"""The single-trade AD risk engine: PV, delta ladders, gamma matrices,
speed cubes and cashflow reports.

Port of ``adrates_tpu/market/position/engine.py``. One pure function
quotes -> PV per (instrument, curve) pairing; the delta ladder is one
``torch.func.jacrev`` of it, the gamma matrix one ``jacfwd`` of that and
the speed cube ``jacfwd(jacrev(jacrev))``. The bootstrap's linear
solve (``ops/linear_solve``) is one custom op whose derivatives are
solves, so the curve-jacobian chain falls out of the composition with
one more solve per AD level; a solve takes at most one forward-mode
level, hence speed's forward level outermost over two reverse ones.

The engine runs on one device, the CUDA card unless the caller asks for
another (``device="cpu"``); with no device given and no card visible it
raises. Eager torch compiles nothing, so there is no compiled-function
cache: what is cached is each curve's device constants (its bootstrap
plan, grids and quotes), once per (curve, device), and each leg's device
tensors, once per engine. Every requested output of a request is packed
into one flat float64 tensor on the device and copied to the host with
one ``.cpu()``, the request's only synchronisation.

Unit conventions: delta in ccy/bp (x 1e-4), gamma in ccy/bp^2 (x 1e-8),
speed in ccy/bp^3 (x 1e-12), PAY legs negative.
"""

from __future__ import annotations

from typing import Dict, Set

import numpy as np
import torch
from torch.func import jacfwd, jacrev

from ...ops.bootstrap import bootstrap_ois, plan_to_torch
from ...ops.interpolation import plan_to_torch as interp_plan_to_torch
from ...ops.pricers import leg_to_torch, pv_fixed_leg, pv_float_leg
from ...ops.xccy_bootstrap import bootstrap_xccy
from ...ops.xccy_bootstrap import plan_to_torch as xccy_plan_to_torch
from ...requests.results import (AnalyticsResult, CashflowItem, Cashflows,
                                 CrossGamma, Delta, Gamma, Risk, Speed,
                                 Valuation)
from ...utils.day_count import DayCountTypes
from ...utils.device import resolve_device
from ...utils.error import LibError
from ...utils.global_types import (CollateralType, InstrumentTypes,
                                   RequestTypes, SwapTypes,
                                   collateral_to_currency,
                                   get_discount_curve_name)
from ...utils.helpers import to_tenor
from ...utils.observability import timed
from .engine_legacy import LegacyLegAnalytics


def memo_tensor(owner, key, build):
    """``owner``'s leg tensor for ``key``, built once and kept on it (as
    the swap legs memoize theirs), so an engine's device copy of it is
    reused by every later request."""
    memo = owner.__dict__.setdefault("_tensor_memo", {})
    out = memo.get(key)
    if out is None:
        out = build()
        memo[key] = out
    return out


class Engine(LegacyLegAnalytics):
    """Routes instruments to their pricing functions and runs the AD risk
    chain on ``device`` (the CUDA card when None)."""

    def __init__(self, model, device=None):
        self.model = model
        self.device = resolve_device(device)
        self._legs: Dict[int, tuple] = {}

    # ------------------------------------------------------------------
    # routing
    # ------------------------------------------------------------------

    def compute(self, derivative, reqs, collateral_type=None
                ) -> AnalyticsResult:
        reqs = set(reqs)
        dtype = derivative.derivative_type
        with timed("engine.compute", instrument=dtype.name,
                   reqs=len(reqs), device=str(self.device)):
            return self._compute(derivative, reqs, collateral_type, dtype)

    # Single-measure convenience wrappers: thin routes into the same
    # compute path, so every instrument type works.

    def valuation(self, derivative):
        return self.compute(derivative, [RequestTypes.VALUE]).value

    def delta(self, derivative):
        return self.compute(derivative, [RequestTypes.DELTA]).risk

    def gamma(self, derivative):
        return self.compute(derivative, [RequestTypes.GAMMA]).gamma

    def _compute(self, derivative, reqs, collateral_type, dtype
                 ) -> AnalyticsResult:
        if dtype == InstrumentTypes.OIS_SWAP:
            return self._compute_ois(derivative, reqs, collateral_type)
        if dtype == InstrumentTypes.XCCY_SWAP:
            return self._compute_xccy(derivative, reqs)
        if dtype == InstrumentTypes.BOND:
            return self._compute_bond(derivative, reqs)
        if dtype == InstrumentTypes.FRN:
            return self._compute_frn(derivative, reqs)
        if dtype == InstrumentTypes.YOY_INFLATION_SWAP:
            return self._compute_yoy_iis(derivative, reqs)
        if dtype == InstrumentTypes.ZCIS:
            return self._compute_zcis(derivative, reqs)
        raise LibError(f"Unsupported derivative type: {dtype}")

    # ------------------------------------------------------------------
    # device constants
    # ------------------------------------------------------------------

    def _f64(self, x) -> torch.Tensor:
        """Host numbers as a float64 tensor on the engine's device."""
        return torch.as_tensor(np.asarray(x, dtype=np.float64),
                               device=self.device)

    def _consts(self, curve, kind, build) -> dict:
        """``build()``'s device constants for one route on ``curve``, made
        once per (curve, device) and kept on the curve, so every engine on
        that device shares them."""
        cache = curve.__dict__.setdefault("_engine_consts", {})
        key = (kind, str(self.device))
        out = cache.get(key)
        if out is None:
            out = build()
            cache[key] = out
        return out

    def _ois_consts(self, curve) -> dict:
        """An OIS curve's bootstrap plan and quotes on the device."""
        return self._consts(curve, "ois", lambda: dict(
            plan=plan_to_torch(curve._plan, self.device),
            rates=self._f64(curve.swap_rates)))

    def _xccy_consts(self, xccy_curve) -> dict:
        """An XCCY curve's chain plan, foreign-curve interpolation plan
        (None for a foreign curve on a fitted scheme, which the bootstrap
        then fits on its grid), grid, domestic-leg PVs, the foreign curve's
        times and DFs, spot FX and the basis spreads on the device. The
        foreign grid's times are static even where its DFs are
        differentiated, so a static plan serves both."""
        fplan = xccy_curve._fplan
        return self._consts(xccy_curve, "xccy", lambda: dict(
            plan=xccy_plan_to_torch(xccy_curve._plan, self.device),
            fplan=None if fplan is None
            else interp_plan_to_torch(fplan, self.device),
            times=xccy_curve._times.to(self.device),
            for_times=xccy_curve._foreign_curve._times.to(self.device),
            dfs=xccy_curve._dfs.to(self.device),
            pv_dom=self._f64(xccy_curve._pv_domestic),
            for_dfs=xccy_curve._foreign_curve._dfs.to(self.device),
            spot_fx=self._f64(xccy_curve._spot_fx),
            spreads=self._f64(xccy_curve.basis_spreads)))

    def _leg(self, tensor):
        """A host leg tensor's device form, made once per engine (the legs
        memoize their host tensors, so a warm request copies nothing to
        the device)."""
        if tensor is None:
            return None
        hit = self._legs.get(id(tensor))
        if hit is None:
            hit = (tensor, leg_to_torch(tensor, self.device))
            self._legs[id(tensor)] = hit
        return hit[1]

    # ------------------------------------------------------------------
    # shared risk chain
    # ------------------------------------------------------------------

    @staticmethod
    def _two_curve_analytics(pv_fn, want):
        """Packed analytics of PV(x0, x1): PV, both delta ladders, both
        gamma matrices and the x0-x1 cross-gamma, concatenated into one
        flat tensor."""
        def analytics(x0, x1):
            parts = []
            if want[0]:
                parts.append(pv_fn(x0, x1).reshape(1))
            if want[1]:
                parts.append(jacrev(pv_fn, argnums=0)(x0, x1))
                parts.append(jacrev(pv_fn, argnums=1)(x0, x1))
            if want[2]:
                parts.append(jacfwd(jacrev(pv_fn, argnums=0),
                                    argnums=0)(x0, x1).reshape(-1))
                parts.append(jacfwd(jacrev(pv_fn, argnums=1),
                                    argnums=1)(x0, x1).reshape(-1))
                parts.append(jacfwd(jacrev(pv_fn, argnums=0),
                                    argnums=1)(x0, x1).reshape(-1))
            return torch.cat(parts)
        return analytics

    @staticmethod
    def _unpack(packed: torch.Tensor, sizes) -> Dict[str, np.ndarray]:
        """Split one flat device tensor into named host blocks: ONE
        device->host copy per request, whatever it asked for."""
        host = packed.detach().cpu().numpy().astype(np.float64, copy=False)
        out = {}
        pos = 0
        for name, shape in sizes:
            n = int(np.prod(shape))
            out[name] = host[pos:pos + n].reshape(shape)
            pos += n
        return out

    def _swap_analytics(self, curve, fixed_tensor, float_tensor,
                        reqs: Set[RequestTypes]) -> Dict[str, np.ndarray]:
        """PV / delta ladder / gamma matrix / speed cube of a (fixed leg?,
        float leg?) pair bootstrapped and discounted on ``curve``. Delta
        is one jacrev of the quotes -> PV map, gamma one jacfwd of that,
        speed jacfwd(jacrev(jacrev))."""
        want = (RequestTypes.VALUE in reqs, RequestTypes.DELTA in reqs,
                RequestTypes.GAMMA in reqs, RequestTypes.SPEED in reqs)
        if not any(want):  # e.g. CASHFLOWS-only requests
            return {}
        C = self._ois_consts(curve)
        plan = C["plan"]
        it = curve._interp_type
        ft = self._leg(fixed_tensor)
        lt = self._leg(float_tensor)

        def pv_fn(r):
            times, dfs = bootstrap_ois(r, plan)
            pv = 0.0
            if ft is not None:
                pv = pv + pv_fixed_leg(dfs, times, it, ft)
            if lt is not None:
                pv = pv + pv_float_leg(dfs, it, lt, times=times)
            return pv

        rates = C["rates"]
        n = rates.shape[0]
        parts, sizes = [], []
        if want[0]:
            parts.append(pv_fn(rates).reshape(1))
            sizes.append(("pv", ()))
        if want[1]:
            parts.append(jacrev(pv_fn)(rates))
            sizes.append(("delta", (n,)))
        if want[2]:
            parts.append(jacfwd(jacrev(pv_fn))(rates).reshape(-1))
            sizes.append(("gamma", (n, n)))
        if want[3]:
            # third order (SPEED): one forward level over two reverse
            # ones, since a solve takes one forward level only
            # (ops/linear_solve)
            parts.append(jacfwd(jacrev(jacrev(pv_fn)))(rates).reshape(-1))
            sizes.append(("speed", (n, n, n)))
        return self._unpack(torch.cat(parts), sizes)

    def _package_outputs(self, raw: Dict, reqs: Set[RequestTypes], currency,
                         curve_type, swap_times) -> Dict:
        out = {}
        tenors = to_tenor(list(swap_times))
        if RequestTypes.VALUE in reqs:
            out["value"] = Valuation(amount=float(raw["pv"]),
                                     currency=currency)
        if RequestTypes.DELTA in reqs:
            out["delta"] = Delta(risk_ladder=raw["delta"] * 1e-4,
                                 tenors=tenors, currency=currency,
                                 curve_type=curve_type)
        if RequestTypes.GAMMA in reqs:
            out["gamma"] = Gamma(risk_ladder=raw["gamma"] * 1e-8,
                                 tenors=tenors, currency=currency,
                                 curve_type=curve_type)
        if RequestTypes.SPEED in reqs and "speed" in raw:
            out["speed"] = Speed(risk_cube=raw["speed"] * 1e-12,
                                 tenors=tenors, currency=currency,
                                 curve_type=curve_type)
        return out

    # ------------------------------------------------------------------
    # OIS
    # ------------------------------------------------------------------

    def _compute_ois(self, derivative, reqs, collateral_type=None
                     ) -> AnalyticsResult:
        if collateral_type is None:
            collateral_ccy = derivative._currency
        else:
            collateral_ccy = collateral_to_currency(collateral_type)
        if collateral_ccy == derivative._currency:
            return self._compute_ois_natural(derivative, reqs)
        return self._compute_ois_xccy_collateral(derivative, reqs,
                                                 collateral_ccy)

    def _compute_ois_natural(self, derivative, reqs) -> AnalyticsResult:
        curve = getattr(self.model.curves, derivative._floating_index.name)
        value_dt = curve._value_dt

        fixed_tensor = derivative._fixed_leg.tensor(value_dt)
        float_tensor = derivative._float_leg.tensor(
            value_dt, index_dc=curve._dc_type)
        raw = self._swap_analytics(curve, fixed_tensor, float_tensor, reqs)
        out = self._package_outputs(raw, reqs, derivative._currency,
                                    derivative._floating_index,
                                    curve.swap_times)

        cashflows = None
        if RequestTypes.CASHFLOWS in reqs:
            cashflows = self._ois_cashflows(derivative, curve)

        return AnalyticsResult(value=out.get("value"),
                               risk=out.get("delta"),
                               gamma=out.get("gamma"),
                               cashflows=cashflows,
                               speed=out.get("speed"))

    def _compute_ois_xccy_collateral(self, derivative, reqs, collateral_ccy
                                     ) -> AnalyticsResult:
        """OIS projected on its natural OIS curve but discounted on the
        {CCY}_{COLL}_XCCY curve, PV converted by spot FX."""
        from ...trades.rates.xccy_curve import XccyCurve
        from .engine_xccy import basis_curve_type
        model = self.model
        ois_curve = getattr(model.curves, derivative._floating_index.name)
        value_dt = ois_curve._value_dt
        disc_name = get_discount_curve_name(derivative._currency,
                                            CollateralType[
                                                collateral_ccy.name])
        if disc_name in model.curves:
            xccy_curve = model.curves[disc_name]
        else:
            # fall back to any XCCY curve whose foreign leg matches
            matches = [c for c in model._curves_dict.values()
                       if isinstance(c, XccyCurve)]
            if len(matches) != 1:
                raise LibError(
                    f"Discount curve {disc_name} not found and no unique "
                    f"XCCY curve to fall back to")
            xccy_curve = matches[0]
        pair = f"{collateral_ccy.name}{derivative._currency.name}"
        spot_fx = model.fx(pair)

        # XccyCurve.df pins ACT/365F for its time conversion, so the
        # discount-side query times must be in that basis (direct-path
        # parity); forwards stay on the natural curve's basis.
        ft = self._leg(derivative._fixed_leg.tensor(
            value_dt, discount_dc=DayCountTypes.ACT_365F))
        lt = self._leg(derivative._float_leg.tensor(
            value_dt, index_dc=ois_curve._dc_type,
            discount_dc=DayCountTypes.ACT_365F))

        O = self._ois_consts(ois_curve)
        X = self._xccy_consts(xccy_curve)
        it = ois_curve._interp_type
        xccy_it = xccy_curve._interp_type
        want = (RequestTypes.VALUE in reqs, RequestTypes.DELTA in reqs,
                RequestTypes.GAMMA in reqs)

        # The trade's natural OIS curve is usually the XCCY curve's
        # FOREIGN curve (a GBP swap under USD collateral discounts on the
        # GBP-in-USD-collateral curve, whose foreign leg is GBP OIS): the
        # basis bootstrap then consumes the SAME grid the forwards project
        # off, so rate deltas carry the recalibration chain. When the
        # curves are unrelated the stored foreign grid rides as a
        # constant.
        chain_foreign = xccy_curve._foreign_curve is ois_curve
        f_it = it if chain_foreign \
            else xccy_curve._foreign_curve._interp_type
        n_r = len(ois_curve.swap_rates)
        n_s = len(xccy_curve.basis_spreads)

        def pv_fn(rates, spreads):
            times, dfs = bootstrap_ois(rates, O["plan"])
            f_dfs = dfs if chain_foreign else X["for_dfs"]
            f_times = times if chain_foreign else X["for_times"]
            _, xdfs = bootstrap_xccy(spreads, X["pv_dom"], f_dfs,
                                     X["spot_fx"], X["plan"], f_it,
                                     X["fplan"], foreign_times=f_times)
            xts = X["times"]
            pv = pv_fixed_leg(xdfs, xts, xccy_it, ft)
            pv = pv + pv_float_leg(xdfs, xccy_it, lt, idx_dfs=dfs,
                                   idx_interp_type=it, times=xts,
                                   idx_times=times)
            return pv / spot_fx

        value = risk = gamma = None
        if any(want):
            packed = self._two_curve_analytics(pv_fn, want)(O["rates"],
                                                            X["spreads"])
            sizes = []
            if want[0]:
                sizes.append(("pv", ()))
            if want[1]:
                sizes += [("d_ois", (n_r,)), ("d_basis", (n_s,))]
            if want[2]:
                sizes += [("g_ois", (n_r, n_r)), ("g_basis", (n_s, n_s)),
                          ("cross", (n_r, n_s))]
            raw = self._unpack(packed, sizes)

            basis_ct = basis_curve_type(derivative._currency, collateral_ccy)
            ois_tenors = to_tenor(list(ois_curve.swap_times))
            basis_tenors = to_tenor(list(xccy_curve.swap_times))
            if want[0]:
                value = Valuation(float(raw["pv"]), collateral_ccy)
            if want[1]:
                risk = Risk([
                    Delta(raw["d_ois"] * 1e-4, ois_tenors, collateral_ccy,
                          derivative._floating_index),
                    Delta(raw["d_basis"] * 1e-4, basis_tenors,
                          collateral_ccy, basis_ct)])
            if want[2]:
                cross = CrossGamma(
                    risk_matrix=raw["cross"] * 1e-8,
                    tenors_curve1=ois_tenors, tenors_curve2=basis_tenors,
                    currency=collateral_ccy,
                    curve_type_1=derivative._floating_index,
                    curve_type_2=basis_ct)
                gamma = Risk([
                    Gamma(raw["g_ois"] * 1e-8, ois_tenors, collateral_ccy,
                          derivative._floating_index),
                    Gamma(raw["g_basis"] * 1e-8, basis_tenors,
                          collateral_ccy, basis_ct)],
                    cross_gammas=[cross])
        return AnalyticsResult(value=value, risk=risk, gamma=gamma)

    # ------------------------------------------------------------------
    # cashflow extraction
    # ------------------------------------------------------------------

    def _ois_cashflows(self, derivative, curve) -> Cashflows:
        value_dt = curve._value_dt
        derivative._fixed_leg.value(value_dt, curve)
        derivative._float_leg.value(value_dt, curve, curve)
        pay_fixed = derivative._fixed_leg._leg_type == SwapTypes.PAY
        items = []
        items += self._extract_leg_cashflows(
            derivative._fixed_leg, "Fixed_Pay" if pay_fixed else "Fixed_Rec")
        items += self._extract_leg_cashflows(
            derivative._float_leg, "Float_Rec" if pay_fixed else "Float_Pay")
        return Cashflows(items, derivative._currency)

    @staticmethod
    def _extract_leg_cashflows(leg, leg_type: str):
        items = []
        notionals = getattr(leg, "_notional_array", None) or \
            [leg._notional] * len(leg._payment_dts)
        for i, dt in enumerate(leg._payment_dts):
            rate = leg._rates[i] if hasattr(leg, "_rates") and \
                i < len(leg._rates) else 0.0
            items.append(CashflowItem(
                payment_date=dt,
                notional=float(notionals[i]),
                payment_fraction=float(rate),
                accrual_period=float(leg._year_fracs[i]),
                amount=float(leg._payments[i]),
                discount_factor=float(leg._payment_dfs[i]),
                discounted_amount=float(leg._payment_pvs[i]),
                leg_type=leg_type))
        if getattr(leg, "_notional_exchange", False):
            sign_type = "Notional_Pay" if leg._leg_type == SwapTypes.PAY \
                else "Notional_Rec"
            items.append(CashflowItem(
                payment_date=leg._effective_dt, notional=leg._notional,
                payment_fraction=-1.0, accrual_period=0.0,
                amount=-leg._notional, discount_factor=1.0,
                discounted_amount=-leg._notional, leg_type=sign_type))
            items.append(CashflowItem(
                payment_date=leg._maturity_dt, notional=leg._notional,
                payment_fraction=1.0, accrual_period=0.0,
                amount=leg._notional,
                discount_factor=float(leg._payment_dfs[-1]),
                discounted_amount=float(leg._notional
                                        * leg._payment_dfs[-1]),
                leg_type=sign_type))
        return items

    # ------------------------------------------------------------------
    # the other instrument kinds
    # ------------------------------------------------------------------

    def _compute_xccy(self, derivative, reqs) -> AnalyticsResult:
        from .engine_xccy import compute_xccy
        return compute_xccy(self, derivative, reqs)

    def _compute_bond(self, derivative, reqs) -> AnalyticsResult:
        from .engine_credit import compute_bond
        return compute_bond(self, derivative, reqs)

    def _compute_frn(self, derivative, reqs) -> AnalyticsResult:
        from .engine_credit import compute_frn
        return compute_frn(self, derivative, reqs)

    def _compute_yoy_iis(self, derivative, reqs) -> AnalyticsResult:
        from .engine_inflation import compute_yoy_iis
        return compute_yoy_iis(self, derivative, reqs)

    def _compute_zcis(self, derivative, reqs) -> AnalyticsResult:
        from .engine_inflation import compute_zcis
        return compute_zcis(self, derivative, reqs)
