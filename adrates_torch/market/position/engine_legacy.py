"""Legacy raw-input engine API: curve bootstrap and per-leg analytics
from (swap_rates, swap_times, year_fracs) triples.

Port of ``adrates_tpu/market/position/engine_legacy.py``
(``build_curve_ad``, value/valuation/delta/gamma of the fixed leg and of
the float leg). The whole pv(rates) composition — the node recursion,
the interpolation and the leg sum — is one function of the quote vector,
so delta and gamma are ``jacrev`` and ``jacfwd∘jacrev`` through it.

The node recursion df_k = (1 - r·A_prev) / (1 + r·α_k) runs as a Python
loop over the nodes that keeps the running pv01s in a list and stacks
the DFs at the end: no tensor is written in place, so ``torch.func``
transforms it to every order.

Units follow the reference: rates are decimals, delta is scaled 1e-4
(per bp) and gamma 1e-8 (per bp^2). The entry points run on the engine's
device.
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import Dict, Sequence

import numpy as np
import torch
from torch.func import jacfwd, jacrev

from ...ops.interpolation import simple_df
from ...requests.results import Delta, Gamma, Valuation
from ...utils.global_types import InterpTypes, SwapTypes
from ...utils.helpers import times_from_dates, to_tenor


# ---------------------------------------------------------------------------
# node plan: host-side, hashable-key cached


@lru_cache(maxsize=256)
def _legacy_plan(swap_times: tuple, year_fracs: tuple):
    """Expand every swap's coupon times (cumulative year fracs) into one
    sorted node list. Each node keeps its parent swap's index and the
    node index of the swap's previous coupon (first occurrence of the
    2-dp-rounded key), so the par recursion can run node by node.
    Duplicate times are kept — each swap's chain carries its own rate.

    As in the JAX package, a swap whose FIRST accrual fraction rounds to
    0.00 at 2dp resolves its second coupon's previous key to that tiny
    first node, keeping the node's real annuity (the reference drops it
    and misprices the input swap by ~2e-4 in DF)."""
    nodes = []  # (t_exact, key, alpha, prev_key, swap_idx)
    for i, fracs in enumerate(year_fracs):
        cum = 0.0
        for j, frac in enumerate(fracs):
            prev = cum
            cum += float(frac)
            nodes.append((cum, round(cum, 2), float(frac),
                          round(prev, 2) if j > 0 else None, i))
    nodes.sort(key=lambda p: p[0])
    first_at = {}
    for idx, p in enumerate(nodes):
        first_at.setdefault(p[1], idx)
    prev_idx = np.array(
        [first_at.get(p[3], -1) if p[3] is not None else -1 for p in nodes],
        dtype=np.int32)
    return dict(
        t=np.array([p[0] for p in nodes]),
        alpha=np.array([p[2] for p in nodes]),
        swap=np.array([p[4] for p in nodes], dtype=np.int32),
        prev=prev_idx,
    )


def _legacy_dfs(rates, alpha, swap_idx, prev_idx):
    """DFs at every node as a function of the quote vector. ``alpha``,
    ``swap_idx`` and ``prev_idx`` are host sequences; a previous-node
    index not yet reached reads a zero pv01, as the JAX package's scan
    reads its zero-initialised carry."""
    pv01 = []
    dfs = []
    for i, (a, k, p) in enumerate(zip(alpha, swap_idx, prev_idx)):
        r = rates[k]
        a_prev = pv01[p] if 0 <= p < i else 0.0
        df = (1.0 - r * a_prev) / (1.0 + r * a)
        pv01.append(a_prev + a * df)
        dfs.append(df)
    return torch.stack(dfs)


def _anchored_curve(rates, alpha, swap_idx, prev_idx, node_t):
    """(times, dfs(rates)) with a near-zero anchor prepended so
    sub-first-node queries (value date, seasoned accrual starts)
    interpolate; its DF is the constant 1 (zero sensitivity)."""
    dfs = _legacy_dfs(rates, alpha, swap_idx, prev_idx)
    times = torch.cat([node_t.new_full((1,), 1e-8), node_t])
    dfs = torch.cat([dfs.new_ones(1), dfs])
    return times, dfs


# ---------------------------------------------------------------------------
# leg pv functions (rates first, the argument differentiated)


def _first_fixed(fwd, override, fix0):
    if not override:
        return fwd
    first = torch.arange(fwd.shape[0], device=fwd.device) == 0
    return torch.where(first, fix0, fwd)


def _fixed_pv_raw(rates, alpha, swap_idx, prev_idx, node_t, pay_t,
                  payments, mask, principal, sign, interp_type):
    times, dfs = _anchored_curve(rates, alpha, swap_idx, prev_idx, node_t)
    df_p = simple_df(pay_t, times, dfs, interp_type)
    coupon_pv = torch.where(mask, payments * df_p, 0.0).sum()
    prin_pv = torch.where(mask[-1], principal * df_p[-1], 0.0)
    return sign * (coupon_pv + prin_pv)


def _float_pv_raw(rates, alpha, swap_idx, prev_idx, node_t, pay_t, start_t,
                  end_t, alphas, notionals, spread, fix0, mask, principal,
                  sign, interp_type, idx_interp_type, override):
    times, dfs = _anchored_curve(rates, alpha, swap_idx, prev_idx, node_t)
    # forwards off the (same or separately-schemed) index curve; the
    # near-zero anchor clamps seasoned accrual starts to DF(0)=1
    df_s = simple_df(start_t.clamp(min=1e-8), times, dfs, idx_interp_type)
    df_e = simple_df(end_t, times, dfs, idx_interp_type)
    fwd = torch.where(alphas > 0.0, (df_s / df_e - 1.0) / alphas, 0.0)
    fwd = _first_fixed(fwd, override, fix0)
    cf = (fwd + spread) * alphas * notionals
    df_p = simple_df(pay_t, times, dfs, interp_type)
    coupon_pv = torch.where(mask, cf * df_p, 0.0).sum()
    prin_pv = torch.where(mask[-1], principal * df_p[-1], 0.0)
    return sign * (coupon_pv + prin_pv)


def _float_pv_disc_curve_raw(rates, alpha, swap_idx, prev_idx, node_t,
                             disc_times, disc_dfs, pay_t, start_t, end_t,
                             alphas, notionals, spread, fix0, mask,
                             principal, sign, disc_interp_type,
                             idx_interp_type, override):
    """Float leg discounted on a PREBUILT curve (times/dfs constants in
    the quote vector) with forwards projected off the bootstrapped index
    curve. The greeks are the index curve's alone (discount grid held
    fixed), an extension of the reference, which raises there."""
    times, dfs = _anchored_curve(rates, alpha, swap_idx, prev_idx, node_t)
    df_s = simple_df(start_t.clamp(min=1e-8), times, dfs, idx_interp_type)
    df_e = simple_df(end_t, times, dfs, idx_interp_type)
    fwd = torch.where(alphas > 0.0, (df_s / df_e - 1.0) / alphas, 0.0)
    fwd = _first_fixed(fwd, override, fix0)
    cf = (fwd + spread) * alphas * notionals
    df_p = simple_df(pay_t, disc_times, disc_dfs, disc_interp_type)
    coupon_pv = torch.where(mask, cf * df_p, 0.0).sum()
    prin_pv = torch.where(mask[-1], principal * df_p[-1], 0.0)
    return sign * (coupon_pv + prin_pv)


def _kernels(pv):
    """(value, delta, gamma) of a leg pv function, each called as
    ``k(rates, **args)``."""
    def value(rates, **args):
        return pv(rates, **args)

    def delta(rates, **args):
        return jacrev(partial(pv, **args))(rates)

    def gamma(rates, **args):
        return jacfwd(jacrev(partial(pv, **args)))(rates)
    return value, delta, gamma


_fixed_value, _fixed_delta, _fixed_gamma = _kernels(_fixed_pv_raw)
_float_value, _float_delta, _float_gamma = _kernels(_float_pv_raw)
_float_xccy_value, _float_xccy_delta, _float_xccy_gamma = _kernels(
    _float_pv_disc_curve_raw)


# ---------------------------------------------------------------------------
# Engine-facing mixin


class LegacyLegAnalytics:
    """Raw-input per-leg entry points mixed into Engine (which sets
    ``self.device``)."""

    def _rates(self, swap_rates) -> torch.Tensor:
        return torch.as_tensor(np.asarray(swap_rates, dtype=np.float64),
                               device=self.device)

    def build_curve_ad(self, swap_rates, swap_times, year_fracs):
        """(all node times, dfs) of the legacy par bootstrap, with the
        reference's leading t=0 / df=1.0 point."""
        plan = _legacy_plan(tuple(swap_times),
                            tuple(tuple(f) for f in year_fracs))
        dfs = _legacy_dfs(self._rates(swap_rates), plan["alpha"].tolist(),
                          plan["swap"].tolist(), plan["prev"].tolist())
        times = torch.as_tensor(np.concatenate([[0.0], plan["t"]]),
                                device=self.device)
        return times, torch.cat([dfs.new_ones(1), dfs])

    # -- operand packing -----------------------------------------------------

    def _plan_args(self, swap_times, year_fracs) -> dict:
        plan = _legacy_plan(tuple(swap_times),
                            tuple(tuple(f) for f in year_fracs))
        return dict(alpha=plan["alpha"].tolist(),
                    swap_idx=plan["swap"].tolist(),
                    prev_idx=plan["prev"].tolist(),
                    node_t=self._rates(plan["t"]))

    def _fixed_args(self, swap_times, year_fracs, leg, value_dt,
                    interp_type) -> dict:
        dc = leg._dc_type
        pay_t = np.array([times_from_dates(d, value_dt, dc)
                          for d in leg._payment_dts])
        return dict(
            self._plan_args(swap_times, year_fracs),
            pay_t=self._rates(pay_t),
            payments=self._rates(leg._payments),
            mask=torch.as_tensor(pay_t > 0.0, device=self.device),
            principal=float(leg._principal),
            sign=1.0 if leg._leg_type == SwapTypes.RECEIVE else -1.0,
            interp_type=InterpTypes(interp_type))

    def _float_args(self, swap_times, year_fracs, leg, value_dt,
                    interp_type, index_curve_type=None,
                    first_fixing_rate=None) -> dict:
        dc = leg._dc_type
        pay_t = np.array([times_from_dates(d, value_dt, dc)
                          for d in leg._payment_dts])
        it = InterpTypes(interp_type)
        return dict(
            self._plan_args(swap_times, year_fracs),
            pay_t=self._rates(pay_t),
            start_t=self._rates([times_from_dates(d, value_dt, dc)
                                 for d in leg._start_accrued_dts]),
            end_t=self._rates([times_from_dates(d, value_dt, dc)
                               for d in leg._end_accrued_dts]),
            alphas=self._rates(leg._year_fracs),
            notionals=self._rates(leg._notional_array or [leg._notional]
                                  * len(leg._year_fracs)),
            spread=float(leg._spread),
            fix0=(0.0 if first_fixing_rate is None
                  else float(first_fixing_rate)),
            mask=torch.as_tensor(pay_t >= 0.0, device=self.device),
            principal=float(leg._principal),
            sign=1.0 if leg._leg_type == SwapTypes.RECEIVE else -1.0,
            interp_type=it,
            idx_interp_type=(it if index_curve_type is None
                             else InterpTypes(index_curve_type)),
            override=first_fixing_rate is not None)

    def _float_route(self, swap_times, year_fracs, leg, value_dt,
                     discount_curve_type, index_curve_type,
                     first_fixing_rate):
        """(value, delta, gamma functions, packed args) for the float leg.
        ``discount_curve_type`` is an InterpTypes — or a prebuilt
        XccyCurve, in which case discounting rides the curve's static
        (times, dfs) grid and only the index curve is bootstrapped from
        the quote vector."""
        from ...trades.rates.xccy_curve import XccyCurve
        if not isinstance(discount_curve_type, XccyCurve):
            args = self._float_args(
                swap_times, year_fracs, leg, value_dt,
                discount_curve_type, index_curve_type, first_fixing_rate)
            return _float_value, _float_delta, _float_gamma, args
        curve = discount_curve_type
        it = InterpTypes(curve._interp_type)
        base = self._float_args(
            swap_times, year_fracs, leg, value_dt, it,
            index_curve_type if index_curve_type is not None else it,
            first_fixing_rate)
        args = dict(base,
                    disc_times=curve._times.to(self.device),
                    disc_dfs=curve._dfs.to(self.device),
                    disc_interp_type=it)
        del args["interp_type"]
        return _float_xccy_value, _float_xccy_delta, _float_xccy_gamma, args

    def _measures(self, value_k, delta_k, gamma_k, args, swap_rates,
                  swap_times, leg, requests) -> Dict:
        rates = self._rates(swap_rates)
        tenors = to_tenor(list(swap_times))
        out = {}
        if "value" in requests:
            out["value"] = Valuation(float(value_k(rates, **args)),
                                     leg._currency)
        if "delta" in requests:
            out["delta"] = Delta(
                delta_k(rates, **args).cpu().numpy() * 1e-4,
                tenors, leg._currency, leg._floating_index)
        if "gamma" in requests:
            out["gamma"] = Gamma(
                gamma_k(rates, **args).cpu().numpy() * 1e-8,
                tenors, leg._currency, leg._floating_index)
        return out

    def _fixed_leg_analytics(self, swap_rates, swap_times, year_fracs,
                             leg, value_dt, interp_type,
                             requests: Sequence[str]) -> Dict:
        args = self._fixed_args(swap_times, year_fracs, leg, value_dt,
                                interp_type)
        return self._measures(_fixed_value, _fixed_delta, _fixed_gamma,
                              args, swap_rates, swap_times, leg, requests)

    def _float_leg_analytics(self, swap_rates, swap_times, year_fracs,
                             leg, value_dt, discount_curve_type,
                             index_curve_type=None, first_fixing_rate=None,
                             requests: Sequence[str] = ("value",)) -> Dict:
        value_k, delta_k, gamma_k, args = self._float_route(
            swap_times, year_fracs, leg, value_dt, discount_curve_type,
            index_curve_type, first_fixing_rate)
        return self._measures(value_k, delta_k, gamma_k,
                              args, swap_rates, swap_times, leg, requests)

    # -- public wrappers (reference names/returns) ---------------------------

    def value_fixed_leg(self, swap_rates, swap_times, year_fracs,
                        fixed_leg_details, value_dt, interpolator_dc_type):
        args = self._fixed_args(swap_times, year_fracs, fixed_leg_details,
                                value_dt, interpolator_dc_type)
        return _fixed_value(self._rates(swap_rates), **args)

    def valuation_fixed_leg(self, swap_rates, swap_times, year_fracs,
                            fixed_leg_details, value_dt,
                            interpolator_dc_type):
        return self._fixed_leg_analytics(
            swap_rates, swap_times, year_fracs, fixed_leg_details,
            value_dt, interpolator_dc_type, ("value",))["value"]

    def delta_fixed_leg(self, swap_rates, swap_times, year_fracs,
                        fixed_leg_details, value_dt, interpolator_dc_type):
        return self._fixed_leg_analytics(
            swap_rates, swap_times, year_fracs, fixed_leg_details,
            value_dt, interpolator_dc_type, ("delta",))["delta"]

    def gamma_fixed_leg(self, swap_rates, swap_times, year_fracs,
                        fixed_leg_details, value_dt, interpolator_dc_type):
        return self._fixed_leg_analytics(
            swap_rates, swap_times, year_fracs, fixed_leg_details,
            value_dt, interpolator_dc_type, ("gamma",))["gamma"]

    def value_float_leg(self, swap_rates, swap_times, year_fracs,
                        floating_leg_details, value_dt, discount_curve_type,
                        index_curve_type=None, first_fixing_rate=None):
        value_k, _, _, args = self._float_route(
            swap_times, year_fracs, floating_leg_details, value_dt,
            discount_curve_type, index_curve_type, first_fixing_rate)
        return value_k(self._rates(swap_rates), **args)

    def valuation_float_leg(self, swap_rates, swap_times, year_fracs,
                            floating_leg_details, value_dt,
                            discount_curve_type, index_curve_type=None,
                            first_fixing_rate=None):
        return self._float_leg_analytics(
            swap_rates, swap_times, year_fracs, floating_leg_details,
            value_dt, discount_curve_type, index_curve_type,
            first_fixing_rate, ("value",))["value"]

    def delta_float_leg(self, swap_rates, swap_times, year_fracs,
                        floating_leg_details, value_dt, discount_curve_type,
                        index_curve_type=None, first_fixing_rate=None):
        return self._float_leg_analytics(
            swap_rates, swap_times, year_fracs, floating_leg_details,
            value_dt, discount_curve_type, index_curve_type,
            first_fixing_rate, ("delta",))["delta"]

    def gamma_float_leg(self, swap_rates, swap_times, year_fracs,
                        floating_leg_details, value_dt, discount_curve_type,
                        index_curve_type=None, first_fixing_rate=None):
        return self._float_leg_analytics(
            swap_rates, swap_times, year_fracs, floating_leg_details,
            value_dt, discount_curve_type, index_curve_type,
            first_fixing_rate, ("gamma",))["gamma"]
