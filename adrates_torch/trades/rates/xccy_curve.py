"""Cross-currency (foreign-in-domestic-collateral) discount curve.

Port of ``adrates_tpu/trades/rates/xccy_curve.py``: the static chain plan
(``_prepare_plan``), the static foreign-curve interpolation plan
(``_foreign_plan``), the domestic calibration-leg PVs, the ACT/365F
``df()`` and the 1e-10 refit gate. The solve is
``ops/xccy_bootstrap.bootstrap_xccy`` as CPU float64 torch ops, shared
with the book path's batched XCCY stages. A foreign curve on a simple
scheme gives the bootstrap a static plan; one on a fitted scheme has
none, and the bootstrap fits and queries it directly (as the JAX
class). The curve-level jacobian properties of the JAX class are not
ported (the single-trade engine composes its own).

FX convention: spot_fx = DOMESTIC per FOREIGN.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ...market.curves.discount_curve import DiscountCurve
from ...ops.interpolation import (_SIMPLE_SCHEMES, plan_to_torch,
                                  simple_interp_plan)
from ...ops.xccy_bootstrap import XccyBootstrapPlan, bootstrap_xccy
from ...ops.xccy_bootstrap import plan_to_torch as xccy_plan_to_torch
from ...utils.date import Date
from ...utils.day_count import DayCount, DayCountTypes
from ...utils.error import LibError
from ...utils.frequency import FrequencyTypes
from ...utils.global_types import InterpTypes, SwapTypes
from ...utils.global_vars import gDaysInYear
from ...utils.helpers import label_to_string, times_from_dates
from ...utils.observability import timed

SWAP_TOL = 1e-10


class XccyCurve(DiscountCurve):
    """Discount curve for foreign cashflows under domestic collateral,
    calibrated so every basis swap prices to par in domestic currency."""

    def __init__(self,
                 value_dt: Date,
                 basis_swaps: list,
                 domestic_curve: DiscountCurve,
                 foreign_curve: DiscountCurve,
                 spot_fx: float,
                 interp_type: InterpTypes = InterpTypes.FLAT_FWD_RATES,
                 check_refit: bool = False):
        self._value_dt = value_dt
        self._used_swaps = sorted(basis_swaps,
                                  key=lambda s: s._maturity_dt.serial())
        self._domestic_curve = domestic_curve
        self._foreign_curve = foreign_curve
        self._spot_fx = spot_fx
        self._interp_type = interp_type
        self._check_refit = check_refit
        self._dc_type = DayCountTypes.ACT_365F
        self._freq_type = FrequencyTypes.CONTINUOUS

        self.basis_spreads = [s._foreign_spread for s in self._used_swaps]
        self.swap_times = [(s._maturity_dt - value_dt) / gDaysInYear
                           for s in self._used_swaps]

        with timed("curve.build.xccy", pillars=len(basis_swaps),
                   interp=interp_type.name):
            self._plan = self._prepare_plan()
            self._pv_domestic = self._domestic_leg_pvs()
            self._fplan = self._foreign_plan()
            f64 = torch.float64
            self._times, self._dfs = bootstrap_xccy(
                torch.tensor(self.basis_spreads, dtype=f64),
                torch.tensor(self._pv_domestic, dtype=f64),
                self._foreign_curve._dfs, self._spot_fx,
                xccy_plan_to_torch(self._plan, "cpu"),
                self._foreign_curve._interp_type,
                None if self._fplan is None
                else plan_to_torch(self._fplan, "cpu"),
                foreign_times=self._foreign_curve._times)

            if check_refit:
                with timed("curve.refit.xccy", pillars=len(basis_swaps)):
                    self._check_refits(SWAP_TOL)

    # ------------------------------------------------------------------

    def _domestic_leg_pvs(self) -> List[float]:
        """Domestic-leg PV of each calibration swap on the domestic OIS
        curve (constant inputs to the basis bootstrap)."""
        return [s._domestic_leg.value(self._value_dt, self._domestic_curve,
                                      self._domestic_curve)
                for s in self._used_swaps]

    # ------------------------------------------------------------------

    def _prepare_plan(self) -> XccyBootstrapPlan:
        """Expand all foreign-leg payments into the static chain plan.

        Points sorted by (time, swap index); value-date flows contribute to
        the constant V0 terms; the flat-forward chain runs over the rest.
        """
        fdc = self._foreign_curve._dc_type
        points = []
        v0 = np.zeros(len(self._used_swaps))

        for k, swap in enumerate(self._used_swaps):
            leg = swap._foreign_leg
            if leg._leg_type != SwapTypes.PAY:
                raise LibError("Calibration foreign legs must be PAY")
            maturity_dt = swap._maturity_dt
            if not leg._notional_exchange:
                raise LibError("Calibration basis swaps need notional "
                               "exchange on the foreign leg")

            # initial exchange at effective date
            eff = leg._effective_dt
            if eff == self._value_dt:
                v0[k] += -leg._notional
            elif eff > self._value_dt:
                points.append(dict(
                    t=(eff - self._value_dt) / gDaysInYear,
                    pay_tf=times_from_dates(eff, self._value_dt, fdc),
                    start_t=0.0, end_t=0.0, notional=leg._notional,
                    spread_sens=0.0, alpha_ratio=1.0, is_mat=False,
                    is_notl=True, is_last=False, swap=k))

            notionals = leg._notionals()
            index_counter = DayCount(fdc)
            for j, pmnt_dt in enumerate(leg._payment_dts):
                if pmnt_dt < self._value_dt:
                    continue
                t = (pmnt_dt - self._value_dt) / gDaysInYear
                is_maturity = (pmnt_dt == maturity_dt)
                # forward coupons: pay basis over the foreign curve's
                # forward basis (value() parity — they only cancel when
                # the leg accrues on the curve's day count)
                ia = index_counter.year_frac(leg._start_accrued_dts[j],
                                             leg._end_accrued_dts[j])[0]
                pa = float(leg._year_fracs[j])
                rec = dict(
                    t=t,
                    pay_tf=times_from_dates(pmnt_dt, self._value_dt, fdc),
                    # forward DF queries happen at LEG-basis times — the
                    # same times value() asks the foreign curve for
                    start_t=times_from_dates(leg._start_accrued_dts[j],
                                             self._value_dt, leg._dc_type),
                    end_t=times_from_dates(leg._end_accrued_dts[j],
                                           self._value_dt, leg._dc_type),
                    notional=float(notionals[j]),
                    spread_sens=float(leg._year_fracs[j] * notionals[j]),
                    alpha_ratio=(pa / ia if ia > 0 else 1.0),
                    is_mat=is_maturity, is_notl=False,
                    is_last=is_maturity,  # final coupon carries +notional
                    swap=k)
                if pmnt_dt == self._value_dt:
                    raise LibError("Coupon at the value date unsupported")
                points.append(rec)

        points.sort(key=lambda p: (p["t"], p["swap"]))
        n = len(points)
        S = len(self._used_swaps)

        times = np.array([p["t"] for p in points])
        dt_chain = np.diff(np.concatenate([[0.0], times]))
        is_mat = np.array([p["is_mat"] for p in points])
        swap_of = np.array([p["swap"] for p in points], dtype=np.int32)
        seg_of = np.concatenate(
            [[0], np.cumsum(is_mat.astype(np.int32))[:-1]]).astype(np.int32)

        mat_pos = np.full(S, -1, dtype=np.int32)
        for i, p in enumerate(points):
            if p["is_mat"]:
                mat_pos[p["swap"]] = i
        if np.any(mat_pos < 0):
            raise LibError("Every calibration swap needs a maturity flow")

        live = ~is_mat
        swap_onehot = np.zeros((S, n))
        seg_onehot = np.zeros((S + 1, n))
        for i in range(n):
            if live[i]:
                swap_onehot[swap_of[i], i] = 1.0
            seg_onehot[seg_of[i], i] = 1.0

        # first occurrence of each (rounded) node time
        seen = {}
        unique_sel = []
        for i in range(n):
            key = round(times[i], 9)
            if key not in seen:
                seen[key] = i
                unique_sel.append(i)

        return XccyBootstrapPlan(
            times=times,
            pay_t_foreign=np.array([p["pay_tf"] for p in points]),
            start_t=np.array([p["start_t"] for p in points]),
            end_t=np.array([p["end_t"] for p in points]),
            notionals=np.array([p["notional"] for p in points]),
            spread_sens=np.array([p["spread_sens"] for p in points]),
            alpha_ratio=np.array([p["alpha_ratio"] for p in points]),
            dt_chain=dt_chain,
            is_mat=is_mat,
            is_notl=np.array([p["is_notl"] for p in points]),
            is_last=np.array([p["is_last"] for p in points]),
            swap_of=swap_of,
            seg_of=seg_of,
            mat_pos=mat_pos,
            swap_onehot=swap_onehot,
            seg_onehot=seg_onehot,
            v0=v0,
            unique_sel=np.array(unique_sel, dtype=np.int32),
            foreign_sign=-1.0)

    # ------------------------------------------------------------------

    def _foreign_plan(self):
        """Static-weight interp plan for the bootstrap's foreign-curve
        queries (the schedule AND the parent grid times are fixed once
        the curve set exists); None for a fitted foreign scheme."""
        it = self._foreign_curve._interp_type
        if it not in _SIMPLE_SCHEMES:
            return None
        q = np.concatenate([np.asarray(self._plan.start_t),
                            np.asarray(self._plan.end_t),
                            np.asarray(self._plan.pay_t_foreign)])
        return simple_interp_plan(
            q, self._foreign_curve._times.numpy(), it)

    # ------------------------------------------------------------------

    def df(self, dt, day_count=None):
        """DFs always under ACT/365F — node times are stored in those
        units (day_count is ignored)."""
        times = times_from_dates(dt, self._value_dt, DayCountTypes.ACT_365F)
        dfs = self.df_t(times).numpy()
        if isinstance(dt, Date):
            return float(dfs[0])
        return dfs

    # ------------------------------------------------------------------

    def _check_refits(self, swap_tol: float):
        """Every calibration basis swap must have |PV|/notional < tol in
        domestic currency on the built curve."""
        for swap in self._used_swaps:
            v = swap.value(value_dt=self._value_dt,
                           domestic_discount_curve=self._domestic_curve,
                           foreign_discount_curve=self._foreign_curve,
                           xccy_discount_curve=self,
                           spot_fx=self._spot_fx)
            v_norm = v / swap._domestic_notional
            if abs(v_norm) > swap_tol:
                raise LibError(
                    f"XCCY swap with maturity {swap._maturity_dt} not "
                    f"repriced: normalized PV {v_norm:.3e} exceeds "
                    f"{swap_tol:.1e}")

    # ------------------------------------------------------------------

    def __repr__(self):
        s = label_to_string("OBJECT TYPE", type(self).__name__)
        s += label_to_string("VALUATION DATE", self._value_dt)
        s += label_to_string("SPOT FX (dom/for)", self._spot_fx)
        s += label_to_string("INTERPOLATION", self._interp_type)
        for i, swap in enumerate(self._used_swaps):
            s += label_to_string(
                f"{self.swap_times[i]:8.4f}",
                f"{self.basis_spreads[i] * 1e4:8.2f}bp")
        return s


def find_xccy_curve(model, derivative, allow_fallback: bool = False):
    """Locate the XCCY curve calibrated for this currency pair by EXACT
    index match (port of ``adrates_tpu/market/position/engine_xccy.py``
    ``find_xccy_curve``). A mismatched pair raises — discounting a trade
    on some other pair's basis curve silently mislabels the whole risk
    ladder. ``allow_fallback=True`` opts back in to "any single
    XccyCurve" for deliberately index-agnostic setups."""
    dom_idx = derivative._domestic_floating_index
    for_idx = derivative._foreign_floating_index
    candidates = [(name, c) for name, c in model._curves_dict.items()
                  if isinstance(c, XccyCurve)]
    for name, curve in candidates:
        if (getattr(curve, "_domestic_index", None) == dom_idx
                and getattr(curve, "_foreign_index", None) == for_idx):
            return name, curve
    if allow_fallback and len(candidates) == 1:
        return candidates[0]
    raise LibError(
        f"No XCCY curve found in model for pair "
        f"{for_idx.name}/{dom_idx.name}. Build one with "
        f"model.build_xccy_curve(...). Available XCCY curves: "
        f"{[n for n, _ in candidates]}")
