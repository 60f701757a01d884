"""OIS discount curve bootstrapped from par swap quotes.

Port of ``adrates_tpu/trades/rates/ois_curve.py`` (behavioral parity with
the reference's input prep 113-154, cashflow bootstrap 156-212 and refit
gate 344-358 at SWAP_TOL=1e-10). The curve is built on the host: the
static plan in numpy, the bootstrap as CPU float64 torch ops
(``ops/bootstrap.py``), shared with the book path's batched stages. The
refit gate prices the calibration swaps on the curve's own scheme, any
of the eight.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ...market.curves.discount_curve import DiscountCurve
from ...ops.bootstrap import bootstrap_ois, plan_to_torch, prepare_ois_plan
from ...parallel.book import book_pvs, compile_book
from ...utils.date import Date
from ...utils.day_count import DayCount
from ...utils.error import LibError
from ...utils.frequency import FrequencyTypes
from ...utils.global_types import InterpTypes
from ...utils.helpers import label_to_string
from ...utils.observability import timed

SWAP_TOL = 1e-10


class OISCurve(DiscountCurve):
    """Discount curve implied by par OIS rates (solver-free cashflow
    bootstrap, differentiable end-to-end w.r.t. the quotes)."""

    def __init__(self,
                 value_dt: Date,
                 ois_swaps: list,
                 interp_type: InterpTypes = InterpTypes.FLAT_FWD_RATES,
                 check_refit: bool = False):
        self._value_dt = value_dt
        self._used_swaps = ois_swaps
        self._interp_type = interp_type
        self._check_refit = check_refit

        with timed("curve.build.ois", pillars=len(ois_swaps),
                   interp=interp_type.name):
            self._prepare_curve_builder_inputs()
            self._plan = prepare_ois_plan(
                self.swap_times, self.year_fracs,
                loglinear_rates=all(r > 0 for r in self.swap_rates))
            plan = plan_to_torch(self._plan, "cpu")
            rates = torch.tensor(self.swap_rates, dtype=torch.float64)
            self._times, self._dfs = bootstrap_ois(rates, plan)
            self._repr_dfs = self._dfs.numpy()[
                np.asarray(self._plan.pillar_point) + 1]
            self._freq_type = FrequencyTypes.CONTINUOUS

            if check_refit:
                with timed("curve.refit.ois", pillars=len(ois_swaps)):
                    self._check_refits(SWAP_TOL)

    # ------------------------------------------------------------------

    def _prepare_curve_builder_inputs(self):
        """Per-swap (rate, pillar time, fixed-leg year fracs). Pillar time
        is anchored on the last *coupon* date (holiday-adjusted), in units
        of the float-leg day count's fixed denominator
        (ois_curve.py:128-154)."""
        self._dc_type = self._used_swaps[0]._float_leg._dc_type
        dcc = DayCount(self._dc_type)
        days_in_year = dcc.days_in_year()

        swap_rates: List[float] = []
        swap_times: List[float] = []
        year_fracs: List[list] = []
        prev_t = -1.0
        for swap in self._used_swaps:
            maturity_dt = swap._adjusted_fixed_dts[-1]
            tswap = (maturity_dt - self._value_dt) / days_in_year
            if tswap <= prev_t:
                raise LibError(
                    "Swaps must be sorted by increasing maturity")
            prev_t = tswap
            swap_rates.append(swap._fixed_coupon)
            swap_times.append(tswap)
            year_fracs.append(list(swap._fixed_leg._year_fracs))

        self.swap_rates = swap_rates
        self.swap_times = swap_times
        self.year_fracs = year_fracs
        return swap_rates

    # ------------------------------------------------------------------

    def _check_refits(self, swap_tol: float):
        """Reprice every calibration swap on the built curve in one
        batched pass; hard-fail if any normalized PV exceeds the tolerance
        (ois_curve.py:344-358)."""
        book = compile_book(self._used_swaps, self._value_dt,
                            index_dc=self._dc_type)
        pvs = book_pvs(torch.tensor(self.swap_rates, dtype=torch.float64),
                       plan_to_torch(self._plan, "cpu"), self._interp_type,
                       book, self._times.numpy())
        self._check_refit_pvs(pvs.numpy(), swap_tol)

    def _check_refit_pvs(self, pvs, swap_tol: float):
        for swap, pv in zip(self._used_swaps, pvs):
            v = pv / swap._notional
            if abs(v) > swap_tol:
                raise LibError(
                    f"Swap with maturity {swap._maturity_dt} not repriced: "
                    f"normalized PV {v:.3e} exceeds tol {swap_tol:.1e}")

    # ------------------------------------------------------------------

    def __repr__(self):
        s = label_to_string("OBJECT TYPE", type(self).__name__)
        s += label_to_string("VALUE DATE", self._value_dt)
        s += label_to_string("INTERP TYPE", self._interp_type)
        s += label_to_string("PILLARS", "")
        for t, df in zip(self._times.tolist(), self._dfs.tolist()):
            s += label_to_string(f"{t:10.6f}", f"{df:14.10f}")
        return s
