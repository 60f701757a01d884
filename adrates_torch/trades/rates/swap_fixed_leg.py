"""Fixed swap leg: ISDA schedule → static payment tensor.

Behavioral parity with the reference's cavour/trades/rates/swap_fixed_leg.py
(generate_payments 131-196, value 200-245). Valuation is vectorized: the
date loop is replaced by one interpolation call over the compiled
payment-time array, and ``tensor()`` exposes the leg as a FixedLegTensor for
the book compilers.
"""

from __future__ import annotations

from typing import Union

import numpy as np

from ...ops.pricers import FixedLegTensor
from ...utils import ONE_MILLION
from ...utils.calendar import (BusDayAdjustTypes, Calendar, CalendarTypes,
                               DateGenRuleTypes)
from ...utils.currency import CurrencyTypes
from ...utils.date import Date
from ...utils.day_count import DayCount, DayCountTypes
from ...utils.error import LibError
from ...utils.frequency import FrequencyTypes
from ...utils.global_types import CurveTypes, InstrumentTypes, SwapTypes
from ...utils.helpers import format_table, times_from_dates
from ...utils.schedule import Schedule


class SwapFixedLeg:
    """Fixed leg of a swap: a strip of alpha*N*c coupons on an ISDA
    schedule, optionally with a principal at maturity."""

    def __init__(self,
                 effective_dt: Date,
                 end_dt: Union[Date, str],
                 leg_type: SwapTypes,
                 coupon: float,
                 freq_type: FrequencyTypes,
                 dc_type: DayCountTypes,
                 floating_index: CurveTypes,
                 currency: CurrencyTypes,
                 notional: float = ONE_MILLION,
                 principal: float = 0.0,
                 payment_lag: int = 0,
                 cal_type: CalendarTypes = CalendarTypes.WEEKEND,
                 bd_type: BusDayAdjustTypes = BusDayAdjustTypes.FOLLOWING,
                 dg_type: DateGenRuleTypes = DateGenRuleTypes.BACKWARD,
                 end_of_month: bool = False):
        self.instrument_type = InstrumentTypes.SWAP_FIXED_LEG

        if isinstance(end_dt, Date):
            self._termination_dt = end_dt
        else:
            self._termination_dt = effective_dt.add_tenor(end_dt)

        calendar = Calendar(cal_type)
        self._maturity_dt = calendar.adjust(self._termination_dt, bd_type)
        if effective_dt > self._maturity_dt:
            raise LibError("Effective date after maturity date")

        self._effective_dt = effective_dt
        self._end_dt = end_dt
        self._leg_type = leg_type
        self._freq_type = freq_type
        self._payment_lag = payment_lag
        self._notional = notional
        self._principal = principal
        self._cpn = coupon
        self._floating_index = floating_index
        self._currency = currency
        self._dc_type = dc_type
        self._cal_type = cal_type
        self._bd_type = bd_type
        self._dg_type = dg_type
        self._end_of_month = end_of_month

        self.generate_payments()

    # ------------------------------------------------------------------

    def generate_payments(self):
        """Compile the schedule into static payment arrays."""
        schedule = Schedule(self._effective_dt, self._termination_dt,
                            self._freq_type, self._cal_type, self._bd_type,
                            self._dg_type, end_of_month=self._end_of_month)
        schedule_dts = schedule._adjusted_dts
        if len(schedule_dts) < 2:
            raise LibError("Schedule has none or only one date")

        day_counter = DayCount(self._dc_type)
        calendar = Calendar(self._cal_type)

        self._start_accrued_dts = []
        self._end_accrued_dts = []
        self._payment_dts = []
        self._payment_dts_ad = []
        self._adjusted_fixed_dts = []
        self._payments = []
        self._year_fracs = []
        self._accrued_days = []
        self._rates = []

        prev_dt = schedule_dts[0]
        for next_dt in schedule_dts[1:]:
            self._start_accrued_dts.append(prev_dt)
            self._end_accrued_dts.append(next_dt)
            if self._payment_lag == 0:
                payment_dt = next_dt
            else:
                payment_dt = calendar.add_business_days(next_dt,
                                                        self._payment_lag)
            self._payment_dts_ad.append(
                day_counter.year_frac(self._effective_dt, next_dt)[0])
            self._payment_dts.append(payment_dt)
            self._adjusted_fixed_dts.append(payment_dt)

            year_frac, num, _ = day_counter.year_frac(prev_dt, next_dt)
            self._rates.append(self._cpn)
            self._payments.append(year_frac * self._notional * self._cpn)
            self._year_fracs.append(year_frac)
            self._accrued_days.append(num)
            prev_dt = next_dt

    # ------------------------------------------------------------------

    def tensor(self, value_dt: Date,
               discount_dc: DayCountTypes = None) -> FixedLegTensor:
        """Compile to the static pricing tensor (times under the leg's
        own day count, engine parity: engine.py:2520-2528).

        ``discount_dc`` overrides the basis for the DISCOUNT query times —
        needed when the discount curve converts dates with a fixed basis
        regardless of the caller's (XccyCurve.df pins ACT/365F).

        Memoized per (value date, basis): warm engine requests skip the
        per-payment Python date arithmetic entirely."""
        ddc = discount_dc or self._dc_type
        memo_key = (value_dt.serial(), ddc)
        memo = self.__dict__.setdefault("_tensor_memo", {})
        cached = memo.get(memo_key)
        if cached is not None:
            return cached
        out = self._tensor_uncached(value_dt, ddc)
        memo[memo_key] = out
        return out

    def _tensor_uncached(self, value_dt: Date,
                         ddc: DayCountTypes) -> FixedLegTensor:
        payment_times = np.asarray(
            times_from_dates(self._payment_dts, value_dt, ddc))
        return FixedLegTensor(
            payment_times=payment_times,
            payments=np.array(self._payments, dtype=np.float64),
            principal=np.float64(self._principal * self._notional),
            leg_sign=np.float64(
                1.0 if self._leg_type == SwapTypes.RECEIVE else -1.0),
            value_time=np.float64(
                times_from_dates(value_dt, value_dt, ddc)))

    # ------------------------------------------------------------------

    def value(self, value_dt: Date, discount_curve) -> float:
        """PV on a discount curve. Vectorized equivalent of the reference's
        date loop (swap_fixed_leg.py:200-245); also stores the per-payment
        dfs/pvs for reporting."""
        # ONE batched DF query
        df_value = discount_curve.df(value_dt, self._dc_type)
        dfs = np.asarray(discount_curve.df(list(self._payment_dts),
                                           self._dc_type)) / df_value
        amounts = np.array(self._payments)
        future = np.array([dt > value_dt for dt in self._payment_dts])

        pvs = np.where(future, amounts * dfs, 0.0)
        leg_pv = float(np.sum(pvs))

        self._payment_dfs = list(np.where(future, dfs, 0.0))
        self._payment_pvs = list(pvs)
        self._cumulative_pvs = list(np.cumsum(pvs) * future)

        if future[-1]:
            principal_pv = self._principal * dfs[-1] * self._notional
            self._payment_pvs[-1] += principal_pv
            leg_pv += principal_pv
            self._cumulative_pvs[-1] = leg_pv

        if self._leg_type == SwapTypes.PAY:
            leg_pv = -leg_pv
        return leg_pv

    # ------------------------------------------------------------------

    def print_payments(self):
        header = ["PAY_NUM", "PAY_dt", "ACCR_START", "ACCR_END", "DAYS",
                  "YEARFRAC", "RATE", "PMNT"]
        rows = [[i + 1, str(self._payment_dts[i]),
                 str(self._start_accrued_dts[i]),
                 str(self._end_accrued_dts[i]), self._accrued_days[i],
                 round(self._year_fracs[i], 6), round(self._rates[i], 6),
                 round(self._payments[i], 2)]
                for i in range(len(self._payment_dts))]
        print(format_table(header, rows))

    def print_valuation(self):
        if not hasattr(self, "_payment_dfs"):
            raise LibError("Leg has not been valued — call value() first")
        header = ["PAY_NUM", "PAY_dt", "PMNT", "DF", "PV", "CUM_PV"]
        rows = [[i + 1, str(self._payment_dts[i]),
                 round(self._payments[i], 2),
                 round(float(self._payment_dfs[i]), 6),
                 round(float(self._payment_pvs[i]), 2),
                 round(float(self._cumulative_pvs[i]), 2)]
                for i in range(len(self._payment_dts))]
        print(format_table(header, rows))

    def __repr__(self):
        return (f"SwapFixedLeg({self._effective_dt} -> {self._maturity_dt}, "
                f"{self._leg_type.name}, cpn={self._cpn}, "
                f"{self._freq_type.name}, {self._dc_type.name}, "
                f"N={self._notional})")
