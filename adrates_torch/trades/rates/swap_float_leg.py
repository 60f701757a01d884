"""Floating swap leg: schedule compilation + dual-curve valuation.

Behavioral parity with the reference's cavour/trades/rates/swap_float_leg.py
(generate_payment_dts 130-187, value 190-352 incl. first-fixing override and
notional exchanges). Valuation is vectorized and stateless — notional
exchanges are priced directly (−N at effective, +N at maturity) instead of
the reference's mutable array-insertion bookkeeping (swap_float_leg.py:
283-347), which is order-dependent and idempotence-fragile.
"""

from __future__ import annotations

from typing import Union

import numpy as np

from ...ops.pricers import FloatLegTensor
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


class SwapFloatLeg:
    """Floating leg: forwards projected from an index curve over an ISDA
    schedule, with optional spread, principal and notional exchanges."""

    def __init__(self,
                 effective_dt: Date,
                 end_dt: Union[Date, str],
                 leg_type: SwapTypes,
                 spread: float,
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
                 end_of_month: bool = False,
                 notional_exchange: bool = False):
        self.instrument_type = InstrumentTypes.SWAP_FLOAT_LEG

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
        self._spread = spread
        self._floating_index = floating_index
        self._currency = currency
        self._dc_type = dc_type
        self._cal_type = cal_type
        self._bd_type = bd_type
        self._dg_type = dg_type
        self._end_of_month = end_of_month
        self._notional_exchange = notional_exchange
        self._notional_array = []

        self.generate_payment_dts()

    # ------------------------------------------------------------------

    def generate_payment_dts(self):
        """Compile the schedule; coupons are projected later from a curve."""
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
        self._payment_dts_float = []
        self._payment_dts_ad = []
        self._year_fracs = []
        self._accrued_days = []

        prev_dt = schedule_dts[0]
        cum = 0.0
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

            year_frac, num, _ = day_counter.year_frac(prev_dt, next_dt)
            cum += year_frac
            self._payment_dts_float.append(cum)
            self._year_fracs.append(year_frac)
            self._accrued_days.append(num)
            prev_dt = next_dt

    # ------------------------------------------------------------------

    def _notionals(self) -> np.ndarray:
        n = len(self._payment_dts)
        if not self._notional_array:
            return np.full(n, self._notional, dtype=float)
        arr = np.asarray(self._notional_array, dtype=float)
        if arr.size != n:
            raise LibError("Notional array length mismatch")
        return arr

    def tensor(self, value_dt: Date,
               first_fixing_rate: float = None,
               index_dc: DayCountTypes = None,
               discount_dc: DayCountTypes = None) -> FloatLegTensor:
        """Compile to the static pricing tensor (times under the leg's
        own day count, engine parity: engine.py:2858-2878).

        ``index_dc`` is the projection curve's day count: forwards divide
        the DF ratio by accrual fractions in THAT basis (value() parity);
        defaults to the leg's own day count when the two coincide.
        ``discount_dc`` overrides the basis for the DISCOUNT query times
        (payment/value/exchange) — XccyCurve.df pins ACT/365F regardless
        of the caller's basis.

        Memoized per (value date, bases, fixing): warm engine requests
        skip the per-payment Python date arithmetic entirely."""
        dc = self._dc_type
        ddc = discount_dc or dc
        memo_key = (value_dt.serial(), first_fixing_rate, index_dc, ddc)
        memo = self.__dict__.setdefault("_tensor_memo", {})
        cached = memo.get(memo_key)
        if cached is not None:
            return cached
        out = self._tensor_uncached(value_dt, first_fixing_rate, index_dc,
                                    ddc)
        memo[memo_key] = out
        return out

    def _tensor_uncached(self, value_dt, first_fixing_rate, index_dc,
                         ddc) -> FloatLegTensor:
        dc = self._dc_type
        if index_dc is None or index_dc == dc:
            index_alphas = np.array(self._year_fracs, dtype=np.float64)
        else:
            counter = DayCount(index_dc)
            index_alphas = np.array(
                [counter.year_frac(s, e)[0]
                 for s, e in zip(self._start_accrued_dts,
                                 self._end_accrued_dts)], dtype=np.float64)
        override = first_fixing_rate is not None
        return FloatLegTensor(
            payment_times=np.asarray(
                times_from_dates(self._payment_dts, value_dt, ddc)),
            start_times=np.asarray(
                times_from_dates(self._start_accrued_dts, value_dt, dc)),
            end_times=np.asarray(
                times_from_dates(self._end_accrued_dts, value_dt, dc)),
            pay_alphas=np.array(self._year_fracs, dtype=np.float64),
            index_alphas=index_alphas,
            notionals=self._notionals(),
            spreads=np.full(len(self._year_fracs), self._spread),
            principal=np.float64(self._principal * self._notional),
            leg_sign=np.float64(
                1.0 if self._leg_type == SwapTypes.RECEIVE else -1.0),
            value_time=np.float64(
                times_from_dates(value_dt, value_dt, ddc)),
            first_fixing_rate=np.float64(
                first_fixing_rate if override else 0.0),
            notional_exchange_amount=np.float64(
                float(self._notional) if self._notional_exchange else 0.0),
            effective_time=np.float64(
                times_from_dates(self._effective_dt, value_dt, ddc)),
            maturity_time=np.float64(
                times_from_dates(self._maturity_dt, value_dt, ddc)),
            cap_rate=np.float64(np.inf),
            floor_rate=np.float64(-np.inf),
            override_first=override,
            notional_exchange=self._notional_exchange,
            has_cap_floor=False)

    # ------------------------------------------------------------------

    def value(self, value_dt: Date, discount_curve, index_curve=None,
              first_fixing_rate: float = None) -> float:
        """PV: forwards off the index curve, discounted on the discount
        curve; optional first-fixing override and notional exchanges."""
        if discount_curve is None:
            raise LibError("Discount curve is None")
        if index_curve is None:
            index_curve = discount_curve

        dc = self._dc_type
        df_value = discount_curve.df(value_dt, dc)
        n = len(self._payment_dts)
        notionals = self._notionals()

        index_dc = index_curve._dc_type
        index_counter = DayCount(index_dc)

        future = np.array([dt > value_dt for dt in self._payment_dts])
        df_start = np.asarray(index_curve.df(
            list(self._start_accrued_dts), dc))
        df_end = np.asarray(index_curve.df(
            list(self._end_accrued_dts), dc))
        index_alphas = np.array([
            index_counter.year_frac(s, e)[0]
            for s, e in zip(self._start_accrued_dts, self._end_accrued_dts)])
        with np.errstate(divide="ignore", invalid="ignore"):
            fwd = np.where(index_alphas > 0,
                           (df_start / df_end - 1.0) / index_alphas, 0.0)

        # First future payment may take a known fixing.
        if first_fixing_rate is not None:
            future_idx = np.nonzero(future)[0]
            if future_idx.size:
                fwd[future_idx[0]] = first_fixing_rate

        pay_alphas = np.array(self._year_fracs)
        amounts = (fwd + self._spread) * pay_alphas * notionals
        df_pmts = np.asarray(discount_curve.df(
            list(self._payment_dts), dc)) / df_value
        pvs = np.where(future, amounts * df_pmts, 0.0)
        leg_pv = float(np.sum(pvs))

        self._rates = list(np.where(future, fwd, 0.0))
        self._payments = list(np.where(future, amounts, 0.0))
        self._payment_dfs = list(np.where(future, df_pmts, 0.0))
        self._payment_pvs = list(pvs)
        self._cumulative_pvs = list(np.cumsum(pvs) * future)

        if future[-1]:
            principal_pv = self._principal * df_pmts[-1] * notionals[-1]
            self._payment_pvs[-1] += principal_pv
            leg_pv += principal_pv
            self._cumulative_pvs[-1] = leg_pv

        if self._notional_exchange:
            if self._effective_dt >= value_dt:
                df_eff = discount_curve.df(self._effective_dt, dc) / df_value
                leg_pv += -self._notional * df_eff
            if self._maturity_dt >= value_dt:
                df_mat = discount_curve.df(self._maturity_dt, dc) / df_value
                leg_pv += self._notional * df_mat

        if self._leg_type == SwapTypes.PAY:
            leg_pv = -leg_pv
        return leg_pv

    # ------------------------------------------------------------------

    def print_payments(self):
        header = ["PAY_NUM", "PAY_dt", "ACCR_START", "ACCR_END", "DAYS",
                  "YEARFRAC"]
        rows = [[i + 1, str(self._payment_dts[i]),
                 str(self._start_accrued_dts[i]),
                 str(self._end_accrued_dts[i]), self._accrued_days[i],
                 round(self._year_fracs[i], 6)]
                for i in range(len(self._payment_dts))]
        print(format_table(header, rows))

    def print_valuation(self):
        if not hasattr(self, "_payment_pvs"):
            raise LibError("Leg has not been valued — call value() first")
        header = ["PAY_NUM", "PAY_dt", "RATE", "PMNT", "DF", "PV", "CUM_PV"]
        rows = [[i + 1, str(self._payment_dts[i]),
                 round(float(self._rates[i]), 6),
                 round(float(self._payments[i]), 2),
                 round(float(self._payment_dfs[i]), 6),
                 round(float(self._payment_pvs[i]), 2),
                 round(float(self._cumulative_pvs[i]), 2)]
                for i in range(len(self._payment_dts))]
        print(format_table(header, rows))

    def __repr__(self):
        return (f"SwapFloatLeg({self._effective_dt} -> {self._maturity_dt}, "
                f"{self._leg_type.name}, spread={self._spread}, "
                f"{self._freq_type.name}, {self._dc_type.name}, "
                f"N={self._notional})")
