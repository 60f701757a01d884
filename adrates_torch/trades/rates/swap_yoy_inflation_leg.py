"""Year-on-year inflation leg.

Copy of ``adrates_tpu/trades/rates/swap_yoy_inflation_leg.py`` (plain
Python): annual observation windows
(yoy_start = accrual end - 12M), per payment N*alpha*((I_e/I_s - 1) +
spread) discounted under the leg's day count.
"""

from __future__ import annotations

from typing import Union

import numpy as np

from ...market.indices.inflation_index import InflationIndex
from ...utils import ONE_MILLION
from ...utils.calendar import (BusDayAdjustTypes, Calendar, CalendarTypes,
                               DateGenRuleTypes)
from ...utils.date import Date
from ...utils.day_count import DayCount, DayCountTypes
from ...utils.error import LibError
from ...utils.frequency import FrequencyTypes
from ...utils.global_types import InstrumentTypes, SwapTypes
from ...utils.helpers import format_table
from ...utils.schedule import Schedule


class SwapYoYInflationLeg:
    """Periodic payments linked to year-on-year index growth."""

    def __init__(self,
                 effective_dt: Date,
                 end_dt: Union[Date, str],
                 leg_type: SwapTypes,
                 inflation_index: InflationIndex,
                 freq_type: FrequencyTypes,
                 notional: float = ONE_MILLION,
                 spread: float = 0.0,
                 dc_type: DayCountTypes = DayCountTypes.ACT_365F,
                 payment_lag: int = 0,
                 cal_type: CalendarTypes = CalendarTypes.WEEKEND,
                 bd_type: BusDayAdjustTypes = BusDayAdjustTypes.FOLLOWING,
                 dg_type: DateGenRuleTypes = DateGenRuleTypes.BACKWARD,
                 end_of_month: bool = False):
        self.instrument_type = InstrumentTypes.SWAP_YOY_INFLATION_LEG

        if isinstance(end_dt, Date):
            self._termination_dt = end_dt
        else:
            self._termination_dt = effective_dt.add_tenor(end_dt)

        calendar = Calendar(cal_type)
        self._maturity_dt = calendar.adjust(self._termination_dt, bd_type)
        if effective_dt > self._maturity_dt:
            raise LibError("Start date after maturity date")

        self._effective_dt = effective_dt
        self._leg_type = leg_type
        self._inflation_index = inflation_index
        self._freq_type = freq_type
        self._notional = notional
        self._spread = spread
        self._dc_type = dc_type
        self._payment_lag = payment_lag
        self._cal_type = cal_type
        self._bd_type = bd_type
        self._dg_type = dg_type
        self._end_of_month = end_of_month

        self.generate_payment_schedule()

    # ------------------------------------------------------------------

    def generate_payment_schedule(self):
        schedule = Schedule(self._effective_dt, self._termination_dt,
                            self._freq_type, self._cal_type, self._bd_type,
                            self._dg_type,
                            end_of_month=self._end_of_month)
        schedule_dts = schedule._adjusted_dts
        if len(schedule_dts) < 2:
            raise LibError("Schedule has none or only one date")

        calendar = Calendar(self._cal_type)
        day_counter = DayCount(self._dc_type)

        self._start_accrued_dts = []
        self._end_accrued_dts = []
        self._payment_dts = []
        self._year_fracs = []
        self._accrued_days = []
        self._yoy_start_dts = []
        self._yoy_end_dts = []

        for i in range(1, len(schedule_dts)):
            start_dt = schedule_dts[i - 1]
            end_dt = schedule_dts[i]
            year_frac, num, _ = day_counter.year_frac(start_dt, end_dt)
            if self._payment_lag == 0:
                payment_dt = end_dt
            else:
                payment_dt = calendar.add_business_days(end_dt,
                                                        self._payment_lag)
            self._start_accrued_dts.append(start_dt)
            self._end_accrued_dts.append(end_dt)
            self._payment_dts.append(payment_dt)
            self._year_fracs.append(year_frac)
            self._accrued_days.append(num)
            # observation window: end vs one year before end
            self._yoy_end_dts.append(end_dt)
            self._yoy_start_dts.append(end_dt.add_months(-12))

    # ------------------------------------------------------------------

    def value(self, value_dt: Date, discount_curve,
              inflation_curve=None) -> float:
        """Sum of N*alpha*((I_e/I_s - 1) + spread) * DF over future
        payments."""
        if inflation_curve is not None:
            self._inflation_index.set_inflation_curve(inflation_curve)

        self._start_cpis = []
        self._end_cpis = []
        self._yoy_rates = []
        self._payments = []
        self._dfs = []
        self._pvs = []

        leg_pv = 0.0
        for i, payment_dt in enumerate(self._payment_dts):
            if payment_dt <= value_dt:
                for arr in (self._start_cpis, self._end_cpis,
                            self._yoy_rates, self._payments, self._dfs,
                            self._pvs):
                    arr.append(0.0)
                continue
            start_cpi = self._inflation_index.get_index(
                self._yoy_start_dts[i], apply_lag=True)
            end_cpi = self._inflation_index.get_index(
                self._yoy_end_dts[i], apply_lag=True)
            if start_cpi <= 0.0:
                raise LibError(
                    f"Start CPI must be positive, got {start_cpi}")
            yoy_rate = end_cpi / start_cpi - 1.0
            payment = self._notional * self._year_fracs[i] \
                * (yoy_rate + self._spread)
            df = discount_curve.df(payment_dt, self._dc_type) \
                / discount_curve.df(value_dt, self._dc_type)
            pv = payment * df

            self._start_cpis.append(start_cpi)
            self._end_cpis.append(end_cpi)
            self._yoy_rates.append(yoy_rate)
            self._payments.append(payment)
            self._dfs.append(df)
            self._pvs.append(pv)
            leg_pv += pv

        if self._leg_type == SwapTypes.PAY:
            leg_pv = -leg_pv
        return leg_pv

    # ------------------------------------------------------------------

    def print_payments(self):
        header = ["PAY_NUM", "PAY_dt", "YOY_START", "YOY_END", "YEARFRAC"]
        rows = [[i + 1, str(self._payment_dts[i]),
                 str(self._yoy_start_dts[i]), str(self._yoy_end_dts[i]),
                 round(self._year_fracs[i], 6)]
                for i in range(len(self._payment_dts))]
        print(format_table(header, rows))

    def print_valuation(self):
        """Per-payment PV table (reference swap_yoy_inflation_leg.py
        print_valuation) — requires a prior value()."""
        if not hasattr(self, "_pvs"):
            raise LibError("Leg has not been valued — call value() first")
        sign = -1.0 if self._leg_type == SwapTypes.PAY else 1.0
        header = ["PAY_NUM", "PAY_dt", "YOY_RATE", "PMNT", "DF", "PV",
                  "CUM_PV"]
        cum = 0.0
        rows = []
        for i in range(len(self._payment_dts)):
            pv = sign * float(self._pvs[i])
            cum += pv
            rows.append([i + 1, str(self._payment_dts[i]),
                         round(float(self._yoy_rates[i]), 8),
                         round(float(self._payments[i]), 2),
                         round(float(self._dfs[i]), 6),
                         round(pv, 2), round(cum, 2)])
        print(format_table(header, rows))

    def __repr__(self):
        return (f"SwapYoYInflationLeg({self._effective_dt} -> "
                f"{self._maturity_dt}, {self._leg_type.name}, "
                f"{self._freq_type.name}, N={self._notional})")
