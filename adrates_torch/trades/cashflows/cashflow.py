"""Single fixed cashflow instrument.

Copy of ``adrates_tpu/trades/cashflows/cashflow.py`` (plain Python): one
fixed payment on a date (with optional lag + calendar adjustment), valued
as amount x relative DF.
"""

from __future__ import annotations

from typing import Union

from ...utils.calendar import BusDayAdjustTypes, Calendar, CalendarTypes
from ...utils.currency import CurrencyTypes
from ...utils.date import Date
from ...utils.day_count import DayCountTypes
from ...utils.error import LibError


class SingleFixedCashflow:
    """One fixed payment of ``amount`` on ``payment_dt``."""

    def __init__(self,
                 payment_dt_or_tenor: Union[Date, str],
                 amount: float,
                 currency: CurrencyTypes,
                 anchor_dt: Date = None,
                 payment_lag: int = 0,
                 cal_type: CalendarTypes = CalendarTypes.WEEKEND,
                 bd_type: BusDayAdjustTypes = BusDayAdjustTypes.FOLLOWING):
        if isinstance(payment_dt_or_tenor, Date):
            payment_dt = payment_dt_or_tenor
        else:
            if anchor_dt is None:
                raise LibError("anchor_dt required when a tenor is given")
            payment_dt = anchor_dt.add_tenor(payment_dt_or_tenor)

        calendar = Calendar(cal_type)
        if payment_lag:
            payment_dt = calendar.add_business_days(payment_dt, payment_lag)
        self._payment_dt = calendar.adjust(payment_dt, bd_type)
        self._amount = amount
        self._currency = currency

    def value(self, value_dt: Date, discount_curve,
              day_count: DayCountTypes = DayCountTypes.ACT_ACT_ISDA
              ) -> float:
        """amount x DF(payment)/DF(value); zero once the date has passed."""
        if self._payment_dt <= value_dt:
            return 0.0
        df = discount_curve.df(self._payment_dt, day_count) \
            / discount_curve.df(value_dt, day_count)
        return self._amount * df

    def print_valuation(self, value_dt: Date, discount_curve,
                        day_count: DayCountTypes = DayCountTypes.ACT_ACT_ISDA
                        ) -> None:
        """One-row payment/DF/PV table (reference cashflow.py:116-149)."""
        from ...utils.helpers import format_table
        if self._payment_dt <= value_dt:
            df, pv = 0.0, 0.0
        else:
            df = float(discount_curve.df(self._payment_dt, day_count)
                       / discount_curve.df(value_dt, day_count))
            pv = self._amount * df
        print(format_table(
            ["PAY_NUM", "PAY_dt", "AMOUNT", "DF", "PV", "CUM_PV"],
            [[1, str(self._payment_dt), round(self._amount, 2),
              round(df, 6), round(pv, 2), round(pv, 2)]]))

    def __repr__(self):
        return (f"SingleFixedCashflow({self._amount} "
                f"{self._currency.name} @ {self._payment_dt})")
