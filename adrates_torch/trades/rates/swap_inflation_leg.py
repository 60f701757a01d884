"""Zero-coupon inflation leg: single payment N * (I_final/I_base - 1).

Copy of ``adrates_tpu/trades/rates/swap_inflation_leg.py`` (plain
Python): lagged base and final CPI through the index, discounting under
ACT/365F.
"""

from __future__ import annotations

from typing import Union

from ...market.indices.inflation_index import InflationIndex
from ...utils import ONE_MILLION
from ...utils.calendar import BusDayAdjustTypes, Calendar, CalendarTypes
from ...utils.date import Date
from ...utils.day_count import DayCountTypes
from ...utils.error import LibError
from ...utils.global_types import InstrumentTypes, SwapTypes
from ...utils.helpers import format_table, label_to_string


class SwapInflationLeg:
    """One inflation-linked exchange at maturity."""

    def __init__(self,
                 effective_dt: Date,
                 end_dt: Union[Date, str],
                 leg_type: SwapTypes,
                 inflation_index: InflationIndex,
                 notional: float = ONE_MILLION,
                 payment_lag: int = 0,
                 cal_type: CalendarTypes = CalendarTypes.WEEKEND,
                 bd_type: BusDayAdjustTypes = BusDayAdjustTypes.FOLLOWING):
        self.instrument_type = InstrumentTypes.SWAP_INFLATION_LEG

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
        self._notional = notional
        self._payment_lag = payment_lag
        self._cal_type = cal_type
        self._bd_type = bd_type

        if payment_lag == 0:
            self._payment_dt = self._maturity_dt
        else:
            self._payment_dt = calendar.add_business_days(
                self._maturity_dt, payment_lag)

        self._base_cpi_ref_dt = effective_dt
        self._final_cpi_ref_dt = self._maturity_dt

    # ------------------------------------------------------------------

    def value(self, value_dt: Date, discount_curve,
              inflation_curve=None) -> float:
        """PV = N * (I(mat - lag)/I(eff - lag) - 1) * DF(payment)."""
        if inflation_curve is not None:
            self._inflation_index.set_inflation_curve(inflation_curve)

        self._base_index = self._inflation_index.get_index(
            self._base_cpi_ref_dt, apply_lag=True)
        self._final_index = self._inflation_index.get_index(
            self._final_cpi_ref_dt, apply_lag=True)
        if self._base_index <= 0.0:
            raise LibError(
                f"Base index must be positive, got {self._base_index}")

        self._inflation_return = self._final_index / self._base_index - 1.0
        self._payment_amount = self._notional * self._inflation_return

        if self._payment_dt > value_dt:
            df_value = discount_curve.df(value_dt, DayCountTypes.ACT_365F)
            df_payment = discount_curve.df(self._payment_dt,
                                           DayCountTypes.ACT_365F)
            self._payment_df = df_payment / df_value
            self._payment_pv = self._payment_amount * self._payment_df
            leg_pv = self._payment_pv
        else:
            self._payment_df = 0.0
            self._payment_pv = 0.0
            leg_pv = 0.0

        if self._leg_type == SwapTypes.PAY:
            leg_pv = -leg_pv
        return leg_pv

    # ------------------------------------------------------------------
    # reporting (reference swap_inflation_leg.py print_payments /
    # print_valuation — single-exchange leg, so one row each)

    def _require_valued(self):
        if not hasattr(self, "_payment_amount"):
            raise LibError("Leg has not been valued — call value() first")

    def print_payments(self):
        self._require_valued()
        header = ["PAY_NUM", "PAY_dt", "BASE_CPI", "FINAL_CPI", "RETURN",
                  "PMNT"]
        rows = [[1, str(self._payment_dt),
                 round(float(self._base_index), 5),
                 round(float(self._final_index), 5),
                 round(float(self._inflation_return), 8),
                 round(float(self._payment_amount), 2)]]
        print(format_table(header, rows))

    def print_valuation(self):
        self._require_valued()
        sign = -1.0 if self._leg_type == SwapTypes.PAY else 1.0
        pv = sign * float(self._payment_pv)
        header = ["PAY_NUM", "PAY_dt", "PMNT", "DF", "PV", "CUM_PV"]
        rows = [[1, str(self._payment_dt),
                 round(float(self._payment_amount), 2),
                 round(float(self._payment_df), 6),
                 round(pv, 2), round(pv, 2)]]
        print(format_table(header, rows))

    def __repr__(self):
        s = label_to_string("OBJECT TYPE", type(self).__name__)
        s += label_to_string("EFFECTIVE", self._effective_dt)
        s += label_to_string("MATURITY", self._maturity_dt)
        s += label_to_string("LEG TYPE", self._leg_type)
        s += label_to_string("NOTIONAL", self._notional)
        return s
