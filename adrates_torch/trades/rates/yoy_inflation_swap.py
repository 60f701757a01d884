"""Year-on-year inflation swap.

Copy of ``adrates_tpu/trades/rates/yoy_inflation_swap.py`` (plain Python)
with ``position(model, device)``: periodic fixed leg
(``SwapFixedLeg``) vs YoY inflation leg; ``value``, ``breakeven_rate``,
``pv01``.
"""

from __future__ import annotations

from typing import Union

from ...market.indices.inflation_index import InflationIndex
from ...utils import ONE_MILLION
from ...utils.calendar import (BusDayAdjustTypes, Calendar, CalendarTypes,
                               DateGenRuleTypes)
from ...utils.date import Date
from ...utils.day_count import DayCountTypes
from ...utils.error import LibError
from ...utils.frequency import FrequencyTypes
from ...utils.global_types import CurveTypes, InstrumentTypes, SwapTypes
from .swap_fixed_leg import SwapFixedLeg
from .swap_yoy_inflation_leg import SwapYoYInflationLeg


class YoYInflationSwap:
    """Periodic fixed rate vs periodic year-on-year inflation."""

    def __init__(self,
                 effective_dt: Date,
                 term_dt_or_tenor: Union[Date, str],
                 fixed_leg_type: SwapTypes,
                 fixed_rate: float,
                 inflation_index: InflationIndex,
                 freq_type: FrequencyTypes,
                 notional: float = ONE_MILLION,
                 inflation_spread: float = 0.0,
                 dc_type: DayCountTypes = DayCountTypes.ACT_365F,
                 payment_lag: int = 0,
                 cal_type: CalendarTypes = CalendarTypes.WEEKEND,
                 bd_type: BusDayAdjustTypes = BusDayAdjustTypes.FOLLOWING,
                 dg_type: DateGenRuleTypes = DateGenRuleTypes.BACKWARD,
                 end_of_month: bool = False):
        self.instrument_type = InstrumentTypes.YOY_INFLATION_SWAP
        self.derivative_type = InstrumentTypes.YOY_INFLATION_SWAP

        if isinstance(term_dt_or_tenor, Date):
            self._termination_dt = term_dt_or_tenor
        else:
            self._termination_dt = effective_dt.add_tenor(term_dt_or_tenor)

        calendar = Calendar(cal_type)
        self._maturity_dt = calendar.adjust(self._termination_dt, bd_type)
        if effective_dt > self._maturity_dt:
            raise LibError("Start date after maturity date")

        self._effective_dt = effective_dt
        self._fixed_leg_type = fixed_leg_type
        self._fixed_rate = fixed_rate
        self._inflation_index = inflation_index
        self._freq_type = freq_type
        self._notional = notional
        self._inflation_spread = inflation_spread
        self._dc_type = dc_type
        self._currency = inflation_index._currency

        inflation_leg_type = SwapTypes.RECEIVE \
            if fixed_leg_type == SwapTypes.PAY else SwapTypes.PAY

        self._fixed_leg = SwapFixedLeg(
            effective_dt, self._termination_dt, fixed_leg_type, fixed_rate,
            freq_type, dc_type, CurveTypes.GBP_OIS_SONIA,
            inflation_index._currency, notional, 0.0, payment_lag,
            cal_type, bd_type, dg_type, end_of_month)

        self._inflation_leg = SwapYoYInflationLeg(
            effective_dt, self._termination_dt, inflation_leg_type,
            inflation_index, freq_type, notional, inflation_spread,
            dc_type, payment_lag, cal_type, bd_type, dg_type, end_of_month)

    # ------------------------------------------------------------------

    def position(self, model, device=None):
        """This trade against ``model``, computed on ``device`` (None: the
        CUDA card)."""
        from ...market.position.position import Position
        return Position(self, model, device)

    # ------------------------------------------------------------------

    def value(self, value_dt: Date, discount_curve,
              inflation_curve=None) -> float:
        self._fixed_pv = self._fixed_leg.value(value_dt, discount_curve)
        self._inflation_pv = self._inflation_leg.value(
            value_dt, discount_curve, inflation_curve)
        return self._fixed_pv + self._inflation_pv

    # ------------------------------------------------------------------

    def _annuity(self, value_dt: Date, discount_curve) -> float:
        annuity = 0.0
        df_value = discount_curve.df(value_dt, DayCountTypes.ACT_365F)
        for i, payment_dt in enumerate(self._fixed_leg._payment_dts):
            if payment_dt <= value_dt:
                continue
            df = discount_curve.df(payment_dt,
                                   DayCountTypes.ACT_365F) / df_value
            annuity += self._fixed_leg._year_fracs[i] * df
        return annuity

    def breakeven_rate(self, value_dt: Date, discount_curve,
                       inflation_curve=None) -> float:
        """Fixed rate making the swap worth zero."""
        inflation_pv = self._inflation_leg.value(value_dt, discount_curve,
                                                 inflation_curve)
        annuity = self._annuity(value_dt, discount_curve)
        if annuity <= 0:
            raise LibError(
                "Annuity must be positive for breakeven calculation")
        if self._fixed_leg_type == SwapTypes.PAY:
            return inflation_pv / (self._notional * annuity)
        return -inflation_pv / (self._notional * annuity)

    def pv01(self, value_dt: Date, discount_curve) -> float:
        """Value of 1bp of fixed rate."""
        return abs(self._notional * self._annuity(value_dt, discount_curve)
                   * 1e-4)

    def print_payments(self):
        """Both legs' payment schedules (reference yoy_inflation_swap.py
        print_payments)."""
        print("FIXED LEG:")
        self._fixed_leg.print_payments()
        print("INFLATION LEG:")
        self._inflation_leg.print_payments()

    def print_valuation(self):
        """Both legs' per-payment PV tables — requires a prior value()."""
        print("FIXED LEG:")
        self._fixed_leg.print_valuation()
        print("INFLATION LEG:")
        self._inflation_leg.print_valuation()

    def __repr__(self):
        return (f"YoYInflationSwap({self._effective_dt} -> "
                f"{self._maturity_dt}, {self._fixed_leg_type.name} fixed "
                f"{self._fixed_rate}, {self._freq_type.name}, "
                f"N={self._notional})")
