"""Cross-currency fixed-vs-float swap.

Copy of ``adrates_tpu/trades/rates/xccy_fix_float_swap.py`` (plain Python)
with ``position(model, device)``: domestic fixed leg
(notional exchanges added at valuation, the fixed-leg class has no
exchange flag) vs foreign floating leg (exchange built into the leg).
FX convention: PV = dom + spot_fx * for, spot_fx domestic per foreign.
"""

from __future__ import annotations

from typing import Union

from ...utils.calendar import (BusDayAdjustTypes, Calendar, CalendarTypes,
                               DateGenRuleTypes)
from ...utils.currency import CurrencyTypes
from ...utils.date import Date
from ...utils.day_count import DayCountTypes
from ...utils.error import LibError
from ...utils.frequency import FrequencyTypes
from ...utils.global_types import CurveTypes, InstrumentTypes, SwapTypes
from .swap_fixed_leg import SwapFixedLeg
from .swap_float_leg import SwapFloatLeg


class XccyFixFloat:
    """Domestic fixed leg vs foreign floating leg, notionals exchanged."""

    def __init__(self,
                 effective_dt: Date,
                 term_dt_or_tenor: Union[Date, str],
                 domestic_notional: float,
                 foreign_notional: float,
                 domestic_leg_type: SwapTypes,
                 domestic_coupon: float,
                 foreign_spread: float,
                 domestic_freq_type: FrequencyTypes,
                 foreign_freq_type: FrequencyTypes,
                 domestic_dc_type: DayCountTypes,
                 foreign_dc_type: DayCountTypes,
                 domestic_floating_index: CurveTypes,
                 foreign_floating_index: CurveTypes,
                 domestic_currency: CurrencyTypes,
                 foreign_currency: CurrencyTypes,
                 domestic_payment_lag: int = 0,
                 foreign_payment_lag: int = 0,
                 domestic_cal_type: CalendarTypes = CalendarTypes.WEEKEND,
                 foreign_cal_type: CalendarTypes = CalendarTypes.WEEKEND,
                 domestic_bd_type: BusDayAdjustTypes =
                 BusDayAdjustTypes.FOLLOWING,
                 foreign_bd_type: BusDayAdjustTypes =
                 BusDayAdjustTypes.FOLLOWING,
                 domestic_dg_type: DateGenRuleTypes =
                 DateGenRuleTypes.BACKWARD,
                 foreign_dg_type: DateGenRuleTypes =
                 DateGenRuleTypes.BACKWARD,
                 domestic_end_of_month: bool = False,
                 foreign_end_of_month: bool = False):
        self.derivative_type = InstrumentTypes.XCCY_SWAP

        if isinstance(term_dt_or_tenor, Date):
            self._termination_dt = term_dt_or_tenor
        else:
            self._termination_dt = effective_dt.add_tenor(term_dt_or_tenor)

        calendar = Calendar(domestic_cal_type)
        self._maturity_dt = calendar.adjust(self._termination_dt,
                                            domestic_bd_type)
        if effective_dt > self._maturity_dt:
            raise LibError("Start date after maturity date")

        self._effective_dt = effective_dt
        self._domestic_notional = domestic_notional
        self._foreign_notional = foreign_notional
        self._domestic_currency = domestic_currency
        self._foreign_currency = foreign_currency
        self._domestic_floating_index = domestic_floating_index
        self._foreign_floating_index = foreign_floating_index
        self._domestic_leg_type = domestic_leg_type
        self._domestic_coupon = domestic_coupon
        self._foreign_spread = foreign_spread

        # Foreign leg direction opposes the domestic leg.
        foreign_leg_type = SwapTypes.PAY \
            if domestic_leg_type == SwapTypes.RECEIVE else SwapTypes.RECEIVE

        self._domestic_leg = SwapFixedLeg(
            effective_dt, self._termination_dt, domestic_leg_type,
            domestic_coupon, domestic_freq_type, domestic_dc_type,
            domestic_floating_index, domestic_currency, domestic_notional,
            0.0, domestic_payment_lag, domestic_cal_type, domestic_bd_type,
            domestic_dg_type, domestic_end_of_month)

        self._foreign_leg = SwapFloatLeg(
            effective_dt, self._termination_dt, foreign_leg_type,
            foreign_spread, foreign_freq_type, foreign_dc_type,
            foreign_floating_index, foreign_currency, foreign_notional,
            0.0, foreign_payment_lag, foreign_cal_type, foreign_bd_type,
            foreign_dg_type, foreign_end_of_month, True)

    # ------------------------------------------------------------------

    def _domestic_exchange_pv(self, value_dt: Date,
                              discount_curve) -> float:
        """Manual notional exchanges on the fixed leg (the fixed-leg class
        has no exchange flag — parity: xccy_fix_float_swap.py:232-270)."""
        pv = 0.0
        if self._effective_dt >= value_dt:
            pv += -self._domestic_notional \
                * discount_curve.df(self._effective_dt)
        if self._maturity_dt >= value_dt:
            pv += self._domestic_notional \
                * discount_curve.df(self._maturity_dt)
        if self._domestic_leg_type == SwapTypes.PAY:
            pv = -pv
        return pv

    def position(self, model, device=None):
        """This trade against ``model``, computed on ``device`` (None: the
        CUDA card)."""
        from ...market.position.position import Position
        return Position(self, model, device)

    # ------------------------------------------------------------------

    def value(self,
              value_dt: Date,
              domestic_discount_curve,
              foreign_discount_curve,
              xccy_discount_curve,
              spot_fx: float,
              first_fixing_rate_foreign: float = None) -> float:
        """PV in domestic currency: fixed leg + exchanges on the domestic
        curve, foreign float leg discounted on the XCCY curve x spot FX."""
        dom_pv = self._domestic_leg.value(value_dt, domestic_discount_curve)
        dom_pv += self._domestic_exchange_pv(value_dt,
                                             domestic_discount_curve)
        for_pv = self._foreign_leg.value(value_dt, xccy_discount_curve,
                                         foreign_discount_curve,
                                         first_fixing_rate_foreign)
        return dom_pv + spot_fx * for_pv

    def print_payments(self):
        """Both legs' payment schedules (reference
        xccy_fix_float_swap.py print_payments)."""
        print("DOMESTIC FIXED LEG:")
        self._domestic_leg.print_payments()
        print("FOREIGN FLOAT LEG:")
        self._foreign_leg.print_payments()

    def print_valuation(self):
        """Both legs' PV tables — requires a prior value()."""
        print("DOMESTIC FIXED LEG:")
        self._domestic_leg.print_valuation()
        print("FOREIGN FLOAT LEG:")
        self._foreign_leg.print_valuation()

    def __repr__(self):
        return (f"XccyFixFloat({self._effective_dt} -> {self._maturity_dt},"
                f" {self._domestic_leg_type.name} fixed "
                f"{self._domestic_coupon} {self._domestic_currency.name} vs"
                f" float {self._foreign_currency.name})")
