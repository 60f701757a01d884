"""Overnight index swap (OIS) product.

Behavioral parity with the reference's cavour/trades/rates/ois.py (leg
construction 128-190, value 209-273). The float leg defaults mirror the
reference (annual, THIRTY_E_360, zero spread).
"""

from __future__ import annotations

from enum import Enum
from typing import Union

from ...utils import ONE_MILLION
from ...utils.calendar import (BusDayAdjustTypes, Calendar, CalendarTypes,
                               DateGenRuleTypes)
from ...utils.currency import CurrencyTypes
from ...utils.date import Date
from ...utils.day_count import DayCountTypes
from ...utils.error import LibError
from ...utils.frequency import FrequencyTypes
from ...utils.global_types import (CollateralType, CurveTypes,
                                   InstrumentTypes, SwapTypes,
                                   collateral_to_currency)
from .swap_fixed_leg import SwapFixedLeg
from .swap_float_leg import SwapFloatLeg


class FinCompoundingTypes(Enum):
    COMPOUNDED = 1
    OVERNIGHT_COMPOUNDED_ANNUAL_RATE = 2
    AVERAGED = 3
    AVERAGED_DAILY = 4


class OIS:
    """Fixed-for-compounded-overnight swap."""

    def __init__(self,
                 effective_dt: Date,
                 term_dt_or_tenor: Union[Date, str],
                 fixed_leg_type: SwapTypes,
                 fixed_coupon: float,
                 fixed_freq_type: FrequencyTypes,
                 fixed_dc_type: DayCountTypes,
                 floating_index: CurveTypes,
                 currency: CurrencyTypes,
                 notional: float = ONE_MILLION,
                 payment_lag: int = 0,
                 float_spread: float = 0.0,
                 float_freq_type: FrequencyTypes = FrequencyTypes.ANNUAL,
                 float_dc_type: DayCountTypes = DayCountTypes.THIRTY_E_360,
                 cal_type: CalendarTypes = CalendarTypes.WEEKEND,
                 bd_type: BusDayAdjustTypes = BusDayAdjustTypes.FOLLOWING,
                 dg_type: DateGenRuleTypes = DateGenRuleTypes.BACKWARD):
        self.derivative_type = InstrumentTypes.OIS_SWAP

        if isinstance(term_dt_or_tenor, Date):
            self._termination_dt = term_dt_or_tenor
        else:
            self._termination_dt = effective_dt.add_tenor(term_dt_or_tenor)

        calendar = Calendar(cal_type)
        self._maturity_dt = calendar.adjust(self._termination_dt, bd_type)
        if effective_dt > self._maturity_dt:
            raise LibError("Start date after maturity date")
        self._effective_dt = effective_dt

        float_leg_type = SwapTypes.PAY \
            if fixed_leg_type == SwapTypes.RECEIVE else SwapTypes.RECEIVE
        if fixed_leg_type == SwapTypes.PAY:
            float_leg_type = SwapTypes.RECEIVE

        self._floating_index = floating_index
        self._currency = currency

        self._fixed_leg = SwapFixedLeg(
            effective_dt, self._termination_dt, fixed_leg_type, fixed_coupon,
            fixed_freq_type, fixed_dc_type, floating_index, currency,
            notional, 0.0, payment_lag, cal_type, bd_type, dg_type, False)

        self._float_leg = SwapFloatLeg(
            effective_dt, self._termination_dt, float_leg_type, float_spread,
            float_freq_type, float_dc_type, floating_index, currency,
            notional, 0.0, payment_lag, cal_type, bd_type, dg_type, False,
            False)

        self._adjusted_fixed_dts = self._fixed_leg._adjusted_fixed_dts
        self._fixed_coupon = self._fixed_leg._cpn
        self._fixed_year_fracs = self._fixed_leg._year_fracs
        self._start_dt = self._fixed_leg._effective_dt
        self._notional = notional

    # ------------------------------------------------------------------

    def value(self,
              value_dt: Date,
              ois_curve=None,
              discount_curve=None,
              xccy_discount_curve=None,
              spot_fx: float = None,
              collateral_type: CollateralType = None,
              first_fixing_rate: float = None) -> float:
        """PV: single-curve in the natural currency, or dual-curve under
        cross-currency collateral (project on OIS, discount on XCCY curve,
        convert by spot FX)."""
        if discount_curve is None and collateral_type is None:
            discount_curve = ois_curve

        if collateral_type is not None:
            collateral_ccy = collateral_to_currency(collateral_type)
            if collateral_ccy != self._currency:
                if xccy_discount_curve is None or spot_fx is None:
                    raise ValueError(
                        f"xccy_discount_curve and spot_fx required for "
                        f"{self._currency.name} swap with "
                        f"{collateral_ccy.name} collateral")
                fixed_pv = self._fixed_leg.value(value_dt,
                                                 xccy_discount_curve)
                float_pv = self._float_leg.value(value_dt,
                                                 xccy_discount_curve,
                                                 ois_curve,
                                                 first_fixing_rate)
                return (fixed_pv + float_pv) / spot_fx
            discount_curve = discount_curve or ois_curve

        fixed_pv = self._fixed_leg.value(value_dt, discount_curve)
        float_pv = self._float_leg.value(value_dt, discount_curve,
                                         ois_curve or discount_curve,
                                         first_fixing_rate)
        return fixed_pv + float_pv

    # ------------------------------------------------------------------

    def __repr__(self):
        return (f"OIS({self._effective_dt} -> {self._maturity_dt}, "
                f"{self._fixed_leg._leg_type.name} fixed "
                f"{self._fixed_coupon}, N={self._notional}, "
                f"{self._currency.name})")
