"""Cross-currency basis swap (float vs float, both notional-exchanged).

Port of ``adrates_tpu/trades/rates/xccy_basis_swap.py`` (construction:
domestic RECEIVE / foreign PAY, both legs with notional exchange; host
``value()`` incl. foreign collateral via an inverted curve;
``position(model, device)``; ``print_payments`` / ``print_valuation``),
plus the foreign leg's compiled tensor the book compiler reads
(``adrates_tpu/market/position/engine_xccy.py:_float_leg_xccy_tensor``).
FX convention: spot_fx = domestic per foreign, PV_total = PV_dom +
spot_fx * PV_for.
"""

from __future__ import annotations

from typing import Union

import numpy as np

from ...ops.pricers import FloatLegTensor
from ...utils.calendar import (BusDayAdjustTypes, Calendar, CalendarTypes,
                               DateGenRuleTypes)
from ...utils.currency import CurrencyTypes
from ...utils.date import Date
from ...utils.day_count import DayCount, DayCountTypes
from ...utils.error import LibError
from ...utils.frequency import FrequencyTypes
from ...utils.global_types import (CollateralType, CurveTypes,
                                   InstrumentTypes, SwapTypes,
                                   collateral_to_currency)
from ...utils.helpers import times_from_dates
from .swap_float_leg import SwapFloatLeg


class XccyBasisSwap:
    """Receive domestic float, pay foreign float + basis spread; notionals
    exchanged at start and maturity on both legs."""

    def __init__(self,
                 effective_dt: Date,
                 term_dt_or_tenor: Union[Date, str],
                 domestic_notional: float,
                 foreign_notional: float,
                 domestic_spread: float,
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
        self._domestic_spread = domestic_spread
        self._foreign_spread = foreign_spread

        self._domestic_leg = SwapFloatLeg(
            effective_dt, self._termination_dt, SwapTypes.RECEIVE,
            domestic_spread, domestic_freq_type, domestic_dc_type,
            domestic_floating_index, domestic_currency, domestic_notional,
            0.0, domestic_payment_lag, domestic_cal_type, domestic_bd_type,
            domestic_dg_type, domestic_end_of_month, True)

        self._foreign_leg = SwapFloatLeg(
            effective_dt, self._termination_dt, SwapTypes.PAY,
            foreign_spread, foreign_freq_type, foreign_dc_type,
            foreign_floating_index, foreign_currency, foreign_notional,
            0.0, foreign_payment_lag, foreign_cal_type, foreign_bd_type,
            foreign_dg_type, foreign_end_of_month, True)

        self._adjusted_domestic_dts = self._domestic_leg._payment_dts
        self._adjusted_foreign_dts = self._foreign_leg._payment_dts

    # ------------------------------------------------------------------

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
              xccy_discount_curve=None,
              xccy_discount_curve_inverted=None,
              spot_fx: float = None,
              collateral_type: CollateralType = None,
              first_fixing_rate_domestic: float = None,
              first_fixing_rate_foreign: float = None) -> float:
        """PV in the collateral currency.

        Domestic collateral (default): domestic leg on domestic OIS,
        foreign leg discounted on the XCCY curve; PV = dom + fx * for with
        fx = domestic per foreign. Foreign collateral: mirrored using the
        inverted XCCY curve.
        """
        if collateral_type is None:
            collateral_ccy = self._domestic_currency
        else:
            collateral_ccy = collateral_to_currency(collateral_type)

        if collateral_ccy == self._domestic_currency:
            if xccy_discount_curve is None:
                raise ValueError(
                    f"xccy_discount_curve required for domestic collateral "
                    f"({self._domestic_currency.name})")
            dom_disc = domestic_discount_curve
            for_disc = xccy_discount_curve
        elif collateral_ccy == self._foreign_currency:
            if xccy_discount_curve_inverted is None:
                raise ValueError(
                    f"xccy_discount_curve_inverted required for foreign "
                    f"collateral ({self._foreign_currency.name})")
            dom_disc = xccy_discount_curve_inverted
            for_disc = foreign_discount_curve
        else:
            raise ValueError(
                f"Third-party collateral not supported: {collateral_type}")

        dom_pv = self._domestic_leg.value(value_dt, dom_disc,
                                          domestic_discount_curve,
                                          first_fixing_rate_domestic)
        for_pv = self._foreign_leg.value(value_dt, for_disc,
                                         foreign_discount_curve,
                                         first_fixing_rate_foreign)

        if spot_fx is None:
            raise ValueError("spot_fx required (domestic per foreign)")

        if collateral_ccy == self._domestic_currency:
            return dom_pv + spot_fx * for_pv
        return dom_pv / spot_fx + for_pv

    # ------------------------------------------------------------------

    def print_payments(self):
        print("DOMESTIC LEG:")
        self._domestic_leg.print_payments()
        print("FOREIGN LEG:")
        self._foreign_leg.print_payments()

    def print_valuation(self):
        print("DOMESTIC LEG:")
        self._domestic_leg.print_valuation()
        print("FOREIGN LEG:")
        self._foreign_leg.print_valuation()

    def __repr__(self):
        return (f"XccyBasisSwap({self._effective_dt} -> "
                f"{self._maturity_dt}, {self._domestic_currency.name} "
                f"{self._domestic_notional} vs "
                f"{self._foreign_currency.name} {self._foreign_notional}, "
                f"basis={self._foreign_spread * 1e4:.2f}bp)")


def float_leg_xccy_tensor(leg: SwapFloatLeg, value_dt: Date,
                          foreign_dc: DayCountTypes) -> FloatLegTensor:
    """Foreign float leg: payment/exchange times in XCCY curve units
    (ACT/365F), forward DF queries at LEG-basis times with the divisor in
    the foreign curve's basis — exactly what value() asks the curves
    for."""
    xccy_dc = DayCountTypes.ACT_365F
    n = len(leg._payment_dts)
    return FloatLegTensor(
        payment_times=np.asarray(
            times_from_dates(leg._payment_dts, value_dt, xccy_dc)),
        start_times=np.asarray(
            times_from_dates(leg._start_accrued_dts, value_dt,
                             leg._dc_type)),
        end_times=np.asarray(
            times_from_dates(leg._end_accrued_dts, value_dt,
                             leg._dc_type)),
        pay_alphas=np.array(leg._year_fracs, dtype=np.float64),
        index_alphas=np.array(
            [DayCount(foreign_dc).year_frac(s, e)[0]
             for s, e in zip(leg._start_accrued_dts, leg._end_accrued_dts)],
            dtype=np.float64),
        spreads=np.full(n, leg._spread),
        notionals=leg._notionals(),
        principal=np.float64(leg._principal * leg._notional),
        leg_sign=np.float64(
            1.0 if leg._leg_type == SwapTypes.RECEIVE else -1.0),
        value_time=np.float64(0.0),
        first_fixing_rate=np.float64(0.0),
        notional_exchange_amount=np.float64(
            float(leg._notional) if leg._notional_exchange else 0.0),
        effective_time=np.float64(
            times_from_dates(leg._effective_dt, value_dt, xccy_dc)),
        maturity_time=np.float64(
            times_from_dates(leg._maturity_dt, value_dt, xccy_dc)),
        cap_rate=np.float64(np.inf),
        floor_rate=np.float64(-np.inf),
        override_first=False,
        notional_exchange=leg._notional_exchange,
        has_cap_floor=False)
