"""Zero-coupon inflation swap (ZCIS).

Copy of ``adrates_tpu/trades/rates/zcis.py`` (plain Python) with
``position(model, device)``: fixed leg pays N*[(1+r)^T - 1],
inflation leg pays N*[I(T-lag)/I(0-lag)-1], single exchange at maturity;
``breakeven_inflation_rate``, ``pv01``.
"""

from __future__ import annotations

from typing import Union

from ...market.indices.inflation_index import InflationIndex
from ...utils import ONE_MILLION
from ...utils.calendar import BusDayAdjustTypes, Calendar, CalendarTypes
from ...utils.date import Date
from ...utils.day_count import DayCount, DayCountTypes
from ...utils.error import LibError
from ...utils.global_types import InstrumentTypes, SwapTypes
from .swap_inflation_leg import SwapInflationLeg


class ZeroCouponInflationSwap:
    """Fixed compounded return vs realized inflation at one maturity."""

    def __init__(self,
                 effective_dt: Date,
                 term_dt_or_tenor: Union[Date, str],
                 fixed_leg_type: SwapTypes,
                 fixed_rate: float,
                 inflation_index: InflationIndex,
                 notional: float = ONE_MILLION,
                 payment_lag: int = 0,
                 dc_type: DayCountTypes = DayCountTypes.ACT_365F,
                 cal_type: CalendarTypes = CalendarTypes.WEEKEND,
                 bd_type: BusDayAdjustTypes = BusDayAdjustTypes.FOLLOWING):
        self.instrument_type = InstrumentTypes.ZCIS
        self.derivative_type = InstrumentTypes.ZCIS

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
        self._notional = notional
        self._payment_lag = payment_lag
        self._dc_type = dc_type
        self._cal_type = cal_type
        self._bd_type = bd_type

        if payment_lag == 0:
            self._payment_dt = self._maturity_dt
        else:
            self._payment_dt = calendar.add_business_days(
                self._maturity_dt, payment_lag)

        inflation_leg_type = SwapTypes.RECEIVE \
            if fixed_leg_type == SwapTypes.PAY else SwapTypes.PAY
        self._inflation_leg = SwapInflationLeg(
            effective_dt=effective_dt, end_dt=self._termination_dt,
            leg_type=inflation_leg_type, inflation_index=inflation_index,
            notional=notional, payment_lag=payment_lag, cal_type=cal_type,
            bd_type=bd_type)

    # ------------------------------------------------------------------

    def year_frac(self) -> float:
        return DayCount(self._dc_type).year_frac(self._effective_dt,
                                                 self._maturity_dt)[0]

    # ------------------------------------------------------------------

    def position(self, model, device=None):
        """This trade against ``model``, computed on ``device`` (None: the
        CUDA card)."""
        from ...market.position.position import Position
        return Position(self, model, device)

    # ------------------------------------------------------------------

    def value(self, value_dt: Date, discount_curve,
              inflation_curve=None) -> float:
        """Net PV of the fixed and inflation single exchanges."""
        year_frac = self.year_frac()
        self._fixed_return = (1.0 + self._fixed_rate) ** year_frac - 1.0
        self._fixed_payment = self._notional * self._fixed_return

        if self._payment_dt > value_dt:
            df_value = discount_curve.df(value_dt, DayCountTypes.ACT_365F)
            df_payment = discount_curve.df(self._payment_dt,
                                           DayCountTypes.ACT_365F)
            self._payment_df = df_payment / df_value
            self._fixed_pv = self._fixed_payment * self._payment_df
        else:
            self._payment_df = 0.0
            self._fixed_pv = 0.0

        if self._fixed_leg_type == SwapTypes.PAY:
            self._fixed_pv *= -1.0

        self._inflation_pv = self._inflation_leg.value(
            value_dt, discount_curve, inflation_curve)
        return self._fixed_pv + self._inflation_pv

    # ------------------------------------------------------------------

    def breakeven_inflation_rate(self, value_dt: Date, discount_curve,
                                 inflation_curve=None) -> float:
        """Constant annual inflation rate making the swap worth zero:
        implied from the projected index ratio."""
        if inflation_curve is not None:
            self._inflation_index.set_inflation_curve(inflation_curve)
        ratio = self._inflation_index.inflation_ratio(
            self._effective_dt, self._maturity_dt, apply_lag=True)
        year_frac = self.year_frac()
        if year_frac <= 0:
            raise LibError("Year fraction must be positive")
        return ratio ** (1.0 / year_frac) - 1.0

    def pv01(self, value_dt: Date, discount_curve) -> float:
        """dPV/d(fixed rate) x 1bp magnitude (zcis.py:284-319)."""
        year_frac = self.year_frac()
        if self._payment_dt > value_dt:
            df = discount_curve.df(self._payment_dt,
                                   DayCountTypes.ACT_365F) \
                / discount_curve.df(value_dt, DayCountTypes.ACT_365F)
        else:
            df = 0.0
        dpv_dr = self._notional * year_frac \
            * (1.0 + self._fixed_rate) ** (year_frac - 1.0) * df
        return abs(dpv_dr) * 1e-4

    # ------------------------------------------------------------------
    # reporting (reference zcis.py:321-438)

    def print_payments(self):
        """Both single exchanges: the fixed compounded payment and the
        inflation leg's payment (requires a prior value())."""
        if not hasattr(self, "_fixed_payment"):
            raise LibError("Swap has not been valued — call value() first")
        print("FIXED LEG:")
        from ...utils.helpers import format_table
        print(format_table(
            ["PAY_NUM", "PAY_dt", "RATE", "PMNT"],
            [[1, str(self._payment_dt), self._fixed_rate,
              round(float(self._fixed_payment), 2)]]))
        print("INFLATION LEG:")
        self._inflation_leg.print_payments()

    def print_valuation(self):
        """PV breakdown by leg (reference zcis.py:358-438)."""
        if not hasattr(self, "_fixed_pv"):
            raise LibError("Swap has not been valued — call value() first")
        print("=" * 70)
        print("ZERO-COUPON INFLATION SWAP VALUATION")
        print("=" * 70)
        print(f"START DATE:    {self._effective_dt}")
        print(f"MATURITY DATE: {self._maturity_dt}")
        print(f"PAYMENT DATE:  {self._payment_dt}")
        print(f"NOTIONAL:      {self._notional:,.2f}")
        print(f"FIXED RATE:    {self._fixed_rate:.6f} "
              f"({self._fixed_leg_type.name})")
        print(f"FIXED PV:      {float(self._fixed_pv):,.2f}")
        print(f"INFLATION PV:  {float(self._inflation_pv):,.2f}")
        print(f"SWAP PV:       "
              f"{float(self._fixed_pv) + float(self._inflation_pv):,.2f}")

    def __repr__(self):
        return (f"ZCIS({self._effective_dt} -> {self._maturity_dt}, "
                f"{self._fixed_leg_type.name} fixed {self._fixed_rate}, "
                f"N={self._notional})")
