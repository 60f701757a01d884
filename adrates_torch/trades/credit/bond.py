"""Fixed-coupon / zero-coupon / amortizing bond.

Copy of ``adrates_tpu/trades/credit/bond.py`` (plain numpy and scipy):
``position(model, device)``, schedule, value with z-spread (keeping the
per-payment DFs and PVs the engine's cashflow report reads), accrued,
clean/dirty, YTM, z/g/i-spreads (the last two through the curves'
``zero_rate``), duration and convexity, dv01 and cs01, key-rate
durations from the engine's delta ladder, the amortization helpers and
the payment reports. Valuation is vectorized (one batched DF query per
call); root-finding (YTM, z-spread) uses Brent on the host.
"""

from __future__ import annotations

from typing import List, Optional, Union

import numpy as np
from scipy.optimize import brentq, newton

from ...utils.calendar import (BusDayAdjustTypes, Calendar, CalendarTypes,
                               DateGenRuleTypes)
from ...utils.currency import CurrencyTypes
from ...utils.date import Date
from ...utils.day_count import DayCount, DayCountTypes
from ...utils.error import LibError
from ...utils.frequency import FrequencyTypes, annual_frequency
from ...utils.global_types import InstrumentTypes
from ...utils.helpers import format_table
from ...utils.schedule import Schedule


class Bond:
    """Bond with fixed coupons (optionally amortizing) and final principal.

    Prices are quoted per 100 face value; dirty = PV, clean = dirty −
    accrued.
    """

    def __init__(self,
                 issue_dt: Date,
                 maturity_dt_or_tenor: Union[Date, str],
                 coupon: float,
                 freq_type: FrequencyTypes,
                 dc_type: DayCountTypes,
                 currency: CurrencyTypes,
                 face_value: float = 100.0,
                 payment_lag: int = 0,
                 amortization_schedule: Optional[list] = None,
                 cal_type: CalendarTypes = CalendarTypes.WEEKEND,
                 bd_type: BusDayAdjustTypes = BusDayAdjustTypes.FOLLOWING,
                 dg_type: DateGenRuleTypes = DateGenRuleTypes.BACKWARD,
                 end_of_month: bool = False):
        self.derivative_type = InstrumentTypes.BOND

        if isinstance(maturity_dt_or_tenor, Date):
            self._maturity_dt = maturity_dt_or_tenor
        else:
            self._maturity_dt = issue_dt.add_tenor(maturity_dt_or_tenor)
        if issue_dt >= self._maturity_dt:
            raise LibError("Issue date must be before maturity date")

        self._issue_dt = issue_dt
        self._coupon = coupon
        self._freq_type = freq_type
        self._dc_type = dc_type
        self._currency = currency
        self._face_value = face_value
        self._payment_lag = payment_lag
        self._cal_type = cal_type
        self._bd_type = bd_type
        self._dg_type = dg_type
        self._end_of_month = end_of_month
        self._amortization_schedule = amortization_schedule
        self._is_zero_coupon = (coupon == 0.0
                                or freq_type == FrequencyTypes.ZERO)

        self._generate_coupon_schedule()

    # ------------------------------------------------------------------

    def _generate_coupon_schedule(self):
        calendar = Calendar(self._cal_type)
        schedule = Schedule(self._issue_dt, self._maturity_dt,
                            self._freq_type, self._cal_type, self._bd_type,
                            self._dg_type,
                            end_of_month=self._end_of_month)
        schedule_dts = schedule._adjusted_dts
        num_periods = len(schedule_dts) - 1

        if self._amortization_schedule is not None:
            if len(self._amortization_schedule) != num_periods:
                raise LibError(
                    f"Amortization schedule length "
                    f"({len(self._amortization_schedule)}) must match "
                    f"number of payment periods ({num_periods})")
            self._principal_schedule = [self._face_value] + \
                list(self._amortization_schedule)
        else:
            self._principal_schedule = [self._face_value] * num_periods \
                + [0.0]

        day_count = DayCount(self._dc_type)
        self._accrual_start_dts = []
        self._accrual_end_dts = []
        self._payment_dts = []
        self._year_fracs = []
        self._coupon_payments = []
        self._principal_payments = []

        prev_dt = self._issue_dt
        for i, next_dt in enumerate(schedule_dts[1:]):
            payment_dt = calendar.add_business_days(next_dt,
                                                    self._payment_lag)
            year_frac = day_count.year_frac(prev_dt, next_dt)[0]
            outstanding = self._principal_schedule[i]
            self._accrual_start_dts.append(prev_dt)
            self._accrual_end_dts.append(next_dt)
            self._payment_dts.append(payment_dt)
            self._year_fracs.append(year_frac)
            self._coupon_payments.append(
                year_frac * self._coupon * outstanding)
            self._principal_payments.append(
                self._principal_schedule[i]
                - self._principal_schedule[i + 1])
            prev_dt = next_dt

        self._num_coupons = len(self._payment_dts)
        self._is_amortizing = self._amortization_schedule is not None

    # ------------------------------------------------------------------

    def position(self, model, device=None):
        """This trade against ``model``, computed on ``device`` (None: the
        CUDA card)."""
        from ...market.position.position import Position
        return Position(self, model, device)

    # ------------------------------------------------------------------

    def value(self, value_dt: Date, discount_curve,
              z_spread: float = 0.0, settlement_dt: Date = None) -> float:
        """PV of coupons + principal(s), with exp(-z*t) z-spread adjustment
        (times on ACT/365.25 as in the reference, bond.py:305-310)."""
        if settlement_dt is None:
            settlement_dt = value_dt

        df_settle = discount_curve.df(settlement_dt)
        n = len(self._payment_dts)
        future = np.array([dt > settlement_dt for dt in self._payment_dts])
        dfs = np.asarray(discount_curve.df(list(self._payment_dts)))
        if z_spread != 0.0:
            t = np.array([(dt - settlement_dt) / 365.25
                          for dt in self._payment_dts])
            dfs = dfs * np.exp(-z_spread * t)
        df_rel = dfs / df_settle

        # per-payment DFs and PVs are kept for the engine's cashflow report
        coupon_pvs = np.where(future,
                              np.array(self._coupon_payments) * df_rel, 0.0)
        self._payment_dfs = list(np.where(future, df_rel, 0.0))
        self._coupon_pvs = list(coupon_pvs)
        bond_pv = float(np.sum(coupon_pvs))

        if self._is_amortizing:
            prin_pvs = np.where(
                future & (np.array(self._principal_payments) > 0),
                np.array(self._principal_payments) * df_rel, 0.0)
            self._principal_pvs = list(prin_pvs)
            bond_pv += float(np.sum(prin_pvs))
        else:
            # Bullet principal paid on the final (adjusted) payment date.
            # The reference discounts it at the unadjusted maturity here but
            # at the adjusted date in the engine (bond.py:346-353 vs
            # engine.py:546-560); we use the adjusted payment date in both.
            self._principal_pvs = [0.0] * n
            final_dt = self._payment_dts[-1]
            if final_dt > settlement_dt:
                df_mat = discount_curve.df(final_dt)
                if z_spread != 0.0:
                    t_mat = (final_dt - settlement_dt) / 365.25
                    df_mat = df_mat * np.exp(-z_spread * t_mat)
                prin_pv = self._face_value * df_mat / df_settle
                self._principal_pvs[-1] = prin_pv
                bond_pv += prin_pv

        return bond_pv

    # ------------------------------------------------------------------

    def accrued_interest(self, settlement_dt: Date) -> float:
        """Accrual from the period start containing settlement."""
        if self._is_zero_coupon:
            return 0.0
        last_coupon_dt = self._issue_dt
        for i, payment_dt in enumerate(self._payment_dts):
            if payment_dt <= settlement_dt:
                last_coupon_dt = self._accrual_end_dts[i]
            else:
                last_coupon_dt = self._accrual_start_dts[i]
                break
        day_count = DayCount(self._dc_type)
        accrued_frac = day_count.year_frac(last_coupon_dt, settlement_dt)[0]
        return accrued_frac * self._coupon * self._face_value

    def dirty_price(self, value_dt: Date, discount_curve,
                    z_spread: float = 0.0,
                    settlement_dt: Date = None) -> float:
        if settlement_dt is None:
            settlement_dt = value_dt
        pv = self.value(value_dt, discount_curve, z_spread, settlement_dt)
        return pv / self._face_value * 100.0

    def clean_price(self, value_dt: Date, discount_curve,
                    z_spread: float = 0.0,
                    settlement_dt: Date = None) -> float:
        if settlement_dt is None:
            settlement_dt = value_dt
        dirty = self.dirty_price(value_dt, discount_curve, z_spread,
                                 settlement_dt)
        accrued_per_100 = self.accrued_interest(settlement_dt) \
            / self._face_value * 100.0
        return dirty - accrued_per_100

    # ------------------------------------------------------------------

    def _ytm_pv(self, settlement_dt: Date, ytm: float) -> float:
        """PV of future flows continuously compounded at ytm (ACT/365.25)."""
        pv = 0.0
        for i, payment_dt in enumerate(self._payment_dts):
            if payment_dt > settlement_dt:
                t = (payment_dt - settlement_dt) / 365.25
                pv += self._coupon_payments[i] * np.exp(-ytm * t)
                if self._is_amortizing:
                    pv += self._principal_payments[i] * np.exp(-ytm * t)
        if not self._is_amortizing and self._maturity_dt > settlement_dt:
            t = (self._maturity_dt - settlement_dt) / 365.25
            pv += self._face_value * np.exp(-ytm * t)
        return pv

    def yield_to_maturity(self, settlement_dt: Date,
                          clean_price: float) -> float:
        """Continuously compounded YTM matching the clean price (Brent,
        Newton fallback — reference bond.py:463-516)."""
        accrued_per_100 = self.accrued_interest(settlement_dt) \
            / self._face_value * 100.0
        target_pv = (clean_price + accrued_per_100) / 100.0 \
            * self._face_value

        def pv_difference(ytm):
            return self._ytm_pv(settlement_dt, ytm) - target_pv

        try:
            return brentq(pv_difference, -0.5, 0.5, maxiter=100)
        except Exception:
            return newton(pv_difference, 0.05, maxiter=100)

    def current_yield(self) -> float:
        if self._is_zero_coupon:
            return 0.0
        return self._coupon

    # ------------------------------------------------------------------

    def z_spread(self, settlement_dt: Date, discount_curve,
                 clean_price: float) -> float:
        """Parallel spread over the curve matching the clean price."""
        accrued_per_100 = self.accrued_interest(settlement_dt) \
            / self._face_value * 100.0
        target_pv = (clean_price + accrued_per_100) / 100.0 \
            * self._face_value

        def pv_difference(z):
            return self.value(settlement_dt, discount_curve, z,
                              settlement_dt) - target_pv

        try:
            return brentq(pv_difference, -0.1, 0.5, maxiter=100)
        except Exception:
            return newton(pv_difference, 0.01, maxiter=100)

    def g_spread(self, settlement_dt: Date, govt_curve,
                 clean_price: float) -> float:
        """YTM minus government-curve zero yield at maturity."""
        bond_ytm = self.yield_to_maturity(settlement_dt, clean_price)
        govt_yield = govt_curve.zero_rate(self._maturity_dt,
                                          freq_type=self._freq_type,
                                          dc_type=self._dc_type)
        return bond_ytm - float(govt_yield)

    def i_spread(self, settlement_dt: Date, discount_curve,
                 clean_price: float) -> float:
        """YTM minus swap-curve zero yield at maturity."""
        bond_ytm = self.yield_to_maturity(settlement_dt, clean_price)
        swap_yield = discount_curve.zero_rate(self._maturity_dt,
                                              freq_type=self._freq_type,
                                              dc_type=self._dc_type)
        return bond_ytm - float(swap_yield)

    # ------------------------------------------------------------------

    def duration(self, settlement_dt: Date, discount_curve,
                 duration_type: str = "modified",
                 z_spread: float = 0.0) -> float:
        """YTM-weighted Macaulay duration; modified == Macaulay under
        continuous compounding (reference bond.py:648-704)."""
        clean_px = self.clean_price(settlement_dt, discount_curve,
                                    z_spread, settlement_dt)
        ytm = self.yield_to_maturity(settlement_dt, clean_px)

        weighted_time = 0.0
        total_pv = 0.0
        for i, payment_dt in enumerate(self._payment_dts):
            if payment_dt > settlement_dt:
                t = (payment_dt - settlement_dt) / 365.25
                pv = self._coupon_payments[i] * np.exp(-ytm * t)
                if self._is_amortizing:
                    pv += self._principal_payments[i] * np.exp(-ytm * t)
                weighted_time += pv * t
                total_pv += pv
        if not self._is_amortizing and self._maturity_dt > settlement_dt:
            t = (self._maturity_dt - settlement_dt) / 365.25
            pv = self._face_value * np.exp(-ytm * t)
            weighted_time += pv * t
            total_pv += pv

        macaulay = weighted_time / total_pv
        if duration_type.lower() in ("macaulay", "modified"):
            return macaulay
        raise ValueError(f"Unknown duration type: {duration_type}")

    def convexity(self, settlement_dt: Date, discount_curve,
                  z_spread: float = 0.0) -> float:
        clean_px = self.clean_price(settlement_dt, discount_curve,
                                    z_spread, settlement_dt)
        ytm = self.yield_to_maturity(settlement_dt, clean_px)
        weighted_t2 = 0.0
        total_pv = 0.0
        for i, payment_dt in enumerate(self._payment_dts):
            if payment_dt > settlement_dt:
                t = (payment_dt - settlement_dt) / 365.25
                pv = self._coupon_payments[i] * np.exp(-ytm * t)
                if self._is_amortizing:
                    pv += self._principal_payments[i] * np.exp(-ytm * t)
                weighted_t2 += pv * t * t
                total_pv += pv
        if not self._is_amortizing and self._maturity_dt > settlement_dt:
            t = (self._maturity_dt - settlement_dt) / 365.25
            pv = self._face_value * np.exp(-ytm * t)
            weighted_t2 += pv * t * t
            total_pv += pv
        return weighted_t2 / total_pv

    def dv01(self, settlement_dt: Date, discount_curve,
             z_spread: float = 0.0) -> float:
        """Central 1bp z-spread bump (reference bond.py:752-783)."""
        bump = 0.0001
        pv_down = self.value(settlement_dt, discount_curve,
                             z_spread - bump, settlement_dt)
        pv_up = self.value(settlement_dt, discount_curve,
                           z_spread + bump, settlement_dt)
        return (pv_down - pv_up) / 2.0

    def cs01(self, settlement_dt: Date, discount_curve,
             z_spread: float = 0.0) -> float:
        """1bp credit-spread sensitivity — same bump as dv01 by the
        reference's definition (bond.py:834-874)."""
        return self.dv01(settlement_dt, discount_curve, z_spread)

    def key_rate_durations(self, model, device=None) -> dict:
        """Percentage price sensitivity to 100bp per tenor, from the AD
        delta ladder (reference bond.py:785-833), computed on ``device``
        (None: the CUDA card)."""
        from ...market.position.engine import Engine
        from ...utils.global_types import RequestTypes
        engine = Engine(model, device)
        result = engine.compute(self, [RequestTypes.VALUE,
                                       RequestTypes.DELTA])
        price = result.value.amount
        krds = {}
        for tenor, delta_val in zip(result.risk.tenors,
                                    result.risk.risk_ladder):
            krds[tenor] = (-float(delta_val) / price * 10000.0
                           if price != 0 else 0.0)
        return krds

    # ------------------------------------------------------------------

    @staticmethod
    def generate_equal_principal_schedule(face_value: float,
                                          num_periods: int) -> List[float]:
        """Outstanding principal after each period, equal repayments."""
        step = face_value / num_periods
        return [face_value - step * (i + 1) for i in range(num_periods)]

    @staticmethod
    def generate_annuity_schedule(face_value: float, num_periods: int,
                                  coupon_rate: float,
                                  freq_type: FrequencyTypes) -> List[float]:
        """Outstanding principal under level total payments (annuity)."""
        freq = annual_frequency(freq_type)
        r = coupon_rate / freq
        if r == 0:
            return Bond.generate_equal_principal_schedule(face_value,
                                                          num_periods)
        annuity = face_value * r / (1 - (1 + r) ** (-num_periods))
        outstanding = face_value
        schedule = []
        for _ in range(num_periods):
            interest = outstanding * r
            principal = annuity - interest
            outstanding -= principal
            schedule.append(max(outstanding, 0.0))
        schedule[-1] = 0.0
        return schedule

    # ------------------------------------------------------------------

    def print_valuation(self, value_dt: Date, discount_curve,
                        z_spread: float = 0.0, settlement_dt: Date = None):
        """Per-cashflow PV table + clean/dirty/accrued summary (reference
        bond.py:915-1026)."""
        self.value(value_dt, discount_curve, z_spread, settlement_dt)
        settle = settlement_dt or value_dt
        header = ["PAY_NUM", "PAY_dt", "COUPON", "PRINCIPAL", "DF", "PV",
                  "CUM_PV"]
        cum = 0.0
        rows = []
        for i in range(self._num_coupons):
            pv = float(self._coupon_pvs[i]) + float(self._principal_pvs[i])
            cum += pv
            rows.append([i + 1, str(self._payment_dts[i]),
                         round(self._coupon_payments[i], 2),
                         round(self._principal_payments[i], 2),
                         round(float(self._payment_dfs[i]), 6),
                         round(pv, 2), round(cum, 2)])
        print(format_table(header, rows))
        print(f"ACCRUED INTEREST: {self.accrued_interest(settle):,.4f}")
        print(f"DIRTY PRICE:      "
              f"{self.dirty_price(value_dt, discount_curve, z_spread, settlement_dt):,.6f}")
        print(f"CLEAN PRICE:      "
              f"{self.clean_price(value_dt, discount_curve, z_spread, settlement_dt):,.6f}")

    def print_payments(self):
        header = ["PAY_NUM", "PAY_dt", "ACCR_START", "ACCR_END", "YEARFRAC",
                  "COUPON", "PRINCIPAL"]
        rows = [[i + 1, str(self._payment_dts[i]),
                 str(self._accrual_start_dts[i]),
                 str(self._accrual_end_dts[i]),
                 round(self._year_fracs[i], 6),
                 round(self._coupon_payments[i], 2),
                 round(self._principal_payments[i], 2)]
                for i in range(self._num_coupons)]
        print(format_table(header, rows))

    def __repr__(self):
        return (f"Bond({self._issue_dt} -> {self._maturity_dt}, "
                f"cpn={self._coupon}, {self._freq_type.name}, "
                f"{self._dc_type.name}, face={self._face_value}, "
                f"{self._currency.name})")
