"""Floating Rate Note (FRN).

Copy of ``adrates_tpu/trades/credit/frn.py`` (plain numpy and scipy):
``position(model, device)``, schedule, value with the cap/floor clamp and
the discount-margin exp adjustment (keeping the per-coupon rates,
amounts, DFs and PVs the engine's cashflow report reads), accrued
interest (per-100 units, as the reference package), clean/dirty prices,
discount_margin by Brent, the discount-margin bump analytics (modified
duration, dv01) and the payment reports. A curve is used only through
``df`` and ``_dc_type``.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
from scipy.optimize import brentq, newton

from ...utils.calendar import (BusDayAdjustTypes, Calendar, CalendarTypes,
                               DateGenRuleTypes)
from ...utils.currency import CurrencyTypes
from ...utils.date import Date
from ...utils.day_count import DayCount, DayCountTypes
from ...utils.error import LibError
from ...utils.frequency import FrequencyTypes
from ...utils.global_types import CurveTypes, InstrumentTypes
from ...utils.helpers import format_table
from ...utils.schedule import Schedule


class FRN:
    """Floating-rate note: index + quoted margin coupons with optional
    cap/floor, principal at maturity."""

    def __init__(self,
                 issue_dt: Date,
                 maturity_dt_or_tenor: Union[Date, str],
                 quoted_margin: float,
                 freq_type: FrequencyTypes,
                 dc_type: DayCountTypes,
                 currency: CurrencyTypes,
                 floating_index: CurveTypes,
                 face_value: float = 100.0,
                 payment_lag: int = 0,
                 cap_rate: Optional[float] = None,
                 floor_rate: Optional[float] = None,
                 first_fixing_rate: Optional[float] = None,
                 cal_type: CalendarTypes = CalendarTypes.WEEKEND,
                 bd_type: BusDayAdjustTypes = BusDayAdjustTypes.FOLLOWING,
                 dg_type: DateGenRuleTypes = DateGenRuleTypes.BACKWARD,
                 end_of_month: bool = False):
        self.derivative_type = InstrumentTypes.FRN

        if isinstance(maturity_dt_or_tenor, Date):
            self._maturity_dt = maturity_dt_or_tenor
        else:
            self._maturity_dt = issue_dt.add_tenor(maturity_dt_or_tenor)
        if issue_dt >= self._maturity_dt:
            raise LibError("Issue date must be before maturity date")
        if cap_rate is not None and floor_rate is not None \
                and cap_rate < floor_rate:
            raise LibError("Cap rate must be above floor rate")

        self._issue_dt = issue_dt
        self._quoted_margin = quoted_margin
        self._freq_type = freq_type
        self._dc_type = dc_type
        self._currency = currency
        self._floating_index = floating_index
        self._face_value = face_value
        self._payment_lag = payment_lag
        self._cap_rate = cap_rate
        self._floor_rate = floor_rate
        self._first_fixing_rate = first_fixing_rate
        self._cal_type = cal_type
        self._bd_type = bd_type
        self._dg_type = dg_type
        self._end_of_month = end_of_month

        self._generate_payment_schedule()

    # ------------------------------------------------------------------

    def _generate_payment_schedule(self):
        calendar = Calendar(self._cal_type)
        schedule = Schedule(self._issue_dt, self._maturity_dt,
                            self._freq_type, self._cal_type, self._bd_type,
                            self._dg_type,
                            end_of_month=self._end_of_month)
        schedule_dts = schedule._adjusted_dts

        day_count = DayCount(self._dc_type)
        self._start_accrued_dts = []
        self._end_accrued_dts = []
        self._payment_dts = []
        self._year_fracs = []

        prev_dt = self._issue_dt
        for next_dt in schedule_dts[1:]:
            payment_dt = calendar.add_business_days(next_dt,
                                                    self._payment_lag)
            self._start_accrued_dts.append(prev_dt)
            self._end_accrued_dts.append(next_dt)
            self._payment_dts.append(payment_dt)
            self._year_fracs.append(
                day_count.year_frac(prev_dt, next_dt)[0])
            prev_dt = next_dt
        self._num_coupons = len(self._payment_dts)

    # ------------------------------------------------------------------

    def _clamp(self, rate):
        if self._cap_rate is not None:
            rate = np.minimum(rate, self._cap_rate)
        if self._floor_rate is not None:
            rate = np.maximum(rate, self._floor_rate)
        return rate

    def position(self, model, device=None):
        """This trade against ``model``, computed on ``device`` (None: the
        CUDA card)."""
        from ...market.position.position import Position
        return Position(self, model, device)

    # ------------------------------------------------------------------

    def value(self, value_dt: Date, discount_curve, index_curve=None,
              discount_margin: float = 0.0,
              settlement_dt: Date = None) -> float:
        """PV: projected forwards + margin (cap/floor clamped), discounted
        with optional exp(-dm*t) margin adjustment; principal at maturity."""
        if discount_curve is None:
            raise LibError("Discount curve is required")
        if index_curve is None:
            index_curve = discount_curve
        if settlement_dt is None:
            settlement_dt = value_dt

        dc = self._dc_type
        df_settle = discount_curve.df(settlement_dt, dc)
        day_counter = DayCount(dc)
        index_dc = DayCount(index_curve._dc_type)

        future = np.array([dt > settlement_dt for dt in self._payment_dts])
        df_start = np.asarray(index_curve.df(
            list(self._start_accrued_dts), dc))
        df_end = np.asarray(index_curve.df(
            list(self._end_accrued_dts), dc))
        idx_alphas = np.array([
            index_dc.year_frac(s, e)[0]
            for s, e in zip(self._start_accrued_dts, self._end_accrued_dts)])
        with np.errstate(divide="ignore", invalid="ignore"):
            fwd = np.where(idx_alphas > 0,
                           (df_start / df_end - 1.0) / idx_alphas, 0.0)

        if self._first_fixing_rate is not None:
            fut_idx = np.nonzero(future)[0]
            if fut_idx.size:
                fwd[fut_idx[0]] = self._first_fixing_rate

        rates = self._clamp(fwd + self._quoted_margin)
        coupons = rates * np.array(self._year_fracs) * self._face_value

        df_pmts = np.asarray(discount_curve.df(
            list(self._payment_dts), dc)) / df_settle
        if discount_margin != 0.0:
            disc_t = np.array([day_counter.year_frac(settlement_dt, d)[0]
                               for d in self._payment_dts])
            df_pmts = df_pmts * np.exp(-discount_margin * disc_t)

        pvs = np.where(future, coupons * df_pmts, 0.0)
        pv = float(np.sum(pvs))

        # per-coupon rates, amounts, DFs and PVs for the engine's cashflow
        # report
        self._rates = list(np.where(future, rates, 0.0))
        self._coupon_payments = list(np.where(future, coupons, 0.0))
        self._payment_dfs = list(np.where(future, df_pmts, 0.0))
        self._payment_pvs = list(pvs)

        if self._maturity_dt > settlement_dt:
            df_mat = discount_curve.df(self._maturity_dt, dc) / df_settle
            if discount_margin != 0.0:
                t_mat = day_counter.year_frac(settlement_dt,
                                              self._maturity_dt)[0]
                df_mat *= np.exp(-discount_margin * t_mat)
            principal_pv = self._face_value * df_mat
            pv += principal_pv
            if self._payment_pvs:
                self._payment_pvs[-1] += principal_pv

        return pv

    # ------------------------------------------------------------------

    def accrued_interest(self, settlement_dt: Date) -> float:
        """Accrued per 100 face (reference quirk: per-100 units and the
        accrual rate uses the first fixing + margin when known, else the
        margin alone, clamped — frn.py:371-418)."""
        day_counter = DayCount(self._dc_type)
        for i, payment_dt in enumerate(self._payment_dts):
            if payment_dt > settlement_dt:
                start_dt = self._start_accrued_dts[i]
                if settlement_dt >= start_dt:
                    accrued_frac = day_counter.year_frac(start_dt,
                                                         settlement_dt)[0]
                    if self._first_fixing_rate is not None:
                        rate = self._first_fixing_rate + self._quoted_margin
                    else:
                        rate = self._quoted_margin
                    rate = float(self._clamp(rate))
                    accrued = rate * accrued_frac * self._face_value
                    return 100.0 * accrued / self._face_value
                return 0.0
        return 0.0

    def dirty_price(self, value_dt: Date, discount_curve, index_curve=None,
                    discount_margin: float = 0.0,
                    settlement_dt: Date = None) -> float:
        pv = self.value(value_dt, discount_curve, index_curve,
                        discount_margin, settlement_dt)
        return pv / self._face_value * 100.0

    def clean_price(self, value_dt: Date, discount_curve, index_curve=None,
                    discount_margin: float = 0.0,
                    settlement_dt: Date = None) -> float:
        if settlement_dt is None:
            settlement_dt = value_dt
        dirty = self.dirty_price(value_dt, discount_curve, index_curve,
                                 discount_margin, settlement_dt)
        return dirty - self.accrued_interest(settlement_dt)

    # ------------------------------------------------------------------

    def discount_margin(self, settlement_dt: Date, discount_curve,
                        index_curve, clean_price: float,
                        dm_guess: float = 0.0) -> float:
        """Spread over the discount curve matching the clean price."""
        target_dirty = clean_price + self.accrued_interest(settlement_dt)

        def price_error(dm):
            return self.dirty_price(settlement_dt, discount_curve,
                                    index_curve, dm,
                                    settlement_dt) - target_dirty

        try:
            return brentq(price_error, -0.10, 0.20, xtol=1e-8)
        except Exception:
            try:
                return newton(price_error, dm_guess, tol=1e-8, maxiter=50)
            except Exception:
                raise LibError(
                    f"Failed to converge on discount margin for price "
                    f"{clean_price}")

    def modified_duration(self, value_dt: Date, discount_curve,
                          index_curve=None, discount_margin: float = 0.0,
                          settlement_dt: Date = None) -> float:
        """-(1/P) dP/d(dm) by central 1bp bump (frn.py:494-536)."""
        if settlement_dt is None:
            settlement_dt = value_dt
        bump = 0.0001
        p0 = self.dirty_price(value_dt, discount_curve, index_curve,
                              discount_margin, settlement_dt)
        p_up = self.dirty_price(value_dt, discount_curve, index_curve,
                                discount_margin + bump, settlement_dt)
        p_down = self.dirty_price(value_dt, discount_curve, index_curve,
                                  discount_margin - bump, settlement_dt)
        return -(p_up - p_down) / (2 * bump * p0)

    def dv01(self, value_dt: Date, discount_curve, index_curve=None,
             discount_margin: float = 0.0,
             settlement_dt: Date = None) -> float:
        if settlement_dt is None:
            settlement_dt = value_dt
        bump = 0.0001
        pv = self.value(value_dt, discount_curve, index_curve,
                        discount_margin, settlement_dt)
        pv_bumped = self.value(value_dt, discount_curve, index_curve,
                               discount_margin + bump, settlement_dt)
        return abs(pv_bumped - pv)

    # ------------------------------------------------------------------

    def print_valuation(self):
        """Per-coupon rate/PV table (reference frn.py print_valuation) —
        requires a prior value()."""
        if not hasattr(self, "_payment_pvs"):
            raise LibError("FRN has not been valued — call value() first")
        header = ["PAY_NUM", "PAY_dt", "RATE", "PMNT", "DF", "PV", "CUM_PV"]
        cum = 0.0
        rows = []
        for i in range(self._num_coupons):
            pv = float(self._payment_pvs[i])
            cum += pv
            rows.append([i + 1, str(self._payment_dts[i]),
                         round(float(self._rates[i]), 8),
                         round(float(self._coupon_payments[i]), 2),
                         round(float(self._payment_dfs[i]), 6),
                         round(pv, 2), round(cum, 2)])
        print(format_table(header, rows))

    def print_payments(self):
        header = ["PAY_NUM", "PAY_dt", "ACCR_START", "ACCR_END", "YEARFRAC"]
        rows = [[i + 1, str(self._payment_dts[i]),
                 str(self._start_accrued_dts[i]),
                 str(self._end_accrued_dts[i]),
                 round(self._year_fracs[i], 6)]
                for i in range(self._num_coupons)]
        print(format_table(header, rows))

    def __repr__(self):
        return (f"FRN({self._issue_dt} -> {self._maturity_dt}, "
                f"margin={self._quoted_margin}, {self._freq_type.name}, "
                f"{self._floating_index.name}, face={self._face_value})")
