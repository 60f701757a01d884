"""Inflation index: CPI fixing store, publication lag, projection.

Copy of ``adrates_tpu/market/indices/inflation_index.py`` (plain Python):
seasonality validation, the publication lag, FLAT/LINEAR/COMPOUND
interpolation between fixings, historical lookup with the inflation
curve as the projection fallback, and ``inflation_ratio``.
"""

from __future__ import annotations

from typing import Dict, Optional

from ...utils.currency import CurrencyTypes
from ...utils.date import Date
from ...utils.day_count import DayCount, DayCountTypes
from ...utils.error import LibError
from ...utils.global_types import InflationIndexTypes, InflationInterpTypes
from ...utils.helpers import label_to_string


class InflationIndex:
    """CPI index: historical fixings + lag + optional seasonality, with an
    inflation curve as the projection fallback for future dates."""

    def __init__(self,
                 index_type: InflationIndexTypes,
                 base_date: Date,
                 base_index: float,
                 currency: CurrencyTypes,
                 lag_months: int = 3,
                 interp_type: InflationInterpTypes =
                 InflationInterpTypes.LINEAR,
                 seasonality_factors: Optional[Dict[int, float]] = None):
        if base_index <= 0.0:
            raise LibError("Base index must be positive")
        if lag_months < 0:
            raise LibError("Lag months must be non-negative")
        if seasonality_factors is not None:
            self._validate_seasonality_factors(seasonality_factors)

        self._index_type = index_type
        self._base_date = base_date
        self._base_index = base_index
        self._currency = currency
        self._lag_months = lag_months
        self._interp_type = interp_type
        self._seasonality_factors = seasonality_factors or {}
        self._use_seasonality = len(self._seasonality_factors) > 0

        self._fixings: Dict[int, tuple] = {
            base_date.serial(): (base_date, base_index)}
        self._inflation_curve = None

    # ------------------------------------------------------------------

    @staticmethod
    def _validate_seasonality_factors(factors: Dict[int, float]):
        if set(factors.keys()) != set(range(1, 13)):
            raise LibError(
                f"Seasonality factors must include all months 1-12. "
                f"Got: {sorted(factors.keys())}")
        for month, factor in factors.items():
            if factor <= 0:
                raise LibError(
                    f"Seasonality factors must be positive. "
                    f"Month {month} has factor {factor}")
        avg = sum(factors.values()) / 12.0
        if abs(avg - 1.0) > 0.01:
            raise LibError(
                f"Seasonality factors should average to 1.0 (within 1% "
                f"tolerance). Got average: {avg:.6f}")

    def _apply_seasonality(self, date: Date, cpi_value: float) -> float:
        if not self._use_seasonality:
            return cpi_value
        return cpi_value * self._seasonality_factors.get(date.m(), 1.0)

    # ------------------------------------------------------------------

    def add_fixing(self, fixing_date: Date, index_value: float):
        if index_value <= 0.0:
            raise LibError(
                f"Index value must be positive, got {index_value}")
        self._fixings[fixing_date.serial()] = (fixing_date, index_value)

    def set_inflation_curve(self, inflation_curve):
        self._inflation_curve = inflation_curve

    def _apply_lag(self, ref_date: Date) -> Date:
        return ref_date.add_months(-self._lag_months)

    # ------------------------------------------------------------------

    def get_index(self, ref_date: Date, apply_lag: bool = True) -> float:
        """CPI at (optionally lagged) date: historical fixings first
        (interpolated intra-month), inflation-curve projection otherwise."""
        lookup_date = self._apply_lag(ref_date) if apply_lag else ref_date

        value = self._get_historical_index(lookup_date)
        if value is not None:
            return self._apply_seasonality(lookup_date, value)

        if self._inflation_curve is not None:
            curve_value = self._inflation_curve.forward_index(lookup_date)
            return self._apply_seasonality(lookup_date, curve_value)

        raise LibError(
            f"No fixing available for {lookup_date} and no inflation curve "
            f"set. Add fixings via add_fixing() or set curve via "
            f"set_inflation_curve().")

    def inflation_ratio(self, start_dt: Date, end_dt: Date,
                        apply_lag: bool = True) -> float:
        """I(end)/I(start): the ratio a ZCIS pays on."""
        index_start = self.get_index(start_dt, apply_lag)
        index_end = self.get_index(end_dt, apply_lag)
        if index_start <= 0.0:
            raise LibError("Start index must be positive")
        return index_end / index_start

    # ------------------------------------------------------------------

    def _get_historical_index(self, lookup_date: Date) -> Optional[float]:
        if not self._fixings:
            return None
        serials = sorted(self._fixings.keys())
        first_dt = self._fixings[serials[0]][0]
        last_dt = self._fixings[serials[-1]][0]
        if lookup_date < first_dt or lookup_date > last_dt:
            return None
        key = lookup_date.serial()
        if key in self._fixings:
            return self._fixings[key][1]

        for i in range(len(serials) - 1):
            lo = self._fixings[serials[i]]
            hi = self._fixings[serials[i + 1]]
            if lo[0] <= lookup_date <= hi[0]:
                return self._interpolate(lookup_date, lo[0], hi[0],
                                         lo[1], hi[1])
        return None

    def _interpolate(self, target_date: Date, lower_date: Date,
                     upper_date: Date, lower_value: float,
                     upper_value: float) -> float:
        if self._interp_type == InflationInterpTypes.FLAT:
            return lower_value
        dc = DayCount(DayCountTypes.ACT_365F)
        total = dc.year_frac(lower_date, upper_date)[0]
        elapsed = dc.year_frac(lower_date, target_date)[0]
        if total == 0:
            return lower_value
        w = elapsed / total
        if self._interp_type == InflationInterpTypes.LINEAR:
            return lower_value + w * (upper_value - lower_value)
        if self._interp_type == InflationInterpTypes.COMPOUND:
            return lower_value * (upper_value / lower_value) ** w
        raise LibError(f"Unknown interpolation type: {self._interp_type}")

    def get_all_fixings(self) -> list:
        return [(date, value) for date, value in self._fixings.values()]

    # ------------------------------------------------------------------

    def __repr__(self):
        s = label_to_string("OBJECT TYPE", type(self).__name__)
        s += label_to_string("INDEX TYPE", self._index_type)
        s += label_to_string("BASE DATE", self._base_date)
        s += label_to_string("BASE INDEX", self._base_index)
        s += label_to_string("LAG (MONTHS)", self._lag_months)
        s += label_to_string("NUM FIXINGS", len(self._fixings))
        s += label_to_string("HAS CURVE",
                             self._inflation_curve is not None)
        return s
