"""Inflation curve: ZCIS-calibrated cumulative inflation factors.

Port of ``adrates_tpu/market/curves/inflation_curve.py``: node k stores
the factor (1+r_k)^T_k (one ``torch.pow`` over the pillars, with the
t = 0 node of factor 1, ``inflation_curve.py:110-116``), the
``InflationInterpTypes`` map onto the port's simple schemes (:28-32),
``forward_index``, ``inflation_rate`` and the 1e-10 ZCIS refit gate
(:120-134). The grid is held on the host as CPU float64 tensors and
queried through ``DiscountCurve.df_t`` (static plans), so the factors
interpolate exactly as the book path's inflation stage does.
"""

from __future__ import annotations

import torch

from ...utils.currency import CurrencyTypes
from ...utils.date import Date
from ...utils.day_count import DayCount, DayCountTypes
from ...utils.error import LibError
from ...utils.frequency import FrequencyTypes
from ...utils.global_types import (InflationIndexTypes,
                                   InflationInterpTypes, InterpTypes)
from ...utils.helpers import label_to_string
from ...utils.observability import timed
from .discount_curve import DiscountCurve

ZCIS_TOL = 1e-10

_INTERP_MAPPING = {
    InflationInterpTypes.LINEAR: InterpTypes.LINEAR_ZERO_RATES,
    InflationInterpTypes.COMPOUND: InterpTypes.LINEAR_ZERO_RATES,
    InflationInterpTypes.FLAT: InterpTypes.FLAT_FWD_RATES,
}


class InflationCurve(DiscountCurve):
    """Cumulative inflation-factor curve: I(T)/I(0) = (1+r_T)^T at the
    calibrated pillars, interpolated in between."""

    def __init__(self,
                 value_dt: Date,
                 zcis_instruments: list,
                 base_cpi: float,
                 currency: CurrencyTypes,
                 index_type: InflationIndexTypes,
                 discount_curve: DiscountCurve = None,
                 interp_type: InflationInterpTypes =
                 InflationInterpTypes.LINEAR,
                 dc_type: DayCountTypes = DayCountTypes.ACT_365F,
                 check_refit: bool = False):
        if base_cpi <= 0.0:
            raise LibError("Base CPI must be positive")
        if len(zcis_instruments) < 2:
            raise LibError("Need at least 2 ZCIS instruments to build "
                           "a curve")

        self._value_dt = value_dt
        self._used_swaps = zcis_instruments
        self._base_cpi = base_cpi
        self._currency = currency
        self._index_type = index_type
        self._discount_curve = discount_curve
        self._interp_type_infl = interp_type
        self._interp_type = _INTERP_MAPPING.get(
            interp_type, InterpTypes.LINEAR_ZERO_RATES)
        self._dc_type = dc_type
        self._check_refit = check_refit
        self._freq_type = FrequencyTypes.CONTINUOUS

        with timed("curve.build.inflation", pillars=len(zcis_instruments)):
            breakeven_rates = self._prepare_curve_builder_inputs()
            self._times, self._dfs = self._build_curve(
                torch.tensor(breakeven_rates, dtype=torch.float64))
            if check_refit:
                self._check_refits(ZCIS_TOL)

    # ------------------------------------------------------------------

    def _prepare_curve_builder_inputs(self):
        """Breakeven rates + pillar times from the calibration ZCIS (par
        ZCIS fixed rate IS the breakeven)."""
        dc = DayCount(self._dc_type)
        breakeven_rates = []
        self.swap_times = []
        self.tenors = []
        prev_t = 0.0
        for zcis in self._used_swaps:
            breakeven_rates.append(zcis._fixed_rate)
            year_frac = dc.year_frac(zcis._effective_dt,
                                     zcis._maturity_dt)[0]
            if year_frac <= prev_t:
                raise LibError("ZCIS instruments must be sorted by "
                               "increasing maturity")
            prev_t = year_frac
            self.swap_times.append(year_frac)
            if abs(year_frac - round(year_frac)) < 0.1:
                self.tenors.append(f"{int(round(year_frac))}Y")
            else:
                self.tenors.append(f"{year_frac:.2f}Y")
        self.breakeven_rates = breakeven_rates
        return breakeven_rates

    def _build_curve(self, breakeven_rates: torch.Tensor):
        """(times, factors) with the t = 0 node: one power, differentiable
        in the breakevens."""
        swap_times = torch.tensor(self.swap_times, dtype=torch.float64)
        factors = torch.pow(1.0 + breakeven_rates, swap_times)
        one = torch.ones(1, dtype=torch.float64)
        return (torch.cat([torch.zeros(1, dtype=torch.float64),
                           swap_times]),
                torch.cat([one, factors]))

    # ------------------------------------------------------------------

    def _factor(self, year_frac: float) -> float:
        return float(self.df_t(year_frac)[0])

    def _check_refits(self, zcis_tol: float):
        """Back out the implied breakeven at each pillar; hard-fail if it
        deviates from the quote."""
        dc = DayCount(self._dc_type)
        for zcis in self._used_swaps:
            year_frac = dc.year_frac(zcis._effective_dt,
                                     zcis._maturity_dt)[0]
            factor = self._factor(year_frac)
            implied = factor ** (1.0 / year_frac) - 1.0 \
                if year_frac > 0 else 0.0
            diff = abs(implied - zcis._fixed_rate)
            if diff > zcis_tol:
                raise LibError(
                    f"ZCIS with maturity {zcis._maturity_dt} not repriced. "
                    f"Difference is {diff * 1e4:.4f} bps")

    # ------------------------------------------------------------------

    def forward_index(self, target_date: Date) -> float:
        """Projected CPI: I(T) = base_cpi * factor(T)."""
        if target_date < self._value_dt:
            raise LibError(
                f"Cannot project CPI before value date. "
                f"Target: {target_date}, Value: {self._value_dt}")
        dc = DayCount(self._dc_type)
        year_frac = dc.year_frac(self._value_dt, target_date)[0]
        return self._base_cpi * self._factor(year_frac)

    def inflation_rate(self, start_dt: Date, end_dt: Date) -> float:
        """Implied annualized inflation between two (future) dates."""
        if end_dt <= start_dt:
            raise LibError("End date must be after start date")
        cpi_start = self.forward_index(start_dt)
        cpi_end = self.forward_index(end_dt)
        dc = DayCount(self._dc_type)
        year_frac = dc.year_frac(start_dt, end_dt)[0]
        if year_frac <= 0:
            raise LibError("Year fraction must be positive")
        return (cpi_end / cpi_start) ** (1.0 / year_frac) - 1.0

    # ------------------------------------------------------------------

    def __repr__(self):
        s = label_to_string("OBJECT TYPE", type(self).__name__)
        s += label_to_string("VALUATION DATE", self._value_dt)
        s += label_to_string("BASE CPI", self._base_cpi)
        s += label_to_string("INDEX TYPE", self._index_type)
        for i, zcis in enumerate(self._used_swaps):
            s += label_to_string(
                self.tenors[i],
                f"{zcis._fixed_rate * 1e4:8.2f}bp  "
                f"{float(self._dfs[i + 1]):10.6f}")
        return s
