"""CPI references of inflation trades, as the book compiler reads them.

Port of ``_cpi_ref`` (``adrates_tpu/market/position/engine_inflation.py
:74-89``): a lagged CPI date covered by the index's historical fixings is
a constant; a later one resolves to seas * base_cpi * factor(t) on the
inflation curve, differentiably in the breakevens. The rest of that module
(the single-trade ZCIS and YoY engine paths) is not ported yet.
"""

from __future__ import annotations

from ...utils.day_count import DayCount


def _cpi_ref(index, infl_curve, ref_dt, value_dt):
    """Classify a CPI reference: (is_fixed, fixed_value, t_curve, seas).

    The lag is applied; if the lagged date has a historical fixing the
    value is that fixing times the seasonal factor, else the reference is
    seas * base_cpi * factor(t_curve) with t_curve in the inflation
    curve's day count from its value date."""
    lagged = index._apply_lag(ref_dt)
    hist = index._get_historical_index(lagged)
    seas = index._seasonality_factors.get(lagged.m(), 1.0) \
        if index._use_seasonality else 1.0
    if hist is not None:
        return True, hist * seas, 0.0, seas
    dc = DayCount(infl_curve._dc_type)
    t = dc.year_frac(infl_curve._value_dt, lagged)[0]
    return False, 0.0, t, seas
