"""Model.build_inflation_curve convenience.

Copy of ``adrates_tpu/models/inflation_builder.py`` over the port's
classes: ZCIS calibration instruments at the quoted breakevens, an
InflationIndex with the publication lag, and the calibrated curve attached
to the index — registered on the model under ``name``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..market.curves.inflation_curve import InflationCurve
from ..market.indices.inflation_index import InflationIndex
from ..trades.rates.zcis import ZeroCouponInflationSwap
from ..utils.calendar import BusDayAdjustTypes, CalendarTypes
from ..utils.currency import CurrencyTypes
from ..utils.day_count import DayCountTypes
from ..utils.global_types import (CurveTypes, InflationIndexTypes,
                                  InflationInterpTypes, SwapTypes)


def build_inflation_curve(model,
                          name: str,
                          breakeven_list: List[float],
                          tenor_list: List[str],
                          base_cpi: float,
                          index_type: InflationIndexTypes =
                          InflationIndexTypes.UK_RPI,
                          lag_months: int = 3,
                          dc_type: DayCountTypes = DayCountTypes.ACT_365F,
                          interp_type: InflationInterpTypes =
                          InflationInterpTypes.LINEAR,
                          cal_type: CalendarTypes = CalendarTypes.WEEKEND,
                          bd_type: BusDayAdjustTypes =
                          BusDayAdjustTypes.FOLLOWING,
                          seasonality_factors: Optional[Dict[int, float]]
                          = None,
                          fixings: Optional[list] = None,
                          check_refit: bool = True):
    """Build an inflation curve from ZCIS breakevens quoted in PERCENT
    (consistent with build_curve's px_list). Returns (curve, index)."""
    currency = CurrencyTypes[name.split("_")[0]]

    if seasonality_factors:
        # JSON round-trips dict keys as strings; months are ints.
        seasonality_factors = {int(k): float(v)
                               for k, v in seasonality_factors.items()}
    index = InflationIndex(index_type=index_type,
                           base_date=model.value_dt.add_months(-lag_months),
                           base_index=base_cpi,
                           currency=currency,
                           lag_months=lag_months,
                           seasonality_factors=seasonality_factors)
    for fixing_date, value in (fixings or []):
        index.add_fixing(fixing_date, value)

    zcis_list = [
        ZeroCouponInflationSwap(
            effective_dt=model.value_dt,
            term_dt_or_tenor=tenor,
            fixed_leg_type=SwapTypes.PAY,
            fixed_rate=px / 100.0,
            inflation_index=index,
            cal_type=cal_type,
            bd_type=bd_type,
            dc_type=dc_type)
        for tenor, px in zip(tenor_list, breakeven_list)]

    curve = InflationCurve(value_dt=model.value_dt,
                           zcis_instruments=zcis_list,
                           base_cpi=base_cpi,
                           currency=currency,
                           index_type=index_type,
                           interp_type=interp_type,
                           dc_type=dc_type,
                           check_refit=check_refit)
    try:
        curve._curve_type = CurveTypes[name]
    except KeyError:
        curve._curve_type = None
    index.set_inflation_curve(curve)

    model._curves_dict[name] = curve
    # Every constructor input is persisted (Date-encoded fixing keys) so
    # Model.from_json rebuilds curve AND index bit-identically.
    model._curve_params_dict[name] = {
        "breakeven_list": list(breakeven_list),
        "tenor_list": list(tenor_list),
        "base_cpi": base_cpi,
        "index_type": index_type,
        "lag_months": lag_months,
        "dc_type": dc_type,
        "interp_type": interp_type,
        "cal_type": cal_type,
        "bd_type": bd_type,
        "seasonality_factors": dict(seasonality_factors)
        if seasonality_factors else None,
        "fixings": [(dt, float(v)) for dt, v in (fixings or [])] or None,
    }
    return curve, index
