"""Model facade: multi-curve container and FX store.

Port of ``adrates_tpu/models/models.py`` — ``build_curve`` (:74),
``build_fx`` (:159) and ``fx`` (:174). Parity with the reference's
cavour/models/models.py (CurveAccessor 23-49, build_curve 142-228,
build_fx 230-266). XCCY and inflation curves,
prebuilt market data, scenarios and persistence are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

from ..trades.rates.ois import OIS
from ..trades.rates.ois_curve import OISCurve
from ..utils.calendar import BusDayAdjustTypes, CalendarTypes
from ..utils.currency import CurrencyTypes
from ..utils.date import Date
from ..utils.day_count import DayCountTypes
from ..utils.error import LibError
from ..utils.frequency import FrequencyTypes
from ..utils.global_types import CurveTypes, InterpTypes, SwapTypes


class CurveAccessor:
    """Dot/bracket access over the model's curve dictionary."""

    def __init__(self, curves: Dict[str, OISCurve]):
        self._curves = curves

    def __getattr__(self, item):
        try:
            return self._curves[item]
        except KeyError:
            raise AttributeError(f"No such curve: {item}")

    def __getitem__(self, item):
        try:
            return self._curves[item]
        except KeyError:
            raise LibError(
                f"No such curve in model: {item}. Available: "
                f"{list(self._curves.keys())}") from None

    def __contains__(self, item):
        return item in self._curves

    def keys(self):
        return self._curves.keys()


@dataclass
class Model:
    """Multi-curve model: builds and stores curves and FX."""

    value_dt: Date
    _curves_dict: Dict[str, object] = field(default_factory=dict)
    _curve_params_dict: Dict[str, dict] = field(default_factory=dict)
    _fx_params_dict: Dict[str, dict] = field(default_factory=dict)

    def build_curve(self,
                    name: str,
                    px_list: List[float],
                    tenor_list: List[str],
                    spot_days: int = 0,
                    swap_type: SwapTypes = SwapTypes.PAY,
                    fixed_dcc_type: DayCountTypes = DayCountTypes.ACT_360,
                    fixed_freq_type: FrequencyTypes = FrequencyTypes.ANNUAL,
                    float_freq_type: FrequencyTypes = FrequencyTypes.ANNUAL,
                    float_dc_type: DayCountTypes = DayCountTypes.ACT_360,
                    bus_day_type: BusDayAdjustTypes =
                    BusDayAdjustTypes.MODIFIED_FOLLOWING,
                    interp_type: InterpTypes = InterpTypes.LINEAR_ZERO_RATES,
                    payment_lag: int = 0,
                    cal_type: CalendarTypes = CalendarTypes.WEEKEND):
        """Bootstrap an OIS curve from par rates quoted in percent."""
        settle_dt = self.value_dt.add_weekdays(spot_days)
        curve_type = CurveTypes[name]
        currency = CurrencyTypes[name.split("_")[0]]

        swaps = [OIS(effective_dt=settle_dt,
                     term_dt_or_tenor=tenor,
                     fixed_leg_type=swap_type,
                     fixed_coupon=px / 100,
                     fixed_freq_type=fixed_freq_type,
                     fixed_dc_type=fixed_dcc_type,
                     floating_index=curve_type,
                     currency=currency,
                     bd_type=bus_day_type,
                     float_freq_type=float_freq_type,
                     float_dc_type=float_dc_type,
                     payment_lag=payment_lag,
                     cal_type=cal_type)
                 for tenor, px in zip(tenor_list, px_list)]

        curve = OISCurve(value_dt=self.value_dt, ois_swaps=swaps,
                         interp_type=interp_type, check_refit=True)
        self._curves_dict[name] = curve
        self._curve_params_dict[name] = {
            "tenor_list": list(tenor_list),
            "px_list": list(px_list),
            "spot_days": spot_days,
            "swap_type": swap_type,
            "fixed_dcc_type": fixed_dcc_type,
            "fixed_freq_type": fixed_freq_type,
            "float_freq_type": float_freq_type,
            "float_dc_type": float_dc_type,
            "bus_day_type": bus_day_type,
            "interp_type": interp_type,
            "payment_lag": payment_lag,
            "cal_type": cal_type,
        }
        return curve

    def build_fx(self, currency_pairs: List[str],
                 pxs: List[float]) -> dict:
        """Register spot FX rates (pair strings like 'GBPUSD')."""
        result = {}
        for pair, price in zip(currency_pairs, pxs):
            base_code, quote_code = pair[:3], pair[3:]
            try:
                base = CurrencyTypes[base_code]
                quote = CurrencyTypes[quote_code]
            except KeyError:
                raise ValueError(f"Invalid currency code in pair: {pair}")
            result[pair] = {"base": base, "quote": quote, "price": price}
        self._fx_params_dict.update(result)
        return result

    def fx(self, pair: str) -> float:
        """Spot rate for a pair, inverting if necessary. Pairs that need
        routing through a third currency are not ported yet."""
        if pair in self._fx_params_dict:
            return self._fx_params_dict[pair]["price"]
        inverse = pair[3:] + pair[:3]
        if inverse in self._fx_params_dict:
            return 1.0 / self._fx_params_dict[inverse]["price"]
        raise LibError(f"FX pair {pair} needs routing, which is not yet "
                       f"ported (register the pair or its inverse)")

    @property
    def curves(self) -> CurveAccessor:
        return CurveAccessor(self._curves_dict)

    def __repr__(self):
        return (f"Model(value_dt={self.value_dt}, "
                f"curves={list(self._curves_dict.keys())}, "
                f"fx={list(self._fx_params_dict.keys())})")
