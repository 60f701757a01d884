"""Model facade: multi-curve container, FX store, scenario engine.

Port of ``adrates_tpu/models/models.py`` — ``build_curve`` (:74),
``build_parallel`` (:130), ``build_xccy_curve`` (:187,
``models/xccy_builder.py``), ``build_inflation_curve`` (:191,
``models/inflation_builder.py``), ``build_fx`` (:159), ``fx`` (:174,
routed through ``marketdata.FXRoutingEngine``), ``scenario`` (:238),
``scenario_grid`` (:279) and ``to_json`` / ``from_json`` (:308,
``models/serialization.py``). Parity with the reference's
cavour/models/models.py (CurveAccessor 23-49, build_curve 142-228,
build_fx 230-266, scenario 507-557). The Bloomberg-backed ``prebuilt_*``
builders are not ported (they need ``xbbg`` and a terminal).

``scenario_grid`` is the one method that puts tensors on a device: it
takes ``device`` (None: the CUDA card, see ``utils/device.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Union

import numpy as np
import torch
from torch.func import vmap

from ..marketdata.market_data_engine import FXRoutingEngine
from ..ops.bootstrap import bootstrap_ois, plan_to_torch
from ..trades.rates.ois import OIS
from ..trades.rates.ois_curve import OISCurve
from ..trades.rates.xccy_basis_swap import XccyBasisSwap
from ..trades.rates.xccy_curve import XccyCurve
from ..utils.calendar import BusDayAdjustTypes, CalendarTypes
from ..utils.currency import CurrencyTypes
from ..utils.date import Date
from ..utils.day_count import DayCountTypes
from ..utils.device import resolve_device
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
    """Multi-curve model: builds and stores curves, FX, and scenarios."""

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

    def build_parallel(self, *waves):
        """Run curve builds wave by wave: each wave is an iterable of
        zero-arg callables (closures over ``build_curve`` /
        ``build_xccy_curve`` / ``build_inflation_curve`` calls), and a
        later wave may read curves an earlier one built (XCCY needs its
        parent OIS curves). The JAX package runs a wave on a thread pool
        only to overlap XLA compiles; the port has none, so each wave runs
        in order. ``CurveBasket`` orders curves by name within each kind,
        so the build order does not change the book's packing."""
        for wave in waves:
            for build in wave:
                build()

    def build_inflation_curve(self, *args, **kwargs):
        """Build and register an inflation curve from ZCIS breakevens in
        percent; returns (curve, index). See
        ``models/inflation_builder.py``."""
        from .inflation_builder import build_inflation_curve
        return build_inflation_curve(self, *args, **kwargs)

    def build_xccy_curve(self,
                         name: str,
                         domestic_curve_name: str,
                         foreign_curve_name: str,
                         basis_spreads: List[float],
                         tenor_list: List[str],
                         spot_fx: float,
                         domestic_notional: float = 100_000_000,
                         domestic_freq_type: FrequencyTypes =
                         FrequencyTypes.ANNUAL,
                         foreign_freq_type: FrequencyTypes =
                         FrequencyTypes.ANNUAL,
                         domestic_dc_type: DayCountTypes =
                         DayCountTypes.ACT_360,
                         foreign_dc_type: DayCountTypes =
                         DayCountTypes.ACT_365F,
                         bus_day_type: BusDayAdjustTypes =
                         BusDayAdjustTypes.MODIFIED_FOLLOWING,
                         interp_type: InterpTypes =
                         InterpTypes.FLAT_FWD_RATES,
                         check_refit: bool = True,
                         use_ad: bool = True) -> XccyCurve:
        """Bootstrap a foreign-in-domestic-collateral curve from basis
        spreads (quoted in bp) and register it under ``name`` (port of
        ``adrates_tpu/models/xccy_builder.py``). The "domestic" curve is
        the collateral currency's OIS curve; spot_fx is DOMESTIC per
        FOREIGN. ``use_ad`` is only stored with the curve's parameters, as
        the JAX builder stores it (its curve class reads it nowhere), so
        the two packages' stored parameters and JSON agree."""
        for role, cname in (("Domestic", domestic_curve_name),
                            ("Foreign", foreign_curve_name)):
            if cname not in self._curves_dict:
                raise ValueError(
                    f"{role} curve '{cname}' not found in model. "
                    f"Build it first using build_curve().")
        domestic_curve = self._curves_dict[domestic_curve_name]
        foreign_curve = self._curves_dict[foreign_curve_name]
        domestic_currency = CurrencyTypes[domestic_curve_name.split("_")[0]]
        foreign_currency = CurrencyTypes[foreign_curve_name.split("_")[0]]
        domestic_index = CurveTypes[domestic_curve_name]
        foreign_index = CurveTypes[foreign_curve_name]
        foreign_notional = domestic_notional / spot_fx

        basis_swaps = [XccyBasisSwap(
            effective_dt=self.value_dt,
            term_dt_or_tenor=tenor,
            domestic_notional=domestic_notional,
            foreign_notional=foreign_notional,
            domestic_spread=0.0,
            foreign_spread=spread_bps / 10000.0,
            domestic_freq_type=domestic_freq_type,
            foreign_freq_type=foreign_freq_type,
            domestic_dc_type=domestic_dc_type,
            foreign_dc_type=foreign_dc_type,
            domestic_floating_index=domestic_index,
            foreign_floating_index=foreign_index,
            domestic_currency=domestic_currency,
            foreign_currency=foreign_currency,
            domestic_bd_type=bus_day_type,
            foreign_bd_type=bus_day_type)
            for tenor, spread_bps in zip(tenor_list, basis_spreads)]

        curve = XccyCurve(value_dt=self.value_dt, basis_swaps=basis_swaps,
                          domestic_curve=domestic_curve,
                          foreign_curve=foreign_curve, spot_fx=spot_fx,
                          interp_type=interp_type, check_refit=check_refit)
        curve._domestic_index = domestic_index
        curve._foreign_index = foreign_index
        self._curves_dict[name] = curve
        self._curve_params_dict[name] = {
            "domestic_curve_name": domestic_curve_name,
            "foreign_curve_name": foreign_curve_name,
            "basis_spreads": list(basis_spreads),
            "tenor_list": list(tenor_list),
            "spot_fx": spot_fx,
            "domestic_notional": domestic_notional,
            "domestic_freq_type": domestic_freq_type,
            "foreign_freq_type": foreign_freq_type,
            "domestic_dc_type": domestic_dc_type,
            "foreign_dc_type": foreign_dc_type,
            "bus_day_type": bus_day_type,
            "interp_type": interp_type,
            "use_ad": use_ad,
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
        """Spot rate for a pair, inverting or routing if necessary."""
        if pair in self._fx_params_dict:
            return self._fx_params_dict[pair]["price"]
        inverse = pair[3:] + pair[:3]
        if inverse in self._fx_params_dict:
            return 1.0 / self._fx_params_dict[inverse]["price"]
        return FXRoutingEngine(self._fx_params_dict).rate(pair)

    # ------------------------------------------------------------------
    # scenarios
    # ------------------------------------------------------------------

    def scenario(self, curve_name: str,
                 shock: Union[float, Dict[str, float]]) -> "Model":
        """New Model with one curve re-bootstrapped under shocked quotes.

        shock: float => parallel shift in PERCENT units (reference
        convention, models.py:507-557); dict tenor->shift for per-tenor.
        Untouched curves and FX are copied by reference; every XCCY curve
        whose domestic or foreign parent is the shocked curve is rebuilt.
        The name of an XCCY or inflation curve has stored parameters
        without ``px_list`` and raises ``KeyError``, as in the JAX
        package.
        """
        if curve_name not in self._curve_params_dict:
            raise LibError(f"No stored parameters for curve {curve_name}")
        params = dict(self._curve_params_dict[curve_name])
        tenor_list = params["tenor_list"]
        px_list = list(params["px_list"])

        if isinstance(shock, dict):
            unknown = set(shock) - set(tenor_list)
            if unknown:
                raise LibError(f"Shock tenors not on curve: {unknown}")
            px_list = [px + shock.get(ten, 0.0)
                       for px, ten in zip(px_list, tenor_list)]
        else:
            px_list = [px + shock for px in px_list]

        new_model = Model(self.value_dt)
        new_model._curves_dict = dict(self._curves_dict)
        new_model._curve_params_dict = dict(self._curve_params_dict)
        new_model._fx_params_dict = dict(self._fx_params_dict)
        params["px_list"] = px_list
        new_model.build_curve(curve_name, **params)

        # XCCY node DFs are functions of their parents' grids: a shocked
        # OIS curve invalidates its dependants (the reference returns a
        # model holding only the shocked curve; keeping the rest of the
        # market consistent is the JAX package's upgrade, kept here)
        for dep_name, dep_params in self._curve_params_dict.items():
            if dep_params.get("domestic_curve_name") == curve_name or \
                    dep_params.get("foreign_curve_name") == curve_name:
                new_model.build_xccy_curve(dep_name, **dep_params)
        return new_model

    def scenario_grid(self, curve_name: str, shocks,
                      device=None) -> torch.Tensor:
        """Batched scenario bootstrap: shocks [S, P] in percent added to
        the stored quotes; returns the DF grids [S, n_nodes] (t = 0 node
        included) on ``device`` from ONE ``vmap`` of ``bootstrap_ois``
        over the curve's plan (no Python rebuild per row)."""
        curve = self._curves_dict[curve_name]
        dev = resolve_device(device)
        base = torch.as_tensor(np.asarray(curve.swap_rates, np.float64),
                               device=dev)
        shocks = torch.as_tensor(shocks, dtype=torch.float64,
                                 device=dev) / 100.0
        plan = plan_to_torch(curve._plan, dev)
        return vmap(lambda s: bootstrap_ois(base + s, plan)[1])(shocks)

    # ------------------------------------------------------------------
    # persistence
    # ------------------------------------------------------------------

    def to_json(self, fp=None):
        """Serialize market state (curve params + FX) to JSON; every
        curve re-bootstraps bit-identically on load."""
        from .serialization import model_to_json
        return model_to_json(self, fp)

    @classmethod
    def from_json(cls, source) -> "Model":
        from .serialization import model_from_json
        return model_from_json(source)

    @property
    def curves(self) -> CurveAccessor:
        return CurveAccessor(self._curves_dict)

    def __repr__(self):
        return (f"Model(value_dt={self.value_dt}, "
                f"curves={list(self._curves_dict.keys())}, "
                f"fx={list(self._fx_params_dict.keys())})")
