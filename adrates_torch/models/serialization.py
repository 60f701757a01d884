"""Model persistence: save/load the market state needed to re-bootstrap.

Port of ``adrates_tpu/models/serialization.py``: the same ``__enum__`` /
``__date__`` encoding and the same rebuild order (OIS, then XCCY, then
inflation), so a JSON text written by either package loads in the other.
Curves re-bootstrap from their stored quotes on load rather than
serializing tensors.
"""
from __future__ import annotations

import json
from enum import Enum
from typing import TextIO, Union

from ..utils.calendar import BusDayAdjustTypes, CalendarTypes
from ..utils.date import Date
from ..utils.day_count import DayCountTypes
from ..utils.frequency import FrequencyTypes
from ..utils.global_types import (InflationIndexTypes, InflationInterpTypes,
                                  InterpTypes, SwapTypes)

_ENUMS = {
    "DayCountTypes": DayCountTypes,
    "FrequencyTypes": FrequencyTypes,
    "BusDayAdjustTypes": BusDayAdjustTypes,
    "CalendarTypes": CalendarTypes,
    "InterpTypes": InterpTypes,
    "SwapTypes": SwapTypes,
    "InflationIndexTypes": InflationIndexTypes,
    "InflationInterpTypes": InflationInterpTypes,
}


def _encode(obj):
    if isinstance(obj, Enum):
        return {"__enum__": f"{type(obj).__name__}.{obj.name}"}
    if isinstance(obj, Date):
        return {"__date__": [obj.d(), obj.m(), obj.y()]}
    raise TypeError(f"Not JSON-serializable: {type(obj)}")


def _decode(dct):
    if "__enum__" in dct:
        cls_name, member = dct["__enum__"].split(".")
        return _ENUMS[cls_name][member]
    if "__date__" in dct:
        d, m, y = dct["__date__"]
        return Date(d, m, y)
    return dct


def model_to_json(model, fp: Union[str, TextIO, None] = None):
    """Serialize the model's market state (curve params + FX) to JSON."""
    state = {
        "value_dt": model.value_dt,
        "curve_params": model._curve_params_dict,
        "fx_params": {
            pair: rec["price"] if isinstance(rec, dict) else rec
            for pair, rec in model._fx_params_dict.items()},
    }
    text = json.dumps(state, default=_encode, indent=2)
    if fp is None:
        return text
    if isinstance(fp, str):
        with open(fp, "w") as f:
            f.write(text)
        return None
    fp.write(text)
    return None


def model_from_json(source: Union[str, TextIO]):
    """Rebuild a Model (re-bootstrapping every curve) from JSON state.

    Curves rebuild in dependency order: OIS curves first, then XCCY and
    inflation (which reference them).
    """
    from .models import Model

    if hasattr(source, "read"):
        text = source.read()
    elif source.lstrip().startswith("{"):
        text = source
    else:
        with open(source) as f:
            text = f.read()
    state = json.loads(text, object_hook=_decode)

    model = Model(state["value_dt"])
    if state["fx_params"]:
        pairs = list(state["fx_params"].keys())
        model.build_fx(pairs, [state["fx_params"][p] for p in pairs])

    ois_items = {}
    xccy_items = {}
    infl_items = {}
    for name, params in state["curve_params"].items():
        if "basis_spreads" in params:
            xccy_items[name] = params
        elif "breakeven_list" in params:
            infl_items[name] = params
        else:
            ois_items[name] = params

    for name, params in ois_items.items():
        model.build_curve(name, **params)
    for name, params in xccy_items.items():
        model.build_xccy_curve(name, **params)
    for name, params in infl_items.items():
        model.build_inflation_curve(name, **params)
    return model
