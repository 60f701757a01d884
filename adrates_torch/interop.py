"""Build the port's objects from plain numpy arrays.

Another implementation of the same book (the JAX reference package, in
the parity tests) hands over its compiled state as numpy arrays and
nested dicts of them — never its own array types — and these functions
turn it into the port's plans and device-layer inputs, so the port's
device layer can be held against the reference apart from its host
layer.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from .ops.bootstrap import OISBootstrapPlan
from .ops.pricers import FixedLegTensor, FloatLegTensor
from .ops.xccy_bootstrap import XccyBootstrapPlan
from .parallel.curve_batching import StageTopology, _Stage, make_grids
from .parallel.multibook import (BookInputs, ClampSlots, ColRows,
                                 MultiBookAggregate, TileSpec, _CurveSpec)
from .utils.global_types import InterpTypes


def _dataclass_from_numpy(cls, fields: dict, scalars=()):
    """``cls`` from a dict of its fields (numpy arrays; the names in
    ``scalars`` as Python scalars of their annotated kind); extra keys
    are ignored."""
    kw = {}
    for f in dataclasses.fields(cls):
        v = fields[f.name]
        kw[f.name] = (v if f.name in scalars else np.asarray(v))
    return cls(**kw)


def ois_plan_from_numpy(fields: dict) -> OISBootstrapPlan:
    """An ``OISBootstrapPlan`` from a dict of its fields (numpy arrays,
    ``depth`` and ``loglinear_rates``); extra keys are ignored."""
    plan = _dataclass_from_numpy(OISBootstrapPlan, fields,
                                 ("depth", "loglinear_rates"))
    return dataclasses.replace(plan, depth=int(plan.depth),
                               loglinear_rates=bool(plan.loglinear_rates))


def xccy_plan_from_numpy(fields: dict) -> XccyBootstrapPlan:
    """An ``XccyBootstrapPlan`` from a dict of its fields."""
    plan = _dataclass_from_numpy(XccyBootstrapPlan, fields,
                                 ("foreign_sign",))
    return dataclasses.replace(plan,
                               foreign_sign=float(plan.foreign_sign))


def leg_from_numpy(fields: dict) -> FloatLegTensor:
    """A (stacked) ``FloatLegTensor`` from a dict of its fields."""
    flags = ("override_first", "notional_exchange", "has_cap_floor")
    leg = _dataclass_from_numpy(FloatLegTensor, fields, flags)
    return dataclasses.replace(leg, **{k: bool(fields[k]) for k in flags})


def fixed_leg_from_numpy(fields: dict) -> FixedLegTensor:
    """A ``FixedLegTensor`` from a dict of its fields."""
    return _dataclass_from_numpy(FixedLegTensor, fields)


def _plans(p: dict) -> dict:
    """A nested dict of interpolation plans as numpy."""
    return {k: _plans(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in p.items()}


def _it(name) -> Optional[InterpTypes]:
    return None if name is None else InterpTypes[name]


def multibook_from_numpy(basket_params: dict, cols: Sequence[dict],
                         clamp: Optional[dict], aggregate: dict,
                         n_trades: int, groups: Optional[Sequence[dict]],
                         n_grid: int, tile: Optional[dict]) -> BookInputs:
    """The device-layer inputs (``multibook.BookInputs``) of a compiled
    book given as numpy.

    ``basket_params``:

    - ``specs``: per curve id, dicts of ``name``, ``kind`` ('ois',
      'xccy' or 'infl'), ``interp`` (scheme name), ``n_quotes``, ``offset`` and, for
      XCCY curves, ``dom_id``, ``for_id``, ``foreign_interp``;
    - ``stages``: dicts of ``kind``, ``ids``, ``key`` and, for XCCY
      stages, ``dom_ids``, ``for_ids``, ``dom_interp``,
      ``foreign_interp``, ``recal``;
    - ``bat``: per stage key the stacked ``plan`` fields, ``qidx``,
      ``pad_mask``, ``ts_static``, ``row_plan`` and (optional)
      ``row_plan_keep``; XCCY stages add ``legs`` (stacked calibration
      leg fields), ``spot_fx``, ``pv_dom0``, ``dom_ts``, ``for_ts``,
      ``fboot_plan`` and ``legs_plan``; the inflation stage has its
      stacked ``swap_times`` in place of ``plan``; under ``gplan`` one
      stacked interpolation plan per scheme name;
    - ``unique_times``, ``n_quotes``, and ``grid``: dict of ``sel``
      (None for a dense grid), ``keep_of``, ``offsets`` and ``inv``;
    - ``structured``: True when the book carries its stage topology (the
      risk pass then takes the structured split).

    ``cols``: dicts of ``col_idx``, ``w``, ``row_trade``. ``clamp``:
    ``ClampSlots`` fields or None. ``aggregate``: ``MultiBookAggregate``
    fields. ``n_trades``: the (tiled) trade count. ``groups``: the term-1
    trip groups (``tsel``, ``s_idx``, ``e_idx``, ``p_idx``, ``segs``,
    ``k``). ``tile``: ``scale`` and ``base_trades``, or None."""
    bp = basket_params
    specs = [_CurveSpec(name=s["name"], kind=s["kind"],
                        interp_type=InterpTypes[s["interp"]],
                        n_quotes=int(s["n_quotes"]), offset=int(s["offset"]),
                        dom_id=int(s.get("dom_id", -1)),
                        for_id=int(s.get("for_id", -1)),
                        foreign_interp_type=_it(s.get("foreign_interp")))
             for s in bp["specs"]]
    stages = []
    for s in bp["stages"]:
        st = _Stage(kind=s["kind"], ids=[int(i) for i in s["ids"]],
                    key=s["key"])
        if st.kind == "xccy":
            st.dom_ids = [int(i) for i in s["dom_ids"]]
            st.for_ids = [int(i) for i in s["for_ids"]]
            st.dom_interp = _it(s["dom_interp"])
            st.foreign_interp = _it(s["foreign_interp"])
            st.recal = bool(s["recal"])
        stages.append(st)

    bat = {"gplan": _plans(bp["bat"]["gplan"])}
    for st in stages:
        b = bp["bat"][st.key]
        d = dict(qidx=np.asarray(b["qidx"]),
                 pad_mask=np.asarray(b["pad_mask"]),
                 ts_static=np.asarray(b["ts_static"]),
                 row_plan=_plans(b["row_plan"]))
        if b.get("row_plan_keep") is not None:
            d["row_plan_keep"] = _plans(b["row_plan_keep"])
        if st.kind == "infl":
            d["swap_times"] = np.asarray(b["swap_times"], dtype=np.float64)
        elif st.kind == "xccy":
            d.update(plan=xccy_plan_from_numpy(b["plan"]),
                     legs=leg_from_numpy(b["legs"]),
                     spot_fx=np.asarray(b["spot_fx"]),
                     pv_dom0=np.asarray(b["pv_dom0"]),
                     dom_ts=np.asarray(b["dom_ts"]),
                     for_ts=np.asarray(b["for_ts"]),
                     fboot_plan=_plans(b["fboot_plan"]),
                     legs_plan=_plans(b["legs_plan"]))
        else:
            d["plan"] = ois_plan_from_numpy(b["plan"])
        bat[st.key] = d

    grid = bp["grid"]
    sel = grid.get("sel")
    topology = None
    if bp.get("structured", True):
        dense = sel is None
        topology = StageTopology(
            stages=stages, specs=specs, bat=bat,
            n_quotes=int(bp["n_quotes"]),
            unique_times=np.asarray(bp["unique_times"]), grid_dense=dense,
            grid_keep_of=None if dense else [np.asarray(k) for k in
                                             grid["keep_of"]],
            grid_offsets=None if dense else np.asarray(grid["offsets"]),
            grid_inv=None if dense else np.asarray(grid["inv"]))
    return BookInputs(
        grids=make_grids(stages, [s.interp_type for s in specs]), bat=bat,
        grid_sel=None if sel is None else np.asarray(sel),
        cols=tuple(ColRows(**{k: np.asarray(c[k]) for k in
                              ("col_idx", "w", "row_trade")})
                   for c in cols),
        clamp=None if clamp is None else ClampSlots(
            **{f.name: np.asarray(clamp[f.name])
               for f in dataclasses.fields(ClampSlots)}),
        aggregate=MultiBookAggregate(
            **{f.name: np.asarray(aggregate[f.name])
               for f in dataclasses.fields(MultiBookAggregate)}),
        groups=None if groups is None else [
            dict(tsel=np.asarray(g["tsel"]), s_idx=np.asarray(g["s_idx"]),
                 e_idx=np.asarray(g["e_idx"]), p_idx=np.asarray(g["p_idx"]),
                 segs=tuple((int(o), int(n)) for o, n in g["segs"]),
                 k=int(g["k"])) for g in groups],
        n_grid=int(n_grid), n_quotes=int(bp["n_quotes"]),
        n_trades=int(n_trades),
        tile=None if tile is None else TileSpec(
            scale=np.asarray(tile["scale"], dtype=np.float64),
            base_trades=int(tile["base_trades"])),
        topology=topology)
