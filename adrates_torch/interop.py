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
from .parallel.curve_batching import _Stage, make_grids
from .parallel.multibook import (BookInputs, ClampSlots, ColRows,
                                 MultiBookAggregate, TileSpec)
from .utils.global_types import InterpTypes


def ois_plan_from_numpy(fields: dict) -> OISBootstrapPlan:
    """An ``OISBootstrapPlan`` from a dict of its fields (numpy arrays,
    ``depth`` and ``loglinear_rates``); extra keys are ignored."""
    kw = {}
    for f in dataclasses.fields(OISBootstrapPlan):
        v = fields[f.name]
        if f.name == "depth":
            kw[f.name] = int(v)
        elif f.name == "loglinear_rates":
            kw[f.name] = bool(v)
        else:
            kw[f.name] = np.asarray(v)
    return OISBootstrapPlan(**kw)


def multibook_from_numpy(basket_params: dict, cols: Sequence[dict],
                         clamp: Optional[dict], aggregate: dict,
                         tri, groups: Optional[Sequence[dict]], n_grid: int,
                         tile: Optional[dict]) -> BookInputs:
    """The device-layer inputs (``multibook.BookInputs``) of a compiled
    book given as numpy.

    ``basket_params``: ``interp`` (scheme name per curve id), ``stages``
    (dicts of ``kind``, ``ids``, ``key``), ``bat`` (per stage key the
    stacked ``plan`` fields, ``qidx``, ``pad_mask``; under ``gplan`` one
    stacked interpolation plan per scheme name), ``grid_sel`` (None for
    a dense grid) and ``n_quotes``. ``cols``: dicts of ``col_idx``,
    ``w``, ``row_trade``. ``clamp``: ``ClampSlots`` fields or None.
    ``aggregate``: ``MultiBookAggregate`` fields. ``tri``: the [B, K]
    trade row table. ``groups``: the term-1 trip groups (``tsel``,
    ``s_idx``, ``e_idx``, ``p_idx``, ``segs``, ``k``). ``tile``:
    ``scale`` and ``base_trades``, or None."""
    bp = basket_params
    interp = [InterpTypes[n] for n in bp["interp"]]
    stages = [_Stage(kind=s["kind"], ids=[int(i) for i in s["ids"]],
                     key=s["key"]) for s in bp["stages"]]
    bat = {"gplan": {name: {k: np.asarray(v) for k, v in p.items()}
                     for name, p in bp["bat"]["gplan"].items()}}
    for st in stages:
        b = bp["bat"][st.key]
        bat[st.key] = dict(plan=ois_plan_from_numpy(b["plan"]),
                           qidx=np.asarray(b["qidx"]),
                           pad_mask=np.asarray(b["pad_mask"]))
    sel = bp.get("grid_sel")
    tri = np.asarray(tri, dtype=np.int32)
    return BookInputs(
        grids=make_grids(stages, interp), bat=bat,
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
        tri=tri,
        groups=None if groups is None else [
            dict(tsel=np.asarray(g["tsel"]), s_idx=np.asarray(g["s_idx"]),
                 e_idx=np.asarray(g["e_idx"]), p_idx=np.asarray(g["p_idx"]),
                 segs=tuple((int(o), int(n)) for o, n in g["segs"]),
                 k=int(g["k"])) for g in groups],
        n_grid=int(n_grid), n_quotes=int(bp["n_quotes"]),
        n_trades=int(tri.shape[0]),
        tile=None if tile is None else TileSpec(
            scale=np.asarray(tile["scale"], dtype=np.float64),
            base_trades=int(tile["base_trades"])))
