"""Batched curve-graph construction: one batched bootstrap per GROUP of
same-topology curves instead of one subgraph per curve.

Port of the OIS stages of ``adrates_tpu/parallel/curve_batching.py``.
The host side (plan stacking, sentinel padding, static interpolation
plans) is the same numpy code; the ``grids(qvec, P)`` closure is torch
and runs each stage's curves as one [G, ...] bootstrap
(``ops/bootstrap.bootstrap_ois`` takes stacked plans directly).

Padding semantics (all static, built once in numpy):

- Within a group, plans pad to the max point/pillar counts. Padded
  bootstrap rows are EXACT no-ops (acc=0, no prev link -> pv01=0, df=1).
- Padded grid POSITIONS are pushed to ascending sentinel times
  t_i = 1e30 + i*1e24 with df 1.0. Interpolating any real query t against
  such a grid reproduces the unpadded clamp extrapolation to ~1e-28
  relative (the pad knot is 1e30 away), for every simple scheme. The
  sentinels live in the f64 plans: never cast a plan to f32.

XCCY and inflation stages and the spline schemes are not ported yet:
they raise ``LibError``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..ops.bootstrap import OISBootstrapPlan, bootstrap_ois
from ..ops.bootstrap import plan_to_torch as ois_plan_to_torch
from ..ops.interpolation import (plan_to_torch, simple_df_static,
                                 simple_interp_plan)
from ..utils.error import LibError
from ..utils.global_types import InterpTypes

_SIMPLE = (InterpTypes.FLAT_FWD_RATES, InterpTypes.LINEAR_ZERO_RATES,
           InterpTypes.LINEAR_FWD_RATES)


def _sent(i0: int, n: int) -> np.ndarray:
    """Ascending sentinel times for pad positions [i0, i0+n): far beyond
    any real tenor, strictly increasing by position so stacked grids stay
    sorted regardless of which stage padded them."""
    return 1e30 + (i0 + np.arange(n, dtype=np.float64)) * 1e24


def _pad1(a, n, fill):
    a = np.asarray(a)
    out = np.full((n,) + a.shape[1:], fill, dtype=a.dtype)
    out[:a.shape[0]] = a
    return out


def _stack_ois_plans(plans: Sequence[OISBootstrapPlan]) -> OISBootstrapPlan:
    """Stack same-loglinear OIS plans into one [G, ...] plan (padded
    rows solve to df=1 and are later sentinelized)."""
    P = max(p.point_times.shape[0] for p in plans)

    def f(field, pad):
        return np.stack([_pad1(getattr(p, field), P, pad) for p in plans])

    Q = max(p.swap_times.shape[0] for p in plans)
    point_times = np.stack([
        np.concatenate([p.point_times,
                        p.point_times[-1] + 1.0
                        + np.arange(P - p.point_times.shape[0])])
        for p in plans])
    swap_times = np.stack([
        np.concatenate([p.swap_times,
                        p.swap_times[-1] + 1.0
                        + np.arange(Q - p.swap_times.shape[0])])
        for p in plans])
    return OISBootstrapPlan(
        point_times=point_times,
        accs=f("accs", 0.0),
        prev_idx=f("prev_idx", -1),
        pillar_idx=f("pillar_idx", -1),
        swap_times=swap_times,
        pillar_point=f("pillar_point", 0),
        depth=max(p.depth for p in plans),
        loglinear_rates=plans[0].loglinear_rates,
        # pad rows read rates[0] with weight c=0 — their interp value
        # is unused (acc=0 rows solve to df=1 regardless)
        rate_i0=f("rate_i0", 0), rate_i1=f("rate_i1", 0),
        rate_c=f("rate_c", 0.0))


def _qidx(spec, n: int) -> np.ndarray:
    """Global quote indices for a curve, padded with the LAST real index
    (pad rates repeat the last pillar — monotone under log-interp)."""
    idx = np.arange(spec.offset, spec.offset + spec.n_quotes,
                    dtype=np.int32)
    return _pad1(idx, n, idx[-1])


@dataclasses.dataclass
class _Stage:
    """Static description of one batched stage (arrays live in params)."""
    kind: str                    # 'ois' (the only kind ported)
    ids: List[int]               # curve ids in stack order
    key: str                     # params["bat"] entry name


def _stack_plans(plans: Sequence[dict]) -> dict:
    """Stack per-member simple_interp_plan dicts along a leading axis."""
    return {k: np.stack([p[k] for p in plans]) for k in plans[0]}


def _row_plan(ut: np.ndarray, ts_static: np.ndarray,
              its: Sequence[InterpTypes]) -> dict:
    """Per-scheme stacked static plans of a stage's rows at the shared
    query times, keyed by scheme name (the per-stage row evaluation of
    the structured risk pass, which is not ported yet, reads these)."""
    by_scheme: Dict[InterpTypes, List[int]] = {}
    for m, it in enumerate(its):
        if it in _SIMPLE:
            by_scheme.setdefault(it, []).append(m)
    return {it.name: _stack_plans(
        [simple_interp_plan(ut, ts_static[m], it) for m in mids])
        for it, mids in by_scheme.items()}


def build_batched_grids(basket, unique_times: np.ndarray,
                        stage_buckets: str = "fine"):
    """Build the batched quotes->[C*U] grids function for a CurveBasket.

    Returns (grids_fn, bat, stages). ``bat`` holds the host numpy plans;
    :func:`bat_to_torch` moves them to a device, and grids_fn(qvec, P)
    reads that device form from P["bat"].

    ``stage_buckets``: "fine" buckets OIS plan shapes at (quotes/8,
    points/32) — minimal tangent padding; "coarse" at (quotes/32,
    points/256) — mixed-pillar-count models merge into one stage.
    """
    if stage_buckets == "coarse":
        qb, pb = 32, 256
    elif stage_buckets == "fine":
        qb, pb = 8, 32
    else:
        raise ValueError(f"stage_buckets must be 'fine' or 'coarse', "
                         f"got {stage_buckets!r}")
    specs = basket.specs
    C = len(specs)
    bat: Dict[str, dict] = {}
    stages: List[_Stage] = []

    # ---- group OIS curves by static solve config --------------------
    # The group key buckets the plan SHAPES as well as the solve config:
    # one merged group forces every member to the max quote/point count.
    ois_plan_of = {i: basket.params["ois_plans"][i] for i in range(C)}
    groups: Dict[tuple, List[int]] = {}
    for i in range(C):
        p = ois_plan_of[i]
        key = (p.loglinear_rates,
               -(-p.swap_times.shape[0] // qb),
               -(-p.point_times.shape[0] // pb))
        groups.setdefault(key, []).append(i)
    for gk, ids in groups.items():
        plans = [ois_plan_of[i] for i in ids]
        plan = _stack_ois_plans(plans)
        P1 = plan.point_times.shape[1] + 1      # incl. t=0 node
        pad_mask = np.zeros((len(ids), P1), dtype=bool)
        for g, p in enumerate(plans):
            pad_mask[g, 1 + p.point_times.shape[0]:] = True
        key = f"ois_{len(stages)}"
        sent = np.tile(_sent(0, P1), (len(ids), 1))
        ts_full = np.concatenate(
            [np.zeros((len(ids), 1)), plan.point_times], axis=1)
        ts_static = np.where(pad_mask, sent, ts_full)
        bat[key] = dict(
            plan=plan,
            qidx=np.stack([_qidx(specs[i], plan.swap_times.shape[1])
                           for i in ids]),
            pad_mask=pad_mask,
            sent=sent,
            ts_static=ts_static,
            row_plan=_row_plan(unique_times, ts_static,
                               [specs[i].interp_type for i in ids]))
        stages.append(_Stage(kind="ois", ids=list(ids), key=key))

    interp_of = [s.interp_type for s in specs]
    bat["gplan"] = _grid_plans(unique_times, stages, bat, interp_of)
    return make_grids(stages, interp_of), bat, stages


def _stack_static_ts(ids, ts_static_of) -> np.ndarray:
    L = max(ts_static_of[i].shape[0] for i in ids)
    return np.stack([
        np.concatenate([ts_static_of[i],
                        _sent(ts_static_of[i].shape[0],
                              L - ts_static_of[i].shape[0])])
        for i in ids])


def _by_scheme(interp_of: Sequence[InterpTypes]) -> Dict[InterpTypes,
                                                         List[int]]:
    out: Dict[InterpTypes, List[int]] = {}
    for i, it in enumerate(interp_of):
        out.setdefault(it, []).append(i)
    return out


def _grid_plans(unique_times, stages, bat, interp_of) -> dict:
    """Static cross-stage interp plans for grids()' final assembly: one
    stacked plan per scheme over that scheme's curves (padded to a common
    grid length with sentinels), queried at every unique time."""
    ts_static_of: Dict[int, np.ndarray] = {}
    for st in stages:
        for g, cid in enumerate(st.ids):
            ts_static_of[cid] = bat[st.key]["ts_static"][g]
    gplan: Dict[str, dict] = {}
    for it, ids_ in _by_scheme(interp_of).items():
        stacked_ts = _stack_static_ts(ids_, ts_static_of)
        gplan[it.name] = _stack_plans([
            simple_interp_plan(unique_times, stacked_ts[g], it)
            for g in range(len(ids_))])
    return gplan


def bat_to_torch(bat: dict, device) -> dict:
    """The device form of ``bat`` that grids() reads: stage plans, quote
    indices, pad masks and the grid plans as tensors on ``device``."""
    out = {}
    for key, b in bat.items():
        if key == "gplan":
            out[key] = {name: plan_to_torch(p, device)
                        for name, p in b.items()}
            continue
        out[key] = dict(
            plan=ois_plan_to_torch(b["plan"], device),
            qidx=torch.as_tensor(np.asarray(b["qidx"], dtype=np.int64),
                                 device=device),
            pad_mask=torch.as_tensor(np.asarray(b["pad_mask"], dtype=bool),
                                     device=device))
    return out


def make_grids(stages: Sequence[_Stage], interp_of: Sequence[InterpTypes]):
    """The pure fn (qvec, P) -> dense flat DF vector [C*U] (curve-major)
    over the stages, or the compacted [n_grid] selection when
    P["grid_sel"] is set. P["bat"] is :func:`bat_to_torch` output."""
    for st in stages:
        if st.kind != "ois":
            raise LibError(f"not yet ported: {st.kind} curve stage")
    C = len(interp_of)
    schemes = list(_by_scheme(interp_of).items())

    def grids(qvec: torch.Tensor, P: dict) -> torch.Tensor:
        B = P["bat"]
        native: Dict[int, torch.Tensor] = {}
        for st in stages:
            b = B[st.key]
            rates = qvec[b["qidx"]]                       # [G, Q]
            _, ds = bootstrap_ois(rates, b["plan"])
            # pad positions read df 1 at their sentinel times, so
            # interpolation clamps at the last REAL knot (to ~1e-28)
            ds = torch.where(b["pad_mask"], 1.0, ds)
            for g, cid in enumerate(st.ids):
                native[cid] = ds[g]

        rows: Dict[int, torch.Tensor] = {}
        for it, ids in schemes:
            L = max(native[i].shape[-1] for i in ids)
            ds = torch.stack([
                torch.cat([native[i], torch.ones(
                    native[i].shape[:-1] + (L - native[i].shape[-1],),
                    dtype=native[i].dtype, device=native[i].device)],
                    dim=-1) for i in ids])
            out = simple_df_static(B["gplan"][it.name], ds, it)
            for g, cid in enumerate(ids):
                rows[cid] = out[g]
        flat = torch.cat([rows[i] for i in range(C)])
        sel = P.get("grid_sel")
        return flat if sel is None else flat[sel]

    return grids
