"""Batched curve-graph construction: one batched bootstrap per GROUP of
same-topology curves instead of one subgraph per curve.

Port of the OIS, XCCY and inflation stages of
``adrates_tpu/parallel/curve_batching.py``. The host side (plan stacking,
sentinel padding, static interpolation plans) is the same numpy code; the
stage-native forwards and the ``grids(qvec, P)`` closure are torch and run
each stage's curves as one [G, ...] bootstrap (``bootstrap_ois`` and
``bootstrap_xccy`` take stacked plans directly; the inflation stage is the
closed-form factor grid (1+r)^T with the t=0 node).

Padding semantics (all static, built once in numpy):

- Within a group, plans pad to the max point/pillar counts. Padded
  bootstrap rows are EXACT no-ops (acc=0, no prev link -> pv01=0, df=1;
  zero-weight chain points for XCCY).
- Padded grid POSITIONS are pushed to ascending sentinel times
  t_i = 1e30 + i*1e24 with df 1.0. Interpolating any real query t against
  such a grid reproduces the unpadded clamp extrapolation to ~1e-28
  relative (the pad knot is 1e30 away), for every simple scheme. The
  sentinels live in the f64 plans: never cast a plan to f32.
- A member on a fitted scheme (PCHIP, cubic spline) is fitted on its REAL
  knots only: the pad positions, trailing and known from ``pad_mask``,
  are sliced off before the fit, since a pad interval 1e30 long changes
  the fitted tail (and, for PCHIP, the last knot's slope). The JAX
  package fits such a member on its padded grid, so its batched grids
  depart from its own unbatched ones there; the port's equal the
  unbatched ones and each curve's own ``df_t``.

Every interpolation here goes through a static plan (the query times and
the grid times are both fixed at compile time), including the XCCY
calibration legs (``legs_plan``) and the bootstrap's foreign-curve
queries (``fboot_plan``). Same-simple-scheme members of a stage batch
through one stacked plan; a fitted member has a host plan of its own
(``ops/interpolation.fitted_interp_plan``: its knots, the queries and
their brackets), and the device form stacks a stage's fitted members,
whatever their schemes, into one ``ops/fitted_rows.FittedPlan``,
evaluated in one ``ops/fitted_rows`` call (one K6 launch an AD
evaluation).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..ops.bootstrap import OISBootstrapPlan, bootstrap_ois
from ..ops.bootstrap import plan_to_torch as ois_plan_to_torch
from ..ops.fitted_rows import fitted_eval, fitted_plan
from ..ops.interpolation import (fitted_interp_plan, plan_to_torch,
                                 simple_df_static, simple_interp_plan)
from ..ops.pricers import FloatLegTensor, leg_to_torch, pv_float_leg
from ..ops.xccy_bootstrap import XccyBootstrapPlan, bootstrap_xccy
from ..ops.xccy_bootstrap import plan_to_torch as xccy_plan_to_torch
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


def _pad_tail_value(a, n):
    """Pad with the last real value (clamp-safe for interp queries)."""
    a = np.asarray(a, dtype=np.float64)
    out = np.full(n, a[-1] if a.shape[0] else 0.0, dtype=np.float64)
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
    kc = max(p.child_idx.shape[1] for p in plans)
    child_idx = np.zeros((len(plans), P, kc), dtype=np.int64)
    child_mask = np.zeros((len(plans), P, kc))
    for g, p in enumerate(plans):
        n, k = p.child_idx.shape
        child_idx[g, :n, :k] = p.child_idx
        child_mask[g, :n, :k] = p.child_mask
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
        rate_c=f("rate_c", 0.0), child_idx=child_idx, child_mask=child_mask)


def _stack_xccy_plans(plans: Sequence[XccyBootstrapPlan]
                      ) -> XccyBootstrapPlan:
    """Stack same-pillar-count XCCY plans: padded chain points carry
    zero cashflow/zero dt (the telescoped chain and the [S, S+1] weight
    matrix are unchanged), padded unique_sel entries duplicate the last
    node and are sentinelized downstream."""
    n = max(p.times.shape[0] for p in plans)
    U = max(p.unique_sel.shape[0] for p in plans)
    S = plans[0].mat_pos.shape[0]

    def f(field, pad, width=n):
        return np.stack([_pad1(getattr(p, field), width, pad)
                         for p in plans])

    def ftail(field):
        return np.stack([_pad_tail_value(getattr(p, field), n)
                         for p in plans])

    sw_oh = np.zeros((len(plans), S, n))
    seg_oh = np.zeros((len(plans), S + 1, n))
    for g, p in enumerate(plans):
        sw_oh[g, :, :p.swap_onehot.shape[1]] = p.swap_onehot
        seg_oh[g, :, :p.seg_onehot.shape[1]] = p.seg_onehot
    uniq = np.stack([
        _pad1(p.unique_sel, U, p.unique_sel[-1]) for p in plans])
    return XccyBootstrapPlan(
        times=ftail("times"),
        pay_t_foreign=ftail("pay_t_foreign"),
        start_t=ftail("start_t"),
        end_t=ftail("end_t"),
        notionals=f("notionals", 0.0),
        spread_sens=f("spread_sens", 0.0),
        alpha_ratio=f("alpha_ratio", 1.0),
        dt_chain=f("dt_chain", 0.0),
        is_mat=f("is_mat", False),
        is_notl=f("is_notl", True),
        is_last=f("is_last", False),
        swap_of=f("swap_of", 0),
        seg_of=f("seg_of", 0),
        mat_pos=np.stack([p.mat_pos for p in plans]),
        swap_onehot=sw_oh,
        seg_onehot=seg_oh,
        v0=np.stack([p.v0 for p in plans]),
        unique_sel=uniq,
        foreign_sign=plans[0].foreign_sign)


def _stack_legs(tensors: Sequence[FloatLegTensor]) -> FloatLegTensor:
    """Stack per-curve [S, P_i] calibration-leg stacks to [G, S, Pmax]
    (padded slots settled: payment time -1, index alpha 0)."""
    P = max(t.payment_times.shape[1] for t in tensors)

    def pad2(a, fill):
        a = np.asarray(a)
        out = np.full((a.shape[0], P), fill, dtype=np.float64)
        out[:, :a.shape[1]] = a
        return out

    def stack(name, fill=0.0):
        return np.stack([pad2(getattr(t, name), fill) for t in tensors])

    def scal(name):
        return np.stack([np.asarray(getattr(t, name), dtype=np.float64)
                         for t in tensors])

    first = tensors[0]
    if not all(t.override_first == first.override_first and
               t.notional_exchange == first.notional_exchange and
               t.has_cap_floor == first.has_cap_floor for t in tensors):
        raise LibError("stacked calibration legs disagree on their static "
                       "switches")
    return FloatLegTensor(
        payment_times=stack("payment_times", -1.0),
        start_times=stack("start_times", 0.0),
        end_times=stack("end_times", 0.0),
        pay_alphas=stack("pay_alphas", 0.0),
        index_alphas=stack("index_alphas", 0.0),
        spreads=stack("spreads", 0.0),
        notionals=stack("notionals", 0.0),
        principal=scal("principal"),
        leg_sign=scal("leg_sign"),
        value_time=scal("value_time"),
        first_fixing_rate=scal("first_fixing_rate"),
        notional_exchange_amount=scal("notional_exchange_amount"),
        effective_time=scal("effective_time"),
        maturity_time=scal("maturity_time"),
        cap_rate=scal("cap_rate"),
        floor_rate=scal("floor_rate"),
        override_first=first.override_first,
        notional_exchange=first.notional_exchange,
        has_cap_floor=first.has_cap_floor)


def _real_ts(ts_row: np.ndarray, pad_row: np.ndarray) -> np.ndarray:
    """A member's real knot times: its stage row without the pad
    positions, which are trailing."""
    n = int((~pad_row).sum())
    if pad_row[:n].any():
        raise LibError("stage pad positions are not trailing")
    return ts_row[:n]


def _qidx(spec, n: int) -> np.ndarray:
    """Global quote indices for a curve, padded with the LAST real index
    (pad rates repeat the last pillar — monotone under log-interp)."""
    idx = np.arange(spec.offset, spec.offset + spec.n_quotes,
                    dtype=np.int32)
    return _pad1(idx, n, idx[-1])


@dataclasses.dataclass
class _Stage:
    """Static description of one batched stage (arrays live in params)."""
    kind: str                    # 'ois' | 'xccy' | 'infl'
    ids: List[int]               # curve ids in stack order
    key: str                     # params["bat"] entry name
    # xccy only:
    dom_ids: List[int] = None
    for_ids: List[int] = None
    dom_interp: InterpTypes = None
    foreign_interp: InterpTypes = None
    recal: bool = True


@dataclasses.dataclass
class StageTopology:
    """The static stage topology of a basket's batched curve graph, as
    the structured risk pass reads it: the stages, the curve specs
    (``offset``, ``n_quotes``, ``interp_type``), the host stage plans
    (shapes only) and the layout of the book's grid axis. ``grid_dense``
    means every (curve, time) pair is a column; otherwise curve c's
    columns are ``grid_offsets[c]:grid_offsets[c+1]`` at unique-time
    indices ``grid_keep_of[c]``, and ``grid_inv`` maps the dense [C*U]
    axis onto the compact one (n_grid for an unreferenced pair)."""
    stages: List[_Stage]
    specs: list
    bat: dict
    n_quotes: int
    unique_times: np.ndarray
    grid_dense: bool
    grid_keep_of: Optional[List[np.ndarray]] = None
    grid_offsets: Optional[np.ndarray] = None
    grid_inv: Optional[np.ndarray] = None


# ---------------------------------------------------------------------------
# Stage-native forwards (shared by grids() and the structured risk pass,
# which differentiates each stage separately with a per-stage tangent
# basis, so these are standalone pure functions of the device form of
# bat[key] — see bat_to_torch)
# ---------------------------------------------------------------------------


def ois_native_ds(rates: torch.Tensor, b: dict) -> torch.Tensor:
    """[G, Qp] padded local rates -> sentinelized native dfs [G, P1]."""
    _, ds = bootstrap_ois(rates, b["plan"])
    return torch.where(b["pad_mask"], 1.0, ds)


def infl_native_ds(q: torch.Tensor, b: dict) -> torch.Tensor:
    """[G, Qp] breakevens -> sentinelized factor grid [G, Qp+1]
    (``adrates_tpu/parallel/curve_batching.py:257-262``)."""
    stt = b["swap_times"]
    one = torch.ones(q.shape[:-1] + (1,), dtype=q.dtype, device=q.device)
    ds = torch.cat([one, torch.pow(1.0 + q, stt)], dim=-1)
    return torch.where(b["pad_mask"], 1.0, ds)


def xccy_legs_pv(dom_ds: torch.Tensor, b: dict, st: _Stage) -> torch.Tensor:
    """Calibration domestic-leg PVs [G, S] from the stacked dom grids
    [G, Ld] — the ONLY channel through which the domestic curve reaches
    the XCCY bootstrap (an S-value bottleneck the structured risk pass
    exploits: dom-quote directions compose through these S values
    instead of re-differentiating the whole stage)."""
    lp = b["legs_plan"]
    if "both" in lp:
        # a fitted dom scheme: member g's plan fits dom_ds[g] once for
        # all S legs' index and discount queries
        return pv_float_leg(dom_ds, st.dom_interp, b["legs"], lp)
    S = b["legs"]["leg_sign"].shape[-1]
    dds = dom_ds.unsqueeze(-2).expand(dom_ds.shape[:-1] + (S,)
                                      + dom_ds.shape[-1:])
    return pv_float_leg(dds, st.dom_interp, b["legs"], lp)


def xccy_boot_ds(spreads: torch.Tensor, pv_dom: torch.Tensor,
                 for_ds: torch.Tensor, b: dict, st: _Stage) -> torch.Tensor:
    """[G, S] spreads + dom-leg PVs + stacked foreign grids [G, Lf] ->
    sentinelized native dfs [G, U1]."""
    _, ds = bootstrap_xccy(spreads, pv_dom, for_ds, b["spot_fx"], b["plan"],
                           st.foreign_interp, b["fboot_plan"])
    return torch.where(b["pad_mask"], 1.0, ds)


def xccy_native_ds(spreads: torch.Tensor, dom_ds: torch.Tensor,
                   for_ds: torch.Tensor, b: dict, st: _Stage
                   ) -> torch.Tensor:
    """[G, S] spreads + stacked parent native dfs -> sentinelized native
    dfs [G, U1]. Without recalibration the parents enter as values only:
    the dom-leg PVs are the build-time constants and the foreign grid is
    detached."""
    if st.recal:
        pv_dom = xccy_legs_pv(dom_ds, b, st)
    else:
        pv_dom = b["pv_dom0"]
        for_ds = for_ds.detach()
    return xccy_boot_ds(spreads, pv_dom, for_ds, b, st)


def stage_rows(ds: torch.Tensor, its: Sequence[InterpTypes],
               plan: dict) -> torch.Tensor:
    """Interpolate a stage's [G, P1] native grids at the stage's static
    query times: [G, W]. Same-simple-scheme members batch through one
    static plan; the fitted members, each fitted on its real knots,
    through one ``ops/fitted_rows`` call (``plan`` is the torch form of a
    stage's ``row_plan`` or ``row_plan_keep``; ``plan["fit"]`` is the
    fitted members' positions and their stacked tables)."""
    fit = plan.get("fit")
    by_scheme: Dict[InterpTypes, List[int]] = {}
    for m, it in enumerate(its):
        if it in _SIMPLE:
            by_scheme.setdefault(it, []).append(m)
    if fit is None and len(by_scheme) == 1:
        (it, _), = by_scheme.items()
        return simple_df_static(plan[it.name], ds, it)
    rows: List = [None] * ds.shape[0]
    for it, mids in by_scheme.items():
        out = simple_df_static(plan[it.name], ds[mids], it)
        for k, m in enumerate(mids):
            rows[m] = out[k]
    if fit is not None:
        mids, tab = fit
        tab.check(its[m] for m in mids)
        if not by_scheme:
            return fitted_eval(tab, ds)
        out = fitted_eval(tab, ds[list(mids)])
        for k, m in enumerate(mids):
            rows[m] = out[k]
    return torch.stack(rows)


def _stack_plans(plans: Sequence[dict]) -> dict:
    """Stack per-member simple_interp_plan dicts along a leading axis."""
    return {k: np.stack([p[k] for p in plans]) for k in plans[0]}


def _row_plan(ut: np.ndarray, ts_static: np.ndarray, pad_mask: np.ndarray,
              its: Sequence[InterpTypes]) -> dict:
    """Static plans for stage_rows at the shared query times: per simple
    scheme one stacked plan, keyed by scheme name in the member grouping
    stage_rows derives from ``its``; under "fit", each fitted member's own
    plan on its real knots."""
    return _member_plans([ut] * len(its), ts_static, pad_mask, its)


def _member_plans(qs, ts_static, pad_mask, its) -> dict:
    """Member m's queries ``qs[m]`` on its stage row: stacked simple plans
    by scheme (on the sentinel-padded rows) and the fitted members' plans
    (on their real knots) under "fit"."""
    by_scheme: Dict[InterpTypes, List[int]] = {}
    plan: Dict = {}
    fit = {}
    for m, it in enumerate(its):
        if it in _SIMPLE:
            by_scheme.setdefault(it, []).append(m)
        else:
            fit[m] = fitted_interp_plan(
                qs[m], _real_ts(ts_static[m], pad_mask[m]), it)
    for it, mids in by_scheme.items():
        plan[it.name] = _stack_plans(
            [simple_interp_plan(qs[m], ts_static[m], it) for m in mids])
    if fit:
        plan["fit"] = fit
    return plan


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
    # one merged group forces every member to the max quote/point count,
    # and the structured risk pass pays one tangent direction per PADDED
    # quote slot.
    ois_ids = [i for i, s in enumerate(specs) if s.kind == "ois"]
    ois_plan_of = {i: basket.params["ois_plans"][k]
                   for k, i in enumerate(ois_ids)}
    groups: Dict[tuple, List[int]] = {}
    for i in ois_ids:
        p = ois_plan_of[i]
        key = (p.loglinear_rates,
               -(-p.swap_times.shape[0] // qb),
               -(-p.point_times.shape[0] // pb))
        groups.setdefault(key, []).append(i)
    for ids in groups.values():
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
            row_plan=_row_plan(unique_times, ts_static, pad_mask,
                               [specs[i].interp_type for i in ids]))
        stages.append(_Stage(kind="ois", ids=list(ids), key=key))

    # ---- group XCCY curves ------------------------------------------
    xccy_ids = [i for i, s in enumerate(specs) if s.kind == "xccy"]
    xp_of = {i: basket.params["xccy"][k] for k, i in enumerate(xccy_ids)}
    xgroups: Dict[tuple, List[int]] = {}
    for i in xccy_ids:
        s = specs[i]
        legs = xp_of[i]["dom_legs"]
        xk = (s.foreign_interp_type, specs[s.dom_id].interp_type,
              xp_of[i]["plan"].foreign_sign, s.n_quotes,
              legs.override_first, legs.notional_exchange,
              legs.has_cap_floor, basket.recalibrate_xccy)
        xgroups.setdefault(xk, []).append(i)
    for xk, ids in xgroups.items():
        plans = [xp_of[i]["plan"] for i in ids]
        plan = _stack_xccy_plans(plans)
        U1 = plan.unique_sel.shape[1] + 1       # incl. t=0 node
        pad_mask = np.zeros((len(ids), U1), dtype=bool)
        for g, p in enumerate(plans):
            pad_mask[g, 1 + p.unique_sel.shape[0]:] = True
        key = f"xccy_{len(stages)}"
        sent = np.tile(_sent(0, U1), (len(ids), 1))
        ts_full = np.stack([
            np.concatenate([[0.0], plan.times[g][plan.unique_sel[g]]])
            for g in range(len(ids))])
        ts_static = np.where(pad_mask, sent, ts_full)
        bat[key] = dict(
            plan=plan,
            legs=_stack_legs([xp_of[i]["dom_legs"] for i in ids]),
            spot_fx=np.array([xp_of[i]["spot_fx"] for i in ids]),
            pv_dom0=np.stack([xp_of[i]["pv_dom0"] for i in ids]),
            qidx=np.stack([_qidx(specs[i], specs[i].n_quotes)
                           for i in ids]),
            pad_mask=pad_mask,
            sent=sent,
            ts_static=ts_static,
            row_plan=_row_plan(unique_times, ts_static, pad_mask,
                               [specs[i].interp_type for i in ids]))
        stages.append(_Stage(
            kind="xccy", ids=list(ids), key=key,
            dom_ids=[specs[i].dom_id for i in ids],
            for_ids=[specs[i].for_id for i in ids],
            dom_interp=xk[1], foreign_interp=xk[0],
            recal=basket.recalibrate_xccy))

    # ---- inflation curves (closed form, one group) -------------------
    infl_ids = [i for i, s in enumerate(specs) if s.kind == "infl"]
    if infl_ids:
        st_of = {i: np.asarray(basket.params["infl"][k]["swap_times"],
                               dtype=np.float64)
                 for k, i in enumerate(infl_ids)}
        Q = max(st_of[i].shape[0] for i in infl_ids)
        pad_mask = np.zeros((len(infl_ids), Q + 1), dtype=bool)
        sts = []
        for g, i in enumerate(infl_ids):
            st = st_of[i]
            pad_mask[g, 1 + st.shape[0]:] = True
            sts.append(np.concatenate(
                [st, st[-1] + 1.0 + np.arange(Q - st.shape[0])]))
        sent = np.tile(_sent(0, Q + 1), (len(infl_ids), 1))
        ts_full = np.concatenate(
            [np.zeros((len(infl_ids), 1)), np.stack(sts)], axis=1)
        ts_static = np.where(pad_mask, sent, ts_full)
        bat["infl"] = dict(
            swap_times=np.stack(sts),
            qidx=np.stack([_qidx(specs[i], Q) for i in infl_ids]),
            pad_mask=pad_mask,
            sent=sent,
            ts_static=ts_static,
            row_plan=_row_plan(unique_times, ts_static, pad_mask,
                               [specs[i].interp_type for i in infl_ids]))
        stages.append(_Stage(kind="infl", ids=list(infl_ids), key="infl"))

    # ---- static parent time grids for the XCCY stages (the structured
    # risk pass feeds parent native dfs as explicit stage inputs) -------
    ts_static_of: Dict[int, np.ndarray] = {}
    real_ts_of: Dict[int, np.ndarray] = {}
    for st in stages:
        b = bat[st.key]
        for g, cid in enumerate(st.ids):
            ts_static_of[cid] = b["ts_static"][g]
            real_ts_of[cid] = _real_ts(b["ts_static"][g], b["pad_mask"][g])

    for st in stages:
        if st.kind != "xccy":
            continue
        b = bat[st.key]
        b["dom_ts"] = _stack_static_ts(st.dom_ids, ts_static_of)
        b["for_ts"] = _stack_static_ts(st.for_ids, ts_static_of)
        # static foreign-curve interp plan for the bootstrap's cashflow
        # queries (query times AND the stacked parent grids are static):
        # one stacked plan on the sentinel-padded parent rows for a simple
        # foreign scheme, else each member's plan on its parent's real
        # knots
        xp = b["plan"]
        fq = [np.concatenate([xp.start_t[g], xp.end_t[g],
                              xp.pay_t_foreign[g]])
              for g in range(len(st.ids))]
        if st.foreign_interp in _SIMPLE:
            b["fboot_plan"] = _stack_plans([
                simple_interp_plan(fq[g], b["for_ts"][g], st.foreign_interp)
                for g in range(len(st.ids))])
        else:
            b["fboot_plan"] = [
                fitted_interp_plan(fq[g], real_ts_of[st.for_ids[g]],
                                   st.foreign_interp)
                for g in range(len(st.ids))]
        # static interp plans for the calibration domestic legs
        # (pv_float_leg's two queries, same query order): per member a
        # stack over its S legs (simple), or one plan of [S, Q] queries
        # on the dom parent's real knots (fitted)
        legs = b["legs"]
        dts = b["dom_ts"]
        idx_p, disc_p = [], []
        for g in range(len(st.ids)):
            idx_q, disc_q = [], []
            for s in range(legs.payment_times.shape[1]):
                idx_q.append(np.concatenate([legs.start_times[g, s],
                                             legs.end_times[g, s]]))
                extra = [np.atleast_1d(legs.value_time[g, s])]
                if legs.notional_exchange:
                    extra.append(np.atleast_1d(legs.effective_time[g, s]))
                    extra.append(np.atleast_1d(legs.maturity_time[g, s]))
                disc_q.append(np.concatenate([legs.payment_times[g, s]]
                                             + extra))
            if st.dom_interp in _SIMPLE:
                idx_p.append(_stack_plans([simple_interp_plan(
                    q, dts[g], st.dom_interp) for q in idx_q]))
                disc_p.append(_stack_plans([simple_interp_plan(
                    q, dts[g], st.dom_interp) for q in disc_q]))
            else:
                knots = real_ts_of[st.dom_ids[g]]
                idx_p.append(fitted_interp_plan(np.stack(idx_q), knots,
                                                st.dom_interp))
                disc_p.append(fitted_interp_plan(np.stack(disc_q), knots,
                                                 st.dom_interp))
        if st.dom_interp in _SIMPLE:
            b["legs_plan"] = dict(idx=_stack_plans(idx_p),
                                  disc=_stack_plans(disc_p))
        else:
            b["legs_plan"] = dict(idx=idx_p, disc=disc_p)

    interp_of = [s.interp_type for s in specs]
    bat["gplan"] = _grid_plans(unique_times, ts_static_of, real_ts_of,
                               interp_of)

    # ---- keep-compact row plans for the structured risk pass ---------
    # A stage's rows only matter at the times the book's index tables
    # reference ON ITS OWN curves (basket.grid_keep_of, the grid
    # compaction): plans built at those queries (padded to the stage max
    # with the t=0 node, whose rows carry zero cotangent) shrink every
    # [G, U] row and tangent intermediate of the per-stage AD.
    keep_of = getattr(basket, "grid_keep_of", None)
    if keep_of is not None and not basket.grid_dense:
        for st in stages:
            bat[st.key]["row_plan_keep"] = _keep_plan(
                unique_times, [keep_of[c] for c in st.ids],
                bat[st.key]["ts_static"], bat[st.key]["pad_mask"],
                [interp_of[c] for c in st.ids])

    return make_grids(stages, interp_of), bat, stages


def _keep_plan(unique_times, keeps, ts_static, pad_mask, its) -> dict:
    """A stage's keep-compact row plan: each member's referenced times,
    padded with unique_times[0] to the stage max, per simple scheme and
    per fitted member (each at its own queries)."""
    qlists = [unique_times[k] for k in keeps]
    Ug = max((len(q) for q in qlists), default=1) or 1
    qpad = np.stack([np.concatenate([q, np.full(Ug - len(q),
                                                unique_times[0])])
                     for q in qlists])
    plan = _member_plans(qpad, ts_static, pad_mask, its)
    plan["q"] = qpad
    return plan


def _stack_static_ts(ids, ts_static_of) -> np.ndarray:
    L = max(ts_static_of[i].shape[0] for i in ids)
    return np.stack([
        np.concatenate([ts_static_of[i],
                        _sent(ts_static_of[i].shape[0],
                              L - ts_static_of[i].shape[0])])
        for i in ids])


def _by_scheme(interp_of: Sequence[InterpTypes]) -> Dict[InterpTypes,
                                                         List[int]]:
    """The curves of each simple scheme, by scheme."""
    out: Dict[InterpTypes, List[int]] = {}
    for i, it in enumerate(interp_of):
        if it in _SIMPLE:
            out.setdefault(it, []).append(i)
    return out


def _grid_plans(unique_times, ts_static_of, real_ts_of, interp_of) -> dict:
    """Static cross-stage interp plans for grids()' final assembly,
    queried at every unique time: one stacked plan per simple scheme over
    that scheme's curves (padded to a common grid length with sentinels),
    and under "fit" each fitted curve's own plan on its real knots."""
    gplan: Dict = {}
    for it, ids_ in _by_scheme(interp_of).items():
        stacked_ts = _stack_static_ts(ids_, ts_static_of)
        gplan[it.name] = _stack_plans([
            simple_interp_plan(unique_times, stacked_ts[g], it)
            for g in range(len(ids_))])
    fit = {cid: fitted_interp_plan(unique_times, real_ts_of[cid], it)
           for cid, it in enumerate(interp_of) if it not in _SIMPLE}
    if fit:
        gplan["fit"] = fit
    return gplan


def _plans_to_torch(plans: dict, device) -> dict:
    """{scheme name: numpy plan, "fit": {member: numpy plan}, "q": array}
    -> the same on ``device``, with "fit" as (the fitted members in
    ascending order, their stacked ``FittedPlan``)."""
    out = {}
    for k, v in plans.items():
        if k == "fit":
            mids = tuple(sorted(v))
            out[k] = (mids, fitted_plan([v[m] for m in mids], device))
        elif isinstance(v, dict):
            out[k] = plan_to_torch(v, device)
        else:
            out[k] = torch.as_tensor(np.asarray(v, dtype=np.float64),
                                     device=device)
    return out


def _legs_plan_to_torch(lp: dict, device) -> dict:
    """The calibration legs' plans on ``device``. On a fitted dom scheme
    the index and the discount queries are one curve's, so each member's
    two plans become one (``both``: the index queries, then the discount
    ones, ``n_idx`` of the first), evaluated by one ``ops/fitted_rows``
    call."""
    if not isinstance(lp["idx"], list):
        return {k: plan_to_torch(v, device) for k, v in lp.items()}
    both = []
    for pi, pd in zip(lp["idx"], lp["disc"]):
        if not np.array_equal(pi["x"], pd["x"]):
            raise LibError("calibration-leg plans on different knots")
        both.append(dict(pi, q=np.concatenate([pi["q"], pd["q"]], -1),
                         idx=np.concatenate([pi["idx"], pd["idx"]], -1)))
    return dict(both=fitted_plan(both, device),
                n_idx=int(np.asarray(lp["idx"][0]["q"]).shape[-1]))


def bat_to_torch(bat: dict, device) -> dict:
    """The device form of ``bat`` that grids() and the structured risk
    pass read: stage plans, quote indices, pad masks, row plans, XCCY
    legs and static plans, and the grid plans as tensors on ``device``."""
    def i64(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)

    def f64(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64),
                               device=device)

    out = {}
    for key, b in bat.items():
        if key == "gplan":
            out[key] = _plans_to_torch(b, device)
            continue
        d = dict(qidx=i64(b["qidx"]),
                 pad_mask=torch.as_tensor(np.asarray(b["pad_mask"],
                                                     dtype=bool),
                                          device=device),
                 row_plan=_plans_to_torch(b["row_plan"], device))
        if "row_plan_keep" in b:
            d["row_plan_keep"] = _plans_to_torch(b["row_plan_keep"], device)
        if "swap_times" in b:                       # inflation stage
            d["swap_times"] = f64(b["swap_times"])
        elif isinstance(b["plan"], XccyBootstrapPlan):
            d.update(plan=xccy_plan_to_torch(b["plan"], device),
                     legs=leg_to_torch(b["legs"], device),
                     spot_fx=f64(b["spot_fx"]), pv_dom0=f64(b["pv_dom0"]),
                     fboot_plan=plan_to_torch(b["fboot_plan"], device),
                     legs_plan=_legs_plan_to_torch(b["legs_plan"], device))
        else:
            d["plan"] = ois_plan_to_torch(b["plan"], device)
        out[key] = d
    return out


def make_grids(stages: Sequence[_Stage], interp_of: Sequence[InterpTypes]):
    """The pure fn (qvec, P) -> dense flat DF vector [C*U] (curve-major)
    over the stages, or the compacted [n_grid] selection when
    P["grid_sel"] is set. P["bat"] is :func:`bat_to_torch` output."""
    C = len(interp_of)
    schemes = list(_by_scheme(interp_of).items())
    fitted = any(it not in _SIMPLE for it in interp_of)

    def _stack_native(native, ids):
        """Stack per-curve native dfs to a common padded length (pad
        positions read df 1 at their sentinel times)."""
        L = max(native[i].shape[-1] for i in ids)
        return torch.stack([
            torch.cat([native[i], torch.ones(
                native[i].shape[:-1] + (L - native[i].shape[-1],),
                dtype=native[i].dtype, device=native[i].device)], dim=-1)
            for i in ids])

    def grids(qvec: torch.Tensor, P: dict) -> torch.Tensor:
        B = P["bat"]
        native: Dict[int, torch.Tensor] = {}
        for st in stages:
            b = B[st.key]
            if st.kind == "ois":
                ds = ois_native_ds(qvec[b["qidx"]], b)
            elif st.kind == "infl":
                ds = infl_native_ds(qvec[b["qidx"]], b)
            else:
                ds = xccy_native_ds(qvec[b["qidx"]],
                                    _stack_native(native, st.dom_ids),
                                    _stack_native(native, st.for_ids),
                                    b, st)
            for g, cid in enumerate(st.ids):
                native[cid] = ds[g]

        rows: Dict[int, torch.Tensor] = {}
        for it, ids in schemes:
            out = simple_df_static(B["gplan"][it.name],
                                   _stack_native(native, ids), it)
            for g, cid in enumerate(ids):
                rows[cid] = out[g]
        if fitted:
            cids, tab = B["gplan"]["fit"]
            out = fitted_eval(tab, _stack_native(native, cids))
            for g, cid in enumerate(cids):
                rows[cid] = out[g]
        flat = torch.cat([rows[i] for i in range(C)])
        sel = P.get("grid_sel")
        return flat if sel is None else flat[sel]

    return grids
