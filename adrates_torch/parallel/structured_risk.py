"""Structured scenario risk: per-stage differentiation of the curve graph.

Port of ``adrates_tpu/parallel/structured_risk.py`` (``_build_meta``,
``make_structured_parts``, ``make_structured_risk``). The generic split
(multibook._scenario_risk) pushes N (= every quote on every curve)
tangents through the WHOLE curve graph twice per scenario. But the
quotes->curves dependency is BLOCK SPARSE: an OIS or inflation curve
depends only on its own pillar quotes, and an XCCY curve on its basis
spreads plus its two parent OIS curves' quotes. This module
differentiates each batched STAGE separately with a tangent basis sized
to the stage's parent set and composes by the chain rule:

- J rows, OIS/inflation stage: Qp tangent seeds (one per LOCAL quote
  slot). One seed carries the same unit direction for EVERY group member
  at once — members never interact inside a stage, so the [Qp] basis
  recovers all G members' jacobians in one sweep.
- J rows, XCCY stage: D = S + Qp_dom + Qp_for COMPOSED directions: basis
  units plus parent jacobian columns fed as input tangents of the small
  XCCY stage graph; the dom curve reaches the stage only through the S
  calibration-leg PVs, so dom directions compose through that bottleneck.
- term2 = sum_k g_k d2 dfs_k/dq2 by the second-order chain rule: the XCCY
  stage's hessian over its composed directions, plus a COTANGENT v on
  each parent's native dfs (``v_of``) that the parent OIS stage folds
  into its own scalar g_c . rows_c + v_c . ds_c.

Every function here takes a scenario batch: quotes [Sc, N] and returns
[Sc, ...]. Per-stage AD runs under ``torch.func.vmap`` over the
scenarios (and over the tangent seeds inside it); the static-offset block
placements (fold pads, place rows, place hessian blocks) run outside
``vmap`` on the [Sc, ...] results, as slice writes into tensors the
functions allocate. The trip quad form (term1) is the caller's K2 kernel
plus the clamp quad form.

The per-trade curve-Hessian contraction (``make_pertrade_tensors``,
``make_pertrade_curvehess``) ports ``_so_tensor`` and
``make_pertrade_curvehess`` (``adrates_tpu/parallel/structured_risk.py``
:688-1033): each stage's second-order response tensors at one quote
vector, contracted with every trade's DF-space gradient. An XCCY stage on
the per-trade kernel route (``xccy_stage.pertrade_route``) takes its
tensors split at its node DFs: the nodes' first and second derivatives
from K12 (``kernels.xccy_stage_node_hess``), the legs' from K9 / K11, and
the rows' derivatives in the nodes on the full unique-time plan in torch
(``xccy_stage.node_rows`` / ``node_quads``), so that a trade's second
derivative of its rows is (G_b RR) T, the split K10 makes for the
scenario pass with the trade's row in place of the scenario's g.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
from torch.func import grad, jvp, vjp, vmap
from torch.profiler import record_function

from ..ops import kernels
from ..ops.linear_solve import jvp_by_vjp
from ..ops.ois_stage import ois_stage_routes
from ..ops.ois_stage import stage_tables as ois_tables
from ..ops.xccy_stage import (kernel_hess, kernel_jac, lift_grid,
                               node_quads, node_row_tables, node_rows,
                               pertrade_routes, stage_routes, stage_tables)
from ..utils.error import LibError
from .curve_batching import (StageTopology, infl_native_ds, ois_native_ds,
                             stage_rows, xccy_boot_ds, xccy_legs_pv,
                             xccy_native_ds)


def _build_meta(topo: StageTopology) -> dict:
    """Static stage metadata: member positions, per-member quote
    segments, direction metadata for XCCY stages and the grid layout."""
    stages = topo.stages
    specs = topo.specs
    C = len(specs)
    N = topo.n_quotes
    U = int(np.asarray(topo.unique_times).shape[0])
    bat0 = topo.bat

    pos_of: Dict[int, tuple] = {}
    for si, st in enumerate(stages):
        for mi, cid in enumerate(st.ids):
            pos_of[cid] = (si, mi)

    its_of = [[specs[i].interp_type for i in st.ids] for st in stages]
    n_dirs_of = [int(np.asarray(bat0[st.key]["qidx"]).shape[1])
                 for st in stages]
    p1_of = [int(np.asarray(bat0[st.key]["ts_static"]).shape[1])
             for st in stages]

    xmeta: Dict[int, dict] = {}
    for si, st in enumerate(stages):
        if st.kind != "xccy":
            continue
        S = n_dirs_of[si]
        b = bat0[st.key]
        Ld = int(np.asarray(b["dom_ts"]).shape[1])
        Lf = int(np.asarray(b["for_ts"]).shape[1])
        if not st.recal:
            # parents are detached: directions = basis only
            xmeta[si] = dict(D=S, S=S, Ld=Ld, Lf=Lf, parents=None)
            continue
        parents = []
        for mi in range(len(st.ids)):
            sd, md = pos_of[st.dom_ids[mi]]
            sf, mf = pos_of[st.for_ids[mi]]
            parents.append(dict(sd=sd, md=md, qd=n_dirs_of[sd],
                                p1d=p1_of[sd], sf=sf, mf=mf,
                                qf=n_dirs_of[sf], p1f=p1_of[sf]))
        D = max(S + p["qd"] + p["qf"] for p in parents)
        xmeta[si] = dict(D=D, S=S, Ld=Ld, Lf=Lf, parents=parents,
                         Qd=max(p["qd"] for p in parents),
                         Qf=max(p["qf"] for p in parents))

    def segments(si, mi):
        """[(global_offset, n_live, dir_lo, n_dirs_with_pads)] — local
        dirs [dir_lo, dir_lo+n_dirs) map onto quote rows
        [global_offset, global_offset+n_live), rows beyond n_live being
        group-pad duplicates of the last."""
        st = stages[si]
        cid = st.ids[mi]
        segs = [(specs[cid].offset, specs[cid].n_quotes, 0, n_dirs_of[si])]
        if st.kind == "xccy" and xmeta[si]["parents"] is not None:
            p = xmeta[si]["parents"][mi]
            lo = n_dirs_of[si]
            for sp, mp in ((p["sd"], p["md"]), (p["sf"], p["mf"])):
                par_cid = stages[sp].ids[mp]
                segs.append((specs[par_cid].offset,
                             specs[par_cid].n_quotes, lo, n_dirs_of[sp]))
                lo += n_dirs_of[sp]
        return segs

    dense = topo.grid_dense
    keeprows = (not dense) and all(
        "row_plan_keep" in bat0[st.key] for st in stages)
    keep_of = None if dense else topo.grid_keep_of
    grid = dict(
        dense=dense, keeprows=keeprows,
        keep_of=keep_of,
        offsets=(np.arange(C + 1) * U if dense
                 else np.asarray(topo.grid_offsets)),
        inv=None if dense else np.asarray(topo.grid_inv),
        Uc_of=([U] * C if dense else [int(k.shape[0]) for k in keep_of]))

    return dict(stages=stages, specs=specs, C=C, N=N, U=U, bat0=bat0,
                pos_of=pos_of, its_of=its_of, xmeta=xmeta,
                n_dirs_of=n_dirs_of, p1_of=p1_of, segments=segments,
                grid=grid,
                ois_first=[si for si, st in enumerate(stages)
                           if st.kind != "xccy"],
                xccy_last=[si for si, st in enumerate(stages)
                           if st.kind == "xccy"])


def xccy_stage_tables(topo: StageTopology, device) -> dict:
    """{stage index: ``ops/xccy_stage.XccyStageTables``} on ``device``
    for every XCCY stage on the kernel route (``xccy_stage.stage_routes``),
    at the row plan and the direction counts the structured pass uses;
    built once with the book's device tables (``P["xstage"]``)."""
    meta = _build_meta(topo)
    out = {}
    for si, route in stage_routes(topo).items():
        if route != "kernels":
            continue
        st = topo.stages[si]
        b = topo.bat[st.key]
        m = meta["xmeta"][si]
        S = m["S"]
        recal = m["parents"] is not None
        out[si] = stage_tables(
            st, meta["its_of"][si], b,
            b["row_plan_keep"] if meta["grid"]["keeprows"]
            else b["row_plan"],
            2 * S + m["Qf"] if recal else S, m["Qd"] if recal else 0,
            device)
    return out


def ois_stage_tables(topo: StageTopology, B: dict, device) -> dict:
    """{stage index: ``ops/ois_stage.OisStageTables``} on ``device`` for
    every OIS stage on the K13 / K14 route (``ois_stage.ois_stage_routes``),
    at the row plan the structured pass uses, beside the stage's device
    ``bat`` entry (``B``, curve_batching.bat_to_torch's) that the plain
    versions read; built once with the book's device tables
    (``P["ostage"]``)."""
    keeprows = _build_meta(topo)["grid"]["keeprows"]
    rk = "row_plan_keep" if keeprows else "row_plan"
    out = {}
    for si, route in ois_stage_routes(topo).items():
        if route != "kernels":
            continue
        st = topo.stages[si]
        out[si] = ois_tables(st, [topo.specs[c].interp_type for c in st.ids],
                             topo.bat[st.key], topo.bat[st.key][rk],
                             B[st.key], B[st.key][rk], device)
    return out


def _span(region: str, st, b) -> str:
    """A stage pass's profiler span: region, stage kind, members and local
    quotes (``scripts/staged_ops.py`` counts ops by it)."""
    return f"{region}:{st.kind}:G={len(st.ids)}:Qp={int(b['qidx'].shape[-1])}"


def fold_pads(seg: torch.Tensor, n_live: int, dim: int) -> torch.Tensor:
    """Fold pad-duplicate slices (beyond n_live along ``dim``) into the
    last live one: a padded direction duplicates the member's last quote,
    so its derivative adds to that quote's."""
    if seg.shape[dim] <= n_live:
        return seg
    live = seg.narrow(dim, 0, n_live - 1)
    last = seg.narrow(dim, n_live - 1, 1) + seg.narrow(
        dim, n_live, seg.shape[dim] - n_live).sum(dim=dim, keepdim=True)
    return torch.cat([live, last], dim=dim)


def place_hess(H2: torch.Tensor, Hm: torch.Tensor, segs) -> None:
    """Add a member's [Sc, D, D] local hessian into H2 [Sc, N, N] at its
    segment-pair blocks (in place)."""
    for off1, n1, lo1, nd1 in segs:
        for off2, n2, lo2, nd2 in segs:
            sub = Hm[:, lo1:lo1 + nd1, lo2:lo2 + nd2]
            sub = fold_pads(fold_pads(sub, n1, 1), n2, 2)
            H2[:, off1:off1 + n1, off2:off2 + n2] += sub


def _seeds(n: int, G: int, like: torch.Tensor) -> torch.Tensor:
    """[n, G, n] unit directions: seed j moves local slot j of every
    group member at once."""
    eye = torch.eye(n, dtype=like.dtype, device=like.device)
    return eye[:, None, :].expand(n, G, n)


def _jac(f, x: torch.Tensor, seeds: torch.Tensor):
    """(f(x), [n_seeds, ...] directional derivatives of f at x): one jvp
    per seed under vmap (the primal is computed once, unbatched)."""
    out, tan = vmap(lambda s: jvp(f, (x,), (s,)))(seeds)
    if isinstance(out, tuple):
        return tuple(o[0] for o in out), tan
    return out[0], tan


def _hess(f, x: torch.Tensor, seeds: torch.Tensor) -> torch.Tensor:
    """[n_seeds, ...] hessian-vector products of the scalar f at x
    (forward over reverse)."""
    return vmap(lambda s: jvp(grad(f), (x,), (s,))[1])(seeds)


def tower_jvp(fwd, q: torch.Tensor):
    """(ds, rows, dds [Sc, n, G, P1], drows [Sc, n, G, W]) of an OIS or
    inflation stage's forward ``fwd`` (local quotes [G, n] -> (native
    DFs, rows)) at q [Sc, G, n]: :func:`_jac` along the n unit quote
    directions under vmap (the OIS stage's plain K13,
    ``ois_stage.ois_stage_jvp_plain``)."""
    seeds = _seeds(q.shape[-1], q.shape[1], q)
    (ds, rows), (dds, drows) = vmap(lambda r: _jac(fwd, r, seeds))(q)
    return ds, rows, dds, drows


def tower_hess(fwd, q: torch.Tensor, gs: torch.Tensor,
               vs: torch.Tensor) -> torch.Tensor:
    """[Sc, n, G, n]: the Hessian of psi(x) = sum(gs * rows(x)) + sum(vs *
    ds(x)) at q [Sc, G, n] for a stage's forward ``fwd``, :func:`_hess`
    along the n unit quote directions (the OIS stage's plain K14,
    ``ois_stage.ois_stage_hess_plain``)."""
    def one(r, g, v):
        def psi(x):
            ds, rows = fwd(x)
            return torch.sum(g * rows) + torch.sum(v * ds)
        return _hess(psi, r, _seeds(r.shape[-1], r.shape[0], r))
    return vmap(one)(q, gs, vs)


def make_structured_parts(topo: StageTopology) -> dict:
    """The structured risk pass as separable batched functions (the
    regions of multibook.make_staged_multibook_fn):

    - ``fwd_delta(q, P, agg, clamp_agg)`` -> dict(dfs [Sc, n_grid],
      g [Sc, n_grid], J [Sc, N, n_grid], delta [Sc, N], carry): stage
      forwards, per-stage jacobian rows, assembled J on the book's grid
      axis, the aggregate gradient and the book delta. ``carry`` holds
      the cross-boundary arrays term2 needs per XCCY stage (the stacked
      parent grids as values, the calibration-leg PVs and the composed
      direction tables), so term2 never re-differentiates the parent
      bootstraps.
    - ``term2_xccy(q, P, g, carry)`` -> (H2 [Sc, N, N], v_of): the XCCY
      stages' hessian placements and the chain cotangents
      {str(parent cid): [Sc, P1]} their parents owe.
    - ``term2_ois(q, P, g, v_of)`` -> [Sc, N, N]: the OIS stages'
      hessians with the cotangents folded into each stage scalar.
    - ``term2(q, P, g, carry)``: their sum.

    ``P`` holds ``bat`` (curve_batching.bat_to_torch of ``topo.bat``),
    ``xstage`` (:func:`xccy_stage_tables`) and ``ostage``
    (:func:`ois_stage_tables`); ``agg``/``clamp_agg`` are the device
    aggregate and clamp slots. gamma = term1 + term2.

    An OIS stage on the K13 / K14 route (``ois_stage.ois_stage_routes``:
    every member on a simple scheme) takes fwd_delta's pass 1 from K13
    ``kernels.ois_stage_jvp`` and its term2_ois Hessian from K14
    ``kernels.ois_stage_hess`` (their plain versions on CPU tensors, the
    ``torch.func`` towers below); an inflation stage and a stage with a
    fitted member keep the towers. The outputs are the same.

    An XCCY stage on the kernel route (``xccy_stage.stage_routes``)
    takes its derivatives from K8-K11 (``ops/kernels``:
    ``xccy_stage_jvp``, ``xccy_legs_jvp``, ``xccy_stage_hess``,
    ``xccy_legs_hess``; on CPU tensors their plain versions) in place of
    the ``torch.func`` towers over the stage, which the other XCCY stages
    keep; the outputs are the same, and ``carry`` holds the same entries
    (and, where a parent is on a fitted scheme, the query grids the
    kernels read of it: ``xccy_stage.kernel_jac``). ``xccy_jac`` and
    ``xccy_hess`` are a recalibrated stage's derivatives on its route.
    """
    from .multibook import aggregate_total

    meta = _build_meta(topo)
    stages = meta["stages"]
    C, N, U = meta["C"], meta["N"], meta["U"]
    pos_of = meta["pos_of"]
    its_of = meta["its_of"]
    xmeta = meta["xmeta"]
    segments = meta["segments"]
    ois_first = meta["ois_first"]
    xccy_last = meta["xccy_last"]
    grid = meta["grid"]
    keeprows = grid["keeprows"]
    Uc_of = grid["Uc_of"]
    offs = grid["offsets"]
    p1_of = meta["p1_of"]
    xroutes = stage_routes(topo)
    oroutes = ois_stage_routes(topo)

    def _otab(si, P):
        """The OIS stage's K13 / K14 tables when it takes their route, else
        None."""
        if oroutes.get(si) != "kernels":
            return None
        tab = P.get("ostage", {}).get(si)
        if tab is None:
            raise LibError(f"OIS stage {si} is on the kernel route but the "
                           f"device tables lack its OisStageTables")
        return tab

    def _xtab(si, P):
        """The stage's kernel tables when it takes the kernel route, else
        None."""
        if xroutes.get(si) != "kernels":
            return None
        tab = P.get("xstage", {}).get(si)
        if tab is None:
            raise LibError(f"XCCY stage {si} is on the kernel route but "
                           f"the device tables lack its XccyStageTables")
        return tab

    def _rp(b):
        """The stage row plan: keep-compact when available (rows only at
        each curve's referenced times), else the full-U plan."""
        return b["row_plan_keep"] if keeprows else b["row_plan"]

    def _crop(x, cid):
        """A member's stage rows [..., W] restricted to its curve's
        columns: a slice (keeprows: evaluated at keep times padded to
        the stage max), the whole row (dense), or a gather of the
        referenced times from the full-U row."""
        if keeprows:
            return x[..., :Uc_of[cid]]
        if grid["dense"]:
            return x
        idx = torch.as_tensor(grid["keep_of"][cid], dtype=torch.int64,
                              device=x.device)
        return x.index_select(-1, idx)

    def _stage_g(g0, st):
        """The aggregate cotangent [Sc, n_grid] laid out over one
        stage's row output [Sc, G, W]. keeprows: each member's compact
        segment slice-placed (pad columns carry zero — they multiply pad
        row outputs). Else: per-curve slices of the cotangent re-expanded
        to the dense [C*U] axis by a gather (unreferenced pairs read an
        appended zero)."""
        if not keeprows:
            gd = g0
            if not grid["dense"]:
                inv = torch.as_tensor(grid["inv"], dtype=torch.int64,
                                      device=g0.device)
                gd = torch.cat([g0, g0.new_zeros((g0.shape[0], 1))],
                               dim=1)[:, inv]
            return torch.stack([gd[:, cid * U:(cid + 1) * U]
                                for cid in st.ids], dim=1)
        W = int(np.asarray(topo.bat[st.key]["row_plan_keep"]["q"])
                .shape[-1])
        out = g0.new_zeros((g0.shape[0], len(st.ids), W))
        for mi, cid in enumerate(st.ids):
            out[:, mi, :Uc_of[cid]] = g0[:, offs[cid]:offs[cid + 1]]
        return out

    def _ois_fwd(b, si):
        """An OIS or inflation stage's forward: local quotes -> (native
        grids, stage rows)."""
        native = ois_native_ds if stages[si].kind == "ois" \
            else infl_native_ds

        def fwd(r):
            ds = native(r, b)
            return ds, stage_rows(ds, its_of[si], _rp(b))
        return fwd

    def _boot_fwd(b, st, si):
        def boot(sp, pv, fd):
            ds = xccy_boot_ds(sp, pv, fd, b, st)
            return ds, stage_rows(ds, its_of[si], _rp(b))
        return boot

    def _parent_stack(ds_of, ids, L):
        """[Sc, G, L] parent native grids padded with df 1."""
        return torch.stack([torch.nn.functional.pad(
            ds_of[c], (0, L - ds_of[c].shape[-1]), value=1.0)
            for c in ids], dim=1)

    def _xccy_jac(b, st, si, spreads, dom_ds, for_ds, td_legs, tf2):
        """torch.func's (ds, rows, pv0, Jpv, drows2) of a recalibrated
        XCCY stage along its composed directions."""
        G, S = spreads.shape[1:]
        D2 = tf2.shape[1]
        tb2 = spreads.new_zeros((D2, G, S))
        tb2[:S] = _seeds(S, G, spreads)
        tp2 = spreads.new_zeros((D2, G, S))
        tp2[S:2 * S] = _seeds(S, G, spreads)
        boot = _boot_fwd(b, st, si)

        def legs(dd):
            return xccy_legs_pv(dd, b, st)

        def one(sp, dd, fd, tdl, tf):
            pv0, Jpv = _jac(legs, dd, tdl)        # Jpv [Qd, G, S]
            (ds, rows), (_, drows2) = vmap(
                lambda a, c, e: jvp(boot, (sp, pv0, fd),
                                    (a, c, e)))(tb2, tp2, tf)
            return ds[0], rows[0], pv0, Jpv, drows2

        return vmap(one)(spreads, dom_ds, for_ds, td_legs, tf2)

    def fwd_delta(q, P, agg, clamp_agg):
        B = P["bat"]
        Sc = q.shape[0]
        ds_of: List = [None] * C          # cid -> [Sc, P1] native dfs
        rows_of: List = [None] * C        # cid -> [Sc, W]
        dds_st: Dict[int, torch.Tensor] = {}    # si -> [Sc, Qp, G, P1]
        drows_st: Dict[int, torch.Tensor] = {}  # si -> [Sc, Dirs, G, W]
        carry: Dict[int, dict] = {}

        # ---- pass 1: OIS + inflation stages (primal + Qp-seed jvp) ---
        for si in ois_first:
            st = stages[si]
            b = B[st.key]
            q_local = q[:, b["qidx"]]                      # [Sc, G, Qp]
            tab = _otab(si, P)
            with record_function(_span("A", st, b)):
                if tab is not None:
                    ds, rows, dds, drows = kernels.ois_stage_jvp(tab,
                                                                 q_local)
                else:
                    ds, rows, dds, drows = tower_jvp(_ois_fwd(b, si),
                                                     q_local)
            dds_st[si] = dds
            drows_st[si] = drows
            for mi, cid in enumerate(st.ids):
                ds_of[cid] = ds[:, mi]
                rows_of[cid] = rows[:, mi]

        # ---- pass 2: XCCY stages (composed parent directions) --------
        for si in xccy_last:
            st = stages[si]
            b = B[st.key]
            m = xmeta[si]
            spreads = q[:, b["qidx"]]                      # [Sc, G, S]
            G, S = spreads.shape[1:]
            dom_ds = _parent_stack(ds_of, st.dom_ids, m["Ld"])
            for_ds = _parent_stack(ds_of, st.for_ids, m["Lf"])

            tab = _xtab(si, P)
            if m["parents"] is None and tab is not None:
                fq, _ = lift_grid(tab.ffit, for_ds)
                ds, rows, drows_st[si] = kernels.xccy_stage_jvp(
                    tab, spreads, tab.pv_dom0.expand(Sc, G, S).contiguous(),
                    fq)
                carry[si] = dict(dom_ds=dom_ds, for_ds=for_ds)
                if tab.ffit is not None:
                    carry[si]["fq"] = fq
            elif m["parents"] is None:
                # parents enter as VALUES only: basis spreads are the
                # only differentiation directions
                def fwd(sp, dd, fd, b=b, st=st, si=si):
                    ds = xccy_native_ds(sp, dd, fd, b, st)
                    return ds, stage_rows(ds, its_of[si], _rp(b))

                seeds = _seeds(S, G, q)
                (ds, rows), (_, drows) = vmap(
                    lambda sp, dd, fd: _jac(
                        lambda x: fwd(x, dd, fd), sp, seeds))(
                            spreads, dom_ds, for_ds)
                drows_st[si] = drows
                carry[si] = dict(dom_ds=dom_ds, for_ds=for_ds)
            else:
                # parent jacobian columns as input tangents:
                # td_legs [Sc, Qd, G, Ld] over the dom grids and
                # tf2 [Sc, D2, G, Lf] (basis | pv | foreign) over the
                # foreign grids
                Qd, Qf = m["Qd"], m["Qf"]
                D2 = 2 * S + Qf
                td_legs = q.new_zeros((Sc, Qd, G, m["Ld"]))
                tf2 = q.new_zeros((Sc, D2, G, m["Lf"]))
                for mi, p in enumerate(m["parents"]):
                    td_legs[:, :p["qd"], mi, :p["p1d"]] = \
                        dds_st[p["sd"]][:, :, p["md"], :]
                    tf2[:, 2 * S:2 * S + p["qf"], mi, :p["p1f"]] = \
                        dds_st[p["sf"]][:, :, p["mf"], :]
                ds, rows, pv0, Jpv, drows2, grids = xccy_jac(
                    si, P, spreads, dom_ds, for_ds, td_legs, tf2)
                # compose to quote-direction space, per-member layout
                # matching segments(): [basis | dom quotes | for quotes]
                D = m["D"]
                W = drows2.shape[-1]
                drows = q.new_zeros((Sc, D, G, W))
                for mi, p in enumerate(m["parents"]):
                    qd_m, qf_m = p["qd"], p["qf"]
                    drows[:, :S, mi] = drows2[:, :S, mi]
                    drows[:, S:S + qd_m, mi] = \
                        Jpv[:, :qd_m, mi] @ drows2[:, S:2 * S, mi]
                    drows[:, S + qd_m:S + qd_m + qf_m, mi] = \
                        drows2[:, 2 * S:2 * S + qf_m, mi]
                drows_st[si] = drows
                carry[si] = dict(dom_ds=dom_ds, for_ds=for_ds, pv0=pv0,
                                 Jpv=Jpv, td_legs=td_legs, tf2=tf2,
                                 **grids)
            for mi, cid in enumerate(st.ids):
                ds_of[cid] = ds[:, mi]
                rows_of[cid] = rows[:, mi]

        # ---- aggregate gradient --------------------------------------
        dfs = torch.cat([_crop(rows_of[c], c) for c in range(C)], dim=-1)
        g = vmap(grad(lambda d: aggregate_total(d, agg, clamp_agg)))(dfs)

        # ---- J assembly (static slice placement) ---------------------
        J = q.new_zeros((Sc, N, dfs.shape[-1]))
        for cid in range(C):
            si, mi = pos_of[cid]
            d_c = _crop(drows_st[si][:, :, mi, :], cid)  # [Sc, Dirs, Uc]
            c0, c1 = int(offs[cid]), int(offs[cid]) + d_c.shape[-1]
            for off, n_live, lo, n_dirs in segments(si, mi):
                J[:, off:off + n_live, c0:c1] = fold_pads(
                    d_c[:, lo:lo + n_dirs], n_live, 1)
        delta = (J @ g.unsqueeze(-1)).squeeze(-1)
        return {"dfs": dfs, "g": g, "J": J, "delta": delta,
                "carry": carry}

    def term2_xccy(q, P, g, carry):
        """XCCY-stage hessian placements + the chain cotangents their
        parents owe: (H2_xccy [Sc, N, N], v_of {str(cid): [Sc, P1]})."""
        B = P["bat"]
        Sc = q.shape[0]
        g0 = g.detach()
        H2 = q.new_zeros((Sc, N, N))
        v_of: Dict[str, torch.Tensor] = {}

        for si in xccy_last:
            st = stages[si]
            b = B[st.key]
            m = xmeta[si]
            xs = carry[si]
            G, S = len(st.ids), m["S"]
            g_stage = _stage_g(g0, st)                      # [Sc, G, W]
            spreads = q[:, b["qidx"]]                       # [Sc, G, S]
            tab = _xtab(si, P)

            if m["parents"] is None and tab is not None:
                _, _, Hx = kernels.xccy_stage_hess(
                    tab, spreads, tab.pv_dom0.expand(Sc, G, S).contiguous(),
                    xs.get("fq", xs["for_ds"]), None, g_stage)
                for mi in range(G):
                    place_hess(H2, Hx[:, :, mi, :], segments(si, mi))
                continue
            if m["parents"] is None:
                def one_plain(sp, gs, dd, fd, b=b, st=st, si=si):
                    def s_plain(x):
                        ds = xccy_native_ds(x, dd, fd, b, st)
                        return torch.sum(
                            gs * stage_rows(ds, its_of[si], _rp(b)))
                    return _hess(s_plain, sp, _seeds(S, G, sp))

                Hx = vmap(one_plain)(spreads, g_stage, xs["dom_ds"],
                                     xs["for_ds"])          # [Sc, S, G, S]
                for mi in range(G):
                    place_hess(H2, Hx[:, :, mi, :], segments(si, mi))
                continue

            gf, gdd, Hx2, Hl = xccy_hess(si, P, spreads, g_stage, xs)
            _xccy_place(H2, v_of, st, si, m, gf, gdd, Hx2, Hl, xs["Jpv"])
        return H2, v_of

    def xccy_jac(si, P, spreads, dom_ds, for_ds, td_legs, tf2):
        """A recalibrated XCCY stage's (ds, rows, pv0, Jpv, drows2, the
        lifted grids of its fitted parents) along its composed directions:
        K8 / K9 on the kernel route (``xccy_stage.kernel_jac``), else
        torch.func (no lifted grids)."""
        tab = _xtab(si, P)
        if tab is not None:
            return kernel_jac(tab, spreads, dom_ds, for_ds, td_legs, tf2)
        st = stages[si]
        return _xccy_jac(P["bat"][st.key], st, si, spreads, dom_ds,
                         for_ds, td_legs, tf2) + ({},)

    def xccy_hess(si, P, spreads, g_stage, xs):
        """A recalibrated XCCY stage's (gf, gdd, Hx2, Hl) from its
        ``carry`` xs: K10 / K11 on the kernel route
        (``xccy_stage.kernel_hess``), else torch.func."""
        tab = _xtab(si, P)
        if tab is not None:
            return kernel_hess(tab, spreads, xs["pv0"], g_stage, xs)
        st = stages[si]
        return _xccy_hess(P["bat"][st.key], st, si, spreads, g_stage, xs,
                          xmeta[si])

    def _xccy_hess(b, st, si, spreads, g_stage, xs, m):
        """torch.func's (gf, gdd, Hx2, Hl) of a recalibrated XCCY stage."""
        G, S = spreads.shape[1:]
        Qd, Qf = m["Qd"], m["Qf"]
        D2 = 2 * S + Qf
        boot = _boot_fwd(b, st, si)

        def legs(dd):
            return xccy_legs_pv(dd, b, st)

        def one(sp0, pv0, fd0, dd0, gs, tf, tdl):
            # boot-stage hessian over (basis, pv, composed-foreign)
            # directions; fd enters as a second argument so one grad
            # gives both gZ = [gb | gpv | composed-f] and the
            # native-foreign cotangent gf
            def s_hat(Z, fd):
                fd2 = fd + torch.einsum("gd,dgl->gl", Z, tf)
                _, rows = boot(sp0 + Z[:, :S], pv0 + Z[:, S:2 * S], fd2)
                return torch.sum(gs * rows)

            Z0 = sp0.new_zeros((G, D2))
            gZ0, gf = grad(s_hat, argnums=(0, 1))(Z0, fd0)
            Hx2 = _hess(lambda Z: s_hat(Z, fd0), Z0,
                        _seeds(D2, G, sp0))             # [D2, G, D2]

            # legs-stage hessian over dom-quote directions (legs only):
            # sum_s gpv_s d2 pv_s / dq_dom2, and the legs vjp cotangent
            # gdd on the dom grids
            gpv0 = gZ0[:, S:2 * S].detach()

            def s_legs(Zd, dd):
                dd2 = dd + torch.einsum("gd,dgl->gl", Zd, tdl)
                return torch.sum(gpv0 * legs(dd2))

            Zd0 = sp0.new_zeros((G, Qd))
            gdd = grad(s_legs, argnums=1)(Zd0, dd0)
            Hl = _hess(lambda Zd: s_legs(Zd, dd0), Zd0,
                       _seeds(Qd, G, sp0))              # [Qd, G, Qd]
            return gf, gdd, Hx2, Hl

        return vmap(one)(spreads, xs["pv0"], xs["for_ds"], xs["dom_ds"],
                         g_stage, xs["tf2"], xs["td_legs"])

    def _xccy_place(H2, v_of, st, si, m, gf, gdd, Hx2, Hl, Jpv):
        """A recalibrated XCCY stage's parent cotangents into ``v_of`` and
        its boot and legs hessians, in quote space, into H2."""
        S = m["S"]
        # cotangents at the primal: gdd routes to the dom parent's
        # native grid, gf to the foreign parent directly
        for mi, p in enumerate(m["parents"]):
            for cid_par, cot, p1 in (
                    (st.dom_ids[mi], gdd, p["p1d"]),
                    (st.for_ids[mi], gf, p["p1f"])):
                key = str(cid_par)
                add = cot[:, mi, :p1]
                v_of[key] = add if key not in v_of else v_of[key] + add

        # transform the boot hessian to quote space per member
        for mi, p in enumerate(m["parents"]):
            qd_m, qf_m = p["qd"], p["qf"]
            Hb = Hx2[:, :, mi, :]                       # [Sc, D2, D2]
            Jv = Jpv[:, :qd_m, mi]                      # [Sc, qd, S]
            JvT = Jv.transpose(1, 2)
            bb = Hb[:, :S, :S]
            bp = Hb[:, :S, S:2 * S]
            bf = Hb[:, :S, 2 * S:2 * S + qf_m]
            pp = Hb[:, S:2 * S, S:2 * S]
            pf = Hb[:, S:2 * S, 2 * S:2 * S + qf_m]
            ff = Hb[:, 2 * S:2 * S + qf_m, 2 * S:2 * S + qf_m]
            q_bd = bp @ JvT                             # [Sc, S, qd]
            q_dd = Jv @ pp @ JvT + Hl[:, :qd_m, mi, :qd_m]
            q_df = Jv @ pf                              # [Sc, qd, qf]
            Hq = torch.cat([
                torch.cat([bb, q_bd, bf], dim=2),
                torch.cat([q_bd.transpose(1, 2), q_dd, q_df], dim=2),
                torch.cat([bf.transpose(1, 2), q_df.transpose(1, 2),
                           ff], dim=2)], dim=1)
            place_hess(H2, Hq, segments(si, mi))

    def term2_ois(q, P, g, v_of):
        """OIS/inflation-stage hessian placements with the XCCY chain
        cotangents (term2_xccy's v_of) folded into each stage scalar."""
        B = P["bat"]
        Sc = q.shape[0]
        g0 = g.detach()
        H2 = q.new_zeros((Sc, N, N))
        for si in ois_first:
            st = stages[si]
            b = B[st.key]
            q_local = q[:, b["qidx"]]                      # [Sc, G, Qp]
            G, Qp = q_local.shape[1:]
            g_stage = _stage_g(g0, st)
            zero = q.new_zeros((Sc, p1_of[si]))
            v_stage = torch.stack([v_of.get(str(cid), zero)
                                   for cid in st.ids], dim=1)
            tab = _otab(si, P)
            with record_function(_span("C2", st, b)):
                if tab is not None:
                    Hs = kernels.ois_stage_hess(tab, q_local, g_stage,
                                                v_stage)
                else:
                    Hs = tower_hess(_ois_fwd(b, si), q_local, g_stage,
                                    v_stage)
            for mi in range(G):                     # Hs [Sc, Qp, G, Qp]
                place_hess(H2, Hs[:, :, mi, :], segments(si, mi))
        return H2

    def term2(q, P, g, carry):
        H2x, v_of = term2_xccy(q, P, g, carry)
        return H2x + term2_ois(q, P, g, v_of)

    return dict(fwd_delta=fwd_delta, term2=term2, term2_xccy=term2_xccy,
                term2_ois=term2_ois, xccy_jac=xccy_jac, xccy_hess=xccy_hess,
                meta=meta)


def make_structured_risk(topo: StageTopology, term1):
    """The monolithic composition of :func:`make_structured_parts`:
    scenario_risk(q [Sc, N], P, agg, clamp_agg, want_gamma) ->
    {dfs, delta[, gamma]}, with ``term1(J, dfs)`` the caller's trip and
    clamp quad form."""
    parts = make_structured_parts(topo)
    fwd_delta = parts["fwd_delta"]
    term2 = parts["term2"]

    def scenario_risk(q, P, agg, clamp_agg, want_gamma):
        fw = fwd_delta(q, P, agg, clamp_agg)
        out = {"delta": fw["delta"], "dfs": fw["dfs"]}
        if want_gamma:
            out["gamma"] = term1(fw["J"], fw["dfs"]) \
                + term2(q, P, fw["g"], fw["carry"])
        return out

    return scenario_risk


# ---------------------------------------------------------------------------
# per-trade curve-Hessian contraction
# ---------------------------------------------------------------------------


def _so_fwd(f, x0: torch.Tensor, seeds: torch.Tensor,
            fitted: bool = False) -> torch.Tensor:
    """Second-order directional-derivative tensor T[i, j, ...] =
    d^2 f/(d s_i)(d s_j) at x0 (``adrates_tpu`` ``_so_tensor``): per seed
    pair under vmap, one jvp over jvp for an ``f`` with no solve and no
    fitted curve on its path; where ``fitted`` (``f`` reaches a fitted
    curve's rows, ``ops/fitted_rows``, which take one forward-mode level
    only, and raise under two), one jvp over the inner directional
    derivative taken by two reverse passes
    (``ops/linear_solve.jvp_by_vjp``). The seed bases are
    member-parallel (outputs of different group members never mix, so one
    seed carries every member's direction at once)."""
    def one(s1):
        def inner(x):
            if fitted:
                return jvp_by_vjp(f, x, s1)[1]
            return jvp(f, (x,), (s1,))[1]
        return vmap(lambda s2: jvp(inner, (x0,), (s2,))[1])(seeds)
    return vmap(one)(seeds)


def _so_tensor(native, x0: torch.Tensor, seeds: torch.Tensor, rows,
               fitted: bool = False):
    """(ds, D, H, T): ``native``'s value ds and directional derivatives D
    at x0, and the second-order tensors of :func:`_so_fwd` for ``native``
    (a stage's bootstrap, whose solve takes one forward-mode level) and
    for f = rows∘native. H is one jvp over the inner directional
    derivative taken by two reverse passes (``ops/linear_solve
    .jvp_by_vjp``) per seed pair under vmap; T follows by the chain rule,
    T[i, j] = R'(ds) H[i, j] + R''(ds)[D_i, D_j] with D_i = native' s_i,
    the second term by :func:`_so_fwd` on ``rows`` (``fitted``: they
    reach a fitted curve)."""
    def one(s1):
        def inner(x):
            return jvp_by_vjp(native, x, s1)[1]
        return vmap(lambda s2: jvp(inner, (x0,), (s2,))[1])(seeds)

    H = vmap(one)(seeds)
    ds, D = _jac(native, x0, seeds)
    first = vmap(vmap(lambda h: jvp(rows, (ds,), (h,))[1]))(H)
    return ds, D, H, first + _so_fwd(rows, ds, D, fitted)


def make_pertrade_tensors(topo: StageTopology):
    """tensors(q [N], P) -> the per-stage response tensors the per-trade
    curve-Hessian contraction reads (:func:`make_pertrade_curvehess`),
    at one quote vector, every stage's rows on its full unique-time plan
    (``row_plan``) as in the JAX package. They do not depend on the
    trades' DF gradients, so one call serves every trade batch and every
    signature group. Per OIS/inflation stage si: ``so[si] = (dsT
    [Qp, Qp, G, P1], rowsT [Qp, Qp, G, U])``; per XCCY stage off the
    per-trade kernel route: ``rowsT`` [S, S, G, U] (parents held), or
    (parents recalibrated) the legs jacobian ``Jpv`` [Qd, G, S], the legs
    vjp rows ``Jlegs_nat`` [S, G, Ld], ``drows2`` [D2, G, U] and
    ``rowsTx`` [D2, D2, G, U] over (basis | pv | composed foreign)
    directions, ``drows_fd`` [Lf, G, U] and ``legsT`` [Qd, Qd, G, S].

    An XCCY stage on the route (``xccy_stage.pertrade_route``; ``P``
    holds its ``xstage`` tables) keeps no [., ., G, U] tensor: ``RR``
    [G, U, K] (``node_rows``: the rows' derivatives in the node DFs) and
    ``T`` [G, K, D D] (``node_quads``: K12's Hn and the products of its
    Jn), so that ``rowsTx`` = RR T; ``Jn`` [D, G, U1]; and, recalibrated
    (D = D2), ``Jfd`` [Lf, G, U1] (K12), ``Jpv`` (K9), ``Jlegs_nat`` and
    ``Hl`` [S, Qd, G, Qd] (K11 with the S unit cotangents of the legs'
    PVs as its scenario axis: ``legsT`` transposed)."""
    meta = _build_meta(topo)
    stages = meta["stages"]
    its_of = meta["its_of"]
    xmeta = meta["xmeta"]
    C = meta["C"]
    routes = pertrade_routes(topo)
    # the full unique-time rows of each stage on the route, per device
    row_tabs: Dict[tuple, object] = {}

    def _rows_of(si, device):
        key = (si, str(device))
        if key not in row_tabs:
            st = stages[si]
            b = topo.bat[st.key]
            row_tabs[key] = node_row_tables(
                its_of[si], b["row_plan"],
                int(np.asarray(b["pad_mask"]).shape[-1]), device)
        return row_tabs[key]

    def _parent_tangents(m, dds_st, like):
        """(td_legs [Qd, G, Ld], tf2 [D2, G, Lf]): each member's parents'
        jacobian columns (the OIS stages' dds) as tangent rows over the
        parents' native grids, tf2's basis and PV rows zero."""
        S = m["S"]
        G = len(m["parents"])
        td_legs = like.new_zeros((m["Qd"], G, m["Ld"]))
        tf2 = like.new_zeros((2 * S + m["Qf"], G, m["Lf"]))
        for mi, p in enumerate(m["parents"]):
            td_legs[:p["qd"], mi, :p["p1d"]] = dds_st[p["sd"]][:, p["md"]]
            tf2[2 * S:2 * S + p["qf"], mi, :p["p1f"]] = \
                dds_st[p["sf"]][:, p["mf"]]
        return td_legs, tf2

    def _node_tensors(si, P, spreads, dom_ds, for_ds, dds_st):
        """The stage's tensors on K12, K9 and K11 (see above)."""
        tab = P.get("xstage", {}).get(si)
        if tab is None:
            raise LibError(f"XCCY stage {si} is on the per-trade kernel "
                           f"route but the device tables lack its "
                           f"XccyStageTables")
        m = xmeta[si]
        G, S = spreads.shape
        nr = _rows_of(si, spreads.device)
        if m["parents"] is None:
            ds, Jn, _, Hn = kernels.xccy_stage_node_hess(
                tab, spreads[None], tab.pv_dom0[None].contiguous(),
                for_ds[None].contiguous())
            return dict(Jn=Jn[0], RR=node_rows(nr, ds[0]),
                        T=node_quads(nr, Jn[0], Hn[0]))
        Qd = m["Qd"]
        td_legs, tf2 = (t[None] for t in _parent_tangents(m, dds_st,
                                                          spreads))
        dd = dom_ds[None].contiguous()
        pv0, Jpv = kernels.xccy_legs_jvp(tab, dd, td_legs)
        ds, Jn, Jfd, Hn = kernels.xccy_stage_node_hess(
            tab, spreads[None], pv0, for_ds[None].contiguous(), tf2)
        unit = torch.eye(S, dtype=spreads.dtype, device=spreads.device)
        Jlegs_nat, Hl = kernels.xccy_legs_hess(
            tab, dd.expand(S, G, m["Ld"]).contiguous(),
            td_legs.expand(S, Qd, G, m["Ld"]).contiguous(),
            unit[:, None, :].expand(S, G, S).contiguous())
        return dict(Jn=Jn[0], Jfd=Jfd[0], Jpv=Jpv[0], Jlegs_nat=Jlegs_nat,
                    Hl=Hl, RR=node_rows(nr, ds[0]),
                    T=node_quads(nr, Jn[0], Hn[0]))

    def tensors(q, P):
        B = P["bat"]
        ds_of: List = [None] * C
        dds_st: Dict[int, torch.Tensor] = {}
        so: Dict[int, dict] = {}
        for si in meta["ois_first"]:
            st = stages[si]
            b = B[st.key]
            native = ois_native_ds if st.kind == "ois" else infl_native_ds
            q_local = q[b["qidx"]]                         # [G, Qp]
            seeds = _seeds(q_local.shape[-1], len(st.ids), q)
            ds, dds, dsT, rowsT = _so_tensor(
                lambda r, b=b, native=native: native(r, b), q_local, seeds,
                lambda d, b=b, si=si: stage_rows(d, its_of[si],
                                                 b["row_plan"]),
                "fit" in b["row_plan"])
            dds_st[si] = dds                               # [Qp, G, P1]
            for mi, cid in enumerate(st.ids):
                ds_of[cid] = ds[mi]
            so[si] = dict(dsT=dsT, rowsT=rowsT)

        for si in meta["xccy_last"]:
            st = stages[si]
            b = B[st.key]
            m = xmeta[si]
            spreads = q[b["qidx"]]                         # [G, S]
            G, S = spreads.shape
            dom_ds = torch.stack([torch.nn.functional.pad(
                ds_of[c], (0, m["Ld"] - ds_of[c].shape[-1]), value=1.0)
                for c in st.dom_ids])
            for_ds = torch.stack([torch.nn.functional.pad(
                ds_of[c], (0, m["Lf"] - ds_of[c].shape[-1]), value=1.0)
                for c in st.for_ids])

            if routes[si] == "kernels":
                so[si] = _node_tensors(si, P, spreads, dom_ds, for_ds,
                                       dds_st)
                continue

            def rows(d, b=b, si=si):
                return stage_rows(d, its_of[si], b["row_plan"])

            if m["parents"] is None:
                def native0(sp, b=b, st=st, dd=dom_ds, fd=for_ds):
                    return xccy_native_ds(sp, dd, fd, b, st)
                so[si] = dict(rowsT=_so_tensor(native0, spreads,
                                               _seeds(S, G, q), rows,
                                               "fit" in b["row_plan"])[3])
                continue

            Qd, Qf = m["Qd"], m["Qf"]
            D2 = 2 * S + Qf
            td_legs, tf2 = _parent_tangents(m, dds_st, q)

            def legs(dd, b=b, st=st):
                return xccy_legs_pv(dd, b, st)

            pv0, Jpv = _jac(legs, dom_ds, td_legs)         # [Qd, G, S]
            _, legs_vjp = vjp(legs, dom_ds)
            Jlegs_nat = vmap(lambda ct: legs_vjp(ct)[0])(
                _seeds(S, G, q))                           # [S, G, Ld]

            def native_z(Z, b=b, st=st, spreads=spreads, pv0=pv0,
                         for_ds=for_ds, tf2=tf2, S=S):
                fd2 = for_ds + torch.einsum("gd,dgl->gl", Z, tf2)
                return xccy_boot_ds(spreads + Z[:, :S], pv0 + Z[:, S:2 * S],
                                    fd2, b, st)

            Z0 = q.new_zeros((G, D2))
            seedsD = _seeds(D2, G, q)
            _, drows2 = _jac(lambda Z, native_z=native_z, rows=rows:
                             rows(native_z(Z)), Z0, seedsD)  # [D2, G, U]
            rowsTx = _so_tensor(native_z, Z0, seedsD, rows,
                                "fit" in b["row_plan"])[3]  # [D2, D2, G, U]

            def boot_fd(fd, b=b, st=st, si=si, spreads=spreads, pv0=pv0):
                ds = xccy_boot_ds(spreads, pv0, fd, b, st)
                return stage_rows(ds, its_of[si], b["row_plan"])

            _, drows_fd = _jac(boot_fd, for_ds,
                               _seeds(m["Lf"], G, q))      # [Lf, G, U]

            def legs_z(Zd, td_legs=td_legs, dom_ds=dom_ds, legs=legs):
                return legs(dom_ds + torch.einsum("gd,dgl->gl", Zd,
                                                  td_legs))

            legsT = _so_fwd(legs_z, q.new_zeros((G, Qd)), _seeds(Qd, G, q),
                            "both" in b["legs_plan"])      # [Qd, Qd, G, S]
            so[si] = dict(Jpv=Jpv, Jlegs_nat=Jlegs_nat, drows2=drows2,
                          rowsTx=rowsTx, drows_fd=drows_fd, legsT=legsT)
        return so

    return tensors


def _contract(Gb: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """"bu,iju->bij": [B, U] trade rows against a [I, J, U] tensor."""
    I, J, U = T.shape
    return (Gb @ T.reshape(I * J, U).T).reshape(-1, I, J)


def make_pertrade_curvehess(topo: StageTopology, restrict=None):
    """contract(so, G) -> [B, width, width]: sum_k G[b, k] d2 dfs_k/dq dq
    for every trade b (``adrates_tpu`` ``make_pertrade_curvehess``), with
    ``so`` the per-stage tensors of :func:`make_pertrade_tensors` at the
    quote vector. The contraction is linear in G: each member's tensor
    meets the trades' DF-gradient rows in one matrix product, and the
    XCCY chain terms flow as per-trade cotangents on the parents' native
    grids, as in the scenario term 2.

    An XCCY stage whose tensors are split at its node DFs (``RR`` in
    ``so[si]``) meets a trade's row G_b as W_b = G_b RR (a [B, U1] of the
    rows in the nodes, and M's band) and W_b T, the trade's Hessian over
    the stage's directions; its cotangents and the quote-space assembly
    are the same as the tensors' route.

    ``restrict=None``: G is [B, n_grid] on the book's grid axis (re-
    expanded to the dense [C*U] axis here) and the output [B, N, N].
    ``restrict=dict(cids=[...], width=k)`` (the per-trade blocks) names a
    set of curves closed over XCCY parents: G is [B, T*U], each touched
    curve's full unique-time row in sorted-cid order, and the output the
    [B, k, k] block of their quote slots (exact: quotes outside it move
    no touched curve)."""
    meta = _build_meta(topo)
    stages = meta["stages"]
    specs = meta["specs"]
    C, N, U = meta["C"], meta["N"], meta["U"]
    xmeta = meta["xmeta"]
    grid = meta["grid"]
    if restrict is None:
        touched = set(range(C))
        width = N
        row_pos = {cid: cid for cid in range(C)}
        segments = meta["segments"]
    else:
        touched = set(restrict["cids"])
        width = int(restrict["width"])
        row_pos = {cid: i for i, cid in enumerate(sorted(touched))}
        offmap, blk_off = {}, 0
        for cid in sorted(touched):
            offmap[specs[cid].offset] = blk_off
            blk_off += specs[cid].n_quotes
        if blk_off != width:
            raise ValueError(f"restrict width {width}, curves {blk_off}")

        def segments(si, mi):
            return [(offmap[off], n, lo, nd)
                    for off, n, lo, nd in meta["segments"](si, mi)]

    def contract(so, G):
        Bn = G.shape[0]
        if restrict is None and not grid["dense"]:
            inv = torch.as_tensor(grid["inv"], dtype=torch.int64,
                                  device=G.device)
            G = torch.cat([G, G.new_zeros((Bn, 1))], dim=1)[:, inv]
        out = G.new_zeros((Bn, width, width))

        def g_rows(cid):
            if cid not in touched:
                return None
            r = row_pos[cid]
            return G[:, r * U:(r + 1) * U]

        # own-stage terms of the OIS / inflation members
        for si in meta["ois_first"]:
            for mi, cid in enumerate(stages[si].ids):
                Gb = g_rows(cid)
                if Gb is not None:
                    place_hess(out, _contract(Gb, so[si]["rowsT"][:, :, mi]),
                               segments(si, mi))

        # XCCY stages, and the cotangents their parents owe
        vnat: Dict[int, torch.Tensor] = {}
        for si in meta["xccy_last"]:
            st = stages[si]
            m = xmeta[si]
            t = so[si]
            S = m["S"]
            nodes = "RR" in t
            for mi, cid in enumerate(st.ids):
                Gb = g_rows(cid)
                if Gb is None:
                    continue
                if nodes:
                    # the node split: W_b = G_b RR, Hb = W_b T
                    Wb = Gb @ t["RR"][mi]                   # [B, K]
                    D = t["Jn"].shape[0]
                    Hb = (Wb @ t["T"][mi]).reshape(-1, D, D)
                    a = Wb[:, :t["Jn"].shape[-1]]           # [B, U1]
                if m["parents"] is None:
                    place_hess(out, Hb if nodes else _contract(
                        Gb, t["rowsT"][:, :, mi]), segments(si, mi))
                    continue
                p = m["parents"][mi]
                qd_m, qf_m = p["qd"], p["qf"]
                if nodes:
                    w_pv = a @ t["Jn"][S:2 * S, mi].T       # [B, S]
                    v_for = a @ t["Jfd"][:, mi].T           # [B, Lf]
                    Hl = t["Hl"][:, :qd_m, mi, :qd_m]       # [S, qd, qd]
                    legs = (w_pv @ Hl.reshape(S, -1)).reshape(
                        -1, qd_m, qd_m)
                else:
                    w_pv = Gb @ t["drows2"][S:2 * S, mi].T  # [B, S]
                    v_for = Gb @ t["drows_fd"][:, mi].T     # [B, Lf]
                    Hb = _contract(Gb, t["rowsTx"][:, :, mi])
                    legs = _contract(w_pv, t["legsT"][:qd_m, :qd_m, mi])
                v_dom = w_pv @ t["Jlegs_nat"][:, mi]        # [B, Ld]
                for cid_par, vb, p1 in ((st.dom_ids[mi], v_dom, p["p1d"]),
                                        (st.for_ids[mi], v_for, p["p1f"])):
                    add = vb[:, :p1]
                    vnat[cid_par] = add if cid_par not in vnat \
                        else vnat[cid_par] + add
                Jv = t["Jpv"][:qd_m, mi]                    # [qd, S]
                bb = Hb[:, :S, :S]
                bp = Hb[:, :S, S:2 * S]
                bf = Hb[:, :S, 2 * S:2 * S + qf_m]
                pp = Hb[:, S:2 * S, S:2 * S]
                pf = Hb[:, S:2 * S, 2 * S:2 * S + qf_m]
                ff = Hb[:, 2 * S:2 * S + qf_m, 2 * S:2 * S + qf_m]
                q_bd = bp @ Jv.T                            # [B, S, qd]
                q_dd = Jv @ pp @ Jv.T + legs
                q_df = Jv @ pf                              # [B, qd, qf]
                Hq = torch.cat([
                    torch.cat([bb, q_bd, bf], dim=2),
                    torch.cat([q_bd.transpose(1, 2), q_dd, q_df], dim=2),
                    torch.cat([bf.transpose(1, 2), q_df.transpose(1, 2),
                               ff], dim=2)], dim=1)
                place_hess(out, Hq, segments(si, mi))

        # parent-chain second-order terms
        for si in meta["ois_first"]:
            for mi, cid in enumerate(stages[si].ids):
                vb = vnat.get(cid)
                if vb is not None:
                    place_hess(out, _contract(vb, so[si]["dsT"][:, :, mi]),
                               segments(si, mi))
        return out

    return contract
