"""The XCCY stage of the structured risk pass on K8-K11.

An XCCY stage of the batched curve graph (``parallel/curve_batching``:
the bootstrap ``xccy_boot_ds``, its rows ``stage_rows`` and the
calibration legs ``xccy_legs_pv``) is differentiated by the structured
split (``parallel/structured_risk``) along D composed directions in
region A and to the second order in region C1. On the card those
derivatives come from four hand-written kernels
(``csrc/xccy_stage.cu``), which evaluate the stage once per thread in a
scalar type T: a dual number (value and one tangent) for a directional
derivative, a hyper-dual one (value, e1, e2, e1 e2) for one entry of a
Hessian, so second derivatives are exact with no hand-derived adjoint:

- K8 ``xccy_stage_jvp``: the native DFs, the rows and the rows'
  directional derivatives along the D directions (basis spreads, the
  calibration legs' PVs and the foreign tangents; the basis alone when
  the parents are held as values);
- K9 ``xccy_legs_jvp``: the legs' PVs and their directional derivatives
  along the domestic parent's jacobian columns;
- K10 ``xccy_stage_hess``: for s(Z, fd) = sum gs . rows, its gradient in
  Z and in the foreign grid and its Hessian in Z, a thread a pair i <= j
  (written at [i, j] and [j, i]) and a thread a foreign grid entry;
- K11 ``xccy_legs_hess``: the same for sum gpv . legs(dd + Zd tdl) over
  the domestic directions and grid.

:class:`XccyStageTables` packs one stage's static data into flat
contiguous f64 / int32 tensors, once when the book's device tables are
built; the kernels and the plain versions here read the same tables. The
plain versions are torch on those tables, differentiated by
``torch.func``: the CPU path of the wrappers in ``ops/kernels`` and the
oracle of the kernels' card tests. :func:`thread_stage` and
:func:`thread_legs` are the kernels' per-thread evaluation written once
more in Python over any scalar type: the tests run it in hyper-dual
numpy arithmetic, and the operations the kernels' functions need (their
bounds) are counted on it (:func:`needed_flops`).

The bootstrap's solve is forward substitution in chain order: pillar k's
factor x_k = -(pv_k + fxs (v0_k + acc_k)) / d_k, with acc_k the sum of
its known payments' cf base C_seg over the factors C already solved,
which is what the JAX package's Neumann series (``ops/linear_solve``)
converges to; the node DFs and the rows follow in the same pass.

A stage takes the kernels (:func:`stage_route`) when its members', its
domestic and its foreign schemes are all simple (``LINEAR_FWD_RATES``,
``FLAT_FWD_RATES``, ``LINEAR_ZERO_RATES``; :func:`kernel_route`), it fits
the kernels' per-thread arrays (at most ``MAX_S`` pillars and ``MAX_U``
nodes) and its plan is one the single forward pass can take; any other
stage keeps the ``torch.func`` route. The route is the stage's alone: on
CPU tensors the wrappers run the plain versions.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch.func import grad, jvp, vmap

from ..utils.error import LibError
from ..utils.global_types import InterpTypes

# the kernels' scheme codes (csrc/xccy_stage.cu kLinFwd, kFlatFwd,
# kLinZero)
SCHEME_CODE = {InterpTypes.LINEAR_FWD_RATES: 0,
               InterpTypes.FLAT_FWD_RATES: 1,
               InterpTypes.LINEAR_ZERO_RATES: 2}
LIN_FWD, FLAT_FWD, LIN_ZERO = 0, 1, 2

# the kernels' per-thread array sizes (csrc/xccy_stage.cu kMaxS, kMaxU)
MAX_S = 16
MAX_U = 64

# chain-point flags (pt_i[..., 2]) and the legs' switches (``flags``)
IS_MAT, IS_NOTL, IS_LAST = 1, 2, 4
OVERRIDE_FIRST, NOTIONAL_EXCHANGE, CAP_FLOOR = 1, 2, 4

# direction kinds (csrc/xccy_stage.cu Dir): none, a basis spread, a leg
# PV, a tangent row over the grid, a unit grid entry
DIR_NONE, DIR_SPREAD, DIR_PV, DIR_ROW, DIR_UNIT = 0, 1, 2, 3, 4


def kernel_route(st, its: Sequence[InterpTypes]) -> bool:
    """Whether XCCY stage ``st`` (``curve_batching._Stage``, its members
    on the schemes ``its``) runs on K8-K11: its members', its domestic
    and its foreign schemes all simple."""
    return st.kind == "xccy" and all(
        it in SCHEME_CODE
        for it in list(its) + [st.dom_interp, st.foreign_interp])


def stage_route(st, its: Sequence[InterpTypes], b: dict) -> str:
    """"kernels" when XCCY stage ``st`` (its members on ``its``, its host
    ``bat`` entry ``b``) runs on K8-K11, else "torch.func: " and why: a
    fitted scheme, more pillars or nodes than the kernels' arrays hold, or
    a plan the single forward pass cannot take (:func:`_chain`)."""
    if not kernel_route(st, its):
        return "torch.func: a fitted scheme (" + ", ".join(sorted({
            it.name for it in list(its) + [st.dom_interp, st.foreign_interp]
            if it not in SCHEME_CODE})) + ")"
    p = b["plan"]
    S = int(np.asarray(p.mat_pos).shape[-1])
    pad_mask = np.asarray(b["pad_mask"], dtype=bool)
    U1 = pad_mask.shape[-1]
    if S > MAX_S or U1 > MAX_U:
        return (f"torch.func: {S} pillars / {U1} nodes exceed the "
                f"kernels' {MAX_S} / {MAX_U}")
    try:
        _chain(p, pad_mask)
        _legs_xs(b["legs_plan"], np.asarray(b["dom_ts"]).shape[-1])
    except LibError as e:
        return f"torch.func: {e}"
    return "kernels"


def stage_routes(topo) -> Dict[int, str]:
    """{stage index: :func:`stage_route`} for every XCCY stage of a
    ``StageTopology``, decided once when the book compiles."""
    return {si: stage_route(st, [topo.specs[c].interp_type for c in st.ids],
                            topo.bat[st.key])
            for si, st in enumerate(topo.stages) if st.kind == "xccy"}


@dataclasses.dataclass(frozen=True, eq=False)
class XccyStageTables:
    """One XCCY stage's static data for K8-K11, flat and contiguous on
    the book's device (f64 and int32; [G, ...] member-major):

    - chain points ``pt_f`` [G, n, 5] (notional, spread_sens,
      alpha_ratio, dt_chain, the weight of its known payment in its
      swap's par condition: 1 or 0) and ``pt_i`` [G, n, 4] (swap,
      segment, flags ``IS_*``, its node slot or -1); ``mat_pos`` [G, S];
      ``u_src`` [G, U1] each node slot's chain point or -1 (the t = 0
      node and the pad slots, DF 1 with no derivative); ``v0`` [G, S];
      ``fxs`` [G] (spot FX times the foreign sign);
    - four static simple plans as (``*_i`` [..., Q, 3] int32: i0, i1 and
      the exact knot or -1; ``*_f`` [..., Q, 2]: the weight and the query
      time) with each grid's ``x_safe`` (``*_xs``; ones but on
      ``LINEAR_ZERO``): ``fq`` the foreign DFs at (start, end, pay) of
      every chain point [G, 3n], ``rq`` the stage rows [G, W] (each
      member on its own scheme, ``r_sch`` [G]), ``li`` / ``ld`` the legs'
      index [G, S, 2P] and discount [G, S, Pd] queries;
    - the legs ``leg_f`` [G, S, P, 5] (payment time, pay alpha, index
      alpha, spread, notional) and ``leg_s`` [G, S, 9] (principal, sign,
      value time, first fixing, exchange amount, effective and maturity
      times, cap, floor); ``pv_dom0`` [G, S];
    - the Hessians' pair tables ``hpairs`` [D(D+1)/2, 2] and ``lpairs``
      [Qd(Qd+1)/2, 2] (i <= j, row-major).

    ``D`` is the stage's direction count (2S + Qf recalibrated, S held
    as values), ``npv`` the PV directions (S or 0), ``Qd`` the domestic
    directions. ``cache`` holds the kernels' argument block."""
    G: int
    S: int
    n: int
    U1: int
    Lf: int
    Ld: int
    W: int
    P: int
    Pd: int
    D: int
    npv: int
    Qd: int
    recal: bool
    flags: int
    fsch: int
    dsch: int
    pt_f: torch.Tensor
    pt_i: torch.Tensor
    mat_pos: torch.Tensor
    u_src: torch.Tensor
    v0: torch.Tensor
    fxs: torch.Tensor
    fq_i: torch.Tensor
    fq_f: torch.Tensor
    f_xs: torch.Tensor
    rq_i: torch.Tensor
    rq_f: torch.Tensor
    r_sch: torch.Tensor
    r_xs: torch.Tensor
    li_i: torch.Tensor
    li_f: torch.Tensor
    ld_i: torch.Tensor
    ld_f: torch.Tensor
    d_xs: torch.Tensor
    leg_f: torch.Tensor
    leg_s: torch.Tensor
    pv_dom0: torch.Tensor
    hpairs: torch.Tensor
    lpairs: torch.Tensor
    cache: dict = dataclasses.field(default_factory=dict, init=False,
                                    repr=False)

    def host(self) -> dict:
        """The tables as numpy arrays (:func:`thread_stage`'s input)."""
        return {f.name: (getattr(self, f.name).cpu().numpy()
                         if isinstance(getattr(self, f.name), torch.Tensor)
                         else getattr(self, f.name))
                for f in dataclasses.fields(self) if f.name != "cache"}


def probe_tables(tab: XccyStageTables, seed: int) -> XccyStageTables:
    """``tab`` with calibration legs that do not telescope, for holding
    K9 / K11 to their plain versions: a book's domestic legs (float
    coupons with notional exchanges, projected and discounted on one
    curve) price to 0 for every curve, so their PVs and derivatives are
    rounding alone. Here every live coupon carries a seeded spread, each
    leg's second coupon has no accrual (ia = 0), the first coupon is
    fixed, a principal is paid, and the all-in rate is capped and floored
    inside the range of the forwards."""
    rng = np.random.default_rng(seed)
    leg_f = tab.leg_f.clone()
    leg_s = tab.leg_s.clone()
    live = leg_f[..., 2] > 0
    spr = torch.as_tensor(rng.normal(0.0, 2e-3, live.shape),
                          device=leg_f.device)
    leg_f[..., 3] = torch.where(live, spr, leg_f[..., 3])
    if leg_f.shape[-2] > 1:
        leg_f[..., 1, 2] = 0.0
    leg_s[..., 0] = leg_f[..., -1, 4]
    leg_s[..., 3] = 0.02
    leg_s[..., 7] = 0.035
    leg_s[..., 8] = 0.002
    return dataclasses.replace(
        tab, leg_f=leg_f, leg_s=leg_s,
        flags=tab.flags | OVERRIDE_FIRST | CAP_FLOOR)


def pair_table(D: int) -> np.ndarray:
    """[D(D+1)/2, 2] int32: every pair i <= j of D directions, once,
    row-major."""
    i, j = np.triu_indices(D)
    return np.stack([i, j], axis=1).astype(np.int32)


def _pack_plan(plan: dict):
    """A (stacked) simple plan as (int32 [..., Q, 3], f64 [..., Q, 2])."""
    kn = np.where(np.asarray(plan["at_knot"]),
                  np.asarray(plan["knot_idx"]), -1)
    i = np.stack([np.asarray(plan["i0"]), np.asarray(plan["i1"]), kn],
                 axis=-1).astype(np.int32)
    f = np.stack([np.asarray(plan["c"], dtype=np.float64),
                  np.asarray(plan["q"], dtype=np.float64)], axis=-1)
    return i, f


def _x_safe(plan: dict, shape) -> np.ndarray:
    return np.asarray(plan["x_safe"], dtype=np.float64) \
        if "x_safe" in plan else np.ones(shape)


def _legs_xs(lp: dict, Ld: int) -> np.ndarray:
    """The legs' domestic grid ``x_safe`` [G, Ld], one for all of a
    member's legs."""
    xs = _x_safe(lp["idx"], np.asarray(lp["idx"]["i0"]).shape[:-1] + (Ld,))
    if not (xs == xs[:, :1]).all():
        raise LibError("XCCY plan: legs on different grids")
    return xs[:, 0]


def _chain(p, pad_mask: np.ndarray):
    """(pt_f, pt_i, mat_pos, u_src) from a stacked XccyBootstrapPlan,
    after checking what the single forward pass relies on."""
    G, n = np.asarray(p.times).shape
    S = np.asarray(p.mat_pos).shape[-1]
    U1 = pad_mask.shape[-1]
    sw, sg = np.asarray(p.swap_onehot), np.asarray(p.seg_onehot)
    swap = np.asarray(p.swap_of).astype(np.int64)
    seg = np.asarray(p.seg_of).astype(np.int64)
    is_mat = np.asarray(p.is_mat, dtype=bool)
    flags = (IS_MAT * is_mat + IS_NOTL * np.asarray(p.is_notl, dtype=bool)
             + IS_LAST * np.asarray(p.is_last, dtype=bool))
    if ((sw != 0).sum(axis=1) > 1).any() or ((sg != 0).sum(axis=1) > 1).any():
        raise LibError("XCCY plan: a chain point in two swaps or segments")
    rows = np.arange(n)
    weight = np.zeros((G, n))
    node = np.full((G, n), -1, dtype=np.int64)
    u_src = np.full((G, U1), -1, dtype=np.int64)
    usel = np.asarray(p.unique_sel)
    mat_pos = np.asarray(p.mat_pos).astype(np.int64)
    for g in range(G):
        weight[g] = sw[g, swap[g], rows] * sg[g, seg[g], rows]
        if (np.abs(sw[g]).sum(axis=0) != np.abs(weight[g])).any():
            raise LibError("XCCY plan: a swap weight off its own segment")
        mats = np.flatnonzero(is_mat[g])
        if mats.shape[0] != S or not np.array_equal(mats, mat_pos[g]) \
                or not np.array_equal(swap[g, mats], np.arange(S)):
            raise LibError("XCCY plan: pillars not in maturity order")
        before = np.concatenate([[0], np.cumsum(is_mat[g])[:-1]])
        for u in range(1, U1):
            if not pad_mask[g, u]:
                i = int(usel[g, u - 1])
                if node[g, i] >= 0:
                    raise LibError("XCCY plan: a chain point on two nodes")
                node[g, i], u_src[g, u] = u, i
        need = (weight[g] != 0) | (node[g] >= 0)
        if (need & ~is_mat[g] & (seg[g] > before)).any():
            raise LibError("XCCY plan: a segment factor not yet solved")
        live = np.flatnonzero(weight[g] != 0)
        if (live >= mat_pos[g, swap[g, live]]).any():
            raise LibError("XCCY plan: a payment after its pillar")
    pt_f = np.stack([np.asarray(p.notionals), np.asarray(p.spread_sens),
                     np.asarray(p.alpha_ratio), np.asarray(p.dt_chain),
                     weight], axis=-1).astype(np.float64)
    pt_i = np.stack([swap, seg, flags, node], axis=-1).astype(np.int32)
    return pt_f, pt_i, mat_pos.astype(np.int32), u_src.astype(np.int32)


def stage_tables(st, its: Sequence[InterpTypes], b: dict, row_plan: dict,
                 D: int, Qd: int, device) -> XccyStageTables:
    """One XCCY stage's :class:`XccyStageTables` on ``device`` from its
    host ``bat`` entry ``b`` (``curve_batching.build_batched_grids``), the
    row plan the structured pass evaluates (keep-compact or full) and its
    direction counts. Raises LibError for a stage off the kernel route
    (:func:`stage_route`)."""
    route = stage_route(st, its, b)
    if route != "kernels":
        raise LibError("XCCY stage tables: the stage keeps " + route)
    p = b["plan"]
    G, n = np.asarray(p.times).shape
    S = int(np.asarray(p.mat_pos).shape[-1])
    pad_mask = np.asarray(b["pad_mask"], dtype=bool)
    U1 = pad_mask.shape[-1]
    pt_f, pt_i, mat_pos, u_src = _chain(p, pad_mask)
    Lf = np.asarray(b["for_ts"]).shape[-1]
    Ld = np.asarray(b["dom_ts"]).shape[-1]
    fq_i, fq_f = _pack_plan(b["fboot_plan"])
    f_xs = _x_safe(b["fboot_plan"], (G, Lf))
    # the rows: each member's own scheme's stacked plan, by position
    W = int(np.asarray(next(v for k, v in row_plan.items()
                            if k in InterpTypes.__members__)["i0"])
            .shape[-1])
    rq_i = np.zeros((G, W, 3), dtype=np.int32)
    rq_f = np.zeros((G, W, 2))
    r_xs = np.ones((G, U1))
    mids: Dict[InterpTypes, list] = {}
    for m, it in enumerate(its):
        mids.setdefault(it, []).append(m)
    for it, ms in mids.items():
        pi, pf = _pack_plan(row_plan[it.name])
        xs = _x_safe(row_plan[it.name], (len(ms), U1))
        for k, m in enumerate(ms):
            rq_i[m], rq_f[m], r_xs[m] = pi[k], pf[k], xs[k]
    lp = b["legs_plan"]
    li_i, li_f = _pack_plan(lp["idx"])
    ld_i, ld_f = _pack_plan(lp["disc"])
    legs = b["legs"]
    P = np.asarray(legs.payment_times).shape[-1]
    leg_f = np.stack([np.asarray(getattr(legs, k), dtype=np.float64)
                      for k in ("payment_times", "pay_alphas",
                                "index_alphas", "spreads", "notionals")],
                     axis=-1)
    leg_s = np.stack([np.asarray(getattr(legs, k), dtype=np.float64)
                      for k in ("principal", "leg_sign", "value_time",
                                "first_fixing_rate",
                                "notional_exchange_amount",
                                "effective_time", "maturity_time",
                                "cap_rate", "floor_rate")], axis=-1)
    flags = (OVERRIDE_FIRST * bool(legs.override_first)
             + NOTIONAL_EXCHANGE * bool(legs.notional_exchange)
             + CAP_FLOOR * bool(legs.has_cap_floor))
    fxs = np.asarray(b["spot_fx"], dtype=np.float64) \
        * float(p.foreign_sign)

    def f64(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.float64),
                               device=device)

    def i32(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32),
                               device=device)

    return XccyStageTables(
        G=int(G), S=S, n=int(n), U1=int(U1), Lf=int(Lf), Ld=int(Ld),
        W=W, P=int(P), Pd=int(ld_i.shape[-2]), D=int(D),
        npv=S if st.recal else 0, Qd=int(Qd), recal=bool(st.recal),
        flags=int(flags), fsch=SCHEME_CODE[st.foreign_interp],
        dsch=SCHEME_CODE[st.dom_interp],
        pt_f=f64(pt_f), pt_i=i32(pt_i), mat_pos=i32(mat_pos),
        u_src=i32(u_src), v0=f64(p.v0), fxs=f64(fxs), fq_i=i32(fq_i),
        fq_f=f64(fq_f), f_xs=f64(f_xs), rq_i=i32(rq_i), rq_f=f64(rq_f),
        r_sch=i32([SCHEME_CODE[it] for it in its]), r_xs=f64(r_xs),
        li_i=i32(li_i), li_f=f64(li_f), ld_i=i32(ld_i), ld_f=f64(ld_f),
        d_xs=f64(_legs_xs(lp, Ld)), leg_f=f64(leg_f), leg_s=f64(leg_s),
        pv_dom0=f64(b["pv_dom0"]), hpairs=i32(pair_table(D)),
        lpairs=i32(pair_table(Qd)))


# ---------------------------------------------------------------------------
# the plain versions: torch on the packed tables, differentiated by
# torch.func
# ---------------------------------------------------------------------------


def _interp(ti: torch.Tensor, tf: torch.Tensor, xs: torch.Tensor,
            grid: torch.Tensor, sch) -> torch.Tensor:
    """``interpolation.simple_df_static`` on a packed plan: ``grid``
    [..., L] at the queries of ``ti`` / ``tf`` [..., Q, 3 / 2] under the
    scheme code ``sch`` (an int, or [..., 1] codes of the leading rows)."""
    i0, i1, kn = (ti[..., k].long() for k in range(3))
    c, q = tf[..., 0], tf[..., 1]

    def val(code):
        if code == LIN_FWD:
            y = grid
        else:
            y = -torch.log(grid)
            if code == LIN_ZERO:
                y = y / xs
        y0 = y.gather(-1, i0)
        v = y0 + c * (y.gather(-1, i1) - y0)
        if code == FLAT_FWD:
            return torch.exp(-v)
        if code == LIN_ZERO:
            return torch.exp(-v * q)
        return v

    if isinstance(sch, int):
        out = val(sch)
    else:
        codes = sorted(set(sch.reshape(-1).tolist()))
        out = val(codes[0])
        for code in codes[1:]:
            out = torch.where(sch == code, val(code), out)
    return torch.where(kn >= 0, grid.gather(-1, kn.clamp(min=0)), out)


def stage_forward(tab: XccyStageTables, sp: torch.Tensor, pv: torch.Tensor,
                  fd: torch.Tensor):
    """(ds [G, U1], rows [G, W]): the stage's sentinelized native DFs and
    rows from the spreads [G, S], the legs' PVs [G, S] and the foreign
    grids [G, Lf], on the packed tables (``curve_batching.xccy_boot_ds``
    and ``stage_rows``, the solve by forward substitution)."""
    n, S = tab.n, tab.S
    fq = _interp(tab.fq_i, tab.fq_f, tab.f_xs, fd, tab.fsch)
    df_s, df_e, df_p = fq[..., :n], fq[..., n:2 * n], fq[..., 2 * n:]
    notl, ss, ar, dt, w = tab.pt_f.unbind(-1)
    swap, seg, fl, _ = tab.pt_i.long().unbind(-1)
    is_mat, is_notl, is_last = (fl & IS_MAT) != 0, (fl & IS_NOTL) != 0, \
        (fl & IS_LAST) != 0
    sp_of = sp.gather(-1, swap)
    interest = (df_s / df_e - 1.0) * notl * ar \
        + torch.where(is_last, notl, 0.0)
    cf = torch.where(is_notl, torch.where(is_last, notl, -notl), interest) \
        + sp_of * ss
    base = df_p * torch.exp(torch.cumsum(-sp_of * dt, dim=-1))
    live = cf * base * w
    ks = torch.arange(S + 1, device=sp.device)
    W = ((swap.unsqueeze(-2) == ks[:S, None]) * live.unsqueeze(-2)) \
        @ (seg.unsqueeze(-2) == ks[:, None]).to(live.dtype).mT  # [G, S, S+1]
    mp = tab.mat_pos.long()
    d = tab.fxs.unsqueeze(-1) * cf.gather(-1, mp) * base.gather(-1, mp)
    C = [torch.ones_like(sp[..., 0])]
    for k in range(S):
        acc = (W[..., k, :k + 1] * torch.stack(C, dim=-1)).sum(-1)
        C.append(-(pv[..., k] + tab.fxs * (tab.v0[..., k] + acc))
                 / d[..., k])
    Cf = torch.stack(C, dim=-1)                               # [G, S+1]
    rank = (torch.cumsum(is_mat.long(), dim=-1) - 1).clamp(min=0)
    nodes = torch.where(is_mat, Cf[..., 1:].gather(-1, rank),
                        Cf.gather(-1, seg)) * base
    src = tab.u_src.long()
    ds = torch.where(src >= 0, nodes.gather(-1, src.clamp(min=0)), 1.0)
    rows = _interp(tab.rq_i, tab.rq_f, tab.r_xs, ds,
                   tab.r_sch.unsqueeze(-1))
    return ds, rows


def legs_forward(tab: XccyStageTables, dd: torch.Tensor) -> torch.Tensor:
    """The calibration legs' PVs [G, S] from the domestic grids [G, Ld]
    on the packed tables (``ops/pricers.pv_float_leg`` on static plans,
    as ``curve_batching.xccy_legs_pv`` runs it)."""
    G, S, Ld, P = tab.G, tab.S, tab.Ld, tab.P
    dds = dd.unsqueeze(-2).expand(dd.shape[:-1] + (S, Ld))
    xs = tab.d_xs.unsqueeze(-2).expand(G, S, Ld)
    idx = _interp(tab.li_i, tab.li_f, xs, dds, tab.dsch)
    disc = _interp(tab.ld_i, tab.ld_f, xs, dds, tab.dsch)
    pay_t, pa, ia, spr, notl = tab.leg_f.unbind(-1)
    principal, sign, vt, ffr, nx, eff, mat, cap, flo = (
        x.unsqueeze(-1) for x in tab.leg_s.unbind(-1))
    df_val = disc[..., P:P + 1]
    has = ia > 0
    fwd = torch.where(has, (idx[..., :P] / idx[..., P:] - 1.0)
                      / torch.where(has, ia, 1.0), 0.0)
    pos = torch.arange(P, device=dd.device)
    if tab.flags & OVERRIDE_FIRST:
        fwd = torch.where(pos == 0, ffr, fwd)
    rate = fwd + spr
    if tab.flags & CAP_FLOOR:
        rate = torch.clamp(rate, flo, cap)
    cf = rate * pa * notl + torch.where(pos == P - 1, principal, 0.0)
    pv = torch.where(pay_t > vt, (sign * cf) * (disc[..., :P] / df_val),
                     0.0)
    total = pv.sum(-1)
    if tab.flags & NOTIONAL_EXCHANGE:
        ex_t = torch.cat([eff, mat], dim=-1)
        ex_amt = torch.cat([-nx, nx], dim=-1)
        total = total + torch.where(
            ex_t >= vt, (sign * ex_amt) * (disc[..., P + 1:P + 3] / df_val),
            0.0).sum(-1)
    return total


def _dir_tangents(tab: XccyStageTables, like: torch.Tensor):
    """The D directions' spread and PV tangents ([D, G, S] each)."""
    D, G, S = tab.D, tab.G, tab.S
    eye = torch.eye(S, dtype=like.dtype, device=like.device)[:, None, :]
    tb = like.new_zeros((D, G, S))
    tb[:S] = eye
    tp = like.new_zeros((D, G, S))
    tp[S:S + tab.npv] = eye[:tab.npv]
    return tb, tp


def _fd_tangents(tab: XccyStageTables, tf: Optional[torch.Tensor],
                 fd: torch.Tensor) -> torch.Tensor:
    """[Sc, D, G, Lf]: the directions' foreign tangents (0 without)."""
    if tf is not None:
        return tf
    return fd.new_zeros((fd.shape[0], tab.D) + fd.shape[1:])


def xccy_stage_jvp_plain(tab: XccyStageTables, sp: torch.Tensor,
                         pv: torch.Tensor, fd: torch.Tensor,
                         tf: Optional[torch.Tensor] = None):
    """Plain version of K8: (ds [Sc, G, U1], rows [Sc, G, W], drows
    [Sc, D, G, W]) from sp, pv [Sc, G, S], fd [Sc, G, Lf] and the
    directions' foreign tangents tf [Sc, D, G, Lf] (None: none)."""
    tb, tp = _dir_tangents(tab, sp)

    def one(s, p, f, t):
        (ds, rows), (_, drows) = vmap(lambda a, b, c: jvp(
            lambda x, y, z: stage_forward(tab, x, y, z), (s, p, f),
            (a, b, c)))(tb, tp, t)
        return ds[0], rows[0], drows

    return vmap(one)(sp, pv, fd, _fd_tangents(tab, tf, fd))


def xccy_legs_jvp_plain(tab: XccyStageTables, dd: torch.Tensor,
                        tdl: torch.Tensor):
    """Plain version of K9: (pv0 [Sc, G, S], Jpv [Sc, Qd, G, S]) from the
    domestic grids dd [Sc, G, Ld] along tdl [Sc, Qd, G, Ld]."""
    def one(d, t):
        pv, jp = vmap(lambda s: jvp(lambda x: legs_forward(tab, x), (d,),
                                    (s,)))(t)
        return pv[0], jp

    return vmap(one)(dd, tdl)


def _hess(f, x: torch.Tensor, n: int) -> torch.Tensor:
    """[n, ...] Hessian-vector products of the scalar f at x [G, n] along
    the n member-parallel unit directions."""
    eye = torch.eye(n, dtype=x.dtype, device=x.device)[:, None, :]
    seeds = eye.expand(n, x.shape[0], n)
    return vmap(lambda s: jvp(grad(f), (x,), (s,))[1])(seeds)


def xccy_stage_hess_plain(tab: XccyStageTables, sp: torch.Tensor,
                          pv: torch.Tensor, fd: torch.Tensor,
                          tf: Optional[torch.Tensor], gs: torch.Tensor):
    """Plain version of K10: for s(Z, fd) = sum(gs * rows(sp + Z_b,
    pv + Z_pv, fd + Z . tf)) at Z = 0, (gZ [Sc, G, D], gf [Sc, G, Lf],
    H [Sc, D, G, D]); gf is None when the parents are held as values."""
    S, npv, D = tab.S, tab.npv, tab.D

    def one(s0, p0, f0, t, g):
        def s_hat(Z, f):
            f2 = f + torch.einsum("gd,dgl->gl", Z, t)
            pz = p0 + Z[:, S:S + npv] if npv else p0
            return torch.sum(g * stage_forward(tab, s0 + Z[:, :S], pz,
                                               f2)[1])
        Z0 = s0.new_zeros((tab.G, D))
        gZ, gf = grad(s_hat, argnums=(0, 1))(Z0, f0)
        return gZ, gf, _hess(lambda Z: s_hat(Z, f0), Z0, D)

    gZ, gf, H = vmap(one)(sp, pv, fd, _fd_tangents(tab, tf, fd), gs)
    return gZ, (gf if tab.recal else None), H


def xccy_legs_hess_plain(tab: XccyStageTables, dd: torch.Tensor,
                         tdl: torch.Tensor, gpv: torch.Tensor):
    """Plain version of K11: for s(Zd, dd) = sum(gpv * legs(dd + Zd .
    tdl)) at Zd = 0, (gdd [Sc, G, Ld], Hl [Sc, Qd, G, Qd])."""
    Qd = tab.Qd

    def one(d0, t, g):
        def s_legs(Zd, d):
            return torch.sum(g * legs_forward(
                tab, d + torch.einsum("gd,dgl->gl", Zd, t)))
        Z0 = d0.new_zeros((tab.G, Qd))
        gdd = grad(s_legs, argnums=1)(Z0, d0)
        return gdd, _hess(lambda Z: s_legs(Z, d0), Z0, Qd)

    return vmap(one)(dd, tdl, gpv)


# ---------------------------------------------------------------------------
# the kernels' per-thread evaluation, over any scalar type
# ---------------------------------------------------------------------------


def _terms(*terms) -> int:
    """The f64 operations of a sum of terms, each (present, its own
    operations): a term whose factor is zero is not computed, and n
    present terms take n - 1 additions."""
    live = [k for present, k in terms if present]
    return sum(live) + max(len(live) - 1, 0)


class Dual:
    """A dual number v + e eps in the kernels' formulas (a double operand
    at the kernels' double overloads). ``Dual.ops`` counts the f64
    operations each part needs, [primal, tangent]: an add, multiply,
    divide, exp or log is one, a negation none (it folds into its user),
    and a term whose factor is zero is not computed."""
    ops = [0, 0]
    __slots__ = ("v", "e")

    def __init__(self, v, e=0.0):
        self.v, self.e = float(v), float(e)

    @staticmethod
    def _count(v, e):
        Dual.ops[0] += v
        Dual.ops[1] += e

    def __add__(self, o):
        if not isinstance(o, Dual):
            Dual._count(1, 0)
            return Dual(self.v + o, self.e)
        Dual._count(1, _terms((self.e != 0, 0), (o.e != 0, 0)))
        return Dual(self.v + o.v, self.e + o.e)

    __radd__ = __add__

    def __sub__(self, o):
        return self + (-o)

    def __rsub__(self, o):
        return (-self) + o

    def __neg__(self):
        return Dual(-self.v, -self.e)

    def __mul__(self, o):
        if not isinstance(o, Dual):
            Dual._count(1, int(self.e != 0))
            return Dual(self.v * o, self.e * o)
        Dual._count(1, _terms((o.e != 0, 1), (self.e != 0, 1)))
        return Dual(self.v * o.v, self.v * o.e + self.e * o.v)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if not isinstance(o, Dual):
            Dual._count(1, int(self.e != 0))
            return Dual(self.v / o, self.e / o)
        q = self.v / o.v
        Dual._count(1, _terms((self.e != 0, 0), (o.e != 0, 1))
                    + (self.e != 0 or o.e != 0))      # the divide by o.v
        return Dual(q, (self.e - q * o.e) / o.v)

    def __rtruediv__(self, o):
        return Dual(o) / self

    def exp(self):
        x = math.exp(self.v)
        Dual._count(1, int(self.e != 0))
        return Dual(x, x * self.e)

    def log(self):
        Dual._count(1, int(self.e != 0))
        return Dual(math.log(self.v), self.e / self.v)


class HyperDual:
    """A hyper-dual number v + a e1 + b e2 + ab e1 e2 (e1^2 = e2^2 = 0) in
    the kernels' formulas; ``HyperDual.ops`` counts the f64 operations
    each part needs, [v, a, b, ab], as :class:`Dual` counts them."""
    ops = [0, 0, 0, 0]
    __slots__ = ("v", "a", "b", "ab")

    def __init__(self, v, a=0.0, b=0.0, ab=0.0):
        self.v, self.a, self.b, self.ab = float(v), float(a), float(b), \
            float(ab)

    @staticmethod
    def _count(*k):
        for i, x in enumerate(k):
            HyperDual.ops[i] += x

    def __add__(self, o):
        if not isinstance(o, HyperDual):
            HyperDual._count(1, 0, 0, 0)
            return HyperDual(self.v + o, self.a, self.b, self.ab)
        HyperDual._count(1, *(_terms((x != 0, 0), (y != 0, 0)) for x, y in (
            (self.a, o.a), (self.b, o.b), (self.ab, o.ab))))
        return HyperDual(self.v + o.v, self.a + o.a, self.b + o.b,
                         self.ab + o.ab)

    __radd__ = __add__

    def __sub__(self, o):
        return self + (-o)

    def __rsub__(self, o):
        return (-self) + o

    def __neg__(self):
        return HyperDual(-self.v, -self.a, -self.b, -self.ab)

    def __mul__(self, o):
        if not isinstance(o, HyperDual):
            HyperDual._count(1, int(self.a != 0), int(self.b != 0),
                             int(self.ab != 0))
            return HyperDual(self.v * o, self.a * o, self.b * o,
                             self.ab * o)
        HyperDual._count(
            1, _terms((o.a != 0, 1), (self.a != 0, 1)),
            _terms((o.b != 0, 1), (self.b != 0, 1)),
            _terms((o.ab != 0, 1), (self.a != 0 and o.b != 0, 1),
                   (self.b != 0 and o.a != 0, 1), (self.ab != 0, 1)))
        return HyperDual(self.v * o.v, self.v * o.a + self.a * o.v,
                         self.v * o.b + self.b * o.v,
                         self.v * o.ab + self.a * o.b + self.b * o.a
                         + self.ab * o.v)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if not isinstance(o, HyperDual):
            HyperDual._count(1, int(self.a != 0), int(self.b != 0),
                             int(self.ab != 0))
            return HyperDual(self.v / o, self.a / o, self.b / o,
                             self.ab / o)
        q = self.v / o.v
        qa = (self.a - q * o.a) / o.v
        qb = (self.b - q * o.b) / o.v

        def part(*terms):
            t = _terms(*terms)
            return t + any(p for p, _ in terms)      # the divide by o.v
        HyperDual._count(
            1, part((self.a != 0, 0), (o.a != 0, 1)),
            part((self.b != 0, 0), (o.b != 0, 1)),
            part((self.ab != 0, 0), (o.ab != 0, 1),
                 (qa != 0 and o.b != 0, 1), (qb != 0 and o.a != 0, 1)))
        return HyperDual(q, qa, qb, (self.ab - q * o.ab - qa * o.b
                                     - qb * o.a) / o.v)

    def __rtruediv__(self, o):
        return HyperDual(o) / self

    def exp(self):
        x = math.exp(self.v)
        ab = ((self.ab != 0, 0), (self.a != 0 and self.b != 0, 1))
        HyperDual._count(1, int(self.a != 0), int(self.b != 0),
                         _terms(*ab) + any(p for p, _ in ab))
        return HyperDual(x, x * self.a, x * self.b,
                         x * (self.ab + self.a * self.b))

    def log(self):
        HyperDual._count(1, int(self.a != 0), int(self.b != 0),
                         _terms((self.ab != 0, 1),
                                (self.a != 0 and self.b != 0, 3)))
        return HyperDual(math.log(self.v), self.a / self.v,
                         self.b / self.v,
                         self.ab / self.v - self.a * self.b
                         / (self.v * self.v))


def _lift(T, v, t1, t2):
    return Dual(v, t1) if T is Dual else HyperDual(v, t1, t2)


def _tan_sp(d, s):
    return 1.0 if d[0] == DIR_SPREAD and d[1] == s else 0.0


def _tan_pv(d, s):
    return 1.0 if d[0] == DIR_PV and d[1] == s else 0.0


def _tan_grid(d, ll):
    if d[0] == DIR_ROW:
        return float(d[2][ll])
    return 1.0 if d[0] == DIR_UNIT and d[1] == ll else 0.0


def _interp_t(T, sch, qi, qf, xs, grid, d1, d2):
    """One query of a packed plan in T (csrc/xccy_stage.cu interp)."""
    def gv(ll):
        return _lift(T, grid[ll], _tan_grid(d1, ll), _tan_grid(d2, ll))

    def y(ll):
        d = gv(ll)
        if sch == LIN_FWD:
            return d
        r = -d.log()
        return r if sch == FLAT_FWD else r / float(xs[ll])

    if qi[2] >= 0:
        return gv(int(qi[2]))
    y0 = y(int(qi[0]))
    v = y0 + float(qf[0]) * (y(int(qi[1])) - y0)
    if sch == FLAT_FWD:
        return (-v).exp()
    if sch == LIN_ZERO:
        return (-v * float(qf[1])).exp()
    return v


def thread_stage(T, h: dict, g: int, sp, pv, fd, d1, d2, row_sink):
    """One K8 / K10 thread's evaluation of member ``g`` (h = the tables'
    ``host()``) in the scalar type T (:class:`Dual` or
    :class:`HyperDual`) at the spreads ``sp`` [S], PVs ``pv`` [S] and
    foreign grid ``fd`` [Lf], the inputs lifted along the directions
    ``d1`` / ``d2`` ((kind, index, tangent row)); calls ``row_sink(w,
    value)`` for every row and returns the node DFs [U1]."""
    n, S = h["n"], h["S"]
    pf, pi = h["pt_f"][g], h["pt_i"][g]
    fqi, fqf, fxsg = h["fq_i"][g], h["fq_f"][g], h["f_xs"][g]
    fxs = float(h["fxs"][g])

    def fdf(q):
        return _interp_t(T, h["fsch"], fqi[q], fqf[q], fxsg, fd, d1, d2)

    C = [None] * (S + 1)
    C[0] = _lift(T, 1.0, 0.0, 0.0)
    acc = [_lift(T, 0.0, 0.0, 0.0) for _ in range(S)]
    ds = [_lift(T, 1.0, 0.0, 0.0) for _ in range(h["U1"])]
    cum = _lift(T, 0.0, 0.0, 0.0)
    rank = 0
    for i in range(n):
        k, s, fl, node = (int(x) for x in pi[i])
        notl, ss, ar, dt, w = (float(x) for x in pf[i])
        spk = _lift(T, sp[k], _tan_sp(d1, k), _tan_sp(d2, k))
        cum = cum + (-spk) * dt
        mat = bool(fl & IS_MAT)
        if not mat and w == 0.0 and node < 0:
            continue
        base = fdf(2 * n + i) * cum.exp()
        if fl & IS_NOTL:
            cf = _lift(T, notl if fl & IS_LAST else -notl, 0.0, 0.0) \
                + spk * ss
        else:
            r = fdf(i) / fdf(n + i)
            cf = (((r - 1.0) * notl) * ar
                  + (notl if fl & IS_LAST else 0.0)) + spk * ss
        if mat:
            d = (fxs * cf) * base
            pvk = _lift(T, pv[rank], _tan_pv(d1, rank), _tan_pv(d2, rank))
            x = -(pvk + fxs * (float(h["v0"][g, rank]) + acc[rank])) / d
            C[rank + 1] = x
            val = x * base
            rank += 1
        else:
            if w != 0.0:
                acc[k] = acc[k] + (cf * base) * w * C[s]
            val = C[s] * base
        if node >= 0:
            ds[node] = val
    rs = int(h["r_sch"][g])
    rxs = h["r_xs"][g]
    y = []
    for u in range(h["U1"]):
        if rs == LIN_FWD:
            y.append(ds[u])
        else:
            r = -ds[u].log()
            y.append(r if rs == FLAT_FWD else r / float(rxs[u]))
    rqi, rqf = h["rq_i"][g], h["rq_f"][g]
    for w in range(h["W"]):
        q, f = rqi[w], rqf[w]
        if q[2] >= 0:
            v = ds[int(q[2])]
        else:
            y0 = y[int(q[0])]
            v = y0 + float(f[0]) * (y[int(q[1])] - y0)
            if rs == FLAT_FWD:
                v = (-v).exp()
            elif rs == LIN_ZERO:
                v = (-v * float(f[1])).exp()
        row_sink(w, v)
    return ds


def thread_legs(T, h: dict, g: int, dd, d1, d2, leg_sink):
    """One K9 / K11 thread's evaluation of member ``g``'s calibration
    legs in T at the domestic grid ``dd`` [Ld] along ``d1`` / ``d2``;
    calls ``leg_sink(s, pv)`` for every leg."""
    S, P = h["S"], h["P"]
    xs = h["d_xs"][g]
    flags = h["flags"]
    for s in range(S):
        ii, if_ = h["li_i"][g, s], h["li_f"][g, s]
        di, df = h["ld_i"][g, s], h["ld_f"][g, s]
        lf = h["leg_f"][g, s]
        principal, sign, vt, ffr, nx, eff, matt, cap, flo = (
            float(x) for x in h["leg_s"][g, s])

        def q(plan_i, plan_f, k):
            return _interp_t(T, h["dsch"], plan_i[k], plan_f[k], xs, dd,
                             d1, d2)

        dval = q(di, df, P)
        total = _lift(T, 0.0, 0.0, 0.0)
        for p in range(P):
            payt, pa, ia, spr, notl = (float(x) for x in lf[p])
            if not payt > vt:
                continue
            if flags & OVERRIDE_FIRST and p == 0:
                fwd = _lift(T, ffr, 0.0, 0.0)
            elif ia > 0:
                fwd = (q(ii, if_, p) / q(ii, if_, P + p) - 1.0) / ia
            else:
                fwd = _lift(T, 0.0, 0.0, 0.0)
            rate = fwd + spr
            if flags & CAP_FLOOR:
                if rate.v < flo:
                    rate = _lift(T, flo, 0.0, 0.0)
                elif rate.v > cap:
                    rate = _lift(T, cap, 0.0, 0.0)
            cf = (rate * pa) * notl + (principal if p == P - 1 else 0.0)
            total = total + (sign * cf) * (q(di, df, p) / dval)
        if flags & NOTIONAL_EXCHANGE:
            for e, (ext, amt) in enumerate(((eff, -nx), (matt, nx))):
                if ext >= vt:
                    total = total + (sign * amt) * (q(di, df, P + 1 + e)
                                                   / dval)
        leg_sink(s, total)


def stage_dir(h: dict, d: int, row):
    """Direction ``d`` of K8 / K10 as (kind, index, tangent row): a basis
    spread, a leg PV, else the foreign tangent ``row``."""
    S, npv = h["S"], h["npv"]
    if d < S:
        return (DIR_SPREAD, d, None)
    if d < S + npv:
        return (DIR_PV, d - S, None)
    return (DIR_ROW, 0, row)


def _dir_key(d):
    """What decides a direction's operation counts: its kind and index,
    or which entries of its tangent row are nonzero."""
    if d[0] == DIR_ROW:
        return (DIR_ROW, np.flatnonzero(np.asarray(d[2])).tobytes())
    return d[:2]


def needed_flops(name: str, tab: XccyStageTables, *args) -> dict:
    """The f64 operations of kernel ``name`` (K8-K11) on
    ``kernels.<name>(tab, *args)``'s inputs, counted by running
    :func:`thread_stage` / :func:`thread_legs` in :class:`Dual` and
    :class:`HyperDual` (their ``ops``) on scenario 0 of every member,
    times the scenarios:

    - ``needed``: what the function needs, a forward-mode evaluation that
      computes nothing twice: the primal once a (scenario, member), each
      direction's first tangent once (and, K10 / K11, each grid entry's
      for the gradient), each pair i <= j's e1 e2 part once (K10 / K11,
      with the sum over the cotangents);
    - ``threads``: what the kernel's threads compute, each thread its
      primal and first tangents again.
    """
    h = tab.host()
    a = [x.cpu().numpy() if isinstance(x, torch.Tensor) else x
         for x in args]
    Sc = a[0].shape[0]
    none = (DIR_NONE, 0, None)
    need = threads = 0
    for g in range(tab.G):
        if name in ("xccy_stage_jvp", "xccy_stage_hess"):
            sp, pv, fd, tf = (x[0, g] if x is not None and k < 3 else x
                              for k, x in enumerate(a[:4]))
            dirs = [stage_dir(h, d, None if tf is None else tf[0, d, g])
                    for d in range(tab.D)]
            grid = h["Lf"] if tab.recal else 0
            cot = a[4][0, g] if name == "xccy_stage_hess" else None

            def run(T, d1, d2):
                out = [T(0.0)]

                def sink(w, v):
                    if cot is not None:
                        out[0] = out[0] + v * float(cot[w])
                thread_stage(T, h, g, sp, pv, fd, d1, d2, sink)
        else:
            dd, tdl = a[0][0, g], a[1]
            dirs = [(DIR_ROW, 0, tdl[0, d, g]) for d in range(tab.Qd)]
            grid = h["Ld"]
            cot = a[2][0, g] if name == "xccy_legs_hess" else None

            def run(T, d1, d2):
                out = [T(0.0)]

                def sink(s, v):
                    if cot is not None:
                        out[0] = out[0] + v * float(cot[s])
                thread_legs(T, h, g, dd, d1, d2, sink)
        memo = {}

        def count(T, d1, d2):
            key = (T, _dir_key(d1), _dir_key(d2))
            if key not in memo:
                T.ops = [0] * len(T.ops)
                run(T, d1, d2)
                memo[key] = list(T.ops)
            return memo[key]
        firsts = [count(Dual, d, none) for d in dirs]
        need += count(Dual, none, none)[0] + sum(c[1] for c in firsts)
        if cot is None:
            threads += sum(sum(c) for c in firsts)
            continue
        grads = [count(Dual, (DIR_UNIT, ll, None), none)
                 for ll in range(grid)]
        pairs = [count(HyperDual, dirs[i], dirs[j])
                 for i, j in pair_table(len(dirs))]
        need += sum(c[1] for c in grads) + sum(c[3] for c in pairs)
        threads += sum(sum(c) for c in grads + pairs)
    return dict(needed=float(Sc * need), threads=float(Sc * threads))
