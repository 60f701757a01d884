"""The OIS stage of the structured risk pass on K13 and K14.

An OIS stage of the batched curve graph (``parallel/curve_batching``:
the bootstrap ``ois_native_ds`` over ``ops/bootstrap.bootstrap_ois`` and
its rows ``stage_rows``) is differentiated by the structured split
(``parallel/structured_risk``) along its Qp local quotes in region A
(``fwd_delta`` pass 1) and to the second order in region C2
(``term2_ois``). On the card both come from two hand-written kernels
(``csrc/ois_stage.cu``), a block of ``WARPS`` warps a (scenario,
member), its threads first taking a point each for the primal rate and
1 / denom (:func:`point_prims`):

- K13 ``ois_stage_jvp``: the native DFs ds [Sc, G, P1], their tangents
  dds [Sc, Qp, G, P1] along the Qp unit quote directions, the rows
  [Sc, G, W] and their tangents drows [Sc, Qp, G, W]. A lane of the
  first warp takes a direction (tiles of 32 where Qp > 32) and walks the
  chain's P points in order in dual numbers (:func:`lane_chain`): the
  point's rate (a pillar's quote, or the sub-pillar rate log-linear in
  the quotes with the 1e-8 clamp, or linear where any quote of the
  member is <= 0), denom = 1 + r a, b = a / denom, pv01 = b + pv01_prev
  / denom and df = (1 - r pv01_prev) / denom, each quotient a product
  by 1 / denom, every link pointing backward; then the block's threads
  take the rows, each row's value once and its tangents from its one or
  two nodes (``csrc/stage_rows.cuh`` ``row_val``, shared with K8 / K10).
- K14 ``ois_stage_hess``: Hs [Sc, Qp, G, Qp], the Hessian over the local
  quotes of psi = sum g . rows + sum v . ds (g the aggregate cotangent
  on the stage's rows, v the XCCY chain cotangents on its native DFs),
  forward over reverse, split at the node DFs. Once a (scenario,
  member) the warps sum the node cotangent w = R'(ds)' g + v and the
  band B = sum_w g_w R_w''(ds) over the rows (a row reads at most two
  nodes), a lane a row in chunks of 32 (:func:`node_band`). Then a lane
  of the first warp a direction d runs the dual chain along e_d (its
  node tangents ds') and the chain's adjoint in reverse point order in
  dual numbers (:func:`lane_adjoint`), seeded with w + B ds'; the
  adjoint of the quotes is row d of Hs (``jvp(grad(psi))``, as the JAX
  package takes it). Hs is symmetric up to rounding only.

:class:`OisStageTables` packs one stage's static data into flat
contiguous f64 / int32 tensors once, when the book's device tables are
built (``P["ostage"]``), beside the stage's device ``bat`` entry and
row plan, which the plain versions read: ``torch.func`` over
``ois_native_ds`` and ``stage_rows``, the towers the structured pass ran
before (and runs for a stage off the route). :func:`ois_stage_route`
says which stages take the kernels: an OIS stage whose members are all
on the simple schemes (``xccy_stage.SCHEME_CODE``), with at most
``MAX_P`` points, ``MAX_Q`` quotes and ``MAX_W`` rows a member and a
plan whose links all point backward; an inflation stage, a fitted
member or a larger plan keeps ``torch.func``.

:func:`emulate_jvp` / :func:`emulate_hess` run the kernels' lanes in
Python (``xccy_stage.Dual``) in the kernels' order of operations (but
for the card's fused multiply-adds); the CPU tests hold them to
``torch.func`` and count the f64 operations the functions need on them
(:func:`needed_flops`).

Hazard: any change to ``bootstrap_ois`` (its rates, its 1e-8 clamp, the
switch to linear space, the chain), to ``ois_native_ds``'s pad sentinel
or to the simple row schemes must also be made in ``csrc/ois_stage.cu``
and in the emulation here; the plain versions follow the library by
construction, the kernels do not.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Sequence

import numpy as np
import torch

from ..utils.error import LibError
from ..utils.global_types import InterpTypes
from .xccy_stage import (SCHEME_CODE, Dual, _pack_rows, _row_bands,
                         row_terms)

# the most points, quotes and rows a member of a stage on the kernels has
# (csrc/ois_stage.cu kMaxP, kMaxQ, kMaxW): K14's block keeps three dual
# tangents a point and lane and a quote row a lane in shared memory
MAX_P = 192
MAX_Q = 64
MAX_W = 1 << 16
# the rate floor of the log-linear sub-pillar rates (ops/bootstrap.py)
RATE_FLOOR = 1e-8
# a block's warps (csrc/ois_stage.cu kWarps): K14's node band takes the
# rows' chunks in turn
WARPS = 4


def ois_stage_route(st, its: Sequence[InterpTypes], b: dict) -> str:
    """"kernels" when stage ``st`` (``curve_batching._Stage``, its members
    on ``its``, its host ``bat`` entry ``b``) runs on K13 / K14, else
    "torch.func: " and why: an inflation stage, a fitted member scheme,
    more points, quotes or rows than the kernels' arrays hold, or a plan
    whose links do not all point backward."""
    if st.kind != "ois":
        return "torch.func: an inflation stage"
    fitted = sorted({it.name for it in its if it not in SCHEME_CODE})
    if fitted:
        return "torch.func: a fitted member scheme (" + ", ".join(fitted) \
            + ")"
    p = b["plan"]
    P = int(np.asarray(p.point_times).shape[-1])
    Qp = int(np.asarray(b["qidx"]).shape[-1])
    W = max(_width(b[k]) for k in ("row_plan", "row_plan_keep") if k in b)
    if P > MAX_P or Qp > MAX_Q or W > MAX_W:
        return (f"torch.func: {P} points / {Qp} quotes / {W} rows exceed "
                f"the kernels' {MAX_P} / {MAX_Q} / {MAX_W}")
    prev = np.asarray(p.prev_idx).reshape(-1, P)
    if (prev >= np.arange(P)).any():
        return ("torch.func: OIS plan: a point's previous point does not "
                "precede it")
    return "kernels"


def ois_stage_routes(topo) -> Dict[int, str]:
    """{stage index: :func:`ois_stage_route`} for every OIS and inflation
    stage of a ``StageTopology``, decided once when the book compiles."""
    return {si: ois_stage_route(st, [topo.specs[c].interp_type
                                     for c in st.ids], topo.bat[st.key])
            for si, st in enumerate(topo.stages) if st.kind != "xccy"}


def _width(row_plan: dict) -> int:
    """A host row plan's rows a member."""
    return int(np.asarray(next(v for k, v in row_plan.items()
                               if k in InterpTypes.__members__)["i0"])
               .shape[-1])


@dataclasses.dataclass(frozen=True, eq=False)
class OisStageTables:
    """One OIS stage's static data for K13 / K14, flat and contiguous on
    the book's device (f64 and int32; [G, ...] member-major):

    - the chain ``pt_f`` [G, P, 2] (accrual, sub-pillar rate weight c)
      and ``pt_i`` [G, P, 4] (previous point or -1, pillar or -1, the
      rate bracket i0, i1), its children ``ch_ptr`` [G, P + 1] / ``ch_pt``
      [G, NC] (the points whose previous point each is, ascending: the
      adjoint gathers a point's cotangent from them), ``pad`` [G, P1] 1
      at a pad node (DF 1, no derivative) and ``log`` the stage's
      log-linear rates switch;
    - the rows (``xccy_stage._pack_rows``: ``rq_i`` [G, W, 3], ``rq_f``
      [G, W, 2], ``r_sch`` [G], ``r_xs`` [G, P1]), the band's entries
      (``xccy_stage._row_bands``' ``mb_pq`` [G, E, 2], the node pairs p <
      q that a row brackets), each row's entry ``r_e`` [G, W] (-1 where
      it reads one node) and each node's entries ``nb_ptr`` [G, P1 + 1] /
      ``nb_e`` [G, NE] (K14's B ds');
    - the plain versions' inputs: the stage's device ``bat`` entry ``b``,
      its row plan ``rp`` and its members' schemes ``its``.

    ``cache`` holds the kernels' argument block."""
    G: int
    P: int
    P1: int
    Qp: int
    W: int
    E: int
    log: bool
    pt_f: torch.Tensor
    pt_i: torch.Tensor
    ch_ptr: torch.Tensor
    ch_pt: torch.Tensor
    pad: torch.Tensor
    rq_i: torch.Tensor
    rq_f: torch.Tensor
    r_sch: torch.Tensor
    r_xs: torch.Tensor
    mb_pq: torch.Tensor
    r_e: torch.Tensor
    nb_ptr: torch.Tensor
    nb_e: torch.Tensor
    b: dict
    rp: dict
    its: tuple
    cache: dict = dataclasses.field(default_factory=dict, init=False,
                                    repr=False)

    def host(self) -> dict:
        """The packed tables as numpy arrays, with ``U1`` = P1 (the
        emulation's and ``xccy_stage``'s row helpers' input)."""
        out = {f.name: (getattr(self, f.name).cpu().numpy()
                        if isinstance(getattr(self, f.name), torch.Tensor)
                        else getattr(self, f.name))
               for f in dataclasses.fields(self)
               if f.name not in ("cache", "b", "rp", "its")}
        out["U1"] = self.P1
        return out


def _children(prev: np.ndarray):
    """(ch_ptr [G, P + 1], ch_pt [G, NC]): each point's children in
    ascending order."""
    G, P = prev.shape
    ptr = np.zeros((G, P + 1), dtype=np.int32)
    lists = []
    for g in range(G):
        kids = [[] for _ in range(P)]
        for i in range(P):
            if prev[g, i] >= 0:
                kids[int(prev[g, i])].append(i)
        ptr[g, 1:] = np.cumsum([len(k) for k in kids])
        lists.append([i for k in kids for i in k])
    flat = np.zeros((G, max(1, max(len(x) for x in lists))), dtype=np.int32)
    for g, x in enumerate(lists):
        flat[g, :len(x)] = x
    return ptr, flat


def _node_bands(pq: np.ndarray, U1: int):
    """(nb_ptr [G, U1 + 1], nb_e [G, NE]): the band entries of
    ``_row_bands``' pairs pq [G, E, 2] that touch each node, in entry
    order (a member's pad entries (0, 0) touch none)."""
    G, E = pq.shape[:2]
    ptr = np.zeros((G, U1 + 1), dtype=np.int32)
    lists = []
    for g in range(G):
        at = [[] for _ in range(U1)]
        for e in range(E):
            p, q = int(pq[g, e, 0]), int(pq[g, e, 1])
            if p != q:
                at[p].append(e)
                at[q].append(e)
        ptr[g, 1:] = np.cumsum([len(x) for x in at])
        lists.append([e for x in at for e in x])
    flat = np.zeros((G, max(1, max(len(x) for x in lists))), dtype=np.int32)
    for g, x in enumerate(lists):
        flat[g, :len(x)] = x
    return ptr, flat


def stage_tables(st, its: Sequence[InterpTypes], b: dict, row_plan: dict,
                 bd: dict, rp: dict, device) -> OisStageTables:
    """One OIS stage's :class:`OisStageTables` on ``device`` from its host
    ``bat`` entry ``b`` and the host row plan the structured pass
    evaluates (keep-compact or full), with the device forms ``bd`` (of
    ``b``) and ``rp`` (of the row plan) the plain versions read. Raises
    LibError for a stage off the route (:func:`ois_stage_route`)."""
    route = ois_stage_route(st, its, b)
    if route != "kernels":
        raise LibError("OIS stage tables: the stage keeps " + route)
    p = b["plan"]
    G, P = np.asarray(p.point_times).shape
    pad_mask = np.asarray(b["pad_mask"], dtype=bool)
    P1 = pad_mask.shape[-1]
    Qp = int(np.asarray(b["qidx"]).shape[-1])
    prev = np.asarray(p.prev_idx, dtype=np.int64)
    pt_f = np.stack([np.asarray(p.accs, dtype=np.float64),
                     np.asarray(p.rate_c, dtype=np.float64)], axis=-1)
    pt_i = np.stack([prev, np.asarray(p.pillar_idx), np.asarray(p.rate_i0),
                     np.asarray(p.rate_i1)], axis=-1)
    ch_ptr, ch_pt = _children(prev)
    rq_i, rq_f, r_xs = _pack_rows(its, row_plan, P1)
    _, _, mb_pq, mb_ptr, mb_row = _row_bands(rq_i, P1)
    r_e = np.full(rq_i.shape[:2], -1, dtype=np.int32)
    for g in range(G):
        for e in range(mb_pq.shape[1]):
            r_e[g, mb_row[g, mb_ptr[g, e]:mb_ptr[g, e + 1]]] = e
    nb_ptr, nb_e = _node_bands(mb_pq, P1)

    def f64(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.float64),
                               device=device)

    def i32(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32),
                               device=device)

    return OisStageTables(
        G=int(G), P=int(P), P1=int(P1), Qp=Qp, W=int(rq_i.shape[1]),
        E=int(mb_pq.shape[1]), log=bool(p.loglinear_rates),
        pt_f=f64(pt_f), pt_i=i32(pt_i), ch_ptr=i32(ch_ptr), ch_pt=i32(ch_pt),
        pad=i32(pad_mask), rq_i=i32(rq_i), rq_f=f64(rq_f),
        r_sch=i32([SCHEME_CODE[it] for it in its]), r_xs=f64(r_xs),
        mb_pq=i32(mb_pq), r_e=i32(r_e), nb_ptr=i32(nb_ptr), nb_e=i32(nb_e),
        b=bd, rp=rp, its=tuple(its))


# ---------------------------------------------------------------------------
# the plain versions: torch.func over ois_native_ds and stage_rows
# ---------------------------------------------------------------------------


def _forward(tab: OisStageTables):
    """The stage's forward on its device tables: local quotes [G, Qp] ->
    (native DFs [G, P1], rows [G, W])."""
    from ..parallel.curve_batching import ois_native_ds, stage_rows

    def fwd(r):
        ds = ois_native_ds(r, tab.b)
        return ds, stage_rows(ds, tab.its, tab.rp)
    return fwd


def ois_stage_jvp_plain(tab: OisStageTables, q: torch.Tensor):
    """Plain version of K13: (ds [Sc, G, P1], rows [Sc, G, W], dds
    [Sc, Qp, G, P1], drows [Sc, Qp, G, W]) from the local quotes q
    [Sc, G, Qp] (``structured_risk.tower_jvp`` over the stage's
    forward)."""
    from ..parallel.structured_risk import tower_jvp
    return tower_jvp(_forward(tab), q)


def ois_stage_hess_plain(tab: OisStageTables, q: torch.Tensor,
                         gs: torch.Tensor, vs: torch.Tensor) -> torch.Tensor:
    """Plain version of K14: Hs [Sc, Qp, G, Qp], the Hessian of psi(x) =
    sum(gs * rows(x)) + sum(vs * ds(x)) at the local quotes q [Sc, G, Qp]
    (gs [Sc, G, W], vs [Sc, G, P1]; ``structured_risk.tower_hess``)."""
    from ..parallel.structured_risk import tower_hess
    return tower_hess(_forward(tab), q, gs, vs)


# ---------------------------------------------------------------------------
# the kernels' lanes in Python, in their order of operations
# ---------------------------------------------------------------------------


def _zero():
    return Dual(0.0)


def quote_logs(q):
    """(lq, iq, pos): log(max(q, 1e-8)) of each quote, 1 / q where q >=
    1e-8 (else 0: the clamp passes no tangent) and whether every quote is
    > 0 (the block's prologue)."""
    return ([math.log(max(x, RATE_FLOOR)) for x in q],
            [1.0 / x if x >= RATE_FLOOR else 0.0 for x in q],
            all(x > 0.0 for x in q))


def point_prims(h: dict, g: int, q, lq, logr: bool) -> list:
    """Each point's primal rate rv and iv = 1 / (1 + rv a), [(rv, iv)]:
    a pillar's quote, else the sub-pillar rate, exp of the log-linear
    one where ``logr`` (the stage's rates log-linear and every quote of
    the member > 0), else the linear one (the block's threads take a
    point each before the chains, so the chains and adjoints divide and
    exponentiate nothing)."""
    out = []
    for p in range(h["P"]):
        _, pil, i0, i1 = (int(x) for x in h["pt_i"][g, p])
        a, c = (float(x) for x in h["pt_f"][g, p])
        if pil >= 0:
            r = Dual(q[pil])
        elif logr:
            y0 = Dual(lq[i0])
            r = (y0 + c * (Dual(lq[i1]) - y0)).exp()
        else:
            y0 = Dual(q[i0])
            r = y0 + c * (Dual(q[i1]) - y0)
        out.append((r.v, (1.0 / (1.0 + r * a)).v))
    return out


def lane_rate(h: dict, g: int, p: int, iq, logr: bool, d: int,
              rv: float) -> Dual:
    """Point p's rate of member g along the unit quote direction d, its
    primal rv: the tangent 1 where d is its pillar's quote; else the
    sub-pillar rate's, rv (y0 + c (y1 - y0)) with y_k = 1 / q_k where d is
    quote i_k above the 1e-8 clamp (``iq``) for the log-linear rates, y_k
    = [d = i_k] for the linear ones."""
    _, pil, i0, i1 = (int(x) for x in h["pt_i"][g, p])
    c = float(h["pt_f"][g, p, 1])
    if pil >= 0:
        return Dual(rv, 1.0 if d == pil else 0.0)
    if logr:
        y0 = iq[i0] if d == i0 else 0.0
        y1 = iq[i1] if d == i1 else 0.0
        e = rv * (y0 + c * (y1 - y0))
    else:
        y0 = 1.0 if d == i0 else 0.0
        y1 = 1.0 if d == i1 else 0.0
        e = y0 + c * (y1 - y0)
    Dual._count(0, 4 if e != 0.0 else 0)
    return Dual(rv, e)


def _inv(den: Dual, iv: float) -> Dual:
    """1 / den as a Dual from its primal iv: (iv, -(den' iv) iv)."""
    Dual._count(0, 2 if den.e != 0.0 else 0)
    return Dual(iv, -(den.e * iv) * iv)


def lane_chain(h: dict, g: int, q, d: int):
    """Lane d's dual chain of member g at the local quotes q [Qp]: per
    point its (rate, denom, pv01_prev, pv01, df, b, 1 / denom) Duals in
    point order, every link pointing backward, with denom = 1 + r a, b =
    a / denom, pv01 = b + pv01_prev / denom, df = (1 - r pv01_prev) /
    denom, each quotient a product by 1 / denom (:func:`point_prims`' iv
    and its tangent); the node tangents follow (pad nodes DF 1 with no
    tangent)."""
    q = [float(x) for x in q]
    lq, iq, pos = quote_logs(q)
    logr = bool(h["log"]) and pos
    prims = point_prims(h, g, q, lq, logr)
    pts = []
    for p in range(h["P"]):
        prev = int(h["pt_i"][g, p, 0])
        a = float(h["pt_f"][g, p, 0])
        rv, iv = prims[p]
        r = lane_rate(h, g, p, iq, logr, d, rv)
        den = 1.0 + r * a
        inv = _inv(den, iv)
        b = a * inv
        pp = pts[prev][3] if prev >= 0 else _zero()
        pv = b + pp * inv
        df = (1.0 - r * pp) * inv
        pts.append((r, den, pp, pv, df, b, inv))
    return pts


def lane_nodes(h: dict, g: int, pts) -> list:
    """The node DFs [P1] of a lane's chain as Duals: the t = 0 node 1, a
    pad node 1, else the point's df."""
    return [Dual(1.0)] + [Dual(1.0) if h["pad"][g, p + 1] else pts[p][4]
                          for p in range(h["P"])]


def node_band(h: dict, g: int, ds, gs, vs):
    """K14's once-a-(scenario, member) sums at the primal node DFs ds
    [P1] (floats, or Duals to count the operations): (w [P1], md [P1],
    mo [E]) with w = R'(ds)' gs + vs the node cotangent and (md, mo) the
    band B = sum_w gs_w R_w''(ds). The rows go in chunks of 32, chunk i to
    warp i % ``WARPS``, a lane a row, each row's terms once
    (``row_terms``); a chunk's terms add to the warp's part of each sum
    by :func:`_group_add`, tap 0's, then tap 1's, then the band entries';
    each sum is then its warps' parts in warp order. So the work is the
    same in every lane however the rows crowd onto a node."""
    U1, W, E = h["U1"], h["W"], h["E"]
    parts = [([0.0] * U1, [0.0] * U1, [0.0] * E) for _ in range(WARPS)]
    for w0 in range(0, W, 32):
        pw, pm, po = parts[(w0 // 32) % WARPS]
        lanes = [[(-1, 0.0, 0.0)] * 32 for _ in range(3)]   # tap 0, 1, band
        for lane, r in enumerate(range(w0, min(w0 + 32, W))):
            gw = float(gs[r])
            t = row_terms(h, g, r, ds)
            if t is None:
                lanes[0][lane] = (int(h["rq_i"][g, r, 2]), gw, 0.0)
                continue
            v, v1, v2, taps = t
            for k, (u, du, d2u) in enumerate(taps):
                lanes[k][lane] = (u, gw * (v1 * du),
                                  gw * (v2 * (du * du) + v1 * d2u))
            if len(taps) > 1:
                lanes[2][lane] = (int(h["r_e"][g, r]),
                                  gw * (v2 * (taps[0][1] * taps[1][1])),
                                  0.0)
        for terms, sx, sy in zip(lanes, (pw, pw, po), (pm, pm, None)):
            _group_add(terms, sx, sy)

    def total(i, n):
        out = []
        for k in range(n):
            s = parts[0][i][k]
            for p in parts[1:]:
                s = s + p[i][k]
            out.append(s)
        return out
    return ([x + float(vs[u]) for u, x in enumerate(total(0, U1))],
            total(1, U1), total(2, E))


def _group_add(terms, sx, sy):
    """One chunk's terms [(key, x, y)] a lane (key -1: none), as the
    kernel's warp adds them: each run of lanes with one key sums its
    terms by a segmented inclusive scan (at offsets 1, 2, 4, 8, 16 a lane
    adds the partial sum of the lane that far below it, inside its run),
    then the run's sum is added to sx[key] (and sy[key]); several runs of
    one key first sum theirs in lane order."""
    n = len(terms)
    keys = [k for k, _, _ in terms]
    x = [v for _, v, _ in terms]
    y = [v for _, _, v in terms]
    start = [0] * n
    for lane in range(1, n):
        start[lane] = lane if keys[lane - 1] != keys[lane] \
            else start[lane - 1]
    off = 1
    while off < n:
        x0, y0 = list(x), list(y)
        for lane in range(n):
            if lane - off >= start[lane]:
                x[lane] = x0[lane - off] + x0[lane]
                y[lane] = y0[lane - off] + y0[lane]
        off *= 2
    acc = {}
    for lane in range(n):
        k = keys[lane]
        if k < 0 or (lane + 1 < n and keys[lane + 1] == k):
            continue
        acc[k] = ((acc[k][0] + x[lane], acc[k][1] + y[lane]) if k in acc
                  else (x[lane], y[lane]))
    for k, (a, b) in acc.items():
        sx[k] = sx[k] + a
        if sy is not None:
            sy[k] = sy[k] + b


def lane_adjoint(h: dict, g: int, q, d: int, pts, w, md, mo) -> list:
    """Lane d's adjoint of member g's chain in reverse point order in
    dual numbers, seeded on each live node with (w_u, (B ds')_u), B ds' =
    md_u ds'_u + sum of mo_e ds'_partner over the node's band entries:
    each point's df-bar, then its pv01-bar gathered from its children's
    pv01_prev-bars, then the adjoints of df = (1 - r pp) / den, pv01 = b
    + pp / den (pv01-bar / den is both pp's and b's share), b = a / den
    and den = 1 + r a, each quotient a product by 1 / den, and the rate's
    to its one or two quotes. Returns the quotes' adjoint tangents [Qp],
    row d of Hs."""
    q = [float(x) for x in q]
    _, iq, pos = quote_logs(q)
    logr = bool(h["log"]) and pos
    P = h["P"]
    dsd = [0.0] + [0.0 if h["pad"][g, p + 1] else pts[p][4].e
                   for p in range(P)]
    qb = [0.0] * h["Qp"]
    ppb = [None] * P
    for p in range(P - 1, -1, -1):
        u = p + 1
        prev = int(h["pt_i"][g, p, 0])
        a = float(h["pt_f"][g, p, 0])
        r, _, pp, _, df, b, inv = pts[p]
        if h["pad"][g, u]:
            dfb = _zero()
        else:
            t = md[u] * dsd[u]
            for k in range(h["nb_ptr"][g, u], h["nb_ptr"][g, u + 1]):
                e = int(h["nb_e"][g, k])
                pe, qe = (int(x) for x in h["mb_pq"][g, e])
                t = t + mo[e] * dsd[qe if pe == u else pe]
            dfb = Dual(w[u], t)
        pvb = _zero()
        for k in range(h["ch_ptr"][g, p], h["ch_ptr"][g, p + 1]):
            pvb = pvb + ppb[int(h["ch_pt"][g, k])]
        numb = dfb * inv
        denb = -(numb * df)
        rb = -(numb * pp)
        ppb_p = -(numb * r)
        pvd = pvb * inv
        ppb_p = ppb_p + pvd
        denb = denb - pvd * (pp * inv)
        denb = denb - pvd * b
        rb = rb + denb * a
        ppb[p] = ppb_p if prev >= 0 else None
        _rate_adjoint(h, g, p, q, iq, logr, d, r, rb, qb)
    return qb


def _rate_adjoint(h, g, p, q, iq, logr, d, r, rb, qb):
    """The rate's adjoint rb (a :class:`Dual`) to its quotes' adjoint
    tangents qb (in place): a pillar's quote; the linear rate's two
    quotes at weights 1 - c and c; the log-linear rate's through L = log
    r, each quote's share s over its value where the clamp lets it
    through: the tangent of s / q_i, (s' - (s iq_i) [d = i]) iq_i."""
    _, pil, i0, i1 = (int(x) for x in h["pt_i"][g, p])
    c = float(h["pt_f"][g, p, 1])
    if pil >= 0:
        qb[pil] += rb.e
        return
    if logr:
        Lb = rb * r
        s1 = Lb * c
        s0 = Lb - s1
        for i, s in ((i0, s0), (i1, s1)):
            if q[i] >= RATE_FLOOR:
                Dual._count(0, 3 if d == i else 1)
                qb[i] += (s.e - (s.v * iq[i] if d == i else 0.0)) * iq[i]
        return
    s1 = rb * c
    qb[i1] += s1.e
    qb[i0] += (rb - s1).e


def emulate_jvp(tab: OisStageTables, q: torch.Tensor):
    """K13's lanes in Python: (ds [Sc, G, P1], rows [Sc, G, W], dds [Sc,
    Qp, G, P1], drows [Sc, Qp, G, W]) as numpy arrays, each direction's
    dual chain, then the rows' values and their tangents from their
    nodes' (``xccy_stage.row_terms``)."""
    h = tab.host()
    qn = q.detach().cpu().numpy()
    Sc, G, Qp, P1, W = qn.shape[0], tab.G, tab.Qp, tab.P1, tab.W
    ds = np.zeros((Sc, G, P1))
    rows = np.zeros((Sc, G, W))
    dds = np.zeros((Sc, Qp, G, P1))
    drows = np.zeros((Sc, Qp, G, W))
    for sc in range(Sc):
        for g in range(G):
            J = []
            for d in range(Qp):
                nd = lane_nodes(h, g, lane_chain(h, g, qn[sc, g], d))
                J.append([x.e for x in nd])
            v = [x.v for x in nd]
            ds[sc, g] = v
            dds[sc, :, g] = J
            for w in range(W):
                t = row_terms(h, g, w, v, second=False)
                if t is None:
                    kn = int(h["rq_i"][g, w, 2])
                    rows[sc, g, w] = v[kn]
                    drows[sc, :, g, w] = [J[d][kn] for d in range(Qp)]
                    continue
                val, v1, _, taps = t
                rows[sc, g, w] = val
                cs = [(u, v1 * du) for u, du, _ in taps]
                for d in range(Qp):
                    x = cs[0][1] * J[d][cs[0][0]]
                    if len(cs) > 1:
                        x = x + cs[1][1] * J[d][cs[1][0]]
                    drows[sc, d, g, w] = x
    return ds, rows, dds, drows


def emulate_hess(tab: OisStageTables, q: torch.Tensor, gs: torch.Tensor,
                 vs: torch.Tensor) -> np.ndarray:
    """K14's lanes in Python: Hs [Sc, Qp, G, Qp] as a numpy array, the
    node band once a (scenario, member), then each direction's dual chain
    and its adjoint."""
    h = tab.host()
    qn = q.detach().cpu().numpy()
    gn, vn = gs.detach().cpu().numpy(), vs.detach().cpu().numpy()
    Sc, G, Qp = qn.shape[0], tab.G, tab.Qp
    Hs = np.zeros((Sc, Qp, G, Qp))
    for sc in range(Sc):
        for g in range(G):
            band = None
            for d in range(Qp):
                pts = lane_chain(h, g, qn[sc, g], d)
                if band is None:
                    ds = [x.v for x in lane_nodes(h, g, pts)]
                    band = node_band(h, g, ds, gn[sc, g], vn[sc, g])
                Hs[sc, d, g] = lane_adjoint(h, g, qn[sc, g], d, pts, *band)
    return Hs


# ---------------------------------------------------------------------------
# what the functions need: operations and bytes
# ---------------------------------------------------------------------------


def needed_flops(name: str, tab: OisStageTables, *args) -> float:
    """The f64 operations kernel ``name`` (K13 ``ois_stage_jvp``, K14
    ``ois_stage_hess``) needs on ``kernels.<name>(tab, *args)``'s inputs,
    counted by :class:`Dual` on the lanes of scenario 0 of every member,
    times the scenarios: the chain's primal once a (scenario, member) and
    each direction's tangent parts once; K13 the rows' primals once and
    each direction's row tangent (one product a tap and the sum of two);
    K14 the node band once and each direction's adjoint (its primal parts
    once, its tangent parts a direction)."""
    h = tab.host()
    qn = args[0].detach().cpu().numpy()
    Sc = qn.shape[0]
    total = 0
    for g in range(tab.G):
        prim = tan = 0
        for d in range(tab.Qp):
            Dual.ops = [0, 0]
            pts = lane_chain(h, g, qn[0, g], d)
            prim, tan = Dual.ops[0], tan + Dual.ops[1]
        ds = [x.v for x in lane_nodes(h, g, pts)]
        Dual.ops = [0, 0]
        if name == "ois_stage_jvp":
            for w in range(tab.W):
                t = row_terms(h, g, w, [Dual(x) for x in ds], second=False)
                if t is not None:
                    tan += tab.Qp * (2 * len(t[3]) - 1) + len(t[3])
            prim += Dual.ops[0]
        else:
            gs = args[1].detach().cpu().numpy()[0, g]
            vs = args[2].detach().cpu().numpy()[0, g]
            band = node_band(h, g, [Dual(x) for x in ds], gs, vs)
            prim += Dual.ops[0]
            w, md, mo = ([float(getattr(x, "v", x)) for x in part]
                         for part in band)
            adj_prim = 0
            for d in range(tab.Qp):
                Dual.ops = [0, 0]
                lane_adjoint(h, g, qn[0, g], d, lane_chain(h, g, qn[0, g],
                                                          d), w, md, mo)
                ops_d = list(Dual.ops)
                Dual.ops = [0, 0]
                lane_chain(h, g, qn[0, g], d)
                adj_prim = ops_d[0] - Dual.ops[0]
                tan += ops_d[1] - Dual.ops[1]
            prim += adj_prim
        total += prim + tan
    Dual.ops = [0, 0]
    return float(Sc * total)


# the tables each kernel reads
_READS = dict(
    ois_stage_jvp=("pt_f", "pt_i", "pad", "rq_i", "rq_f", "r_sch", "r_xs"),
    ois_stage_hess=("pt_f", "pt_i", "pad", "ch_ptr", "ch_pt", "rq_i",
                    "rq_f", "r_sch", "r_xs", "mb_pq", "r_e", "nb_ptr",
                    "nb_e"))


def needed_bytes(name: str, tab: OisStageTables, *args) -> int:
    """The bytes kernel ``name`` must move on ``kernels.<name>(tab,
    *args)``'s inputs, each input read once and each output written once:
    the tables it reads (``_READS``), the quotes (K14 also the row and
    node cotangents) and its outputs (K13 ds, dds, rows, drows; K14
    Hs)."""
    h = tab.host()
    Sc, G, Qp, P1, W = args[0].shape[0], tab.G, tab.Qp, tab.P1, tab.W
    nb = sum(h[k].nbytes for k in _READS[name])
    if name == "ois_stage_jvp":
        io = Qp + (1 + Qp) * (P1 + W)
    else:
        io = Qp + W + P1 + Qp * Qp
    return int(nb + 8 * Sc * G * io)
