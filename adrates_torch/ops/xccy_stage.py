"""The XCCY stage of the structured risk pass on K8-K11, and its
per-trade second-order tensors on K12, K9 and K11.

An XCCY stage of the batched curve graph (``parallel/curve_batching``:
the bootstrap ``xccy_boot_ds``, its rows ``stage_rows`` and the
calibration legs ``xccy_legs_pv``) is differentiated by the structured
split (``parallel/structured_risk``) along D composed directions in
region A and to the second order in region C1. On the card those
derivatives come from four hand-written kernels
(``csrc/xccy_stage.cu``). K8 / K10 evaluate the stage in a scalar type
T: a dual number (value and one tangent) for a directional derivative,
a hyper-dual one (value, e1, e2, e1 e2) for one entry of a Hessian, so
second derivatives are exact with no hand-derived adjoint; K9 / K11 take
the calibration legs' flows' partials:

- K8 ``xccy_stage_jvp``: the native DFs, the rows and the rows'
  directional derivatives along the D directions (basis spreads, the
  calibration legs' PVs and the foreign tangents; the basis alone when
  the parents are held as values);
- K9 ``xccy_legs_jvp``: the legs' PVs and their directional derivatives
  along the domestic parent's jacobian columns;
- K10 ``xccy_stage_hess``: for s(Z, fd) = sum gs . rows, its gradient in
  Z and in the foreign grid and its Hessian in Z, each pair i <= j once
  (written at [i, j] and [j, i]);
- K11 ``xccy_legs_hess``: the same for sum gpv . legs(dd + Zd tdl) over
  the domestic directions and grid.

K9 and K11 split the legs at their flows. Both lift the domestic grid
linearly along tangent rows t_d, so Jpv[d, s] = G_s . t_d and Hl_ij =
t_i' M t_j exactly, G_s = dPV_s/dd and M = sum_s gpv_s d2PV_s/dd2. A
block takes one (scenario, member): it evaluates every flow once
(:func:`leg_flow`: n = sign cf D_pay, its partials in the taps of its
index start, index end and payment DFs and, K11, gpv_s / V_s times its
second partials), sums them onto the domestic grid's rows in static
segments of the host's lists (:func:`_legs_lists`, from the plans
alone), and forms G_s and M_N = sum_s gpv_s / V_s d2N_s/dd2 on its
static support (:func:`legs_prologue`; PV_s = N_s / V_s, the value DF's
coupling folded into U_j = M t_j by :func:`legs_u`); then a dot a
direction (K9) or pair (K11, :func:`legs_pair`). What bounds them is the
chain latency of one block a (scenario, member), not bytes or
operations. Any change to ``pv_float_leg`` or :func:`legs_forward` must
also be made in :func:`leg_flow`, the kernels' ``leg_flow`` and the
lists: a slot the lists leave out gives a wrong Hessian with no error.

K8 and K10 split the stage at its node DFs ds [U1]: the *chain* (the
bootstrap over the chain points, :func:`thread_chain`) ends in ds, and
the *rows* (:func:`thread_rows`) read ds alone. A block takes one
(scenario, member) and a tile of ``TILE`` directions (K10: a pair of
tiles): it runs one dual chain a direction, which gives the nodes'
first tangents J [U1, D], then the rows once. K8 writes the rows'
tangents from J; K10 collapses the rows into a = ds/dds of s and the
band of M = d2s/dds2 (:func:`rows_prologue`: a row reads at most the two
nodes that bracket it), so that a pair thread runs only the chain in
hyper-dual numbers and takes H_ij = sum_u a_u d2ds_u/didj + J_i' M J_j
(:func:`pair_hessian`).

K12 ``xccy_stage_node_hess`` takes the chain with the node DFs as the
sink: ds, their first tangents Jn [D, U1], each pair's second
derivatives Hn [D, D, U1] and, recalibrated, their tangents along each
unit foreign grid entry Jfd [Lf, U1]. A chain of K12 is a warp whose
lanes take the chain points (:func:`warp_chain`): the points' queries,
bases and cashflows at once, then the known payments' sums by swap and
segment and the pillars in rank order, a multiply-add each; a prologue
launch runs the primal chain and a dual chain a direction and a foreign
grid entry once a (scenario, member) and leaves their tables in a
workspace (:func:`node_workspace`), then a warp a pair i <= j, in blocks
of a tile pair of directions, runs its chain in hyper-dual numbers over
them (:func:`node_hess_blocks`). The per-trade tensors
(``parallel/structured_risk.make_pertrade_tensors``) read the rows on
another plan (the full unique-time rows) and meet every trade's own
cotangent G_b, so the rows stay outside the kernel: :func:`node_rows`
takes their first and second derivatives in the nodes (RR; a row reads
at most two nodes) and :func:`node_quads` what those meet (T: Hn and the
products of Jn on the band), so that a trade's Hessian over the stage's
directions is (G_b RR) T = sum_u a_u Hn_u + J' M_b J, K10's split with
the trade's row in place of the scenario's g. A stage takes it
(:func:`pertrade_route`) where it takes K8-K11 and no parent is fitted.

:class:`XccyStageTables` packs one stage's static data into flat
contiguous f64 / int32 tensors, once when the book's device tables are
built; the kernels and the plain versions here read the same tables. The
plain versions are torch on those tables, differentiated by
``torch.func``: the CPU path of the wrappers in ``ops/kernels`` and the
oracle of the kernels' card tests. :func:`thread_stage` and
:func:`thread_legs` are the stage's evaluation written once more in
Python over any scalar type, split as K8 / K10 split it (the chain
with a node sink, as K12 writes its nodes), and
:func:`legs_prologue` / :func:`legs_pair` K9 / K11's split: the tests
run them in (hyper-dual) numpy arithmetic, and the operations the
kernels' functions need (their bounds) and the kernels' own are counted
on them (:func:`needed_flops`).

The bootstrap's solve is forward substitution in chain order: pillar k's
factor x_k = -(pv_k + fxs (v0_k + acc_k)) / d_k, with acc_k the sum of
its known payments' cf base C_seg over the factors C already solved,
which is what the JAX package's Neumann series (``ops/linear_solve``)
converges to; the node DFs and the rows follow in the same pass.

A stage takes the kernels (:func:`stage_route`) when its members'
schemes are simple (``LINEAR_FWD_RATES``, ``FLAT_FWD_RATES``,
``LINEAR_ZERO_RATES``; :func:`kernel_route`), it has at most ``MAX_S``
pillars and ``MAX_U`` nodes (what K8 / K10's shared-memory layout is
sized for) and its plan is one the single forward pass can take; any
other stage keeps the ``torch.func`` route. The route is the stage's
alone: on CPU tensors the wrappers run the plain versions.

A parent on a fitted scheme (PCHIP or a cubic spline) enters the stage
at static queries only: the foreign DFs at the chain points' start, end
and payment times, and the calibration legs' index and discount DFs. So
the stage splits there (:func:`lift_grid`, :func:`pull_grid`): K6
``fitted_eval`` evaluates the parent once a (scenario, member) at each
member's sorted distinct query times, and its tangent mode the parent's
tangent rows there; these form a *query grid* on ``LINEAR_FWD_RATES``
(the identity transform) on which every query is an exact knot, so K8-K11
read exactly the fitted values and run unchanged. Their gradients on the
query grid (K10's gf, K11's gdd) go back to the parent's own grid through
the fitted evaluation's reverse mode (K7 and the transforms' vjp), and the
Hessians take the curvature the linear lift leaves out, sum_q g_q
F''_q[t_i, t_j] along the parent's tangent rows, forward over reverse
(one forward-mode level through ``ops/fitted_rows``).
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

# the most pillars and nodes a stage on the kernels has (csrc/xccy_stage.cu
# kMaxS, kMaxU)
MAX_S = 16
MAX_U = 64

# K8 / K10's launch (csrc/xccy_stage.cu kTile, kBlock, kItems): K8's
# directions a block, the threads of a block, K10's items (pairs, grid
# entries) a block
TILE = 16
BLOCK = 128
ITEMS = 2 * BLOCK

# K12's lanes a chain (a warp; csrc/xccy_stage.cu kLanes), a prologue
# block's item warps (kNodeWarps, beside its primal warp) and a pair
# block's warps (kPairWarps, where a pair block fits two to an SM)
NODE_LANES = 32
NODE_WARPS = 4
PAIR_WARPS = 8
# the longest chain and foreign grid of a stage on K12: its prologue block
# holds the tape, cum and its tangents (up to 25 doubles a chain point at
# S = 16) and the grid's transforms (4 a grid entry) in shared memory
NODE_MAX_N = 512
NODE_MAX_LF = 3000
# the SMs of an H100 SXM, where the mirrors of K12's cut need a card's
H100_SMS = 132

# K9 / K11's threads a block, which are also the flows of a chunk
# (csrc/xccy_stage.cu kLegBlock), and the pairs a <= b of a flow's six
# slots, row-major (spair)
LEG_BLOCK = 256
SLOT_PAIRS = [(a, b) for a in range(6) for b in range(a, 6)]
_PAIR = {ab: k for k, ab in enumerate(SLOT_PAIRS)}
# the most terms of one segment of K9 / K11's sums (a thread's serial sum
# before the segments of a target are added in order)
LEG_SEG = 32

# chain-point flags (pt_i[..., 2]) and the legs' switches (``flags``)
IS_MAT, IS_NOTL, IS_LAST = 1, 2, 4
OVERRIDE_FIRST, NOTIONAL_EXCHANGE, CAP_FLOOR = 1, 2, 4

# direction kinds (csrc/xccy_stage.cu Dir): none, a basis spread, a leg
# PV, a tangent row over the grid, a unit grid entry
DIR_NONE, DIR_SPREAD, DIR_PV, DIR_ROW, DIR_UNIT = 0, 1, 2, 3, 4


def kernel_route(st, its: Sequence[InterpTypes]) -> bool:
    """Whether XCCY stage ``st`` (``curve_batching._Stage``, its members
    on the schemes ``its``) runs on K8-K11: its members' schemes simple
    (its parents on any scheme: a fitted parent through its query
    grid)."""
    return st.kind == "xccy" and all(it in SCHEME_CODE for it in its)


def stage_route(st, its: Sequence[InterpTypes], b: dict) -> str:
    """"kernels" when XCCY stage ``st`` (its members on ``its``, its host
    ``bat`` entry ``b``) runs on K8-K11, else "torch.func: " and why: a
    fitted member scheme, more pillars or nodes than the kernels' arrays
    hold, or a plan the single forward pass cannot take
    (:func:`_chain`)."""
    if not kernel_route(st, its):
        return "torch.func: a fitted member scheme (" + ", ".join(sorted({
            it.name for it in its if it not in SCHEME_CODE})) + ")"
    p = b["plan"]
    S = int(np.asarray(p.mat_pos).shape[-1])
    pad_mask = np.asarray(b["pad_mask"], dtype=bool)
    U1 = pad_mask.shape[-1]
    if S > MAX_S or U1 > MAX_U:
        return (f"torch.func: {S} pillars / {U1} nodes exceed the "
                f"kernels' {MAX_S} / {MAX_U}")
    try:
        _chain(p, pad_mask)
        if st.dom_interp in SCHEME_CODE:
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


def pertrade_route(st, its: Sequence[InterpTypes], b: dict,
                   parents: Sequence[InterpTypes]) -> str:
    """"kernels" when the per-trade second-order tensors of XCCY stage
    ``st`` (its members on ``its``, its host ``bat`` entry ``b``, its
    domestic and foreign parents on ``parents``) come from K12, K9 and
    K11 split at the node DFs (``parallel/structured_risk
    .make_pertrade_tensors``): :func:`stage_route` says "kernels", no
    parent is on a fitted scheme and its chain and foreign grid fit K12's
    prologue block (``NODE_MAX_N`` points, ``NODE_MAX_LF`` entries); else
    "torch.func: " and why (a fitted parent's curvature along its tangent
    rows is not in the split)."""
    route = stage_route(st, its, b)
    if route != "kernels":
        return route
    fitted = sorted({it.name for it in parents if it not in SCHEME_CODE})
    if fitted:
        return ("torch.func: a parent on a fitted scheme ("
                + ", ".join(fitted) + ")")
    n = int(np.asarray(b["plan"].times).shape[-1])
    Lf = int(np.asarray(b["for_ts"]).shape[-1])
    if n > NODE_MAX_N or Lf > NODE_MAX_LF:
        return (f"torch.func: {n} chain points / a foreign grid of {Lf} "
                f"exceed K12's {NODE_MAX_N} / {NODE_MAX_LF}")
    return "kernels"


def pertrade_routes(topo) -> Dict[int, str]:
    """{stage index: :func:`pertrade_route`} for every XCCY stage of a
    ``StageTopology``."""
    return {si: pertrade_route(st, [topo.specs[c].interp_type
                                    for c in st.ids], topo.bat[st.key],
                               (st.dom_interp, st.foreign_interp))
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
    - ``ffit`` / ``dfit``: where the foreign / domestic parent is on a
      fitted scheme, the ``ops/fitted_rows.FittedPlan`` of its query grid
      (each member's sorted distinct query times on its parent's real
      knots), else None; the stage's grid ``fd`` / ``dd`` is then that
      query grid (``Lf`` / ``Ld`` its length), on ``LINEAR_FWD_RATES``
      with every query an exact knot (:func:`lift_grid`);
    - the rows' node and band tables (:func:`_row_bands`; K8 / K10's
      sums over a member's rows): ``nr_ptr`` [G, U1 + 1] / ``nr_row``
      [G, NR] the rows that read each node, and ``mb_pq`` [G, E, 2] the
      entries p < q of M = d2s/dds2 off its diagonal, each with its rows
      ``mb_ptr`` [G, E + 1] / ``mb_row`` [G, NB];
    - ``tp_off`` [G, n + 1]: each chain point's place on K10's tape of
      the primal chain's exps and quotients (:func:`_tape_offsets`);
    - ``nb_ptr`` / ``nb_pt`` / ``nb_pos``: K12's buckets of the known
      payments by swap and segment (:func:`_term_buckets`); ``cum_t``
      [G, S, n] the basis chain's cumulative sums' tangents along the
      spreads (:func:`_cum_tangents`); ``pt_ord`` [G, n] the order in
      which K12's lanes take the chain points (:func:`_lane_order`);
    - K9 / K11's lists over the legs (:func:`_legs_lists`): the rows
      ``lr_row`` / ``lr_of``, the legs' gradient targets ``ls_ptr`` /
      ``ls_row`` / ``lt_leg`` and each row's ``gd_ptr`` / ``gd_t``, M_N's
      entries ``me_rc`` and each row's ``mr_ptr`` / ``mr_e``, and the
      sums' terms ``lt_term`` in segments ``sg`` by chunk ``sc_ptr``,
      each target's ``ts_ptr`` / ``ts_seg``.

    ``D`` is the stage's direction count (2S + Qf recalibrated, S held
    as values), ``npv`` the PV directions (S or 0), ``Qd`` the domestic
    directions. The Hessians' pairs i <= j are the kernels' own
    enumeration (:func:`pair_table` the emulations'). ``cache`` holds the
    kernels' argument block."""
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
    ffit: object
    dfit: object
    E: int
    nr_ptr: torch.Tensor
    nr_row: torch.Tensor
    mb_pq: torch.Tensor
    mb_ptr: torch.Tensor
    mb_row: torch.Tensor
    tp_off: torch.Tensor
    nb_ptr: torch.Tensor
    nb_pt: torch.Tensor
    nb_pos: torch.Tensor
    cum_t: torch.Tensor
    pt_ord: torch.Tensor
    lr_row: torch.Tensor
    lr_of: torch.Tensor
    ls_ptr: torch.Tensor
    ls_row: torch.Tensor
    lt_leg: torch.Tensor
    gd_ptr: torch.Tensor
    gd_t: torch.Tensor
    me_rc: torch.Tensor
    mr_ptr: torch.Tensor
    mr_e: torch.Tensor
    lt_term: torch.Tensor
    sg: torch.Tensor
    sc_ptr: torch.Tensor
    ts_ptr: torch.Tensor
    ts_seg: torch.Tensor
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


def _row_bands(rq_i: np.ndarray, U1: int):
    """The rows' node and band tables from the packed row plans rq_i
    [G, W, 3]: per member, the rows that read each node in row order (an
    exact knot its knot, an interpolated row its one or two bracketing
    nodes) as a CSR (nr_ptr [G, U1 + 1], nr_row [G, NR]); and the pairs
    p < q of distinct nodes that some row brackets, mb_pq [G, E, 2], in
    the order first met, each with its rows (mb_ptr [G, E + 1], mb_row
    [G, NB]). Members pad with entries (0, 0) that no row reaches."""
    G, W = rq_i.shape[:2]
    nodes = [[[] for _ in range(U1)] for _ in range(G)]
    bands = [{} for _ in range(G)]
    for g in range(G):
        for w in range(W):
            i0, i1, kn = (int(x) for x in rq_i[g, w])
            if kn >= 0:
                nodes[g][kn].append(w)
                continue
            nodes[g][i0].append(w)
            if i1 != i0:
                nodes[g][i1].append(w)
                bands[g].setdefault((min(i0, i1), max(i0, i1)), []).append(w)

    def csr(lists, width):
        ptr = np.zeros((G, len(lists[0]) + 1), dtype=np.int32)
        flat = np.zeros((G, width), dtype=np.int32)
        for g, ls in enumerate(lists):
            ptr[g, 1:] = np.cumsum([len(x) for x in ls])
            cat = [w for x in ls for w in x]
            flat[g, :len(cat)] = cat
        return ptr, flat

    E = max(1, max(len(b) for b in bands))
    pq = np.zeros((G, E, 2), dtype=np.int32)
    rows = [list(b.values()) + [[]] * (E - len(b)) for b in bands]
    for g, b in enumerate(bands):
        if b:
            pq[g, :len(b)] = list(b)
    nr_ptr, nr_row = csr(nodes, max(1, max(int(sum(len(x) for x in ls))
                                           for ls in nodes)))
    mb_ptr, mb_row = csr(rows, max(1, max(int(sum(len(x) for x in ls))
                                          for ls in rows)))
    return nr_ptr, nr_row, pq, mb_ptr, mb_row


def _tape_offsets(pt_f: np.ndarray, pt_i: np.ndarray, fq_i: np.ndarray,
                  fsch: int) -> np.ndarray:
    """[G, n + 1] int32: where each chain point's primal exps and
    quotients start on K10's tape, in the order the chain takes them (the
    payment DF's exp, the basis chain's, the start and end DFs' and the
    coupon's quotient, then a pillar's factor's quotient; an exp only
    where the query is interpolated on a scheme other than LINEAR_FWD, a
    quotient two slots), and its end; a point the chain skips takes
    none."""
    G, n = pt_i.shape[:2]
    off = np.zeros((G, n + 1), dtype=np.int32)
    for g in range(G):
        for i in range(n):
            _, _, fl, node = (int(x) for x in pt_i[g, i])
            k = 0
            if fl & IS_MAT or pt_f[g, i, 4] != 0.0 or node >= 0:
                qs = [2 * n + i] + ([] if fl & IS_NOTL else [i, n + i])
                k = 1 + sum(int(fq_i[g, q, 2] < 0 and fsch != LIN_FWD)
                            for q in qs)
                k += 2 * (int(not fl & IS_NOTL) + int(bool(fl & IS_MAT)))
            off[g, i + 1] = off[g, i] + k
    return off


def _term_buckets(pt_f: np.ndarray, pt_i: np.ndarray, S: int):
    """(nb_ptr [G, S (S + 1) / 2 + 1], nb_pt [G, NT], nb_pos [G, n])
    int32: each member's known payments (the chain points that are no
    pillar and weigh in their swap's par condition) by bucket b = k (k +
    1) / 2 + s, swap k and segment s <= k, in chain order within a bucket
    (CSR; pads -1), and each chain point's place in that list (-1: none).
    K12 sums a swap's acc by these buckets (:func:`warp_chain`)."""
    G, n = pt_i.shape[:2]
    NB = S * (S + 1) // 2
    lists = []
    for g in range(G):
        bk = [[] for _ in range(NB)]
        for i in range(n):
            k, sg, fl, _ = (int(x) for x in pt_i[g, i])
            if not fl & IS_MAT and pt_f[g, i, 4] != 0.0:
                if not 0 <= sg <= k < S:
                    raise LibError("XCCY plan: a payment's segment after "
                                   "its swap")
                bk[k * (k + 1) // 2 + sg].append(i)
        lists.append(bk)
    NT = max(1, max(sum(len(x) for x in bk) for bk in lists))
    ptr = np.zeros((G, NB + 1), dtype=np.int32)
    pts = np.full((G, NT), -1, dtype=np.int32)
    pos = np.full((G, n), -1, dtype=np.int32)
    for g, bk in enumerate(lists):
        flat = [i for x in bk for i in x]
        ptr[g, 1:] = np.cumsum([len(x) for x in bk])
        pts[g, :len(flat)] = flat
        pos[g, flat] = np.arange(len(flat))
    return ptr, pts, pos


def _lane_order(pt_f: np.ndarray, pt_i: np.ndarray) -> np.ndarray:
    """[G, n] int32: the order in which K12's lanes take each member's
    chain points (place x to lane x % 32): the coupons first, then the
    notional exchanges, then the points the chain skips, each in chain
    order, so that the lanes of one round evaluate one kind of point."""
    fl, w, node = pt_i[..., 2], pt_f[..., 4], pt_i[..., 3]
    skip = ~((fl & IS_MAT) != 0) & (w == 0.0) & (node < 0)
    key = np.where(skip, 2, np.where((fl & IS_NOTL) != 0, 1, 0))
    return np.argsort(key, axis=1, kind="stable").astype(np.int32)


def _cum_tangents(pt_f: np.ndarray, pt_i: np.ndarray, S: int) -> np.ndarray:
    """[G, S, n] f64: the tangents of the basis chain's cumulative sums cum
    = cumsum(-sp dt) along each basis spread at each chain point, in chain
    order (static: cum is linear in the spreads)."""
    G, n = pt_i.shape[:2]
    out = np.zeros((G, S, n))
    for g in range(G):
        run = [0.0] * S
        for i in range(n):
            k = int(pt_i[g, i, 0])
            run[k] = run[k] - float(pt_f[g, i, 3])
            out[g, :, i] = run
    return out


def _taps(qi) -> list:
    """The grid entries a packed query reads: its exact knot, else the two
    entries that bracket it."""
    return [int(qi[2])] if qi[2] >= 0 else [int(qi[0]), int(qi[1])]


def _legs_lists(li_i: np.ndarray, ld_i: np.ndarray, P: int, Ld: int):
    """K9 / K11's static lists over the calibration legs, from the packed
    index and discount plans alone (``probe_tables`` rewrites the legs'
    values and switches, never these). A member's flows f = s (P + 2) + p
    are its legs' P coupons and two notional exchanges (these only where
    the discount plan has their queries, Pd >= P + 3), in chunks of
    ``LEG_BLOCK``; a flow's six slots are the taps of its index start
    (A: 0, 1), index end (B: 2, 3) and payment or exchange DF (C: 4, 5),
    a knot query filling one. Per member (each padded to the stage's
    largest):

    - ``lr_row`` [G, R] the grid entries some query of the legs reads (the
      rows, ascending; -1 pads), ``lr_of`` [G, Ld] each entry's row or -1;
    - each leg's rows (its flows' and its value DF's), ``ls_ptr``
      [G, S + 1] / ``ls_row`` [G, NL] (a gradient target a (leg, row), in
      leg then row order) with ``lt_leg`` [G, NL] its leg, and each row's
      targets in leg order ``gd_ptr`` [G, R + 1] / ``gd_t``;
    - the entries (r <= c) of M_N = sum_s w_s d2N_s/dd2 over the rows
      (the rows of each pair of slots of one flow), ``me_rc`` [G, E, 2]
      in the order first met, and each row's entries ``mr_ptr``
      [G, R + 1] / ``mr_e``;
    - the sums, over the targets [N_s (S) | gradient (NL) | M_N (E)]:
      each target's terms ``lt_term``, in flow order, a term the place of
      its value in a chunk's flow table, (k LEG_BLOCK + f mod LEG_BLOCK)
      2 + 1 where two distinct slots of a pair fall on one row (counted
      twice), with k 0 the flow's n, 1 + a its slot a's partial and
      7 + pair its slot pair's second partial (``SLOT_PAIRS``); cut into
      segments of at most ``LEG_SEG`` terms of one chunk, ``sg`` [G, NS,
      2] (a term range), in chunk order and, within a chunk, the sums'
      and gradients' before M_N's (``sc_ptr`` [G, 2 nC + 1]: chunk c's
      from 2c, its M_N segments from 2c + 1), and each target's segments
      in term order ``ts_ptr`` [G, S + NL + E + 1] / ``ts_seg``.
    """
    G, S = li_i.shape[:2]
    Pd = ld_i.shape[2]
    F = P + 2
    nC = -(-S * F // LEG_BLOCK)
    n_ex = 2 if Pd >= P + 3 else 0
    per = []
    for g in range(G):
        def flow_slots(s, p):
            """[(slot, grid entry)] of flow p of leg s."""
            if p >= P:
                if p - P >= n_ex:
                    return []
                return [(4 + a, x) for a, x in
                        enumerate(_taps(ld_i[g, s, P + 1 + p - P]))]
            qs = (li_i[g, s, p], li_i[g, s, P + p], ld_i[g, s, p])
            return [(2 * k + a, x) for k, q in enumerate(qs)
                    for a, x in enumerate(_taps(q))]
        slots = {(s, p): flow_slots(s, p) for s in range(S) for p in range(F)}
        vt = [_taps(ld_i[g, s, P]) for s in range(S)]
        rows = sorted({x for v in slots.values() for _, x in v}
                      | {x for v in vt for x in v})
        of = {x: r for r, x in enumerate(rows)}

        def term(f, k, dbl=0):
            return (k * LEG_BLOCK + f % LEG_BLOCK) * 2 + dbl

        sums = [[(s * F + p, term(s * F + p, 0)) for p in range(F)]
                for s in range(S)]
        legs, grads, leg_of = [], [], []
        for s in range(S):
            lrows = sorted({of[x] for p in range(F) for _, x in slots[s, p]}
                           | {of[x] for x in vt[s]})
            legs.append(lrows)
            for r in lrows:
                leg_of.append(s)
                grads.append([(s * F + p, term(s * F + p, 1 + a))
                              for p in range(F) for a, x in slots[s, p]
                              if of[x] == r])
        gd = [[] for _ in rows]
        for t, r in enumerate(r for ls in legs for r in ls):
            gd[r].append(t)
        ents = {}
        for s in range(S):
            for p in range(F):
                f, sl = s * F + p, slots[s, p]
                for i, (a, xa) in enumerate(sl):
                    for b, xb in sl[i:]:
                        ra, rb = of[xa], of[xb]
                        ents.setdefault((min(ra, rb), max(ra, rb)), []).append(
                            (f, term(f, 7 + _PAIR[(a, b)],
                                     int(a != b and ra == rb))))
        mr = [[] for _ in rows]
        for e, (r, c) in enumerate(ents):
            mr[r].append(e)
            if c != r:
                mr[c].append(e)
        per.append(dict(rows=rows, legs=legs, leg_of=leg_of, gd=gd,
                        mr=mr, ents=list(ents), sums=sums, grads=grads,
                        mterms=list(ents.values())))
    R = max(len(m["rows"]) for m in per)
    NL = max(len(m["leg_of"]) for m in per)
    E = max(1, max(len(m["ents"]) for m in per))

    def csr(lists):
        ptr = np.zeros((G, max(len(x) for x in lists) + 1), dtype=np.int32)
        flat = np.zeros((G, max(1, max(sum(len(y) for y in x)
                                       for x in lists))), dtype=np.int32)
        for g, ls in enumerate(lists):
            c = np.cumsum([len(y) for y in ls]) if ls else [0]
            ptr[g, 1:len(ls) + 1] = c
            ptr[g, len(ls) + 1:] = c[-1]
            cat = [w for y in ls for w in y]
            flat[g, :len(cat)] = cat
        return ptr, flat

    def pad(x, n):
        return x + [[]] * (n - len(x))

    # each target's terms, cut into segments of one chunk
    lt, sg, ts, sc = [], [], [], []
    for m in per:
        targets = m["sums"] + pad(m["grads"], NL) + pad(m["mterms"], E)
        flat, segs = [], []            # (chunk, M_N?, target, lo, hi)
        for t, terms in enumerate(targets):
            lo = len(flat)
            flat += [c for _, c in terms]
            chunk = [f // LEG_BLOCK for f, _ in terms]
            k = lo
            while k < len(flat):
                c0, e = chunk[k - lo], k
                while e < len(flat) and e - k < LEG_SEG \
                        and chunk[e - lo] == c0:
                    e += 1
                segs.append((c0, int(t >= S + NL), t, k, e))
                k = e
        segs.sort(key=lambda x: (x[0], x[1]))
        mine = [[] for _ in targets]
        for i, x in enumerate(segs):
            mine[x[2]].append(i)
        bounds = [0] * (2 * nC + 1)
        for x in segs:
            bounds[2 * x[0] + x[1] + 1] += 1
        lt.append([flat])
        sg.append([[x[3], x[4]] for x in segs])
        ts.append(mine)
        sc.append(np.cumsum(bounds).tolist())
    NS = max(1, max(len(x) for x in sg))
    sg_a = np.zeros((G, NS, 2), dtype=np.int32)
    for g, x in enumerate(sg):
        if x:
            sg_a[g, :len(x)] = x
    lr_row = np.full((G, R), -1, dtype=np.int32)
    lr_of = np.full((G, Ld), -1, dtype=np.int32)
    me_rc = np.zeros((G, E, 2), dtype=np.int32)
    lt_leg = np.zeros((G, max(NL, 1)), dtype=np.int32)
    for g, m in enumerate(per):
        lr_row[g, :len(m["rows"])] = m["rows"]
        lr_of[g, m["rows"]] = np.arange(len(m["rows"]))
        if m["ents"]:
            me_rc[g, :len(m["ents"])] = m["ents"]
        lt_leg[g, :len(m["leg_of"])] = m["leg_of"]
    ls_ptr, ls_row = csr([m["legs"] for m in per])
    gd_ptr, gd_t = csr([pad(m["gd"], R) for m in per])
    mr_ptr, mr_e = csr([pad(m["mr"], R) for m in per])
    ts_ptr, ts_seg = csr(ts)
    return dict(lr_row=lr_row, lr_of=lr_of, ls_ptr=ls_ptr, ls_row=ls_row,
                lt_leg=lt_leg, gd_ptr=gd_ptr, gd_t=gd_t, me_rc=me_rc,
                mr_ptr=mr_ptr, mr_e=mr_e, lt_term=csr(lt)[1], sg=sg_a,
                sc_ptr=np.asarray(sc, dtype=np.int32), ts_ptr=ts_ptr,
                ts_seg=ts_seg)


def _query_grid(sets):
    """A fitted parent's query grid from its members' static queries:
    ``sets`` is a list of query sets, each a list of per-member host
    fitted plans (``ops/interpolation.fitted_interp_plan`` on the parent's
    real knots; any query shape). Each member's grid is its sorted
    distinct query times over all the sets. Returns (the packed plans'
    ints, their floats), one a set, each query an exact knot of its
    member's grid (i0 = i1 = the knot, weight 0, its time), and the
    members' host fitted plans at their grid times."""
    from .interpolation import fitted_interp_plan
    G = len(sets[0])
    ints = [[] for _ in sets]
    flts = [[] for _ in sets]
    grid = []
    for g in range(G):
        qs = [np.asarray(st[g]["q"], np.float64) for st in sets]
        t, inv = np.unique(np.concatenate([q.reshape(-1) for q in qs]),
                           return_inverse=True)
        lo = 0
        for k, q in enumerate(qs):
            kn = inv[lo:lo + q.size].reshape(q.shape)
            lo += q.size
            ints[k].append(np.stack([kn, kn, kn], -1).astype(np.int32))
            flts[k].append(np.stack([np.zeros(q.shape), q], -1))
        x = sets[0][g]["x"]
        if any(not np.array_equal(st[g]["x"], x) for st in sets):
            raise LibError("XCCY stage tables: one parent's queries on "
                           "different knots")
        grid.append(fitted_interp_plan(t, x, InterpTypes(int(np.asarray(
            sets[0][g]["scheme"])))))
    return ([np.stack(x) for x in ints], [np.stack(x) for x in flts],
            grid)


def _pack_rows(its: Sequence[InterpTypes], row_plan: dict, U1: int):
    """A stage's rows (rq_i [G, W, 3], rq_f [G, W, 2], r_xs [G, U1]):
    each member's own simple scheme's stacked plan of ``row_plan``, by
    position."""
    G = len(its)
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
    return rq_i, rq_f, r_xs


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
    from .fitted_rows import fitted_plan
    route = stage_route(st, its, b)
    if route != "kernels":
        raise LibError("XCCY stage tables: the stage keeps " + route)
    p = b["plan"]
    G, n = np.asarray(p.times).shape
    S = int(np.asarray(p.mat_pos).shape[-1])
    pad_mask = np.asarray(b["pad_mask"], dtype=bool)
    U1 = pad_mask.shape[-1]
    pt_f, pt_i, mat_pos, u_src = _chain(p, pad_mask)
    fsch, dsch = (SCHEME_CODE.get(it, LIN_FWD)
                  for it in (st.foreign_interp, st.dom_interp))
    ffit = dfit = None
    if st.foreign_interp in SCHEME_CODE:
        Lf = np.asarray(b["for_ts"]).shape[-1]
        fq_i, fq_f = _pack_plan(b["fboot_plan"])
        f_xs = _x_safe(b["fboot_plan"], (G, Lf))
    else:
        (fq_i,), (fq_f,), grid = _query_grid([b["fboot_plan"]])
        ffit = fitted_plan(grid, device)
        Lf = ffit.tables.W_max
        f_xs = np.ones((G, Lf))
    rq_i, rq_f, r_xs = _pack_rows(its, row_plan, U1)
    W = rq_i.shape[1]
    lp = b["legs_plan"]
    if st.dom_interp in SCHEME_CODE:
        Ld = np.asarray(b["dom_ts"]).shape[-1]
        li_i, li_f = _pack_plan(lp["idx"])
        ld_i, ld_f = _pack_plan(lp["disc"])
        d_xs = _legs_xs(lp, Ld)
    else:
        (li_i, ld_i), (li_f, ld_f), grid = _query_grid([lp["idx"],
                                                         lp["disc"]])
        dfit = fitted_plan(grid, device)
        Ld = dfit.tables.W_max
        d_xs = np.ones((G, Ld))
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
    if flags & NOTIONAL_EXCHANGE and ld_i.shape[-2] < P + 3:
        raise LibError("XCCY stage tables: notional exchanges with no "
                       "discount queries at the effective and maturity "
                       "times")
    nr_ptr, nr_row, mb_pq, mb_ptr, mb_row = _row_bands(rq_i, U1)
    tp_off = _tape_offsets(pt_f, pt_i, fq_i, fsch)
    nb_ptr, nb_pt, nb_pos = _term_buckets(pt_f, pt_i, S)
    ll = _legs_lists(li_i, ld_i, int(P), int(Ld))

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
        flags=int(flags), fsch=fsch, dsch=dsch,
        pt_f=f64(pt_f), pt_i=i32(pt_i), mat_pos=i32(mat_pos),
        u_src=i32(u_src), v0=f64(p.v0), fxs=f64(fxs), fq_i=i32(fq_i),
        fq_f=f64(fq_f), f_xs=f64(f_xs), rq_i=i32(rq_i), rq_f=f64(rq_f),
        r_sch=i32([SCHEME_CODE[it] for it in its]), r_xs=f64(r_xs),
        li_i=i32(li_i), li_f=f64(li_f), ld_i=i32(ld_i), ld_f=f64(ld_f),
        d_xs=f64(d_xs), leg_f=f64(leg_f), leg_s=f64(leg_s),
        pv_dom0=f64(b["pv_dom0"]), ffit=ffit, dfit=dfit,
        E=int(mb_pq.shape[1]),
        nr_ptr=i32(nr_ptr), nr_row=i32(nr_row), mb_pq=i32(mb_pq),
        mb_ptr=i32(mb_ptr), mb_row=i32(mb_row), tp_off=i32(tp_off),
        nb_ptr=i32(nb_ptr), nb_pt=i32(nb_pt), nb_pos=i32(nb_pos),
        cum_t=f64(_cum_tangents(pt_f, pt_i, S)),
        pt_ord=i32(_lane_order(pt_f, pt_i)),
        **{k: i32(v) for k, v in ll.items()})


# ---------------------------------------------------------------------------
# the route: a fitted parent's query grid, K8-K11, back to the parent
# ---------------------------------------------------------------------------


def lift_grid(fit, x: torch.Tensor, t: Optional[torch.Tensor] = None):
    """(the grid [Sc, G, Lq], its tangent rows [Sc, D, G, Lq] or None) the
    kernels read of a parent at ``x`` [Sc, G, L] along the tangent rows
    ``t`` [Sc, D, G, L]: on a fitted parent (``fit``, the stage's
    ``ffit`` / ``dfit``) its query grid, K6 ``fitted_eval`` and its
    tangent mode (one launch each on the card); else ``x`` and ``t``."""
    if fit is None:
        return x, t
    from . import kernels
    q = kernels.fitted_eval(x.contiguous(), fit)
    if t is None:
        return q, None
    return q, kernels.fitted_eval_jvp(x.contiguous(), t.contiguous(), q,
                                      fit)


def pull_grid(fit, x: torch.Tensor, g: torch.Tensor,
              t: Optional[torch.Tensor] = None):
    """(g-bar [Sc, G, L], C [Sc, D, G, D] or None): a cotangent ``g`` on
    the grid :func:`lift_grid` gave for a parent at ``x`` [Sc, G, L],
    taken to the parent's own grid, and, along the tangent rows ``t``
    [Sc, D, G, L], the curvature the linear lift leaves out, C_ij =
    sum_q g_q F''_q[t_i, t_j] (the Hessian of g . F(x) along the rows).
    On a fitted parent F is ``ops/fitted_rows.fitted_eval``: g-bar its
    vjp (K7 and the transforms' vjp) and C forward over reverse, the jvp
    of that vjp along each row (one forward-mode level), dotted with every
    row; on a simple parent g-bar = g and C = 0 (None)."""
    if fit is None:
        return g, None
    from .fitted_rows import fitted_eval

    def scal(v, w):
        return torch.sum(w * fitted_eval(fit, v))

    if t is None:
        return vmap(grad(scal))(x, g), None

    def one(v, w, tt):
        gv, hv = vmap(lambda s: jvp(lambda u: grad(scal)(u, w), (v,),
                                    (s,)))(tt)
        return gv[0], torch.einsum("igl,jgl->igj", hv, tt)

    return vmap(one)(x, g, t)


def kernel_jac(tab: XccyStageTables, sp: torch.Tensor, dd: torch.Tensor,
               fd: torch.Tensor, tdl: torch.Tensor, tf: torch.Tensor):
    """A recalibrated stage's (ds, rows, pv0, Jpv, drows, grids) on K8 /
    K9 from its spreads sp [Sc, G, S], its parents' native grids dd
    [Sc, G, Ld'] / fd [Sc, G, Lf'] and their tangent rows tdl [Sc, Qd, G,
    Ld'] / tf [Sc, D, G, Lf']: the fitted parents lifted to their query
    grids (:func:`lift_grid`), the legs' PVs and jacobian on K9, the stage
    on K8. ``grids`` holds the lifted grids (``dq``, ``tdq``, ``fq``,
    ``tfq``) where a parent is fitted, for :func:`kernel_hess`."""
    from . import kernels
    dq, tdq = lift_grid(tab.dfit, dd, tdl)
    fq, tfq = lift_grid(tab.ffit, fd, tf)
    pv0, Jpv = kernels.xccy_legs_jvp(tab, dq, tdq)
    ds, rows, drows = kernels.xccy_stage_jvp(tab, sp, pv0, fq, tfq)
    grids = {}
    if tab.dfit is not None:
        grids.update(dq=dq, tdq=tdq)
    if tab.ffit is not None:
        grids.update(fq=fq, tfq=tfq)
    return ds, rows, pv0, Jpv, drows, grids


def kernel_hess(tab: XccyStageTables, sp: torch.Tensor, pv0: torch.Tensor,
                gs: torch.Tensor, c: dict):
    """A recalibrated stage's (gf, gdd, Hx2, Hl) on K10 / K11 from its
    spreads sp, the legs' PVs pv0 [Sc, G, S], the cotangent of its rows gs
    [Sc, G, W] and its ``carry`` c (the parents' native grids and tangent
    rows, and :func:`kernel_jac`'s lifted grids): the stage's Hessian over
    its D directions and its gradient on the foreign grid (K10), the legs'
    Hessian over the Qd domestic directions weighted by the PV cotangents
    and their gradient on the domestic grid (K11); on a fitted parent the
    gradient taken back to its own grid and the curvature along its rows
    added to the Hessian's block of its directions (:func:`pull_grid`)."""
    from . import kernels
    S = tab.S
    fq, tfq = c.get("fq", c["for_ds"]), c.get("tfq", c["tf2"])
    dq, tdq = c.get("dq", c["dom_ds"]), c.get("tdq", c["td_legs"])
    gZ0, gf, H = kernels.xccy_stage_hess(tab, sp, pv0, fq, tfq, gs)
    gdd, Hl = kernels.xccy_legs_hess(tab, dq, tdq,
                                     gZ0[:, :, S:2 * S].contiguous())
    gf, C = pull_grid(tab.ffit, c["for_ds"], gf, c["tf2"][:, 2 * S:])
    if C is not None:
        H[:, 2 * S:, :, 2 * S:] += C
    gdd, C = pull_grid(tab.dfit, c["dom_ds"], gdd, c["td_legs"])
    if C is not None:
        Hl = Hl + C
    return gf, gdd, H, Hl


# ---------------------------------------------------------------------------
# the per-trade tensors split at the node DFs: K12's nodes, the rows'
# derivatives in them on the full unique-time row plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class NodeRows:
    """A stage's rows on a row plan (the per-trade tensors' full
    unique-time ``row_plan``) as functions of its node DFs, on a device:
    each member's row w reads nodes ``i0`` and ``i1`` [G, W] at weight
    ``c`` and query time ``qt`` [G, W], or is its exact knot (``knot``);
    ``cols`` [G, W, 5] are the columns of :func:`node_rows` its five
    terms add into (its two taps', their second partials', its band
    entry's), ``pq`` [G, E, 2] the band entries p < q (:func:`_row_bands`;
    members pad with (0, 0), which no row reaches), ``sch`` [G, 1] each
    member's scheme code and ``xs`` [G, U1] its x_safe."""
    U1: int
    E: int
    i0: torch.Tensor
    i1: torch.Tensor
    knot: torch.Tensor
    c: torch.Tensor
    qt: torch.Tensor
    cols: torch.Tensor
    pq: torch.Tensor
    sch: torch.Tensor
    xs: torch.Tensor


def node_row_tables(its: Sequence[InterpTypes], row_plan: dict, U1: int,
                    device) -> NodeRows:
    """:class:`NodeRows` of a stage whose members are on the simple
    schemes ``its`` at the host row plan ``row_plan`` (one stacked plan a
    scheme, as ``stage_tables`` packs them), on ``device``."""
    rq_i, rq_f, r_xs = _pack_rows(its, row_plan, U1)
    _, _, pq, _, _ = _row_bands(rq_i, U1)
    G, W = rq_i.shape[:2]
    i0, i1, kn = (rq_i[..., k].astype(np.int64) for k in range(3))
    be = np.zeros((G, W), dtype=np.int64)
    for g in range(G):
        ent = {(int(p), int(q)): e for e, (p, q) in enumerate(pq[g])}
        for w in np.flatnonzero((kn[g] < 0) & (i0[g] != i1[g])):
            be[g, w] = ent[(min(i0[g, w], i1[g, w]), max(i0[g, w],
                                                         i1[g, w]))]
    cols = np.stack([np.where(kn >= 0, kn, i0), i1, U1 + i0, U1 + i1,
                     2 * U1 + be], axis=-1)

    def t(a, dt):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                               device=device)

    return NodeRows(
        U1=int(U1), E=int(pq.shape[1]), i0=t(i0, torch.int64),
        i1=t(i1, torch.int64), knot=t(kn >= 0, torch.bool),
        c=t(rq_f[..., 0], torch.float64), qt=t(rq_f[..., 1], torch.float64),
        cols=t(cols, torch.int64), pq=t(pq, torch.int64),
        sch=t(np.asarray([SCHEME_CODE[it] for it in its])[:, None],
              torch.int64),
        xs=t(r_xs, torch.float64))


def node_rows(nr: NodeRows, ds: torch.Tensor) -> torch.Tensor:
    """RR [G, W, 2 U1 + E]: each row's first and second derivatives in the
    node DFs ds [G, U1], as :func:`rows_prologue` takes a row apart: its
    partials at its one or two nodes in columns [0, U1) (an exact knot: 1
    at its knot), its second partials at each of them in [U1, 2 U1) and
    its mixed partial at its band entry in [2 U1, 2 U1 + E). For a trade's
    DF gradient G_b [W] on the rows, G_b RR is (a, M's diagonal, M's band
    entries) of s = G_b . rows: K10's rows' sums for the cotangent
    G_b."""
    U1 = nr.U1
    lf, fl = nr.sch == LIN_FWD, nr.sch == FLAT_FWD
    den = torch.where(fl, 1.0, nr.xs)
    inv = 1.0 / ds
    y = torch.where(lf, ds, -torch.log(ds) / den)
    y1 = torch.where(lf, 1.0, -inv / den)
    y2 = torch.where(lf, 0.0, inv * inv / den)
    c = nr.c
    z0 = y.gather(1, nr.i0)
    z = z0 + c * (y.gather(1, nr.i1) - z0)
    qt = torch.where(fl, 1.0, nr.qt)
    v = torch.exp(-z * qt)
    v1 = torch.where(lf, 1.0, -qt * v)
    v2 = torch.where(lf, 0.0, qt * (qt * v))
    one = nr.i0 == nr.i1
    w0 = torch.where(one, 1.0, 1.0 - c)
    t0, s0 = w0 * y1.gather(1, nr.i0), w0 * y2.gather(1, nr.i0)
    t1 = torch.where(one, 0.0, c * y1.gather(1, nr.i1))
    s1 = torch.where(one, 0.0, c * y2.gather(1, nr.i1))
    vals = torch.stack([v1 * t0, v1 * t1, v2 * (t0 * t0) + v1 * s0,
                        v2 * (t1 * t1) + v1 * s1, v2 * (t0 * t1)], dim=-1)
    first = torch.arange(5, device=ds.device) == 0
    vals = torch.where(nr.knot[..., None], first.to(vals.dtype), vals)
    G, W = nr.i0.shape
    return vals.new_zeros((G, W, 2 * U1 + nr.E)).scatter_add_(
        2, nr.cols, vals)


def node_quads(nr: NodeRows, Jn: torch.Tensor, Hn: torch.Tensor
               ) -> torch.Tensor:
    """T [G, 2 U1 + E, D D], what :func:`node_rows`' columns meet, from
    K12's node tangents Jn [D, G, U1] and second derivatives Hn [D, D, G,
    U1]: Hn's nodes (a . Hn = sum_u a_u d2ds_u/didj), J_u J_u' at each
    node and J_p J_q' + J_q J_p' at each band entry (J_i' M J_j; K10's
    band_quad), so that G_b RR T = sum_w G_bw d2rows_w/didj, K10's H_ij
    for the cotangent G_b."""
    D, G, U1 = Jn.shape
    J = Jn.permute(1, 2, 0)                                # [G, U1, D]
    hn = Hn.permute(2, 3, 0, 1).reshape(G, U1, D * D)
    diag = (J[..., :, None] * J[..., None, :]).reshape(G, U1, D * D)
    Jp = J.gather(1, nr.pq[..., :1].expand(G, nr.E, D))
    Jq = J.gather(1, nr.pq[..., 1:].expand(G, nr.E, D))
    band = (Jp[..., :, None] * Jq[..., None, :]
            + Jq[..., :, None] * Jp[..., None, :]).reshape(G, nr.E, D * D)
    return torch.cat([hn, diag, band], dim=1)


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


def xccy_stage_node_hess_plain(tab: XccyStageTables, sp: torch.Tensor,
                               pv: torch.Tensor, fd: torch.Tensor,
                               tf: Optional[torch.Tensor] = None):
    """Plain version of K12: for the node DFs ds(Z, fd) = stage_forward's
    ds at (sp + Z_b, pv + Z_pv, fd + Z . tf), at Z = 0: (ds [Sc, G, U1],
    Jn [Sc, D, G, U1] along the D unit directions of Z, Jfd [Sc, Lf, G,
    U1] along each unit entry of fd or None when the parents are held as
    values, Hn [Sc, D, D, G, U1] the second derivatives, jvp over jvp)."""
    S, npv, D, G, Lf = tab.S, tab.npv, tab.D, tab.G, tab.Lf

    def unit(n, like):
        eye = torch.eye(n, dtype=like.dtype, device=like.device)
        return eye[:, None, :].expand(n, G, n)

    def one(s0, p0, f0, t):
        def nodes(Z, f):
            f2 = f + torch.einsum("gd,dgl->gl", Z, t)
            pz = p0 + Z[:, S:S + npv] if npv else p0
            return stage_forward(tab, s0 + Z[:, :S], pz, f2)[0]

        Z0 = s0.new_zeros((G, D))
        seeds = unit(D, s0)
        ds, Jn = vmap(lambda s: jvp(lambda Z: nodes(Z, f0), (Z0,),
                                    (s,)))(seeds)

        def second(s1, s2):
            return jvp(lambda Z: jvp(lambda Y: nodes(Y, f0), (Z,),
                                     (s1,))[1], (Z0,), (s2,))[1]

        Hn = vmap(lambda s1: vmap(lambda s2: second(s1, s2))(seeds))(seeds)
        if not tab.recal:
            return ds[0], Jn, Hn
        _, Jfd = vmap(lambda e: jvp(lambda f: nodes(Z0, f), (f0,),
                                    (e,)))(unit(Lf, f0))
        return ds[0], Jn, Hn, Jfd

    out = vmap(one)(sp, pv, fd, _fd_tangents(tab, tf, fd))
    return out[0], out[1], (out[3] if tab.recal else None), out[2]


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
    """One query of a packed plan in T, the grid's values lifted and
    transformed as they are read (csrc/xccy_stage.cu interp)."""
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


def _exp(x):
    return x.exp() if isinstance(x, (Dual, HyperDual)) else math.exp(x)


def _log(x):
    return x.log() if isinstance(x, (Dual, HyperDual)) else math.log(x)


def transform(sch, d, xs):
    """(d, y, y', y''): a DF d under a simple scheme's interpolated
    transform y (``LINEAR_FWD_RATES`` y = d, ``FLAT_FWD_RATES`` -log d,
    ``LINEAR_ZERO_RATES`` -log(d) / x_safe) and its first two
    derivatives (csrc/xccy_stage.cu transform). ``d`` is a float, or a
    :class:`Dual` with no tangent to count the operations."""
    if sch == LIN_FWD:
        return d, d, 1.0, 0.0
    inv = 1.0 / d
    y = -_log(d)
    if sch == FLAT_FWD:
        return d, y, -inv, inv * inv
    return d, y / xs, -inv / xs, inv * inv / xs


def _lift_y(T, p, t1, t2):
    """A transformed grid value p = (d, y, y', y'') lifted along the grid
    tangents t1 / t2 by the chain rule: (y, t1 y', t2 y', t1 t2 y''),
    the operations counted as the kernel's lift_y does them."""
    y, y1, y2 = (float(x) for x in p[1:])
    if T is Dual:
        Dual._count(0, int(t1 != 0))
        return Dual(y, t1 * y1)
    both = t1 != 0 and t2 != 0 and y2 != 0
    HyperDual._count(0, int(t1 != 0), int(t2 != 0), 2 * both)
    return HyperDual(y, t1 * y1, t2 * y1, (t1 * t2) * y2)


def _query_t(T, sch, qi, qf, tg, d1, d2):
    """One query of a packed plan in T on a grid transformed once
    (``tg``: :func:`transform` of every grid entry), lifted as it is read
    (csrc/xccy_stage.cu query)."""
    if qi[2] >= 0:
        ll = int(qi[2])
        return _lift(T, float(tg[ll][0]), _tan_grid(d1, ll),
                     _tan_grid(d2, ll))
    l0, l1 = int(qi[0]), int(qi[1])
    y0 = _lift_y(T, tg[l0], _tan_grid(d1, l0), _tan_grid(d2, l0))
    v = y0 + float(qf[0]) * (_lift_y(T, tg[l1], _tan_grid(d1, l1),
                                     _tan_grid(d2, l1)) - y0)
    if sch == FLAT_FWD:
        return (-v).exp()
    if sch == LIN_ZERO:
        return (-v * float(qf[1])).exp()
    return v


def grid_transforms(h: dict, g: int, fd) -> list:
    """:func:`transform` of every entry of member g's foreign grid fd
    [Lf], as a K8 / K10 block keeps them."""
    return [transform(h["fsch"], float(fd[ll]), float(h["f_xs"][g, ll]))
            for ll in range(h["Lf"])]


def thread_chain(T, h: dict, g: int, sp, pv, fd, d1, d2, tg=None,
                 node_sink=None):
    """The chain of member ``g`` (h = the tables' ``host()``) in the
    scalar type T (:class:`Dual` or :class:`HyperDual`) at the spreads ``sp`` [S], PVs ``pv`` [S] and foreign grid
    ``fd`` [Lf], the inputs lifted along the directions ``d1`` / ``d2``
    ((kind, index, tangent row)): the node DFs ds [U1] in T. The foreign
    grid is transformed at each read, or, given ``tg``
    (:func:`grid_transforms`), once, as K8 / K10 read it. ``node_sink``
    (K12's store): called ``node_sink(u, value)`` as the chain sets node
    u, in chain order."""
    n, S = h["n"], h["S"]
    pf, pi = h["pt_f"][g], h["pt_i"][g]
    fqi, fqf, fxsg = h["fq_i"][g], h["fq_f"][g], h["f_xs"][g]
    fxs = float(h["fxs"][g])

    def fdf(q):
        if tg is None:
            return _interp_t(T, h["fsch"], fqi[q], fqf[q], fxsg, fd, d1,
                             d2)
        return _query_t(T, h["fsch"], fqi[q], fqf[q], tg, d1, d2)

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
            if node_sink is not None:
                node_sink(node, val)
    return ds


def chain_cums(h: dict, g: int, sp) -> tuple:
    """(cumv [n], cs [S, n]) of member g at the spreads ``sp`` [S]: the
    basis chain's cumulative sums cum = cumsum(-sp dt) at each chain point
    and their tangents along each basis spread (``cum_t``, static), as
    K12's prologue takes them: cum_i = sum_s sp_s cs_si, a thread a
    point."""
    cs = h["cum_t"][g]
    cumv = np.zeros(h["n"])
    for i in range(h["n"]):
        v = 0.0
        for k in range(h["S"]):
            v = v + float(sp[k]) * float(cs[k, i])
        cumv[i] = v
    return cumv, cs


def warp_chain(T, h: dict, g: int, sp, pv, fd, d1, d2, tg, tabs: dict,
               lanes: int = NODE_LANES):
    """Member ``g``'s chain as K12 runs it (csrc/xccy_stage.cu
    chain_point, chain_solve): ``lanes`` lanes on the chain points (place x
    of ``pt_ord`` to lane x % ``lanes``) each evaluate their points' base
    and, of a known payment's term t = cf base w, K_p (the part of t C_s
    that C_s's carried part does not touch) and V_p (t's value), a
    pillar's divisor fxs cf base kept; then per swap r, K_r = its terms' K
    summed in list order (``nb_ptr`` / ``nb_pt``: by segment, chain order
    within), each segment's sum of V (the primal chain's, ``tabs["vs"]``,
    in the others) and pillar r's quotient as an affine map of acc_r's
    carried part, C_{r+1} = al_r + be_r acc_r; then the ranks in order:
    C_{r+1} from acc_r, then each later swap q adds V_{q, r+1} C_{r+1} to
    its acc; last, every node is C base (C_s of its segment, C_{k+1} at
    pillar k). Only one part of C and acc is carried: the value in the
    primal chain (T :class:`Dual` along no direction, ``tabs`` the cum
    tables alone; it adds the sums of V to ``tabs``), the tangent in a
    direction's (T :class:`Dual`, ``tabs`` with the primal ``cv`` /
    ``av``), the e1 e2 part in a pair's (T :class:`HyperDual`, with ``c1``
    / ``c2`` / ``a1`` / ``a2``, the two directions' first tangents of C
    and acc); the others are ``tabs``', as are cum (``cumv``) and its
    tangents along the spreads (``cs``; :func:`chain_cums`). The lanes set
    only which lane evaluates a point: no sum depends on them. Returns
    (the nodes' carried parts [U1], 1 where no point sets a node in the
    primal chain and 0 in the others; C's [S]; acc's [S])."""
    n, S, U1 = h["n"], h["S"], h["U1"]
    pf, pi = h["pt_f"][g], h["pt_i"][g]
    fqi, fqf = h["fq_i"][g], h["fq_f"][g]
    fxs, v0 = float(h["fxs"][g]), h["v0"][g]
    level = ("pair" if T is HyperDual else "dual" if "cv" in tabs
             else "primal")
    cs = tabs["cs"]

    def top(x):
        return x.v if level == "primal" else x.e if level == "dual" \
            else x.ab

    def full(t, name, k, tp):
        if level == "primal":
            return Dual(tp)
        if level == "dual":
            return Dual(float(tabs[name][k]), tp)
        return HyperDual(float(tabs[name][k]), float(tabs[t + "1"][k]),
                         float(tabs[t + "2"][k]), tp)

    one = _lift(T, 1.0, 0.0, 0.0)

    def c_of(s, tp):
        return one if s == 0 else full("c", "cv", s - 1, tp)

    def tcum(d, p):
        return float(cs[d[1], p]) if d[0] == DIR_SPREAD else 0.0

    def fdf(q):
        return _query_t(T, h["fsch"], fqi[q], fqf[q], tg, d1, d2)

    base, term = {}, {}
    order = h["pt_ord"][g]
    for ln in range(lanes):
        for p in (int(order[x]) for x in range(ln, n, lanes)):
            k, s, fl, node = (int(x) for x in pi[p])
            notl, ss, ar, _, w = (float(x) for x in pf[p])
            mat = bool(fl & IS_MAT)
            if not mat and w == 0.0 and node < 0:
                continue
            spk = _lift(T, float(sp[k]), _tan_sp(d1, k), _tan_sp(d2, k))
            cum = _lift(T, float(tabs["cumv"][p]), tcum(d1, p), tcum(d2, p))
            base[p] = fdf(2 * n + p) * cum.exp()
            if fl & IS_NOTL:
                cf = _lift(T, notl if fl & IS_LAST else -notl, 0.0, 0.0) \
                    + spk * ss
            else:
                r = fdf(p) / fdf(n + p)
                cf = (((r - 1.0) * notl) * ar
                      + (notl if fl & IS_LAST else 0.0)) + spk * ss
            if mat:
                term[p] = (fxs * cf) * base[p]
            elif w != 0.0:
                term[p] = (cf * base[p]) * w
    ptr, pts = h["nb_ptr"][g], h["nb_pt"][g]
    acc, VS, al, be = [], [], [], []
    for r in range(S):
        b0 = r * (r + 1) // 2
        kr = 0.0
        for x in range(int(ptr[b0]), int(ptr[b0 + r + 1])):
            p = int(pts[x])
            kr = kr + top(term[p] * c_of(int(pi[p, 1]), 0.0))
        acc.append(kr)
        VS.append([0.0] * (r + 1))
        for sg in range(1, r + 1):
            vs = 0.0
            for x in range(int(ptr[b0 + sg]), int(ptr[b0 + sg + 1])):
                vs = vs + term[int(pts[x])].v
            VS[r][sg] = vs if level == "primal" \
                else float(tabs["vs"][b0 + sg])
        d = term[int(h["mat_pos"][g][r])]
        pvk = _lift(T, float(pv[r]), _tan_pv(d1, r), _tan_pv(d2, r))
        num = -(pvk + fxs * (float(v0[r]) + full("a", "av", r, 0.0)))
        rr = 1.0 / d.v
        if level == "primal":
            a0 = num.v * rr
        else:
            q = float(tabs["cv"][r])
            if level == "dual":
                a0 = (num.e - q * d.e) * rr
            else:
                qa = (num.a - q * d.a) * rr
                qb = (num.b - q * d.b) * rr
                a0 = (num.ab - q * d.ab - qa * d.b - qb * d.a) * rr
        al.append(a0)
        be.append(-fxs * rr)
    if level == "primal":
        tabs["vs"] = [v for r in range(S) for v in VS[r]]
    cab = [0.0] * (S + 1)
    atop = [0.0] * S
    for r in range(S):
        cab[r + 1] = al[r] + be[r] * acc[r]
        atop[r] = acc[r]
        for q in range(r + 1, S):
            acc[q] = acc[q] + VS[q][r + 1] * cab[r + 1]
    nodes = [1.0 if level == "primal" else 0.0] * U1
    for p in range(n):
        k, s, fl, node = (int(x) for x in pi[p])
        if node >= 0:
            sc = k + 1 if fl & IS_MAT else s
            nodes[node] = top(c_of(sc, cab[sc]) * base[p])
    return nodes, cab[1:], atop


def thread_rows(T, h: dict, g: int, ds, row_sink):
    """Member ``g``'s rows from its node DFs ``ds`` [U1] in T through its
    own simple plan (``r_sch``): calls ``row_sink(w, value)`` for every
    row."""
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


def thread_stage(T, h: dict, g: int, sp, pv, fd, d1, d2, row_sink):
    """The whole stage of member ``g`` in T, as one thread of the simple
    design evaluates it: :func:`thread_chain` then :func:`thread_rows`;
    calls ``row_sink(w, value)`` for every row and returns the node DFs
    [U1]."""
    ds = thread_chain(T, h, g, sp, pv, fd, d1, d2)
    thread_rows(T, h, g, ds, row_sink)
    return ds


def row_terms(h: dict, g: int, w: int, ds, second: bool = True):
    """Row w of member g at the primal node DFs ds [U1] (floats, or
    :class:`Dual`s with no tangent to count the operations), as K8 / K10
    take it apart (csrc/xccy_stage.cu row_val): None for an exact knot
    (the row is ds[knot]); else (v, v', v'', taps) with v the row as a
    function of z = y0 + c (y1 - y0), v' and v'' its derivatives in z,
    and taps [(u, dz/dds_u, d2z/dds_u2)] its one or two nodes (with
    ``second`` False, v'' and d2z/dds_u2 None: K8 needs neither)."""
    rs = int(h["r_sch"][g])
    q, f = h["rq_i"][g, w], h["rq_f"][g, w]
    if q[2] >= 0:
        return None
    u0, u1 = int(q[0]), int(q[1])
    c, qt = float(f[0]), float(f[1])
    p0 = transform(rs, ds[u0], float(h["r_xs"][g, u0]))
    p1 = transform(rs, ds[u1], float(h["r_xs"][g, u1]))
    z = p0[1] + c * (p1[1] - p0[1])
    v2 = None
    if rs == LIN_FWD:
        v, v1 = z, 1.0
        if second:
            v2 = 0.0
    elif rs == FLAT_FWD:
        v = _exp(-z)
        v1, v2 = -v, (v if second else None)
    else:
        v = _exp(-z * qt)
        v1 = -qt * v
        if second:
            v2 = qt * (qt * v)
    if u0 == u1:
        return v, v1, v2, [(u0, p0[2], p0[3] if second else None)]
    return v, v1, v2, [
        (u0, (1.0 - c) * p0[2], (1.0 - c) * p0[3] if second else None),
        (u1, c * p1[2], c * p1[3] if second else None)]


def rows_prologue(h: dict, g: int, ds, gs, band: bool = True):
    """K10's pair-independent sums over member g's rows at its primal
    node DFs ds [U1] and the rows' cotangents gs [W] (csrc/xccy_stage.cu
    rows_sums): (a [U1], md [U1], mo [E]) with a = ds/dds of
    s = sum gs . rows, md the diagonal of M = d2s/dds2 and mo its entries
    at ``mb_pq`` (p < q), each a sum over its rows in table order (the
    node and band tables of :func:`_row_bands`); md and mo are None when
    ``band`` is False (a alone, which the foreign grid's gradient reads)."""
    U1 = h["U1"]
    a = [0.0] * U1
    md = [0.0] * U1
    ptr, rows = h["nr_ptr"][g], h["nr_row"][g]
    for u in range(U1):
        for p in range(ptr[u], ptr[u + 1]):
            w = int(rows[p])
            gw = float(gs[w])
            t = row_terms(h, g, w, ds)
            if t is None:
                a[u] = a[u] + gw
                continue
            v, v1, v2, taps = t
            du, d2u = next((x, y) for uu, x, y in taps if uu == u)
            a[u] = a[u] + gw * (v1 * du)
            if band:
                md[u] = md[u] + gw * (v2 * (du * du) + v1 * d2u)
    if not band:
        return a, None, None
    mo = [0.0] * h["E"]
    bptr, brow = h["mb_ptr"][g], h["mb_row"][g]
    for e in range(h["E"]):
        for p in range(bptr[e], bptr[e + 1]):
            w = int(brow[p])
            v, v1, v2, taps = row_terms(h, g, w, ds)
            mo[e] = mo[e] + float(gs[w]) * (v2 * (taps[0][1] * taps[1][1]))
    return a, md, mo


def band_matrix(h: dict, g: int, md, mo) -> np.ndarray:
    """M [U1, U1] from its diagonal md and its band entries mo at
    ``mb_pq``."""
    M = np.diag(np.asarray([float(x) for x in md]))
    for e, (p, q) in enumerate(h["mb_pq"][g]):
        M[p, q] += float(mo[e])
        if p != q:
            M[q, p] += float(mo[e])
    return M


def pair_hessian(h: dict, g: int, a, md, mo, dab, Ji, Jj) -> float:
    """K10's H_ij = sum_u a_u d2ds_u/didj + J_i' M J_j from the pair's
    hyper-dual node parts dab [U1] (e1 e2), the nodes' first tangents
    Ji, Jj [U1] and the band (md, mo); the kernel sums the first term in
    chain order as it writes the nodes, the second as here."""
    hs = 0.0
    for u in range(h["U1"]):
        hs = hs + a[u] * dab[u]
    hm = 0.0
    for u in range(h["U1"]):
        hm = hm + md[u] * (Ji[u] * Jj[u])
    for e, (p, q) in enumerate(h["mb_pq"][g]):
        hm = hm + mo[e] * (Ji[p] * Jj[q] + Ji[q] * Jj[p])
    return hs + hm


def rows_jvp(h: dict, g: int, ds, J):
    """K8's rows phase for member g from its primal node DFs ds [U1] and
    the nodes' first tangents J [U1][k] along the block's directions:
    (rows [W], drows [k][W]), each row's primal once and each tangent
    from the row's one or two taps (csrc/xccy_stage.cu k8_stage_jvp)."""
    nd = len(J[0]) if len(J) else 0
    rows, drows = [], [[] for _ in range(nd)]
    for w in range(h["W"]):
        t = row_terms(h, g, w, ds, second=False)
        if t is None:
            kn = int(h["rq_i"][g, w, 2])
            rows.append(ds[kn])
            for k in range(nd):
                drows[k].append(J[kn][k])
            continue
        v, v1, _, taps = t
        rows.append(v)
        cs = [(u, v1 * du) for u, du, _ in taps]
        for k in range(nd):
            x = cs[0][1] * J[cs[0][0]][k]
            if len(cs) > 1:
                x = x + cs[1][1] * J[cs[1][0]][k]
            drows[k].append(x)
    return rows, drows


def thread_legs(T, h: dict, g: int, dd, d1, d2, leg_sink):
    """Member ``g``'s calibration legs evaluated whole in T at the
    domestic grid ``dd`` [Ld] along ``d1`` / ``d2`` (what a K9 / K11
    thread did before the legs were split at their flows; the count of
    :func:`needed_flops`' need and the emulated threads of the tests);
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


# ---------------------------------------------------------------------------
# K9 / K11 split: the legs' primal, gradients and M once a (scenario,
# member), then a dot a direction or pair
# ---------------------------------------------------------------------------


def _prim(x) -> float:
    return x.v if isinstance(x, (Dual, HyperDual)) else x


def leg_query(h: dict, qi, qf, tg, dd):
    """One query of a member's legs on its domestic grid ``dd`` [Ld]
    transformed once (``tg``: :func:`transform` of each entry), as K9 /
    K11's flow pass takes it (csrc/xccy_stage.cu leg_query): (D, its
    first partials in its taps (:func:`_taps`), its second partials
    (h00, h01, h11) in them, None at a knot): interp's knot select (dD/dd
    = 1, no second order), LINEAR_ZERO's x_safe, FLAT_FWD's exp."""
    if qi[2] >= 0:
        return dd[int(qi[2])], [1.0], None
    c, qt = float(qf[0]), float(qf[1])
    p0, p1 = tg[int(qi[0])], tg[int(qi[1])]
    v = p0[1] + c * (p1[1] - p0[1])
    if h["dsch"] == LIN_FWD:
        d, f1, f2 = v, 1.0, 0.0
    elif h["dsch"] == FLAT_FWD:
        d = _exp(-v)
        f1, f2 = -d, d
    else:
        d = _exp(-v * qt)
        f1 = -qt * d
        f2 = qt * (qt * d)
    u0, u1 = (1.0 - c) * p0[2], c * p1[2]
    return d, [f1 * u0, f1 * u1], (
        f2 * (u0 * u0) + f1 * ((1.0 - c) * p0[3]), f2 * (u0 * u1),
        f2 * (u1 * u1) + f1 * (c * p1[3]))


def _put_query_hess(hN, base, k, x1, x2):
    """k times a query's second partials into the slot Hessian hN at its
    slots base, base + 1."""
    if x2 is None:
        return
    hN[_PAIR[(base, base)]] = k * x2[0]
    hN[_PAIR[(base, base + 1)]] = k * x2[1]
    hN[_PAIR[(base + 1, base + 1)]] = k * x2[2]


def leg_flow(h: dict, g: int, s: int, p: int, tg, dd, w=None):
    """Flow p of member g's leg s (p < P a coupon, P + e exchange e) as
    K9 / K11's flow pass takes it (csrc/xccy_stage.cu leg_flow): (n,
    gN [6], hN [21] or None) with n = sign cf D_pay (an exchange: sign
    amt D_ex), gN its partials in its six slots and, given w (K11:
    gpv_s / D_val), w times its Hessian in them (pairs of
    ``SLOT_PAIRS``). pv_float_leg's branches as :func:`thread_legs` takes
    them: a past coupon (payt <= vt) and an exchange before vt are 0; the
    first-fixing override on flow 0 and an ia = 0 slot (the double-where)
    give a fixed rate, no index DF read; the cap / floor clamp fixes the
    rate strictly beyond it, the floor first, then the cap, as
    torch.clamp's min(max(rate, floor), cap) (its derivative passes at the
    cap and the floor); the principal rides on the last coupon."""
    P, flags = h["P"], h["flags"]
    principal, sign, vt, ffr, nx, eff, matt, cap, flo = (
        float(x) for x in h["leg_s"][g, s])
    di, df = h["ld_i"][g, s], h["ld_f"][g, s]
    gN = [0.0] * 6
    hN = None if w is None else [0.0] * 21
    if p >= P:
        e = p - P
        ext, amt = (matt, nx) if e else (eff, -nx)
        if not (flags & NOTIONAL_EXCHANGE and ext >= vt):
            return 0.0, gN, hN
        x, x1, x2 = leg_query(h, di[P + 1 + e], df[P + 1 + e], tg, dd)
        k = sign * amt
        for a, v in enumerate(x1):
            gN[4 + a] = k * v
        if hN is not None:
            _put_query_hess(hN, 4, w * k, x1, x2)
        return k * x, gN, hN
    payt, pa, ia, spr, notl = (float(x) for x in h["leg_f"][g, s, p])
    if not payt > vt:
        return 0.0, gN, hN
    li, lf = h["li_i"][g, s], h["li_f"][g, s]
    C, c1, c2 = leg_query(h, di[p], df[p], tg, dd)
    K = 0.0
    if flags & OVERRIDE_FIRST and p == 0:
        fwd = ffr
    elif ia > 0:
        A, a1, a2 = leg_query(h, li[p], lf[p], tg, dd)
        B, b1, b2 = leg_query(h, li[P + p], lf[P + p], tg, dd)
        fwd = (A / B - 1.0) / ia
        K = (pa * notl) / ia
    else:
        fwd = 0.0
    rate = fwd + spr
    if flags & CAP_FLOOR:
        if _prim(rate) < flo:
            rate, K = flo, 0.0
        if _prim(rate) > cap:
            rate, K = cap, 0.0
    cf = (rate * pa) * notl + (principal if p == P - 1 else 0.0)
    nC = sign * cf
    for a, v in enumerate(c1):
        gN[4 + a] = nC * v
    if K != 0.0:
        iB = 1.0 / B
        r = A * iB
        kc = sign * K
        nA = (kc * C) * iB
        nB = -nA * r
        for a, v in enumerate(a1):
            gN[a] = nA * v
        for a, v in enumerate(b1):
            gN[2 + a] = nB * v
    if hN is None:
        return nC * C, gN, hN
    _put_query_hess(hN, 4, w * nC, c1, c2)
    if K != 0.0:
        wA, wB = w * nA, w * nB
        fAB, fBB = -wA * iB, -2.0 * (wB * iB)
        fAC = (w * kc) * iB
        fBC = -fAC * r
        _put_query_hess(hN, 0, wA, a1, a2)
        _put_query_hess(hN, 2, wB, b1, b2)
        for a, x in enumerate(b1):
            for b, y in enumerate(b1[a:], a):
                hN[_PAIR[(2 + a, 2 + b)]] = hN[_PAIR[(2 + a, 2 + b)]] \
                    + fBB * (x * y)
        for a, x in enumerate(a1):
            for b, y in enumerate(b1):
                hN[_PAIR[(a, 2 + b)]] = fAB * (x * y)
            for b, y in enumerate(c1):
                hN[_PAIR[(a, 4 + b)]] = fAC * (x * y)
        for a, x in enumerate(b1):
            for b, y in enumerate(c1):
                hN[_PAIR[(2 + a, 4 + b)]] = fBC * (x * y)
    return nC * C, gN, hN


def _vtaps(h: dict, g: int, s: int) -> list:
    """The rows of leg s's value DF's taps."""
    return [int(h["lr_of"][g, x]) for x in _taps(h["ld_i"][g, s, h["P"]])]


def legs_prologue(h: dict, g: int, dd, gpv=None) -> dict:
    """K9 / K11's work of one (scenario, member) that no direction or
    pair depends on (csrc/xccy_stage.cu legs_prologue), at the domestic
    grid dd [Ld] and, for K11, the legs' cotangents gpv [S]: the grid
    transformed once; each leg's value DF V_s (:func:`leg_query`) and, K11,
    w_s = gpv_s / V_s; then, chunk by chunk, its flows (:func:`leg_flow`)
    into the chunk's table and the chunk's segments' sums of their terms
    (``sg``, ``lt_term``; K9 without M_N's); then each target's segments
    in order: N_s, each (leg s, row r)'s dN_s/dd_r and, K11, each entry of
    M_N = sum_s w_s d2N_s/dd2; PV_s = N_s / V_s and G_s[r] = (dN_s/dd_r -
    PV_s dV_s/dd_r) / V_s, the leg's gradient; K11, gdd[l] = sum_s gpv_s
    G_s[l] over the row's targets (``gd_*``) and each target's
    coefficients in U (``tc``: w_s G_s[r] of beta and, at a value DF tap,
    w_s dV_s/dd_r of gamma and w_s PV_s d2V_s/dd_r dd_v of the tangent at
    each tap v, with a flag). Entries are floats, or :class:`Dual` s with
    no tangent to count the operations."""
    S, P, Ld = h["S"], h["P"], h["Ld"]
    F = P + 2
    NL, E = h["ls_row"].shape[1], h["me_rc"].shape[1]
    xs = h["d_xs"][g]
    tg = [transform(h["dsch"], dd[ll], float(xs[ll])) for ll in range(Ld)]
    V = [leg_query(h, h["ld_i"][g, s, P], h["ld_f"][g, s, P], tg, dd)
         for s in range(S)]
    w = [None] * S if gpv is None else [float(gpv[s]) / V[s][0]
                                        for s in range(S)]
    lt, sgs, scp = h["lt_term"][g], h["sg"][g], h["sc_ptr"][g]
    part = [0.0] * sgs.shape[0]
    for c in range(len(scp) // 2):
        table = {}
        for f in range(c * LEG_BLOCK, min((c + 1) * LEG_BLOCK, S * F)):
            s, p = divmod(f, F)
            n, gN, hN = leg_flow(h, g, s, p, tg, dd, w[s])
            for k, v in enumerate([n] + gN + (hN or [])):
                table[k * LEG_BLOCK + f % LEG_BLOCK] = v
        for k in range(scp[2 * c], scp[2 * c + (1 if gpv is None else 2)]):
            acc = 0.0
            for term in lt[sgs[k, 0]:sgs[k, 1]]:
                v = table[int(term) >> 1]
                acc = acc + (2.0 * v if term & 1 else v)
            part[k] = acc
    tp, tsg = h["ts_ptr"][g], h["ts_seg"][g]

    def total(t):
        acc = 0.0
        for k in tsg[tp[t]:tp[t + 1]]:
            acc = acc + part[k]
        return acc
    N = [total(s) for s in range(S)]
    pv = [N[s] / V[s][0] for s in range(S)]
    G = []
    for t in range(int(h["ls_ptr"][g, S])):
        s, r = int(h["lt_leg"][g, t]), int(h["ls_row"][g, t])
        dv = 0.0
        for a, vr in enumerate(_vtaps(h, g, s)):
            if vr == r:
                dv = dv + V[s][1][a]
        G.append((total(S + t) - pv[s] * dv) / V[s][0])
    out = dict(V=V, w=w, N=N, pv=pv, G=G)
    if gpv is None:
        return out
    M = [total(S + NL + e) for e in range(E)]
    dp, dt = h["gd_ptr"][g], h["gd_t"][g]
    gdd = []
    for ll in range(Ld):
        r = int(h["lr_of"][g, ll])
        acc = 0.0
        if r >= 0:
            for t in dt[dp[r]:dp[r + 1]]:
                acc = acc + float(gpv[int(h["lt_leg"][g, t])]) * G[t]
        gdd.append(acc)
    tc = []
    for t in range(len(G)):
        s, r = int(h["lt_leg"][g, t]), int(h["ls_row"][g, t])
        vr = _vtaps(h, g, s) + [-1]
        a0, a1 = vr[0] == r, vr[1] == r
        Vs, wt = V[s], w[s]
        wp = wt * pv[s]
        h2 = Vs[2] or (0.0, 0.0, 0.0)
        d1 = Vs[1] + [0.0]
        tc.append((wt * G[t], wt * ((d1[0] if a0 else 0.0)
                                     + (d1[1] if a1 else 0.0)),
                   wp * ((h2[0] if a0 else 0.0) + (h2[1] if a1 else 0.0)),
                   wp * ((h2[1] if a0 else 0.0) + (h2[2] if a1 else 0.0)),
                   a0 or a1))
    return dict(out, M=M, gdd=gdd, tc=tc)


def legs_dir(h: dict, g: int, pro: dict, t) -> tuple:
    """Along one domestic tangent row t [Ld] of a (scenario, member):
    (gamma [S], beta [S]) with gamma_s = G_s . t (K9's Jpv[d, s]) over the
    leg's targets and beta_s = dV_s/dd . t over its value DF's taps."""
    S = h["S"]
    gam, bet = [], []
    for s in range(S):
        acc = 0.0
        for k in range(int(h["ls_ptr"][g, s]), int(h["ls_ptr"][g, s + 1])):
            acc = acc + pro["G"][k] * float(
                t[int(h["lr_row"][g, h["ls_row"][g, k]])])
        gam.append(acc)
        b = 0.0
        for a, x in enumerate(_taps(h["ld_i"][g, s, h["P"]])):
            b = b + pro["V"][s][1][a] * float(t[x])
        bet.append(b)
    return gam, bet


def legs_u(h: dict, g: int, pro: dict, tj, gam, bet) -> list:
    """U_j = M t_j [R] over the rows for one tangent row tj [Ld] with its
    (gamma, beta) (:func:`legs_dir`): M_N's entries of each row (``mr_*``)
    times tj at the other row, then, less, each of the row's targets'
    coefficients (``tc``) times beta_s and, at a value DF tap, gamma_s and
    tj at the taps: the value DF's coupling d2PV_s = d2N_s / V_s - (G_s
    dV_s' + dV_s G_s') / V_s - PV_s d2V_s / V_s folded in
    (csrc/xccy_stage.cu k11_legs_hess)."""
    R = h["lr_row"].shape[1]
    rows, rc = h["lr_row"][g], h["me_rc"][g]
    mp, me = h["mr_ptr"][g], h["mr_e"][g]
    dp, dt = h["gd_ptr"][g], h["gd_t"][g]
    U = []
    for r in range(R):
        acc = 0.0
        if rows[r] < 0:
            U.append(acc)
            continue
        for e in me[mp[r]:mp[r + 1]]:
            p, c = (int(x) for x in rc[e])
            acc = acc + pro["M"][e] * float(tj[rows[c if p == r else p]])
        for t in dt[dp[r]:dp[r + 1]]:
            s = int(h["lt_leg"][g, t])
            c0, c1, c2, c3, at = pro["tc"][t]
            y = c0 * bet[s]
            if at:
                tau = [float(tj[x]) for x in _taps(h["ld_i"][g, s, h["P"]])]
                y = y + c1 * gam[s] + c2 * tau[0] + c3 * (
                    tau[1] if len(tau) > 1 else 0.0)
            acc = acc - y
        U.append(acc)
    return U


def legs_pair(h: dict, g: int, ti, U) -> float:
    """K11's Hl_ij = t_i . U_j over the rows (csrc/xccy_stage.cu
    k11_legs_hess)."""
    acc = 0.0
    for r, x in enumerate(h["lr_row"][g]):
        if x >= 0:
            acc = acc + float(ti[x]) * U[r]
    return acc


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


def _ops_of(f) -> int:
    """The f64 operations :class:`Dual` counts in its primal part while
    ``f()`` runs (a float-like mirror of the kernels' scalar code)."""
    Dual.ops = [0, 0]
    f()
    return Dual.ops[0]


def tiles(D: int, hess: bool, Dt: Optional[int] = None) -> list:
    """K8 / K10's tiles of directions, in launch order, as (I, J) lists:
    K8 a tile I of ``TILE`` directions a block (J None); K10 the tile
    pairs I <= J of tiles of ``Dt`` directions (all D, as K10 lays a
    block out when its tables fit three blocks to an SM, which they do
    at the route's sizes), whose pairs are those i <= j with i in I and j
    in J (J is I on the diagonal)."""
    Dt = (D if hess else TILE) if Dt is None else Dt
    ts = [list(range(k, min(k + Dt, D))) for k in range(0, D, Dt)]
    if not hess:
        return [(t, None) for t in ts]
    return [(ts[i], ts[j]) for i in range(len(ts))
            for j in range(i, len(ts))]


def hess_blocks(D: int, n_gf: int, Dt: Optional[int] = None) -> list:
    """K10's blocks of one (scenario, member) as (I, J, items): each tile
    pair's items (its pairs i <= j in row-major order, then, the last tile
    pair's, from the next multiple of 32 on, the n_gf foreign grid
    entries as ("grid", l); None for a thread with none) cut into chunks
    of at most ``ITEMS`` (csrc/xccy_stage.cu hess_blocks; the kernel runs
    a (scenario, member)'s blocks last first)."""
    tps = tiles(D, True, Dt)
    out = []
    for k, (I, J) in enumerate(tps):
        items = [(i, j) for i in I for j in J if j >= i]
        if k == len(tps) - 1 and n_gf:
            items += [None] * (-len(items) % 32)
            items += [("grid", ll) for ll in range(n_gf)]
        out += [(I, J, items[c:c + ITEMS])
                for c in range(0, len(items), ITEMS)]
    return out


def node_pair_tile(Sc: int, G: int, D: int, sms: int = H100_SMS) -> int:
    """The directions of a tile of K12's pair launch (csrc/xccy_stage.cu
    node_plan): the largest of 8, 4, 2 whose tile pairs at Sc scenarios of
    G members give each of the card's ``sms`` SMs a block, else 1."""
    for dt in (8, 4, 2):
        nT = -(-D // dt)
        if Sc * G * (nT * (nT + 1) // 2) >= sms:
            return dt
    return 1


def node_hess_blocks(Sc: int, G: int, D: int, n_gf: int,
                     warps: int = NODE_WARPS, sms: int = H100_SMS) -> tuple:
    """K12's two launches at Sc scenarios of G members, D directions and
    n_gf foreign grid entries (csrc/xccy_stage.cu, a block of ``warps``
    warps): (the prologue's blocks in launch order, each (scenario-member
    sg, its items: ("dir", d) or ("grid", l), a warp each), a (scenario,
    member)'s D + n_gf items cut in blocks of ``warps``; the pair launch's
    blocks, a (scenario, member) and tile pair I <= J of
    :func:`node_pair_tile` directions each (:func:`tiles`' order), each its
    pairs i <= j (i in I, j in J) row-major as (sg, i, j), pair x taken by
    warp x % ``PAIR_WARPS``)."""
    items = [("dir", d) for d in range(D)] + [("grid", ll)
                                              for ll in range(n_gf)]
    pro = [(sg, items[c:c + warps]) for sg in range(Sc * G)
           for c in range(0, len(items), warps)]
    tps = tiles(D, True, node_pair_tile(Sc, G, D, sms))
    pairs = [[(sg, i, j) for i in I for j in J if j >= i]
             for sg in range(Sc * G) for I, J in tps]
    return pro, pairs


def node_workspace(tab: XccyStageTables) -> int:
    """The doubles of K12's workspace a (scenario, member)
    (csrc/xccy_stage.cu node_plan): the tape (8 slots a chain point), the
    foreign grid's transforms [4, Lf], cum [n], the primal C and acc [S]
    each, the primal chain's buckets' sums of V [S (S + 1) / 2] and the
    directions' first tangents of C and acc [D, S] each."""
    n, S = tab.n, tab.S
    return 8 * n + 4 * tab.Lf + n + 2 * S + S * (S + 1) // 2 \
        + 2 * tab.D * S


def _row_ops(h: dict, g: int, dsd, hess: bool) -> int:
    """The operations of member g's rows once (K8: each row and its
    taps' coefficients, :func:`rows_jvp`; K10: the node and band sums,
    :func:`rows_prologue`, with ``dsd`` the primal node DFs as counting
    :class:`Dual`s and unit cotangents)."""
    if hess:
        return _ops_of(lambda: rows_prologue(h, g, dsd, np.ones(h["W"])))

    def rows():
        for w in range(h["W"]):
            t = row_terms(h, g, w, dsd, second=False)
            if t is not None:
                for _, du, _ in t[3]:
                    t[1] * du
    return _ops_of(rows)


def _tape_len(h: dict, g: int):
    """(exps, quotients) of member g's chain: what K10's tape holds and a
    replaying thread leaves out of its primal part."""
    n, fsch = h["n"], h["fsch"]
    pi, fqi = h["pt_i"][g], h["fq_i"][g]
    exps = quots = 0
    for i in range(n):
        fl = int(pi[i, 2])
        if h["tp_off"][g, i + 1] == h["tp_off"][g, i]:
            continue
        qs = [2 * n + i] + ([] if fl & IS_NOTL else [i, n + i])
        exps += 1 + sum(fqi[q][2] < 0 and fsch != LIN_FWD for q in qs)
        quots += int(not fl & IS_NOTL) + int(bool(fl & IS_MAT))
    return exps, quots


def _stage_kernel_ops(name, h, g, sp, pv, fd, dirs, count_chain) -> int:
    """The operations of K8's or K10's blocks of one (scenario, member),
    each phase counted on the Python mirror of the kernel's code: a
    block's grid transforms and rows once (:func:`_row_ops`); K8's dual
    chain a direction of the block (computing its exps and quotients, a
    reciprocal more a quotient) and its rows' tangents (a multiply a tap,
    an add between two); K10's primal chain (its quotients' reciprocals
    too), then a dual chain a direction of the block, a hyper-dual chain a
    pair and a dual chain a foreign grid entry, each replaying the block's
    tape (no exp, no quotient in its primal part); K10's contraction a
    pair (2 operations a real node for sum a . dds.ab, 3 a node and 7 a
    band entry for J_i' M J_j, 2 a node for gZ at i = j) and 2 operations
    a real node for gf. K12's two launches: :func:`_node_kernel_ops`."""
    hess = name == "xccy_stage_hess"
    none = (DIR_NONE, 0, None)
    U1, Lf = h["U1"], h["Lf"]
    grid = _ops_of(lambda: [transform(h["fsch"], Dual(float(fd[ll])),
                                      float(h["f_xs"][g, ll]))
                            for ll in range(Lf)])
    exps, quots = _tape_len(h, g)
    if name == "xccy_stage_node_hess":
        return _node_kernel_ops(h, g, dirs, count_chain, grid, exps, quots)
    firsts = [sum(count_chain(Dual, d, none)) for d in dirs]
    dsd = [Dual(x.v) for x in thread_chain(Dual, h, g, sp, pv, fd, none,
                                           none)]
    live = int((h["u_src"][g] >= 0).sum())
    rows = _row_ops(h, g, dsd, hess)
    if not hess:
        taps = [0 if t is None else len(t[3])
                for t in (row_terms(h, g, w, [x.v for x in dsd])
                          for w in range(h["W"]))]
        return sum(grid + rows + sum(firsts[d] + quots for d in I)
                   for I, _ in tiles(len(dirs), False)) \
            + len(dirs) * sum(2 * k - 1 for k in taps if k)
    contract = 2 * live + 3 * U1 + 7 * h["E"] + 1
    prim = count_chain(Dual, none, none)[0] + quots
    total = 0
    for I, J, items in hess_blocks(len(dirs), Lf if h["recal"] else 0):
        total += grid + rows + prim + sum(
            firsts[d] - exps - quots for d in I + ([] if J is I else J))
        for i, j in (x for x in items if x is not None):
            if i == "grid":
                total += sum(count_chain(Dual, (DIR_UNIT, j, None),
                                         none)) - exps - quots + 2 * live
                continue
            total += sum(count_chain(HyperDual, dirs[i], dirs[j])) \
                - exps - quots + contract + (2 * U1 if i == j else 0)
    return total


def _node_kernel_ops(h, g, dirs, count_chain, grid, exps, quots) -> int:
    """The operations of K12's two launches for one (scenario, member)
    (:func:`node_hess_blocks`), each chain counted on the Python mirror of
    its arithmetic (:func:`thread_chain`'s operations, which
    :func:`warp_chain` reorders into its buckets' sums): each prologue
    block's grid transforms, primal chain (its quotients' reciprocals
    too) and cum's tangents along the spreads (an add a point of its
    swap); a dual chain a direction and a foreign grid entry, replaying
    the tape (no exp, no quotient in its primal part); a hyper-dual chain
    a pair, replaying the tape."""
    none = (DIR_NONE, 0, None)
    n_gf = h["Lf"] if h["recal"] else 0
    pro, _ = node_hess_blocks(1, 1, len(dirs), n_gf)
    replay = exps + quots
    total = len(pro) * (grid + count_chain(Dual, none, none)[0] + quots
                        + h["n"])
    total += sum(sum(count_chain(Dual, d, none)) - replay for d in dirs)
    total += sum(sum(count_chain(Dual, (DIR_UNIT, ll, None), none))
                 - replay for ll in range(n_gf))
    total += sum(sum(count_chain(HyperDual, dirs[i], dirs[j])) - replay
                 for i, j in pair_table(len(dirs)))
    return total


def _legs_kernel_ops(h: dict, g: int, dd, tdl, gpv) -> int:
    """The operations of K9's (gpv None) or K11's block of one (scenario,
    member) at its grid dd [Ld] and tangent rows tdl [Qd, Ld]: the
    prologue counted on its Python mirror (:func:`legs_prologue`: the
    grid's transforms, the value DFs, the flows, the segments' and the
    targets' sums, the gradients; K11 gdd too), then, counted from the
    lists, 2 operations a term of each direction's G_s . t_d (K9's Jpv,
    K11's gamma) and, K11, 4 a value DF tap for beta, 2 a row entry of
    M_N and 3 a target (5 more at a value tap) for U, and 2 a row for
    each pair's t_i . U_j."""
    S, R = h["S"], int((h["lr_row"][g] >= 0).sum())
    Qd = tdl.shape[0]
    prol = _ops_of(lambda: legs_prologue(h, g, [Dual(float(x)) for x in dd],
                                         gpv))
    terms = int(h["ls_ptr"][g, S])
    if gpv is None:
        return prol + Qd * 2 * terms
    vt = sum(len(_taps(h["ld_i"][g, s, h["P"]])) for s in range(S))
    rows_m = int(h["mr_ptr"][g, R])
    rows_t = int(h["gd_ptr"][g, R])
    return prol + Qd * (2 * terms + 2 * vt + 2 * rows_m + 3 * rows_t
                        + 5 * vt) + Qd * (Qd + 1) // 2 * 2 * R


def needed_flops(name: str, tab: XccyStageTables, *args) -> dict:
    """The f64 operations of kernel ``name`` (K8-K12) on
    ``kernels.<name>(tab, *args)``'s inputs, counted by running
    :func:`thread_stage` / :func:`thread_legs` in :class:`Dual` and
    :class:`HyperDual` (their ``ops``) on scenario 0 of every member,
    times the scenarios:

    - ``needed``: what the function needs, a forward-mode evaluation that
      computes nothing twice: the primal once a (scenario, member), each
      direction's first tangent once (and, K10 / K11 / K12, each grid
      entry's for the gradient or the nodes' tangents), each pair i <=
      j's e1 e2 part once (K10 / K11, with the sum over the cotangents;
      K12 the chain to the nodes alone, no rows);
    - ``threads``: what the threads of the simple design compute, a
      thread the whole evaluation of a direction, a pair or a grid entry
      (K9 / K11's threads; K8 / K10's before they split the stage), each
      its primal and first tangents again;
    - ``kernel``: what the kernel's own design computes
      (:func:`_stage_kernel_ops` for K8 / K10 / K12, on the foreign grid
      transformed once a block, K10's replaying threads without the
      primal exps and quotients; :func:`_legs_kernel_ops` for K9 / K11,
      the legs' flows once a (scenario, member), then a dot a direction
      or pair).
    """
    h = tab.host()
    a = [x.cpu().numpy() if isinstance(x, torch.Tensor) else x
         for x in args]
    Sc = a[0].shape[0]
    none = (DIR_NONE, 0, None)
    need = threads = kernel = 0
    stage = name in ("xccy_stage_jvp", "xccy_stage_hess",
                     "xccy_stage_node_hess")
    second = name in ("xccy_stage_hess", "xccy_legs_hess",
                      "xccy_stage_node_hess")
    for g in range(tab.G):
        if stage:
            sp, pv, fd, tf = (x[0, g] if x is not None and k < 3 else x
                              for k, x in enumerate(a[:4]))
            dirs = [stage_dir(h, d, None if tf is None else tf[0, d, g])
                    for d in range(tab.D)]
            grid = h["Lf"] if tab.recal else 0
            cot = a[4][0, g] if name == "xccy_stage_hess" else None
            nodes = name == "xccy_stage_node_hess"

            def run(T, d1, d2):
                out = [T(0.0)]

                def sink(w, v):
                    if cot is not None:
                        out[0] = out[0] + v * float(cot[w])
                if nodes:
                    thread_chain(T, h, g, sp, pv, fd, d1, d2)
                else:
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
        own = 0
        if not second:
            own = sum(sum(c) for c in firsts)
        else:
            grads = [count(Dual, (DIR_UNIT, ll, None), none)
                     for ll in range(grid)]
            pairs = [count(HyperDual, dirs[i], dirs[j])
                     for i, j in pair_table(len(dirs))]
            need += sum(c[1] for c in grads) + sum(c[3] for c in pairs)
            own = sum(sum(c) for c in grads + pairs)
        threads += own
        if stage:
            tg = grid_transforms(h, g, fd)

            def count_chain(T, d1, d2):
                key = ("chain", T, _dir_key(d1), _dir_key(d2))
                if key not in memo:
                    T.ops = [0] * len(T.ops)
                    thread_chain(T, h, g, sp, pv, fd, d1, d2, tg)
                    memo[key] = list(T.ops)
                return memo[key]
            own = _stage_kernel_ops(name, h, g, sp, pv, fd, dirs,
                                    count_chain)
        else:
            own = _legs_kernel_ops(h, g, dd, a[1][0, :, g], cot)
        kernel += own
    return dict(needed=float(Sc * need), threads=float(Sc * threads),
                kernel=float(Sc * kernel))


# the tables each of K8-K11 reads (K9 reads part of K11's last four)
_K8_READS = ("pt_f", "pt_i", "v0", "fxs", "fq_i", "fq_f", "rq_i", "rq_f",
             "r_sch", "r_xs")
_K9_READS = ("leg_f", "leg_s", "li_i", "li_f", "ld_i", "ld_f", "lr_row",
             "ls_ptr", "ls_row", "lt_leg", "sc_ptr")
_READS = dict(
    xccy_stage_node_hess=("pt_f", "pt_i", "v0", "fxs", "fq_i", "fq_f",
                          "tp_off", "mat_pos", "nb_ptr", "nb_pt"),
    xccy_stage_jvp=_K8_READS,
    xccy_stage_hess=_K8_READS + ("nr_ptr", "nr_row", "mb_pq", "mb_ptr",
                                 "mb_row", "tp_off"),
    xccy_legs_jvp=_K9_READS,
    xccy_legs_hess=_K9_READS + ("lr_of", "gd_ptr", "gd_t", "me_rc",
                                "mr_ptr", "mr_e", "lt_term", "sg", "ts_ptr",
                                "ts_seg"))


def needed_bytes(name: str, tab: XccyStageTables, *args) -> int:
    """The bytes kernel ``name`` (K8-K12) must move on
    ``kernels.<name>(tab, *args)``'s inputs, each input read once and
    each output written once: the tables the kernel reads (``_READS``;
    K9 only the segments of the legs' sums and gradients, their targets'
    segment lists and the value DFs' rows of ``lr_of``), the scenario
    inputs in full but the grids, and each grid only at the entries its
    plan reads: K8 / K10 / K12's foreign DFs ``fd``, their tangents
    ``tf`` and ``f_xs`` at the taps of ``fq``, K9 / K11's domestic
    ``dd``, ``tdl`` and ``d_xs`` at the legs' rows (``lr_row``); K12's
    outputs ds, Jn, Jfd and Hn whole, both mirrors of Hn."""
    h = tab.host()
    Sc, G, S, D, Qd = args[0].shape[0], tab.G, tab.S, tab.D, tab.Qd
    nb = sum(h[k].nbytes for k in _READS[name])
    if name in ("xccy_legs_jvp", "xccy_legs_hess"):
        taps = int((h["lr_row"] >= 0).sum())
        grids = (1 + Qd) * Sc * taps + taps             # dd, tdl, d_xs
        outs = S + Qd * S if name == "xccy_legs_jvp" \
            else tab.Ld + Qd * Qd                       # pv0, jpv | gdd, Hl
        ins = S if name == "xccy_legs_hess" else 0      # gpv
        if name == "xccy_legs_jvp":
            NL = h["ls_row"].shape[1]
            for g in range(G):
                sc = h["sc_ptr"][g]
                ks = np.concatenate([np.arange(sc[2 * c], sc[2 * c + 1])
                                     for c in range(len(sc) // 2)])
                sg = h["sg"][g, ks]
                nt = int(h["ts_ptr"][g, S + NL])
                vtaps = sum(len(_taps(h["ld_i"][g, s, h["P"]]))
                            for s in range(S))
                nb += 4 * (sg.size + int((sg[:, 1] - sg[:, 0]).sum())
                           + S + NL + 1 + nt + vtaps)
    else:
        taps = sum(len({x for q in h["fq_i"][g] for x in _taps(q)})
                   for g in range(G))
        grids = (1 + (D if tab.recal else 0)) * Sc * taps + taps
        if name == "xccy_stage_jvp":
            outs = tab.U1 + tab.W + D * tab.W
        elif name == "xccy_stage_hess":
            outs = D + (tab.Lf if tab.recal else 0) + D * D
        else:
            outs = tab.U1 * (1 + D + (tab.Lf if tab.recal else 0) + D * D)
        ins = 2 * S + (tab.W if name == "xccy_stage_hess" else 0)
    return nb + 8 * (grids + Sc * G * (ins + outs))
