"""Multi-currency, multi-curve book-scale pricing and risk (OIS slice).

Port of ``adrates_tpu/parallel/multibook.py``: the same design — one
shared unique-time grid, per-trade gathers, aggregate-weight AD:

 - a **CurveBasket** compiles a Model's curves into ONE differentiable
   function quotes -> flat DF vector over the book's COMPACTED grid axis
   (only the (curve, time) pairs some trade references);
 - a **MultiBook** holds every leg of every trade as padded index rows
   with the curve ids folded into the gather indices at compile time,
   and derives the COLUMN form (``ColRows``) the PV sweep runs on: one
   (column, weight) slot per cashflow against the per-scenario value
   vector [DF grid, forward-triple table];
 - FX conversion to the base currency is folded into the row weights;
 - the book's TOTAL PV collapses onto O(n_grid + T) aggregate weights, so
   the book delta ladder and gamma cost one trade's.

``make_multibook_fn(mb, device)`` is the device path: per scenario chunk,
J = ∂dfs/∂q by ``vmap(jvp)``, g = ∂total/∂dfs by ``grad``, delta = J g,
gamma = term1 (the hand-written K2 kernel) + term2 (``jacfwd(grad(..))``
of g0·grids); then the per-trade PVs of every scenario in one sweep (the
hand-written K1 kernel).

Ported here: OIS trades under natural collateral, OIS curves, the three
simple interpolation schemes. Other instruments, foreign collateral and
other curve kinds raise ``LibError``.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch.func import grad, jacfwd, jvp, vmap

from ..ops import kernels
from ..utils.currency import CurrencyTypes
from ..utils.error import LibError
from ..utils.global_types import InstrumentTypes, InterpTypes
from ..utils.observability import timed
from .curve_batching import bat_to_torch, build_batched_grids

# Bytes allowed for the risk pass's live f64 tangent stacks of one
# scenario chunk. The generic split holds about three [chunk, N, C*U]
# stacks live at once (J before compaction, and the curve-Hessian
# contraction's forward tangents through the dense rows), so the chunk is
# budget // (3 * N * C*U * 8): at the flagship OIS slice (N = 144) that is
# tens of scenarios per chunk, well inside an 80 GB card.
RISK_CHUNK_BYTES = 4 * 1024 ** 3


# ---------------------------------------------------------------------------
# Curve basket: the model's curves as one differentiable system
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _CurveSpec:
    name: str
    kind: str                      # 'ois' (the only kind ported)
    interp_type: InterpTypes
    n_quotes: int
    offset: int                    # slice start in the packed quote vector


class CurveBasket:
    """Compiles a Model's OIS curves into one differentiable quotes->grids
    function over a packed quote vector.

    Curve order: by NAME (the model dict's insertion order is build
    order, which would make the quote packing and the grid compaction
    depend on it); explicit ``curve_names`` keep caller order.
    ``specs[i].offset`` locates curve i's quotes inside the packed
    vector."""

    def __init__(self, model, curve_names: Optional[List[str]] = None):
        from ..trades.rates.ois_curve import OISCurve

        explicit = curve_names is not None
        names = curve_names or list(model._curves_dict)
        ois = []
        for n in names:
            c = model._curves_dict[n]
            if not isinstance(c, OISCurve):
                raise LibError(f"not yet ported: {type(c).__name__} "
                               f"curve {n} in a basket")
            ois.append((n, c))
        if not explicit:
            ois.sort(key=lambda nc: nc[0])

        self.model = model
        self.specs: List[_CurveSpec] = []
        self.curves: List[object] = []
        self._id_by_name: Dict[str, int] = {}
        params: Dict = {"ois_plans": []}
        quotes0 = []
        offset = 0
        for name, curve in ois:
            n_q = len(curve.swap_rates)
            self.specs.append(_CurveSpec(name, "ois", curve._interp_type,
                                         n_q, offset))
            self._id_by_name[name] = len(self.curves)
            self.curves.append(curve)
            params["ois_plans"].append(curve._plan)
            quotes0.append(np.asarray(curve.swap_rates, dtype=np.float64))
            offset += n_q
        params["ois_plans"] = tuple(params["ois_plans"])
        self.params = params
        self.quotes0 = np.concatenate(quotes0) if quotes0 \
            else np.zeros(0)
        self.n_quotes = offset
        self.n_curves = len(self.curves)
        self.grid_sel = None
        self.n_grid = None

    def curve_id(self, name: str) -> int:
        return self._id_by_name[name]

    def quote_slice(self, name: str) -> slice:
        spec = self.specs[self._id_by_name[name]]
        return slice(spec.offset, spec.offset + spec.n_quotes)

    def grids_fn(self, unique_times, stage_buckets: str = "fine",
                 grid_sel=None):
        """The pure fn (qvec, P) -> flat DF vector over the book's grid
        axis: every curve interpolated over the shared unique-time grid,
        rows concatenated in curve-id order (dense global index =
        curve_id * U + time_idx), then restricted to ``grid_sel`` (sorted
        int array into the dense [C*U] axis) — the compaction
        compile_multibook applies. Sets ``grid_sel/n_grid/grid_curve_of``
        and the host stage plans ``bat``/``stages``."""
        ut = np.asarray(unique_times)
        U = ut.shape[0]
        if grid_sel is None:
            grid_sel = np.arange(self.n_curves * U, dtype=np.int32)
        grid_sel = np.asarray(grid_sel, dtype=np.int32)
        self.grid_sel = grid_sel
        self.n_grid = int(grid_sel.shape[0])
        self.grid_curve_of = (grid_sel // U).astype(np.int32)
        grids, bat, stages = build_batched_grids(
            self, ut, stage_buckets=stage_buckets)
        self.unique_times = ut
        self.bat = bat
        self.stages = stages
        return grids


# ---------------------------------------------------------------------------
# Multi-book tables (host numpy)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MultiBookRows:
    """One pad-bucket of legs ("rows"): [R, P] padded index/amount arrays
    with GLOBAL gather indices (curve id folded in at compile time).
    FX-to-base and leg signs are folded into the amount weights."""
    fix_idx: np.ndarray              # [R, P] int32 into the compact grid
    fix_payments: np.ndarray         # [R, P]
    fix_mask: np.ndarray             # [R, P]
    flt_pay_idx: np.ndarray          # [R, P] int32 (disc curve)
    flt_start_idx: np.ndarray        # [R, P] int32 (proj curve)
    flt_end_idx: np.ndarray          # [R, P] int32 (proj curve)
    flt_pay_alphas: np.ndarray       # [R, P]
    flt_index_alphas: np.ndarray     # [R, P]
    flt_spreads: np.ndarray          # [R, P]
    flt_notionals: np.ndarray        # [R, P] signed, fx-folded
    flt_mask: np.ndarray             # [R, P]
    row_trade: np.ndarray            # [R] int32 owning trade

    @property
    def num_rows(self) -> int:
        return self.fix_idx.shape[0]


@dataclasses.dataclass(frozen=True)
class ClampSlots:
    """Cap/floor-clamped float coupons (nonlinear in the DFs): kept
    per-slot. PV = w * clip((df_s/df_e - 1)/ia + spread, floor, cap)
    * df_p, with w = sign * fx * alpha * notional. Arrays are numpy on
    the host and tensors on the device."""
    s_idx: np.ndarray                # [K] int32
    e_idx: np.ndarray                # [K] int32
    p_idx: np.ndarray                # [K] int32
    ia: np.ndarray                   # [K] index-basis alphas
    w: np.ndarray                    # [K]
    spread: np.ndarray               # [K]
    cap: np.ndarray                  # [K]
    floor: np.ndarray                # [K]
    slot_trade: np.ndarray           # [K] int32


@dataclasses.dataclass(frozen=True)
class ColRows:
    """One pad-bucket of legs in COLUMN form: every cashflow is a single
    (column, weight) slot against the per-scenario value vector
    v = concat(dfs_flat [n_grid], tripvals [T]) where
    tripvals[t] = (df_s/df_e - 1) * df_p over the aggregate's
    deduplicated forward triples."""
    col_idx: np.ndarray              # [R, L] int32 into [n_grid + T]
    w: np.ndarray                    # [R, L] (0.0 = dead slot)
    row_trade: np.ndarray            # [R] int32 owning trade


@dataclasses.dataclass(frozen=True)
class MultiBookAggregate:
    """The book's TOTAL base-ccy PV collapsed onto the compact flat grid:
    linear weights + deduplicated forward triples (+ clamp slots handled
    separately)."""
    w_lin: np.ndarray                # [n_grid]
    trip_s: np.ndarray               # [T] int32
    trip_e: np.ndarray               # [T] int32
    trip_p: np.ndarray               # [T] int32
    trip_w: np.ndarray               # [T]


@dataclasses.dataclass(frozen=True)
class TileSpec:
    """Lazy tiling: the book is ``base x n_copies`` with per-copy
    notional multipliers, expanded to full row tensors on the device once
    at function-build time (only the base book crosses the host->device
    boundary)."""
    scale: np.ndarray                # [n_copies] notional multipliers
    base_trades: int


@dataclasses.dataclass
class MultiBook:
    """A compiled multi-currency book: pad-bucketed rows + clamp slots +
    aggregate + the basket that produced the gather indices. When
    ``tile`` is set, buckets/clamp/cols hold the BASE book (aggregate is
    already at tiled scale)."""
    basket: CurveBasket
    unique_times: np.ndarray
    buckets: Tuple[MultiBookRows, ...]
    clamp: Optional[ClampSlots]
    aggregate: MultiBookAggregate
    n_trades: int
    base_currency: CurrencyTypes
    tile: Optional[TileSpec] = None
    cols: Tuple[ColRows, ...] = ()   # column form of `buckets` (same PVs)


# ---------------------------------------------------------------------------
# compilation (host)
# ---------------------------------------------------------------------------


class _Interner:
    def __init__(self):
        self._by_key = {}
        self._times = []

    def add(self, t: float) -> int:
        key = round(float(t), 12)
        idx = self._by_key.get(key)
        if idx is None:
            idx = len(self._times)
            self._by_key[key] = idx
            self._times.append(float(t))
        return idx

    def finish(self):
        order = np.argsort(np.asarray(self._times))
        remap = np.empty(len(order), dtype=np.int64)
        remap[order] = np.arange(len(order))
        return np.asarray(self._times)[order], remap


def _fx_to_base(model, ccy: CurrencyTypes, base: CurrencyTypes) -> float:
    if ccy == base:
        return 1.0
    return model.fx(f"{ccy.name}{base.name}")


def _float_row(tensor, disc_id: int, proj_id: int, fx: float,
               trade_id: int, clamp_rows: list):
    """Compile a FloatLegTensor into one row dict (+ optional clamp
    slots). Exchanges and first-fixing coupons move to the FIX side."""
    sign = float(tensor.leg_sign)
    w = fx * sign
    pay_t = np.asarray(tensor.payment_times, dtype=np.float64)
    start_t = np.asarray(tensor.start_times, dtype=np.float64)
    end_t = np.asarray(tensor.end_times, dtype=np.float64)
    pay_a = np.asarray(tensor.pay_alphas, dtype=np.float64)
    idx_a = np.asarray(tensor.index_alphas, dtype=np.float64)
    spreads = np.asarray(tensor.spreads, dtype=np.float64)
    notionals = np.asarray(tensor.notionals, dtype=np.float64)
    n = pay_t.shape[0]

    fix_t, fix_amt, fix_m = [], [], []
    flt = dict(pay=[], s=[], e=[], pa=[], ia=[], sp=[], no=[], m=[])

    for j in range(n):
        live = pay_t[j] > 0.0
        amt_extra = float(tensor.principal) if j == n - 1 else 0.0
        if tensor.override_first and j == 0:
            # known fixing: the coupon is a fixed cashflow
            rate = float(tensor.first_fixing_rate) + spreads[j]
            if tensor.has_cap_floor:
                rate = min(max(rate, float(tensor.floor_rate)),
                           float(tensor.cap_rate))
            fix_t.append(pay_t[j])
            fix_amt.append(w * (rate * pay_a[j] * notionals[j] + amt_extra))
            fix_m.append(1.0 if live else 0.0)
            continue
        if amt_extra:
            fix_t.append(pay_t[j])
            fix_amt.append(w * amt_extra)
            fix_m.append(1.0 if live else 0.0)
        if tensor.has_cap_floor:
            if live:
                clamp_rows.append(dict(
                    s=(proj_id, start_t[j]), e=(proj_id, end_t[j]),
                    p=(disc_id, pay_t[j]), ia=idx_a[j],
                    w=w * pay_a[j] * notionals[j], spread=spreads[j],
                    cap=float(tensor.cap_rate),
                    floor=float(tensor.floor_rate), trade=trade_id))
            continue
        flt["pay"].append(pay_t[j])
        flt["s"].append(start_t[j])
        flt["e"].append(end_t[j])
        flt["pa"].append(pay_a[j])
        flt["ia"].append(idx_a[j])
        flt["sp"].append(spreads[j])
        flt["no"].append(w * notionals[j])
        flt["m"].append(1.0 if live else 0.0)

    if tensor.notional_exchange:
        amt = float(tensor.notional_exchange_amount)
        for t, a in [(float(tensor.effective_time), -amt),
                     (float(tensor.maturity_time), amt)]:
            fix_t.append(t)
            fix_amt.append(w * a)
            fix_m.append(1.0 if t >= 0.0 else 0.0)  # exchange AT value
            #   date still settles today (direct value() parity)

    return dict(trade=trade_id, disc=disc_id, proj=proj_id,
                fix_t=fix_t, fix_amt=fix_amt, fix_m=fix_m, flt=flt)


def _fixed_row(payment_times, amounts, disc_id: int, fx: float, sign: float,
               trade_id: int, extra_exchanges=None):
    """Fixed cashflows (+ optional (time, amount) exchanges with >= 0
    liveness)."""
    w = fx * sign
    fix_t = [float(t) for t in payment_times]
    fix_amt = [w * float(a) for a in amounts]
    fix_m = [1.0 if t > 0.0 else 0.0 for t in fix_t]
    for t, a in (extra_exchanges or []):
        fix_t.append(float(t))
        fix_amt.append(w * float(a))
        fix_m.append(1.0 if t >= 0.0 else 0.0)
    return dict(trade=trade_id, disc=disc_id, proj=disc_id,
                fix_t=fix_t, fix_amt=fix_amt, fix_m=fix_m,
                flt=dict(pay=[], s=[], e=[], pa=[], ia=[], sp=[], no=[],
                         m=[]))


def _rows_for_instrument(inst, model, basket: CurveBasket, base, value_dt,
                         trade_id: int, clamp_rows: list,
                         collateral_type=None) -> list:
    """Compile one instrument into row dicts (reference semantics:
    engine.py:2639-2728 dual-curve floats). Only OIS under natural
    collateral is ported."""
    itype = inst.derivative_type
    if itype != InstrumentTypes.OIS_SWAP:
        raise LibError(f"not yet ported: {itype} in a multibook")
    if collateral_type is not None:
        from ..utils.global_types import collateral_to_currency
        if collateral_to_currency(collateral_type) != inst._currency:
            raise LibError("not yet ported: OIS under foreign collateral")

    cid = basket.curve_id(inst._floating_index.name)
    curve = basket.curves[cid]
    fx = _fx_to_base(model, inst._currency, base)
    ft = inst._fixed_leg.tensor(value_dt)
    lt = inst._float_leg.tensor(value_dt, index_dc=curve._dc_type)
    return [_fixed_row(ft.payment_times, np.asarray(ft.payments), cid, fx,
                       float(ft.leg_sign), trade_id),
            _float_row(lt, cid, cid, fx, trade_id, clamp_rows)]


def compile_multibook(instruments, model,
                      base_currency: CurrencyTypes = CurrencyTypes.GBP,
                      curve_names: Optional[List[str]] = None,
                      n_buckets: int = 4,
                      collateral_types: Optional[Sequence] = None,
                      stage_buckets: str = "fine") -> MultiBook:
    """Compile a multi-currency book against a Model (host numpy).

    Returns a MultiBook whose rows gather from the COMPACTED flat DF
    vector produced by ``basket.grids`` (only the (curve, time) pairs the
    book references); all PVs are in ``base_currency``.

    ``collateral_types``: optional per-trade CollateralType list (None
    entries = natural collateral; foreign collateral is not ported).
    ``stage_buckets``: "fine" (default) or "coarse" — OIS stage-group
    shape-bucket coarseness, see curve_batching.build_batched_grids.
    """
    if collateral_types is not None \
            and len(collateral_types) != len(instruments):
        raise LibError("collateral_types must parallel instruments")

    basket = CurveBasket(model, curve_names)
    value_dt = model.value_dt

    clamp_rows: list = []
    rows: list = []
    with timed("multibook.compile", trades=len(instruments),
               curves=basket.n_curves):
        for t_id, inst in enumerate(instruments):
            coll = collateral_types[t_id] if collateral_types else None
            rows += _rows_for_instrument(inst, model, basket,
                                         base_currency, value_dt, t_id,
                                         clamp_rows,
                                         collateral_type=coll)

    intern = _Interner()
    intern.add(0.0)

    # First pass: intern every (time) once; rows store temp indices.
    for r in rows:
        r["fix_ti"] = [intern.add(t) for t in r["fix_t"]]
        r["flt_pi"] = [intern.add(t) for t in r["flt"]["pay"]]
        r["flt_si"] = [intern.add(t) for t in r["flt"]["s"]]
        r["flt_ei"] = [intern.add(t) for t in r["flt"]["e"]]
    for c in clamp_rows:
        c["si"] = intern.add(c["s"][1])
        c["ei"] = intern.add(c["e"][1])
        c["pi"] = intern.add(c["p"][1])

    unique_times, remap = intern.finish()
    U = unique_times.shape[0]

    def gidx(curve_id, tmp):
        return curve_id * U + int(remap[tmp])

    # Bucket rows by padded length.
    def row_size(r):
        return max(len(r["fix_ti"]),
                   len(r["flt_pi"]), 1)

    order = np.argsort([row_size(r) for r in rows], kind="stable")
    n = len(rows)
    bounds = np.linspace(0, n, min(n_buckets, n) + 1).astype(int)
    spans = []
    sizes_sorted = [row_size(rows[i]) for i in order]
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        if hi <= lo:
            continue
        pad = max(sizes_sorted[lo:hi])
        if spans and spans[-1][2] == pad:
            spans[-1] = (spans[-1][0], hi, pad)
        else:
            spans.append((lo, hi, pad))

    buckets = []
    for lo, hi, P in spans:
        sel = [rows[i] for i in order[lo:hi]]
        R = len(sel)
        arr = dict(
            fix_idx=np.zeros((R, P), dtype=np.int32),
            fix_payments=np.zeros((R, P)),
            fix_mask=np.zeros((R, P)),
            flt_pay_idx=np.zeros((R, P), dtype=np.int32),
            flt_start_idx=np.zeros((R, P), dtype=np.int32),
            flt_end_idx=np.zeros((R, P), dtype=np.int32),
            flt_pay_alphas=np.zeros((R, P)),
            flt_index_alphas=np.zeros((R, P)),
            flt_spreads=np.zeros((R, P)),
            flt_notionals=np.zeros((R, P)),
            flt_mask=np.zeros((R, P)),
            row_trade=np.zeros(R, dtype=np.int32))
        for k, r in enumerate(sel):
            arr["row_trade"][k] = r["trade"]
            nf = len(r["fix_ti"])
            arr["fix_idx"][k, :nf] = [gidx(r["disc"], t)
                                      for t in r["fix_ti"]]
            arr["fix_payments"][k, :nf] = r["fix_amt"]
            arr["fix_mask"][k, :nf] = r["fix_m"]
            nl = len(r["flt_pi"])
            arr["flt_pay_idx"][k, :nl] = [gidx(r["disc"], t)
                                          for t in r["flt_pi"]]
            arr["flt_start_idx"][k, :nl] = [gidx(r["proj"], t)
                                            for t in r["flt_si"]]
            arr["flt_end_idx"][k, :nl] = [gidx(r["proj"], t)
                                          for t in r["flt_ei"]]
            arr["flt_pay_alphas"][k, :nl] = r["flt"]["pa"]
            arr["flt_index_alphas"][k, :nl] = r["flt"]["ia"]
            arr["flt_spreads"][k, :nl] = r["flt"]["sp"]
            arr["flt_notionals"][k, :nl] = r["flt"]["no"]
            arr["flt_mask"][k, :nl] = r["flt"]["m"]
        buckets.append(MultiBookRows(**arr))

    clamp = None
    if clamp_rows:
        clamp = ClampSlots(
            s_idx=np.array([gidx(c["s"][0], c["si"]) for c in clamp_rows],
                           dtype=np.int32),
            e_idx=np.array([gidx(c["e"][0], c["ei"]) for c in clamp_rows],
                           dtype=np.int32),
            p_idx=np.array([gidx(c["p"][0], c["pi"]) for c in clamp_rows],
                           dtype=np.int32),
            ia=np.array([c["ia"] for c in clamp_rows]),
            w=np.array([c["w"] for c in clamp_rows]),
            spread=np.array([c["spread"] for c in clamp_rows]),
            cap=np.array([c["cap"] for c in clamp_rows]),
            floor=np.array([c["floor"] for c in clamp_rows]),
            slot_trade=np.array([c["trade"] for c in clamp_rows],
                                dtype=np.int32))

    # ---- grid compaction ------------------------------------------------
    # Keep only the (curve, time) pairs the book's index tables reference
    # (the dense [C*U] layout evaluates every curve at every unique time,
    # and the grid axis is the risk pass's tangent width): remap every
    # index table onto the compacted axis (global index order is
    # preserved, so the compact axis is still curve-major). A curve no
    # trade references keeps no column, so its quotes get exactly-zero
    # risk.
    used = np.zeros(basket.n_curves * U, dtype=bool)
    used[0] = True                    # dead-slot target (curve 0, t=0)
    for b in buckets:
        for nm in ("fix_idx", "flt_pay_idx", "flt_start_idx",
                   "flt_end_idx"):
            used[np.asarray(getattr(b, nm)).ravel()] = True
    if clamp is not None:
        for nm in ("s_idx", "e_idx", "p_idx"):
            used[np.asarray(getattr(clamp, nm))] = True
    grid_sel = np.flatnonzero(used).astype(np.int32)
    new_of_old = np.full(basket.n_curves * U, -1, dtype=np.int32)
    new_of_old[grid_sel] = np.arange(grid_sel.shape[0], dtype=np.int32)

    def _remap(idx):
        return new_of_old[np.asarray(idx)].astype(np.int32)

    buckets = [dataclasses.replace(
        b, fix_idx=_remap(b.fix_idx), flt_pay_idx=_remap(b.flt_pay_idx),
        flt_start_idx=_remap(b.flt_start_idx),
        flt_end_idx=_remap(b.flt_end_idx)) for b in buckets]
    if clamp is not None:
        clamp = dataclasses.replace(
            clamp, s_idx=_remap(clamp.s_idx), e_idx=_remap(clamp.e_idx),
            p_idx=_remap(clamp.p_idx))

    referenced = {r["disc"] for r in rows} | {r["proj"] for r in rows} \
        | {c[k][0] for c in clamp_rows for k in ("s", "e", "p")}
    idle = [s.name for i, s in enumerate(basket.specs) if i not in referenced]
    if idle:
        warnings.warn(f"no trade references curve(s) {idle}: their quotes "
                      f"carry exactly zero delta and gamma", stacklevel=2)

    n_grid = int(grid_sel.shape[0])
    agg = _aggregate(buckets, n_grid)
    cols = _build_cols(buckets, agg, n_grid, n_buckets)
    basket.grids = basket.grids_fn(unique_times,
                                   stage_buckets=stage_buckets,
                                   grid_sel=grid_sel)

    return MultiBook(basket=basket, unique_times=unique_times,
                     buckets=tuple(buckets), clamp=clamp, aggregate=agg,
                     n_trades=len(instruments),
                     base_currency=base_currency, cols=cols)


def _optimal_spans(sizes_sorted: np.ndarray, k: int):
    """Partition the SORTED slot-count list into <= k contiguous spans
    minimizing total padded slots sum((hi-lo) * max_size_in_span). The DP
    runs over DISTINCT sizes (span boundaries only ever sit at size
    changes), so it is O(d^2 k) with d <= max row length."""
    ends = np.flatnonzero(np.diff(sizes_sorted, append=-1)) + 1
    d = len(ends)
    starts = np.concatenate([[0], ends[:-1]])
    size_of = sizes_sorted[ends - 1]
    k = min(k, d)
    INF = float("inf")
    # best[j][g] = min padded cost covering groups [0, g) with j spans
    best = np.full((k + 1, d + 1), INF)
    best[0][0] = 0.0
    choice = np.zeros((k + 1, d + 1), dtype=np.int64)
    for j in range(1, k + 1):
        for g in range(1, d + 1):
            hi = ends[g - 1]
            for g0 in range(g):
                if best[j - 1][g0] == INF:
                    continue
                lo = starts[g0]
                c = best[j - 1][g0] + (hi - lo) * size_of[g - 1]
                if c < best[j][g]:
                    best[j][g] = c
                    choice[j][g] = g0
    spans = []
    g = d
    j = int(np.argmin(best[:, d]))
    while g > 0:
        g0 = choice[j][g]
        spans.append((int(starts[g0]), int(ends[g - 1])))
        g = g0
        j -= 1
    return spans[::-1]


def _build_cols(buckets, agg: MultiBookAggregate, CU: int,
                n_buckets: int) -> Tuple[ColRows, ...]:
    """Derive the column representation from the padded buckets: one
    (col, w) slot per live fixed coupon / spread term / forward term,
    with forward terms remapped onto the aggregate's deduplicated trip
    table (trip t's column is CU + t)."""
    uniq_key = ((agg.trip_s.astype(np.int64) * CU
                 + agg.trip_e.astype(np.int64)) * CU
                + agg.trip_p.astype(np.int64))
    slots = []                       # (trade, [(col, w), ...])
    for b in buckets:
        R = b.fix_idx.shape[0]
        fix_idx = np.asarray(b.fix_idx)
        fix_w = np.asarray(b.fix_payments) * np.asarray(b.fix_mask)
        pay = np.asarray(b.flt_pay_idx)
        spr_w = (np.asarray(b.flt_spreads) * np.asarray(b.flt_pay_alphas)
                 * np.asarray(b.flt_notionals) * np.asarray(b.flt_mask))
        ia = np.asarray(b.flt_index_alphas)
        pa = np.asarray(b.flt_pay_alphas)
        ratio = np.where(ia > 0.0, pa / np.where(ia > 0.0, ia, 1.0), 0.0)
        fwd_w = (np.asarray(b.flt_notionals) * ratio
                 * np.asarray(b.flt_mask))
        key = ((np.asarray(b.flt_start_idx).astype(np.int64) * CU
                + np.asarray(b.flt_end_idx).astype(np.int64)) * CU
               + pay.astype(np.int64))
        trip_col = CU + np.searchsorted(uniq_key, key)
        row_trade = np.asarray(b.row_trade)
        for k in range(R):
            s: list = []
            live = fix_w[k] != 0.0
            s += list(zip(fix_idx[k][live].tolist(),
                          fix_w[k][live].tolist()))
            live = spr_w[k] != 0.0
            s += list(zip(pay[k][live].tolist(), spr_w[k][live].tolist()))
            live = fwd_w[k] != 0.0
            s += list(zip(trip_col[k][live].tolist(),
                          fwd_w[k][live].tolist()))
            slots.append((int(row_trade[k]), s))

    order = sorted(range(len(slots)), key=lambda i: len(slots[i][1]))
    sizes_sorted = np.array([len(slots[i][1]) for i in order])
    # the sweep's traffic is proportional to PADDED slots, so the column
    # form gets more spans than the row buckets
    spans = _optimal_spans(sizes_sorted, max(n_buckets, 8)) \
        if len(slots) else []
    cols = []
    for lo, hi in spans:
        sel = [slots[i] for i in order[lo:hi]]
        L = max(max((len(s) for _, s in sel), default=1), 1)
        R = len(sel)
        ci = np.zeros((R, L), dtype=np.int32)
        wi = np.zeros((R, L))
        rt = np.zeros(R, dtype=np.int32)
        for k, (t, s) in enumerate(sel):
            rt[k] = t
            for j, (c, w) in enumerate(s):
                ci[k, j] = c
                wi[k, j] = w
        cols.append(ColRows(col_idx=ci, w=wi, row_trade=rt))
    return tuple(cols)


def _aggregate(buckets, CU: int) -> MultiBookAggregate:
    """Collapse the linear rows to aggregate weights (host-side)."""
    w_lin = np.zeros(CU)
    ss, ee, pp, ww = [], [], [], []
    for b in buckets:
        fix_idx = np.asarray(b.fix_idx).ravel()
        fix_w = (np.asarray(b.fix_payments)
                 * np.asarray(b.fix_mask)).ravel()
        w_lin += np.bincount(fix_idx, weights=fix_w, minlength=CU)

        pay = np.asarray(b.flt_pay_idx).ravel()
        spread_w = (np.asarray(b.flt_spreads)
                    * np.asarray(b.flt_pay_alphas)
                    * np.asarray(b.flt_notionals)
                    * np.asarray(b.flt_mask)).ravel()
        w_lin += np.bincount(pay, weights=spread_w, minlength=CU)

        ia = np.asarray(b.flt_index_alphas)
        pa = np.asarray(b.flt_pay_alphas)
        scale = np.where(ia > 0.0, pa / np.where(ia > 0.0, ia, 1.0), 0.0)
        w = (np.asarray(b.flt_notionals) * scale
             * np.asarray(b.flt_mask)).ravel()
        live = w != 0.0
        ss.append(np.asarray(b.flt_start_idx).ravel()[live])
        ee.append(np.asarray(b.flt_end_idx).ravel()[live])
        pp.append(pay[live])
        ww.append(w[live])

    s = np.concatenate(ss) if ss else np.zeros(0, dtype=np.int64)
    e = np.concatenate(ee) if ee else np.zeros(0, dtype=np.int64)
    p = np.concatenate(pp) if pp else np.zeros(0, dtype=np.int64)
    w = np.concatenate(ww) if ww else np.zeros(0)
    key = (s.astype(np.int64) * CU + e) * CU + p
    uniq, inverse = np.unique(key, return_inverse=True)
    trip_w = np.bincount(inverse, weights=w)
    return MultiBookAggregate(
        w_lin=w_lin,
        trip_s=(uniq // (CU * CU)).astype(np.int32),
        trip_e=((uniq // CU) % CU).astype(np.int32),
        trip_p=(uniq % CU).astype(np.int32),
        trip_w=trip_w)


def tile_multibook(mb: MultiBook, n_copies: int,
                   notional_scale=None) -> MultiBook:
    """Scale a compiled multibook up by tiling its rows with per-copy
    notional multipliers (copies share schedules and curves; amounts
    differ). Trade k of copy c becomes trade c * B + k. Lazy: the
    returned book keeps the base tables plus a TileSpec, and
    ``make_multibook_fn`` expands them on the device."""
    if notional_scale is None:
        notional_scale = np.ones(n_copies)
    scale = np.asarray(notional_scale, dtype=np.float64)
    if mb.tile is not None:
        raise LibError("multibook is already lazily tiled")
    total = float(scale.sum())
    agg = MultiBookAggregate(
        w_lin=np.asarray(mb.aggregate.w_lin) * total,
        trip_s=mb.aggregate.trip_s, trip_e=mb.aggregate.trip_e,
        trip_p=mb.aggregate.trip_p,
        trip_w=np.asarray(mb.aggregate.trip_w) * total)
    return dataclasses.replace(
        mb, aggregate=agg, n_trades=mb.n_trades * n_copies,
        tile=TileSpec(scale=scale, base_trades=mb.n_trades))


def _trade_row_table(mb: MultiBook) -> np.ndarray:
    """Static [B, K] row-gather table over the concatenated per-bucket
    row-PV vector (bucket-major; within a lazily tiled bucket the device
    expansion is copy-major, row index c*R_b + r — see _expand_cols).
    Dead slots point at the appended zero row R_total."""
    base_R = [cb.col_idx.shape[0] for cb in mb.cols]
    offs = np.cumsum([0] + list(base_R))
    if mb.tile is not None:
        n_cop = int(mb.tile.scale.shape[0])
        B_base = int(mb.tile.base_trades)
        offs = np.cumsum([0] + [R * n_cop for R in base_R])
    else:
        n_cop = 1
        B_base = mb.n_trades
    R_total = int(offs[-1])

    rows_of: List[list] = [[] for _ in range(B_base)]
    for bi, cb in enumerate(mb.cols):
        rt = np.asarray(cb.row_trade)
        for r in range(rt.shape[0]):
            rows_of[int(rt[r])].append((int(offs[bi]) + r, base_R[bi]))
    K = max((len(x) for x in rows_of), default=1)
    base_idx = np.full((B_base, K), R_total, dtype=np.int64)
    stride = np.zeros((B_base, K), dtype=np.int64)
    for t, lst in enumerate(rows_of):
        for k, (gidx, rb) in enumerate(lst):
            base_idx[t, k] = gidx
            stride[t, k] = rb
    if n_cop == 1:
        return base_idx.astype(np.int32)
    copies = np.arange(n_cop, dtype=np.int64)
    idx = (base_idx[None, :, :]
           + copies[:, None, None] * stride[None, :, :])
    return idx.reshape(n_cop * B_base, K).astype(np.int32)


def _term1_trip_groups(basket, agg: MultiBookAggregate):
    """Host-side signature grouping of the trip table for the quad form:
    a trip's three J columns are nonzero ONLY on the quote slots of the
    curves they belong to, so the [N, T] @ [T, N] contraction can run at
    each group's closed quote width k instead of full N. Returns a list
    of dicts of static int index arrays (``tsel`` into the trip table,
    ``s_idx``/``e_idx``/``p_idx``, the group's quote ``segs`` and width
    ``k``), or None when the basket lacks grid metadata."""
    curve_of = getattr(basket, "grid_curve_of", None)
    if curve_of is None or agg.trip_s.shape[0] == 0:
        return None
    curve_of = np.asarray(curve_of)
    specs = basket.specs

    ts = np.asarray(agg.trip_s)
    te = np.asarray(agg.trip_e)
    tp = np.asarray(agg.trip_p)
    cs, ce, cp = curve_of[ts], curve_of[te], curve_of[tp]
    by_sig: Dict[frozenset, List[int]] = {}
    for t in range(ts.shape[0]):
        sig = frozenset((int(cs[t]), int(ce[t]), int(cp[t])))
        by_sig.setdefault(sig, []).append(t)

    groups = []
    for sig, tidx in sorted(by_sig.items(),
                            key=lambda kv: sorted(kv[0])):
        raw = sorted((specs[c].offset, specs[c].n_quotes) for c in sig)
        segs: List[tuple] = []
        for off, n in raw:                  # merge adjacent quote slices
            if segs and segs[-1][0] + segs[-1][1] == off:
                segs[-1] = (segs[-1][0], segs[-1][1] + n)
            else:
                segs.append((off, n))
        tsel = np.asarray(tidx, dtype=np.int32)
        groups.append(dict(
            tsel=tsel,
            s_idx=ts[tsel].astype(np.int32),
            e_idx=te[tsel].astype(np.int32),
            p_idx=tp[tsel].astype(np.int32),
            segs=tuple(segs),
            k=sum(n for _, n in segs)))
    return groups


# ---------------------------------------------------------------------------
# device layer
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BookInputs:
    """Everything the device layer needs from a compiled book, as host
    numpy: ``make_multibook_fn`` builds it from a MultiBook, and
    ``interop.multibook_from_numpy`` from another package's arrays."""
    grids: Callable                  # (qvec, P) -> flat DFs [n_grid]
    bat: dict                        # host stage plans (P["bat"] source)
    grid_sel: Optional[np.ndarray]   # None = dense grid
    cols: Tuple[ColRows, ...]
    clamp: Optional[ClampSlots]
    aggregate: MultiBookAggregate
    tri: np.ndarray                  # [B, K] int32 (_trade_row_table)
    groups: Optional[list]           # _term1_trip_groups
    n_grid: int
    n_quotes: int
    n_trades: int
    tile: Optional[TileSpec] = None


def book_inputs(mb: MultiBook) -> BookInputs:
    basket = mb.basket
    dense = basket.n_grid == basket.n_curves * mb.unique_times.shape[0]
    return BookInputs(
        grids=basket.grids, bat=basket.bat,
        grid_sel=None if dense else basket.grid_sel,
        cols=mb.cols, clamp=mb.clamp, aggregate=mb.aggregate,
        tri=_trade_row_table(mb),
        groups=_term1_trip_groups(basket, mb.aggregate),
        n_grid=basket.n_grid, n_quotes=basket.n_quotes,
        n_trades=mb.n_trades, tile=mb.tile)


@dataclasses.dataclass
class DeviceBook:
    """The device tables ``make_multibook_fn`` runs on (``fn.book``):
    the book expanded to full size, indices for the kernels int32."""
    grids: Callable
    params: dict
    aggregate: MultiBookAggregate
    clamp: Optional[ClampSlots]      # per-trade slots (tiled)
    clamp_agg: Optional[ClampSlots]  # the aggregate's view of them
    cols: List[ColRows]
    tri: torch.Tensor                # [B, K] int32
    groups: List[dict]               # K2 trip groups (int32 + f64 w)


def _f64(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.float64), device=device)


def _i32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.int32), device=device)


def _i64(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)


def _agg_to(agg: MultiBookAggregate, device) -> MultiBookAggregate:
    return MultiBookAggregate(
        w_lin=_f64(agg.w_lin, device), trip_s=_i64(agg.trip_s, device),
        trip_e=_i64(agg.trip_e, device), trip_p=_i64(agg.trip_p, device),
        trip_w=_f64(agg.trip_w, device))


def _clamp_to(c: ClampSlots, device) -> ClampSlots:
    return ClampSlots(
        s_idx=_i64(c.s_idx, device), e_idx=_i64(c.e_idx, device),
        p_idx=_i64(c.p_idx, device), ia=_f64(c.ia, device),
        w=_f64(c.w, device), spread=_f64(c.spread, device),
        cap=_f64(c.cap, device), floor=_f64(c.floor, device),
        slot_trade=_i64(c.slot_trade, device))


def _expand_cols(cb: ColRows, scale: torch.Tensor,
                 base_trades: int) -> ColRows:
    """Expand a lazily tiled column bucket on the device: the base rows
    repeated per copy (copy-major), weights scaled by the copy's notional
    multiplier, trades offset by copy * base_trades."""
    n = scale.shape[0]
    R, L = cb.col_idx.shape
    copies = torch.arange(n, dtype=cb.row_trade.dtype,
                          device=cb.row_trade.device)
    return ColRows(
        col_idx=cb.col_idx.repeat(n, 1),
        w=(scale[:, None, None] * cb.w[None]).reshape(n * R, L),
        row_trade=(cb.row_trade[None, :]
                   + (copies * base_trades)[:, None]).reshape(-1))


def _expand_clamp(c: ClampSlots, scale: torch.Tensor,
                  base_trades: int) -> ClampSlots:
    n = scale.shape[0]
    copies = torch.arange(n, dtype=c.slot_trade.dtype,
                          device=c.slot_trade.device)

    def rep(x):
        return x.repeat(n)

    return ClampSlots(
        s_idx=rep(c.s_idx), e_idx=rep(c.e_idx), p_idx=rep(c.p_idx),
        ia=rep(c.ia), w=(scale[:, None] * c.w[None, :]).reshape(-1),
        spread=rep(c.spread), cap=rep(c.cap), floor=rep(c.floor),
        slot_trade=(c.slot_trade[None, :]
                    + (copies * base_trades)[:, None]).reshape(-1))


def _trip_values(dfs_flat: torch.Tensor,
                 agg: MultiBookAggregate) -> torch.Tensor:
    """The [..., T] forward-triple value table for the column sweep."""
    return ((dfs_flat[..., agg.trip_s] / dfs_flat[..., agg.trip_e] - 1.0)
            * dfs_flat[..., agg.trip_p])


def _clamp_pvs(dfs_flat: torch.Tensor, c: ClampSlots) -> torch.Tensor:
    df_s = dfs_flat[c.s_idx]
    df_e = dfs_flat[c.e_idx]
    df_p = dfs_flat[c.p_idx]
    fwd = torch.where(c.ia > 0.0, (df_s / df_e - 1.0)
                      / torch.where(c.ia > 0.0, c.ia, 1.0), 0.0)
    rate = torch.clamp(fwd + c.spread, c.floor, c.cap)
    return c.w * rate * df_p


def aggregate_total(dfs_flat: torch.Tensor, agg: MultiBookAggregate,
                    clamp: Optional[ClampSlots]) -> torch.Tensor:
    """Total book PV — O(U + T + K) regardless of trade count."""
    lin = torch.sum(agg.w_lin * dfs_flat)
    trip = torch.sum(agg.trip_w * _trip_values(dfs_flat, agg))
    total = lin + trip
    if clamp is not None:
        total = total + torch.sum(_clamp_pvs(dfs_flat, clamp))
    return total


def _clamp_quad_form(J: torch.Tensor, dfs_flat: torch.Tensor,
                     clamp: ClampSlots) -> torch.Tensor:
    """The cap/floor slots' contribution to Jᵀ·H_agg·J for one scenario
    (J [N, n_grid]). PV = w·clip((u/v-1)/ia + spread, lo, hi)·p; the
    clipped rate's u/v partials vanish outside the cap/floor band."""
    u = dfs_flat[clamp.s_idx]
    v = dfs_flat[clamp.e_idx]
    p = dfs_flat[clamp.p_idx]
    has = clamp.ia > 0.0
    ia = torch.where(has, clamp.ia, 1.0)
    pre = torch.where(has, (u / v - 1.0) / ia, 0.0) + clamp.spread
    inside = ((pre > clamp.floor) & (pre < clamp.cap)) & has
    wI = clamp.w * inside.to(u.dtype)
    Ju = J[:, clamp.s_idx]
    Jv = J[:, clamp.e_idx]
    Jp = J[:, clamp.p_idx]
    g_uv = -wI * p / (ia * v * v)
    g_up = wI / (ia * v)
    g_vp = -wI * u / (ia * v * v)
    g_vv = 2.0 * wI * p * u / (ia * v * v * v)
    Gc = (Ju * g_uv[None, :]) @ Jv.T
    Gc = Gc + (Ju * g_up[None, :]) @ Jp.T
    Gc = Gc + (Jv * g_vp[None, :]) @ Jp.T
    Gc = Gc + Gc.T
    return Gc + (Jv * g_vv[None, :]) @ Jv.T


def _scenario_risk(grids, q: torch.Tensor, P: dict,
                   agg: MultiBookAggregate, clamp_agg: Optional[ClampSlots],
                   want_gamma: bool) -> dict:
    """Delta and the curve-Hessian part of gamma for ONE scenario via the
    chain-rule split:

        delta = J @ g,
        gamma = Jᵀ·H_agg·J  +  Σ_k g_k · ∂²dfs_k/∂q∂q

    with J = ∂dfs/∂q by ``vmap(jvp)`` over the N unit seeds, g =
    ∂total/∂dfs one ``grad`` of the O(n_grid + T) aggregate, and the
    curve-Hessian term one ``jacfwd(grad(.))`` of the scalar g₀·dfs(q)
    (g₀ detached). The quad form Jᵀ·H_agg·J is left to the caller (the
    K2 kernel runs outside ``vmap``). Returns dfs, J, delta and (with
    ``want_gamma``) term2."""
    def f(x):
        return grids(x, P)

    N = q.shape[0]
    eye = torch.eye(N, dtype=q.dtype, device=q.device)
    dfs_b, J = vmap(lambda v: jvp(f, (q,), (v,)))(eye)    # [N, n_grid]
    dfs = dfs_b[0]
    g = grad(lambda d: aggregate_total(d, agg, clamp_agg))(dfs)
    out = {"dfs": dfs, "J": J, "delta": J @ g}
    if want_gamma:
        g0 = g.detach()
        out["term2"] = jacfwd(grad(lambda x: torch.dot(g0, f(x))))(q)
    return out


def _pvs_sweep(dfs_all: torch.Tensor, cols: Sequence[ColRows],
               clamp: Optional[ClampSlots], agg: MultiBookAggregate,
               tri: torch.Tensor) -> torch.Tensor:
    """Per-trade PVs [S, B] for all scenarios at once: the [M, S] value
    table (DF columns then trip values, one contiguous S-row per column)
    through the K1 kernel, then the cap/floor clamp epilogue in torch."""
    trip_all = _trip_values(dfs_all, agg)                   # [S, T]
    vT = torch.cat([dfs_all, trip_all], dim=1).T.contiguous()   # [M, S]
    pvs_bs = kernels.pvs_sweep(vT, [(cb.col_idx, cb.w) for cb in cols],
                               tri)                         # [B, S]
    if clamp is not None:
        dT = dfs_all.T
        df_s = dT[clamp.s_idx]
        df_e = dT[clamp.e_idx]
        df_p = dT[clamp.p_idx]
        has = (clamp.ia > 0.0)[:, None]
        ia = torch.where(clamp.ia > 0.0, clamp.ia, 1.0)[:, None]
        fwd = torch.where(has, (df_s / df_e - 1.0) / ia, 0.0)
        rate = torch.clamp(fwd + clamp.spread[:, None],
                           clamp.floor[:, None], clamp.cap[:, None])
        pvs_bs = pvs_bs.index_add(0, clamp.slot_trade,
                                  clamp.w[:, None] * rate * df_p)
    return pvs_bs.T.contiguous()


def risk_chunk_size(n_quotes: int, dense_width: int, n_scen: int) -> int:
    """Scenarios per risk chunk: three [chunk, N, dense_width] f64 stacks
    within RISK_CHUNK_BYTES, at least 1 and at most ``n_scen``."""
    per = 3 * n_quotes * dense_width * 8
    return max(1, min(n_scen, RISK_CHUNK_BYTES // max(per, 1)))


def make_multibook_fn(mb: Union[MultiBook, BookInputs], device,
                      want_gamma: bool = True):
    """(qvec [N], shocks [S, N]) -> {pvs [S, B], delta [S, N],
    gamma [S, N, N]} on ``device``: per-trade PVs from the K1 sweep, book
    delta/gamma from the aggregate graph. N is the packed quote
    dimension across every curve, so the gamma includes all cross-curve
    blocks. The book moves to ``device`` once, here (a lazily tiled book
    is expanded there).

    ``fn.risk_only`` and ``fn.pvs_only`` run the two halves separately;
    ``fn.dfs_only`` and ``fn.jacobians`` return the shocked grids (and
    their quote jacobians); ``fn.chunk(S)`` is the risk pass's scenario
    chunk for S scenarios; ``fn.book`` holds the device tables."""
    inp = book_inputs(mb) if isinstance(mb, MultiBook) else mb
    device = torch.device(device)
    grids = inp.grids
    P = {"bat": bat_to_torch(inp.bat, device),
         "grid_sel": None if inp.grid_sel is None
         else _i64(inp.grid_sel, device)}
    agg = _agg_to(inp.aggregate, device)
    clamp = None if inp.clamp is None else _clamp_to(inp.clamp, device)
    clamp_agg = clamp
    cols = [ColRows(col_idx=_i32(cb.col_idx, device),
                    w=_f64(cb.w, device),
                    row_trade=_i64(cb.row_trade, device))
            for cb in inp.cols]
    if inp.tile is not None:
        scale = _f64(inp.tile.scale, device)
        base = int(inp.tile.base_trades)
        cols = [_expand_cols(cb, scale, base) for cb in cols]
        if clamp is not None:
            # the aggregate's clamp total is linear in the per-copy
            # scale: the base slots with weights times sum(scale)
            clamp_agg = dataclasses.replace(clamp, w=clamp.w * scale.sum())
            clamp = _expand_clamp(clamp, scale, base)
    tri = _i32(inp.tri, device)
    groups = [dict(s_idx=_i32(g["s_idx"], device),
                   e_idx=_i32(g["e_idx"], device),
                   p_idx=_i32(g["p_idx"], device),
                   rows=_i32(np.concatenate(
                       [np.arange(off, off + n) for off, n in g["segs"]]),
                       device),
                   w=agg.trip_w[_i64(g["tsel"], device)].contiguous())
              for g in (inp.groups or [])]
    N = inp.n_quotes
    dense_width = sum(p["i0"].size for p in inp.bat["gplan"].values())

    def chunk(n_scen: int) -> int:
        return risk_chunk_size(N, dense_width, n_scen)

    def _as(x):
        return torch.as_tensor(x, dtype=torch.float64, device=device)

    def _risk(qvec, shocks):
        """Per-chunk risk; returns (dfs [S, n_grid], delta, gamma)."""
        dfs_l, delta_l, gamma_l = [], [], []
        c = chunk(shocks.shape[0])
        for s0 in range(0, shocks.shape[0], c):
            q = qvec[None, :] + shocks[s0:s0 + c]
            if not want_gamma:
                def one(x):
                    total = grad(lambda y: aggregate_total(
                        grids(y, P), agg, clamp_agg))
                    return grids(x, P), total(x)
                dfs, delta = vmap(one)(q)
            else:
                out = vmap(lambda x: _scenario_risk(
                    grids, x, P, agg, clamp_agg, True))(q)
                dfs, delta = out["dfs"].contiguous(), out["delta"]
                J = out["J"].contiguous()
                term1 = kernels.gamma_quad_form_grouped(J, dfs, groups)
                if clamp_agg is not None:
                    term1 = term1 + vmap(
                        lambda j, d: _clamp_quad_form(j, d, clamp_agg))(
                            J, dfs)
                gamma_l.append(term1 + out["term2"])
            dfs_l.append(dfs)
            delta_l.append(delta)
        res = {"delta": torch.cat(delta_l)}
        if want_gamma:
            res["gamma"] = torch.cat(gamma_l)
        return torch.cat(dfs_l), res

    def fn(qvec, shocks):
        dfs_all, out = _risk(_as(qvec), _as(shocks))
        # the risk pass already bootstrapped every scenario's grids —
        # the PV sweep consumes them instead of recomputing
        out["pvs"] = _pvs_sweep(dfs_all.contiguous(), cols, clamp, agg, tri)
        return out

    def risk_only(qvec, shocks):
        return _risk(_as(qvec), _as(shocks))[1]

    def dfs_only(qvec, shocks):
        """The compact DF grids [S, n_grid] of the shocked quotes."""
        q = _as(qvec)
        return vmap(lambda s: grids(q + s, P))(_as(shocks)).contiguous()

    def pvs_only(qvec, shocks):
        return _pvs_sweep(dfs_only(qvec, shocks), cols, clamp, agg, tri)

    def jacobians(qvec, shocks):
        """(dfs [S, n_grid], J [S, N, n_grid]) of the shocked quotes."""
        out = vmap(lambda x: _scenario_risk(grids, x, P, agg, clamp_agg,
                                            False))(_as(qvec) + _as(shocks))
        return out["dfs"], out["J"].contiguous()

    fn.risk_only = risk_only
    fn.pvs_only = pvs_only
    fn.dfs_only = dfs_only
    fn.jacobians = jacobians
    fn.chunk = chunk
    fn.book = DeviceBook(grids=grids, params=P, aggregate=agg,
                         clamp=clamp, clamp_agg=clamp_agg, cols=cols,
                         tri=tri, groups=groups)
    return fn
