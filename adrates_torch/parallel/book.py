"""Single-curve OIS book: compile swaps to index tables, price them against
one bootstrapped curve under a scenario matrix, and take the book's delta
and gamma from its aggregate.

Port of ``adrates_tpu/parallel/book.py`` (:89-583). Every
payment/accrual time collapses into ONE sorted unique-time grid and
trades hold indices into it, so pricing the book is one bootstrap, one
interpolation over the grid and per-trade gathers:

 - ``compile_book`` / ``tile_book`` / ``compile_book_buckets`` build the
   host tables (numpy, as the JAX package's);
 - ``make_book_fn`` gives the per-trade PVs [S, B] of every scenario from
   the hand-written K1 kernel (``kernels.pvs_sweep``, replacing
   ``_pvs_from_grid`` under ``lax.map``, :223-231 / :379-380): the value
   table is ``multibook.value_table``'s layout, rows ``[dfs_u (U); trip
   values (T)]`` and one column per scenario, and each trade's fixed,
   spread and forward slots are one per-trade CSR of (row, weight) over
   it, built once per (book, device);
 - the book delta [S, N] and gamma [S, N, N] are ``torch.func`` ``jacrev``
   and ``jacfwd(jacrev)`` of ``aggregate_total_pv``, the O(U + T)
   aggregate, vmapped over the scenarios, as in JAX. K2 is not on this
   path: JAX differentiates the aggregate here, not a J-based quad form;
 - ``shard_book``, ``make_sharded_book_fn`` and
   ``make_pershard_aggregate_fn`` (:401-470) split the trades over a
   mesh's ranks (``distributed.py``): each rank prices and differentiates
   its own trades and the totals, deltas and gammas are all-reduced.

Any interpolation scheme works: the simple ones through their static
plan, the fitted ones fitted on the bootstrap's nodes
(``interpolation.df_static``). Functions that put tensors on a device take
``device`` (None: the CUDA card, ``utils/device.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch.func import jacfwd, jacrev, vmap

from ..ops import kernels
from ..ops.bootstrap import OISBootstrapPlan, bootstrap_ois, plan_to_torch
from ..ops.interpolation import df_static, interp_plan
from ..ops.interpolation import plan_to_torch as interp_plan_to_torch
from ..utils.device import resolve_device
from ..utils.error import LibError
from ..utils.global_types import InterpTypes
from .multibook import value_table as multibook_value_table
from .slots import _combine_book, _trip_keys, _unkey, sweep_slots


@dataclasses.dataclass(frozen=True)
class BookTensors:
    """A whole book as padded index/amount arrays. B trades x P slots.

    unique_times [U] is the shared payment/accrual time grid; *_idx arrays
    are int32 indices into it. Padded slots point at index 0 with zero
    amounts and mask=0.
    """
    unique_times: np.ndarray         # [U]
    # fixed side
    fix_idx: np.ndarray              # [B, P] int32 payment-time index
    fix_payments: np.ndarray         # [B, P] signed coupon amounts
    fix_mask: np.ndarray             # [B, P] 1.0 live / 0.0 padded-or-past
    # float side
    flt_pay_idx: np.ndarray          # [B, P] int32
    flt_start_idx: np.ndarray        # [B, P] int32
    flt_end_idx: np.ndarray          # [B, P] int32
    flt_pay_alphas: np.ndarray       # [B, P]
    flt_index_alphas: np.ndarray     # [B, P] forward divisor in the index
    #   curve's day count (== pay_alphas when the bases coincide)
    flt_spreads: np.ndarray          # [B, P]
    flt_notionals: np.ndarray        # [B, P] signed notionals
    flt_mask: np.ndarray             # [B, P]

    @property
    def num_trades(self) -> int:
        return self.fix_idx.shape[0]


class _TimeInterner:
    """Host-side dedupe of payment times into one sorted grid."""

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
        """Sort the grid, return (times [U], remap old->new)."""
        order = np.argsort(np.asarray(self._times))
        remap = np.empty(len(order), dtype=np.int32)
        remap[order] = np.arange(len(order), dtype=np.int32)
        return np.asarray(self._times)[order], remap


def compile_book(swaps, value_dt, pad_to: Optional[int] = None,
                 index_dc=None) -> BookTensors:
    """Compile a list of OIS products into one indexed BookTensors.

    Only future payments (time > 0) are marked live; pricing assumes the
    curve's anchor (t=0) is the valuation date. ``pad_to`` fixes the slot
    count P (default: the longest leg). ``index_dc`` is the projection
    curve's day count for the forward divisor (defaults to each leg's own
    basis).
    """
    fixed = [s._fixed_leg.tensor(value_dt) for s in swaps]
    flt = [s._float_leg.tensor(value_dt, index_dc=index_dc)
           for s in swaps]
    P_max = pad_to or max(max(t.payment_times.shape[0] for t in fixed),
                          max(t.payment_times.shape[0] for t in flt))

    interner = _TimeInterner()
    interner.add(0.0)  # always include the anchor

    def pad_idx(times):
        t = np.asarray(times)
        idx = np.zeros(P_max, dtype=np.int32)
        for j, tv in enumerate(t):
            idx[j] = interner.add(tv)
        return idx, t.shape[0]

    def pad_val(vec):
        v = np.asarray(vec, dtype=np.float64)
        out = np.zeros(P_max, dtype=np.float64)
        out[:v.shape[0]] = v
        return out

    rows = dict(fix_idx=[], fix_payments=[], fix_mask=[], flt_pay_idx=[],
                flt_start_idx=[], flt_end_idx=[], flt_pay_alphas=[],
                flt_index_alphas=[], flt_spreads=[], flt_notionals=[],
                flt_mask=[])
    for ft, lt in zip(fixed, flt):
        fsign = float(ft.leg_sign)
        lsign = float(lt.leg_sign)

        f_idx, f_n = pad_idx(ft.payment_times)
        mask = np.zeros(P_max)
        mask[:f_n] = (np.asarray(ft.payment_times) > 0.0).astype(float)
        rows["fix_idx"].append(f_idx)
        rows["fix_payments"].append(pad_val(np.asarray(ft.payments) * fsign))
        rows["fix_mask"].append(mask)

        p_idx, p_n = pad_idx(lt.payment_times)
        s_idx, _ = pad_idx(lt.start_times)
        e_idx, _ = pad_idx(lt.end_times)
        # strictly-future coupons, same convention as the fixed mask (a
        # payment exactly at the valuation date settled)
        mask = np.zeros(P_max)
        mask[:p_n] = (np.asarray(lt.payment_times) > 0.0).astype(float)
        rows["flt_pay_idx"].append(p_idx)
        rows["flt_start_idx"].append(s_idx)
        rows["flt_end_idx"].append(e_idx)
        rows["flt_pay_alphas"].append(pad_val(lt.pay_alphas))
        rows["flt_index_alphas"].append(pad_val(lt.index_alphas))
        rows["flt_spreads"].append(pad_val(lt.spreads))
        rows["flt_notionals"].append(
            pad_val(np.asarray(lt.notionals) * lsign))
        rows["flt_mask"].append(mask)

    unique_times, remap = interner.finish()
    out = {}
    for k, v in rows.items():
        arr = np.stack(v)
        if k.endswith("_idx"):
            out[k] = remap[arr].astype(np.int32)
        else:
            out[k] = arr
    return BookTensors(unique_times=unique_times, **out)


def tile_book(base: BookTensors, n_copies: int, coupon_scale=None,
              notional_scale=None) -> BookTensors:
    """Scale a compiled book up by tiling with per-copy coupon/notional
    multipliers (books share schedules; amounts differ). Copy-major: trade
    ``c * B + b`` is copy c of base trade b."""
    if coupon_scale is None:
        coupon_scale = np.ones(n_copies)
    if notional_scale is None:
        notional_scale = np.ones(n_copies)

    def tile(x, scale_vec=None):
        x = np.asarray(x)
        tiled = np.tile(x, (n_copies, 1))
        if scale_vec is not None:
            reps = np.repeat(np.asarray(scale_vec, dtype=np.float64),
                             x.shape[0])
            tiled = tiled * reps[:, None]
        return tiled

    return BookTensors(
        unique_times=base.unique_times,
        fix_idx=tile(base.fix_idx),
        fix_payments=tile(base.fix_payments, coupon_scale),
        fix_mask=tile(base.fix_mask),
        flt_pay_idx=tile(base.flt_pay_idx),
        flt_start_idx=tile(base.flt_start_idx),
        flt_end_idx=tile(base.flt_end_idx),
        flt_pay_alphas=tile(base.flt_pay_alphas),
        flt_index_alphas=tile(base.flt_index_alphas),
        flt_spreads=tile(base.flt_spreads),
        flt_notionals=tile(base.flt_notionals, notional_scale),
        flt_mask=tile(base.flt_mask))


def _grid_times(plan: OISBootstrapPlan) -> np.ndarray:
    """The bootstrap's node times, t = 0 included (static)."""
    return np.concatenate([[0.0], np.asarray(plan.point_times,
                                             dtype=np.float64)])


def _dfs_u(rates: torch.Tensor, P: dict, iplan, interp_type: InterpTypes):
    """DFs on the book's unique grid: one bootstrap, one interpolation
    (a fit on the nodes first on the fitted schemes)."""
    _, dfs = bootstrap_ois(rates, P)
    return df_static(iplan, dfs, interp_type)


def book_pvs(rates: torch.Tensor, plan: dict, interp_type: InterpTypes,
             book: BookTensors, grid_times: np.ndarray) -> torch.Tensor:
    """Per-trade PVs [B] through the per-trade gathers (no kernel): one
    bootstrap, one interpolation over the unique grid, per-trade sums.
    ``plan`` is a device plan (``ops/bootstrap.plan_to_torch``) and
    ``grid_times`` the host copy of the bootstrap's node times (t=0
    included), which with the book's static unique times fixes the
    interpolation plan. The OIS curve's refit gate and ``book_analytics``
    run on it."""
    dev = rates.device
    iplan = interp_plan_to_torch(interp_plan(book.unique_times, grid_times,
                                             interp_type), dev)
    dfs_u = _dfs_u(rates, plan, iplan, interp_type)

    def t(a, dtype=torch.float64):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    def g(idx):
        return dfs_u[t(idx, torch.int64)]

    w_fix, w_fwd, w_spr = (t(w) for w in _combine_book(book))
    fix_pv = torch.sum(w_fix * g(book.fix_idx), dim=1)
    cf = w_fwd * (g(book.flt_start_idx) / g(book.flt_end_idx) - 1.0) + w_spr
    return fix_pv + torch.sum(cf * g(book.flt_pay_idx), dim=1)


@dataclasses.dataclass(frozen=True)
class BookAggregate:
    """The book's TOTAL PV collapsed onto the unique-time grid (host
    numpy):

      total = sum_u w_lin[u] * df[u]
            + sum_t w_trip[t] * (df[s_t]/df[e_t] - 1) * df[p_t]

    U and T are both small (hundreds) regardless of book size, so the
    book's delta ladder and gamma cost one trade's."""
    w_lin: np.ndarray        # [U]
    trip_s: np.ndarray       # [T] int32
    trip_e: np.ndarray       # [T] int32
    trip_p: np.ndarray       # [T] int32
    trip_w: np.ndarray       # [T]
    unique_times: np.ndarray  # [U]


def aggregate_book(book: BookTensors) -> BookAggregate:
    """Collapse a book to its aggregate-PV weights (host-side groupby)."""
    U = int(book.unique_times.shape[0])
    w_fix, w_fwd, w_spr = _combine_book(book)
    flt_pay = np.asarray(book.flt_pay_idx).ravel()
    w_lin = np.bincount(np.asarray(book.fix_idx).ravel(),
                        weights=w_fix.ravel(), minlength=U)
    w_lin += np.bincount(flt_pay, weights=w_spr.ravel(), minlength=U)

    w = w_fwd.ravel()
    live = w != 0.0
    key = _trip_keys(np.asarray(book.flt_start_idx).ravel()[live],
                     np.asarray(book.flt_end_idx).ravel()[live],
                     flt_pay[live], U)
    uniq, inverse = np.unique(key, return_inverse=True)
    trip_s, trip_e, trip_p = _unkey(uniq, U)
    return BookAggregate(w_lin=w_lin, trip_s=trip_s, trip_e=trip_e,
                         trip_p=trip_p,
                         trip_w=np.bincount(inverse, weights=w[live]),
                         unique_times=book.unique_times)


def merge_aggregates(aggs) -> BookAggregate:
    """Sum BookAggregates sharing one unique grid: linear weights add,
    forward triples concatenate with (s, e, p)-key deduplication."""
    U = int(aggs[0].unique_times.shape[0])
    w_lin = np.sum([np.asarray(a.w_lin) for a in aggs], axis=0)
    key = _trip_keys(np.concatenate([np.asarray(a.trip_s) for a in aggs]),
                     np.concatenate([np.asarray(a.trip_e) for a in aggs]),
                     np.concatenate([np.asarray(a.trip_p) for a in aggs]),
                     U)
    w = np.concatenate([np.asarray(a.trip_w) for a in aggs])
    uniq, inverse = np.unique(key, return_inverse=True)
    trip_s, trip_e, trip_p = _unkey(uniq, U)
    return BookAggregate(w_lin=w_lin, trip_s=trip_s, trip_e=trip_e,
                         trip_p=trip_p, trip_w=np.bincount(inverse, weights=w),
                         unique_times=aggs[0].unique_times)


@dataclasses.dataclass(frozen=True)
class _DeviceAggregate:
    """An aggregate on the device, with its grid's interpolation plan."""
    iplan: object
    w_lin: torch.Tensor
    trip_s: torch.Tensor     # int64
    trip_e: torch.Tensor
    trip_p: torch.Tensor
    trip_w: torch.Tensor


def _agg_to(agg: BookAggregate, grid_times: np.ndarray,
            interp_type: InterpTypes, device) -> _DeviceAggregate:
    def f64(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=device)

    def i64(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    return _DeviceAggregate(
        iplan=interp_plan_to_torch(interp_plan(agg.unique_times, grid_times,
                                               interp_type), device),
        w_lin=f64(agg.w_lin), trip_s=i64(agg.trip_s),
        trip_e=i64(agg.trip_e), trip_p=i64(agg.trip_p),
        trip_w=f64(agg.trip_w))


def _total(rates, P: dict, interp_type: InterpTypes,
           agg: _DeviceAggregate) -> torch.Tensor:
    dfs_u = _dfs_u(rates, P, agg.iplan, interp_type)
    lin = torch.sum(agg.w_lin * dfs_u)
    trip = torch.sum(agg.trip_w
                     * (dfs_u[agg.trip_s] / dfs_u[agg.trip_e] - 1.0)
                     * dfs_u[agg.trip_p])
    return lin + trip


def aggregate_total_pv(rates: torch.Tensor, plan: OISBootstrapPlan,
                       interp_type: InterpTypes,
                       agg: BookAggregate) -> torch.Tensor:
    """Total book PV from the aggregated weights — O(U + T), on the
    device of ``rates`` (a tensor)."""
    dev = rates.device
    return _total(rates, plan_to_torch(plan, dev), interp_type,
                  _agg_to(agg, _grid_times(plan), interp_type, dev))


def book_analytics(rates, plan: OISBootstrapPlan, interp_type: InterpTypes,
                   book: BookTensors, shocks=None, device=None):
    """(pvs [S,B], delta [S,N], gamma [S,N,N]) over a scenario shock
    matrix (shocks [S,N] in rate units; None = single base scenario), on
    ``device``.

    CROSS-CHECK ONLY (not exported): differentiates through the per-trade
    [B, P] gather graph, so each Hessian column costs O(B*P). The book
    functions take the O(U + T) aggregate's delta and gamma instead; this
    naive formulation exists to validate them in tests."""
    dev = resolve_device(device)
    P = plan_to_torch(plan, dev)
    grid_times = _grid_times(plan)
    rates = torch.as_tensor(rates, dtype=torch.float64, device=dev)
    if shocks is None:
        shocks = torch.zeros((1, rates.shape[0]), dtype=torch.float64)
    shocks = torch.as_tensor(shocks, dtype=torch.float64, device=dev)

    def pvs(r):
        return book_pvs(r, P, interp_type, book, grid_times)

    def total(r):
        return torch.sum(pvs(r))

    def one_scenario(shock):
        r = rates + shock
        return pvs(r), jacrev(total)(r), jacfwd(jacrev(total))(r)

    return vmap(one_scenario)(shocks)


# ---------------------------------------------------------------------------
# The book functions: per-trade PVs on K1, delta and gamma from the aggregate
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BookSweep:
    """K1's inputs for a book (or a tuple of books sharing one grid, their
    trades concatenated in order), on the device: the unique grid's
    interpolation plan, the forward trips (s, e, p) whose values fill the
    value table's rows U..U+T-1, and the per-trade CSR of (row, weight)
    slots over the table (``kernels.sweep_tables``)."""
    iplan: object
    trip_s: torch.Tensor     # [T] int64
    trip_e: torch.Tensor
    trip_p: torch.Tensor
    sweep: kernels.SweepTables


def _book_sweep(books, grid_times: np.ndarray, interp_type: InterpTypes,
                device) -> BookSweep:
    """Build K1's tables for ``books`` (sharing one unique grid, their
    trades concatenated in order): ``slots.sweep_slots`` over the books'
    unique grid."""
    U = int(books[0].unique_times.shape[0])
    offs = np.cumsum([0] + [b.num_trades for b in books])
    trade, col, w, uniq = sweep_slots(
        books, [np.arange(o, o + b.num_trades) for o, b in zip(offs, books)],
        U)
    trip_s, trip_e, trip_p = _unkey(uniq, U)

    def i64(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    sweep = kernels.sweep_tables(
        i64(trade), i64(col),
        torch.as_tensor(w, dtype=torch.float64, device=device),
        int(offs[-1]), U + uniq.shape[0])
    return BookSweep(
        iplan=interp_plan_to_torch(interp_plan(books[0].unique_times,
                                               grid_times, interp_type),
                                   device),
        trip_s=i64(trip_s), trip_e=i64(trip_e), trip_p=i64(trip_p),
        sweep=sweep)


def _make_fn(plan: OISBootstrapPlan, interp_type: InterpTypes,
             want_gamma: bool, device):
    """The shared body of the book functions: fn(rates, books, agg,
    shocks), with ``fn.tables(books)``, ``fn.value_table(rates, books,
    shocks)`` and ``fn.risk(rates, agg, shocks, total_pv=False)``
    (tensors on the device). ``books`` is a tuple of books sharing one
    grid; ``agg`` their aggregate, or None for the books' own
    (``merge_aggregates`` of each one's ``aggregate_book``). K1's tables,
    the books' own aggregate and an aggregate's device copy are built at
    first sight of their objects and kept (the objects are held, so their
    ids stay theirs)."""
    dev = resolve_device(device)
    P = plan_to_torch(plan, dev)
    grid_times = _grid_times(plan)
    memo = {}

    def kept(tag: str, objs: tuple, build):
        key = (tag,) + tuple(map(id, objs))
        if key not in memo:
            memo[key] = (objs, build())
        return memo[key][1]

    def tables(books) -> BookSweep:
        return kept("tables", books, lambda: _book_sweep(
            books, grid_times, interp_type, dev))

    def value_table(rates, books, shocks):
        """(K1's value table [U + T, S], rows 16-byte aligned, and the
        books' tables): every scenario's DF grid ([S, U] is small), then
        its trip values."""
        tab = tables(books)
        dfs_u = vmap(lambda s: _dfs_u(rates + s, P, tab.iplan,
                                      interp_type))(shocks)
        return multibook_value_table(dfs_u, tab), tab

    def risk(rates, agg, shocks, total_pv: bool = False):
        """{delta [S, N], gamma [S, N, N] (with ``want_gamma``), total_pv
        [S] (with ``total_pv``)}: ``jacrev`` / ``jacfwd∘jacrev`` of the
        aggregate's O(U + T) total, vmapped over the scenarios."""
        rates = torch.as_tensor(rates, dtype=torch.float64, device=dev)
        shocks = torch.as_tensor(shocks, dtype=torch.float64, device=dev)
        ag = kept("agg", (agg,), lambda: _agg_to(agg, grid_times,
                                                 interp_type, dev))

        def total(r):
            return _total(r, P, interp_type, ag)

        def one_scenario(shock):
            r = rates + shock
            out = {"delta": jacrev(total)(r)}
            if want_gamma:
                out["gamma"] = jacfwd(jacrev(total))(r)
            if total_pv:
                out["total_pv"] = total(r)
            return out

        return vmap(one_scenario)(shocks)

    def fn(rates, books, agg, shocks):
        if agg is None:
            agg = kept("own agg", books, lambda: merge_aggregates(
                [aggregate_book(b) for b in books]))
        rates = torch.as_tensor(rates, dtype=torch.float64, device=dev)
        shocks = torch.as_tensor(shocks, dtype=torch.float64, device=dev)
        vT, tab = value_table(rates, books, shocks)
        pvs = kernels.pvs_sweep(vT, tab.sweep)   # one K1 launch
        out = risk(rates, agg, shocks)
        out["pvs"] = pvs
        return out

    fn.tables = tables
    fn.value_table = value_table
    fn.risk = risk
    return fn


def make_book_fn(plan: OISBootstrapPlan, interp_type: InterpTypes,
                 want_gamma: bool = True, device=None):
    """(rates [N], book, agg, shocks [S, N]) -> {pvs [S, B], delta [S, N],
    gamma [S, N, N]} on ``device`` (rates and shocks in rate units).

    Per-trade PVs come from the K1 kernel, one launch per call over every
    scenario; book-level delta/gamma from the aggregated total (identical
    by construction, tested), so the AD graph never differentiates
    through the per-trade slots. K1's tables are built at the first call
    on a book and kept (``fn.tables(book)`` builds or returns them), so a
    warm call builds none. ``fn.value_table(rates, book, shocks)`` gives
    K1's inputs: the [U + T, S] value table (device tensors in) and the
    tables."""
    inner = _make_fn(plan, interp_type, want_gamma, device)

    def fn(rates, book, agg, shocks):
        return inner(rates, (book,), agg, shocks)

    fn.tables = lambda book: inner.tables((book,))
    fn.value_table = lambda rates, book, shocks: inner.value_table(
        rates, (book,), shocks)
    return fn


def shard_book(book: BookTensors, mesh, axis: str = "book") -> BookTensors:
    """This rank's contiguous slice of the trade axis over ``mesh``'s
    ``axis`` (the unique grid shared), host numpy (``adrates_tpu``
    ``book.py:401``). Raises ``LibError`` when the trade count does not
    divide the shard count: pad with ``tile_book`` first, as the JAX
    package's caller does."""
    from .distributed import ShardAxis
    ax = ShardAxis(mesh, axis)
    B = book.num_trades
    if B % ax.n:
        raise LibError(f"shard_book: {B} trades do not divide into "
                       f"{ax.n} shards (pad with tile_book)")
    n = B // ax.n
    return _slice_book(book, slice(ax.index * n, (ax.index + 1) * n),
                       None)


def make_sharded_book_fn(plan: OISBootstrapPlan, interp_type: InterpTypes,
                         mesh, axis: str = "book", want_gamma: bool = True,
                         device=None):
    """(rates [N], book_shard, shocks [S, N]) -> {total_pv [S], delta
    [S, N], gamma [S, N, N]} of the whole book on every rank
    (``adrates_tpu`` ``book.py:414``): ``book_shard`` is this rank's
    ``shard_book``. Each rank prices its shard's trades on K1 (the
    ``make_book_fn`` tables, built at first sight of a shard and kept)
    and takes its shard's delta and gamma by ``jacrev`` /
    ``jacfwd∘jacrev`` of the shard's aggregate (equal by construction to
    the derivatives of its trades' PV sum, as in ``make_book_fn``); the
    three are then all-reduced over the ``axis`` group."""
    from .distributed import ShardAxis, all_reduce
    group = ShardAxis(mesh, axis).group
    inner = _make_fn(plan, interp_type, want_gamma, device)

    def fn(rates, book_shard, shocks):
        out = inner(rates, (book_shard,), None, shocks)
        res = {"total_pv": all_reduce(out["pvs"].sum(dim=1), group),
               "delta": all_reduce(out["delta"], group)}
        if want_gamma:
            res["gamma"] = all_reduce(out["gamma"], group)
        return res

    return fn


def make_pershard_aggregate_fn(plan: OISBootstrapPlan,
                               interp_type: InterpTypes, mesh,
                               axis: str = "book", device=None):
    """(rates [N], agg, shocks [S, N]) -> {total_pv [S], delta [S, N],
    gamma [S, N, N]} of the whole book on every rank (``adrates_tpu``
    ``book.py:450``): ``agg`` is this rank's shard's aggregate
    (``aggregate_book(shard_book(...))``); each rank takes its total and
    its ``jacrev`` / ``jacfwd∘jacrev`` (the O(U + T) graph), and the
    three are all-reduced: the PV, delta and gamma are linear in the
    book, so the sum is the whole book's."""
    from .distributed import ShardAxis, all_reduce
    group = ShardAxis(mesh, axis).group
    risk = _make_fn(plan, interp_type, True, device).risk

    def fn(rates, agg, shocks):
        out = risk(rates, agg, shocks, total_pv=True)
        return {k: all_reduce(v, group) for k, v in out.items()}

    return fn


def _slice_book(book: BookTensors, rows: slice,
                pad: Optional[int]) -> BookTensors:
    """Row/pad-slice of a compiled book (padded slots sit at the END of
    each row, so truncating the slot axis keeps every live payment;
    ``pad`` None keeps every slot)."""
    def cut(x):
        x = np.asarray(x)
        return x[rows, :pad] if x.ndim == 2 else x
    return BookTensors(
        unique_times=book.unique_times,
        **{f.name: cut(getattr(book, f.name))
           for f in dataclasses.fields(BookTensors)
           if f.name != "unique_times"})


def compile_book_buckets(swaps, value_dt, index_dc=None,
                         n_buckets: int = 4):
    """Compile a heterogeneous book into pad-size buckets sharing ONE
    unique-time grid: trades sorted by payment count, each bucket padded
    to its own maximum (equal-count buckets; contiguous buckets with the
    same pad collapse, so a homogeneous book is one bucket).

    Returns (books, order): per-bucket BookTensors and the permutation
    such that concatenated bucket PVs follow swaps[order].
    """
    sizes = np.array([max(len(s._fixed_leg._payment_dts),
                          len(s._float_leg._payment_dts)) for s in swaps])
    order = np.argsort(sizes, kind="stable")
    big = compile_book([swaps[i] for i in order], value_dt,
                       index_dc=index_dc)
    sorted_sizes = sizes[order]
    n = len(swaps)
    bounds = np.linspace(0, n, min(n_buckets, n) + 1).astype(int)
    spans = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        if hi <= lo:
            continue
        pad = int(sorted_sizes[lo:hi].max())
        if spans and spans[-1][2] == pad:
            spans[-1] = (spans[-1][0], hi, pad)
        else:
            spans.append((lo, hi, pad))
    books = [_slice_book(big, slice(int(lo), int(hi)), pad)
             for lo, hi, pad in spans]
    return books, order


def make_bucketed_book_fn(plan: OISBootstrapPlan, interp_type: InterpTypes,
                          want_gamma: bool = True, device=None):
    """``make_book_fn`` over a sequence of pad-bucketed books sharing one
    grid: (rates, books, agg, shocks) -> the same dict, per-trade PVs
    concatenated in bucket order; delta/gamma from the aggregate.

    K1 sweeps every bucket, in their concatenated order, in one launch.
    Its per-trade CSR holds live slots only, so the buckets' pad saving
    (which the JAX package's padded gathers need) does not apply to it:
    the bucketed and the monolithic book cost K1 the same. The output
    equals the JAX function's. ``fn.tables(books)`` builds or returns
    the kept tables."""
    inner = _make_fn(plan, interp_type, want_gamma, device)

    def fn(rates, books, agg, shocks):
        return inner(rates, tuple(books), agg, shocks)

    fn.tables = lambda books: inner.tables(tuple(books))
    fn.value_table = lambda rates, books, shocks: inner.value_table(
        rates, tuple(books), shocks)
    return fn
