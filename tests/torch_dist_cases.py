"""Spawn targets of the port's sharded tests (``test_torch_sharded_*.py``,
``test_torch_f32_ladder.py``) and their one guarded launcher.

``run_ranks`` is ``adrates_torch.parallel.distributed.run_ranks``: each
rank a spawned process with one intra-op thread, the group on gloo over a
file store in a temporary directory (so test workers never share a TCP
port), every collective and the whole world bounded by a timeout, the
survivors killed and the failing rank's traceback raised. A target runs
in each rank as ``target(rank, world, *args)``, rebuilds its book from
``torch_cases``' builders and seeds (the books do not pickle) and returns
numpy only. The sharded functions run on the CPU (``device="cpu"``)."""

import os

import numpy as np
import torch

import torch_cases as tc
from adrates_torch.parallel.distributed import run_ranks  # noqa: F401

PKG = "adrates_torch"
# the tiles of the sharded tests: 8 base trades x 5 (40 trades divide
# neither 3 nor 8 ranks) and the credit book's 6 x 3
OIS_COPIES = 5
CREDIT_COPIES = 3
N_SCEN = 2
# the selection of the sharded gammas: 11 trades (no world size of the
# tests divides it)
N_SEL = 11


def ois_books(pkg: str = PKG):
    """(base, lazy x5, materialized x5) of torch_cases' OIS book, with the
    seeded notional scales."""
    from importlib import import_module
    mbmod = import_module(f"{pkg}.parallel.multibook")
    base, lazy = tc.compile_book(pkg, tc.build_model(pkg), OIS_COPIES)
    mat = mbmod.tile_multibook(base, OIS_COPIES,
                               notional_scale=lazy.tile.scale,
                               materialize=True)
    return base, lazy, mat


def credit_books(pkg: str = PKG):
    """(lazy x3, materialized x3) of torch_cases' credit book (capped /
    floored FRN clamp slots), with its seeded notional scales."""
    from importlib import import_module
    mbmod = import_module(f"{pkg}.parallel.multibook")
    m = tc.build_credit_model(pkg)
    base, lazy = tc.compile_tiled(pkg, m, tc.credit_trades_for(pkg, m),
                                  n_copies=CREDIT_COPIES)
    return lazy, mbmod.tile_multibook(base, CREDIT_COPIES,
                                      notional_scale=lazy.tile.scale,
                                      materialize=True)


def credit_book(pkg: str = PKG):
    """The lazy x3 credit book of :func:`credit_books`."""
    return credit_books(pkg)[0]


def selection(mb) -> np.ndarray:
    return np.linspace(0, mb.n_trades - 1, N_SEL).astype(np.int64)


def _mesh(local_world):
    """``book_mesh`` with ``LOCAL_WORLD_SIZE`` set (a 2-D mesh when it is
    less than the world); its every axis."""
    from adrates_torch.parallel import distributed
    if local_world is not None:
        os.environ["LOCAL_WORLD_SIZE"] = str(local_world)
    mesh = distributed.book_mesh()
    return mesh, tuple(mesh.mesh_dim_names)


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else x


def _count_k1(f):
    """(f(), the trade counts of the tables of each ``kernels.pvs_sweep``
    call f made): the wrapper wrapped to count its calls, since its CPU
    twin counts no launch."""
    from adrates_torch.ops import kernels
    calls, sweep = [], kernels.pvs_sweep
    kernels.pvs_sweep = lambda vT, tab, **kw: calls.append(
        tab.n_trades) or sweep(vT, tab, **kw)
    try:
        return f(), calls
    finally:
        kernels.pvs_sweep = sweep


def _shard_info(shard) -> dict:
    return dict(lo=shard.lo, hi=shard.hi, n_local=shard.n_local,
                n_pad=shard.n_pad, rows=shard.rows,
                clamp_slots=0 if shard.clamp is None
                else int(shard.clamp.w.shape[0]))


def multibook_ranks(rank, world, local_world=None):
    """The sharded multibook on the lazy and the materialized OIS tiles
    and the lazy credit tile: each book's {total_pv, delta, gamma} and
    this rank's shard."""
    from adrates_torch.parallel import (make_sharded_multibook_fn,
                                        shard_multibook)
    mesh, axis = _mesh(local_world)
    _, lazy, mat = ois_books()
    out = {"coord": list(mesh.get_coordinate()),
           "dims": list(mesh.mesh_dim_names)}
    for name, mb in (("lazy", lazy),
                     ("materialized", shard_multibook(mat, mesh, axis,
                                                      device="cpu")),
                     ("credit", credit_book())):
        fn = make_sharded_multibook_fn(mb, mesh, axis, device="cpu")
        book = fn.shard.book
        res, k1 = _count_k1(lambda: fn(
            book.basket.quotes0, tc.shocks(book.basket.n_quotes, N_SCEN)))
        out[name] = dict({k: _np(v) for k, v in res.items()}, k1_calls=k1,
                         **_shard_info(fn.shard))
    if len(axis) == 2:
        # the trades over the "book" axis alone, replicated over "dcn"
        fn = make_sharded_multibook_fn(lazy, mesh, "book", device="cpu")
        res = fn(lazy.basket.quotes0, tc.shocks(lazy.basket.n_quotes,
                                                N_SCEN))
        out["lazy_book_axis"] = dict({k: _np(v) for k, v in res.items()},
                                     **_shard_info(fn.shard))
    return out


def pertrade_ranks(rank, world):
    """The sharded ladders (lazy and materialized OIS tiles, lazy credit
    tile), the selected gammas and the full-book blocks: this rank's
    blocks and shard, and everything gathered."""
    from adrates_torch.parallel import (
        make_sharded_per_trade_delta_fn, make_sharded_per_trade_gamma_fn,
        make_sharded_per_trade_gamma_blocks_fn)
    mesh, axis = _mesh(None)
    _, lazy, mat = ois_books()
    q0 = lazy.basket.quotes0
    out = {}
    for name, mb in (("lazy", lazy), ("materialized", mat),
                     ("credit", credit_book())):
        fn = make_sharded_per_trade_delta_fn(mb, mesh, axis, device="cpu")
        block, k1 = _count_k1(lambda: fn(mb.basket.quotes0))
        out[f"ladder_{name}"] = dict(
            block=_np(block), gathered=_np(fn.gather(block)), k1_calls=k1,
            trade_range=fn.trade_range, n_trades=fn.n_trades,
            **_shard_info(fn.shard))
    fn = make_sharded_per_trade_gamma_fn(lazy, mesh, selection(lazy), axis,
                                         device="cpu")
    local = fn(q0)
    out["gamma"] = dict(local=_np(local), gathered=_np(fn.gather(local)),
                        sel_range=fn.sel_range)
    fn = make_sharded_per_trade_gamma_blocks_fn(lazy, mesh, axis,
                                                device="cpu")
    groups = fn(q0)
    out["blocks"] = dict(
        local=[(g.cids, g.trade_ids, _np(g.blocks)) for g in groups],
        ranges=fn.group_ranges,
        gathered=[(g.cids, g.qidx, g.trade_ids, _np(g.blocks))
                  for g in fn.gather(groups)])
    return out


def f32_ranks(rank, world):
    """The sharded f32 ladders of the lazy credit tile: this rank's block
    and the gathered ladder."""
    from adrates_torch.parallel import make_sharded_per_trade_delta_fn
    mesh, axis = _mesh(None)
    mb = credit_book()
    fn = make_sharded_per_trade_delta_fn(mb, mesh, axis,
                                         dtype=torch.float32, device="cpu")
    block = fn(mb.basket.quotes0)
    return dict(block=_np(block), gathered=_np(fn.gather(block)),
                trade_range=fn.trade_range)


def book_case(pkg: str):
    """(curve, base book, the base tiled x4 with seeded coupon and
    notional scales): the quick start's 20 OIS on its GBP curve."""
    from importlib import import_module
    mod = import_module(f"{pkg}.parallel.book")
    m = tc.quickstart_gbp_model(pkg)
    swaps = tc.quickstart_book_swaps(pkg, np.random.default_rng(0))
    base = mod.compile_book(swaps, m.value_dt)
    scales = np.random.default_rng(tc.SEED).uniform(0.5, 1.5, (2, 4))
    return (m.curves.GBP_OIS_SONIA, base,
            mod.tile_book(base, 4, scales[0], scales[1]))


def book_shocks() -> np.ndarray:
    return np.random.default_rng(tc.SEED + 1).normal(
        0.0, 1e-3, (N_SCEN, len(tc.QS_GBP_RATES)))


def book_ranks(rank, world):
    """``make_sharded_book_fn`` and ``make_pershard_aggregate_fn`` on this
    rank's ``shard_book`` of the tiled quick-start book, and whether
    ``shard_book`` refuses a trade count that does not divide."""
    from adrates_torch.parallel import (aggregate_book, distributed,
                                        make_pershard_aggregate_fn,
                                        make_sharded_book_fn, shard_book)
    from adrates_torch.parallel.book import _slice_book
    from adrates_torch.utils import LibError
    mesh, axis = _mesh(None)
    curve, base, tiled = book_case(PKG)
    shard = shard_book(tiled, mesh, axis)
    rates = np.asarray(curve.swap_rates)
    out = {"trades": shard.num_trades, "dims": list(mesh.mesh_dim_names)}
    fn = make_sharded_book_fn(curve._plan, curve._interp_type, mesh, axis,
                              device="cpu")
    res, out["k1_calls"] = _count_k1(lambda: fn(rates, shard,
                                                book_shocks()))
    out["sharded"] = {k: _np(v) for k, v in res.items()}
    fn = make_pershard_aggregate_fn(curve._plan, curve._interp_type, mesh,
                                    axis, device="cpu")
    out["pershard"] = {k: _np(v) for k, v in
                       fn(rates, aggregate_book(shard),
                          book_shocks()).items()}
    # the collectives take a non-contiguous tensor (a transpose)
    out["reduced_t"] = _np(distributed.all_reduce(
        torch.arange(6.0).reshape(2, 3).T))
    out["gathered_t"] = _np(distributed.all_gather(
        torch.full((3, rank + 1), float(rank)).T))
    odd = _slice_book(base, slice(0, base.num_trades - 1), None)
    try:
        shard_book(odd, mesh, axis)
        out["odd_raises"] = False
    except LibError:
        out["odd_raises"] = True
    return out


def failing_rank(rank, world):
    """Rank 1 raises; the others wait for it in a barrier."""
    import torch.distributed as dist
    if rank == 1:
        raise ValueError("rank 1 fails before the collective")
    dist.barrier()


def init_ranks(rank, world, store):
    """``init_distributed``'s return values in a spawned rank: with the
    world's group already active (``again``), then, the group destroyed,
    making a new one over ``store`` (``fresh``), and the new group's
    size."""
    import torch.distributed as dist
    from adrates_torch.parallel.distributed import init_distributed
    again = init_distributed(address=store, world_size=world, rank=rank,
                             backend="gloo")
    dist.destroy_process_group()
    fresh = init_distributed(address=store, world_size=world, rank=rank,
                             backend="gloo")
    return dict(again=again, fresh=fresh, size=dist.get_world_size())
