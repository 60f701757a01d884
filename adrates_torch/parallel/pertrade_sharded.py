"""Per-trade risk with the book's trades sharded over a mesh.

Port of ``adrates_tpu/parallel/pertrade_sharded.py``. Each rank computes
its own trades' part; the curve graph, its jacobian J and the per-stage
second-order tensors are replicated work:

- ``make_sharded_per_trade_delta_fn``: the rank's contiguous range of the
  trades (``multibook.shard_multibook``'s layout: the trade count padded
  with dead trades to a multiple of the shard count) through K1 against
  the replicated Jv, plus its clamp rows. The [B_pad, N] ladder is split
  along trades as the JAX package's ``psum_scatter`` output is, so no
  collective runs: each rank's rows are its own trades' whole ladders.
- ``make_sharded_per_trade_gamma_fn``: the selection split across ranks,
  each running ``make_per_trade_gamma_fn``'s machinery (K3 term 1, the
  term-2 stage tensors) on its part. No collective.
- ``make_sharded_per_trade_gamma_blocks_fn``: each signature group's base
  trades split across ranks, each running the blocks' group kernel (K3)
  on its share. No collective.

Each fn's ``gather(result)`` all-gathers the shards into the single-device
layout (for tests and reports; the sharded path itself never gathers).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..utils.device import resolve_device
from .distributed import ShardAxis, all_gather
from .multibook import (MultiBook, _as_shard, _device_book, _jacobians_fn,
                        _ladder_fn, book_inputs, make_per_trade_gamma_fn,
                        sweep_tables_from_cols)
from .pertrade_blocks import GammaBlockGroup, _blocks_fn


def make_sharded_per_trade_delta_fn(mb, mesh, axis="book", dtype=None,
                                    device=None):
    """(qvec [N]) -> this rank's [B_pad / n, N] block of the per-trade
    delta ladders (``adrates_tpu`` ``pertrade_sharded.py:133``): trades
    ``fn.trade_range`` of the book padded to B_pad (its dead tail rows
    exact zeros), ``fn.n_trades`` the live count. ``mb`` is a MultiBook
    (materialized or lazily tiled: a lazy one expands only this rank's
    trades on the device) or a ``MultiBookShard``. Jv is replicated, the
    rank's own trades run on K1 (in ``dtype``, None: f64, as
    ``make_per_trade_delta_fn``), the clamp rows come from
    ``_clamp_slot_terms``. ``fn.gather(block)`` gives the whole
    [B_pad, N] ladder on every rank; ``fn.shard`` is the shard."""
    shard = _as_shard(mb, mesh, axis, device)
    inp = book_inputs(shard.book)
    book = _device_book(inp, shard.device, sweep=False, quad=False)
    sweep = sweep_tables_from_cols(
        shard.cols, shard.n_local,
        inp.n_grid + int(book.aggregate.trip_s.shape[0]))
    fn = _ladder_fn(_jacobians_fn(inp, book), book.aggregate, sweep,
                    shard.clamp, shard.device, dtype)
    fn.n_trades = shard.book.n_trades
    fn.trade_range = (shard.lo, shard.lo + shard.n_local)
    fn.gather = lambda block: all_gather(block, shard.axis.group)
    fn.shard = shard
    return fn


def make_sharded_per_trade_gamma_fn(mb: MultiBook, mesh, trade_ids,
                                    axis="book", device=None):
    """(qvec [N]) -> this rank's [B_loc, N, N] exact gammas of the
    selected trades (``adrates_tpu`` ``pertrade_sharded.py:314``): the
    selection, padded by repeating its last trade to a multiple of the
    shard count, split into contiguous parts of B_loc, this rank's part
    (``fn.sel_range`` of the padded selection) through
    ``make_per_trade_gamma_fn`` (K3 term 1, the term-2 stage tensors).
    ``fn.gather(local)`` gives the [B_sel, N, N] of every selected trade
    on every rank."""
    ax = ShardAxis(mesh, axis)
    sel = np.asarray(trade_ids, dtype=np.int64)
    n_sel = int(sel.shape[0])
    n_loc = -(-n_sel // ax.n)
    sel_pad = np.concatenate([sel, np.repeat(sel[-1:],
                                             n_loc * ax.n - n_sel)])
    lo = ax.index * n_loc
    fn = make_per_trade_gamma_fn(mb, sel_pad[lo:lo + n_loc],
                                 resolve_device(device))
    fn.sel_range = (lo, lo + n_loc)
    fn.gather = lambda local: all_gather(local, ax.group)[:n_sel]
    return fn


def make_sharded_per_trade_gamma_blocks_fn(mb: MultiBook, mesh, axis="book",
                                           device=None):
    """(qvec [N]) -> this rank's ``GammaBlockGroup``s (``adrates_tpu``
    ``pertrade_sharded.py:232``): every signature group of
    ``make_per_trade_gamma_blocks_fn``, in its order, holding this rank's
    contiguous share of the group's base trades (ceil(Bg / n) each;
    ``fn.group_ranges``) in every tile copy, term 1 on K3 in one launch
    for every group and term 2 per group. A lazily tiled book's copies
    are the scale broadcast of the base blocks, as on one device.
    ``fn.gather(groups)`` gives every group's blocks for all its trades,
    in the single-device order, on every rank."""
    ax = ShardAxis(mesh, axis)
    fn = _blocks_fn(mb, resolve_device(device), part=(ax.index, ax.n))
    n_cop = 1 if mb.tile is None else int(mb.tile.scale.shape[0])

    def gather(groups: List[GammaBlockGroup]) -> List[GammaBlockGroup]:
        out = []
        for g in groups:
            k, share = g.qidx.shape[0], len(g.trade_ids) // n_cop
            # copy-major: [n_cop, share, k, k] gathered along the share
            blocks = all_gather(g.blocks.reshape(n_cop, share, k, k),
                                ax.group, dim=1).reshape(-1, k, k)
            ids = torch.as_tensor(g.trade_ids, device=g.blocks.device)
            ids = all_gather(ids.reshape(n_cop, share), ax.group,
                             dim=1).reshape(-1).cpu().numpy()
            out.append(GammaBlockGroup(cids=g.cids, qidx=g.qidx,
                                       trade_ids=ids, blocks=blocks))
        return out

    fn.gather = gather
    return fn
