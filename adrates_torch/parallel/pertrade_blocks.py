"""Block-sparse per-trade gamma matrices for the WHOLE book.

Port of ``adrates_tpu/parallel/pertrade_blocks.py``. A trade's exact
gamma lives on its own curves' quote slots: quotes that cannot move any
curve the trade's cashflows gather from have identically zero
second-order effect on its PV. So instead of the dense [B, N, N]
per-trade tensor (terabytes at book scale), this module emits, for EVERY
trade, its own-block matrix [k, k] plus the block's quote-index map,
where k = the total quote count of the curves the trade touches — closed
over XCCY parents when they are recalibrated, so the block is exact, not
a truncation.

Mechanics:

- base trades are grouped by their touched-curve signature (the host
  harvest is numpy, vectorised);
- term 1 (each trade's DF-space Hessian quad form, restricted to its
  block's quote rows) runs for every trade of every group in ONE launch
  of the K3 kernel (``ops/kernels.py:pertrade_quad_form``);
- term 2 (the curve-Hessian contraction) is
  ``structured_risk.make_pertrade_curvehess(restrict=...)`` per group,
  on per-stage tensors computed once per call and shared by every group;
- the shared curve jacobian J and the grids come from the book's risk
  split at q, once per call;
- a group whose term-2 operands (DF-gradient rows [Bg, T*U] and blocks
  [Bg, k, k], f64) exceed the device budget ``RISK_CHUNK_BYTES`` runs
  term 2 in equal sub-blocks within it;
- a lazily tiled book's copies are the scale broadcast of the base
  blocks (per-trade gamma is linear in the notional).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops import kernels
from ..utils.error import LibError
from . import multibook
from .multibook import (MultiBook, _base_trades, _device_book, _f64,
                        _harvest, _jacobians_fn, _k3_tables, _k3_weights,
                        _need_multibook, _slot_dict, _slot_gradient,
                        _tables_to, book_inputs)


@dataclasses.dataclass
class GammaBlockGroup:
    """One signature group's static metadata + (after the call) blocks.

    ``qidx`` maps block coordinates to packed-quote-vector coordinates:
    blocks[b][i, j] is the gamma entry d2 PV_b / dq[qidx[i]] dq[qidx[j]]
    (ccy units per unit-rate^2; multiply by 1e-8 for per-bp^2). Entries
    of the full [N, N] per-trade gamma outside qidx x qidx are exactly
    zero."""
    cids: Tuple[int, ...]            # touched curve ids (sorted)
    qidx: np.ndarray                 # [k] global quote indices
    trade_ids: np.ndarray            # [Bg_total] trade ids (tiled ids)
    blocks: Optional[torch.Tensor] = None   # [Bg_total, k, k]


def dense_from_block(group: GammaBlockGroup, pos: int, n_quotes: int
                     ) -> np.ndarray:
    """Scatter one trade's block into the dense [N, N] (test/report
    helper; production consumers should stay in block coordinates)."""
    out = np.zeros((n_quotes, n_quotes))
    blk = group.blocks[pos].detach().cpu().numpy()
    out[np.ix_(group.qidx, group.qidx)] = blk
    return out


def _touched_sets(mb: MultiBook) -> np.ndarray:
    """[B_base, C] bool: the curves each BASE trade's live slots gather
    from, closed over XCCY parents when the basket recalibrates them
    in-graph (a quote move on a parent then moves the XCCY grid, so the
    block must carry those directions)."""
    basket = mb.basket
    CU = basket.n_grid
    curve_of = np.asarray(basket.grid_curve_of, dtype=np.int64)
    agg = mb.aggregate
    touched = np.zeros((_base_trades(mb), len(basket.specs)), dtype=bool)
    trip_cids = [curve_of[np.asarray(x, dtype=np.int64)]
                 for x in (agg.trip_s, agg.trip_e, agg.trip_p)]
    for cb in mb.cols:
        w = np.asarray(cb.w)
        live = w != 0.0
        t = np.broadcast_to(np.asarray(cb.row_trade)[:, None],
                            w.shape)[live]
        c = np.asarray(cb.col_idx, dtype=np.int64)[live]
        lin = c < CU
        touched[t[lin], curve_of[c[lin]]] = True
        for tc in trip_cids:
            touched[t[~lin], tc[c[~lin] - CU]] = True
    if mb.clamp is not None:
        st = np.asarray(mb.clamp.slot_trade)
        for idx in (mb.clamp.s_idx, mb.clamp.e_idx, mb.clamp.p_idx):
            touched[st, curve_of[np.asarray(idx, dtype=np.int64)]] = True
    if basket.recalibrate_xccy:
        closed = touched.copy()
        for cid, spec in enumerate(basket.specs):
            if spec.kind == "xccy":
                closed[:, spec.dom_id] |= touched[:, cid]
                closed[:, spec.for_id] |= touched[:, cid]
        touched = closed
    return touched


def _harvest_group(mb: MultiBook, base_ids: np.ndarray) -> dict:
    """Flat lin/trip/clamp slot tables for one group's base trades (b
    indices LOCAL to the group, weights at base scale)."""
    return _harvest(mb, base_ids, np.ones(base_ids.shape[0]))


def _split_tables(tab: dict, sizes: List[int]) -> List[dict]:
    """Split a group's tables into sub-blocks by LOCAL b index ranges of
    the given sizes, b re-based to each sub-block."""
    subs = []
    lo = 0
    for s in sizes:
        hi = lo + s
        sub = {}
        for kind in ("lin", "trip", "clamp"):
            a = tab[kind]
            sel = a[(a[:, 0] >= lo) & (a[:, 0] < hi)].copy()
            sel[:, 0] -= lo
            sub[kind] = sel
        subs.append(sub)
        lo = hi
    return subs


def _tables_device(sub: dict, mb: MultiBook, row_pos: Dict[int, int],
                   device) -> dict:
    """One sub-block's tables on ``device``, with both the GLOBAL grid
    columns (for the dfs and J gathers) and the LOCAL restricted-row
    positions (the ``*l`` columns, for the [B, T*U] gradient scatter: the
    restricted grid is time-DENSE per touched curve, the layout
    ``make_pertrade_curvehess``'s restrict mode slices)."""
    U = mb.unique_times.shape[0]
    curve_of = np.asarray(mb.basket.grid_curve_of, dtype=np.int64)
    local_of = np.asarray(mb.basket.grid_local_of, dtype=np.int64)
    rowpos_arr = np.full(len(mb.basket.specs), -1, dtype=np.int64)
    for cid, rp in row_pos.items():
        rowpos_arr[cid] = rp

    def loc(idx):
        idx = idx.astype(np.int64)
        return (rowpos_arr[curve_of[idx]] * U + local_of[idx]).astype(
            np.int32)

    lin, trip, cl = sub["lin"], sub["trip"], sub["clamp"]
    tb = _slot_dict(lin, trip, cl)
    tb.update(lin_cl=loc(lin[:, 1]), tr_sl=loc(trip[:, 1]),
              tr_el=loc(trip[:, 2]), tr_pl=loc(trip[:, 3]),
              cl_sl=loc(cl[:, 1]), cl_el=loc(cl[:, 2]), cl_pl=loc(cl[:, 3]))
    return _tables_to(tb, device)


def _sub_block_trades(width: int, k: int) -> int:
    """Trades per term-2 sub-block: their DF-gradient rows [n, width] and
    blocks [n, k, k], f64, within ``multibook.RISK_CHUNK_BYTES`` (at
    least 1)."""
    return max(1, multibook.RISK_CHUNK_BYTES // (8 * (width + k * k)))


def _group_specs(mb: MultiBook, device, part=None):
    """Per-signature-group static metadata: cids, qidx, row_pos,
    trade_ids, Bg, the harvested slot tables ``tab`` (local b), the
    term-2 sub-block ``sizes`` (:func:`_sub_block_trades`) and their
    device tables ``tabs``, and the group's restricted ``contract``.
    With ``part = (r, n)`` each group keeps only share r of n of its
    base trades (contiguous, ceil(Bg / n) each, the last ones shorter or
    empty), ``range`` says which."""
    basket = mb.basket
    U = mb.unique_times.shape[0]
    if not basket.batch_curves:
        raise LibError("per-trade gamma blocks need the batched curve "
                       "topology (compile_multibook batch_curves=True)")
    from .structured_risk import make_pertrade_curvehess

    touched = _touched_sets(mb)
    live = np.nonzero(touched.any(axis=1))[0]   # no live slot: no group
    uniq, inv = np.unique(touched[live], axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    groups = sorted(((tuple(np.nonzero(row)[0].tolist()), live[inv == u])
                     for u, row in enumerate(uniq)), key=lambda g: g[0])
    B_base = _base_trades(mb)
    n_cop = 1 if mb.tile is None else int(mb.tile.scale.shape[0])
    topo = basket.topology()

    specs = []
    for cids, base_ids in groups:
        qidx = np.concatenate([
            np.arange(basket.specs[c].offset,
                      basket.specs[c].offset + basket.specs[c].n_quotes)
            for c in cids]).astype(np.int32)
        row_pos = {cid: i for i, cid in enumerate(cids)}
        lo, hi = 0, int(base_ids.shape[0])
        if part is not None:
            r, n = part
            share = -(-hi // n)
            lo, hi = min(r * share, hi), min((r + 1) * share, hi)
            base_ids = base_ids[lo:hi]
        Bg = int(base_ids.shape[0])
        tab = _harvest_group(mb, base_ids)
        chunk = _sub_block_trades(len(cids) * U, qidx.shape[0])
        n_sub = -(-Bg // chunk)
        sub_size = -(-Bg // n_sub) if n_sub else 0
        sizes = [min(sub_size, Bg - i * sub_size) for i in range(n_sub)]
        specs.append(dict(
            cids=cids, qidx=qidx, row_pos=row_pos, Bg=Bg, tab=tab,
            range=(lo, hi),
            sizes=sizes,
            tabs=[_tables_device(s, mb, row_pos, device)
                  for s in _split_tables(tab, sizes)],
            trade_ids=(np.arange(n_cop)[:, None] * B_base
                       + base_ids[None, :]).reshape(-1).astype(np.int64),
            contract=make_pertrade_curvehess(
                topo, restrict=dict(cids=list(cids), width=len(qidx)))))
    return specs


def _blocks_fn(mb: MultiBook, device, part=None):
    """make_per_trade_gamma_blocks_fn's body, over every group's share
    ``part`` (see :func:`_group_specs`) of its base trades."""
    from .structured_risk import make_pertrade_tensors

    mb = _need_multibook(mb)
    specs = _group_specs(mb, device, part)
    inp = book_inputs(mb)
    book = _device_book(inp, device, sweep=False, quad=False)
    jac = _jacobians_fn(inp, book)
    tensors = make_pertrade_tensors(inp.topology)
    U = mb.unique_times.shape[0]
    scale = None if mb.tile is None else _f64(mb.tile.scale, device)

    # every group's trips and clamp slots, b = the trade's K3 item
    # (groups in order)
    ibase = np.concatenate([[0], np.cumsum([gs["Bg"] for gs in specs])])

    def items(kind, n):
        parts = [np.zeros((0, n))]
        for g, gs in enumerate(specs):
            a = gs["tab"][kind].copy()
            a[:, 0] += ibase[g]
            parts.append(a)
        return np.concatenate(parts)

    host = _slot_dict(np.zeros((0, 3)), items("trip", 5), items("clamp", 9))
    k3 = _k3_tables(host, [gs["qidx"] for gs in specs],
                    [gs["Bg"] for gs in specs], device)
    k3_tb = _tables_to(host, device)

    def prep(qvec):
        """(q, dfs [n_grid], Jt [n_grid, N], K3's slot weights) at qvec."""
        q = _f64(qvec, device)
        dfs, J = jac(q[None, :])
        dfs, Jt = dfs[0], J[0].T.contiguous()
        return q, dfs, Jt, _k3_weights(dfs, k3_tb)

    def fn(qvec) -> List[GammaBlockGroup]:
        q, dfs, Jt, w = prep(qvec)
        so = tensors(q, book.params)
        term1 = kernels.pertrade_quad_form(Jt, dfs, w, k3)
        out = []
        for gs, t1 in zip(specs, term1):
            width = len(gs["cids"]) * U
            parts = [gs["contract"](so, _slot_gradient(
                dfs, tb, n, width, local=True))
                for n, tb in zip(gs["sizes"], gs["tabs"])]
            blocks = t1 + torch.cat(parts) if parts else t1
            if scale is not None:
                k = blocks.shape[1]
                blocks = (scale[:, None, None, None]
                          * blocks[None]).reshape(-1, k, k)
            out.append(GammaBlockGroup(cids=gs["cids"], qidx=gs["qidx"],
                                       trade_ids=gs["trade_ids"],
                                       blocks=blocks))
        return out

    fn.n_groups = len(specs)
    fn.group_meta = [(gs["cids"], gs["qidx"].shape[0], gs["Bg"])
                     for gs in specs]
    fn.group_ranges = [gs["range"] for gs in specs]
    fn.sub_sizes = [gs["sizes"] for gs in specs]
    fn.prep = prep
    fn.k3 = k3
    return fn


def make_per_trade_gamma_blocks_fn(mb: MultiBook, device):
    """Build fn(qvec) -> List[GammaBlockGroup] with every trade's exact
    own-block gamma matrix (see the module docstring) on ``device``.
    Requires the batched stage topology (compile_multibook's default
    batch_curves=True). ``fn.n_groups``, ``fn.group_meta`` ((cids, k, Bg)
    per group) and ``fn.sub_sizes`` (each group's term-2 sub-blocks)
    describe the call; ``fn.prep(qvec)`` gives K3's inputs, ``fn.k3`` its
    tables."""
    return _blocks_fn(mb, torch.device(device))
