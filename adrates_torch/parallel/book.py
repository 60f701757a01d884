"""Single-curve OIS book: compile calibration swaps to index tables and
price them against one bootstrapped curve.

Port of ``adrates_tpu/parallel/book.py:BookTensors``, ``compile_book``
(:89) and ``book_pvs`` (:234) — what the ``OISCurve`` refit gate needs.
Every payment/accrual time collapses into ONE sorted unique-time grid and
trades hold indices into it, so pricing the book is one bootstrap, one
interpolation over the grid and per-trade gathers.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.bootstrap import bootstrap_ois
from ..ops.interpolation import (plan_to_torch, simple_df_static,
                                 simple_interp_plan)
from ..utils.global_types import InterpTypes


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


def compile_book(swaps, value_dt, index_dc=None) -> BookTensors:
    """Compile a list of OIS products into one indexed BookTensors.

    Only future payments (time > 0) are marked live; pricing assumes the
    curve's anchor (t=0) is the valuation date. ``index_dc`` is the
    projection curve's day count for the forward divisor (defaults to
    each leg's own basis).
    """
    fixed = [s._fixed_leg.tensor(value_dt) for s in swaps]
    flt = [s._float_leg.tensor(value_dt, index_dc=index_dc)
           for s in swaps]
    P_max = max(max(t.payment_times.shape[0] for t in fixed),
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


def book_pvs(rates: torch.Tensor, plan: dict, interp_type: InterpTypes,
             book: BookTensors, grid_times: np.ndarray) -> torch.Tensor:
    """Per-trade PVs [B]: one bootstrap, one interpolation over the unique
    grid, per-trade gathers. ``plan`` is a device plan
    (``ops/bootstrap.plan_to_torch``) and ``grid_times`` the host copy of
    the bootstrap's node times (t=0 included), which with the book's
    static unique times fixes the interpolation plan."""
    dev = rates.device
    _, dfs = bootstrap_ois(rates, plan)
    iplan = plan_to_torch(simple_interp_plan(book.unique_times, grid_times,
                                             interp_type), dev)
    dfs_u = simple_df_static(iplan, dfs, interp_type)

    def t(a, dtype=torch.float64):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    def g(idx):
        return dfs_u[t(idx, torch.int64)]

    ia = t(book.flt_index_alphas)
    ratio = torch.where(ia > 0.0, t(book.flt_pay_alphas)
                        / torch.where(ia > 0.0, ia, 1.0), 0.0)
    w_fix = t(book.fix_payments) * t(book.fix_mask)
    w_fwd = ratio * t(book.flt_notionals) * t(book.flt_mask)
    w_spr = (t(book.flt_spreads) * t(book.flt_pay_alphas)
             * t(book.flt_notionals) * t(book.flt_mask))
    fix_pv = torch.sum(w_fix * g(book.fix_idx), dim=1)
    cf = w_fwd * (g(book.flt_start_idx) / g(book.flt_end_idx) - 1.0) + w_spr
    return fix_pv + torch.sum(cf * g(book.flt_pay_idx), dim=1)
