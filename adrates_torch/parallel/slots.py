"""Swap rows as K1 slots: the per-slot weights of a compiled swap table and
K1's flat (trade, column, weight) slots over a ``[DF grid; trip values]``
value table, with the forward trips keyed as an aggregate keys them.

Both book kinds build K1's tables from these: the single-curve book
(``book.py``: ``BookTensors`` over its unique grid) and the multibook's
public ``trade_pvs`` (``multibook.MultiBookRows``, which carry the same
fields, over the flat DF grid). Host numpy only.
"""

from __future__ import annotations

import numpy as np


def _combine_book(book):
    """The scenario-invariant per-slot weights (host numpy [B, P] each):

      pv_b = sum_p w_fix*df[fix] + (w_fwd*(df_s/df_e - 1) + w_spr)*df_pay
    """
    w_fix = np.asarray(book.fix_payments) * np.asarray(book.fix_mask)
    ia = np.asarray(book.flt_index_alphas)
    pa = np.asarray(book.flt_pay_alphas)
    ratio = np.where(ia > 0.0, pa / np.where(ia > 0.0, ia, 1.0), 0.0)
    notional = np.asarray(book.flt_notionals) * np.asarray(book.flt_mask)
    w_fwd = ratio * notional
    w_spr = np.asarray(book.flt_spreads) * pa * notional
    return w_fix, w_fwd, w_spr


def _trip_keys(s, e, p, U: int) -> np.ndarray:
    """The (start, end, pay) index triple as one int64 key."""
    return (np.asarray(s).astype(np.int64) * U + e) * U + p


def _unkey(uniq: np.ndarray, U: int):
    """(trip_s, trip_e, trip_p) int32 from sorted trip keys."""
    return ((uniq // (U * U)).astype(np.int32),
            ((uniq // U) % U).astype(np.int32),
            (uniq % U).astype(np.int32))


def sweep_slots(rows, trade_of, U: int):
    """K1's flat slots (trade, column, weight) of row tables ``rows``
    (``BookTensors`` or ``MultiBookRows``), ``trade_of[i]`` the trades of
    ``rows[i]``'s rows: each row's fixed slots (``w_fix`` at
    ``fix_idx``), spread slots (``w_spr`` at ``flt_pay_idx``) and forward
    slots (``w_fwd`` at column U + t of its (s, e, p) trip t, keyed as
    ``book.aggregate_book`` keys them, over a grid of U columns); returns
    them with the sorted trip keys."""
    trade, col, w, fwd = [], [], [], []
    for b, rt in zip(rows, trade_of):
        tid = np.repeat(np.asarray(rt, np.int64),
                        np.asarray(b.fix_idx).shape[1])
        w_fix, w_fwd, w_spr = _combine_book(b)
        pay = np.asarray(b.flt_pay_idx).ravel()
        trade += [tid, tid]
        col += [np.asarray(b.fix_idx).ravel(), pay]
        w += [w_fix.ravel(), w_spr.ravel()]
        live = w_fwd.ravel() != 0.0
        fwd.append((tid[live], w_fwd.ravel()[live],
                    _trip_keys(np.asarray(b.flt_start_idx).ravel()[live],
                               np.asarray(b.flt_end_idx).ravel()[live],
                               pay[live], U)))
    uniq, inverse = np.unique(np.concatenate([k for _, _, k in fwd]),
                              return_inverse=True)
    trade.append(np.concatenate([t for t, _, _ in fwd]))
    col.append(U + inverse.ravel())
    w.append(np.concatenate([x for _, x, _ in fwd]))
    return (np.concatenate(trade), np.concatenate(col).astype(np.int64),
            np.concatenate(w), uniq)
