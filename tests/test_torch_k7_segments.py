"""K7's static segments and its order of summation, on the CPU.

``kernels.fitted_tables`` cuts each member's queries, in interval order
(``iq``), into chunks and segments, and lists the knots a chunk's
segments reach (``fcp``, ``fchunk``, ``ftab``;
``csrc/fitted_rows.cu`` streams them through shared memory). Held here:
the tables' invariants, and a torch emulation of the kernel's sums (each
segment's four weighted sums, then for each knot the left sums of the
segments right of it and the right sums of those left of it, in order,
chunk by chunk, then T^-T by the stored Thomas factors and R^T) against
``fitted_rows_t_plain`` at 1e-12 x max|ref|, on the ragged members of
the card tests, a 700-query extrapolated tail in one interval and a
joint legs plan (two sorted query runs in one member, as region C1's
index and discount queries are)."""

import numpy as np
import pytest
import torch

from adrates_torch.ops import kernels
from adrates_torch.ops.fitted_rows import fitted_plan
from adrates_torch.ops.interpolation import fitted_interp_plan
from adrates_torch.utils.global_types import InterpTypes

SCHEMES = ("PCHIP_LOG_DISCOUNT", "PCHIP_ZERO_RATES", "NATCUBIC_LOG_DISCOUNT",
           "NATCUBIC_ZERO_RATES", "FINCUBIC_ZERO_RATES")
# the ragged cases of tests/test_torch_kernels_cuda.py
# test_fitted_rows_kernels_ragged: knot and query counts a member
RAGGED = {"ragged": ((2, 97, 12, 43, 3), (1, 300, 0, 17, 5)),
          "short": ((2, 3, 2, 3, 2), (1, 2, 3, 0, 9)),
          "wide": ((257, 5, 190, 2, 73), (40, 1, 500, 2, 64)),
          "one": ((73,), (130,))}


def _knots(rng, n, x0=0.0):
    return x0 + np.concatenate([[0.0], np.cumsum(rng.uniform(0.02, 2.0,
                                                             n - 1))])


def _plans(rng, schemes, ns, ws):
    """Host fitted plans (a t = 0 node on every other member; queries
    before, between and past the knots), as the card tests draw them."""
    plans = []
    for g, (s, n, w) in enumerate(zip(schemes, ns, ws)):
        x = _knots(rng, n, 0.0 if g % 2 == 0 else rng.uniform(0.02, 0.3))
        q = rng.uniform(x[0] - 0.1, x[-1] + 3.0, w)
        plans.append(fitted_interp_plan(q, x, InterpTypes[s]))
    return plans


def _ragged(case, R):
    ns, ws = RAGGED[case]
    rng = np.random.default_rng(R + len(case))
    return _plans(rng, [SCHEMES[(g + R) % 5] for g in range(len(ns))], ns,
                  ws)


def _tail(scheme="NATCUBIC_ZERO_RATES"):
    """A 43-knot member whose 700 queries past its last knot lie in one
    interval, after 60 queries spread over the knots."""
    rng = np.random.default_rng(700)
    x = _knots(rng, 43)
    q = np.concatenate([np.sort(rng.uniform(x[0], x[-1], 60)),
                        np.sort(rng.uniform(x[-1], x[-1] + 30.0, 700))])
    return [fitted_interp_plan(q, x, InterpTypes[scheme])]


def _legs(scheme="PCHIP_LOG_DISCOUNT"):
    """A joint legs plan: one member's index and discount queries, each
    run sorted, the two runs one after the other."""
    rng = np.random.default_rng(744)
    x = _knots(rng, 73)
    q = np.concatenate([np.sort(rng.uniform(x[0], x[-1] + 5.0, 372)),
                        np.sort(rng.uniform(x[0], x[-1] + 5.0, 372))])
    return [fitted_interp_plan(q, x, InterpTypes[scheme])]


def _spline_cell():
    """The spline cell's OIS stage (five fitted members of 43 and 73
    knots, 2,225 sorted queries each)."""
    rng = np.random.default_rng(73)
    plans = []
    for s, n in zip(("FINCUBIC_ZERO_RATES", "NATCUBIC_LOG_DISCOUNT",
                     "PCHIP_LOG_DISCOUNT", "NATCUBIC_ZERO_RATES",
                     "PCHIP_ZERO_RATES"), (43, 73, 73, 43, 73)):
        x = _knots(rng, n, 0.0)
        q = np.sort(rng.uniform(0.0, x[-1] + 20.0, 2225))
        plans.append(fitted_interp_plan(q, x, InterpTypes[s]))
    return plans


CASES = {"tail": _tail, "legs": _legs, "spline_cell": _spline_cell}


def _stream(tab, g):
    """Member g's chunks as (k0, k1, 1 + the first query where the
    chunk's queries are consecutive in memory else 0, segments [(start in
    the chunk, length)], knots [(knot, left first, left end, right first,
    right end)])."""
    fcp = tab.fcp.tolist()
    ch = tab.fchunk[fcp[g]:fcp[g + 1]].tolist()
    tb = tab.ftab[fcp[g]:fcp[g + 1]].tolist()
    S = kernels.FIT_SEGS
    out = []
    for (k0, ns, nk, cons), (k1, *_), t in zip(ch[:-1], ch[1:], tb):
        segs = [(v & 0xffff, v >> 16) for v in t[:ns]]
        kn = t[S:S + 2 * nk]
        knots = [(x & 0xffff, (x >> 16) & 0xff, x >> 24, y & 0xff,
                  (y >> 8) & 0xff) for x, y in zip(kn[::2], kn[1::2])]
        out.append((k0, k1, cons, segs, knots))
    return out


def _k7_emulated(Ub: torch.Tensor, tab) -> torch.Tensor:
    """K7's sums in its order, vectorised over the rows: per member and
    chunk, each segment's four sums over its queries in order, then for
    each knot the left sums of its right interval's segments and the
    right sums of its left interval's, in order, added to the knot; then
    a spline member's T^-T (U^T and L^T sweeps by the stored factors) and
    R^T."""
    R = Ub.shape[0]
    out = Ub.new_zeros((R, tab.G, tab.K, tab.n_max))
    iq, qw, sp = tab.iq.long(), tab.qw, tab.sp
    for g in range(tab.G):
        n, kind = int(tab.nk[g]), int(tab.kind[g])
        yb = Ub.new_zeros((R, tab.n_max))
        db = Ub.new_zeros((R, tab.n_max))
        for k0, k1, _, segs, knots in _stream(tab, g):
            ws = iq[g, k0:k1]
            v, w = Ub[:, g, ws], qw[g, ws]
            part = []
            for a, ln in segs:
                p = Ub.new_zeros((R, 4))
                for k in range(a, a + ln):
                    p = p + w[k] * v[:, k:k + 1]
                part.append(p)
            for i, lb, le, rb, re in knots:
                t = Ub.new_zeros((R, 2))
                for s in range(lb, le):
                    t = t + part[s][:, 0:2]
                for s in range(rb, re):
                    t = t + part[s][:, 2:4]
                yb[:, i] += t[:, 0]
                db[:, i] += t[:, 1]
        if kind == kernels.FIT_HERMITE:
            out[:, g, 0, :n] = yb[:, :n]
            out[:, g, 1, :n] = db[:, :n]
            continue
        z = db.clone()
        v = Ub.new_zeros(R)
        for i in range(n):
            c = sp[g, 2, i - 1] if i > 0 else 0.0
            v = (z[:, i] - c * v) * sp[g, 1, i]
            z[:, i] = v
        b = Ub.new_zeros(R)
        for i in range(n - 1, -1, -1):
            lo = sp[g, 0, i + 1] if i + 1 < n else 0.0
            b = z[:, i] - lo * b
            z[:, i] = b
        vy = yb[:, :n] + sp[g, 4, :n] * z[:, :n]
        vy[:, :n - 1] += sp[g, 3, 1:n] * z[:, 1:n]
        vy[:, 1:] += sp[g, 5, :n - 1] * z[:, :n - 1]
        out[:, g, 0, :n] = vy
    return out


def _check_tables(tab):
    """Every real query in exactly one segment; a segment inside one
    chunk, one interval and at most FIT_SEG_LEN queries; a chunk of at
    most FIT_CHUNK queries and FIT_SEGS segments; its knots ascending,
    each segment's left sums taken by its interval's left knot and its
    right sums by the right knot, once; 1 + the chunk's first query only where
    its queries are consecutive in memory; no pad read."""
    iq, ikey = tab.iq.numpy(), tab.ikey.numpy()
    fcp = tab.fcp.tolist()
    assert fcp[0] == 0 and len(fcp) == tab.G + 1
    assert tab.fchunk.shape == (fcp[-1], 4)
    assert tab.ftab.shape == (fcp[-1], kernels.FIT_TAB)
    assert tab.nc == max(np.diff(fcp))
    for g in range(tab.G):
        W = int(tab.nw[g])
        chunks = _stream(tab, g)
        end = tab.fchunk[fcp[g + 1] - 1].tolist()
        assert end == [W, 0, 0, 0] and not tab.ftab[fcp[g + 1] - 1].any()
        covered = np.zeros(W, int)
        pos = 0
        for k0, k1, cons, segs, knots in chunks:
            assert k0 == pos and 0 < k1 - k0 <= kernels.FIT_CHUNK
            pos = k1
            assert 0 < len(segs) <= kernels.FIT_SEGS
            assert len(knots) <= 2 * kernels.FIT_SEGS
            at = 0
            for a, ln in segs:
                assert a == at and 1 <= ln <= kernels.FIT_SEG_LEN
                at += ln
                covered[k0 + a:k0 + a + ln] += 1
                assert np.all(ikey[g, k0 + a:k0 + a + ln] == ikey[g, k0 + a])
            assert at == k1 - k0
            # knots: ascending; a segment's left sums to its interval's
            # left knot, its right sums to the right knot, each once
            ks = [kn[0] for kn in knots]
            assert ks == sorted(set(ks))
            left = np.zeros(len(segs), int)
            right = np.zeros(len(segs), int)
            for i, lb, le, rb, re in knots:
                assert lb <= le and rb <= re and (lb < le or rb < re)
                for s in range(lb, le):
                    assert ikey[g, k0 + segs[s][0]] == i
                    left[s] += 1
                for s in range(rb, re):
                    assert ikey[g, k0 + segs[s][0]] == i - 1
                    right[s] += 1
            assert np.all(left == 1) and np.all(right == 1)
            # no pad is read: the chunk's queries are real ones
            ws = iq[g, k0:k1]
            assert np.all((ws >= 0) & (ws < W))
            assert cons == (1 + ws[0] if np.all(np.diff(ws) == 1) else 0)
        assert pos == W
        assert np.all(covered == 1)


def _ub(tab, R, seed):
    return torch.tensor(np.random.default_rng(seed).standard_normal(
        (R, tab.G, tab.W_max)))


def _emulation_matches(plans, R, seed):
    tab = fitted_plan(plans, "cpu").tables
    _check_tables(tab)
    Ub = _ub(tab, R, seed)
    ref = kernels.fitted_rows_t_plain(Ub, tab)
    got = _k7_emulated(Ub, tab)
    assert float((got - ref).abs().max()) <= 1e-12 * float(ref.abs().max())
    return tab


@pytest.mark.parametrize("R", [1, 7, 33, 100])
@pytest.mark.parametrize("case", sorted(RAGGED))
def test_emulated_order_matches_the_twin_ragged(case, R):
    _emulation_matches(_ragged(case, R), R, R)


@pytest.mark.parametrize("case", sorted(CASES))
def test_emulated_order_matches_the_twin(case):
    _emulation_matches(CASES[case](), 5, 3)


def test_the_tail_is_cut_into_short_segments():
    """The 700 queries of one interval are 88 segments of at most 8, over
    as many chunks as their count needs, none walked alone."""
    tab = fitted_plan(_tail(), "cpu").tables
    last = int(tab.ikey[0, -1])
    lens = [ln for _, _, _, segs, knots in _stream(tab, 0)
            for i, lb, le, _, _ in knots if i == last
            for _, ln in segs[lb:le]]
    assert sum(lens) == 700 and max(lens) == kernels.FIT_SEG_LEN
    assert len(lens) == 88
    spread = sum(1 for *_, knots in _stream(tab, 0)
                 if any(kn[0] == last and kn[1] < kn[2] for kn in knots))
    assert spread >= -(-88 // kernels.FIT_SEGS)


def test_the_legs_gather_and_the_stage_streams():
    """The joint legs plan's chunks interleave its two runs (gathered
    through iq), the spline cell's sorted queries stream consecutively."""
    legs = fitted_plan(_legs(), "cpu").tables
    assert not all(c[2] for c in _stream(legs, 0))
    cell = fitted_plan(_spline_cell(), "cpu").tables
    for g in range(cell.G):
        assert all(c[2] for c in _stream(cell, g))


def test_tables_are_fixed():
    """The same plans give the same tables (the order is static)."""
    a = fitted_plan(_ragged("wide", 7), "cpu").tables
    b = fitted_plan(_ragged("wide", 7), "cpu").tables
    for f in ("fcp", "fchunk", "ftab", "iq", "ikey"):
        assert torch.equal(getattr(a, f), getattr(b, f))


def test_chunks_stop_at_the_segment_cap():
    """A member whose every query is in its own interval fills a chunk's
    FIT_SEGS segments before its FIT_CHUNK queries."""
    x = np.arange(400, dtype=np.float64)
    q = x[:-1] + 0.5
    tab = fitted_plan([fitted_interp_plan(q, x, InterpTypes[
        "PCHIP_LOG_DISCOUNT"])], "cpu").tables
    _check_tables(tab)
    chunks = _stream(tab, 0)
    assert [len(c[3]) for c in chunks[:-1]] == [kernels.FIT_SEGS] * (
        len(chunks) - 1)
    assert all(k1 - k0 == kernels.FIT_SEGS for k0, k1, *_ in chunks[:-1])
    Ub = _ub(tab, 3, 9)
    ref = kernels.fitted_rows_t_plain(Ub, tab)
    assert float((_k7_emulated(Ub, tab) - ref).abs().max()) \
        <= 1e-12 * float(ref.abs().max())
