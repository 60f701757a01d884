"""K1's trade-major layout (``kernels.pvs_sweep(vT, tab, trade_major=True)``,
the per-trade ladders' [B, N]) on the CPU, where the wrapper runs its
plain twin.

- The twin's trade-major result is the scenario-major one transposed,
  bit for bit, in f64 and f32, at N around the kernel's piece and pass
  widths, with trades that have no slot and a short last block.
- The launch plan (``kernels.sweep_plan``: pass width, passes, pieces a
  lane, row strides, shared memory) at the same N, against numbers
  worked out by hand from the kernel's constants.
- The kernel's walk (blocks of 32 trades, chunks of 32 stage rows,
  each trade's 32-slot window and its prefix count, the
  longest-with-shortest pairing, the column passes) emulated in numpy:
  every slot summed once, equal to the twin (1e-12 x max|ref|: the same
  slot order, products rounded apart from the adds).
- The ladder path makes one trade-major call and returns that call's
  tensor (no transpose after it), in f64 and f32.

The ladders against the JAX package go through the same path in
``tests/test_torch_pertrade.py`` and ``tests/test_torch_f32_ladder.py``.
"""

import numpy as np
import pytest
import torch

import torch_cases as tc
from adrates_torch.ops import kernels
from adrates_torch.parallel import multibook as tmb

NS = [1, 3, 33, 128, 129, 184, 193, 300]
DTYPES = [torch.float64, torch.float32]


def _tables(rng, M, B, dtype):
    """Random K1 tables over an [M, .] value table: padded buckets with
    dead slots and repeated columns, every fifth trade without a slot,
    B not a multiple of the 32-trade block."""
    t, c, w = [], [], []
    for R, L in [(60, 3), (40, 17), (6, 70)]:
        ci = rng.integers(0, M, (R, L))
        ci[:, 1:] = np.where(rng.random((R, L - 1)) < 0.3, ci[:, :1],
                             ci[:, 1:])
        wi = rng.normal(size=(R, L))
        wi[rng.random((R, L)) < 0.2] = 0.0
        ti = rng.integers(0, B, R)
        wi[ti % 5 == 0] = 0.0
        t.append(np.repeat(ti, L))
        c.append(ci.ravel())
        w.append(wi.ravel())
    tab = kernels.sweep_tables(*(torch.tensor(np.concatenate(x))
                                 for x in (t, c, w)), B, M)
    return tab if dtype == torch.float64 else kernels.sweep_tables_as(
        tab, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("N", NS)
def test_trade_major_twin_is_the_transpose(N, dtype):
    rng = np.random.default_rng(N)
    M, B = 250, 3 * 32 + 7
    tab = _tables(rng, M, B, dtype)
    vT = torch.tensor(rng.normal(size=(M, N)), dtype=dtype)
    empty = tab.tptr[1:] == tab.tptr[:-1]
    assert int(empty.sum()) > 0 and B % kernels.SWEEP_BLOCK
    sm = kernels.pvs_sweep_plain(vT, tab)
    tm = kernels.pvs_sweep_plain(vT, tab, trade_major=True)
    assert tm.shape == (B, N) and tm.dtype == dtype and tm.is_contiguous()
    assert torch.equal(tm, sm.T)
    assert torch.equal(kernels.pvs_sweep(vT, tab, trade_major=True), tm)
    assert not tm[empty].any()


# (N, dtype) -> (width, passes, pieces, vec, ld, pitch, smem bytes): a
# pass is 32 lanes x 3 double2 (192 columns) or x 2 float4 (256); a stage
# row is the widest pass's whole pieces; two stages of 32 rows
PLANS = {
    (1, torch.float64): (192, 1, 3, 2, 2, 2, 1024),
    (3, torch.float64): (192, 1, 3, 2, 4, 4, 2048),
    (33, torch.float64): (192, 1, 3, 2, 34, 34, 17408),
    (128, torch.float64): (192, 1, 3, 2, 128, 128, 65536),
    (129, torch.float64): (192, 1, 3, 2, 130, 130, 66560),
    (184, torch.float64): (192, 1, 3, 2, 184, 184, 94208),
    (193, torch.float64): (192, 2, 3, 2, 194, 192, 98304),
    (300, torch.float64): (192, 2, 3, 2, 300, 192, 98304),
    (1, torch.float32): (256, 1, 2, 4, 4, 4, 1024),
    (3, torch.float32): (256, 1, 2, 4, 4, 4, 1024),
    (33, torch.float32): (256, 1, 2, 4, 36, 36, 9216),
    (128, torch.float32): (256, 1, 2, 4, 128, 128, 32768),
    (129, torch.float32): (256, 1, 2, 4, 132, 132, 33792),
    (184, torch.float32): (256, 1, 2, 4, 184, 184, 47104),
    (193, torch.float32): (256, 1, 2, 4, 196, 196, 50176),
    (300, torch.float32): (256, 2, 2, 4, 300, 256, 65536),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("N", NS)
def test_launch_plan(N, dtype):
    p = kernels.sweep_plan(N, dtype)
    assert (p.width, p.passes, p.pieces, p.vec, p.ld, p.pitch,
            p.smem_bytes) == PLANS[N, dtype]
    # two blocks an SM (228 KB, 2 KB a block besides), every pass's
    # pieces inside a stage row
    assert 2 * (p.smem_bytes + 2048) <= 228 * 1024
    assert p.pitch * p.passes >= N and p.width == 32 * p.pieces * p.vec


def test_launch_plan_refuses_other_dtypes():
    with pytest.raises(TypeError):
        kernels.sweep_plan(184, torch.float16)


def _emulate(vT: np.ndarray, tab, plan, rows=kernels.SWEEP_ROWS
             ) -> np.ndarray:
    """The trade-major kernel's walk in numpy, one (block, pass) at a
    time, following ``csrc/pvs_sweep.cu:pvs_sweep_tm_kernel``; asserts
    its invariants on the way."""
    M, N = vT.shape
    B, TB = tab.n_trades, kernels.SWEEP_BLOCK
    tptr, srow, sw, bptr, brow = (x.numpy() for x in (
        tab.tptr, tab.slot_row, tab.slot_w, tab.bptr, tab.brow))
    out = np.full((B, N), np.nan)
    for blk in range(bptr.shape[0] - 1):
        r0, nrow = int(bptr[blk]), int(bptr[blk + 1] - bptr[blk])
        lens = [int(tptr[t + 1] - tptr[t]) if t < B else -1
                for t in range(blk * TB, blk * TB + TB)]
        perm = sorted(range(TB), key=lambda u: (-lens[u], u))
        owned = [(perm[w], perm[TB - 1 - w]) for w in range(TB // 2)]
        assert sorted(u for pair in owned for u in pair) == list(range(TB))
        for p in range(plan.passes):
            n0 = p * plan.width
            cols = slice(n0, min(N, n0 + plan.width))
            for pair in owned:
                for u in pair:
                    t = blk * TB + u
                    if t >= B:
                        continue
                    cur, end = int(tptr[t]), int(tptr[t + 1])
                    acc = np.zeros(cols.stop - n0)
                    for c in range(-(-nrow // rows)):
                        lo, hi = c * rows, (c + 1) * rows
                        stage = vT[brow[r0 + lo:r0 + min(hi, nrow)], cols]
                        win = srow[cur:min(cur + 32, end)]
                        cnt = int((win < hi).sum())
                        # the chunk's slots are a prefix of the window
                        assert (win[:cnt] >= lo).all()
                        assert (win[cnt:] >= hi).all()
                        for i in range(cur, cur + cnt):
                            acc = acc + sw[i] * stage[srow[i] - lo]
                        cur += cnt
                    assert cur == end
                    out[t, cols] = acc
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("N", [3, 184, 300])
def test_kernel_walk_emulated(N, dtype):
    rng = np.random.default_rng(100 + N)
    M, B = 400, 2 * 32 + 9
    tab = _tables(rng, M, B, torch.float64)
    vT = rng.normal(size=(M, N))
    ref = kernels.pvs_sweep_plain(torch.tensor(vT), tab,
                                  trade_major=True).numpy()
    got = _emulate(vT, tab, kernels.sweep_plan(N, dtype))
    assert not np.isnan(got).any()
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()


@pytest.mark.parametrize("dtype", [None, torch.float32])
def test_ladder_path_is_one_trade_major_call(dtype, monkeypatch):
    """make_per_trade_delta_fn takes its [B, N] from one trade-major K1
    call and adds the clamp rows in place: no transpose or copy after
    it (the credit book has clamp rows)."""
    mb = tc.pertrade_book("adrates_torch", "credit")
    fn = tmb.make_per_trade_delta_fn(mb, "cpu", dtype=dtype)
    seen = []
    sweep = kernels.pvs_sweep

    def watched(vT, tab, **kw):
        seen.append((kw, sweep(vT, tab, **kw)))
        return seen[-1][1]

    monkeypatch.setattr(kernels, "pvs_sweep", watched)
    lad = fn(mb.basket.quotes0)
    assert [kw for kw, _ in seen] == [{"trade_major": True}]
    assert lad.data_ptr() == seen[0][1].data_ptr()
    assert lad.shape == (mb.n_trades, mb.basket.n_quotes)
    assert torch.equal(fn.contract(*fn.prep(mb.basket.quotes0)), lad)
