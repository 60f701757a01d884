"""The CUDA kernels against their plain twins, on the card.

Marked ``cuda``: every test skips (inside its fixture) where no CUDA
device is visible. On a machine with a card and without JAX, run

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels_cuda.py

(``--noconftest`` because the suite's conftest configures JAX).
"""

import dataclasses

import numpy as np
import pytest
import torch

import torch_cases as cases
from adrates_torch.ops import kernels
from adrates_torch.parallel import multibook as tmb

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _rel_err(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _flat_tables(rng, M, B, shapes, dev):
    """K1's tables from random padded buckets (dead slots, repeated
    columns), on ``dev``."""
    t, c, w = [], [], []
    for R, L in shapes:
        ci = rng.integers(0, M, (R, L))
        ci[:, 1:] = np.where(rng.random((R, L - 1)) < 0.3, ci[:, :1],
                             ci[:, 1:])
        wi = rng.normal(size=(R, L))
        wi[rng.random((R, L)) < 0.2] = 0.0
        t.append(np.repeat(rng.integers(0, B, R), L))
        c.append(ci.ravel())
        w.append(wi.ravel())
    return kernels.sweep_tables(
        *(torch.tensor(np.concatenate(x), device=dev) for x in (t, c, w)),
        B, M)


@pytest.mark.parametrize("S", [1, 33, 100])
def test_pvs_sweep_kernel_matches_plain(dev, S):
    rng = np.random.default_rng(S)
    M, B = 700, 170
    vT = torch.tensor(rng.normal(size=(M, S)), device=dev)
    tab = _flat_tables(rng, M, B, [(13, 1), (300, 9), (41, 130)], dev)
    before = kernels.pvs_sweep.launches
    got = kernels.pvs_sweep(vT, tab)
    assert kernels.pvs_sweep.launches == before + 1
    ref = kernels.pvs_sweep_plain(vT, tab)
    torch.cuda.synchronize()
    assert _rel_err(got, ref) <= 1e-12


@pytest.mark.parametrize("S", [1, 31, 32, 33, 100, 130])
def test_pvs_sweep_kernel_ragged(dev, S):
    """Scenario counts around the 32-lane and 128-scenario tiles (odd S
    takes the even-stride copy), trades that leave the last block short,
    trades with no slot, and blocks whose distinct rows span many
    stages; once more through an even-stride view."""
    rng = np.random.default_rng(200 + S)
    M, B = 3000, 64 * 7 + 5
    vT = torch.tensor(rng.normal(size=(M, S)), device=dev)
    tab = _flat_tables(rng, M, B, [(400, 3), (200, 40), (7, 300)], dev)
    ref = kernels.pvs_sweep_plain(vT, tab)
    assert int((tab.tptr[1:] == tab.tptr[:-1]).sum()) > 0
    got = kernels.pvs_sweep(vT, tab)
    buf = torch.zeros((M, S + 3 - (S + 3) % 2), dtype=torch.float64,
                      device=dev)
    buf[:, :S] = vT
    got_view = kernels.pvs_sweep(buf[:, :S], tab)
    torch.cuda.synchronize()
    assert _rel_err(got, ref) <= 1e-12
    assert _rel_err(got_view, ref) <= 1e-12


@pytest.mark.parametrize("S", [1, 3, 33, 100, 130, 184])
def test_pvs_sweep_f32_kernel_matches_plain(dev, S):
    """K1's f32 instantiation against its f32 twin (1e-5 x max|ref|: both
    sum in f32, in another order), scenario counts that leave a 16-byte
    piece short (the copy into a stride of whole pieces) included; one
    launch; f64 weights with an f32 table refused."""
    rng = np.random.default_rng(300 + S)
    M, B = 3000, 64 * 7 + 5
    vT = torch.tensor(rng.normal(size=(M, S)), dtype=torch.float32,
                      device=dev)
    tab64 = _flat_tables(rng, M, B, [(400, 3), (200, 40), (7, 300)], dev)
    tab = kernels.sweep_tables_as(tab64, torch.float32)
    before = kernels.pvs_sweep.launches
    got = kernels.pvs_sweep(vT, tab)
    assert kernels.pvs_sweep.launches == before + 1
    assert got.dtype == torch.float32
    ref = kernels.pvs_sweep_plain(vT, tab)
    torch.cuda.synchronize()
    assert _rel_err(got, ref) <= 1e-5
    with pytest.raises(TypeError):
        kernels.pvs_sweep(vT, tab64)


# trade-major (the ladders' [B, N]): around the piece and pass widths
TM_NS = [1, 3, 33, 128, 129, 184, 193, 300]
TM_TOL = {torch.float64: 1e-12, torch.float32: 1e-5}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("N", TM_NS)
def test_pvs_sweep_trade_major_kernel_matches_plain(dev, N, dtype):
    """The trade-major kernel against its plain twin (1e-12 / 1e-5 x
    max|ref|) in one launch, and bit for bit the scenario-major kernel's
    sums transposed (both one FMA chain in slot order); a last block
    short of 32 trades and trades with no slot (their rows exactly 0)."""
    rng = np.random.default_rng(400 + N)
    M, B = 3000, 64 * 7 + 5
    vT = torch.tensor(rng.normal(size=(M, N)), dtype=dtype, device=dev)
    tab = _flat_tables(rng, M, B, [(400, 3), (200, 40), (7, 300)], dev)
    tab = kernels.sweep_tables_as(tab, dtype)
    empty = tab.tptr[1:] == tab.tptr[:-1]
    assert int(empty.sum()) > 0
    before = kernels.pvs_sweep.launches
    got = kernels.pvs_sweep(vT, tab, trade_major=True)
    assert kernels.pvs_sweep.launches == before + 1
    assert got.shape == (B, N) and got.dtype == dtype
    sm = kernels.pvs_sweep(vT, tab)
    ref = kernels.pvs_sweep_plain(vT, tab, trade_major=True)
    torch.cuda.synchronize()
    assert _rel_err(got, ref) <= TM_TOL[dtype]
    assert torch.equal(got, sm.T)
    assert not got[empty].any()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("N", [1, 5, 184, 193])
def test_pvs_sweep_trade_major_kernel_ragged(dev, N, dtype):
    """Blocks whose distinct rows span many stages and trades longer
    than a window, taken once through the aligned copy (an [M, N] table
    whose rows are not whole 16-byte pieces where N is odd) and once
    through a view of a wider buffer whose stride holds whole pieces
    (taken as it is): the same sums, bit for bit."""
    rng = np.random.default_rng(500 + N)
    M, B = 5000, 32 * 5 + 31
    tab = kernels.sweep_tables_as(
        _flat_tables(rng, M, B, [(300, 2), (120, 90), (9, 500)], dev), dtype)
    vT = torch.tensor(rng.normal(size=(M, N)), dtype=dtype, device=dev)
    vec = 16 // vT.element_size()
    buf = torch.zeros((M, N + vec + (-N) % vec), dtype=dtype, device=dev)
    buf[:, :N] = vT
    view = buf[:, :N]
    assert view.stride(0) % vec == 0
    ref = kernels.pvs_sweep_plain(vT, tab, trade_major=True)
    got = kernels.pvs_sweep(vT, tab, trade_major=True)
    got_view = kernels.pvs_sweep(view, tab, trade_major=True)
    torch.cuda.synchronize()
    assert _rel_err(got, ref) <= TM_TOL[dtype]
    assert torch.equal(got, got_view)


def test_pvs_sweep_trade_major_refuses(dev):
    """f64 weights with an f32 table, a table of the wrong height and
    int64 index tables are refused before any launch."""
    rng = np.random.default_rng(7)
    tab = _flat_tables(rng, 50, 40, [(30, 4)], dev)
    vT = torch.ones((50, 184), dtype=torch.float32, device=dev)
    before = kernels.pvs_sweep.launches
    with pytest.raises(TypeError):
        kernels.pvs_sweep(vT, tab, trade_major=True)
    with pytest.raises(ValueError):
        kernels.pvs_sweep(vT[:49].double(), tab, trade_major=True)
    with pytest.raises(TypeError):
        kernels.pvs_sweep(vT.double(), dataclasses.replace(
            tab, brow=tab.brow.long()), trade_major=True)
    assert kernels.pvs_sweep.launches == before


def _groups(rng, specs, n_grid, dev):
    return [dict(s_idx=rng.integers(0, n_grid, T),
                 e_idx=rng.integers(0, n_grid, T),
                 p_idx=rng.integers(0, n_grid, T),
                 rows=np.asarray(rows), w=rng.normal(size=T))
            for rows, T in specs]


@pytest.mark.parametrize("k", [5, 16, 37])
def test_gamma_kernel_matches_plain(dev, k):
    rng = np.random.default_rng(k)
    S, N, n_grid = 3, 60, 400

    def t(a, dtype=torch.float64):
        return torch.tensor(a, dtype=dtype, device=dev)

    J = t(rng.normal(size=(S, N, n_grid)))
    dfs = t(rng.uniform(0.5, 1.0, (S, n_grid)))
    tab = kernels.quad_tables(_groups(
        rng, [(np.arange(0, k), 45),
              (np.sort(rng.choice(N, k, replace=False)), 70)], n_grid, dev),
        N, dev)
    before = kernels.gamma_quad_form_grouped.launches
    got = kernels.gamma_quad_form_grouped(J, dfs, tab)
    assert kernels.gamma_quad_form_grouped.launches == before + 2
    ref = kernels.gamma_quad_form_grouped_plain(J, dfs, tab)
    torch.cuda.synchronize()
    assert _rel_err(got, ref) <= 1e-12


@pytest.mark.parametrize("k", [1, 5, 8, 12, 16, 37, 72, 80, 96, 130])
def test_gamma_kernel_ragged(dev, k):
    """Group widths off and on the 8-row tile and past one work item
    (96 and 130 rows run as chunk pairs), trip counts off the 16-trip
    tile, an empty group, and scenario counts around 32 and 128, with
    groups that overlap; rows in no group stay exactly zero."""
    rng = np.random.default_rng(300 + k)
    N, n_grid = 140, 500
    rows = np.sort(rng.choice(N - 4, k, replace=False))
    specs = [(rows, 37), (rows[: max(1, k // 2)], 0),
             (np.concatenate([rows[: max(1, k // 3)], [N - 3, N - 2]]), 1),
             (np.array([N - 2]), 17)]
    tab = kernels.quad_tables(_groups(rng, specs, n_grid, dev), N, dev)
    for S in (1, 31, 32, 33, 100, 130):
        J = torch.tensor(rng.normal(size=(S, N, n_grid)), device=dev)
        dfs = torch.tensor(rng.uniform(0.5, 1.0, (S, n_grid)), device=dev)
        got = kernels.gamma_quad_form_grouped(J, dfs, tab)
        ref = kernels.gamma_quad_form_grouped_plain(J, dfs, tab)
        torch.cuda.synchronize()
        assert _rel_err(got, ref) <= 1e-12, S
        assert float(got[:, N - 1].abs().max()) == 0.0


def test_wrappers_refuse_wrong_index_dtype(dev):
    vT = torch.ones((4, 2), dtype=torch.float64, device=dev)
    tab = kernels.sweep_tables(torch.zeros(1, dtype=torch.int64, device=dev),
                               torch.zeros(1, dtype=torch.int64, device=dev),
                               torch.ones(1, dtype=torch.float64, device=dev),
                               1, 4)
    bad = dataclasses.replace(tab, tptr=tab.tptr.long())
    with pytest.raises(TypeError):
        kernels.pvs_sweep(vT, bad)
    with pytest.raises(ValueError):
        kernels.pvs_sweep(vT[:3], tab)
    qt = kernels.quad_tables([dict(
        s_idx=np.zeros(1), e_idx=np.zeros(1), p_idx=np.zeros(1),
        rows=np.arange(3), w=np.ones(1))], 3, dev)
    J = torch.ones((1, 3, 1), dtype=torch.float64, device=dev)
    dfs = torch.ones((1, 1), dtype=J.dtype, device=dev)
    with pytest.raises(TypeError):
        kernels.gamma_quad_form_grouped(
            J, dfs, dataclasses.replace(qt, items=qt.items.long()))
    with pytest.raises(ValueError):
        kernels.gamma_quad_form_grouped(J[:, :2], dfs, qt)


def test_slice_on_cuda_matches_cpu(dev):
    model = cases.build_model("adrates_torch")
    _, mb = cases.compile_book("adrates_torch", model)
    q0 = mb.basket.quotes0
    sh = cases.shocks(mb.basket.n_quotes)
    ref = tmb.make_multibook_fn(mb, device="cpu")(q0, sh)
    before = (kernels.pvs_sweep.launches,
              kernels.gamma_quad_form_grouped.launches)
    out = tmb.make_multibook_fn(mb, device=dev)(q0, sh)
    torch.cuda.synchronize()
    assert kernels.pvs_sweep.launches > before[0]
    assert kernels.gamma_quad_form_grouped.launches > before[1]
    for key in ("pvs", "delta", "gamma"):
        assert _rel_err(out[key].cpu(), ref[key]) <= 1e-12, key


@pytest.mark.parametrize("S", [1, 7])
def test_gamma_kernel_overlapping_group_rows(dev, S):
    """Groups that share quote rows (as XCCY groups share their parents')
    sum into the same entries in the fixed group order: the kernel
    against the twin; rows in no group stay exactly zero."""
    rng = np.random.default_rng(100 + S)
    N, n_grid = 50, 300

    def t(a, dtype=torch.float64):
        return torch.tensor(a, dtype=dtype, device=dev)

    J = t(rng.normal(size=(S, N, n_grid)))
    dfs = t(rng.uniform(0.5, 1.0, (S, n_grid)))
    usd = np.arange(20, 40)
    tab = kernels.quad_tables(_groups(
        rng, [(np.concatenate([np.arange(0, 12), usd]), 41),
              (np.concatenate([usd, np.arange(44, 50)]), 77), (usd, 33)],
        n_grid, dev), N, dev)
    got = kernels.gamma_quad_form_grouped(J, dfs, tab)
    ref = kernels.gamma_quad_form_grouped_plain(J, dfs, tab)
    again = kernels.gamma_quad_form_grouped(J, dfs, tab)
    torch.cuda.synchronize()
    assert _rel_err(got, ref) <= 1e-12
    assert float(got[:, 12:20].abs().max()) == 0.0
    assert torch.equal(got, again)


def test_xccy_book_on_cuda_matches_cpu(dev):
    """The OIS + XCCY book (XCCY curves, basis swaps, foreign collateral)
    through make_multibook_fn and make_staged_multibook_fn on the card
    against the CPU run."""
    model = cases.build_xccy_model("adrates_torch")
    mb = cases.compile_xccy_book("adrates_torch", model)
    q0 = mb.basket.quotes0
    sh = cases.shocks(mb.basket.n_quotes)
    ref = tmb.make_multibook_fn(mb, device="cpu")(q0, sh)
    for make in (tmb.make_multibook_fn, tmb.make_staged_multibook_fn):
        before = (kernels.pvs_sweep.launches,
                  kernels.gamma_quad_form_grouped.launches)
        out = make(mb, dev)(q0, sh)
        torch.cuda.synchronize()
        for key in ("pvs", "delta", "gamma"):
            assert _rel_err(out[key].cpu(), ref[key]) <= 1e-12, key
        # one sweep and one chunk of term 1 (groups, then the sum)
        assert kernels.pvs_sweep.launches == before[0] + 1
        assert kernels.gamma_quad_form_grouped.launches == before[1] + 2


def test_all_kinds_book_on_cuda_matches_cpu(dev):
    """A book of every instrument kind (OIS, basis, fix-float and fix-fix
    XCCY, FRNs with clamp slots, a bond, ZCIS and YoY on an inflation
    curve), tiled x2, through make_multibook_fn and
    make_staged_multibook_fn on the card against the CPU run."""
    from adrates_torch.utils import CurrencyTypes
    model = cases.build_all_kinds_model("adrates_torch")
    _, mb = cases.compile_tiled(
        "adrates_torch", model, cases.all_kinds_trades("adrates_torch",
                                                       model),
        base_currency=CurrencyTypes.USD)
    assert mb.clamp is not None
    assert [st.kind for st in mb.basket.stages] == ["ois", "xccy", "infl"]
    q0 = mb.basket.quotes0
    sh = cases.shocks(mb.basket.n_quotes)
    ref = tmb.make_multibook_fn(mb, device="cpu")(q0, sh)
    for make in (tmb.make_multibook_fn, tmb.make_staged_multibook_fn):
        before = (kernels.pvs_sweep.launches,
                  kernels.gamma_quad_form_grouped.launches)
        out = make(mb, dev)(q0, sh)
        torch.cuda.synchronize()
        for key in ("pvs", "delta", "gamma"):
            assert _rel_err(out[key].cpu(), ref[key]) <= 1e-12, key
        assert kernels.pvs_sweep.launches == before[0] + 1
        assert kernels.gamma_quad_form_grouped.launches == before[1] + 2


def _k3_tables(rng, ks, n_items, n_slots, n_grid, dev):
    """K3's tables over groups of widths ``ks`` (random quote rows of
    N = 184) with random slots; of several items, the first has none."""
    N = 184
    n_all = sum(n_items)
    item = rng.integers(min(1, n_all - 1), n_all, n_slots)
    s, e, p = rng.integers(0, n_grid, (3, n_slots))
    rows = [np.sort(rng.choice(N, k, replace=False)) for k in ks]
    return kernels.pertrade_tables(rows, n_items, item, s, e, p, dev)


def _k3_operands(rng, tab, n_grid, dev):
    n_slots = tab.order.shape[0]
    return (torch.tensor(rng.normal(size=(n_grid, 184)), device=dev),
            torch.tensor(rng.uniform(0.5, 1.0, n_grid), device=dev),
            torch.tensor(rng.normal(size=n_slots), device=dev))


@pytest.mark.parametrize("n_items", [1, 37])
@pytest.mark.parametrize("k", [1, 7, 8, 9, 12, 40, 71, 72, 73, 97, 184])
def test_pertrade_kernel_matches_plain(dev, k, n_items):
    """Widths on and off the 8-row tile, at and past the packing sizes,
    and the widest item one block takes whole (k = 184); one item, or 37
    packed."""
    rng = np.random.default_rng(400 + k + n_items)
    n_grid, n_slots = 500, 60 * n_items
    tab = _k3_tables(rng, [k], [n_items], n_slots, n_grid, dev)
    Jt, dfs, w = _k3_operands(rng, tab, n_grid, dev)
    before = kernels.pertrade_quad_form.launches
    got = kernels.pertrade_quad_form(Jt, dfs, w, tab)
    assert kernels.pertrade_quad_form.launches == before + 1
    ref = kernels.pertrade_quad_form_plain(Jt, dfs, w, tab)
    torch.cuda.synchronize()
    assert _rel_err(got[0], ref[0]) <= 1e-12
    assert torch.equal(got[0], got[0].transpose(1, 2))


@pytest.mark.parametrize("per_item", [1, 15, 16, 17, 31, 32, 33])
@pytest.mark.parametrize("k", [40, 184])
def test_pertrade_kernel_segments(dev, k, per_item):
    """Items of exactly ``per_item`` slots, on both sides of one and two
    16-slot segments, beside an item with none."""
    rng = np.random.default_rng(600 + k + per_item)
    n_grid, n_items = 300, 5
    item = np.repeat(np.arange(1, n_items), per_item)
    s, e, p = rng.integers(0, n_grid, (3, item.shape[0]))
    tab = kernels.pertrade_tables([np.sort(rng.choice(184, k,
                                                      replace=False))],
                                  [n_items], item, s, e, p, dev)
    Jt, dfs, w = _k3_operands(rng, tab, n_grid, dev)
    got = kernels.pertrade_quad_form(Jt, dfs, w, tab)[0]
    ref = kernels.pertrade_quad_form_plain(Jt, dfs, w, tab)[0]
    torch.cuda.synchronize()
    assert _rel_err(got, ref) <= 1e-12
    assert torch.equal(got, got.transpose(1, 2))
    assert float(got[0].abs().max()) == 0.0


def test_pertrade_kernel_is_one_kernel(dev):
    """A K3 call puts exactly one kernel into a torch.profiler trace: the
    weights are read through ``order`` by the kernel, not gathered by a
    launch of their own."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(700)
    tab = _k3_tables(rng, [12, 72, 184], [9, 3, 2], 400, 300, dev)
    Jt, dfs, w = _k3_operands(rng, tab, 300, dev)
    kernels.pertrade_quad_form(Jt, dfs, w, tab)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        kernels.pertrade_quad_form(Jt, dfs, w, tab)
        torch.cuda.synchronize()
    ks = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert len(ks) == 1 and "pertrade_quad" in ks[0], ks


def test_pertrade_kernel_ragged_groups(dev):
    """Groups of ragged widths (packed several to a block, and one at
    k = 184) in one launch, items with no slot (exact zeros), slot counts
    around the 16-slot segment; wider items run as chunk pairs."""
    rng = np.random.default_rng(500)
    ks, n_items = [1, 31, 32, 33, 64, 65, 184], [3, 2, 1, 4, 2, 2, 1]
    n_grid = 400
    tab = _k3_tables(rng, ks, n_items, 31 * 4 + 33, n_grid, dev)
    Jt = torch.tensor(rng.normal(size=(n_grid, 184)), device=dev)
    dfs = torch.tensor(rng.uniform(0.5, 1.0, n_grid), device=dev)
    w = torch.tensor(rng.normal(size=31 * 4 + 33), device=dev)
    got = kernels.pertrade_quad_form(Jt, dfs, w, tab)
    ref = kernels.pertrade_quad_form_plain(Jt, dfs, w, tab)
    torch.cuda.synchronize()
    empty = np.diff(tab.iptr.cpu().numpy()) == 0
    assert empty.any()
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert _rel_err(g, r) <= 1e-12
        assert torch.equal(g, g.transpose(1, 2))
    flat = torch.cat([g.reshape(g.shape[0], -1).abs().amax(1) for g in got])
    assert float(flat[torch.tensor(empty, device=dev)].max()) == 0.0


@pytest.mark.parametrize("k", [185, 192, 300])
def test_pertrade_kernel_wide_items(dev, k):
    """Items wider than one block takes whole run as pairs of 96-row
    chunks, beside packed small items."""
    rng = np.random.default_rng(800 + k)
    N, n_grid, n_slots = 320, 300, 150
    item = rng.integers(0, 6, n_slots)
    s, e, p = rng.integers(0, n_grid, (3, n_slots))
    rows = [np.sort(rng.choice(N, kk, replace=False)) for kk in (k, 12)]
    tab = kernels.pertrade_tables(rows, [2, 4], item, s, e, p, dev)
    assert int((tab.units[:, 4] > 0).sum()) > 0
    Jt = torch.tensor(rng.normal(size=(n_grid, N)), device=dev)
    dfs = torch.tensor(rng.uniform(0.5, 1.0, n_grid), device=dev)
    w = torch.tensor(rng.normal(size=n_slots), device=dev)
    got = kernels.pertrade_quad_form(Jt, dfs, w, tab)
    ref = kernels.pertrade_quad_form_plain(Jt, dfs, w, tab)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert _rel_err(g, r) <= 1e-12
        assert torch.equal(g, g.transpose(1, 2))


def test_per_trade_paths_on_cuda_match_cpu(dev):
    """The all-kinds book (clamp slots, XCCY, inflation), tiled x2: the
    ladders through K1, the selected gammas and the blocks through K3,
    on the card against the CPU run."""
    from adrates_torch.parallel import pertrade_blocks as tpb
    from adrates_torch.utils import CurrencyTypes
    model = cases.build_all_kinds_model("adrates_torch")
    _, mb = cases.compile_tiled(
        "adrates_torch", model, cases.all_kinds_trades("adrates_torch",
                                                       model),
        base_currency=CurrencyTypes.USD)
    q0 = mb.basket.quotes0
    sel = [int(mb.clamp.slot_trade[0]), 0, mb.n_trades - 1]
    k1, k3 = kernels.pvs_sweep.launches, kernels.pertrade_quad_form.launches
    lad = tmb.make_per_trade_delta_fn(mb, dev)(q0)
    gam = tmb.make_per_trade_gamma_fn(mb, sel, dev)(q0)
    blk = tpb.make_per_trade_gamma_blocks_fn(mb, dev)(q0)
    torch.cuda.synchronize()
    assert kernels.pvs_sweep.launches == k1 + 1
    assert kernels.pertrade_quad_form.launches == k3 + 2
    assert _rel_err(lad.cpu(), tmb.make_per_trade_delta_fn(mb, "cpu")(q0)) \
        <= 1e-12
    assert _rel_err(gam.cpu(), tmb.make_per_trade_gamma_fn(
        mb, sel, "cpu")(q0)) <= 1e-12
    for g, r in zip(blk, tpb.make_per_trade_gamma_blocks_fn(mb, "cpu")(q0)):
        assert _rel_err(g.blocks.cpu(), r.blocks) <= 1e-12


@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("P", [1, 2, 72, 300])
@pytest.mark.parametrize("R", [1, 3, 33, 4097])
def test_pv01_solve_kernels_match_plain(dev, R, P, G):
    """K4 equals its plain K-sweep bit for bit; K5 its child-table sweep
    within 1e-14 x max|ref| (it adds a point's children in another
    order). With G = 3 plans, R x 3 rows, row r on plan row r mod 3."""
    rng = np.random.default_rng(1000 * P + 10 * R + G)
    prev, ci, cm, depth = cases.chain_forest(rng, P, G=G,
                                             pad=2 if P > 2 else 0)
    tab = kernels.chain_tables(prev, ci, cm, depth, dev)
    rows = R * G
    b = torch.tensor(rng.normal(size=(rows, P)), device=dev)
    d = torch.tensor(1.0 + rng.uniform(0.01, 0.5, size=(rows, P)),
                     device=dev)
    before = (kernels.pv01_solve.launches, kernels.pv01_solve_t.launches)
    x = kernels.pv01_solve(b, d, tab)
    y = kernels.pv01_solve_t(b, d, tab)
    assert (kernels.pv01_solve.launches,
            kernels.pv01_solve_t.launches) == (before[0] + 1, before[1] + 1)
    x_ref = kernels.pv01_solve_plain(b, d, tab)
    y_ref = kernels.pv01_solve_t_plain(b, d, tab)
    torch.cuda.synchronize()
    assert torch.equal(x, x_ref)
    assert _rel_err(y, y_ref) <= 1e-14


def _solve_both(dev, kind, R, b, d):
    """K4 and K5 (one launch each) and their plain versions on
    ``torch_cases.chain_edge_plan(kind)``, R rows a plan."""
    tab = kernels.chain_tables(*cases.chain_edge_plan(kind), dev)
    G = tab.prev.shape[0]
    b = torch.tensor(b(R * G), device=dev)
    d = torch.tensor(d(R * G), device=dev)
    before = (kernels.pv01_solve.launches, kernels.pv01_solve_t.launches)
    x = kernels.pv01_solve(b, d, tab)
    y = kernels.pv01_solve_t(b, d, tab)
    assert (kernels.pv01_solve.launches,
            kernels.pv01_solve_t.launches) == (before[0] + 1, before[1] + 1)
    x_ref = kernels.pv01_solve_plain(b, d, tab)
    y_ref = kernels.pv01_solve_t_plain(b, d, tab)
    torch.cuda.synchronize()
    return x, x_ref, y, y_ref


@pytest.mark.parametrize("kind, R", [("padded_stack", 1600),
                                     ("one_chain", 33), ("interleaved", 33)])
def test_pv01_solve_kernels_match_plain_on_edge_plans(dev, kind, R):
    """K4 and K5 bit for bit on plans where no point has two children:
    region A's shape (flagship_v5's OIS stage, G = 7 padded plans, 1,600
    rows each: [11,200, 72]), one chain of 72 (every link the point just
    before) and two interleaved chains (none)."""
    rng = np.random.default_rng(R + len(kind))
    x, x_ref, y, y_ref = _solve_both(
        dev, kind, R, lambda n: rng.normal(size=(n, 72)),
        lambda n: 1.0 + rng.uniform(0.01, 0.5, size=(n, 72)))
    assert torch.equal(x, x_ref)
    assert _rel_err(y, y_ref) <= 1e-14
    assert torch.equal(y, y_ref)


@pytest.mark.parametrize("kind", ["padded_stack", "one_chain"])
def test_pv01_solve_kernels_exact_outside_the_fast_range(dev, kind):
    """Values for which the kernels' split division must fall back to the
    IEEE v / d (zeros of either sign, denormals and magnitudes beyond
    2^+-400 in b, beyond 2^400 in d) among ordinary ones: K4 and K5 still
    equal their plain versions."""
    rng = np.random.default_rng(len(kind))

    def b(n):
        v = rng.normal(size=(n, 72))
        m = rng.random(v.shape) < 0.15
        v[m] = rng.choice([0.0, -0.0, 1e-310, -1e-150, 1e-125, 1e150,
                           -1e130], m.sum())
        return v

    def d(n):
        v = 1.0 + rng.uniform(0.01, 0.5, size=(n, 72))
        m = rng.random(v.shape) < 0.05
        v[m] = rng.choice([1e150, 2e125], m.sum())
        return v

    x, x_ref, y, y_ref = _solve_both(dev, kind, 9, b, d)
    assert torch.equal(x, x_ref)
    assert torch.equal(y, y_ref)


def test_bootstrap_tower_on_cuda_matches_cpu(dev):
    """bootstrap_ois's value, jacobian, Hessian and third order on the
    card (K4 and K5 under every level) equal the CPU's plain sweeps."""
    from torch.func import jacfwd, jacrev

    from adrates_torch.models import Model
    from adrates_torch.ops import bootstrap as tboot
    from adrates_torch.utils import Date, DayCountTypes
    m = Model(Date(1, 1, 2024))
    c = m.build_curve("GBP_OIS_SONIA", px_list=[5.0, 4.7, 4.3, 3.9, 3.87],
                      tenor_list=["6M", "1Y", "2Y", "5Y", "10Y"],
                      fixed_dcc_type=DayCountTypes.ACT_365F,
                      float_dc_type=DayCountTypes.ACT_365F)
    w = np.random.default_rng(8).normal(size=c._plan.point_times.shape[0]
                                        + 1)
    r = np.array([5.0, 4.7, 4.3, 3.9, 3.87]) / 100.0

    def orders(device):
        plan = tboot.plan_to_torch(c._plan, device)
        wt = torch.tensor(w, device=device)

        def pv(x):
            return torch.dot(wt, tboot.bootstrap_ois(x, plan)[1])

        x = torch.tensor(r, device=device)
        return [pv(x), jacrev(pv)(x), jacfwd(jacrev(pv))(x),
                jacfwd(jacrev(jacrev(pv)))(x)]

    before = (kernels.pv01_solve.launches, kernels.pv01_solve_t.launches)
    got = orders(dev)
    torch.cuda.synchronize()
    # 1 + 1 + 2 + 4 forward solves, 0 + 1 + 2 + 4 transpose solves
    assert kernels.pv01_solve.launches - before[0] == 8
    assert kernels.pv01_solve_t.launches - before[1] == 7
    for g, ref in zip(got, orders("cpu")):
        assert _rel_err(g.cpu(), ref) <= 1e-12


# ---------------------------------------------------------------------------
# K6 / K7: the fitted rows and their transpose
# ---------------------------------------------------------------------------

_FIT_SCHEMES = ("PCHIP_LOG_DISCOUNT", "PCHIP_ZERO_RATES",
                "NATCUBIC_LOG_DISCOUNT", "NATCUBIC_ZERO_RATES",
                "FINCUBIC_ZERO_RATES")


def _fit_plans(rng, schemes, ns, ws):
    """Host fitted plans of the given schemes, knot and query counts (a
    t = 0 node on every other member; queries before, between and past
    the knots)."""
    from adrates_torch.ops.interpolation import fitted_interp_plan
    from adrates_torch.utils.global_types import InterpTypes
    plans = []
    for g, (s, n, w) in enumerate(zip(schemes, ns, ws)):
        x0 = 0.0 if g % 2 == 0 else rng.uniform(0.02, 0.3)
        x = x0 + np.concatenate([[0.0], np.cumsum(rng.uniform(0.02, 2.0,
                                                              n - 1))])
        q = rng.uniform(x[0] - 0.1, x[-1] + 3.0, w)
        plans.append(fitted_interp_plan(q, x, InterpTypes[s]))
    return plans


def _fit_both(dev, plans, R, seed):
    """K6 and K7 (one launch each) and their twins on random X and
    U-bar of R rows."""
    from adrates_torch.ops.fitted_rows import fitted_plan
    rng = np.random.default_rng(seed)
    tab = fitted_plan(plans, dev).tables
    X = torch.tensor(rng.normal(size=(R, tab.G, tab.K, tab.n_max)),
                     device=dev)
    Ub = torch.tensor(rng.normal(size=(R, tab.G, tab.W_max)), device=dev)
    before = (kernels.fitted_rows.launches, kernels.fitted_rows_t.launches)
    U = kernels.fitted_rows(X, tab)
    Xb = kernels.fitted_rows_t(Ub, tab)
    assert (kernels.fitted_rows.launches,
            kernels.fitted_rows_t.launches) == (before[0] + 1, before[1] + 1)
    U_ref = kernels.fitted_rows_plain(X, tab)
    Xb_ref = kernels.fitted_rows_t_plain(Ub, tab)
    torch.cuda.synchronize()
    return U, U_ref, Xb, Xb_ref


def test_fitted_rows_kernels_at_the_spline_cell(dev):
    """The spline cell's OIS stage (flagship_v5 on SPLINE_SCHEMES): its
    five fitted members (AUD, EUR, GBP, JPY, USD: 43, 73, 73, 43 and 73
    knots) at the keep-compact rows (2,225 queries) of region A's 1,600
    rows (50 scenarios x 32 quote seeds), within 1e-12 x max|ref|."""
    rng = np.random.default_rng(73)
    plans = _fit_plans(rng, ("FINCUBIC_ZERO_RATES", "NATCUBIC_LOG_DISCOUNT",
                             "PCHIP_LOG_DISCOUNT", "NATCUBIC_ZERO_RATES",
                             "PCHIP_ZERO_RATES"),
                       (43, 73, 73, 43, 73), (2225,) * 5)
    U, U_ref, Xb, Xb_ref = _fit_both(dev, plans, 1600, 1)
    assert _rel_err(U, U_ref) <= 1e-12
    assert _rel_err(Xb, Xb_ref) <= 1e-12


@pytest.mark.parametrize("R", [1, 7, 33, 100])
@pytest.mark.parametrize("case", ["ragged", "short", "wide", "one"])
def test_fitted_rows_kernels_ragged(dev, case, R):
    """Knot counts from 2 to 97 (a tile of 32 rows past 48 KB of shared
    memory), query counts from 0 (a member with none) and 1, one member
    alone, and 257 knots (tiles of fewer rows); pad queries are 0."""
    ns, ws = {"ragged": ((2, 97, 12, 43, 3), (1, 300, 0, 17, 5)),
              "short": ((2, 3, 2, 3, 2), (1, 2, 3, 0, 9)),
              "wide": ((257, 5, 190, 2, 73), (40, 1, 500, 2, 64)),
              "one": ((73,), (130,))}[case]
    rng = np.random.default_rng(R + len(case))
    schemes = [_FIT_SCHEMES[(g + R) % 5] for g in range(len(ns))]
    U, U_ref, Xb, Xb_ref = _fit_both(dev, _fit_plans(rng, schemes, ns, ws),
                                     R, R)
    assert _rel_err(U, U_ref) <= 1e-12
    assert _rel_err(Xb, Xb_ref) <= 1e-12
    for g, w in enumerate(ws):
        assert not U[:, g, w:].any()


def test_fitted_rows_cuda_never_runs_a_twin(dev, monkeypatch):
    """On CUDA tensors the wrappers launch (the counts move) and never
    call a twin, and the Function's AD tower on the card equals the CPU's
    twins: one K6 / K7 launch per evaluation."""
    from torch.func import jacfwd, jacrev

    from adrates_torch.ops.fitted_rows import fitted_eval, fitted_plan
    rng = np.random.default_rng(5)
    plans = _fit_plans(rng, _FIT_SCHEMES, (12, 73, 2, 43, 3),
                       (40, 40, 40, 40, 40))
    rows = np.exp(-0.03 * np.sort(rng.uniform(0, 30, (5, 76)), axis=1))

    def tower(device):
        tab = fitted_plan(plans, device)
        d = torch.tensor(rows, device=device)

        def f(v):
            return fitted_eval(tab, v)
        return [f(d), jacrev(f)(d), jacfwd(jacrev(f))(d)]

    ref = tower("cpu")

    def refuse(*a):
        raise AssertionError("a twin ran on a CUDA tensor")
    from adrates_torch.ops import fitted_rows as tfr
    monkeypatch.setattr(kernels, "fitted_rows_plain", refuse)
    monkeypatch.setattr(kernels, "fitted_rows_t_plain", refuse)
    monkeypatch.setattr(tfr, "fitted_eval_plain", refuse)
    monkeypatch.setattr(tfr, "fitted_eval_jvp_plain", refuse)
    names = ("fitted_eval", "fitted_eval_jvp", "fitted_rows", "fitted_rows_t")
    before = [getattr(kernels, k).launches for k in names]
    got = tower(dev)
    torch.cuda.synchronize()
    # value: K6; jacrev: K6, then K7; jacfwd(jacrev): K6 and its tangent
    # mode, the transpose and its jvp (K7 twice)
    assert [getattr(kernels, k).launches - b
            for k, b in zip(names, before)] == [3, 1, 0, 3]
    for g, r in zip(got, ref):
        assert _rel_err(g.cpu(), r) <= 1e-12


def _eval_plans(rng, schemes, ns, ws, runs=1, reach=2.0):
    """Host fitted plans for K6's evaluation: knots 0.25-2 apart (from 0
    on every other member), queries from just before the first knot to
    ``reach`` last intervals past the last (two by default: a cubic's
    extrapolation far past a short last interval overflows exp on noisy
    DFs), in ``runs`` sorted runs."""
    from adrates_torch.ops.interpolation import fitted_interp_plan
    from adrates_torch.utils.global_types import InterpTypes
    plans = []
    for g, (s, n, w) in enumerate(zip(schemes, ns, ws)):
        x0 = 0.0 if g % 2 == 0 else rng.uniform(0.02, 0.3)
        x = x0 + np.concatenate([[0.0], np.cumsum(rng.uniform(0.25, 2.0,
                                                              n - 1))])
        hi = x[-1] + reach * (x[-1] - x[-2])
        q = np.concatenate([np.sort(rng.uniform(x[0] - 0.05, hi, w // runs))
                            for _ in range(runs)] + [x[:w % runs]])
        plans.append(fitted_interp_plan(q, x, InterpTypes[s]))
    return plans


def _eval_twice(dev, plans, R, D, seed, noise=2e-3):
    """K6 ``fitted_eval`` and its tangent mode, each launched twice on
    seeded DFs [R, G, L] (an upward zero curve with uniform noise of
    +-``noise`` in the rates, pads 0.5) and tangents [R, D, G, L] (the
    launches counted), and their plain versions."""
    from adrates_torch.ops import fitted_rows as tfr
    plan = tfr.fitted_plan(plans, dev)
    tab = plan.tables
    rng = np.random.default_rng(seed)
    x = tab.host["x"]
    L = tab.n_max + 2
    r = 0.02 + 0.01 * np.sqrt(np.abs(x)) \
        + rng.uniform(-noise, noise, (R,) + x.shape)
    d = np.full((R, tab.G, L), 0.5)
    d[..., :tab.n_max] = np.exp(-r * x)
    dfs = torch.tensor(d, device=dev)
    ddfs = torch.tensor(rng.normal(size=(R, D, tab.G, L)), device=dev)
    before = (kernels.fitted_eval.launches, kernels.fitted_eval_jvp.launches)
    out = [kernels.fitted_eval(dfs, plan) for _ in range(2)]
    dout = [kernels.fitted_eval_jvp(dfs, ddfs, out[0], plan)
            for _ in range(2)]
    assert (kernels.fitted_eval.launches,
            kernels.fitted_eval_jvp.launches) == (before[0] + 2,
                                                  before[1] + 2)
    ref = tfr.fitted_eval_plain(plan, dfs)
    dref = tfr.fitted_eval_jvp_plain(plan, dfs, ddfs, ref)
    torch.cuda.synchronize()
    return out, ref, dout, dref


def _eval_check(out, ref, dout, dref):
    assert _rel_err(out[0], ref) <= 1e-12
    assert _rel_err(dout[0], dref) <= 1e-12
    assert torch.equal(out[0], out[1]) and torch.equal(dout[0], dout[1])


_SPLINE_CELL = (("FINCUBIC_ZERO_RATES", "NATCUBIC_LOG_DISCOUNT",
                 "PCHIP_LOG_DISCOUNT", "NATCUBIC_ZERO_RATES",
                 "PCHIP_ZERO_RATES"), (43, 73, 73, 43, 73))


@pytest.mark.parametrize("call", ["A", "C1", "gamma_256"])
def test_fitted_eval_at_the_phase8_shapes(dev, call):
    """K6 ``fitted_eval`` and its tangent mode at chip_smoke phase 8's
    calls: region A's (the spline cell's five fitted members, 43 and 73
    knots, 2,225 queries; 50 scenarios x 32 quote seeds), region C1's (a
    joint legs plan on 73 knots, two sorted runs of 372 queries; 48
    directions) and the 256 gammas' (4,337 queries, one primal row,
    1,024 directions); within 1e-12 x max|ref| of the plain versions,
    two launches bit for bit."""
    rng = np.random.default_rng(20)
    if call == "C1":
        plans = _eval_plans(rng, ("PCHIP_ZERO_RATES",), (73,), (744,), 2)
        R, D = 50, 48
    else:
        W, R, D = (2225, 50, 32) if call == "A" else (4337, 1, 1024)
        plans = _eval_plans(rng, _SPLINE_CELL[0], _SPLINE_CELL[1], (W,) * 5)
    _eval_check(*_eval_twice(dev, plans, R, D, 21))


# the farthest any static fitted plan of the spline cell or the engine
# reaches past its member's last knot, in last intervals: the 43-knot OIS
# members (last knot 40.03, last interval 1 year) queried to 51.54 years
# by the 256 gammas' rows and to 50.83 by region A's (chip_smoke phase 7d
# prints it)
CELL_REACH = 11.511


@pytest.mark.parametrize("reach, noise", [(CELL_REACH, 2e-3), (30.0, 0.0)],
                         ids=["cell", "far"])
@pytest.mark.parametrize("call", ["A", "gamma_256"])
def test_fitted_eval_past_the_last_knot(dev, call, reach, noise):
    """K6 ``fitted_eval`` and its tangent mode at the spline cell's
    members (43 and 73 knots, region A's and the 256 gammas' shapes) with
    queries to the farthest reach of the cell's plans past the last knot
    (on the noisy DFs of the other cases), and to 30 last intervals, the
    reach of this file's first generator, on a smooth zero curve, where
    exp stays finite; within 1e-12 x max|ref| of the plain versions, two
    launches bit for bit. A cubic's extrapolation multiplies a rounding
    difference by up to reach^3, so the kernel takes the spline's solve
    and rows in the plain version's order of operations."""
    rng = np.random.default_rng(22)
    W, R, D = (2225, 50, 32) if call == "A" else (4337, 1, 1024)
    plans = _eval_plans(rng, _SPLINE_CELL[0], _SPLINE_CELL[1], (W,) * 5,
                        reach=reach)
    out, ref, dout, dref = _eval_twice(dev, plans, R, D, 23, noise)
    assert bool(torch.isfinite(ref).all() and torch.isfinite(dref).all())
    _eval_check(out, ref, dout, dref)


@pytest.mark.parametrize("R, D", [(1, 1), (3, 5), (7, 130), (100, 2)])
@pytest.mark.parametrize("case", ["ragged", "short", "wide", "one"])
def test_fitted_eval_ragged(dev, case, R, D):
    """K6 ``fitted_eval`` and its tangent mode on knot counts from 2 to
    257 (tiles of fewer rows, 130 directions cut into tiles), query
    counts from 0 and 1, one member alone, and R G below one block an SM;
    pad queries 1 (values) and 0 (tangents)."""
    ns, ws = {"ragged": ((2, 97, 12, 43, 3), (1, 300, 0, 17, 5)),
              "short": ((2, 3, 2, 3, 2), (1, 2, 3, 0, 9)),
              "wide": ((257, 5, 190, 2, 73), (40, 1, 500, 2, 64)),
              "one": ((73,), (130,))}[case]
    rng = np.random.default_rng(R + D + len(case))
    schemes = [_FIT_SCHEMES[(g + R) % 5] for g in range(len(ns))]
    out, ref, dout, dref = _eval_twice(
        dev, _eval_plans(rng, schemes, ns, ws), R, D, R)
    _eval_check(out, ref, dout, dref)
    for g, w in enumerate(ws):
        assert bool((out[0][:, g, w:] == 1.0).all())
        assert not dout[0][:, :, g, w:].any()


def test_fitted_kernels_no_local_memory(dev):
    """K6's three entries (the linear map, the evaluation, its tangent
    mode) keep nothing in local memory and fit two blocks of 256 threads
    an SM; their tiles give every SM a block at region C1's [2,400, 1]
    (73 knots, 234 queries), with the tables in shared memory; so do the
    tangent mode's at C1's tangent call (50 rows x 32 directions, 744
    queries: 200 tiles of 8 directions) and A's 50 rows x 32 directions
    of 5 members (2,225 queries: on to two blocks an SM, 500 tiles of
    16); the evaluation's one-row tiles at C1's primal call [50, 1] (744
    queries) and the 256 gammas' [1, 5] (4,337 queries) are cut into query
    tiles (multiples of 32) until every SM has a block, and so is the
    gammas' tangent call (1 row x 1,024 directions) where its direction
    tiles do not fill the card."""
    for mode in kernels.FIT_MODES:
        c1 = kernels.fitted_kernel_info(mode, 2400, 1, 73, 234, D=48)
        assert c1["local_bytes"] == 0 and c1["registers"] <= 128, c1
        assert c1["blocks"] >= 132 and c1["staged"], c1
    c1t = kernels.fitted_kernel_info("tangent", 50, 1, 73, 744, D=32)
    a = kernels.fitted_kernel_info("tangent", 50, 5, 73, 2225, D=32)
    assert a["staged"] and c1t["staged"], (a, c1t)
    assert (a["blocks"], a["tile_dirs"]) == (500, 16), a
    assert (c1t["blocks"], c1t["tile_dirs"]) == (200, 8), c1t
    for mode, R, D, G, W in (("eval", 50, 0, 1, 744),
                             ("eval", 1, 0, 5, 4337),
                             ("tangent", 1, 1024, 5, 4337),
                             ("linear", 1, 0, 5, 4337)):
        info = kernels.fitted_kernel_info(mode, R, G, 73, W, D=D)
        assert info["blocks"] >= 132 and info["staged"], (mode, R, G, info)
        assert info["tile_queries"] % 32 == 0 or info["tile_queries"] == W
    c1e = kernels.fitted_kernel_info("eval", 50, 1, 73, 744)
    assert (c1e["blocks"], c1e["tile_queries"]) == (200, 224), c1e
    big = kernels.fitted_kernel_info("tangent", 1, 1, kernels.FIT_MAX_KNOTS,
                                     1, D=1)
    assert not big["staged"] and big["smem_bytes"] <= 232448, big


def _fit_t_plans(case):
    """Host plans of K7's streaming cases: a 43-knot spline whose 700
    queries past its last knot lie in one interval (after 60 spread over
    the knots); a joint legs plan (two sorted runs of 372 queries on 73
    knots, gathered through the interval order); a member of one
    interval (2 knots, 600 queries); a member with a query in each of its
    399 intervals (chunks cut at 64 segments); and all four stacked
    (W_max 760, not a multiple of the 256-query chunk)."""
    from adrates_torch.ops.interpolation import fitted_interp_plan
    from adrates_torch.utils.global_types import InterpTypes as IT
    rng = np.random.default_rng(len(case))

    def knots(n):
        return np.concatenate([[0.0], np.cumsum(rng.uniform(0.02, 2.0,
                                                            n - 1))])

    def plan(kind):
        if kind == "tail":
            x = knots(43)
            q = np.concatenate([np.sort(rng.uniform(0.0, x[-1], 60)),
                                np.sort(rng.uniform(x[-1], x[-1] + 30.0,
                                                    700))])
            return fitted_interp_plan(q, x, IT.NATCUBIC_ZERO_RATES)
        if kind == "legs":
            x = knots(73)
            q = np.concatenate([np.sort(rng.uniform(0.0, x[-1] + 5.0, 372))
                                for _ in range(2)])
            return fitted_interp_plan(q, x, IT.PCHIP_LOG_DISCOUNT)
        if kind == "one_interval":
            x = np.array([0.0, 1.5])
            return fitted_interp_plan(rng.uniform(-0.1, 4.0, 600), x,
                                      IT.FINCUBIC_ZERO_RATES)
        x = np.arange(400, dtype=np.float64)
        return fitted_interp_plan(x[:-1] + 0.5, x, IT.PCHIP_ZERO_RATES)

    kinds = ("tail", "legs", "one_interval", "segment_cap")
    return [plan(k) for k in (kinds if case == "stacked" else (case,))]


def _fit_t_twice(dev, plans, R, seed):
    """K7 launched twice on one seeded U-bar of R rows (the launches
    counted), and its twin."""
    from adrates_torch.ops.fitted_rows import fitted_plan
    tab = fitted_plan(plans, dev).tables
    Ub = torch.tensor(np.random.default_rng(seed).normal(
        size=(R, tab.G, tab.W_max)), device=dev)
    before = kernels.fitted_rows_t.launches
    got = kernels.fitted_rows_t(Ub, tab)
    again = kernels.fitted_rows_t(Ub, tab)
    assert kernels.fitted_rows_t.launches == before + 2
    ref = kernels.fitted_rows_t_plain(Ub, tab)
    torch.cuda.synchronize()
    return got, again, ref


@pytest.mark.parametrize("R", [1, 13, 100])
@pytest.mark.parametrize("case", ["tail", "legs", "one_interval",
                                  "segment_cap", "stacked"])
def test_fitted_rows_t_streams_at_1e12(dev, case, R):
    """K7's stream against its twin at 1e-12 x max|ref| on the long tail,
    the legs, one interval, the segment cap and all stacked, at R = 1 and
    R not a multiple of the tile; two launches equal bit for bit."""
    got, again, ref = _fit_t_twice(dev, _fit_t_plans(case), R, R)
    assert _rel_err(got, ref) <= 1e-12
    assert torch.equal(got, again)


@pytest.mark.parametrize("call", ["C2", "C1", "gamma_256"])
def test_fitted_rows_t_at_the_phase8_shapes(dev, call):
    """K7 at chip_smoke phase 8's three calls: region C2's [1,600, 5,
    2,225] (the spline cell's five fitted members, 43 and 73 knots),
    region C1's [1,600, 1, 744] (a joint legs plan on 73 knots) and the
    256 gammas' [32, 5, 4,337]; within 1e-12 x max|ref| of its twin and
    bit for bit equal to its second launch."""
    from adrates_torch.ops.interpolation import fitted_interp_plan
    from adrates_torch.utils.global_types import InterpTypes as IT
    rng = np.random.default_rng(16)
    if call == "C1":
        plans = _fit_t_plans("legs")
        R = 1600
    else:
        W, R = (2225, 1600) if call == "C2" else (4337, 32)
        plans = []
        for s, n in zip(("FINCUBIC_ZERO_RATES", "NATCUBIC_LOG_DISCOUNT",
                         "PCHIP_LOG_DISCOUNT", "NATCUBIC_ZERO_RATES",
                         "PCHIP_ZERO_RATES"), (43, 73, 73, 43, 73)):
            x = np.concatenate([[0.0], np.cumsum(rng.uniform(0.02, 1.0,
                                                             n - 1))])
            q = np.sort(rng.uniform(0.0, x[-1] + 20.0, W))
            plans.append(fitted_interp_plan(q, x, IT[s]))
    got, again, ref = _fit_t_twice(dev, plans, R, 17)
    assert _rel_err(got, ref) <= 1e-12
    assert torch.equal(got, again)


# ---------------------------------------------------------------------------
# K8-K11: the XCCY stage
# ---------------------------------------------------------------------------

_XBOOKS = {                       # (OIS scheme, XCCY scheme, S)
    "v1_flat": None,              # the OIS + XCCY test book: G = 1, S = 3
    "v3_flat": ("FLAT_FWD_RATES", "FLAT_FWD_RATES", 5),
    "v3_zero_fwd": ("LINEAR_ZERO_RATES", "LINEAR_FWD_RATES", 5),
    "v3_fwd_zero": ("LINEAR_FWD_RATES", "LINEAR_ZERO_RATES", 7),
    # G = 1, S = 3 over fitted parents (torch_cases.XCCY_FITTED_PARENTS):
    # the kernels read the parents' query grids
    "fitted_parents": "fitted",
}


def _xccy_case(name, recal, dev, seed=0):
    """(tables on dev, inputs on the CPU) of a book's XCCY stage: the
    spreads, PVs, parent grids (a fitted parent's query grid) and tangents
    of one fwd_delta on the CPU on 3 scenarios; the legs' tables from ``probe_tables`` (a cap and floor,
    an ia = 0 slot, a fixed first coupon), which do not telescope, and
    seeded domestic tangents and cotangents."""
    from adrates_torch.ops import xccy_stage as xs
    from adrates_torch.parallel import structured_risk as tsr
    if _XBOOKS[name] is None:
        mb = cases.compile_xccy_book(
            "adrates_torch", cases.build_xccy_model("adrates_torch"),
            recalibrate_xccy=recal)
    elif _XBOOKS[name] == "fitted":
        mb = cases.fitted_parent_book("adrates_torch", recal)[1]
    else:
        o, x, S = _XBOOKS[name]
        mb = cases.xccy3_book("adrates_torch", o, x, S,
                              recalibrate_xccy=recal)
    topo = tmb.book_inputs(mb).topology
    cpu = tmb.make_multibook_fn(mb, "cpu").book
    (si, tab_c), = cpu.params["xstage"].items()
    rng = np.random.default_rng(seed)
    q = torch.tensor(mb.basket.quotes0[None, :] + rng.normal(
        0.0, 1e-3, (3, mb.basket.n_quotes)))
    fw = tsr.make_structured_parts(topo)["fwd_delta"](
        q, cpu.params, cpu.aggregate, cpu.clamp_agg)
    c = fw["carry"][si]
    G, S = tab_c.G, tab_c.S
    # the grids the kernels read: a fitted parent's query grid
    inp = dict(sp=q[:, cpu.params["bat"][topo.stages[si].key]["qidx"]],
               fd=c.get("fq", c["for_ds"]), tf=c.get("tfq", c.get("tf2")),
               gs=torch.tensor(rng.standard_normal((3, G, tab_c.W))),
               dd=c["dq"] if "dq" in c else xs.lift_grid(tab_c.dfit,
                                                         c["dom_ds"])[0],
               tdl=torch.tensor(1e-3 * rng.standard_normal(
                   (3, max(tab_c.Qd, 3), G, tab_c.Ld))),
               gpv=torch.tensor(rng.standard_normal((3, G, S))))
    inp["pv"] = c["pv0"] if recal else tab_c.pv_dom0.expand(
        3, G, S).contiguous()
    tab = tmb.make_multibook_fn(mb, dev).book.params["xstage"][si]
    legs = xs.probe_tables(tab, seed)
    legs_c = xs.probe_tables(tab_c, seed)
    if not recal:                   # held as values: no dom directions
        legs = dataclasses.replace(legs, Qd=3)
        legs_c = dataclasses.replace(legs_c, Qd=3)
    return tab, tab_c, legs, legs_c, inp


def _xrel(got, ref):
    return float((got.cpu() - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("recal", [True, False], ids=["recal", "values"])
@pytest.mark.parametrize("name", list(_XBOOKS))
def test_xccy_stage_kernels_match_plain(dev, name, recal):
    """K8-K11 against their plain versions at 1e-12 x max|ref| on G = 1
    (S = 3) and G = 3 (S = 5, 7) stages on the three simple schemes, and
    on a G = 1 stage over fitted parents (the parents' query grids, every
    query an exact knot), both branches, one launch each; the Hessians'
    mirror entries equal bit for bit."""
    from adrates_torch.ops import xccy_stage as xs
    tab, tab_c, legs, legs_c, inp = _xccy_case(name, recal, dev)
    on = {k: None if v is None else v.to(dev).contiguous()
          for k, v in inp.items()}
    names = ("xccy_stage_jvp", "xccy_legs_jvp", "xccy_stage_hess",
             "xccy_legs_hess")
    before = [getattr(kernels, k).launches for k in names]
    got = kernels.xccy_stage_jvp(tab, on["sp"], on["pv"], on["fd"], on["tf"])
    ref = xs.xccy_stage_jvp_plain(tab_c, inp["sp"], inp["pv"], inp["fd"],
                                  inp["tf"])
    for a, b in zip(got, ref):
        assert _xrel(a, b) <= 1e-12
    got = kernels.xccy_stage_hess(tab, on["sp"], on["pv"], on["fd"],
                                  on["tf"], on["gs"])
    ref = xs.xccy_stage_hess_plain(tab_c, inp["sp"], inp["pv"], inp["fd"],
                                   inp["tf"], inp["gs"])
    assert (got[1] is None) == (not recal)
    for a, b in zip(got, ref):
        if b is not None:
            assert _xrel(a, b) <= 1e-12
    H = got[2]
    assert torch.equal(H, H.permute(0, 3, 2, 1))
    tdl = on["tdl"][:, :legs.Qd].contiguous()
    got = kernels.xccy_legs_jvp(legs, on["dd"], tdl)
    ref = xs.xccy_legs_jvp_plain(legs_c, inp["dd"],
                                 inp["tdl"][:, :legs.Qd].contiguous())
    for a, b in zip(got, ref):
        assert _xrel(a, b) <= 1e-12
    got = kernels.xccy_legs_hess(legs, on["dd"], tdl, on["gpv"])
    ref = xs.xccy_legs_hess_plain(legs_c, inp["dd"],
                                  inp["tdl"][:, :legs.Qd].contiguous(),
                                  inp["gpv"])
    for a, b in zip(got, ref):
        assert _xrel(a, b) <= 1e-12
    assert torch.equal(got[1], got[1].permute(0, 3, 2, 1))
    torch.cuda.synchronize()
    assert [getattr(kernels, k).launches for k in names] == \
        [b + 1 for b in before]


@pytest.mark.parametrize("recal", [True, False], ids=["recal", "values"])
def test_xccy_stage_route_on_cuda_matches_cpu(dev, recal):
    """The structured split with its three-member XCCY stage on K8-K11 on
    the card against the torch.func route on the CPU: dfs, J, H2 and the
    parent cotangents at 1e-12 x max|ref|; K8-K11 launched (K9 and K11
    only when recalibrated)."""
    from adrates_torch.parallel import structured_risk as tsr
    mb = cases.xccy3_book("adrates_torch", "LINEAR_ZERO_RATES",
                          "FLAT_FWD_RATES", 5, recalibrate_xccy=recal)
    topo = tmb.book_inputs(mb).topology
    q = torch.tensor(mb.basket.quotes0[None, :] + cases.shocks(
        mb.basket.n_quotes))
    outs = {}
    for where in ("cpu", dev):
        with pytest.MonkeyPatch.context() as mp:
            if where == "cpu":          # the torch.func route
                mp.setattr(tsr, "stage_routes", lambda topo: {})
            b = tmb.make_multibook_fn(mb, where).book
            parts = tsr.make_structured_parts(topo)
        qq = q.to(where)
        fw = parts["fwd_delta"](qq, b.params, b.aggregate, b.clamp_agg)
        h2x, v_of = parts["term2_xccy"](qq, b.params, fw["g"], fw["carry"])
        outs[str(where)] = (fw, h2x, v_of)
    torch.cuda.synchronize()
    (rf, rh, rv), (gf, gh, gv) = outs["cpu"], outs[str(dev)]
    for key in ("dfs", "J"):
        assert _xrel(gf[key], rf[key]) <= 1e-12, key
    assert _xrel(gh, rh) <= 1e-12
    assert sorted(gv) == sorted(rv) and bool(rv) == recal
    scale = max((float(v.abs().max()) for v in rv.values()), default=1.0)
    for k, v in rv.items():
        assert float((gv[k].cpu() - v).abs().max()) <= 1e-12 * scale, k


@pytest.mark.parametrize("recal", [True, False], ids=["recal", "values"])
def test_xccy_fitted_parents_route_on_cuda_matches_cpu(dev, recal):
    """The structured split of the book over fitted parents
    (``torch_cases.fitted_parent_book``) with its XCCY stage on the card
    (K6 lifting the parents to their query grids, K8-K11, K6's reverse
    mode and the curvature terms) against the torch.func route on the
    CPU: dfs, J, H2 and the parent cotangents at 1e-12 x max|ref|; K8 and
    K10 launched (K9 and K11, and K6's tangent mode, when recalibrated),
    no plain version run on the card."""
    from adrates_torch.ops import fitted_rows as tfr
    from adrates_torch.ops import xccy_stage as xs
    from adrates_torch.parallel import structured_risk as tsr
    mb = cases.fitted_parent_book("adrates_torch", recal)[1]
    topo = tmb.book_inputs(mb).topology
    q = torch.tensor(mb.basket.quotes0[None, :] + cases.shocks(
        mb.basket.n_quotes))
    names = ("xccy_stage_jvp", "xccy_legs_jvp", "xccy_stage_hess",
             "xccy_legs_hess", "fitted_eval", "fitted_eval_jvp")
    outs = {}
    for where in ("cpu", dev):
        with pytest.MonkeyPatch.context() as mp:
            if where == "cpu":          # the torch.func route
                mp.setattr(tsr, "stage_routes", lambda topo: {})
            b = tmb.make_multibook_fn(mb, where).book
            parts = tsr.make_structured_parts(topo)
            if where != "cpu":
                def refuse(*a, **k):
                    raise AssertionError("a plain version ran on the card")
                for plain in ("xccy_stage_jvp_plain", "xccy_legs_jvp_plain",
                              "xccy_stage_hess_plain",
                              "xccy_legs_hess_plain"):
                    mp.setattr(xs, plain, refuse)
                mp.setattr(tfr, "fitted_eval_plain", refuse)
                mp.setattr(tfr, "fitted_eval_jvp_plain", refuse)
            before = [getattr(kernels, k).launches for k in names]
            qq = q.to(where)
            fw = parts["fwd_delta"](qq, b.params, b.aggregate, b.clamp_agg)
            h2x, v_of = parts["term2_xccy"](qq, b.params, fw["g"],
                                            fw["carry"])
            if where != "cpu":
                torch.cuda.synchronize()
        outs[str(where)] = (fw, h2x, v_of)
    n = [getattr(kernels, k).launches - b for k, b in zip(names, before)]
    assert n[0] == 1 and n[2] == 1 and n[4] >= 1, n
    assert (n[1] == 1 and n[3] == 1 and n[5] >= 1) == recal, n
    (rf, rh, rv), (gf, gh, gv) = outs["cpu"], outs[str(dev)]
    for key in ("dfs", "J"):
        assert _xrel(gf[key], rf[key]) <= 1e-12, key
    assert _xrel(gh, rh) <= 1e-12
    assert sorted(gv) == sorted(rv) and bool(rv) == recal
    scale = max((float(v.abs().max()) for v in rv.values()), default=1.0)
    for k, v in rv.items():
        assert float((gv[k].cpu() - v).abs().max()) <= 1e-12 * scale, k


def test_xccy_query_grid_maps_on_cuda_match_cpu(dev):
    """The query-grid maps of a stage over fitted parents on the card
    against the CPU (their plain versions), at 1e-12 x max|ref|: the
    lift (K6 and its tangent mode at the parents' query times) and the
    pull-back with the curvature term (K6's reverse mode, forward over
    reverse), on the domestic and foreign grids, seeded cotangents."""
    from adrates_torch.ops import xccy_stage as xs
    from adrates_torch.parallel import structured_risk as tsr
    mb = cases.fitted_parent_book("adrates_torch", True)[1]
    topo = tmb.book_inputs(mb).topology
    cpu = tmb.make_multibook_fn(mb, "cpu").book
    (si, tab_c), = cpu.params["xstage"].items()
    tab = tmb.make_multibook_fn(mb, dev).book.params["xstage"][si]
    q = torch.tensor(mb.basket.quotes0[None, :] + cases.shocks(
        mb.basket.n_quotes))
    c = tsr.make_structured_parts(topo)["fwd_delta"](
        q, cpu.params, cpu.aggregate, cpu.clamp_agg)["carry"][si]
    rng = np.random.default_rng(4)
    for side, x, t in (("d", c["dom_ds"], c["td_legs"]),
                       ("f", c["for_ds"], c["tf2"][:, 2 * tab_c.S:])):
        fit_c, fit = getattr(tab_c, side + "fit"), getattr(tab, side + "fit")
        ref = xs.lift_grid(fit_c, x, t)
        got = xs.lift_grid(fit, x.to(dev), t.to(dev))
        for a, b in zip(got, ref):
            assert _xrel(a, b) <= 1e-12, side
        g = torch.tensor(rng.standard_normal(tuple(ref[0].shape)))
        ref = xs.pull_grid(fit_c, x, g, t)
        got = xs.pull_grid(fit, x.to(dev), g.to(dev), t.to(dev))
        for a, b in zip(got, ref):
            assert _xrel(a, b) <= 1e-12, side
    torch.cuda.synchronize()


# K8 / K10 split at the node DFs: the route's maxima, a foreign grid
# longer than a block's shared-memory tile, one direction, odd scenario
# counts, both branches; H symmetric and two launches equal bit for bit

_XLONG = ["1Y", "2Y", "3Y", "4Y", "5Y", "6Y", "7Y", "8Y", "9Y", "10Y",
          "15Y", "20Y", "30Y", "40Y", "50Y", "63Y"]


def _xccy_one_book(tenors, scheme, recal):
    """A book whose one XCCY stage is GBP_USD_XCCY on ``scheme`` over the
    given basis tenors (USD and GBP OIS on FLAT_FWD), with GBP OIS under
    USD collateral from 1Y to 60Y (discounted on the XCCY curve, its
    rows); 16 tenors to 63Y give the route's maxima, S = 16 and U1 =
    64."""
    import importlib
    u, Model, OIS = cases._ns("adrates_torch")
    mbmod = importlib.import_module("adrates_torch.parallel.multibook")
    m = Model(u.Date(1, 1, 2024))
    D, F, C, S = (u.DayCountTypes, u.FrequencyTypes, u.CurveTypes,
                  u.SwapTypes)
    for name, px, dc in (("USD_OIS_SOFR", [5.3, 5.0, 4.6, 4.0, 3.88],
                          D.ACT_360),
                         ("GBP_OIS_SONIA", [5.0, 4.7, 4.3, 3.9, 3.87],
                          D.ACT_365F)):
        m.build_curve(name, px_list=px,
                      tenor_list=["6M", "1Y", "2Y", "5Y", "10Y"],
                      fixed_dcc_type=dc, float_dc_type=dc,
                      interp_type=u.InterpTypes.FLAT_FWD_RATES)
    m.build_fx(["GBPUSD"], [1.27])
    m.build_xccy_curve(
        name="GBP_USD_XCCY", domestic_curve_name="USD_OIS_SOFR",
        foreign_curve_name="GBP_OIS_SONIA", spot_fx=1.27,
        basis_spreads=[-5.0 - 1.5 * i for i in range(len(tenors))],
        tenor_list=tenors, interp_type=getattr(u.InterpTypes, scheme))
    v = m.value_dt
    trades = [OIS(v, f"{y}Y", S.PAY if y % 2 else S.RECEIVE,
                  0.02 + 0.001 * k, F.ANNUAL, D.ACT_365F, C.GBP_OIS_SONIA,
                  u.CurrencyTypes.GBP, notional=1e7,
                  float_dc_type=D.ACT_365F)
              for k, y in enumerate((1, 3, 7, 12, 25, 45, 60))]
    trades.append(OIS(v, "5Y", S.PAY, 0.04, F.ANNUAL, D.ACT_360,
                      C.USD_OIS_SOFR, u.CurrencyTypes.USD, notional=1e7,
                      float_dc_type=D.ACT_360))
    coll = [u.CollateralType.USD] * (len(trades) - 1) + [None]
    return mbmod.compile_multibook(trades, m,
                                   base_currency=u.CurrencyTypes.USD,
                                   collateral_types=coll,
                                   recalibrate_xccy=recal)


def _xstage_inputs(mb, recal, dev, Sc, seed=0):
    """(tables on dev, tables on the CPU, inputs on the CPU) of a book's
    one XCCY stage: the spreads, PVs, foreign grids and tangents of a
    torch.func fwd_delta on Sc scenarios, and seeded cotangents."""
    from adrates_torch.parallel import structured_risk as tsr
    topo = tmb.book_inputs(mb).topology
    cpu = tmb.make_multibook_fn(mb, "cpu").book
    (si, tab_c), = cpu.params["xstage"].items()
    rng = np.random.default_rng(seed)
    q = torch.tensor(mb.basket.quotes0[None, :] + rng.normal(
        0.0, 1e-3, (Sc, mb.basket.n_quotes)))
    fw = tsr.make_structured_parts(topo)["fwd_delta"](
        q, cpu.params, cpu.aggregate, cpu.clamp_agg)
    c = fw["carry"][si]
    G, S = tab_c.G, tab_c.S
    inp = dict(sp=q[:, cpu.params["bat"][topo.stages[si].key]["qidx"]],
               fd=c["for_ds"], tf=c.get("tf2"),
               gs=torch.tensor(rng.standard_normal((Sc, G, tab_c.W))))
    inp["pv"] = c["pv0"] if recal else tab_c.pv_dom0.expand(
        Sc, G, S).contiguous()
    tab = tmb.make_multibook_fn(mb, dev).book.params["xstage"][si]
    return tab, tab_c, inp


def _xsplit_check(tab, tab_c, inp, dev):
    """K8 and K10 against their plain versions at 1e-12 x max|ref| of
    every output, each launched twice on one input (equal bit for bit),
    H equal to its mirror bit for bit, two launches counted each."""
    from adrates_torch.ops import xccy_stage as xs
    on = {k: None if v is None else v.to(dev).contiguous()
          for k, v in inp.items()}
    before = [kernels.xccy_stage_jvp.launches,
              kernels.xccy_stage_hess.launches]
    args8 = (on["sp"], on["pv"], on["fd"], on["tf"])
    got = kernels.xccy_stage_jvp(tab, *args8)
    again = kernels.xccy_stage_jvp(tab, *args8)
    ref = xs.xccy_stage_jvp_plain(tab_c, inp["sp"], inp["pv"], inp["fd"],
                                  inp["tf"])
    for a, a2, b in zip(got, again, ref):
        assert _xrel(a, b) <= 1e-12
        assert torch.equal(a, a2)
    got = kernels.xccy_stage_hess(tab, *args8, on["gs"])
    again = kernels.xccy_stage_hess(tab, *args8, on["gs"])
    ref = xs.xccy_stage_hess_plain(tab_c, inp["sp"], inp["pv"], inp["fd"],
                                   inp["tf"], inp["gs"])
    assert (got[1] is None) == (not tab.recal)
    for a, a2, b in zip(got, again, ref):
        if b is not None:
            assert _xrel(a, b) <= 1e-12
            assert torch.equal(a, a2)
    H = got[2]
    assert torch.equal(H, H.permute(0, 3, 2, 1))
    torch.cuda.synchronize()
    assert [kernels.xccy_stage_jvp.launches,
            kernels.xccy_stage_hess.launches] == [b + 2 for b in before]


@pytest.mark.parametrize("recal", [True, False], ids=["recal", "values"])
@pytest.mark.parametrize("scheme", ["FLAT_FWD_RATES", "LINEAR_ZERO_RATES",
                                    "LINEAR_FWD_RATES"])
def test_xccy_stage_split_at_the_route_maxima(dev, scheme, recal):
    """K8 / K10 at the route's maxima (S = 16 pillars, U1 = 64 nodes, 273
    chain points) on each simple scheme, 5 scenarios."""
    mb = _xccy_one_book(_XLONG, scheme, recal)
    tab, tab_c, inp = _xstage_inputs(mb, recal, dev, 5)
    assert (tab.S, tab.U1) == (16, 64)
    _xsplit_check(tab, tab_c, inp, dev)


@pytest.mark.parametrize("Lf", [1001, 8001])
@pytest.mark.parametrize("recal", [True, False], ids=["recal", "values"])
def test_xccy_stage_split_long_foreign_grid(dev, recal, Lf):
    """A foreign grid padded to Lf entries that no query reads: at 1,001
    a block's foreign tangent rows (15 directions) no longer fit in its
    share of an SM's shared memory and are read from device memory; at
    8,001 the grid's transforms neither, and are computed at each read
    (the layout's fallbacks)."""
    mb = cases.xccy3_book("adrates_torch", "LINEAR_ZERO_RATES",
                          "FLAT_FWD_RATES", 5, recalibrate_xccy=recal)
    tab, tab_c, inp = _xstage_inputs(mb, recal, dev, 3)
    pad = Lf - tab.Lf
    rng = np.random.default_rng(Lf)

    def grow(t, fill):
        extra = torch.as_tensor(fill(t.shape[:-1] + (pad,)), dtype=t.dtype)
        return torch.cat([t, extra.to(t.device)], dim=-1).contiguous()

    def longer(tb):
        return dataclasses.replace(tb, Lf=Lf, f_xs=grow(tb.f_xs, np.ones))
    tab, tab_c = longer(tab), longer(tab_c)
    inp["fd"] = grow(inp["fd"], lambda s: rng.uniform(0.5, 1.0, s))
    if inp["tf"] is not None:
        inp["tf"] = grow(inp["tf"], lambda s: rng.normal(0.0, 1e-3, s))
    for name in ("xccy_stage_jvp", "xccy_stage_hess"):
        held = kernels.xccy_kernel_info(tab, name)["held"]
        assert "rows" not in held and "chain" in held
        assert ("grid" in held) == (Lf < 8000)
    _xsplit_check(tab, tab_c, inp, dev)


@pytest.mark.parametrize("recal", [True, False], ids=["recal", "values"])
def test_xccy_stage_split_one_pillar(dev, recal):
    """One basis tenor: S = 1, so D = 1 held as values (one direction, one
    tile, one pair) and D = 2 + Qf recalibrated; 7 scenarios."""
    mb = _xccy_one_book(["5Y"], "FLAT_FWD_RATES", recal)
    tab, tab_c, inp = _xstage_inputs(mb, recal, dev, 7)
    assert tab.S == 1 and (recal or tab.D == 1)
    _xsplit_check(tab, tab_c, inp, dev)


@pytest.mark.parametrize("Sc", [1, 3, 13])
@pytest.mark.parametrize("recal", [True, False], ids=["recal", "values"])
def test_xccy_stage_split_odd_scenarios(dev, recal, Sc):
    """Three members (S = 7, LINEAR_ZERO over LINEAR_FWD OIS) at odd
    scenario counts."""
    mb = cases.xccy3_book("adrates_torch", "LINEAR_FWD_RATES",
                          "LINEAR_ZERO_RATES", 7, recalibrate_xccy=recal)
    tab, tab_c, inp = _xstage_inputs(mb, recal, dev, Sc, seed=Sc)
    _xsplit_check(tab, tab_c, inp, dev)


def test_xccy_stage_split_no_local_memory(dev):
    """K8 and K10 keep nothing in local memory (no spill, no stack: every
    per-thread value is a register or the thread's column of the block's
    scratch), and their blocks fit several to an SM at flagship_v5-like
    sizes."""
    mb = cases.xccy3_book("adrates_torch", "FLAT_FWD_RATES",
                          "FLAT_FWD_RATES", 7, recalibrate_xccy=True)
    tab = tmb.make_multibook_fn(mb, dev).book.params["xstage"][1]
    for name in ("xccy_stage_jvp", "xccy_stage_hess"):
        info = kernels.xccy_kernel_info(tab, name)
        assert info["local_bytes"] == 0, (name, info)
        assert info["blocks_per_sm"] >= 2, (name, info)


# K9 / K11 split at the legs' flows: a long domestic grid, the route's
# maxima, many domestic directions (the layout's fallbacks); two launches
# bit for bit, Hl symmetric, no local memory


def _legs_inputs(tab, Sc, Qd, seed):
    """Probe legs of ``tab`` with Qd domestic directions (its pair table
    on the tables' device) and seeded grids [Sc, G, Ld] (DFs falling from
    1), tangents [Sc, Qd, G, Ld] and cotangents [Sc, G, S], on the
    tables' device."""
    from adrates_torch.ops import xccy_stage as xs
    dev = tab.leg_f.device
    pt = xs.probe_tables(tab, seed)
    pt = dataclasses.replace(pt, Qd=Qd)
    rng = np.random.default_rng(seed)
    G, Ld = pt.G, pt.Ld
    dd = np.exp(-np.cumsum(rng.uniform(0.0, 0.08, (Sc, G, Ld)), axis=-1))
    dd[..., 0] = 1.0
    return pt, dict(
        dd=torch.tensor(dd, device=dev),
        tdl=torch.tensor(1e-3 * rng.standard_normal((Sc, Qd, G, Ld)),
                         device=dev),
        gpv=torch.tensor(rng.standard_normal((Sc, G, pt.S)), device=dev))


def _legs_check(pt, inp):
    """K9 and K11 against their plain versions (torch.func on the same
    tables, on the card) at 1e-12 x max|ref| of every output, each
    launched twice (equal bit for bit), Hl its own mirror bit for bit,
    two launches counted each."""
    from adrates_torch.ops import xccy_stage as xs
    before = [kernels.xccy_legs_jvp.launches, kernels.xccy_legs_hess.launches]
    args = (pt, inp["dd"], inp["tdl"])
    for name, extra in (("xccy_legs_jvp", ()),
                        ("xccy_legs_hess", (inp["gpv"],))):
        kern = getattr(kernels, name)
        got = kern(*args, *extra)
        again = kern(*args, *extra)
        ref = getattr(xs, name + "_plain")(*args, *extra)
        for a, a2, b in zip(got, again, ref):
            assert _xrel(a, b.cpu()) <= 1e-12, name
            assert torch.equal(a, a2), name
    Hl = got[1]
    assert torch.equal(Hl, Hl.permute(0, 3, 2, 1))
    torch.cuda.synchronize()
    assert [kernels.xccy_legs_jvp.launches,
            kernels.xccy_legs_hess.launches] == [b + 2 for b in before]


@pytest.mark.parametrize("scheme", ["FLAT_FWD_RATES", "LINEAR_ZERO_RATES",
                                    "LINEAR_FWD_RATES"])
def test_xccy_legs_split_long_domestic_grid(dev, scheme):
    """A domestic grid padded to 1,001 entries that no query reads (three
    members, S = 5, on each simple domestic scheme): the rows stay the
    entries the queries read, the grid's transforms fit in shared memory;
    gdd is 0 off the rows."""
    from adrates_torch.ops import xccy_stage as xs
    mb = cases.xccy3_book("adrates_torch", scheme, "FLAT_FWD_RATES", 5,
                          recalibrate_xccy=True)
    tab = tmb.make_multibook_fn(mb, dev).book.params["xstage"][1]
    pad = 1001 - tab.Ld
    tab = dataclasses.replace(
        tab, Ld=1001,
        d_xs=torch.cat([tab.d_xs, torch.ones(tab.G, pad, dtype=torch.float64,
                                             device=dev)], -1).contiguous(),
        lr_of=torch.cat([tab.lr_of, torch.full((tab.G, pad), -1,
                                               dtype=torch.int32,
                                               device=dev)], -1).contiguous())
    pt, inp = _legs_inputs(tab, 3, 6, 1001)
    _legs_check(pt, inp)
    gdd, _ = kernels.xccy_legs_hess(pt, inp["dd"], inp["tdl"], inp["gpv"])
    assert not gdd[..., tab.Ld - pad:].any()
    info = kernels.xccy_kernel_info(pt, "xccy_legs_hess")
    assert "grid" in info["held"] and "rows" in info["held"], info
    assert xs.LEG_BLOCK == info["threads"]


@pytest.mark.parametrize("scheme", ["FLAT_FWD_RATES", "LINEAR_ZERO_RATES",
                                    "LINEAR_FWD_RATES"])
def test_xccy_legs_split_at_the_route_maxima(dev, scheme):
    """K9 / K11 at the route's maxima (S = 16 legs of up to 63 annual
    coupons, 1,040 flows in five chunks) with 64 domestic directions, 5
    scenarios."""
    mb = _xccy_one_book(_XLONG, "FLAT_FWD_RATES", True)
    tab = tmb.make_multibook_fn(mb, dev).book.params["xstage"][1]
    assert (tab.S, tab.P) == (16, 63)
    tab = dataclasses.replace(tab, dsch={
        "FLAT_FWD_RATES": 1, "LINEAR_ZERO_RATES": 2,
        "LINEAR_FWD_RATES": 0}[scheme])
    pt, inp = _legs_inputs(tab, 5, 64, 16)
    _legs_check(pt, inp)


@pytest.mark.parametrize("Qd", [400, 1024])
def test_xccy_legs_split_many_directions(dev, Qd):
    """Domestic directions beyond a block's shared memory (three members,
    S = 7, 12 rows): at 400 the tangent rows are read from device memory,
    at 1,024 U is also cut into tiles of directions (the layout's
    fallbacks)."""
    mb = cases.xccy3_book("adrates_torch", "LINEAR_ZERO_RATES",
                          "FLAT_FWD_RATES", 7, recalibrate_xccy=True)
    tab = tmb.make_multibook_fn(mb, dev).book.params["xstage"][1]
    pt, inp = _legs_inputs(tab, 2, Qd, Qd)
    info = kernels.xccy_kernel_info(pt, "xccy_legs_hess")
    assert "rows" not in info["held"], info
    assert (info["tile"] < Qd) == (Qd > 400), info
    _legs_check(pt, inp)


def test_xccy_legs_split_no_local_memory(dev):
    """K9 and K11 keep nothing in local memory and fit two blocks an SM at
    flagship_v5-like sizes (three members, S = 7)."""
    mb = cases.xccy3_book("adrates_torch", "FLAT_FWD_RATES",
                          "FLAT_FWD_RATES", 7, recalibrate_xccy=True)
    tab = tmb.make_multibook_fn(mb, dev).book.params["xstage"][1]
    for name in ("xccy_legs_jvp", "xccy_legs_hess"):
        info = kernels.xccy_kernel_info(tab, name)
        assert info["local_bytes"] == 0, (name, info)
        assert info["blocks_per_sm"] >= 2, (name, info)


# K12 xccy_stage_node_hess: the per-trade tensors' node DFs, their
# tangents and second derivatives (K10's blocks with a node sink)


def _flagship_base(recal):
    """flagship_v5's base book (1,004 trades, untiled): its one XCCY stage
    has three members, S = 8, a 73-entry foreign grid and, recalibrated,
    D = 2S + 32 = 48 directions (held as values, D = S)."""
    import warnings

    from adrates_torch.examples import flagship_v5 as cfg
    model = cfg.build_model()
    trades, coll = cfg.build_base_trades(model,
                                         np.random.default_rng(cfg.SEED))
    with warnings.catch_warnings():        # CHF has no trades
        warnings.simplefilter("ignore", UserWarning)
        return cfg.compile_base(model, trades, coll, recalibrate_xccy=recal)


def _node_check(tab, tab_c, inp, dev):
    """K12 against its plain version at 1e-12 x max|ref| of every output,
    launched twice on one input (equal bit for bit), Hn equal to its
    mirror bit for bit, Jfd only recalibrated, two launches counted."""
    from adrates_torch.ops import xccy_stage as xs
    on = {k: None if v is None else v.to(dev).contiguous()
          for k, v in inp.items()}
    before = kernels.xccy_stage_node_hess.launches
    args = (on["sp"], on["pv"], on["fd"], on["tf"])
    got = kernels.xccy_stage_node_hess(tab, *args)
    again = kernels.xccy_stage_node_hess(tab, *args)
    ref = xs.xccy_stage_node_hess_plain(tab_c, inp["sp"], inp["pv"],
                                        inp["fd"], inp["tf"])
    assert (got[2] is None) == (ref[2] is None) == (not tab.recal)
    for a, a2, b in zip(got, again, ref):
        if b is not None:
            assert _xrel(a, b) <= 1e-12
            assert torch.equal(a, a2)
    Hn = got[3]
    assert Hn.shape == (inp["sp"].shape[0], tab.D, tab.D, tab.G, tab.U1)
    assert torch.equal(Hn, Hn.transpose(1, 2))
    torch.cuda.synchronize()
    assert kernels.xccy_stage_node_hess.launches == before + 2


@pytest.mark.parametrize("recal", [True, False], ids=["recal", "values"])
def test_xccy_stage_node_hess_at_flagship_shapes(dev, recal):
    """K12 at flagship_v5's stage (G = 3, S = 8, Lf = 73; D = 48
    recalibrated, D = S held as values) at one quote vector, as the
    per-trade tensors call it."""
    mb = _flagship_base(recal)
    tab, tab_c, inp = _xstage_inputs(mb, recal, dev, 1)
    assert (tab.G, tab.S, tab.Lf, tab.D) == (3, 8, 73, 48 if recal else 8)
    _node_check(tab, tab_c, inp, dev)


@pytest.mark.parametrize("recal", [True, False], ids=["recal", "values"])
@pytest.mark.parametrize("case", ["maxima", "three_members", "one_pillar"])
def test_xccy_stage_node_hess_matches_plain(dev, case, recal):
    """K12 at the route's maxima (S = 16, U1 = 64) on 2 scenarios, on a
    three-member stage (S = 7, LINEAR_ZERO over LINEAR_FWD OIS) on 3 and
    on one pillar (S = 1) on 1."""
    if case == "maxima":
        mb, Sc = _xccy_one_book(_XLONG, "FLAT_FWD_RATES", recal), 2
    elif case == "three_members":
        mb, Sc = cases.xccy3_book("adrates_torch", "LINEAR_FWD_RATES",
                                  "LINEAR_ZERO_RATES", 7,
                                  recalibrate_xccy=recal), 3
    else:
        mb, Sc = _xccy_one_book(["5Y"], "FLAT_FWD_RATES", recal), 1
    tab, tab_c, inp = _xstage_inputs(mb, recal, dev, Sc, seed=Sc)
    _node_check(tab, tab_c, inp, dev)


def test_xccy_stage_node_hess_no_local_memory(dev):
    """K12 keeps nothing in local memory and fits several blocks an SM at
    flagship_v5's stage."""
    tab = tmb.make_multibook_fn(_flagship_base(True), dev).book.params[
        "xstage"][1]
    info = kernels.xccy_kernel_info(tab, "xccy_stage_node_hess")
    assert info["local_bytes"] == 0, info
    assert info["blocks_per_sm"] >= 2, info


def test_xccy_stage_node_hess_fills_the_card(dev):
    """At flagship_v5's per-trade call (one scenario, G = 3, D = 48, Lf =
    73) K12's pair launch has at least one block an SM of the card (a
    block a member and tile pair of directions), and each of its two
    launches keeps nothing in local memory and fits two blocks an SM."""
    tab = tmb.make_multibook_fn(_flagship_base(True), dev).book.params[
        "xstage"][1]
    info = kernels.xccy_kernel_info(tab, "xccy_stage_node_hess")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert info["blocks"] >= sms, info
    nT = -(-48 // info["tile"])
    assert info["blocks"] == 3 * nT * (nT + 1) // 2, info
    for k in ("prologue", "pairs"):
        assert info[k]["local_bytes"] == 0, info
        assert info[k]["blocks_per_sm"] >= 2, info


@pytest.mark.parametrize("recal", [True, False], ids=["recal", "values"])
def test_pertrade_node_split_on_cuda_matches_cpu(dev, recal):
    """The per-trade tensors of the OIS + XCCY book's stage on the card
    (K12, and recalibrated K9 / K11, one launch each) and their
    contraction with seeded DF gradients, the 256-gamma path's term 2,
    against the same call on the CPU at 1e-12 x max|ref|; the selected
    trades' gammas the same."""
    from adrates_torch.parallel import structured_risk as tsr
    mb = cases.compile_xccy_book("adrates_torch",
                                 cases.build_xccy_model("adrates_torch"),
                                 recalibrate_xccy=recal)
    topo = mb.basket.topology()
    inp = tmb.book_inputs(mb)
    q0 = torch.tensor(mb.basket.quotes0)
    Gs = torch.tensor(np.random.default_rng(8).normal(0.0, 1e6,
                                                      (4, inp.n_grid)))
    names = ("xccy_stage_node_hess", "xccy_legs_jvp", "xccy_legs_hess")
    out = {}
    for d in ("cpu", dev):
        P = tmb._device_book(inp, d, sweep=False, quad=False).params
        before = [getattr(kernels, k).launches for k in names]
        so = tsr.make_pertrade_tensors(topo)(q0.to(d), P)
        out[str(d)] = tsr.make_pertrade_curvehess(topo)(so, Gs.to(d)).cpu()
        torch.cuda.synchronize()
        n = [getattr(kernels, k).launches - b for k, b in zip(names, before)]
        assert n == ([0, 0, 0] if d == "cpu"
                     else [1, 1, 1] if recal else [1, 0, 0])
    assert _rel_err(out[str(dev)], out["cpu"]) <= 1e-12
    sel = cases.pertrade_selection(mb)
    ref = tmb.make_per_trade_gamma_fn(mb, sel, "cpu")(q0)
    got = tmb.make_per_trade_gamma_fn(mb, sel, dev)(q0)
    assert _rel_err(got.cpu(), ref) <= 1e-12


# K13 / K14: the OIS stage, a warp a (scenario, member), a lane a quote
# direction; seeded stages with mixed schemes, more than 32 quotes (two
# tiles of lanes), the most points the route takes, quotes that cross zero
# (linear rates) and one below the 1e-8 clamp


OIS_STAGES = {
    "mixed": ([(8, 1, "FLAT_FWD_RATES"), (5, 2, "LINEAR_ZERO_RATES"),
               (6, 1, "LINEAR_FWD_RATES")], 40, 1.0, 5),
    "qp40": ([(40, 1, "FLAT_FWD_RATES"), (33, 1, "LINEAR_ZERO_RATES")], 60,
             1.0, 3),
    "p192": ([(24, 4, "FLAT_FWD_RATES"), (10, 2, "LINEAR_FWD_RATES")], 300,
             2.0, 2),
}


def _ois_case(name, dev):
    members, W, spacing, Sc = OIS_STAGES[name]
    tab, q = cases.ois_stage_case(members, W, Sc, 11, dev, spacing=spacing)
    rng = np.random.default_rng(12)
    gs = torch.tensor(rng.standard_normal((Sc, tab.G, tab.W)), device=dev)
    vs = torch.tensor(rng.standard_normal((Sc, tab.G, tab.P1)), device=dev)
    return tab, q, gs, vs


def _cross_zero(q):
    """Scenario 0's first member crossing zero (linear rates), scenario
    1's second member with a quote below the 1e-8 clamp."""
    q = q.clone()
    q[0, 0] = q[0, 0] - q[0, 0].mean()
    if q.shape[0] > 1 and q.shape[1] > 1:
        q[1, 1, 1] = 4e-9
    return q


@pytest.mark.parametrize("clamp", [False, True], ids=["plain", "cross_zero"])
@pytest.mark.parametrize("name", sorted(OIS_STAGES))
def test_ois_stage_jvp_matches_plain(dev, name, clamp):
    """K13 against its plain version (torch.func over ois_native_ds and
    stage_rows) at 1e-12 x max|ref| of each output; one launch a call;
    two launches equal bit for bit."""
    from adrates_torch.ops import ois_stage
    tab, q, _, _ = _ois_case(name, dev)
    if clamp:
        q = _cross_zero(q)
    ref = ois_stage.ois_stage_jvp_plain(tab, q)
    before = kernels.ois_stage_jvp.launches
    got = kernels.ois_stage_jvp(tab, q)
    assert kernels.ois_stage_jvp.launches == before + 1
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        assert _rel_err(a, b) <= 1e-12
    again = kernels.ois_stage_jvp(tab, q)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("clamp", [False, True], ids=["plain", "cross_zero"])
@pytest.mark.parametrize("name", sorted(OIS_STAGES))
def test_ois_stage_hess_matches_plain(dev, name, clamp):
    """K14 against its plain version (jvp over grad of g . rows + v . ds)
    at 1e-12 x max|ref|; one launch a call; two launches equal bit for
    bit."""
    from adrates_torch.ops import ois_stage
    tab, q, gs, vs = _ois_case(name, dev)
    if clamp:
        q = _cross_zero(q)
    ref = ois_stage.ois_stage_hess_plain(tab, q, gs, vs)
    before = kernels.ois_stage_hess.launches
    got = kernels.ois_stage_hess(tab, q, gs, vs)
    assert kernels.ois_stage_hess.launches == before + 1
    assert got.shape == ref.shape
    assert _rel_err(got, ref) <= 1e-12
    assert torch.equal(got, kernels.ois_stage_hess(tab, q, gs, vs))


def test_ois_stage_no_local_memory(dev):
    """K13 and K14 keep nothing in local memory (every per-lane value a
    register or the lane's column of the warp's shared tables) at the
    route's largest plan, and their warps fit several to an SM at
    flagship_v5-like sizes (72 points, 32 quotes)."""
    big, *_ = _ois_case("p192", dev)
    flag, _ = cases.ois_stage_case([(30, 1, "FLAT_FWD_RATES")] * 2 + [
        (14, 1, "FLAT_FWD_RATES")], 500, 1, 3, dev, spacing=1.0)
    for tab, least in ((big, 1), (flag, 3)):
        for name in ("ois_stage_jvp", "ois_stage_hess"):
            info = kernels.ois_kernel_info(tab, name)
            assert info["local_bytes"] == 0, (name, info)
            assert info["blocks_per_sm"] >= least, (name, tab.P, info)


@pytest.mark.parametrize("recal", [True, False], ids=["recal", "values"])
def test_ois_stage_route_card_equals_cpu(dev, recal):
    """The OIS + XCCY book's fwd_delta and term2_ois with its OIS stage on
    K13 / K14 on the card equal the same parts on the CPU (the plain
    versions) at 1e-12 x max|ref|; K13 and K14 launch once each a call."""
    from adrates_torch.parallel import structured_risk as tsr
    mb = cases.compile_xccy_book("adrates_torch",
                                 cases.build_xccy_model("adrates_torch"),
                                 recalibrate_xccy=recal)
    topo = tmb.book_inputs(mb).topology
    parts = tsr.make_structured_parts(topo)
    q0 = torch.tensor(mb.basket.quotes0[None, :]
                      + cases.shocks(mb.basket.n_quotes))
    out = {}
    for d in ("cpu", dev):
        book = tmb.make_multibook_fn(mb, d).book
        assert len(book.params["ostage"]) == 1
        q = q0.to(d)
        before = (kernels.ois_stage_jvp.launches,
                  kernels.ois_stage_hess.launches)
        fw = parts["fwd_delta"](q, book.params, book.aggregate,
                                book.clamp_agg)
        _, v_of = parts["term2_xccy"](q, book.params, fw["g"], fw["carry"])
        h2o = parts["term2_ois"](q, book.params, fw["g"], v_of)
        n = (kernels.ois_stage_jvp.launches - before[0],
             kernels.ois_stage_hess.launches - before[1])
        assert n == ((1, 1) if d != "cpu" else (0, 0))
        out[str(d)] = [t.cpu() for t in (fw["dfs"], fw["J"], h2o)]
    for a, b in zip(out[str(dev)], out["cpu"]):
        assert _rel_err(a, b) <= 1e-12
