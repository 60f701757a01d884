"""The plain torch twins of the two CUDA kernels, on the kernels' static
tables, against the JAX functions they replace, on the same numpy inputs,
to 1e-12 x max|ref| (the two differ only in summation order); and the
tables themselves (K1's per-trade CSR and trade blocks against the
bucketed computation they replace, K2's reduction table against the
groups' rows). On CPU tensors the wrappers run the twins and leave the
launch counters at 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import adrates_tpu  # noqa: F401 — enables x64 for the JAX side
import torch_cases as cases
from adrates_tpu.parallel import multibook as jmb
from adrates_torch.ops import kernels
from adrates_torch.parallel import multibook as tmb


@pytest.fixture(scope="module")
def jbook():
    _, tiled = cases.compile_book("adrates_tpu",
                                  cases.build_model("adrates_tpu"))
    return tiled


def _dfs(n_scen, n_grid, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.3, 1.0, (n_scen, n_grid))


def _jax_pvs(mb, dfs):
    _, clamp, cols = jmb._device_expand(None, mb.clamp, mb.tile,
                                        cols=mb.cols)
    return np.asarray(jmb._pvs_sweep(jnp.asarray(dfs), cols, clamp,
                                     mb.aggregate,
                                     jnp.asarray(jmb._trade_row_table(mb))))


def _port_pvs_inputs(mb, dfs):
    """vT and K1's tables, from the JAX book's numpy column buckets
    expanded copy-major (the expansion and tables are the port's own)."""
    agg = mb.aggregate
    trips = ((dfs[:, agg.trip_s] / dfs[:, agg.trip_e] - 1.0)
             * dfs[:, agg.trip_p])
    vT = torch.tensor(np.concatenate([dfs, trips], axis=1).T.copy())
    inp = tmb.BookInputs(
        grids=None, bat={}, grid_sel=None,
        cols=tuple(tmb.ColRows(col_idx=np.asarray(c.col_idx),
                               w=np.asarray(c.w),
                               row_trade=np.asarray(c.row_trade))
                   for c in mb.cols),
        clamp=None, aggregate=agg, groups=None,
        n_grid=mb.basket.n_grid, n_quotes=mb.basket.n_quotes,
        n_trades=mb.n_trades,
        tile=tmb.TileSpec(scale=np.asarray(mb.tile.scale),
                          base_trades=mb.tile.base_trades))
    tab = tmb.sweep_tables_from_cols(tmb.expanded_cols(inp, "cpu"),
                                     mb.n_trades, vT.shape[0])
    return vT, tab


@pytest.mark.parametrize("n_scen", [1, 4])
def test_pvs_sweep_plain_matches_jax(jbook, n_scen):
    dfs = _dfs(n_scen, jbook.basket.n_grid, n_scen)
    ref = _jax_pvs(jbook, dfs)                          # [S, B]
    vT, tab = _port_pvs_inputs(jbook, dfs)
    kernels.pvs_sweep.launches = 0
    got = kernels.pvs_sweep(vT, tab).numpy()
    assert kernels.pvs_sweep.launches == 0
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())


def _random_buckets(rng, M, B, shapes, dup_frac=0.3, dead_frac=0.25):
    """Column buckets [(col [R, L], w [R, L], row_trade [R])] with dead
    slots (w = 0), columns repeated within a row and across a trade's
    rows, and trade B - 1 owning only dead slots."""
    out = []
    for R, L in shapes:
        c = rng.integers(0, M, (R, L))
        dup = rng.random((R, L)) < dup_frac
        c[:, 1:] = np.where(dup[:, 1:], c[:, :1], c[:, 1:])
        w = rng.normal(size=(R, L))
        w[rng.random((R, L)) < dead_frac] = 0.0
        rt = rng.integers(0, B - 1, R)
        rt[0] = B - 1
        w[0] = 0.0
        out.append((c.astype(np.int32), w, rt))
    return out


def _bucketed_pvs(vT, bks, B):
    """The computation the tables replace: per padded row, the weighted
    sum of its slots' value rows; per trade, the sum of its rows."""
    out = np.zeros((B, vT.shape[1]))
    for c, w, rt in bks:
        np.add.at(out, rt, np.einsum("rl,rls->rs", w, vT[c]))
    return out.T


def _tables(bks, B, M):
    def flat(f):
        return torch.tensor(np.concatenate([f(*b).ravel() for b in bks]))

    return kernels.sweep_tables(
        flat(lambda c, w, rt: np.broadcast_to(rt[:, None], c.shape)),
        flat(lambda c, w, rt: c), flat(lambda c, w, rt: w), B, M)


def test_pvs_sweep_plain_random_tables():
    """Random tables, ragged buckets and dead trade slots: the twin
    against a direct numpy evaluation of the same sums."""
    rng = np.random.default_rng(3)
    M, S, B = 50, 7, 11
    vT = rng.normal(size=(M, S))
    bks = _random_buckets(rng, M, B, [(5, 3), (9, 1), (4, 8)])
    ref = _bucketed_pvs(vT, bks, B)
    got = kernels.pvs_sweep(torch.tensor(vT), _tables(bks, B, M)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())


@pytest.mark.parametrize("S", [1, 3, 33])
def test_sweep_tables_match_bucketed(S):
    """The per-trade CSR and trade blocks (5 of them, the last short)
    give the bucketed [S, B]; the tables hold each (trade, column) once
    with its merged weight, slot rows ascending within a trade, and each
    block's distinct rows once, ascending."""
    rng = np.random.default_rng(40 + S)
    M, B = 90, 150
    vT = rng.normal(size=(M, S))
    bks = _random_buckets(rng, M, B, [(60, 2), (90, 5), (30, 11)])
    ref = _bucketed_pvs(vT, bks, B)
    w_ref = np.zeros((B, M))
    for c, w, rt in bks:
        np.add.at(w_ref, (np.broadcast_to(rt[:, None], c.shape), c), w)
    block = kernels.SWEEP_BLOCK
    tab = _tables(bks, B, M)
    got = kernels.pvs_sweep_plain(torch.tensor(vT), tab).numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())
    t, c = tab.slot_trade().numpy(), tab.slot_col().numpy()
    assert len(set(zip(t.tolist(), c.tolist()))) == t.shape[0]
    dense = np.zeros((B, M))
    dense[t, c] = tab.slot_w.numpy()
    np.testing.assert_allclose(dense, w_ref, rtol=0, atol=1e-14)
    tptr = tab.tptr.numpy()
    assert tptr[B - 1] == tptr[B]                # only dead slots
    row = tab.slot_row.numpy()
    for b in range(B):
        assert np.all(np.diff(row[tptr[b]:tptr[b + 1]]) > 0)
    bptr, brow = tab.bptr.numpy(), tab.brow.numpy()
    assert bptr.shape[0] == -(-B // block) + 1 > 2
    for k in range(bptr.shape[0] - 1):
        mine = brow[bptr[k]:bptr[k + 1]]
        assert np.all(np.diff(mine) > 0)
        sel = t // block == k
        assert set(mine.tolist()) == set(c[sel].tolist())


def test_sweep_tables_reuse_on_test_book(jbook):
    """On the tiled test book each trade block stages fewer distinct
    rows than it has live slots."""
    vT, tab = _port_pvs_inputs(jbook, _dfs(1, jbook.basket.n_grid, 0))
    nnz, n_rows = tab.slot_w.shape[0], tab.brow.shape[0]
    live = sum(int((np.asarray(c.w) != 0).sum()) for c in jbook.cols) \
        * jbook.tile.scale.shape[0]
    assert nnz <= live
    assert n_rows < nnz
    assert tab.tptr.shape[0] == jbook.n_trades + 1


@pytest.mark.parametrize("n_scen", [1, 3])
def test_gamma_quad_form_grouped_plain_matches_jax(jbook, n_scen):
    basket = jbook.basket
    N, n_grid = basket.n_quotes, basket.n_grid
    rng = np.random.default_rng(10 + n_scen)
    J = rng.normal(size=(n_scen, N, n_grid))
    dfs = _dfs(n_scen, n_grid, 20 + n_scen)
    groups = jmb._term1_trip_groups(basket, jbook.aggregate)
    ref = np.stack([np.asarray(jmb._gamma_quad_form_grouped(
        jnp.asarray(J[s]), jnp.asarray(dfs[s]), jbook.aggregate, None,
        groups)) for s in range(n_scen)])
    tab = kernels.quad_tables(tmb.trip_group_arrays(groups, jbook.aggregate),
                              N)
    kernels.gamma_quad_form_grouped.launches = 0
    got = kernels.gamma_quad_form_grouped(torch.tensor(J),
                                          torch.tensor(dfs), tab).numpy()
    assert kernels.gamma_quad_form_grouped.launches == 0
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())


def _group(rows, T, n_grid, seed):
    r = np.random.default_rng(seed)
    return dict(s_idx=r.integers(0, n_grid, T),
                e_idx=r.integers(0, n_grid, T),
                p_idx=r.integers(0, n_grid, T),
                rows=np.asarray(rows), w=r.normal(size=T))


def test_gamma_quad_form_grouped_overlapping_groups():
    """Groups that share quote rows accumulate: two groups on the same
    rows equal one group holding both trip sets."""
    rng = np.random.default_rng(4)
    S, N, n_grid = 2, 9, 30
    J = torch.tensor(rng.normal(size=(S, N, n_grid)))
    dfs = torch.tensor(rng.uniform(0.5, 1.0, (S, n_grid)))
    g1 = _group([1, 2, 5, 7], 6, n_grid, 1)
    g2 = _group([1, 2, 5, 7], 4, n_grid, 2)
    both = {k: np.concatenate([g1[k], g2[k]]) if k != "rows" else g1[k]
            for k in g1}
    a = kernels.gamma_quad_form_grouped(J, dfs, kernels.quad_tables(
        [g1, g2], N))
    b = kernels.gamma_quad_form_grouped(J, dfs, kernels.quad_tables(
        [both], N))
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                               atol=1e-12 * float(b.abs().max()))
    assert float(a[:, 0].abs().max()) == 0.0


def _xccy_groups():
    model = cases.build_xccy_model("adrates_torch")
    mb = cases.compile_xccy_book("adrates_torch", model)
    groups = tmb._term1_trip_groups(mb.basket, mb.aggregate)
    return tmb.trip_group_arrays(groups, mb.aggregate), mb.basket.n_quotes


def _random_groups():
    rng = np.random.default_rng(8)
    N, n_grid = 40, 70
    shared = np.arange(10, 22)
    rows = [np.concatenate([np.arange(0, 6), shared]), shared,
            np.concatenate([shared, np.arange(30, 37)]), np.arange(37, 40),
            rng.choice(N, 9, replace=False)]
    return [_group(r, T, n_grid, i) for i, (r, T) in
            enumerate(zip(rows, [13, 0, 21, 5, 17]))], N


@pytest.mark.parametrize("which", ["xccy_book", "random"])
def test_quad_tables_reduction(which):
    """Every G entry sums exactly the blocks of the groups that hold both
    of its rows, in group order; each partial slot feeds one entry; the
    work list holds each group (none is wider than one item) once, widest
    first; each group keeps its trips, sorted by column."""
    groups, N = _xccy_groups() if which == "xccy_book" else _random_groups()
    if which == "xccy_book":
        k_of = [len(g["rows"]) for g in groups]
        assert len(set(k_of)) > 1
        sets = [set(g["rows"].tolist()) for g in groups]
        assert any(a & b for n, a in enumerate(sets) for b in sets[n + 1:])
    tab = kernels.quad_tables(groups, N)
    poff = tab.poff.numpy()
    red_ptr, red_src = tab.red_ptr.numpy(), tab.red_src.numpy()
    assert sorted(red_src.tolist()) == list(range(tab.n_part))
    for i in range(N):
        for j in range(N):
            want = []
            for g, grp in enumerate(groups):
                pos = {int(r): n for n, r in enumerate(grp["rows"])}
                if i in pos and j in pos:
                    want.append(poff[g] + pos[i] * len(pos) + pos[j])
            e = i * N + j
            assert red_src[red_ptr[e]:red_ptr[e + 1]].tolist() == want
    items = tab.items.numpy()
    assert sorted(items[:, 0].tolist()) == list(range(len(groups)))
    ks = [len(groups[g]["rows"]) for g in items[:, 0]]
    assert items[:, 1:].tolist() == [[0, k, 0, 0] for k in ks]
    assert ks == sorted(ks, reverse=True)
    tptr = tab.tptr.numpy()
    for g, grp in enumerate(groups):
        sl = slice(tptr[g], tptr[g + 1])
        trips = list(zip(tab.e_idx.numpy()[sl], tab.s_idx.numpy()[sl],
                         tab.p_idx.numpy()[sl], tab.w.numpy()[sl]))
        assert trips == sorted(trips, key=lambda x: x[:3])
        assert sorted(trips) == sorted(zip(
            np.asarray(grp["e_idx"]), np.asarray(grp["s_idx"]),
            np.asarray(grp["p_idx"]), np.asarray(grp["w"])))


@pytest.mark.parametrize("k", [1, 5, 72, 80, 81, 96, 130])
def test_quad_items_cover_each_group_once(k):
    """The work list covers each group's k x k block exactly once (an
    item's part and its mirror), no item stages more than QUAD_ITEM_K
    rows, and the items run largest first: one item up to QUAD_ITEM_K
    rows, chunk pairs beyond."""
    n_grid = 20
    groups = [_group(np.arange(k), 7, n_grid, 1),
              _group(np.arange(3), 30, n_grid, 2)]
    tab = kernels.quad_tables(groups, k + 1)
    items = tab.items.numpy()
    assert tab.item_rows <= kernels.QUAD_ITEM_K
    cover = {0: np.zeros((k, k), dtype=int), 1: np.zeros((3, 3), dtype=int)}
    for g, a0, na, b0, nb in items.tolist():
        if nb == 0:
            cover[g][a0:a0 + na, a0:a0 + na] += 1
        else:
            assert a0 + na <= b0
            cover[g][a0:a0 + na, b0:b0 + nb] += 1
            cover[g][b0:b0 + nb, a0:a0 + na] += 1
    for c in cover.values():
        assert np.all(c == 1)
    want = 1 if k <= kernels.QUAD_ITEM_K else \
        (lambda n: n * (n + 1) // 2)(-(-k // (kernels.QUAD_ITEM_K // 2)))
    assert int((items[:, 0] == 0).sum()) == want
    rows = (items[:, 2] + items[:, 4]).tolist()
    assert rows == sorted(rows, reverse=True)


def _items_emulated(J, dfs, groups, tab):
    """G built item by item, as the kernel builds it: each item's part of
    w (X Yᵀ + Y Xᵀ) from the J values of its rows only."""
    S, N, _ = J.shape
    G = np.zeros((S, N, N))
    for g, a0, na, b0, nb in tab.items.numpy().tolist():
        grp = groups[g]
        r = np.asarray(grp["rows"])
        ra = r[a0:a0 + na]
        rb = ra if nb == 0 else r[b0:b0 + nb]
        s_, e, p = grp["s_idx"], grp["e_idx"], grp["p_idx"]
        for k in range(S):
            a, b, c = dfs[k, s_], dfs[k, e], dfs[k, p]

            def xy(rr):
                Jr = J[k][rr]
                return ((Jr[:, s_] - (a / b) * Jr[:, e]) / b * grp["w"],
                        Jr[:, p] - (c / b) * Jr[:, e])
            (xa, ya), (xb, yb) = xy(ra), xy(rb)
            blk = xa @ yb.T + ya @ xb.T
            G[k][np.ix_(ra, rb)] += blk
            if nb:
                G[k][np.ix_(rb, ra)] += blk.T
    return G


def test_gamma_plain_takes_groups_wider_than_the_kernel():
    """Neither the twin nor the work list has a width limit: a group of
    QUAD_ITEM_K + 10 rows against a direct numpy evaluation of
    w (X Yᵀ + Y Xᵀ), and the same G built item by item from the work
    list (three 40-row chunks: six items), as the kernel builds it."""
    rng = np.random.default_rng(12)
    S, N, n_grid = 2, kernels.QUAD_ITEM_K + 14, 40
    g = _group(np.arange(2, kernels.QUAD_ITEM_K + 12), 23, n_grid, 5)
    J = rng.normal(size=(S, N, n_grid))
    dfs = rng.uniform(0.5, 1.0, (S, n_grid))
    got = kernels.gamma_quad_form_grouped(
        torch.tensor(J), torch.tensor(dfs),
        kernels.quad_tables([g], N)).numpy()
    r, s_, e, p = g["rows"], g["s_idx"], g["e_idx"], g["p_idx"]
    ref = np.zeros((S, N, N))
    for k in range(S):
        a, b, c = dfs[k, s_], dfs[k, e], dfs[k, p]
        Jr = J[k][r]
        X = (Jr[:, s_] - (a / b) * Jr[:, e]) / b
        Y = Jr[:, p] - (c / b) * Jr[:, e]
        Z = (X * g["w"]) @ Y.T
        ref[k][np.ix_(r, r)] = Z + Z.T
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())
    tab = kernels.quad_tables([g], N)
    assert tab.items.shape[0] == 6
    np.testing.assert_allclose(_items_emulated(J, dfs, [g], tab), ref,
                               rtol=0, atol=1e-12 * np.abs(ref).max())


def test_wrappers_build_nothing_for_cpu_tensors(tmp_path, monkeypatch):
    """The plain path never reaches nvcc or the kernel library."""
    monkeypatch.setattr(kernels, "build_kernels", lambda: 1 / 0)
    vT = torch.ones((3, 2), dtype=torch.float64)
    tab = kernels.sweep_tables(torch.zeros(1, dtype=torch.int64),
                               torch.zeros(1, dtype=torch.int64),
                               torch.ones(1, dtype=torch.float64), 1, 3)
    assert kernels.pvs_sweep(vT, tab).shape == (2, 1)
    g = _group([0, 2], 3, 4, 0)
    J = torch.ones((2, 3, 4), dtype=torch.float64)
    dfs = torch.full((2, 4), 0.9, dtype=torch.float64)
    assert kernels.gamma_quad_form_grouped(
        J, dfs, kernels.quad_tables([g], 3)).shape == (2, 3, 3)
    k3 = kernels.pertrade_tables([np.arange(2)], [1], [0], [0], [1], [2])
    assert kernels.pertrade_quad_form(
        torch.ones((4, 3), dtype=torch.float64), dfs[0],
        torch.ones(1, dtype=torch.float64), k3)[0].shape == (1, 2, 2)


def _k3_case(rng, N, n_grid, groups):
    """Slot tables over ``groups`` ([(rows, n_items, trips, clamps)]):
    random trips, and clamp slots with index alphas, spreads and bands
    that put about half of them inside the band (and one without an
    index alpha), as the harvest's named columns; items numbered group
    by group."""
    tr, cl = [], []
    base = 0
    for rows, n_items, n_tr, n_cl in groups:
        b = rng.integers(0, n_items, n_tr) + base
        tr.append(np.stack([b, *rng.integers(0, n_grid, (3, n_tr)),
                            rng.normal(0.0, 1e6, n_tr)], axis=1))
        b = rng.integers(0, n_items, n_cl) + base
        ia = rng.uniform(0.2, 0.6, n_cl)
        ia[:1] = 0.0
        lo = rng.uniform(-0.2, 0.0, n_cl)
        cap = lo + rng.uniform(0.0, 0.4, n_cl)
        cl.append(np.stack([b, *rng.integers(0, n_grid, (3, n_cl)), ia,
                            rng.normal(0.0, 1e6, n_cl),
                            rng.normal(0.0, 0.01, n_cl), cap, lo], axis=1))
        base += n_items
    return tmb._slot_dict(np.zeros((0, 3)), np.concatenate(tr),
                          np.concatenate(cl))


def _k3_dense_reference(Jt, dfs, tb, groups):
    """Each item's block as the sum over its slots of Jg H Jgᵀ: H the
    slot's 3 x 3 DF Hessian (of w (a/b - 1) c for a trip; of
    w clip((a/b - 1)/ia + spread, floor, cap) c for a clamp slot, which is
    the trip's times 1/ia inside the band and 0 outside it or without an
    index alpha), Jg the [k, 3] quote jacobians of its three DFs."""
    out, base = [], 0
    for rows, n_items, _, _ in groups:
        out.append(np.zeros((n_items, len(rows), len(rows))))
    ibase = np.cumsum([0] + [g[1] for g in groups])

    def add(b, s, e, p, w):
        g = int(np.searchsorted(ibase, b, side="right") - 1)
        rows = groups[g][0]
        a_, b_, c_ = dfs[s], dfs[e], dfs[p]
        H = w * np.array([[0.0, -c_ / b_**2, 1.0 / b_],
                          [-c_ / b_**2, 2 * a_ * c_ / b_**3, -a_ / b_**2],
                          [1.0 / b_, -a_ / b_**2, 0.0]])
        Jg = Jt[[s, e, p]][:, rows].T
        out[g][b - ibase[g]] += Jg @ H @ Jg.T

    for i in range(tb["tr_b"].shape[0]):
        add(tb["tr_b"][i], tb["tr_s"][i], tb["tr_e"][i], tb["tr_p"][i],
            tb["tr_w"][i])
    for i in range(tb["cl_b"].shape[0]):
        ia = tb["cl_ia"][i]
        u, v = dfs[tb["cl_s"][i]], dfs[tb["cl_e"][i]]
        pre = ((u / v - 1.0) / ia if ia > 0 else 0.0) + tb["cl_sp"][i]
        if ia > 0 and tb["cl_lo"][i] < pre < tb["cl_cap"][i]:
            add(tb["cl_b"][i], tb["cl_s"][i], tb["cl_e"][i], tb["cl_p"][i],
                tb["cl_w"][i] / ia)
    return out


@pytest.mark.parametrize("which", ["ragged", "full_width"])
def test_pertrade_quad_form_plain_matches_dense_reference(which):
    """K3's twin on trip and clamp slots (in and out of the band) against
    an independent dense reference: groups of ragged width with items
    that have no slot, and one group at the full width k = N = 184."""
    rng = np.random.default_rng(7 if which == "ragged" else 8)
    N, n_grid = 184, 300
    if which == "ragged":
        groups = [(np.sort(rng.choice(N, k, replace=False)), n, t, c)
                  for k, n, t, c in ((1, 2, 5, 2), (5, 3, 40, 9),
                                     (37, 6, 70, 30), (33, 4, 0, 6))]
    else:
        groups = [(np.arange(N), 3, 50, 20)]
    tb = _k3_case(rng, N, n_grid, groups)
    Jt = rng.normal(size=(n_grid, N))
    dfs = rng.uniform(0.5, 1.0, n_grid)
    ref = _k3_dense_reference(Jt, dfs, tb, groups)
    tab = tmb._k3_tables(tb, [g[0] for g in groups], [g[1] for g in groups],
                         "cpu")
    dfs_t = torch.tensor(dfs)
    w = tmb._k3_weights(dfs_t, tmb._tables_to(tb, "cpu"))
    inside = (w[tb["tr_b"].shape[0]:] != 0).sum()
    assert 0 < inside < tb["cl_b"].shape[0]
    before = kernels.pertrade_quad_form.launches
    got = kernels.pertrade_quad_form(torch.tensor(Jt), dfs_t, w, tab)
    assert kernels.pertrade_quad_form.launches == before
    assert len(got) == len(groups)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=1e-12 * np.abs(r).max())
        assert torch.equal(g, g.transpose(1, 2))


def _k3_emulated(Jt, dfs, w, tab):
    """K3's launch as the kernel runs it, in numpy: each pack's units on
    their rows and warps, each unit's block from its slots, written where
    its upper-triangle tiles and their mirrors land (a symmetric unit's
    lower entries from its upper ones). Returns (per group blocks, the
    write count of every output entry) and asserts the pack limits and
    the unit columns on the way."""
    W, TPW = kernels.PERTRADE_WARPS, kernels.PERTRADE_TPW
    iptr, igrp, qptr, qrows = (x.numpy().astype(np.int64) for x in (
        tab.iptr, tab.igrp, tab.qptr, tab.qrows))
    k_of = np.asarray(tab.ks)[igrp]
    ioff = np.cumsum(k_of * k_of) - k_of * k_of
    s, e, p = (x.numpy().astype(np.int64) for x in (tab.s_idx, tab.e_idx,
                                                    tab.p_idx))
    ws = w[tab.order.numpy()]
    out = np.full(tab.n_out, np.nan)
    writes = np.zeros(tab.n_out, dtype=np.int64)
    units = tab.units.numpy().astype(np.int64)
    assert units.shape[1] == 13
    prows = tab.prows.numpy()
    row0 = 0
    for u0, u1, nseg, n_rows, r0 in tab.packs.numpy():
        assert r0 == row0
        row0 += n_rows
        assert 0 < n_rows <= tab.rows_max <= kernels.PERTRADE_ROWS
        assert n_rows % 8 == 0 and 0 < u1 - u0 <= W
        warps = np.zeros(W, dtype=np.int64)
        row_end = 0
        for (item, a0, na, b0, nb, roff, w0, nw, lo, hi, qoff, k,
             blk) in units[u0:u1]:
            g = igrp[item]
            assert (lo, hi, qoff, k, blk) == (
                iptr[item], iptr[item + 1], qptr[g], qptr[g + 1] - qptr[g],
                ioff[item])
            kpa, kpb = -(-na // 16) * 16, -(-nb // 8) * 8
            assert roff == row_end
            row_end += kpa + kpb
            assert nw >= 1 and w0 + nw <= W
            warps[w0:w0 + nw] += 1
            assert -(-(hi - lo) // kernels.PERTRADE_SEG) <= nseg
            tiles = int(kernels._tiles(na, nb))
            assert -(-tiles // nw) <= TPW
            staged = prows[r0 + roff:r0 + roff + kpa + kpb]
            assert (staged[:, 1] == np.searchsorted(
                units[u0:u1, 5], roff, side="right") - 1).all()
            loc = np.concatenate([a0 + np.arange(na), b0 + np.arange(nb)])
            q = qrows[qoff + loc]
            np.testing.assert_array_equal(
                staged[:, 0], np.concatenate([
                    q[:na], np.full(kpa - na, -1), q[na:],
                    np.full(kpb - nb, -1)]))
            sl = slice(lo, hi)
            a, b, c = dfs[s[sl]], dfs[e[sl]], dfs[p[sl]]
            X = (Jt[s[sl]][:, q] - (a / b)[:, None] * Jt[e[sl]][:, q]) \
                * (ws[sl] / b)[:, None]
            Y = Jt[p[sl]][:, q] - (c / b)[:, None] * Jt[e[sl]][:, q]
            P = X.T @ Y + Y.T @ X
            if nb == 0:
                P = np.triu(P) + np.triu(P, 1).T
                ri, ci = np.meshgrid(loc, loc, indexing="ij")
                v = P
            else:
                Pab = P[:na, na:]
                ra, cb = np.meshgrid(loc[:na], loc[na:], indexing="ij")
                ri = np.concatenate([ra.ravel(), cb.ravel()])
                ci = np.concatenate([cb.ravel(), ra.ravel()])
                v = np.concatenate([Pab.ravel(), Pab.ravel()])
            at = blk + ri.ravel() * k + ci.ravel()
            out[at] = np.ravel(v)
            np.add.at(writes, at, 1)
        assert row_end == n_rows
        assert (warps <= 1).all()
    return tab.blocks(torch.tensor(out)), writes


def _k3_slot_items(rng, n_items, n_slots, case):
    if case != "flagship_like":
        return rng.integers(0, sum(n_items), n_slots)
    # most items light, one 240-slot item, as on flagship_v5's 256 trades
    return np.concatenate([np.repeat(np.arange(1, n_items[0]), 8),
                           np.zeros(240, dtype=np.int64)])


@pytest.mark.parametrize("case", ["ragged", "packed_beside_wide",
                                  "chunked", "flagship_like"])
def test_pertrade_tables_cover_each_block_once(case):
    """The work list covers every item's k x k block exactly once (each
    unit's tiles and their mirrors, on the warps the pack gives it),
    units largest first; the slot CSR holds each slot once, by item; and
    the emulated launch equals the twin, exactly symmetric."""
    rng = np.random.default_rng(11)
    ks, n_items = {"ragged": ([1, 7, 8, 9, 32, 33, 97, 184],
                              [2, 3, 1, 2, 1, 3, 1, 2]),
                   "packed_beside_wide": ([12, 40, 72, 184],
                                          [30, 8, 6, 2]),
                   "chunked": ([185, 200, 12], [1, 2, 3]),
                   "flagship_like": ([184], [256])}[case]
    item = _k3_slot_items(rng, n_items, 300, case)
    n_slots, n_grid = item.shape[0], 50
    s, e, p = rng.integers(0, n_grid, (3, n_slots))
    tab = kernels.pertrade_tables([np.arange(k) for k in ks], n_items, item,
                                  s, e, p)
    assert tab.n_out == sum(n * k * k for n, k in zip(n_items, ks))
    counts = np.diff(tab.iptr.numpy())
    np.testing.assert_array_equal(counts, np.bincount(
        item, minlength=sum(n_items)))
    units = tab.units.numpy().astype(np.int64)
    work = kernels.pertrade_work(kernels._tiles(units[:, 2], units[:, 4]),
                                 counts[units[:, 0]],
                                 kernels._rows(units[:, 2], units[:, 4]))
    assert (np.diff(work) <= 0).all()
    np.testing.assert_array_equal(tab.s_idx.numpy(), s[tab.order.numpy()])
    np.testing.assert_array_equal(tab.sitem.numpy(), np.sort(item))
    Jt = rng.normal(size=(n_grid, max(ks)))
    dfs = rng.uniform(0.5, 1.0, n_grid)
    w = rng.normal(size=n_slots)
    got, writes = _k3_emulated(Jt, dfs, w, tab)
    assert (writes == 1).all()
    ref = kernels.pertrade_quad_form_plain(
        torch.tensor(Jt), torch.tensor(dfs), torch.tensor(w), tab)
    for g, r in zip(got, ref):
        assert torch.equal(g, g.transpose(1, 2))
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=0,
                                   atol=1e-12 * float(r.abs().max()))
    packs = tab.packs.numpy()
    k_of = np.repeat(ks, n_items)[units[:, 0]]
    if case == "packed_beside_wide":
        # small items share blocks beside the k = 184 items' units
        assert (packs[:, 1] - packs[:, 0]).max() > 1
        assert (k_of == 184).any() and (k_of == 12).any()
    if case == "chunked":
        assert (units[:, 4] > 0).any()
    if case == "flagship_like":
        # the light items whole on 16 warps, one block each; the heavy
        # one cut into chunk pairs
        light = units[:, 0] != 0
        assert (units[light, 2] == 184).all()
        assert (units[light, 7] == 16).all()
        assert (units[~light, 4] > 0).any() and (~light).sum() > 1
        assert len(packs) == 255 + (~light).sum() - (
            packs[:, 1] - packs[:, 0] - 1).sum()
