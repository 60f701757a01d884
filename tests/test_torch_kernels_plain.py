"""The plain torch twins of the two CUDA kernels against the JAX
functions they replace, on the same numpy inputs, to 1e-12 x max|ref|
(the two differ only in summation order). On CPU tensors the wrappers run
the twins and leave the launch counters at 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import adrates_tpu  # noqa: F401 — enables x64 for the JAX side
import torch_cases as cases
from adrates_tpu.parallel import multibook as jmb
from adrates_torch.ops import kernels


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
    """vT, the expanded column buckets and the trade table, from the JAX
    book's numpy tables (the expansion is the port's own)."""
    agg = mb.aggregate
    trips = ((dfs[:, agg.trip_s] / dfs[:, agg.trip_e] - 1.0)
             * dfs[:, agg.trip_p])
    vT = torch.tensor(np.concatenate([dfs, trips], axis=1).T.copy())
    n = mb.tile.scale.shape[0]
    bks = [(torch.tensor(np.tile(np.asarray(c.col_idx), (n, 1))),
            torch.tensor((mb.tile.scale[:, None, None]
                          * np.asarray(c.w)[None]).reshape(
                              -1, c.w.shape[1])))
           for c in mb.cols]
    tri = torch.tensor(jmb._trade_row_table(mb))
    return vT, bks, tri


@pytest.mark.parametrize("n_scen", [1, 4])
def test_pvs_sweep_plain_matches_jax(jbook, n_scen):
    dfs = _dfs(n_scen, jbook.basket.n_grid, n_scen)
    ref = _jax_pvs(jbook, dfs)                          # [S, B]
    vT, bks, tri = _port_pvs_inputs(jbook, dfs)
    kernels.pvs_sweep.launches = 0
    got = kernels.pvs_sweep(vT, bks, tri).T.numpy()
    assert kernels.pvs_sweep.launches == 0
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())


def test_pvs_sweep_plain_random_tables():
    """Random tables, ragged buckets and dead trade slots: the twin
    against a direct numpy evaluation of the same sums."""
    rng = np.random.default_rng(3)
    M, S = 50, 7
    vT = rng.normal(size=(M, S))
    bks = [(rng.integers(0, M, (R, L)).astype(np.int32),
            rng.normal(size=(R, L))) for R, L in [(5, 3), (9, 1), (4, 8)]]
    R_total = 18
    tri = rng.integers(0, R_total + 1, (11, 3)).astype(np.int32)
    rowpv = np.concatenate([np.einsum("rl,rls->rs", w, vT[c])
                            for c, w in bks] + [np.zeros((1, S))])
    ref = rowpv[tri].sum(axis=1)
    got = kernels.pvs_sweep(
        torch.tensor(vT), [(torch.tensor(c), torch.tensor(w))
                           for c, w in bks], torch.tensor(tri)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())


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
    tg = [dict(s_idx=torch.tensor(g["s_idx"]),
               e_idx=torch.tensor(g["e_idx"]),
               p_idx=torch.tensor(g["p_idx"]),
               rows=torch.tensor(np.concatenate(
                   [np.arange(o, o + n) for o, n in g["segs"]]
               ).astype(np.int32)),
               w=torch.tensor(np.asarray(jbook.aggregate.trip_w)[
                   g["tsel"]]))
          for g in groups]
    kernels.gamma_quad_form_grouped.launches = 0
    got = kernels.gamma_quad_form_grouped(torch.tensor(J),
                                          torch.tensor(dfs), tg).numpy()
    assert kernels.gamma_quad_form_grouped.launches == 0
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())


def test_gamma_quad_form_grouped_overlapping_groups():
    """Groups that share quote rows accumulate: two groups on the same
    rows equal one group holding both trip sets."""
    rng = np.random.default_rng(4)
    S, N, n_grid = 2, 9, 30
    J = torch.tensor(rng.normal(size=(S, N, n_grid)))
    dfs = torch.tensor(rng.uniform(0.5, 1.0, (S, n_grid)))

    def group(rows, T, seed):
        r = np.random.default_rng(seed)
        return dict(s_idx=torch.tensor(r.integers(0, n_grid, T)),
                    e_idx=torch.tensor(r.integers(0, n_grid, T)),
                    p_idx=torch.tensor(r.integers(0, n_grid, T)),
                    rows=torch.tensor(rows), w=torch.tensor(r.normal(size=T)))

    g1, g2 = group([1, 2, 5, 7], 6, 1), group([1, 2, 5, 7], 4, 2)
    both = {k: torch.cat([g1[k], g2[k]]) if k != "rows" else g1[k]
            for k in g1}
    a = kernels.gamma_quad_form_grouped(J, dfs, [g1, g2])
    b = kernels.gamma_quad_form_grouped(J, dfs, [both])
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                               atol=1e-12 * float(b.abs().max()))
    assert float(a[:, 0].abs().max()) == 0.0


def test_wrappers_build_nothing_for_cpu_tensors(tmp_path, monkeypatch):
    """The plain path never reaches nvcc or the kernel library."""
    monkeypatch.setattr(kernels, "build_kernels", lambda: 1 / 0)
    vT = torch.ones((3, 2), dtype=torch.float64)
    ci = torch.zeros((1, 1), dtype=torch.int32)
    w = torch.ones((1, 1), dtype=torch.float64)
    tri = torch.zeros((1, 1), dtype=torch.int32)
    assert kernels.pvs_sweep(vT, [(ci, w)], tri).shape == (1, 2)
