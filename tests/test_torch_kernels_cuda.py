"""The CUDA kernels against their plain twins, on the card.

Marked ``cuda``: every test skips (inside its fixture) where no CUDA
device is visible. On a machine with a card and without JAX, run

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels_cuda.py

(``--noconftest`` because the suite's conftest configures JAX).
"""

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


@pytest.mark.parametrize("S", [1, 33, 100])
def test_pvs_sweep_kernel_matches_plain(dev, S):
    rng = np.random.default_rng(S)
    M = 700
    vT = torch.tensor(rng.normal(size=(M, S)), device=dev)
    bks = []
    for R, L in [(13, 1), (300, 9), (41, 130)]:
        bks.append((torch.tensor(rng.integers(0, M, (R, L)),
                                 dtype=torch.int32, device=dev),
                    torch.tensor(rng.normal(size=(R, L)), device=dev)))
    tri = torch.tensor(rng.integers(0, 355, (170, 3)), dtype=torch.int32,
                       device=dev)
    before = kernels.pvs_sweep.launches
    got = kernels.pvs_sweep(vT, bks, tri)
    assert kernels.pvs_sweep.launches == before + len(bks) + 1
    ref = kernels.pvs_sweep_plain(vT, bks, tri)
    torch.cuda.synchronize()
    assert _rel_err(got, ref) <= 1e-12


@pytest.mark.parametrize("k", [5, 16, 37])
def test_gamma_kernel_matches_plain(dev, k):
    rng = np.random.default_rng(k)
    S, N, n_grid = 3, 60, 400

    def t(a, dtype=torch.float64):
        return torch.tensor(a, dtype=dtype, device=dev)

    J = t(rng.normal(size=(S, N, n_grid)))
    dfs = t(rng.uniform(0.5, 1.0, (S, n_grid)))
    groups = []
    for rows, T in [(np.arange(0, k), 45),
                    (np.sort(rng.choice(N, k, replace=False)), 70)]:
        groups.append(dict(
            s_idx=t(rng.integers(0, n_grid, T), torch.int32),
            e_idx=t(rng.integers(0, n_grid, T), torch.int32),
            p_idx=t(rng.integers(0, n_grid, T), torch.int32),
            rows=t(rows, torch.int32), w=t(rng.normal(size=T))))
    before = kernels.gamma_quad_form_grouped.launches
    got = kernels.gamma_quad_form_grouped(J, dfs, groups)
    assert kernels.gamma_quad_form_grouped.launches == before + 2
    ref = kernels.gamma_quad_form_grouped_plain(J, dfs, groups)
    torch.cuda.synchronize()
    assert _rel_err(got, ref) <= 1e-12


def test_wrappers_refuse_wrong_index_dtype(dev):
    vT = torch.ones((4, 2), dtype=torch.float64, device=dev)
    ci = torch.zeros((1, 1), dtype=torch.int64, device=dev)
    w = torch.ones((1, 1), dtype=torch.float64, device=dev)
    tri = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        kernels.pvs_sweep(vT, [(ci, w)], tri)


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
