"""The port's book SPEED (``make_multibook_speed_fn``) against the JAX
package's, on the CPU, on ``torch_cases``' three-curve OIS book (N = 16)
and its lazily tiled copy (1e-10 x max|ref|); symmetric under both index
swaps and equal to a central FD of ``make_multibook_fn``'s gamma (the
JAX test's tolerances, ``tests/test_multibook_core.py:325-352``); the
N <= SPEED_MAX_QUOTES guard and ``force``; the device rule."""

import numpy as np
import pytest
import torch

import adrates_tpu.parallel.multibook as jmb
import adrates_torch.parallel.multibook as tmb
import torch_cases as tc
from adrates_torch.utils import LibError

PKGS = ("adrates_tpu", "adrates_torch")


@pytest.fixture(scope="module")
def books():
    """{pkg: (base multibook, tiled x3)}."""
    return {pkg: tc.compile_book(pkg, tc.build_model(pkg)) for pkg in PKGS}


@pytest.fixture(scope="module")
def speeds(books):
    """{(pkg, which): [N, N, N]} for which in (base, tiled)."""
    out = {}
    for pkg, mod in (("adrates_tpu", jmb), ("adrates_torch", tmb)):
        for which, mb in zip(("base", "tiled"), books[pkg]):
            q0 = np.asarray(mb.basket.quotes0)
            if mod is tmb:
                out[pkg, which] = mod.make_multibook_speed_fn(
                    mb, "cpu")(q0).numpy()
            else:
                out[pkg, which] = np.asarray(
                    mod.make_multibook_speed_fn(mb)(q0))
    return out


@pytest.mark.parametrize("which", ["base", "tiled"])
def test_speed_matches_jax(speeds, which):
    got, ref = speeds["adrates_torch", which], speeds["adrates_tpu", which]
    assert got.shape == ref.shape == (16, 16, 16)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-10 * np.abs(ref).max())


def test_speed_symmetric_and_fd_of_gamma(books, speeds):
    speed = speeds["adrates_torch", "base"]
    assert np.isfinite(speed).all()
    sym_atol = 1e-12 * (np.abs(speed).max() + 1.0)
    np.testing.assert_allclose(speed, np.swapaxes(speed, 0, 1), rtol=1e-9,
                               atol=sym_atol)
    np.testing.assert_allclose(speed, np.swapaxes(speed, 1, 2), rtol=1e-9,
                               atol=sym_atol)
    mb = books["adrates_torch"][0]
    q0 = np.asarray(mb.basket.quotes0)
    N = q0.shape[0]
    fn = tmb.make_multibook_fn(mb, "cpu")
    h = 1e-5
    scale = np.abs(speed).max() + 1.0
    for k in [1, N - 2]:
        sh = np.zeros((2, N))
        sh[0, k], sh[1, k] = h, -h
        g = fn(q0, sh)["gamma"].numpy()
        np.testing.assert_allclose(speed[:, :, k], (g[0] - g[1]) / (2 * h),
                                   rtol=5e-4, atol=1e-6 * scale)


def test_speed_tile_linearity(speeds):
    scale = np.random.default_rng(tc.SEED).uniform(0.5, 2.0, 3)
    base = speeds["adrates_torch", "base"]
    np.testing.assert_allclose(speeds["adrates_torch", "tiled"],
                               scale.sum() * base, rtol=1e-9,
                               atol=1e-10 * (np.abs(base).max() + 1.0))


def test_speed_guard(books, monkeypatch):
    """Above SPEED_MAX_QUOTES the builder raises with the JAX message;
    force=True overrides; at the threshold it builds unguarded."""
    mb = books["adrates_torch"][0]
    assert tmb.SPEED_MAX_QUOTES == jmb.SPEED_MAX_QUOTES == 64
    monkeypatch.setattr(tmb, "SPEED_MAX_QUOTES", mb.basket.n_quotes - 1)
    with pytest.raises(LibError, match="force=True"):
        tmb.make_multibook_speed_fn(mb, "cpu")
    assert callable(tmb.make_multibook_speed_fn(mb, "cpu", force=True))
    monkeypatch.setattr(tmb, "SPEED_MAX_QUOTES", mb.basket.n_quotes)
    assert callable(tmb.make_multibook_speed_fn(mb, "cpu"))


def test_speed_device_rule(books):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: None selects it")
    with pytest.raises(LibError, match="device='cpu'"):
        tmb.make_multibook_speed_fn(books["adrates_torch"][0])
