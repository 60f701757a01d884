"""Per-trade risk on the fitted interpolation schemes, against adrates_tpu
on the CPU: the per-trade delta ladders, the selected trades' dense
gammas and every trade's own gamma block on the recalibrated spline book
of ``torch_cases.spline_book`` (USD NATCUBIC_ZERO_RATES, GBP
PCHIP_LOG_DISCOUNT, GBP_USD_XCCY PCHIP_ZERO_RATES over them; the
all-kinds trades in USD, tiled x2), whose stages pad no fitted member.

Tolerance: 1e-10 x max|ref|."""

import numpy as np
import pytest
import torch

import adrates_tpu  # noqa: F401 — enables x64 for the JAX side
import torch_cases as tc
from adrates_tpu.parallel import multibook as jmb
from adrates_tpu.parallel import pertrade_blocks as jpb
from adrates_torch.parallel import multibook as tmb
from adrates_torch.parallel import pertrade_blocks as tpb


def _close(got, ref, tol=1e-10):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * max(np.abs(ref).max(), 1e-300))


@pytest.fixture(scope="module")
def book():
    jb = tc.spline_book("adrates_tpu", "a_recal")[1]
    return dict(jb=jb, tb=tc.spline_book("adrates_torch", "a_recal")[1],
                q0=jb.basket.quotes0)


def test_per_trade_ladders_match_jax(book):
    jb, tb, q0 = book["jb"], book["tb"], book["q0"]
    _close(tmb.make_per_trade_delta_fn(tb, "cpu")(q0),
           jmb.make_per_trade_delta_fn(jb)(q0))


def test_per_trade_gammas_match_jax(book):
    jb, tb, q0 = book["jb"], book["tb"], book["q0"]
    sel = tc.pertrade_selection(tb)
    _close(tmb.make_per_trade_gamma_fn(tb, sel, "cpu")(q0),
           jmb.make_per_trade_gamma_fn(jb, sel)(q0))


def test_per_trade_blocks_match_jax(book):
    jb, tb, q0 = book["jb"], book["tb"], book["q0"]
    ref = jpb.make_per_trade_gamma_blocks_fn(jb)(q0)
    got = tpb.make_per_trade_gamma_blocks_fn(tb, "cpu")(q0)
    assert [tuple(int(c) for c in g.cids) for g in ref] == \
        [g.cids for g in got]
    scale = max(float(np.abs(np.asarray(g.blocks)).max()) for g in ref)
    for a, b in zip(ref, got):
        np.testing.assert_allclose(b.blocks.numpy(), np.asarray(a.blocks),
                                   rtol=0, atol=1e-10 * scale)


