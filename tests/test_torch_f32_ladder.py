"""The f32 per-trade ladders (``make_per_trade_delta_fn(mb, device,
dtype=torch.float32)``, ROADMAP A.6) on the CPU, where K1's wrapper runs
its plain twin in f32: against the JAX package's
``make_per_trade_delta_fn(mb, dtype=jnp.float32)`` and against the port's
f64 ladders on the OIS, credit (clamp rows) and recalibrated OIS + XCCY
books of ``torch_cases``; the result is f32, the contraction goes
through ``kernels.pvs_sweep`` on f32 tables and an f32 value table whose
rows hold whole 16-byte pieces; the sharded f32 ladders across two gloo
processes equal the single-device ones.

Tolerance: the JAX package's reporting tolerance for its f32 ladders
(``tests/test_multibook_pertrade.py:80-81``): rtol 1e-4, atol 3e-6 x
max|f64 ladder|. The sharded f32 ladders sum each trade's slots in the
same order as the single-device ones: equal bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import adrates_tpu  # noqa: F401 — enables x64 for the JAX side
import torch_cases as tc
import torch_dist_cases as dc
from adrates_tpu.parallel import multibook as jmb
from adrates_torch.ops import kernels
from adrates_torch.parallel import multibook as tmb

BOOKS = ["ois", "credit", "xccy_recal"]


@pytest.fixture(scope="module", params=BOOKS)
def book(request):
    return dict(jb=tc.pertrade_book("adrates_tpu", request.param),
                tb=tc.pertrade_book("adrates_torch", request.param))


@pytest.fixture(scope="module")
def ladders(book):
    jb, tb = book["jb"], book["tb"]
    q0 = jb.basket.quotes0
    return dict(
        jax32=np.asarray(jmb.make_per_trade_delta_fn(jb, dtype=jnp.float32)(
            q0)),
        port32=tmb.make_per_trade_delta_fn(tb, "cpu",
                                           dtype=torch.float32)(q0),
        port64=tmb.make_per_trade_delta_fn(tb, "cpu")(q0).numpy())


def _reporting_close(got, ref, f64):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=3e-6 * np.abs(f64).max())


def test_f32_ladder_is_f32(ladders):
    assert ladders["port32"].dtype == torch.float32
    assert ladders["jax32"].dtype == np.float32


def test_f32_ladder_matches_jax_f32(ladders):
    _reporting_close(ladders["port32"], ladders["jax32"], ladders["port64"])


def test_f32_ladder_matches_f64(ladders):
    _reporting_close(ladders["port32"], ladders["port64"], ladders["port64"])


def test_f32_ladder_runs_k1_on_f32_tables(book, monkeypatch):
    tb = book["tb"]
    fn = tmb.make_per_trade_delta_fn(tb, "cpu", dtype=torch.float32)
    assert fn.sweep.slot_w.dtype == torch.float32
    assert fn.book.sweep.slot_w.dtype == torch.float64
    _, _, Jv = fn.prep(tb.basket.quotes0)
    assert Jv.dtype == torch.float32 and Jv.stride(0) % 4 == 0
    seen = []
    sweep = kernels.pvs_sweep
    monkeypatch.setattr(kernels, "pvs_sweep",
                        lambda vT, tab, **kw: seen.append(
                            (vT.dtype, tab.slot_w.dtype, kw))
                        or sweep(vT, tab, **kw))
    fn(tb.basket.quotes0)
    assert seen == [(torch.float32, torch.float32, {"trade_major": True})]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_value_table_rows_hold_whole_pieces(dtype):
    top = torch.arange(15.0, dtype=torch.float64).reshape(3, 5)
    out = tmb._even_rows(top, 2 * top[:2], dtype)
    assert out.dtype == dtype
    assert out.stride(0) == (6 if dtype == torch.float64 else 8)
    np.testing.assert_array_equal(out.double().numpy(),
                                  np.concatenate([top, 2 * top[:2]]))


def test_plain_twin_sums_in_f32():
    """The K1 twin on f32 inputs sums in f32 (one trade's two slots of
    1 and 1e-8: the f64 sum keeps the small one, the f32 sum drops it)."""
    vT = torch.tensor([[1.0], [1e-8]], dtype=torch.float64)
    tab = kernels.sweep_tables(torch.tensor([0, 0]), torch.tensor([0, 1]),
                               torch.tensor([1.0, 1.0],
                                            dtype=torch.float64), 1, 2)
    f64 = kernels.pvs_sweep(vT, tab)
    f32 = kernels.pvs_sweep(vT.float(), kernels.sweep_tables_as(
        tab, torch.float32))
    assert f32.dtype == torch.float32
    assert float(f64[0, 0]) == 1.0 + 1e-8 and float(f32[0, 0]) == 1.0


@pytest.fixture(scope="module")
def sharded32():
    return dc.run_ranks(2, dc.f32_ranks, timeout_s=600)


def test_sharded_f32_ladder_equals_single_device(sharded32):
    mb = dc.credit_book()
    ref = tmb.make_per_trade_delta_fn(mb, "cpu", dtype=torch.float32)(
        mb.basket.quotes0).numpy()
    whole = sharded32[0]["gathered"]
    assert whole.dtype == np.float32
    np.testing.assert_array_equal(whole[:mb.n_trades], ref)
    for res in sharded32:
        lo, hi = res["trade_range"]
        np.testing.assert_array_equal(res["block"], whole[lo:hi])
