"""The slice end to end on the CPU: the port's make_multibook_fn against
the JAX package's on the same 3-curve OIS book, tiled x3, 3 scenarios —
once through the port's own host layer, once with the port's device layer
fed the JAX-compiled book through ``interop.multibook_from_numpy``.

Tolerances: pvs rtol 1e-11; delta 1e-9 x max|ref|; gamma 1e-8 x max|ref|.
Both sides take the structured risk split (the port's
``parallel/structured_risk.py``); a book compiled with
``batch_curves=False`` takes the generic split
(``adrates_tpu/parallel/multibook.py:1718-1743``) in both packages, and
the two splits agree to f64 noise (compare
tests/test_staged_risk.py:176-177).
"""

import numpy as np
import pytest

import adrates_tpu  # noqa: F401 — enables x64 for the JAX side
import torch_cases as cases
from adrates_tpu.parallel import multibook as jmb
from adrates_torch import interop
from adrates_torch.ops import kernels
from adrates_torch.parallel import multibook as tmb


@pytest.fixture(scope="module")
def jax_case():
    _, tiled = cases.compile_book("adrates_tpu",
                                  cases.build_model("adrates_tpu"))
    q0 = tiled.basket.quotes0
    sh = cases.shocks(tiled.basket.n_quotes)
    ref = {k: np.asarray(v)
           for k, v in jmb.make_multibook_fn(tiled)(q0, sh).items()}
    return tiled, q0, sh, ref


@pytest.fixture(scope="module")
def port_book():
    return cases.compile_book("adrates_torch",
                              cases.build_model("adrates_torch"))[1]


def _compare(out, ref):
    out = {k: v.numpy() for k, v in out.items()}
    assert sorted(out) == sorted(ref)
    np.testing.assert_allclose(out["pvs"], ref["pvs"], rtol=1e-11, atol=0)
    np.testing.assert_allclose(out["delta"], ref["delta"], rtol=0,
                               atol=1e-9 * np.abs(ref["delta"]).max())
    np.testing.assert_allclose(out["gamma"], ref["gamma"], rtol=0,
                               atol=1e-8 * np.abs(ref["gamma"]).max())


def test_port_host_and_device_match_jax(jax_case, port_book):
    _, q0, sh, ref = jax_case
    np.testing.assert_array_equal(port_book.basket.quotes0, q0)
    kernels.pvs_sweep.launches = 0
    kernels.gamma_quad_form_grouped.launches = 0
    fn = tmb.make_multibook_fn(port_book, device="cpu")
    assert fn.structured
    _compare(fn(q0, sh), ref)
    assert kernels.pvs_sweep.launches == 0
    assert kernels.gamma_quad_form_grouped.launches == 0


def test_generic_split_matches_jax(jax_case):
    _, q0, sh, ref = jax_case
    model = cases.build_model("adrates_torch")
    mb = tmb.compile_multibook(cases.build_trades("adrates_torch", model),
                               model, base_currency=tmb.CurrencyTypes.USD,
                               batch_curves=False)
    scale = np.random.default_rng(cases.SEED).uniform(0.5, 2.0, 3)
    fn = tmb.make_multibook_fn(tmb.tile_multibook(mb, 3, scale), "cpu")
    assert not fn.structured
    _compare(fn(q0, sh), ref)


def test_port_device_layer_on_jax_compiled_book(jax_case):
    tiled, q0, sh, ref = jax_case
    inputs = interop.multibook_from_numpy(**cases.jax_book_numpy(tiled))
    fn = tmb.make_multibook_fn(inputs, device="cpu")
    _compare(fn(q0, sh), ref)


def test_risk_and_pvs_halves(jax_case, port_book):
    _, q0, sh, ref = jax_case
    fn = tmb.make_multibook_fn(port_book, device="cpu")
    risk = fn.risk_only(q0, sh)
    assert sorted(risk) == ["delta", "gamma"]
    np.testing.assert_allclose(risk["delta"].numpy(), ref["delta"],
                               rtol=0, atol=1e-9 * np.abs(ref["delta"]).max())
    np.testing.assert_allclose(fn.pvs_only(q0, sh).numpy(), ref["pvs"],
                               rtol=1e-11, atol=0)


def test_delta_only_path(jax_case, port_book):
    tiled, q0, sh, _ = jax_case
    ref = jmb.make_multibook_fn(tiled, want_gamma=False)(q0, sh)
    out = tmb.make_multibook_fn(port_book, device="cpu",
                                want_gamma=False)(q0, sh)
    assert sorted(out) == ["delta", "pvs"]
    d = np.asarray(ref["delta"])
    np.testing.assert_allclose(out["delta"].numpy(), d, rtol=0,
                               atol=1e-9 * np.abs(d).max())


def test_scenario_chunks_compose(jax_case, port_book, monkeypatch):
    """A one-scenario chunk budget gives the same outputs as one chunk."""
    _, q0, sh, ref = jax_case
    monkeypatch.setattr(tmb, "RISK_CHUNK_BYTES", 1)
    fn = tmb.make_multibook_fn(port_book, device="cpu")
    assert fn.chunk(sh.shape[0]) == 1
    _compare(fn(q0, sh), ref)


def test_unreferenced_curve_has_zero_risk():
    """A curve with no trades keeps no grid column, so its quotes carry
    exactly-zero delta and gamma (the reference package behaves the
    same)."""
    model = cases.build_model("adrates_torch")
    trades = [t for t in cases.build_trades("adrates_torch", model)
              if t._currency.name != "EUR"]
    from adrates_torch.utils import CurrencyTypes
    with pytest.warns(UserWarning, match="EUR_OIS_ESTR"):
        mb = tmb.compile_multibook(trades, model,
                                   base_currency=CurrencyTypes.USD)
    sh = cases.shocks(mb.basket.n_quotes, 2)
    out = tmb.make_multibook_fn(mb, device="cpu")(mb.basket.quotes0, sh)
    eur = mb.basket.quote_slice("EUR_OIS_ESTR")
    assert float(out["delta"][:, eur].abs().max()) == 0.0
    assert float(out["gamma"][:, eur].abs().max()) == 0.0
    assert float(out["delta"].abs().max()) > 0.0


def test_clamp_slots_through_interop():
    """A JAX-compiled book with capped and floored FRN coupons (clamp
    slots) through the port's device layer: the clamp PV epilogue and the
    clamp quad form match the JAX package (tests/test_torch_credit.py
    holds the port's own compile of such a book)."""
    from adrates_tpu.trades.credit import FRN
    from adrates_tpu.utils import CurrencyTypes, CurveTypes, \
        DayCountTypes, FrequencyTypes
    model = cases.build_model("adrates_tpu")
    v = model.value_dt
    frn = dict(freq_type=FrequencyTypes.QUARTERLY,
               dc_type=DayCountTypes.ACT_365F,
               floating_index=CurveTypes.GBP_OIS_SONIA,
               currency=CurrencyTypes.GBP, face_value=5_000_000)
    trades = cases.build_trades("adrates_tpu", model)[:3] + [
        FRN(v, "5Y", quoted_margin=0.0015, cap_rate=0.045,
            floor_rate=0.02, **frn),
        FRN(v.add_months(-4), "3Y", quoted_margin=0.001, cap_rate=0.05,
            floor_rate=0.044, **frn)]
    mb = jmb.tile_multibook(
        jmb.compile_multibook(trades, model,
                              base_currency=CurrencyTypes.USD), 2,
        notional_scale=[0.7, 1.6])
    assert mb.clamp is not None and mb.clamp.w.shape[0] > 10
    q0 = mb.basket.quotes0
    sh = cases.shocks(mb.basket.n_quotes)
    ref = {k: np.asarray(v)
           for k, v in jmb.make_multibook_fn(mb)(q0, sh).items()}
    inputs = interop.multibook_from_numpy(**cases.jax_book_numpy(mb))
    _compare(tmb.make_multibook_fn(inputs, device="cpu")(q0, sh), ref)
