"""The OIS + XCCY book end to end on the CPU: the port's
make_staged_multibook_fn and make_multibook_fn against the JAX
package's make_multibook_fn on the same book (USD, GBP and EUR OIS,
GBP_USD_XCCY; an OIS per currency, a basis swap, a GBP OIS under USD
collateral; tiled x2; 3 scenarios), with the XCCY curve recalibrated
in-graph and held as values; the staged chunk rule; the structured
split against the generic one; and the port's device layer fed the
JAX-compiled book through ``interop.multibook_from_numpy``.

Tolerances as tests/test_torch_multibook.py: pvs rtol 1e-11; delta
1e-9 x max|ref|; gamma 1e-8 x max|ref|."""

import numpy as np
import pytest

import adrates_tpu  # noqa: F401 — enables x64 for the JAX side
import torch_cases as cases
from adrates_tpu.parallel import multibook as jmb
from adrates_torch import interop
from adrates_torch.ops import kernels
from adrates_torch.parallel import multibook as tmb
from adrates_torch.utils import LibError


@pytest.fixture(scope="module", params=[True, False],
                ids=["recal", "values"])
def case(request):
    recal = request.param
    jb = cases.compile_xccy_book("adrates_tpu",
                                 cases.build_xccy_model("adrates_tpu"),
                                 recalibrate_xccy=recal)
    tm = cases.build_xccy_model("adrates_torch")
    tb = cases.compile_xccy_book("adrates_torch", tm,
                                 recalibrate_xccy=recal)
    q0 = jb.basket.quotes0
    sh = cases.shocks(jb.basket.n_quotes)
    ref = {k: np.asarray(v)
           for k, v in jmb.make_multibook_fn(jb)(q0, sh).items()}
    return dict(recal=recal, jb=jb, tm=tm, tb=tb, q0=q0, sh=sh, ref=ref)


def _compare(out, ref):
    out = {k: v.numpy() for k, v in out.items()}
    assert sorted(out) == sorted(ref)
    np.testing.assert_allclose(out["pvs"], ref["pvs"], rtol=1e-11, atol=0)
    np.testing.assert_allclose(out["delta"], ref["delta"], rtol=0,
                               atol=1e-9 * np.abs(ref["delta"]).max())
    np.testing.assert_allclose(out["gamma"], ref["gamma"], rtol=0,
                               atol=1e-8 * np.abs(ref["gamma"]).max())


def test_port_matches_jax(case):
    np.testing.assert_array_equal(case["tb"].basket.quotes0, case["q0"])
    kernels.pvs_sweep.launches = 0
    kernels.gamma_quad_form_grouped.launches = 0
    for make in (tmb.make_staged_multibook_fn, tmb.make_multibook_fn):
        fn = make(case["tb"], "cpu")
        _compare(fn(case["q0"], case["sh"]), case["ref"])
    assert fn.structured
    assert kernels.pvs_sweep.launches == 0
    assert kernels.gamma_quad_form_grouped.launches == 0


@pytest.mark.parametrize("max_chunk", [1, 2])
def test_staged_chunks_compose(case, max_chunk):
    """One-scenario chunks, and chunks of 2 over 3 scenarios (the last
    one zero-padded), give the same outputs."""
    fn = tmb.make_staged_multibook_fn(case["tb"], "cpu",
                                      max_chunk=max_chunk)
    assert fn.chunk(case["sh"].shape[0]) == max_chunk
    _compare(fn(case["q0"], case["sh"]), case["ref"])


def test_staged_chunk_rule(case):
    """Equalized chunks: the fewest chunks of at most the cap, then even
    sizes (S = 100 under a cap of 30 runs 4 x 25)."""
    fn = tmb.make_staged_multibook_fn(case["tb"], "cpu", max_chunk=30)
    assert [fn.chunk(s) for s in (100, 3, 31, 60)] == [25, 3, 16, 30]
    default = tmb.make_staged_multibook_fn(case["tb"], "cpu")
    n_grid = case["tb"].basket.n_grid
    assert default.chunk(100) == tmb.risk_chunk_size(
        case["tb"].basket.n_quotes, n_grid, 100) == 100


def test_structured_equals_generic(case):
    gb = cases.compile_xccy_book("adrates_torch", case["tm"],
                                 recalibrate_xccy=case["recal"],
                                 batch_curves=False)
    fn = tmb.make_multibook_fn(gb, "cpu")
    assert not fn.structured
    _compare(fn(case["q0"], case["sh"]), case["ref"])
    with pytest.raises(LibError, match="batch_curves=True"):
        tmb.make_staged_multibook_fn(gb, "cpu")


@pytest.mark.parametrize("structured", [True, False])
def test_device_layer_on_jax_compiled_book(case, structured):
    inputs = interop.multibook_from_numpy(
        **cases.jax_book_numpy(case["jb"], structured=structured))
    fn = tmb.make_multibook_fn(inputs, "cpu")
    assert fn.structured == structured
    _compare(fn(case["q0"], case["sh"]), case["ref"])
    if structured:
        staged = tmb.make_staged_multibook_fn(inputs, "cpu")
        _compare(staged(case["q0"], case["sh"]), case["ref"])


@pytest.mark.parametrize("staged", [True, False])
def test_warmup_then_call(case, staged):
    fn = tmb.warmup_multibook(case["tb"], case["sh"].shape[0], "cpu",
                              staged=staged)
    _compare(fn(case["q0"], case["sh"]), case["ref"])


def test_staged_delta_only(case):
    out = tmb.make_staged_multibook_fn(case["tb"], "cpu",
                                       want_gamma=False)(case["q0"],
                                                         case["sh"])
    assert sorted(out) == ["delta", "pvs"]
    d = case["ref"]["delta"]
    np.testing.assert_allclose(out["delta"].numpy(), d, rtol=0,
                               atol=1e-9 * np.abs(d).max())
    np.testing.assert_allclose(out["pvs"].numpy(), case["ref"]["pvs"],
                               rtol=1e-11, atol=0)


def test_regions_compose_to_gamma(case):
    """The regions A, B, C1, C2, D called one by one give the staged
    gamma."""
    import torch
    fn = tmb.make_staged_multibook_fn(case["tb"], "cpu")
    r = fn.regions
    q = torch.tensor(case["q0"][None, :] + case["sh"])
    a = r["A"](q)
    h2x, v_of = r["C1"](q, a["g"], a["carry"])
    gamma = r["D"](r["B"](a["J"], a["dfs"]), h2x,
                   r["C2"](q, a["g"], v_of))
    g = case["ref"]["gamma"]
    np.testing.assert_allclose(gamma.numpy(), g, rtol=0,
                               atol=1e-8 * np.abs(g).max())
    np.testing.assert_allclose(r["P"](a["dfs"]).numpy(),
                               case["ref"]["pvs"], rtol=1e-11, atol=0)
