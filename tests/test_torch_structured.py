"""The structured risk split, part by part, against adrates_tpu on the
small OIS + XCCY book (USD, GBP and EUR OIS, GBP_USD_XCCY; an OIS per
currency, a basis swap and a GBP OIS under USD collateral, tiled x2;
3 scenarios; the XCCY parents carry a group-pad direction), with the
XCCY curve recalibrated in-graph and held as values: ``fwd_delta`` (dfs, g, J, delta), ``term1``, ``term2_xccy`` (H2
and every parent cotangent in ``v_of``) and ``term2_ois``. The JAX parts
run per scenario under ``jax.vmap``; the port's take the scenario batch.

Tolerances, each a multiple of the largest reference entry (measured
differences are f64 noise, below 1e-14 relative): dfs 1e-14; g, J and
delta 1e-11; term1, H2 and v_of 1e-10."""

import jax
import numpy as np
import pytest
import torch

import adrates_tpu  # noqa: F401 — enables x64 for the JAX side
import torch_cases as cases
from adrates_tpu.parallel import structured_risk as jsr
from adrates_torch.parallel import multibook as tmb
from adrates_torch.parallel import structured_risk as tsr


@pytest.fixture(scope="module", params=[True, False],
                ids=["recal", "values"])
def parts(request):
    recal = request.param
    jb = cases.compile_xccy_book("adrates_tpu",
                                 cases.build_xccy_model("adrates_tpu"),
                                 recalibrate_xccy=recal)
    tb = cases.compile_xccy_book("adrates_torch",
                                 cases.build_xccy_model("adrates_torch"),
                                 recalibrate_xccy=recal)
    q0 = jb.basket.quotes0
    sh = cases.shocks(jb.basket.n_quotes)

    jp = jsr.make_structured_parts(jb.basket, host_agg=jb.aggregate)
    P, agg = jb.basket.params, jb.aggregate
    jfw = jax.jit(jax.vmap(lambda s: jp["fwd_delta"](q0 + s, P, agg,
                                                     None)))(sh)
    jt1 = jax.vmap(lambda J, d: jp["term1"](J, d, agg, None))(
        jfw["J"], jfw["dfs"])
    jh2x, jv = jax.jit(jax.vmap(lambda s, g, c: jp["term2_xccy"](
        q0 + s, P, g, c)))(sh, jfw["g"], jfw["carry"])
    jh2o = jax.jit(jax.vmap(lambda s, g, v: jp["term2_ois"](
        q0 + s, P, g, v)))(sh, jfw["g"], jv)
    ref = dict(fw=jfw, t1=jt1, h2x=jh2x, v_of=jv, h2o=jh2o)
    ref = jax.tree.map(np.asarray, ref)

    book = tmb.make_multibook_fn(tb, "cpu").book
    tp = tsr.make_structured_parts(tmb.book_inputs(tb).topology)
    q = torch.tensor(q0[None, :] + sh)
    fw = tp["fwd_delta"](q, book.params, book.aggregate, book.clamp_agg)
    t1 = tmb._term1_fn(book)(fw["J"], fw["dfs"])
    h2x, v_of = tp["term2_xccy"](q, book.params, fw["g"], fw["carry"])
    h2o = tp["term2_ois"](q, book.params, fw["g"], v_of)
    got = dict(fw=fw, t1=t1, h2x=h2x, v_of=v_of, h2o=h2o)
    return recal, got, ref


def _close(got, ref, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * np.abs(ref).max())


@pytest.mark.parametrize("key,tol", [("dfs", 1e-14), ("g", 1e-11),
                                     ("J", 1e-11), ("delta", 1e-11)])
def test_fwd_delta(parts, key, tol):
    _, got, ref = parts
    _close(got["fw"][key], ref["fw"][key], tol)


def test_parent_quote_columns_of_the_xccy_rows(parts):
    """J's XCCY-curve columns have nonzero rows on the parents' quotes
    (USD and GBP, each padded by one group-pad direction that folds into
    its last quote) exactly when the curve is recalibrated in-graph, and
    exactly zero ones when it is held as values."""
    recal, got, ref = parts
    J, Jr = got["fw"]["J"].numpy(), ref["fw"]["J"]
    basis = slice(16, 19)                       # GBP_USD_XCCY's quotes
    xcols = np.flatnonzero(np.any(Jr[:, basis] != 0, axis=(0, 1)))
    parents = J[:, 6:16][:, :, xcols]           # GBP and USD quote rows
    assert (np.abs(parents).max() > 0) == recal
    np.testing.assert_allclose(parents, Jr[:, 6:16][:, :, xcols], rtol=0,
                               atol=1e-11 * np.abs(Jr).max())


def test_term1(parts):
    _, got, ref = parts
    _close(got["t1"], ref["t1"], 1e-10)


def test_term2_xccy_hessian(parts):
    _, got, ref = parts
    _close(got["h2x"], ref["h2x"], 1e-10)


def test_term2_xccy_parent_cotangents(parts):
    """Every parent cotangent, at 1e-10 of the largest one: the dom
    parent's (through the calibration legs, which telescope to PV 0 on
    one curve) is f64 noise beside the foreign parent's."""
    recal, got, ref = parts
    assert sorted(got["v_of"]) == sorted(ref["v_of"])
    assert bool(got["v_of"]) == recal
    scale = max((np.abs(v).max() for v in ref["v_of"].values()),
                default=0.0)
    for k, v in ref["v_of"].items():
        np.testing.assert_allclose(got["v_of"][k].numpy(), v, rtol=0,
                                   atol=1e-10 * scale, err_msg=k)


def test_term2_ois(parts):
    _, got, ref = parts
    _close(got["h2o"], ref["h2o"], 1e-10)


def test_fold_pads_and_place_hess():
    """Pad-duplicate directions fold into the last live one, and a
    member's local hessian lands at its segment blocks (added)."""
    x = torch.arange(12.0, dtype=torch.float64).reshape(1, 4, 3)
    f = tsr.fold_pads(x, 2, 1)
    assert f.tolist() == [[[0.0, 1.0, 2.0], [3 + 6 + 9.0, 4 + 7 + 10.0,
                                            5 + 8 + 11.0]]]
    assert tsr.fold_pads(x, 4, 1) is x
    H2 = torch.zeros((1, 6, 6), dtype=torch.float64)
    Hm = torch.ones((1, 5, 5), dtype=torch.float64)
    tsr.place_hess(H2, Hm, [(0, 2, 0, 3), (4, 2, 3, 2)])
    assert H2[0, :2, :2].tolist() == [[1.0, 2.0], [2.0, 4.0]]
    assert H2[0, 4:, 4:].tolist() == [[1.0, 1.0], [1.0, 1.0]]
    assert H2[0, :2, 4:].tolist() == [[1.0, 1.0], [2.0, 2.0]]
    assert float(H2[0, 2:4].abs().max()) == 0.0
