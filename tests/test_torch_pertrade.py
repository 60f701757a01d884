"""Per-trade risk on the CPU: the port's per-trade delta ladders
(``make_per_trade_delta_fn``), selected-trade gammas
(``make_per_trade_gamma_fn``), curve-Hessian contraction
(``structured_risk.make_pertrade_curvehess``) and slot harvest against the
JAX package's, on the books of ``torch_cases`` tiled x2-3: the OIS book,
the OIS + XCCY book with its XCCY curve recalibrated and held, the credit
book (capped/floored FRN clamp slots), the inflation book and the
all-kinds book.

Tolerance: 1e-10 x max|ref| (f64, sums in another order)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import adrates_tpu  # noqa: F401 — enables x64 for the JAX side
import torch_cases as cases
from adrates_tpu.parallel import multibook as jmb
from adrates_tpu.parallel import structured_risk as jsr
from adrates_torch.ops import kernels
from adrates_torch.parallel import multibook as tmb
from adrates_torch.parallel import structured_risk as tsr
from adrates_torch.utils import LibError

BOOKS = cases.PERTRADE_BOOKS
build_book = cases.pertrade_book
selection = cases.pertrade_selection


def _close(got, ref, tol=1e-10):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * np.abs(ref).max())


@pytest.fixture(scope="module", params=BOOKS)
def book(request):
    name = request.param
    return dict(name=name, jb=build_book("adrates_tpu", name),
                tb=build_book("adrates_torch", name))


def test_ladders_match_jax(book):
    jb, tb = book["jb"], book["tb"]
    q0 = jb.basket.quotes0
    ref = jmb.make_per_trade_delta_fn(jb)(q0)
    before = kernels.pvs_sweep.launches
    got = tmb.make_per_trade_delta_fn(tb, "cpu")(q0)
    assert kernels.pvs_sweep.launches == before
    assert got.shape == (tb.n_trades, tb.basket.n_quotes)
    _close(got, ref)


def test_ladder_of_a_clamp_slot_without_index_matches_fd():
    """A clamp slot with no index alpha (ia = 0) pays its clamped spread
    alone, so in band it has no forward partials; the JAX package's
    ladder keeps them (its in-band mask ignores ia > 0), the port's
    does not. The trade's ladder against a central FD of its PV."""
    tb = build_book("adrates_torch", "credit")
    cl = tb.clamp
    ia, spread = np.array(cl.ia), np.array(cl.spread)
    ia[0], spread[0] = 0.0, 0.5 * (cl.floor[0] + cl.cap[0])
    tb = dataclasses.replace(tb, clamp=dataclasses.replace(
        cl, ia=ia, spread=spread))
    t = int(cl.slot_trade[0])
    q0 = np.asarray(tb.basket.quotes0)
    lad = tmb.make_per_trade_delta_fn(tb, "cpu")(q0)[t].numpy()
    pvs = tmb.make_multibook_fn(tb, "cpu", want_gamma=False).pvs_only
    h = 1e-6
    E = h * np.eye(q0.shape[0])
    fd = (pvs(q0, E)[:, t] - pvs(q0, -E)[:, t]).numpy() / (2 * h)
    np.testing.assert_allclose(lad, fd, rtol=0,
                               atol=1e-6 * np.abs(fd).max())


def test_selected_gamma_matches_jax(book):
    jb, tb = book["jb"], book["tb"]
    q0 = jb.basket.quotes0
    sel = selection(tb)
    ref = np.asarray(jmb.make_per_trade_gamma_fn(jb, sel)(q0))
    before = kernels.pertrade_quad_form.launches
    got = tmb.make_per_trade_gamma_fn(tb, sel, "cpu")(q0)
    assert kernels.pertrade_quad_form.launches == before
    _close(got, ref)
    # the same base trade in two copies: its gamma scales with the copy
    scale = np.asarray(tb.tile.scale)
    _close(got[1], got[0].numpy() * scale[1] / scale[0], 1e-12)


@pytest.mark.parametrize("restricted", [False, True],
                         ids=["all", "restricted"])
def test_curvehess_matches_jax(book, restricted):
    """The contraction of random DF-space gradients: on the book's grid
    axis (``restrict=None``), and on the full unique-time rows of one
    set of curves closed over XCCY parents (the XCCY curve and its
    parents where the book has one, else its first curve)."""
    jb, tb = book["jb"], book["tb"]
    basket = tb.basket
    if restricted:
        x = [c for c, s in enumerate(basket.specs) if s.kind == "xccy"]
        cids = sorted({x[0], basket.specs[x[0]].dom_id,
                       basket.specs[x[0]].for_id}) if x else [0]
        if x and not basket.recalibrate_xccy:
            cids = [x[0]]
        width = sum(basket.specs[c].n_quotes for c in cids)
        restrict = dict(cids=cids, width=width)
        n_cols = len(cids) * tb.unique_times.shape[0]
    else:
        restrict = None
        n_cols = basket.n_grid
    G = np.random.default_rng(cases.SEED).normal(0.0, 1e6, (3, n_cols))
    q0 = jb.basket.quotes0
    contract = jsr.make_pertrade_curvehess(jb.basket, restrict=restrict)
    ref = jax.jit(lambda q, g: contract(q, jb.basket.params, g))(q0, G)
    P = tmb._device_book(tmb.book_inputs(tb), "cpu", sweep=False,
                         quad=False).params
    so = tsr.make_pertrade_tensors(basket.topology())(
        torch.tensor(q0), P)
    got = tsr.make_pertrade_curvehess(basket.topology(), restrict)(
        so, torch.tensor(G))
    _close(got, ref)


def _rows(a: np.ndarray) -> np.ndarray:
    """The rows of a slot table in lexicographic order (a multiset)."""
    return a[np.lexsort(a.T[::-1])] if a.size else a


def test_harvest_tables_match_jax_loops(book):
    jb, tb = book["jb"], book["tb"]
    sel = selection(tb)
    ref = jmb._harvest_sel_tables(jb, sel)
    got = tmb._harvest_sel_tables(tb, sel)
    for pre, keys in (("lin", ("b", "c", "w")),
                      ("tr", ("b", "s", "e", "p", "w")),
                      ("cl", ("b", "s", "e", "p", "ia", "w", "sp", "cap",
                              "lo"))):
        a = np.stack([np.asarray(ref[f"{pre}_{k}"], np.float64)
                      for k in keys], axis=1)
        b = np.stack([np.asarray(got[f"{pre}_{k}"], np.float64)
                      for k in keys], axis=1)
        np.testing.assert_array_equal(_rows(b), _rows(a), err_msg=pre)
    assert got["tr_w"].size > 0


def test_generic_split_selected_gamma():
    """A book compiled without the stage topology takes the generic
    jacfwd(jacfwd(grids)) term 2, and matches the structured one."""
    from adrates_torch.utils import CurrencyTypes
    m = cases.build_model("adrates_torch")
    trades = cases.build_trades("adrates_torch", m)
    books = [cases.compile_tiled("adrates_torch", m, trades, n_copies=3,
                                 base_currency=CurrencyTypes.USD,
                                 batch_curves=batch)[1]
             for batch in (True, False)]
    sel = selection(books[0])
    q0 = books[0].basket.quotes0
    ref = tmb.make_per_trade_gamma_fn(books[0], sel, "cpu")(q0)
    _close(tmb.make_per_trade_gamma_fn(books[1], sel, "cpu")(q0),
           ref.numpy())


@pytest.mark.parametrize("where", ["below", "above"])
def test_selection_outside_the_book_raises(where):
    tb = build_book("adrates_torch", "ois")
    bad = -1 if where == "below" else tb.n_trades
    with pytest.raises(ValueError, match="trade ids outside"):
        tmb.make_per_trade_gamma_fn(tb, [0, bad], "cpu")


def test_per_trade_needs_a_multibook():
    m = cases.build_model("adrates_torch")
    inputs = tmb.book_inputs(cases.compile_book("adrates_torch", m)[1])
    with pytest.raises(LibError, match="MultiBook"):
        tmb.make_per_trade_delta_fn(inputs, "cpu")
