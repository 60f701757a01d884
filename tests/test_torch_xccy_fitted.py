"""XCCY stages over fitted parent curves on K8-K11 (``ops/xccy_stage``),
on the CPU, where the wrappers run the plain versions (K6's and
K8-K11's).

The book: the credit trades on ``torch_cases.XCCY_FITTED_PARENTS`` (USD,
the domestic parent, PCHIP_ZERO_RATES; GBP, the foreign parent,
NATCUBIC_LOG_DISCOUNT; GBP_USD_XCCY FLAT_FWD_RATES) with quarterly
calibration legs, recalibrated in-graph and held as values. The two OIS
curves share one stage unpadded, so the JAX package's batched path fits
each on its own knots.

- Routes: the stage over fitted parents takes the kernels; a stage with a
  fitted member (``SPLINE_SCHEMES["a_recal"]``: GBP_USD_XCCY on
  PCHIP_ZERO_RATES) keeps torch.func, with its reason.
- The kernel route (the fitted parents lifted to their query grids by K6,
  K8-K11's plain versions, the grid cotangents taken back by K6's reverse
  mode with the curvature term) against the port's torch.func route
  (``_xccy_jac`` / ``_xccy_hess``) at 1e-12 x max|ref|: the rows'
  tangents, Jpv, gf, gdd, Hx2 and Hl, on calibration legs that do not
  telescope (a book's legs price to 0 on any curve, so their PVs and
  derivatives are rounding; here ``xccy_stage.probe_tables``' changes are
  made to the host legs that both routes read); and ``fwd_delta`` /
  ``term2_xccy`` (dfs, J, H2, the parent cotangents) on the book's own
  legs.
- The curvature term (``xccy_stage.pull_grid``) against the Hessian of
  g . F(x) by ``torch.func`` (1e-12).
- The book's pvs, delta and gamma (the structured split) against
  ``adrates_tpu`` at 1e-10 x max|ref|.
- On the CPU no kernel launch is counted.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd, jacrev

import adrates_tpu  # noqa: F401 — enables x64 for the JAX side
import torch_cases as tc
from adrates_tpu.parallel import multibook as jmb
from adrates_torch.ops import fitted_rows as tfr
from adrates_torch.ops import kernels
from adrates_torch.ops import xccy_stage as xs
from adrates_torch.parallel import multibook as tmb
from adrates_torch.parallel import structured_risk as tsr

KERNELS = ("xccy_stage_jvp", "xccy_legs_jvp", "xccy_stage_hess",
           "xccy_legs_hess", "fitted_eval", "fitted_eval_jvp",
           "fitted_rows", "fitted_rows_t")


def _launches():
    return [getattr(kernels, k).launches for k in KERNELS]


def _rel(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


def _xccy_si(topo):
    (si,) = [k for k, st in enumerate(topo.stages) if st.kind == "xccy"]
    return si


def _probe_legs(legs, seed):
    """The host calibration legs with ``xccy_stage.probe_tables``'
    changes (a seeded spread on every live coupon, the second coupon's
    index accrual 0, a fixed first coupon, a principal, the all-in rate
    capped and floored), so that they do not telescope."""
    rng = np.random.default_rng(seed)
    ia = np.array(legs.index_alphas, dtype=np.float64)
    spr = np.where(ia > 0, rng.normal(0.0, 2e-3, ia.shape),
                   np.asarray(legs.spreads))
    ia[..., 1] = 0.0
    full = np.ones(np.shape(legs.first_fixing_rate))
    return dataclasses.replace(
        legs, spreads=spr, index_alphas=ia,
        principal=np.asarray(legs.notionals)[..., -1].copy(),
        first_fixing_rate=0.02 * full, cap_rate=0.035 * full,
        floor_rate=0.002 * full, override_first=True, has_cap_floor=True)


def _routes(mb):
    """{"kernels" | "torch.func": (structured parts, device book)} on the
    CPU, the torch.func route with every XCCY stage off the kernels."""
    topo = tmb.book_inputs(mb).topology
    out = {}
    for route in ("kernels", "torch.func"):
        with pytest.MonkeyPatch.context() as mp:
            if route == "torch.func":
                mp.setattr(tsr, "stage_routes", lambda topo: {})
            book = tmb.make_multibook_fn(mb, "cpu").book
            out[route] = (tsr.make_structured_parts(topo), book)
    assert bool(out["kernels"][1].params["xstage"])
    assert not out["torch.func"][1].params["xstage"]
    return out


@pytest.fixture(scope="module", params=[True, False],
                ids=["recal", "values"])
def book(request):
    """(recal, the JAX book, the port's book, quotes [3, N])."""
    recal = request.param
    jb = tc.fitted_parent_book("adrates_tpu", recal)[1]
    tb = tc.fitted_parent_book("adrates_torch", recal)[1]
    q = jb.basket.quotes0[None, :] + tc.shocks(jb.basket.n_quotes)
    return recal, jb, tb, q


@pytest.fixture(scope="module")
def probe():
    """The recalibrated book with non-telescoping calibration legs: its
    two routes, its XCCY stage and quotes [3, N]."""
    mb = tc.fitted_parent_book("adrates_torch", True)[1]
    topo = tmb.book_inputs(mb).topology
    si = _xccy_si(topo)
    hb = topo.bat[topo.stages[si].key]
    hb["legs"] = _probe_legs(hb["legs"], 5)
    q = torch.tensor(mb.basket.quotes0[None, :]
                     + tc.shocks(mb.basket.n_quotes))
    return _routes(mb), topo, si, q


def test_routes_of_fitted_parents_and_members():
    """The stage over fitted parents takes the kernels, with query grids
    on both parents; a fitted member keeps torch.func with its reason."""
    for recal in (True, False):
        mb = tc.fitted_parent_book("adrates_torch", recal)[1]
        topo = tmb.book_inputs(mb).topology
        si = _xccy_si(topo)
        assert tsr.stage_routes(topo) == {si: "kernels"}
        tab = tmb.make_multibook_fn(mb, "cpu").book.params["xstage"][si]
        assert tab.ffit is not None and tab.dfit is not None
        assert (tab.fsch, tab.dsch) == (xs.LIN_FWD, xs.LIN_FWD)
        for qi in (tab.fq_i, tab.li_i, tab.ld_i):
            kn = qi[..., 2]
            assert bool((kn >= 0).all() and (qi[..., 0] == kn).all()
                        and (qi[..., 1] == kn).all())
        assert (tab.Lf, tab.Ld) == (tab.ffit.tables.W_max,
                                    tab.dfit.tables.W_max)
    mb = tc.spline_book("adrates_torch", "a_recal")[1]
    topo = tmb.book_inputs(mb).topology
    assert tsr.stage_routes(topo) == {
        _xccy_si(topo): "torch.func: a fitted member scheme "
                        "(PCHIP_ZERO_RATES)"}
    assert not tmb.make_multibook_fn(mb, "cpu").book.params["xstage"]


def test_kernel_route_matches_torch_func_on_probe_legs(probe):
    """The recalibrated stage's derivatives on the kernel route against
    the torch.func route at 1e-12 x max|ref| of each: the native DFs and
    rows, the rows' tangents, the legs' PVs and Jpv (``xccy_jac``), and
    gf, gdd, Hx2 and Hl (``xccy_hess``, with the curvature terms), the
    lifted grids in the carry; nothing launched on the CPU."""
    routes, topo, si, q = probe
    st = topo.stages[si]
    before = _launches()
    got = {}
    for route, (parts, book) in routes.items():
        fw = parts["fwd_delta"](q, book.params, book.aggregate,
                                book.clamp_agg)
        c = fw["carry"][si]
        sp = q[:, book.params["bat"][st.key]["qidx"]]
        jac = parts["xccy_jac"](si, book.params, sp, c["dom_ds"],
                                c["for_ds"], c["td_legs"], c["tf2"])
        gs = torch.tensor(np.random.default_rng(1).standard_normal(
            (q.shape[0], len(st.ids), jac[1].shape[-1])))
        got[route] = (jac, parts["xccy_hess"](si, book.params, sp, gs, c),
                      c)
    assert _launches() == before
    (kj, kh, kc), (rj, rh, rc) = got["kernels"], got["torch.func"]
    assert sorted(kj[5]) == ["dq", "fq", "tdq", "tfq"] and not rj[5]
    assert set(kc) == set(rc) | set(kj[5])
    names = ("ds", "rows", "pv0", "Jpv", "drows")
    for name, a, b in zip(names, kj[:5], rj[:5]):
        assert a.shape == b.shape
        assert _rel(a, b) <= 1e-12, name
    for name, a, b in zip(("gf", "gdd", "Hx2", "Hl"), kh, rh):
        assert a.shape == b.shape
        assert _rel(a, b) <= 1e-12, name
    # the probe legs are far from rounding
    assert float(rj[2].abs().min()) > 1.0 and float(rh[3].abs().max()) > 1.0


def test_split_on_the_kernel_route_matches_torch_func(book):
    """fwd_delta and term2_xccy with the stage on the kernels against
    the torch.func route, on the book's own legs: dfs, J and H2 at 1e-12
    x max|ref|, the parent cotangents at 1e-12 of the largest."""
    recal, _, tb, q = book
    q = torch.tensor(q)
    out = {}
    for route, (parts, b) in _routes(tb).items():
        fw = parts["fwd_delta"](q, b.params, b.aggregate, b.clamp_agg)
        h2x, v_of = parts["term2_xccy"](q, b.params, fw["g"], fw["carry"])
        out[route] = fw, h2x, v_of
    (kf, kh, kv), (rf, rh, rv) = out["kernels"], out["torch.func"]
    for key in ("dfs", "J", "delta"):
        assert _rel(kf[key], rf[key]) <= 1e-12, key
    assert _rel(kh, rh) <= 1e-12
    assert sorted(kv) == sorted(rv) and bool(rv) == recal
    scale = max((float(v.abs().max()) for v in rv.values()), default=1.0)
    for k, v in rv.items():
        assert float((kv[k] - v).abs().max()) <= 1e-12 * scale, k


def test_curvature_term_against_torch_func(probe):
    """``pull_grid`` on the domestic and foreign query grids with a seeded
    cotangent: g-bar equal to the vjp of g . F, and C_ij = t_i' d2(g .
    F)/dx2 t_j from ``jacfwd(jacrev)``, at 1e-12 x max|ref|; a simple
    parent passes g through with no curvature."""
    routes, topo, si, q = probe
    parts, book = routes["kernels"]
    tab = book.params["xstage"][si]
    c = parts["fwd_delta"](q, book.params, book.aggregate,
                           book.clamp_agg)["carry"][si]
    rng = np.random.default_rng(3)
    for fit, x, t in ((tab.dfit, c["dom_ds"], c["td_legs"]),
                      (tab.ffit, c["for_ds"], c["tf2"][:, 2 * tab.S:])):
        g = torch.tensor(rng.standard_normal(
            (x.shape[0], x.shape[1], fit.tables.W_max)))
        gb, C = xs.pull_grid(fit, x, g, t)
        for r in range(x.shape[0]):
            def scal(v, r=r):
                return torch.sum(g[r] * tfr.fitted_eval(fit, v))
            ref_g = jacrev(scal)(x[r])
            H = jacfwd(jacrev(scal))(x[r])
            ref_c = torch.einsum("iab,abcd,jcd->iaj", t[r], H, t[r])
            assert _rel(gb[r], ref_g) <= 1e-12
            assert _rel(C[r], ref_c) <= 1e-12
    g = torch.ones(2, 1, 3)
    assert xs.pull_grid(None, None, g, None) == (g, None)
    assert xs.lift_grid(None, g, None) == (g, None)


def test_book_matches_jax(book):
    """pvs, delta and gamma of the book, its XCCY stage on the kernel
    route (plain versions), against adrates_tpu at 1e-10 x max|ref|."""
    _, jb, tb, q = book
    q0 = q[0]
    sh = q - q0[None, :]
    ref = {k: np.asarray(v) for k, v in jmb.make_multibook_fn(jb)(
        jnp.asarray(q0), jnp.asarray(sh)).items()}
    fn = tmb.make_multibook_fn(tb, "cpu")
    assert fn.structured and fn.book.params["xstage"]
    got = fn(q0, sh)
    for k in ("pvs", "delta", "gamma"):
        g, r = got[k].numpy(), ref[k]
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=1e-10 * np.abs(r).max(), err_msg=k)
