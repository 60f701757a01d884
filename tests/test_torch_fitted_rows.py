"""The fitted-scheme rows on K6 / K7's Function (``adrates_torch/ops/
fitted_rows.py``) on the CPU, where the kernels' wrappers run their plain
twins.

- Each of the five fitted schemes, on knots and DFs drawn from a numpy
  seed (n in {2, 3, 12, 43, 73}, a t = 0 node on every other grid):
  ``fitted_df_static`` (one Function call) against the JAX package's
  ``interp_fit`` + ``interp_df`` on the same knots, its value,
  ``jacrev``, ``jacfwd`` and ``jacfwd(jacrev)``, and at n in {3, 73}
  ``jacfwd(jacrev(jacrev))`` (each size of that JAX reference is a
  compile of seconds), at 1e-10 x max|ref|.
- A stacked plan of all five schemes with ragged knot and query counts
  equal to each member's own plan (1e-14 x max|ref|), with finite
  derivatives, zero in every pad.
- The twins are transposes of each other (1e-13 relative), the Function
  under ``vmap`` over two batch dims, one call of each wrapper per AD
  evaluation, the ``LibError`` under two forward-mode levels, and the
  tables' invariants (brackets, weights, the Thomas factors rebuilding
  T, the query CSR).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd, jacrev, jvp, vmap

import adrates_tpu  # noqa: F401 — enables x64 for the JAX side
from adrates_tpu.ops import interpolation as jint
from adrates_tpu.utils.global_types import InterpTypes as JIT
from adrates_torch.ops import fitted_rows as tfr
from adrates_torch.ops import interpolation as tint
from adrates_torch.ops import kernels
from adrates_torch.utils.error import LibError
from adrates_torch.utils.global_types import InterpTypes as TIT

SCHEMES = ["PCHIP_LOG_DISCOUNT", "PCHIP_ZERO_RATES", "NATCUBIC_LOG_DISCOUNT",
           "NATCUBIC_ZERO_RATES", "FINCUBIC_ZERO_RATES"]
SIZES = [2, 3, 12, 43, 73]
MEASURES = ["value", "jacrev", "jacfwd", "jacfwd_jacrev"]
THIRD_SIZES = [3, 73]
CASES = [(n, m) for n in SIZES for m in MEASURES] \
    + [(n, "jacfwd_jacrev_jacrev") for n in THIRD_SIZES]


def _t(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def _grid(n: int, seed: int):
    """(knots, DFs, queries): knots from 0 (even seeds) or above it, DFs
    of a noisy upward curve of zero rates, queries at the knots, between
    them, before the first and past the last."""
    rng = np.random.default_rng(seed)
    x0 = 0.0 if seed % 2 == 0 else rng.uniform(0.02, 0.3)
    x = x0 + np.concatenate([[0.0], np.cumsum(rng.uniform(0.05, 2.0,
                                                          n - 1))])
    r = 0.02 + 0.01 * np.sqrt(x) + rng.uniform(-2e-3, 2e-3, n)
    dfs = np.exp(-r * x)
    mids = 0.5 * (x[1:] + x[:-1])
    q = np.concatenate([x, mids, [x[0] - 0.05, x[-1] + 3.0,
                                  rng.uniform(x[0], x[-1])]])
    return x, dfs, q


def _close(got, ref, tol, msg=""):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, msg
    assert np.isfinite(got).all(), msg
    if ref.size == 0:
        return
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * max(np.abs(ref).max(), 1e-300),
                               err_msg=msg)


@pytest.mark.parametrize("n, measure", CASES)
@pytest.mark.parametrize("scheme", SCHEMES)
def test_function_matches_jax(scheme, n, measure):
    x, dfs, q = _grid(n, seed=n + SCHEMES.index(scheme))
    if measure == "jacfwd_jacrev_jacrev":
        q = q[[n - 1, n, 2 * n - 1, 2 * n]]     # a knot, a mid, both ends
    it, jit_ = TIT[scheme], JIT[scheme]
    plan = tint.plan_to_torch(tint.fitted_interp_plan(q, x, it), "cpu")

    def tf(d):
        return tint.fitted_df_static(plan, d, it)

    def jf(d):
        jx = jnp.asarray(x)
        return jint.interp_df(jnp.asarray(q), jx, d,
                              jit_, jint.interp_fit(jx, d, jit_))
    tr, jr = {"value": (tf, jf),
              "jacrev": (jacrev(tf), jax.jacrev(jf)),
              "jacfwd": (jacfwd(tf), jax.jacfwd(jf)),
              "jacfwd_jacrev": (jacfwd(jacrev(tf)),
                                jax.jacfwd(jax.jacrev(jf))),
              "jacfwd_jacrev_jacrev": (
                  jacfwd(jacrev(jacrev(tf))),
                  jax.jacfwd(jax.jacrev(jax.jacrev(jf))))}[measure]
    _close(tr(_t(dfs)), jax.jit(jr)(jnp.asarray(dfs)), 1e-10,
           f"{scheme} n={n} {measure}")


def _mixed():
    """Five members, one a scheme, of ragged knot and query counts
    (queries [W_g], one member with none), their plans and DF rows
    [G, L] with L past every member's knots (the pads hold 1 and 0.5)."""
    ns, ws = [73, 2, 12, 43, 3], [40, 7, 0, 25, 9]
    plans, rows = [], []
    L = max(ns) + 3
    for g, (scheme, n, w) in enumerate(zip(SCHEMES, ns, ws)):
        x, dfs, q = _grid(n, seed=100 + g)
        rng = np.random.default_rng(200 + g)
        qq = rng.uniform(x[0] - 0.1, x[-1] + 2.0, w)
        plans.append(tint.fitted_interp_plan(qq, x, TIT[scheme]))
        rows.append(np.concatenate([dfs, np.full(L - n, 0.5 if g % 2
                                                 else 1.0)]))
    return plans, np.stack(rows), ns, ws


def test_stacked_mixed_plan_equals_members():
    plans, rows, ns, ws = _mixed()
    tab = tfr.fitted_plan(plans, "cpu")
    k = tab.tables
    assert k.K == 2 and k.n_max == 73 and k.W_max == 40
    assert tab.qshape is None and tab.pad is not None
    out = tfr.fitted_eval(tab, _t(rows))
    assert out.shape == (5, 40)
    for g, p in enumerate(plans):
        if ws[g] == 0:
            continue
        one = tint.plan_to_torch(p, "cpu")
        ref = tint.fitted_df_static(one, _t(rows[g]), TIT[SCHEMES[g]])
        _close(out[g, :ws[g]], ref.numpy(), 1e-14, SCHEMES[g])
    # the first and second derivatives: finite, and 0 at every pad knot
    # and in every row past the member's own
    d = _t(rows)
    J = jacrev(lambda v: tfr.fitted_eval(tab, v))(d)
    H = jacfwd(jacrev(lambda v: tfr.fitted_eval(tab, v).sum()))(d)
    assert bool(torch.isfinite(J).all()) and bool(torch.isfinite(H).all())
    for g, n in enumerate(ns):
        assert not J[g, :, g, n:].any()
        assert not J[g, :, torch.arange(5) != g].any()
        assert not H[g, n:].any() and not H[:, :, g, n:].any()
    # each member's own jacobian equals its plan's
    for g, p in enumerate(plans):
        if ws[g] == 0:
            continue
        one = tint.plan_to_torch(p, "cpu")
        ref = jacrev(lambda v: tint.fitted_df_static(
            one, v, TIT[SCHEMES[g]]))(_t(rows[g]))
        _close(J[g, :ws[g], g], ref.numpy(), 1e-14, SCHEMES[g])


def test_member_list_stacks_into_one_call(monkeypatch):
    """A list of one-curve host plans on the device (``plan_to_torch``,
    as the stages' foreign-curve and leg plans are) is one stacked plan:
    ``df_static`` makes one K6 call, equal to the members evaluated one
    by one."""
    x, dfs, q = _grid(12, seed=5)
    it = TIT["NATCUBIC_ZERO_RATES"]
    rows = dfs[None, :] ** np.array([[1.0], [1.1], [0.9]])
    host = [tint.fitted_interp_plan(q, x, it) for _ in range(3)]
    stacked = tint.plan_to_torch(host, "cpu")
    assert isinstance(stacked, tfr.FittedPlan) and stacked.stacked
    calls = []
    orig = kernels.fitted_rows
    monkeypatch.setattr(kernels, "fitted_rows",
                        lambda X, tab: calls.append(X.shape) or orig(X, tab))
    got = tint.df_static(stacked, _t(rows), it)
    assert calls == [(1, 3, 1, 12)]
    for g in range(3):
        one = tint.plan_to_torch(host[g], "cpu")
        assert torch.equal(got[g], tint.fitted_df_static(one, _t(rows[g]),
                                                         it))


def test_one_call_of_each_kernel_per_evaluation(monkeypatch):
    """The value is one K6 call; a vjp adds one K7 call; a jvp of the
    value one K6 call, a Hessian-vector product one of each more."""
    plans, rows, _, _ = _mixed()
    tab = tfr.fitted_plan(plans, "cpu")
    seen = []
    for name in ("fitted_rows", "fitted_rows_t"):
        orig = getattr(kernels, name)

        def watched(t, tab, name=name, orig=orig):
            seen.append(name)
            return orig(t, tab)
        monkeypatch.setattr(kernels, name, watched)
    d = _t(rows)
    tfr.fitted_eval(tab, d)
    assert seen == ["fitted_rows"]
    seen.clear()
    torch.func.vjp(lambda v: tfr.fitted_eval(tab, v), d)[1](
        torch.ones(5, 40, dtype=torch.float64))
    assert seen == ["fitted_rows", "fitted_rows_t"]
    seen.clear()
    jvp(lambda v: tfr.fitted_eval(tab, v), (d,), (torch.ones_like(d),))
    assert sorted(seen) == ["fitted_rows", "fitted_rows"]
    seen.clear()
    jvp(torch.func.grad(lambda v: tfr.fitted_eval(tab, v).sum()), (d,),
        (torch.ones_like(d),))
    assert sorted(seen) == ["fitted_rows", "fitted_rows", "fitted_rows_t",
                            "fitted_rows_t"]


def test_twins_are_transposes():
    plans, _, _, _ = _mixed()
    tab = tfr.fitted_plan(plans, "cpu").tables
    rng = np.random.default_rng(3)
    X = _t(rng.standard_normal((4, 5, 2, 73)))
    Ub = _t(rng.standard_normal((4, 5, 40)))
    U = kernels.fitted_rows_plain(X, tab)
    Xb = kernels.fitted_rows_t_plain(Ub, tab)
    lhs = float((U * Ub).sum())
    rhs = float((X * Xb).sum())
    assert abs(lhs - rhs) <= 1e-13 * max(abs(lhs), float((U * Ub).abs()
                                                         .sum()))
    # pads and unread slots: nothing in, nothing out
    assert not Xb[:, 2:, 1].any()
    for g, (n, w) in enumerate(zip(tab.nk.tolist(), tab.nw.tolist())):
        assert not Xb[:, g, :, n:].any() and not U[:, g, w:].any()
    # the wrappers run the twins on a CPU tensor, and leave the counts
    n6, n7 = kernels.fitted_rows.launches, kernels.fitted_rows_t.launches
    assert torch.equal(kernels.fitted_rows(X, tab), U)
    assert torch.equal(kernels.fitted_rows_t(Ub, tab), Xb)
    assert (kernels.fitted_rows.launches,
            kernels.fitted_rows_t.launches) == (n6, n7)


def test_function_under_vmap_over_two_batch_dims():
    plans, rows, _, _ = _mixed()
    tab = tfr.fitted_plan(plans, "cpu")
    rng = np.random.default_rng(4)
    d = _t(rows[None, None] ** (1.0 + 0.1 * rng.standard_normal((2, 3, 1,
                                                                1))))
    batched = tfr.fitted_eval(tab, d)
    assert batched.shape == (2, 3, 5, 40)
    mapped = vmap(vmap(lambda v: tfr.fitted_eval(tab, v)))(d)
    _close(mapped, batched.numpy(), 1e-15)
    jm = vmap(vmap(jacrev(lambda v: tfr.fitted_eval(tab, v))))(d)
    for i in range(2):
        for j in range(3):
            _close(jm[i, j], jacrev(lambda v: tfr.fitted_eval(tab, v))(
                d[i, j]).numpy(), 1e-14)
    # the rows given as a moved batch dim
    ut = vmap(lambda v: tfr.fitted_eval(tab, v), in_dims=1)(d)
    _close(ut, batched.transpose(0, 1).numpy(), 1e-15)


def test_two_forward_levels_raise():
    x, dfs, q = _grid(12, seed=1)
    it = TIT["PCHIP_ZERO_RATES"]
    plan = tint.plan_to_torch(tint.fitted_interp_plan(q, x, it), "cpu")

    def f(d):
        return tint.fitted_df_static(plan, d, it)
    d = _t(dfs)
    with pytest.raises(LibError, match="forward-mode levels"):
        jacfwd(jacfwd(f))(d)
    with pytest.raises(LibError, match="forward-mode levels"):
        jvp(lambda v: jvp(f, (v,), (torch.ones_like(v),))[1], (d,),
            (torch.ones_like(d),))
    # one forward level over two reverse ones is the third order
    assert jacfwd(jacrev(jacrev(f)))(d).shape == (q.size, 12, 12, 12)


def test_tables_invariants():
    plans, _, ns, ws = _mixed()
    tab = tfr.fitted_plan(plans, "cpu").tables
    kinds = [kernels.FIT_HERMITE, kernels.FIT_HERMITE, kernels.FIT_NATURAL,
             kernels.FIT_NATURAL, kernels.FIT_CLAMPED]
    assert tab.kind.tolist() == kinds
    assert tab.nk.tolist() == ns and tab.nw.tolist() == ws
    for g, p in enumerate(plans):
        n, w = ns[g], ws[g]
        x = p["x"]
        qi = tab.qidx[g, :w].numpy()
        # brackets: fitted_index's, inside the member's real intervals
        assert np.array_equal(qi, np.asarray(p["idx"]))
        assert np.all((qi >= 0) & (qi <= n - 2))
        # weights: the Hermite basis at s = (q - x_i) / h, which
        # reproduces a linear function with its slope exactly
        W4 = tab.qw[g, :w].numpy()
        _close(W4[:, 0] + W4[:, 2], np.ones(w), 1e-14)
        a, b = 0.3, -0.7
        y = a + b * x
        lin = W4[:, 0] * y[qi] + W4[:, 1] * b + W4[:, 2] * y[qi + 1] \
            + W4[:, 3] * b
        _close(lin, a + b * np.asarray(p["q"]), 1e-13)
        assert not tab.qw[g, w:].any()
        # the queries by interval: every query once, intervals ascending,
        # query order within an interval, each with its own interval
        iq, key = tab.iq[g, :w].numpy(), tab.ikey[g, :w].numpy()
        assert sorted(iq.tolist()) == list(range(w))
        assert np.array_equal(key, qi[iq]) and np.all(np.diff(key) >= 0)
        for j in range(n - 1):
            assert np.all(np.diff(iq[key == j]) > 0)
        # the Thomas factors rebuild T, and R maps y to cubic_spline_
        # coeffs' right-hand side
        if kinds[g] == kernels.FIT_HERMITE:
            continue
        sp = tab.sp[g].numpy()
        lo, di, up = tab.twin.bands[g, :, :n].numpy()
        T = np.diag(di) + np.diag(lo[1:], -1) + np.diag(up[:-1], 1)
        Lm = np.eye(n) + np.diag(sp[0, 1:n], -1)
        Um = np.diag(1.0 / sp[1, :n]) + np.diag(sp[2, :n - 1], 1)
        _close(Lm @ Um, T, 1e-14)
        Rm = np.diag(sp[4, :n]) + np.diag(sp[3, 1:n], -1) \
            + np.diag(sp[5, :n - 1], 1)
        y = np.random.default_rng(g).standard_normal(n)
        h = np.diff(x)
        m = np.diff(y) / h
        rhs = np.concatenate([[3 * m[0]], 3 * (m[:-1] / h[:-1]
                                               + m[1:] / h[1:]),
                              [0.0 if kinds[g] == kernels.FIT_CLAMPED
                               else 3 * m[-1]]])
        _close(Rm @ y, rhs, 1e-13)
        # pads are decoupled identity rows of T, with no R and no slope
        assert np.all(sp[1, n:] == 1.0) and not sp[[0, 2, 3, 4, 5], n:].any()
    # a member of more knots than a one-row tile holds is refused
    assert kernels.FIT_MAX_KNOTS | 1 == kernels.FIT_MAX_KNOTS
    x = np.arange(kernels.FIT_MAX_KNOTS + 1, dtype=np.float64)
    big = tint.fitted_interp_plan(x[:3] + 0.5, x, TIT["PCHIP_LOG_DISCOUNT"])
    with pytest.raises(ValueError, match="knot counts"):
        tfr.fitted_plan([big], "cpu")


def test_calibration_legs_share_one_plan(monkeypatch):
    """A recalibrated XCCY stage on a fitted dom curve (torch_cases'
    spline book "a_recal": USD NATCUBIC_ZERO_RATES): its legs' index and
    discount queries are one stacked plan, one K6 call for both, and the
    legs' PVs equal those of the two plans evaluated apart."""
    import torch_cases as tc
    from adrates_torch.ops import pricers
    from adrates_torch.parallel import curve_batching as cb
    _, mb = tc.spline_book("adrates_torch", "a_recal")
    basket = mb.basket
    st = next(s for s in basket.stages if s.kind == "xccy")
    host = basket.bat[st.key]
    dev = cb.bat_to_torch({st.key: host}, "cpu")[st.key]
    assert sorted(dev["legs_plan"]) == ["both", "n_idx"]
    L = host["dom_ts"].shape[1]
    rng = np.random.default_rng(11)
    dom_ds = _t(np.exp(-0.03 * host["dom_ts"].clip(0, 40.0)
                       * (1.0 + 0.01 * rng.standard_normal((1, L)))))
    calls = []
    orig = kernels.fitted_rows
    monkeypatch.setattr(kernels, "fitted_rows",
                        lambda X, tab: calls.append(X.shape) or orig(X, tab))
    got = cb.xccy_legs_pv(dom_ds, dev, st)
    assert len(calls) == 1
    apart = dict(idx=tint.plan_to_torch(host["legs_plan"]["idx"], "cpu"),
                 disc=tint.plan_to_torch(host["legs_plan"]["disc"], "cpu"))
    legs = cb.leg_to_torch(host["legs"], "cpu")
    ref = pricers.pv_float_leg(dom_ds, st.dom_interp, legs, apart)
    _close(got, ref.numpy(), 1e-14)
    assert got.shape == (1, host["legs"].payment_times.shape[1])
