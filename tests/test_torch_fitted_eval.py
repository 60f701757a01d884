"""K6 ``fitted_eval`` and its tangent mode behind ``ops/fitted_rows``'
``_FittedEval`` / ``_FittedTangent`` on the CPU, where the wrappers run
the plain versions.

- Each of the five fitted schemes (n = 10, a t = 0 knot on the
  zero-rate schemes): ``fitted_eval`` against the JAX package's
  ``interp_fit`` + ``interp_df`` on the same knots, its value,
  ``jacrev`` and ``jacfwd(jacrev)``, at 1e-10 x max|ref| (one JAX compile
  a scheme).
- The tangent mode's arithmetic and layout (D tangent rows a primal row,
  the primal transforms once a row), emulated in numpy as
  ``csrc/fitted_rows.cu`` runs it (the transforms' tangents, PCHIP's
  slope derivative with its guard, the spline's solve and rows in the
  plain version's order, the Hermite rows, out fac du), against
  ``torch.func.jvp`` of the composition and against
  ``fitted_eval_jvp_plain``.
- ``vmap(jvp)`` with the tangent batched over an unbatched primal: one
  tangent call whose directions are the batch, the primal not expanded.
- Members with pad knots, a zero-rate member with a t = 0 knot, a PCHIP
  member with a flat segment and a sign change (the guard's false
  branch: its slope's tangent exactly 0 and every derivative finite).
- The spline solve a warp a row (the plain version's parallel cyclic
  reduction on the host's reduced coefficients) and the spline rows,
  emulated in numpy, against the Thomas sweeps on the stored factors,
  and equal to the plain linear map bit for bit up to 30 last intervals
  past the last knot.
- One launch of each wrapper a value and a jvp; a second forward level
  raises ``LibError``; reverse over forward raises (the tangent mode has
  no backward).
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


def _t(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def _close(got, ref, tol, msg=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = ref.detach().numpy() if torch.is_tensor(ref) else np.asarray(ref)
    assert got.shape == ref.shape, msg
    assert np.isfinite(got).all(), msg
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * max(np.abs(ref).max(), 1e-300),
                               err_msg=msg)


def _knots(rng, n, t0):
    x0 = 0.0 if t0 else rng.uniform(0.02, 0.3)
    return x0 + np.concatenate([[0.0], np.cumsum(rng.uniform(0.05, 2.0,
                                                             n - 1))])


def _dfs(rng, x, flat=False):
    """DFs of a noisy upward curve of zero rates on the knots x; ``flat``
    makes knots 3-5 one DF (a flat log-DF segment) and knot 7 a rise (a
    sign change of the secants)."""
    r = 0.02 + 0.01 * np.sqrt(x) + rng.uniform(-2e-3, 2e-3, x.shape)
    d = np.exp(-r * x)
    if flat:
        d[..., 3:6] = d[..., 3:4]
        d[..., 7] *= 1.2
    return d


def _mixed(flat=True):
    """Five members, one a scheme, of ragged knot and query counts (a
    t = 0 knot on the zero-rate members, a flat segment and a sign change
    on the PCHIP log member), their stacked plan and DF rows [G, L] past
    every member's knots (the pads hold 0.5)."""
    ns, ws = [12, 9, 14, 8, 10], [30, 17, 25, 1, 40]
    rng = np.random.default_rng(41)
    plans, rows = [], []
    L = max(ns) + 3
    for g, (s, n, w) in enumerate(zip(SCHEMES, ns, ws)):
        x = _knots(rng, n, "ZERO" in s)
        q = np.concatenate([x[:3], rng.uniform(x[0] - 0.1, x[-1] + 2.0,
                                               w - 3)]) if w > 3 else x[:w]
        plans.append(tint.fitted_interp_plan(q, x, TIT[s]))
        d = _dfs(rng, x, flat and g == 0)
        rows.append(np.concatenate([d, np.full(L - n, 0.5)]))
    return tfr.fitted_plan(plans, "cpu"), np.stack(rows), ns


@pytest.mark.parametrize("scheme", SCHEMES)
def test_fitted_eval_matches_jax(scheme):
    """Value, jacrev and jacfwd(jacrev) of one Function call against the
    JAX package's interp_fit + interp_df (1e-10 x max|ref|)."""
    rng = np.random.default_rng(SCHEMES.index(scheme))
    x = _knots(rng, 10, "ZERO" in scheme)
    dfs = _dfs(rng, x)
    q = np.concatenate([x, 0.5 * (x[1:] + x[:-1]), [x[0] - 0.05,
                                                    x[-1] + 3.0]])
    it, jit_ = TIT[scheme], JIT[scheme]
    plan = tint.plan_to_torch(tint.fitted_interp_plan(q, x, it), "cpu")

    def tf(d):
        return tint.fitted_df_static(plan, d, it)

    def jf(d):
        jx = jnp.asarray(x)
        return jint.interp_df(jnp.asarray(q), jx, d, jit_,
                              jint.interp_fit(jx, d, jit_))

    ref = jax.jit(lambda d: (jf(d), jax.jacrev(jf)(d),
                             jax.jacfwd(jax.jacrev(jf))(d)))(
        jnp.asarray(dfs))
    d = _t(dfs)
    for got, r, what in zip((tf(d), jacrev(tf)(d), jacfwd(jacrev(tf))(d)),
                            ref, ("value", "jacrev", "jacfwd(jacrev)")):
        _close(got, np.asarray(r), 1e-10, f"{scheme} {what}")


def _emulate_tangent(plan, dfs, ddfs, out):
    """K6's tangent mode as ``csrc/fitted_rows.cu`` runs it, in numpy:
    dfs [R, G, L], ddfs [R, D, G, L], out [R, G, W_max] -> dout
    [R, D, G, W_max]; a primal row's transformed knots once, then each of
    its D directions."""
    tab = plan.tables
    fx, fmode, fac = plan.fx.numpy(), plan.fmode.numpy(), plan.fac.numpy()
    qw, qidx = tab.qw.numpy(), tab.qidx.numpy()
    kinds, nk, nw = tab.kind.numpy(), tab.nk.numpy(), tab.nw.numpy()
    R, D, G, _ = ddfs.shape
    dout = np.zeros((R, D, G, tab.W_max))
    for p in range(R):
        for g in range(G):
            n, md = nk[g], fmode[g]
            negx, h = fx[g, tfr.FX_NEGXG], fx[g, tfr.FX_H]
            w1, w2, w12 = (fx[g, k] for k in (tfr.FX_W1, tfr.FX_W2,
                                               tfr.FX_W12))
            j = np.arange(n)
            if md & tfr.FM_PATCH:
                j[0] = 1
            y = np.log(dfs[p, g, j])
            if md & tfr.FM_ZERO_RATES:
                y = y / negx[j]
            for k in range(D):
                dy = ddfs[p, k, g, j] / dfs[p, g, j]
                if md & tfr.FM_ZERO_RATES:
                    dy = dy / negx[j]
                ds = np.zeros(n)
                if kinds[g] == kernels.FIT_HERMITE:
                    ds[0] = (dy[1] - dy[0]) / h[0]
                    ds[n - 1] = (dy[n - 1] - dy[n - 2]) / h[n - 2]
                    for i in range(1, n - 1):
                        m0 = (y[i] - y[i - 1]) / h[i - 1]
                        m1 = (y[i + 1] - y[i]) / h[i]
                        if not m0 * m1 > 0:
                            continue              # the guard: exactly 0
                        dm0 = (dy[i] - dy[i - 1]) / h[i - 1]
                        dm1 = (dy[i + 1] - dy[i]) / h[i]
                        a, b = w1[i - 1] / m0, w2[i - 1] / m1
                        den = a + b
                        dden = -(a * (dm0 / m0) + b * (dm1 / m1))
                        ds[i] = -(w12[i - 1] / den) * (dden / den)
                w = nw[g]
                if kinds[g] == kernels.FIT_HERMITE:
                    i0 = qidx[g, :w]
                    W4 = qw[g, :w]
                    du = W4[:, 0] * dy[i0] + W4[:, 1] * ds[i0] \
                        + W4[:, 2] * dy[i0 + 1] + W4[:, 3] * ds[i0 + 1]
                else:
                    du = _k6_spline(tab, g, dy)[1]
                dout[p, k, g, :w] = out[p, g, :w] * (fac[g, :w] * du)
    return dout


def _k6_spline(tab, g, y):
    """A spline member g's slopes and rows at its queries from its knot
    values y [n] as K6 takes them (``spline_pcr``, ``spline_u``), in
    numpy, each operation rounded: the right-hand side from the secants,
    the parallel cyclic reduction on the host's reduced coefficients
    (``pc``: h, b, each step's alpha and gamma; the rows past the
    member's knots read 0), then the power form on the offsets ``qu``."""
    n, w = int(tab.nk[g]), int(tab.nw[g])
    P = tab.pc.numpy()[g]
    h = P[0]
    m = (y[1:n] - y[:n - 1]) / h[:n - 1]
    d = np.zeros(n)
    d[0] = 3.0 * m[0]
    d[n - 1] = 0.0 if int(tab.kind[g]) == kernels.FIT_CLAMPED \
        else 3.0 * m[n - 2]
    for i in range(1, n - 1):
        d[i] = 3.0 * (m[i - 1] * (1.0 / h[i - 1]) + m[i] * (1.0 / h[i]))
    for k in range(kernels.pcr_steps(tab.n_max)):
        s = 1 << k
        up = np.concatenate([np.zeros(min(s, n)), d[:max(n - s, 0)]])
        dn = np.concatenate([d[s:], np.zeros(min(s, n))])
        d = (d + P[2 + 2 * k, :n] * up) + P[3 + 2 * k, :n] * dn
    d = d / P[1, :n]
    i = tab.host["idx"][g, :w]
    uq = tab.qu.numpy()[g, :w]
    hi = h[i]
    mi = (y[i + 1] - y[i]) / hi
    c1 = ((3.0 * mi - 2.0 * d[i]) - d[i + 1]) / hi
    c0 = ((d[i] + d[i + 1]) - 2.0 * mi) / (hi * hi)
    return d, ((c0 * uq + c1) * uq + d[i]) * uq + y[i]


def _thomas(F, y):
    """The spline's slopes from the stored factors F [6, n] (l, 1 / b',
    c, R's three diagonals) by the two Thomas sweeps, a thread a row."""
    l, rb, c, rl, rd, ru = F
    n = len(y)
    rhs = rd * y
    rhs[1:] += rl[1:] * y[:-1]
    rhs[:-1] += ru[:-1] * y[1:]
    d, f = np.zeros(n), 0.0
    for i in range(n):
        f = rhs[i] - l[i] * f
        d[i] = f
    b = 0.0
    for i in range(n - 1, -1, -1):
        b = (d[i] - c[i] * b) * rb[i]
        d[i] = b
    return d


@pytest.mark.parametrize("n", [2, 3, 31, 33, 43, 73, 257])
@pytest.mark.parametrize("scheme", ["NATCUBIC_LOG_DISCOUNT",
                                    "FINCUBIC_ZERO_RATES"])
def test_warp_solve_emulated_against_thomas(scheme, n):
    """K6's spline solve a warp a row (``spline_pcr``: the plain version's
    parallel cyclic reduction on the host's reduced coefficients) and its
    rows (``spline_u``, the power form), emulated in numpy as
    ``csrc/fitted_rows.cu`` runs them, beside a member of half the knots
    (its pad rows): the slopes against the Thomas sweeps on the stored
    factors (1e-13 x max|ref|); the rows equal the plain linear map's bit
    for bit at queries from before the first knot to 30 last intervals
    past the last, where a cubic's extrapolation multiplies a rounding
    difference by up to 30^3; and at each interval's midpoint the Hermite
    row (y_i + y_i+1) / 2 + h (d_i - d_i+1) / 8 (1e-12)."""
    rng = np.random.default_rng(n)
    x = _knots(rng, n, True)
    q = np.sort(rng.uniform(x[0] - 0.05, x[-1] + 30.0 * (x[-1] - x[-2]),
                            64))
    mids = (x[:-1] + x[1:]) / 2
    half = x[:max(2, n // 2)]
    plan = tfr.fitted_plan([tint.fitted_interp_plan(np.concatenate(
        [mids, q]), x, TIT[scheme]), tint.fitted_interp_plan(q, half,
                                                             TIT[scheme])],
        "cpu")
    tab = plan.tables
    X = torch.zeros(2, 2, tab.K, tab.n_max, dtype=torch.float64)
    X[..., 0, :] = _t(rng.standard_normal((2, 2, tab.n_max)))
    U = kernels.fitted_rows_plain(X, tab).numpy()
    F = tab.sp.numpy()
    for r in range(2):
        for g, xg in enumerate((x, half)):
            k = xg.shape[0]
            y = X[r, g, 0].numpy()
            d, u = _k6_spline(tab, g, y)
            _close(d, _thomas(F[g, :, :k], y[:k].copy()), 1e-13,
                   "PCR vs Thomas")
            w = int(tab.nw[g])
            assert np.array_equal(u, U[r, g, :w]), (r, g)
            if g == 0:
                h = np.diff(x)
                herm = (y[:n - 1] + y[1:n]) / 2 + h / 8 * (d[:-1] - d[1:])
                _close(u[:n - 1], herm, 1e-12, "plain map vs the slopes")


def test_tangent_layout_emulated_against_torch_jvp():
    """D = 4 tangent rows on each of R = 3 primal rows, emulated, against
    torch.func.jvp of the composition a direction and against the plain
    tangent mode (1e-12 x max|ref|); pad queries 0."""
    plan, rows, _ = _mixed()
    rng = np.random.default_rng(5)
    R, D = 3, 4
    dfs = _t(rows[None] ** (1.0 + 0.05 * rng.standard_normal((R, 1, 1))))
    ddfs = _t(rng.standard_normal((R, D) + rows.shape))
    out = tfr.fitted_eval_plain(plan, dfs)
    emu = _emulate_tangent(plan, dfs.numpy(), ddfs.numpy(), out.numpy())
    plain = tfr.fitted_eval_jvp_plain(plan, dfs, ddfs, out)
    _close(plain, emu, 1e-12, "plain vs emulation")
    for k in range(D):
        ref = jvp(lambda d: tfr.fitted_eval_plain(plan, d), (dfs,),
                  (ddfs[:, k],))[1]
        _close(emu[:, k], ref, 1e-12, f"direction {k}")
    for g, w in enumerate(plan.tables.nw.tolist()):
        assert not emu[..., g, w:].any()
    # the wrapper's CPU route is the plain version
    assert torch.equal(kernels.fitted_eval_jvp(dfs, ddfs, out, plan), plain)
    assert torch.equal(kernels.fitted_eval(dfs, plan), out)


def test_vmap_jvp_batches_tangents_over_one_primal(monkeypatch):
    """vmap over tangents of jvp at one primal: one tangent call whose D
    is the batch and whose primal has one row (not expanded), equal to
    the jvps one by one; the same under a vmap over scenarios outside."""
    plan, rows, _ = _mixed()
    rng = np.random.default_rng(6)
    seeds = _t(rng.standard_normal((7,) + rows.shape))
    calls = []
    orig = kernels.fitted_eval_jvp
    monkeypatch.setattr(kernels, "fitted_eval_jvp", lambda d, dd, o, p: (
        calls.append((tuple(d.shape), tuple(dd.shape))) or orig(d, dd, o, p)))
    d = _t(rows)

    def f(v):
        return tfr.fitted_eval(plan, v)
    got = vmap(lambda s: jvp(f, (d,), (s,))[1])(seeds)
    assert calls == [((1,) + rows.shape, (1, 7) + rows.shape)]
    for k in range(7):
        _close(got[k], jvp(f, (d,), (seeds[k],))[1], 1e-15)
    # scenarios outside: each scenario's primal row carries the 7 seeds
    calls.clear()
    scen = _t(rows[None] ** np.array([1.0, 1.05, 0.95])[:, None, None])
    got = vmap(lambda r: vmap(lambda s: jvp(f, (r,), (s,))[1])(seeds))(scen)
    assert calls == [((3,) + rows.shape, (3, 7) + rows.shape)]
    _close(got[1, 2], jvp(f, (scen[1],), (seeds[2],))[1], 1e-15)


def test_pads_patch_and_the_guard():
    """Pad knots take no derivative; the zero-rate members' t = 0 knot
    moves with its neighbour's DF; the PCHIP log member's flat segment and
    sign change give finite derivatives with the guard's slope tangents
    exactly 0."""
    plan, rows, ns = _mixed()
    d = _t(rows)
    J = jacrev(lambda v: tfr.fitted_eval(plan, v))(d)       # [G, W, G, L]
    H = jacfwd(jacrev(lambda v: tfr.fitted_eval(plan, v).sum()))(d)
    assert bool(torch.isfinite(J).all()) and bool(torch.isfinite(H).all())
    for g, n in enumerate(ns):
        assert not J[g, :, g, n:].any() and not H[g, n:].any()
        if "ZERO" in SCHEMES[g]:
            # knot 0 at t = 0 takes knot 1's rate, so no query's DF
            # moves with its DF
            assert plan.tables.host["x"][g, 0] == 0.0
            assert not J[g, :, g, 0].any()
    # the guard: on the flat segment the interior slopes are 0, and so
    # are their tangents along any direction
    y = torch.log(d[0, :ns[0]])
    m = (y[1:] - y[:-1]) / plan.h[0, :ns[0] - 1]
    false = torch.nonzero(~(m[:-1] * m[1:] > 0)).flatten() + 1
    assert {4, 5, 6, 7} <= set(false.tolist())
    rng = np.random.default_rng(7)
    dd = _t(rng.standard_normal((1, 2) + rows.shape))
    dX = torch.func.jvp(lambda v: tfr._knots(plan, v), (d[None],),
                        (dd[:, 0],))[1]
    assert bool((dX[0, 0, 1, false] == 0).all())
    out = tfr.fitted_eval(plan, d[None])
    emu = _emulate_tangent(plan, d[None].numpy(), dd.numpy(), out.numpy())
    _close(tfr.fitted_eval_jvp_plain(plan, d[None], dd, out), emu, 1e-12)


def test_one_launch_a_value_and_a_jvp(monkeypatch):
    """A value is one fitted_eval call; a jvp one more, of the tangent
    mode; a vjp adds one K7 call and no fitted_eval."""
    plan, rows, _ = _mixed()
    seen = []
    for name in ("fitted_eval", "fitted_eval_jvp", "fitted_rows_t"):
        orig = getattr(kernels, name)

        def watched(*a, name=name, orig=orig):
            seen.append(name)
            return orig(*a)
        monkeypatch.setattr(kernels, name, watched)
    d = _t(rows)

    def f(v):
        return tfr.fitted_eval(plan, v)
    f(d)
    assert seen == ["fitted_eval"]
    seen.clear()
    jvp(f, (d,), (torch.ones_like(d),))
    assert seen == ["fitted_eval", "fitted_eval_jvp"]
    seen.clear()
    torch.func.vjp(f, d)[1](torch.ones(5, 40, dtype=torch.float64))
    assert seen == ["fitted_eval", "fitted_rows_t"]


def test_second_forward_level_raises():
    plan, rows, _ = _mixed()
    d = _t(rows)

    def f(v):
        return tfr.fitted_eval(plan, v)
    with pytest.raises(LibError, match="forward-mode levels"):
        jacfwd(jacfwd(f))(d)
    with pytest.raises(LibError, match="fitted_eval"):
        jvp(lambda v: jvp(f, (v,), (torch.ones_like(v),))[1], (d,),
            (torch.ones_like(d),))
    # reverse over forward is not an order the package composes: the
    # tangent mode has no backward, and autograd raises
    with pytest.raises(NotImplementedError, match="backward"):
        jacrev(lambda v: jvp(f, (v,), (torch.ones_like(v),))[1])(d)
