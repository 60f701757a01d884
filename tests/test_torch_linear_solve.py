"""adrates_torch's custom linear solves (``ops/linear_solve``) against
adrates_tpu's ``lax.custom_linear_solve`` and against unrolled sweeps.

- ``bootstrap_ois`` (13-pillar GBP curve of tests/test_reference_parity.py,
  flagship_v5's 32-pillar GBP_OIS_SONIA at depth 60, and the 13-pillar
  curve with a non-positive pillar) and ``bootstrap_xccy``
  (tests/torch_cases.py's GBP_USD_XCCY) against the JAX package: values
  at 1e-14, jacobian 1e-12, Hessian 1e-10 and the third order (of a fixed
  random projection of the DFs) 1e-9, each x max|ref|.
- ``gradcheck`` / ``gradgradcheck`` with forward AD and batched grads on
  each Function, over a random forest plan and a stacked [G, P] plan.
- Every composition the port runs at a solve against the same function
  built on unrolled sweeps (written here, independent of the port): at
  1e-13 x max|ref| (the solves reorder sums the sweeps take in place).
- Two forward-mode levels through a solve raise ``LibError``.
- The number of solves a composition runs does not grow with the plan's
  depth (the wrappers' ``calls``, kept apart from ``launches``).
- K4's single pass, emulated in numpy as the kernel walks it (the
  carried value, far links read ahead), equals its plain version bit for
  bit; K5's within 1e-14 x max|ref|, and bit for bit on plans where no
  point has two children (one chain, interleaved chains, flagship_v5's
  padded OIS stage).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, jacfwd, jacrev, jvp, vmap

import adrates_tpu  # noqa: F401 — enables x64 for the JAX side
import torch_cases as cases
from adrates_tpu.ops import bootstrap as jboot
from adrates_tpu.ops import xccy_bootstrap as jx
from adrates_torch.examples import flagship_ois
from adrates_torch.interop import ois_plan_from_numpy
from adrates_torch.ops import bootstrap as tboot
from adrates_torch.ops import interpolation as tinterp
from adrates_torch.ops import kernels
from adrates_torch.ops import linear_solve as ls
from adrates_torch.ops import xccy_bootstrap as tx
from adrates_torch.parallel.structured_risk import _so_tensor
from adrates_torch.utils import LibError

TENORS13 = ["1M", "3M", "6M", "1Y", "18M", "2Y", "3Y", "5Y", "7Y", "10Y",
            "15Y", "20Y", "30Y"]
RATES13 = [5.19, 5.15, 5.04, 4.71, 4.51, 4.35, 4.13, 3.93, 3.87, 3.87,
           3.91, 3.88, 3.71]
ORDERS = ["value", "jacobian", "hessian", "third"]
TOL = {"value": 1e-14, "jacobian": 1e-12, "hessian": 1e-10, "third": 1e-9}


def _close(got, ref, tol):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0,
                               atol=tol * np.abs(ref).max())


# ---------------------------------------------------------------------------
# bootstrap_ois and bootstrap_xccy against the JAX package
# ---------------------------------------------------------------------------


def _gbp_plan(tenors, rates):
    from adrates_tpu.models import Model
    from adrates_tpu.utils import Date, DayCountTypes
    m = Model(Date(1, 1, 2024))
    c = m.build_curve("GBP_OIS_SONIA", px_list=rates, tenor_list=tenors,
                      fixed_dcc_type=DayCountTypes.ACT_365F,
                      float_dc_type=DayCountTypes.ACT_365F)
    return c._plan


OIS_CASES = {
    "gbp13": (TENORS13, RATES13, None),
    "flagship_gbp32": (flagship_ois.MAIN_TENORS, flagship_ois.MAIN_RATES,
                       None),
    "gbp13_nonpositive": (TENORS13, RATES13, 1),
}


@pytest.fixture(scope="module")
def ois_refs():
    """Per case: the rates, the JAX plan, the port's plan, a projection
    and the JAX package's value, jacobian, Hessian and third order."""
    out = {}
    for name, (tenors, rates, neg) in OIS_CASES.items():
        plan = _gbp_plan(tenors, rates)
        r = np.asarray(rates) / 100.0
        if neg is not None:
            r = r.copy()
            r[neg] = -0.002
        w = np.random.default_rng(3).normal(size=plan.point_times.shape[0]
                                            + 1)

        def jf(x, plan=plan):
            return jboot.bootstrap_ois(x, plan)[1]

        def jproj(x, jf=jf, w=w):
            return jnp.dot(jnp.asarray(w), jf(x))

        rj = jnp.asarray(r)
        tplan = tboot.plan_to_torch(
            ois_plan_from_numpy(cases.plan_fields(plan)), "cpu")
        out[name] = dict(
            r=r, w=w, plan=plan, tplan=tplan,
            **_jax_orders(jf, jproj, rj))
    return out


def _jax_orders(jf, jproj, x):
    """The JAX package's value, jacobian, Hessian and third order (of
    the projection), each jitted."""
    fns = dict(value=jf, jacobian=jax.jacfwd(jf), hessian=jax.hessian(jf),
               third=jax.jacfwd(jax.hessian(jproj)))
    return {k: np.asarray(jax.jit(fn)(x)) for k, fn in fns.items()}


def _port_orders(f, proj, x):
    return dict(value=lambda: f(x), jacobian=lambda: jacrev(f)(x),
                hessian=lambda: jacfwd(jacrev(f))(x),
                third=lambda: jacfwd(jacrev(jacrev(proj)))(x))


def test_flagship_plan_shape(ois_refs):
    plan = ois_refs["flagship_gbp32"]["plan"]
    assert plan.point_times.shape[0] == 72 and plan.depth == 60


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("case", list(OIS_CASES))
def test_bootstrap_ois_matches_jax(ois_refs, case, order):
    ref = ois_refs[case]
    tplan = ref["tplan"]
    w = torch.tensor(ref["w"])

    def tf(x):
        return tboot.bootstrap_ois(x, tplan)[1]

    def proj(x):
        return torch.dot(w, tf(x))

    got = _port_orders(tf, proj, torch.tensor(ref["r"]))[order]()
    _close(got.numpy(), ref[order], TOL[order])


@pytest.fixture(scope="module")
def xccy_refs():
    jm = cases.build_xccy_model("adrates_tpu")
    tm = cases.build_xccy_model("adrates_torch")
    jc, tc = jm.curves["GBP_USD_XCCY"], tm.curves["GBP_USD_XCCY"]
    sp = np.asarray(tc.basis_spreads, dtype=np.float64)
    pv = np.asarray(tc._pv_domestic, dtype=np.float64)
    fd = np.asarray(tc._foreign_curve._dfs, dtype=np.float64)
    S = sp.shape[0]
    x0 = np.concatenate([sp, pv, fd])
    for_times = jnp.asarray(jc._foreign_curve._times)
    w = np.random.default_rng(4).normal(size=len(jc._times))

    def jf(x):
        return jx.bootstrap_xccy(
            x[:S], x[S:2 * S], for_times, x[2 * S:], jc._spot_fx, jc._plan,
            foreign_interp_type=jc._foreign_curve._interp_type,
            foreign_plan=jc._fplan)[1]

    def jproj(x):
        return jnp.dot(jnp.asarray(w), jf(x))

    xj = jnp.asarray(x0)
    tplan = tx.plan_to_torch(tc._plan, "cpu")
    fplan = tinterp.plan_to_torch(tc._fplan, "cpu")

    def tf(x):
        return tx.bootstrap_xccy(x[:S], x[S:2 * S], x[2 * S:], tc._spot_fx,
                                 tplan, tc._foreign_curve._interp_type,
                                 fplan)[1]

    return dict(x0=x0, w=w, tf=tf, **_jax_orders(jf, jproj, xj))


@pytest.mark.parametrize("order", ORDERS)
def test_bootstrap_xccy_matches_jax(xccy_refs, order):
    ref = xccy_refs
    tf = ref["tf"]
    w = torch.tensor(ref["w"])

    def proj(x):
        return torch.dot(w, tf(x))

    got = _port_orders(tf, proj, torch.tensor(ref["x0"]))[order]()
    _close(got.numpy(), ref[order], TOL[order])


# ---------------------------------------------------------------------------
# the Functions on random plans
# ---------------------------------------------------------------------------


def _tables(P=14, G=1, pad=0, depth=None, seed=0):
    prev, ci, cm, d = cases.chain_forest(np.random.default_rng(seed), P,
                                         G=G, depth=depth, pad=pad)
    return kernels.chain_tables(prev, ci, cm, d, "cpu"), prev


PLANS = {"forest": dict(P=14, seed=1), "stacked": dict(P=11, G=3, pad=3,
                                                       seed=2)}


@pytest.fixture(params=list(PLANS))
def plan(request):
    tab, prev = _tables(**PLANS[request.param])
    return dict(tab=tab, prev=np.asarray(prev), shape=tab.shape,
                rng=np.random.default_rng(9))


def _inputs(plan):
    rng = plan["rng"]
    shape = plan["shape"]
    b = torch.tensor(rng.normal(size=shape), requires_grad=True)
    d = torch.tensor(1.0 + rng.uniform(0.05, 0.5, size=shape),
                     requires_grad=True)
    return b, d


@pytest.mark.parametrize("transpose", [False, True])
def test_chain_gradcheck(plan, transpose):
    tab = plan["tab"]
    solve = ls.chain_solve_t if transpose else ls.chain_solve
    b, d = _inputs(plan)

    def fn(b, d):
        return solve(b, d, tab)

    assert torch.autograd.gradcheck(fn, (b, d), check_forward_ad=True,
                                    check_batched_grad=True,
                                    check_batched_forward_grad=True)
    assert torch.autograd.gradgradcheck(fn, (b, d), check_fwd_over_rev=True,
                                        check_batched_grad=True)


def test_neumann_gradcheck():
    rng = np.random.default_rng(12)
    S = 5
    L = torch.tensor(rng.normal(size=(S, S)) * 0.4, requires_grad=True)
    b = torch.tensor(rng.normal(size=(2, S)), requires_grad=True)

    def fn(L, b):
        return ls.neumann_solve(torch.tril(L, -1), b)

    assert torch.autograd.gradcheck(fn, (L, b), check_forward_ad=True,
                                    check_batched_grad=True,
                                    check_batched_forward_grad=True)
    assert torch.autograd.gradgradcheck(fn, (L, b), check_fwd_over_rev=True,
                                        check_batched_grad=True)


def _sweeps(b, d, prev, depth):
    """The unrolled K-sweep oracle, written apart from the port: gather
    x[prev] row by row of a stacked plan."""
    prev_t = torch.as_tensor(prev)
    idx = prev_t.clamp(min=0).expand(b.shape)
    x = b
    for _ in range(max(depth, 1)):
        x = b + torch.where(prev_t >= 0, x.gather(-1, idx), 0.0) / d
    return x


def _chain_fns(plan):
    """(f through chain_solve, f through the unrolled sweeps): three
    parameters t, moving the rates r0 + M t of the plan's shape, -> a
    [3] projection of the pv01s."""
    tab, prev = plan["tab"], plan["prev"]
    rng = np.random.default_rng(21)
    shape = plan["shape"]
    n = int(np.prod(shape))
    accs = torch.tensor(rng.uniform(0.2, 1.0, size=shape))
    r0 = torch.tensor(rng.uniform(0.0, 0.06, size=shape))
    M = torch.tensor(rng.normal(size=(n, 3)) * 0.01)
    W = torch.tensor(rng.normal(size=(3, n)))

    def make(solve):
        def f(t):
            r = r0 + (M @ t).reshape(shape)
            d = 1.0 + r * accs
            x = solve(accs / d, d)
            return W @ x.reshape(-1)
        return f

    return (make(lambda b, d: ls.chain_solve(b, d, tab)),
            make(lambda b, d: _sweeps(b, d, prev, tab.depth)))


T0 = [0.2, -0.5, 0.3]
E3 = torch.eye(3, dtype=torch.float64)


def _rows(y):
    """A smooth map after the solve, as a stage's DF rows follow its
    bootstrap (``_so_tensor``'s ``rows``)."""
    return torch.exp(0.3 * y) * y


COMPOSITIONS = {
    "vmap": lambda f, r, E: vmap(f)(r + 0.01 * E),
    "vmap_vmap": lambda f, r, E: vmap(vmap(f))(
        (r + 0.01 * E)[None].expand((2,) + E.shape)),
    "vmap_jvp": lambda f, r, E: vmap(lambda v: jvp(f, (r,), (v,))[1])(E),
    "jacrev": lambda f, r, E: jacrev(f)(r),
    "jacfwd_jacrev": lambda f, r, E: jacfwd(jacrev(f))(r),
    "jvp_grad": lambda f, r, E: vmap(lambda v: jvp(
        grad(lambda x: f(x).sum()), (r,), (v,))[1])(E),
    "speed": lambda f, r, E: jacfwd(jacrev(jacrev(
        lambda x: f(x).sum())))(r),
    "so_tensor": lambda f, r, E: _so_tensor(f, r, E, _rows)[3],
}
# the oracle's own form of the two recomposed ones (the sweeps take any
# number of forward levels)
ORACLE = {
    "speed": lambda f, r, E: jacfwd(jacfwd(jacrev(
        lambda x: f(x).sum())))(r),
    "so_tensor": lambda f, r, E: vmap(lambda s1: vmap(lambda s2: jvp(
        lambda x: jvp(lambda y: _rows(f(y)), (x,), (s1,))[1], (r,),
        (s2,))[1])(E))(E),
}


@pytest.mark.parametrize("comp", list(COMPOSITIONS))
def test_chain_compositions_match_sweeps(plan, comp):
    f, f_ref = _chain_fns(plan)
    t = torch.tensor(T0, dtype=torch.float64)
    got = COMPOSITIONS[comp](f, t, E3)
    ref = ORACLE.get(comp, COMPOSITIONS[comp])(f_ref, t, E3)
    _close(got.detach().numpy(), ref.detach().numpy(), 1e-13)


def _neumann_fns():
    """(f through neumann_solve, f through forward substitution):
    [3] parameters -> the solution of a strictly lower system."""
    rng = np.random.default_rng(31)
    S = 9
    A0 = torch.tensor(np.tril(rng.normal(size=(S, S)), -1) * 0.3)
    A1 = torch.tensor(np.tril(rng.normal(size=(S, S)), -1) * 0.1)
    b0 = torch.tensor(rng.normal(size=S))

    def parts(t):
        return A0 * (1 + t[0]) + t[1] * A1, b0 * (1 + t[2] * t[0])

    def f(t):
        return ls.neumann_solve(*parts(t))

    def f_ref(t):
        A, b = parts(t)
        xs = []
        for i in range(S):
            xi = b[i]
            for j in range(i):
                xi = xi + A[i, j] * xs[j]
            xs.append(xi)
        return torch.stack(xs)

    return f, f_ref


@pytest.mark.parametrize("comp", list(COMPOSITIONS))
def test_neumann_compositions_match_substitution(comp):
    f, f_ref = _neumann_fns()
    t = torch.tensor(T0, dtype=torch.float64)
    got = COMPOSITIONS[comp](f, t, E3)
    ref = ORACLE.get(comp, COMPOSITIONS[comp])(f_ref, t, E3)
    _close(got.detach().numpy(), ref.detach().numpy(), 1e-13)


TWO_FORWARD = {
    "jvp_jvp": lambda f, r, v: jvp(lambda x: jvp(f, (x,), (v,))[1],
                                   (r,), (v,))[1],
    "jacfwd_jacfwd": lambda f, r, v: jacfwd(jacfwd(f))(r),
    "jacfwd_jacfwd_jacrev": lambda f, r, v: jacfwd(jacfwd(jacrev(
        lambda x: f(x).sum())))(r),
}


@pytest.mark.parametrize("comp", list(TWO_FORWARD))
@pytest.mark.parametrize("solve", ["chain", "chain_t", "neumann"])
def test_two_forward_levels_raise(comp, solve):
    """Two forward-mode levels through a solve would drop the cross
    terms; every solve raises instead of returning that number."""
    if solve == "neumann":
        f, _ = _neumann_fns()
        r = torch.tensor([0.1, -0.3, 0.2], dtype=torch.float64)
    else:
        tab, _ = _tables(seed=5)
        sl = ls.chain_solve_t if solve == "chain_t" else ls.chain_solve

        def f(x):
            d = 1.0 + 0.5 * x
            return sl(0.5 / d, d, tab)

        r = torch.full(tab.shape, 0.03, dtype=torch.float64)
    with pytest.raises(LibError, match="forward-mode levels"):
        TWO_FORWARD[comp](f, r, torch.ones_like(r))


def test_forward_levels_counts_jvp_only():
    x = torch.ones(2, dtype=torch.float64)
    seen = []

    def probe(y):
        seen.append(ls.forward_levels())
        return y * 2.0

    probe(x)
    jacrev(probe)(x)
    jacfwd(probe)(x)
    jacfwd(jacrev(probe))(x)
    jacfwd(jacfwd(probe))(x)
    assert seen == [0, 0, 1, 1, 2]


def _solve_calls(fn):
    before = kernels.pv01_solve.calls + kernels.pv01_solve_t.calls
    fn()
    return kernels.pv01_solve.calls + kernels.pv01_solve_t.calls - before


@pytest.mark.parametrize("comp", ["value"] + list(COMPOSITIONS))
def test_solve_count_does_not_grow_with_depth(comp):
    counts = []
    for depth in (30, 60):
        tab, prev = _tables(P=depth + 10, depth=depth, seed=depth)
        assert tab.depth >= depth
        p = dict(tab=tab, prev=prev, shape=tab.shape,
                 rng=np.random.default_rng(0))
        f, _ = _chain_fns(p)
        t = torch.tensor(T0, dtype=torch.float64)
        run = (lambda: f(t)) if comp == "value" else \
            (lambda: COMPOSITIONS[comp](f, t, E3))
        launches = kernels.pv01_solve.launches
        counts.append(_solve_calls(run))
        assert kernels.pv01_solve.launches == launches    # CPU: no kernel
    assert counts[0] == counts[1]
    assert 1 <= counts[0] <= 8


@pytest.mark.parametrize("case", ["gbp13", "flagship_gbp32"])
def test_bootstrap_gamma_tower_solves(ois_refs, case):
    """The engine's request (value, jacrev, jacfwd∘jacrev) and speed
    through ``bootstrap_ois``: the same handful of solves at depth 60
    (flagship_v5's GBP) as at the 13-pillar curve's depth."""
    ref = ois_refs[case]
    tplan = ref["tplan"]
    w = torch.tensor(ref["w"])
    r = torch.tensor(ref["r"])

    def pv(x):
        return torch.dot(w, tboot.bootstrap_ois(x, tplan)[1])

    assert _solve_calls(lambda: pv(r)) == 1
    assert _solve_calls(lambda: jacrev(pv)(r)) == 2
    assert _solve_calls(lambda: jacfwd(jacrev(pv))(r)) == 4
    assert _solve_calls(lambda: jacfwd(jacrev(jacrev(pv)))(r)) == 8


# ---------------------------------------------------------------------------
# K4 / K5 arithmetic and tables
# ---------------------------------------------------------------------------


def _k4_emulated(b, d, prev):
    """K4's single ascending pass per row, in numpy scalars, as the kernel
    walks it: where a point's link is the point just before, the value
    carried from the last step; a far link's value read a step ahead; a
    root's 0. Each x_i = b_i + v / d_i."""
    R, P = b.shape
    G = prev.shape[0]
    x = b.copy()
    for r in range(R):
        pv = prev[r % G]
        carry = ahead = 0.0
        for i in range(P):
            v = carry if pv[i] == i - 1 else ahead
            pn = pv[i + 1] if i + 1 < P else -1
            ahead = x[r, pn] if 0 <= pn < i else 0.0
            carry = x[r, i] = b[r, i] + v / d[r, i]
    return x


def _k5_emulated(c, d, prev):
    """K5's single descending pass per row, in numpy scalars, as the kernel
    walks it: y_i = (c_i + f_i) + the adjacent child's y_{i+1} / d_{i+1}
    (carried), f_i the far children's terms summed from 0 in descending
    order."""
    R, P = c.shape
    G = prev.shape[0]
    y = c.copy()
    for r in range(R):
        pv = prev[r % G]
        f = np.zeros(P)
        carry = 0.0
        for i in range(P - 1, -1, -1):
            ahead = c[r, i] + f[i]
            y[r, i] = ahead + carry if i + 1 < P and pv[i + 1] == i \
                else ahead
            carry = y[r, i] / d[r, i]
            if pv[i] >= 0 and pv[i] != i - 1:
                f[pv[i]] += carry
    return y


def _pass_inputs(rng, R, P):
    return rng.normal(size=(R, P)), 1.0 + rng.uniform(0.01, 0.4, size=(R, P))


@pytest.mark.parametrize("G", [1, 3])
def test_kernel_passes_match_plain(G):
    tab, prev = _tables(P=23, G=G, pad=2 if G > 1 else 0, seed=40 + G)
    prev = np.asarray(prev).reshape(G, -1)
    b, d = _pass_inputs(np.random.default_rng(G), 4 * G, prev.shape[1])
    tb, td = torch.tensor(b), torch.tensor(d)
    x = kernels.pv01_solve(tb, td, tab)
    assert torch.equal(x, torch.tensor(_k4_emulated(b, d, prev)))
    assert torch.equal(x, kernels.pv01_solve_plain(tb, td, tab))
    y = kernels.pv01_solve_t(tb, td, tab)
    _close(y.numpy(), _k5_emulated(b, d, prev), 1e-14)


@pytest.mark.parametrize("kind", ["one_chain", "interleaved", "padded_stack"])
def test_kernel_passes_on_edge_plans(kind):
    """On plans where no point has two children, both passes equal their
    plain sweeps bit for bit: one chain of 72 (every link the point just
    before), two interleaved chains (none), and flagship_v5's OIS stage
    shape (G = 7, padded)."""
    prev, ci, cm, depth = cases.chain_edge_plan(kind)
    tab = kernels.chain_tables(prev, ci, cm, depth, "cpu")
    prev = prev.reshape(-1, prev.shape[-1])
    G, P = prev.shape
    b, d = _pass_inputs(np.random.default_rng(len(kind)), 3 * G, P)
    tb, td = torch.tensor(b), torch.tensor(d)
    x = kernels.pv01_solve_plain(tb, td, tab)
    assert torch.equal(x, torch.tensor(_k4_emulated(b, d, prev)))
    assert torch.equal(x, kernels.pv01_solve(tb, td, tab))
    y = kernels.pv01_solve_t_plain(tb, td, tab)
    assert torch.equal(y, torch.tensor(_k5_emulated(b, d, prev)))


def test_chain_tables_refuse_a_forward_link():
    prev = np.array([-1, 0, 3, 1])
    with pytest.raises(ValueError, match="precede"):
        kernels.chain_tables(prev, np.zeros((4, 1), np.int64),
                             np.zeros((4, 1)), 3, "cpu")


def test_chain_wrappers_refuse_ragged_rows():
    tab, _ = _tables(P=11, G=3, pad=3, seed=2)
    b = torch.ones((4, 11), dtype=torch.float64)
    with pytest.raises(ValueError, match="multiple of 3"):
        kernels.pv01_solve(b, b, tab)
