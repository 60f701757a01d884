"""The OIS stage on K13 / K14's plain versions and on their lanes emulated
in Python (``ops/ois_stage``):

- the structured split with its OIS stages on the kernel route on the CPU
  (the wrappers' plain versions, ``torch.func`` over ``ois_native_ds`` and
  ``stage_rows``) and with the kernels' lanes in their place
  (``emulate_jvp`` / ``emulate_hess``), against the JAX package's
  ``make_structured_parts``: ``fwd_delta``'s OIS pass (dfs, J) and
  ``term2_ois`` at 1e-10 x max|ref|, on the 3-curve OIS book (one
  scenario pushing a curve's quotes across zero, so its sub-pillar rates
  are linear, one putting a quote below the 1e-8 clamp), the OIS + XCCY
  book recalibrated and held, and the inflation book (its inflation stage
  keeps the towers);
- the lanes against ``torch.func`` at 1e-13 x max|ref| on seeded stages
  (FLAT_FWD, LINEAR_ZERO and LINEAR_FWD members, more than 32 quotes, a
  member crossing zero, a quote below the clamp);
- the routes: a fitted member, an inflation stage, an oversized plan and
  a link that is not backward keep ``torch.func`` with their reason, and
  a book whose stages all keep it still prices as the JAX package does;
- the torch ops of region A's and C2's OIS passes with K13 / K14 counted
  as one op each, against the towers'.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import adrates_tpu  # noqa: F401 — enables x64 for the JAX side
import torch_cases as cases
from adrates_tpu.parallel import structured_risk as jsr
from adrates_torch.ops import kernels
from adrates_torch.ops import ois_stage as os_
from adrates_torch.parallel import multibook as tmb
from adrates_torch.parallel import structured_risk as tsr
from adrates_torch.utils.global_types import InterpTypes


def _ois_shocks(basket, n_quotes):
    """Three scenarios: the seeded shocks, then scenario 1 moves the first
    curve's quotes across zero and scenario 2 puts the second curve's
    second quote at 5e-9 (below the log-rates' 1e-8 clamp)."""
    sh = cases.shocks(n_quotes)
    q0 = basket.quotes0
    names = [sp.name for sp in basket.specs if sp.kind == "ois"]
    a = basket.quote_slice(names[0])
    sh[1, a] = -q0[a] + (q0[a] - q0[a].mean())
    b = basket.quote_slice(names[1])
    sh[2, b.start + 1] = 5e-9 - q0[b.start + 1]
    return sh


BOOKS = ["ois", "xccy_recal", "xccy_held", "infl"]


def _port_book(name, pkg="adrates_torch"):
    """(the tiled book of one of ``BOOKS`` through ``pkg``, shocks)."""
    if name == "ois":
        tb = cases.compile_book(pkg, cases.build_model(pkg))[1]
        return tb, _ois_shocks(tb.basket, tb.basket.n_quotes)
    if name == "infl":
        m = cases.build_infl_model(pkg)
        tb = cases.compile_tiled(pkg, m, cases.infl_trades_for(pkg, m))[1]
    else:
        tb = cases.compile_xccy_book(pkg, cases.build_xccy_model(pkg),
                                     recalibrate_xccy=name == "xccy_recal")
    return tb, cases.shocks(tb.basket.n_quotes)


@pytest.fixture(scope="module", params=BOOKS)
def book(request):
    """dict(name, ref: the JAX references, tb: the port's book, topo,
    dbook: its device book, q: quotes [3, N])."""
    jb, sh = _port_book(request.param, "adrates_tpu")
    tb, _ = _port_book(request.param)
    q0 = jb.basket.quotes0
    jp = jsr.make_structured_parts(jb.basket, host_agg=jb.aggregate)
    P, agg = jb.basket.params, jb.aggregate
    jfw = jax.jit(jax.vmap(lambda s: jp["fwd_delta"](q0 + s, P, agg,
                                                     None)))(sh)
    jh2x, jv = jax.jit(jax.vmap(lambda s, g, c: jp["term2_xccy"](
        q0 + s, P, g, c)))(sh, jfw["g"], jfw["carry"])
    jh2o = jax.jit(jax.vmap(lambda s, g, v: jp["term2_ois"](
        q0 + s, P, g, v)))(sh, jfw["g"], jv)
    ref = jax.tree.map(np.asarray, dict(dfs=jfw["dfs"], J=jfw["J"],
                                        h2o=jh2o))
    return dict(name=request.param, ref=ref, tb=tb,
                topo=tmb.book_inputs(tb).topology,
                dbook=tmb.make_multibook_fn(tb, "cpu").book,
                q=torch.tensor(q0[None, :] + sh))


def _close(got, ref, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * np.abs(ref).max())


def _run(topo, dbook, q):
    """fwd_delta's dfs and J and term2_ois of the port."""
    parts = tsr.make_structured_parts(topo)
    fw = parts["fwd_delta"](q, dbook.params, dbook.aggregate,
                            dbook.clamp_agg)
    _, v_of = parts["term2_xccy"](q, dbook.params, fw["g"], fw["carry"])
    h2o = parts["term2_ois"](q, dbook.params, fw["g"], v_of)
    return dict(dfs=fw["dfs"], J=fw["J"], h2o=h2o)


def _emulated(monkeypatch):
    """K13 / K14's CPU route through the kernels' lanes (numpy out as
    tensors) in place of the plain versions."""
    def jvp(tab, q):
        return tuple(torch.as_tensor(x) for x in os_.emulate_jvp(tab, q))

    def hess(tab, q, gs, vs):
        return torch.as_tensor(os_.emulate_hess(tab, q, gs, vs))
    monkeypatch.setattr(os_, "ois_stage_jvp_plain", jvp)
    monkeypatch.setattr(os_, "ois_stage_hess_plain", hess)


@pytest.mark.parametrize("route", ["plain", "lanes"])
def test_routed_ois_pass_and_term2_ois(book, route, monkeypatch):
    """dfs, J and term2_ois with every OIS stage on the K13 / K14 route
    (their plain versions, or the kernels' lanes) equal the JAX package's
    at 1e-10 x max|ref|; the OIS stages take the route, the inflation
    stage keeps the towers, and nothing counts a launch on the CPU."""
    name, ref, topo, dbook = (book[k] for k in ("name", "ref", "topo",
                                                 "dbook"))
    routes = os_.ois_stage_routes(topo)
    assert sorted(dbook.params["ostage"]) == sorted(
        si for si, r in routes.items() if r == "kernels")
    assert sorted(r for r in routes.values() if r != "kernels") == (
        ["torch.func: an inflation stage"] if name == "infl" else [])
    if route == "lanes":
        _emulated(monkeypatch)
    before = (kernels.ois_stage_jvp.launches, kernels.ois_stage_hess.launches)
    got = _run(topo, dbook, book["q"])
    assert (kernels.ois_stage_jvp.launches,
            kernels.ois_stage_hess.launches) == before
    for key in ("dfs", "J", "h2o"):
        _close(got[key], ref[key], 1e-10)


def test_stage_pass_outputs(book):
    """The route's pass 1 gives the towers' ds, rows, dds and drows: K13's
    plain version on the stage's tables and the lanes at 1e-13 x
    max|ref|, at the book's scenarios."""
    topo, dbook, q = book["topo"], book["dbook"], book["q"]
    for si, tab in dbook.params["ostage"].items():
        ql = q[:, dbook.params["bat"][topo.stages[si].key]["qidx"]]
        ref = os_.ois_stage_jvp_plain(tab, ql)
        for a, b in zip(os_.emulate_jvp(tab, ql), ref):
            _close(a, b.numpy(), 1e-13)


# ---------------------------------------------------------------------------
# the lanes against torch.func on seeded stages
# ---------------------------------------------------------------------------


STAGES = {
    "mixed": ([(5, 2, "LINEAR_ZERO_RATES"), (8, 1, "FLAT_FWD_RATES"),
               (6, 2, "LINEAR_FWD_RATES")], 40),
    "qp36": ([(9, 2, "LINEAR_ZERO_RATES"), (36, 1, "FLAT_FWD_RATES")], 50),
}


def _stage(name, cross):
    members, W = STAGES[name]
    tab, q = cases.ois_stage_case(members, W, 3, 5, "cpu")
    if cross:
        # member 0 crosses zero in scenario 0 (linear rates) and has a
        # quote below the clamp in scenario 1
        q = q.clone()
        q[0, 0] = q[0, 0] - q[0, 0].mean()
        q[1, 0, 1] = 4e-9
        assert (q[0, 0] < 0).any() and (q[0, 0] > 0).any()
    rng = np.random.default_rng(6)
    gs = torch.tensor(rng.standard_normal((3, tab.G, tab.W)))
    vs = torch.tensor(rng.standard_normal((3, tab.G, tab.P1)))
    return tab, q, gs, vs


@pytest.mark.parametrize("cross", [False, True], ids=["log", "cross_zero"])
@pytest.mark.parametrize("name", sorted(STAGES))
def test_lanes_hold_torch_func(name, cross):
    """K13's and K14's lanes (dual chains, the node band, the dual adjoint
    sweeps) equal torch.func's jvp and jvp over grad at 1e-13 x
    max|ref|, every output."""
    tab, q, gs, vs = _stage(name, cross)
    for a, b in zip(os_.emulate_jvp(tab, q), os_.ois_stage_jvp_plain(tab, q)):
        _close(a, b.numpy(), 1e-13)
    _close(os_.emulate_hess(tab, q, gs, vs),
           os_.ois_stage_hess_plain(tab, q, gs, vs).numpy(), 1e-13)


@pytest.mark.parametrize("name", sorted(STAGES))
def test_node_band_equals_the_rows_sums(name):
    """K14's node band, summed by chunks of 32 rows in lane groups
    (``node_band``), equals the sums over each node's and each band
    entry's rows in row order (``xccy_stage.rows_prologue`` on the same
    rows) at 1e-14 x max|ref|, on stages whose rows past a member's last
    knot crowd up to 18 rows of a chunk onto one node."""
    from adrates_torch.ops import xccy_stage
    tab, q, gs, vs = _stage(name, False)
    h = tab.host()
    ds = os_.emulate_jvp(tab, q)[0]
    nr_ptr, nr_row, _, mb_ptr, mb_row = xccy_stage._row_bands(h["rq_i"],
                                                             tab.P1)
    ref_h = dict(h, nr_ptr=nr_ptr, nr_row=nr_row, mb_ptr=mb_ptr,
                 mb_row=mb_row)
    crowd = max(int(np.bincount(h["rq_i"][g, w0:w0 + 32, 0]).max())
                for g in range(tab.G) for w0 in range(0, tab.W, 32))
    assert crowd >= 10
    for sc in range(q.shape[0]):
        for g in range(tab.G):
            w, md, mo = os_.node_band(h, g, list(ds[sc, g]), gs[sc, g],
                                      vs[sc, g])
            a, md_r, mo_r = xccy_stage.rows_prologue(ref_h, g,
                                                     list(ds[sc, g]),
                                                     gs[sc, g])
            w_r = np.asarray(a) + vs[sc, g].numpy()
            for got, ref in ((w, w_r), (md, md_r), (mo, mo_r)):
                _close(np.asarray(got), np.asarray(ref), 1e-14)


def test_linear_rates_and_the_clamp():
    """Where a member's quotes cross zero its sub-pillar rates are linear
    (quote 0's tangent reaches a point between pillars 0 and 1 at weight
    1 - c), and a quote below 1e-8 passes no tangent through the
    log-linear rates of the points it brackets, only to its own pillar's
    point."""
    tab, q, _, _ = _stage("mixed", True)
    h = tab.host()
    pt = h["pt_i"][0]
    sub = [p for p in range(tab.P) if pt[p, 1] < 0 and pt[p, 2] == 0
           and pt[p, 3] == 1]
    assert sub
    lin = os_.lane_chain(h, 0, q[0, 0].numpy(), 0)
    c = float(h["pt_f"][0, sub[0], 1])
    assert lin[sub[0]][0].e == pytest.approx(1.0 - c, abs=1e-15)
    low = os_.lane_chain(h, 0, q[1, 0].numpy(), 1)
    near = [p for p in range(tab.P) if pt[p, 1] < 0
            and 1 in (pt[p, 2], pt[p, 3])]
    assert near and all(low[p][0].e == 0.0 for p in near)
    own = int(np.flatnonzero(pt[:, 1] == 1)[0])
    assert low[own][0].e == 1.0
    _, _, dds, _ = os_.emulate_jvp(tab, q)
    assert dds[1, 1, 0, 1 + own] != 0.0


# ---------------------------------------------------------------------------
# the routes
# ---------------------------------------------------------------------------


def test_routes_and_their_reasons():
    """A fitted member, an inflation stage, an oversized plan and a link
    that is not backward keep torch.func, each with its reason."""
    st, its, b = cases.ois_stage_host([(6, 1, "FLAT_FWD_RATES"),
                                       (4, 1, "LINEAR_ZERO_RATES")], 30, 1)
    assert os_.ois_stage_route(st, its, b) == "kernels"
    fitted = [its[0], InterpTypes.PCHIP_ZERO_RATES]
    assert os_.ois_stage_route(st, fitted, b) == \
        "torch.func: a fitted member scheme (PCHIP_ZERO_RATES)"
    infl = dataclasses.replace(st, kind="infl")
    assert os_.ois_stage_route(infl, its, b) == \
        "torch.func: an inflation stage"
    st2, its2, big = cases.ois_stage_host([(50, 4, "FLAT_FWD_RATES")], 30, 1)
    assert os_.ois_stage_route(st2, its2, big) == (
        f"torch.func: 200 points / 50 quotes / 30 rows exceed the kernels' "
        f"{os_.MAX_P} / {os_.MAX_Q} / {os_.MAX_W}")
    prev = b["plan"].prev_idx.copy()
    prev[0, 2] = 4
    bad = dict(b, plan=dataclasses.replace(b["plan"], prev_idx=prev))
    assert os_.ois_stage_route(st, its, bad) == (
        "torch.func: OIS plan: a point's previous point does not precede it")


def test_fitted_stage_keeps_the_towers():
    """A stage with fitted members (``fitted_parent_book``'s USD PCHIP and
    GBP natural-cubic curves) keeps torch.func: the book's device tables
    hold no OisStageTables for it."""
    _, tb = cases.fitted_parent_book("adrates_torch", True)
    topo = tmb.book_inputs(tb).topology
    routes = os_.ois_stage_routes(topo)
    assert routes and all(r.startswith("torch.func: a fitted member")
                          for r in routes.values())
    assert tmb.make_multibook_fn(tb, "cpu").book.params["ostage"] == {}


def test_every_stage_off_the_route(book, monkeypatch):
    """With every OIS stage off the route the book builds no
    OisStageTables and its parts still equal the JAX package's."""
    monkeypatch.setattr(tsr, "ois_stage_routes", lambda topo: {
        si: "torch.func: off" for si, st in enumerate(topo.stages)
        if st.kind != "xccy"})
    dbook = tmb.make_multibook_fn(book["tb"], "cpu").book
    assert dbook.params["ostage"] == {}
    got = _run(book["topo"], dbook, book["q"])
    for key in ("dfs", "J", "h2o"):
        _close(got[key], book["ref"][key], 1e-10)


# ---------------------------------------------------------------------------
# torch ops of the OIS passes
# ---------------------------------------------------------------------------


def _span_ops(f, prefix):
    """Leaf non-view aten ops of one ``f()`` call inside the profiler
    spans whose name starts with ``prefix`` (``structured_risk._span``)."""
    from torch.autograd import DeviceType
    views = {"aten::" + n for n in (
        "view", "as_strided", "reshape", "expand", "permute", "transpose",
        "select", "slice", "unsqueeze", "squeeze", "t", "detach", "alias",
        "empty", "_unsafe_view", "lift_fresh", "empty_like",
        "empty_strided", "narrow", "unbind", "split", "_reshape_alias",
        "expand_as", "view_as", "contiguous", "movedim", "diagonal",
        "split_with_sizes", "item", "_local_scalar_dense", "is_nonzero",
        "result_type", "to", "_to_copy")}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        f()
    n = 0
    for e in prof.events():
        if e.device_type != DeviceType.CPU or not e.name.startswith("aten::") \
                or e.name in views:
            continue
        if any(c.name.startswith("aten::") and c.name not in views
               for c in e.cpu_children):
            continue
        p = e.cpu_parent
        while p is not None and not p.name.startswith(prefix):
            p = p.cpu_parent
        n += p is not None
    return n


def test_op_counts_of_the_ois_passes(monkeypatch):
    """On the OIS + XCCY book (3 scenarios), with K13 and K14 one op each
    (their outputs one ``torch.zeros``), region A's OIS pass takes at most
    4 ops and C2's at most 1, where the towers take over 250 and 600."""
    tb, sh = _port_book("xccy_recal")
    dbook = tmb.make_multibook_fn(tb, "cpu").book
    topo = tmb.book_inputs(tb).topology
    parts = tsr.make_structured_parts(topo)
    q = torch.tensor(tb.basket.quotes0[None, :] + sh)
    P = dbook.params

    def count():
        fw = parts["fwd_delta"](q, P, dbook.aggregate, dbook.clamp_agg)
        _, v_of = parts["term2_xccy"](q, P, fw["g"], fw["carry"])
        return (_span_ops(lambda: parts["fwd_delta"](
            q, P, dbook.aggregate, dbook.clamp_agg), "A:ois"),
            _span_ops(lambda: parts["term2_ois"](q, P, fw["g"], v_of),
                      "C2:ois"))

    monkeypatch.setattr(tsr, "ois_stage_routes", lambda topo: {
        si: "torch.func: off" for si, st in enumerate(topo.stages)
        if st.kind != "xccy"})
    parts = tsr.make_structured_parts(topo)
    towers = count()
    monkeypatch.undo()
    parts = tsr.make_structured_parts(topo)

    def one_op_jvp(tab, ql):
        n = [tab.P1, tab.W, tab.Qp * tab.P1, tab.Qp * tab.W]
        out = torch.zeros((ql.shape[0], tab.G, sum(n)), dtype=ql.dtype)
        a, b, c, d = out.split(n, dim=-1)
        return (a, b, c.reshape(-1, tab.G, tab.Qp, tab.P1).transpose(1, 2),
                d.reshape(-1, tab.G, tab.Qp, tab.W).transpose(1, 2))

    monkeypatch.setattr(kernels, "ois_stage_jvp", one_op_jvp)
    monkeypatch.setattr(kernels, "ois_stage_hess",
                        lambda tab, ql, gs, vs: torch.zeros(
                            (ql.shape[0], tab.Qp, tab.G, tab.Qp),
                            dtype=ql.dtype))
    routed = count()
    assert routed[0] <= 4 and routed[1] <= 1, routed
    assert towers[0] > 250 and towers[1] > 600, towers
