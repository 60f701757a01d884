"""The XCCY stage on K8-K11's plain versions (``ops/xccy_stage``), on the
small OIS + XCCY book of ``test_torch_structured`` (GBP_USD_XCCY over the
USD and GBP OIS curves: G = 1, S = 3), recalibrated in-graph and held as
values:

- the structured split with the stage on the kernel route on the CPU
  (the wrappers' plain versions, reading the packed tables) against the
  JAX package's ``make_structured_parts``: dfs, J, and ``term2_xccy``'s
  H2 and parent cotangents, at ``test_torch_structured``'s tolerances
  (each a multiple of the largest reference entry); its ``carry`` against
  the torch.func route's; a plan the single forward pass cannot take
  keeps the torch.func route, and the book still builds and prices;
- the kernels' per-thread evaluation (``xccy_stage.thread_stage`` /
  ``thread_legs``) in hyper-dual numpy arithmetic, every pair thread of
  K10 and K11, in place of the Hessian kernels: H2 and the cotangents
  against the JAX package at 1e-12; the pair tables cover each i <= j
  once and every entry is written, mirrored bit for bit; its dual
  threads against the plain K8 / K9, and K11's on legs that do not
  telescope (a cap and floor, an ia = 0 slot, a fixed first coupon);
- ``kernel_route`` over the eight schemes (the members' schemes decide
  it; the parents' may be fitted), and the packed tables' invariants.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import adrates_tpu  # noqa: F401 — enables x64 for the JAX side
import torch_cases as cases
from adrates_tpu.parallel import structured_risk as jsr
from adrates_torch.ops import kernels
from adrates_torch.ops import xccy_stage as xs
from adrates_torch.parallel import multibook as tmb
from adrates_torch.parallel import structured_risk as tsr
from adrates_torch.parallel.curve_batching import _Stage
from adrates_torch.utils.error import LibError
from adrates_torch.utils.global_types import InterpTypes

SIMPLE = (InterpTypes.FLAT_FWD_RATES, InterpTypes.LINEAR_ZERO_RATES,
          InterpTypes.LINEAR_FWD_RATES)


@pytest.fixture(scope="module", params=[True, False],
                ids=["recal", "values"])
def book(request):
    """(recal, the JAX references, the port's topology, its device book,
    quotes [3, N], the port's book)."""
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
    jh2x, jv = jax.jit(jax.vmap(lambda s, g, c: jp["term2_xccy"](
        q0 + s, P, g, c)))(sh, jfw["g"], jfw["carry"])
    ref = jax.tree.map(np.asarray, dict(dfs=jfw["dfs"], J=jfw["J"],
                                        g=jfw["g"], h2x=jh2x, v_of=jv))
    dbook = tmb.make_multibook_fn(tb, "cpu").book
    topo = tmb.book_inputs(tb).topology
    q = torch.tensor(q0[None, :] + sh)
    return recal, ref, topo, dbook, q, tb


def _close(got, ref, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * np.abs(ref).max())


def _v_of_close(got, ref, tol):
    assert sorted(got) == sorted(ref)
    scale = max((np.abs(v).max() for v in ref.values()), default=0.0)
    for k, v in ref.items():
        np.testing.assert_allclose(got[k].numpy(), v, rtol=0,
                                   atol=tol * scale, err_msg=k)


def _parts(book):
    _, _, topo, dbook, q, _ = book
    parts = tsr.make_structured_parts(topo)
    fw = parts["fwd_delta"](q, dbook.params, dbook.aggregate,
                            dbook.clamp_agg)
    return parts, fw


def _launch_counts():
    return [getattr(kernels, k).launches for k in (
        "xccy_stage_jvp", "xccy_legs_jvp", "xccy_stage_hess",
        "xccy_legs_hess")]


@pytest.mark.parametrize("key,tol", [("dfs", 1e-14), ("g", 1e-11),
                                     ("J", 1e-11)])
def test_fwd_delta_on_the_kernel_route(book, key, tol):
    """fwd_delta's pass 2 on K8 / K9's plain versions equals the JAX
    package's fwd_delta; on the CPU nothing counts a launch."""
    before = _launch_counts()
    _, fw = _parts(book)
    assert _launch_counts() == before
    _close(fw[key], book[1][key], tol)


def test_term2_xccy_on_the_kernel_route(book):
    """term2_xccy on K10 / K11's plain versions: H2 and every parent
    cotangent equal the JAX package's."""
    recal, ref, _, dbook, q, _ = book
    parts, fw = _parts(book)
    h2x, v_of = parts["term2_xccy"](q, dbook.params, fw["g"], fw["carry"])
    _close(h2x, ref["h2x"], 1e-10)
    assert bool(v_of) == recal
    _v_of_close(v_of, ref["v_of"], 1e-10)


def test_the_route_keeps_the_carry(book, monkeypatch):
    """The kernel route leaves ``carry`` with the torch.func route's keys,
    shapes and values (term2_ois and the per-trade prep read it)."""
    _, _, topo, dbook, q, _ = book
    _, fw = _parts(book)
    monkeypatch.setattr(tsr, "stage_routes", lambda topo: {})
    tf = tsr.make_structured_parts(topo)["fwd_delta"](
        q, dbook.params, dbook.aggregate, dbook.clamp_agg)
    assert sorted(fw["carry"]) == sorted(tf["carry"])
    for si, c in tf["carry"].items():
        assert sorted(fw["carry"][si]) == sorted(c)
        for k, v in c.items():
            got = fw["carry"][si][k]
            assert got.shape == v.shape
            scale = float(v.abs().max())
            assert float((got - v).abs().max()) <= 1e-12 * max(scale, 1.0)


def emulate_stage_hess(h: dict, sp, pv, fd, tf, gs):
    """K10 over every thread, in Python: ``xccy_stage.HyperDual`` pair
    threads from ``pair_table(D)``, each written at [i, j] and [j, i], and
    ``Dual`` threads for the foreign grid; (gZ [Sc, G, D], gf [Sc, G, Lf]
    or None, H [Sc, D, G, D]) as numpy, from numpy inputs shaped as the
    kernel's."""
    Sc, G, D, Lf = sp.shape[0], h["G"], h["D"], h["Lf"]
    gZ = np.zeros((Sc, G, D))
    gf = np.zeros((Sc, G, Lf))
    H = np.full((Sc, D, G, D), np.nan)
    none = (xs.DIR_NONE, 0, None)
    for sc in range(Sc):
        for g in range(G):
            def total(T, d1, d2):
                out = [T(0.0)]

                def sink(w, v):
                    out[0] = out[0] + v * float(gs[sc, g, w])
                xs.thread_stage(T, h, g, sp[sc, g], pv[sc, g], fd[sc, g],
                                d1, d2, sink)
                return out[0]

            def d(i):
                return xs.stage_dir(h, i, None if tf is None
                                    else tf[sc, i, g])
            for i, j in xs.pair_table(D):
                t = total(xs.HyperDual, d(i), d(j))
                H[sc, i, g, j] = H[sc, j, g, i] = t.ab
                if i == j:
                    gZ[sc, g, i] = t.a
            if h["recal"]:
                for ll in range(Lf):
                    gf[sc, g, ll] = total(xs.Dual, (xs.DIR_UNIT, ll, None),
                                          none).e
    return gZ, (gf if h["recal"] else None), H


def emulate_legs_hess(h: dict, dd, tdl, gpv):
    """K11 over every thread, in Python: (gdd [Sc, G, Ld], Hl [Sc, Qd, G,
    Qd]) as numpy."""
    Sc, G, Qd, Ld = dd.shape[0], h["G"], h["Qd"], h["Ld"]
    gdd = np.zeros((Sc, G, Ld))
    Hl = np.full((Sc, Qd, G, Qd), np.nan)
    none = (xs.DIR_NONE, 0, None)
    for sc in range(Sc):
        for g in range(G):
            def total(T, d1, d2):
                out = [T(0.0)]

                def sink(s, v):
                    out[0] = out[0] + v * float(gpv[sc, g, s])
                xs.thread_legs(T, h, g, dd[sc, g], d1, d2, sink)
                return out[0]
            for i, j in xs.pair_table(Qd):
                t = total(xs.HyperDual, (xs.DIR_ROW, 0, tdl[sc, i, g]),
                          (xs.DIR_ROW, 0, tdl[sc, j, g]))
                Hl[sc, i, g, j] = Hl[sc, j, g, i] = t.ab
            for ll in range(Ld):
                gdd[sc, g, ll] = total(xs.Dual, (xs.DIR_UNIT, ll, None),
                                       none).e
    return gdd, Hl


def _emulated(book):
    """term2_xccy with K10 and K11 replaced by every thread of their
    per-thread evaluation in hyper-dual numpy arithmetic."""
    _, _, topo, dbook, q, _ = book
    parts, fw = _parts(book)

    def hess(tab, sp, pv, fd, tf, gs):
        out = emulate_stage_hess(
            tab.host(), sp.numpy(), pv.numpy(), fd.numpy(),
            None if tf is None else tf.numpy(), gs.numpy())
        return tuple(None if o is None else torch.tensor(o) for o in out)

    def legs(tab, dd, tdl, gpv):
        return tuple(torch.tensor(o) for o in emulate_legs_hess(
            tab.host(), dd.numpy(), tdl.numpy(), gpv.numpy()))

    mp = pytest.MonkeyPatch()
    mp.setattr(kernels, "xccy_stage_hess", hess)
    mp.setattr(kernels, "xccy_legs_hess", legs)
    try:
        return parts["term2_xccy"](q, dbook.params, fw["g"], fw["carry"])
    finally:
        mp.undo()


def test_hyper_dual_threads_hold_the_jax_hessian(book):
    """Every pair thread of K10 / K11 in hyper-dual numpy arithmetic:
    term2_xccy's H2 and cotangents at 1e-12 x max|ref|."""
    recal, ref, *_ = book
    h2x, v_of = _emulated(book)
    _close(h2x, ref["h2x"], 1e-12)
    _v_of_close(v_of, ref["v_of"], 1e-12)


def test_pair_threads_cover_each_pair_once_and_mirror(book):
    """The pair tables hold each i <= j once; the emulated K10 writes
    every entry of H (from NaN), H equals its mirror bit for bit and
    equals the plain K10's; gZ and gf equal the plain version's."""
    for D in (1, 2, 7, 48):
        pt = xs.pair_table(D)
        assert pt.shape == (D * (D + 1) // 2, 2)
        assert (pt[:, 0] <= pt[:, 1]).all()
        assert len({tuple(p) for p in pt.tolist()}) == pt.shape[0]
    _, _, topo, dbook, q, _ = book
    _, fw = _parts(book)
    for si, tab in dbook.params["xstage"].items():
        c = fw["carry"][si]
        st = topo.stages[si]
        sp = q[:, dbook.params["bat"][st.key]["qidx"]]
        pv = c["pv0"] if tab.recal else tab.pv_dom0.expand(
            q.shape[0], tab.G, tab.S).contiguous()
        gs = torch.tensor(np.random.default_rng(5).standard_normal(
            (q.shape[0], tab.G, tab.W)))
        tf = c.get("tf2")
        gZ, gf, H = emulate_stage_hess(
            tab.host(), sp.numpy(), pv.numpy(), c["for_ds"].numpy(),
            None if tf is None else tf.numpy(), gs.numpy())
        assert not np.isnan(H).any()
        assert np.array_equal(H, H.transpose(0, 3, 2, 1))
        rgZ, rgf, rH = xs.xccy_stage_hess_plain(tab, sp, pv, c["for_ds"],
                                                tf, gs)
        _close(H, rH.numpy(), 1e-12)
        _close(gZ, rgZ.numpy(), 1e-12)
        if tab.recal:
            _close(gf, rgf.numpy(), 1e-12)


def test_dual_threads_hold_the_plain_jvps(book):
    """K8's and K9's dual threads, emulated, equal the plain versions'
    directional derivatives (K9 on legs that do not telescope)."""
    _, _, topo, dbook, q, _ = book
    _, fw = _parts(book)
    for si, tab in dbook.params["xstage"].items():
        c = fw["carry"][si]
        st = topo.stages[si]
        sp = q[:, dbook.params["bat"][st.key]["qidx"]]
        pv = c["pv0"] if tab.recal else tab.pv_dom0.expand(
            q.shape[0], tab.G, tab.S).contiguous()
        tf = c.get("tf2")
        ds, rows, drows = xs.xccy_stage_jvp_plain(tab, sp, pv, c["for_ds"],
                                                  tf)
        h = tab.host()
        for d in range(tab.D):
            got, want = [], []
            out = xs.thread_stage(
                xs.Dual, h, 0, sp[0, 0].numpy(), pv[0, 0].numpy(),
                c["for_ds"][0, 0].numpy(),
                xs.stage_dir(h, d, None if tf is None
                              else tf[0, d, 0].numpy()),
                (xs.DIR_NONE, 0, None),
                lambda w, v: (got.append(v.e), want.append(v.v)))
            _close(np.array(got), drows[0, d, 0].numpy(), 1e-12)
            _close(np.array(want), rows[0, 0].numpy(), 1e-12)
            _close(np.array([u.v for u in out]), ds[0, 0].numpy(), 1e-14)
        if not tab.recal:
            continue
        pt = xs.probe_tables(tab, 1)
        pv0, jpv = xs.xccy_legs_jvp_plain(pt, c["dom_ds"], c["td_legs"])
        hp = pt.host()
        for d in range(pt.Qd):
            got = {}
            xs.thread_legs(xs.Dual, hp, 0, c["dom_ds"][1, 0].numpy(),
                           (xs.DIR_ROW, 0, c["td_legs"][1, d, 0].numpy()),
                           (xs.DIR_NONE, 0, None),
                           lambda s, v: got.__setitem__(s, v))
            _close(np.array([got[s].e for s in range(pt.S)]),
                   jpv[1, d, 0].numpy(), 1e-12)
            _close(np.array([got[s].v for s in range(pt.S)]),
                   pv0[1, 0].numpy(), 1e-13)


def test_legs_hessian_threads_on_live_legs(book):
    """K11's threads, emulated, on legs that price away from 0 (a capped
    and floored rate, an ia = 0 slot, a fixed first coupon) along seeded
    domestic tangents: equal to the plain K11 (torch.clamp's derivative,
    the double-where) at 1e-12; the probe legs' PVs are far from
    rounding. (Along the parent's own jacobian columns the legs' Hessian
    is itself a cancellation: its terms meet at 1e-14 of their size.)"""
    recal, _, topo, dbook, q, _ = book
    _, fw = _parts(book)
    for si, tab in dbook.params["xstage"].items():
        pt = xs.probe_tables(tab, 2)
        if not recal:           # held as values: no domestic directions
            pt = dataclasses.replace(pt, Qd=4)
        c = fw["carry"][si]
        pv0 = xs.legs_forward(pt, c["dom_ds"][0])
        assert float(pv0.abs().min()) > 1e-6 * float(
            pt.leg_f[..., 4].abs().max())
        rng = np.random.default_rng(7)
        gpv = torch.tensor(rng.standard_normal((q.shape[0], pt.G, pt.S)))
        tdl = torch.tensor(1e-3 * rng.standard_normal(
            (q.shape[0], pt.Qd, pt.G, pt.Ld)))
        gdd, Hl = emulate_legs_hess(pt.host(), c["dom_ds"].numpy(),
                                       tdl.numpy(), gpv.numpy())
        rgdd, rHl = xs.xccy_legs_hess_plain(pt, c["dom_ds"], tdl, gpv)
        assert np.array_equal(Hl, Hl.transpose(0, 3, 2, 1))
        _close(Hl, rHl.numpy(), 1e-12)
        _close(gdd, rgdd.numpy(), 1e-12)


@pytest.mark.parametrize("dom", list(InterpTypes), ids=lambda t: t.name)
def test_kernel_route_over_the_eight_schemes(dom):
    """A stage takes the kernels when its members' schemes are simple,
    its parents on any scheme (a fitted parent through its query grid); a
    fitted member keeps torch.func."""
    for other in InterpTypes:
        for its in ([other], [InterpTypes.FLAT_FWD_RATES, other]):
            for dom_it, for_it in ((dom, other), (other, dom)):
                st = _Stage(kind="xccy", ids=list(range(len(its))),
                            key="x", dom_interp=dom_it,
                            foreign_interp=for_it)
                want = all(it in SIMPLE for it in its)
                assert xs.kernel_route(st, its) == want
    assert not xs.kernel_route(_Stage(kind="ois", ids=[0], key="o"),
                               [InterpTypes.FLAT_FWD_RATES])


def test_packed_tables(book):
    """The tables' invariants: contiguous f64 / int32 on the device;
    every real node slot fed by one chain point and back; pillars in
    maturity order, each its own swap's; weights 0 / 1 on known payments
    only, each before its pillar; the rows' member schemes; the sign and
    the FX; a plan off the single pass raises."""
    recal, _, topo, dbook, _, _ = book
    assert tsr.stage_routes(topo) == {1: "kernels"}
    (si, tab), = dbook.params["xstage"].items()
    st = topo.stages[si]
    b = topo.bat[st.key]
    for f in dataclasses.fields(tab):
        v = getattr(tab, f.name)
        if isinstance(v, torch.Tensor):
            assert v.is_contiguous() and v.device.type == "cpu"
            assert v.dtype in (torch.float64, torch.int32), f.name
    h = tab.host()
    assert (tab.G, tab.S, tab.recal) == (1, 3, recal)
    assert tab.D == (2 * tab.S + tsr._build_meta(topo)["xmeta"][si]["Qf"]
                     if recal else tab.S)
    assert tab.npv == (tab.S if recal else 0)
    for g in range(tab.G):
        swap, seg, fl, node = h["pt_i"][g].T
        w = h["pt_f"][g, :, 4]
        mats = np.flatnonzero(fl & xs.IS_MAT)
        assert np.array_equal(mats, h["mat_pos"][g])
        assert np.array_equal(swap[mats], np.arange(tab.S))
        assert set(np.unique(w)) <= {0.0, 1.0}
        assert not (w[mats] != 0).any()
        live = np.flatnonzero(w)
        assert (live < h["mat_pos"][g][swap[live]]).all()
        src = h["u_src"][g]
        assert src[0] == -1
        real = np.flatnonzero(src >= 0)
        assert np.array_equal(real, np.flatnonzero(~b["pad_mask"][g])[1:])
        assert np.array_equal(node[src[real]], real)
        assert (node >= 0).sum() == real.shape[0]
    assert h["r_sch"].tolist() == [xs.SCHEME_CODE[topo.specs[c].interp_type]
                                   for c in st.ids]
    np.testing.assert_array_equal(
        h["fxs"], np.asarray(b["spot_fx"]) * b["plan"].foreign_sign)
    bad = dict(b, plan=dataclasses.replace(
        b["plan"], mat_pos=b["plan"].mat_pos[:, ::-1].copy()))
    with pytest.raises(LibError):
        xs.stage_tables(st, [topo.specs[c].interp_type for c in st.ids],
                        bad, b["row_plan_keep"], tab.D, tab.Qd, "cpu")


def test_a_plan_off_the_single_pass_keeps_torch_func(book, monkeypatch):
    """A stage whose plan the single forward pass cannot take is routed
    to torch.func with the reason, its book builds without its tables,
    and the split on the torch.func route equals the JAX package's."""
    recal, ref, topo, _, q, tb = book
    st = topo.stages[1]
    b = topo.bat[st.key]
    its = [topo.specs[c].interp_type for c in st.ids]
    bad = dict(b, plan=dataclasses.replace(
        b["plan"], mat_pos=b["plan"].mat_pos[:, ::-1].copy()))
    assert xs.stage_route(st, its, bad) == \
        "torch.func: XCCY plan: pillars not in maturity order"

    def refuse(p, pad_mask):
        raise LibError("XCCY plan: a payment after its pillar")
    monkeypatch.setattr(xs, "_chain", refuse)
    assert tsr.stage_routes(topo) == {
        1: "torch.func: XCCY plan: a payment after its pillar"}
    dbook = tmb.make_multibook_fn(tb, "cpu").book
    assert dbook.params["xstage"] == {}
    parts = tsr.make_structured_parts(topo)
    before = _launch_counts()
    fw = parts["fwd_delta"](q, dbook.params, dbook.aggregate,
                            dbook.clamp_agg)
    h2x, v_of = parts["term2_xccy"](q, dbook.params, fw["g"], fw["carry"])
    assert _launch_counts() == before
    _close(fw["dfs"], ref["dfs"], 1e-14)
    _close(fw["J"], ref["J"], 1e-11)
    _close(h2x, ref["h2x"], 1e-10)
    _v_of_close(v_of, ref["v_of"], 1e-10)


def _ops(T, f):
    T.ops = [0] * len(T.ops)
    f()
    return list(T.ops)


def test_op_counts_per_part():
    """The dual numbers count each part's f64 operations at the kernels'
    formulas: a hyper-dual product [1, 3, 3, 7]; a double operand at the
    kernels' double overloads (x c one a live part, x + c the primal's
    one); a term whose factor is zero not computed; a negation none."""
    H, D = xs.HyperDual, xs.Dual
    x, y = H(2.0, 1.0, 3.0, 4.0), H(5.0, 6.0, 7.0, 8.0)
    z = H(2.0, 1.0, 0.0, 0.0)                   # along e1 alone
    assert _ops(H, lambda: x * y) == [1, 3, 3, 7]
    assert _ops(H, lambda: z * y) == [1, 3, 1, 3]
    assert _ops(H, lambda: x * 2.0) == [1, 1, 1, 1]
    assert _ops(H, lambda: z * 2.0) == [1, 1, 0, 0]
    assert _ops(H, lambda: x + 2.0) == [1, 0, 0, 0]
    assert _ops(H, lambda: x - y) == [1, 1, 1, 1]
    assert _ops(H, lambda: -x) == [0, 0, 0, 0]
    assert _ops(H, lambda: x / y) == [1, 3, 3, 7]
    assert _ops(H, lambda: x.exp()) == [1, 1, 1, 3]
    assert _ops(H, lambda: x.log()) == [1, 1, 1, 5]
    assert _ops(D, lambda: D(2.0, 1.0) * D(3.0, 1.0)) == [1, 3]
    assert _ops(D, lambda: D(2.0) / D(3.0, 1.0)) == [1, 2]
    assert _ops(D, lambda: D(2.0) + D(3.0, 1.0)) == [1, 0]
    v = x * y
    assert (v.v, v.a, v.b, v.ab) == (10.0, 17.0, 29.0, 61.0)


def test_needed_flops(book):
    """needed_flops counts the primal once a (scenario, member): K8's
    threads count it once a direction, so they exceed the need by (D - 1)
    primals a (scenario, member); K10's need lies between K8's and its
    threads'."""
    _, _, topo, dbook, q, _ = book
    (si, tab), = dbook.params["xstage"].items()
    c = tsr.make_structured_parts(topo)["fwd_delta"](
        q, dbook.params, dbook.aggregate, dbook.clamp_agg)["carry"][si]
    sp = q[:, dbook.params["bat"][topo.stages[si].key]["qidx"]]
    pv = c["pv0"] if tab.recal else tab.pv_dom0.expand(
        q.shape[0], tab.G, tab.S).contiguous()
    tf = c.get("tf2")
    gs = torch.tensor(np.random.default_rng(3).standard_normal(
        (q.shape[0], tab.G, tab.W)))
    h, none = tab.host(), (xs.DIR_NONE, 0, None)
    prim = sum(_ops(xs.Dual, lambda g=g: xs.thread_stage(
        xs.Dual, h, g, sp[0, g].numpy(), pv[0, g].numpy(),
        c["for_ds"][0, g].numpy(), none, none, lambda w, v: None))[0]
        for g in range(tab.G))
    jvp = xs.needed_flops("xccy_stage_jvp", tab, sp, pv, c["for_ds"], tf)
    assert jvp["threads"] - jvp["needed"] == \
        q.shape[0] * (tab.D - 1) * prim
    hess = xs.needed_flops("xccy_stage_hess", tab, sp, pv, c["for_ds"], tf,
                           gs)
    assert jvp["needed"] < hess["needed"] < hess["threads"]


# ---------------------------------------------------------------------------
# K8 / K10 split at the node DFs: the chain to the nodes, then the rows
# ---------------------------------------------------------------------------


def _split_inputs(h, sc, g, sp, pv, fd, tf):
    """One (scenario, member)'s inputs, its directions and its grid
    transformed once, as a K8 / K10 block takes them."""
    args = (sp[sc, g], pv[sc, g], fd[sc, g])
    dirs = [xs.stage_dir(h, d, None if tf is None else tf[sc, d, g])
            for d in range(h["D"])]
    return args, dirs, xs.grid_transforms(h, g, fd[sc, g])


def _first_tangents(h, g, args, dirs, tg):
    """The prologue's dual chains: (J [U1, D], the primal node DFs)."""
    none = (xs.DIR_NONE, 0, None)
    ch = [xs.thread_chain(xs.Dual, h, g, *args, d, none, tg) for d in dirs]
    J = np.array([[c[u].e for c in ch] for u in range(h["U1"])])
    return J.reshape(h["U1"], len(dirs)), [u.v for u in ch[0]]


def emulate_stage_hess_split(h: dict, sp, pv, fd, tf, gs):
    """K10 as it splits the stage, in Python: per (scenario, member) and
    tile pair, a dual chain a direction (J and the primal nodes), a and
    the band of M over the rows, then a hyper-dual chain a pair to the
    nodes and H_ij = sum a . dds.ab + J_i' M J_j, written at [i, j] and
    [j, i], gZ_i = a . J_i, and a dual chain a foreign grid entry for gf;
    (gZ, gf or None, H) as numpy, from numpy inputs shaped as the
    kernel's."""
    Sc, G, D, Lf = sp.shape[0], h["G"], h["D"], h["Lf"]
    gZ = np.full((Sc, G, D), np.nan)
    gf = np.full((Sc, G, Lf), np.nan)
    H = np.full((Sc, D, G, D), np.nan)
    none = (xs.DIR_NONE, 0, None)
    for sc in range(Sc):
        for g in range(G):
            args, dirs, tg = _split_inputs(h, sc, g, sp, pv, fd, tf)
            for I, Jt in xs.tiles(D, True):
                blk = I + ([] if Jt is I else Jt)
                Jb, dsv = _first_tangents(h, g, args, [dirs[d] for d in blk],
                                          tg)
                a, md, mo = xs.rows_prologue(h, g, dsv, gs[sc, g])
                for i in I:
                    for j in Jt:
                        if j < i:
                            continue
                        dd = xs.thread_chain(xs.HyperDual, h, g, *args,
                                             dirs[i], dirs[j], tg)
                        H[sc, i, g, j] = H[sc, j, g, i] = xs.pair_hessian(
                            h, g, a, md, mo, [u.ab for u in dd],
                            Jb[:, blk.index(i)], Jb[:, blk.index(j)])
                        if i == j:
                            gZ[sc, g, i] = sum(a[u] * Jb[u, blk.index(i)]
                                               for u in range(h["U1"]))
            if h["recal"]:
                _, dsv = _first_tangents(h, g, args, [none], tg)
                a, _, _ = xs.rows_prologue(h, g, dsv, gs[sc, g],
                                           band=False)
                for ll in range(Lf):
                    dd = xs.thread_chain(xs.Dual, h, g, *args,
                                         (xs.DIR_UNIT, ll, None), none, tg)
                    gf[sc, g, ll] = sum(a[u] * dd[u].e
                                        for u in range(h["U1"]))
    return gZ, (gf if h["recal"] else None), H


def emulate_stage_jvp_split(h: dict, sp, pv, fd, tf):
    """K8 as it splits the stage, in Python: per (scenario, member) and
    tile, a dual chain a direction to the nodes, then the rows over (row,
    direction) from the nodes' tangents; (ds, rows, drows) as numpy."""
    Sc, G, D, W = sp.shape[0], h["G"], h["D"], h["W"]
    ds = np.full((Sc, G, h["U1"]), np.nan)
    rows = np.full((Sc, G, W), np.nan)
    drows = np.full((Sc, D, G, W), np.nan)
    for sc in range(Sc):
        for g in range(G):
            args, dirs, tg = _split_inputs(h, sc, g, sp, pv, fd, tf)
            for I, _ in xs.tiles(D, False):
                Jb, dsv = _first_tangents(h, g, args, [dirs[d] for d in I],
                                          tg)
                r, dr = xs.rows_jvp(h, g, dsv, Jb.tolist())
                if I[0] == 0:
                    ds[sc, g], rows[sc, g] = dsv, r
                drows[sc, I, g] = np.array(dr)
    return ds, rows, drows


def _emulated_split(book):
    """term2_xccy with K10 replaced by its split emulation (K11 by its
    per-thread one)."""
    _, _, topo, dbook, q, _ = book
    parts, fw = _parts(book)

    def hess(tab, sp, pv, fd, tf, gs):
        h = dict(tab.host(), D=tab.D)
        out = emulate_stage_hess_split(
            h, sp.numpy(), pv.numpy(), fd.numpy(),
            None if tf is None else tf.numpy(), gs.numpy())
        return tuple(None if o is None else torch.tensor(o) for o in out)

    def legs(tab, dd, tdl, gpv):
        return tuple(torch.tensor(o) for o in emulate_legs_hess(
            tab.host(), dd.numpy(), tdl.numpy(), gpv.numpy()))

    mp = pytest.MonkeyPatch()
    mp.setattr(kernels, "xccy_stage_hess", hess)
    mp.setattr(kernels, "xccy_legs_hess", legs)
    try:
        return parts["term2_xccy"](q, dbook.params, fw["g"], fw["carry"])
    finally:
        mp.undo()


def test_split_hessian_holds_the_jax_hessian(book):
    """K10's split (a hyper-dual chain a pair to the nodes, a, M's band
    and J from the prologue, the contraction), emulated in numpy:
    term2_xccy's H2 and cotangents at 1e-12 x max|ref|."""
    recal, ref, *_ = book
    h2x, v_of = _emulated_split(book)
    _close(h2x, ref["h2x"], 1e-12)
    assert bool(v_of) == recal
    _v_of_close(v_of, ref["v_of"], 1e-12)


def _stage_inputs(book, si, tab):
    _, _, topo, dbook, q, _ = book
    _, fw = _parts(book)
    c = fw["carry"][si]
    sp = q[:, dbook.params["bat"][topo.stages[si].key]["qidx"]]
    pv = c["pv0"] if tab.recal else tab.pv_dom0.expand(
        q.shape[0], tab.G, tab.S).contiguous()
    return sp, pv, c["for_ds"], c.get("tf2")


def test_split_jvp_holds_the_plain_jvp(book):
    """K8's split (a dual chain a direction to the nodes, then the rows
    over (row, direction)), emulated in numpy, equals the plain K8 at
    1e-12 x max|ref|; every entry is written; the split K10's H, gZ and
    gf equal the plain K10's and H its mirror bit for bit."""
    _, _, _, dbook, q, _ = book
    for si, tab in dbook.params["xstage"].items():
        sp, pv, fd, tf = _stage_inputs(book, si, tab)
        h = dict(tab.host(), D=tab.D)
        tfn = None if tf is None else tf.numpy()
        got = emulate_stage_jvp_split(h, sp.numpy(), pv.numpy(), fd.numpy(),
                                      tfn)
        ref = xs.xccy_stage_jvp_plain(tab, sp, pv, fd, tf)
        for a, b in zip(got, ref):
            assert not np.isnan(a).any()
            _close(a, b.numpy(), 1e-12)
        gs = torch.tensor(np.random.default_rng(9).standard_normal(
            (q.shape[0], tab.G, tab.W)))
        gZ, gf, H = emulate_stage_hess_split(h, sp.numpy(), pv.numpy(),
                                             fd.numpy(), tfn, gs.numpy())
        rgZ, rgf, rH = xs.xccy_stage_hess_plain(tab, sp, pv, fd, tf, gs)
        assert not np.isnan(H).any() and not np.isnan(gZ).any()
        assert np.array_equal(H, H.transpose(0, 3, 2, 1))
        _close(H, rH.numpy(), 1e-12)
        _close(gZ, rgZ.numpy(), 1e-12)
        assert (gf is None) == (not tab.recal)
        if tab.recal:
            _close(gf, rgf.numpy(), 1e-12)


@pytest.mark.parametrize("D", [1, 2, 15, 16, 17, 33, 48, 64])
def test_tiles_cover_each_pair_once(D):
    """K8's tiles hold each direction once; K10's tile pairs, at any tile
    size, hold each pair i <= j once, as the pair table does; its blocks
    take each pair and each foreign grid entry once, at most ``ITEMS`` a
    block."""
    k8 = [d for I, _ in xs.tiles(D, False) for d in I]
    assert k8 == list(range(D))
    assert all(len(I) <= xs.TILE for I, _ in xs.tiles(D, False))
    want = [tuple(p) for p in xs.pair_table(D).tolist()]
    for Dt in (1, 5, 16, D):
        pairs = [(i, j) for I, J in xs.tiles(D, True, Dt) for i in I
                 for j in J if j >= i]
        assert sorted(pairs) == want
        blocks = xs.hess_blocks(D, 7, Dt)
        items = [x for _, _, it in blocks for x in it if x is not None]
        assert sorted(x for x in items if x[0] != "grid") == want
        assert [x[1] for x in items if x[0] == "grid"] == list(range(7))
        assert all(0 < len(it) <= xs.ITEMS for _, _, it in blocks)


@pytest.mark.parametrize("scheme", [
    "FLAT_FWD_RATES", "LINEAR_ZERO_RATES", "LINEAR_FWD_RATES"])
def test_rows_prologue_band(scheme):
    """a and M = d2s/dds2 of s = sum gs . rows(ds) from the node and band
    tables (the rows' plans of a three-member stage on each simple
    scheme) equal torch.func's gradient and Hessian of the plain rows at
    1e-12 x max|ref|; M is nonzero only on the diagonal and at the node
    pairs some row brackets (the band tables' entries), and LINEAR_FWD
    adds nothing to M."""
    from torch.func import grad, hessian
    mb = cases.xccy3_book("adrates_torch", "FLAT_FWD_RATES", scheme, 5,
                          recalibrate_xccy=False)
    (si, tab), = tmb.make_multibook_fn(mb, "cpu").book.params[
        "xstage"].items()
    h = tab.host()
    rng = np.random.default_rng(11)
    sp = torch.tensor(1e-4 * rng.standard_normal((tab.G, tab.S)))
    ds, _ = xs.stage_forward(tab, sp, tab.pv_dom0, tab.f_xs.new_ones(
        (tab.G, tab.Lf)) * 0.97)
    gs = torch.tensor(rng.standard_normal((tab.G, tab.W)))
    for g in range(tab.G):
        code = int(h["r_sch"][g])

        def s(d, g=g, code=code):
            return torch.sum(gs[g] * xs._interp(
                tab.rq_i[g], tab.rq_f[g], tab.r_xs[g], d, code))
        a, md, mo = xs.rows_prologue(h, g, ds[g].numpy(), gs[g].numpy())
        M = xs.band_matrix(h, g, md, mo)
        _close(np.array(a), grad(s)(ds[g]).numpy(), 1e-12)
        rM = hessian(s)(ds[g]).numpy()
        if code == xs.LIN_FWD:
            assert not M.any() and not rM.any()
            continue
        _close(M, rM, 1e-12)
        band = np.eye(tab.U1, dtype=bool)
        for i0, i1, kn in h["rq_i"][g]:
            if kn < 0:
                band[i0, i1] = band[i1, i0] = True
        assert not M[~band].any()
        for e, (p, q) in enumerate(h["mb_pq"][g]):
            assert p < q or (p == q == 0 and mo[e] == 0.0)


def test_kernel_flops(book):
    """needed_flops counts K8's and K10's own design on the test book
    beside the bound and the simple design: the kernels do more than the
    function needs (each block's dual chains, a pair's primal and first
    tangents again), and K8, recalibrated (D = 2S + Qf), less than a dual
    thread a direction over the whole stage (held as values, D = 3, a
    block's grid transforms and rows cost about what they save); K9 /
    K11, the legs' flows once a (scenario, member) and a dot a direction
    or pair, count less than a thread a direction or pair did."""
    _, _, topo, dbook, q, _ = book
    (si, tab), = dbook.params["xstage"].items()
    sp, pv, fd, tf = _stage_inputs(book, si, tab)
    gs = torch.tensor(np.random.default_rng(3).standard_normal(
        (q.shape[0], tab.G, tab.W)))
    jvp = xs.needed_flops("xccy_stage_jvp", tab, sp, pv, fd, tf)
    hess = xs.needed_flops("xccy_stage_hess", tab, sp, pv, fd, tf, gs)
    for c in (jvp, hess):
        assert c["needed"] < c["kernel"]
        assert c["kernel"] % q.shape[0] == 0
    if tab.recal:
        assert jvp["kernel"] < jvp["threads"]
    _, fw = _parts(book)
    c = fw["carry"][si]
    if tab.recal:
        legs = xs.needed_flops("xccy_legs_jvp", tab, c["dom_ds"],
                               c["td_legs"])
        hl = xs.needed_flops("xccy_legs_hess", tab, c["dom_ds"],
                             c["td_legs"], torch.ones(q.shape[0], tab.G,
                                                      tab.S))
        for x in (legs, hl):
            assert 0 < x["kernel"] < x["threads"]
            assert x["kernel"] % q.shape[0] == 0


def test_needed_bytes(book):
    """needed_bytes counts each grid only at the entries its plan reads
    (per scenario: K8 / K10 the foreign DFs and their tangents at the
    taps of fq, K9 / K11 the domestic DFs and tangents at the taps of the
    legs' index and discount queries, both taken from the plans here),
    the other inputs and the outputs in full, and the tables the kernel
    reads once; each below the sum of every table and every input and
    output in full."""
    _, _, topo, dbook, q, _ = book
    (si, tab), = dbook.params["xstage"].items()
    h = tab.host()
    G, S, D, Qd, W = tab.G, tab.S, tab.D, tab.Qd, tab.W
    sp, pv, fd, tf = _stage_inputs(book, si, tab)
    gs = torch.ones(q.shape[0], G, W)
    _, fw = _parts(book)
    c = fw["carry"][si]
    ftaps = sum(len({x for qi in h["fq_i"][g] for x in xs._taps(qi)})
                for g in range(G))
    dtaps = sum(len({x for qi in np.concatenate([h["li_i"][g], h["ld_i"][g]],
                                                axis=1).reshape(-1, 3)
                     for x in xs._taps(qi)}) for g in range(G))
    assert dtaps == int((h["lr_row"] >= 0).sum())
    nf = 1 + (D if tab.recal else 0)
    per = dict(
        xccy_stage_jvp=((sp, pv, fd, tf), nf * ftaps
                        + G * (2 * S + tab.U1 + W + D * W)),
        xccy_stage_hess=((sp, pv, fd, tf, gs), nf * ftaps
                         + G * (2 * S + W + D + D * D
                                + (tab.Lf if tab.recal else 0))))
    if tab.recal:
        gpv = torch.ones(q.shape[0], G, S)
        per.update(
            xccy_legs_jvp=((c["dom_ds"], c["td_legs"]), (1 + Qd) * dtaps
                           + G * (S + Qd * S)),
            xccy_legs_hess=((c["dom_ds"], c["td_legs"], gpv),
                            (1 + Qd) * dtaps + G * (S + tab.Ld + Qd * Qd)))
    whole = sum(getattr(tab, f.name).numel()
                * getattr(tab, f.name).element_size()
                for f in dataclasses.fields(tab)
                if isinstance(getattr(tab, f.name), torch.Tensor))
    for name, (args, scen) in per.items():
        one = [a if a is None else a[:1] for a in args]
        n1 = xs.needed_bytes(name, tab, *one)
        n2 = xs.needed_bytes(name, tab, *[a if a is None else a[:2]
                                          for a in args])
        assert n2 - n1 == 8 * scen, name
        outs = [r for r in getattr(kernels, name)(tab, *one)
                if r is not None]
        assert n1 < whole + sum(8 * a.numel() for a in list(one) + outs
                                if a is not None), name
    if tab.recal:
        assert xs.needed_bytes("xccy_legs_jvp", tab, *per[
            "xccy_legs_jvp"][0]) < xs.needed_bytes(
            "xccy_legs_hess", tab, *per["xccy_legs_hess"][0])


def test_exchanges_need_their_discount_queries(book):
    """stage_tables refuses legs with notional exchanges whose discount
    plan lacks the effective and maturity times' queries (the kernels and
    the plain version read them at P + 1 and P + 2)."""
    _, _, topo, dbook, _, _ = book
    (si, tab), = dbook.params["xstage"].items()
    assert tab.flags & xs.NOTIONAL_EXCHANGE and tab.Pd == tab.P + 3
    st = topo.stages[si]
    b = topo.bat[st.key]
    disc = {k: (np.asarray(v)[..., :tab.P + 1]
                if k in ("i0", "i1", "at_knot", "knot_idx", "c", "q")
                else v) for k, v in b["legs_plan"]["disc"].items()}
    bad = dict(b, legs_plan=dict(b["legs_plan"], disc=disc))
    with pytest.raises(LibError, match="notional exchanges"):
        xs.stage_tables(st, [topo.specs[c].interp_type for c in st.ids],
                        bad, b["row_plan_keep"], tab.D, tab.Qd, "cpu")


# ---------------------------------------------------------------------------
# K9 / K11 split at the legs' flows: the primal, gradients and M once a
# (scenario, member), then a dot a direction or pair
# ---------------------------------------------------------------------------


def emulate_legs_split(h: dict, dd, tdl, gpv=None):
    """K9 (gpv None) or K11 as they split the legs, in Python: per
    (scenario, member) ``xccy_stage.legs_prologue``, then Jpv[d, s] =
    G_s . t_d (``legs_dir``) or, K11, U_j = M t_j (``legs_u``) and each
    pair i <= j's t_i . U_j (``legs_pair``), written at [i, j] and
    [j, i]; (pv0, Jpv) or (gdd, Hl) as numpy, from numpy inputs shaped as
    the kernels'."""
    Sc, G, Qd, Ld, S = dd.shape[0], h["G"], tdl.shape[1], h["Ld"], h["S"]
    pv0 = np.full((Sc, G, S), np.nan)
    jpv = np.full((Sc, Qd, G, S), np.nan)
    gdd = np.full((Sc, G, Ld), np.nan)
    Hl = np.full((Sc, Qd, G, Qd), np.nan)
    for sc in range(Sc):
        for g in range(G):
            pro = xs.legs_prologue(h, g, dd[sc, g],
                                   None if gpv is None else gpv[sc, g])
            dirs = [xs.legs_dir(h, g, pro, tdl[sc, d, g]) for d in range(Qd)]
            if gpv is None:
                pv0[sc, g] = pro["pv"]
                for d in range(Qd):
                    jpv[sc, d, g] = dirs[d][0]
                continue
            gdd[sc, g] = pro["gdd"]
            for j in range(Qd):
                U = xs.legs_u(h, g, pro, tdl[sc, j, g], *dirs[j])
                for i in range(j + 1):
                    Hl[sc, i, g, j] = Hl[sc, j, g, i] = xs.legs_pair(
                        h, g, tdl[sc, i, g], U)
    return (pv0, jpv) if gpv is None else (gdd, Hl)


def _legs_split_check(tab, dd, tdl, gpv, tol=1e-12):
    """The split's K9 and K11 against the plain versions at tol x
    max|ref|, every entry written, Hl its own mirror bit for bit."""
    h = tab.host()
    got = emulate_legs_split(h, dd.numpy(), tdl.numpy())
    for a, b in zip(got, xs.xccy_legs_jvp_plain(tab, dd, tdl)):
        assert not np.isnan(a).any()
        _close(a, b.numpy(), tol)
    gdd, Hl = emulate_legs_split(h, dd.numpy(), tdl.numpy(), gpv.numpy())
    assert not np.isnan(Hl).any()
    assert np.array_equal(Hl, Hl.transpose(0, 3, 2, 1))
    rg, rH = xs.xccy_legs_hess_plain(tab, dd, tdl, gpv)
    _close(gdd, rg.numpy(), tol)
    _close(Hl, rH.numpy(), tol)


def _probe_legs_inputs(tab, dom_ds, seed, Qd=None):
    """Probe legs of ``tab`` (Qd domestic directions where given) and
    seeded tangents [Sc, Qd, G, Ld] and cotangents [Sc, G, S]."""
    pt = xs.probe_tables(tab, seed)
    if Qd is not None:
        pt = dataclasses.replace(pt, Qd=Qd)
    rng = np.random.default_rng(seed)
    Sc = dom_ds.shape[0]
    tdl = torch.tensor(1e-3 * rng.standard_normal((Sc, pt.Qd, pt.G, pt.Ld)))
    gpv = torch.tensor(rng.standard_normal((Sc, pt.G, pt.S)))
    return pt, tdl, gpv


def _jax_legs(jb, si, pt, dom_ds, tdl, gpv):
    """The JAX package's K9 / K11 functions on the probe legs of ``pt``:
    ``jax.linearize`` of ``xccy_legs_pv`` and its Jpv along tdl, and
    ``s_legs``' gdd and Hl (adrates_tpu/parallel/structured_risk.py
    :367-379, :546-563), a scenario at a time; (pv0, Jpv, gdd, Hl) as
    numpy."""
    import jax.numpy as jnp
    from adrates_tpu.parallel.curve_batching import xccy_legs_pv
    st = jsr._build_meta(jb.basket)["stages"][si]
    b = jb.basket.params["bat"][st.key]
    h = pt.host()
    lf, ls = h["leg_f"], h["leg_s"]
    legs = dataclasses.replace(
        b["legs"], spreads=lf[..., 3], index_alphas=lf[..., 2],
        principal=ls[..., 0], first_fixing_rate=ls[..., 3],
        cap_rate=ls[..., 7], floor_rate=ls[..., 8],
        override_first=bool(pt.flags & xs.OVERRIDE_FIRST),
        has_cap_floor=bool(pt.flags & xs.CAP_FLOOR))
    b2 = dict(b, legs=legs)
    G, Qd = pt.G, pt.Qd

    def legs_fn(dd):
        return xccy_legs_pv(dd, b2, st)

    def one(dd, td, gp):
        pv0, jvp_legs = jax.linearize(legs_fn, dd)
        Jpv = jax.vmap(jvp_legs)(td)

        def s_legs(Zd, d):
            return jnp.vdot(gp, legs_fn(d + jnp.einsum("gd,dgl->gl", Zd,
                                                       td)))
        (_, gdd), jvp2 = jax.linearize(jax.grad(s_legs, argnums=(0, 1)),
                                       jnp.zeros((G, Qd)), dd)
        seeds = jnp.broadcast_to(jnp.eye(Qd)[:, None, :], (Qd, G, Qd))
        Hl = jax.vmap(lambda s: jvp2(s, jnp.zeros_like(dd))[0])(seeds)
        return pv0, Jpv, gdd, Hl
    return tuple(np.asarray(x) for x in jax.jit(jax.vmap(one))(
        dom_ds.numpy(), tdl.numpy(), gpv.numpy()))


def _legs_vs_jax(jb, si, tab, dom_ds, seed, Qd=None):
    pt, tdl, gpv = _probe_legs_inputs(tab, dom_ds, seed, Qd)
    rpv, rJ, rg, rH = _jax_legs(jb, si, pt, dom_ds, tdl, gpv)
    h = pt.host()
    pv0, jpv = emulate_legs_split(h, dom_ds.numpy(), tdl.numpy())
    gdd, Hl = emulate_legs_split(h, dom_ds.numpy(), tdl.numpy(),
                                 gpv.numpy())
    for got, ref in ((pv0, rpv), (jpv, rJ), (gdd, rg), (Hl, rH)):
        _close(got, ref, 1e-12)
    return pt, tdl, gpv


def test_legs_split_holds_the_jax_legs(book):
    """K9 / K11's split (the legs' flows once a (scenario, member),
    G_s, gdd and M collapsed onto the domestic grid, a dot a direction or
    pair), in numpy, on probe legs (a cap and floor, an ia = 0 slot, a
    fixed first coupon, a principal) along seeded tangents: pv0, Jpv,
    gdd and Hl equal the JAX package's linearize / s_legs at 1e-12 x
    max|ref|, and the plain versions'."""
    recal, _, _, dbook, _, _ = book
    jb = cases.compile_xccy_book("adrates_tpu",
                                 cases.build_xccy_model("adrates_tpu"),
                                 recalibrate_xccy=recal)
    _, fw = _parts(book)
    for si, tab in dbook.params["xstage"].items():
        dd = fw["carry"][si]["dom_ds"]
        pt, tdl, gpv = _legs_vs_jax(jb, si, tab, dd, 4,
                                    None if recal else 4)
        _legs_split_check(pt, dd, tdl, gpv)


@pytest.mark.parametrize("scheme", [
    "FLAT_FWD_RATES", "LINEAR_ZERO_RATES", "LINEAR_FWD_RATES"])
def test_legs_split_on_the_three_schemes(scheme):
    """The split on a three-member stage whose domestic curve (USD OIS)
    is on each simple scheme: against the JAX package at 1e-12 x
    max|ref| on probe legs along seeded tangents, and pv0, Jpv and gdd
    along the parent's own jacobian columns (td_legs; along these the
    legs' Hessian is itself a cancellation, its terms meeting at about
    1e-14 of their size)."""
    jb = cases.xccy3_book("adrates_tpu", scheme, "FLAT_FWD_RATES", 5,
                          recalibrate_xccy=True)
    mb = cases.xccy3_book("adrates_torch", scheme, "FLAT_FWD_RATES", 5,
                          recalibrate_xccy=True)
    topo = tmb.book_inputs(mb).topology
    dbook = tmb.make_multibook_fn(mb, "cpu").book
    q = torch.tensor(mb.basket.quotes0[None, :] + np.random.default_rng(
        6).normal(0.0, 1e-3, (2, mb.basket.n_quotes)))
    c = tsr.make_structured_parts(topo)["fwd_delta"](
        q, dbook.params, dbook.aggregate, dbook.clamp_agg)["carry"]
    (si, tab), = dbook.params["xstage"].items()
    assert tab.dsch == xs.SCHEME_CODE[getattr(InterpTypes, scheme)]
    pt, _, gpv = _legs_vs_jax(jb, si, tab, c[si]["dom_ds"], 8)
    rpv, rJ, rg, rH = _jax_legs(jb, si, pt, c[si]["dom_ds"],
                                c[si]["td_legs"], gpv)
    h = pt.host()
    dd, td = c[si]["dom_ds"].numpy(), c[si]["td_legs"].numpy()
    for got, ref in zip(emulate_legs_split(h, dd, td) + emulate_legs_split(
            h, dd, td, gpv.numpy())[:1], (rpv, rJ, rg)):
        _close(got, ref, 1e-12)


def _rate_at(h, g, s, p, dd):
    """The all-in rate of coupon p of leg s, in the kernels' arithmetic."""
    tg = [xs.transform(h["dsch"], float(x), float(y))
          for x, y in zip(dd, h["d_xs"][g])]
    li, lf = h["li_i"][g, s], h["li_f"][g, s]
    A = xs.leg_query(h, li[p], lf[p], tg, dd)[0]
    B = xs.leg_query(h, li[h["P"] + p], lf[h["P"] + p], tg, dd)[0]
    return (A / B - 1.0) / float(h["leg_f"][g, s, p, 2]) \
        + float(h["leg_f"][g, s, p, 3])


def test_legs_split_at_the_cap_and_floor():
    """A rate exactly at the cap and another exactly at the floor (a
    LINEAR_FWD domestic curve, whose DFs the plain version and the split
    compute in the same IEEE operations): torch.clamp's derivative passes
    at both, the split's strict comparisons agree, at 1e-12 x max|ref|;
    the rates do sit on the bounds in the plain version's arithmetic.
    (The JAX package's jnp.clip halves the derivative at a tie, so these
    are held to the plain versions.)"""
    mb = cases.xccy3_book("adrates_torch", "LINEAR_FWD_RATES",
                          "LINEAR_ZERO_RATES", 5, recalibrate_xccy=True)
    topo = tmb.book_inputs(mb).topology
    dbook = tmb.make_multibook_fn(mb, "cpu").book
    (si, tab), = dbook.params["xstage"].items()
    q = torch.tensor(mb.basket.quotes0[None, :])
    dd = tsr.make_structured_parts(topo)["fwd_delta"](
        q, dbook.params, dbook.aggregate, dbook.clamp_agg)["carry"][si][
            "dom_ds"]
    pt, tdl, gpv = _probe_legs_inputs(tab, dd, 5)
    h = pt.host()
    leg_s = pt.leg_s.clone()
    hit = []
    for g in range(pt.G):
        live = [(s, p) for s in range(pt.S) for p in range(1, pt.P)
                if h["leg_f"][g, s, p, 2] > 0
                and h["leg_f"][g, s, p, 0] > h["leg_s"][g, s, 2]]
        (s0, p0), (s1, p1) = live[0], live[-1]
        assert s0 != s1
        leg_s[g, s0, 7] = _rate_at(h, g, s0, p0, dd[0, g].numpy())
        leg_s[g, s1, 8] = _rate_at(h, g, s1, p1, dd[0, g].numpy())
        leg_s[g, s1, 7] = leg_s[g, s1, 8] + 0.01
        hit.append((g, s0, p0, s1, p1))
    pt = dataclasses.replace(pt, leg_s=leg_s)
    # the plain version's own rates sit on the bounds
    P = pt.P
    idx = xs._interp(pt.li_i, pt.li_f, pt.d_xs.unsqueeze(-2).expand(
        pt.G, pt.S, pt.Ld), dd[0].unsqueeze(-2).expand(pt.G, pt.S, pt.Ld),
        pt.dsch)
    ia = pt.leg_f[..., 2]
    rate = (idx[..., :P] / idx[..., P:] - 1.0) / torch.where(
        ia > 0, ia, 1.0) + pt.leg_f[..., 3]
    for g, s0, p0, s1, p1 in hit:
        assert float(rate[g, s0, p0]) == float(pt.leg_s[g, s0, 7])
        assert float(rate[g, s1, p1]) == float(pt.leg_s[g, s1, 8])
    _legs_split_check(pt, dd, tdl, gpv)


def test_legs_split_support_covers_the_hessian(book):
    """M = sum_s gpv_s d2PV_s/dd2 assembled from the split's pieces (M_N
    on its entries ``me_rc``, the value DFs' coupling -w_s (G_s dV_s' +
    dV_s G_s' + PV_s d2V_s)) equals torch.func's dense Hessian of the
    plain legs at 1e-12 x max|ref| on probe legs, and every nonzero of
    that Hessian lies on the support: M_N's entries, or a value DF tap's
    row or column within its leg's rows; gdd equals its gradient."""
    from torch.func import grad, hessian
    _, _, _, dbook, _, _ = book
    _, fw = _parts(book)
    for si, tab in dbook.params["xstage"].items():
        pt, _, gpv = _probe_legs_inputs(tab, fw["carry"][si]["dom_ds"], 9, 2)
        h = pt.host()
        dd = fw["carry"][si]["dom_ds"][0]
        for g in range(pt.G):
            def s_of(d, g=g):
                full = dd.clone()
                full[g] = d
                return torch.sum(gpv[0, g] * xs.legs_forward(pt, full)[g])
            rM = hessian(s_of)(dd[g]).numpy()
            pro = xs.legs_prologue(h, g, dd[g].numpy(), gpv[0, g].numpy())
            _close(np.array(pro["gdd"]), grad(s_of)(dd[g]).numpy(), 1e-12)
            rows = h["lr_row"][g]
            M = np.zeros_like(rM)
            on = np.zeros(rM.shape, dtype=bool)
            for e, (p, c) in enumerate(h["me_rc"][g]):
                if rows[p] < 0 or rows[c] < 0:
                    continue
                M[rows[p], rows[c]] += pro["M"][e]
                if p != c:
                    M[rows[c], rows[p]] += pro["M"][e]
                on[rows[p], rows[c]] = on[rows[c], rows[p]] = True
            for s in range(pt.S):
                lo, hi = h["ls_ptr"][g, s], h["ls_ptr"][g, s + 1]
                Gs = np.zeros(pt.Ld)
                lrows = rows[h["ls_row"][g, lo:hi]]
                Gs[lrows] = pro["G"][lo:hi]
                V = pro["V"][s]
                taps = xs._taps(h["ld_i"][g, s, pt.P])
                dV = np.zeros(pt.Ld)
                d2V = np.zeros((pt.Ld, pt.Ld))
                for a, x in enumerate(taps):
                    dV[x] += V[1][a]
                    on[x, lrows] = on[lrows, x] = True
                if V[2] is not None:
                    for a, b, k in ((0, 0, 0), (0, 1, 1), (1, 0, 1),
                                    (1, 1, 2)):
                        d2V[taps[a], taps[b]] += V[2][k]
                M -= pro["w"][s] * (np.outer(Gs, dV) + np.outer(dV, Gs)
                                    + pro["pv"][s] * d2V)
            assert not rM[~on].any()
            _close(M, rM, 1e-12)


def _emulated_legs_split(book):
    """fwd_delta and term2_xccy with K9 and K11 replaced by their split
    emulation in numpy."""
    _, _, topo, dbook, q, _ = book
    parts = tsr.make_structured_parts(topo)

    def jvp_(tab, dd, tdl):
        return tuple(torch.tensor(o) for o in emulate_legs_split(
            tab.host(), dd.numpy(), tdl.numpy()))

    def hess_(tab, dd, tdl, gpv):
        return tuple(torch.tensor(o) for o in emulate_legs_split(
            tab.host(), dd.numpy(), tdl.numpy(), gpv.numpy()))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(kernels, "xccy_legs_jvp", jvp_)
        mp.setattr(kernels, "xccy_legs_hess", hess_)
        fw = parts["fwd_delta"](q, dbook.params, dbook.aggregate,
                                dbook.clamp_agg)
        return fw, parts["term2_xccy"](q, dbook.params, fw["g"],
                                       fw["carry"])


def test_legs_split_holds_the_jax_book(book):
    """The book's own calibration legs (which telescope: their PVs and
    derivatives cancel to rounding) through the split K9 and K11 in
    fwd_delta and term2_xccy: dfs, J, H2 and the parent cotangents equal
    the JAX package's at the tolerances of the route's tests, each a
    multiple of the largest reference entry (the scale of the terms that
    cancel)."""
    recal, ref, *_ = book
    fw, (h2x, v_of) = _emulated_legs_split(book)
    _close(fw["dfs"], ref["dfs"], 1e-14)
    _close(fw["J"], ref["J"], 1e-11)
    _close(h2x, ref["h2x"], 1e-12)
    assert bool(v_of) == recal
    _v_of_close(v_of, ref["v_of"], 1e-12)


def _flagship_legs_plans():
    """(li_i, ld_i, P, Ld) of flagship_v5's XCCY stage."""
    import warnings
    from adrates_torch.examples import flagship_v5 as cfg
    model = cfg.build_model()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        trades, coll = cfg.build_base_trades(
            model, np.random.default_rng(cfg.SEED))
        mb = cfg.compile_base(model, trades, coll)
    (_, tab), = tmb.make_multibook_fn(mb, "cpu").book.params[
        "xstage"].items()
    return tab.li_i.numpy(), tab.ld_i.numpy(), tab.P, tab.Ld


def _random_legs_plans(G=3, S=16, P=63, Ld=12, seed=3):
    """Random packed plans at the route's maxima (S = 16 legs of 63
    coupons): bracketing entries, a fifth of the queries at a knot."""
    rng = np.random.default_rng(seed)

    def plan(shape):
        i0 = rng.integers(0, Ld - 1, shape)
        kn = np.where(rng.random(shape) < 0.2, rng.integers(0, Ld, shape),
                      -1)
        return np.stack([i0, i0 + 1, kn], axis=-1).astype(np.int32)
    return plan((G, S, 2 * P)), plan((G, S, P + 3)), P, Ld


@pytest.mark.parametrize("plans", [_flagship_legs_plans, _random_legs_plans],
                         ids=["flagship_v5", "route_maxima"])
def test_legs_lists_invariants(plans):
    """K9 / K11's lists on flagship_v5's XCCY stage (G = 3, S = 8, P =
    30) and on random plans at the route's maxima (S = 16, P = 63): the
    rows are the entries the queries read; every flow's n lies once in
    its leg's sum, every slot once in a gradient target, every slot pair
    once in an M_N entry; segments hold 1 to LEG_SEG terms, the sums' and
    gradients' before M_N's in each chunk, and each target's segments
    come in order."""
    li, ld, P, Ld = plans()
    G, S = li.shape[:2]
    F, B = P + 2, xs.LEG_BLOCK
    ll = xs._legs_lists(li, ld, P, Ld)
    NL, E = ll["ls_row"].shape[1], ll["me_rc"].shape[1]
    for g in range(G):
        rows = ll["lr_row"][g]
        read = sorted({x for q in list(li[g].reshape(-1, 3))
                       + list(ld[g].reshape(-1, 3)) for x in xs._taps(q)})
        assert rows[rows >= 0].tolist() == read
        lt, seg = ll["lt_term"][g], ll["sg"][g]
        tp, ts, sc = ll["ts_ptr"][g], ll["ts_seg"][g], ll["sc_ptr"][g]
        is_m = np.zeros(seg.shape[0], dtype=bool)
        for c in range(len(sc) // 2):
            is_m[sc[2 * c + 1]:sc[2 * c + 2]] = True
        by_k = np.zeros(7 + len(xs.SLOT_PAIRS), dtype=int)
        for t in range(S + NL + E):
            ks = ts[tp[t]:tp[t + 1]]
            assert list(ks) == sorted(ks)
            for k in ks:
                assert 0 < seg[k, 1] - seg[k, 0] <= xs.LEG_SEG
                assert is_m[k] == (t >= S + NL)
                for x in lt[seg[k, 0]:seg[k, 1]]:
                    by_k[(x >> 1) // B] += 1
                    assert (x >> 1) // B == 0 or t >= S
        slots = [[len(xs._taps(q)) for q in (li[g, s, p], li[g, s, P + p],
                                             ld[g, s, p])]
                 for s in range(S) for p in range(P)]
        slots += [[len(xs._taps(ld[g, s, P + 1 + e]))] for s in range(S)
                  for e in range(2)]
        n = [sum(x) for x in slots]
        assert by_k[0] == S * F
        assert by_k[1:7].sum() == sum(n)
        assert by_k[7:].sum() == sum(k * (k + 1) // 2 for k in n)
