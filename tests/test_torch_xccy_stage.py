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
- ``kernel_route`` over the eight schemes, and the packed tables'
  invariants.
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
    threads from ``hpairs``, each written at [i, j] and [j, i], and
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
            for i, j in h["hpairs"]:
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
            for i, j in h["lpairs"]:
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
            pt = dataclasses.replace(pt, Qd=4,
                                     lpairs=torch.tensor(xs.pair_table(4)))
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
    """A stage takes the kernels when its members', domestic and foreign
    schemes are all simple; a fitted scheme anywhere keeps torch.func."""
    for other in InterpTypes:
        for its in ([other], [InterpTypes.FLAT_FWD_RATES, other]):
            for dom_it, for_it in ((dom, other), (other, dom)):
                st = _Stage(kind="xccy", ids=list(range(len(its))),
                            key="x", dom_interp=dom_it,
                            foreign_interp=for_it)
                want = all(it in SIMPLE for it in its + [dom_it, for_it])
                assert xs.kernel_route(st, its) == want
    assert not xs.kernel_route(_Stage(kind="ois", ids=[0], key="o"),
                               [InterpTypes.FLAT_FWD_RATES])


def test_packed_tables(book):
    """The tables' invariants: contiguous f64 / int32 on the device;
    every real node slot fed by one chain point and back; pillars in
    maturity order, each its own swap's; weights 0 / 1 on known payments
    only, each before its pillar; the rows' member schemes; the sign and
    the FX; the pair tables; a plan off the single pass raises."""
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
    assert h["hpairs"].shape == (tab.D * (tab.D + 1) // 2, 2)
    assert h["lpairs"].shape == (tab.Qd * (tab.Qd + 1) // 2, 2)
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
    K11 keep the simple design's count."""
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
        assert legs["kernel"] == legs["threads"]
