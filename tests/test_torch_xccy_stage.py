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
