"""The per-trade second-order tensors of an XCCY stage split at its node
DFs (K12 ``xccy_stage_node_hess``, K9 / K11 and the rows' derivatives in
the nodes on the full unique-time plan, ``xccy_stage.node_rows`` /
``node_quads``), on the CPU (the wrappers' plain versions), on the OIS +
XCCY book of ``torch_cases`` (GBP_USD_XCCY over the USD and GBP OIS
curves: G = 1, S = 3), recalibrated in-graph and held as values:

- the 256-gamma function's term 2 (the contraction at the selected
  trades' DF gradients) and the restricted contraction of the XCCY
  curve's group against the JAX package's ``make_pertrade_curvehess``,
  the gamma function and the selected trades' blocks against its
  ``make_per_trade_gamma_fn``, at 1e-10 x max|ref|;
- the node split against the ``torch.func`` towers (``rowsTx``, the route
  before it) at 1e-12 x max|ref|;
- ``xccy_stage_node_hess_plain`` against ``torch.func`` over
  ``curve_batching.xccy_boot_ds`` (and ``stage_rows`` on the full plan,
  the rows' second derivatives) at 1e-12 x max|ref|;
- K12's split emulated in hyper-dual numpy against the plain version on
  ``probe_tables`` tables: its two launches (``warp_chain``, a warp a
  chain with its lanes on the chain points, the ranks' sums in the
  kernel's lane and shuffle order; the prologue once a (scenario, member),
  a warp a pair), at 32 lanes and at 5 (the points split unevenly), and
  the thread-a-chain split of K10's blocks with a node sink
  (``thread_chain``), each pair and foreign grid entry once, written and
  mirrored as the kernel writes them; the two launches' cut;
- ``pertrade_route`` on fitted parents: the towers kept, with the reason.
"""

import jax
import numpy as np
import pytest
import torch
from torch.func import jvp, vmap

import adrates_tpu  # noqa: F401 — enables x64 for the JAX side
import torch_cases as cases
from test_torch_xccy_stage import _first_tangents
from adrates_tpu.parallel import multibook as jmb
from adrates_tpu.parallel import structured_risk as jsr
from adrates_torch.ops import kernels
from adrates_torch.ops import xccy_stage as xs
from adrates_torch.parallel import curve_batching as tcb
from adrates_torch.parallel import multibook as tmb
from adrates_torch.parallel import pertrade_blocks as tpb
from adrates_torch.parallel import structured_risk as tsr


@pytest.fixture(scope="module", params=[True, False],
                ids=["recal", "values"])
def book(request):
    """(recal, JAX book, port book, topology, device params, q0, the
    stage index, the selected trades and their DF gradients [B, n_grid])."""
    recal = request.param
    jb = cases.compile_xccy_book("adrates_tpu",
                                 cases.build_xccy_model("adrates_tpu"),
                                 recalibrate_xccy=recal)
    tb = cases.compile_xccy_book("adrates_torch",
                                 cases.build_xccy_model("adrates_torch"),
                                 recalibrate_xccy=recal)
    topo = tb.basket.topology()
    inp = tmb.book_inputs(tb)
    P = tmb._device_book(inp, "cpu", sweep=False, quad=False).params
    (si, _), = P["xstage"].items()
    q0 = torch.tensor(tb.basket.quotes0)
    sel = cases.pertrade_selection(tb)
    gam = tmb.make_per_trade_gamma_fn(tb, sel, "cpu")
    _, dfs, _, _ = gam.prep(q0)
    slots = tmb._tables_to(tmb._harvest_sel_tables(tb, sel), "cpu")
    Gs = tmb._slot_gradient(dfs, slots, len(sel), inp.n_grid)
    return dict(recal=recal, jb=jb, tb=tb, topo=topo, P=P, q0=q0, si=si,
                sel=sel, Gs=Gs, gam=gam)


def _close(got, ref, tol):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * np.abs(ref).max())


def _towers(topo):
    """make_pertrade_tensors with every XCCY stage kept on the
    torch.func towers (the route before the node split)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(tsr, "pertrade_routes",
               lambda t: {si: "torch.func: forced" for si in
                          xs.pertrade_routes(t)})
    try:
        return tsr.make_pertrade_tensors(topo)
    finally:
        mp.undo()


def _restrict(tb):
    """The XCCY curve's group: the curve and, recalibrated, its parents."""
    basket = tb.basket
    x = next(c for c, s in enumerate(basket.specs) if s.kind == "xccy")
    cids = sorted({x, basket.specs[x].dom_id, basket.specs[x].for_id}) \
        if basket.recalibrate_xccy else [x]
    return dict(cids=cids, width=sum(basket.specs[c].n_quotes for c in cids))


def test_the_stage_takes_the_node_split(book):
    """The stage is on the per-trade kernel route; its tensors hold the
    split (no [., ., G, U] tensor) and nothing counts a launch on the
    CPU."""
    assert xs.pertrade_routes(book["topo"]) == {book["si"]: "kernels"}
    before = [getattr(kernels, k).launches for k in (
        "xccy_stage_node_hess", "xccy_legs_jvp", "xccy_legs_hess")]
    so = tsr.make_pertrade_tensors(book["topo"])(book["q0"], book["P"])
    t = so[book["si"]]
    want = {"Jn", "RR", "T"} | ({"Jfd", "Jpv", "Jlegs_nat", "Hl"}
                               if book["recal"] else set())
    assert set(t) == want
    assert [getattr(kernels, k).launches for k in (
        "xccy_stage_node_hess", "xccy_legs_jvp", "xccy_legs_hess")] == before


def test_term2_of_the_selected_gammas_matches_jax(book):
    """The 256-gamma path's term 2, the contraction at the selected
    trades' DF gradients, against the JAX package's."""
    jb, q0, Gs = book["jb"], book["q0"], book["Gs"]
    so = tsr.make_pertrade_tensors(book["topo"])(q0, book["P"])
    got = tsr.make_pertrade_curvehess(book["topo"])(so, Gs)
    contract = jsr.make_pertrade_curvehess(jb.basket)
    ref = jax.jit(lambda q, g: contract(q, jb.basket.params, g))(
        jb.basket.quotes0, Gs.numpy())
    _close(got, ref, 1e-10)


def test_gammas_and_blocks_match_jax(book):
    """The selected trades' dense gammas (K3's term 1 and the node split's
    term 2) and their own blocks (``dense_from_block``; term 2 restricted
    to each trade's group) against the JAX package's
    ``make_per_trade_gamma_fn``."""
    jb, tb, q0 = book["jb"], book["tb"], book["q0"]
    ref = np.asarray(jmb.make_per_trade_gamma_fn(jb, book["sel"])(
        jb.basket.quotes0))
    _close(book["gam"](q0), ref, 1e-10)
    groups = tpb.make_per_trade_gamma_blocks_fn(tb, "cpu")(q0)
    where = {int(t): (g, k) for g in groups
             for k, t in enumerate(g.trade_ids)}
    N = tb.basket.n_quotes
    got = np.stack([tpb.dense_from_block(*where[t], N) if t in where
                    else np.zeros((N, N)) for t in book["sel"]])
    assert sum(t in where for t in book["sel"]) >= 3
    _close(got, ref, 1e-10)


def test_restricted_contraction_matches_jax(book):
    """The contraction restricted to the XCCY curve's group (the blocks'
    term 2), on seeded DF gradients over the group's full unique-time
    rows."""
    jb, tb, q0 = book["jb"], book["tb"], book["q0"]
    restrict = _restrict(tb)
    U = tb.unique_times.shape[0]
    G = np.random.default_rng(cases.SEED).normal(
        0.0, 1e6, (3, len(restrict["cids"]) * U))
    contract = jsr.make_pertrade_curvehess(jb.basket, restrict=restrict)
    ref = jax.jit(lambda q, g: contract(q, jb.basket.params, g))(
        jb.basket.quotes0, G)
    so = tsr.make_pertrade_tensors(book["topo"])(q0, book["P"])
    got = tsr.make_pertrade_curvehess(book["topo"], restrict)(
        so, torch.tensor(G))
    _close(got, ref, 1e-10)


@pytest.mark.parametrize("restricted", [False, True],
                         ids=["all", "restricted"])
def test_node_split_equals_the_towers(book, restricted):
    """The node split's contraction against the torch.func towers'
    (rowsTx, drows2, drows_fd, legsT) at 1e-12 x max|ref|, on the
    selected trades' DF gradients and on seeded ones."""
    topo, q0, P = book["topo"], book["q0"], book["P"]
    so = tsr.make_pertrade_tensors(topo)(q0, P)
    so_t = _towers(topo)(q0, P)
    assert "RR" in so[book["si"]] and "RR" not in so_t[book["si"]]
    if restricted:
        restrict = _restrict(book["tb"])
        U = book["tb"].unique_times.shape[0]
        Gs = torch.tensor(np.random.default_rng(5).normal(
            0.0, 1e6, (4, len(restrict["cids"]) * U)))
    else:
        restrict = None
        Gs = torch.cat([book["Gs"], torch.tensor(
            np.random.default_rng(5).normal(0.0, 1e6,
                                            (2, book["Gs"].shape[1])))])
    c = tsr.make_pertrade_curvehess(topo, restrict)
    _close(c(so, Gs), c(so_t, Gs).numpy(), 1e-12)


def _stage_inputs(book, Sc=1, seed=None):
    """(tables, sp, pv, fd, tf) of the stage at q0 (plus seeded shocks),
    from the structured pass's carry, as the per-trade call feeds K12."""
    topo, P, si = book["topo"], book["P"], book["si"]
    q = book["q0"][None, :].repeat(Sc, 1)
    if seed is not None:
        q = q + torch.tensor(np.random.default_rng(seed).normal(
            0.0, 1e-3, q.shape))
    dbook = tmb.make_multibook_fn(book["tb"], "cpu").book
    fw = tsr.make_structured_parts(topo)["fwd_delta"](
        q, P, dbook.aggregate, dbook.clamp_agg)
    c = fw["carry"][si]
    tab = P["xstage"][si]
    sp = q[:, P["bat"][topo.stages[si].key]["qidx"]]
    pv = c["pv0"] if tab.recal else tab.pv_dom0.expand(
        Sc, tab.G, tab.S).contiguous()
    return tab, sp, pv, c["for_ds"], c.get("tf2")


def test_plain_version_holds_the_bootstrap(book):
    """xccy_stage_node_hess_plain (forward substitution on the packed
    tables) against torch.func over curve_batching.xccy_boot_ds (the
    bootstrap's own solve, one forward level: structured_risk._so_tensor)
    at Z = 0 along the stage's D directions: ds, Jn, Hn, Jfd; and the
    node split's rows, RR T, against the second derivatives of
    stage_rows on the full unique-time plan."""
    topo, si = book["topo"], book["si"]
    tab, sp, pv, fd, tf = _stage_inputs(book)
    ds, Jn, Jfd, Hn = xs.xccy_stage_node_hess_plain(tab, sp, pv, fd, tf)
    st = topo.stages[si]
    b = book["P"]["bat"][st.key]
    G, S, D, npv = tab.G, tab.S, tab.D, tab.npv
    t = tf[0] if tf is not None else fd.new_zeros((D, G, tab.Lf))

    def native(Z):
        f2 = fd[0] + torch.einsum("gd,dgl->gl", Z, t)
        pz = pv[0] + Z[:, S:S + npv] if npv else pv[0]
        return tcb.xccy_boot_ds(sp[0] + Z[:, :S], pz, f2, b, st)

    its = [topo.specs[c].interp_type for c in st.ids]

    def rows(d):
        return tcb.stage_rows(d, its, b["row_plan"])

    seeds = tsr._seeds(D, G, sp)
    rds, rJ, rH, rT = tsr._so_tensor(native, sp.new_zeros((G, D)), seeds,
                                     rows)
    _close(ds[0], rds.numpy(), 1e-12)
    _close(Jn[0], rJ.numpy(), 1e-12)
    _close(Hn[0], rH.numpy(), 1e-12)
    assert (Jfd is None) == (not tab.recal)
    if tab.recal:
        _, rJf = tsr._jac(lambda f: tcb.xccy_boot_ds(sp[0], pv[0], f, b, st),
                          fd[0], tsr._seeds(tab.Lf, G, fd))
        _close(Jfd[0], rJf.numpy(), 1e-12)
    nr = xs.node_row_tables(its, topo.bat[st.key]["row_plan"], tab.U1,
                            "cpu")
    RR, T = xs.node_rows(nr, ds[0]), xs.node_quads(nr, Jn[0], Hn[0])
    got = torch.einsum("gwk,gkx->gwx", RR, T).reshape(
        G, -1, D, D).permute(2, 3, 0, 1)
    _close(got, rT.numpy(), 1e-12)
    # RR's first columns are the rows' jacobian in the nodes
    _, rJr = vmap(lambda s: jvp(rows, (rds,), (s,)))(
        tsr._seeds(tab.U1, G, sp))
    _close(RR[..., :tab.U1].permute(2, 0, 1), rJr.numpy(), 1e-12)


def emulate_node_hess(h: dict, sp, pv, fd, tf, Dt=None):
    """The thread-a-chain split of the node DFs' derivatives over K10's
    blocks (K12's first design), in Python, block by block
    (``xccy_stage.hess_blocks`` at a tile of ``Dt`` directions): each
    block's dual chain a direction of its tile pair (J and the primal
    nodes), the first chunk of tile I's diagonal pair writing Jn for tile
    I, the first block ds; then each item's chain with a node sink: a pair
    i <= j's hyper-dual chain (its row of Hn zeroed first, each node's e1
    e2 part written at [i, j] and [j, i] as the chain sets it), a foreign
    grid entry's dual chain (Jfd); (ds, Jn, Jfd or None, Hn) as numpy,
    unwritten entries NaN."""
    Sc, G, D, Lf, U1 = sp.shape[0], h["G"], h["D"], h["Lf"], h["U1"]
    ds = np.full((Sc, G, U1), np.nan)
    Jn = np.full((Sc, D, G, U1), np.nan)
    Jfd = np.full((Sc, Lf, G, U1), np.nan)
    Hn = np.full((Sc, D, D, G, U1), np.nan)
    none = (xs.DIR_NONE, 0, None)
    for sc in range(Sc):
        for g in range(G):
            args = (sp[sc, g], pv[sc, g], fd[sc, g])
            dirs = [xs.stage_dir(h, d, None if tf is None else tf[sc, d, g])
                    for d in range(D)]
            tg = xs.grid_transforms(h, g, fd[sc, g])
            seen = set()
            for k, (I, J, items) in enumerate(xs.hess_blocks(
                    D, Lf if h["recal"] else 0, Dt)):
                blk = I + ([] if J is I else J)
                Jb, dsv = _first_tangents(h, g, args, [dirs[d] for d in blk],
                                          tg)
                if J is I and I[0] not in seen:
                    seen.add(I[0])
                    Jn[sc, I, g] = Jb[:, :len(I)].T
                if k == 0:
                    ds[sc, g] = dsv
                for it in (x for x in items if x is not None):
                    if it[0] == "grid":
                        ll = it[1]
                        Jfd[sc, ll, g] = 0.0

                        def gsink(u, v, ll=ll):
                            Jfd[sc, ll, g, u] = v.e
                        xs.thread_chain(xs.Dual, h, g, *args,
                                        (xs.DIR_UNIT, ll, None), none, tg,
                                        gsink)
                        continue
                    i, j = it
                    Hn[sc, i, j, g] = Hn[sc, j, i, g] = 0.0

                    def psink(u, v, i=i, j=j):
                        Hn[sc, i, j, g, u] = Hn[sc, j, i, g, u] = v.ab
                    xs.thread_chain(xs.HyperDual, h, g, *args, dirs[i],
                                    dirs[j], tg, psink)
    return ds, Jn, (Jfd if h["recal"] else None), Hn


def emulate_node_warps(h: dict, sp, pv, fd, tf, lanes: int):
    """K12 as its two launches split the stage, in Python
    (``xccy_stage.node_hess_blocks``), a chain of ``lanes`` lanes
    (``xccy_stage.warp_chain``): each (scenario, member)'s primal chain
    along no direction (ds, the primal C and acc, once: every prologue
    block of a member computes the same), each prologue block's items, a
    dual chain a direction (Jn, and its first tangents of C and acc) or a
    foreign grid entry (Jfd); then each pair warp's hyper-dual chain over
    those tables, its nodes written at [i, j] and [j, i]; (ds, Jn, Jfd or
    None, Hn) as numpy, unwritten entries NaN."""
    Sc, G, D, Lf, U1 = sp.shape[0], h["G"], h["D"], h["Lf"], h["U1"]
    ds = np.full((Sc, G, U1), np.nan)
    Jn = np.full((Sc, D, G, U1), np.nan)
    Jfd = np.full((Sc, Lf, G, U1), np.nan)
    Hn = np.full((Sc, D, D, G, U1), np.nan)
    none = (xs.DIR_NONE, 0, None)
    mem = {}
    pro, pairs = xs.node_hess_blocks(Sc, G, D, Lf if h["recal"] else 0)
    for sg, items in pro:
        sc, g = divmod(sg, G)
        if sg not in mem:
            args = (sp[sc, g], pv[sc, g], fd[sc, g])
            tg = xs.grid_transforms(h, g, fd[sc, g])
            cumv, cs = xs.chain_cums(h, g, sp[sc, g])
            tabs = dict(cumv=cumv, cs=cs)
            ds[sc, g], cv, av = xs.warp_chain(xs.Dual, h, g, *args, none,
                                              none, tg, tabs, lanes)
            mem[sg] = dict(args=args, tg=tg, tabs=dict(tabs, cv=cv, av=av),
                           ce={}, ae={}, dirs=[xs.stage_dir(
                               h, d, None if tf is None else tf[sc, d, g])
                               for d in range(D)])
        M = mem[sg]
        for kind, x in items:
            d = M["dirs"][x] if kind == "dir" else (xs.DIR_UNIT, x, None)
            nodes, ce, ae = xs.warp_chain(xs.Dual, h, g, *M["args"], d,
                                          none, M["tg"], M["tabs"], lanes)
            if kind == "dir":
                Jn[sc, x, g] = nodes
                M["ce"][x], M["ae"][x] = ce, ae
            else:
                Jfd[sc, x, g] = nodes
    for blk in pairs:
        for sg, i, j in blk:
            sc, g = divmod(sg, G)
            M = mem[sg]
            tabs = dict(M["tabs"], c1=M["ce"][i], c2=M["ce"][j],
                        a1=M["ae"][i], a2=M["ae"][j])
            Hn[sc, i, j, g] = Hn[sc, j, i, g] = xs.warp_chain(
                xs.HyperDual, h, g, *M["args"], M["dirs"][i], M["dirs"][j],
                M["tg"], tabs, lanes)[0]
    return ds, Jn, (Jfd if h["recal"] else None), Hn


@pytest.mark.parametrize("split", ["one_tile", "tile_pairs", "lanes_32",
                                   "lanes_5"])
def test_node_split_emulation_holds_the_plain_version(book, split):
    """K12's split, emulated in hyper-dual numpy on ``probe_tables`` tables
    at two seeded scenarios, against the plain version at 1e-12 x
    max|ref| of every output: every entry written, Hn equal to its mirror
    bit for bit; the two launches with 32 lanes a chain and with 5 (the
    chain points split unevenly, the shuffle tree over 8 with 3 lanes of
    0), and the thread-a-chain split of K10's blocks, with one tile of all
    D directions and with tile pairs of 5."""
    tab, sp, pv, fd, tf = _stage_inputs(book, Sc=2, seed=17)
    tab = xs.probe_tables(tab, 3)
    h = dict(tab.host(), D=tab.D)
    ins = (sp.numpy(), pv.numpy(), fd.numpy(),
           None if tf is None else tf.numpy())
    if split.startswith("lanes"):
        got = emulate_node_warps(h, *ins, int(split[len("lanes_"):]))
    else:
        got = emulate_node_hess(h, *ins, None if split == "one_tile" else 5)
    ref = xs.xccy_stage_node_hess_plain(tab, sp, pv, fd, tf)
    assert (got[2] is None) == (ref[2] is None) == (not tab.recal)
    for a, b in zip(got, ref):
        if b is None:
            continue
        assert not np.isnan(a).any()
        _close(a, b.numpy(), 1e-12)
    Hn = got[3]
    assert np.array_equal(Hn, Hn.transpose(0, 2, 1, 3, 4))


@pytest.mark.parametrize("shape", [(1, 3, 48, 73), (1, 3, 8, 0),
                                   (2, 1, 37, 12), (3, 2, 5, 12)],
                         ids=["flagship", "values", "maxima", "odd"])
def test_node_launches_cover_every_item_once(shape):
    """K12's cut (``xccy_stage.node_hess_blocks``): the prologue's blocks
    take each (scenario, member)'s directions and foreign grid entries once,
    ``NODE_WARPS`` a block, in launch order; the pair launch's blocks each
    pair i <= j of each (scenario, member) once, a tile pair a block, on
    the tile that gives each of the H100's 132 SMs a block where one does:
    at flagship_v5's per-trade call (Sc = 1, G = 3, D = 48, Lf = 73) 93
    prologue blocks and 234 pair blocks of tiles of 4 directions."""
    Sc, G, D, n_gf = shape
    pro, pairs = xs.node_hess_blocks(Sc, G, D, n_gf)
    W = xs.NODE_WARPS
    per = -(-(D + n_gf) // W)
    assert len(pro) == Sc * G * per
    assert [sg for sg, _ in pro] == [b // per for b in range(len(pro))]
    assert all(0 < len(it) <= W for _, it in pro)
    want = [("dir", d) for d in range(D)] + [("grid", ll)
                                             for ll in range(n_gf)]
    for sg in range(Sc * G):
        assert [x for s, it in pro if s == sg for x in it] == want
    Dt = xs.node_pair_tile(Sc, G, D)
    nT = -(-D // Dt)
    assert len(pairs) == Sc * G * nT * (nT + 1) // 2
    assert Dt == 1 or len(pairs) >= xs.H100_SMS
    assert all(0 < len(b) <= Dt * Dt for b in pairs)
    flat = [x for b in pairs for x in b]
    assert sorted(flat) == [(sg, int(i), int(j)) for sg in range(Sc * G)
                            for i, j in xs.pair_table(D)]
    assert all(len({i for _, i, _ in b} | {j for _, _, j in b}) <= 2 * Dt
               for b in pairs)
    assert all(len({sg for sg, _, _ in b}) == 1 for b in pairs)
    if shape == (1, 3, 48, 73):
        assert (len(pro), len(pairs), Dt) == (93, 234, 4)


def test_wrapper_on_cpu_tensors_runs_the_plain_version(book):
    """kernels.xccy_stage_node_hess on CPU tensors is the plain version
    (no launch counted) and checks its shapes."""
    tab, sp, pv, fd, tf = _stage_inputs(book)
    before = kernels.xccy_stage_node_hess.launches
    got = kernels.xccy_stage_node_hess(tab, sp, pv, fd, tf)
    ref = xs.xccy_stage_node_hess_plain(tab, sp, pv, fd, tf)
    assert kernels.xccy_stage_node_hess.launches == before
    for a, b in zip(got, ref):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)
    assert got[3].shape == (1, tab.D, tab.D, tab.G, tab.U1)
    with pytest.raises(ValueError, match="fd has shape"):
        kernels.xccy_stage_node_hess(tab, sp, pv, fd[..., 1:], tf)
    bad = torch.zeros_like(sp) if tf is None else None
    with pytest.raises(ValueError, match="tf"):
        kernels.xccy_stage_node_hess(tab, sp, pv, fd, bad)


def test_needed_flops_and_bytes(book):
    """K12's counts: the kernel's own operations above what the function
    needs (each prologue block's primal chain, a pair's primal and first
    tangents again) and below K10's on the same inputs (no rows, no
    contraction, the first tangents once a (scenario, member)); its bytes
    grow by its outputs and inputs a scenario."""
    tab, sp, pv, fd, tf = _stage_inputs(book, Sc=2, seed=4)
    c = xs.needed_flops("xccy_stage_node_hess", tab, sp, pv, fd, tf)
    gs = torch.ones(2, tab.G, tab.W)
    k10 = xs.needed_flops("xccy_stage_hess", tab, sp, pv, fd, tf, gs)
    assert 0 < c["needed"] < c["kernel"] < k10["kernel"]
    assert c["needed"] < k10["needed"]
    assert c["kernel"] % 2 == 0
    h = tab.host()
    G, S, D, U1 = tab.G, tab.S, tab.D, tab.U1
    taps = sum(len({x for q in h["fq_i"][g] for x in xs._taps(q)})
               for g in range(G))
    nf = 1 + (D if tab.recal else 0)
    per = nf * taps + G * (2 * S + U1 * (1 + D + D * D
                                         + (tab.Lf if tab.recal else 0)))

    def one(n):
        return [a if a is None else a[:n] for a in (sp, pv, fd, tf)]
    n1 = xs.needed_bytes("xccy_stage_node_hess", tab, *one(1))
    n2 = xs.needed_bytes("xccy_stage_node_hess", tab, *one(2))
    assert n2 - n1 == 8 * per


@pytest.mark.parametrize("recal", [True, False], ids=["recal", "values"])
def test_fitted_parents_keep_the_towers(recal):
    """A stage over fitted parents (``torch_cases.XCCY_FITTED_PARENTS``)
    takes K8-K11 in the scenario pass, but its per-trade tensors keep the
    torch.func towers: the route says why, and its tensors hold rowsTx /
    rowsT, not the node split."""
    _, mb = cases.fitted_parent_book("adrates_torch", recal)
    topo = mb.basket.topology()
    (si, route), = xs.pertrade_routes(topo).items()
    assert xs.stage_routes(topo) == {si: "kernels"}
    assert route == ("torch.func: a parent on a fitted scheme "
                     "(NATCUBIC_LOG_DISCOUNT, PCHIP_ZERO_RATES)")
    P = tmb._device_book(tmb.book_inputs(mb), "cpu", sweep=False,
                         quad=False).params
    so = tsr.make_pertrade_tensors(topo)(torch.tensor(mb.basket.quotes0), P)
    assert "RR" not in so[si]
    assert ("rowsTx" if recal else "rowsT") in so[si]
