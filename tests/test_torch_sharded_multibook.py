"""The port's sharded multibook on the CPU, across gloo processes
(``torch_dist_cases``): ``make_sharded_multibook_fn`` at world 3 (the OIS
book's 40 trades do not divide it: the dead-trade padding runs) on a 1-D
``("book",)`` mesh and at world 4 on a 2-D ``("dcn", "book")`` mesh,
each on the lazy and the materialized (``shard_multibook``) x5 OIS tile
and the lazy x3 credit tile (clamp slots); against the JAX package's
sharded function on its virtual CPU mesh of the same shape (world 3: the
lazy tiles; the 2-D mesh: the materialized tile through
``shard_multibook``, as the JAX package's own tests pass them), against
the port's single-device ``make_multibook_fn`` and against each other
(on the 2-D mesh also with the "book" axis alone);
each rank's shard of a lazy book holds only its own trades' rows, and
each call sweeps them once through K1; ``shard_multibook`` refuses a
lazy book;
``tile_multibook(materialize=True)`` and ``trade_pvs`` against the JAX
package's.

Tolerances: against JAX, the JAX package's own for its sharded function
(``tests/test_multibook_sharded.py:40-47``: total PV rtol 1e-12 atol
1e-7, delta rtol 1e-10 atol 1e-7, gamma rtol 1e-10 atol 1e-6); against
the port's single-device function 1e-12 x max|ref| (f64 sums in another
order); the materialized tables exactly; ``trade_pvs`` 1e-12 x max|ref|.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import adrates_tpu  # noqa: F401 — enables x64 for the JAX side
import torch_cases as tc
import torch_dist_cases as dc
from adrates_tpu.parallel import multibook as jmb
from adrates_torch.ops import kernels
from adrates_torch.parallel import multibook as tmb
from adrates_torch.utils import LibError

BOOKS = ["lazy", "materialized", "credit"]


@pytest.fixture(scope="module")
def ranks3():
    return dc.run_ranks(3, dc.multibook_ranks, timeout_s=600)


@pytest.fixture(scope="module")
def ranks4_2d():
    return dc.run_ranks(4, dc.multibook_ranks, (2,), timeout_s=600)


@pytest.fixture(scope="module")
def port_books():
    """The port's books, and each one's materialized tile (``mat_*``)."""
    _, lazy, mat = dc.ois_books()
    credit, credit_mat = dc.credit_books()
    return dict(lazy=lazy, materialized=mat, credit=credit,
                mat_lazy=mat, mat_materialized=mat, mat_credit=credit_mat)


@pytest.fixture(scope="module")
def jax_books():
    """The JAX package's books, as ``port_books``."""
    _, lazy, mat = dc.ois_books("adrates_tpu")
    credit, credit_mat = dc.credit_books("adrates_tpu")
    return dict(lazy=lazy, materialized=mat, credit=credit,
                mat_credit=credit_mat)


def _jax_sharded(mb, mesh, axis, materialized):
    if materialized:
        mb = jmb.shard_multibook(mb, mesh, axis=axis)
    fn = jmb.make_sharded_multibook_fn(mb, mesh, axis=axis)
    out = fn(mb.basket.quotes0, tc.shocks(mb.basket.n_quotes, dc.N_SCEN))
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def jax3(jax_books):
    """The JAX sharded function on a 3-device mesh: the lazy tiles, as
    its dryrun passes them."""
    mesh = Mesh(np.array(jax.devices()[:3]), ("book",))
    return {k: _jax_sharded(jax_books[k], mesh, "book", False)
            for k in ("lazy", "credit")}


@pytest.fixture(scope="module")
def jax4_2d(jax_books):
    """The JAX sharded function on a (dcn 2, book 2) mesh: the
    materialized tile through ``shard_multibook``, as its 2-D test."""
    axis = ("dcn", "book")
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), axis)
    return _jax_sharded(jax_books["materialized"], mesh, axis, True)


def _check_jax(got, ref):
    np.testing.assert_allclose(got["total_pv"], ref["total_pv"],
                               rtol=1e-12, atol=1e-7)
    np.testing.assert_allclose(got["delta"], ref["delta"], rtol=1e-10,
                               atol=1e-7)
    np.testing.assert_allclose(got["gamma"], ref["gamma"], rtol=1e-10,
                               atol=1e-6)


def _close(got, ref, rel=1e-12):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = ref.numpy() if torch.is_tensor(ref) else np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rel * np.abs(ref).max())


@pytest.mark.parametrize("book", ["lazy", "credit"])
def test_world3_matches_jax(ranks3, jax3, book):
    _check_jax(ranks3[0][book], jax3[book])


def test_world4_2d_mesh_matches_jax(ranks4_2d, jax4_2d):
    assert ranks4_2d[0]["dims"] == ["dcn", "book"]
    assert [r["coord"] for r in ranks4_2d] == [[0, 0], [0, 1], [1, 0],
                                               [1, 1]]
    _check_jax(ranks4_2d[0]["materialized"], jax4_2d)


def test_world4_2d_mesh_book_axis_alone(ranks4_2d):
    """On the 2-D mesh with ``axis="book"`` the trades shard over the
    two ranks of each "dcn" row (20 of the 40 trades each, both rows
    alike) and the totals reduce over the row: the whole book's, equal
    to the every-axis run (1e-12 x max)."""
    for r, res in enumerate(ranks4_2d):
        s = res["lazy_book_axis"]
        assert (s["n_pad"], s["n_local"]) == (40, 20)
        assert s["lo"] == (r % 2) * 20
        for k in ("total_pv", "delta", "gamma"):
            _close(s[k], ranks4_2d[0]["lazy"][k])


@pytest.mark.parametrize("world", [3, 4])
@pytest.mark.parametrize("book", ["materialized", "credit"])
def test_books_match_the_lazy_tile(ranks3, ranks4_2d, world, book):
    """The materialized tile through ``shard_multibook`` equals the lazy
    tile sharded in the function (1e-12 x max), on both meshes; the
    credit book's 2-D mesh run equals its 1-D one."""
    ranks = ranks3 if world == 3 else ranks4_2d
    ref = ranks[0]["lazy"] if book == "materialized" else ranks3[0][book]
    for k in ("total_pv", "delta", "gamma"):
        _close(ranks[0][book][k], ref[k])


@pytest.mark.parametrize("book", BOOKS)
def test_world3_matches_single_device(ranks3, port_books, book):
    mb = port_books[book]
    ref = tmb.make_multibook_fn(mb, "cpu")(
        mb.basket.quotes0, tc.shocks(mb.basket.n_quotes, dc.N_SCEN))
    got = ranks3[0][book]
    _close(got["total_pv"], ref["pvs"].sum(dim=1))
    _close(got["delta"], ref["delta"])
    _close(got["gamma"], ref["gamma"])


@pytest.mark.parametrize("world", [3, 4])
def test_every_rank_holds_the_result(ranks3, ranks4_2d, world):
    ranks = ranks3 if world == 3 else ranks4_2d
    for book in BOOKS:
        for r in ranks[1:]:
            for k in ("total_pv", "delta", "gamma"):
                np.testing.assert_array_equal(r[book][k], ranks[0][book][k])


@pytest.mark.parametrize("world", [3, 4])
@pytest.mark.parametrize("book", BOOKS)
def test_shards_are_contiguous_padded_trade_ranges(ranks3, ranks4_2d,
                                                   port_books, world, book):
    ranks = ranks3 if world == 3 else ranks4_2d
    B = port_books[book].n_trades
    n_pad = B + (-B) % world
    for r, res in enumerate(ranks):
        s = res[book]
        assert s["n_pad"] == n_pad and s["n_local"] == n_pad // world
        assert s["lo"] == r * s["n_local"]
        assert s["hi"] == min(s["lo"] + s["n_local"], B)
        # one K1 sweep a call, over this rank's trades
        assert s["k1_calls"] == [s["n_local"]]
    if world == 3 and book != "credit":
        assert n_pad > B        # 40 trades on 3 ranks: padded


@pytest.mark.parametrize("world", [3, 4])
@pytest.mark.parametrize("book", BOOKS)
def test_shard_holds_only_its_own_rows(ranks3, ranks4_2d, port_books, world,
                                       book):
    """A rank's expanded rows and clamp slots are its own trades' only
    (counted on the materialized tile), never the full book's."""
    ranks = ranks3 if world == 3 else ranks4_2d
    mb = port_books["mat_" + book]
    rt = np.concatenate([np.asarray(cb.row_trade) for cb in mb.cols])
    st = np.zeros(0) if mb.clamp is None else np.asarray(mb.clamp.slot_trade)
    for res in ranks:
        s = res[book]
        assert s["rows"] == int(((rt >= s["lo"]) & (rt < s["hi"])).sum())
        assert s["rows"] < rt.shape[0]
        assert s["clamp_slots"] == int(((st >= s["lo"])
                                        & (st < s["hi"])).sum())
    assert sum(r[book]["rows"] for r in ranks) == rt.shape[0]


def test_shard_multibook_refuses_a_lazy_book(port_books, jax_books):
    with pytest.raises(LibError):
        tmb.shard_multibook(port_books["lazy"], None)
    with pytest.raises(Exception):
        jmb.shard_multibook(jax_books["lazy"], None)


MATERIALIZED = {"ois": "materialized", "credit": "mat_credit"}


@pytest.mark.parametrize("book", ["ois", "credit"])
def test_tile_multibook_materialize_matches_jax(jax_books, port_books,
                                                book):
    jb, tb = (b[MATERIALIZED[book]] for b in (jax_books, port_books))
    assert jb.tile is None and tb.tile is None
    assert tb.n_trades == jb.n_trades
    for name in ("buckets", "cols"):
        for a, b in zip(getattr(jb, name), getattr(tb, name), strict=True):
            for f in dataclasses.fields(b):
                np.testing.assert_array_equal(getattr(b, f.name),
                                              np.asarray(getattr(a, f.name)))
    pairs = [(jb.aggregate, tb.aggregate)]
    assert (tb.clamp is None) == (jb.clamp is None)
    if tb.clamp is not None:
        pairs.append((jb.clamp, tb.clamp))
    for a, b in pairs:
        for f in dataclasses.fields(b):
            np.testing.assert_array_equal(getattr(b, f.name),
                                          np.asarray(getattr(a, f.name)))


def test_materialized_equals_lazy(port_books):
    lazy, mat = port_books["lazy"], port_books["materialized"]
    sh = tc.shocks(lazy.basket.n_quotes, dc.N_SCEN)
    a = tmb.make_multibook_fn(lazy, "cpu")(lazy.basket.quotes0, sh)
    b = tmb.make_multibook_fn(mat, "cpu")(mat.basket.quotes0, sh)
    for k in ("pvs", "delta", "gamma"):
        _close(b[k], a[k])


@pytest.mark.parametrize("book", ["ois", "credit"])
def test_trade_pvs_matches_jax(jax_books, port_books, book, monkeypatch):
    """``trade_pvs`` on the materialized rows against the JAX package's,
    from the same DF vector, through ``kernels.pvs_sweep`` (the CPU
    twin, one call); a [S, n_grid] stack of grids gives each row."""
    jb, tb = (b[MATERIALIZED[book]] for b in (jax_books, port_books))
    dfs = np.asarray(jax.jit(jb.basket.grids)(jb.basket.quotes0,
                                              jb.basket.params))
    ref = np.asarray(jax.jit(lambda d: jmb.trade_pvs(
        d, jb.buckets, jb.clamp, jb.n_trades))(dfs))
    calls = []
    sweep = kernels.pvs_sweep
    monkeypatch.setattr(kernels, "pvs_sweep",
                        lambda *a: calls.append(1) or sweep(*a))
    dfs = torch.tensor(dfs)
    got = tmb.trade_pvs(dfs, tb.buckets, tb.clamp, tb.n_trades)
    assert calls == [1]
    _close(got, ref)
    two = tmb.trade_pvs(torch.stack([dfs, dfs]), tb.buckets, tb.clamp,
                        tb.n_trades)
    assert two.shape == (2, tb.n_trades)
    _close(two[1], ref)
