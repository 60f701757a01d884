"""The port's sharded per-trade risk on the CPU, across three gloo
processes (``torch_dist_cases.pertrade_ranks``): the ladders
(``make_sharded_per_trade_delta_fn``) on the lazy and the materialized x5
OIS tile (40 trades: padded to 42) and the lazy x3 credit tile (clamp
rows), 11 selected trades' gammas (``make_sharded_per_trade_gamma_fn``,
the selection padded to 12) and every trade's own block
(``make_sharded_per_trade_gamma_blocks_fn``), each gathered and held
against the JAX package's sharded function on a 3-device virtual CPU
mesh and against the port's single-device function; each rank's part
against the gathered whole (ranges, dead rows exactly zero); a lazy
shard holds only its own trades' rows.

Tolerances: against JAX, the JAX package's own for its sharded functions
(``tests/test_multibook_sharded.py:155-245``: ladders rtol 1e-12 atol
1e-13 x (max|ref| + 1); gammas and blocks rtol 1e-9 atol 1e-12 x
(max|ref| + 1)); against the port's single-device functions 1e-12 x
max|ref| (f64 sums in another order).
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import adrates_tpu  # noqa: F401 — enables x64 for the JAX side
import torch_dist_cases as dc
from adrates_tpu.parallel import pertrade_sharded as jps
from adrates_torch.parallel import (make_per_trade_gamma_blocks_fn,
                                    make_per_trade_gamma_fn)
from adrates_torch.parallel import multibook as tmb

WORLD = 3
LADDER_BOOKS = ["lazy", "materialized", "credit"]


@pytest.fixture(scope="module")
def ranks():
    return dc.run_ranks(WORLD, dc.pertrade_ranks, timeout_s=600)


def _books(pkg):
    _, lazy, mat = dc.ois_books(pkg)
    return dict(lazy=lazy, materialized=mat, credit=dc.credit_book(pkg))


@pytest.fixture(scope="module")
def port_books():
    """The port's books, and the materialized tile of each (``mat_*``)."""
    out = _books("adrates_torch")
    out.update(mat_lazy=out["materialized"],
               mat_materialized=out["materialized"],
               mat_credit=dc.credit_books()[1])
    return out


@pytest.fixture(scope="module")
def jax_out():
    books = _books("adrates_tpu")
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("book",))
    lazy = books["lazy"]
    q0 = np.asarray(lazy.basket.quotes0)
    out = {f"ladder_{k}": np.asarray(
        jps.make_sharded_per_trade_delta_fn(mb, mesh)(mb.basket.quotes0))
        for k, mb in books.items()}
    out["gamma"] = np.asarray(jps.make_sharded_per_trade_gamma_fn(
        lazy, mesh, dc.selection(lazy))(q0))
    out["blocks"] = [(g.cids, np.asarray(g.qidx), np.asarray(g.trade_ids),
                      np.asarray(g.blocks))
                     for g in jps.make_sharded_per_trade_gamma_blocks_fn(
                         lazy, mesh)(q0)]
    return out


def _close(got, ref, rel=1e-12):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = ref.numpy() if torch.is_tensor(ref) else np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rel * np.abs(ref).max())


def _jax_close(got, ref, rtol, atol):
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=atol * (np.abs(ref).max() + 1.0))


@pytest.mark.parametrize("book", LADDER_BOOKS)
def test_ladders_match_jax(ranks, jax_out, book):
    key = f"ladder_{book}"
    _jax_close(ranks[0][key]["gathered"], jax_out[key], 1e-12, 1e-13)


@pytest.mark.parametrize("book", LADDER_BOOKS)
def test_ladders_match_single_device(ranks, port_books, book):
    mb = port_books[book]
    ref = tmb.make_per_trade_delta_fn(mb, "cpu")(mb.basket.quotes0)
    res = ranks[0][f"ladder_{book}"]
    assert res["n_trades"] == mb.n_trades
    _close(res["gathered"][:mb.n_trades], ref)


@pytest.mark.parametrize("book", LADDER_BOOKS)
def test_ladder_blocks_are_the_ranks_trades(ranks, port_books, book):
    """Each rank's block is its trade range of the gathered ladder, the
    padded tail rows exact zeros, every rank's gather the same."""
    key = f"ladder_{book}"
    B = port_books[book].n_trades
    n_pad = B + (-B) % WORLD
    whole = ranks[0][key]["gathered"]
    assert whole.shape[0] == n_pad
    assert not whole[B:].any()
    for r, res in enumerate(ranks):
        lo, hi = res[key]["trade_range"]
        assert (lo, hi) == (r * n_pad // WORLD, (r + 1) * n_pad // WORLD)
        assert res[key]["k1_calls"] == [hi - lo]   # one sweep, its trades
        np.testing.assert_array_equal(res[key]["block"], whole[lo:hi])
        np.testing.assert_array_equal(res[key]["gathered"], whole)


@pytest.mark.parametrize("book", LADDER_BOOKS)
def test_ladder_shard_holds_only_its_own_rows(ranks, port_books, book):
    mb = port_books["mat_" + book]
    rt = np.concatenate([np.asarray(cb.row_trade) for cb in mb.cols])
    for res in ranks:
        s = res[f"ladder_{book}"]
        assert s["rows"] == int(((rt >= s["lo"]) & (rt < s["hi"])).sum())
    assert sum(r[f"ladder_{book}"]["rows"] for r in ranks) == rt.shape[0]


def test_gammas_match_jax(ranks, jax_out):
    _jax_close(ranks[0]["gamma"]["gathered"], jax_out["gamma"], 1e-9, 1e-12)


def test_gammas_match_single_device(ranks, port_books):
    mb = port_books["lazy"]
    ref = make_per_trade_gamma_fn(mb, dc.selection(mb), "cpu")(
        mb.basket.quotes0)
    _close(ranks[0]["gamma"]["gathered"], ref)


def test_gamma_parts_split_the_padded_selection(ranks):
    n_loc = -(-dc.N_SEL // WORLD)
    whole = ranks[0]["gamma"]["gathered"]
    assert whole.shape[0] == dc.N_SEL
    padded = np.concatenate([whole, np.repeat(whole[-1:], n_loc * WORLD
                                              - dc.N_SEL, axis=0)])
    for r, res in enumerate(ranks):
        lo, hi = res["gamma"]["sel_range"]
        assert (lo, hi) == (r * n_loc, (r + 1) * n_loc)
        np.testing.assert_array_equal(res["gamma"]["local"], padded[lo:hi])


def test_blocks_match_jax(ranks, jax_out):
    got = ranks[0]["blocks"]["gathered"]
    assert len(got) == len(jax_out["blocks"]) > 0
    for (cids, qidx, ids, blk), (jc, jq, jids, jblk) in zip(
            got, jax_out["blocks"]):
        assert tuple(cids) == tuple(jc)
        np.testing.assert_array_equal(qidx, jq)
        np.testing.assert_array_equal(ids, jids)
        _jax_close(blk, jblk, 1e-9, 1e-12)


def test_blocks_match_single_device(ranks, port_books):
    mb = port_books["lazy"]
    ref = make_per_trade_gamma_blocks_fn(mb, "cpu")(mb.basket.quotes0)
    got = ranks[0]["blocks"]["gathered"]
    assert len(got) == len(ref)
    for (cids, qidx, ids, blk), g in zip(got, ref):
        assert cids == g.cids
        np.testing.assert_array_equal(ids, g.trade_ids)
        _close(blk, g.blocks)


def test_block_shares_split_each_group(ranks, port_books):
    """Each rank holds its contiguous share (ceil(Bg / 3)) of every
    group's base trades, in every copy; the shares cover each group."""
    n_cop = len(port_books["lazy"].tile.scale)
    whole = ranks[0]["blocks"]["gathered"]
    for g, (_, _, ids, _) in enumerate(whole):
        n_base = ids.shape[0] // n_cop
        share = -(-n_base // WORLD)
        got = []
        for r, res in enumerate(ranks):
            lo, hi = res["blocks"]["ranges"][g]
            assert (lo, hi) == (min(r * share, n_base),
                                min((r + 1) * share, n_base))
            local_ids = res["blocks"]["local"][g][1]
            assert local_ids.shape[0] == n_cop * (hi - lo)
            got.append(local_ids.reshape(n_cop, -1))
        np.testing.assert_array_equal(np.concatenate(got, axis=1).ravel(),
                                      ids)
