"""Block-sparse per-trade gammas on the CPU: the port's
``make_per_trade_gamma_blocks_fn`` against the JAX package's on the books
of ``test_torch_pertrade`` (the OIS book, the OIS + XCCY book
recalibrated and held, the credit book with clamp slots, the inflation
book and the all-kinds book, tiled x2-3): the same signature groups
(cids, quote rows, trade ids) and the same blocks, with a device budget
of one byte so that the term-2 sub-block split runs; a trade with no live
slot is in no group.

Tolerance: 1e-10 x max|ref| (f64, sums in another order)."""

import dataclasses

import numpy as np
import pytest

import adrates_tpu  # noqa: F401 — enables x64 for the JAX side
import torch_cases as cases
from adrates_tpu.parallel import pertrade_blocks as jpb
from adrates_torch.ops import kernels
from adrates_torch.parallel import multibook as tmb
from adrates_torch.parallel import pertrade_blocks as tpb
from adrates_torch.utils import LibError

BOOKS = cases.PERTRADE_BOOKS
build_book = cases.pertrade_book
selection = cases.pertrade_selection


def _groups_equal(jg, tg):
    assert [tuple(int(c) for c in g.cids) for g in jg] == \
        [g.cids for g in tg]
    for a, b in zip(jg, tg):
        np.testing.assert_array_equal(b.qidx, np.asarray(a.qidx))
        np.testing.assert_array_equal(b.trade_ids, np.asarray(a.trade_ids))


@pytest.fixture(scope="module", params=BOOKS)
def book(request):
    name = request.param
    jb = build_book("adrates_tpu", name)
    return dict(name=name, jb=jb, tb=build_book("adrates_torch", name),
                ref=jpb.make_per_trade_gamma_blocks_fn(jb)(
                    jb.basket.quotes0))


def test_groups_match_jax(book):
    tg = tpb.make_per_trade_gamma_blocks_fn(book["tb"], "cpu")(
        book["jb"].basket.quotes0)
    _groups_equal(book["ref"], tg)


@pytest.mark.parametrize("split", [True, False], ids=["split", "whole"])
def test_blocks_match_jax(book, split, monkeypatch):
    """Whole groups, and one-trade sub-blocks of term 2 (a budget of
    one byte)."""
    tb = book["tb"]
    if split:
        monkeypatch.setattr(tmb, "RISK_CHUNK_BYTES", 1)
    fn = tpb.make_per_trade_gamma_blocks_fn(tb, "cpu")
    assert fn.sub_sizes == [[1] * bg if split else [bg]
                            for _, _, bg in fn.group_meta]
    before = kernels.pertrade_quad_form.launches
    tg = fn(book["jb"].basket.quotes0)
    assert kernels.pertrade_quad_form.launches == before
    assert fn.n_groups == len(tg)
    scale = max(float(np.abs(np.asarray(g.blocks)).max())
                for g in book["ref"])
    for a, b in zip(book["ref"], tg):
        np.testing.assert_allclose(b.blocks.numpy(), np.asarray(a.blocks),
                                   rtol=0, atol=1e-10 * scale)


def test_blocks_equal_dense_selected_gammas(book):
    """dense_from_block of each selected trade equals its dense gamma
    from make_per_trade_gamma_fn (two port paths, one K3 twin)."""
    tb = book["tb"]
    q0 = tb.basket.quotes0
    N = tb.basket.n_quotes
    sel = selection(tb)
    dense = tmb.make_per_trade_gamma_fn(tb, sel, "cpu")(q0).numpy()
    groups = tpb.make_per_trade_gamma_blocks_fn(tb, "cpu")(q0)
    where = {int(t): (g, p) for g in groups
             for p, t in enumerate(g.trade_ids)}
    for i, t in enumerate(sel):
        g, p = where[t]
        np.testing.assert_allclose(tpb.dense_from_block(g, p, N), dense[i],
                                   rtol=0,
                                   atol=1e-10 * np.abs(dense[i]).max())


def _drop_trade(mb, t: int):
    """``mb`` with base trade ``t``'s slots dead (weights 0) and its
    clamp slots removed."""
    cols = tuple(dataclasses.replace(
        c, w=np.where((np.asarray(c.row_trade) == t)[:, None], 0.0,
                      np.asarray(c.w)))
        for c in mb.cols)
    clamp = mb.clamp
    if clamp is not None:
        keep = np.asarray(clamp.slot_trade) != t
        clamp = type(clamp)(**{
            f.name: np.asarray(getattr(clamp, f.name))[keep]
            for f in dataclasses.fields(clamp)})
    return dataclasses.replace(mb, cols=cols, clamp=clamp)


def test_trade_without_live_slots_is_in_no_group():
    tb = build_book("adrates_torch", "credit")
    t = int(np.asarray(tb.clamp.slot_trade)[0])
    tb = _drop_trade(tb, t)
    assert not tpb._touched_sets(tb)[t].any()
    tg = tpb.make_per_trade_gamma_blocks_fn(tb, "cpu")(tb.basket.quotes0)
    ids = np.concatenate([g.trade_ids for g in tg])
    B = tb.tile.base_trades
    assert t not in ids % B
    assert ids.shape[0] == tb.n_trades - tb.n_trades // B


def test_blocks_need_the_stage_topology():
    from adrates_torch.utils import CurrencyTypes
    m = cases.build_model("adrates_torch")
    mb = tmb.compile_multibook(cases.build_trades("adrates_torch", m), m,
                               base_currency=CurrencyTypes.USD,
                               batch_curves=False)
    with pytest.raises(LibError, match="batch_curves=True"):
        tpb.make_per_trade_gamma_blocks_fn(mb, "cpu")


def test_untiled_book_gives_the_base_blocks():
    """An untiled book's blocks are the tiled book's first copy over its
    notional scale, group by group (the base trades' own ids)."""
    tb = build_book("adrates_torch", "credit")
    base = dataclasses.replace(tb, tile=None, n_trades=tb.tile.base_trades)
    q0 = tb.basket.quotes0
    tiled = tpb.make_per_trade_gamma_blocks_fn(tb, "cpu")(q0)
    plain = tpb.make_per_trade_gamma_blocks_fn(base, "cpu")(q0)
    s0 = float(tb.tile.scale[0])
    B = tb.tile.base_trades
    for a, b in zip(tiled, plain):
        n = b.trade_ids.shape[0]
        np.testing.assert_array_equal(b.trade_ids, a.trade_ids[:n])
        assert (b.trade_ids < B).all()
        np.testing.assert_allclose(b.blocks.numpy(),
                                   a.blocks[:n].numpy() / s0, rtol=0,
                                   atol=1e-12 * float(b.blocks.abs().max()))


def test_single_copy_tile_scales_blocks():
    """A book tiled into one copy of scale 2.5 gives 2.5 x the untiled
    blocks (the copies are always the scale broadcast of the base
    blocks)."""
    tb = build_book("adrates_torch", "credit")
    base = dataclasses.replace(tb, tile=None, n_trades=tb.tile.base_trades)
    one = tmb.tile_multibook(base, 1, notional_scale=[2.5])
    q0 = tb.basket.quotes0
    ref = tpb.make_per_trade_gamma_blocks_fn(base, "cpu")(q0)
    for a, b in zip(ref, tpb.make_per_trade_gamma_blocks_fn(one, "cpu")(q0)):
        np.testing.assert_array_equal(b.trade_ids, a.trade_ids)
        np.testing.assert_allclose(b.blocks.numpy(), 2.5 * a.blocks.numpy(),
                                   rtol=1e-14, atol=0)
