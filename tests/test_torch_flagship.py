"""The port's flagship_v5 base book (``adrates_torch/examples/
flagship_v5.py``) against ``bench.py``'s builders compiled by adrates_tpu,
on the CPU: the same 12-curve basket and quotes, the same compacted grid
(n_grid 11,340), row buckets, column tables, aggregate (T = 4,643), the
11 term-1 trip groups, the 410 clamp slots and the same stages
(ois x7, xccy x3, infl x2); and the flat grid at quotes0 within 1e-14
(relative to its largest entry). No risk pass runs at this size here.

Tolerances: integer tables exactly; weights 1e-15 relative.
"""

import dataclasses

import numpy as np
import pytest
import torch

import adrates_tpu  # noqa: F401 — enables x64 for the JAX side
import bench
from adrates_tpu.parallel import multibook as jmb
from adrates_torch.examples import flagship_v5 as cfg
from adrates_torch.parallel import multibook as tmb
from adrates_torch.parallel.curve_batching import bat_to_torch


@pytest.fixture(scope="module")
def books():
    from adrates_tpu.utils import CurrencyTypes
    jm = bench.build_model()
    trades, coll = bench.build_base_trades(jm, np.random.default_rng(7))
    jb = jmb.compile_multibook(trades, jm, base_currency=CurrencyTypes.USD,
                               n_buckets=4, collateral_types=coll,
                               stage_buckets="coarse")
    tm = cfg.build_model()
    trades, coll = cfg.build_base_trades(tm, np.random.default_rng(cfg.SEED))
    with pytest.warns(UserWarning, match="CHF_OIS_SARON"):
        tb = cfg.compile_base(tm, trades, coll)
    return jb, tb


def _close(a, b):
    np.testing.assert_allclose(b, np.asarray(a), rtol=1e-15, atol=0)


def test_shapes(books):
    _, tb = books
    assert tb.n_trades == 1004
    assert tb.basket.n_quotes == 184
    assert tb.basket.n_grid == 11_340
    assert tb.aggregate.trip_s.shape[0] == 4_643
    assert tb.clamp.w.shape[0] == 410
    assert [(st.kind, len(st.ids)) for st in tb.basket.stages] == \
        [("ois", 7), ("xccy", 3), ("infl", 2)]
    assert len(tmb._term1_trip_groups(tb.basket, tb.aggregate)) == 11


def test_basket_order_and_quotes(books):
    jb, tb = books
    assert [(s.name, s.kind, s.offset, s.n_quotes)
            for s in jb.basket.specs] == \
        [(s.name, s.kind, s.offset, s.n_quotes) for s in tb.basket.specs]
    np.testing.assert_array_equal(tb.basket.quotes0, jb.basket.quotes0)


@pytest.mark.parametrize("name", ["unique_times", "grid_sel",
                                  "grid_curve_of"])
def test_grid_axis(books, name):
    jb, tb = books
    src_j = jb if name == "unique_times" else jb.basket
    src_t = tb if name == "unique_times" else tb.basket
    np.testing.assert_array_equal(getattr(src_t, name),
                                  np.asarray(getattr(src_j, name)))


@pytest.mark.parametrize("field", [f.name for f in
                                   dataclasses.fields(tmb.MultiBookRows)])
def test_row_buckets(books, field):
    jb, tb = books
    assert len(jb.buckets) == len(tb.buckets)
    for a, b in zip(jb.buckets, tb.buckets):
        _close(getattr(a, field), getattr(b, field))


def test_column_tables(books):
    jb, tb = books
    assert [c.col_idx.shape for c in tb.cols] == \
        [tuple(c.col_idx.shape) for c in jb.cols]
    for a, b in zip(jb.cols, tb.cols):
        np.testing.assert_array_equal(b.col_idx, np.asarray(a.col_idx))
        np.testing.assert_array_equal(b.row_trade, np.asarray(a.row_trade))
        _close(a.w, b.w)


@pytest.mark.parametrize("field", [f.name for f in dataclasses.fields(
    tmb.MultiBookAggregate)])
def test_aggregate(books, field):
    jb, tb = books
    _close(getattr(jb.aggregate, field), getattr(tb.aggregate, field))


@pytest.mark.parametrize("field", [f.name for f in
                                   dataclasses.fields(tmb.ClampSlots)])
def test_clamp_slots(books, field):
    jb, tb = books
    np.testing.assert_array_equal(getattr(tb.clamp, field),
                                  np.asarray(getattr(jb.clamp, field)))


def test_trip_groups(books):
    jb, tb = books
    jg = jmb._term1_trip_groups(jb.basket, jb.aggregate)
    tg = tmb._term1_trip_groups(tb.basket, tb.aggregate)
    assert len(jg) == len(tg) == 11
    for a, b in zip(jg, tg):
        for k in ("tsel", "s_idx", "e_idx", "p_idx"):
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
        assert tuple(a["segs"]) == tuple(b["segs"]) and a["k"] == b["k"]
    assert sorted(g["k"] for g in tg).count(40) == 2   # the inflation pair


def test_flat_grid_at_quotes0(books):
    import jax.numpy as jnp
    jb, tb = books
    ref = np.asarray(jb.basket.grids(jnp.asarray(jb.basket.quotes0),
                                     jb.basket.params))
    P = {"bat": bat_to_torch(tb.basket.bat, "cpu"),
         "grid_sel": torch.as_tensor(tb.basket.grid_sel.astype(np.int64))}
    got = tb.basket.grids(torch.as_tensor(tb.basket.quotes0), P).numpy()
    assert got.shape == ref.shape == (11_340,)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-14 * np.abs(ref).max())
