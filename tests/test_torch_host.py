"""adrates_torch host layer against adrates_tpu: the same 3-curve OIS
model and 8-trade book compiled by both packages must give identical
grids, column tables, trade row tables, trip groups and stage plans, and
the same weights to 1e-15 relative."""

import dataclasses

import numpy as np
import pytest

import torch_cases as cases
from adrates_tpu.parallel import multibook as jmb
from adrates_torch.parallel import multibook as tmb


@pytest.fixture(scope="module")
def books():
    jm = cases.build_model("adrates_tpu")
    tm = cases.build_model("adrates_torch")
    return cases.compile_book("adrates_tpu", jm), \
        cases.compile_book("adrates_torch", tm)


def _rel(a, b):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=1e-15,
                               atol=0)


def test_basket_order_and_quotes(books):
    (jb, _), (tb, _) = books
    assert [s.name for s in jb.basket.specs] == \
        [s.name for s in tb.basket.specs]
    assert [s.offset for s in jb.basket.specs] == \
        [s.offset for s in tb.basket.specs]
    np.testing.assert_array_equal(jb.basket.quotes0, tb.basket.quotes0)


@pytest.mark.parametrize("name", ["unique_times", "grid_sel",
                                  "grid_curve_of"])
def test_grid_axis_exact(books, name):
    (jb, _), (tb, _) = books
    src_j = jb if name == "unique_times" else jb.basket
    src_t = tb if name == "unique_times" else tb.basket
    np.testing.assert_array_equal(np.asarray(getattr(src_j, name)),
                                  np.asarray(getattr(src_t, name)))
    assert jb.basket.n_grid == tb.basket.n_grid


@pytest.mark.parametrize("field", [f.name for f in
                                   dataclasses.fields(tmb.MultiBookRows)])
def test_row_buckets(books, field):
    (jb, _), (tb, _) = books
    assert len(jb.buckets) == len(tb.buckets)
    for a, b in zip(jb.buckets, tb.buckets):
        a, b = np.asarray(getattr(a, field)), getattr(b, field)
        if np.issubdtype(b.dtype, np.integer):
            np.testing.assert_array_equal(a, b)
        else:
            _rel(a, b)


def test_column_tables(books):
    (jb, _), (tb, _) = books
    assert len(jb.cols) == len(tb.cols)
    for a, b in zip(jb.cols, tb.cols):
        np.testing.assert_array_equal(np.asarray(a.col_idx), b.col_idx)
        np.testing.assert_array_equal(np.asarray(a.row_trade), b.row_trade)
        _rel(a.w, b.w)


@pytest.mark.parametrize("tiled", [False, True])
def test_aggregate(books, tiled):
    (jb, jt), (tb, tt) = books
    ja, ta = (jt, tt) if tiled else (jb, tb)
    for f in ("trip_s", "trip_e", "trip_p"):
        np.testing.assert_array_equal(np.asarray(getattr(ja.aggregate, f)),
                                      getattr(ta.aggregate, f))
    _rel(ja.aggregate.w_lin, ta.aggregate.w_lin)
    _rel(ja.aggregate.trip_w, ta.aggregate.trip_w)


@pytest.mark.parametrize("tiled", [False, True])
def test_trade_row_table(books, tiled):
    (jb, jt), (tb, tt) = books
    ja, ta = (jt, tt) if tiled else (jb, tb)
    np.testing.assert_array_equal(jmb._trade_row_table(ja),
                                  tmb._trade_row_table(ta))


def test_term1_trip_groups(books):
    (jb, _), (tb, _) = books
    jg = jmb._term1_trip_groups(jb.basket, jb.aggregate)
    tg = tmb._term1_trip_groups(tb.basket, tb.aggregate)
    assert len(jg) == len(tg) == 3
    for a, b in zip(jg, tg):
        for k in ("tsel", "s_idx", "e_idx", "p_idx"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert tuple(a["segs"]) == tuple(b["segs"])
        assert a["k"] == b["k"]


def test_stage_plans(books):
    (jb, _), (tb, _) = books
    jbat, tbat = jb.basket.params["bat"], tb.basket.bat
    jst, tst = jb.basket._stages, tb.basket.stages
    assert [(s.key, s.ids) for s in jst] == [(s.key, s.ids) for s in tst]
    for st in tst:
        a, b = jbat[st.key], tbat[st.key]
        for k in ("qidx", "pad_mask", "sent", "ts_static"):
            np.testing.assert_array_equal(np.asarray(a[k]), b[k],
                                          err_msg=k)
        for f in dataclasses.fields(b["plan"]):
            v = getattr(b["plan"], f.name)
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(
                    np.asarray(getattr(a["plan"], f.name)), v,
                    err_msg=f.name)
            else:
                assert getattr(a["plan"], f.name) == v, f.name
        assert sorted(a["row_plan"]) == sorted(b["row_plan"])
        for scheme, p in b["row_plan"].items():
            for k, v in p.items():
                np.testing.assert_array_equal(
                    np.asarray(a["row_plan"][scheme][k]), v, err_msg=k)


def test_grid_plans(books):
    (jb, _), (tb, _) = books
    jg, tg = jb.basket.params["bat"]["gplan"], tb.basket.bat["gplan"]
    assert sorted(jg) == sorted(tg)
    for scheme, p in tg.items():
        for k, v in p.items():
            np.testing.assert_array_equal(np.asarray(jg[scheme][k]), v,
                                          err_msg=k)


def test_unported_instrument_raises():
    from adrates_torch.utils import CollateralType, LibError
    tm = cases.build_model("adrates_torch")
    trades = cases.build_trades("adrates_torch", tm)
    with pytest.raises(LibError):
        tmb.compile_multibook(trades[:1], tm,
                              collateral_types=[CollateralType.USD])
