"""The port's single-curve book path (``adrates_torch/parallel/book.py``)
against the JAX package's, on the CPU: ``compile_book`` with and without
``pad_to``, ``tile_book`` with coupon and notional scales,
``aggregate_book``, ``aggregate_total_pv``, ``book_analytics``,
``make_book_fn`` (pvs, delta, gamma), and ``compile_book_buckets`` +
``merge_aggregates`` + ``make_bucketed_book_fn``, on the quick start's 20
swaps and 13-pillar GBP curve under 3 scenarios, on FLAT_FWD_RATES and
PCHIP_LOG_DISCOUNT, at 1e-10 x max|ref|; plus the PVs going through
``kernels.pvs_sweep`` (the CPU twin: no launch counted), tables built
once per book, and the device rule."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import adrates_tpu.parallel.book as jbook
import adrates_torch.parallel.book as tbook
import torch_cases as tc
from adrates_torch.ops import kernels
from adrates_torch.utils import LibError

SCHEMES = ["FLAT_FWD_RATES", "PCHIP_LOG_DISCOUNT"]
FIELDS = [f.name for f in dataclasses.fields(tbook.BookTensors)]
N_SCEN = 3


def _close(got, ref, rel=1e-10):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rel * max(np.abs(ref).max(), 1e-300))


@pytest.fixture(scope="module", params=SCHEMES)
def case(request):
    """Both packages' model, curve, swaps, base and tiled books, and the
    scenario shocks, on one scheme."""
    out = {}
    scales = np.random.default_rng(tc.SEED).uniform(0.5, 1.5, (2, 4))
    for pkg, mod in (("adrates_tpu", jbook), ("adrates_torch", tbook)):
        m = tc.quickstart_gbp_model(pkg, request.param)
        curve = m.curves.GBP_OIS_SONIA
        swaps = tc.quickstart_book_swaps(pkg, np.random.default_rng(0))
        base = mod.compile_book(swaps, m.value_dt)
        out[pkg] = dict(curve=curve, swaps=swaps, base=base,
                        book=mod.tile_book(base, 4, scales[0], scales[1]))
    out["shocks"] = np.random.default_rng(tc.SEED + 1).normal(
        0.0, 1e-3, (N_SCEN, len(tc.QS_GBP_RATES)))
    return out


@pytest.fixture(scope="module")
def jax_out(case):
    j = case["adrates_tpu"]
    c = j["curve"]
    fn = jbook.make_book_fn(c._plan, c._interp_type)
    return fn(jnp.asarray(c.swap_rates), j["book"],
              jbook.aggregate_book(j["book"]), jnp.asarray(case["shocks"]))


def _torch_fn(case, **kw):
    c = case["adrates_torch"]["curve"]
    return tbook.make_book_fn(c._plan, c._interp_type, device="cpu", **kw)


@pytest.mark.parametrize("pad_to", [None, 40])
def test_compile_book(pad_to):
    books = {}
    for pkg, mod in (("adrates_tpu", jbook), ("adrates_torch", tbook)):
        m = tc.quickstart_gbp_model(pkg, "FLAT_FWD_RATES")
        swaps = tc.quickstart_book_swaps(pkg, np.random.default_rng(0))
        books[pkg] = mod.compile_book(swaps, m.value_dt, pad_to=pad_to)
    got, ref = books["adrates_torch"], books["adrates_tpu"]
    assert got.num_trades == 20
    if pad_to is not None:
        assert got.fix_idx.shape == (20, pad_to)
    for f in FIELDS:
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(ref, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_tile_book_with_scales(case):
    got, ref = case["adrates_torch"]["book"], case["adrates_tpu"]["book"]
    assert got.num_trades == 80
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(ref, f)),
                                      err_msg=f)


def test_aggregate_book(case):
    got = tbook.aggregate_book(case["adrates_torch"]["book"])
    ref = jbook.aggregate_book(case["adrates_tpu"]["book"])
    for f in ("trip_s", "trip_e", "trip_p", "unique_times"):
        np.testing.assert_array_equal(getattr(got, f),
                                      np.asarray(getattr(ref, f)))
    _close(got.w_lin, ref.w_lin)
    _close(got.trip_w, ref.trip_w)


def test_aggregate_total_pv(case):
    j, t = case["adrates_tpu"], case["adrates_torch"]
    q = case["shocks"][0]
    ref = jbook.aggregate_total_pv(
        jnp.asarray(j["curve"].swap_rates) + q, j["curve"]._plan,
        j["curve"]._interp_type, jbook.aggregate_book(j["book"]))
    got = tbook.aggregate_total_pv(
        torch.tensor(t["curve"].swap_rates, dtype=torch.float64)
        + torch.from_numpy(q), t["curve"]._plan, t["curve"]._interp_type,
        tbook.aggregate_book(t["book"]))
    assert abs(float(got) - float(ref)) <= 1e-10 * abs(float(ref))


def test_book_analytics(case):
    j, t = case["adrates_tpu"], case["adrates_torch"]
    ref = jax.jit(jbook.book_analytics, static_argnums=2)(
        jnp.asarray(j["curve"].swap_rates), j["curve"]._plan,
        j["curve"]._interp_type, j["base"], jnp.asarray(case["shocks"]))
    got = tbook.book_analytics(t["curve"].swap_rates, t["curve"]._plan,
                               t["curve"]._interp_type, t["base"],
                               case["shocks"], device="cpu")
    for a, b in zip(got, ref):
        _close(a, b)


@pytest.mark.parametrize("key", ["pvs", "delta", "gamma"])
def test_make_book_fn(case, jax_out, key):
    t = case["adrates_torch"]
    out = _torch_fn(case)(t["curve"].swap_rates, t["book"],
                          tbook.aggregate_book(t["book"]), case["shocks"])
    _close(out[key], jax_out[key])


def test_make_book_fn_aggregate_equals_trade_sum(case):
    """Σ trade PVs = the aggregate's total in every scenario, and the
    delta-only function gives the same delta."""
    t = case["adrates_torch"]
    agg = tbook.aggregate_book(t["book"])
    rates = torch.tensor(t["curve"].swap_rates, dtype=torch.float64)
    out = _torch_fn(case, want_gamma=False)(rates, t["book"], agg,
                                            case["shocks"])
    assert "gamma" not in out
    full = _torch_fn(case)(rates, t["book"], agg, case["shocks"])
    _close(out["delta"], full["delta"].numpy())
    for s, shock in enumerate(case["shocks"]):
        total = tbook.aggregate_total_pv(
            rates + torch.from_numpy(shock), t["curve"]._plan,
            t["curve"]._interp_type, agg)
        assert abs(float(out["pvs"][s].sum()) - float(total)) \
            <= 1e-10 * abs(float(total))


def test_make_book_fn_pvs_go_through_k1(case, monkeypatch):
    """One pvs_sweep call per make_book_fn call, on the tables built at
    the first call and kept; the CPU path is the twin, so the launch
    counter stays 0."""
    t = case["adrates_torch"]
    calls = []
    sweep = kernels.pvs_sweep

    def counting(vT, tab):
        calls.append((tuple(vT.shape), tab))
        return sweep(vT, tab)

    monkeypatch.setattr(kernels, "pvs_sweep", counting)
    launches = sweep.launches
    fn = _torch_fn(case)
    agg = tbook.aggregate_book(t["book"])
    tables = fn.tables(t["book"])
    for _ in range(2):
        fn(t["curve"].swap_rates, t["book"], agg, case["shocks"])
    assert len(calls) == 2
    U = t["book"].unique_times.shape[0]
    T = tables.trip_s.shape[0]
    assert calls[0][0] == (U + T, N_SCEN)
    assert all(tab is tables.sweep for _, tab in calls)
    assert fn.tables(t["book"]) is tables
    assert tables.sweep.n_trades == t["book"].num_trades
    assert sweep.launches == launches


def test_padded_book_prices_the_same(case):
    """A book compiled with pad_to prices as the unpadded one: K1's CSR
    holds live slots only."""
    t = case["adrates_torch"]
    padded = tbook.compile_book(t["swaps"], t["curve"]._value_dt,
                                pad_to=45)
    fn = _torch_fn(case)
    a = fn(t["curve"].swap_rates, t["base"], tbook.aggregate_book(t["base"]),
           case["shocks"])
    b = fn(t["curve"].swap_rates, padded, tbook.aggregate_book(padded),
           case["shocks"])
    for key in ("pvs", "delta", "gamma"):
        _close(b[key], a[key].numpy(), rel=1e-13)


def test_buckets(case):
    j, t = case["adrates_tpu"], case["adrates_torch"]
    books_j, order_j = jbook.compile_book_buckets(
        j["swaps"], j["curve"]._value_dt, n_buckets=4)
    books_t, order_t = tbook.compile_book_buckets(
        t["swaps"], t["curve"]._value_dt, n_buckets=4)
    np.testing.assert_array_equal(order_t, order_j)
    assert len(books_t) == len(books_j) == 4
    for bt, bj in zip(books_t, books_j):
        for f in FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(bt, f)),
                                          np.asarray(getattr(bj, f)))
    agg_j = jbook.merge_aggregates([jbook.aggregate_book(b)
                                    for b in books_j])
    agg_t = tbook.merge_aggregates([tbook.aggregate_book(b)
                                    for b in books_t])
    for f in ("trip_s", "trip_e", "trip_p"):
        np.testing.assert_array_equal(getattr(agg_t, f),
                                      np.asarray(getattr(agg_j, f)))
    _close(agg_t.w_lin, agg_j.w_lin)
    _close(agg_t.trip_w, agg_j.trip_w)
    # the merged buckets' aggregate is the monolithic book's
    mono = tbook.aggregate_book(t["base"])
    np.testing.assert_array_equal(agg_t.trip_s, mono.trip_s)
    _close(agg_t.w_lin, mono.w_lin)
    _close(agg_t.trip_w, mono.trip_w)

    c = j["curve"]
    ref = jbook.make_bucketed_book_fn(c._plan, c._interp_type)(
        jnp.asarray(c.swap_rates), books_j, agg_j,
        jnp.asarray(case["shocks"]))
    c = t["curve"]
    fn = tbook.make_bucketed_book_fn(c._plan, c._interp_type, device="cpu")
    got = fn(c.swap_rates, books_t, agg_t, case["shocks"])
    for key in ("pvs", "delta", "gamma"):
        _close(got[key], ref[key])
    # in sorted order: the monolithic book's PVs permuted by ``order``
    mono_out = _torch_fn(case)(c.swap_rates, t["base"], mono,
                               case["shocks"])
    _close(got["pvs"], mono_out["pvs"].numpy()[:, order_t], rel=1e-12)
    assert fn.tables(books_t).sweep.n_trades == 20


def test_device_rule():
    """None means the card: without one the builders raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: None selects it")
    m = tc.quickstart_gbp_model("adrates_torch", "FLAT_FWD_RATES")
    c = m.curves.GBP_OIS_SONIA
    for build in (tbook.make_book_fn, tbook.make_bucketed_book_fn):
        with pytest.raises(LibError, match="device='cpu'"):
            build(c._plan, c._interp_type)
