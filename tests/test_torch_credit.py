"""The port's FRNs and bonds against adrates_tpu on the CPU: their leg
tensors field by field, their host values, and the credit book of
tests/multibook_cases.py:trades_for compiled by the port itself — its
clamp slots and aggregate against the JAX compile, and pvs, delta and
gamma at 3 scenarios, tiled x2 (the clamp aggregate is tiled by the
scale sum), on the structured split, the generic split and the staged
path.

Tolerances: tensors exactly (times, alphas and amounts come from the
same date arithmetic); host values rtol 1e-12 (static against dynamic
interpolation plans); compiled weights 1e-15 relative; book outputs
1e-10 x max|ref|.
"""

import dataclasses
import importlib

import numpy as np
import pytest

import adrates_tpu  # noqa: F401 — enables x64 for the JAX side
import torch_cases as cases
from adrates_tpu.parallel import multibook as jmb
from adrates_torch.parallel import multibook as tmb

PKGS = ("adrates_tpu", "adrates_torch")


def _frns(pkg, model):
    """FRNs covering the leg tensor's switches: plain, capped and
    floored, a known first fixing (seasoned), a USD FRN on ACT/365F whose
    index curve counts ACT/360, a floor only."""
    u = importlib.import_module(f"{pkg}.utils")
    credit = importlib.import_module(f"{pkg}.trades.credit")
    v = model.value_dt
    D, F, C, Y = (u.DayCountTypes, u.FrequencyTypes, u.CurveTypes,
                  u.CurrencyTypes)
    gbp = dict(floating_index=C.GBP_OIS_SONIA, currency=Y.GBP)
    return {
        "plain": credit.FRN(v, "5Y", 0.0015, F.QUARTERLY, D.ACT_365F,
                            face_value=5e6, **gbp),
        "capped": credit.FRN(v.add_months(1).add_days(11), "7Y", 0.002,
                             F.SEMI_ANNUAL, D.ACT_365F, face_value=3e6,
                             cap_rate=0.045, floor_rate=0.02, **gbp),
        "first_fixing": credit.FRN(v.add_months(-2), "3Y", 0.001,
                                   F.QUARTERLY, D.ACT_365F, face_value=4e6,
                                   first_fixing_rate=0.0512, cap_rate=0.05,
                                   **gbp),
        "index_dc": credit.FRN(v.add_months(4).add_days(3), "10Y", 0.0025,
                               F.ANNUAL, D.ACT_365F, Y.USD, C.USD_OIS_SOFR,
                               face_value=2e6),
        "floor_only": credit.FRN(v, "2Y", 0.0005, F.QUARTERLY, D.ACT_365F,
                                 face_value=1e6, floor_rate=0.049, **gbp),
    }


def _bonds(pkg, model):
    u = importlib.import_module(f"{pkg}.utils")
    credit = importlib.import_module(f"{pkg}.trades.credit")
    v = model.value_dt
    D, F, Y = u.DayCountTypes, u.FrequencyTypes, u.CurrencyTypes
    return {
        "bullet": credit.Bond(v.add_months(-31).add_days(9), "7Y", 0.04,
                              F.SEMI_ANNUAL, D.THIRTY_360_BOND, Y.USD,
                              face_value=1e6),
        "amortizing": credit.Bond(v.add_months(-9).add_days(21), "5Y",
                                  0.035, F.ANNUAL, D.ACT_365F, Y.GBP,
                                  face_value=5e6,
                                  amortization_schedule=[4e6, 3e6, 2e6,
                                                         1e6, 0.0]),
    }


@pytest.fixture(scope="module")
def models():
    return {pkg: cases.build_credit_model(pkg) for pkg in PKGS}


def _tensor_fields(t):
    return {f.name: getattr(t, f.name) for f in dataclasses.fields(t)}


@pytest.mark.parametrize("name", ["plain", "capped", "first_fixing",
                                  "index_dc", "floor_only"])
def test_frn_tensor(models, name):
    from adrates_tpu.market.position.engine_credit import _frn_tensor as jf
    from adrates_torch.market.position.engine_credit import \
        _frn_tensor as tf
    out = []
    for pkg, f in zip(PKGS, (jf, tf)):
        m = models[pkg]
        frn = _frns(pkg, m)[name]
        idx = m.curves[frn._floating_index.name]
        out.append(_tensor_fields(f(frn, m.value_dt,
                                    index_dc=idx._dc_type)))
    assert sorted(out[0]) == sorted(out[1])
    for k, a in out[0].items():
        np.testing.assert_array_equal(np.asarray(out[1][k]), np.asarray(a),
                                      err_msg=k)
    if name == "index_dc":
        assert not np.array_equal(out[1]["index_alphas"],
                                  out[1]["pay_alphas"])


@pytest.mark.parametrize("name", ["bullet", "amortizing"])
def test_bond_tensor(models, name):
    from adrates_tpu.market.position.engine_credit import _bond_tensor as jf
    from adrates_torch.market.position.engine_credit import \
        _bond_tensor as tf
    out = [_tensor_fields(f(_bonds(pkg, models[pkg])[name],
                            models[pkg].value_dt))
           for pkg, f in zip(PKGS, (jf, tf))]
    for k, a in out[0].items():
        np.testing.assert_array_equal(np.asarray(out[1][k]), np.asarray(a),
                                      err_msg=k)


def test_host_values(models):
    """FRN value (single and dual curve, with a discount margin), clean
    and dirty prices, accrued (also at a later settlement) and discount
    margin; bond value (with a z-spread, and settled later), clean and
    dirty prices, accrued, YTM and z-spread."""
    vals = []
    for pkg in PKGS:
        m = models[pkg]
        gbp, usd = m.curves["GBP_OIS_SONIA"], m.curves["USD_OIS_SOFR"]
        v = m.value_dt
        later = v.add_months(2).add_days(5)
        out = []
        for name, frn in _frns(pkg, m).items():
            disc = usd if name == "index_dc" else gbp
            out += [frn.value(v, disc, disc),
                    frn.value(v, disc, disc, discount_margin=0.003),
                    frn.clean_price(v, disc, disc),
                    frn.dirty_price(v, disc, disc, settlement_dt=later),
                    frn.accrued_interest(later)]
        frn = _frns(pkg, m)["plain"]
        out.append(frn.discount_margin(v, gbp, gbp, 99.4))
        for name, bond in _bonds(pkg, m).items():
            disc = usd if name == "bullet" else gbp
            clean = bond.clean_price(v, disc)
            out += [bond.value(v, disc), bond.value(v, disc, 0.002), clean,
                    bond.value(v, disc, settlement_dt=later),
                    bond.dirty_price(v, disc, 0.001),
                    bond.yield_to_maturity(v, clean - 0.5),
                    bond.z_spread(v, disc, clean - 0.5),
                    bond.accrued_interest(v), bond.accrued_interest(later)]
        vals.append(out)
    np.testing.assert_allclose(vals[1], vals[0], rtol=1e-12)


@pytest.mark.parametrize("method", ["g_spread", "i_spread"])
def test_bond_zero_rate_spreads_not_ported(models, method):
    """The spreads over a curve's zero rate at maturity (ported with the
    curves' rate queries; the name is kept from when they raised): equal
    to the JAX package's at rtol 1e-12."""
    vals = []
    for pkg in PKGS:
        m = models[pkg]
        bond = _bonds(pkg, m)["bullet"]
        vals.append(getattr(bond, method)(m.value_dt,
                                          m.curves["USD_OIS_SOFR"], 100.0))
    assert vals[1] == pytest.approx(vals[0], rel=1e-12)


# ---------------------------------------------------------------------------
# the credit book
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def books(models):
    """Per package (base, tiled) of the credit book with the FRNs and
    bonds above added, and the JAX tiled book's outputs."""
    out = {}
    for pkg in PKGS:
        m = models[pkg]
        trades = cases.credit_trades_for(pkg, m) \
            + list(_frns(pkg, m).values()) + list(_bonds(pkg, m).values())
        out[pkg] = cases.compile_tiled(pkg, m, trades)
    jt = out["adrates_tpu"][1]
    q0 = jt.basket.quotes0
    sh = cases.shocks(jt.basket.n_quotes)
    ref = {k: np.asarray(v)
           for k, v in jmb.make_multibook_fn(jt)(q0, sh).items()}
    return out, q0, sh, ref


@pytest.mark.parametrize("field", [f.name for f in
                                   dataclasses.fields(tmb.ClampSlots)])
def test_clamp_slots(books, field):
    out, *_ = books
    a = np.asarray(getattr(out["adrates_tpu"][0].clamp, field))
    b = getattr(out["adrates_torch"][0].clamp, field)
    assert b.shape[0] > 40
    np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("tiled", [False, True])
def test_aggregate(books, tiled):
    out, *_ = books
    ja, ta = out["adrates_tpu"][tiled].aggregate, \
        out["adrates_torch"][tiled].aggregate
    for f in ("trip_s", "trip_e", "trip_p"):
        np.testing.assert_array_equal(getattr(ta, f),
                                      np.asarray(getattr(ja, f)))
    for f in ("w_lin", "trip_w"):
        np.testing.assert_allclose(getattr(ta, f),
                                   np.asarray(getattr(ja, f)), rtol=1e-15,
                                   atol=0)


def test_column_tables(books):
    out, *_ = books
    jb, tb = out["adrates_tpu"][0], out["adrates_torch"][0]
    np.testing.assert_array_equal(jb.basket.grid_sel, tb.basket.grid_sel)
    assert len(jb.cols) == len(tb.cols)
    for a, b in zip(jb.cols, tb.cols):
        np.testing.assert_array_equal(b.col_idx, np.asarray(a.col_idx))
        np.testing.assert_array_equal(b.row_trade, np.asarray(a.row_trade))
        np.testing.assert_allclose(b.w, np.asarray(a.w), rtol=1e-15, atol=0)


@pytest.mark.parametrize("route", ["structured", "generic", "staged"])
def test_book_matches_jax(models, books, route):
    out, q0, sh, ref = books
    tiled = out["adrates_torch"][1]
    if route == "generic":
        m = models["adrates_torch"]
        trades = cases.credit_trades_for("adrates_torch", m) \
            + list(_frns("adrates_torch", m).values()) \
            + list(_bonds("adrates_torch", m).values())
        _, tiled = cases.compile_tiled("adrates_torch", m, trades,
                                       batch_curves=False)
        fn = tmb.make_multibook_fn(tiled, "cpu")
        assert not fn.structured
    elif route == "staged":
        fn = tmb.make_staged_multibook_fn(tiled, "cpu")
    else:
        fn = tmb.make_multibook_fn(tiled, "cpu")
    got = {k: v.numpy() for k, v in fn(q0, sh).items()}
    for k in ("pvs", "delta", "gamma"):
        np.testing.assert_allclose(got[k], ref[k], rtol=0,
                                   atol=1e-10 * np.abs(ref[k]).max(),
                                   err_msg=k)


def test_clamp_epilogue_moves_capped_trades(books):
    """The capped and floored FRNs' PVs come from the clamp epilogue: with
    the clamp slots dropped their PVs change, the others' do not."""
    out, q0, sh, _ = books
    base = out["adrates_torch"][0]
    fn = tmb.make_multibook_fn(base, "cpu")
    full = fn.pvs_only(q0, sh).numpy()
    bare = tmb.make_multibook_fn(dataclasses.replace(base, clamp=None),
                                 "cpu").pvs_only(q0, sh).numpy()
    clamped = np.unique(base.clamp.slot_trade)
    others = np.setdiff1d(np.arange(base.n_trades), clamped)
    assert np.abs(full[:, clamped] - bare[:, clamped]).min() > 1.0
    np.testing.assert_array_equal(full[:, others], bare[:, others])
