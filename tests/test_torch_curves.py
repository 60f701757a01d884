"""The port's ``DiscountCurve`` queries and ``Interpolator`` /
``InterpolatorAd`` against adrates_tpu's on the CPU, on all eight
interpolation schemes.

A curve from year offsets and DFs (the ``DiscountCurve`` constructor)
and an OIS curve bootstrapped through the refit gate, per scheme:
``df`` at dates (one and many, under two day counts), ``df_t``,
``df_ad``, ``survival_prob``, ``zero_rate`` under every compounding
frequency, ``cc_rate``, ``swap_rate`` (one maturity and several),
``fwd`` (one date and several), ``_fwd``, ``fwd_rate`` (to a tenor, a
date and a list of dates), ``_zero_to_df`` / ``_df_to_zero``, and
``bump``; the interpolator classes' fit and interpolate, the stateless
``simple_interpolate`` and the legacy module-level ``interpolate``.

Tolerance: rtol 1e-12 (host values; the rate queries divide DFs); the
forwards, which difference neighbouring DFs, absolute: the O/N ``fwd``
1e-12 (an ulp of a DF over 1/365), ``_fwd`` 1e-9 (over 2e-6)."""

import importlib

import numpy as np
import pytest

import adrates_tpu  # noqa: F401 — enables x64 for the JAX side

PKGS = ("adrates_tpu", "adrates_torch")
SCHEMES = ["FLAT_FWD_RATES", "LINEAR_ZERO_RATES", "LINEAR_FWD_RATES",
           "PCHIP_LOG_DISCOUNT", "PCHIP_ZERO_RATES", "NATCUBIC_LOG_DISCOUNT",
           "NATCUBIC_ZERO_RATES", "FINCUBIC_ZERO_RATES"]
OFFSETS = [0.25, 0.5, 1.0, 2.0, 3.0, 5.0, 7.0, 10.0, 20.0]
DFS = [0.9878, 0.9755, 0.952, 0.908, 0.868, 0.79, 0.72, 0.62, 0.38]


def _u(pkg):
    return importlib.import_module(f"{pkg}.utils")


def _curve(pkg, scheme, kind):
    u = _u(pkg)
    it = u.InterpTypes[scheme]
    if kind == "grid":
        dc = importlib.import_module(f"{pkg}.market.curves.discount_curve")
        return dc.DiscountCurve(u.Date(1, 1, 2024), OFFSETS, np.array(DFS),
                                it)
    models = importlib.import_module(f"{pkg}.models")
    m = models.Model(u.Date(1, 1, 2024))
    return m.build_curve("GBP_OIS_SONIA",
                         px_list=[5.0, 4.8, 4.6, 4.3, 4.0, 3.9, 3.87, 3.8],
                         tenor_list=["3M", "6M", "1Y", "2Y", "5Y", "7Y",
                                     "10Y", "20Y"],
                         fixed_dcc_type=u.DayCountTypes.ACT_365F,
                         float_dc_type=u.DayCountTypes.ACT_365F,
                         interp_type=it)


def _queries(pkg, curve):
    """Every query of the curve, as a flat list of floats."""
    u = _u(pkg)
    D, F = u.DayCountTypes, u.FrequencyTypes
    v = curve.value_dt()
    dates = [v.add_days(d) for d in (0, 1, 45, 200, 400, 900, 1500, 2600,
                                     3700, 5000, 8000, 11000)]
    out = list(np.atleast_1d(curve.df(dates)))
    out += list(np.atleast_1d(curve.df(dates, D.ACT_360)))
    out.append(curve.df(dates[5]))
    out += list(np.asarray(curve.df_t(np.array([0.0, 0.3, 4.4, 25.0]))))
    out += list(np.atleast_1d(np.asarray(curve.df_ad(np.array([0.7, 12.0])))))
    out.append(curve.survival_prob(dates[4]))
    for f in (F.CONTINUOUS, F.SIMPLE, F.ANNUAL, F.SEMI_ANNUAL, F.QUARTERLY,
              F.MONTHLY):
        out += list(np.atleast_1d(curve.zero_rate(dates[2:], f)))
        out.append(curve.zero_rate(dates[6], f, D.ACT_365F))
    out += list(np.atleast_1d(curve.cc_rate(dates[2:])))
    out.append(curve.swap_rate(v, dates[7]))
    out += list(curve.swap_rate(v.add_days(30), dates[6:], F.SEMI_ANNUAL,
                                D.ACT_360))
    out.append(curve.fwd_rate(dates[3], "6M"))
    out.append(curve.fwd_rate(dates[3], dates[8]))
    out += list(curve.fwd_rate(dates[2:5], dates[5:8], D.ACT_365F))
    out += list(np.atleast_1d(curve._zero_to_df(v, [0.03, 0.04],
                                                [1.0, 6.0], F.QUARTERLY,
                                                D.ACT_365F)))
    out += list(np.atleast_1d(curve._df_to_zero([0.97, 0.8], dates[6:8],
                                                F.ANNUAL, D.ACT_365F)))
    bumped = curve.bump(0.0007)
    out += list(np.atleast_1d(bumped.df(dates)))
    # the forwards difference neighbouring DFs: an ulp of a DF moves the
    # O/N forward by ~1e-13 and the central-difference one by ~1e-10
    on = [curve.fwd(dates[3])] + list(curve.fwd(dates[2:]))
    inst = list(np.atleast_1d(curve._fwd(np.array([0.5, 3.0, 17.0]))))
    return ([float(x) for x in out], [float(x) for x in on],
            [float(x) for x in inst])


@pytest.mark.parametrize("kind", ["grid", "ois"])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_discount_curve_queries_match_jax(scheme, kind):
    (vj, onj, inj), (vt, ont, intt) = (
        _queries(pkg, _curve(pkg, scheme, kind)) for pkg in PKGS)
    np.testing.assert_allclose(vt, vj, rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(ont, onj, rtol=0, atol=1e-12)
    np.testing.assert_allclose(intt, inj, rtol=0, atol=1e-9)


@pytest.mark.parametrize("cls", ["Interpolator", "InterpolatorAd"])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_interpolator_matches_jax(scheme, cls):
    times = np.array([0.0] + OFFSETS)
    dfs = np.array([1.0] + DFS)
    q = np.array([0.0, 0.1, 0.5, 1.7, 6.0, 10.0, 26.0])
    out = []
    for pkg in PKGS:
        mod = importlib.import_module(f"{pkg}.market.curves.interpolator")
        it = _u(pkg).InterpTypes[scheme]
        ip = getattr(mod, cls)(it)
        ip.fit(times, dfs)
        row = list(np.asarray(ip.interpolate(q)))
        if scheme in SCHEMES[:3]:
            row += list(np.asarray(ip.simple_interpolate(q, times, dfs,
                                                         it.value)))
            row += list(mod.interpolate(q[1:], times, dfs, it.value))
            row.append(mod.interpolate(2.5, times, dfs, it.value))
        out.append([float(x) for x in row])
    np.testing.assert_allclose(out[1], out[0], rtol=1e-12, atol=1e-15)


def test_interpolator_needs_a_fit():
    from adrates_torch.market.curves import Interpolator
    from adrates_torch.utils import InterpTypes, LibError
    with pytest.raises(LibError, match="Dfs have not been set"):
        Interpolator(InterpTypes.PCHIP_ZERO_RATES).interpolate([1.0])
