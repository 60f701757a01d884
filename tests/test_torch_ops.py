"""adrates_torch ops against adrates_tpu: the OIS bootstrap (values,
jacobian, Hessian), the static simple-scheme interpolation (values and
jacobian), and the port's curve build against the reference's pillar
DFs. Inputs are made with numpy and handed to both packages."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd, jacrev

import adrates_tpu  # noqa: F401 — enables x64 for the JAX side
from adrates_tpu.ops import bootstrap as jboot
from adrates_tpu.ops import interpolation as jinterp
from adrates_tpu.utils import InterpTypes as JInterp
from adrates_torch.ops import bootstrap as tboot
from adrates_torch.ops import interpolation as tinterp
from adrates_torch.utils import InterpTypes as TInterp

# the 13-pillar GBP SONIA curve of tests/test_reference_parity.py:28-41
TENORS = ["1M", "3M", "6M", "1Y", "18M", "2Y", "3Y", "5Y", "7Y", "10Y",
          "15Y", "20Y", "30Y"]
RATES = [5.19, 5.15, 5.04, 4.71, 4.51, 4.35, 4.13, 3.93, 3.87, 3.87, 3.91,
         3.88, 3.71]
REF_PILLAR_DFS = [
    1.0, 0.9956113995050311, 0.9873230426320679, 0.9754851234509831,
    0.9549009440700128, 0.9358559723843419, 0.9183977054813196,
    0.8859355786782549, 0.8253596224750342, 0.767530129527242,
    0.6847568691463398, 0.5622016404749532, 0.4678336310269053,
    0.34441753285475984]
SCHEMES = ["FLAT_FWD_RATES", "LINEAR_ZERO_RATES", "LINEAR_FWD_RATES"]


def _gbp_curve(pkg):
    if pkg == "jax":
        from adrates_tpu.models import Model
        from adrates_tpu.utils import Date, DayCountTypes
    else:
        from adrates_torch.models import Model
        from adrates_torch.utils import Date, DayCountTypes
    m = Model(Date(1, 1, 2024))
    return m.build_curve("GBP_OIS_SONIA", px_list=RATES, tenor_list=TENORS,
                         fixed_dcc_type=DayCountTypes.ACT_365F,
                         float_dc_type=DayCountTypes.ACT_365F)


@pytest.fixture(scope="module")
def gbp():
    return _gbp_curve("jax"), _gbp_curve("torch")


def test_port_curve_matches_reference_pillar_dfs(gbp):
    _, curve = gbp
    got = np.concatenate([[1.0], curve._repr_dfs])
    np.testing.assert_allclose(got, REF_PILLAR_DFS, rtol=0, atol=1e-12)


def test_plan_builder_matches_jax(gbp):
    jc, tc = gbp
    jp, tp = jc._plan, tc._plan
    for f in dataclasses.fields(tp):
        a, b = getattr(jp, f.name), getattr(tp, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(np.asarray(a), b, err_msg=f.name)
        else:
            assert a == b, f.name


def _rates_cases():
    rng = np.random.default_rng(11)
    base = np.asarray(RATES) / 100.0
    # the quoted curve, a shocked one, and one with a non-positive
    # pillar (the linear-space branch of the log-rate guard)
    neg = base.copy()
    neg[1] = -0.002
    return {"quoted": base,
            "shocked": base + rng.normal(0.0, 1e-3, base.shape),
            "nonpositive": neg}


@pytest.mark.parametrize("case", ["quoted", "shocked", "nonpositive"])
def test_bootstrap_values_jacobian_hessian(gbp, case):
    jc, _ = gbp
    plan = jc._plan
    r = _rates_cases()[case]
    tplan = tboot.plan_to_torch(tboot.OISBootstrapPlan(
        **{f.name: getattr(plan, f.name)
           for f in dataclasses.fields(tboot.OISBootstrapPlan)}), "cpu")

    def jf(x):
        return jboot.bootstrap_ois(x, plan)[1]

    def tf(x):
        return tboot.bootstrap_ois(x, tplan)[1]

    rj = jnp.asarray(r)
    rt = torch.tensor(r, dtype=torch.float64)
    np.testing.assert_allclose(tf(rt).numpy(), np.asarray(jf(rj)),
                               rtol=0, atol=1e-14)
    np.testing.assert_allclose(jacfwd(tf)(rt).numpy(),
                               np.asarray(jax.jacfwd(jf)(rj)),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(jacfwd(jacrev(tf))(rt).numpy(),
                               np.asarray(jax.hessian(jf)(rj)),
                               rtol=0, atol=1e-10)


def test_pillar_dfs_match_jax(gbp):
    jc, _ = gbp
    plan = jc._plan
    r = np.asarray(RATES) / 100.0
    ref = np.asarray(jboot.bootstrap_pillar_dfs(jnp.asarray(r), plan))
    got = tboot.bootstrap_pillar_dfs(
        torch.tensor(r, dtype=torch.float64),
        tboot.plan_to_torch(_gbp_curve("torch")._plan, "cpu"))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-14)


def _interp_case(scheme):
    rng = np.random.default_rng(5)
    x = np.concatenate([[0.0], np.sort(rng.uniform(0.05, 30.0, 14))])
    dfs = np.exp(-0.04 * x - 0.002 * x * np.sin(x))
    # queries inside, on knots, near knots, before/after the grid
    q = np.concatenate([rng.uniform(0.0, 32.0, 40), x[3:6],
                        x[7:9] + 5e-11, [0.0, 35.0, 1e-13]])
    return q, x, dfs


@pytest.mark.parametrize("scheme", SCHEMES)
def test_simple_interp_plan_matches_jax(scheme):
    q, x, _ = _interp_case(scheme)
    jp = jinterp.simple_interp_plan(q, x, JInterp[scheme])
    tp = tinterp.simple_interp_plan(q, x, TInterp[scheme])
    assert sorted(jp) == sorted(tp)
    for k in jp:
        np.testing.assert_array_equal(np.asarray(jp[k]), tp[k], err_msg=k)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_simple_df_static_values_and_jacobian(scheme):
    q, x, dfs = _interp_case(scheme)
    plan = jinterp.simple_interp_plan(q, x, JInterp[scheme])
    tplan = tinterp.plan_to_torch(plan, "cpu")

    def jf(d):
        return jinterp.simple_df_static(plan, d, JInterp[scheme])

    def tf(d):
        return tinterp.simple_df_static(tplan, d, TInterp[scheme])

    dj = jnp.asarray(dfs)
    dt = torch.tensor(dfs, dtype=torch.float64)
    np.testing.assert_allclose(tf(dt).numpy(), np.asarray(jf(dj)),
                               rtol=0, atol=1e-14)
    np.testing.assert_allclose(jacfwd(tf)(dt).numpy(),
                               np.asarray(jax.jacfwd(jf)(dj)),
                               rtol=0, atol=1e-14)


def test_unported_scheme_raises():
    from adrates_torch.utils import LibError
    with pytest.raises(LibError):
        tinterp.simple_interp_plan([1.0], [0.0, 2.0],
                                   TInterp.PCHIP_LOG_DISCOUNT)


REF_4Y_QUARTERLY_DIRECT = -256210.88509191805   # test_reference_parity.py


def _direct_swaps(pkg):
    if pkg == "jax":
        from adrates_tpu.trades.rates import OIS
        from adrates_tpu.utils import (BusDayAdjustTypes, CurrencyTypes,
                                       CurveTypes, Date, DayCountTypes,
                                       FrequencyTypes, SwapTypes)
    else:
        from adrates_torch.trades.rates import OIS
        from adrates_torch.utils import (BusDayAdjustTypes, CurrencyTypes,
                                         CurveTypes, Date, DayCountTypes,
                                         FrequencyTypes, SwapTypes)
    v = Date(1, 1, 2024)
    common = dict(floating_index=CurveTypes.GBP_OIS_SONIA,
                  currency=CurrencyTypes.GBP,
                  float_dc_type=DayCountTypes.ACT_365F)
    return [
        OIS(v, "4Y", SwapTypes.PAY, 0.0425, FrequencyTypes.QUARTERLY,
            DayCountTypes.ACT_365F, notional=25_000_000,
            float_freq_type=FrequencyTypes.QUARTERLY,
            bd_type=BusDayAdjustTypes.MODIFIED_FOLLOWING, **common),
        OIS(v.add_months(-5), "7Y", SwapTypes.RECEIVE, 0.04,
            FrequencyTypes.SEMI_ANNUAL, DayCountTypes.ACT_365F,
            notional=8e6, payment_lag=2, **common),
        OIS(v.add_months(3), "12Y", SwapTypes.PAY, 0.038,
            FrequencyTypes.ANNUAL, DayCountTypes.ACT_365F, notional=3e6,
            **common),
    ]


def test_direct_ois_value_matches_reference_and_jax(gbp):
    from adrates_torch.utils import Date
    jc, tc = gbp
    v = Date(1, 1, 2024)
    port = [s.value(v, tc, None) for s in _direct_swaps("torch")]
    assert port[0] == pytest.approx(REF_4Y_QUARTERLY_DIRECT, abs=2e-7)
    from adrates_tpu.utils import Date as JDate
    ref = [s.value(JDate(1, 1, 2024), jc, None)
           for s in _direct_swaps("jax")]
    np.testing.assert_allclose(port, ref, rtol=0, atol=1e-8)
