"""Shared builders for the adrates_torch parity tests: the same small OIS
model and book, built once through each package's own public API
(``pkg`` is "adrates_tpu" or "adrates_torch"), plus converters that hand
the JAX package's compiled state to the port as numpy."""

import dataclasses
import importlib

import numpy as np

SEED = 20240101


def _ns(pkg: str):
    utils = importlib.import_module(f"{pkg}.utils")
    models = importlib.import_module(f"{pkg}.models")
    rates = importlib.import_module(f"{pkg}.trades.rates")
    return utils, models.Model, rates.OIS


def build_model(pkg: str):
    """USD and GBP (FLAT_FWD, as tests/multibook_cases.py) plus a
    LINEAR_ZERO_RATES EUR curve, with the FX to USD."""
    u, Model, _ = _ns(pkg)
    m = Model(u.Date(1, 1, 2024))
    m.build_curve("USD_OIS_SOFR", px_list=[5.3, 5.0, 4.6, 4.0, 3.88],
                  tenor_list=["6M", "1Y", "2Y", "5Y", "10Y"],
                  fixed_dcc_type=u.DayCountTypes.ACT_360,
                  float_dc_type=u.DayCountTypes.ACT_360,
                  interp_type=u.InterpTypes.FLAT_FWD_RATES)
    m.build_curve("GBP_OIS_SONIA", px_list=[5.0, 4.7, 4.3, 3.9, 3.87],
                  tenor_list=["6M", "1Y", "2Y", "5Y", "10Y"],
                  fixed_dcc_type=u.DayCountTypes.ACT_365F,
                  float_dc_type=u.DayCountTypes.ACT_365F,
                  interp_type=u.InterpTypes.FLAT_FWD_RATES)
    m.build_curve("EUR_OIS_ESTR", px_list=[3.9, 3.7, 3.3, 2.9, 2.8, 2.7],
                  tenor_list=["3M", "1Y", "2Y", "5Y", "10Y", "20Y"],
                  fixed_dcc_type=u.DayCountTypes.ACT_360,
                  float_dc_type=u.DayCountTypes.ACT_360,
                  interp_type=u.InterpTypes.LINEAR_ZERO_RATES)
    m.build_fx(["GBPUSD", "EURUSD"], [1.27, 1.09])
    return m


def build_trades(pkg: str, model):
    """Eight OIS of mixed conventions: pay lags 0-2, FOLLOWING and
    MODIFIED_FOLLOWING, seasoned and forward-starting, annual,
    semi-annual and quarterly, one past the curve's last pillar."""
    u, _, OIS = _ns(pkg)
    v = model.value_dt
    D, F, C, S = (u.DayCountTypes, u.FrequencyTypes, u.CurveTypes,
                  u.SwapTypes)
    MF = u.BusDayAdjustTypes.MODIFIED_FOLLOWING
    FOL = u.BusDayAdjustTypes.FOLLOWING
    gbp = (C.GBP_OIS_SONIA, u.CurrencyTypes.GBP)
    usd = (C.USD_OIS_SOFR, u.CurrencyTypes.USD)
    eur = (C.EUR_OIS_ESTR, u.CurrencyTypes.EUR)
    specs = [
        (v, "5Y", S.RECEIVE, 0.039, F.ANNUAL, D.ACT_365F, gbp, 1e7,
         D.ACT_365F, 0, MF),
        (v.add_months(-7), "2Y", S.PAY, 0.045, F.QUARTERLY, D.ACT_360, usd,
         1.5e7, D.ACT_360, 2, MF),
        (v.add_months(5), "7Y", S.PAY, 0.03, F.SEMI_ANNUAL, D.ACT_360, eur,
         8e6, D.ACT_360, 1, MF),
        (v.add_months(-13).add_days(9), "10Y", S.RECEIVE, 0.041, F.ANNUAL,
         D.ACT_360, usd, 2.2e7, D.ACT_360, 0, FOL),
        (v.add_months(2).add_days(17), "3Y", S.PAY, 0.043, F.QUARTERLY,
         D.ACT_365F, gbp, 5e6, D.ACT_365F, 1, FOL),
        (v.add_months(-22), "15Y", S.RECEIVE, 0.028, F.ANNUAL,
         D.THIRTY_E_360, eur, 1.2e7, D.ACT_360, 0, MF),
        (v.add_months(14), "30Y", S.PAY, 0.036, F.SEMI_ANNUAL, D.ACT_360,
         usd, 3e6, D.ACT_360, 2, MF),
        (v.add_months(-6), "1Y", S.RECEIVE, 0.05, F.ANNUAL, D.ACT_365F,
         gbp, 9e6, D.ACT_365F, 0, FOL),
    ]
    return [OIS(st, ten, side, cpn, freq, fdc, idx, ccy, notional=nt,
                float_dc_type=ldc, payment_lag=lag, bd_type=bd)
            for st, ten, side, cpn, freq, fdc, (idx, ccy), nt, ldc, lag, bd
            in specs]


def compile_book(pkg: str, model, n_copies: int = 3):
    """(base book, book tiled x n_copies with seeded notional scales),
    priced in USD."""
    u, _, _ = _ns(pkg)
    mbmod = importlib.import_module(f"{pkg}.parallel.multibook")
    mb = mbmod.compile_multibook(build_trades(pkg, model), model,
                                 base_currency=u.CurrencyTypes.USD)
    scale = np.random.default_rng(SEED).uniform(0.5, 2.0, n_copies)
    return mb, mbmod.tile_multibook(mb, n_copies, notional_scale=scale)


def shocks(n_quotes: int, n_scen: int = 3) -> np.ndarray:
    return np.random.default_rng(SEED + 1).normal(0.0, 1e-3,
                                                  (n_scen, n_quotes))


def plan_fields(plan) -> dict:
    """A plan dataclass as a dict of numpy fields."""
    return {f.name: (np.asarray(getattr(plan, f.name))
                     if isinstance(getattr(plan, f.name), np.ndarray)
                     else getattr(plan, f.name))
            for f in dataclasses.fields(plan)}


def jax_book_numpy(mb) -> dict:
    """The JAX package's compiled (tiled) book as the numpy arguments of
    ``adrates_torch.interop.multibook_from_numpy``."""
    from adrates_tpu.parallel.multibook import (_term1_trip_groups,
                                                _trade_row_table)
    basket = mb.basket
    bat = basket.params["bat"]
    stages = basket._stages
    np_bat = {"gplan": {name: {k: np.asarray(v) for k, v in p.items()}
                        for name, p in bat["gplan"].items()}}
    for st in stages:
        b = bat[st.key]
        np_bat[st.key] = dict(plan=plan_fields(b["plan"]),
                              qidx=np.asarray(b["qidx"]),
                              pad_mask=np.asarray(b["pad_mask"]))
    basket_params = dict(
        interp=[s.interp_type.name for s in basket.specs],
        stages=[dict(kind=st.kind, ids=list(st.ids), key=st.key)
                for st in stages],
        bat=np_bat,
        grid_sel=None if basket._grid_dense else np.asarray(
            basket.grid_sel),
        n_quotes=basket.n_quotes)
    agg = mb.aggregate
    return dict(
        basket_params=basket_params,
        cols=[dict(col_idx=np.asarray(c.col_idx), w=np.asarray(c.w),
                   row_trade=np.asarray(c.row_trade)) for c in mb.cols],
        clamp=None if mb.clamp is None else {
            f.name: np.asarray(getattr(mb.clamp, f.name))
            for f in dataclasses.fields(mb.clamp)},
        aggregate={f.name: np.asarray(getattr(agg, f.name))
                   for f in dataclasses.fields(agg)},
        tri=np.asarray(_trade_row_table(mb)),
        groups=_term1_trip_groups(basket, agg),
        n_grid=basket.n_grid,
        tile=None if mb.tile is None else dict(
            scale=np.asarray(mb.tile.scale),
            base_trades=mb.tile.base_trades))
