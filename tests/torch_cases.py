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


def _np_plans(p):
    return {k: _np_plans(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in p.items()}


def jax_book_numpy(mb, structured: bool = True) -> dict:
    """The JAX package's compiled (tiled) book as the numpy arguments of
    ``adrates_torch.interop.multibook_from_numpy``."""
    from adrates_tpu.parallel.multibook import _term1_trip_groups
    basket = mb.basket
    bat = basket.params["bat"]
    stages = basket._stages

    def name(it):
        return None if it is None else it.name

    np_bat = {"gplan": _np_plans(bat["gplan"])}
    for st in stages:
        b = bat[st.key]
        d = dict(qidx=np.asarray(b["qidx"]),
                 pad_mask=np.asarray(b["pad_mask"]),
                 ts_static=np.asarray(b["ts_static"]),
                 row_plan=_np_plans(b["row_plan"]),
                 row_plan_keep=(_np_plans(b["row_plan_keep"])
                                if "row_plan_keep" in b else None))
        if st.kind == "infl":
            d["swap_times"] = np.asarray(b["swap_times"])
        else:
            d["plan"] = plan_fields(b["plan"])
        if st.kind == "xccy":
            d.update(legs=plan_fields(b["legs"]),
                     spot_fx=np.asarray(b["spot_fx"]),
                     pv_dom0=np.asarray(b["pv_dom0"]),
                     dom_ts=np.asarray(b["dom_ts"]),
                     for_ts=np.asarray(b["for_ts"]),
                     fboot_plan=_np_plans(b["fboot_plan"]),
                     legs_plan=_np_plans(b["legs_plan"]))
        np_bat[st.key] = d
    dense = basket._grid_dense
    basket_params = dict(
        specs=[dict(name=s.name, kind=s.kind, interp=s.interp_type.name,
                    n_quotes=s.n_quotes, offset=s.offset, dom_id=s.dom_id,
                    for_id=s.for_id,
                    foreign_interp=name(s.foreign_interp_type))
               for s in basket.specs],
        stages=[dict(kind=st.kind, ids=list(st.ids), key=st.key,
                     dom_ids=st.dom_ids, for_ids=st.for_ids,
                     dom_interp=name(st.dom_interp),
                     foreign_interp=name(st.foreign_interp),
                     recal=st.recal)
                for st in stages],
        bat=np_bat,
        unique_times=np.asarray(basket.params["unique_times"]),
        n_quotes=basket.n_quotes,
        grid=dict(sel=None if dense else np.asarray(basket.grid_sel),
                  keep_of=None if dense else [np.asarray(k) for k in
                                              basket.grid_keep_of],
                  offsets=None if dense else np.asarray(basket.grid_offsets),
                  inv=None if dense else np.asarray(basket.grid_inv)),
        structured=structured)
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
        n_trades=mb.n_trades,
        groups=_term1_trip_groups(basket, agg),
        n_grid=basket.n_grid,
        tile=None if mb.tile is None else dict(
            scale=np.asarray(mb.tile.scale),
            base_trades=mb.tile.base_trades))


def build_xccy_model(pkg: str):
    """USD and GBP OIS (FLAT_FWD) plus GBP_USD_XCCY over them, as
    tests/multibook_cases.py:build_model, and the 6-pillar
    LINEAR_ZERO_RATES EUR curve of build_model, which shares the OIS
    stage: its sixth quote slot pads the 5-pillar USD and GBP members, so
    the XCCY curve's composed parent directions carry group-pad
    duplicates; with the FX to USD."""
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
    m.build_xccy_curve(name="GBP_USD_XCCY",
                       domestic_curve_name="USD_OIS_SOFR",
                       foreign_curve_name="GBP_OIS_SONIA",
                       basis_spreads=[-5.0, -8.0, -11.0],
                       tenor_list=["1Y", "5Y", "10Y"], spot_fx=1.27)
    m.build_curve("EUR_OIS_ESTR", px_list=[3.9, 3.7, 3.3, 2.9, 2.8, 2.7],
                  tenor_list=["3M", "1Y", "2Y", "5Y", "10Y", "20Y"],
                  fixed_dcc_type=u.DayCountTypes.ACT_360,
                  float_dc_type=u.DayCountTypes.ACT_360,
                  interp_type=u.InterpTypes.LINEAR_ZERO_RATES)
    m.build_fx(["GBPUSD", "EURUSD"], [1.27, 1.09])
    return m


def build_xccy_trades(pkg: str, model):
    """(trades, collateral_types): a GBP, a USD and a EUR OIS, one
    GBP/USD basis swap starting forward, and a seasoned GBP OIS under USD
    collateral (discounted on GBP_USD_XCCY)."""
    u, _, OIS = _ns(pkg)
    rates = importlib.import_module(f"{pkg}.trades.rates")
    v = model.value_dt
    D, F, C, S = (u.DayCountTypes, u.FrequencyTypes, u.CurveTypes,
                  u.SwapTypes)
    MF = u.BusDayAdjustTypes.MODIFIED_FOLLOWING
    gbp = OIS(v, "5Y", S.RECEIVE, 0.039, F.ANNUAL, D.ACT_365F,
              C.GBP_OIS_SONIA, u.CurrencyTypes.GBP, notional=1e7,
              float_dc_type=D.ACT_365F, bd_type=MF)
    usd = OIS(v.add_months(-5), "2Y", S.PAY, 0.045, F.QUARTERLY, D.ACT_360,
              C.USD_OIS_SOFR, u.CurrencyTypes.USD, notional=1.5e7,
              float_dc_type=D.ACT_360, payment_lag=1, bd_type=MF)
    xccy = rates.XccyBasisSwap(
        effective_dt=v.add_months(3).add_days(5), term_dt_or_tenor="5Y",
        domestic_notional=12_700_000, foreign_notional=10_000_000,
        domestic_spread=0.0, foreign_spread=-0.0008,
        domestic_freq_type=F.QUARTERLY, foreign_freq_type=F.QUARTERLY,
        domestic_dc_type=D.ACT_360, foreign_dc_type=D.ACT_365F,
        domestic_floating_index=C.USD_OIS_SOFR,
        foreign_floating_index=C.GBP_OIS_SONIA,
        domestic_currency=u.CurrencyTypes.USD,
        foreign_currency=u.CurrencyTypes.GBP)
    coll = OIS(v.add_months(-7), "7Y", S.PAY, 0.041, F.ANNUAL, D.ACT_365F,
               C.GBP_OIS_SONIA, u.CurrencyTypes.GBP, notional=8e6,
               float_dc_type=D.ACT_365F, bd_type=MF)
    eur = OIS(v.add_months(2), "7Y", S.RECEIVE, 0.031, F.SEMI_ANNUAL,
              D.ACT_360, C.EUR_OIS_ESTR, u.CurrencyTypes.EUR, notional=6e6,
              float_dc_type=D.ACT_360, bd_type=MF)
    return [gbp, usd, xccy, coll, eur], \
        [None, None, None, u.CollateralType.USD, None]


def compile_xccy_book(pkg: str, model, n_copies: int = 2, **kw):
    """The XCCY book in USD, tiled x n_copies with seeded notional
    scales; ``kw`` goes to compile_multibook (recalibrate_xccy,
    batch_curves, ...)."""
    u, _, _ = _ns(pkg)
    mbmod = importlib.import_module(f"{pkg}.parallel.multibook")
    trades, coll = build_xccy_trades(pkg, model)
    mb = mbmod.compile_multibook(trades, model,
                                 base_currency=u.CurrencyTypes.USD,
                                 collateral_types=coll, **kw)
    scale = np.random.default_rng(SEED + 2).uniform(0.5, 2.0, n_copies)
    return mbmod.tile_multibook(mb, n_copies, notional_scale=scale)


def xccy3_book(pkg: str, ois_scheme: str, xccy_scheme: str,
               n_spreads: int = 5, **kw):
    """A book whose one XCCY stage has three members: GBP_, EUR_ and
    JPY_USD_XCCY (``n_spreads`` basis quotes each, on ``xccy_scheme``)
    over USD, GBP, EUR and JPY OIS curves on ``ois_scheme`` (scheme
    names); an OIS on each OIS curve and a GBP, EUR and JPY OIS under USD
    collateral (discounted on the XCCY curves), in USD; ``kw`` goes to
    compile_multibook (recalibrate_xccy, ...)."""
    u, Model, OIS = _ns(pkg)
    mbmod = importlib.import_module(f"{pkg}.parallel.multibook")
    it = getattr(u.InterpTypes, ois_scheme)
    m = Model(u.Date(1, 1, 2024))
    D, F, C, S = (u.DayCountTypes, u.FrequencyTypes, u.CurveTypes,
                  u.SwapTypes)
    curves = [("USD_OIS_SOFR", [5.3, 5.0, 4.6, 4.0, 3.88], D.ACT_360, 0.0),
              ("GBP_OIS_SONIA", [5.0, 4.7, 4.3, 3.9, 3.87], D.ACT_365F,
               1.27),
              ("EUR_OIS_ESTR", [3.9, 3.7, 3.3, 2.9, 2.8], D.ACT_360, 1.09),
              ("JPY_OIS_TONAR", [0.1, 0.2, 0.4, 0.7, 0.9], D.ACT_365F,
               0.0069)]
    for name, px, dc, _ in curves:
        m.build_curve(name, px_list=px,
                      tenor_list=["6M", "1Y", "2Y", "5Y", "10Y"],
                      fixed_dcc_type=dc, float_dc_type=dc, interp_type=it)
    m.build_fx(["GBPUSD", "EURUSD", "JPYUSD"], [1.27, 1.09, 0.0069])
    tenors = ["1Y", "2Y", "3Y", "5Y", "7Y", "10Y", "15Y"][:n_spreads]
    for k, (name, _, _, fx) in enumerate(curves[1:]):
        ccy = name[:3]
        m.build_xccy_curve(
            name=f"{ccy}_USD_XCCY", domestic_curve_name="USD_OIS_SOFR",
            foreign_curve_name=name, spot_fx=fx,
            basis_spreads=[-5.0 - 7.0 * k - 1.5 * i
                           for i in range(n_spreads)],
            tenor_list=tenors,
            interp_type=getattr(u.InterpTypes, xccy_scheme))
    v = m.value_dt
    trades, coll = [], []
    for k, (name, _, dc, _) in enumerate(curves):
        ccy = getattr(u.CurrencyTypes, name[:3])
        for coll_t in ([None] if k == 0 else [None, u.CollateralType.USD]):
            trades.append(OIS(v.add_months(k), f"{4 + 2 * k}Y",
                              S.PAY if k % 2 else S.RECEIVE,
                              0.01 + 0.008 * k, F.ANNUAL, dc,
                              getattr(C, name), ccy, notional=1e7,
                              float_dc_type=dc))
            coll.append(coll_t)
    return mbmod.compile_multibook(trades, m,
                                   base_currency=u.CurrencyTypes.USD,
                                   collateral_types=coll, **kw)


def trade_slot_weights(jax_mb, port_mb):
    """([B, M], [B, M]): each trade's (column, weight) slots over the value
    table, densely, from the JAX package's trade row table over its
    expanded column buckets, and from the port's per-trade CSR (K1's
    tables) over its own."""
    from adrates_tpu.parallel.multibook import _trade_row_table
    from adrates_torch.parallel import multibook as tmb
    mb = jax_mb
    n = 1 if mb.tile is None else int(mb.tile.scale.shape[0])
    scale = np.ones(1) if mb.tile is None else np.asarray(mb.tile.scale)
    M = mb.basket.n_grid + int(mb.aggregate.trip_s.shape[0])
    tri = np.asarray(_trade_row_table(mb))
    R_total = sum(int(c.col_idx.shape[0]) for c in mb.cols) * n
    owner = np.full(R_total + 1, -1)
    owner[tri] = np.arange(mb.n_trades)[:, None]
    jax_w = np.zeros((mb.n_trades, M))
    off = 0
    for c in mb.cols:
        ci = np.tile(np.asarray(c.col_idx), (n, 1))
        w = (scale[:, None, None] * np.asarray(c.w)[None]).reshape(ci.shape)
        rows = owner[off:off + ci.shape[0]]
        np.add.at(jax_w, (np.broadcast_to(rows[:, None], ci.shape), ci), w)
        off += ci.shape[0]
    inp = tmb.book_inputs(port_mb)
    tab = tmb.sweep_tables_from_cols(tmb.expanded_cols(inp, "cpu"),
                                     inp.n_trades, M)
    port_w = np.zeros((inp.n_trades, M))
    port_w[tab.slot_trade().numpy(), tab.slot_col().numpy()] = \
        tab.slot_w.numpy()
    return jax_w, port_w


def build_credit_model(pkg: str, schemes=None, xccy_freq="ANNUAL"):
    """tests/multibook_cases.py:build_model through ``pkg``: USD and GBP
    OIS (FLAT_FWD), GBP_USD_XCCY over them, GBPUSD. ``schemes`` maps a
    curve's name to the name of another interpolation scheme; the two OIS
    curves have the same pillars and points, so neither pads the other in
    their stage. ``xccy_freq`` is the XCCY curve's calibration legs'
    frequency (both legs)."""
    u, Model, _ = _ns(pkg)
    schemes = schemes or {}
    freq = getattr(u.FrequencyTypes, xccy_freq)

    def it(name):
        return u.InterpTypes[schemes.get(name, "FLAT_FWD_RATES")]
    m = Model(u.Date(1, 1, 2024))
    m.build_curve("USD_OIS_SOFR", px_list=[5.3, 5.0, 4.6, 4.0, 3.88],
                  tenor_list=["6M", "1Y", "2Y", "5Y", "10Y"],
                  fixed_dcc_type=u.DayCountTypes.ACT_360,
                  float_dc_type=u.DayCountTypes.ACT_360,
                  interp_type=it("USD_OIS_SOFR"))
    m.build_curve("GBP_OIS_SONIA", px_list=[5.0, 4.7, 4.3, 3.9, 3.87],
                  tenor_list=["6M", "1Y", "2Y", "5Y", "10Y"],
                  fixed_dcc_type=u.DayCountTypes.ACT_365F,
                  float_dc_type=u.DayCountTypes.ACT_365F,
                  interp_type=it("GBP_OIS_SONIA"))
    m.build_xccy_curve(name="GBP_USD_XCCY",
                       domestic_curve_name="USD_OIS_SOFR",
                       foreign_curve_name="GBP_OIS_SONIA",
                       basis_spreads=[-5.0, -8.0, -11.0],
                       tenor_list=["1Y", "5Y", "10Y"], spot_fx=1.27,
                       domestic_freq_type=freq, foreign_freq_type=freq,
                       interp_type=it("GBP_USD_XCCY"))
    m.build_fx(["GBPUSD"], [1.27])
    return m


def credit_trades_for(pkg: str, model):
    """tests/multibook_cases.py:trades_for through ``pkg``: a GBP and a
    USD OIS, a basis swap, a plain and a capped/floored GBP FRN and a
    7Y bond."""
    u, _, OIS = _ns(pkg)
    rates = importlib.import_module(f"{pkg}.trades.rates")
    credit = importlib.import_module(f"{pkg}.trades.credit")
    v = model.value_dt
    D, F, C, S = (u.DayCountTypes, u.FrequencyTypes, u.CurveTypes,
                  u.SwapTypes)
    MF = u.BusDayAdjustTypes.MODIFIED_FOLLOWING
    gbp_ois = OIS(v, "5Y", S.RECEIVE, 0.039, F.ANNUAL, D.ACT_365F,
                  C.GBP_OIS_SONIA, u.CurrencyTypes.GBP, notional=10_000_000,
                  float_dc_type=D.ACT_365F, bd_type=MF)
    usd_ois = OIS(v, "2Y", S.PAY, 0.045, F.QUARTERLY, D.ACT_360,
                  C.USD_OIS_SOFR, u.CurrencyTypes.USD, notional=15_000_000,
                  float_dc_type=D.ACT_360, bd_type=MF)
    xccy = rates.XccyBasisSwap(
        effective_dt=v, term_dt_or_tenor="5Y",
        domestic_notional=12_700_000, foreign_notional=10_000_000,
        domestic_spread=0.0, foreign_spread=-0.0008,
        domestic_freq_type=F.QUARTERLY, foreign_freq_type=F.QUARTERLY,
        domestic_dc_type=D.ACT_360, foreign_dc_type=D.ACT_365F,
        domestic_floating_index=C.USD_OIS_SOFR,
        foreign_floating_index=C.GBP_OIS_SONIA,
        domestic_currency=u.CurrencyTypes.USD,
        foreign_currency=u.CurrencyTypes.GBP)
    frn = dict(freq_type=F.QUARTERLY, dc_type=D.ACT_365F,
               floating_index=C.GBP_OIS_SONIA, currency=u.CurrencyTypes.GBP,
               face_value=5_000_000)
    frn_plain = credit.FRN(v, "5Y", quoted_margin=0.0015, **frn)
    frn_capped = credit.FRN(v, "5Y", quoted_margin=0.0015, cap_rate=0.045,
                            floor_rate=0.02, **frn)
    bond = credit.Bond(v, "7Y", coupon=0.04, freq_type=F.SEMI_ANNUAL,
                       dc_type=D.ACT_365F, currency=u.CurrencyTypes.GBP,
                       face_value=1_000_000)
    return [gbp_ois, usd_ois, xccy, frn_plain, frn_capped, bond]


def fixed_xccy_trades(pkg: str, model):
    """On build_credit_model: fix-float swaps starting today (t = 0
    exchange), forward and seasoned (past exchange), paying and receiving
    the fixed leg; fix-fix swaps starting today and forward."""
    u = importlib.import_module(f"{pkg}.utils")
    rates = importlib.import_module(f"{pkg}.trades.rates")
    v = model.value_dt
    D, F, C, S, Y = (u.DayCountTypes, u.FrequencyTypes, u.CurveTypes,
                     u.SwapTypes, u.CurrencyTypes)
    pair = dict(domestic_floating_index=C.USD_OIS_SOFR,
                foreign_floating_index=C.GBP_OIS_SONIA,
                domestic_currency=Y.USD, foreign_currency=Y.GBP)
    fix_float = [rates.XccyFixFloat(
        effective_dt=st, term_dt_or_tenor=ten, domestic_notional=dn,
        foreign_notional=dn / 1.27, domestic_leg_type=side,
        domestic_coupon=cpn, foreign_spread=spr,
        domestic_freq_type=F.SEMI_ANNUAL, foreign_freq_type=F.QUARTERLY,
        domestic_dc_type=D.ACT_360, foreign_dc_type=D.ACT_365F, **pair)
        for st, ten, dn, side, cpn, spr in [
            (v, "5Y", 2.0e7, S.RECEIVE, 0.041, -0.0011),
            (v.add_months(3).add_days(5), "7Y", 1.3e7, S.PAY, 0.037, -0.0004),
            (v.add_months(-8), "3Y", 9.0e6, S.PAY, 0.046, -0.0015)]]
    fix_fix = [rates.XccyFixFix(
        effective_dt=st, term_dt_or_tenor=ten, domestic_notional=dn,
        foreign_notional=dn / 1.27, domestic_leg_type=S.RECEIVE,
        domestic_coupon=dc, foreign_coupon=fc,
        domestic_freq_type=F.ANNUAL, foreign_freq_type=F.ANNUAL,
        domestic_dc_type=D.ACT_360, foreign_dc_type=D.ACT_365F, **pair)
        for st, ten, dn, dc, fc in [
            (v, "10Y", 1.7e7, 0.039, 0.042),
            (v.add_months(9).add_days(13), "5Y", 6.0e6, 0.044, 0.036)]]
    return fix_float + fix_fix


def build_infl_model(pkg: str, **infl_kw):
    """tests/multibook_cases.py:build_model_infl through ``pkg``: the GBP
    OIS curve and a 5-pillar GBP_RPI_INFLATION curve (base CPI 293);
    ``infl_kw`` goes to build_inflation_curve (seasonality, fixings)."""
    u, Model, _ = _ns(pkg)
    m = Model(u.Date(1, 1, 2024))
    m.build_curve("GBP_OIS_SONIA", px_list=[5.0, 4.7, 4.3, 3.9, 3.87],
                  tenor_list=["6M", "1Y", "2Y", "5Y", "10Y"],
                  fixed_dcc_type=u.DayCountTypes.ACT_365F,
                  float_dc_type=u.DayCountTypes.ACT_365F,
                  interp_type=u.InterpTypes.FLAT_FWD_RATES)
    m.build_inflation_curve("GBP_RPI_INFLATION",
                            breakeven_list=[3.8, 3.5, 3.4, 3.5, 3.3],
                            tenor_list=["1Y", "3Y", "5Y", "10Y", "30Y"],
                            base_cpi=293.0, **infl_kw)
    return m


def infl_trades_for(pkg: str, model):
    """tests/multibook_cases.py:infl_trades_for through ``pkg``: a 5Y ZCIS,
    a 4Y annual YoY swap with a spread and a 5Y GBP OIS."""
    u, _, OIS = _ns(pkg)
    rates = importlib.import_module(f"{pkg}.trades.rates")
    v = model.value_dt
    D, F, C, S = (u.DayCountTypes, u.FrequencyTypes, u.CurveTypes,
                  u.SwapTypes)
    index = model.curves["GBP_RPI_INFLATION"]._used_swaps[0] \
        ._inflation_index
    zcis = rates.ZeroCouponInflationSwap(
        effective_dt=v, term_dt_or_tenor="5Y", fixed_leg_type=S.PAY,
        fixed_rate=0.033, inflation_index=index, notional=7_000_000)
    yoy = rates.YoYInflationSwap(
        effective_dt=v, term_dt_or_tenor="4Y", fixed_leg_type=S.RECEIVE,
        fixed_rate=0.034, inflation_index=index, freq_type=F.ANNUAL,
        notional=5_000_000, inflation_spread=0.0007)
    ois = OIS(v, "5Y", S.RECEIVE, 0.039, F.ANNUAL, D.ACT_365F,
              C.GBP_OIS_SONIA, u.CurrencyTypes.GBP, notional=10_000_000,
              float_dc_type=D.ACT_365F,
              bd_type=u.BusDayAdjustTypes.MODIFIED_FOLLOWING)
    return [zcis, yoy, ois]


def compile_tiled(pkg: str, model, trades, n_copies: int = 2, seed=SEED + 3,
                  **kw):
    """``trades`` compiled in ``pkg`` (base GBP unless ``kw`` says
    otherwise) and tiled x n_copies with seeded notional scales."""
    mbmod = importlib.import_module(f"{pkg}.parallel.multibook")
    mb = mbmod.compile_multibook(trades, model, **kw)
    scale = np.random.default_rng(seed).uniform(0.5, 2.0, n_copies)
    return mb, mbmod.tile_multibook(mb, n_copies, notional_scale=scale)


def build_all_kinds_model(pkg: str, schemes=None):
    """build_credit_model (``schemes`` as there) plus the GBP RPI curve of
    build_infl_model: a model for every instrument kind of the book
    compiler."""
    m = build_credit_model(pkg, schemes)
    m.build_inflation_curve("GBP_RPI_INFLATION",
                            breakeven_list=[3.8, 3.5, 3.4, 3.5, 3.3],
                            tenor_list=["1Y", "3Y", "5Y", "10Y", "30Y"],
                            base_cpi=293.0)
    return m


def all_kinds_trades(pkg: str, model):
    """OIS, a basis swap, FRNs (plain and capped), a bond, fix-float and
    fix-fix XCCY swaps, a ZCIS and a YoY swap."""
    return credit_trades_for(pkg, model) + fixed_xccy_trades(pkg, model) \
        + infl_trades_for(pkg, model)[:2]


# two scheme maps for build_all_kinds_model that together cover the five
# fitted schemes; the XCCY curve of the first is recalibrated in-graph,
# the second's held as values (spline_book)
SPLINE_SCHEMES = {
    "a_recal": {"USD_OIS_SOFR": "NATCUBIC_ZERO_RATES",
                "GBP_OIS_SONIA": "PCHIP_LOG_DISCOUNT",
                "GBP_USD_XCCY": "PCHIP_ZERO_RATES"},
    "b_held": {"USD_OIS_SOFR": "PCHIP_ZERO_RATES",
               "GBP_OIS_SONIA": "NATCUBIC_LOG_DISCOUNT",
               "GBP_USD_XCCY": "FINCUBIC_ZERO_RATES"},
}


def spline_book(pkg: str, name: str, **kw):
    """(model, tiled book): the all-kinds trades on build_all_kinds_model
    with the scheme map SPLINE_SCHEMES[name], in USD, tiled x2; ``kw``
    goes to compile_multibook."""
    u = importlib.import_module(f"{pkg}.utils")
    m = build_all_kinds_model(pkg, SPLINE_SCHEMES[name])
    return m, compile_tiled(pkg, m, all_kinds_trades(pkg, m),
                            base_currency=u.CurrencyTypes.USD,
                            recalibrate_xccy=name.endswith("recal"),
                            **kw)[1]


# a scheme map for build_credit_model with the XCCY curve's two parents on
# fitted schemes and the XCCY curve itself simple, so that its stage takes
# K8-K11 through its parents' query grids: USD (the domestic parent)
# PCHIP_ZERO_RATES, GBP (the foreign parent) NATCUBIC_LOG_DISCOUNT
XCCY_FITTED_PARENTS = {"USD_OIS_SOFR": "PCHIP_ZERO_RATES",
                       "GBP_OIS_SONIA": "NATCUBIC_LOG_DISCOUNT",
                       "GBP_USD_XCCY": "FLAT_FWD_RATES"}


def fitted_parent_book(pkg: str, recal: bool, n_copies: int = 2):
    """(model, tiled book): the credit trades (OIS, a basis swap, FRNs, a
    bond) on build_credit_model with the scheme map XCCY_FITTED_PARENTS
    and quarterly calibration legs (their queries fall between the
    parents' annual knots), in USD, tiled x ``n_copies``; the XCCY curve
    recalibrated in-graph (``recal``) or held as values. The two OIS
    curves share one stage unpadded, so the JAX package's batched path
    fits each on its own knots."""
    u = importlib.import_module(f"{pkg}.utils")
    m = build_credit_model(pkg, XCCY_FITTED_PARENTS, xccy_freq="QUARTERLY")
    return m, compile_tiled(pkg, m, credit_trades_for(pkg, m), n_copies,
                            base_currency=u.CurrencyTypes.USD,
                            recalibrate_xccy=recal)[1]


PERTRADE_BOOKS = ["ois", "xccy_recal", "xccy_held", "credit", "infl",
                  "all_kinds"]


def pertrade_book(pkg: str, name: str):
    """The tiled book ``name`` (one of PERTRADE_BOOKS) of the per-trade
    tests, compiled through ``pkg``."""
    if name == "ois":
        return compile_book(pkg, build_model(pkg))[1]
    if name.startswith("xccy"):
        return compile_xccy_book(pkg, build_xccy_model(pkg),
                                 recalibrate_xccy=name == "xccy_recal")
    if name == "credit":
        m = build_credit_model(pkg)
        return compile_tiled(pkg, m, credit_trades_for(pkg, m),
                             n_copies=3)[1]
    if name == "infl":
        m = build_infl_model(pkg)
        return compile_tiled(pkg, m, infl_trades_for(pkg, m))[1]
    m = build_all_kinds_model(pkg)
    usd = importlib.import_module(f"{pkg}.utils").CurrencyTypes.USD
    return compile_tiled(pkg, m, all_kinds_trades(pkg, m),
                         base_currency=usd)[1]


def pertrade_selection(mb) -> list:
    """A base trade in two copies (a capped/floored FRN where the book
    has clamp slots), then the first and last base trades of the last
    copy."""
    B = mb.tile.base_trades
    t = int(np.asarray(mb.clamp.slot_trade)[0]) if mb.clamp is not None \
        else 1
    last = mb.n_trades - B
    return [t, B + t, last, mb.n_trades - 1]


# ---------------------------------------------------------------------------
# the single-trade engine: results of both packages as comparable arrays


def result_parts(res) -> dict:
    """An ``AnalyticsResult`` as {kind: {name: numpy array}}: the PV; each
    delta ladder, gamma matrix and cross-gamma by curve name; the speed
    cube; the cashflow report's numeric columns."""
    out = {}
    if res.value is not None:
        out["value"] = {"pv": np.array([res.value.amount])}

    def blocks(obj):
        if obj is None:
            return None
        if hasattr(obj, "_by_curve"):
            d = {n: l.risk_ladder for n, l in obj._by_curve.items()}
            d.update({f"{a} x {b}": cg.risk_matrix
                      for (a, b), cg in obj._cross_gammas.items()})
            return d
        return {obj.curve_type.name: obj.risk_ladder}

    for kind, obj in (("delta", res.risk), ("gamma", res.gamma)):
        b = blocks(obj)
        if b is not None:
            out[kind] = b
    if res.speed is not None:
        out["speed"] = {res.speed.curve_type.name: res.speed.risk_cube}
    if res.cashflows is not None:
        cols = ("notional", "payment_fraction", "accrual_period", "amount",
                "discount_factor", "discounted_amount")
        out["cashflows"] = {c: np.array([getattr(cf, c)
                                         for cf in res.cashflows])
                            for c in cols}
    return out


def result_labels(res) -> dict:
    """The non-numeric parts of an ``AnalyticsResult``: currencies, curve
    types, tenor labels, cashflow dates and leg tags, as plain values."""
    out = {}
    if res.value is not None:
        out["value"] = res.value.currency.name
    for kind, obj in (("delta", res.risk), ("gamma", res.gamma),
                      ("speed", res.speed)):
        if obj is None:
            continue
        ls = obj._by_curve.values() if hasattr(obj, "_by_curve") else [obj]
        out[kind] = [(l.curve_type.name, l.currency.name, list(l.tenors))
                     for l in ls]
        if hasattr(obj, "_cross_gammas"):
            out[kind + "_cross"] = [
                (a, b, cg.currency.name, list(cg.tenors_curve1),
                 list(cg.tenors_curve2))
                for (a, b), cg in obj._cross_gammas.items()]
    if res.cashflows is not None:
        out["cashflows"] = [(str(cf.payment_date), cf.leg_type)
                            for cf in res.cashflows]
        out["cashflows_ccy"] = res.cashflows.currency.name
    return out


def assert_parts_close(ref: dict, got: dict, rel: float = 1e-10):
    """Every array of ``got`` equals ``ref``'s within ``rel`` x the largest
    |entry| of its kind in ``ref`` (cashflows: of its column); a PV within
    1e-8 as well, the rounding of a sum of flows of 1e7 notional, so that
    a par swap's PV of ~0 compares."""
    assert set(got) == set(ref)
    for kind, blocks in ref.items():
        assert set(got[kind]) == set(blocks), kind
        if kind == "cashflows":
            for name, r in blocks.items():
                scale = max(float(np.abs(r).max()), 1e-300) if r.size else 1
                np.testing.assert_allclose(got[kind][name], r, rtol=0,
                                           atol=rel * scale,
                                           err_msg=f"{kind} {name}")
            continue
        scale = max(float(np.abs(r).max()) for r in blocks.values())
        atol = max(rel * scale, 1e-8 if kind == "value" else 1e-300)
        for name, r in blocks.items():
            np.testing.assert_allclose(got[kind][name], r, rtol=0,
                                       atol=atol, err_msg=f"{kind} {name}")


ENGINE_ROUTES = ["xccy_basis", "xccy_fix_float", "xccy_fix_fix", "zcis", "yoy",
                 "bond", "bond_amortizing", "frn", "frn_capped", "frn_dual"]


def engine_route(pkg, model, route):
    """(trade, requests) of an engine ``route`` (one of ENGINE_ROUTES) on
    build_all_kinds_model, built through ``pkg``: VALUE, DELTA, GAMMA and
    CASHFLOWS (the ZCIS route reports no cashflows)."""
    u = importlib.import_module(f"{pkg}.utils")
    credit = importlib.import_module(f"{pkg}.trades.credit")
    R = u.RequestTypes
    reqs = [R.VALUE, R.DELTA, R.GAMMA, R.CASHFLOWS]
    kinds = all_kinds_trades(pkg, model)
    v = model.value_dt
    F, D, C, Y = (u.FrequencyTypes, u.DayCountTypes, u.CurveTypes,
                  u.CurrencyTypes)
    if route == "bond_amortizing":
        return credit.Bond(v.add_months(-5), "4Y", coupon=0.035,
                           freq_type=F.SEMI_ANNUAL, dc_type=D.ACT_365F,
                           currency=Y.GBP, face_value=2_000_000,
                           amortization_schedule=[
                               2e6 - 2.5e5 * (i + 1) for i in range(8)]), \
            reqs
    if route == "frn_dual":
        return credit.FRN(v.add_months(-3), "3Y", quoted_margin=0.002,
                          freq_type=F.QUARTERLY, dc_type=D.ACT_360,
                          currency=Y.USD, floating_index=C.GBP_OIS_SONIA,
                          face_value=3_000_000), reqs
    i = {"frn": 3, "frn_capped": 4, "bond": 5, "xccy_basis": 2,
         "xccy_fix_float": 7, "xccy_fix_fix": 10, "zcis": 11, "yoy": 12}
    if route == "zcis":
        reqs = reqs[:3]          # the ZCIS route reports no cashflows
    return kinds[i[route]], reqs


def engine_route_results(models: dict, route: str) -> dict:
    """``route`` computed by both packages' engines (the port's on the
    CPU), on ``models`` (pkg -> build_all_kinds_model(pkg)), with each
    result's comparable parts."""
    out = dict(name=route)
    for pkg, key in (("adrates_tpu", "jax"), ("adrates_torch", "port")):
        trade, reqs = engine_route(pkg, models[pkg], route)
        kw = {} if pkg == "adrates_tpu" else dict(device="cpu")
        out[key] = trade.position(models[pkg], **kw).compute(reqs)
    out["jp"] = result_parts(out["jax"])
    out["tp"] = result_parts(out["port"])
    return out


def check_route_kind(route: dict, kind: str):
    """One output kind of a route: present in both results or in neither
    (only the ZCIS route reports no cashflows), and equal at 1e-10 x
    max|ref| of its kind."""
    jp, tp = route["jp"], route["tp"]
    assert (kind in jp) == (kind in tp)
    if kind not in jp:
        assert route["name"] == "zcis" and kind == "cashflows"
        return
    assert_parts_close({kind: jp[kind]}, {kind: tp[kind]})


def check_gamma_symmetric(parts: dict):
    """Each curve's gamma block is symmetric within 1e-10 x the largest
    |gamma| of the result (a par leg's block on its own curve is ~1e-17
    noise, in the JAX package too)."""
    blocks = parts["gamma"]
    scale = max(float(np.abs(g).max()) for g in blocks.values())
    for name, g in blocks.items():
        if " x " not in name:
            np.testing.assert_allclose(g, g.T, rtol=0, atol=1e-10 * scale,
                                       err_msg=name)


def direct_value(model, trade) -> float:
    """A trade's own host ``value(...)`` on the port's all-kinds model."""
    from adrates_torch.trades.rates.xccy_curve import find_xccy_curve
    curves = model.curves
    gbp, usd = curves["GBP_OIS_SONIA"], curves["USD_OIS_SOFR"]
    v = model.value_dt
    kind = trade.derivative_type.name
    if kind == "XCCY_SWAP":
        _, xc = find_xccy_curve(model, trade)
        return trade.value(v, usd, gbp, xccy_discount_curve=xc,
                           spot_fx=xc._spot_fx)
    if kind in ("ZCIS", "YOY_INFLATION_SWAP"):
        return trade.value(v, gbp, curves["GBP_RPI_INFLATION"])
    if kind == "BOND":
        return trade.value(v, gbp)
    disc = usd if trade._currency.name == "USD" else gbp
    return trade.value(v, disc, curves[trade._floating_index.name])


# The quick start's (examples/quickstart.py) curves and book, through
# either package.
QS_GBP_TENORS = ["1M", "6M", "1Y", "18M", "2Y", "3Y", "5Y", "7Y", "10Y",
                 "12Y", "20Y", "30Y", "50Y"]
QS_GBP_RATES = [5.19, 5.04, 4.71, 4.51, 4.35, 4.13, 3.93, 3.87, 3.87, 3.89,
                3.88, 3.71, 3.33]


def quickstart_gbp_model(pkg: str, interp: str = "LINEAR_ZERO_RATES"):
    """A model holding the quick start's 13-pillar GBP_OIS_SONIA alone, on
    the scheme named ``interp``."""
    u, Model, _ = _ns(pkg)
    m = Model(u.Date(1, 1, 2024))
    m.build_curve("GBP_OIS_SONIA", px_list=QS_GBP_RATES,
                  tenor_list=QS_GBP_TENORS,
                  fixed_dcc_type=u.DayCountTypes.ACT_365F,
                  float_dc_type=u.DayCountTypes.ACT_365F,
                  interp_type=getattr(u.InterpTypes, interp))
    return m


def quickstart_model(pkg: str):
    """(model, RPI index): the quick start's GBP, USD, GBP/USD basis and
    GBP RPI curves with GBPUSD."""
    u, _, _ = _ns(pkg)
    D = u.DayCountTypes
    m = quickstart_gbp_model(pkg)
    m.build_curve("USD_OIS_SOFR",
                  px_list=[5.33, 5.05, 4.60, 4.25, 4.00, 3.90, 3.88, 3.92,
                           3.85],
                  tenor_list=["6M", "1Y", "2Y", "3Y", "5Y", "7Y", "10Y",
                              "20Y", "30Y"],
                  fixed_dcc_type=D.ACT_360, float_dc_type=D.ACT_360,
                  interp_type=u.InterpTypes.FLAT_FWD_RATES)
    m.build_xccy_curve(name="GBP_USD_BASIS",
                       domestic_curve_name="USD_OIS_SOFR",
                       foreign_curve_name="GBP_OIS_SONIA",
                       basis_spreads=[-2.0, -5.0, -8.0, -11.0, -13.0],
                       tenor_list=["1Y", "2Y", "5Y", "10Y", "30Y"],
                       spot_fx=1.27)
    m.build_fx(["GBPUSD"], [1.27])
    _, rpi = m.build_inflation_curve(
        "GBP_RPI_INFLATION",
        breakeven_list=[3.8, 3.6, 3.5, 3.4, 3.5, 3.45, 3.3],
        tenor_list=["1Y", "2Y", "3Y", "5Y", "10Y", "20Y", "30Y"],
        base_cpi=293.0)
    return m, rpi


def quickstart_ten_year(pkg: str):
    """The quick start's 10Y RECEIVE 3.87% GBP OIS, 10M notional."""
    u, _, OIS = _ns(pkg)
    return OIS(u.Date(1, 1, 2024), "10Y", u.SwapTypes.RECEIVE, 0.0387,
               u.FrequencyTypes.ANNUAL, u.DayCountTypes.ACT_365F,
               u.CurveTypes.GBP_OIS_SONIA, u.CurrencyTypes.GBP,
               notional=10_000_000,
               float_dc_type=u.DayCountTypes.ACT_365F,
               bd_type=u.BusDayAdjustTypes.MODIFIED_FOLLOWING)


def quickstart_book_swaps(pkg: str, rng):
    """The quick start's 20 base OIS (2Y/5Y/10Y/30Y x 5, coupons from
    ``rng``)."""
    u, _, OIS = _ns(pkg)
    return [OIS(u.Date(1, 1, 2024), ten,
                u.SwapTypes.PAY if i % 2 else u.SwapTypes.RECEIVE,
                float(rng.uniform(0.02, 0.05)), u.FrequencyTypes.ANNUAL,
                u.DayCountTypes.ACT_365F, u.CurveTypes.GBP_OIS_SONIA,
                u.CurrencyTypes.GBP, notional=1e6,
                float_dc_type=u.DayCountTypes.ACT_365F,
                bd_type=u.BusDayAdjustTypes.MODIFIED_FOLLOWING)
            for i, ten in enumerate(["2Y", "5Y", "10Y", "30Y"] * 5)]


def chain_forest(rng, P: int, G: int = 1, depth: int = None, pad: int = 0):
    """A random OIS-style point plan for the pv01 chain solve, as the
    host arrays of ``ops/kernels.chain_tables``: each of ``G`` rows has
    several roots and branching chains (every link strictly backward),
    the last ``pad`` points of a row roots, as a stacked stage pads; with
    ``depth`` given, row 0 opens with one chain that long. Returns
    (prev [P] or [G, P], child_idx, child_mask, depth)."""
    prev = np.full((G, P), -1, dtype=np.int64)
    for g in range(G):
        live = P - pad
        lo = 0
        if depth is not None and g == 0:
            prev[g, 1:depth] = np.arange(depth - 1)
            lo = depth
        for i in range(max(lo, 1), live):
            if rng.random() > 0.15:
                prev[g, i] = rng.integers(max(0, i - 6), i)
    return chain_plan(prev[0] if G == 1 else prev)


def chain_plan(prev):
    """The host arrays of ``ops/kernels.chain_tables`` for the links
    ``prev`` [P] or [G, P] (-1 at a root, every link strictly backward):
    (prev, child_idx, child_mask, depth), children in ascending order as
    the JAX package's plan lists them."""
    prev = np.asarray(prev, dtype=np.int64)
    rows = prev.reshape(-1, prev.shape[-1])
    G, P = rows.shape
    depths = np.zeros((G, P), dtype=np.int64)
    for g in range(G):
        for i in range(P):
            p = rows[g, i]
            depths[g, i] = 1 if p < 0 else depths[g, p] + 1
    kids = [[[] for _ in range(P)] for _ in range(G)]
    for g in range(G):
        for i in range(P):
            if rows[g, i] >= 0:
                kids[g][rows[g, i]].append(i)
    kc = max(1, max(len(c) for row in kids for c in row))
    child_idx = np.zeros((G, P, kc), dtype=np.int64)
    child_mask = np.zeros((G, P, kc))
    for g in range(G):
        for j, c in enumerate(kids[g]):
            child_idx[g, j, :len(c)] = c
            child_mask[g, j, :len(c)] = 1.0
    shape = prev.shape + (kc,)
    return (prev, child_idx.reshape(shape), child_mask.reshape(shape),
            int(depths.max()))


def chain_edge_plan(kind: str):
    """The pv01 chain plans the K4 / K5 tests hold apart from the random
    forests, as ``chain_plan`` arrays: ``one_chain`` (P = 72, every link
    the point just before), ``interleaved`` (P = 72, two chains, no link
    the point just before) and ``padded_stack`` (G = 7 rows of P = 72
    shaped as flagship_v5's OIS stage: three of 72 points, 12 roots and
    two far links, four of 42 points, 3 roots, padded with roots)."""
    P = 72
    i = np.arange(P)
    if kind == "one_chain":
        return chain_plan(i - 1)
    if kind == "interleaved":
        return chain_plan(np.where(i >= 2, i - 2, -1))
    if kind == "padded_stack":
        long = np.where(i >= 14, i - 1, -1)
        long[12], long[13] = 5, 11
        short = np.full(P, -1)
        short[3:42] = np.arange(2, 41)
        return chain_plan(np.stack([long] * 3 + [short] * 4))
    raise ValueError(kind)


def ois_stage_host(members, W: int, seed: int, spacing: float = 1.0,
                   log: bool = True):
    """A seeded OIS stage built from the port's host pieces, with no model:
    ``members`` [(pillars, coupons a year, scheme name)], pillar k at
    ``spacing`` (k + 1) years with its coupons from the start (the
    plan's rounded-key memo shares the coupon points), stacked and padded
    as ``curve_batching`` stacks a stage; W rows at seeded times (the t =
    0 node, every member's knots and times between and past them).
    Returns (the ``curve_batching._Stage``, its members' schemes, its host
    ``bat`` entry)."""
    from adrates_torch.ops.bootstrap import prepare_ois_plan
    from adrates_torch.parallel import curve_batching as cb
    from adrates_torch.utils.global_types import InterpTypes
    rng = np.random.default_rng(seed)
    plans, its = [], []
    for n, f, sch in members:
        T = spacing * np.arange(1, n + 1)
        plans.append(prepare_ois_plan(
            T, [[1.0 / f] * int(round(f * t)) for t in T],
            loglinear_rates=log))
        its.append(InterpTypes[sch])
    plan = cb._stack_ois_plans(plans)
    G, P = plan.point_times.shape
    Qp = plan.swap_times.shape[1]
    pad_mask = np.zeros((G, P + 1), dtype=bool)
    for g, p in enumerate(plans):
        pad_mask[g, 1 + p.point_times.shape[0]:] = True
    sent = np.tile(cb._sent(0, P + 1), (G, 1))
    ts = np.where(pad_mask, sent, np.concatenate(
        [np.zeros((G, 1)), plan.point_times], axis=1))
    knots = np.unique(np.concatenate([p.point_times for p in plans]))
    tmax = float(knots.max())
    extra = np.sort(rng.uniform(0.0, tmax + 3.0, max(W - 1 - knots.size, 0)))
    ut = np.unique(np.concatenate([[0.0], knots, extra]))[:W]
    b = dict(plan=plan, pad_mask=pad_mask,
             qidx=np.stack([np.minimum(np.arange(Qp), len(p.swap_times) - 1)
                            for p in plans]),
             ts_static=ts, row_plan=cb._row_plan(ut, ts, pad_mask, its))
    return cb._Stage(kind="ois", ids=list(range(G)), key="s"), its, b


def ois_stage_case(members, W: int, Sc: int, seed: int, device,
                   spacing: float = 1.0, log: bool = True):
    """:func:`ois_stage_host`'s stage as (``ops/ois_stage.OisStageTables``
    on ``device``, local quotes [Sc, G, Qp] on ``device``: about 3% with
    seeded noise, each member's pad slots repeating its last quote)."""
    import torch

    from adrates_torch.ops import ois_stage
    from adrates_torch.parallel import curve_batching as cb
    st, its, b = ois_stage_host(members, W, seed, spacing, log)
    bd = cb.bat_to_torch({"s": b}, device)["s"]
    tab = ois_stage.stage_tables(st, its, b, b["row_plan"], bd,
                                 bd["row_plan"], device)
    n_of = (b["qidx"].max(axis=1) + 1).tolist()
    rng = np.random.default_rng(seed + 1)
    q = 0.03 + 0.004 * rng.standard_normal((Sc, tab.G, tab.Qp))
    for g, n in enumerate(n_of):
        q[:, g, n:] = q[:, g, n - 1:n]
    return tab, torch.tensor(q, device=device)
