"""Multi-currency, multi-curve book-scale pricing and risk.

Port of ``adrates_tpu/parallel/multibook.py``: the same design — one
shared unique-time grid, per-trade gathers, aggregate-weight AD:

 - a **CurveBasket** compiles a Model's curves into ONE differentiable
   function quotes -> flat DF vector over the book's COMPACTED grid axis
   (only the (curve, time) pairs some trade references);
 - a **MultiBook** holds every leg of every trade as padded index rows
   with the curve ids folded into the gather indices at compile time,
   and derives the COLUMN form (``ColRows``) the PV sweep runs on: one
   (column, weight) slot per cashflow against the per-scenario value
   vector [DF grid, forward-triple table];
 - FX conversion to the base currency is folded into the row weights;
 - the book's TOTAL PV collapses onto O(n_grid + T) aggregate weights, so
   the book delta ladder and gamma cost one trade's.

``make_multibook_fn(mb, device)`` is the device path: per scenario chunk,
J = ∂dfs/∂q, g = ∂total/∂dfs by ``grad``, delta = J g, gamma = term1 (the
hand-written K2 kernel) + term2; then the per-trade PVs of every scenario
in one sweep (the hand-written K1 kernel). J and term2 come from the
STRUCTURED per-stage split (``structured_risk.py``) when the book carries
its stage topology, else from the generic split over the whole curve
graph (``vmap(jvp)`` for J, ``jacfwd(grad(..))`` of g0·grids for term2).
``make_staged_multibook_fn`` runs the same structured pass as separately
callable regions; ``warmup_multibook`` builds either and makes the first
call. ``make_per_trade_delta_fn`` (every trade's ladder, on K1) and
``make_per_trade_gamma_fn`` (selected trades' gammas, term 1 on the K3
kernel) give per-trade risk at one quote vector; ``pertrade_blocks.py``
every trade's own gamma block; ``make_multibook_speed_fn`` the book's
exact third-order tensor.

Ported here: OIS, XCCY and inflation curves (the three simple
interpolation schemes), OIS trades under natural or foreign collateral,
XCCY swaps (float/float, fix-float, fix-fix), FRNs (cap/floor coupons as
clamp slots), bonds, ZCIS and YoY inflation swaps — every instrument the
JAX package's book compiler takes. Other instruments raise ``LibError``,
as there.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch.func import grad, jacfwd, jacrev, jvp, vmap

from ..ops import kernels
from ..ops.linear_solve import jvp_by_vjp
from ..utils.currency import CurrencyTypes
from ..utils.day_count import DayCountTypes
from ..utils.device import resolve_device
from ..utils.error import LibError
from ..utils.global_types import (CollateralType, InstrumentTypes,
                                  InterpTypes, SwapTypes,
                                  collateral_to_currency,
                                  get_discount_curve_name)
from ..ops.pricers import FloatLegTensor
from ..utils.observability import timed
from .curve_batching import (StageTopology, bat_to_torch,
                             build_batched_grids)
from .slots import _unkey, sweep_slots

# Bytes allowed for the risk pass's live f64 tangent stacks of one
# scenario chunk. The generic split holds about three [chunk, N, C*U]
# stacks live at once (J before compaction, and the curve-Hessian
# contraction's forward tangents through the dense rows), so the chunk is
# budget // (3 * N * C*U * 8): at the flagship OIS slice (N = 144) that is
# tens of scenarios per chunk, well inside an 80 GB card.
RISK_CHUNK_BYTES = 4 * 1024 ** 3

# Largest quote-vector size the exact third-order SPEED tower accepts
# without force=True (see make_multibook_speed_fn: past this the N^2
# forward tangents make runtime and memory impractical).
SPEED_MAX_QUOTES = 64


# ---------------------------------------------------------------------------
# Curve basket: the model's curves as one differentiable system
# ---------------------------------------------------------------------------


def _stack_leg_tensors(tensors: Sequence[FloatLegTensor]) -> FloatLegTensor:
    """Pad to a common payment count and stack along a leading axis (the
    XCCY calibration domestic legs). Static switches must agree."""
    P = max(t.payment_times.shape[0] for t in tensors)

    def pad(vec, fill):
        v = np.asarray(vec, dtype=np.float64)
        out = np.full(P, fill, dtype=np.float64)
        out[:v.shape[0]] = v
        return out

    def stack(name, fill=0.0):
        return np.stack([pad(getattr(t, name), fill) for t in tensors])

    def scal(name):
        return np.array([np.float64(getattr(t, name)) for t in tensors])

    first = tensors[0]
    if not all(t.override_first == first.override_first and
               t.notional_exchange == first.notional_exchange and
               t.has_cap_floor == first.has_cap_floor for t in tensors):
        raise LibError("calibration legs disagree on their static switches")
    return FloatLegTensor(
        payment_times=stack("payment_times", -1.0),  # padded slots settled
        start_times=stack("start_times", 0.0),
        end_times=stack("end_times", 0.0),
        pay_alphas=stack("pay_alphas", 0.0),
        index_alphas=stack("index_alphas", 0.0),  # 0 -> fwd masked to 0
        spreads=stack("spreads", 0.0),
        notionals=stack("notionals", 0.0),
        principal=scal("principal"),
        leg_sign=scal("leg_sign"),
        value_time=scal("value_time"),
        first_fixing_rate=scal("first_fixing_rate"),
        notional_exchange_amount=scal("notional_exchange_amount"),
        effective_time=scal("effective_time"),
        maturity_time=scal("maturity_time"),
        cap_rate=scal("cap_rate"),
        floor_rate=scal("floor_rate"),
        override_first=first.override_first,
        notional_exchange=first.notional_exchange,
        has_cap_floor=first.has_cap_floor)


@dataclasses.dataclass
class _CurveSpec:
    name: str
    kind: str                      # 'ois' | 'xccy' | 'infl'
    interp_type: InterpTypes
    n_quotes: int
    offset: int                    # slice start in the packed quote vector
    dom_id: int = -1               # xccy only: domestic curve id
    for_id: int = -1               # xccy only: foreign curve id
    foreign_interp_type: InterpTypes = None


class CurveBasket:
    """Compiles a Model's OIS, XCCY and inflation curves into one
    differentiable quotes->grids function over a packed quote vector.

    Curve order: OIS curves first, then XCCY curves (which consume the
    OIS grids), then inflation curves (closed form, no dependencies), each
    kind by NAME (the model dict's insertion order is build order, which
    would make the quote packing and the grid compaction depend on it);
    explicit ``curve_names`` keep caller order within each kind.
    ``specs[i].offset`` locates curve i's quotes inside the packed vector.
    ``recalibrate_xccy=False`` holds each XCCY curve's parents as values
    (their quotes do not move it). Inflation rows hold cumulative FACTORS
    (1+r)^T >= 1 on the shared time grid instead of discount factors; the
    gathers and the trip form do not care what the numbers mean."""

    def __init__(self, model, curve_names: Optional[List[str]] = None,
                 recalibrate_xccy: bool = True):
        from ..market.curves.inflation_curve import InflationCurve
        from ..trades.rates.ois_curve import OISCurve
        from ..trades.rates.xccy_curve import XccyCurve

        explicit = curve_names is not None
        names = curve_names or list(model._curves_dict)
        ois, xccy, infl = [], [], []
        for n in names:
            c = model._curves_dict[n]
            if isinstance(c, OISCurve):
                ois.append((n, c))
            elif isinstance(c, XccyCurve):
                xccy.append((n, c))
            elif isinstance(c, InflationCurve):
                infl.append((n, c))
            else:
                raise LibError(f"not yet ported: {type(c).__name__} "
                               f"curve {n} in a basket")
        if not explicit:
            ois.sort(key=lambda nc: nc[0])
            xccy.sort(key=lambda nc: nc[0])
            infl.sort(key=lambda nc: nc[0])

        self.model = model
        self.recalibrate_xccy = recalibrate_xccy
        # compile_multibook(batch_curves=False) clears it: the risk pass
        # then takes the generic split
        self.batch_curves = True
        self.specs: List[_CurveSpec] = []
        self.curves: List[object] = []
        self._id_by_name: Dict[str, int] = {}
        params: Dict = {"ois_plans": [], "xccy": [], "infl": []}
        quotes0 = []
        offset = 0
        for name, curve in ois:
            n_q = len(curve.swap_rates)
            self.specs.append(_CurveSpec(name, "ois", curve._interp_type,
                                         n_q, offset))
            self._id_by_name[name] = len(self.curves)
            self.curves.append(curve)
            params["ois_plans"].append(curve._plan)
            quotes0.append(np.asarray(curve.swap_rates, dtype=np.float64))
            offset += n_q

        for name, curve in xccy:
            dom_name = next(n for n, c in ois
                            if c is curve._domestic_curve)
            for_name = next(n for n, c in ois
                            if c is curve._foreign_curve)
            n_q = len(curve.basis_spreads)
            self.specs.append(_CurveSpec(
                name, "xccy", curve._interp_type, n_q, offset,
                dom_id=self._id_by_name[dom_name],
                for_id=self._id_by_name[for_name],
                foreign_interp_type=curve._foreign_curve._interp_type))
            self._id_by_name[name] = len(self.curves)
            self.curves.append(curve)
            dom_dc = curve._domestic_curve._dc_type
            dom_legs = _stack_leg_tensors([
                s._domestic_leg.tensor(model.value_dt, index_dc=dom_dc)
                for s in curve._used_swaps])
            params["xccy"].append(dict(
                plan=curve._plan, dom_legs=dom_legs,
                spot_fx=np.float64(curve._spot_fx),
                pv_dom0=np.asarray(curve._pv_domestic, dtype=np.float64)))
            quotes0.append(np.asarray(curve.basis_spreads,
                                      dtype=np.float64))
            offset += n_q

        for name, curve in infl:
            n_q = len(curve.breakeven_rates)
            self.specs.append(_CurveSpec(name, "infl", curve._interp_type,
                                         n_q, offset))
            self._id_by_name[name] = len(self.curves)
            self.curves.append(curve)
            params["infl"].append(dict(
                swap_times=np.asarray(curve.swap_times, dtype=np.float64)))
            quotes0.append(np.asarray(curve.breakeven_rates,
                                      dtype=np.float64))
            offset += n_q

        params["ois_plans"] = tuple(params["ois_plans"])
        params["xccy"] = tuple(params["xccy"])
        params["infl"] = tuple(params["infl"])
        self.params = params
        self.quotes0 = np.concatenate(quotes0) if quotes0 \
            else np.zeros(0)
        self.n_quotes = offset
        self.n_curves = len(self.curves)
        self.grid_sel = None
        self.n_grid = None

    def curve_id(self, name: str) -> int:
        return self._id_by_name[name]

    def quote_slice(self, name: str) -> slice:
        spec = self.specs[self._id_by_name[name]]
        return slice(spec.offset, spec.offset + spec.n_quotes)

    def grids_fn(self, unique_times, stage_buckets: str = "fine",
                 grid_sel=None):
        """The pure fn (qvec, P) -> flat DF vector over the book's grid
        axis: every curve interpolated over the shared unique-time grid,
        rows concatenated in curve-id order (dense global index =
        curve_id * U + time_idx), then restricted to ``grid_sel`` (sorted
        int array into the dense [C*U] axis) — the compaction
        compile_multibook applies. Sets the grid-axis metadata
        (``grid_sel``, ``n_grid``, ``grid_dense``, ``grid_inv``,
        ``grid_curve_of``, ``grid_local_of`` (each column's unique-time
        index), ``grid_keep_of``, ``grid_offsets``: the per-curve rows
        the structured risk pass places into) and the host stage plans
        ``bat``/``stages``."""
        ut = np.asarray(unique_times)
        U = ut.shape[0]
        C = self.n_curves
        if grid_sel is None:
            grid_sel = np.arange(C * U, dtype=np.int32)
        grid_sel = np.asarray(grid_sel, dtype=np.int32)
        self.grid_sel = grid_sel
        self.n_grid = int(grid_sel.shape[0])
        self.grid_dense = self.n_grid == C * U
        # gather-based inverse: dense index -> compact position, with
        # unreferenced entries pointing at an appended zero slot
        inv = np.full(C * U, self.n_grid, dtype=np.int32)
        inv[grid_sel] = np.arange(self.n_grid, dtype=np.int32)
        self.grid_inv = inv
        self.grid_curve_of = (grid_sel // U).astype(np.int32)
        self.grid_local_of = (grid_sel % U).astype(np.int32)
        self.grid_keep_of = [self.grid_local_of[self.grid_curve_of == c]
                             for c in range(C)]
        self.grid_offsets = np.concatenate(
            [[0], np.cumsum([k.shape[0] for k in self.grid_keep_of])]
        ).astype(np.int32)
        grids, bat, stages = build_batched_grids(
            self, ut, stage_buckets=stage_buckets)
        self.unique_times = ut
        self.bat = bat
        self.stages = stages
        return grids

    def topology(self) -> StageTopology:
        """The static stage topology the structured risk pass reads."""
        return StageTopology(
            stages=self.stages, specs=self.specs, bat=self.bat,
            n_quotes=self.n_quotes, unique_times=self.unique_times,
            grid_dense=self.grid_dense, grid_keep_of=self.grid_keep_of,
            grid_offsets=self.grid_offsets, grid_inv=self.grid_inv)


# ---------------------------------------------------------------------------
# Multi-book tables (host numpy)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MultiBookRows:
    """One pad-bucket of legs ("rows"): [R, P] padded index/amount arrays
    with GLOBAL gather indices (curve id folded in at compile time).
    FX-to-base and leg signs are folded into the amount weights."""
    fix_idx: np.ndarray              # [R, P] int32 into the compact grid
    fix_payments: np.ndarray         # [R, P]
    fix_mask: np.ndarray             # [R, P]
    flt_pay_idx: np.ndarray          # [R, P] int32 (disc curve)
    flt_start_idx: np.ndarray        # [R, P] int32 (proj curve)
    flt_end_idx: np.ndarray          # [R, P] int32 (proj curve)
    flt_pay_alphas: np.ndarray       # [R, P]
    flt_index_alphas: np.ndarray     # [R, P]
    flt_spreads: np.ndarray          # [R, P]
    flt_notionals: np.ndarray        # [R, P] signed, fx-folded
    flt_mask: np.ndarray             # [R, P]
    row_trade: np.ndarray            # [R] int32 owning trade

    @property
    def num_rows(self) -> int:
        return self.fix_idx.shape[0]


@dataclasses.dataclass(frozen=True)
class ClampSlots:
    """Cap/floor-clamped float coupons (nonlinear in the DFs): kept
    per-slot. PV = w * clip((df_s/df_e - 1)/ia + spread, floor, cap)
    * df_p, with w = sign * fx * alpha * notional. Arrays are numpy on
    the host and tensors on the device."""
    s_idx: np.ndarray                # [K] int32
    e_idx: np.ndarray                # [K] int32
    p_idx: np.ndarray                # [K] int32
    ia: np.ndarray                   # [K] index-basis alphas
    w: np.ndarray                    # [K]
    spread: np.ndarray               # [K]
    cap: np.ndarray                  # [K]
    floor: np.ndarray                # [K]
    slot_trade: np.ndarray           # [K] int32


@dataclasses.dataclass(frozen=True)
class ColRows:
    """One pad-bucket of legs in COLUMN form: every cashflow is a single
    (column, weight) slot against the per-scenario value vector
    v = concat(dfs_flat [n_grid], tripvals [T]) where
    tripvals[t] = (df_s/df_e - 1) * df_p over the aggregate's
    deduplicated forward triples."""
    col_idx: np.ndarray              # [R, L] int32 into [n_grid + T]
    w: np.ndarray                    # [R, L] (0.0 = dead slot)
    row_trade: np.ndarray            # [R] int32 owning trade


@dataclasses.dataclass(frozen=True)
class MultiBookAggregate:
    """The book's TOTAL base-ccy PV collapsed onto the compact flat grid:
    linear weights + deduplicated forward triples (+ clamp slots handled
    separately)."""
    w_lin: np.ndarray                # [n_grid]
    trip_s: np.ndarray               # [T] int32
    trip_e: np.ndarray               # [T] int32
    trip_p: np.ndarray               # [T] int32
    trip_w: np.ndarray               # [T]


@dataclasses.dataclass(frozen=True)
class TileSpec:
    """Lazy tiling: the book is ``base x n_copies`` with per-copy
    notional multipliers, expanded to full row tensors on the device once
    at function-build time (only the base book crosses the host->device
    boundary)."""
    scale: np.ndarray                # [n_copies] notional multipliers
    base_trades: int


@dataclasses.dataclass
class MultiBook:
    """A compiled multi-currency book: pad-bucketed rows + clamp slots +
    aggregate + the basket that produced the gather indices. When
    ``tile`` is set, buckets/clamp/cols hold the BASE book (aggregate is
    already at tiled scale)."""
    basket: CurveBasket
    unique_times: np.ndarray
    buckets: Tuple[MultiBookRows, ...]
    clamp: Optional[ClampSlots]
    aggregate: MultiBookAggregate
    n_trades: int
    base_currency: CurrencyTypes
    tile: Optional[TileSpec] = None
    cols: Tuple[ColRows, ...] = ()   # column form of `buckets` (same PVs)


# ---------------------------------------------------------------------------
# compilation (host)
# ---------------------------------------------------------------------------


class _Interner:
    def __init__(self):
        self._by_key = {}
        self._times = []

    def add(self, t: float) -> int:
        key = round(float(t), 12)
        idx = self._by_key.get(key)
        if idx is None:
            idx = len(self._times)
            self._by_key[key] = idx
            self._times.append(float(t))
        return idx

    def finish(self):
        order = np.argsort(np.asarray(self._times))
        remap = np.empty(len(order), dtype=np.int64)
        remap[order] = np.arange(len(order))
        return np.asarray(self._times)[order], remap


# each currency's default OIS curve: the discount curve of its FRNs, bonds
# and inflation swaps
_DEFAULT_OIS = {
    CurrencyTypes.GBP: "GBP_OIS_SONIA",
    CurrencyTypes.USD: "USD_OIS_SOFR",
    CurrencyTypes.EUR: "EUR_OIS_ESTR",
    CurrencyTypes.JPY: "JPY_OIS_TONAR",
    CurrencyTypes.CHF: "CHF_OIS_SARON",
    CurrencyTypes.AUD: "AUD_OIS_AONIA",
    CurrencyTypes.CAD: "CAD_OIS_CORRA",
}


def _fx_to_base(model, ccy: CurrencyTypes, base: CurrencyTypes) -> float:
    if ccy == base:
        return 1.0
    return model.fx(f"{ccy.name}{base.name}")


def _empty_flt() -> dict:
    return dict(pay=[], s=[], e=[], pa=[], ia=[], sp=[], no=[], m=[])


def _float_row(tensor, disc_id: int, proj_id: int, fx: float,
               trade_id: int, clamp_rows: list):
    """Compile a FloatLegTensor into one row dict (+ optional clamp
    slots). Exchanges and first-fixing coupons move to the FIX side."""
    sign = float(tensor.leg_sign)
    w = fx * sign
    pay_t = np.asarray(tensor.payment_times, dtype=np.float64)
    start_t = np.asarray(tensor.start_times, dtype=np.float64)
    end_t = np.asarray(tensor.end_times, dtype=np.float64)
    pay_a = np.asarray(tensor.pay_alphas, dtype=np.float64)
    idx_a = np.asarray(tensor.index_alphas, dtype=np.float64)
    spreads = np.asarray(tensor.spreads, dtype=np.float64)
    notionals = np.asarray(tensor.notionals, dtype=np.float64)
    n = pay_t.shape[0]

    fix_t, fix_amt, fix_m = [], [], []
    flt = _empty_flt()

    for j in range(n):
        live = pay_t[j] > 0.0
        amt_extra = float(tensor.principal) if j == n - 1 else 0.0
        if tensor.override_first and j == 0:
            # known fixing: the coupon is a fixed cashflow
            rate = float(tensor.first_fixing_rate) + spreads[j]
            if tensor.has_cap_floor:
                rate = min(max(rate, float(tensor.floor_rate)),
                           float(tensor.cap_rate))
            fix_t.append(pay_t[j])
            fix_amt.append(w * (rate * pay_a[j] * notionals[j] + amt_extra))
            fix_m.append(1.0 if live else 0.0)
            continue
        if amt_extra:
            fix_t.append(pay_t[j])
            fix_amt.append(w * amt_extra)
            fix_m.append(1.0 if live else 0.0)
        if tensor.has_cap_floor:
            if live:
                clamp_rows.append(dict(
                    s=(proj_id, start_t[j]), e=(proj_id, end_t[j]),
                    p=(disc_id, pay_t[j]), ia=idx_a[j],
                    w=w * pay_a[j] * notionals[j], spread=spreads[j],
                    cap=float(tensor.cap_rate),
                    floor=float(tensor.floor_rate), trade=trade_id))
            continue
        flt["pay"].append(pay_t[j])
        flt["s"].append(start_t[j])
        flt["e"].append(end_t[j])
        flt["pa"].append(pay_a[j])
        flt["ia"].append(idx_a[j])
        flt["sp"].append(spreads[j])
        flt["no"].append(w * notionals[j])
        flt["m"].append(1.0 if live else 0.0)

    if tensor.notional_exchange:
        amt = float(tensor.notional_exchange_amount)
        for t, a in [(float(tensor.effective_time), -amt),
                     (float(tensor.maturity_time), amt)]:
            fix_t.append(t)
            fix_amt.append(w * a)
            fix_m.append(1.0 if t >= 0.0 else 0.0)  # exchange AT value
            #   date still settles today (direct value() parity)

    return dict(trade=trade_id, disc=disc_id, proj=proj_id,
                fix_t=fix_t, fix_amt=fix_amt, fix_m=fix_m, flt=flt)


def _fixed_row(payment_times, amounts, disc_id: int, fx: float, sign: float,
               trade_id: int, extra_exchanges=None):
    """Fixed cashflows (+ optional (time, amount) exchanges with >= 0
    liveness)."""
    w = fx * sign
    fix_t = [float(t) for t in payment_times]
    fix_amt = [w * float(a) for a in amounts]
    fix_m = [1.0 if t > 0.0 else 0.0 for t in fix_t]
    for t, a in (extra_exchanges or []):
        fix_t.append(float(t))
        fix_amt.append(w * float(a))
        fix_m.append(1.0 if t >= 0.0 else 0.0)
    return dict(trade=trade_id, disc=disc_id, proj=disc_id,
                fix_t=fix_t, fix_amt=fix_amt, fix_m=fix_m, flt=_empty_flt())


def _infl_curve_id(basket: CurveBasket, inst) -> int:
    """The basket id of the instrument's inflation curve: the index's
    attached curve, else the single inflation curve in the basket
    (``adrates_tpu/parallel/multibook.py:631``)."""
    from ..market.curves.inflation_curve import InflationCurve

    curve = inst._inflation_index._inflation_curve
    if curve is not None:
        for i, c in enumerate(basket.curves):
            if c is curve:
                return i
    cands = [i for i, c in enumerate(basket.curves)
             if isinstance(c, InflationCurve)]
    if len(cands) != 1:
        raise LibError("Inflation trade needs its index's curve in the "
                       "basket (or exactly one inflation curve)")
    return cands[0]


def _infl_payment(num_ref, den_ref, base_cpi: float, w: float,
                  spread: float, pay_t: float, row: dict):
    """Append ONE inflation-ratio payment w·(cpi_num/cpi_den − 1 +
    spread)·df(pay) to a row dict, split into the book's linear and trip
    primitives (``adrates_tpu/parallel/multibook.py:650-689``): a CPI is
    its fixed value when the lagged date has a historical fixing, else
    seas·base_cpi·factor(t).

    Future/future ratios are the trip form (F_num/F_den − 1)·df exactly;
    a fixed side puts the trip's other time on the inflation curve's t=0
    column (factor 1 there by construction), so one trip shape covers all
    four fixed/projected cases. Refs are (is_fixed, value, t, seas)."""
    n_fixed, n_val, n_t, n_seas = num_ref
    d_fixed, d_val, d_t, d_seas = den_ref

    if n_fixed and d_fixed:
        row["fix_t"].append(float(pay_t))
        row["fix_amt"].append(w * (n_val / d_val - 1.0 + spread))
        row["fix_m"].append(1.0)
        return
    if d_fixed:                   # k·F(n_t), k = seas·base/fixed_den
        k = n_seas * base_cpi / d_val
        s_t, e_t = float(n_t), 0.0
    elif n_fixed:                 # k/F(d_t)
        k = n_val / (d_seas * base_cpi)
        s_t, e_t = 0.0, float(d_t)
    else:                         # k·F(n_t)/F(d_t)
        k = n_seas / d_seas
        s_t, e_t = float(n_t), float(d_t)
    w_trip = w * k                          # on (F_s/F_e − 1)·df_p
    w_lin = w * (k - 1.0 + spread)          # on df_p
    flt = row["flt"]
    flt["pay"].append(float(pay_t))
    flt["s"].append(s_t)
    flt["e"].append(e_t)
    flt["pa"].append(1.0)
    flt["ia"].append(1.0)
    flt["sp"].append(w_lin / w_trip)
    flt["no"].append(w_trip)
    flt["m"].append(1.0)


def _rows_for_instrument(inst, model, basket: CurveBasket, base, value_dt,
                         trade_id: int, clamp_rows: list,
                         collateral_type=None) -> list:
    """Compile one instrument into row dicts
    (``adrates_tpu/parallel/multibook.py:692-899``; reference semantics:
    engine.py:2639-2728 dual-curve floats, 1496-1520 XCCY foreign legs,
    505-698 bonds, 700-984 FRNs, 1108-1146 YoY legs, 217-503 OIS under
    foreign collateral)."""
    from ..market.position.engine_credit import _bond_tensor, _frn_tensor
    from ..market.position.engine_inflation import _cpi_ref
    from ..trades.rates.swap_fixed_leg import SwapFixedLeg
    from ..trades.rates.xccy_basis_swap import float_leg_xccy_tensor
    from ..trades.rates.xccy_curve import find_xccy_curve
    from ..utils.helpers import times_from_dates

    itype = inst.derivative_type
    rows = []

    if itype == InstrumentTypes.OIS_SWAP:
        cid = basket.curve_id(inst._floating_index.name)
        curve = basket.curves[cid]
        fx = _fx_to_base(model, inst._currency, base)

        coll_ccy = None
        if collateral_type is not None:
            coll_ccy = collateral_to_currency(collateral_type)
            if coll_ccy == inst._currency:
                coll_ccy = None

        if coll_ccy is None:
            ft = inst._fixed_leg.tensor(value_dt)
            lt = inst._float_leg.tensor(value_dt, index_dc=curve._dc_type)
            rows.append(_fixed_row(ft.payment_times,
                                   np.asarray(ft.payments), cid, fx,
                                   float(ft.leg_sign), trade_id))
            rows.append(_float_row(lt, cid, cid, fx, trade_id,
                                   clamp_rows))
        else:
            # OIS under foreign collateral: project on the natural OIS
            # curve, discount on the {CCY}_{COLL}_XCCY curve, whose df()
            # pins ACT/365F query times. The curve graph recalibrates the
            # XCCY grid, so rate AND basis deltas carry the chain.
            disc_name = get_discount_curve_name(
                inst._currency, CollateralType[coll_ccy.name])
            if disc_name not in basket._id_by_name:
                raise LibError(
                    f"Collateralized OIS needs discount curve "
                    f"{disc_name} in the basket")
            disc_id = basket.curve_id(disc_name)
            ft = inst._fixed_leg.tensor(
                value_dt, discount_dc=DayCountTypes.ACT_365F)
            lt = inst._float_leg.tensor(
                value_dt, index_dc=curve._dc_type,
                discount_dc=DayCountTypes.ACT_365F)
            rows.append(_fixed_row(ft.payment_times,
                                   np.asarray(ft.payments), disc_id, fx,
                                   float(ft.leg_sign), trade_id))
            rows.append(_float_row(lt, disc_id, cid, fx, trade_id,
                                   clamp_rows))

    elif itype == InstrumentTypes.XCCY_SWAP:
        xname, xcurve = find_xccy_curve(model, inst)
        xid = basket.curve_id(xname)
        dom_id = basket.curve_id(inst._domestic_floating_index.name)
        for_id = basket.curve_id(inst._foreign_floating_index.name)
        dom_curve = basket.curves[dom_id]
        for_curve = basket.curves[for_id]
        fx_dom = _fx_to_base(model, inst._domestic_currency, base)
        fx_for = fx_dom * float(xcurve._spot_fx)  # foreign leg PV is in
        #   foreign ccy; trade PV converts at the curve's spot
        dom_leg = inst._domestic_leg
        for_leg = inst._foreign_leg

        if isinstance(dom_leg, SwapFixedLeg):
            # the fixed leg's manual notional exchanges
            # (xccy_fix_float_swap.py value()), on ACT_ACT_ISDA times as
            # the domestic curve's df() default
            ft = dom_leg.tensor(value_dt)
            eff_t = times_from_dates(inst._effective_dt, value_dt,
                                     DayCountTypes.ACT_ACT_ISDA)
            mat_t = times_from_dates(inst._maturity_dt, value_dt,
                                     DayCountTypes.ACT_ACT_ISDA)
            n = inst._domestic_notional
            rows.append(_fixed_row(
                ft.payment_times, np.asarray(ft.payments), dom_id, fx_dom,
                float(ft.leg_sign), trade_id,
                extra_exchanges=[(eff_t, -n), (mat_t, n)]))
        else:
            lt = dom_leg.tensor(value_dt, index_dc=dom_curve._dc_type)
            rows.append(_float_row(lt, dom_id, dom_id, fx_dom, trade_id,
                                   clamp_rows))

        if isinstance(for_leg, SwapFixedLeg):
            # the foreign fixed leg and its exchanges on the XCCY curve,
            # whose df() pins ACT/365F query times
            xdc = DayCountTypes.ACT_365F
            pay_t = np.asarray(times_from_dates(
                for_leg._payment_dts, value_dt, xdc))
            sign = 1.0 if for_leg._leg_type == SwapTypes.RECEIVE else -1.0
            eff_t = times_from_dates(inst._effective_dt, value_dt, xdc)
            mat_t = times_from_dates(inst._maturity_dt, value_dt, xdc)
            n = inst._foreign_notional
            rows.append(_fixed_row(
                pay_t, np.asarray(for_leg._payments), xid, fx_for, sign,
                trade_id, extra_exchanges=[(eff_t, -n), (mat_t, n)]))
        else:
            lt = float_leg_xccy_tensor(for_leg, value_dt, for_curve._dc_type)
            rows.append(_float_row(lt, xid, for_id, fx_for, trade_id,
                                   clamp_rows))

    elif itype == InstrumentTypes.FRN:
        # projected on its index curve, discounted on the currency's
        # default OIS curve; capped/floored coupons become clamp slots
        disc_id = basket.curve_id(_DEFAULT_OIS[inst._currency])
        proj_id = basket.curve_id(inst._floating_index.name)
        idx_curve = basket.curves[proj_id]
        fx = _fx_to_base(model, inst._currency, base)
        lt = _frn_tensor(inst, value_dt, index_dc=idx_curve._dc_type)
        rows.append(_float_row(lt, disc_id, proj_id, fx, trade_id,
                               clamp_rows))

    elif itype == InstrumentTypes.BOND:
        disc_id = basket.curve_id(_DEFAULT_OIS[inst._currency])
        fx = _fx_to_base(model, inst._currency, base)
        ft = _bond_tensor(inst, value_dt)
        amounts = np.asarray(ft.payments, dtype=np.float64).copy()
        amounts[-1] += float(ft.principal)
        rows.append(_fixed_row(ft.payment_times, amounts, disc_id, fx,
                               1.0, trade_id))

    elif itype in (InstrumentTypes.ZCIS,
                   InstrumentTypes.YOY_INFLATION_SWAP):
        index = inst._inflation_index
        ccy = index._currency
        disc_id = basket.curve_id(_DEFAULT_OIS[ccy])
        infl_id = _infl_curve_id(basket, inst)
        infl_curve = basket.curves[infl_id]
        base_cpi = float(infl_curve._base_cpi)
        fx = _fx_to_base(model, ccy, base)

        if itype == InstrumentTypes.ZCIS:
            # one exchange: fixed N[(1+r)^T − 1] vs inflation
            # N[I_T/I_b − 1], both discounted at the ACT/365F payment time
            if inst._payment_dt > value_dt:
                pay_t = times_from_dates(inst._payment_dt, value_dt,
                                         DayCountTypes.ACT_365F)
                fixed_sign = -1.0 if inst._fixed_leg_type == SwapTypes.PAY \
                    else 1.0
                yf = inst.year_frac()
                fixed_amt = inst._notional \
                    * ((1.0 + inst._fixed_rate) ** yf - 1.0)
                row = dict(trade=trade_id, disc=disc_id, proj=infl_id,
                           fix_t=[float(pay_t)],
                           fix_amt=[fx * fixed_sign * fixed_amt],
                           fix_m=[1.0], flt=_empty_flt())
                b_ref = _cpi_ref(index, infl_curve, inst._effective_dt,
                                 value_dt)
                f_ref = _cpi_ref(index, infl_curve, inst._maturity_dt,
                                 value_dt)
                _infl_payment(f_ref, b_ref, base_cpi,
                              fx * (-fixed_sign) * inst._notional, 0.0,
                              pay_t, row)
                rows.append(row)
        else:
            # YoY: the periodic fixed leg + the YoY ratio leg
            ft = inst._fixed_leg.tensor(value_dt)
            rows.append(_fixed_row(ft.payment_times,
                                   np.asarray(ft.payments), disc_id, fx,
                                   float(ft.leg_sign), trade_id))
            leg = inst._inflation_leg
            sign = 1.0 if leg._leg_type == SwapTypes.RECEIVE else -1.0
            row = dict(trade=trade_id, disc=disc_id, proj=infl_id,
                       fix_t=[], fix_amt=[], fix_m=[], flt=_empty_flt())
            for i in range(len(leg._payment_dts)):
                if leg._payment_dts[i] <= value_dt:
                    continue
                s_ref = _cpi_ref(index, infl_curve, leg._yoy_start_dts[i],
                                 value_dt)
                e_ref = _cpi_ref(index, infl_curve, leg._yoy_end_dts[i],
                                 value_dt)
                pay_t = times_from_dates(leg._payment_dts[i], value_dt,
                                         leg._dc_type)
                w = fx * sign * float(leg._notional) \
                    * float(leg._year_fracs[i])
                _infl_payment(e_ref, s_ref, base_cpi, w,
                              float(leg._spread), pay_t, row)
            rows.append(row)

    else:
        raise LibError(f"MultiBook does not support {itype}")

    return rows


def compile_multibook(instruments, model,
                      base_currency: CurrencyTypes = CurrencyTypes.GBP,
                      curve_names: Optional[List[str]] = None,
                      n_buckets: int = 4,
                      recalibrate_xccy: bool = True,
                      collateral_types: Optional[Sequence] = None,
                      batch_curves: bool = True,
                      stage_buckets: str = "fine") -> MultiBook:
    """Compile a multi-currency book against a Model (host numpy).

    Returns a MultiBook whose rows gather from the COMPACTED flat DF
    vector produced by ``basket.grids`` (only the (curve, time) pairs the
    book references); all PVs are in ``base_currency``.

    ``collateral_types``: optional per-trade CollateralType list (None
    entries = natural collateral). An OIS whose collateral currency
    differs from its own discounts on the {CCY}_{COLL}_XCCY curve.
    ``batch_curves``: record the basket's stage topology, so the risk
    pass takes the structured per-stage split; with False it takes the
    generic split (the grids are the same batched stages either way).
    ``stage_buckets``: "fine" (default) or "coarse" — OIS stage-group
    shape-bucket coarseness, see curve_batching.build_batched_grids.
    """
    if collateral_types is not None \
            and len(collateral_types) != len(instruments):
        raise LibError("collateral_types must parallel instruments")

    basket = CurveBasket(model, curve_names,
                         recalibrate_xccy=recalibrate_xccy)
    basket.batch_curves = batch_curves
    value_dt = model.value_dt

    clamp_rows: list = []
    rows: list = []
    with timed("multibook.compile", trades=len(instruments),
               curves=basket.n_curves):
        for t_id, inst in enumerate(instruments):
            coll = collateral_types[t_id] if collateral_types else None
            rows += _rows_for_instrument(inst, model, basket,
                                         base_currency, value_dt, t_id,
                                         clamp_rows,
                                         collateral_type=coll)

    intern = _Interner()
    intern.add(0.0)

    # First pass: intern every (time) once; rows store temp indices.
    for r in rows:
        r["fix_ti"] = [intern.add(t) for t in r["fix_t"]]
        r["flt_pi"] = [intern.add(t) for t in r["flt"]["pay"]]
        r["flt_si"] = [intern.add(t) for t in r["flt"]["s"]]
        r["flt_ei"] = [intern.add(t) for t in r["flt"]["e"]]
    for c in clamp_rows:
        c["si"] = intern.add(c["s"][1])
        c["ei"] = intern.add(c["e"][1])
        c["pi"] = intern.add(c["p"][1])

    unique_times, remap = intern.finish()
    U = unique_times.shape[0]

    def gidx(curve_id, tmp):
        return curve_id * U + int(remap[tmp])

    # Bucket rows by padded length.
    def row_size(r):
        return max(len(r["fix_ti"]),
                   len(r["flt_pi"]), 1)

    order = np.argsort([row_size(r) for r in rows], kind="stable")
    n = len(rows)
    bounds = np.linspace(0, n, min(n_buckets, n) + 1).astype(int)
    spans = []
    sizes_sorted = [row_size(rows[i]) for i in order]
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        if hi <= lo:
            continue
        pad = max(sizes_sorted[lo:hi])
        if spans and spans[-1][2] == pad:
            spans[-1] = (spans[-1][0], hi, pad)
        else:
            spans.append((lo, hi, pad))

    buckets = []
    for lo, hi, P in spans:
        sel = [rows[i] for i in order[lo:hi]]
        R = len(sel)
        arr = dict(
            fix_idx=np.zeros((R, P), dtype=np.int32),
            fix_payments=np.zeros((R, P)),
            fix_mask=np.zeros((R, P)),
            flt_pay_idx=np.zeros((R, P), dtype=np.int32),
            flt_start_idx=np.zeros((R, P), dtype=np.int32),
            flt_end_idx=np.zeros((R, P), dtype=np.int32),
            flt_pay_alphas=np.zeros((R, P)),
            flt_index_alphas=np.zeros((R, P)),
            flt_spreads=np.zeros((R, P)),
            flt_notionals=np.zeros((R, P)),
            flt_mask=np.zeros((R, P)),
            row_trade=np.zeros(R, dtype=np.int32))
        for k, r in enumerate(sel):
            arr["row_trade"][k] = r["trade"]
            nf = len(r["fix_ti"])
            arr["fix_idx"][k, :nf] = [gidx(r["disc"], t)
                                      for t in r["fix_ti"]]
            arr["fix_payments"][k, :nf] = r["fix_amt"]
            arr["fix_mask"][k, :nf] = r["fix_m"]
            nl = len(r["flt_pi"])
            arr["flt_pay_idx"][k, :nl] = [gidx(r["disc"], t)
                                          for t in r["flt_pi"]]
            arr["flt_start_idx"][k, :nl] = [gidx(r["proj"], t)
                                            for t in r["flt_si"]]
            arr["flt_end_idx"][k, :nl] = [gidx(r["proj"], t)
                                          for t in r["flt_ei"]]
            arr["flt_pay_alphas"][k, :nl] = r["flt"]["pa"]
            arr["flt_index_alphas"][k, :nl] = r["flt"]["ia"]
            arr["flt_spreads"][k, :nl] = r["flt"]["sp"]
            arr["flt_notionals"][k, :nl] = r["flt"]["no"]
            arr["flt_mask"][k, :nl] = r["flt"]["m"]
        buckets.append(MultiBookRows(**arr))

    clamp = None
    if clamp_rows:
        clamp = ClampSlots(
            s_idx=np.array([gidx(c["s"][0], c["si"]) for c in clamp_rows],
                           dtype=np.int32),
            e_idx=np.array([gidx(c["e"][0], c["ei"]) for c in clamp_rows],
                           dtype=np.int32),
            p_idx=np.array([gidx(c["p"][0], c["pi"]) for c in clamp_rows],
                           dtype=np.int32),
            ia=np.array([c["ia"] for c in clamp_rows]),
            w=np.array([c["w"] for c in clamp_rows]),
            spread=np.array([c["spread"] for c in clamp_rows]),
            cap=np.array([c["cap"] for c in clamp_rows]),
            floor=np.array([c["floor"] for c in clamp_rows]),
            slot_trade=np.array([c["trade"] for c in clamp_rows],
                                dtype=np.int32))

    # ---- grid compaction ------------------------------------------------
    # Keep only the (curve, time) pairs the book's index tables reference
    # (the dense [C*U] layout evaluates every curve at every unique time,
    # and the grid axis is the risk pass's tangent width): remap every
    # index table onto the compacted axis (global index order is
    # preserved, so the compact axis is still curve-major). A curve no
    # trade references keeps no column, so its quotes get exactly-zero
    # risk.
    used = np.zeros(basket.n_curves * U, dtype=bool)
    used[0] = True                    # dead-slot target (curve 0, t=0)
    for b in buckets:
        for nm in ("fix_idx", "flt_pay_idx", "flt_start_idx",
                   "flt_end_idx"):
            used[np.asarray(getattr(b, nm)).ravel()] = True
    if clamp is not None:
        for nm in ("s_idx", "e_idx", "p_idx"):
            used[np.asarray(getattr(clamp, nm))] = True
    grid_sel = np.flatnonzero(used).astype(np.int32)
    new_of_old = np.full(basket.n_curves * U, -1, dtype=np.int32)
    new_of_old[grid_sel] = np.arange(grid_sel.shape[0], dtype=np.int32)

    def _remap(idx):
        return new_of_old[np.asarray(idx)].astype(np.int32)

    buckets = [dataclasses.replace(
        b, fix_idx=_remap(b.fix_idx), flt_pay_idx=_remap(b.flt_pay_idx),
        flt_start_idx=_remap(b.flt_start_idx),
        flt_end_idx=_remap(b.flt_end_idx)) for b in buckets]
    if clamp is not None:
        clamp = dataclasses.replace(
            clamp, s_idx=_remap(clamp.s_idx), e_idx=_remap(clamp.e_idx),
            p_idx=_remap(clamp.p_idx))

    referenced = {r["disc"] for r in rows} | {r["proj"] for r in rows} \
        | {c[k][0] for c in clamp_rows for k in ("s", "e", "p")}
    idle = [s.name for i, s in enumerate(basket.specs) if i not in referenced]
    if idle:
        warnings.warn(f"no trade references curve(s) {idle}: their quotes "
                      f"carry exactly zero delta and gamma", stacklevel=2)

    n_grid = int(grid_sel.shape[0])
    agg = _aggregate(buckets, n_grid)
    cols = _build_cols(buckets, agg, n_grid, n_buckets)
    basket.grids = basket.grids_fn(unique_times,
                                   stage_buckets=stage_buckets,
                                   grid_sel=grid_sel)

    return MultiBook(basket=basket, unique_times=unique_times,
                     buckets=tuple(buckets), clamp=clamp, aggregate=agg,
                     n_trades=len(instruments),
                     base_currency=base_currency, cols=cols)


def _optimal_spans(sizes_sorted: np.ndarray, k: int):
    """Partition the SORTED slot-count list into <= k contiguous spans
    minimizing total padded slots sum((hi-lo) * max_size_in_span). The DP
    runs over DISTINCT sizes (span boundaries only ever sit at size
    changes), so it is O(d^2 k) with d <= max row length."""
    ends = np.flatnonzero(np.diff(sizes_sorted, append=-1)) + 1
    d = len(ends)
    starts = np.concatenate([[0], ends[:-1]])
    size_of = sizes_sorted[ends - 1]
    k = min(k, d)
    INF = float("inf")
    # best[j][g] = min padded cost covering groups [0, g) with j spans
    best = np.full((k + 1, d + 1), INF)
    best[0][0] = 0.0
    choice = np.zeros((k + 1, d + 1), dtype=np.int64)
    for j in range(1, k + 1):
        for g in range(1, d + 1):
            hi = ends[g - 1]
            for g0 in range(g):
                if best[j - 1][g0] == INF:
                    continue
                lo = starts[g0]
                c = best[j - 1][g0] + (hi - lo) * size_of[g - 1]
                if c < best[j][g]:
                    best[j][g] = c
                    choice[j][g] = g0
    spans = []
    g = d
    j = int(np.argmin(best[:, d]))
    while g > 0:
        g0 = choice[j][g]
        spans.append((int(starts[g0]), int(ends[g - 1])))
        g = g0
        j -= 1
    return spans[::-1]


def _build_cols(buckets, agg: MultiBookAggregate, CU: int,
                n_buckets: int) -> Tuple[ColRows, ...]:
    """Derive the column representation from the padded buckets: one
    (col, w) slot per live fixed coupon / spread term / forward term,
    with forward terms remapped onto the aggregate's deduplicated trip
    table (trip t's column is CU + t)."""
    uniq_key = ((agg.trip_s.astype(np.int64) * CU
                 + agg.trip_e.astype(np.int64)) * CU
                + agg.trip_p.astype(np.int64))
    slots = []                       # (trade, [(col, w), ...])
    for b in buckets:
        R = b.fix_idx.shape[0]
        fix_idx = np.asarray(b.fix_idx)
        fix_w = np.asarray(b.fix_payments) * np.asarray(b.fix_mask)
        pay = np.asarray(b.flt_pay_idx)
        spr_w = (np.asarray(b.flt_spreads) * np.asarray(b.flt_pay_alphas)
                 * np.asarray(b.flt_notionals) * np.asarray(b.flt_mask))
        ia = np.asarray(b.flt_index_alphas)
        pa = np.asarray(b.flt_pay_alphas)
        ratio = np.where(ia > 0.0, pa / np.where(ia > 0.0, ia, 1.0), 0.0)
        fwd_w = (np.asarray(b.flt_notionals) * ratio
                 * np.asarray(b.flt_mask))
        key = ((np.asarray(b.flt_start_idx).astype(np.int64) * CU
                + np.asarray(b.flt_end_idx).astype(np.int64)) * CU
               + pay.astype(np.int64))
        trip_col = CU + np.searchsorted(uniq_key, key)
        row_trade = np.asarray(b.row_trade)
        for k in range(R):
            s: list = []
            live = fix_w[k] != 0.0
            s += list(zip(fix_idx[k][live].tolist(),
                          fix_w[k][live].tolist()))
            live = spr_w[k] != 0.0
            s += list(zip(pay[k][live].tolist(), spr_w[k][live].tolist()))
            live = fwd_w[k] != 0.0
            s += list(zip(trip_col[k][live].tolist(),
                          fwd_w[k][live].tolist()))
            slots.append((int(row_trade[k]), s))

    order = sorted(range(len(slots)), key=lambda i: len(slots[i][1]))
    sizes_sorted = np.array([len(slots[i][1]) for i in order])
    # the sweep's traffic is proportional to PADDED slots, so the column
    # form gets more spans than the row buckets
    spans = _optimal_spans(sizes_sorted, max(n_buckets, 8)) \
        if len(slots) else []
    cols = []
    for lo, hi in spans:
        sel = [slots[i] for i in order[lo:hi]]
        L = max(max((len(s) for _, s in sel), default=1), 1)
        R = len(sel)
        ci = np.zeros((R, L), dtype=np.int32)
        wi = np.zeros((R, L))
        rt = np.zeros(R, dtype=np.int32)
        for k, (t, s) in enumerate(sel):
            rt[k] = t
            for j, (c, w) in enumerate(s):
                ci[k, j] = c
                wi[k, j] = w
        cols.append(ColRows(col_idx=ci, w=wi, row_trade=rt))
    return tuple(cols)


def _aggregate(buckets, CU: int) -> MultiBookAggregate:
    """Collapse the linear rows to aggregate weights (host-side)."""
    w_lin = np.zeros(CU)
    ss, ee, pp, ww = [], [], [], []
    for b in buckets:
        fix_idx = np.asarray(b.fix_idx).ravel()
        fix_w = (np.asarray(b.fix_payments)
                 * np.asarray(b.fix_mask)).ravel()
        w_lin += np.bincount(fix_idx, weights=fix_w, minlength=CU)

        pay = np.asarray(b.flt_pay_idx).ravel()
        spread_w = (np.asarray(b.flt_spreads)
                    * np.asarray(b.flt_pay_alphas)
                    * np.asarray(b.flt_notionals)
                    * np.asarray(b.flt_mask)).ravel()
        w_lin += np.bincount(pay, weights=spread_w, minlength=CU)

        ia = np.asarray(b.flt_index_alphas)
        pa = np.asarray(b.flt_pay_alphas)
        scale = np.where(ia > 0.0, pa / np.where(ia > 0.0, ia, 1.0), 0.0)
        w = (np.asarray(b.flt_notionals) * scale
             * np.asarray(b.flt_mask)).ravel()
        live = w != 0.0
        ss.append(np.asarray(b.flt_start_idx).ravel()[live])
        ee.append(np.asarray(b.flt_end_idx).ravel()[live])
        pp.append(pay[live])
        ww.append(w[live])

    s = np.concatenate(ss) if ss else np.zeros(0, dtype=np.int64)
    e = np.concatenate(ee) if ee else np.zeros(0, dtype=np.int64)
    p = np.concatenate(pp) if pp else np.zeros(0, dtype=np.int64)
    w = np.concatenate(ww) if ww else np.zeros(0)
    key = (s.astype(np.int64) * CU + e) * CU + p
    uniq, inverse = np.unique(key, return_inverse=True)
    trip_w = np.bincount(inverse, weights=w)
    return MultiBookAggregate(
        w_lin=w_lin,
        trip_s=(uniq // (CU * CU)).astype(np.int32),
        trip_e=((uniq // CU) % CU).astype(np.int32),
        trip_p=(uniq % CU).astype(np.int32),
        trip_w=trip_w)


def tile_multibook(mb: MultiBook, n_copies: int,
                   notional_scale=None,
                   materialize: bool = False) -> MultiBook:
    """Scale a compiled multibook up by tiling its rows with per-copy
    notional multipliers (copies share schedules and curves; amounts
    differ). Trade k of copy c becomes trade c * B + k.

    Default is lazy: the returned book keeps the base tables plus a
    TileSpec, and the device functions expand them on the device.
    ``materialize=True`` builds the full numpy tables on the host instead
    (``adrates_tpu`` ``multibook.py:1306-1355``), as ``shard_multibook``
    needs."""
    if notional_scale is None:
        notional_scale = np.ones(n_copies)
    scale = np.asarray(notional_scale, dtype=np.float64)
    B = mb.n_trades
    if mb.tile is not None:
        raise LibError("multibook is already lazily tiled")
    if not materialize:
        total = float(scale.sum())
        agg = MultiBookAggregate(
            w_lin=np.asarray(mb.aggregate.w_lin) * total,
            trip_s=mb.aggregate.trip_s, trip_e=mb.aggregate.trip_e,
            trip_p=mb.aggregate.trip_p,
            trip_w=np.asarray(mb.aggregate.trip_w) * total)
        return dataclasses.replace(
            mb, aggregate=agg, n_trades=B * n_copies,
            tile=TileSpec(scale=scale, base_trades=B))

    def tile(x, amount=False, trade=False):
        x = np.asarray(x)
        tiled = np.tile(x, (n_copies,) + (1,) * (x.ndim - 1))
        if amount:
            reps = np.repeat(scale, x.shape[0])
            tiled = tiled * reps.reshape((-1,) + (1,) * (x.ndim - 1))
        if trade:
            tiled = tiled + np.repeat(
                np.arange(n_copies, dtype=np.int32) * B, x.shape[0])
        return tiled

    buckets = tuple(MultiBookRows(
        fix_idx=tile(b.fix_idx),
        fix_payments=tile(b.fix_payments, amount=True),
        fix_mask=tile(b.fix_mask),
        flt_pay_idx=tile(b.flt_pay_idx),
        flt_start_idx=tile(b.flt_start_idx),
        flt_end_idx=tile(b.flt_end_idx),
        flt_pay_alphas=tile(b.flt_pay_alphas),
        flt_index_alphas=tile(b.flt_index_alphas),
        flt_spreads=tile(b.flt_spreads),
        flt_notionals=tile(b.flt_notionals, amount=True),
        flt_mask=tile(b.flt_mask),
        row_trade=tile(b.row_trade, trade=True).astype(np.int32),
    ) for b in mb.buckets)
    clamp = None
    if mb.clamp is not None:
        c = mb.clamp
        clamp = ClampSlots(
            s_idx=tile(c.s_idx).astype(np.int32),
            e_idx=tile(c.e_idx).astype(np.int32),
            p_idx=tile(c.p_idx).astype(np.int32),
            ia=tile(c.ia), w=tile(c.w, amount=True),
            spread=tile(c.spread), cap=tile(c.cap), floor=tile(c.floor),
            slot_trade=tile(c.slot_trade, trade=True).astype(np.int32))
    cols = tuple(ColRows(
        col_idx=tile(cb.col_idx).astype(np.int32),
        w=tile(cb.w, amount=True),
        row_trade=tile(cb.row_trade, trade=True).astype(np.int32),
    ) for cb in mb.cols)
    return dataclasses.replace(
        mb, buckets=buckets, clamp=clamp,
        aggregate=_aggregate(buckets, mb.basket.n_grid),
        n_trades=B * n_copies, cols=cols)


def _term1_trip_groups(basket, agg: MultiBookAggregate):
    """Host-side signature grouping of the trip table for the quad form:
    a trip's three J columns are nonzero ONLY on the quote slots of the
    curves they belong to (plus XCCY parents when the basket
    recalibrates them), so the [N, T] @ [T, N] contraction can run at
    each group's closed quote width k instead of full N. Groups may share
    quote rows (every XCCY group holds its parents'). Returns a list of
    dicts of static int index arrays (``tsel`` into the trip table,
    ``s_idx``/``e_idx``/``p_idx``, the group's quote ``segs`` and width
    ``k``), or None when the basket lacks grid metadata."""
    curve_of = getattr(basket, "grid_curve_of", None)
    if curve_of is None or agg.trip_s.shape[0] == 0:
        return None
    curve_of = np.asarray(curve_of)
    specs = basket.specs

    def contrib(cid):
        s = {int(cid)}
        sp = specs[int(cid)]
        if sp.kind == "xccy" and basket.recalibrate_xccy:
            s |= {sp.dom_id, sp.for_id}
        return s

    ts = np.asarray(agg.trip_s)
    te = np.asarray(agg.trip_e)
    tp = np.asarray(agg.trip_p)
    cs, ce, cp = curve_of[ts], curve_of[te], curve_of[tp]
    sig_cache: Dict[tuple, frozenset] = {}
    by_sig: Dict[frozenset, List[int]] = {}
    for t in range(ts.shape[0]):
        key = (int(cs[t]), int(ce[t]), int(cp[t]))
        sig = sig_cache.get(key)
        if sig is None:
            sig = frozenset(contrib(key[0]) | contrib(key[1])
                            | contrib(key[2]))
            sig_cache[key] = sig
        by_sig.setdefault(sig, []).append(t)

    groups = []
    for sig, tidx in sorted(by_sig.items(),
                            key=lambda kv: sorted(kv[0])):
        raw = sorted((specs[c].offset, specs[c].n_quotes) for c in sig)
        segs: List[tuple] = []
        for off, n in raw:                  # merge adjacent quote slices
            if segs and segs[-1][0] + segs[-1][1] == off:
                segs[-1] = (segs[-1][0], segs[-1][1] + n)
            else:
                segs.append((off, n))
        tsel = np.asarray(tidx, dtype=np.int32)
        groups.append(dict(
            tsel=tsel,
            s_idx=ts[tsel].astype(np.int32),
            e_idx=te[tsel].astype(np.int32),
            p_idx=tp[tsel].astype(np.int32),
            segs=tuple(segs),
            k=sum(n for _, n in segs)))
    return groups


# ---------------------------------------------------------------------------
# device layer
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BookInputs:
    """Everything the device layer needs from a compiled book, as host
    numpy: ``make_multibook_fn`` builds it from a MultiBook, and
    ``interop.multibook_from_numpy`` from another package's arrays."""
    grids: Callable                  # (qvec, P) -> flat DFs [n_grid]
    bat: dict                        # host stage plans (P["bat"] source)
    grid_sel: Optional[np.ndarray]   # None = dense grid
    cols: Tuple[ColRows, ...]
    clamp: Optional[ClampSlots]
    aggregate: MultiBookAggregate
    groups: Optional[list]           # _term1_trip_groups
    n_grid: int
    n_quotes: int
    n_trades: int
    tile: Optional[TileSpec] = None
    # the stage topology for the structured risk split; None = the
    # generic split (a book compiled with batch_curves=False)
    topology: Optional[StageTopology] = None


def book_inputs(mb: MultiBook) -> BookInputs:
    basket = mb.basket
    return BookInputs(
        grids=basket.grids, bat=basket.bat,
        grid_sel=None if basket.grid_dense else basket.grid_sel,
        cols=mb.cols, clamp=mb.clamp, aggregate=mb.aggregate,
        groups=_term1_trip_groups(basket, mb.aggregate),
        n_grid=basket.n_grid, n_quotes=basket.n_quotes,
        n_trades=mb.n_trades, tile=mb.tile,
        topology=basket.topology() if basket.batch_curves else None)


@dataclasses.dataclass
class DeviceBook:
    """The device tables ``make_multibook_fn`` runs on (``fn.book``):
    the book expanded to full size, the kernels' static tables."""
    grids: Callable
    params: dict
    aggregate: MultiBookAggregate
    clamp: Optional[ClampSlots]      # per-trade slots (tiled)
    clamp_agg: Optional[ClampSlots]  # the aggregate's view of them
    sweep: Optional[kernels.SweepTables]  # K1: per-trade CSR, trade blocks
    quad: Optional[kernels.QuadTables]    # K2: trip groups, reduction table


def _f64(a, device) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float64, device=device)


def _i32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.int32), device=device)


def _i64(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)


def _agg_to(agg: MultiBookAggregate, device) -> MultiBookAggregate:
    return MultiBookAggregate(
        w_lin=_f64(agg.w_lin, device), trip_s=_i64(agg.trip_s, device),
        trip_e=_i64(agg.trip_e, device), trip_p=_i64(agg.trip_p, device),
        trip_w=_f64(agg.trip_w, device))


def _clamp_to(c: ClampSlots, device) -> ClampSlots:
    return ClampSlots(
        s_idx=_i64(c.s_idx, device), e_idx=_i64(c.e_idx, device),
        p_idx=_i64(c.p_idx, device), ia=_f64(c.ia, device),
        w=_f64(c.w, device), spread=_f64(c.spread, device),
        cap=_f64(c.cap, device), floor=_f64(c.floor, device),
        slot_trade=_i64(c.slot_trade, device))


def _expand_cols(cb: ColRows, scale: torch.Tensor,
                 base_trades: int) -> ColRows:
    """Expand a lazily tiled column bucket on the device: the base rows
    repeated per copy (copy-major), weights scaled by the copy's notional
    multiplier, trades offset by copy * base_trades."""
    n = scale.shape[0]
    R, L = cb.col_idx.shape
    copies = torch.arange(n, dtype=cb.row_trade.dtype,
                          device=cb.row_trade.device)
    return ColRows(
        col_idx=cb.col_idx.repeat(n, 1),
        w=(scale[:, None, None] * cb.w[None]).reshape(n * R, L),
        row_trade=(cb.row_trade[None, :]
                   + (copies * base_trades)[:, None]).reshape(-1))


def _expand_clamp(c: ClampSlots, scale: torch.Tensor,
                  base_trades: int) -> ClampSlots:
    n = scale.shape[0]
    copies = torch.arange(n, dtype=c.slot_trade.dtype,
                          device=c.slot_trade.device)

    def rep(x):
        return x.repeat(n)

    return ClampSlots(
        s_idx=rep(c.s_idx), e_idx=rep(c.e_idx), p_idx=rep(c.p_idx),
        ia=rep(c.ia), w=(scale[:, None] * c.w[None, :]).reshape(-1),
        spread=rep(c.spread), cap=rep(c.cap), floor=rep(c.floor),
        slot_trade=(c.slot_trade[None, :]
                    + (copies * base_trades)[:, None]).reshape(-1))


def _trip_values(dfs_flat: torch.Tensor,
                 agg: MultiBookAggregate) -> torch.Tensor:
    """The [..., T] forward-triple value table for the column sweep."""
    return ((dfs_flat[..., agg.trip_s] / dfs_flat[..., agg.trip_e] - 1.0)
            * dfs_flat[..., agg.trip_p])


def _clamp_pvs(dfs_flat: torch.Tensor, c: ClampSlots) -> torch.Tensor:
    df_s = dfs_flat[c.s_idx]
    df_e = dfs_flat[c.e_idx]
    df_p = dfs_flat[c.p_idx]
    fwd = torch.where(c.ia > 0.0, (df_s / df_e - 1.0)
                      / torch.where(c.ia > 0.0, c.ia, 1.0), 0.0)
    rate = torch.clamp(fwd + c.spread, c.floor, c.cap)
    return c.w * rate * df_p


def aggregate_total(dfs_flat: torch.Tensor, agg: MultiBookAggregate,
                    clamp: Optional[ClampSlots]) -> torch.Tensor:
    """Total book PV — O(U + T + K) regardless of trade count."""
    lin = torch.sum(agg.w_lin * dfs_flat)
    trip = torch.sum(agg.trip_w * _trip_values(dfs_flat, agg))
    total = lin + trip
    if clamp is not None:
        total = total + torch.sum(_clamp_pvs(dfs_flat, clamp))
    return total


def _clamp_quad_form(J: torch.Tensor, dfs_flat: torch.Tensor,
                     clamp: ClampSlots) -> torch.Tensor:
    """The cap/floor slots' contribution to Jᵀ·H_agg·J for one scenario
    (J [N, n_grid]). PV = w·clip((u/v-1)/ia + spread, lo, hi)·p; the
    clipped rate's u/v partials vanish outside the cap/floor band."""
    u = dfs_flat[clamp.s_idx]
    v = dfs_flat[clamp.e_idx]
    p = dfs_flat[clamp.p_idx]
    has = clamp.ia > 0.0
    ia = torch.where(has, clamp.ia, 1.0)
    pre = torch.where(has, (u / v - 1.0) / ia, 0.0) + clamp.spread
    inside = ((pre > clamp.floor) & (pre < clamp.cap)) & has
    wI = clamp.w * inside.to(u.dtype)
    Ju = J[:, clamp.s_idx]
    Jv = J[:, clamp.e_idx]
    Jp = J[:, clamp.p_idx]
    g_uv = -wI * p / (ia * v * v)
    g_up = wI / (ia * v)
    g_vp = -wI * u / (ia * v * v)
    g_vv = 2.0 * wI * p * u / (ia * v * v * v)
    Gc = (Ju * g_uv[None, :]) @ Jv.T
    Gc = Gc + (Ju * g_up[None, :]) @ Jp.T
    Gc = Gc + (Jv * g_vp[None, :]) @ Jp.T
    Gc = Gc + Gc.T
    return Gc + (Jv * g_vv[None, :]) @ Jv.T


def _scenario_risk(grids, q: torch.Tensor, P: dict,
                   agg: MultiBookAggregate, clamp_agg: Optional[ClampSlots],
                   want_gamma: bool) -> dict:
    """Delta and the curve-Hessian part of gamma for ONE scenario via the
    chain-rule split:

        delta = J @ g,
        gamma = Jᵀ·H_agg·J  +  Σ_k g_k · ∂²dfs_k/∂q∂q

    with J = ∂dfs/∂q by ``vmap(jvp)`` over the N unit seeds, g =
    ∂total/∂dfs one ``grad`` of the O(n_grid + T) aggregate, and the
    curve-Hessian term one ``jacfwd(grad(.))`` of the scalar g₀·dfs(q)
    (g₀ detached). The quad form Jᵀ·H_agg·J is left to the caller (the
    K2 kernel runs outside ``vmap``). Returns dfs, J, delta and (with
    ``want_gamma``) term2."""
    def f(x):
        return grids(x, P)

    N = q.shape[0]
    eye = torch.eye(N, dtype=q.dtype, device=q.device)
    dfs_b, J = vmap(lambda v: jvp(f, (q,), (v,)))(eye)    # [N, n_grid]
    dfs = dfs_b[0]
    g = grad(lambda d: aggregate_total(d, agg, clamp_agg))(dfs)
    out = {"dfs": dfs, "J": J, "delta": J @ g}
    if want_gamma:
        g0 = g.detach()
        out["term2"] = jacfwd(grad(lambda x: torch.dot(g0, f(x))))(q)
    return out


def _even_rows(top: torch.Tensor, bottom: torch.Tensor,
               dtype=None) -> torch.Tensor:
    """[top; bottom] ([M, S]) in ``dtype`` (default ``top``'s) as a view
    of a buffer whose rows hold whole 16-byte pieces, so every row
    starts on a 16-byte boundary (K1's layout)."""
    dtype = top.dtype if dtype is None else dtype
    S = top.shape[1]
    buf = torch.empty((top.shape[0] + bottom.shape[0],
                       S + (-S) % (16 // dtype.itemsize)),
                      dtype=dtype, device=top.device)
    out = buf[:, :S]
    out[:top.shape[0]] = top
    out[top.shape[0]:] = bottom
    return out


def value_table(dfs_all: torch.Tensor,
                agg: MultiBookAggregate) -> torch.Tensor:
    """The [M, S] value table of the sweep (DF columns then trip values,
    one S-row per column), rows 16-byte aligned."""
    return _even_rows(dfs_all.T, _trip_values(dfs_all, agg).T)


def clamp_epilogue(pvs: torch.Tensor, dfs_all: torch.Tensor,
                   clamp: ClampSlots) -> torch.Tensor:
    """The cap/floor clamp slots' PVs [S, K] added to their trades'
    columns of ``pvs`` [S, B]: the sweep's torch epilogue
    (``adrates_tpu/parallel/multibook.py:1823-1834``)."""
    df_s = dfs_all[:, clamp.s_idx]                          # [S, K]
    df_e = dfs_all[:, clamp.e_idx]
    df_p = dfs_all[:, clamp.p_idx]
    has = clamp.ia > 0.0
    ia = torch.where(has, clamp.ia, 1.0)
    fwd = torch.where(has, (df_s / df_e - 1.0) / ia, 0.0)
    rate = torch.clamp(fwd + clamp.spread, clamp.floor, clamp.cap)
    return pvs.index_add(1, clamp.slot_trade, clamp.w * rate * df_p)


def _pvs_sweep(dfs_all: torch.Tensor, sweep: kernels.SweepTables,
               clamp: Optional[ClampSlots],
               agg: MultiBookAggregate) -> torch.Tensor:
    """Per-trade PVs [S, B] for all scenarios at once: the value table
    through the K1 kernel, then the cap/floor clamp epilogue in torch."""
    pvs = kernels.pvs_sweep(value_table(dfs_all, agg), sweep)   # [S, B]
    if clamp is not None:
        pvs = clamp_epilogue(pvs, dfs_all, clamp)
    return pvs


def risk_chunk_size(n_quotes: int, width: int, n_scen: int) -> int:
    """Scenarios per risk chunk: three [chunk, N, width] f64 stacks
    within RISK_CHUNK_BYTES, at least 1 and at most ``n_scen``. The
    generic split's stacks run at the dense stage width (C*U before
    compaction), the structured split's at the book's grid width."""
    per = 3 * n_quotes * width * 8
    return max(1, min(n_scen, RISK_CHUNK_BYTES // max(per, 1)))


def expanded_cols(inp: BookInputs, device) -> List[ColRows]:
    """The book's column buckets on ``device``, a lazily tiled book
    expanded (copy-major)."""
    cols = [ColRows(col_idx=_i32(cb.col_idx, device),
                    w=_f64(cb.w, device),
                    row_trade=_i64(cb.row_trade, device))
            for cb in inp.cols]
    if inp.tile is not None:
        scale = _f64(inp.tile.scale, device)
        base = int(inp.tile.base_trades)
        cols = [_expand_cols(cb, scale, base) for cb in cols]
    return cols


def sweep_tables_from_cols(cols: Sequence[ColRows], n_trades: int,
                           n_cols: int) -> kernels.SweepTables:
    """K1's per-trade CSR from the (expanded) column buckets, on their
    device: every padded slot flattened, then ``kernels.sweep_tables``."""
    def flat(f):
        return torch.cat([f(cb).reshape(-1) for cb in cols])

    return kernels.sweep_tables(
        flat(lambda cb: cb.row_trade[:, None].expand(cb.col_idx.shape)),
        flat(lambda cb: cb.col_idx), flat(lambda cb: cb.w), n_trades, n_cols)


def trip_group_arrays(groups, agg: MultiBookAggregate) -> list:
    """``_term1_trip_groups``' groups (host numpy) as the dicts
    ``kernels.quad_tables`` takes: quote rows from the segments, weights
    from the host aggregate."""
    trip_w = np.asarray(agg.trip_w)
    return [dict(s_idx=g["s_idx"], e_idx=g["e_idx"], p_idx=g["p_idx"],
                 rows=np.concatenate([np.arange(off, off + n)
                                      for off, n in g["segs"]]),
                 w=trip_w[np.asarray(g["tsel"])])
            for g in (groups or [])]


def _device_book(inp: BookInputs, device, sweep: bool = True,
                 quad: bool = True) -> DeviceBook:
    """The book's tables on ``device``, a lazily tiled book expanded;
    K1's ``sweep`` tables with the per-trade clamp slots, and K2's
    ``quad`` tables, only where asked for (the per-trade gammas need
    neither, the ladders no ``quad``, the sharded paths take their own
    trades' part of the sweep). Without the sweep, ``clamp`` is None."""
    P = {"bat": bat_to_torch(inp.bat, device),
         "grid_sel": None if inp.grid_sel is None
         else _i64(inp.grid_sel, device)}
    if inp.topology is not None:
        from .structured_risk import ois_stage_tables, xccy_stage_tables
        P["xstage"] = xccy_stage_tables(inp.topology, device)
        P["ostage"] = ois_stage_tables(inp.topology, P["bat"], device)
    agg = _agg_to(inp.aggregate, device)
    clamp = None if inp.clamp is None else _clamp_to(inp.clamp, device)
    clamp_agg = clamp
    if inp.tile is not None and clamp is not None:
        scale = _f64(inp.tile.scale, device)
        # the aggregate's clamp total is linear in the per-copy scale:
        # the base slots with weights times sum(scale)
        clamp_agg = dataclasses.replace(clamp, w=clamp.w * scale.sum())
        if sweep:
            clamp = _expand_clamp(clamp, scale, int(inp.tile.base_trades))
    if not sweep:
        clamp = None
    sw = None if not sweep else sweep_tables_from_cols(
        expanded_cols(inp, device), inp.n_trades,
        inp.n_grid + agg.trip_s.shape[0])
    qt = None if not quad else kernels.quad_tables(
        trip_group_arrays(inp.groups, inp.aggregate), inp.n_quotes, device)
    return DeviceBook(grids=inp.grids, params=P, aggregate=agg,
                      clamp=clamp, clamp_agg=clamp_agg, sweep=sw, quad=qt)


def _jacobians_fn(inp: BookInputs, book: DeviceBook):
    """q [Sc, N] -> (dfs [Sc, n_grid], J [Sc, N, n_grid]): the shocked
    grids and their quote jacobians through the book's risk split (the
    structured one when the book carries its stage topology)."""
    P, agg, clamp_agg = book.params, book.aggregate, book.clamp_agg
    if inp.topology is not None:
        from .structured_risk import make_structured_parts
        fwd_delta = make_structured_parts(inp.topology)["fwd_delta"]

        def jac(q):
            fw = fwd_delta(q, P, agg, clamp_agg)
            return fw["dfs"], fw["J"]
        return jac

    def jac(q):
        out = vmap(lambda x: _scenario_risk(book.grids, x, P, agg,
                                            clamp_agg, False))(q)
        return out["dfs"], out["J"].contiguous()
    return jac


def _term1_fn(book: DeviceBook):
    """term1(J [Sc, N, n_grid], dfs [Sc, n_grid]) -> [Sc, N, N]: the
    trip quad form through the K2 kernel, plus the cap/floor clamp
    slots' closed form."""
    def term1(J, dfs):
        J = J.contiguous()
        dfs = dfs.contiguous()
        t1 = kernels.gamma_quad_form_grouped(J, dfs, book.quad)
        if book.clamp_agg is not None:
            t1 = t1 + vmap(lambda j, d: _clamp_quad_form(
                j, d, book.clamp_agg))(J, dfs)
        return t1
    return term1


def _risk_fn(inp: BookInputs, book: DeviceBook, want_gamma: bool):
    """(risk, chunk): ``risk(qvec, shocks)`` -> (dfs [S, n_grid], {delta
    [S, N], gamma [S, N, N]}), the book's risk pass in scenario chunks
    of ``chunk(S)`` through the structured split when the book carries
    its stage topology, else the generic split; term1 on K2."""
    grids, P = book.grids, book.params
    agg, clamp_agg = book.aggregate, book.clamp_agg
    term1 = _term1_fn(book)
    N = inp.n_quotes
    structured = inp.topology is not None
    if structured:
        from .structured_risk import make_structured_risk
        scenario_risk = make_structured_risk(inp.topology, term1)
        width = inp.n_grid
    else:
        # the dense [C*U] row width: each simple scheme's stacked plan
        # and each fitted curve's own
        gplan = inp.bat["gplan"]
        width = sum(p["i0"].size for k, p in gplan.items() if k != "fit") \
            + sum(p["q"].size for p in gplan.get("fit", {}).values())

    def chunk(n_scen: int) -> int:
        return risk_chunk_size(N, width, n_scen)

    def risk(qvec, shocks):
        dfs_l, delta_l, gamma_l = [], [], []
        c = chunk(shocks.shape[0])
        for s0 in range(0, shocks.shape[0], c):
            q = qvec[None, :] + shocks[s0:s0 + c]
            if not want_gamma:
                def one(x):
                    total = grad(lambda y: aggregate_total(
                        grids(y, P), agg, clamp_agg))
                    return grids(x, P), total(x)
                dfs, delta = vmap(one)(q)
            elif structured:
                out = scenario_risk(q, P, agg, clamp_agg, True)
                dfs, delta = out["dfs"], out["delta"]
                gamma_l.append(out["gamma"])
            else:
                out = vmap(lambda x: _scenario_risk(
                    grids, x, P, agg, clamp_agg, True))(q)
                dfs, delta = out["dfs"], out["delta"]
                gamma_l.append(term1(out["J"], dfs) + out["term2"])
            dfs_l.append(dfs)
            delta_l.append(delta)
        res = {"delta": torch.cat(delta_l)}
        if want_gamma:
            res["gamma"] = torch.cat(gamma_l)
        return torch.cat(dfs_l), res

    return risk, chunk


def make_multibook_fn(mb: Union[MultiBook, BookInputs], device,
                      want_gamma: bool = True):
    """(qvec [N], shocks [S, N]) -> {pvs [S, B], delta [S, N],
    gamma [S, N, N]} on ``device``: per-trade PVs from the K1 sweep, book
    delta/gamma from the aggregate graph. N is the packed quote
    dimension across every curve (OIS rates + basis spreads), so the
    gamma includes all cross-curve blocks. The book moves to ``device``
    once, here (a lazily tiled book is expanded there).

    The risk pass takes the STRUCTURED per-stage split
    (``structured_risk``) whenever the book carries its stage topology,
    and the generic split (``_scenario_risk``) for a book compiled with
    ``batch_curves=False``; term1 is the K2 kernel either way.

    ``fn.risk_only`` and ``fn.pvs_only`` run the two halves separately;
    ``fn.dfs_only`` and ``fn.jacobians`` return the shocked grids (and
    their quote jacobians); ``fn.chunk(S)`` is the risk pass's scenario
    chunk for S scenarios; ``fn.structured`` says which split runs;
    ``fn.book`` holds the device tables."""
    inp = book_inputs(mb) if isinstance(mb, MultiBook) else mb
    device = torch.device(device)
    book = _device_book(inp, device)
    grids, P, agg = book.grids, book.params, book.aggregate
    _risk, chunk = _risk_fn(inp, book, want_gamma)

    def fn(qvec, shocks):
        dfs_all, out = _risk(_f64(qvec, device), _f64(shocks, device))
        # the risk pass already bootstrapped every scenario's grids —
        # the PV sweep consumes them instead of recomputing
        out["pvs"] = _pvs_sweep(dfs_all, book.sweep, book.clamp, agg)
        return out

    def risk_only(qvec, shocks):
        return _risk(_f64(qvec, device), _f64(shocks, device))[1]

    def dfs_only(qvec, shocks):
        """The compact DF grids [S, n_grid] of the shocked quotes."""
        q = _f64(qvec, device)
        return vmap(lambda s: grids(q + s, P))(
            _f64(shocks, device)).contiguous()

    def pvs_only(qvec, shocks):
        return _pvs_sweep(dfs_only(qvec, shocks), book.sweep, book.clamp,
                          agg)

    jac = _jacobians_fn(inp, book)

    def jacobians(qvec, shocks):
        """(dfs [S, n_grid], J [S, N, n_grid]) of the shocked quotes,
        through the same split as the risk pass."""
        return jac(_f64(qvec, device)[None, :] + _f64(shocks, device))

    fn.risk_only = risk_only
    fn.pvs_only = pvs_only
    fn.dfs_only = dfs_only
    fn.jacobians = jacobians
    fn.chunk = chunk
    fn.structured = inp.topology is not None
    fn.book = book
    return fn


def make_multibook_speed_fn(mb: MultiBook, device=None,
                            force: bool = False):
    """(qvec [N]) -> [N, N, N] EXACT third-order book risk tensor
    speed[i, j, k] = ∂³ total_PV / ∂q_i ∂q_j ∂q_k (ccy units per
    unit-rate³; multiply by 1e-12 for per-bp³), on ``device`` (None: the
    CUDA card). Port of ``adrates_tpu/parallel/multibook.py:2256``.

    The plain AD tower ``jacfwd(jacrev(jacrev(total)))`` (one forward
    level, as a solve takes at most one: ``ops/linear_solve``) over the
    aggregate graph, ``total(q) = aggregate_total(grids(q, P), agg,
    clamp)`` with the tile and clamp aggregates carried as
    ``make_multibook_fn`` carries them — NO structured shortcut, for the
    JAX package's reason: the structured pass's second-order machinery
    holds the aggregate cotangent g fixed, so differentiating ITS gamma
    would drop the ∂g/∂q third-order terms, and extending the per-stage
    chain rule one more level means hand-assembling the full Faà di
    Bruno composition through the XCCY legs. The tower is exact; its N²
    forward tangents through the whole curve graph make it impractical at
    flagship N (184).

    Raises LibError above SPEED_MAX_QUOTES quotes unless ``force=True``.
    """
    n_quotes = mb.basket.n_quotes
    if n_quotes > SPEED_MAX_QUOTES and not force:
        raise LibError(
            f"make_multibook_speed_fn: n_quotes={n_quotes} > "
            f"{SPEED_MAX_QUOTES}. The exact third-order tower needs N^2 "
            f"forward tangents through the whole curve graph; past ~"
            f"{SPEED_MAX_QUOTES} quotes compile and runtime are "
            f"impractical (see docstring). Pass force=True to override, "
            f"or compute engine-level SPEED per position for selected "
            f"trades.")
    device = resolve_device(device)
    book = _device_book(book_inputs(mb), device, sweep=False, quad=False)
    grids, P = book.grids, book.params
    agg, clamp_agg = book.aggregate, book.clamp_agg

    def total(q):
        return aggregate_total(grids(q, P), agg, clamp_agg)

    tower = jacfwd(jacrev(jacrev(total)))

    def fn(qvec):
        return tower(_f64(qvec, device))

    return fn


def make_staged_multibook_fn(mb: Union[MultiBook, BookInputs], device,
                             want_gamma: bool = True,
                             max_chunk: Optional[int] = None):
    """(qvec, shocks [S, N]) -> {pvs [S, B], delta [S, N],
    gamma [S, N, N]} — the same outputs as make_multibook_fn, computed
    as a plain composition of the staged REGIONS of the JAX package's
    ``make_staged_multibook_fn`` (``adrates_tpu/parallel/multibook.py``
    :1963), each callable on its own through ``fn.regions``:

        A   fwd + J + delta  (structured_risk fwd_delta)
        B   term1            (K2 trip quad form + clamp slots, over A's J)
        C1  term2, XCCY stages (curve hessians + parent cotangents)
        C2  term2, OIS stages (consume C1's cotangents)
        D   gamma = t1 + h2_xccy + h2_ois
        P   per-trade PV sweep (K1) over A's DF grids

    Scenarios run in equalized chunks: the fewest chunks of at most the
    cap, then even sizes (``fn.chunk(S)``; S = 100 under a cap of 25
    gives 4 x 25), the last one zero-padded when S does not divide. The
    cap comes from the device-memory budget RISK_CHUNK_BYTES (three
    [chunk, N, n_grid] f64 stacks); ``max_chunk`` overrides it.

    Requires the book's stage topology (batch_curves=True).
    ``want_gamma=False`` runs A + P only."""
    inp = book_inputs(mb) if isinstance(mb, MultiBook) else mb
    if inp.topology is None:
        raise LibError(
            "make_staged_multibook_fn requires the batched stage "
            "topology: compile the book with batch_curves=True")
    from .structured_risk import make_structured_parts
    device = torch.device(device)
    book = _device_book(inp, device)
    P, agg, clamp_agg = book.params, book.aggregate, book.clamp_agg
    parts = make_structured_parts(inp.topology)
    N = inp.n_quotes
    chunk_cap = max(1, RISK_CHUNK_BYTES // (3 * N * inp.n_grid * 8)) \
        if max_chunk is None else int(max_chunk)

    def _chunk_for(S: int) -> int:
        """Equalized chunk: smallest count of <=chunk_cap-sized chunks,
        then even sizes."""
        n_ch = -(-S // chunk_cap)
        return -(-S // n_ch)

    regions = dict(
        A=lambda q: parts["fwd_delta"](q, P, agg, clamp_agg),
        B=_term1_fn(book),
        C1=lambda q, g, carry: parts["term2_xccy"](q, P, g, carry),
        C2=lambda q, g, v_of: parts["term2_ois"](q, P, g, v_of),
        D=lambda t1, h2x, h2o: t1 + h2x + h2o,
        P=lambda dfs: _pvs_sweep(dfs, book.sweep, book.clamp, agg))

    def _run_chunk(q):
        a = regions["A"](q)
        res = {"delta": a["delta"], "dfs": a["dfs"]}
        if want_gamma:
            t1 = regions["B"](a["J"], a["dfs"])
            h2x, v_of = regions["C1"](q, a["g"], a["carry"])
            h2o = regions["C2"](q, a["g"], v_of)
            res["gamma"] = regions["D"](t1, h2x, h2o)
        return res

    def fn(qvec, shocks):
        qvec = _f64(qvec, device)
        shocks = _f64(shocks, device)
        S = shocks.shape[0]
        chunk = _chunk_for(S)
        outs = []
        for lo in range(0, S, chunk):
            sh = shocks[lo:lo + chunk]
            pad = chunk - sh.shape[0]
            if pad:
                sh = torch.cat([sh, sh.new_zeros((pad, N))])
            outs.append(_run_chunk(qvec[None, :] + sh))
        res = {k: torch.cat([o[k] for o in outs])[:S] for k in outs[0]}
        res["pvs"] = regions["P"](res.pop("dfs"))
        return res

    fn.chunk = _chunk_for
    fn.regions = regions
    fn.book = book
    return fn


def warmup_multibook(mb: MultiBook, n_scenarios: int, device,
                     want_gamma: bool = True, staged: bool = False):
    """Build the book's risk fn (``make_staged_multibook_fn`` with
    ``staged=True``, else ``make_multibook_fn``) and make one call on
    zero shocks at the production (n_scenarios, n_quotes) shape,
    synchronized, so torch.func's first use, the kernel build and the
    allocator's first growth happen here; returns the ready fn."""
    device = torch.device(device)
    make = make_staged_multibook_fn if staged else make_multibook_fn
    fn = make(mb, device, want_gamma=want_gamma)
    fn(mb.basket.quotes0, np.zeros((n_scenarios, mb.basket.n_quotes)))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return fn


# ---------------------------------------------------------------------------
# per-trade delta ladders and gammas
# ---------------------------------------------------------------------------


def _base_trades(mb: MultiBook) -> int:
    return mb.tile.base_trades if mb.tile is not None else mb.n_trades


def _repeat_slots(owner: np.ndarray, n_base: int, rows_of: np.ndarray):
    """(k, idx): every slot ``idx`` of base trade ``rows_of[k]``, for each
    k in order (``owner``: each slot's base trade), so a base trade listed
    twice gets its slots twice."""
    order = np.argsort(owner, kind="stable")
    cnt = np.bincount(owner, minlength=n_base)
    start = np.concatenate([[0], np.cumsum(cnt)])[:-1]
    n_k = cnt[rows_of]
    k = np.repeat(np.arange(rows_of.shape[0]), n_k)
    pos = np.arange(int(n_k.sum())) - np.repeat(np.cumsum(n_k) - n_k, n_k)
    return k, order[np.repeat(start[rows_of], n_k) + pos]


def _harvest(mb: MultiBook, rows_of, mult) -> Dict[str, np.ndarray]:
    """The live slots of the base trades ``rows_of`` (one entry per
    listed trade; weights times ``mult[k]``), as the float64 tables of
    the JAX package's harvest loops (``pertrade_blocks.py:_harvest_group``,
    ``multibook.py:2556-2595``), vectorised: ``lin`` [n, 3] (k, column,
    w), ``trip`` [n, 5] (k, s, e, p, w) and ``clamp`` [n, 9] (k, s, e, p,
    ia, w, spread, cap, floor), k the position in ``rows_of``."""
    CU = mb.basket.n_grid
    agg = mb.aggregate
    n_base = _base_trades(mb)
    rows_of = np.asarray(rows_of, dtype=np.int64)
    mult = np.asarray(mult, dtype=np.float64)
    t, c, w = [], [], []
    for cb in mb.cols:
        wi = np.asarray(cb.w)
        live = wi != 0.0
        t.append(np.broadcast_to(np.asarray(cb.row_trade)[:, None],
                                 wi.shape)[live])
        c.append(np.asarray(cb.col_idx)[live])
        w.append(wi[live])
    t = np.concatenate(t).astype(np.int64) if t else np.zeros(0, np.int64)
    c = np.concatenate(c).astype(np.int64) if c else np.zeros(0, np.int64)
    w = np.concatenate(w) if w else np.zeros(0)
    out = {}
    is_lin = c < CU
    k, i = _repeat_slots(t[is_lin], n_base, rows_of)
    out["lin"] = np.stack([k, c[is_lin][i], w[is_lin][i] * mult[k]],
                          axis=1)
    k, i = _repeat_slots(t[~is_lin], n_base, rows_of)
    ti = c[~is_lin][i] - CU
    out["trip"] = np.stack(
        [k, np.asarray(agg.trip_s)[ti], np.asarray(agg.trip_e)[ti],
         np.asarray(agg.trip_p)[ti], w[~is_lin][i] * mult[k]], axis=1)
    out["clamp"] = np.zeros((0, 9))
    if mb.clamp is not None:
        cl = mb.clamp
        k, i = _repeat_slots(np.asarray(cl.slot_trade, dtype=np.int64),
                             n_base, rows_of)
        f = [np.asarray(getattr(cl, n))[i] for n in
             ("s_idx", "e_idx", "p_idx", "ia", "w", "spread", "cap",
              "floor")]
        f[4] = f[4] * mult[k]
        out["clamp"] = np.stack([k, *f], axis=1)
    return out


def _slot_dict(lin: np.ndarray, trip: np.ndarray,
               cl: np.ndarray) -> Dict[str, np.ndarray]:
    """The harvest tables as named columns (the JAX package's keys)."""
    ix = np.int32
    return dict(
        lin_b=lin[:, 0].astype(ix), lin_c=lin[:, 1].astype(ix),
        lin_w=lin[:, 2],
        tr_b=trip[:, 0].astype(ix), tr_s=trip[:, 1].astype(ix),
        tr_e=trip[:, 2].astype(ix), tr_p=trip[:, 3].astype(ix),
        tr_w=trip[:, 4],
        cl_b=cl[:, 0].astype(ix), cl_s=cl[:, 1].astype(ix),
        cl_e=cl[:, 2].astype(ix), cl_p=cl[:, 3].astype(ix),
        cl_ia=cl[:, 4], cl_w=cl[:, 5], cl_sp=cl[:, 6], cl_cap=cl[:, 7],
        cl_lo=cl[:, 8])


def _harvest_sel_tables(mb: MultiBook, trade_ids) -> Dict[str, np.ndarray]:
    """Flat lin / trip / clamp slot tables of a SELECTION of (tiled)
    trade ids (``adrates_tpu`` ``_harvest_sel_tables`` without its MXU
    pair tables): b indices local to the selection order, one entry per
    selection when a base trade is selected in several copies, weights at
    the copy's tile scale."""
    sel = np.asarray(trade_ids, dtype=np.int64)
    if sel.size and (sel.min() < 0 or sel.max() >= mb.n_trades):
        raise ValueError(f"trade ids outside [0, {mb.n_trades})")
    if mb.tile is not None:
        B_base = mb.tile.base_trades
        mult = np.asarray(mb.tile.scale)[sel // B_base]
        rows_of = sel % B_base
    else:
        mult = np.ones(sel.shape[0])
        rows_of = sel
    h = _harvest(mb, rows_of, mult)
    return _slot_dict(h["lin"], h["trip"], h["clamp"])


def _tables_to(tb: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """Slot tables on ``device``: indices int64, the rest f64."""
    return {k: (_i64(v, device) if np.issubdtype(v.dtype, np.integer)
                else _f64(v, device)) for k, v in tb.items()}


def _clamp_slot_terms(dfs: torch.Tensor, tb: dict):
    """(u, v, p, ia, rate, wI) of the clamp slots at ``dfs``: the DFs,
    the safe index alpha, the clipped rate and the weight times the
    in-band mask (``multibook.py:2730-2738``)."""
    u, v, p = dfs[tb["cl_s"]], dfs[tb["cl_e"]], dfs[tb["cl_p"]]
    has = tb["cl_ia"] > 0.0
    ia = torch.where(has, tb["cl_ia"], 1.0)
    pre = torch.where(has, (u / v - 1.0) / ia, 0.0) + tb["cl_sp"]
    rate = torch.clamp(pre, tb["cl_lo"], tb["cl_cap"])
    inside = (pre > tb["cl_lo"]) & (pre < tb["cl_cap"]) & has
    return u, v, p, ia, rate, tb["cl_w"] * inside.to(u.dtype)


def _slot_gradient(dfs: torch.Tensor, tb: dict, n_b: int, width: int,
                   local: bool = False) -> torch.Tensor:
    """[n_b, width] DF-space gradient of each trade's PV, closed form:
    its linear weights, its trips' partials and its clamp slots'. The
    scatter columns are the slots' grid columns, or with ``local`` their
    restricted-row positions (the ``*l`` columns of the blocks' tables)."""
    sfx = "l" if local else ""
    G = dfs.new_zeros(n_b * width)

    def add(b, col, val):
        G.index_add_(0, b * width + col, val)

    add(tb["lin_b"], tb["lin_c" + sfx], tb["lin_w"])
    a, b_, c_ = dfs[tb["tr_s"]], dfs[tb["tr_e"]], dfs[tb["tr_p"]]
    w = tb["tr_w"]
    add(tb["tr_b"], tb["tr_s" + sfx], w * c_ / b_)
    add(tb["tr_b"], tb["tr_e" + sfx], -w * a * c_ / (b_ * b_))
    add(tb["tr_b"], tb["tr_p" + sfx], w * (a / b_ - 1.0))
    u, v, p, ia, rate, wI = _clamp_slot_terms(dfs, tb)
    add(tb["cl_b"], tb["cl_p" + sfx], tb["cl_w"] * rate)
    add(tb["cl_b"], tb["cl_s" + sfx], wI * p / (ia * v))
    add(tb["cl_b"], tb["cl_e" + sfx], -wI * p * u / (ia * v * v))
    return G.view(n_b, width)


def _k3_weights(dfs: torch.Tensor, tb: dict) -> torch.Tensor:
    """K3's slot weights in :func:`_k3_tables`' slot order: each trip's
    weight, then each clamp slot's in-band weight over its index alpha
    (the clamp's Hessian is the trip's times w·inside/ia)."""
    _, _, _, ia, _, wI = _clamp_slot_terms(dfs, tb)
    return torch.cat([tb["tr_w"], wI / ia])


def _k3_tables(tb: Dict[str, np.ndarray], rows, n_items,
               device) -> kernels.PertradeTables:
    """K3's tables over the trip then the clamp slots of ``tb``, whose b
    columns are the items (groups of ``rows``, ``n_items`` trades each)."""
    def cat(kind):
        return np.concatenate([tb["tr_" + kind], tb["cl_" + kind]])

    return kernels.pertrade_tables(rows, n_items, cat("b"), cat("s"),
                                   cat("e"), cat("p"), device)


def _need_multibook(mb) -> MultiBook:
    if not isinstance(mb, MultiBook):
        raise LibError("per-trade risk needs the compiled MultiBook (its "
                       "base trades' slots), not device-layer inputs")
    return mb


def _ladder_fn(jac, agg: MultiBookAggregate, sweep: kernels.SweepTables,
               clamp: Optional[ClampSlots], device, dtype=None):
    """(qvec) -> the ladders of the trades of ``sweep`` and ``clamp``
    (their trade ids index the rows of the result) on K1, in ``dtype``
    (None: f64): J from ``jac`` at qvec stays f64, Jv and the slot
    weights are cast to ``dtype`` and K1 sums in it, trade-major, the
    clamp rows are computed in f64 and cast (``adrates_tpu``
    ``multibook.py:2825-2829``, ``:2856-2857``). ``fn.prep(qvec)`` gives
    K1's inputs, ``fn.contract(*fn.prep(qvec))`` the ladders from them,
    ``fn.sweep`` K1's tables."""
    dtype = torch.float64 if dtype is None else dtype
    sweep = sweep if dtype == torch.float64 \
        else kernels.sweep_tables_as(sweep, dtype)
    if clamp is not None:
        ct = dict(cl_s=clamp.s_idx, cl_e=clamp.e_idx, cl_p=clamp.p_idx,
                  cl_ia=clamp.ia, cl_w=clamp.w, cl_sp=clamp.spread,
                  cl_cap=clamp.cap, cl_lo=clamp.floor)

    def prep(qvec):
        """(dfs [n_grid], Jt [n_grid, N], Jv [n_grid + T, N] in the
        ladder's dtype) at qvec: K1's value table, rows 16-byte
        aligned."""
        dfs, J = jac(_f64(qvec, device)[None, :])
        dfs, Jt = dfs[0], J[0].T
        a = dfs[agg.trip_s][:, None]
        b_ = dfs[agg.trip_e][:, None]
        c_ = dfs[agg.trip_p][:, None]
        J_trip = (Jt[agg.trip_s] * (c_ / b_)
                  - Jt[agg.trip_e] * (a * c_ / (b_ * b_))
                  + Jt[agg.trip_p] * (a / b_ - 1.0))
        return dfs, Jt, _even_rows(Jt, J_trip, dtype)

    def contract(dfs, Jt, Jv):
        """The ladders [B, N] from ``prep``'s outputs: one trade-major K1
        launch, then the clamp rows."""
        out = kernels.pvs_sweep(Jv, sweep, trade_major=True)    # [B, N]
        if clamp is not None:
            # the clamp slots' DF partials, as in _slot_gradient
            u, v, p, ia, rate, wI = _clamp_slot_terms(dfs, ct)
            d = ((clamp.w * rate)[:, None] * Jt[clamp.p_idx]
                 + (wI * p / (ia * v))[:, None] * Jt[clamp.s_idx]
                 - (wI * p * u / (ia * v * v))[:, None] * Jt[clamp.e_idx])
            out.index_add_(0, clamp.slot_trade, d.to(dtype))
        return out

    def fn(qvec):
        return contract(*prep(qvec))

    fn.prep = prep
    fn.contract = contract
    fn.sweep = sweep
    return fn


def make_per_trade_delta_fn(mb: MultiBook, device, dtype=None):
    """(qvec [N]) -> [B, N] per-trade delta ladders (ccy units per unit
    rate; multiply by 1e-4 for per-bp) on ``device``, single scenario
    (``adrates_tpu`` ``make_per_trade_delta_fn``, its "gather" method).

    Chain-rule split: per-slot dPV/dDF coefficients are closed form and
    J = d dfs/d quotes comes from the book's risk split at q. The ladder
    is ``ladder[b, :] = sum over b's slots of w · Jv[col, :]`` with
    Jv = [Jᵀ; J_trip] [n_grid + T, N], the trip rows in closed form: the
    PV sweep's own CSR (``fn.book.sweep``) over a value table whose S
    columns are the N quotes, so K1's trade-major kernel writes the
    [B, N] ladders in one launch. The cap/floor clamp rows are added in
    torch.

    ``dtype`` (e.g. ``torch.float32``) downcasts Jv, the slot weights and
    the contraction, which then runs on K1's f32 instantiation; the
    curve graph and J stay f64 and the clamp rows are computed in f64
    and cast, as in the JAX package (ladders are reporting artifacts,
    not calibration inputs). ``fn.prep(qvec)`` gives K1's inputs,
    ``fn.sweep`` the tables K1 reads (in ``dtype``), ``fn.book`` the
    device book."""
    mb = _need_multibook(mb)
    inp = book_inputs(mb)
    device = torch.device(device)
    book = _device_book(inp, device, quad=False)
    fn = _ladder_fn(_jacobians_fn(inp, book), book.aggregate, book.sweep,
                    book.clamp, device, dtype)
    fn.book = book
    return fn


def make_per_trade_gamma_fn(mb: MultiBook, trade_ids, device):
    """(qvec [N]) -> [B_sel, N, N] exact per-trade gamma matrices of the
    selected (tiled) trades on ``device`` (``adrates_tpu``
    ``make_per_trade_gamma_fn``; ccy units per unit-rate², 1e-8 for
    per-bp²), by the book gamma's chain-rule split

        gamma_b = Jᵀ·H_b·J + Σ_k G[b, k] · ∂²dfs_k/∂q∂q.

    G, the trades' DF-space gradients, is closed form over their slots;
    term 1 is the K3 kernel over their trip and in-band clamp slots at
    full width (k = N); term 2 is the structured per-stage curve-Hessian
    contraction (``structured_risk.make_pertrade_curvehess``), or for a
    book without the stage topology one ``jacfwd`` over the grids'
    ``jvp_by_vjp`` (one forward level through the solves).
    ``fn.prep(qvec)`` gives K3's inputs, ``fn.k3`` its tables."""
    mb = _need_multibook(mb)
    sel = np.asarray(trade_ids, dtype=np.int64)
    n_sel = int(sel.shape[0])
    inp = book_inputs(mb)
    device = torch.device(device)
    book = _device_book(inp, device, sweep=False, quad=False)
    jac = _jacobians_fn(inp, book)
    N, CU = inp.n_quotes, inp.n_grid
    host = _harvest_sel_tables(mb, sel)
    tb = _tables_to(host, device)
    k3 = _k3_tables(host, [np.arange(N)], [n_sel], device)
    if inp.topology is not None:
        from .structured_risk import (make_pertrade_curvehess,
                                      make_pertrade_tensors)
        tensors = make_pertrade_tensors(inp.topology)
        contract = make_pertrade_curvehess(inp.topology)

        def term2(q, G):
            return contract(tensors(q, book.params), G)
    else:
        eye = torch.eye(N, dtype=torch.float64, device=device)

        def grids(x):
            return book.grids(x, book.params)

        def term2(q, G):
            H = jacfwd(lambda x: vmap(
                lambda s: jvp_by_vjp(grids, x, s)[1])(eye))(q)
            H = H.permute(1, 0, 2)                      # [CU, N, N]
            return (G @ H.reshape(CU, N * N)).reshape(-1, N, N)

    def prep(qvec):
        """(q, dfs [n_grid], Jt [n_grid, N], K3's slot weights) at qvec."""
        q = _f64(qvec, device)
        dfs, J = jac(q[None, :])
        dfs, Jt = dfs[0], J[0].T.contiguous()
        return q, dfs, Jt, _k3_weights(dfs, tb)

    def fn(qvec):
        q, dfs, Jt, w = prep(qvec)
        t1 = kernels.pertrade_quad_form(Jt, dfs, w, k3)[0]
        return t1 + term2(q, _slot_gradient(dfs, tb, n_sel, CU))

    fn.prep = prep
    fn.k3 = k3
    return fn


# ---------------------------------------------------------------------------
# the book's trades sharded over a mesh
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MultiBookShard:
    """One rank's part of a multibook (:func:`shard_multibook`): the
    trades are padded with dead ones to ``n_pad`` (the trade count
    rounded up to the shard count) and split into contiguous ranges, and
    this rank owns trades ``[lo, lo + n_local)``, of which ``[lo, hi)``
    are live. ``cols`` and ``clamp`` hold the live trades' column rows
    and clamp slots on ``device``, trade ids made local (``t - lo``);
    ``axis`` says which shard and group this is."""
    book: MultiBook
    axis: object                     # distributed.ShardAxis
    device: torch.device
    n_pad: int
    lo: int
    hi: int
    cols: List[ColRows]
    clamp: Optional[ClampSlots]

    @property
    def n_local(self) -> int:
        return self.n_pad // self.axis.n

    @property
    def rows(self) -> int:
        """The column rows this rank holds (its trades' only)."""
        return sum(int(cb.col_idx.shape[0]) for cb in self.cols)


def _copy_pieces(lo: int, hi: int, n_base: int):
    """[(c_a, c_b, k_lo, k_hi)]: trades [lo, hi) of a copy-major tiled
    book (trade c * n_base + k) as runs of copies [c_a, c_b) of base
    trades [k_lo, k_hi), whole copies merged into one run."""
    pieces = []
    c = lo // n_base
    while c * n_base < hi:
        k_lo, k_hi = max(lo - c * n_base, 0), min(hi - c * n_base, n_base)
        if (k_lo, k_hi) == (0, n_base) and pieces \
                and pieces[-1][1] == c and pieces[-1][2:] == (0, n_base):
            pieces[-1] = (pieces[-1][0], c + 1, 0, n_base)
        else:
            pieces.append((c, c + 1, k_lo, k_hi))
        c += 1
    return pieces


def _trade_rows(mb: MultiBook, lo: int, hi: int, device):
    """(cols, clamp) of trades [lo, hi) on ``device`` with trade ids
    ``t - lo``. A lazily tiled book expands on the device only the
    copies the range overlaps, and of a partial copy only its base rows
    in range: no full-size row table is built."""
    n_base = _base_trades(mb)
    scale = _f64(mb.tile.scale if mb.tile is not None else [1.0], device)
    cols, clamps = [], []
    for c_a, c_b, k_lo, k_hi in _copy_pieces(lo, hi, n_base):
        sc, off = scale[c_a:c_b], c_a * n_base - lo
        for cb in mb.cols:
            rt = np.asarray(cb.row_trade)
            sel = (rt >= k_lo) & (rt < k_hi)
            if not sel.any():
                continue
            ex = _expand_cols(ColRows(
                col_idx=_i32(np.asarray(cb.col_idx)[sel], device),
                w=_f64(np.asarray(cb.w)[sel], device),
                row_trade=_i64(rt[sel], device)), sc, n_base)
            cols.append(dataclasses.replace(ex, row_trade=ex.row_trade + off))
        if mb.clamp is not None:
            st = np.asarray(mb.clamp.slot_trade)
            sel = (st >= k_lo) & (st < k_hi)
            if sel.any():
                part = ClampSlots(**{f.name: np.asarray(getattr(
                    mb.clamp, f.name))[sel] for f in
                    dataclasses.fields(ClampSlots)})
                ex = _expand_clamp(_clamp_to(part, device), sc, n_base)
                clamps.append(dataclasses.replace(
                    ex, slot_trade=ex.slot_trade + off))
    clamp = None
    if clamps:
        clamp = ClampSlots(**{f.name: torch.cat([getattr(c, f.name)
                                                 for c in clamps])
                              for f in dataclasses.fields(ClampSlots)})
    return cols, clamp


def _shard(mb: MultiBook, mesh, axis, device) -> MultiBookShard:
    from .distributed import ShardAxis
    mb = _need_multibook(mb)
    ax = ShardAxis(mesh, axis)
    device = resolve_device(device)
    n_pad = mb.n_trades + (-mb.n_trades) % ax.n
    lo = ax.index * (n_pad // ax.n)
    hi = max(lo, min(lo + n_pad // ax.n, mb.n_trades))
    cols, clamp = _trade_rows(mb, lo, hi, device)
    return MultiBookShard(book=mb, axis=ax, device=device, n_pad=n_pad,
                          lo=lo, hi=hi, cols=cols, clamp=clamp)


def _as_shard(mb, mesh, axis, device) -> MultiBookShard:
    return mb if isinstance(mb, MultiBookShard) \
        else _shard(mb, mesh, axis, device)


def shard_multibook(mb: MultiBook, mesh, axis="book",
                    device=None) -> MultiBookShard:
    """This rank's shard of a materialized multibook (``adrates_tpu``
    ``multibook.py:2374``): its contiguous range of the trades, padded
    with dead trades here (not by the caller) to a multiple of the shard
    count, with their column rows and clamp slots placed on ``device``
    (None: the card). ``axis`` is one axis name of ``mesh`` (a
    ``DeviceMesh``, ``distributed.book_mesh``) or a tuple of every axis.
    A lazily tiled book raises ``LibError``: pass it straight to
    ``make_sharded_multibook_fn``, which expands only this rank's part
    on the device."""
    if mb.tile is not None:
        raise LibError(
            "shard_multibook places materialized rows; for a lazy "
            "TileSpec book pass the MultiBook straight to "
            "make_sharded_multibook_fn, which expands only this rank's "
            "trades on the device (no full-size row table is built)")
    return _shard(mb, mesh, axis, device)


def make_sharded_multibook_fn(mb, mesh, axis="book",
                              want_gamma: bool = True, device=None):
    """(qvec [N], shocks [S, N]) -> {total_pv [S], delta [S, N],
    gamma [S, N, N]} on every rank (``adrates_tpu``
    ``multibook.py:2414``): only the PV sweep is sharded. Each rank runs
    K1 (and the clamp epilogue) over its own trades and sums them, and
    the per-scenario totals are all-reduced over the ``axis`` group;
    delta and gamma come from the replicated aggregate through the
    book's risk split (structured when the basket has stages; term1 on
    K2), so no collective carries them.

    ``mb`` is a ``MultiBookShard`` from :func:`shard_multibook`, or a
    MultiBook, materialized or lazily tiled, sharded here (a lazy book
    expands on this rank's device only its own trades' rows).
    ``fn.shard`` is the shard, ``fn.sweep`` its K1 tables, ``fn.book``
    the replicated device book, ``fn.chunk(S)`` the risk chunk."""
    shard = _as_shard(mb, mesh, axis, device)
    inp = book_inputs(shard.book)
    dev = shard.device
    book = _device_book(inp, dev, sweep=False, quad=want_gamma)
    risk, chunk = _risk_fn(inp, book, want_gamma)
    sweep = sweep_tables_from_cols(
        shard.cols, shard.n_local,
        inp.n_grid + int(book.aggregate.trip_s.shape[0]))

    def fn(qvec, shocks):
        from .distributed import all_reduce
        dfs_all, out = risk(_f64(qvec, dev), _f64(shocks, dev))
        pvs = _pvs_sweep(dfs_all, sweep, shard.clamp, book.aggregate)
        out["total_pv"] = all_reduce(pvs.sum(dim=1), shard.axis.group)
        return out

    fn.shard = shard
    fn.sweep = sweep
    fn.book = book
    fn.chunk = chunk
    return fn


def trade_pvs(dfs_flat: torch.Tensor, mb_buckets, clamp: Optional[ClampSlots],
              n_trades: int) -> torch.Tensor:
    """Per-trade base-ccy PVs [B] of row buckets (``MultiBookRows``, host
    numpy, as ``compile_multibook`` and ``tile_multibook(...,
    materialize=True)`` give them) and host clamp slots, from a flat DF
    vector [n_grid] (or [S, n_grid] -> [S, B]), on K1 (``adrates_tpu``
    ``multibook.py:1481``): the rows' slots become K1's per-trade CSR
    over the value table [DF grid; the rows' forward-trip values], then
    the clamp slots' PVs are added. Tables are built per call."""
    dfs = dfs_flat if dfs_flat.dim() == 2 else dfs_flat[None]
    dev, CU = dfs.device, dfs.shape[1]
    trade, col, w, uniq = sweep_slots(
        mb_buckets, [b.row_trade for b in mb_buckets], CU)
    s, e, p = (_i64(x, dev) for x in _unkey(uniq, CU))
    sweep = kernels.sweep_tables(_i64(trade, dev), _i64(col, dev),
                                 _f64(w, dev), n_trades, CU + int(s.shape[0]))
    vT = _even_rows(dfs.T, ((dfs[:, s] / dfs[:, e] - 1.0) * dfs[:, p]).T)
    pvs = kernels.pvs_sweep(vT, sweep)
    if clamp is not None:
        pvs = clamp_epilogue(pvs, dfs, _clamp_to(clamp, dev))
    return pvs if dfs_flat.dim() == 2 else pvs[0]
