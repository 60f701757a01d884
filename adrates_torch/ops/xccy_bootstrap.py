"""Cross-currency basis-curve bootstrap — pillar-sequential, vectorized.

Port of ``adrates_tpu/ops/xccy_bootstrap.py``. The plan is the same host
numpy dataclass; the solve is torch:

 - between par solves the flat-forward-basis chain
       df_i = df_prev * (df_ois_i / df_ois_prev) * exp(-basis_i * dt_i)
   telescopes to  df_i = C_seg(i) * base_i  with
       base_i = df_ois_i * exp(cumsum(-basis_i * dt_i));
 - each pillar's par condition needs only PV_known_k = V0_k +
   sum_s C_s * W[k, s] with a tiny [S, S+1] weight matrix, so the
   sequential part collapses from n payment points to S pillars: the
   strictly-lower-triangular system (I - A) x = b.

A is nilpotent of index <= S, so ceil(log2 S) Neumann doublings
v <- v + A^(2^k) v give the exact solution. The solve is
``ops/linear_solve.neumann_solve``, the counterpart of the JAX package's
``lax.custom_linear_solve`` here: the doubling runs in ``torch.matmul``
with the powers squared once per solve, and every AD level is one more
solve (with Aᵀ for reverse mode) instead of recorded doublings. At most
one forward-mode level may pass through it.

The foreign curve's DFs at the cashflow times come from a static plan
(``foreign_plan``: ``ops/interpolation.interp_plan`` over the cashflow
query times, of any scheme, or the stacked fitted plan of a stage's
members, evaluated in one ``ops/fitted_rows`` call) or,
without one, from ``interp_fit`` plus ``interp_df`` on the foreign grid
(``foreign_times``), under the foreign curve's own scheme either way.

FX convention: spot_fx is DOMESTIC per FOREIGN, and the par condition is
PV_dom + spot_fx * PV_for = 0.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.error import LibError
from .interpolation import df_static, interp_df, interp_fit
from .linear_solve import neumann_solve


@dataclasses.dataclass(frozen=True)
class XccyBootstrapPlan:
    """Static topology of an XCCY bootstrap (chain points sorted by
    (time, swap index); value-date points excluded from the chain).
    Fields are numpy on the host; a stacked plan has a leading [G] curve
    axis on every array (see :func:`plan_to_torch` for the device form).
    """
    times: np.ndarray            # [n] payment times (ACT/365F curve units)
    pay_t_foreign: np.ndarray    # [n] payment times in foreign-curve units
    start_t: np.ndarray          # [n] accrual starts (foreign-curve units)
    end_t: np.ndarray            # [n] accrual ends
    notionals: np.ndarray        # [n]
    spread_sens: np.ndarray      # [n] year_frac * notional (0 for exchanges)
    alpha_ratio: np.ndarray      # [n] pay_alpha / index_alpha (1.0 when
    #   the leg accrues on the foreign curve's basis, and for exchanges)
    dt_chain: np.ndarray         # [n] time since previous chain point
    is_mat: np.ndarray           # [n] bool: pillar maturity point
    is_notl: np.ndarray          # [n] bool: pure notional exchange
    is_last: np.ndarray          # [n] bool: final payment incl. notional
    swap_of: np.ndarray          # [n] int32 parent swap
    seg_of: np.ndarray           # [n] int32 segment (pillars solved before)
    mat_pos: np.ndarray          # [S] int32 chain index of each pillar
    swap_onehot: np.ndarray      # [S, n] live non-maturity points per swap
    seg_onehot: np.ndarray       # [S+1, n]
    v0: np.ndarray               # [S] value-date cashflow sums per swap
    unique_sel: np.ndarray       # [U] int32 first-occurrence node indices
    foreign_sign: float = -1.0   # -1.0 for PAY legs


def plan_to_torch(plan: XccyBootstrapPlan, device) -> dict:
    """The plan's arrays as tensors on ``device`` (indices int64, masks
    bool, the rest f64), plus ``foreign_sign`` as a float."""
    out = {}
    for f in dataclasses.fields(XccyBootstrapPlan):
        v = getattr(plan, f.name)
        if f.name == "foreign_sign":
            out[f.name] = float(v)
            continue
        v = np.asarray(v)
        if v.dtype == np.bool_:
            out[f.name] = torch.as_tensor(v, device=device)
        elif np.issubdtype(v.dtype, np.integer):
            out[f.name] = torch.as_tensor(v.astype(np.int64), device=device)
        else:
            out[f.name] = torch.as_tensor(v.astype(np.float64),
                                          device=device)
    return out


def bootstrap_xccy(spreads: torch.Tensor, pv_dom: torch.Tensor,
                   foreign_dfs: torch.Tensor, spot_fx, plan: dict,
                   foreign_interp_type, foreign_plan=None,
                   foreign_times: torch.Tensor = None):
    """Solve the XCCY curve: (times, dfs) with the t=0 node prepended.

    spreads:     [S] pillar basis spreads (decimal)
    pv_dom:      [S] domestic-leg PVs of the calibration swaps
    foreign_dfs: the foreign OIS discount grid (t=0 node included)
    spot_fx:     domestic per foreign (a float or a 0-d tensor)
    plan:        :func:`plan_to_torch` dict
    foreign_interp_type: the foreign curve's scheme
    foreign_plan: the torch form of an ``interp_plan`` over
        concat(start_t, end_t, pay_t_foreign) x the foreign grid times
        (a stacked ``ops/fitted_rows.FittedPlan`` for a stacked fitted
        plan), or None
    foreign_times: the foreign grid's times, read when there is no plan

    With a stacked [G, ...] plan every argument carries the same leading
    [G] axis (``spot_fx`` as [G]) and so do the outputs.
    """
    n = plan["start_t"].shape[-1]
    if foreign_plan is not None:
        out = df_static(foreign_plan, foreign_dfs, foreign_interp_type)
    elif foreign_times is not None and plan["start_t"].dim() == 1:
        aux = interp_fit(foreign_times, foreign_dfs, foreign_interp_type)
        q = torch.cat([plan["start_t"], plan["end_t"],
                       plan["pay_t_foreign"]])
        out = interp_df(q, foreign_times, foreign_dfs, foreign_interp_type,
                        aux)
    else:
        raise LibError("bootstrap_xccy needs a static foreign "
                       "interpolation plan, or the foreign grid's times "
                       "for one curve")
    df_s, df_e = out[..., :n], out[..., n:2 * n]
    df_pay_ois = out[..., 2 * n:]

    is_notl, is_last, is_mat = plan["is_notl"], plan["is_last"], \
        plan["is_mat"]
    notionals = plan["notionals"]
    sp_of = spreads.gather(-1, plan["swap_of"])          # [n]

    # Cashflows: forward coupons (+ final notional) or exchanges; the pay
    # alpha cancels against the forward's divisor only up to the basis
    # ratio.
    interest = (df_s / df_e - 1.0) * notionals * plan["alpha_ratio"] \
        + torch.where(is_last, notionals, 0.0)
    exchange = torch.where(is_last, notionals, -notionals)
    cf = torch.where(is_notl, exchange, interest) \
        + sp_of * plan["spread_sens"]

    # Flat-forward-basis chain, telescoped.
    base = df_pay_ois * torch.exp(torch.cumsum(-sp_of * plan["dt_chain"],
                                               dim=-1))

    # Per-(swap, segment) weights of known (non-maturity) payments:
    # W[k, s] = sum_i swap_onehot[k, i] * cf_i * base_i * seg_onehot[s, i]
    live_w = cf * base
    W = (plan["swap_onehot"] * live_w.unsqueeze(-2)) \
        @ plan["seg_onehot"].transpose(-1, -2)           # [S, S+1]

    cf_mat = cf.gather(-1, plan["mat_pos"])              # [S]
    base_mat = base.gather(-1, plan["mat_pos"])          # [S]

    fxs = torch.as_tensor(spot_fx, dtype=spreads.dtype,
                          device=spreads.device) * plan["foreign_sign"]
    fxs = fxs.unsqueeze(-1)                              # [.., 1]
    d = fxs * cf_mat * base_mat                          # [S]
    b_vec = -(pv_dom + fxs * (plan["v0"] + W[..., 0])) / d
    A = (-(fxs / d)).unsqueeze(-1) * W[..., 1:]          # [S, S] strict lower

    x = neumann_solve(A, b_vec)

    one = torch.ones(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device)
    C_final = torch.cat([one, x], dim=-1)
    D = x * base_mat

    # Node DFs: par-solved at pillars, chain values elsewhere.
    mat_rank = (torch.cumsum(is_mat.to(torch.int64), dim=-1) - 1).clamp(
        min=0)
    df_nodes = torch.where(is_mat, D.gather(-1, mat_rank),
                           C_final.gather(-1, plan["seg_of"]) * base)

    sel = plan["unique_sel"]
    out_times = plan["times"].gather(-1, sel)
    out_dfs = df_nodes.gather(-1, sel)
    zero = torch.zeros(out_times.shape[:-1] + (1,), dtype=out_times.dtype,
                       device=out_times.device)
    one = torch.ones(out_dfs.shape[:-1] + (1,), dtype=out_dfs.dtype,
                     device=out_dfs.device)
    return (torch.cat([zero, out_times], dim=-1),
            torch.cat([one, out_dfs], dim=-1))
