#!/usr/bin/env python3
"""Count the torch ops of one warm staged call of flagship_v5, on the
FLAT_FWD curves and on ``flagship_v5.SPLINE_SCHEMES``, region by region,
and region A's and C2's ops stage by stage.

    python3 scripts/staged_ops.py [N_TRADES] [--as-card]

Runs on the CPU at a small book (N_TRADES, default 1,004: the base book
once) and one 50-scenario chunk, the staged path's chunk at bench.py's
100 scenarios. It counts the leaf aten ops of a torch.profiler trace (ops
with no aten op below them, views and metadata ops left out): a
host-side estimate of the kernels a call launches on a card, whose count
does not depend on the number of trades. On the CPU the fitted-rows
wrappers (K6's entries and K7) run their plain twins, dozens of ops
each, and K13 / K14 (the OIS stage, ``ops/kernels.ois_stage_jvp`` /
``ois_stage_hess``) theirs, ``torch.func`` towers; with ``--as-card``
each call of one counts as the one op its kernel is on a card (its
outputs made by one ``torch.zeros`` or ``torch.ones``), so that the
count estimates the card's. The values are then wrong: only the count is
read. Region A's and C2's stage passes run inside profiler spans
``<region>:<kind>:G=<members>:Qp=<quotes>`` (``structured_risk._span``);
the ops inside each are printed as ``stages``.
"""

import pathlib
import sys
import warnings

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from adrates_torch.examples import flagship_v5 as cfg  # noqa: E402
from adrates_torch.parallel import multibook as tmb  # noqa: E402

_NO_KERNEL = {
    "view", "as_strided", "reshape", "expand", "permute", "transpose",
    "select", "slice", "unsqueeze", "squeeze", "t", "detach", "alias",
    "empty", "_unsafe_view", "lift_fresh", "resolve_conj", "resolve_neg",
    "empty_like", "empty_strided", "narrow", "unbind", "split", "chunk",
    "_reshape_alias", "expand_as", "view_as", "contiguous", "movedim",
    "flatten", "unflatten", "diagonal", "split_with_sizes", "item",
    "_local_scalar_dense", "is_nonzero", "result_type", "to", "_to_copy",
    "unfold", "squeeze_"}
_NO_KERNEL = {"aten::" + n for n in _NO_KERNEL}


def _leaves(prof):
    """The leaf non-view aten events of a trace."""
    for e in prof.events():
        if not e.name.startswith("aten::") or e.name in _NO_KERNEL:
            continue
        if not any(c.name.startswith("aten::") and c.name not in _NO_KERNEL
                   for c in e.cpu_children):
            yield e


def leaf_ops(f) -> int:
    """Leaf non-view aten ops of one ``f()`` call."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        f()
    return sum(1 for _ in _leaves(prof))


def stage_ops(f) -> dict:
    """{stage span: leaf non-view aten ops inside it} of one ``f()``
    call (the spans of region A's and C2's stage passes)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        f()
    out = {}
    for e in _leaves(prof):
        p = e.cpu_parent
        while p is not None and not p.name.startswith(("A:", "C2:")):
            p = p.cpu_parent
        if p is not None:
            out[p.name] = out.get(p.name, 0) + 1
    return out


def count(schemes, n_trades: int, as_card: bool = False) -> dict:
    cfg.N_TRADES = n_trades
    model = cfg.build_model(schemes=schemes)
    with warnings.catch_warnings():        # CHF has no trades
        warnings.simplefilter("ignore", UserWarning)
        mb, shocks = cfg.build_book(model, np.random.default_rng(cfg.SEED))
    shocks = shocks[:50]
    fn = tmb.make_staged_multibook_fn(mb, "cpu")
    q0 = mb.basket.quotes0
    saved = _one_op_kernels() if as_card else {}
    fn(q0, shocks)
    out = {"call": leaf_ops(lambda: fn(q0, shocks))}
    r = fn.regions
    q = torch.as_tensor(q0)[None, :] + torch.as_tensor(shocks)
    a = r["A"](q)
    _, v_of = r["C1"](q, a["g"], a["carry"])
    out.update(A=leaf_ops(lambda: r["A"](q)),
               C1=leaf_ops(lambda: r["C1"](q, a["g"], a["carry"])),
               C2=leaf_ops(lambda: r["C2"](q, a["g"], v_of)),
               P=leaf_ops(lambda: r["P"](a["dfs"])))
    out["stages"] = dict(
        stage_ops(lambda: r["A"](q)),
        **stage_ops(lambda: r["C2"](q, a["g"], v_of)))
    from adrates_torch.ops import kernels
    for name, f in saved.items():
        setattr(kernels, name, f)
    return out


def _one_op_kernels() -> dict:
    """K6, K7, K13 and K14 as one op a call, the shape of their outputs,
    until the returned wrappers are put back (the model and the book are
    built with the real ones)."""
    from adrates_torch.ops import kernels
    saved = {k: getattr(kernels, k) for k in (
        "fitted_eval", "fitted_eval_jvp", "fitted_rows", "fitted_rows_t",
        "ois_stage_jvp", "ois_stage_hess") if hasattr(kernels, k)}

    def ois_jvp(tab, q):
        n = [tab.P1, tab.W, tab.Qp * tab.P1, tab.Qp * tab.W]
        out = torch.zeros((q.shape[0], tab.G, sum(n)), dtype=q.dtype)
        a, b, c, d = out.split(n, dim=-1)
        return (a, b, c.reshape(-1, tab.G, tab.Qp, tab.P1).transpose(1, 2),
                d.reshape(-1, tab.G, tab.Qp, tab.W).transpose(1, 2))

    kernels.ois_stage_jvp = ois_jvp
    kernels.ois_stage_hess = lambda tab, q, gs, vs: torch.zeros(
        (q.shape[0], tab.Qp, tab.G, tab.Qp), dtype=q.dtype)
    kernels.fitted_rows = lambda X, tab: torch.zeros(
        (X.shape[0], tab.G, tab.W_max), dtype=X.dtype)
    kernels.fitted_rows_t = lambda U, tab: torch.zeros(
        (U.shape[0], tab.G, tab.K, tab.n_max), dtype=U.dtype)
    if "fitted_eval" in saved:
        kernels.fitted_eval = lambda d, plan: torch.ones(
            (d.shape[0], plan.G, plan.tables.W_max), dtype=d.dtype)
        kernels.fitted_eval_jvp = lambda d, dd, out, plan: torch.zeros(
            dd.shape[:2] + (plan.G, plan.tables.W_max), dtype=d.dtype)
    return saved


def main() -> int:
    args = [a for a in sys.argv[1:] if a != "--as-card"]
    as_card = "--as-card" in sys.argv[1:]
    n = int(args[0]) if args else 1004
    for label, schemes in (("FLAT_FWD", None),
                           ("SPLINE_SCHEMES", cfg.SPLINE_SCHEMES)):
        print(f"{label}: leaf aten ops of one warm 50-scenario staged call "
              f"and of its regions: {count(schemes, n, as_card)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
