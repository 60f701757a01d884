#!/usr/bin/env python3
"""Count the torch ops of one warm staged call of flagship_v5, on the
FLAT_FWD curves and on ``flagship_v5.SPLINE_SCHEMES``, region by region.

    python3 scripts/staged_ops.py [N_TRADES]

Runs on the CPU at a small book (N_TRADES, default 1,004: the base book
once) and one 50-scenario chunk, the staged path's chunk at bench.py's
100 scenarios. It counts the leaf aten ops of a torch.profiler trace (ops
with no aten op below them, views and metadata ops left out): a
host-side estimate of the kernels a call launches on a card, whose count
does not depend on the number of trades.
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


def leaf_ops(f) -> int:
    """Leaf non-view aten ops of one ``f()`` call."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        f()
    n = 0
    for e in prof.events():
        if not e.name.startswith("aten::") or e.name in _NO_KERNEL:
            continue
        if not any(c.name.startswith("aten::") and c.name not in _NO_KERNEL
                   for c in e.cpu_children):
            n += 1
    return n


def count(schemes, n_trades: int) -> dict:
    cfg.N_TRADES = n_trades
    model = cfg.build_model(schemes=schemes)
    with warnings.catch_warnings():        # CHF has no trades
        warnings.simplefilter("ignore", UserWarning)
        mb, shocks = cfg.build_book(model, np.random.default_rng(cfg.SEED))
    shocks = shocks[:50]
    fn = tmb.make_staged_multibook_fn(mb, "cpu")
    q0 = mb.basket.quotes0
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
    return out


def main() -> int:
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1004
    for label, schemes in (("FLAT_FWD", None),
                           ("SPLINE_SCHEMES", cfg.SPLINE_SCHEMES)):
        print(f"{label}: leaf aten ops of one warm 50-scenario staged call "
              f"and of its regions: {count(schemes, n)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
