#!/usr/bin/env python3
"""The paths the OIS pv01 solve sits on, for one checkout, on one CUDA card:
device ops and walls of the engine's request and of flagship_v5's staged
regions.

    python3 scripts/solve_ab.py [ROOT]

ROOT is a checkout of this repository (default: the one holding this
script); its ``adrates_torch`` is imported and its kernels built. The
inputs and the timing helpers come from this checkout's
``chip_smoke.py``, so two checkouts are measured on the same inputs and
clocks. Measured:

- ``bench.py``'s config 2 (a 10Y OIS on flagship_v5's 32-pillar
  GBP_OIS_SONIA): VALUE + DELTA + GAMMA and SPEED, cold and warm on the
  host clock (20 and 5 warm), the device ops and device ms of one warm
  request (a CUDA-only torch.profiler trace);
- flagship_v5's staged path at S = 100: the warm call (median of 3) and
  its device ops, and regions A and C2 on the first 50-scenario chunk,
  each's host-clock ms (median of 3 warm) and the device ops and device
  ms of one warm region call;
- on flagship_v5 and on its ``SPLINE_SCHEMES`` book: the 256 selected
  trades' dense gammas (``make_per_trade_gamma_fn``, whose stage tensors
  take a second order through the bootstrap), and on the spline book
  the staged call too, each's host-clock ms (median of 3 warm) and the
  device ops and device ms of one warm call;
- K4 / K5 launches in each (none where the checkout has no such kernel).

Prints one JSON line. To compare commits, run parent, change, change,
parent in one call.
"""

import importlib.util
import json
import sys
import warnings
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def main(argv) -> int:
    root = Path(argv[1] if len(argv) > 1 else HERE).resolve()
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("solve_ab: no CUDA device visible", file=sys.stderr)
        return 2
    import adrates_torch
    if root not in Path(adrates_torch.__file__).resolve().parents:
        raise AssertionError(f"imported {adrates_torch.__file__}, not from "
                             f"{root}")
    from adrates_torch.examples import flagship_v5 as cfg
    from adrates_torch.ops import kernels
    from adrates_torch.parallel import make_per_trade_gamma_fn
    from adrates_torch.parallel.multibook import warmup_multibook
    from adrates_torch.utils import RequestTypes as R
    kernels.build_kernels()
    dev = torch.device("cuda", 0)
    solves = [k for k in ("pv01_solve", "pv01_solve_t")
              if hasattr(kernels, k)]

    def launches():
        return {k: getattr(kernels, k).launches for k in solves}

    def since(before):
        return {k: n - before[k] for k, n in launches().items()}

    def warm(f, n):
        f()
        return cs._stats([cs._timed(f)[1] for _ in range(n)])

    model = cfg.build_model()
    out = dict(root=str(root), card=cs._card_line(),
               torch=torch.__version__)

    pos = cs._config2_swap(model).position(model, device=dev)
    for key, reqs, n in (("config2", [R.VALUE, R.DELTA, R.GAMMA], 20),
                         ("config2_speed", [R.SPEED], 5)):
        _, cold = cs._timed(lambda: pos.compute(reqs))
        before = launches()
        w = warm(lambda: pos.compute(reqs), n)
        ls = since(before)
        ops, dms = cs._request_device(lambda: pos.compute(reqs))
        out[key] = dict(cold_ms=cold, warm_ms=w, device_ops=ops,
                        device_ms=dms, launches=ls, calls=n + 1)

    with warnings.catch_warnings():        # CHF has no trades
        warnings.simplefilter("ignore", UserWarning)
        mb, shocks = cfg.build_book(model, np.random.default_rng(cfg.SEED))
    q0 = mb.basket.quotes0
    fn = warmup_multibook(mb, shocks.shape[0], dev, staged=True)
    before = launches()
    w = warm(lambda: fn(q0, shocks), 3)
    ls = since(before)
    ops, dms = cs._request_device(lambda: fn(q0, shocks))
    out["staged"] = dict(warm_ms=w, device_ops=ops, device_ms=dms,
                         launches=ls, calls=4)
    chunk = fn.chunk(shocks.shape[0])
    q = torch.as_tensor(q0, device=dev)[None, :] \
        + torch.as_tensor(shocks[:chunk], device=dev)
    r = fn.regions
    a = r["A"](q)
    _, v_of = r["C1"](q, a["g"], a["carry"])
    for name, f in (("A", lambda: r["A"](q)),
                    ("C2", lambda: r["C2"](q, a["g"], v_of))):
        before = launches()
        w = warm(f, 3)
        ls = since(before)
        ops, dms = cs._request_device(f)
        out[f"region_{name}"] = dict(chunk=chunk, warm_ms=w, device_ops=ops,
                                     device_ms=dms, launches=ls, calls=4)
    for key, schemes in (("gamma_256", None),
                         ("gamma_256_splines", cfg.SPLINE_SCHEMES)):
        m = model if schemes is None else cfg.build_model(schemes=schemes)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            mb_k, sh_k = cfg.build_book(m, np.random.default_rng(cfg.SEED))
        g = make_per_trade_gamma_fn(mb_k, cs._select_trades(mb_k)[0], dev)
        q0k = mb_k.basket.quotes0
        calls = [(key, lambda: g(q0k))]
        if schemes is not None:
            fs = warmup_multibook(mb_k, sh_k.shape[0], dev, staged=True)
            calls.append(("staged_splines", lambda: fs(q0k, sh_k)))
        for name, f in calls:
            before = launches()
            w = warm(f, 3)
            ls = since(before)
            ops, dms = cs._request_device(f)
            out[name] = dict(warm_ms=w, device_ops=ops, device_ms=dms,
                             launches=ls, calls=4)
        del g, mb_k, calls
    torch.cuda.synchronize()
    print(json.dumps(out))
    summary = {k: (v["warm_ms"]["median"], v["device_ops"])
               for k, v in out.items() if isinstance(v, dict)}
    print(f"solve_ab {root.name}: (warm median ms, device ops) "
          f"{summary}; card {out['card']}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
