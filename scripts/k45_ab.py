#!/usr/bin/env python3
"""K4 (``pv01_solve``) and K5 (``pv01_solve_t``) of one checkout at the
engine request's and flagship_v5's region A's largest solves, on one CUDA
card.

    python3 scripts/k45_ab.py [ROOT] [--inputs FILE]

ROOT is a checkout of this repository (default: the one holding this
script); its ``adrates_torch`` is imported and its kernels built. The
inputs are captured as ``chip_smoke.py``'s phase 8 captures them (the
wrappers watched during ``bench.py``'s config-2 VALUE + DELTA + GAMMA
request and during one staged flagship_v5 call at S = 100; per kernel the
call with the most rows: [32, 72] on one plan and region A's [11,200, 72]
on seven). With ``--inputs FILE`` they are read from FILE where it exists,
else captured and written there, so that two checkouts are timed on the
same inputs. For each kernel and path it checks the kernel against its
plain version (K4 bit for bit; K5 at 1e-14 x max|ref|, and says whether it
is bit for bit), then times it 30 times by CUDA events around the call
and 30 times by the device time of its kernel in one torch.profiler
trace, beside one batched ``torch.linalg.solve_triangular`` on the dense
unit triangular (I - A), and on one row a plan: the chain, whose device
time over P is the latency of one step. Prints one JSON line. To compare
commits, run parent, change, change, parent in one call.
"""

import argparse
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
KERNELS = ("pv01_solve", "pv01_solve_t")


def _capture(cs, dev) -> dict:
    """{path: {kernel: (rhs, denom, plan host arrays)}} on the CPU."""
    import numpy as np
    import warnings

    from adrates_torch.examples import flagship_v5 as cfg
    from adrates_torch.parallel.multibook import warmup_multibook
    from adrates_torch.utils import RequestTypes as R
    model = cfg.build_model()
    pos = cs._config2_swap(model).position(model, device=dev)
    reqs = [R.VALUE, R.DELTA, R.GAMMA]
    pos.compute(reqs)
    got = {"engine_config2": cs._capture_solves(lambda: pos.compute(reqs))}
    with warnings.catch_warnings():        # CHF has no trades
        warnings.simplefilter("ignore", UserWarning)
        mb, shocks = cfg.build_book(model, np.random.default_rng(cfg.SEED))
    fn = warmup_multibook(mb, shocks.shape[0], dev, staged=True)
    q0 = mb.basket.quotes0
    got["flagship_v5"] = cs._capture_solves(lambda: fn(q0, shocks))
    out = {}
    for path, solves in got.items():
        out[path] = {}
        for name, (rhs, denom, tab) in solves.items():
            out[path][name] = dict(
                rhs=rhs.cpu(), denom=denom.cpu(), depth=tab.depth,
                prev=tab.prev.cpu().reshape(tab.shape),
                child_idx=_child_table(tab).cpu(),
                child_mask=tab.child_mask.cpu())
    return out


def _child_table(tab):
    """A plan's child table [*shape, Kc] from its ChainTables' flat one."""
    import torch
    G, P = tab.prev.shape
    kc = tab.child_flat.numel() // (G * P)
    g = torch.arange(G, device=tab.child_flat.device).view(G, 1, 1) * P
    return (tab.child_flat.view(G, P, kc) - g).reshape(tab.shape + (kc,))


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?", default=str(HERE))
    ap.add_argument("--inputs")
    args = ap.parse_args(argv[1:])
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch
    if not torch.cuda.is_available():
        print("k45_ab: no CUDA device visible", file=sys.stderr)
        return 2
    import adrates_torch
    if root not in Path(adrates_torch.__file__).resolve().parents:
        raise AssertionError(f"imported {adrates_torch.__file__}, not from "
                             f"{root}")
    from adrates_torch.ops import kernels
    kernels.build_kernels()
    dev = torch.device("cuda", 0)
    inputs = Path(args.inputs) if args.inputs else None
    if inputs is not None and inputs.exists():
        data = torch.load(inputs)
        captured = False
    else:
        data = _capture(cs, dev)
        captured = True
        if inputs is not None:
            inputs.parent.mkdir(parents=True, exist_ok=True)
            torch.save(data, inputs)
    out = dict(root=str(root), card=cs._card_line(), captured=captured,
               paths={})
    for path, solves in data.items():
        for name in KERNELS:
            s = solves[name]
            tab = kernels.chain_tables(s["prev"].numpy(),
                                       s["child_idx"].numpy(),
                                       s["child_mask"].numpy(), s["depth"],
                                       dev)
            rhs, denom = s["rhs"].to(dev), s["denom"].to(dev)
            R, P = rhs.shape
            G = tab.prev.shape[0]
            kern = getattr(kernels, name)
            ref = getattr(kernels, name + "_plain")(rhs, denom, tab)
            got = kern(rhs, denom, tab)
            err = float((got - ref).abs().max() / ref.abs().max())
            exact = bool(torch.equal(got, ref))
            if name == "pv01_solve" and not exact:
                raise AssertionError(f"{path} K4 differs from its plain "
                                     f"version")
            cs._check(f"{path} {name} vs plain (abs / max|ref|)", err, 1e-14)
            M = cs._dense_chain(denom, tab)
            upper = name == "pv01_solve_t"
            if upper:
                M = M.mT.contiguous()
            b3 = rhs.unsqueeze(-1)
            r1, d1 = rhs[:G].contiguous(), denom[:G].contiguous()
            chain = cs._device_stats(lambda: kern(r1, d1, tab))
            rec = dict(
                rows=R, points=P, plans=G, err=err, bit_for_bit=exact,
                events=cs._cuda_stats(lambda: kern(rhs, denom, tab)),
                device=cs._device_stats(lambda: kern(rhs, denom, tab)),
                chain=chain,
                step_ns=chain and chain["median"] * 1e6 / P,
                library_device=cs._device_stats(
                    lambda: torch.linalg.solve_triangular(
                        M, b3, upper=upper, unitriangular=True)))
            out["paths"][f"{path}/{name}"] = rec
            print(f"{path} {name} [R, P]={[R, P]} on {G} plan(s): device "
                  f"{cs._fmt_ms(rec['device'] and rec['device']['median'])}"
                  f", events {rec['events']['median']:.4f} ms, chain "
                  f"{cs._fmt_ms(chain and chain['median'])} "
                  f"({rec['step_ns'] or 0:.1f} ns a step), solve_triangular "
                  f"{cs._fmt_ms(rec['library_device'] and rec['library_device']['median'])}"
                  f"; err {err:.1e}, bit for bit {exact}; card "
                  f"{out['card']}", flush=True)
            del M
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
