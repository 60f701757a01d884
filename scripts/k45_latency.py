#!/usr/bin/env python3
"""What one step of the OIS pv01 chain costs on one CUDA card, and whether
the split division of K4 / K5 (``adrates_torch/csrc/pv01_solve.cu``) is
the IEEE quotient.

    python3 scripts/k45_latency.py [--sass FILE]

Builds ``scripts/k45_latency.cu`` (which includes the kernels' source)
with the kernels' nvcc flags into a temporary directory and runs, on one
warp, 4,096 dependent steps x <- b + v / d of three kinds, each timed by
clock64 and the global timer: nvcc's own IEEE division (``v / d``), the
same dividing zero (every root of a plan; the expansion's slow path), and
the kernels' step (the select of the carried value or 0, their split
division with the reciprocal made ahead, the addition, a shared store).
Then 2^24 random (v, d) pairs of each of five kinds (exponents inside the
fast range, near its edges, all bit patterns, the solve's own magnitudes,
signed zeros) through the kernels' fast path, where their range checks
take it, and through ``v / d``: the quotients that differ in any bit
(NaNs aside) are counted, and must be none. With ``--sass FILE`` it
writes the probe library's SASS there. Prints one JSON line.
"""

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sass")
    args = ap.parse_args(argv[1:])
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("k45_latency: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    from adrates_torch.ops import kernels
    dev = torch.device("cuda", 0)
    P_, I_ = ctypes.c_void_p, ctypes.c_int
    with tempfile.TemporaryDirectory() as tmp:
        so = Path(tmp) / "k45_latency.so"
        subprocess.run([kernels._nvcc(), *kernels._NVCC_FLAGS, "-shared",
                        "-o", str(so), str(HERE / "scripts/k45_latency.cu")],
                       check=True)
        if args.sass:
            Path(args.sass).write_text(subprocess.run(
                [str(Path(kernels._nvcc()).parent / "cuobjdump"), "-sass",
                 str(so)], capture_output=True, text=True).stdout)
        lib = ctypes.CDLL(str(so))
        lib.k45_step_probe.argtypes = [I_, I_, P_, P_, P_, P_]
        lib.k45_exact_check.argtypes = [P_, P_, ctypes.c_long, P_, P_]
        out = dict(card=subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), steps={}, exact={})
        d = torch.tensor(1.0 + np.random.default_rng(1).uniform(0.01, 0.5, 16),
                         device=dev)
        n = 4096
        for kind, name in enumerate(("ieee_division", "ieee_division_of_zero",
                                     "kernel_step")):
            res = torch.tensor([0.3, 0.7, 0.0], dtype=torch.float64,
                               device=dev)
            cyc = torch.zeros(1, dtype=torch.int64, device=dev)
            ns = torch.zeros(1, dtype=torch.int64, device=dev)
            for _ in range(2):               # the second run is timed
                assert lib.k45_step_probe(kind, n, d.data_ptr(),
                                          res.data_ptr(), cyc.data_ptr(),
                                          ns.data_ptr()) == 0
            c, t = int(cyc.item()), int(ns.item())
            out["steps"][name] = dict(cycles=c / n, ns=t / n,
                                      ghz=c / max(t, 1))
        rng = np.random.default_rng(2)
        m = 1 << 24

        def bits(lo, hi):
            e = rng.integers(lo, hi, m, dtype=np.int64)
            f = rng.integers(0, 1 << 52, m, dtype=np.int64)
            s = rng.integers(0, 2, m, dtype=np.int64)
            return ((s << 63) | (e << 52) | f).view(np.float64)

        def any_bits():
            return rng.integers(-2**63, 2**63 - 1, m, dtype=np.int64,
                                endpoint=True).view(np.float64)

        cases = dict(
            in_range=(bits(623, 1425), bits(623, 1425)),
            near_edges=(bits(600, 650), bits(1400, 1440)),
            all_bits=(any_bits(), any_bits()),
            solve_magnitudes=(rng.normal(size=m) * 10.0 **
                              rng.integers(-12, 3, m),
                              1.0 + rng.uniform(0.0, 0.6, m)),
            signed_zeros=(np.where(rng.random(m) < 0.5, 0.0, -0.0),
                          bits(0, 2047)))
        for name, (v, dd) in cases.items():
            tv, td = torch.tensor(v, device=dev), torch.tensor(dd, device=dev)
            bad = torch.zeros(1, dtype=torch.int64, device=dev)
            fast = torch.zeros(1, dtype=torch.int64, device=dev)
            assert lib.k45_exact_check(tv.data_ptr(), td.data_ptr(), m,
                                       bad.data_ptr(), fast.data_ptr()) == 0
            out["exact"][name] = dict(pairs=m, fast_path=int(fast.item()),
                                      differ=int(bad.item()))
    print(json.dumps(out))
    bad = sum(r["differ"] for r in out["exact"].values())
    if bad:
        print(f"k45_latency: {bad} quotients differ from v / d",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
