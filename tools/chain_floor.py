"""Measure on one CUDA card the chain floor of the staged walks in
``genomics_rs_tpu_torch/csrc/traceback_walk.cu``: one dependent
shared-memory load a step (``x = s[x]`` through a shuffled ring in shared
memory, ``tools/smem_chase.cu``, built here with nvcc), ns a step from two
chase lengths' CUDA-event times (the median of ``--reps``). ``chip_smoke.py``
calls :func:`chain_floor_ns` in its phase 1.

Prints the card's name and power limit, then one JSON object (also written
to ``--out``, when given).

    python3 tools/chain_floor.py [--reps 3] [--out chain_floor.json]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0]


def chain_floor_ns(torch, reps: int) -> float:
    """ns of one dependent shared-memory load, from tools/smem_chase.cu."""
    from genomics_rs_tpu_torch.ops._build import _find_nvcc

    with tempfile.TemporaryDirectory() as tmp:
        so = os.path.join(tmp, "libchase.so")
        subprocess.run([_find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                        "-shared", "-Xcompiler", "-fPIC", "-o", so,
                        os.path.join(ROOT, "tools", "smem_chase.cu")], check=True)
        lib = ctypes.CDLL(so)
        lib.smem_chase_launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                                          ctypes.c_void_p, ctypes.c_void_p]
        n = 4096
        perm = np.random.default_rng(0).permutation(n)
        ring = np.empty(n, np.int32)
        ring[perm] = np.roll(perm, -1)  # one cycle through every slot
        dev = torch.device("cuda")
        ring_d = torch.from_numpy(ring).to(dev)
        out = torch.zeros(1, dtype=torch.int32, device=dev)
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

        def run(steps):
            ts = []
            for _ in range(reps + 1):
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                err = lib.smem_chase_launch(ctypes.c_void_p(ring_d.data_ptr()), n, steps,
                                            ctypes.c_void_p(out.data_ptr()), stream)
                b.record()
                torch.cuda.synchronize()
                if err:
                    raise RuntimeError(f"smem_chase_launch failed ({err})")
                ts.append(a.elapsed_time(b))
            return float(np.median(ts[1:]))

        lo, hi = 1 << 20, 1 << 22
        return (run(hi) - run(lo)) * 1e6 / (hi - lo)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("chain_floor.py needs a CUDA card")

    card = card_line()
    print(f"card {card} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    floor = chain_floor_ns(torch, args.reps)
    print(f"chain floor: {floor:.3f} ns a dependent shared-memory load", flush=True)

    result = {"card": card, "chain_floor_ns": floor}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
