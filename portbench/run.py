"""The benchmark's command: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, the kernel library, the cell's data from the seed, its
warm-up) counts as ``setup_s``; then requests run in a closed loop for
``--seconds``; then the answers kept from the window are held against
the plain reference. The last lines on standard error are the numbers
compared, each beside its limit; the last line on standard output is the
result object. A run without CUDA, or with fewer cards than the cell
asks for, prints no result and exits 2; one that finds JAX or the JAX
package loaded once its window has closed exits 3.
"""

import time

T_PROC = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
# Build and kernel caches stay at fixed paths inside the checkout.
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CHECKOUT / "portbench" / "_cache" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(CHECKOUT / "portbench" / "_cache" / "triton"))
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
# One process with few threads: the host side of a request stays on one.
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
sys.path.insert(0, str(CHECKOUT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness

    bench = harness.load_json(CHECKOUT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(entry["chips"]):
        print(f"cell {args.workload} needs {entry['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    result, checks = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                                 t_proc=T_PROC, bench=bench,
                                 log=lambda s: print(s, file=sys.stderr, flush=True))
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded after the window: {', '.join(bad)}", file=sys.stderr)
        return 3
    lines = [f"check {name}: {value} (limit {limit})" for name, value, limit in checks]
    print("\n".join(lines), file=sys.stderr, flush=True)
    print(json.dumps(harness.jsonable(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
