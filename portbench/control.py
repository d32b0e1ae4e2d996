"""Readings for the limits of a cell's check, on the card at the cell's
own size (the benchmark's own runs do not run this).

For each seed: the cell's set-up, a short window at the cell's load and
the check against the plain reference, as a run makes them (the
program's readings); then, for the first ``--control-seeds`` seeds, the
control in the program's place: the plain reference computed with one of
the configuration's guarantees broken (``Driver.reference(...,
control=True)``: the DNA paths take ties in the reversed order, the
all-pairs scores fill only a band, the search keeps the first best cell
instead of the last), held against the reference as the program's
answers are. One JSON line a seed on standard output and in ``--out``.

    python3 portbench/control.py --workload cov10-allpairs --seeds 11,12,13 \\
        --seconds 3 --control-seeds 3 --out chiprun_out/control.jsonl
"""

import time

T_PROC = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(CHECKOUT))


def readings(cell: str, seed: int, seconds: float, control: bool, device: str = "cuda",
             workload=None, config=None) -> dict:
    """The program's and (with ``control``) the control's numbers of one
    seed."""
    import torch

    from portbench import gen, harness
    from portbench.driver import compare

    _, _, wl, cfg = harness.load_cell(cell, workload=workload, config=config)
    ctx = harness.Context(cfg, wl["params"], seed, torch.device(device))
    drv = harness.load_module("drivers", wl["driver"]).Driver(ctx)
    drv.setup()
    drv.warm()
    sample = set(drv.sample_inputs(gen.rng(seed, 98), int(wl["params"].get("check_inputs", 2))))
    w = harness.run_window(drv, ctx, seconds, sample, float(wl["params"].get("keep_share", 1.0)))
    drv.release()
    t = time.perf_counter()
    want = drv.reference(sorted(w.kept))
    out = {"cell": cell, "seed": seed, "requests": len(w.latency),
           "program": dict((n, v) for n, v, _ in compare(w.kept, want, drv.same)),
           "reference_s": time.perf_counter() - t}
    if control:
        got = drv.reference(sorted(w.kept), control=True)
        ctrl = {x: [got[x]] * len(v) for x, v in w.kept.items()}
        out["control"] = dict((n, v) for n, v, _ in compare(ctrl, want, drv.same))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    for k, seed in enumerate(seeds):
        rec = readings(args.workload, seed, args.seconds, k < args.control_seeds)
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
