"""The run: set-up, a closed-loop window of requests, the check against
the plain reference, the metrics and the result line.

Everything that belongs to one cell is found by name: the cell in
``BENCHMARK.json`` and ``workloads/<cell>.json``, its configuration in
``configs/<config>.json``, its request kind in ``drivers/<driver>.py``
and each metric in ``metrics/<metric>.py``. Adding a cell, a
configuration, a request kind or a metric adds files and edits none.

One client: the next request starts when the last one has returned its
result to the host. The window closes at the end of the first request
that ends past ``--seconds``; rates are over all the work and all the
time of the window, the tail over all of its requests.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from portbench import bound, gen

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
#: top-level modules a run may not hold once its window has closed.
FORBIDDEN = ("jax", "jaxlib", "flax", "genomics_rs_tpu")
#: the program whose launch counters the harness reads.
PROGRAM = "genomics_rs_tpu_torch"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` under the benchmark's folder, by file path
    (a metric's name may hold dots)."""
    path = ROOT / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(cell: str, bench=None, workload=None, config=None):
    """``(bench, entry, workload, config)`` of ``cell``: its entry in
    ``BENCHMARK.json`` and its files, each unless given."""
    bench = load_json(REPO / "BENCHMARK.json") if bench is None else bench
    entry = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise SystemExit(f"no cell {cell!r} in BENCHMARK.json")
    wl = load_json(ROOT / "workloads" / f"{cell}.json") if workload is None else workload
    cfg = load_json(ROOT / "configs" / f"{entry['config']}.json") if config is None else config
    return bench, entry, wl, cfg


def cell_metrics(bench: dict, cell: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics that ``cell`` reports."""
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def forbidden_modules() -> list[str]:
    """Modules loaded in this process whose top-level name is one of
    :data:`FORBIDDEN`, compared whole."""
    return sorted({n for n in sys.modules if n.split(".")[0] in FORBIDDEN})


def launch_counts() -> dict[str, int]:
    """Every ``*COUNTS`` dict of the program's loaded ``ops`` modules,
    flattened to ``"<module>.<dict>.<key>"``."""
    out = {}
    for name, mod in list(sys.modules.items()):
        if not name.startswith(PROGRAM + ".ops.") or mod is None:
            continue
        for attr, val in vars(mod).items():
            if attr.endswith("COUNTS") and isinstance(val, dict):
                for key, n in val.items():
                    out[f"{name.rsplit('.', 1)[1]}.{attr}.{key}"] = int(n)
    return out


def counts_delta(before: dict, after: dict) -> dict[str, int]:
    return {k: after.get(k, 0) - before.get(k, 0) for k in after if after.get(k, 0) != before.get(k, 0)}


class Context:
    """What a driver gets: its configuration and traffic, the seed, the
    device, and spans that the traced run records."""

    def __init__(self, cfg: dict, params: dict, seed: int, device: torch.device):
        self.cfg, self.params, self.seed, self.device = cfg, params, seed, device
        self.tracing = False

    def span(self, name: str):
        """A named range in the traced run; nothing otherwise."""
        if self.tracing:
            return torch.profiler.record_function(f"portbench/{name}")
        return contextlib.nullcontext()

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


class Window:
    """What the window saw: latencies, work and the kept answers."""

    def __init__(self):
        self.latency: list[float] = []
        self.cells = 0.0
        self.work: dict[str, list[float]] = {}
        self.attempted = self.failed = 0
        self.kept: dict[int, list] = {}
        self.seconds = 0.0
        self.counts: dict[str, int] = {}


def run_window(drv, ctx: Context, seconds: float, sample: set, keep_share: float) -> Window:
    """Requests in turn until one ends past ``seconds``."""
    w = Window()
    pick = gen.rng(ctx.seed, 99)
    before = launch_counts()
    t_start = time.perf_counter()
    deadline = t_start + seconds
    k = 0
    while True:
        t0 = time.perf_counter()
        if t0 >= deadline and k:
            break
        w.attempted += 1
        try:
            with ctx.span("request"):
                out = drv.request(k)
        except Exception:  # a request that fails is counted, the window goes on
            w.failed += 1
            if w.failed == 1:
                traceback.print_exc()
            out = None
        t1 = time.perf_counter()
        if out is not None:
            w.latency.append(t1 - t0)
            w.cells += drv.cells(k)
            for kid, (ops, nbytes) in drv.work(k).items():
                acc = w.work.setdefault(kid, [0.0, 0.0])
                acc[0] += ops
                acc[1] += nbytes
            x = drv.input_of(k)
            if x in sample and (x not in w.kept or pick.random() < keep_share):
                w.kept.setdefault(x, []).append(drv.keep(k, out))
        k += 1
    w.seconds = time.perf_counter() - t_start
    w.counts = counts_delta(before, launch_counts())
    return w


class MetricContext:
    """What a metric reader gets: the window, the trace (traced runs)
    and the card's int32 rate."""

    def __init__(self, w: Window, trace, rate: float, setup_s: float):
        self.window, self.trace, self.rate, self.setup_s = w, trace, rate, setup_s
        self.requests = len(w.latency)
        self.notes: list[str] = []

    def count(self, prefix: str) -> int:
        """Launches in the window counted under keys starting ``prefix``
        (``"<module>.<dict>.<key>"``)."""
        return sum(v for k, v in self.window.counts.items() if k.startswith(prefix))

    def roofline(self, kid: str, match) -> float | None:
        """Bound time of the window's ``kid`` work over the summed device
        time of the kernels ``match`` accepts."""
        if self.trace is None or kid not in self.window.work:
            return None
        ops, nbytes = self.window.work[kid]
        got = bound.share_pct(ops, nbytes, self.trace.kernel_s(match), self.rate)
        if got is None:
            return None
        self.notes.append(f"roofline {kid}: {got[0]:.4f}% (bound by {got[1]})")
        return got[0]


def device_info(dev: torch.device, chips: int) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": chips,
            "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(d) for d in range(chips)))}


def run(cell: str, seed: int, seconds: float, trace: bool, *, t_proc: float,
        device: str = "cuda", bench: dict | None = None, workload: dict | None = None,
        config: dict | None = None, allow_plain: bool = False, log=print) -> tuple[dict, list]:
    """One run of ``cell``. Returns the result object and the checks
    ``[(name, value, limit)]``; ``log`` takes the stderr lines."""
    bench, entry, wl, cfg = load_cell(cell, bench, workload, config)
    dev = torch.device(device)
    chips = int(entry["chips"])
    split = {"imports": time.perf_counter() - t_proc}
    t = time.perf_counter()
    if dev.type == "cuda":
        from genomics_rs_tpu_torch.ops import _build

        torch.cuda.init()
        _build.library()
        split["library"] = time.perf_counter() - t
        split["nvcc"] = _build.BUILD_INFO["seconds"] if "ptxas" in _build.BUILD_INFO else 0.0
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        rate, clock = bound.card_rate(sms)
        log(f"card {torch.cuda.get_device_name(dev)}, power limit {bound.smi('power.limit')} W, "
            f"{sms} SMs at {clock:.0f} MHz: int32 {rate:.4g} ops/s, HBM "
            f"{bound.HBM_BYTES_PER_S:.4g} B/s | torch {torch.__version__}")
    else:
        rate = bound.int32_rate(1, 1000.0)
    ctx = Context(cfg, wl["params"], seed, dev)
    drv = load_module("drivers", wl["driver"]).Driver(ctx)
    t = time.perf_counter()
    drv.setup()
    ctx.sync()
    split["data"] = time.perf_counter() - t
    t = time.perf_counter()
    drv.warm()
    ctx.sync()
    split["warm"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_proc
    log("setup split (s): " + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
        + f"; setup_s {setup_s:.3f}")

    sample = set(drv.sample_inputs(gen.rng(seed, 98), int(wl["params"].get("check_inputs", 2))))
    keep_share = float(wl["params"].get("keep_share", 1.0))
    prof = None
    if trace:
        ctx.tracing = True
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            w = run_window(drv, ctx, seconds, sample, keep_share)
            ctx.sync()
        ctx.tracing = False
    else:
        w = run_window(drv, ctx, seconds, sample, keep_share)
    info = device_info(dev, chips)

    metrics = {}
    tr = None
    if trace:
        from portbench.devtrace import Trace

        t = time.perf_counter()
        tr = Trace.from_profiler(prof)
        del prof
        info["busy_s"] = tr.busy_s
        info["window_s"] = tr.window_s
        log(f"trace read in {time.perf_counter() - t:.2f} s: {len(tr.device)} device events, "
            f"{len(tr.host)} host events, {tr.requests} requests")
    mctx = MetricContext(w, tr, rate, setup_s)
    kind = "per_layer" if trace else "end_to_end"
    for m in cell_metrics(bench, cell, kind):
        v = load_module("metrics", m["name"]).read(mctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    for note in mctx.notes:
        log(note)

    # The check: the program's state goes first, then the reference.
    drv.release()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    checks = drv.check(w.kept)
    log(f"reference check in {time.perf_counter() - t:.2f} s over {sum(map(len, w.kept.values()))}"
        f" kept answers of inputs {sorted(w.kept)}")
    plain = sum(v for k, v in w.counts.items() if "plain" in k.rsplit(".", 1)[1])
    checks += [("failed_requests", w.failed, 0),
               ("plain_calls", 0 if allow_plain else plain, 0)]
    correct = all(v <= lim for _, v, lim in checks)
    result = {"correct": bool(correct), "attempted": w.attempted, "failed": w.failed,
              "metrics": metrics, "device": info}
    if trace:
        result["breakdown"] = {"device_ops": tr.by_name(), "idle_gaps": tr.idle_gaps()}
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    log(f"window {w.seconds:.3f} s, {len(w.latency)} requests, {w.cells:.6g} cells, "
        f"launches {w.counts}")
    return result, checks


def jsonable(x):
    """Floats as measured; NaN and infinities as null."""
    if isinstance(x, dict):
        return {k: jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [jsonable(v) for v in x]
    if isinstance(x, (np.integer,)):
        return int(x)
    if isinstance(x, (float, np.floating)):
        return None if not math.isfinite(float(x)) else float(x)
    return x
