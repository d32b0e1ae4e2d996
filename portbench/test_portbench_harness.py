"""The harness on the CPU (the program's plain versions, tiny sizes):
discovery by name, BENCHMARK.json against the contract's shape, the
import guard, the check failing under planted faults, and the controls
failing at a size a test run holds."""

import ast
import copy
import json
import re
import shutil
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
BANNED = {"jax", "jaxlib", "flax", "genomics_rs_tpu"}
#: the yardstick: none of it may import the program either.
YARDSTICK = ("reference.py", "gen.py", "cells.py", "bound.py", "devtrace.py")


def bench():
    return harness.load_json(ROOT.parent / "BENCHMARK.json")


def tiny(cell: str):
    """(workload, config) of ``cell`` cut to a size the plain versions
    run in about a second."""
    wl = harness.load_json(ROOT / "workloads" / f"{cell}.json")
    cfg = harness.load_json(ROOT / "configs" / f"{wl['config']}.json")
    if wl["config"] == "cov-genomes":
        cfg["ancestor_bp"] = 300
        cfg["genomes"] = [{"bp": 260 + 10 * k, "identity": g["identity"]}
                          for k, g in enumerate(cfg["genomes"][:4])]
        cfg["small_indel_pairs_per_divergence"] = 8
    else:
        cfg.update(entries=200, length_median=60, length_mean=75, length_max=400)
    p = wl["params"]
    for key, small in (("corpora", 3), ("pairs", 3), ("queries", 4)):
        if key in p:
            p[key] = small
    p["keep_share"] = 1.0
    return wl, cfg


def run_cpu(cell, seed=2**31 + 12345, trace=False, **kw):
    wl, cfg = tiny(cell)
    return harness.run(cell, seed, 0.3, trace, t_proc=time.perf_counter(), device="cpu",
                       workload=wl, config=cfg, allow_plain=True, log=lambda s: None, **kw)


CELLS = [w["name"] for w in bench()["workloads"]]


def test_benchmark_json_has_the_contracts_shape():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["portbench"] and b["command"][1] == "portbench/run.py"
    assert 1 <= b["run_seconds"] <= 51
    e2e = {m["name"] for m in b["end_to_end"]}
    assert {"setup_s", "gcups", "p95_ms"} <= e2e
    names = [c["name"] for c in b["configs"]] + [w["name"] for w in b["workloads"]] + [
        m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        cfg = json.loads((ROOT.parent / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        f = harness.load_json(ROOT / "workloads" / f"{w['name']}.json")
        assert {k: f[k] for k in ("config", "traffic", "chips", "why")} == {
            k: w[k] for k in ("config", "traffic", "chips", "why")}
        assert (ROOT / "drivers" / f"{f['driver']}.py").is_file() and len(w["why"]) <= 200
        reported = {m["name"] for m in harness.cell_metrics(b, w["name"], "end_to_end")}
        assert "setup_s" in reported and len(reported) >= 2
        assert harness.cell_metrics(b, w["name"], "per_layer")
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"] and len(m["layer"]) <= 200
        for cell in m.get("workloads", CELLS):
            assert m["moves"] in {x["name"] for x in harness.cell_metrics(b, cell, "end_to_end")}
    for m in b["end_to_end"] + b["per_layer"]:
        assert callable(harness.load_module("metrics", m["name"]).read)


def imports_of(path: Path) -> set[str]:
    """Top-level names of every module ``path`` imports."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(ROOT.rglob("*.py")), ids=lambda p: p.name)
def test_no_module_imports_jax_or_the_jax_package(path):
    got = imports_of(path)
    assert not got & BANNED, f"{path} imports {got & BANNED}"
    if path.name in YARDSTICK:
        assert "genomics_rs_tpu_torch" not in got


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "genomics_rs_tpu_torchx", None)
    monkeypatch.setitem(sys.modules, "jaxfoo.bar", None)
    assert harness.forbidden_modules() == [] or all(
        n.split(".")[0] in BANNED for n in harness.forbidden_modules())
    monkeypatch.setitem(sys.modules, "genomics_rs_tpu.config", None)
    assert "genomics_rs_tpu.config" in harness.forbidden_modules()


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_end_to_end_on_the_plain_versions(cell, trace):
    result, checks = run_cpu(cell, trace=trace)
    assert result["correct"], checks
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in harness.cell_metrics(bench(), cell, kind)}
    assert set(result["metrics"]) <= want
    if not trace:
        assert set(result["metrics"]) == want
    assert list(result)[-1] == "checks"


def test_a_new_config_cell_driver_and_metric_are_found_without_edits(tmp_path, monkeypatch):
    root = tmp_path / "portbench"
    shutil.copytree(ROOT, root, ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    cfg = harness.load_json(root / "configs" / "cov-genomes.json")
    cfg.update(name="cov-local", ancestor_bp=200,
               genomes=[{"bp": 180 + 5 * k, "identity": 0.9} for k in range(3)])
    (root / "configs" / "cov-local.json").write_text(json.dumps(cfg))
    (root / "drivers" / "allpairs_local.py").write_text(
        "from portbench.drivers import allpairs\n\n\n"
        "class Driver(allpairs.Driver):\n    pass\n")
    (root / "metrics" / "requests_seen.py").write_text(
        "def read(c):\n    return float(c.requests)\n")
    wl = {"config": "cov-local", "traffic": "corpus2", "driver": "allpairs_local", "chips": 1,
          "why": "a test cell", "params": {"corpora": 2, "check_inputs": 1,
                                           "control_band": 1024}}
    (root / "workloads" / "cov-local-allpairs.json").write_text(json.dumps(wl))
    b = copy.deepcopy(bench())
    b["configs"].append({"name": "cov-local", "source": "https://example.org", "file":
                         "portbench/configs/cov-local.json", "reduced": [], "why": "test"})
    b["workloads"].append({"name": "cov-local-allpairs", "config": "cov-local",
                           "traffic": "corpus2", "chips": 1, "why": "a test cell"})
    for m in b["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append("cov-local-allpairs")
    b["end_to_end"].append({"name": "requests_seen", "unit": "requests", "better": "higher",
                            "bound": 0.05, "source": "host_clock",
                            "workloads": ["cov-local-allpairs"]})
    monkeypatch.setattr(harness, "ROOT", root)
    result, _ = harness.run("cov-local-allpairs", 3, 0.2, False, t_proc=time.perf_counter(),
                            device="cpu", bench=b, allow_plain=True, log=lambda s: None)
    assert result["correct"] and result["metrics"]["requests_seen"]["value"] >= 1
    assert {"gcups", "p95_ms", "setup_s"} <= set(result["metrics"])


def _alter_first(fn, how):
    def wrapped(*a, **k):
        return how(fn(*a, **k))
    return wrapped


def _plus_one(m):
    m = m.copy()
    m[-1, -1] += 1
    return m


def _drop_half(m):
    m = m.copy()
    rows = np.arange(m.shape[0])
    m[rows[: m.shape[0] // 2]] = 0
    return m


FAULTS = {
    # an answer altered where it is produced
    ("cov10-allpairs", "answer"): ("genomics_rs_tpu_torch.parallel.allpairs",
                                   "_score_pairs_bucketed",
                                   lambda r: (_plus_one(r[0][None])[0], r[1])),
    # half of the batch left out: the first half of the pairs never scored
    ("cov10-allpairs", "half"): ("genomics_rs_tpu_torch.parallel.allpairs",
                                 "_score_pairs_bucketed",
                                 lambda r: (np.where(np.arange(r[0].size) < r[0].size // 2, 0,
                                                     r[0]), r[1])),
    ("swissprot-search", "answer"): ("genomics_rs_tpu_torch.ops.gotoh_matrix",
                                     "gotoh_scores_matrix",
                                     lambda r: (r[0] + (r[0] == r[0].max()).int(), r[1], r[2])),
    ("swissprot-search", "half"): ("genomics_rs_tpu_torch.ops.gotoh_matrix",
                                   "gotoh_scores_matrix",
                                   lambda r: tuple(x.clone().index_fill_(
                                       0, __import__("torch").arange(x.shape[0] // 2 + 1), 0)
                                       for x in r)),
    ("cov-align-pair", "answer"): ("genomics_rs_tpu_torch.models.aligner", "classify_moves",
                                   lambda al: setattr(al, "matches", al.matches + 1) or al),
    ("cov-banded", "answer"): ("genomics_rs_tpu_torch.models.banded", "gotoh_banded",
                               lambda r: (r[0] + 1, r[1])),
}


@pytest.mark.parametrize("cell,fault", sorted(FAULTS))
def test_a_planted_fault_makes_the_run_incorrect(cell, fault, monkeypatch):
    import importlib

    modname, fn, how = FAULTS[(cell, fault)]
    mod = importlib.import_module(modname)
    monkeypatch.setattr(mod, fn, _alter_first(getattr(mod, fn), how))
    result, checks = run_cpu(cell)
    assert not result["correct"]
    assert dict((n, v) for n, v, _ in checks)["wrong_answers"] >= 1


def test_controls_fail_at_a_size_a_test_holds():
    """Each driver's control against its reference on inputs where the
    broken guarantee shows (the chip reads them at the cell's size)."""
    import torch

    from portbench import gen

    out = {}
    for cell in CELLS:
        wl, cfg = tiny(cell)
        if wl["config"] == "cov-genomes":
            cfg["ancestor_bp"] = 2_600
            cfg["genomes"] = [{"bp": bp, "identity": i} for bp, i in
                              ((1_300, 0.999), (2_600, 0.99), (2_450, 0.9))]
            cfg["isolate"] = {"snps": 6, "deletions": [3, 2, 1, 1], "insertions": [1, 2]}
        wl["params"]["check_inputs"] = 2
        ctx = harness.Context(cfg, wl["params"], 77, torch.device("cpu"))
        drv = harness.load_module("drivers", wl["driver"]).Driver(ctx)
        drv.setup()
        xs = drv.sample_inputs(gen.rng(77, 98), 2)
        want, got = drv.reference(xs), drv.reference(xs, control=True)
        out[cell] = sum(0 if drv.same(got[x], want[x]) else 1 for x in xs)
    assert all(v >= 1 for v in out.values()), out
