"""The harness on the CPU (the program's plain versions, tiny sizes):
discovery by name, BENCHMARK.json against the contract's shape, the
import guard, the check failing under planted faults, and the controls
failing at a size a test run holds.

Every test here finds a cell's files by name, so a new configuration and
its cell come as new files, and no file that exists is edited:

- ``configs/<config>.json``: the configuration as it is run;
- ``workloads/<cell>.json``: the cell's configuration, traffic, driver,
  chips, ``why`` and params;
- ``drivers/<driver>.py``, where the request kind is new: a ``Driver``;
- ``metrics/<metric>.py``, for each new metric: its ``read``;
- ``testsizes/<config>.json``: ``config``, the configuration's keys as
  the CPU tests run them; ``params``, the cells' params at that size
  (applied where a cell has the key); ``control``, the configuration's
  keys at the size where the control's broken guarantee shows;
- ``faults/<cell>.py``: ``FAULTS = {name: (module, function, how)}``, at
  least one fault planted in the cell's timed path;
- ``BENCHMARK.json`` gains entries only: the configuration, the cell, each
  new metric, and the cell's name in the ``workloads`` of each metric it
  reports.

``test_a_new_config_cell_driver_and_metric_are_found_without_edits``
does exactly that in a copy and holds every file that was there before
unchanged."""

import ast
import hashlib
import importlib
import json
import re
import shutil
import sys
import time
import uuid
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
BANNED = {"jax", "jaxlib", "flax", "genomics_rs_tpu"}
#: the yardstick: none of it may import the program either.
YARDSTICK = ("reference.py", "gen.py", "cells.py", "bound.py", "devtrace.py")


def bench():
    return harness.load_json(harness.REPO / "BENCHMARK.json")


def sizes_of(config: str) -> dict:
    """``testsizes/<config>.json``; a configuration without one fails
    here, naming the file."""
    path = harness.ROOT / "testsizes" / f"{config}.json"
    if not path.is_file():
        raise FileNotFoundError(f"configuration {config!r} has no test sizes: add "
                                f"portbench/testsizes/{config}.json ({path})")
    return harness.load_json(path)


def tiny(cell: str):
    """(workload, config) of ``cell`` cut to its configuration's test
    sizes, every answer of the window kept."""
    wl = harness.load_json(harness.ROOT / "workloads" / f"{cell}.json")
    cfg = harness.load_json(harness.ROOT / "configs" / f"{wl['config']}.json")
    sizes = sizes_of(wl["config"])
    cfg.update(sizes["config"])
    p = wl["params"]
    p.update({k: v for k, v in sizes["params"].items() if k in p})
    p["keep_share"] = 1.0
    return wl, cfg


def run_cpu(cell, seed=2**31 + 12345, trace=False, **kw):
    wl, cfg = tiny(cell)
    return harness.run(cell, seed, 0.3, trace, t_proc=time.perf_counter(), device="cpu",
                       workload=wl, config=cfg, allow_plain=True, log=lambda s: None, **kw)


def faults(cell: str) -> dict:
    """``FAULTS`` of ``faults/<cell>.py``."""
    return harness.load_module("faults", cell).FAULTS


CELLS = [w["name"] for w in bench()["workloads"]]
FAULT_CASES = sorted((p.stem, name) for p in ROOT.glob("faults/[!_]*.py")
                     for name in faults(p.stem))


def check_contract(b: dict):
    """``b`` and the files it names against the contract's shape."""
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["portbench"] and b["command"][1] == "portbench/run.py"
    assert 1 <= b["run_seconds"] <= 51
    cells = [w["name"] for w in b["workloads"]]
    e2e = {m["name"] for m in b["end_to_end"]}
    assert {"setup_s", "gcups", "p95_ms"} <= e2e
    names = [c["name"] for c in b["configs"]] + cells + [
        m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        cfg = json.loads((harness.REPO / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        f = harness.load_json(harness.ROOT / "workloads" / f"{w['name']}.json")
        assert {k: f[k] for k in ("config", "traffic", "chips", "why")} == {
            k: w[k] for k in ("config", "traffic", "chips", "why")}
        assert (harness.ROOT / "drivers" / f"{f['driver']}.py").is_file() and len(w["why"]) <= 200
        reported = {m["name"] for m in harness.cell_metrics(b, w["name"], "end_to_end")}
        assert "setup_s" in reported and len(reported) >= 2
        assert harness.cell_metrics(b, w["name"], "per_layer")
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"] and len(m["layer"]) <= 200
        for cell in m.get("workloads", cells):
            assert m["moves"] in {x["name"] for x in harness.cell_metrics(b, cell, "end_to_end")}
    for m in b["end_to_end"] + b["per_layer"]:
        assert callable(harness.load_module("metrics", m["name"]).read)


def check_plain_run(cell: str, trace: bool):
    """One run of ``cell`` on the plain versions: correct, with the
    cell's metrics and the checks last."""
    result, checks = run_cpu(cell, trace=trace)
    assert result["correct"], checks
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in harness.cell_metrics(bench(), cell, kind)}
    assert set(result["metrics"]) <= want
    if not trace:
        assert set(result["metrics"]) == want
    assert list(result)[-1] == "checks"
    return result


def _alter_first(fn, how):
    def wrapped(*a, **k):
        return how(fn(*a, **k))
    return wrapped


def check_fault(cell: str, fault: str):
    """A run of ``cell`` with ``fault`` planted comes out not correct,
    by a wrong answer."""
    modname, fn, how = faults(cell)[fault]
    mod = importlib.import_module(modname)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mod, fn, _alter_first(getattr(mod, fn), how))
        result, checks = run_cpu(cell)
    assert not result["correct"]
    assert dict((n, v) for n, v, _ in checks)["wrong_answers"] >= 1


def control_misses(cell: str) -> int:
    """Inputs of ``cell`` on which its control, at its configuration's
    control size, differs from the reference."""
    import torch

    from portbench import gen

    wl, cfg = tiny(cell)
    cfg.update(sizes_of(wl["config"])["control"])
    wl["params"]["check_inputs"] = 2
    ctx = harness.Context(cfg, wl["params"], 77, torch.device("cpu"))
    drv = harness.load_module("drivers", wl["driver"]).Driver(ctx)
    drv.setup()
    xs = drv.sample_inputs(gen.rng(77, 98), 2)
    want, got = drv.reference(xs), drv.reference(xs, control=True)
    return sum(0 if drv.same(got[x], want[x]) else 1 for x in xs)


def test_benchmark_json_has_the_contracts_shape():
    check_contract(bench())


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
    check_plain_run(cell, trace)


def _digests(root: Path) -> dict[str, str]:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def add_config_by_files(tmp_path: Path, monkeypatch, with_sizes: bool = True):
    """A copy of the benchmark (``BENCHMARK.json`` and ``portbench/``) to
    which a configuration under a fresh name, its test sizes, a cell, its
    faults, a driver subclass and a metric come as new files and new
    entries only; the harness pointed at the copy. Returns the cell's
    name, the copy's benchmark folder and its files' digests from before."""
    root = tmp_path / "portbench"
    shutil.copytree(ROOT, root, ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    shutil.copy(ROOT.parent / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digests(root)
    config = f"dna-{uuid.uuid4().hex[:12]}"
    cell = f"{config}.allpairs"
    assert not any(config.encode() in p.read_bytes() for p in tmp_path.rglob("*") if p.is_file())

    cfg = harness.load_json(root / "configs" / "cov-genomes.json")
    cfg.update(name=config)
    new = {
        f"configs/{config}.json": json.dumps(cfg),
        f"testsizes/{config}.json": json.dumps({
            "config": {"ancestor_bp": 200, "genomes": [{"bp": 180 + 5 * k, "identity": 0.9}
                                                       for k in range(3)]},
            "params": {"corpora": 2},
            "control": {"ancestor_bp": 1_200, "genomes": [{"bp": 150, "identity": 0.999},
                                                          {"bp": 1_200, "identity": 0.99}]}}),
        f"workloads/{cell}.json": json.dumps({
            "config": config, "traffic": "corpus4", "driver": "allpairs_subclass", "chips": 1,
            "why": "a test cell", "params": {"corpora": 4, "check_inputs": 1,
                                             "control_band": 1024}}),
        f"faults/{cell}.py": (
            "from portbench.faults import plus_one\n\n"
            "FAULTS = {\"answer\": (\"genomics_rs_tpu_torch.parallel.allpairs\", "
            "\"_score_pairs_bucketed\", lambda r: (plus_one(r[0][None])[0], r[1]))}\n"),
        "drivers/allpairs_subclass.py": ("from portbench.drivers import allpairs\n\n\n"
                                         "class Driver(allpairs.Driver):\n    pass\n"),
        "metrics/requests_seen.py": "def read(c):\n    return float(c.requests)\n",
    }
    for name, text in new.items():
        if with_sizes or not name.startswith("testsizes/"):
            assert not (root / name).exists()
            (root / name).write_text(text)

    b = bench()
    b["configs"].append({"name": config, "source": "https://example.org",
                         "file": f"portbench/configs/{config}.json", "reduced": [], "why": "test"})
    b["workloads"].append({"name": cell, "config": config, "traffic": "corpus4", "chips": 1,
                           "why": "a test cell"})
    for m in b["end_to_end"] + b["per_layer"]:
        if m["name"] in ("gcups", "launches_per_req"):
            m["workloads"].append(cell)
    b["end_to_end"].append({"name": "requests_seen", "unit": "requests", "better": "higher",
                            "bound": 0.05, "source": "host_clock", "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    monkeypatch.setattr(harness, "ROOT", root)
    monkeypatch.setattr(harness, "REPO", tmp_path)
    return cell, root, before


def test_a_new_config_cell_driver_and_metric_are_found_without_edits(tmp_path, monkeypatch):
    cell, root, before = add_config_by_files(tmp_path, monkeypatch)
    check_contract(bench())
    result = check_plain_run(cell, False)
    assert result["metrics"]["requests_seen"]["value"] >= 1
    assert {"gcups", "p95_ms", "setup_s"} <= set(result["metrics"])
    check_plain_run(cell, True)
    assert control_misses(cell) >= 1
    assert faults(cell)
    for fault in faults(cell):
        check_fault(cell, fault)
    after = _digests(root)
    assert {k: after.get(k) for k in before} == before


def test_a_config_without_test_sizes_fails_at_once_naming_the_file(tmp_path, monkeypatch):
    cell, _, _ = add_config_by_files(tmp_path, monkeypatch, with_sizes=False)
    missing = re.escape(f"portbench/testsizes/{bench()['workloads'][-1]['config']}.json")
    for check in (lambda: tiny(cell), lambda: check_plain_run(cell, False),
                  lambda: control_misses(cell), lambda: check_fault(cell, "answer")):
        with pytest.raises(FileNotFoundError, match=missing):
            check()


def test_every_cell_has_a_planted_fault():
    for cell in CELLS:
        assert faults(cell), f"faults/{cell}.py plants no fault"


@pytest.mark.parametrize("cell,fault", FAULT_CASES)
def test_a_planted_fault_makes_the_run_incorrect(cell, fault):
    check_fault(cell, fault)


def test_controls_fail_at_a_size_a_test_holds():
    """Each driver's control against its reference on inputs where the
    broken guarantee shows (the chip reads them at the cell's size)."""
    out = {cell: control_misses(cell) for cell in CELLS}
    assert all(v >= 1 for v in out.values()), out
