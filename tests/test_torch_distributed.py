"""The multi-device and multi-process paths against the JAX package, on
the CPU: the deals (``balanced_deal``, ``hybrid_deal``, ``split_cost``),
``allpairs_hybrid`` (a split pair through the sequence-parallel
pipeline), ``allpairs_scores_resumable`` (resuming a half-written
checkpoint, the JAX package's own included), ``batch_scores_sharded``,
``device_loop_scores``, the ``mesh=`` path of ``allpairs_scores``,
``align_reads``' device split, ``init_distributed`` and a two-rank gloo
``allpairs_multihost``. Exact equality throughout.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from genomics_rs_tpu.config import Scores as JaxScores
from genomics_rs_tpu.models.reads import align_reads as jax_align_reads
from genomics_rs_tpu.parallel import allpairs as jax_ap
from genomics_rs_tpu.parallel import batch as jax_batch
from genomics_rs_tpu.parallel import distributed as jax_dist
from genomics_rs_tpu.parallel.mesh import make_mesh as jax_make_mesh
from genomics_rs_tpu.sequence import Sequence as JaxSequence
from genomics_rs_tpu.sequence import SequenceContainer as JaxContainer
from genomics_rs_tpu_torch.config import Scores
from genomics_rs_tpu_torch.models import reads as port_reads
from genomics_rs_tpu_torch.ops import gotoh_pallas as gp
from genomics_rs_tpu_torch.parallel import allpairs as ap
from genomics_rs_tpu_torch.parallel import batch
from genomics_rs_tpu_torch.parallel import distributed as dist_mod
from genomics_rs_tpu_torch.parallel.mesh import make_mesh
from genomics_rs_tpu_torch.sequence import Sequence, SequenceContainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCORES = (1, -2, -1, -5)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The plain fills run thousands of small torch ops; torch's thread
    pool only contends with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seqs(seed, lengths):
    rng = np.random.default_rng(seed)
    return [(f"s{k}", "".join(rng.choice(list("ACGT"), L))) for k, L in enumerate(lengths)]


def _both(seqs):
    return (SequenceContainer([Sequence(n, s) for n, s in seqs]),
            JaxContainer([JaxSequence(n, s) for n, s in seqs]))


def _units(shares):
    return [[(u.index, u.nparts, u.group) for u in s] for s in shares]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_deals_match_jax(seed):
    rng = np.random.default_rng(seed)
    costs = list(rng.integers(1, 1000, 40).astype(float)) + [float(rng.integers(5000, 20000))]
    for n_shares in (1, 3, 8):
        assert dist_mod.balanced_deal(costs, n_shares) == jax_dist.balanced_deal(costs, n_shares)
        assert _units(dist_mod.hybrid_deal(costs, n_shares)) == _units(
            jax_dist.hybrid_deal(costs, n_shares))
        for parts in (1, 2, 5):
            assert dist_mod.split_cost(costs[0], parts) == jax_dist.split_cost(costs[0], parts)


@pytest.mark.parametrize("is_local", [False, True])
def test_allpairs_hybrid_matches_jax(is_local):
    """Five 30 bp sequences and one of 200 bp at three shares: the (big,
    big) pair costs more than a share and is split over a sub-mesh."""
    port, jax_c = _both(_seqs(41, [30] * 5 + [200]))
    want = jax_dist.allpairs_hybrid(jax_c, JaxScores(*SCORES), n_shares=3, is_local=is_local,
                                    engine="scan", interpret=True)
    before = gp.TILE_COUNTS["plain"]
    got = dist_mod.allpairs_hybrid(port, Scores(*SCORES), n_shares=3, is_local=is_local,
                                   devices=[CPU] * 3)
    assert gp.TILE_COUNTS["plain"] > before  # the split pair ran the pipeline
    np.testing.assert_array_equal(got.matrix, want.matrix)
    assert (got.names, got.lengths, got.cells) == (want.names, want.lengths, want.cells)


def test_allpairs_resumable_matches_jax_and_resumes(tmp_path, monkeypatch):
    seqs = _seqs(7, [40, 90, 130, 60, 200, 75])  # 21 pairs, chunks of 4
    port, jax_c = _both(seqs)
    sc, jsc = Scores(*SCORES), JaxScores(*SCORES)
    want = jax_ap.allpairs_scores_resumable(jax_c, jsc, str(tmp_path / "jax.jsonl"),
                                            chunk_pairs=4)
    path = tmp_path / "port.jsonl"
    got = ap.allpairs_scores_resumable(port, sc, str(path), chunk_pairs=4, device="cpu")
    np.testing.assert_array_equal(got.matrix, want.matrix)
    np.testing.assert_array_equal(got.matrix, ap.allpairs_scores(port, sc, device="cpu").matrix)
    jax_lines = (tmp_path / "jax.jsonl").read_text().splitlines()
    assert path.read_text().splitlines() == jax_lines  # the same file, byte for byte

    # Resume from half of the JAX package's checkpoint plus a torn line:
    # only the missing chunks are scored, and the file ends as JAX's.
    calls = []
    real = ap._score_pairs_bucketed
    monkeypatch.setattr(ap, "_score_pairs_bucketed",
                        lambda c, chunk, *a, **k: calls.append(len(chunk)) or real(c, chunk, *a,
                                                                                   **k))
    path.write_text("\n".join(jax_lines[:4]) + "\n" + jax_lines[4][:9])
    again = ap.allpairs_scores_resumable(port, sc, str(path), chunk_pairs=4, device="cpu")
    np.testing.assert_array_equal(again.matrix, want.matrix)
    assert calls == [4, 4, 1]  # chunks k0 = 12, 16, 20 of 21 pairs
    assert path.read_text().splitlines() == jax_lines

    # A checkpoint of other inputs starts fresh.
    path.write_text(json.dumps({"meta": {"other": 1}}) + "\n")
    calls.clear()
    ap.allpairs_scores_resumable(port, sc, str(path), chunk_pairs=4, device="cpu")
    assert sum(calls) == 21


@pytest.mark.parametrize("is_local", [False, True])
def test_batch_scores_sharded_matches_jax(is_local):
    rng = np.random.default_rng(9)
    B, L1, L2 = 8, 256, 192
    ms = rng.integers(1, L1 + 1, B).astype(np.int32)
    ns = rng.integers(1, L2 + 1, B).astype(np.int32)
    ms[3], ns[5] = 0, 0  # empty sequences: a padded shard's pairs
    s1b = rng.choice(np.frombuffer(b"ACGT", np.uint8), (B, L1))
    s2b = rng.choice(np.frombuffer(b"ACGT", np.uint8), (B, L2))
    want = jax_batch.batch_scores_sharded(jax_make_mesh(4), s1b, s2b, ms, ns,
                                          JaxScores(*SCORES), is_local, engine="scan")
    got = batch.batch_scores_sharded(make_mesh(4, devices=[CPU] * 4), s1b, s2b, ms, ns,
                                     Scores(*SCORES), is_local)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert got.max_score == int(want.max_score)
    assert got.total_cells == np.float32(want.total_cells)
    with pytest.raises(ValueError, match="pad_batch"):
        batch.batch_scores_sharded(make_mesh(3, devices=[CPU] * 3), s1b, s2b, ms, ns,
                                   Scores(*SCORES), is_local)


def test_mesh_bucket_engine_matches_jax():
    for engine in ("auto", "scan", "shortread", "segmented", "stream", "pallas"):
        for L1, L2 in ((128, 256), (256, 384), (1024, 512), (8192, 8192), (8320, 128)):
            for is_local in (False, True):
                assert batch.mesh_bucket_engine(engine, L1, L2, is_local) == (
                    jax_batch.mesh_bucket_engine(engine, L1, L2, is_local))


@pytest.mark.parametrize("is_local", [False, True])
def test_device_loop_scores_matches_scan(is_local):
    """Equal K3 slices (its plain version) over three devices, the batch
    padded by replicating pair 0; equal to JAX's scan oracle."""
    rng = np.random.default_rng(11)
    B, L1, L2 = 7, 384, 256
    ms = rng.integers(200, L1 + 1, B).astype(np.int32)
    ns = rng.integers(100, L2 + 1, B).astype(np.int32)
    s1b = rng.choice(np.frombuffer(b"ACGT", np.uint8), (B, L1))
    s2b = rng.choice(np.frombuffer(b"ACGT", np.uint8), (B, L2))
    want = jax_batch.batch_scores(s1b, s2b, ms, ns, JaxScores(*SCORES), is_local)
    got = batch.device_loop_scores([CPU] * 3, s1b, s2b, ms, ns, Scores(*SCORES), is_local)
    for g, w in zip(got, (want.score, want.start_i, want.start_j)):
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("is_local", [False, True])
def test_allpairs_mesh_path_matches_jax(is_local, monkeypatch):
    """``allpairs_scores(mesh=)``: short buckets through
    ``batch_scores_sharded`` (padded to the mesh), long-pair buckets
    through ``device_loop_scores`` (the segmented tier's bound is lowered
    so that 300 bp is long here)."""
    port, jax_c = _both(_seqs(3, [100, 250, 300, 120]))
    want = jax_ap.allpairs_scores(jax_c, JaxScores(*SCORES), is_local=is_local, engine="scan")
    calls = []
    real = batch.device_loop_scores
    monkeypatch.setattr(batch, "SEGMENTED_MAX_LEN", 256)
    monkeypatch.setattr(ap, "device_loop_scores",
                        lambda *a, **k: calls.append(k["engine"]) or real(*a, **k))
    got = ap.allpairs_scores(port, Scores(*SCORES), is_local=is_local,
                             mesh=make_mesh(3, devices=[CPU] * 3))
    np.testing.assert_array_equal(got.matrix, want.matrix)
    assert calls and set(calls) == {"stream"}


def test_align_reads_device_split_matches_jax(monkeypatch):
    """A round of 7 reads over three devices: slices of three (read 0
    replicated into the padding), the same alignments as JAX's."""
    rng = np.random.default_rng(2)
    ref = "".join(rng.choice(list("ACGT"), 160))
    reads = ["".join(rng.choice(list("ACGT"), 60)) if k % 3 == 0 else ref[k * 9 : k * 9 + 70]
             for k in range(7)]
    calls = []
    real = port_reads._launch_part
    monkeypatch.setattr(port_reads, "_launch_part",
                        lambda s1b, *a: calls.append(len(s1b)) or real(s1b, *a))
    got = port_reads.align_reads([Sequence(f"r{k}", r) for k, r in enumerate(reads)],
                                 [Sequence("ref", ref)], Scores(*SCORES), device=[CPU] * 3)
    assert calls == [3, 3, 3]
    want = jax_align_reads([JaxSequence(f"r{k}", r) for k, r in enumerate(reads)],
                           [JaxSequence("ref", ref)], JaxScores(*SCORES), engine="scan")
    assert [(r.score, [(c.value, i, j) for c, i, j in r.alignment]) for r in got] == [
        (r.score, [(c.value, i, j) for c, i, j in r.alignment]) for r in want]


def test_init_distributed_environment(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert dist_mod.init_distributed() == (0, 1)  # alone: a no-op
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "not-a-port")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="2-rank gloo group"):
        dist_mod.init_distributed()
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert dist_mod.init_distributed() == (0, 1)  # one rank: warns only
    assert not torch.distributed.is_initialized()


WORKER = r"""
import os, sys
sys.path.insert(0, %ROOT%)
import numpy as np
from genomics_rs_tpu_torch.config import Scores
from genomics_rs_tpu_torch.parallel.distributed import allpairs_multihost, init_distributed
from genomics_rs_tpu_torch.sequence import Sequence, SequenceContainer

rank = int(os.environ["RANK"])
assert init_distributed(init_method="file://%OUT%/rendezvous") == (rank, 2)
rng = np.random.default_rng(1)
c = SequenceContainer([Sequence(f"s{k}", "".join(rng.choice(list("ACGT"), 60)))
                       for k in range(5)])
r = allpairs_multihost(c, Scores(1, -2, -1, -5), device="cpu")
np.save(f"%OUT%/matrix_{rank}.npy", r.matrix)
import torch.distributed
torch.distributed.destroy_process_group()
"""


def test_two_rank_allpairs_multihost(tmp_path):
    """Two gloo ranks, each scoring its dealt share; the gathered matrix
    equals the single-process one (and the JAX scan's)."""
    script = tmp_path / "worker.py"
    script.write_text(WORKER.replace("%ROOT%", repr(REPO)).replace("%OUT%", str(tmp_path)))
    env = {k: v for k, v in os.environ.items() if k not in ("MASTER_ADDR", "MASTER_PORT")}
    env.update(WORLD_SIZE="2", GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(script)], env=dict(env, RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=240)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, lg in zip(procs, logs):
        assert p.returncode == 0, lg[-2000:]
    rng = np.random.default_rng(1)
    seqs = [(f"s{k}", "".join(rng.choice(list("ACGT"), 60))) for k in range(5)]
    port, jax_c = _both(seqs)
    m0, m1 = np.load(tmp_path / "matrix_0.npy"), np.load(tmp_path / "matrix_1.npy")
    np.testing.assert_array_equal(m0, m1)
    np.testing.assert_array_equal(m0, ap.allpairs_scores(port, Scores(*SCORES),
                                                         device="cpu").matrix)
    np.testing.assert_array_equal(
        m0, jax_ap.allpairs_scores(jax_c, JaxScores(*SCORES), engine="scan").matrix)
