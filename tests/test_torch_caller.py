"""The port's variant caller on ``device="cpu"`` against the JAX package:
record expansion, the counting and quality-weighted pileups, calling,
``call_reads`` end to end (SNPs, a deletion, an insertion, weighted
gates) and the ``call`` CLI's VCF bytes against the JAX CLI run
in-process.

Tolerances: counts, calls and VCF bytes are equal. The float32 weight
sums are equal to the JAX package's host pileup (``np.add.at``, a
sequential sum): the port sums every bin in update order, on any device.
The JAX device scatter sums in its own order, so against it the weights
are held to rtol 1e-6 (float32, depth < 100), as the JAX package's own
test holds its two pileups.
"""

import numpy as np
import pytest
import torch

from genomics_rs_tpu.config import Scores as JaxScores
from genomics_rs_tpu.models import caller as jax_caller
from genomics_rs_tpu.sequence import Sequence as JaxSequence
from genomics_rs_tpu_torch.config import Scores
from genomics_rs_tpu_torch.models import caller
from genomics_rs_tpu_torch.sequence import Sequence
from tests.test_torch_reads import one_torch_thread, run_both_clis  # noqa: F401

SCORES = (1, -2, -1, -5)
FLIP = {"A": "G", "C": "T", "G": "A", "T": "C"}


def _q(vals):
    return "".join(chr(33 + v) for v in vals)


def _records(seed, n=60, ref_len=40):
    """Synthetic SAM-normalized records: M/I/D/N/S/H runs, N bases,
    random qualities and MAPQs, some unmapped."""
    rng = np.random.default_rng(seed)
    recs = []
    for k in range(n):
        pos = int(rng.integers(1, 10))
        ops = [("S", 2), ("M", int(rng.integers(3, 8))), ("I", 2), ("M", 4), ("D", 2),
               ("M", 5), ("N", 1), ("M", 3), ("H", 3)]
        if k % 5 == 0:
            ops = ops[1:3] + ops[3:]  # a leading-edge-free insert
        if k % 7 == 0:
            ops = [("I", 2)] + ops[1:]  # a leading-edge insert (dropped)
        qlen = sum(n for op, n in ops if op in "MIS")
        seq = "".join(rng.choice(list("ACGTN" if k % 9 == 0 else "ACGT"), qlen))
        recs.append(dict(
            mapped=k % 11 != 3, pos=pos, cigar="".join(f"{n}{op}" for op, n in ops), seq=seq,
            qual=_q(rng.integers(2, 41, qlen)) if k % 4 else "*",
            mapq=int(rng.choice([0, 3, 20, 60, 255])), rname="c"))
    return recs


@pytest.mark.parametrize("gates", [(0, 0, False), (0, 0, True), (13, 10, True)])
def test_expand_records_matches_jax(gates):
    min_baseq, min_mapq, weights = gates
    recs = _records(1)
    got = caller._expand_records(recs, min_baseq, min_mapq, weights)
    want = jax_caller._expand_records(recs, min_baseq, min_mapq, weights)
    for g, w in zip(got[:3], want[:3]):
        assert (g is None and w is None) or np.array_equal(g, w)
    assert got[3] == want[3] and got[4] == want[4]


def test_pileups_match_jax():
    recs = _records(2)
    counts, ins = caller.pileup_full(recs, 40, device="cpu")
    for dev in (False, True):
        want = jax_caller.pileup_full(recs, 40, device=dev)
        assert np.array_equal(counts, want[0]) and ins == want[1]
    assert np.array_equal(caller.pileup(recs, 40, device="cpu"), counts)
    got = caller.pileup_q(recs, 40, device="cpu", min_baseq=5, min_mapq=2)
    host = jax_caller.pileup_q(recs, 40, device=False, min_baseq=5, min_mapq=2)
    dev = jax_caller.pileup_q(recs, 40, device=True, min_baseq=5, min_mapq=2)
    assert np.array_equal(got[0], host[0]) and got[2:] == host[2:]
    assert got[1].dtype == np.float32 and np.array_equal(got[1], host[1])
    np.testing.assert_allclose(got[1], dev[1], rtol=1e-6)
    with pytest.raises(AssertionError, match="outside the reference"):
        caller.pileup_full(recs, 12, device="cpu")


def test_ordered_sums_are_sequential_float32_sums():
    """Each bin's sum equals ``np.add.at``'s in-order float32 sum, bit
    for bit, with deep bins and empty ones."""
    rng = np.random.default_rng(4)
    bins = rng.integers(0, 50, 5000) ** 2 % 997
    w = (rng.random(5000) * 1e3 ** rng.integers(-1, 2, 5000)).astype(np.float32)
    want = np.zeros(997, np.float32)
    np.add.at(want, bins, w)
    got = caller._ordered_sums(torch.from_numpy(bins), torch.from_numpy(w), 997).numpy()
    assert np.array_equal(got, want)
    assert caller._ordered_sums(torch.zeros(0, dtype=torch.int64),
                                torch.zeros(0), 4).tolist() == [0.0] * 4


def test_call_pileup_and_insertions_match_jax():
    rng = np.random.default_rng(6)
    ref = "".join(rng.choice(list("ACGT"), 60))
    counts = rng.integers(0, 12, (60, 5)).astype(np.int32)
    counts[10:13, 4] = 30  # a 3-base deletion run
    weights = (counts * rng.random((60, 5))).astype(np.float32)
    ins = {5: {"GG": 9, "T": 2}, 20: {"A": 1}, 33: {"CC": 20}}
    ins_w = {5: {"GG": 8.5}, 33: {"CC": 2.0}}
    for kw in (dict(), dict(weights=weights), dict(weights=weights, min_alt_conf=0.6)):
        for depth, frac in ((8, 0.7), (5, 0.3)):
            got = caller.call_pileup(counts, ref, "c", depth, frac, **kw)
            want = jax_caller.call_pileup(counts, ref, "c", depth, frac, **kw)
            assert [vars(c) for c in got] == [vars(c) for c in want]
    for kw in (dict(), dict(ins_w=ins_w, weights=weights)):
        got = caller.call_insertions(ins, counts, ref, "c", 5, 0.3, **kw)
        want = jax_caller.call_insertions(ins, counts, ref, "c", 5, 0.3, **kw)
        assert [vars(c) for c in got] == [vars(c) for c in want] and got
    with pytest.raises(ValueError, match="together"):
        caller.call_insertions(ins, counts, ref, "c", ins_w=ins_w)


def _tiled(seed, n=700, read_len=80, step=7, quality=False):
    """A random reference and reads tiling it with two SNPs, a 2-base
    deletion and a 3-base insertion planted in every covering read."""
    rng = np.random.default_rng(seed)
    ref = "".join(rng.choice(list("ACGT"), n))
    muts = {150: FLIP[ref[150]], 400: FLIP[ref[400]], 300: "", 301: "", 550: ref[550] + "TTG"}
    reads = []
    for k, start in enumerate(range(0, n - read_len + 1, step)):
        s = "".join(muts.get(p, ref[p]) for p in range(start, start + read_len))
        q = "".join(chr(33 + int(x)) for x in rng.integers(20, 41, len(s))) if quality else None
        reads.append((f"r{k}", s, q))
    return ref, reads


@pytest.mark.parametrize(
    "kw",
    [dict(), dict(weighted=True), dict(min_baseq=25, min_mapq=5, min_alt_conf=0.5),
     dict(band=48, both_strands=False)],
    ids=["counts", "weighted", "gated", "wide-window"],
)
def test_call_reads_matches_jax(kw):
    ref, reads = _tiled(3, quality=True)
    args = dict(min_depth=5, min_frac=0.6, k=15, **kw)
    got, gp = caller.call_reads([Sequence(n, s, q) for n, s, q in reads],
                                [Sequence("chr1 test", ref)], Scores(*SCORES),
                                device="cpu", **args)
    want, wp = jax_caller.call_reads([JaxSequence(n, s, q) for n, s, q in reads],
                                     [JaxSequence("chr1 test", ref)], JaxScores(*SCORES),
                                     engine="scan", **args)
    assert [vars(c) for c in got] == [vars(c) for c in want]
    assert gp.keys() == wp.keys() and all(np.array_equal(gp[k], wp[k]) for k in gp)
    assert {(c.pos, c.alt) for c in got} >= {(151, FLIP[ref[150]]), (401, FLIP[ref[400]])}


def test_write_vcf_matches_jax(tmp_path):
    refs = [("chr", "AACGTTGCA"), ("other x", "ACGT")]
    calls = [("chr", 3, "C", "T", 12, 11), ("chr", 5, "T", "", 9, 8), ("chr", 1, "AA", "", 9, 9),
             ("chr", 7, "G", "GAT", 10, 8), ("other", 1, "ACGT", "", 5, 5)]
    out = {}
    for name, mod, Seq in (("port", caller, Sequence), ("jax", jax_caller, JaxSequence)):
        path = tmp_path / f"{name}.vcf"
        mod.write_vcf(str(path), [mod.VariantCall(*c) for c in calls],
                      [Seq(n, s) for n, s in refs])
        out[name] = path.read_bytes()
    assert out["port"] == out["jax"]


@pytest.mark.parametrize(
    "extra", [[], ["--weighted", "--min-baseq", "25"], ["--single-strand", "--band", "48"]])
def test_cli_call_matches_jax(tmp_path, capsys, monkeypatch, extra):
    ref, reads = _tiled(5, quality=True)
    r = tmp_path / "ref.fasta"
    r.write_text(f">chr1 test\n{ref}\n")
    q = tmp_path / "reads.fastq"
    q.write_text("".join(f"@{n}\n{s}\n+\n{ql}\n" for n, s, ql in reads))
    cfg = tmp_path / "config.toml"
    cfg.write_text("[scores]\ns_match = 1\ns_mismatch = -2\ng = -1\nh = -5\n")
    argv = ["-c", str(cfg), "call", "-q", str(q), "-r", str(r), "-k", "15",
            "--min-depth", "5"] + extra
    runs = run_both_clis(tmp_path, capsys, monkeypatch, argv, "calls.vcf")
    assert runs["port"] == runs["jax"]
    body = [ln for ln in runs["port"][1].decode().splitlines() if not ln.startswith("#")]
    assert len(body) >= 3


def test_cli_call_scan_exits_2(tmp_path, capsys, monkeypatch):
    """``call --engine scan`` prints and writes the JAX CLI's bytes."""
    ref, reads = _tiled(5, quality=True)
    r = tmp_path / "ref.fasta"
    r.write_text(f">chr1 test\n{ref}\n")
    q = tmp_path / "reads.fastq"
    q.write_text("".join(f"@{n}\n{s}\n+\n{ql}\n" for n, s, ql in reads[:60]))
    cfg = tmp_path / "config.toml"
    cfg.write_text("[scores]\ns_match = 1\ns_mismatch = -2\ng = -1\nh = -5\n")
    argv = ["-c", str(cfg), "call", "-q", str(q), "-r", str(r), "-k", "15", "--min-depth", "3",
            "--engine", "scan"]
    runs = run_both_clis(tmp_path, capsys, monkeypatch, argv, "calls.vcf")
    assert runs["port"] == runs["jax"]
    assert runs["port"][1].startswith(b"##fileformat=VCF")
