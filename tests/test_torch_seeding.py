"""Device seeding (``models/mapper``: ``KmerIndex.device_arrays``,
``_device_vote``, ``_vote_windows_device``) against the JAX package's
device vote and the port's host vote on the CPU: the vote arrays on
reads with repeats (tied bins), non-ACGT bytes and a padded last chunk,
the k > 15 and length errors, ``map_reads``/``call_reads`` with
``seed_engine="device"``, and the ``map --seed-engine device -k 15`` CLI
against the JAX CLI. Equality throughout.
"""

import numpy as np
import pytest
import torch

from genomics_rs_tpu.config import Scores as JaxScores
from genomics_rs_tpu.models import mapper as jax_mapper
from genomics_rs_tpu.sequence import Sequence as JaxSequence
from genomics_rs_tpu_torch.config import Scores
from genomics_rs_tpu_torch.models import caller, mapper
from genomics_rs_tpu_torch.models.reads import encode_batch
from genomics_rs_tpu_torch.sequence import Sequence
from tests.test_torch_mapper import _genome, _write_map_inputs
from tests.test_torch_reads import one_torch_thread, run_both_clis  # noqa: F401

SCORES = (1, -2, -1, -5)


def _repeat_genome(seed: int, n: int = 3000) -> str:
    """A genome with an exact 500 bp repeat and a short tandem run, so
    reads from them tie between bins."""
    rng = np.random.default_rng(seed)
    g = "".join(rng.choice(list("ACGT"), n))
    return g[:1000] + g[200:700] + g[1000:1500] + "ACGTT" * 30 + g[1500:]


def _reads_of(genome: str, seed: int, n: int = 70) -> list[str]:
    rng = np.random.default_rng(seed)
    out = []
    for t in range(n):
        p = int(rng.integers(0, len(genome) - 90))
        r = genome[p : p + int(rng.integers(40, 80))]
        if t % 4 == 0:
            r = r[::-1]
        if t % 9 == 0:
            r = r[:20] + "N" + r[21:]
        if t % 11 == 0:
            r = r.lower()
        out.append(r)
    return out + ["ACGT" * 3, "NNNNNNNNNNNNNNNNNNNN", "A"]


def _enc4(reads: list[str]) -> np.ndarray:
    L = max(len(r) for r in reads)
    return mapper._BASE[encode_batch([Sequence("r", r) for r in reads], L, 0xFE)]


@pytest.mark.parametrize("k,stride,max_hits,band", [(11, 5, 8, 8), (15, 7, 64, 32),
                                                   (13, 1, 3, 16), (6, 3, 64, 4)])
def test_vote_windows_device_matches_jax_and_host(k, stride, max_hits, band):
    """Votes, windows, anchors and runner-up votes: the device vote equals
    JAX's device vote and the port's host vote, also in chunks of 16 rows
    (a padded last chunk)."""
    g = _repeat_genome(k)
    enc4 = _enc4(_reads_of(g, k))
    pix = mapper.KmerIndex(Sequence("g", g), k)
    jix = jax_mapper.KmerIndex(JaxSequence("g", g), k)
    host = mapper._vote_windows(pix, enc4, stride, max_hits, band)
    want = jax_mapper._vote_windows_device(jix, enc4, stride, max_hits, band, chunk=16)
    for chunk in (16, 16384):
        got = mapper._vote_windows_device(pix, enc4, stride, max_hits, band, chunk=chunk,
                                          device="cpu")
        for g_, w, h in zip(got, want, host):
            assert np.array_equal(g_, np.asarray(w)) and np.array_equal(g_, h)
    assert (host[0] > 0).sum() > 40 and (host[3] == -1).any()


def test_device_vote_ties_take_the_smallest_bin():
    """A read whose seeds hit two far-apart copies equally: the winner is
    the smaller bin, as the host's lexsort takes it, and the runner-up
    carries the same vote (MAPQ margin 0)."""
    rng = np.random.default_rng(5)
    unit = "".join(rng.choice(list("ACGT"), 120))
    g = "".join(rng.choice(list("ACGT"), 400)) + unit + "".join(
        rng.choice(list("ACGT"), 700)) + unit + "".join(rng.choice(list("ACGT"), 300))
    ix = mapper.KmerIndex(Sequence("g", g), 11)
    enc4 = _enc4([unit[10:100], unit[::-1][:60]])
    host = mapper._vote_windows(ix, enc4, 5, 64, 16)
    got = mapper._vote_windows_device(ix, enc4, 5, 64, 16, device="cpu")
    for a, b in zip(got, host):
        assert np.array_equal(a, b)
    assert got[0][0] == got[4][0] > 0  # tied with the other copy
    assert got[1][0] == (400 + 10) // 16 * 16  # the first copy's bin


def test_device_arrays_errors_match_jax():
    g = _repeat_genome(3)
    for k in (16, 21):
        with pytest.raises(ValueError) as want:
            jax_mapper.KmerIndex(JaxSequence("g", g), k).device_arrays()
        with pytest.raises(ValueError) as got:
            mapper.KmerIndex(Sequence("g", g), k).device_arrays("cpu")
        assert str(got.value) == str(want.value)
    ix, jix = mapper.KmerIndex(Sequence("g", g), 15), jax_mapper.KmerIndex(JaxSequence("g", g), 15)
    ix.starts = jix.starts = np.array([0, 1 << 31], np.int64)
    with pytest.raises(ValueError) as want:
        jix.device_arrays()
    with pytest.raises(ValueError) as got:
        ix.device_arrays("cpu")
    assert str(got.value) == str(want.value) and "2^31" in str(got.value)
    ix2 = mapper.KmerIndex(Sequence("g", g), 15)
    keys, pos = ix2.device_arrays("cpu")
    assert keys.dtype == pos.dtype == torch.int32 and keys.shape == pos.shape == (len(ix2),)
    assert ix2.device_arrays("cpu")[0] is keys  # made once a device


def _mapped_fields(r):
    return (r.read.name, r.strand, r.mapped, r.score, r.mapinfo, r.cigar, r.seeds, r.mapq,
            r.contig.name)


@pytest.mark.parametrize("both_strands", [True, False])
def test_map_reads_device_seeding_equals_host(both_strands):
    """``map_reads(seed_engine="device")`` equals the host-seeded run and
    JAX's device-seeded one."""
    contigs, reads = _genome(5)
    kw = dict(k=15, both_strands=both_strands, with_paths=True)
    pq = [Sequence(n, s) for n, s in reads]
    pc = [Sequence(n, s) for n, s in contigs]
    dev = mapper.map_reads(pq, pc, Scores(*SCORES), seed_engine="device", device="cpu", **kw)
    host = mapper.map_reads(pq, pc, Scores(*SCORES), device="cpu", **kw)
    want = jax_mapper.map_reads([JaxSequence(n, s) for n, s in reads],
                                [JaxSequence(n, s) for n, s in contigs],
                                JaxScores(*SCORES), seed_engine="device", engine="scan", **kw)
    assert [_mapped_fields(r) for r in dev] == [_mapped_fields(r) for r in host]
    assert [_mapped_fields(r) for r in dev] == [_mapped_fields(r) for r in want]
    assert sum(r.mapped for r in dev) >= 10


def test_call_reads_passes_seed_engine():
    contigs, reads = _genome(6)
    pq = [Sequence(n, s) for n, s in reads] * 3
    pc = [Sequence(n, s) for n, s in contigs]
    dev = caller.call_reads(pq, pc, Scores(*SCORES), min_depth=2, k=15, seed_engine="device",
                            device="cpu")
    host = caller.call_reads(pq, pc, Scores(*SCORES), min_depth=2, k=15, device="cpu")
    assert dev[0] == host[0]
    assert dev[1].keys() == host[1].keys()
    assert all(np.array_equal(dev[1][c], host[1][c]) for c in dev[1])


@pytest.mark.parametrize("extra", [[], ["--single-strand", "--format", "tsv"]])
def test_cli_map_device_seeding_matches_jax(tmp_path, capsys, monkeypatch, extra):
    """``map --seed-engine device -k 15`` prints and writes the JAX CLI's
    bytes, which are the host-seeded run's."""
    from genomics_rs_tpu_torch import cli

    q, _, r, cfg = _write_map_inputs(tmp_path, 9)
    base = ["-c", cfg, "map", "-q", q, "-r", r, "-k", "15"] + extra
    runs = run_both_clis(tmp_path, capsys, monkeypatch, base + ["--seed-engine", "device"],
                         "out.sam")
    assert runs["port"] == runs["jax"]
    out = tmp_path / "host.sam"
    assert cli.main(base + ["-o", str(out), "--device", "cpu"]) == 0
    capsys.readouterr()
    assert out.read_bytes() == runs["port"][1]
