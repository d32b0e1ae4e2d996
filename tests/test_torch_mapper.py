"""The port's mapper on ``device="cpu"`` against the JAX package: the
k-mer index and the host diagonal vote, ``map_reads`` (both extension
routes: windows up to 256 bytes on K6's plain version, wider ones on
K3's; multi-contig, both strands, junk and soft-masked reads),
``map_pairs`` with ``write_sam_paired``, and the ``map`` CLI (SAM, TSV,
paired) against the JAX CLI run in-process, output files byte for byte.
Equality throughout (every result is an integer or a string).
"""

import numpy as np
import pytest

from genomics_rs_tpu.config import Scores as JaxScores
from genomics_rs_tpu.models import mapper as jax_mapper
from genomics_rs_tpu.sequence import Sequence as JaxSequence
from genomics_rs_tpu_torch.config import Scores
from genomics_rs_tpu_torch.models import mapper
from genomics_rs_tpu_torch.ops import gotoh_shortread as gsr
from genomics_rs_tpu_torch.ops import gotoh_stream as gs
from genomics_rs_tpu_torch.sequence import Sequence
from tests.test_torch_reads import one_torch_thread, run_both_clis  # noqa: F401

SCORES = (1, -2, -1, -5)


def _rc(s: str) -> str:
    return Sequence("", s).reverse_complement().sequence


def _genome(seed):
    """Three contigs (one soft-masked stretch, one N run) and reads from
    them: planted on both strands with a SNP and an indel, a junk read,
    an all-N read and a read across the masked stretch."""
    rng = np.random.default_rng(seed)
    contigs = ["".join(rng.choice(list("ACGT"), n)) for n in (1800, 2600, 700)]
    contigs[0] = contigs[0][:900] + contigs[0][900:1000].lower() + contigs[0][1000:]
    contigs[1] = contigs[1][:1300] + "N" * 30 + contigs[1][1330:]
    reads = []
    for t in range(14):
        c = t % 2
        L = int(rng.integers(60, 130))
        p = int(rng.integers(0, len(contigs[c]) - L))
        frag = list(contigs[c][p : p + L].upper())
        frag[L // 3] = "A" if frag[L // 3] != "A" else "C"
        if t % 3 == 0:
            del frag[L // 2 : L // 2 + 2]
        frag = "".join(frag)
        reads.append((f"q{t} p={p}", _rc(frag) if t % 4 == 1 else frag))
    reads.append(("junk", "".join(rng.choice(list("ACGT"), 90))))
    reads.append(("ns", "N" * 70))
    reads.append(("masked", contigs[0][880:990]))
    return [(f"ctg{k} test", s) for k, s in enumerate(contigs)], reads


def _mapped_fields(r):
    a = r.aligned
    return (r.read.name, r.read.sequence, r.contig.name, r.strand, r.mapped, r.score,
            r.mapinfo, r.cigar, r.seeds, r.mapq, a.matches, a.mismatches,
            a.gap_extensions, a.opening_gaps)


def test_kmer_index_and_votes_match_jax(monkeypatch):
    contigs, reads = _genome(3)
    ix = mapper.KmerIndex([Sequence(n, s) for n, s in contigs], k=13)
    jix = jax_mapper.KmerIndex([JaxSequence(n, s) for n, s in contigs], k=13)
    assert np.array_equal(ix._keys, jix._keys) and np.array_equal(ix._pos, jix._pos)
    assert np.array_equal(ix.starts, jix.starts) and len(ix) == len(jix)
    assert ix.contig_of(2000) == jix.contig_of(2000) == 1
    key = int(ix._keys[5])
    assert np.array_equal(ix.lookup(key), jix.lookup(key))
    L = max(len(s) for _, s in reads)
    enc4 = mapper._BASE[np.stack([
        np.frombuffer(s.ljust(L, "\xfe").encode("latin-1"), np.uint8) for _, s in reads])]
    want = jax_mapper._vote_windows(jix, enc4, 6, 64, 32)
    for got in (mapper._vote_windows(ix, enc4, 6, 64, 32),):
        for g, w in zip(got, want):
            assert np.array_equal(g, w)
    monkeypatch.setattr(mapper, "_PAR_CHUNK", 4)  # the thread-parallel path
    for g, w in zip(mapper._vote_windows(ix, enc4, 6, 64, 32), want):
        assert np.array_equal(g, w)
    with pytest.raises(ValueError):
        mapper.KmerIndex(Sequence("r", "ACGT"), k=3)


@pytest.mark.parametrize("band,route", [(32, "k6"), (48, "k3")])
@pytest.mark.parametrize("both_strands", [True, False])
def test_map_reads_matches_jax(band, route, both_strands):
    contigs, reads = _genome(5)
    kw = dict(k=15, band=band, both_strands=both_strands, with_paths=True)
    before = gsr.COUNTS["plain"], gs.COUNTS["plain"]
    got = mapper.map_reads([Sequence(n, s) for n, s in reads],
                           [Sequence(n, s) for n, s in contigs], Scores(*SCORES),
                           device="cpu", **kw)
    want = jax_mapper.map_reads([JaxSequence(n, s) for n, s in reads],
                                [JaxSequence(n, s) for n, s in contigs], JaxScores(*SCORES),
                                engine="scan", **kw)
    assert [_mapped_fields(r) for r in got] == [_mapped_fields(r) for r in want]
    assert [[(c.value, i, j) for c, i, j in r.aligned.alignment] for r in got] == [
        [(c.value, i, j) for c, i, j in r.aligned.alignment] for r in want]
    # Every planted read on the mapped strands maps; the N read does not.
    assert sum(r.mapped for r in got) >= (14 if both_strands else 10)
    assert not got[-2].mapped
    # read_len + 4*band: up to 258 bytes at band 32 (K6), 322 at band 48 (K3).
    used = gsr.COUNTS["plain"] - before[0], gs.COUNTS["plain"] - before[1]
    assert used == ((1, 0) if route == "k6" else (0, 1))


def test_map_reads_knobs():
    ref = Sequence("r", "".join(np.random.default_rng(1).choice(list("ACGT"), 500)))
    with pytest.raises(ValueError, match="k <= 15"):
        mapper.map_reads([ref], ref, Scores(), seed_engine="device", device="cpu")
    for bad in (dict(band=0), dict(max_hits=0), dict(seed_engine="gpu")):
        with pytest.raises(ValueError):
            mapper.map_reads([ref], ref, Scores(), device="cpu", **bad)
    ix = mapper.KmerIndex(ref, k=11)
    with pytest.raises(ValueError, match="different reference"):
        mapper.map_reads([ref], Sequence("o", "ACGT" * 50), Scores(), index=ix, device="cpu")
    assert mapper.map_reads([], ref, Scores(), device="cpu") == []


def test_map_pairs_and_paired_sam_match_jax(tmp_path):
    rng = np.random.default_rng(77)
    ref = "".join(rng.choice(list("ACGT"), 3000))
    r1 = [("t0", ref[700:800]), ("t1", ref[1500:1600]), ("t2", ref[100:200]),
          ("t3", ref[2000:2100])]
    r2 = [("t0", _rc(ref[900:1000])), ("t1", "N" * 100), ("t2", ref[2500:2600]),
          ("t3", _rc(ref[1000:1100]))]
    out = {}
    for name, mod, Seq, sc, extra in (
        ("port", mapper, Sequence, Scores(*SCORES), dict(device="cpu")),
        ("jax", jax_mapper, JaxSequence, JaxScores(*SCORES), dict(engine="scan")),
    ):
        refs = [Seq("chrP x", ref)]
        res1, res2 = mod.map_pairs([Seq(n, s, "I" * len(s)) for n, s in r1],
                                   [Seq(n, s) for n, s in r2], refs, sc, k=15, **extra)
        path = tmp_path / f"{name}.sam"
        proper = mod.write_sam_paired(str(path), res1, res2, header_refs=refs, max_insert=1000)
        out[name] = (proper, path.read_bytes())
    assert out["port"] == out["jax"]
    assert out["port"][0] == 1


def _write_map_inputs(tmp_path, seed):
    contigs, reads = _genome(seed)
    q = tmp_path / "reads.fastq"
    q.write_text("".join(f"@{n}\n{s}\n+\n{'I' * len(s)}\n" for n, s in reads))
    q2 = tmp_path / "mates.fasta"
    q2.write_text("".join(f">{n}\n{_rc(s)}\n" for n, s in reads))
    r = tmp_path / "ref.fasta"
    r.write_text("".join(f">{n}\n{s}\n" for n, s in contigs))
    cfg = tmp_path / "config.toml"
    cfg.write_text("[scores]\ns_match = 1\ns_mismatch = -2\ng = -1\nh = -5\n")
    return str(q), str(q2), str(r), str(cfg)


@pytest.mark.parametrize(
    "extra,out_name",
    [([], "out.sam"), (["--format", "tsv", "--band", "48"], "out.tsv"),
     (["--single-strand", "--stride", "3", "--max-hits", "8"], "out.sam"),
     (["-2", "MATES", "--max-insert", "500"], "out.sam")],
)
def test_cli_map_matches_jax(tmp_path, capsys, monkeypatch, extra, out_name):
    q, q2, r, cfg = _write_map_inputs(tmp_path, 9)
    extra = [q2 if x == "MATES" else x for x in extra]
    argv = ["-c", cfg, "map", "-q", q, "-r", r, "-k", "15"] + extra
    runs = run_both_clis(tmp_path, capsys, monkeypatch, argv, out_name)
    assert runs["port"] == runs["jax"]
    assert len(runs["port"][1].splitlines()) > 10


@pytest.mark.parametrize("extra", [["--seed-engine", "device"], ["--engine", "scan"]])
def test_cli_map_unported_options_exit_2(tmp_path, capsys, monkeypatch, extra):
    """At the default k = 21 ``--seed-engine device`` exits 1 with the JAX
    CLI's message; ``--engine scan`` gives the JAX CLI's bytes."""
    from genomics_rs_tpu import cli as jax_cli
    from genomics_rs_tpu_torch import cli

    q, _, r, cfg = _write_map_inputs(tmp_path, 1)
    argv = ["-c", cfg, "map", "-q", q, "-r", r, *extra]
    if "--seed-engine" in extra:
        caplog = []
        for mod, tail in ((jax_cli, []), (cli, ["--device", "cpu"])):
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr("logging.Logger.error",
                           lambda self, msg, *a, **k: caplog.append(msg % a))
                assert mod.main(argv + ["-o", str(tmp_path / "x.sam")] + tail) == 1
        assert caplog == ["device seeding requires k <= 15 (int32 keys); index has k=21"] * 2
        return
    runs = run_both_clis(tmp_path, capsys, monkeypatch, argv, "out.sam")
    assert runs["port"] == runs["jax"]
