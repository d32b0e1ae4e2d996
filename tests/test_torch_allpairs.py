"""The port's ``align-matrix`` path on ``device="cpu"`` against the JAX
package: ``allpairs_scores`` against ``allpairs_scores(engine="scan")``,
``align_batch`` against ``align_batch(engine="scan")``, and the CLI
against the JAX CLI (standard output except the timing line, the TSV
bytes and every alignment FASTA's bytes). Exact equality throughout.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from genomics_rs_tpu.config import Scores as JaxScores
from genomics_rs_tpu.models.aligner import align_batch as jax_align_batch
from genomics_rs_tpu.parallel import allpairs as jax_ap
from genomics_rs_tpu.parallel.batch import pad_batch as jax_pad_batch
from genomics_rs_tpu.sequence import Sequence as JaxSequence
from genomics_rs_tpu.sequence import SequenceContainer as JaxContainer
from genomics_rs_tpu_torch.config import Scores
from genomics_rs_tpu_torch.models import aligner as port_aligner
from genomics_rs_tpu_torch.models.aligner import align_batch
from genomics_rs_tpu_torch.ops import gotoh_rowblock, gotoh_stream, traceback_batch
from genomics_rs_tpu_torch.parallel import allpairs as ap
from genomics_rs_tpu_torch.parallel import batch
from genomics_rs_tpu_torch.sequence import Sequence, SequenceContainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSIC = (1, -2, -1, -5)
KIMURA = (2, -3, -2, -4, -1)
#: lengths over three pow2 classes (128, 256, 512), so 2-3 buckets per axis.
LENGTHS = (100, 120, 200, 250, 130, 300)


def _corpus(seed: int, lengths=LENGTHS) -> list[tuple[str, str]]:
    """Related sequences (mutated copies of one base), so alignments
    hold long matches and gaps."""
    rng = np.random.default_rng(seed)
    base = "".join(rng.choice(list("ACGT"), max(lengths) + 60))
    out = []
    for k, L in enumerate(lengths):
        s = list(base[k * 7 : k * 7 + L])
        for p in rng.integers(0, L, L // 12):
            s[p] = str(rng.choice(list("ACGT")))
        out.append((f"seq {k}|x", "".join(s)))
    return out


def _fields(r):
    return (r.score, [(c.value, i, j) for c, i, j in r.alignment],
            r.matches, r.mismatches, r.opening_gaps, r.gap_extensions)


@pytest.mark.parametrize("is_local", [False, True])
@pytest.mark.parametrize("score_t", [CLASSIC, KIMURA], ids=["classic", "kimura"])
def test_allpairs_cpu_matches_jax_scan(is_local, score_t):
    seqs = _corpus(1)
    got = ap.allpairs_scores(
        SequenceContainer([Sequence(n, s) for n, s in seqs]), Scores.from_tuple(score_t),
        is_local=is_local, device="cpu",
    )
    want = jax_ap.allpairs_scores(
        JaxContainer([JaxSequence(n, s) for n, s in seqs]), JaxScores(*score_t),
        is_local=is_local, engine="scan",
    )
    assert np.array_equal(got.matrix, want.matrix)
    assert (got.names, got.lengths, got.cells, got.padded_cells) == (
        want.names, want.lengths, want.cells, want.padded_cells)


def test_bucketize_pairs_matches_jax():
    lens = [100, 129, 256, 257, 3000, 64]
    pairs = [(i, j) for j in range(len(lens)) for i in range(len(lens)) if i <= j]
    assert ap.bucketize_pairs(pairs, lens) == jax_ap.bucketize_pairs(pairs, lens)
    assert len(ap.bucketize_pairs(pairs, lens)) > 3


def test_write_scores_tsv_matches_jax(tmp_path):
    m = np.tril(np.arange(16).reshape(4, 4) - 5)
    res = ap.AllPairsResult(list("abcd"), [1, 2, 3, 4], m, 1.0, 10.0, 10.0)
    jres = jax_ap.AllPairsResult(list("abcd"), [1, 2, 3, 4], m, 1.0, 10.0, 10.0)
    assert ap.write_scores_tsv(res, str(tmp_path / "a.tsv")) == jax_ap.write_scores_tsv(
        jres, str(tmp_path / "b.tsv"))
    assert (tmp_path / "a.tsv").read_bytes() == (tmp_path / "b.tsv").read_bytes()


@pytest.mark.parametrize("pad_values", [None, [None, 0]])
def test_pad_batch_matches_jax(pad_values):
    a = np.arange(12, dtype=np.uint8).reshape(3, 4)
    n = np.array([5, 6, 7], np.int32)
    got, pb = batch.pad_batch((a, n), 3, 4, pad_values=pad_values)
    want, jpb = jax_pad_batch((a, n), 3, 4, pad_values=pad_values)
    assert pb == jpb == 4
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


@pytest.mark.parametrize("engine", ["segmented", "stream8", "pallas", "scan"])
def test_unported_engines_raise(engine):
    """The K7–K9 tiers and the port's own scan engine give the JAX scan
    oracle's scores and start cells."""
    from genomics_rs_tpu.parallel.batch import batch_scores

    rng = np.random.default_rng(6)
    s1 = rng.choice(np.frombuffer(b"ACGT", np.uint8), (3, 384))
    s2 = rng.choice(np.frombuffer(b"ACGT", np.uint8), (3, 128))
    ms, ns = np.array([384, 300, 0], np.int32), np.array([128, 99, 5], np.int32)
    got = batch.score_pairs(s1, s2, ms, ns, Scores(), True, engine=engine, device="cpu")
    want = batch_scores(s1, s2, ms, ns, JaxScores(), True)
    for g, w in zip(got, (want.score, want.start_i, want.start_j)):
        assert np.array_equal(g, np.asarray(w))


def test_score_pairs_stream_equals_auto():
    rng = np.random.default_rng(4)
    s1 = rng.choice(np.frombuffer(b"ACGT", np.uint8), (3, 128))
    s2 = rng.choice(np.frombuffer(b"ACGT", np.uint8), (3, 256))
    ms, ns = np.array([128, 60, 1]), np.array([256, 200, 7])
    a = batch.score_pairs(s1, s2, ms, ns, Scores(), True, engine="auto", device="cpu")
    b = batch.score_pairs(s1, s2, ms, ns, Scores(), True, engine="stream", device="cpu")
    for x, y in zip(a, b):
        assert np.array_equal(x, y)


def _pairs(seed, n_pairs=5):
    seqs = _corpus(seed)
    out = []
    for k in range(n_pairs):
        a, b = seqs[k % len(seqs)], seqs[(k + 2) % len(seqs)]
        out.append((a[1], b[1]))
    return out


@pytest.mark.parametrize("is_local", [False, True])
@pytest.mark.parametrize("score_t", [CLASSIC, KIMURA], ids=["classic", "kimura"])
def test_align_batch_matches_jax(is_local, score_t):
    raw = _pairs(2 + is_local)
    got = align_batch([(Sequence("a", a), Sequence("b", b)) for a, b in raw],
                      Scores.from_tuple(score_t), is_local=is_local, device="cpu")
    want = jax_align_batch([(JaxSequence("a", a), JaxSequence("b", b)) for a, b in raw],
                           JaxScores(*score_t), is_local=is_local, engine="scan")
    assert [_fields(r) for r in got] == [_fields(r) for r in want]


def test_align_batch_groups_and_routes(monkeypatch):
    """A small budget cuts the batch into groups of two (K3 + K4 per
    group); a budget below two pairs sends every pair to the per-pair
    aligner (K1 + K2); a path longer than one walk buffer is walked per
    pair. All three give the same alignments."""
    raw = _pairs(5)
    pairs = [(Sequence("a", a), Sequence("b", b)) for a, b in raw]
    sc = Scores.from_tuple(CLASSIC)
    whole = align_batch(pairs, sc, device="cpu")
    KW, V = gotoh_stream.dirs_shape(384, 384)
    per_pair = KW * V * 4 + 8192 // 16 * 4
    counts = dict(gotoh_stream.COUNTS), dict(traceback_batch.COUNTS)
    monkeypatch.setattr(port_aligner, "GROUP_BYTE_BUDGET", 2 * per_pair)
    assert [_fields(r) for r in align_batch(pairs, sc, device="cpu")] == [
        _fields(r) for r in whole]
    assert gotoh_stream.COUNTS["plain"] - counts[0]["plain"] == 3
    assert traceback_batch.COUNTS["plain"] - counts[1]["plain"] == 3
    before = gotoh_rowblock.COUNTS["plain"]
    monkeypatch.setattr(port_aligner, "GROUP_BYTE_BUDGET", per_pair)
    assert [_fields(r) for r in align_batch(pairs, sc, device="cpu")] == [
        _fields(r) for r in whole]
    assert gotoh_rowblock.COUNTS["plain"] - before == len(pairs)
    monkeypatch.setattr(port_aligner, "GROUP_BYTE_BUDGET", 4 << 30)
    monkeypatch.setattr(port_aligner, "MAX_STEPS_CAP", 1024)
    many = traceback_batch.COUNTS["plain"]
    assert [_fields(r) for r in align_batch(pairs, sc, device="cpu")] == [
        _fields(r) for r in whole]
    assert traceback_batch.COUNTS["plain"] == many


def test_stream_group_pairs_counts_bitmaps():
    """The 10 x 29,900 bp corpus: (Lm, Ln) = (29952, 29952), one 460 MB
    bitmap per pair, so 9 pairs per 4 GiB group."""
    KW, V = gotoh_stream.dirs_shape(29952, 29952)
    assert (KW, V) == (3745, 30720)
    assert port_aligner._stream_group_pairs(29952, 29952, 65536) == 9
    assert port_aligner._stream_group_pairs(65536, 65536, 131072) == 1


# ---- the CLI ----


def _write_corpus(tmp_path, seqs, score_t):
    d = tmp_path / "fasta"
    d.mkdir()
    for k, (name, s) in enumerate(seqs):
        (d / f"g{k:02d}.fasta").write_text(f">{name}\n{s}\n")
    (d / "notes.txt").write_text("not a fasta\n")
    cfg = tmp_path / "config.toml"
    lines = ["[scores]", f"s_match = {score_t[0]}", f"s_mismatch = {score_t[1]}",
             f"g = {score_t[2]}", f"h = {score_t[3]}"]
    if len(score_t) > 4:
        lines.append(f"s_transition = {score_t[4]}")
    cfg.write_text("\n".join(lines) + "\n")
    return str(d), str(cfg)


def _stdout_without_timing(out: str) -> str:
    lines = out.split("\x1b[0m", 1)[1].splitlines()
    return "\n".join(ln for ln in lines if " DP cells in " not in ln)


@pytest.mark.parametrize(
    "kind,score_t,with_alignments",
    [("global", CLASSIC, True), ("local", KIMURA, True), ("1", CLASSIC, False)],
)
def test_cli_align_matrix_matches_jax(tmp_path, capsys, monkeypatch, kind, score_t,
                                      with_alignments):
    from genomics_rs_tpu import cli as jax_cli
    from genomics_rs_tpu_torch import cli

    monkeypatch.setenv("GENOMICS_TPU_JAX_CACHE", str(tmp_path / "jaxcache"))
    fasta_dir, cfg = _write_corpus(tmp_path, _corpus(7, LENGTHS[:5]), score_t)
    runs = {}
    for name, mod, extra in (("jax", jax_cli, []), ("port", cli, ["--device", "cpu"])):
        out_dir = tmp_path / name
        argv = ["-c", cfg, "align-matrix", "-a", kind, "-f", fasta_dir,
                "-o", str(tmp_path / f"{name}.tsv")]
        if with_alignments:
            argv += ["--alignments-out", str(out_dir)]
        assert mod.main(argv + extra) == 0
        stdout = capsys.readouterr().out.replace(str(out_dir), "OUT")
        files = ({f: (out_dir / f).read_bytes() for f in sorted(os.listdir(out_dir))}
                 if with_alignments else {})
        runs[name] = (_stdout_without_timing(stdout),
                      (tmp_path / f"{name}.tsv").read_bytes(), files)
    assert "Alignment score TSV:" in runs["port"][0]
    assert runs["port"] == runs["jax"]
    if with_alignments:
        assert len(runs["port"][2]) == 10


@pytest.mark.parametrize("extra", [["--matrix", "BLOSUM62"], ["--engine", "scan"]])
def test_cli_align_matrix_unported_options_fail_clearly(tmp_path, capsys, monkeypatch, extra):
    """``--engine scan`` and ``--matrix`` give the JAX CLI's exit code,
    standard output and TSV."""
    from genomics_rs_tpu import cli as jax_cli
    from genomics_rs_tpu_torch import cli

    monkeypatch.setenv("GENOMICS_TPU_JAX_CACHE", str(tmp_path / "jaxcache"))
    fasta_dir, cfg = _write_corpus(tmp_path, _corpus(1, (20, 30)), CLASSIC)
    argv = ["-c", cfg, "align-matrix", "-f", fasta_dir, *extra]
    rc = cli.main(argv + ["-o", str(tmp_path / "port.tsv"), "--device", "cpu"])
    got = capsys.readouterr()
    assert rc == 0 and jax_cli.main(argv + ["-o", str(tmp_path / "jax.tsv")]) == 0
    assert _stdout_without_timing(got.out) == _stdout_without_timing(capsys.readouterr().out)
    assert (tmp_path / "port.tsv").read_bytes() == (tmp_path / "jax.tsv").read_bytes()


def test_cli_align_matrix_cuda_without_cuda_fails_clearly(tmp_path, capsys, monkeypatch):
    import torch

    from genomics_rs_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fasta_dir, cfg = _write_corpus(tmp_path, _corpus(1, (20, 30)), CLASSIC)
    assert cli.main(["-c", cfg, "align-matrix", "-f", fasta_dir]) == 2
    assert "CUDA is not available" in capsys.readouterr().err


def test_load_fasta_dir_and_rows_match_jax(tmp_path):
    from genomics_rs_tpu.comparison.driver import load_fasta_dir as jax_load
    from genomics_rs_tpu.models import msa as jax_msa
    from genomics_rs_tpu_torch.comparison.driver import load_fasta_dir
    from genomics_rs_tpu_torch.models import msa

    fasta_dir, _ = _write_corpus(tmp_path, _corpus(3, (40, 50, 45)), CLASSIC)
    got, want = load_fasta_dir(fasta_dir), jax_load(fasta_dir)
    assert [(s.name, s.sequence) for s in got.sequences] == [
        (s.name, s.sequence) for s in want.sequences]
    a, b = got.sequences[0], got.sequences[1]
    aln = align_batch([(a, b)], Scores(), device="cpu")[0]
    jaln = jax_align_batch([(want.sequences[0], want.sequences[1])], JaxScores(),
                           engine="scan")[0]
    ops = msa._alignment_ops(aln)
    assert ops == jax_msa._alignment_ops(jaln)
    assert "I" in ops or "D" in ops
    assert msa._gapped_pair(a.sequence, b.sequence, ops) == jax_msa._gapped_pair(
        a.sequence, b.sequence, ops)
    with pytest.raises(AssertionError, match="consume"):
        msa._gapped_pair(a.sequence, b.sequence, ops[:-1])


def test_port_modules_do_not_import_jax():
    code = (
        "import sys, genomics_rs_tpu_torch.cli, genomics_rs_tpu_torch.parallel.allpairs, "
        "genomics_rs_tpu_torch.parallel.batch, genomics_rs_tpu_torch.ops.gotoh_stream, "
        "genomics_rs_tpu_torch.models.msa, genomics_rs_tpu_torch.comparison.driver, "
        "genomics_rs_tpu_torch.ops.gotoh_shortread, genomics_rs_tpu_torch.ops.traceback_batch, "
        "genomics_rs_tpu_torch.models.reads, genomics_rs_tpu_torch.models.mapper, "
        "genomics_rs_tpu_torch.models.caller, genomics_rs_tpu_torch.ops.gotoh_matrix, "
        "genomics_rs_tpu_torch.ops.gotoh_matrix_stream, genomics_rs_tpu_torch.ops.subst, "
        "genomics_rs_tpu_torch.ops.gotoh_segmented, genomics_rs_tpu_torch.ops.gotoh_stream8, "
        "genomics_rs_tpu_torch.ops.gotoh_pallas, genomics_rs_tpu_torch.ops.gotoh_tile, "
        "genomics_rs_tpu_torch.parallel.mesh, genomics_rs_tpu_torch.parallel.longseq, "
        "genomics_rs_tpu_torch.parallel.distributed, genomics_rs_tpu_torch.parallel, "
        "genomics_rs_tpu_torch.comparison.display, genomics_rs_tpu_torch.suffixtree.fmindex, "
        "genomics_rs_tpu_torch.suffixtree.native, genomics_rs_tpu_torch.ops.bwt_device, "
        "genomics_rs_tpu_torch.entry, genomics_rs_tpu_torch.ops.gotoh_scan, "
        "genomics_rs_tpu_torch.models.aligner; "
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.') "
        "or k == 'genomics_rs_tpu' or k.startswith('genomics_rs_tpu.')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr
