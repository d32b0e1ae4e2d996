"""The port's read aligner on ``device="cpu"`` against the JAX package:
``align_reads`` against JAX ``align_reads`` (its CPU scan engine) on both
routes (K6 + ``walk_rows16`` up to 256 bytes, K3 + K4 beyond), global
and local, with both strands: paths, stats, CIGARs, strands and walk
endpoints; ``encode_batch``; and the ``reads`` CLI (scores TSV, both
strands, ``--align`` TSV and SAM) against the JAX CLI run in-process,
output files byte for byte. Every result is an integer or a string:
equality throughout.
"""

import numpy as np
import pytest
import torch

from genomics_rs_tpu.config import Scores as JaxScores
from genomics_rs_tpu.models import reads as jax_reads
from genomics_rs_tpu.sequence import Sequence as JaxSequence
from genomics_rs_tpu_torch.config import Scores
from genomics_rs_tpu_torch.models import reads
from genomics_rs_tpu_torch.ops import gotoh_shortread as gsr
from genomics_rs_tpu_torch.ops import gotoh_stream as gs
from genomics_rs_tpu_torch.ops import traceback_batch as tb
from genomics_rs_tpu_torch.ops import traceback_walker as tw
from genomics_rs_tpu_torch.sequence import Sequence

CLASSIC = (1, -2, -1, -5)
KIMURA = (2, -3, -2, -4, -1)
#: read lengths of the two routes: padded to 128 (K6), and to 384 (K3).
ROUTES = {"k6": (20, 120), "k3": (260, 300)}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The plain fills run thousands of small torch ops; in a parallel
    test run torch's thread pool only contends with the other workers
    (a K3-route test ran 15x slower under load with it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reads(seed, n, lo, hi, with_qual=False):
    """Reads and mutated, shifted copies (with a reverse-complemented
    one), so alignments hold matches, mismatches and gaps."""
    rng = np.random.default_rng(seed)
    qs, rs = [], []
    for k in range(n):
        L = int(rng.integers(lo, hi))
        q = "".join(rng.choice(list("ACGT"), L))
        r = list(q)
        for _ in range(max(1, L // 15)):
            r[int(rng.integers(0, L))] = str(rng.choice(list("ACGT")))
        cut = int(rng.integers(0, 20))
        r = "".join(r[cut:]) + "".join(rng.choice(list("ACGT"), cut // 2))
        p = int(rng.integers(0, len(r) - 5))
        r = r[:p] + r[p + 3 :]  # a deletion
        if k % 3 == 2:
            r = Sequence("x", r).reverse_complement().sequence
        qual = "".join(chr(33 + int(x)) for x in rng.integers(2, 40, L)) if with_qual else None
        qs.append((f"q{k} read", q, qual))
        rs.append((f"r{k}", r))
    return qs, rs


def _both(qs, rs):
    port = ([Sequence(n, s, ql) for n, s, ql in qs], [Sequence(n, s) for n, s in rs])
    jax = ([JaxSequence(n, s, ql) for n, s, ql in qs], [JaxSequence(n, s) for n, s in rs])
    return port, jax


def _fields(a):
    return (a.score, a.matches, a.mismatches, a.gap_extensions, a.opening_gaps,
            [(c.value, i, j) for c, i, j in a.alignment])


@pytest.mark.parametrize("is_local", [False, True])
@pytest.mark.parametrize("route", ["k6", "k3"])
def test_align_reads_matches_jax(route, is_local):
    qs, rs = _reads(5 + is_local, 10, *ROUTES[route])
    (pq, pr), (jq, jr) = _both(qs, rs)
    kw = dict(is_local=is_local, with_cigars=True, both_strands=True, with_mapinfo=True,
              batch=16)
    counts = dict(gsr.COUNTS), dict(gs.COUNTS), dict(tb.COUNTS), dict(tw.COUNTS)
    got = reads.align_reads(pq, pr, Scores(), device="cpu", **kw)
    want = jax_reads.align_reads(jq, jr, JaxScores(), engine="scan", **kw)
    assert [_fields(a) for a in got[0]] == [_fields(a) for a in want[0]]
    assert got[1:] == want[1:]
    assert set(got[2]) == {"+", "-"}
    # Two rounds (batch 16 halves to 8 for both strands), on the route's fill.
    fills = gsr.COUNTS["plain"] - counts[0]["plain"], gs.COUNTS["plain"] - counts[1]["plain"]
    assert fills == ((2, 0) if route == "k6" else (0, 2))
    assert tb.COUNTS["plain"] - counts[2]["plain"] == 2


@pytest.mark.parametrize("score_t", [CLASSIC, KIMURA], ids=["classic", "kimura"])
def test_align_reads_one_strand_no_paths_matches_jax(score_t):
    qs, rs = _reads(9, 5, 30, 100)
    (pq, pr), (jq, jr) = _both(qs, rs)
    got, gcig = reads.align_reads(pq, pr, Scores.from_tuple(score_t), is_local=True,
                                  with_paths=False, with_cigars=True, device="cpu")
    want, wcig = jax_reads.align_reads(jq, jr, JaxScores(*score_t), is_local=True,
                                       with_paths=False, with_cigars=True, engine="scan")
    assert gcig == wcig
    assert [_fields(a) for a in got] == [_fields(a) for a in want]
    assert all(a.alignment == [] for a in got)


def test_align_reads_single_ref_broadcast_and_pallas_engine():
    qs, _ = _reads(12, 4, 40, 60)
    ref = "".join(np.random.default_rng(1).choice(list("ACGT"), 200))
    pq = [Sequence(n, ref[10:20] + s + ref[50:60], ql) for n, s, ql in qs]
    jq = [JaxSequence(q.name, q.sequence) for q in pq]
    got = reads.align_reads(pq, [Sequence("ref", ref)], Scores(), engine="pallas", device="cpu")
    want = jax_reads.align_reads(jq, [JaxSequence("ref", ref)], JaxScores(), engine="scan")
    assert [_fields(a) for a in got] == [_fields(a) for a in want]
    assert reads.cigar(got[0]) == jax_reads.cigar(want[0])


def test_encode_batch_matches_jax():
    seqs = [Sequence("a", "ACGT"), Sequence("b", "AC"), Sequence("c", "")]
    jseqs = [JaxSequence(s.name, s.sequence) for s in seqs]
    assert np.array_equal(reads.encode_batch(seqs, 8, 0xFE), jax_reads.encode_batch(jseqs, 8, 0xFE))
    one = Sequence("r", "ACG")
    view = reads.encode_batch([one] * 3, 4, 0xFF)
    assert not view.flags.writeable and view.shape == (3, 4)
    assert np.array_equal(view, jax_reads.encode_batch([JaxSequence("r", "ACG")] * 3, 4, 0xFF))


def test_align_reads_rejects_incomplete_global_walk(monkeypatch):
    """A global walk that stops short of (0, 0) is a corrupt fill and
    raises, naming the read."""
    real = reads.walk_batch_launch

    def short_walk(*args):
        read = real(*args)

        def short_read():
            moves, counts, i_f, j_f, done = read()
            return moves, counts, i_f + 1, j_f, done

        return short_read

    monkeypatch.setattr(reads, "walk_batch_launch", short_walk)
    q = [Sequence("q", "ACGTACGT")]
    with pytest.raises(RuntimeError, match="read 0 retrace did not terminate"):
        reads.align_reads(q, q, Scores(), is_local=False, device="cpu")


@pytest.mark.parametrize("engine", ["scan", "bogus"])
def test_align_reads_engines(engine):
    """``"scan"`` gives the JAX scan engine's alignment; an unknown engine
    raises as JAX's does."""
    q = [Sequence("q", "ACGT")]
    if engine == "bogus":
        with pytest.raises(ValueError):
            reads.align_reads(q, q, Scores(), engine=engine, device="cpu")
        return
    got = reads.align_reads(q, q, Scores(), engine=engine, device="cpu", with_cigars=True)
    jq = [JaxSequence("q", "ACGT")]
    want = jax_reads.align_reads(jq, jq, JaxScores(), engine=engine, with_cigars=True)
    assert [_fields(a) for a in got[0]] == [_fields(a) for a in want[0]]
    assert got[1] == want[1] == ["4M"]


# ---- the CLI ----


def _write_inputs(tmp_path, qs, rs, score_t, fastq=False):
    q = tmp_path / ("q.fastq" if fastq else "q.fasta")
    if fastq:
        q.write_text("".join(f"@{n}\n{s}\n+\n{ql}\n" for n, s, ql in qs))
    else:
        q.write_text("".join(f">{n}\n{s}\n" for n, s, _ in qs))
    r = tmp_path / "r.fasta"
    r.write_text("".join(f">{n}\n{s}\n" for n, s in rs))
    cfg = tmp_path / "config.toml"
    lines = ["[scores]", f"s_match = {score_t[0]}", f"s_mismatch = {score_t[1]}",
             f"g = {score_t[2]}", f"h = {score_t[3]}"]
    if len(score_t) > 4:
        lines.append(f"s_transition = {score_t[4]}")
    cfg.write_text("\n".join(lines) + "\n")
    return str(q), str(r), str(cfg)


def _stdout_without_timing(out: str) -> str:
    lines = out.split("\x1b[0m", 1)[1].splitlines()
    return "\n".join(ln for ln in lines if " in " not in ln)


def run_both_clis(tmp_path, capsys, monkeypatch, argv, out_name, port_extra=()):
    """Run the JAX CLI and the port's (``--device cpu`` and
    ``port_extra``) with ``argv``, each writing ``out_name`` in its own
    directory; returns {name: (stdout without timing lines, output
    bytes)}."""
    from genomics_rs_tpu import cli as jax_cli
    from genomics_rs_tpu_torch import cli

    monkeypatch.setenv("GENOMICS_TPU_JAX_CACHE", str(tmp_path / "jaxcache"))
    runs = {}
    for name, mod, extra in (("jax", jax_cli, []),
                             ("port", cli, ["--device", "cpu", *port_extra])):
        out = tmp_path / name / out_name
        out.parent.mkdir()
        assert mod.main(argv + ["-o", str(out)] + extra) == 0
        stdout = capsys.readouterr().out.replace(str(out), "OUT")
        runs[name] = (_stdout_without_timing(stdout), out.read_bytes())
    return runs


@pytest.mark.parametrize(
    "kind,score_t,extra,engine",
    [("global", CLASSIC, [], "auto"), ("local", KIMURA, ["--both-strands"], "auto"),
     ("local", CLASSIC, [], "shortread"), ("1", CLASSIC, ["--both-strands"], "stream")],
)
def test_cli_reads_scores_match_jax(tmp_path, capsys, monkeypatch, kind, score_t, extra,
                                    engine):
    qs, rs = _reads(31, 7, 20, 110)
    q, r, cfg = _write_inputs(tmp_path, qs, rs, score_t)
    argv = ["-c", cfg, "reads", "-q", q, "-r", r, "-a", kind] + extra
    # The JAX CLI takes its CPU route (auto: the scan engine).
    runs = run_both_clis(tmp_path, capsys, monkeypatch, argv, "scores.tsv",
                         ["--engine", engine])
    assert runs["port"] == runs["jax"]
    assert runs["port"][1].startswith(b"query\tref\tscore\tend_i\tend_j")


@pytest.mark.parametrize(
    "fmt,extra,fastq",
    [("tsv", [], False), ("tsv", ["--both-strands"], True), ("sam", [], True),
     ("sam", ["--both-strands", "-a", "global"], False)],
)
def test_cli_reads_align_matches_jax(tmp_path, capsys, monkeypatch, fmt, extra, fastq):
    qs, rs = _reads(32, 7, 20, 110, with_qual=True)
    q, r, cfg = _write_inputs(tmp_path, qs, rs, CLASSIC, fastq=fastq)
    argv = ["-c", cfg, "reads", "-q", q, "-r", r, "--align", "--format", fmt] + extra
    runs = run_both_clis(tmp_path, capsys, monkeypatch, argv, f"out.{fmt}")
    assert runs["port"] == runs["jax"]
    if fmt == "sam":
        assert runs["port"][1].startswith(b"@HD\tVN:1.6")


@pytest.mark.parametrize(
    "extra", [["--engine", "scan"], ["--both-strands", "--engine", "scan"],
              ["--align", "--engine", "scan"]])
def test_cli_reads_unported_engines_exit_2(tmp_path, capsys, monkeypatch, extra):
    """``reads --engine scan`` (scores, both strands, ``--align``) prints
    and writes the JAX CLI's bytes."""
    q, r, cfg = _write_inputs(tmp_path, *_reads(1, 2, 10, 20), CLASSIC)
    argv = ["-c", cfg, "reads", "-q", q, "-r", r, *extra]
    runs = run_both_clis(tmp_path, capsys, monkeypatch, argv, "out.tsv")
    assert runs["port"] == runs["jax"]
    assert len(runs["port"][1].splitlines()) == 3


def test_cli_reads_sam_needs_align(tmp_path):
    from genomics_rs_tpu_torch import cli

    q, r, cfg = _write_inputs(tmp_path, *_reads(1, 2, 10, 20), CLASSIC)
    assert cli.main(["-c", cfg, "reads", "-q", q, "-r", r, "--format", "sam",
                     "--device", "cpu"]) == 1
