"""The port's ``align`` path end to end on ``device="cpu"``.

The CPU route runs every kernel's plain version; results are held
against the JAX package (``PairwiseAligner(engine="scan")``) and the
reference goldens of ``tests/test_alignment.py``, with exact equality
of scores, paths and stats, and against the JAX CLI's stdout.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from genomics_rs_tpu.config import Scores as JaxScores
from genomics_rs_tpu.models.aligner import PairwiseAligner as JaxAligner
from genomics_rs_tpu.sequence import Sequence as JaxSequence
from genomics_rs_tpu_torch.config import Scores
from genomics_rs_tpu_torch.models import longalign
from genomics_rs_tpu_torch.models.aligner import PairwiseAligner
from genomics_rs_tpu_torch.models.longalign import align_checkpointed
from genomics_rs_tpu_torch.ops import gotoh_rowblock, traceback_device, traceback_walker
from genomics_rs_tpu_torch.ops.traceback import AlignmentChoice as C
from genomics_rs_tpu_torch.sequence import Sequence

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEST_SCORES = (1, -2, -2, -5)
SCORES = (1, -2, -1, -5)
KIMURA = (2, -3, -2, -4, -1)


def _align(a: str, b: str, is_local=False, score_t=TEST_SCORES):
    aligner = PairwiseAligner(Scores.from_tuple(score_t), is_local=is_local, device="cpu")
    return aligner.align(Sequence("s1", a), Sequence("s2", b))


def _jax_align(a: str, b: str, is_local, score_t):
    aligner = JaxAligner(JaxScores(*score_t), is_local=is_local, engine="scan")
    return aligner.align(JaxSequence("s1", a), JaxSequence("s2", b))


def _fields(r):
    return (
        r.score,
        [(c.value, i, j) for c, i, j in r.alignment],
        r.matches,
        r.mismatches,
        r.opening_gaps,
        r.gap_extensions,
    )


def _pair(rng, m, n, edits=6, shift=5):
    """Correlated strings, so paths have long matches and gaps."""
    base = rng.choice(list("ACGT"), max(m, n) + 50)
    a = "".join(base[:m])
    bl = list(base[shift : n + shift])
    for _ in range(edits):
        bl[int(rng.integers(0, n))] = str(rng.choice(list("ACGT")))
    return a, "".join(bl)


# ---- reference goldens (tests/test_alignment.py) ----


def test_golden_simple_matches():
    r = _align("ACGT", "ACGT")
    assert (r.score, r.matches, r.mismatches, r.opening_gaps, r.gap_extensions) == (
        4, 4, 0, 0, 0,
    )
    assert r.alignment == [(C.MATCH, 4, 4), (C.MATCH, 3, 3), (C.MATCH, 2, 2), (C.MATCH, 1, 1)]


def test_golden_gaps():
    r = _align("ACGT", "AGCGT")
    assert (r.matches, r.mismatches, r.opening_gaps, r.gap_extensions) == (3, 1, 1, 0)
    assert r.alignment == [
        (C.MATCH, 4, 5),
        (C.MATCH, 3, 4),
        (C.MATCH, 2, 3),
        (C.OPEN_INSERT, 1, 2),
        (C.MISMATCH, 1, 1),
    ]


def test_golden_affine_gap():
    r = _align("ACGGATAAAAAAAATC", "ACGGATAAAATC")
    assert (r.matches, r.mismatches, r.opening_gaps, r.gap_extensions) == (12, 0, 1, 3)
    assert r.alignment == [
        (C.MATCH, 16, 12), (C.MATCH, 15, 11), (C.MATCH, 14, 10),
        (C.MATCH, 13, 9), (C.MATCH, 12, 8), (C.MATCH, 11, 7),
        (C.OPEN_DELETE, 10, 6), (C.DELETE, 9, 6), (C.DELETE, 8, 6),
        (C.DELETE, 7, 6), (C.MATCH, 6, 6), (C.MATCH, 5, 5),
        (C.MATCH, 4, 4), (C.MATCH, 3, 3), (C.MATCH, 2, 2), (C.MATCH, 1, 1),
    ]


def test_golden_local_simple():
    r = _align("TTTACGTTTT", "ACGT", is_local=True)
    assert r.score == 4
    assert r.matches + r.mismatches == 4
    assert [c for c, _, _ in r.alignment].count(C.MATCH) == r.matches


# ---- seeded pairs against the JAX aligner ----


@pytest.mark.parametrize("is_local", [False, True])
@pytest.mark.parametrize("score_t", [SCORES, KIMURA], ids=["classic", "kimura"])
def test_align_matches_jax(is_local, score_t):
    rng = np.random.default_rng(101 + is_local)
    for _ in range(3):
        m, n = int(rng.integers(5, 260)), int(rng.integers(5, 260))
        a, b = _pair(rng, m, n)
        assert _fields(_align(a, b, is_local, score_t)) == _fields(
            _jax_align(a, b, is_local, score_t)
        )


def _path_cost(a: str, b: str, r, score_t) -> int:
    """The path's cost under the model, each substitution scored with
    the true characters (the stats' match count follows the reference's
    off-by-one ``is_match`` instead)."""
    s_match, s_mismatch, g, h = score_t
    cost = 0
    for ch, i, j in r.alignment:
        if ch.name in ("MATCH", "MISMATCH"):
            cost += s_match if a[i - 1] == b[j - 1] else s_mismatch
        elif ch.name.startswith("OPEN"):
            cost += h + g
        else:
            cost += g
    return cost


@pytest.mark.parametrize("seed,is_local", [(202, False), (200, True)])
def test_path_cost_below_score_matches_jax(seed, is_local):
    """The reference retrace picks each move by the cell's max code, not
    by the matrix a gap came from, so its path can cost less than the
    score it starts from. The JAX aligner's own path does so on these
    pairs; the port's path, stats and path cost equal JAX's."""
    rng = np.random.default_rng(seed)
    m, n = int(rng.integers(30, 130)), int(rng.integers(30, 130))
    a, b = _pair(rng, m, n, edits=12)
    want = _jax_align(a, b, is_local, SCORES)
    assert _path_cost(a, b, want, SCORES) < want.score
    got = _align(a, b, is_local, SCORES)
    assert _fields(got) == _fields(want)
    assert _path_cost(a, b, got, SCORES) == _path_cost(a, b, want, SCORES)


@pytest.mark.parametrize("is_local", [False, True])
def test_score_only_matches_jax(is_local):
    rng = np.random.default_rng(7)
    a, b = _pair(rng, 150, 190)
    ts = Scores.from_tuple(SCORES)
    got = PairwiseAligner(ts, is_local=is_local, device="cpu").score_only(
        Sequence("a", a), Sequence("b", b)
    )
    assert got == _jax_align(a, b, is_local, SCORES).score


@pytest.mark.parametrize("is_local", [False, True])
def test_checkpointed_blocks_match_jax(is_local):
    """block_rows=64: many row blocks, bottoms chained block to block."""
    rng = np.random.default_rng(47)
    for _ in range(2):
        m, n = int(rng.integers(10, 300)), int(rng.integers(10, 300))
        a, b = _pair(rng, m, n)
        got = align_checkpointed(
            Sequence("s1", a), Sequence("s2", b), Scores.from_tuple(SCORES),
            is_local=is_local, block_rows=64, device="cpu",
        )
        assert _fields(got) == _fields(_jax_align(a, b, is_local, SCORES))


@pytest.mark.parametrize("is_local", [False, True])
def test_checkpointed_windows_match_jax(is_local):
    """block_rows=1023 (V=1024) and n > 2V: refills start at captured
    columns (jc > 0) with streamed left boundaries, across two blocks."""
    rng = np.random.default_rng(61)
    a, b = _pair(rng, 1100, 2200, edits=15, shift=7)
    got = align_checkpointed(
        Sequence("s1", a), Sequence("s2", b), Scores.from_tuple(SCORES),
        is_local=is_local, block_rows=1023, device="cpu",
    )
    assert _fields(got) == _fields(_jax_align(a, b, is_local, SCORES))


def test_checkpointed_left_exit_matches_jax():
    """A horizontal run longer than the window stride exits left and
    resumes in a wider window (tests/test_longalign.py's case)."""
    rng = np.random.default_rng(62)
    m, n = 300, 2600
    a = "".join(rng.choice(list("ACGT"), m))
    b = a[:150] + "".join(rng.choice(list("ACGT"), n - m)) + a[150:]
    before = gotoh_rowblock.COUNTS["plain"]
    got = align_checkpointed(
        Sequence("s1", a), Sequence("s2", b), Scores.from_tuple(SCORES),
        is_local=False, block_rows=1023, device="cpu",
    )
    assert _fields(got) == _fields(_jax_align(a, b, False, SCORES))
    # one forward fill plus more than one window refill
    assert gotoh_rowblock.COUNTS["plain"] - before >= 3


def _interior_local_pair(rng):
    """A shared core between unrelated flanks: the local best cell lies
    above row m and left of column n."""
    core = "".join(rng.choice(list("ACGT"), 80))
    flank = lambda k: "".join(rng.choice(list("ACGT"), k))  # noqa: E731
    return flank(50) + core + flank(70), flank(30) + core + flank(95)


@pytest.mark.parametrize("is_local", [False, True])
@pytest.mark.parametrize("case", ["equal", "interior_best", "n_2v_minus_1", "n_2v"])
def test_checkpointed_one_block_one_fill(is_local, case):
    """block_rows=1023 (V=1024), one block: with n < 2V every walk window
    starts at column 0, so one fill with dirs replaces the forward pass
    and the refill; at n = 2V the forward pass and the windowed refills
    stay."""
    rng = np.random.default_rng(71)
    if case == "equal":
        a, b = _pair(rng, 200, 200)
    elif case == "interior_best":
        a, b = _interior_local_pair(rng)
    else:
        a, b = _pair(rng, 300, 2047 if case == "n_2v_minus_1" else 2048, edits=12)
    fills, routes = gotoh_rowblock.COUNTS["plain"], dict(longalign.ROUTE_COUNTS)
    got = align_checkpointed(
        Sequence("s1", a), Sequence("s2", b), Scores.from_tuple(SCORES),
        is_local=is_local, block_rows=1023, device="cpu",
    )
    assert _fields(got) == _fields(_jax_align(a, b, is_local, SCORES))
    fills = gotoh_rowblock.COUNTS["plain"] - fills
    if case == "n_2v":
        assert fills >= 2
        assert longalign.ROUTE_COUNTS["forward"] == routes["forward"] + 1
        assert longalign.ROUTE_COUNTS["one_fill"] == routes["one_fill"]
    else:
        assert fills == 1
        assert longalign.ROUTE_COUNTS["one_fill"] == routes["one_fill"] + 1
        assert longalign.ROUTE_COUNTS["forward"] == routes["forward"]
    if case == "interior_best" and is_local:
        _, i_end, j_end = got.alignment[0]
        assert 0 < i_end < len(a) and 0 < j_end < len(b)


def test_budget_routes_to_checkpointed(monkeypatch):
    rng = np.random.default_rng(3)
    a, b = _pair(rng, 200, 230)
    monkeypatch.setattr(PairwiseAligner, "DIRS_BYTE_BUDGET", 1)
    got = _align(a, b, False, SCORES)
    assert _fields(got) == _fields(_jax_align(a, b, False, SCORES))


def test_cpu_route_runs_plain_versions():
    before = (
        gotoh_rowblock.COUNTS["plain"],
        traceback_device.COUNTS["plain"],
        gotoh_rowblock.COUNTS["kernel"],
        traceback_walker.COUNTS["kernel"],
    )
    _align("ACGTTGCA", "ACGTGCA")
    assert gotoh_rowblock.COUNTS["plain"] == before[0] + 1
    assert traceback_device.COUNTS["plain"] > before[1]
    assert gotoh_rowblock.COUNTS["kernel"] == before[2]
    assert traceback_walker.COUNTS["kernel"] == before[3]


def test_cuda_request_without_cuda_is_an_error(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PairwiseAligner(Scores(), device="cuda")


def test_port_does_not_import_jax():
    code = (
        "import sys, genomics_rs_tpu_torch.cli, genomics_rs_tpu_torch.models.aligner, "
        "genomics_rs_tpu_torch.native, genomics_rs_tpu_torch.display.alignment, "
        "genomics_rs_tpu_torch.models.banded, genomics_rs_tpu_torch.ops.gotoh_banded_batch, "
        "genomics_rs_tpu_torch.ops.gotoh_matrix, genomics_rs_tpu_torch.ops.gotoh_matrix_stream, "
        "genomics_rs_tpu_torch.ops.subst, genomics_rs_tpu_torch.models.msa, "
        "genomics_rs_tpu_torch.suffixtree, genomics_rs_tpu_torch.suffixtree.tree, "
        "genomics_rs_tpu_torch.suffixtree.native, genomics_rs_tpu_torch.suffixtree.fmindex, "
        "genomics_rs_tpu_torch.ops.bwt_device, genomics_rs_tpu_torch.display.tree; "
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.') "
        "or k == 'genomics_rs_tpu' or k.startswith('genomics_rs_tpu.')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


# ---- the CLI ----


def _write_inputs(tmp_path, a, b, score_t):
    fasta = tmp_path / "pair.fasta"
    fasta.write_text(f">s1\n{a}\n>s2\n{b}\n")
    cfg = tmp_path / "config.toml"
    lines = ["[scores]", f"s_match = {score_t[0]}", f"s_mismatch = {score_t[1]}",
             f"g = {score_t[2]}", f"h = {score_t[3]}"]
    if len(score_t) > 4:
        lines.append(f"s_transition = {score_t[4]}")
    cfg.write_text("\n".join(lines) + "\n")
    return str(fasta), str(cfg)


def _after_banner(out: str) -> str:
    return out.split("\x1b[0m", 1)[1]


@pytest.mark.parametrize(
    "kind,score_t,lengths",
    [("global", SCORES, (40, 52)), ("local", KIMURA, (60, 45)), ("1", SCORES, (230, 260))],
)
def test_cli_align_stdout_matches_jax(tmp_path, capsys, monkeypatch, kind, score_t, lengths):
    from genomics_rs_tpu import cli as jax_cli
    from genomics_rs_tpu_torch import cli

    monkeypatch.setenv("GENOMICS_TPU_JAX_CACHE", str(tmp_path / "jaxcache"))
    rng = np.random.default_rng(len(kind))
    a, b = _pair(rng, *lengths)
    fasta, cfg = _write_inputs(tmp_path, a, b, score_t)
    argv = ["-c", cfg, "align", "-a", kind, "-f", fasta]
    assert jax_cli.main(argv) == 0
    want = capsys.readouterr().out
    assert cli.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert "Alignment Score" in got
    assert _after_banner(got) == _after_banner(want)


@pytest.mark.parametrize(
    "extra", [["--matrix", "BLOSUM62"], ["--matrix", "BLOSUM62", "--band", "8"], ["--engine", "scan"]]
)
def test_cli_unported_options_fail_clearly(tmp_path, capsys, monkeypatch, extra):
    """``--engine scan`` and ``--matrix`` give the JAX CLI's bytes and exit
    code (``--matrix`` with ``--band`` its "mutually exclusive" error, rc
    2)."""
    from genomics_rs_tpu import cli as jax_cli
    from genomics_rs_tpu_torch import cli

    monkeypatch.setenv("GENOMICS_TPU_JAX_CACHE", str(tmp_path / "jaxcache"))
    fasta, cfg = _write_inputs(tmp_path, "ACGT", "ACGA", SCORES)
    argv = ["-c", cfg, "align", "-a", "global", "-f", fasta, *extra]
    rc = cli.main(argv + ["--device", "cpu"])
    got = capsys.readouterr()
    assert jax_cli.main(argv) == rc == (2 if "--band" in extra else 0)
    want = capsys.readouterr()
    assert _after_banner(got.out) == _after_banner(want.out)
    if rc == 2:
        assert got.err == want.err == "--matrix and --band are mutually exclusive\n"
    else:
        assert "Alignment Score" in got.out


def test_cli_cuda_without_cuda_fails_clearly(tmp_path, capsys, monkeypatch):
    import torch

    from genomics_rs_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fasta, cfg = _write_inputs(tmp_path, "ACGT", "ACGA", SCORES)
    assert cli.main(["-c", cfg, "align", "-f", fasta]) == 2
    assert "CUDA is not available" in capsys.readouterr().err


@pytest.mark.parametrize("is_local", [False, True])
def test_score_long_matches_jax(is_local):
    from genomics_rs_tpu.models.longalign import score_long as jax_score_long

    from genomics_rs_tpu_torch.models.longalign import score_long

    rng = np.random.default_rng(17)
    a, b = _pair(rng, 700, 600)
    got = score_long(
        Sequence("a", a), Sequence("b", b), Scores.from_tuple(SCORES),
        is_local=is_local, block_rows=255, device="cpu",
    )
    want = jax_score_long(
        JaxSequence("a", a), JaxSequence("b", b), JaxScores(*SCORES),
        is_local=is_local, block_rows=255, interpret=True,
    )
    assert tuple(got) == tuple(int(x) for x in want)


@pytest.mark.parametrize("is_local", [False, True])
def test_traceback_host_on_unpacked_dirs(is_local):
    """The host walker over per-cell codes (unpacked from the fill's
    packed bitmap) gives the same alignment as the device route."""
    import torch

    from genomics_rs_tpu_torch.models.aligner import _fill
    from genomics_rs_tpu_torch.ops.traceback import traceback_host
    from genomics_rs_tpu_torch.sequence import PAD_S1, PAD_S2

    rng = np.random.default_rng(23)
    a, b = _pair(rng, 90, 110)
    ts = Scores.from_tuple(SCORES)
    s1e = torch.from_numpy(Sequence("a", a).encoded(128, PAD_S1).copy())
    s2e = torch.from_numpy(Sequence("b", b).encoded(128, PAD_S2).copy())
    res = _fill(s1e, s2e, len(a), len(b), ts, is_local)
    words = res.dirs.numpy().astype(np.uint32)
    codes = ((words[:, None, :] >> (2 * np.arange(16, dtype=np.uint32))[None, :, None]) & 3)
    codes = codes.reshape(-1, words.shape[1]).astype(np.uint8)
    got = traceback_host(
        codes, res.start_i, res.start_j, res.score,
        Sequence("a", a), Sequence("b", b), is_local,
    )
    assert _fields(got) == _fields(_align(a, b, is_local, SCORES))


@pytest.mark.parametrize("is_local", [False, True])
def test_native_oracle_matches_port(is_local):
    from genomics_rs_tpu_torch import native

    rng = np.random.default_rng(29)
    a, b = _pair(rng, 180, 150)
    got = _align(a, b, is_local, SCORES)
    start = (got.alignment[0][1], got.alignment[0][2])
    assert native.gotoh_score_cpu(a, b, Scores.from_tuple(SCORES), is_local) == (
        (got.score,) + start
    )


def test_classify_moves_vectorized_matches_loop():
    """classify_moves' numpy path equals its per-move loop (the DEBUG
    trace path)."""
    import logging

    from genomics_rs_tpu_torch.ops.traceback import classify_moves

    rng = np.random.default_rng(91)
    tlog = logging.getLogger("genomics_rs_tpu_torch.ops.traceback")
    for trial in range(10):
        m, n = int(rng.integers(0, 40)), int(rng.integers(0, 40))
        s1 = Sequence("a", "".join(rng.choice(list("ACGT"), m)))
        s2 = Sequence("b", "".join(rng.choice(list("ACGT"), n)))
        codes = rng.integers(0, 3, int(rng.integers(0, m + n + 5))).astype(np.uint8)
        fast = classify_moves(codes, m, n, 7, s1, s2)
        old_level = tlog.level
        tlog.setLevel(logging.DEBUG)
        try:
            slow = classify_moves(codes, m, n, 7, s1, s2)
        finally:
            tlog.setLevel(old_level)
        assert _fields(fast) == _fields(slow), trial
