"""The scan engines (``ops/gotoh_scan`` and the ``engine="scan"`` paths
above it) against the JAX package's on the CPU, on seeded inputs: the
fill's dirs byte for byte with its score and start (global and local;
classic, kimura and a substitution table; with and without dirs), the
batched fill and ``batch_scores``, the ``"diag"`` walk, the matrix scan,
the sequence-parallel scan, ``PairwiseAligner``/``align_batch``,
``allpairs_scores``, ``center_star_msa`` and ``align_reads`` (one round
and the pipelined rounds). The DP is integer: equality throughout.
"""

import numpy as np
import pytest
import torch

from genomics_rs_tpu.config import Scores as JaxScores
from genomics_rs_tpu.models import reads as jax_reads
from genomics_rs_tpu.models.aligner import PairwiseAligner as JaxAligner
from genomics_rs_tpu.ops import gotoh_matrix as jax_gm
from genomics_rs_tpu.ops import subst as jax_subst
from genomics_rs_tpu.ops.gotoh_scan import gotoh_fill_scan as jax_fill
from genomics_rs_tpu.ops.traceback_batch import walk_batch as jax_walk
from genomics_rs_tpu.parallel import allpairs as jax_ap
from genomics_rs_tpu.parallel import longseq as jls
from genomics_rs_tpu.parallel.batch import batch_scores as jax_batch_scores
from genomics_rs_tpu.parallel.mesh import make_mesh as jax_make_mesh
from genomics_rs_tpu.sequence import Sequence as JaxSequence
from genomics_rs_tpu.sequence import SequenceContainer as JaxContainer
from genomics_rs_tpu_torch.config import Scores
from genomics_rs_tpu_torch.models import aligner, msa, reads
from genomics_rs_tpu_torch.ops import gotoh_matrix as gm
from genomics_rs_tpu_torch.ops import gotoh_pallas as gp
from genomics_rs_tpu_torch.ops import gotoh_rowblock as rb
from genomics_rs_tpu_torch.ops import gotoh_shortread as gsr
from genomics_rs_tpu_torch.ops import gotoh_stream as gs
from genomics_rs_tpu_torch.ops import subst
from genomics_rs_tpu_torch.ops import traceback_batch as tb
from genomics_rs_tpu_torch.ops.gotoh_scan import gotoh_fill_scan, gotoh_fill_scan_batch
from genomics_rs_tpu_torch.parallel import allpairs as ap
from genomics_rs_tpu_torch.parallel import batch
from genomics_rs_tpu_torch.parallel import longseq as ls
from genomics_rs_tpu_torch.parallel import mesh as pmesh
from genomics_rs_tpu_torch.sequence import PAD_S1, PAD_S2, Sequence, SequenceContainer
from tests.test_torch_reads import one_torch_thread  # noqa: F401

CLASSIC = (1, -2, -1, -5)
KIMURA = (2, -3, -2, -4, -1)
CPU = torch.device("cpu")


def _padded(rng, Lm, Ln, m, n, alphabet=b"ACGT"):
    """A pair padded to (Lm, Ln) with PAD_S1/PAD_S2 past (m, n)."""
    chars = np.frombuffer(alphabet, np.uint8)
    s1 = np.full(Lm, PAD_S1, np.uint8)
    s2 = np.full(Ln, PAD_S2, np.uint8)
    s1[:m] = rng.choice(chars, m)
    s2[:n] = rng.choice(chars, n)
    return s1, s2


def _related(rng, n: int) -> tuple[str, str]:
    """A sequence and a mutated, shifted copy (matches, mismatches, gaps)."""
    a = "".join(rng.choice(list("ACGT"), n))
    b = list(a[3:])
    for p in rng.integers(0, len(b), n // 10):
        b[p] = str(rng.choice(list("ACGT")))
    del b[n // 3 : n // 3 + 4]
    return a, "".join(b) + "GATTACA"


def _fields(r):
    return (r.score, [(c.value, i, j) for c, i, j in r.alignment], r.matches, r.mismatches,
            r.opening_gaps, r.gap_extensions)


# ---- gotoh_fill_scan ----

FILL_CASES = [(33, 40, 33, 40), (40, 24, 17, 24), (16, 48, 0, 31), (24, 24, 20, 0),
              (1, 9, 1, 9), (48, 32, 45, 29)]


@pytest.mark.parametrize("case", range(len(FILL_CASES)))
@pytest.mark.parametrize("score", ["classic", "kimura", "blosum62"])
@pytest.mark.parametrize("is_local", [False, True])
def test_fill_scan_matches_jax(case, score, is_local):
    """Dirs (every cell, padding included), score and start of one pair."""
    Lm, Ln, m, n = FILL_CASES[case]
    rng = np.random.default_rng(100 + case)
    alphabet = b"ARNDCQEGHILKMFPSTWYVxb" if score == "blosum62" else b"ACGTacgtN"
    s1, s2 = _padded(rng, Lm, Ln, m, n, alphabet)
    t = KIMURA if score == "kimura" else CLASSIC
    lut = subst.blosum62().byte_lut() if score == "blosum62" else None
    want = jax_fill(s1, s2, m, n, JaxScores(*t), is_local, subst_lut=lut)
    got = gotoh_fill_scan(torch.from_numpy(s1), torch.from_numpy(s2), m, n,
                          Scores.from_tuple(t), is_local, subst_lut=lut)
    assert got.dirs.dtype == torch.uint8 and got.dirs.shape == (Lm + Ln + 1, Lm + 1)
    assert np.array_equal(got.dirs.numpy(), np.asarray(want.dirs))
    assert [int(x) for x in got[1:]] == [int(x) for x in want[1:]]


@pytest.mark.parametrize("is_local", [False, True])
def test_fill_scan_without_dirs(is_local):
    rng = np.random.default_rng(7)
    s1, s2 = _padded(rng, 40, 56, 37, 50)
    want = jax_fill(s1, s2, 37, 50, JaxScores(*KIMURA), is_local, emit_dirs=False)
    got = gotoh_fill_scan(torch.from_numpy(s1), torch.from_numpy(s2), 37, 50,
                          Scores.from_tuple(KIMURA), is_local, emit_dirs=False)
    assert got.dirs.shape == np.asarray(want.dirs).shape == (0, 0)
    assert [int(x) for x in got[1:]] == [int(x) for x in want[1:]]


def test_fill_scan_rejects_lut_with_kimura():
    s = torch.zeros(4, dtype=torch.uint8)
    with pytest.raises(ValueError, match="mutually exclusive"):
        gotoh_fill_scan(s, s, 4, 4, Scores.from_tuple(KIMURA), False,
                        subst_lut=subst.blosum62().byte_lut())


def test_fill_scan_local_ties_keep_last():
    """A repeat gives many equal local maxima: the start is the last one
    in row-major order, as JAX's tracker keeps it."""
    s1 = np.frombuffer(b"ACGTACGTACGT", np.uint8).copy()
    s2 = np.frombuffer(b"ACGTTTACGTAA", np.uint8).copy()
    want = jax_fill(s1, s2, 12, 12, JaxScores(*CLASSIC), True)
    got = gotoh_fill_scan(torch.from_numpy(s1), torch.from_numpy(s2), 12, 12,
                          Scores.from_tuple(CLASSIC), True)
    assert [int(x) for x in got[1:]] == [int(x) for x in want[1:]]
    assert np.array_equal(got.dirs.numpy(), np.asarray(want.dirs))


def _batch(seed, B, Lm, Ln):
    rng = np.random.default_rng(seed)
    ms = rng.integers(0, Lm + 1, B).astype(np.int32)
    ns = rng.integers(0, Ln + 1, B).astype(np.int32)
    ms[0], ns[0] = Lm, Ln
    pairs = [_padded(rng, Lm, Ln, int(m), int(n)) for m, n in zip(ms, ns)]
    return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs]), ms, ns


@pytest.mark.parametrize("is_local", [False, True])
def test_fill_scan_batch_equals_one_pair_fills(is_local):
    """The batched carry gives each pair's own fill (JAX's ``vmap``)."""
    s1, s2, ms, ns = _batch(3, 5, 32, 40)
    sc = Scores.from_tuple(CLASSIC)
    got = gotoh_fill_scan_batch(torch.from_numpy(s1), torch.from_numpy(s2), ms, ns, sc,
                                is_local)
    for b in range(5):
        one = jax_fill(s1[b], s2[b], ms[b], ns[b], JaxScores(*CLASSIC), is_local)
        assert np.array_equal(got.dirs[b].numpy(), np.asarray(one.dirs))
        assert (int(got.score[b]), int(got.start_i[b]), int(got.start_j[b])) == (
            int(one.score), int(one.start_i), int(one.start_j))


@pytest.mark.parametrize("score_t", [CLASSIC, KIMURA], ids=["classic", "kimura"])
@pytest.mark.parametrize("is_local", [False, True])
def test_batch_scores_matches_jax(is_local, score_t):
    s1, s2, ms, ns = _batch(11, 6, 48, 64)
    want = jax_batch_scores(s1, s2, ms, ns, JaxScores(*score_t), is_local)
    got = batch.batch_scores(s1, s2, ms, ns, Scores.from_tuple(score_t), is_local)
    for g, w in zip(got[:3], want[:3]):
        assert np.array_equal(g, np.asarray(w))
    assert got.max_score == int(want.max_score)
    assert got.total_cells == np.float32(want.total_cells)
    # score_pairs' named "scan" engine is the same fill and reaches no kernel.
    before = gsr.COUNTS["plain"], gs.COUNTS["plain"]
    sp = batch.score_pairs(s1, s2, ms, ns, Scores.from_tuple(score_t), is_local,
                           engine="scan", device="cpu")
    assert all(np.array_equal(a, b) for a, b in zip(sp, got[:3]))
    assert (gsr.COUNTS["plain"], gs.COUNTS["plain"]) == before


@pytest.mark.parametrize("is_local", [False, True])
def test_walk_batch_diag_matches_jax(is_local):
    """The ``"diag"`` walk over the batched fill's dirs equals JAX's walk
    over its ``_fill_batch``: moves, counts, final cells, done."""
    s1, s2, ms, ns = _batch(19, 6, 40, 56)
    sc = Scores.from_tuple(KIMURA)
    fill = gotoh_fill_scan_batch(torch.from_numpy(s1), torch.from_numpy(s2), ms, ns, sc,
                                 is_local)
    jd, jsc, jsi, jsj = jax_reads._fill_batch(s1, s2, ms, ns, JaxScores(*KIMURA), is_local)
    assert np.array_equal(fill.dirs.numpy(), np.asarray(jd))
    before = dict(tb.COUNTS)
    got = tb.walk_batch(fill.dirs, fill.start_i, fill.start_j, sc, is_local, "diag", 97)
    want = jax_walk(jd, jsi, jsj, JaxScores(*KIMURA), is_local, "diag", 97)
    for g, w in zip(got, want):
        assert np.array_equal(g, np.asarray(w))
    assert tb.COUNTS["diag"] == before["diag"] + 1
    assert tb.COUNTS["plain"] == before["plain"] and all(got[4])
    # The launch half and its reader give the same walk.
    read = tb.walk_batch_launch(fill.dirs, fill.start_i, fill.start_j, sc, is_local, "diag", 97)
    assert all(np.array_equal(a, b) for a, b in zip(read(), got))


@pytest.mark.parametrize("is_local", [False, True])
def test_matrix_scan_matches_jax(is_local):
    """``gotoh_scores_matrix(engine="scan")`` under BLOSUM62 (with bytes
    outside its alphabet) and under a matrix past the kernels' |v| <= 127."""
    rng = np.random.default_rng(23 + is_local)
    aa = np.frombuffer(b"ARNDCQEGHILKMFPSTWYVbx", np.uint8)
    s1 = rng.choice(aa, (5, 40))
    s2 = rng.choice(aa, (5, 48))
    ms = np.array([40, 31, 1, 0, 17], np.int32)
    ns = np.array([48, 5, 40, 9, 0], np.int32)
    big = np.array([[150, -200, 3], [-200, 90, 0], [3, 0, 256]])
    for jm, pm in ((jax_subst.blosum62(), subst.blosum62()),
                   (jax_subst.SubstMatrix("ARN", big), subst.SubstMatrix("ARN", big))):
        want = jax_gm.gotoh_scores_matrix(s1, s2, ms, ns, jm, -1, -10, is_local, engine="scan")
        before = dict(gm.COUNTS)
        got = gm.gotoh_scores_matrix(torch.from_numpy(s1), torch.from_numpy(s2), ms, ns, pm,
                                     -1, -10, is_local, engine="scan")
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w))
        assert gm.COUNTS == before  # no kernel route, not even its plain version


@pytest.mark.parametrize("is_local", [False, True])
def test_longseq_scan_matches_jax(is_local):
    """``sharded_gotoh_score``/``batched_sharded_scores``/``align_sharded``
    on ``engine="scan"`` over a CPU mesh of 2 equal JAX's scan engine on
    two of its virtual devices, and never reach the tile kernel's route."""
    rng = np.random.default_rng(31 + is_local)
    a, b = _related(rng, 150)
    sc, jsc = Scores.from_tuple(CLASSIC), JaxScores(*CLASSIC)
    s1e = Sequence("a", a).encoded(pad_to=256, pad_value=PAD_S1)
    s2e = Sequence("b", b).encoded(pad_to=256, pad_value=PAD_S2)
    mesh = pmesh.make_mesh(2, pmesh.SEQ_AXIS, devices=[CPU] * 2)
    jmesh = jax_make_mesh(2, axis_name="seq")
    before = gp.TILE_COUNTS["plain"]
    got = ls.sharded_gotoh_score(mesh, s1e, s2e, len(a), len(b), sc, is_local, engine="scan")
    want = jls.sharded_gotoh_score(jmesh, s1e, s2e, np.int32(len(a)), np.int32(len(b)), jsc,
                                   is_local, engine="scan")
    assert (int(got.score), got.best.tolist()) == (int(want.score),
                                                   [int(x) for x in want.best])
    got_a = ls.align_sharded(mesh, Sequence("a", a), Sequence("b", b), sc, is_local,
                             engine="scan")
    want_a = jls.align_sharded(jmesh, JaxSequence("a", a), JaxSequence("b", b), jsc, is_local,
                               engine="scan", interpret=True)
    assert _fields(got_a) == _fields(want_a)
    assert gp.TILE_COUNTS["plain"] == before


@pytest.mark.parametrize("matrix", [False, True])
@pytest.mark.parametrize("is_local", [False, True])
def test_aligner_scan_matches_jax(is_local, matrix):
    """``PairwiseAligner(engine="scan")``: the scan fill and the host walk,
    no kernel; under BLOSUM62 the byte table's scan, as JAX's aligner."""
    rng = np.random.default_rng(41 + 2 * is_local + matrix)
    a, b = _related(rng, 90)
    pm = jm = None
    t = KIMURA
    if matrix:
        a, b = a.replace("T", "W"), b.replace("T", "W")
        pm, jm, t = subst.blosum62(), jax_subst.blosum62(), (0, 0, -1, -10)
    before = rb.COUNTS["plain"], gm.COUNTS["stream_plain"]
    got = aligner.PairwiseAligner(Scores.from_tuple(t), is_local, device="cpu", matrix=pm,
                                  engine="scan")
    want = JaxAligner(JaxScores(*t), is_local, engine="scan", matrix=jm)
    assert _fields(got.align(Sequence("a", a), Sequence("b", b))) == _fields(
        want.align(JaxSequence("a", a), JaxSequence("b", b)))
    assert got.score_only(Sequence("a", a), Sequence("b", b)) == want.score_only(
        JaxSequence("a", a), JaxSequence("b", b))
    assert (rb.COUNTS["plain"], gm.COUNTS["stream_plain"]) == before


def test_align_batch_scan_and_engines():
    rng = np.random.default_rng(47)
    pairs = [_related(rng, int(L)) for L in (60, 90, 75)]
    sc = Scores.from_tuple(CLASSIC)
    got = aligner.align_batch([(Sequence("a", a), Sequence("b", b)) for a, b in pairs], sc,
                              device="cpu", engine="scan")
    want = aligner.align_batch([(Sequence("a", a), Sequence("b", b)) for a, b in pairs], sc,
                               device="cpu")
    assert [_fields(r) for r in got] == [_fields(r) for r in want]
    with pytest.raises(ValueError, match="unknown engine"):
        aligner.PairwiseAligner(sc, device="cpu", engine="bogus")


@pytest.mark.parametrize("mesh_size", [None, 2])
def test_allpairs_scan_matches_jax(mesh_size, tmp_path):
    """``allpairs_scores(engine="scan")`` on one device and over a CPU mesh
    of 2 (``batch_scores_sharded`` on each bucket), and the resumable form,
    equal JAX's scan engine."""
    rng = np.random.default_rng(53)
    base = "".join(rng.choice(list("ACGT"), 200))
    seqs = [(f"s{k}", base[k * 9 : k * 9 + L]) for k, L in enumerate((50, 90, 130, 70))]
    c = SequenceContainer([Sequence(n, s) for n, s in seqs])
    mesh = None if mesh_size is None else pmesh.make_mesh(mesh_size, devices=[CPU] * mesh_size)
    got = ap.allpairs_scores(c, Scores.from_tuple(CLASSIC), True, engine="scan", device="cpu",
                             mesh=mesh)
    want = jax_ap.allpairs_scores(JaxContainer([JaxSequence(n, s) for n, s in seqs]),
                                  JaxScores(*CLASSIC), True, engine="scan")
    assert np.array_equal(got.matrix, want.matrix)
    res = ap.allpairs_scores_resumable(c, Scores.from_tuple(CLASSIC), str(tmp_path / "ck.jsonl"),
                                       True, engine="scan", chunk_pairs=3, device="cpu",
                                       mesh=mesh)
    assert np.array_equal(res.matrix, want.matrix)


def test_msa_scan_matches_jax():
    from genomics_rs_tpu.models import msa as jax_msa

    rng = np.random.default_rng(59)
    base = "".join(rng.choice(list("ACGT"), 120))
    seqs = [(f"m{k}", base[k : k + 100 - 5 * k]) for k in range(4)]
    got = msa.center_star_msa(SequenceContainer([Sequence(n, s) for n, s in seqs]),
                              Scores.from_tuple(CLASSIC), engine="scan", device="cpu")
    want = jax_msa.center_star_msa(JaxContainer([JaxSequence(n, s) for n, s in seqs]),
                                   JaxScores(*CLASSIC), engine="scan")
    assert (got.rows, got.center_index) == (want.rows, want.center_index)
    np.testing.assert_array_equal(got.score_matrix, want.score_matrix)


@pytest.mark.parametrize("both_strands", [False, True])
@pytest.mark.parametrize("is_local", [False, True])
def test_align_reads_scan_pipelined_matches_jax(is_local, both_strands):
    """``align_reads(engine="scan")`` with ``batch`` below the read count
    (several pipelined rounds) equals JAX's, and equals one round."""
    rng = np.random.default_rng(61 + is_local)
    qs, rs = [], []
    for k in range(21):
        r = "".join(rng.choice(list("ACGT"), int(rng.integers(30, 70))))
        q = list(r[int(rng.integers(0, 8)) :][:40])
        q[len(q) // 2] = "A"
        qs.append((f"q{k}", "".join(q)))
        rs.append((f"r{k}", r))
    kw = dict(is_local=is_local, with_cigars=True, both_strands=both_strands,
              with_mapinfo=True)
    calls = []
    real = reads._launch_part
    got = None
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(reads, "_launch_part", lambda s1b, *a: calls.append(len(s1b)) or real(s1b, *a))
        got = reads.align_reads([Sequence(*x) for x in qs], [Sequence(*x) for x in rs],
                                Scores.from_tuple(CLASSIC), batch=16, engine="scan",
                                device="cpu", **kw)
    assert len(calls) >= 2  # pipelined rounds
    one = reads.align_reads([Sequence(*x) for x in qs], [Sequence(*x) for x in rs],
                            Scores.from_tuple(CLASSIC), engine="scan", device="cpu", **kw)
    want = jax_reads.align_reads([JaxSequence(*x) for x in qs], [JaxSequence(*x) for x in rs],
                                 JaxScores(*CLASSIC), batch=16, engine="scan", **kw)
    for res in (got, one):
        assert [_fields(a) for a in res[0]] == [_fields(a) for a in want[0]]
        assert list(res[1:]) == list(want[1:])


def test_align_reads_pipeline_keeps_order_on_k6():
    """The K6 route through the pipeline: rounds of 4 give the one-round
    result, in input order."""
    rng = np.random.default_rng(67)
    refs = ["".join(rng.choice(list("ACGT"), 60)) for _ in range(11)]
    qs = [Sequence(f"q{k}", r[5:45]) for k, r in enumerate(refs)]
    rs = [Sequence(f"r{k}", r) for k, r in enumerate(refs)]
    sc = Scores.from_tuple(CLASSIC)
    a = reads.align_reads(qs, rs, sc, batch=4, device="cpu", with_cigars=True)
    b = reads.align_reads(qs, rs, sc, device="cpu", with_cigars=True)
    assert [_fields(x) for x in a[0]] == [_fields(x) for x in b[0]] and a[1] == b[1]
