"""The port's banded path on ``device="cpu"`` against the JAX package:
``band_offset``; the plain fill (K10's and K12's plain version) against
JAX ``gotoh_banded(..., interpret=True)`` and ``gotoh_banded_batch``
(score, and codes at every true in-band cell); the plain walker (K11's)
against JAX's XLA walker and its Pallas walker in interpret mode;
``align_banded`` and ``banded_align_batch`` end to end; the CLI's ``align
--band`` bytes; and the planted-edit data maker of ``chip_smoke.py``
against the C++ full DP. Every result is an integer: equality throughout.
"""

import numpy as np
import pytest
import torch

from genomics_rs_tpu.config import Scores as JaxScores
from genomics_rs_tpu.models.banded import align_banded as jax_align_banded
from genomics_rs_tpu.ops import gotoh_banded as jgb
from genomics_rs_tpu.ops import gotoh_banded_batch as jgbb
from genomics_rs_tpu.sequence import Sequence as JaxSequence
from genomics_rs_tpu_torch.config import Scores
from genomics_rs_tpu_torch.models.aligner import PairwiseAligner
from genomics_rs_tpu_torch.models.banded import align_banded
from genomics_rs_tpu_torch.ops import gotoh_banded as gb
from genomics_rs_tpu_torch.ops import gotoh_banded_batch as gbb
from genomics_rs_tpu_torch.sequence import PAD_S1, PAD_S2, Sequence
from tests.test_torch_align import _after_banner, _fields, _write_inputs
from tests.test_torch_reads import one_torch_thread  # noqa: F401

CLASSIC = (1, -2, -1, -5)
KIMURA = (2, -3, -2, -4, -1)
BASES = np.frombuffer(b"ACGT", np.uint8)


def _similar(rng, m: int, n: int, subs: float = 0.04, indels: int = 6) -> tuple[str, str]:
    """A pair whose optimal path stays near the diagonal: s2 is a mutated
    copy of s1 cut to ``n``."""
    a = BASES[rng.integers(0, 4, m)]
    b = a.copy()
    hit = rng.random(m) < subs
    b[hit] = BASES[rng.integers(0, 4, int(hit.sum()))]
    for _ in range(indels):
        p, L = int(rng.integers(1, m - 10)), int(rng.integers(1, 4))
        b = np.delete(b, np.arange(p, p + L)) if rng.random() < 0.5 else np.insert(
            b, p, BASES[rng.integers(0, 4, L)])
    return a.tobytes().decode(), b[:n].tobytes().decode()


def _in_band_codes(dirs, m: int, n: int, V: int, geom=None) -> list[np.ndarray]:
    """The 2-bit code of every true in-band cell, row by row: 1 <= i <= m,
    max(1, off(i)+1) <= j <= min(n, off(i)+V)."""
    words = np.asarray(dirs).astype(np.int64)
    gM, gN = geom or (m, n)
    off = gb.band_offset(np.arange(1, m + 1), gM, gN, V)
    out = []
    for i in range(1, m + 1):
        o = int(off[i - 1])
        v = np.arange(max(1, o + 1), min(n, o + V) + 1) - o - 1
        out.append((words[(i - 1) // 16, v] >> (2 * ((i - 1) % 16))) & 3)
    return out


def _same_codes(a, b) -> bool:
    return len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("m,n,V", [(400, 380, 1024), (1_078_175, 1_077_003, 2048),
                                   (1_078_175, 900_000, 1024), (50, 50, 1024)])
def test_band_offset_matches_jax(m, n, V):
    rows = np.arange(0, m + 1, max(1, m // 4096), dtype=np.int64)
    got = gb.band_offset(rows, m, n, V)
    assert got.dtype == np.int64
    assert np.array_equal(got, jgb.band_offset(rows, m, n, V))


@pytest.mark.parametrize("score_t", [CLASSIC, KIMURA], ids=["classic", "kimura"])
@pytest.mark.parametrize("m,n", [(300, 260), (1400, 1390)], ids=["full", "narrow"])
def test_plain_fill_matches_jax_interpret(score_t, m, n):
    """Full cover (V >= n) and a narrow band (n > V) that slides."""
    rng = np.random.default_rng(m)
    a, b = _similar(rng, m, n)
    s1 = np.frombuffer(a.encode(), np.uint8)
    s2 = np.frombuffer(b.encode(), np.uint8)
    score, dirs = gb.gotoh_banded(torch.from_numpy(s1.copy()), torch.from_numpy(s2.copy()),
                                  m, len(b), Scores.from_tuple(score_t), 1024)
    jscore, jdirs = jgb.gotoh_banded(s1, s2, m, len(b), JaxScores(*score_t), 1024,
                                     interpret=True)
    assert score == int(jscore)
    assert dirs.shape == (-(-m // 16), 1024) and dirs.dtype == torch.int32
    assert _same_codes(_in_band_codes(dirs, m, len(b), 1024),
                       _in_band_codes(jdirs, m, len(b), 1024))


def test_plain_walker_matches_jax_walkers():
    """K11's plain version against JAX's XLA walker, and against its
    Pallas walker in interpret mode resumed from a 256-move buffer."""
    import jax.numpy as jnp

    from genomics_rs_tpu.ops.traceback_pallas import unpack_moves

    rng = np.random.default_rng(17)
    m, n, V = 1300, 1290, 1024
    a, b = _similar(rng, m, n)
    sc = Scores.from_tuple(CLASSIC)
    s1 = np.frombuffer(a.encode(), np.uint8).copy()
    s2 = np.frombuffer(b.encode(), np.uint8).copy()
    _, dirs = gb.gotoh_banded(torch.from_numpy(s1), torch.from_numpy(s2), m, n, sc, V)
    before = gb.COUNTS["walk_plain"]
    got = gb.walk_banded(dirs, m, n, V)
    assert gb.COUNTS["walk_plain"] == before + 1
    assert np.array_equal(got, np.asarray(jgb.walk_banded(dirs.numpy(), m, n, V)))

    _, deltas, _ = gb.plan_streams(m, n, V)
    KW = dirs.shape[0]
    D = max(-(-(KW * 16) // 128), 4)
    dl = np.zeros(D * 128, np.int32)
    dl[: deltas.size] = deltas
    chunks, i, j = [], m, n
    for _ in range(32):
        words, pos, i_f, j_f, done, oob = map(np.asarray, jgb._walk_banded_pallas(
            jnp.asarray(dirs.numpy()), jnp.asarray(dl.reshape(D, 128)), np.int32(i),
            np.int32(j), np.int32(gb.band_offset(i, m, n, V)), V=V, max_steps=1024,
            interpret=True))
        assert not bool(oob)
        chunks.append(unpack_moves(words, int(pos)))
        if bool(done):
            break
        i, j = int(i_f), int(j_f)
    assert len(chunks) > 1 and np.array_equal(got, np.concatenate(chunks))


def test_walker_flags_all_ins_bitmap():
    """Every code INS drives the lane below 0: corrupt data raises, it
    does not spin."""
    dirs = torch.full((18, 256), 0x55555555, dtype=torch.int32)
    assert gb.band_offset(280, 300, 290, 256) == 34  # lane 65 at (280, 100): 66 INS moves
    with pytest.raises(RuntimeError, match="left the band"):
        gb.walk_banded_plain(dirs, 280, 100, 256, (300, 290))
    with pytest.raises(RuntimeError, match="left the band"):
        gb.walk_banded(dirs, 280, 100, 256, geom=(300, 290))


def test_walk_outside_the_window_raises():
    """A walk must start inside the rows its window was planned for."""
    dirs = torch.zeros((2, 19, 256), dtype=torch.int32)
    with pytest.raises(ValueError, match="outside the window's rows 1..290"):
        gb.walk_banded_batch(dirs, [300, 280], [280, 270], 256, geom=(290, 285))


@pytest.mark.parametrize("score_t", [CLASSIC, KIMURA], ids=["classic", "kimura"])
def test_align_banded_matches_jax(score_t):
    rng = np.random.default_rng(23)
    a, b = _similar(rng, 1500, 1480, indels=8)
    got = align_banded(Sequence("s1", a), Sequence("s2", b), Scores.from_tuple(score_t),
                       band=1000, device="cpu")
    want = jax_align_banded(JaxSequence("s1", a), JaxSequence("s2", b), JaxScores(*score_t),
                            band=1000, interpret=True)
    assert _fields(got) == _fields(want)


@pytest.mark.parametrize("m,n", [(500, 430), (700, 700)])
def test_align_banded_full_cover_matches_aligner(m, n):
    """A band that covers every column is the full DP: the same alignment
    as the port's PairwiseAligner."""
    rng = np.random.default_rng(n)
    a, b = _similar(rng, m, n, subs=0.1)
    sc = Scores.from_tuple(CLASSIC)
    got = align_banded(Sequence("s1", a), Sequence("s2", b), sc, band=1024, device="cpu")
    want = PairwiseAligner(sc, device="cpu").align(Sequence("s1", a), Sequence("s2", b))
    assert _fields(got) == _fields(want)


def test_align_banded_rejects_longer_second_sequence():
    s1, s2 = Sequence("a", "ACGT" * 10), Sequence("b", "ACGT" * 20)
    with pytest.raises(ValueError, match="pass the longer sequence first"):
        align_banded(s1, s2, Scores(), device="cpu")
    with pytest.raises(ValueError, match="multiple of 1024"):
        gb.gotoh_banded(torch.zeros(40, dtype=torch.uint8), torch.zeros(40, dtype=torch.uint8),
                        40, 40, Scores(), 1000)


def test_cpu_route_runs_plain_versions():
    before = dict(gb.COUNTS)
    rng = np.random.default_rng(5)
    a, b = _similar(rng, 200, 190)
    align_banded(Sequence("a", a), Sequence("b", b), Scores(), device="cpu")
    assert gb.COUNTS["plain"] == before["plain"] + 1
    assert gb.COUNTS["walk_plain"] == before["walk_plain"] + 1
    assert (gb.COUNTS["kernel"], gb.COUNTS["walk_kernel"]) == (
        before["kernel"], before["walk_kernel"])


def _batch(rng, B, L, W, Lm, Ln):
    """B mutated copies of one genome of ~L bp, padded (B, Lm), (B, Ln)."""
    base = BASES[rng.integers(0, 4, L)]
    s1 = np.full((B, Lm), PAD_S1, np.uint8)
    s2 = np.full((B, Ln), PAD_S2, np.uint8)
    ms, ns = np.zeros(B, np.int64), np.zeros(B, np.int64)
    for k in range(B):
        a = base[: L - int(rng.integers(0, 12))]
        b = a.copy()
        hit = rng.random(b.size) < 0.05
        b[hit] = BASES[rng.integers(0, 4, int(hit.sum()))]
        b = np.delete(b, rng.integers(0, b.size - 10, 2))
        s1[k, : a.size], s2[k, : b.size] = a, b
        ms[k], ns[k] = a.size, b.size
    return s1, s2, ms, ns


@pytest.mark.parametrize("W", [128, 384])
def test_batch_matches_jax(W):
    """B = 11 over two groups of 8, kimura scoring: scores, codes at every
    true in-band cell of each pair (shared window) and the walked moves."""
    rng = np.random.default_rng(W)
    s1, s2, ms, ns = _batch(rng, 11, 330, W, 384, 384)
    sc, jsc = Scores.from_tuple(KIMURA), JaxScores(*KIMURA)
    groups = gbb.gotoh_banded_batch(torch.from_numpy(s1), torch.from_numpy(s2), ms, ns, sc, W)
    jgroups = jgbb.gotoh_banded_batch(s1, s2, ms, ns, jsc, W, interpret=True)
    assert [len(g.ms) for g in groups] == [8, 3] == [len(g.ms) for g in jgroups]
    got_all = gbb.banded_align_batch(torch.from_numpy(s1), torch.from_numpy(s2), ms, ns, sc, W)
    for gi, (g, jg) in enumerate(zip(groups, jgroups)):
        assert g.score.tolist() == np.asarray(jg.score)[: len(g.ms)].tolist()
        assert (g.M, g.N) == (jg.M, jg.N)
        for r in range(len(g.ms)):
            m, n = int(g.ms[r]), int(g.ns[r])
            assert _same_codes(_in_band_codes(g.pair_dirs(r), m, n, W, (g.M, g.N)),
                               _in_band_codes(jg.pair_dirs(r), m, n, W, (g.M, g.N)))
            want = jgb.walk_banded(jg.pair_dirs(r), m, n, W, geom=(jg.M, jg.N))
            score, moves = got_all[8 * gi + r]
            assert score == int(np.asarray(jg.score)[r])
            assert np.array_equal(moves, np.asarray(want))


def test_banded_align_batch_full_cover_matches_aligner():
    rng = np.random.default_rng(41)
    s1, s2, ms, ns = _batch(rng, 5, 250, 256, 256, 256)
    sc = Scores.from_tuple(CLASSIC)
    aligner = PairwiseAligner(sc, device="cpu")
    from genomics_rs_tpu_torch.ops.traceback import classify_moves

    for k, (score, moves) in enumerate(gbb.banded_align_batch(
            torch.from_numpy(s1), torch.from_numpy(s2), ms, ns, sc, 256)):
        a = Sequence("a", s1[k, : ms[k]].tobytes().decode())
        b = Sequence("b", s2[k, : ns[k]].tobytes().decode())
        got = classify_moves(moves, int(ms[k]), int(ns[k]), score, a, b)
        assert _fields(got) == _fields(aligner.align(a, b))


@pytest.mark.parametrize(
    "ms,ns,W,match",
    [([400, 400], [400, 40], 128, "outside the shared band"),
     ([400], [400], 100, "multiple of 128"),
     ([300], [400], 128, "swap pairs"),
     ([400, 0], [400, 30], 128, "nonempty pairs")],
)
def test_batch_rejects_what_jax_rejects(ms, ns, W, match):
    s1 = torch.full((len(ms), 512), 65, dtype=torch.uint8)
    s2 = torch.full((len(ms), 512), 65, dtype=torch.uint8)
    with pytest.raises(ValueError, match=match):
        gbb.gotoh_banded_batch(s1, s2, ms, ns, Scores(), W)


def test_planted_copy_scores_its_optimum():
    """chip_smoke.py's real-size inputs: the planted score is the full-DP
    optimum at 29,903 bp (the C++ oracle), and the planted pair's banded
    alignment scores it."""
    import chip_smoke
    from genomics_rs_tpu_torch import native

    rng = np.random.default_rng(2048)
    sc = Scores()
    genome = BASES[rng.integers(0, 4, 29_903)].tobytes().decode()
    copy, planted = chip_smoke.planted_copy(rng, genome, sc)
    assert len(copy) <= len(genome)
    assert native.gotoh_score_cpu(genome, copy, sc, False)[0] == planted


@pytest.mark.parametrize("band", ["1000", "2048"])
def test_cli_align_band_stdout_matches_jax(tmp_path, capsys, monkeypatch, band):
    from genomics_rs_tpu import cli as jax_cli
    from genomics_rs_tpu_torch import cli

    monkeypatch.setenv("GENOMICS_TPU_JAX_CACHE", str(tmp_path / "jaxcache"))
    rng = np.random.default_rng(int(band))
    a, b = _similar(rng, 1200, 1190)
    fasta, cfg = _write_inputs(tmp_path, a, b, CLASSIC)
    with open(fasta, "a") as f:
        f.write(">s3\nACGT\n")  # a third record: the warning, and only two used
    argv = ["-c", cfg, "align", "-a", "global", "--band", band, "-f", fasta]
    assert jax_cli.main(argv) == 0
    want = capsys.readouterr().out
    assert cli.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert "Alignment Score" in got
    assert _after_banner(got) == _after_banner(want)


def test_cli_band_is_global_only(tmp_path, capsys):
    from genomics_rs_tpu import cli as jax_cli
    from genomics_rs_tpu_torch import cli

    fasta, cfg = _write_inputs(tmp_path, "ACGTACGT", "ACGTCGT", CLASSIC)
    argv = ["-c", cfg, "align", "-a", "local", "--band", "8", "-f", fasta]
    assert jax_cli.main(argv) == 2
    want = capsys.readouterr().err
    assert cli.main(argv + ["--device", "cpu"]) == 2
    got = capsys.readouterr().err
    assert "--band is global-only" in got and got.strip().splitlines()[-1] == \
        want.strip().splitlines()[-1]


@pytest.mark.parametrize("M,N,V", [(6000, 5900, 1024), (1500, 900, 1024), (1300, 1300, 256),
                                   (33_100, 33_000, 32_768), (1_000_000, 999_000, 2048)])
def test_band_strip_columns_follow_off(M, N, V):
    """Each strip of the kernel's sweep (128 rows) visits the columns from
    its first row's off (the column left of that row's band) to its last
    row's band end, cut at n; every in-band cell of its rows lies inside,
    and the ring slot (the widest strip) holds at most V + 128 columns."""
    off, _, _ = gb.plan_streams(M, N, V)
    H = gb.BAND_STRIP_ROWS
    assert H == 128
    for m, n in ((M, N), (M - 700, N - 650)):
        lo, hi = gb.band_strip_columns(off, m, n, V)
        assert lo.size == hi.size == -(-m // H)
        for s in range(lo.size):
            rows = np.arange(s * H + 1, min(s * H + H, m) + 1)
            assert lo[s] == off[rows[0] - 1] and hi[s] == min(off[rows[-1] - 1] + V, n)
            band_lo, band_hi = off[rows - 1] + 1, np.minimum(off[rows - 1] + V, n)
            assert band_lo.min() > lo[s] and band_hi.max() <= hi[s]
            if s:  # a strip starts at or right of the one above, never left
                assert lo[s] >= lo[s - 1] and hi[s] >= hi[s - 1]
    w = gb.band_slot_width(off, [M, M - 700], [N, N - 650], V)
    assert w <= V + H and w == max(int((h - l).max()) + 1 for l, h in (
        gb.band_strip_columns(off, M, N, V), gb.band_strip_columns(off, M - 700, N - 650, V)))


def test_band_strips_in_flight_follow_the_slide():
    """A band that slides a column a row lets a few strips sweep at once
    (each waits for the one above to pass its first column); a band that
    stays at column 0 lets more (they start a lookahead apart)."""
    off, _, _ = gb.plan_streams(29_903, 29_892, 2048)
    assert list(gb.band_strips_in_flight(off, [29_903], [29_892], 2048)) == [14]
    off, _, _ = gb.plan_streams(1500, 900, 1024)
    assert list(gb.band_strips_in_flight(off, [1500, 1400], [900, 900], 1024)) == [17, 17]
