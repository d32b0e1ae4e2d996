"""The port's batched move classifier (``ops/traceback.classify_moves_batch``)
on the CPU against the JAX package's and against the port's per-pair
``classify_moves``, its use in ``matrix_align_batch``, and the small
public helpers that carry the JAX package's names (``kimura_byte_lut``,
``native_available``, ``snake_deal``).

Batches are made from seeds with numpy and handed to both packages, as
``tests/test_longalign.py`` makes them for the JAX classifier: B 1-12,
T 1-70, counts 0..T, zero-length sequences, starts at the sequence ends.
Classification is integer work, so every comparison is exact equality.
"""

import logging

import numpy as np
import pytest

from genomics_rs_tpu.config import Scores as JaxScores
from genomics_rs_tpu.models import aligner as jax_aligner
from genomics_rs_tpu.ops import subst as jax_subst
from genomics_rs_tpu.ops import traceback as jax_tb
from genomics_rs_tpu.parallel import distributed as jax_dist
from genomics_rs_tpu.sequence import Sequence as JaxSequence
from genomics_rs_tpu.suffixtree import native as jax_native
from genomics_rs_tpu_torch.config import Scores
from genomics_rs_tpu_torch.models import aligner as port_aligner
from genomics_rs_tpu_torch.ops import subst
from genomics_rs_tpu_torch.ops import traceback as tb
from genomics_rs_tpu_torch.ops.traceback_batch import NO_MOVE
from genomics_rs_tpu_torch.parallel import distributed as dist_mod
from genomics_rs_tpu_torch.sequence import Sequence
from genomics_rs_tpu_torch.suffixtree import native as port_native

ALPHABETS = {"dna": "ACGT", "protein": "ARNDCQEGHILKMFPSTWYV"}
#: NCBI BLASTP's BLOSUM62 gap defaults (existence 11, extension 1).
G, H = -1, -11


def _fields(r):
    return (r.s1.name, r.s1.sequence, r.s2.name, r.s2.sequence, r.score,
            [(c.value, i, j) for c, i, j in r.alignment],
            r.matches, r.mismatches, r.opening_gaps, r.gap_extensions)


def _batch(seed, alphabet):
    """A seeded batch: (moves, counts, start_is, start_js, scores, raw
    pairs), rows padded past ``counts`` with ``NO_MOVE`` as the walks
    pad them."""
    rng = np.random.default_rng(seed)
    letters = list(ALPHABETS[alphabet])
    B, T = int(rng.integers(1, 13)), int(rng.integers(1, 71))
    raw, counts = [], np.zeros(B, np.int64)
    moves = np.full((B, T), NO_MOVE, np.uint8)
    si, sj = np.zeros(B, np.int64), np.zeros(B, np.int64)
    for b in range(B):
        m, n = int(rng.integers(0, 40)), int(rng.integers(0, 40))
        raw.append(("".join(rng.choice(letters, m)), "".join(rng.choice(letters, n))))
        c = int(rng.integers(0, T + 1))
        counts[b] = c
        moves[b, :c] = rng.integers(0, 3, c).astype(np.uint8)
        # Starts at the sequence ends, as a global walk starts; every
        # third row inside them, as a local walk may.
        si[b], sj[b] = (m, n) if b % 3 else (int(rng.integers(0, m + 1)),
                                             int(rng.integers(0, n + 1)))
    scores = rng.integers(-50, 50, B)
    return moves, counts, si, sj, scores, raw


def _both(moves, counts, si, sj, scores, raw):
    """The port's batched and per-pair results and JAX's batched one."""
    pairs = [(Sequence(f"a{b}", x), Sequence(f"b{b}", y)) for b, (x, y) in enumerate(raw)]
    jpairs = [(JaxSequence(f"a{b}", x), JaxSequence(f"b{b}", y)) for b, (x, y) in enumerate(raw)]
    got = tb.classify_moves_batch(moves, counts, si, sj, scores, pairs)
    per_pair = [tb.classify_moves(moves[b, : int(counts[b])], int(si[b]), int(sj[b]),
                                  int(scores[b]), x, y) for b, (x, y) in enumerate(pairs)]
    want = jax_tb.classify_moves_batch(moves, counts, si, sj, scores, jpairs)
    return got, per_pair, want


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("alphabet", list(ALPHABETS))
def test_classify_moves_batch_matches_jax_and_per_pair(alphabet, seed):
    got, per_pair, want = _both(*_batch(100 + seed, alphabet))
    assert len(got) == len(want)
    for b, (g, p, w) in enumerate(zip(got, per_pair, want)):
        assert _fields(g) == _fields(p) == _fields(w), b
        assert all(type(x) is int for _, i, j in g.alignment for x in (i, j))


@pytest.mark.parametrize("alphabet", list(ALPHABETS))
def test_classify_moves_batch_ignores_padding(alphabet):
    """Random bytes past ``counts`` (not only ``NO_MOVE``) change nothing."""
    batch = _batch(200, alphabet)
    clean = _both(*batch)
    moves, counts = batch[0].copy(), batch[1]
    past = np.arange(moves.shape[1])[None, :] >= counts[:, None]
    assert past.any()
    moves[past] = np.random.default_rng(201).integers(0, 256, int(past.sum()))
    noisy = _both(moves, *batch[1:])
    assert [_fields(r) for r in noisy[0]] == [_fields(r) for r in clean[0]]
    assert [_fields(r) for r in noisy[0]] == [_fields(r) for r in noisy[2]]


@pytest.mark.parametrize("alphabet", list(ALPHABETS))
def test_classify_moves_batch_debug_falls_back_per_pair(alphabet, monkeypatch, caplog):
    """Under DEBUG logging each pair goes through ``classify_moves`` (the
    per-move trace), as JAX's does; results stay equal."""
    batch = _batch(300, alphabet)
    want = [_fields(r) for r in _both(*batch)[0]]
    calls = []
    real = tb.classify_moves
    monkeypatch.setattr(tb, "classify_moves", lambda *a: calls.append(1) or real(*a))
    with caplog.at_level(logging.DEBUG, logger=tb.log.name):
        got, _, jax_got = _both(*batch)
    n_pairs = len(batch[-1])
    assert len(calls) == 2 * n_pairs  # the batched fallback, then the per-pair reference
    assert [_fields(r) for r in got] == want == [_fields(r) for r in jax_got]
    assert any(m.endswith("found at ({}, {})".format(*g.alignment[0][1:]))
               for g in got if g.alignment for m in caplog.messages)


@pytest.mark.parametrize("B", [0, 1, 4])
def test_classify_moves_batch_empty_paths(B, monkeypatch):
    """``T == 0`` classifies pair by pair: every alignment is empty."""
    raw = [("ACG"[: b], "TTAC"[: b + 1]) for b in range(B)]
    calls = []
    real = tb.classify_moves
    monkeypatch.setattr(tb, "classify_moves", lambda *a: calls.append(1) or real(*a))
    moves, counts = np.zeros((B, 0), np.uint8), np.zeros(B, np.int64)
    si = np.array([len(a) for a, _ in raw], np.int64)
    sj = np.array([len(b) for _, b in raw], np.int64)
    got, per_pair, want = _both(moves, counts, si, sj, np.arange(B) - 2, raw)
    assert len(calls) == 2 * B
    assert [_fields(r) for r in got] == [_fields(r) for r in per_pair] \
        == [_fields(r) for r in want]
    assert all(r.alignment == [] and r.matches == r.opening_gaps == 0 for r in got)


@pytest.mark.parametrize("bad", [3, 7, 254, NO_MOVE])
def test_classify_moves_batch_bad_code_raises_as_jax(bad):
    moves, counts, si, sj, scores, raw = _batch(400, "dna")
    b = int(np.flatnonzero(counts)[0])
    moves[b, int(counts[b]) - 1] = bad
    errors = []
    for fn, seq in ((tb.classify_moves_batch, Sequence), (jax_tb.classify_moves_batch,
                                                          JaxSequence)):
        with pytest.raises(ValueError) as e:
            fn(moves, counts, si, sj, scores, [(seq("a", x), seq("b", y)) for x, y in raw])
        errors.append(str(e.value))
    assert errors[0] == errors[1] == f"Unexpected move code {bad}"


def _prot_pairs(seed, n, lo=10, hi=60):
    rng = np.random.default_rng(seed)
    letters = list(ALPHABETS["protein"])
    base = "".join(rng.choice(letters, hi + 40))
    out = []
    for _ in range(n):
        a = base[int(rng.integers(0, 20)):][: int(rng.integers(lo, hi))]
        b = list(base[int(rng.integers(0, 20)):][: int(rng.integers(lo, hi))])
        for p in rng.integers(0, len(b), len(b) // 6):
            b[p] = str(rng.choice(letters))
        out.append((a, "".join(b)))
    return out


def _spy_classifiers(monkeypatch):
    """Record the batch size of every ``classify_moves_batch`` call the
    aligner makes, and count its per-pair ``classify_moves`` calls."""
    calls = {"batch": [], "pair": 0}
    real_batch, real_pair = tb.classify_moves_batch, tb.classify_moves

    def spy_batch(moves, *args):
        calls["batch"].append(moves.shape[0])
        return real_batch(moves, *args)

    def spy_pair(*args):
        calls["pair"] += 1
        return real_pair(*args)

    monkeypatch.setattr(port_aligner, "classify_moves_batch", spy_batch)
    monkeypatch.setattr(port_aligner, "classify_moves", spy_pair)
    return calls


@pytest.mark.parametrize("B", [1, 2, 15, 16, 17])
@pytest.mark.parametrize("is_local", [False, True])
def test_matrix_align_batch_classifier_by_group_size(monkeypatch, is_local, B):
    """A group of any size is classified in one batched pass, never pair
    by pair, and every pair equals the JAX scan aligner and per-pair
    ``classify_moves`` of the same walked moves."""
    jm = jax_subst.blosum62()
    pm = subst.SubstMatrix(jm.alphabet, jm.matrix, jm.name)
    raw = _prot_pairs(500 + B + 10 * is_local, B)
    calls = _spy_classifiers(monkeypatch)
    walked = []
    real_group = port_aligner._classify_group
    monkeypatch.setattr(port_aligner, "_classify_group",
                        lambda chunk, w, *a: walked.append((chunk, w)) or real_group(chunk, w, *a))
    got = port_aligner.matrix_align_batch(
        [(Sequence("a", a), Sequence("b", b)) for a, b in raw], pm, G, H,
        is_local=is_local, device="cpu")
    assert calls == {"batch": [B], "pair": 0}
    [(chunk, w)] = walked
    per_pair = [tb.classify_moves(w[0][t, : w[1][t]], int(w[6][t]), int(w[7][t]), int(w[5][t]),
                                  a, b) for t, (a, b) in enumerate(chunk)]
    assert [_fields(g) for g in got] == [_fields(p) for p in per_pair]
    oracle = jax_aligner.PairwiseAligner(JaxScores(0, 0, G, H), is_local=is_local,
                                         engine="scan", matrix=jm)
    for (a, b), g in zip(raw, got):
        assert _fields(g)[4:] == _fields(oracle.align(JaxSequence("a", a),
                                                      JaxSequence("b", b)))[4:]


@pytest.mark.parametrize("is_local", [False, True])
def test_align_batch_classifies_each_group_in_one_pass(monkeypatch, is_local):
    """DNA ``align_batch`` shares the group step: one batched pass a
    group, and every pair equals the JAX package's ``align_batch``."""
    rng = np.random.default_rng(600 + is_local)
    raw = [("".join(rng.choice(list("ACGT"), int(rng.integers(20, 70)))),
            "".join(rng.choice(list("ACGT"), int(rng.integers(20, 70))))) for _ in range(5)]
    calls = _spy_classifiers(monkeypatch)
    got = port_aligner.align_batch([(Sequence("a", a), Sequence("b", b)) for a, b in raw],
                                   Scores(), is_local=is_local, device="cpu")
    assert calls == {"batch": [5], "pair": 0}
    want = jax_aligner.align_batch([(JaxSequence("a", a), JaxSequence("b", b)) for a, b in raw],
                                   JaxScores(), is_local=is_local, engine="scan")
    assert [_fields(g) for g in got] == [_fields(w) for w in want]


@pytest.mark.parametrize("score_t", [(1, -2, -2, -5), (2, -3, -2, -4, -1), (5, -4, -1, -3, 1)],
                         ids=["classic", "kimura", "kimura_positive"])
def test_kimura_byte_lut_matches_jax(score_t):
    got = subst.kimura_byte_lut(Scores.from_tuple(score_t))
    want = jax_subst.kimura_byte_lut(JaxScores(*score_t))
    assert got.dtype == want.dtype == np.int32
    assert np.array_equal(got, want)


def test_native_available_matches_jax():
    assert port_native.native_available() is jax_native.native_available()


@pytest.mark.parametrize("n_shares", [1, 3, 8])
def test_snake_deal_matches_jax(n_shares):
    costs = np.random.default_rng(n_shares).integers(1, 1000, 40).tolist()
    assert dist_mod.snake_deal is dist_mod.balanced_deal
    assert dist_mod.snake_deal(costs, n_shares) == jax_dist.snake_deal(costs, n_shares)
