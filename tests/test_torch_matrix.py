"""The port's protein path on the CPU against the JAX package: the
substitution matrices (``ops/subst``), the query profile (K15's plain
version) and the matrix fill (K13's/K14's plain version), the aligners
(``PairwiseAligner(matrix=)``, ``matrix_align_batch``),
``allpairs_matrix_scores``, the C++ LUT oracle and the CLI's
``align --matrix`` and ``align-matrix --matrix`` bytes.

Inputs are made from seeds with numpy and handed to both packages. The
DP is integer, so every comparison is exact equality. The JAX TPU
kernels run in interpret mode (K13, K14 and K15 on one small batch
each); the scan engine is the JAX oracle elsewhere.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from genomics_rs_tpu.config import Scores as JaxScores
from genomics_rs_tpu.models import aligner as jax_aligner
from genomics_rs_tpu.ops import gotoh_matrix as jax_gm
from genomics_rs_tpu.ops import gotoh_matrix_stream as jax_gms
from genomics_rs_tpu.ops import subst as jax_subst
from genomics_rs_tpu.parallel import allpairs as jax_ap
from genomics_rs_tpu.sequence import Sequence as JaxSequence
from genomics_rs_tpu.sequence import SequenceContainer as JaxContainer
from genomics_rs_tpu_torch.config import Scores
from genomics_rs_tpu_torch.models import aligner as port_aligner
from genomics_rs_tpu_torch.models.aligner import PairwiseAligner, matrix_align_batch
from genomics_rs_tpu_torch.ops import gotoh_matrix as gm
from genomics_rs_tpu_torch.ops import gotoh_matrix_stream as gms
from genomics_rs_tpu_torch.ops import gotoh_stream as gs
from genomics_rs_tpu_torch.ops import subst
from genomics_rs_tpu_torch.parallel import allpairs as ap
from genomics_rs_tpu_torch.sequence import PAD_S1, PAD_S2, Sequence, SequenceContainer

PROT = "ARNDCQEGHILKMFPSTWYV"
#: NCBI BLASTP's BLOSUM62 gap defaults (existence 11, extension 1).
G, H = -1, -11


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The plain fills run thousands of small torch ops; one thread keeps
    them from contending with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _asym(rng) -> tuple[str, np.ndarray]:
    """An asymmetric 20-letter matrix without X (unknown bytes score at
    its minimum)."""
    m = rng.integers(-6, 9, (20, 20)).astype(np.int32)
    return PROT, m


def _near200(rng) -> tuple[str, np.ndarray]:
    """A matrix with entries near 200 (past the int8 stream's 127)."""
    m = rng.integers(-200, 201, (20, 20)).astype(np.int32)
    m[0, 0], m[1, 1] = 200, -199
    return PROT, m


MATRICES = {
    "blosum62": lambda rng: (jax_subst.blosum62().alphabet, jax_subst.blosum62().matrix),
    "asymmetric": _asym,
    "no_x": lambda rng: ("ACGT", np.array([[3, -2, -1, -2], [-2, 3, -2, -1],
                                           [-1, -2, 3, -2], [-2, -1, -2, 3]], np.int32)),
    "near200": _near200,
}


def _pair_of_matrices(kind: str, seed: int = 0):
    """The same matrix in both packages (the port's built from the JAX
    object's alphabet and array, like weights carried across)."""
    alphabet, m = MATRICES[kind](np.random.default_rng(seed))
    jm = jax_subst.SubstMatrix(alphabet, m, kind)
    return jm, subst.SubstMatrix(jm.alphabet, jm.matrix, jm.name)


def _prot_batch(rng, B, Lm, Ln, lo=5, alphabet=PROT):
    """Padded byte batches with true lengths in [lo, L] (model:
    tests/test_matrix_stream.py)."""
    s1 = np.frombuffer("".join(rng.choice(list(alphabet), B * Lm)).encode(), np.uint8)
    s2 = np.frombuffer("".join(rng.choice(list(alphabet), B * Ln)).encode(), np.uint8)
    ms = rng.integers(lo, Lm + 1, B).astype(np.int32)
    ns = rng.integers(lo, Ln + 1, B).astype(np.int32)
    return s1.reshape(B, Lm).copy(), s2.reshape(B, Ln).copy(), ms, ns


def _edge_batch(rng, alphabet=PROT):
    """Mixed lengths with zero-length sequences and unknown bytes
    (lowercase, U, O, padding bytes inside the true length)."""
    s1, s2, ms, ns = _prot_batch(rng, 7, 48, 40, lo=1, alphabet=alphabet)
    ms[0], ns[1], ms[2], ns[2] = 0, 0, 0, 0
    s1[3, :6] = np.frombuffer(b"acdUOx", np.uint8)
    s2[4, 2:5] = np.frombuffer(b"UO*", np.uint8)
    s2[5, :3] = PAD_S2
    return s1, s2, ms, ns


def _port_scores(s1, s2, ms, ns, pm, is_local, engine="auto"):
    out = gm.gotoh_scores_matrix(torch.from_numpy(s1), torch.from_numpy(s2), ms, ns, pm, G, H,
                                 is_local, engine=engine)
    return [x.numpy() for x in out]


def _jax_scan(s1, s2, ms, ns, jm, is_local):
    out = jax_gm.gotoh_scores_matrix(s1, s2, ms, ns, jm, G, H, is_local=is_local, engine="scan")
    return [np.asarray(x) for x in out]


def _equal(got, want):
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


# ---- ops/subst ----


@pytest.mark.parametrize("kind", ["blosum62", "classic", "kimura"])
def test_matrices_and_byte_lut_match_jax(kind):
    if kind == "blosum62":
        jm, pm = jax_subst.blosum62(), subst.blosum62()
    else:
        t = (2, -3, -2, -4) + ((-1,) if kind == "kimura" else ())
        jm, pm = jax_subst.dna_matrix(JaxScores(*t)), subst.dna_matrix(Scores.from_tuple(t))
    assert (pm.alphabet, pm.name, pm.max_abs) == (jm.alphabet, jm.name, jm.max_abs)
    np.testing.assert_array_equal(pm.matrix, jm.matrix)
    np.testing.assert_array_equal(pm.byte_lut(), jm.byte_lut())
    data = np.frombuffer(b"ARNDxyzACGTacgt*\xfe\xff", np.uint8)
    assert pm.unknown_fraction(data) == jm.unknown_fraction(data)
    assert pm.unknown_fraction(data[:0]) == jm.unknown_fraction(data[:0]) == 0.0


def test_get_matrix_and_carried_matrix_match_jax():
    assert subst.get_matrix("blosum62").alphabet == jax_subst.get_matrix("BLOSUM62").alphabet
    for kind in MATRICES:
        jm, pm = _pair_of_matrices(kind)
        np.testing.assert_array_equal(pm.byte_lut(), jm.byte_lut())
        np.testing.assert_array_equal(gm._alpha_code(pm), jax_gm._alpha_code(jm))
        np.testing.assert_array_equal(gm._ext_matrix(pm), jax_gm._ext_matrix(jm))
        got, want = gm._alpha_bytes(pm), jax_gm._alpha_bytes(jm)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]
    with pytest.raises(ValueError, match="duplicate"):
        subst.SubstMatrix("AA", np.zeros((2, 2)))


@pytest.mark.parametrize("symmetric", [True, False])
def test_load_matrix_file_matches_jax(tmp_path, symmetric):
    rng = np.random.default_rng(3)
    m = rng.integers(-5, 6, (5, 5))
    if symmetric:
        m = np.triu(m) + np.triu(m, 1).T
    path = tmp_path / "m.txt"
    body = "\n".join(f"{c} " + " ".join(str(v) for v in row) for c, row in zip("ACGTN", m))
    path.write_text(f"# a comment\n\n   A  C  G  T  N\n{body}\n")
    got, want = subst.get_matrix(str(path)), jax_subst.get_matrix(str(path))
    assert (got.alphabet, got.name) == (want.alphabet, want.name)
    np.testing.assert_array_equal(got.matrix, want.matrix)
    np.testing.assert_array_equal(got.byte_lut(), want.byte_lut())
    assert (got.matrix == got.matrix.T).all() == symmetric


@pytest.mark.parametrize("text", [
    "AB C\nA 1 2\n",
    "A C\nA 1 2\nC 1\n",
    "# nothing\n",
    "A C\nC 1 2\nA 3 4\n",
    "A C\nAC 1 2\n",
], ids=["header", "short_row", "empty", "row_order", "row_char"])
def test_load_matrix_file_errors_match_jax(tmp_path, text):
    path = tmp_path / "bad.txt"
    path.write_text(text)
    with pytest.raises(ValueError) as want:
        jax_subst.load_matrix_file(str(path))
    with pytest.raises(ValueError) as got:
        subst.load_matrix_file(str(path))
    assert str(got.value) == str(want.value)


def test_warn_unknown_bytes_matches_jax(caplog):
    data = np.frombuffer(b"ARND" * 10 + b"arnd", np.uint8)
    with caplog.at_level("WARNING"):
        frac = subst.warn_unknown_bytes(subst.blosum62(), data, where="t")
    assert frac == jax_subst.warn_unknown_bytes(jax_subst.blosum62(), data, where="t")
    assert "outside the BLOSUM62 alphabet" in caplog.text
    assert subst.warn_unknown_bytes(subst.blosum62(), data[:40]) == 0.0


# ---- the profile (K15's plain version) ----


@pytest.mark.parametrize("kind", list(MATRICES))
def test_profile_plain_matches_jax_lut_and_shear(kind):
    """At every true cell, ``prof[p, code(s1[i]), j]`` is JAX's
    ``byte_lut()[s1[i], s2[j]]`` and its ``_sheared_subs8`` plane read
    back from the shear (``sheared[i+j+2, p, i+1]``)."""
    jm, pm = _pair_of_matrices(kind)
    rng = np.random.default_rng(7)
    s1, s2, ms, ns = _edge_batch(rng, "ACGT" if kind == "no_x" else PROT)
    prof = gm.matrix_profile(torch.from_numpy(s2), ns, pm).numpy()
    A = gm._ext_matrix(pm).shape[0]
    assert prof.shape == (len(ms), A, s2.shape[1]) and prof.dtype == np.int16
    code1 = gm.row_codes(torch.from_numpy(s1), pm).numpy()
    lut = jm.byte_lut()
    if kind != "near200":  # _sheared_subs8 is int8
        ab, fallback, Ae = jax_gm._alpha_bytes(jm)
        sheared = np.asarray(jax_gm._sheared_subs8(
            jnp.asarray(s1), jnp.asarray(s2), jnp.asarray(ms), jnp.asarray(ns), jnp.asarray(ab),
            jnp.asarray(jax_gm._ext_matrix(jm)), Ae, fallback))
    for p in range(len(ms)):
        i, j = np.meshgrid(np.arange(ms[p]), np.arange(ns[p]), indexing="ij")
        got = prof[p, code1[p, i], j]
        np.testing.assert_array_equal(got, lut[s1[p, i], s2[p, j]])
        if kind != "near200":
            np.testing.assert_array_equal(got, sheared[i + j + 2, p, i + 1])
        assert (prof[p, :, ns[p]:] == 0).all()


# ---- the fill (K13's / K14's plain version) ----


@pytest.mark.parametrize("is_local", [False, True])
@pytest.mark.parametrize("kind", list(MATRICES))
def test_fill_plain_matches_jax_scan(kind, is_local):
    """Zero lengths, unknown and lowercase bytes, and B = 1."""
    jm, pm = _pair_of_matrices(kind)
    rng = np.random.default_rng(11)
    s1, s2, ms, ns = _edge_batch(rng, "ACGT" if kind == "no_x" else PROT)
    _equal(_port_scores(s1, s2, ms, ns, pm, is_local), _jax_scan(s1, s2, ms, ns, jm, is_local))
    _equal(_port_scores(s1[3:4], s2[3:4], ms[3:4], ns[3:4], pm, is_local),
           _jax_scan(s1[3:4], s2[3:4], ms[3:4], ns[3:4], jm, is_local))


@pytest.mark.parametrize("is_local", [False, True])
def test_fill_plain_matches_jax_k13_interpret(is_local):
    jm, pm = _pair_of_matrices("blosum62")
    s1, s2, ms, ns = _prot_batch(np.random.default_rng(12), 5, 40, 36, lo=1)
    want = jax_gm.gotoh_scores_matrix(s1, s2, ms, ns, jm, G, H, is_local=is_local,
                                      engine="pallas", interpret=True)
    _equal(_port_scores(s1, s2, ms, ns, pm, is_local, engine="pallas"), want)


@pytest.mark.parametrize("is_local", [False, True])
def test_fill_plain_matches_jax_k14_interpret(is_local):
    """K14 through JAX's stream entry, whose input K15 (the assembler)
    builds in interpret mode."""
    jm, pm = _pair_of_matrices("blosum62")
    s1, s2, ms, ns = _prot_batch(np.random.default_rng(13), 9, 60, 45)
    want = jax_gms.gotoh_scores_matrix_stream(s1, s2, ms, ns, jm, G, H, is_local=is_local,
                                              interpret=True, vtarget=512)
    got = gms.gotoh_scores_matrix_stream(torch.from_numpy(s1), torch.from_numpy(s2), ms, ns, pm,
                                         G, H, is_local)
    _equal([x.numpy() for x in got], want)


def test_stream_entries_return_none_where_jax_does():
    jm, pm = _pair_of_matrices("blosum62")
    jbig, pbig = _pair_of_matrices("near200")
    s1, s2, ms, ns = _prot_batch(np.random.default_rng(14), 3, 20, 20)
    zero = ns.copy()
    zero[1] = 0
    cases = [(s1, s2, ms, ns, jm, pm), (s1, s2, ms, zero, jm, pm), (s1, s2, ms, ns, jbig, pbig),
             (s1[:0], s2[:0], ms[:0], ns[:0], jm, pm)]
    t = torch.from_numpy
    for a, b, m, n, jmat, pmat in cases:
        for jfn, pfn in ((jax_gms.gotoh_scores_matrix_stream, gms.gotoh_scores_matrix_stream),
                         (jax_gms.gotoh_scores_matrix_stream_grouped,
                          gms.gotoh_scores_matrix_stream_grouped),
                         (jax_gms.gotoh_matrix_stream_fill_dirs,
                          gms.gotoh_matrix_stream_fill_dirs)):
            if jmat is jm and len(m) and (n > 0).all():
                continue  # the applicable case: computed elsewhere, not here
            assert jfn(a, b, m, n, jmat, G, H) is None
            assert pfn(t(a), t(b), m, n, pmat, G, H) is None


@pytest.mark.parametrize("is_local", [False, True])
def test_grouped_and_routes(monkeypatch, is_local):
    """``"auto"`` takes the pallas route below STREAM_MIN_B pairs and the
    stream route from it, grouped from STREAM_GROUPED_MIN_B; every route
    gives the same scores."""
    jm, pm = _pair_of_matrices("blosum62")
    s1, s2, ms, ns = _prot_batch(np.random.default_rng(15), 20, 40, 40)
    want = _jax_scan(s1, s2, ms, ns, jm, is_local)
    before = dict(gm.COUNTS)
    _equal(_port_scores(s1[:7], s2[:7], ms[:7], ns[:7], pm, is_local),
           [w[:7] for w in want])
    assert gm.COUNTS["pallas_plain"] - before["pallas_plain"] == 1
    _equal(_port_scores(s1, s2, ms, ns, pm, is_local), want)
    assert gm.COUNTS["stream_plain"] - before["stream_plain"] == 1
    monkeypatch.setattr(gm, "STREAM_GROUPED_MIN_B", 16)
    got = gms.gotoh_scores_matrix_stream_grouped(torch.from_numpy(s1), torch.from_numpy(s2), ms,
                                                 ns, pm, G, H, is_local, group_size=8)
    _equal([x.numpy() for x in got], want)
    assert gm.COUNTS["stream_plain"] - before["stream_plain"] == 4  # 1 + 3 groups
    _equal(_port_scores(s1, s2, ms, ns, pm, is_local, engine="stream"), want)  # grouped: 1
    assert gm.COUNTS["stream_plain"] - before["stream_plain"] == 5
    # one profile a call: the grouped calls' three groups fit one profile
    assert gm.COUNTS["profile_plain"] - before["profile_plain"] == 4
    assert gm.COUNTS["pallas_kernel"] == before["pallas_kernel"]


@pytest.mark.parametrize("kind", ["blosum62", "no_x", "asymmetric"])
def test_device_tables_are_made_once_per_values(kind):
    """The profile kernel's tables are kept per alphabet, matrix values and
    device: they equal ``_tables``' (the extra row and column of a matrix
    without X included), the byte table is ``ext[:, code]``, a second
    matrix object with the same values gets the same tensors, and a change
    of one value gets new ones."""
    _, pm = _pair_of_matrices(kind)
    code, ext, tab = gm.device_tables(pm, "cpu")
    want_code, want_ext = gm._tables(pm, "cpu")
    assert torch.equal(code, want_code) and torch.equal(ext, want_ext)
    assert ext.shape[0] == len(pm.alphabet) + ("X" not in pm.alphabet)
    assert tab.dtype == torch.int16 and torch.equal(tab, ext[:, code.long()].to(torch.int16))
    same = subst.SubstMatrix(pm.alphabet, pm.matrix.copy(), "a copy")
    assert all(a is b for a, b in zip(gm.device_tables(same, torch.device("cpu")),
                                      (code, ext, tab)))
    changed = pm.matrix.copy()
    changed[1, 0] += 1
    other = gm.device_tables(subst.SubstMatrix(pm.alphabet, changed), "cpu")
    assert torch.equal(other[1], gm._tables(subst.SubstMatrix(pm.alphabet, changed), "cpu")[1])
    assert not torch.equal(other[1], ext) and not torch.equal(other[2], tab)
    assert torch.equal(gm.device_tables(pm, "cpu")[1], want_ext)


@pytest.mark.parametrize("budget_groups", [None, 1])
@pytest.mark.parametrize("is_local", [False, True])
def test_grouped_batch_of_2048_pairs_matches_jax(monkeypatch, is_local, budget_groups):
    """A batch of STREAM_GROUPED_MIN_B pairs at small lengths goes through
    ``gotoh_scores_matrix``'s grouped route (two fill groups of 1,024) and
    equals the JAX package's scan engine: one profile for both groups
    under the default budget, one a group under a budget of one group."""
    jm, pm = _pair_of_matrices("blosum62")
    B = gm.STREAM_GROUPED_MIN_B
    assert B >= 2048
    s1, s2, ms, ns = _prot_batch(np.random.default_rng(2048 + is_local), B, 12, 10, lo=1)
    if budget_groups:
        monkeypatch.setattr(gms, "PROFILE_BUDGET_BYTES", 2 * 24 * 10 * 1024 * budget_groups)
    before = dict(gm.COUNTS)
    _equal(_port_scores(s1, s2, ms, ns, pm, is_local), _jax_scan(s1, s2, ms, ns, jm, is_local))
    assert gm.COUNTS["profile_plain"] - before["profile_plain"] == (2 if budget_groups else 1)
    assert gm.COUNTS["stream_plain"] - before["stream_plain"] == 2


def test_matrix_guards_match_jax():
    jbig, pbig = _pair_of_matrices("near200")
    s1, s2, ms, ns = _prot_batch(np.random.default_rng(16), 2, 20, 20)
    with pytest.raises(ValueError) as want:
        jax_gm.gotoh_scores_matrix(s1, s2, ms, ns, jbig, G, H, engine="pallas")
    with pytest.raises(ValueError) as got:
        _port_scores(s1, s2, ms, ns, pbig, False, engine="pallas")
    assert str(got.value) == str(want.value)
    huge = jax_subst.SubstMatrix("AC", np.array([[300, 0], [0, 1]]))
    with pytest.raises(ValueError) as want:
        jax_gm.gotoh_scores_matrix(s1, s2, ms, ns, huge, G, H)
    with pytest.raises(ValueError) as got:
        gm.gotoh_scores_matrix(s1, s2, ms, ns, subst.SubstMatrix("AC", huge.matrix), G, H,
                               device="cpu")
    assert str(got.value) == str(want.value)
    # Past the kernels' |v| <= 127 the scan engine runs, equal to JAX's.
    _equal(_port_scores(s1, s2, ms, ns, pbig, False, engine="scan"),
           _jax_scan(s1, s2, ms, ns, jbig, False))


@pytest.mark.parametrize("is_local", [False, True])
@pytest.mark.parametrize("score_t", [(2, -3, -2, -4), (2, -3, -2, -4, -1)],
                         ids=["classic", "kimura"])
def test_dna_matrix_bridge_equals_k3_plain(score_t, is_local):
    sc = Scores.from_tuple(score_t)
    rng = np.random.default_rng(17)
    s1, s2, ms, ns = _prot_batch(rng, 6, 64, 56, lo=0, alphabet="ACGT")
    t = torch.from_numpy
    want = gs.gotoh_stream_fill(t(s1), t(s2), ms, ns, sc, is_local, emit_dirs=True)
    got = gm.gotoh_matrix_fill(t(s1), t(s2), ms, ns, subst.dna_matrix(sc), sc.g, sc.h, is_local,
                               emit_dirs=True)
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g, w)
    for p in range(len(ms)):
        np.testing.assert_array_equal(_codes(got.dirs[p].numpy(), ms[p], ns[p]),
                                      _codes(want.dirs[p].numpy(), ms[p], ns[p]))


def _codes(words: np.ndarray, m: int, n: int, koff: int = 0, loff: int = 0) -> np.ndarray:
    """Codes at every true cell (i <= m, j <= n) of a diag16 bitmap, at
    word offset ``koff`` and lane offset ``loff``."""
    i = np.arange(m + 1)[:, None]
    k = i + np.arange(n + 1)[None, :]
    w = np.asarray(words)[koff + k // 16, loff + i].astype(np.int64) & 0xFFFFFFFF
    return (w >> (2 * (k % 16))) & 3


@pytest.mark.parametrize("is_local", [False, True])
def test_dirs_codes_match_jax_interpret(is_local):
    """The codes at every true cell of the port's per-pair bitmaps equal
    JAX's, read at its ``koff``/``loff`` (the contract, not the layout)."""
    jm, pm = _pair_of_matrices("blosum62")
    s1, s2, ms, ns = _prot_batch(np.random.default_rng(18), 3, 70, 60, lo=30)
    want = jax_gms.gotoh_matrix_stream_fill_dirs(s1, s2, ms, ns, jm, G, H, is_local=is_local,
                                                 interpret=True, vtarget=256)
    got = gms.gotoh_matrix_stream_fill_dirs(torch.from_numpy(s1), torch.from_numpy(s2), ms, ns,
                                            pm, G, H, is_local)
    np.testing.assert_array_equal(got.score, np.asarray(want.score))
    np.testing.assert_array_equal(got.start_i, want.start_i)
    np.testing.assert_array_equal(got.start_j, want.start_j)
    jd = np.asarray(want.dirs)
    for p in range(len(ms)):
        assert (got.koff(p), got.loff(p)) == (p * got.KW, 0)
        np.testing.assert_array_equal(
            _codes(got.segment_dirs(p).numpy(), ms[p], ns[p]),
            _codes(jd, ms[p], ns[p], want.koff(p), want.loff(p)))


# ---- the aligners ----


def _fields(r):
    return (r.score, [(c.value, i, j) for c, i, j in r.alignment],
            r.matches, r.mismatches, r.opening_gaps, r.gap_extensions)


def _prot_pairs(seed, n, lo=10, hi=80):
    rng = np.random.default_rng(seed)
    base = "".join(rng.choice(list(PROT), hi + 40))
    out = []
    for _ in range(n):
        a = base[int(rng.integers(0, 20)):][: int(rng.integers(lo, hi))]
        b = list(base[int(rng.integers(0, 20)):][: int(rng.integers(lo, hi))])
        for p in rng.integers(0, len(b), len(b) // 6):
            b[p] = str(rng.choice(list(PROT)))
        out.append((a, "".join(b)))
    return out


@pytest.mark.parametrize("is_local", [False, True])
def test_matrix_align_batch_matches_jax_interpret(is_local):
    """B < 16: JAX walks its K14 dirs with ``walk_many`` (interpret)."""
    jm, pm = _pair_of_matrices("blosum62")
    raw = _prot_pairs(20 + is_local, 6)
    got = matrix_align_batch([(Sequence("a", a), Sequence("b", b)) for a, b in raw], pm, G, H,
                             is_local=is_local, device="cpu")
    want = jax_aligner.matrix_align_batch(
        [(JaxSequence("a", a), JaxSequence("b", b)) for a, b in raw], jm, G, H,
        is_local=is_local, interpret=True)
    assert [_fields(r) for r in got] == [_fields(r) for r in want]


@pytest.mark.parametrize("is_local", [False, True])
def test_matrix_align_batch_and_aligner_match_jax_scan(is_local):
    """B >= 16, a zero-length pair (per-pair route) and the per-pair
    ``PairwiseAligner(matrix=)``, against the JAX scan aligner."""
    jm, pm = _pair_of_matrices("blosum62")
    raw = _prot_pairs(22 + is_local, 17) + [("", "ACD")]
    got = matrix_align_batch([(Sequence("a", a), Sequence("b", b)) for a, b in raw], pm, G, H,
                             is_local=is_local, device="cpu")
    oracle = jax_aligner.PairwiseAligner(JaxScores(0, 0, G, H), is_local=is_local,
                                         engine="scan", matrix=jm)
    port = PairwiseAligner(Scores(0, 0, G, H), is_local=is_local, device="cpu", matrix=pm)
    for (a, b), g in zip(raw, got):
        want = _fields(oracle.align(JaxSequence("a", a), JaxSequence("b", b)))
        assert _fields(g) == want
        if len(a) % 4 == 0:
            assert _fields(port.align(Sequence("a", a), Sequence("b", b))) == want
    a, b = raw[0]
    assert port.score_only(Sequence("a", a), Sequence("b", b)) == oracle.score_only(
        JaxSequence("a", a), JaxSequence("b", b))


def test_matrix_align_batch_groups_and_long_paths(monkeypatch):
    """Groups of two give the same alignments; a path past the walk
    buffer goes to the per-pair aligner (K2's route), as in JAX."""
    _, pm = _pair_of_matrices("blosum62")
    pairs = [(Sequence("a", a), Sequence("b", b)) for a, b in _prot_pairs(24, 5)]
    whole = [_fields(r) for r in matrix_align_batch(pairs, pm, G, H, device="cpu")]
    KW, V = gs.dirs_shape(128, 128)
    monkeypatch.setattr(port_aligner, "GROUP_BYTE_BUDGET", 2 * (KW * V * 4 + 1024 // 16 * 4))
    before = gm.COUNTS["stream_plain"]
    assert [_fields(r) for r in matrix_align_batch(pairs, pm, G, H, device="cpu")] == whole
    assert gm.COUNTS["stream_plain"] - before == 3
    monkeypatch.setattr(port_aligner, "MAX_STEPS_CAP", 200)
    before = gm.COUNTS["stream_plain"]
    assert [_fields(r) for r in matrix_align_batch(pairs, pm, G, H, device="cpu")] == whole
    assert gm.COUNTS["stream_plain"] - before == len(pairs)


def test_aligner_rejects_matrix_with_transition():
    with pytest.raises(ValueError, match="mutually exclusive"):
        PairwiseAligner(Scores(1, -1, -1, -2, 0), device="cpu", matrix=subst.blosum62())


# ---- scores across a corpus, the oracle ----


def _prot_corpus(seed, lengths):
    rng = np.random.default_rng(seed)
    base = "".join(rng.choice(list(PROT), max(lengths) + 60))
    out = []
    for k, L in enumerate(lengths):
        s = list(base[k * 5 : k * 5 + L])
        for p in rng.integers(0, L, L // 8):
            s[p] = str(rng.choice(list(PROT)))
        out.append((f"prot {k}|x", "".join(s)))
    return out


@pytest.mark.parametrize("is_local", [False, True])
def test_allpairs_matrix_scores_matches_jax(is_local):
    seqs = _prot_corpus(30, (60, 90, 130, 70, 150))
    jm, pm = _pair_of_matrices("blosum62")
    got = ap.allpairs_matrix_scores(SequenceContainer([Sequence(n, s) for n, s in seqs]), pm,
                                    G, H, is_local=is_local, device="cpu")
    want = jax_ap.allpairs_matrix_scores(JaxContainer([JaxSequence(n, s) for n, s in seqs]), jm,
                                         G, H, is_local=is_local)
    np.testing.assert_array_equal(got.matrix, want.matrix)
    assert (got.names, got.lengths, got.cells, got.padded_cells) == (
        want.names, want.lengths, want.cells, want.padded_cells)


@pytest.mark.parametrize("is_local", [False, True])
def test_native_subst_oracle_matches_port(is_local):
    from genomics_rs_tpu_torch import native

    _, pm = _pair_of_matrices("blosum62")
    a, b = _prot_pairs(31, 1, 150, 200)[0]
    s1 = Sequence("a", a).encoded(256, PAD_S1)[None]
    s2 = Sequence("b", b).encoded(256, PAD_S2)[None]
    got = _port_scores(s1, s2, np.array([len(a)]), np.array([len(b)]), pm, is_local)
    assert native.gotoh_score_cpu_subst(a, b, pm.byte_lut(), G, H, is_local) == tuple(
        int(x[0]) for x in got)


# ---- the CLI ----


def _write_config(tmp_path) -> str:
    cfg = tmp_path / "config.toml"
    cfg.write_text(f"[scores]\ns_match = 1\ns_mismatch = -2\ng = {G}\nh = {H}\n")
    return str(cfg)


def _after_banner(out: str) -> str:
    lines = out.split("\x1b[0m", 1)[1].splitlines()
    return "\n".join(ln for ln in lines if " DP cells in " not in ln)


@pytest.mark.parametrize("kind", ["global", "local"])
def test_cli_align_matrix_flag_matches_jax(tmp_path, capsys, monkeypatch, kind):
    """``align --matrix BLOSUM62``, small enough that the score tables
    print (they are scored under the matrix)."""
    from genomics_rs_tpu import cli as jax_cli
    from genomics_rs_tpu_torch import cli

    monkeypatch.setenv("GENOMICS_TPU_JAX_CACHE", str(tmp_path / "jaxcache"))
    a, b = _prot_pairs(40, 1, 30, 45)[0]
    fasta = tmp_path / "pair.fasta"
    fasta.write_text(f">p1\n{a}\n>p2\n{b}\n")
    argv = ["-c", _write_config(tmp_path), "align", "-a", kind, "-f", str(fasta),
            "--matrix", "BLOSUM62"]
    assert jax_cli.main(argv) == 0
    want = capsys.readouterr().out
    assert cli.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert "Sub Scores" in got and "Alignment Score" in got
    assert _after_banner(got) == _after_banner(want)


def _align_matrix_cli_runs(tmp_path, capsys, monkeypatch, kind, corpus):
    """``align-matrix --matrix BLOSUM62 --alignments-out`` over ``corpus``
    by both CLIs: for each, (stdout, the TSV's bytes, every pair's file)."""
    from genomics_rs_tpu import cli as jax_cli
    from genomics_rs_tpu_torch import cli

    monkeypatch.setenv("GENOMICS_TPU_JAX_CACHE", str(tmp_path / "jaxcache"))
    d = tmp_path / "fasta"
    d.mkdir()
    for k, (name, s) in enumerate(corpus):
        (d / f"p{k:02d}.fasta").write_text(f">{name}\n{s}\n")
    cfg = _write_config(tmp_path)
    runs = {}
    for name, mod, extra in (("jax", jax_cli, []), ("port", cli, ["--device", "cpu"])):
        out_dir = tmp_path / name
        argv = ["-c", cfg, "align-matrix", "-a", kind, "-f", str(d), "--matrix", "BLOSUM62",
                "-o", str(tmp_path / f"{name}.tsv"), "--alignments-out", str(out_dir)]
        assert mod.main(argv + extra) == 0
        stdout = capsys.readouterr().out.replace(str(out_dir), "OUT")
        files = {f: (out_dir / f).read_bytes() for f in sorted(os.listdir(out_dir))}
        runs[name] = (_after_banner(stdout), (tmp_path / f"{name}.tsv").read_bytes(), files)
    return runs


@pytest.mark.parametrize("kind", ["global", "local"])
def test_cli_align_matrix_mode_with_matrix_matches_jax(tmp_path, capsys, monkeypatch, kind):
    """``align-matrix --matrix BLOSUM62 --alignments-out``: stdout, the TSV
    and every pair's file."""
    runs = _align_matrix_cli_runs(tmp_path, capsys, monkeypatch, kind,
                                  _prot_corpus(41, (60, 140, 75, 90)))
    assert len(runs["port"][2]) == 6
    assert runs["port"] == runs["jax"]


@pytest.mark.parametrize("kind", ["global", "local"])
def test_cli_align_matrix_mode_batched_classifier_matches_jax(tmp_path, capsys, monkeypatch,
                                                               kind):
    """Seven proteins of 40-90 aa: one length bucket of 21 pairs, which the
    port classifies in one ``classify_moves_batch`` pass; the bytes still
    equal the JAX CLI's."""
    sizes = []
    real = port_aligner.classify_moves_batch
    monkeypatch.setattr(port_aligner, "classify_moves_batch",
                        lambda moves, *a: sizes.append(moves.shape[0]) or real(moves, *a))
    runs = _align_matrix_cli_runs(tmp_path, capsys, monkeypatch, kind,
                                  _prot_corpus(42, (40, 90, 55, 72, 64, 81, 47)))
    assert sizes == [21]
    assert len(runs["port"][2]) == 21
    assert runs["port"] == runs["jax"]
