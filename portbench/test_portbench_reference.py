"""The plain reference against a brute-force Gotoh, cell by cell, and the
controls against the reference: CPU, tiny pairs."""

import numpy as np
import pytest
import torch

from portbench import reference as R

NEG = R.NEG_INF


def brute(a: bytes, b: bytes, table, g, h, local, band=None):
    """The recurrence cell by cell (the reference project's, as
    ``reference``'s docstring states it): (score, start, codes table)."""
    m, n = len(a), len(b)
    hg = h + g
    I = [[NEG] * (n + 1) for _ in range(m + 1)]
    S = [[NEG] * (n + 1) for _ in range(m + 1)]
    D = [[NEG] * (n + 1) for _ in range(m + 1)]
    I[0][0] = S[0][0] = D[0][0] = 0
    for j in range(1, n + 1):
        I[0][j] = h + j * g
    for i in range(1, m + 1):
        D[i][0] = h + i * g
    zl = 0 if local else -(1 << 40)

    def C(i, j):
        return max(I[i][j], S[i][j], D[i][j])

    def inb(i, j):
        if band is None or i == 0:
            return True
        off = int(R.band_offset(i, m, n, band))
        return (j == 0 and off == 0) or off < j <= off + band

    for i in range(1, m + 1):
        for j in range(1, n + 1):
            if not inb(i, j):
                continue
            I[i][j] = max(I[i][j - 1] + g, max(S[i][j - 1], D[i][j - 1]) + hg, zl)
            D[i][j] = max(max(I[i - 1][j], S[i - 1][j]) + hg, D[i - 1][j] + g, zl)
            S[i][j] = int(table[a[i - 1], b[j - 1]]) + max(C(i - 1, j - 1), zl)
        if not inb(i, 0):
            D[i][0] = NEG
    codes = np.full((m + 1, n + 1), R.STOP, np.uint8)
    best = (0, 0, n)
    for i in range(m + 1):
        for j in range(n + 1):
            c = max(C(i, j), 0) if local else C(i, j)
            for arm, code in ((S, R.SUB), (I, R.INS), (D, R.DEL)):
                if arm[i][j] == c:
                    codes[i, j] = code
                    break
            if local and (c, i, j) >= best:
                best = (c, i, j)
    if local:
        return best[0], (best[1], best[2]), codes
    return C(m, n), (m, n), codes


def rand_pairs(seed, count, lo, hi, letters=b"ACGT"):
    r = np.random.default_rng(seed)
    alpha = np.frombuffer(letters, np.uint8)
    out = []
    for _ in range(count):
        m, n = r.integers(lo, hi, 2)
        a = alpha[r.integers(0, alpha.size, m)]
        b = a[: n].copy() if r.random() < 0.5 else alpha[r.integers(0, alpha.size, n)]
        if b.size:
            b[r.integers(0, b.size, max(1, b.size // 6))] = alpha[r.integers(0, alpha.size)]
        out.append((a.tobytes(), b.tobytes() or b"A"))
    return out


@pytest.mark.parametrize("local", [False, True])
@pytest.mark.parametrize("kind", ["dna", "protein"])
def test_fill_and_paths_equal_brute_force(local, kind):
    if kind == "dna":
        table, g, h, pairs = R.dna_table(1, -2), -1, -5, rand_pairs(1, 12, 1, 18)
    else:
        table, g, h = R.blosum62_table(), -1, -11
        pairs = rand_pairs(2, 12, 1, 18, b"ARNDCQEGHILKMFPSTWYV")
    got = R.scores(pairs, table, g, h, local, batch=5)
    recs = R.align(pairs, table, g, h, local, batch=3)
    for k, (a, b) in enumerate(pairs):
        score, start, codes = brute(a, b, table, g, h, local)
        assert got["score"][k] == score and (got["start_i"][k], got["start_j"][k]) == start
        assert recs[k]["score"] == score and recs[k]["start"] == start
        path = R.walk(codes, *start, local)
        want = R.classify(path, *start, a, b)
        assert np.array_equal(recs[k]["choice"], want["choice"])
        assert np.array_equal(recs[k]["i"], want["i"]) and np.array_equal(recs[k]["j"], want["j"])


def test_band_equals_brute_force():
    r = np.random.default_rng(3)
    a = np.frombuffer(b"ACGT", np.uint8)[r.integers(0, 4, 60)]
    b = np.concatenate([a[:10], a[40:]])  # a 30-base deletion: the path leaves a narrow band
    pair = (a.tobytes(), b.tobytes())
    for band in (8, 16, 64):
        score, start, codes = brute(*pair, R.dna_table(1, -2), -1, -5, False, band=band)
        rec = R.align([pair], R.dna_table(1, -2), -1, -5, False, band=band)[0]
        assert rec["score"] == score
        want = R.classify(R.walk(codes, *start, False), *start, *pair)
        assert np.array_equal(rec["choice"], want["choice"])
    full = R.scores([pair], R.dna_table(1, -2), -1, -5, False)["score"][0]
    assert R.scores([pair], R.dna_table(1, -2), -1, -5, False, band=8)["score"][0] < full


def test_search_fill_ranks_as_the_program_orders():
    """Entries of several lengths padded as one class (s1, the rows) against
    one query (s2): each entry's local best, the last in row-major order."""
    pairs = rand_pairs(4, 10, 2, 20, b"ARNDCQEGHILKMFPSTWYV")
    query = pairs[0][1]
    tab = R.blosum62_table()
    s1, s2, ms, ns = R.pad_batch([(a, query) for a, _ in pairs], "cpu")
    got = R.fill(s1, s2, ms, ns, tab, -1, -11, True)
    for k, (a, _) in enumerate(pairs):
        score, start, _ = brute(a, query, tab, -1, -11, True)
        assert (got["score"][k], got["start_i"][k], got["start_j"][k]) == (score, *start)


def test_controls_break_their_guarantee():
    # Reversed tie order: a homopolymer deletion is placed at the other end.
    a, b = b"ACGTTTTGCA", b"ACGTTTGCA"
    tab = R.dna_table(1, -2)
    sid = R.align([(a, b)], tab, -1, -5)[0]
    dis = R.align([(a, b)], tab, -1, -5, tie="DIS")[0]
    assert sid["score"] == dis["score"] and not np.array_equal(sid["j"], dis["j"])
    # Keep-first: ties of the local best move the start.
    s1, s2, ms, ns = R.pad_batch([(b"AAAA", b"AAAA" + b"C" * 4 + b"AAAA")], "cpu")
    last = R.fill(s1, s2, ms, ns, tab, -1, -5, True)
    first = R.fill(s1, s2, ms, ns, tab, -1, -5, True, keep="first")
    assert last["score"][0] == first["score"][0]
    assert (last["start_i"][0], last["start_j"][0]) != (first["start_i"][0], first["start_j"][0])


def test_tables():
    t = R.blosum62_table()
    assert t[ord("W"), ord("W")] == 11 and t[ord("A"), ord("R")] == -1
    assert t[ord("x"), ord("A")] == t[ord("X"), ord("A")]
    d = R.dna_table(1, -2)
    assert d[65, 65] == 1 and d[65, 67] == -2
    assert torch.equal(torch.as_tensor(R.band_offset(np.arange(5), 4, 4, 2)),
                       torch.tensor([0, 0, 1, 2, 2]))
