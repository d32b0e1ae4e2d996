"""The generators, the cell counts, the bound model and the trace reader:
CPU, against brute force and hand-made traces."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import bound, cells, gen
from portbench.devtrace import REQUEST, Trace, short_name

CONFIGS = Path(__file__).resolve().parent / "configs"


def cov():
    return json.loads((CONFIGS / "cov-genomes.json").read_text())


def small_cov():
    c = cov()
    c["ancestor_bp"] = 2_000
    c["genomes"] = [{"bp": 1_800 + 60 * k, "identity": g["identity"]}
                    for k, g in enumerate(c["genomes"])]
    return c


def test_corpus_is_fixed_by_seed_and_its_sizes_by_the_configuration():
    c = small_cov()
    one = gen.genome_corpus(gen.rng(2**31 + 9, 1), c)
    assert one == gen.genome_corpus(gen.rng(2**31 + 9, 1), c)
    other = gen.genome_corpus(gen.rng(2**31 + 10, 1), c)
    assert one != other
    want = sorted(g["bp"] for g in c["genomes"])
    assert sorted(map(len, one)) == want == sorted(map(len, other))
    assert all(set(x) <= set(b"ACGT") for x in one)


def test_isolate_pair_sizes_and_identity():
    c = cov()
    ref, iso = gen.isolate_pair(gen.rng(5, 2), c)
    assert (ref, iso) == gen.isolate_pair(gen.rng(5, 2), c)
    i = c["isolate"]
    assert len(ref) == c["ancestor_bp"]
    assert len(iso) == c["ancestor_bp"] - sum(i["deletions"]) + sum(i["insertions"])
    comp = np.bincount(np.frombuffer(ref, np.uint8), minlength=256)[list(b"ACGT")] / len(ref)
    assert np.allclose(comp, gen.composition(c), atol=0.01)


def test_lognormal_lengths_are_deterministic_quantiles():
    L = gen.lognormal_lengths(142_500, 292, 361, 2, 35_213)
    assert np.array_equal(L, gen.lognormal_lengths(142_500, 292, 361, 2, 35_213))
    assert abs(np.median(L) - 292) <= 1 and abs(L.mean() - 361) < 2
    assert np.all(np.diff(L) >= 0) and L.min() >= 2 and L.max() <= 35_213


def test_residues_by_seed_and_frequency():
    freqs = json.loads((CONFIGS / "swissprot-blastp.json").read_text())["frequencies"]
    a = gen.residues(gen.torch_gen(7, 5, "cpu"), (400, 250), freqs, "cpu")
    assert torch.equal(a, gen.residues(gen.torch_gen(7, 5, "cpu"), (400, 250), freqs, "cpu"))
    assert not torch.equal(a, gen.residues(gen.torch_gen(8, 5, "cpu"), (400, 250), freqs, "cpu"))
    got = np.bincount(a.numpy().ravel(), minlength=256)
    for ch, pct in freqs.items():
        assert abs(got[ord(ch)] / a.numel() * 100 - pct) < 0.5
    assert got.sum() == got[[ord(c) for c in freqs]].sum()


@pytest.mark.parametrize("m,n,V", [(1, 1, 1024), (30, 30, 8), (50, 20, 8), (97, 41, 16),
                                   (2100, 1500, 1024)])
def test_band_cells_equal_brute_force(m, n, V):
    want = 0
    for i in range(1, m + 1):
        off = (i * n) // m - V // 2
        off = min(max(off, 0), max(0, n - V))
        want += sum(1 for j in range(1, n + 1) if off < j <= off + V)
    assert cells.banded(m, n, V) == want
    assert cells.full([m, 3], [n, 4]) == m * n + 12


def test_band_width_rounds_as_the_banded_model():
    assert [cells.band_width(b) for b in (1, 1024, 1025, 2048, 3000)] == [1024, 1024, 2048,
                                                                          2048, 3072]


def test_bound_model():
    rate = bound.int32_rate(132, 1980)
    assert rate == pytest.approx(1.6727e13, rel=1e-4)
    ops, nbytes = bound.fill(1e9, 2e4, 1, "global")
    assert (ops, nbytes) == (12e9, 2e4 + 12)
    ops, nbytes = bound.fill(1e9, 2e4, 1, "global", dirs=True)
    assert ops == 21e9 and nbytes == 2e4 + 12 + 2.5e8
    ops, nbytes = bound.fill(1e6, 100, 2, "local", matrix=True, profile_bytes=50)
    assert ops == 17e6 and nbytes == 400 + 50 + 24
    assert bound.profile(10, 24) == (0.0, 490.0)
    assert bound.band(100, 10) == (2100, 10 + 25 + 4)
    t, by = bound.bound_s(rate, 0, rate)
    assert t == pytest.approx(1.0) and by == "operations"
    t, by = bound.bound_s(0, 3.35e12, rate)
    assert t == pytest.approx(1.0) and by == "bytes"
    share, by = bound.share_pct(rate * 0.5, 0, 2.0, rate)
    assert share == pytest.approx(25.0) and by == "operations"
    assert bound.share_pct(1.0, 1.0, 0.0, rate) is None


def test_trace_reader():
    ms = 1_000_000
    host = [(0, 100 * ms, REQUEST), (100 * ms, 200 * ms, REQUEST),
            (10 * ms, 30 * ms, "aten::copy_"), (150 * ms, 190 * ms, "portbench/classify")]
    dev = [(5 * ms, 40 * ms, "void (anonymous namespace)::warp_pipe_kernel<FullRows, CharSub>"),
           (30 * ms, 60 * ms, "Memcpy DtoH"), (120 * ms, 140 * ms, "rowblock_kernel"),
           (190 * ms, 260 * ms, "rowblock_kernel")]
    t = Trace(dev, host)
    assert t.requests == 2 and t.window_s == pytest.approx(0.2)
    assert t.busy() == [(5 * ms, 60 * ms), (120 * ms, 140 * ms), (190 * ms, 200 * ms)]
    assert t.busy_s == pytest.approx(0.085)
    assert t.kernel_s(lambda n: "rowblock" in n) == pytest.approx(0.030)
    assert t.by_name()[0][0] == "warp_pipe_kernel<FullRows, CharSub>"
    assert short_name("void (anonymous namespace)::walk_kernel(unsigned int const*, int)") == \
        "walk_kernel"
    assert short_name("Memcpy DtoH (Device -> Pageable)") == "Memcpy DtoH (Device -> Pageable)"
    assert t.exposed() == [pytest.approx((0.1, 0.045)), pytest.approx((0.1, 0.07))]
    gaps = dict(t.idle_gaps())
    assert gaps["portbench/classify"] == pytest.approx(0.050)
    assert gaps[REQUEST] == pytest.approx(0.065)
    assert sum(gaps.values()) == pytest.approx(0.2 - 0.085)
