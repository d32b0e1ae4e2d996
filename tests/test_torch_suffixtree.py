"""The port's suffix trees on the CPU against the JAX package's Python tree:
``load_alphabet``, ``compute_stats`` (every field, the BWT included) and
``get_lcs`` for the port's Python ``SuffixTree`` and its
``NativeSuffixTree``, with and without suffix links, on 1-4 strings,
duplicate strings and alphabet files with and without a trailing
newline; the tree display; the CLI's ``suffixtree`` bytes against the
JAX CLI's, below and above 64 bp. Exact equality throughout; alphabet
files are written under ``tmp_path``."""

import dataclasses

import numpy as np
import pytest

from genomics_rs_tpu.display import tree as jax_display
from genomics_rs_tpu.suffixtree import tree as jax_tree
from genomics_rs_tpu_torch.display import tree as display
from genomics_rs_tpu_torch.suffixtree import make_tree, tree
from genomics_rs_tpu_torch.suffixtree.native import NativeSuffixTree

#: alphabet files: the letters, with a trailing newline (a second '\n' in
#: the merged alphabet), and spaced out (spaces are stripped).
ALPHABETS = {"plain": "ACGT", "newline": "ACGT\n", "spaced": "A C G T\n"}


def _alphabet(tmp_path, kind: str = "newline") -> str:
    path = tmp_path / f"dna_{kind}.txt"
    path.write_text(ALPHABETS[kind])
    return str(path)


def _repeaty(rng, n: int) -> str:
    """Random DNA with copied segments, so the tree has deep repeats."""
    s = list(rng.choice(list("ACGT"), n))
    for _ in range(n // 40):
        L = int(rng.integers(4, 16))
        a, b = (int(x) for x in rng.integers(0, n - L, 2))
        s[b : b + L] = s[a : a + L]
    return "".join(s)


def _stats(t) -> dict:
    return dataclasses.asdict(t.compute_stats(0))


def _build(cls, alphabet, strings, links):
    t = cls(alphabet, sum(len(s) for s in strings))
    for s in strings:
        t.insert_string(s, links, False)
    return t


@pytest.mark.parametrize("kind", sorted(ALPHABETS))
def test_load_alphabet_matches_jax(tmp_path, kind):
    path = _alphabet(tmp_path, kind)
    got = tree.load_alphabet(path)
    assert got == jax_tree.load_alphabet(path)
    assert got == sorted(got) and " " in got  # the ' ' terminator stays
    assert got.count("\n") == (2 if ALPHABETS[kind].endswith("\n") else 1)
    assert set("ACGT") <= set(got) and len(got) == 32 + len(ALPHABETS[kind].replace(" ", ""))


CASES = {
    "one": (31, [180]),
    "two": (32, [150, 170]),
    "three": (33, [90, 120, 110]),
    "four": (34, [70, 80, 60, 90]),
    "short": (35, [1, 2]),
}


@pytest.mark.parametrize("links", [True, False], ids=["links", "nolinks"])
@pytest.mark.parametrize("kind", ["plain", "newline"])
@pytest.mark.parametrize("case", sorted(CASES) + ["duplicate", "duplicate_pair"])
def test_trees_match_jax(tmp_path, case, kind, links):
    """compute_stats and get_lcs of every string pair, three trees."""
    alphabet = _alphabet(tmp_path, kind)
    if case.startswith("duplicate"):
        rng = np.random.default_rng(36)
        a = _repeaty(rng, 120)
        strings = [a, a] if case == "duplicate" else [a, _repeaty(rng, 90), a]
    else:
        seed, lens = CASES[case]
        rng = np.random.default_rng(seed)
        strings = [_repeaty(rng, n) if n > 8 else "".join(rng.choice(list("ACGT"), n))
                   for n in lens]
    want = _build(jax_tree.SuffixTree, alphabet, strings, links)
    want_stats = _stats(want)
    pairs = [(i, j) for i in range(len(strings)) for j in range(len(strings)) if i != j]
    want_lcs = [want.get_lcs(i, j) for i, j in pairs]
    for cls in (tree.SuffixTree, NativeSuffixTree):
        got = _build(cls, alphabet, strings, links)
        assert _stats(got) == want_stats, cls.__name__
        assert [got.get_lcs(i, j) for i, j in pairs] == want_lcs, cls.__name__
    assert want_stats["num_leaves"] == len(strings[0]) + 1
    if len(strings) > 1 and min(map(len, strings)) > 8:
        assert max(lcs[2] for lcs in want_lcs) > 0


def test_make_tree_is_native(tmp_path):
    t = make_tree(_alphabet(tmp_path), 8)
    assert isinstance(t, NativeSuffixTree)


@pytest.mark.parametrize("cls", [tree.SuffixTree, NativeSuffixTree], ids=lambda c: c.__name__)
def test_tree_errors_match_jax(tmp_path, cls):
    """Unknown characters raise KeyError, terminator characters ValueError,
    a 33rd string ValueError, in the port's trees as in JAX's."""
    alphabet = _alphabet(tmp_path)
    with pytest.raises(KeyError):
        jax_tree.SuffixTree(alphabet).insert_string("ACGXT")
    with pytest.raises(KeyError):
        cls(alphabet).insert_string("ACGXT")
    for bad in ("AC$GT", "AC#G"):
        with pytest.raises(ValueError, match="terminator"):
            cls(alphabet).insert_string(bad)
    t = cls(alphabet)
    for _ in range(32):
        t.insert_string("ACG")
    with pytest.raises(ValueError, match="at most 32"):
        t.insert_string("ACG")


@pytest.mark.parametrize("links", [True, False], ids=["links", "nolinks"])
@pytest.mark.parametrize("text", ["ACA", "GATTACAGATTACA", "ACGTACGTTTGACGA" * 3])
def test_display_matches_jax(tmp_path, text, links):
    alphabet = _alphabet(tmp_path)
    got = tree.SuffixTree(alphabet, len(text))
    want = jax_tree.SuffixTree(alphabet, len(text))
    for t in (got, want):
        t.insert_string(text, links, False)
        t.compute_stats(0)
    assert display.write_graphviz(got) == jax_display.write_graphviz(want)
    assert display.format_string_depth(got) == jax_display.format_string_depth(want)
    assert display.format_tree_stats(got.stats) == jax_display.format_tree_stats(want.stats)
    for debug in (False, True):
        assert display.format_tree(got, debug) == jax_display.format_tree(want, debug)


def test_stats_display_truncates_long_bwt(tmp_path):
    text = _repeaty(np.random.default_rng(37), 400)
    got = make_tree(_alphabet(tmp_path), len(text))
    got.insert_string(text)
    got.compute_stats(0)
    want = jax_tree.SuffixTree(_alphabet(tmp_path), len(text))
    want.insert_string(text)
    want.compute_stats(0)
    out = display.format_tree_stats(got.stats)
    assert out == jax_display.format_tree_stats(want.stats)
    assert "... (truncated)" in out and f"BWT Length: {len(text) + 1}" in out


# ---- the CLI ----


def _config(tmp_path) -> str:
    cfg = tmp_path / "config.toml"
    cfg.write_text("[scores]\ns_match = 1\ns_mismatch = -2\ng = -2\nh = -5\n")
    return str(cfg)


@pytest.mark.parametrize("length,flags,debug", [
    (20, ["--stats", "--suffix-links"], False),
    (20, ["--stats"], True),
    (20, [], False),
    (40, ["--stats", "--suffix-links"], True),
    (500, ["--stats", "--suffix-links"], False),
    (500, ["--stats"], True),
])
def test_cli_suffixtree_matches_jax(tmp_path, capsys, monkeypatch, length, flags, debug):
    """stdout (below 64 bp the Python tree's display: Graphviz while the
    node table is under 100 slots, the string-depth dump under
    LOG_LEVEL=DEBUG; above, the stats block of the native tree) and
    ``BWT_out/<stem>_bwt.txt``, written to the working directory."""
    from genomics_rs_tpu import cli as jax_cli
    from genomics_rs_tpu_torch import cli

    monkeypatch.setenv("GENOMICS_TPU_JAX_CACHE", str(tmp_path / "jaxcache"))
    monkeypatch.setenv("LOG_LEVEL", "DEBUG" if debug else "INFO")
    fasta = tmp_path / "genome.fasta"
    fasta.write_text(f">g test\n{_repeaty(np.random.default_rng(38 + length), length)}\n")
    alphabet = _alphabet(tmp_path)
    outs = {}
    for name, mod in (("jax", jax_cli), ("port", cli)):
        run = tmp_path / name
        run.mkdir()
        monkeypatch.chdir(run)
        argv = ["-c", _config(tmp_path), "suffixtree", "-a", alphabet, "-f", str(fasta), *flags]
        assert mod.main(argv) == 0
        bwt = run / "BWT_out" / "genome_bwt.txt"
        outs[name] = (capsys.readouterr().out, bwt.read_bytes() if bwt.exists() else None)
    assert outs["port"] == outs["jax"]
    if "--stats" in flags:
        assert len(outs["port"][1]) == 2 * (length + 1)
        assert ("digraph {" in outs["port"][0]) == (length < 25)
        assert ("String Depth" in outs["port"][0]) == (debug and length < 64)
