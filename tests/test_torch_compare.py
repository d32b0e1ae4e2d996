"""The port's ``compare`` on the CPU against the JAX package:
``recursive_lcs_similarity`` and ``compare_all_pairs`` on the native and
the Python engines against JAX's ``engine="python"`` recursion on its
Python tree, the similarity TSV and heatmap, and the CLI's ``compare``
bytes against the JAX CLI's. Exact equality throughout."""

import numpy as np
import pytest

import genomics_rs_tpu.suffixtree as jax_suffixtree
from genomics_rs_tpu.comparison import display as jax_display
from genomics_rs_tpu.comparison import driver as jax_driver
from genomics_rs_tpu.sequence import Sequence as JaxSequence
from genomics_rs_tpu.sequence import SequenceContainer as JaxContainer
from genomics_rs_tpu.suffixtree.tree import SuffixTree as JaxSuffixTree
from genomics_rs_tpu_torch.comparison import display, driver
from genomics_rs_tpu_torch.sequence import Sequence, SequenceContainer

#: JAX's recursion, kept before any test patches the module attribute.
_JAX_ORACLE = jax_driver.recursive_lcs_similarity


@pytest.fixture
def jax_python_tree(monkeypatch):
    """JAX's recursion on its Python tree: ``make_tree`` (which would build
    and load JAX's own native library) returns the oracle tree."""
    monkeypatch.setattr(jax_suffixtree, "make_tree",
                        lambda alphabet_file, n=16: JaxSuffixTree(alphabet_file, n))


@pytest.fixture
def alphabet(tmp_path) -> str:
    path = tmp_path / "dna.txt"
    path.write_text("ACGT\n")
    return str(path)


def _related(rng, base: str, snp: float, n_indels: int) -> str:
    s = list(base)
    for p in np.flatnonzero(rng.random(len(s)) < snp):
        s[p] = str(rng.choice(list("ACGT")))
    for _ in range(n_indels):
        p = int(rng.integers(0, len(s) - 10))
        if rng.random() < 0.5:
            del s[p : p + int(rng.integers(1, 8))]
        else:
            s[p:p] = list(rng.choice(list("ACGT"), int(rng.integers(1, 8))))
    return "".join(s)


def _pair(case: str) -> tuple[str, str]:
    rng = np.random.default_rng(50)
    base = "".join(rng.choice(list("ACGT"), 480))
    return {
        "related": (base, _related(rng, base, 0.03, 4)),
        "distant": (base, _related(rng, base, 0.25, 10)),
        "random": (base[:300], "".join(rng.choice(list("ACGT"), 350))),
        "self": (base, base),
        "empty": ("", base[:50]),
        "tiny": ("A", "CA"),
    }[case]


@pytest.mark.parametrize("engine", ["auto", "native", "python"])
@pytest.mark.parametrize("case", ["related", "distant", "random", "self", "empty", "tiny"])
def test_recursive_lcs_matches_jax(alphabet, jax_python_tree, case, engine):
    a, b = _pair(case)
    want = _JAX_ORACLE(a, b, alphabet, engine="python")
    assert driver.recursive_lcs_similarity(a, b, alphabet, engine=engine) == want
    if case == "self":
        assert want == (len(a), len(a))


def test_unknown_engine_and_character_raise(alphabet):
    with pytest.raises(ValueError, match="unknown engine"):
        driver.recursive_lcs_similarity("AC", "AC", alphabet, engine="tree")
    for engine in ("native", "python"):
        with pytest.raises(KeyError):
            driver.recursive_lcs_similarity("ACXT", "ACGT", alphabet, engine=engine)


def _corpus(seed: int = 51, n: int = 5) -> list[tuple[str, str]]:
    rng = np.random.default_rng(seed)
    base = "".join(rng.choice(list("ACGT"), 260))
    out = [(f"g{k} strain", _related(rng, base, 0.02 * k, k)) for k in range(n - 1)]
    return out + [("unrelated", "".join(rng.choice(list("ACGT"), 200)))]


@pytest.mark.parametrize("engine,threads", [("auto", 1), ("native", 3), ("python", 2)])
def test_compare_all_pairs_matches_jax(alphabet, jax_python_tree, monkeypatch, engine, threads):
    """The matrix (lower triangle, zeros above), names and lengths; JAX
    runs its per-pair Python recursion in one process."""
    from genomics_rs_tpu.suffixtree import native as jax_native

    monkeypatch.setattr(jax_native, "native_available", lambda: False)
    monkeypatch.setattr(jax_driver, "recursive_lcs_similarity",
                        lambda a, b, f, engine="auto": _JAX_ORACLE(a, b, f, engine="python"))
    seqs = _corpus()
    want = jax_driver.compare_all_pairs(JaxContainer([JaxSequence(n, s) for n, s in seqs]),
                                        alphabet, threads=1)
    got = driver.compare_all_pairs(SequenceContainer([Sequence(n, s) for n, s in seqs]),
                                   alphabet, threads=threads, engine=engine)
    assert got.matrix.dtype == want.matrix.dtype and np.array_equal(got.matrix, want.matrix)
    assert (got.names, got.lengths) == (want.names, want.lengths)
    assert np.all(got.matrix[np.triu_indices(len(seqs), 1)] == 0)
    assert got.matrix[1, 0, 0] > got.matrix[4, 0, 0]  # related beats unrelated


def test_tsv_and_heatmap_match_jax(tmp_path, alphabet, jax_python_tree):
    seqs = _corpus(52, 4)
    got = driver.compare_all_pairs(SequenceContainer([Sequence(n, s) for n, s in seqs]),
                                   alphabet, threads=2)
    want_matrix = np.zeros_like(got.matrix)
    for j in range(len(seqs)):
        for i in range(j + 1):
            score, first = _JAX_ORACLE(seqs[i][1], seqs[j][1], alphabet, engine="python")
            want_matrix[j, i] = (score, len(seqs[i][1]), len(seqs[j][1]), first)
    assert np.array_equal(got.matrix, want_matrix)
    want = jax_driver.CompareResult(names=got.names, lengths=got.lengths, matrix=want_matrix,
                                    elapsed_s=0.0)
    text = driver.write_similarity_tsv(got, str(tmp_path / "port.tsv"))
    assert text == jax_driver.write_similarity_tsv(want, str(tmp_path / "jax.tsv"))
    assert (tmp_path / "port.tsv").read_bytes() == (tmp_path / "jax.tsv").read_bytes()
    for color in (True, False):
        assert (display.format_similarity_matrix(got.matrix, color)
                == jax_display.format_similarity_matrix(want_matrix, color))
    assert display.VIRIDIS_COLORS == jax_display.VIRIDIS_COLORS


def test_load_fasta_dir_matches_jax(tmp_path):
    from genomics_rs_tpu.comparison.driver import load_fasta_dir as jax_load

    d = tmp_path / "fasta"
    d.mkdir()
    for k, (name, s) in enumerate(_corpus(53, 4)):
        (d / f"{3 - k}_g.fasta").write_text(f">{name}\n{s[:70]}\n{s[70:]}\n")
    (d / "notes.txt").write_text(">x\nACGT\n")
    got = [(s.name, s.sequence) for s in driver.load_fasta_dir(str(d)).sequences]
    assert got == [(s.name, s.sequence) for s in jax_load(str(d)).sequences]
    assert len(got) == 4


# ---- the CLI ----


@pytest.mark.parametrize("flags", [[], ["--suffix-links", "--threads", "3"]])
def test_cli_compare_matches_jax(tmp_path, capsys, monkeypatch, alphabet, flags):
    """stdout (heatmap with its ANSI codes, the similarity TSV and the
    LCS-length TSV) and ``similarity_matrix.tsv`` in the working
    directory, against the JAX CLI."""
    from genomics_rs_tpu import cli as jax_cli
    from genomics_rs_tpu_torch import cli

    monkeypatch.setenv("GENOMICS_TPU_JAX_CACHE", str(tmp_path / "jaxcache"))
    d = tmp_path / "fasta"
    d.mkdir()
    for k, (name, s) in enumerate(_corpus(54, 4)):
        (d / f"s{k}.fasta").write_text(f">{name}\n{s}\n")
    cfg = tmp_path / "config.toml"
    cfg.write_text("[scores]\ns_match = 1\ns_mismatch = -2\ng = -2\nh = -5\n")
    outs = {}
    for name, mod in (("jax", jax_cli), ("port", cli)):
        run = tmp_path / name
        run.mkdir()
        monkeypatch.chdir(run)
        argv = ["-c", str(cfg), "compare", "-a", alphabet, "-f", str(d), *flags]
        assert mod.main(argv) == 0
        outs[name] = (capsys.readouterr().out, (run / "similarity_matrix.tsv").read_bytes())
    assert outs["port"] == outs["jax"]
    assert "\x1b[38;2;" in outs["port"][0] and "LCS Length TSV:" in outs["port"][0]


def test_cli_compare_takes_no_device_flag(tmp_path, alphabet, capsys):
    from genomics_rs_tpu_torch import cli

    with pytest.raises(SystemExit):
        cli.main(["compare", "-a", alphabet, "-f", str(tmp_path), "--device", "cpu"])
    assert "unrecognized arguments: --device" in capsys.readouterr().err
