"""The port's ``msa`` on the CPU against the JAX package:
``center_star_msa`` (DNA and ``matrix=``) rows, center and score matrix,
the row merge, the CLUSTAL and FASTA writers, and the CLI's ``msa`` and
``msa --matrix`` bytes. Exact equality throughout."""

import numpy as np
import pytest
import torch

from genomics_rs_tpu.config import Scores as JaxScores
from genomics_rs_tpu.models import msa as jax_msa
from genomics_rs_tpu.ops import subst as jax_subst
from genomics_rs_tpu.sequence import Sequence as JaxSequence
from genomics_rs_tpu.sequence import SequenceContainer as JaxContainer
from genomics_rs_tpu_torch.config import Scores
from genomics_rs_tpu_torch.models import aligner as port_aligner
from genomics_rs_tpu_torch.models import msa
from genomics_rs_tpu_torch.ops import gotoh_pallas as gp
from genomics_rs_tpu_torch.ops import gotoh_shortread as gsr
from genomics_rs_tpu_torch.ops import gotoh_stream as gs
from genomics_rs_tpu_torch.ops import subst
from genomics_rs_tpu_torch.sequence import Sequence, SequenceContainer

PROT = "ARNDCQEGHILKMFPSTWYV"
DNA_SCORES = (2, -3, -2, -4)
PROT_SCORES = (0, 0, -1, -11)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The plain fills run thousands of small torch ops; one thread keeps
    them from contending with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _family(seed: int, alphabet: str, n: int, length: int) -> list[tuple[str, str]]:
    """Mutated copies of one base: substitutions and a few indels."""
    rng = np.random.default_rng(seed)
    base = "".join(rng.choice(list(alphabet), length))
    out = []
    for k in range(n):
        s = list(base)
        for p in rng.integers(0, len(s), length // 10):
            s[p] = str(rng.choice(list(alphabet)))
        for _ in range(int(rng.integers(0, 3))):
            p = int(rng.integers(0, len(s) - 8))
            if rng.random() < 0.5:
                del s[p : p + int(rng.integers(1, 6))]
            else:
                s[p:p] = list(rng.choice(list(alphabet), int(rng.integers(1, 6))))
        out.append((f"seq{k} fam", "".join(s)))
    return out


def _both(seqs):
    return (SequenceContainer([Sequence(n, s) for n, s in seqs]),
            JaxContainer([JaxSequence(n, s) for n, s in seqs]))


@pytest.mark.parametrize("protein", [False, True], ids=["dna", "protein"])
def test_center_star_msa_matches_jax(protein):
    if protein:
        seqs, t = _family(50, PROT, 5, 80), PROT_SCORES
        pm, jm = subst.blosum62(), jax_subst.blosum62()
    else:
        seqs, t = _family(51, "ACGT", 5, 150), DNA_SCORES
        pm = jm = None
    pc, jc = _both(seqs)
    got = msa.center_star_msa(pc, Scores.from_tuple(t), matrix=pm, device="cpu")
    want = jax_msa.center_star_msa(jc, JaxScores(*t), matrix=jm)
    assert (got.names, got.rows, got.center_index) == (want.names, want.rows, want.center_index)
    np.testing.assert_array_equal(got.score_matrix, want.score_matrix)
    assert got.conservation() == want.conservation() and got.width == want.width
    for row, (_, s) in zip(got.rows, seqs):
        assert row.replace("-", "") == s


def test_star_routes_and_groups_agree(monkeypatch):
    """Groups of two, and the per-pair aligner past the star budget, give
    the batched route's rows."""
    seqs = _family(52, "ACGT", 5, 120)
    pc, _ = _both(seqs)
    sc = Scores.from_tuple(DNA_SCORES)
    whole = msa.center_star_msa(pc, sc, device="cpu").rows
    KW, V = gs.dirs_shape(128, 128)
    monkeypatch.setattr(port_aligner, "GROUP_BYTE_BUDGET", 2 * (KW * V * 4 + 8192 // 16 * 4))
    before = gs.COUNTS["plain"], gsr.COUNTS["plain"], gp.COUNTS["plain"]
    assert msa.center_star_msa(pc, sc, engine="pallas", device="cpu").rows == whole
    # The score pass on the pallas engine (one bucket: K9), as JAX passes
    # the engine through; then two star groups (K3).
    assert (gs.COUNTS["plain"] - before[0], gsr.COUNTS["plain"] - before[1],
            gp.COUNTS["plain"] - before[2]) == (2, 0, 1)
    monkeypatch.setattr(msa, "STAR_PAIR_DIRS_BUDGET", 0)
    assert msa.center_star_msa(pc, sc, device="cpu").rows == whole
    # The scan engine: the scan score pass and the per-pair scan aligner.
    assert msa.center_star_msa(pc, sc, engine="scan", device="cpu").rows == whole
    one = msa.center_star_msa(SequenceContainer([Sequence("x", "ACGT")]), sc, device="cpu")
    assert (one.rows, one.center_index) == (["ACGT"], 0)


def test_build_rows_equals_merge_center_and_jax():
    rng = np.random.default_rng(53)
    center = "".join(rng.choice(list("ACGT"), 40))
    others, ops_list = [], []
    for _ in range(4):
        ops = list("M" * 40)
        for _ in range(5):
            p = int(rng.integers(0, len(ops) + 1))
            ops.insert(p, str(rng.choice(["I", "D"])))
        ops = "".join(ops)
        # A 'D' consumes a center char: keep exactly 40 of M/D.
        while sum(o in "MD" for o in ops) > 40:
            ops = ops.replace("M", "", 1)
        while sum(o in "MD" for o in ops) < 40:
            ops += "M"
        other = "".join(rng.choice(list("ACGT"), sum(o in "MI" for o in ops)))
        others.append(other)
        ops_list.append(ops)
    master, rows = msa._build_rows(center, others, ops_list)
    assert (master, rows) == jax_msa._build_rows(center, others, ops_list)
    seq_master, seq_rows = None, []
    for other, ops in zip(others, ops_list):
        c, o = msa._gapped_pair(center, other, ops)
        if seq_master is None:
            seq_master, seq_rows = c, [o]
        else:
            seq_master, seq_rows, new = msa._merge_center(seq_master, seq_rows, c, o)
            seq_rows.append(new)
    assert (master, rows) == (seq_master, seq_rows)
    assert msa._merge_center("A-C", ["T-G"], "AC-", "GGA") == jax_msa._merge_center(
        "A-C", ["T-G"], "AC-", "GGA")


def test_writers_match_jax(tmp_path):
    names = ["a" * 35, "short", "mid name"]
    rows = ["ACGT-" * 30, "ACG-A" * 30, "ACGTA" * 30]
    res = msa.MSAResult(names, rows, 1, np.zeros((3, 3), np.int64))
    jres = jax_msa.MSAResult(names, rows, 1, np.zeros((3, 3), np.int64))
    assert msa.format_msa_clustal(res) == jax_msa.format_msa_clustal(jres)
    assert msa.format_msa_clustal(res, width=50) == jax_msa.format_msa_clustal(jres, width=50)
    msa.write_msa_fasta(res, str(tmp_path / "a.fa"))
    jax_msa.write_msa_fasta(jres, str(tmp_path / "b.fa"))
    assert (tmp_path / "a.fa").read_bytes() == (tmp_path / "b.fa").read_bytes()


def _config(tmp_path, t) -> str:
    cfg = tmp_path / "config.toml"
    cfg.write_text(f"[scores]\ns_match = {t[0]}\ns_mismatch = {t[1]}\ng = {t[2]}\nh = {t[3]}\n")
    return str(cfg)


def _after_banner(out: str) -> str:
    return out.split("\x1b[0m", 1)[1]


@pytest.mark.parametrize("protein,fmt", [(False, "clustal"), (False, "fasta"),
                                         (True, "clustal"), (True, "fasta")])
def test_cli_msa_matches_jax(tmp_path, capsys, monkeypatch, protein, fmt):
    """``msa`` (a directory and a file) and ``msa --matrix BLOSUM62``:
    stdout and the ``-o`` file in both formats."""
    from genomics_rs_tpu import cli as jax_cli
    from genomics_rs_tpu_torch import cli

    monkeypatch.setenv("GENOMICS_TPU_JAX_CACHE", str(tmp_path / "jaxcache"))
    seqs = _family(54 + protein, PROT if protein else "ACGT", 5, 70 if protein else 110)
    d = tmp_path / "fasta"
    d.mkdir()
    for k, (name, s) in enumerate(seqs[:3]):
        (d / f"s{k}.fasta").write_text(f">{name}\n{s}\n")
    extra_file = tmp_path / "more.fasta"
    extra_file.write_text("".join(f">{n}\n{s}\n" for n, s in seqs[3:]))
    t = PROT_SCORES if protein else DNA_SCORES
    outs = {}
    for name, mod, extra in (("jax", jax_cli, []), ("port", cli, ["--device", "cpu"])):
        out = tmp_path / f"{name}.{fmt}"
        argv = ["-c", _config(tmp_path, t), "msa", "-f", str(d), str(extra_file),
                "--format", fmt, "-o", str(out)]
        if protein:
            argv += ["--matrix", "BLOSUM62"]
        assert mod.main(argv + extra) == 0
        stdout = capsys.readouterr().out.replace(str(out), "OUT")
        outs[name] = (_after_banner(stdout), out.read_bytes())
    assert "multiple sequence alignment" in outs["port"][0]
    assert outs["port"] == outs["jax"]


def test_cli_msa_fails_clearly(tmp_path, capsys, monkeypatch):
    """``msa --engine scan`` prints the JAX CLI's bytes; one sequence
    exits 1."""
    from genomics_rs_tpu import cli as jax_cli
    from genomics_rs_tpu_torch import cli

    monkeypatch.setenv("GENOMICS_TPU_JAX_CACHE", str(tmp_path / "jaxcache"))
    fasta = tmp_path / "x.fasta"
    fasta.write_text("".join(f">{n}\n{s}\n" for n, s in _family(57, "ACGT", 4, 90)))
    cfg = _config(tmp_path, DNA_SCORES)
    argv = ["-c", cfg, "msa", "-f", str(fasta), "--engine", "scan"]
    assert jax_cli.main(argv) == 0
    want = _after_banner(capsys.readouterr().out)
    assert cli.main(argv + ["--device", "cpu"]) == 0
    assert _after_banner(capsys.readouterr().out) == want
    one = tmp_path / "one.fasta"
    one.write_text(">a\nACGT\n")
    assert cli.main(["-c", cfg, "msa", "-f", str(one), "--device", "cpu"]) == 1
