"""The port's suffix array, BWT and FM-index on the CPU against the JAX
package: ``suffix_array`` / ``bwt_device`` against JAX's and against
native SA-IS, ``FMIndex.build`` (both suffix-array routes) field by field
against JAX's ``build(host=False)``, ``search_batch`` counts and ranges
(device and host) against JAX's device search, the one int64 gather path
against JAX's narrow and wide gathers, ``MultiFMIndex`` against JAX's,
and the CLI's ``search`` bytes against the JAX CLI's. Exact equality
throughout."""

import importlib

import numpy as np
import pytest
import torch

from genomics_rs_tpu.sequence import Sequence as JaxSequence
from genomics_rs_tpu.suffixtree import fmindex as jax_fm
from genomics_rs_tpu_torch.ops.bwt_device import bwt_device, suffix_array
from genomics_rs_tpu_torch.sequence import Sequence
from genomics_rs_tpu_torch.suffixtree import fmindex as fm
from genomics_rs_tpu_torch.suffixtree.native import native_suffix_array

jax_bwt = importlib.import_module("genomics_rs_tpu.ops.bwt_device")

SEP = chr(fm.SEPARATOR)


def _dna(seed: int, n: int) -> str:
    return "".join(np.random.default_rng(seed).choice(list("ACGT"), n))


TEXTS = {
    "banana": "BANANA",
    "mississippi": "MISSISSIPPI",
    "empty": "",
    "one": "A",
    "run": "AAAAAAAA",
    "period": "ACGT" * 50,
    "gattaca": "GATTACAGATTACACATTAG",
    "random997": _dna(40, 997),
    "random4k": _dna(41, 4_096),
    "contigs": "ACGTT" + SEP + "GGTAC" + SEP + "ACG",
    "contigs_random": SEP.join(_dna(42 + k, n) for k, n in enumerate((300, 1, 450, 120))),
}


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_suffix_array_and_bwt_match_jax_and_sais(name):
    text = TEXTS[name]
    got = suffix_array(text, device="cpu")
    assert got.dtype == np.int32 and got.shape == (len(text) + 1,)
    assert got.tolist() == jax_bwt.suffix_array(text).tolist()
    assert got.tolist() == native_suffix_array(text.encode("latin-1") + b"$").tolist()
    assert bwt_device(text, device="cpu") == jax_bwt.bwt_device(text)


def test_bwt_known_values():
    assert bwt_device("BANANA", device="cpu") == "ANNB$AA"
    assert bwt_device("MISSISSIPPI", device="cpu") == "IPSSM$PISSII"


FIELDS = ("text", "sa", "bwt", "alphabet", "code", "cvec", "occ")


def _same_fields(a, b) -> None:
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, bytes):
            assert x == y, f
        else:
            assert x.dtype == y.dtype and np.array_equal(x, y), f


@pytest.mark.parametrize("host", [True, False], ids=["sais", "device_sa"])
@pytest.mark.parametrize("name", ["banana", "mississippi", "one", "random997", "contigs_random"])
def test_fmindex_fields_match_jax(name, host):
    got = fm.FMIndex.build(TEXTS[name], host=host, device="cpu")
    assert got.device == torch.device("cpu")
    _same_fields(got, jax_fm.FMIndex.build(TEXTS[name], host=False))


def _patterns(text: str, seed: int, n: int) -> list:
    """Substrings of the text (20-40 bp when it is long), short motifs,
    patterns with absent bytes, the terminator, the separator, empty
    patterns and one longer than the text."""
    rng = np.random.default_rng(seed)
    pats = []
    for _ in range(n):
        L = int(rng.integers(1, 8)) if len(text) < 60 else int(rng.integers(20, 40))
        L = min(L, len(text))
        st = int(rng.integers(0, len(text) - L + 1))
        pats.append(text[st : st + L])
    pats += ["".join(rng.choice(list("ACGT"), k)) for k in (1, 2, 3, 5, 8)]
    pats += ["", "ACGZ", "$", "A$", SEP, "A" + SEP + "C", "N", "", text + "A", b"AC", b""]
    return pats


@pytest.mark.parametrize("name", ["banana", "mississippi", "gattaca", "random4k",
                                  "contigs_random"])
def test_search_batch_matches_jax(name):
    text = TEXTS[name]
    idx = fm.FMIndex.build(text, device="cpu")
    want_idx = jax_fm.FMIndex.build(text, host=False)
    pats = _patterns(text, 43, 300)
    want = want_idx.search_batch(pats, device=True)
    before = dict(fm.COUNTS)
    got = idx.search_batch(pats, device=True)
    assert fm.COUNTS["device"] == before["device"] + 1
    assert fm.COUNTS["host_range"] == before["host_range"]
    assert got[0].tolist() == want[0].tolist() and got[1] == want[1]
    host = idx.search_batch(pats, device=False)
    assert fm.COUNTS["host_range"] > before["host_range"]
    assert host[0].tolist() == want[0].tolist() and host[1] == want[1]
    assert idx.count_batch(pats).tolist() == want[0].tolist()
    for p in pats[:20] + pats[-11:]:
        assert idx.count(p) == want_idx.count(p)
        assert idx.locate(p).tolist() == want_idx.locate(p).tolist()
    for rng in got[1][:50]:
        assert idx.locate_range(rng).tolist() == want_idx.locate_range(rng).tolist()
    assert isinstance(idx._dev[0], torch.Tensor) and idx._dev[0].device.type == "cpu"


def test_search_batch_edge_batches():
    idx = fm.FMIndex.build("ACGTACGT", device="cpu")
    want = jax_fm.FMIndex.build("ACGTACGT", host=False)
    for pats in ([], [""], ["", b""], ["Z", "$"], ["ACGTACGTA"], ["T"]):
        got = idx.search_batch(pats)
        exp = want.search_batch(pats)
        assert got[0].tolist() == exp[0].tolist() and got[1] == exp[1]


def test_int64_gather_matches_jax_narrow_and_wide():
    """The port's one int64 path == JAX's flat int32 gather and its 2-D
    ``wide`` gather on the same index and patterns."""
    import jax.numpy as jnp

    text = TEXTS["gattaca"]
    idx = jax_fm.FMIndex.build(text, host=False)
    A = len(idx.alphabet)
    pats = np.full((3, 4), -1, dtype=np.int32)
    for row, p in enumerate([b"TTA", b"GATT", b"CA"]):
        pats[row, 4 - len(p):] = idx.code[np.frombuffer(p, np.uint8)]
    args = (jnp.asarray(idx.occ.reshape(-1)), jnp.asarray(idx.cvec), jnp.asarray(pats),
            jnp.int32(idx.n))
    lo, hi = fm._search_lockstep(torch.from_numpy(idx.occ.reshape(-1)),
                                 torch.from_numpy(idx.cvec.astype(np.int64)),
                                 torch.from_numpy(pats.astype(np.int64)), idx.n, A)
    assert lo.dtype == torch.int64
    for wide in (False, True):
        jlo, jhi = jax_fm._search_batch_device(*args, A=A, wide=wide)
        assert lo.tolist() == np.asarray(jlo).tolist()
        assert hi.tolist() == np.asarray(jhi).tolist()
    want = [sum(text[s : s + len(p)] == p for s in range(len(text)))
            for p in ("TTA", "GATT", "CA")]
    assert (hi - lo).tolist() == want


def _contigs(seed: int):
    rng = np.random.default_rng(seed)
    specs = [("chr1 first", 400), ("chr2", 1), ("chr3 x", 250), ("chr4", 600)]
    return [(name, "".join(rng.choice(list("ACGT"), n))) for name, n in specs]


@pytest.mark.parametrize("host", [None, False], ids=["sais", "device_sa"])
def test_multi_fmindex_matches_jax(host):
    contigs = _contigs(44)
    got = fm.MultiFMIndex.build([Sequence(n, s) for n, s in contigs], host=host, device="cpu")
    want = jax_fm.MultiFMIndex.build([JaxSequence(n, s) for n, s in contigs], host=False)
    _same_fields(got.index, want.index)
    assert got.names == want.names
    assert got.offsets.tolist() == want.offsets.tolist()
    assert got.lengths.tolist() == want.lengths.tolist()
    joined = SEP.join(s for _, s in contigs)
    pats = _patterns(joined, 45, 200) + ["A", "AC", contigs[1][1]]
    for device in (True, False):
        counts, ranges = got.search_batch(pats, device=device)
        wc, wr = want.search_batch(pats, device=True)
        assert counts.tolist() == wc.tolist() and ranges == wr
        for p, c, rng in zip(pats, counts, ranges):
            hits = got.locate_range(rng)
            assert hits == want.locate_range(rng)
            assert len(hits) == c, p
    assert got.count_batch(["", SEP]).tolist() == [sum(len(s) for _, s in contigs), 0]
    with pytest.raises(ValueError, match="separator"):
        fm.MultiFMIndex.build([Sequence("bad", "AC#G")], device="cpu")
    with pytest.raises(ValueError, match="empty"):
        fm.MultiFMIndex.build([], device="cpu")


def test_terminator_text_rejected():
    with pytest.raises(ValueError, match="terminator"):
        fm.FMIndex.build("AC$GT", device="cpu")


def test_cuda_request_without_cuda_is_an_error(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        suffix_array("ACGT", device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fm.FMIndex.build("ACGT")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fm.MultiFMIndex.build([Sequence("r", "ACGT")], host=True)


def test_facade_exports_fmindex_lazily():
    from genomics_rs_tpu_torch import suffixtree

    assert suffixtree.FMIndex is fm.FMIndex and suffixtree.MultiFMIndex is fm.MultiFMIndex
    with pytest.raises(AttributeError):
        suffixtree.NoSuchThing  # noqa: B018


# ---- the CLI ----


def _config(tmp_path) -> str:
    cfg = tmp_path / "config.toml"
    cfg.write_text("[scores]\ns_match = 1\ns_mismatch = -2\ng = -2\nh = -5\n")
    return str(cfg)


def _timeless(stdout: str) -> str:
    """stdout without the banner and the summary line's two times."""
    out = stdout.split("\x1b[0m", 1)[1]
    return "\n".join("<summary>" if ln.startswith("indexed ") else ln
                     for ln in out.splitlines())


@pytest.mark.parametrize("multi,locate,queries_fmt", [
    (False, True, "fasta"),
    (False, False, "fastq"),
    (True, True, "fastq"),
    (True, False, "fasta"),
])
def test_cli_search_matches_jax(tmp_path, capsys, monkeypatch, multi, locate, queries_fmt):
    """The TSV byte for byte and stdout apart from the summary's times,
    for both of the port's engines against the JAX CLI's default."""
    from genomics_rs_tpu import cli as jax_cli
    from genomics_rs_tpu_torch import cli

    monkeypatch.setenv("GENOMICS_TPU_JAX_CACHE", str(tmp_path / "jaxcache"))
    contigs = _contigs(46) if multi else _contigs(46)[:1]
    ref = tmp_path / "ref.fasta"
    ref.write_text("".join(f">{n}\n{s}\n" for n, s in contigs))
    joined = SEP.join(s for _, s in contigs)
    rng = np.random.default_rng(47)
    pats = []
    for k in range(40):
        L = int(rng.integers(3, 12))
        st = int(rng.integers(0, len(joined) - L))
        pats.append(joined[st : st + L].replace(SEP, "A"))
    pats += ["ACGTN", "A", "GG"]
    q = tmp_path / f"q.{queries_fmt}"
    if queries_fmt == "fasta":
        q.write_text("".join(f">q{k} read\n{p}\n" for k, p in enumerate(pats)))
    else:
        q.write_text("".join(f"@q{k}\n{p}\n+\n{'I' * len(p)}\n" for k, p in enumerate(pats)))
    flags = ["--locate"] if locate else []
    outs = {}
    runs = (("jax", jax_cli, []), ("device", cli, ["--device", "cpu"]),
            ("host", cli, ["--engine", "host", "--device", "cpu"]))
    for name, mod, extra in runs:
        out = tmp_path / f"{name}.tsv"
        argv = ["-c", _config(tmp_path), "search", "-r", str(ref), "-q", str(q), "-o", str(out),
                *flags, *extra]
        assert mod.main(argv) == 0
        stdout = capsys.readouterr().out.replace(str(out), "OUT")
        outs[name] = (_timeless(stdout), out.read_bytes())
    assert outs["device"] == outs["jax"] and outs["host"] == outs["jax"]
    header = b"query\tcount\tpositions\n" if locate else b"query\tcount\n"
    assert outs["device"][1].startswith(header)
    if multi and locate:
        assert b"chr1:" in outs["device"][1] and b"chr4:" in outs["device"][1]


def test_cli_search_cuda_without_cuda_is_an_error(tmp_path, capsys, monkeypatch):
    from genomics_rs_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ref = tmp_path / "ref.fasta"
    ref.write_text(">r\nACGTACGT\n")
    q = tmp_path / "q.fasta"
    q.write_text(">p\nACG\n")
    for extra in ([], ["--device", "cuda", "--engine", "host"]):
        argv = ["-c", _config(tmp_path), "search", "-r", str(ref), "-q", str(q),
                "-o", str(tmp_path / "o.tsv"), *extra]
        assert cli.main(argv) == 2
        assert "CUDA is not available" in capsys.readouterr().err
