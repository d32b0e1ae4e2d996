"""The sequence-parallel pipeline (``parallel/longseq``) and its meshes
against the JAX package, on CPU meshes (the plain tile fill in every
shard): ``sharded_gotoh_score`` at P in {1, 2, 4, 8} shards against JAX's
on its 8-device CPU mesh (``tests/test_longseq.py``'s seed and padded
length), ``batched_sharded_scores`` on a 2 x 4 mesh, and ``align_sharded``
against JAX's (scan engine): identical moves and stats, also through a
left exit and a sub-blocked backward. Exact equality throughout.
"""

import functools

import numpy as np
import pytest
import torch

from genomics_rs_tpu.config import Scores as JaxScores
from genomics_rs_tpu.parallel import longseq as jls
from genomics_rs_tpu.parallel.mesh import make_mesh as jax_make_mesh
from genomics_rs_tpu.parallel.mesh import make_mesh_2d as jax_make_mesh_2d
from genomics_rs_tpu.sequence import Sequence as JaxSequence
from genomics_rs_tpu_torch.config import Scores
from genomics_rs_tpu_torch.ops import gotoh_pallas as gp
from genomics_rs_tpu_torch.parallel import longseq as ls
from genomics_rs_tpu_torch.parallel import mesh as pmesh
from genomics_rs_tpu_torch.sequence import PAD_S1, PAD_S2, Sequence

SCORES = (1, -2, -1, -5)
LPAD = 320
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The plain tile fills run thousands of small torch ops; torch's
    thread pool only contends with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cpu_mesh(P, axis=pmesh.SEQ_AXIS):
    return pmesh.make_mesh(P, axis, devices=[CPU] * P)


@functools.lru_cache(maxsize=None)
def _score_cases(is_local):
    """``test_longseq.py``'s pairs (seed 17) and JAX's 8-shard answers."""
    rng = np.random.default_rng(17)
    cases = [(1, 8), (317, 211)] + [(int(rng.integers(3, 300)), int(rng.integers(3, 300)))
                                    for _ in range(3)]
    mesh = jax_make_mesh(8, axis_name="seq")
    out = []
    for m, n in cases:
        a = "".join(rng.choice(list("ACGT"), m))
        b = "".join(rng.choice(list("ACGT"), n))
        s1e = Sequence("x", a).encoded(pad_to=LPAD, pad_value=PAD_S1)
        s2e = Sequence("x", b).encoded(pad_to=LPAD, pad_value=PAD_S2)
        want = jls.sharded_gotoh_score(mesh, s1e, s2e, np.int32(m), np.int32(n),
                                       JaxScores(*SCORES), is_local, engine="scan")
        out.append((s1e, s2e, m, n, int(want.score), tuple(int(x) for x in want.best)))
    return out


@pytest.mark.parametrize("P", [1, 2, 4, 8])
@pytest.mark.parametrize("is_local", [False, True])
def test_sharded_score_matches_jax(is_local, P):
    mesh = _cpu_mesh(P)
    for s1e, s2e, m, n, score, best in _score_cases(is_local):
        got = ls.sharded_gotoh_score(mesh, s1e, s2e, m, n, Scores(*SCORES), is_local)
        if is_local:
            assert tuple(got.best.tolist()) == best, (m, n, P)
        else:
            assert int(got.score) == score, (m, n, P)


def test_sharded_score_runs_one_tile_per_block():
    """P shards x C blocks issue P * C tiles (inactive ones are skipped)."""
    s1e, s2e, m, n, score, _ = _score_cases(False)[1]
    before = gp.TILE_COUNTS["plain"]
    got = ls.sharded_gotoh_score(_cpu_mesh(4), s1e, s2e, m, n, Scores(*SCORES), n_blocks=5)
    assert int(got.score) == score
    assert gp.TILE_COUNTS["plain"] - before == 4 * 5


def test_sharded_fill_checkpoints_match_jax():
    """The forward's captured tile entries (tops and lefts) equal JAX's."""
    s1e, s2e, m, n, _, _ = _score_cases(True)[1]
    want = jls.sharded_fill_checkpoints(jax_make_mesh(4, axis_name="seq"), s1e, s2e, m, n,
                                        JaxScores(*SCORES), True, engine="scan")
    got = ls.sharded_fill_checkpoints(_cpu_mesh(4), s1e, s2e, m, n, Scores(*SCORES), True)
    assert tuple(got.best.tolist()) == tuple(int(x) for x in want.best)
    np.testing.assert_array_equal(got.tops.numpy(), np.asarray(want.tops))
    np.testing.assert_array_equal(got.lefts.numpy(), np.asarray(want.lefts))


def test_batched_2d_mesh_matches_jax():
    """(data 2 x seq 4): a batch of pairs, each pair's rows sharded."""
    rng = np.random.default_rng(23)
    B, L = 4, 64
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    ms = rng.integers(L // 2, L + 1, B).astype(np.int32)
    ns = rng.integers(L // 2, L + 1, B).astype(np.int32)
    s1b = np.full((B, L), PAD_S1, dtype=np.uint8)
    s2b = np.full((B, L), PAD_S2, dtype=np.uint8)
    for i in range(B):
        s1b[i, : ms[i]] = bases[rng.integers(0, 4, ms[i])]
        s2b[i, : ns[i]] = bases[rng.integers(0, 4, ns[i])]
    mesh = pmesh.make_mesh_2d(2, 4, devices=[CPU] * 8)
    for is_local in (False, True):
        want = jls.batched_sharded_scores(jax_make_mesh_2d(2, 4), s1b, s2b, ms, ns,
                                          JaxScores(*SCORES), is_local, engine="scan")
        got = ls.batched_sharded_scores(mesh, s1b, s2b, ms, ns, Scores(*SCORES), is_local)
        np.testing.assert_array_equal(got.score.numpy(), np.asarray(want.score))
        if is_local:
            np.testing.assert_array_equal(got.best.numpy(), np.asarray(want.best))


def _aligned(r):
    return (r.score, [(c.value, i, j) for c, i, j in r.alignment], r.matches, r.mismatches,
            r.gap_extensions, r.opening_gaps)


@pytest.mark.parametrize("is_local", [False, True])
def test_align_sharded_matches_jax(is_local):
    rng = np.random.default_rng(23)
    m, n = 317, 211
    a, b = ("".join(rng.choice(list("ACGT"), k)) for k in (m, n))
    want = jls.align_sharded(jax_make_mesh(8, axis_name="seq"), JaxSequence("a", a),
                             JaxSequence("b", b), JaxScores(*SCORES), is_local=is_local,
                             engine="scan", interpret=True)
    got = ls.align_sharded(_cpu_mesh(8), Sequence("a", a), Sequence("b", b), Scores(*SCORES),
                           is_local=is_local)
    assert _aligned(got) == _aligned(want)


def test_align_sharded_left_exit_matches_jax():
    """A 400 bp insertion out-runs the first window guess: the walk exits
    left and resumes one stride wider."""
    rng = np.random.default_rng(31)
    core = "".join(rng.choice(list("ACGT"), 100))
    ins = "".join(rng.choice(list("ACGT"), 400))
    a, b = core, core[:50] + ins + core[50:]
    want = jls.align_sharded(jax_make_mesh(2, axis_name="seq"), JaxSequence("a", a),
                             JaxSequence("b", b), JaxScores(*SCORES), engine="scan",
                             interpret=True)
    got = ls.align_sharded(_cpu_mesh(2), Sequence("a", a), Sequence("b", b), Scores(*SCORES))
    assert _aligned(got) == _aligned(want)


def test_align_sharded_sub_blocked_matches_jax():
    """Shards taller than ``sub_rows``: the window-local sub-forward
    rebuilds the sub-block tops before the walk."""
    rng = np.random.default_rng(29)
    a, b = ("".join(rng.choice(list("ACGT"), k)) for k in (300, 260))
    want = jls.align_sharded(jax_make_mesh(2, axis_name="seq"), JaxSequence("a", a),
                             JaxSequence("b", b), JaxScores(*SCORES), engine="scan",
                             interpret=True, sub_rows=63)
    got = ls.align_sharded(_cpu_mesh(2), Sequence("a", a), Sequence("b", b), Scores(*SCORES),
                           sub_rows=63)
    assert _aligned(got) == _aligned(want)


def test_meshes():
    mesh = pmesh.make_mesh_2d(2, 3, devices=[CPU] * 6)
    assert mesh.shape == {"data": 2, "seq": 3} and mesh.size == 6
    assert pmesh.axis_devices(mesh, "seq") == [CPU] * 3
    with pytest.raises(ValueError, match="requested 3 devices, only 2 available"):
        pmesh.make_mesh(3, devices=[CPU] * 2)
    with pytest.raises(ValueError, match="requested 6 devices, only 4 available"):
        pmesh.make_mesh_2d(2, 3, devices=[CPU] * 4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pmesh.make_mesh()


def test_unported_and_bad_inputs_raise():
    s1e, s2e, m, n, _, _ = _score_cases(False)[0]
    with pytest.raises(ValueError, match="unknown engine"):
        ls.sharded_gotoh_score(_cpu_mesh(2), s1e, s2e, m, n, Scores(*SCORES), engine="bogus")
    with pytest.raises(ValueError, match="divide into"):
        ls.sharded_gotoh_score(_cpu_mesh(3), s1e, s2e, m, n, Scores(*SCORES))
