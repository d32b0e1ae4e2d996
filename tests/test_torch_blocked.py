"""K16's entry ``gotoh_scores_blocked`` (CPU tensors: the strips' plain
version at R-row strips) against the JAX package's, in interpret mode, on
``tests/test_pallas.py``'s case (R = 64) and ``tests/test_subst.py``'s
kimura case (R = 16). Exact equality; the answer does not depend on R.
"""

import numpy as np
import pytest
import torch

from genomics_rs_tpu.config import Scores as JaxScores
from genomics_rs_tpu.ops.gotoh_pallas import gotoh_scores_blocked as jax_blocked
from genomics_rs_tpu.sequence import Sequence as JaxSequence
from genomics_rs_tpu_torch.config import Scores
from genomics_rs_tpu_torch.ops import gotoh_pallas as gp
from genomics_rs_tpu_torch.sequence import PAD_S1, PAD_S2

SCORES = (1, -2, -1, -5)
KIM = (1, -2, -1, -5, -1)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The plain strips run thousands of small torch ops; torch's thread
    pool only contends with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pallas_case():
    """``test_pallas.py::test_blocked_batch_scores``'s batch (seed 77)."""
    rng = np.random.default_rng(77)
    B, Lm, Ln = 4, 300, 200
    ms = rng.integers(10, Lm + 1, B).astype(np.int32)
    ns = rng.integers(10, Ln + 1, B).astype(np.int32)
    s1b = np.full((B, Lm), PAD_S1, dtype=np.uint8)
    s2b = np.full((B, Ln), PAD_S2, dtype=np.uint8)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    for i in range(B):
        s1b[i, : ms[i]] = bases[rng.integers(0, 4, ms[i])]
        s2b[i, : ns[i]] = bases[rng.integers(0, 4, ns[i])]
    return s1b, s2b, ms, ns


def _kimura_case():
    """``test_subst.py::test_blocked_kernel_kimura``'s batch (seed 24)."""
    rng = np.random.default_rng(24)
    ms = rng.integers(40, 65, 3).astype(np.int32)
    ns = rng.integers(40, 65, 3).astype(np.int32)
    s1b = np.stack([JaxSequence("a", "".join(rng.choice(list("ACGTN"), m))).encoded(pad_to=64)
                    for m in ms])
    s2b = np.stack([JaxSequence("b", "".join(rng.choice(list("ACGTN"), n))).encoded(
        pad_to=64, pad_value=PAD_S2) for n in ns])
    return s1b, s2b, ms, ns


def _rows(out):
    return list(zip(*(np.asarray(x).tolist() for x in out)))


@pytest.mark.parametrize("is_local", [False, True])
@pytest.mark.parametrize("case,score_t,R", [
    (_pallas_case, SCORES, 64), (_kimura_case, KIM, 16)], ids=["pallas-R64", "kimura-R16"])
def test_blocked_matches_jax(case, score_t, R, is_local):
    s1b, s2b, ms, ns = case()
    want = jax_blocked(s1b, s2b, ms, ns, JaxScores(*score_t), is_local, R=R, interpret=True)
    before = dict(gp.BLOCKED_COUNTS)
    got = gp.gotoh_scores_blocked(torch.from_numpy(s1b), torch.from_numpy(s2b), ms, ns,
                                  Scores(*score_t), is_local, R=R)
    assert gp.BLOCKED_COUNTS == {"kernel": before["kernel"], "plain": before["plain"] + 1}
    assert _rows(got) == _rows(want)
    # Any block height fills the same table.
    for r in (7, 4096):
        again = gp.gotoh_scores_blocked(torch.from_numpy(s1b), torch.from_numpy(s2b), ms, ns,
                                        Scores(*score_t), is_local, R=r)
        assert _rows(again) == _rows(want), r


def test_blocked_rows_fit_a_block():
    """The card's strip height: the least compiled warp-strip height (32 x
    RT rows, RT = 1, 2, 4, 8 or 16) that holds R rows, at most 512."""
    assert [gp.blocked_rows(r) for r in (1, 16, 64, 100, 200, 300, 4096)] == [
        32, 32, 64, 128, 256, 512, 512]


@pytest.mark.parametrize("R,Lm,want", [(4096, 384, 256), (4096, 511, 256), (4096, 512, 512),
                                       (4096, 155_008, 512), (300, 384, 256), (4096, 200, 256),
                                       (64, 384, 64), (200, 150, 256)])
def test_blocked_rows_short_bucket_takes_pipe_rows(R, Lm, want):
    """A bucket that one strip of ``blocked_rows(R)`` would hold runs at
    K9's height at most (its pairs' strips sweep at once); a longer bucket
    keeps the block's height."""
    assert gp.blocked_rows(R, Lm) == want
    assert gp.pipe_rows(Lm, gp.blocked_rows(R, Lm)) <= want
