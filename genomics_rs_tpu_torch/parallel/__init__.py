"""Batched and sharded scoring, the sequence-parallel pipeline, all-pairs
scoring and multi-process execution (counterpart of
``genomics_rs_tpu/parallel``)."""

from genomics_rs_tpu_torch.parallel.allpairs import (
    AllPairsResult,
    allpairs_scores,
    allpairs_scores_resumable,
    write_scores_tsv,
)
from genomics_rs_tpu_torch.parallel.batch import (
    BatchScores,
    batch_scores_sharded,
    pad_batch,
    score_pairs,
)
from genomics_rs_tpu_torch.parallel.longseq import (
    LongSeqResult,
    batched_sharded_scores,
    sharded_gotoh_score,
)
from genomics_rs_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    SEQ_AXIS,
    make_mesh,
    make_mesh_2d,
)

__all__ = [
    "AllPairsResult",
    "allpairs_scores",
    "allpairs_scores_resumable",
    "write_scores_tsv",
    "BatchScores",
    "batch_scores_sharded",
    "pad_batch",
    "score_pairs",
    "LongSeqResult",
    "batched_sharded_scores",
    "sharded_gotoh_score",
    "DATA_AXIS",
    "SEQ_AXIS",
    "make_mesh",
    "make_mesh_2d",
]
