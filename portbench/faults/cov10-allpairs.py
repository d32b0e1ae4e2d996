"""Faults of ``cov10-allpairs``: the scores of a corpus's pairs, where
the program produces them."""

import numpy as np

from portbench.faults import plus_one

FAULTS = {
    # an answer altered where it is produced
    "answer": ("genomics_rs_tpu_torch.parallel.allpairs", "_score_pairs_bucketed",
               lambda r: (plus_one(r[0][None])[0], r[1])),
    # half of the batch left out: the first half of the pairs never scored
    "half": ("genomics_rs_tpu_torch.parallel.allpairs", "_score_pairs_bucketed",
             lambda r: (np.where(np.arange(r[0].size) < r[0].size // 2, 0, r[0]), r[1])),
}
