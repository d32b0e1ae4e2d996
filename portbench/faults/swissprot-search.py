"""Faults of ``swissprot-search``: the scores and start cells of a
query against the database, where the program produces them."""

import torch

FAULTS = {
    # an answer altered where it is produced: the best score raised
    "answer": ("genomics_rs_tpu_torch.ops.gotoh_matrix", "gotoh_scores_matrix",
               lambda r: (r[0] + (r[0] == r[0].max()).int(), r[1], r[2])),
    # half of the batch left out: the first half of each length class's entries
    # read 0
    "half": ("genomics_rs_tpu_torch.ops.gotoh_matrix", "gotoh_scores_matrix",
             lambda r: tuple(x.clone().index_fill_(0, torch.arange(x.shape[0] // 2 + 1), 0)
                             for x in r)),
}
