"""Faults of ``cov-banded``: the banded fill's results."""

FAULTS = {
    # an answer altered where it is produced: every score one higher
    "answer": ("genomics_rs_tpu_torch.models.banded", "gotoh_banded",
               lambda r: (r[0] + 1, r[1])),
}
