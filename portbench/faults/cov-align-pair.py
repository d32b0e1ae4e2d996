"""Faults of ``cov-align-pair``: the classified alignment of a pair."""

FAULTS = {
    # an answer altered where it is produced: one match too many
    "answer": ("genomics_rs_tpu_torch.models.aligner", "classify_moves",
               lambda al: setattr(al, "matches", al.matches + 1) or al),
}
