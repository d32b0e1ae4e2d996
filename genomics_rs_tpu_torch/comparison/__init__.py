"""Genome-corpus helpers (counterpart of ``genomics_rs_tpu/comparison``):
the FASTA directory loader, the all-pairs recursive LCS comparison and its
heatmap."""
