"""Genome-corpus helpers (counterpart of ``genomics_rs_tpu/comparison``;
only the FASTA directory loader so far)."""
