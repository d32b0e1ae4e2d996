"""Batched scoring and all-pairs scoring (counterpart of
``genomics_rs_tpu/parallel``; the single-device paths so far)."""
