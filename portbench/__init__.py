"""The benchmark of ``genomics_rs_tpu_torch`` (see ``run.py``)."""
