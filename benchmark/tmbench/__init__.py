"""The benchmark harness of ``triplet_match_tpu_torch`` (see ``run.py``)."""
