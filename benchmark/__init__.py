"""The benchmark of ``dagr_tpu_torch`` on the H100 (see ``run.py``)."""
