"""The benchmark of ``mcmcpp_tpu_torch`` on one NVIDIA H100 (``run.py``)."""
