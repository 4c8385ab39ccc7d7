"""The benchmark of ``diffdrr_tpu_torch`` on an NVIDIA H100: ``run.py``."""
