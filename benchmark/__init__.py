"""The benchmark of xgcm_tpu_torch on an NVIDIA card (see README.md)."""
