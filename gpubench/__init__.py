"""The benchmark of tokengeex_tpu_torch (see README.md)."""
