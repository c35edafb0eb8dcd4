"""The benchmark of superscreen_tpu_torch on an NVIDIA H100: the harness,
the plain reference it is judged by, and the data it runs (see README.md)."""
