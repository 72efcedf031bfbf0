"""The benchmark of juicy_tpu_torch (the PyTorch and CUDA port): the
harness (run.py, harness.py), its drivers, traffic mixes, configurations
and per-layer metric readers, the plain reference (reference/) and the
comparison that decides `correct` (compare.py). It reads nothing of the
JAX package and imports none of it."""
