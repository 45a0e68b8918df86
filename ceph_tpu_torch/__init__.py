"""ceph_tpu_torch — the PyTorch/CUDA port of ceph_tpu for NVIDIA Hopper.

Layout mirrors the JAX package (same file names), but this package
imports ``torch`` and numpy only: never ``jax`` and nothing of
``ceph_tpu``.  Every GPU kernel is hand-written CUDA C++ under
``csrc/``, built with ``nvcc`` at first use (``ops/_build.py``).
Entry points run on the CUDA device unless the caller asks for the CPU
(``backend=host`` / ``device="cpu"``); there is no silent fallback.
"""
