"""MLego on PyTorch and CUDA: a port of the ``repro`` package.

Entry points run on a CUDA device unless the caller asks for the CPU
(``device="cpu"``).  The hot kernels are CUDA C++ for Hopper
(``kernels/csrc``), built on first use.  Importing this package loads
``torch`` and ``numpy`` only — never ``jax`` and nothing of ``repro``.
"""
