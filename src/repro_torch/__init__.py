"""PyTorch/CUDA port of the LUT-MU serving stack.

A second package beside the JAX reference (``repro``): it imports
``torch`` and numpy, never ``jax`` and never ``repro``.  The LUT-MU kernels
are CUDA C++ for Hopper (``csrc/``), built with ``nvcc`` at first use and
bound with ``ctypes`` (``kernels/_build.py``); every kernel has a plain
PyTorch version beside it that CPU tensors take.
"""
