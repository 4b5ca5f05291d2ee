"""LUT-MU kernels layer (PyTorch + CUDA).

``dispatch.lutmu_matmul`` is the one entry point the models use; ``ref``
keeps the plain PyTorch versions of the kernels, ``_build`` compiles and
binds the CUDA sources in ``csrc/``, and each kernel module holds one
wrapper with its launch counter.
"""
