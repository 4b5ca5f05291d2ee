// Shared helpers of the LUT-MU kernels: dtype codes, value conversion by
// the CUDA intrinsics only, and the dequant epilogue.
//
// Each kernel source is built on its own into a shared library with a plain
// C interface (kernels/_build.py); every entry point returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// dtype codes shared with kernels/_build.py::DTYPE_CODES
enum DType : int { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int v) { return __int2float_rn(v); }

// acc·scale + offset with two roundings: nvcc would otherwise contract the
// expression into one FMA, and the plain PyTorch version rounds twice.
__device__ __forceinline__ float dequant(float acc, float scale, float offset) {
  return __fadd_rn(__fmul_rn(acc, scale), offset);
}

// Heap-order tree walk: x[l] >= thr[node] goes right; the leaf is the path
// bits, most significant first (the same comparisons the TPU kernel's
// parallel comparators make along the one valid root-to-leaf path).
__device__ __forceinline__ int tree_leaf(const float* __restrict__ x,
                                         const float* __restrict__ thr,
                                         int depth) {
  int node = 0;
  for (int l = 0; l < depth; ++l) node = 2 * node + 1 + (x[l] >= thr[node] ? 1 : 0);
  return node - ((1 << depth) - 1);
}

#define REPRO_ERROR_STRING_FN                                      \
  extern "C" const char* repro_error_string(int err) {             \
    return cudaGetErrorString(static_cast<cudaError_t>(err));     \
  }
