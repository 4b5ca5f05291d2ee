// Shared helpers of the port's kernels: dtype codes, value conversion by
// the CUDA intrinsics only, the dequant epilogue, the tree walk, the
// 16-byte LUT row load and the fixed-order partial-sum pass of the
// aggregate (lut_aggregate.cu).
//
// Each kernel source is built on its own into a shared library with a plain
// C interface (kernels/_build.py); every entry point returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// dtype codes shared with kernels/_build.py::DTYPE_CODES
enum DType : int { kF32 = 0, kBF16 = 1, kI8 = 2, kI16 = 3 };

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

// ---------------------------------------------------------------------------
// LUT row sums (fused_lutmu.cu, lut_aggregate.cu)
// ---------------------------------------------------------------------------

// Accumulator of a LUT type: int32 for int8 and int16 tables (exact in any
// order: |sum| ≤ C·2^15 < 2^31), float32 for float32 and bfloat16 tables.
// The aggregate keys it on its left operand's type instead, so a float32
// left operand sums any table in float32.
template <typename T> struct LutAcc { using type = float; };
template <> struct LutAcc<int8_t> { using type = int; };
template <> struct LutAcc<int16_t> { using type = int; };

__device__ __forceinline__ int lut_widen(int8_t v) { return static_cast<int>(v); }
__device__ __forceinline__ int lut_widen(int16_t v) { return static_cast<int>(v); }
__device__ __forceinline__ float lut_widen(float v) { return v; }
__device__ __forceinline__ float lut_widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// The 16 bytes of V = 16 / sizeof(T) LUT entries starting at p, raw;
// `full` means all V are in range and p is 16-byte aligned, else the first
// n_left are read one by one and the rest are zero.
template <typename T>
__device__ __forceinline__ uint4 load_row_raw(const T* __restrict__ p, bool full,
                                              int n_left) {
  if (full) return __ldg(reinterpret_cast<const uint4*>(p));
  uint4 raw = make_uint4(0u, 0u, 0u, 0u);
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < static_cast<int>(16 / sizeof(T)); ++i)
    if (i < n_left) e[i] = p[i];
  return raw;
}

// entry i of a raw 16-byte row, widened to the accumulator type
template <typename T>
__device__ __forceinline__ typename LutAcc<T>::type lut_entry(const uint4& raw, int i) {
  return lut_widen(reinterpret_cast<const T*>(&raw)[i]);
}

// Sum the per-split partials (splits, B, N) in split order, then the
// epilogue: deterministic, and exact on the int32 path.
template <typename A>
__global__ void reduce_epilogue_kernel(const A* __restrict__ partial,
                                       int splits,
                                       const float* __restrict__ scale,
                                       int scale_stride,
                                       const float* __restrict__ offset,
                                       int offset_stride,
                                       float* __restrict__ out, int B, int N) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t total = static_cast<size_t>(B) * N;
  if (idx >= total) return;
  const int n = static_cast<int>(idx % N);
  A s = 0;
  for (int k = 0; k < splits; ++k) s += partial[k * total + idx];
  out[idx] = dequant(to_f32(s), scale[n * scale_stride], offset[n * offset_stride]);
}

template <typename A>
void launch_reduce_epilogue(const A* partial, int splits, const float* scale,
                            int scale_stride, const float* offset,
                            int offset_stride, float* out, int B, int N,
                            cudaStream_t stream) {
  const size_t total = static_cast<size_t>(B) * N;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  reduce_epilogue_kernel<A><<<blocks, threads, 0, stream>>>(
      partial, splits, scale, scale_stride, offset, offset_stride, out, B, N);
}

#define REPRO_ERROR_STRING_FN                                      \
  extern "C" const char* repro_error_string(int err) {             \
    return cudaGetErrorString(static_cast<cudaError_t>(err));     \
  }
