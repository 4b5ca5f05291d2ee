// MADDNESS encode to a one-hot, for Hopper.
//
// Replaces: repro/kernels/maddness_encode.py::encode_onehot_pallas
// (_encode_kernel), the TPU kernel that evaluates every node comparison of a
// (B_t, C_t) tile at once on the VPU and expands a level-by-level leaf mask.
//
// What bounds it on this card: device-memory bytes.  Per (row, codebook) it
// reads I split values and 2^I - 1 thresholds and writes G = 2^I one-hot
// entries; the compares are a few instructions per byte written.
//
// What the design does about it: one thread per (row, codebook) walks the
// I levels of its tree (the comparisons on the one valid root-to-leaf path
// are the parallel comparators' result) and writes its G entries.  The
// thresholds of a codebook are read by every row and stay in L1/L2; the
// one-hot is the output, so its bytes are the floor.

#include "common.cuh"

namespace {

__device__ __forceinline__ void set_onehot(float* o, int g) { o[g] = 1.0f; }
__device__ __forceinline__ void set_onehot(__nv_bfloat16* o, int g) { o[g] = __float2bfloat16(1.0f); }
__device__ __forceinline__ void set_onehot(int8_t* o, int g) { o[g] = 1; }

__device__ __forceinline__ void clear(float* o, int g) { o[g] = 0.0f; }
__device__ __forceinline__ void clear(__nv_bfloat16* o, int g) { o[g] = __float2bfloat16(0.0f); }
__device__ __forceinline__ void clear(int8_t* o, int g) { o[g] = 0; }

template <typename O>
__global__ void encode_onehot_kernel(const float* __restrict__ x,
                                     const float* __restrict__ thr,
                                     O* __restrict__ out, int B, int C,
                                     int depth) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<size_t>(B) * C) return;
  const int c = static_cast<int>(idx % C);
  const int G = 1 << depth;
  const int leaf = tree_leaf(x + idx * depth, thr + static_cast<size_t>(c) * (G - 1), depth);
  O* o = out + idx * G;
  for (int g = 0; g < G; ++g) {
    if (g == leaf) set_onehot(o, g); else clear(o, g);
  }
}

template <typename O>
void launch(const void* x, const void* thr, void* out, int B, int C, int depth,
            cudaStream_t stream) {
  const size_t total = static_cast<size_t>(B) * C;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  encode_onehot_kernel<O><<<blocks, threads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(thr),
      static_cast<O*>(out), B, C, depth);
}

}  // namespace

REPRO_ERROR_STRING_FN

// x (B, C, depth) f32, thr (C, 2^depth - 1) f32 → out (B, C, 2^depth) in
// out_dtype.  Returns cudaGetLastError() after the launch.
extern "C" int encode_onehot_launch(const void* x, const void* thr, void* out,
                                    int out_dtype, int B, int C, int depth,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (out_dtype) {
    case kF32: launch<float>(x, thr, out, B, C, depth, s); break;
    case kBF16: launch<__nv_bfloat16>(x, thr, out, B, C, depth, s); break;
    case kI8: launch<int8_t>(x, thr, out, B, C, depth, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
