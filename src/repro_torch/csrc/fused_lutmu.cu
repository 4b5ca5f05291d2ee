// Fused LUT-MU for Hopper: tree encode + LUT gather-sum + dequant epilogue.
//
// Replaces: repro/kernels/fused_lutmu.py::fused_lutmu_pallas (_fused_kernel),
// the TPU kernel that builds a one-hot in VMEM and contracts it with the LUT
// tile on the MXU.
//
// What bounds it on this card: device-memory bytes.  Each output row needs
// exactly one LUT row (N entries) per codebook, so the work is B·C·N loads
// and adds against at most min(B, G)·C·N LUT bytes; there is no matrix
// product to feed the tensor cores, and a one-hot contraction would read the
// whole C·G·N table (G times the bytes at decode) and multiply by zeros.
//
// What the design does about it: no one-hot.  A block owns a (kRows rows,
// N-tile) pair and a slice of the codebooks.  Its threads first derive the
// leaf of every (row, codebook) of the slice into shared memory, then each
// thread streams LUT[c, leaf[b], n0 .. n0+V) with one 16-byte vector load per
// row and codebook (neighbouring threads on neighbouring columns, so each
// warp reads whole 512-byte spans) into int32 (int8 LUTs) or float32
// (f32/bf16 LUTs) registers.  Decode batches are a few rows, which leaves too
// few (row, N-tile) blocks to keep the memory system busy, so the codebooks
// are split over gridDim.z; the splits write partial sums that a second,
// small kernel adds in a fixed order before the epilogue (deterministic, and
// exact on the int32 path).  With one split the first kernel applies the
// epilogue itself.

#include "common.cuh"

namespace {

constexpr int kThreads = 64;  // threads per block
constexpr int kRows = 4;      // output rows per block

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_lutmu_kernel(const float* __restrict__ x, const float* __restrict__ thr,
                   const T* __restrict__ lut, const float* __restrict__ scale,
                   int scale_stride, const float* __restrict__ offset,
                   int offset_stride, float* __restrict__ out,
                   typename LutAcc<T>::type* __restrict__ partial, int B, int C,
                   int N, int depth, int c_per_split, bool vec_ok) {
  using A = typename LutAcc<T>::type;
  constexpr int V = 16 / sizeof(T);
  extern __shared__ unsigned char leaf_s[];  // [kRows][c_per_split]

  const int G = 1 << depth;
  const int b0 = blockIdx.y * kRows;
  const int c0 = blockIdx.z * c_per_split;
  const int c1 = min(C, c0 + c_per_split);
  const int nc = c1 - c0;
  const int rows = min(kRows, B - b0);

  // encode: one leaf per (row, codebook) of this block's slice
  for (int i = threadIdx.x; i < kRows * nc; i += kThreads) {
    const int r = i / nc;
    const int c = c0 + i % nc;
    int leaf = 0;
    if (r < rows) {
      leaf = tree_leaf(x + (static_cast<size_t>(b0 + r) * C + c) * depth,
                       thr + static_cast<size_t>(c) * (G - 1), depth);
    }
    leaf_s[i] = static_cast<unsigned char>(leaf);
  }
  __syncthreads();

  const int n0 = (blockIdx.x * kThreads + threadIdx.x) * V;
  if (n0 >= N) return;
  const int n_left = N - n0;
  const bool full = vec_ok && n_left >= V;

  A acc[kRows][V];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int i = 0; i < V; ++i) acc[r][i] = 0;

  for (int c = c0; c < c1; ++c) {
    const T* base = lut + static_cast<size_t>(c) * G * N + n0;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < rows) {
        const int leaf = leaf_s[r * nc + (c - c0)];
        A v[V];
        load_row<T, V>(base + static_cast<size_t>(leaf) * N, full, n_left, v);
#pragma unroll
        for (int i = 0; i < V; ++i) acc[r][i] += v[i];
      }
    }
  }

  const bool last = gridDim.z == 1;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r >= rows) break;
    const size_t row = static_cast<size_t>(b0 + r) * N;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int n = n0 + i;
      if (n >= N) break;
      if (last) {
        out[row + n] = dequant(to_f32(acc[r][i]), scale[n * scale_stride],
                               offset[n * offset_stride]);
      } else {
        partial[static_cast<size_t>(blockIdx.z) * B * N + row + n] = acc[r][i];
      }
    }
  }
}

template <typename T>
void launch(const void* x, const void* thr, const void* lut, const void* scale,
            int scale_stride, const void* offset, int offset_stride, void* out,
            void* partial, int B, int C, int N, int depth, int c_per_split,
            int splits, cudaStream_t stream) {
  using A = typename LutAcc<T>::type;
  constexpr int V = 16 / sizeof(T);
  const int cols = kThreads * V;
  const bool vec_ok = (N % V == 0) &&
                      (reinterpret_cast<uintptr_t>(lut) % 16 == 0);
  dim3 grid((N + cols - 1) / cols, (B + kRows - 1) / kRows, splits);
  const size_t smem = static_cast<size_t>(kRows) * c_per_split;
  fused_lutmu_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(thr),
      static_cast<const T*>(lut), static_cast<const float*>(scale),
      scale_stride, static_cast<const float*>(offset), offset_stride,
      static_cast<float*>(out), static_cast<A*>(partial), B, C, N, depth,
      c_per_split, vec_ok);
  if (splits > 1) {
    launch_reduce_epilogue<A>(static_cast<const A*>(partial), splits,
                              static_cast<const float*>(scale), scale_stride,
                              static_cast<const float*>(offset), offset_stride,
                              static_cast<float*>(out), B, N, stream);
  }
}

}  // namespace

REPRO_ERROR_STRING_FN

// x (B, C, depth) f32, thr (C, 2^depth - 1) f32, lut (C, 2^depth, N) in
// lut_dtype, scale/offset f32 of N entries (stride 1) or one (stride 0),
// out (B, N) f32; partial (splits, B, N) int32 (int8 LUT) or f32, unused
// when splits == 1.  Returns cudaGetLastError() after the launches.
extern "C" int fused_lutmu_launch(const void* x, const void* thr,
                                  const void* lut, int lut_dtype,
                                  const void* scale, int scale_stride,
                                  const void* offset, int offset_stride,
                                  void* out, void* partial, int B, int C, int N,
                                  int depth, int c_per_split, int splits,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (lut_dtype) {
    case kI8:
      launch<int8_t>(x, thr, lut, scale, scale_stride, offset, offset_stride,
                     out, partial, B, C, N, depth, c_per_split, splits, s);
      break;
    case kF32:
      launch<float>(x, thr, lut, scale, scale_stride, offset, offset_stride,
                    out, partial, B, C, N, depth, c_per_split, splits, s);
      break;
    case kBF16:
      launch<__nv_bfloat16>(x, thr, lut, scale, scale_stride, offset,
                            offset_stride, out, partial, B, C, N, depth,
                            c_per_split, splits, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
