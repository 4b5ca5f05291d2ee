// LUT aggregation as a general product (B, K) × (K, N) + dequant epilogue,
// for Hopper.
//
// Replaces: repro/kernels/lut_aggregate.py::lut_aggregate_pallas
// (_matmul_kernel), the TPU kernel that tiles the one-hot × LUT contraction
// over (B, N, K) on the MXU and accumulates over the K grid axis.
//
// What bounds it on this card: device-memory bytes for the batches the
// serving path gives it (a few to a few tens of rows): the K×N right operand
// is read once per 16-row tile and each of its bytes takes 2·16 operations at
// most, far below the ~600 int8 operations per byte where the tensor cores
// would become the limit.
//
// What the design does about it: the TPU kernel's sequential K grid axis
// becomes a loop inside the block.  A block owns a 16-row × 64-column output
// tile; per 16-deep K step its 256 threads stage the left tile and the right
// tile in shared memory (the right tile read by 64 neighbouring threads per
// row, so coalesced) and each thread accumulates four outputs in int32
// (int8 × int8) or float32 registers.  It takes any left operand, as the TPU
// kernel does; a one-hot-aware or tensor-core (mma) version is later work.

#include "common.cuh"

namespace {

constexpr int BM = 16;  // output rows per block
constexpr int BN = 64;  // output columns per block (blockDim.x)
constexpr int BK = 16;  // K depth per shared-memory step
constexpr int TY = 4;   // blockDim.y; each thread computes BM / TY rows

// Operand values in the accumulation type (int32 for int8 × int8, else
// float32; a bf16 LUT widens exactly).
__device__ __forceinline__ int widen(int8_t v) { return static_cast<int>(v); }
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename L> struct AccOf { using type = float; };
template <> struct AccOf<int8_t> { using type = int; };

template <typename L, typename R>
__global__ void __launch_bounds__(BN * TY)
lut_aggregate_kernel(const L* __restrict__ lhs, const R* __restrict__ rhs,
                     const float* __restrict__ scale, int scale_stride,
                     const float* __restrict__ offset, int offset_stride,
                     float* __restrict__ out, int B, int K, int N) {
  using A = typename AccOf<L>::type;
  __shared__ A As[BM][BK];
  __shared__ A Bs[BK][BN];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * BN + tx;
  const int row0 = blockIdx.y * BM;
  const int col = blockIdx.x * BN + tx;

  A acc[BM / TY];
#pragma unroll
  for (int i = 0; i < BM / TY; ++i) acc[i] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    {  // left tile: BM × BK = 256 entries, one per thread
      const int r = tid / BK, k = tid % BK;
      const int gr = row0 + r, gk = k0 + k;
      As[r][k] = (gr < B && gk < K)
                     ? widen(lhs[static_cast<size_t>(gr) * K + gk])
                     : A(0);
    }
#pragma unroll
    for (int i = 0; i < BK / TY; ++i) {  // right tile: BK × BN
      const int k = ty * (BK / TY) + i;
      const int gk = k0 + k;
      Bs[k][tx] = (gk < K && col < N)
                      ? widen(rhs[static_cast<size_t>(gk) * N + col])
                      : A(0);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const A b = Bs[k][tx];
#pragma unroll
      for (int i = 0; i < BM / TY; ++i) acc[i] += As[ty * (BM / TY) + i][k] * b;
    }
    __syncthreads();
  }

  if (col >= N) return;
#pragma unroll
  for (int i = 0; i < BM / TY; ++i) {
    const int r = row0 + ty * (BM / TY) + i;
    if (r < B) {
      out[static_cast<size_t>(r) * N + col] =
          dequant(to_f32(acc[i]), scale[col * scale_stride],
                  offset[col * offset_stride]);
    }
  }
}

template <typename L, typename R>
void launch(const void* lhs, const void* rhs, const void* scale,
            int scale_stride, const void* offset, int offset_stride, void* out,
            int B, int K, int N, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (B + BM - 1) / BM);
  dim3 block(BN, TY);
  lut_aggregate_kernel<L, R><<<grid, block, 0, stream>>>(
      static_cast<const L*>(lhs), static_cast<const R*>(rhs),
      static_cast<const float*>(scale), scale_stride,
      static_cast<const float*>(offset), offset_stride,
      static_cast<float*>(out), B, K, N);
}

}  // namespace

REPRO_ERROR_STRING_FN

// lhs (B, K) in lhs_dtype, rhs (K, N) in rhs_dtype, scale/offset f32 of N
// entries (stride 1) or one (stride 0) → out (B, N) f32.  Pairs: int8 ×
// int8 (int32 sums), and f32 × {f32, bf16} (float32 sums).  Returns
// cudaGetLastError() after the launch.
extern "C" int lut_aggregate_launch(const void* lhs, int lhs_dtype,
                                    const void* rhs, int rhs_dtype,
                                    const void* scale, int scale_stride,
                                    const void* offset, int offset_stride,
                                    void* out, int B, int K, int N,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_AGG(L, R) \
  launch<L, R>(lhs, rhs, scale, scale_stride, offset, offset_stride, out, B, K, N, s)
  if (lhs_dtype == kI8 && rhs_dtype == kI8) {
    REPRO_AGG(int8_t, int8_t);
  } else if (lhs_dtype == kF32 && rhs_dtype == kF32) {
    REPRO_AGG(float, float);
  } else if (lhs_dtype == kF32 && rhs_dtype == kBF16) {
    REPRO_AGG(float, __nv_bfloat16);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_AGG
  return static_cast<int>(cudaGetLastError());
}
