// LUT aggregation (B, K) × (K, N) + dequant epilogue for Hopper, summed over
// the left operand's nonzero entries only.
//
// Replaces: repro/kernels/lut_aggregate.py::lut_aggregate_pallas
// (_matmul_kernel), the TPU kernel that tiles the one-hot × LUT contraction
// over (B, N, K) on the MXU and accumulates over the K grid axis.
//
// What bounds it on this card: device-memory bytes.  The left operand of
// the serving path is a one-hot (one nonzero per codebook and row), so a
// row needs one LUT row of N entries per codebook: at most min(B, G)·C·N
// LUT bytes, and B·C·N adds.  A dense product would read the whole C·G·N
// table (G times the bytes at decode) and multiply by zeros, and its adds
// are far below the tensor cores' rate anyway.
//
// What the design does about it: it does what the plain version does and
// sums only the nonzero entries.  A block owns kRows rows, one N-tile of
// kThreads·V columns (V = 16 bytes of LUT per thread) and a slice of K.  It
// walks its slice kChunk entries at a time: each warp compacts one row's
// nonzero entries (k, value) into shared memory, every lane loading its 16
// entries at once and a warp prefix count placing them (in k order, so the
// sums are deterministic).  Then every thread streams those LUT rows with
// 16-byte loads (load_row_raw, common.cuh), the rows in
// step along k with 8 loads in flight, kept raw and widened to int32 (int8
// tables with an int8 left operand) or float32 (a float32 left operand
// with float32, bfloat16 or int16 tables) only as each is added with its
// value: widened in flight, the int8 instance needed 245
// registers, which let too few blocks stay resident for one wave.
// Skipping an exact zero never changes a finite sum, so any left operand
// is taken, as the TPU kernel takes one: a dense one just has more
// entries.  Decode batches leave few (row, N-tile) blocks, so K is split
// over gridDim.z, and the splits' partial sums go through the fixed-order
// reduce + epilogue pass (common.cuh); with one
// split the kernel applies the epilogue itself.  Row blocks and N-tiles
// share grid.x (row block major): grid.y's 65,535 would cap the rows at
// 262,140, which a Kn2col tap of a CNN batch passes.

#include "common.cuh"

namespace {

constexpr int kThreads = 64;   // threads per block (kernels/lut_aggregate.py)
constexpr int kRows = 4;       // output rows per block
constexpr int kPerLane = 16;   // K entries a lane compacts per pass
constexpr int kChunk = 32 * kPerLane;  // K entries compacted per pass
constexpr int kStep = 2;       // entries per row loaded at once: kStep·kRows
                               // LUT rows in flight per thread

// acc + w·x with two roundings in float, as the plain version's product
// then index_add_; exact in int32
__device__ __forceinline__ int madd(int acc, int w, int x) { return acc + w * x; }
__device__ __forceinline__ float madd(float acc, float w, float x) {
  return __fadd_rn(acc, __fmul_rn(w, x));
}

template <typename L, typename T>
__global__ void __launch_bounds__(kThreads)
lut_aggregate_kernel(const L* __restrict__ lhs, const T* __restrict__ lut,
                     const float* __restrict__ scale, int scale_stride,
                     const float* __restrict__ offset, int offset_stride,
                     float* __restrict__ out,
                     typename LutAcc<L>::type* __restrict__ partial, int B,
                     int K, int N, int k_per_split, bool vec_ok) {
  using A = typename LutAcc<L>::type;  // int32 for int8 × int8, else float32
  constexpr int V = 16 / sizeof(T);
  __shared__ int ks[kRows][kChunk];
  __shared__ A vs[kRows][kChunk];
  __shared__ int cnt[kRows];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tiles = (N + kThreads * V - 1) / (kThreads * V);
  const int tile = static_cast<int>(blockIdx.x) % tiles;
  const int b0 = static_cast<int>(blockIdx.x) / tiles * kRows;
  const int rows = min(kRows, B - b0);
  const int k0 = blockIdx.z * k_per_split;
  const int k1 = min(K, k0 + k_per_split);
  const int n0 = (tile * kThreads + static_cast<int>(threadIdx.x)) * V;
  const bool active = n0 < N;
  const int n_left = N - n0;
  const bool full = vec_ok && n_left >= V;

  A acc[kRows][V];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int i = 0; i < V; ++i) acc[r][i] = 0;

  for (int kc = k0; kc < k1; kc += kChunk) {
    const int kc1 = min(k1, kc + kChunk);
    // compact: one warp per row, entries in k order; lane i holds the 16
    // entries [kc + 16·i, kc + 16·i + 16), all loaded before any is used,
    // and a warp prefix count places them
    for (int r = warp; r < kRows; r += kThreads / 32) {
      int count = 0;
      if (r < rows) {
        const L* lr = lhs + static_cast<size_t>(b0 + r) * K;
        const int kl = kc + kPerLane * lane;
        L v[kPerLane];
#pragma unroll
        for (int i = 0; i < kPerLane; ++i) v[i] = kl + i < kc1 ? lr[kl + i] : L(0);
        int mine = 0;
#pragma unroll
        for (int i = 0; i < kPerLane; ++i) mine += v[i] != L(0);
        int before = mine;  // inclusive prefix over the lanes
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int x = __shfl_up_sync(0xffffffffu, before, o);
          if (lane >= o) before += x;
        }
        count = __shfl_sync(0xffffffffu, before, 31);
        int at = before - mine;
#pragma unroll
        for (int i = 0; i < kPerLane; ++i) {
          if (v[i] != L(0)) {
            ks[r][at] = kl + i;
            vs[r][at] = static_cast<A>(v[i]);
            ++at;
          }
        }
      }
      if (lane == 0) cnt[r] = count;
    }
    __syncthreads();
    if (active) {
      // the rows walk their entries together, in step along k, so the
      // blocks of one K slice fetch each LUT row while it is in L2; each
      // row's sum runs in its own entry order
      int c[kRows];
      int most = 0;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        c[r] = r < rows ? cnt[r] : 0;
        most = max(most, c[r]);
      }
      for (int e = 0; e < most; e += kStep) {
        // raw 16-byte rows, widened only as they are added: 4 registers a
        // load in flight instead of V
        uint4 raw[kStep][kRows];
#pragma unroll
        for (int u = 0; u < kStep; ++u)
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            if (e + u < c[r])
              raw[u][r] = load_row_raw(lut + static_cast<size_t>(ks[r][e + u]) * N + n0,
                                       full, n_left);
#pragma unroll
        for (int u = 0; u < kStep; ++u)
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            if (e + u < c[r]) {
              const A w = vs[r][e + u];
#pragma unroll
              for (int i = 0; i < V; ++i)
                acc[r][i] = madd(acc[r][i], w,
                                 static_cast<A>(lut_entry<T>(raw[u][r], i)));
            }
      }
    }
    __syncthreads();
  }

  if (!active) return;
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

template <typename L, typename T>
void launch(const void* lhs, const void* lut, const void* scale,
            int scale_stride, const void* offset, int offset_stride, void* out,
            void* partial, int B, int K, int N, int k_per_split, int splits,
            cudaStream_t stream) {
  using A = typename LutAcc<L>::type;
  constexpr int V = 16 / sizeof(T);
  const int cols = kThreads * V;
  const bool vec_ok = (N % V == 0) &&
                      (reinterpret_cast<uintptr_t>(lut) % 16 == 0);
  // the wrapper keeps the grid's blocks below 2**31
  const unsigned blocks = static_cast<unsigned>(((N + cols - 1) / cols) *
                                                ((B + kRows - 1) / kRows));
  dim3 grid(blocks, 1, splits);
  lut_aggregate_kernel<L, T><<<grid, kThreads, 0, stream>>>(
      static_cast<const L*>(lhs), static_cast<const T*>(lut),
      static_cast<const float*>(scale), scale_stride,
      static_cast<const float*>(offset), offset_stride,
      static_cast<float*>(out), static_cast<A*>(partial), B, K, N,
      k_per_split, vec_ok);
  if (splits > 1) {
    launch_reduce_epilogue<A>(static_cast<const A*>(partial), splits,
                              static_cast<const float*>(scale), scale_stride,
                              static_cast<const float*>(offset), offset_stride,
                              static_cast<float*>(out), B, N, stream);
  }
}

}  // namespace

REPRO_ERROR_STRING_FN

// lhs (B, K) in lhs_dtype, lut (K, N) in lut_dtype, scale/offset f32 of N
// entries (stride 1) or one (stride 0) → out (B, N) f32; partial (splits,
// B, N) int32 (int8 LUT) or f32, unused when splits == 1; split z sums
// K entries [z·k_per_split, (z+1)·k_per_split).  Pairs: int8 × int8 (int32
// sums), and f32 × {f32, bf16, int16} (float32 sums; with a one-hot and an
// int16 table every partial sum is an integer, exact while |sum| ≤ 2^24,
// so bit-equal to the plain version wherever C ≤ 512).  Returns cudaGetLastError()
// after the launches.
extern "C" int lut_aggregate_launch(const void* lhs, int lhs_dtype,
                                    const void* lut, int lut_dtype,
                                    const void* scale, int scale_stride,
                                    const void* offset, int offset_stride,
                                    void* out, void* partial, int B, int K,
                                    int N, int k_per_split, int splits,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_AGG(L, T)                                                      \
  launch<L, T>(lhs, lut, scale, scale_stride, offset, offset_stride, out,    \
               partial, B, K, N, k_per_split, splits, s)
  if (lhs_dtype == kI8 && lut_dtype == kI8) {
    REPRO_AGG(int8_t, int8_t);
  } else if (lhs_dtype == kF32 && lut_dtype == kF32) {
    REPRO_AGG(float, float);
  } else if (lhs_dtype == kF32 && lut_dtype == kBF16) {
    REPRO_AGG(float, __nv_bfloat16);
  } else if (lhs_dtype == kF32 && lut_dtype == kI16) {
    REPRO_AGG(float, int16_t);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_AGG
  return static_cast<int>(cudaGetLastError());
}
