// Fused speculative-verify window attention for Hopper: page gather + all
// W = k+1 masked attends of a row in one kernel.
//
// Replaces: repro/kernels/fused_verify.py::verify_window_attend_pallas
// (_verify_window_kernel), the TPU kernel that DMAs a row's K/V pages into
// VMEM block_s positions at a time and computes all W attends from the
// staged copy.
//
// What bounds it on this card: device-memory bytes.  Per (row, kv head) the
// work is 2·(W·g)·hd multiply-adds per reachable cache position against
// 2·hd cache elements read, i.e. about W·g = 25 operations per byte at
// full width (bf16) — far below the ≈ 295 the tensor cores need.  The bound
// is the bytes of the K/V positions the rows' masks can reach (causal
// kv_pos <= pos+j, window kv_pos > pos+j-win), plus q and out, over
// 3.35 TB/s.
//
// What the design does about it: each position's K and V are read from
// device memory once per (row, head), straight through the page table:
// the gathered (B, S, n_kv, hd) view never exists in device memory, and
// positions no window row can reach are never read.  One block per
// (kv head, batch row); it stages kTileS positions of K (then of V) into
// shared memory, padded by one word per position so that the 32 lanes of a
// warp, one position each, hit 32 banks.  The W·g logit rows are kept whole
// (shared memory when they fit, else a float32 scratch the wrapper
// allocates) for one flat softmax per row over the full row, as the plain
// version computes it; then A·V is summed tile by tile.  Masked logits are
// -1e30, not -inf, as in the reference.  Float caches round the weights to
// the cache's type before the value product (bf16 KV multiplies bf16
// weights); int8 caches quantise q (sq = max|q|/127 + 1e-9) and the weights
// (rint(w·127) in [0, 127]) and sum both products in int32, which is exact
// in any order — the only difference from the plain version is where a
// weight's float rounding (expf, the sum's order) lands it on the
// neighbouring int8 step.  The int8 rescales use __fmul_rn / __fdiv_rn in
// the plain version's association so nvcc cannot contract or reorder them.
// 32 blocks at full width (B=4, n_kv=8) fill a quarter of the SMs: a split
// over S, cp.async staging and tensor cores are later work.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileS = 32;              // cache positions staged at once
constexpr int kStageLoads = 16;         // loads a thread keeps in flight
constexpr float kNegInf = -1e30f;
constexpr float kKvInt8Scale = 0.05f;   // fused_verify.py KV_INT8_SCALE
constexpr float kOutScale = static_cast<float>(0.05 / 127.0);
constexpr size_t kMaxSmem = 232448;     // 227 KB a block may use

template <typename T> struct KV { using acc = float; };
template <> struct KV<int8_t> { using acc = int; };

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ int widen(int8_t v) { return static_cast<int>(v); }

// the softmax weight rounded to the cache's type (the plain version's
// w.to(cache_v.dtype))
__device__ __forceinline__ float round_to(float w, const float*) { return w; }
__device__ __forceinline__ float round_to(float w, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(w));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Stage positions t0 .. t0+kTileS of head n into kv_s (row stride hd+1),
// read through the page table; positions past nt are zero.  Each thread
// issues kStageLoads independent loads before it stores any, so the block
// keeps that many loads per thread in flight instead of one.
template <typename T, typename Acc>
__device__ __forceinline__ void stage(const T* __restrict__ pages,
                                      const int* pt_s, Acc* kv_s, int t0,
                                      int nt, int n, int nkv, int hd, int ps) {
  const int total = kTileS * hd;
  for (int base = threadIdx.x; base < total; base += kThreads * kStageLoads) {
    Acc v[kStageLoads];
#pragma unroll
    for (int i = 0; i < kStageLoads; ++i) {
      const int e = base + i * kThreads;
      const int t = e / hd, d = e - t * hd;
      v[i] = 0;
      if (e < total && t < nt) {
        const int p = t0 + t;
        const size_t page = static_cast<size_t>(pt_s[p / ps]);
        v[i] = widen(pages[((page * ps + p % ps) * nkv + n) * hd + d]);
      }
    }
#pragma unroll
    for (int i = 0; i < kStageLoads; ++i) {
      const int e = base + i * kThreads;
      const int t = e / hd, d = e - t * hd;
      if (e < total) kv_s[t * (hd + 1) + d] = v[i];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
verify_window_kernel(const float* __restrict__ q, const T* __restrict__ kp,
                     const T* __restrict__ vp, const int* __restrict__ pt,
                     const int* __restrict__ pos_arr, float* __restrict__ out,
                     float* __restrict__ scratch, int W, int nkv, int g,
                     int hd, int ps, int max_pages, int win, int lg_in_smem) {
  using Acc = typename KV<T>::acc;
  constexpr bool kInt8 = sizeof(T) == 1;
  const int n = blockIdx.x, b = blockIdx.y;
  const int R = W * g, S = ps * max_pages;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ __align__(16) unsigned char smem[];
  int* pt_s = reinterpret_cast<int*>(smem);
  Acc* q_s = reinterpret_cast<Acc*>(pt_s + max_pages);
  float* coef_s = reinterpret_cast<float*>(q_s + R * hd);
  Acc* kv_s = reinterpret_cast<Acc*>(coef_s + R);
  Acc* acc_s = kv_s + kTileS * (hd + 1);
  float* w_s = reinterpret_cast<float*>(acc_s + R * hd);  // one tile's weights
  float* lg = lg_in_smem ? w_s + R * kTileS
                         : scratch + (static_cast<size_t>(b) * nkv + n) * R * S;
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(hd)));

  for (int i = tid; i < max_pages; i += kThreads)
    pt_s[i] = pt[static_cast<size_t>(b) * max_pages + i];
  for (int e = tid; e < R * hd; e += kThreads) acc_s[e] = 0;
  // q rows r = j·g + gi of (b, ·, n, ·, ·), one warp per row
  for (int r = warp; r < R; r += kWarps) {
    const int j = r / g, gi = r - j * g;
    const float* qr = q + (((static_cast<size_t>(b) * W + j) * nkv + n) * g + gi) * hd;
    if constexpr (kInt8) {
      float m = 0.f;
      for (int d = lane; d < hd; d += 32) m = fmaxf(m, fabsf(qr[d]));
      m = warp_max(m);
      const float sq = __fadd_rn(__fdiv_rn(m, 127.0f), 1e-9f);
      for (int d = lane; d < hd; d += 32) {
        const float v = rintf(__fdiv_rn(qr[d], sq));
        q_s[r * hd + d] = static_cast<int>(fminf(fmaxf(v, -127.f), 127.f));
      }
      if (lane == 0) coef_s[r] = __fmul_rn(__fmul_rn(sq, kKvInt8Scale), scale);
    } else {
      for (int d = lane; d < hd; d += 32) q_s[r * hd + d] = qr[d];
    }
  }

  // positions any window row can reach; all of [0, S) when a row's mask
  // is empty (its softmax is then uniform over the whole row, as in the
  // plain version)
  const long long p0 = pos_arr[b];
  bool empty = false;
  for (int j = 0; j < W; ++j) {
    const long long lower = max(0LL, p0 + j - win + 1);
    const long long upper = min(static_cast<long long>(S) - 1, p0 + j);
    empty |= lower > upper;
  }
  const int lo = empty ? 0 : static_cast<int>(max(0LL, p0 - win + 1));
  const int hi = empty ? S : static_cast<int>(min(static_cast<long long>(S) - 1,
                                                  p0 + W - 1) + 1);
  __syncthreads();

  // QK: lane = position of the tile, warp = query rows
  for (int t0 = lo; t0 < hi; t0 += kTileS) {
    const int nt = min(kTileS, hi - t0);
    stage(kp, pt_s, kv_s, t0, nt, n, nkv, hd, ps);
    __syncthreads();
    if (lane < nt) {
      const long long kvp = t0 + lane;
      const Acc* kr = kv_s + lane * (hd + 1);
      for (int r = warp; r < R; r += kWarps) {
        const Acc* qr = q_s + r * hd;
        Acc s = 0;
#pragma unroll 8
        for (int d = 0; d < hd; ++d) s += qr[d] * kr[d];
        float l;
        if constexpr (kInt8) {
          l = __fmul_rn(__int2float_rn(s), coef_s[r]);
        } else {
          l = __fmul_rn(s, scale);
        }
        const long long pj = p0 + r / g;
        const bool ok = kvp <= pj && kvp > pj - win;
        lg[static_cast<size_t>(r) * S + kvp] = ok ? l : kNegInf;
      }
    }
    __syncthreads();
  }

  // one flat softmax per query row over the reachable positions (the rest
  // of the row has weight exactly 0 in the plain version)
  for (int r = warp; r < R; r += kWarps) {
    float* row = lg + static_cast<size_t>(r) * S;
    float m = kNegInf;
    for (int t = lo + lane; t < hi; t += 32) m = fmaxf(m, row[t]);
    m = warp_max(m);
    float sum = 0.f;
    for (int t = lo + lane; t < hi; t += 32) {
      const float e = expf(__fsub_rn(row[t], m));
      row[t] = e;
      sum = __fadd_rn(sum, e);
    }
    sum = warp_sum(sum);
    for (int t = lo + lane; t < hi; t += 32) {
      const float w = __fdiv_rn(row[t], sum);
      if constexpr (kInt8) {
        row[t] = fminf(fmaxf(rintf(__fmul_rn(w, 127.0f)), 0.f), 127.f);
      } else {
        row[t] = round_to(w, static_cast<const T*>(nullptr));
      }
    }
  }
  __syncthreads();

  // AV: each thread owns (row, d) sums in shared memory across tiles; the
  // tile's weights are staged beside its V (zero past nt, where V is zero
  // too, so the unrolled sum adds exact zeros)
  for (int t0 = lo; t0 < hi; t0 += kTileS) {
    const int nt = min(kTileS, hi - t0);
    stage(vp, pt_s, kv_s, t0, nt, n, nkv, hd, ps);
    for (int e = tid; e < R * kTileS; e += kThreads) {
      const int r = e / kTileS, t = e - r * kTileS;
      w_s[e] = t < nt ? lg[static_cast<size_t>(r) * S + t0 + t] : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < R * hd; e += kThreads) {
      const int r = e / hd, d = e - r * hd;
      const float* wr = w_s + r * kTileS;
      Acc a = acc_s[e];
#pragma unroll
      for (int t = 0; t < kTileS; ++t) {
        if constexpr (kInt8) {
          a += static_cast<int>(wr[t]) * kv_s[t * (hd + 1) + d];
        } else {
          a = fmaf(wr[t], kv_s[t * (hd + 1) + d], a);
        }
      }
      acc_s[e] = a;
    }
    __syncthreads();
  }

  for (int e = tid; e < R * hd; e += kThreads) {
    const int r = e / hd, d = e - r * hd;
    const int j = r / g, gi = r - j * g;
    float o;
    if constexpr (kInt8) {
      o = __fmul_rn(__int2float_rn(acc_s[e]), kOutScale);
    } else {
      o = acc_s[e];
    }
    out[(((static_cast<size_t>(b) * W + j) * nkv + n) * g + gi) * hd + d] = o;
  }
}

template <typename T>
int launch(const void* q, const void* kp, const void* vp, const void* pt,
           const void* pos, void* out, void* scratch, int B, int W, int nkv,
           int g, int hd, int ps, int max_pages, int win, int lg_in_smem,
           cudaStream_t stream) {
  const size_t R = static_cast<size_t>(W) * g;
  const size_t S = static_cast<size_t>(ps) * max_pages;
  const size_t words = max_pages + 2 * R * hd + R +
                       static_cast<size_t>(kTileS) * (hd + 1) + R * kTileS +
                       (lg_in_smem ? R * S : 0);
  const size_t bytes = words * 4;
  if (bytes > kMaxSmem || (!lg_in_smem && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        verify_window_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid(nkv, B);
  verify_window_kernel<T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const int*>(pt),
      static_cast<const int*>(pos), static_cast<float*>(out),
      static_cast<float*>(scratch), W, nkv, g, hd, ps, max_pages, win,
      lg_in_smem);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

REPRO_ERROR_STRING_FN

// q (B, W, nkv, g, hd) f32; k/v pages (P, ps, nkv, hd) in kv_dtype; page
// table (B, max_pages) int32; pos (B,) int32; out (B, W, nkv, g, hd) f32;
// scratch (B, nkv, W·g, ps·max_pages) f32, unused when lg_in_smem.
// Returns cudaGetLastError() after the launch.
extern "C" int verify_window_launch(const void* q, const void* kp,
                                    const void* vp, int kv_dtype,
                                    const void* pt, const void* pos, void* out,
                                    void* scratch, int B, int W, int nkv,
                                    int g, int hd, int ps, int max_pages,
                                    int win, int lg_in_smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kv_dtype) {
    case kF32:
      return launch<float>(q, kp, vp, pt, pos, out, scratch, B, W, nkv, g, hd,
                           ps, max_pages, win, lg_in_smem, s);
    case kBF16:
      return launch<__nv_bfloat16>(q, kp, vp, pt, pos, out, scratch, B, W, nkv,
                                   g, hd, ps, max_pages, win, lg_in_smem, s);
    case kI8:
      return launch<int8_t>(q, kp, vp, pt, pos, out, scratch, B, W, nkv, g, hd,
                            ps, max_pages, win, lg_in_smem, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
