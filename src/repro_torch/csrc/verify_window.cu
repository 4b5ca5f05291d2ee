// Fused speculative-verify window attention for Hopper: page gather + all
// W = k+1 masked attends of a row, split over the cache positions.
//
// Replaces: repro/kernels/fused_verify.py::verify_window_attend_pallas
// (_verify_window_kernel), the TPU kernel that DMAs a row's K/V pages into
// VMEM block_s positions at a time and computes all W attends from the
// staged copy with one flat softmax per query row.  At W = 1 it is also
// the paged decode step's read on the card (kernels/fused_verify.py::
// decode_attend_paged_cuda), which the JAX package computes with plain
// jnp over the gathered view (repro/models/attention.py::_decode_attend).
//
// What bounds it on this card: device-memory bytes.  Per (row, kv head) the
// work is 2·(W·g)·hd multiply-adds per reachable cache position against
// 2·hd cache elements read, about W·g = 25 operations per byte at full
// width (bf16), far below the ≈ 295 where the tensor cores become the
// limit.  The bound is the bytes of the K/V positions the rows' masks can
// reach (causal kv_pos <= pos+j, window kv_pos > pos+j-win), plus q and
// out, over 3.35 TB/s.  To reach it the kernel must keep many SMs pulling
// K/V at once, with enough bytes in flight on each.
//
// What the design does about it:
// * Split over S.  Each (kv head, batch row, ≤ 32 query rows) is a cluster
//   of `nsplit` ≤ 8 blocks (gridDim.x, one per 512 positions of a row, or
//   fewer when that lets every cluster run in one wave); block i takes the
//   i-th slice of the reachable range [lo, hi), which it derives from pos
//   on the device (the wrapper fixes nsplit from S and the grid shape, so
//   the host never reads pos).  Full width at S = 4096 puts every SM to
//   work.
// * One flat softmax per row, as the plain version: each block keeps its
//   slice's logits (shared memory, or a float32 scratch for very long
//   rows), the blocks exchange row maxima and then row sums through
//   distributed shared memory with cluster barriers, and only then is any
//   weight formed and rounded (to bf16, or to an int8 step).  The partial
//   A·V sums are added in split order through distributed shared memory:
//   exact on int32, deterministic on float32.  A block whose slice is empty
//   takes part with -inf, 0 and zero sums.
// * Staging: a ring of cp.async 16-byte copies of each position's head
//   slice (K tiles, then V tiles, one continuous pipeline; 26-37 KB in
//   flight per block), with the slice's page ids read once into shared
//   memory.
// * Tensor cores through mma.sync for int8 KV (m16n8k32 s8 → s32) and for
//   bf16 KV whose rows are split (m16n8k16 bf16 → f32).  The 32 query rows
//   (W·g = 25 zero-padded) are the n side of QK and the m side of A·V.
//   int8: q quantised per row (sq = max|q|/127 + 1e-9), weights
//   rint(w·127) in [0, 127], V transposed while it is staged (sm_90 has no
//   8-bit ldmatrix transpose); integer sums are exact in any order.  bf16:
//   float32 q split into three bf16 terms that sum to it exactly, so every
//   product is exact (only the first term when q holds bf16 values, as on
//   the serve path).
// * float32 KV, and bf16 KV whose row one block holds whole (S ≤ 512, the
//   serve path's rows), on the CUDA cores in the plain version's order:
//   each logit is one FMA chain over the head dim and each output one FMA
//   chain over the positions (2×2 and 4×4 register tiles over 16-byte
//   shared loads, bf16 widened on load).  Tensor-core sums round in
//   another order; on the serve path that moved a few outputs by a last
//   bit, enough to change a 40-layer model's logits through its LUT
//   encoders, where this order leaves them bit-identical to the plain
//   path's.  A split row is summed in split order anyway.
// * A CUDA-core block of at most 8 query rows (the paged decode read, the
//   verify kernel at W = 1: g = 5 rows) maps its threads onto those rows
//   alone, one logit and four outputs a thread, instead of 2×2 and 4×4
//   tiles over 32 padded rows.  At B = 32 rows of up to 1,024 positions
//   (bf16, one split) that took the read from 0.144 to 0.085 ms, and to
//   0.101 ms (4.4 × its bound) with the chunked sums below.  Its sums
//   follow the plain decode read's library calls at the
//   decode shapes, which sum each logit as one FMA chain over the head dim
//   but each output in 256-position chunks (kAvChunk): the served model's
//   logits then equal a plain reference's bit for bit, where one ulp of an
//   attention output can move a LUT-MU tree encode to another table row.
// Masked logits are -1e30, not -inf, as in the reference: a row whose mask
// is empty widens the range to [0, S) and gets a uniform softmax.  The int8
// rescales use __fmul_rn / __fdiv_rn in the plain version's association so
// nvcc cannot contract or reorder them.

#include <cooperative_groups.h>

#include <algorithm>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileS = 32;              // cache positions per staged tile
constexpr int kRowsBlk = 32;            // query rows one block holds
constexpr int kFewRows = kThreads / 32;  // rows of a block in the few-row roles
// the few-row roles sum a value product as the plain read's library call
// does at the paged decode shapes (cuBLAS gemmSN_NN on B = 32 rows of
// 1,024 and 1,536 positions; its tree read off by probes of M, -M and
// ones): the positions [0, S) in two halves, each half in chunks of
// kAvChunk, each chunk one FMA chain in order, a half's chunks added in
// order, then half 0 + half 1
constexpr int kAvChunk = 256;
constexpr int kMaxSplits = 8;           // portable cluster size
constexpr float kNegInf = -1e30f;       // the reference's mask value
constexpr float kKvInt8Scale = 0.05f;   // fused_verify.py KV_INT8_SCALE
constexpr float kOutScale = static_cast<float>(0.05 / 127.0);
constexpr size_t kMaxSmem = 232448;     // 227 KB a block may use
static_assert(kThreads / kTileS == 8, "staging maps 8 threads to a position");

// Shared-memory layout of one block (bytes; every region 16-byte aligned):
// small per-row arrays, the slice's page ids, the cp.async ring, the
// weight tile, int8 V transposed, float32 q (CUDA-core path), then the
// union of the logits, the tensor cores' q staging and the partial sums.
// TC: bf16 KV on the tensor cores (int8 always is; float32 never).
template <typename T, int HDP, bool TC>
struct Layout {
  static constexpr int kElt = sizeof(T);
  static constexpr bool kInt8 = kElt == 1;
  static constexpr bool kMma = kInt8 || (kElt == 2 && TC);
  // ring depth: 26-37 KB of tiles in flight per block
  static constexpr int kStages = kElt == 4 ? 2 : kElt == 2 ? 4 : 8;
  static constexpr int kRowBytes = HDP * kElt + 16;  // one staged position
  static constexpr int kStageBytes = kTileS * kRowBytes;
  // q: int8 or three bf16 terms for the tensor cores, float32 otherwise
  static constexpr int kQTerms = kMma && !kInt8 ? 3 : 1;
  static constexpr int kQRowBytes = kInt8 ? HDP + 16 : kMma ? 2 * HDP + 16 : 4 * HDP + 16;
  static constexpr int kQBytes = kQTerms * kRowsBlk * kQRowBytes;
  // one tile's weights in the value product's type (float32 on the CUDA
  // cores, rounded to bf16 for bf16 KV)
  static constexpr int kWElt = kMma ? kElt : 4;
  static constexpr int kWRowBytes = kTileS * kWElt + 16;
  static constexpr int kWBytes = kRowsBlk * kWRowBytes;
  // int8 V transposed to (head dim, positions)
  static constexpr int kVtRowBytes = kTileS + 16;
  static constexpr int kVtBytes = kInt8 ? HDP * kVtRowBytes : 0;
  static constexpr int kPartBytes = kRowsBlk * HDP * 4;
  static constexpr int kSmallBytes = 4 * kRowsBlk * 4;
  // bytes of the regions after the page ids and before the union
  static constexpr int kMidBytes = kStages * kStageBytes + kWBytes + kVtBytes +
                                   (kMma ? 0 : kQBytes);
};

// bytes of the page ids a slice of at most cap positions spans
__host__ __device__ __forceinline__ int page_id_bytes(int cap, int ps) {
  return ((cap / ps + 2) * 4 + 15) / 16 * 16;
}

template <typename T> struct KV { using acc = float; };
template <> struct KV<int8_t> { using acc = int; };

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)) : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)) : "memory");
}

// D = A·B + D, m16n8k16, bf16 inputs, float32 sums
__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// D = A·B + D, m16n8k32, int8 inputs, int32 sums
__device__ __forceinline__ void mma(int (&c)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// the normalised softmax weight in the value product's type: int8 steps
// rint(w·127) in [0, 127]; float caches round it to the cache's type (the
// plain version's w.to(cache_v.dtype)) and keep it as float32
__device__ __forceinline__ float round_to(float w, float) { return w; }
__device__ __forceinline__ float round_to(float w, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(w));
}
__device__ __forceinline__ int8_t int8_step(float w) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(__fmul_rn(w, 127.0f)), 0.f), 127.f));
}

// a chunk's four sums added to the first or the second half's (register
// indices fixed at compile time)
__device__ __forceinline__ void add_to_half(float (&halves)[2][4], const float (&c)[4],
                                            bool first) {
  if (first) {
#pragma unroll
    for (int h = 0; h < 4; ++h) halves[0][h] = __fadd_rn(halves[0][h], c[h]);
  } else {
#pragma unroll
    for (int h = 0; h < 4; ++h) halves[1][h] = __fadd_rn(halves[1][h], c[h]);
  }
}

// float32 values of 8 (16-byte aligned) or 4 (8-byte aligned) cache entries
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(e[i]);
}
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = __bfloat162float(e[i]);
}

template <typename T, int HDP, bool TC>
__global__ void __launch_bounds__(kThreads, HDP <= 128 ? 2 : 1)
verify_window_kernel(const float* __restrict__ q, const T* __restrict__ kp,
                     const T* __restrict__ vp, const int* __restrict__ pt,
                     const int* __restrict__ pos_arr, float* __restrict__ out,
                     float* __restrict__ scratch, int W, int nkv, int g,
                     int hd, int ps, int max_pages, int win, int cap,
                     int lg_in_smem) {
  using Lay = Layout<T, HDP, TC>;
  using Acc = typename KV<T>::acc;
  constexpr bool kInt8 = Lay::kInt8;
  constexpr bool kMma = Lay::kMma;
  constexpr bool kTcBf16 = kMma && !kInt8;
  constexpr int kStages = Lay::kStages;
  constexpr int KSB = HDP * static_cast<int>(sizeof(T)) / 32;  // 32-byte k steps
  constexpr int NTW = HDP / 32;  // n8 tiles (mma) or rows (CUDA cores) per thread

  cg::cluster_group cluster = cg::this_cluster();
  const int nsplit = static_cast<int>(cluster.num_blocks());
  const int split = static_cast<int>(cluster.block_rank());
  const int n = blockIdx.y % nkv, b = blockIdx.z;
  const int R = W * g, r0 = (blockIdx.y / nkv) * kRowsBlk;
  const int RB = min(kRowsBlk, R - r0);
  const int S = ps * max_pages;
  // a CUDA-core block of at most 8 query rows (a decode read, W = 1): its
  // threads map onto those rows alone
  const bool few = !kMma && RB <= kFewRows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lstride = cap + 4;

  // reachable positions [lo, hi): all of [0, S) when a row's mask is empty
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
  // this block's slice [a, a + len) (kernels/fused_verify.py::split_slice)
  const int chunk = ((hi - lo + nsplit - 1) / nsplit + kTileS - 1) / kTileS * kTileS;
  const int a = min(hi, lo + split * chunk);
  const int len = min(hi, a + chunk) - a;
  const int ntiles = (len + kTileS - 1) / kTileS;

  extern __shared__ __align__(16) unsigned char smem[];
  float* smax = reinterpret_cast<float*>(smem);
  float* ssum = smax + kRowsBlk;
  float* gsum = ssum + kRowsBlk;
  float* coef = gsum + kRowsBlk;
  int* pts = reinterpret_cast<int*>(smem + Lay::kSmallBytes);
  unsigned char* ring = smem + Lay::kSmallBytes + page_id_bytes(cap, ps);
  unsigned char* wtile = ring + kStages * Lay::kStageBytes;
  unsigned char* vt = wtile + Lay::kWBytes;
  unsigned char* uni = vt + Lay::kVtBytes + (kMma ? 0 : Lay::kQBytes);
  unsigned char* qbuf = kMma ? uni : vt + Lay::kVtBytes;
  float* lg = lg_in_smem
                  ? reinterpret_cast<float*>(uni)
                  : scratch + ((static_cast<size_t>(b) * gridDim.y + blockIdx.y) *
                                   nsplit + split) * kRowsBlk * lstride;
  Acc* part = reinterpret_cast<Acc*>(uni);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(hd)));

  // the slice's page ids, read once
  const int pfirst = a / ps;
  const int npages = len > 0 ? (a + len - 1) / ps - pfirst + 1 : 0;
  for (int i = tid; i < npages; i += kThreads)
    pts[i] = __ldg(pt + static_cast<size_t>(b) * max_pages + pfirst + i);

  // zero the ring's padding columns once (cp.async never writes them)
  const int real_bytes = hd * static_cast<int>(sizeof(T));
  const int pad_words = (HDP * static_cast<int>(sizeof(T)) - real_bytes) / 4;
  for (int e = tid; e < kStages * kTileS * pad_words; e += kThreads) {
    const int row = e / pad_words, w = e - row * pad_words;
    *reinterpret_cast<unsigned*>(ring + row * Lay::kRowBytes + real_bytes + 4 * w) = 0u;
  }

  // stage q: rows r = j·g + gi of (b, ·, n, ·, ·), zero past RB and hd
  int nterms = 1;
  auto q_row = [&](int r) {
    const int ra = r0 + r, j = ra / g, gi = ra - j * g;
    return q + (((static_cast<size_t>(b) * W + j) * nkv + n) * g + gi) * hd;
  };
  if constexpr (kInt8) {
    // one warp per row, the row held in registers: q_i8 = rint(q / sq)
    for (int r = warp; r < kRowsBlk; r += kWarps) {
      int8_t* dst = reinterpret_cast<int8_t*>(qbuf + r * Lay::kQRowBytes);
      float v[HDP / 32];
      float m = 0.f;
#pragma unroll
      for (int i = 0; i < HDP / 32; ++i) {
        const int d = lane + 32 * i;
        v[i] = (r < RB && d < hd) ? q_row(r)[d] : 0.f;
        m = fmaxf(m, fabsf(v[i]));
      }
      m = warp_max(m);
      const float sq = __fadd_rn(__fdiv_rn(m, 127.0f), 1e-9f);
#pragma unroll
      for (int i = 0; i < HDP / 32; ++i)
        dst[lane + 32 * i] = static_cast<int8_t>(
            fminf(fmaxf(rintf(__fdiv_rn(v[i], sq)), -127.f), 127.f));
      if (lane == 0) coef[r] = __fmul_rn(__fmul_rn(sq, kKvInt8Scale), scale);
    }
  } else {
    // 16-byte loads, all issued before any store; the tensor cores take q
    // as three bf16 terms hi + mid + lo that sum to it exactly
    // (kernels/fused_verify.py::split_bf16_terms)
    constexpr int kQ4 = kRowsBlk * HDP / 4 / kThreads;
    float4 v[kQ4];
#pragma unroll
    for (int i = 0; i < kQ4; ++i) {
      const int e = tid + i * kThreads, r = e / (HDP / 4), d = 4 * (e % (HDP / 4));
      v[i] = (r < RB && d < hd) ? *reinterpret_cast<const float4*>(q_row(r) + d)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    bool lower = false;
#pragma unroll
    for (int i = 0; i < kQ4; ++i) {
      const int e = tid + i * kThreads, r = e / (HDP / 4), d = 4 * (e % (HDP / 4));
      if constexpr (kTcBf16) {
        const float x[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const __nv_bfloat16 h = __float2bfloat16_rn(x[u]);
          const float r1 = __fsub_rn(x[u], __bfloat162float(h));
          const __nv_bfloat16 m = __float2bfloat16_rn(r1);
          const __nv_bfloat16 l = __float2bfloat16_rn(__fsub_rn(r1, __bfloat162float(m)));
          lower |= r1 != 0.f;
          __nv_bfloat16* row = reinterpret_cast<__nv_bfloat16*>(qbuf + r * Lay::kQRowBytes);
          row[d + u] = h;
          row[d + u + kRowsBlk * Lay::kQRowBytes / 2] = m;
          row[d + u + kRowsBlk * Lay::kQRowBytes] = l;
        }
      } else {
        *reinterpret_cast<float4*>(qbuf + r * Lay::kQRowBytes + 4 * d) = v[i];
      }
    }
    // bf16-valued q (the serve path's) needs only the first term
    if constexpr (kTcBf16) nterms = __syncthreads_or(lower) ? 3 : 1;
  }
  __syncthreads();

  // tensor-core QK warp roles: rows 8·nt.. (n side), positions 16·mt.. of
  // a tile; q's fragments stay in registers
  const int nt = warp & 3, mt = warp >> 2;
  unsigned qf[Lay::kQTerms][KSB][2];
  if constexpr (kMma) {
#pragma unroll
    for (int term = 0; term < Lay::kQTerms; ++term) {
      const unsigned char* base = qbuf + term * kRowsBlk * Lay::kQRowBytes +
                                  (8 * nt + (lane & 7)) * Lay::kQRowBytes +
                                  16 * (lane >> 3);
#pragma unroll
      for (int p = 0; p < KSB / 2; ++p) {
        unsigned r[4];
        ldsm_x4(r, base + 64 * p);
        qf[term][2 * p][0] = r[0];
        qf[term][2 * p][1] = r[1];
        qf[term][2 * p + 1][0] = r[2];
        qf[term][2 * p + 1][1] = r[3];
      }
    }
  }

  // one pipeline of 2·ntiles loads: K tiles, then V tiles; 8 threads copy
  // one position's head slice in 16-byte pieces
  const int cpr = real_bytes / 16;
  auto issue = [&](int ld) {
    const bool is_v = ld >= ntiles;
    const int t0 = a + (is_v ? ld - ntiles : ld) * kTileS;
    const int t = tid >> 3;
    unsigned char* dst = ring + (ld % kStages) * Lay::kStageBytes + t * Lay::kRowBytes;
    if (t0 + t < a + len) {
      const int p = t0 + t;
      const size_t page = static_cast<size_t>(pts[p / ps - pfirst]);
      const unsigned char* src = reinterpret_cast<const unsigned char*>(
          (is_v ? vp : kp) + ((page * ps + p % ps) * nkv + n) * hd);
      for (int c = tid & 7; c < cpr; c += 8) cp_async16(dst + 16 * c, src + 16 * c);
    } else {
      for (int c = tid & 7; c < cpr; c += 8)
        *reinterpret_cast<uint4*>(dst + 16 * c) = make_uint4(0u, 0u, 0u, 0u);
    }
  };
  const int total = 2 * ntiles;
  auto step = [&](int i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // load i landed; the stage of load i-1 is free
    if (i + kStages - 1 < total) issue(i + kStages - 1);
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total) issue(s);
    cp_async_commit();
  }

  auto store_logit = [&](int r, int t, float l) {
    const long long kvp = a + t;
    const long long pj = p0 + (r0 + r) / g;
    lg[static_cast<size_t>(r) * lstride + t] = (kvp <= pj && kvp > pj - win) ? l : kNegInf;
  };

  // QK
  for (int i = 0; i < ntiles; ++i) {
    step(i);
    const unsigned char* st = ring + (i % kStages) * Lay::kStageBytes;
    const int t0 = i * kTileS;
    const int nv = min(kTileS, len - t0);
    if constexpr (kMma) {
      if (8 * nt < RB && 16 * mt < nv) {
        Acc c[4] = {0, 0, 0, 0};
        const unsigned char* arow = st + (16 * mt + (lane & 15)) * Lay::kRowBytes +
                                    16 * (lane >> 4);
#pragma unroll
        for (int ks = 0; ks < KSB; ++ks) {
          unsigned af[4];
          ldsm_x4(af, arow + 32 * ks);
          mma(c, af, qf[0][ks][0], qf[0][ks][1]);
          if constexpr (kTcBf16) {
            if (nterms > 1) {
              mma(c, af, qf[1][ks][0], qf[1][ks][1]);
              mma(c, af, qf[2][ks][0], qf[2][ks][1]);
            }
          }
        }
        const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int t = 16 * mt + gq + (h >> 1) * 8;
          const int r = 8 * nt + 2 * tq + (h & 1);
          if (t < nv && r < RB) {
            if constexpr (kInt8) {
              store_logit(r, t0 + t, __fmul_rn(__int2float_rn(c[h]), coef[r]));
            } else {
              store_logit(r, t0 + t, __fmul_rn(c[h], scale));
            }
          }
        }
      }
    } else if (few) {
      // one logit a thread: row tid / 32, position tid % 32; the same FMA
      // chain over the head dim as below
      const int tr = warp, tp = lane;
      if (tr < RB && tp < nv) {
        const T* k0 = reinterpret_cast<const T*>(st + tp * Lay::kRowBytes);
        const float* q0 = reinterpret_cast<const float*>(qbuf + tr * Lay::kQRowBytes);
        float c = 0.f;
        for (int d = 0; d < hd; d += 8) {
          float ka[8], qa[8];
          load8(k0 + d, ka);
          load8(q0 + d, qa);
#pragma unroll
          for (int u = 0; u < 8; ++u) c = fmaf(qa[u], ka[u], c);
        }
        store_logit(tr, t0 + tp, __fmul_rn(c, scale));
      }
    } else {
      // positions tp, tp+16 × rows tr, tr+16; each logit one FMA chain over
      // the head dim in order, as the plain version's float32 product
      const int tp = tid & 15, tr = tid >> 4;
      if (tr < RB && tp < nv) {
        const T* k0 = reinterpret_cast<const T*>(st + tp * Lay::kRowBytes);
        const T* k1 = reinterpret_cast<const T*>(st + (tp + 16) * Lay::kRowBytes);
        const float* q0 = reinterpret_cast<const float*>(qbuf + tr * Lay::kQRowBytes);
        const float* q1 = reinterpret_cast<const float*>(qbuf + (tr + 16) * Lay::kQRowBytes);
        float c00 = 0.f, c01 = 0.f, c10 = 0.f, c11 = 0.f;
        for (int d = 0; d < hd; d += 8) {
          float ka[8], kb[8], qa[8], qb[8];
          load8(k0 + d, ka);
          load8(k1 + d, kb);
          load8(q0 + d, qa);
          load8(q1 + d, qb);
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            c00 = fmaf(qa[u], ka[u], c00);
            c01 = fmaf(qb[u], ka[u], c01);
            c10 = fmaf(qa[u], kb[u], c10);
            c11 = fmaf(qb[u], kb[u], c11);
          }
        }
        store_logit(tr, t0 + tp, __fmul_rn(c00, scale));
        if (tr + 16 < RB) store_logit(tr + 16, t0 + tp, __fmul_rn(c01, scale));
        if (tp + 16 < nv) {
          store_logit(tr, t0 + tp + 16, __fmul_rn(c10, scale));
          if (tr + 16 < RB) store_logit(tr + 16, t0 + tp + 16, __fmul_rn(c11, scale));
        }
      }
    }
  }
  __syncthreads();

  // one flat softmax per row across the cluster: row maxima, then row sums
  for (int r = warp; r < RB; r += kWarps) {
    const float* row = lg + static_cast<size_t>(r) * lstride;
    float m = -__int_as_float(0x7f800000);
    for (int t = lane; t < len; t += 32) m = fmaxf(m, row[t]);
    m = warp_max(m);
    if (lane == 0) smax[r] = m;
  }
  cluster.sync();
  for (int r = warp; r < RB; r += kWarps) {
    float m = lane < nsplit ? cluster.map_shared_rank(smax, lane)[r]
                            : -__int_as_float(0x7f800000);
    m = warp_max(m);
    float* row = lg + static_cast<size_t>(r) * lstride;
    float s = 0.f;
    for (int t = lane; t < len; t += 32) {
      const float e = expf(__fsub_rn(row[t], m));
      row[t] = e;
      s = __fadd_rn(s, e);
    }
    s = warp_sum(s);
    if (lane == 0) ssum[r] = s;
  }
  cluster.sync();
  for (int r = warp; r < RB; r += kWarps) {
    // the same fixed order in every block of the cluster
    float s = lane < nsplit ? cluster.map_shared_rank(ssum, lane)[r] : 0.f;
    s = warp_sum(s);
    if (lane == 0) gsum[r] = s;
  }

  // A·V
  Acc acc[NTW][4];
#pragma unroll
  for (int i = 0; i < NTW; ++i)
#pragma unroll
    for (int h = 0; h < 4; ++h) acc[i][h] = 0;
  const int amt = warp & 1, d0 = (warp >> 1) * (HDP / 4);  // mma roles
  constexpr int D4 = HDP / 4;
  const int d4 = tid % D4, rg = tid / D4;                    // float roles
  constexpr int kFewIt = (kFewRows * D4 + kThreads - 1) / kThreads;  // few rows
  static_assert(kFewIt <= NTW, "the few-row roles reuse acc");
  float halves[kFewIt][2][4];  // the few-row roles' sums of whole chunks
#pragma unroll
  for (int i = 0; i < kFewIt; ++i)
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int h = 0; h < 4; ++h) halves[i][k][h] = 0.f;
  for (int i = ntiles; i < total; ++i) {
    step(i);
    const unsigned char* st = ring + (i % kStages) * Lay::kStageBytes;
    const int t0 = (i - ntiles) * kTileS;
    const int nv = min(kTileS, len - t0);
    for (int e = tid; e < (few ? kFewRows : kRowsBlk) * kTileS; e += kThreads) {
      const int r = e / kTileS, t = e - r * kTileS;
      float w = 0.f;
      if (r < RB && t < nv)
        w = __fdiv_rn(lg[static_cast<size_t>(r) * lstride + t0 + t], gsum[r]);
      if constexpr (kInt8) {
        reinterpret_cast<int8_t*>(wtile + r * Lay::kWRowBytes)[t] = int8_step(w);
      } else if constexpr (kTcBf16) {
        reinterpret_cast<__nv_bfloat16*>(wtile + r * Lay::kWRowBytes)[t] =
            __float2bfloat16_rn(w);
      } else {
        reinterpret_cast<float*>(wtile + r * Lay::kWRowBytes)[t] = round_to(w, T());
      }
    }
    if constexpr (kInt8) {
      // V (positions, d) → vt (d, positions), 4 positions per word
      for (int e = tid; e < HDP * (kTileS / 4); e += kThreads) {
        const int d = e % HDP, t4 = e / HDP;
        const unsigned char* src = st + 4 * t4 * Lay::kRowBytes + d;
        const unsigned word = static_cast<unsigned>(src[0]) |
                              (static_cast<unsigned>(src[Lay::kRowBytes]) << 8) |
                              (static_cast<unsigned>(src[2 * Lay::kRowBytes]) << 16) |
                              (static_cast<unsigned>(src[3 * Lay::kRowBytes]) << 24);
        *reinterpret_cast<unsigned*>(vt + d * Lay::kVtRowBytes + 4 * t4) = word;
      }
    }
    __syncthreads();
    if constexpr (kTcBf16) {
      if (16 * amt < RB) {
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          unsigned af[4];
          ldsm_x4(af, wtile + (16 * amt + (lane & 15)) * Lay::kWRowBytes + 32 * kk +
                          16 * (lane >> 4));
#pragma unroll
          for (int np = 0; np < NTW / 2; ++np) {
            unsigned bf[4];
            ldsm_x4_t(bf, st + (16 * kk + ((lane >> 3) & 1) * 8 + (lane & 7)) * Lay::kRowBytes +
                              (d0 + 16 * np + (lane >> 4) * 8) * 2);
            mma(acc[2 * np], af, bf[0], bf[1]);
            mma(acc[2 * np + 1], af, bf[2], bf[3]);
          }
        }
      }
    } else if constexpr (kInt8) {
      if (16 * amt < RB) {
        unsigned af[4];
        ldsm_x4(af, wtile + (16 * amt + (lane & 15)) * Lay::kWRowBytes + 16 * (lane >> 4));
#pragma unroll
        for (int np = 0; np < NTW / 2; ++np) {
          unsigned bf[4];
          ldsm_x4(bf, vt + (d0 + 16 * np + (lane >> 4) * 8 + (lane & 7)) * Lay::kVtRowBytes +
                          ((lane >> 3) & 1) * 16);
          mma(acc[2 * np], af, bf[0], bf[1]);
          mma(acc[2 * np + 1], af, bf[2], bf[3]);
        }
      }
    } else if (few) {
      // row e / D4, columns 4·(e % D4), for e = tid, tid + 256, ...; each
      // output summed in the plain read's order (kAvChunk): acc holds the
      // current chunk's chain, halves the sums of the chunks before.  bnd:
      // the tile's position where a chunk after the block's first starts
      constexpr int wstride = Lay::kWRowBytes / 4;
      const int p0 = a + t0;
      int bnd = (kAvChunk - p0 % kAvChunk) % kAvChunk;
      if (bnd >= kTileS || p0 + bnd == a) bnd = -1;
#pragma unroll
      for (int i = 0; i < kFewIt; ++i) {
        const int e = tid + i * kThreads, r = e / D4, c4 = e % D4;
        if (r < RB) {
          const float* ws = reinterpret_cast<const float*>(wtile) + r * wstride;
          for (int t = 0; t < kTileS; t += 4) {
            float v[4][4];
#pragma unroll
            for (int u = 0; u < 4; ++u)
              load4(reinterpret_cast<const T*>(st + (t + u) * Lay::kRowBytes) + 4 * c4, v[u]);
            const float4 w4 = *reinterpret_cast<const float4*>(ws + t);
            const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
            if (static_cast<unsigned>(bnd - t) < 4u) {
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                if (t + u == bnd) {
                  // the chunk that ended joins its half's sum
                  add_to_half(halves[i], acc[i], p0 + bnd - 1 < S / 2);
#pragma unroll
                  for (int h = 0; h < 4; ++h) acc[i][h] = 0.f;
                }
#pragma unroll
                for (int h = 0; h < 4; ++h) acc[i][h] = fmaf(wv[u], v[u][h], acc[i][h]);
              }
            } else {
#pragma unroll
              for (int u = 0; u < 4; ++u)
#pragma unroll
                for (int h = 0; h < 4; ++h) acc[i][h] = fmaf(wv[u], v[u][h], acc[i][h]);
            }
          }
        }
      }
    } else {
      // rows rg·NTW.., columns 4·d4..; each output one FMA chain over the
      // positions in order, as the plain version's float32 product
      constexpr int wstride = Lay::kWRowBytes / 4;
      const float* ws = reinterpret_cast<const float*>(wtile) + rg * NTW * wstride;
      for (int t = 0; t < kTileS; t += 4) {
        float v[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          load4(reinterpret_cast<const T*>(st + (t + u) * Lay::kRowBytes) + 4 * d4, v[u]);
#pragma unroll
        for (int rr = 0; rr < NTW; ++rr) {
          const float4 w4 = *reinterpret_cast<const float4*>(ws + rr * wstride + t);
          const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int h = 0; h < 4; ++h) acc[rr][h] = fmaf(wv[u], v[u][h], acc[rr][h]);
        }
      }
    }
  }
  __syncthreads();  // every read of the logits is done: part overwrites them
  if constexpr (!kMma) {
    if (few && ntiles > 0) {
      // the last chunk joins its half too, then half 0 + half 1
      const bool first = a + ntiles * kTileS - 1 < S / 2;
#pragma unroll
      for (int i = 0; i < kFewIt; ++i) {
        add_to_half(halves[i], acc[i], first);
#pragma unroll
        for (int h = 0; h < 4; ++h) acc[i][h] = __fadd_rn(halves[i][0][h], halves[i][1][h]);
      }
    }
  }

  if constexpr (kMma) {
    if (16 * amt < RB) {
      const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        const int col = d0 + 8 * j + 2 * tq;
        Acc* p0r = part + (16 * amt + gq) * HDP + col;
        Acc* p1r = p0r + 8 * HDP;
        p0r[0] = acc[j][0];
        p0r[1] = acc[j][1];
        p1r[0] = acc[j][2];
        p1r[1] = acc[j][3];
      }
    }
  } else if (few) {
#pragma unroll
    for (int i = 0; i < kFewIt; ++i) {
      const int e = tid + i * kThreads, r = e / D4, c4 = e % D4;
      if (r < RB)
        *reinterpret_cast<float4*>(part + r * HDP + 4 * c4) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  } else {
#pragma unroll
    for (int rr = 0; rr < NTW; ++rr)
      *reinterpret_cast<float4*>(part + (rg * NTW + rr) * HDP + 4 * d4) =
          make_float4(acc[rr][0], acc[rr][1], acc[rr][2], acc[rr][3]);
  }
  cluster.sync();

  // the splits' partial sums, added in split order; block i writes every
  // nsplit-th slice of the outputs
  for (int e = split * kThreads + tid; e < RB * hd; e += nsplit * kThreads) {
    const int r = e / hd, d = e - r * hd;
    Acc s = 0;
    for (int k = 0; k < nsplit; ++k) {
      const Acc v = cluster.map_shared_rank(part, k)[r * HDP + d];
      if constexpr (kInt8) {
        s += v;
      } else {
        s = __fadd_rn(s, v);
      }
    }
    float o;
    if constexpr (kInt8) {
      o = __fmul_rn(__int2float_rn(s), kOutScale);
    } else {
      o = s;
    }
    const int ra = r0 + r, j = ra / g, gi = ra - j * g;
    out[(((static_cast<size_t>(b) * W + j) * nkv + n) * g + gi) * hd + d] = o;
  }
  cluster.sync();  // keep this block's partial sums until every block has read them
}

// dynamic shared memory of one block
template <typename T, int HDP, bool TC>
size_t smem_bytes(int R, int cap, int ps, int lg_in_smem) {
  using Lay = Layout<T, HDP, TC>;
  size_t uni = Lay::kPartBytes;
  if (Lay::kMma) uni = std::max(uni, static_cast<size_t>(Lay::kQBytes));
  if (lg_in_smem)
    uni = std::max(uni, static_cast<size_t>(std::min(R, kRowsBlk)) * (cap + 4) * 4);
  return Lay::kSmallBytes + page_id_bytes(cap, ps) + Lay::kMidBytes + uni;
}

// Checks the arguments and raises the kernel's dynamic shared-memory limit
// (once per instance and size); returns 0 or a cudaError_t.
template <typename T, int HDP, bool TC>
int prepare(size_t bytes, int hd, int nsplit, int cap) {
  if (bytes > kMaxSmem || nsplit < 1 || nsplit > kMaxSplits || cap % kTileS != 0 ||
      hd % 16 != 0 || hd > HDP)
    return static_cast<int>(cudaErrorInvalidValue);
  static size_t configured = 48 * 1024;
  if (bytes > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        verify_window_kernel<T, HDP, TC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = bytes;
  }
  return 0;
}

cudaLaunchConfig_t cluster_config(int nsplit, dim3 grid, size_t bytes,
                                  cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

struct Args {
  const void *q, *kp, *vp, *pt, *pos;
  void *out, *scratch;
  int B, W, nkv, g, hd, ps, max_pages, win, nsplit, cap, lg_in_smem;
};

template <typename T, int HDP, bool TC>
int launch(const Args& x, cudaStream_t stream) {
  const int R = x.W * x.g;
  const size_t bytes = smem_bytes<T, HDP, TC>(R, x.cap, x.ps, x.lg_in_smem);
  if (!x.lg_in_smem && x.scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int err0 = prepare<T, HDP, TC>(bytes, x.hd, x.nsplit, x.cap);
  if (err0 != 0) return err0;
  const int halves = (R + kRowsBlk - 1) / kRowsBlk;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(
      x.nsplit, dim3(x.nsplit, x.nkv * halves, x.B), bytes, stream, attr);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, verify_window_kernel<T, HDP, TC>, static_cast<const float*>(x.q),
      static_cast<const T*>(x.kp), static_cast<const T*>(x.vp),
      static_cast<const int*>(x.pt), static_cast<const int*>(x.pos),
      static_cast<float*>(x.out), static_cast<float*>(x.scratch), x.W, x.nkv,
      x.g, x.hd, x.ps, x.max_pages, x.win, x.cap, x.lg_in_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// clusters of this configuration the card runs at once, or -cudaError_t
template <typename T, int HDP, bool TC>
int max_clusters(const Args& x) {
  const size_t bytes = smem_bytes<T, HDP, TC>(x.W * x.g, x.cap, x.ps, x.lg_in_smem);
  const int err0 = prepare<T, HDP, TC>(bytes, x.hd, x.nsplit, x.cap);
  if (err0 != 0) return -err0;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(x.nsplit, dim3(x.nsplit, 1, 1), bytes, nullptr, attr);
  int n = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveClusters(&n, verify_window_kernel<T, HDP, TC>, &cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// Dispatch on the cache type and the padded head dim.  bf16 rows split over
// several blocks run on the tensor cores; a row one block holds whole stays
// on the CUDA cores, in the plain version's summation order.
int dispatch(int kv_dtype, const Args& x, cudaStream_t stream, bool occupancy) {
#define REPRO_VW(T, HDP, TC) \
  (occupancy ? max_clusters<T, HDP, TC>(x) : launch<T, HDP, TC>(x, stream))
#define REPRO_VW_HD(T, TC)                     \
  (x.hd <= 64 ? REPRO_VW(T, 64, TC)            \
   : x.hd <= 128 ? REPRO_VW(T, 128, TC) : REPRO_VW(T, 256, TC))
  switch (kv_dtype) {
    case kF32:
      return REPRO_VW_HD(float, false);
    case kBF16:
      return x.nsplit > 1 ? REPRO_VW_HD(__nv_bfloat16, true)
                          : REPRO_VW_HD(__nv_bfloat16, false);
    case kI8:
      return REPRO_VW_HD(int8_t, true);
    default:
      return occupancy ? -static_cast<int>(cudaErrorInvalidValue)
                       : static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_VW_HD
#undef REPRO_VW
}

}  // namespace

REPRO_ERROR_STRING_FN

// q (B, W, nkv, g, hd) f32; k/v pages (P, ps, nkv, hd) in kv_dtype; page
// table (B, max_pages) int32; pos (B,) int32; out (B, W, nkv, g, hd) f32.
// nsplit ≤ 8 blocks per (row, kv head, 32 query rows), each holding at most
// cap positions (a multiple of 32); scratch (B, nkv·ceil(W·g/32), nsplit,
// 32, cap + 4) f32 for the logits, unused when lg_in_smem.  hd a multiple
// of 16, at most 256.  Returns the launch's error, else cudaGetLastError().
extern "C" int verify_window_launch(const void* q, const void* kp,
                                    const void* vp, int kv_dtype,
                                    const void* pt, const void* pos, void* out,
                                    void* scratch, int B, int W, int nkv,
                                    int g, int hd, int ps, int max_pages,
                                    int win, int nsplit, int cap,
                                    int lg_in_smem, void* stream) {
  const Args x{q, kp, vp, pt, pos, out, scratch, B, W, nkv, g, hd, ps,
               max_pages, win, nsplit, cap, lg_in_smem};
  return dispatch(kv_dtype, x, static_cast<cudaStream_t>(stream), false);
}

// How many clusters of nsplit blocks (W·g query rows, head dim hd, cap
// positions, page size ps) the card runs at once; a negative value is
// -cudaError_t.
extern "C" int verify_window_max_clusters(int kv_dtype, int W, int g, int hd,
                                          int ps, int nsplit, int cap,
                                          int lg_in_smem) {
  const Args x{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
               1, W, 1, g, hd, ps, 1, 1, nsplit, cap, lg_in_smem};
  return dispatch(kv_dtype, x, nullptr, true);
}
