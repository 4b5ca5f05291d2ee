// Fused LUT-MU for Hopper: tree encode + LUT gather-sum + dequant epilogue,
// one launch per call.
//
// Replaces: repro/kernels/fused_lutmu.py::fused_lutmu_pallas (_fused_kernel),
// the TPU kernel that builds a one-hot in VMEM and contracts it with the LUT
// tile on the MXU.
//
// What bounds it on this card: device-memory bytes in principle.  Each
// output row needs exactly one LUT row (N entries) per codebook, so the work
// is B·C·N adds against the LUT rows the batch touches, at most
// min(B, G)·C·N entries; there is no matrix product to feed the tensor
// cores, and a one-hot contraction would read the whole C·G·N table and
// multiply by zeros.  In practice the rows are scattered segments of a few
// hundred bytes, and what limits a block is how fast it can request them
// and add them: see PERF.md.
//
// What the design does about it (kernels/fused_lutmu.py::plan sizes it):
// * One launch, no partial buffer in device memory.  A block owns up to 32
//   rows (a row group: a decode batch or a prefill chunk is one group), one
//   N-tile of TB bytes (kTileBytes) and a slice of `per` codebooks.  The
//   codebooks are split over a thread-block cluster of cs ≤ 16 blocks
//   (cudaLaunchKernelEx, cluster along x; above 8 a non-portable size, which
//   the down projection's 20 N-tiles need to fill the card in one wave);
//   each block leaves its partial sums in shared memory, and after a
//   cluster barrier block k adds every cs-th output over the ranks in rank
//   order through distributed shared memory and applies the dequant
//   epilogue.  Exact on int32 (int8 and int16 tables); a fixed order on
//   float32.
// * Each LUT row segment a block needs is read once.  The codebooks go by
//   stages of k_stage.  Eight consumer warps encode a stage kStages stages
//   before they sum it, one thread per (codebook, row) walking the tree
//   from the slice's thresholds (copied into shared memory once, when they
//   fit) and x (loaded one stage ahead into registers); a butterfly OR of
//   one-hot leaf masks (__match_any_sync beyond 32 leaves) gives each
//   codebook's distinct leaves and each row's slot among them.  Only the
//   distinct segments are copied, and every row that chose one adds it
//   from shared memory.
// * Bytes in flight, and the copies off the adding warps: two producer
//   warps take alternate stages; once a stage's ring slot is free (empty
//   mbarrier) and its table written (table mbarrier), one issues a TMA 1-D
//   bulk copy per segment, completing on the slot's full mbarrier, so three
//   stages of about 16 KB are in flight while one is summed.  (With
//   cp.async 16-byte copies issued by the adding threads, or a single
//   producer warp, the copies' issue stalled the block at about 5 GB/s.)
//   LUT rows whose segments are not 16-byte aligned (N·sizeof(T) % 16 != 0)
//   are copied entry by entry by the producer through the same ring.
// * Sums: consumer thread t owns the 16-byte column chunk t % (TB/16) and
//   row lane t / (TB/16).  With fewer rows than row lanes, the spare lanes
//   take other codebooks of the stage (phases), and the phases' sums are
//   added in phase order before the cluster's; every thread adds at most
//   four chunks per stage, their loads issued together.  Values stay raw
//   until added: bf16 widens by a shift, int16 by a sign extension into
//   int32 sums (the plain version's float32 sums of integers agree bit for
//   bit while |sum| ≤ 2^24, which C ≤ 512 guarantees), and int8 is added
//   four at a time
//   as offset-binary bytes (v + 128) into two 16-bit lanes per 32-bit
//   register, flushed to int32 at most every 256 codebooks (256 · 255 <
//   2^16) and corrected by 128 per codebook at the end: exact.  At most
//   102 registers a thread, so two blocks share an SM.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kConsumers = 256;   // threads that encode and add: 8 warps
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kProducerWarps = 2;  // warps that issue the ring's copies
constexpr int kThreads = kConsumers + 32 * kProducerWarps;
constexpr int kGroupRows = 32;    // rows of a row group
constexpr int kStages = 4;        // ring depth (kernels/fused_lutmu.py _STAGES)
constexpr int kTabSlots = 2 * kStages;  // stages whose leaf tables are held
constexpr int kBars = 2 * kStages + kTabSlots;  // full, empty, table mbarriers
constexpr int kMaxCluster = 16;   // the largest (non-portable) cluster size
constexpr int kFlushEvery = 256;  // int8 codebooks per 16-bit lane flush
constexpr size_t kMaxSmem = 232448;  // 227 KB a block may use

__host__ __device__ __forceinline__ int align16(int v) { return (v + 15) / 16 * 16; }

// The shared-memory plan of one launch (kernels/fused_lutmu.py::smem_bytes
// is its twin): the ring's mbarriers, the leaf tables of kTabSlots stages —
// distinct-leaf counts,
// distinct leaves (max_seg per codebook), each row's slot (rows_cap per
// codebook) — then the slice's thresholds when thr_smem, then the ring,
// which the partial sums reuse once the last stage is summed.
struct Plan {
  int tb;        // bytes of a row segment: the N-tile
  int rows_cap;  // min(B, 32): table stride
  int rows_p2;   // rows_cap rounded up to a power of two: encode lanes
  int max_seg;   // min(rows_cap, 2^depth): distinct leaves of a codebook
  int k_stage;   // codebooks per ring stage (k_stage · rows_p2 ≤ kConsumers)
  int per;       // codebooks of a block
  int n_thr;     // thresholds per codebook
  int thr_smem;  // the slice's thresholds are copied into shared memory
  __host__ __device__ int lanes() const { return kConsumers / (tb / 16); }
  __host__ __device__ int phases() const {
    return lanes() / (rows_p2 < lanes() ? rows_p2 : lanes());
  }
  __host__ __device__ int table_bytes() const {
    const int cells = kTabSlots * k_stage;
    return align16(kBars * 8) + align16(cells) + align16(cells * max_seg) +
           align16(cells * rows_cap);
  }
  __host__ __device__ int thr_bytes() const { return thr_smem ? align16(per * n_thr * 4) : 0; }
  __host__ __device__ int stage_bytes() const { return k_stage * max_seg * tb; }
  __host__ __device__ size_t smem_bytes(int itemsize) const {
    const int ring = kStages * stage_bytes();
    const int part = phases() * rows_cap * (tb / itemsize) * 4;
    return static_cast<size_t>(table_bytes() + thr_bytes()) + (ring > part ? ring : part);
  }
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// TMA 1-D bulk copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) into this block's shared memory, completing on mbarrier `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, int bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(unsigned long long* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, int parity) {
  asm volatile(
      "{\n\t.reg .pred P1;\n"
      "LAB_WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n\t"
      "@P1 bra DONE;\n\t"
      "bra LAB_WAIT;\n"
      "DONE:\n\t}\n"
      :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Bytes of a row segment, the N-tile of a block: 256 for int8 tables, 512
// for wider entries (256 bfloat16 or int16 columns, 128 float32 ones): the
// fastest of 128, 256 and 512 bytes in every int8, float32 and bfloat16
// kernel-phase case of chip_smoke.py; 512-byte int8 tiles need more
// registers than two blocks per SM leave.
template <typename T> constexpr int kTileBytes = sizeof(T) == 1 ? 256 : 512;

// Per-thread sums of R rows × one 16-byte column chunk.
template <typename T, int R> struct Acc;

// float32 and bfloat16 tables: float32 sums, each added in codebook order;
// int16 tables: int32 sums, exact in any order
template <typename E, int R, int V_> struct PlainAcc {
  static constexpr int V = V_;
  E v[R][V];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < R; ++j)
#pragma unroll
      for (int e = 0; e < V; ++e) v[j][e] = 0;
  }
  __device__ __forceinline__ void reserve(int) {}
  __device__ __forceinline__ void finish() {}
  __device__ __forceinline__ E value(int j, int e) const { return v[j][e]; }
};

template <int R> struct Acc<float, R> : PlainAcc<float, R, 4> {
  __device__ __forceinline__ void add(int j, const uint4& raw) {
    this->v[j][0] += __uint_as_float(raw.x);
    this->v[j][1] += __uint_as_float(raw.y);
    this->v[j][2] += __uint_as_float(raw.z);
    this->v[j][3] += __uint_as_float(raw.w);
  }
};

template <int R> struct Acc<__nv_bfloat16, R> : PlainAcc<float, R, 8> {
  __device__ __forceinline__ void add(int j, const uint4& raw) {
    const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {  // entry 2q in the low half, 2q+1 high
      this->v[j][2 * q] += __uint_as_float(w[q] << 16);
      this->v[j][2 * q + 1] += __uint_as_float(w[q] & 0xffff0000u);
    }
  }
};

template <int R> struct Acc<int16_t, R> : PlainAcc<int, R, 8> {
  __device__ __forceinline__ void add(int j, const uint4& raw) {
    const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {  // entry 2q in the low half, 2q+1 high
      this->v[j][2 * q] += static_cast<int16_t>(w[q] & 0xffffu);
      this->v[j][2 * q + 1] += static_cast<int16_t>(w[q] >> 16);
    }
  }
};

// int8 tables: entry e of word q as the byte v + 128 in [0, 255]; even
// bytes sum in pk[2q], odd ones in pk[2q+1], two 16-bit lanes each
template <int R> struct Acc<int8_t, R> {
  static constexpr int V = 16;
  unsigned pk[R][8];
  int wide[R][16];
  int since;  // codebooks in pk
  int added;  // codebooks in all
  __device__ __forceinline__ void zero() {
    since = 0;
    added = 0;
#pragma unroll
    for (int j = 0; j < R; ++j) {
#pragma unroll
      for (int e = 0; e < 8; ++e) pk[j][e] = 0u;
#pragma unroll
      for (int e = 0; e < 16; ++e) wide[j][e] = 0;
    }
  }
  __device__ __forceinline__ void add(int j, const uint4& raw) {
    const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const unsigned u = w[q] ^ 0x80808080u;
      pk[j][2 * q] += u & 0x00ff00ffu;
      pk[j][2 * q + 1] += (u >> 8) & 0x00ff00ffu;
    }
  }
  __device__ __forceinline__ void flush() {
#pragma unroll
    for (int j = 0; j < R; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        wide[j][4 * q] += static_cast<int>(pk[j][2 * q] & 0xffffu);
        wide[j][4 * q + 2] += static_cast<int>(pk[j][2 * q] >> 16);
        wide[j][4 * q + 1] += static_cast<int>(pk[j][2 * q + 1] & 0xffffu);
        wide[j][4 * q + 3] += static_cast<int>(pk[j][2 * q + 1] >> 16);
        pk[j][2 * q] = 0u;
        pk[j][2 * q + 1] = 0u;
      }
  }
  // n more codebooks are about to be added
  __device__ __forceinline__ void reserve(int n) {
    if (since + n > kFlushEvery) {
      flush();
      since = 0;
    }
    since += n;
    added += n;
  }
  // remove the +128 of each codebook added
  __device__ __forceinline__ void finish() {
    flush();
#pragma unroll
    for (int j = 0; j < R; ++j)
#pragma unroll
      for (int e = 0; e < 16; ++e) wide[j][e] -= 128 * added;
  }
  __device__ __forceinline__ int value(int j, int e) const { return wide[j][e]; }
};

__device__ __forceinline__ int add_in_order(int s, int v) { return s + v; }
__device__ __forceinline__ float add_in_order(float s, float v) { return __fadd_rn(s, v); }

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
fused_lutmu_kernel(const float* __restrict__ x, const float* __restrict__ thr,
                   const T* __restrict__ lut, const float* __restrict__ scale,
                   int scale_stride, const float* __restrict__ offset,
                   int offset_stride, float* __restrict__ out, int B, int C,
                   int N, int depth, Plan pl, bool vec_ok) {
  using A = typename LutAcc<T>::type;
  constexpr int TB = kTileBytes<T>;
  constexpr int kChunks = TB / 16;               // 16-byte chunks of a segment
  constexpr int kLanes = kConsumers / kChunks;   // row lanes
  constexpr int kRpt = (kGroupRows + kLanes - 1) / kLanes;  // rows a thread owns
  constexpr int kUnroll = 4 / kRpt;              // codebooks loaded at once
  constexpr int TN = TB / static_cast<int>(sizeof(T));      // columns of a tile
  using AccT = Acc<T, kRpt>;
  constexpr int V = AccT::V;
  static_assert(V * static_cast<int>(sizeof(T)) == 16, "16-byte chunks");

  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int n0 = static_cast<int>(blockIdx.x / cs) * TN;
  const int b0 = blockIdx.y * kGroupRows;
  const int rows = min(kGroupRows, B - b0);
  const int c_begin = min(C, rank * pl.per);
  const int ncb = min(C, c_begin + pl.per) - c_begin;
  const int G = 1 << depth;
  const int n_thr = G - 1;
  const int ks = pl.k_stage;
  const int nst = (ncb + ks - 1) / ks;

  extern __shared__ __align__(16) unsigned char smem[];
  const int cells = kTabSlots * ks;
  unsigned long long* full = reinterpret_cast<unsigned long long*>(smem);  // stage landed
  unsigned long long* empty = full + kStages;       // stage summed by all warps
  unsigned long long* tab = empty + kStages;        // stage's leaf table written
  unsigned char* nd_s = smem + align16(kBars * 8);              // [slot][k]
  unsigned char* leaf_s = nd_s + align16(cells);                // [slot][k][max_seg]
  unsigned char* slot_s = leaf_s + align16(cells * pl.max_seg);  // [slot][k][rows_cap]
  float* thr_s = reinterpret_cast<float*>(smem + pl.table_bytes());
  unsigned char* ring = smem + pl.table_bytes() + pl.thr_bytes();
  const int stage_bytes = pl.stage_bytes();

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunk = tid % kChunks, rlane = tid / kChunks;
  const int rw = min(kLanes, pl.rows_p2);  // row lanes of a phase
  const int phases = kLanes / rw;
  const int rl = rlane % rw, phase = rlane / rw;
  // encode: thread = (codebook ek of a stage, row er); the rows of one
  // codebook are rows_p2 neighbouring lanes of one warp
  const int ek = tid / pl.rows_p2, er = tid % pl.rows_p2;

  // x of this thread's (codebook, row) of stage s, zeros where there is none
  auto load_x = [&](int s, float (&xv)[8]) {
    const int i = s * ks + ek;
    const bool on = ek < ks && i < ncb && er < rows;
    const float* xr = x + (static_cast<size_t>(b0 + er) * C + c_begin + i) * depth;
#pragma unroll
    for (int l = 0; l < 8; ++l) xv[l] = on && l < depth ? xr[l] : 0.f;
  };

  // Stage s's leaf table: each warp whose lanes hold (codebook, row) pairs
  // of the stage walks their trees and finds each codebook's distinct
  // leaves among its rows_p2 lanes (a butterfly OR of one-hot masks for up
  // to 32 leaves, __match_any_sync beyond); every warp then arrives on the
  // stage's table barrier.
  auto encode = [&](int s, const float (&xv)[8]) {
    const int kc = min(ks, ncb - s * ks);
    if ((warp * 32) / pl.rows_p2 < kc) {  // warp-uniform
      const int i = s * ks + ek;
      const bool on = ek < kc && er < rows;
      int leaf = 0;
      if (on) {
        const float* tp = pl.thr_smem ? thr_s + static_cast<size_t>(i) * n_thr
                                      : thr + static_cast<size_t>(c_begin + i) * n_thr;
        int node = 0;
#pragma unroll
        for (int l = 0; l < 8; ++l) {
          if (l >= depth) break;
          node = 2 * node + 1 + (xv[l] >= tp[node] ? 1 : 0);
        }
        leaf = node - n_thr;
      }
      int slot, nd;
      if (G <= 32) {  // block-uniform
        unsigned m = on ? 1u << leaf : 0u;
        for (int o = 1; o < pl.rows_p2; o <<= 1) m |= __shfl_xor_sync(0xffffffffu, m, o);
        slot = __popc(m & ((1u << leaf) - 1u));
        nd = __popc(m);
      } else {
        const unsigned same = __match_any_sync(
            0xffffffffu, on ? ((lane / pl.rows_p2) << 8) | leaf : 0x10000 | lane);
        const int first = __ffs(same) - 1;
        // the lanes of this thread's codebook
        const unsigned grp = (pl.rows_p2 == 32 ? 0xffffffffu : (1u << pl.rows_p2) - 1u)
                             << (lane & ~(pl.rows_p2 - 1));
        const unsigned firsts = __ballot_sync(0xffffffffu, on && first == lane) & grp;
        slot = __popc(firsts & ((1u << first) - 1u));
        nd = __popc(firsts);
      }
      if (ek < ks) {
        const int e = (s % kTabSlots) * ks + ek;
        if (er < pl.rows_cap) slot_s[e * pl.rows_cap + er] = static_cast<unsigned char>(on ? slot : 0);
        // every row of a leaf writes the same entry
        if (on) leaf_s[e * pl.max_seg + slot] = static_cast<unsigned char>(leaf);
        if (er == 0) nd_s[e] = static_cast<unsigned char>(ek < kc ? nd : 0);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&tab[s % kTabSlots]);
  };

  // Producer warp: copy stage s's distinct segments into ring slot
  // s % kStages, cell f = k·max_seg + seg of the stage at f·TB.  It arms
  // the slot's full barrier with the stage's bytes and its lanes issue one
  // TMA bulk copy per segment; rows that are not 16-byte aligned are copied
  // entry by entry by the warp, which then arrives with no bytes expected.
  const int seg_bytes = min(TB, (N - n0) * static_cast<int>(sizeof(T)));
  auto issue = [&](int s) {
    const int t = (s % kTabSlots) * ks;
    unsigned char* st = ring + (s % kStages) * stage_bytes;
    unsigned long long* bar = &full[s % kStages];
    const int kc = min(ks, ncb - s * ks);
    const T* base = lut + static_cast<size_t>(c_begin + s * ks) * G * N + n0;
    if (vec_ok) {
      int mine = 0;
      for (int f = lane; f < kc * pl.max_seg; f += 32) {
        const int k = f / pl.max_seg;
        mine += f - k * pl.max_seg < nd_s[t + k] ? 1 : 0;
      }
      const int total = __reduce_add_sync(0xffffffffu, mine);
      if (lane == 0) mbar_arrive_expect_tx(bar, total * seg_bytes);
      __syncwarp();
      for (int f = lane; f < kc * pl.max_seg; f += 32) {
        const int k = f / pl.max_seg, seg = f - k * pl.max_seg;
        if (seg < nd_s[t + k])
          bulk_copy(st + f * TB,
                    base + (static_cast<size_t>(k) * G + leaf_s[(t + k) * pl.max_seg + seg]) * N,
                    seg_bytes, bar);
      }
    } else {
      const int cols = min(TN, N - n0);
      for (int f = 0; f < kc * pl.max_seg; ++f) {
        const int k = f / pl.max_seg, seg = f - k * pl.max_seg;
        if (seg >= nd_s[t + k]) continue;
        const T* src = base + (static_cast<size_t>(k) * G + leaf_s[(t + k) * pl.max_seg + seg]) * N;
        T* d = reinterpret_cast<T*>(st + f * TB);
        for (int e = lane; e < cols; e += 32) d[e] = src[e];
      }
      __threadfence_block();
      __syncwarp();
      if (lane == 0) mbar_arrive_expect_tx(bar, 0);
    }
  };

  // prologue: the barriers and the slice's thresholds
  if (tid == 0) {
    for (int q = 0; q < kStages; ++q) {
      mbar_init(&full[q], 1);
      mbar_init(&empty[q], kConsumerWarps);
    }
    for (int q = 0; q < kTabSlots; ++q) mbar_init(&tab[q], kConsumerWarps);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (pl.thr_smem) {
    const float* src = thr + static_cast<size_t>(c_begin) * n_thr;
    for (int e = tid; e < ncb * n_thr; e += kThreads) cp_async4(thr_s + e, src + e);
  }
  float xv[8];
  float xp[kStages][8];
  if (warp < kConsumerWarps) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) load_x(s, xp[s]);
  }
  cp_async_wait_all();
  __syncthreads();

  AccT acc;
  acc.zero();
  if (warp >= kConsumerWarps) {
    // producers: producer warp w takes stages w, w + kProducerWarps, ...,
    // each once its ring slot is free and its leaf table written
    for (int s = warp - kConsumerWarps; s < nst; s += kProducerWarps) {
      if (s >= kStages) mbar_wait(&empty[s % kStages], (s / kStages - 1) & 1);
      mbar_wait(&tab[s % kTabSlots], (s / kTabSlots) & 1);
      issue(s);
    }
  } else {
#pragma unroll
    for (int s = 0; s < kStages; ++s)
      if (s < nst) encode(s, xp[s]);
    load_x(kStages, xv);
    for (int s = 0; s < nst; ++s) {
      mbar_wait(&full[s % kStages], (s / kStages) & 1);
      if (s + kStages < nst) encode(s + kStages, xv);
      load_x(s + kStages + 1, xv);
      // add stage s: this thread's rows of codebooks phase, phase + phases, ...
      const unsigned char* st = ring + (s % kStages) * stage_bytes;
      const int t = (s % kTabSlots) * ks;
      const int kc = min(ks, ncb - s * ks);
      for (int k0 = phase; k0 < kc; k0 += kUnroll * phases) {
        uint4 v[kUnroll][kRpt];
        int n = 0;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int k = k0 + u * phases;
          if (k < kc) {
            ++n;
#pragma unroll
            for (int j = 0; j < kRpt; ++j) {
              const int r = rl + j * kLanes;
              if (r < rows) {
                const int sl = slot_s[(t + k) * pl.rows_cap + r];
                v[u][j] = *reinterpret_cast<const uint4*>(
                    st + (k * pl.max_seg + sl) * TB + chunk * 16);
              }
            }
          }
        }
        acc.reserve(n);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (u < n)
#pragma unroll
            for (int j = 0; j < kRpt; ++j)
              if (rl + j * kLanes < rows) acc.add(j, v[u][j]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s % kStages]);
    }
    acc.finish();
  }

  // partial sums [phase][row][column] into the ring's space once every
  // consumer is done with it; the phases added in order; then the
  // cluster's ranks in order, and the epilogue
  A* part = reinterpret_cast<A*>(ring);
  if (warp < kConsumerWarps) {
    asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers) : "memory");
#pragma unroll
    for (int j = 0; j < kRpt; ++j) {
      const int r = rl + j * kLanes;
      if (r < rows) {
#pragma unroll
        for (int e = 0; e < V; ++e)
          part[(phase * pl.rows_cap + r) * TN + chunk * V + e] = acc.value(j, e);
      }
    }
    asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers) : "memory");
    if (phases > 1) {
      for (int e = tid; e < rows * TN; e += kConsumers) {
        A s = part[e];
        for (int p = 1; p < phases; ++p) s = add_in_order(s, part[p * pl.rows_cap * TN + e]);
        part[e] = s;
      }
    }
  }
  cluster.sync();
  if (warp < kConsumerWarps) {
    for (int e = rank * kConsumers + tid; e < rows * TN; e += cs * kConsumers) {
      const int r = e / TN;
      const int n = n0 + e - r * TN;
      if (n >= N) continue;
      A s = 0;
#pragma unroll
      for (int k = 0; k < kMaxCluster; ++k)
        if (k < cs) s = add_in_order(s, cluster.map_shared_rank(part, k)[e]);
      out[static_cast<size_t>(b0 + r) * N + n] =
          dequant(to_f32(s), scale[n * scale_stride], offset[n * offset_stride]);
    }
  }
  cluster.sync();  // keep this block's partial sums until every block has read them
}

// Checks the plan and raises the kernel's dynamic shared-memory limit (once
// per instance and size); returns 0 or a cudaError_t.
template <typename T>
int prepare(const Plan& pl, int cs, size_t bytes) {
  if (bytes > kMaxSmem || pl.tb != kTileBytes<T> || cs < 1 || cs > kMaxCluster || pl.k_stage < 1 ||
      pl.k_stage * pl.rows_p2 > kConsumers || pl.per < 1 || pl.rows_cap < 1 ||
      pl.rows_cap > kGroupRows || pl.max_seg < 1 || pl.max_seg > pl.rows_cap)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool non_portable = false;
  if (!non_portable) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_lutmu_kernel<T>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    non_portable = true;
  }
  static size_t configured = 48 * 1024;
  if (bytes > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_lutmu_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = bytes;
  }
  return 0;
}

cudaLaunchConfig_t cluster_config(int cs, dim3 grid, size_t bytes,
                                  cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

struct Args {
  const void *x, *thr, *lut, *scale, *offset;
  int scale_stride, offset_stride;
  void* out;
  int B, C, N, depth, cs;
  Plan pl;
};

template <typename T>
int launch(const Args& a, cudaStream_t stream) {
  const size_t bytes = a.pl.smem_bytes(sizeof(T));
  const int err0 = prepare<T>(a.pl, a.cs, bytes);
  if (err0 != 0) return err0;
  if (static_cast<long long>(a.pl.per) * a.cs < a.C)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int TN = kTileBytes<T> / static_cast<int>(sizeof(T));
  const bool vec_ok = (static_cast<size_t>(a.N) * sizeof(T)) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(a.lut) % 16 == 0;
  const unsigned tiles = static_cast<unsigned>((a.N + TN - 1) / TN);
  const unsigned groups = static_cast<unsigned>((a.B + kGroupRows - 1) / kGroupRows);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(a.cs, dim3(tiles * a.cs, groups, 1), bytes, stream, attr);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, fused_lutmu_kernel<T>, static_cast<const float*>(a.x),
      static_cast<const float*>(a.thr), static_cast<const T*>(a.lut),
      static_cast<const float*>(a.scale), a.scale_stride,
      static_cast<const float*>(a.offset), a.offset_stride,
      static_cast<float*>(a.out), a.B, a.C, a.N, a.depth, a.pl, vec_ok);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// clusters of this configuration the card runs at once, or -cudaError_t
template <typename T>
int max_clusters(const Args& a) {
  const size_t bytes = a.pl.smem_bytes(sizeof(T));
  const int err0 = prepare<T>(a.pl, a.cs, bytes);
  if (err0 != 0) return -err0;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(a.cs, dim3(a.cs, 1, 1), bytes, nullptr, attr);
  int n = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveClusters(&n, fused_lutmu_kernel<T>, &cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// Dispatch on the LUT type.
int dispatch(int lut_dtype, const Args& a, cudaStream_t stream, bool occupancy) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (a.depth < 1 || a.depth > 8) return occupancy ? -bad : bad;
#define REPRO_FL(T) (occupancy ? max_clusters<T>(a) : launch<T>(a, stream))
  switch (lut_dtype) {
    case kI8:
      return REPRO_FL(int8_t);
    case kF32:
      return REPRO_FL(float);
    case kBF16:
      return REPRO_FL(__nv_bfloat16);
    case kI16:
      return REPRO_FL(int16_t);
    default:
      return occupancy ? -bad : bad;
  }
#undef REPRO_FL
}

Plan make_plan(int B, int depth, int tb, int per, int k_stage, int thr_smem) {
  const int rows_cap = B < kGroupRows ? B : kGroupRows;
  int rows_p2 = 1;
  while (rows_p2 < rows_cap) rows_p2 *= 2;
  const int g = 1 << depth;
  return Plan{tb, rows_cap, rows_p2, rows_cap < g ? rows_cap : g, k_stage, per,
              g - 1, thr_smem};
}

}  // namespace

REPRO_ERROR_STRING_FN

// x (B, C, depth) f32, thr (C, 2^depth - 1) f32, lut (C, 2^depth, N) in
// lut_dtype, scale/offset f32 of N entries (stride 1) or one (stride 0),
// out (B, N) f32.  Plan (kernels/fused_lutmu.py::plan): N-tiles of tb bytes
// (kTileBytes of the LUT type), clusters of cs ≤ 16 blocks, block k of a cluster
// summing codebooks [k·per, (k+1)·per), k_stage codebooks per ring stage,
// the slice's thresholds in shared memory when thr_smem.  Returns the
// launch's error, else cudaGetLastError().
extern "C" int fused_lutmu_launch(const void* x, const void* thr,
                                  const void* lut, int lut_dtype,
                                  const void* scale, int scale_stride,
                                  const void* offset, int offset_stride,
                                  void* out, int B, int C, int N, int depth,
                                  int tb, int cs, int per, int k_stage,
                                  int thr_smem, void* stream) {
  const Args a{x, thr, lut, scale, offset, scale_stride, offset_stride, out,
               B, C, N, depth, cs, make_plan(B, depth, tb, per, k_stage, thr_smem)};
  return dispatch(lut_dtype, a, static_cast<cudaStream_t>(stream), false);
}

// How many clusters of cs blocks of this plan (B rows, tree depth, tile tb
// bytes, per, k_stage, thr_smem) the card runs at once; a negative value
// is -cudaError_t.
extern "C" int fused_lutmu_max_clusters(int lut_dtype, int B, int depth, int tb,
                                        int cs, int per, int k_stage,
                                        int thr_smem) {
  const Args a{nullptr, nullptr, nullptr, nullptr, nullptr, 0, 0, nullptr,
               B, 1, 1, depth, cs, make_plan(B, depth, tb, per, k_stage, thr_smem)};
  return dispatch(lut_dtype, a, nullptr, true);
}
