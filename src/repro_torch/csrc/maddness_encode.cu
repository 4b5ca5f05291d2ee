// MADDNESS encode to a one-hot, for Hopper.
//
// Replaces: repro/kernels/maddness_encode.py::encode_onehot_pallas
// (_encode_kernel), the TPU kernel that evaluates every node comparison of a
// (B_t, C_t) tile at once on the VPU and expands a level-by-level leaf mask.
//
// What bounds it on this card: device-memory bytes, and at decode the
// latency of one launch.  Per (row, codebook) it reads I split values and
// 2^I - 1 thresholds and writes G = 2^I one-hot entries; the compares are a
// few instructions per byte written, and the one-hot is most of the bytes
// (4.46 MB of float32 at B=32, C=2176, depth 4).  A decode call (B=4,
// C=640) moves 0.2 MB: there one memory round trip and the launch are the
// time, not the bytes.
//
// What the design does about it (kernels/maddness_encode.py::plan sizes the
// tiles):
// * One block per tile of c_t codebooks x b_t rows.  The block first stages
//   the tile's thresholds (one run of c_t·(G-1) floats) and split values
//   (b_t runs of c_t·I floats) in shared memory, every copy issued before
//   any is waited on, so the data arrives in one round trip instead of
//   depth.  The copies are cp.async: 16 bytes wherever a 16-byte chunk of
//   device memory lies inside the run, 4 bytes at the ragged ends.  Each run
//   keeps its 16-byte phase in shared memory (float i of a run lands at
//   phase + i), so every 16-byte copy is aligned at both ends.  A TMA 1-D
//   bulk copy needs a 16-byte aligned start and length, which runs of
//   c_t·15 or c_t·4 floats at any codebook offset seldom have, and a
//   tile's runs are a few hundred bytes: cp.async takes any alignment at
//   the same one round trip.
// * Compares from shared memory: one thread per (row, codebook) walks its
//   tree (the comparisons on the one valid root-to-leaf path are the
//   parallel comparators' result: x >= thr goes right, so ties go right and
//   NaN goes left, as on the TPU) and leaves the leaf in shared memory.
// * Coalesced stores: a tile's output is b_t contiguous runs of c_t·G
//   entries.  Threads take the runs' 16-byte chunks in address order, each
//   thread the chunk after its neighbour's, and write each as one 16-byte
//   vector whose entries are (g == leaf).  A chunk may span several
//   codebooks (int8 with G < 16, bfloat16 with G < 8, float32 with G = 2,
//   or a run whose start is not 16-byte aligned); chunks cut by a run's
//   ends are written entry by entry.
// * Deep trees: the plan sizes c_t so the staged thresholds fit
//   THR_BUDGET (96 KB; above 48 KB the launch raises the kernel's dynamic
//   shared-memory limit first).  Depths whose one codebook does not fit
//   (15 and 16) run the second instance of the kernel, which stages only
//   the split values and walks thresholds in device memory.

#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;        // kernels/maddness_encode.py THREADS
constexpr size_t kMaxSmem = 232448;  // 227 KB a block may use

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Shared-memory floats of a staged run of n floats: up to 3 floats of
// 16-byte phase in front, rounded up to 16 bytes.
__host__ __device__ __forceinline__ int run_floats(int n) { return (n + 6) & ~3; }

// Shared memory of a tile (kernels/maddness_encode.py::smem_bytes): the
// thresholds (none in the device-memory instance), b_t runs of split
// values, then b_t·c_t leaves.
struct Layout {
  int thr_floats, x_stride;
  size_t bytes(int b_t, int c_t) const {
    return 4 * (static_cast<size_t>(thr_floats) + static_cast<size_t>(b_t) * x_stride +
                static_cast<size_t>(b_t) * c_t);
  }
};
__host__ __device__ __forceinline__ Layout make_layout(int c_t, int depth, bool thr_smem) {
  return Layout{thr_smem ? run_floats(c_t * ((1 << depth) - 1)) : 0, run_floats(c_t * depth)};
}

// 4-byte elements between p and the 16-byte boundary below it
__device__ __forceinline__ int float_phase(const void* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// entries of p's type between p and the 16-byte boundary below it
template <typename O>
__device__ __forceinline__ int entry_phase(const O* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) & 15) / sizeof(O));
}

// Chunk k of a staged run: dst[ph + i] = src[i] for the run's floats i in
// [4k - ph, 4k - ph + 4), ph = float_phase(src); one 16-byte copy when the
// chunk lies inside the run, else its floats one by one.
__device__ __forceinline__ void stage_chunk(float* dst, const float* src, int n, int k) {
  const int ph = float_phase(src);
  const float* base = src - ph;  // 16-byte aligned; read only inside the run
  const int lo = 4 * k;
  if (lo >= ph && lo + 4 <= ph + n) {
    cp_async16(dst + lo, base + lo);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (lo + j >= ph && lo + j < ph + n) cp_async4(dst + lo + j, base + lo + j);
  }
}

// The bits of 1 in an output type
template <typename O> struct One;
template <> struct One<float> { static constexpr unsigned bits = 0x3f800000u; };
template <> struct One<__nv_bfloat16> { static constexpr unsigned bits = 0x3f80u; };
template <> struct One<int8_t> { static constexpr unsigned bits = 0x01u; };

__device__ __forceinline__ void put(float* o, bool hot) { *o = hot ? 1.0f : 0.0f; }
__device__ __forceinline__ void put(__nv_bfloat16* o, bool hot) {
  *o = __float2bfloat16(hot ? 1.0f : 0.0f);
}
__device__ __forceinline__ void put(int8_t* o, bool hot) { *o = hot ? 1 : 0; }

// The 16 bytes of one-hot entries [e0, e0 + 16 / sizeof(O)) of a run whose
// codebook k chose leaf lf[k]: one leaf read when they lie in one codebook,
// else one per entry.
template <typename O>
__device__ __forceinline__ uint4 onehot_chunk(const int* lf, int e0, int depth) {
  constexpr int E = 16 / static_cast<int>(sizeof(O));
  constexpr int per_word = E / 4;
  constexpr int bits = 32 / per_word;
  const int gmask = (1 << depth) - 1;
  unsigned w[4];
  if ((e0 & gmask) + E <= gmask + 1) {
    const int rel = lf[e0 >> depth] - (e0 & gmask);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int d = rel - q * per_word;
      w[q] = (d >= 0 && d < per_word) ? (One<O>::bits << (d * bits)) : 0u;
    }
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      unsigned v = 0u;
#pragma unroll
      for (int j = 0; j < per_word; ++j) {
        const int e = e0 + q * per_word + j;
        if ((e & gmask) == lf[e >> depth]) v |= One<O>::bits << (j * bits);
      }
      w[q] = v;
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename O, bool kThrSmem>
__global__ void __launch_bounds__(kThreads)
encode_onehot_kernel(const float* __restrict__ x, const float* __restrict__ thr,
                     O* __restrict__ out, int B, int C, int depth, int b_t,
                     int c_t, int tiles_c) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay = make_layout(c_t, depth, kThrSmem);
  float* thr_s = reinterpret_cast<float*>(smem);
  float* x_s = thr_s + lay.thr_floats;
  int* leaf_s = reinterpret_cast<int*>(x_s + static_cast<size_t>(b_t) * lay.x_stride);

  const int tid = threadIdx.x;
  const int tc = static_cast<int>(blockIdx.x % tiles_c);
  const int tb = static_cast<int>(blockIdx.x / tiles_c);
  const int c0 = tc * c_t, b0 = tb * b_t;
  const int cols = min(c_t, C - c0), rows = min(b_t, B - b0);
  const int nodes = (1 << depth) - 1;
  const float* thr_g = thr + static_cast<size_t>(c0) * nodes;
  const float* x_g = x + (static_cast<size_t>(b0) * C + c0) * depth;
  const size_t x_row = static_cast<size_t>(C) * depth;

  // 1. stage the tile: every copy issued before any is waited on
  if constexpr (kThrSmem) {
    const int n = cols * nodes;
    const int chunks = (float_phase(thr_g) + n + 3) >> 2;
    for (int k = tid; k < chunks; k += kThreads) stage_chunk(thr_s, thr_g, n, k);
  }
  {
    const int n = cols * depth;
    const int per_row = run_floats(n) >> 2;  // chunks of a run at any phase
    for (int i = tid; i < rows * per_row; i += kThreads) {
      const int r = i / per_row, k = i - r * per_row;
      const float* src = x_g + r * x_row;
      if (4 * k < float_phase(src) + n) stage_chunk(x_s + r * lay.x_stride, src, n, k);
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // 2. one thread per (row, codebook): the tree walk from shared memory
  for (int p = tid; p < rows * cols; p += kThreads) {
    const int r = p / cols, cc = p - r * cols;
    const float* src = x_g + r * x_row;
    const float* xv = x_s + r * lay.x_stride + float_phase(src) + cc * depth;
    int leaf;
    if constexpr (kThrSmem) {
      leaf = tree_leaf(xv, thr_s + float_phase(thr_g) + cc * nodes, depth);
    } else {
      leaf = tree_leaf(xv, thr_g + static_cast<size_t>(cc) * nodes, depth);
    }
    leaf_s[p] = leaf;
  }
  __syncthreads();

  // 3. the rows' runs of cols·G entries in 16-byte chunks, in address order
  constexpr int E = 16 / static_cast<int>(sizeof(O));
  const int n = cols << depth;
  O* out_g = out + ((static_cast<size_t>(b0) * C + c0) << depth);
  const size_t out_row = static_cast<size_t>(C) << depth;
  const bool same_phase = (out_row * sizeof(O)) % 16 == 0;
  const int ph0 = entry_phase(out_g);
  const int per_row = same_phase ? (ph0 + n + E - 1) / E : (n + E - 1) / E + 1;
  for (int i = tid; i < rows * per_row; i += kThreads) {
    const int r = i / per_row, k = i - r * per_row;
    O* dst = out_g + r * out_row;
    const int ph = same_phase ? ph0 : entry_phase(dst);
    const int e0 = k * E - ph;  // the chunk's first entry in the run
    if (e0 >= n) continue;
    const int* lf = leaf_s + r * cols;
    if (e0 >= 0 && e0 + E <= n) {
      *reinterpret_cast<uint4*>(dst + e0) = onehot_chunk<O>(lf, e0, depth);
    } else {
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const int e = e0 + j;
        if (e >= 0 && e < n) put(dst + e, (e & ((1 << depth) - 1)) == lf[e >> depth]);
      }
    }
  }
}

template <typename O, bool kThrSmem>
int launch(const void* x, const void* thr, void* out, int B, int C, int depth,
           int b_t, int c_t, size_t bytes, cudaStream_t stream) {
  auto kernel = encode_onehot_kernel<O, kThrSmem>;
  static size_t configured = 48 * 1024;
  if (bytes > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = bytes;
  }
  const int tiles_c = (C + c_t - 1) / c_t;
  const long long blocks = static_cast<long long>(tiles_c) * ((B + b_t - 1) / b_t);
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), kThreads, bytes, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(thr), static_cast<O*>(out), B, C,
      depth, b_t, c_t, tiles_c);
  return static_cast<int>(cudaGetLastError());
}

template <typename O>
int launch_dtype(bool thr_smem, const void* x, const void* thr, void* out, int B, int C,
                 int depth, int b_t, int c_t, size_t bytes, cudaStream_t stream) {
  return thr_smem ? launch<O, true>(x, thr, out, B, C, depth, b_t, c_t, bytes, stream)
                  : launch<O, false>(x, thr, out, B, C, depth, b_t, c_t, bytes, stream);
}

}  // namespace

REPRO_ERROR_STRING_FN

// x (B, C, depth) f32, thr (C, 2^depth - 1) f32 → out (B, C, 2^depth) in
// out_dtype.  Plan (kernels/maddness_encode.py::plan): tiles of b_t rows x
// c_t codebooks, the thresholds staged in shared memory when thr_smem, smem
// bytes of shared memory a block (must equal the kernel's own layout).
// Returns the launch's error, else cudaGetLastError().
extern "C" int encode_onehot_launch(const void* x, const void* thr, void* out,
                                    int out_dtype, int B, int C, int depth,
                                    int b_t, int c_t, int thr_smem, int smem,
                                    void* stream) {
  if (depth < 1 || depth > 16 || B < 1 || C < 1 || b_t < 1 || c_t < 1 ||
      (static_cast<long long>(b_t) * c_t << depth) > (1LL << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = make_layout(c_t, depth, thr_smem != 0).bytes(b_t, c_t);
  if (bytes > kMaxSmem || static_cast<size_t>(smem) != bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ts = thr_smem != 0;
  switch (out_dtype) {
    case kF32: return launch_dtype<float>(ts, x, thr, out, B, C, depth, b_t, c_t, bytes, s);
    case kBF16: return launch_dtype<__nv_bfloat16>(ts, x, thr, out, B, C, depth, b_t, c_t, bytes, s);
    case kI8: return launch_dtype<int8_t>(ts, x, thr, out, B, C, depth, b_t, c_t, bytes, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
