// Streaming-softmax attention (FlashAttention forward) for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py::flash_attention
// (body `_kernel`, pallas_call at line 114) and computes its function:
//
//   q (B, H, Sq, D), k/v (B, KH, Sk, D), output (B, H, Sq, D) in q's type.
//   Head h reads KV head h / (H / KH) (GQA).  Queries take the last Sq
//   slots of the timeline: query i sits at q_abs = i + Sk - Sq and sees key
//   j where j <= q_abs (causal) and j > q_abs - window (has_window).  Masked
//   scores are -1e30, the running max starts at -1e30, p is zero where a
//   key is masked, and a row that sees no key (l == 0) is written as zeros
//   — all as the TPU kernel does.  Both designs below skip the K/V tiles
//   that no query of a block can see (exact: such a tile adds p = 0 and
//   leaves m and l unchanged).
//
// Bound on an H100: 4 D FLOPs per unmasked (q, k) pair against 989 TFLOP/s
// (bf16 tensor cores) and q, k, v, o moved once against 3.35 TB/s; at a
// causal 2048-token prefill of qwen2.5-3b (B 4, H 16, KH 2, D 128) the
// FLOPs bound it at ~0.07 ms.
//
// Two designs, picked by the input's type:
//
// * bfloat16 — `wgmma_kernel`, the LM's prefill path.  One block of three
//   warpgroups per (128-query tile, head, batch): warpgroup 0 is the
//   producer, whose thread 0 feeds shared memory with TMA; warpgroups 1 and
//   2 each own 64 query rows.  Q (the block's 128 rows) and a ring of
//   kStages 64-key K and V tiles sit in shared memory as bf16, 128-byte
//   swizzled, one box per 64 columns of the head dim; tensor maps describe
//   the caller's views (any stride order with a contiguous last dim), and
//   TMA's out-of-bounds fill zeroes the head dim past D and the rows past Sq
//   or Sk, so no padded copies are made.  Completion and release go through
//   mbarriers with phase bits.  A consumer computes S = Q K^T with `wgmma`
//   (A = Q and B = K, both K-major in shared memory, f32 in registers),
//   masks only the tiles that straddle the causal diagonal, the window edge
//   or the key tail, and keeps its rows' running max and sum in registers
//   (ex2.approx with scale * log2 e folded in; l sums the f32 p).  The TPU
//   kernel computes P V in f32, and a bf16 P misses `attention_bound` by up
//   to 20x, so P is split into two bf16 halves, P_hi = bf16(p) and P_lo =
//   bf16(p - P_hi): two `wgmma`s with A from registers (the S accumulator's
//   fragment is the A fragment of the next product) against V, read MN-major
//   from the same swizzled tile (transpose bit), sum into a fresh f32 tile
//   accumulator, which is added to O with f32 FMAs on the CUDA cores (O = O
//   * alpha + T), so no tensor-core accumulation runs across tiles.  The
//   epilogue divides by l in f32, writes zeros where l is 0 and rounds to
//   bf16.  The grid puts a KV group's heads next to each other (K/V reused
//   from L2) and the longest causal tiles first. `setmaxnreg` gives the
//   consumers 232 registers and the producer 40.
//
// * float32 — `simple_kernel` (tests and the 2-layer card-vs-CPU check).
//   One block of 256 threads per (64-query tile, head, batch); the q tile
//   lives in shared memory as float; a loop over the visible KV tiles
//   stages one 64-key K and V tile at a time.  Thread (ty, tx) = (t / 16,
//   t % 16) owns rows ty + 16 i (i < 4): it computes the 4 x 4 scores of
//   those rows against keys tx + 16 j, reduces each row's max and sum over
//   its 16 lanes (a half-warp) with shuffles, and keeps its output columns
//   tx + 16 c in registers.  Head dims up to 128 run on a padded width DP
//   in {32, 64, 128}, zero in shared memory.  Its products are float FMAs
//   on the CUDA cores, far above the bound.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF

// ------------------------------------------------------------------ float32

namespace simple {

constexpr int kBQ = 64;            // queries per block
constexpr int kBK = 64;            // keys per KV tile
constexpr int kThreads = 256;      // 16 x 16: rows ty + 16 i, keys tx + 16 j
constexpr int kRowsPerThread = kBQ / 16;
constexpr int kKeysPerThread = kBK / 16;

// Shared-memory layout of one block, in floats.  Q and K rows are padded
// by one float so that the 16 rows a warp reads at one d fall in 16
// different banks (DP is a multiple of 32).
template <int DP>
struct Layout {
  static constexpr int kQStride = DP + 1;
  static constexpr int kKStride = DP + 1;
  static constexpr int kVStride = DP;
  static constexpr int kPStride = kBK + 1;
  static constexpr int kFloats = kBQ * kQStride + kBK * kKStride +
                                 kBK * kVStride + kBQ * kPStride;
  static constexpr size_t kBytes = kFloats * sizeof(float);
};

// rows x DP tile of a (rows, D) row-major slab into shared memory; zeros
// past `valid` rows and past D columns.
template <int DP>
__device__ __forceinline__ void load_tile(float* dst, int stride,
                                          const float* __restrict__ src,
                                          int rows, int valid, int D) {
  for (int idx = threadIdx.x; idx < rows * DP; idx += kThreads) {
    const int r = idx / DP, d = idx % DP;
    dst[r * stride + d] = (r < valid && d < D) ? src[(int64_t)r * D + d] : 0.f;
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
simple_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int H,
              int KH, int Sq, int Sk, int D, float scale, int causal,
              int has_window, int window) {
  using L = Layout<DP>;
  constexpr int kCols = DP / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * L::kQStride;
  float* Vs = Ks + kBK * L::kKStride;
  float* Ps = Vs + kBK * L::kVStride;

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KH);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int offset = Sk - Sq;      // absolute position of query 0
  const int q_rows = min(kBQ, Sq - q0);

  const float* qb = q + ((int64_t)(b * H + h) * Sq + q0) * D;
  const float* kb = k + (int64_t)(b * KH + kh) * Sk * D;
  const float* vb = v + (int64_t)(b * KH + kh) * Sk * D;
  float* ob = o + ((int64_t)(b * H + h) * Sq + q0) * D;

  // keys [k_begin, k_end) hold every key a query of this tile can see
  const int q_lo = q0 + offset;
  const int q_hi = q0 + q_rows - 1 + offset;
  int k_begin = 0, k_end = Sk;
  if (causal) k_end = min(k_end, q_hi + 1);
  if (has_window) k_begin = max(k_begin, q_lo - window + 1);
  const int kt_begin = k_begin / kBK;
  const int kt_end = k_end > k_begin ? (k_end + kBK - 1) / kBK : kt_begin;

  load_tile<DP>(Qs, L::kQStride, qb, kBQ, q_rows, D);

  float acc[kRowsPerThread][kCols];
  float m[kRowsPerThread], l[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();               // the previous tile's readers are done
    load_tile<DP>(Ks, L::kKStride, kb + (int64_t)k0 * D, kBK, Sk - k0, D);
    load_tile<DP>(Vs, L::kVStride, vb + (int64_t)k0 * D, kBK, Sk - k0, D);
    __syncthreads();

    float s[kRowsPerThread][kKeysPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DP; ++d) {
      float qv[kRowsPerThread], kv[kKeysPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        qv[i] = Qs[(ty + 16 * i) * L::kQStride + d];
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j)
        kv[j] = Ks[(tx + 16 * j) * L::kKStride + d];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kKeysPerThread; ++j)
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // mask, then the online softmax of each row over its 16 lanes
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int q_abs = q0 + ty + 16 * i + offset;
      bool seen[kKeysPerThread];
      float row_max = kNegInf;
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) {
        const int key = k0 + tx + 16 * j;
        bool ok = key < Sk;
        if (causal) ok = ok && key <= q_abs;
        if (has_window) ok = ok && key > q_abs - window;
        seen[j] = ok;
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        row_max = fmaxf(row_max, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(row_max));
      const float alpha = expf(m[i] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) {
        const float p = seen[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty + 16 * i) * L::kPStride + tx + 16 * j] = p;
        row_sum += p;
      }
      l[i] = l[i] * alpha + half_warp_sum(row_sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc += P V
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pv[kRowsPerThread], vv[kCols];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        pv[i] = Ps[(ty + 16 * i) * L::kPStride + j];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vv[c] = Vs[j * L::kVStride + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int row = ty + 16 * i;
    if (row >= q_rows) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];   // no key seen: zeros
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = tx + 16 * c;
      if (d < D) ob[(int64_t)row * D + d] = acc[i][c] / l_safe;
    }
  }
}

template <int DP>
int launch(const float* q, const float* k, const float* v, float* o, int B,
           int H, int KH, int Sq, int Sk, int D, float scale, int causal,
           int has_window, int window, cudaStream_t stream) {
  const size_t smem = Layout<DP>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      simple_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  simple_kernel<DP><<<grid, kThreads, smem, stream>>>(
      q, k, v, o, H, KH, Sq, Sk, D, scale, causal, has_window, window);
  return (int)cudaGetLastError();
}

}  // namespace simple

// ----------------------------------------------------------------- bfloat16

namespace hopper {

constexpr int kBQ = 128;           // queries per block: two warpgroups of 64
constexpr int kBK = 64;            // keys per K/V tile
constexpr int kStages = 4;         // depth of the K/V ring
constexpr int kThreads = 384;      // warpgroup 0 produces, 1 and 2 consume
constexpr int kBox = 64;           // bf16 columns per 128-byte swizzled row
constexpr int kRowBytes = 128;
constexpr int kProducerRegs = 40;  // setmaxnreg: 40 * 128 + 232 * 256
constexpr int kConsumerRegs = 232; // registers fit the SM's 65,536
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of one block, in bytes from a 1024-aligned base (the
// 128-byte swizzle repeats every 8 rows = 1024 bytes).  Each tile is
// DP / 64 boxes of (rows x 128 bytes).
template <int DP>
struct Smem {
  static constexpr int kBoxes = DP / kBox;
  static constexpr int kQBox = kBQ * kRowBytes;
  static constexpr int kKVBox = kBK * kRowBytes;
  static constexpr int kQBytes = kBoxes * kQBox;
  static constexpr int kTileBytes = kBoxes * kKVBox;
  static constexpr int kK = kQBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBars = kV + kStages * kTileBytes;  // full, empty, q
  static constexpr int kBytes = kBars + (2 * kStages + 1) * 8;
  static constexpr int kAlloc = kBytes + 1024;             // base alignment
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Wait until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// One TMA box of a 4-D tensor map into shared memory, completing on `bar`.
// `pos` packs the map dimension (1..3) of the row, head and batch axes in
// bits 0-1, 2-3 and 4-5; dimension 0 is the head dim.
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map,
                                        uint32_t bar, int pos, int col,
                                        int row, int head, int batch) {
  const int ps = pos & 3, ph = (pos >> 2) & 3;
  const int c1 = ps == 1 ? row : ph == 1 ? head : batch;
  const int c2 = ps == 2 ? row : ph == 2 ? head : batch;
  const int c3 = ps == 3 ? row : ph == 3 ? head : batch;
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (each >> 4), swizzle mode 1.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// 2^x on the SFU: ~2 ulp, and a result below 2^-126 flushes to zero (such
// a p is far below what l >= 1 and a bf16 output can show).  exp2f's
// handling of subnormal results costs ~10% of the kernel at the prefill.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keep the compiler from moving reads of an accumulator above the wait.
__device__ __forceinline__ void pin(float (&r)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define ACC32(d)                                                            \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])
#define REGS32                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// d (64 x 64, f32) (+)= A (64 x 16) B (16 x 64), both bf16 from shared
// memory, K-major.  `accumulate` 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : ACC32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// The same with A from registers (four bf16 pairs per thread) and B read
// MN-major (transpose bit set).
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

#undef ACC32
#undef REGS32

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (a, b) -> P_hi = bf16(a, b) and P_lo = bf16(a - P_hi, b - P_hi): the two
// halves carry p to ~16 bits, P_hi alone to 8.
__device__ __forceinline__ void split_pair(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(a - hf.x, b - hf.y));
}

// The rows a consumer warpgroup owns and the key tiles they can see.
struct Rows {
  int rows;                // valid rows (of 64) before Sq
  int q_lo, q_hi;          // absolute positions of the first and last
  int kt_begin, kt_end;    // visible key tiles; empty if begin == end
};

__device__ __forceinline__ Rows rows_of(int r0, int Sq, int Sk, int causal,
                                        int has_window, int window) {
  Rows r;
  r.rows = max(0, min(64, Sq - r0));
  r.q_lo = r0 + Sk - Sq;
  r.q_hi = r.q_lo + r.rows - 1;
  int k_begin = 0, k_end = Sk;
  if (causal) k_end = min(k_end, r.q_hi + 1);
  if (has_window) k_begin = max(k_begin, r.q_lo - window + 1);
  if (r.rows == 0 || k_end <= k_begin) {
    r.kt_begin = r.kt_end = 0;
  } else {
    r.kt_begin = k_begin / kBK;
    r.kt_end = (k_end + kBK - 1) / kBK;
  }
  return r;
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
wgmma_kernel(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv,
             __nv_bfloat16* __restrict__ o, int pos_q, int pos_k, int pos_v,
             int B, int H, int KH, int Sq, int Sk, int D, float scale_log2,
             int causal, int has_window, int window) {
  using L = Smem<DP>;
  constexpr int NB = L::kBoxes;    // 64-column boxes of the head dim
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_full = base + L::kBars;       // + 8 s: K/V landed
  const uint32_t bar_empty = bar_full + 8 * kStages;  // + 8 s: released
  const uint32_t bar_q = bar_empty + 8 * kStages;

  // heads fastest, so a KV group's heads run side by side; the last query
  // tiles, the longest causal rows, first
  const int n_qt = (Sq + kBQ - 1) / kBQ;
  const int qt = n_qt - 1 - (int)(blockIdx.x / (B * H));
  const int bh = blockIdx.x % (B * H);
  const int b = bh / H, h = bh % H;
  const int kh = h / (H / KH);
  const int q0 = qt * kBQ;

  // the block loads the union of its two warpgroups' key tiles (contiguous:
  // warpgroup 0's rows precede warpgroup 1's)
  const Rows r0 = rows_of(q0, Sq, Sk, causal, has_window, window);
  const Rows r1 = rows_of(q0 + 64, Sq, Sk, causal, has_window, window);
  int kt_begin, kt_end;
  if (r0.kt_end == r0.kt_begin) {
    kt_begin = r1.kt_begin;
    kt_end = r1.kt_end;
  } else if (r1.kt_end == r1.kt_begin) {
    kt_begin = r0.kt_begin;
    kt_end = r0.kt_end;
  } else {
    kt_begin = min(r0.kt_begin, r1.kt_begin);
    kt_end = max(r0.kt_end, r1.kt_end);
  }
  const int n_tiles = kt_end - kt_begin;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 8);   // one arrival per consumer warp
    }
    mbar_init(bar_q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, L::kQBytes);
      for (int c = 0; c < NB; ++c)
        tma_box(base + c * L::kQBox, &tq, bar_q, pos_q, c * kBox, q0, h, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        mbar_wait(bar_empty + 8 * s, ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(bar_full + 8 * s, 2 * L::kTileBytes);
        const int k0 = (kt_begin + i) * kBK;
        for (int c = 0; c < NB; ++c) {
          const int off = s * L::kTileBytes + c * L::kKVBox;
          tma_box(base + L::kK + off, &tk, bar_full + 8 * s, pos_k, c * kBox,
                  k0, kh, b);
          tma_box(base + L::kV + off, &tv, bar_full + 8 * s, pos_v, c * kBox,
                  k0, kh, b);
        }
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int w = threadIdx.x / 128 - 1;       // consumer warpgroup 0 or 1
  const int t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  // accumulator fragment: element j of a 64 x 64 f32 tile sits at row
  // r_lo + 8 ((j >> 1) & 1), column 8 (j / 4) + c_lo + (j & 1)
  const int r_lo = 16 * warp + lane / 4;
  const int c_lo = 2 * (lane % 4);
  const Rows me = w == 0 ? r0 : r1;
  const uint32_t q_tile = base + w * 64 * kRowBytes;

  float O[NB][32];
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int j = 0; j < 32; ++j) O[n][j] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};           // this thread's share of each row sum

  mbar_wait(bar_q, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages;
    const int kt = kt_begin + i;
    mbar_wait(bar_full + 8 * s, (i / kStages) & 1);
    if (kt >= me.kt_begin && kt < me.kt_end) {
      const uint32_t k_tile = base + L::kK + s * L::kTileBytes;
      const uint32_t v_tile = base + L::kV + s * L::kTileBytes;

      // S = Q K^T, 16 head-dim columns a step (32 bytes into the swizzled
      // row; the hardware applies the swizzle to the full address)
      float S[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;
        wgmma_ss(S,
                 smem_desc(q_tile + (kk / 4) * L::kQBox + col, 16, 1024),
                 smem_desc(k_tile + (kk / 4) * L::kKVBox + col, 16, 1024),
                 kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(S);

      // scale into log2 units; mask only a tile that straddles an edge
      const int k0 = kt * kBK;
      const bool whole = k0 + kBK <= Sk &&
                         (!causal || k0 + kBK - 1 <= me.q_lo) &&
                         (!has_window || k0 > me.q_hi - window);
      uint32_t seen = 0xffffffffu;
#pragma unroll
      for (int j = 0; j < 32; ++j) S[j] *= scale_log2;
      if (!whole) {
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const int key = k0 + 8 * (j / 4) + c_lo + (j & 1);
          const int q_abs = me.q_lo + r_lo + 8 * ((j >> 1) & 1);
          bool ok = key < Sk;
          if (causal) ok = ok && key <= q_abs;
          if (has_window) ok = ok && key > q_abs - window;
          if (!ok) {
            S[j] = kNegInf;
            seen &= ~(1u << j);
          }
        }
      }

      // online softmax: the 4 lanes of a quad share each row
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < 32; ++j)
          if (((j >> 1) & 1) == r) mx = fmaxf(mx, S[j]);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx);
        alpha[r] = fast_exp2(m[r] - m_new);
        m[r] = m_new;
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int r = (j >> 1) & 1;
        const float p = (seen >> j) & 1u ? fast_exp2(S[j] - m[r]) : 0.f;
        S[j] = p;
        sum[r] += p;
      }
      l[0] = l[0] * alpha[0] + sum[0];
      l[1] = l[1] * alpha[1] + sum[1];

      // P = P_hi + P_lo as A fragments: keys 16 t .. 16 t + 15 are
      // accumulator elements 8 t .. 8 t + 7
      uint32_t p_hi[4][4], p_lo[4][4];
#pragma unroll
      for (int t4 = 0; t4 < 4; ++t4)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split_pair(S[8 * t4 + 2 * e], S[8 * t4 + 2 * e + 1], p_hi[t4][e],
                     p_lo[t4][e]);

      // T = P_hi V + P_lo V in a fresh accumulator; V's rows are keys, so
      // it is read MN-major (16 keys = 2048 bytes a step)
      float T[NB][32];
      wgmma_fence();
#pragma unroll
      for (int n = 0; n < NB; ++n) {
#pragma unroll
        for (int t4 = 0; t4 < 4; ++t4) {
          const uint64_t vd = smem_desc(
              v_tile + n * L::kKVBox + t4 * 16 * kRowBytes, 1024, 1024);
          wgmma_rs(T[n], p_hi[t4], vd, t4 > 0);
          wgmma_rs(T[n], p_lo[t4], vd, 1);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int n = 0; n < NB; ++n) pin(T[n]);

      // O = O alpha + T on the CUDA cores, in f32
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int j = 0; j < 32; ++j)
          O[n][j] = fmaf(O[n][j], alpha[(j >> 1) & 1], T[n][j]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * s);
  }

  // epilogue: full row sums, O / l in f32, zeros where no key was seen
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  __nv_bfloat16* ob = o + (((int64_t)b * H + h) * Sq + q0 + 64 * w) * D;
#pragma unroll
  for (int n = 0; n < NB; ++n) {
#pragma unroll
    for (int j = 0; j < 32; j += 2) {
      const int r = (j >> 1) & 1;
      const int row = r_lo + 8 * r;
      const int col = n * kBox + 8 * (j / 4) + c_lo;
      if (row < me.rows && col < D) {   // D % 8 == 0: col + 1 < D too
        const float2 val = l[r] == 0.f
                               ? make_float2(0.f, 0.f)
                               : make_float2(O[n][j] / l[r],
                                             O[n][j + 1] / l[r]);
        *reinterpret_cast<__nv_bfloat162*>(ob + (int64_t)row * D + col) =
            __floats2bfloat162_rn(val.x, val.y);
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, fetched through the runtime (no -lcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

constexpr int kEncodeError = 100000;   // + libcuda's CUresult

// Tensor map of one bf16 operand.  `desc` (10 entries): the map's dims,
// innermost first (head dim, then the row, head and batch axes in stride
// order), its 3 byte strides, and the map dim (1..3) of the row, head and
// batch axes; the box is 64 columns by `box_rows` rows.
int encode(CUtensorMap* map, const void* ptr, const int64_t* desc,
           int box_rows, int* pos) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kEncodeError + (int)CUDA_ERROR_NOT_FOUND;
  cuuint64_t dims[4], strides[3];
  cuuint32_t box[4] = {kBox, 1, 1, 1}, unit[4] = {1, 1, 1, 1};
  for (int i = 0; i < 4; ++i) dims[i] = desc[i] > 0 ? desc[i] : 1;
  for (int i = 0; i < 3; ++i) strides[i] = desc[4 + i];
  box[desc[7]] = box_rows;
  const CUresult res =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
         dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  *pos = (int)(desc[7] | desc[8] << 2 | desc[9] << 4);
  return res == CUDA_SUCCESS ? 0 : kEncodeError + (int)res;
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* o,
           const int64_t* q_map, const int64_t* k_map, const int64_t* v_map,
           int B, int H, int KH, int Sq, int Sk, int D, float scale,
           int causal, int has_window, int window, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int pos_q, pos_k, pos_v, err;
  if ((err = encode(&tq, q, q_map, kBQ, &pos_q)) != 0) return err;
  if ((err = encode(&tk, k, k_map, kBK, &pos_k)) != 0) return err;
  if ((err = encode(&tv, v, v_map, kBK, &pos_v)) != 0) return err;
  const size_t smem = Smem<DP>::kAlloc;
  cudaError_t cerr = cudaFuncSetAttribute(
      wgmma_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (cerr != cudaSuccess) return (int)cerr;
  const long long blocks = (long long)((Sq + kBQ - 1) / kBQ) * H * B;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  wgmma_kernel<DP><<<(unsigned)blocks, kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), pos_q, pos_k, pos_v, B, H,
      KH, Sq, Sk, D, scale * kLog2e, causal, has_window, window);
  return (int)cudaGetLastError();
}

}  // namespace hopper

bool bad_shape(int B, int H, int KH, int Sq, int Sk, int D) {
  return B < 1 || H < 1 || KH < 1 || H % KH != 0 || Sq < 1 || Sk < 0 ||
         D < 1 || D > 128;
}

}  // namespace

// float32, the simple design.  q (B, H, Sq, D), k/v (B, KH, Sk, D), o
// (B, H, Sq, D), all contiguous on the device.  Launches on `stream`
// without synchronizing; returns the launch's cudaError_t (0 = launched).
extern "C" int flash_attention_f32_launch(const void* q, const void* k,
                                          const void* v, void* o, int B,
                                          int H, int KH, int Sq, int Sk,
                                          int D, float scale, int causal,
                                          int has_window, int window,
                                          void* stream) {
  if (bad_shape(B, H, KH, Sq, Sk, D) || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  if (D <= 32)
    return simple::launch<32>(qf, kf, vf, of, B, H, KH, Sq, Sk, D, scale,
                              causal, has_window, window, s);
  if (D <= 64)
    return simple::launch<64>(qf, kf, vf, of, B, H, KH, Sq, Sk, D, scale,
                              causal, has_window, window, s);
  return simple::launch<128>(qf, kf, vf, of, B, H, KH, Sq, Sk, D, scale,
                             causal, has_window, window, s);
}

// bfloat16, the wgmma design.  q, k, v are read through tensor maps
// described by `*_map` (see `encode`; the wrapper's `tensor_map`); o is
// (B, H, Sq, D) contiguous.  D % 8 == 0 (TMA's 16-byte strides).  Returns
// the launch's cudaError_t, or 100000 + libcuda's CUresult when a
// tensor map is refused.
extern "C" int flash_attention_bf16_launch(
    const void* q, const void* k, const void* v, void* o,
    const int64_t* q_map, const int64_t* k_map, const int64_t* v_map, int B,
    int H, int KH, int Sq, int Sk, int D, float scale, int causal,
    int has_window, int window, void* stream) {
  if (bad_shape(B, H, KH, Sq, Sk, D) || D % 8 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 64)
    return hopper::launch<64>(q, k, v, o, q_map, k_map, v_map, B, H, KH, Sq,
                              Sk, D, scale, causal, has_window, window, s);
  return hopper::launch<128>(q, k, v, o, q_map, k_map, v_map, B, H, KH, Sq,
                             Sk, D, scale, causal, has_window, window, s);
}
