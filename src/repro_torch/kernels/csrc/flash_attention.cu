// Streaming-softmax attention (FlashAttention forward) for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py::flash_attention
// (body `_kernel`, pallas_call at line 114) and computes its function:
//
//   q (B, H, Sq, D), k/v (B, KH, Sk, D), float or bfloat16 in, float math,
//   output (B, H, Sq, D) in the input's type.  Head h reads KV head
//   h / (H / KH) (GQA).  Queries take the last Sq slots of the timeline:
//   query i sits at q_abs = i + Sk - Sq and sees key j where j <= q_abs
//   (causal) and j > q_abs - window (has_window).  Masked scores are -1e30,
//   the running max starts at -1e30, and a row that sees no key (l == 0)
//   is written as zeros — all as the TPU kernel does.
//
// Design (the simple kernel; tensor cores, wgmma and TMA are later work).
// One block of 256 threads per (64-query tile, head, batch).  The q tile
// lives in shared memory as float for the whole block; a loop over the KV
// tiles that the tile's queries can see (causal and window ranges computed
// up front, so tiles whose every key is masked are never loaded — exact,
// since such a tile adds p = 0 and leaves m and l unchanged) stages one
// 64-key K and V tile at a time.  Thread (ty, tx) = (t / 16, t % 16) owns
// rows ty + 16 i (i < 4) of the tile: it computes the 4 x 4 scores of those
// rows against keys tx + 16 j, reduces each row's max and sum over its 16
// lanes with warp shuffles (the 16 lanes of a row are one half-warp), and
// keeps the rows' output columns tx + 16 c (c < DP / 16) in registers.
// Head dims up to 128 run on a padded width DP in {32, 64, 128}; the
// padding is zero in shared memory and is never written out.  Ragged
// query and key tails are bounds-checked; no padded copies are made.
//
// Bound on an H100: 4 D FLOPs per unmasked (q, k) pair against 989 TFLOP/s
// (bf16 tensor cores) and q, k, v, o moved once against 3.35 TB/s; at a
// causal 2048-token prefill of qwen2.5-3b (B 4, H 16, KH 2, D 128) the
// FLOPs bound it at ~0.07 ms.  This kernel runs its products as float FMAs
// on the CUDA cores, fed from shared memory, so it sits far above that
// bound; its times stand in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;            // queries per block
constexpr int kBK = 64;            // keys per KV tile
constexpr int kThreads = 256;      // 16 x 16: rows ty + 16 i, keys tx + 16 j
constexpr int kRowsPerThread = kBQ / 16;
constexpr int kKeysPerThread = kBK / 16;
constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);     // round to nearest even, as torch's cast
}

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

// rows x DP tile of a (rows, D) row-major slab into shared memory as
// float; zeros past `valid` rows and past D columns.
template <typename T, int DP>
__device__ __forceinline__ void load_tile(float* dst, int stride,
                                          const T* __restrict__ src,
                                          int rows, int valid, int D) {
  for (int idx = threadIdx.x; idx < rows * DP; idx += kThreads) {
    const int r = idx / DP, d = idx % DP;
    dst[r * stride + d] =
        (r < valid && d < D) ? to_float(src[(int64_t)r * D + d]) : 0.f;
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

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int H,
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

  const T* qb = q + ((int64_t)(b * H + h) * Sq + q0) * D;
  const T* kb = k + (int64_t)(b * KH + kh) * Sk * D;
  const T* vb = v + (int64_t)(b * KH + kh) * Sk * D;
  T* ob = o + ((int64_t)(b * H + h) * Sq + q0) * D;

  // keys [k_begin, k_end) hold every key a query of this tile can see
  const int q_lo = q0 + offset;
  const int q_hi = q0 + q_rows - 1 + offset;
  int k_begin = 0, k_end = Sk;
  if (causal) k_end = min(k_end, q_hi + 1);
  if (has_window) k_begin = max(k_begin, q_lo - window + 1);
  const int kt_begin = k_begin / kBK;
  const int kt_end = k_end > k_begin ? (k_end + kBK - 1) / kBK : kt_begin;

  load_tile<T, DP>(Qs, L::kQStride, qb, kBQ, q_rows, D);

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
    load_tile<T, DP>(Ks, L::kKStride, kb + (int64_t)k0 * D, kBK, Sk - k0, D);
    load_tile<T, DP>(Vs, L::kVStride, vb + (int64_t)k0 * D, kBK, Sk - k0, D);
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
      if (d < D) store(ob + (int64_t)row * D + d, acc[i][c] / l_safe);
    }
  }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int KH, int Sq, int Sk, int D, float scale, int causal,
           int has_window, int window, cudaStream_t stream) {
  const size_t smem = Layout<DP>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<T, DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, KH, Sq, Sk, D, scale,
      causal, has_window, window);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_padded(const void* q, const void* k, const void* v, void* o,
                  int B, int H, int KH, int Sq, int Sk, int D, float scale,
                  int causal, int has_window, int window,
                  cudaStream_t stream) {
  if (D <= 32)
    return launch<T, 32>(q, k, v, o, B, H, KH, Sq, Sk, D, scale, causal,
                         has_window, window, stream);
  if (D <= 64)
    return launch<T, 64>(q, k, v, o, B, H, KH, Sq, Sk, D, scale, causal,
                         has_window, window, stream);
  return launch<T, 128>(q, k, v, o, B, H, KH, Sq, Sk, D, scale, causal,
                        has_window, window, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q (B, H, Sq, D), k/v (B, KH, Sk, D),
// o (B, H, Sq, D), all contiguous on the device.  Launches on `stream`
// without synchronizing; returns the launch's cudaError_t (0 = launched).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int dtype,
                                      int B, int H, int KH, int Sq, int Sk,
                                      int D, float scale, int causal,
                                      int has_window, int window,
                                      void* stream) {
  if (B < 1 || H < 1 || KH < 1 || H % KH != 0 || Sq < 1 || Sk < 0 ||
      D < 1 || D > 128 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_padded<float>(q, k, v, o, B, H, KH, Sq, Sk, D, scale,
                                causal, has_window, window, s);
  if (dtype == 1)
    return launch_padded<__nv_bfloat16>(q, k, v, o, B, H, KH, Sq, Sk, D,
                                        scale, causal, has_window, window, s);
  return (int)cudaErrorInvalidValue;
}
