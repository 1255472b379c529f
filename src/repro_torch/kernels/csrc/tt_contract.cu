// Fused TT-chain contraction for Hopper (sm_90a): y = x @ W(cores)^T, for
// one core set (tt_contract), P stacked core sets (tt_contract_batched) or
// P stacked core sets block-quantized on chip (tt_contract_batched_quant).
//
// Replaces the Pallas kernels repro/kernels/tt_contract.py::tt_contract
// (pallas_call at line 115), ::tt_contract_batched (pallas_call at line
// 212) and ::tt_contract_batched_quant (line 250, pallas_call at 300); all
// three share the chain body _chain (line 46).  Like the TPU kernels
// it keeps the whole chain on chip for a tile of rows: device memory sees
// each input row read once, each output row written once and the cores read
// once per block — B*N + B*M + sum|G_k| floats, the least traffic the
// function allows.  The batched kernel adds the stack index p as the grid's
// y axis: a block of entry p reads its cores at cores[k] + p*|G_k| and its
// rows at x + p*x_stride_p, where x_stride_p = 0 for an input shared by
// every entry — a shared x is read once per (p, tile) and never copied P
// times, as the TPU kernel's index map does.
//
// What bounds it on an H100: at the paper's spec (1024x1024, ranks
// [1,2,1,2,1]) each row costs 8 KB of traffic against 64 KFLOP of chain
// arithmetic, about 8 FLOP/byte, far under the card's f32 ridge (67 TFLOP/s
// over 3.35 TB/s = 20 FLOP/byte): memory-bound, ~5 us for the served pool
// of 2048 rows, ~116 us for the 47,300 rows of the training hidden layer.
// The design's answer is that traffic: intermediates never leave shared
// memory.  Each chain step contracts only r*n_k = 8 terms into m_k*r' = 8
// outputs, below any tensor-core tile, so the step is plain FMA work,
// accumulating in f32.
//
// Layout of one row's intermediate A_k (the invariant of _chain):
//   (m_1..m_k, r_k, n_{k+1}..n_L), row-major.
// Step k, with mp over M_<k and ns over N_>k:
//   out[mp, mk, rn, ns] = sum_{r, nk} a[mp, r, nk, ns] * G_k[r, mk, nk, rn]
//
// One body runs that step, chain_fibers, in all three kernels.  It gives
// each thread a fiber: one (row, mp, ns), whose r*n_k inputs
// a[row, mp, :, :, ns] it loads into registers once and turns into all
// m_k*r' outputs out[row, mp, :, :, ns], against the step's core held in
// registers (or read as warp-wide broadcasts when it is larger than 64
// floats).  The fiber widths are template arguments (4, 8, 16 or 32, the
// cap; narrower fibers pad their inputs with +0 and the core's rows with
// -0, which leaves every sum exactly as it was); the threads walk fibers and
// rows with nested loops, the starting split by host-built reciprocals, so
// no integer division runs per fiber or element.  When r*n_k == m_k*r' a
// thread writes its outputs over its own inputs, one buffer in place.  Rows
// are XOR-swizzled in 4-float chunks (swz), which keeps every step of the
// paper's spec free of bank conflicts, contiguous fibers (n_s = 1) read and
// written as float4, and the x and y tiles moved as float4 where the widths
// and the pointers allow.  A block is 128 threads over up to 32 rows
// (kernels/tt_contract.py::fiber_tile; 16 at the paper's spec), three
// blocks to an SM: ptxas gives the body 164 registers and no spills, where
// 256 threads capped at 128 registers spilled.
//
// Every output element is one sum in one order: acc = 0, then acc =
// fmaf(a[r, nk], G[r, mk, nk, rn], acc) over r, then n_k.  So every row's
// arithmetic is the same whatever tile or kernel it lands in: padding a
// batch cannot change the values of the real rows, entry p of the batched
// kernel equals tt_contract(x[p], cores[p]) bit for bit, and so does the
// quantized kernel on the fake-quantized cores.
//
// The three kernels differ only in the functor that fills the shared core
// buffer before the chain: CopyCores copies entry p's f32 cores, and
// QuantizeCores quantizes them on the way, block by block, to the values
// kernels/quant.py::fake_quant_stacked gives (int8 or fp8-e4m3 codes of
// absmax / qmax scales, multiplied back).  Each step is one IEEE operation
// in PyTorch's order — the two divisions are divisions by a float, never
// multiplications by a reciprocal, and the final multiply stays out of any
// FMA — so the buffer holds the bits PyTorch computes.  The quantizer reads
// the same 256 floats at the paper's spec as the copy and adds two divisions
// and one block's absmax per element, against 8 KB of x and y per row: the
// bound is the f32 kernel's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxCores = 8;

struct TTChain {
  int L;
  int in_dim;
  int out_dim;
  int widest;                       // floats per row buffer
  int out_modes[kMaxCores];
  int in_modes[kMaxCores];
  int ranks[kMaxCores + 1];
  int core_off[kMaxCores + 1];      // offsets into the shared core buffer
  const float* cores[kMaxCores];    // device pointers, (P, r, m, n, r') each
};

// Packs entry p's f32 cores, as they are, into the shared core buffer
// (tiny: 256 floats at the paper's spec).
struct CopyCores {
  size_t p;
  __device__ __forceinline__ void operator()(const TTChain& chain,
                                             float* g_all, int tid) const {
    for (int k = 0; k < chain.L; ++k) {
      const int size = chain.core_off[k + 1] - chain.core_off[k];
      float* dst = g_all + chain.core_off[k];
      const float* src = chain.cores[k] + p * size;
      for (int i = tid; i < size; i += blockDim.x) dst[i] = src[i];
    }
  }
};

// The value of torch.float8_e4m3fn's conversion of v: the code byte of
// c10's fp8e4m3fn_from_fp32_value, decoded exactly.  It rounds to nearest
// even and saturates to 448 where the rounding reaches the NaN code 0x7f
// (from 464 up), as the hardware's satfinite conversion does; NaN stays
// NaN.  (Older releases gave NaN from 464 up.  The quantizer
// never gets there: |x / scale| is at most 448 and an ulp.)
__device__ __forceinline__ float e4m3_round(float v) {
  constexpr uint32_t kOverflow = 1087u << 20;    // 480.0f
  constexpr uint32_t kDenormMagic = 141u << 23;  // (127 - 7) + (23 - 3) + 1
  uint32_t bits = __float_as_uint(v);
  const uint32_t sign = bits & 0x80000000u;
  bits ^= sign;
  uint32_t code;
  if (bits >= kOverflow) {
    code = bits > 0x7f800000u ? 0x7f : 0x7e;
  } else if (bits < (121u << 23)) {              // below 2^-6: subnormal
    code = __float_as_uint(__fadd_rn(__uint_as_float(bits),
                                     __uint_as_float(kDenormMagic))) -
           kDenormMagic;
  } else {
    const uint32_t mant_odd = (bits >> 20) & 1;
    code = ((bits + ((uint32_t)(7 - 127) << 23) + 0x7ffff + mant_odd) >> 20) &
           0xff;
    if (code == 0x7f) code = 0x7e;
  }
  const int exp = code >> 3;
  const int mant = code & 7;
  float mag;
  if (code == 0x7f) mag = __uint_as_float(0x7fc00000u);           // NaN
  else if (exp == 0) mag = __fmul_rn(static_cast<float>(mant), 0x1p-9f);
  else mag = __fmul_rn(static_cast<float>(8 + mant),
                       __uint_as_float(static_cast<uint32_t>(exp + 117) << 23));
  return sign ? -mag : mag;
}

// Quantizes entry p's f32 cores into the shared core buffer to the values
// of kernels/quant.py::fake_quant_stacked, for kCode 0 (int8, qmax 127) or
// 1 (fp8-e4m3, qmax 448).  Each core is cut into runs of `block` elements
// (the last one short: the zeros the plain quantizer pads it with change
// no absmax).  Element i of a run with absmax m becomes
//   scale = m > 0 ? m / qmax : 1,   code = q(x_i / scale),   code * scale,
// q the int8 rint clamped to +-127 or the e4m3 conversion, each operation
// rounded on its own.  Each thread takes whole elements, flattened over the
// cores, and reads its run from device memory (L1 keeps the entry's cores).
template <int kCode>
struct QuantizeCores {
  size_t p;
  int block;
  __device__ __forceinline__ void operator()(const TTChain& chain,
                                             float* g_all, int tid) const {
    const float qmax = kCode == 0 ? 127.0f : 448.0f;
    int k = 0;
    for (int i = tid; i < chain.core_off[chain.L]; i += blockDim.x) {
      while (i >= chain.core_off[k + 1]) ++k;
      const int size = chain.core_off[k + 1] - chain.core_off[k];
      const float* src = chain.cores[k] + p * size;
      const int e = i - chain.core_off[k];
      const int run0 = e / block * block;
      const int run1 = min(run0 + block, size);
      float absmax = 0.0f;
      for (int j = run0; j < run1; ++j) absmax = fmaxf(absmax, fabsf(src[j]));
      const float scale = absmax > 0.0f ? __fdiv_rn(absmax, qmax) : 1.0f;
      const float v = __fdiv_rn(src[e], scale);
      float code;
      if constexpr (kCode == 0)
        code = static_cast<float>(
            static_cast<int>(fminf(fmaxf(rintf(v), -qmax), qmax)));
      else
        code = e4m3_round(v);
      g_all[i] = __fmul_rn(code, scale);
    }
  }
};

// ----------------------------------------------------------- fiber body

constexpr int kFiberThreads = 128;
constexpr int kMaxFiber = 32;      // widest r*n_k or m_k*r' the body takes
constexpr size_t kMaxSmem = 232448;  // Hopper's per-block opt-in maximum

// One chain step of the fiber body, filled on the host (parse_fibers).
struct FiberStep {
  int cap;                  // template width: 4, 8, 16 or 32
  int f_in;                 // r * n_k, inputs per fiber
  int f_out;                // m_k * r', outputs per fiber
  int n_s;                  // n_{k+1} ... n_L
  int fpr;                  // fibers per row: m_1 ... m_{k-1} * n_s
  int groups;               // rows walked side by side: max(1, threads/fpr)
  int step_mp, step_ns;     // kFiberThreads = step_mp * n_s + step_ns
  unsigned long long magic_fpr;  // ceil(2^32 / fpr), see fast_div
  unsigned long long magic_ns;   // ceil(2^32 / n_s)
  int gp_off;               // the repacked core (cap x cap) in shared memory
  int in_place;             // f_in == f_out: outputs overwrite the inputs
};

// How a block moves its x tile in or its y tile out.
struct TileIO {
  int units;                // per row: width / 4 (float4) or width
  int groups;               // rows moved side by side
  unsigned long long magic; // ceil(2^32 / units)
  int vec;                  // 16-byte accesses
};

struct FiberChain {
  int rows;                 // rows per block
  int stride;               // floats per row buffer (widest, rounded to 32)
  int gp_floats;            // repacked cores: sum of cap^2
  TileIO x, y;
  FiberStep step[kMaxCores];
};

// n / d for 0 <= n < 1024 and d < 2^22 by a host-built reciprocal:
// floor(n * ceil(2^32 / d) / 2^32) is exact while n * d < 2^32.
__device__ __forceinline__ int fast_div(int n, unsigned long long magic) {
  return static_cast<int>((static_cast<unsigned long long>(n) * magic) >> 32);
}

// Position of float l of a row in its buffer: 4-float chunks XOR-permuted
// inside each 32-float bank row by bits 5-7 of l.  Fibers of stride n_s = 4
// and contiguous (n_s = 1) fibers read as float4 then fall on distinct
// banks; a run of 32 consecutive floats keeps one bank each.
__device__ __forceinline__ int swz(int l) { return l ^ ((l >> 3) & 0x1c); }

// Copies nrows rows of `width` floats from src (row stride src_stride) to
// dst (row stride dst_stride), applying swz on the side that is a shared
// buffer.  Loads are issued kBatch rows ahead of their stores.
template <bool kToShared>
__device__ __forceinline__ void move_tile(const float* __restrict__ src,
                                          float* __restrict__ dst, int nrows,
                                          int width, const TileIO& io,
                                          int stride, int tid) {
  constexpr int kBatch = 8;
  const int rg = fast_div(tid, io.magic);
  if (rg >= io.groups) return;
  const int src_stride = kToShared ? width : stride;
  const int dst_stride = kToShared ? stride : width;
  for (int u = tid - rg * io.units; u < io.units; u += kFiberThreads) {
    const int col = io.vec ? 4 * u : u;
    const int s_col = kToShared ? col : swz(col);
    const int d_col = kToShared ? swz(col) : col;
    for (int row = rg; row < nrows; row += kBatch * io.groups) {
      if (io.vec) {
        float4 v[kBatch];
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          const int r = row + i * io.groups;
          if (r < nrows)
            v[i] = *reinterpret_cast<const float4*>(src + r * src_stride +
                                                    s_col);
        }
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          const int r = row + i * io.groups;
          if (r < nrows)
            *reinterpret_cast<float4*>(dst + r * dst_stride + d_col) = v[i];
        }
      } else {
        float v[kBatch];
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          const int r = row + i * io.groups;
          if (r < nrows) v[i] = src[r * src_stride + s_col];
        }
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          const int r = row + i * io.groups;
          if (r < nrows) dst[r * dst_stride + d_col] = v[i];
        }
      }
    }
  }
}

// Rewrites step k's core G[r, mk, nk, rn] (as load_cores left it) as a
// cap x cap matrix gp[j][o], j = r*n_k + nk the fiber input and o = mk*r'
// + rn the fiber output.  Rows j >= f_in hold -0: a padded input is +0, and
// fmaf(+0, -0, acc) == acc for every acc, so the padding leaves each sum
// bit for bit as it was.  Thread o fills column o.
__device__ __forceinline__ void repack_cores(const TTChain& chain,
                                             const FiberChain& fc,
                                             const float* g_all,
                                             float* gp_all, int tid) {
  for (int k = 0; k < chain.L; ++k) {
    const FiberStep& st = fc.step[k];
    if (tid >= st.cap) continue;
    float* dst = gp_all + st.gp_off + tid;
    int j = 0;
    if (tid < st.f_out) {
      const int mk = chain.out_modes[k];
      const int nk = chain.in_modes[k];
      const int rn = chain.ranks[k + 1];
      int mki = 0, rni = tid;
      while (rni >= rn) {
        rni -= rn;
        ++mki;
      }
      const float* src = g_all + chain.core_off[k] + mki * nk * rn + rni;
      for (int ri = 0; ri < chain.ranks[k]; ++ri)
        for (int nki = 0; nki < nk; ++nki, ++j)
          dst[j * st.cap] = src[(ri * mk * nk + nki) * rn];
    }
    for (; j < st.cap; ++j) dst[j * st.cap] = -0.0f;
  }
}

// Loads the step's core, cap x cap as repack_cores wrote it, into registers
// (warp-wide broadcasts: every thread reads the same address).
template <int C>
__device__ __forceinline__ void core_to_registers(const float* gp,
                                                  float (&g)[C * C]) {
#pragma unroll
  for (int e = 0; e < C * C; e += 4) {
    const float4 v = *reinterpret_cast<const float4*>(gp + e);
    g[e] = v.x;
    g[e + 1] = v.y;
    g[e + 2] = v.z;
    g[e + 3] = v.w;
  }
}

// One chain step over the block's rows when f_in == f_out == C <= 8 (every
// step of the paper's spec): the core and the fiber's offsets in registers,
// outputs in place.  Thread tid takes the fibers q = tid % fpr, +
// kFiberThreads, ... and, for each, the rows tid / fpr, + groups, ...
template <int C>
__device__ __forceinline__ void fiber_step_exact(float* a, const float* gp,
                                                 const FiberStep& st,
                                                 int nrows, int stride,
                                                 int tid) {
  const int rg = fast_div(tid, st.magic_fpr);
  if (rg >= st.groups) return;
  const int n_s = st.n_s;
  float g[C * C];
  core_to_registers<C>(gp, g);
  int q = tid - rg * st.fpr;
  int mp = fast_div(q, st.magic_ns);
  int ns = q - mp * n_s;
#pragma unroll 1
  for (; q < st.fpr; q += kFiberThreads) {
    const int in0 = mp * C * n_s + ns;      // input and output j at
    if (n_s == 1) {                         // in0 + j * n_s; contiguous:
      int off[C / 4];                       // float4
#pragma unroll
      for (int c = 0; c < C / 4; ++c) off[c] = swz(in0 + 4 * c);
#pragma unroll 1
      for (int row = rg; row < nrows; row += st.groups) {
        float* ar = a + row * stride;
        float xv[C];
#pragma unroll
        for (int c = 0; c < C / 4; ++c) {
          const float4 v = *reinterpret_cast<const float4*>(ar + off[c]);
          xv[4 * c] = v.x;
          xv[4 * c + 1] = v.y;
          xv[4 * c + 2] = v.z;
          xv[4 * c + 3] = v.w;
        }
        float acc[C];
#pragma unroll
        for (int oi = 0; oi < C; ++oi) acc[oi] = 0.0f;
#pragma unroll
        for (int j = 0; j < C; ++j) {
#pragma unroll
          for (int oi = 0; oi < C; ++oi)
            acc[oi] = fmaf(xv[j], g[j * C + oi], acc[oi]);
        }
#pragma unroll
        for (int c = 0; c < C / 4; ++c)
          *reinterpret_cast<float4*>(ar + off[c]) =
              make_float4(acc[4 * c], acc[4 * c + 1], acc[4 * c + 2],
                          acc[4 * c + 3]);
      }
    } else {
      int off[C];
#pragma unroll
      for (int j = 0; j < C; ++j) off[j] = swz(in0 + j * n_s);
#pragma unroll 1
      for (int row = rg; row < nrows; row += st.groups) {
        float* ar = a + row * stride;
        float xv[C];
#pragma unroll
        for (int j = 0; j < C; ++j) xv[j] = ar[off[j]];
        float acc[C];
#pragma unroll
        for (int oi = 0; oi < C; ++oi) acc[oi] = 0.0f;
#pragma unroll
        for (int j = 0; j < C; ++j) {
#pragma unroll
          for (int oi = 0; oi < C; ++oi)
            acc[oi] = fmaf(xv[j], g[j * C + oi], acc[oi]);
        }
#pragma unroll
        for (int oi = 0; oi < C; ++oi) ar[off[oi]] = acc[oi];
      }
    }
    ns += st.step_ns;                       // q += kFiberThreads
    mp += st.step_mp;
    if (ns >= n_s) {
      ns -= n_s;
      ++mp;
    }
  }
}

// Every other step, fibers up to C wide: f_in < C inputs padded with +0,
// outputs past f_out not stored, in place when f_in == f_out.  Rows outside,
// fibers inside, addresses stepped by n_s, so that nothing per fiber stays
// live across rows; the core in registers for C <= 8, else read from
// shared memory as broadcasts, and outputs accumulated 8 at a time.
template <int C>
__device__ __forceinline__ void fiber_step_padded(const float* a, float* o,
                                                  const float* gp,
                                                  const FiberStep& st,
                                                  int nrows, int stride,
                                                  int tid) {
  constexpr bool kCoreRegs = C <= 8;
  constexpr int kChunk = C < 8 ? C : 8;
  const int rg = fast_div(tid, st.magic_fpr);
  if (rg >= st.groups) return;
  const int fi = st.f_in;
  const int fo = st.f_out;
  const int n_s = st.n_s;
  float g[kCoreRegs ? C * C : 4];
  if constexpr (kCoreRegs) core_to_registers<C>(gp, g);
  const int q0 = tid - rg * st.fpr;
  const int mp0 = fast_div(q0, st.magic_ns);
  const int ns0 = q0 - mp0 * n_s;
#pragma unroll 1
  for (int row = rg; row < nrows; row += st.groups) {
    const float* ar = a + row * stride;
    float* orow = o + row * stride;
    int mp = mp0;
    int ns = ns0;
#pragma unroll 1
    for (int q = q0; q < st.fpr; q += kFiberThreads) {
      float xv[C];
      int l = mp * fi * n_s + ns;           // input j at l + j * n_s
#pragma unroll
      for (int j = 0; j < C; ++j) {
        if (j < fi) {
          xv[j] = ar[swz(l)];
          l += n_s;
        } else {
          xv[j] = 0.0f;
        }
      }
      const int out0 = mp * fo * n_s + ns;  // output o at out0 + o * n_s
#pragma unroll 1
      for (int o0 = 0; o0 < fo; o0 += kChunk) {
        float acc[kChunk];
#pragma unroll
        for (int oi = 0; oi < kChunk; ++oi) acc[oi] = 0.0f;
#pragma unroll
        for (int j = 0; j < C; ++j) {
#pragma unroll
          for (int oi = 0; oi < kChunk; ++oi) {
            float core;
            if constexpr (kCoreRegs) core = g[j * C + oi];   // o0 == 0
            else core = gp[j * C + o0 + oi];
            acc[oi] = fmaf(xv[j], core, acc[oi]);
          }
        }
        int lo = out0 + o0 * n_s;
#pragma unroll
        for (int oi = 0; oi < kChunk; ++oi) {
          if (o0 + oi < fo) orow[swz(lo)] = acc[oi];
          lo += n_s;
        }
      }
      ns += st.step_ns;                     // q += kFiberThreads
      mp += st.step_mp;
      if (ns >= n_s) {
        ns -= n_s;
        ++mp;
      }
    }
  }
}

template <int C>
__device__ __forceinline__ void fiber_step(float* a, float* o,
                                           const float* gp,
                                           const FiberStep& st, int nrows,
                                           int stride, int tid) {
  if constexpr (C <= 8) {
    if (st.f_in == C && st.f_out == C) {
      fiber_step_exact<C>(a, gp, st, nrows, stride, tid);
      return;
    }
  }
  fiber_step_padded<C>(a, o, gp, st, nrows, stride, tid);
}

// One step of the fiber body at the template width of st.cap.
__device__ __forceinline__ void run_fiber_step(float* a, float* o,
                                               const float* gp,
                                               const FiberStep& st, int nrows,
                                               int stride, int tid) {
  switch (st.cap) {
    case 4: fiber_step<4>(a, o, gp, st, nrows, stride, tid); break;
    case 8: fiber_step<8>(a, o, gp, st, nrows, stride, tid); break;
    case 16: fiber_step<16>(a, o, gp, st, nrows, stride, tid); break;
    default: fiber_step<32>(a, o, gp, st, nrows, stride, tid); break;
  }
}

// The chain for `nrows` contiguous rows of one stack entry (xs -> ys) by
// fibers, with the entry's cores packed into shared memory by `load_cores`
// (CopyCores or QuantizeCores).  Shared memory: the cores as loaded, the
// repacked cores, then one row buffer (every step in place) or two
// (ping-pong), each fc.rows * fc.stride floats.
template <typename LoadCores>
__device__ __forceinline__ void chain_fibers(const float* __restrict__ xs,
                                             float* __restrict__ ys,
                                             int nrows, const TTChain& chain,
                                             const FiberChain& fc,
                                             const LoadCores& load_cores) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int core_floats = (chain.core_off[chain.L] + 3) & ~3;
  float* g_all = smem;
  float* gp_all = smem + core_floats;
  float* a = gp_all + fc.gp_floats;
  float* o = a + fc.rows * fc.stride;
  const int tid = threadIdx.x;

  load_cores(chain, g_all, tid);
  move_tile<true>(xs, a, nrows, chain.in_dim, fc.x, fc.stride, tid);
  __syncthreads();
  repack_cores(chain, fc, g_all, gp_all, tid);
  __syncthreads();

  for (int k = 0; k < chain.L; ++k) {
    const FiberStep& st = fc.step[k];
    float* out = st.in_place ? a : o;
    run_fiber_step(a, out, gp_all + st.gp_off, st, nrows, fc.stride, tid);
    __syncthreads();
    if (!st.in_place) {
      o = a;
      a = out;
    }
  }
  move_tile<false>(a, ys, nrows, chain.out_dim, fc.y, fc.stride, tid);
}

__global__ void __launch_bounds__(kFiberThreads, 3)
tt_contract_kernel(const float* __restrict__ x, float* __restrict__ y,
                   int batch, const __grid_constant__ TTChain chain,
                   const __grid_constant__ FiberChain fc) {
  const int row0 = blockIdx.x * fc.rows;
  chain_fibers(x + (size_t)row0 * chain.in_dim,
               y + (size_t)row0 * chain.out_dim, min(fc.rows, batch - row0),
               chain, fc, CopyCores{0});
}

// grid (row tiles, P): block (i, p) runs rows [i*fc.rows, (i+1)*fc.rows)
// of entry p, on entry p's f32 cores
__global__ void __launch_bounds__(kFiberThreads, 3)
tt_contract_batched_kernel(const float* __restrict__ x, float* __restrict__ y,
                           int batch, int64_t x_stride_p,
                           const __grid_constant__ TTChain chain,
                           const __grid_constant__ FiberChain fc) {
  const size_t p = blockIdx.y;
  const int row0 = blockIdx.x * fc.rows;
  chain_fibers(x + p * x_stride_p + (size_t)row0 * chain.in_dim,
               y + (p * batch + row0) * chain.out_dim,
               min(fc.rows, batch - row0), chain, fc, CopyCores{p});
}

// The batched grid on entry p's cores quantized in the block (kCode 0:
// int8, 1: fp8-e4m3) in runs of `block`.
template <int kCode>
__global__ void __launch_bounds__(kFiberThreads, 3)
tt_contract_batched_quant_kernel(const float* __restrict__ x,
                                 float* __restrict__ y, int batch,
                                 int64_t x_stride_p,
                                 const __grid_constant__ TTChain chain,
                                 const __grid_constant__ FiberChain fc,
                                 int block) {
  const size_t p = blockIdx.y;
  const int row0 = blockIdx.x * fc.rows;
  chain_fibers(x + p * x_stride_p + (size_t)row0 * chain.in_dim,
               y + (p * batch + row0) * chain.out_dim,
               min(fc.rows, batch - row0), chain, fc,
               QuantizeCores<kCode>{p, block});
}

// ------------------------------------------------------------- backward
//
// tt_contract_grad: the gradients of y = x @ W(cores)^T against dy, for the
// off-chip back-propagation baselines (no TPU counterpart: the JAX package
// differentiates only its plain chain).  With fibers as in the forward, step
// k maps each fiber's inputs a_f = A_k[row, mp, :, :, ns] (r*n_k of them) to
// its outputs A_{k+1}[row, mp, :, :, ns] (m_k*r') through the cap x cap core
// gp, so its reverse is
//   dA_k fiber   = gp . dA_{k+1} fiber    (a fiber step on gp^T, widths
//                                          swapped: the forward body again)
//   dG_k[j][o]  += a_f[j] * dA_{k+1} fiber[o]   over every fiber.
// A block takes a tile of rows.  It keeps dA in shared memory and walks k
// from L-1 down to 0; for each k it recomputes A_k from its x rows with the
// forward steps 0..k-1 (recompute, not a saving forward: the forward stays
// the launch serving and ZO run, and the states A_1..A_{L-1} of the paper's
// hidden layer would be 53 MB of extra traffic), reduces dG_k over its
// fibers (reduce_core_grad) into its own slot of `partials`, and steps dA
// back.  A second kernel sums the blocks' partials in block order.  No
// float atomics anywhere: two calls on the same inputs give the same bits.
//
// What bounds it: x and dy read, dx written (12 KB a row at the paper's
// spec, against the forward's 8), and L(L-1)/2 recomputed forward steps, L
// backward steps and L reductions of ~r*n_k*m_k*r' FMAs per fiber: about
// 3.5x the forward's arithmetic, still under the f32 ridge.

constexpr int kRedSlots = 16;      // groups of lanes whose 8x8 tiles meet
constexpr int kGradSumThreads = 128;

// The backward's tiling: the forward steps (rows, stride, the x tile),
// the backward steps (step k with f_in and f_out swapped, so dA_{k+1} ->
// dA_k runs the forward body on the transposed core), the dy and dx tiles
// and the shared buffers of each direction.
struct GradChain {
  FiberChain fwd;
  FiberStep back[kMaxCores];
  TileIO dy, dx;
  int fwd_buffers;          // 1: every step in place, else 2
  int back_buffers;
  int need_dx;
  int partial_floats;       // sum |G_k|: one block's slot of partials
};

// gpT = gp^T for every step: the backward step's cap x cap core.  Padding
// rows and columns of gp are -0, so gpT's padding is too.
__device__ __forceinline__ void transpose_cores(const TTChain& chain,
                                                const FiberChain& fc,
                                                const float* gp_all,
                                                float* gpT_all, int tid) {
  for (int k = 0; k < chain.L; ++k) {
    const int cap = fc.step[k].cap;
    const float* src = gp_all + fc.step[k].gp_off;
    float* dst = gpT_all + fc.step[k].gp_off;
    for (int i = tid; i < cap * cap; i += kFiberThreads) {
      const int j = i / cap;
      const int o = i - j * cap;
      dst[o * cap + j] = src[i];
    }
  }
}

// One block's dG_k: the sum over its fibers (row, mp, ns) of a_f[j] *
// d_f[o], a = A_k (fiber inputs, f_in) and d = dA_{k+1} (fiber outputs,
// f_out), written to out[G_k index of (j, o)].  dG is cut into 8 x 8 tiles;
// each tile takes G = kFiberThreads / T' threads (T' the tile count rounded
// up to a power of 2), and thread g of a tile the fibers g, g + G, ... in
// that order, accumulating its tile in registers.  Then a fixed shuffle tree
// over each group of W = min(G, 32) lanes, the groups' sums through shared
// memory (red), and a tile's G / W groups added in group order.
__device__ __forceinline__ void reduce_core_grad(const TTChain& chain, int k,
                                                 const FiberStep& st,
                                                 const float* a,
                                                 const float* d, float* red,
                                                 float* out, int nrows,
                                                 int stride, int tid) {
  const int f_in = st.f_in;
  const int f_out = st.f_out;
  const int n_s = st.n_s;
  const int fpr = st.fpr;
  const int to_n = (f_out + 7) / 8;
  const int tiles = ((f_in + 7) / 8) * to_n;
  int tiles_p2 = 1;
  while (tiles_p2 < tiles) tiles_p2 *= 2;
  const int G = kFiberThreads / tiles_p2;
  const int W = G < 32 ? G : 32;
  const int t = tid / G;
  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.0f;
  if (t < tiles) {
    const int j0 = (t / to_n) * 8;
    const int o0 = (t - (t / to_n) * to_n) * 8;
    const int nf = nrows * fpr;
#pragma unroll 1
    for (int i = tid - t * G; i < nf; i += G) {
      const int row = i / fpr;
      const int q = i - row * fpr;
      const int mp = q / n_s;
      const int ns = q - mp * n_s;
      const float* ar = a + row * stride;
      const float* dr = d + row * stride;
      const int a0 = mp * f_in * n_s + ns;
      const int d0 = mp * f_out * n_s + ns;
      float av[8], dv[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        av[c] = j0 + c < f_in ? ar[swz(a0 + (j0 + c) * n_s)] : 0.0f;
        dv[c] = o0 + c < f_out ? dr[swz(d0 + (o0 + c) * n_s)] : 0.0f;
      }
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
        for (int oo = 0; oo < 8; ++oo)
          acc[jj * 8 + oo] = fmaf(av[jj], dv[oo], acc[jj * 8 + oo]);
      }
    }
  }
  for (int off = W / 2; off > 0; off /= 2) {
#pragma unroll
    for (int e = 0; e < 64; ++e)
      acc[e] += __shfl_down_sync(0xffffffffu, acc[e], off, W);
  }
  if (tid % W == 0) {
    float* slot = red + (tid / W) * 64;
#pragma unroll
    for (int e = 0; e < 64; ++e) slot[e] = acc[e];
  }
  __syncthreads();
  const int groups = G / W;
  const int nk = chain.in_modes[k];
  const int mk = chain.out_modes[k];
  const int rn = chain.ranks[k + 1];
  for (int idx = tid; idx < tiles * 64; idx += kFiberThreads) {
    const int tt = idx >> 6;
    const int e = idx & 63;
    const int j = (tt / to_n) * 8 + (e >> 3);
    const int o = (tt - (tt / to_n) * to_n) * 8 + (e & 7);
    if (j >= f_in || o >= f_out) continue;
    const float* slot = red + (tt * G / W) * 64 + e;
    float sum = slot[0];
    for (int h = 1; h < groups; ++h) sum += slot[h * 64];
    // j = r * n_k + nki, o = mki * r' + rni  ->  G[r, mki, nki, rni]
    const int r = j / nk;
    const int nki = j - r * nk;
    const int mki = o / rn;
    const int rni = o - mki * rn;
    out[((r * mk + mki) * nk + nki) * rn + rni] = sum;
  }
  __syncthreads();
}

// grid (row tiles): block i takes rows [i*rows, (i+1)*rows) of x and dy,
// writes their dx (need_dx) and its dG partials to partials + i *
// partial_floats.  Shared memory: the cores as loaded, gp, gpT, red, the
// forward buffers, the backward buffers.
__global__ void __launch_bounds__(kFiberThreads, 3)
tt_contract_grad_kernel(const float* __restrict__ x,
                        const float* __restrict__ dy, float* __restrict__ dx,
                        float* __restrict__ partials, int batch,
                        const __grid_constant__ TTChain chain,
                        const __grid_constant__ GradChain gc) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const FiberChain& fc = gc.fwd;
  const int core_floats = (chain.core_off[chain.L] + 3) & ~3;
  const int buf = fc.rows * fc.stride;
  float* g_all = smem;
  float* gp_all = g_all + core_floats;
  float* gpT_all = gp_all + fc.gp_floats;
  float* red = gpT_all + fc.gp_floats;
  float* f0 = red + kRedSlots * 64;
  float* f1 = f0 + (gc.fwd_buffers - 1) * buf;
  float* d = f1 + buf;
  float* d_other = d + (gc.back_buffers - 1) * buf;
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * fc.rows;
  const int nrows = min(fc.rows, batch - row0);
  const float* xs = x + (size_t)row0 * chain.in_dim;
  float* out = partials + (size_t)blockIdx.x * gc.partial_floats;

  CopyCores{0}(chain, g_all, tid);
  move_tile<true>(dy + (size_t)row0 * chain.out_dim, d, nrows,
                  chain.out_dim, gc.dy, fc.stride, tid);
  __syncthreads();
  repack_cores(chain, fc, g_all, gp_all, tid);
  __syncthreads();
  transpose_cores(chain, fc, gp_all, gpT_all, tid);

  for (int k = chain.L - 1; k >= 0; --k) {
    move_tile<true>(xs, f0, nrows, chain.in_dim, fc.x, fc.stride, tid);
    __syncthreads();
    float* a = f0;
    float* o = f1;
    for (int s = 0; s < k; ++s) {               // A_k from x
      const FiberStep& st = fc.step[s];
      float* next = st.in_place ? a : o;
      run_fiber_step(a, next, gp_all + st.gp_off, st, nrows, fc.stride, tid);
      __syncthreads();
      if (!st.in_place) {
        o = a;
        a = next;
      }
    }
    reduce_core_grad(chain, k, fc.step[k], a, d, red,
                     out + chain.core_off[k], nrows, fc.stride, tid);
    if (k > 0 || gc.need_dx) {                  // dA_{k+1} -> dA_k
      const FiberStep& st = gc.back[k];
      float* next = st.in_place ? d : d_other;
      run_fiber_step(d, next, gpT_all + st.gp_off, st, nrows, fc.stride,
                     tid);
      __syncthreads();
      if (!st.in_place) {
        d_other = d;
        d = next;
      }
    }
  }
  if (gc.need_dx)
    move_tile<false>(d, dx + (size_t)row0 * chain.in_dim, nrows,
                     chain.in_dim, gc.dx, fc.stride, tid);
}

// dG[e] = the sum of the blocks' partials[b][e] over b, one warp an
// element: lane l adds blocks l, l + 32, ... in order, then a fixed
// shuffle tree over the lanes.
__global__ void __launch_bounds__(kGradSumThreads)
tt_contract_grad_sum_kernel(const float* __restrict__ partials, int blocks,
                            int floats, float* __restrict__ grad) {
  const int e = blockIdx.x * (kGradSumThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  float sum = 0.0f;
  if (e < floats)
    for (int b = lane; b < blocks; b += 32)
      sum += partials[(size_t)b * floats + e];
  for (int off = 16; off > 0; off /= 2)
    sum += __shfl_down_sync(0xffffffffu, sum, off);
  if (e < floats && lane == 0) grad[e] = sum;
}

// Fill `chain` from the descriptor; false for a descriptor the kernels
// cannot take.
bool parse_chain(const int64_t* desc, TTChain* chain) {
  chain->L = static_cast<int>(desc[0]);
  if (chain->L < 1 || chain->L > kMaxCores) return false;
  chain->widest = static_cast<int>(desc[1]);
  const int64_t* out_modes = desc + 2;
  const int64_t* in_modes = out_modes + chain->L;
  const int64_t* ranks = in_modes + chain->L;
  const int64_t* ptrs = ranks + chain->L + 1;
  chain->in_dim = 1;
  chain->out_dim = 1;
  chain->core_off[0] = 0;
  for (int k = 0; k < chain->L; ++k) {
    chain->out_modes[k] = static_cast<int>(out_modes[k]);
    chain->in_modes[k] = static_cast<int>(in_modes[k]);
    chain->out_dim *= chain->out_modes[k];
    chain->in_dim *= chain->in_modes[k];
    chain->cores[k] = reinterpret_cast<const float*>(ptrs[k]);
  }
  for (int k = 0; k <= chain->L; ++k)
    chain->ranks[k] = static_cast<int>(ranks[k]);
  for (int k = 0; k < chain->L; ++k) {
    chain->core_off[k + 1] = chain->core_off[k] + chain->ranks[k] *
        chain->out_modes[k] * chain->in_modes[k] * chain->ranks[k + 1];
  }
  return true;
}

unsigned long long reciprocal(int d) {      // ceil(2^32 / d), for fast_div
  return ((1ull << 32) + d - 1) / d;
}

TileIO tile_io(int width, const void* ptr) {
  TileIO io;
  io.vec = width % 4 == 0 && reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  io.units = io.vec ? width / 4 : width;
  io.groups = io.units >= kFiberThreads ? 1 : kFiberThreads / io.units;
  io.magic = reciprocal(io.units);
  return io;
}

// Fill `fc` for the fiber body at `rows` rows per block, x and y as given
// (their alignment picks the tile accesses); return the dynamic shared
// memory it needs, or 0 for a chain it cannot take (a fiber wider than
// kMaxFiber, more shared memory than a block has).  kernels/tt_contract.py::
// fiber_tile computes the same layout.
size_t parse_fibers(const TTChain& chain, FiberChain* fc, int rows,
                    const void* x, const void* y) {
  if (rows < 1) return 0;
  fc->rows = rows;
  fc->stride = (chain.widest + 31) & ~31;
  fc->gp_floats = 0;
  int buffers = 1;
  int m_prefix = 1;
  int n_suffix = chain.in_dim;
  for (int k = 0; k < chain.L; ++k) {
    FiberStep& st = fc->step[k];
    n_suffix /= chain.in_modes[k];
    st.f_in = chain.ranks[k] * chain.in_modes[k];
    st.f_out = chain.out_modes[k] * chain.ranks[k + 1];
    if (st.f_in > kMaxFiber || st.f_out > kMaxFiber) return 0;
    st.cap = 4;
    while (st.cap < st.f_in || st.cap < st.f_out) st.cap *= 2;
    st.n_s = n_suffix;
    st.fpr = m_prefix * n_suffix;
    st.groups = st.fpr >= kFiberThreads ? 1 : kFiberThreads / st.fpr;
    st.step_mp = kFiberThreads / n_suffix;
    st.step_ns = kFiberThreads % n_suffix;
    st.magic_fpr = reciprocal(st.fpr);
    st.magic_ns = reciprocal(n_suffix);
    st.gp_off = fc->gp_floats;
    fc->gp_floats += st.cap * st.cap;
    st.in_place = st.f_in == st.f_out;
    if (!st.in_place) buffers = 2;
    m_prefix *= chain.out_modes[k];
  }
  fc->x = tile_io(chain.in_dim, x);
  fc->y = tile_io(chain.out_dim, y);
  const size_t core_floats = (chain.core_off[chain.L] + 3) & ~3;
  const size_t smem = (core_floats + fc->gp_floats +
                       static_cast<size_t>(buffers) * rows * fc->stride) *
                      sizeof(float);
  return smem > kMaxSmem ? 0 : smem;
}

// The opt-in past 48 KB, and the most shared memory per SM (the fiber
// tiling plans three blocks of up to 74 KB on one SM).
template <typename Kernel>
cudaError_t allow_fiber_smem(Kernel kernel, size_t smem) {
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// The chain and tiling of a batched launch; the dynamic shared memory it
// needs, or 0 for arguments the kernels cannot take.
size_t parse_batched(const void* desc, const void* x, const void* y,
                     int batch, int stack, int64_t x_stride_p, int rows,
                     TTChain* chain, FiberChain* fc) {
  if (!parse_chain(static_cast<const int64_t*>(desc), chain) || batch < 1 ||
      stack < 1 || stack > 65535 || x_stride_p < 0)
    return 0;
  return parse_fibers(*chain, fc, rows, x, y);
}

// The backward's tiling at `rows` rows per block (kernels/tt_contract.py::
// grad_tile computes the same layout); the dynamic shared memory it needs,
// or 0 for a chain it cannot take.
size_t parse_grad(const TTChain& chain, GradChain* gc, int rows,
                  const void* x, const void* dy, const void* dx,
                  int need_dx) {
  if (parse_fibers(chain, &gc->fwd, rows, x, nullptr) == 0) return 0;
  gc->fwd_buffers = 1;
  for (int k = 0; k < chain.L; ++k) {
    FiberStep& st = gc->back[k];
    st = gc->fwd.step[k];
    st.f_in = gc->fwd.step[k].f_out;
    st.f_out = gc->fwd.step[k].f_in;
    if (!st.in_place) gc->fwd_buffers = 2;
  }
  gc->back_buffers = gc->fwd_buffers;
  gc->dy = tile_io(chain.out_dim, dy);
  gc->dx = tile_io(chain.in_dim, dx);
  gc->need_dx = need_dx;
  gc->partial_floats = chain.core_off[chain.L];
  const size_t core_floats = (chain.core_off[chain.L] + 3) & ~3;
  const size_t smem =
      (core_floats + 2 * static_cast<size_t>(gc->fwd.gp_floats) +
       kRedSlots * 64 +
       static_cast<size_t>(gc->fwd_buffers + gc->back_buffers) * rows *
           gc->fwd.stride) * sizeof(float);
  return smem > kMaxSmem ? 0 : smem;
}

}  // namespace

// Plain C entry points, bound with ctypes.
//
// desc (host memory, int64): [L, widest, out_modes[L], in_modes[L],
//                             ranks[L+1], f32 core pointers[L]]
// All launch on `stream` without synchronizing and return
// cudaGetLastError() (or cudaErrorInvalidValue for arguments the kernel
// cannot take).
extern "C" int tt_contract_launch(const void* x, void* y, const void* desc_ptr,
                                  int batch, int rows, void* stream) {
  TTChain chain;
  FiberChain fc;
  if (!parse_chain(static_cast<const int64_t*>(desc_ptr), &chain) ||
      batch < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = parse_fibers(chain, &fc, rows, x, y);
  if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_fiber_smem(tt_contract_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (batch + rows - 1) / rows;
  tt_contract_kernel<<<blocks, kFiberThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), batch, chain, fc);
  return static_cast<int>(cudaGetLastError());
}

// x: (B, N) shared by every entry (x_stride_p = 0) or (P, B, N)
// (x_stride_p = B*N); core k: (P, |G_k|); y: (P, B, M).
extern "C" int tt_contract_batched_launch(const void* x, void* y,
                                          const void* desc_ptr, int batch,
                                          int stack, int64_t x_stride_p,
                                          int rows, void* stream) {
  TTChain chain;
  FiberChain fc;
  const size_t smem = parse_batched(desc_ptr, x, y, batch, stack, x_stride_p,
                                    rows, &chain, &fc);
  if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_fiber_smem(tt_contract_batched_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((batch + rows - 1) / rows, stack);
  tt_contract_batched_kernel<<<grid, kFiberThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), batch, x_stride_p,
      chain, fc);
  return static_cast<int>(cudaGetLastError());
}

// The batched entry on the f32 cores quantized in the kernel, in runs of
// `block`, to code_type 0 (int8) or 1 (fp8-e4m3); arguments as in
// tt_contract_batched_launch.
extern "C" int tt_contract_batched_quant_launch(
    const void* x, void* y, const void* desc_ptr, int batch, int stack,
    int64_t x_stride_p, int rows, int block, int code_type, void* stream) {
  TTChain chain;
  FiberChain fc;
  const size_t smem = parse_batched(desc_ptr, x, y, batch, stack, x_stride_p,
                                    rows, &chain, &fc);
  if (smem == 0 || block < 1 || (code_type != 0 && code_type != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  using QuantKernel = void (*)(const float*, float*, int, int64_t, TTChain,
                               FiberChain, int);
  const QuantKernel kernel = code_type == 0
                                 ? &tt_contract_batched_quant_kernel<0>
                                 : &tt_contract_batched_quant_kernel<1>;
  cudaError_t err = allow_fiber_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((batch + rows - 1) / rows, stack);
  kernel<<<grid, kFiberThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), batch, x_stride_p,
      chain, fc, block);
  return static_cast<int>(cudaGetLastError());
}

// The gradients of y = x @ W(cores)^T against dy: x (B, N), dy (B, M), dx
// (B, N) when need_dx (else unused), partials (ceil(B / rows), sum |G_k|)
// scratch, grad (sum |G_k|): the cores' gradients one after another, each
// laid out as its core.  Two kernels on `stream`: the blocks' pass and the
// fixed-order sum of their partials.
extern "C" int tt_contract_grad_launch(const void* x, const void* dy,
                                       void* dx, void* partials, void* grad,
                                       const void* desc_ptr, int batch,
                                       int rows, int need_dx, void* stream) {
  TTChain chain;
  GradChain gc;
  if (!parse_chain(static_cast<const int64_t*>(desc_ptr), &chain) ||
      batch < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = parse_grad(chain, &gc, rows, x, dy, dx, need_dx);
  if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_fiber_smem(tt_contract_grad_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (batch + rows - 1) / rows;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  tt_contract_grad_kernel<<<blocks, kFiberThreads, smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(dy),
      static_cast<float*>(dx), static_cast<float*>(partials), batch, chain,
      gc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int floats = gc.partial_floats;
  const int per_block = kGradSumThreads / 32;
  tt_contract_grad_sum_kernel<<<(floats + per_block - 1) / per_block,
                                kGradSumThreads, 0, s>>>(
      static_cast<const float*>(partials), blocks, floats,
      static_cast<float*>(grad));
  return static_cast<int>(cudaGetLastError());
}
