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
// outputs at the inputs' places in o (o == a: in place).  Thread tid takes the fibers q = tid % fpr, +
// kFiberThreads, ... and, for each, the rows tid / fpr, + groups, ...
template <int C>
__device__ __forceinline__ void fiber_step_exact(const float* a, float* o,
                                                 const float* gp,
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
        const float* ar = a + row * stride;
        float* orow = o + row * stride;
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
          *reinterpret_cast<float4*>(orow + off[c]) =
              make_float4(acc[4 * c], acc[4 * c + 1], acc[4 * c + 2],
                          acc[4 * c + 3]);
      }
    } else {
      int off[C];
#pragma unroll
      for (int j = 0; j < C; ++j) off[j] = swz(in0 + j * n_s);
#pragma unroll 1
      for (int row = rg; row < nrows; row += st.groups) {
        const float* ar = a + row * stride;
        float* orow = o + row * stride;
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
        for (int oi = 0; oi < C; ++oi) orow[off[oi]] = acc[oi];
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
__device__ __forceinline__ void fiber_step(const float* a, float* o,
                                           const float* gp,
                                           const FiberStep& st, int nrows,
                                           int stride, int tid) {
  if constexpr (C <= 8) {
    if (st.f_in == C && st.f_out == C) {
      fiber_step_exact<C>(a, o, gp, st, nrows, stride, tid);
      return;
    }
  }
  fiber_step_padded<C>(a, o, gp, st, nrows, stride, tid);
}

// One step of the fiber body at the template width of st.cap.
__device__ __forceinline__ void run_fiber_step(const float* a, float* o,
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
//   dA_k fiber   = gp . dA_{k+1} fiber    (the forward body's sum on gp^T)
//   dG_k[j][o]  += a_f[j] * dA_{k+1} fiber[o]   over every fiber,
// and dA_k has A_k's layout: a thread can write its fiber's dA_k over the
// a_f it has just read.
//
// What bounds it: x and dy read, dx written (12 KB a row at the paper's
// spec, 52.8 MB at the hidden layer's 4300 rows: 15.8 us at 3.35 TB/s),
// against ~90 KFMA a row (the forward steps, every dG_k and dA_k: 11.6 us
// at 67 TFLOP/s) and ~60 KB a row of shared-memory traffic.  The design:
//
// * One forward sweep, states kept on chip.  A block holds `saved` forward
//   states plus dA for a tile of `rows` rows (saved + 1 row buffers).  The
//   host (parse_grad) compiles a schedule of ops: the chain cut into
//   segments of `saved` states from its end; a segment's states are made
//   once (x loaded and stepped to its first state, the segment's steps run
//   out of place so each state keeps its buffer), then the segment's
//   reverse steps run on them.  With saved = L x is read once and each
//   forward step runs once; L - 1 runs the same steps and reads x again
//   for the last reverse step (the paper's hidden layer: a row more a
//   tile); a wider row saves fewer states and recomputes more, in the
//   same kernel.
// * Reverse step k over the tile: each thread adds a_f (x) d_f into its
//   register tile of dG_k over its fibers of step k (fibers up to 8 wide:
//   the whole C x C tile; 16 or 32: 8 x 8 tiles, a warp a tile), then the
//   forward body steps dA_{k+1} back over A_k on the transposed core.  Up
//   to 8 wide both walk the same fibers on the same threads, so no barrier
//   parts them, and the dG tile (64 registers) and the core (64) are never
//   live together: fused into one loop they spilled.
// * The combine costs a fixed amount per tile and k: a butterfly
//   reduce-scatter over each warp's 32 lanes (62 shuffles for 64 values,
//   where a tree costs 320), the warps' sums added in warp order through
//   shared memory and into the block's partial of sum |G_k| floats.
// * Persistent blocks: at most one wave of them (parse_grad's `blocks`),
//   block i taking the row tiles i, i + blocks, ... and adding each tile's
//   sums to its partial in tile order, so the cores' setup and the ticket
//   below are paid once a block, and the tiles spread evenly.
// * One launch a call: after its partial every block takes a ticket of
//   its group (ceil(sqrt(blocks)) blocks a group, at least 32: one level
//   up to 32 blocks); the group's last block sums the group's partials in
//   block order, and the last group's the group sums in group order, into
//   grad, resetting the tickets to 0.  No
//   float atomics and no order that depends on arrival: two calls on the
//   same inputs give the same bits.  The tickets belong to one call at a
//   time: calls on one device must not overlap on two streams.
// * The kernel is instantiated for the widest step (kCap 8, 16 or 32), so
//   the paper's instantiation carries no code of wider fibers.

constexpr int kGradWarps = kFiberThreads / 32;
constexpr int kRedFloats = 16 * 64;   // the combine's staging: 16 8x8 tiles
constexpr int kMaxGradOps = 96;       // >= 2L + L*L + 2 for L <= kMaxCores
constexpr int kSumChunk = 16;         // partials summed pairwise 16 at a time
constexpr int kSumGroup = 32;         // the fewest blocks a group of the sum

enum GradOpCode : int { kOpLoadX, kOpLoadDy, kOpForward, kOpReverse,
                        kOpStoreDx };

// One op of a block's schedule.  kOpForward: A_{k+1} = step_k(buffer a)
// into buffer b.  kOpReverse: dG_k from A_k (buffer a) and dA_{k+1}
// (buffer b); dA_k over buffer a unless k == 0 and dx is not needed.  The
// loads and the store move x, dy or dx through buffer a.
struct GradOp {
  int code;
  int k;
  int a;
  int b;
  int sync;                 // __syncthreads() after the op
};

struct GradChain {
  FiberChain fwd;           // the forward steps, rows, stride, the x tile
  FiberStep back[kMaxCores];  // step k, widths swapped: dA_{k+1} -> dA_k
  unsigned long long magic_nk[kMaxCores];  // ceil(2^32 / n_k)
  unsigned long long magic_rn[kMaxCores];  // ceil(2^32 / r_{k+1})
  TileIO dy, dx;
  int saved;                // forward states kept; saved + 1 row buffers
  int ops;
  GradOp op[kMaxGradOps];
  int partial_floats;       // sum |G_k|: one block's partial
  int tiles;                // row tiles: ceil(batch / rows)
  int blocks;               // the grid, at most tiles
  int group;                // blocks a group (the first level of the sum)
  int groups;
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

// Round S of butterfly<NV> on a lane holding N values (N, S compile-time, so
// every index is static and the values stay in registers).
template <int NV, int N, int S>
__device__ __forceinline__ void butterfly_round(float (&v)[NV], int lane) {
  if constexpr (N >= 2) {
    const bool upper = (lane & S) != 0;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float send = upper ? v[i] : v[i + N / 2];
      const float keep = upper ? v[i + N / 2] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, S);
    }
  } else {
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], S);
  }
  if constexpr (S > 1) butterfly_round<NV, (N >= 2 ? N / 2 : 1), S / 2>(v, lane);
}

// Sums NV values over a warp's 32 lanes, each lane ending with NV/32 sums
// (or one, for NV < 32): round s = 16, 8, ..., 1 halves the values a lane
// holds, the lane with bit s set keeping the upper half and adding its
// partner's; once a lane holds one value the rounds add it to its
// partner's.  Every value passes through 5 additions.  Afterwards lane l
// holds, as v[i], the sum of value (l >> (5 - R)) * (NV >> R) + i, R =
// min(5, log2 NV); lanes with a nonzero (l mod 2^(5 - R)) hold copies.
template <int NV>
__device__ __forceinline__ void butterfly(float (&v)[NV], int lane) {
  butterfly_round<NV, NV, 16>(v, lane);
}

// After butterfly<NV>, lane `lane` of warp `slot` writes its sums to
// red[slot * NV + index].
template <int NV>
__device__ __forceinline__ void stage_sums(const float (&v)[NV], float* red,
                                           int slot, int lane) {
  // rounds of halving in butterfly<NV> (NV 16 or 64): log2 NV, at most 5
  constexpr int R = NV >= 32 ? 5 : NV >= 16 ? 4 : NV >= 8 ? 3 : 2;
  constexpr int kHeld = NV >> R;
  if ((lane & ((1 << (5 - R)) - 1)) != 0) return;
  float* dst = red + slot * NV + (lane >> (5 - R)) * kHeld;
#pragma unroll
  for (int i = 0; i < kHeld; ++i) dst[i] = v[i];
}

// Position of dG_k[j][o] (j = r*n_k + nki, o = mki*r' + rni) in G_k[r, mki,
// nki, rni].
__device__ __forceinline__ int core_index(const TTChain& chain,
                                          const GradChain& gc, int k, int j,
                                          int o) {
  const int nk = chain.in_modes[k];
  const int rn = chain.ranks[k + 1];
  const int r = fast_div(j, gc.magic_nk[k]);
  const int mki = fast_div(o, gc.magic_rn[k]);
  return ((r * chain.out_modes[k] + mki) * nk + (j - r * nk)) * rn +
         (o - mki * rn);
}

// Writes or adds (after the first tile of a block) one sum of dG_k to the
// block's partial.  The same thread takes the same element in every tile.
__device__ __forceinline__ void add_partial(float* part, int e, float sum,
                                            bool first) {
  part[e] = first ? sum : part[e] + sum;
}

// This thread's C x C tile of dG_k over its fibers of step k, acc[j][o] +=
// a_f[j] * d_f[o], walking the fibers as the forward body walks them
// (fiber q = tid % fpr, + kFiberThreads, ...; rows tid / fpr, + groups,
// ...), so that the back step after it touches only fibers this thread has
// read.  Fibers of exactly C inputs and outputs load as float4 where
// contiguous; narrower ones pad with 0.
template <int C>
__device__ __forceinline__ void reduce_fibers(const float* a, const float* d,
                                              const FiberStep& st, int nrows,
                                              int stride, int tid,
                                              float (&acc)[C * C]) {
  const int rg = fast_div(tid, st.magic_fpr);
  if (rg >= st.groups) return;
  const int n_s = st.n_s;
  const int fi = st.f_in;
  const int fo = st.f_out;
  const bool vec = fi == C && fo == C && n_s == 1;
  int q = tid - rg * st.fpr;
  int mp = fast_div(q, st.magic_ns);
  int ns = q - mp * n_s;
#pragma unroll 1
  for (; q < st.fpr; q += kFiberThreads) {
    const int a0 = mp * fi * n_s + ns;      // A_k input j at a0 + j * n_s
    const int d0 = mp * fo * n_s + ns;      // dA_{k+1} output o at d0 + o * n_s
#pragma unroll 1
    for (int row = rg; row < nrows; row += st.groups) {
      const float* ar = a + row * stride;
      const float* dr = d + row * stride;
      float av[C], dv[C];
      if (vec) {
#pragma unroll
        for (int c = 0; c < C / 4; ++c) {
          const float4 u = *reinterpret_cast<const float4*>(ar + swz(a0 + 4 * c));
          const float4 w = *reinterpret_cast<const float4*>(dr + swz(d0 + 4 * c));
          av[4 * c] = u.x; av[4 * c + 1] = u.y;
          av[4 * c + 2] = u.z; av[4 * c + 3] = u.w;
          dv[4 * c] = w.x; dv[4 * c + 1] = w.y;
          dv[4 * c + 2] = w.z; dv[4 * c + 3] = w.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < C; ++j) {
          av[j] = j < fi ? ar[swz(a0 + j * n_s)] : 0.0f;
          dv[j] = j < fo ? dr[swz(d0 + j * n_s)] : 0.0f;
        }
      }
#pragma unroll
      for (int j = 0; j < C; ++j) {
#pragma unroll
        for (int o = 0; o < C; ++o)
          acc[j * C + o] = fmaf(av[j], dv[o], acc[j * C + o]);
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

// Reverse step k for fibers up to 8 wide (cap C = 4 or 8): dG_k over this
// thread's fibers, summed by butterfly into red (one slot a warp); then
// dA_{k+1} -> dA_k over A_k by the forward body on the transposed core
// (same fibers, same threads: no barrier between); then the four warps'
// sums added in warp order into the block's partial.
template <int C>
__device__ __forceinline__ void reverse_small(const TTChain& chain,
                                              const GradChain& gc, int k,
                                              float* a, const float* d,
                                              const float* gpT, bool da,
                                              float* red, float* part,
                                              bool first, int nrows,
                                              int tid) {
  constexpr int NV = C * C;
  const FiberStep& st = gc.fwd.step[k];
  {
    float acc[NV];
#pragma unroll
    for (int e = 0; e < NV; ++e) acc[e] = 0.0f;
    reduce_fibers<C>(a, d, st, nrows, gc.fwd.stride, tid, acc);
    butterfly<NV>(acc, tid & 31);
    stage_sums<NV>(acc, red, tid >> 5, tid & 31);
  }
  if (da) fiber_step<C>(d, a, gpT, gc.back[k], nrows, gc.fwd.stride, tid);
  __syncthreads();
  if (tid < NV) {
    const int j = tid / C;
    const int o = tid - j * C;
    if (j < st.f_in && o < st.f_out) {
      float sum = red[tid];
#pragma unroll
      for (int w = 1; w < kGradWarps; ++w) sum += red[w * NV + tid];
      add_partial(part, chain.core_off[k] + core_index(chain, gc, k, j, o),
                  sum, first);
    }
  }
}

// Reverse step k for fibers 16 or 32 wide: dG_k in 8 x 8 tiles (T of them).
// With T' = T rounded up to a power of 2, each tile takes wpt = 4 /
// min(4, T') warps and each warp the tiles warp / wpt, + 4 / wpt, ...; the
// wpt * 32 lanes of a tile split each row's fibers (lane l: fibers l, +
// wpt * 32, ...), rows in order.  Each warp's tile is summed by butterfly
// into red, the wpt warps' sums added in order into the partial.  Then the
// forward body steps dA_{k+1} back over A_k on the transposed core.
template <int C>
__device__ __forceinline__ void reverse_tiles(const TTChain& chain,
                                              const GradChain& gc, int k,
                                              float* a, const float* d,
                                              const float* gpT, bool da,
                                              float* red, float* part,
                                              bool first, int nrows,
                                              int tid) {
  const FiberStep& st = gc.fwd.step[k];
  const int stride = gc.fwd.stride;
  const int fi = st.f_in;
  const int fo = st.f_out;
  const int n_s = st.n_s;
  const int to_n = (fo + 7) / 8;
  const int tiles = ((fi + 7) / 8) * to_n;
  int tiles_p2 = 1;
  while (tiles_p2 < tiles) tiles_p2 *= 2;
  const int wpt = kGradWarps / min(kGradWarps, tiles_p2);
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int sub = warp % wpt;
  const int span = wpt * 32;                // lanes a tile
  const int l0 = sub * 32 + lane;
  const int span_mp = span / n_s;           // once per call, not per fiber
  const int span_ns = span - span_mp * n_s;
  const int mp0 = l0 / n_s;
  const int ns0 = l0 - mp0 * n_s;
#pragma unroll 1
  for (int t = warp / wpt; t < tiles; t += kGradWarps / wpt) {
    const int tj = t / to_n;
    const int j0 = tj * 8;
    const int o0 = (t - tj * to_n) * 8;
    float acc[64];
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = 0.0f;
#pragma unroll 1
    for (int row = 0; row < nrows; ++row) {
      const float* ar = a + row * stride;
      const float* dr = d + row * stride;
      int mp = mp0;
      int ns = ns0;
#pragma unroll 1
      for (int q = l0; q < st.fpr; q += span) {
        const int a0 = mp * fi * n_s + ns;
        const int d0 = mp * fo * n_s + ns;
        float av[8], dv[8];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          av[c] = j0 + c < fi ? ar[swz(a0 + (j0 + c) * n_s)] : 0.0f;
          dv[c] = o0 + c < fo ? dr[swz(d0 + (o0 + c) * n_s)] : 0.0f;
        }
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
          for (int oo = 0; oo < 8; ++oo)
            acc[jj * 8 + oo] = fmaf(av[jj], dv[oo], acc[jj * 8 + oo]);
        }
        ns += span_ns;
        mp += span_mp;
        if (ns >= n_s) {
          ns -= n_s;
          ++mp;
        }
      }
    }
    butterfly<64>(acc, lane);
    stage_sums<64>(acc, red, t * wpt + sub, lane);
  }
  __syncthreads();
  for (int idx = tid; idx < tiles * 64; idx += kFiberThreads) {
    const int t = idx >> 6;
    const int e = idx & 63;
    const int tj = t / to_n;
    const int j = tj * 8 + (e >> 3);
    const int o = (t - tj * to_n) * 8 + (e & 7);
    if (j >= fi || o >= fo) continue;
    const float* slot = red + t * wpt * 64 + e;
    float sum = slot[0];
    for (int h = 1; h < wpt; ++h) sum += slot[h * 64];
    add_partial(part, chain.core_off[k] + core_index(chain, gc, k, j, o), sum,
                first);
  }
  if (da) {                                 // dA_{k+1} -> dA_k over A_k
    __syncthreads();
    const FiberStep& bst = gc.back[k];
    fiber_step_padded<C>(d, a, gpT, bst, nrows, stride, tid);
  }
}

// Reverse step k at the template width of its cap, up to kCap.
template <int kCap>
__device__ __forceinline__ void reverse_step(const TTChain& chain,
                                             const GradChain& gc, int k,
                                             float* a, const float* d,
                                             const float* gpT_all, bool da,
                                             float* red, float* part,
                                             bool first, int nrows, int tid) {
  const FiberStep& st = gc.fwd.step[k];
  const float* gpT = gpT_all + st.gp_off;
  if (st.cap == 4) {
    reverse_small<4>(chain, gc, k, a, d, gpT, da, red, part, first, nrows,
                     tid);
  } else if (kCap == 8 || st.cap == 8) {
    reverse_small<8>(chain, gc, k, a, d, gpT, da, red, part, first, nrows,
                     tid);
  } else if constexpr (kCap >= 16) {
    if (kCap == 16 || st.cap == 16)
      reverse_tiles<16>(chain, gc, k, a, d, gpT, da, red, part, first, nrows,
                        tid);
    else if constexpr (kCap == 32)
      reverse_tiles<32>(chain, gc, k, a, d, gpT, da, red, part, first, nrows,
                        tid);
  }
}

// A forward step at the template width of its cap, up to kCap.
template <int kCap>
__device__ __forceinline__ void forward_step(const float* a, float* o,
                                             const float* gp,
                                             const FiberStep& st, int nrows,
                                             int stride, int tid) {
  if (st.cap == 4) {
    fiber_step<4>(a, o, gp, st, nrows, stride, tid);
  } else if (kCap == 8 || st.cap == 8) {
    fiber_step<8>(a, o, gp, st, nrows, stride, tid);
  } else if constexpr (kCap >= 16) {
    if (kCap == 16 || st.cap == 16)
      fiber_step<16>(a, o, gp, st, nrows, stride, tid);
    else if constexpr (kCap == 32)
      fiber_step<32>(a, o, gp, st, nrows, stride, tid);
  }
}

// v[0] = the pairwise sum of v[0..kSumChunk), level W and up (W
// compile-time: static indices, registers).
template <int V, int W>
__device__ __forceinline__ void pairwise(float (&v)[kSumChunk][V]) {
#pragma unroll
  for (int i = 0; i < kSumChunk; i += 2 * W) {
#pragma unroll
    for (int c = 0; c < V; ++c) v[i][c] += v[i + W][c];
  }
  if constexpr (2 * W < kSumChunk) pairwise<V, 2 * W>(v);
}

// dst[e] = the sum over b < n of src[b * floats + e] for e < floats, read
// through L2 (other blocks wrote src).  V floats side by side a thread
// (float4 when floats % 4 == 0): cols = floats / V columns, split into
// parts = min(kFiberThreads / cols, n) ranges of blocks (1 when cols >=
// kFiberThreads), part p taking blocks [p*n/parts, (p+1)*n/parts).  A part
// adds kSumChunk blocks at a time pairwise, the chunks in order; the parts'
// sums are added in part order through `scratch` (parts * floats floats).
template <int V>
__device__ __forceinline__ void sum_partials(const float* src, int n,
                                             int floats, float* dst,
                                             float* scratch, int tid) {
  const int cols = floats / V;
  const int parts = cols >= kFiberThreads
                        ? 1
                        : min(kFiberThreads / cols, n);
  const int p = tid / cols;
  if (p < parts) {
    const int b_lo = p * n / parts;
    const int b_hi = (p + 1) * n / parts;
    float* out = parts == 1 ? dst : scratch + p * floats;
    for (int col = tid - p * cols; col < cols; col += kFiberThreads) {
      float sum[V];
#pragma unroll 1
      for (int b0 = b_lo; b0 < b_hi; b0 += kSumChunk) {
        float v[kSumChunk][V];
#pragma unroll
        for (int i = 0; i < kSumChunk; ++i) {
          if (b0 + i < b_hi) {
            const float* at = src + (size_t)(b0 + i) * floats + col * V;
            if constexpr (V == 4) {
              const float4 u = __ldcg(reinterpret_cast<const float4*>(at));
              v[i][0] = u.x;
              v[i][1] = u.y;
              v[i][2] = u.z;
              v[i][3] = u.w;
            } else {
              v[i][0] = __ldcg(at);
            }
          } else {
#pragma unroll
            for (int c = 0; c < V; ++c) v[i][c] = 0.0f;
          }
        }
        pairwise<V, 1>(v);
#pragma unroll
        for (int c = 0; c < V; ++c)
          sum[c] = b0 == b_lo ? v[0][c] : sum[c] + v[0][c];
      }
#pragma unroll
      for (int c = 0; c < V; ++c) out[col * V + c] = sum[c];
    }
  }
  if (parts == 1) return;
  __syncthreads();
  for (int e = tid; e < floats; e += kFiberThreads) {
    float sum = scratch[e];
    for (int q = 1; q < parts; ++q) sum += scratch[q * floats + e];
    dst[e] = sum;
  }
}

__device__ __forceinline__ void sum_partials_any(const float* src, int n,
                                                 int floats, float* dst,
                                                 float* scratch, int tid) {
  if (floats % 4 == 0)
    sum_partials<4>(src, n, floats, dst, scratch, tid);
  else
    sum_partials<1>(src, n, floats, dst, scratch, tid);
}

// A grid of gc.blocks blocks (at most one wave of block slots): block i
// takes the row tiles i, i + blocks, ... in turn (gc.fwd.rows rows each of
// x and dy), runs the schedule on each (writing its dx when dx is given),
// and adds each tile's sum of every dG_k to its partial at partials + i *
// partial_floats in tile order; then the two-level sum.  Shared memory:
// the cores as loaded, gp, gpT, red, saved + 1 row buffers.
// kCap: the widest step's template width, 8 (every step 4 or 8 wide), 16
// or 32; the narrower instantiations carry no code of the wider steps.
template <int kCap>
__global__ void __launch_bounds__(kFiberThreads, 3)
tt_contract_grad_kernel(const float* __restrict__ x,
                        const float* __restrict__ dy, float* __restrict__ dx,
                        float* __restrict__ partials,
                        float* __restrict__ grad, int* __restrict__ tickets,
                        int batch, const __grid_constant__ TTChain chain,
                        const __grid_constant__ GradChain gc) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const FiberChain& fc = gc.fwd;
  const int core_floats = (chain.core_off[chain.L] + 3) & ~3;
  float* g_all = smem;
  float* gp_all = g_all + core_floats;
  float* gpT_all = gp_all + fc.gp_floats;
  float* red = gpT_all + fc.gp_floats;
  float* bufs = red + kRedFloats;
  const int buf = fc.rows * fc.stride;
  const int tid = threadIdx.x;
  const int floats = gc.partial_floats;
  float* part = partials + (size_t)blockIdx.x * floats;

  CopyCores{0}(chain, g_all, tid);
  __syncthreads();
  repack_cores(chain, fc, g_all, gp_all, tid);
  __syncthreads();
  transpose_cores(chain, fc, gp_all, gpT_all, tid);
  // the first op's barrier (after dy's load) orders gpT before its use
#pragma unroll 1
  for (int tile = blockIdx.x; tile < gc.tiles; tile += gc.blocks) {
    const int row0 = tile * fc.rows;
    const int nrows = min(fc.rows, batch - row0);
    const bool first = tile == blockIdx.x;
#pragma unroll 1
    for (int i = 0; i < gc.ops; ++i) {
      const GradOp& op = gc.op[i];
      float* a = bufs + op.a * buf;
      float* b = bufs + op.b * buf;
      switch (op.code) {
        case kOpLoadX:
          move_tile<true>(x + (size_t)row0 * chain.in_dim, a, nrows,
                          chain.in_dim, fc.x, fc.stride, tid);
          break;
        case kOpLoadDy:
          move_tile<true>(dy + (size_t)row0 * chain.out_dim, a, nrows,
                          chain.out_dim, gc.dy, fc.stride, tid);
          break;
        case kOpForward:
          forward_step<kCap>(a, b, gp_all + fc.step[op.k].gp_off,
                             fc.step[op.k], nrows, fc.stride, tid);
          break;
        case kOpReverse:
          reverse_step<kCap>(chain, gc, op.k, a, b, gpT_all,
                             op.k > 0 || dx, red, part, first, nrows, tid);
          break;
        default:
          move_tile<false>(a, dx + (size_t)row0 * chain.in_dim, nrows,
                           chain.in_dim, gc.dx, fc.stride, tid);
          break;
      }
      if (op.sync) __syncthreads();
    }
  }

  // The two-level sum.  The block's partials are ordered before its
  // group's ticket by the barrier and one thread's fence (as a grid
  // barrier orders a block's writes); the last block of a group sums the
  // group's blocks in block order (into grad when there is one group), the
  // last group's last block the group sums in group order.  red holds the
  // two flags, then the sums' scratch.
  int* last = reinterpret_cast<int*>(red);
  float* scratch = red + 4;
  const int group = blockIdx.x / gc.group;
  const int first = group * gc.group;
  const int members = min(gc.group, gc.blocks - first);
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    last[0] = atomicAdd(tickets + group, 1) == members - 1;
    if (last[0]) __threadfence();
  }
  __syncthreads();
  if (!last[0]) return;
  float* level = gc.groups == 1
                     ? grad
                     : partials + (size_t)(gc.blocks + group) * floats;
  sum_partials_any(partials + (size_t)first * floats, members, floats, level,
                   scratch, tid);
  if (gc.groups == 1) {
    if (tid == 0) tickets[group] = 0;
    return;
  }
  __syncthreads();
  if (tid == 0) {
    tickets[group] = 0;
    __threadfence();
    last[1] = atomicAdd(tickets + gc.groups, 1) == gc.groups - 1;
    if (last[1]) __threadfence();
  }
  __syncthreads();
  if (!last[1]) return;
  sum_partials_any(partials + (size_t)gc.blocks * floats, gc.groups, floats,
                   grad, scratch, tid);
  if (tid == 0) tickets[gc.groups] = 0;
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

// The backward's layout at `rows` rows a block and `saved` forward states
// (kernels/tt_contract.py::grad_tile computes the same), its schedule and
// the two-level sum of its `batch` rows' partials; the dynamic shared
// memory it needs, or 0 for arguments it cannot take.  The schedule cuts
// the chain into segments of `saved` states from its end.  For each: x
// loaded and stepped to the segment's first state (in place, or between two
// buffers), the segment's states made out of place into buffers of their
// own, dy loaded with the first x, then the reverse steps from the
// segment's end, dA_k taking A_k's buffer.  Buffers are taken lowest first.
size_t parse_grad(const TTChain& chain, GradChain* gc, int batch, int rows,
                  int saved, int blocks, const void* x, const void* dy,
                  const void* dx) {
  if (batch < 1 || parse_fibers(chain, &gc->fwd, rows, x, nullptr) == 0)
    return 0;
  gc->tiles = (batch + rows - 1) / rows;
  if (blocks < 1 || blocks > gc->tiles) return 0;
  gc->blocks = blocks;
  const int L = chain.L;
  bool steps_in_place = true;               // steps 0..L-2: the forward's
  for (int k = 0; k < L; ++k) {
    FiberStep& st = gc->back[k];
    st = gc->fwd.step[k];
    st.f_in = gc->fwd.step[k].f_out;
    st.f_out = gc->fwd.step[k].f_in;
    gc->magic_nk[k] = reciprocal(chain.in_modes[k]);
    gc->magic_rn[k] = reciprocal(chain.ranks[k + 1]);
    if (k < L - 1 && !gc->fwd.step[k].in_place) steps_in_place = false;
  }
  if (saved < (L > 1 && !steps_in_place ? 2 : 1) || saved > L) return 0;
  gc->saved = saved;
  const bool need_dx = dx != nullptr;
  unsigned free_bufs = (1u << (saved + 1)) - 1;
  int n = 0;
  bool ok = true;
  auto take = [&]() {
    if (free_bufs == 0) {
      ok = false;
      return 0;
    }
    const int b = __builtin_ctz(free_bufs);
    free_bufs &= free_bufs - 1;
    return b;
  };
  auto give = [&](int b) { free_bufs |= 1u << b; };
  auto emit = [&](int code, int k, int a, int b) {
    if (n == kMaxGradOps) {
      ok = false;
      return;
    }
    gc->op[n++] = GradOp{code, k, a, b, 1};
  };
  int d = -1;
  int state[kMaxCores];
  for (int end = L; end > 0;) {
    const int start = end > saved ? end - saved : 0;
    int cur = take();
    emit(kOpLoadX, 0, cur, 0);
    if (d < 0) {                            // dy beside the first x
      gc->op[n - 1].sync = 0;
      d = take();
      emit(kOpLoadDy, 0, d, 0);
    }
    for (int s = 0; s < start; ++s) {
      if (gc->fwd.step[s].in_place) {
        emit(kOpForward, s, cur, cur);
      } else {
        const int next = take();
        emit(kOpForward, s, cur, next);
        give(cur);
        cur = next;
      }
    }
    state[start] = cur;
    for (int k = start; k < end - 1; ++k) {
      state[k + 1] = take();
      emit(kOpForward, k, state[k], state[k + 1]);
    }
    for (int k = end - 1; k >= start; --k) {
      emit(kOpReverse, k, state[k], d);
      give(d);
      d = state[k];
    }
    end = start;
  }
  if (need_dx) emit(kOpStoreDx, 0, d, 0);
  if (!ok) return 0;
  gc->ops = n;
  gc->dy = tile_io(chain.out_dim, dy);
  gc->dx = tile_io(chain.in_dim, dx);
  gc->partial_floats = chain.core_off[L];
  gc->group = 1;                            // ceil(sqrt(blocks)), and at
  while (static_cast<int64_t>(gc->group) * gc->group < gc->blocks)
    ++gc->group;                            // least kSumGroup (one level
  gc->group = max(gc->group, min(gc->blocks, kSumGroup));   // up to it)
  gc->groups = (gc->blocks + gc->group - 1) / gc->group;
  const size_t core_floats = (chain.core_off[L] + 3) & ~3;
  const size_t smem =
      (core_floats + 2 * static_cast<size_t>(gc->fwd.gp_floats) +
       kRedFloats +
       static_cast<size_t>(saved + 1) * rows * gc->fwd.stride) *
      sizeof(float);
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
// (B, N) or null (dx not needed), partials (blocks + groups, sum |G_k|)
// scratch, grad (sum |G_k|): the cores' gradients one after another, each
// laid out as its core; tickets (groups + 1) int32, zero, and zero again
// when the kernel ends.  `rows` rows a tile, `saved` forward states,
// `blocks` blocks (1 to ceil(B / rows)), groups = ceil(blocks /
// ceil(sqrt(blocks))).  One kernel on `stream`.
extern "C" int tt_contract_grad_launch(const void* x, const void* dy,
                                       void* dx, void* partials, void* grad,
                                       void* tickets, const void* desc_ptr,
                                       int batch, int rows, int saved,
                                       int blocks, void* stream) {
  TTChain chain;
  GradChain gc;
  if (!parse_chain(static_cast<const int64_t*>(desc_ptr), &chain))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      parse_grad(chain, &gc, batch, rows, saved, blocks, x, dy, dx);
  if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  int cap = 4;
  for (int k = 0; k < chain.L; ++k) cap = max(cap, gc.fwd.step[k].cap);
  using GradKernel = void (*)(const float*, const float*, float*, float*,
                              float*, int*, int, TTChain, GradChain);
  const GradKernel kernel = cap <= 8    ? &tt_contract_grad_kernel<8>
                            : cap <= 16 ? &tt_contract_grad_kernel<16>
                                        : &tt_contract_grad_kernel<32>;
  cudaError_t err = allow_fiber_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<gc.blocks, kFiberThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dy),
      static_cast<float*>(dx), static_cast<float*>(partials),
      static_cast<float*>(grad), static_cast<int*>(tickets), batch, chain,
      gc);
  return static_cast<int>(cudaGetLastError());
}
