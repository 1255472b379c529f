// Fused TT-chain contraction for Hopper (sm_90a): y = x @ W(cores)^T, for
// one core set (tt_contract), P stacked core sets (tt_contract_batched) or
// P stacked block-quantized core sets (tt_contract_batched_quant).
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
// Two bodies run that step.  chain_rows (tt_contract_batched) gives each
// thread one output element per turn: three runtime divisions and 16 shared
// loads buy 8 FMAs, in blocks of 5 rows.  chain_fibers (tt_contract and
// tt_contract_batched_quant) gives each thread a fiber: one (row, mp, ns),
// whose r*n_k inputs a[row, mp, :, :, ns] it loads into registers once and
// turns into all m_k*r' outputs out[row, mp, :, :, ns], against the step's
// core held in registers (or read as warp-wide broadcasts when it is larger
// than 64 floats).  The fiber widths are template arguments (4, 8, 16 or 32,
// the cap; narrower fibers pad their inputs with +0 and the core's rows with
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
// Both bodies give each output element the same sum in the same order:
// acc = 0, then acc = fmaf(a[r, nk], G[r, mk, nk, rn], acc) over r, then
// n_k.  So every row's arithmetic is the same whatever tile, body or kernel
// it lands in: padding a batch cannot change the values of the real rows,
// entry p of the batched kernel equals tt_contract(x[p], cores[p]) bit for
// bit, and so does the quantized kernel on the fake-quantized cores.
//
// The quantized kernel reads entry p's cores as narrow codes (int8 or
// fp8-e4m3, one byte each, (P, padded_k) per core, padded_k the core's size
// rounded up to the block) and f32 scales ((P, padded_k / block)).  It
// dequantizes them into the shared core buffer before the chain, one f32
// multiply per element (code * scale of its block) with nothing added, so
// the buffer holds exactly kernels/quant.py::fake_quant_stacked's values
// (the fiber body then only permutes them), and entry p equals
// tt_contract_batched on the fake-quantized cores bit for
// bit.  The multiply stays outside the chain's FMA loop, where nvcc could
// contract it into an fmaf and round once instead of twice.  The codes and
// scales add ~0.3 KB per entry at the paper's spec (256 codes, 8 scales at
// block 32) against 8 KB of x and y per row: the bound is the f32 kernel's.

#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxCores = 8;
constexpr int kThreads = 256;

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

// Block-quantized cores of the quantized kernel (the chain's `cores`
// pointers are unused there).
struct QuantCores {
  int block;
  const uint8_t* codes[kMaxCores];  // (P, padded_k) narrow codes, 1 byte each
  const float* scales[kMaxCores];   // (P, padded_k / block)
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

// Dequantizes entry p's codes of type Code into the shared core buffer:
// element i of core k is float(code[i]) * scale[i / block]; the padding past
// |G_k| is dropped.
template <typename Code>
struct DequantCores {
  const QuantCores& q;
  size_t p;
  __device__ __forceinline__ void operator()(const TTChain& chain,
                                             float* g_all, int tid) const {
    for (int k = 0; k < chain.L; ++k) {
      const int size = chain.core_off[k + 1] - chain.core_off[k];
      const int padded = (size + q.block - 1) / q.block * q.block;
      const Code* codes =
          reinterpret_cast<const Code*>(q.codes[k]) + p * padded;
      const float* scales = q.scales[k] + p * (padded / q.block);
      float* dst = g_all + chain.core_off[k];
      for (int i = tid; i < size; i += blockDim.x)
        dst[i] = __fmul_rn(static_cast<float>(codes[i]), scales[i / q.block]);
    }
  }
};

// The chain for `nrows` contiguous rows of one stack entry: xs -> ys, with
// the entry's cores packed into shared memory by `load_cores` (CopyCores or
// DequantCores).
template <typename LoadCores>
__device__ __forceinline__ void chain_rows(const float* __restrict__ xs,
                                           float* __restrict__ ys, int nrows,
                                           int rows_per_block,
                                           const TTChain& chain,
                                           const LoadCores& load_cores) {
  extern __shared__ float smem[];
  const int core_floats = (chain.core_off[chain.L] + 3) & ~3;
  float* g_all = smem;
  float* buf_a = smem + core_floats;
  float* buf_b = buf_a + rows_per_block * chain.widest;
  const int tid = threadIdx.x;

  load_cores(chain, g_all, tid);
  // this tile's input rows, contiguous in device memory
  for (int i = tid; i < nrows * chain.in_dim; i += blockDim.x) {
    const int r = i / chain.in_dim;
    buf_a[r * chain.widest + (i - r * chain.in_dim)] = xs[i];
  }
  __syncthreads();

  float* a = buf_a;
  float* o = buf_b;
  int m_prefix = 1;
  int n_suffix = chain.in_dim;
  for (int k = 0; k < chain.L; ++k) {
    const int r = chain.ranks[k];
    const int mk = chain.out_modes[k];
    const int nk = chain.in_modes[k];
    const int rn = chain.ranks[k + 1];
    n_suffix /= nk;
    const float* g = g_all + chain.core_off[k];
    const int per_row = m_prefix * mk * rn * n_suffix;
    const int a_mp_stride = r * nk * n_suffix;
    for (int e = tid; e < nrows * per_row; e += blockDim.x) {
      const int row = e / per_row;
      const int rem = e - row * per_row;
      int t = rem / n_suffix;
      const int ns = rem - t * n_suffix;
      const int rni = t % rn;
      t /= rn;
      const int mki = t % mk;
      const int mp = t / mk;
      const float* ar = a + row * chain.widest + mp * a_mp_stride + ns;
      const float* gr = g + mki * nk * rn + rni;   // G[ri, mki, nki, rni]
      float acc = 0.0f;
      for (int ri = 0; ri < r; ++ri) {
        for (int nki = 0; nki < nk; ++nki) {
          acc = fmaf(ar[(ri * nk + nki) * n_suffix],
                     gr[(ri * mk * nk + nki) * rn], acc);
        }
      }
      o[row * chain.widest + rem] = acc;
    }
    __syncthreads();
    float* tmp = a;
    a = o;
    o = tmp;
    m_prefix *= mk;
  }

  for (int i = tid; i < nrows * chain.out_dim; i += blockDim.x) {
    const int r = i / chain.out_dim;
    ys[i] = a[r * chain.widest + (i - r * chain.out_dim)];
  }
}

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

// The chain for `nrows` contiguous rows of one stack entry (xs -> ys) by
// fibers; `load_cores` as for chain_rows.  Shared memory: the cores as
// loaded, the repacked cores, then one row buffer (every step in place) or
// two (ping-pong), each fc.rows * fc.stride floats.
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
    const float* gp = gp_all + st.gp_off;
    switch (st.cap) {
      case 4: fiber_step<4>(a, out, gp, st, nrows, fc.stride, tid); break;
      case 8: fiber_step<8>(a, out, gp, st, nrows, fc.stride, tid); break;
      case 16: fiber_step<16>(a, out, gp, st, nrows, fc.stride, tid); break;
      default: fiber_step<32>(a, out, gp, st, nrows, fc.stride, tid); break;
    }
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

// grid (row tiles, P): block (i, p) runs rows [i*rpb, (i+1)*rpb) of entry p
__global__ void __launch_bounds__(kThreads)
tt_contract_batched_kernel(const float* __restrict__ x, float* __restrict__ y,
                           int batch, int rows_per_block, int64_t x_stride_p,
                           const TTChain chain) {
  const size_t p = blockIdx.y;
  const int row0 = blockIdx.x * rows_per_block;
  chain_rows(x + p * x_stride_p + (size_t)row0 * chain.in_dim,
             y + (p * batch + row0) * chain.out_dim,
             min(rows_per_block, batch - row0), rows_per_block, chain,
             CopyCores{p});
}

// The batched grid on the fiber body, with entry p's cores dequantized from
// codes of type Code (int8_t or __nv_fp8_e4m3, whose conversion to float is
// exact).
template <typename Code>
__global__ void __launch_bounds__(kFiberThreads, 3)
tt_contract_batched_quant_kernel(const float* __restrict__ x,
                                 float* __restrict__ y, int batch,
                                 int64_t x_stride_p,
                                 const __grid_constant__ TTChain chain,
                                 const __grid_constant__ FiberChain fc,
                                 const __grid_constant__ QuantCores q) {
  const size_t p = blockIdx.y;
  const int row0 = blockIdx.x * fc.rows;
  chain_fibers(x + p * x_stride_p + (size_t)row0 * chain.in_dim,
               y + (p * batch + row0) * chain.out_dim,
               min(fc.rows, batch - row0), chain, fc,
               DequantCores<Code>{q, p});
}

// Fill `chain` from the descriptor and return the dynamic shared memory
// the kernel needs (0 for a descriptor it cannot take).
size_t parse_chain(const int64_t* desc, TTChain* chain, int rows_per_block) {
  chain->L = static_cast<int>(desc[0]);
  if (chain->L < 1 || chain->L > kMaxCores || rows_per_block < 1) return 0;
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
  const size_t core_floats = (chain->core_off[chain->L] + 3) & ~3;
  return (core_floats +
          2 * static_cast<size_t>(rows_per_block) * chain->widest) *
         sizeof(float);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
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
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

}  // namespace

// Plain C entry points, bound with ctypes.
//
// desc (host memory, int64): [L, widest, out_modes[L], in_modes[L],
//                             ranks[L+1], core pointers[L]]
// (the quantized entry's desc carries code pointers in place of the core
// pointers, then scale pointers[L]).
// All launch on `stream` without synchronizing and return
// cudaGetLastError() (or cudaErrorInvalidValue for arguments the kernel
// cannot take).
extern "C" int tt_contract_launch(const void* x, void* y, const void* desc_ptr,
                                  int batch, int rows, void* stream) {
  TTChain chain;
  FiberChain fc;
  if (parse_chain(static_cast<const int64_t*>(desc_ptr), &chain, 1) == 0 ||
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
                                          int rows_per_block, void* stream) {
  TTChain chain;
  const size_t smem = parse_chain(static_cast<const int64_t*>(desc_ptr),
                                  &chain, rows_per_block);
  if (smem == 0 || batch < 1 || stack < 1 || stack > 65535 || x_stride_p < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(tt_contract_batched_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((batch + rows_per_block - 1) / rows_per_block, stack);
  tt_contract_batched_kernel<<<grid, kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), batch,
      rows_per_block, x_stride_p, chain);
  return static_cast<int>(cudaGetLastError());
}

// The batched entry with block-quantized cores: code k (P, padded_k) of
// code_type 0 (int8) or 1 (fp8-e4m3, passed as its bytes), scale k
// (P, padded_k / block) f32; x and y as in tt_contract_batched_launch.
extern "C" int tt_contract_batched_quant_launch(
    const void* x, void* y, const void* desc_ptr, int batch, int stack,
    int64_t x_stride_p, int rows, int block, int code_type, void* stream) {
  const int64_t* desc = static_cast<const int64_t*>(desc_ptr);
  TTChain chain;
  FiberChain fc;
  if (parse_chain(desc, &chain, 1) == 0 || batch < 1 || stack < 1 ||
      stack > 65535 || x_stride_p < 0 || block < 1 ||
      (code_type != 0 && code_type != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = parse_fibers(chain, &fc, rows, x, y);
  if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  QuantCores q;
  q.block = block;
  const int64_t* scales = desc + 2 + 3 * chain.L + 1 + chain.L;
  for (int k = 0; k < chain.L; ++k) {
    q.codes[k] = reinterpret_cast<const uint8_t*>(chain.cores[k]);
    q.scales[k] = reinterpret_cast<const float*>(scales[k]);
    chain.cores[k] = nullptr;
  }
  using QuantKernel = void (*)(const float*, float*, int, int64_t, TTChain,
                               FiberChain, QuantCores);
  const QuantKernel kernel =
      code_type == 0 ? &tt_contract_batched_quant_kernel<int8_t>
                     : &tt_contract_batched_quant_kernel<__nv_fp8_e4m3>;
  cudaError_t err = allow_fiber_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((batch + rows - 1) / rows, stack);
  kernel<<<grid, kFiberThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), batch, x_stride_p,
      chain, fc, q);
  return static_cast<int>(cudaGetLastError());
}
