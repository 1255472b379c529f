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
// outputs, below any tensor-core tile, so the step is plain FMA work by
// threads striding over output elements, accumulating in f32.
//
// Layout of one row's intermediate A_k (the invariant of _chain):
//   (m_1..m_k, r_k, n_{k+1}..n_L), row-major.
// Step k, with mp over M_<k and ns over N_>k:
//   out[mp, mk, rn, ns] = sum_{r, nk} a[mp, r, nk, ns] * G_k[r, mk, nk, rn]
//
// Every row's arithmetic is the same whatever tile or kernel it lands in
// (one device function, a fixed summation order per element), so padding a
// batch cannot change the values of the real rows, and entry p of the
// batched kernel equals tt_contract(x[p], cores[p]) bit for bit.
//
// The quantized kernel reads entry p's cores as narrow codes (int8 or
// fp8-e4m3, one byte each, (P, padded_k) per core, padded_k the core's size
// rounded up to the block) and f32 scales ((P, padded_k / block)).  It
// dequantizes them into the shared core buffer before the chain, one f32
// multiply per element (code * scale of its block) with nothing added, so
// the buffer holds exactly kernels/quant.py::fake_quant_stacked's values,
// and entry p equals tt_contract_batched on the fake-quantized cores bit for
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

__global__ void __launch_bounds__(kThreads)
tt_contract_kernel(const float* __restrict__ x, float* __restrict__ y,
                   int batch, int rows_per_block, const TTChain chain) {
  const int row0 = blockIdx.x * rows_per_block;
  chain_rows(x + (size_t)row0 * chain.in_dim,
             y + (size_t)row0 * chain.out_dim,
             min(rows_per_block, batch - row0), rows_per_block, chain,
             CopyCores{0});
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

// tt_contract_batched_kernel with entry p's cores dequantized from codes of
// type Code (int8_t or __nv_fp8_e4m3, whose conversion to float is exact).
template <typename Code>
__global__ void __launch_bounds__(kThreads)
tt_contract_batched_quant_kernel(const float* __restrict__ x,
                                 float* __restrict__ y, int batch,
                                 int rows_per_block, int64_t x_stride_p,
                                 const TTChain chain, const QuantCores q) {
  const size_t p = blockIdx.y;
  const int row0 = blockIdx.x * rows_per_block;
  chain_rows(x + p * x_stride_p + (size_t)row0 * chain.in_dim,
             y + (p * batch + row0) * chain.out_dim,
             min(rows_per_block, batch - row0), rows_per_block, chain,
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
                                  int batch, int rows_per_block,
                                  void* stream) {
  TTChain chain;
  const size_t smem = parse_chain(static_cast<const int64_t*>(desc_ptr),
                                  &chain, rows_per_block);
  if (smem == 0 || batch < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(tt_contract_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (batch + rows_per_block - 1) / rows_per_block;
  tt_contract_kernel<<<blocks, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), batch,
      rows_per_block, chain);
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
    int64_t x_stride_p, int rows_per_block, int block, int code_type,
    void* stream) {
  const int64_t* desc = static_cast<const int64_t*>(desc_ptr);
  TTChain chain;
  const size_t smem = parse_chain(desc, &chain, rows_per_block);
  if (smem == 0 || batch < 1 || stack < 1 || stack > 65535 ||
      x_stride_p < 0 || block < 1 || (code_type != 0 && code_type != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  QuantCores q;
  q.block = block;
  const int64_t* scales = desc + 2 + 3 * chain.L + 1 + chain.L;
  for (int k = 0; k < chain.L; ++k) {
    q.codes[k] = reinterpret_cast<const uint8_t*>(chain.cores[k]);
    q.scales[k] = reinterpret_cast<const float*>(scales[k]);
    chain.cores[k] = nullptr;
  }
  using QuantKernel = void (*)(const float*, float*, int, int, int64_t,
                               TTChain, QuantCores);
  const QuantKernel kernel =
      code_type == 0 ? &tt_contract_batched_quant_kernel<int8_t>
                     : &tt_contract_batched_quant_kernel<__nv_fp8_e4m3>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((batch + rows_per_block - 1) / rows_per_block, stack);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), batch,
      rows_per_block, x_stride_p, chain, q);
  return static_cast<int>(cudaGetLastError());
}
