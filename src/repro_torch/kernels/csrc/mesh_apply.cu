// S stacked MZI meshes of one layout on Hopper (sm_90a), gather form:
//   x <- D x (unless transpose); then per level c, for every wire w
//   y[w] = C[s, c, w] * x[w] + S[s, c, w] * x[perm[c, w]];
//   x <- D x last (transpose).
//
// Replaces the Pallas kernel repro/kernels/mesh_apply.py::
// mesh_apply_stacked_pallas (pallas_call at line 136; body _kernel at line
// 60).  On the TPU the gather x[perm[c, :]] was a matmul against a one-hot
// permutation so that it ran on the MXU; here a thread reads x[perm[c, w]]
// straight from shared memory, which is exact.  The per-wire trig tables
// (S, levels, ports) are computed outside the kernel by
// core.photonic.mesh_gather_tables (level-reversed and sine-negated for
// transpose), and the perm table (levels, ports) comes level-reversed for
// transpose to match.
//
// Grid (row tiles, S).  A block stages its s's cos/sin tables, the perm
// table and the diag row in shared memory, and its rows of x in a pair of
// ping-pong buffers; one thread per (row, wire) computes a level, then the
// block meets at a barrier.  Products and sums are rounded one by one
// (__fmul_rn, __fadd_rn: no FMA contraction), the arithmetic of the plain
// version, cos*x + sin*x[perm], so the two agree to the bit.
//
// What bounds it on an H100: the meshes of the training path are tiny
// (<= 16 ports x 16 levels, S = 11, at most 16 rows): a few KB of traffic
// and ~10^5 FLOPs per launch, so a launch is bound by its latency, far
// above both the bytes bound and the f32 bound.  Shared memory bounds the
// layouts it takes: 12*levels*ports + 4*ports + 8*ports*rows bytes within
// the 227 KB a block may use (a square rectangular mesh of up to ~138
// ports); the wrapper raises for a layout over that.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
mesh_apply_kernel(const float* __restrict__ x, const float* __restrict__ cos_t,
                  const float* __restrict__ sin_t,
                  const int* __restrict__ perm, const float* __restrict__ diag,
                  float* __restrict__ y, int batch, int ports, int levels,
                  int rows_per_block, int64_t x_stride_s,
                  int64_t diag_stride_s, int transpose) {
  extern __shared__ float smem[];
  const int table = levels * ports;
  float* cs = smem;
  float* sn = cs + table;
  int* pm = reinterpret_cast<int*>(sn + table);
  float* dg = reinterpret_cast<float*>(pm + table);
  float* buf_a = dg + ports;
  float* buf_b = buf_a + rows_per_block * ports;

  const size_t s = blockIdx.y;
  const int row0 = blockIdx.x * rows_per_block;
  const int n = min(rows_per_block, batch - row0) * ports;
  const int tid = threadIdx.x;

  const float* cs_g = cos_t + s * table;
  const float* sn_g = sin_t + s * table;
  for (int i = tid; i < table; i += blockDim.x) {
    cs[i] = cs_g[i];
    sn[i] = sn_g[i];
    pm[i] = perm[i];
  }
  const float* dg_g = diag + s * diag_stride_s;
  for (int i = tid; i < ports; i += blockDim.x) dg[i] = dg_g[i];
  __syncthreads();

  const float* xs = x + s * x_stride_s + (size_t)row0 * ports;
  for (int i = tid; i < n; i += blockDim.x) {
    const float v = xs[i];
    buf_a[i] = transpose ? v : __fmul_rn(v, dg[i % ports]);
  }
  __syncthreads();

  float* a = buf_a;
  float* o = buf_b;
  for (int c = 0; c < levels; ++c) {
    const float* cc = cs + c * ports;
    const float* sc = sn + c * ports;
    const int* pc = pm + c * ports;
    for (int i = tid; i < n; i += blockDim.x) {
      const int w = i % ports;
      const float* row = a + (i - w);
      o[i] = __fadd_rn(__fmul_rn(cc[w], row[w]), __fmul_rn(sc[w], row[pc[w]]));
    }
    __syncthreads();
    float* tmp = a;
    a = o;
    o = tmp;
  }

  float* ys = y + (s * batch + row0) * ports;
  for (int i = tid; i < n; i += blockDim.x)
    ys[i] = transpose ? __fmul_rn(a[i], dg[i % ports]) : a[i];
}

}  // namespace

// Plain C entry point, bound with ctypes.
//
// x: (B, P) shared by every stack entry (x_stride_s = 0) or (S, B, P)
// (x_stride_s = B*P); cos_t, sin_t: (S, levels, P); perm: (levels, P)
// int32; diag: (P,) (diag_stride_s = 0) or (S, P); y: (S, B, P).
// Launches on `stream` without synchronizing; returns cudaGetLastError()
// (or cudaErrorInvalidValue for arguments the kernel cannot take).
extern "C" int mesh_apply_launch(const void* x, const void* cos_t,
                                 const void* sin_t, const void* perm,
                                 const void* diag, void* y, int batch,
                                 int ports, int levels, int stack,
                                 int rows_per_block, int64_t x_stride_s,
                                 int64_t diag_stride_s, int transpose,
                                 void* stream) {
  if (batch < 1 || ports < 1 || levels < 1 || stack < 1 || stack > 65535 ||
      rows_per_block < 1 || x_stride_s < 0 || diag_stride_s < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (3 * static_cast<size_t>(levels) * ports + ports +
                       2 * static_cast<size_t>(rows_per_block) * ports) *
                      sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        mesh_apply_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((batch + rows_per_block - 1) / rows_per_block, stack);
  mesh_apply_kernel<<<grid, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), static_cast<const int*>(perm),
      static_cast<const float*>(diag), static_cast<float*>(y), batch, ports,
      levels, rows_per_block, x_stride_s, diag_stride_s, transpose);
  return static_cast<int>(cudaGetLastError());
}
