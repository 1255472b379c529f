// MZI meshes on Hopper (sm_90a), gather form.  Per level c in application
// order, for every wire w:
//   y[w] = C[c, w] * x[w] + S[c, w] * x[perm[c, w]],
// with D = diag applied first (or last, transposed).
//
// Replaces the Pallas kernel repro/kernels/mesh_apply.py::
// mesh_apply_stacked_pallas (pallas_call at line 136; body _kernel at line
// 60).  On the TPU the gather x[perm[c, :]] was a matmul against a one-hot
// permutation so that it ran on the MXU, and the trig tables were built by
// XLA outside the kernel (repro/core/photonic.py::mesh_gather_tables).
// Here a thread reads x[perm[c, w]] straight from shared memory, which is
// exact, and each block computes its own trig from the phases and the
// layout's plan (slot, sign, perm; core.photonic.mesh_plan_tensors):
//   ph = phases[c, slot[c, w]];  C = sign ? cosf(ph) : 1;  S = sign*sinf(ph),
// the arithmetic of core.photonic.mesh_gather_tables.  A transposed mesh
// reads level L-1-c at step c with its sines negated.  sinf / cosf are the
// precise functions (no __sinf, no --use_fast_math): the ones torch.sin /
// torch.cos run on the card, so the tables equal the plain version's.
//
// Three entries:
//   mesh_apply_launch    S stacked meshes of one layout on rows x, shared
//                        or per entry: grid (row tiles, S), the layout's
//                        trig and perm tables resident in shared memory
//                        (the "resident" design).
//                        core.photonic.mesh_apply_stacked.
//   mesh_stream_launch   the same function for layouts whose tables do
//                        not fit a block (the "streamed" design; below).
//   mesh_densify_launch  PhotonicMatrix.to_dense_stacked of G matrices at
//                        once, each written as its TT core: grid (S, G),
//                        one block per (stack entry, matrix).  A block
//                        DAC-snaps the commanded phases, applies the noise
//                        model, builds the trig, runs V transposed on an
//                        identity feed made in the kernel, scales by sigma,
//                        zero-pads to out_dim, runs U, and stores W[o, j].
//                        core.photonic.mesh_densify_stacked.
//
// Every product, sum and quotient is rounded on its own (__fmul_rn,
// __fadd_rn, __fdiv_rn: no FMA contraction) in the plain version's order,
// so the two agree to the bit.
//
// What bounds it on an H100: the meshes of the training path are tiny (4 and
// 16 ports, 4 to 16 levels, S = 11): a ZO step's densification reads and
// writes ~90 KB and does ~10^6 FLOPs, 0.03 us at the card's memory rate.  A
// launch is bound by its latency and the host's launch rate, so the design
// cuts launches: one per call (no table build on the host), and one per ZO
// step for all of a model's core meshes.  Shared memory bounds the layouts:
// the standalone entry holds 12*levels*ports + 4*ports + 8*ports*rows bytes
// (a square rectangular mesh of up to ~138 ports), the grouped one
// 8*in*max(in, out) + 8*levels*(slots + ports) bytes of its larger mesh;
// the wrappers raise past Hopper's 227 KB per block.
//
// The streamed entry also replaces the JAX package's jnp gather scan
// (repro/kernels/ops.py:139-140), to which the Pallas kernel left the wide
// meshes: onn's 1024-port meshes have 1024 levels and 512 slots, whose
// cos, sin and perm tables take 12 MB.  No (levels, ports) table lives in
// shared memory here: a block holds only its rows, one buffer of
// rows * ports floats, and walks the levels in order, reading each
// level's phases and plan (the owner list of core.photonic.mesh_owner_plan,
// perm, slot, sign) from device memory, where a whole stack's phases
// (11 x 1024 x 512 f32, 23 MB) and plan tables (4 MB each) stay in the
// 50 MB L2.  A level is a set of disjoint pairs, so the thread that owns
// MZI (a, perm[a]) updates both wires in place and one buffer suffices;
// an unpaired wire owns itself (y = 1*x + (+-0)*x, kept for the plain
// version's bits).  The trig of level c + 1 (one sinf and one cosf per
// owner: 513 at 1024 ports) goes into a double-buffered list while the
// rows take level c, so a level costs one barrier and its trig is paid
// once per block, shared by the block's rows.
//
// What bounds the streamed entry: per element and level two shared loads,
// four products and two sums (3 FLOPs a wire, unfused); at the hidden
// layer of an onn ZO step (11 x 4300 rows, 1024 levels) 1.49e11 FLOPs,
// 2.2 ms at the f32 peak, while its bytes (x and y, 387 MB) take 0.12 ms.
// It is bound by shared-memory traffic and instruction issue, not by
// device memory.  Rows per block (up to ~49 at 1024 ports) amortize each
// level's plan reads and trig; the wrapper spreads a small batch over more
// blocks so every SM gets one (kernels/mesh_apply.py::stream_rows).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

constexpr int kMaxGroup = 20;   // matrices per grouped launch (4 KB of params)

// Descriptors of the grouped entry.  Its C launcher takes them, so they
// live outside the anonymous namespace; kernels/mesh_apply.py mirrors them
// field for field in ctypes (_MeshSide, _MatrixDesc, MeshGroup).

// One mesh of a PhotonicMatrix.
struct MeshSide {
  const float* phases;    // (S, levels, slots), commanded
  const float* gamma;     // (levels, slots), or null: no noise model
  const float* bias;      // (levels, slots)
  const float* diag;      // (ports,) or (S, ports)
  const int* slot;        // (levels, ports) int32
  const float* sign;      // (levels, ports)
  const int* perm;        // (levels, ports) int32, stored level order
  int64_t diag_stride_s;  // 0 or ports
  int ports, levels, slots;
  int crosstalk;          // mix adjacent slots (noise on, kappa > 0, slots > 1)
};

// One PhotonicMatrix (out_dim = u.ports, in_dim = v.ports) and its core.
struct MatrixDesc {
  MeshSide u, v;
  const float* sigma;     // (S, k)
  float* out;             // (S, out_dim, in_dim), the TT core's memory
  int k;
  int pad;
};

struct MeshGroup {
  MatrixDesc m[kMaxGroup];
  int count, stack;
  float dac_step;         // f32(2 pi / 2^bits)
  int dac;                // snap the commanded phases to the DAC grid
  float kappa;            // f32(crosstalk)
  int pad;
};
static_assert(sizeof(MeshGroup) <= 4096, "a kernel takes 4 KB of parameters");

namespace {

constexpr int kThreads = 256;

// Per-wire trig tables of one mesh in stored level order, from its
// effective phases ph (levels, slots); n = levels * ports.
__device__ void build_trig(const float* ph, const int* __restrict__ slot,
                           const float* __restrict__ sign, int n, int ports,
                           int slots, float* cs, float* sn) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float sg = sign[i];
    const float v = ph[(i / ports) * slots + slot[i]];
    cs[i] = sg != 0.0f ? cosf(v) : 1.0f;
    sn[i] = __fmul_rn(sg, sinf(v));
  }
}

// The levels of one mesh on the n = rows * ports elements of buffer a
// (o is the other buffer of the pair); the caller has synchronized a.
// Returns the buffer that holds the result.
__device__ float* run_levels(float* a, float* o, int n, int ports, int levels,
                             const float* cs, const float* sn,
                             const int* perm, bool transpose) {
  for (int c = 0; c < levels; ++c) {
    const int cl = transpose ? levels - 1 - c : c;
    const float* cc = cs + cl * ports;
    const float* sc = sn + cl * ports;
    const int* pc = perm + cl * ports;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int w = i % ports;
      const float* row = a + (i - w);
      const float s = transpose ? -sc[w] : sc[w];
      o[i] = __fadd_rn(__fmul_rn(cc[w], row[w]), __fmul_rn(s, row[pc[w]]));
    }
    __syncthreads();
    float* tmp = a;
    a = o;
    o = tmp;
  }
  return a;
}

// ------------------------------------------------------------ standalone

__global__ void __launch_bounds__(kThreads)
mesh_apply_kernel(const float* __restrict__ x,
                  const float* __restrict__ phases,
                  const int* __restrict__ slot,
                  const float* __restrict__ sign,
                  const int* __restrict__ perm, const float* __restrict__ diag,
                  float* __restrict__ y, int batch, int ports, int levels,
                  int slots, int rows_per_block, int64_t x_stride_s,
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

  build_trig(phases + s * levels * slots, slot, sign, table, ports, slots,
             cs, sn);
  for (int i = tid; i < table; i += blockDim.x) pm[i] = perm[i];
  const float* dg_g = diag + s * diag_stride_s;
  for (int i = tid; i < ports; i += blockDim.x) dg[i] = dg_g[i];
  __syncthreads();

  const float* xs = x + s * x_stride_s + (size_t)row0 * ports;
  for (int i = tid; i < n; i += blockDim.x) {
    const float v = xs[i];
    buf_a[i] = transpose ? v : __fmul_rn(v, dg[i % ports]);
  }
  __syncthreads();

  const float* a = run_levels(buf_a, buf_b, n, ports, levels, cs, sn, pm,
                              transpose);
  float* ys = y + (s * batch + row0) * ports;
  for (int i = tid; i < n; i += blockDim.x)
    ys[i] = transpose ? __fmul_rn(a[i], dg[i % ports]) : a[i];
}


// ---------------------------------------------------------------- grouped

// Effective phases of one mesh of entry s into ph (and scratch tmp, both
// levels * slots), then its trig tables into cs, sn.  The order of
// PhotonicMatrix._dac_phases and NoiseModel.effective_phases:
//   q = rint(phi / step) * step;  p = gamma * q;
//   p = p + kappa * (p[k+1] + p[k-1])   (0 past either end of a level);
//   p = p + bias.
__device__ void stage_mesh(const MeshSide& m, int s, const MeshGroup& grp,
                           float* ph, float* tmp, float* cs, float* sn) {
  const int n = m.levels * m.slots;
  const float* src = m.phases + static_cast<size_t>(s) * n;
  const bool noise = m.gamma != nullptr;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    float v = src[i];
    if (grp.dac)
      v = __fmul_rn(rintf(__fdiv_rn(v, grp.dac_step)), grp.dac_step);
    ph[i] = noise ? __fmul_rn(m.gamma[i], v) : v;
  }
  __syncthreads();
  if (noise) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      float p = ph[i];
      if (m.crosstalk) {
        const int k = i % m.slots;
        const float left = k + 1 < m.slots ? ph[i + 1] : 0.0f;
        const float right = k > 0 ? ph[i - 1] : 0.0f;
        p = __fadd_rn(p, __fmul_rn(grp.kappa, __fadd_rn(left, right)));
      }
      tmp[i] = __fadd_rn(p, m.bias[i]);
    }
    __syncthreads();
    ph = tmp;
  }
  build_trig(ph, m.slot, m.sign, m.levels * m.ports, m.ports, m.slots, cs,
             sn);
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
mesh_densify_kernel(const __grid_constant__ MeshGroup grp) {
  extern __shared__ float smem[];
  const MatrixDesc& d = grp.m[blockIdx.y];
  const int s = blockIdx.x;
  const int in = d.v.ports, out = d.u.ports;
  const int width = max(in, out);
  float* buf_a = smem;
  float* buf_b = buf_a + in * width;
  float* ph = buf_b + in * width;
  const int phase_n = max(d.u.levels * d.u.slots, d.v.levels * d.v.slots);
  float* tmp = ph + phase_n;
  float* cs = tmp + phase_n;
  float* sn = cs + max(d.u.levels * d.u.ports, d.v.levels * d.v.ports);
  const int tid = threadIdx.x;

  // V, transposed, on the identity: rows j = e_j, D_v last
  stage_mesh(d.v, s, grp, ph, tmp, cs, sn);
  for (int i = tid; i < in * in; i += blockDim.x)
    buf_a[i] = i / in == i % in ? 1.0f : 0.0f;
  __syncthreads();
  const float* a = run_levels(buf_a, buf_b, in * in, in, d.v.levels, cs, sn,
                              d.v.perm, true);
  float* z = a == buf_a ? buf_b : buf_a;
  // D_v, sigma on the first k wires, zeros up to out_dim, then D_u: rows of
  // out_dim in the other buffer
  const float* dv = d.v.diag + s * d.v.diag_stride_s;
  const float* du = d.u.diag + s * d.u.diag_stride_s;
  const float* sig = d.sigma + static_cast<size_t>(s) * d.k;
  for (int i = tid; i < in * out; i += blockDim.x) {
    const int j = i / out, w = i % out;
    const float zv = w < d.k
        ? __fmul_rn(__fmul_rn(a[j * in + w], dv[w]), sig[w]) : 0.0f;
    z[i] = __fmul_rn(zv, du[w]);
  }
  // U on the rows of z, D_u already applied; the tables are rewritten only
  // after every thread has passed this barrier
  __syncthreads();
  stage_mesh(d.u, s, grp, ph, tmp, cs, sn);
  const float* r = run_levels(z, z == buf_a ? buf_b : buf_a, in * out, out,
                              d.u.levels, cs, sn, d.u.perm, false);
  // W[o, j] = r[j, o], the core's flat layout
  float* dst = d.out + static_cast<size_t>(s) * out * in;
  for (int i = tid; i < out * in; i += blockDim.x)
    dst[i] = r[(i % in) * out + i / in];
}

// ---------------------------------------------------------------- streamed

constexpr int kStreamThreads = 1024;

// One owner of a level: y[a] = ca*x[a] + sa*x[b] and, when b != a,
// y[b] = cb*x[b] + sb*x[a] (a < 0: a padded entry of the owner list).
struct __align__(8) Rot {
  int a, b;
  float ca, sa, cb, sb;
};

// Stored level cl's owners and their trig, in the arithmetic of build_trig
// (both lanes of an MZI share its slot, core.photonic.mesh_gather_plan; a
// transposed mesh negates the sines).
__device__ void stage_level(int cl, const float* __restrict__ ph,
                            const int* __restrict__ slot,
                            const float* __restrict__ sign,
                            const int* __restrict__ perm,
                            const int* __restrict__ owner, int ports,
                            int slots, int items, bool transpose, Rot* out) {
  const size_t base = static_cast<size_t>(cl) * ports;
  for (int j = threadIdx.x; j < items; j += blockDim.x) {
    Rot r;
    r.a = owner[static_cast<size_t>(cl) * items + j];
    r.b = r.a;
    r.ca = r.cb = 1.0f;
    r.sa = r.sb = 0.0f;
    if (r.a >= 0) {
      r.b = perm[base + r.a];
      const float v = ph[static_cast<size_t>(cl) * slots + slot[base + r.a]];
      const float sga = sign[base + r.a], sgb = sign[base + r.b];
      r.ca = sga != 0.0f ? cosf(v) : 1.0f;
      r.cb = sgb != 0.0f ? cosf(v) : 1.0f;
      const float sv = sinf(v);
      r.sa = __fmul_rn(sga, sv);
      r.sb = __fmul_rn(sgb, sv);
      if (transpose) {
        r.sa = -r.sa;
        r.sb = -r.sb;
      }
    }
    out[j] = r;
  }
}

__global__ void __launch_bounds__(kStreamThreads)
mesh_stream_kernel(const float* __restrict__ x,
                   const float* __restrict__ phases,
                   const int* __restrict__ slot,
                   const float* __restrict__ sign,
                   const int* __restrict__ perm,
                   const int* __restrict__ owner,
                   const float* __restrict__ diag, float* __restrict__ y,
                   int batch, int ports, int levels, int slots, int items,
                   int rows_per_block, int64_t x_stride_s,
                   int64_t diag_stride_s, int transpose) {
  extern __shared__ float smem[];
  Rot* rot = reinterpret_cast<Rot*>(smem);         // 2 x items, 8-aligned
  float* buf = reinterpret_cast<float*>(rot + 2 * items);
  float* dg = buf + static_cast<size_t>(rows_per_block) * ports;

  const size_t s = blockIdx.y;
  const int row0 = blockIdx.x * rows_per_block;
  const int rows = min(rows_per_block, batch - row0);
  const int n = rows * ports;
  const int tid = threadIdx.x;
  const bool tr = transpose != 0;
  const float* ph = phases + s * levels * slots;

  stage_level(tr ? levels - 1 : 0, ph, slot, sign, perm, owner, ports, slots,
              items, tr, rot);
  const float* dg_g = diag + s * diag_stride_s;
  for (int i = tid; i < ports; i += blockDim.x) dg[i] = dg_g[i];
  __syncthreads();
  const float* xs = x + s * x_stride_s + static_cast<size_t>(row0) * ports;
  for (int i = tid; i < n; i += blockDim.x) {
    const float v = xs[i];
    buf[i] = tr ? v : __fmul_rn(v, dg[i % ports]);
  }
  __syncthreads();

  // work item i = r * items + j (row r, owner j), i = tid + k * blockDim
  const int work = rows * items;
  const int step_r = blockDim.x / items, step_j = blockDim.x % items;
  for (int c = 0; c < levels; ++c) {
    const Rot* cur = rot + (c & 1) * items;
    if (c + 1 < levels)
      stage_level(tr ? levels - 2 - c : c + 1, ph, slot, sign, perm, owner,
                  ports, slots, items, tr, rot + ((c + 1) & 1) * items);
    int r = tid / items, j = tid % items;
    for (int i = tid; i < work; i += blockDim.x) {
      const Rot q = cur[j];
      if (q.a >= 0) {
        float* row = buf + r * ports;
        const float xa = row[q.a];
        const float xb = row[q.b];
        row[q.a] = __fadd_rn(__fmul_rn(q.ca, xa), __fmul_rn(q.sa, xb));
        if (q.b != q.a)
          row[q.b] = __fadd_rn(__fmul_rn(q.cb, xb), __fmul_rn(q.sb, xa));
      }
      r += step_r;
      j += step_j;
      if (j >= items) {
        j -= items;
        ++r;
      }
    }
    __syncthreads();
  }

  float* ys = y + (s * batch + row0) * ports;
  for (int i = tid; i < n; i += blockDim.x)
    ys[i] = tr ? __fmul_rn(buf[i], dg[i % ports]) : buf[i];
}

size_t stream_smem(int ports, int items, int rows_per_block) {
  return 2 * static_cast<size_t>(items) * sizeof(Rot) +
         (static_cast<size_t>(rows_per_block) + 1) * ports * sizeof(float);
}

size_t densify_smem(const MatrixDesc& d) {
  const size_t in = d.v.ports, out = d.u.ports;
  const size_t phase_n = std::max(d.u.levels * d.u.slots,
                                  d.v.levels * d.v.slots);
  const size_t table = std::max(d.u.levels * d.u.ports,
                                d.v.levels * d.v.ports);
  return (2 * in * std::max(in, out) + 2 * phase_n + 2 * table) *
         sizeof(float);
}

}  // namespace

// Plain C entry points, bound with ctypes.  Each launches on `stream`
// without synchronizing and returns cudaGetLastError() (or
// cudaErrorInvalidValue for arguments the kernel cannot take).

// x: (B, P) shared by every stack entry (x_stride_s = 0) or (S, B, P)
// (x_stride_s = B*P); phases: (S, levels, slots); slot, perm: (levels, P)
// int32; sign: (levels, P); diag: (P,) (diag_stride_s = 0) or (S, P);
// y: (S, B, P).
extern "C" int mesh_apply_launch(const void* x, const void* phases,
                                 const void* slot, const void* sign,
                                 const void* perm, const void* diag, void* y,
                                 int batch, int ports, int levels, int slots,
                                 int stack, int rows_per_block,
                                 int64_t x_stride_s, int64_t diag_stride_s,
                                 int transpose, void* stream) {
  if (batch < 1 || ports < 1 || levels < 1 || slots < 1 || stack < 1 ||
      stack > 65535 || rows_per_block < 1 || x_stride_s < 0 ||
      diag_stride_s < 0)
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
      static_cast<const float*>(x), static_cast<const float*>(phases),
      static_cast<const int*>(slot), static_cast<const float*>(sign),
      static_cast<const int*>(perm), static_cast<const float*>(diag),
      static_cast<float*>(y), batch, ports, levels, slots, rows_per_block,
      x_stride_s, diag_stride_s, transpose);
  return static_cast<int>(cudaGetLastError());
}

// The streamed design: the arguments of mesh_apply_launch plus owner
// (levels, items) int32 (core.photonic.mesh_owner_plan).  Shared memory:
// 48 * items + 4 * (rows_per_block + 1) * ports bytes.
extern "C" int mesh_stream_launch(const void* x, const void* phases,
                                  const void* slot, const void* sign,
                                  const void* perm, const void* owner,
                                  const void* diag, void* y, int batch,
                                  int ports, int levels, int slots, int items,
                                  int stack, int rows_per_block,
                                  int64_t x_stride_s, int64_t diag_stride_s,
                                  int transpose, void* stream) {
  if (batch < 1 || ports < 1 || levels < 1 || slots < 1 || items < 1 ||
      stack < 1 || stack > 65535 || rows_per_block < 1 || x_stride_s < 0 ||
      diag_stride_s < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = stream_smem(ports, items, rows_per_block);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        mesh_stream_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((batch + rows_per_block - 1) / rows_per_block, stack);
  mesh_stream_kernel<<<grid, kStreamThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(phases),
      static_cast<const int*>(slot), static_cast<const float*>(sign),
      static_cast<const int*>(perm), static_cast<const int*>(owner),
      static_cast<const float*>(diag), static_cast<float*>(y), batch, ports,
      levels, slots, items, rows_per_block, x_stride_s, diag_stride_s,
      transpose);
  return static_cast<int>(cudaGetLastError());
}

// Size of MeshGroup, so the wrapper can check its ctypes mirror.
extern "C" int mesh_densify_group_bytes() {
  return static_cast<int>(sizeof(MeshGroup));
}

// group: the G descriptors, read on the host and passed to the kernel by
// value as its parameter (no copy to the device).
extern "C" int mesh_densify_launch(const MeshGroup* group, void* stream) {
  if (group->count < 1 || group->count > kMaxGroup || group->stack < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  size_t smem = 0;
  for (int g = 0; g < group->count; ++g) {
    const MatrixDesc& d = group->m[g];
    if (d.u.ports < 1 || d.v.ports < 1 || d.u.levels < 1 ||
        d.v.levels < 1 || d.u.slots < 1 || d.v.slots < 1 || d.k < 1)
      return static_cast<int>(cudaErrorInvalidValue);
    smem = std::max(smem, densify_smem(d));
  }
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        mesh_densify_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(group->stack, group->count);
  mesh_densify_kernel<<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(*group);
  return static_cast<int>(cudaGetLastError());
}
