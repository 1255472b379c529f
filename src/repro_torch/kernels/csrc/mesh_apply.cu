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
// Entries:
//   mesh_apply_launch    S stacked meshes of one layout on rows x, shared
//                        or per entry: grid (row tiles, S), the layout's
//                        trig and perm tables resident in shared memory
//                        (the "resident" design).
//                        core.photonic.mesh_apply_stacked.
//   mesh_rows_launch,    the same function for layouts whose tables do
//   mesh_product_launch, not fit a block (the wide routes; below).
//   mesh_stream_launch
//   mesh_densify_launch  PhotonicMatrix.to_dense_stacked of G matrices at
//                        once, each written as its TT core: grid (S, G),
//                        one block per (stack entry, matrix).  A block
//                        DAC-snaps the commanded phases, applies the noise
//                        model, builds the trig, runs V transposed on an
//                        identity feed made in the kernel, scales by sigma,
//                        zero-pads to out_dim, runs U, and stores W[o, j].
//                        core.photonic.mesh_densify_stacked.
//   mesh_densify_grad_warp_launch, mesh_densify_grad_launch  its backward,
//                        the BP baselines' (port-only: the TPU kernel has
//                        none; JAX differentiates its jnp scan): the same
//                        grid, one block re-runs its forward keeping the
//                        states and walks both meshes back to dphases_u,
//                        dphases_v and dsigma.  Two designs: "warp" (rows
//                        in a warp's lanes, levels by shuffles, no block
//                        barrier a level) for meshes of at most 32 ports,
//                        "block" (an element a thread, a barrier a level)
//                        for the rest.
//   mesh_apply_grad_warp_launch, mesh_apply_grad_launch  the backward of
//                        mesh_apply_launch (port-only too): dx and dphases
//                        from the saved output, grid (block columns, S),
//                        the tables resident.  Two designs: "warp" (a mesh
//                        row in a warp's lanes, the states recovered by
//                        shuffles, no block barrier a level) for meshes of
//                        at most 32 ports and brick layouts of at most 64,
//                        "block" (an element a thread, a barrier a level)
//                        for the rest.  Both backwards are below
//                        ("backwards").
//   mesh_rows_grad_launch  the backward of the wide routes (port-only
//                        too), in route A's warp-row layout: dx and
//                        dphases from the saved output ("warp rows
//                        backward", below): the backward of route A's
//                        forwards.
//   mesh_product_grad_launch  with mesh_rows_grad_launch, the "dense"
//                        backward of route B's forwards (port-only too),
//                        from the forward's x and its dense scratch M
//                        (y = x*M): dx = dy*M^T and dM = x^T*dy on the
//                        tensor cores ("dense", below), then dphases by
//                        the warp-rows backward on M's P identity rows
//                        (y := M, dy := dM) instead of the batch's rows.
//                        The owner walk's layouts have no backward
//                        (ROADMAP item 6c-3).
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
// The wide meshes (onn's 1024-port layouts, whose cos, sin and perm tables
// take 12 MB) also replace the JAX package's jnp gather scan
// (repro/kernels/ops.py:139-140), to which the Pallas kernel left them.
// kernels/mesh_apply.py::wide_route picks one of three routes from the
// layout, the stack size and the rows per entry:
//
//   warp rows (route A; mesh_rows_launch) — every layout whose levels each
//     pair adjacent wires (a, a+1) of one parity a % 2 ("brick" levels:
//     the rectangular and the Reck layouts the repo builds).  A warp holds
//     R whole rows in registers, lane t wires [t*W, (t+1)*W) (W = 8, 16 or
//     32, the narrowest with 32*W >= ports).  A level's pairs inside a lane
//     are register arithmetic in the gather form, y[w] = C*x[w] +
//     S*x[partner]; the pairs that cross lanes (odd parity only) take one
//     __shfl_sync each way; nothing is written back and no barrier orders
//     the levels.  The trig is stored per MZI, not per wire: one brick
//     entry (cos, s_lo) per pair a lane touches (W/2 + 1 a level), s_lo
//     the lower wire's signed sine (the upper wire's is -s_lo, exactly),
//     and a bit per entry for a pair the level leaves out (its wires keep
//     the plain version's unpaired y = 1*x + (+-0)*x).  The layout's
//     static half (each entry's slot and sign, the absent bits, each
//     level's parity) is a plan built once on the host
//     (kernels/mesh_apply.py::rows_plan); a prologue launch
//     (mesh_trig_kernel) turns it and the call's phases into every
//     entry's record once a call.  A block streams the records K levels a
//     chunk through a ring of 4 chunks in shared memory, one TMA bulk copy
//     a chunk issued by one thread, one barrier a chunk, and the R rows of
//     a warp share each entry.  (Building the trig inside each block
//     instead measured 4-12x slower; per-thread cp.async copies cost 40% of
//     a small batch's time.)  Bound: 3 unfused f32 operations per wire and
//     level at the issue rate (an unfused product or sum takes an issue
//     slot, as an FMA does): 4.44 ms at the hidden layer of an onn ZO
//     step.
//   dense (route B; mesh_rows_launch on an identity feed, then
//     mesh_product_launch) — from 1.5x the ports rows per entry
//     (kernels/mesh_apply.py::DENSE_MIN_ROWS_PER_PORT):
//     route A densifies each entry's mesh (row i of M_s = mesh(e_i), diag
//     and transpose as the call has them) into an (S, P, P) scratch, and a
//     tensor-core kernel forms y_s = x_s * M_s in 3xTF32 (a = hi + lo, each
//     a TF32 value; hi*hi + hi*lo + lo*hi summed in f32 by mma.sync
//     m16n8k8), fed by cp.async, double-buffered.  Not bit-equal to the
//     plain version: within PERF.md's f32 bound.  Bound: the
//     densification's operations at the issue rate plus three TF32
//     products at 495 TFLOP/s, against x, y and the scratch moved once.
//   owner walk (mesh_stream_launch) — any other layout one row of which
//     fits a block.  A block holds only its rows, one buffer of
//     rows * ports floats, and walks the levels in order, reading each
//     level's phases and plan (the owner list of
//     core.photonic.mesh_owner_plan, perm, slot, sign) from device memory.
//     A level is a set of disjoint pairs, so the thread that owns MZI
//     (a, perm[a]) updates both wires in place and one buffer suffices; an
//     unpaired wire owns itself.  The trig of level c + 1 goes into a
//     double-buffered list while the rows take level c: one barrier a
//     level.  Bound by shared-memory traffic (a 24-byte owner entry, two
//     loads and two stores per element and level).
//
// Routes A and the owner walk round as the plain version does, so they
// agree with it, and with the resident design, bit for bit.

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
  float* out;             // (S, out_dim, in_dim), the TT core's memory; the
                          // backward reads the core's gradient dW there
  int k;
  int save_states;        // backward: keep each level's input (else recover)
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

// Where each matrix's gradients start in the grouped backward's output, in
// floats (the host's layout; the warp design reads it, the block design
// sums the sizes of the matrices before its own).
struct GroupOffsets {
  int64_t grads[kMaxGroup];
};
static_assert(sizeof(MeshGroup) + sizeof(GroupOffsets) + sizeof(void*) <=
                  4096, "a kernel takes 4 KB of parameters");

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFullMask = 0xffffffffu;

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
// With states, level c's input goes to states[c * n ...] (application
// order) on the way: the backward's saved states.  Returns the buffer that
// holds the result.
__device__ float* run_levels(float* a, float* o, int n, int ports, int levels,
                             const float* cs, const float* sn,
                             const int* perm, bool transpose,
                             float* states = nullptr) {
  for (int c = 0; c < levels; ++c) {
    const int cl = transpose ? levels - 1 - c : c;
    const float* cc = cs + cl * ports;
    const float* sc = sn + cl * ports;
    const int* pc = perm + cl * ports;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int w = i % ports;
      const float* row = a + (i - w);
      const float s = transpose ? -sc[w] : sc[w];
      if (states) states[static_cast<size_t>(c) * n + i] = a[i];
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

// ------------------------------------------------------------- backwards
//
// Both backwards walk one mesh's levels in reverse over rows held in shared
// memory (reverse_levels, below), each level orthogonal and in the gather
// form y[w] = C[w]*x[w] + S[w]*x[perm w]:
//   its input x   x[w] = C[w]*y[w] - S[w]*y[perm w]   (the inverse rotation),
//                 or read back from the states the forward kept;
//   dphi_slot  += sum over the rows and the slot's two wires of
//                 g[w] * (-sin phi * x[w] + t * sign[w] * cos phi * x[perm w])
//                 (g the gradient at the level's output; t = -1 for a
//                 transposed mesh, whose sines are negated, else 1);
//   g         <- M^T g:  g[w] = C[w]*g[w] - S[w]*g[perm w].
// The slot's sum runs over the rows in order, one thread per slot (the
// thread of the slot's first wire, sign -1), and each block writes its own
// sums: no atomics, so the result is the same bits on every run.
//
// Where a level's input comes from:
//   mesh_densify_grad_kernel (the grouped backward's block design) keeps
//     the states: it
//     re-runs the forward of its (stack entry, matrix) on the identity feed
//     and writes each level's input to shared memory on the way
//     (save_states; at the paper's cores V's 16 rows x 16 ports x 16
//     levels and U's 16 x 4 x 4, 17 KB), so its states are the forward's
//     bits.  A matrix whose states do not fit
//     (kernels/mesh_apply.py::densify_grad_saves) recovers them instead.
//   mesh_densify_grad_warp_kernel (its warp design, below the block one)
//     keeps each thread's input at every level in the thread's own column
//     of shared memory: the forward's bits too.
//   mesh_apply_grad_kernel (the resident backward's block design) and
//     mesh_apply_grad_warp_kernel (its warp design, below) recover them
//     from the saved output y: a row tile's states (rows x ports x levels)
//     outgrow shared memory at a few dozen ports.  Each recovered level adds a few
//     ulps; at 137 levels (a 137-port rectangular mesh, the widest the
//     resident design holds; random phases, 64 rows) the worst state sat
//     1.2e-6 of max|x| from the forward's, measured on the CPU with the
//     plain version (kernels/ref.py::mesh_reverse).
//
// Bound: like the forwards, a launch latency at the BP path's shapes (a
// few hundred KB moved); the grouped backward is one launch for every
// core matrix, the resident one a launch and, when it takes more than one
// block column (and, in the warp design, more than the launch folds
// itself), a second small kernel that sums the blocks' phase gradients in
// a fixed order (mesh_grad_sum_kernel).  At onn's 64-port meshes on 4300
// rows the warp design is bound by its issue rate: per row and level ~30
// unfused operations and shuffles (3 + 3 for the state and the gradient
// of each of a lane's two wires, 14 for its slot's term), against the
// bound's 6 per element and 11 per MZI (PERF.md row 9).

// Reverse walk of one mesh over `rows` rows of `ports` floats.  y / ty:
// the levels' output and a scratch buffer (recovering mode; unused with
// states); g / tg: the gradient at the output and a scratch buffer.  On
// return g holds the gradient at the levels' input (and y the input).
// states: each level's input in application order, or null; dph: this
// block's phase gradients (levels, slots), which the walk adds to (the
// caller zeroes them first: a padded slot has no wire), or null; slot,
// sign: the layout's plan (levels, ports).
__device__ void reverse_levels(float*& y, float*& ty, float*& g, float*& tg,
                               int rows, int ports, int levels, int slots,
                               const float* cs, const float* sn,
                               const int* perm, const int* __restrict__ slot,
                               const float* __restrict__ sign, bool transpose,
                               const float* states, float* dph) {
  const int n = rows * ports;
  for (int c = levels - 1; c >= 0; --c) {
    const int cl = transpose ? levels - 1 - c : c;
    const float* cc = cs + cl * ports;
    const float* sc = sn + cl * ports;
    const int* pc = perm + cl * ports;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int w = i % ports;
      const int p = i - w + pc[w];
      const float s = transpose ? -sc[w] : sc[w];
      if (!states)
        ty[i] = __fsub_rn(__fmul_rn(cc[w], y[i]), __fmul_rn(s, y[p]));
      tg[i] = __fsub_rn(__fmul_rn(cc[w], g[i]), __fmul_rn(s, g[p]));
    }
    __syncthreads();
    if (dph) {
      const float* x = states ? states + static_cast<size_t>(c) * n : ty;
      for (int a = threadIdx.x; a < ports; a += blockDim.x) {
        if (!(sign[cl * ports + a] < 0.0f)) continue;   // a slot's first wire
        const int b = pc[a];
        // sn = sign * sin(phi) = -sin(phi) on wire a; cs = cos(phi)
        const float ms = sc[a];
        const float cb = transpose ? cc[a] : -cc[a];
        float acc = 0.0f;
        for (int r = 0; r < rows; ++r) {
          const float* xr = x + r * ports;
          const float* gr = g + r * ports;
          const float dya = __fadd_rn(__fmul_rn(ms, xr[a]),
                                      __fmul_rn(cb, xr[b]));
          const float dyb = __fsub_rn(__fmul_rn(ms, xr[b]),
                                      __fmul_rn(cb, xr[a]));
          acc = __fadd_rn(acc, __fadd_rn(__fmul_rn(gr[a], dya),
                                         __fmul_rn(gr[b], dyb)));
        }
        float* dst = dph + cl * slots + slot[cl * ports + a];
        *dst = __fadd_rn(*dst, acc);
      }
      __syncthreads();
    }
    if (!states) {
      float* t = y;
      y = ty;
      ty = t;
    }
    float* t = g;
    g = tg;
    tg = t;
  }
}

// The commanded phases' gradient of one mesh from its effective phases'
// (dph, levels * slots) into dst: the transpose of stage_mesh's noise
// model, Omega symmetric:  dst = gamma * (d + kappa * (d[k-1] + d[k+1])).
__device__ void noise_transpose(const MeshSide& m, const MeshGroup& grp,
                                const float* dph, float* dst) {
  const int n = m.levels * m.slots;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    float v = dph[i];
    if (m.gamma != nullptr) {
      if (m.crosstalk) {
        const int k = i % m.slots;
        const float left = k + 1 < m.slots ? dph[i + 1] : 0.0f;
        const float right = k > 0 ? dph[i - 1] : 0.0f;
        v = __fadd_rn(v, __fmul_rn(grp.kappa, __fadd_rn(left, right)));
      }
      v = __fmul_rn(m.gamma[i], v);
    }
    dst[i] = v;
  }
}

// The grouped backward: grid (S, G), one block per (stack entry, matrix),
// as the forward.  d.out holds the core's gradient dW (S, out, in); grads
// the flat output, per matrix in group order [dphases_u (S, Lu, Ku),
// dphases_v (S, Lv, Kv), dsigma (S, k)].
__global__ void __launch_bounds__(kThreads)
mesh_densify_grad_kernel(const __grid_constant__ MeshGroup grp,
                         float* __restrict__ grads) {
  extern __shared__ float smem[];
  const MatrixDesc& d = grp.m[blockIdx.y];
  const int s = blockIdx.x, S = grp.stack;
  const int in = d.v.ports, out = d.u.ports, k = d.k;
  const int width = max(in, out);
  const int nu = d.u.levels * d.u.slots, nv = d.v.levels * d.v.slots;
  const int phase_n = max(nu, nv);
  const bool save = d.save_states != 0;
  float* buf_a = smem;
  float* buf_b = buf_a + in * width;
  float* g_a = buf_b + in * width;
  float* g_b = g_a + in * width;
  float* vout = g_b + in * width;                  // V's output rows
  float* ph = vout + in * in;
  float* tmp = ph + phase_n;
  float* dph = tmp + phase_n;
  float* cs = dph + phase_n;
  float* sn = cs + max(d.u.levels * d.u.ports, d.v.levels * d.v.ports);
  float* sv = sn + max(d.u.levels * d.u.ports, d.v.levels * d.v.ports);
  float* su = sv + (save ? d.v.levels * in * in : 0);
  const int tid = threadIdx.x;

  size_t off = 0;                                  // this matrix's grads
  for (int g = 0; g < static_cast<int>(blockIdx.y); ++g)
    off += static_cast<size_t>(S) *
           (grp.m[g].u.levels * grp.m[g].u.slots +
            grp.m[g].v.levels * grp.m[g].v.slots + grp.m[g].k);
  float* dphu = grads + off + static_cast<size_t>(s) * nu;
  float* dphv = grads + off + static_cast<size_t>(S) * nu +
                static_cast<size_t>(s) * nv;
  float* dsig = grads + off + static_cast<size_t>(S) * (nu + nv) +
                static_cast<size_t>(s) * k;

  // the forward of mesh_densify_kernel, keeping V's output (and the states)
  stage_mesh(d.v, s, grp, ph, tmp, cs, sn);
  for (int i = tid; i < in * in; i += blockDim.x)
    buf_a[i] = i / in == i % in ? 1.0f : 0.0f;
  __syncthreads();
  const float* a = run_levels(buf_a, buf_b, in * in, in, d.v.levels, cs, sn,
                              d.v.perm, true, save ? sv : nullptr);
  float* z = a == buf_a ? buf_b : buf_a;
  const float* dv = d.v.diag + s * d.v.diag_stride_s;
  const float* du = d.u.diag + s * d.u.diag_stride_s;
  const float* sig = d.sigma + static_cast<size_t>(s) * k;
  for (int i = tid; i < in * in; i += blockDim.x) vout[i] = a[i];
  for (int i = tid; i < in * out; i += blockDim.x) {
    const int j = i / out, w = i % out;
    const float zv = w < k
        ? __fmul_rn(__fmul_rn(a[j * in + w], dv[w]), sig[w]) : 0.0f;
    z[i] = __fmul_rn(zv, du[w]);
  }
  __syncthreads();
  stage_mesh(d.u, s, grp, ph, tmp, cs, sn);
  float* r = run_levels(z, z == buf_a ? buf_b : buf_a, in * out, out,
                        d.u.levels, cs, sn, d.u.perm, false,
                        save ? su : nullptr);
  // the gradient at U's output rows: g[j, o] = dW[o, j]
  const float* dw = d.out + static_cast<size_t>(s) * out * in;
  for (int i = tid; i < in * out; i += blockDim.x)
    g_a[i] = dw[(i % out) * in + i / out];
  for (int i = tid; i < nu; i += blockDim.x) dph[i] = 0.0f;
  __syncthreads();
  float* y = r;
  float* ty = r == buf_a ? buf_b : buf_a;
  float* g = g_a;
  float* tg = g_b;
  reverse_levels(y, ty, g, tg, in, out, d.u.levels, d.u.slots, cs, sn,
                 d.u.perm, d.u.slot, d.u.sign, false, save ? su : nullptr,
                 dph);
  // g: the gradient at U's input rows (D_u applied); sigma's, and V's
  // output's through sigma and D_v
  float* da = tg;
  for (int w = tid; w < k; w += blockDim.x) {
    float acc = 0.0f;
    for (int j = 0; j < in; ++j)
      acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(vout[j * in + w], dv[w]),
                                     __fmul_rn(g[j * out + w], du[w])));
    dsig[w] = acc;
  }
  for (int i = tid; i < in * in; i += blockDim.x) {
    const int j = i / in, w = i % in;
    da[i] = w < k ? __fmul_rn(__fmul_rn(__fmul_rn(g[j * out + w], du[w]),
                                        sig[w]), dv[w])
                  : 0.0f;
  }
  noise_transpose(d.u, grp, dph, dphu);
  __syncthreads();
  for (int i = tid; i < nv; i += blockDim.x) dph[i] = 0.0f;
  stage_mesh(d.v, s, grp, ph, tmp, cs, sn);       // ends on a barrier
  y = vout;
  ty = buf_a;
  g = da;
  tg = da == g_a ? g_b : g_a;
  reverse_levels(y, ty, g, tg, in, in, d.v.levels, d.v.slots, cs, sn,
                 d.v.perm, d.v.slot, d.v.sign, true, save ? sv : nullptr,
                 dph);
  noise_transpose(d.v, grp, dph, dphv);
}

// The grouped backward's "warp" design (kernels/mesh_apply.py::
// densify_grad_design picks it for groups whose meshes are at most 32
// ports wide and whose states fit: every core matrix of PAPER_TONN_SPEC;
// the block design above takes the rest).  The same grid and arithmetic,
// one block per (stack entry, matrix), but a mesh row of P ports lives in
// P lanes of a warp, R = 32 / P rows a warp (lane r*P + w holds row r's
// wire w), so a level is y[w] = C[w]*y[w] + S[w]*y[perm w] with the
// partner's value from __shfl_sync and no walk, forward or reverse, takes
// a block barrier a level.  Each thread keeps its own value's input at
// every level in its own column of shared memory (states[level][thread],
// read back by the same thread), so the reverse walks read the forward's
// bits.  A slot's term over one row is formed by the lane of its first
// wire (sign -1), which holds both wires' x and g after the level's two
// shuffles; a warp's R rows sum by a shuffle tree (rows r and r + d, d =
// 1, 2, 4, ...), and each warp writes its sums to shared memory
// (part[warp][level][slot]), which the block sums in warp order after the
// walks: a fixed order, no atomics.  (A version that split each reverse
// walk into the gradient's chain and a second pass over the levels'
// independent terms measured slower on an H100, with the stamps of
// tools/densify_grad_phases.py: 5.2k against 4.1k SM cycles for V's 16
// levels.)
//
// The block's global reads are issued first, independent of each other:
// each lane's dW, diag and sigma values, the gamma of the output it
// writes (where its gradients start comes from the host, GroupOffsets),
// and for both meshes the plan (partner, slot and sign a wire)
// and each slot's phase, gamma and bias, of which it forms the effective
// phase (stage_mesh's arithmetic: DAC-free, gamma, crosstalk with the
// neighbours' gamma*phi recomputed, bias).  Then one barrier, the trig of
// both meshes once (cosf, sinf: the forward's tables), a barrier, V's
// forward (its output rows feed U's rows in another lane layout), a
// barrier, U's walks (the gradient at U's input feeds V's reverse walk), a
// barrier, V's reverse walk, a barrier, and the outputs.
constexpr int kWarpGradMaxThreads = 1024;

// A wire's plan word in shared memory: its slot << 2 | its sign (0: none,
// 1: +1, 2: -1, the slot's first wire, which forms the slot's term).
__device__ __forceinline__ int plan_word(int slot, float sign) {
  return slot << 2 | (sign > 0.0f ? 1 : (sign < 0.0f ? 2 : 0));
}

// The warp design's smem view of one mesh: per wire (levels, ports) cos,
// signed sin, partner and plan word; per slot (levels, slots) the
// effective phase.
struct WarpMesh {
  float* cs;
  float* sn;
  int* pm;
  int* plan;
  float* eff;
  int ports, levels, slots;
};

__device__ WarpMesh warp_mesh(const MeshSide& m, float*& at) {
  WarpMesh w;
  const int n = m.levels * m.ports;
  w.cs = at;
  w.sn = w.cs + n;
  w.pm = reinterpret_cast<int*>(w.sn + n);
  w.plan = w.pm + n;
  w.eff = reinterpret_cast<float*>(w.plan + n);
  at = w.eff + m.levels * m.slots;
  w.ports = m.ports;
  w.levels = m.levels;
  w.slots = m.slots;
  return w;
}

// Entry i of a mesh's staging — a wire's plan (past its wires: a slot's
// effective phase) — in two halves, so that a thread issues the global
// reads of all its entries before it waits on any: stage_read takes a
// wire's partner, slot and sign, or a slot's phase, gamma and bias and its
// neighbours' gamma and phase; stage_write forms the plan word or the
// effective phase (stage_mesh's arithmetic) and stores it.
struct StageRead {
  float v[7];
};

__device__ __forceinline__ StageRead stage_read(const MeshSide& m, int s,
                                                int i) {
  StageRead r = {};
  const int wires = m.levels * m.ports;
  if (i < wires) {
    r.v[0] = __int_as_float(m.perm[i]);
    r.v[1] = __int_as_float(m.slot[i]);
    r.v[2] = m.sign[i];
    return r;
  }
  const int j = i - wires, k = j % m.slots;
  const float* src = m.phases + static_cast<size_t>(s) * m.levels * m.slots;
  r.v[0] = src[j];
  if (m.gamma != nullptr) {
    r.v[1] = m.gamma[j];
    r.v[2] = m.bias[j];
    if (m.crosstalk && k + 1 < m.slots) {
      r.v[3] = m.gamma[j + 1];
      r.v[4] = src[j + 1];
    }
    if (m.crosstalk && k > 0) {
      r.v[5] = m.gamma[j - 1];
      r.v[6] = src[j - 1];
    }
  }
  return r;
}

__device__ __forceinline__ void stage_write(const MeshSide& m,
                                            const MeshGroup& grp,
                                            const WarpMesh& w, int i,
                                            const StageRead& r) {
  const int wires = m.levels * m.ports;
  if (i < wires) {
    w.pm[i] = __float_as_int(r.v[0]);
    w.plan[i] = plan_word(__float_as_int(r.v[1]), r.v[2]);
    return;
  }
  const int j = i - wires, k = j % m.slots;
  float v = r.v[0];
  if (m.gamma != nullptr) {
    float p = __fmul_rn(r.v[1], v);
    if (m.crosstalk) {
      const float left = k + 1 < m.slots ? __fmul_rn(r.v[3], r.v[4]) : 0.0f;
      const float right = k > 0 ? __fmul_rn(r.v[5], r.v[6]) : 0.0f;
      p = __fadd_rn(p, __fmul_rn(grp.kappa, __fadd_rn(left, right)));
    }
    v = __fadd_rn(p, r.v[2]);
  }
  w.eff[j] = v;
}

// A wire's trig from its slot's effective phase: build_trig's arithmetic.
__device__ __forceinline__ void stage_trig(const WarpMesh& w, int i) {
  const int q = w.plan[i];
  const float sg = (q & 3) == 0 ? 0.0f : ((q & 3) == 1 ? 1.0f : -1.0f);
  const float v = w.eff[(i / w.ports) * w.slots + (q >> 2)];
  w.cs[i] = sg != 0.0f ? cosf(v) : 1.0f;
  w.sn[i] = __fmul_rn(sg, sinf(v));
}

// A thread's place in the warp-row layout of a P-port mesh on `rows` rows:
// its wire w, the lane of its row's wire 0, its row, and whether it holds
// one (a dead lane reads itself and carries zeros).
struct WarpLane {
  int w, base, row;
  bool live;
};

__device__ WarpLane warp_lane(int ports, int rows) {
  const int lane = threadIdx.x & 31;
  const int r = lane / ports;
  WarpLane l;
  l.row = (threadIdx.x >> 5) * (32 / ports) + r;
  l.live = r < 32 / ports && l.row < rows;
  l.w = l.live ? lane - r * ports : 0;
  l.base = r * ports;
  return l;
}

// The levels of one mesh on a warp's rows, as run_levels: x this lane's
// value; its level-c input goes to states[c * blockDim.x + threadIdx.x].
__device__ float warp_levels(float x, const WarpLane& l, const WarpMesh& m,
                             bool transpose, float* states) {
  const int lane = threadIdx.x & 31;
#pragma unroll 4
  for (int c = 0; c < m.levels; ++c) {
    const int i = (transpose ? m.levels - 1 - c : c) * m.ports + l.w;
    const int src = l.live ? l.base + m.pm[i] : lane;
    const float s = transpose ? -m.sn[i] : m.sn[i];
    states[c * blockDim.x + threadIdx.x] = x;
    const float xp = __shfl_sync(kFullMask, x, src);
    x = __fadd_rn(__fmul_rn(m.cs[i], x), __fmul_rn(s, xp));
  }
  return x;
}

// The reverse walk of warp_levels, as reverse_levels with the states kept:
// g the gradient at the levels' output, returned at their input; part this
// warp's phase gradients (levels, slots), each written once by row 0's
// lane of the slot's first wire with the sum of its rows.
__device__ float warp_reverse(float g, const WarpLane& l, const WarpMesh& m,
                              bool transpose, const float* states,
                              float* part) {
  const int lane = threadIdx.x & 31;
  const int R = 32 / m.ports, r = lane / m.ports;
#pragma unroll 2
  for (int c = m.levels - 1; c >= 0; --c) {
    const int cl = transpose ? m.levels - 1 - c : c;
    const int i = cl * m.ports + l.w;
    const int src = l.live ? l.base + m.pm[i] : lane;
    const float x = states[c * blockDim.x + threadIdx.x];
    const float cc = m.cs[i], sc = m.sn[i];
    const int q = m.plan[i];
    const float xp = __shfl_sync(kFullMask, x, src);
    const float gp = __shfl_sync(kFullMask, g, src);
    // sn = sign * sin(phi) = -sin(phi) on the slot's first wire, the only
    // lane whose term is kept; the rows of a warp at one wire share it
    const bool first = l.live && (q & 3) == 2;
    const float cb = transpose ? cc : -cc;
    const float dya = __fadd_rn(__fmul_rn(sc, x), __fmul_rn(cb, xp));
    const float dyb = __fsub_rn(__fmul_rn(sc, xp), __fmul_rn(cb, x));
    const float t = __fadd_rn(__fmul_rn(g, dya), __fmul_rn(gp, dyb));
    float term = first ? t : 0.0f;
    g = __fsub_rn(__fmul_rn(cc, g),
                  __fmul_rn(transpose ? -sc : sc, gp));
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      if (d >= R) break;                               // warp-uniform
      const float o = __shfl_down_sync(kFullMask, term, d * m.ports);
      if ((r & (2 * d - 1)) == 0 && r + d < R) term = __fadd_rn(term, o);
    }
    if (r == 0 && first) part[cl * m.slots + (q >> 2)] = term;
  }
  return g;
}

// Element i of the warps' phase gradients part (warps, n), summed in warp
// order.
__device__ float warp_sum(const float* part, int n, int warps, int i) {
  float v = part[i];
  for (int w = 1; w < warps; ++w) v = __fadd_rn(v, part[w * n + i]);
  return v;
}

// noise_transpose's element i from the warps' sums; gamma: m.gamma[i].
__device__ float warp_noise_transpose(const MeshSide& m, const MeshGroup& grp,
                                      const float* part, int warps, int i,
                                      float gamma) {
  const int n = m.levels * m.slots;
  float v = warp_sum(part, n, warps, i);
  if (m.gamma != nullptr) {
    if (m.crosstalk) {
      const int k = i % m.slots;
      const float left = k + 1 < m.slots ? warp_sum(part, n, warps, i + 1)
                                         : 0.0f;
      const float right = k > 0 ? warp_sum(part, n, warps, i - 1) : 0.0f;
      v = __fadd_rn(v, __fmul_rn(grp.kappa, __fadd_rn(left, right)));
    }
    v = __fmul_rn(gamma, v);
  }
  return v;
}

// Warps a P-port mesh's warp rows take over `rows` rows.
__host__ __device__ inline int warp_row_warps(int ports, int rows) {
  const int per = 32 / ports;
  return (rows + per - 1) / per;
}

// grid (S, G), blockDim.x = 32 * warps, warps enough for both meshes of
// every matrix (warp_row_warps); grads as for mesh_densify_grad_kernel.
__global__ void __launch_bounds__(kWarpGradMaxThreads)
mesh_densify_grad_warp_kernel(const __grid_constant__ MeshGroup grp,
                              const __grid_constant__ GroupOffsets offs,
                              float* __restrict__ grads) {
  extern __shared__ float smem[];
  const MatrixDesc& d = grp.m[blockIdx.y];
  const int s = blockIdx.x, S = grp.stack;
  const int in = d.v.ports, out = d.u.ports, k = d.k;
  const int nu = d.u.levels * d.u.slots, nv = d.v.levels * d.v.slots;
  const int T = blockDim.x, warp = threadIdx.x >> 5, tid = threadIdx.x;
  float* at = smem;
  const WarpMesh mv = warp_mesh(d.v, at);
  const WarpMesh mu = warp_mesh(d.u, at);
  float* vout = at;                      // V's output rows (in, in)
  float* gu = vout + in * in;            // the gradient at U's input rows
  float* st_v = gu + in * out;           // V's states (Lv, T)
  float* st_u = st_v + d.v.levels * T;   // U's states (Lu, T)
  float* part_u = st_u + d.u.levels * T; // (warps, Lu, Ku)
  float* part_v = part_u + (T >> 5) * nu;  // (warps, Lv, Kv)

  const int64_t off = offs.grads[blockIdx.y];     // this matrix's grads
  float* dphu = grads + off + static_cast<size_t>(s) * nu;
  float* dphv = grads + off + static_cast<size_t>(S) * nu +
                static_cast<size_t>(s) * nv;
  float* dsig = grads + off + static_cast<size_t>(S) * (nu + nv) +
                static_cast<size_t>(s) * k;

  // every global read a lane needs later, issued first
  const float* dv = d.v.diag + s * d.v.diag_stride_s;
  const float* du = d.u.diag + s * d.u.diag_stride_s;
  const float* sig = d.sigma + static_cast<size_t>(s) * k;
  const WarpLane lv = warp_lane(in, in), lu = warp_lane(out, in);
  const bool walk_v = warp < warp_row_warps(in, in);
  const bool walk_u = warp < warp_row_warps(out, in);
  float g_out = 0.0f, z_scale = 0.0f, du_o = 0.0f;   // U's lane
  if (lu.live) {
    const int o = lu.w;
    g_out = d.out[static_cast<size_t>(s) * out * in + o * in + lu.row];
    du_o = du[o];
    if (o < k) z_scale = dv[o];
  }
  const float sig_o = lu.live && lu.w < k ? sig[lu.w] : 0.0f;
  float du_w = 0.0f, sig_w = 0.0f, dv_w = 0.0f;       // V's lane
  if (lv.live && lv.w < k) {
    du_w = du[lv.w];
    sig_w = sig[lv.w];
    dv_w = dv[lv.w];
  }
  float gam = 0.0f, dsig_dv = 0.0f, dsig_du = 0.0f;   // output tid
  if (tid < nu) {
    if (d.u.gamma != nullptr) gam = d.u.gamma[tid];
  } else if (tid < nu + nv) {
    if (d.v.gamma != nullptr) gam = d.v.gamma[tid - nu];
  } else if (tid < nu + nv + k) {
    dsig_dv = dv[tid - nu - nv];
    dsig_du = du[tid - nu - nv];
  }

  // both meshes' plans and effective phases, two entries a thread a
  // round (every read of a round issued first), then their trig
  const int pv = d.v.levels * (in + d.v.slots);
  const int n = pv + d.u.levels * (out + d.u.slots);
  for (int i = tid; i < n; i += 2 * T) {
    const int i2 = i + T;
    const StageRead a = i < pv ? stage_read(d.v, s, i)
                               : stage_read(d.u, s, i - pv);
    StageRead b = {};
    if (i2 < n)
      b = i2 < pv ? stage_read(d.v, s, i2) : stage_read(d.u, s, i2 - pv);
    if (i < pv)
      stage_write(d.v, grp, mv, i, a);
    else
      stage_write(d.u, grp, mu, i - pv, a);
    if (i2 < pv)
      stage_write(d.v, grp, mv, i2, b);
    else if (i2 < n)
      stage_write(d.u, grp, mu, i2 - pv, b);
  }
  for (int i = tid; i < (T >> 5) * (nu + nv); i += T) part_u[i] = 0.0f;
  __syncthreads();
  const int tv = d.v.levels * in, tu = d.u.levels * out;
  for (int i = tid; i < tv + tu; i += T) {
    if (i < tv)
      stage_trig(mv, i);
    else
      stage_trig(mu, i - tv);
  }
  __syncthreads();

  // V, transposed, on the identity: row j = e_j, D_v later
  if (walk_v) {
    const float a = warp_levels(lv.live && lv.w == lv.row ? 1.0f : 0.0f, lv,
                                mv, true, st_v);
    if (lv.live) vout[lv.row * in + lv.w] = a;
  }
  __syncthreads();
  // U on D_v, sigma on the first k wires, zeros up to out_dim, D_u; then
  // its reverse walk from dW^T
  if (walk_u) {
    float z = 0.0f;
    if (lu.live) {
      const float zv = lu.w < k
          ? __fmul_rn(__fmul_rn(vout[lu.row * in + lu.w], z_scale), sig_o)
          : 0.0f;
      z = __fmul_rn(zv, du_o);
    }
    warp_levels(z, lu, mu, false, st_u);
    const float g = warp_reverse(g_out, lu, mu, false, st_u,
                                 part_u + warp * nu);
    if (lu.live) gu[lu.row * out + lu.w] = g;
  }
  __syncthreads();
  // V's output gradient through D_u, sigma and D_v; V's reverse walk
  if (walk_v) {
    const float g = lv.live && lv.w < k
        ? __fmul_rn(__fmul_rn(__fmul_rn(gu[lv.row * out + lv.w], du_w),
                              sig_w), dv_w)
        : 0.0f;
    warp_reverse(g, lv, mv, true, st_v, part_v + warp * nv);
  }
  __syncthreads();
  // dphases through the noise model's transpose, and dsigma over the rows
  // in order, as the block design
  const int wu = warp_row_warps(out, in), wv = warp_row_warps(in, in);
  for (int i = tid; i < nu + nv + k; i += T) {
    if (i < nu) {
      dphu[i] = warp_noise_transpose(
          d.u, grp, part_u, wu, i,
          i == tid ? gam : (d.u.gamma != nullptr ? d.u.gamma[i] : 0.0f));
    } else if (i < nu + nv) {
      const int iv = i - nu;
      dphv[iv] = warp_noise_transpose(
          d.v, grp, part_v, wv, iv,
          i == tid ? gam : (d.v.gamma != nullptr ? d.v.gamma[iv] : 0.0f));
    } else {
      const int w = i - nu - nv;
      const float dvw = i == tid ? dsig_dv : dv[w];
      const float duw = i == tid ? dsig_du : du[w];
      float acc = 0.0f;
      for (int j = 0; j < in; ++j)
        acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(vout[j * in + w], dvw),
                                       __fmul_rn(gu[j * out + w], duw)));
      dsig[w] = acc;
    }
  }
}

// The resident backward: grid (row-tile columns, S); block x takes the row
// tiles x, x + gridDim.x, ... of entry s with the layout's tables resident
// as in mesh_apply_kernel, zeroes its own slice of dph, (gridDim.x, S,
// levels, slots) (or, with one column, dphases itself), and adds its phase
// gradients over its tiles into it.  y, dy, dx: (S, batch, ports); dx and dph may be
// null (not asked for).
__global__ void __launch_bounds__(kThreads)
mesh_apply_grad_kernel(const float* __restrict__ y,
                       const float* __restrict__ dy,
                       const float* __restrict__ phases,
                       const int* __restrict__ slot,
                       const float* __restrict__ sign,
                       const int* __restrict__ perm,
                       const float* __restrict__ diag, float* __restrict__ dx,
                       float* __restrict__ dph, int batch, int ports,
                       int levels, int slots, int rows_per_block,
                       int64_t diag_stride_s, int transpose) {
  extern __shared__ float smem[];
  const int table = levels * ports;
  float* cs = smem;
  float* sn = cs + table;
  int* pm = reinterpret_cast<int*>(sn + table);
  float* dg = reinterpret_cast<float*>(pm + table);
  float* b0 = dg + ports;
  float* b1 = b0 + rows_per_block * ports;
  float* b2 = b1 + rows_per_block * ports;
  float* b3 = b2 + rows_per_block * ports;
  const size_t s = blockIdx.y;
  const int tid = threadIdx.x;
  const bool tr = transpose != 0;

  build_trig(phases + s * levels * slots, slot, sign, table, ports, slots,
             cs, sn);
  for (int i = tid; i < table; i += blockDim.x) pm[i] = perm[i];
  const float* dg_g = diag + s * diag_stride_s;
  for (int i = tid; i < ports; i += blockDim.x) dg[i] = dg_g[i];
  float* part = dph ? dph + (static_cast<size_t>(blockIdx.x) * gridDim.y + s)
                                * levels * slots
                    : nullptr;
  if (part)
    for (int i = tid; i < levels * slots; i += blockDim.x) part[i] = 0.0f;
  __syncthreads();

  for (int row0 = blockIdx.x * rows_per_block; row0 < batch;
       row0 += gridDim.x * rows_per_block) {
    const int rows = min(rows_per_block, batch - row0);
    const int n = rows * ports;
    const size_t base = (s * batch + row0) * static_cast<size_t>(ports);
    float* yb = b0;
    float* ty = b1;
    float* gb = b2;
    float* tg = b3;
    // transposed, D comes last in the forward: the levels' output is y / D
    // (exact for the +-1 buffers) and their gradient dy * D
    for (int i = tid; i < n; i += blockDim.x) {
      const float d = dg[i % ports];
      yb[i] = tr ? __fdiv_rn(y[base + i], d) : y[base + i];
      gb[i] = tr ? __fmul_rn(dy[base + i], d) : dy[base + i];
    }
    __syncthreads();
    reverse_levels(yb, ty, gb, tg, rows, ports, levels, slots, cs, sn, pm,
                   slot, sign, tr, nullptr, part);
    if (dx)
      for (int i = tid; i < n; i += blockDim.x)
        dx[base + i] = tr ? gb[i] : __fmul_rn(gb[i], dg[i % ports]);
    __syncthreads();
  }
}

// out[i] = the blocks' partial sums part[b * count + i], b in order.
__global__ void mesh_grad_sum_kernel(const float* __restrict__ part,
                                     float* __restrict__ out, int blocks,
                                     int64_t count) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < count; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float acc = part[i];
    int b = 1;
    for (; b + 32 <= blocks; b += 32) {     // 32 loads in flight, then
      float v[32];                          // added in order
#pragma unroll
      for (int u = 0; u < 32; ++u) v[u] = part[(b + u) * count + i];
#pragma unroll
      for (int u = 0; u < 32; ++u) acc = __fadd_rn(acc, v[u]);
    }
    for (; b < blocks; ++b) acc = __fadd_rn(acc, part[b * count + i]);
    out[i] = acc;
  }
}

// The resident backward's "warp" design (kernels/mesh_apply.py::
// resident_grad_design picks it for meshes of at most 32 ports, and for
// brick layouts of 33 to 64 ports: every rectangular mesh the repo's
// configs build; mesh_apply_grad_kernel above stays as the "block" design
// for the rest).  The function of mesh_apply_grad_kernel with a mesh row
// in a warp's lanes, so that no level takes a block barrier.  Two lane
// layouts:
//   lanes (P <= 32, any layout): one wire a lane, R = 32 / P rows a warp
//     (warp_lane: lane r*P + w holds row r's wire w); a wire's partner by
//     __shfl_sync from the lane of perm[w];
//   pairs (33 <= P <= 64, brick levels: mesh_apply.py::adjacent_pairs):
//     wires 2l and 2l + 1 in lane l, one row a warp; a level of parity 0
//     pairs a lane's two wires (no shuffle), one of parity 1 pairs lane
//     l's upper wire with lane l + 1's lower (one __shfl_up_sync and one
//     __shfl_down_sync a value).
// Each level, last first, as reverse_levels without states: the input
// recovered from the output, x = C*y - S*y[perm], the gradient carried,
// g <- C*g - S*g[perm] (the same rounded operations, so dx is the plain
// version's bits), and each slot's term over the row formed by one lane
// from both wires' x and g: the lane of the slot's first wire (lanes;
// the partner's x recovered in the lane, C*y[b] + S*y[a], the bits the
// partner's lane forms), the lane of its lower wire (pairs; the term with
// the pair's wires swapped is exactly the negated term, so the lane forms
// it from its lower wire and negates it where the upper wire comes
// first).  A lane owns at most one slot a level.  A warp's R rows sum by
// warp_reverse's shuffle tree, and the row groups a warp walks add, in
// order, into the warp's own words part[warp][level][slot]: no barrier,
// no atomics.  After the walk one barrier, then the warps' words summed in
// warp order (warp_sum), every slot written (0 where a level has no MZI).
// Over several block columns each column writes its sums to partials
// (columns, S, levels, slots), summed in column order by the entry's last
// block to finish (an atomic ticket a stack entry, reset by that block;
// no block waits on another) where the columns are few ("fold"), else by
// mesh_grad_sum_kernel.
//
// Staging: one round of global reads (kStageBatch entries a thread issued
// before any is used: a wire's partner, slot and sign, a slot's phase),
// each slot's cosf and sinf once (a wire's table entry is then build_trig's
// cos-if-paired-else-1 and sign * sin: the same bits), a barrier, each
// lane's records of every level, a barrier.
constexpr int kResWarpMaxThreads = 1024;
constexpr int kStageBatch = 4;
// pairs: a lane's word a level, its pair's slot << 3 | the flags
constexpr int kParity = 1;      // the level pairs (2i - 1, 2i)
constexpr int kLowFirst = 2;    // the pair's lower wire has sign -1
constexpr int kOwns = 4;        // the lane forms a slot's term

// Shared memory of one warp-design block (``pairs`` or lanes, ``warps``
// warps): the records (levels, 32 or P) of 16 bytes, pairs' words, and a
// region that holds the staging's plan and slot trig, then the warps'
// phase gradients.
__host__ __device__ inline size_t res_warp_smem(int ports, int levels,
                                                int slots, int warps,
                                                bool pairs) {
  const size_t L = levels, P = ports, K = slots;
  const size_t stage = 2 * L * P + 2 * L * K;
  const size_t part = static_cast<size_t>(warps) * L * K;
  return 16 * L * (pairs ? 32 : P) + (pairs ? 4 * L * 32 : 0) +
         4 * (stage > part ? stage : part);
}

// A wire's cos and signed sin from its plan word and its level's slot
// trig (build_trig's arithmetic).
__device__ __forceinline__ void wire_trig(int q, const float* tc,
                                          const float* ts, float& c,
                                          float& s) {
  const float sg = (q & 3) == 0 ? 0.0f : ((q & 3) == 1 ? 1.0f : -1.0f);
  c = sg != 0.0f ? tc[q >> 2] : 1.0f;
  s = __fmul_rn(sg, ts[q >> 2]);
}

// One level of the pairs layout's walk for a chunk of rows, parity kPar
// (a compile-time choice, so a parity-0 level takes no shuffle and no
// select): each wire's input recovered, the lane's slot term of each row
// added to acc in row order (own: the lane holds a pair), the gradient
// carried.  r: the lane's record (cos, sin of its lower and upper wire).
template <bool kTr, bool kPh, int kChunk, bool kPar>
__device__ __forceinline__ void pair_level(const float4& r, bool own,
                                           bool low_first, float& acc,
                                           float (&yl)[kChunk],
                                           float (&yh)[kChunk],
                                           float (&gl)[kChunk],
                                           float (&gh)[kChunk]) {
  const float sl = kTr ? -r.y : r.y, sh = kTr ? -r.w : r.w;
  float ylp[kChunk], yhp[kChunk], glp[kChunk], ghp[kChunk];
#pragma unroll
  for (int m = 0; m < kChunk; ++m) {          // each wire's partner's
    if (kPar) {
      ylp[m] = __shfl_up_sync(kFullMask, yh[m], 1);
      yhp[m] = __shfl_down_sync(kFullMask, yl[m], 1);
      glp[m] = __shfl_up_sync(kFullMask, gh[m], 1);
      ghp[m] = __shfl_down_sync(kFullMask, gl[m], 1);
    } else {
      ylp[m] = yh[m];
      yhp[m] = yl[m];
      glp[m] = gh[m];
      ghp[m] = gl[m];
    }
  }
  float xl[kChunk], xh[kChunk];
#pragma unroll
  for (int m = 0; m < kChunk; ++m) {
    xl[m] = __fsub_rn(__fmul_rn(r.x, yl[m]), __fmul_rn(sl, ylp[m]));
    xh[m] = __fsub_rn(__fmul_rn(r.z, yh[m]), __fmul_rn(sh, yhp[m]));
  }
  if (kPh && own) {
    // the lane's pair (a, b): (lo, hi) at parity 0, (hi, hi + 1) at
    // parity 1, whose x[b] = C*y[b] + S*y[a] is formed here
    const float ms = kPar ? r.w : r.y, cc = kPar ? r.z : r.x;
    const float cb = kTr ? cc : -cc;
#pragma unroll
    for (int m = 0; m < kChunk; ++m) {
      const float xa = kPar ? xh[m] : xl[m];
      const float xb = kPar ? __fadd_rn(__fmul_rn(r.z, yhp[m]),
                                        __fmul_rn(sh, yh[m]))
                            : xh[m];
      const float ga = kPar ? gh[m] : gl[m];
      const float gb = kPar ? ghp[m] : gh[m];
      const float dya = __fadd_rn(__fmul_rn(ms, xa), __fmul_rn(cb, xb));
      const float dyb = __fsub_rn(__fmul_rn(ms, xb), __fmul_rn(cb, xa));
      const float t = __fadd_rn(__fmul_rn(ga, dya), __fmul_rn(gb, dyb));
      acc = __fadd_rn(acc, low_first ? t : -t);
    }
  }
#pragma unroll
  for (int m = 0; m < kChunk; ++m) {
    gl[m] = __fsub_rn(__fmul_rn(r.x, gl[m]), __fmul_rn(sl, glp[m]));
    gh[m] = __fsub_rn(__fmul_rn(r.z, gh[m]), __fmul_rn(sh, ghp[m]));
    yl[m] = xl[m];
    yh[m] = xh[m];
  }
}

// grid (columns, S), blockDim.x = 32 * warps; column x walks the row
// groups [x * per_column, (x + 1) * per_column) of entry s, warp q the
// groups q, q + warps, ... of them.  y, dy, dx: (S, batch, ports); dph:
// (S, levels, slots); dx may be null, and without kPh dph is.
template <bool kPairs, bool kTr, bool kPh, int kChunk>
__global__ void __launch_bounds__(kResWarpMaxThreads)
mesh_apply_grad_warp_kernel(const float* __restrict__ y,
                            const float* __restrict__ dy,
                            const float* __restrict__ phases,
                            const int* __restrict__ slot,
                            const float* __restrict__ sign,
                            const int* __restrict__ perm,
                            const float* __restrict__ diag,
                            float* __restrict__ dx, float* __restrict__ dph,
                            float* __restrict__ partials,
                            int* __restrict__ tickets, int batch, int ports,
                            int levels, int slots, int per_column,
                            int64_t diag_stride_s) {
  extern __shared__ float4 smem4[];
  __shared__ int last;
  const int L = levels, P = ports, K = slots;
  const int nw = L * P, nk = L * K;
  float4* rec = smem4;
  int* word = reinterpret_cast<int*>(rec + L * (kPairs ? 32 : P));
  float* region = reinterpret_cast<float*>(word + (kPairs ? L * 32 : 0));
  int* pm = reinterpret_cast<int*>(region);
  int* plan = pm + nw;
  float* tc = reinterpret_cast<float*>(plan + nw);
  float* ts = tc + nk;
  float* part = region;                 // after the staging: (warps, L, K)
  const int T = blockDim.x, W = T >> 5, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int s = blockIdx.y;

  // one round of global reads: the wires' plan, the slots' phases
  const float* ph = phases + static_cast<size_t>(s) * nk;
  for (int i0 = tid; i0 < nw + nk; i0 += kStageBatch * T) {
    int a[kStageBatch], b[kStageBatch];
    float v[kStageBatch];
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int i = i0 + u * T;
      a[u] = 0;
      b[u] = 0;
      v[u] = 0.0f;
      if (i < nw) {
        a[u] = perm[i];
        b[u] = slot[i];
        v[u] = sign[i];
      } else if (i < nw + nk) {
        v[u] = ph[i - nw];
      }
    }
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int i = i0 + u * T;
      if (i < nw) {
        pm[i] = a[u];
        plan[i] = plan_word(b[u], v[u]);
      } else if (i < nw + nk) {
        tc[i - nw] = cosf(v[u]);
        ts[i - nw] = sinf(v[u]);
      }
    }
  }
  __syncthreads();
  // each lane's record of every level
  if constexpr (kPairs) {
    for (int cl = warp; cl < L; cl += W) {
      const int lo = 2 * lane, hi = lo + 1;
      float4 r = make_float4(1.0f, 0.0f, 1.0f, 0.0f);
      int ql = 0, qh = 0;
      bool own0 = false, own1 = false;
      if (lo < P) {
        ql = plan[cl * P + lo];
        wire_trig(ql, tc + cl * K, ts + cl * K, r.x, r.y);
        own0 = pm[cl * P + lo] == hi;
      }
      if (hi < P) {
        qh = plan[cl * P + hi];
        wire_trig(qh, tc + cl * K, ts + cl * K, r.z, r.w);
        own1 = pm[cl * P + hi] == hi + 1;
      }
      // a brick level pairs wires of one parity: any lane's pair across
      // lanes makes it a parity-1 level
      const bool par = __any_sync(kFullMask, own1);
      int w = par ? kParity : 0;
      if (par ? own1 : own0) {
        const int q = par ? qh : ql;          // the pair's lower wire
        w |= kOwns | ((q & 3) == 2 ? kLowFirst : 0) | (q >> 2) << 3;
      }
      rec[cl * 32 + lane] = r;
      word[cl * 32 + lane] = w;
    }
  } else {
    for (int i = tid; i < nw; i += T) {
      const int q = plan[i];
      const int base = (i / P) * K;
      float4 r;
      wire_trig(q, tc + base, ts + base, r.x, r.y);
      r.z = __int_as_float(pm[i]);
      r.w = __int_as_float(q);
      rec[i] = r;
    }
  }
  __syncthreads();

  float* mine = part + static_cast<size_t>(warp) * nk;
  if (kPh) {
    for (int i = lane; i < nk; i += 32) mine[i] = 0.0f;
    __syncwarp();
  }
  const int R = kPairs ? 1 : 32 / P;
  const int groups = (batch + R - 1) / R;
  const int g_end = min(groups, static_cast<int>(blockIdx.x + 1) * per_column);
  const float* dg = diag + s * diag_stride_s;
  const size_t entry = static_cast<size_t>(s) * batch;
  // a warp walks its groups kChunk at a time, level by level together:
  // kChunk independent chains a lane in straight-line code (a chunk's
  // missing group walks zeros), one record load a level for all of them,
  // and a slot's terms of the chunk added to the warp's word in group
  // order (the word read only from a warp's second chunk on)
  const int step = kChunk * W;
  const int first_group = blockIdx.x * per_column + warp;

  if constexpr (kPairs) {
    const int lo = 2 * lane, hi = lo + 1;
    const float d_lo = lo < P ? dg[lo] : 1.0f;
    const float d_hi = hi < P ? dg[hi] : 1.0f;
    for (int g0 = first_group; g0 < g_end; g0 += step) {
      const bool fresh = g0 == first_group;
      float yl[kChunk], yh[kChunk], gl[kChunk], gh[kChunk];
      // the chunk's y and dy at the levels' output (transposed: y / D and
      // dy * D), zeros on a dead wire or a missing group
#pragma unroll
      for (int m = 0; m < kChunk; ++m) {
        const int gi = g0 + m * W;
        float y_l = 0.0f, y_h = 0.0f, g_l = 0.0f, g_h = 0.0f;
        if (gi < g_end) {
          const size_t at = (entry + gi) * P;
          if (lo < P) {
            y_l = y[at + lo];
            g_l = dy[at + lo];
          }
          if (hi < P) {
            y_h = y[at + hi];
            g_h = dy[at + hi];
          }
        }
        yl[m] = kTr ? __fdiv_rn(y_l, d_lo) : y_l;
        yh[m] = kTr ? __fdiv_rn(y_h, d_hi) : y_h;
        gl[m] = kTr ? __fmul_rn(g_l, d_lo) : g_l;
        gh[m] = kTr ? __fmul_rn(g_h, d_hi) : g_h;
      }
      int cl = kTr ? 0 : L - 1;
      float4 r = rec[cl * 32 + lane];
      int q = word[cl * 32 + lane];
      for (int c = L - 1; c >= 0; --c) {
        // the next level's record, and this level's word of the warp's
        // sums, loaded before any store of this level
        const int cn = kTr ? cl + 1 : cl - 1;
        const int at_n = (c > 0 ? cn : cl) * 32 + lane;
        const float4 rn = rec[at_n];
        const int qn = word[at_n];
        float* dst = mine + cl * K + (q >> 3);
        const bool own = kPh && (q & kOwns);
        float acc = own && !fresh ? *dst : 0.0f;
        if (q & kParity)                              // warp-uniform
          pair_level<kTr, kPh, kChunk, true>(r, own, q & kLowFirst, acc, yl,
                                             yh, gl, gh);
        else
          pair_level<kTr, kPh, kChunk, false>(r, own, q & kLowFirst, acc, yl,
                                              yh, gl, gh);
        if (own) *dst = acc;
        r = rn;
        q = qn;
        cl = cn;
      }
      if (dx != nullptr) {
#pragma unroll
        for (int m = 0; m < kChunk; ++m) {
          if (g0 + m * W >= g_end) break;
          const size_t at = (entry + g0 + m * W) * P;
          if (lo < P) dx[at + lo] = kTr ? gl[m] : __fmul_rn(gl[m], d_lo);
          if (hi < P) dx[at + hi] = kTr ? gh[m] : __fmul_rn(gh[m], d_hi);
        }
      }
    }
  } else {
    const int r = lane / P;
    const bool lane_live = r < R;
    const int w = lane_live ? lane - r * P : 0;
    const int base = r * P;
    const float d = dg[w];
    for (int g0 = first_group; g0 < g_end; g0 += step) {
      const bool fresh = g0 == first_group;
      bool row_live[kChunk];
      float yv[kChunk], gv[kChunk];
#pragma unroll
      for (int m = 0; m < kChunk; ++m) {
        const int gi = g0 + m * W;
        const int row = gi * R + r;
        float y0 = 0.0f, g0v = 0.0f;
        row_live[m] = gi < g_end && lane_live && row < batch;
        if (row_live[m]) {
          const size_t at = (entry + row) * P + w;
          y0 = y[at];
          g0v = dy[at];
        }
        yv[m] = kTr ? __fdiv_rn(y0, d) : y0;
        gv[m] = kTr ? __fmul_rn(g0v, d) : g0v;
      }
      int cl = kTr ? 0 : L - 1;
      float4 rr = rec[cl * P + w];
      for (int c = L - 1; c >= 0; --c) {
        const int cn = kTr ? cl + 1 : cl - 1;
        const float4 rn = rec[(c > 0 ? cn : cl) * P + w];
        const int q = __float_as_int(rr.w);
        // the slot's first wire a (sign -1) forms the term, row 0 of the
        // group keeps the tree's sum; its partner b's x = C*y[b] + S*y[a]
        const bool first = (q & 3) == 2;
        const bool keep = kPh && lane_live && r == 0 && first;
        float* dst = mine + cl * K + (q >> 2);
        const float prev = keep && !fresh ? *dst : 0.0f;
        const float cc = rr.x, sc = rr.y;
        const float sv = kTr ? -sc : sc;
        const int pw = base + __float_as_int(rr.z);
        float yp[kChunk], gp[kChunk], x[kChunk];
#pragma unroll
        for (int m = 0; m < kChunk; ++m) {
          const int src = row_live[m] ? pw : lane;
          yp[m] = __shfl_sync(kFullMask, yv[m], src);
          gp[m] = __shfl_sync(kFullMask, gv[m], src);
        }
#pragma unroll
        for (int m = 0; m < kChunk; ++m)
          x[m] = __fsub_rn(__fmul_rn(cc, yv[m]), __fmul_rn(sv, yp[m]));
        if (kPh) {
          const float cb = kTr ? cc : -cc;
          float term[kChunk];
#pragma unroll
          for (int m = 0; m < kChunk; ++m) {
            const float xb = __fadd_rn(__fmul_rn(cc, yp[m]),
                                       __fmul_rn(sv, yv[m]));
            const float dya = __fadd_rn(__fmul_rn(sc, x[m]),
                                        __fmul_rn(cb, xb));
            const float dyb = __fsub_rn(__fmul_rn(sc, xb),
                                        __fmul_rn(cb, x[m]));
            const float t = __fadd_rn(__fmul_rn(gv[m], dya),
                                      __fmul_rn(gp[m], dyb));
            term[m] = row_live[m] && first ? t : 0.0f;
          }
          for (int dd = 1; dd < R; dd *= 2) {             // warp-uniform
#pragma unroll
            for (int m = 0; m < kChunk; ++m) {
              const float o = __shfl_down_sync(kFullMask, term[m], dd * P);
              if ((r & (2 * dd - 1)) == 0 && r + dd < R)
                term[m] = __fadd_rn(term[m], o);
            }
          }
          if (keep) {
            float acc = prev;
#pragma unroll
            for (int m = 0; m < kChunk; ++m) acc = __fadd_rn(acc, term[m]);
            *dst = acc;
          }
        }
#pragma unroll
        for (int m = 0; m < kChunk; ++m) {
          gv[m] = __fsub_rn(__fmul_rn(cc, gv[m]), __fmul_rn(sv, gp[m]));
          yv[m] = x[m];
        }
        rr = rn;
        cl = cn;
      }
      if (dx != nullptr) {
#pragma unroll
        for (int m = 0; m < kChunk; ++m)
          if (row_live[m])
            dx[(entry + (g0 + m * W) * R + r) * P + w] =
                kTr ? gv[m] : __fmul_rn(gv[m], d);
      }
    }
  }

  if (!kPh) return;

  __syncthreads();
  const bool one = gridDim.x == 1;
  float* out = one ? dph + static_cast<size_t>(s) * nk
                   : partials + (static_cast<size_t>(blockIdx.x) * gridDim.y +
                                 s) * nk;
  for (int i = tid; i < nk; i += T) out[i] = warp_sum(part, nk, W, i);
  if (one || tickets == nullptr) return;
  // the fold: the entry's last column to finish sums the columns' sums in
  // column order (mesh_grad_sum_kernel's order) and resets the ticket
  __threadfence();
  __syncthreads();
  if (tid == 0)
    last = atomicAdd(tickets + s, 1) == static_cast<int>(gridDim.x) - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const size_t stride = static_cast<size_t>(gridDim.y) * nk;
  for (int i = tid; i < nk; i += T) {
    const float* p = partials + static_cast<size_t>(s) * nk + i;
    float v = __ldcg(p);
    for (int c = 1; c < static_cast<int>(gridDim.x); ++c)
      v = __fadd_rn(v, __ldcg(p + c * stride));
    dph[static_cast<size_t>(s) * nk + i] = v;
  }
  if (tid == 0) tickets[s] = 0;
}

// ------------------------------------------------------------- owner walk

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

// ------------------------------------------------------------- warp rows

constexpr int kRowsMaxThreads = 256;

// One level's record for a warp of lane width W: brick entries (cos, s_lo)
// as float2 [W/2 + 1][32 lanes], one word of absent bits per lane, then
// the level's mode (and 3 words of padding to 16 bytes).
// Lane t's entry i joins wires lo = t*W + 2i - p and lo + 1 at a level of
// parity p: at p = 0 its pairs (2i, 2i+1), i < W/2; at p = 1 entry 0 is
// the pair across its left edge, entries 1..W/2-1 its pairs (2i-1, 2i) and
// entry W/2 the pair across its right edge (both lanes of a crossing pair
// hold the entry).  A block streams the records kStage levels a chunk
// through a ring of kRing chunks in shared memory, one bulk copy a chunk
// completing on the chunk slot's mbarrier (after the ring).
template <int W>
struct RowsShape {
  static constexpr int kEntries = W / 2 + 1;
  static constexpr int kMode = kEntries * 64 + 32;       // the mode word
  static constexpr int kRecord = kMode + 4;              // floats a level
  static constexpr int kStage = 128 / W;                 // levels a chunk
  static constexpr int kRing = 4;                        // chunks in flight
  static constexpr int kRingFloats = kRing * kStage * kRecord;
  static constexpr size_t kSmem =
      kRingFloats * sizeof(float) + kRing * sizeof(uint64_t);
};

// 16 bytes, or 16 zero bytes where !full (src is not read then)
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool full) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = full ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar), "r"(bytes) : "memory");
}

// Wait until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// `bytes` (a multiple of 16, both ends 16-byte aligned) from global into
// shared memory by the TMA unit, completing on `bar`
__device__ __forceinline__ void bulk_copy(unsigned dst, const void* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The layout's record plan (kernels/mesh_apply.py::rows_plan), per stored
// level kPlan int32: a code per brick entry [W/2 + 1][32] — the slot of
// its phase (bits 0-23), its wire's sign (bits 24-25: 0, +1, -1) and bit
// 26 set where the entry holds a wire at all — then the absent word of
// each lane and the level's mode.
template <int W>
struct PlanShape {
  static constexpr int kCodes = RowsShape<W>::kEntries * 32;
  static constexpr int kPlan = kCodes + 33;
};

// The prologue: every record of every stack entry, stored level order;
// grid (levels / 8, S), a warp a level, a lane its entries, in the
// arithmetic of build_trig: an entry with a wire gets sign != 0 ? cos(ph)
// : 1 and sign*sin(ph) (negated when transposed) — a pair's lower wire's,
// or the unpaired wires' 1 and +-0 — and entries past the wires (1, 0);
// the absent word and the mode are copied from the plan.
template <int W>
__global__ void __launch_bounds__(256)
mesh_trig_kernel(const float* __restrict__ phases,
                 const int* __restrict__ plan, float* __restrict__ table,
                 int levels, int slots, int transpose) {
  using Plan = PlanShape<W>;
  const int cl = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const size_t s = blockIdx.y;
  if (cl >= levels) return;
  const float* ph = phases + (s * levels + cl) * slots;
  const int* code = plan + static_cast<size_t>(cl) * Plan::kPlan;
  float* rec = table + (s * levels + cl) * RowsShape<W>::kRecord;
  float2* ent = reinterpret_cast<float2*>(rec);
#pragma unroll 1
  for (int i = 0; i < RowsShape<W>::kEntries; ++i) {
    const int q = code[i * 32 + lane];
    float c = 1.0f, sn = 0.0f;
    if (q & (1 << 26)) {
      const int sc = (q >> 24) & 3;
      const float sg = sc == 0 ? 0.0f : (sc == 1 ? 1.0f : -1.0f);
      const float v = ph[q & 0xffffff];
      c = sg != 0.0f ? cosf(v) : 1.0f;
      sn = __fmul_rn(sg, sinf(v));
      if (transpose) sn = -sn;
    }
    ent[i * 32 + lane] = make_float2(c, sn);
  }
  reinterpret_cast<int*>(rec)[RowsShape<W>::kEntries * 64 + lane] =
      code[Plan::kCodes + lane];
  if (lane < 4)
    reinterpret_cast<int*>(rec + RowsShape<W>::kMode)[lane] =
        lane == 0 ? code[Plan::kCodes + 32] : 0;
}

// y = c*x + s*partner for the lower wire of a pair, c*x - s*partner for
// the upper: the plain version's c*x + (sign*sin)*x[perm], whose upper
// sine is exactly -s_lo.  An absent entry's wires are unpaired: partner is
// the wire itself and both take +s.
__device__ __forceinline__ float rot_lo(float c, float s, float x, float q) {
  return __fadd_rn(__fmul_rn(c, x), __fmul_rn(s, q));
}

__device__ __forceinline__ float rot_hi(float c, float s, float x, float q) {
  return __fsub_rn(__fmul_rn(c, x), __fmul_rn(s, q));
}

// A pair of a lane's own wires on R rows; with kPartial an absent entry
// leaves both wires unpaired.
template <int W, int R, bool kPartial>
__device__ __forceinline__ void rows_pair(float (&v)[R][W], int j, float2 e,
                                          bool ab) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float lo = v[r][j], hi = v[r][j + 1];
    if (kPartial && ab) {
      v[r][j] = rot_lo(e.x, e.y, lo, lo);
      v[r][j + 1] = rot_lo(e.x, e.y, hi, hi);
    } else {
      v[r][j] = rot_lo(e.x, e.y, lo, hi);
      v[r][j + 1] = rot_hi(e.x, e.y, hi, lo);
    }
  }
}

// A level of parity 0: pairs (2i, 2i+1), none across lanes.
template <int W, int R, bool kPartial>
__device__ __forceinline__ void rows_even(float (&v)[R][W],
                                          const float2* __restrict__ ent,
                                          unsigned absent, int lane) {
#pragma unroll
  for (int i = 0; i < W / 2; ++i)
    rows_pair<W, R, kPartial>(v, 2 * i, ent[i * 32 + lane],
                              (absent >> i) & 1u);
}

// A level of parity 1: pairs (2i-1, 2i) inside the lane, and its wires 0
// and W-1 paired across its edges, one shuffle each way.  Full levels take
// no select: their only unpaired wires are wire 0, whose left partner lane
// 0 replaces by -x[0] (so rot_hi gives x + s*x), and wire P-1 where it
// ends a lane (`last`), whose right partner becomes x[W-1].
template <int W, int R, bool kPartial>
__device__ __forceinline__ void rows_odd(float (&v)[R][W],
                                         const float2* __restrict__ ent,
                                         unsigned absent, int lane,
                                         bool first, bool last) {
  constexpr int H = W / 2;
  float left[R], right[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    left[r] = __shfl_up_sync(kFullMask, v[r][W - 1], 1);
    right[r] = __shfl_down_sync(kFullMask, v[r][0], 1);
  }
  const float2 e0 = ent[lane];
  const bool ab0 = absent & 1u;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float x0 = v[r][0];
    if (!kPartial)
      v[r][0] = rot_hi(e0.x, e0.y, x0, first ? -x0 : left[r]);
    else
      v[r][0] = ab0 ? rot_lo(e0.x, e0.y, x0, x0)
                    : rot_hi(e0.x, e0.y, x0, left[r]);
  }
#pragma unroll
  for (int i = 1; i < H; ++i)
    rows_pair<W, R, kPartial>(v, 2 * i - 1, ent[i * 32 + lane],
                              (absent >> i) & 1u);
  const float2 eh = ent[H * 32 + lane];
  const bool self = kPartial ? ((absent >> H) & 1u) != 0 : last;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float xl = v[r][W - 1];
    v[r][W - 1] = rot_lo(eh.x, eh.y, xl, self ? xl : right[r]);
  }
}

// One level on the R rows of a warp.  mode: bit 0 the level's parity, bit
// 1 "partial": some entry is absent where the lane-edge substitution of
// rows_odd cannot stand in for it, so each pair selects.
template <int W, int R>
__device__ __forceinline__ void rows_level(float (&v)[R][W],
                                           const float2* __restrict__ ent,
                                           unsigned absent, int mode,
                                           int lane, bool first, bool last) {
  switch (mode & 3) {
    case 0: rows_even<W, R, false>(v, ent, absent, lane); break;
    case 2: rows_even<W, R, true>(v, ent, absent, lane); break;
    case 1: rows_odd<W, R, false>(v, ent, absent, lane, first, last); break;
    default: rows_odd<W, R, true>(v, ent, absent, lane, first, last);
  }
}

// Route A: grid (row tiles of warps*R rows, S), blockDim = 32*warps.  x:
// rows of entry s at x + s*x_stride_s, or with `identity` the rows e_r of
// the P x P identity (batch = P).  table: the prologue's records (S,
// levels, kRecord).  The blocks of one stack entry are adjacent in the
// grid, so they run together and read its records from L2.  Thread 0
// stages every chunk with one bulk copy (a chunk's records are adjacent
// in the table; a transposed mesh reads them in reverse); the others only
// wait on the chunk's barrier.
template <int W, int R>
__global__ void __launch_bounds__(kRowsMaxThreads)
mesh_rows_kernel(const float* __restrict__ x, const float* __restrict__ table,
                 const float* __restrict__ diag, float* __restrict__ y,
                 int batch, int ports, int levels, int64_t x_stride_s,
                 int64_t diag_stride_s, int transpose, int identity) {
  using Shape = RowsShape<W>;
  extern __shared__ float4 rows_smem[];       // the ring, then its barriers
  float* smem = reinterpret_cast<float*>(rows_smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Shape::kRingFloats);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const size_t s = blockIdx.y;
  const bool tr = transpose != 0;
  const int row0 = (blockIdx.x * warps + warp) * R;
  const float* dg = diag + s * diag_stride_s;
  const float* tab = table + s * levels * Shape::kRecord;
  const int chunks = (levels + Shape::kStage - 1) / Shape::kStage;

  // chunk k: application levels [k*kStage, k*kStage + n), stored levels
  // [cl0, cl0 + n) into ring slot k % kRing (thread 0)
  auto stage = [&](int k) {
    if (k >= chunks) return;
    const int first = k * Shape::kStage;
    const int n = min(Shape::kStage, levels - first);
    const int cl0 = tr ? levels - first - n : first;
    const unsigned bar = smem_u32(full + k % Shape::kRing);
    const unsigned bytes = n * Shape::kRecord * sizeof(float);
    mbar_expect_tx(bar, bytes);
    bulk_copy(smem_u32(smem + (k % Shape::kRing) * Shape::kStage *
                                  Shape::kRecord),
              tab + static_cast<size_t>(cl0) * Shape::kRecord, bytes, bar);
  };
  if (threadIdx.x == 0) {
    for (int j = 0; j < Shape::kRing; ++j) mbar_init(smem_u32(full + j), 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int k = 0; k < Shape::kRing - 1; ++k) stage(k);

  float v[R][W];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + r;
    const float* xr = x + s * x_stride_s + static_cast<size_t>(row) * ports;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const int w = lane * W + j;
      float val = 0.0f;
      if (row < batch && w < ports) {
        val = identity ? (w == row ? 1.0f : 0.0f) : xr[w];
        if (!tr) val = __fmul_rn(val, dg[w]);
      }
      v[r][j] = val;
    }
  }

  const bool first = lane == 0;
  const bool last = ports % W == 0 && lane == ports / W - 1;
#pragma unroll 1
  for (int k = 0; k < chunks; ++k) {
    // every warp is done with chunk k - 1, so its slot takes chunk
    // k + kRing - 1; then chunk k has landed
    __syncthreads();
    if (threadIdx.x == 0) stage(k + Shape::kRing - 1);
    mbar_wait(smem_u32(full + k % Shape::kRing), (k / Shape::kRing) & 1);
    const float* cur =
        smem + (k % Shape::kRing) * Shape::kStage * Shape::kRecord;
    const int n = min(Shape::kStage, levels - k * Shape::kStage);
#pragma unroll 1
    for (int lv = 0; lv < n; ++lv) {
      const float* rec = cur + (tr ? n - 1 - lv : lv) * Shape::kRecord;
      rows_level<W, R>(
          v, reinterpret_cast<const float2*>(rec),
          reinterpret_cast<const unsigned*>(rec + Shape::kEntries * 64)[lane],
          reinterpret_cast<const int*>(rec + Shape::kMode)[0], lane, first,
          last);
    }
  }

  float* ys = y + s * batch * ports;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + r;
    if (row >= batch) continue;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const int w = lane * W + j;
      if (w < ports)
        ys[static_cast<size_t>(row) * ports + w] =
            tr ? __fmul_rn(v[r][j], dg[w]) : v[r][j];
    }
  }
}

template <int W, int R>
int rows_launch(const float* x, const float* phases, const int* plan,
                const float* diag, float* y, float* table, int batch,
                int ports, int levels, int slots, int stack, int warps,
                int64_t x_stride_s, int64_t diag_stride_s, int transpose,
                int identity, cudaStream_t stream) {
  mesh_trig_kernel<W><<<dim3((levels + 7) / 8, stack), 256, 0, stream>>>(
      phases, plan, table, levels, slots, transpose);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(mesh_rows_kernel<W, R>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(RowsShape<W>::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((batch + warps * R - 1) / (warps * R), stack);
  mesh_rows_kernel<W, R><<<grid, 32 * warps, RowsShape<W>::kSmem, stream>>>(
      x, table, diag, y, batch, ports, levels, x_stride_s, diag_stride_s,
      transpose, identity);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------ warp rows backward
//
// The backward of route A (port-only, as the resident backward; the JAX
// package differentiates its jnp gather scan), and the dense backward's
// walk on M's identity rows (y := M, dy := dM, no dx): from the forward's
// output y and the gradient dy there, (S, batch, ports), dx (S, batch,
// ports) and dphases (S, levels, slots).  The arithmetic of
// reverse_levels in route A's register layout: a warp holds R rows of y
// and of the gradient g, lane t wires [t*W, (t+1)*W).
//   A level is orthogonal, so its inverse is its transpose, and both the
//   state recovery (x from y) and the gradient carry (g <- M^T g) are the
//   forward's level with the opposite transpose: route A's level function
//   (rows_level) on the records mesh_trig_kernel writes with !transpose,
//   walked in the order a forward with !transpose walks.  So y and g are
//   the plain version's bits level by level (c*y - s*q and c*y + (-s)*q
//   round alike).
//   The phase term of a pair (lo, hi) is taken before the level is undone,
//   from its output: with the forward's record (c, s), s = t*sign_lo*sin
//   phi (t = -1 transposed), d y_lo / d phi = q*y_hi and d y_hi / d phi =
//   -q*y_lo, q = t*sign_lo.  So the pair adds q*(g_lo*y_hi - g_hi*y_lo),
//   summed over the warp's R rows in registers (each pair of a level is
//   owned by one lane: at parity 1 the pair across a lane's right edge by
//   that lane, through one shuffle of y and one of g), then over the
//   block's warps in warp order through shared memory: each warp writes
//   its terms for every level of a chunk of the record ring (kStage
//   levels), to one of two buffers; while the warps walk chunk k, thread
//   q of the block sums slot q of chunk k - 1 at its kStage levels at once
//   (their loads in flight together), reading the word of the slot's term
//   and its sign from the layout's slot map (kernels/mesh_apply.py::
//   grad_slot_map; staged beside the records, one bulk copy each a
//   chunk), and writes the block's sum, or 0 for a slot no pair holds, to
//   its column's partials.  So the warps meet once a chunk, at the ring's
//   barrier, not once a level.  A warp's term of entry (i, lane) lies at
//   word i*32 + (lane ^ ((64/W)*i mod 32)) (term_word), so that the 32
//   slots a warp of the sum reads (a lane's W/2 pairs, then the next
//   lanes') fall in 32 banks, not W/2 to a bank.  No float atomics:
//   mesh_grad_sum_kernel adds the columns in order, so two calls give the
//   same bits.
// The diag as in mesh_apply_grad_kernel: transposed (D last), the walk
// starts from y / D and dy * D; otherwise dx = g * D at the end.
//
// A warp holds y and g of its R rows as one array of 2R rows, so that one
// call of route A's level function undoes a level on both.  Grid
// (columns, S): block x takes rows [x*warps*R, (x+1)*warps*R) of entry
// s, so each column writes its partials (levels x slots floats of every
// entry) once, not once a row tile.  Registers and shared memory bound
// the block (RowsGradShape).
// Bound: per element and level 3 operations to recover the state and 3
// for the gradient, 4 a pair and row for the phase term (two products, a
// difference and the add over the rows; q is applied once a slot), at the
// issue rate; the partials (columns x S x levels x slots floats) are written
// once and read once by the sum.

constexpr int kMapNeg = 1 << 16;   // slot map: the pair's lower wire has
                                   // sign -1 (bits 0-15: its term's word)

// Registers bound the block (y and g of R rows, 2*R*W a thread): 256
// threads from W*R = 32 (255 registers each), else 512; shared memory
// holds the terms of 8 warps at W = 32 and 16 (kernels/mesh_apply.py::
// grad_rows_config).  The ring holds kRing chunks of records and slot
// map: chunk k is walked while k + 1 lands and chunk k - 1's terms are
// summed.
template <int W, int R>
struct RowsGradShape {
  static constexpr int kMaxThreads = W * R >= 32 ? 256 : 512;
  static constexpr int kTerms = RowsShape<W>::kEntries * 32;  // a warp's
  static constexpr int kRing = 3;
  static constexpr int kRingFloats =
      kRing * RowsShape<W>::kStage * RowsShape<W>::kRecord;
};

// Where a warp's term of entry (i, lane) lies in its level's row of kTerms
// words: i*32 + (lane ^ ((64/W)*i mod 32)), so that the 32 slots a warp of
// the sum reads (a lane's W/2 pairs, then the next lanes') fall in 32
// banks.  The slot map names this word (kernels/mesh_apply.py::
// grad_slot_map).
template <int W>
__device__ __forceinline__ int term_word(int i, int lane) {
  return i * 32 + (lane ^ (((64 / W) * i) & 31));
}

// st: the walk's rows, y in rows 0..R-1 and g in rows R..2R-1
template <int W, int R>
__device__ __forceinline__ float pair_term(const float (&st)[2 * R][W],
                                           int lo, int hi) {
  float acc = __fsub_rn(__fmul_rn(st[R][lo], st[0][hi]),
                        __fmul_rn(st[R][hi], st[0][lo]));
#pragma unroll
  for (int r = 1; r < R; ++r)
    acc = __fadd_rn(acc, __fsub_rn(__fmul_rn(st[R + r][lo], st[r][hi]),
                                   __fmul_rn(st[R + r][hi], st[r][lo])));
  return acc;
}

// The unsigned phase terms g_lo*y_hi - g_hi*y_lo of the pairs a lane owns
// at one level, summed over the warp's R rows, into entry (i, lane) of out
// (at term_word): at
// parity 0 entries 0..W/2-1 (pairs (2i, 2i+1)), at parity 1 entries
// 1..W/2 (pairs (2i-1, 2i), and entry W/2 the pair (W-1, the right lane's
// wire 0)).  Entries that are no pair get a term nothing reads.
template <int W, int R>
__device__ __forceinline__ void rows_terms(const float (&st)[2 * R][W],
                                           int parity, int lane,
                                           float* __restrict__ out) {
  constexpr int H = W / 2;
  if (parity == 0) {
#pragma unroll
    for (int i = 0; i < H; ++i)
      out[term_word<W>(i, lane)] = pair_term<W, R>(st, 2 * i, 2 * i + 1);
    return;
  }
#pragma unroll
  for (int i = 1; i < H; ++i)
    out[term_word<W>(i, lane)] = pair_term<W, R>(st, 2 * i - 1, 2 * i);
  float acc = 0.0f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float yh = __shfl_down_sync(kFullMask, st[r][0], 1);
    const float gh = __shfl_down_sync(kFullMask, st[R + r][0], 1);
    const float t = __fsub_rn(__fmul_rn(st[R + r][W - 1], yh),
                              __fmul_rn(gh, st[r][W - 1]));
    acc = r == 0 ? t : __fadd_rn(acc, t);
  }
  out[term_word<W>(H, lane)] = acc;
}

// table: the records of mesh_trig_kernel with !transpose (S, levels,
// kRecord); smap: the slot map (levels, map_stride) int32; part: this
// call's partials (gridDim.x, S, levels, slots), or dphases itself with
// one column, or null (no dphases asked for); dx: (S, batch, ports) or
// null.
template <int W, int R>
__global__ void __launch_bounds__(RowsGradShape<W, R>::kMaxThreads)
mesh_rows_grad_kernel(const float* __restrict__ y,
                      const float* __restrict__ dy,
                      const float* __restrict__ table,
                      const int* __restrict__ smap,
                      const float* __restrict__ diag, float* __restrict__ dx,
                      float* __restrict__ part, int batch, int ports,
                      int levels, int slots, int map_stride,
                      int64_t diag_stride_s, int transpose) {
  using Shape = RowsShape<W>;
  using GShape = RowsGradShape<W, R>;
  constexpr int kTerms = GShape::kTerms, kRing = GShape::kRing;
  // the record ring, the slot-map ring, two buffers of a chunk's terms
  // ([kStage levels][warps][kTerms] each), then the ring's barriers
  extern __shared__ float4 grad_rows_smem[];
  float* smem = reinterpret_cast<float*>(grad_rows_smem);
  const bool phase = part != nullptr;
  const int warps = blockDim.x >> 5;
  const int map_chunk = Shape::kStage * map_stride;
  const int chunk_terms = Shape::kStage * warps * kTerms;
  int* mring = reinterpret_cast<int*>(smem + GShape::kRingFloats);
  float* terms = reinterpret_cast<float*>(
      mring + (phase ? kRing * map_chunk : 0));
  uint64_t* full = reinterpret_cast<uint64_t*>(
      terms + (phase ? 2 * chunk_terms : 0));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t s = blockIdx.y;
  const bool tr = transpose != 0;
  const bool rev = !tr;              // the walk's order: a !tr forward's
  const int row0 = (blockIdx.x * warps + warp) * R;
  const float* dg = diag + s * diag_stride_s;
  const float* tab = table + s * levels * Shape::kRecord;
  const int chunks = (levels + Shape::kStage - 1) / Shape::kStage;
  // chunks staged ahead of the one walked: with dphases, chunk k - 1's
  // map slot is still read while chunk k is walked
  const int ahead = phase ? kRing - 2 : kRing - 1;

  auto chunk_n = [&](int k) {
    return min(Shape::kStage, levels - k * Shape::kStage);
  };
  auto chunk_cl0 = [&](int k) {
    return rev ? levels - k * Shape::kStage - chunk_n(k) : k * Shape::kStage;
  };
  auto stage = [&](int k) {
    if (k >= chunks) return;
    const int n = chunk_n(k);
    const int cl0 = chunk_cl0(k);
    const unsigned bar = smem_u32(full + k % kRing);
    const unsigned rbytes = n * Shape::kRecord * sizeof(float);
    const unsigned mbytes = phase ? n * map_stride * sizeof(int) : 0;
    mbar_expect_tx(bar, rbytes + mbytes);
    bulk_copy(smem_u32(smem + (k % kRing) * Shape::kStage * Shape::kRecord),
              tab + static_cast<size_t>(cl0) * Shape::kRecord, rbytes, bar);
    if (phase)
      bulk_copy(smem_u32(mring + (k % kRing) * map_chunk),
                smap + static_cast<size_t>(cl0) * map_stride, mbytes, bar);
  };
  if (threadIdx.x == 0) {
    for (int j = 0; j < kRing; ++j) mbar_init(smem_u32(full + j), 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int k = 0; k < ahead; ++k) stage(k);

  // the levels' output and its gradient, one array so that one level
  // function takes both (y in rows 0..R-1, g in R..2R-1): y, dy;
  // transposed y / D, dy * D
  float v[2 * R][W];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + r;
    const size_t base = (s * batch + row) * static_cast<size_t>(ports);
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const int w = lane * W + j;
      float a = 0.0f, b = 0.0f;
      if (row < batch && w < ports) {
        a = y[base + w];
        b = dy[base + w];
        if (tr) {
          a = __fdiv_rn(a, dg[w]);
          b = __fmul_rn(b, dg[w]);
        }
      }
      v[r][j] = a;
      v[R + r][j] = b;
    }
  }

  const bool first = lane == 0;
  const bool last = ports % W == 0 && lane == ports / W - 1;
  float* dst = phase ? part + (static_cast<size_t>(blockIdx.x) * gridDim.y +
                               s) * levels * slots
                     : nullptr;
  // chunk k's sums: thread q takes slots q and q + blockDim.x (kQ of
  // them, kQ * kStage sums in all) at each of the chunk's levels at once
  // (their loads in flight together), each summed over the warps in warp
  // order, from the terms buffer k % 2; a slot no pair holds reads word 0
  // and writes 0
  constexpr int kQ = Shape::kStage <= 4 ? 2 : 1, kN = kQ * Shape::kStage;
  auto sum_chunk = [&](int k) {
    const int n = chunk_n(k);
    const int* cmap = mring + (k % kRing) * map_chunk;
    const float* tb = terms + (k & 1) * chunk_terms;
    float* out = dst + static_cast<size_t>(chunk_cl0(k)) * slots;
    for (int q0 = threadIdx.x; q0 < slots; q0 += kQ * blockDim.x) {
      int m[kN], word[kN];
      float acc[kN];
#pragma unroll
      for (int i = 0; i < kN; ++i) {
        const int j = i % Shape::kStage;
        const int q = q0 + (i / Shape::kStage) * blockDim.x;
        m[i] = j < n && q < slots ? cmap[j * map_stride + q] : -1;
        word[i] = j * warps * kTerms + (m[i] < 0 ? 0 : m[i] & (kMapNeg - 1));
        acc[i] = tb[word[i]];
      }
      for (int w = 1; w < warps; ++w) {
#pragma unroll
        for (int i = 0; i < kN; ++i)
          acc[i] = __fadd_rn(acc[i], tb[word[i] + w * kTerms]);
      }
#pragma unroll
      for (int i = 0; i < kN; ++i) {
        const int j = i % Shape::kStage;
        const int q = q0 + (i / Shape::kStage) * blockDim.x;
        if (j < n && q < slots)
          out[static_cast<size_t>(j) * slots + q] =
              m[i] < 0 ? 0.0f
                       : (((m[i] & kMapNeg) != 0) != tr ? -acc[i] : acc[i]);
      }
    }
  };
#pragma unroll 1
  for (int k = 0; k < chunks; ++k) {
    // every warp has walked chunk k - 1 (its terms are in) and summed
    // chunk k - 2 (its terms buffer and ring slot are free)
    __syncthreads();
    if (threadIdx.x == 0) stage(k + ahead);
    mbar_wait(smem_u32(full + k % kRing), (k / kRing) & 1);
    const float* cur = smem + (k % kRing) * Shape::kStage * Shape::kRecord;
    const int n = chunk_n(k);
    float* tb = terms + (k & 1) * chunk_terms;
#pragma unroll 1
    for (int lv = 0; lv < n; ++lv) {
      const int idx = rev ? n - 1 - lv : lv;
      const float* rec = cur + idx * Shape::kRecord;
      const float2* ent = reinterpret_cast<const float2*>(rec);
      const unsigned absent =
          reinterpret_cast<const unsigned*>(rec + Shape::kEntries * 64)[lane];
      const int mode = reinterpret_cast<const int*>(rec + Shape::kMode)[0];
      if (phase)
        rows_terms<W, R>(v, mode & 1, lane,
                         tb + (idx * warps + warp) * kTerms);
      rows_level<W, 2 * R>(v, ent, absent, mode, lane, first, last);
    }
    if (phase && k > 0) sum_chunk(k - 1);
  }
  if (phase) {
    __syncthreads();
    sum_chunk(chunks - 1);
  }

  if (dx == nullptr) return;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + r;
    if (row >= batch) continue;
    float* dr = dx + (s * batch + row) * static_cast<size_t>(ports);
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const int w = lane * W + j;
      if (w < ports)
        dr[w] = tr ? v[R + r][j] : __fmul_rn(v[R + r][j], dg[w]);
    }
  }
}

template <int W, int R>
size_t rows_grad_smem(int warps, int map_stride, bool phase) {
  using Shape = RowsShape<W>;
  using GShape = RowsGradShape<W, R>;
  return GShape::kRingFloats * sizeof(float) +
         (phase ? static_cast<size_t>(Shape::kStage) *
                      (GShape::kRing * map_stride +
                       2 * static_cast<size_t>(warps) * GShape::kTerms) *
                      sizeof(float)
                : 0) +
         GShape::kRing * sizeof(uint64_t);
}

template <int W, int R>
int rows_grad_launch(const float* y, const float* dy, const float* phases,
                     const int* plan, const int* smap, int map_stride,
                     const float* diag, float* dx, float* dph, float* part,
                     float* table, int batch, int ports, int levels,
                     int slots, int stack, int warps, int blocks_x,
                     int64_t diag_stride_s, int transpose,
                     cudaStream_t stream) {
  if (32 * warps > RowsGradShape<W, R>::kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool phase = dph != nullptr;
  mesh_trig_kernel<W><<<dim3((levels + 7) / 8, stack), 256, 0, stream>>>(
      phases, plan, table, levels, slots, !transpose);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = rows_grad_smem<W, R>(warps, map_stride, phase);
  err = cudaFuncSetAttribute(mesh_rows_grad_kernel<W, R>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  float* target = !phase ? nullptr : (blocks_x > 1 ? part : dph);
  mesh_rows_grad_kernel<W, R>
      <<<dim3(blocks_x, stack), 32 * warps, smem, stream>>>(
          y, dy, table, smap, diag, dx, target, batch, ports, levels, slots,
          map_stride, diag_stride_s, transpose);
  err = cudaGetLastError();
  if (err != cudaSuccess || !phase || blocks_x == 1)
    return static_cast<int>(err);
  const int64_t count = static_cast<int64_t>(stack) * levels * slots;
  const int blocks = static_cast<int>(
      std::min<int64_t>((count + kThreads - 1) / kThreads, 1024));
  mesh_grad_sum_kernel<<<blocks, kThreads, 0, stream>>>(part, dph, blocks_x,
                                                        count);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------------ dense
//
// C_s = op(A_s) * op(B_s), (m x k) * (k x n), in 3xTF32 on the tensor
// cores: block tile 128 x 128 of C, k tiles of 32, 8 warps of 64 x 32 each
// (4 x 4 mma tiles of 16 x 8), two cp.async stages.  A is stored (m, k)
// row-major, or with kTA (k, m); B (k, n), or with kTB (n, k).  Route B's
// forward is the plain case, y_s = x_s * M_s; the dense backward's two
// products read one operand transposed: dx_s = dy_s * M_s^T (kTB) and
// dM_s = x_s^T * dy_s (kTA).  Each operand's tile is staged in the layout
// it has in memory, so every copy is 16 contiguous bytes: a row-major
// (rows, k) tile with rows of 36 floats, a (k, cols) tile with rows of
// 136; both strides make the fragment loads of a warp hit 32 distinct
// banks.  The k tiles may be split (`splits` ranges of `per_split` tiles
// each): split z writes its own (S, m, n) partial, which
// mesh_grad_sum_kernel adds in split order (no float atomics: two calls
// give the same bits), so a product with few output tiles and a long k
// still fills the card.  The dense backward launches its two products as
// one grid (mesh_product_grad_kernel): at 1024 ports on 4300 rows, dx's
// 272 tiles and dM's 64 tiles split 4 ways fill 4 waves of 132 blocks
// (one block an SM), not 3 and 2.
// Bound of the dense backward: the two products' 3 x 2*S*B*P^2 TF32 FLOPs
// each at 495 TFLOP/s, plus the warp-rows walk's operations on M's P
// rows at the issue rate (chip_smoke._apply_grad_bound): 0.37 ms at 1024
// ports on 4300 rows, against the row walk's 1.08.
constexpr int kDenseBM = 128, kDenseBN = 128, kDenseBK = 32;
constexpr int kDenseThreads = 256;
constexpr int kDenseAStride = kDenseBK + 4;
constexpr int kDenseBStride = kDenseBN + 8;

template <bool kTA, bool kTB>
struct ProductShape {
  static constexpr int kA = kTA ? kDenseBK * kDenseBStride
                                : kDenseBM * kDenseAStride;
  static constexpr int kB = kTB ? kDenseBN * kDenseAStride
                                : kDenseBK * kDenseBStride;
  static constexpr int kStage = kA + kB;
  static constexpr size_t kSmem = 2 * kStage * sizeof(float);
};

__device__ __forceinline__ unsigned to_tf32(float f) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(f));
  return r;
}

// a = hi + lo to 2^-22 of |a|, hi and lo TF32 values
__device__ __forceinline__ void split_tf32(float a, unsigned& hi,
                                           unsigned& lo) {
  hi = to_tf32(a);
  lo = to_tf32(__fsub_rn(a, __uint_as_float(hi)));
}

// d += a * b, m16n8k8, TF32 inputs, f32 accumulators
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One product c = op(a) * op(b), (m x k) * (k x n), of S stacked entries,
// its k tiles split `splits` ways: entry s reads A at a + s*a_stride_s, B
// at b + s*b_stride_s and writes split z's C at c + z*split_stride +
// s*c_stride_s; split z takes k tiles [z * per_split, +per_split).  Each
// operand's contiguous dimension is a multiple of 4, so a 16-byte copy is
// wholly inside a row or wholly past it (zero-filled), and n is even
// (float2 stores).
struct Product {
  const float* a;
  const float* b;
  float* c;
  int m, n, k, splits, per_split;
  int64_t a_stride_s, b_stride_s, c_stride_s, split_stride;
};

// One block's tile of product p: column tile bx, row tile by, bz = entry *
// splits + split; smem holds 2 stages of ProductShape<kTA, kTB>.
template <bool kTA, bool kTB>
__device__ __forceinline__ void product_tile(const Product& p, int bx, int by,
                                             int bz, float* smem) {
  using Shape = ProductShape<kTA, kTB>;
  const int m_dim = p.m, n_dim = p.n, k_dim = p.k, per_split = p.per_split;
  const size_t s = bz / p.splits;
  const int split = bz % p.splits;
  const int row0 = by * kDenseBM, col0 = bx * kDenseBN;
  const float* __restrict__ as_g = p.a + s * p.a_stride_s;
  const float* __restrict__ bs_g = p.b + s * p.b_stride_s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, t = lane & 3;

  // one tile of `rows` x `cols` floats of a row-major (rows_dim,
  // cols_dim) operand from (r0, c0) into dst rows of `stride` floats
  auto tile = [&](float* dst, const float* src, int rows, int cols,
                  int stride, int r0, int c0, int rows_dim, int cols_dim) {
    for (int q = tid; q < rows * cols / 4; q += kDenseThreads) {
      const int r = q / (cols / 4), cc = 4 * (q % (cols / 4));
      const int row = r0 + r, col = c0 + cc;
      const bool ok = row < rows_dim && col < cols_dim;
      cp_async16_zfill(dst + r * stride + cc,
                       ok ? src + static_cast<size_t>(row) * cols_dim + col
                          : src,
                       ok);
    }
  };
  auto load = [&](int kt, float* buf) {
    const int k0 = kt * kDenseBK;
    if (kTA)
      tile(buf, as_g, kDenseBK, kDenseBM, kDenseBStride, k0, row0, k_dim,
           m_dim);
    else
      tile(buf, as_g, kDenseBM, kDenseBK, kDenseAStride, row0, k0, m_dim,
           k_dim);
    if (kTB)
      tile(buf + Shape::kA, bs_g, kDenseBN, kDenseBK, kDenseAStride, col0,
           k0, n_dim, k_dim);
    else
      tile(buf + Shape::kA, bs_g, kDenseBK, kDenseBN, kDenseBStride, k0,
           col0, k_dim, n_dim);
    cp_async_commit();
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  const int ktiles = (k_dim + kDenseBK - 1) / kDenseBK;
  const int kt0 = split * per_split;
  const int kt1 = min(ktiles, kt0 + per_split);
  if (kt0 < kt1) load(kt0, smem);
#pragma unroll 1
  for (int kt = kt0; kt < kt1; ++kt) {
    cp_async_wait_all();
    __syncthreads();                 // tile kt in; tile kt - 1 consumed
    const int st = (kt - kt0) & 1;
    if (kt + 1 < kt1) load(kt + 1, smem + (st ^ 1) * Shape::kStage);
    const float* as = smem + st * Shape::kStage;
    const float* bs = as + Shape::kA;
#pragma unroll
    for (int k8 = 0; k8 < kDenseBK; k8 += 8) {
      unsigned bh[4][2], bl[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = wn * 32 + nt * 8 + g;
        if (kTB) {
          const float* bp = bs + n * kDenseAStride + k8 + t;
          split_tf32(bp[0], bh[nt][0], bl[nt][0]);                // (t, g)
          split_tf32(bp[4], bh[nt][1], bl[nt][1]);                // (t+4, g)
        } else {
          const float* bp = bs + (k8 + t) * kDenseBStride + n;
          split_tf32(bp[0], bh[nt][0], bl[nt][0]);                // (t, g)
          split_tf32(bp[4 * kDenseBStride], bh[nt][1], bl[nt][1]); // (t+4, g)
        }
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int m = wm * 64 + mt * 16 + g;
        unsigned ah[4], al[4];
        if (kTA) {
          const float* ap = as + (k8 + t) * kDenseBStride + m;
          split_tf32(ap[0], ah[0], al[0]);                         // (g, t)
          split_tf32(ap[8], ah[1], al[1]);                         // (g+8, t)
          split_tf32(ap[4 * kDenseBStride], ah[2], al[2]);         // (g, t+4)
          split_tf32(ap[4 * kDenseBStride + 8], ah[3], al[3]);     // (g+8, t+4)
        } else {
          const float* ap = as + m * kDenseAStride + k8 + t;
          split_tf32(ap[0], ah[0], al[0]);                         // (g, t)
          split_tf32(ap[8 * kDenseAStride], ah[1], al[1]);         // (g+8, t)
          split_tf32(ap[4], ah[2], al[2]);                         // (g, t+4)
          split_tf32(ap[8 * kDenseAStride + 4], ah[3], al[3]);     // (g+8, t+4)
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          mma_tf32(acc[mt][nt], al, bh[nt]);
          mma_tf32(acc[mt][nt], ah, bl[nt]);
          mma_tf32(acc[mt][nt], ah, bh[nt]);
        }
      }
    }
  }

  float* cs = p.c + split * p.split_stride + s * p.c_stride_s;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    const int row = row0 + wm * 64 + mt * 16 + g;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = col0 + wn * 32 + nt * 8 + 2 * t;
      if (col >= n_dim) continue;
      if (row < m_dim)
        *reinterpret_cast<float2*>(cs + static_cast<size_t>(row) * n_dim +
                                   col) =
            make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      if (row + 8 < m_dim)
        *reinterpret_cast<float2*>(cs + static_cast<size_t>(row + 8) * n_dim +
                                   col) =
            make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
  }
}

// Route B's product: grid (column tiles, row tiles, S).
__global__ void __launch_bounds__(kDenseThreads)
mesh_product_kernel(const Product p) {
  extern __shared__ float4 dense_smem[];          // 2 stages of A and B
  product_tile<false, false>(p, blockIdx.x, blockIdx.y, blockIdx.z,
                             reinterpret_cast<float*>(dense_smem));
}

// The dense backward's two products in one launch, so that their blocks
// share the card's waves: blocks [0, dx_blocks) take the tiles of dx =
// dy * M^T (B reads M transposed), the rest those of dM = x^T * dy (A
// reads x transposed), each in column-tile, row-tile, entry-split order.
__global__ void __launch_bounds__(kDenseThreads)
mesh_product_grad_kernel(const Product dx, const Product dm, int dx_blocks) {
  extern __shared__ float4 dense_smem[];
  float* smem = reinterpret_cast<float*>(dense_smem);
  int b = blockIdx.x;
  const bool first = b < dx_blocks;
  const Product& p = first ? dx : dm;
  b -= first ? 0 : dx_blocks;
  const int nx = (p.n + kDenseBN - 1) / kDenseBN;
  const int ny = (p.m + kDenseBM - 1) / kDenseBM;
  if (first)
    product_tile<false, true>(dx, b % nx, (b / nx) % ny, b / (nx * ny), smem);
  else
    product_tile<true, false>(dm, b % nx, (b / nx) % ny, b / (nx * ny), smem);
}

constexpr size_t kProductSmem =
    std::max(ProductShape<false, true>::kSmem, ProductShape<true, false>::kSmem);

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

size_t densify_grad_smem(const MatrixDesc& d) {
  const size_t in = d.v.ports, out = d.u.ports;
  const size_t phase_n = std::max(d.u.levels * d.u.slots,
                                  d.v.levels * d.v.slots);
  const size_t table = std::max(d.u.levels * d.u.ports,
                                d.v.levels * d.v.ports);
  const size_t states = d.save_states
      ? static_cast<size_t>(d.v.levels) * in * in +
            static_cast<size_t>(d.u.levels) * in * out
      : 0;
  return (4 * in * std::max(in, out) + in * in + 3 * phase_n + 2 * table +
          states) * sizeof(float);
}

// The warp design's shared memory at `threads` a block: both meshes'
// tables (cos, sin, partner, plan word a wire; the effective phase a
// slot), V's output rows, the gradient at U's input rows, every thread's
// states and every warp's phase gradients.
size_t densify_grad_warp_smem(const MatrixDesc& d, int threads) {
  const size_t in = d.v.ports, out = d.u.ports;
  const size_t phases = d.u.levels * d.u.slots + d.v.levels * d.v.slots;
  const size_t tables = 4 * (static_cast<size_t>(d.v.levels) * in +
                             static_cast<size_t>(d.u.levels) * out) +
                        phases;
  const size_t states =
      static_cast<size_t>(d.v.levels + d.u.levels) * threads;
  const size_t parts = static_cast<size_t>(threads / 32) * phases;
  return (tables + in * in + in * out + states + parts) * sizeof(float);
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

// The owner walk: the arguments of mesh_apply_launch plus owner
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

// Route A (warp rows): x, phases, diag, y, strides and transpose as for
// mesh_apply_launch; plan: the layout's record plan (levels, kPlan) int32
// (kernels/mesh_apply.py::rows_plan); table: (S, levels, kRecord) f32
// scratch for the prologue's trig records; the lane width W (8, 16, 32),
// rows per warp R (1, 2, 4) and warps per block; identity: x is ignored
// and row r of each entry is e_r (batch = ports): the densification of
// route B.
extern "C" int mesh_rows_launch(const void* x, const void* phases,
                                const void* plan, const void* diag, void* y,
                                void* table, int batch, int ports, int levels,
                                int slots, int stack, int lane_width,
                                int rows_per_warp, int warps,
                                int64_t x_stride_s, int64_t diag_stride_s,
                                int transpose, int identity, void* stream) {
  if (batch < 1 || ports < 2 || ports > 32 * lane_width || levels < 1 ||
      slots < 1 || stack < 1 || stack > 65535 || warps < 1 ||
      32 * warps > kRowsMaxThreads || x_stride_s < 0 || diag_stride_s < 0 ||
      table == nullptr || (identity && batch != ports))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xf = static_cast<const float*>(x);
  const float* pf = static_cast<const float*>(phases);
  const int* pl = static_cast<const int*>(plan);
  const float* dg = static_cast<const float*>(diag);
  float* yf = static_cast<float*>(y);
  float* tb = static_cast<float*>(table);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MESH_ROWS_CASE(W, R)                                                \
  if (lane_width == W && rows_per_warp == R)                               \
    return rows_launch<W, R>(xf, pf, pl, dg, yf, tb, batch, ports, levels,  \
                             slots, stack, warps, x_stride_s, diag_stride_s, \
                             transpose, identity, st);
  MESH_ROWS_CASE(8, 1) MESH_ROWS_CASE(8, 2) MESH_ROWS_CASE(8, 4)
  MESH_ROWS_CASE(16, 1) MESH_ROWS_CASE(16, 2) MESH_ROWS_CASE(16, 4)
  MESH_ROWS_CASE(32, 1) MESH_ROWS_CASE(32, 2) MESH_ROWS_CASE(32, 4)
#undef MESH_ROWS_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// Route B's product: y (S, batch, ports) = x * m per entry, x (batch,
// ports) shared (x_stride_s = 0) or (S, batch, ports), m (S, ports, ports);
// ports % 4 == 0 and 16-byte aligned rows.
extern "C" int mesh_product_launch(const void* x, const void* m, void* y,
                                   int batch, int ports, int stack,
                                   int64_t x_stride_s, void* stream) {
  if (batch < 1 || ports < 4 || ports % 4 != 0 || stack < 1 ||
      stack > 65535 || x_stride_s < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Product p{static_cast<const float*>(x), static_cast<const float*>(m),
                  static_cast<float*>(y), batch, ports, ports, 1,
                  (ports + kDenseBK - 1) / kDenseBK, x_stride_s,
                  static_cast<int64_t>(ports) * ports,
                  static_cast<int64_t>(batch) * ports, 0};
  constexpr size_t smem = ProductShape<false, false>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      mesh_product_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((ports + kDenseBN - 1) / kDenseBN,
                  (batch + kDenseBM - 1) / kDenseBM, stack);
  mesh_product_kernel<<<grid, kDenseThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The dense backward's products (kernels/mesh_apply.py::mesh_product_grad),
// one launch: dx (S, batch, ports) = dy * M^T per entry, and dM (S, ports,
// ports) = x^T * dy, either skipped (null); dy (S, batch, ports), m (S,
// ports, ports), x (batch, ports) shared (x_stride_s = 0) or (S, batch,
// ports).  dM's k tiles (of the batch's rows) are split in `splits` ranges
// of per_split tiles, each split writing its (S, ports, ports) partial
// into `partials` (splits, S, ports, ports) where splits > 1, then summed
// into dM in split order.  ports % 4 == 0.
extern "C" int mesh_product_grad_launch(const void* dy, const void* m,
                                        const void* x, void* dx, void* dm,
                                        void* partials, int batch, int ports,
                                        int stack, int64_t x_stride_s,
                                        int splits, int per_split,
                                        void* stream) {
  const int ktiles = (batch + kDenseBK - 1) / kDenseBK;
  if (batch < 1 || ports < 4 || ports % 4 != 0 || stack < 1 ||
      x_stride_s < 0 || (dx == nullptr && dm == nullptr) ||
      (dm != nullptr &&
       (splits < 1 || per_split < 1 || (splits - 1) * per_split >= ktiles ||
        splits * per_split < ktiles || (splits > 1 && partials == nullptr))))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dyf = static_cast<const float*>(dy);
  const int64_t bp = static_cast<int64_t>(batch) * ports;
  const int64_t pp = static_cast<int64_t>(ports) * ports;
  const int64_t count = stack * pp;
  const Product pdx{dyf, static_cast<const float*>(m),
                    static_cast<float*>(dx), batch, ports, ports, 1,
                    (ports + kDenseBK - 1) / kDenseBK, bp, pp, bp, 0};
  const Product pdm{static_cast<const float*>(x), dyf,
                    static_cast<float*>(splits > 1 ? partials : dm), ports,
                    ports, batch, splits, per_split, x_stride_s, bp, pp,
                    count};
  const int64_t tiles_n = (ports + kDenseBN - 1) / kDenseBN;
  const int64_t dx_blocks =
      dx == nullptr ? 0 : tiles_n * ((batch + kDenseBM - 1) / kDenseBM) * stack;
  const int64_t dm_blocks =
      dm == nullptr ? 0 : tiles_n * tiles_n * stack * splits;
  if (dx_blocks + dm_blocks > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      mesh_product_grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kProductSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  mesh_product_grad_kernel<<<static_cast<unsigned>(dx_blocks + dm_blocks),
                             kDenseThreads, kProductSmem, st>>>(
      pdx, pdm, static_cast<int>(dx_blocks));
  err = cudaGetLastError();
  if (err != cudaSuccess || dm == nullptr || splits == 1)
    return static_cast<int>(err);
  const int blocks = static_cast<int>(
      std::min<int64_t>((count + kThreads - 1) / kThreads, 4096));
  mesh_grad_sum_kernel<<<blocks, kThreads, 0, st>>>(
      static_cast<const float*>(partials), static_cast<float*>(dm), splits,
      count);
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

// The grouped backward: group as for mesh_densify_launch, each matrix's
// `out` pointing at its core's gradient dW (S, out, in) and `save_states`
// set where its states fit; grads: the flat output (see
// mesh_densify_grad_kernel).  DAC phase snapping has no gradient here.
extern "C" int mesh_densify_grad_launch(const MeshGroup* group, void* grads,
                                        void* stream) {
  if (group->count < 1 || group->count > kMaxGroup || group->stack < 1 ||
      group->dac || grads == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  size_t smem = 0;
  for (int g = 0; g < group->count; ++g) {
    const MatrixDesc& d = group->m[g];
    if (d.u.ports < 1 || d.v.ports < 1 || d.u.levels < 1 ||
        d.v.levels < 1 || d.u.slots < 1 || d.v.slots < 1 || d.k < 1)
      return static_cast<int>(cudaErrorInvalidValue);
    smem = std::max(smem, densify_grad_smem(d));
  }
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        mesh_densify_grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(group->stack, group->count);
  mesh_densify_grad_kernel<<<grid, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      *group, static_cast<float*>(grads));
  return static_cast<int>(cudaGetLastError());
}

// The grouped backward's warp design (mesh_densify_grad_warp_kernel):
// group and grads as for mesh_densify_grad_launch (save_states unused: it
// keeps every state), offsets the float offset of each matrix's gradients
// in grads (in the block design's order: the sizes of the matrices before
// it), blocks of 32 * warps threads, warps enough for both meshes' rows of
// every matrix (every mesh at most 32 ports wide).
extern "C" int mesh_densify_grad_warp_launch(const MeshGroup* group,
                                             const GroupOffsets* offsets,
                                             void* grads, int warps,
                                             void* stream) {
  if (group->count < 1 || group->count > kMaxGroup || group->stack < 1 ||
      group->dac || offsets == nullptr || grads == nullptr || warps < 1 ||
      32 * warps > kWarpGradMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  size_t smem = 0;
  for (int g = 0; g < group->count; ++g) {
    const MatrixDesc& d = group->m[g];
    const int in = d.v.ports, out = d.u.ports;
    if (in < 1 || out < 1 || in > 32 || out > 32 || d.u.levels < 1 ||
        d.v.levels < 1 || d.u.slots < 1 || d.v.slots < 1 || d.k < 1 ||
        warp_row_warps(in, in) > warps || warp_row_warps(out, in) > warps)
      return static_cast<int>(cudaErrorInvalidValue);
    smem = std::max(smem, densify_grad_warp_smem(d, 32 * warps));
  }
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        mesh_densify_grad_warp_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(group->stack, group->count);
  mesh_densify_grad_warp_kernel<<<grid, 32 * warps, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      *group, *offsets, static_cast<float*>(grads));
  return static_cast<int>(cudaGetLastError());
}

// The resident backward: y, dy (S, batch, ports), the output and its
// gradient of mesh_apply_launch; phases, slot, sign, perm, diag and
// transpose as there; dx (S, batch, ports) or null; dphases (S, levels,
// slots) or null; partials (blocks_x, S, levels, slots) scratch, used when
// blocks_x > 1 (then mesh_grad_sum_kernel sums it into dphases).  Grid
// (blocks_x, S), blocks_x at most the row tiles.
extern "C" int mesh_apply_grad_launch(const void* y, const void* dy,
                                      const void* phases, const void* slot,
                                      const void* sign, const void* perm,
                                      const void* diag, void* dx,
                                      void* dphases, void* partials,
                                      int batch, int ports, int levels,
                                      int slots, int stack,
                                      int rows_per_block, int blocks_x,
                                      int64_t diag_stride_s, int transpose,
                                      void* stream) {
  const int tiles =
      (batch + rows_per_block - 1) / std::max(rows_per_block, 1);
  if (batch < 1 || ports < 1 || levels < 1 || slots < 1 || stack < 1 ||
      stack > 65535 || rows_per_block < 1 || blocks_x < 1 ||
      blocks_x > tiles || diag_stride_s < 0 ||
      (dx == nullptr && dphases == nullptr) ||
      (dphases != nullptr && blocks_x > 1 && partials == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (3 * static_cast<size_t>(levels) * ports + ports +
                       4 * static_cast<size_t>(rows_per_block) * ports) *
                      sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        mesh_apply_grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* target = dphases == nullptr ? nullptr
                  : static_cast<float*>(blocks_x > 1 ? partials : dphases);
  mesh_apply_grad_kernel<<<dim3(blocks_x, stack), kThreads, smem, st>>>(
      static_cast<const float*>(y), static_cast<const float*>(dy),
      static_cast<const float*>(phases), static_cast<const int*>(slot),
      static_cast<const float*>(sign), static_cast<const int*>(perm),
      static_cast<const float*>(diag), static_cast<float*>(dx), target,
      batch, ports, levels, slots, rows_per_block, diag_stride_s, transpose);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || dphases == nullptr || blocks_x == 1)
    return static_cast<int>(err);
  const int64_t count = static_cast<int64_t>(stack) * levels * slots;
  const int blocks = static_cast<int>(
      std::min<int64_t>((count + kThreads - 1) / kThreads, 1024));
  mesh_grad_sum_kernel<<<blocks, kThreads, 0, st>>>(
      static_cast<const float*>(partials), static_cast<float*>(dphases),
      blocks_x, count);
  return static_cast<int>(cudaGetLastError());
}

namespace {

template <bool kPairs, bool kTr, bool kPh, int kChunk>
int res_warp_launch(const float* y, const float* dy, const float* phases,
                    const int* slot, const float* sign, const int* perm,
                    const float* diag, float* dx, float* dph, float* part,
                    int* tickets, int batch, int ports, int levels,
                    int slots, int stack, int warps, int columns,
                    int per_column, int64_t diag_stride_s,
                    cudaStream_t st) {
  const size_t smem = res_warp_smem(ports, levels, slots, warps, kPairs);
  auto* kernel = mesh_apply_grad_warp_kernel<kPairs, kTr, kPh, kChunk>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(columns, stack), 32 * warps, smem, st>>>(
      y, dy, phases, slot, sign, perm, diag, dx, dph, part, tickets, batch,
      ports, levels, slots, per_column, diag_stride_s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The resident backward's warp design (mesh_apply_grad_warp_kernel): y,
// dy, phases, slot, sign, perm, diag, dx, dphases and transpose as for
// mesh_apply_grad_launch; pairs: the pairs lane layout (33 to 64 ports,
// brick levels; the host checks the layout) rather than lanes (at most 32
// ports); blocks of 32 * warps threads; grid (columns, S), column x taking
// the row groups [x * per_column, (x + 1) * per_column) (R = 32 / ports
// rows a group in lanes, 1 in pairs), every column some, each warp
// walking `chunk` (1 or 2) of its groups at once; partials
// (columns, S, levels, slots) scratch when columns > 1 and dphases is
// asked for; tickets: S int32 zeros (left zero) to fold the columns in the
// launch, or null to sum them in mesh_grad_sum_kernel after it.
extern "C" int mesh_apply_grad_warp_launch(
    const void* y, const void* dy, const void* phases, const void* slot,
    const void* sign, const void* perm, const void* diag, void* dx,
    void* dphases, void* partials, void* tickets, int batch, int ports,
    int levels, int slots, int stack, int warps, int columns,
    int per_column, int chunk, int pairs, int64_t diag_stride_s,
    int transpose, void* stream) {
  const int rows = pairs ? 1 : 32 / std::max(ports, 1);
  const int groups = (batch + rows - 1) / std::max(rows, 1);
  if (batch < 1 || ports < 2 || (pairs ? ports < 33 || ports > 64
                                       : ports > 32) ||
      levels < 1 || slots < 1 || stack < 1 || stack > 65535 || warps < 1 ||
      32 * warps > kResWarpMaxThreads || columns < 1 || per_column < 1 ||
      static_cast<int64_t>(columns - 1) * per_column >= groups ||
      static_cast<int64_t>(columns) * per_column < groups ||
      (chunk != 1 && chunk != 2) || diag_stride_s < 0 ||
      (dx == nullptr && dphases == nullptr) ||
      (dphases != nullptr && columns > 1 && partials == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* yf = static_cast<const float*>(y);
  const float* df = static_cast<const float*>(dy);
  const float* pf = static_cast<const float*>(phases);
  const int* sl = static_cast<const int*>(slot);
  const float* sg = static_cast<const float*>(sign);
  const int* pm = static_cast<const int*>(perm);
  const float* dg = static_cast<const float*>(diag);
  float* dxf = static_cast<float*>(dx);
  float* dpf = static_cast<float*>(dphases);
  float* pt = static_cast<float*>(partials);
  int* tk = columns > 1 ? static_cast<int*>(tickets) : nullptr;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = static_cast<int>(cudaErrorInvalidValue);
#define RES_WARP_CASE(PA, TR, PH, CH)                                       \
  if ((pairs != 0) == PA && (transpose != 0) == TR &&                      \
      (dphases != nullptr) == PH && chunk == CH)                           \
    err = res_warp_launch<PA, TR, PH, CH>(                                 \
        yf, df, pf, sl, sg, pm, dg, dxf, dpf, pt, tk, batch, ports, levels, \
        slots, stack, warps, columns, per_column, diag_stride_s, st);
#define RES_WARP_CHUNKS(PA, TR, PH)                                         \
  RES_WARP_CASE(PA, TR, PH, 1) RES_WARP_CASE(PA, TR, PH, 2)
  RES_WARP_CHUNKS(false, false, false) RES_WARP_CHUNKS(false, false, true)
  RES_WARP_CHUNKS(false, true, false) RES_WARP_CHUNKS(false, true, true)
  RES_WARP_CHUNKS(true, false, false) RES_WARP_CHUNKS(true, false, true)
  RES_WARP_CHUNKS(true, true, false) RES_WARP_CHUNKS(true, true, true)
#undef RES_WARP_CHUNKS
#undef RES_WARP_CASE
  if (err != cudaSuccess || dphases == nullptr || columns == 1 ||
      tk != nullptr)
    return err;
  const int64_t count = static_cast<int64_t>(stack) * levels * slots;
  const int blocks = static_cast<int>(
      std::min<int64_t>((count + kThreads - 1) / kThreads, 1024));
  mesh_grad_sum_kernel<<<blocks, kThreads, 0, st>>>(pt, dpf, columns, count);
  return static_cast<int>(cudaGetLastError());
}

// The warp-rows backward (routes A and B): y, dy (S, batch, ports), the
// forward's output and its gradient; phases, diag, transpose as for
// mesh_rows_launch; plan: the layout's record plan; smap: its slot map
// (levels, map_stride) int32, map_stride a multiple of 4 of at least
// slots; dx (S, batch, ports) or null; dphases (S, levels, slots) or null;
// partials (blocks_x, S, levels, slots) scratch, used when blocks_x > 1;
// table: (S, levels, kRecord) f32 scratch.  blocks_x must be the row
// tiles of warps * R rows.
extern "C" int mesh_rows_grad_launch(const void* y, const void* dy,
                                     const void* phases, const void* plan,
                                     const void* smap, const void* diag,
                                     void* dx, void* dphases, void* partials,
                                     void* table, int batch, int ports,
                                     int levels, int slots, int map_stride,
                                     int stack, int lane_width,
                                     int rows_per_warp, int warps,
                                     int blocks_x, int64_t diag_stride_s,
                                     int transpose, void* stream) {
  const int tile = std::max(warps * rows_per_warp, 1);
  if (batch < 1 || ports < 2 || ports > 32 * lane_width || levels < 1 ||
      slots < 1 || map_stride < slots || map_stride % 4 != 0 || stack < 1 ||
      stack > 65535 || warps < 1 || diag_stride_s < 0 || table == nullptr ||
      blocks_x != (batch + tile - 1) / tile ||
      (dx == nullptr && dphases == nullptr) ||
      (dphases != nullptr && blocks_x > 1 && partials == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* yf = static_cast<const float*>(y);
  const float* df = static_cast<const float*>(dy);
  const float* pf = static_cast<const float*>(phases);
  const int* pl = static_cast<const int*>(plan);
  const int* sm = static_cast<const int*>(smap);
  const float* dg = static_cast<const float*>(diag);
  float* dxf = static_cast<float*>(dx);
  float* dpf = static_cast<float*>(dphases);
  float* pt = static_cast<float*>(partials);
  float* tb = static_cast<float*>(table);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MESH_ROWS_GRAD_CASE(W, R)                                            \
  if (lane_width == W && rows_per_warp == R)                                \
    return rows_grad_launch<W, R>(yf, df, pf, pl, sm, map_stride, dg, dxf,  \
                                  dpf, pt, tb, batch, ports, levels, slots, \
                                  stack, warps, blocks_x, diag_stride_s,    \
                                  transpose, st);
  MESH_ROWS_GRAD_CASE(8, 1) MESH_ROWS_GRAD_CASE(8, 2)
  MESH_ROWS_GRAD_CASE(16, 1) MESH_ROWS_GRAD_CASE(16, 2)
  MESH_ROWS_GRAD_CASE(32, 1) MESH_ROWS_GRAD_CASE(32, 2)
#undef MESH_ROWS_GRAD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
