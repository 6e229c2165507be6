// K1: the dynamics-projection DP sweep of the Chambolle-Pock prox_f, for
// NVIDIA Hopper (sm_90a), templated on float and double.
//
// Replaces the Pallas TPU kernel raocp_tpu/ops/pallas_sweep.py:_sweep_kernel
// (launched by project_dynamics_pallas). Same contract: the Euclidean
// projection of (x, u) onto {x_j = A_j x_i + B_j u_i, x_0 = x0} for trees
// whose every nonleaf stage k is stage-constant (uniform branching c_k, one
// child mode pattern, one Riccati table set per stage).
//
// Backward sweep, stage k from the leaves up (q_leaf = -x_leaf):
//   abtq = sum_r q_child_r * ab_bwd[k][r]            ([sum A'q | sum B'q])
//   d    = (u - sumB'q) * rinv_s[k]^T
//   q    = -x + (d - u + sumB'q) * k_s[k] + d * sumapb_s[k]^T + sumA'q
// Forward rollout, stage k from the root down:
//   u          = x * k_s[k]^T + d
//   x_child_r  = [x u] * ab_fwd[k][:, r, :]
// Ghost rows past N (x) and NL (u) are written as zeros.
//
// What bounds it on this card: a sequential dependency chain of
// 2 x (number of nonleaf stages) steps -- 16 at the 50-state, 8-stage,
// 9,841-node configuration -- over tiny weights (c*n*(n+m) values per
// stage, 42 KB in float32 at n=50, m=20, c=3) and at most a few MB of node
// data. Neither FLOPs nor HBM bandwidth bounds it: each stage depends on
// the one before, and the early stages have too few rows to fill the card.
// What this design does about it: each stage's chain of small ops (two
// contractions, three matrix products, the combine) runs fused in ONE
// launch, with the stage's weights staged in shared memory and the
// intermediates (abtq, d, [x u]) kept there, so a stage costs one launch
// and one read and write of its rows instead of about eight separate ops
// with device-memory round trips. Nothing carries over between blocks:
// the stages are separate launches on one stream, which orders them.
// Plain FMA in the element type: no tensor cores, no TF32 (the solver
// needs full float32 to reach its tolerances).
//
// Wide stages: where a stage's weights do not fit in shared memory beside
// one row of the tile (n=100, m=40, c=3 in float64: 417 KB), the same two
// kernels run with kSharedW = false: they read the weights from device
// memory through the read-only path (__ldg; the weights are a few hundred
// KB, so they stay in L2) and keep only the tile's rows in shared memory.
// The host picks the path and the tile per stage and direction
// (plan_stage); raocp_sweep_tile reports the choice.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTileRows = 16;
constexpr size_t kMaxSmem = 232448;   // 227 KB: the most a block may use

// shared-memory elements of the weights of one backward launch
inline size_t bwd_weight_elems(int n, int m, int c) {
  const size_t F = n + m;
  return (size_t)c * n * F + 2 * (size_t)m * n + (size_t)m * m;
}

// shared-memory elements of the rows of a backward tile of `tw` rows
inline size_t bwd_row_elems(int n, int m, int c, int tw) {
  const size_t F = n + m;
  return (size_t)tw * ((size_t)c * n + F + 2 * (size_t)m);
}

// shared-memory elements of the weights of one forward launch
inline size_t fwd_weight_elems(int n, int m, int c) {
  const size_t F = n + m;
  return F * c * n + (size_t)m * n;
}

// shared-memory elements of the rows of a forward tile of `tw` rows
inline size_t fwd_row_elems(int n, int m, int c, int tw) {
  (void)c;
  return (size_t)tw * (size_t)(n + m);
}

// a weight read: from shared memory, or from device memory through the
// read-only data path
template <bool kSharedW, typename T>
__device__ __forceinline__ T ldw(const T* p, size_t i) {
  if constexpr (kSharedW) {
    return p[i];
  } else {
    return __ldg(p + i);
  }
}

// fused multiply-add in the element type (no mixed precision)
__device__ __forceinline__ float fmadd(float x, float y, float acc) {
  return fmaf(x, y, acc);
}
__device__ __forceinline__ double fmadd(double x, double y, double acc) {
  return fma(x, y, acc);
}

template <typename T, bool kSharedW>
__global__ void sweep_bwd_kernel(
    const T* __restrict__ x_in, const T* __restrict__ u_in,
    const T* __restrict__ q_child, T child_sign,
    const T* __restrict__ ab_bwd, const T* __restrict__ k_s,
    const T* __restrict__ rinv, const T* __restrict__ sumapb,
    T* __restrict__ q_out, T* __restrict__ d_out,
    long long a, long long W, long long a2, int c, int n, int m, int tw) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int F = n + m;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  // the weights: staged in shared memory, or read in place
  const T* w_ab = ab_bwd;                        // [c, n, F]
  const T* w_k = k_s;                            // [m, n]
  const T* w_rinv = rinv;                        // [m, m]
  const T* w_apb = sumapb;                       // [n, m]
  T* s_q = smem;                                 // [tw, c, n] child q rows
  if constexpr (kSharedW) {
    T* s_ab = smem;
    T* s_k = s_ab + (size_t)c * n * F;
    T* s_rinv = s_k + (size_t)m * n;
    T* s_apb = s_rinv + (size_t)m * m;
    for (int i = tid; i < c * n * F; i += nt) s_ab[i] = ab_bwd[i];
    for (int i = tid; i < m * n; i += nt) {
      s_k[i] = k_s[i];
      s_apb[i] = sumapb[i];
    }
    for (int i = tid; i < m * m; i += nt) s_rinv[i] = rinv[i];
    w_ab = s_ab;
    w_k = s_k;
    w_rinv = s_rinv;
    w_apb = s_apb;
    s_q = s_apb + (size_t)n * m;
  }
  T* s_abtq = s_q + (size_t)tw * c * n;          // [tw, F]
  T* s_d = s_abtq + (size_t)tw * F;              // [tw, m]
  T* s_g = s_d + (size_t)tw * m;                 // [tw, m] d - u + sumB'q

  const long long w0 = (long long)blockIdx.x * tw;
  const int rows = (int)(W - w0 < tw ? W - w0 : tw);

  const T* qsrc = q_child + (a2 + w0 * c) * n;
  for (int i = tid; i < rows * c * n; i += nt) s_q[i] = child_sign * qsrc[i];
  __syncthreads();

  // abtq[w, f] = sum_{r, i} q[w, r, i] * ab_bwd[r, i, f]
  for (int idx = tid; idx < rows * F; idx += nt) {
    const int w = idx / F, f = idx - w * F;
    const T* qw = s_q + (size_t)w * c * n;
    T acc = T(0);
    for (int r = 0; r < c; ++r)
      for (int i = 0; i < n; ++i)
        acc = fmadd(qw[r * n + i],
                    ldw<kSharedW>(w_ab, ((size_t)r * n + i) * F + f), acc);
    s_abtq[(size_t)w * F + f] = acc;
  }
  __syncthreads();

  // d = (u - sumB'q) rinv^T ; g = d - u + sumB'q
  for (int idx = tid; idx < rows * m; idx += nt) {
    const int w = idx / m, j = idx - w * m;
    const T* urow = u_in + (a + w0 + w) * m;
    const T* bt = s_abtq + (size_t)w * F + n;
    T acc = T(0);
    for (int l = 0; l < m; ++l)
      acc = fmadd(urow[l] - bt[l], ldw<kSharedW>(w_rinv, (size_t)j * m + l),
                  acc);
    s_d[(size_t)w * m + j] = acc;
    s_g[(size_t)w * m + j] = (acc - urow[j]) + bt[j];
    d_out[(a + w0 + w) * m + j] = acc;
  }
  __syncthreads();

  // q = -x + g k_s + d sumapb^T + sumA'q
  for (int idx = tid; idx < rows * n; idx += nt) {
    const int w = idx / n, i = idx - w * n;
    const T* gw = s_g + (size_t)w * m;
    const T* dw = s_d + (size_t)w * m;
    T kg = T(0), pd = T(0);
    for (int j = 0; j < m; ++j) {
      kg = fmadd(gw[j], ldw<kSharedW>(w_k, (size_t)j * n + i), kg);
      pd = fmadd(dw[j], ldw<kSharedW>(w_apb, (size_t)i * m + j), pd);
    }
    const long long row = a + w0 + w;
    q_out[row * n + i] = ((-x_in[row * n + i] + kg) + pd)
                         + s_abtq[(size_t)w * F + i];
  }
}

template <typename T, bool kSharedW>
__global__ void sweep_fwd_kernel(
    const T* __restrict__ x0, T* __restrict__ x_out, T* __restrict__ u_out,
    const T* __restrict__ d_in, const T* __restrict__ ab_fwd,
    const T* __restrict__ k_s,
    long long a, long long W, long long a2, int c, int n, int m, int tw,
    int first) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int F = n + m;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  // the weights: staged in shared memory, or read in place
  const T* w_abf = ab_fwd;                       // [F, c, n]
  const T* w_k = k_s;                            // [m, n]
  T* s_xu = smem;                                // [tw, F] = [x u]
  if constexpr (kSharedW) {
    T* s_abf = smem;
    T* s_k = s_abf + (size_t)F * c * n;
    for (int i = tid; i < F * c * n; i += nt) s_abf[i] = ab_fwd[i];
    for (int i = tid; i < m * n; i += nt) s_k[i] = k_s[i];
    w_abf = s_abf;
    w_k = s_k;
    s_xu = s_k + (size_t)m * n;
  }

  const long long w0 = (long long)blockIdx.x * tw;
  const int rows = (int)(W - w0 < tw ? W - w0 : tw);

  // the parents' x: x0 at the root (also written to row 0), else the rows
  // the previous stage's launch wrote
  for (int idx = tid; idx < rows * n; idx += nt) {
    const int w = idx / n, i = idx - w * n;
    T v;
    if (first) {
      v = x0[i];
      x_out[i] = v;
    } else {
      v = x_out[(a + w0 + w) * n + i];
    }
    s_xu[(size_t)w * F + i] = v;
  }
  __syncthreads();

  // u = x k_s^T + d
  for (int idx = tid; idx < rows * m; idx += nt) {
    const int w = idx / m, j = idx - w * m;
    const T* xw = s_xu + (size_t)w * F;
    T acc = T(0);
    for (int i = 0; i < n; ++i)
      acc = fmadd(xw[i], ldw<kSharedW>(w_k, (size_t)j * n + i), acc);
    const long long row = a + w0 + w;
    acc = acc + d_in[row * m + j];
    s_xu[(size_t)w * F + n + j] = acc;
    u_out[row * m + j] = acc;
  }
  __syncthreads();

  // x_child[w, r, i] = sum_f xu[w, f] ab_fwd[f, r, i]
  for (int idx = tid; idx < rows * c * n; idx += nt) {
    const int w = idx / (c * n);
    const int ri = idx - w * c * n;              // r * n + i
    const T* xw = s_xu + (size_t)w * F;
    T acc = T(0);
    for (int f = 0; f < F; ++f)
      acc = fmadd(xw[f], ldw<kSharedW>(w_abf, (size_t)f * c * n + ri), acc);
    x_out[(a2 + (w0 + w) * c) * n + ri] = acc;
  }
}

template <typename T>
__global__ void zero_kernel(T* __restrict__ p, long long count) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < count; i += (long long)gridDim.x * blockDim.x)
    p[i] = T(0);
}

// How one launch runs: the weights in shared memory or in device memory,
// the tile's row count, and the dynamic shared memory in bytes.
struct StagePlan {
  bool shared_w;
  int tile;
  size_t bytes;
};

// The largest tile (<= kMaxTileRows rows) whose shared memory fits with
// the weights staged there; failing that, the largest whose rows alone
// fit, with the weights read from device memory. tile 0: not even one row
// fits.
inline StagePlan plan_stage(bool forward, int n, int m, int c, size_t es) {
  const size_t wts = forward ? fwd_weight_elems(n, m, c)
                             : bwd_weight_elems(n, m, c);
  for (int shared = 1; shared >= 0; --shared)
    for (int tw = kMaxTileRows; tw >= 1; tw /= 2) {
      const size_t rows = forward ? fwd_row_elems(n, m, c, tw)
                                  : bwd_row_elems(n, m, c, tw);
      const size_t bytes = ((shared ? wts : 0) + rows) * es;
      if (bytes <= kMaxSmem) return StagePlan{shared == 1, tw, bytes};
    }
  return StagePlan{false, 0, 0};
}

template <typename KernelT>
cudaError_t allow_smem(KernelT kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

inline unsigned int blocks_for(long long W, int tw) {
  return (unsigned int)((W + tw - 1) / tw);
}

template <typename T, bool kSharedW>
cudaError_t launch_bwd(const StagePlan& p, long long W, cudaStream_t stream,
                       const T* x_in, const T* u_in, const T* q_child,
                       T sign, const T* ab, const T* k, const T* rinv,
                       const T* apb, T* q_out, T* d_out, long long a,
                       long long a2, int c, int n, int m) {
  cudaError_t err = allow_smem(sweep_bwd_kernel<T, kSharedW>, p.bytes);
  if (err != cudaSuccess) return err;
  sweep_bwd_kernel<T, kSharedW>
      <<<blocks_for(W, p.tile), kThreads, p.bytes, stream>>>(
          x_in, u_in, q_child, sign, ab, k, rinv, apb, q_out, d_out, a, W,
          a2, c, n, m, p.tile);
  return cudaGetLastError();
}

template <typename T, bool kSharedW>
cudaError_t launch_fwd(const StagePlan& p, long long W, cudaStream_t stream,
                       const T* x0, T* x_out, T* u_out, const T* d_in,
                       const T* abf, const T* k, long long a, long long a2,
                       int c, int n, int m, int first) {
  cudaError_t err = allow_smem(sweep_fwd_kernel<T, kSharedW>, p.bytes);
  if (err != cudaSuccess) return err;
  sweep_fwd_kernel<T, kSharedW>
      <<<blocks_for(W, p.tile), kThreads, p.bytes, stream>>>(
          x0, x_out, u_out, d_in, abf, k, a, W, a2, c, n, m, p.tile, first);
  return cudaGetLastError();
}

// Error codes besides CUDA's: -2 = not even one row of a stage's tile fits
// in shared memory.
template <typename T>
int run_sweep(const T* x_in, const T* u_in, const T* x0, T* x_out, T* u_out,
              T* q_buf, T* d_buf, const void* const* ab_bwd,
              const void* const* ab_fwd, const void* const* k_s,
              const void* const* rinv_s, const void* const* sumapb_s,
              const long long* stage_start, const long long* stage_child,
              int num_stages, int n, int m, long long np_pad,
              long long nl_pad, cudaStream_t stream) {
  const size_t es = sizeof(T);
  const int ns_nl = num_stages - 1;
  const long long N = stage_start[num_stages];
  const long long NL = stage_start[num_stages - 1];
  cudaError_t err;

  // backward sweep: stage ns_nl-1 reads the leaves' q = -x straight from
  // x_in; every other stage reads the q rows the stage below wrote
  for (int k = ns_nl - 1; k >= 0; --k) {
    const long long a = stage_start[k], W = stage_start[k + 1] - a;
    const long long a2 = stage_start[k + 1];
    const int c = (int)stage_child[k];
    const StagePlan p = plan_stage(false, n, m, c, es);
    if (p.tile == 0) return -2;
    const bool leaf_children = (k == ns_nl - 1);
    const T* q_child = leaf_children ? x_in : q_buf;
    const T sign = leaf_children ? T(-1) : T(1);
    const T* ab = static_cast<const T*>(ab_bwd[k]);
    const T* kk = static_cast<const T*>(k_s[k]);
    const T* rinv = static_cast<const T*>(rinv_s[k]);
    const T* apb = static_cast<const T*>(sumapb_s[k]);
    err = p.shared_w
        ? launch_bwd<T, true>(p, W, stream, x_in, u_in, q_child, sign, ab,
                              kk, rinv, apb, q_buf, d_buf, a, a2, c, n, m)
        : launch_bwd<T, false>(p, W, stream, x_in, u_in, q_child, sign, ab,
                               kk, rinv, apb, q_buf, d_buf, a, a2, c, n, m);
    if (err != cudaSuccess) return (int)err;
  }

  // forward rollout from x0
  for (int k = 0; k < ns_nl; ++k) {
    const long long a = stage_start[k], W = stage_start[k + 1] - a;
    const long long a2 = stage_start[k + 1];
    const int c = (int)stage_child[k];
    const StagePlan p = plan_stage(true, n, m, c, es);
    if (p.tile == 0) return -2;
    const T* abf = static_cast<const T*>(ab_fwd[k]);
    const T* kk = static_cast<const T*>(k_s[k]);
    err = p.shared_w
        ? launch_fwd<T, true>(p, W, stream, x0, x_out, u_out, d_buf, abf,
                              kk, a, a2, c, n, m, k == 0)
        : launch_fwd<T, false>(p, W, stream, x0, x_out, u_out, d_buf, abf,
                               kk, a, a2, c, n, m, k == 0);
    if (err != cudaSuccess) return (int)err;
  }

  // ghost rows
  const long long gx = (np_pad - N) * n, gu = (nl_pad - NL) * m;
  if (gx > 0) {
    zero_kernel<T><<<blocks_for(gx, kThreads), kThreads, 0, stream>>>(
        x_out + N * n, gx);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (gu > 0) {
    zero_kernel<T><<<blocks_for(gu, kThreads), kThreads, 0, stream>>>(
        u_out + NL * m, gu);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

#define RAOCP_SWEEP_ENTRY(NAME, T)                                           \
  extern "C" int NAME(                                                       \
      const void* x_in, const void* u_in, const void* x0, void* x_out,       \
      void* u_out, void* q_buf, void* d_buf, const void* const* ab_bwd,      \
      const void* const* ab_fwd, const void* const* k_s,                     \
      const void* const* rinv_s, const void* const* sumapb_s,                \
      const long long* stage_start, const long long* stage_child,            \
      int num_stages, int n, int m, long long np_pad, long long nl_pad,      \
      void* stream) {                                                        \
    return run_sweep<T>(                                                     \
        static_cast<const T*>(x_in), static_cast<const T*>(u_in),            \
        static_cast<const T*>(x0), static_cast<T*>(x_out),                   \
        static_cast<T*>(u_out), static_cast<T*>(q_buf),                      \
        static_cast<T*>(d_buf), ab_bwd, ab_fwd, k_s, rinv_s, sumapb_s,       \
        stage_start, stage_child, num_stages, n, m, np_pad, nl_pad,          \
        static_cast<cudaStream_t>(stream));                                  \
  }

RAOCP_SWEEP_ENTRY(raocp_sweep_f32, float)
RAOCP_SWEEP_ENTRY(raocp_sweep_f64, double)

// The plan of one launch: the tile's row count, negative where the weights
// are read from device memory, 0 where not even one row fits.
extern "C" int raocp_sweep_tile(int forward, int n, int m, int c,
                                int elem_size) {
  const StagePlan p = plan_stage(forward != 0, n, m, c, (size_t)elem_size);
  return p.shared_w ? p.tile : -p.tile;
}

extern "C" const char* raocp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
