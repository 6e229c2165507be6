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
// What bounds it on this card: operations. One apply is 2(c n (n+m) +
// m^2 + 2 m n) + 2(n m + (n+m) c n) FLOP per nonleaf node (48,800 at n=50,
// m=20, c=3; 195,200 at n=100, m=40, c=3) against about 1,600 / 2,800 bytes
// of node data, so at 67 TFLOP/s of float32 FMA and 3.35 TB/s the
// operations take 1.5-3.5 times as long as the bytes: 2.4 us for 9,841
// nodes at n=50, 86 us for 88,573 nodes at n=100. On top of that comes the
// dependency chain of 2 x (number of nonleaf stages) steps, whose top
// stages have 1, 3, 9, ... rows and cannot fill the card: there the time
// of a step is the latency of one tile.
//
// What this design does about it:
// * A stage step is a short chain of skinny products over a tile of rows:
//   backward [T, c n] x [c n, n+m], then [T, m] x [m, m], then
//   [T, 2m] x [2m, n] ([g | d] against k_s stacked on sumapb^T) and the
//   combine; forward [T, n] x [n, m], then [T, n+m] x [n+m, c n]. Each is
//   one register-tiled product: a thread owns TM rows x 4 columns of the
//   output, the tile's rows and the intermediates (sumA'q - x, u - sumB'q,
//   [g | d], [x | u]) stay in shared memory, and the weights stream from L2
//   through a ring of kRing slabs of 128 bytes' worth of rows of K.
// * The weights come by bulk copy, started by a producer warp. The caller
//   packs each product's weights in the order a block reads them, so a slab
//   is one contiguous run that ONE cp.async.bulk moves and reports to the
//   slab's `full` mbarrier; the multiplying warps arrive at the slab's
//   `empty` mbarrier after their last read, and one thread of the block's
//   ninth warp starts the next copy as soon as a slot is empty. The next
//   slabs load, across the ends of products, of tiles and (in the apex) of
//   stages, while this one is multiplied; no multiplying thread spends any
//   work on a copy, and no barrier of the whole block stands between two
//   slabs. The shared memory of a block is set by its row tile,
//   never by a stage's weights: any n, m, c fits, in float64 too.
// * The thread tile follows the stage. TM = 8 (one 16-byte read of the
//   weights feeds 8 x 4 FMAs) where a stage has more tiles than the card
//   holds blocks and the FMA pipes and the shared-memory reads are the
//   limit; blocks are persistent and walk over the stage's tiles. TM = 4,
//   2, 1 where a stage runs in one wave and the time of the launch is the
//   time of one tile: fewer rows a thread means a shorter chain of FMAs
//   and loads, and down to one row a block spreads a small stage over the
//   card; there, up to eight threads share an output and split the rows
//   of K between them.
// * One "apex" launch for the top of the tree: a single block runs the
//   backward steps of stages ka-1 .. 0 and then the forward steps of stages
//   0 .. ka-1, with a barrier of its multiplying threads between steps (q,
//   d and x of those stages go through device memory, which that barrier
//   orders). The launch that writes the last rows also zeroes the ghost
//   rows.
// * Which stages go to the apex, each other stage's thread tile, row tile
//   and grid, and how each product's columns and rows of K are dealt to the
//   threads (which is also how its weights are packed) are decided by the
//   caller alone (sweep_schedule in ops/sweep.py) and handed to
//   raocp_sweep_*, which checks them and computes none of them again;
//   raocp_sweep_smem reports the shared memory of a tile so that the plan
//   can be held against it.
// * A batch of B solves sweeps B lanes in one launch set. The arrays are
//   lane-major (x [B, np_pad, n], u [B, nl_pad, m], x0 [B, n], lanes
//   sx, su, s0 elements apart) and the lanes share the stage weights, so a
//   stage launch runs the B * W rows of all lanes as one stage: its global
//   row r is row r % W of lane r / W, a map applied where a row is loaded
//   or stored (one 32-bit division a row, outside the FMA loop), and a tile
//   may hold rows of several lanes. The apex runs a block a lane. The
//   children of a row stay contiguous inside its lane, so every load and
//   store keeps its width. One lane is the unbatched apply, through kernels
//   built without the map (a template case), so it pays nothing for it.
// Plain FMA in the element type: no tensor cores, no TF32 (the solver
// needs full float32 to reach its tolerances).

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;          // threads that multiply (8 warps)
constexpr int kBlock = kThreads + 32;  // and the producer warp
constexpr int kSlabRowBytes = 128;     // a slab holds 128 / sizeof(T) rows
constexpr int kHeaderBytes = 128;      // the slabs' barriers, ahead of them
constexpr int kRing = 4;               // slabs in flight (at most 8)
constexpr int kMaxCpp = 48;            // most column groups of a pass: a slab
                                       // is at most 128 x 4 x 48 = 24 KB
constexpr int kMaxSplit = 8;           // most threads that share an output
constexpr int kMaxApex = 16;           // most stages of one apex launch
constexpr int kApexTm = 1;             // thread tile of the apex launch
constexpr size_t kMaxSmem = 232448;    // 227 KB: the most a block may use

// ---------------------------------------------------------------- helpers

__host__ __device__ inline int round_up(int v, int q) {
  return (v + q - 1) / q * q;
}

// leading dimension of a shared-memory row array of K columns: a multiple
// of 4 elements (16-byte rows) that is not a multiple of 8, so that
// neighbouring rows start in different banks
__host__ __device__ inline int lead_dim(int K) {
  const int r = round_up(K, 4);
  return (r % 8 == 0) ? r + 4 : r;
}

// shared-memory elements of the row arrays of one row of a tile
__host__ __device__ inline size_t row_elems(bool forward, int n, int m,
                                            int c) {
  const int n4 = round_up(n, 4), m4 = round_up(m, 4);
  return forward ? (size_t)lead_dim(n4 + m4)
                 : (size_t)lead_dim(c * n) + lead_dim(n) + lead_dim(m)
                       + lead_dim(2 * m4);
}

// shared-memory elements of the partial sums of a split product: four a
// thread, twice (two passes in a row take turns)
__host__ __device__ inline size_t partial_elems(int tm) {
  return tm == 1 ? 2 * (size_t)kThreads * 4 : 0;
}

// shared-memory elements of a tile of one direction whose slabs have `cols`
// columns, after the header
__host__ __device__ inline size_t smem_elems(bool forward, int tile, int tm,
                                             int cols, int n, int m, int c,
                                             size_t elem_size) {
  const size_t slabs =
      (size_t)kRing * (kSlabRowBytes / (int)elem_size) * cols;
  return slabs + (size_t)tile * row_elems(forward, n, m, c)
         + partial_elems(tm);
}

__device__ __forceinline__ float fmadd(float x, float y, float acc) {
  return fmaf(x, y, acc);
}
__device__ __forceinline__ double fmadd(double x, double y, double acc) {
  return fma(x, y, acc);
}

// 16 bytes of the element type
template <typename T> struct Vec;
template <> struct Vec<float> {
  using type = float4;
  static constexpr int kLen = 4;
};
template <> struct Vec<double> {
  using type = double2;
  static constexpr int kLen = 2;
};
__device__ __forceinline__ float elem(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
__device__ __forceinline__ double elem(const double2& v, int i) {
  return i == 0 ? v.x : v.y;
}

// four consecutive elements from 16-byte-aligned shared memory
__device__ __forceinline__ void load4(const float* p, float (&b)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  b[0] = v.x; b[1] = v.y; b[2] = v.z; b[3] = v.w;
}
__device__ __forceinline__ void load4(const double* p, double (&b)[4]) {
  const double2 v = *reinterpret_cast<const double2*>(p);
  const double2 w = *reinterpret_cast<const double2*>(p + 2);
  b[0] = v.x; b[1] = v.y; b[2] = w.x; b[3] = w.y;
}

// an asynchronous copy of BYTES bytes from device to shared memory; where
// `valid` is false nothing is read and the destination is filled with zeros
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int bytes = valid ? BYTES : 0;
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(bytes) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(d), "l"(src), "n"(BYTES), "r"(bytes) : "memory");
  }
}
__device__ __forceinline__ void cp_commit_and_wait() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Where the rows of a stage lie in one array: its row r starts at element
// base + r * step. Batched, the stage has W rows in each lane and its
// global row r, row i = r % W of lane l = r / W, starts at element
// l * lane + base + i * step.
template <bool Batched>
struct RowMap {
  long long base;
  long long step;
  long long lane;
  unsigned W;
  __device__ __forceinline__ long long at(unsigned r) const {
    if constexpr (Batched) {
      const unsigned l = r / W;
      return (long long)l * lane + base + (long long)(r - l * W) * step;
    } else {
      return base + (long long)r * step;
    }
  }
};

// the widest copy (16, 8 or sizeof(T) bytes) that every row of `cols`
// elements of the map, from the array at `p`, is aligned for
template <typename T, typename Map>
__device__ __forceinline__ int copy_bytes(const T* p, const Map& map,
                                          int cols) {
  const unsigned long long bits =
      (unsigned long long)p
      | (unsigned long long)(map.base * (long long)sizeof(T))
      | (unsigned long long)(map.step * (long long)sizeof(T))
      | (unsigned long long)(map.lane * (long long)sizeof(T))
      | (unsigned long long)((long long)cols * (long long)sizeof(T));
  if (bits % 16 == 0) return 16;
  if (bits % 8 == 0) return 8;
  return (int)sizeof(T);
}

// dst[r][0..width) <- row r0 + r of the map in src, columns 0..K, for r <
// rows_valid; zeros in the columns K .. width and in the rows up to
// `tile`; dst rows are ld elements apart. Every thread of the block copies
// its share (batched, one division a row; none a copy).
template <typename T, int BYTES, typename Map>
__device__ __forceinline__ void load_rows_w(T* dst, int ld, int width,
                                            const T* src, const Map& map,
                                            unsigned r0, int rows_valid,
                                            int tile, int K) {
  if constexpr (BYTES >= (int)sizeof(T)) {
    constexpr int E = BYTES / (int)sizeof(T);
    const int vpr = width / E;
    const int tpr = vpr < kThreads ? vpr : kThreads;   // threads to a row
    const int rstep = kThreads / tpr;                  // rows in flight
    const int lr = threadIdx.x / tpr, lj = threadIdx.x - lr * tpr;
    if (lr >= rstep) return;                       // past the last whole row
    for (int r = lr; r < tile; r += rstep) {
      const T* srow = r < rows_valid ? src + map.at(r0 + r) : src;
      T* drow = dst + (size_t)r * ld;
      for (int j = lj; j < vpr; j += tpr) {
        const bool ok = r < rows_valid && j * E < K;
        cp_async<BYTES>(drow + j * E, ok ? srow + j * E : src, ok);
      }
    }
  }
}

template <typename T, typename Map>
__device__ __forceinline__ void load_rows(T* dst, int ld, int width,
                                          const T* src, const Map& map,
                                          unsigned r0, int rows_valid,
                                          int tile, int K) {
  switch (copy_bytes(src, map, K)) {
    case 16:
      load_rows_w<T, 16>(dst, ld, width, src, map, r0, rows_valid, tile, K);
      break;
    case 8:
      load_rows_w<T, 8>(dst, ld, width, src, map, r0, rows_valid, tile, K);
      break;
    default:
      load_rows_w<T, 4>(dst, ld, width, src, map, r0, rows_valid, tile, K);
  }
}

// dst[0..4) <- v[0..4) in device memory, the columns below `valid` only;
// one 16-byte store where all four are valid and dst is aligned for it
__device__ __forceinline__ void store4(float* dst, const float (&v)[4],
                                       int valid) {
  if (valid >= 4 && ((uintptr_t)dst & 15) == 0) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < valid) dst[j] = v[j];
  }
}
__device__ __forceinline__ void store4(double* dst, const double (&v)[4],
                                       int valid) {
  if (valid >= 4 && ((uintptr_t)dst & 15) == 0) {
    *reinterpret_cast<double2*>(dst) = make_double2(v[0], v[1]);
    *reinterpret_cast<double2*>(dst + 2) = make_double2(v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < valid) dst[j] = v[j];
  }
}

// --- the slabs' barriers (mbarrier) and bulk copies

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(unsigned bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(arrivals) : "memory");
}
// one arrival that also announces `bytes` of copies to come
__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}
// wait until the barrier's phase of parity `parity` is complete
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}
// `bytes` (a multiple of 16, both ends 16-byte aligned) from device to
// shared memory, reported to the barrier when they have landed
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// One product [T, K] x [K, N] of a step, as the caller lays it out for the
// launch that runs it: the packed right operand [passes, Kp, cw] (the column
// chunks of the passes one after the other, zero rows where the left operand
// has padding columns, zero columns past N), and how the tile's nrg row
// groups of TM rows, a pass's cpp column groups of 4 and the rows of K are
// dealt to the threads (nrg * cpp * ks <= kThreads). Where a thread owns one
// row (TM = 1) and threads are left over, ks of them share an output: they
// split the rows of K of every slab between them and add up at the end.
template <typename T>
struct Product {
  const T* w;
  int Kp;             // rows of the right operand (a multiple of 4)
  int cw;             // columns of one pass's chunk
  int passes;
  int cpp;            // column groups of a pass
  int ks;             // threads that share an output (split K)
};

// The products and the shape of one stage. Backward: abtq [c n, n+m]
// (ab_bwd, the children's blocks stacked), d [m, m] (rinv^T), q [2 m, n]
// (k_s on top of sumapb^T). Forward: u [n, m] (k_s^T), xc [n+m, c n]
// (ab_fwd, the children's blocks side by side).
template <typename T>
struct Stage {
  Product<T> bwd[3];
  Product<T> fwd[2];
  long long a;        // first row of the stage in a lane
  long long a2;       // first row of the stage below
  unsigned W;         // rows of the stage in a lane
  int c;
};

// The ring of slabs of a block. The weights do not depend on the tile, so
// the slabs of a whole step (every tile the block runs, every product,
// every pass) form one stream. The block's last warp is the producer: one
// of its threads starts one bulk copy a slab, as soon as the slab's slot is
// empty; a slot's `full` barrier flips when the bytes have landed, its
// `empty` barrier when every multiplying warp has arrived there after its
// last read. The multiplying warps wait for `full`, multiply, arrive at
// `empty`: no barrier of the whole block, and no work on the copy, stands
// between two slabs.
template <typename T>
struct Ring {
  T* slabs;
  T* partial;             // the partial sums of a split product, at the end
  unsigned full, empty;   // kRing barriers each, one a slot
  int slab_elems;         // elements of one slot
  int count;              // slabs copied (producer) or multiplied so far
  int turn;               // which half of `partial` the next product takes
};

// Once a kernel, by every thread of the block: the barriers, and zeros in
// the row arrays, which lie behind the slabs (their padding columns are
// read, never written).
template <typename T>
__device__ __forceinline__ void ring_init(Ring<T>& g, unsigned char* smem,
                                          size_t smem_bytes, int ldb) {
  constexpr int KS = kSlabRowBytes / (int)sizeof(T);
  g.full = smem_addr(smem);
  g.empty = g.full + 8 * kRing;
  g.slabs = reinterpret_cast<T*>(smem + kHeaderBytes);
  g.partial = reinterpret_cast<T*>(smem + smem_bytes) - 2 * kThreads * 4;
  g.slab_elems = KS * ldb;
  g.count = g.turn = 0;
  const size_t rows_at =
      kHeaderBytes + (size_t)kRing * g.slab_elems * sizeof(T);
  float4* z = reinterpret_cast<float4*>(smem);
  for (size_t i = rows_at / 16 + threadIdx.x; i < smem_bytes / 16;
       i += kBlock)
    z[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (threadIdx.x == 0) {
    for (int i = 0; i < kRing; ++i) {
      mbar_init(g.full + 8 * i, 1);
      mbar_init(g.empty + 8 * i, kThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The producer thread copies the slabs of `tiles` tiles of the products
// prod[0..np).
template <typename T>
__device__ __forceinline__ void produce(Ring<T>& g, const Product<T>* prod,
                                        int np, long long tiles) {
  constexpr int KS = kSlabRowBytes / (int)sizeof(T);
#pragma unroll 1
  for (long long t = 0; t < tiles; ++t)
#pragma unroll 1
    for (int i = 0; i < np; ++i) {
      const Product<T> P = prod[i];
#pragma unroll 1
      for (int pass = 0; pass < P.passes; ++pass)
#pragma unroll 1
        for (int k0 = 0; k0 < P.Kp; k0 += KS) {
          const int slot = g.count % kRing;
          if (g.count >= kRing)         // the slot's last slab is done with
            mbar_wait(g.empty + 8 * slot,
                      (unsigned)(g.count / kRing - 1) & 1u);
          const int rows = P.Kp - k0 < KS ? P.Kp - k0 : KS;
          const unsigned bytes = (unsigned)(rows * P.cw * (int)sizeof(T));
          mbar_expect(g.full + 8 * slot, bytes);
          bulk_copy(g.slabs + (size_t)slot * g.slab_elems,
                    P.w + ((size_t)pass * P.Kp + k0) * P.cw, bytes,
                    g.full + 8 * slot);
          ++g.count;
        }
    }
}

// a barrier of the multiplying threads (the producer warp stays out)
__device__ __forceinline__ void sync_multipliers() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kThreads) : "memory");
}

// Where a thread sits in the passes of a product. A warp multiplies as a
// whole or not at all: a thread past the last row group, in a warp that has
// work, repeats the last row group and drops its results.
struct Seat {
  int nrg;       // row groups of the tile
  int rg, cg;    // its row group (rows rg + i * nrg) and its column group
  int part;      // which of the ks shares of the rows of K it sums
  bool active;   // it holds the results (share 0 of a seat that exists)
  bool works;    // its warp multiplies
};

template <typename T>
__device__ __forceinline__ Seat seat(const Product<T>& P, int nrg) {
  Seat s;
  const int q = threadIdx.x / P.cpp;       // share * nrg + row group
  const bool exists = q < nrg * P.ks;
  s.nrg = nrg;
  s.cg = threadIdx.x - q * P.cpp;
  s.part = exists ? q / nrg : P.ks - 1;
  s.rg = exists ? q - s.part * nrg : nrg - 1;
  s.active = exists && s.part == 0;
  s.works = (int)(threadIdx.x & ~31u) / P.cpp < nrg * P.ks;
  return s;
}

// acc = A[rows of the thread][0..Kp) * B[0..Kp)[columns of the thread] for
// the next pass of the stream (B the chunk [Kp, cw] of product P), A a
// shared-memory row array (leading dimension lda, padding columns zero).
// Every multiplying thread runs it; A was written before the last barrier.
// Where ks threads share an output, each sums every ks-th group of rows of
// K, and share 0 adds the others' sums up, in their order, at the end.
template <typename T, int TM>
__device__ __forceinline__ void multiply(T (&acc)[TM][4], const T* A, int lda,
                                         const Product<T>& P, const Seat& s,
                                         Ring<T>& g) {
  using V = typename Vec<T>::type;
  constexpr int KV = Vec<T>::kLen;
  constexpr int KS = kSlabRowBytes / (int)sizeof(T);
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = T(0);
  const int cw = P.cw;
  const size_t rstep = (size_t)s.nrg * lda;
  // the thread's groups of KV rows within a slab: first, and from one to
  // the next
  const int kfirst = TM == 1 ? s.part * KV : 0;
  const int kstep = TM == 1 ? P.ks * KV : KV;
#pragma unroll 1
  for (int k0 = 0; k0 < P.Kp; k0 += KS) {
    const int slot = g.count % kRing;
    mbar_wait(g.full + 8 * slot,
              (unsigned)(g.count / kRing) & 1u);        // the slab has landed
    if (s.works) {
      const int kk = P.Kp - k0 < KS ? P.Kp - k0 : KS;   // a multiple of 4
      const T* bs = g.slabs + (size_t)slot * g.slab_elems + s.cg * 4;
      const T* ar = A + (size_t)s.rg * lda + k0;
      // two groups of KV rows of K in registers: while one is
      // multiplied the loads of the next are in flight (a third group
      // spills, and costs more than it hides)
      V av[2][TM];
      T bv[2][KV][4];
      auto load = [&](int buf, int k) {
#pragma unroll
        for (int r = 0; r < TM; ++r)
          av[buf][r] = *reinterpret_cast<const V*>(ar + r * rstep + k);
#pragma unroll
        for (int q = 0; q < KV; ++q)
          load4(bs + (size_t)(k + q) * cw, bv[buf][q]);
      };
      auto fma_group = [&](int buf) {
#pragma unroll
        for (int q = 0; q < KV; ++q)
#pragma unroll
          for (int r = 0; r < TM; ++r) {
            const T a = elem(av[buf][r], q);
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[r][j] = fmadd(a, bv[buf][q][j], acc[r][j]);
          }
      };
      int k = kfirst;
      if (k < kk) load(0, k);
#pragma unroll 1
      for (; k + kstep < kk; k += 2 * kstep) {
        load(1, k + kstep);
        fma_group(0);
        if (k + 2 * kstep < kk) load(0, k + 2 * kstep);
        fma_group(1);
      }
      if (k < kk) fma_group(0);
    }
    ++g.count;
    __syncwarp();                     // the warp is done with the slot
    if ((threadIdx.x & 31) == 0) mbar_arrive(g.empty + 8 * slot);
  }
  if constexpr (TM == 1) {
    if (P.ks > 1) {
      // every thread leaves its sums at its own place; the halves of
      // `partial` take turns, so one barrier a product is enough
      T* mine = g.partial + ((size_t)g.turn * kThreads + threadIdx.x) * 4;
      g.turn ^= 1;
#pragma unroll
      for (int j = 0; j < 4; ++j) mine[j] = acc[0][j];
      sync_multipliers();
      if (s.active)
        for (int part = 1; part < P.ks; ++part) {
          const T* theirs = mine + (size_t)part * s.nrg * P.cpp * 4;
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[0][j] += theirs[j];
        }
    }
  }
}

// The arrays of one apply, and their lanes: x_in, x_out and q_buf are
// sx elements apart, u_in, u_out and d_buf su, x0 s0.
template <typename T>
struct Io {
  const T* x_in;
  const T* u_in;
  const T* x0;
  T* x_out;
  T* u_out;
  T* q_buf;
  T* d_buf;
  long long sx, su, s0;
};

// the maps of a stage's rows: in x (the parents' rows), in u, and of the
// children's rows as one row of c n
template <bool B, typename T>
__device__ __forceinline__ RowMap<B> x_rows(const Stage<T>& st,
                                            const Io<T>& io, int n) {
  return RowMap<B>{st.a * n, n, io.sx, st.W};
}
template <bool B, typename T>
__device__ __forceinline__ RowMap<B> u_rows(const Stage<T>& st,
                                            const Io<T>& io, int m) {
  return RowMap<B>{st.a * m, m, io.su, st.W};
}
template <bool B, typename T>
__device__ __forceinline__ RowMap<B> child_rows(const Stage<T>& st,
                                                const Io<T>& io, int n) {
  return RowMap<B>{st.a2 * n, (long long)st.c * n, io.sx, st.W};
}

// One backward step on the global rows w0 .. w0 + rows of the stage: reads
// the children's q from q_child (times sign), x_in and u_in; writes q_buf
// and d_buf. B: the rows of several lanes (RowMap).
template <typename T, int TM, bool B>
__device__ __forceinline__ void backward_tile(
    T* smem_rows, const Stage<T>& st, int n, int m, int tile, Ring<T>& ring,
    const Io<T>& io, const T* q_child, T sign, unsigned w0, int rows) {
  const int Nc = st.c * n, F = n + m, m4 = round_up(m, 4);
  const int ldq = lead_dim(Nc), ldn = lead_dim(n), ldm = lead_dim(m);
  const int ldg = lead_dim(2 * m4);
  T* const Q = smem_rows;                      // the children's q
  T* const SA = Q + (size_t)tile * ldq;        // x, then sumA'q - x
  T* const Vv = SA + (size_t)tile * ldn;       // u, then v = u - sumB'q
  T* const GD = Vv + (size_t)tile * ldm;       // [g | d], g = d - v

  load_rows(Q, ldq, ldq, q_child, child_rows<B>(st, io, n), w0, rows, tile, Nc);
  load_rows(SA, ldn, ldn, io.x_in, x_rows<B>(st, io, n), w0, rows, tile, n);
  load_rows(Vv, ldm, ldm, io.u_in, u_rows<B>(st, io, m), w0, rows, tile, m);
  cp_commit_and_wait();
  sync_multipliers();

  T acc[TM][4];
  {   // abtq = q_child ab_bwd: its first n columns are sumA'q, the rest sumB'q
    const Product<T> P = st.bwd[0];
    const Seat s = seat(P, tile / TM);
    for (int pass = 0; pass < P.passes; ++pass) {
      multiply<T, TM>(acc, Q, ldq, P, s, ring);
      if (s.active) {
#pragma unroll
        for (int r = 0; r < TM; ++r) {
          const int row = s.rg + r * s.nrg;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int col = pass * P.cw + s.cg * 4 + j;
            if (col < n) {
              T* e = SA + (size_t)row * ldn + col;
              *e = sign * acc[r][j] - *e;                 // sumA'q - x
            } else if (col < F) {
              T* e = Vv + (size_t)row * ldm + (col - n);
              *e = *e - sign * acc[r][j];                 // v = u - sumB'q
            }
          }
        }
      }
    }
  }
  sync_multipliers();
  {   // d = v rinv^T ; g = d - v
    const Product<T> P = st.bwd[1];
    const Seat s = seat(P, tile / TM);
    for (int pass = 0; pass < P.passes; ++pass) {
      multiply<T, TM>(acc, Vv, ldm, P, s, ring);
      if (s.active) {
        const int col0 = pass * P.cw + s.cg * 4;
#pragma unroll
        for (int r = 0; r < TM; ++r) {
          const int row = s.rg + r * s.nrg;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (col0 + j < m) {
              GD[(size_t)row * ldg + m4 + col0 + j] = acc[r][j];
              GD[(size_t)row * ldg + col0 + j] =
                  acc[r][j] - Vv[(size_t)row * ldm + col0 + j];
            }
          }
          if (row < rows)
            store4(io.d_buf + u_rows<B>(st, io, m).at(w0 + row) + col0, acc[r],
                   m - col0);
        }
      }
    }
  }
  sync_multipliers();
  {   // q = [g | d] [k_s ; sumapb^T] + (sumA'q - x)
    const Product<T> P = st.bwd[2];
    const Seat s = seat(P, tile / TM);
    for (int pass = 0; pass < P.passes; ++pass) {
      multiply<T, TM>(acc, GD, ldg, P, s, ring);
      if (s.active) {
        const int col0 = pass * P.cw + s.cg * 4;
#pragma unroll
        for (int r = 0; r < TM; ++r) {
          const int row = s.rg + r * s.nrg;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (col0 + j < n) acc[r][j] += SA[(size_t)row * ldn + col0 + j];
          if (row < rows)
            store4(io.q_buf + x_rows<B>(st, io, n).at(w0 + row) + col0, acc[r],
                   n - col0);
        }
      }
    }
  }
  // the next tile's rows land in the row arrays: everyone is done with them
  sync_multipliers();
}

// One forward step on the global rows w0 .. w0 + rows of the stage: reads
// the parents' x from x_out and d_buf; writes the parents' u and the
// children's x. B: the rows of several lanes (RowMap).
template <typename T, int TM, bool B>
__device__ __forceinline__ void forward_tile(
    T* smem_rows, const Stage<T>& st, int n, int m, int tile, Ring<T>& ring,
    const Io<T>& io, unsigned w0, int rows) {
  const int Nc = st.c * n, n4 = round_up(n, 4), m4 = round_up(m, 4);
  const int ldx = lead_dim(n4 + m4);
  T* const XU = smem_rows;                     // [x | d, then u]

  load_rows(XU, ldx, n4, io.x_out, x_rows<B>(st, io, n), w0, rows, tile, n);
  load_rows(XU + n4, ldx, ldx - n4, io.d_buf, u_rows<B>(st, io, m), w0, rows,
            tile, m);
  cp_commit_and_wait();
  sync_multipliers();

  T acc[TM][4];
  {   // u = x k_s^T + d
    const Product<T> P = st.fwd[0];
    const Seat s = seat(P, tile / TM);
    for (int pass = 0; pass < P.passes; ++pass) {
      multiply<T, TM>(acc, XU, ldx, P, s, ring);
      if (s.active) {
        const int col0 = pass * P.cw + s.cg * 4;
#pragma unroll
        for (int r = 0; r < TM; ++r) {
          const int row = s.rg + r * s.nrg;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (col0 + j < m) {
              T* e = XU + (size_t)row * ldx + n4 + col0 + j;
              acc[r][j] += *e;
              *e = acc[r][j];
            }
          }
          if (row < rows)
            store4(io.u_out + u_rows<B>(st, io, m).at(w0 + row) + col0, acc[r],
                   m - col0);
        }
      }
    }
  }
  sync_multipliers();
  {   // x_child = [x u] ab_fwd
    const Product<T> P = st.fwd[1];
    const Seat s = seat(P, tile / TM);
    for (int pass = 0; pass < P.passes; ++pass) {
      multiply<T, TM>(acc, XU, ldx, P, s, ring);
      if (s.active) {
        const int col0 = pass * P.cw + s.cg * 4;
#pragma unroll
        for (int r = 0; r < TM; ++r) {
          const int row = s.rg + r * s.nrg;
          if (row < rows)
            store4(io.x_out + child_rows<B>(st, io, n).at(w0 + row) + col0,
                   acc[r], Nc - col0);
        }
      }
    }
  }
  // the next tile's rows land in XU: everyone is done with it
  sync_multipliers();
}

// The ghost rows of both outputs: nx elements of x from x in every lane
// (lanes sx apart), nu of u from u (lanes su apart).
template <typename T>
struct Ghosts {
  T* x;
  long long nx, sx;
  T* u;
  long long nu, su;
  int lanes;
};

template <typename T>
__device__ __forceinline__ void zero_ghosts(const Ghosts<T>& g) {
  const long long start = (long long)blockIdx.x * kBlock + threadIdx.x;
  const long long step = (long long)gridDim.x * kBlock;
  for (long long i = start; i < g.lanes * g.nx; i += step) {
    const long long l = g.sx ? i / g.nx : 0;
    g.x[l * g.sx + (i - l * g.nx)] = T(0);
  }
  for (long long i = start; i < g.lanes * g.nu; i += step) {
    const long long l = g.su ? i / g.nu : 0;
    g.u[l * g.su + (i - l * g.nu)] = T(0);
  }
}

// how many of the tiles of R rows are t0, t0 + stride, ...
__device__ __forceinline__ long long tiles_of(long long R, int tile,
                                              long long t0,
                                              long long stride) {
  const long long tiles = (R + tile - 1) / tile;
  return t0 >= tiles ? 0 : (tiles - t0 + stride - 1) / stride;
}

// The multiplying threads run one step of one stage over the tiles t0,
// t0 + stride, ... of its global rows r_begin .. r_begin + R.
template <typename T, int TM, bool B>
__device__ __forceinline__ void run_step(
    Ring<T>& ring, const Stage<T>& st, int n, int m, int tile, bool forward,
    const Io<T>& io, const T* q_child, T sign, unsigned r_begin, unsigned R,
    long long t0, long long stride) {
  T* rows_smem = ring.slabs + (size_t)kRing * ring.slab_elems;
  const long long tiles = ((long long)R + tile - 1) / tile;
#pragma unroll 1
  for (long long t = t0; t < tiles; t += stride) {
    const unsigned w = (unsigned)(t * tile);
    const int rows = (int)(R - w < (unsigned)tile ? R - w : tile);
    if (forward)
      forward_tile<T, TM, B>(rows_smem, st, n, m, tile, ring, io,
                             r_begin + w, rows);
    else
      backward_tile<T, TM, B>(rows_smem, st, n, m, tile, ring, io, q_child,
                              sign, r_begin + w, rows);
  }
}

// blocks of one SM that the registers of a thread tile leave room for
__host__ __device__ constexpr int min_blocks(int tm, int elem_size) {
  return elem_size == 8 ? (tm >= 4 ? 1 : 2) : (tm >= 8 ? 1 : 2);
}

// ---------------------------------------------------------------- kernels

// One step of one stage, backward or forward, over the rows of all
// `lanes` lanes (B: more than one); the blocks walk over its tiles. The
// last forward launch also zeroes the ghost rows.
template <typename T, int TM, bool B>
__global__ void __launch_bounds__(kBlock, min_blocks(TM, sizeof(T)))
stage_kernel(const __grid_constant__ Stage<T> st, int n, int m, int tile,
             int forward, int lanes, Io<T> io, const T* q_child, T sign,
             Ghosts<T> ghosts, int ldb, unsigned smem_bytes) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  zero_ghosts(ghosts);
  Ring<T> ring;
  ring_init(ring, smem_raw, smem_bytes, ldb);
  const unsigned R = (unsigned)lanes * st.W;
  if (threadIdx.x >= kThreads) {
    if (threadIdx.x == kThreads)
      produce(ring, forward ? st.fwd : st.bwd, forward ? 2 : 3,
              tiles_of(R, tile, blockIdx.x, gridDim.x));
    return;
  }
  run_step<T, TM, B>(ring, st, n, m, tile, forward != 0, io, q_child, sign,
                     0u, R, blockIdx.x, gridDim.x);
}

// The stages of the apex launch.
template <typename T>
struct Apex {
  Stage<T> st[kMaxApex];
  int count;
  int leaf_stage;     // the stage whose children are the leaves
};

// The top of the tree, block b for lane b (B: more than one lane):
// backward steps of stages count-1 .. 0, then forward steps of stages
// 0 .. count-1. What one step writes to device memory the next reads after
// the multiplying threads' barrier; the producer runs ahead with the
// weights of the steps to come.
template <typename T, int TM, bool B>
__global__ void __launch_bounds__(kBlock) apex_kernel(
    const __grid_constant__ Apex<T> ax, int n, int m, int tile, Io<T> io,
    Ghosts<T> ghosts, int ldb, unsigned smem_bytes) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  zero_ghosts(ghosts);
  Ring<T> ring;
  ring_init(ring, smem_raw, smem_bytes, ldb);
  const bool producer = threadIdx.x >= kThreads;
  if (producer && threadIdx.x != kThreads) return;
  const unsigned lane = B ? blockIdx.x : 0u;
  if (!producer)
    for (int i = threadIdx.x; i < n; i += kThreads)
      io.x_out[lane * io.sx + i] = io.x0[lane * io.s0 + i];
  // steps 0 .. count-1 go up, steps count .. 2 count - 1 come down again
#pragma unroll 1
  for (int i = 0; i < 2 * ax.count; ++i) {
    const bool forward = i >= ax.count;
    const int k = forward ? i - ax.count : ax.count - 1 - i;
    const Stage<T>& st = ax.st[k];
    if (producer) {
      produce(ring, forward ? st.fwd : st.bwd, forward ? 2 : 3,
              tiles_of(st.W, tile, 0, 1));
    } else {
      const bool leaves = (k == ax.leaf_stage);
      sync_multipliers();             // what the step before wrote is there
      run_step<T, TM, B>(ring, st, n, m, tile, forward, io,
                         leaves ? io.x_in : io.q_buf, leaves ? T(-1) : T(1),
                         lane * st.W, st.W, 0, 1);
    }
  }
}

// ------------------------------------------------------------------- host

// allow a kernel all the dynamic shared memory a block may use, once on
// every device (`done` has a bit a device; two threads that come first at
// once both ask, which does no harm)
template <typename KernelT>
cudaError_t allow_smem(KernelT kernel, std::atomic<uint64_t>& done) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const uint64_t bit = uint64_t(1) << (device & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

// columns of a slab of a launch that runs the products prod[0..np): those
// of the widest chunk
template <typename T>
inline int slab_cols(const Product<T>* prod, int np) {
  int cols = 0;
  for (int i = 0; i < np; ++i)
    if (prod[i].cw > cols) cols = prod[i].cw;
  return cols;
}

// a row tile the kernels take: whole row groups, at most one a thread
inline bool tile_ok(int tile, int tm) {
  return tile >= tm && tile % tm == 0 && tile / tm <= kThreads;
}

template <typename T, int TM, bool B>
cudaError_t start_stage(const Stage<T>& st, int n, int m, int tile, int grid,
                        bool forward, int lanes, cudaStream_t stream,
                        const Io<T>& io, const T* q_child, T sign,
                        const Ghosts<T>& ghosts, int ldb, size_t bytes) {
  static std::atomic<uint64_t> allowed{0};
  cudaError_t err = allow_smem(stage_kernel<T, TM, B>, allowed);
  if (err != cudaSuccess) return err;
  stage_kernel<T, TM, B><<<grid, kBlock, bytes, stream>>>(
      st, n, m, tile, forward ? 1 : 0, lanes, io, q_child, sign, ghosts, ldb,
      (unsigned)bytes);
  return cudaGetLastError();
}

template <typename T, bool B>
cudaError_t start_apex(const Apex<T>& ax, int n, int m, int tile, int lanes,
                       cudaStream_t stream, const Io<T>& io,
                       const Ghosts<T>& ghosts, int ldb, size_t bytes) {
  static std::atomic<uint64_t> allowed{0};
  cudaError_t err = allow_smem(apex_kernel<T, kApexTm, B>, allowed);
  if (err != cudaSuccess) return err;
  apex_kernel<T, kApexTm, B><<<lanes, kBlock, bytes, stream>>>(
      ax, n, m, tile, io, ghosts, ldb, (unsigned)bytes);
  return cudaGetLastError();
}

// one launch of a stage step: the kernel of one lane, or of a batch
template <typename T, int TM>
cudaError_t launch_stage(const Stage<T>& st, int n, int m, int tile, int grid,
                         bool forward, int lanes, cudaStream_t stream,
                         const Io<T>& io, const T* q_child, T sign,
                         const Ghosts<T>& ghosts) {
  const int ldb = slab_cols(forward ? st.fwd : st.bwd, forward ? 2 : 3);
  const size_t bytes = kHeaderBytes
      + smem_elems(forward, tile, TM, ldb, n, m, st.c, sizeof(T)) * sizeof(T);
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  return lanes == 1
      ? start_stage<T, TM, false>(st, n, m, tile, grid, forward, lanes,
                                  stream, io, q_child, sign, ghosts, ldb,
                                  bytes)
      : start_stage<T, TM, true>(st, n, m, tile, grid, forward, lanes,
                                 stream, io, q_child, sign, ghosts, ldb,
                                 bytes);
}

// The schedule of one apply, planned by the caller: stages 0 .. apex_stages-1
// run in the apex launch on tiles of apex_tile rows; stage k >= apex_stages
// runs one launch in each direction with thread tile tm[k] (8, 4, 2 or 1;
// float64 up to 4) rows, row tile tile[k] and grid[k] blocks, entries
// [0, ns_nl) backward and [ns_nl, 2 ns_nl) forward. weights[5 k + j] is
// product j's packed right operand of stage k (abtq, d, q, u, xc), packed
// for the thread tile and row tile of the launch that runs it, and
// products[4 (5 k + j) ..] says how: its Kp, passes, cpp and ks (Product).
// `lanes` lanes (x, x_out, q_buf sx elements apart, u, u_out, d_buf su,
// x0 s0) run in every launch, the apex a block a lane.
// Error codes besides CUDA's: -2 = the schedule is not one this library
// can launch (a thread tile it has no kernel for, a tile that is no
// multiple of it, too many apex stages, no apex stage, lanes that overlap,
// more rows than a 32-bit index, or a product whose layout does not fit
// the tile's row arrays or the block's threads).
template <typename T>
int run_sweep(const T* x_in, const T* u_in, const T* x0, T* x_out, T* u_out,
              T* q_buf, T* d_buf, const void* const* weights,
              const int* products, const long long* stage_start,
              const long long* stage_child, int num_stages, int n, int m,
              long long np_pad, long long nl_pad, int lanes, long long sx,
              long long su, long long s0, int apex_stages, int apex_tile,
              const int* tm, const int* tile, const int* grid,
              cudaStream_t stream) {
  const int ns_nl = num_stages - 1;
  const long long N = stage_start[num_stages];
  const long long NL = stage_start[num_stages - 1];
  if (apex_stages < 1 || apex_stages > kMaxApex || apex_stages > ns_nl ||
      !tile_ok(apex_tile, kApexTm))
    return -2;
  if (lanes < 1 ||
      (lanes > 1 && (sx < np_pad * n || su < nl_pad * m || s0 < n)))
    return -2;
  for (int k = 0; k < ns_nl; ++k)
    if ((long long)lanes * (stage_start[k + 1] - stage_start[k])
        >= (1LL << 31))
      return -2;
  if (lanes == 1) sx = su = s0 = 0;     // one lane: no lane offsets
  const int n4 = round_up(n, 4), m4 = round_up(m, 4);
  // product j of stage k as the caller laid it out, held against what the
  // launch that runs it (row tile, thread tile) needs: Kp rows for the
  // padded columns of the left operand, all `width` columns covered, a
  // thread for every seat
  bool fits = true;
  auto product = [&](int k, int j, int Kp, int width, int tile_, int tm_) {
    const int* p = products + 4 * (5 * k + j);
    const Product<T> P{static_cast<const T*>(weights[5 * k + j]), p[0],
                       4 * p[2], p[1], p[2], p[3]};
    const bool split_ok =
        P.ks == 1 || (tm_ == 1 && P.ks > 1 && P.ks <= kMaxSplit);
    fits = fits && P.Kp == Kp && P.passes >= 1 && P.cpp >= 1
           && P.cpp <= kMaxCpp && (long long)P.passes * P.cw >= width
           && split_ok && (tile_ / tm_) * P.cpp * P.ks <= kThreads;
    return P;
  };
  // stage k, its products laid out for the launches (row tile, thread
  // tile) that run its backward and its forward step
  auto stage = [&](int k, int tile_b, int tm_b, int tile_f, int tm_f) {
    Stage<T> st;
    st.a = stage_start[k];
    st.W = (unsigned)(stage_start[k + 1] - st.a);
    st.a2 = stage_start[k + 1];
    st.c = (int)stage_child[k];
    st.bwd[0] = product(k, 0, round_up(st.c * n, 4), n + m, tile_b, tm_b);
    st.bwd[1] = product(k, 1, m4, m, tile_b, tm_b);
    st.bwd[2] = product(k, 2, 2 * m4, n, tile_b, tm_b);
    st.fwd[0] = product(k, 3, n4, m, tile_f, tm_f);
    st.fwd[1] = product(k, 4, n4 + m4, st.c * n, tile_f, tm_f);
    return st;
  };
  const Ghosts<T> ghosts{x_out + N * n, (np_pad - N) * n, sx,
                         u_out + NL * m, (nl_pad - NL) * m, su, lanes};
  const Ghosts<T> none{nullptr, 0, 0, nullptr, 0, 0, 0};
  cudaError_t err;

  const Io<T> io{x_in, u_in, x0, x_out, u_out, q_buf, d_buf, sx, su, s0};
  // one launch of stage k in one direction
  auto launch = [&](int k, bool forward) -> int {
    // backward, the last nonleaf stage reads the leaves' q = -x straight
    // from x_in; every other stage reads the q rows the stage below wrote
    const bool leaves = (k == ns_nl - 1);
    const T* q_child = leaves ? x_in : q_buf;
    const T sign = leaves ? T(-1) : T(1);
    const Ghosts<T>& gh = (forward && leaves) ? ghosts : none;
    const int eb = k, ef = ns_nl + k, e = forward ? ef : eb;
    if (!tile_ok(tile[eb], tm[eb]) || !tile_ok(tile[ef], tm[ef]) ||
        grid[e] < 1)
      return -2;
    const Stage<T> st = stage(k, tile[eb], tm[eb], tile[ef], tm[ef]);
    if (!fits) return -2;
    switch (tm[e]) {
      case 1:
        return (int)launch_stage<T, 1>(st, n, m, tile[e], grid[e], forward,
                                       lanes, stream, io, q_child, sign, gh);
      case 2:
        return (int)launch_stage<T, 2>(st, n, m, tile[e], grid[e], forward,
                                       lanes, stream, io, q_child, sign, gh);
      case 4:
        return (int)launch_stage<T, 4>(st, n, m, tile[e], grid[e], forward,
                                       lanes, stream, io, q_child, sign, gh);
      case 8:
        if constexpr (sizeof(T) == 4)
          return (int)launch_stage<T, 8>(st, n, m, tile[e], grid[e], forward,
                                         lanes, stream, io, q_child, sign,
                                         gh);
        return -2;
      default:
        return -2;
    }
  };

  // backward sweep below the apex
  for (int k = ns_nl - 1; k >= apex_stages; --k)
    if (int rc = launch(k, false)) return rc;

  // the apex: up to the root and down again
  {
    Apex<T> ax;
    ax.count = apex_stages;
    ax.leaf_stage = ns_nl - 1;
    size_t elems = 0;
    int ldb = 0;
    for (int k = 0; k < apex_stages; ++k) {
      ax.st[k] = stage(k, apex_tile, kApexTm, apex_tile, kApexTm);
      for (int fwd = 0; fwd < 2; ++fwd) {
        const int cols = fwd ? slab_cols(ax.st[k].fwd, 2)
                             : slab_cols(ax.st[k].bwd, 3);
        if (cols > ldb) ldb = cols;
        const size_t e = (size_t)apex_tile
                         * row_elems(fwd != 0, n, m, ax.st[k].c);
        if (e > elems) elems = e;
      }
    }
    elems += (size_t)kRing * (kSlabRowBytes / sizeof(T)) * ldb
             + partial_elems(kApexTm);
    const size_t bytes = kHeaderBytes + elems * sizeof(T);
    if (!fits) return -2;
    if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
    const Ghosts<T>& gh = apex_stages == ns_nl ? ghosts : none;
    err = lanes == 1
        ? start_apex<T, false>(ax, n, m, apex_tile, lanes, stream, io, gh,
                               ldb, bytes)
        : start_apex<T, true>(ax, n, m, apex_tile, lanes, stream, io, gh,
                              ldb, bytes);
    if (err != cudaSuccess) return (int)err;
  }

  // forward rollout below the apex
  for (int k = apex_stages; k < ns_nl; ++k)
    if (int rc = launch(k, true)) return rc;
  return 0;
}

}  // namespace

#define RAOCP_SWEEP_ENTRY(NAME, T)                                           \
  extern "C" int NAME(                                                       \
      const void* x_in, const void* u_in, const void* x0, void* x_out,       \
      void* u_out, void* q_buf, void* d_buf, const void* const* weights,     \
      const int* products, const long long* stage_start,                     \
      const long long* stage_child, int num_stages, int n, int m,            \
      long long np_pad, long long nl_pad, int lanes, long long sx,           \
      long long su, long long s0, int apex_stages, int apex_tile,            \
      const int* tm, const int* tile, const int* grid, void* stream) {       \
    return run_sweep<T>(                                                     \
        static_cast<const T*>(x_in), static_cast<const T*>(u_in),            \
        static_cast<const T*>(x0), static_cast<T*>(x_out),                   \
        static_cast<T*>(u_out), static_cast<T*>(q_buf),                      \
        static_cast<T*>(d_buf), weights, products, stage_start, stage_child, \
        num_stages, n, m, np_pad, nl_pad, lanes, sx, su, s0, apex_stages,    \
        apex_tile, tm, tile, grid, static_cast<cudaStream_t>(stream));       \
  }

RAOCP_SWEEP_ENTRY(raocp_sweep_f32, float)
RAOCP_SWEEP_ENTRY(raocp_sweep_f64, double)

// The dynamic shared memory, in bytes, of a block that runs tiles of `tile`
// rows with thread tile `tm` in one direction of a stage, its slabs `cols`
// columns wide.
extern "C" long long raocp_sweep_smem(int forward, int tile, int tm, int cols,
                                      int n, int m, int c, int elem_size) {
  return (long long)(kHeaderBytes
                     + smem_elems(forward != 0, tile, tm, cols, n, m, c,
                                  (size_t)elem_size) * (size_t)elem_size);
}

extern "C" const char* raocp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
