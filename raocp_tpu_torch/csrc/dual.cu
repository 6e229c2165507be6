// The dual half of a Chambolle-Pock step as one kernel, for NVIDIA Hopper
// (sm_90a): from eta, L z, L z+, alpha2 and the epigraph half-shift to
//
//   mod  = (eta + alpha2 (2 L z+ - L z)) / alpha2 + shift
//   eta+ = alpha2 (mod - proj(mod))
//
// the Moreau form of prox_{alpha2 g*} (reference cache.py:321-393), with
// proj the cone, box and ball projections of ops/prox.py's
// g_conj_projections: the risk's dual cone on e1 (free, zero and
// nonnegative rows, and an SOC block where the risk has one), the
// nonnegative orthant on e2, the SOC of (e3, e4, e5 | e6) and of (e11, e12 |
// e13), and each node's box or ball on e7 and e14.
//
// It replaces no TPU kernel: the JAX package leaves this map to XLA, which
// fuses it (raocp_tpu/solver.py's step). In PyTorch the same map was 169
// launches a step at BASELINE config 4, with mod and proj passing through
// device memory. Here one launch reads each input once and writes eta+
// once; mod and proj stay in registers.
//
// What bounds it on this card: bytes where the dual is large (88,573 nodes
// at n = 100: about 0.46 GB a call, 0.14 ms at 3.35 TB/s), the launch
// itself where it is small (BASELINE config 4: about 25 MB). So the design
// keeps to one pass over memory: a group of G threads (4 to 32, a power of
// two, chosen by the wrapper from the rows' widths) takes one row of one of
// the three row families (nonleaf rows: e1, e2, e7; node rows: e3-e6; leaf
// rows: e11-e14), each family a range of blocks. The group forms the row's
// mod on the fly, keeps the first entries of each part a thread in
// registers (the rest it forms again from memory), reduces the SOC and ball
// norms with shuffles, and writes eta+.
// A thread takes a part's entries V at a time (V from the family's widths
// and the element size alone), as one 16- or 8-byte load where every
// operand of the family allows it (the wrapper checks strides and
// alignment), else one entry at a time at any column stride: the same
// entries in the same order either way, so the bits of eta+ do not depend
// on where its inputs lie in memory.
//
// The arithmetic is the plain twin's (ops/dual.py dual_update_plain), in
// the same order and precision, each operation rounded on its own (no
// contraction into fma, IEEE division and square root); only the order of
// a row's sums differs.
//
// A plain C interface for ctypes: every operand is (address, lane stride,
// row stride, column stride), in elements; the functions return a
// cudaError_t (0 on success), or -2 for arguments the library does not take.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
// the entries of one part of a row that a thread keeps in registers (at
// least one vector). More spill under the 64 registers that four blocks of
// 256 threads an SM leave: on the H100 at BASELINE configs 4 and 5, 8
// entries took 8-45% longer than 2, and 128 registers (two blocks an SM)
// longer still
constexpr int CACHE = 2;

template <int V>
__host__ __device__ constexpr int slots() {
  return CACHE >= V ? CACHE / V : 1;
}

// the dual's parts, in the order of raocp_tpu_torch.core.variables.Dual
enum { E1, E2, E3, E4, E5, E6, E7, E11, E12, E13, E14, PARTS };
// the operands: each part's eta, L z, L z+ and eta+; the half-shift's four
// nonzero parts; the risk masks; the box and ball tables; alpha2
enum {
  ETA = 0, LZ = PARTS, LZN = 2 * PARTS, OUT = 3 * PARTS,
  SH5 = 4 * PARTS, SH6, SH12, SH13,
  FREE, ZERO, SOC_ROWS, SOC_TAIL,
  LO7, HI7, C7, R7, LO14, HI14, C14, R14,
  ALPHA, OPERANDS
};
// the sizes: lanes, rows of each family, part widths, whether the risk has
// an SOC block, and each family's entries a thread takes together, group
// size and whether its operands take vector loads
enum {
  D_LANES, D_ROWS_NL, D_ROWS_NP, D_ROWS_LF, D_Y, D_C7, D_N, D_M, D_C14,
  D_SOC, D_VEC_NL, D_VEC_NP, D_VEC_LF, D_GROUP_NL, D_GROUP_NP, D_GROUP_LF,
  D_ALIGNED_NL, D_ALIGNED_NP, D_ALIGNED_LF, DIMS
};

struct Operand {
  long long p, ls, rs, cs;
};

struct Args {
  Operand op[OPERANDS];
  long long dim[DIMS];
  long long end[3];  // the block ranges' ends: nonleaf, node, leaf rows
  double alpha;      // alpha2 where op[ALPHA] has no address
};

// each operation rounded on its own, as the plain twin's kernels round
__device__ inline float add(float a, float b) { return __fadd_rn(a, b); }
__device__ inline double add(double a, double b) { return __dadd_rn(a, b); }
__device__ inline float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ inline double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ inline float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ inline double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ inline float quo(float a, float b) { return __fdiv_rn(a, b); }
__device__ inline double quo(double a, double b) { return __ddiv_rn(a, b); }
__device__ inline float root(float a) { return __fsqrt_rn(a); }
__device__ inline double root(double a) { return __dsqrt_rn(a); }
__device__ inline float tiny(float) { return 1.17549435e-38f; }
__device__ inline double tiny(double) { return 2.2250738585072014e-308; }

// torch.maximum / torch.minimum: a NaN in either wins
template <typename T>
__device__ __forceinline__ T most(T a, T b) {
  return a != a ? a : (b != b ? b : (a > b ? a : b));
}
template <typename T>
__device__ __forceinline__ T least(T a, T b) {
  return a != a ? a : (b != b ? b : (a < b ? a : b));
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

// V entries from p at column stride cs: one vector load where ``vec``
// holds (unit stride, aligned), else one load an entry
template <typename T, int V>
__device__ __forceinline__ Vec<T, V> load(const T* p, long long cs,
                                          bool vec) {
  if constexpr (V > 1) {
    if (vec) return *reinterpret_cast<const Vec<T, V>*>(p);
  }
  Vec<T, V> x;
#pragma unroll
  for (int i = 0; i < V; ++i) x.v[i] = p[i * cs];
  return x;
}
template <typename T, int V>
__device__ __forceinline__ void store(T* p, long long cs, bool vec,
                                      const Vec<T, V>& x) {
  if constexpr (V > 1) {
    if (vec) {
      *reinterpret_cast<Vec<T, V>*>(p) = x;
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < V; ++i) p[i * cs] = x.v[i];
}

template <typename T>
__device__ __forceinline__ const T* row_at(const Operand& o, long long b,
                                           long long r) {
  return reinterpret_cast<const T*>(o.p) + b * o.ls + r * o.rs;
}

// (e + a (2 lzn - lz)) / a + s
template <typename T>
__device__ __forceinline__ T moreau(T e, T lz, T lzn, T a, T s) {
  return add(quo(add(e, mul(a, sub(mul(T(2), lzn), lz))), a), s);
}

// one row of a part: its three inputs and its output, with column
// strides, and whether its family's operands take vector loads
template <typename T>
struct Row {
  const T *e, *lz, *lzn;
  T* out;
  long long ce, clz, clzn, cout;
  bool vec;
};

template <typename T>
__device__ __forceinline__ Row<T> row_of(const Args& a, int part, long long b,
                                         long long r, bool vec) {
  const Operand &e = a.op[ETA + part], &lz = a.op[LZ + part],
                &lzn = a.op[LZN + part], &out = a.op[OUT + part];
  Row<T> s;
  s.e = row_at<T>(e, b, r);
  s.lz = row_at<T>(lz, b, r);
  s.lzn = row_at<T>(lzn, b, r);
  s.out = const_cast<T*>(row_at<T>(out, b, r));
  s.ce = e.cs;
  s.clz = lz.cs;
  s.clzn = lzn.cs;
  s.cout = out.cs;
  s.vec = vec;
  return s;
}

// mod of the V entries of a row from column j
template <typename T, int V>
__device__ __forceinline__ Vec<T, V> mod_at(const Row<T>& s, int j, T a) {
  const Vec<T, V> e = load<T, V>(s.e + j * s.ce, s.ce, s.vec),
                  lz = load<T, V>(s.lz + j * s.clz, s.clz, s.vec),
                  lzn = load<T, V>(s.lzn + j * s.clzn, s.clzn, s.vec);
  Vec<T, V> m;
#pragma unroll
  for (int i = 0; i < V; ++i)
    m.v[i] = moreau(e.v[i], lz.v[i], lzn.v[i], a, T(0));
  return m;
}

template <typename T, int V>
__device__ __forceinline__ void put(const Row<T>& s, int j,
                                    const Vec<T, V>& x) {
  store<T, V>(s.out + j * s.cout, s.cout, s.vec, x);
}

// a table's row (no lane axis), V entries from column j
template <typename T, int V>
__device__ __forceinline__ Vec<T, V> table_at(const Operand& o, long long r,
                                              int j, bool vec) {
  return load<T, V>(row_at<T>(o, 0, r) + j * o.cs, o.cs, vec);
}

// the thread's first K vectors of a row of width w (thread g of a group of
// G takes vectors g, g + G, ...), into registers
template <typename T, int V, int K>
__device__ __forceinline__ void fill(const Row<T>& s, int w, int g, int G, T a,
                                     Vec<T, V> (&c)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = (k * G + g) * V;
    if (j < w) c[k] = mod_at<T, V>(s, j, a);
  }
}

// f(j, mod) on each of the thread's vectors of the row: the first K from
// registers, any beyond them formed from memory again
template <typename T, int V, int K, typename F>
__device__ __forceinline__ void visit(const Row<T>& s, int w, int g, int G,
                                      T a, const Vec<T, V> (&c)[K], F&& f) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = (k * G + g) * V;
    if (j < w) f(j, c[k]);
  }
  for (int j = (K * G + g) * V; j < w; j += G * V) f(j, mod_at<T, V>(s, j, a));
}

// a sum over the G threads of a group, the same bits in each (a butterfly:
// both partners of a step add the same two numbers)
template <typename T>
__device__ __forceinline__ T group_sum(T x, int G) {
  for (int off = G >> 1; off > 0; off >>= 1)
    x = add(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// a scalar part of row r: its mod, with the shift operand sh (or none)
template <typename T>
__device__ __forceinline__ T scalar_mod(const Args& a, int part, int sh,
                                        long long b, long long r, T al) {
  const T e = *row_at<T>(a.op[ETA + part], b, r);
  const T lz = *row_at<T>(a.op[LZ + part], b, r);
  const T lzn = *row_at<T>(a.op[LZN + part], b, r);
  const T s = sh < 0 ? T(0) : *row_at<T>(a.op[sh], b, r);
  return moreau(e, lz, lzn, al, s);
}

template <typename T>
__device__ __forceinline__ void scalar_put(const Args& a, int part,
                                           long long b, long long r, T x) {
  *const_cast<T*>(row_at<T>(a.op[OUT + part], b, r)) = x;
}

// the SOC's three cases (ops/cones.py soc_project_parts): the head's
// projection is head * scale, the tail's is t
template <typename T>
struct Soc {
  T scale, t;
};

template <typename T>
__device__ __forceinline__ Soc<T> soc(T sq, T t) {
  const T nx = root(sq);
  const bool in_cone = nx <= t, in_polar = nx <= -t;
  const T half = mul(T(0.5), add(nx, t));
  const T safe = nx > T(0) ? nx : T(1);
  T scale = in_cone ? T(1) : quo(half, safe);
  scale = in_polar ? T(0) : scale;
  return {scale, in_cone ? t : (in_polar ? T(0) : half)};
}

// the box or ball of one row of e7 or e14 (ops/cones.py
// constraint_project): a ball where the row's radius is finite
template <typename T, int V, int K>
__device__ __forceinline__ void constraint(const Args& a, const Row<T>& s,
                                           int lo, int hi, int c, int rad,
                                           long long r, bool ok, int w, int g,
                                           int G, T al,
                                           const Vec<T, V> (&cv)[K]) {
  const T radius = ok ? *row_at<T>(a.op[rad], 0, r) : T(0);
  const bool ball = ok && sub(radius, radius) == T(0);  // a finite radius
  T sq = T(0);
  if (ball) {
    visit(s, w, g, G, al, cv, [&](int j, const Vec<T, V>& m) {
      const Vec<T, V> cc = table_at<T, V>(a.op[c], r, j, s.vec);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const T d = sub(m.v[i], cc.v[i]);
        sq = add(sq, mul(d, d));
      }
    });
  }
  sq = group_sum(sq, G);
  const T norm = root(sq);
  const T safe = norm > T(0) ? norm : T(1);
  const T scale = norm > radius ? quo(radius, safe) : T(1);
  visit(s, w, g, G, al, cv, [&](int j, const Vec<T, V>& m) {
    Vec<T, V> o;
    if (ball) {
      const Vec<T, V> cc = table_at<T, V>(a.op[c], r, j, s.vec);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const T p = add(cc.v[i], mul(sub(m.v[i], cc.v[i]), scale));
        o.v[i] = mul(al, sub(m.v[i], p));
      }
    } else {
      const Vec<T, V> l = table_at<T, V>(a.op[lo], r, j, s.vec),
                      h = table_at<T, V>(a.op[hi], r, j, s.vec);
#pragma unroll
      for (int i = 0; i < V; ++i)
        o.v[i] = mul(al, sub(m.v[i], least(most(m.v[i], l.v[i]), h.v[i])));
    }
    put<T, V>(s, j, o);
  });
}

// a nonleaf row: e1 (the risk's dual cone, an entry at a time: its rows are
// few), e2 (the orthant), e7 (box or ball)
template <typename T, int V>
__device__ __forceinline__ void nonleaf_row(const Args& a, long long b, long long r, bool ok,
                            int g, int G, T al, bool vec) {
  const int y = ok ? int(a.dim[D_Y]) : 0;
  const Row<T> s1 = row_of<T>(a, E1, b, r, false);
  Vec<T, 1> c1[CACHE];
  fill(s1, y, g, G, al, c1);
  const Operand &fr = a.op[FREE], &zr = a.op[ZERO], &sr = a.op[SOC_ROWS],
                &st = a.op[SOC_TAIL];
  auto mask = [&](const Operand& o, int j) {
    const unsigned char* row = reinterpret_cast<const unsigned char*>(o.p);
    return row[r * o.rs + j * o.cs] != 0;
  };
  const bool soc_block = a.dim[D_SOC] != 0;
  T x_coef = T(1), t_new = T(0);
  if (soc_block) {  // the same for every row of the launch
    T sq = T(0), tt = T(0);
    visit(s1, y, g, G, al, c1, [&](int j, const Vec<T, 1>& m) {
      const T x = mul(m.v[0], mask(sr, j) ? T(1) : T(0));
      sq = add(sq, mul(x, x));
      tt = add(tt, mul(m.v[0], mask(st, j) ? T(1) : T(0)));
    });
    sq = group_sum(sq, G);
    tt = group_sum(tt, G);
    const T nx = root(sq);
    const bool inside = nx <= tt, polar = nx <= -tt;
    const T t_half = mul(T(0.5), add(nx, tt));
    x_coef = inside ? T(1) : (polar ? T(0) : quo(t_half, most(nx, tiny(nx))));
    t_new = inside ? tt : (polar ? T(0) : t_half);
  }
  visit(s1, y, g, G, al, c1, [&](int j, const Vec<T, 1>& mv) {
    const T m = mv.v[0];
    T p = mask(fr, j) ? m : (mask(zr, j) ? T(0) : most(m, T(0)));
    if (soc_block)
      p = mask(sr, j) ? mul(x_coef, m) : (mask(st, j) ? t_new : p);
    Vec<T, 1> o;
    o.v[0] = mul(al, sub(m, p));
    put<T, 1>(s1, j, o);
  });
  if (ok && g == 0) {
    const T m2 = scalar_mod(a, E2, -1, b, r, al);
    scalar_put(a, E2, b, r, mul(al, sub(m2, most(m2, T(0)))));
  }
  constexpr int K = slots<V>();
  const int c7 = ok ? int(a.dim[D_C7]) : 0;
  const Row<T> s7 = row_of<T>(a, E7, b, r, vec);
  Vec<T, V> cv[K];
  fill(s7, c7, g, G, al, cv);
  constraint(a, s7, LO7, HI7, C7, R7, r, ok, c7, g, G, al, cv);
}

// the SOC of (x head, y head, a scalar head | a scalar tail): writes the
// projected rows (out = a (mod - mod scale) on the heads)
template <typename T, int V, int K>
__device__ __forceinline__ void soc_rows(const Args& a, const Row<T>& sx,
                                         int wx, const Vec<T, V> (&cx)[K],
                                         const Row<T>& sy, int wy,
                                         const Vec<T, V> (&cy)[K], int head,
                                         int sh_head, int tail, int sh_tail,
                                         long long b, long long r, bool ok,
                                         int g, int G, T al) {
  T sq = T(0);
  auto square = [&](int, const Vec<T, V>& m) {
#pragma unroll
    for (int i = 0; i < V; ++i) sq = add(sq, mul(m.v[i], m.v[i]));
  };
  visit(sx, wx, g, G, al, cx, square);
  visit(sy, wy, g, G, al, cy, square);
  const T mh = ok ? scalar_mod(a, head, sh_head, b, r, al) : T(0);
  const T mt = ok ? scalar_mod(a, tail, sh_tail, b, r, al) : T(0);
  if (g == 0) sq = add(sq, mul(mh, mh));
  sq = group_sum(sq, G);
  const Soc<T> p = soc(sq, mt);
  auto head_out = [&](const Vec<T, V>& m) {
    Vec<T, V> o;
#pragma unroll
    for (int i = 0; i < V; ++i)
      o.v[i] = mul(al, sub(m.v[i], mul(m.v[i], p.scale)));
    return o;
  };
  visit(sx, wx, g, G, al, cx,
        [&](int j, const Vec<T, V>& m) { put<T, V>(sx, j, head_out(m)); });
  visit(sy, wy, g, G, al, cy,
        [&](int j, const Vec<T, V>& m) { put<T, V>(sy, j, head_out(m)); });
  if (ok && g == 0) {
    scalar_put(a, head, b, r, mul(al, sub(mh, mul(mh, p.scale))));
    scalar_put(a, tail, b, r, mul(al, sub(mt, p.t)));
  }
}

// a node row: the SOC of (e3, e4, e5 | e6)
template <typename T, int V>
__device__ __forceinline__ void node_row(const Args& a, long long b, long long r, bool ok,
                         int g, int G, T al, bool vec) {
  constexpr int K = slots<V>();
  const int n = ok ? int(a.dim[D_N]) : 0, m = ok ? int(a.dim[D_M]) : 0;
  const Row<T> s3 = row_of<T>(a, E3, b, r, vec),
               s4 = row_of<T>(a, E4, b, r, vec);
  Vec<T, V> c3[K], c4[K];
  fill(s3, n, g, G, al, c3);
  fill(s4, m, g, G, al, c4);
  soc_rows(a, s3, n, c3, s4, m, c4, E5, SH5, E6, SH6, b, r, ok, g, G, al);
}

// a leaf row: the SOC of (e11, e12 | e13), then e14's box or ball
template <typename T, int V>
__device__ __forceinline__ void leaf_row(const Args& a, long long b, long long r, bool ok,
                         int g, int G, T al, bool vec) {
  constexpr int K = slots<V>();
  const int n = ok ? int(a.dim[D_N]) : 0, c14 = ok ? int(a.dim[D_C14]) : 0;
  const Row<T> s11 = row_of<T>(a, E11, b, r, vec),
               s14 = row_of<T>(a, E14, b, r, vec);
  Vec<T, V> c11[K], cv[K];
  fill(s11, n, g, G, al, c11);
  fill(s14, c14, g, G, al, cv);
  soc_rows(a, s11, n, c11, s11, 0, c11, E12, SH12, E13, SH13, b, r, ok, g, G,
           al);
  constraint(a, s14, LO14, HI14, C14, R14, r, ok, c14, g, G, al, cv);
}

// VEC a constant, so that each instantiation holds one kind of load
template <typename T, int V, bool VEC>
__device__ __forceinline__ void family_row(int fam, const Args& a, long long b,
                                           long long r, bool ok, int g, int G,
                                           T al) {
  if (fam == 0) {
    nonleaf_row<T, V>(a, b, r, ok, g, G, al, VEC);
  } else if (fam == 1) {
    node_row<T, V>(a, b, r, ok, g, G, al, VEC);
  } else {
    leaf_row<T, V>(a, b, r, ok, g, G, al, VEC);
  }
}

// one launch: block ranges for the nonleaf, node and leaf rows; a group of
// G threads a row of one lane
template <typename T>
__global__ void __launch_bounds__(THREADS, 4)
    dual_update_kernel(const __grid_constant__ Args a) {
  const long long blk = blockIdx.x;
  const int fam = blk < a.end[0] ? 0 : (blk < a.end[1] ? 1 : 2);
  const long long first = fam == 0 ? 0 : a.end[fam - 1];
  const int G = int(a.dim[D_GROUP_NL + fam]);
  const int g = threadIdx.x & (G - 1);
  const long long rows = a.dim[D_ROWS_NL + fam];
  const long long task = (blk - first) * (THREADS / G) + threadIdx.x / G;
  const bool ok = task < a.dim[D_LANES] * rows;
  const long long b = ok ? task / rows : 0, r = ok ? task % rows : 0;
  const Operand& alpha = a.op[ALPHA];
  const T al = alpha.p ? *row_at<T>(alpha, b, 0) : T(a.alpha);
  const int V = int(a.dim[D_VEC_NL + fam]);
  const bool vec = a.dim[D_ALIGNED_NL + fam] != 0;
  constexpr int VMAX = 16 / int(sizeof(T));
  if (V == VMAX && vec) {
    family_row<T, VMAX, true>(fam, a, b, r, ok, g, G, al);
  } else if (V == VMAX) {
    family_row<T, VMAX, false>(fam, a, b, r, ok, g, G, al);
  } else if (V == 2 && vec) {
    family_row<T, 2, true>(fam, a, b, r, ok, g, G, al);
  } else if (V == 2) {
    family_row<T, 2, false>(fam, a, b, r, ok, g, G, al);
  } else {
    family_row<T, 1, false>(fam, a, b, r, ok, g, G, al);
  }
}

template <typename T>
int launch(const long long* ops, const long long* dims, double alpha,
           void* stream) {
  Args a;
  for (int i = 0; i < OPERANDS; ++i)
    a.op[i] = Operand{ops[4 * i], ops[4 * i + 1], ops[4 * i + 2],
                      ops[4 * i + 3]};
  for (int i = 0; i < DIMS; ++i) a.dim[i] = dims[i];
  a.alpha = alpha;
  long long blocks = 0;
  for (int f = 0; f < 3; ++f) {
    const long long G = dims[D_GROUP_NL + f], V = dims[D_VEC_NL + f];
    if (G != 4 && G != 8 && G != 16 && G != 32) return -2;
    if (V != 1 && V != 2 && V != 16 / static_cast<long long>(sizeof(T)))
      return -2;
    const long long per = THREADS / G;
    blocks += (dims[D_LANES] * dims[D_ROWS_NL + f] + per - 1) / per;
    a.end[f] = blocks;
  }
  if (blocks > 0x7fffffffLL) return -2;
  if (blocks == 0) return 0;
  dual_update_kernel<T><<<unsigned(blocks), THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int raocp_dual_f32(const long long* ops, const long long* dims,
                              double alpha, void* stream) {
  return launch<float>(ops, dims, alpha, stream);
}

extern "C" int raocp_dual_f64(const long long* ops, const long long* dims,
                              double alpha, void* stream) {
  return launch<double>(ops, dims, alpha, stream);
}

// the operand and size counts the library was built with, for the wrapper
// to check its layout against
extern "C" int raocp_dual_layout(int which) {
  return which == 0 ? OPERANDS : (which == 1 ? DIMS : THREADS);
}

// Initialises this library's CUDA runtime on the current device, outside
// any capture (its first call would otherwise fall inside one).
extern "C" int raocp_dual_init(void) { return cudaFree(nullptr); }

extern "C" const char* raocp_dual_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
