// The over-relaxation of a Chambolle-Pock step as one kernel, for NVIDIA
// Hopper (sm_90a): for each leaf of the step's (z, eta, L z, L'eta), with c
// the current iterate's leaf and p the step's,
//
//   out = c + rho (p - c)
//
// It replaces no TPU kernel: the JAX package leaves the relaxation to XLA,
// which fuses it into the step's loop body. In PyTorch it was three
// elementwise kernels a leaf, 96 launches a step over the 32 leaves, and
// the sum and the product passed through device memory: 8 S of traffic a
// step, S the four vectors' bytes (314 MB at BASELINE config 5's 88,573
// nodes, n = 100, m = 40, float32).
//
// What bounds it on this card: bytes. One launch reads each c and p once
// and writes each result once, 3 S (943 MB at config 5: 0.28 ms at 3.35
// TB/s). The design keeps to that pass: the leaves' (c, p, out) triples
// go in a table passed by value (valid inside a captured CUDA graph), each
// leaf a range of blocks in proportion to its size; a thread takes UNITS
// units of a leaf, a unit V consecutive entries of one row, loads them all
// before it computes and stores (several loads in flight a thread), and
// moves them as 16-byte loads and stores where the leaf allows it (unit
// column strides, aligned addresses, strides that keep rows aligned; the
// wrapper decides), else one entry at a time at any stride. Inputs may be
// strided or aliased views (L z's e3 and e4 are column slices of one
// tensor, its e5 is its e6): each is read through its own strides, never
// copied. Each output is a contiguous leaf of its own.
//
// The arithmetic is the plain twin's (ops/relax.py over_relax_plain): d = p
// - c, m = rho d with rho rounded to the leaf's type, then c + m, each
// operation rounded on its own (no contraction into fma), so every entry
// is the twin's to the bit.
//
// A plain C interface for ctypes: each leaf is 14 numbers (addresses,
// strides and sizes in elements; see Leaf); the functions return a
// cudaError_t (0 on success), or -2 for arguments the library does not
// take.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
// the units a thread takes: their loads are issued together
constexpr int UNITS = 4;
// the leaves a launch takes: the step's 5 + 11 + 11 + 5. The table fits
// the 4 KB of a kernel's parameters
constexpr int LEAVES = 32;
constexpr int FIELDS = 14;

// one leaf: the output is [lanes, rows, cols], contiguous; c and p are
// read at their own lane, row and column strides (0 on a broadcast axis)
struct Leaf {
  long long c, p, out;
  long long cl, cr, cc, pl, pr, pc;
  long long lanes, rows, cols;
  long long first;  // the leaf's first block
  long long vec;    // whether its units move as 16-byte accesses
};

struct Args {
  Leaf leaf[LEAVES];
  double rho;
  int count;
};

__device__ inline float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ inline double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ inline float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ inline double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ inline float add(float a, float b) { return __fadd_rn(a, b); }
__device__ inline double add(double a, double b) { return __dadd_rn(a, b); }

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

// the unit's place: its offsets into c, p and out, and its entries
struct Place {
  long long c, p, out;
  int n;
};

template <int V>
__device__ __forceinline__ Place place(const Leaf& f, long long u) {
  const long long per = (f.cols + V - 1) / V;  // units a row
  long long q = 0, j = u * V;
  if (f.lanes * f.rows > 1) {
    q = u / per;
    j = (u - q * per) * V;
  }
  const long long b = f.rows > 1 ? q / f.rows : q;
  const long long r = q - b * f.rows;
  const long long left = f.cols - j;
  return Place{b * f.cl + r * f.cr + j * f.cc, b * f.pl + r * f.pr + j * f.pc,
               q * f.cols + j, int(left < V ? left : V)};
}

// a unit's n entries from base + offset at column stride cs: one vector
// load where the unit is whole (V > 1 only on leaves the wrapper found
// aligned, at unit column stride), else an entry at a time
template <typename T, int V>
__device__ __forceinline__ Vec<T, V> load(const T* base, long long offset,
                                          long long cs, int n) {
  if constexpr (V > 1) {
    if (n == V) return *reinterpret_cast<const Vec<T, V>*>(base + offset);
  }
  Vec<T, V> x;
#pragma unroll
  for (int i = 0; i < V; ++i) x.v[i] = i < n ? base[offset + i * cs] : T(0);
  return x;
}

template <typename T, int V>
__device__ __forceinline__ void body(const Leaf& f, long long first_unit,
                                     T rho) {
  const T* c = reinterpret_cast<const T*>(f.c);
  const T* p = reinterpret_cast<const T*>(f.p);
  T* out = reinterpret_cast<T*>(f.out);
  const long long units = f.lanes * f.rows * ((f.cols + V - 1) / V);
  Place at[UNITS];
  Vec<T, V> xc[UNITS], xp[UNITS];
#pragma unroll
  for (int k = 0; k < UNITS; ++k) {
    const long long u = first_unit + k * THREADS + threadIdx.x;
    at[k].n = 0;
    if (u < units) {
      at[k] = place<V>(f, u);
      xc[k] = load<T, V>(c, at[k].c, f.cc, at[k].n);
      xp[k] = load<T, V>(p, at[k].p, f.pc, at[k].n);
    }
  }
#pragma unroll
  for (int k = 0; k < UNITS; ++k) {
    if (at[k].n == 0) continue;
    Vec<T, V> o;
#pragma unroll
    for (int i = 0; i < V; ++i)
      o.v[i] = add(xc[k].v[i], mul(rho, sub(xp[k].v[i], xc[k].v[i])));
    if constexpr (V > 1) {
      if (at[k].n == V) {
        *reinterpret_cast<Vec<T, V>*>(out + at[k].out) = o;
        continue;
      }
    }
#pragma unroll
    for (int i = 0; i < V; ++i)
      if (i < at[k].n) out[at[k].out + i] = o.v[i];
  }
}

// one launch: each leaf a range of blocks, a block THREADS * UNITS units
template <typename T>
__global__ void __launch_bounds__(THREADS)
    over_relax_kernel(const __grid_constant__ Args a) {
  const long long blk = blockIdx.x;
  int lo = 0, hi = a.count - 1;  // the last leaf whose first block <= blk
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (a.leaf[mid].first <= blk) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const Leaf& f = a.leaf[lo];
  const long long first_unit = (blk - f.first) * (THREADS * UNITS);
  const T rho = T(a.rho);
  constexpr int VMAX = 16 / int(sizeof(T));
  if (f.vec) {
    body<T, VMAX>(f, first_unit, rho);
  } else {
    body<T, 1>(f, first_unit, rho);
  }
}

template <typename T>
int launch(const long long* table, int count, double rho, void* stream) {
  if (count < 0 || count > LEAVES) return -2;
  Args a = {};
  a.rho = rho;
  a.count = count;
  constexpr long long VMAX = 16 / static_cast<long long>(sizeof(T));
  long long blocks = 0;
  for (int i = 0; i < count; ++i) {
    const long long* t = table + FIELDS * i;
    Leaf& f = a.leaf[i];
    f = Leaf{t[0], t[1], t[2], t[3], t[4], t[5], t[6], t[7], t[8],
             t[9], t[10], t[11], blocks, t[13]};
    if (f.lanes < 0 || f.rows < 0 || f.cols < 0 || (f.vec != 0 && f.vec != 1))
      return -2;
    const long long v = f.vec ? VMAX : 1;
    const long long units = f.lanes * f.rows * ((f.cols + v - 1) / v);
    blocks += (units + THREADS * UNITS - 1) / (THREADS * UNITS);
  }
  if (blocks > 0x7fffffffLL) return -2;
  if (blocks == 0) return 0;
  over_relax_kernel<T><<<unsigned(blocks), THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int raocp_relax_f32(const long long* table, int count,
                               double rho, void* stream) {
  return launch<float>(table, count, rho, stream);
}

extern "C" int raocp_relax_f64(const long long* table, int count,
                               double rho, void* stream) {
  return launch<double>(table, count, rho, stream);
}

// the layout the library was built with, for the wrapper to check its own
// against: leaves a launch, numbers a leaf, threads a block, units a thread
extern "C" int raocp_relax_layout(int which) {
  return which == 0 ? LEAVES
                    : (which == 1 ? FIELDS : (which == 2 ? THREADS : UNITS));
}

// Initialises this library's CUDA runtime on the current device, outside
// any capture (its first call would otherwise fall inside one).
extern "C" int raocp_relax_init(void) { return cudaFree(nullptr); }

extern "C" const char* raocp_relax_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
