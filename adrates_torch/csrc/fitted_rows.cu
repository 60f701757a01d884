// K6 / K7: the fitted schemes' curve rows at static queries, and their
// transpose (f64).
//
// Replace the fit and the evaluation of the fitted schemes at static
// queries: adrates_tpu/ops/interpolation.py interp_fit (:350) and
// interp_df (:375), as adrates_tpu/parallel/curve_batching.py stage_rows
// (:320) runs them for each fitted member of a stage (the port's
// ops/interpolation.py fitted_df_static). On a static plan the knots x, the
// queries q and their brackets i = idx(q) are fixed when the book compiles;
// past the scheme's elementwise transform (log DF or the zero rate, done by
// torch around the kernels), each member is a cubic Hermite interpolant
//
//   u = w00 y_i + w10 d_i + w01 y_{i+1} + w11 d_{i+1}
//
// with static weights (hermite_eval's h00, h10 h, h01, h11 h), on slopes d
// that are given (the PCHIP schemes: slot 1 of the input) or are the
// spline's, d = T^-1 R y (the three spline schemes: T the knot-slope
// tridiagonal, R the static map from y to its right-hand side; both depend
// on the knots alone). So the map (y, d) -> u is linear and static.
//
//   K6 fitted_rows:    U [R, G, W_max] from X [R, G, K, n_max], X[.., 0, :]
//                      the knot values y, X[.., 1, :] the given slopes
//                      (read for a Hermite member only; K = 2 where the
//                      stack holds one).
//   K7 fitted_rows_t:  its exact transpose, Xb [R, G, K, n_max] from
//                      Ub [R, G, W_max]: each query's cotangent times its
//                      four weights, summed by interval into the
//                      interval's two knots in a fixed order (no atomics);
//                      for a spline member d-bar -> z = T^-T d-bar and
//                      y-bar += R^T z, and slot 1 is 0.
//
// Row r of X is one (scenario, tangent, ...) evaluation of member g = the
// second axis; members are padded to n_max knots (T's pad rows identity,
// R's and the weights' pad entries 0: pads are never read) and W_max
// queries (K6 writes 0 there, K7 reads none of them).
//
// T is factored once on the host in f64 (Thomas: T = L U, L unit lower with
// multipliers l_i, U upper with pivots b'_i and super-diagonal c_i; T is
// strictly diagonally dominant, so no pivoting), and the tables hold l, 1 /
// b' and c: the device solve is two sweeps of FMAs and multiplies, no
// division. sp [G, 6, n_max] = (l, 1 / b', c, rl, rd, ru), R's three
// diagonals last.
//
// What bounds them on an H100: bytes. A call reads X (8 R G K n_max bytes)
// and writes U (8 R G W_max), or the reverse for K7, plus the tables
// (about 40 G (n_max + W_max) bytes, read once from HBM and then from L2):
// on the spline cell's stages (n_max 73, W_max the book's unique times) the
// query values are the most of it. The work is a few FMAs a byte (K7: four
// a cotangent, 142 MFLOP at region C2's [1,600, 5, 2,225], far below the
// f64 rate). A spline member's solve is a chain of about 2 n dependent
// FMAs a row (n = 73 on GBP, USD, EUR, 43 on JPY and AUD): about 1-3 us,
// taken once a tile and hidden behind other blocks' streams.
//
// K6: one block a (tile of rows, member) -- the grid is [ceil(R / rows),
// G] --, 256 threads. The tile's y rows (and d rows of a Hermite member)
// staged in shared memory, coalesced; a spline member's rows solved one
// lane a row (the first warp) from the stored factors, into the d rows;
// then a thread a query loads its bracket and weights once and writes its
// value in every row of the tile (stores coalesced along the queries; the
// tables are read once a tile, not once a value). Rows of the shared
// tiles have an odd stride (n_max | 1 doubles), so the solving lanes, a
// row each, hit distinct banks. A tile is 32 rows where two of them fit
// 96 KB of shared memory (n_max < 192), else fewer (down to 1 row: n_max <
// 6144).
//
// K7: the cotangents streamed through shared memory and summed over
// static segments, with no shuffle (kernels.fitted_tables builds the
// segments once a plan). Its first design summed by a warp's segmented
// shuffle scan over the queries in interval order: 40 32-bit shuffles a
// cotangent, 0.129 of its 0.239 ms at region C2 (scripts/k7_phases.py).
//
// - The host cuts each member's queries, in interval order (iq), into
//   chunks of at most kChunk = 256 queries and kSegs = 32 segments, a
//   segment being at most kSegLen = 8 consecutive queries of one
//   interval; a chunk's segments of one interval are consecutive. A
//   segment sums to four numbers: the y-bar and d-bar of its interval's
//   left and right knots. The chunk's tables (ftab, kTab ints) list its
//   segments, then each knot its segments reach with two ranges: the
//   segments right of it (their left sums) and left of it (their right
//   sums). A short curve's extrapolated tail (1,049 of 2,225 queries in
//   one interval on the spline cell's 43-knot members) is thus many
//   short segments summed side by side, not a walk of one thread.
// - One block a (tile of rows, member), the grid [ceil(R / tr), G]: eight
//   warps that sum and a ninth whose first lane issues the bulk (TMA)
//   copies, so that their issue (about 125 cycles a copy, which the
//   engine holds the issuing thread for) runs while the others sum; the
//   member's chunk list read once into shared memory. The block streams
//   its chunks through a ring of kStages stages, kStages - 1 in flight
//   while one is summed: a chunk is issued into the stage the chunk
//   before it left, after the barrier that ends that chunk's round.
//   Where a chunk's queries are consecutive in memory (a stage's sorted
//   times: 42 of region C2's 50 chunks, all of the gammas') its weights
//   and each row's cotangents come by bulk copies, a row's from the
//   16-byte unit holding its first value to the one holding its last,
//   counted in bytes by the stage's shared-memory barrier; else (a joint
//   legs plan, region C1) a summing thread a query gathers its value in
//   each row and its weights by cp.async. The tables always come by a
//   bulk copy. Ub's rows are G W_max values apart, and W_max is odd at
//   every captured call, so no 2-D TMA box (16-byte strides) fits.
// - A thread a (segment, row): four FMAs a cotangent from shared memory
//   (the segment's queries unrolled), the four sums to a shared slot;
//   then, after a barrier, a thread a (knot, row) adds the left sums of
//   its right segments, then the right sums of its left ones, in order,
//   to the knot: a fixed order (chunks, segments), no atomics, and one
//   thread a knot, so no barrier between a knot's two sides. Work goes
//   to (segment, row) pairs of live rows only: a small tile does no work
//   for dead rows.
// - Then a spline member's rows go through U^T and L^T, one lane a row,
//   the factors staged in shared memory with the first chunk and eight
//   steps' operands loaded together, and R^T is applied as the rows are
//   stored.
// - Tiles: tr = 8 rows where that gives a block to each of the 132 SMs
//   (regions C2 and C1: 1,000 and 200 blocks), else 4, 2, 1 (the gammas'
//   [32, 5, 4,337]: 160 blocks of one row); fewer where the shared memory
//   would pass 75 KB, so that three blocks share an SM (72 registers a
//   thread, no spills; 70,288 bytes at region C2's tr = 8 and n_max 73).
//   kStages = 2 at tr = 8, 3 at 4, 4 below: a thinner tile keeps more
//   chunks in flight. Three 2-stage blocks an SM measured faster than two
//   3-stage ones (0.094 against 0.116 ms at C2), and 8-row tiles than
//   4-row ones (0.103 against 0.174 ms in a cp.async form: a tile reads
//   the weights again). A staged row has an odd stride (kChunk + 3
//   doubles, its 16-byte phase taken from its address), so a warp's
//   (segment, row) pairs meet few bank conflicts.
// - What holds it at C2: a chunk's round (2.3 us) goes to summing
//   segments (shared-memory bound: every row reads the weights again)
//   and knots (a tail's knot adds 32 segments' sums in a row); the
//   copies' issue from a summing thread had held the block at the next
//   barrier (0.092 against 0.086 ms a launch at C2).
//
// No atomics, no allocation, one launch on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;            // K7: the summing threads
constexpr int kMaxRows = 32;              // rows a K6 tile (the solving warp)
constexpr int kSmemBudget = 96 * 1024;    // bytes of shared memory a block
// K7 (kernels.py FIT_CHUNK, FIT_SEGS, FIT_SEG_LEN)
constexpr int kChunk = 256;               // queries a chunk, at most
constexpr int kSegs = 32;                 // segments a chunk, at most
constexpr int kKnots = 2 * kSegs;         // knots a chunk reaches, at most
constexpr int kSegLen = 8;                // queries a segment, at most
constexpr int kTileT = 8;                 // rows a tile, at most
constexpr int kKnotItems = kKnots * kTileT / kThreads;  // a thread's
constexpr int kLdV = kChunk + 3;          // a staged row: odd, with its phase
constexpr int kTab = kSegs + 2 * kKnots;  // ints of a chunk's tables
constexpr int kBlocksSM = 3;              // blocks an SM
constexpr int kSmemT = 76800;             // bytes a block, for kBlocksSM
constexpr int kSMs = 132;
enum { kL = 0, kRb = 1, kC = 2, kRl = 3, kRd = 4, kRu = 5 };  // sp slots

__host__ __device__ inline int row_stride(int n_max) { return n_max | 1; }

int tile_rows(int n_max) {
  const int per_row = 2 * row_stride(n_max) * (int)sizeof(double);
  const int tr = kSmemBudget / per_row;
  return tr < kMaxRows ? tr : kMaxRows;
}

__device__ __forceinline__ double2 ld2(const double* p) {
  return __ldg(reinterpret_cast<const double2*>(p));
}

__global__ void __launch_bounds__(kThreads)
    fitted_rows_kernel(const double* __restrict__ X, int R, int G, int K,
                       int n_max, int W_max, const int* __restrict__ kind,
                       const int* __restrict__ nk, const int* __restrict__ nw,
                       const int* __restrict__ qidx,
                       const double* __restrict__ qw,
                       const double* __restrict__ sp, int TR,
                       double* __restrict__ U) {
  extern __shared__ double smem[];
  const int g = blockIdx.y;
  const int r0 = blockIdx.x * TR;
  const int rows = min(TR, R - r0);
  const int n = nk[g], W = nw[g], kd = kind[g];
  const int ld = row_stride(n_max);
  double* ys = smem;              // [TR][ld] knot values
  double* ds = smem + TR * ld;    // [TR][ld] slopes

  // 1. stage the tile's knot values (and a Hermite member's slopes)
  for (int e = threadIdx.x; e < rows * n; e += blockDim.x) {
    const int r = e / n, i = e - r * n;
    const double* xr = X + ((size_t)(r0 + r) * G + g) * K * n_max;
    ys[r * ld + i] = xr[i];
    if (kd == 0) ds[r * ld + i] = xr[n_max + i];
  }
  __syncthreads();

  // 2. a spline member: d = U^-1 L^-1 (R y), one lane a row
  if (kd != 0) {
    if ((int)threadIdx.x < rows) {
      const double* s = sp + (size_t)g * 6 * n_max;
      const double* y = ys + threadIdx.x * ld;
      double* d = ds + threadIdx.x * ld;
      double f = 0.0;
      for (int i = 0; i < n; ++i) {
        double rhs = s[kRd * n_max + i] * y[i];
        if (i > 0) rhs = fma(s[kRl * n_max + i], y[i - 1], rhs);
        if (i + 1 < n) rhs = fma(s[kRu * n_max + i], y[i + 1], rhs);
        f = fma(-s[kL * n_max + i], f, rhs);       // l_0 = 0
        d[i] = f;
      }
      double b = 0.0;
      for (int i = n - 1; i >= 0; --i) {
        b = fma(-s[kC * n_max + i], b, d[i]) * s[kRb * n_max + i];
        d[i] = b;
      }
    }
    __syncthreads();
  }

  // 3. a thread a query: its bracket and weights loaded once, then its
  //    value in every row of the tile (stores coalesced along queries)
  const int* qi = qidx + (size_t)g * W_max;
  const double* w4 = qw + (size_t)g * W_max * 4;
  for (int w = threadIdx.x; w < W_max; w += blockDim.x) {
    double* out = U + ((size_t)r0 * G + g) * W_max + w;
    const size_t step = (size_t)G * W_max;
    if (w < W) {
      const int i = __ldg(qi + w);
      const double2 a = ld2(w4 + 4 * w), c = ld2(w4 + 4 * w + 2);
      for (int r = 0; r < rows; ++r) {
        const double* y = ys + r * ld;
        const double* d = ds + r * ld;
        out[r * step] = a.x * y[i] + a.y * d[i] + c.x * y[i + 1]
            + c.y * d[i + 1];
      }
    } else {
      for (int r = 0; r < rows; ++r) out[r * step] = 0.0;
    }
  }
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// the bulk (TMA) copy engine: a copy of whole 16-byte units whose landing
// a shared-memory barrier counts in bytes
__device__ __forceinline__ void bar_init(unsigned long long* b) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(b))
               : "memory");
}

__device__ __forceinline__ void bar_expect(unsigned long long* b,
                                           unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(b)), "r"(bytes)
               : "memory");
}

// wait for the barrier's phase of the given parity to complete; a phase
// that never completes (a byte count that the copies do not meet) traps
// instead of hanging the card
__device__ __forceinline__ void bar_wait(unsigned long long* b,
                                         unsigned parity) {
  for (long spin = 0;; ++spin) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(b)), "r"(parity)
        : "memory");
    if (done) return;
    if (spin > (1L << 22)) __trap();
  }
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* b) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(b))
      : "memory");
}

// doubles of a K7 stage's value rows (even, so each stage is 16-byte
// aligned)
__host__ __device__ inline int fit_t_vst(int tr) {
  return (tr * kLdV + 1) & ~1;
}

// doubles of the solve's factors (even, so what follows is 16-byte
// aligned)
__host__ __device__ inline int fit_t_fac(int n_max) {
  return (3 * n_max + 1) & ~1;
}

// bytes of a block's shared memory
size_t fit_t_smem(int tr, int stages, int n_max, int nc) {
  return sizeof(double) * ((size_t)stages * (kChunk * 4 + fit_t_vst(tr))
                           + (size_t)kSegs * tr * 4
                           + (size_t)2 * tr * row_stride(n_max)
                           + (size_t)fit_t_fac(n_max))
         + sizeof(int) * (size_t)stages * kTab + sizeof(int4) * (size_t)nc;
}

// chunks in flight + 1: a thinner tile keeps more in flight
int fit_t_stages(int tr) {
  return tr >= 8 ? 2 : tr >= 4 ? 3 : 4;
}

// rows a K7 tile: the most (kTileT, 4, 2, 1) that still gives a block to
// every SM, and fits kBlocksSM blocks an SM
int fit_t_tile(int R, int G, int n_max, int nc) {
  int tr = kTileT;
  while (tr > 1 && (long)((R + tr - 1) / tr) * G < kSMs) tr >>= 1;
  while (tr > 1 && fit_t_smem(tr, fit_t_stages(tr), n_max, nc) > kSmemT)
    tr >>= 1;
  return tr;
}

template <int kStages>
__global__ void __launch_bounds__(kThreads + 32, kBlocksSM)
    fitted_rows_t_kernel(const double* __restrict__ Ub, int R, int G, int K,
                         int n_max, int W_max, const int* __restrict__ kind,
                         const int* __restrict__ nk,
                         const int* __restrict__ nw,
                         const double* __restrict__ qw,
                         const double* __restrict__ sp,
                         const int* __restrict__ iq,
                         const int* __restrict__ fcp,
                         const int4* __restrict__ fchunk,
                         const int* __restrict__ ftab, int nc, int TR,
                         double* __restrict__ Xb) {
  extern __shared__ __align__(16) double tsm[];
  __shared__ unsigned long long bars[kStages];  // a stage's bulk copies
  const int g = blockIdx.y;
  const int r0 = blockIdx.x * TR;
  const int rows = min(TR, R - r0);
  const int n = nk[g], kd = kind[g];
  const int ld = row_stride(n_max);
  const int vst = fit_t_vst(TR);
  double* sw = tsm;                         // [kStages][kChunk][4] weights
  int* st = reinterpret_cast<int*>(sw + kStages * kChunk * 4);
  // [kStages][kTab] a chunk's segments, then its knots
  int4* chs = reinterpret_cast<int4*>(st + kStages * kTab);  // [nc]
  double* sv = reinterpret_cast<double*>(chs + nc);  // [kStages][vst]
  double* part = sv + kStages * vst;        // [kSegs][TR][4] segment sums
  double* yb = part + kSegs * TR * 4;       // [TR][ld] knot-value cotangents
  double* db = yb + TR * ld;                // [TR][ld] slope cotangents, z
  double* fac = db + TR * ld;               // [3][n_max] l, 1 / b', c
  // threads 0 .. kThreads - 1 sum; the last warp's first lane issues the
  // bulk copies, while the others sum
  const bool sums = threadIdx.x < kThreads;
  const bool issues = threadIdx.x == kThreads;
  if (sums)
    for (int e = threadIdx.x; e < rows * ld; e += kThreads) {
      yb[e] = 0.0;
      db[e] = 0.0;
    }
  if (issues) {
    for (int i = 0; i < kStages; ++i) bar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // the member's chunks (k0, segments, knots, 1 + w0 | 0) and an end
  // entry, read once into shared memory
  const int c0 = fcp[g], nch = fcp[g + 1] - c0 - 1;
  if (sums)
    for (int e = threadIdx.x; e <= nch; e += kThreads)
      chs[e] = fchunk[c0 + e];
  const int* qq = iq + (size_t)g * W_max;
  const double* w4 = qw + (size_t)g * W_max * 4;
  const double* ub = Ub + ((size_t)r0 * G + g) * W_max;
  const size_t step = (size_t)G * W_max;

  // where a staged row's value k lies: v[r * kLdV + 1 + sh + k], sh the
  // 16-byte phase of its address (0 for a gathered chunk)
  auto at = [&](const int4& a, int r) {
    if (!a.w) return r * kLdV + 1;
    const uintptr_t p =
        reinterpret_cast<uintptr_t>(ub + r * step + a.w - 1) >> 3;
    return r * kLdV + 1 + (int)((p - (uintptr_t)(r * kLdV + 1)) & 1);
  };

  // chunk c's tables, weights and cotangents into stage c % kStages:
  // bulk copies where its queries are consecutive in memory (a row's from
  // the 16-byte unit holding its first value to the one holding its
  // last), else the tables so and the rest gathered by cp.async, a
  // summing thread a query
  auto bulk = [&](int c) {                  // the issuing lane's
    if (c >= nch) return;
    const int4 a = chs[c];
    const int nq = chs[c + 1].x - a.x;
    const int s = c % kStages;
    unsigned bytes = kTab * sizeof(int);    // every byte the copies land
    if (a.w) {
      bytes += nq * 32;
      for (int r = 0; r < rows; ++r) {
        const uintptr_t p =
            reinterpret_cast<uintptr_t>(ub + r * step + a.w - 1);
        bytes += 8 * ((nq + (int)((p >> 3) & 1) + 1) & ~1);
      }
    }
    bar_expect(bars + s, bytes);
    bulk_copy(st + s * kTab, ftab + (size_t)(c0 + c) * kTab,
              kTab * sizeof(int), bars + s);
    if (a.w) {
      bulk_copy(sw + s * kChunk * 4, w4 + 4 * (size_t)(a.w - 1), nq * 32,
                bars + s);
      for (int r = 0; r < rows; ++r) {
        const double* p = ub + r * step + a.w - 1;
        const int h = (int)((reinterpret_cast<uintptr_t>(p) >> 3) & 1);
        bulk_copy(sv + s * vst + at(a, r) - h, p - h,
                  8 * ((nq + h + 1) & ~1), bars + s);
      }
    }
  };
  int qn = 0;  // this thread's query of the next chunk gathered
  auto gather = [&](int c) {                // the summing threads'
    if (c >= nch) return;
    const int4 a = chs[c], b = chs[c + 1];
    const int q = qn;                       // this chunk's, read a load ago
    if (c + 1 < nch && !b.w && (int)threadIdx.x < chs[c + 2].x - b.x)
      qn = qq[b.x + threadIdx.x];
    if (!a.w && (int)threadIdx.x < b.x - a.x) {
      const int k = threadIdx.x, s = c % kStages;
      double* w = sw + s * kChunk * 4;
      cp_async16(w + 4 * k, w4 + 4 * (size_t)q);
      cp_async16(w + 4 * k + 2, w4 + 4 * (size_t)q + 2);
      for (int r = 0; r < rows; ++r)
        cp_async8(sv + s * vst + at(a, r) + k, ub + r * step + q);
    }
  };

  const double* s = sp + (size_t)g * 6 * n_max;
  if (kd != 0 && sums)                      // the solve's factors
    for (int e = threadIdx.x; e < 3 * n; e += kThreads)
      cp_async8(fac + (e / n) * n_max + e % n, s + (e / n) * n_max + e % n);
  __syncthreads();                          // chs, the barriers
  if (sums && nch > 0 && !chs[0].w && (int)threadIdx.x < chs[1].x)
    qn = qq[threadIdx.x];
  for (int c = 0; c < kStages - 1; ++c) {
    if (issues) bulk(c);
    if (sums) gather(c);
    cp_async_commit();
  }
  for (int c = 0; c < nch; ++c) {
    if (sums) {
      gather(c + kStages - 1);
      cp_async_commit();
      cp_async_wait<kStages - 1>();         // chunk c landed: gathered
      bar_wait(bars + c % kStages, (c / kStages) & 1);  // and bulk
    }
    __syncthreads();                        // (everyone's)
    // chunk c + kStages - 1 into the stage chunk c - 1 left (its last
    // reads were before the barrier that ended its round), issued while
    // this chunk is summed
    if (issues) bulk(c + kStages - 1);
    const int4 a = chs[c];
    const int nseg = a.y, nknot = a.z;
    const double* v = sv + (c % kStages) * vst;
    const double* w = sw + (c % kStages) * kChunk * 4;
    const int* t = st + (c % kStages) * kTab;

    // 1. a thread a (segment, row): four FMAs a cotangent
    for (int it = threadIdx.x; sums && it < nseg * rows; it += kThreads) {
      const int s = it / rows, r = it - s * rows;
      const int sg = t[s];
      const int k0 = sg & 0xffff, len = sg >> 16;
      const double* x = v + at(a, r) + k0;
      const double* wk = w + 4 * k0;
      double p0 = 0.0, p1 = 0.0, p2 = 0.0, p3 = 0.0;
#pragma unroll
      for (int k = 0; k < kSegLen; ++k) {
        if (k < len) {
          const double u = x[k];
          const double2 lo = *reinterpret_cast<const double2*>(wk + 4 * k);
          const double2 hi =
              *reinterpret_cast<const double2*>(wk + 4 * k + 2);
          p0 = fma(lo.x, u, p0);
          p1 = fma(lo.y, u, p1);
          p2 = fma(hi.x, u, p2);
          p3 = fma(hi.y, u, p3);
        }
      }
      double2* o = reinterpret_cast<double2*>(part + (s * TR + r) * 4);
      o[0] = make_double2(p0, p1);
      o[1] = make_double2(p2, p3);
    }
    // this thread's knots, read before the barrier: the next chunk's
    // copies, issued past it, may overwrite the stage's tables
    const int2* tk = reinterpret_cast<const int2*>(t + kSegs);
    int2 kn[kKnotItems];
#pragma unroll
    for (int q = 0; q < kKnotItems; ++q) {
      const int it = threadIdx.x + q * kThreads;
      kn[q] = sums && it < nknot * rows ? tk[it / rows] : make_int2(0, 0);
    }
    __syncthreads();

    // 2. a thread a (knot, row): the left sums (slots 0, 1) of the
    //    knot's segments in order, then the right sums (slots 2, 3) of
    //    the segments of the interval before it, added to the knot
#pragma unroll
    for (int q = 0; q < kKnotItems; ++q) {
      const int it = threadIdx.x + q * kThreads;
      if (!sums || it >= nknot * rows) break;
      const int r = it % rows, i = kn[q].x & 0xffff;
      const int lb = (kn[q].x >> 16) & 0xff;
      const int le = (int)((unsigned)kn[q].x >> 24);
      const int rb = kn[q].y & 0xff, re = (kn[q].y >> 8) & 0xff;
      const double2* pr = reinterpret_cast<const double2*>(part) + 2 * r;
      double ty = 0.0, td = 0.0;
      for (int s = lb; s < le; ++s) {
        const double2 u = pr[2 * s * TR];
        ty += u.x;
        td += u.y;
      }
      for (int s = rb; s < re; ++s) {
        const double2 u = pr[2 * s * TR + 1];
        ty += u.x;
        td += u.y;
      }
      yb[r * ld + i] += ty;
      db[r * ld + i] += td;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // 3. a spline member: z = T^-T d-bar = L^-T U^-T d-bar, eight steps'
  //    operands loaded together
  if (kd != 0) {  // T^-T, one lane a row
    if ((int)threadIdx.x < rows) {
      double* z = db + threadIdx.x * ld;
      const double* fl = fac;
      const double* fb = fac + n_max;
      const double* fc = fac + 2 * n_max;
      double v = 0.0;
      for (int i0 = 0; i0 < n; i0 += 8) {     // U^T: c_{i-1} below b'_i
        double zz[8], cc[8], bb[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int i = min(i0 + k, n - 1);
          zz[k] = z[i];
          cc[k] = i > 0 ? fc[i - 1] : 0.0;
          bb[k] = fb[i];
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          if (i0 + k < n) {
            v = fma(-cc[k], v, zz[k]) * bb[k];
            z[i0 + k] = v;
          }
        }
      }
      double b = 0.0;
      for (int i1 = n - 1; i1 >= 0; i1 -= 8) {  // L^T: l_{i+1} right of 1
        double zz[8], ll[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int i = max(i1 - k, 0);
          zz[k] = z[i];
          ll[k] = i + 1 < n ? fl[i + 1] : 0.0;
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          if (i1 - k >= 0) {
            b = fma(-ll[k], b, zz[k]);
            z[i1 - k] = b;
          }
        }
      }
    }
    __syncthreads();
  }

  // 4. store (R^T z added for a spline member), pads 0
  for (int e = threadIdx.x; sums && e < rows * n_max; e += kThreads) {
    const int r = e / n_max, i = e - r * n_max;
    double vy = 0.0, vd = 0.0;
    if (i < n) {
      vy = yb[r * ld + i];
      const double* z = db + r * ld;
      if (kd != 0) {
        vy = fma(s[kRd * n_max + i], z[i], vy);
        if (i + 1 < n) vy = fma(s[kRl * n_max + i + 1], z[i + 1], vy);
        if (i > 0) vy = fma(s[kRu * n_max + i - 1], z[i - 1], vy);
      } else {
        vd = z[i];
      }
    }
    double* xr = Xb + ((size_t)(r0 + r) * G + g) * K * n_max;
    xr[i] = vy;
    if (K == 2) xr[n_max + i] = vd;
  }
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, int n_max, int* tr, size_t* smem) {
  *tr = tile_rows(n_max);
  if (*tr < 1) return cudaErrorInvalidValue;
  *smem = (size_t)2 * *tr * row_stride(n_max) * sizeof(double);
  if (*smem > 48 * 1024)
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)*smem);
  return cudaSuccess;
}

template <int kStages>
cudaError_t launch_t(const double* Ub, int R, int G, int K, int n_max,
                     int W_max, const int* kind, const int* nk,
                     const int* nw, const double* qw, const double* sp,
                     const int* iq, const int* fcp, const int* fchunk,
                     const int* ftab, int nc, int tr, double* Xb,
                     cudaStream_t stream) {
  auto kernel = fitted_rows_t_kernel<kStages>;
  const size_t smem = fit_t_smem(tr, kStages, n_max, nc);
  // the most shared memory an SM can give, so that kBlocksSM blocks fit
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((R + tr - 1) / tr, G);
  kernel<<<grid, kThreads + 32, smem, stream>>>(
      Ub, R, G, K, n_max, W_max, kind, nk, nw, qw, sp, iq, fcp,
      reinterpret_cast<const int4*>(fchunk), ftab, nc, tr, Xb);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fitted_rows_f64(const double* X, int R, int G, int K,
                               int n_max, int W_max, const int* kind,
                               const int* nk, const int* nw, const int* qidx,
                               const double* qw, const double* sp, double* U,
                               cudaStream_t stream) {
  if (R <= 0 || G <= 0 || W_max <= 0) return 0;
  int tr;
  size_t smem;
  cudaError_t err = prepare(fitted_rows_kernel, n_max, &tr, &smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((R + tr - 1) / tr, G);
  fitted_rows_kernel<<<grid, kThreads, smem, stream>>>(
      X, R, G, K, n_max, W_max, kind, nk, nw, qidx, qw, sp, tr, U);
  return (int)cudaGetLastError();
}

extern "C" int fitted_rows_t_f64(const double* Ub, int R, int G, int K,
                                 int n_max, int W_max, const int* kind,
                                 const int* nk, const int* nw,
                                 const double* qw, const double* sp,
                                 const int* iq, const int* fcp,
                                 const int* fchunk, const int* ftab,
                                 int nc, double* Xb,
                                 cudaStream_t stream) {
  if (R <= 0 || G <= 0) return 0;
  const int tr = fit_t_tile(R, G, n_max, nc);
  switch (fit_t_stages(tr)) {
    case 2:
      return (int)launch_t<2>(Ub, R, G, K, n_max, W_max, kind, nk, nw, qw,
                              sp, iq, fcp, fchunk, ftab, nc, tr, Xb,
                              stream);
    case 3:
      return (int)launch_t<3>(Ub, R, G, K, n_max, W_max, kind, nk, nw, qw,
                              sp, iq, fcp, fchunk, ftab, nc, tr, Xb,
                              stream);
    default:
      return (int)launch_t<4>(Ub, R, G, K, n_max, W_max, kind, nk, nw, qw,
                              sp, iq, fcp, fchunk, ftab, nc, tr, Xb,
                              stream);
  }
}
