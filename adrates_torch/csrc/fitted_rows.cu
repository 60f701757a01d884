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
//                      four weights, summed by interval and added to the
//                      interval's two knots (the queries taken in interval
//                      order, iq / ikey: a fixed order, no atomics); for a
//                      spline member d-bar -> z = T^-T d-bar and y-bar +=
//                      R^T z, and slot 1 is 0.
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
// query values are the most of it. The work is a few FMAs a byte. A spline
// member's solve is a chain of about 2 n dependent FMAs a row (n = 73 on
// GBP, USD, EUR, 43 on JPY and AUD): about 3 us at 1.7 GHz, taken once a
// tile and hidden behind other blocks' query phases.
//
// Design: one block a (tile of rows, member) -- the grid is
// [ceil(R / rows), G] --, 256 threads.
//
// - K6: the tile's y rows (and d rows of a Hermite member) staged in
//   shared memory, coalesced; a spline member's rows solved one lane a row
//   (the first warp) from the stored factors, into the d rows; then a
//   thread a query loads its bracket and weights once and writes its value
//   in every row of the tile (stores coalesced along the queries; the
//   tables are read once a tile, not once a value).
// - K7: a warp takes up to four rows (wid, wid + 8, ...) and walks the
//   member's queries in interval order, 32 at a time, the rows' loads
//   issued together (coalesced where the queries are sorted, as the stage
//   rows' are): a lane's four products a row are summed over its
//   interval's lanes by a segmented shuffle scan, the rows' scans
//   interleaved, and
//   the interval's last lane adds them to the interval's left knot's
//   shared y-bar / d-bar, then, after a __syncwarp, to its right knot's.
//   An interval of hundreds of queries (a short curve's extrapolated
//   tail) is thus spread over lanes, not walked by one thread. A spline
//   member's rows then go through U^T and L^T (one lane a row), and R^T
//   is applied as the rows are stored. A call of few rows (R G below
//   8 x 264) takes smaller tiles, down to a row a warp, to fill the SMs.
// - Rows of the shared tiles have an odd stride (n_max | 1 doubles), so the
//   solving lanes, a row each, hit distinct banks. A tile is 32 rows where
//   two of them fit 96 KB of shared memory (n_max < 192), else fewer
//   (down to 1 row: n_max < 6144).
//
// No atomics, no allocation, one launch on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 32;              // rows a tile (the solving warp)
constexpr int kWarps = kThreads / 32;
constexpr int kRowsWarp = kMaxRows / kWarps;  // K7: rows a warp sums
constexpr int kSmemBudget = 96 * 1024;    // bytes of shared memory a block
constexpr int kBlocksWanted = 264;        // K7: two blocks for each of 132 SMs
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

__global__ void __launch_bounds__(kThreads)
    fitted_rows_t_kernel(const double* __restrict__ Ub, int R, int G, int K,
                         int n_max, int W_max, const int* __restrict__ kind,
                         const int* __restrict__ nk,
                         const int* __restrict__ nw,
                         const double* __restrict__ qw,
                         const double* __restrict__ sp,
                         const int* __restrict__ iq,
                         const int* __restrict__ ikey, int TR,
                         double* __restrict__ Xb) {
  extern __shared__ double smem[];
  const int g = blockIdx.y;
  const int r0 = blockIdx.x * TR;
  const int rows = min(TR, R - r0);
  const int n = nk[g], W = nw[g], kd = kind[g];
  const int ld = row_stride(n_max);
  double* yb = smem;              // [TR][ld] knot-value cotangents
  double* db = smem + TR * ld;    // [TR][ld] slope cotangents, then z
  for (int e = threadIdx.x; e < rows * ld; e += blockDim.x) {
    yb[e] = 0.0;
    db[e] = 0.0;
  }
  __syncthreads();

  // 1. the member's queries in interval order, 32 at a time, a warp
  //    kRowsWarp rows (wid, wid + 8, ...), their loads issued together:
  //    each lane's four products v w00, v w10, v w01, v w11 summed over
  //    its interval's lanes by a segmented scan; the interval's last lane
  //    adds them to the interval's left knot, then (after the warp's other
  //    intervals did) to its right
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int* qq = iq + (size_t)g * W_max;
  const int* kk = ikey + (size_t)g * W_max;
  const double* w4 = qw + (size_t)g * W_max * 4;
  const double* ub = Ub + ((size_t)r0 * G + g) * W_max;
  const size_t step = (size_t)G * W_max;
  for (int k0 = 0; k0 < W; k0 += 32) {
    const int k = k0 + lane;
    const bool live = k < W;
    int w = 0, j = 0x7fffffff;          // a dead lane: its own interval
    double2 a = make_double2(0.0, 0.0), c = make_double2(0.0, 0.0);
    if (live) {
      w = __ldg(qq + k);
      j = __ldg(kk + k);
      a = ld2(w4 + 4 * w);
      c = ld2(w4 + 4 * w + 2);
    }
    const int jn = __shfl_down_sync(0xffffffffu, j, 1);
    const bool last = live && (lane == 31 || jn != j);
    double p[kRowsWarp][4];
#pragma unroll
    for (int q = 0; q < kRowsWarp; ++q) {
      const int r = wid + q * kWarps;
      const double v = live && r < rows ? ub[r * step + w] : 0.0;
      p[q][0] = a.x * v;
      p[q][1] = a.y * v;
      p[q][2] = c.x * v;
      p[q][3] = c.y * v;
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      // every lane shuffles (a full-mask shuffle skipped by a lane is
      // undefined), then only those past ``off`` in the interval add
      const int jo = __shfl_up_sync(0xffffffffu, j, off);
      const bool take = lane >= off && jo == j;
#pragma unroll
      for (int q = 0; q < kRowsWarp; ++q) {
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const double t = __shfl_up_sync(0xffffffffu, p[q][m], off);
          if (take) p[q][m] += t;
        }
      }
    }
    if (last) {
#pragma unroll
      for (int q = 0; q < kRowsWarp; ++q) {
        const int r = wid + q * kWarps;
        if (r < rows) {
          yb[r * ld + j] += p[q][0];
          db[r * ld + j] += p[q][1];
        }
      }
    }
    __syncwarp();
    if (last) {
#pragma unroll
      for (int q = 0; q < kRowsWarp; ++q) {
        const int r = wid + q * kWarps;
        if (r < rows) {
          yb[r * ld + j + 1] += p[q][2];
          db[r * ld + j + 1] += p[q][3];
        }
      }
    }
    __syncwarp();
  }
  __syncthreads();

  // 2. a spline member: z = T^-T d-bar = L^-T U^-T d-bar, one lane a row
  const double* s = sp + (size_t)g * 6 * n_max;
  if (kd != 0) {
    if ((int)threadIdx.x < rows) {
      double* z = db + threadIdx.x * ld;
      double v = 0.0;
      for (int i = 0; i < n; ++i) {           // U^T: c_{i-1} below b'_i
        const double c = i > 0 ? s[kC * n_max + i - 1] : 0.0;
        v = fma(-c, v, z[i]) * s[kRb * n_max + i];
        z[i] = v;
      }
      double b = 0.0;
      for (int i = n - 1; i >= 0; --i) {      // L^T: l_{i+1} right of 1
        const double l = i + 1 < n ? s[kL * n_max + i + 1] : 0.0;
        b = fma(-l, b, z[i]);
        z[i] = b;
      }
    }
    __syncthreads();
  }

  // 3. store (R^T z added for a spline member), pads 0
  for (int e = threadIdx.x; e < rows * n_max; e += blockDim.x) {
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
                                 const int* iq, const int* ikey, double* Xb,
                                 cudaStream_t stream) {
  if (R <= 0 || G <= 0) return 0;
  int tr;
  size_t smem;
  cudaError_t err = prepare(fitted_rows_t_kernel, n_max, &tr, &smem);
  if (err != cudaSuccess) return (int)err;
  // a small call (few rows of few members) takes tiles of as few as a
  // row a warp, so that it still spreads over the SMs
  const long want = ((long)R * G + kBlocksWanted - 1) / kBlocksWanted;
  if (want < tr) {
    tr = want < kWarps ? (tr < kWarps ? tr : kWarps) : (int)want;
    smem = (size_t)2 * tr * row_stride(n_max) * sizeof(double);
  }
  dim3 grid((R + tr - 1) / tr, G);
  fitted_rows_t_kernel<<<grid, kThreads, smem, stream>>>(
      Ub, R, G, K, n_max, W_max, kind, nk, nw, qw, sp, iq, ikey, tr, Xb);
  return (int)cudaGetLastError();
}
