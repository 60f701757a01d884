// K6 / K7: the fitted schemes' evaluation at static queries, its tangent,
// and the transpose of its linear core (f64).
//
// Replace the fit and the evaluation of the fitted schemes at static
// queries: adrates_tpu/ops/interpolation.py interp_fit (:350) and
// interp_df (:375), as adrates_tpu/parallel/curve_batching.py stage_rows
// (:320) runs them for each fitted member of a stage (the port's
// ops/fitted_rows.py fitted_eval). On a static plan the knots x, the
// queries q and their brackets i = idx(q) are fixed when the book compiles;
// past the scheme's elementwise transform of the DFs (the log DF, or the
// zero rate -log(df) / (t + gSmall) with the t = 0 knot patched to its
// neighbour), each member is a cubic Hermite interpolant
//
//   u = w00 y_i + w10 d_i + w01 y_{i+1} + w11 d_{i+1},  df(q) = exp(fac u)
//
// with static weights (hermite_eval's h00, h10 h, h01, h11 h) and fac = 1
// (log DF) or -q (zero rates), on slopes d that are pchip_slopes' (the
// PCHIP schemes) or the spline's, d = T^-1 R y (the three spline schemes:
// T the knot-slope tridiagonal, R the static map from y to its right-hand
// side; both depend on the knots alone).
//
//   K6 fitted_eval:     out [R, G, W_max] from the DFs [R, G, L] (member
//                       g's knots first; pad knots and positions past them
//                       not read, pad queries 1): the whole evaluation.
//   K6 fitted_eval_jvp: its tangent mode, dout [R, D, G, W_max] = out (fac
//                       du) from the DFs, D tangent rows a primal row
//                       [R, D, G, L] and out: the transforms' tangents (dd
//                       / d, divided by -(t + gSmall) for zero rates),
//                       PCHIP's slope derivative (exactly 0 where its guard
//                       m0 m1 > 0 is false) or the spline's solve of dy,
//                       the Hermite rows of (dy, dd); pad queries 0.
//   K6 fitted_rows:     the linear core alone, U [R, G, W_max] from X [R,
//                       G, K, n_max] (the knot values, and a Hermite
//                       member's slopes in slot 1): K7's own derivative.
//   K7 fitted_rows_t:   the core's exact transpose, Xb [R, G, K, n_max]
//                       from Ub [R, G, W_max]: each query's cotangent times
//                       its four weights, summed by interval into the
//                       interval's two knots in a fixed order (no atomics);
//                       for a spline member d-bar -> z = T^-T d-bar and
//                       y-bar += R^T z, and slot 1 is 0. The reverse mode
//                       of fitted_eval is K7 between torch ops (the vjp of
//                       exp(fac u) before it, of the transforms after).
//
// Members are padded to n_max knots (T's pad rows identity, R's and the
// weights' pad entries 0: pads are never read) and W_max queries.
//
// K6 takes a spline member's slopes and rows as the plain version does,
// operation for operation (no FMA contraction): the right-hand side from
// the secants, the parallel cyclic reduction of utils/math.py
// solve_tridiagonal, and cubic_eval's power form. T's reduced coefficients
// depend on the knots alone, so the host computes them once in that
// order: pc [G, 2 + 2 st, n_max] = (h, the reduced diagonal b, then each
// of the st = ceil(log2 n_max) steps' alpha and gamma), beside the
// offsets qu [G, W_max] = q - x[idx]. A cubic's extrapolation past the
// last knot multiplies a rounding difference by up to (q - x)^3 / h^3
// (the spline cell's 43-knot members reach 11.5 last intervals past
// their last knot), so Thomas sweeps or the Hermite form departed from
// the plain version by more than 1e-12 of the values there; in one order
// they agree bit for bit. K7 keeps T factored once on the host in f64
// (Thomas: T = L U, L unit lower with multipliers l_i, U upper with
// pivots b'_i and super-diagonal c_i; T is strictly diagonally dominant,
// so no pivoting): sp [G, 6, n_max] = (l, 1 / b', c, rl, rd, ru), R's
// three diagonals last. fx [G, 5, n_max] = (-(x + gSmall), h, PCHIP's w1,
// w2, w12) and fmode [G] (zero rates, t = 0 patched) are the transforms'.
//
// What bounds them on an H100: bytes. K6 writes R G W_max values (and D
// times as many tangents) from R G n_max DFs; K7 the reverse; the tables
// (about 44 G W_max + 88 G n_max bytes) come once from HBM, then from L2:
// on the spline cell's stages (n_max 73, W_max the book's unique times) the
// query values are the most of it. The work is a few FMAs a byte.
//
// K6 (one kernel, k6_kernel<kMode>, for its three entries): one block a
// tile and a member, 256 threads. A tile is tp primal rows or (tangent
// mode) one primal row and td of its directions (k6_tile: at most 32 primal
// rows, 64 staged rows and 96 KB; the largest that still gives every SM a
// block, then, in tangent mode, directions split on to two blocks an SM
// while a block keeps 2^15 outputs; all D directions of a row where they
// fit, or tiles of them, the primal row's transforms taken again in each),
// and where one-row tiles still leave SMs without a block, a tile of its
// queries (a multiple of 32; the row's transforms and slopes taken again
// in each, a tile of pad queries alone skipping them).
// The block stages its member's tables (pc, fx) in shared memory once,
// then its rows' transformed knot values and tangents, a thread a (row,
// knot), coalesced; PCHIP's slopes (or their tangents) a thread a (row,
// knot); a spline's solve from shared memory, a warp a row (spline_pcr:
// the steps' reads and writes ping-pong between the row and the warp's
// scratch row); then a thread a query loads its bracket, weights (a
// spline's offset and interval) and fac once and writes its value in
// every row of the tile (stores coalesced along the queries).
// Rows of the shared tiles have an odd stride (n_max | 1 doubles), so the
// solving lanes, a row each, hit distinct banks. No atomics, no
// allocation, no local memory (ptxas, 0 spill bytes; each entry's
// registers in chip_smoke's phase 8 and scripts/k6_phases.py).
//
// What holds it (scripts/k6_phases.py on an H100 80GB HBM3 at 700 W,
// seeded inputs at the spline cell's shapes): the tangent mode at region
// A (50 rows x 32 directions of 5 members, 2,225 queries) takes 0.0970
// ms (two blocks an SM, tiles of 16 directions, overlap one's work with
// the other's stores). The primal evaluations are a block's own chain of
// dependent steps (the member's tables, the DFs and the query tables from
// memory, the log, the slopes, the spline's coefficients, exp): A 0.0121
// ms, C1 (one PCHIP member, 744 queries in 200 blocks) 0.0053, the
// gammas' (1 row of 5 members, 4,337 queries in 140 blocks) 0.0080. The
// plain version's order costs divisions: the right-hand side's secants,
// the reduction's last quotient and three a spline interval (taken once
// a row and interval, not a query: a tangent call a query took 2.7 times
// as long). Thomas sweeps on stored factors and the Hermite form, in
// place of these, took 0.0858, 0.0090, 0.0052 and 0.0050 ms.
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

constexpr int kThreads = 256;            // K6's threads, K7's summing ones
// K6
constexpr int kMaxTileRows = 32;          // primal rows a tile, at most
constexpr int kMaxSlots = 64;             // rows a tile stages, at most
constexpr int kSmemPref = 96 * 1024;      // a tile's shared memory, at most
constexpr int kSmemMax = 232448;          // ... where one row needs more
constexpr int kFxRows = 5;                // fx's rows a member
constexpr long kMinOutputs = 1L << 15;    // a block's outputs, to split more
constexpr int kWarps = kThreads / 32;
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
// fx slots (fitted_rows.py FX_*): -(x + gSmall), h, PCHIP's w1, w2, w12
enum { kNegX = 0, kH = 1, kW1 = 2, kW2 = 3, kW12 = 4 };
enum { kZeroRates = 1, kPatch = 2 };      // fmode bits (fitted_rows.py FM_*)
// K6's entries: the linear map, the whole evaluation, its tangent mode
enum { kLinear = 0, kEval = 1, kTangent = 2 };

__host__ __device__ inline int row_stride(int n_max) { return n_max | 1; }

// the steps of the plain version's parallel cyclic reduction over n_max
// rows (utils/math.py solve_tridiagonal: ceil(log2 n), at least 1), and
// the rows of a member's PCR table pc: h, the reduced diagonal b, then
// each step's alpha and gamma (kernels.fitted_tables)
__host__ __device__ inline int pcr_steps(int n_max) {
  int s = 0;
  while ((1 << s) < n_max) ++s;
  return n_max > 1 ? (s > 1 ? s : 1) : 0;
}
__host__ __device__ inline int pcr_rows(int n_max) {
  return 2 + 2 * pcr_steps(n_max);
}
// a tile's table rows in shared memory: pc's, then (not kLinear) fx's
__host__ __device__ inline int tab_rows(int n_max, bool linear) {
  return pcr_rows(n_max) + (linear ? 0 : kFxRows);
}

__device__ __forceinline__ double2 ld2(const double* p) {
  return __ldg(reinterpret_cast<const double2*>(p));
}

// the SMs of the current device (kSMs where it cannot be read)
int sm_count() {
  static int n = 0;
  if (n <= 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess
        || cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev)
               != cudaSuccess
        || n <= 0)
      n = kSMs;
  }
  return n;
}

// a K6 launch's tiles: tp primal rows and (tangent mode) td directions a
// block, nd_tiles direction tiles a primal tile, tw queries a block and
// nw_tiles query tiles a (row, direction) tile; the member's tables staged
// in shared memory where they fit
struct K6Tile {
  int tp, td, nd_tiles, tw, nw_tiles;
  bool stage;
  size_t smem;
};

// the warps that solve a tile's spline rows, each with a scratch row: one a
// row, at most kWarps (tp rows, or tp (slots - 1) direction rows); a slot
// takes four rows (knot values, slopes, a spline's two coefficients)
__host__ __device__ inline int solve_warps(int tp, int slots) {
  const int rows = slots > 1 ? tp * (slots - 1) : tp;
  return rows < kWarps ? rows : kWarps;
}

size_t k6_smem(int tp, int slots, int n_max, bool stage) {
  return sizeof(double)
         * ((stage ? (size_t)tab_rows(n_max, false) * n_max : 0)
            + ((size_t)4 * tp * slots + solve_warps(tp, slots))
                  * row_stride(n_max));
}

// The most rows a tile (up to kMaxTileRows primal rows, kMaxSlots staged
// rows, kSmemPref bytes) that still gives a block to every SM; in tangent
// mode all D directions of a primal row where they fit, else tiles of
// them, halved until every SM has a block, and on to two blocks an SM
// while a block keeps kMinOutputs outputs (its stores then overlap the
// other block's prologue: region A's 50 x 32 directions 0.0914 -> 0.0872
// ms in 500 tiles of 16, scripts/k6_phases.py). Where one-row tiles still
// leave SMs without a block (R G D below the SM count: region C1's primal
// [50, 1], the gammas' [1, 5]), the queries are cut into tiles of a
// multiple of 32 (at least 32), as many as give every SM a block; each
// query tile takes its row's transforms and slopes again.
K6Tile k6_tile(int R, int D, int G, int n_max, int W_max, bool tangent) {
  const long sms = sm_count();
  auto slots = [&](int td) { return tangent ? 1 + td : 1; };
  auto fits = [&](int tp, int td) {
    return k6_smem(tp, slots(td), n_max, true) <= (size_t)kSmemPref;
  };
  auto blocks = [&](int tp, int td) {
    return (long)((R + tp - 1) / tp) * (tangent ? (D + td - 1) / td : 1) * G;
  };
  K6Tile t{1, tangent ? D : 0, 1, W_max, 1, true, 0};
  while (tangent && t.td > 1 && (slots(t.td) > kMaxSlots || !fits(1, t.td)))
    t.td = (t.td + 1) / 2;
  if (!tangent || t.td == D)
    while (t.tp < kMaxTileRows && 2 * t.tp * slots(t.td) <= kMaxSlots
           && fits(2 * t.tp, t.td) && blocks(2 * t.tp, t.td) >= sms)
      t.tp *= 2;
  while (tangent && t.tp == 1 && t.td > 1 && blocks(1, t.td) < sms)
    t.td = (t.td + 1) / 2;
  while (tangent && t.tp == 1 && t.td > 1 && blocks(1, t.td) < 2 * sms
         && (long)(t.td / 2) * W_max >= kMinOutputs)
    t.td = (t.td + 1) / 2;
  t.nd_tiles = tangent ? (D + t.td - 1) / t.td : 1;
  const long b = blocks(t.tp, t.td);
  if (b < sms) {
    const long need = (sms + b - 1) / b;
    const int tw = max(32, (int)(W_max / need) / 32 * 32);
    if (tw < W_max) {
      t.tw = tw;
      t.nw_tiles = (W_max + tw - 1) / tw;
    }
  }
  t.stage = fits(t.tp, t.td);
  t.smem = k6_smem(t.tp, slots(t.td), n_max, t.stage);
  return t;
}

// The plain version's arithmetic, operation for operation: each product
// and sum rounded on its own (never contracted into an FMA), so that K6's
// spline and Hermite rows equal fitted_rows_plain's bit for bit where
// their inputs do. A cubic's extrapolation far past the last knot
// multiplies any rounding difference by up to (q - x)^3 / h^3, so a
// different order of the same sums (Thomas against PCR, the Hermite form
// against the power form) departs by more than 1e-12 of the values there.
__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ double sub(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ double quo(double a, double b) {
  return __ddiv_rn(a, b);
}

// a knot's transformed value from its DF row: the log DF or the zero rate
// -log(df) / (t + gSmall) (as log(df) / -(t + gSmall)), the t = 0 knot of
// a patched member taking its neighbour's
__device__ __forceinline__ double knot_value(const double* d,
                                             const double* negx, int i,
                                             int md) {
  const int j = (md & kPatch) && i == 0 ? 1 : i;
  const double y = log(d[j]);
  return (md & kZeroRates) ? y / negx[j] : y;
}

// its tangent along the DF row's tangent dd
__device__ __forceinline__ double knot_tangent(const double* d,
                                               const double* dd,
                                               const double* negx, int i,
                                               int md) {
  const int j = (md & kPatch) && i == 0 ? 1 : i;
  const double dy = dd[j] / d[j];
  return (md & kZeroRates) ? dy / negx[j] : dy;
}

// pchip_slopes at knot i of the row y (n knots): the end knots the
// one-sided secants, an interior knot the weighted harmonic mean of its
// secants where they have one sign (m0 m1 > 0), else 0
__device__ __forceinline__ double pchip_slope(const double* y,
                                              const double* fx, int n_max,
                                              int i, int n) {
  const double* h = fx + kH * n_max;
  if (i == 0) return (y[1] - y[0]) / h[0];
  if (i == n - 1) return (y[n - 1] - y[n - 2]) / h[n - 2];
  const double m0 = (y[i] - y[i - 1]) / h[i - 1];
  const double m1 = (y[i + 1] - y[i]) / h[i];
  if (!(m0 * m1 > 0)) return 0.0;
  const int j = i - 1;
  return fx[kW12 * n_max + j]
      / (fx[kW1 * n_max + j] / m0 + fx[kW2 * n_max + j] / m1);
}

// its derivative along dy: the secants' tangents at the end knots; an
// interior knot, where the guard holds, -w12 dden / den^2 with den =
// w1 / m0 + w2 / m1 and dden = -(w1 / m0) (dm0 / m0) - (w2 / m1) (dm1 /
// m1); exactly 0 where it does not
__device__ __forceinline__ double pchip_dslope(const double* y,
                                               const double* dy,
                                               const double* fx, int n_max,
                                               int i, int n) {
  const double* h = fx + kH * n_max;
  if (i == 0) return (dy[1] - dy[0]) / h[0];
  if (i == n - 1) return (dy[n - 1] - dy[n - 2]) / h[n - 2];
  const double m0 = (y[i] - y[i - 1]) / h[i - 1];
  const double m1 = (y[i + 1] - y[i]) / h[i];
  if (!(m0 * m1 > 0)) return 0.0;
  const int j = i - 1;
  const double dm0 = (dy[i] - dy[i - 1]) / h[i - 1];
  const double dm1 = (dy[i + 1] - dy[i]) / h[i];
  const double a = fx[kW1 * n_max + j] / m0, b = fx[kW2 * n_max + j] / m1;
  const double den = a + b;
  const double dden = -add(mul(a, dm0 / m0), mul(b, dm1 / m1));
  return -(fx[kW12 * n_max + j] / den) * (dden / den);
}

// hermite_eval's row: w00 y_i + w10 d_i + w01 y_i+1 + w11 d_i+1, summed
// left to right
__device__ __forceinline__ double hermite_u(double2 a, double2 c, double y0,
                                            double d0, double y1,
                                            double d1) {
  return add(add(add(mul(a.x, y0), mul(a.y, d0)), mul(c.x, y1)),
             mul(c.y, d1));
}

// cubic_spline_coeffs' coefficients of interval i of a row (knot values
// y, slopes d, interval length h): c1 = (3 m - 2 d_i - d_i+1) / h and c0 =
// (d_i + d_i+1 - 2 m) / h^2, m the secant
__device__ __forceinline__ void spline_coefs(const double* y, const double* d,
                                             int i, double h, double& c1,
                                             double& c0) {
  const double m = quo(sub(y[i + 1], y[i]), h);
  c1 = quo(sub(sub(mul(3.0, m), mul(2.0, d[i])), d[i + 1]), h);
  c0 = quo(sub(add(d[i], d[i + 1]), mul(2.0, m)), mul(h, h));
}

// cubic_eval's row in the power form on the query's offset uq = q - x_i:
// ((c0 uq + c1) uq + d_i) uq + y_i
__device__ __forceinline__ double spline_u(double y0, double s0, double c1,
                                           double c0, double uq) {
  return add(mul(add(mul(add(mul(c0, uq), c1), uq), s0), uq), y0);
}

// cubic_spline_coeffs' right-hand side at knot i of the row y (n knots):
// 3 m_0 at the first, 3 m_n-2 at the last (0 for a clamped end), else
// 3 (m_i-1 / h_i-1 + m_i / h_i)
__device__ __forceinline__ double spline_rhs(const double* y, const double* h,
                                             int i, int n, bool clamped) {
  auto m = [&](int j) { return quo(sub(y[j + 1], y[j]), h[j]); };
  if (i == 0) return mul(3.0, m(0));
  if (i == n - 1) return clamped ? 0.0 : mul(3.0, m(n - 2));
  return mul(3.0, add(mul(m(i - 1), quo(1.0, h[i - 1])),
                      mul(m(i), quo(1.0, h[i]))));
}

// A spline row's slopes, one warp a row, by the plain version's parallel
// cyclic reduction (utils/math.py solve_tridiagonal): the right-hand side
// into d, then at each step k (stride 2^k) d_i <- (d_i + alpha_i d_i-s) +
// gamma_i d_i+s, reading the step's old values (ping-pong with the warp's
// scratch row tmp), and d_i / b_i at the end. T's reduced coefficients
// alpha, gamma and b depend on the knots alone and come from the host
// (the member's table P: h, b, then alpha and gamma a step), computed
// there in the plain version's order; rows past the member's n knots are
// decoupled and hold 0, so they read as 0.
__device__ __forceinline__ void spline_pcr(const double* y, double* d,
                                           double* tmp, const double* P,
                                           int n_max, int n, bool clamped,
                                           int lane) {
  const double* h = P;
  for (int i = lane; i < n; i += 32) d[i] = spline_rhs(y, h, i, n, clamped);
  __syncwarp();
  double* cur = d;
  double* nxt = tmp;
  const int st = pcr_steps(n_max);
  for (int k = 0; k < st; ++k) {
    const int s = 1 << k;
    const double* al = P + (2 + 2 * k) * n_max;
    const double* ga = al + n_max;
    for (int i = lane; i < n; i += 32) {
      const double up = i >= s ? cur[i - s] : 0.0;
      const double dn = i + s < n ? cur[i + s] : 0.0;
      nxt[i] = add(add(cur[i], mul(al[i], up)), mul(ga[i], dn));
    }
    __syncwarp();
    double* t = cur;
    cur = nxt;
    nxt = t;
  }
  for (int i = lane; i < n; i += 32) d[i] = quo(cur[i], P[n_max + i]);
  __syncwarp();
}

// K6, one block a (tile, member), kThreads threads. A tile is tp primal
// rows (kLinear, kEval), or tp primal rows and td of their directions
// (kTangent). Its rows in shared memory: slots of a knot-value row (ys)
// and a slope row (ds), S slots a primal row (1, or 1 + td: the primal's
// transformed knots, then each direction's tangents).
template <int kMode>
__global__ void __launch_bounds__(kThreads, 2)
    k6_kernel(const double* __restrict__ X, const double* __restrict__ dX,
              const double* __restrict__ V, int R, int D, int G, int ldx,
              int n_max, int W_max, const int* __restrict__ kind,
              const int* __restrict__ nk, const int* __restrict__ nw,
              const int* __restrict__ fmode, const int* __restrict__ qidx,
              const double* __restrict__ qw, const double* __restrict__ qu,
              const double* __restrict__ pc, const double* __restrict__ fx,
              const double* __restrict__ fac, int TP, int TD, int nDT,
              int TW, int nWT, int stage, double* __restrict__ Y) {
  extern __shared__ __align__(16) double smem[];
  const int g = blockIdx.y;
  const int qt = blockIdx.x % nWT, bd = blockIdx.x / nWT;
  const int bt = bd / nDT, dt = bd - bt * nDT;
  const int w0 = qt * TW, w1 = min(W_max, w0 + TW);
  const int p0 = bt * TP, np = min(TP, R - p0);
  const int k0 = dt * TD;
  const int nd = kMode == kTangent ? min(TD, D - k0) : 0;
  const int S = kMode == kTangent ? 1 + TD : 1;
  const int n = nk[g], W = nw[g], kd = kind[g];
  const int md = kMode == kLinear ? 0 : fmode[g];
  const int ld = row_stride(n_max);
  const int prow = pcr_rows(n_max);
  const double* P = pc + (size_t)g * prow * n_max;
  const double* fxg =
      kMode == kLinear ? nullptr : fx + (size_t)g * kFxRows * n_max;
  // a slot's rows, cs apart: its knot values ys, slopes ds and (a
  // spline) its intervals' coefficients c1, c0; then the solve's scratch
  const int cs = TP * S * ld;
  double* ys = smem + (stage ? tab_rows(n_max, false) * n_max : 0);
  double* ds = ys + cs;                                // [TP S][ld]
  double* scr = ys + 4 * cs;                           // [nsw][ld]
  const int nsw = solve_warps(TP, S);

  // a query tile of pads alone (past the member's W queries) skips the
  // prologue
  if (w0 < W) {
    // 0. the member's tables (its PCR table; the transforms' rows) once
    if (stage) {
      const int nrow = tab_rows(n_max, kMode == kLinear);
      for (int e = threadIdx.x; e < nrow * n; e += kThreads) {
        const int r = e / n, i = e - r * n;
        smem[r * n_max + i] = r < prow ? P[r * n_max + i]
                                       : fxg[(r - prow) * n_max + i];
      }
      P = smem;
      if (kMode != kLinear) fxg = smem + prow * n_max;
      __syncthreads();                        // step 1 reads fx
    }

    // 1. the knot values (kLinear: as given, with a Hermite member's
    //    slopes; else the transforms of the DFs) and, in tangent mode, each
    //    direction's tangents; a thread a (row, knot), coalesced
    for (int e = threadIdx.x; e < np * n; e += kThreads) {
      const int p = e / n, i = e - p * n;
      const double* xr = X + ((size_t)(p0 + p) * G + g) * ldx;
      double* y = ys + p * S * ld;
      if (kMode == kLinear) {
        y[i] = xr[i];
        if (kd == 0) ds[p * ld + i] = xr[n_max + i];
      } else {
        y[i] = knot_value(xr, fxg + kNegX * n_max, i, md);
      }
    }
    if (kMode == kTangent)
      for (int e = threadIdx.x; e < np * nd * n; e += kThreads) {
        const int pk = e / n, i = e - pk * n;
        const int p = pk / nd, k = pk - p * nd;
        const double* xr = X + ((size_t)(p0 + p) * G + g) * ldx;
        const double* dxr = dX + (((size_t)(p0 + p) * D + k0 + k) * G + g) * ldx;
        ys[(p * S + 1 + k) * ld + i] =
            knot_tangent(xr, dxr, fxg + kNegX * n_max, i, md);
      }
    __syncthreads();

    // 2. the slopes: PCHIP's (or their tangents) a thread a (row, knot); a
    //    spline's solve (spline_pcr) a warp a row
    const int nrows = kMode == kTangent ? np * nd : np;
    if (kd == 0 && kMode != kLinear) {
      for (int e = threadIdx.x; e < nrows * n; e += kThreads) {
        const int rr = e / n, i = e - rr * n;
        if (kMode == kEval) {
          ds[rr * ld + i] = pchip_slope(ys + rr * ld, fxg, n_max, i, n);
        } else {
          const int p = rr / nd, s = p * S + 1 + (rr - p * nd);
          ds[s * ld + i] =
              pchip_dslope(ys + p * S * ld, ys + s * ld, fxg, n_max, i, n);
        }
      }
      __syncthreads();
    } else if (kd != 0) {
      const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5;
      for (int rr = wp; wp < nsw && rr < nrows; rr += nsw) {
        const int s =
            kMode == kTangent ? (rr / nd) * S + 1 + rr % nd : rr;
        spline_pcr(ys + s * ld, ds + s * ld, scr + wp * ld, P, n_max, n,
                   kd == 2, lane);
      }
      __syncthreads();
      // the coefficients once a (row, interval), not a (row, query): their
      // three divisions are most of a query's work otherwise
      for (int e = threadIdx.x; e < nrows * (n - 1); e += kThreads) {
        const int rr = e / (n - 1), i = e - rr * (n - 1);
        const int s =
            kMode == kTangent ? (rr / nd) * S + 1 + rr % nd : rr;
        double* y = ys + s * ld;
        spline_coefs(y, y + cs, i, P[i], y[2 * cs + i], y[3 * cs + i]);
      }
      __syncthreads();
    }
  }

  // 3. a thread a query: its bracket, weights or offset (and fac) loaded
  //    once, then its value in every row of the tile (stores coalesced
  //    along queries): u (kLinear), exp(fac u) (kEval), V (fac du) a
  //    direction (kTangent), a Hermite member's u by hermite_u, a
  //    spline's by spline_u; pad queries 0, 1, 0
  const int* qi = qidx + (size_t)g * W_max;
  const double* w4 = qw + (size_t)g * W_max * 4;
  for (int w = w0 + threadIdx.x; w < w1; w += kThreads) {
    if (w < W) {
      const int i = __ldg(qi + w);
      double2 a = {0.0, 0.0}, c = {0.0, 0.0};
      double uq = 0.0;
      if (kd == 0) {
        a = ld2(w4 + 4 * w);
        c = ld2(w4 + 4 * w + 2);
      } else {
        uq = __ldg(qu + (size_t)g * W_max + w);
      }
      auto row = [&](const double* y, const double* d) {
        return kd == 0 ? hermite_u(a, c, y[i], d[i], y[i + 1], d[i + 1])
                       : spline_u(y[i], d[i], y[2 * cs + i], y[3 * cs + i],
                                  uq);
      };
      const double f = kMode == kLinear ? 0.0 : __ldg(fac + (size_t)g * W_max + w);
      for (int p = 0; p < np; ++p) {
        if (kMode == kTangent) {
          const size_t pr = (size_t)(p0 + p);
          const double v = __ldg(V + (pr * G + g) * W_max + w);
          for (int k = 0; k < nd; ++k) {
            const double du = row(ys + (p * S + 1 + k) * ld,
                                  ds + (p * S + 1 + k) * ld);
            Y[((pr * D + k0 + k) * G + g) * W_max + w] = mul(v, mul(f, du));
          }
        } else {
          const double u = row(ys + p * ld, ds + p * ld);
          Y[((size_t)(p0 + p) * G + g) * W_max + w] =
              kMode == kLinear ? u : exp(mul(f, u));
        }
      }
    } else {
      const double pad = kMode == kEval ? 1.0 : 0.0;
      for (int p = 0; p < np; ++p) {
        const size_t pr = (size_t)(p0 + p);
        if (kMode == kTangent) {
          for (int k = 0; k < nd; ++k)
            Y[((pr * D + k0 + k) * G + g) * W_max + w] = 0.0;
        } else {
          Y[(pr * G + g) * W_max + w] = pad;
        }
      }
    }
  }
}

template <int kMode>
int k6_launch(const double* X, const double* dX, const double* V, int R,
              int D, int G, int ldx, int n_max, int W_max, const int* kind,
              const int* nk, const int* nw, const int* fmode,
              const int* qidx, const double* qw, const double* qu,
              const double* pc,
              const double* fx, const double* fac, double* Y,
              cudaStream_t stream) {
  if (R <= 0 || G <= 0 || W_max <= 0 || (kMode == kTangent && D <= 0))
    return 0;
  const K6Tile t = k6_tile(R, D, G, n_max, W_max, kMode == kTangent);
  if (t.smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  auto kernel = k6_kernel<kMode>;
  if (t.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)t.smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(((R + t.tp - 1) / t.tp) * t.nd_tiles * t.nw_tiles, G);
  kernel<<<grid, kThreads, t.smem, stream>>>(
      X, dX, V, R, D, G, ldx, n_max, W_max, kind, nk, nw, fmode, qidx, qw,
      qu, pc, fx, fac, t.tp, t.td, t.nd_tiles, t.tw, t.nw_tiles,
      t.stage ? 1 : 0, Y);
  return (int)cudaGetLastError();
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
                               const double* qw, const double* qu,
                               const double* pc, double* U,
                               cudaStream_t stream) {
  return k6_launch<kLinear>(X, nullptr, nullptr, R, 0, G, K * n_max, n_max,
                            W_max, kind, nk, nw, nullptr, qidx, qw, qu, pc,
                            nullptr, nullptr, U, stream);
}

extern "C" int fitted_eval_f64(const double* dfs, int R, int G, int L,
                               int n_max, int W_max, const int* kind,
                               const int* nk, const int* nw,
                               const int* fmode, const int* qidx,
                               const double* qw, const double* qu,
                               const double* pc, const double* fx,
                               const double* fac, double* out,
                               cudaStream_t stream) {
  return k6_launch<kEval>(dfs, nullptr, nullptr, R, 0, G, L, n_max, W_max,
                          kind, nk, nw, fmode, qidx, qw, qu, pc, fx, fac,
                          out, stream);
}

extern "C" int fitted_eval_jvp_f64(const double* dfs, const double* ddfs,
                                   const double* vals, int R, int D, int G,
                                   int L, int n_max, int W_max,
                                   const int* kind, const int* nk,
                                   const int* nw, const int* fmode,
                                   const int* qidx, const double* qw,
                                   const double* qu, const double* pc,
                                   const double* fx, const double* fac,
                                   double* dout, cudaStream_t stream) {
  return k6_launch<kTangent>(dfs, ddfs, vals, R, D, G, L, n_max, W_max,
                             kind, nk, nw, fmode, qidx, qw, qu, pc, fx, fac,
                             dout, stream);
}

// K6's entry ``mode`` (kLinear, kEval, kTangent): its registers and local
// bytes a thread, and the tiles a launch of R rows (D directions) of G
// members of n_max knots and W_max queries takes: primal rows and
// directions a tile, blocks, shared memory bytes, whether the tables are
// staged, queries a tile (out: 8 ints)
extern "C" int fitted_kernel_info(int mode, int R, int D, int G, int n_max,
                                  int W_max, int* out) {
  const void* fns[3] = {(const void*)k6_kernel<kLinear>,
                        (const void*)k6_kernel<kEval>,
                        (const void*)k6_kernel<kTangent>};
  if (mode < 0 || mode > 2) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, fns[mode]);
  if (err != cudaSuccess) return (int)err;
  const K6Tile t = k6_tile(R, D, G, n_max, W_max, mode == kTangent);
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = t.tp;
  out[3] = t.td;
  out[4] = ((R + t.tp - 1) / t.tp) * t.nd_tiles * t.nw_tiles * G;
  out[5] = (int)t.smem;
  out[6] = t.stage ? 1 : 0;
  out[7] = t.tw;
  return 0;
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
