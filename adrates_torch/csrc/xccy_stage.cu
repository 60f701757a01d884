// K8-K11: the XCCY stage of the structured risk pass, its directional
// derivatives and its Hessians, in dual and hyper-dual arithmetic (f64).
//
// Replace the torch.func towers over one XCCY stage in
// adrates_torch/parallel/structured_risk.py (fwd_delta's pass 2 and
// term2_xccy), which port the XCCY pass of fwd_delta and term2_xccy in
// adrates_tpu/parallel/structured_risk.py (:320- and :457-603) over
// adrates_tpu/parallel/curve_batching.py:265-319 (xccy_legs_pv,
// xccy_boot_ds, xccy_native_ds), adrates_tpu/ops/xccy_bootstrap.py:78
// (bootstrap_xccy) and adrates_tpu/ops/pricers.py:102 (pv_float_leg).
// The JAX package wrote these in plain jnp, which XLA lowers: no Pallas
// kernel. They were added because the stage was about half the ops of a
// FLAT_FWD staged chunk of flagship_v5 (3,600 of 6,500 counted on the
// CPU), each a host dispatch on the card.
//
// The stage is written once over a scalar type T: double, Dual (value,
// one tangent) or HDual (value, e1, e2, e1 e2), its inputs lifted along
// one direction or two, so second derivatives are exact with no
// hand-derived adjoint. It splits at the node DFs ds [U1]:
//
//   - the chain (chain_eval): the foreign DFs at each chain point's start,
//     end and payment through the static simple plan (the exact-knot
//     select, right-side brackets and LINEAR_ZERO's t = 0 remap are in
//     the tables); the cashflows and the telescoped basis chain base =
//     df_pay exp(cumsum(-sp dt)), in chain order; the par conditions by
//     forward substitution, pillar k's factor x_k = -(pv_k + fxs (v0_k +
//     acc_k)) / d_k at its maturity point, acc_k the sum of its known
//     payments' cf base C_seg over the factors C solved before them (what
//     the Neumann series of ops/linear_solve.py converges to); the node
//     DFs (x base at a pillar, C_seg base elsewhere; 1 with no derivative
//     at the t = 0 node and the pad slots);
//   - the rows, which read ds alone through the member's static simple
//     plan: a row is an exact knot or v(z), z = y0 + c (y1 - y0) over the
//     transformed DFs y of the two nodes that bracket it.
//
// K8 and K10 do the work that does not depend on a pair once a block, on
// chip, and keep nothing in local memory. A block takes one (scenario,
// member) and a set of directions: K8 a tile of kTile, K10 all D (a pair
// of tiles I <= J where the tables of all D would not fit three blocks to
// an SM). It copies the member's chain tables and transforms its foreign
// grid (-log, / x_safe) into shared memory, and runs one dual chain a
// direction (a thread each), which leaves the nodes' first tangents J
// [U1, dirs] and the first tangents of the factors C and the sums acc
// (ce, ae) in shared memory. Then
//
//   K8 xccy_stage_jvp:   the block's threads run the rows, each row's
//                        primal once (from the nodes' transforms, taken
//                        once) and its tangent along each direction from
//                        its one or two taps, the stores coalesced over
//                        the rows; tile 0 writes ds and the rows.
//   K10 xccy_stage_hess: with a = ds/dds of s = sum gs . rows and M =
//                        d2s/dds2, banded (a row reads at most the two
//                        nodes that bracket it; LINEAR_FWD adds nothing),
//                        H_ij = sum_u a_u d2ds_u/didj + J_i' M J_j. Before
//                        the dual chains, the block runs the primal chain
//                        point-parallel (primal_tape), recording its exps
//                        and quotients on a tape in shared memory, which
//                        every later chain of the block replays (no exp
//                        and no division in their primal parts, the
//                        primal C and acc read from its tables). While
//                        warps 0-1 run the dual chains, warps 2-3 sum a
//                        and M's band over the rows in chunks
//                        (rows_sums, a thread a row, then a thread a
//                        node or band entry over its rows in table
//                        order). Then each thread takes items of the
//                        block's chunk of at most kItems: a pair i <= j,
//                        whose chain alone runs in HDual keeping only the
//                        e1 e2 parts of C and acc (the other parts are the
//                        tables'), written at H[i, j] = H[j, i], with gZ_i
//                        = a . J_i at i = j; recalibrated, a foreign grid
//                        entry l (the last chunk's, from a warp's boundary
//                        on), a dual chain giving gf_l = a . dds/dfd_l.
//   K9 xccy_legs_jvp:    a Dual thread a (scenario, member, dom
//                        direction): the legs' PVs' tangents and PVs, by
//                        pv_float_leg's arithmetic on the static plans
//                        (the double-where of an ia = 0 slot, the
//                        first-fixing override on flow 0, torch.clamp's
//                        derivative passing inclusively at the cap and
//                        floor, strictly future coupons, the notional
//                        exchanges).
//   K11 xccy_legs_hess:  an HDual thread a (scenario, member, pair) of
//                        sum gpv . legs over the dom directions, and a
//                        Dual thread a grid entry: the simple design, a
//                        whole evaluation a thread.
//
// What bounds K8 and K10 on an H100. At flagship_v5's XCCY stage (G = 3,
// S = 8, 78 chain points, 31 nodes, 490 rows, D = 48, 50 scenarios a
// chunk) the function needs 0.19 GFLOP of f64 in K10 (the primal once a
// (scenario, member), each first tangent once, each pair's e1 e2 part
// once; xccy_stage.needed_flops) and moves about 8 MB, so its bound is
// operations, 5.7 us; K8's bound is its 28 MB of tangent rows out. The
// kernels do more: a pair thread's hyper-dual chain recomputes its
// first-order parts (cheaper than keeping every intermediate's tangents
// on chip, 78 points x D directions), and each of a (scenario, member)'s
// five K10 blocks runs the primal chain, the 48 dual chains and the rows'
// sums again; xccy_stage.needed_flops counts the kernels' own operations
// beside the bound ("kernel"). What bounds them then is instruction
// dispatch: 750 K10 blocks of 128 threads, three to an SM (168 registers
// a thread, 74 KB of shared memory a block), 12 warps an SM whose chains
// are sequences of dependent f64 operations and shared-memory reads; K8's
// 450 blocks are one dual chain's latency and the rows' stores. scripts/xccy_phases.py stamps
// each block's phases (PERF.md has them). Blocks lay their tables out
// from the stage's own sizes (plan_layout): where the tape, the lists,
// the grid's transforms, the chain tables or the foreign tangent rows do
// not fit, they are read from device memory (through L1) or computed at
// each read, and the tiles shrink before the core would not fit.
//
// Sums run in a fixed order with no atomics, so two launches agree bit
// for bit, and each H_ij is written at [i, j] and [j, i] by the thread
// that computes it. No allocation; one launch a call on the caller's
// stream.

#include <cuda_runtime.h>

// ---- the tables (kernels._XStage) ------------------------------------------

struct XccyStageTab {
  int G, S, n, U1, Lf, Ld, W, P, Pd, fsch, dsch, flags;
  const double* pt_f;   // [G, n, 5] notional, spread_sens, alpha_ratio, dt, w
  const int* pt_i;      // [G, n, 4] swap, segment, flags, node slot or -1
  const double* v0;     // [G, S]
  const double* fxs;    // [G]
  const int* fq_i;      // [G, 3n, 3] i0, i1, exact knot or -1
  const double* fq_f;   // [G, 3n, 2] weight, query time
  const double* f_xs;   // [G, Lf]
  const int* rq_i;      // [G, W, 3]
  const double* rq_f;   // [G, W, 2]
  const int* r_sch;     // [G]
  const double* r_xs;   // [G, U1]
  const int* li_i;      // [G, S, 2P, 3]
  const double* li_f;   // [G, S, 2P, 2]
  const int* ld_i;      // [G, S, Pd, 3]
  const double* ld_f;   // [G, S, Pd, 2]
  const double* d_xs;   // [G, Ld]
  const double* leg_f;  // [G, S, P, 5] pay time, pay alpha, index alpha,
                        //   spread, notional
  const double* leg_s;  // [G, S, 9] principal, sign, value time, first
                        //   fixing, exchange amount, effective, maturity,
                        //   cap, floor
  int E, NR, NB;        // band entries, node-row and band-row slots a member
  const int* nr_ptr;    // [G, U1 + 1] the rows that read each node (CSR)
  const int* nr_row;    // [G, NR]
  const int* mb_pq;     // [G, E, 2] the band entries p < q of M
  const int* mb_ptr;    // [G, E + 1] their rows (CSR)
  const int* mb_row;    // [G, NB]
  const int* tp_off;    // [G, n + 1] each chain point's place on K10's tape
};

namespace {

using StageTab = XccyStageTab;


constexpr int kMaxS = 16;     // xccy_stage.MAX_S
constexpr int kMaxU = 64;     // xccy_stage.MAX_U
constexpr int kThreads = 128;

enum { kLinFwd = 0, kFlatFwd = 1, kLinZero = 2 };
enum { kMat = 1, kNotl = 2, kLast = 4 };
enum { kOverride = 1, kExchange = 2, kCapFloor = 4 };
enum { kNone = 0, kSpread = 1, kPv = 2, kRow = 3, kUnit = 4 };

// ---- the scalar types ------------------------------------------------------

struct Dual { double v, e; };
struct HDual { double v, a, b, ab; };

__device__ __forceinline__ Dual operator+(Dual x, Dual y) {
  return {x.v + y.v, x.e + y.e};
}
__device__ __forceinline__ Dual operator-(Dual x, Dual y) {
  return {x.v - y.v, x.e - y.e};
}
__device__ __forceinline__ Dual operator-(Dual x) { return {-x.v, -x.e}; }
__device__ __forceinline__ Dual operator*(Dual x, Dual y) {
  return {x.v * y.v, x.v * y.e + x.e * y.v};
}
__device__ __forceinline__ Dual operator/(Dual x, Dual y) {
  const double q = x.v / y.v;
  return {q, (x.e - q * y.e) / y.v};
}
__device__ __forceinline__ Dual operator+(Dual x, double c) {
  return {x.v + c, x.e};
}
__device__ __forceinline__ Dual operator+(double c, Dual x) {
  return {c + x.v, x.e};
}
__device__ __forceinline__ Dual operator-(Dual x, double c) {
  return {x.v - c, x.e};
}
__device__ __forceinline__ Dual operator*(Dual x, double c) {
  return {x.v * c, x.e * c};
}
__device__ __forceinline__ Dual operator*(double c, Dual x) {
  return {c * x.v, c * x.e};
}
__device__ __forceinline__ Dual operator/(Dual x, double c) {
  return {x.v / c, x.e / c};
}
__device__ __forceinline__ Dual texp(Dual x) {
  const double e = exp(x.v);
  return {e, e * x.e};
}
__device__ __forceinline__ Dual tlog(Dual x) {
  return {log(x.v), x.e / x.v};
}

__device__ __forceinline__ HDual operator+(HDual x, HDual y) {
  return {x.v + y.v, x.a + y.a, x.b + y.b, x.ab + y.ab};
}
__device__ __forceinline__ HDual operator-(HDual x, HDual y) {
  return {x.v - y.v, x.a - y.a, x.b - y.b, x.ab - y.ab};
}
__device__ __forceinline__ HDual operator-(HDual x) {
  return {-x.v, -x.a, -x.b, -x.ab};
}
__device__ __forceinline__ HDual operator*(HDual x, HDual y) {
  return {x.v * y.v, x.v * y.a + x.a * y.v, x.v * y.b + x.b * y.v,
          x.v * y.ab + x.a * y.b + x.b * y.a + x.ab * y.v};
}
__device__ __forceinline__ HDual operator/(HDual x, HDual y) {
  const double q = x.v / y.v;
  const double qa = (x.a - q * y.a) / y.v;
  const double qb = (x.b - q * y.b) / y.v;
  return {q, qa, qb, (x.ab - q * y.ab - qa * y.b - qb * y.a) / y.v};
}
__device__ __forceinline__ HDual operator+(HDual x, double c) {
  return {x.v + c, x.a, x.b, x.ab};
}
__device__ __forceinline__ HDual operator+(double c, HDual x) {
  return {c + x.v, x.a, x.b, x.ab};
}
__device__ __forceinline__ HDual operator-(HDual x, double c) {
  return {x.v - c, x.a, x.b, x.ab};
}
__device__ __forceinline__ HDual operator*(HDual x, double c) {
  return {x.v * c, x.a * c, x.b * c, x.ab * c};
}
__device__ __forceinline__ HDual operator*(double c, HDual x) {
  return {c * x.v, c * x.a, c * x.b, c * x.ab};
}
__device__ __forceinline__ HDual operator/(HDual x, double c) {
  return {x.v / c, x.a / c, x.b / c, x.ab / c};
}
__device__ __forceinline__ HDual texp(HDual x) {
  const double e = exp(x.v);
  return {e, e * x.a, e * x.b, e * (x.ab + x.a * x.b)};
}
__device__ __forceinline__ HDual tlog(HDual x) {
  return {log(x.v), x.a / x.v, x.b / x.v,
          x.ab / x.v - x.a * x.b / (x.v * x.v)};
}

template <class T> __device__ __forceinline__ T lift(double v, double t1,
                                                     double t2);
template <> __device__ __forceinline__ Dual lift<Dual>(double v, double t1,
                                                       double) {
  return {v, t1};
}
template <> __device__ __forceinline__ HDual lift<HDual>(double v, double t1,
                                                         double t2) {
  return {v, t1, t2, 0.0};
}
__device__ __forceinline__ double prim(Dual x) { return x.v; }
__device__ __forceinline__ double prim(HDual x) { return x.v; }

// A direction of the inputs: a basis spread, a leg PV, a tangent row over
// the grid, or a unit grid entry.
struct Dir {
  int kind, idx;
  const double* row;
};

__device__ __forceinline__ double tan_sp(const Dir& d, int s) {
  return d.kind == kSpread && d.idx == s ? 1.0 : 0.0;
}
__device__ __forceinline__ double tan_pv(const Dir& d, int s) {
  return d.kind == kPv && d.idx == s ? 1.0 : 0.0;
}
__device__ __forceinline__ double tan_grid(const Dir& d, int l) {
  if (d.kind == kRow) return d.row[l];
  return d.kind == kUnit && d.idx == l ? 1.0 : 0.0;
}

template <class T>
__device__ __forceinline__ T grid_at(const double* grid, int l, const Dir& d1,
                                     const Dir& d2) {
  return lift<T>(grid[l], tan_grid(d1, l), tan_grid(d2, l));
}

template <class T>
__device__ T grid_y(int sch, const double* grid, const double* xs, int l,
                    const Dir& d1, const Dir& d2) {
  const T d = grid_at<T>(grid, l, d1, d2);
  if (sch == kLinFwd) return d;
  const T r = -tlog(d);
  return sch == kFlatFwd ? r : r / xs[l];
}

// interpolation.simple_df_static at one packed query of a grid whose
// values are lifted as they are read.
template <class T>
__device__ T interp(int sch, const int* qi, const double* qf,
                    const double* xs, const double* grid, const Dir& d1,
                    const Dir& d2) {
  if (qi[2] >= 0) return grid_at<T>(grid, qi[2], d1, d2);
  const T y0 = grid_y<T>(sch, grid, xs, qi[0], d1, d2);
  const T v = y0 + qf[0] * (grid_y<T>(sch, grid, xs, qi[1], d1, d2) - y0);
  if (sch == kFlatFwd) return texp(-v);
  if (sch == kLinZero) return texp(-v * qf[1]);
  return v;
}

// ---- K8 / K10: the stage split at its node DFs ------------------------------

constexpr int kTile = 16;     // xccy_stage.TILE: K8's directions a block
constexpr int kBlock = 128;   // xccy_stage.BLOCK: the threads of a block
constexpr int kK8Blocks = 4;  // K8's blocks an SM its registers allow
constexpr int kK10Blocks = 3; // K10's blocks an SM (its launch bounds)


// The primal exps and quotients of one chain, in the order the chain takes
// them. The chain's control flow is the tables' (the same for every
// direction), so one thread of a block records them and the others replay
// them: a replaying thread computes no exp and no division, only the
// derivative parts, which multiply by the recorded reciprocal. p null:
// every thread computes its own.
struct QR { double q, r; };

template <> __device__ __forceinline__ double lift<double>(double v, double,
                                                           double) {
  return v;
}

struct Tape {
  double* p;
  int i;
  bool rec;
  __device__ __forceinline__ double exp_of(double x) {
    if (p && !rec) return p[i++];
    const double e = exp(x);
    if (p) p[i++] = e;
    return e;
  }
  __device__ __forceinline__ QR div_of(double x, double y) {
    if (p && !rec) {
      const QR d{p[i], p[i + 1]};
      i += 2;
      return d;
    }
    const QR d{x / y, 1.0 / y};
    if (p) {
      p[i] = d.q;
      p[i + 1] = d.r;
      i += 2;
    }
    return d;
  }
};

__device__ __forceinline__ double texp(double x, Tape& tp) {
  return tp.exp_of(x);
}
__device__ __forceinline__ Dual texp(const Dual& x, Tape& tp) {
  const double e = tp.exp_of(x.v);
  return {e, e * x.e};
}
__device__ __forceinline__ HDual texp(const HDual& x, Tape& tp) {
  const double e = tp.exp_of(x.v);
  return {e, e * x.a, e * x.b, e * (x.ab + x.a * x.b)};
}

__device__ __forceinline__ double tdiv(double x, double y, Tape& tp) {
  return tp.div_of(x, y).q;
}
__device__ __forceinline__ Dual tdiv(const Dual& x, const Dual& y,
                                     Tape& tp) {
  const QR d = tp.div_of(x.v, y.v);
  return {d.q, (x.e - d.q * y.e) * d.r};
}
__device__ __forceinline__ HDual tdiv(const HDual& x, const HDual& y,
                                      Tape& tp) {
  const QR d = tp.div_of(x.v, y.v);
  const double qa = (x.a - d.q * y.a) * d.r, qb = (x.b - d.q * y.b) * d.r;
  return {d.q, qa, qb, (x.ab - d.q * y.ab - qa * y.b - qb * y.a) * d.r};
}

// A DF d under a simple scheme's interpolated transform y (LINEAR_FWD
// y = d, FLAT_FWD -log d, LINEAR_ZERO -log(d) / x_safe), with y' and y''
// (xccy_stage.transform).
struct GPt { double d, y, y1, y2; };

__device__ __forceinline__ GPt transform(int sch, double d, double xs) {
  if (sch == kLinFwd) return {d, d, 1.0, 0.0};
  const double inv = 1.0 / d, y = -log(d);
  if (sch == kFlatFwd) return {d, y, -inv, inv * inv};
  return {d, y / xs, -inv / xs, inv * inv / xs};
}

// A transformed grid value lifted along the grid tangents t1 / t2 by the
// chain rule: (y, t1 y', t2 y', t1 t2 y'').
template <class T>
__device__ __forceinline__ T lift_y(const GPt& p, double t1, double t2);
template <> __device__ __forceinline__ double lift_y<double>(const GPt& p,
                                                             double,
                                                             double) {
  return p.y;
}
template <> __device__ __forceinline__ Dual lift_y<Dual>(const GPt& p,
                                                         double t1, double) {
  return {p.y, t1 * p.y1};
}
template <> __device__ __forceinline__ HDual lift_y<HDual>(const GPt& p,
                                                           double t1,
                                                           double t2) {
  return {p.y, t1 * p.y1, t2 * p.y1, (t1 * t2) * p.y2};
}

// One (scenario, member) as a block reads it: its inputs in device
// memory; its chain tables and its foreign grid's transforms in shared
// memory where the layout holds them, else the tables in device memory
// and the transforms computed at each read.
struct Member {
  int n, Lf, fsch;
  double fxs;
  const double *sp, *pv, *v0;   // [S]
  const double *fd, *fxg;       // [Lf]
  const double* pf;             // [n, 5]
  const int* pi;                // [n, 4]
  const int* fqi;               // [3n, 3]
  const double* fqf;            // [3n, 2]
  const double* gt;             // [4, Lf] d, y, y', y'', or null
};

__device__ __forceinline__ GPt grid_pt(const Member& m, int l) {
  if (m.gt) {
    return {m.gt[l], m.gt[m.Lf + l], m.gt[2 * m.Lf + l], m.gt[3 * m.Lf + l]};
  }
  return transform(m.fsch, m.fd[l], m.fxg[l]);
}

// interpolation.simple_df_static at one packed query of the foreign grid,
// its values lifted as they are read.
template <class T>
__device__ __forceinline__ T query(const Member& m, int q, const Dir& d1,
                                   const Dir& d2, Tape& tp) {
  const int* qi = m.fqi + 3 * q;
  const double* qf = m.fqf + 2 * q;
  const int kn = qi[2];
  if (kn >= 0) {
    return lift<T>(m.gt ? m.gt[kn] : m.fd[kn], tan_grid(d1, kn),
                   tan_grid(d2, kn));
  }
  const int l0 = qi[0], l1 = qi[1];
  const T y0 = lift_y<T>(grid_pt(m, l0), tan_grid(d1, l0), tan_grid(d2, l0));
  const T v = y0 + qf[0] * (lift_y<T>(grid_pt(m, l1), tan_grid(d1, l1),
                                      tan_grid(d2, l1)) - y0);
  if (m.fsch == kFlatFwd) return texp(-v, tp);
  if (m.fsch == kLinZero) return texp(-v * qf[1], tp);
  return v;
}

// One chain point i of a member (xccy_stage.thread_chain): the foreign
// DFs at its payment, start and end (a coupon's) through the static simple
// plan, the basis chain's base = df_pay exp(cum) and the cashflow cf (its
// exps and the coupon's quotient on the tape tp).
template <class T>
__device__ __forceinline__ void point_eval(const Member& m, int i, int fl,
                                           const double* pf, const T& spk,
                                           const T& cum, const Dir& d1,
                                           const Dir& d2, Tape& tp, T& base,
                                           T& cf) {
  const int n = m.n;
  const double notl = pf[0], ss = pf[1], ar = pf[2];
  const T pay = query<T>(m, 2 * n + i, d1, d2, tp);
  base = pay * texp(cum, tp);
  if (fl & kNotl) {
    cf = lift<T>((fl & kLast) ? notl : -notl, 0.0, 0.0) + spk * ss;
  } else {
    const T q0 = query<T>(m, i, d1, d2, tp);
    const T r = tdiv(q0, query<T>(m, n + i, d1, d2, tp), tp);
    cf = (((r - 1.0) * notl) * ar + ((fl & kLast) ? notl : 0.0)) + spk * ss;
  }
}

// Chain point i's part of the bootstrap, in chain order: pillar k's factor
// x_k = -(pv_k + fxs (v0_k + acc_k)) / d_k at its maturity point (its
// quotient on the tape), else its known payment's cf base C_seg w added to
// acc_k; its node's DF (x base at a pillar, C_seg base elsewhere).
template <class T, class Store>
__device__ __forceinline__ void point_solve(const Member& m, const int* pi,
                                            double w, const T& base,
                                            const T& cf, int& rank,
                                            const Dir& d1, const Dir& d2,
                                            Store& st, Tape& tp) {
  const int k = pi[0], s = pi[1], fl = pi[2], node = pi[3];
  T val;
  if (fl & kMat) {
    const T d = (m.fxs * cf) * base;
    const T pvk = lift<T>(m.pv[rank], tan_pv(d1, rank), tan_pv(d2, rank));
    const T x = tdiv(-(pvk + m.fxs * (m.v0[rank] + st.acc(rank))), d, tp);
    st.set_c(rank, x);
    val = x * base;
    ++rank;
  } else {
    const T c = st.c(s);
    if (w != 0.0) st.add_acc(k, ((cf * base) * w) * c);
    val = c * base;
  }
  if (node >= 0) st.node(node, val);
}

__device__ __forceinline__ bool point_skips(int fl, double w, int node) {
  return !(fl & kMat) && w == 0.0 && node < 0;
}

// The chain of one member at sp [S], pv [S], fd [Lf] lifted along d1 / d2,
// to its node DFs (xccy_stage.thread_chain): the telescoped basis chain's
// cumulative sums cum = cumsum(-sp dt), then each needed point's
// point_eval and point_solve. The store st keeps the factors C[1..S] and
// the sums acc, and takes each node: st.c(s) (s = 0: 1, no derivative),
// st.set_c(r, x) (C[r + 1]), st.acc(k), st.add_acc(k, term), st.node(u, v).
// tp records or replays its exps and quotients.
template <class T, class Store>
__device__ void chain_eval(const Member& m, const Dir& d1, const Dir& d2,
                           Store& st, Tape tp) {
  const int n = m.n;
  T cum = lift<T>(0.0, 0.0, 0.0);
  int rank = 0;
  for (int i = 0; i < n; ++i) {
    const int* pi = m.pi + 4 * i;
    const double* pf = m.pf + 5 * i;
    const int k = pi[0], fl = pi[2];
    const T spk = lift<T>(m.sp[k], tan_sp(d1, k), tan_sp(d2, k));
    cum = cum + (-spk) * pf[3];
    if (point_skips(fl, pf[4], pi[3])) continue;
    T base, cf;
    point_eval(m, i, fl, pf, spk, cum, d1, d2, tp, base, cf);
    point_solve(m, pi, pf[4], base, cf, rank, d1, d2, st, tp);
  }
}

// ---- the chain's stores ------------------------------------------------------
//
// A thread's own values live in its column of the block's scratch
// (slot j at sv[j * stride], C[1..S] in slots 0..S-1, acc in S..2S-1):
// shared memory, never local memory. A direction's first tangents of C
// and acc, once its dual chain has run, are the block's tables ce / ae
// (a row a direction), and the primal values cv / av; a pair or grid
// thread reads them there and keeps only its own part.

struct DirStore {        // Dual, direction k of the block (the prologue)
  double* sv;            // null: the primal parts are the tables' (cv, av)
  int stride, S;
  double *ce, *ae;       // this direction's rows of the tangent tables
  double* J;             // [U1, nd]: J[u * nd + k]
  int nd, k;
  double *cv, *av, *dsv; // the primal tables, written by the primary thread
  bool primary;
  __device__ void init() {
    for (int j = 0; j < S; ++j) {
      if (sv) sv[(S + j) * stride] = 0.0;
      ae[j] = 0.0;
      if (primary) av[j] = 0.0;
    }
  }
  __device__ Dual c(int s) const {
    if (s == 0) return {1.0, 0.0};
    return {sv ? sv[(s - 1) * stride] : cv[s - 1], ce[s - 1]};
  }
  __device__ void set_c(int r, const Dual& x) {
    if (sv) sv[r * stride] = x.v;
    ce[r] = x.e;
    if (primary) cv[r] = x.v;
  }
  __device__ Dual acc(int j) const {
    return {sv ? sv[(S + j) * stride] : av[j], ae[j]};
  }
  __device__ void add_acc(int j, const Dual& x) {
    const Dual a = acc(j) + x;
    if (sv) sv[(S + j) * stride] = a.v;
    ae[j] = a.e;
    if (primary) av[j] = a.v;
  }
  __device__ void node(int u, const Dual& x) {
    J[u * nd + k] = x.e;
    if (primary) dsv[u] = x.v;
  }
};

struct PairStore {       // HDual, the pair (i, j): its e1 e2 parts alone
  double* sv;
  int stride, S;
  const double *cv, *av, *ci, *cj, *ai, *aj, *au;
  double h;              // sum_u a_u ds_u.ab, in chain order
  __device__ void init() {
    for (int j = 0; j < S; ++j) sv[(S + j) * stride] = 0.0;
    h = 0.0;
  }
  __device__ HDual c(int s) const {
    if (s == 0) return {1.0, 0.0, 0.0, 0.0};
    return {cv[s - 1], ci[s - 1], cj[s - 1], sv[(s - 1) * stride]};
  }
  __device__ void set_c(int r, const HDual& x) { sv[r * stride] = x.ab; }
  __device__ HDual acc(int j) const {
    return {av[j], ai[j], aj[j], sv[(S + j) * stride]};
  }
  __device__ void add_acc(int j, const HDual& x) {
    sv[(S + j) * stride] = sv[(S + j) * stride] + x.ab;
  }
  __device__ void node(int u, const HDual& x) { h = h + au[u] * x.ab; }
};

struct GridStore {       // Dual, a unit foreign grid entry: its tangents
  double* sv;
  int stride, S;
  const double *cv, *av, *au;
  double gsum;           // sum_u a_u ds_u.e, in chain order
  __device__ void init() {
    for (int j = 0; j < S; ++j) sv[(S + j) * stride] = 0.0;
    gsum = 0.0;
  }
  __device__ Dual c(int s) const {
    return s == 0 ? Dual{1.0, 0.0} : Dual{cv[s - 1], sv[(s - 1) * stride]};
  }
  __device__ void set_c(int r, const Dual& x) { sv[r * stride] = x.e; }
  __device__ Dual acc(int j) const { return {av[j], sv[(S + j) * stride]}; }
  __device__ void add_acc(int j, const Dual& x) {
    sv[(S + j) * stride] = sv[(S + j) * stride] + x.e;
  }
  __device__ void node(int u, const Dual& x) { gsum = gsum + au[u] * x.e; }
};

struct PrimStore {       // double, one thread: the primal tables
  double *cv, *av, *dsv;
  int S;
  __device__ void init() {
    for (int j = 0; j < S; ++j) av[j] = 0.0;
  }
  __device__ double c(int s) const { return s == 0 ? 1.0 : cv[s - 1]; }
  __device__ void set_c(int r, double x) { cv[r] = x; }
  __device__ double acc(int j) const { return av[j]; }
  __device__ void add_acc(int j, double x) { av[j] = av[j] + x; }
  __device__ void node(int u, double x) { dsv[u] = x; }
};

// ---- the rows ----------------------------------------------------------------

// Row w at the primal node DFs through its member's scheme rs
// (xccy_stage.row_terms), from the nodes' transforms nt [3, U1] (y, y',
// y'' of each node, xccy_stage.transform): the row as a function of z =
// y0 + c (y1 - y0), v and its derivatives v', v'' in z, and its taps'
// dz/dds (t0, t1) and d2z/dds2 (s0, s1); one tap (t1 = s1 = 0) where
// i0 = i1.
struct RowVal { double v, v1, v2, t0, t1, s0, s1; };

__device__ __forceinline__ RowVal row_val(int rs, const int* q,
                                          const double* f, const double* nt,
                                          int U1) {
  const int u0 = q[0], u1 = q[1];
  const double c = f[0];
  const double y0 = nt[u0];
  const double z = y0 + c * (nt[u1] - y0);
  double v, v1, v2;
  if (rs == kLinFwd) {
    v = z;
    v1 = 1.0;
    v2 = 0.0;
  } else if (rs == kFlatFwd) {
    v = exp(-z);
    v1 = -v;
    v2 = v;
  } else {
    const double qt = f[1];
    v = exp(-z * qt);
    v1 = -qt * v;
    v2 = qt * (qt * v);
  }
  const double* n1 = nt + U1;
  const double* n2 = nt + 2 * U1;
  if (u0 == u1) return {v, v1, v2, n1[u0], 0.0, n2[u0], 0.0};
  return {v, v1, v2, (1.0 - c) * n1[u0], c * n1[u1], (1.0 - c) * n2[u0],
          c * n2[u1]};
}

// The transforms nt [3, U1] of member g's primal node DFs ds, a thread a
// node (the caller synchronises before reading them).
__device__ __forceinline__ void node_transforms(const StageTab& t, int g,
                                                const double* ds,
                                                double* nt, int tid,
                                                int nthreads) {
  const int rs = t.r_sch[g], U1 = t.U1;
  const double* xs = t.r_xs + (size_t)g * U1;
  for (int u = tid; u < U1; u += nthreads) {
    const GPt p = transform(rs, ds[u], xs[u]);
    nt[u] = p.y;
    nt[U1 + u] = p.y1;
    nt[2 * U1 + u] = p.y2;
  }
}

// J_i' M J_j over the band: the diagonal md, then each entry p < q twice.
__device__ __forceinline__ double band_quad(int U1, int E, const int* pq,
                                            const double* md,
                                            const double* mo,
                                            const double* J, int nd, int ki,
                                            int kj) {
  double hm = 0.0;
  for (int u = 0; u < U1; ++u) hm = hm + md[u] * (J[u * nd + ki] * J[u * nd + kj]);
  for (int e = 0; e < E; ++e) {
    const int p = pq[2 * e], q = pq[2 * e + 1];
    hm = hm + mo[e] * (J[p * nd + ki] * J[q * nd + kj]
                       + J[q * nd + ki] * J[p * nd + kj]);
  }
  return hm;
}

// ---- the timeline of a profiling build ---------------------------------------

#ifdef XCCY_TIMELINE
// scripts/xccy_phases.py builds this file with -DXCCY_TIMELINE: each K8 /
// K10 block stamps its phases on the global timer (ns), with its SM, for
// the first kStampBlocks blocks of a launch (xccy_timeline reads them).
constexpr int kStampBlocks = 1 << 15;
__device__ unsigned long long g_stamps[kStampBlocks][6];
__device__ __forceinline__ void stamp(int k) {
  if (threadIdx.x != 0 || blockIdx.x >= kStampBlocks) return;
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  g_stamps[blockIdx.x][k] = t;
  if (k == 0) {
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    g_stamps[blockIdx.x][5] = sm;
  }
}
#define XCCY_STAMP(k) stamp(k)
#define XCCY_STAMP_END() \
  do {                   \
    __syncthreads();     \
    stamp(4);            \
  } while (0)
#else
#define XCCY_STAMP(k)
#define XCCY_STAMP_END()
#endif

// ---- a block's tables in shared memory ---------------------------------------

// Where a block keeps its tables in dynamic shared memory, as offsets in
// doubles (the int chain tables after the doubles, at `ints`); -1: not
// there (the chain tables and the tangent rows are then read from device
// memory, the grid's transforms computed at each read). Planned on the
// host by plan_layout from the stage's own sizes.
struct Layout {
  int Dt, nT, nd, stride;  // tile, tiles, most directions a block, scratch
  int J, dsv, nt, cv, av, ce, ae, au, md, mo, rt, ri, sc, pp;
  int cs;                  // the row stride of ce / ae (odd: no bank
                           // conflicts between directions)
  int tape, lists, gt, tt, ttld, ptf, fqf, ints;
  int bytes;
};

// A group of a block's warps: threads [t0, t0 + n) and the barrier that
// synchronises them (0: the block's own, n = kBlock).
struct Group {
  int t0, n, bar;
  __device__ __forceinline__ int tid() const { return (int)threadIdx.x - t0; }
  __device__ __forceinline__ void sync() const {
    if (bar == 0) {
      __syncthreads();
    } else {
      asm volatile("bar.sync %0, %1;" ::"r"(bar), "r"(n) : "memory");
    }
  }
};

// Copy member g's node and band lists into shared memory, where the
// layout holds them (the group synchronises before reading them).
__device__ void copy_lists(const StageTab& t, const Layout& L, double* sm,
                           int g, const Group& G) {
  if (L.lists < 0) return;
  int* l = reinterpret_cast<int*>(sm + L.lists);
  const int nn = t.U1 + 1, ne = t.E + 1, tid = G.tid();
  for (int x = tid; x < nn; x += G.n) l[x] = t.nr_ptr[(size_t)g * nn + x];
  for (int x = tid; x < t.NR; x += G.n) {
    l[nn + x] = t.nr_row[(size_t)g * t.NR + x];
  }
  for (int x = tid; x < ne; x += G.n) {
    l[nn + t.NR + x] = t.mb_ptr[(size_t)g * ne + x];
  }
  for (int x = tid; x < t.NB; x += G.n) {
    l[nn + t.NR + ne + x] = t.mb_row[(size_t)g * t.NB + x];
  }
}

// Member g's node and band lists (its rows in table order): the block's
// copy where the layout holds one.
__device__ __forceinline__ void lists(const StageTab& t, const Layout& L,
                                      const double* sm, int g,
                                      const int** nptr, const int** nrow,
                                      const int** bptr, const int** brow) {
  if (L.lists >= 0) {
    const int* l = reinterpret_cast<const int*>(sm + L.lists);
    *nptr = l;
    *nrow = l + t.U1 + 1;
    *bptr = *nrow + t.NR;
    *brow = *bptr + t.E + 1;
    return;
  }
  *nptr = t.nr_ptr + (size_t)g * (t.U1 + 1);
  *nrow = t.nr_row + (size_t)g * t.NR;
  *bptr = t.mb_ptr + (size_t)g * (t.E + 1);
  *brow = t.mb_row + (size_t)g * t.NB;
}

// a = ds/dds of s = sum gs . rows and M = d2s/dds2's diagonal md and
// band entries mo (xccy_stage.rows_prologue), over the member's rows
// in chunks of G.n by the group G: a thread a row puts the row's terms in
// shared memory (rt, its first node in ru), then a thread a node and a
// thread a band entry add the chunk's rows of its list, in table order,
// carrying its place in the list (pos) from chunk to chunk. Its tables
// (rt, ru, pos, the lists) may lie over the threads' scratch, which no
// thread uses while the dual chains replay a tape, nor between the
// chains and the pairs.
__device__ void rows_sums(const StageTab& t, const Layout& L, double* sm,
                          int g, const double* ds, const double* gs,
                          const Group& G) {
  const int tid = G.tid(), nth = G.n, U1 = t.U1, W = t.W, E = t.E;
  const int rs = t.r_sch[g];
  const int* rqi = t.rq_i + (size_t)g * W * 3;
  const double* rqf = t.rq_f + (size_t)g * W * 2;
  const int *nptr, *nrow, *bptr, *brow;
  lists(t, L, sm, g, &nptr, &nrow, &bptr, &brow);
  double *au = sm + L.au, *md = sm + L.md, *mo = sm + L.mo, *rt = sm + L.rt;
  const double* nt = sm + L.nt;
  copy_lists(t, L, sm, g, G);
  node_transforms(t, g, ds, sm + L.nt, tid, nth);
  G.sync();
  int* ru = reinterpret_cast<int*>(sm + L.ri);
  int* pos = ru + kBlock;
  for (int x = tid; x < U1 + E; x += nth) {
    if (x < U1) {
      pos[x] = nptr[x];
      au[x] = 0.0;
      md[x] = 0.0;
    } else {
      pos[x] = bptr[x - U1];
      mo[x - U1] = 0.0;
    }
  }
  G.sync();
  for (int c0 = 0; c0 < W; c0 += nth) {
    const int w = c0 + tid;
    if (w < W) {
      const int* q = rqi + 3 * w;
      const double gw = gs[w];
      double a0 = gw, a1 = 0.0, m0 = 0.0, m1 = 0.0, mb = 0.0;
      int u0 = q[2];
      if (u0 < 0) {
        const RowVal r = row_val(rs, q, rqf + 2 * w, nt, U1);
        u0 = q[0];
        a0 = gw * (r.v1 * r.t0);
        a1 = gw * (r.v1 * r.t1);
        m0 = gw * (r.v2 * (r.t0 * r.t0) + r.v1 * r.s0);
        m1 = gw * (r.v2 * (r.t1 * r.t1) + r.v1 * r.s1);
        mb = gw * (r.v2 * (r.t0 * r.t1));
      }
      ru[tid] = u0;
      rt[tid] = a0;
      rt[kBlock + tid] = a1;
      rt[2 * kBlock + tid] = m0;
      rt[3 * kBlock + tid] = m1;
      rt[4 * kBlock + tid] = mb;
    }
    G.sync();
    const int c1 = c0 + nth;
    for (int x = tid; x < U1 + E; x += nth) {
      const bool node = x < U1;
      const int* lst = node ? nrow : brow;
      const int end = node ? nptr[x + 1] : bptr[x - U1 + 1];
      int p = pos[x];
      for (; p < end && lst[p] < c1; ++p) {
        const int k = lst[p] - c0;
        if (node) {
          const bool first = ru[k] == x;
          au[x] = au[x] + rt[(first ? 0 : 1) * kBlock + k];
          md[x] = md[x] + rt[(first ? 2 : 3) * kBlock + k];
        } else {
          mo[x - U1] = mo[x - U1] + rt[4 * kBlock + k];
        }
      }
      pos[x] = p;
    }
    G.sync();
  }
}

// The member view of (scenario, member) sg; copies its chain tables and
// transforms its grid into shared memory where the layout holds them
// (the caller synchronises before reading them).
__device__ Member load_member(const StageTab& t, const Layout& L, double* sm,
                              int g, size_t sg, const double* sp,
                              const double* pv, const double* fd) {
  const int n = t.n, Lf = t.Lf, tid = threadIdx.x;
  Member m;
  m.n = n;
  m.Lf = Lf;
  m.fsch = t.fsch;
  m.fxs = t.fxs[g];
  m.sp = sp + sg * t.S;
  m.pv = pv + sg * t.S;
  m.v0 = t.v0 + (size_t)g * t.S;
  m.fd = fd + sg * Lf;
  m.fxg = t.f_xs + (size_t)g * Lf;
  const double* pf = t.pt_f + (size_t)g * n * 5;
  const int* pi = t.pt_i + (size_t)g * n * 4;
  const int* fqi = t.fq_i + (size_t)g * 3 * n * 3;
  const double* fqf = t.fq_f + (size_t)g * 3 * n * 2;
  if (L.ptf >= 0) {
    double* spf = sm + L.ptf;
    double* sqf = sm + L.fqf;
    int* spi = reinterpret_cast<int*>(sm + L.ints);
    int* sqi = spi + 4 * n;
    for (int x = tid; x < 5 * n; x += kBlock) spf[x] = pf[x];
    for (int x = tid; x < 6 * n; x += kBlock) sqf[x] = fqf[x];
    for (int x = tid; x < 4 * n; x += kBlock) spi[x] = pi[x];
    for (int x = tid; x < 9 * n; x += kBlock) sqi[x] = fqi[x];
    m.pf = spf;
    m.pi = spi;
    m.fqi = sqi;
    m.fqf = sqf;
  } else {
    m.pf = pf;
    m.pi = pi;
    m.fqi = fqi;
    m.fqf = fqf;
  }
  m.gt = nullptr;
  if (L.gt >= 0) {
    double* gt = sm + L.gt;
    for (int l = tid; l < Lf; l += kBlock) {
      const GPt p = transform(t.fsch, m.fd[l], m.fxg[l]);
      gt[l] = p.d;
      gt[Lf + l] = p.y;
      gt[2 * Lf + l] = p.y1;
      gt[3 * Lf + l] = p.y2;
    }
    m.gt = gt;
  }
  return m;
}

// The block's tape of the primal chain and its primal tables (cv, av,
// dsv), point-parallel: one thread runs the basis chain's cumulative
// sums; a thread a chain point then takes its point_eval, writing its exps
// and coupon quotient at the point's place on the tape (tp_off); one
// thread then runs the points' point_solve in chain order (the factors'
// quotients on the tape). The cumulative sums, bases and cashflows lie in
// pp [3, n], over the threads' scratch where they fit.
__device__ void primal_tape(const StageTab& t, const Layout& L, double* sm,
                            const Member& m, int g) {
  const int n = m.n, tid = threadIdx.x;
  double* cumv = sm + L.pp;
  double* basev = cumv + n;
  double* cfv = basev + n;
  double* tape = sm + L.tape;
  const int* off = t.tp_off + (size_t)g * (n + 1);
  if (tid == 0) {
    double cum = 0.0;
    for (int i = 0; i < n; ++i) {
      cum = cum + (-m.sp[m.pi[4 * i]]) * m.pf[5 * i + 3];
      cumv[i] = cum;
    }
  }
  __syncthreads();
  const Dir none{kNone, 0, nullptr};
  for (int i = tid; i < n; i += kBlock) {
    const int* pi = m.pi + 4 * i;
    const double* pf = m.pf + 5 * i;
    if (point_skips(pi[2], pf[4], pi[3])) continue;
    Tape tp{tape, off[i], true};
    point_eval<double>(m, i, pi[2], pf, m.sp[pi[0]], cumv[i], none, none,
                       tp, basev[i], cfv[i]);
  }
  __syncthreads();
  if (tid == 0) {
    PrimStore st{sm + L.cv, sm + L.av, sm + L.dsv, t.S};
    st.init();
    int rank = 0;
    for (int i = 0; i < n; ++i) {
      const int* pi = m.pi + 4 * i;
      const double w = m.pf[5 * i + 4];
      if (point_skips(pi[2], w, pi[3])) continue;
      Tape tp{tape, off[i + 1] - 2, true};
      point_solve<double>(m, pi, w, basev[i], cfv[i], rank, none, none, st,
                          tp);
    }
  }
  __syncthreads();
}

// The directions of a block: local k < nI is global I Dt + k, the others
// Jt Dt + k - nI (K8: none). The row directions (d >= S + npv) of each
// range are its last ones; the block keeps their tangent rows in shared
// memory in that order (slot), where the layout holds them.
struct Dirs {
  int I, Jt, nI, nd, Dt, offI, rI, offJ;
  __device__ __forceinline__ int d(int k) const {
    return k < nI ? I * Dt + k : Jt * Dt + (k - nI);
  }
  __device__ __forceinline__ int slot(int k) const {
    return k < nI ? k - offI : rI + (k - nI - offJ);
  }
};

__device__ __forceinline__ Dirs block_dirs(int I, int Jt, int nI, int nJ,
                                           int Dt, int R0) {
  const int offI = max(0, min(nI, R0 - I * Dt));
  const int offJ = max(0, min(nJ, R0 - Jt * Dt));
  return {I, Jt, nI, nI + nJ, Dt, offI, nI - offI, offJ};
}

// Local direction k of the block as a direction of the stage: a basis
// spread, a leg PV, or the foreign tangent row (the block's copy where the
// layout holds it, else row).
__device__ __forceinline__ Dir block_dir(const Dirs& B, int k, int S,
                                         int npv, const Layout& L,
                                         const double* sm,
                                         const double* row) {
  const int d = B.d(k);
  if (d < S) return {kSpread, d, nullptr};
  if (d < S + npv) return {kPv, d - S, nullptr};
  return {kRow, 0, L.tt >= 0 ? sm + L.tt + B.slot(k) * L.ttld : row};
}

// Zero J [U1, nd], set the node DFs to 1 (the t = 0 node and the pad slots
// keep it, with no derivative), and copy the block's tangent rows.
__device__ void init_block(const StageTab& t, const Layout& L, double* sm,
                           const Dirs& B, int S, int npv, int sc, int D,
                           int g, const double* tf) {
  const int tid = threadIdx.x;
  for (int x = tid; x < t.U1 * B.nd; x += kBlock) sm[L.J + x] = 0.0;
  for (int u = tid; u < t.U1; u += kBlock) sm[L.dsv + u] = 1.0;
  if (L.tt < 0 || !tf) return;
  for (int x = tid; x < B.nd * t.Lf; x += kBlock) {
    const int k = x / t.Lf, l = x - k * t.Lf;
    const int d = B.d(k);
    if (d >= S + npv) {
      sm[L.tt + B.slot(k) * L.ttld + l] =
          tf[(((size_t)sc * D + d) * t.G + g) * t.Lf + l];
    }
  }
}

// The prologue's dual chain of local direction k of the block (its
// foreign tangent row in device memory: row): where the block has a tape
// (primal_tape) it replays it and reads the primal C and acc from the
// primal tables, keeping no scratch; else it computes its exps and
// quotients in its column of the scratch, the primary direction (k = 0)
// writing the primal tables.
__device__ void direction_chain(const StageTab& t, const Layout& L,
                                double* sm, const Member& m, const Dirs& B,
                                int k, int npv, const double* row) {
  const int S = t.S;
  const bool taped = L.tape >= 0;
  DirStore st{taped ? nullptr : sm + L.sc + threadIdx.x, L.stride, S,
              sm + L.ce + k * L.cs, sm + L.ae + k * L.cs, sm + L.J, B.nd, k,
              sm + L.cv, sm + L.av, sm + L.dsv, k == 0 && !taped};
  st.init();
  const Dir none{kNone, 0, nullptr};
  chain_eval<Dual>(m, block_dir(B, k, S, npv, L, sm, row), none, st,
                   Tape{taped ? sm + L.tape : nullptr, 0, false});
}

// ---- the calibration legs --------------------------------------------------

// Member g's S leg PVs at dd [Ld] lifted along d1 / d2: sink.leg(s, pv).
template <class T, class Sink>
__device__ void legs_eval(const StageTab& t, int g, const double* dd,
                          const Dir& d1, const Dir& d2, Sink& sink) {
  const int S = t.S, P = t.P, Pd = t.Pd;
  const double* xs = t.d_xs + (size_t)g * t.Ld;
  for (int s = 0; s < S; ++s) {
    const size_t gl = (size_t)g * S + s;
    const int* ii = t.li_i + gl * 2 * P * 3;
    const double* fi = t.li_f + gl * 2 * P * 2;
    const int* id = t.ld_i + gl * Pd * 3;
    const double* fdd = t.ld_f + gl * Pd * 2;
    const double* lf = t.leg_f + gl * P * 5;
    const double* ls = t.leg_s + gl * 9;
    const double principal = ls[0], sign = ls[1], vt = ls[2], ffr = ls[3],
                 nx = ls[4], eff = ls[5], matt = ls[6], cap = ls[7],
                 flo = ls[8];
    const T dval = interp<T>(t.dsch, id + 3 * P, fdd + 2 * P, xs, dd, d1, d2);
    T total = lift<T>(0.0, 0.0, 0.0);
    for (int p = 0; p < P; ++p) {
      const double payt = lf[5 * p], pa = lf[5 * p + 1], ia = lf[5 * p + 2],
                   spr = lf[5 * p + 3], notl = lf[5 * p + 4];
      if (!(payt > vt)) continue;
      T fwd;
      if ((t.flags & kOverride) && p == 0) {
        fwd = lift<T>(ffr, 0.0, 0.0);
      } else if (ia > 0) {
        fwd = (interp<T>(t.dsch, ii + 3 * p, fi + 2 * p, xs, dd, d1, d2)
               / interp<T>(t.dsch, ii + 3 * (P + p), fi + 2 * (P + p), xs,
                           dd, d1, d2) - 1.0) / ia;
      } else {
        fwd = lift<T>(0.0, 0.0, 0.0);
      }
      T rate = fwd + spr;
      if (t.flags & kCapFloor) {
        if (prim(rate) < flo) rate = lift<T>(flo, 0.0, 0.0);
        else if (prim(rate) > cap) rate = lift<T>(cap, 0.0, 0.0);
      }
      const T cf = (rate * pa) * notl + (p == P - 1 ? principal : 0.0);
      total = total + (sign * cf) * (interp<T>(t.dsch, id + 3 * p,
                                               fdd + 2 * p, xs, dd, d1, d2)
                                     / dval);
    }
    if (t.flags & kExchange) {
      for (int e = 0; e < 2; ++e) {
        const double ext = e ? matt : eff, amt = e ? nx : -nx;
        if (ext >= vt) {
          const int k = P + 1 + e;
          total = total + (sign * amt) * (interp<T>(t.dsch, id + 3 * k,
                                                    fdd + 2 * k, xs, dd, d1,
                                                    d2) / dval);
        }
      }
    }
    sink.leg(s, total);
  }
}

// ---- sinks -----------------------------------------------------------------

struct LegJvpSink {        // K9: the legs' tangents; the PVs at d = 0
  double *pv0, *jpv;
  bool first;
  __device__ void leg(int s, const Dual& v) {
    jpv[s] = v.e;
    if (first) pv0[s] = v.v;
  }
};

template <class T>
struct LegSumSink {        // K11: sum gpv . legs
  const double* gpv;
  T total;
  __device__ void leg(int s, const T& v) { total = total + v * gpv[s]; }
};

// ---- the kernels -----------------------------------------------------------

__global__ void __launch_bounds__(kBlock)
k8_stage_jvp(const StageTab t, const Layout L, int D, int npv,
             const double* sp, const double* pv, const double* fd,
             const double* tf, double* ds, double* rows, double* drows) {
  extern __shared__ double sm[];
  const int I = (int)(blockIdx.x % L.nT);
  const long long r = blockIdx.x / L.nT;
  const int g = (int)(r % t.G), sc = (int)(r / t.G);
  const size_t sg = (size_t)sc * t.G + g;
  const int tid = threadIdx.x, d0 = I * L.Dt, nd = min(L.Dt, D - d0);
  const int U1 = t.U1, W = t.W;
  XCCY_STAMP(0);
  const Member m = load_member(t, L, sm, g, sg, sp, pv, fd);
  const Dirs B = block_dirs(I, I, nd, 0, L.Dt, t.S + npv);
  init_block(t, L, sm, B, t.S, npv, sc, D, g, tf);
  __syncthreads();
  XCCY_STAMP(1);
  for (int k = tid; k < nd; k += kBlock) {
    const int d = d0 + k;
    direction_chain(t, L, sm, m, B, k, npv,
                    tf ? tf + (((size_t)sc * D + d) * t.G + g) * t.Lf
                       : nullptr);
  }
  __syncthreads();
  XCCY_STAMP(2);
  XCCY_STAMP(3);
  const double* J = sm + L.J;
  const double* dsv = sm + L.dsv;
  const double* nt = sm + L.nt;
  if (I == 0) {
    for (int u = tid; u < U1; u += kBlock) ds[sg * U1 + u] = dsv[u];
  }
  node_transforms(t, g, dsv, sm + L.nt, tid, kBlock);
  __syncthreads();
  // the rows: each row's primal once, then its tangent along each of the
  // block's directions from its one or two taps, stored coalesced (a warp
  // on 32 consecutive rows of one direction)
  const int rs = t.r_sch[g];
  const int* rqi = t.rq_i + (size_t)g * W * 3;
  const double* rqf = t.rq_f + (size_t)g * W * 2;
  double* out = drows + (((size_t)sc * D + d0) * t.G + g) * W;
  const size_t dstride = (size_t)t.G * W;
  for (int w = tid; w < W; w += kBlock) {
    const int* q = rqi + 3 * w;
    if (q[2] >= 0) {
      const int u = q[2];
      if (I == 0) rows[sg * W + w] = dsv[u];
      for (int k = 0; k < nd; ++k) out[k * dstride + w] = J[u * nd + k];
      continue;
    }
    const RowVal rv = row_val(rs, q, rqf + 2 * w, nt, U1);
    if (I == 0) rows[sg * W + w] = rv.v;
    const int u0 = q[0], u1 = q[1];
    const double c0 = rv.v1 * rv.t0;
    if (u0 == u1) {
      for (int k = 0; k < nd; ++k) out[k * dstride + w] = c0 * J[u0 * nd + k];
    } else {
      const double c1 = rv.v1 * rv.t1;
      for (int k = 0; k < nd; ++k) {
        out[k * dstride + w] = c0 * J[u0 * nd + k] + c1 * J[u1 * nd + k];
      }
    }
  }
  XCCY_STAMP_END();
}


__global__ void __launch_bounds__(kThreads)
k9_legs_jvp(const StageTab t, int Sc, int Qd, const double* dd,
            const double* tdl, double* pv0, double* jpv) {
  const long long item = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (item >= (long long)Sc * t.G * Qd) return;
  const int d = (int)(item % Qd);
  const long long r = item / Qd;
  const int g = (int)(r % t.G), sc = (int)(r / t.G);
  const size_t sg = (size_t)sc * t.G + g;
  const Dir d1{kRow, 0, tdl + (((size_t)sc * Qd + d) * t.G + g) * t.Ld};
  const Dir none{kNone, 0, nullptr};
  LegJvpSink sink{pv0 + sg * t.S,
                  jpv + (((size_t)sc * Qd + d) * t.G + g) * t.S, d == 0};
  legs_eval<Dual>(t, g, dd + sg * t.Ld, d1, none, sink);
}

// K10's work of one (scenario, member): tile pairs I <= J of its D
// directions, each with its pairs i <= j (i in I, j in J), the last one
// also with the n_gf foreign grid entries, cut into blocks of at most
// kItems items (xccy_stage.hess_blocks).
constexpr int kItems = 2 * kBlock;  // xccy_stage.ITEMS

struct TilePair { int I, Jt, nI, nJ, pairs, gf0, items; };

__device__ __host__ __forceinline__ TilePair tile_pair(int tp, int nT, int Dt,
                                                        int D, int n_gf) {
  int I = 0, rem = tp;
  while (rem >= nT - I) {
    rem -= nT - I;
    ++I;
  }
  TilePair p;
  p.I = I;
  p.Jt = I + rem;
  p.nI = min(Dt, D - I * Dt);
  p.nJ = p.Jt > I ? min(Dt, D - p.Jt * Dt) : 0;
  p.pairs = p.Jt > I ? p.nI * p.nJ : p.nI * (p.nI + 1) / 2;
  // the grid entries from a warp's boundary on, so that no warp mixes
  // hyper-dual pairs and dual grid entries
  p.gf0 = (p.pairs + 31) / 32 * 32;
  p.items = tp == nT * (nT + 1) / 2 - 1 && n_gf ? p.gf0 + n_gf : p.pairs;
  return p;
}

__device__ __host__ __forceinline__ int hess_blocks(int nT, int Dt, int D,
                                                    int n_gf) {
  int nb = 0;
  for (int tp = 0; tp < nT * (nT + 1) / 2; ++tp) {
    nb += (tile_pair(tp, nT, Dt, D, n_gf).items + kItems - 1) / kItems;
  }
  return nb;
}

// At most 170 registers a thread (three blocks an SM), the most a pair
// thread's hyper-dual chain takes with nothing spilled to local memory.
__global__ void __launch_bounds__(kBlock, kK10Blocks)
k10_stage_hess(const StageTab t, const Layout L, int D, int npv,
               int n_gf, int per, const double* sp, const double* pv,
               const double* fd, const double* tf, const double* gs,
               double* gZ, double* gf, double* H) {
  extern __shared__ double sm[];
  // a (scenario, member)'s blocks run last first: the last, with the grid
  // entries, is the longest
  const int b = per - 1 - (int)(blockIdx.x % per);
  const long long r = blockIdx.x / per;
  const int g = (int)(r % t.G), sc = (int)(r / t.G);
  const size_t sg = (size_t)sc * t.G + g;
  const int tid = threadIdx.x, S = t.S, U1 = t.U1;
  // this block's tile pair and its chunk of items
  int tp = 0, c = b;
  TilePair P = tile_pair(0, L.nT, L.Dt, D, n_gf);
  for (;;) {
    const int nc = (P.items + kItems - 1) / kItems;
    if (c < nc) break;
    c -= nc;
    P = tile_pair(++tp, L.nT, L.Dt, D, n_gf);
  }
  const int x0 = c * kItems, x1 = min(P.items, x0 + kItems);
  const int I = P.I, Jt = P.Jt, nI = P.nI, nd = P.nI + P.nJ;
  XCCY_STAMP(0);
  const Member m = load_member(t, L, sm, g, sg, sp, pv, fd);
  const double* gsg = gs + sg * t.W;
  const double *cv = sm + L.cv, *av = sm + L.av, *au = sm + L.au;
  double* scr = sm + L.sc + tid;
  double* tape = L.tape >= 0 ? sm + L.tape : nullptr;
  // the prologue: a dual chain a direction of the tile pair (J, the
  // tangent tables, the primal tables and the tape), then a and the band
  // of M over the rows
  const Dirs B = block_dirs(I, Jt, nI, P.nJ, L.Dt, S + npv);
  init_block(t, L, sm, B, S, npv, sc, D, g, tf);
  __syncthreads();
  XCCY_STAMP(1);
  // the dual chains, then a and M's band over the rows; with a tape the
  // primal node DFs are known first, and the chains (warps 0-1) and the
  // rows' sums (warps 2-3, barrier 1) run at once
  if (tape) primal_tape(t, L, sm, m, g);
  const int nc = tape ? kBlock / 2 : kBlock;
  if (tid < nc) {
    for (int k = tid; k < nd; k += nc) {
      const int d = B.d(k);
      direction_chain(t, L, sm, m, B, k, npv,
                      tf ? tf + (((size_t)sc * D + d) * t.G + g) * t.Lf
                         : nullptr);
    }
  } else {
    rows_sums(t, L, sm, g, sm + L.dsv, gsg, Group{nc, kBlock - nc, 1});
  }
  __syncthreads();
  XCCY_STAMP(2);
  if (!tape) rows_sums(t, L, sm, g, sm + L.dsv, gsg, Group{0, kBlock, 0});
  XCCY_STAMP(3);
  const double* md = sm + L.md;
  const double* mo = sm + L.mo;
  const double* J = sm + L.J;
  const double* ce = sm + L.ce;
  const double* ae = sm + L.ae;
  const int* pq = t.mb_pq + (size_t)g * t.E * 2;
  const Dir none{kNone, 0, nullptr};
  // the items: a hyper-dual chain a pair, a dual chain a grid entry
  for (int x = x0 + tid; x < x1; x += kBlock) {
    if (x >= P.pairs) {
      const int l = x - P.gf0;
      if (l < 0) continue;
      GridStore st{scr, L.stride, S, cv, av, au, 0.0};
      st.init();
      chain_eval<Dual>(m, Dir{kUnit, l, nullptr}, none, st,
                       Tape{tape, 0, false});
      gf[sg * t.Lf + l] = st.gsum;
      continue;
    }
    int ki, kj;
    if (Jt > I) {
      ki = x / P.nJ;
      kj = nI + (x - ki * P.nJ);
    } else {
      int rest = x;
      ki = 0;
      while (rest >= nI - ki) {
        rest -= nI - ki;
        ++ki;
      }
      kj = ki + rest;
    }
    const int i = B.d(ki), j = B.d(kj);
    const double* rowi =
        tf ? tf + (((size_t)sc * D + i) * t.G + g) * t.Lf : nullptr;
    const double* rowj =
        tf ? tf + (((size_t)sc * D + j) * t.G + g) * t.Lf : nullptr;
    PairStore st{scr, L.stride, S, cv, av, ce + ki * L.cs, ce + kj * L.cs,
                 ae + ki * L.cs, ae + kj * L.cs, au, 0.0};
    st.init();
    chain_eval<HDual>(m, block_dir(B, ki, S, npv, L, sm, rowi),
                      block_dir(B, kj, S, npv, L, sm, rowj), st,
                      Tape{tape, 0, false});
    const double hij = st.h + band_quad(U1, t.E, pq, md, mo, J, nd, ki, kj);
    H[(((size_t)sc * D + i) * t.G + g) * D + j] = hij;
    H[(((size_t)sc * D + j) * t.G + g) * D + i] = hij;
    if (i == j) {
      double z = 0.0;
      for (int u = 0; u < U1; ++u) z = z + au[u] * J[u * nd + ki];
      gZ[sg * D + i] = z;
    }
  }
  XCCY_STAMP_END();
}

__global__ void __launch_bounds__(kThreads)
k11_legs_hess(const StageTab t, int Sc, int Qd, int n_pairs, const int* pairs,
              int n_gd, const double* dd, const double* tdl,
              const double* gpv, double* gdd, double* Hl) {
  const long long item = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n_h = (long long)Sc * t.G * n_pairs;
  if (item >= n_h + (long long)Sc * t.G * n_gd) return;
  if (item < n_h) {
    const int p = (int)(item % n_pairs);
    const long long r = item / n_pairs;
    const int g = (int)(r % t.G), sc = (int)(r / t.G);
    const size_t sg = (size_t)sc * t.G + g;
    const int i = pairs[2 * p], j = pairs[2 * p + 1];
    const Dir d1{kRow, 0, tdl + (((size_t)sc * Qd + i) * t.G + g) * t.Ld};
    const Dir d2{kRow, 0, tdl + (((size_t)sc * Qd + j) * t.G + g) * t.Ld};
    LegSumSink<HDual> sink{gpv + sg * t.S, {0.0, 0.0, 0.0, 0.0}};
    legs_eval<HDual>(t, g, dd + sg * t.Ld, d1, d2, sink);
    Hl[(((size_t)sc * Qd + i) * t.G + g) * Qd + j] = sink.total.ab;
    Hl[(((size_t)sc * Qd + j) * t.G + g) * Qd + i] = sink.total.ab;
  } else {
    const long long it2 = item - n_h;
    const int l = (int)(it2 % n_gd);
    const long long r = it2 / n_gd;
    const int g = (int)(r % t.G), sc = (int)(r / t.G);
    const size_t sg = (size_t)sc * t.G + g;
    const Dir d1{kUnit, l, nullptr};
    const Dir none{kNone, 0, nullptr};
    LegSumSink<Dual> sink{gpv + sg * t.S, {0.0, 0.0}};
    legs_eval<Dual>(t, g, dd + sg * t.Ld, d1, none, sink);
    gdd[sg * t.Ld + l] = sink.total.e;
  }
}

int blocks_for(long long items) {
  return (int)((items + kThreads - 1) / kThreads);
}

bool fits(const StageTab* t) {
  return t->S >= 1 && t->S <= kMaxS && t->U1 >= 1 && t->U1 <= kMaxU;
}

// K8 / K10's layout of a block's tables for a stage of D directions: the
// core (J, the node DFs and their transforms, the primal and first-order
// tables of C and acc, K10's a, band and row terms, the threads' scratch)
// always (K10's tables of the rows' sums over the threads' scratch where
// they fit); then, where they fit, K10's tape and its lists, the grid's
// transforms, the chain tables and the block's foreign tangent rows. A
// block takes K8's tile of kTile directions, or K10's tile of all D
// directions (a tile pair, J > I, holds two tiles), the tiles halving
// until the core fits; first within the shared memory that lets
// kK10Blocks (K8: kK8Blocks) blocks share an SM, else within a block's
// most.
bool plan_layout(const StageTab* t, int D, int npv, bool hess, bool rows,
                 Layout* out) {
  int dev = 0, smax = 0, ssm = 0, res = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&smax, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&ssm,
                             cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                             dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&res, cudaDevAttrReservedSharedMemoryPerBlock,
                             dev) != cudaSuccess) {
    return false;
  }
  const long long hard = smax / (long long)sizeof(double);
  long long soft = (ssm / (hess ? kK10Blocks : kK8Blocks) - res)
                   / (long long)sizeof(double);
  if (soft > hard) soft = hard;
  for (int pass = 0; pass < 2; ++pass) {
    const long long cap = pass ? hard : soft;
    for (int Dt = hess ? D : (D < kTile ? D : kTile);; Dt = (Dt + 1) / 2) {
      Layout L;
      L.Dt = Dt;
      L.nT = (D + Dt - 1) / Dt;
      L.nd = hess ? 2 * Dt : Dt;
      if (L.nd > D) L.nd = D;
      L.stride = hess ? kBlock : L.nd;
      long long off = 0;
      auto take = [&off](long long k) {
        const int o = (int)off;
        off += k;
        return o;
      };
      L.J = take((long long)t->U1 * L.nd);
      L.dsv = take(t->U1);
      L.nt = take(3LL * t->U1);
      L.cv = take(t->S);
      L.av = take(t->S);
      L.cs = t->S | 1;
      L.ce = take((long long)L.nd * L.cs);
      L.ae = take((long long)L.nd * L.cs);
      L.au = hess ? take(t->U1) : -1;
      L.md = hess ? take(t->U1) : -1;
      L.mo = hess ? take(t->E) : -1;
      L.sc = take(2LL * t->S * L.stride);
      // the rows' sums' tables (K10): over the scratch where they fit
      const long long ri = (kBlock + t->U1 + t->E + 1) / 2;
      const long long nl = (t->U1 + t->NR + t->E + t->NB + 3LL) / 2;
      const bool over = 5LL * kBlock + ri + nl <= 2LL * t->S * L.stride;
      L.rt = !hess ? -1 : over ? L.sc : take(5LL * kBlock);
      L.ri = !hess ? -1 : over ? L.sc + 5 * kBlock : take(ri);
      L.lists = hess && over ? L.ri + (int)ri : -1;
      if (off <= cap) {
        auto room = [&off, cap](long long k) { return off + k <= cap; };
        // K10's tape: at most 4 exps and 2 quotients (4 slots) a point;
        // the primal pass's pp [3, n] over the scratch where it fits
        const long long pp = 3LL * t->n;
        const bool pp_over = pp <= 2LL * t->S * L.stride;
        L.tape = hess && room(8LL * t->n + (pp_over ? 0 : pp))
                     ? take(8LL * t->n) : -1;
        L.pp = L.tape < 0 ? -1 : pp_over ? L.sc : take(pp);
        if (hess && !over && room(nl)) L.lists = take(nl);
        L.gt = room(4LL * t->Lf) ? take(4LL * t->Lf) : -1;
        // the tangent rows of the block's row directions (its d >= S + npv)
        L.ttld = t->Lf | 1;
        long long nr = D - t->S - npv;
        if (nr > L.nd) nr = L.nd;
        const long long ints = (13LL * t->n + 1) / 2;
        if (room(11LL * t->n + ints)) {
          L.ptf = take(5LL * t->n);
          L.fqf = take(6LL * t->n);
          L.ints = take(ints);
        } else {
          L.ptf = L.fqf = L.ints = -1;
        }
        L.tt = rows && nr > 0 && room(nr * L.ttld) ? take(nr * L.ttld) : -1;
        L.bytes = (int)(off * (long long)sizeof(double));
        *out = L;
        return true;
      }
      if (Dt == 1) break;
    }
  }
  return false;
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace

// K8: ds [Sc, G, U1], rows [Sc, G, W], drows [Sc, D, G, W] from sp, pv
// [Sc, G, S], fd [Sc, G, Lf] and tf [Sc, D, G, Lf] (null: no foreign
// directions). A block a (scenario, member, tile of directions).
extern "C" int xccy_stage_jvp_f64(const XccyStageTab* t, int Sc, int D,
                                  int npv, const double* sp, const double* pv,
                                  const double* fd, const double* tf,
                                  double* ds, double* rows, double* drows,
                                  cudaStream_t stream) {
  if (!fits(t) || D < 1) return (int)cudaErrorInvalidValue;
  if ((long long)Sc * t->G == 0) return 0;
  Layout L;
  if (!plan_layout(t, D, npv, false, tf != nullptr, &L)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t err = allow_smem(k8_stage_jvp, L.bytes);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)Sc * t->G * L.nT;
  k8_stage_jvp<<<(unsigned)blocks, kBlock, L.bytes, stream>>>(
      *t, L, D, npv, sp, pv, fd, tf, ds, rows, drows);
  return (int)cudaGetLastError();
}

// K9: pv0 [Sc, G, S], jpv [Sc, Qd, G, S] from dd [Sc, G, Ld] and tdl
// [Sc, Qd, G, Ld].
extern "C" int xccy_legs_jvp_f64(const XccyStageTab* t, int Sc, int Qd,
                                 const double* dd, const double* tdl,
                                 double* pv0, double* jpv,
                                 cudaStream_t stream) {
  if (!fits(t)) return (int)cudaErrorInvalidValue;
  const long long items = (long long)Sc * t->G * Qd;
  if (items == 0) return 0;
  k9_legs_jvp<<<blocks_for(items), kThreads, 0, stream>>>(*t, Sc, Qd, dd, tdl,
                                                          pv0, jpv);
  return (int)cudaGetLastError();
}

// K10: gZ [Sc, G, D], gf [Sc, G, Lf] (n_gf = Lf; 0 writes none), H
// [Sc, D, G, D] from sp, pv, fd, tf as K8's and gs [Sc, G, W]. pairs
// [n_pairs, 2] is the pair table of every i <= j once (n_pairs =
// D(D+1)/2), which the kernel's tile pairs enumerate in its own order. A
// block a (scenario, member, tile pair), then, recalibrated, a block a
// (scenario, member, kBlock grid entries).
extern "C" int xccy_stage_hess_f64(const XccyStageTab* t, int Sc, int D,
                                   int npv, int n_pairs, const int* pairs,
                                   int n_gf,
                                   const double* sp, const double* pv,
                                   const double* fd, const double* tf,
                                   const double* gs, double* gZ, double* gf,
                                   double* H, cudaStream_t stream) {
  (void)pairs;
  if (!fits(t) || D < 1 || (long long)n_pairs != (long long)D * (D + 1) / 2
      || (n_gf != 0 && n_gf != t->Lf)) {
    return (int)cudaErrorInvalidValue;
  }
  if ((long long)Sc * t->G == 0) return 0;
  Layout L;
  if (!plan_layout(t, D, npv, true, tf != nullptr, &L)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t err = allow_smem(k10_stage_hess, L.bytes);
  if (err != cudaSuccess) return (int)err;
  const int per = hess_blocks(L.nT, L.Dt, D, n_gf);
  const long long blocks = (long long)Sc * t->G * per;
  k10_stage_hess<<<(unsigned)blocks, kBlock, L.bytes, stream>>>(
      *t, L, D, npv, n_gf, per, sp, pv, fd, tf, gs, gZ, gf, H);
  return (int)cudaGetLastError();
}

// K11: gdd [Sc, G, Ld] (n_gd = Ld), Hl [Sc, Qd, G, Qd] from pairs
// [n_pairs, 2], dd [Sc, G, Ld], tdl [Sc, Qd, G, Ld] and gpv [Sc, G, S].
extern "C" int xccy_legs_hess_f64(const XccyStageTab* t, int Sc, int Qd,
                                  int n_pairs, const int* pairs, int n_gd,
                                  const double* dd, const double* tdl,
                                  const double* gpv, double* gdd, double* Hl,
                                  cudaStream_t stream) {
  if (!fits(t)) return (int)cudaErrorInvalidValue;
  const long long items = (long long)Sc * t->G * (n_pairs + n_gd);
  if (items == 0) return 0;
  k11_legs_hess<<<blocks_for(items), kThreads, 0, stream>>>(
      *t, Sc, Qd, n_pairs, pairs, n_gd, dd, tdl, gpv, gdd, Hl);
  return (int)cudaGetLastError();
}

// The registers and local memory a thread of kernel `which` (8-11) takes,
// and, at this stage with D directions (rows: tangent rows given), its
// dynamic shared memory a block, the blocks an SM holds at once, its
// threads a block, K8 / K10's tile, what their layout holds in shared
// memory beside the core and their blocks a (scenario, member): out[8] =
// {registers, local bytes a thread, shared bytes a block, blocks an SM,
// threads a block, tile, held: 1 the grid's transforms | 2 the chain
// tables | 4 the tangent rows | 8 K10's tape | 16 K10's lists, blocks a
// (scenario, member)}.
extern "C" int xccy_kernel_info(const XccyStageTab* t, int D, int which,
                                int rows, int* out) {
  const void* fn = nullptr;
  int smem = 0, threads = kThreads, tile = 0, held = 0, per = 0;
  cudaError_t err = cudaSuccess;
  if (which == 8 || which == 10) {
    Layout L;
    if (!fits(t) || D < 1
        || !plan_layout(t, D, rows ? t->S : 0, which == 10, rows != 0, &L)) {
      return (int)cudaErrorInvalidValue;
    }
    fn = which == 8 ? (const void*)k8_stage_jvp : (const void*)k10_stage_hess;
    smem = L.bytes;
    threads = kBlock;
    tile = L.Dt;
    held = (L.gt >= 0) | (L.ptf >= 0) << 1 | (L.tt >= 0) << 2
           | (L.tape >= 0) << 3 | (L.lists >= 0) << 4;
    per = which == 8 ? L.nT : hess_blocks(L.nT, L.Dt, D, rows ? t->Lf : 0);
    err = allow_smem(fn, smem);
  } else if (which == 9) {
    fn = (const void*)k9_legs_jvp;
  } else if (which == 11) {
    fn = (const void*)k11_legs_hess;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaFuncAttributes a;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, fn);
  int nb = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, fn, threads,
                                                       (size_t)smem);
  }
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = smem;
  out[3] = nb;
  out[4] = threads;
  out[5] = tile;
  out[6] = held;
  out[7] = per;
  return 0;
}

#ifdef XCCY_TIMELINE
// The profiling build's stamps of the last launch's first n blocks:
// out[n, 6] = {start, tables loaded, chains, rows' sums, end, SM}.
extern "C" int xccy_timeline(unsigned long long* out, int n) {
  if (n > kStampBlocks) n = kStampBlocks;
  return (int)cudaMemcpyFromSymbol(out, g_stamps,
                                   sizeof(unsigned long long) * 6 * n);
}
#endif
