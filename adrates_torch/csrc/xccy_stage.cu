// K8-K12: the XCCY stage of the structured risk pass, its directional
// derivatives and its Hessians (f64): K8 / K10 / K12 in dual and
// hyper-dual arithmetic, K9 / K11 from the calibration legs' flows'
// partials.
//
// Replace the torch.func towers over one XCCY stage in
// adrates_torch/parallel/structured_risk.py (fwd_delta's pass 2 and
// term2_xccy), which port the XCCY pass of fwd_delta and term2_xccy in
// adrates_tpu/parallel/structured_risk.py (:320- and :457-603) over
// adrates_tpu/parallel/curve_batching.py:265-319 (xccy_legs_pv,
// xccy_boot_ds, xccy_native_ds), adrates_tpu/ops/xccy_bootstrap.py:78
// (bootstrap_xccy) and adrates_tpu/ops/pricers.py:102 (pv_float_leg);
// K12 (with K9 / K11) those of the per-trade second-order tensors
// (make_pertrade_tensors), which port the stage's tensors of the
// per-trade contraction (adrates_tpu/parallel/structured_risk.py:868-
// 975, rowsTx at :949). The JAX package wrote these in plain jnp, which
// XLA lowers: no Pallas kernel. They were added because the stage was
// about half the ops of a FLAT_FWD staged chunk of flagship_v5 (3,600 of
// 6,500 counted on the CPU), each a host dispatch on the card, and (K12)
// about 55% of the per-trade tensors' (5,409 of 9,842).
//
// K8 / K10's stage is written once over a scalar type T: double, Dual
// (value, one tangent) or HDual (value, e1, e2, e1 e2), its inputs lifted
// along one direction or two, so second derivatives are exact with no
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
//   K12 xccy_stage_node_hess: the node DFs as the sink in place of the
//                        contraction with a: the per-trade rows lie on
//                        another plan (the full unique-time rows) than the
//                        stage's tables, and every trade has its own
//                        cotangent, so the kernel writes ds, the nodes'
//                        tangents Jn [D, U1], each pair's nodes' e1 e2 parts
//                        Hn[i, j] = Hn[j, i] [U1] and, recalibrated, each
//                        foreign grid entry's node tangents Jfd [U1]; the
//                        caller contracts a trade's row G_b with the rows'
//                        derivatives in the nodes (a row reads at most two
//                        nodes), H_ij = sum_u a_u Hn_iju + J_i' M_b J_j. Its
//                        chains run a warp each, the lanes on the chain
//                        points (section K12 below): a prologue launch takes
//                        the primal chain and a dual chain a direction and
//                        grid entry once a (scenario, member), and leaves
//                        their tables in a workspace; a second launch takes
//                        a hyper-dual chain a pair.
//   K9 xccy_legs_jvp and K11 xccy_legs_hess: the calibration legs split at
//                        their flows, a block a (scenario, member) of
//                        kLegBlock threads. Both lift the domestic grid
//                        linearly along tangent rows t_d, so Jpv[d, s] =
//                        G_s . t_d and Hl_ij = t_i' M t_j exactly, with G_s
//                        = dPV_s/dd and M = sum_s gpv_s d2PV_s/dd2: all but
//                        the last dot is the same for every direction and
//                        pair. The block transforms its grid once (GPt),
//                        runs a thread a leg for its value DF V_s, then,
//                        chunk by chunk, a thread a flow (leg_flow: n =
//                        sign cf D_pay, PV_s = sum n / V_s, over the index
//                        start A, index end B and payment C, by
//                        pv_float_leg's branches:
//                        a past coupon 0, the first-fixing override, an
//                        ia = 0 slot's double-where, the cap / floor as
//                        torch.clamp, strictly future coupons, the
//                        exchanges at or after the value time, the
//                        principal on the last coupon) writing n, its
//                        partials in its six slots (the taps of A, B, C)
//                        and, K11, gpv_s / V_s times its second partials
//                        in them into the chunk's table; a thread a static
//                        segment of at most 32 terms (the host's lists,
//                        xccy_stage._legs_lists, built from the plans
//                        alone) sums its terms in table order, then a
//                        thread a target adds its segments in order: each
//                        leg's N_s, each (leg, grid row)'s dN_s/dd and,
//                        K11, each entry of M_N = sum_s w_s d2N_s/dd2 on
//                        its static support (the rows each flow's queries
//                        touch). G_s = (dN_s - PV_s dV_s) / V_s; K11
//                        folds the value DF's coupling of every flow of a
//                        leg into U_j = M t_j (M = M_N - sum_s w_s (G_s
//                        dV_s' + dV_s G_s' + PV_s d2V_s), the second term
//                        through gamma_js = G_s . t_j and beta_js = dV_s .
//                        t_j), so M is never dense. K9 writes PV and
//                        Jpv[d, s] a thread a (d, s); K11 writes gdd a
//                        thread a grid entry, then, by tiles of
//                        directions j, U_j a thread a (j, row) and Hl_ij =
//                        t_i . U_j a thread a pair i <= j, written at
//                        [i, j] and [j, i]. The tangent rows [Qd, rows] sit
//                        in shared memory where they fit (plan_legs), else
//                        are read from device memory; U's tile halves until
//                        the core fits.
//
// Hazard: any change to pv_float_leg (adrates_tpu/ops/pricers.py) or the
// port's legs_forward must also be made in leg_flow here, in
// xccy_stage.leg_flow and in the support lists (xccy_stage._legs_lists):
// a slot or a coupling the lists leave out gives a wrong Hessian with no
// error.
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
// What bounds K12. At the per-trade call of flagship_v5's stage (one
// quote vector, G = 3, D = 48) it writes 1.8 MB (Hn's both mirrors) and
// the function needs under 1 MFLOP: its bound is about 0.6 us of bytes.
// 234 pair blocks (tile pairs of 4 directions) of 8 warps fill the card,
// two blocks an SM, each warp two pairs in turn; what bounds it is a
// chain's latency: its lanes' two or three points' hyper-dual
// evaluations, each a sequence of dependent shared-memory reads and f64
// operations through three queries that branch on their kind, then the
// buckets' sums, the pillars' quotients and S multiply-adds and shuffles,
// and the block's copy of its tables from L2 before its first chain. The prologue is that copy, the
// primal chain and one dual chain's latency, on 93 blocks. Two launches a
// per-trade call in place of the towers' device ops (their counts on an
// H100 are in PERF.md, section 5).
//
// What bounds K9 and K11. At flagship_v5's XCCY stage (G = 3, S = 8 legs
// of P = 30 coupons, a domestic grid of 73 entries of which the legs read
// 31, Qd = 32, 50 scenarios a chunk) K11 moves about 4 MB (the tangent
// rows in, Hl out: about 1.2 us at the HBM rate) and the function needs
// about 0.08 GFLOP of f64, the collapse's own count less
// (xccy_stage.needed_flops): the bound is a few microseconds. A block
// does a few thousand flops a thread in short dependent chains between
// barriers (a flow's three queries, a segment's 32 terms, a target's
// segments, U's and a pair's dots over 31 rows), so what bounds it is the
// chain latency of one block on its SM: 150 blocks, one or two an SM.
//
// Sums run in a fixed order with no atomics, so two launches agree bit
// for bit, and each H_ij is written at [i, j] and [j, i] by the thread
// (K12: the warp) that computes it. No allocation; one launch a call on
// the caller's stream (K12: two, its workspace allocated by the caller).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "stage_rows.cuh"

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
  // K9 / K11's lists over the legs (xccy_stage._legs_lists): rows, gradient
  // targets, M_N's entries, segments, chunks, and the widths of the lists
  int R, NL, EL, NS, nC, NGD, NMR, NTT;
  const int* lr_row;    // [G, R] the rows' grid entries (-1 pads)
  const int* lr_of;     // [G, Ld] each grid entry's row or -1
  const int* ls_ptr;    // [G, S + 1] each leg's gradient targets
  const int* ls_row;    // [G, NL] a target's row
  const int* lt_leg;    // [G, NL] a target's leg
  const int* gd_ptr;    // [G, R + 1] each row's targets (CSR)
  const int* gd_t;      // [G, NGD]
  const int* me_rc;     // [G, EL, 2] M_N's entries (r <= c)
  const int* mr_ptr;    // [G, R + 1] each row's entries (CSR)
  const int* mr_e;      // [G, NMR]
  const int* lt_term;   // [G, NTT] the sums' terms (a chunk table's place)
  const int* sg;        // [G, NS, 2] the segments' term ranges
  const int* sc_ptr;    // [G, 2 nC + 1] each chunk's segments
  const int* ts_ptr;    // [G, S + NL + EL + 1] each target's segments
  const int* ts_seg;    // [G, NS]
  // K12's: each pillar's chain point, the known payments by bucket b = k
  // (k + 1) / 2 + s of swap k and segment s (xccy_stage._term_buckets) and
  // the tangents of the basis chain's cumulative sums along the spreads
  int NBT;
  const int* mat_pos;   // [G, S]
  const int* nb_ptr;    // [G, S (S + 1) / 2 + 1]
  const int* nb_pt;     // [G, NBT]
  const int* nb_pos;    // [G, n] each chain point's place in nb_pt or -1
  const double* cum_t;  // [G, S, n]
  const int* pt_ord;    // [G, n] the order the lanes take the points in
};

namespace {

using StageTab = XccyStageTab;


constexpr int kMaxS = 16;     // xccy_stage.MAX_S
constexpr int kMaxU = 64;     // xccy_stage.MAX_U

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

// K12's tapes, whose mode is the type's: its primal chain records its
// exps and quotients (Record), every other chain reads them (Replay), so
// neither carries the other's code.
struct Record {
  double* p;
  int i;
  __device__ __forceinline__ double exp_of(double x) {
    const double e = exp(x);
    p[i++] = e;
    return e;
  }
  __device__ __forceinline__ QR div_of(double x, double y) {
    const QR d{x / y, 1.0 / y};
    p[i] = d.q;
    p[i + 1] = d.r;
    i += 2;
    return d;
  }
};

struct Replay {
  const double* p;
  int i;
  __device__ __forceinline__ double exp_of(double) { return p[i++]; }
  __device__ __forceinline__ QR div_of(double, double) {
    const QR d{p[i], p[i + 1]};
    i += 2;
    return d;
  }
};

template <class TP>
__device__ __forceinline__ double texp(double x, TP& tp) {
  return tp.exp_of(x);
}
template <class TP>
__device__ __forceinline__ Dual texp(const Dual& x, TP& tp) {
  const double e = tp.exp_of(x.v);
  return {e, e * x.e};
}
template <class TP>
__device__ __forceinline__ HDual texp(const HDual& x, TP& tp) {
  const double e = tp.exp_of(x.v);
  return {e, e * x.a, e * x.b, e * (x.ab + x.a * x.b)};
}

template <class TP>
__device__ __forceinline__ double tdiv(double x, double y, TP& tp) {
  return tp.div_of(x, y).q;
}
template <class TP>
__device__ __forceinline__ Dual tdiv(const Dual& x, const Dual& y, TP& tp) {
  const QR d = tp.div_of(x.v, y.v);
  return {d.q, (x.e - d.q * y.e) * d.r};
}
template <class TP>
__device__ __forceinline__ HDual tdiv(const HDual& x, const HDual& y,
                                      TP& tp) {
  const QR d = tp.div_of(x.v, y.v);
  const double qa = (x.a - d.q * y.a) * d.r, qb = (x.b - d.q * y.b) * d.r;
  return {d.q, qa, qb, (x.ab - d.q * y.ab - qa * y.b - qb * y.a) * d.r};
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

// kGt: the transforms are in memory (K12), so no transform is taken here.
template <bool kGt = false>
__device__ __forceinline__ GPt grid_pt(const Member& m, int l) {
  if (kGt || m.gt) {
    return {m.gt[l], m.gt[m.Lf + l], m.gt[2 * m.Lf + l], m.gt[3 * m.Lf + l]};
  }
  return transform(m.fsch, m.fd[l], m.fxg[l]);
}

// interpolation.simple_df_static at one packed query of the foreign grid,
// its values lifted as they are read.
template <class T, class TP, bool kGt = false>
__device__ __forceinline__ T query(const Member& m, int q, const Dir& d1,
                                   const Dir& d2, TP& tp) {
  const int* qi = m.fqi + 3 * q;
  const double* qf = m.fqf + 2 * q;
  const int kn = qi[2];
  if (kn >= 0) {
    return lift<T>(kGt || m.gt ? m.gt[kn] : m.fd[kn], tan_grid(d1, kn),
                   tan_grid(d2, kn));
  }
  const int l0 = qi[0], l1 = qi[1];
  const T y0 = lift_y<T>(grid_pt<kGt>(m, l0), tan_grid(d1, l0),
                         tan_grid(d2, l0));
  const T v = y0 + qf[0] * (lift_y<T>(grid_pt<kGt>(m, l1), tan_grid(d1, l1),
                                      tan_grid(d2, l1)) - y0);
  if (m.fsch == kFlatFwd) return texp(-v, tp);
  if (m.fsch == kLinZero) return texp(-v * qf[1], tp);
  return v;
}

// One chain point i of a member (xccy_stage.thread_chain): the foreign
// DFs at its payment, start and end (a coupon's) through the static simple
// plan, the basis chain's base = df_pay exp(cum) and the cashflow cf (its
// exps and the coupon's quotient on the tape tp).
template <class T, class TP, bool kGt = false>
__device__ __forceinline__ void point_eval(const Member& m, int i, int fl,
                                           const double* pf, const T& spk,
                                           const T& cum, const Dir& d1,
                                           const Dir& d2, TP& tp, T& base,
                                           T& cf) {
  const int n = m.n;
  const double notl = pf[0], ss = pf[1], ar = pf[2];
  const T pay = query<T, TP, kGt>(m, 2 * n + i, d1, d2, tp);
  base = pay * texp(cum, tp);
  if (fl & kNotl) {
    cf = lift<T>((fl & kLast) ? notl : -notl, 0.0, 0.0) + spk * ss;
  } else {
    const T q0 = query<T, TP, kGt>(m, i, d1, d2, tp);
    const T r = tdiv(q0, query<T, TP, kGt>(m, n + i, d1, d2, tp), tp);
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

// ---- K12: a warp a chain, its lanes on the chain points -------------------
//
// K12 xccy_stage_node_hess writes the node DFs themselves, for the per-trade
// tensors, whose rows are on another plan than the stage's tables (the full
// unique-time rows): no row, no cotangent. A chain of K12 is one warp
// (xccy_stage.warp_chain mirrors it):
//
//   chain_point: its lanes take the chain points (place x of the host's
//     order pt_ord to lane x % 32: the coupons, then the notional
//     exchanges), each evaluating its points' foreign DF queries, base and
//     cashflow (point_eval) at once, since none of them reads a solved
//     factor, and keeping each point's base, a pillar's divisor fxs cf base
//     and, of a known payment's term t = cf base w, the part of t C_s that
//     C_s's carried part does not touch (K) and t's value (V), at its place
//     in the host's lists of known payments by swap k and segment s <= k
//     (nb_ptr / nb_pt / nb_pos);
//   chain_solve: a lane a (swap, segment) bucket sums its V in list order
//     (the primal chain; the others read its sums); lane r sums its swap's
//     K, acc_r's carried part but for the factors, and takes pillar r's
//     quotient as an affine map of acc_r's carried part, C_{r+1} = al_r +
//     be_r acc_r (its exps and quotients the tape's, its divisor the
//     point's); then the ranks in order, each a multiply-add on lane r, its
//     C_{r+1} broadcast by a shuffle and added to the later swaps' acc
//     (V_{q, r+1} C_{r+1} on lane q); then the lanes set every node, C
//     base.
//
// Only one part of C and acc is carried (the top part): the value in the
// primal chain, the tangent in a direction's, the e1 e2 part in a pair's;
// the others are the member's tables. A first version summed each rank's
// terms over the lanes by a shuffle tree, a rank at a time: on the card
// those ranks took about half of a chain, which is why the sums are by
// bucket and the ranks a multiply-add each. Two launches:
//
//   k12_node_prologue: a block a (scenario, member), its warp 0 on the
//     primal chain and its other warps on as many items. The block copies
//     the member's chain tables and the tangents of the basis chain's
//     cumulative sums cum along the spreads (cum_t, static) into shared
//     memory and takes cum, a thread a point, and its threads evaluate the
//     primal chain's points (recording their exps and quotients on the
//     tape, at each point's place tp_off); warp 0 solves the primal chain
//     while the other warps evaluate their items' points: a dual chain
//     along a direction of the stage (its first tangents ce / ae of C and
//     acc, and its nodes' tangents, Jn) or, recalibrated, along a unit
//     foreign grid entry (Jfd); then they solve them. The member's first
//     block writes ds and the member's workspace (the tape, the grid's
//     transforms, cum, the primal C and acc and the buckets' sums of V), a
//     direction's warp its rows of ce / ae.
//   k12_node_pairs: a block a (scenario, member) and a tile pair I <= J of
//     directions (K10's cut), which copies the member's tables, its
//     workspace and its directions' rows into shared memory once; its warps
//     take its pairs i <= j in turn, each a chain in hyper-dual numbers (no
//     exp, no division in its primal part), its nodes' e1 e2 parts written
//     as one row at Hn[i, j] and at Hn[j, i] (the t = 0 node and the pad
//     slots 0). The tile is the largest that gives every SM a block.
//
// A warp keeps its points' bases in its part of the block's shared memory,
// lane-contiguous, beside its pillars' divisors, its terms' K and V in list
// order, the carried parts of C (cab), the buckets' sums of V and its
// nodes. Copies into shared memory are asynchronous (cp.async), all of a
// block's in flight at once. The chains read the tape through Replay and
// the grid's transforms from memory, so their code holds no exp, division
// or transform (whose slow paths, calls, cost registers and spilled).

constexpr int kLanes = 32;      // xccy_stage.NODE_LANES

#ifdef XCCY_TIMELINE
// scripts/k12_phases.py: block 0 of each K12 launch stamps the SM's clock
// (cycles) at its phases, lane 0 of warp 0 at stamp k and of warp 1 at k
// + 32 (k12_timeline reads them): 0-5 the prologue (start, tables copied,
// cum, the primal points, warp 0's primal chain solved / warp 1's item
// points, synchronised), 6-8 a solve (its sums and pillars, its ranks, its
// nodes; warp 0 the primal chain's, warp 1 its item's), 10-13 the pair
// launch (start, tables copied, a pair's points begun, evaluated), 14-16
// a pair's solve, 17 its rows written (warp 0's and 1's last pair).
__device__ long long g_k12[64];
__device__ __forceinline__ void k12_stamp(int k) {
  if (blockIdx.x == 0 && (threadIdx.x & 31) == 0 && threadIdx.x < 64) {
    g_k12[k + 32 * (threadIdx.x / 32)] = clock64();
  }
}
#define K12_STAMP(k) k12_stamp(k)
#else
#define K12_STAMP(k)
#endif
constexpr int kNodeWarps = 4;   // xccy_stage.NODE_WARPS: a prologue block's
                                // item warps (and its primal warp)
constexpr int kPairWarps = 8;   // xccy_stage.PAIR_WARPS: a pair block's
constexpr int kMaxNB = kMaxS * (kMaxS + 1) / 2;  // buckets of a member

__device__ __forceinline__ double top(double x) { return x; }
__device__ __forceinline__ double top(const Dual& x) { return x.e; }
__device__ __forceinline__ double top(const HDual& x) { return x.ab; }
__device__ __forceinline__ double val(double x) { return x; }
__device__ __forceinline__ double val(const Dual& x) { return x.v; }
__device__ __forceinline__ double val(const HDual& x) { return x.v; }

// A value in a warp's scratch: its parts kLanes apart (a lane's column).
__device__ __forceinline__ void st_lane(double* p, double x) { p[0] = x; }
__device__ __forceinline__ void st_lane(double* p, const Dual& x) {
  p[0] = x.v;
  p[kLanes] = x.e;
}
__device__ __forceinline__ void st_lane(double* p, const HDual& x) {
  p[0] = x.v;
  p[kLanes] = x.a;
  p[2 * kLanes] = x.b;
  p[3 * kLanes] = x.ab;
}
template <class T> __device__ __forceinline__ T ld_lane(const double* p);
template <> __device__ __forceinline__ double ld_lane<double>(const double* p) {
  return p[0];
}
template <> __device__ __forceinline__ Dual ld_lane<Dual>(const double* p) {
  return {p[0], p[kLanes]};
}
template <> __device__ __forceinline__ HDual ld_lane<HDual>(const double* p) {
  return {p[0], p[kLanes], p[2 * kLanes], p[3 * kLanes]};
}

// Asynchronous copies of len values into shared memory (cp.async), by the
// block's threads; the caller commits, waits and synchronises.
template <class V>
__device__ __forceinline__ void acopy(V* dst, const V* src, int len) {
  for (int x = threadIdx.x; x < len; x += blockDim.x) {
    __pipeline_memcpy_async(dst + x, src + x, sizeof(V));
  }
}

__device__ __forceinline__ void acopy_wait() {
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
}

// The factors C_s and sums acc_r of a chain: c(s, top) with its carried
// part top, low(s) with 0 there (C_0 = 1, no derivative), acc(r, top);
// solved(r, acc_r's, C_{r+1}'s carried parts) keeps what a later chain
// reads. kDefer: a term's K = t.e C_s's value is taken once the primal C
// is known (the prologue's dual chains evaluate their points while the
// primal chain solves), the point keeping t.e.
struct PrimFrame {       // double: the primal chain, writing cv / av
  static constexpr bool kDefer = false;
  double *cv, *av;
  __device__ double low(int s) const { return s == 0 ? 1.0 : 0.0; }
  __device__ double c(int s, double t) const { return s == 0 ? 1.0 : t; }
  __device__ double acc(int, double t) const { return t; }
  __device__ void solved(int r, double a, double x) const {
    cv[r] = x;
    av[r] = a;
  }
};

struct DualFrame {       // Dual: a direction's chain over the primal tables
  static constexpr bool kDefer = true;   // its K once the primal C is known
  const double *cv, *av;
  double *ce, *ae;       // the direction's rows of the first tangents, or null
  __device__ Dual low(int s) const {
    return s == 0 ? Dual{1.0, 0.0} : Dual{cv[s - 1], 0.0};
  }
  __device__ Dual c(int s, double t) const {
    return s == 0 ? Dual{1.0, 0.0} : Dual{cv[s - 1], t};
  }
  __device__ Dual acc(int r, double t) const { return {av[r], t}; }
  __device__ void solved(int r, double a, double x) const {
    if (ce) {
      ce[r] = x;
      ae[r] = a;
    }
  }
};

struct PairFrame {       // HDual: a pair's chain over the first-order tables
  static constexpr bool kDefer = false;
  const double *cv, *av, *ci, *cj, *ai, *aj;
  __device__ HDual low(int s) const {
    if (s == 0) return {1.0, 0.0, 0.0, 0.0};
    return {cv[s - 1], ci[s - 1], cj[s - 1], 0.0};
  }
  __device__ HDual c(int s, double t) const {
    if (s == 0) return {1.0, 0.0, 0.0, 0.0};
    return {cv[s - 1], ci[s - 1], cj[s - 1], t};
  }
  __device__ HDual acc(int r, double t) const {
    return {av[r], ai[r], aj[r], t};
  }
  __device__ void solved(int, double, double) const {}
};

// What a chain reads beside the member: the tape and its offsets, the
// basis chain's primal cumulative sums cumv [n] and, for a spread
// direction d1 / d2, the tangents of cum along it (cs1 / cs2 [n], else
// null); the pillars' chain points and the lists of known payments.
struct Chain {
  const int* off;
  double* tape;          // recorded by the primal chain, read by the others
  const double *cumv, *cs1, *cs2;
  const int *mat, *nbp, *nbq, *ord;
  const double* vsum;    // the buckets' sums of V (the primal chain's), or
                         // null: the chain sums them
  int S, U1;
};

// A warp's part of the block's shared memory (node_scratch's layout).
struct WarpScratch {
  double* ps;            // [npl, parts of T, kLanes]: the points' bases
  double* dv;            // [kMaxS, 4] the pillars' divisors
  double* cab;           // [kMaxS + 1] the carried parts of C
  double* nodes;         // [kMaxU]
  double* vs;            // [kMaxNB] the buckets' sums of V
  double* kb;            // [NBT] the terms' K, in list order
  double* vb;            // [NBT] and V
};

__device__ __forceinline__ WarpScratch carve(double* p, int npl, int np,
                                             int nbt) {
  WarpScratch w;
  w.ps = p;
  w.dv = p + np * kLanes * npl;
  w.cab = w.dv + 4 * kMaxS;
  w.nodes = w.cab + kMaxS + 1;
  w.vs = w.nodes + kMaxU;
  w.kb = w.vs + kMaxNB;
  w.vb = w.kb + nbt;
  return w;
}

// The doubles of a warp's scratch (carve) for values of np parts.
__host__ __device__ __forceinline__ int node_scratch(int npl, int np,
                                                     int nbt) {
  return np * kLanes * npl + 4 * kMaxS + kMaxS + 1 + kMaxU + kMaxNB
         + 2 * nbt;
}

// A value's parts contiguous (a pillar's divisor).
__device__ __forceinline__ void st_flat(double* p, double x) { p[0] = x; }
__device__ __forceinline__ void st_flat(double* p, const Dual& x) {
  p[0] = x.v;
  p[1] = x.e;
}
__device__ __forceinline__ void st_flat(double* p, const HDual& x) {
  p[0] = x.v;
  p[1] = x.a;
  p[2] = x.b;
  p[3] = x.ab;
}
template <class T> __device__ __forceinline__ T ld_flat(const double* p);
template <> __device__ __forceinline__ double ld_flat<double>(const double* p) {
  return p[0];
}
template <> __device__ __forceinline__ Dual ld_flat<Dual>(const double* p) {
  return {p[0], p[1]};
}
template <> __device__ __forceinline__ HDual ld_flat<HDual>(const double* p) {
  return {p[0], p[1], p[2], p[3]};
}

// The primal chain records the tape, the others read it.
template <class T> struct TapeOf { using type = Replay; };
template <> struct TapeOf<double> { using type = Record; };

// The chain point at place x of the lanes' order, of member m along d1 /
// d2 (xccy_stage.warp_chain's first step): its base into the chain's
// scratch at place x (lane x % 32's column), a pillar's divisor at its
// rank, a known payment's K and V at its place in the lists, whichever
// thread evaluates it.
template <class T, class F>
__device__ __forceinline__ void chain_point(const Member& m, const Chain& ch,
                                            int x, const Dir& d1,
                                            const Dir& d2, const F& fr,
                                            const WarpScratch& w) {
  constexpr int NP = sizeof(T) / sizeof(double);
  const int p = ch.ord[x];
  const int* pi = m.pi + 4 * p;
  const double* pf = m.pf + 5 * p;
  const int k = pi[0], fl = pi[2];
  if (point_skips(fl, pf[4], pi[3])) return;
  const T spk = lift<T>(m.sp[k], tan_sp(d1, k), tan_sp(d2, k));
  const T cum = lift<T>(ch.cumv[p], ch.cs1 ? ch.cs1[p] : 0.0,
                        ch.cs2 ? ch.cs2[p] : 0.0);
  using TP = typename TapeOf<T>::type;
  TP tp{ch.tape, ch.off[p]};
  T base, cf;
  point_eval<T, TP, true>(m, p, fl, pf, spk, cum, d1, d2, tp, base, cf);
  st_lane(w.ps + (x / kLanes) * NP * kLanes + (x & (kLanes - 1)), base);
  if (fl & kMat) {
    st_flat(w.dv + 4 * k, (m.fxs * cf) * base);
  } else if (pf[4] != 0.0) {
    const T t = (cf * base) * pf[4];
    const int y = ch.nbq[p];
    w.kb[y] = F::kDefer ? top(t) : top(t * fr.low(pi[1]));
    if (!ch.vsum) w.vb[y] = val(t);
  }
}

// Pillar r's quotient as an affine map of acc_r's carried part: C_{r+1}'s
// carried part = al + be acc_r's, d its divisor; rr = 1 / d's value (the
// primal chain's own; the tape's in the others).
template <class T, class F>
__device__ __forceinline__ void pillar(const Member& m, const Chain& ch,
                                       const F& fr, int r, const T& d,
                                       const Dir& d1, const Dir& d2,
                                       double& al, double& be, double& rr) {
  const T num = -(lift<T>(m.pv[r], tan_pv(d1, r), tan_pv(d2, r))
                  + m.fxs * (m.v0[r] + fr.acc(r, 0.0)));
  const int o = ch.off[ch.mat[r] + 1] - 2;
  if constexpr (sizeof(T) == sizeof(double)) {
    rr = __drcp_rn(d);
    al = num * rr;
  } else {
    Replay tp{ch.tape, o};
    al = top(tdiv(num, d, tp));
    rr = ch.tape[o + 1];
  }
  be = -m.fxs * rr;
}

// The rest of the chain, by one warp once its points are in its scratch
// (xccy_stage.warp_chain): a lane a bucket's sum of V (the primal chain;
// the others read its sums); lane r its swap's sum of K and its pillar;
// the ranks in order; the nodes' carried parts into w.nodes (fill where no
// point sets a node: 1 for the primal DFs, 0 for their derivatives). The
// primal chain records each pillar's quotient and reciprocal on the tape.
template <class T, class F>
__device__ __forceinline__ void chain_solve(const Member& m, const Chain& ch,
                                            const Dir& d1,
                            const Dir& d2, const F& fr, const WarpScratch& w,
                            double fill) {
  constexpr int NP = sizeof(T) / sizeof(double);
  const int lane = threadIdx.x & (kLanes - 1), n = m.n, S = ch.S;
  for (int u = lane; u < ch.U1; u += kLanes) w.nodes[u] = fill;
  const double* vs = ch.vsum ? ch.vsum : w.vs;
  if (!ch.vsum) {
    for (int b = lane; b < S * (S + 1) / 2; b += kLanes) {
      double v = 0.0;
      for (int x = ch.nbp[b]; x < ch.nbp[b + 1]; ++x) v = v + w.vb[x];
      w.vs[b] = v;
    }
  }
  double acc = 0.0, al = 0.0, be = 0.0, rr = 0.0;
  const int b0 = lane * (lane + 1) / 2;
  if (lane < S) {
    if constexpr (F::kDefer) {
      for (int s = 0; s <= lane; ++s) {
        const double c = s == 0 ? 1.0 : val(fr.low(s));
        for (int x = ch.nbp[b0 + s]; x < ch.nbp[b0 + s + 1]; ++x) {
          acc = acc + w.kb[x] * c;
        }
      }
    } else {
      for (int x = ch.nbp[b0]; x < ch.nbp[b0 + lane + 1]; ++x) {
        acc = acc + w.kb[x];
      }
    }
    pillar<T>(m, ch, fr, lane, ld_flat<T>(w.dv + 4 * lane), d1, d2, al, be,
              rr);
  }
  if (lane == 0) w.cab[0] = 0.0;
  __syncwarp();
  K12_STAMP(sizeof(T) == sizeof(HDual) ? 14 : 6);
  for (int r = 0; r < S; ++r) {
    const double x = __shfl_sync(0xffffffffu, al + be * acc, r);
    if (lane == r) {
      w.cab[r + 1] = x;
      fr.solved(r, acc, x);
      if constexpr (sizeof(T) == sizeof(double)) {
        const int o = ch.off[ch.mat[r] + 1] - 2;
        ch.tape[o] = x;
        ch.tape[o + 1] = rr;
      }
    } else if (lane > r && lane < S) {
      acc = acc + vs[b0 + r + 1] * x;
    }
  }
  __syncwarp();
  K12_STAMP(sizeof(T) == sizeof(HDual) ? 15 : 7);
  for (int x = lane; x < n; x += kLanes) {
    const int* pi = m.pi + 4 * ch.ord[x];
    if (pi[3] < 0) continue;
    const int s = (pi[2] & kMat) ? pi[0] + 1 : pi[1];
    const T base = ld_lane<T>(w.ps + (x / kLanes) * NP * kLanes + lane);
    w.nodes[pi[3]] = top(fr.c(s, w.cab[s]) * base);
  }
  __syncwarp();
  K12_STAMP(sizeof(T) == sizeof(HDual) ? 16 : 8);
}

// A chain's points by one warp's lanes.
template <class T, class F>
__device__ __forceinline__ void warp_points(const Member& m, const Chain& ch,
                                            const Dir& d1, const Dir& d2,
                                            const F& fr,
                                            const WarpScratch& w) {
  for (int x = threadIdx.x & (kLanes - 1); x < m.n; x += kLanes) {
    chain_point<T>(m, ch, x, d1, d2, fr, w);
  }
  __syncwarp();
}

// K12's layout (node_plan): the blocks' warps, the pair launch's tile of
// directions, a warp's scratch in each launch, the member's workspace in
// device memory, and where each launch keeps its tables in dynamic shared
// memory, as offsets in doubles (-1: read from device memory).
struct NodeLayout {
  int warps, pwarps, npl, Dt, nT;
  int wpro, wpair;
  int ws, w_tape, w_gt, w_cum, w_cv, w_av, w_vs, w_ce, w_ae;
  // the prologue: chain tables, sp / pv / v0, tape, cum, cs, cv / av / ds,
  // the grid's transforms, the warps' scratch
  int p_tab, p_aux, p_tape, p_cum, p_cs, p_cv, p_gt, p_warps, pro_bytes;
  // the pairs: the same, the block's directions' rows of ce / ae and their
  // foreign tangent rows
  int q_tab, q_aux, q_tape, q_cum, q_cs, q_cv, q_ce, q_gt, q_tf, q_warps;
  int pair_bytes;
};

// The doubles of a member's chain tables in shared memory: pt_f, fq_f,
// then pt_i, fq_i, tp_off, mat_pos, nb_ptr, nb_pos and pt_ord
// (node_member).
__host__ __device__ __forceinline__ long long node_tab(const StageTab& t) {
  const long long n = t.n, S = t.S;
  return 11 * n + (16 * n + 1 + S + S * (S + 1) / 2 + 1 + 1) / 2;
}

// Member g of (scenario, member) sg: its chain tables, tape offsets,
// pillars, lists of known payments and lane order at `tab` in shared
// memory, or in device memory (tab null); sp, pv and v0 at `aux`; the
// copies issued (cp.async) by the block's threads, the caller waiting for
// them (acopy_wait).
__device__ __forceinline__ Member node_member(const StageTab& t, int g,
                                              size_t sg,
                              const double* sp, const double* pv,
                              const double* fd, double* tab, double* aux,
                              const int** off, const int** mat,
                              const int** nbp, const int** nbq,
                              const int** ord) {
  const int n = t.n, S = t.S, NB = S * (S + 1) / 2;
  Member m;
  m.n = n;
  m.Lf = t.Lf;
  m.fsch = t.fsch;
  m.fxs = t.fxs[g];
  m.fd = fd + sg * t.Lf;
  m.fxg = t.f_xs + (size_t)g * t.Lf;
  m.gt = nullptr;
  acopy(aux, sp + sg * S, S);
  acopy(aux + S, pv + sg * S, S);
  acopy(aux + 2 * S, t.v0 + (size_t)g * S, S);
  m.sp = aux;
  m.pv = aux + S;
  m.v0 = aux + 2 * S;
  const double* pf = t.pt_f + (size_t)g * n * 5;
  const double* fqf = t.fq_f + (size_t)g * 3 * n * 2;
  const int* pi = t.pt_i + (size_t)g * n * 4;
  const int* fqi = t.fq_i + (size_t)g * 3 * n * 3;
  const int* o = t.tp_off + (size_t)g * (n + 1);
  const int* mp = t.mat_pos + (size_t)g * S;
  const int* bp = t.nb_ptr + (size_t)g * (NB + 1);
  const int* bq = t.nb_pos + (size_t)g * n;
  const int* od = t.pt_ord + (size_t)g * n;
  if (!tab) {
    m.pf = pf;
    m.fqf = fqf;
    m.pi = pi;
    m.fqi = fqi;
    *off = o;
    *mat = mp;
    *nbp = bp;
    *nbq = bq;
    *ord = od;
    return m;
  }
  double* spf = tab;
  double* sqf = spf + 5 * n;
  int* spi = reinterpret_cast<int*>(sqf + 6 * n);
  int* sqi = spi + 4 * n;
  int* so = sqi + 9 * n;
  int* smp = so + n + 1;
  int* sbp = smp + S;
  int* sbq = sbp + NB + 1;
  int* sod = sbq + n;
  acopy(spf, pf, 5 * n);
  acopy(sqf, fqf, 6 * n);
  acopy(spi, pi, 4 * n);
  acopy(sqi, fqi, 9 * n);
  acopy(so, o, n + 1);
  acopy(smp, mp, S);
  acopy(sbp, bp, NB + 1);
  acopy(sbq, bq, n);
  acopy(sod, od, n);
  m.pf = spf;
  m.fqf = sqf;
  m.pi = spi;
  m.fqi = sqi;
  *off = so;
  *mat = smp;
  *nbp = sbp;
  *nbq = sbq;
  *ord = sod;
  return m;
}

// Direction d of the stage: a basis spread, a leg PV or the foreign
// tangent row `row` (in shared or device memory).
__device__ __forceinline__ Dir node_dir(int d, int S, int npv,
                                        const double* row) {
  if (d < S) return {kSpread, d, nullptr};
  if (d < S + npv) return {kPv, d - S, nullptr};
  return {kRow, 0, row};
}

__device__ __forceinline__ const double* tf_row(const StageTab& t,
                                                const double* tf, int sc,
                                                int D, int d, int g) {
  return tf + (((size_t)sc * D + d) * t.G + g) * t.Lf;
}

// The primal chain and a dual chain an item: a block a (scenario, member)
// and L.warps of its items (its D directions, then its n_gf foreign grid
// entries); per = the blocks of a (scenario, member).
__global__ void __launch_bounds__((kNodeWarps + 1) * kLanes, 3)
k12_node_prologue(const StageTab t, const NodeLayout L, int D, int npv,
                  int n_gf, int per, const double* sp, const double* pv,
                  const double* fd, const double* tf, double* ds, double* Jn,
                  double* Jfd, double* ws) {
  extern __shared__ double sm[];
  K12_STAMP(0);
  const int c = (int)(blockIdx.x % per), r = (int)(blockIdx.x / per);
  const int g = r % t.G, sc = r / t.G;
  const size_t sg = (size_t)sc * t.G + g;
  const int tid = threadIdx.x, nth = blockDim.x, wid = tid / kLanes;
  const int lane = tid & (kLanes - 1), S = t.S, n = t.n, U1 = t.U1;
  const int Lf = t.Lf;
  double* W = ws + sg * L.ws;
  const int *off, *mat, *nbp, *nbq, *ord;
  Member m = node_member(t, g, sg, sp, pv, fd,
                         L.p_tab >= 0 ? sm + L.p_tab : nullptr, sm + L.p_aux,
                         &off, &mat, &nbp, &nbq, &ord);
  double* cs = sm + L.p_cs;
  acopy(cs, t.cum_t + (size_t)g * S * n, S * n);
  // the grid's transforms: the block's own, the member's first block's
  // into the workspace too
  double* gt = sm + L.p_gt;
  for (int l = tid; l < Lf; l += nth) {
    const GPt p = transform(t.fsch, m.fd[l], m.fxg[l]);
    gt[l] = p.d;
    gt[Lf + l] = p.y;
    gt[2 * Lf + l] = p.y1;
    gt[3 * Lf + l] = p.y2;
    if (c == 0) {
      W[L.w_gt + l] = p.d;
      W[L.w_gt + Lf + l] = p.y;
      W[L.w_gt + 2 * Lf + l] = p.y1;
      W[L.w_gt + 3 * Lf + l] = p.y2;
    }
  }
  m.gt = gt;
  acopy_wait();
  K12_STAMP(1);
  // cum, a thread a point (xccy_stage.chain_cums)
  double* cumv = sm + L.p_cum;
  for (int i = tid; i < n; i += nth) {
    double v = 0.0;
    for (int k = 0; k < S; ++k) v = v + m.sp[k] * cs[k * n + i];
    cumv[i] = v;
  }
  __syncthreads();
  K12_STAMP(2);
  // the primal chain: its points by the block's threads, recording the
  // tape; solved by warp 0
  double* tape = sm + L.p_tape;
  const WarpScratch w0 = carve(sm + L.p_warps, L.npl, 2, t.NBT);
  const Dir none{kNone, 0, nullptr};
  const Chain ch0{off, tape, cumv, nullptr, nullptr, mat, nbp, nbq, ord,
                  nullptr, S, U1};
  const PrimFrame f0{sm + L.p_cv, sm + L.p_cv + S};
  for (int x = tid; x < n; x += nth) {
    chain_point<double>(m, ch0, x, none, none, f0, w0);
  }
  __syncthreads();
  K12_STAMP(3);
  // warp 0 solves the primal chain while the other warps evaluate their
  // items' points (a dual chain each: a direction of the stage, then,
  // recalibrated, a unit foreign grid entry)
  const int x = c * L.warps + wid - 1;
  const bool item = wid > 0 && x < D + n_gf;
  const WarpScratch w = carve(sm + L.p_warps + wid * L.wpro, L.npl, 2,
                              t.NBT);
  Dir d{kUnit, x - D, nullptr};
  DualFrame fr{sm + L.p_cv, sm + L.p_cv + S, nullptr, nullptr};
  double* out = nullptr;
  if (item && x >= D) {
    out = Jfd + (((size_t)sc * Lf + (x - D)) * t.G + g) * U1;
  } else if (item) {
    d = node_dir(x, S, npv, x >= S + npv ? tf_row(t, tf, sc, D, x, g)
                                         : nullptr);
    fr.ce = W + L.w_ce + x * S;
    fr.ae = W + L.w_ae + x * S;
    out = Jn + (((size_t)sc * D + x) * t.G + g) * U1;
  }
  const Chain ch{off, tape, cumv, item && x < S ? cs + x * n : nullptr,
                 nullptr, mat, nbp, nbq, ord, w0.vs, S, U1};
  if (wid == 0) {
    chain_solve<double>(m, ch0, none, none, f0, w0, 1.0);
    for (int u = lane; u < U1; u += kLanes) {
      sm[L.p_cv + 2 * S + u] = w0.nodes[u];
    }
  } else if (item) {
    warp_points<Dual>(m, ch, d, none, fr, w);
  }
  K12_STAMP(4);
  __syncthreads();
  K12_STAMP(5);
  if (item) {
    chain_solve<Dual>(m, ch, d, none, fr, w, 0.0);
    for (int u = lane; u < U1; u += kLanes) out[u] = w.nodes[u];
  }
  // the member's first block: ds and the workspace
  if (c == 0) {
    for (int y = tid; y < off[n]; y += nth) W[L.w_tape + y] = tape[y];
    for (int y = tid; y < n; y += nth) W[L.w_cum + y] = cumv[y];
    for (int y = tid; y < S; y += nth) {
      W[L.w_cv + y] = sm[L.p_cv + y];
      W[L.w_av + y] = sm[L.p_cv + S + y];
    }
    for (int y = tid; y < S * (S + 1) / 2; y += nth) {
      W[L.w_vs + y] = w0.vs[y];
    }
    for (int u = tid; u < U1; u += nth) {
      ds[sg * U1 + u] = sm[L.p_cv + 2 * S + u];
    }
  }
}

// A hyper-dual chain a pair: a block a (scenario, member) and tile pair I
// <= J of L.Dt directions (K10's cut, tile_pair), its warps taking its
// pairs i <= j (i in I, j in J) in turn, row-major. The block copies the
// member's chain tables and workspace and its directions' rows of ce / ae
// and foreign tangent rows where the layout holds them; each pair's nodes'
// e1 e2 parts are written as one row at Hn[i, j] and at Hn[j, i].
__global__ void __launch_bounds__(kPairWarps * kLanes, 2)
k12_node_pairs(const StageTab t, const NodeLayout L, int D, int npv,
               const double* sp, const double* pv, const double* fd,
               const double* tf, const double* ws, double* Hn) {
  extern __shared__ double sm[];
  K12_STAMP(10);
  const int nTP = L.nT * (L.nT + 1) / 2;
  const int tp = (int)(blockIdx.x % nTP), r = (int)(blockIdx.x / nTP);
  const int g = r % t.G, sc = r / t.G;
  const size_t sg = (size_t)sc * t.G + g;
  const int tid = threadIdx.x, nth = blockDim.x, wid = tid / kLanes;
  const int lane = tid & (kLanes - 1), S = t.S, n = t.n, U1 = t.U1;
  const int Lf = t.Lf;
  const TilePair P = tile_pair(tp, L.nT, L.Dt, D, 0);
  const int nI = P.nI, nd = P.nI + P.nJ;
  auto dir_of = [&](int k) {
    return k < nI ? P.I * L.Dt + k : P.Jt * L.Dt + (k - nI);
  };
  const double* W = ws + sg * L.ws;
  const int *off, *mat, *nbp, *nbq, *ord;
  Member m = node_member(t, g, sg, sp, pv, fd,
                         L.q_tab >= 0 ? sm + L.q_tab : nullptr, sm + L.q_aux,
                         &off, &mat, &nbp, &nbq, &ord);
  // the member's workspace and the block's directions' rows, in shared
  // memory where the layout holds them
  auto stage = [&](int at, const double* src, int len) -> const double* {
    if (at < 0) return src;
    acopy(sm + at, src, len);
    return sm + at;
  };
  double* tape = const_cast<double*>(
      stage(L.q_tape, W + L.w_tape, t.tp_off[(size_t)g * (n + 1) + n]));
  m.gt = stage(L.q_gt, W + L.w_gt, 4 * Lf);
  const double* cumv = stage(L.q_cum, W + L.w_cum, n);
  const bool spreads = P.I * L.Dt < S;     // the tile has spread directions
  const double* cs = stage(spreads ? L.q_cs : -1,
                           t.cum_t + (size_t)g * S * n, S * n);
  // cv, av and the primal chain's sums of V
  const double* cv = stage(L.q_cv, W + L.w_cv, 2 * S + S * (S + 1) / 2);
  double* cea = sm + L.q_ce;                          // [2, nd, S]
  for (int x = tid; x < 2 * nd * S; x += nth) {
    const int h = x / (nd * S), k = (x / S) % nd, s = x % S;
    __pipeline_memcpy_async(cea + x,
                            W + (h ? L.w_ae : L.w_ce) + dir_of(k) * S + s,
                            sizeof(double));
  }
  const bool rows = tf && L.q_tf >= 0;
  if (rows) {
    for (int k = 0; k < nd; ++k) {
      const int d = dir_of(k);
      if (d >= S + npv) {
        acopy(sm + L.q_tf + k * Lf, tf_row(t, tf, sc, D, d, g), Lf);
      }
    }
  }
  acopy_wait();
  K12_STAMP(11);
  const WarpScratch w = carve(sm + L.q_warps + wid * L.wpair, L.npl, 4,
                              t.NBT);
  for (int x = wid; x < P.pairs; x += L.pwarps) {
    int ki, kj;
    if (P.Jt > P.I) {
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
    const int i = dir_of(ki), j = dir_of(kj);
    const double* ri = i < S + npv ? nullptr
                       : rows ? sm + L.q_tf + ki * Lf
                              : tf_row(t, tf, sc, D, i, g);
    const double* rj = j < S + npv ? nullptr
                       : rows ? sm + L.q_tf + kj * Lf
                              : tf_row(t, tf, sc, D, j, g);
    const Chain ch{off, tape, cumv, i < S ? cs + i * n : nullptr,
                   j < S ? cs + j * n : nullptr, mat, nbp, nbq, ord,
                   cv + 2 * S, S, U1};
    const PairFrame fr{cv, cv + S, cea + ki * S, cea + kj * S,
                       cea + (nd + ki) * S, cea + (nd + kj) * S};
    const Dir di = node_dir(i, S, npv, ri), dj = node_dir(j, S, npv, rj);
    K12_STAMP(12);
    warp_points<HDual>(m, ch, di, dj, fr, w);
    K12_STAMP(13);
    chain_solve<HDual>(m, ch, di, dj, fr, w, 0.0);
    double* hij = Hn + ((((size_t)sc * D + i) * D + j) * t.G + g) * U1;
    double* hji = Hn + ((((size_t)sc * D + j) * D + i) * t.G + g) * U1;
    for (int u = lane; u < U1; u += kLanes) {
      const double v = w.nodes[u];
      hij[u] = v;
      hji[u] = v;
    }
    __syncwarp();
    K12_STAMP(17);
  }
}

bool fits(const StageTab* t) {
  return t->S >= 1 && t->S <= kMaxS && t->U1 >= 1 && t->U1 <= kMaxU;
}

// ---- K9 / K11: the calibration legs split at their flows -----------------

constexpr int kLegBlock = 256;  // xccy_stage.LEG_BLOCK: threads a block, and
                                // the flows of a chunk
constexpr int kFlowVals = 28;   // xccy_stage.FLOW_VALS: n, 6 partials, 21
                                // second partials a flow
constexpr int kJvpVals = 7;     // K9's: n and the partials
constexpr int kLegVals = 8;     // a leg's V, V' (2), V'' (3), w, PV

// A query of the legs (xccy_stage.leg_query): its DF, its first partials
// in its one or two taps, its second partials (h00, h01, h11); a knot's
// second tap and second partials are 0.
struct QD { double d, d0, d1, h0, h1, h2; };

// Slot pair (a, b), a <= b, of a flow's six slots (xccy_stage.SLOT_PAIRS).
__host__ __device__ constexpr int spair(int a, int b) {
  return a * (11 - a) / 2 + b;
}

// One (scenario, member) as a K9 / K11 block reads its legs: the domestic
// grid in device memory and its transforms in shared memory where the
// layout holds them, else computed at each read.
struct LegView {
  int sch, Ld;
  const double *dd, *xs;  // [Ld]
  const double* gt;       // [4, Ld] d, y, y', y'' or null
  __device__ __forceinline__ double d(int l) const {
    return gt ? gt[l] : dd[l];
  }
  __device__ __forceinline__ GPt pt(int l) const {
    if (gt) return {gt[l], gt[Ld + l], gt[2 * Ld + l], gt[3 * Ld + l]};
    return transform(sch, dd[l], xs[l]);
  }
};

// interpolation.simple_df_static at one packed query of the domestic grid
// with its partials in the grid: the knot select (dD/dd = 1, no second
// order), else D = v(z), z = (1 - c) y0 + c y1 of the bracketing entries'
// transforms, through FLAT_FWD's / LINEAR_ZERO's exp (interp's arithmetic).
__device__ __forceinline__ QD leg_query(const LegView& v, const int* qi,
                                        const double* qf) {
  if (qi[2] >= 0) return {v.d(qi[2]), 1.0, 0.0, 0.0, 0.0, 0.0};
  const double c = qf[0];
  const GPt p0 = v.pt(qi[0]), p1 = v.pt(qi[1]);
  const double z = p0.y + c * (p1.y - p0.y);
  double d, f1, f2;
  if (v.sch == kLinFwd) {
    d = z;
    f1 = 1.0;
    f2 = 0.0;
  } else if (v.sch == kFlatFwd) {
    d = exp(-z);
    f1 = -d;
    f2 = d;
  } else {
    const double qt = qf[1];
    d = exp(-z * qt);
    f1 = -qt * d;
    f2 = qt * (qt * d);
  }
  const double u0 = (1.0 - c) * p0.y1, u1 = c * p1.y1;
  return {d, f1 * u0, f1 * u1, f2 * (u0 * u0) + f1 * ((1.0 - c) * p0.y2),
          f2 * (u0 * u1), f2 * (u1 * u1) + f1 * (c * p1.y2)};
}

// Flow p of leg s (p < P a coupon, P + e exchange e) into its column of
// the chunk's table (col[k kLegBlock], xccy_stage.leg_flow): n = sign cf
// D_pay (sign amt D_ex), its partials in its six slots (A: the index
// start's taps, B: the index end's, C: the payment's or exchange's) and,
// K11, w times its second partials in them. pv_float_leg's branches as
// the plain version takes them: a coupon paid at or before the value
// time and an exchange before it are 0; the first-fixing override on
// flow 0 and an ia = 0 slot (the double-where) fix the rate and read no
// index DF; the cap / floor clamp fixes the rate strictly beyond it, the
// floor first, then the cap, as torch.clamp's min(max(rate, floor), cap)
// (its derivative passes at the cap and the floor); the principal rides
// on the last coupon. With f = n: dn/dA = sign C K / B,
// dn/dB = -dn/dA A / B, dn/dC = sign cf, K = pa notl / ia where the rate
// follows the forward (else 0), and the cross and B-B second partials
// from these.
template <bool kHess>
__device__ __forceinline__ void leg_flow(const StageTab& t, const LegView& v,
                                         int g, int s, int p, double w,
                                         double* col) {
  const int P = t.P;
  const size_t gl = (size_t)g * t.S + s;
  const double* ls = t.leg_s + gl * 9;
  const double principal = ls[0], sign = ls[1], vt = ls[2], ffr = ls[3],
               nx = ls[4], eff = ls[5], matt = ls[6], cap = ls[7],
               flo = ls[8];
  const int* id = t.ld_i + gl * t.Pd * 3;
  const double* fdd = t.ld_f + gl * t.Pd * 2;
  QD A{0.0, 0.0, 0.0, 0.0, 0.0, 0.0}, B{1.0, 0.0, 0.0, 0.0, 0.0, 0.0},
      C{0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  double n = 0.0, nA = 0.0, nB = 0.0, nC = 0.0, kc = 0.0, iB = 0.0,
         r = 0.0;
  if (p >= P) {
    const int e = p - P;
    const double ext = e ? matt : eff, amt = e ? nx : -nx;
    if ((t.flags & kExchange) && ext >= vt) {
      C = leg_query(v, id + 3 * (P + 1 + e), fdd + 2 * (P + 1 + e));
      nC = sign * amt;
      n = nC * C.d;
    }
  } else {
    const double* lf = t.leg_f + (gl * P + p) * 5;
    const double payt = lf[0], pa = lf[1], ia = lf[2], spr = lf[3],
                 notl = lf[4];
    if (payt > vt) {
      C = leg_query(v, id + 3 * p, fdd + 2 * p);
      double K = 0.0, fwd;
      if ((t.flags & kOverride) && p == 0) {
        fwd = ffr;
      } else if (ia > 0) {
        const int* ii = t.li_i + gl * 2 * P * 3;
        const double* fi = t.li_f + gl * 2 * P * 2;
        A = leg_query(v, ii + 3 * p, fi + 2 * p);
        B = leg_query(v, ii + 3 * (P + p), fi + 2 * (P + p));
        fwd = (A.d / B.d - 1.0) / ia;
        K = (pa * notl) / ia;
      } else {
        fwd = 0.0;
      }
      double rate = fwd + spr;
      if (t.flags & kCapFloor) {
        if (rate < flo) {
          rate = flo;
          K = 0.0;
        }
        if (rate > cap) {
          rate = cap;
          K = 0.0;
        }
      }
      const double cf = (rate * pa) * notl + (p == P - 1 ? principal : 0.0);
      nC = sign * cf;
      n = nC * C.d;
      if (K != 0.0) {
        iB = 1.0 / B.d;
        r = A.d * iB;
        kc = sign * K;
        nA = (kc * C.d) * iB;
        nB = -nA * r;
      }
    }
  }
  col[0] = n;
  col[1 * kLegBlock] = nA * A.d0;
  col[2 * kLegBlock] = nA * A.d1;
  col[3 * kLegBlock] = nB * B.d0;
  col[4 * kLegBlock] = nB * B.d1;
  col[5 * kLegBlock] = nC * C.d0;
  col[6 * kLegBlock] = nC * C.d1;
  if (!kHess) return;
  const double wA = w * nA, wB = w * nB, wC = w * nC;
  const double fAB = -wA * iB, fBB = -2.0 * (wB * iB);
  const double fAC = (w * kc) * iB, fBC = -fAC * r;
  double* h = col + 7 * kLegBlock;
  h[spair(0, 0) * kLegBlock] = wA * A.h0;
  h[spair(0, 1) * kLegBlock] = wA * A.h1;
  h[spair(1, 1) * kLegBlock] = wA * A.h2;
  h[spair(2, 2) * kLegBlock] = wB * B.h0 + fBB * (B.d0 * B.d0);
  h[spair(2, 3) * kLegBlock] = wB * B.h1 + fBB * (B.d0 * B.d1);
  h[spair(3, 3) * kLegBlock] = wB * B.h2 + fBB * (B.d1 * B.d1);
  h[spair(4, 4) * kLegBlock] = wC * C.h0;
  h[spair(4, 5) * kLegBlock] = wC * C.h1;
  h[spair(5, 5) * kLegBlock] = wC * C.h2;
  h[spair(0, 2) * kLegBlock] = fAB * (A.d0 * B.d0);
  h[spair(0, 3) * kLegBlock] = fAB * (A.d0 * B.d1);
  h[spair(1, 2) * kLegBlock] = fAB * (A.d1 * B.d0);
  h[spair(1, 3) * kLegBlock] = fAB * (A.d1 * B.d1);
  h[spair(0, 4) * kLegBlock] = fAC * (A.d0 * C.d0);
  h[spair(0, 5) * kLegBlock] = fAC * (A.d0 * C.d1);
  h[spair(1, 4) * kLegBlock] = fAC * (A.d1 * C.d0);
  h[spair(1, 5) * kLegBlock] = fAC * (A.d1 * C.d1);
  h[spair(2, 4) * kLegBlock] = fBC * (B.d0 * C.d0);
  h[spair(2, 5) * kLegBlock] = fBC * (B.d0 * C.d1);
  h[spair(3, 4) * kLegBlock] = fBC * (B.d1 * C.d0);
  h[spair(3, 5) * kLegBlock] = fBC * (B.d1 * C.d1);
}

// Where a K9 / K11 block keeps its tables in dynamic shared memory, as
// offsets in doubles (-1: not there; the tangent rows are then read from
// device memory, the grid's transforms computed at each read). Planned on
// the host by plan_legs from the stage's own sizes.
struct LegLayout {
  int lv, lvi, acc, part, tc, vals, gb, U, T, gt;
  int Jt, bytes;            // K11's directions a tile of U; the block's bytes
};

// Member g's lists (xccy_stage._legs_lists) at their rows.
struct LegLists {
  const int *lr_row, *lr_of, *ls_ptr, *ls_row, *lt_leg, *gd_ptr, *gd_t,
      *me_rc, *mr_ptr, *mr_e, *lt_term, *sg, *sc_ptr, *ts_ptr, *ts_seg;
};

__device__ __forceinline__ LegLists leg_lists(const StageTab& t, int g) {
  const size_t G = g;
  return {t.lr_row + G * t.R,      t.lr_of + G * t.Ld,
          t.ls_ptr + G * (t.S + 1), t.ls_row + G * t.NL,
          t.lt_leg + G * t.NL,     t.gd_ptr + G * (t.R + 1),
          t.gd_t + G * t.NGD,      t.me_rc + G * t.EL * 2,
          t.mr_ptr + G * (t.R + 1), t.mr_e + G * t.NMR,
          t.lt_term + G * t.NTT,   t.sg + G * t.NS * 2,
          t.sc_ptr + G * (2 * t.nC + 1),
          t.ts_ptr + G * (t.S + t.NL + t.EL + 1), t.ts_seg + G * t.NS};
}

// Tangent row d at row r: the block's copy where the layout holds it, else
// device memory (a pad row reads 0).
struct Tangents {
  const double* sm;        // [Qd, R] or null
  const double* row0;      // tdl at (scenario, direction 0, member)
  size_t dstride;          // G Ld
  const int* lr_row;
  int R;
  __device__ __forceinline__ double at(int d, int r) const {
    if (sm) return sm[d * R + r];
    const int x = lr_row[r];
    return x < 0 ? 0.0 : row0[d * dstride + x];
  }
};

// K9 / K11's work of a (scenario, member) that no direction or pair
// depends on (xccy_stage.legs_prologue): the grid's transforms; each leg's
// value DF and, K11, w = gpv / V; chunk by chunk, a thread a flow into the
// chunk's table (leg_flow), then a thread a segment summing its terms in
// table order (K9: the sums' and gradients' segments alone); then a thread
// a target adding its segments in order: N_s, dN_s/dd at each of the
// leg's rows and, K11, M_N's entries; PV_s = N_s / V_s; and each gradient
// target's G_s[r] = (dN_s/dd_r - PV_s dV_s/dd_r) / V_s, in place. No
// atomics: two launches agree bit for bit.
template <bool kHess>
__device__ __forceinline__ void legs_prologue(const StageTab& t,
                                              const LegLayout& L, double* sm,
                                              const LegView& v,
                                              const LegLists& ll, int g,
                                              const double* gpv) {
  const int tid = threadIdx.x, S = t.S, P = t.P, F = P + 2;
  double* lv = sm + L.lv;
  int* lvi = reinterpret_cast<int*>(sm + L.lvi);
  double* acc = sm + L.acc;
  double* part = sm + L.part;
  for (int s = tid; s < S; s += kLegBlock) {
    const size_t gl = (size_t)g * S + s;
    const int* qi = t.ld_i + (gl * t.Pd + P) * 3;
    const QD V = leg_query(v, qi, t.ld_f + (gl * t.Pd + P) * 2);
    double* o = lv + s * kLegVals;
    o[0] = V.d;
    o[1] = V.d0;
    o[2] = V.d1;
    o[3] = V.h0;
    o[4] = V.h1;
    o[5] = V.h2;
    o[6] = kHess ? gpv[s] / V.d : 0.0;
    lvi[2 * s] = ll.lr_of[qi[2] >= 0 ? qi[2] : qi[0]];
    lvi[2 * s + 1] = qi[2] >= 0 ? -1 : ll.lr_of[qi[1]];
  }
  __syncthreads();
  XCCY_STAMP(1);
  for (int c = 0; c < t.nC; ++c) {
    const int f = c * kLegBlock + tid;
    if (f < S * F) {
      const int s = f / F;
      leg_flow<kHess>(t, v, g, s, f - s * F, lv[s * kLegVals + 6],
                      sm + L.vals + tid);
    }
    __syncthreads();
    const int k1 = ll.sc_ptr[2 * c + (kHess ? 2 : 1)];
    const double* vals = sm + L.vals;
    for (int k = ll.sc_ptr[2 * c] + tid; k < k1; k += kLegBlock) {
      double a = 0.0;
#pragma unroll 4
      for (int x = ll.sg[2 * k]; x < ll.sg[2 * k + 1]; ++x) {
        const int term = ll.lt_term[x];
        const double val = vals[term >> 1];
        a = a + ((term & 1) ? 2.0 * val : val);
      }
      part[k] = a;
    }
    __syncthreads();
  }
  XCCY_STAMP(2);
  const int nt = S + t.NL + (kHess ? t.EL : 0);
  for (int x = tid; x < nt; x += kLegBlock) {
    double a = 0.0;
    for (int k = ll.ts_ptr[x]; k < ll.ts_ptr[x + 1]; ++k) {
      a = a + part[ll.ts_seg[k]];
    }
    acc[x] = a;
  }
  __syncthreads();
  for (int s = tid; s < S; s += kLegBlock) {
    lv[s * kLegVals + 7] = acc[s] / lv[s * kLegVals];
  }
  __syncthreads();
  for (int x = tid; x < ll.ls_ptr[S]; x += kLegBlock) {
    const int s = ll.lt_leg[x], r = ll.ls_row[x];
    const double* o = lv + s * kLegVals;
    double dv = 0.0;
    if (lvi[2 * s] == r) dv = dv + o[1];
    if (lvi[2 * s + 1] == r) dv = dv + o[2];
    acc[S + x] = (acc[S + x] - o[7] * dv) / o[0];
  }
  __syncthreads();
}

// The block's start: its view of the grid (transformed into shared memory
// where the layout holds it) and its copy of the tangent rows [Qd, R]
// where the layout holds them (the caller synchronises).
__device__ __forceinline__ LegView leg_start(const StageTab& t,
                                             const LegLayout& L, double* sm,
                                             const LegLists& ll, int g,
                                             size_t sg, int sc, int Qd,
                                             const double* dd,
                                             const double* tdl, Tangents* T) {
  const int tid = threadIdx.x, Ld = t.Ld, R = t.R;
  LegView v{t.dsch, Ld, dd + sg * Ld, t.d_xs + (size_t)g * Ld, nullptr};
  if (L.gt >= 0) {
    double* gt = sm + L.gt;
    for (int l = tid; l < Ld; l += kLegBlock) {
      const GPt p = transform(t.dsch, v.dd[l], v.xs[l]);
      gt[l] = p.d;
      gt[Ld + l] = p.y;
      gt[2 * Ld + l] = p.y1;
      gt[3 * Ld + l] = p.y2;
    }
    v.gt = gt;
  }
  const double* row0 = tdl ? tdl + ((size_t)sc * Qd * t.G + g) * Ld
                           : nullptr;
  *T = Tangents{nullptr, row0, (size_t)t.G * Ld, ll.lr_row, R};
  if (L.T >= 0 && tdl) {
    double* ts = sm + L.T;
    for (int x = tid; x < Qd * R; x += kLegBlock) {
      const int d = x / R, r = x - d * R;
      ts[x] = T->at(d, r);
    }
    T->sm = ts;
  }
  return v;
}

__global__ void __launch_bounds__(kLegBlock, 2)
k9_legs_jvp(const StageTab t, const LegLayout L, int Qd, const double* dd,
            const double* tdl, double* pv0, double* jpv) {
  extern __shared__ double sm[];
  const int g = (int)(blockIdx.x % t.G), sc = (int)(blockIdx.x / t.G);
  const size_t sg = (size_t)sc * t.G + g;
  const int tid = threadIdx.x, S = t.S;
  XCCY_STAMP(0);
  const LegLists ll = leg_lists(t, g);
  Tangents T;
  const LegView v = leg_start(t, L, sm, ll, g, sg, sc, Qd, dd, tdl, &T);
  __syncthreads();
  legs_prologue<false>(t, L, sm, v, ll, g, nullptr);
  XCCY_STAMP(3);
  const double* lv = sm + L.lv;
  const double* G = sm + L.acc + S;
  for (int s = tid; s < S; s += kLegBlock) {
    pv0[sg * S + s] = lv[s * kLegVals + 7];
  }
  // Jpv[d, s] = G_s . t_d over the leg's rows, a thread a (d, s), the
  // stores coalesced over s
  for (int x = tid; x < Qd * S; x += kLegBlock) {
    const int d = x / S, s = x - d * S;
    double a = 0.0;
    for (int k = ll.ls_ptr[s]; k < ll.ls_ptr[s + 1]; ++k) {
      a = a + G[k] * T.at(d, ll.ls_row[k]);
    }
    jpv[(((size_t)sc * Qd + d) * t.G + g) * S + s] = a;
  }
  XCCY_STAMP_END();
}

// K11: the prologue with M_N, then gdd, then by tiles of Jt directions j:
// (gamma, beta) a (j, leg), U_j = M t_j at each row (M_N's entries of
// the row, then the value DFs' coupling folded in, xccy_stage.legs_u),
// and each pair i <= j's t_i . U_j, written at [i, j] and [j, i].
__global__ void __launch_bounds__(kLegBlock, 2)
k11_legs_hess(const StageTab t, const LegLayout L, int Qd, const double* dd,
              const double* tdl, const double* gpv, double* gdd,
              double* Hl) {
  extern __shared__ double sm[];
  const int g = (int)(blockIdx.x % t.G), sc = (int)(blockIdx.x / t.G);
  const size_t sg = (size_t)sc * t.G + g;
  const int tid = threadIdx.x, S = t.S, R = t.R, Ld = t.Ld;
  XCCY_STAMP(0);
  const LegLists ll = leg_lists(t, g);
  Tangents T;
  const LegView v = leg_start(t, L, sm, ll, g, sg, sc, Qd, dd, tdl, &T);
  const double* gp = gpv + sg * S;
  __syncthreads();
  legs_prologue<true>(t, L, sm, v, ll, g, gp);
  const double* lv = sm + L.lv;
  const int* lvi = reinterpret_cast<const int*>(sm + L.lvi);
  const double* G = sm + L.acc + S;
  const double* M = G + t.NL;
  for (int l = tid; l < Ld; l += kLegBlock) {
    const int r = ll.lr_of[l];
    double a = 0.0;
    if (r >= 0) {
      for (int k = ll.gd_ptr[r]; k < ll.gd_ptr[r + 1]; ++k) {
        const int x = ll.gd_t[k];
        a = a + gp[ll.lt_leg[x]] * G[x];
      }
    }
    gdd[sg * Ld + l] = a;
  }
  // each gradient target's coefficients in U (xccy_stage.legs_prologue's
  // "tc"): w G_s[r] of beta and, at a value DF tap, w dV_s/dd_r of gamma
  // and w PV_s d2V_s/dd_r dd_v of the tangent at each tap v
  double* tc = sm + L.tc;
  int* tv = reinterpret_cast<int*>(tc + 4 * t.NL);
  for (int x = tid; x < ll.ls_ptr[S]; x += kLegBlock) {
    const int s = ll.lt_leg[x], r = ll.ls_row[x];
    const double* o = lv + s * kLegVals;
    const bool a0 = lvi[2 * s] == r, a1 = lvi[2 * s + 1] == r;
    const double w = o[6], wp = w * o[7];
    tc[4 * x] = w * G[x];
    tc[4 * x + 1] = w * ((a0 ? o[1] : 0.0) + (a1 ? o[2] : 0.0));
    tc[4 * x + 2] = wp * ((a0 ? o[3] : 0.0) + (a1 ? o[4] : 0.0));
    tc[4 * x + 3] = wp * ((a0 ? o[4] : 0.0) + (a1 ? o[5] : 0.0));
    tv[x] = a0 || a1;
  }
  XCCY_STAMP(3);
  double* gb = sm + L.gb;
  double* U = sm + L.U;
  for (int j0 = 0; j0 < Qd; j0 += L.Jt) {
    const int nj = min(L.Jt, Qd - j0);
    for (int x = tid; x < nj * S; x += kLegBlock) {
      const int jj = x / S, s = x - jj * S, j = j0 + jj;
      double a = 0.0;
      for (int k = ll.ls_ptr[s]; k < ll.ls_ptr[s + 1]; ++k) {
        a = a + G[k] * T.at(j, ll.ls_row[k]);
      }
      const double* o = lv + s * kLegVals;
      double b = o[1] * T.at(j, lvi[2 * s]);
      if (lvi[2 * s + 1] >= 0) b = b + o[2] * T.at(j, lvi[2 * s + 1]);
      gb[jj * 2 * S + s] = a;
      gb[jj * 2 * S + S + s] = b;
    }
    __syncthreads();
    for (int x = tid; x < nj * R; x += kLegBlock) {
      const int jj = x / R, r = x - jj * R, j = j0 + jj;
      double a = 0.0;
      if (ll.lr_row[r] >= 0) {
        for (int k = ll.mr_ptr[r]; k < ll.mr_ptr[r + 1]; ++k) {
          const int e = ll.mr_e[k];
          const int p = ll.me_rc[2 * e], q = ll.me_rc[2 * e + 1];
          a = a + M[e] * T.at(j, p == r ? q : p);
        }
        for (int k = ll.gd_ptr[r]; k < ll.gd_ptr[r + 1]; ++k) {
          const int xt = ll.gd_t[k], s = ll.lt_leg[xt];
          const double* c = tc + 4 * xt;
          double y = c[0] * gb[jj * 2 * S + S + s];
          if (tv[xt]) {
            const int v0 = lvi[2 * s], v1 = lvi[2 * s + 1];
            y = y + c[1] * gb[jj * 2 * S + s] + c[2] * T.at(j, v0)
                + c[3] * (v1 >= 0 ? T.at(j, v1) : 0.0);
          }
          a = a - y;
        }
      }
      U[jj * R + r] = a;
    }
    __syncthreads();
    // the pairs i <= j of the tile's columns, in column order
    const long long b0 = (long long)j0 * (j0 + 1) / 2;
    const long long b1 = (long long)(j0 + nj) * (j0 + nj + 1) / 2;
    for (long long X = b0 + tid; X < b1; X += kLegBlock) {
      int j = (int)((sqrt(8.0 * (double)X + 1.0) - 1.0) * 0.5);
      while ((long long)(j + 1) * (j + 2) / 2 <= X) ++j;
      while ((long long)j * (j + 1) / 2 > X) --j;
      const int i = (int)(X - (long long)j * (j + 1) / 2);
      const double* u = U + (j - j0) * R;
      double a = 0.0;
#pragma unroll 4
      for (int r = 0; r < R; ++r) a = a + T.at(i, r) * u[r];
      Hl[(((size_t)sc * Qd + i) * t.G + g) * Qd + j] = a;
      Hl[(((size_t)sc * Qd + j) * t.G + g) * Qd + i] = a;
    }
    __syncthreads();
  }
  XCCY_STAMP_END();
}

// K9 / K11's layout of a block's tables for a stage with Qd domestic
// directions: the core (the legs' values, the targets' sums, the
// segments' partial sums, K11's targets' coefficients in U, the chunk's
// flow table or, after it, K11's
// (gamma, beta) and U of a tile of Jt directions) always, the tiles
// halving until the core fits; then, where they fit, the tangent rows
// [Qd, R] and the grid's transforms. First within the
// shared memory that lets two blocks share an SM, else within a block's
// most.
bool plan_legs(const StageTab* t, int Qd, bool hess, LegLayout* out) {
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
  long long soft = (ssm / 2 - res) / (long long)sizeof(double);
  if (soft > hard) soft = hard;
  const int S = t->S, R = t->R;
  for (int pass = 0; pass < 2; ++pass) {
    const long long cap = pass ? hard : soft;
    for (int Jt = Qd > 1 ? Qd : 1;; Jt = (Jt + 1) / 2) {
      LegLayout L;
      long long off = 0;
      auto take = [&off](long long k) {
        const int o = (int)off;
        off += k;
        return o;
      };
      L.Jt = Jt;
      L.lv = take((long long)kLegVals * S);
      L.lvi = take(S);
      L.acc = take(S + t->NL + (hess ? t->EL : 0));
      L.part = take(t->NS);
      L.tc = hess ? take(4LL * t->NL + (t->NL + 1) / 2) : -1;
      const long long vals = (long long)(hess ? kFlowVals : kJvpVals)
                             * kLegBlock;
      const long long post = hess ? (long long)Jt * (2LL * S + R) : 0;
      L.vals = take(vals > post ? vals : post);
      L.gb = hess ? L.vals : -1;
      L.U = hess ? L.vals + Jt * 2 * S : -1;
      if (off <= cap) {
        auto room = [&off, cap](long long k) { return off + k <= cap; };
        L.T = Qd > 0 && room((long long)Qd * R) ? take((long long)Qd * R)
                                                : -1;
        L.gt = room(4LL * t->Ld) ? take(4LL * t->Ld) : -1;
        L.bytes = (int)(off * (long long)sizeof(double));
        *out = L;
        return true;
      }
      if (Jt == 1) break;
    }
  }
  return false;
}

bool fits_legs(const StageTab* t) {
  return fits(t) && t->R >= 1;
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

// K12's layout (NodeLayout) for a stage of D directions at Sc scenarios
// (rows: foreign tangent rows given): the member's workspace in device
// memory (the tape, the grid's transforms, cum, the primal C and acc, the
// primal chain's buckets' sums of V and the directions' first tangents ce
// / ae); the pair launch's tile of directions, the largest of 8, 4, 2, 1 that
// gives every SM a block (else 1); a warp's scratch in each launch
// (node_scratch); what each launch holds in shared memory: the prologue
// the tape, cum, its tangents, the primal tables, the grid's transforms
// and its warps' scratch, then, where they fit, the chain tables; the
// pair launch its warps' scratch and its directions' rows of ce / ae,
// then, where they fit, the chain tables, the tape, cum, its tangents, the
// grid's transforms and its directions' foreign tangent rows. A block's
// warps halve (the pair launch's from kPairWarps, the prologue's from
// kNodeWarps) until a pair block fits two to an SM, then until it fits a
// block's most; false where one warp's does not.
bool node_plan(const StageTab* t, int D, int Sc, bool rows,
               NodeLayout* out) {
  int dev = 0, smax = 0, ssm = 0, res = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&smax, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&ssm,
                             cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                             dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&res, cudaDevAttrReservedSharedMemoryPerBlock,
                             dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
          != cudaSuccess) {
    return false;
  }
  const long long hard = smax / (long long)sizeof(double);
  long long soft = (ssm / 2 - res) / (long long)sizeof(double);
  if (soft > hard) soft = hard;
  const int n = t->n, S = t->S, U1 = t->U1, Lf = t->Lf;
  NodeLayout L;
  L.npl = (n + kLanes - 1) / kLanes;
  L.wpro = node_scratch(L.npl, 2, t->NBT);
  L.wpair = node_scratch(L.npl, 4, t->NBT);
  L.Dt = 1;
  for (int dt = 8; dt > 1; dt /= 2) {
    const long long nT = (D + dt - 1) / dt;
    if ((long long)Sc * t->G * (nT * (nT + 1) / 2) >= sms) {
      L.Dt = dt;
      break;
    }
  }
  L.nT = (D + L.Dt - 1) / L.Dt;
  long long off = 0;
  auto take = [&off](long long k) {
    const int o = (int)off;
    off += k;
    return o;
  };
  L.w_tape = take(8LL * n);
  L.w_gt = take(4LL * Lf);
  L.w_cum = take(n);
  L.w_cv = take(S);
  L.w_av = take(S);
  L.w_vs = take((long long)S * (S + 1) / 2);
  L.w_ce = take((long long)D * S);
  L.w_ae = take((long long)D * S);
  L.ws = (int)off;
  const long long tab = node_tab(*t);
  for (int pass = 0; pass < 2; ++pass) {
    const long long cap = pass ? hard : soft;
    for (int wp = kPairWarps; wp >= 1; wp /= 2) {
      L.pwarps = wp;
      L.warps = wp < kNodeWarps ? wp : kNodeWarps;
      off = 0;
      L.p_aux = take(3LL * S);
      L.p_tape = take(8LL * n);
      L.p_cum = take(n);
      L.p_cs = take((long long)S * n);
      L.p_cv = take(2LL * S + U1);
      L.p_gt = take(4LL * Lf);
      L.p_warps = take((long long)(L.warps + 1) * L.wpro);
      if (off > hard) continue;
      L.p_tab = off + tab <= hard ? take(tab) : -1;
      L.pro_bytes = (int)(off * (long long)sizeof(double));
      off = 0;
      L.q_aux = take(3LL * S);
      L.q_cv = take(2LL * S + S * (S + 1) / 2);
      L.q_ce = take(4LL * L.Dt * S);
      L.q_warps = take((long long)wp * L.wpair);
      if (off > cap) continue;
      auto opt = [&](long long k) { return off + k <= cap ? take(k) : -1; };
      L.q_tab = opt(tab);
      L.q_tape = opt(8LL * n);
      L.q_cum = opt(n);
      L.q_cs = opt((long long)S * n);
      L.q_gt = opt(4LL * Lf);
      L.q_tf = rows ? opt(2LL * L.Dt * Lf) : -1;
      L.pair_bytes = (int)(off * (long long)sizeof(double));
      *out = L;
      return true;
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
// [Sc, Qd, G, Ld]. A block a (scenario, member).
extern "C" int xccy_legs_jvp_f64(const XccyStageTab* t, int Sc, int Qd,
                                 const double* dd, const double* tdl,
                                 double* pv0, double* jpv,
                                 cudaStream_t stream) {
  if (!fits_legs(t) || Qd < 0) return (int)cudaErrorInvalidValue;
  if ((long long)Sc * t->G * Qd == 0) return 0;
  LegLayout L;
  if (!plan_legs(t, Qd, false, &L)) return (int)cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(k9_legs_jvp, L.bytes);
  if (err != cudaSuccess) return (int)err;
  k9_legs_jvp<<<(unsigned)((long long)Sc * t->G), kLegBlock, L.bytes,
                stream>>>(*t, L, Qd, dd, tdl, pv0, jpv);
  return (int)cudaGetLastError();
}

// K10: gZ [Sc, G, D], gf [Sc, G, Lf] (n_gf = Lf; 0 writes none), H
// [Sc, D, G, D] from sp, pv, fd, tf as K8's and gs [Sc, G, W]; each pair
// i <= j once, in the order the kernel's tile pairs enumerate them. A
// block a (scenario, member, tile pair), then, recalibrated, a block a
// (scenario, member, kBlock grid entries).
extern "C" int xccy_stage_hess_f64(const XccyStageTab* t, int Sc, int D,
                                   int npv, int n_gf,
                                   const double* sp, const double* pv,
                                   const double* fd, const double* tf,
                                   const double* gs, double* gZ, double* gf,
                                   double* H, cudaStream_t stream) {
  if (!fits(t) || D < 1 || (n_gf != 0 && n_gf != t->Lf)) {
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

// K12: ds [Sc, G, U1], Jn [Sc, D, G, U1], Jfd [Sc, Lf, G, U1] (n_gf =
// Lf; 0 writes none) and Hn [Sc, D, D, G, U1] from sp, pv, fd, tf as
// K10's, through the workspace ws [Sc, G, ws_len] (ws_len doubles a
// (scenario, member): node_plan's, xccy_stage.node_workspace). Two
// launches: the prologue, a block a (scenario, member) and a few of its
// items (its directions, then its foreign grid entries), then a warp a pair
// i <= j, each pair once.
extern "C" int xccy_stage_node_hess_f64(const XccyStageTab* t, int Sc, int D,
                                        int npv, int n_gf, const double* sp,
                                        const double* pv, const double* fd,
                                        const double* tf, double* ds,
                                        double* jn, double* jfd, double* hn,
                                        double* ws, int ws_len,
                                        cudaStream_t stream) {
  if (!fits(t) || D < 1 || (n_gf != 0 && n_gf != t->Lf)) {
    return (int)cudaErrorInvalidValue;
  }
  if ((long long)Sc * t->G == 0) return 0;
  NodeLayout L;
  if (!node_plan(t, D, Sc, tf != nullptr, &L) || ws_len != L.ws) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = allow_smem(k12_node_prologue, L.pro_bytes);
  if (err == cudaSuccess) err = allow_smem(k12_node_pairs, L.pair_bytes);
  if (err != cudaSuccess) return (int)err;
  const int per = (D + n_gf + L.warps - 1) / L.warps;
  k12_node_prologue<<<(unsigned)((long long)Sc * t->G * per),
                      (L.warps + 1) * kLanes, L.pro_bytes, stream>>>(
      *t, L, D, npv, n_gf, per, sp, pv, fd, tf, ds, jn, jfd, ws);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)Sc * t->G * (L.nT * (L.nT + 1) / 2);
  k12_node_pairs<<<(unsigned)blocks, L.pwarps * kLanes, L.pair_bytes,
                   stream>>>(*t, L, D, npv, sp, pv, fd, tf, ws, hn);
  return (int)cudaGetLastError();
}

// K11: gdd [Sc, G, Ld] (n_gd = Ld), Hl [Sc, Qd, G, Qd] from dd [Sc, G,
// Ld], tdl [Sc, Qd, G, Ld] and gpv [Sc, G, S]; each pair i <= j once, in
// the kernel's own order. A block a (scenario, member).
extern "C" int xccy_legs_hess_f64(const XccyStageTab* t, int Sc, int Qd,
                                  int n_gd, const double* dd,
                                  const double* tdl, const double* gpv,
                                  double* gdd, double* Hl,
                                  cudaStream_t stream) {
  if (!fits_legs(t) || Qd < 0 || n_gd != t->Ld) {
    return (int)cudaErrorInvalidValue;
  }
  if ((long long)Sc * t->G == 0) return 0;
  LegLayout L;
  if (!plan_legs(t, Qd, true, &L)) return (int)cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(k11_legs_hess, L.bytes);
  if (err != cudaSuccess) return (int)err;
  k11_legs_hess<<<(unsigned)((long long)Sc * t->G), kLegBlock, L.bytes,
                  stream>>>(*t, L, Qd, dd, tdl, gpv, gdd, Hl);
  return (int)cudaGetLastError();
}

namespace {

// What the card's compiler and occupancy calculator say of kernel f at
// smem bytes of dynamic shared memory and threads a block: o[4] =
// {registers, local bytes a thread, smem, blocks an SM}.
template <class Kernel>
cudaError_t kinfo(Kernel f, int smem, int threads, int* o) {
  cudaError_t err = allow_smem(f, smem);
  cudaFuncAttributes a;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, f);
  int nb = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, f, threads,
                                                       (size_t)smem);
  }
  if (err != cudaSuccess) return err;
  o[0] = a.numRegs;
  o[1] = (int)a.localSizeBytes;
  o[2] = smem;
  o[3] = nb;
  return cudaSuccess;
}

}  // namespace

// The registers and local memory a thread of kernel `which` (8-12) takes,
// and, at this stage with D directions (K9 / K11: Qd; rows: tangent rows
// given), its dynamic shared memory a block, the blocks an SM holds at
// once, its threads a block, its tile (K8 / K10: directions; K11: the
// directions of a tile of U), what its layout holds in shared memory beside
// the core and its blocks a (scenario, member): out[8] = {registers, local
// bytes a thread, shared bytes a block, blocks an SM, threads a block,
// tile, held: 1 the grid's transforms | 2 the chain tables | 4 the tangent
// rows | 8 K10's tape | 16 K10's lists, blocks a (scenario, member)}. K12's
// two launches: out[0, 1] the most registers and local bytes of the two,
// out[2] the pair launch's shared bytes, out[3] the fewer blocks an SM,
// out[4] the threads of a pair block, out[5] the pair launch's tile of
// directions, out[6] what the prologue holds beside its core (1 the
// grid's transforms | 2 the chain tables | 8 the tape), out[7] the
// prologue's blocks a (scenario, member); then out[8..11] = {registers,
// local bytes, shared bytes, blocks an SM} of the prologue, out[12..15] the
// same of the pair launch, out[16] the pair launch's blocks at one
// scenario, out[17] a pair block's warps and out[18] a prologue block's
// (its primal warp and its item warps; out has 19 entries).
extern "C" int xccy_kernel_info(const XccyStageTab* t, int D, int which,
                                int rows, int* out) {
  if (which == 12) {
    NodeLayout L;
    if (!fits(t) || D < 1 || !node_plan(t, D, 1, rows != 0, &L)) {
      return (int)cudaErrorInvalidValue;
    }
    const int threads = L.pwarps * kLanes;
    cudaError_t err = kinfo(k12_node_prologue, L.pro_bytes,
                            (L.warps + 1) * kLanes, out + 8);
    if (err == cudaSuccess) {
      err = kinfo(k12_node_pairs, L.pair_bytes, threads, out + 12);
    }
    if (err != cudaSuccess) return (int)err;
    out[0] = max(out[8], out[12]);
    out[1] = max(out[9], out[13]);
    out[2] = L.pair_bytes;
    out[3] = min(out[11], out[15]);
    out[4] = threads;
    out[5] = L.Dt;
    out[6] = 1 | (L.p_tab >= 0) << 1 | 8;
    out[7] = (D + (rows ? t->Lf : 0) + L.warps - 1) / L.warps;
    out[16] = t->G * (L.nT * (L.nT + 1) / 2);
    out[17] = L.pwarps;
    out[18] = L.warps + 1;
    return 0;
  }
  int threads = kBlock, tile = 0, held = 0, per = 0;
  cudaError_t err = cudaErrorInvalidValue;
  if (which == 8 || which == 10) {
    Layout L;
    if (!fits(t) || D < 1
        || !plan_layout(t, D, rows ? t->S : 0, which != 8, rows != 0, &L)) {
      return (int)cudaErrorInvalidValue;
    }
    err = which == 8 ? kinfo(k8_stage_jvp, L.bytes, threads, out)
                     : kinfo(k10_stage_hess, L.bytes, threads, out);
    tile = L.Dt;
    held = (L.gt >= 0) | (L.ptf >= 0) << 1 | (L.tt >= 0) << 2
           | (L.tape >= 0) << 3 | (L.lists >= 0) << 4;
    per = which == 8 ? L.nT : hess_blocks(L.nT, L.Dt, D, rows ? t->Lf : 0);
  } else if (which == 9 || which == 11) {
    LegLayout L;
    if (!fits_legs(t) || D < 0 || !plan_legs(t, D, which == 11, &L)) {
      return (int)cudaErrorInvalidValue;
    }
    threads = kLegBlock;
    err = which == 9 ? kinfo(k9_legs_jvp, L.bytes, threads, out)
                     : kinfo(k11_legs_hess, L.bytes, threads, out);
    tile = which == 11 ? L.Jt : 0;
    held = (L.gt >= 0) | (L.T >= 0) << 2;
    per = 1;
  }
  if (err != cudaSuccess) return (int)err;
  out[4] = threads;
  out[5] = tile;
  out[6] = held;
  out[7] = per;
  return 0;
}

#ifdef XCCY_TIMELINE
// The profiling build's K12 stamps (k12_stamp): out[64], the last
// launches' block 0, warp 0's then warp 1's.
extern "C" int k12_timeline(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_k12, sizeof(long long) * 64);
}

// The profiling build's stamps of the last launch's first n blocks:
// out[n, 6] = {start, tables loaded, chains, rows' sums, end, SM}.
extern "C" int xccy_timeline(unsigned long long* out, int n) {
  if (n > kStampBlocks) n = kStampBlocks;
  return (int)cudaMemcpyFromSymbol(out, g_stamps,
                                   sizeof(unsigned long long) * 6 * n);
}
#endif
