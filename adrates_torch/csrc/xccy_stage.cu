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
// One templated device evaluation of the stage, written once over a
// scalar type T: double, Dual (value, one tangent) or HDual (value, e1,
// e2, e1 e2). A thread lifts its inputs along one direction (Dual) or two
// (HDual) and evaluates
//
//   - the foreign DFs at each chain point's start, end and payment
//     through the static simple plan (the exact-knot select, right-side
//     brackets and LINEAR_ZERO's t = 0 remap are in the tables);
//   - the cashflows and the telescoped basis chain base = df_pay
//     exp(cumsum(-sp dt)), in chain order;
//   - the par conditions by forward substitution: pillar k's factor
//     x_k = -(pv_k + fxs (v0_k + acc_k)) / d_k at its maturity point, acc_k
//     the sum of its known payments' cf base C_seg over the factors C
//     solved before them (what the Neumann series of ops/linear_solve.py
//     converges to);
//   - the node DFs (x base at a pillar, C_seg base elsewhere; 1 with no
//     derivative at the t = 0 node and the pad slots), then the stage
//     rows through the member's static simple plan;
//
// and, for the legs, pv_float_leg's arithmetic on the static plans (the
// double-where of an ia = 0 slot, the first-fixing override on flow 0,
// torch.clamp's derivative passing inclusively at the cap and floor,
// strictly future coupons, the notional exchanges). Second derivatives are
// exact, with no hand-derived adjoint.
//
//   K8 xccy_stage_jvp:   a Dual thread a (scenario, member, direction):
//                        the rows' tangent, and (direction 0) the DFs and
//                        rows.
//   K9 xccy_legs_jvp:    a Dual thread a (scenario, member, dom
//                        direction): the legs' PVs' tangents and PVs.
//   K10 xccy_stage_hess: an HDual thread a (scenario, member, pair i <= j)
//                        of s = sum gs . rows: H[i, j] = H[j, i], and
//                        gZ[i] at i = j; then a Dual thread a (scenario,
//                        member, foreign grid entry): gf.
//   K11 xccy_legs_hess:  the same for sum gpv . legs over the dom
//                        directions and grid.
//
// What bounds it on an H100: the f64 arithmetic. At flagship_v5's XCCY
// stage (G = 3, S = 8, 78 chain points, 31 nodes, 490 rows, D = 48
// directions, 50 scenarios a chunk) K10 runs 176,400 pair threads, each
// evaluating the whole stage in HDual, and moves about 8 MB (the foreign
// tangents in, H out): operations bound it, at 34 TFLOP/s of f64 outside
// the tensor cores. The bound
// counts what the function needs (xccy_stage.needed_flops: the primal
// once a (scenario, member), each first tangent once, each pair's e1 e2
// part once); every pair thread here recomputes the primal and the
// first-order parts its neighbours share, and its arrays (the factors,
// the node DFs and their transforms, 5 KB in HDual) live in local
// memory, so the threads do several times the operations the bound
// counts (chip_smoke prints both). This is the simple design, right
// first: the better one keeps the primal and first tangents in shared
// memory, once a (scenario, member) block, so that a pair thread
// computes only its e1 e2 part (ROADMAP B).
//
// No atomics, no allocation, one launch a call on the caller's stream.

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

// ---- the stage -------------------------------------------------------------

// Member g's bootstrap and rows at sp [S], pv [S], fd [Lf] lifted along
// d1 / d2: sink.row(w, value) for every row, sink.node(u, value) for
// every node.
template <class T, class Sink>
__device__ void stage_eval(const StageTab& t, int g, const double* sp,
                           const double* pv, const double* fd, const Dir& d1,
                           const Dir& d2, Sink& sink) {
  const int n = t.n, S = t.S;
  T C[kMaxS + 1], acc[kMaxS], ds[kMaxU], y[kMaxU];
  const double fxs = t.fxs[g];
  const double* pf = t.pt_f + (size_t)g * n * 5;
  const int* pi = t.pt_i + (size_t)g * n * 4;
  const int* fqi = t.fq_i + (size_t)g * 3 * n * 3;
  const double* fqf = t.fq_f + (size_t)g * 3 * n * 2;
  const double* fxg = t.f_xs + (size_t)g * t.Lf;
  C[0] = lift<T>(1.0, 0.0, 0.0);
  for (int k = 0; k < S; ++k) acc[k] = lift<T>(0.0, 0.0, 0.0);
  for (int u = 0; u < t.U1; ++u) ds[u] = lift<T>(1.0, 0.0, 0.0);
  T cum = lift<T>(0.0, 0.0, 0.0);
  int rank = 0;
  for (int i = 0; i < n; ++i) {
    const int k = pi[4 * i], s = pi[4 * i + 1], fl = pi[4 * i + 2],
              node = pi[4 * i + 3];
    const double notl = pf[5 * i], ss = pf[5 * i + 1], ar = pf[5 * i + 2],
                 dt = pf[5 * i + 3], w = pf[5 * i + 4];
    const T spk = lift<T>(sp[k], tan_sp(d1, k), tan_sp(d2, k));
    cum = cum + (-spk) * dt;
    const bool mat = fl & kMat;
    if (!mat && w == 0.0 && node < 0) continue;
    const int qp = 2 * n + i;
    const T base = interp<T>(t.fsch, fqi + 3 * qp, fqf + 2 * qp, fxg, fd, d1,
                             d2) * texp(cum);
    T cf;
    if (fl & kNotl) {
      cf = lift<T>((fl & kLast) ? notl : -notl, 0.0, 0.0) + spk * ss;
    } else {
      const T r = interp<T>(t.fsch, fqi + 3 * i, fqf + 2 * i, fxg, fd, d1, d2)
                  / interp<T>(t.fsch, fqi + 3 * (n + i), fqf + 2 * (n + i),
                              fxg, fd, d1, d2);
      cf = (((r - 1.0) * notl) * ar + ((fl & kLast) ? notl : 0.0)) + spk * ss;
    }
    T val;
    if (mat) {
      const T d = (fxs * cf) * base;
      const T pvk = lift<T>(pv[rank], tan_pv(d1, rank), tan_pv(d2, rank));
      const T x = -(pvk + fxs * (t.v0[g * S + rank] + acc[rank])) / d;
      C[rank + 1] = x;
      val = x * base;
      ++rank;
    } else {
      if (w != 0.0) acc[k] = acc[k] + ((cf * base) * w) * C[s];
      val = C[s] * base;
    }
    if (node >= 0) ds[node] = val;
  }
  const int rs = t.r_sch[g];
  const double* rxs = t.r_xs + (size_t)g * t.U1;
  for (int u = 0; u < t.U1; ++u) {
    sink.node(u, ds[u]);
    if (rs == kLinFwd) {
      y[u] = ds[u];
    } else {
      const T r = -tlog(ds[u]);
      y[u] = rs == kFlatFwd ? r : r / rxs[u];
    }
  }
  const int* rqi = t.rq_i + (size_t)g * t.W * 3;
  const double* rqf = t.rq_f + (size_t)g * t.W * 2;
  for (int w = 0; w < t.W; ++w) {
    const int* q = rqi + 3 * w;
    const double* f = rqf + 2 * w;
    T v;
    if (q[2] >= 0) {
      v = ds[q[2]];
    } else {
      const T y0 = y[q[0]];
      v = y0 + f[0] * (y[q[1]] - y0);
      if (rs == kFlatFwd) v = texp(-v);
      else if (rs == kLinZero) v = texp(-v * f[1]);
    }
    sink.row(w, v);
  }
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

struct JvpSink {           // K8: the rows' tangent; the primal at d = 0
  double *ds, *rows, *drows;
  bool first;
  __device__ void node(int u, const Dual& v) {
    if (first) ds[u] = v.v;
  }
  __device__ void row(int w, const Dual& v) {
    drows[w] = v.e;
    if (first) rows[w] = v.v;
  }
};

template <class T>
struct SumSink {           // K10: sum gs . rows
  const double* gs;
  T total;
  __device__ void node(int, const T&) {}
  __device__ void row(int w, const T& v) { total = total + v * gs[w]; }
};

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

__device__ __forceinline__ Dir stage_dir(int d, int S, int npv,
                                         const double* row) {
  if (d < S) return {kSpread, d, nullptr};
  if (d < S + npv) return {kPv, d - S, nullptr};
  return {kRow, 0, row};
}

// ---- the kernels -----------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
k8_stage_jvp(const StageTab t, int Sc, int D, int npv, const double* sp,
             const double* pv, const double* fd, const double* tf,
             double* ds, double* rows, double* drows) {
  const long long item = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (item >= (long long)Sc * t.G * D) return;
  const int d = (int)(item % D);
  const long long r = item / D;
  const int g = (int)(r % t.G), sc = (int)(r / t.G);
  const size_t sg = (size_t)sc * t.G + g;
  const Dir d1 = stage_dir(
      d, t.S, npv,
      tf ? tf + (((size_t)sc * D + d) * t.G + g) * t.Lf : nullptr);
  const Dir none{kNone, 0, nullptr};
  JvpSink sink{ds + sg * t.U1, rows + sg * t.W,
               drows + (((size_t)sc * D + d) * t.G + g) * t.W, d == 0};
  stage_eval<Dual>(t, g, sp + sg * t.S, pv + sg * t.S, fd + sg * t.Lf, d1,
                   none, sink);
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

__global__ void __launch_bounds__(kThreads)
k10_stage_hess(const StageTab t, int Sc, int D, int npv, int n_pairs,
               const int* pairs, int n_gf, const double* sp,
               const double* pv, const double* fd, const double* tf,
               const double* gs, double* gZ, double* gf, double* H) {
  const long long item = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n_h = (long long)Sc * t.G * n_pairs;
  if (item >= n_h + (long long)Sc * t.G * n_gf) return;
  if (item < n_h) {
    const int p = (int)(item % n_pairs);
    const long long r = item / n_pairs;
    const int g = (int)(r % t.G), sc = (int)(r / t.G);
    const size_t sg = (size_t)sc * t.G + g;
    const int i = pairs[2 * p], j = pairs[2 * p + 1];
    const Dir d1 = stage_dir(
        i, t.S, npv,
        tf ? tf + (((size_t)sc * D + i) * t.G + g) * t.Lf : nullptr);
    const Dir d2 = stage_dir(
        j, t.S, npv,
        tf ? tf + (((size_t)sc * D + j) * t.G + g) * t.Lf : nullptr);
    SumSink<HDual> sink{gs + sg * t.W, {0.0, 0.0, 0.0, 0.0}};
    stage_eval<HDual>(t, g, sp + sg * t.S, pv + sg * t.S, fd + sg * t.Lf, d1,
                      d2, sink);
    H[(((size_t)sc * D + i) * t.G + g) * D + j] = sink.total.ab;
    H[(((size_t)sc * D + j) * t.G + g) * D + i] = sink.total.ab;
    if (i == j) gZ[sg * D + i] = sink.total.a;
  } else {
    const long long it2 = item - n_h;
    const int l = (int)(it2 % n_gf);
    const long long r = it2 / n_gf;
    const int g = (int)(r % t.G), sc = (int)(r / t.G);
    const size_t sg = (size_t)sc * t.G + g;
    const Dir d1{kUnit, l, nullptr};
    const Dir none{kNone, 0, nullptr};
    SumSink<Dual> sink{gs + sg * t.W, {0.0, 0.0}};
    stage_eval<Dual>(t, g, sp + sg * t.S, pv + sg * t.S, fd + sg * t.Lf, d1,
                     none, sink);
    gf[sg * t.Lf + l] = sink.total.e;
  }
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

}  // namespace

// K8: ds [Sc, G, U1], rows [Sc, G, W], drows [Sc, D, G, W] from sp, pv
// [Sc, G, S], fd [Sc, G, Lf] and tf [Sc, D, G, Lf] (null: no foreign
// directions).
extern "C" int xccy_stage_jvp_f64(const XccyStageTab* t, int Sc, int D,
                                  int npv, const double* sp, const double* pv,
                                  const double* fd, const double* tf,
                                  double* ds, double* rows, double* drows,
                                  cudaStream_t stream) {
  if (!fits(t)) return (int)cudaErrorInvalidValue;
  const long long items = (long long)Sc * t->G * D;
  if (items == 0) return 0;
  k8_stage_jvp<<<blocks_for(items), kThreads, 0, stream>>>(
      *t, Sc, D, npv, sp, pv, fd, tf, ds, rows, drows);
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
// [Sc, D, G, D] from pairs [n_pairs, 2], sp, pv, fd, tf as K8's and gs
// [Sc, G, W].
extern "C" int xccy_stage_hess_f64(const XccyStageTab* t, int Sc, int D,
                                   int npv, int n_pairs, const int* pairs,
                                   int n_gf,
                                   const double* sp, const double* pv,
                                   const double* fd, const double* tf,
                                   const double* gs, double* gZ, double* gf,
                                   double* H, cudaStream_t stream) {
  if (!fits(t)) return (int)cudaErrorInvalidValue;
  const long long items = (long long)Sc * t->G * (n_pairs + n_gf);
  if (items == 0) return 0;
  k10_stage_hess<<<blocks_for(items), kThreads, 0, stream>>>(
      *t, Sc, D, npv, n_pairs, pairs, n_gf, sp, pv, fd, tf, gs, gZ, gf, H);
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
