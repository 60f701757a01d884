// K13 / K14: the OIS stage of the structured risk pass, its directional
// derivatives along the local quotes and its Hessian (f64).
//
// Replace the torch.func towers over one OIS stage in
// adrates_torch/parallel/structured_risk.py (fwd_delta's pass 1 and
// term2_ois), which port region A's OIS pass and term2_ois of
// adrates_tpu/parallel/structured_risk.py (:296-318 and :604-645) over
// adrates_tpu/ops/bootstrap.py:213 (bootstrap_ois) and
// adrates_tpu/ops/interpolation.py:325 (simple_df_static). The JAX package
// wrote these in plain jnp, which XLA lowers: no Pallas kernel. They were
// added because the OIS stage was 82-85% of both towers' ops, about 700-850
// of a FLAT_FWD flagship_v5 staged chunk's 1,190 device ops, each a host
// dispatch on the card.
//
// The stage splits at its node DFs ds [P1]: the chain (the bootstrap over
// the plan's P points) ends in ds, and the rows read ds alone through the
// member's static simple plan (stage_rows.cuh row_val, shared with K8 /
// K10). A block of four warps takes one (scenario, member), its tables
// copied into shared memory first (cp.async). Its threads take a point each
// for the primal rate and iv = 1 / den (every exp and division of the
// chain); then warp 0's lanes take the Qp unit quote directions (in tiles of
// 32 where Qp > 32) and each walks the points in order in dual numbers:
//
//   r   = a pillar's quote, else the sub-pillar rate between quotes i0 and
//         i1 at weight c: exp(l0 + c (l1 - l0)) over l = log(max(q, 1e-8))
//         where the stage's rates are log-linear and every quote of the
//         member is > 0, else q0 + c (q1 - q0) (ops/bootstrap.py's guard,
//         word for word: the clamp passes no tangent below 1e-8);
//   den = 1 + r a,  b = a / den,  pv01 = b + pv01_prev / den,
//   df  = (1 - r pv01_prev) / den,
//
// each quotient a product by iv and its tangent, every link pointing
// backward (the plan's checks and the route's), the t = 0 node and the pad
// nodes DF 1 with no tangent. The primal parts are the same in every lane,
// so each lane writes them to the block's tables (the same value), and each
// lane keeps its own tangents in its column of shared memory. Then
//
//   K13 ois_stage_jvp:  the block's threads take the rows: each row's value
//                       once (from the nodes' transforms, taken once) and its
//                       tangent along each direction of the tile from its one
//                       or two nodes' (node tangents in shared memory, stride
//                       33), the stores coalesced over the rows, the next
//                       row's plan entries loaded a row ahead; ds and dds the
//                       same way over the nodes.
//   K14 ois_stage_hess: forward over reverse. Once a (scenario, member) the
//                       warps sum the node cotangent w = R'(ds)' g + v and
//                       the band B = sum_w g_w R_w''(ds) (a row reads at most
//                       two nodes): a warp a chunk of 32 rows in turn, a lane
//                       a row, each row's terms once, added by runs of lanes
//                       with one node (or band entry) through a segmented
//                       scan into the warp's part of each sum, then the parts
//                       in warp order. So no lane walks a node's rows, which
//                       flagship_v5 crowds up to 2,225 of a member onto. Then
//                       each of warp 0's lanes runs the chain's adjoint in
//                       reverse point order in dual numbers, seeded on each
//                       live node with (w_u, (B ds')_u): a point's pv01-bar
//                       gathered from its children's pv01_prev-bars (a fixed
//                       order, no atomics), the adjoints of df, pv01, b, den
//                       and the rate, whose tangent parts accumulate in the
//                       lane's column of the quotes' table. That column is
//                       row d of Hs (jvp(grad(psi)), as the JAX reference
//                       takes it), written through shared memory so the
//                       stores coalesce.
//
// What bounds them on an H100. At a FLAT_FWD flagship_v5 chunk (G = 7, Qp =
// 32, 72 points, W = 2,225 rows, 50 scenarios) K13 writes about 213 MB (the
// node and row tangents) and K14 reads the rows' cotangents and writes Hs,
// about 10 MB; each needs a few tens of MFLOP. Both run 350 blocks, three to
// five an SM (shared memory: three dual tangents a point and lane in K14):
// K13's rows are bound by the stores, its chain and K14's chain and adjoint
// by one lane's chain of dependent f64 operations and shared-memory reads
// over the points (scripts/ois_phases.py stamps their phases; PERF.md has
// their times beside their bounds).
//
// Sums run in a fixed order with no atomics, so two launches agree bit for
// bit. No allocation, no local memory; one launch a call on the caller's
// stream.
//
// Hazard: any change to bootstrap_ois (ops/bootstrap.py), to ois_native_ds's
// pad sentinel or to the simple row schemes must also be made here and in
// ops/ois_stage.py's emulation (lane_chain, lane_adjoint).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "stage_rows.cuh"

// ---- the tables (kernels._OStage) -------------------------------------------

struct OisStageTab {
  int G, P, P1, Qp, W, E, log;
  const double* pt_f;   // [G, P, 2] accrual, sub-pillar rate weight c
  const int* pt_i;      // [G, P, 4] previous point or -1, pillar or -1, i0, i1
  const int* ch_ptr;    // [G, P + 1] each point's children (CSR)
  const int* ch_pt;     // [G, NC]
  const int* pad;       // [G, P1] 1 at a pad node
  const int* rq_i;      // [G, W, 3] i0, i1, exact knot or -1
  const double* rq_f;   // [G, W, 2] weight, query time
  const int* r_sch;     // [G]
  const double* r_xs;   // [G, P1]
  int NC, NE;           // children, node-band slots
  const int* mb_pq;     // [G, E, 2] the band entries p < q
  const int* r_e;       // [G, W] each row's band entry, or -1
  const int* nb_ptr;    // [G, P1 + 1] each node's band entries (CSR)
  const int* nb_e;      // [G, NE]
};

namespace {

constexpr int kMaxP = 192;      // ois_stage.MAX_P
constexpr int kMaxQ = 64;       // ois_stage.MAX_Q
constexpr int kMaxW = 1 << 16;  // ois_stage.MAX_W
constexpr int kLanes = 32;      // the lanes of a warp: directions a tile
constexpr int kWarps = 4;       // a block's warps (one (scenario, member))
constexpr int kThreads = kWarps * kLanes;
constexpr int kT = kLanes + 1;  // a transposed table's row stride
constexpr double kFloor = 1e-8; // ois_stage.RATE_FLOOR

// ---- dual numbers ------------------------------------------------------------

struct Dual { double v, e; };

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
__device__ __forceinline__ Dual operator*(double c, Dual x) {
  return {c * x.v, c * x.e};
}
__device__ __forceinline__ Dual operator*(Dual x, double c) {
  return {x.v * c, x.e * c};
}
__device__ __forceinline__ Dual operator+(double c, Dual x) {
  return {c + x.v, x.e};
}
__device__ __forceinline__ Dual operator-(double c, Dual x) {
  return {c - x.v, -x.e};
}
__device__ __forceinline__ Dual operator/(double c, Dual y) {
  const double q = c / y.v;
  return {q, (0.0 - q * y.e) / y.v};
}

bool fits(const OisStageTab* t) {
  return t->G >= 1 && t->P >= 1 && t->P <= kMaxP && t->Qp >= 1
         && t->Qp <= kMaxQ && t->W >= 1 && t->W <= kMaxW
         && t->P1 == t->P + 1;
}

#ifdef OIS_TIMELINE
// scripts/ois_phases.py builds this file with -DOIS_TIMELINE: lane 0 of each
// of a launch's first kStampBlocks blocks stamps the SM's clock (cycles) at
// its phases, K13's in g_ois[0], K14's in g_ois[1] (ois_timeline reads
// them): 0 start, 1 tables and quotes loaded and the points' primals, 2
// chain walked; K13 3 ds and dds written, 4 rows written; K14 3 node band
// summed and its products with the tangents, 4 adjoint swept, 5 Hs written
// (the last tile of directions where Qp > 32), and warp 0's cycles in the
// band's rows' terms (6) and run sums (7), summed over its chunks.
constexpr int kStampBlocks = 4096, kStamps = 8;
__device__ long long g_ois[2][kStampBlocks][kStamps];
#define OIS_STAMP(k, i)                                            \
  do {                                                             \
    if (threadIdx.x == 0 && blockIdx.x < kStampBlocks) {           \
      g_ois[k][blockIdx.x][i] = clock64();                         \
    }                                                              \
  } while (0)
#else
#define OIS_STAMP(k, i) \
  do {                  \
  } while (0)
#endif

// ---- a block's shared memory --------------------------------------------------

// Offsets of a block's tables: doubles from the start, then ints from int
// offset 0 past the last double (nd doubles). The quotes, their logs and
// reciprocals, the member's chain table pf [P, 2]; the primal rates, 1 /
// denoms and pv01s a point and each lane's pv01 tangent a point in its
// column (stride 32); the node DFs; K13 the nodes' transforms and their
// tangents (stride 33); K14 the primal pv01_prev-bars, the df and
// pv01_prev-bar tangents (stride 32; the latter's
// room holds the nodes' transforms, each warp's row-chunk terms and its part
// of the node band until the adjoint runs), the node cotangents, band and the
// quotes' adjoint tangents (stride 33). Ints: the log-linear rates' switch,
// the member's chain table pi [P, 4] and pad nodes; K14 the children lists,
// each node's band entries and the entries' node pairs.
struct Layout {
  int q, lq, iq, pf, rv, iv, pvv, pvt, ds, nt, J, ppv, dft, ppt, sc, part, w,
      md, mo, qb, nd;
  int logr, pi, pad, cp, cpt, nbp, nbe, pq;
  int bytes;
};

Layout layout(const OisStageTab* t, bool hess) {
  Layout L;
  const int P = t->P, P1 = t->P1, Qp = t->Qp, E = t->E;
  int off = 0, ioff = 0;
  auto take = [&](int n) { const int o = off; off += n; return o; };
  auto itake = [&](int n) { const int o = ioff; ioff += n; return o; };
  L.q = take(Qp);
  L.lq = take(Qp);
  L.iq = take(Qp);
  L.pf = take(2 * P);
  L.rv = take(P);
  L.iv = take(P);
  L.pvv = take(P);
  L.pvt = take(kLanes * P);
  L.ds = take(P1);
  L.logr = itake(1);
  L.pi = itake(4 * P);
  L.pad = itake(P1);
  if (!hess) {
    L.nt = take(3 * P1);
    L.J = take(kT * P1);
    L.ppv = L.dft = L.ppt = L.sc = L.part = L.w = L.md = L.mo = L.qb = -1;
    L.cp = L.cpt = L.nbp = L.nbe = L.pq = -1;
  } else {
    L.J = -1;
    L.ppv = take(P);
    L.dft = take(kLanes * P);
    const int band = 3 * P1 + kWarps * (2 * kLanes + 2 * P1 + E);
    L.ppt = take(kLanes * P > band ? kLanes * P : band);
    L.nt = L.ppt;
    L.sc = L.nt + 3 * P1;
    L.part = L.sc + kWarps * 2 * kLanes;
    L.w = take(P1);
    L.md = take(P1);
    L.mo = take(E);
    L.qb = take(kT * Qp);
    L.cp = itake(P + 1);
    L.cpt = itake(t->NC);
    L.nbp = itake(P1 + 1);
    L.nbe = itake(t->NE);
    L.pq = itake(2 * E);
  }
  L.nd = off;
  L.bytes = off * (int)sizeof(double) + ioff * (int)sizeof(int);
  return L;
}

__device__ __forceinline__ int* ints(double* sm, const Layout& L) {
  return reinterpret_cast<int*>(sm + L.nd);
}

// Member g's static tables into the block's shared memory, all threads, so
// that the chain and the adjoint read them there point by point: every copy
// in flight at once (cp.async); the caller synchronises.
__device__ void load_tables(const OisStageTab& t, const Layout& L, double* sm,
                            int g, bool hess) {
  const int P = t.P, P1 = t.P1, E = t.E;
  int* si = ints(sm, L);
  auto copy = [](auto* dst, const auto* src, int n) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      __pipeline_memcpy_async(dst + i, src + i, sizeof(*dst));
    }
  };
  copy(sm + L.pf, t.pt_f + (size_t)g * 2 * P, 2 * P);
  copy(si + L.pi, t.pt_i + (size_t)g * 4 * P, 4 * P);
  copy(si + L.pad, t.pad + (size_t)g * P1, P1);
  if (hess) {
    copy(si + L.cp, t.ch_ptr + (size_t)g * (P + 1), P + 1);
    copy(si + L.cpt, t.ch_pt + (size_t)g * t.NC, t.NC);
    copy(si + L.nbp, t.nb_ptr + (size_t)g * (P1 + 1), P1 + 1);
    copy(si + L.nbe, t.nb_e + (size_t)g * t.NE, t.NE);
    copy(si + L.pq, t.mb_pq + (size_t)g * 2 * E, 2 * E);
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
}

// ---- the chain ------------------------------------------------------------------

// Point p's rate's tangent along direction d (d < 0: none), its primal rv:
// 1 where d is its pillar's quote; else the sub-pillar rate's, rv (y0 + c
// (y1 - y0)) with y_k = 1 / q_k where d is quote i_k above the 1e-8 clamp
// (iq) for the log-linear rates, y_k = [d = i_k] for the linear ones.
__device__ __forceinline__ double rate_tan(const int* pi, double c,
                                           const double* iq, bool logr, int d,
                                           double rv) {
  const int pil = pi[1], i0 = pi[2], i1 = pi[3];
  if (pil >= 0) return d == pil ? 1.0 : 0.0;
  if (logr) {
    const double y0 = d == i0 ? iq[i0] : 0.0, y1 = d == i1 ? iq[i1] : 0.0;
    return rv * (y0 + c * (y1 - y0));
  }
  const double y0 = d == i0 ? 1.0 : 0.0, y1 = d == i1 ? 1.0 : 0.0;
  return y0 + c * (y1 - y0);
}

// 1 / den as a dual number from its primal iv.
__device__ __forceinline__ Dual inverse(Dual den, double iv) {
  return {iv, -(den.e * iv) * iv};
}

// One (scenario, member) as warp 0 reads it, its tables in shared memory.
struct Member {
  int lane, d;             // lane, the lane's direction (-1: none)
  bool logr;               // log-linear sub-pillar rates
  const double* pf;        // [P, 2]
  const int* pi;           // [P, 4]
  const int* pad;          // [P1]
};

// The quotes of scenario sc, member g into the block's tables, with their
// logs log(max(q, 1e-8)) and reciprocals (0 below the clamp, which passes no
// tangent), by warp 0, and whether the sub-pillar rates are log-linear (the
// stage's rates are and every quote of the member is > 0).
__device__ void load_quotes(const OisStageTab& t, const Layout& L, double* sm,
                            const double* Q, int sc, int g, int lane) {
  const int Qp = t.Qp;
  const double* qg = Q + ((size_t)sc * t.G + g) * Qp;
  bool pos = true;
  for (int i = lane; i < Qp; i += kLanes) {
    const double x = qg[i];
    sm[L.q + i] = x;
    sm[L.lq + i] = log(fmax(x, kFloor));
    sm[L.iq + i] = x >= kFloor ? 1.0 / x : 0.0;
    pos = pos && x > 0.0;
  }
  pos = __all_sync(0xffffffffu, pos);
  if (lane == 0) ints(sm, L)[L.logr] = t.log && pos;
}

// Each point's primal rate rv and iv = 1 / (1 + rv a), a thread a point: a
// pillar's quote, else the sub-pillar rate, exp of the log-linear one or the
// linear one. So the lanes' chains and adjoints divide and exponentiate
// nothing (ois_stage.point_prims).
__device__ void point_prims(const OisStageTab& t, const Layout& L,
                            double* sm) {
  const double *q = sm + L.q, *lq = sm + L.lq, *pf = sm + L.pf;
  const int* si = ints(sm, L);
  const bool logr = si[L.logr] != 0;
  for (int p = threadIdx.x; p < t.P; p += blockDim.x) {
    const int* pi = si + L.pi + 4 * p;
    const double a = pf[2 * p], c = pf[2 * p + 1];
    const int pil = pi[1], i0 = pi[2], i1 = pi[3];
    double r;
    if (pil >= 0) {
      r = q[pil];
    } else if (logr) {
      r = exp(lq[i0] + c * (lq[i1] - lq[i0]));
    } else {
      r = q[i0] + c * (q[i1] - q[i0]);
    }
    sm[L.rv + p] = r;
    sm[L.iv + p] = 1.0 / (1.0 + r * a);
  }
}

// Warp 0's dual chains, a lane a direction: each point's pv01 tangent in the
// lane's column (K14 also the df tangent), the primal pv01s and node DFs in
// the block's tables (every lane writes the same values), and the node
// tangents handed to put(u, tangent) (0 at the pad nodes). Each quotient by
// den is a product by 1 / den (point_prims' iv and its tangent).
template <class Put>
__device__ void chain(const OisStageTab& t, const Layout& L, double* sm,
                      const Member& m, bool hess, Put put) {
  const double *iq = sm + L.iq, *rv = sm + L.rv, *iv = sm + L.iv;
  double *pvv = sm + L.pvv, *pvt = sm + L.pvt;
  for (int p = 0; p < t.P; ++p) {
    const int* pi = m.pi + 4 * p;
    const int prev = pi[0];
    const double a = m.pf[2 * p];
    const Dual r = {rv[p], rate_tan(pi, m.pf[2 * p + 1], iq, m.logr, m.d,
                                    rv[p])};
    const Dual den = 1.0 + r * a;
    const Dual inv = inverse(den, iv[p]);
    const Dual b = a * inv;
    const Dual pp = prev >= 0 ? Dual{pvv[prev], pvt[prev * kLanes + m.lane]}
                              : Dual{0.0, 0.0};
    const Dual pv = b + pp * inv;
    const Dual df = (1.0 - r * pp) * inv;
    pvv[p] = pv.v;
    pvt[p * kLanes + m.lane] = pv.e;
    const bool live = m.pad[p + 1] == 0;
    sm[L.ds + p + 1] = live ? df.v : 1.0;
    if (hess) sm[L.dft + p * kLanes + m.lane] = live ? df.e : 0.0;
    put(p + 1, live ? df.e : 0.0);
  }
  sm[L.ds] = 1.0;
  put(0, 0.0);
}

// The transforms nt [3, P1] of member g's node DFs, a thread a node.
__device__ void node_transforms(const OisStageTab& t, const Layout& L,
                                double* sm, int g) {
  const int rs = t.r_sch[g], P1 = t.P1;
  const double* xs = t.r_xs + (size_t)g * P1;
  for (int u = threadIdx.x; u < P1; u += blockDim.x) {
    const GPt p = transform(rs, sm[L.ds + u], xs[u]);
    sm[L.nt + u] = p.y;
    sm[L.nt + P1 + u] = p.y1;
    sm[L.nt + 2 * P1 + u] = p.y2;
  }
}

// A row of the packed plan (xccy_stage._pack_rows) as registers: its two
// bracketing nodes, its exact knot or -1, its weight and query time.
struct Row {
  int i0, i1, kn;
  double c, qt;
};

__device__ __forceinline__ Row load_row(const int* rqi, const double* rqf,
                                        int w, int W) {
  if (w >= W) return {0, 0, 0, 0.0, 0.0};
  return {rqi[3 * w], rqi[3 * w + 1], rqi[3 * w + 2], rqf[2 * w],
          rqf[2 * w + 1]};
}

// ---- K13 ------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
k13_ois_stage_jvp(const OisStageTab t, const Layout L, const double* Q,
                  double* ds_out, double* rows_out, double* dds,
                  double* drows) {
  extern __shared__ double sm[];
  OIS_STAMP(0, 0);
  const int g = blockIdx.x % t.G, sc = blockIdx.x / t.G;
  const int tid = threadIdx.x, lane = tid % kLanes, warp = tid / kLanes;
  const int P1 = t.P1, W = t.W, Qp = t.Qp;
  load_tables(t, L, sm, g, false);
  if (warp == 0) load_quotes(t, L, sm, Q, sc, g, lane);
  __syncthreads();
  point_prims(t, L, sm);
  Member m;
  m.lane = lane;
  m.logr = ints(sm, L)[L.logr] != 0;
  m.pf = sm + L.pf;
  m.pi = ints(sm, L) + L.pi;
  m.pad = ints(sm, L) + L.pad;
  __syncthreads();
  OIS_STAMP(0, 1);
  const int rs = t.r_sch[g];
  const int* rqi = t.rq_i + (size_t)g * W * 3;
  const double* rqf = t.rq_f + (size_t)g * W * 2;
  double* J = sm + L.J;
  const double* dsv = sm + L.ds;
  for (int base = 0; base < Qp; base += kLanes) {
    const int nd = min(kLanes, Qp - base);
    if (warp == 0) {
      m.d = lane < nd ? base + lane : -1;
      chain(t, L, sm, m, false,
            [&](int u, double e) { J[u * kT + lane] = e; });
    }
    __syncthreads();
    OIS_STAMP(0, 2);
    if (base == 0) {
      node_transforms(t, L, sm, g);
      double* out = ds_out + ((size_t)sc * t.G + g) * P1;
      for (int u = tid; u < P1; u += kThreads) out[u] = dsv[u];
    }
    for (int i = tid; i < nd * P1; i += kThreads) {
      const int k = i / P1, u = i - k * P1;
      dds[(((size_t)sc * Qp + base + k) * t.G + g) * P1 + u] = J[u * kT + k];
    }
    __syncthreads();
    OIS_STAMP(0, 3);
    // a thread a row, the next row's table entries loaded a row ahead
    Row nx = load_row(rqi, rqf, tid, W);
    for (int w = tid; w < W; w += kThreads) {
      const Row rw = nx;
      nx = load_row(rqi, rqf, w + kThreads, W);
      int u0 = rw.kn, u1 = -1;
      double v, c0 = 0.0, c1 = 0.0;
      if (u0 >= 0) {
        v = dsv[u0];
      } else {
        const RowVal r = row_val(rs, rw.i0, rw.i1, rw.c, rw.qt, sm + L.nt,
                                 P1);
        v = r.v;
        u0 = rw.i0;
        c0 = r.v1 * r.t0;
        if (rw.i1 != rw.i0) {
          u1 = rw.i1;
          c1 = r.v1 * r.t1;
        }
      }
      if (base == 0) rows_out[((size_t)sc * t.G + g) * W + w] = v;
      for (int k = 0; k < nd; ++k) {
        double x = J[u0 * kT + k];
        if (rw.kn < 0) {
          x = c0 * x;
          if (u1 >= 0) x = x + c1 * J[u1 * kT + k];
        }
        drows[(((size_t)sc * Qp + base + k) * t.G + g) * W + w] = x;
      }
    }
    __syncthreads();
    OIS_STAMP(0, 4);
  }
}

// ---- K14 ------------------------------------------------------------------------

// A chunk's terms (x, y) of a warp's lanes' keys (a node or a band entry;
// -1: none) add to sx[key] (and sy[key]) by runs: each run of lanes with one
// key sums its terms by a segmented inclusive scan (Hillis-Steele: at
// offsets 1, 2, 4, 8, 16 a lane adds the partial sum of the lane that far
// below it, inside its run), then the run's last lane adds the sum; where
// one key has several runs the first run's last lane adds theirs in lane
// order. A fixed order whatever the keys, in 5 steps however many lanes
// share a key (ois_stage._group_add).
struct Run {
  int s;           // the run's first lane
  bool end;        // the lane ends its run
  unsigned same;   // the run ends with the lane's key (at a run's end)
};

__device__ __forceinline__ Run run_of(int key, int lane) {
  constexpr unsigned kAll = 0xffffffffu;
  const int below = __shfl_up_sync(kAll, key, 1);
  const int above = __shfl_down_sync(kAll, key, 1);
  const unsigned starts = __ballot_sync(kAll, lane == 0 || below != key);
  Run r;
  r.s = 31 - __clz(starts & (kAll >> (kLanes - 1 - lane)));
  r.end = lane == kLanes - 1 || above != key;
  r.same = __match_any_sync(kAll, r.end ? key : -2 - lane);
  return r;
}

// One step of a run's scan: x plus the partial sum off lanes below, inside
// the run.
__device__ __forceinline__ double scan_step(double x, const Run& r, int lane,
                                            int off) {
  const double xu = __shfl_up_sync(0xffffffffu, x, off);
  return lane - off >= r.s ? xu + x : x;
}

// The runs' sums (x, y at each run's last lane) into sx[key] and sy[key].
__device__ __forceinline__ void run_add(int key, const Run& r, double x,
                                        double y, double* sx, double* sy,
                                        double* sc, int lane) {
  __syncwarp();
  sc[lane] = x;
  sc[kLanes + lane] = y;
  __syncwarp();
  if (!r.end || key < 0 || lane != __ffs(r.same) - 1) return;
  for (unsigned b = r.same & (r.same - 1); b; b &= b - 1) {
    const int l = __ffs(b) - 1;
    x = x + sc[l];
    y = y + sc[kLanes + l];
  }
  sx[key] = sx[key] + x;
  if (sy) sy[key] = sy[key] + y;
}

// w = R'(ds)' g + v, the band's diagonal md and its entries mo: warp k takes
// the row chunks k, k + kWarps, ... (32 rows, a lane a row, each row's terms
// once, the next chunk's table entries loaded a chunk ahead) into its own
// parts by runs (run_of; the three keys' scans interleaved, their adds tap
// 0's, then tap 1's, then the band entries'); then each sum is its warps'
// parts in warp order (ois_stage.node_band).
__device__ void node_band(const OisStageTab& t, const Layout& L, double* sm,
                          int g, const double* gs, const double* vs) {
  const int rs = t.r_sch[g], P1 = t.P1, W = t.W, E = t.E;
  const int tid = threadIdx.x, lane = tid % kLanes, warp = tid / kLanes;
  const int* rqi = t.rq_i + (size_t)g * W * 3;
  const double* rqf = t.rq_f + (size_t)g * W * 2;
  const int* re = t.r_e + (size_t)g * W;
  const double* nt = sm + L.nt;
  const int stride = 2 * P1 + E;
  double* pw = sm + L.part + warp * stride;
  double *pm = pw + P1, *po = pw + 2 * P1, *sc = sm + L.sc + warp * 2 * kLanes;
  for (int i = lane; i < stride; i += kLanes) pw[i] = 0.0;
  int r = warp * kLanes + lane;
  Row nx = load_row(rqi, rqf, r, W);
  double ng = r < W ? gs[r] : 0.0;
  int ne = r < W ? re[r] : -1;
#ifdef OIS_TIMELINE
  long long t0 = clock64(), t_row = 0, t_grp = 0;
#endif
  for (int w0 = warp * kLanes; w0 < W; w0 += kThreads) {
    const Row rw = nx;
    const double gw = ng;
    const int ew = ne;
    r = w0 + lane;
    nx = load_row(rqi, rqf, r + kThreads, W);
    ng = r + kThreads < W ? gs[r + kThreads] : 0.0;
    ne = r + kThreads < W ? re[r + kThreads] : -1;
    int k0 = -1, k1 = -1, ke = -1;
    double a0 = 0.0, m0 = 0.0, a1 = 0.0, m1 = 0.0, mb = 0.0;
    if (r < W) {
      if (rw.kn >= 0) {
        k0 = rw.kn;
        a0 = gw;
      } else {
        const RowVal v = row_val(rs, rw.i0, rw.i1, rw.c, rw.qt, nt, P1);
        k0 = rw.i0;
        a0 = gw * (v.v1 * v.t0);
        m0 = gw * (v.v2 * (v.t0 * v.t0) + v.v1 * v.s0);
        if (rw.i1 != rw.i0) {
          k1 = rw.i1;
          a1 = gw * (v.v1 * v.t1);
          m1 = gw * (v.v2 * (v.t1 * v.t1) + v.v1 * v.s1);
          ke = ew;
          mb = gw * (v.v2 * (v.t0 * v.t1));
        }
      }
    }
#ifdef OIS_TIMELINE
    const long long t1 = clock64();
    t_row += t1 - t0;
#endif
    // the three keys' scans interleaved, their adds in turn
    const Run r0 = run_of(k0, lane), r1 = run_of(k1, lane);
    const Run rb = run_of(ke, lane);
    for (int off = 1; off < kLanes; off *= 2) {
      a0 = scan_step(a0, r0, lane, off);
      m0 = scan_step(m0, r0, lane, off);
      a1 = scan_step(a1, r1, lane, off);
      m1 = scan_step(m1, r1, lane, off);
      mb = scan_step(mb, rb, lane, off);
    }
    run_add(k0, r0, a0, m0, pw, pm, sc, lane);
    run_add(k1, r1, a1, m1, pw, pm, sc, lane);
    run_add(ke, rb, mb, 0.0, po, nullptr, sc, lane);
#ifdef OIS_TIMELINE
    t0 = clock64();
    t_grp += t0 - t1;
#endif
  }
#ifdef OIS_TIMELINE
  if (tid == 0 && blockIdx.x < kStampBlocks) {
    g_ois[1][blockIdx.x][6] = t_row;
    g_ois[1][blockIdx.x][7] = t_grp;
  }
#endif
  __syncthreads();
  const double* part = sm + L.part;
  for (int i = tid; i < stride; i += kThreads) {
    double s = part[i];
    for (int k = 1; k < kWarps; ++k) s = s + part[k * stride + i];
    if (i < P1) {
      sm[L.w + i] = s + vs[i];
    } else if (i < 2 * P1) {
      sm[L.md + i - P1] = s;
    } else {
      sm[L.mo + i - 2 * P1] = s;
    }
  }
}

// (B ds')_u of each live node u = p + 1 along each lane's direction, md_u
// ds'_u plus mo_e ds'_partner over its band entries in order, into the
// lane's column of ppt at point p (0 at a pad node), the block's warps a
// point in turn: the adjoint reads it there before it writes the point's
// pv01_prev-bar over it.
__device__ void band_products(const OisStageTab& t, const Layout& L,
                              double* sm) {
  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
  const double *dft = sm + L.dft, *md = sm + L.md, *mo = sm + L.mo;
  const int* si = ints(sm, L);
  const int *pad = si + L.pad, *pq = si + L.pq, *nbp = si + L.nbp;
  const int* nbe = si + L.nbe;
  double* out = sm + L.ppt;
  auto dsd = [&](int u) {
    return u == 0 || pad[u] ? 0.0 : dft[(u - 1) * kLanes + lane];
  };
  for (int p = warp; p < t.P; p += kWarps) {
    const int u = p + 1;
    double e = 0.0;
    if (!pad[u]) {
      e = md[u] * dsd(u);
      for (int k = nbp[u]; k < nbp[u + 1]; ++k) {
        const int x = nbe[k];
        const int pe = pq[2 * x], qe = pq[2 * x + 1];
        e = e + mo[x] * dsd(pe == u ? qe : pe);
      }
    }
    out[p * kLanes + lane] = e;
  }
}

// Warp 0's adjoints of the chain in reverse point order in dual numbers, a
// lane a direction, each quotient by den a product by 1 / den: the quotes'
// adjoint tangents in the lane's column of qb.
__device__ void adjoint(const OisStageTab& t, const Layout& L, double* sm,
                        const Member& m) {
  const int lane = m.lane, d = m.d;
  const double *q = sm + L.q, *iq = sm + L.iq, *rv = sm + L.rv;
  const double *iv = sm + L.iv;
  const double *pvv = sm + L.pvv, *pvt = sm + L.pvt, *dft = sm + L.dft;
  const double* w = sm + L.w;
  double *ppv = sm + L.ppv, *ppt = sm + L.ppt, *qb = sm + L.qb;
  const int* si = ints(sm, L);
  const int *cp = si + L.cp, *cpt = si + L.cpt;
  for (int p = t.P - 1; p >= 0; --p) {
    const int u = p + 1;
    const int* pi = m.pi + 4 * p;
    const int prev = pi[0];
    const double a = m.pf[2 * p], c = m.pf[2 * p + 1];
    const Dual r = {rv[p], rate_tan(pi, c, iq, m.logr, d, rv[p])};
    const Dual den = 1.0 + r * a;
    const Dual inv = inverse(den, iv[p]);
    const Dual b = a * inv;
    const Dual pp = prev >= 0 ? Dual{pvv[prev], pvt[prev * kLanes + lane]}
                              : Dual{0.0, 0.0};
    // a pad node's DF is never read: its cotangent is 0
    const Dual df = {sm[L.ds + u], dft[p * kLanes + lane]};
    // band_products' (B ds')_u, read before ppt's slot p is written below
    const Dual dfb = m.pad[u] ? Dual{0.0, 0.0}
                              : Dual{w[u], ppt[p * kLanes + lane]};
    Dual pvb = {0.0, 0.0};
    for (int k = cp[p]; k < cp[p + 1]; ++k) {
      const int ch = cpt[k];
      pvb = pvb + Dual{ppv[ch], ppt[ch * kLanes + lane]};
    }
    const Dual numb = dfb * inv;
    Dual denb = -(numb * df);
    Dual rb = -(numb * pp);
    Dual ppb = -(numb * r);
    const Dual pvd = pvb * inv;
    ppb = ppb + pvd;
    denb = denb - pvd * (pp * inv);
    denb = denb - pvd * b;
    rb = rb + denb * a;
    if (prev >= 0) {
      ppv[p] = ppb.v;
      ppt[p * kLanes + lane] = ppb.e;
    }
    // the rate's adjoint to its quotes
    const int pil = pi[1], i0 = pi[2], i1 = pi[3];
    if (pil >= 0) {
      qb[pil * kT + lane] += rb.e;
    } else if (m.logr) {
      const Dual Lb = rb * r;
      const Dual s1 = Lb * c;
      const Dual s0 = Lb - s1;
      // the tangent of s / q_i: (s' - (s / q_i) [d = i]) / q_i
      if (q[i0] >= kFloor) {
        qb[i0 * kT + lane] +=
            (s0.e - (d == i0 ? s0.v * iq[i0] : 0.0)) * iq[i0];
      }
      if (q[i1] >= kFloor) {
        qb[i1 * kT + lane] +=
            (s1.e - (d == i1 ? s1.v * iq[i1] : 0.0)) * iq[i1];
      }
    } else {
      const Dual s1 = rb * c;
      qb[i1 * kT + lane] += s1.e;
      qb[i0 * kT + lane] += (rb - s1).e;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
k14_ois_stage_hess(const OisStageTab t, const Layout L, const double* Q,
                   const double* G, const double* V, double* Hs) {
  extern __shared__ double sm[];
  OIS_STAMP(1, 0);
  const int g = blockIdx.x % t.G, sc = blockIdx.x / t.G;
  const int tid = threadIdx.x, lane = tid % kLanes, warp = tid / kLanes;
  const int Qp = t.Qp;
  load_tables(t, L, sm, g, true);
  if (warp == 0) load_quotes(t, L, sm, Q, sc, g, lane);
  __syncthreads();
  point_prims(t, L, sm);
  Member m;
  m.lane = lane;
  m.logr = ints(sm, L)[L.logr] != 0;
  m.pf = sm + L.pf;
  m.pi = ints(sm, L) + L.pi;
  m.pad = ints(sm, L) + L.pad;
  __syncthreads();
  OIS_STAMP(1, 1);
  const double* gs = G + ((size_t)sc * t.G + g) * t.W;
  const double* vs = V + ((size_t)sc * t.G + g) * t.P1;
  double* qb = sm + L.qb;
  for (int base = 0; base < Qp; base += kLanes) {
    const int nd = min(kLanes, Qp - base);
    if (warp == 0) {
      m.d = lane < nd ? base + lane : -1;
      chain(t, L, sm, m, true, [](int, double) {});
      for (int i = 0; i < Qp; ++i) qb[i * kT + lane] = 0.0;
    }
    __syncthreads();
    OIS_STAMP(1, 2);
    if (base == 0) {
      node_transforms(t, L, sm, g);
      __syncthreads();
      node_band(t, L, sm, g, gs, vs);
      __syncthreads();
    }
    band_products(t, L, sm);
    __syncthreads();
    OIS_STAMP(1, 3);
    if (warp == 0) adjoint(t, L, sm, m);
    __syncthreads();
    OIS_STAMP(1, 4);
    for (int i = tid; i < nd * Qp; i += kThreads) {
      const int k = i / Qp, j = i - k * Qp;
      Hs[(((size_t)sc * Qp + base + k) * t.G + g) * Qp + j] = qb[j * kT + k];
    }
    __syncthreads();
    OIS_STAMP(1, 5);
  }
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace

// K13: ds [Sc, G, P1], rows [Sc, G, W], dds [Sc, Qp, G, P1], drows [Sc, Qp,
// G, W] from the local quotes q [Sc, G, Qp]. A warp (block) a (scenario,
// member).
extern "C" int ois_stage_jvp_f64(const OisStageTab* t, int Sc,
                                 const double* q, double* ds, double* rows,
                                 double* dds, double* drows,
                                 cudaStream_t stream) {
  if (!fits(t) || Sc < 0) return (int)cudaErrorInvalidValue;
  if (Sc == 0) return 0;
  const Layout L = layout(t, false);
  const cudaError_t err = allow_smem(k13_ois_stage_jvp, L.bytes);
  if (err != cudaSuccess) return (int)err;
  k13_ois_stage_jvp<<<(unsigned)((long long)Sc * t->G), kThreads, L.bytes,
                      stream>>>(*t, L, q, ds, rows, dds, drows);
  return (int)cudaGetLastError();
}

// K14: Hs [Sc, Qp, G, Qp] from q [Sc, G, Qp], the rows' cotangents gs [Sc,
// G, W] and the node cotangents vs [Sc, G, P1]. A warp (block) a (scenario,
// member).
extern "C" int ois_stage_hess_f64(const OisStageTab* t, int Sc,
                                  const double* q, const double* gs,
                                  const double* vs, double* Hs,
                                  cudaStream_t stream) {
  if (!fits(t) || Sc < 0) return (int)cudaErrorInvalidValue;
  if (Sc == 0) return 0;
  const Layout L = layout(t, true);
  const cudaError_t err = allow_smem(k14_ois_stage_hess, L.bytes);
  if (err != cudaSuccess) return (int)err;
  k14_ois_stage_hess<<<(unsigned)((long long)Sc * t->G), kThreads, L.bytes,
                       stream>>>(*t, L, q, gs, vs, Hs);
  return (int)cudaGetLastError();
}

#ifdef OIS_TIMELINE
// The profiling build's stamps of the last launch of K13 (which = 13) or
// K14 (14), its first n blocks: out[n, 8] (OIS_STAMP).
extern "C" int ois_timeline(int which, long long* out, int n) {
  if (which != 13 && which != 14) return (int)cudaErrorInvalidValue;
  if (n > kStampBlocks) n = kStampBlocks;
  return (int)cudaMemcpyFromSymbol(out, g_ois, sizeof(long long) * kStamps * n,
                                   sizeof(g_ois[0]) * (which - 13));
}
#endif

// K13's (which = 13) or K14's (14) registers and local memory a thread, and
// at this stage its dynamic shared memory a block, the blocks an SM holds at
// once and its threads a block: out[0..4].
extern "C" int ois_kernel_info(const OisStageTab* t, int which, int* out) {
  if (!fits(t) || (which != 13 && which != 14)) {
    return (int)cudaErrorInvalidValue;
  }
  const Layout L = layout(t, which == 14);
  cudaFuncAttributes a;
  int nb = 0;
  cudaError_t err;
  if (which == 13) {
    err = allow_smem(k13_ois_stage_jvp, L.bytes);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, k13_ois_stage_jvp);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &nb, k13_ois_stage_jvp, kThreads, (size_t)L.bytes);
    }
  } else {
    err = allow_smem(k14_ois_stage_hess, L.bytes);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, k14_ois_stage_hess);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &nb, k14_ois_stage_hess, kThreads, (size_t)L.bytes);
    }
  }
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = L.bytes;
  out[3] = nb;
  out[4] = kThreads;
  return 0;
}
