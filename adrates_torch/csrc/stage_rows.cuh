// The simple schemes' row arithmetic shared by the stage kernels: K8 /
// K10 / K12 (xccy_stage.cu) and K13 / K14 (ois_stage.cu). A stage row is an
// exact knot, or v(z) with z = y0 + c (y1 - y0) over the transformed DFs y
// of the one or two nodes that bracket it (ops/xccy_stage.py row_terms,
// transform; the plans are packed by xccy_stage._pack_rows).

#pragma once

#include <cuda_runtime.h>

namespace {

// the kernels' scheme codes (xccy_stage.SCHEME_CODE)
enum { kLinFwd = 0, kFlatFwd = 1, kLinZero = 2 };

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

// Row w at the primal node DFs through its member's scheme rs
// (xccy_stage.row_terms), from the nodes' transforms nt [3, U1] (y, y',
// y'' of each node, xccy_stage.transform): the row as a function of z =
// y0 + c (y1 - y0), v and its derivatives v', v'' in z, and its taps'
// dz/dds (t0, t1) and d2z/dds2 (s0, s1); one tap (t1 = s1 = 0) where
// i0 = i1. The row's plan entries: its nodes u0, u1, weight c and query
// time qt (read by LINEAR_ZERO only).
struct RowVal { double v, v1, v2, t0, t1, s0, s1; };

__device__ __forceinline__ RowVal row_val(int rs, int u0, int u1, double c,
                                          double qt, const double* nt,
                                          int U1) {
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

// The same from the packed plan's entries q (u0, u1, ...) and f (c, qt).
__device__ __forceinline__ RowVal row_val(int rs, const int* q,
                                          const double* f, const double* nt,
                                          int U1) {
  return row_val(rs, q[0], q[1], f[0], rs == kLinZero ? f[1] : 0.0, nt, U1);
}

}  // namespace
