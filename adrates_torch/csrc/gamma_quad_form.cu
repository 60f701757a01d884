// K2: term 1 of the book gamma, grouped by trip signature (f64).
//
// Replaces adrates_tpu/parallel/multibook.py:_gamma_quad_form_grouped
// (:1660-1715, the trip part; the cap/floor clamp term stays plain torch
// in the caller).
//
// For one trip group with quote rows rows[0..k) and trips t = 0..T_g-1,
// a = dfs[s, s_idx[t]], b = dfs[s, e_idx[t]], c = dfs[s, p_idx[t]] and
// Ja_i = J[s, rows[i], s_idx[t]] (likewise Jb, Jc at e_idx, p_idx):
//
//   Z_ij = sum_t w_t [ f_ab (Ja_i Jb_j + Jb_i Ja_j)
//                    + f_ac (Ja_i Jc_j + Jc_i Ja_j)
//                    + f_bc (Jb_i Jc_j + Jc_i Jb_j) + f_bb Jb_i Jb_j ]
//
// with the second partials of (a/b - 1) c: f_ab = -c/b^2, f_ac = 1/b,
// f_bb = 2ac/b^3, f_bc = -a/b^2. Then G[s, rows[i], rows[j]] += Z_ij.
//
// What bounds it on an H100: f64 arithmetic once the J operands are in
// shared memory. Per scenario and group it does about 17 k^2 T_g flops on
// 6 k T_g gathered J values; at the flagship OIS slice (six curve groups,
// k = 32, 32, 32, 12, 12, 12, T_g = 415 each, 54 scenarios per risk
// chunk) that is 1.33 GFLOP on 142 MB of gathers per chunk, against
// about 34 TFLOP/s of f64 FMA outside the tensor cores. The gathers are
// scattered (trip columns of J rows that lie n_grid apart), so they are
// done once per tile into shared memory and reused by 16 threads each.
// Design: a block owns one 16 x 16 tile of (i, j) for one scenario. It
// walks the group's trips in tiles of 32: the block loads the four trip
// coefficients and the 16 x 32 operand tiles of Ja, Jb, Jc for its i
// rows and its j rows into shared memory (rows padded to 33 doubles so
// the 16 j-lanes hit different banks), then every thread accumulates its
// (i, j) entry over the tile, in the same fixed trip order. One launch
// per group, in stream order on the caller's stream: groups that share
// quote rows accumulate into G without races, and each (s, i, j) of a
// launch is written by one thread only, so the result is deterministic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;   // i (and j) rows per block
constexpr int kTrips = 32;  // trips per shared-memory tile
constexpr int kPad = kTrips + 1;

__global__ void gamma_group_kernel(const double* __restrict__ J,
                                   const double* __restrict__ dfs, int N,
                                   int n_grid,
                                   const int* __restrict__ s_idx,
                                   const int* __restrict__ e_idx,
                                   const int* __restrict__ p_idx,
                                   const double* __restrict__ w, int T,
                                   const int* __restrict__ rows, int k,
                                   double* __restrict__ G) {
  __shared__ double sAi[kTile][kPad], sBi[kTile][kPad], sCi[kTile][kPad];
  __shared__ double sAj[kTile][kPad], sBj[kTile][kPad], sCj[kTile][kPad];
  __shared__ double cab[kTrips], cac[kTrips], cbc[kTrips], cbb[kTrips];

  const int s = blockIdx.z;
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTile + tx;
  const double* Js = J + (int64_t)s * N * n_grid;
  const double* ds = dfs + (int64_t)s * n_grid;

  double acc = 0.0;
  for (int t0 = 0; t0 < T; t0 += kTrips) {
    if (tid < kTrips) {
      const int t = t0 + tid;
      double f_ab = 0.0, f_ac = 0.0, f_bc = 0.0, f_bb = 0.0;
      if (t < T) {
        const double a = ds[s_idx[t]];
        const double b = ds[e_idx[t]];
        const double c = ds[p_idx[t]];
        const double wt = w[t];
        f_ab = wt * (-c / (b * b));
        f_ac = wt * (1.0 / b);
        f_bb = wt * (2.0 * a * c / (b * b * b));
        f_bc = wt * (-a / (b * b));
      }
      cab[tid] = f_ab;
      cac[tid] = f_ac;
      cbc[tid] = f_bc;
      cbb[tid] = f_bb;
    }
    for (int e = tid; e < kTile * kTrips; e += kTile * kTile) {
      const int r = e / kTrips;
      const int tt = e % kTrips;
      const int t = t0 + tt;
      double ai = 0.0, bi = 0.0, ci = 0.0, aj = 0.0, bj = 0.0, cj = 0.0;
      if (t < T) {
        const int cs = s_idx[t], ce = e_idx[t], cp = p_idx[t];
        if (i0 + r < k) {
          const double* Jr = Js + (int64_t)rows[i0 + r] * n_grid;
          ai = Jr[cs];
          bi = Jr[ce];
          ci = Jr[cp];
        }
        if (j0 + r < k) {
          const double* Jr = Js + (int64_t)rows[j0 + r] * n_grid;
          aj = Jr[cs];
          bj = Jr[ce];
          cj = Jr[cp];
        }
      }
      sAi[r][tt] = ai;
      sBi[r][tt] = bi;
      sCi[r][tt] = ci;
      sAj[r][tt] = aj;
      sBj[r][tt] = bj;
      sCj[r][tt] = cj;
    }
    __syncthreads();
#pragma unroll 4
    for (int tt = 0; tt < kTrips; ++tt) {
      const double Ai = sAi[ty][tt], Bi = sBi[ty][tt], Ci = sCi[ty][tt];
      const double Aj = sAj[tx][tt], Bj = sBj[tx][tt], Cj = sCj[tx][tt];
      acc += cab[tt] * (Ai * Bj + Bi * Aj) + cac[tt] * (Ai * Cj + Ci * Aj)
             + cbc[tt] * (Bi * Cj + Ci * Bj) + cbb[tt] * (Bi * Bj);
    }
    __syncthreads();
  }
  const int i = i0 + ty, j = j0 + tx;
  if (i < k && j < k) {
    G[(int64_t)s * N * N + (int64_t)rows[i] * N + rows[j]] += acc;
  }
}

}  // namespace

// Adds one trip group's block into G [S, N, N] on `stream`. J is
// [S, N, n_grid] and dfs [S, n_grid], both contiguous f64. Returns the
// cudaError_t of the launch.
extern "C" int gamma_group_f64(const double* J, const double* dfs, int S,
                               int N, int n_grid, const int* s_idx,
                               const int* e_idx, const int* p_idx,
                               const double* w, int T, const int* rows,
                               int k, double* G, cudaStream_t stream) {
  if (S <= 0 || T <= 0 || k <= 0) return 0;
  dim3 block(kTile, kTile);
  dim3 grid((k + kTile - 1) / kTile, (k + kTile - 1) / kTile, S);
  gamma_group_kernel<<<grid, block, 0, stream>>>(
      J, dfs, N, n_grid, s_idx, e_idx, p_idx, w, T, rows, k, G);
  return (int)cudaGetLastError();
}
