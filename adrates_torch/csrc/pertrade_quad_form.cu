// K3: term 1 of the per-trade gammas, one k x k block per trade (f64),
// every group of a call in one launch.
//
// Replaces adrates_tpu/parallel/pertrade_blocks.py:316-363 (the per-slot
// quad form of a signature group's trades, k-wide) and
// adrates_tpu/parallel/multibook.py:2693-2753 (the grouped [N, K] @ [K, N]
// form of the selected trades, N-wide).
//
// A work item is one trade of one group; the group owns quote rows
// qrows[qptr[g] .. qptr[g+1]) (k of them) and the item its slots
// iptr[i] .. iptr[i+1] of (s_idx, e_idx, p_idx, w). With a = dfs[s],
// b = dfs[e], c = dfs[p] and Jt the [n_grid, N] transposed curve jacobian:
//
//   out_i = sum over the item's slots of w (X Y^T + Y X^T),
//   X = (Jt[s, rows] - (a/b) Jt[e, rows]) / b,
//   Y = Jt[p, rows] - (c/b) Jt[e, rows],
//
// the second differential 2 du (dc - (c/b) db), du = (da - (a/b) db)/b, of
// the trip value (a/b - 1) c. A trip slot carries its weight; an in-band
// cap/floor clamp slot is the same trip with weight w / ia (the caller
// computes it per call from the DFs; out of band it is 0). So the JAX
// package's four products f_ab, f_ac, f_bc, f_bb (and the clamp pairs uv,
// up, vp, vv) are this one rank-2 form.
//
// What bounds it on an H100: the needed bytes are the slot table, each
// item's distinct Jt rows k wide and the output written once (over
// 3.35 TB/s), against 4 k^2 flops per slot (over 67 TFLOP/s f64);
// chip_smoke.py computes both from each path's tables and PERF.md holds
// the numbers of a run. This first version is simple rather than fast: it
// gathers an item's Jt values once per 32 x 32 output tile, not once per
// item, and multiplies on the CUDA cores.
//
// Design: one block of 256 threads per (item, tile) of the upper triangle
// of the item's block (tiles I <= J of kT = 32 rows; the host orders them
// by slot count, largest first). The block streams the item's slots in
// chunks of kCS = 32: one thread per slot loads its three DFs and forms
// the coefficients a/b, w/b, c/b; then the block gathers Jt at the slot's
// three columns for the tile's 2 x 32 quote rows and stages w X and Y in
// shared memory. Thread (ty, tx) of the 16 x 16 grid accumulates the four
// entries (ty + 16 u, tx + 16 v) in registers, each term as
// x_i y_j + y_i x_j with plain (uncontracted) multiplies and adds, so an
// entry and its mirror are the same sum: the block is exactly symmetric.
// The epilogue writes the tile and, off the diagonal, its mirror. Every
// output entry is written once (zeros included): no atomics, no memset,
// deterministic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 32;                  // output tile edge
constexpr int kThreads = 256;           // 16 x 16 threads, 2 x 2 entries
constexpr int kH = kT / 2;
constexpr int kCS = 32;                 // slots per staged chunk

__device__ __forceinline__ double pair(double xi, double yj, double yi,
                                       double xj) {
  return __dadd_rn(__dmul_rn(xi, yj), __dmul_rn(yi, xj));
}

__global__ void __launch_bounds__(kThreads)
pertrade_quad_kernel(const double* __restrict__ Jt, int N,
                     const double* __restrict__ dfs,
                     const int* __restrict__ tiles,
                     const int* __restrict__ iptr,
                     const int* __restrict__ igrp,
                     const int* __restrict__ ioff,
                     const int* __restrict__ qptr,
                     const int* __restrict__ qrows,
                     const int* __restrict__ s_idx,
                     const int* __restrict__ e_idx,
                     const int* __restrict__ p_idx,
                     const double* __restrict__ w,
                     double* __restrict__ out) {
  __shared__ int rows[2 * kT];          // the tile's I rows, then its J rows
  __shared__ double xs[kCS][2 * kT];    // w X at those rows, per slot
  __shared__ double ys[kCS][2 * kT];    // Y
  __shared__ int cs[kCS], ce[kCS], cp[kCS];
  __shared__ double ra[kCS], rw[kCS], rc[kCS];   // a/b, w/b, c/b

  const int item = tiles[3 * blockIdx.x];
  const int i0 = tiles[3 * blockIdx.x + 1];
  const int j0 = tiles[3 * blockIdx.x + 2];
  const int g = igrp[item];
  const int q0 = qptr[g];
  const int k = qptr[g + 1] - q0;
  const int nI = min(kT, k - i0), nJ = min(kT, k - j0);
  const int tid = threadIdx.x;
  const int tx = tid % kH, ty = tid / kH;
  if (tid < 2 * kT) {
    const int r = tid < kT ? tid : tid - kT;
    const int n = tid < kT ? nI : nJ;
    const int off = tid < kT ? i0 : j0;
    rows[tid] = r < n ? qrows[q0 + off + r] : -1;
  }
  const int lo = iptr[item], hi = iptr[item + 1];
  double acc[2][2] = {{0.0, 0.0}, {0.0, 0.0}};

  for (int c0 = lo; c0 < hi; c0 += kCS) {
    const int n = min(kCS, hi - c0);
    __syncthreads();                    // previous chunk consumed
    if (tid < n) {
      const int sl = c0 + tid;
      const int s = s_idx[sl], e = e_idx[sl], p = p_idx[sl];
      const double b = dfs[e];
      cs[tid] = s;
      ce[tid] = e;
      cp[tid] = p;
      ra[tid] = dfs[s] / b;
      rw[tid] = w[sl] / b;
      rc[tid] = dfs[p] / b;
    }
    __syncthreads();
    for (int idx = tid; idx < n * 2 * kT; idx += kThreads) {
      const int sl = idx / (2 * kT), r = idx % (2 * kT);
      const int q = rows[r];
      double x = 0.0, y = 0.0;
      if (q >= 0) {
        const double ja = Jt[(int64_t)cs[sl] * N + q];
        const double jb = Jt[(int64_t)ce[sl] * N + q];
        const double jc = Jt[(int64_t)cp[sl] * N + q];
        x = (ja - ra[sl] * jb) * rw[sl];
        y = jc - rc[sl] * jb;
      }
      xs[sl][r] = x;
      ys[sl][r] = y;
    }
    __syncthreads();
    for (int sl = 0; sl < n; ++sl) {
      const double xi0 = xs[sl][ty], xi1 = xs[sl][ty + kH];
      const double yi0 = ys[sl][ty], yi1 = ys[sl][ty + kH];
      const double xj0 = xs[sl][kT + tx], xj1 = xs[sl][kT + tx + kH];
      const double yj0 = ys[sl][kT + tx], yj1 = ys[sl][kT + tx + kH];
      acc[0][0] = __dadd_rn(acc[0][0], pair(xi0, yj0, yi0, xj0));
      acc[0][1] = __dadd_rn(acc[0][1], pair(xi0, yj1, yi0, xj1));
      acc[1][0] = __dadd_rn(acc[1][0], pair(xi1, yj0, yi1, xj0));
      acc[1][1] = __dadd_rn(acc[1][1], pair(xi1, yj1, yi1, xj1));
    }
  }

  double* blk = out + ioff[item];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int i = ty + kH * u, j = tx + kH * v;
      if (i < nI && j < nJ) {
        blk[(int64_t)(i0 + i) * k + j0 + j] = acc[u][v];
        if (i0 != j0) blk[(int64_t)(j0 + j) * k + i0 + i] = acc[u][v];
      }
    }
  }
}

}  // namespace

// out (flat; item i's k x k block row-major at ioff[i]) = every item's
// term-1 block. tiles [n_tiles, 3] (item, i0, j0) with i0 <= j0 cover the
// upper triangle of every item's block; Jt [n_grid, N] row-major; w the
// slot weights in slot order. Returns the cudaError_t of the launch.
extern "C" int pertrade_quad_f64(const double* Jt, int N, const double* dfs,
                                 const int* tiles, int n_tiles,
                                 const int* iptr, const int* igrp,
                                 const int* ioff, const int* qptr,
                                 const int* qrows, const int* s_idx,
                                 const int* e_idx, const int* p_idx,
                                 const double* w, double* out,
                                 cudaStream_t stream) {
  if (n_tiles <= 0) return 0;
  pertrade_quad_kernel<<<n_tiles, kThreads, 0, stream>>>(
      Jt, N, dfs, tiles, iptr, igrp, ioff, qptr, qrows, s_idx, e_idx, p_idx,
      w, out);
  return (int)cudaGetLastError();
}
