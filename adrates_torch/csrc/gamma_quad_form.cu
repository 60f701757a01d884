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
//   P = Z + Z^T,  Z = (X w) Y^T,
//   X_it = (Ja_i - (a/b) Jb_i) / b,   Y_it = Jc_i - (c/b) Jb_i,
//
// the trip value (a/b - 1) c's second differential 2 du (dc - (c/b) db)
// with du = (da - (a/b) db)/b: the JAX package's four products f_ab, f_ac,
// f_bc, f_bb regrouped, so that the near-cancelling Ja and Jb of a short
// accrual period cancel once, in X. Then G[s, rows[i], rows[j]] += P_ij.
//
// What bounds it on an H100: bytes. Each needed J value read once and G
// written once is, at the flagship OIS slice (S = 100, 6 groups of k = 12
// or 32, 415 trips each), 75 MB of J + 17 MB of G = 92 MB, 28 us at
// 3.35 TB/s; on the OIS + XCCY book (9 groups, k up to 72, 281,232 needed
// J values per scenario) 225 + 23 MB, 74 us. The flops, 4 k^2 T_g per
// group and scenario (5.8e8 and 3.1e9), take 9 and 47 us on the FP64
// tensor cores (67 TFLOP/s). The earlier design gathered every needed J
// value 2 ceil(k/16) times (6-12x the needed values, 1.8-10 GB of 32-byte
// sectors per call), multiplied on the CUDA cores and ran one launch per
// group.
//
// Design: launch 1 runs one block of 256 threads per (work item,
// scenario), items ordered largest first (blockIdx.y walks the host's
// `items`, blockIdx.x the scenarios). An item is a group whole when it is
// at most kKMax = 80 rows wide (every group of the flagship books, the
// widest 72), else one pair of its kKMax / 2-row chunks: the symmetric
// block of one chunk, or the block of two chunks and its mirror. So any
// width runs, and an item gathers at most kKMax rows: wider items would
// leave each warp more tiles' sums to hold in registers, which spill at
// two blocks per SM and measured slower. The block takes the item's trips
// in segments of kSeg = 256: their J columns and coefficients (a/b, 1/b,
// c/b, w) go to shared memory once, so the gathers that follow issue
// without waiting on an index load. For each tile of kTT = 16 trips
// (each group's trips sorted by column on the host, so a tile's gathers
// share sectors) the block gathers Ja, Jb, Jc of ALL the item's rows once,
// by 8-byte cp.async into one of two raw stages, so the next tile's
// gathers fly while this tile is multiplied; then it forms X w and Y for
// those rows (each chunk padded to a multiple of 8) in shared memory (row
// stride kTT + 4 doubles, so the 8 x 4 fragment loads hit distinct banks). The products run on the FP64
// tensor cores (mma.sync m8n8k4 f64): warp w owns the 8 x 8 tiles w,
// w + 8, ... of the item's upper triangle (I <= J; for a chunk pair all
// of chunk a x chunk b) and accumulates P_IJ = (Xw)_I Y_J^T + Y_I (Xw)_J^T
// in registers, so only the upper triangle is multiplied; the epilogue
// writes P_IJ and its mirror P_JI to the group's k x k slot of a partial
// buffer [S, sum k^2].
// XCCY groups share their parents' quote rows, so blocks of different
// groups land on the same G entries. Option taken: a partial buffer and a
// second, fixed-order pass (launch 2: one thread per G entry and
// scenario sums that entry's partials in group order and writes it, zeros
// included) rather than colour sets of row-disjoint groups: it keeps
// every group of a call in one launch whatever the overlap (the sets
// would run in series, the USD rows alone forcing four on the XCCY book),
// costs 2 launches on every book, needs no zero-fill of G, and is
// deterministic (no atomics; each output is one thread's ordered sum).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTT = 16;                 // trips per tile
constexpr int kSeg = 256;               // trips per staged segment
constexpr int kLd = kTT + 4;            // X / Y row stride (doubles)
constexpr int kKMax = 80;               // most rows an item gathers
constexpr int kNTMax = kKMax / 8;
constexpr int kUpMax = kNTMax * (kNTMax + 1) / 2;
constexpr int kTPW = (kUpMax + kWarps - 1) / kWarps;   // tiles per warp

// doubles of shared memory for items of up to kp (padded) rows: two raw
// stages [3][kp][kTT], X w and Y [kp][kLd], the segment's trip
// coefficients [4][kSeg], then (as ints) its trip columns [3][kSeg] and
// the rows [kp]
__host__ __device__ constexpr int smem_doubles(int kp) {
  return 2 * 3 * kp * kTT + 2 * kp * kLd + 4 * kSeg
         + (3 * kSeg + kp + 1) / 2;
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// d += A B for one 8 x 8 x 4 f64 step: lane holds A[lane/4][lane%4],
// B[lane%4][lane/4] and D[lane/4][2 (lane%4) + {0, 1}].
__device__ __forceinline__ void dmma(double& d0, double& d1, double a,
                                     double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1}, {%2}, {%3}, {%0, %1};\n"
      : "+d"(d0), "+d"(d1)
      : "d"(a), "d"(b));
}

__global__ void __launch_bounds__(kThreads, 2)
gamma_groups_kernel(const double* __restrict__ J,
                    const double* __restrict__ dfs, int N, int n_grid,
                    const int* __restrict__ items,
                    const int* __restrict__ tptr,
                    const int* __restrict__ s_idx,
                    const int* __restrict__ e_idx,
                    const int* __restrict__ p_idx,
                    const double* __restrict__ w,
                    const int* __restrict__ rptr,
                    const int* __restrict__ rows, int n_part,
                    const int* __restrict__ poff,
                    double* __restrict__ part) {
  extern __shared__ __align__(16) double smem[];
  const int s = blockIdx.x;
  // item (g, a0, na, b0, nb): group g's rows [a0, a0 + na) against
  // [b0, b0 + nb), or with nb = 0 the symmetric block of [a0, a0 + na).
  // Local rows: chunk a padded to 8, then chunk b padded to 8.
  const int* item = items + 5 * blockIdx.y;
  const int g = item[0], a0 = item[1], na = item[2], b0 = item[3],
            nb = item[4];
  const bool sym = nb == 0;
  const int T0 = tptr[g], T = tptr[g + 1] - T0;
  const int R0 = rptr[g], k = rptr[g + 1] - R0;
  const int kpa = (na + 7) & ~7;
  const int kp = kpa + ((nb + 7) & ~7);
  const int nTa = kpa / 8, nT = kp / 8;
  const int nUp = sym ? nTa * (nTa + 1) / 2 : nTa * (nT - nTa);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, q4 = lane & 3;

  double* raw = smem;                          // [2][3][kp][kTT]
  double* xw = raw + 2 * 3 * kp * kTT;         // [kp][kLd]
  double* yv = xw + kp * kLd;                  // [kp][kLd]
  double* coef = yv + kp * kLd;                // [4][kSeg]: a/b, 1/b, c/b, w
  int* tcol = reinterpret_cast<int*>(coef + 4 * kSeg);   // [3][kSeg]
  int* trow = tcol + 3 * kSeg;                 // [kp]: J rows, -1 = pad
  const double* Js = J + (int64_t)s * N * n_grid;
  const double* ds = dfs + (int64_t)s * n_grid;

  // local row i's row of the group, or -1 for padding
  auto grow = [&](int i) {
    if (i < kpa) return i < na ? a0 + i : -1;
    return i - kpa < nb ? b0 + i - kpa : -1;
  };
  for (int i = tid; i < kp; i += kThreads) {
    const int r = grow(i);
    trow[i] = r < 0 ? -1 : rows[R0 + r];
  }

  // this warp's tiles, (I << 8) | J: the upper triangle of the symmetric
  // item's nTa x nTa tiles, or all of chunk a x chunk b
  int tile[kTPW];
  double acc[kTPW][2];
#pragma unroll
  for (int idx = 0; idx < kTPW; ++idx) {
    int m = warp + kWarps * idx, I = 0, Jt = 0;
    if (m < nUp) {
      if (sym) {
        while (m >= nTa - I) {
          m -= nTa - I;
          ++I;
        }
        Jt = I + m;
      } else {
        I = m / (nT - nTa);
        Jt = nTa + m % (nT - nTa);
      }
    }
    tile[idx] = (I << 8) | Jt;
    acc[idx][0] = acc[idx][1] = 0.0;
  }

  // gathers of tile c of the current segment (trip columns in shared
  // memory, so the copies issue without waiting on a load)
  auto issue = [&](int c, int nseg) {
    double* rs = raw + (c & 1) * 3 * kp * kTT;
    const int tb = c * kTT;
    for (int e = tid; e < kp * kTT; e += kThreads) {
      const int i = e / kTT, tt = e % kTT, t = tb + tt;
      double* d = rs + i * kTT + tt;
      if (trow[i] >= 0 && t < nseg) {
        const double* Jr = Js + (int64_t)trow[i] * n_grid;
        cp_async8(d, Jr + tcol[t]);
        cp_async8(d + kp * kTT, Jr + tcol[kSeg + t]);
        cp_async8(d + 2 * kp * kTT, Jr + tcol[2 * kSeg + t]);
      } else {
        d[0] = d[kp * kTT] = d[2 * kp * kTT] = 0.0;
      }
    }
  };

  for (int g0 = 0; g0 < T; g0 += kSeg) {
    const int nseg = min(kSeg, T - g0);
    __syncthreads();                   // the previous segment is done
    for (int t = tid; t < kSeg; t += kThreads) {
      double u = 0.0, ib = 0.0, cb = 0.0, wt = 0.0;
      int cs = 0, ce = 0, cp = 0;
      if (t < nseg) {
        cs = s_idx[T0 + g0 + t];
        ce = e_idx[T0 + g0 + t];
        cp = p_idx[T0 + g0 + t];
        const double b = ds[ce];
        u = ds[cs] / b;
        ib = 1.0 / b;
        cb = ds[cp] / b;
        wt = w[T0 + g0 + t];
      }
      tcol[t] = cs;
      tcol[kSeg + t] = ce;
      tcol[2 * kSeg + t] = cp;
      coef[t] = u;
      coef[kSeg + t] = ib;
      coef[2 * kSeg + t] = cb;
      coef[3 * kSeg + t] = wt;
    }
    __syncthreads();
    const int nTile = (nseg + kTT - 1) / kTT;
    issue(0, nseg);
    cp_async_commit();
    for (int c = 0; c < nTile; ++c) {
      if (c + 1 < nTile) issue(c + 1, nseg);
      cp_async_commit();
      cp_async_wait<1>();               // tile c has landed
      __syncthreads();
      const double* rs = raw + (c & 1) * 3 * kp * kTT;
      const double* cf = coef + c * kTT;
      for (int e = tid; e < kp * kTT; e += kThreads) {
        const int i = e / kTT, tt = e % kTT;
        const double ja = rs[i * kTT + tt];
        const double jb = rs[kp * kTT + i * kTT + tt];
        const double jc = rs[2 * kp * kTT + i * kTT + tt];
        const double x = (ja - cf[tt] * jb) * cf[kSeg + tt];
        xw[i * kLd + tt] = x * cf[3 * kSeg + tt];
        yv[i * kLd + tt] = jc - cf[2 * kSeg + tt] * jb;
      }
      __syncthreads();
#pragma unroll
      for (int idx = 0; idx < kTPW; ++idx) {
        if (warp + kWarps * idx < nUp) {
          const int I = tile[idx] >> 8, Jt = tile[idx] & 255;
          const double* a = xw + (I * 8 + grp) * kLd + q4;
          const double* ay = yv + (I * 8 + grp) * kLd + q4;
          const double* b = yv + (Jt * 8 + grp) * kLd + q4;
          const double* bx = xw + (Jt * 8 + grp) * kLd + q4;
#pragma unroll
          for (int kk = 0; kk < kTT; kk += 4) {
            dmma(acc[idx][0], acc[idx][1], a[kk], b[kk]);
            dmma(acc[idx][0], acc[idx][1], ay[kk], bx[kk]);
          }
        }
      }
      __syncthreads();
    }
  }
  cp_async_wait<0>();

  double* P = part + (int64_t)s * n_part + poff[g];
#pragma unroll
  for (int idx = 0; idx < kTPW; ++idx) {
    if (warp + kWarps * idx < nUp) {
      const int I = tile[idx] >> 8, Jt = tile[idx] & 255;
      const int i = grow(I * 8 + grp);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = grow(Jt * 8 + 2 * q4 + h);
        if (i >= 0 && j >= 0) {
          P[i * k + j] = acc[idx][h];
          if (!sym || I != Jt) P[j * k + i] = acc[idx][h];
        }
      }
    }
  }
}

__global__ void gamma_reduce_kernel(const double* __restrict__ part, int S,
                                    int n_part,
                                    const int* __restrict__ red_ptr,
                                    const int* __restrict__ red_src, int NN,
                                    double* __restrict__ G) {
  const int64_t total = (int64_t)S * NN;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += (int64_t)gridDim.x * blockDim.x) {
    const int s = (int)(e / NN), ent = (int)(e % NN);
    const double* ps = part + (int64_t)s * n_part;
    double sum = 0.0;
    for (int p = red_ptr[ent]; p < red_ptr[ent + 1]; ++p) sum += ps[red_src[p]];
    G[e] = sum;
  }
}

}  // namespace

// Launch 1: every (item, scenario) part of a group's block P = Z + Z^T
// into part[S, n_part] at poff[g] (row-major k x k). J is [S, N, n_grid]
// and dfs [S, n_grid], contiguous f64; items [n_items, 5] as in the
// kernel, item_rows the most local rows an item stages (its chunks each
// padded to 8; a multiple of 8, <= kKMax). Returns the cudaError_t of the
// launch.
extern "C" int gamma_groups_f64(const double* J, const double* dfs, int S,
                                int N, int n_grid, const int* items,
                                const int* tptr, const int* s_idx,
                                const int* e_idx, const int* p_idx,
                                const double* w, const int* rptr,
                                const int* rows, int n_items, int item_rows,
                                int n_part, const int* poff, double* part,
                                cudaStream_t stream) {
  if (S <= 0 || n_items <= 0) return 0;
  if (item_rows > kKMax || item_rows % 8 || n_items > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  // per call: the limit is a property of the current device
  const cudaError_t err = cudaFuncSetAttribute(
      gamma_groups_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(sizeof(double) * smem_doubles(kKMax)));
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(double) * smem_doubles(item_rows);
  dim3 grid(S, n_items);
  gamma_groups_kernel<<<grid, kThreads, smem, stream>>>(
      J, dfs, N, n_grid, items, tptr, s_idx, e_idx, p_idx, w, rptr, rows,
      n_part, poff, part);
  return (int)cudaGetLastError();
}

// Launch 2: G[s, e] = sum of part[s, red_src[red_ptr[e] .. red_ptr[e+1])]
// in table order, for every e < NN (zeros where no group reaches).
extern "C" int gamma_reduce_f64(const double* part, int S, int n_part,
                                const int* red_ptr, const int* red_src,
                                int NN, double* G, cudaStream_t stream) {
  if (S <= 0 || NN <= 0) return 0;
  const int64_t total = (int64_t)S * NN;
  const int64_t want = (total + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  gamma_reduce_kernel<<<blocks, kThreads, 0, stream>>>(part, S, n_part,
                                                       red_ptr, red_src, NN,
                                                       G);
  return (int)cudaGetLastError();
}
