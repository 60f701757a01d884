// K3: term 1 of the per-trade gammas, one k x k block per trade (f64),
// every group of a call in one launch.
//
// Replaces adrates_tpu/parallel/pertrade_blocks.py:316-363 (the per-slot
// quad form of a signature group's trades, k-wide) and
// adrates_tpu/parallel/multibook.py:2693-2753 (the grouped [N, K] @ [K, N]
// form of the selected trades, N-wide).
//
// An item is one trade of one group; the group owns k quote rows and the
// item its slots of (s_idx, e_idx, p_idx), with weight w[order[slot]].
// With a = dfs[s], b = dfs[e], c = dfs[p] and Jt the [n_grid, N]
// transposed curve jacobian:
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
// What bounds it on an H100: bytes. The needed bytes are the slot table,
// the Jt values the items need (each once), the DFs and the output written
// once, over 3.35 TB/s; the flops, 4 k^2 per slot, take less than that
// time on the FP64 tensor cores (67 TFLOP/s). On the 256 selected
// trades (k = 184) the 69.3 MB output is 92% of the bytes; chip_smoke.py
// computes both bounds from each path's tables and PERF.md holds the
// numbers of a run. The first version gathered an item's Jt values once
// per 32 x 32 output tile (21 times at k = 184), multiplied on the CUDA
// cores and wrote each mirror tile with a stride of k across a warp.
//
// Design: one block of 16 warps per pack, packs ordered by work, largest
// first (the host builds them). A pack is one unit or several; a unit is
// an item whole (up to 184 rows: 144 tiles of 16 x 8, kTPW = 9 a warp),
// or one pair of an item's row chunks (the symmetric block of one chunk,
// or the block of two chunks and its mirror). The host cuts an item into
// chunks only where it is wider or its work exceeds the launch's mean per
// SM: a block that owned flagship_v5's 240-slot k = 184 item whole was
// the launch's critical path (scripts/k3_phases.py; PERF.md). Every other
// item's Jt values are gathered once per item, a cut item's once per
// unit, from the L2. Small units are packed several to a block (at most
// kRowsMax staged rows and 16 warps), each on a range of warps sized to
// its tiles, so a k = 12 item takes one warp, not a block.
// The block loads its staged rows (a host table) and its units' slot
// columns and coefficients (a/b, w/b, c/b, the weight read through
// `order`) for up to kMeta slots into shared memory, then walks them in
// segments of kSeg = 16 slots per unit. For each segment it gathers Jt at
// the slots' three columns for every staged row by cp.async into a ring
// of 2 to 4 stages (as many as shared memory holds for the block's rows),
// so later segments' gathers fly while one is multiplied: slot-major,
// each thread a fixed pair of adjacent rows, 16 bytes at once where the
// two quote rows are adjacent in Jt (every row of the selected trades),
// else 8. It then forms w X and Y row-major (row stride kSeg + 4 doubles,
// so the fragment loads of a half-warp hit distinct banks; the pass reads
// and writes in 4 x 4 patches for the same reason). The products run on
// the FP64 tensor cores: mma.sync m16n8k16 for a full segment and m16n8k4
// steps for a unit's last, both twice the rate of m8n8k4 on an H100
// (scripts/k3_phases.py), and one product a tile and term per full
// segment keeps each accumulator's chain of dependent products short. A
// tile is 16 rows x 8 columns of the unit's block, every such tile that
// reaches the upper triangle; each warp owns a contiguous run of them
// (row-major, so consecutive tiles share their A fragments) and
// accumulates (wX)_I Y_J^T, then Y_I (wX)_J^T, in registers. Epilogue:
// each finished 8 x 8 half passes through a per-warp buffer in shared
// memory, so it and its mirror both leave as 64-byte row segments (the
// mirror's rows are its columns), 16 bytes a lane. A diagonal 8 x 8
// writes its upper triangle and mirrors it, so the block is exactly
// symmetric, bit for bit. Every output entry is written once (zeros
// included, as for an item with no slot): no atomics, no memset,
// deterministic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kSeg = 16;                // slots per unit and segment
constexpr int kLd = kSeg + 4;           // w X and Y row stride (doubles)
constexpr int kTPW = 9;                 // most 16 x 8 tiles a warp holds
constexpr int kRowsMax = 192;           // most staged rows in a block
constexpr int kUnits = kWarps;          // most units in a block
constexpr int kMeta = 512;              // (unit, slot) entries loaded at once
constexpr int kStagesMax = 4;
constexpr int kCols = 13;               // columns of the unit table
constexpr int kBufLd = 9;               // epilogue buffer row stride
constexpr int kSmem = 232448;           // an H100 block's shared memory
// bytes before w X, Y and the stages: the slot coefficients [3][kMeta]
// (doubles), then as ints their DF columns [3][kMeta], each row's Jt
// column and unit [kRowsMax] and each unit's slot range [kUnits]
constexpr int kFixed = 8 * 3 * kMeta + 4 * (3 * kMeta + 2 * kRowsMax
                                            + 2 * kUnits);

// slot stride of a stage: at least `rows`, even (16-byte row pairs) and
// 4 mod 16 doubles (the 4 x 4 patches of the w X / Y pass hit distinct
// banks)
__host__ __device__ constexpr int slot_stride(int rows) {
  return rows + ((rows & 15) == 0 ? 4 : 12);
}

// stages of [3][kSeg][slot_stride] doubles (a, b, c) that fit beside the
// fixed part and w X, Y [2][rows][kLd], at most kStagesMax
__host__ __device__ constexpr int stage_count(int rows) {
  return (kSmem - kFixed - 16 * rows * kLd)
                     / (24 * kSeg * slot_stride(rows)) > kStagesMax
             ? kStagesMax
             : (kSmem - kFixed - 16 * rows * kLd)
                   / (24 * kSeg * slot_stride(rows));
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most n (1..3) committed groups are pending
__device__ __forceinline__ void cp_async_wait(int n) {
  if (n >= 3) {
    asm volatile("cp.async.wait_group 3;\n" ::);
  } else if (n == 2) {
    asm volatile("cp.async.wait_group 2;\n" ::);
  } else {
    asm volatile("cp.async.wait_group 1;\n" ::);
  }
}

// d += A B for one 16 x 8 x 4 f64 step: lane holds A[lane/4][lane%4] in
// a0 and A[lane/4 + 8][lane%4] in a1, B[lane%4][lane/4], and
// D[lane/4][2 (lane%4) + {0, 1}] in d0, d1, D[lane/4 + 8][...] in d2, d3.
__device__ __forceinline__ void dmma16(double* d, double a0, double a1,
                                       double b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(b));
}

// d += A B for one 16 x 8 x 16 f64 step: lane holds
// A[lane/4 + 8 (r % 2)][lane%4 + 4 (r / 2)] in a[r], B[lane%4 + 4 r][lane/4]
// in b_r, D as in dmma16.
__device__ __forceinline__ void dmma16x16(double* d, const double* a,
                                          double b0, double b1, double b2,
                                          double b3) {
  asm("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7, %8, %9, %10, %11}, "
      "{%12, %13, %14, %15}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
        "d"(a[6]), "d"(a[7]), "d"(b0), "d"(b1), "d"(b2), "d"(b3));
}

// a unit row: (item, a0, na, b0, nb, row_off, warp0, n_warps, lo, hi,
// qoff, k, ioff): the item's rows [a0, a0 + na) against [b0, b0 + nb), or
// with nb = 0 the symmetric block of [a0, a0 + na); staged from block row
// row_off (chunk a padded to 16, then chunk b padded to 8); tiles on warps
// [warp0, warp0 + n_warps); slots [lo, hi); the group's quote rows at
// qrows[qoff ..), k of them; the item's block at out[ioff].
struct Unit {
  int a0, na, b0, nb, row_off;
  __device__ explicit Unit(const int* u)
      : a0(u[1]), na(u[2]), b0(u[3]), nb(u[4]), row_off(u[5]) {}
  __device__ int kpa() const { return (na + 15) & ~15; }
  // the item's row at local staged row i, or -1 for padding
  __device__ int row(int i) const {
    const int kp = kpa();
    if (i < kp) return i < na ? a0 + i : -1;
    return i - kp < nb ? b0 + i - kp : -1;
  }
};

__global__ void __launch_bounds__(kThreads, 1)
pertrade_quad_kernel(const double* __restrict__ Jt, int N,
                     const double* __restrict__ dfs,
                     const double* __restrict__ w,
                     const int64_t* __restrict__ order,
                     const int* __restrict__ packs,
                     const int* __restrict__ units,
                     const int* __restrict__ prows,
                     const int* __restrict__ s_idx,
                     const int* __restrict__ e_idx,
                     const int* __restrict__ p_idx,
                     double* __restrict__ out) {
  extern __shared__ __align__(16) double smem[];
  double* coef = smem;                         // [3][kMeta]
  int* cols = reinterpret_cast<int*>(coef + 3 * kMeta);   // [3][kMeta]
  int* rowq = cols + 3 * kMeta;                // [kRowsMax]: -1 = pad
  int* rowu = rowq + kRowsMax;                 // [kRowsMax]
  int* ulo = rowu + kRowsMax;                  // [kUnits]
  int* uhi = ulo + kUnits;

  const int* pk = packs + 5 * blockIdx.x;
  const int u0 = pk[0], nu = pk[1] - pk[0], nseg = pk[2], nR = pk[3];
  const int* ut = units + kCols * u0;
  const int ns = stage_count(nR), S = slot_stride(nR);
  double* X = smem + kFixed / 8;               // [nR][kLd]: w X
  double* Y = X + nR * kLd;                    // [nR][kLd]
  double* raw = Y + nR * kLd;                  // [ns][3][kSeg][S]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, q4 = lane & 3;

  // slot chunk c0's columns and coefficients: entry (u * mn + j) * kSeg + t
  // is unit u's slot t of chunk segment j
  auto load_meta = [&](int c0, int mn) {
    for (int e = tid; e < nu * mn * kSeg; e += kThreads) {
      const int u = e / (mn * kSeg);
      const int sl = ut[kCols * u + 8] + c0 * kSeg + e - u * mn * kSeg;
      int cs = 0, ce = 0, cp = 0;
      double ra = 0.0, rw = 0.0, rc = 0.0;
      if (sl < ut[kCols * u + 9]) {
        cs = s_idx[sl];
        ce = e_idx[sl];
        cp = p_idx[sl];
        const double b = dfs[ce];
        ra = dfs[cs] / b;
        rw = w[order[sl]] / b;
        rc = dfs[cp] / b;
      }
      cols[e] = cs;
      cols[kMeta + e] = ce;
      cols[2 * kMeta + e] = cp;
      coef[e] = ra;
      coef[kMeta + e] = rw;
      coef[2 * kMeta + e] = rc;
    }
  };
  const int mc = kMeta / (nu * kSeg);          // segments per chunk
  // the staged rows' loads fly under the first chunk's (a thread a row:
  // nR <= kRowsMax < kThreads)
  int rq = -1, ru = 0;
  if (tid < nR) {
    rq = prows[2 * (pk[4] + tid)];
    ru = prows[2 * (pk[4] + tid) + 1];
  }
  load_meta(0, min(mc, nseg));
  if (tid < nu) {
    ulo[tid] = ut[kCols * tid + 8];
    uhi[tid] = ut[kCols * tid + 9];
  }
  if (tid < nR) {
    rowq[tid] = rq;
    rowu[tid] = ru;
  }

  // this warp's unit and its run of `mine` 16 x 8 tiles from (I0, J0):
  // I in 16-row tiles of chunk a, J in 8-row tiles of the staged rows;
  // row by row, J from 2 I (every tile reaching the upper triangle) for a
  // symmetric unit, over chunk b for a pair; `advance` steps to the next
  int myu = -1;
  for (int u = 0; u < nu; ++u) {
    const int* p = ut + kCols * u;
    if (warp >= p[6] && warp < p[6] + p[7]) myu = u;
  }
  double acc[kTPW][4];
#pragma unroll
  for (int idx = 0; idx < kTPW; ++idx) {
    acc[idx][0] = acc[idx][1] = acc[idx][2] = acc[idx][3] = 0.0;
  }
  int mine = 0, row_off = 0, jlo = 0, jend = 1, I0 = 0, J0 = 0;
  bool sym = true;
  if (myu >= 0) {
    const int* p = ut + kCols * myu;
    const Unit un(p);
    sym = un.nb == 0;
    row_off = un.row_off;
    const int nI = un.kpa() / 16;
    int nUp;
    if (sym) {
      jend = (un.na + 7) / 8;
      jlo = 0;
      nUp = 0;
      for (int I = 0; I < nI; ++I) nUp += max(0, jend - 2 * I);
    } else {
      jlo = un.kpa() / 8;
      jend = jlo + (un.nb + 7) / 8;
      nUp = nI * (jend - jlo);
    }
    const int per = (nUp + p[7] - 1) / p[7];
    const int m0 = (warp - p[6]) * per;
    mine = max(0, min(per, nUp - m0));
    int m = m0;
    if (sym) {
      while (I0 < nI && m >= jend - 2 * I0) {
        m -= jend - 2 * I0;
        ++I0;
      }
      J0 = 2 * I0 + m;
    } else {
      I0 = m / (jend - jlo);
      J0 = jlo + m % (jend - jlo);
    }
  }
  auto advance = [&](int& I, int& J) {
    if (++J == jend) {
      ++I;
      J = sym ? 2 * I : jlo;
    }
  };
  __syncthreads();                     // rows and the first chunk visible

  // this thread's pair of staged rows for the gathers (slot-major, a
  // stage's slot t holds rows [t * S, t * S + nR)) and its first slot
  const int nP = nR / 2, tstep = kThreads / nP;
  const int ip = tid % nP, t0 = tid / nP < tstep ? tid / nP : kSeg;
  const int gu = rowu[2 * ip], gq0 = rowq[2 * ip], gq1 = rowq[2 * ip + 1];

  for (int c0 = 0; c0 < nseg; c0 += mc) {
    const int mn = min(mc, nseg - c0);
    if (c0 > 0) {
      load_meta(c0, mn);
      __syncthreads();
    }
    // chunk segment j's gathers into stage j % ns: Jt at its slots'
    // columns for every staged row of a live slot
    auto issue = [&](int j) {
      double* rs = raw + (j % ns) * 3 * kSeg * S + 2 * ip;
      const int nv = uhi[gu] - ulo[gu] - (c0 + j) * kSeg;
      for (int t = t0; t < min(kSeg, nv); t += tstep) {
        const int m = (gu * mn + j) * kSeg + t;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          double* d = rs + (a * kSeg + t) * S;
          const double* src = Jt + (int64_t)cols[a * kMeta + m] * N;
          if (gq0 >= 0 && gq1 == gq0 + 1
              && ((uintptr_t)(src + gq0) & 15) == 0) {
            cp_async16(d, src + gq0);
          } else {
            if (gq0 >= 0) cp_async8(d, src + gq0);
            if (gq1 >= 0) cp_async8(d + 1, src + gq1);
          }
        }
      }
    };
    for (int j = 0; j < ns - 1; ++j) {
      if (j < mn) issue(j);
      cp_async_commit();
    }
    for (int j = 0; j < mn; ++j) {
      if (j + ns - 1 < mn) issue(j + ns - 1);
      cp_async_commit();
      cp_async_wait(ns - 1);           // segment j has landed
      __syncthreads();
      // w X and Y of the live slots (zeros up to the next 4): a half-warp
      // takes 4 slots x 4 rows, a thread one slot t of every 32nd row,
      // with its unit's coefficients of t kept while the unit lasts
      const double* rs = raw + (j % ns) * 3 * kSeg * S;
      {
        const int t = ((tid >> 2) & 12) | (tid & 3);
        int up = -1, nv = 0;
        double ca = 0.0, cw = 0.0, cc = 0.0;
        for (int i = ((tid >> 6) << 2) | ((tid >> 2) & 3); i < nR; i += 32) {
          const int u = rowu[i];
          if (u != up) {
            up = u;
            nv = uhi[u] - ulo[u] - (c0 + j) * kSeg;
            if (t < nv) {
              const int m = (u * mn + j) * kSeg + t;
              ca = coef[m];
              cw = coef[kMeta + m];
              cc = coef[2 * kMeta + m];
            }
          }
          if (t < nv) {
            const double jb = rs[(kSeg + t) * S + i];
            X[i * kLd + t] = (rs[t * S + i] - ca * jb) * cw;
            Y[i * kLd + t] = rs[(2 * kSeg + t) * S + i] - cc * jb;
          } else if (t < ((nv + 3) & ~3)) {
            X[i * kLd + t] = 0.0;
            Y[i * kLd + t] = 0.0;
          }
        }
      }
      __syncthreads();
      if (mine > 0) {
        const int nv = min(kSeg, uhi[myu] - ulo[myu] - (c0 + j) * kSeg);
        const double* Xw = X + row_off * kLd + q4;
        const double* Yw = Y + row_off * kLd + q4;
        if (nv == kSeg) {
          // a full segment: one 16-slot step a tile and term, so each
          // accumulator waits on two products a segment, not eight
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const double* A = h ? Yw : Xw;
            const double* B = h ? Xw : Yw;
            int I = I0, J = J0, Ip = -1;
            double a[8];
#pragma unroll
            for (int idx = 0; idx < kTPW; ++idx) {
              if (idx < mine) {
                if (I != Ip) {
#pragma unroll
                  for (int r = 0; r < 8; ++r) {
                    a[r] = A[(I * 16 + grp + 8 * (r & 1)) * kLd
                             + 4 * (r >> 1)];
                  }
                  Ip = I;
                }
                const double* b = B + (J * 8 + grp) * kLd;
                dmma16x16(acc[idx], a, b[0], b[4], b[8], b[12]);
                advance(I, J);
              }
            }
          }
        }
        for (int kk = 0; kk < (nv == kSeg ? 0 : nv); kk += 4) {
          // (wX)_I Y_J^T over the run, then Y_I (wX)_J^T
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const double* A = h ? Yw : Xw;
            const double* B = h ? Xw : Yw;
            int I = I0, J = J0, Ip = -1;
            double a0 = 0.0, a1 = 0.0;
#pragma unroll
            for (int idx = 0; idx < kTPW; ++idx) {
              if (idx < mine) {
                if (I != Ip) {
                  const int o = (I * 16 + grp) * kLd + kk;
                  a0 = A[o];
                  a1 = A[o + 8 * kLd];
                  Ip = I;
                }
                dmma16(acc[idx], a0, a1, B[(J * 8 + grp) * kLd + kk]);
                advance(I, J);
              }
            }
          }
        }
      }
      __syncthreads();                 // stage j % ns and X, Y free
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();                     // coefficients free for the buffers

  if (mine > 0) {
    const int* p = ut + kCols * myu;
    const Unit un(p);
    const int64_t k = p[11];
    double* blk = out + p[12];
    double* buf = coef + warp * 8 * kBufLd;
    // entries (row, col) and (row, col + 1) of the block: one 16-byte
    // store where both are live, adjacent and aligned
    auto store2 = [&](int row, int col, int col1, double v0, double v1) {
      if (row < 0 || col < 0) return;
      double* d = blk + row * k + col;
      if (col1 == col + 1 && ((uintptr_t)d & 15) == 0) {
        *reinterpret_cast<double2*>(d) = make_double2(v0, v1);
      } else {
        *d = v0;
        if (col1 >= 0) blk[row * k + col1] = v1;
      }
    };
    // lane: row r of an 8 x 8 half, columns c and c + 1
    const int r = lane >> 2, c = 2 * (lane & 3);
    int I2 = I0, J = J0;
#pragma unroll
    for (int idx = 0; idx < kTPW; ++idx) {
      if (idx < mine) {
        const int ci = un.row(J * 8 + c), ci1 = un.row(J * 8 + c + 1);
        const int rj = un.row(J * 8 + r);
        // the tile's two 8 x 8 halves: rows 16 I2 + 8 h of the block
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int I = 2 * I2 + h;
          if (sym && I > J) continue;            // below the diagonal
          const bool diag = sym && I == J;
          buf[grp * kBufLd + 2 * q4] = acc[idx][2 * h];
          buf[grp * kBufLd + 2 * q4 + 1] = acc[idx][2 * h + 1];
          __syncwarp();
          // the half (I, J), its lower entries mirrored on the diagonal,
          // then its mirror (J, I): each row leaves as 64 bytes
          store2(un.row(I * 8 + r), ci, ci1,
                 diag && r > c ? buf[c * kBufLd + r] : buf[r * kBufLd + c],
                 diag && r > c + 1 ? buf[(c + 1) * kBufLd + r]
                                   : buf[r * kBufLd + c + 1]);
          if (!diag) {
            store2(rj, un.row(I * 8 + c), un.row(I * 8 + c + 1),
                   buf[c * kBufLd + r], buf[(c + 1) * kBufLd + r]);
          }
          __syncwarp();
        }
        advance(I2, J);
      }
    }
  }
}

}  // namespace

// out (flat; item i's k x k block row-major at its ioff) = every item's
// term-1 block. packs [n_packs, 5] (first unit, end unit, segments, staged
// rows, first row in prows), prows [sum of staged rows, 2] (each staged
// row's Jt column or -1 for padding, and its unit in the pack) and units
// [n_units, 13] as in the kernel, largest pack first;
// rows_max the most staged rows of a pack (a multiple of 8, at most
// kRowsMax); Jt [n_grid, N] row-major; w the slot weights in the caller's
// slot order, order[slot] the caller's index of each. Returns the
// cudaError_t of the launch.
extern "C" int pertrade_quad_f64(const double* Jt, int N, const double* dfs,
                                 const double* w, const int64_t* order,
                                 const int* packs, int n_packs, int rows_max,
                                 const int* units, const int* prows,
                                 const int* s_idx, const int* e_idx,
                                 const int* p_idx, double* out,
                                 cudaStream_t stream) {
  if (n_packs <= 0) return 0;
  if (rows_max <= 0 || rows_max > kRowsMax || rows_max % 8) {
    return (int)cudaErrorInvalidValue;
  }
  static_assert(stage_count(kRowsMax) >= 2, "two stages of kRowsMax rows");
  // per call: the limit is a property of the current device
  const cudaError_t err = cudaFuncSetAttribute(
      pertrade_quad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (err != cudaSuccess) return (int)err;
  pertrade_quad_kernel<<<n_packs, kThreads, kSmem, stream>>>(
      Jt, N, dfs, w, order, packs, units, prows, s_idx, e_idx, p_idx, out);
  return (int)cudaGetLastError();
}
