// K1: the per-trade PV sweep over all scenarios (f64).
//
// Replaces adrates_tpu/parallel/multibook.py:_pvs_sweep (:1782-1835, the
// gather + weighted row-sum + trade gather part; the cap/floor clamp
// epilogue stays plain torch in the caller).
//
//   rowpv[r, s] = sum_l w[r, l] * vT[col_idx[r, l], s]     (per bucket)
//   pvs[b, s]   = sum_k rowpv[tri[b, k], s]
//
// vT is the [M, S] value table (DF grid columns, then the forward-trip
// values), contiguous, so a row holds all S scenarios of one column.
//
// What bounds it on an H100: memory traffic, not arithmetic (2 flops per
// 8-byte gathered value). At the flagship OIS slice (S = 100, M = 10,197
// value columns, 200,160 tiled rows in 8 buckets holding 5,197,488 padded
// slots, B = 100,080 trades) one sweep moves, in f64:
//   - the slot tables: 5.2e6 * (4 + 8) = 62 MB, read once per 32-scenario
//     tile (4 tiles; repeats are partly L2 hits);
//   - the gathered values: 5.2e6 * 100 * 8 = 4.2 GB of L2 -> SM traffic,
//     mostly L2 hits because vT itself is 10,197 * 100 * 8 = 8.2 MB,
//     well under the 50 MB L2 — this is the binding stream;
//   - rowpv: 200,160 * 100 * 8 = 160 MB written once and read once by
//     the trade pass;
//   - pvs: 100,080 * 100 * 8 = 80 MB written once.
// So device memory sees about 0.5-0.6 GB (>= 0.15 ms at 3.35 TB/s) and L2
// about 4.2 GB per sweep.
// Design: one thread per (row, scenario). The 32 lanes of a warp take 32
// consecutive scenarios of one row, so every gathered vT read is one
// coalesced 256-byte segment and the row's (col, w) slot pair is a
// broadcast load. No atomics: every output element is written by exactly
// one thread, so the result is deterministic. Rows and trades go on grid
// axis x (up to 2^31 - 1 blocks), scenario tiles on axis y.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;   // scenarios per block row (one warp)
constexpr int kRows = 8;     // rows (or trades) per block

__global__ void pvs_rows_kernel(const double* __restrict__ vT, int S,
                                const int* __restrict__ col_idx,
                                const double* __restrict__ w, int R, int L,
                                double* __restrict__ rowpv) {
  const int64_t r = (int64_t)blockIdx.x * kRows + threadIdx.y;
  const int s = blockIdx.y * kLanes + threadIdx.x;
  if (r >= R || s >= S) return;
  const int* ci = col_idx + r * L;
  const double* wi = w + r * L;
  double acc = 0.0;
  for (int l = 0; l < L; ++l) {
    acc += wi[l] * vT[(int64_t)ci[l] * S + s];
  }
  rowpv[r * S + s] = acc;
}

__global__ void pvs_trades_kernel(const double* __restrict__ rowpv, int S,
                                  const int* __restrict__ tri, int B, int K,
                                  double* __restrict__ out) {
  const int64_t b = (int64_t)blockIdx.x * kRows + threadIdx.y;
  const int s = blockIdx.y * kLanes + threadIdx.x;
  if (b >= B || s >= S) return;
  const int* tb = tri + b * K;
  double acc = 0.0;
  for (int k = 0; k < K; ++k) {
    acc += rowpv[(int64_t)tb[k] * S + s];
  }
  out[b * S + s] = acc;
}

}  // namespace

// Row pass for one column bucket: rowpv[R, S] (a slice of the caller's
// concatenated row table). Returns the cudaError_t of the launch.
extern "C" int pvs_rows_f64(const double* vT, int S, const int* col_idx,
                            const double* w, int R, int L, double* rowpv,
                            cudaStream_t stream) {
  if (R <= 0 || S <= 0) return 0;
  dim3 block(kLanes, kRows);
  dim3 grid((R + kRows - 1) / kRows, (S + kLanes - 1) / kLanes);
  pvs_rows_kernel<<<grid, block, 0, stream>>>(vT, S, col_idx, w, R, L,
                                              rowpv);
  return (int)cudaGetLastError();
}

// Trade pass: out[B, S] = sum over each trade's K row slots (dead slots
// point at the all-zero last row of rowpv).
extern "C" int pvs_trades_f64(const double* rowpv, int S, const int* tri,
                              int B, int K, double* out,
                              cudaStream_t stream) {
  if (B <= 0 || S <= 0) return 0;
  dim3 block(kLanes, kRows);
  dim3 grid((B + kRows - 1) / kRows, (S + kLanes - 1) / kLanes);
  pvs_trades_kernel<<<grid, block, 0, stream>>>(rowpv, S, tri, B, K, out);
  return (int)cudaGetLastError();
}
