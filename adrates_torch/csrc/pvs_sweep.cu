// K1: the per-trade sweep, one launch, in two layouts and two dtypes.
//
// Replaces adrates_tpu/parallel/multibook.py:_pvs_sweep (:1782-1835, the
// gather + weighted row-sum + trade gather part; the cap/floor clamp
// epilogue stays plain torch in the caller), and the per-trade ladder
// contraction of make_per_trade_delta_fn (:2842), in f64 and, for its
// dtype=float32 option (:2825-2829), in f32.
//
//   scenario-major (the PVs):      out[s, b] = sum_slots w * vT[col, s]
//   trade-major (the ladders):     out[b, n] = sum_slots w * vT[col, n]
//
// vT is the [M, S] (or [M, N]) value table (DF grid columns, then the
// forward-trip values; for the ladders Jv, the N quotes as its columns)
// with a row stride ld of whole 16-byte pieces, so every row starts on a
// 16-byte boundary. The slots come as a per-trade CSR (dead slots
// dropped, a trade's duplicate columns merged) over blocks of kTB
// consecutive trades in the book's own order; block k lists its distinct
// vT rows once (brow[bptr[k] .. bptr[k+1]), ascending) and a slot names
// its row by its index in that list (ascending within a trade). Both
// layouts read the same tables.
//
// What bounds it on an H100. Each input read once and the output written
// once is, at the flagship OIS slice (S = 100, 4,510,272 live slots, vT
// [10,197, 100], out [100,080, 100]), 143 MB, 43 us at 3.35 TB/s; at
// flagship_v5's ladders (N = 184, 4,776,000 slots, Jv [15,983, 184],
// out [100,400, 184]) 229 MB in f64 (68 us), 124 MB in f32 (37 us). In
// practice the L2 -> SM traffic and the per-slot instructions bind
// first: vT fits in the L2, but every slot needs a whole row of it.
// Staging each block's distinct rows once in shared memory cuts the L2
// traffic by the block's reuse (2.4 slots a staged row at 32 trades on
// both flagship books): 1.6 GB at the PV shape, 2.9 GB (f64) and 1.5 GB
// (f32) at the ladders; what is left is the slots' shared-memory reads
// (a whole row a slot) and the instructions each slot costs a lane.
//
// Scenario-major (pvs_sweep_f64 / _f32; the PV shape, S = 100): one block
// of 512 threads per kTB = 32 consecutive trades and per tile of up to
// kSC = 128 scenarios (one tile for S <= 128, so the slot tables are read
// once). The block streams its distinct vT rows through a ring of kStages
// shared-memory stages of kCH = 32 rows, filled by 16-byte cp.async (the
// rows of the stage after next are looked up while this one is summed),
// so a distinct row crosses the L2 once per block instead of once per
// slot. Larger blocks share more rows (3.0x at 64) but measured slower: a
// block runs as long as its longest trade (up to 249 and 363 slots), and
// more trades per warp mean more idle passes. The trades go to the 16
// warps by slot count, two per warp, longest first; lane l holds
// scenarios 2l, 2l+1, 64+2l, 65+2l of each and keeps the sums in
// registers. Per chunk a warp loads a window of each trade's next 32
// (row, weight) slots, one per lane (the next chunk's window is fetched
// while this one is summed); the trade's slots in the chunk are a prefix
// of the window (rows ascending, at most kCH), counted by a ballot, and
// broadcast by shuffles, one per pass. The shared-memory row loads are
// predicated on a slot being there and on the lane's scenarios, so only
// live bytes are read. The sums leave through a shared-memory transpose
// tile as coalesced rows of out[S, B]. A lane spends 2 shuffles, 2 8-byte
// shared loads and 4 FMAs a slot and tile, in either dtype.
//
// Trade-major (pvs_sweep_tm_f64 / _f32; the ladders, N = 184): the same
// blocks of kTB trades and the same kind of cp.async ring, but a stage
// row is the whole row of a column pass, so at N <= kWidth (192 f64, 256
// f32) the slot tables are read once and every staged row crosses the L2
// once. A lane owns whole 16-byte pieces of the row, strided by the warp
// (pieces l, l + 32, l + 64): three double2 (6 columns) in f64, two
// float4 (8 columns) in f32, so a slot costs a lane 2 shuffles (3 in
// f64: the weight is two words), 3 or 2 16-byte shared loads and 6 or 8
// FMAs, a piece past the row's end costs nothing, and f32 halves the
// shared loads of f64. A warp owns two trades, the block's w-th longest
// and w-th shortest, and sums them one after the other: no pass runs on
// a trade without a slot there (summing both in lockstep passes measured
// 13-19% slower). Wider N runs ceil(N / kWidth) column passes in the same
// launch (grid.y). The ring is two stages of kTMRows = 32 rows (94 KB at
// N = 184 in f64, 47 KB in f32, at most 98 KB at any N, so two blocks of
// 512 threads stay on an SM; 64 registers, no spill); chunk c + 1 is
// copied while chunk c is summed, one row per warp, a lane its own
// pieces. Three stages, stages of 16 rows, and three blocks an SM in f32
// (40 registers, with spills) measured slower. Each trade's N sums leave
// straight from registers as 16-byte stores into its row of out[B, N]
// (narrower where N leaves a row unaligned): no transpose tile, and none
// after the launch.
//
// What holds the trade-major kernel at the ladders (scripts/k1_phases.py,
// the kernel with parts cut out): the copies alone take about 0.44 ms in
// f64 and 0.23 ms in f32 (2.9 / 1.5 GB from the L2 at about 6.6 TB/s),
// the sums alone about 0.44 / 0.32 ms, and the two overlap only in part
// (0.65 / 0.44 ms together), because a chunk ends at a block barrier that
// waits for the warp with the block's longest trade; without the barrier
// (a timing probe, not a kernel) they take 0.53 / 0.36 ms.
//
// No atomics in either layout: every output is one thread's FMA chain in
// slot order from +0, so the result is deterministic, and the two
// layouts give the same bits (the scenario-major kernel's predicated-off
// passes add fma(0, 0, acc) = acc).
//
// The f32 instantiations read, sum and write f32 (vT, the slot weights,
// the sums and out); a 16-byte piece holds 4 columns, so the row stride
// is a multiple of 4, and the stages take half the shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTB = 32;                 // trades per block
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTPW = kTB / kWarps;      // trades per warp
constexpr int kSC = 128;                // scenarios per tile
constexpr int kCH = 32;                 // vT rows per stage
constexpr int kStages = 3;
constexpr int kStageElems = kCH * kSC;
constexpr int kTileLd = kTB + 1;        // transpose tile row stride
constexpr int kSmemElems = kStages * kStageElems > kSC * kTileLd
                               ? kStages * kStageElems : kSC * kTileLd;
constexpr int kNoRow = 0x7fffffff;      // past a trade's last slot

// per element type: the pair a lane loads, the scenarios of a 16-byte
// cp.async piece and the fused multiply-add
template <typename T> struct Elem;
template <> struct Elem<double> {
  using Pair = double2;
  static constexpr int kVec = 2;
  __device__ static double madd(double a, double b, double c) {
    return fma(a, b, c);
  }
};
template <> struct Elem<float> {
  using Pair = float2;
  static constexpr int kVec = 4;
  __device__ static float madd(float a, float b, float c) {
    return fmaf(a, b, c);
  }
};

template <typename T>
constexpr size_t smem_bytes() { return sizeof(T) * kSmemElems; }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
pvs_sweep_kernel(const T* __restrict__ vT, int ld, int S,
                 const int* __restrict__ tptr,
                 const int* __restrict__ slot_row,
                 const T* __restrict__ slot_w,
                 const int* __restrict__ bptr, const int* __restrict__ brow,
                 int B, T* __restrict__ out) {
  using Pair = typename Elem<T>::Pair;
  constexpr int kVec = Elem<T>::kVec;          // scenarios per piece
  constexpr int kRowPieces = kSC / kVec;       // pieces per stage row
  constexpr int kPieces = kCH * kRowPieces / kThreads;  // per thread
  constexpr int kRowStep = kThreads / kRowPieces;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int blk = blockIdx.x;
  const int s0 = blockIdx.y * kSC;
  const int nS = min(kSC, S - s0);
  const int nq = (nS + kVec - 1) / kVec;  // 16-byte pieces of a row tile
  const int t0 = blk * kTB;
  const int r0 = bptr[blk];
  const int nrow = bptr[blk + 1] - r0;
  const int nchunk = (nrow + kCH - 1) / kCH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int prow = threadIdx.x / kRowPieces, pq = threadIdx.x % kRowPieces;

  // The block's trades go to warps by slot count, longest first, so a
  // warp's trades need about the same number of passes per chunk.
  __shared__ int s_len[kTB], s_perm[kTB];
  if (threadIdx.x < kTB) {
    const int t = t0 + threadIdx.x;
    s_len[threadIdx.x] = t < B ? tptr[t + 1] - tptr[t] : -1;
  }
  __syncthreads();
  if (threadIdx.x < kTB) {
    const int me = s_len[threadIdx.x];
    int rank = 0;
    for (int u = 0; u < kTB; ++u) {
      const int v = s_len[u];
      rank += (v > me) || (v == me && u < (int)threadIdx.x);
    }
    s_perm[rank] = threadIdx.x;
  }
  __syncthreads();

  // each owned trade: its next slot and end, and a window of its next
  // 32 slots (row, weight), one per lane; the window for the next chunk
  // is fetched while this one is summed
  int cur[kTPW], end[kTPW], wr[kTPW], nwr[kTPW];
  T ww[kTPW], nww[kTPW], acc[kTPW][4];
#pragma unroll
  for (int j = 0; j < kTPW; ++j) {
    const int t = t0 + s_perm[warp * kTPW + j];
    cur[j] = t < B ? tptr[t] : 0;
    end[j] = t < B ? tptr[t + 1] : 0;
    const int i = cur[j] + lane;
    nwr[j] = i < end[j] ? __ldg(slot_row + i) : kNoRow;
    nww[j] = i < end[j] ? __ldg(slot_w + i) : T(0);
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = T(0);
  }
  const bool lane0 = 2 * lane < nS, lane1 = 64 + 2 * lane < nS;

  // the vT rows of the chunk to be copied next, fetched one chunk early
  int nxt[kPieces];
  auto fetch_rows = [&](int c) {
#pragma unroll
    for (int i = 0; i < kPieces; ++i) {
      const int r = c * kCH + prow + i * kRowStep;
      nxt[i] = (c < nchunk && r < nrow) ? __ldg(brow + r0 + r) : -1;
    }
  };
  auto load_chunk = [&](int c) {
    T* st = smem + (c % kStages) * kStageElems;
#pragma unroll
    for (int i = 0; i < kPieces; ++i) {
      const int r = prow + i * kRowStep;
      if (nxt[i] >= 0 && pq < nq) {
        cp_async16(st + r * kSC + kVec * pq,
                   vT + (int64_t)nxt[i] * ld + s0 + kVec * pq);
      }
    }
  };

#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    fetch_rows(c);
    load_chunk(c);
    cp_async_commit();
  }
  fetch_rows(kStages - 1);
  for (int c = 0; c < nchunk; ++c) {
    cp_async_wait<kStages - 2>();       // chunk c has landed
    __syncthreads();                    // for every thread; c-1 consumed
    load_chunk(c + kStages - 1);
    cp_async_commit();
    fetch_rows(c + kStages);
    const T* st = smem + (c % kStages) * kStageElems;
    const int lo = c * kCH, hi = lo + kCH;
    // a trade's slots in this chunk are a prefix of its window (rows
    // ascending, at most kCH = 32 of them); one pass per slot of the
    // busiest of the warp's trades, each pass over all of them with the
    // shared-memory row loads predicated on a slot being there and on
    // the lane's scenarios, so only live rows and lanes are read
    int cnt[kTPW], passes = 0;
#pragma unroll
    for (int j = 0; j < kTPW; ++j) {
      wr[j] = nwr[j];
      ww[j] = nww[j];
      cnt[j] = __popc(__ballot_sync(0xffffffffu, wr[j] < hi));
      passes = max(passes, cnt[j]);
      cur[j] += cnt[j];
      const int i = cur[j] + lane;
      nwr[j] = i < end[j] ? __ldg(slot_row + i) : kNoRow;
      nww[j] = i < end[j] ? __ldg(slot_w + i) : T(0);
    }
    for (int r = 0; r < passes; ++r) {
#pragma unroll
      for (int j = 0; j < kTPW; ++j) {
        const bool hit = r < cnt[j];
        const int lr = __shfl_sync(0xffffffffu, wr[j], r);
        const T wj = __shfl_sync(0xffffffffu, ww[j], r);
        const T w = hit ? wj : T(0);
        const T* row = st + (lr - lo) * kSC;
        Pair v0, v1;
        v0.x = v0.y = v1.x = v1.y = T(0);
        if (hit && lane0) {
          v0 = *reinterpret_cast<const Pair*>(row + 2 * lane);
        }
        if (hit && lane1) {
          v1 = *reinterpret_cast<const Pair*>(row + 64 + 2 * lane);
        }
        acc[j][0] = Elem<T>::madd(w, v0.x, acc[j][0]);
        acc[j][1] = Elem<T>::madd(w, v0.y, acc[j][1]);
        acc[j][2] = Elem<T>::madd(w, v1.x, acc[j][2]);
        acc[j][3] = Elem<T>::madd(w, v1.y, acc[j][3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                      // stages free: reuse as the tile

  T* tile = smem;                       // [kSC][kTileLd]
#pragma unroll
  for (int j = 0; j < kTPW; ++j) {
    const int tl = s_perm[warp * kTPW + j];
    tile[(2 * lane) * kTileLd + tl] = acc[j][0];
    tile[(2 * lane + 1) * kTileLd + tl] = acc[j][1];
    tile[(64 + 2 * lane) * kTileLd + tl] = acc[j][2];
    tile[(65 + 2 * lane) * kTileLd + tl] = acc[j][3];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nS * kTB; e += kThreads) {
    const int s = e / kTB, tl = e % kTB;
    if (t0 + tl < B) {
      out[(int64_t)(s0 + s) * B + t0 + tl] = tile[s * kTileLd + tl];
    }
  }
}

template <typename T>
int launch(const T* vT, int ld, int S, const int* tptr, const int* slot_row,
           const T* slot_w, const int* bptr, const int* brow, int B, T* out,
           cudaStream_t stream) {
  if (B <= 0 || S <= 0) return 0;
  // per call: the limit is a property of the current device
  const cudaError_t err = cudaFuncSetAttribute(
      pvs_sweep_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes<T>());
  if (err != cudaSuccess) return (int)err;
  dim3 grid((B + kTB - 1) / kTB, (S + kSC - 1) / kSC);
  pvs_sweep_kernel<T><<<grid, kThreads, smem_bytes<T>(), stream>>>(
      vT, ld, S, tptr, slot_row, slot_w, bptr, brow, B, out);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Trade-major: out[B, N]
// ---------------------------------------------------------------------------

constexpr int kTMStages = 2;            // double buffer: one in flight
constexpr int kTMRows = 32;             // rows a stage (a slot window)

// per element type: the 16-byte piece a lane loads, its columns, and the
// pieces a lane owns in one column pass
template <typename T> struct Wide;
template <> struct Wide<double> {
  using Piece = double2;
  static constexpr int kVec = 2;
  static constexpr int kPieces = 3;
  static constexpr int kWidth = 32 * kPieces * kVec;  // columns a pass
};
template <> struct Wide<float> {
  using Piece = float4;
  static constexpr int kVec = 4;
  static constexpr int kPieces = 2;
  static constexpr int kWidth = 32 * kPieces * kVec;
};

static_assert(kTPW == 2, "a warp pairs its longest and shortest trade");
static_assert(kTMRows % kWarps == 0, "the copy gives whole rows to warps");

template <typename T>
__device__ __forceinline__ void fma_piece(T w, const typename Wide<T>::Piece& v,
                                          T* acc);
template <>
__device__ __forceinline__ void fma_piece<double>(double w, const double2& v,
                                                  double* acc) {
  acc[0] = fma(w, v.x, acc[0]);
  acc[1] = fma(w, v.y, acc[1]);
}
template <>
__device__ __forceinline__ void fma_piece<float>(float w, const float4& v,
                                                 float* acc) {
  acc[0] = fmaf(w, v.x, acc[0]);
  acc[1] = fmaf(w, v.y, acc[1]);
  acc[2] = fmaf(w, v.z, acc[2]);
  acc[3] = fmaf(w, v.w, acc[3]);
}

template <typename T>
__device__ __forceinline__ void store_piece(T* dst, const T* acc);
template <>
__device__ __forceinline__ void store_piece<double>(double* dst,
                                                    const double* acc) {
  *reinterpret_cast<double2*>(dst) = make_double2(acc[0], acc[1]);
}
template <>
__device__ __forceinline__ void store_piece<float>(float* dst,
                                                   const float* acc) {
  *reinterpret_cast<float4*>(dst) =
      make_float4(acc[0], acc[1], acc[2], acc[3]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
pvs_sweep_tm_kernel(const T* __restrict__ vT, int ld, int N, int pitch,
                    const int* __restrict__ tptr,
                    const int* __restrict__ slot_row,
                    const T* __restrict__ slot_w,
                    const int* __restrict__ bptr,
                    const int* __restrict__ brow, int B,
                    T* __restrict__ out) {
  using Piece = typename Wide<T>::Piece;
  constexpr int kVec = Wide<T>::kVec;          // columns per piece
  constexpr int kPieces = Wide<T>::kPieces;    // pieces per lane
  constexpr int kWidth = Wide<T>::kWidth;      // columns per pass
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int blk = blockIdx.x;
  const int n0 = blockIdx.y * kWidth;
  const int nq = (min(kWidth, N - n0) + kVec - 1) / kVec;  // pass pieces
  const int t0 = blk * kTB;
  const int r0 = bptr[blk];
  const int nrow = bptr[blk + 1] - r0;
  const int nchunk = (nrow + kTMRows - 1) / kTMRows;
  const int stage_elems = kTMRows * pitch;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // The block's trades go to warps by slot count: warp w sums the w-th
  // longest and the w-th shortest, one after the other.
  __shared__ int s_len[kTB], s_perm[kTB];
  if (threadIdx.x < kTB) {
    const int t = t0 + threadIdx.x;
    s_len[threadIdx.x] = t < B ? tptr[t + 1] - tptr[t] : -1;
  }
  __syncthreads();
  if (threadIdx.x < kTB) {
    const int me = s_len[threadIdx.x];
    int rank = 0;
    for (int u = 0; u < kTB; ++u) {
      const int v = s_len[u];
      rank += (v > me) || (v == me && u < (int)threadIdx.x);
    }
    s_perm[rank] = threadIdx.x;
  }
  __syncthreads();
  // each owned trade: its next slot and end, and a window of its next
  // 32 slots (row, weight), one per lane; the window for the next chunk
  // is fetched while this one is summed
  int cur[kTPW], end[kTPW], nwr[kTPW];
  T nww[kTPW], acc[kTPW][kPieces][kVec];
#pragma unroll
  for (int j = 0; j < kTPW; ++j) {
    const int t = t0 + s_perm[j ? kTB - 1 - warp : warp];
    cur[j] = t < B ? tptr[t] : 0;
    end[j] = t < B ? tptr[t + 1] : 0;
    const int i = cur[j] + lane;
    nwr[j] = i < end[j] ? __ldg(slot_row + i) : kNoRow;
    nww[j] = i < end[j] ? __ldg(slot_w + i) : T(0);
#pragma unroll
    for (int k = 0; k < kPieces; ++k) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[j][k][e] = T(0);
    }
  }
  bool on[kPieces];
#pragma unroll
  for (int k = 0; k < kPieces; ++k) on[k] = lane + 32 * k < nq;

  // the copy: warp w stages rows w and w + kWarps of a chunk, each lane
  // its own pieces of them; the vT rows of the chunk to be copied next
  // are looked up one chunk early
  constexpr int kCopyRows = kTMRows / kWarps;
  int nxt[kCopyRows];
  auto fetch_rows = [&](int c) {
#pragma unroll
    for (int i = 0; i < kCopyRows; ++i) {
      const int sr = warp + i * kWarps;
      const int r = c * kTMRows + sr;
      nxt[i] = r < nrow ? __ldg(brow + r0 + r) : -1;
    }
  };
  auto load_chunk = [&](int c) {
    T* st = smem + (c % kTMStages) * stage_elems;
#pragma unroll
    for (int i = 0; i < kCopyRows; ++i) {
      if (nxt[i] < 0) continue;
      T* dst = st + (warp + i * kWarps) * pitch;
      const T* src = vT + (int64_t)nxt[i] * ld + n0;
#pragma unroll
      for (int k = 0; k < kPieces; ++k) {
        const int q = lane + 32 * k;
        if (q < nq) cp_async16(dst + kVec * q, src + kVec * q);
      }
    }
  };

#pragma unroll
  for (int c = 0; c < kTMStages - 1; ++c) {
    fetch_rows(c);
    load_chunk(c);
    cp_async_commit();
  }
  fetch_rows(kTMStages - 1);
  for (int c = 0; c < nchunk; ++c) {
    cp_async_wait<kTMStages - 2>();     // chunk c has landed
    __syncthreads();                    // for every thread; c-1 consumed
    load_chunk(c + kTMStages - 1);
    cp_async_commit();
    fetch_rows(c + kTMStages);
    const T* st = smem + (c % kTMStages) * stage_elems + kVec * lane;
    const int lo = c * kTMRows, hi = lo + kTMRows;
    // a trade's slots in this chunk are a prefix of its window (rows
    // ascending, at most kTMRows = 32 of them), counted by a ballot
    int wr[kTPW], cnt[kTPW];
    T ww[kTPW];
#pragma unroll
    for (int j = 0; j < kTPW; ++j) {
      wr[j] = nwr[j];
      ww[j] = nww[j];
      cnt[j] = __popc(__ballot_sync(0xffffffffu, wr[j] < hi));
      cur[j] += cnt[j];
      const int i = cur[j] + lane;
      nwr[j] = i < end[j] ? __ldg(slot_row + i) : kNoRow;
      nww[j] = i < end[j] ? __ldg(slot_w + i) : T(0);
    }
#pragma unroll
    for (int j = 0; j < kTPW; ++j) {
      for (int r = 0; r < cnt[j]; ++r) {
        const int lr = __shfl_sync(0xffffffffu, wr[j], r);
        const T w = __shfl_sync(0xffffffffu, ww[j], r);
        const T* row = st + (lr - lo) * pitch;
#pragma unroll
        for (int k = 0; k < kPieces; ++k) {
          if (on[k]) {
            const Piece v =
                *reinterpret_cast<const Piece*>(row + 32 * kVec * k);
            fma_piece<T>(w, v, acc[j][k]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // each trade's sums straight from registers into its row of out[B, N]:
  // 16-byte stores where the row is aligned (N a multiple of kVec),
  // element stores where it is not and on the row's last piece
  const bool aligned = N % kVec == 0;
#pragma unroll
  for (int j = 0; j < kTPW; ++j) {
    const int t = t0 + s_perm[j ? kTB - 1 - warp : warp];
    if (t >= B) continue;
    T* orow = out + (int64_t)t * N;
#pragma unroll
    for (int k = 0; k < kPieces; ++k) {
      if (!on[k]) continue;
      const int col = n0 + kVec * (lane + 32 * k);
      if (aligned && col + kVec <= N) {
        store_piece<T>(orow + col, acc[j][k]);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          if (col + e < N) orow[col + e] = acc[j][k][e];
        }
      }
    }
  }
}

template <typename T>
int launch_tm(const T* vT, int ld, int N, int pitch,
              const int* tptr, const int* slot_row, const T* slot_w,
              const int* bptr, const int* brow, int B, T* out,
              cudaStream_t stream) {
  constexpr int kVec = Wide<T>::kVec;
  constexpr int kWidth = Wide<T>::kWidth;
  if (B <= 0 || N <= 0) return 0;
  const int whole = (N + kVec - 1) / kVec * kVec;
  const int need = whole < kWidth ? whole : kWidth;
  if (pitch % kVec || pitch < need ||
      pitch > kWidth || ld % kVec || ld < N) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = sizeof(T) * (size_t)kTMStages * kTMRows * pitch;
  // per call: the limit is a property of the current device
  const cudaError_t err = cudaFuncSetAttribute(
      pvs_sweep_tm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((B + kTB - 1) / kTB, (N + kWidth - 1) / kWidth);
  pvs_sweep_tm_kernel<T><<<grid, kThreads, smem, stream>>>(
      vT, ld, N, pitch, tptr, slot_row, slot_w, bptr, brow, B, out);
  return (int)cudaGetLastError();
}

}  // namespace

// out[S, B] (row-major) = the trade PVs; vT [M, >= S] with row stride ld
// (a multiple of 2 doubles or 4 floats: whole 16-byte pieces) and a
// 16-byte aligned base. Returns the cudaError_t of the launch.
extern "C" int pvs_sweep_f64(const double* vT, int ld, int S,
                             const int* tptr, const int* slot_row,
                             const double* slot_w, const int* bptr,
                             const int* brow, int B, double* out,
                             cudaStream_t stream) {
  return launch<double>(vT, ld, S, tptr, slot_row, slot_w, bptr, brow, B,
                        out, stream);
}

extern "C" int pvs_sweep_f32(const float* vT, int ld, int S,
                             const int* tptr, const int* slot_row,
                             const float* slot_w, const int* bptr,
                             const int* brow, int B, float* out,
                             cudaStream_t stream) {
  return launch<float>(vT, ld, S, tptr, slot_row, slot_w, bptr, brow, B,
                       out, stream);
}

// out[B, N] (row-major) = the trade-major sweep (the per-trade ladders);
// vT [M, >= N] with row stride ld (whole 16-byte pieces, >= N) and a
// 16-byte aligned base; pitch (the stage row stride, in elements) from
// the caller's plan (adrates_torch/ops/kernels.py:sweep_plan). Returns
// the cudaError_t of the launch (cudaErrorInvalidValue for a pitch or
// stride the kernel does not take).
extern "C" int pvs_sweep_tm_f64(const double* vT, int ld, int N, int pitch,
                                const int* tptr,
                                const int* slot_row, const double* slot_w,
                                const int* bptr, const int* brow, int B,
                                double* out, cudaStream_t stream) {
  return launch_tm<double>(vT, ld, N, pitch, tptr, slot_row, slot_w,
                           bptr, brow, B, out, stream);
}

extern "C" int pvs_sweep_tm_f32(const float* vT, int ld, int N, int pitch,
                                const int* tptr,
                                const int* slot_row, const float* slot_w,
                                const int* bptr, const int* brow, int B,
                                float* out, cudaStream_t stream) {
  return launch_tm<float>(vT, ld, N, pitch, tptr, slot_row, slot_w,
                          bptr, brow, B, out, stream);
}
