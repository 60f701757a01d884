// K1: the per-trade PV sweep over all scenarios (f64), one launch.
//
// Replaces adrates_tpu/parallel/multibook.py:_pvs_sweep (:1782-1835, the
// gather + weighted row-sum + trade gather part; the cap/floor clamp
// epilogue stays plain torch in the caller), and the per-trade ladder
// contraction of make_per_trade_delta_fn (:2842), in f64 and, for its
// dtype=float32 option (:2825-2829), in f32.
//
//   out[s, b] = sum over trade b's live slots of w * vT[col, s]
//
// vT is the [M, S] value table (DF grid columns, then the forward-trip
// values) with an even row stride ld, so a row of S scenarios starts on a
// 16-byte boundary. The slots come as a per-trade CSR (dead slots dropped,
// a trade's duplicate columns merged) over blocks of kTB consecutive
// trades in the book's own order; block k lists its distinct vT rows once
// (brow[bptr[k] .. bptr[k+1]), ascending) and a slot names its row by its
// index in that list (ascending within a trade).
//
// What bounds it on an H100: bytes. Each input read once and the output
// written once is, at the flagship OIS slice (S = 100, 4,510,272 live
// slots, vT [10,197, 100], out [100,080, 100]), 54 MB of slots + 8 MB of
// vT + 80 MB of out = 143 MB, 43 us at 3.35 TB/s; on the OIS + XCCY book
// (5,245,500 merged slots, vT [14,660, 100], out [100,000, 100]) 156 MB,
// 46 us. The flops (2 per slot and scenario, 0.9-1.1 GFLOP) take 26-31 us
// at 34 TFLOP/s. In practice the L2 -> SM traffic binds first: vT fits in
// the L2, but every slot needs a whole row of it. The earlier design
// gathered one 800-byte row per padded slot (4.2-5.0 GB through the L2),
// wrote and re-read 160 MB of row PVs and ran 9 launches.
//
// Design: one block of 512 threads per kTB = 32 consecutive trades and
// per tile of up to kSC = 128 scenarios (one tile for S <= 128, so the
// slot tables are read once). The block streams its distinct vT rows
// through a ring of kStages shared-memory stages of kCH = 32 rows, filled
// by 16-byte cp.async (the rows of the stage after next are looked up
// while this one is summed), so a distinct row crosses the L2 once per
// block instead of once per slot: at 32 trades 2.4x fewer rows than slots
// on both flagship books. Larger blocks share more rows (3.0x at 64) but
// measured slower: a block runs as long as its longest trade (up to 249
// and 363 slots), and more trades per warp mean more idle passes. The
// trades go to the 16 warps by slot count, two per warp, longest first;
// lane l holds scenarios 2l, 2l+1, 64+2l, 65+2l of each and keeps the
// sums in registers. Per chunk a warp loads a window of each trade's next
// 32 (row, weight) slots, one per lane (the next chunk's window is
// fetched while this one is summed); the trade's slots in the chunk are a
// prefix of the window (rows ascending, at most kCH), counted by a
// ballot, and broadcast by shuffles, one per pass. The shared-memory row
// loads are predicated on a slot being there and on the lane's
// scenarios, so only live bytes are read. The sums leave through a
// shared-memory transpose tile as coalesced rows of out[S, B]. No
// atomics: every output is one thread's sum in slot order, so the result
// is deterministic.
//
// The f32 instantiation (pvs_sweep_f32, the f32 ladders) is the same
// kernel over float: vT, the slot weights, the sums and out are f32, a
// 16-byte cp.async piece holds 4 scenarios (so the row stride is a
// multiple of 4), and the stages take half the shared memory. It moves
// half the bytes of the f64 sweep at the same slot count.

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
