// Probes for scripts/k45_latency.py: the latency of one step of the pv01
// chain (one row's dependent division and addition) as the kernels of
// adrates_torch/csrc/pv01_solve.cu take it and as nvcc's own division
// would, and an exactness check of their split division against v / d.
#include "../adrates_torch/csrc/pv01_solve.cu"

namespace {

// One warp walks n steps of x <- b + v / d_u (v = x, or 0 where sel_u is
// false), storing each x to shared memory as the kernels do; cycles[0]
// gets the clock64 ticks of the walk, ns[0] its globaltimer nanoseconds.
template <int kKind>
__global__ void step_probe(int n, const double* dv, double* res,
                           long long* cycles, unsigned long long* ns) {
  __shared__ double sh[32 * 17];
  double x = res[0];
  const double b = res[1];
  double dl[16], rl[16];
  bool sel[16];
  for (int u = 0; u < 16; ++u) {
    dl[u] = dv[u];
    rl[u] = recip(dv[u]);
    sel[u] = dv[u] > 0.0;
  }
  unsigned long long g0;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g0)::"memory");
  const long long c0 = clock64();
  for (int k = 0; k < n; k += 16) {
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      if (kKind == 0) x = __dadd_rn(b, x / dl[u]);                // nvcc
      if (kKind == 1) x = __dadd_rn(b, __dmul_rn(x, 0.0) / dl[u]);  // 0 / d
      if (kKind == 2)                                             // kernels
        x = __dadd_rn(b, divide<false>(sel[u] ? x : 0.0, dl[u], rl[u]));
      sh[threadIdx.x * 17 + u] = x;
    }
  }
  const long long c1 = clock64();
  unsigned long long g1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1)::"memory");
  if (threadIdx.x == 0) {
    res[2] = x + sh[3];
    cycles[0] = c1 - c0;
    ns[0] = g1 - g0;
  }
}

// Counts the quotients where the kernels' fast path (taken where their
// range checks pass) and v / d differ in any bit (NaNs aside), and how
// many took the fast path.
__global__ void exact_check(const double* v, const double* d, long n,
                            unsigned long long* bad,
                            unsigned long long* fast) {
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < n;
       i += (long)gridDim.x * blockDim.x) {
    const double a = v[i], b = d[i];
    const bool in = exp_in_range(b) &&
                    (exp_in_range(a) || __double_as_longlong(a) == 0);
    const double q1 = in ? divide<false>(a, b, recip(b)) : a / b;
    const double q2 = a / b;
    if (__double_as_longlong(q1) != __double_as_longlong(q2) &&
        !(q1 != q1 && q2 != q2))
      atomicAdd(bad, 1ull);
    if (in) atomicAdd(fast, 1ull);
  }
}

}  // namespace

extern "C" int k45_step_probe(int kind, int n, const double* dv, double* res,
                              long long* cycles, unsigned long long* ns) {
  if (kind == 0) step_probe<0><<<1, 32>>>(n, dv, res, cycles, ns);
  else if (kind == 1) step_probe<1><<<1, 32>>>(n, dv, res, cycles, ns);
  else step_probe<2><<<1, 32>>>(n, dv, res, cycles, ns);
  return (int)cudaDeviceSynchronize();
}

extern "C" int k45_exact_check(const double* v, const double* d, long n,
                               unsigned long long* bad,
                               unsigned long long* fast) {
  exact_check<<<1024, 256>>>(v, d, n, bad, fast);
  return (int)cudaDeviceSynchronize();
}
