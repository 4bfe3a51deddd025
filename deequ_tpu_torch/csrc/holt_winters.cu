// Holt-Winters parameter fit on Hopper (sm_90a): the whole Adam fit of
// (alpha, beta, gamma) in one launch.
//
// Replaces deequ_tpu/anomaly/seasonal.py:_fit_parameters_jax, which runs 300
// Adam steps (lr 0.05, beta1 0.9, beta2 0.999, eps 1e-8) on the logits of
// (alpha, beta, gamma), each step a jitted value_and_grad of the residual sum
// of squares of the one-step-ahead ETS(A,A) forecasts (a lax.scan over the
// series). It computes the same function as
// deequ_tpu_torch/ops/holt_winters.py:fit_plain (torch autograd): the
// initial logits log(0.3/0.7), log(0.1/0.9), log(0.1/0.9) (passed in, as
// the host computes them), then `steps` Adam steps, and writes
// sigmoid(logits) as three doubles.
//
// The gradient. Each step needs d RSS / d logit_k exactly. Reverse mode would
// keep the whole recursion's trajectory; forward mode carries, beside the
// level L, the trend T and the p-long season ring S, their partial
// derivatives with respect to one logit through the recursion:
//   r   = y - (L + T + S[t mod p])                 dr   = -(dL + dT + dS)
//   L'  = a (y - S) + (1 - a)(L + T)               dL'  = ea ((y - S) - (L + T))
//                                                        + (1 - a)(dL + dT) - a dS
//   T'  = b (L' - L) + (1 - b) T                   dT'  = eb ((L' - L) - T)
//                                                        + b (dL' - dL) + (1 - b) dT
//   S'  = g (y - L - T) + (1 - g) S                dS'  = eg ((y - L - T) - S)
//                                                        - g (dL + dT) + (1 - g) dS
// with ek = sigmoid'(logit_k) = s_k (1 - s_k) for the lane's own parameter
// and 0 for the other two, and dRSS += 2 r dr. That is the chain rule
// through the sigmoid, exact in exact arithmetic like the reference's
// autodiff; the roundings differ in the last bits only.
//
// The fit runs on the series less its first point, in the kernel as in
// fit_plain. The recursion is translation-equivariant (level and
// forecasts shift, residuals and RSS do not), but a series near 10^9
// whose residuals are near 10^5 loses nine digits to cancellation in
// r = y - (L + T + S) and in the sensitivities, so forward and reverse
// mode then land ~1e-12 apart; centred, they agree within ~1e-14.
//
// Layout: one block of one warp a fit. Lanes 0, 1 and 2 each own one logit:
// its Adam moments, and the sensitivity lane of the recursion for it. The
// sensitivities read the values (L, T, S, L') every step, so each of the
// three lanes also carries the value recursion itself, in registers, rather
// than receiving it from a value lane: the values cost three more f64
// operations per step on a lane that waits on its dependency chain anyway,
// and no exchange sits between the steps. After each pass over the series
// the three logits are exchanged with three warp shuffles. The value and
// sensitivity season rings live in shared memory, one slot per lane and
// phase ([phase][kRingStride], so the lanes hit different banks): 64 p
// bytes, within the default 48 KB for p up to 768 (a larger p fails the
// launch, and the wrapper raises). The series is read from global memory
// through the read-only cache, a point ahead, so its load sits off the
// dependency chain.
//
// What bounds it: latency. The work is ~60 f64 operations per series point
// and lane and the bytes are the series once, both far below the card's
// rates; but point k + 1 needs the state of point k. Written in lt = L + T,
// the value recursion is a second-order linear recurrence,
//   lt_{k+1} = ((1 + b)(1 - a) + (1 - b)) lt_k - (1 - a) lt_{k-1}
//              + (1 + b) u_k - u_{k-1},        u_k = a (y_k - S_k),
// whose loop-carried chain is one f64 FMA a point: lt_{k-1}'s term and
// the season (which feeds back only p points later) are ready before
// lt_k is, for p >= 4; the sensitivities' recurrence has the same form,
// on their own lanes. So a point-by-point evaluation takes at least
// n x steps f64 FMA latencies, and that is the bound chip_smoke.py prints;
// deequ_hw_dfma_cycles measures the latency on the card. A blocked
// (look-ahead) or parallel-prefix evaluation of this linear recurrence
// could go below it, with more operations and other roundings. (The form written
// below, kept close to the reference's, has a longer chain per point: the
// ring's shared-memory load and the level and trend updates.)
//
// Built without --use_fast_math. Plain C interface for ctypes; every entry
// returns the launch's cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kParams = 3;  // alpha, beta, gamma: lanes 0, 1, 2
constexpr int kRingStride = 4;  // ring slots a phase (lanes 0-2, padded)

__device__ __forceinline__ double sigmoid(double x) {
  return 1.0 / (1.0 + exp(-x));
}

__global__ void __launch_bounds__(kWarp)
hw_fit_kernel(const double* __restrict__ y, int n, int p, int steps,
              double theta_a, double theta_bg, double lr, double beta1,
              double beta2, double eps, double* __restrict__ out) {
  extern __shared__ double smem[];
  const int lane = threadIdx.x;
  if (lane >= kParams) return;
  double* ring_s = smem;                     // [p][kRingStride] season values
  double* ring_d = smem + p * kRingStride;   // [p][kRingStride] sensitivities

  // the series centred on its first point, as fit_plain centres it: the
  // recursion shifts with it and its residuals do not (see above)
  const double y0 = __ldg(y);
  // the initial state, as seasonal.py:88-91 builds it
  double s1 = 0.0, s2 = 0.0;
  for (int j = 0; j < p; ++j) s1 += __ldg(y + j) - y0;
  for (int j = p; j < 2 * p; ++j) s2 += __ldg(y + j) - y0;
  const double level0 = s1 / p;
  const double trend0 = (s2 - s1) / (double)(p * p);

  double theta = lane == 0 ? theta_a : theta_bg;
  double m = 0.0, v = 0.0;
  const unsigned mask = (1u << kParams) - 1u;
  for (int i = 1; i <= steps; ++i) {
    const double a = sigmoid(__shfl_sync(mask, theta, 0));
    const double b = sigmoid(__shfl_sync(mask, theta, 1));
    const double g = sigmoid(__shfl_sync(mask, theta, 2));
    const double own = lane == 0 ? a : (lane == 1 ? b : g);
    const double e = own * (1.0 - own);
    const double ea = lane == 0 ? e : 0.0;
    const double eb = lane == 1 ? e : 0.0;
    const double eg = lane == 2 ? e : 0.0;
    const double ca = 1.0 - a, cb = 1.0 - b, cg = 1.0 - g;

    for (int j = 0; j < p; ++j) {
      ring_s[j * kRingStride + lane] = (__ldg(y + j) - y0) - level0;
      ring_d[j * kRingStride + lane] = 0.0;
    }
    double L = level0, T = trend0, dL = 0.0, dT = 0.0, dR = 0.0;
    int slot = lane;  // this lane's slot of phase t mod p: [phase][lane]
    double y_next = y0;  // loaded a point ahead, centred when used
    for (int t = 0; t < n; ++t) {
      const double yt = y_next - y0;
      if (t + 1 < n) y_next = __ldg(y + t + 1);
      const double st = ring_s[slot];
      const double dst = ring_d[slot];
      const double lt = L + T;
      const double dlt = dL + dT;
      const double r = yt - (lt + st);
      dR += 2.0 * r * (-(dlt + dst));
      const double nL = a * (yt - st) + ca * lt;
      const double dnL = ea * ((yt - st) - lt) + ca * dlt - a * dst;
      const double nT = b * (nL - L) + cb * T;
      const double dnT = eb * ((nL - L) - T) + b * (dnL - dL) + cb * dT;
      const double x = yt - L - T;
      ring_s[slot] = g * x + cg * st;
      ring_d[slot] = eg * (x - st) - g * dlt + cg * dst;
      L = nL; T = nT; dL = dnL; dT = dnT;
      slot += kRingStride;
      if (slot >= p * kRingStride) slot = lane;
    }
    // Adam on this lane's logit (seasonal.py:120-128)
    m = beta1 * m + (1.0 - beta1) * dR;
    v = beta2 * v + (1.0 - beta2) * dR * dR;
    const double mhat = m / (1.0 - pow(beta1, (double)i));
    const double vhat = v / (1.0 - pow(beta2, (double)i));
    theta = theta - lr * mhat / (sqrt(vhat) + eps);
  }
  out[lane] = sigmoid(theta);
}

__global__ void dfma_chain_kernel(double x0, double mul, double add, int chain,
                                  long long* cycles, double* sink) {
  double x = x0;
  const long long t0 = clock64();
#pragma unroll 16
  for (int i = 0; i < chain; ++i) x = fma(x, mul, add);
  const long long t1 = clock64();
  cycles[0] = t1 - t0;
  sink[0] = x;
}

}  // namespace

extern "C" {

// Fit (alpha, beta, gamma) to series[0:n] with periodicity p in `steps` Adam
// steps from the logits (theta_a, theta_bg, theta_bg); writes the three
// values to out.
int deequ_hw_fit(const double* series, int n, int p, int steps, double theta_a,
                 double theta_bg, double lr, double beta1, double beta2,
                 double eps, double* out, void* stream) {
  const size_t smem = (size_t)2 * p * kRingStride * sizeof(double);
  hw_fit_kernel<<<1, kWarp, smem, (cudaStream_t)stream>>>(
      series, n, p, steps, theta_a, theta_bg, lr, beta1, beta2, eps, out);
  return (int)cudaGetLastError();
}

// Cycles of a chain of `chain` dependent f64 FMAs on one thread, written to
// cycles[0] (sink[0] keeps the chain alive).
int deequ_hw_dfma_cycles(int chain, long long* cycles, double* sink, void* stream) {
  dfma_chain_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      1.0, 0.999999, 1e-9, chain, cycles, sink);
  return (int)cudaGetLastError();
}

}  // extern "C"
