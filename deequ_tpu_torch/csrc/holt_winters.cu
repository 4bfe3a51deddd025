// Holt-Winters parameter fit on Hopper (sm_90a): the whole Adam fit of
// (alpha, beta, gamma) in one launch, each step's recursion evaluated in
// blocks of the series at once.
//
// Replaces deequ_tpu/anomaly/seasonal.py:_fit_parameters_jax, which runs 300
// Adam steps (lr 0.05, beta1 0.9, beta2 0.999, eps 1e-8) on the logits of
// (alpha, beta, gamma), each step a jitted value_and_grad of the residual sum
// of squares of the one-step-ahead ETS(A,A) forecasts (a lax.scan over the
// series). It computes the same function as
// deequ_tpu_torch/ops/holt_winters.py:fit_plain (torch autograd): the
// initial logits log(0.3/0.7), log(0.1/0.9), log(0.1/0.9) (passed in, as
// the host computes them), then `steps` Adam steps, and writes
// sigmoid(logits) as three doubles. Both fit the series less its first
// point: the recursion shifts with the series and its residuals do not, and
// a series near 10^9 would otherwise lose nine digits to cancellation in
// every residual and sensitivity.
//
// The recursion, in error-correction form with lt = L + T (the level plus
// the trend, the forecast less the season) and r the residual:
//   r   = (y - s) - lt                    s = S[t mod p], the season ring
//   lt' = (lt + T) + a (1 + b) r          (L' = lt + a r, T' = T + a b r)
//   T'  = T + a b r
//   s'  = s + g r
// which is seasonal.py:93-111 rearranged, exact in exact arithmetic. Its
// forward-mode sensitivities along one logit theta_k, with q = dlt + ds
// (dr = -q) and e_k = sigmoid'(theta_k) = s_k (1 - s_k):
//   dlt' = (dlt + dT) - a (1 + b) q + d[a (1 + b)] r
//   dT'  = dT - a b q + d[a b] r
//   ds'  = ds - g q + dg r
// d[a (1 + b)] = e_a (1 + b), a e_b, 0; d[a b] = e_a b, a e_b, 0; dg = 0,
// 0, e_g for theta_a, theta_b, theta_g. The gradient is
// dRSS/dtheta_k = sum 2 r dr = -2 sum r q.
//
// Blocks. Within one Adam step (a, b, g fixed) the recursion is a linear
// time-invariant system in Z = (lt, T, S, dlt, dT, dS): Z' = M Z + c y, of
// size 2 (p + 2) for one logit, with M = [[V, 0], [dV, V]] block
// lower-triangular (V the values' one-point step, dV its derivative along
// the logit). Cut the n points into B blocks of Lb points (Lb a multiple
// of p, the last block shorter where n is not a multiple). A block's end
// state is Phi Z_b + psi_b, with Phi = M^Lb = [[P, 0], [P_k, P]] the same
// for every full block and psi_b the block's response to its own points
// from a zero state. So, for each step:
//   1. in parallel, one lane a trajectory: block 0 from the true initial
//      state (its end state is Z_1); each block 1 .. B-2 from zero
//      (psi_b); and the p + 2 columns of Phi, as the homogeneous response
//      (y = 0) of the value basis (the columns of the sensitivity basis
//      repeat P and need no run);
//   2. the join, serial over the blocks: Z_{b+1} = Phi Z_b + psi_b, a row
//      of the (2(p + 2))-square product a lane, Phi's rows in registers,
//      Z_b broadcast from shared memory;
//   3. in parallel, each block replayed from its true start, accumulating
//      r q; a warp reduction gives the gradient component.
// The serial depth of a step falls from n points to 2 Lb points and B - 2
// joins. Block starts are multiples of p, so the season ring's slot of a
// point is its static index in a loop unrolled by p: the ring lives in
// registers, p a template parameter instantiated for 7 and 12, the only
// periodicities HoltWinters admits (seasonal.py:152-160); the wrapper
// refuses any other on the card. The evaluation's roundings differ from the
// point-by-point one's; both stay within 1e-12 of the plain fit.
//
// Layout: one CTA a fit, three warps, warp k owning logit k: every lane of
// warp k carries the value recursion and the sensitivity along theta_k, so
// the warps exchange nothing but the three parameters once a step (a
// double-buffered shared array and one __syncthreads). Lane 0 of warp k
// keeps theta_k's Adam moments, applies the update and the sigmoid. A warp
// has B - 1 + (p + 2) trajectories in phase 1 and 2 (p + 2) join rows, so
// B <= 31 - p (the wrapper chooses Lb so). Adam's bias corrections
// 1 - beta^i come from a table the wrapper fills once on the host with
// Python's **, the bits fit_plain divides by. The series is read through
// the read-only cache, a ring period ahead of its use; a lane's block,
// and so its first period, is the same every step, so that period is
// loaded once.
//
// What bounds it: latency, and the issue of one warp. Every phase is a
// dependent chain, and the work (tens of f64 operations a point) is far
// below the card's rates. A trajectory's point chains three operations
// (dlt + dT, then two FMAs) and issues ~16 f64 instructions from its warp,
// ~55 cycles a point on the card; a join is a shared-memory round trip and
// 2 (p + 2) FMAs in four partial sums, ~170 cycles at p = 7; the update's
// chain of three divides, a sqrt and an exp ~830 cycles a step (PERF.md,
// from the stage-clock probe build below). So a step costs about 2 Lb
// points and B - 2 joins, and the wrapper takes Lb near sqrt(n), the
// measured best where the lanes allow it.
// No evaluation can beat, per step, ceil(log2 n) dependent f64 operations
// (the state at the last point combines n inputs), one more to join its
// residual term to the gradient, and the update's sqrt, divide and the
// next sigmoid's exp, each a dependent chain: chip_smoke.py prints that
// bound from the latencies deequ_hw_op_cycles measures on the card, and
// beside it the point-by-point chain (one f64 FMA a point and step), which
// a point-by-point evaluation cannot reach either: it would issue ~30 f64
// instructions a point from one warp, or ~16 from each of three.
//
// Built without --use_fast_math. Plain C interface for ctypes; every entry
// returns the launch's cudaGetLastError(). Built with
// -DDEEQU_HW_STAGE_CLOCK (a probe build: tools/time_holt_winters.py), the
// kernel also reads clock64 at its warp synchronisation points and the
// library exports deequ_hw_fit_stage_clock; the package's library has
// neither.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kParams = 3;   // alpha, beta, gamma: warps 0, 1, 2
constexpr int kThreads = kParams * kWarp;
constexpr int kCoef = 8;     // doubles a coefficient buffer: s_k, then e_k
constexpr int kStages = 5;   // drive, join, replay, reduce, update
#ifdef DEEQU_HW_STAGE_CLOCK
constexpr bool kStageClock = true;
#else
constexpr bool kStageClock = false;
#endif

// Cycles of each stage of a step, summed over the steps on lane 0 of each
// warp (clock64 at the warp's synchronisation points), in the probe build;
// nothing otherwise.
template <bool kOn>
struct StageClock {
  long long last = 0, sum[kStages] = {};
  __device__ __forceinline__ void start() {
    if (kOn) last = clock64();
  }
  __device__ __forceinline__ void mark(int stage) {
    if (kOn) {
      const long long now = clock64();
      sum[stage] += now - last;
      last = now;
    }
  }
};

__device__ __forceinline__ double sigmoid(double x) {
  return 1.0 / (1.0 + exp(-x));
}

// One trajectory's state: the value recursion and one sensitivity.
template <int P>
struct State {
  double lt, T, s[P];
  double dlt, dT, ds[P];
};

// A step's coefficients as one warp uses them.
struct Coef {
  double clt, cT, g;     // a (1 + b), a b, g
  double dlt, dT, ds;    // their derivatives along the warp's logit
};

template <int P>
__device__ __forceinline__ void load_state(State<P>& z, const double* src) {
  z.lt = src[0];
  z.T = src[1];
#pragma unroll
  for (int i = 0; i < P; ++i) z.s[i] = src[2 + i];
  z.dlt = src[P + 2];
  z.dT = src[P + 3];
#pragma unroll
  for (int i = 0; i < P; ++i) z.ds[i] = src[P + 4 + i];
}

template <int P>
__device__ __forceinline__ void store_state(const State<P>& z, double* dst) {
  dst[0] = z.lt;
  dst[1] = z.T;
#pragma unroll
  for (int i = 0; i < P; ++i) dst[2 + i] = z.s[i];
  dst[P + 2] = z.dlt;
  dst[P + 3] = z.dT;
#pragma unroll
  for (int i = 0; i < P; ++i) dst[P + 4 + i] = z.ds[i];
}

// One point at ring slot J: residual, state update, and (kAcc) acc += r q.
template <int P, int J, bool kAcc>
__device__ __forceinline__ void point(State<P>& z, const Coef& c, double yv, double& acc) {
  const double r = (yv - z.s[J]) - z.lt;
  const double q = z.dlt + z.ds[J];
  if (kAcc) acc = fma(r, q, acc);
  const double ltT = z.lt + z.T;
  const double dltT = z.dlt + z.dT;
  z.lt = fma(c.clt, r, ltT);
  z.T = fma(c.cT, r, z.T);
  z.s[J] = fma(c.g, r, z.s[J]);
  z.dlt = fma(-c.clt, q, fma(c.dlt, r, dltT));
  z.dT = fma(-c.cT, q, fma(c.dT, r, z.dT));
  z.ds[J] = fma(-c.g, q, fma(c.ds, r, z.ds[J]));
}

template <int P, int J, bool kAcc>
struct Ring {
  // points J .. P-1 of one period, all present
  static __device__ __forceinline__ void full(State<P>& z, const Coef& c, double y0,
                                              const double* ycur, double& acc) {
    point<P, J, kAcc>(z, c, ycur[J] - y0, acc);
    Ring<P, J + 1, kAcc>::full(z, c, y0, ycur, acc);
  }
  // points J .. left-1 of a last, partial period
  static __device__ __forceinline__ void tail(State<P>& z, const Coef& c, double y0,
                                              const double* ycur, int left, double& acc) {
    if (J < left) {
      point<P, J, kAcc>(z, c, ycur[J] - y0, acc);
      Ring<P, J + 1, kAcc>::tail(z, c, y0, ycur, left, acc);
    }
  }
};

template <int P, bool kAcc>
struct Ring<P, P, kAcc> {
  static __device__ __forceinline__ void full(State<P>&, const Coef&, double, const double*,
                                              double&) {}
  static __device__ __forceinline__ void tail(State<P>&, const Coef&, double, const double*,
                                              int, double&) {}
};

// Runs `len` points from series index t0 (a multiple of P) on z, in place;
// an undriven trajectory (drive false) sees y = y0, a centred 0. yfirst
// holds the block's first period (loaded once a fit). Returns the sum of
// r q over the points (kAcc), else 0.
template <int P, bool kAcc>
__device__ __forceinline__ double run(State<P>& z, const Coef& c, const double* __restrict__ y,
                                      double y0, const double (&yfirst)[P], int t0, int len,
                                      bool drive) {
  double acc = 0.0;
  double ycur[P], ynext[P];
#pragma unroll
  for (int j = 0; j < P; ++j) ycur[j] = drive ? yfirst[j] : y0;
  int j0 = 0;
  for (; j0 + P <= len; j0 += P) {
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int t = j0 + P + j;
      ynext[j] = (drive && t < len) ? __ldg(y + t0 + t) : y0;
    }
    Ring<P, 0, kAcc>::full(z, c, y0, ycur, acc);
#pragma unroll
    for (int j = 0; j < P; ++j) ycur[j] = ynext[j];
  }
  if (j0 < len) Ring<P, 0, kAcc>::tail(z, c, y0, ycur, len - j0, acc);
  return acc;
}

template <int P>
__global__ void __launch_bounds__(kThreads)
hw_fit_kernel(const double* __restrict__ y, int n, int steps, int block_len, int blocks,
              const double* __restrict__ bias, double theta_a, double theta_bg, double lr,
              double beta1, double beta2, double eps, double* __restrict__ out,
              long long* __restrict__ clocks) {
  constexpr int R = P + 2;      // the value state: lt, T, the ring
  constexpr int W = 2 * R;      // a warp's state: values and one sensitivity
  extern __shared__ double smem[];
  const int k = threadIdx.x / kWarp;  // this warp's logit
  const int lane = threadIdx.x % kWarp;
  double* coef = smem;                                  // [2][kCoef]
  double* slot = smem + 2 * kCoef + k * (blocks + R) * W;  // [blocks][W]: block starts
  double* phi = slot + blocks * W;                      // [R][W]: Phi's value-basis columns
  const double y0 = __ldg(y);

  double theta = 0.0, m = 0.0, v = 0.0;
  if (lane == 0) {
    // the initial state, as seasonal.py:88-91 builds it, centred
    double s1 = 0.0, s2 = 0.0;
    for (int j = 0; j < P; ++j) s1 += __ldg(y + j) - y0;
    for (int j = P; j < 2 * P; ++j) s2 += __ldg(y + j) - y0;
    const double level0 = s1 / P;
    const double trend0 = (s2 - s1) / (double)(P * P);
    slot[0] = level0 + trend0;
    slot[1] = trend0;
    for (int j = 0; j < P; ++j) slot[2 + j] = (__ldg(y + j) - y0) - level0;
    for (int j = R; j < W; ++j) slot[j] = 0.0;
    theta = k == 0 ? theta_a : theta_bg;
    const double s = sigmoid(theta);
    coef[kCoef + k] = s;
    coef[kCoef + kParams + k] = s * (1.0 - s);
  }
  __syncthreads();

  // lanes basis0 .. basis0 + R - 1 run Phi's columns (needed when blocks > 2)
  const int basis0 = blocks > 1 ? blocks - 1 : 1;
  // lane b < blocks drives and replays block b: its first period, once
  double yfirst[P];
  const int own_len = lane < blocks ? min(block_len, n - lane * block_len) : 0;
#pragma unroll
  for (int j = 0; j < P; ++j) yfirst[j] = j < own_len ? __ldg(y + lane * block_len + j) : y0;
  StageClock<kStageClock> clock;
  clock.start();
  for (int i = 1; i <= steps; ++i) {
    double d1 = 0.0, d2 = 0.0;
    if (lane == 0) {  // off the chain until the update
      d1 = __ldg(bias + i - 1);
      d2 = __ldg(bias + steps + i - 1);
    }
    const double* cf = coef + (i & 1) * kCoef;
    const double a = cf[0], b = cf[1], g = cf[2];
    const double e = cf[kParams + k];
    Coef c;
    c.clt = a * (1.0 + b);
    c.cT = a * b;
    c.g = g;
    c.dlt = k == 0 ? e * (1.0 + b) : (k == 1 ? a * e : 0.0);
    c.dT = k == 0 ? e * b : (k == 1 ? a * e : 0.0);
    c.ds = k == 2 ? e : 0.0;

    // 1. block 0 from the true start (its end is Z_1), blocks 1 .. B-2 from
    //    zero (psi_b), Phi's columns
    State<P> z;
    if (lane < basis0 + R) {
      const bool basis = lane >= basis0;
      if (lane == 0) {
        load_state<P>(z, slot);
      } else {
        const int j = lane - basis0;  // the basis vector e_j, if basis
        z.lt = basis && j == 0 ? 1.0 : 0.0;
        z.T = basis && j == 1 ? 1.0 : 0.0;
#pragma unroll
        for (int q = 0; q < P; ++q) z.s[q] = basis && j == 2 + q ? 1.0 : 0.0;
        z.dlt = 0.0;
        z.dT = 0.0;
#pragma unroll
        for (int q = 0; q < P; ++q) z.ds[q] = 0.0;
      }
      run<P, false>(z, c, y, y0, yfirst, basis ? 0 : lane * block_len,
                    basis ? block_len : own_len, !basis);
      if (basis) {
        store_state<P>(z, phi + (lane - basis0) * W);
      } else if (lane + 1 < blocks) {
        store_state<P>(z, slot + (lane + 1) * W);
      }
    }
    __syncwarp();
    clock.mark(0);

    // 2. the join: Z_{b+1} = Phi Z_b + psi_b, a row a lane
    if (blocks > 2 && lane < W) {
      double A[R], Bc[R];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        A[j] = phi[j * W + lane];
        Bc[j] = lane >= R ? phi[j * W + lane - R] : 0.0;
      }
      double next = slot[2 * W + lane];
      for (int bk = 1; bk + 1 < blocks; ++bk) {
        const double* cur = slot + bk * W;
        double s0 = next, s1 = 0.0, s2 = 0.0, s3 = 0.0;  // four partial sums
#pragma unroll
        for (int j = 0; j < R; j += 2) {
          s0 = fma(A[j], cur[j], s0);
          s2 = fma(Bc[j], cur[R + j], s2);
          if (j + 1 < R) {
            s1 = fma(A[j + 1], cur[j + 1], s1);
            s3 = fma(Bc[j + 1], cur[R + j + 1], s3);
          }
        }
        if (bk + 2 < blocks) next = slot[(bk + 2) * W + lane];
        slot[(bk + 1) * W + lane] = (s0 + s1) + (s2 + s3);
        __syncwarp(0xffffffffu >> (kWarp - W));
      }
    }
    __syncwarp();
    clock.mark(1);

    // 3. every block replayed from its true start, summing r q
    double acc = 0.0;
    if (lane < blocks) {
      load_state<P>(z, slot + lane * W);
      acc = run<P, true>(z, c, y, y0, yfirst, lane * block_len, own_len, true);
    }
    __syncwarp();
    clock.mark(2);
#pragma unroll
    for (int off = kWarp / 2; off > 0; off /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    clock.mark(3);

    // Adam on theta_k (seasonal.py:120-128), in fit_plain's order of operations
    if (lane == 0) {
      const double grad = -2.0 * acc;
      m = __dadd_rn(__dmul_rn(beta1, m), __dmul_rn(1.0 - beta1, grad));
      v = __dadd_rn(__dmul_rn(beta2, v), __dmul_rn(__dmul_rn(1.0 - beta2, grad), grad));
      const double mhat = m / d1;
      const double vhat = v / d2;
      theta = theta - __dmul_rn(lr, mhat) / __dadd_rn(sqrt(vhat), eps);
      const double s = sigmoid(theta);
      double* nf = coef + ((i + 1) & 1) * kCoef;
      nf[k] = s;
      nf[kParams + k] = s * (1.0 - s);
    }
    __syncthreads();
    clock.mark(4);
  }
  if (lane == 0) {
    out[k] = coef[((steps + 1) & 1) * kCoef + k];
    if (kStageClock) {
#pragma unroll
      for (int st = 0; st < kStages; ++st) clocks[k * kStages + st] = clock.sum[st];
    }
  }
}

// Dependent chains of one f64 operation on one thread, for the bound.
__global__ void op_chain_kernel(int op, int chain, long long* cycles, double* sink) {
  double x = op == 1 ? 2.0 : 0.5;
  const long long t0 = clock64();
  switch (op) {
    case 0:
#pragma unroll 16
      for (int i = 0; i < chain; ++i) x = fma(x, 0.999999, 1e-9);
      break;
    case 1:
#pragma unroll 16
      for (int i = 0; i < chain; ++i) x = sqrt(x);
      break;
    case 2:
#pragma unroll 16
      for (int i = 0; i < chain; ++i) x = 1.000001 / x;
      break;
    default:
#pragma unroll 16
      for (int i = 0; i < chain; ++i) x = exp(-x);
      break;
  }
  const long long t1 = clock64();
  cycles[0] = t1 - t0;
  sink[0] = x;
}

template <int P>
int launch_fit(const double* series, int n, int steps, int block_len, int blocks,
               const double* bias, double theta_a, double theta_bg, double lr, double beta1,
               double beta2, double eps, double* out, long long* clocks, size_t smem,
               cudaStream_t stream) {
  hw_fit_kernel<P><<<1, kThreads, smem, stream>>>(series, n, steps, block_len, blocks, bias,
                                                  theta_a, theta_bg, lr, beta1, beta2, eps,
                                                  out, clocks);
  return (int)cudaGetLastError();
}

int fit(const double* series, int n, int p, int steps, int block_len, int blocks,
        const double* bias, double theta_a, double theta_bg, double lr, double beta1,
        double beta2, double eps, double* out, long long* clocks, cudaStream_t stream) {
  if (block_len <= 0 || block_len % p != 0 || blocks < 1 || blocks > 31 - p ||
      (long long)(blocks - 1) * block_len >= n || (long long)blocks * block_len < n ||
      n < 2 * p) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = sizeof(double) * (2 * kCoef + (size_t)kParams * (blocks + p + 2) *
                                                        2 * (p + 2));
  switch (p) {
    case 7:
      return launch_fit<7>(series, n, steps, block_len, blocks, bias, theta_a, theta_bg, lr,
                           beta1, beta2, eps, out, clocks, smem, stream);
    case 12:
      return launch_fit<12>(series, n, steps, block_len, blocks, bias, theta_a, theta_bg, lr,
                            beta1, beta2, eps, out, clocks, smem, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Fit (alpha, beta, gamma) to series[0:n] with periodicity p (7 or 12) in
// `steps` Adam steps from the logits (theta_a, theta_bg, theta_bg), in
// `blocks` blocks of `block_len` points (a multiple of p; blocks <= 31 - p;
// the last block holds the rest); bias holds 1 - beta1^i then 1 - beta2^i
// for i = 1 .. steps. Writes the three values to out. Returns the launch's
// error, or cudaErrorInvalidValue for arguments the kernel does not take.
int deequ_hw_fit(const double* series, int n, int p, int steps, int block_len, int blocks,
                 const double* bias, double theta_a, double theta_bg, double lr, double beta1,
                 double beta2, double eps, double* out, void* stream) {
  return fit(series, n, p, steps, block_len, blocks, bias, theta_a, theta_bg, lr, beta1, beta2,
             eps, out, nullptr, (cudaStream_t)stream);
}

#ifdef DEEQU_HW_STAGE_CLOCK
// deequ_hw_fit, and each warp's cycles in each stage summed over the
// steps into clocks (3 x kStages int64).
int deequ_hw_fit_stage_clock(const double* series, int n, int p, int steps, int block_len,
                             int blocks, const double* bias, double theta_a, double theta_bg,
                             double lr, double beta1, double beta2, double eps, double* out,
                             long long* clocks, void* stream) {
  return fit(series, n, p, steps, block_len, blocks, bias, theta_a, theta_bg, lr, beta1, beta2,
             eps, out, clocks, (cudaStream_t)stream);
}
#endif

// Cycles of a chain of `chain` dependent f64 operations on one thread,
// written to cycles[0] (sink[0] keeps the chain alive): op 0 an FMA, 1 a
// square root, 2 a division, 3 an exp.
int deequ_hw_op_cycles(int op, int chain, long long* cycles, double* sink, void* stream) {
  op_chain_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(op, chain, cycles, sink);
  return (int)cudaGetLastError();
}

}  // extern "C"
