// Island-constrained preconditioned CG in one launch, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel inside uvic_tpu/ops/pallas_cg.py:
// make_pallas_congrad (the `kernel` closure).  The algorithm is
// congrad.F (Dukowicz, Smith & Malone 1993) as ported in
// uvic_tpu/ops/solvers.py:congrad: 9-point operator at unit timestep
// scaled by 1/c2dtsf, diagonal preconditioner, island sum/average
// redistribution over perimeter cells, constant-mode deflation, and the
// geometric-series error-extrapolation stop (congrad.F:62-105).
//
// What bounds it: latency.  The 102x102 solve moves ~0.5 MB and does
// ~1 MFLOP per iteration; its time is the chain of dependent block-wide
// reductions.  Each iteration has 13 __syncthreads() (six two-barrier
// reductions and one barrier before the stencil reads its neighbours),
// so the floor is 13 barriers x iterations.
//
// Design.  One block of 1024 threads does the whole solve, so a
// reduction is a block reduction and no launch boundary sits inside
// the loop.  The four work arrays (res, s, As, dpsi: 4 x jmt x imt
// floats, 166 KB at 102x102) live in dynamic shared memory; the
// operator, preconditioner and island ids are read from global memory
// (they stay in L2).  A thread owns cells tid, tid+1024, ...; a cell
// whose value is a cyclic copy (border) is computed from its source
// cell, which is why res/s/As/dpsi sit in shared memory where every
// thread can read every cell.
//
// Loop rules (a device loop that never ends hangs the card): the
// iteration loop runs at most max_iter trips; the scalars (alpha, the
// error estimate, `done`) are computed by thread 0 after each
// reduction and broadcast through shared memory, so every thread takes
// the same branch; the loop is left only through `done`, by all threads
// at once; every __syncthreads() is reached by all 1024 threads on
// every trip.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 1024;
constexpr int NWARP = NT / 32;
constexpr int MAXISLE = 16;
constexpr int NRED = MAXISLE;   // widest reduction

struct Args {
  const float* __restrict__ cf;      // (9, jmt, imt) operator at unit timestep
  const float* __restrict__ zpre;    // (jmt, imt) preconditioner at unit timestep
  const int* __restrict__ pid;       // (jmt, imt) island index or -1
  const float* __restrict__ rcount;  // (nisle,) 1/perimeter count
  const float* __restrict__ guess;   // (jmt, imt)
  const float* __restrict__ forc;    // (jmt, imt)
  float* __restrict__ dpsi_out;      // (jmt, imt)
  int* __restrict__ iters_out;       // (1,)
  int jmt, imt, nisle, max_iter, cyclic;
  float c2dtsf, tol;
};

struct Scalars {
  float ww;        // dot2(w, w)
  float dz;        // deflation factor of the preconditioned residual
  float dr;        // deflation factor of the residual / iterate
  float betak, betakm1, bfac;
  float alpha, step1, est;
  int k, done;
  float sk[MAXISLE];
};

// Block-wide reduction of NV values (bit q of maxmask: max, else sum).
// Thread 0 hands the results to `fin`, which writes shared scalars;
// the closing barrier publishes them to every thread.
template <int NV, class Fin>
__device__ __forceinline__ void block_reduce(float (&v)[NV], unsigned maxmask,
                                             float* red, Fin fin) {
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < NV; ++q) {
    bool mx = (maxmask >> q) & 1u;
    float x = v[q];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      float y = __shfl_down_sync(0xffffffffu, x, o);
      x = mx ? fmaxf(x, y) : x + y;
    }
    if (lane == 0) red[warp * NV + q] = x;
  }
  __syncthreads();
  if (warp == 0) {
    float tot[NV];
#pragma unroll
    for (int q = 0; q < NV; ++q) {
      bool mx = (maxmask >> q) & 1u;
      float x = red[lane * NV + q];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        float y = __shfl_down_sync(0xffffffffu, x, o);
        x = mx ? fmaxf(x, y) : x + y;
      }
      tot[q] = x;
    }
    if (lane == 0) fin(tot);
  }
  __syncthreads();
}

struct Grid {
  const Args& a;
  int n;
  // source cell of the border operation (poisson.F border): -1 where the
  // value is zero (boundary rows, closed zonal walls)
  __device__ int src(int c) const {
    int j = c / a.imt, i = c - j * a.imt;
    if (j == 0 || j == a.jmt - 1) return -1;
    if (i == 0) return a.cyclic ? c + a.imt - 2 : -1;
    if (i == a.imt - 1) return a.cyclic ? c - a.imt + 2 : -1;
    return c;
  }
  __device__ bool interior(int c) const {
    int j = c / a.imt, i = c - j * a.imt;
    return j > 0 && j < a.jmt - 1 && i > 0 && i < a.imt - 1;
  }
  // deflation vector: border(zpre != 0)
  __device__ float w(int c) const {
    int s = src(c);
    return (s >= 0 && a.zpre[s] != 0.f) ? 1.f : 0.f;
  }
  // (A x)(c) at unit timestep / c2dtsf, interior cells only
  __device__ float apply_op(const float* x, int c) const {
    if (!interior(c)) return 0.f;
    float acc = 0.f;
    int q = 0;
    for (int dj = -1; dj <= 1; ++dj)
      for (int di = -1; di <= 1; ++di, ++q)
        acc += a.cf[q * n + c] * x[c + dj * a.imt + di];
    return acc * (1.f / a.c2dtsf);
  }
};

__global__ void __launch_bounds__(NT, 1) congrad_kernel(Args a) {
  extern __shared__ float smem[];
  __shared__ float red[NWARP * NRED];
  __shared__ Scalars sc;
  const int n = a.jmt * a.imt;
  float* res = smem;
  float* s = smem + n;
  float* as = smem + 2 * n;
  float* dpsi = smem + 3 * n;
  Grid g{a, n};
  const int tid = threadIdx.x;
  const float zfac = a.c2dtsf;   // preconditioner at this timestep
  const int nisle = a.nisle;
  const float tol = a.tol;

  // island sums of x over perimeter cells, into sc.sk (times rcount when
  // `avg`); x(c) is evaluated by the caller's functor
  auto island_sums = [&](auto x, bool avg) {
    float v[NRED];
#pragma unroll
    for (int q = 0; q < NRED; ++q) v[q] = 0.f;
    for (int c = tid; c < n; c += NT) {
      int p = a.pid[c];
      if (p >= 0) {
        float xc = x(c);
#pragma unroll
        for (int q = 0; q < NRED; ++q) if (q == p) v[q] += xc;
      }
    }
    block_reduce(v, 0u, red, [&](float* t) {
      for (int q = 0; q < nisle; ++q) sc.sk[q] = avg ? t[q] * a.rcount[q] : t[q];
    });
  };
  // value of island_dist(x) at source cell sc_: the island's sum (or
  // average) on perimeter cells, x elsewhere
  auto dist = [&](float xs, int s_) {
    int p = a.pid[s_];
    return p >= 0 ? sc.sk[p] : xs;
  };

  // ---- setup --------------------------------------------------------
  {
    float v[2] = {0.f, 0.f};
    for (int c = tid; c < n; c += NT) {
      int sc_ = g.src(c);
      float d = sc_ >= 0 ? a.guess[sc_] : 0.f;
      dpsi[c] = d;
      if (g.interior(c)) {
        float w = g.w(c);
        v[0] += w * w;
        v[1] += d * w;
      }
    }
    block_reduce(v, 0u, red, [&](float* t) {
      sc.ww = t[0];
      sc.dr = t[1] / t[0];
      sc.k = 0;
      sc.betakm1 = 1.f;
      sc.step1 = 0.f;
      sc.est = 0.f;
    });
    for (int c = tid; c < n; c += NT) dpsi[c] -= sc.dr * g.w(c);
  }
  __syncthreads();
  {
    // res = deflate(border((forc - A dpsi) * interior)); raw into `as`
    float v[1] = {0.f};
    for (int c = tid; c < n; c += NT) {
      int sc_ = g.src(c);
      float r = 0.f;
      if (sc_ >= 0 && g.interior(sc_)) r = a.forc[sc_] - g.apply_op(dpsi, sc_);
      as[c] = r;
      if (g.interior(c)) v[0] += r * g.w(c);
    }
    block_reduce(v, 0u, red, [&](float* t) { sc.dr = t[0] / sc.ww; });
    for (int c = tid; c < n; c += NT) {
      res[c] = as[c] - sc.dr * g.w(c);
      s[c] = 0.f;
    }
  }
  // trivially done: 100 * max|inv_op(res)| < tol
  island_sums([&](int c) { return a.zpre[c] * zfac * res[c]; }, false);
  {
    float v[1] = {0.f};
    for (int c = tid; c < n; c += NT) {
      int sc_ = g.src(c);
      float zr = sc_ >= 0 ? dist(a.zpre[sc_] * zfac * res[sc_], sc_) : 0.f;
      v[0] = fmaxf(v[0], fabsf(zr));
    }
    block_reduce(v, 1u, red, [&](float* t) { sc.done = (100.f * t[0] < tol); });
  }

  // ---- iterations: at most max_iter trips, block-uniform exit ---------
  for (int it = 0; it < a.max_iter; ++it) {
    if (sc.done) break;
    // zres = deflate(border(island_sum_dist(Z res)))
    island_sums([&](int c) { return a.zpre[c] * zfac * res[c]; }, false);
    {
      float v[1] = {0.f};
      for (int c = tid; c < n; c += NT) {
        int sc_ = g.src(c);
        float zr = sc_ >= 0 ? dist(a.zpre[sc_] * zfac * res[sc_], sc_) : 0.f;
        as[c] = zr;
        if (g.interior(c)) v[0] += zr * g.w(c);
      }
      block_reduce(v, 0u, red, [&](float* t) { sc.dz = t[0] / sc.ww; });
    }
    {
      // betak = dot2(zres, res)
      float v[1] = {0.f};
      for (int c = tid; c < n; c += NT)
        if (g.interior(c)) v[0] += (as[c] - sc.dz * g.w(c)) * res[c];
      block_reduce(v, 0u, red, [&](float* t) {
        sc.betak = t[0];
        float den = fabsf(sc.betakm1) > 0.f ? sc.betakm1 : 1.f;
        sc.bfac = t[0] / den;
      });
    }
    for (int c = tid; c < n; c += NT)
      s[c] = (as[c] - sc.dz * g.w(c)) + sc.bfac * s[c];
    __syncthreads();
    {
      // As = border(A s); s.As and max|s|
      float v[2] = {0.f, 0.f};
      for (int c = tid; c < n; c += NT) {
        int sc_ = g.src(c);
        float x = sc_ >= 0 ? g.apply_op(s, sc_) : 0.f;
        as[c] = x;
        if (g.interior(c)) v[0] += s[c] * x;
        v[1] = fmaxf(v[1], fabsf(s[c]));
      }
      block_reduce(v, 2u, red, [&](float* t) {
        float betak = sc.betak;
        bool safe = fabsf(t[0]) > fabsf(betak) * 1e-10f;
        float alpha = safe ? betak / t[0] : 0.f;
        int k = sc.k + 1;
        float step = fabsf(alpha) * t[1];
        if (k == 1) sc.step1 = step;
        bool small = step < tol;
        bool done;
        if (k == 1) {
          sc.est = step;
          done = step < tol;
        } else if (small) {
          // geometric-series error extrapolation (congrad.F:415-426)
          float rate = expf(logf(fmaxf(step / sc.step1, 1e-30f)) / (float)(k - 1));
          sc.est = step * rate / (1.f - rate);
          done = sc.est < tol;
        } else {
          done = false;
        }
        sc.alpha = alpha;
        sc.k = k;
        sc.done = done || !safe;
        sc.betakm1 = betak;
      });
    }
    // dpsi += alpha s; res - alpha As, then its island averages
    for (int c = tid; c < n; c += NT) {
      dpsi[c] += sc.alpha * s[c];
      res[c] -= sc.alpha * as[c];
    }
    island_sums([&](int c) { return res[c]; }, true);
    {
      // res = deflate(border(island_avg_dist(res))); raw into `as`
      float v[1] = {0.f};
      for (int c = tid; c < n; c += NT) {
        int sc_ = g.src(c);
        float r = sc_ >= 0 ? dist(res[sc_], sc_) : 0.f;
        as[c] = r;
        if (g.interior(c)) v[0] += r * g.w(c);
      }
      block_reduce(v, 0u, red, [&](float* t) { sc.dr = t[0] / sc.ww; });
    }
    for (int c = tid; c < n; c += NT) res[c] = as[c] - sc.dr * g.w(c);
  }

  // ---- deflate the iterate and write out -----------------------------
  __syncthreads();
  {
    float v[1] = {0.f};
    for (int c = tid; c < n; c += NT)
      if (g.interior(c)) v[0] += dpsi[c] * g.w(c);
    block_reduce(v, 0u, red, [&](float* t) { sc.dr = t[0] / sc.ww; });
  }
  for (int c = tid; c < n; c += NT) a.dpsi_out[c] = dpsi[c] - sc.dr * g.w(c);
  if (tid == 0) a.iters_out[0] = sc.k;
}

}  // namespace

extern "C" int uvic_congrad(const float* cf, const float* zpre, const int* pid,
                            const float* rcount, const float* guess,
                            const float* forc, float* dpsi_out, int* iters_out,
                            int jmt, int imt, int nisle, int max_iter,
                            int cyclic, float c2dtsf, float tol, void* stream) {
  if (nisle > MAXISLE || nisle < 0) return (int)cudaErrorInvalidValue;
  size_t bytes = (size_t)4 * jmt * imt * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      congrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  Args a{cf, zpre, pid, rcount, guess, forc, dpsi_out, iters_out,
         jmt, imt, nisle, max_iter, cyclic, c2dtsf, tol};
  congrad_kernel<<<1, NT, bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
