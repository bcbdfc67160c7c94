// Island-constrained preconditioned CG in one thread-block cluster, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel inside uvic_tpu/ops/pallas_cg.py:
// make_pallas_congrad (the `kernel` closure).  The algorithm is
// congrad.F (Dukowicz, Smith & Malone 1993) in the Pallas kernel's
// sequence of operations: 9-point operator at unit timestep scaled by
// 1/c2dtsf, diagonal preconditioner, island sum/average redistribution
// over perimeter cells, constant-mode deflation of the residuals and the
// result, and the geometric-series error-extrapolation stop
// (congrad.F:62-105).  The iterate starts from border(guess) itself, as
// in ops/solvers.congrad: the constant is a null vector of the curl-form
// streamfunction operator on a cyclic grid, not where the active set
// meets a wall nor of the free-surface operator, so deflating the guess
// would change their problem.
//
// What bounds it: latency.  The 102x102 solve moves ~0.5 MB and does
// ~1 MFLOP per iteration; its time is the chain of dependent global
// reductions (six per iteration), each a barrier across every thread
// that holds a part of the grid.
//
// Design.  One cluster of C CTAs on neighbouring SMs: 16 by default, a
// non-portable size, as the more CTAs the fewer cells each walks between
// two cluster barriers (10.6 against 11.0 us per iteration for 8, the
// portable size, on an H100 80GB HBM3 at 700 W; chip_smoke.py times
// both).  CTA r owns a band of rows [bands[r], bands[r+1])
// and copies, once, with cp.async, its band of the nine operator planes
// and the preconditioner into its shared memory, with the border-source
// and island ids of its cells (one packed int per cell: no integer
// division in the loop) and its part of the island perimeters as a list
// sorted by island.  The work arrays res, As, dpsi and zres of the band
// live there too, and s twice (the iterate of this trip and of the
// last) with one halo row above and below.  The cyclic border copies
// columns within a row, so it stays inside a band.
//
// Halo: after the reduction that gives beta, a CTA computes the new s
// of its halo rows itself, from the neighbour's zres and old s read
// through distributed shared memory with the same fused multiply-add
// the neighbour uses, so the halo costs no barrier of its own.
//
// Reductions: warp shuffles, then across the CTA's warps (one
// __syncthreads), then each CTA writes its partials into slot r of
// every CTA's shared memory (double-buffered by the parity of the
// reduction count), one cluster barrier, and every thread sums the C
// slots in rank order.  All threads of all CTAs thus hold bit-identical
// scalars (alpha, the error estimate, `done`) and take the same branch
// without a broadcast.  Island sums run over `nisle` values, one warp
// per island, and only over the band's perimeter list.  The deflation
// dot product of the iterate rides along with the residual's island
// sums, where dpsi is already final, so the close needs no reduction.
// Per iteration: 6 cluster barriers (4 on the last trip); setup 4.
//
// Loop rules (a device loop that never ends hangs the card): the
// iteration loop runs at most max_iter trips; it is left through
// `done` or the trip count, both identical in every thread of the
// cluster; every __syncthreads() and cluster barrier is reached by
// every thread of every CTA on every trip.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 512;
constexpr int NWARP = NT / 32;
constexpr int MAXC = 16;              // cluster size, non-portable above 8
constexpr int MAXISLE = NWARP;        // islands: warp q sums island q, the last warp
                                      // the dense values too
constexpr int NDENSE = 2;             // dense values per reduction at most
constexpr int NSLOT = MAXISLE + NDENSE;

struct Args {
  const float* __restrict__ cf;      // (9, jmt, imt) operator at unit timestep
  const float* __restrict__ zpre;    // (jmt, imt) preconditioner at unit timestep
  const int* __restrict__ src;       // (jmt, imt) flat index of the border source, or -1
  const int* __restrict__ pid;       // (jmt, imt) island index or -1
  const float* __restrict__ rcount;  // (nisle,) 1/perimeter count
  const int* __restrict__ bands;     // (C+1,) row bounds of the bands
  const int* __restrict__ plist;     // perimeter cells (flat), by band then island
  const int* __restrict__ poff;      // (C*nisle+1,) segment offsets into plist
  const float* __restrict__ guess;   // (jmt, imt)
  const float* __restrict__ forc;    // (jmt, imt)
  float* __restrict__ dpsi_out;      // (jmt, imt)
  int* __restrict__ iters_out;       // (2,): iterations, CTAs in the cluster
  int jmt, imt, nisle, max_iter, rmax, npmax;
  float c2dtsf, tol;
};

// shared-memory words of one CTA: 16 band planes, two s planes with
// their halo rows, the perimeter list (cg_kernel.py: cg_smem_bytes)
__host__ __device__ inline size_t smem_words(int rmax, int imt, int npmax) {
  size_t n = (size_t)rmax * imt;
  return 16 * n + 2 * (n + 2 * (size_t)imt) + (size_t)npmax;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

// the one expression for s <- zres + beta s, used for own and halo rows
__device__ __forceinline__ float s_update(float zres, float bfac, float s) {
  return __fmaf_rn(bfac, s, zres);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_down_sync(0xffffffffu, x, o));
  return x;
}

struct Band {
  const Args& a;
  cg::cluster_group cl;
  int rank, C, row0, nrow, n, tid, lane, warp;
  float* cf;    // 9 planes of n
  float* zl;    // preconditioner x c2dtsf
  float* w;     // deflation vector border(zpre != 0)
  float* res;
  float* as;
  float* dpsi;
  float* zres;
  float* sb[2]; // s with one halo row above and below: (nrow + 2) x imt
  int* info;    // (src local offset + 1) | (island id of the source + 1) << 20
  int* plist;   // local offsets of the band's perimeter cells
  float* slots; // [2][MAXC][NSLOT]
  float* red;   // [NWARP][NDENSE]
  int* pseg;    // [MAXISLE + 1] segment bounds of the band's islands
  float* rc;    // [MAXISLE]
  float* remote;  // lane t < C: slots of CTA t
  int phase;

  __device__ int srcl(int l) const { return (info[l] & 0xfffff) - 1; }
  __device__ int psrc(int l) const { return (info[l] >> 20) - 1; }
  // (A x)(l) at unit timestep / c2dtsf; x is a halo-padded plane
  __device__ float apply_op(const float* x, int l) const {
    const float* xc = x + l + a.imt;
    float acc = 0.f;
    int q = 0;
#pragma unroll
    for (int dj = -1; dj <= 1; ++dj)
#pragma unroll
      for (int di = -1; di <= 1; ++di, ++q)
        acc += cf[q * n + l] * xc[dj * a.imt + di];
    return acc * (1.f / a.c2dtsf);
  }
  // island q's total, summed over the C slots in rank order
  __device__ float island_total(int q, int buf) const {
    const float* s = slots + (size_t)buf * MAXC * NSLOT + NDENSE + q;
    float acc = s[0];
    for (int r = 1; r < C; ++r) acc += s[r * NSLOT];
    return acc;
  }

  // Cluster-wide reduction of NV dense values (bit q of maxmask: max of
  // values >= 0, else sum) and, with ISL, of the island sums of xisl(l)
  // over the perimeter lists.  Returns the buffer holding the slots.
  template <int NV, bool ISL, class XF>
  __device__ int reduce(float (&v)[NV], unsigned maxmask, XF xisl) {
    const int buf = phase & 1;
    ++phase;
#pragma unroll
    for (int q = 0; q < NV; ++q) {
      float x = ((maxmask >> q) & 1u) ? warp_max(v[q]) : warp_sum(v[q]);
      if (lane == 0) red[warp * NDENSE + q] = x;
    }
    __syncthreads();
    float* dst = remote + (size_t)buf * MAXC * NSLOT + rank * NSLOT;
    if (NV > 0 && warp == NWARP - 1) {
#pragma unroll
      for (int q = 0; q < NV; ++q) {
        float x = lane < NWARP ? red[lane * NDENSE + q] : 0.f;
        x = ((maxmask >> q) & 1u) ? warp_max(x) : warp_sum(x);
        x = __shfl_sync(0xffffffffu, x, 0);
        if (lane < C) dst[q] = x;
      }
    }
    if (ISL && warp < a.nisle) {   // nisle <= NWARP
      float x = 0.f;
      for (int e = pseg[warp] + lane; e < pseg[warp + 1]; e += 32) x += xisl(plist[e]);
      x = __shfl_sync(0xffffffffu, warp_sum(x), 0);
      if (lane < C) dst[NDENSE + warp] = x;
    }
    cl.sync();
    const float* s = slots + (size_t)buf * MAXC * NSLOT;
#pragma unroll
    for (int q = 0; q < NV; ++q) {
      bool mx = (maxmask >> q) & 1u;
      float acc = s[q];
      for (int r = 1; r < C; ++r) acc = mx ? fmaxf(acc, s[r * NSLOT + q]) : acc + s[r * NSLOT + q];
      v[q] = acc;
    }
    return buf;
  }
};

__global__ void __launch_bounds__(NT, 1) congrad_cluster_kernel(Args a) {
  extern __shared__ float smem[];
  __shared__ float slots[2 * MAXC * NSLOT];
  __shared__ float red[NWARP * NDENSE];
  __shared__ int pseg[MAXISLE + 1];
  __shared__ float rc[MAXISLE];

  cg::cluster_group cl = cg::this_cluster();
  Band b{a, cl};
  b.rank = (int)cl.block_rank();
  b.C = (int)cl.num_blocks();
  b.row0 = a.bands[b.rank];
  b.nrow = a.bands[b.rank + 1] - b.row0;
  b.n = b.nrow * a.imt;
  b.tid = threadIdx.x;
  b.lane = b.tid & 31;
  b.warp = b.tid >> 5;
  const int imt = a.imt, n = b.n, tid = b.tid;
  const size_t N = (size_t)a.rmax * imt;   // plane stride, the same in every CTA
  b.cf = smem;
  b.zl = smem + 9 * N;
  b.w = smem + 10 * N;
  b.res = smem + 11 * N;
  b.as = smem + 12 * N;
  b.dpsi = smem + 13 * N;
  b.zres = smem + 14 * N;
  b.info = reinterpret_cast<int*>(smem + 15 * N);
  b.sb[0] = smem + 16 * N;
  b.sb[1] = smem + 17 * N + 2 * imt;
  b.plist = reinterpret_cast<int*>(smem + 18 * N + 4 * imt);
  b.slots = slots;
  b.red = red;
  b.pseg = pseg;
  b.rc = rc;
  b.phase = 0;
  b.remote = b.lane < b.C ? cl.map_shared_rank(static_cast<float*>(slots), b.lane) : slots;
  // the band's cf planes are rows [row0, row0+nrow) of each plane, which
  // the CTA keeps at plane stride n (not N) so that cf[q*n + l] is dense
  const size_t g0 = (size_t)b.row0 * imt, plane = (size_t)a.jmt * imt;

  // ---- load the band -------------------------------------------------
  for (int l = tid; l < n; l += NT) {
#pragma unroll
    for (int q = 0; q < 9; ++q) cp_async4(&b.cf[q * n + l], &a.cf[q * plane + g0 + l]);
    cp_async4(&b.zl[l], &a.zpre[g0 + l]);
    int sg = a.src[g0 + l];
    int sl = sg >= 0 ? (int)(sg - g0) : -1;
    int ps = sg >= 0 ? a.pid[sg] : -1;
    b.info[l] = (sl + 1) | ((ps + 1) << 20);
    b.w[l] = (sg >= 0 && a.zpre[sg] != 0.f) ? 1.f : 0.f;
  }
  asm volatile("cp.async.commit_group;\n" ::);
  {
    const int* seg = a.poff + b.rank * a.nisle;
    if (tid <= a.nisle) pseg[tid] = seg[tid] - seg[0];
    if (tid < a.nisle) rc[tid] = a.rcount[tid];
    int p0 = a.nisle > 0 ? seg[0] : 0, p1 = a.nisle > 0 ? seg[a.nisle] : 0;
    for (int e = p0 + tid; e < p1; e += NT) b.plist[e - p0] = (int)(a.plist[e] - g0);
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
  for (int l = tid; l < n; l += NT) b.zl[l] *= a.c2dtsf;
  // every CTA of the cluster is running before any slot is written
  cl.sync();

  auto none = [](int) { return 0.f; };

  // ---- setup: ww ------------------------------------------------------
  float ww, dr;
  {
    float v[1] = {0.f};
    for (int l = tid; l < n; l += NT) {
      if (b.srcl(l) == l) {
        float wl = b.w[l];
        v[0] += wl * wl;
      }
    }
    b.reduce<1, false>(v, 0u, none);
    ww = v[0];
  }
  // dpsi = border(guess) with its halo rows in sb[1];
  // res = deflate(border(forc - A dpsi))
  float* sh = b.sb[1];
  for (int l = tid - imt; l < n + imt; l += NT) {
    long c = (long)g0 + l;
    if (c < 0 || c >= (long)plane) continue;
    int sg = a.src[c];
    float d = sg >= 0 ? a.guess[sg] : 0.f;
    sh[l + imt] = d;
    if (l >= 0 && l < n) b.dpsi[l] = d;
  }
  __syncthreads();
  float dpw;   // dot2(dpsi, w) of the latest dpsi
  {
    float v[2] = {0.f, 0.f};
    for (int l = tid; l < n; l += NT) {
      int sl = b.srcl(l);
      float r = sl >= 0 ? a.forc[g0 + sl] - b.apply_op(sh, sl) : 0.f;
      b.as[l] = r;
      if (sl == l) {
        v[0] += r * b.w[l];
        v[1] += b.dpsi[l] * b.w[l];
      }
    }
    b.reduce<2, false>(v, 0u, none);
    dr = v[0] / ww;
    dpw = v[1];
  }
  float* s_cur = b.sb[0];
  for (int l = tid; l < n; l += NT) b.res[l] = b.as[l] - dr * b.w[l];
  for (int l = tid; l < n + 2 * imt; l += NT) s_cur[l] = 0.f;

  // zres (raw) = border(island_sum_dist(Z res)), its dot with w and its
  // max; returns dz
  auto precondition = [&](float& mx) {
    float v0[1] = {0.f};
    int buf = b.reduce<1, true>(v0, 0u, [&](int l) { return b.zl[l] * b.res[l]; });
    float v[2] = {0.f, 0.f};
    for (int l = tid; l < n; l += NT) {
      int sl = b.srcl(l), ps = b.psrc(l);
      float x = sl < 0 ? 0.f : (ps >= 0 ? b.island_total(ps, buf) : b.zl[sl] * b.res[sl]);
      b.zres[l] = x;
      if (sl == l) v[0] += x * b.w[l];
      v[1] = fmaxf(v[1], fabsf(x));
    }
    b.reduce<2, false>(v, 2u, none);
    mx = v[1];
    return v[0] / ww;
  };

  float mx;
  float dz = precondition(mx);
  bool done = 100.f * mx < a.tol;
  int k = 0;
  float betakm1 = 1.f, step1 = 0.f, est = 0.f;

  // ---- iterations: at most max_iter trips, cluster-uniform exit -------
  while (k < a.max_iter && !done) {
    // zres = deflate(raw); betak = dot2(zres, res)
    float betak, bfac;
    {
      float v[1] = {0.f};
      for (int l = tid; l < n; l += NT) {
        float z = b.zres[l] - dz * b.w[l];
        b.zres[l] = z;
        if (b.srcl(l) == l) v[0] += z * b.res[l];
      }
      b.reduce<1, false>(v, 0u, none);
      betak = v[0];
      float den = fabsf(betakm1) > 0.f ? betakm1 : 1.f;
      bfac = betak / den;
    }
    // s = zres + bfac s, own rows and the halo rows from the neighbours
    float* s_new = (s_cur == b.sb[0]) ? b.sb[1] : b.sb[0];
    for (int l = tid; l < n; l += NT)
      s_new[l + imt] = s_update(b.zres[l], bfac, s_cur[l + imt]);
    if (b.rank > 0) {
      int nr = a.bands[b.rank] - a.bands[b.rank - 1];
      const float* zr = cl.map_shared_rank(b.zres, b.rank - 1);
      const float* sr = cl.map_shared_rank(s_cur, b.rank - 1);
      for (int i = tid; i < imt; i += NT) {
        int o = (nr - 1) * imt + i;
        s_new[i] = s_update(zr[o], bfac, sr[o + imt]);
      }
    }
    if (b.rank < b.C - 1) {
      const float* zr = cl.map_shared_rank(b.zres, b.rank + 1);
      const float* sr = cl.map_shared_rank(s_cur, b.rank + 1);
      for (int i = tid; i < imt; i += NT)
        s_new[(b.nrow + 1) * imt + i] = s_update(zr[i], bfac, sr[i + imt]);
    }
    s_cur = s_new;
    __syncthreads();
    // As = border(A s); dot2(s, As) and max|s|; alpha and the stop rule
    float alpha;
    {
      float v[2] = {0.f, 0.f};
      for (int l = tid; l < n; l += NT) {
        int sl = b.srcl(l);
        float x = sl >= 0 ? b.apply_op(s_cur, sl) : 0.f;
        b.as[l] = x;
        float sv = s_cur[l + imt];
        if (sl == l) v[0] += sv * x;
        v[1] = fmaxf(v[1], fabsf(sv));
      }
      b.reduce<2, false>(v, 2u, none);
      bool safe = fabsf(v[0]) > fabsf(betak) * 1e-10f;
      alpha = safe ? betak / v[0] : 0.f;
      ++k;
      float step = fabsf(alpha) * v[1];
      if (k == 1) {
        step1 = step;
        est = step;
        done = step < a.tol;
      } else if (step < a.tol) {
        // geometric-series error extrapolation (congrad.F:415-426)
        float rate = expf(logf(fmaxf(step / step1, 1e-30f)) / (float)(k - 1));
        est = step * rate / (1.f - rate);
        done = est < a.tol;
      }
      done = done || !safe;
      betakm1 = betak;
    }
    // dpsi += alpha s; res - alpha As; its island sums and dot2(dpsi, w)
    int buf;
    {
      float v[1] = {0.f};
      for (int l = tid; l < n; l += NT) {
        float d = b.dpsi[l] + alpha * s_cur[l + imt];
        b.dpsi[l] = d;
        b.res[l] = b.res[l] - alpha * b.as[l];
        if (b.srcl(l) == l) v[0] += d * b.w[l];
      }
      buf = b.reduce<1, true>(v, 0u, [&](int l) { return b.res[l]; });
      dpw = v[0];
    }
    if (done) break;
    // res = deflate(border(island_avg_dist(res))), raw into `as`
    {
      float v[1] = {0.f};
      for (int l = tid; l < n; l += NT) {
        int sl = b.srcl(l), ps = b.psrc(l);
        float r = sl < 0 ? 0.f : (ps >= 0 ? b.island_total(ps, buf) * rc[ps] : b.res[sl]);
        b.as[l] = r;
        if (sl == l) v[0] += r * b.w[l];
      }
      b.reduce<1, false>(v, 0u, none);
      dr = v[0] / ww;
    }
    for (int l = tid; l < n; l += NT) b.res[l] = b.as[l] - dr * b.w[l];
    if (k < a.max_iter) dz = precondition(mx);
  }

  // ---- deflate the iterate and write out -----------------------------
  dr = dpw / ww;
  for (int l = tid; l < n; l += NT) a.dpsi_out[g0 + l] = b.dpsi[l] - dr * b.w[l];
  if (b.rank == 0 && tid == 0) {
    a.iters_out[0] = k;
    a.iters_out[1] = b.C;
  }
  // no CTA leaves while another may still address its shared memory
  cl.sync();
}

}  // namespace

// Shared-memory and cluster attributes of the kernel and its launch
// configuration (one cluster of `cluster` CTAs).
static cudaError_t cluster_config(int cluster, size_t bytes, cudaStream_t stream,
                                  cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr) {
  cudaError_t err = cudaFuncSetAttribute(
      congrad_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && cluster > 8)
    err = cudaFuncSetAttribute(congrad_cluster_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return err;
}

extern "C" int uvic_congrad(const float* cf, const float* zpre, const int* src,
                            const int* pid, const float* rcount, const int* bands,
                            const int* plist, const int* poff, const float* guess,
                            const float* forc, float* dpsi_out, int* iters_out,
                            int jmt, int imt, int nisle, int max_iter, int cluster,
                            int rmax, int npmax, int smem_bytes, float c2dtsf,
                            float tol, void* stream) {
  if (nisle > MAXISLE || nisle < 0 || cluster < 1 || cluster > MAXC)
    return (int)cudaErrorInvalidValue;
  size_t bytes = smem_words(rmax, imt, npmax) * sizeof(float);
  if (bytes != (size_t)smem_bytes) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config(cluster, bytes, static_cast<cudaStream_t>(stream), cfg, attr);
  if (err != cudaSuccess) return (int)err;
  Args a{cf, zpre, src, pid, rcount, bands, plist, poff, guess, forc, dpsi_out,
         iters_out, jmt, imt, nisle, max_iter, rmax, npmax, c2dtsf, tol};
  err = cudaLaunchKernelEx(&cfg, congrad_cluster_kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many clusters of `cluster` CTAs with `smem_bytes` of dynamic
// shared memory each the card can hold at once (0: the launch cannot
// run), or a negative CUDA error.
extern "C" int uvic_congrad_max_clusters(int cluster, int smem_bytes) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config(cluster, smem_bytes, nullptr, cfg, attr);
  int count = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(&count, congrad_cluster_kernel, &cfg);
  return err == cudaSuccess ? count : -(int)err;
}
