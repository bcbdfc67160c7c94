// Full-convection region-mean apply for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel uvic_tpu/ops/convection.py:
// _apply_region_means_pallas.  out[n, k] = sum_l M[k, l] * t[n, l] on
// ocean cells, t passed through elsewhere; M is the normalised
// region-membership matrix of the complete convection scheme (convct2,
// convect.F:99-311), built from the stable labels in convct_full.  It is
// computed as r + sum_l M[k, l] * (t[n, l] - r), r the tracer at the
// first level l with M[k, l] != 0 (the top of k's region): a row of M
// sums to one only to a rounding, the same at every step, which applied
// to the tracer's whole value drifts it; against r it weighs only the
// spread within the region, and every level of a region computes the
// same numbers (ops/convection.py:apply_region_means_ref).
//
// What bounds it: bytes.  A call reads t (nt x km planes), M (km x km
// planes) and the ocean mask once and writes nt x km planes: 80.7 MB at
// the full-MOBI flagship shape (nt 41, 102 x 102 x 19), against
// 2 km flops per output (~3.8 flop/byte, far below the fp32 ridge).
//
// Design.  A block owns a tile of C consecutive cells of the (jmt*imt)
// plane at every level; thread (c, k) (lanes along c) computes the
// outputs of cell c0 + c at level k for every tracer.
// - M is read once per call: each thread loads its row M[k, 0:km, c]
//   into registers (KMAX of them, km rounded up to a multiple of 4, a
//   template bound, fully unrolled and predicated on l < km) and its
//   ocean flag before the tracer loop.
// - Each tracer's tile t[n, 0:km, c0:c0+C] is staged in a ring of
//   STAGES slots of shared memory, STAGES - 1 tracers ahead, by
//   asynchronous copies: each thread copies its own cell (k, c) of the
//   tile with a 4-byte cp.async (a warp's copies are coalesced; any
//   plane and any partial last tile take the same copies), one commit
//   group per tracer.  A slot holds the tile column by column, each
//   column padded to stride<KMAX>() floats (4 mod 8, so that 8 lanes'
//   16-byte loads fall in distinct banks): all km threads of a column
//   read it with KMAX / 4 16-byte loads.
// - One __syncthreads per tracer, after the wait for its group, both
//   publishes the tile and frees the slot read for the tracer before,
//   which is then refilled.
// At the flagship, km 19 takes the KMAX 20 instantiation: blocks of
// 16 x 19 threads, 40 registers a thread on the H100, 4 blocks an SM, so
// 651 blocks in 1.23 waves.  Two designs tried first were slower: each level row staged by one cp.async.bulk on an mbarrier,
// from warp 0 (19 copies of 64 bytes a tile: the copies, not the bytes,
// set the time), and the tile held row by row, read with 4-byte shared
// loads; capping registers for more blocks an SM gained nothing.
// Each output is one chain of FMAs over l = 0 .. km-1, in that order
// (the order of the TPU kernel and of the first port of this kernel),
// on the differences t[n, l] - r.
// The host-side geometry (C, shared-memory bytes) comes from
// ops/convection.py:region_means_launch.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_THREADS = 512;   // ops/convection.py MAX_THREADS
constexpr int MAX_KM = 64;         // ops/convection.py MAX_KM
constexpr int STAGES = 8;          // ops/convection.py STAGES

// Floats between two columns of a staged tile.
template <int KMAX>
__host__ __device__ constexpr int stride() {
  return KMAX % 8 == 4 ? KMAX : KMAX + 4;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int KMAX>
__global__ void __launch_bounds__(MAX_THREADS)
region_means_kernel(const float* __restrict__ ts, const float* __restrict__ m,
                    const float* __restrict__ ocean, float* __restrict__ out,
                    int nt, int km, int plane) {
  constexpr int S = stride<KMAX>();
  extern __shared__ __align__(16) float tiles[];   // [slots][C][S]
  const int C = blockDim.x, c = threadIdx.x, k = threadIdx.y;
  const int g = blockIdx.x * C + c;    // cell of the plane
  const bool col = g < plane;
  const int tile = C * S;
  const size_t tracer = (size_t)km * plane;
  float* mine = tiles + c * S + k;     // this thread's cell of slot 0
  const float* src = ts + (size_t)k * plane + g;

  // tracers 0 .. STAGES-2, a commit group each (empty past nt)
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (col && s < nt) cp_async4(mine + s * tile, src + s * tracer);
    cp_async_commit();
  }

  // this thread's row of M and its ocean flag, read once
  const float* mk = m + (size_t)k * km * plane + g;
  float mrow[KMAX];
#pragma unroll
  for (int l = 0; l < KMAX; ++l)
    mrow[l] = (col && l < km) ? __ldg(mk + (size_t)l * plane) : 0.f;
  const bool wet = col && __ldg(ocean + (size_t)k * plane + g) > 0.f;
  int lref = k;                        // the top of this level's region
#pragma unroll
  for (int l = KMAX - 1; l >= 0; --l)
    if (l < km && mrow[l] != 0.f) lref = l;

  int slot = 0;                        // n % STAGES
  for (int n = 0; n < nt; ++n) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2) : "memory");
    __syncthreads();   // tracer n has landed; every thread is done with n-1
    const int ahead = n + STAGES - 1;  // into the slot of tracer n-1
    if (col && ahead < nt)
      cp_async4(mine + (slot == 0 ? STAGES - 1 : slot - 1) * tile,
                src + ahead * tracer);
    cp_async_commit();
    const float* column = tiles + slot * tile + c * S;
    const float4* t = reinterpret_cast<const float4*>(column);
    const float r = column[lref];
    float acc = 0.f;
#pragma unroll
    for (int q = 0; q < KMAX / 4; ++q) {
      const float4 v = t[q];
      const float tl[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int l = 4 * q + j;
        if (l == 0)
          acc = mrow[0] * (tl[0] - r);
        else if (l < km)
          acc += mrow[l] * (tl[j] - r);
      }
    }
    if (col)
      out[n * tracer + (size_t)k * plane + g] =
          wet ? r + acc : mine[slot * tile];
    slot = slot == STAGES - 1 ? 0 : slot + 1;
  }
}

using Kernel = void (*)(const float*, const float*, const float*, float*, int,
                        int, int);

// The instantiation for km levels (KMAX: km rounded up to a multiple of
// 4), with its column stride.
template <int KMAX = 4>
Kernel pick(int km, int* col_stride) {
  if constexpr (KMAX > MAX_KM) {
    return nullptr;
  } else {
    if (km > KMAX) return pick<KMAX + 4>(km, col_stride);
    *col_stride = stride<KMAX>();
    return region_means_kernel<KMAX>;
  }
}

// Shared-memory bytes of the ring, or -1 for a geometry the kernel does
// not take.
int smem_bytes(int nt, int km, int cols) {
  if (nt < 1 || km < 1 || km > MAX_KM || cols < 1 || cols * km < 32 ||
      cols * km > MAX_THREADS)
    return -1;
  int s = 0;
  pick(km, &s);
  return (nt < STAGES ? nt : STAGES) * cols * s * 4;
}

}  // namespace

// cols and smem from ops/convection.py:region_means_launch, checked here.
extern "C" int uvic_region_means_apply(const float* ts, const float* m,
                                       const float* ocean, float* out, int nt,
                                       int km, int plane, int cols, int smem,
                                       void* stream) {
  int s = 0;
  if (plane < 1 || smem < 0 || smem != smem_bytes(nt, km, cols))
    return (int)cudaErrorInvalidValue;
  pick(km, &s)<<<(plane + cols - 1) / cols, dim3(cols, km), smem,
                 static_cast<cudaStream_t>(stream)>>>(ts, m, ocean, out, nt,
                                                      km, plane);
  return (int)cudaGetLastError();
}

// Blocks of the kernel resident on one SM at this geometry, or a negative
// CUDA error.
extern "C" int uvic_region_means_blocks_per_sm(int nt, int km, int cols) {
  int smem = smem_bytes(nt, km, cols), s = 0, count = 0;
  if (smem < 0) return -(int)cudaErrorInvalidValue;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &count, pick(km, &s), cols * km, (size_t)smem);
  return err == cudaSuccess ? count : -(int)err;
}
