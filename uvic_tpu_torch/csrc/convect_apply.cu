// Full-convection region-mean apply for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel uvic_tpu/ops/convection.py:
// _apply_region_means_pallas.  out[n, k] = sum_l M[k, l] * t[n, l] on
// ocean cells, t passed through elsewhere; M is the normalised
// region-membership matrix of the complete convection scheme (convct2,
// convect.F:99-311), built from the stable labels in convct_full.
//
// What bounds it: bytes.  At the flagship shape M alone is
// 19 x 19 x 102 x 102 floats = 15 MB; with t, the ocean mask and the
// output a call moves ~19 MB: ~6 us at 3.35 TB/s, against 2 flops per
// M entry and tracer.
//
// Design.  One thread per output (k, j, i), looping over tracers and
// over l: M is read once for the first tracer (coalesced: neighbouring
// threads hold neighbouring i) and from L2 for the next; the column of
// t is re-read km times, from L1/L2.  This keeps 10x more threads in
// flight than one thread per (n, j, i) column would (km x 102 x 102 =
// 198k at the flagship shape), which a memory-bound kernel needs to
// fill the card.  The sum runs in the order of the TPU kernel
// (l = 0, 1, ...).  The loops have fixed trip counts (nt, km).

#include <cuda_runtime.h>

namespace {

__global__ void region_means_kernel(const float* __restrict__ ts,
                                    const float* __restrict__ m,
                                    const float* __restrict__ ocean,
                                    float* __restrict__ out,
                                    int nt, int km, int plane) {
  int tid = blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= km * plane) return;
  int k = tid / plane, c = tid - k * plane;
  bool wet = ocean[tid] > 0.f;
  const float* mk = m + (size_t)k * km * plane + c;
  for (int n = 0; n < nt; ++n) {
    const float* t = ts + (size_t)n * km * plane + c;
    float acc;
    if (wet) {
      acc = mk[0] * t[0];
      for (int l = 1; l < km; ++l) acc += mk[(size_t)l * plane] * t[(size_t)l * plane];
    } else {
      acc = t[(size_t)k * plane];
    }
    out[((size_t)n * km + k) * plane + c] = acc;
  }
}

}  // namespace

extern "C" int uvic_region_means_apply(const float* ts, const float* m,
                                       const float* ocean, float* out,
                                       int nt, int km, int plane,
                                       void* stream) {
  int cells = km * plane;
  region_means_kernel<<<(cells + 255) / 256, 256, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      ts, m, ocean, out, nt, km, plane);
  return (int)cudaGetLastError();
}
