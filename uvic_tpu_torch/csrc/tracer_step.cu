// Fused FCT tracer step for Hopper (sm_90a), one launch.
//
// Replaces the Pallas TPU kernel uvic_tpu/ops/pallas_tracer.py:_kernel
// (built by make_fct_tracer_step).  One call updates every tracer:
// FCT dlm1 low-order upstream solution, Zalesak-limited antidiffusive
// x/y/z fluxes, harmonic horizontal diffusion (flux form when
// isopycnal mixing is on), explicit vertical diffusion with surface and
// bottom fluxes, the Redi/GM tendency from the 18-slot weight stack,
// the source add, the aidif implicit Thomas solve (invtri.F) and the
// setbcx, cyclic or with solid zonal walls (``cyclic`` 0: the two
// boundary columns of t_lo, of the x ratios and of the output are zero).  Reference: source/mom/tracer.F:678-916,
// tracer_adv_flx.F:376-1005, invtri.F:1-115.
//
// What bounds it: bytes, in principle.  At the flagship shape (nt=2,
// km=19, 102x102) one call must read ~23 MB (the 18-slot weight stack
// alone is 14 MB) and write 1.6 MB: ~7 us at 3.35 TB/s, against a few
// hundred flops per cell.  In practice the march down k is a chain of
// 19 dependent levels, each a few hundred instructions a thread between
// barriers, so the kernel is bound by that latency and by instruction
// throughput: its time does not change when L2 is flushed before the
// launch.
//
// Design.  The Zalesak limiter reaches two cells (a flux needs the
// neighbour's ratio, which needs the neighbour's t_lo), and the Thomas
// solve is a recursion down each column.  A block owns one whole row j
// of one tracer (grid = (jmt, nt): 204 blocks at the flagship, two per
// SM), two threads per column i, so the cyclic setbcx is a read of the
// mirror column inside the block, and marches down k.  Shared memory
// holds a rolling window of levels of the inputs on the rows j-2..j+2
// (periodic in j): tm1 for k-1..k+2, t_tau and tmask for k..k+2, the
// velocities for k+1, dcb for k-1..k, the source and the weights the
// row needs (rows j and j-1) for level k, and the level factors.  While
// level k computes, cp.async fetches the next level of each (one commit
// group per level, waited on one level later).  At each level the block
//   A. computes the low-order and raw antidiffusive fluxes of level k+1
//      once per face (rows j-2..j+1) into shared memory;
//   B. computes from them t_lo of level k+1 (in registers, at the mirror
//      column: setbcx) and the six ratios of level k+1 (x and z on row
//      j, y on rows j-1..j+1);
//   C. computes the limited fluxes, diffusion and vertical diffusion of
//      level k on row j (first half) and the Redi/GM tendency and source
//      (second half); the first half adds the two at the start of the
//      next level and runs the Thomas forward elimination, one thread
//      per column, with its coefficients in shared memory.
// The Thomas solve is for the increment y = z - x of x = t_new * mask
// (ops/tridiag.py:invtri): a wet row of the system sums to one, so
// A y = fluxes - a (x[k-1] - x[k]) - c (x[k+1] - x[k]), whose rounding
// scales with the implicit diffusion's increment instead of with the
// tracer (solved for z itself, a column mixed by a large K33 drifts by
// an ulp of the tracer a step).  Level k's right side needs x[k+1], so
// its elimination is completed one level later.  x goes to the output
// as its level is eliminated; back-substitution after the last level
// adds y, each duplicated column computed at its mirror (setbcx).  No global
// scratch; three __syncthreads() per level.  The rows j+-1, j+-2 are
// fetched by five blocks (from L2); the weights by at most two.  A
// ratio's quotient is the correctly rounded reciprocal times the
// numerator: within an ulp of the division, and much cheaper than it.

#include <cuda_runtime.h>

namespace {

constexpr float EPSLN = 1.0e-20f;
constexpr float THOMAS_EPS = 1.0e-30f;
constexpr int KMAX = 64;        // levels
constexpr int MAXNT = 256;      // threads per block: twice imt rounded up to 32
constexpr int NR = 5;           // region rows j-2..j+2 (index r)
constexpr int L_TM = 5;         // ring depths: levels held at once
constexpr int L_TT = 4;
constexpr int L_V = 2;
constexpr int L_D = 3;
constexpr int L_W = 2;
constexpr int NISO = 23;        // weight rows: 18 on row j, 5 on row j-1
// per level of the flux ring: fe_lo, fb_lo on rows 1..3, fn_lo and the
// raw y flux on rows 0..3, raw x and z fluxes on row 2
constexpr int NFLUX = 3 + 3 + 4 + 4 + 1 + 1;
constexpr int F_FE = 0, F_FB = 3, F_FN = 6, F_AY = 10, F_AX = 14, F_AZ = 15;

struct Args {
  const float* __restrict__ t_tau;   // (nt, km, jmt, imt)
  const float* __restrict__ tm1;     // (nt, km, jmt, imt)
  const float* __restrict__ vet;     // (km, jmt, imt) total advective velocities
  const float* __restrict__ vnt;
  const float* __restrict__ vbt;
  const float* __restrict__ tmask;   // (km, jmt, imt)
  const float* __restrict__ dcb;     // (km, jmt, imt) diffusivity at cell bottoms
  const float* __restrict__ stf;     // (nt, jmt, imt) surface flux
  const float* __restrict__ btf;     // (nt, jmt, imt) bottom flux
  const float* __restrict__ src;     // (nt, km, jmt, imt) or null
  const float* __restrict__ isow;    // (18, km, jmt, imt) or null
  const float* __restrict__ twodt;   // (km,) leapfrog interval x dtxcel
  const float* __restrict__ kf;      // (6, km): row 0 unused, dzt2r dztr dzwr_b dztur dztlr
  const float* __restrict__ jif;     // (6, jmt, imt): cstdxt2r cstdyt2r cstdxtr
                                     //   ah*cstdxur yA yB
  const int* __restrict__ kmt;       // (jmt, imt)
  float* __restrict__ out;           // (nt, km, jmt, imt)
  int nt, km, jmt, imt;
  float aidif;
  int fluxform;
  int cyclic;     // 1: cyclic setbcx; 0: solid walls (boundary columns zero)
};

// rows of the shared-memory window, each imt floats
// (tracer_kernel.py: tracer_launch)
constexpr int O_TM = 0;                        // tm1 ring
constexpr int O_TT = O_TM + NR * L_TM;         // t_tau ring
constexpr int O_MK = O_TT + NR * L_TT;         // tmask ring
constexpr int O_VE = O_MK + NR * L_TT;         // vet, vnt, vbt rings
constexpr int O_VN = O_VE + NR * L_V;
constexpr int O_VB = O_VN + NR * L_V;
constexpr int O_DC = O_VB + NR * L_V;          // dcb ring (row j)
constexpr int O_SR = O_DC + L_D;               // source ring (row j)
constexpr int O_WQ = O_SR + L_W;               // weight ring
constexpr int O_JF = O_WQ + L_W * NISO;        // jif on rows j-1..j+1
constexpr int O_FX = O_JF + 6 * 3;             // fluxes, two levels
constexpr int O_RX = O_FX + 2 * NFLUX;         // ratios x, y, z, two levels
constexpr int O_RY = O_RX + 4;
constexpr int O_RZ = O_RY + 12;
constexpr int O_PT = O_RZ + 4;                 // half 1's tendency, two levels
constexpr int SMEM_ROWS = O_PT + 2;

__device__ __forceinline__ int wrap(int i, int n) {
  return i < 0 ? i + n : (i >= n ? i - n : i);
}

// column whose values a duplicated cyclic boundary column carries
__device__ __forceinline__ int mirror(int i, int imt) {
  return i == 0 ? imt - 2 : (i == imt - 1 ? 1 : i);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ float limit(float anti, float cpos, float cneg) {
  return 0.5f * ((cpos + cneg) * anti + (cpos - cneg) * fabsf(anti));
}

__device__ __forceinline__ void ratios(float tl, float fxa, float fxb,
                                       float p_plus, float p_minus, float mask,
                                       float& rpl, float& rmn) {
  float trmax = fmaxf(fmaxf(fxa, fxb), tl);
  float trmin = fminf(fminf(fxa, fxb), tl);
  // the quotients as reciprocal times numerator (see the head note)
  rpl = fminf(1.f, mask * (trmax - tl) * __frcp_rn(p_plus + EPSLN));
  rmn = fminf(1.f, mask * (tl - trmin) * __frcp_rn(p_minus + EPSLN));
}

// upstream flux v (a + b) + |v| (a - b) (2x convention)
__device__ __forceinline__ float upstream(float v, float a, float b) {
  return v * (a + b) + fabsf(v) * (a - b);
}

// One block's view: row j of tracer n and its shared-memory window.
// Region rows r = 0..4 are the rows j-2..j+2; each accessor returns the
// row r of level k as a pointer indexed by column.
struct Win {
  const Args& a;
  int n, j, imt;  // imt: the row length
  const float* kfs;  // (6, KMAX) level factors, row 0 twodt
  float* base;    // the window: row q of it at base + q * imt

  __device__ float* row(int q) const { return base + q * imt; }
  __device__ float* TM(int k, int r) const { return row(O_TM + (k % L_TM) * NR + r); }
  __device__ float* TT(int k, int r) const { return row(O_TT + (k % L_TT) * NR + r); }
  __device__ float* MK(int k, int r) const { return row(O_MK + (k % L_TT) * NR + r); }
  __device__ float* VE(int k, int r) const { return row(O_VE + (k % L_V) * NR + r); }
  __device__ float* VN(int k, int r) const { return row(O_VN + (k % L_V) * NR + r); }
  __device__ float* VB(int k, int r) const { return row(O_VB + (k % L_V) * NR + r); }
  __device__ float* DC(int k) const { return row(O_DC + k % L_D); }
  __device__ float* SR(int k) const { return row(O_SR + k % L_W); }
  // weight q on row r (2, or 1 for q = 4..7, 17)
  __device__ float* WQ(int q, int k, int r) const {
    int w = r == 2 ? q : 18 + (q == 17 ? 4 : q - 4);
    return row(O_WQ + (k % L_W) * NISO + w);
  }
  __device__ float* JF(int q, int r) const { return row(O_JF + q * 3 + r - 1); }
  // flux f (F_FE + r - 1, F_FB + r - 1, F_FN + r, F_AY + r, F_AX, F_AZ)
  __device__ float* FX(int f, int k) const { return row(O_FX + (k & 1) * NFLUX + f); }
  // ratios: p = 0 plus, 1 minus; two levels
  __device__ float* RX(int p, int k) const { return row(O_RX + (k & 1) * 2 + p); }
  __device__ float* RY(int p, int k, int r) const {
    return row(O_RY + ((k & 1) * 2 + p) * 3 + r - 1);
  }
  __device__ float* RZ(int p, int k) const { return row(O_RZ + (k & 1) * 2 + p); }
  __device__ float* PT(int k) const { return row(O_PT + (k & 1)); }
  // level factors, copied to shared memory: global loads in the march
  // would miss the small L1 that the maximal shared carveout leaves
  __device__ float kfac(int q, int k) const { return kfs[q * KMAX + k]; }

  // the column whose values column i carries after setbcx: its mirror
  // when cyclic, itself otherwise (zeroed on a wall, is_wall)
  __device__ int column(int i) const { return a.cyclic ? mirror(i, imt) : i; }
  __device__ bool is_wall(int i) const {
    return !a.cyclic && (i == 0 || i == imt - 1);
  }

  // ---- fetches: thread i copies column i of each row ----------------
  __device__ size_t at(int k, int r) const {   // global offset of (k, row of r, 0)
    return ((size_t)k * a.jmt + wrap(j - 2 + r, a.jmt)) * imt;
  }
  __device__ size_t vol() const { return (size_t)a.km * a.jmt * imt; }
  // copy one row of W floats from global offset g of src into dst,
  // thread i column i
  __device__ void row_copy(float* dst, const float* src, size_t g, int i) const {
    if (i < imt) cp_async4(dst + i, src + g + i);
  }
  // half 0 fetches t, dcb, source and weights 0..8; half 1 the
  // velocities and weights 9..17
  __device__ void fetch(int k3, int k2, int k1, int i, int h) const {
    const size_t V = vol();
    if (h == 0 && k3 < a.km) {                   // tm1, t_tau, tmask of level k3
      for (int r = 0; r < NR; ++r) {
        size_t g = at(k3, r);
        row_copy(TM(k3, r), a.tm1 + n * V, g, i);
        row_copy(TT(k3, r), a.t_tau + n * V, g, i);
        row_copy(MK(k3, r), a.tmask, g, i);
      }
    }
    if (h == 1 && k2 < a.km) {                   // velocities of level k2
      for (int r = 0; r < NR; ++r) {
        size_t g = at(k2, r);
        row_copy(VE(k2, r), a.vet, g, i);
        row_copy(VN(k2, r), a.vnt, g, i);
        row_copy(VB(k2, r), a.vbt, g, i);
      }
    }
    if (k1 < a.km) {                             // dcb, source, weights of level k1
      size_t g2 = at(k1, 2), g1 = at(k1, 1);
      if (h == 0) {
        row_copy(DC(k1), a.dcb, g2, i);
        if (a.src != nullptr) row_copy(SR(k1), a.src + n * V, g2, i);
      }
      if (a.isow != nullptr) {
        for (int q = 9 * h; q < 9 * h + 9; ++q) row_copy(WQ(q, k1, 2), a.isow + q * V, g2, i);
        if (h == 0)
          for (int q = 4; q < 8; ++q) row_copy(WQ(q, k1, 1), a.isow + q * V, g1, i);
        else
          row_copy(WQ(17, k1, 1), a.isow + 17 * V, g1, i);
      }
    }
  }

  // A: low-order and raw antidiffusive fluxes of level k at column i;
  // half 0 the north faces, half 1 the east and bottom faces.  All loads
  // come before the stores, which the compiler cannot move loads past.
  __device__ void fluxes(int k, int i, int h) const {
    if (h == 0) {
      float tm[NR], tt[NR], vn[4], lo[4], ay[4];
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        tm[r] = TM(k, r)[i];
        tt[r] = TT(k, r)[i];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) vn[r] = VN(k, r)[i];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        lo[r] = upstream(vn[r], tm[r], tm[r + 1]);
        ay[r] = vn[r] * (tt[r] + tt[r + 1]) - lo[r];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        FX(F_FN + r, k)[i] = lo[r];
        FX(F_AY + r, k)[i] = ay[r];
      }
      return;
    }
    const int e = wrap(i + 1, imt);
    const bool below = k < a.km - 1;
    float tc[3], te[3], td[3], ve[3], vb[3], fe[3], fb[3];
#pragma unroll
    for (int r = 1; r <= 3; ++r) {
      tc[r - 1] = TM(k, r)[i];
      te[r - 1] = TM(k, r)[e];
      ve[r - 1] = VE(k, r)[i];
      td[r - 1] = below ? TM(k + 1, r)[i] : 0.f;
      vb[r - 1] = below ? VB(k, r)[i] : 0.f;
    }
    const float t2 = TT(k, 2)[i], t2e = TT(k, 2)[e];
    const float t2d = below ? TT(k + 1, 2)[i] : 0.f, m2 = MK(k, 2)[i];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      fe[r] = upstream(ve[r], tc[r], te[r]);
      fb[r] = below ? upstream(vb[r], td[r], tc[r]) : 0.f;
    }
    const float ax = ve[1] * (t2 + t2e) - fe[1];
    const float az = below ? vb[1] * (t2 + t2d) - fb[1] * m2 : 0.f;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      FX(F_FE + r, k)[i] = fe[r];
      FX(F_FB + r, k)[i] = fb[r];
    }
    FX(F_AX, k)[i] = ax;
    FX(F_AZ, k)[i] = az;
  }

  // B: t_lo of level k at (r, ic), before setbcx
  __device__ float t_lo(int k, int r, int ic) const {
    int iw = wrap(ic - 1, imt);
    const float* fe = FX(F_FE + r - 1, k);
    float fb_up = k > 0 ? FX(F_FB + r - 1, k - 1)[ic] : 0.f;
    float adv = (fe[ic] - fe[iw]) * JF(0, r)[ic]
              + (FX(F_FN + r, k)[ic] - FX(F_FN + r - 1, k)[ic]) * JF(1, r)[ic]
              + (fb_up - FX(F_FB + r - 1, k)[ic]) * kfac(1, k);
    return TM(k, r)[ic] - kfac(0, k) * adv * MK(k, r)[ic];
  }
  // B: the six ratios of level k at column i: x on row 2 (setbcx: at
  // the mirror column), y on rows 1..3, z on row 2; t_lo after setbcx is
  // t_lo at the mirror column.  Half 0 takes x and y on rows 1..2, half
  // 1 y on row 3 and z (t_lo of row 2 is computed by both).  The ratios
  // are stored after all loads.
  __device__ void make_ratios(int k, int i, int h) const {
    const float twodt = kfac(0, k);
    const int ic = column(i);
    // a solid wall's boundary column: t_lo and the x ratios are zero there
    const bool wall = is_wall(i);
    const float tl2 = wall ? 0.f : t_lo(k, 2, ic);
    const float tlb = wall ? 0.f : t_lo(k, h == 0 ? 1 : 3, ic);
    float xpl = 0.f, xmn = 0.f, zpl = 0.f, zmn = 0.f;
    float ypl[2] = {0.f, 0.f}, ymn[2] = {0.f, 0.f};   // rows 1, 2 (half 0) or 3
    if (h == 0 && !wall) {
      int iw = wrap(ic - 1, imt), ie = wrap(ic + 1, imt);
      const float* m = MK(k, 2);
      const float* t = TT(k, 2);
      float fxa = m[iw] * (0.5f * (t[iw] + t[ic])) + (1.f - m[iw]) * tl2;
      float fxb = m[ie] * (0.5f * (t[ic] + t[ie])) + (1.f - m[ie]) * tl2;
      float ax = FX(F_AX, k)[ic], axw = FX(F_AX, k)[iw];
      float dcf = twodt * JF(0, 2)[ic];
      ratios(tl2, fxa, fxb, dcf * (fmaxf(0.f, axw) - fminf(0.f, ax)),
             dcf * (fmaxf(0.f, ax) - fminf(0.f, axw)), m[ic], xpl, xmn);
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int r = h == 0 ? 1 + q : 3;
      if (h == 1 && q == 1) break;
      float tl = r == 2 ? tl2 : tlb;
      float ms = MK(k, r - 1)[i], mn = MK(k, r + 1)[i];
      float t = TT(k, r)[i];
      float fxa = ms * (0.5f * (TT(k, r - 1)[i] + t)) + (1.f - ms) * tl;
      float fxb = mn * (0.5f * (t + TT(k, r + 1)[i])) + (1.f - mn) * tl;
      float ay = FX(F_AY + r, k)[i], ays = FX(F_AY + r - 1, k)[i];
      float dcf = twodt * JF(1, r)[i];
      ratios(tl, fxa, fxb, dcf * (fmaxf(0.f, ays) - fminf(0.f, ay)),
             dcf * (fmaxf(0.f, ay) - fminf(0.f, ays)), MK(k, r)[i],
             ypl[q], ymn[q]);
    }
    if (h == 1) {
      float t = TT(k, 2)[i];
      float fxa = tl2, fxb = tl2;
      if (k > 0) {
        float m = MK(k - 1, 2)[i];
        fxa = m * (0.5f * (TT(k - 1, 2)[i] + t)) + (1.f - m) * tl2;
      }
      if (k < a.km - 1) {
        float m = MK(k + 1, 2)[i];
        fxb = m * (0.5f * (t + TT(k + 1, 2)[i])) + (1.f - m) * tl2;
      }
      float az = FX(F_AZ, k)[i], azu = k > 0 ? FX(F_AZ, k - 1)[i] : 0.f;
      float dcf = twodt * kfac(1, k);
      ratios(tl2, fxa, fxb, dcf * (fmaxf(0.f, az) - fminf(0.f, azu)),
             dcf * (fmaxf(0.f, azu) - fminf(0.f, az)), MK(k, 2)[i],
             zpl, zmn);
    }
    if (h == 0) {
      RX(0, k)[i] = xpl;
      RX(1, k)[i] = xmn;
      RY(0, k, 1)[i] = ypl[0];
      RY(1, k, 1)[i] = ymn[0];
      RY(0, k, 2)[i] = ypl[1];
      RY(1, k, 2)[i] = ymn[1];
    } else {
      RY(0, k, 3)[i] = ypl[0];
      RY(1, k, 3)[i] = ymn[0];
      RZ(0, k)[i] = zpl;
      RZ(1, k)[i] = zmn;
    }
  }

  // C: limited fluxes (2x), corrected totals
  __device__ float fe(int k, int i) const {
    int e = wrap(i + 1, imt);
    const float* rp = RX(0, k);
    const float* rm = RX(1, k);
    return limit(FX(F_AX, k)[i], fminf(rp[e], rm[i]), fminf(rp[i], rm[e]))
           + FX(F_FE + 1, k)[i];
  }
  __device__ float fn(int k, int r, int i) const {
    return (limit(FX(F_AY + r, k)[i], fminf(RY(0, k, r + 1)[i], RY(1, k, r)[i]),
                  fminf(RY(0, k, r)[i], RY(1, k, r + 1)[i])) + FX(F_FN + r, k)[i])
           * MK(k, r)[i];
  }
  __device__ float fb(int k, int i) const {
    if (k >= a.km - 1) return 0.f;
    return (limit(FX(F_AZ, k)[i], fminf(RZ(0, k)[i], RZ(1, k + 1)[i]),
                  fminf(RZ(0, k + 1)[i], RZ(1, k)[i])) + FX(F_FB + 1, k)[i])
           * MK(k, 2)[i];
  }

  // tm at level k (0 below the bottom)
  __device__ float tmk(int k, int r, int i) const { return k < a.km ? TM(k, r)[i] : 0.f; }
  // vd0(t)(k) = t(k-1) - t(k), vd1(t)(k) = t(k) - t(k+1), zero-filled
  __device__ float vd0(int k, int r, int i) const {
    return (k > 0 ? TM(k - 1, r)[i] : 0.f) - TM(k, r)[i];
  }
  __device__ float vd1(int k, int r, int i) const { return TM(k, r)[i] - tmk(k + 1, r, i); }
  // Redi/GM flux additions from the weight stack
  __device__ float fe_iso(int k, int i) const {
    int e = wrap(i + 1, imt);
    return WQ(16, k, 2)[i] * (TM(k, 2)[e] - TM(k, 2)[i])
           - WQ(0, k, 2)[i] * vd0(k, 2, i) - WQ(1, k, 2)[i] * vd1(k, 2, i)
           - WQ(2, k, 2)[i] * vd0(k, 2, e) - WQ(3, k, 2)[i] * vd1(k, 2, e);
  }
  __device__ float fn_iso(int k, int r, int i) const {
    return WQ(17, k, r)[i] * (TM(k, r + 1)[i] - TM(k, r)[i])
           - WQ(4, k, r)[i] * vd0(k, r, i) - WQ(5, k, r)[i] * vd1(k, r, i)
           - WQ(6, k, r)[i] * vd0(k, r + 1, i) - WQ(7, k, r)[i] * vd1(k, r + 1, i);
  }
  __device__ float fb_iso(int k, int i) const {
    int iw = wrap(i - 1, imt), ie = wrap(i + 1, imt);
    float t = tmk(k, 2, i), d = tmk(k + 1, 2, i);
    return -(WQ(8, k, 2)[i] * (t - tmk(k, 2, iw))
             + WQ(9, k, 2)[i] * (tmk(k, 2, ie) - t)
             + WQ(10, k, 2)[i] * (d - tmk(k + 1, 2, iw))
             + WQ(11, k, 2)[i] * (tmk(k + 1, 2, ie) - d)
             + WQ(12, k, 2)[i] * (t - tmk(k, 1, i))
             + WQ(13, k, 2)[i] * (tmk(k, 3, i) - t)
             + WQ(14, k, 2)[i] * (d - tmk(k + 1, 1, i))
             + WQ(15, k, 2)[i] * (tmk(k + 1, 3, i) - d));
  }
};

__global__ void __launch_bounds__(MAXNT, 2) fct_tracer_kernel(Args a) {
  extern __shared__ float smem[];
  // two halves of ncol threads, thread i of each on column i
  const int ncol = blockDim.x / 2;
  const int h = threadIdx.x / ncol, i = threadIdx.x - h * ncol;
  const int W = a.imt;
  const bool col = i < W;
  __shared__ float kfs[6 * KMAX];
  Win v{a, (int)blockIdx.y, (int)blockIdx.x, a.imt, kfs, smem};
  for (int q = threadIdx.x; q < 6 * a.km; q += blockDim.x)
    kfs[(q / a.km) * KMAX + q % a.km] = q < a.km ? a.twodt[q] : a.kf[q];
  float* p = v.row(SMEM_ROWS);
  float* tz = p + i;                        // Thomas z and e, (km, ncol)
  float* te = p + (size_t)a.km * ncol + i;
  const int km = a.km, j = v.j, n = v.n;
  const size_t plane = (size_t)a.jmt * W;

  // ---- prologue: levels 0..2 of t, 0..1 of velocities, 0 of the rest --
  if (col) {
    for (int q = 3 * h; q < 3 * h + 3; ++q)
      for (int r = 1; r <= 3; ++r)
        v.JF(q, r)[i] = a.jif[q * plane + wrap(j - 2 + r, a.jmt) * W + i];
    v.fetch(0, 0, 0, i, h);
    v.fetch(1, 1, km, i, h);
    v.fetch(2, km, km, i, h);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  if (col) v.fluxes(0, i, h);
  __syncthreads();
  if (col) v.make_ratios(0, i, h);

  // the column this thread computes: the output's setbcx
  const int ic = col ? v.column(i) : 0;
  const int iw = wrap(ic - 1, W), ie = wrap(ic + 1, W);
  const int c2 = j * W + ic;
  const float stf = col ? a.stf[n * plane + c2] : 0.f;
  const float btf = col ? a.btf[n * plane + c2] : 0.f;
  const int kmt = col ? a.kmt[c2] : 0;
  const int kb = max(kmt - 1, 1);
  const bool iso = a.isow != nullptr;

  // this thread's column of the output (the mirror column's values)
  float* o = a.out + (size_t)n * km * plane + (size_t)j * W + i;

  // half 0 carries level k's own terms and Thomas coefficients to the
  // next step, where it adds half 1's terms and runs the elimination
  float fb_up = 0.f, dfb_up = 0.f, fbi_up = 0.f;   // fluxes through the top face
  // Thomas carry: level k-1's bet, c, x and right side less its c term
  float bet = 0.f, c_up = 0.f, x_up = 0.f, part = 0.f;
  float tend0 = 0.f, tm0 = 0.f, msk0 = 0.f, twodt0 = 0.f, ak0 = 0.f, ck0 = 0.f, f0 = 0.f;
  // t_new of level k and its forward elimination (half 0)
  auto eliminate = [&](int k) {
    float t_new = tm0 + twodt0 * (tend0 + v.PT(k)[ic]) * msk0;
    if (a.aidif > 0.f) {
      float x = t_new * msk0;
      float bk = 1.f - ak0 - ck0;
      o[(size_t)k * plane] = x;
      if (k == 0) {
        bet = msk0 / (bk + THOMAS_EPS);
        part = f0;
        te[0] = 0.f;
      } else {
        // level k-1's right side is whole now that x[k] is known
        float zu = (part + c_up * (x_up - x)) * bet;
        tz[(k - 1) * ncol] = zu;
        float ek = c_up * bet;
        te[k * ncol] = ek;
        bet = msk0 / (bk - ak0 * ek + THOMAS_EPS);
        part = f0 - ak0 * (x_up - x) - ak0 * zu;
      }
      c_up = ck0;
      x_up = x;
    } else {
      tz[k * ncol] = t_new;
    }
  };

  for (int k = 0; k < km; ++k) {
    // wait for what this level reads (fetched one level ago); the barrier
    // also ends the last level's reads of the slots fetched into next
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    v.fetch(k + 3, k + 2, k + 1, i, h);
    asm volatile("cp.async.commit_group;\n" ::);
    if (col && h == 0 && k > 0) eliminate(k - 1);
    if (k + 1 < km && col) v.fluxes(k + 1, i, h);
    __syncthreads();
    if (k + 1 < km && col) v.make_ratios(k + 1, i, h);
    __syncthreads();
    if (col && h == 0) {
      float twodt = v.kfac(0, k), dztr = v.kfac(2, k);
      float cstdxtr = v.JF(2, 2)[ic], yA = v.JF(4, 2)[ic], yB = v.JF(5, 2)[ic];
      float yAs = v.JF(4, 1)[ic];
      const float* t2 = v.TM(k, 2);
      const float* m2 = v.MK(k, 2);
      float tm = t2[ic], msk = m2[ic];
      float tmw = t2[iw], tme = t2[ie];
      float tms = v.TM(k, 1)[ic], tmn = v.TM(k, 3)[ic];
      float mw = m2[iw], me = m2[ie];
      float ms = v.MK(k, 1)[ic], mn = v.MK(k, 3)[ic];

      // advection: limited flux divergence
      float fb = v.fb(k, ic);
      float tend = -(v.fe(k, ic) - v.fe(k, iw)) * v.JF(0, 2)[ic]
                   - (v.fn(k, 2, ic) - v.fn(k, 1, ic)) * v.JF(1, 2)[ic]
                   - (fb_up - fb) * v.kfac(1, k);
      fb_up = fb;

      // harmonic horizontal diffusion
      float dfe = v.JF(3, 2)[ic] * (tme - tm);
      float dfw = v.JF(3, 2)[iw] * (tm - tmw);
      tend += (dfe * me - dfw * mw) * cstdxtr;
      if (a.fluxform) {
        tend += (yA * (tmn - tm) * mn - yAs * (tm - tms) * ms) * yB;
      } else {
        tend += yA * mn * (tmn - tm) - yB * ms * (tm - tms);
      }

      // explicit vertical diffusion; the bottom face of the deepest wet
      // cell carries btf, the surface face stf
      float dfb = k < km - 1 ? v.DC(k)[ic] * v.kfac(3, k) * (tm - v.TM(k + 1, 2)[ic]) : 0.f;
      if (k == kmt - 1) dfb = btf;
      tend += ((k == 0 ? stf : dfb_up) - dfb) * dztr * (1.f - a.aidif);
      dfb_up = dfb;

      // implicit vertical diffusion coefficients (invtri.F)
      ak0 = k > 0 ? -v.DC(k - 1)[ic] * (v.kfac(4, k) * twodt * a.aidif) * msk : 0.f;
      ck0 = k < km - 1
          ? -v.DC(k)[ic] * (v.kfac(5, k) * twodt * a.aidif) * v.MK(k + 1, 2)[ic] : 0.f;
      f0 = 0.f;
      if (k == 0) f0 += stf * twodt * dztr * a.aidif * msk;
      if (k == kb) f0 -= btf * twodt * dztr * a.aidif * msk;
      tend0 = tend;
      tm0 = tm;
      msk0 = msk;
      twodt0 = twodt;
    } else if (col) {
      // Redi/GM tendency and source
      float dztr = v.kfac(2, k), cstdxtr = v.JF(2, 2)[ic], yB = v.JF(5, 2)[ic];
      const float* m2 = v.MK(k, 2);
      float tend = 0.f;
      if (iso) {
        float fbi = v.fb_iso(k, ic);
        tend = (v.fe_iso(k, ic) * m2[ie] - v.fe_iso(k, iw) * m2[iw]) * cstdxtr
               + (v.fn_iso(k, 2, ic) * v.MK(k, 3)[ic] - v.fn_iso(k, 1, ic) * v.MK(k, 1)[ic]) * yB
               + (fbi_up - fbi) * dztr;
        fbi_up = fbi;
      }
      if (a.src != nullptr) tend += v.SR(k)[ic];
      v.PT(k)[ic] = tend;
    }
  }
  __syncthreads();
  if (!col || h != 0) return;
  eliminate(km - 1);
  if (a.aidif > 0.f) {
    // the deepest level's right side has no c term (c = 0 there)
    float y = part * bet;
    o[(size_t)(km - 1) * plane] += y;
    for (int k = km - 2; k >= 0; --k) {
      y = tz[k * ncol] - te[(k + 1) * ncol] * y;
      o[(size_t)k * plane] += y;
    }
  } else {
    for (int k = km - 1; k >= 0; --k) o[(size_t)k * plane] = tz[k * ncol];
  }
  if (v.is_wall(i))
    for (int k = 0; k < km; ++k) o[(size_t)k * plane] = 0.f;
}

}  // namespace

static cudaError_t set_attributes(size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      fct_tracer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  // all of the SM's unified memory as shared memory: two blocks per SM
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fct_tracer_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  return err;
}

static size_t tracer_smem_bytes(int km, int imt) {
  int ncol = (imt + 31) / 32 * 32;
  return ((size_t)SMEM_ROWS * imt + 2 * (size_t)km * ncol) * sizeof(float);
}

extern "C" int uvic_fct_tracer_step(
    const float* t_tau, const float* tm1, const float* vet, const float* vnt,
    const float* vbt, const float* tmask, const float* dcb, const float* stf,
    const float* btf, const float* src, const float* isow, const float* twodt,
    const float* kf, const float* jif, const int* kmt, float* out,
    int nt, int km, int jmt, int imt, float aidif, int fluxform, int cyclic,
    void* stream) {
  int nth = 2 * ((imt + 31) / 32 * 32);
  if (km < 2 || km > KMAX || imt < 3 || nth > MAXNT) return (int)cudaErrorInvalidValue;
  Args a{t_tau, tm1, vet, vnt, vbt, tmask, dcb, stf, btf, src, isow, twodt, kf,
         jif, kmt, out, nt, km, jmt, imt, aidif, fluxform, cyclic};
  size_t bytes = tracer_smem_bytes(km, imt);
  cudaError_t err = set_attributes(bytes);
  if (err != cudaSuccess) return (int)err;
  fct_tracer_kernel<<<dim3(jmt, nt), nth, bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// Blocks of the tracer kernel resident on one SM at the given shape, or
// a negative CUDA error.
extern "C" int uvic_fct_tracer_blocks_per_sm(int km, int imt) {
  int nth = 2 * ((imt + 31) / 32 * 32);
  size_t bytes = tracer_smem_bytes(km, imt);
  cudaError_t err = set_attributes(bytes);
  int count = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&count, fct_tracer_kernel, nth, bytes);
  return err == cudaSuccess ? count : -(int)err;
}
