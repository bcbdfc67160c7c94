// Fused FCT tracer step for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel uvic_tpu/ops/pallas_tracer.py:_kernel
// (built by make_fct_tracer_step).  One call updates every tracer:
// FCT dlm1 low-order upstream solution, Zalesak-limited antidiffusive
// x/y/z fluxes, harmonic horizontal diffusion (flux form when
// isopycnal mixing is on), explicit vertical diffusion with surface and
// bottom fluxes, the Redi/GM tendency from the 18-slot weight stack,
// the source add, the aidif implicit Thomas solve (invtri.F) and the
// cyclic setbcx.  Reference: source/mom/tracer.F:678-916,
// tracer_adv_flx.F:376-1005, invtri.F:1-115.
//
// What bounds it: bytes.  At the flagship shape (nt=2, km=19, 102x102)
// one call must read ~24 MB (the 18-slot weight stack alone is 14 MB)
// and write 1.6 MB: ~8 us at 3.35 TB/s, against a few hundred flops
// per cell.
//
// Design.  The TPU kernel keeps a tracer's whole (km, jmt, imt) block
// in VMEM and shifts it in registers; a Hopper SM has no room for that,
// and blocks run in no order, so the dependency chain is cut in two
// launches through global scratch:
//   pass 1 (one thread per (n, k, j, i)): the six Zalesak ratios
//     (rpl/rmn in x, y, z).  A ratio needs t_lo of its own cell only,
//     so t_lo is recomputed inline and never stored; setbcx of t_lo and
//     of the x ratios is applied by evaluating the mirror column
//     (col 0 <- col imt-2, col imt-1 <- col 1).
//   pass 2 (one thread per (n, j, i) column, loop over k): limited
//     fluxes from the ratios, diffusion, iso tendency, source, and the
//     Thomas solve, which is a recursion in k and so wants the column
//     in one thread.  Vertical fluxes of level k-1 are carried in
//     registers from the previous trip; the output's setbcx is again
//     the mirror column.
// All horizontal neighbours wrap periodically in i and j, like the
// jnp.roll of the reference.  Every loop has a fixed trip count (km).
// The scratch (6 ratio fields) costs ~19 MB of extra traffic; fusing
// the passes with shared-memory halos is later work.

#include <cuda_runtime.h>

namespace {

constexpr float EPSLN = 1.0e-20f;
constexpr float THOMAS_EPS = 1.0e-30f;
constexpr int KMAX = 64;

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
  const float* __restrict__ kf;      // (6, km): twodt dzt2r dztr dzwr_b dztur dztlr
  const float* __restrict__ jif;     // (6, jmt, imt): cstdxt2r cstdyt2r cstdxtr
                                     //   ah*cstdxur yA yB
  const int* __restrict__ kmt;       // (jmt, imt)
  float* __restrict__ ratio;         // (6, nt, km, jmt, imt) scratch
  float* __restrict__ out;           // (nt, km, jmt, imt)
  int nt, km, jmt, imt;
  float aidif;
  int fluxform;
};

__device__ __forceinline__ int wrap(int i, int n) {
  return i < 0 ? i + n : (i >= n ? i - n : i);
}

// column whose values a duplicated cyclic boundary column carries
__device__ __forceinline__ int mirror(int i, int imt) {
  return i == 0 ? imt - 2 : (i == imt - 1 ? 1 : i);
}

struct Field {
  // one tracer's view of the arrays
  const Args& a;
  const float* t0;   // t_tau of tracer n
  const float* tm;   // tm1 of tracer n
  int n;

  __device__ int at(int k, int j, int i) const {
    return (k * a.jmt + j) * a.imt + i;
  }
  __device__ float jf(int r, int j, int i) const {
    return a.jif[(r * a.jmt + j) * a.imt + i];
  }
  __device__ float kfac(int r, int k) const { return a.kf[r * a.km + k]; }

  // low-order upstream fluxes at tau-1 (2x flux convention)
  __device__ float fe_lo(int k, int j, int i) const {
    int c = at(k, j, i), e = at(k, j, wrap(i + 1, a.imt));
    float v = a.vet[c];
    return v * (tm[c] + tm[e]) + fabsf(v) * (tm[c] - tm[e]);
  }
  __device__ float fn_lo(int k, int j, int i) const {
    int c = at(k, j, i), nn = at(k, wrap(j + 1, a.jmt), i);
    float v = a.vnt[c];
    return v * (tm[c] + tm[nn]) + fabsf(v) * (tm[c] - tm[nn]);
  }
  __device__ float fb_lo(int k, int j, int i) const {
    if (k < 0 || k >= a.km - 1) return 0.f;
    int c = at(k, j, i), d = at(k + 1, j, i);
    float v = a.vbt[c];
    return v * (tm[d] + tm[c]) + fabsf(v) * (tm[d] - tm[c]);
  }

  // low-order solution before setbcx
  __device__ float t_lo(int k, int j, int i) const {
    int c = at(k, j, i);
    float adv = (fe_lo(k, j, i) - fe_lo(k, j, wrap(i - 1, a.imt))) * jf(0, j, i)
              + (fn_lo(k, j, i) - fn_lo(k, wrap(j - 1, a.jmt), i)) * jf(1, j, i)
              + (fb_lo(k - 1, j, i) - fb_lo(k, j, i)) * kfac(1, k);
    return tm[c] - kfac(0, k) * adv * a.tmask[c];
  }

  // raw antidiffusive fluxes
  __device__ float anti_x(int k, int j, int i) const {
    int c = at(k, j, i), e = at(k, j, wrap(i + 1, a.imt));
    return a.vet[c] * (t0[c] + t0[e]) - fe_lo(k, j, i);
  }
  __device__ float anti_y(int k, int j, int i) const {
    int c = at(k, j, i), nn = at(k, wrap(j + 1, a.jmt), i);
    return a.vnt[c] * (t0[c] + t0[nn]) - fn_lo(k, j, i);
  }
  __device__ float anti_z(int k, int j, int i) const {
    if (k < 0 || k >= a.km - 1) return 0.f;
    int c = at(k, j, i), d = at(k + 1, j, i);
    return a.vbt[c] * (t0[c] + t0[d]) - fb_lo(k, j, i) * a.tmask[c];
  }

  __device__ float r(int q, int k, int j, int i) const {
    size_t vol = (size_t)a.km * a.jmt * a.imt;
    return a.ratio[((size_t)q * a.nt + n) * vol + at(k, j, i)];
  }
};

__device__ __forceinline__ float limit(float anti, float cpos, float cneg) {
  return 0.5f * ((cpos + cneg) * anti + (cpos - cneg) * fabsf(anti));
}

__device__ __forceinline__ void ratios(float tl, float fxa, float fxb,
                                       float p_plus, float p_minus, float mask,
                                       float& rpl, float& rmn) {
  float trmax = fmaxf(fmaxf(fxa, fxb), tl);
  float trmin = fminf(fminf(fxa, fxb), tl);
  rpl = fminf(1.f, mask * (trmax - tl) / (p_plus + EPSLN));
  rmn = fminf(1.f, mask * (tl - trmin) / (p_minus + EPSLN));
}

// pass 1: Zalesak ratios, one thread per (n, k, j, i)
__global__ void fct_ratios_kernel(Args a) {
  size_t plane = (size_t)a.jmt * a.imt, vol = plane * a.km;
  size_t tid = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= vol * a.nt) return;
  int i = tid % a.imt;
  int j = (tid / a.imt) % a.jmt;
  int k = (tid / plane) % a.km;
  int n = tid / vol;
  Field f{a, a.t_tau + n * vol, a.tm1 + n * vol, n};
  const float* tmask = a.tmask;
  float twodt = f.kfac(0, k);
  float* rq = a.ratio + (size_t)n * vol + f.at(k, j, i);
  size_t qs = (size_t)a.nt * vol;

  // x: evaluated at the mirror column (setbcx of the x ratios)
  {
    int ic = mirror(i, a.imt);
    int iw = wrap(ic - 1, a.imt), ie = wrap(ic + 1, a.imt);
    int c = f.at(k, j, ic), w = f.at(k, j, iw), e = f.at(k, j, ie);
    float tl = f.t_lo(k, j, ic);
    float fxa = tmask[w] * (0.5f * (f.t0[w] + f.t0[c])) + (1.f - tmask[w]) * tl;
    float fxb = tmask[e] * (0.5f * (f.t0[c] + f.t0[e])) + (1.f - tmask[e]) * tl;
    float ax = f.anti_x(k, j, ic), axw = f.anti_x(k, j, iw);
    float dcf = twodt * f.jf(0, j, ic);
    float rpl, rmn;
    ratios(tl, fxa, fxb, dcf * (fmaxf(0.f, axw) - fminf(0.f, ax)),
           dcf * (fmaxf(0.f, ax) - fminf(0.f, axw)), tmask[c], rpl, rmn);
    rq[0] = rpl;
    rq[qs] = rmn;
  }
  // t_lo after setbcx, at this cell
  float tl = f.t_lo(k, j, mirror(i, a.imt));
  int c = f.at(k, j, i);
  // y
  {
    int js = wrap(j - 1, a.jmt), jn = wrap(j + 1, a.jmt);
    int s = f.at(k, js, i), nn = f.at(k, jn, i);
    float fxa = tmask[s] * (0.5f * (f.t0[s] + f.t0[c])) + (1.f - tmask[s]) * tl;
    float fxb = tmask[nn] * (0.5f * (f.t0[c] + f.t0[nn])) + (1.f - tmask[nn]) * tl;
    float ay = f.anti_y(k, j, i), ays = f.anti_y(k, js, i);
    float dcf = twodt * f.jf(1, j, i);
    float rpl, rmn;
    ratios(tl, fxa, fxb, dcf * (fmaxf(0.f, ays) - fminf(0.f, ay)),
           dcf * (fmaxf(0.f, ay) - fminf(0.f, ays)), tmask[c], rpl, rmn);
    rq[2 * qs] = rpl;
    rq[3 * qs] = rmn;
  }
  // z
  {
    float fxa = tl, fxb = tl;
    if (k > 0) {
      int u = f.at(k - 1, j, i);
      fxa = tmask[u] * (0.5f * (f.t0[u] + f.t0[c])) + (1.f - tmask[u]) * tl;
    }
    if (k < a.km - 1) {
      int d = f.at(k + 1, j, i);
      fxb = tmask[d] * (0.5f * (f.t0[c] + f.t0[d])) + (1.f - tmask[d]) * tl;
    }
    float az = f.anti_z(k, j, i), azu = f.anti_z(k - 1, j, i);
    float dcf = twodt * f.kfac(1, k);
    float rpl, rmn;
    ratios(tl, fxa, fxb, dcf * (fmaxf(0.f, az) - fminf(0.f, azu)),
           dcf * (fmaxf(0.f, azu) - fminf(0.f, az)), tmask[c], rpl, rmn);
    rq[4 * qs] = rpl;
    rq[5 * qs] = rmn;
  }
}

struct Column {
  const Field& f;
  // limited fluxes (2x), corrected totals
  __device__ float fe(int k, int j, int i) const {
    int ie = wrap(i + 1, f.a.imt);
    return limit(f.anti_x(k, j, i), fminf(f.r(0, k, j, ie), f.r(1, k, j, i)),
                 fminf(f.r(0, k, j, i), f.r(1, k, j, ie))) + f.fe_lo(k, j, i);
  }
  __device__ float fn(int k, int j, int i) const {
    int jn = wrap(j + 1, f.a.jmt);
    return (limit(f.anti_y(k, j, i), fminf(f.r(2, k, jn, i), f.r(3, k, j, i)),
                  fminf(f.r(2, k, j, i), f.r(3, k, jn, i))) + f.fn_lo(k, j, i))
           * f.a.tmask[f.at(k, j, i)];
  }
  __device__ float fb(int k, int j, int i) const {
    if (k >= f.a.km - 1) return 0.f;
    return (limit(f.anti_z(k, j, i), fminf(f.r(4, k, j, i), f.r(5, k + 1, j, i)),
                  fminf(f.r(4, k + 1, j, i), f.r(5, k, j, i))) + f.fb_lo(k, j, i))
           * f.a.tmask[f.at(k, j, i)];
  }
  // tm at level k (0 below the bottom)
  __device__ float tmk(int k, int j, int i) const {
    return k < f.a.km ? f.tm[f.at(k, j, i)] : 0.f;
  }
  // vd0(t)(k) = t(k-1) - t(k), vd1(t)(k) = t(k) - t(k+1), zero-filled
  __device__ float vd0(int k, int j, int i) const {
    return (k > 0 ? f.tm[f.at(k - 1, j, i)] : 0.f) - f.tm[f.at(k, j, i)];
  }
  __device__ float vd1(int k, int j, int i) const {
    return f.tm[f.at(k, j, i)] - tmk(k + 1, j, i);
  }
  __device__ float w(int q, int k, int j, int i) const {
    size_t vol = (size_t)f.a.km * f.a.jmt * f.a.imt;
    return f.a.isow[q * vol + f.at(k, j, i)];
  }
  // Redi/GM flux additions from the weight stack
  __device__ float fe_iso(int k, int j, int i) const {
    int ie = wrap(i + 1, f.a.imt);
    return w(16, k, j, i) * (f.tm[f.at(k, j, ie)] - f.tm[f.at(k, j, i)])
           - w(0, k, j, i) * vd0(k, j, i) - w(1, k, j, i) * vd1(k, j, i)
           - w(2, k, j, i) * vd0(k, j, ie) - w(3, k, j, i) * vd1(k, j, ie);
  }
  __device__ float fn_iso(int k, int j, int i) const {
    int jn = wrap(j + 1, f.a.jmt);
    return w(17, k, j, i) * (f.tm[f.at(k, jn, i)] - f.tm[f.at(k, j, i)])
           - w(4, k, j, i) * vd0(k, j, i) - w(5, k, j, i) * vd1(k, j, i)
           - w(6, k, j, i) * vd0(k, jn, i) - w(7, k, j, i) * vd1(k, jn, i);
  }
  __device__ float fb_iso(int k, int j, int i) const {
    int iw = wrap(i - 1, f.a.imt), ie = wrap(i + 1, f.a.imt);
    int js = wrap(j - 1, f.a.jmt), jn = wrap(j + 1, f.a.jmt);
    float t = tmk(k, j, i), d = tmk(k + 1, j, i);
    return -(w(8, k, j, i) * (t - tmk(k, j, iw))
             + w(9, k, j, i) * (tmk(k, j, ie) - t)
             + w(10, k, j, i) * (d - tmk(k + 1, j, iw))
             + w(11, k, j, i) * (tmk(k + 1, j, ie) - d)
             + w(12, k, j, i) * (t - tmk(k, js, i))
             + w(13, k, j, i) * (tmk(k, jn, i) - t)
             + w(14, k, j, i) * (d - tmk(k + 1, js, i))
             + w(15, k, j, i) * (tmk(k + 1, jn, i) - d));
  }
};

// pass 2: everything else, one thread per (n, j, i) column
__global__ void fct_column_kernel(Args a) {
  size_t plane = (size_t)a.jmt * a.imt, vol = plane * a.km;
  size_t tid = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= plane * a.nt) return;
  int i = tid % a.imt;
  int j = (tid / a.imt) % a.jmt;
  int n = tid / plane;
  Field f{a, a.t_tau + n * vol, a.tm1 + n * vol, n};
  Column col{f};
  const float* tmask = a.tmask;

  // the output's setbcx: duplicated columns carry their mirror's column
  int ic = mirror(i, a.imt);
  int iw = wrap(ic - 1, a.imt), ie = wrap(ic + 1, a.imt);
  int js = wrap(j - 1, a.jmt), jn = wrap(j + 1, a.jmt);
  int c2 = j * a.imt + ic;
  float stf = a.stf[n * plane + c2];
  float btf = a.btf[n * plane + c2];
  int kmt = a.kmt[c2];
  int kb = max(kmt - 1, 1);
  bool iso = a.isow != nullptr;
  float cstdxt2r = f.jf(0, j, ic), cstdyt2r = f.jf(1, j, ic);
  float cstdxtr = f.jf(2, j, ic);
  float yA = f.jf(4, j, ic), yB = f.jf(5, j, ic);
  float yAs = f.jf(4, js, ic);

  float z[KMAX], e[KMAX];
  float fb_up = 0.f, dfb_up = 0.f, fbi_up = 0.f;   // fluxes through the top face
  float bet = 0.f, c_up = 0.f;                      // Thomas carry
  for (int k = 0; k < a.km; ++k) {
    int c = f.at(k, j, ic);
    float twodt = f.kfac(0, k), dztr = f.kfac(2, k);
    float tm = f.tm[c], msk = tmask[c];
    float tmw = f.tm[f.at(k, j, iw)], tme = f.tm[f.at(k, j, ie)];
    float tms = f.tm[f.at(k, js, ic)], tmn = f.tm[f.at(k, jn, ic)];
    float mw = tmask[f.at(k, j, iw)], me = tmask[f.at(k, j, ie)];
    float ms = tmask[f.at(k, js, ic)], mn = tmask[f.at(k, jn, ic)];

    // advection: limited flux divergence
    float fb = col.fb(k, j, ic);
    float tend = -(col.fe(k, j, ic) - col.fe(k, j, iw)) * cstdxt2r
                 - (col.fn(k, j, ic) - col.fn(k, js, ic)) * cstdyt2r
                 - (fb_up - fb) * f.kfac(1, k);
    fb_up = fb;

    // harmonic horizontal diffusion
    float dfe = f.jf(3, j, ic) * (tme - tm);
    float dfw = f.jf(3, j, iw) * (tm - tmw);
    tend += (dfe * me - dfw * mw) * cstdxtr;
    if (a.fluxform) {
      tend += (yA * (tmn - tm) * mn - yAs * (tm - tms) * ms) * yB;
    } else {
      tend += yA * mn * (tmn - tm) - yB * ms * (tm - tms);
    }

    // explicit vertical diffusion; the bottom face of the deepest wet
    // cell carries btf, the surface face stf
    float dfb = k < a.km - 1
        ? a.dcb[c] * f.kfac(3, k) * (tm - f.tm[f.at(k + 1, j, ic)]) : 0.f;
    if (k == kmt - 1) dfb = btf;
    tend += ((k == 0 ? stf : dfb_up) - dfb) * dztr * (1.f - a.aidif);
    dfb_up = dfb;

    if (iso) {
      float fbi = col.fb_iso(k, j, ic);
      tend += (col.fe_iso(k, j, ic) * me - col.fe_iso(k, j, iw) * mw) * cstdxtr
              + (col.fn_iso(k, j, ic) * mn - col.fn_iso(k, js, ic) * ms) * yB
              + (fbi_up - fbi) * dztr;
      fbi_up = fbi;
    }
    if (a.src != nullptr) tend += a.src[n * vol + c];

    float t_new = tm + twodt * tend * msk;

    if (a.aidif > 0.f) {
      // implicit vertical diffusion, forward sweep (invtri.F)
      float ak = 0.f;
      if (k > 0) {
        ak = -a.dcb[f.at(k - 1, j, ic)] * (f.kfac(4, k) * twodt * a.aidif) * msk;
      }
      float ck = 0.f;
      if (k < a.km - 1) {
        ck = -a.dcb[c] * (f.kfac(5, k) * twodt * a.aidif)
             * tmask[f.at(k + 1, j, ic)];
      }
      float bk = 1.f - ak - ck;
      float fk = t_new * msk;
      if (k == 0) fk += stf * twodt * dztr * a.aidif * msk;
      if (k == kb) fk -= btf * twodt * dztr * a.aidif * msk;
      if (k == 0) {
        bet = msk / (bk + THOMAS_EPS);
        z[0] = fk * bet;
        e[0] = 0.f;
      } else {
        e[k] = c_up * bet;
        bet = msk / (bk - ak * e[k] + THOMAS_EPS);
        z[k] = (fk - ak * z[k - 1]) * bet;
      }
      c_up = ck;
    } else {
      z[k] = t_new;
    }
  }
  if (a.aidif > 0.f) {
    for (int k = a.km - 2; k >= 0; --k) z[k] -= e[k + 1] * z[k + 1];
  }
  float* o = a.out + n * vol;
  for (int k = 0; k < a.km; ++k) o[f.at(k, j, i)] = z[k];
}

}  // namespace

extern "C" int uvic_fct_tracer_step(
    const float* t_tau, const float* tm1, const float* vet, const float* vnt,
    const float* vbt, const float* tmask, const float* dcb, const float* stf,
    const float* btf, const float* src, const float* isow, const float* kf,
    const float* jif, const int* kmt, float* ratio, float* out,
    int nt, int km, int jmt, int imt, float aidif, int fluxform, void* stream) {
  if (km > KMAX || km < 2) return (int)cudaErrorInvalidValue;
  Args a{t_tau, tm1, vet, vnt, vbt, tmask, dcb, stf, btf, src, isow, kf, jif,
         kmt, ratio, out, nt, km, jmt, imt, aidif, fluxform};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  size_t cells = (size_t)nt * km * jmt * imt;
  fct_ratios_kernel<<<(unsigned)((cells + 255) / 256), 256, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  size_t cols = (size_t)nt * jmt * imt;
  fct_column_kernel<<<(unsigned)((cols + 127) / 128), 128, 0, s>>>(a);
  return (int)cudaGetLastError();
}
