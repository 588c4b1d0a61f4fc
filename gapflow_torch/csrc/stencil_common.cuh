// Device functions shared by the stencil kernels of stencil.cu (periodic
// K1/K2) and stencil_bc.cu (boundary K3/K4): the model parameters, the
// equations of state, piezoviscosity, shear thinning and the factored
// closures of models/closures_opt.py.  One copy, so the kernels cannot
// drift apart.  Everything sits in an anonymous namespace: each source
// compiles its own copy, and the shared library links both.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TY = 32;               // tile width along y (contiguous axis)
constexpr int TX = 8;                // tile height along x
constexpr int N_STATIC = 8;
constexpr int N_EOS_PRM = 16;
constexpr int N_PIEZO_PRM = 8;

enum Eos { DH = 0, PL = 1, VDW = 2, MT = 3, CUBIC = 4, BWR = 5, BAYADA = 6 };
enum Piezo { CONST = 0, BARUS = 1, ROELANDS = 2, DUKLER = 3, MCADAMS = 4 };

// What a step kernel writes: the new state, the increment
// ((q* - q) - u) / 2, or the Kahan-compensated (q, q_lo) carry.
enum Mode { STATE = 0, DELTA = 1, COMP = 2 };

// Host-derived parameters; the layout of the float block is documented at
// ops/stencil.py:_kernel_params, which builds it.
struct Params {
    int eos, piezo, piezo_rho;
    float rdx, rdy, U, V, shear, bulk;
    float e[N_EOS_PRM];
    float z[N_PIEZO_PRM];
};

__device__ __forceinline__ float eos_pressure(float rho, const Params& P) {
    const float* e = P.e;
    switch (P.eos) {
    case DH: {      // rho0, P0, C1, C2, 0.99*C2*rho0
        float r = fminf(rho, e[4]) / e[0];
        return e[1] + e[2] * (r - 1.f) / (e[3] - r);
    }
    case PL:        // rho0, P0, 1/(1 - alpha/2)
        return e[1] * powf(rho / e[0], e[2]);
    case VDW: {     // M, R*T, a_si, b_si
        float n = rho / e[0] * 1000.f;
        return e[1] * n / (1.f - e[3] * n) - e[2] * (n * n);
    }
    case MT:        // rho0, P0, K/n, n
        return e[2] * (powf(rho / e[0], e[3]) - 1.f) + e[1];
    case CUBIC:     // a, b, c, d
        return ((e[0] * rho + e[1]) * rho + e[2]) * rho + e[3];
    case BWR: {     // poly[0..8], expo[0..5], gamma
        float rho2 = rho * rho;
        float pp = 0.f;
        for (int k = 8; k >= 0; --k) pp = (pp + e[k]) * rho;
        float pe = 0.f;
        for (int k = 5; k >= 0; --k) pe = pe * rho2 + e[9 + k];
        pe = pe * (rho * rho * rho) * expf(-e[15] * rho2);
        return pp + pe;
    }
    default: {      // BAYADA: rho_l, rho_v-rho_l, Pcav, N, c_l^2, c_v^2,
                    //         rho_v c_v^2, rho_l c_l^2
        float alpha = (rho - e[0]) / e[1];
        float p_liq = e[2] + (rho - e[0]) * e[4];
        float denom = e[0] * (e[6] * (1.f - alpha) + e[7] * alpha);
        float arg = e[6] * rho / denom;
        float p_mix = e[2] + e[3] * logf(arg > 0.f ? arg : 1.f);
        float p_vap = e[5] * rho;
        return alpha < 0.f ? p_liq : (alpha <= 1.f ? p_mix : p_vap);
    }
    }
}

__device__ __forceinline__ float shear_viscosity(float rho, float p,
                                                 const Params& P) {
    const float* z = P.z;
    const float mu0 = P.shear;
    const float x = P.piezo_rho ? rho : p;
    switch (P.piezo) {
    case BARUS:     // aB
        return mu0 * expf(z[0] * x);
    case ROELANDS:  // log(mu0/mu_inf), p_ref, z
        return mu0 * expf(z[0] * (-1.f + powf(1.f + x / z[1], z[2])));
    case DUKLER: {  // eta_v, rho_l, rho_v - rho_l
        float alpha = (x - z[1]) / z[2];
        return alpha * z[0] + (1.f - alpha) * mu0;
    }
    case MCADAMS: { // eta_v, rho_l, rho_v - rho_l, rho_v
        float alpha = (x - z[1]) / z[2];
        float M = alpha * z[3] / x;
        return z[0] * mu0 / (mu0 * M + z[0] * (1.f - M));
    }
    default:
        return mu0;
    }
}

// Shear-thinning parameters (ops/stencil.py:_bc_params builds them).
// model 1 Eyring: a[0] = tauE.  model 2 Carreau: a = {mu_inf, lam, a,
// (N - 1)/a}.  vmu = V - U, the Couette term of the mean shear rate.
struct Thin {
    int model;
    float vmu, dx, dy;
    float a[4];
};

// Viscosity after shear thinning (models.viscosity.shear_rate_avg and
// shear_thinning_factor, as core.step.effective_viscosity applies them),
// from the pressure gradient, the gap height and the piezoviscous mu0.
__device__ __forceinline__ float thinning_eta(float dpx, float dpy, float h,
                                              float mu0, const Thin& T) {
    const float du_pois = (h * hypotf(dpx, dpy)) / (2.f * mu0);
    const float du_carr = T.vmu / h;
    const float rate = (fabsf(du_pois + du_carr)
                        + fabsf(-du_pois + du_carr)) / 2.f;
    float factor;
    if (T.model == 1) {             // Eyring
        const float tau0 = mu0 * rate;
        const float x = tau0 / T.a[0];
        factor = (T.a[0] / tau0)
            * log1pf(x + x * x / (1.f + sqrtf(1.f + x * x)));
    } else {                        // Carreau
        const float mu = T.a[0] + (mu0 - T.a[0])
            * powf(1.f + powf(T.a[1] * rate, T.a[2]), T.a[3]);
        factor = mu / mu0;
    }
    return mu0 * factor;
}

// One cell of closures_opt.fused_pass_top_pre with a given pressure and
// viscosity.  Outputs the five flux values the one-sided differences read
// (jx, jy, p + tb_xx, tb_xy, p + tb_yy) and the sources.
struct CellFlux {
    float f[5];
    float s[3];
};

__device__ __forceinline__ CellFlux closures_eta(float q0, float q1, float q2,
                                                 const float* st, float p,
                                                 float eta, const Params& P) {
    const float Hx = st[0], Hy = st[1], H = st[2], Ls2 = st[3];
    const float inv_h = st[4], ic = st[5], k2s = st[6], Ls6 = st[7];
    const float U = P.U, V = P.V, zeta = P.bulk;

    const float v1 = zeta + (4.f / 3.f) * eta;
    const float v2 = zeta - (2.f / 3.f) * eta;

    const float ir = 1.f / q0;
    const float g = ic * ir;

    const float Ur = U * q0, Vr = V * q0;
    const float ax = 3.f * q1 - Ur, ay = 3.f * q2 - Vr;
    const float bx = Ls2 * (Ur - q1) + H * q1;
    const float by = Ls2 * (Vr - q2) + H * q2;

    const float gh = g * inv_h;
    const float hxbx = Hx * bx, hyby = Hy * by;
    const float tb_xx = (v1 * hxbx + v2 * hyby) * gh;
    const float tb_yy = (v2 * hxbx + v1 * hyby) * gh;
    const float tb_xy = eta * (Hy * bx + Hx * by) * gh;

    const float k2 = k2s * ir;
    const float hxax = Hx * ax, hyay = Hy * ay;
    const float su_xx = k2 * (v1 * hxax + v2 * hyay);
    const float su_yy = k2 * (v2 * hxax + v1 * hyay);
    const float su_xy = k2 * eta * (Hy * ax + Hx * ay);

    const float e2g = 2.f * eta * g;
    const float su_xz = -e2g * ax, su_yz = -e2g * ay;
    const float sl_xz = e2g * (Ls6 * (q1 - Ur) + H * (3.f * q1 - 2.f * Ur)) * inv_h;
    const float sl_yz = e2g * (Ls6 * (q2 - Vr) + H * (3.f * q2 - 2.f * Vr)) * inv_h;

    CellFlux c;
    c.f[0] = q1;
    c.f[1] = q2;
    c.f[2] = p + tb_xx;
    c.f[3] = tb_xy;
    c.f[4] = p + tb_yy;
    c.s[0] = (-q1 * Hx - q2 * Hy) * inv_h;
    c.s[1] = ((tb_xx - su_xx) * Hx + (tb_xy - su_xy) * Hy + su_xz - sl_xz) * inv_h;
    c.s[2] = ((tb_xy - su_xy) * Hx + (tb_yy - su_yy) * Hy + su_yz - sl_yz) * inv_h;
    return c;
}

// The same, preceded by the EOS and the piezoviscous eta.
__device__ __forceinline__ CellFlux closures(float q0, float q1, float q2,
                                             const float* st,
                                             const Params& P) {
    const float p = eos_pressure(q0, P);
    return closures_eta(q0, q1, q2, st, p, shear_viscosity(q0, p, P), P);
}

Params make_params(const int* iprm, const float* fprm) {
    Params P;
    P.eos = iprm[0];
    P.piezo = iprm[1];
    P.piezo_rho = iprm[2];
    P.rdx = fprm[0];
    P.rdy = fprm[1];
    P.U = fprm[2];
    P.V = fprm[3];
    P.shear = fprm[4];
    P.bulk = fprm[5];
    for (int k = 0; k < N_EOS_PRM; ++k) P.e[k] = fprm[6 + k];
    for (int k = 0; k < N_PIEZO_PRM; ++k) P.z[k] = fprm[6 + N_EOS_PRM + k];
    return P;
}

dim3 grid_for(int nx, int ny) {
    return dim3((ny + TY - 1) / TY, (nx + TX - 1) / TX);
}

__device__ __forceinline__ int wrap(int i, int n) {
    i %= n;
    return i < 0 ? i + n : i;
}

// -- edge codes of the boundary kernels (stencil_bc.cu, stencil_sweep.cuh) --

enum Code { CP = 0, CD = 1, CN = 2, CG = 3 };

// Per-edge component codes, two bits each at bit 6 e + 2 c, and the
// Dirichlet values (2 val, rounded once on the host); edges 0..3 = xE
// (X = -1), xW (X = nx), yS (Y = -1), yN (Y = ny).  Read only through
// code() and twoval(): a kernel parameter indexed at run time would be
// copied to local memory by every thread.
struct Bc {
    unsigned codes;
    float tv[4];
};

__device__ __host__ __forceinline__ int code(const Bc& bc, int e, int c) {
    return (bc.codes >> (6 * e + 2 * c)) & 3;
}

__device__ __forceinline__ float twoval(const Bc& bc, int e) {
    return e == 0 ? bc.tv[0] : e == 1 ? bc.tv[1] : e == 2 ? bc.tv[2]
                                                          : bc.tv[3];
}

__device__ __forceinline__ float fill(int code, float twoval, float adj) {
    return code == CD ? twoval - adj : adj;
}

// np.gradient along one axis at ghost-inclusive index X of [-1, n]:
// one-sided at the ghost slots, centred inside.
__device__ __forceinline__ float grad(int X, int n, float pm, float p0,
                                      float pp, float h) {
    if (X <= -1) return (pp - p0) / h;
    if (X >= n) return (p0 - pm) / h;
    return ((pp - pm) / h) / 2.f;
}

// bprm: 12 edge codes (edge-major), thinning model; bfprm: 2 val per
// edge, V - U, dx, dy, 4 thinning parameters.
void make_bc(const int* bprm, const float* bfprm, Bc* bc, Thin* T) {
    bc->codes = 0;
    for (int e = 0; e < 4; ++e) {
        for (int c = 0; c < 3; ++c)
            bc->codes |= (unsigned)bprm[3 * e + c] << (6 * e + 2 * c);
        bc->tv[e] = bfprm[e];
    }
    T->model = bprm[12];
    T->vmu = bfprm[4];
    T->dx = bfprm[5];
    T->dy = bfprm[6];
    for (int k = 0; k < 4; ++k) T->a[k] = bfprm[7 + k];
}

}  // namespace
