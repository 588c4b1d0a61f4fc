// Fused periodic MacCormack step for Hopper (sm_90a), float32.
//
// Replaces the two Pallas TPU kernels on the deterministic f32 path of
// gapflow_tpu/ops/stencil.py:
//   - gf_fused_step  <- _kernel_fused (+ _one_pass_fused): one step, writing
//     the new interior state or, in emit_delta form, the increment
//     ((q* - q) - u) / 2 for compensated accumulation;
//   - gf_comp_step   <- _kernel_fused_hbm_loop with _advance_comp: one
//     Kahan-compensated step on the (q, q_lo) carry,
//       delta = ((q* - q) - u) / 2;  y = delta + lo;  t = q + y;
//       lo' = y - (t - q),
//     in the same order as _advance_comp.  The Python wrapper loops the
//     launches and ping-pongs two buffer pairs, as the TPU kernel
//     ping-pongs outA/outB.
//
// What bounds it: memory bytes.  Per cell and step the kernel reads about
// 11 floats (3 of q, 8 precomputed statics; 14 with the Kahan carry) and
// writes 3 (6 with the carry) against ~250 flops, far below the card's
// flop/byte balance.  The tile is what keeps the rest out of device
// memory: each 256-thread block owns a TX x TY tile of interior cells,
// reads q and the statics once for the tile plus a 2-cell periodic halo
// (wrapped in x AND y by index arithmetic; the TPU kernel used a
// pre-extended x halo and a full-width lane roll in y), evaluates pass d0
// on the tile plus a 1-cell ring into shared memory, then pass d1 on the
// tile.  Pressure, stresses, fluxes and the predictor state never reach
// device memory.  Halo cells are re-read by neighbouring blocks, mostly
// from L2.
//
// Not done yet (later performance work): temporal blocking (K_MULTI = 4
// steps per launch, as the TPU kernel), capturing the launch loop in a
// CUDA graph, and vectorised 16-byte loads.
//
// Build (ops/_build.py): nvcc -gencode arch=compute_90a,code=sm_90a -O3
//        --fmad=false -shared -Xcompiler -fPIC.  No --use_fast_math: it
//        approximates division and exp and flushes denormals, which would
//        break the Kahan carry's sub-ulp increments.  --fmad=false keeps
//        the rounding op for op equal to the plain torch twin.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TY = 32;               // tile width along y (contiguous axis)
constexpr int TX = 8;                // tile height along x
constexpr int LX = TX + 4, LY = TY + 4;   // loaded region: tile + 2-cell halo
constexpr int RX = TX + 2, RY = TY + 2;   // pass-d0 region: tile + 1-cell ring
constexpr int N_STATIC = 8;
constexpr int N_EOS_PRM = 16;
constexpr int N_PIEZO_PRM = 8;

enum Eos { DH = 0, PL = 1, VDW = 2, MT = 3, CUBIC = 4, BWR = 5, BAYADA = 6 };
enum Piezo { CONST = 0, BARUS = 1, ROELANDS = 2, DUKLER = 3, MCADAMS = 4 };

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

// One cell of closures_opt.fused_pass_top_pre, preceded by the EOS and
// the piezoviscous eta.  Outputs the five flux values the one-sided
// differences read (jx, jy, p + tb_xx, tb_xy, p + tb_yy) and the sources.
struct CellFlux {
    float f[5];
    float s[3];
};

__device__ __forceinline__ CellFlux closures(float q0, float q1, float q2,
                                             const float* st,
                                             const Params& P) {
    const float Hx = st[0], Hy = st[1], H = st[2], Ls2 = st[3];
    const float inv_h = st[4], ic = st[5], k2s = st[6], Ls6 = st[7];
    const float U = P.U, V = P.V, zeta = P.bulk;

    const float p = eos_pressure(q0, P);
    const float eta = shear_viscosity(q0, p, P);

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

__device__ __forceinline__ int wrap(int i, int n) {
    i %= n;
    return i < 0 ? i + n : i;
}

// Update u = dt * (ddx(Fx) + ddy(Fy) - S) of the three components at one
// cell, from flux arrays laid out [5][X][Y] in shared memory, with the
// one-sided difference ddx(F)[i] = -d * (F[i-d] - F[i]) * rdx.
template <int X, int Y>
__device__ __forceinline__ void update(float (*F)[X][Y],
                                       const float* S, int i, int j, int d,
                                       float dt, const Params& P, float u[3]) {
    const float md = (float)(-d);
    auto ddx = [&](int k) { return md * (F[k][i - d][j] - F[k][i][j]) * P.rdx; };
    auto ddy = [&](int k) { return md * (F[k][i][j - d] - F[k][i][j]) * P.rdy; };
    u[0] = dt * (ddx(0) + ddy(1) - S[0]);
    u[1] = dt * (ddx(2) + ddy(3) - S[1]);
    u[2] = dt * (ddx(3) + ddy(4) - S[2]);
}

enum Mode { STATE = 0, DELTA = 1, COMP = 2 };

// One MacCormack step of one TX x TY tile.  Block = TY x TX threads.
template <int MODE>
__device__ void step_tile(const float* __restrict__ q,
                          const float* __restrict__ lo,
                          const float* __restrict__ st,
                          float* __restrict__ out,
                          float* __restrict__ lo_out,
                          int nx, int ny, int d0, float dt, const Params& P) {
    __shared__ float qL[3][LX][LY];        // q on the loaded region
    __shared__ float fL[5][LX][LY];        // pass-d0 fluxes
    __shared__ float sR[3][RX][RY];        // pass-d0 sources (ring region)
    __shared__ float aR[3][RX][RY];        // predictor state q*
    __shared__ float fR[5][RX][RY];        // pass-d1 fluxes
    __shared__ float s1R[3][RX][RY];       // pass-d1 sources

    const size_t plane = (size_t)nx * ny;
    const int x0 = blockIdx.y * TX, y0 = blockIdx.x * TY;
    const int tid = threadIdx.y * TY + threadIdx.x;
    const int nthreads = TX * TY;
    const int d1 = -d0;

    // pass d0 closures on the tile + 2-cell halo (periodic in x and y)
    for (int k = tid; k < LX * LY; k += nthreads) {
        const int li = k / LY, lj = k % LY;
        const size_t g = (size_t)wrap(x0 + li - 2, nx) * ny + wrap(y0 + lj - 2, ny);
        float s[N_STATIC];
#pragma unroll
        for (int c = 0; c < N_STATIC; ++c) s[c] = st[c * plane + g];
        const float a = q[g], b = q[plane + g], cc = q[2 * plane + g];
        qL[0][li][lj] = a;
        qL[1][li][lj] = b;
        qL[2][li][lj] = cc;
        const CellFlux f = closures(a, b, cc, s, P);
#pragma unroll
        for (int c = 0; c < 5; ++c) fL[c][li][lj] = f.f[c];
        const int ri = li - 1, rj = lj - 1;
        if (ri >= 0 && ri < RX && rj >= 0 && rj < RY) {
#pragma unroll
            for (int c = 0; c < 3; ++c) sR[c][ri][rj] = f.s[c];
        }
    }
    __syncthreads();

    // predictor on the tile + 1-cell ring, then pass d1 closures there
    for (int k = tid; k < RX * RY; k += nthreads) {
        const int ri = k / RY, rj = k % RY;
        const int li = ri + 1, lj = rj + 1;
        const float S[3] = {sR[0][ri][rj], sR[1][ri][rj], sR[2][ri][rj]};
        float u[3];
        update<LX, LY>(fL, S, li, lj, d0, dt, P, u);
        const float a = qL[0][li][lj] - u[0];
        const float b = qL[1][li][lj] - u[1];
        const float cc = qL[2][li][lj] - u[2];
        aR[0][ri][rj] = a;
        aR[1][ri][rj] = b;
        aR[2][ri][rj] = cc;
        const size_t g = (size_t)wrap(x0 + ri - 1, nx) * ny + wrap(y0 + rj - 1, ny);
        float s[N_STATIC];
#pragma unroll
        for (int c = 0; c < N_STATIC; ++c) s[c] = st[c * plane + g];
        const CellFlux f = closures(a, b, cc, s, P);
#pragma unroll
        for (int c = 0; c < 5; ++c) fR[c][ri][rj] = f.f[c];
#pragma unroll
        for (int c = 0; c < 3; ++c) s1R[c][ri][rj] = f.s[c];
    }
    __syncthreads();

    // pass d1 update and temporal average on the tile
    const int ti = threadIdx.y, tj = threadIdx.x;
    const int gx = x0 + ti, gy = y0 + tj;
    if (gx >= nx || gy >= ny) return;
    const int ri = ti + 1, rj = tj + 1;
    const float S[3] = {s1R[0][ri][rj], s1R[1][ri][rj], s1R[2][ri][rj]};
    float u[3];
    update<RX, RY>(fR, S, ri, rj, d1, dt, P, u);
    const size_t g = (size_t)gx * ny + gy;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        const float q0 = qL[c][ti + 2][tj + 2];
        const float pred = aR[c][ri][rj];
        if (MODE == STATE) {
            out[c * plane + g] = ((pred - u[c]) + q0) / 2.f;
        } else {
            const float delta = ((pred - q0) - u[c]) / 2.f;
            if (MODE == DELTA) {
                out[c * plane + g] = delta;
            } else {
                const float y = delta + lo[c * plane + g];
                const float t = q0 + y;
                out[c * plane + g] = t;
                lo_out[c * plane + g] = y - (t - q0);
            }
        }
    }
}

template <int MODE>
__global__ void __launch_bounds__(TX * TY)
fused_step_kernel(const float* __restrict__ q, const float* __restrict__ st,
                  float* __restrict__ out, int nx, int ny, int d0, float dt,
                  Params P) {
    step_tile<MODE>(q, nullptr, st, out, nullptr, nx, ny, d0, dt, P);
}

__global__ void __launch_bounds__(TX * TY)
comp_step_kernel(const float* __restrict__ q, const float* __restrict__ lo,
                 const float* __restrict__ st, float* __restrict__ q_out,
                 float* __restrict__ lo_out, int nx, int ny, int d0,
                 float dt, Params P) {
    step_tile<COMP>(q, lo, st, q_out, lo_out, nx, ny, d0, dt, P);
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

}  // namespace

// C entry points (ctypes).  Arrays are contiguous float32 device memory:
// q/out/lo (3, nx, ny), st (8, nx, ny).  iprm = {eos, piezo, piezo_rho}
// and fprm (6 + 16 + 8 floats) are host memory.  Each returns
// cudaGetLastError() after its launch.

extern "C" int gf_fused_step(const float* q, const float* st, float* out,
                             int nx, int ny, int d0, int emit_delta,
                             const int* iprm, const float* fprm, float dt,
                             void* stream) {
    const Params P = make_params(iprm, fprm);
    const dim3 block(TY, TX);
    cudaStream_t s = (cudaStream_t)stream;
    if (emit_delta)
        fused_step_kernel<DELTA><<<grid_for(nx, ny), block, 0, s>>>(
            q, st, out, nx, ny, d0, dt, P);
    else
        fused_step_kernel<STATE><<<grid_for(nx, ny), block, 0, s>>>(
            q, st, out, nx, ny, d0, dt, P);
    return (int)cudaGetLastError();
}

extern "C" int gf_comp_step(const float* q, const float* lo, const float* st,
                            float* q_out, float* lo_out, int nx, int ny,
                            int d0, const int* iprm, const float* fprm,
                            float dt, void* stream) {
    const Params P = make_params(iprm, fprm);
    comp_step_kernel<<<grid_for(nx, ny), dim3(TY, TX), 0,
                       (cudaStream_t)stream>>>(q, lo, st, q_out, lo_out,
                                               nx, ny, d0, dt, P);
    return (int)cudaGetLastError();
}

extern "C" const char* gf_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
