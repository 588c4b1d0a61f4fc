// One periodic MacCormack step of one TX x TY tile, templated on where
// the eight static channels of a cell come from.  Shared by the periodic
// kernels of stencil.cu (K1/K2) and stencil_plain.cu (Kv), the statics
// precomputed in device memory; the update is also K9's
// (stencil_shard.cu).
//
// A Statics type provides
//     __device__ void load(int i, int j, float s[N_STATIC]) const
// for a wrapped interior cell (i, j), filling (Hx, Hy, H, 2 Ls, 1/H,
// 1/(4 Ls + H), 2 (3 Ls + H)/(4 Ls + H)^2, 6 Ls), the layout of
// models/closures_opt.py precompute_statics.

#pragma once

#include "stencil_common.cuh"

namespace {

constexpr int LX = TX + 4, LY = TY + 4;   // loaded region: tile + 2-cell halo
constexpr int RX = TX + 2, RY = TY + 2;   // pass-d0 region: tile + 1-cell ring

// The statics precomputed by ops/stencil.py interior_statics: (8, nx, ny).
// Read-only inputs are read through the non-coherent cache (__ldg).
struct ArrayStatics {
    const float* st;
    size_t plane;
    int ny;

    __device__ __forceinline__ void load(int i, int j, float* s) const {
        const size_t g = (size_t)i * ny + j;
#pragma unroll
        for (int c = 0; c < N_STATIC; ++c) s[c] = __ldg(st + c * plane + g);
    }
};

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

// One MacCormack step of the TX x TY tile at interior cell (x0, y0).
// Block = TY x TX threads.  MODE: STATE writes the new state, DELTA the
// increment ((q* - q) - u) / 2, COMP the Kahan-compensated (q, q_lo)
// carry.  COHERENT reads q through L2 only (__ldcg): the persistent
// whole-run kernel of stencil_plain.cu reads the state that other blocks
// wrote earlier in the same launch, which the read-only path may not see.
template <int MODE, class Statics, bool COHERENT = false>
__device__ void step_tile(const float* __restrict__ q,
                          const float* __restrict__ lo,
                          const Statics ST,
                          float* __restrict__ out,
                          float* __restrict__ lo_out,
                          int nx, int ny, int x0, int y0, int d0, float dt,
                          const Params& P) {
    __shared__ float qL[3][LX][LY];        // q on the loaded region
    __shared__ float fL[5][LX][LY];        // pass-d0 fluxes
    __shared__ float sR[3][RX][RY];        // pass-d0 sources (ring region)
    __shared__ float aR[3][RX][RY];        // predictor state q*
    __shared__ float fR[5][RX][RY];        // pass-d1 fluxes
    __shared__ float s1R[3][RX][RY];       // pass-d1 sources

    const size_t plane = (size_t)nx * ny;
    const int tid = threadIdx.y * TY + threadIdx.x;
    const int nthreads = TX * TY;
    const int d1 = -d0;

    // pass d0 closures on the tile + 2-cell halo (periodic in x and y)
    for (int k = tid; k < LX * LY; k += nthreads) {
        const int li = k / LY, lj = k % LY;
        const int gi = wrap(x0 + li - 2, nx), gj = wrap(y0 + lj - 2, ny);
        const size_t g = (size_t)gi * ny + gj;
        float s[N_STATIC];
        ST.load(gi, gj, s);
        auto ld = [&](size_t i) { return COHERENT ? __ldcg(q + i) : q[i]; };
        const float a = ld(g), b = ld(plane + g), cc = ld(2 * plane + g);
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
        float s[N_STATIC];
        ST.load(wrap(x0 + ri - 1, nx), wrap(y0 + rj - 1, ny), s);
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

}  // namespace
