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

#include "stencil_common.cuh"

namespace {

constexpr int LX = TX + 4, LY = TY + 4;   // loaded region: tile + 2-cell halo
constexpr int RX = TX + 2, RY = TY + 2;   // pass-d0 region: tile + 1-cell ring

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
