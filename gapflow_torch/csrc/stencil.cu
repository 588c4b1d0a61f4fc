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
// The tile body (step_tile) is in stencil_tile.cuh, shared with the EHL
// step of stencil_ehl.cu, which derives the statics in-kernel.
//
// Temporal blocking (K_MULTI = 4 steps per launch, as the TPU kernel)
// exists for the plain loop only (stencil_plain.cu, stencil_multi.cuh);
// the compensated K2 still advances one step per launch.  Not done yet
// (later performance work): K2 on that design, capturing the launch loop
// in a CUDA graph, and vectorised 16-byte loads.
//
// Build (ops/_build.py): nvcc -gencode arch=compute_90a,code=sm_90a -O3
//        --fmad=false -shared -Xcompiler -fPIC.  No --use_fast_math: it
//        approximates division and exp and flushes denormals, which would
//        break the Kahan carry's sub-ulp increments.  --fmad=false keeps
//        the rounding op for op equal to the plain torch twin.

#include "stencil_tile.cuh"

namespace {

template <int MODE>
__global__ void __launch_bounds__(TX * TY)
fused_step_kernel(const float* __restrict__ q, const float* __restrict__ st,
                  float* __restrict__ out, int nx, int ny, int d0, float dt,
                  Params P) {
    const ArrayStatics S{st, (size_t)nx * ny, ny};
    step_tile<MODE>(q, nullptr, S, out, nullptr, nx, ny, blockIdx.y * TX,
                    blockIdx.x * TY, d0, dt, P);
}

__global__ void __launch_bounds__(TX * TY)
comp_step_kernel(const float* __restrict__ q, const float* __restrict__ lo,
                 const float* __restrict__ st, float* __restrict__ q_out,
                 float* __restrict__ lo_out, int nx, int ny, int d0,
                 float dt, Params P) {
    const ArrayStatics S{st, (size_t)nx * ny, ny};
    step_tile<COMP>(q, lo, S, q_out, lo_out, nx, ny, blockIdx.y * TX,
                    blockIdx.x * TY, d0, dt, P);
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
