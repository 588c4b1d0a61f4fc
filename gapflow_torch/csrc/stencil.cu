// Fused periodic MacCormack step for Hopper (sm_90a), float32.
//
// Replaces the two Pallas TPU kernels on the deterministic f32 path of
// gapflow_tpu/ops/stencil.py:
//   - gf_fused_step  <- _kernel_fused (+ _one_pass_fused): one step, writing
//     the new interior state;
//   - gf_comp_sweeps <- _kernel_fused_hbm_loop with _advance_comp (K2c):
//     n Kahan-compensated steps on the (q, q_lo) carry,
//       delta = ((q* - q) - u) / 2;  y = delta + lo;  t = q + y;
//       lo' = y - (t - q),
//     in the same order as _advance_comp, in one C call: sweeps of k
//     (1..4; 3 on the main path, ops/stencil.py _comp_k_steps) steps
//     temporally blocked on chip (the compensated form of
//     stencil_multi.cuh) and one sweep of n mod k, ping-ponging two
//     buffer pairs as the TPU kernel ping-pongs outA/outB.
// A third entry, gf_comp_step, is one compensated step on this file's
// tile body: the witness that the sweeps equal k launches of it bit for
// bit (tests/test_torch_gpu.py, chip_smoke.py phase 2i); no main path
// launches it.
//
// What bounds the one-step kernels: memory bytes.  Per cell and step
// the kernel reads about 11 floats (3 of q, 8 precomputed statics; 14
// with the Kahan carry) and writes 3 (6 with the carry) against ~250
// flops, far below the card's flop/byte balance.  The tile is what keeps the rest out of device
// memory: each 256-thread block owns a TX x TY tile of interior cells,
// reads q and the statics once for the tile plus a 2-cell periodic halo
// (wrapped in x AND y by index arithmetic; the TPU kernel used a
// pre-extended x halo and a full-width lane roll in y), evaluates pass d0
// on the tile plus a 1-cell ring into shared memory, then pass d1 on the
// tile.  Pressure, stresses, fluxes and the predictor state never reach
// device memory.  Halo cells are re-read by neighbouring blocks, mostly
// from L2.
//
// The tile body (step_tile) is in stencil_tile.cuh, shared with the
// whole-run kernel of stencil_plain.cu.
//
// The sweeps are bound by FP32 work instead (stencil_multi.cuh).  Not
// done yet (later performance work): capturing the chunk loop in a CUDA
// graph, and vectorised 16-byte loads.
//
// Build (ops/_build.py): nvcc -gencode arch=compute_90a,code=sm_90a -O3
//        --fmad=false -shared -Xcompiler -fPIC.  No --use_fast_math: it
//        approximates division and exp and flushes denormals, which would
//        break the Kahan carry's sub-ulp increments.  --fmad=false keeps
//        the rounding op for op equal to the plain torch twin.

#include "stencil_multi.cuh"
#include "stencil_tile.cuh"

namespace {

__global__ void __launch_bounds__(TX * TY)
fused_step_kernel(const float* __restrict__ q, const float* __restrict__ st,
                  float* __restrict__ out, int nx, int ny, int d0, float dt,
                  Params P) {
    const ArrayStatics S{st, (size_t)nx * ny, ny};
    step_tile<STATE>(q, nullptr, S, out, nullptr, nx, ny, blockIdx.y * TX,
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
                             int nx, int ny, int d0, const int* iprm,
                             const float* fprm, float dt, void* stream) {
    const Params P = make_params(iprm, fprm);
    fused_step_kernel<<<grid_for(nx, ny), dim3(TY, TX), 0,
                        (cudaStream_t)stream>>>(q, st, out, nx, ny, d0, dt,
                                                P);
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

// n compensated periodic steps in sweeps of k (1..4) and one of n mod k
// (stencil_multi.cuh comp_sweeps); A, B (6, nx, ny) device buffers, q
// then q_lo; the result is in A for an odd number of sweeps, else in B.
extern "C" int gf_comp_sweeps(const float* q, const float* lo,
                              const float* st, float* A, float* B, int nx,
                              int ny, int n, int k, int d0, const int* iprm,
                              const float* fprm, float dt, void* stream) {
    const Params P = make_params(iprm, fprm);
    const Bc bc{};
    const Thin T{};
    return comp_sweeps<false, false>(q, lo, st, A, B, nx, ny, n, k, d0, dt,
                                     P, bc, T, stream);
}

extern "C" const char* gf_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
