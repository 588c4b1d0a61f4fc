// The plain (uncompensated) whole-run MacCormack loop on periodic edges
// for Hopper (sm_90a), float32.
//
// Replaces three Pallas TPU kernels of gapflow_tpu/ops/stencil.py, the
// plain branch of make_pallas_loop:
//   - gf_plain_sweeps <- _kernel_fused_hbm_loop with _advance_plain (K2p):
//     a whole plain run of n steps in one C call, sweeps of k steps
//     (ops/stencil.py _plain_k_steps) temporally blocked on chip, each
//     cell's values in registers across the sweep (stencil_sweep.cuh), as
//     the TPU kernel folded the sweeps into its grid;
//   - its last sweep, of n mod k steps <- _kernel_fused_ext (Ke): the
//     remainder steps.  Ke's own job, carrying the halo-extended state
//     between steps without a re-layout pass, has no counterpart here:
//     the window indices wrap, so no extended layout exists.
//     gf_plain_steps is one sweep of k (1..4) steps on its own;
//   - gf_plain_run   <- _kernel_fused_vmem (Kv): the whole n-step run in
//     one cooperative launch.  Each step advances every tile by K1's
//     tile body (stencil_tile.cuh), the state ping-pongs between two
//     device buffers, and a grid-wide barrier separates the steps.  The
//     loop driver takes it where the pair and the statics ((2*3 + 8)
//     nx ny floats) fit the L2 cache, the counterpart of the TPU
//     kernel's VMEM gate: the state then stays in L2 across the run.
//     It launches no more blocks than can be co-resident (occupancy x
//     SMs), striding over the tiles; a refused cooperative launch is
//     returned as an error, never replaced.
//
// What bounds them: see stencil_sweep.cuh for the k-step sweep (FP32
// work and the instructions around it once k steps share one pass over
// device memory).  Kv reads and writes the L2-resident state each step,
// so its bound is FP32 work or L2 bandwidth; device memory is touched
// about twice per run.
//
// Build: see stencil.cu and ops/_build.py (--fmad=false, IEEE division),
// so that the kernels round like K1 launched once per step.  The grid
// barrier needs no -rdc (CUDA >= 11).

#include <cooperative_groups.h>

#include "stencil_sweep.cuh"
#include "stencil_tile.cuh"

namespace cg = cooperative_groups;

namespace {

__global__ void __launch_bounds__(TX * TY)
plain_run_kernel(const float* __restrict__ q, const float* __restrict__ st,
                 float* A, float* B, int nx, int ny, int n, int d0, float dt,
                 Params P) {
    cg::grid_group grid = cg::this_grid();
    const ArrayStatics S{st, (size_t)nx * ny, ny};
    const int tiles_y = (ny + TY - 1) / TY;
    const int tiles = tiles_y * ((nx + TX - 1) / TX);
    for (int s = 0; s < n; ++s) {
        const float* src = s == 0 ? q : (s % 2 == 1 ? A : B);
        float* dst = s % 2 == 0 ? A : B;
        for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
            step_tile<STATE, ArrayStatics, true>(
                src, nullptr, S, dst, nullptr, nx, ny, (t / tiles_y) * TX,
                (t % tiles_y) * TY, d0, dt, P);
            __syncthreads();      // the tile's shared memory is reused
        }
        grid.sync();
    }
}

}  // namespace

// C entry points (ctypes).  Device arrays, contiguous float32: q/out/A/B
// (3, nx, ny), st (8, nx, ny).  iprm/fprm as for gf_fused_step (host
// memory).  Each returns the launch's CUDA error (0 on success).

// k (1..4) plain periodic steps in one launch.
extern "C" int gf_plain_steps(const float* q, const float* st, float* out,
                              int nx, int ny, int k, int d0, const int* iprm,
                              const float* fprm, float dt, void* stream) {
    const Params P = make_params(iprm, fprm);
    return plain_sweeps<false, false>(q, st, out, nullptr, nx, ny, k, k, d0,
                                      dt, P, Bc{}, Thin{}, stream);
}

// n plain periodic steps in sweeps of k (1..4) and one of n mod k
// (stencil_sweep.cuh plain_sweeps); A, B (3, nx, ny) device buffers; the
// result is in A for an odd number of sweeps, else in B.
extern "C" int gf_plain_sweeps(const float* q, const float* st, float* A,
                               float* B, int nx, int ny, int n, int k,
                               int d0, const int* iprm, const float* fprm,
                               float dt, void* stream) {
    const Params P = make_params(iprm, fprm);
    return plain_sweeps<false, false>(q, st, A, B, nx, ny, n, k, d0, dt, P,
                                      Bc{}, Thin{}, stream);
}

// n plain periodic steps in one cooperative launch; the result is in A
// for odd n, in B for even n.  blocks > 0 forces the grid size (a test of
// the refused launch), else the co-resident maximum, at most one block
// per tile.
extern "C" int gf_plain_run(const float* q, const float* st, float* A,
                            float* B, int nx, int ny, int n, int d0,
                            const int* iprm, const float* fprm, float dt,
                            int blocks, void* stream) {
    Params P = make_params(iprm, fprm);
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, plain_run_kernel, TX * TY, 0);
    if (e != cudaSuccess) return (int)e;
    const int tiles = ((ny + TY - 1) / TY) * ((nx + TX - 1) / TX);
    const int grid = blocks > 0 ? blocks
                                : (per_sm * sms < tiles ? per_sm * sms : tiles);
    void* args[] = {(void*)&q, (void*)&st, (void*)&A, (void*)&B, (void*)&nx,
                    (void*)&ny, (void*)&n, (void*)&d0, (void*)&dt, (void*)&P};
    e = cudaLaunchCooperativeKernel((const void*)plain_run_kernel, dim3(grid),
                                    dim3(TY, TX), args, 0,
                                    (cudaStream_t)stream);
    const cudaError_t last = cudaGetLastError();   // clears a refused launch
    return (int)(e != cudaSuccess ? e : last);
}
