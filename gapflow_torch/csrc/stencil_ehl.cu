// Fused periodic EHL step for Hopper (sm_90a), float32: the MacCormack step
// of stencil.cu with the eight static channels derived in-kernel from the
// deformed gap height, instead of read from a precomputed (8, nx, ny) array.
//
// Replaces the Pallas TPU kernel family K8 of gapflow_tpu/ops/stencil.py:
//   - gf_ehl_step      <- _kernel_fused_ehl (plain and emit_delta forms):
//     one step writing the new interior state or the increment
//     ((q* - q) - u) / 2;
//   - gf_ehl_comp_step <- _kernel_fused_ehl6: the compensated step on the
//     interior (q, q_lo) carry, the Kahan two-sum in registers in the order
//     of _advance_comp.
//
// The EHL protocol deforms the gap every step, so the statics cannot be
// hoisted out of the time loop; building them in torch costs about ten
// elementwise passes over the grid per step.  Here each cell's statics
// are formed where the tile needs them, from H = h_int (the deformed
// interior gap) and the slip length Ls:
//   Hx = (H[i+1] - H[i-1]) * (0.5/dx), wrapped, except interior rows 0
//        and nx-1, which take px[0] and px[1] (np.gradient over the
//        ghost-inclusive height reaches the ghost rows there, whose
//        heights need not be a wrap of the interior: a non-periodic gap
//        on periodic edges, the ghost FFT grid); the same holds where
//        those rows are read as the other edge's wrap neighbours;
//   Hy likewise along y, columns 0 and ny-1 from py[0] and py[1];
//   ic = 1/(4 Ls + H);  (Hx, Hy, H, 2 Ls, 1/H, ic, 2 (3 Ls + H) ic^2, 6 Ls),
// the layout of models/closures_opt.py precompute_statics.  The tile body
// is stencil_tile.cuh's, shared with K1/K2: indices wrap on both axes, so
// no halo-extended copies are made.
//
// What bounds it: memory bytes.  Per cell and step the compensated form
// reads 6 floats of carry plus H and Ls and writes 6 (the emit_delta form
// 3 + 2 in, 3 out), against ~300 FP32 operations, far below the card's
// balance.  The statics of a halo cell are formed again by every tile
// that reads it (about 1.5x the cells, plus four reads of H for the
// differences, mostly from L1/L2).  Not done yet: temporal blocking (the
// plain and compensated loops have it, stencil_sweep.cuh and
// stencil_multi.cuh; the EHL loop deforms
// the gap every step, so its statics change between steps) and CUDA
// graphs, as for K2.
//
// Build: see stencil.cu and ops/_build.py (--fmad=false, IEEE division,
// no --use_fast_math), so that kernel and plain twin round op for op.

#include "stencil_tile.cuh"

namespace {

// Statics of a wrapped interior cell from the interior gap height h
// (nx, ny), the slip length ls (nx, ny) and the boundary gradient
// patches px (2, ny) and py (2, nx).
struct EhlStatics {
    const float* h;
    const float* ls;
    const float* px;
    const float* py;
    int nx, ny;
    float rdx2, rdy2;

    __device__ __forceinline__ float H(int i, int j) const {
        return __ldg(h + (size_t)i * ny + j);
    }

    __device__ __forceinline__ void load(int i, int j, float* s) const {
        const float Hc = H(i, j);
        float Hx, Hy;
        if (i == nx - 1)
            Hx = __ldg(px + ny + j);
        else if (i == 0)
            Hx = __ldg(px + j);
        else
            Hx = (H(i + 1, j) - H(i - 1, j)) * rdx2;
        if (j == ny - 1)
            Hy = __ldg(py + nx + i);
        else if (j == 0)
            Hy = __ldg(py + i);
        else
            Hy = (H(i, j + 1) - H(i, j - 1)) * rdy2;
        const float Ls = __ldg(ls + (size_t)i * ny + j);
        const float ic = 1.f / (4.f * Ls + Hc);
        s[0] = Hx;
        s[1] = Hy;
        s[2] = Hc;
        s[3] = 2.f * Ls;
        s[4] = 1.f / Hc;
        s[5] = ic;
        s[6] = 2.f * (3.f * Ls + Hc) * ic * ic;
        s[7] = 6.f * Ls;
    }
};

template <int MODE>
__global__ void __launch_bounds__(TX * TY)
ehl_step_kernel(const float* __restrict__ q, const float* __restrict__ lo,
                EhlStatics S, float* __restrict__ out,
                float* __restrict__ lo_out, int d0, float dt, Params P) {
    step_tile<MODE>(q, lo, S, out, lo_out, S.nx, S.ny, blockIdx.y * TX,
                    blockIdx.x * TY, d0, dt, P);
}

}  // namespace

// C entry points (ctypes).  Device arrays, contiguous float32: q, lo, out,
// q_out, lo_out (3, nx, ny); h, ls (nx, ny); px (2, ny); py (2, nx).
// iprm/fprm as for gf_fused_step (host memory); rdx2 = 0.5/dx and
// rdy2 = 0.5/dy.  Each returns cudaGetLastError() after its launch.

extern "C" int gf_ehl_step(const float* q, const float* h, const float* ls,
                           const float* px, const float* py, float* out,
                           int nx, int ny, int d0, int emit_delta,
                           const int* iprm, const float* fprm, float rdx2,
                           float rdy2, float dt, void* stream) {
    const Params P = make_params(iprm, fprm);
    const EhlStatics S{h, ls, px, py, nx, ny, rdx2, rdy2};
    cudaStream_t s = (cudaStream_t)stream;
    if (emit_delta)
        ehl_step_kernel<DELTA><<<grid_for(nx, ny), dim3(TY, TX), 0, s>>>(
            q, nullptr, S, out, nullptr, d0, dt, P);
    else
        ehl_step_kernel<STATE><<<grid_for(nx, ny), dim3(TY, TX), 0, s>>>(
            q, nullptr, S, out, nullptr, d0, dt, P);
    return (int)cudaGetLastError();
}

extern "C" int gf_ehl_comp_step(const float* q, const float* lo,
                                const float* h, const float* ls,
                                const float* px, const float* py,
                                float* q_out, float* lo_out, int nx, int ny,
                                int d0, const int* iprm, const float* fprm,
                                float rdx2, float rdy2, float dt,
                                void* stream) {
    const Params P = make_params(iprm, fprm);
    const EhlStatics S{h, ls, px, py, nx, ny, rdx2, rdy2};
    ehl_step_kernel<COMP><<<grid_for(nx, ny), dim3(TY, TX), 0,
                            (cudaStream_t)stream>>>(q, lo, S, q_out, lo_out,
                                                    d0, dt, P);
    return (int)cudaGetLastError();
}
