// Fused periodic EHL step for Hopper (sm_90a), float32: one MacCormack
// step on the register sweep body (stencil_sweep.cuh, one step deep), with
// the eight static channels formed in-kernel from the undeformed gap and
// the deformation, instead of read from a precomputed (8, nx, ny) array.
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
// hoisted out of the time loop, nor the step blocked in time.  The kernel
// reads the ghost-inclusive undeformed gap h_und and deformation u, both
// (nx+2, ny+2), and the interior slip length Ls (nx, ny), and forms each
// cell's statics where the body needs them:
//   H(i, j) = h_und(i, j) + (u(i, j) - u(0, 0)) with shift_ref (the
//             half-space's reference shift), else h_und + u: the torch
//             ops of the loop (core/ehl.py), in their order;
//   Hx = (H[i+1] - H[i-1]) * (0.5/dx), over ghost-inclusive neighbours, so
//        interior rows 0 and nx-1 reach the ghost ring (np.gradient over
//        the ghost-inclusive gap: a non-periodic gap on periodic edges);
//   Hy likewise along y;
//   ic = 1/(4 Ls + H);  (Hx, Hy, H, 2 Ls, 1/H, ic, 2 (3 Ls + H) ic^2, 6 Ls),
// the layout of models/closures_opt.py precompute_statics and the order of
// ops/stencil.py ehl_statics_ref.  The state's window wraps on both axes
// (periodic edges); the gap's differences never wrap.
//
// What bounds it: memory bytes.  Per cell and step the compensated form
// reads 6 floats of carry plus h_und, u and Ls and writes 6 (the plain
// forms 3 + 3 in, 3 out), against ~315 FP32 operations, far below the
// card's balance.  The statics are formed on the window (1.14x the cells
// a step at a 30 x 30 tile), five gap values a cell, from L1/L2, once a
// step: EHL_KEEP forms a thread's cells' statics before the passes and
// holds them in shared memory (32 KB a block) for both.  Forming them
// again in each pass, their loads and two IEEE divisions in front of
// each flux, and holding them in registers (16 more a thread, more
// spills) were slower (PERF.md).
//
// Build: see stencil.cu and ops/_build.py (--fmad=false, IEEE division,
// no --use_fast_math), so that kernel and plain twin round op for op.

#include "stencil_sweep.cuh"

namespace {

// the statics formed once and held in shared memory (see above)
constexpr bool EHL_KEEP = true;

// Statics of a wrapped interior cell (i, j) from the ghost-inclusive
// undeformed gap hu and deformation u (nx+2, ny+2) and the interior slip
// length ls (nx, ny).
struct EhlStat {
    const float* hu;
    const float* u;
    const float* ls;
    int nx, ny, shift;
    float rdx2, rdy2;
    float u00;                  // u(0, 0) with shift_ref, else 0

    // u - 0 is u exactly, so one formula covers both protocols
    __device__ __forceinline__ void begin() { u00 = shift ? __ldg(u) : 0.f; }

    // H at ghost-inclusive (a, b)
    __device__ __forceinline__ float H(int a, int b) const {
        const size_t o = (size_t)a * (ny + 2) + b;
        return __ldg(hu + o) + (__ldg(u + o) - u00);
    }

    __device__ __forceinline__ void load(int i, int j, float* s) const {
        const float Hc = H(i + 1, j + 1);
        const float Hx = (H(i + 2, j + 1) - H(i, j + 1)) * rdx2;
        const float Hy = (H(i + 1, j + 2) - H(i + 1, j)) * rdy2;
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

using EG = SweepGeo<false>;
// blocks a SM the EHL kernel is compiled for (registers: 64 at 2)
constexpr int EHL_BLOCKS_PER_SM = 2;

template <int MODE>
__global__ void __launch_bounds__(EG::THREADS, EHL_BLOCKS_PER_SM)
ehl_sweep_kernel(const float* __restrict__ q, const float* __restrict__ lo,
                 EhlStat S, float* __restrict__ out,
                 float* __restrict__ lo_out, int d0, float dt, Params P) {
    sweep_body<false, true, true, false, MODE, false, EHL_KEEP>(
        q, S, out, lo, lo_out, S.nx, S.ny, 1, d0, dt, P, Bc{}, Thin{},
        Shard{});
}

template <int MODE>
int launch_ehl(const float* q, const float* lo, const EhlStat& S,
               float* out, float* lo_out, int d0, float dt, const Params& P,
               void* stream) {
    ehl_sweep_kernel<MODE><<<EG::grid(S.nx, S.ny, 1), EG::THREADS, 0,
                             (cudaStream_t)stream>>>(q, lo, S, out, lo_out,
                                                     d0, dt, P);
    return (int)cudaGetLastError();
}

}  // namespace

// C entry points (ctypes).  Device arrays, contiguous float32: q, lo, out,
// q_out, lo_out (3, nx, ny); hu, u (nx+2, ny+2); ls (nx, ny).  shift: 1
// where the deformation is taken relative to u(0, 0).  iprm/fprm as for
// gf_fused_step (host memory); rdx2 = 0.5/dx and rdy2 = 0.5/dy.  Each
// returns cudaGetLastError() after its launch.

extern "C" int gf_ehl_step(const float* q, const float* hu, const float* u,
                           const float* ls, float* out, int nx, int ny,
                           int shift, int d0, int emit_delta,
                           const int* iprm, const float* fprm, float rdx2,
                           float rdy2, float dt, void* stream) {
    const Params P = make_params(iprm, fprm);
    const EhlStat S{hu, u, ls, nx, ny, shift, rdx2, rdy2, 0.f};
    return emit_delta
        ? launch_ehl<DELTA>(q, nullptr, S, out, nullptr, d0, dt, P, stream)
        : launch_ehl<STATE>(q, nullptr, S, out, nullptr, d0, dt, P, stream);
}

extern "C" int gf_ehl_comp_step(const float* q, const float* lo,
                                const float* hu, const float* u,
                                const float* ls, float* q_out,
                                float* lo_out, int nx, int ny, int shift,
                                int d0, const int* iprm, const float* fprm,
                                float rdx2, float rdy2, float dt,
                                void* stream) {
    const Params P = make_params(iprm, fprm);
    const EhlStat S{hu, u, ls, nx, ny, shift, rdx2, rdy2, 0.f};
    return launch_ehl<COMP>(q, lo, S, q_out, lo_out, d0, dt, P, stream);
}
