// The shard kernels of a spatially decomposed run, for Hopper (sm_90a),
// float32: the k-step shard sweep of the sharded loops, and the one-step
// K9 that is its witness.
//
// Replace gapflow_tpu/ops/stencil.py _kernel_fused_bc_shard (K9): the
// per-shard step of the sharded loops of parallel/pallas_halo.py, on
// Dirichlet/Neumann edges (make_sharded_bc_pallas_loop) and, with every
// flag zero, on periodic edges (make_sharded_pallas_loop, where the TPU
// package ran K1 and, 4 steps per 8-deep exchange, its temporally blocked
// K2 on its wrap layout).
//
// gf_shard_sweep: k (1..4) steps of one shard in one launch, on the
// register sweep body (stencil_sweep.cuh, each cell's state and predictor
// in registers, fluxes by shuffles along y and a small plane between
// warps along x).  Input: the shard's block with a 2k-deep halo, q (3,
// bx+4k, by+4k), and its statics with an hs-deep halo (hs >= 2k), st (8,
// bx+2hs, by+2hs); the loops exchange the halo once per k steps.  A side
// on a domain edge the shard holds (flags xe, xw, yn, ys: X = -1, X =
// bx, Y = by, Y = -1) is a D/N edge of the body: its ghost ring is refilled
// in the sweep by the edge formulas after every pass and average (x edges
// first, then y, so a corner takes the y fill of the x fill), so it
// consumes no halo; every other side reads the block's halo, never
// wrapped, and the sweep consumes one cell of it a step.  Instances are
// compiled per axis that holds a domain edge (code for every edge at run
// time slowed the boundary sweeps, PERF.md).  Output: the new
// interior (3, bx, by).  The result equals k launches of gf_shard_step on
// the shrinking halo, the ghosts of the held edges rebuilt between them,
// bit for bit (ops/stencil.py shard_steps_once, shard_sweep_ref).
//
// gf_shard_step (one step, the witness): the block with a 2-deep halo, q
// (3, bx+4, by+4), and its statics st (8, bx+4, by+4).  The halo was
// filled by the caller: from the mesh neighbours, or on a shard that
// holds a domain edge with the ghost value of that edge (2 val -
// adjacent, or adjacent), duplicated to the halo's depth.  The kernel
//   1. evaluates pass d0 on the tile plus a 1-cell ring, which reaches the
//      halo's outer cells;
//   2. refills the ring cells on each domain edge the shard holds from the
//      predictor of the adjacent interior line, x edges first and then y
//      edges, so a corner takes the y fill of the x fill, as apply_bcs
//      does; every other ring cell keeps its pass-d0 value, which equals
//      the neighbour's (the 2-deep halo makes it exact);
//   3. evaluates pass d1 on the tile and writes the average with the input.
// Every cell's arithmetic is K1's (zero flags) or K3's (stencil_bc.cu) in
// their order: the sharded routes equal the serial ones bit for bit.
//
// Layout: the TPU kernel's wrap layout ([interior | E1 E2 | pad | W2 W1]
// on a 128-aligned width, and an 8-row alignment halo) served the TPU's
// lane roll; here the block is the natural halo block, the one-step
// kernel cut into 8 x 32 tiles as K1, the sweep into (32 - 2k)^2 tiles of
// 32 x 32 windows, with the flags passed by value as kernel arguments.
//
// What bounds them: the one-step kernel memory bytes, as K1 and K3: 3 + 8
// floats read and 3 written per cell, against about 300 float
// operations.  The sweep moves those bytes once per k steps, so its
// bound is the FP32 work (stencil_sweep.cuh).
//
// Build: see stencil.cu and ops/_build.py (same flags, --fmad=false).

#include "stencil_sweep.cuh"
#include "stencil_tile.cuh"

namespace {

__global__ void __launch_bounds__(TX * TY)
shard_step_kernel(const float* __restrict__ q, const float* __restrict__ st,
                  float* __restrict__ out, int bx, int by, int d0, float dt,
                  Params P, Bc bc, int xe, int xw, int yn, int ys) {
    __shared__ float qL[3][LX][LY];        // q on the loaded region
    __shared__ float fL[5][LX][LY];        // pass-d0 fluxes
    __shared__ float sR[3][RX][RY];        // pass-d0 sources (ring region)
    __shared__ float aR[3][RX][RY];        // predictor q*, then refilled
    __shared__ float fR[5][RX][RY];        // pass-d1 fluxes
    __shared__ float s1R[3][RX][RY];       // pass-d1 sources

    const int hx = bx + 4, hy = by + 4;    // the halo block
    const size_t plane = (size_t)hx * hy;
    const int x0 = blockIdx.y * TX, y0 = blockIdx.x * TY;
    const int tid = threadIdx.y * TY + threadIdx.x;
    const int nthreads = TX * TY;
    const int d1 = -d0;
    // the statics of halo-block row i, column j (dead cells clamped)
    auto load_st = [&](int i, int j, float* s) {
        const size_t g = (size_t)min(i, hx - 1) * hy + min(j, hy - 1);
#pragma unroll
        for (int c = 0; c < N_STATIC; ++c) s[c] = __ldg(st + c * plane + g);
    };

    // 1a. pass d0 closures on the tile + 2-cell halo: interior cell X is
    // halo-block row X + 2, so the loaded region starts at row x0
    for (int k = tid; k < LX * LY; k += nthreads) {
        const int li = k / LY, lj = k % LY;
        const size_t g = (size_t)min(x0 + li, hx - 1) * hy
            + min(y0 + lj, hy - 1);
        float s[N_STATIC];
        load_st(x0 + li, y0 + lj, s);
        const float a = __ldg(q + g), b = __ldg(q + plane + g),
                    cc = __ldg(q + 2 * plane + g);
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

    // 1b. predictor q* on the tile + 1-cell ring
    for (int k = tid; k < RX * RY; k += nthreads) {
        const int ri = k / RY, rj = k % RY;
        const float S[3] = {sR[0][ri][rj], sR[1][ri][rj], sR[2][ri][rj]};
        float u[3];
        update<LX, LY>(fL, S, ri + 1, rj + 1, d0, dt, P, u);
#pragma unroll
        for (int c = 0; c < 3; ++c) aR[c][ri][rj] = qL[c][ri + 1][rj + 1] - u[c];
    }
    __syncthreads();

    // 2. refill the ring cells on the domain edges this shard holds.  A
    // refilled cell reads the predictor of its source cell (the adjacent
    // interior line on each refilled axis), which is never itself a
    // refilled cell, so the refill needs no further barrier.
    for (int k = tid; k < RX * RY; k += nthreads) {
        const int ri = k / RY, rj = k % RY;
        const int X = x0 - 1 + ri, Y = y0 - 1 + rj;
        const bool gxe = xe && X == -1, gxw = xw && X == bx;
        const bool gys = ys && Y == -1, gyn = yn && Y == by;
        if (!(gxe || gxw || gys || gyn)) continue;
        const int si = gxe ? ri + 1 : (gxw ? ri - 1 : ri);
        const int sj = gys ? rj + 1 : (gyn ? rj - 1 : rj);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            float v = aR[c][si][sj];
            if (gxe || gxw) {
                const int e = gxe ? 0 : 1;
                v = fill(code(bc, e, c), twoval(bc, e), v);
            }
            if (gys || gyn) {
                const int e = gys ? 2 : 3;
                v = fill(code(bc, e, c), twoval(bc, e), v);
            }
            aR[c][ri][rj] = v;
        }
    }
    __syncthreads();

    // 3a. pass d1 closures on the tile + 1-cell ring
    for (int k = tid; k < RX * RY; k += nthreads) {
        const int ri = k / RY, rj = k % RY;
        float s[N_STATIC];
        load_st(x0 + ri + 1, y0 + rj + 1, s);
        const CellFlux f = closures(aR[0][ri][rj], aR[1][ri][rj],
                                    aR[2][ri][rj], s, P);
#pragma unroll
        for (int c = 0; c < 5; ++c) fR[c][ri][rj] = f.f[c];
#pragma unroll
        for (int c = 0; c < 3; ++c) s1R[c][ri][rj] = f.s[c];
    }
    __syncthreads();

    // 3b. pass d1 update and temporal average on the tile
    const int ti = threadIdx.y, tj = threadIdx.x;
    const int X = x0 + ti, Y = y0 + tj;
    if (X >= bx || Y >= by) return;
    const int ri = ti + 1, rj = tj + 1;
    const float S[3] = {s1R[0][ri][rj], s1R[1][ri][rj], s1R[2][ri][rj]};
    float u[3];
    update<RX, RY>(fR, S, ri, rj, d1, dt, P, u);
    const size_t o = (size_t)X * by + Y;
    const size_t oplane = (size_t)bx * by;
#pragma unroll
    for (int c = 0; c < 3; ++c)
        out[c * oplane + o] = ((aR[c][ri][rj] - u[c]) + qL[c][ti + 2][tj + 2])
            / 2.f;
}

using SG = SweepGeo<false>;
// blocks a SM the shard sweep is compiled for: two (64 registers) where
// the shard holds no domain edge; one (128 registers) where it holds
// one, whose edge code spilled 88-316 bytes at 64 registers and took
// twice the periodic instance's time (PERF.md)
template <bool PX, bool PY>
constexpr int shard_blocks_per_sm() { return PX && PY ? 2 : 1; }

// k steps of the shard's tile (blockIdx.y, blockIdx.x); PX, PY: the shard
// holds no domain edge on that axis (see sweep_body).
template <bool PX, bool PY>
__global__ void __launch_bounds__(SG::THREADS,
                                  shard_blocks_per_sm<PX, PY>())
shard_sweep_kernel(const float* __restrict__ q, const float* __restrict__ st,
                   float* __restrict__ out, int bx, int by, int k, int d0,
                   float dt, Params P, Bc bc, Thin T, Shard sh) {
    const int sw = by + 2 * sh.hs;
    const ArrayStat S{st, (size_t)(bx + 2 * sh.hs) * sw, sw};
    sweep_body<true, PX, PY, false, STATE, true>(q, S, out, nullptr, nullptr,
                                                 bx, by, k, d0, dt, P, bc, T,
                                                 sh);
}

template <bool PX, bool PY>
void launch_shard_sweep(const float* q, const float* st, float* out, int bx,
                        int by, int k, int d0, float dt, const Params& P,
                        const Bc& bc, const Thin& T, const Shard& sh,
                        void* s) {
    shard_sweep_kernel<PX, PY><<<SG::grid(bx, by, k), SG::THREADS, 0,
                                 (cudaStream_t)s>>>(q, st, out, bx, by, k,
                                                    d0, dt, P, bc, T, sh);
}

}  // namespace

// C entry points (ctypes).

// k (1..4) steps of one shard.  Device arrays, contiguous float32: q (3,
// bx+2hq, by+2hq), st (8, bx+2hs, by+2hs), out (3, bx, by), with hq and hs
// at least k (the loops pass hq = 2k).  iprm/fprm as for gf_fused_step,
// bprm/bfprm as for make_bc (the thinning fields unused): host memory.
// xe, xw, yn, ys: 1 where the shard holds that domain edge and the edge
// is not periodic.  Returns cudaErrorInvalidValue for a depth or block it
// does not take, else cudaGetLastError() after the launch.
extern "C" int gf_shard_sweep(const float* q, const float* st, float* out,
                              int bx, int by, int k, int hq, int hs, int d0,
                              const int* iprm, const float* fprm,
                              const int* bprm, const float* bfprm, int xe,
                              int xw, int yn, int ys, float dt,
                              void* stream) {
    if (k < 1 || k > SG::KMAX || hq < k || hs < k || bx < 1 || by < 1)
        return (int)cudaErrorInvalidValue;
    const Params P = make_params(iprm, fprm);
    Bc bc;
    Thin T;
    make_bc(bprm, bfprm, &bc, &T);
    const Shard sh{hq, hs, xe, xw, yn, ys};
    const bool px = !(xe || xw), py = !(yn || ys);
    auto launch = px ? (py ? launch_shard_sweep<true, true>
                           : launch_shard_sweep<true, false>)
                     : (py ? launch_shard_sweep<false, true>
                           : launch_shard_sweep<false, false>);
    launch(q, st, out, bx, by, k, d0, dt, P, bc, T, sh, stream);
    return (int)cudaGetLastError();
}

// One step of one shard.  Device arrays, contiguous float32: q (3, bx+4,
// by+4), st (8, bx+4, by+4), out (3, bx, by).  iprm/fprm as for
// gf_fused_step, bprm/bfprm as for make_bc (the thinning fields unused):
// host memory.  xe, xw, yn, ys: 1 where the shard holds that domain edge
// and the edge is not periodic.  Returns cudaGetLastError() after the
// launch.
extern "C" int gf_shard_step(const float* q, const float* st, float* out,
                             int bx, int by, int d0, const int* iprm,
                             const float* fprm, const int* bprm,
                             const float* bfprm, int xe, int xw, int yn,
                             int ys, float dt, void* stream) {
    const Params P = make_params(iprm, fprm);
    Bc bc;
    Thin T;
    make_bc(bprm, bfprm, &bc, &T);
    shard_step_kernel<<<grid_for(bx, by), dim3(TY, TX), 0,
                        (cudaStream_t)stream>>>(q, st, out, bx, by, d0, dt,
                                                P, bc, xe, xw, yn, ys);
    return (int)cudaGetLastError();
}
