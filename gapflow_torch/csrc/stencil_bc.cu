// MacCormack step on Dirichlet/Neumann, shear-thinning and mixed P/D/N
// edges for Hopper (sm_90a), float32.
//
// Replaces three Pallas TPU kernels of gapflow_tpu/ops:
//   - gf_fused_step_bc <- stencil.py _kernel_fused_bc: one step on the
//     interior state with in-kernel ghost refills between the passes,
//     writing the new state;
//   - gf_comp_step_bc: one Kahan-compensated step on the interior
//     (q, q_lo) carry, the ghosts rebuilt from the interior every step:
//     the witness of gf_comp_sweeps_bc below (no main path launches it);
//   - gf_mixed_step    <- mixed_bc.py _kernel_fused_bc_mixed: one step on
//     the ghost-inclusive state of a mixed-edge run, whose periodic
//     components on a mixed edge take given pass-1 ghost lines.
// One template body serves all three.  Three more entries run the k-step
// sweeps on this file's edge codes:
//   - gf_plain_sweeps_bc <- stencil.py _kernel_fused_bc_hbm with nch = 3
//     (K3p): n plain steps in one C call, sweeps of k (ops/stencil.py
//     _plain_k_steps; at most 4, or 2 with shear thinning) and one of
//     n mod k, temporally blocked on chip with each cell's values in
//     registers (stencil_sweep.cuh), the ghosts refilled after every pass
//     and every average; gf_plain_steps_bc is one such sweep;
//   - gf_comp_sweeps_bc <- stencil.py _kernel_fused_bc_hbm with nch = 6
//     (K3c): n Kahan-compensated steps on the interior (q, q_lo) carry in
//     one C call, sweeps of k steps (ops/stencil.py _comp_k_steps on the
//     main path; at most 4, or 2 with shear thinning) and one of n mod
//     k, on the same register body with the carry in registers, equal
//     bit for bit to n launches of gf_comp_step_bc.
//
// Coordinates are ghost-inclusive: X in [-1, nx], Y in [-1, ny], with the
// ghost rows X = -1, nx and ghost columns Y = -1, ny of the reference
// scheme (core.step).  Each edge (xE at X = -1, xW at X = nx, yS at
// Y = -1, yN at Y = ny) gives each component a code: P (wrap), D
// (2 val - adjacent), N (adjacent) or G (a given ghost line, mixed edges
// only).  An axis is either periodic on both edges or has no P code.
// Ghosts are filled x edges first, then y edges, so a corner takes the
// y fill of the x ghost row, as apply_bcs does.
//
// A block owns an 8 x 32 tile of interior cells:
//   A. loads the pass-1 state on the tile plus a halo of H cells (ghost
//      values from the codes, or read from the ghost-inclusive input);
//      cells beyond the ghosts are dead and never reach an output;
//   B. evaluates pass d0 on the tile plus a ring of R cells in shared
//      memory (predictor q*), at interior cells only;
//   C. refills the ring's ghost slots from q* of the adjacent interior (D,
//      N), of the far edge (P: outside the tile, so recomputed from device
//      memory by pred_direct) or from the given lines (G);
//   D. evaluates pass d1 on the tile and writes the average, increment or
//      compensated carry.
// Without shear thinning R = 1, H = 2, as in K1.  With it the viscosity
// reads the pressure at +-1 (np.gradient of the ghost-inclusive pressure:
// centred inside, one-sided at a ghost slot, whether its value is a
// wrap or a D/N fill), so R = 2 and H = 4.
//
// What bounds the one-step kernels: memory bytes, as K1 (3 + 8 floats
// read, 3 written per cell; 6 and 6 with the Kahan carry).  The ghost
// refills are perimeter work; a block on a periodic edge recomputes the
// far q* line it needs.
//
// Build: see stencil.cu and ops/_build.py (same flags, --fmad=false).

#include "stencil_common.cuh"
#include "stencil_sweep.cuh"

namespace {

// Device arrays and shape.  q: (3, nx, ny) interior, or (3, nx+2, ny+2)
// ghost-inclusive when the template's GIN is set.  st: (8, nx+2, ny+2)
// ghost-inclusive statics.  gx: (3, 2, ny+2) pass-1 x ghost rows, gy:
// (3, 2, nx+2) pass-1 y ghost columns (G codes only).
struct Ctx {
    const float* q;
    const float* st;
    const float* gx;
    const float* gy;
    int nx, ny;
    bool per_x, per_y;
};

struct V3 {
    float v[3];
};

__device__ __forceinline__ void load_st(const Ctx& g, int X, int Y,
                                        float s[N_STATIC]) {
    const size_t plane = (size_t)(g.nx + 2) * (g.ny + 2);
    const size_t k = (size_t)(X + 1) * (g.ny + 2) + (Y + 1);
#pragma unroll
    for (int c = 0; c < N_STATIC; ++c) s[c] = g.st[c * plane + k];
}

__device__ __forceinline__ V3 load_int(const Ctx& g, int X, int Y) {
    const size_t plane = (size_t)g.nx * g.ny;
    const size_t k = (size_t)X * g.ny + Y;
    return {{g.q[k], g.q[plane + k], g.q[2 * plane + k]}};
}

// Pass-1 state at a ghost-inclusive cell.
template <bool GIN>
__device__ V3 q_in(const Ctx& g, const Bc& bc, int X, int Y) {
    const int nx = g.nx, ny = g.ny;
    if (GIN) {
        const size_t plane = (size_t)(nx + 2) * (ny + 2);
        const size_t k = (size_t)(X + 1) * (ny + 2) + (Y + 1);
        return {{g.q[k], g.q[plane + k], g.q[2 * plane + k]}};
    }
    const bool ygh = Y < 0 || Y >= ny;
    const int Yi = !ygh ? Y : (g.per_y ? (Y < 0 ? ny - 1 : 0)
                                       : (Y < 0 ? 0 : ny - 1));
    V3 a;
    if (X < 0 || X >= nx) {
        const int e = X < 0 ? 0 : 1;
        const int Xi = g.per_x ? (X < 0 ? nx - 1 : 0) : (X < 0 ? 0 : nx - 1);
        const V3 b = load_int(g, Xi, Yi);
#pragma unroll
        for (int c = 0; c < 3; ++c)
            a.v[c] = fill(code(bc, e, c), twoval(bc, e), b.v[c]);
    } else {
        a = load_int(g, X, Yi);
    }
    if (ygh) {
        const int e = Y < 0 ? 2 : 3;
#pragma unroll
        for (int c = 0; c < 3; ++c)
            a.v[c] = fill(code(bc, e, c), twoval(bc, e), a.v[c]);
    }
    return a;
}

// Pass-1 fluxes and sources at a ghost-inclusive cell, from device memory.
template <bool GIN, bool THIN>
__device__ CellFlux flux_at(const Ctx& g, const Bc& bc, int X, int Y,
                            const Params& P, const Thin& T) {
    const V3 a = q_in<GIN>(g, bc, X, Y);
    float s[N_STATIC];
    load_st(g, X, Y, s);
    const float p = eos_pressure(a.v[0], P);
    float eta = shear_viscosity(a.v[0], p, P);
    if (THIN) {
        auto pr = [&](int i, int j) {
            return eos_pressure(q_in<GIN>(g, bc, i, j).v[0], P);
        };
        const float pxm = X > -1 ? pr(X - 1, Y) : 0.f;
        const float pxp = X < g.nx ? pr(X + 1, Y) : 0.f;
        const float pym = Y > -1 ? pr(X, Y - 1) : 0.f;
        const float pyp = Y < g.ny ? pr(X, Y + 1) : 0.f;
        eta = thinning_eta(grad(X, g.nx, pxm, p, pxp, T.dx),
                           grad(Y, g.ny, pym, p, pyp, T.dy), s[2], eta, T);
    }
    return closures_eta(a.v[0], a.v[1], a.v[2], s, p, eta, P);
}

// Predictor q* of pass d0 at one interior cell, from device memory (the
// far-edge line a periodic ghost refill needs).  Inlined: a call would
// pass the parameter blocks by reference, through a local-memory copy
// in every thread.
template <bool GIN, bool THIN>
__device__ __forceinline__ V3 pred_direct(const Ctx& g, const Bc& bc, int X,
                                       int Y, int d0, float dt,
                                       const Params& P, const Thin& T) {
    const CellFlux f = flux_at<GIN, THIN>(g, bc, X, Y, P, T);
    const CellFlux fx = flux_at<GIN, THIN>(g, bc, X - d0, Y, P, T);
    const CellFlux fy = flux_at<GIN, THIN>(g, bc, X, Y - d0, P, T);
    const V3 a = q_in<GIN>(g, bc, X, Y);
    const float md = (float)(-d0);
    auto ddx = [&](int k) { return md * (fx.f[k] - f.f[k]) * P.rdx; };
    auto ddy = [&](int k) { return md * (fy.f[k] - f.f[k]) * P.rdy; };
    V3 out;
    out.v[0] = a.v[0] - dt * (ddx(0) + ddy(1) - f.s[0]);
    out.v[1] = a.v[1] - dt * (ddx(2) + ddy(3) - f.s[1]);
    out.v[2] = a.v[2] - dt * (ddx(3) + ddy(4) - f.s[2]);
    return out;
}

// u = dt * (ddx(Fx) + ddy(Fy) - S) at cell k of a [5][n] flux array with
// rows of width w, one-sided: ddx(F)[i] = -d * (F[i-d] - F[i]) * rdx.
__device__ __forceinline__ void update(const float* F, int n, int w,
                                       const float* S, int ns, int k, int ks,
                                       int d, float dt, const Params& P,
                                       float u[3]) {
    const float md = (float)(-d);
    auto ddx = [&](int c) {
        return md * (F[c * n + k - d * w] - F[c * n + k]) * P.rdx;
    };
    auto ddy = [&](int c) {
        return md * (F[c * n + k - d] - F[c * n + k]) * P.rdy;
    };
    u[0] = dt * (ddx(0) + ddy(1) - S[ks]);
    u[1] = dt * (ddx(2) + ddy(3) - S[ns + ks]);
    u[2] = dt * (ddx(3) + ddy(4) - S[2 * ns + ks]);
}

// Shared-memory regions, in floats.  L: loaded (tile + H), R: pass-d0
// (tile + R), S: pass-d1 fluxes (tile + 1).  Stage 2 (pR, f1, s1) reuses
// stage 1's pL and fL, dead by then.
template <bool THIN>
struct Geo {
    static constexpr int R = THIN ? 2 : 1, H = 2 * R;
    static constexpr int LX = TX + 2 * H, LY = TY + 2 * H, NL = LX * LY;
    static constexpr int RX = TX + 2 * R, RY = TY + 2 * R, NR = RX * RY;
    static constexpr int SX = TX + 2, SY = TY + 2, NS = SX * SY;
    static constexpr int STAGE1 = (THIN ? 6 : 5) * NL;
    static constexpr int STAGE2 = (THIN ? NR : 0) + 8 * NS;
    static constexpr int UNION = STAGE1 > STAGE2 ? STAGE1 : STAGE2;
    static constexpr int OFF_U = 3 * NL, OFF_S = OFF_U + UNION;
    static constexpr int OFF_A = OFF_S + 3 * NR, TOTAL = OFF_A + 3 * NR;
};

// Whether every component of edge e takes a given line (no adjacent
// interior value is needed).
__device__ __forceinline__ bool all_given(const Bc& bc, int e) {
    return code(bc, e, 0) == CG && code(bc, e, 1) == CG
        && code(bc, e, 2) == CG;
}

__device__ __forceinline__ int clampi(int i, int lo, int hi) {
    return i < lo ? lo : (i > hi ? hi : i);
}

template <bool GIN, bool THIN, int MODE>
__global__ void __launch_bounds__(TX * TY)
bc_step_kernel(Ctx g, Bc bc, Params P, Thin T, const float* __restrict__ lo,
               float* __restrict__ out, float* __restrict__ lo_out, int d0,
               float dt) {
    using G = Geo<THIN>;
    constexpr int R = G::R, H = G::H, LY = G::LY, NL = G::NL;
    constexpr int RY = G::RY, NR = G::NR, SY = G::SY, NS = G::NS;
    __shared__ float sm[G::TOTAL];
    float* qL = sm;                           // [3][NL] pass-1 state
    float* pL = sm + G::OFF_U;                // [NL]    pass-1 pressure (THIN)
    float* fL = pL + (THIN ? NL : 0);         // [5][NL] pass-d0 fluxes
    float* sR = sm + G::OFF_S;                // [3][NR] pass-d0 sources
    float* aR = sm + G::OFF_A;                // [3][NR] q*, then refilled
    float* pR = sm + G::OFF_U;                // [NR]    pass-2 pressure (THIN)
    float* f1 = pR + (THIN ? NR : 0);         // [5][NS] pass-d1 fluxes
    float* s1 = f1 + 5 * NS;                  // [3][NS] pass-d1 sources

    const int nx = g.nx, ny = g.ny;
    const int x0 = blockIdx.y * TX, y0 = blockIdx.x * TY;
    const int tid = threadIdx.y * TY + threadIdx.x;
    constexpr int NT = TX * TY;
    auto interior = [&](int X, int Y) {
        return X >= 0 && X < nx && Y >= 0 && Y < ny;
    };

    // A: pass-1 state on the loaded region (dead cells clamped)
    for (int k = tid; k < NL; k += NT) {
        const int li = k / LY, lj = k % LY;
        const int X = clampi(x0 - H + li, -1, nx);
        const int Y = clampi(y0 - H + lj, -1, ny);
        const V3 a = q_in<GIN>(g, bc, X, Y);
#pragma unroll
        for (int c = 0; c < 3; ++c) qL[c * NL + k] = a.v[c];
        if (THIN) {
            pL[k] = eos_pressure(a.v[0], P);
        } else {
            float s[N_STATIC];
            load_st(g, X, Y, s);
            const CellFlux f = closures(a.v[0], a.v[1], a.v[2], s, P);
#pragma unroll
            for (int c = 0; c < 5; ++c) fL[c * NL + k] = f.f[c];
            const int ri = li - (H - R), rj = lj - (H - R);
            if (ri >= 0 && ri < G::RX && rj >= 0 && rj < RY) {
#pragma unroll
                for (int c = 0; c < 3; ++c) sR[c * NR + ri * RY + rj] = f.s[c];
            }
        }
    }
    __syncthreads();

    if (THIN) {
        // A': thinning viscosity and pass-d0 fluxes inside the outer ring
        for (int k = tid; k < NL; k += NT) {
            const int li = k / LY, lj = k % LY;
            if (li == 0 || li == G::LX - 1 || lj == 0 || lj == LY - 1) continue;
            const int Xr = x0 - H + li, Yr = y0 - H + lj;
            const int X = clampi(Xr, -1, nx), Y = clampi(Yr, -1, ny);
            float s[N_STATIC];
            load_st(g, X, Y, s);
            const float q0 = qL[k], p = pL[k];
            const float mu0 = shear_viscosity(q0, p, P);
            const float eta = thinning_eta(
                grad(Xr, nx, pL[k - LY], p, pL[k + LY], T.dx),
                grad(Yr, ny, pL[k - 1], p, pL[k + 1], T.dy), s[2], mu0, T);
            const CellFlux f = closures_eta(q0, qL[NL + k], qL[2 * NL + k],
                                            s, p, eta, P);
#pragma unroll
            for (int c = 0; c < 5; ++c) fL[c * NL + k] = f.f[c];
            const int ri = li - (H - R), rj = lj - (H - R);
            if (ri >= 0 && ri < G::RX && rj >= 0 && rj < RY) {
#pragma unroll
                for (int c = 0; c < 3; ++c) sR[c * NR + ri * RY + rj] = f.s[c];
            }
        }
        __syncthreads();
    }

    // B: predictor q* at the interior cells of the pass-d0 region
    for (int k = tid; k < NR; k += NT) {
        const int ri = k / RY, rj = k % RY;
        const int kl = (ri + H - R) * LY + (rj + H - R);
        if (interior(x0 - R + ri, y0 - R + rj)) {
            float u[3];
            update(fL, NL, LY, sR, NR, kl, k, d0, dt, P, u);
#pragma unroll
            for (int c = 0; c < 3; ++c) aR[c * NR + k] = qL[c * NL + kl] - u[c];
        } else {
#pragma unroll
            for (int c = 0; c < 3; ++c) aR[c * NR + k] = qL[c * NL + kl];
        }
    }
    __syncthreads();

    // C: refill the ghost slots of the pass-d0 region (x edges, then y)
    auto pred3 = [&](int X, int Y) -> V3 {
        const int ri = X - (x0 - R), rj = Y - (y0 - R);
        if (ri >= 0 && ri < G::RX && rj >= 0 && rj < RY) {
            const int k = ri * RY + rj;
            return {{aR[k], aR[NR + k], aR[2 * NR + k]}};
        }
        return pred_direct<GIN, THIN>(g, bc, X, Y, d0, dt, P, T);
    };
    auto x_fill = [&](int X, int Y) -> V3 {      // X ghost, Y interior
        const int e = X < 0 ? 0 : 1;
        V3 a = {{0.f, 0.f, 0.f}};
        if (!all_given(bc, e))
            a = pred3(g.per_x ? (X < 0 ? nx - 1 : 0) : (X < 0 ? 0 : nx - 1),
                      Y);
#pragma unroll
        for (int c = 0; c < 3; ++c)
            a.v[c] = code(bc, e, c) == CG
                ? g.gx[(c * 2 + e) * (ny + 2) + Y + 1]
                : fill(code(bc, e, c), twoval(bc, e), a.v[c]);
        return a;
    };
    for (int k = tid; k < NR; k += NT) {
        const int X = x0 - R + k / RY, Y = y0 - R + k % RY;
        if (X < -1 || X > nx || Y < -1 || Y > ny || interior(X, Y)) continue;
        const bool xgh = X < 0 || X >= nx;
        V3 a;
        if (Y < 0 || Y >= ny) {
            const int e = Y < 0 ? 2 : 3;
            const int Yi = g.per_y ? (Y < 0 ? ny - 1 : 0)
                                   : (Y < 0 ? 0 : ny - 1);
            a = {{0.f, 0.f, 0.f}};
            if (!all_given(bc, e))
                a = xgh ? x_fill(X, Yi) : pred3(X, Yi);
#pragma unroll
            for (int c = 0; c < 3; ++c)
                a.v[c] = code(bc, e, c) == CG
                    ? g.gy[(c * 2 + e - 2) * (nx + 2) + X + 1]
                    : fill(code(bc, e, c), twoval(bc, e), a.v[c]);
        } else {
            a = x_fill(X, Y);
        }
#pragma unroll
        for (int c = 0; c < 3; ++c) aR[c * NR + k] = a.v[c];
    }
    __syncthreads();

    // D: pass-d1 fluxes on the tile + 1 ring, then the tile's update
    if (THIN) {
        for (int k = tid; k < NR; k += NT) pR[k] = eos_pressure(aR[k], P);
        __syncthreads();
    }
    for (int k = tid; k < NS; k += NT) {
        const int si = k / SY, sj = k % SY;
        const int kr = (si + R - 1) * RY + (sj + R - 1);
        const int Xr = x0 - 1 + si, Yr = y0 - 1 + sj;
        float s[N_STATIC];
        load_st(g, clampi(Xr, -1, nx), clampi(Yr, -1, ny), s);
        const float a = aR[kr], b = aR[NR + kr], cc = aR[2 * NR + kr];
        CellFlux f;
        if (THIN) {
            const float p = pR[kr];
            const float eta = thinning_eta(
                grad(Xr, nx, pR[kr - RY], p, pR[kr + RY], T.dx),
                grad(Yr, ny, pR[kr - 1], p, pR[kr + 1], T.dy), s[2],
                shear_viscosity(a, p, P), T);
            f = closures_eta(a, b, cc, s, p, eta, P);
        } else {
            f = closures(a, b, cc, s, P);
        }
#pragma unroll
        for (int c = 0; c < 5; ++c) f1[c * NS + k] = f.f[c];
#pragma unroll
        for (int c = 0; c < 3; ++c) s1[c * NS + k] = f.s[c];
    }
    __syncthreads();

    const int ti = threadIdx.y, tj = threadIdx.x;
    const int X = x0 + ti, Y = y0 + tj;
    if (X >= nx || Y >= ny) return;
    const int ks = (ti + 1) * SY + (tj + 1);
    float u[3];
    update(f1, NS, SY, s1, NS, ks, ks, -d0, dt, P, u);
    const int kl = (ti + H) * LY + (tj + H);
    const int kr = (ti + R) * RY + (tj + R);
    const size_t plane = (size_t)nx * ny;
    const size_t o = (size_t)X * ny + Y;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        const float q0 = qL[c * NL + kl];
        const float pred = aR[c * NR + kr];
        if (MODE == STATE) {
            out[c * plane + o] = ((pred - u[c]) + q0) / 2.f;
        } else {
            const float delta = ((pred - q0) - u[c]) / 2.f;
            if (MODE == DELTA) {
                out[c * plane + o] = delta;
            } else {
                const float y = delta + lo[c * plane + o];
                const float t = q0 + y;
                out[c * plane + o] = t;
                lo_out[c * plane + o] = y - (t - q0);
            }
        }
    }
}

Ctx make_ctx(const float* q, const float* st, const float* gx,
             const float* gy, int nx, int ny, const Bc& bc) {
    return Ctx{q, st, gx, gy, nx, ny, code(bc, 0, 0) == CP,
               code(bc, 2, 0) == CP};
}

template <bool GIN, bool THIN, int MODE>
int launch(const Ctx& g, const Bc& bc, const Params& P, const Thin& T,
           const float* lo, float* out, float* lo_out, int d0, float dt,
           void* stream) {
    bc_step_kernel<GIN, THIN, MODE>
        <<<grid_for(g.nx, g.ny), dim3(TY, TX), 0, (cudaStream_t)stream>>>(
            g, bc, P, T, lo, out, lo_out, d0, dt);
    return (int)cudaGetLastError();
}

}  // namespace

// C entry points (ctypes).  Device arrays, contiguous float32: q/out/lo
// (3, nx, ny); st (8, nx+2, ny+2); for gf_mixed_step qg (3, nx+2, ny+2),
// gx (3, 2, ny+2), gy (3, 2, nx+2).  iprm/fprm as for gf_fused_step,
// bprm/bfprm as for make_bc: host memory.  Each returns cudaGetLastError()
// after its launch.

extern "C" int gf_fused_step_bc(const float* q, const float* st, float* out,
                                int nx, int ny, int d0, const int* iprm,
                                const float* fprm, const int* bprm,
                                const float* bfprm, float dt, void* stream) {
    const Params P = make_params(iprm, fprm);
    Bc bc;
    Thin T;
    make_bc(bprm, bfprm, &bc, &T);
    const Ctx g = make_ctx(q, st, nullptr, nullptr, nx, ny, bc);
    return T.model != 0
        ? launch<false, true, STATE>(g, bc, P, T, nullptr, out, nullptr, d0, dt, stream)
        : launch<false, false, STATE>(g, bc, P, T, nullptr, out, nullptr, d0, dt, stream);
}

extern "C" int gf_comp_step_bc(const float* q, const float* lo,
                               const float* st, float* q_out, float* lo_out,
                               int nx, int ny, int d0, const int* iprm,
                               const float* fprm, const int* bprm,
                               const float* bfprm, float dt, void* stream) {
    const Params P = make_params(iprm, fprm);
    Bc bc;
    Thin T;
    make_bc(bprm, bfprm, &bc, &T);
    const Ctx g = make_ctx(q, st, nullptr, nullptr, nx, ny, bc);
    return T.model != 0
        ? launch<false, true, COMP>(g, bc, P, T, lo, q_out, lo_out, d0, dt, stream)
        : launch<false, false, COMP>(g, bc, P, T, lo, q_out, lo_out, d0, dt, stream);
}

extern "C" int gf_mixed_step(const float* qg, const float* st,
                             const float* gx, const float* gy, float* out,
                             int nx, int ny, int d0, int emit_delta,
                             const int* iprm, const float* fprm,
                             const int* bprm, const float* bfprm, float dt,
                             void* stream) {
    const Params P = make_params(iprm, fprm);
    Bc bc;
    Thin T;
    make_bc(bprm, bfprm, &bc, &T);
    const Ctx g = make_ctx(qg, st, gx, gy, nx, ny, bc);
    return emit_delta
        ? launch<true, false, DELTA>(g, bc, P, T, nullptr, out, nullptr, d0, dt, stream)
        : launch<true, false, STATE>(g, bc, P, T, nullptr, out, nullptr, d0, dt, stream);
}

// k plain steps on D/N, thinning or periodic edges in one launch (k <= 4,
// or <= 2 with shear thinning); q/out (3, nx, ny), st (8, nx+2, ny+2).
extern "C" int gf_plain_steps_bc(const float* q, const float* st, float* out,
                                 int nx, int ny, int k, int d0,
                                 const int* iprm, const float* fprm,
                                 const int* bprm, const float* bfprm,
                                 float dt, void* stream) {
    const Params P = make_params(iprm, fprm);
    Bc bc;
    Thin T;
    make_bc(bprm, bfprm, &bc, &T);
    return T.model != 0
        ? plain_sweeps<true, true>(q, st, out, nullptr, nx, ny, k, k, d0, dt,
                                   P, bc, T, stream)
        : plain_sweeps<true, false>(q, st, out, nullptr, nx, ny, k, k, d0,
                                    dt, P, bc, T, stream);
}

// n plain steps on D/N, thinning or periodic edges in sweeps of k (1..4,
// or 1..2 with shear thinning) and one of n mod k; q (3, nx, ny), st (8,
// nx+2, ny+2), A/B (3, nx, ny); the result is in A for an odd number of
// sweeps, else in B.
extern "C" int gf_plain_sweeps_bc(const float* q, const float* st, float* A,
                                  float* B, int nx, int ny, int n, int k,
                                  int d0, const int* iprm, const float* fprm,
                                  const int* bprm, const float* bfprm,
                                  float dt, void* stream) {
    const Params P = make_params(iprm, fprm);
    Bc bc;
    Thin T;
    make_bc(bprm, bfprm, &bc, &T);
    return T.model != 0
        ? plain_sweeps<true, true>(q, st, A, B, nx, ny, n, k, d0, dt, P, bc,
                                   T, stream)
        : plain_sweeps<true, false>(q, st, A, B, nx, ny, n, k, d0, dt, P, bc,
                                    T, stream);
}

// n compensated steps on D/N, thinning or periodic edges in sweeps of k
// (1..4, or 1..2 with shear thinning) and one of n mod k; q/lo (3, nx,
// ny), st (8, nx+2, ny+2), A/B (6, nx, ny): q, then q_lo; the result is
// in A for an odd number of sweeps, else in B.
extern "C" int gf_comp_sweeps_bc(const float* q, const float* lo,
                                 const float* st, float* A, float* B, int nx,
                                 int ny, int n, int k, int d0,
                                 const int* iprm, const float* fprm,
                                 const int* bprm, const float* bfprm,
                                 float dt, void* stream) {
    const Params P = make_params(iprm, fprm);
    Bc bc;
    Thin T;
    make_bc(bprm, bfprm, &bc, &T);
    return T.model != 0
        ? comp_sweeps<true, true>(q, lo, st, A, B, nx, ny, n, k, d0, dt, P,
                                  bc, T, stream)
        : comp_sweeps<true, false>(q, lo, st, A, B, nx, ny, n, k, d0, dt, P,
                                   bc, T, stream);
}
