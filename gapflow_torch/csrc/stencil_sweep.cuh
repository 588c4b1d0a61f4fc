// The plain (uncompensated) temporally blocked MacCormack sweep for Hopper
// (sm_90a), float32: k steps of every tile in one launch, each cell's
// state and predictor held in registers across the sweep.  The body of
// K2p/Ke (stencil_plain.cu: periodic edges, the interior statics), of
// K3p (stencil_bc.cu: Dirichlet/Neumann edges and shear thinning, the
// ghost-inclusive statics), of the shard sweep (stencil_shard.cu: k
// steps of a shard's halo block) and of the EHL step K8 (stencil_ehl.cu:
// one step, the statics formed from the deformed gap, the increment or
// the Kahan carry written); plain_sweeps runs a whole plain run of n
// steps in one C call.
//
// Replaces the plain branch of the Pallas sweep kernels of
// gapflow_tpu/ops/stencil.py: _kernel_fused_hbm_loop with _advance_plain
// (K2p), its remainder _kernel_fused_ext (Ke) and _kernel_fused_bc_hbm
// with nch = 3 (K3p).  k steps of a launch round exactly like k launches
// of K1 (stencil.cu) or K3 (stencil_bc.cu): every flux, update and
// average is the one-step kernels' own arithmetic in their order.
//
// Layout.  A block of WARPS warps advances a window of WX = R * WARPS rows
// (x) by 32 columns (y): lane j holds column j, and the warp w the rows
// [w R, w R + R) of it, each thread R cells.  The window is a tile of
// (WX - 2h) x (32 - 2h) interior cells and a halo of h = k * SHRINK cells
// a side (a step consumes one cell a side, three with shear thinning,
// whose viscosity reads the pressure at +-1).  A thread keeps its cells'
// state and predictor in registers from the load to the store, and reads
// their statics through the read-only cache each pass; nothing of a cell
// goes through shared memory but what a neighbour in another warp reads.
// A one-sided pass in direction D reads the flux of the cell at -D:
//   - along y, lane j - D of the same warp: warp shuffles;
//   - along x, the row above or below in the thread's own registers, and
//     at the first (D = +1) or last (D = -1) of its rows the edge row of
//     the neighbouring warp, through a double-buffered exchange plane of
//     3 floats a lane (7 where a periodic seam needs the neighbour's
//     state), one block barrier a pass.  That row's update waits for the
//     barrier; the others go ahead of it.
// Shear thinning adds a second barrier a pass, for the pressures of the
// neighbouring warps' edge rows.  Rows that leave the valid region (the
// tile plus the halo the remaining passes consume) are skipped, a warp's
// row at a time.
//
// Edges, as in the one-step kernels:
//   - periodic: window indices wrap.  On the ghost-inclusive layout of K3
//     a periodic ghost is a copy of the far interior cell with statics of
//     its own and, with thinning, a one-sided pressure gradient across the
//     seam: a cell whose one-sided difference crosses the seam consumes
//     that ghost's flux (seam flux below), computed from its neighbour's
//     state.  K2p takes K1's interior statics, where the two coincide;
//   - Dirichlet/Neumann on y: the ghost column is a lane, refilled by the
//     edge formula from its neighbour lane (a shuffle) after every update,
//     as apply_bcs refills it after every pass and average;
//   - Dirichlet/Neumann on x: a ghost row is read only by its interior
//     neighbour (the flux it consumes, with thinning the pressure of its
//     gradient), so the thread that holds the edge row forms the ghost row
//     from its own state by the edge formula (the corner lanes taking the
//     y fill of their neighbour in the ghost row: x edges first, then y)
//     and evaluates it there; the ghost row's own slot in the window is
//     never read.  A refilled ghost is valid again, so domain edges
//     consume no halo.
// Each D/N instance is compiled for its periodic axes (PX, PY): carrying
// every edge's paths at run time made the boundary sweeps slower than the
// shared-memory body (PERF.md).
//
// What bounds it: the FP32 work, about 300 operations a cell and step
// under --fmad=false, and the instructions around it; device memory moves
// 14 floats a cell per sweep (3 in, 8 statics, 3 out).  The passes' long
// chains (IEEE divisions, the EOS, thinning) want many warps a SM, so the
// registers a thread holds are what the tile is chosen by: 2 rows a
// thread, 16 warps a block, two blocks a SM (timed against 4 and 8 rows
// and 8 and 16 warps in tests/comp_sweep_bench.py, PERF.md).  PERF.md
// gives the instruction counts of this body and of the shared-memory body
// it replaced (stencil_multi.cuh), from tests/comp_sweep_bench.py --sass.

#pragma once

#include <type_traits>

#include "stencil_common.cuh"

namespace {

constexpr unsigned FULL_MASK = 0xffffffffu;

template <bool THIN>
struct SweepGeo {
    static constexpr int R = 2;                 // window rows a thread owns
    static constexpr int WARPS = 16;            // warps a block
    static constexpr int MIN_BLOCKS = 2;        // blocks a SM (launch bounds)
    static constexpr int THREADS = 32 * WARPS;
    static constexpr int WX = R * WARPS;        // window rows (x)
    static constexpr int SHRINK = THIN ? 3 : 1; // halo a step consumes
    static constexpr int KMAX = THIN ? 2 : 4;   // steps a sweep at most
    static constexpr int XCH = 7;               // floats a lane exchanges

    // the tiles of a sweep k steps deep
    static dim3 grid(int nx, int ny, int k) {
        const int h = k * SHRINK, tx = WX - 2 * h, ty = 32 - 2 * h;
        return dim3((ny + ty - 1) / ty, (nx + tx - 1) / tx);
    }
};

// The one-sided shuffles: lane j receives v of lane j - D.
template <int D>
__device__ __forceinline__ float from_minus(float v) {
    return D > 0 ? __shfl_up_sync(FULL_MASK, v, 1)
                 : __shfl_down_sync(FULL_MASK, v, 1);
}

// The statics of an array layout (8, rows, sw), read through the
// read-only cache: K3's ghost-inclusive (8, nx+2, ny+2), K1's interior
// (8, nx, ny), or a shard's block (8, bx+2 hs, by+2 hs).  A statics type
// provides begin(), called once a thread before the sweep, and load(i, j,
// g), the 8 channels of row i, column j of its layout (stencil_ehl.cu's
// forms them from the deformed gap instead).
struct ArrayStat {
    const float* st;
    size_t splane;
    int sw;

    __device__ __forceinline__ void begin() {}

    __device__ __forceinline__ void load(int i, int j, float* g) const {
        const size_t o = (size_t)i * sw + j;
#pragma unroll
        for (int c = 0; c < N_STATIC; ++c) g[c] = __ldg(st + c * splane + o);
    }
};

// A shard's block (stencil_shard.cu): its state with an H-deep halo, (3,
// bx+2H, by+2H), its statics with an hs-deep one, and the domain edges it
// holds (x-low, x-high, y-high, y-low; each nonzero only where that axis
// is not periodic).
struct Shard {
    int H, hs, xe, xw, yn, ys;
};

// k steps of the tile (blockIdx.y, blockIdx.x).  BC: the ghost-inclusive
// statics and edge codes of K3 (S reads (8, nx+2, ny+2)); else all edges
// periodic and S reads interior (nx, ny) indices.  PX, PY: the x / y edges
// are periodic (else Dirichlet/Neumann), fixed at compile time so that an
// instance holds only its own edges' code.  q, out: (3, nx, ny).
//
// MODE (one step deep only, k = 1; the EHL kernel): STATE writes the new
// state, DELTA the increment ((q* - q) - u) / 2, COMP the Kahan two-sum of
// that increment into the (q, lo) carry, written to (out, lo_out) in the
// order of _advance_comp.  KEEP: the statics of the thread's cells are
// formed once before the passes and held in shared memory.
//
// SHARD (with BC): the tile lies in a shard's block (Shard sh).  A
// domain edge the shard holds is a D/N edge as above (its ghosts refilled
// in the sweep, so it consumes no halo; PX/PY false marks an axis where
// the shard holds one); every other side reads the block's halo, never
// wrapped, and rows and columns beyond the block are clamped (their
// values reach no tile cell within k steps: H >= k).
template <bool BC, bool PX, bool PY, bool THIN, int MODE = STATE,
          bool SHARD = false, bool KEEP = false, class Stat>
__device__ __forceinline__ void sweep_body(
    const float* __restrict__ q, const Stat S0, float* __restrict__ out,
    const float* __restrict__ lo, float* __restrict__ lo_out, int nx, int ny,
    int k, int d0, float dt, const Params& P, const Bc& bc, const Thin& T,
    const Shard& sh) {
    using G = SweepGeo<THIN>;
    constexpr int R = G::R, W = G::WARPS;
    constexpr bool SEAM = BC && !SHARD;     // periodic ghost slots (K3)
    // edge rows' fluxes (with a seam, and state); THIN: their pressures;
    // KEEP: the statics of every thread's own cells
    __shared__ float xf[2][SEAM ? G::XCH : 3][W][32];
    __shared__ float xp[THIN ? 2 : 1][THIN ? W : 1][32];
    __shared__ float kst[KEEP ? N_STATIC : 1][KEEP ? G::WX : 1][32];

    Stat S = S0;
    S.begin();
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int h = k * G::SHRINK;
    const int x0 = blockIdx.y * (G::WX - 2 * h);
    const int y0 = blockIdx.x * (32 - 2 * h);
    const int X0 = x0 - h + warp * R;       // X of the thread's first row
    const int Y = y0 - h + lane;
    constexpr bool per_x = PX, per_y = PY;
    const size_t plane = (size_t)nx * ny;   // out, lo
    // the state's layout: the interior, or the shard's halo block
    const int H = SHARD ? sh.H : 0;
    const int qw = ny + 2 * H;
    const size_t qplane = SHARD ? (size_t)(nx + 2 * H) * qw : plane;
    // the domain edges a shard holds
    const bool s_xe = SHARD && !per_x && sh.xe;
    const bool s_xw = SHARD && !per_x && sh.xw;
    const bool s_ys = SHARD && !per_y && sh.ys;
    const bool s_yn = SHARD && !per_y && sh.yn;

    // the lane's column: state and statics index, ghost and seam flags
    int iy, sy;
    bool yout;
    if constexpr (SHARD) {
        iy = min(max(Y, s_ys ? 0 : -H), s_yn ? ny - 1 : ny + H - 1) + H;
        sy = min(max(Y, s_ys ? -1 : -sh.hs), s_yn ? ny : ny + sh.hs - 1)
             + sh.hs;
        yout = (s_ys && Y < 0) || (s_yn && Y >= ny);
    } else {
        iy = per_y ? wrap(Y, ny) : min(max(Y, 0), ny - 1);
        sy = BC ? (per_y ? iy + 1 : min(max(Y, -1), ny) + 1) : iy;
        yout = !per_y && (Y < 0 || Y >= ny);
    }
    const bool any_yout = BC && __any_sync(FULL_MASK, yout);
    // a periodic seam of the ghost-inclusive layout: the lane whose
    // difference in direction +1 (-1) reads across it
    const bool ys_p = SEAM && per_y && iy == 0;
    const bool ys_m = SEAM && per_y && iy == ny - 1;
    const bool any_ys = SEAM && __any_sync(FULL_MASK, ys_p || ys_m);
    // the statics rows of the ghost rows beyond the x-low and x-high edges
    const int gs_lo = SHARD ? sh.hs - 1 : 0;
    const int gs_hi = SHARD ? nx + sh.hs : nx + 1;

    // the rows: statics row, and bit masks of the rows that are cells
    // (not beyond a D/N edge, nor a shard's block), D/N edge rows,
    // periodic seam rows
    int sx[R];
    unsigned cell = 0, e_lo = 0, e_hi = 0, xs_p = 0, xs_m = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const int X = X0 + r;
        if constexpr (SHARD) {
            sx[r] = min(max(X, s_xe ? -1 : -sh.hs),
                        s_xw ? nx : nx + sh.hs - 1) + sh.hs;
            if (!(s_xe && X < 0) && !(s_xw && X >= nx) && X < nx + H)
                cell |= 1u << r;
            if (s_xe && X == 0) e_lo |= 1u << r;
            if (s_xw && X == nx - 1) e_hi |= 1u << r;
        } else {
            const int ix = per_x ? wrap(X, nx) : min(max(X, 0), nx - 1);
            sx[r] = BC ? (per_x ? ix + 1 : min(max(X, -1), nx) + 1) : ix;
            if (per_x || (X >= 0 && X < nx)) cell |= 1u << r;
            if (!per_x && X == 0) e_lo |= 1u << r;
            if (!per_x && X == nx - 1) e_hi |= 1u << r;
            if (BC && per_x && ix == 0) xs_p |= 1u << r;
            if (BC && per_x && ix == nx - 1) xs_m |= 1u << r;
        }
    }

    // the state on the window (ghost rows and columns from the edge
    // formulas, x then y), once a sweep; COMP: the carry
    float qa[3][R], pd[3][R];
    float lq[MODE == COMP ? 3 : 1][R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const int X = X0 + r;
        int ix;
        bool xg;                            // beyond a D/N x edge
        if constexpr (SHARD) {
            ix = min(max(X, s_xe ? 0 : -H), s_xw ? nx - 1 : nx + H - 1) + H;
            xg = (s_xe && X < 0) || (s_xw && X >= nx);
        } else {
            ix = per_x ? wrap(X, nx) : min(max(X, 0), nx - 1);
            xg = !per_x && (X < 0 || X >= nx);
        }
        const size_t g = (size_t)ix * qw + iy;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            float v = q[c * qplane + g];
            if (xg) {
                const int e = X < 0 ? 0 : 1;
                v = fill(code(bc, e, c), twoval(bc, e), v);
            }
            if (yout) {
                const int e = Y < 0 ? 2 : 3;
                v = fill(code(bc, e, c), twoval(bc, e), v);
            }
            qa[c][r] = pd[c][r] = v;
            if constexpr (MODE == COMP) lq[c][r] = lo[c * plane + g];
        }
    }

    // the statics of a cell or a ghost slot (row i, column j of the
    // statics' layout), read through the read-only cache every pass: held
    // in registers they would cost the occupancy that hides the passes'
    // latency (PERF.md).  KEEP forms a thread's cells' statics once, before
    // the first pass, and holds them in shared memory, where only that
    // thread reads them
    auto statics = [&](int i, int j, float* g) { S.load(i, j, g); };
    // the flux of a cell from its state, statics, pressure and the
    // gradients of thinning
    auto flux = [&](float a, float b, float c, const float* sc, float p,
                    float gx, float gy) -> CellFlux {
        if (!THIN) return closures(a, b, c, sc, P);
        const float eta = thinning_eta(gx, gy, sc[2],
                                       shear_viscosity(a, p, P), T);
        return closures_eta(a, b, c, sc, p, eta, P);
    };

    int vlo = 0, vhi = G::WX - 1;     // valid window rows (inclusive)
    const int row0 = warp * R;

    auto run_pass = [&](auto dir, const bool second, const int buf) {
        constexpr int D = decltype(dir)::value;
        constexpr int RB = D > 0 ? 0 : R - 1;      // the row that waits
        constexpr int RP = D > 0 ? R - 1 : 0;      // the row others read
        auto src = [&](int c, int r) { return second ? pd[c][r] : qa[c][r]; };
        unsigned live = 0;
#pragma unroll
        for (int r = 0; r < R; ++r)
            if (row0 + r >= vlo && row0 + r <= vhi && (cell >> r & 1))
                live |= 1u << r;

        // THIN: the rows' pressures, and those of the neighbouring warps'
        // edge rows (single-buffered: the flux barrier of the previous
        // pass separates its reads from these writes)
        float p[R], pxm = 0.f, pxp = 0.f;
        if constexpr (THIN) {
#pragma unroll
            for (int r = 0; r < R; ++r)
                p[r] = (live >> r & 1) ? eos_pressure(src(0, r), P) : 0.f;
            xp[0][warp][lane] = p[0];
            xp[1][warp][lane] = p[R - 1];
            __syncthreads();
            if (warp > 0) pxm = xp[1][warp - 1][lane];
            if (warp < W - 1) pxp = xp[0][warp + 1][lane];
        }

        // the ghost row beyond the D/N edge row r (e = 0: X = -1, e = 1:
        // X = nx), from the edge formulas; corner lanes take the y fill of
        // their neighbour in the ghost row
        auto ghost_row = [&](int r, int e, float* g) {
#pragma unroll
            for (int c = 0; c < 3; ++c)
                g[c] = fill(code(bc, e, c), twoval(bc, e), src(c, r));
            if (any_yout) {
#pragma unroll
                for (int c = 0; c < 3; ++c) {
                    const float up = __shfl_down_sync(FULL_MASK, g[c], 1);
                    const float dn = __shfl_up_sync(FULL_MASK, g[c], 1);
                    if (yout) {
                        const int ey = Y < 0 ? 2 : 3;
                        g[c] = fill(code(bc, ey, c), twoval(bc, ey),
                                    Y < 0 ? up : dn);
                    }
                }
            }
        };
        // the flux of that ghost row, consumed by row r (pc: row r's
        // pressure): its own statics and, with thinning, its one-sided
        // gradient across the edge and its gradient along y
        auto ghost_flux = [&](int r, int e, const float* g, float pc) {
            float sg[N_STATIC];
            statics(e == 0 ? gs_lo : gs_hi, sy, sg);
            float pg = 0.f, gx = 0.f, gy = 0.f;
            if (THIN) {
                pg = eos_pressure(g[0], P);
                const float pgm = __shfl_up_sync(FULL_MASK, pg, 1);
                const float pgp = __shfl_down_sync(FULL_MASK, pg, 1);
                gx = e == 0 ? (pc - pg) / T.dx : (pg - pc) / T.dx;
                gy = per_y ? ((pgp - pgm) / T.dy) / 2.f
                           : grad(Y, ny, pgm, pg, pgp, T.dy);
            }
            return flux(g[0], g[1], g[2], sg, pg, gx, gy);
        };
        // the seam flux: the neighbour's state (a, b, c; pressure pn, its
        // neighbours pno_m, pno_p along the other axis) with the ghost
        // slot's statics, and with thinning the one-sided gradient across
        // the seam (XAX: the seam is across x)
        auto seam_flux = [&](bool XAX, int r, float a, float b, float c,
                             float pn, float pno_m, float pno_p, float pc) {
            float sg[N_STATIC];
            if (XAX)
                statics(D > 0 ? 0 : nx + 1, sy, sg);
            else
                statics(sx[r], D > 0 ? 0 : ny + 1, sg);
            if (!THIN) return closures(a, b, c, sg, P);
            const float hs = XAX ? T.dx : T.dy, ho = XAX ? T.dy : T.dx;
            const float g_seam = D > 0 ? (pc - pn) / hs : (pn - pc) / hs;
            const float g_other = ((pno_p - pno_m) / ho) / 2.f;
            const float eta = thinning_eta(XAX ? g_seam : g_other,
                                           XAX ? g_other : g_seam, sg[2],
                                           shear_viscosity(a, pn, P), T);
            return closures_eta(a, b, c, sg, pn, eta, P);
        };
        // u = dt * (ddx(Fx) + ddy(Fy) - S), then the predictor q* = q - u
        // or the average ((q* - u) + q) / 2; a D/N ghost lane is refilled
        // from its neighbour lane
        auto update = [&](int r, const CellFlux& f, float fx0, float fx2,
                          float fx3, float fy1, float fy3, float fy4) {
            const float md = (float)(-D);
            float u[3];
            u[0] = dt * (md * (fx0 - f.f[0]) * P.rdx
                         + md * (fy1 - f.f[1]) * P.rdy - f.s[0]);
            u[1] = dt * (md * (fx2 - f.f[2]) * P.rdx
                         + md * (fy3 - f.f[3]) * P.rdy - f.s[1]);
            u[2] = dt * (md * (fx3 - f.f[3]) * P.rdx
                         + md * (fy4 - f.f[4]) * P.rdy - f.s[2]);
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                if (!second) {
                    pd[c][r] = qa[c][r] - u[c];
                } else if (MODE == STATE) {
                    qa[c][r] = ((pd[c][r] - u[c]) + qa[c][r]) / 2.f;
                } else {
                    const float q0 = qa[c][r];
                    const float dq = ((pd[c][r] - q0) - u[c]) / 2.f;
                    if (MODE == DELTA) {
                        qa[c][r] = dq;
                    } else {
                        const float y = dq + lq[MODE == COMP ? c : 0][r];
                        const float t = q0 + y;
                        lq[MODE == COMP ? c : 0][r] = y - (t - q0);
                        qa[c][r] = t;
                    }
                }
            }
            if (any_yout) {
#pragma unroll
                for (int c = 0; c < 3; ++c) {
                    const float v = second ? qa[c][r] : pd[c][r];
                    const float up = __shfl_down_sync(FULL_MASK, v, 1);
                    const float dn = __shfl_up_sync(FULL_MASK, v, 1);
                    if (yout) {
                        const int ey = Y < 0 ? 2 : 3;
                        const float g = fill(code(bc, ey, c), twoval(bc, ey),
                                             Y < 0 ? up : dn);
                        if (second)
                            qa[c][r] = g;
                        else
                            pd[c][r] = g;
                    }
                }
            }
        };

        float cx[3] = {0.f, 0.f, 0.f};   // F0, F2, F3 of the row at -D
        CellFlux fb{};                   // the waiting row's fluxes,
        float fyb[3] = {0.f, 0.f, 0.f};  // its y neighbour's,
        float gxb[3] = {0.f, 0.f, 0.f};  // its D/N ghost's F0, F2, F3,
        float pb[3] = {0.f, 0.f, 0.f};   // its pressure, x neighbours'
#pragma unroll
        for (int i = 0; i < R; ++i) {
            const int r = D > 0 ? i : R - 1 - i;
            if (!(live >> r & 1)) continue;
            const float a = src(0, r), b = src(1, r), c = src(2, r);
            const bool elo = e_lo >> r & 1, ehi = e_hi >> r & 1;
            float glo[3], ghi[3];
            if (elo) ghost_row(r, 0, glo);
            if (ehi) ghost_row(r, 1, ghi);
            float pc = 0.f, pm = 0.f, pp = 0.f, gx = 0.f, gy = 0.f;
            if (THIN) {
                pc = p[r];
                pm = r > 0 ? p[r > 0 ? r - 1 : 0] : pxm;
                pp = r < R - 1 ? p[r < R - 1 ? r + 1 : 0] : pxp;
                if (elo) pm = eos_pressure(glo[0], P);
                if (ehi) pp = eos_pressure(ghi[0], P);
                const float pym = __shfl_up_sync(FULL_MASK, pc, 1);
                const float pyp = __shfl_down_sync(FULL_MASK, pc, 1);
                gx = ((pp - pm) / T.dx) / 2.f;
                gy = per_y ? ((pyp - pym) / T.dy) / 2.f
                           : grad(Y, ny, pym, pc, pyp, T.dy);
            }
            float sr[N_STATIC];
            if (KEEP) {
#pragma unroll
                for (int m = 0; m < N_STATIC; ++m)
                    sr[m] = kst[KEEP ? m : 0][KEEP ? row0 + r : 0][lane];
            } else {
                statics(sx[r], sy, sr);
            }
            const CellFlux f = flux(a, b, c, sr, pc, gx, gy);

            // the y neighbour's fluxes; across a periodic seam the ghost's
            float fy1 = from_minus<D>(f.f[1]), fy3 = from_minus<D>(f.f[3]);
            float fy4 = from_minus<D>(f.f[4]);
            if (SEAM && any_ys) {
                const float na = from_minus<D>(a), nb = from_minus<D>(b);
                const float nc = from_minus<D>(c);
                const float npc = THIN ? from_minus<D>(pc) : 0.f;
                const float npm = THIN ? from_minus<D>(pm) : 0.f;
                const float npp = THIN ? from_minus<D>(pp) : 0.f;
                if (D > 0 ? ys_p : ys_m) {
                    const CellFlux g = seam_flux(false, r, na, nb, nc, npc,
                                                 npm, npp, pc);
                    fy1 = g.f[1];
                    fy3 = g.f[3];
                    fy4 = g.f[4];
                }
            }
            // a D/N ghost row at -D: its flux, from this row's state
            float gf[3] = {cx[0], cx[1], cx[2]};
            if (D > 0 ? elo : ehi) {
                const CellFlux g = ghost_flux(r, D > 0 ? 0 : 1,
                                              D > 0 ? glo : ghi, pc);
                gf[0] = g.f[0];
                gf[1] = g.f[2];
                gf[2] = g.f[3];
            }
            if (r == RP) {        // the row the next warp at +D reads
                xf[buf][0][warp][lane] = f.f[0];
                xf[buf][1][warp][lane] = f.f[2];
                xf[buf][2][warp][lane] = f.f[3];
                if constexpr (SEAM && per_x) {
                    xf[buf][3][warp][lane] = a;
                    xf[buf][4][warp][lane] = b;
                    xf[buf][5][warp][lane] = c;
                    xf[buf][6][warp][lane] = pc;
                }
            }
            if (r == RB) {        // waits for the barrier
                fb = f;
                fyb[0] = fy1;
                fyb[1] = fy3;
                fyb[2] = fy4;
                gxb[0] = gf[0];
                gxb[1] = gf[1];
                gxb[2] = gf[2];
                pb[0] = pc;
            } else {
                if (SEAM && per_x && ((D > 0 ? xs_p : xs_m) >> r & 1)) {
                    // across a periodic seam in x: the ghost's flux, from
                    // the row at -D in this thread
                    const int rn = r - D;
                    const float np = THIN ? p[rn] : 0.f;
                    const CellFlux g = seam_flux(
                        true, r, src(0, rn), src(1, rn), src(2, rn), np,
                        THIN ? __shfl_up_sync(FULL_MASK, np, 1) : 0.f,
                        THIN ? __shfl_down_sync(FULL_MASK, np, 1) : 0.f, pc);
                    gf[0] = g.f[0];
                    gf[1] = g.f[2];
                    gf[2] = g.f[3];
                }
                update(r, f, gf[0], gf[1], gf[2], fy1, fy3, fy4);
            }
            cx[0] = f.f[0];
            cx[1] = f.f[2];
            cx[2] = f.f[3];
        }
        __syncthreads();

        // the waiting row: the neighbouring warp's edge row
        if (live >> RB & 1) {
            const int wn = warp - D;
            const bool has = wn >= 0 && wn < W;
            float fx[3] = {gxb[0], gxb[1], gxb[2]};
            if (!((D > 0 ? e_lo : e_hi) >> RB & 1) && has) {
#pragma unroll
                for (int m = 0; m < 3; ++m) fx[m] = xf[buf][m][wn][lane];
            }
            if constexpr (SEAM && per_x) {
                if ((D > 0 ? xs_p : xs_m) >> RB & 1) {
                    float n[4] = {0.f, 0.f, 0.f, 0.f};
                    if (has) {
#pragma unroll
                        for (int m = 0; m < 4; ++m)
                            n[m] = xf[buf][3 + m][wn][lane];
                    }
                    const float np = THIN ? n[3] : 0.f;
                    const CellFlux g = seam_flux(
                        true, RB, n[0], n[1], n[2], np,
                        THIN ? __shfl_up_sync(FULL_MASK, np, 1) : 0.f,
                        THIN ? __shfl_down_sync(FULL_MASK, np, 1) : 0.f,
                        pb[0]);
                    fx[0] = g.f[0];
                    fx[1] = g.f[2];
                    fx[2] = g.f[3];
                }
            }
            update(RB, fb, fx[0], fx[1], fx[2], fyb[0], fyb[1], fyb[2]);
        }
    };

    if constexpr (KEEP) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
            if (!(cell >> r & 1)) continue;
            float g[N_STATIC];
            statics(sx[r], sy, g);
#pragma unroll
            for (int m = 0; m < N_STATIC; ++m) kst[m][row0 + r][lane] = g[m];
        }
    }

    for (int pass = 0; pass < 2 * k; ++pass) {
        const bool second = pass & 1;
        const int D = second ? -d0 : d0;
        if (D > 0)
            run_pass(std::integral_constant<int, 1>{}, second, pass & 1);
        else
            run_pass(std::integral_constant<int, -1>{}, second, pass & 1);
        // the valid rows: a pass consumes one row at -D, and with
        // thinning one more a side for the pressure gradient
        vlo += (THIN ? 1 : 0) + (D > 0);
        vhi -= (THIN ? 1 : 0) + (D < 0);
    }

    // the tile's cells
    const int tx = G::WX - 2 * h, ty = 32 - 2 * h;
    if (lane < h || lane >= h + ty || Y >= ny) return;
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const int li = row0 + r, X = X0 + r;
        if (li < h || li >= h + tx || X >= nx) continue;
        const size_t g = (size_t)X * ny + Y;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            out[c * plane + g] = qa[c][r];
            if constexpr (MODE == COMP) lo_out[c * plane + g] = lq[c][r];
        }
    }
}

// k plain steps of the tile (blockIdx.y, blockIdx.x) on the interior
// (K2p/Ke, BC false: st is (8, nx, ny)) or with K3's edges (BC: st is
// (8, nx+2, ny+2)); see sweep_body.
template <bool BC, bool PX, bool PY, bool THIN>
__global__ void __launch_bounds__(SweepGeo<THIN>::THREADS,
                                  SweepGeo<THIN>::MIN_BLOCKS)
sweep_kernel(const float* __restrict__ q, const float* __restrict__ st,
             float* __restrict__ out, int nx, int ny, int k, int d0,
             float dt, Params P, Bc bc, Thin T) {
    const int sw = BC ? ny + 2 : ny;
    const ArrayStat S{st, BC ? (size_t)(nx + 2) * sw : (size_t)nx * ny, sw};
    sweep_body<BC, PX, PY, THIN>(q, S, out, nullptr, nullptr, nx, ny, k, d0,
                                 dt, P, bc, T, Shard{});
}

// n plain steps on stream s: n / k sweeps of k steps and one of n mod k,
// each a launch of sweep_kernel that reads one state buffer and writes the
// other.  The first sweep reads q; sweep i writes A (i even) or B (i odd),
// each (3, nx, ny), so the result is in A for an odd number of sweeps,
// else in B (B may be null when n <= k).  Returns the first CUDA error,
// before any later launch.
template <bool BC, bool PX, bool PY, bool THIN>
void launch_sweep(const float* q, const float* st, float* out, int nx,
                  int ny, int k, int d0, float dt, const Params& P,
                  const Bc& bc, const Thin& T, void* s) {
    using G = SweepGeo<THIN>;
    sweep_kernel<BC, PX, PY, THIN><<<G::grid(nx, ny, k), G::THREADS, 0,
                                     (cudaStream_t)s>>>(
        q, st, out, nx, ny, k, d0, dt, P, bc, T);
}

template <bool BC, bool THIN>
int plain_sweeps(const float* q, const float* st, float* A, float* B,
                 int nx, int ny, int n, int k, int d0, float dt,
                 const Params& P, const Bc& bc, const Thin& T, void* s) {
    using G = SweepGeo<THIN>;
    if (k < 1 || k > G::KMAX || n < 1 || (n > k && B == nullptr))
        return (int)cudaErrorInvalidValue;
    // the instance for the edges: periodic x and y without BC; with BC
    // each axis periodic or not by its edge codes (an axis is periodic on
    // both edges or on neither)
    auto launch = launch_sweep<BC, true, true, THIN>;
    if constexpr (BC) {
        const bool px = code(bc, 0, 0) == CP, py = code(bc, 2, 0) == CP;
        if (!px)
            launch = py ? launch_sweep<BC, false, true, THIN>
                        : launch_sweep<BC, false, false, THIN>;
        else if (!py)
            launch = launch_sweep<BC, true, false, THIN>;
    }
    for (int done = 0, i = 0; done < n; ++i) {
        const int kk = n - done < k ? n - done : k;
        float* dst = i % 2 ? B : A;
        launch(q, st, dst, nx, ny, kk, d0, dt, P, bc, T, s);
        const cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
        q = dst;
        done += kk;
    }
    return 0;
}

}  // namespace
