// k Kahan-compensated MacCormack steps per launch (temporal blocking),
// float32: the body of the compensated sweeps K2c (stencil.cu: periodic
// edges, the interior statics) and K3c (stencil_bc.cu: Dirichlet/Neumann
// edges and shear thinning, the ghost-inclusive statics).  The plain
// sweeps K2p/Ke/K3p have a body of their own, stencil_sweep.cuh, which
// keeps each cell's values in registers.
//
// A block owns a TX x TY tile of interior cells.  It loads the state on
// the tile plus a halo of h = k * SHRINK cells per side into shared
// memory, advances that window k steps there and writes the tile alone.
// A one-sided pass in direction d reads the flux of the neighbour at
// -d, so each pass leaves one cell fewer valid on that side of the
// window; with shear thinning the viscosity also reads the pressure at
// +-1, one more cell on both sides.  A step (passes d0 and -d0) thus
// consumes one cell per side (SHRINK = 1), three with thinning.  The
// valid region is tracked per pass, so nothing outside it is read.
//
// Axes, as in the one-step kernels:
//   - periodic: window indices wrap (no extended copies).  On the
//     ghost-inclusive layout of K3 a periodic ghost is a copy of the far
//     interior cell, but it has statics of its own and, with thinning,
//     a one-sided pressure gradient across the seam; an interior cell
//     consumes that ghost's flux, not its wrapped neighbour's, where its
//     one-sided difference crosses the seam (seam_flux below).  K2c
//     takes K2's interior statics, where the two coincide;
//   - Dirichlet/Neumann: the ghost row or column at -1 / n is a window
//     cell, built from the adjacent interior by the edge formulas at the
//     load and again after every pass and every average (x edges first,
//     then y, so a corner takes the y fill of the x ghost row, as
//     apply_bcs does).  Cells beyond it are dead.  A refilled ghost is
//     valid again, so domain edges consume no halo: only the edges
//     between tiles do.
// Every flux, update and two-sum is the one-step kernels' own
// arithmetic, in their order, so k steps of a launch round exactly like
// k launches of K2 or K3 in their Kahan mode.
//
// The Kahan low part q_lo of the (q, q_lo) carry takes three shared
// channels beside q.  It is loaded on the whole window like q: a halo
// cell's carry sets that cell's q after the first step, and so every
// later step of the cells it feeds.  The step ends in the two-sum of the
// increment, in the order of the TPU kernel's _advance_comp and of the
// one-step kernels,
//     delta = ((q* - q) - u) / 2;  y = delta + lo;  t = q + y;
//     lo = y - (t - q);  q = t,
// and the tile's q and q_lo are written.  A D/N ghost is refilled from
// q alone; its q_lo is never read (the average skips ghost slots).
//
// What bounds it: on the H100 the one-step kernels are bound by memory
// bytes (14 floats in, 6 out per cell and step with the carry); k steps
// per launch cut those to 1/k, which leaves FP32 work (~312 operations
// per cell and step) as the bound.  The recomputed halo is the price:
// with a 32 x 32 tile and k = 3 the window is 38 x 38, and the passes of
// a launch evaluate about 1.3x the useful cells.  The state, carry,
// predictor, fluxes and sources of the window live in dynamic shared
// memory (17 floats per cell, 18 with the pressure of thinning: 98.2 KB
// for the 38 x 38 window of k = 3, 104 KB with thinning at k = 1, so two
// blocks still fit an SM's 228 KB); the statics are read through
// the read-only cache (__ldg) rather than staged.  Per-cell integer work
// is kept off the passes: the wrapped or clamped row and column of every
// window cell come from four small index tables, and a cell's window row from a float reciprocal, not an
// integer division.

#pragma once

#include "stencil_common.cuh"

namespace {

// Tile and block: 32 x 32 on 512 threads with and without thinning
// (timed against 16 x 32 on 256 in tests/comp_sweep_bench.py, PERF.md):
// with thinning the sweeps are one step deep (ops/stencil.py
// _comp_k_steps), whose window of 18 floats a cell still leaves two
// blocks per SM.
template <bool THIN>
struct MultiGeo {
    static constexpr int TX = 32;               // tile rows (x)
    static constexpr int TY = 32;               // tile columns (y)
    static constexpr int THREADS = 512;
    static constexpr int SHRINK = THIN ? 3 : 1; // halo a step consumes
    // shared floats per cell: state, carry, predictor, fluxes, sources,
    // the pressure of thinning
    static constexpr int NCH = THIN ? 18 : 17;
    static constexpr int KMAX = THIN ? 2 : 4;   // steps per launch at most

    // the window's floats and its four index tables
    static size_t smem_bytes(int k) {
        const int h = k * SHRINK, wx = TX + 2 * h, wy = TY + 2 * h;
        return sizeof(float) * NCH * wx * wy + sizeof(int) * 2 * (wx + wy);
    }
};

// Whether the one-sided difference in direction d at interior index i
// of a periodic axis of n cells reads across the seam.
__device__ __forceinline__ bool seam(int i, int n, int d) {
    return d > 0 ? i == 0 : i == n - 1;
}

// k steps of the tile (blockIdx.y, blockIdx.x).  BC: the ghost-inclusive
// layout and edge codes of K3 (st is (8, nx+2, ny+2)); else all edges
// periodic and st is (8, nx, ny).  q, out and the carry lo_in, lo_out:
// (3, nx, ny).
template <bool BC, bool THIN>
__global__ void __launch_bounds__(MultiGeo<THIN>::THREADS)
multi_step_kernel(const float* __restrict__ q,
                  const float* __restrict__ lo_in,
                  const float* __restrict__ st, float* __restrict__ out,
                  float* __restrict__ lo_out, int nx, int ny, int k, int d0,
                  float dt, Params P, Bc bc, Thin T) {
    using G = MultiGeo<THIN>;
    extern __shared__ float sm[];
    const int h = k * G::SHRINK;
    const int WX = G::TX + 2 * h, WY = G::TY + 2 * h, NW = WX * WY;
    float* qa = sm;              // [3][NW] state, averaged in place
    float* lo = qa + 3 * NW;     // [3][NW] Kahan carry q_lo
    float* pd = lo + 3 * NW;     // [3][NW] predictor q*
    float* F = pd + 3 * NW;      // [5][NW] fluxes of the current pass
    float* S = F + 5 * NW;       // [3][NW] sources of the current pass
    float* pp = S + 3 * NW;      // [NW]    pressure of the pass (THIN)
    int* ix = (int*)(pp + (THIN ? NW : 0));   // [WX] state row of a window row
    int* iy = ix + WX;                        // [WY] state column
    int* sx = iy + WY;                        // [WX] statics row
    int* sy = sx + WX;                        // [WY] statics column

    const int x0 = blockIdx.y * G::TX, y0 = blockIdx.x * G::TY;
    const int wx = x0 - h, wy = y0 - h;   // coordinates of window cell 0
    const bool per_x = !BC || code(bc, 0, 0) == CP;
    const bool per_y = !BC || code(bc, 2, 0) == CP;
    const int tid = threadIdx.x;
    const size_t plane = (size_t)nx * ny;
    const int sw = BC ? ny + 2 : ny;
    const size_t splane = BC ? (size_t)(nx + 2) * sw : plane;

    // f(li, lj) for every window cell of [xa, xb] x [ya, yb].  The row
    // t / w comes from a float reciprocal: exact, since (t + 1/2) / w
    // lies at least 1/(2w) from an integer and t < 2^12 keeps the
    // rounding error below 2^-10.
    auto each = [&](int xa, int xb, int ya, int yb, auto&& f) {
        if (xb < xa || yb < ya) return;
        const int w = yb - ya + 1, cnt = (xb - xa + 1) * w;
        const float rw = 1.f / (float)w;
        for (int t = tid; t < cnt; t += G::THREADS) {
            const int i = (int)(((float)t + 0.5f) * rw);
            f(xa + i, ya + (t - i * w));
        }
    };
    // index tables: the state's row/column of a window row/column (wrapped
    // on a periodic axis, clamped to the adjacent interior at a ghost) and
    // the statics' (wrapped, or ghost-inclusive on a D/N axis)
    for (int t = tid; t < WX + WY; t += G::THREADS) {
        const bool xa = t < WX;
        const int X = xa ? wx + t : wy + t - WX, n = xa ? nx : ny;
        const bool per = xa ? per_x : per_y;
        const int i = per ? wrap(X, n) : min(max(X, 0), n - 1);
        (xa ? ix[t] : iy[t - WX]) = i;
        (xa ? sx[t] : sy[t - WX]) = BC ? (per ? i + 1 : X + 1) : i;
    }
    __syncthreads();
    auto load_s = [&](int i, int j, float* s) {
        const size_t g = (size_t)i * sw + j;
#pragma unroll
        for (int c = 0; c < N_STATIC; ++c) s[c] = __ldg(st + c * splane + g);
    };
    auto xghost = [&](int X) { return !per_x && (X < 0 || X >= nx); };
    auto yghost = [&](int Y) { return !per_y && (Y < 0 || Y >= ny); };

    // valid region of the state, window indices (inclusive)
    int xlo = 0, xhi = WX - 1, ylo = 0, yhi = WY - 1;
    if (!per_x) {
        xlo = max(xlo, -1 - wx);
        xhi = min(xhi, nx - wx);
    }
    if (!per_y) {
        ylo = max(ylo, -1 - wy);
        yhi = min(yhi, ny - wy);
    }

    // the state on the window; ghosts from the edge formulas (x, then y).
    // The carry is loaded as read: at a ghost slot it is dead.
    each(xlo, xhi, ylo, yhi, [&](int li, int lj) {
        const int X = wx + li, Y = wy + lj;
        const size_t g = (size_t)ix[li] * ny + iy[lj];
        const int w = li * WY + lj;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            lo[c * NW + w] = lo_in[c * plane + g];
            float v = q[c * plane + g];
            if (xghost(X)) {
                const int e = X < 0 ? 0 : 1;
                v = fill(code(bc, e, c), twoval(bc, e), v);
            }
            if (yghost(Y)) {
                const int e = Y < 0 ? 2 : 3;
                v = fill(code(bc, e, c), twoval(bc, e), v);
            }
            qa[c * NW + w] = v;
        }
    });
    __syncthreads();

    // The flux of the ghost slot across a periodic seam, consumed by the
    // interior cell (li, lj) whose neighbour at -d along x (XAX) or y
    // lies beyond the seam: the neighbour's state (the ghost is its
    // copy) with the ghost's statics and, with thinning, the ghost's
    // one-sided gradient across the seam (centred along the other axis,
    // as at the neighbour: the consumer is interior).
    auto seam_flux = [&](bool XAX, int li, int lj, int d,
                         const float* src) -> CellFlux {
        const int w = li * WY + lj;
        const int wn = XAX ? w - d * WY : w - d;
        float s[N_STATIC];
        load_s(XAX ? (d > 0 ? 0 : nx + 1) : sx[li],
               XAX ? sy[lj] : (d > 0 ? 0 : ny + 1), s);
        const float a = src[wn], b = src[NW + wn], c = src[2 * NW + wn];
        if (!THIN) return closures(a, b, c, s, P);
        const float p = pp[wn], pc = pp[w];
        const float hs = XAX ? T.dx : T.dy, ho = XAX ? T.dy : T.dx;
        const float g_seam = d > 0 ? (pc - p) / hs : (p - pc) / hs;
        const int o = XAX ? 1 : WY;
        const float g_other = ((pp[wn + o] - pp[wn - o]) / ho) / 2.f;
        const float eta = thinning_eta(XAX ? g_seam : g_other,
                                       XAX ? g_other : g_seam, s[2],
                                       shear_viscosity(a, p, P), T);
        return closures_eta(a, b, c, s, p, eta, P);
    };

    for (int pass = 0; pass < 2 * k; ++pass) {
        const bool second = pass & 1;
        const int d = second ? -d0 : d0;
        const float* src = second ? pd : qa;

        if (THIN) {
            each(xlo, xhi, ylo, yhi, [&](int li, int lj) {
                const int w = li * WY + lj;
                pp[w] = eos_pressure(src[w], P);
            });
            __syncthreads();
        }

        // fluxes and sources; thinning reads p at +-1 (at a D/N ghost
        // slot only its interior neighbour)
        int fxlo = xlo, fxhi = xhi, fylo = ylo, fyhi = yhi;
        if (THIN) {
            fxlo += (per_x || wx + xlo != -1);
            fxhi -= (per_x || wx + xhi != nx);
            fylo += (per_y || wy + ylo != -1);
            fyhi -= (per_y || wy + yhi != ny);
        }
        each(fxlo, fxhi, fylo, fyhi, [&](int li, int lj) {
            const int X = wx + li, Y = wy + lj, w = li * WY + lj;
            float s[N_STATIC];
            load_s(sx[li], sy[lj], s);
            const float a = src[w], b = src[NW + w], c = src[2 * NW + w];
            CellFlux f;
            if (THIN) {
                const float p = pp[w];
                // a ghost slot's outer neighbour is dead: index it safely
                const int wxm = xghost(X) && X < 0 ? w : w - WY;
                const int wxp = xghost(X) && X >= nx ? w : w + WY;
                const int wym = yghost(Y) && Y < 0 ? w : w - 1;
                const int wyp = yghost(Y) && Y >= ny ? w : w + 1;
                const float gx = per_x
                    ? ((pp[wxp] - pp[wxm]) / T.dx) / 2.f
                    : grad(X, nx, pp[wxm], p, pp[wxp], T.dx);
                const float gy = per_y
                    ? ((pp[wyp] - pp[wym]) / T.dy) / 2.f
                    : grad(Y, ny, pp[wym], p, pp[wyp], T.dy);
                const float eta = thinning_eta(gx, gy, s[2],
                                               shear_viscosity(a, p, P), T);
                f = closures_eta(a, b, c, s, p, eta, P);
            } else {
                f = closures(a, b, c, s, P);
            }
#pragma unroll
            for (int m = 0; m < 5; ++m) F[m * NW + w] = f.f[m];
#pragma unroll
            for (int m = 0; m < 3; ++m) S[m * NW + w] = f.s[m];
        });
        __syncthreads();

        // the update u = dt * (ddx(Fx) + ddy(Fy) - S) at interior cells:
        // predictor q* = q - u, then the two-sum of the increment
        // ((q* - q) - u) / 2 into (q, q_lo)
        const int uxlo = fxlo + (d > 0), uxhi = fxhi - (d < 0);
        const int uylo = fylo + (d > 0), uyhi = fyhi - (d < 0);
        each(uxlo, uxhi, uylo, uyhi, [&](int li, int lj) {
            const int X = wx + li, Y = wy + lj;
            if (xghost(X) || yghost(Y)) return;     // refilled below
            const int w = li * WY + lj, wxn = w - d * WY, wyn = w - d;
            float fx0 = F[wxn], fx2 = F[2 * NW + wxn], fx3 = F[3 * NW + wxn];
            float fy1 = F[NW + wyn], fy3 = F[3 * NW + wyn];
            float fy4 = F[4 * NW + wyn];
            if (BC && per_x && seam(ix[li], nx, d)) {
                const CellFlux g = seam_flux(true, li, lj, d, src);
                fx0 = g.f[0];
                fx2 = g.f[2];
                fx3 = g.f[3];
            }
            if (BC && per_y && seam(iy[lj], ny, d)) {
                const CellFlux g = seam_flux(false, li, lj, d, src);
                fy1 = g.f[1];
                fy3 = g.f[3];
                fy4 = g.f[4];
            }
            const float md = (float)(-d);
            float u[3];
            u[0] = dt * (md * (fx0 - F[w]) * P.rdx
                         + md * (fy1 - F[NW + w]) * P.rdy - S[w]);
            u[1] = dt * (md * (fx2 - F[2 * NW + w]) * P.rdx
                         + md * (fy3 - F[3 * NW + w]) * P.rdy - S[NW + w]);
            u[2] = dt * (md * (fx3 - F[3 * NW + w]) * P.rdx
                         + md * (fy4 - F[4 * NW + w]) * P.rdy
                         - S[2 * NW + w]);
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                const int i = c * NW + w;
                if (!second) {
                    pd[i] = qa[i] - u[c];
                } else {
                    const float q0 = qa[i];
                    const float delta = ((pd[i] - q0) - u[c]) / 2.f;
                    const float y = delta + lo[i];
                    const float t = q0 + y;
                    lo[i] = y - (t - q0);
                    qa[i] = t;
                }
            }
        });
        __syncthreads();

        // the new valid region: the updated cells, and on a D/N axis the
        // ghost slot next to an updated edge cell once refilled
        xlo = uxlo;
        xhi = uxhi;
        ylo = uylo;
        yhi = uyhi;
        if (!per_x) {
            if (wx < 0 && wx + xlo <= 0) xlo = -1 - wx;
            if (wx + WX > nx && wx + xhi >= nx - 1) xhi = nx - wx;
        }
        if (!per_y) {
            if (wy < 0 && wy + ylo <= 0) ylo = -1 - wy;
            if (wy + WY > ny && wy + yhi >= ny - 1) yhi = ny - wy;
        }
        if (BC && (!per_x || !per_y)) {
            float* dst = second ? qa : pd;
            each(xlo, xhi, ylo, yhi, [&](int li, int lj) {
                const int X = wx + li, Y = wy + lj;
                const bool xg = xghost(X), yg = yghost(Y);
                if (!xg && !yg) return;
                const int ai = xg ? (X < 0 ? li + 1 : li - 1) : li;
                const int aj = yg ? (Y < 0 ? lj + 1 : lj - 1) : lj;
                const int w = li * WY + lj, wa = ai * WY + aj;
#pragma unroll
                for (int c = 0; c < 3; ++c) {
                    float v = dst[c * NW + wa];
                    if (xg) {
                        const int e = X < 0 ? 0 : 1;
                        v = fill(code(bc, e, c), twoval(bc, e), v);
                    }
                    if (yg) {
                        const int e = Y < 0 ? 2 : 3;
                        v = fill(code(bc, e, c), twoval(bc, e), v);
                    }
                    dst[c * NW + w] = v;
                }
            });
            __syncthreads();
        }
    }

    each(h, h + G::TX - 1, h, h + G::TY - 1, [&](int li, int lj) {
        const int X = wx + li, Y = wy + lj;
        if (X >= nx || Y >= ny) return;
        const size_t g = (size_t)X * ny + Y;
        const int w = li * WY + lj;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            out[c * plane + g] = qa[c * NW + w];
            lo_out[c * plane + g] = lo[c * NW + w];
        }
    });
}

// n compensated steps on stream s: n / k sweeps of k steps and one of
// n mod k, each a launch of the template that reads one (q, q_lo) pair
// and writes the other.  The first sweep reads (q, lo); sweep i writes
// A (i even) or B (i odd), each 6 planes: q, then q_lo.  The result is
// in A for an odd number of sweeps, else in B.  The shared-memory
// attribute is set once, for the largest window.  Returns the first
// CUDA error, before any later launch.
template <bool BC, bool THIN>
int comp_sweeps(const float* q, const float* lo, const float* st, float* A,
                float* B, int nx, int ny, int n, int k, int d0, float dt,
                const Params& P, const Bc& bc, const Thin& T, void* s) {
    using G = MultiGeo<THIN>;
    if (k < 1 || k > G::KMAX || n < 1) return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(
        multi_step_kernel<BC, THIN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::smem_bytes(k));
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((ny + G::TY - 1) / G::TY, (nx + G::TX - 1) / G::TX);
    const size_t plane3 = (size_t)3 * nx * ny;
    for (int done = 0, i = 0; done < n; ++i) {
        const int kk = n - done < k ? n - done : k;
        float* dst = i % 2 ? B : A;
        multi_step_kernel<BC, THIN><<<grid, G::THREADS, G::smem_bytes(kk),
                                      (cudaStream_t)s>>>(
            q, lo, st, dst, dst + plane3, nx, ny, kk, d0, dt, P, bc, T);
        e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
        q = dst;
        lo = dst + plane3;
        done += kk;
    }
    return 0;
}

}  // namespace
