"""Blocked Cholesky and lower triangular solve: CUDA kernels, their plain
twins and the differentiable ops.  Opt in with ``GAPFLOW_PALLAS_LINALG=1``.

Counterpart of :mod:`gapflow_tpu.ops.cholesky`.  Two kernels, in
``csrc/cholesky.cu`` (whose head comment gives the design):

- :func:`cholesky_kernel` (replaces ``_chol_kernel``): right-looking
  blocked factorization with 128-wide block columns.  The diagonal tile,
  on one SM, is the critical path: it is factored as 4 x 4 sub-blocks of
  32 (one warp per diagonal sub-block, a thread per row below it, all
  warps on the rank-32 updates), and inverted by products (32 x 32
  inverses built up 32 -> 64 -> 128 by the block formula); the panel and
  the trailing update are float32 products whose tiles are sized per call
  to fill the card.  The next tile and its panel run on a second stream
  (:func:`_side_stream`) while the rest of the trailing update runs;
- :func:`tril_solve_kernel` (replaces ``_trsm_kernel``): every diagonal
  tile of ``L`` inverted in one launch, then per block row
  ``X_k = L_kk^-1 Y_k`` and ``Y_j -= L_jk X_k``.

Beside each is its plain torch twin (``_chol_ref``, ``_trsm_ref``, from
``_chol_tile_ref``, ``_tril_inv_ref`` and ``_mm_ref``): the same blocked
algorithm with the same operations in the same order for every element
(a ragged last block where ``n`` is no multiple of 128), on any device and
in any dtype.  A wrapper takes the twin only for a tensor on the CPU; for
a CUDA tensor it launches the kernel or raises.  Every launch sequence
adds one to its entry in :data:`LAUNCHES`.

:func:`cholesky` and :func:`tril_solve` are the public ops, as
``torch.autograd.Function``s with the JAX package's custom VJPs: Murray
(2016) for the factorization and the triangular-solve adjoint, whose
upper solves are lower solves on anti-diagonally reversed operands, so a
backward pass on the card launches the solve kernel again.  They route
as the JAX package's ops do (:func:`_use_kernel`): the kernels when the
variable is set and the matrix is a float32 CUDA tensor of a covered
size, else ``torch.linalg`` (the JAX package's XLA fallback).
"""

import os

import torch

from . import _build

BLK = 128
SB = 32                      # sub-block of a tile (one warp in the kernels)
_VMEM_LIMIT = 100 * 1024 * 1024

#: Kernel launch sequences per wrapper since the last reset (the twins
#: count nothing).  One call launches :func:`kernel_launches` CUDA
#: kernels.
LAUNCHES = {"cholesky": 0, "tril_solve": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def kernel_launches(n):
    """CUDA kernels one call of each wrapper launches at size ``n``: the
    factorization a ``tril`` copy, then per block column its diagonal
    tile, the panel and the trailing update in two launches, the next
    block column and the rest (the last tile has neither, the one before
    it no rest); the solve one batched launch of every tile inverse, then
    per block row two products (one after the last)."""
    k = n // BLK
    return {"cholesky": 4 * k - 3, "tril_solve": 2 * k}


_SIDE_STREAMS = {}


def _side_stream(device):
    """The factorization's second stream on ``device``, made once, at high
    priority: its one-block diagonal tiles then take an SM as soon as one
    frees up, ahead of the trailing update's queued blocks."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    if index not in _SIDE_STREAMS:
        _SIDE_STREAMS[index] = torch.cuda.Stream(device=index, priority=-1)
    return _SIDE_STREAMS[index]


def fits_vmem(n, itemsize=4, nrhs=0):
    """The JAX package's size cap (its whole-matrix VMEM budget), kept as
    a plain cap so that both packages route the same shapes."""
    return (n * n + 4 * BLK * n + n * max(nrhs, BLK)) * itemsize \
        < 0.6 * _VMEM_LIMIT


def _use_kernel(n, m=0, dtype=torch.float32, device="cpu"):
    """Whether :func:`cholesky` / :func:`tril_solve` take the kernels:
    opted in with ``GAPFLOW_PALLAS_LINALG=1``, float32, ``n % 128 == 0``,
    ``n >= 256``, within :func:`fits_vmem`, on a CUDA device (the JAX
    package's ``_use_pallas`` with the TPU backend replaced)."""
    if os.environ.get("GAPFLOW_PALLAS_LINALG", "0") != "1":
        return False
    return (dtype == torch.float32 and n % BLK == 0 and n >= 2 * BLK
            and fits_vmem(n, nrhs=m)
            and torch.device(device).type == "cuda")


# ---------------------------------------------------------------------------
# Plain twins (the kernels' operations in their order)
# ---------------------------------------------------------------------------

def _mm_ref(A, B):
    """A @ B (batched over leading dimensions) summed over the inner index
    in order, product then sum, as the kernels' products do.  Where an
    operand is triangular the kernels skip its zero terms; adding them
    here changes no value."""
    acc = torch.zeros(A.shape[:-1] + B.shape[-1:], dtype=A.dtype,
                      device=A.device)
    for k in range(A.shape[-1]):
        acc = acc + A[..., :, k:k + 1] * B[..., k:k + 1, :]
    return acc


def _recip(x):
    """1 / x by IEEE division (a tensor numerator: torch's CUDA division by
    a number multiplies by its reciprocal instead)."""
    return torch.ones_like(x) / x


def _chol_tile_ref(T):
    """Lower Cholesky factor of a diagonal tile by the column recurrence
    (``_chol_tile``, with ``c = col * (1 / d)``); reads the lower triangle
    only.  The kernel's sub-blocked order (a warp per 32 x 32 diagonal
    sub-block, a thread per row below it, the rank-32 updates) leaves each
    element's operations and their order as here: every element takes the
    subtractions of the columns j before it in increasing j."""
    T = torch.tril(T)
    b = T.shape[0]
    for j in range(b):
        d = torch.sqrt(torch.clamp(T[j, j], min=1e-30))
        c = T[j + 1:, j] * _recip(d)
        T[j + 1:, j + 1:] = T[j + 1:, j + 1:] - c[:, None] * c[None, :]
        T[j + 1:, j] = c
        T[j, j] = d
    return torch.tril(T)


def _tril_inv_sub_ref(T):
    """Inverse of lower-triangular tiles of at most 32 (batched) by
    forward substitution, right-looking: row l times 1 / T[l, l], then
    eliminated below; element (i, t) takes its subtractions in increasing
    l, as the kernel's warp (lane t, column t) does."""
    b = T.shape[-1]
    V = torch.eye(b, dtype=T.dtype, device=T.device).expand(T.shape)
    V = V.clone()
    for l in range(b):
        V[..., l, :l + 1] = V[..., l, :l + 1] * _recip(T[..., l, l:l + 1])
        V[..., l + 1:, :l + 1] = (V[..., l + 1:, :l + 1]
                                  - T[..., l + 1:, l:l + 1]
                                  * V[..., l:l + 1, :l + 1])
    return V


def _tril_inv_ref(T):
    """Inverse of lower-triangular tiles (batched over leading dimensions)
    by products: the 32 x 32 diagonal blocks by substitution, built up
    32 -> 64 -> 128 with ``[A 0; B C]^-1 = [A^-1 0; -C^-1 (B A^-1), C^-1]``
    (halves of 64 above 64, else of 32).  Reads the lower triangle only."""
    b = T.shape[-1]
    if b <= SB:
        return _tril_inv_sub_ref(T)
    h = 2 * SB if b > 2 * SB else SB
    A, B, C = T[..., :h, :h], T[..., h:, :h], T[..., h:, h:]
    if b == 2 * h:                   # both halves in one batch
        both = _tril_inv_ref(torch.stack((A, C)))
        Ai, Ci = both[0], both[1]
    else:
        Ai, Ci = _tril_inv_ref(A), _tril_inv_ref(C)
    V = torch.zeros_like(T)
    V[..., :h, :h] = Ai
    V[..., h:, h:] = Ci
    V[..., h:, :h] = -_mm_ref(Ci, _mm_ref(B, Ai))
    return V


def _tril_inv_tiles_ref(L):
    """The inverses of all diagonal tiles of ``L`` (the solve's one
    batched launch), as a list per block row; the full tiles in one
    batch, a ragged last tile on its own."""
    n = L.shape[0]
    full = n // BLK * BLK
    tiles = [torch.tril(L[x0:x0 + BLK, x0:x0 + BLK])
             for x0 in range(0, full, BLK)]
    out = list(_tril_inv_ref(torch.stack(tiles))) if tiles else []
    if full < n:
        out.append(_tril_inv_ref(torch.tril(L[full:, full:])))
    return out


def _chol_ref(A):
    """Plain torch twin of :func:`cholesky_kernel`."""
    M = A.clone()
    n = M.shape[0]
    for x0 in range(0, n, BLK):
        x1 = min(x0 + BLK, n)
        L_kk = _chol_tile_ref(M[x0:x1, x0:x1])
        M[x0:x1, x0:x1] = L_kk
        if x1 == n:
            break
        P = _mm_ref(M[x1:, x0:x1], _tril_inv_ref(L_kk).T)
        M[x1:, x1:] = M[x1:, x1:] - _mm_ref(P, P.T)
        M[x1:, x0:x1] = P
    return torch.tril(M)


def _trsm_ref(L, B):
    """Plain torch twin of :func:`tril_solve_kernel`: X = L^-1 B."""
    W = _tril_inv_tiles_ref(L)
    X = torch.empty_like(B)
    Y = B.clone()
    n = L.shape[0]
    for k, x0 in enumerate(range(0, n, BLK)):
        x1 = min(x0 + BLK, n)
        X[x0:x1] = _mm_ref(W[k], Y[x0:x1])
        Y[x1:] = Y[x1:] - _mm_ref(L[x1:, x0:x1], X[x0:x1])
    return X


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _on_cpu(t):
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")
    return False


def _check(t, rows, what):
    if t.dtype != torch.float32:
        raise TypeError(f"{what}: the CUDA kernels take float32, got "
                        f"{t.dtype}")
    if t.ndim != 2 or t.shape[0] != rows:
        raise ValueError(f"{what}: expected {rows} rows, got shape "
                         f"{tuple(t.shape)}")
    if rows % BLK or t.shape[1] % BLK:
        raise ValueError(f"{what}: the kernels take sizes that are "
                         f"multiples of {BLK}, got {tuple(t.shape)}")


def _aligned(t):
    """``t`` contiguous at a 16-byte aligned address (the kernels copy
    rows as 16-byte vectors), copied if it is not."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def cholesky_kernel(A):
    """Lower Cholesky factor of the (n, n) matrix ``A`` (its lower
    triangle is read), upper triangle zero.  CUDA tensors (float32,
    n % 128 == 0) launch the kernels; CPU tensors run :func:`_chol_ref`."""
    if _on_cpu(A):
        return _chol_ref(A)
    n = A.shape[0]
    _check(A, n, "cholesky")
    A = _aligned(A)
    L = torch.empty_like(A)
    W = torch.empty((BLK, BLK), dtype=A.dtype, device=A.device)
    lib = _build.load()
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gf_cholesky(A.data_ptr(), L.data_ptr(), W.data_ptr(), n,
                             stream, _side_stream(A.device).cuda_stream)
    _build.check(lib, rc, "gf_cholesky")
    LAUNCHES["cholesky"] += 1
    return L


def tril_solve_kernel(L, B):
    """X = L^-1 B for the lower-triangular (n, n) ``L`` and (n, m) ``B``.
    CUDA tensors (float32, n and m multiples of 128) launch the kernels;
    a non-contiguous or unaligned operand (the reversed operands of the
    upper solve) is copied first.  CPU tensors run :func:`_trsm_ref`."""
    if _on_cpu(L):
        return _trsm_ref(L, B)
    n = L.shape[0]
    _check(L, n, "tril_solve L")
    _check(B, n, "tril_solve B")
    if B.device != L.device:
        raise ValueError(f"tensors on different devices: {L.device} and "
                         f"{B.device}")
    L = _aligned(L)
    B = _aligned(B)
    m = B.shape[1]
    X = torch.empty_like(B)
    W = torch.empty((n // BLK, BLK, BLK), dtype=L.dtype, device=L.device)
    Y = torch.empty_like(B)
    lib = _build.load()
    with torch.cuda.device(L.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gf_tril_solve(L.data_ptr(), B.data_ptr(), X.data_ptr(),
                               W.data_ptr(), Y.data_ptr(), n, m, stream)
    _build.check(lib, rc, "gf_tril_solve")
    LAUNCHES["tril_solve"] += 1
    return X


# ---------------------------------------------------------------------------
# Differentiable ops
# ---------------------------------------------------------------------------

def _chol(A):
    if _use_kernel(A.shape[0], dtype=A.dtype, device=A.device):
        return cholesky_kernel(A)
    L, info = torch.linalg.cholesky_ex(A)
    # not positive definite: all NaN, as the JAX package's factorization
    return torch.where(info == 0, L, torch.full_like(L, float("nan")))


def _solve(L, B):
    if (B.ndim == 2 and B.shape[1] % BLK == 0
            and _use_kernel(L.shape[0], B.shape[1], L.dtype, L.device)):
        return tril_solve_kernel(L, B)
    if B.ndim == 1:
        return torch.linalg.solve_triangular(L, B[:, None], upper=False)[:, 0]
    return torch.linalg.solve_triangular(L, B, upper=False)


def _rev(M):
    return M.flip(tuple(range(M.ndim)))


def _up_solve(L, B):
    """X = L^-T B with the lower solver (an upper-triangular solve is a
    lower one on anti-diagonally reversed operands)."""
    return _rev(_solve(_rev(L.T), _rev(B)))


class _Cholesky(torch.autograd.Function):
    @staticmethod
    def forward(ctx, A):
        L = _chol(A)
        ctx.save_for_backward(L)
        return L

    @staticmethod
    def backward(ctx, Lbar):
        # Murray (2016): Abar = 1/2 L^-T (Phi(L^T Lbar) + Phi(L^T Lbar)^T)
        # L^-1 with Phi = tril with halved diagonal (a symmetric cotangent)
        (L,) = ctx.saved_tensors
        M = L.T @ Lbar
        P = torch.tril(M) - 0.5 * torch.diag(torch.diagonal(M))
        Psym = 0.5 * (P + P.T)
        T1 = _up_solve(L, Psym)          # L^-T Psym
        return _up_solve(L, T1.T).T      # T1 L^-1


class _TrilSolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, L, B):
        X = _solve(L, B)
        ctx.save_for_backward(L, X)
        return X

    @staticmethod
    def backward(ctx, Xbar):
        # X = L^-1 B  =>  Bbar = L^-T Xbar,  Lbar = -tril(Bbar X^T)
        L, X = ctx.saved_tensors
        Bbar = _up_solve(L, Xbar)
        outer = (Bbar[:, None] * X[None, :] if X.ndim == 1
                 else Bbar @ X.T)
        return -torch.tril(outer), Bbar


def cholesky(A):
    """Lower Cholesky factor, differentiable; the blocked kernel where
    :func:`_use_kernel` allows it."""
    return _Cholesky.apply(A)


def tril_solve(L, B):
    """X = L^-1 B for lower-triangular L, differentiable; the blocked
    kernel where :func:`_use_kernel` allows it."""
    return _TrilSolve.apply(L, B)
