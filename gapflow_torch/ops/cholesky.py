"""Blocked Cholesky and lower triangular solve: CUDA kernels, their plain
twins and the differentiable ops.  Opt in with ``GAPFLOW_PALLAS_LINALG=1``.

Counterpart of :mod:`gapflow_tpu.ops.cholesky`.  Two kernels, in
``csrc/cholesky.cu``:

- :func:`cholesky_kernel` (replaces ``_chol_kernel``): right-looking
  blocked factorization with 128-wide block columns: the diagonal tile by
  the column recurrence in one thread block's shared memory, its inverse
  by forward substitution, the panel and the trailing update as tiled
  float32 products;
- :func:`tril_solve_kernel` (replaces ``_trsm_kernel``): the blocked solve
  ``L X = B`` per block row, ``X_k = L_kk^-1 X_k`` and ``X_j -= L_jk X_k``.

Beside each is its plain torch twin (``_chol_ref``, ``_trsm_ref``): the
same blocked algorithm with the same operations in the same order (a
ragged last block where ``n`` is no multiple of 128), on any device and
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
_VMEM_LIMIT = 100 * 1024 * 1024

#: Kernel launch sequences per wrapper since the last reset (the twins
#: count nothing).  One call of :func:`cholesky_kernel` launches
#: ``3 n / 128 - 1`` kernels, one of :func:`tril_solve_kernel`
#: ``3 n / 128 - 1`` (:func:`kernel_launches`).
LAUNCHES = {"cholesky": 0, "tril_solve": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def kernel_launches(n):
    """CUDA kernels one call of either wrapper launches at size ``n``."""
    return 3 * (n // BLK) - 1


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
    """A @ B summed over the inner index in order, product then sum, as
    the kernels' tiled products do."""
    acc = torch.zeros((A.shape[0], B.shape[1]), dtype=A.dtype,
                      device=A.device)
    for k in range(A.shape[1]):
        acc = acc + A[:, k:k + 1] * B[k:k + 1, :]
    return acc


def _chol_tile_ref(T):
    """Lower Cholesky factor of a diagonal tile by the column recurrence
    (``_chol_tile``); reads the lower triangle only."""
    T = torch.tril(T)
    b = T.shape[0]
    for j in range(b):
        d = torch.sqrt(torch.clamp(T[j, j], min=1e-30))
        c = T[j + 1:, j] / d
        T[j + 1:, j + 1:] = T[j + 1:, j + 1:] - c[:, None] * c[None, :]
        T[j + 1:, j] = c
        T[j, j] = d
    return torch.tril(T)


def _tril_inv_ref(T):
    """Inverse of a lower-triangular tile by right-looking forward
    substitution: row l divided by T[l, l], then eliminated below."""
    b = T.shape[0]
    V = torch.eye(b, dtype=T.dtype, device=T.device)
    for l in range(b):
        V[l, :l + 1] = V[l, :l + 1] / T[l, l]
        V[l + 1:, :l + 1] = (V[l + 1:, :l + 1]
                             - T[l + 1:, l:l + 1] * V[l:l + 1, :l + 1])
    return V


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
    X = B.clone()
    n = L.shape[0]
    for x0 in range(0, n, BLK):
        x1 = min(x0 + BLK, n)
        T = _mm_ref(_tril_inv_ref(torch.tril(L[x0:x1, x0:x1])), X[x0:x1])
        X[x1:] = X[x1:] - _mm_ref(L[x1:, x0:x1], T)
        X[x0:x1] = T
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


def cholesky_kernel(A):
    """Lower Cholesky factor of the (n, n) matrix ``A`` (its lower
    triangle is read), upper triangle zero.  CUDA tensors (float32,
    n % 128 == 0) launch the kernels; CPU tensors run :func:`_chol_ref`."""
    if _on_cpu(A):
        return _chol_ref(A)
    n = A.shape[0]
    _check(A, n, "cholesky")
    A = A.contiguous()
    L = torch.empty_like(A)
    W = torch.empty((BLK, BLK), dtype=A.dtype, device=A.device)
    P = torch.empty((n, BLK), dtype=A.dtype, device=A.device)
    lib = _build.load()
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gf_cholesky(A.data_ptr(), L.data_ptr(), W.data_ptr(),
                             P.data_ptr(), n, stream)
    _build.check(lib, rc, "gf_cholesky")
    LAUNCHES["cholesky"] += 1
    return L


def tril_solve_kernel(L, B):
    """X = L^-1 B for the lower-triangular (n, n) ``L`` and (n, m) ``B``.
    CUDA tensors (float32, n and m multiples of 128) launch the kernels;
    a non-contiguous operand (the reversed operands of the upper solve) is
    copied contiguous first.  CPU tensors run :func:`_trsm_ref`."""
    if _on_cpu(L):
        return _trsm_ref(L, B)
    n = L.shape[0]
    _check(L, n, "tril_solve L")
    _check(B, n, "tril_solve B")
    if B.device != L.device:
        raise ValueError(f"tensors on different devices: {L.device} and "
                         f"{B.device}")
    L = L.contiguous()
    B = B.contiguous()
    m = B.shape[1]
    X = torch.empty_like(B)
    W = torch.empty((BLK, BLK), dtype=L.dtype, device=L.device)
    T = torch.empty((BLK, m), dtype=L.dtype, device=L.device)
    lib = _build.load()
    with torch.cuda.device(L.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gf_tril_solve(L.data_ptr(), B.data_ptr(), X.data_ptr(),
                               W.data_ptr(), T.data_ptr(), n, m, stream)
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
