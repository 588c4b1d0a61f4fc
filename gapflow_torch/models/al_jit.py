"""Fixed-capacity padded GP buffers for the device stepping loops.

Counterpart of :mod:`gapflow_tpu.models.al_jit` (``PaddedGP``,
``condition``, ``init``, ``predict``, ``append``; the Adam ``refit`` and
the compiled ``active_learning_loop`` belong to the JAX package's
experimental all-device loop and are not ported).  The training set lives
in ``capacity`` rows; inactive rows are an identity block of the kernel
matrix, so the inverse factor is blockdiag(chol(K)^{-1}, I), padded alpha
rows are zero, and means and variances over the active block are exact.
"""

from typing import NamedTuple

import torch

from .gp import (cholesky, kernel_fn, _invert_cholesky, _outputs_first,
                 _weights_from_inv)


class PaddedGP(NamedTuple):
    """Fixed-capacity GP state."""

    params: dict          # {log_amp, log_scale}
    X: torch.Tensor       # (capacity, d) inputs; rows >= count are padding
    Y: torch.Tensor       # (capacity,) or (capacity, m) targets; padding = 0
    count: int            # number of active rows
    Linv: torch.Tensor    # (capacity, capacity) INVERSE Cholesky factor
    alpha: torch.Tensor   # like Y: K^{-1} Y with padding rows = 0
    yerr: torch.Tensor    # () observation noise std


def _row_mask(capacity, count, like):
    return (torch.arange(capacity, device=like.device)
            < count).to(like.dtype)


def masked_gram(params, X, count, yerr):
    """Kernel matrix with inactive rows/cols replaced by an identity block."""
    n = X.shape[0]
    K = kernel_fn(params, X, X)
    K = 0.5 * (K + K.T)
    amp = torch.exp(params["log_amp"])
    i = torch.arange(n, device=X.device)
    K[i, i] = amp + yerr ** 2

    m = _row_mask(n, count, K)
    active = m[:, None] * m[None, :]
    eye = torch.eye(n, dtype=K.dtype, device=K.device)
    return K * active + eye * ((1. - m)[None, :] * (1. - m)[:, None])


def condition(gp: PaddedGP) -> PaddedGP:
    """Full (re)factorization of the masked gram; O(capacity^3)."""
    K = masked_gram(gp.params, gp.X, gp.count, gp.yerr)
    L = cholesky(K)
    Linv = _invert_cholesky(L)
    alpha, _ = _weights_from_inv(Linv, gp.Y)
    return gp._replace(Linv=Linv, alpha=alpha)


def init(params, capacity, X0, Y0, yerr):
    """Build a PaddedGP from initial data (n0 <= capacity rows), in the
    dtype and on the device of ``X0``."""
    n0, d = X0.shape
    X = X0.new_zeros((capacity, d))
    X[:n0] = X0
    Y = Y0.new_zeros((capacity,) + tuple(Y0.shape[1:]))
    Y[:n0] = Y0
    gp = PaddedGP(params=params, X=X, Y=Y, count=int(n0),
                  Linv=torch.eye(capacity, dtype=X0.dtype, device=X0.device),
                  alpha=torch.zeros_like(Y),
                  yerr=torch.as_tensor(yerr, dtype=X0.dtype,
                                       device=X0.device))
    return condition(gp)


def cast(gp: PaddedGP, dtype=None, device=None) -> PaddedGP:
    """The same buffers in another dtype and/or on another device."""
    def to(t):
        return t.to(dtype=dtype, device=device)
    return gp._replace(params={k: to(v) for k, v in gp.params.items()},
                       X=to(gp.X), Y=to(gp.Y), Linv=to(gp.Linv),
                       alpha=to(gp.alpha), yerr=to(gp.yerr))


def predict(gp: PaddedGP, Xtest):
    """Masked predictive mean(s) and variance at Xtest."""
    Ks = kernel_fn(gp.params, gp.X, Xtest)
    m = _row_mask(gp.X.shape[0], gp.count, Ks)
    Ks = Ks * m[:, None]

    mean = Ks.T @ gp.alpha
    v = gp.Linv @ Ks
    amp = torch.exp(gp.params["log_amp"])
    var = amp + gp.yerr ** 2 - torch.sum(v * v, dim=0)
    return _outputs_first(mean), var


def append(gp: PaddedGP, x_new, y_new) -> PaddedGP:
    """Add one training point at index ``count`` in O(n^2)."""
    cap = gp.X.shape[0]
    idx = gp.count

    X = gp.X.clone()
    X[idx] = x_new
    Y = gp.Y.clone()
    Y[idx] = y_new

    k_vec = kernel_fn(gp.params, X, x_new[None, :])[:, 0]
    k_vec = k_vec * _row_mask(cap, idx, k_vec)     # only active rows

    w = gp.Linv @ k_vec
    amp = torch.exp(gp.params["log_amp"])
    dval = torch.sqrt(torch.clamp(amp + gp.yerr ** 2 - w @ w, min=1e-12))

    # the new row of Linv at position idx replaces that row's identity
    # padding: w is zero in the padding rows, so (Linv^T w)[idx:] = 0 and
    # only the [idx, idx] entry needs fixing
    bottom = -(gp.Linv.T @ w) / dval
    Linv = gp.Linv.clone()
    Linv[idx, :] = bottom
    Linv[idx, idx] = 1. / dval
    alpha, _ = _weights_from_inv(Linv, Y)

    return gp._replace(X=X, Y=Y, count=idx + 1, Linv=Linv, alpha=alpha)
