"""The port's blocked Cholesky and triangular solve (ops/cholesky.py)
against the JAX package's (CPU).

- the plain twins against the Pallas kernels ``_pallas_cholesky`` /
  ``_pallas_tril_solve`` in interpret mode, float32, within the
  reference's own tolerance for its kernels (rtol 2e-4, atol 5e-5,
  tests/test_cholesky.py);
- the tile twins (the factor and the inverse by products) against the
  JAX package's ``_chol_tile`` and ``_tril_inv_tile`` (plain jnp) at
  float64 and float32, on an SPD tile and a GP Gram tile of condition
  number about 1e4; the solve's batched tile-inverse twin against
  ``_tril_inv_tile`` per tile;
- both autograd Functions against ``jax.grad`` of the JAX package's
  custom VJPs at float64, forward and backward routed through the twins
  (the gate forced open: on the CPU a kernel wrapper runs its twin) and
  through ``torch.linalg``;
- the GP marginal-likelihood gradient through the port's ops against
  ``jax.grad`` of the JAX package's ``nlml``;
- the gate's truth table.

The CUDA kernels themselves are held to the twins in
``tests/test_torch_gpu.py`` (marker ``gpu``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from gapflow_tpu.models import gp as jgp
from gapflow_tpu.ops import cholesky as jchol

from gapflow_torch.models import gp as tgp
from gapflow_torch.ops import cholesky as tchol

F64 = torch.float64


def _spd(n, seed=0):
    A = np.random.default_rng(seed).standard_normal((n, n))
    return A @ A.T / n + np.eye(n)


@pytest.fixture(params=["twins", "library"])
def route(request, monkeypatch):
    """Route the ops through the kernel wrappers (their twins on the
    CPU) or through torch.linalg."""
    if request.param == "twins":
        monkeypatch.setattr(tchol, "_use_kernel", lambda *a, **k: True)
    return request.param


@pytest.mark.parametrize("n", [256, 384, 512])
def test_chol_twin_matches_pallas_interpret(n):
    from jax.experimental.pallas import tpu as pltpu
    A = _spd(n).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jchol._pallas_cholesky(jnp.asarray(A)))
    out = tchol._chol_ref(torch.tensor(A)).numpy()
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=5e-5)
    assert np.array_equal(out, np.tril(out))


@pytest.mark.parametrize("n", [256, 384, 512])
def test_trsm_twin_matches_pallas_interpret(n):
    from jax.experimental.pallas import tpu as pltpu
    L = np.linalg.cholesky(_spd(n)).astype(np.float32)
    B = np.random.default_rng(1).standard_normal((n, 128)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jchol._pallas_tril_solve(jnp.asarray(L),
                                                  jnp.asarray(B)))
    out = tchol._trsm_ref(torch.tensor(L), torch.tensor(B)).numpy()
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=5e-5)


def _gram(n, cond=1e4, seed=7):
    """A GP's noisy RBF Gram matrix on n points of the unit square, the
    noise set so that its condition number is about ``cond``."""
    x = np.random.default_rng(seed).random((n, 2))
    K = np.exp(-((x[:, None] - x[None]) ** 2).sum(-1) / (2 * 0.3 ** 2))
    return K + np.linalg.eigvalsh(K)[-1] / cond * np.eye(n)


# (tile, dtype, rtol, atol): float64 to 1e-12 of the reference (the two
# differ in rounding only: the JAX tile inverse is Newton-Schulz, the
# twin the block formula); float32 within the kernels' tolerance
TILE_CASES = [(np.float64, 1e-12, 1e-12), (np.float32, 2e-4, 5e-5)]


@pytest.mark.parametrize("dtype,rtol,atol", TILE_CASES)
@pytest.mark.parametrize("tile", ["spd", "gram"])
def test_tile_twins_match_jax_tiles(tile, dtype, rtol, atol):
    """The diagonal tile's factor (``_chol_tile_ref``) and its inverse by
    products (``_tril_inv_ref``) against the JAX package's ``_chol_tile``
    and ``_tril_inv_tile`` on one 128 tile; the inverse of the same
    factor in both, so that it is compared on its own.  ``_tril_inv_tile``
    computes in float32 only (its products' ``preferred_element_type``),
    so at float64 the inverse is held against the JAX package's
    ``tril_solve`` of the identity (XLA's triangular solve)."""
    A = _spd(128) if tile == "spd" else _gram(128)
    if tile == "gram":
        assert 3e3 < np.linalg.cond(A) < 3e4
    A = A.astype(dtype)
    L_j = np.asarray(jchol._chol_tile(jnp.asarray(A)))
    L_t = tchol._chol_tile_ref(torch.tensor(A)).numpy()
    np.testing.assert_allclose(L_t, L_j, rtol=rtol, atol=atol)
    if dtype == np.float32:
        W_j = np.asarray(jchol._tril_inv_tile(jnp.asarray(L_j)))
    else:
        W_j = np.asarray(jchol.tril_solve(jnp.asarray(L_j),
                                          jnp.eye(128, dtype=dtype)))
    W_t = tchol._tril_inv_ref(torch.tensor(L_j)).numpy()
    np.testing.assert_allclose(W_t, W_j, rtol=rtol, atol=atol)
    assert np.array_equal(W_t, np.tril(W_t))


@pytest.mark.parametrize("n", [384, 448])
def test_batched_tile_inverses_match_jax_per_tile(n):
    """The solve's all-tiles inverse twin (one batch, the ragged last
    tile of 448 on its own) against ``_tril_inv_tile`` tile by tile
    (float32, the kernels' tolerance), and the batch against the twin of
    each tile alone, bit for bit."""
    L = np.linalg.cholesky(_gram(n, seed=n)).astype(np.float32)
    Ws = tchol._tril_inv_tiles_ref(torch.tensor(L))
    assert len(Ws) == -(-n // 128)
    for k, W in enumerate(Ws):
        x0, x1 = 128 * k, min(128 * k + 128, n)
        tile = L[x0:x1, x0:x1]
        ref = np.asarray(jchol._tril_inv_tile(jnp.asarray(tile)))
        np.testing.assert_allclose(W.numpy(), ref, rtol=2e-4, atol=5e-5)
        assert torch.equal(W, tchol._tril_inv_ref(torch.tensor(tile)))


def test_cholesky_vjp_matches_jax(route):
    A = _spd(40, seed=2)
    g_j = np.asarray(jax.grad(
        lambda a: jnp.sum(jnp.sin(jchol.cholesky(a))))(jnp.asarray(A)))
    X = torch.tensor(A, dtype=F64, requires_grad=True)
    L = tchol.cholesky(X)
    np.testing.assert_allclose(L.detach().numpy(), np.linalg.cholesky(A),
                               rtol=1e-12, atol=1e-14)
    torch.sum(torch.sin(L)).backward()
    np.testing.assert_allclose(X.grad.numpy(), g_j, rtol=1e-9, atol=1e-11)


def test_tril_solve_vjp_matches_jax(route):
    L = np.linalg.cholesky(_spd(40, seed=3))
    B = np.random.default_rng(4).standard_normal((40, 3))

    def f(l, b):
        return jnp.sum(jnp.cos(jchol.tril_solve(l, b)))

    gL_j, gB_j = jax.grad(f, argnums=(0, 1))(jnp.asarray(L), jnp.asarray(B))
    Lt = torch.tensor(L, dtype=F64, requires_grad=True)
    Bt = torch.tensor(B, dtype=F64, requires_grad=True)
    torch.sum(torch.cos(tchol.tril_solve(Lt, Bt))).backward()
    np.testing.assert_allclose(Bt.grad.numpy(), np.asarray(gB_j), rtol=1e-9,
                               atol=1e-11)
    np.testing.assert_allclose(np.tril(Lt.grad.numpy()),
                               np.tril(np.asarray(gL_j)), rtol=1e-9,
                               atol=1e-11)


def test_nlml_gradient_matches_jax(route):
    """The port's nlml factors and solves through ops.cholesky; its
    autograd gradient equals jax.grad of the JAX package's nlml (whose
    factorization is XLA's, differentiated by JAX)."""
    n, d = 64, 3
    rng = np.random.default_rng(5)
    X, Y = rng.standard_normal((n, d)), rng.standard_normal(n)
    p = {"log_amp": np.asarray(0.3), "log_scale": np.array([0.1, -0.2, 0.4])}
    v_j, g_j = jax.jit(jax.value_and_grad(
        lambda q: jgp.nlml(q, jnp.asarray(X), jnp.asarray(Y), 0.1)))(
        {k: jnp.asarray(v) for k, v in p.items()})
    tp = {k: torch.tensor(v, dtype=F64, requires_grad=True)
          for k, v in p.items()}
    val = tgp.nlml(tp, torch.tensor(X), torch.tensor(Y), 0.1)
    np.testing.assert_allclose(float(val.detach()), float(v_j), rtol=1e-12)
    val.backward()
    for k in p:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(g_j[k]),
                                   rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("env,dtype,n,m,device,expected", [
    ("1", torch.float32, 256, 0, "cuda", True),
    ("1", torch.float32, 2048, 2048, "cuda", True),
    ("0", torch.float32, 256, 0, "cuda", False),       # not opted in
    ("1", torch.float64, 256, 0, "cuda", False),       # float32 only
    ("1", torch.float32, 128, 0, "cuda", False),       # n >= 256
    ("1", torch.float32, 320, 0, "cuda", False),       # n % 128
    ("1", torch.float32, 4096, 0, "cuda", False),      # the size cap
    ("1", torch.float32, 3840, 2048, "cuda", False),   # the cap with m
    ("1", torch.float32, 256, 0, "cpu", False),        # a CUDA tensor
])
def test_gate_truth_table(monkeypatch, env, dtype, n, m, device, expected):
    monkeypatch.setenv("GAPFLOW_PALLAS_LINALG", env)
    assert tchol._use_kernel(n, m, dtype, device) is expected
    assert tchol.fits_vmem(n, nrhs=m) == jchol.fits_vmem(n, nrhs=m)


@pytest.mark.parametrize("n,expected", [(128, (1, 2)), (256, (5, 4)),
                                        (2048, (61, 32))])
def test_kernel_launches_per_call(n, expected):
    """The CUDA kernels one call launches (chip_smoke.py phase 2k holds the
    profiler's count to these): the factorization a tril copy and per
    block column its tile, panel and two trailing-update launches; the
    solve one batched tile-inverse launch and two products a block row."""
    assert tuple(tchol.kernel_launches(n).values()) == expected


def test_tril_solve_gate_needs_blocked_rhs(monkeypatch):
    """On the CPU the gate is closed; with it forced open, only a 2-D B of
    a multiple of 128 columns takes the kernel wrapper (its twin here)."""
    monkeypatch.setenv("GAPFLOW_PALLAS_LINALG", "1")
    L = torch.linalg.cholesky(torch.tensor(_spd(256), dtype=torch.float32))
    B = torch.ones((256, 128))
    assert not tchol._use_kernel(256, 128, L.dtype, L.device)
    calls = []
    monkeypatch.setattr(tchol, "_use_kernel", lambda *a, **k: True)
    monkeypatch.setattr(tchol, "tril_solve_kernel",
                        lambda L, B: calls.append(B.shape)
                        or tchol._trsm_ref(L, B))
    tchol.tril_solve(L, B)
    tchol.tril_solve(L, B[:, :100])
    tchol.tril_solve(L, B[:, 0])
    assert calls == [(256, 128)]
    assert tchol.LAUNCHES == {"cholesky": 0, "tril_solve": 0}
