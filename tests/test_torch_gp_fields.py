"""The GP means of the port's fields kernel, through its plain twin
``gp_fields_ref``, against the JAX package's ``_gp_mean`` (CPU).

For every feature count D = 1-7 and output count NOUT = 1-2 (the 14
bodies ``csrc/stencil_gp.cu`` compiles), a surrogate with D active
features drawn from the 7 built-ins and 24 training points, the features
of a 6 x 10 state, all from one numpy generator: the twin against
``gapflow_tpu.ops.stencil_gp._gp_mean`` at float64 (scaled 1e-12: the
same operations, summed by Python's ``sum`` there) and at float32 (scaled
2e-5, the JAX package's bar for its kernels), and against the port's
``_gp_mean``, exactly.  On CPU tensors ``gp_fields`` is the twin.  The
CUDA kernel itself runs only on a GPU: tests/test_torch_gpu.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from gapflow_tpu.ops import stencil_gp as JG

from gapflow_torch.ops import stencil_gp as G

SHAPES = [(d, n_out) for d in range(1, 8) for n_out in (1, 2)]
CAP, A, B = 24, 6, 10


def surrogate(d, n_out, seed):
    """(q, statics, dims, coef, Ws, alpha) as numpy float64 arrays: a
    state whose 7 features are O(1), and a surrogate with unit-scale
    training inputs Ws (the sqrt(3)-scaled Xfit / ls)."""
    rng = np.random.default_rng(seed)
    q = rng.uniform(0.5, 1.5, (3, A, B))
    statics = rng.uniform(0.5, 1.5, (8, A, B))
    dims = tuple(int(i) for i in rng.choice(7, size=d, replace=False))
    coef = rng.uniform(0.5, 2., d)
    Ws = rng.uniform(0., 2., (CAP, d))
    alpha = rng.normal(size=(CAP, n_out))
    return q, statics, dims, coef, Ws, alpha


def port_ops(dims, coef, Ws, alpha, dtype):
    def t(a):
        return torch.as_tensor(a, dtype=dtype)
    Wm2 = t(-2. * Ws)
    w2 = t(np.sum(Ws * Ws, axis=1) + 3e-14)
    return G.GPOps({"z": (dims, t(coef), Wm2, w2, t(alpha))}, "cpu")


def jax_mean(q, statics, dims, ops, dtype):
    _, coef, Wm2, w2, alpha = ops.models["z"]
    feats = JG._features7(*(jnp.asarray(a, dtype) for a in q),
                          jnp.asarray(statics, dtype))
    out = JG._gp_mean(feats, dims, jnp.asarray(coef.numpy())[None, :],
                      jnp.asarray(Wm2.numpy()),
                      jnp.asarray(w2.numpy())[:, None],
                      jnp.asarray(alpha.numpy()), alpha.shape[1])
    return np.stack([np.asarray(a) for a in out])


@pytest.mark.parametrize("dtype, tol", [(torch.float64, 1e-12),
                                        (torch.float32, 2e-5)])
@pytest.mark.parametrize("d, n_out", SHAPES)
def test_gp_fields_twin_matches_jax_gp_mean(d, n_out, dtype, tol):
    q, statics, dims, coef, Ws, alpha = surrogate(d, n_out, 10 * d + n_out)
    ops = port_ops(dims, coef, Ws, alpha, dtype)
    qt = torch.as_tensor(q, dtype=dtype)
    st = torch.as_tensor(statics, dtype=dtype)
    got = G.gp_fields_ref(qt, st, ops)
    assert list(got) == ["z"] and got["z"].shape == (n_out, A, B)
    ref = jax_mean(q, statics, dims, ops,
                   jnp.float64 if dtype == torch.float64 else jnp.float32)
    assert ref.dtype == (np.float64 if dtype == torch.float64
                         else np.float32)
    out = got["z"].numpy()
    assert np.abs(out - ref).max() <= tol * np.abs(ref).max()
    # the port's _gp_mean on the same features, exactly
    feats = G._features7(qt[0], qt[1], qt[2], st)
    same = G._gp_mean(feats, ops.floats()["z"])
    assert all(torch.equal(a, b) for a, b in zip(got["z"], same))
    # on CPU tensors the wrapper is the twin
    wrapped = G.gp_fields(qt, st, ops)
    assert torch.equal(wrapped["z"], got["z"])


def test_gp_fields_of_three_surrogates_and_their_planes():
    """The keys come back in the order z, x, y with their own output
    counts, each equal to the surrogate's mean alone; ``planes`` counts
    the kernel's field planes and ``device_args`` pads each row to a
    multiple of 4 floats."""
    q, statics = (torch.as_tensor(a, dtype=torch.float32)
                  for a in surrogate(1, 1, 0)[:2])
    models, alone = {}, {}
    for key, (d, n_out) in zip(G.KEYS, [(2, 1), (3, 2), (7, 2)]):
        _, _, dims, coef, Ws, alpha = surrogate(d, n_out, d)
        ops = port_ops(dims, coef, Ws, alpha, torch.float32)
        models[key] = ops.models["z"]
        alone[key] = G.gp_fields_ref(q, statics, ops)["z"]
    ops = G.GPOps(models, "cpu")
    got = G.gp_fields_ref(q, statics, ops)
    assert list(got) == list(G.KEYS)
    assert all(torch.equal(got[k], alone[k]) for k in G.KEYS)
    assert ops.planes() == 5
    meta, _, data = ops.device_args()
    assert list(meta[:, 0]) == [1, 1, 1] and list(meta[:, 1]) == [2, 3, 7]
    assert list(meta[:, 4]) == [0, CAP * 4, CAP * 4 + CAP * 8]
    assert data.numel() == CAP * (4 + 8 + 12)
    # a row: [Wm2, w2, alpha, zeros]
    Wm2, w2, alpha = (models["x"][i][0] for i in (2, 3, 4))
    row = data[CAP * 4:CAP * 4 + 8]
    assert torch.equal(row, torch.cat([Wm2, w2[None], alpha,
                                       torch.zeros(2)]))
    assert G.kernel_launches(ops) == 4
    assert G.kernel_launches(G.GPOps({}, "cpu")) == 2
