"""CUDA kernels of the port against their plain twins, on a GPU.

The kernels have no CPU mode, so these tests skip without a CUDA device.
This file imports no JAX; on a machine without it, run

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -m gpu
"""

import pytest
import torch

from gapflow_torch import Problem
from gapflow_torch.ops import stencil as S
from gapflow_torch.validate import kernel_vs_plain_err, perturbed_state

SIM = """
options: {output: data/torch_gpu, write_freq: 1000, silent: True}
grid: {dx: 2.e-5, dy: 2.e-5, Nx: 40, Ny: 72}
geometry: {type: journal, CR: 1.e-2, eps: 0.7, U: 0.1, V: 0.}
numerics: {CFL: 0.5, adaptive: 0, tol: 1e-30, dt: 5e-11, max_it: 10}
properties: {shear: 0.0794, bulk: 0., EOS: DH, P0: 101325.,
             rho0: 877.7007, C1: 3.5e10, C2: 1.23}
"""


@pytest.fixture
def cuda_problem():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    p = Problem.from_string(SIM, device="cuda", dtype=torch.float32)
    p._pre_run()
    return p


def _inputs(p):
    st = perturbed_state(p, seed=0, amp=0.01)
    q = st.q[:, 1:-1, 1:-1].contiguous()
    return q, S.interior_statics(st.topo, st.extra, torch.float32,
                                 q.device), p.dt


@pytest.mark.gpu
@pytest.mark.parametrize("emit_delta", [False, True])
def test_fused_step_matches_twin(cuda_problem, emit_delta):
    """Ragged tiles (40 x 72 is no multiple of the 8 x 32 tile)."""
    cfg = cuda_problem._solver_cfg
    q, st, dt = _inputs(cuda_problem)
    out = S.fused_step(q, st, dt, cfg, emit_delta=emit_delta)
    ref = S.fused_step_ref(q, st, dt, cfg, emit_delta=emit_delta)
    assert kernel_vs_plain_err(out, ref) < 1e-5


@pytest.mark.gpu
def test_comp_steps_matches_twin(cuda_problem):
    cfg = cuda_problem._solver_cfg
    q, st, dt = _inputs(cuda_problem)
    lo = torch.zeros_like(q)
    qk, lk = S.comp_steps(q, lo, st, dt, cfg, 8)
    qr, _ = S.comp_steps_ref(q, lo, st, dt, cfg, 8)
    assert kernel_vs_plain_err(qk, qr) < 1e-5
    assert torch.isfinite(lk).all()
    assert torch.equal(lo, torch.zeros_like(q))     # inputs untouched


@pytest.mark.gpu
def test_run_takes_the_kernels(cuda_problem):
    S.reset_launches()
    cuda_problem.run()
    assert cuda_problem._route == "run_compiled_fast"
    assert S.LAUNCHES == {"comp_step": 8, "fused_step": 2}


@pytest.mark.gpu
def test_wrapper_rejects_float64(cuda_problem):
    q, st, dt = _inputs(cuda_problem)
    with pytest.raises(TypeError):
        S.fused_step(q.double(), st.double(), dt, cuda_problem._solver_cfg)
