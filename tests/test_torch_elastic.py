"""The port's elastic half-space agrees with the JAX package's (CPU, f64).

Every half-space (fully periodic, semi-periodic with images on either
axis, free, and the semi-periodic 1D line contact that becomes a free
line contact) under both ``fft_grid`` conventions, on pressures drawn
with numpy: the deformation within 1e-12 of max|u|.  The 36 x 36 grid
puts the ghost convention's 38-point axes (2 x 19) on the JAX package's
mixed-radix FFT path (``ops/specfft.py``), which the port replaces by
``torch.fft`` at every size.  Also the Green's function, the
under-relaxed fixed point and ``Topography.update()`` through a Problem.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from gapflow_tpu import Problem as JProblem
from gapflow_tpu.elastic import ElasticDeformation as JElastic
from gapflow_tpu.ops import specfft

from gapflow_torch import Problem
from gapflow_torch.elastic import ElasticDeformation

F64 = torch.float64

#: (Nx, Ny, x periodic, y periodic, n_images)
CASES = {
    "full": (36, 36, True, True, 0),
    "half_x": (36, 36, True, False, 3),
    "half_y": (20, 12, False, True, 2),
    "none": (36, 36, False, False, 0),
    "line_contact": (64, 1, False, True, 10),
}


def grid_of(nx, ny, per_x, per_y):
    return {"dx": 0.01, "dy": 0.02, "Nx": nx, "Ny": ny,
            "Lx": 0.01 * nx, "Ly": 0.02 * ny,
            "bc_xE_P": [per_x] * 3, "bc_yS_P": [per_y] * 3}


def pair(case, fft_grid, alpha=0.5):
    nx, ny, px, py, n_images = CASES[case]
    grid = grid_of(nx, ny, px, py)
    with pytest.warns() if case == "line_contact" else \
            contextlib.nullcontext():
        j = JElastic(E=1e4, v=0.3, alpha_underrelax=alpha, grid=grid,
                     n_images=n_images, fft_grid=fft_grid)
    with pytest.warns() if case == "line_contact" else \
            contextlib.nullcontext():
        t = ElasticDeformation(E=1e4, v=0.3, alpha_underrelax=alpha,
                               grid=grid, n_images=n_images,
                               fft_grid=fft_grid, dtype=F64)
    return j, t


def pressure(ed, seed=0):
    return np.random.default_rng(seed).normal(size=tuple(ed.u_prev.shape))


def rel(a, b):
    b = np.asarray(b)
    return float(np.abs(np.asarray(a) - b).max() / np.abs(b).max())


@pytest.mark.parametrize("fft_grid", ["interior", "ghost"])
@pytest.mark.parametrize("case", list(CASES))
def test_deformation_matches_jax(case, fft_grid):
    j, t = pair(case, fft_grid)
    assert t.periodicity == j.periodicity
    assert t._pad_modes == j._pad_modes
    p = pressure(t)
    u = t.get_deformation(p)
    assert u.dtype == F64 and tuple(u.shape) == p.shape
    assert rel(u.numpy(), j.get_deformation(p)) < 1e-12
    # the same through the traceable entry on a tensor
    assert rel(t.deformation_full(torch.as_tensor(p)).numpy(),
               j.deformation_full(p)) < 1e-12
    G, Gj = t.get_G_real(), j.get_G_real()
    assert G.shape == Gj.shape and rel(G, Gj) < 1e-12
    for a, b in zip(t.get_G_real_slices(), j.get_G_real_slices()):
        assert rel(a, b) < 1e-12


def test_the_ghost_grid_is_a_mixed_radix_size_for_jax():
    """The 36 x 36 ghost grid takes the JAX package's mixed-radix path,
    periodic and padded: the case the port's torch.fft has to meet."""
    assert specfft.needs_mixed_radix((38, 38))
    assert specfft.needs_mixed_radix((76, 76))
    j, _ = pair("full", "ghost")
    assert j._hs._mixed


@pytest.mark.parametrize("case", ["full", "none"])
def test_underrelaxation_matches_jax_and_converges(case):
    j, t = pair(case, "interior")
    p = pressure(t, seed=1)
    for _ in range(5):
        uj = j.get_deformation_underrelax(p)
        ut = t.get_deformation_underrelax(p)
    assert rel(ut.numpy(), uj) < 1e-12
    assert rel(t.u_prev.numpy(), j.u_prev) < 1e-12
    for _ in range(55):
        ut = t.get_deformation_underrelax(p)
    np.testing.assert_allclose(ut.numpy(), t.get_deformation(p).numpy(),
                               rtol=1e-6, atol=1e-9 * float(ut.abs().max()))


def test_float32_pressure_keeps_its_dtype():
    _, t = pair("full", "interior")
    p = torch.as_tensor(pressure(t), dtype=torch.float32)
    assert t.get_deformation(p).dtype == torch.float32


SIM = """
options: {{output: {out}, write_freq: 1000, silent: True}}
grid: {{dx: 1.e-5, dy: 1.e-5, Nx: 24, Ny: 16{edges}}}
geometry: {{type: journal, CR: 1.e-2, eps: 0.7, U: 0.1, V: 0.}}
numerics: {{CFL: 0.25, adaptive: 0, tol: 1e-30, dt: 5e-11, max_it: 10}}
properties: {{shear: 0.0794, bulk: 0., EOS: DH, P0: 101325.,
             rho0: 877.7007, C1: 3.5e10, C2: 1.23,
             elastic: {{E: 5e9, v: 0.3, alpha_underrelax: 0.3,
                        n_images: 2}}}}
"""


@pytest.mark.parametrize("edges", ["", ", xE: ['D', 'N', 'N'], "
                                   "xW: ['D', 'N', 'N'], xE_D: 877.7007, "
                                   "xW_D: 877.7007"])
def test_topography_update_matches_jax(tmp_path, edges):
    """Topography.update() from a pressure field, twice: the deformation
    (shifted by its [0, 0] value on half periodicity), the gap and its
    refreshed gradients."""
    text = SIM.format(out=tmp_path, edges=edges)
    with contextlib.redirect_stdout(io.StringIO()):
        jp = JProblem.from_string(text)
        tp = Problem.from_string(text, device="cpu", dtype=F64)
    assert tp.topo.elastic and tp.topo.ElasticDeformation.periodicity == \
        jp.topo.ElasticDeformation.periodicity
    np.testing.assert_array_equal(tp.topo.full, np.asarray(jp.topo.full))
    rng = np.random.default_rng(2)
    for _ in range(2):
        p = 1e5 + 1e4 * rng.normal(size=tp.q[0].shape)
        jp.fc.get_real_field("pressure").p[...] = p
        tp.fc.get_real_field("pressure").p[...] = p
        jp.topo.update()
        tp.topo.update()
    full, jfull = tp.topo.full, np.asarray(jp.topo.full)
    for c in range(4):
        assert rel(full[c], jfull[c]) < 1e-12
    np.testing.assert_allclose(full[0], tp.topo.h_undeformed + full[3],
                               rtol=1e-15)
