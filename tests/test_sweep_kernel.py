"""Fused GPU sweep kernels (kernels/sweep_triton.py): interpreter-mode
parity with the lax.scan sweeps, the choice of kernel, and compiled parity
on a GPU (tests marked `gpu`)."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from helios_tpu import fastpath as fp
from helios_tpu.kernels import sweep_triton
from helios_tpu.ops import sweep as sweep_ops

from test_fastpath import make_case
from test_sweep import make_cells


def _iso_flat(rng, L, S, dtype=jnp.float64):
    u = lambda *s, lo=0.0, hi=1.0: jnp.asarray(rng.uniform(lo, hi, s), dtype)
    C = fp.FlatIsoCoeffs(
        a=u(L, S, lo=0.3, hi=0.8), b_nm=u(L, S, hi=0.1),
        src_down=u(L, S, hi=1e3), src_up=u(L, S, hi=1e3),
        boa_refl=u(S, hi=0.3), boa_emis=u(S, hi=1e4), toa=u(S, hi=1e3))
    return C, u(S, hi=1e3), u(L + 1, S, hi=1e4)


def _noniso_flat(rng, L, S, dtype=jnp.float64):
    u = lambda *s, lo=0.0, hi=1.0: jnp.asarray(rng.uniform(lo, hi, s), dtype)
    C = fp.FlatNonIsoCoeffs(
        a_up=u(L, S, lo=0.3, hi=0.8), b_up=u(L, S, hi=0.1),
        src_up_down=u(L, S, hi=1e3), src_up_up=u(L, S, hi=1e3),
        a_low=u(L, S, lo=0.3, hi=0.8), b_low=u(L, S, hi=0.1),
        src_low_down=u(L, S, hi=1e3), src_low_up=u(L, S, hi=1e3),
        boa_refl=u(S, hi=0.3), boa_emis=u(S, hi=1e4), toa=u(S, hi=1e3))
    return C, u(S, hi=1e3), u(L + 1, S, hi=1e4), u(L, S, hi=1e4)


def _iso_kernel(C, F_dir0, F_up, n_passes, **kw):
    return sweep_triton.iso_sweep(
        C.a, C.b_nm, C.src_down, C.src_up, C.toa, C.boa_refl, C.boa_emis,
        F_dir0, F_up, n_passes=n_passes, **kw)


def _noniso_kernel(C, F_dir0, F_up, Fc_up, n_passes, **kw):
    return sweep_triton.noniso_sweep(
        *C[:8], C.toa, C.boa_refl, C.boa_emis, F_dir0, F_up, Fc_up,
        n_passes=n_passes, **kw)


def _assert_close(got, want, rtol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=rtol)


@pytest.mark.parametrize("n_passes", [1, 4])
@pytest.mark.parametrize("scat_corr", [0, 1])
def test_iso_kernel_matches_reference_sweep(rng, n_passes, scat_corr):
    """Kernel on the reference-shaped cells' coefficients vs
    ops.sweep.fband_iso, the [L, B, Y] oracle."""
    L, B, Y = 9, 5, 3
    cells, _, par = make_cells(rng, L, B, Y, scat_corr=scat_corr)
    planckband_lay = jnp.asarray(rng.uniform(1e2, 1e4, (L + 2, B)))
    F_dir = jnp.asarray(-rng.uniform(0.0, 1e3, (L + 1, B, Y)))
    surf_albedo = jnp.asarray(rng.uniform(0.0, 0.5, B))
    F_up0 = jnp.asarray(rng.uniform(0, 1e3, (L + 1, B, Y)))
    kw = dict(scat_corr=scat_corr, i2s_transition=par["i2s"],
              epsi=par["epsi"], mu_star=par["mu_star"], dir_beam=0,
              f_factor=0.5, R_star=7e10, a=1.5e12)

    want = sweep_ops.fband_iso(cells, planckband_lay, F_dir, surf_albedo,
                               F_up0, n_passes=n_passes, **kw)
    C = sweep_ops.iso_sweep_coeffs(cells, planckband_lay, F_dir,
                                   surf_albedo, **kw)
    flat = fp.cube_to_flat
    row = lambda x: flat(jnp.broadcast_to(x[:, None], (B, Y)))
    got = sweep_triton.iso_sweep(
        flat(C.a), flat(C.b_nm), flat(C.src_down), flat(C.src_up),
        row(C.toa), row(C.boa_refl), flat(C.boa_emis), flat(F_dir[0]),
        flat(F_up0), n_passes=n_passes, interpret=True)
    _assert_close([fp.flat_to_cube(g, Y) for g in got], want, 1e-12)


@pytest.mark.parametrize("dtype,rtol", [(jnp.float64, 1e-12),
                                        (jnp.float32, 1e-5)])
@pytest.mark.parametrize("n_passes", [1, 4])
def test_noniso_kernel_matches_scan(rng, n_passes, dtype, rtol):
    C, F_dir0, F_up, Fc_up = _noniso_flat(rng, 10, 40, dtype)
    want = fp.fband_noniso_flat(C, F_dir0, F_up, Fc_up, n_passes=n_passes)
    got = _noniso_kernel(C, F_dir0, F_up, Fc_up, n_passes, interpret=True)
    _assert_close(got, want, rtol)


@pytest.mark.parametrize("iso", [True, False])
def test_kernel_partial_last_block(rng, iso):
    """A column count that is no multiple of the block: the last program
    masks its loads and stores."""
    S = 2 * sweep_triton.BLOCK + 13
    if iso:
        C, F_dir0, F_up = _iso_flat(rng, 7, S)
        want = fp.fband_iso_flat(C, F_dir0, F_up, n_passes=3,
                                 use_pallas=False)
        got = _iso_kernel(C, F_dir0, F_up, 3, interpret=True)
    else:
        C, F_dir0, F_up, Fc_up = _noniso_flat(rng, 7, S)
        want = fp.fband_noniso_flat(C, F_dir0, F_up, Fc_up, n_passes=3)
        got = _noniso_kernel(C, F_dir0, F_up, Fc_up, 3, interpret=True)
    _assert_close(got, want, 1e-12)


@pytest.mark.parametrize("L", [12, 105])
def test_kernel_layer_counts(rng, L):
    """12 layers (a remainder after the row chunks) and the reference's
    105 (one that is no power of two)."""
    C, F_dir0, F_up = _iso_flat(rng, L, 24)
    want = fp.fband_iso_flat(C, F_dir0, F_up, n_passes=2, use_pallas=False)
    got = _iso_kernel(C, F_dir0, F_up, 2, interpret=True)
    _assert_close(got, want, 1e-12)


def test_kernel_under_vmap(rng):
    """A planet batch (vmap) adds a grid axis; each member must match its
    own solve."""
    C, F_dir0, F_up = _iso_flat(rng, 6, 20)
    ups = jnp.stack([F_up, 2.0 * F_up])
    got = jax.vmap(lambda fu: _iso_kernel(C, F_dir0, fu, 2,
                                          interpret=True))(ups)
    for i in range(2):
        want = fp.fband_iso_flat(C, F_dir0, ups[i], n_passes=2,
                                 use_pallas=False)
        _assert_close([got[0][i], got[1][i]], want, 1e-12)


@pytest.mark.parametrize("choice,expect", [("auto", False), ("no", False)])
def test_kernel_choice_off_the_gpu(choice, expect):
    """"auto" picks the kernel on the GPU backend only."""
    phys, _ = make_case(1, clouds=0, dir_beam=0)
    phys = dataclasses.replace(phys, use_pallas=choice)
    assert jax.default_backend() == "cpu"
    assert phys.pallas_active is expect


def test_kernel_demanded_off_the_gpu_raises():
    from helios_tpu.forward import forward_fluxes

    phys, arrays = make_case(1, clouds=0, dir_beam=0)
    phys = dataclasses.replace(phys, use_pallas="yes")
    T = jnp.linspace(1500.0, 800.0, phys.nlayer + 1)
    with pytest.raises(RuntimeError, match="GPU backend"):
        forward_fluxes(phys, arrays, T)


@pytest.mark.gpu
@pytest.mark.parametrize("iso", [True, False])
def test_compiled_kernel_matches_scan(rng, iso):
    """The Triton-compiled kernel on the card vs the lax.scan sweep."""
    if iso:
        C, F_dir0, F_up = _iso_flat(rng, 105, 1000)
        want = fp.fband_iso_flat(C, F_dir0, F_up, n_passes=4,
                                 use_pallas=False)
        got = _iso_kernel(C, F_dir0, F_up, 4)
    else:
        C, F_dir0, F_up, Fc_up = _noniso_flat(rng, 105, 1000)
        want = fp.fband_noniso_flat(C, F_dir0, F_up, Fc_up, n_passes=4)
        got = _noniso_kernel(C, F_dir0, F_up, Fc_up, 4)
    _assert_close(got, want, 1e-12)


@pytest.mark.gpu
def test_kernel_chosen_on_the_gpu():
    phys, _ = make_case(1, clouds=0, dir_beam=0)
    assert phys.use_pallas == "auto" and phys.pallas_active
