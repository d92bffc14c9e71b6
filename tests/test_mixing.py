"""On-the-fly opacity mixing tests: RO vs oracle, physical invariants,
and the full species mixing pass."""

import numpy as np
import pytest

import jax.numpy as jnp

from helios_tpu import chem
from helios_tpu import constants as pc
from helios_tpu.io.opacity import gauss_legendre_ypoints
from helios_tpu.ops import mixing as mix_ops

import reference_mixing as refm


@pytest.fixture(scope="module")
def gauss():
    y, w = gauss_legendre_ypoints(20)
    return jnp.asarray(y), jnp.asarray(w)


def kdist(rng, ny=20, lo=-4, hi=1):
    """Random ascending k-distribution."""
    k = np.sort(10.0 ** rng.uniform(lo, hi, ny))
    return k


@pytest.mark.parametrize("seed", range(6))
def test_random_overlap_matches_oracle(gauss, seed):
    y, w = gauss
    rng = np.random.default_rng(seed)
    mixed = kdist(rng)
    new = kdist(rng, lo=-3, hi=0.5)
    got = np.asarray(mix_ops.random_overlap_mix(
        jnp.asarray(mixed), jnp.asarray(new), w, y))
    want = refm.add_to_mixed_opac_cell(mixed, new, np.asarray(w),
                                       np.asarray(y), s=1, ro_method=1)
    np.testing.assert_allclose(got, want, rtol=1e-12)


@pytest.mark.parametrize("ny", [4, 20])
def test_random_overlap_grid_matches_oracle(rng, ny):
    """The batched XLA Random Overlap over a [layer, bin] grid vs the
    per-cell oracle of the reference kernel."""
    y, w = gauss_legendre_ypoints(ny)
    L, B = 3, 5
    mixed = np.sort(np.exp(rng.normal(0, 4, (L, B, ny))), axis=-1)
    new = np.sort(np.exp(rng.normal(0, 4, (L, B, ny))), axis=-1)
    got = np.asarray(mix_ops.random_overlap_mix(
        jnp.asarray(mixed), jnp.asarray(new), jnp.asarray(w),
        jnp.asarray(y)))
    want = np.array([[refm.add_to_mixed_opac_cell(
        mixed[l, b], new[l, b], w, y, s=1, ro_method=1)
        for b in range(B)] for l in range(L)])
    np.testing.assert_allclose(got, want, rtol=1e-10)


def test_split_f32_hi_is_exact_in_float32(rng):
    """hi converts to float32 without rounding and hi + lo keeps ~47
    bits, so no compiler folding of the conversions can change them."""
    x = jnp.asarray(10.0 ** rng.uniform(-30, 30, 1000))
    hi, lo = mix_ops._split_f32(x)
    assert hi.dtype == lo.dtype == jnp.float32
    np.testing.assert_array_equal(
        np.asarray(hi, np.float64),
        np.asarray(x) - np.asarray(x - hi.astype(jnp.float64)))
    np.testing.assert_allclose(
        np.asarray(hi, np.float64) + np.asarray(lo, np.float64),
        np.asarray(x), rtol=2.0 ** -46)


@pytest.mark.gpu
def test_random_overlap_on_gpu_matches_oracle(rng, gauss):
    """The compiled Random Overlap on the card vs the per-cell oracle."""
    y, w = gauss
    mixed = np.sort(np.exp(rng.normal(0, 4, (6, 40, 20))), axis=-1)
    new = np.sort(np.exp(rng.normal(0, 4, (6, 40, 20))), axis=-1)
    got = np.asarray(mix_ops.random_overlap_mix(
        jnp.asarray(mixed), jnp.asarray(new), w, y))
    want = np.array([[refm.add_to_mixed_opac_cell(
        mixed[l, b], new[l, b], np.asarray(w), np.asarray(y), s=1,
        ro_method=1) for b in range(40)] for l in range(6)])
    np.testing.assert_allclose(got, want, rtol=1e-10)


@pytest.mark.parametrize("seed", range(4))
def test_add_species_negligible_and_batched(gauss, seed):
    """Batched add_species_opacity equals per-cell oracle, including the
    negligible-overlap correlated-k fallback."""
    y, w = gauss
    rng = np.random.default_rng(100 + seed)
    L, B, ny = 3, 4, 20
    mixed = np.stack([[kdist(rng) for _ in range(B)] for _ in range(L)])
    # make some cells negligible (tiny new opacity)
    scale = 10.0 ** rng.uniform(-8, 0, (L, B))
    new_raw = np.stack([[kdist(rng, lo=-2, hi=0.5) for _ in range(B)]
                        for _ in range(L)]) * scale[..., None]
    vmr = np.full(L, 1.0)
    mmm = np.full(L, 2.3 * pc.AMU)
    mass = 2.0 * pc.AMU

    got = np.asarray(mix_ops.add_species_opacity(
        jnp.asarray(mixed), jnp.asarray(new_raw), jnp.asarray(vmr), mass,
        jnp.asarray(mmm), w, y, species_index=1, ro_method=1))

    for i in range(L):
        for x in range(B):
            new = vmr[i] * mass / mmm[i] * new_raw[i, x]
            want = refm.add_to_mixed_opac_cell(
                mixed[i, x].copy(), new, np.asarray(w), np.asarray(y),
                s=1, ro_method=1)
            np.testing.assert_allclose(got[i, x], want, rtol=1e-10,
                                       err_msg=f"cell {i},{x}")


def test_ro_transmission_multiplicativity(gauss):
    """The defining property of Random Overlap: the band transmission of
    the mixed k-distribution approximates the product of the individual
    transmissions (uncorrelated overlap assumption)."""
    y, w = gauss
    rng = np.random.default_rng(7)
    k1 = kdist(rng, lo=-2, hi=1)
    k2 = kdist(rng, lo=-2, hi=1)
    u = 0.3  # column mass such that transmissions are mid-range
    mix = np.asarray(mix_ops.random_overlap_mix(
        jnp.asarray(k1), jnp.asarray(k2), w, y))
    wn = 0.5 * np.asarray(w)
    t1 = np.sum(wn * np.exp(-k1 * u))
    t2 = np.sum(wn * np.exp(-k2 * u))
    t_mix = np.sum(wn * np.exp(-mix * u))
    np.testing.assert_allclose(t_mix, t1 * t2, rtol=2e-2)


def test_mixed_opacities_two_gray_species(gauss):
    """Correlated-k mixing of two gray absorbers reproduces the analytic
    mass-mixing-ratio weighted opacity, and the mean molecular mass is the
    VMR-weighted molar weight."""
    y, w = gauss
    L, B, ny = 5, 3, 20
    ktemps = np.linspace(100, 4000, 6)
    kpress = np.logspace(0, 9, 5)

    k1, k2 = 0.7, 0.013
    tab1 = np.full((6, 5, B, ny), k1)
    tab2 = np.full((6, 5, B, ny), k2)

    specs = [chem.SpeciesSpec("H2", True, False, "0.9"),
             chem.SpeciesSpec("He", True, False, "0.1")]
    sset = chem.build_species_set(
        specs, ktemps=ktemps, kpress=kpress, nbin=B, ny=ny, nlayer=L,
        opacity_tables={"H2": tab1, "He": tab2})

    T = jnp.full(L, 1000.0)
    p = jnp.asarray(np.logspace(8, 4, L))
    wave = jnp.asarray(np.geomspace(1e-4, 1e-3, B))

    opac, scat, mmm = chem.mixed_opacities(
        sset, T, p, wave, w, y, ro_method=0, scat=0)

    w_mol = 0.9 * 2.01588 + 0.1 * 4.0026
    np.testing.assert_allclose(np.asarray(mmm), w_mol * pc.AMU, rtol=1e-12)

    want = (0.9 * 2.01588 * k1 + 0.1 * 4.0026 * k2) / w_mol
    np.testing.assert_allclose(np.asarray(opac), want, rtol=1e-12)
    assert np.all(np.asarray(scat) == 0.0)


def test_mixed_opacities_ro_vs_ck_ordering(gauss):
    """RO of two identical gray distributions equals correlated-k (sum)."""
    y, w = gauss
    rng = np.random.default_rng(3)
    k = kdist(rng)
    got = np.asarray(mix_ops.random_overlap_mix(
        jnp.asarray(k), jnp.asarray(k * 0.0 + 0.5), w, y))
    # mixing with a gray (constant) distribution shifts every k by 0.5
    np.testing.assert_allclose(got, k + 0.5, rtol=1e-9)


def test_h2o_rayleigh_matches_reference_formula():
    """Spot-check the H2O Rayleigh cross-section against a direct scalar
    evaluation of kernels.cu:3174-3205, 3404-3440."""
    wave = np.array([0.5e-4, 3e-4])   # one below, one above the 2.5um limit
    press = np.array([1e6])
    temp = np.array([300.0])
    vmr = np.array([0.01])
    mass = 18.0153 * pc.AMU

    got = np.asarray(mix_ops.h2o_scat_cross(
        jnp.asarray(wave), jnp.asarray(press), jnp.asarray(temp),
        jnp.asarray(vmr), mass))

    # scalar reference evaluation
    dens = vmr[0] * press[0] * mass / (pc.K_B * temp[0])
    lam = wave[0] / 0.589e-4
    delta = min(1.0, dens)
    theta = temp[0] / 273.15
    a = [0.244257733, 0.974634476e-2, -0.373234996e-2, 0.268678472e-3,
         0.158920570e-2, 0.245934259e-2, 0.900704920, -0.166626219e-1]
    A = delta * (a[0] + a[1] * delta + a[2] * theta + a[3] * lam ** 2 * theta
                 + a[4] * lam ** -2 + a[5] / (lam ** 2 - 0.229202 ** 2)
                 + a[6] / (lam ** 2 - 5.432937 ** 2) + a[7] * delta ** 2)
    index = ((2 * A + 1) / (1 - A)) ** 0.5
    n_ref = vmr[0] * press[0] / (pc.K_B * temp[0])
    King = (6 + 3 * 3e-4) / (6 - 7 * 3e-4)
    want = (24 * np.pi ** 3 / (n_ref ** 2 * wave[0] ** 4)
            * ((index ** 2 - 1) / (index ** 2 + 2)) ** 2 * King)

    np.testing.assert_allclose(got[0, 0], want, rtol=1e-12)
    assert got[0, 1] == 0.0   # above wavelength limit


def test_forward_on_the_fly_end_to_end(gauss):
    """Full forward flux pass in on-the-fly mode runs and produces finite
    fluxes that respond to the species VMR."""
    from helios_tpu.config import HeliosConfig
    from helios_tpu.forward import build_model, forward_fluxes
    from helios_tpu.io.opacity import synthetic_premixed_table

    y, w = gauss
    B, ny, L = 8, 20, 8
    donor = synthetic_premixed_table(nbin=B, ny=ny, ntemp=8, npress=6,
                                     seed=1)
    tab = donor.kpoints

    specs = [chem.SpeciesSpec("H2O", True, True, "1e-3"),
             chem.SpeciesSpec("CO2", True, False, "1e-4"),
             chem.SpeciesSpec("H2", False, True, "0.9"),
             chem.SpeciesSpec("He", False, False, "0.1")]
    sset = chem.build_species_set(
        specs, ktemps=donor.temperatures, kpress=donor.pressures,
        nbin=B, ny=ny, nlayer=L,
        opacity_tables={"H2O": tab, "CO2": tab * 3.0},
        scat_tables={"H2": 8.49e-45 / donor.wave_centers ** 4})

    cfg = HeliosConfig(planet="manual", g=2288.0, a=0.0153, R_planet=1.0,
                       R_star=1.0, T_star=4000.0, T_intern=100.0,
                       scattering="yes", direct_beam="no", convection="no",
                       run_type="iterative", iso_input="yes", nlayer=L,
                       p_boa=1e8, p_toa=1e3,
                       opacity_mixing="on-the-fly").finalize()
    phys, arrays = build_model(cfg, donor)
    assert phys.opacity_mixing == "on-the-fly"

    T = jnp.linspace(1500.0, 700.0, L + 1)
    _, totals, cache = forward_fluxes(phys, arrays, T, sset=sset)
    assert bool(jnp.all(jnp.isfinite(totals.F_net)))
    assert float(totals.F_up_tot[-1]) > 0

    # doubling the absorber VMRs must change the emitted spectrum
    specs2 = [chem.SpeciesSpec("H2O", True, True, "2e-3"),
              chem.SpeciesSpec("CO2", True, False, "2e-4"),
              chem.SpeciesSpec("H2", False, True, "0.9"),
              chem.SpeciesSpec("He", False, False, "0.1")]
    sset2 = chem.build_species_set(
        specs2, ktemps=donor.temperatures, kpress=donor.pressures,
        nbin=B, ny=ny, nlayer=L,
        opacity_tables={"H2O": tab, "CO2": tab * 3.0},
        scat_tables={"H2": 8.49e-45 / donor.wave_centers ** 4})
    _, totals2, _ = forward_fluxes(phys, arrays, T, sset=sset2)
    assert not np.allclose(np.asarray(totals.F_up_band[-1]),
                           np.asarray(totals2.F_up_band[-1]))


def test_rce_loop_on_the_fly(gauss):
    """Radiation loop converges in on-the-fly mode with RO mixing."""
    import jax
    from helios_tpu.config import HeliosConfig
    from helios_tpu.forward import build_model
    from helios_tpu.io.opacity import synthetic_premixed_table
    from helios_tpu.rce.radiative import radiation_loop

    y, w = gauss
    B, ny, L = 8, 20, 8
    donor = synthetic_premixed_table(nbin=B, ny=ny, ntemp=8, npress=6,
                                     seed=1)
    specs = [chem.SpeciesSpec("H2O", True, False, "1e-3"),
             chem.SpeciesSpec("CO2", True, False, "1e-4"),
             chem.SpeciesSpec("H2", False, False, "0.9"),
             chem.SpeciesSpec("He", False, False, "0.1")]
    sset = chem.build_species_set(
        specs, ktemps=donor.temperatures, kpress=donor.pressures,
        nbin=B, ny=ny, nlayer=L,
        opacity_tables={"H2O": donor.kpoints, "CO2": donor.kpoints * 3.0})

    cfg = HeliosConfig(planet="manual", g=2288.0, a=0.0153, R_planet=1.0,
                       R_star=1.0, T_star=4000.0, T_intern=200.0,
                       scattering="no", direct_beam="no", convection="no",
                       run_type="iterative", iso_input="yes", nlayer=L,
                       p_boa=1e8, p_toa=1e3, rad_convergence_limit=1e-6,
                       opacity_mixing="on-the-fly").finalize()
    phys, arrays = build_model(cfg, donor)

    T0 = jnp.full(L + 1, 1000.0)
    final = jax.jit(
        lambda t: radiation_loop(phys, arrays, None, t, sset=sset))(T0)
    assert bool(jnp.all(final.abort)), f"not converged at it={int(final.it)}"
    F_net = np.asarray(final.totals.F_net)
    denom = float(final.totals.F_down_tot[L]) + phys.F_intern
    assert (np.abs(F_net - phys.F_intern) / denom).max() < 1e-5
