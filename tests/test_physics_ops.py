"""Unit tests of the physics ops against closed forms and the numpy oracle."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from helios_tpu import constants as pc
from helios_tpu import grid as grid_mod
from helios_tpu import planck as planck_mod
from helios_tpu.ops import beam as beam_ops
from helios_tpu.ops import interp as interp_ops
from helios_tpu.ops import thomas as thomas_ops
from helios_tpu.ops import twostream as ts

import reference_impl as ref


# --------------------------------------------------------------------------- #
# grid
# --------------------------------------------------------------------------- #

def test_grid_construction():
    g = grid_mod.build_grid(p_boa=1e9, p_toa=1e-1, nlayer=105, g=2288.0)
    assert g.nlayer == 105 and g.ninterface == 106
    assert g.p_int[0] == pytest.approx(1e9)
    # strictly decreasing, layers between interfaces
    assert np.all(np.diff(g.p_int) < 0)
    assert np.all(g.p_lay < g.p_int[:-1]) and np.all(g.p_lay > g.p_int[1:])
    # column mass closes: sum of delta_colmass = (p_boa - p_top_int)/g
    assert np.sum(g.delta_colmass) == pytest.approx(
        (g.p_int[0] - g.p_int[-1]) / 2288.0)
    assert np.allclose(g.delta_col_upper + g.delta_col_lower, g.delta_colmass)


def test_automatic_nlayer():
    # read.py:923-926
    n = int(np.ceil(10.5 * np.log10(1e9 / 1e-1)))
    assert n == 105


# --------------------------------------------------------------------------- #
# planck
# --------------------------------------------------------------------------- #

def test_planck_band_integral_matches_stefan_boltzmann():
    # wide wavelength range so the integral captures (almost) all flux
    edges = np.geomspace(1e-6, 1.0, 2001)  # 0.01 micron .. 1 cm
    dl = np.diff(edges)
    for T in (300.0, 1500.0, 6000.0):
        band = planck_mod.integrated_planck_over_bins(
            jnp.asarray(edges), jnp.asarray(dl), jnp.asarray(T))
        total = np.pi * np.sum(np.asarray(band) * dl)
        assert total == pytest.approx(pc.SIGMA_SB * T ** 4, rel=1e-6)


def test_planck_band_matches_quadrature():
    from scipy.integrate import quad
    edges = np.array([1e-4, 2e-4])  # 1-2 micron
    dl = np.diff(edges)
    T = 1200.0
    band = float(planck_mod.integrated_planck_over_bins(
        jnp.asarray(edges), jnp.asarray(dl), jnp.asarray(T))[0])

    def bf(lam):
        return (2 * pc.H * pc.C ** 2 / lam ** 5
                / (np.exp(pc.H * pc.C / (lam * pc.K_B * T)) - 1))

    expected = quad(bf, edges[0], edges[1], limit=200)[0] / dl[0]
    assert band == pytest.approx(expected, rel=1e-9)


def test_dB_dT_finite_difference():
    lam, T = 5e-4, 900.0
    analytic = float(planck_mod.dB_dT(jnp.asarray(lam), jnp.asarray(T)))
    h = 0.5  # large enough to avoid fp64 cancellation in the difference
    fd = float((planck_mod.planck_lambda(jnp.asarray(lam), jnp.asarray(T + h))
                - planck_mod.planck_lambda(jnp.asarray(lam),
                                           jnp.asarray(T - h))) / (2 * h))
    assert analytic == pytest.approx(fd, rel=1e-5)


def test_planck_table_lookup():
    edges = np.geomspace(1e-5, 1e-2, 12)
    dl = np.diff(edges)
    grid = planck_mod.build_planck_table(edges, dl, T_star=5000.0,
                                         dim=50, step=100)
    assert grid.shape == (51, 11)
    # interpolation at a grid temperature T = t*step+1 recovers the row
    T = jnp.asarray([1201.0])
    row = planck_mod.interpolate_planck(grid, T, dim=50, step=100)[0]
    np.testing.assert_allclose(np.asarray(row), np.asarray(grid[12]),
                               rtol=1e-10)


def _planck_lookup_oracle(grid, T, dim, step):
    """numpy linear lookup with the reference's clamped index math
    (kernels.cu:952-974)."""
    t = np.clip((np.asarray(T) - 1.0) / step, 0.001, dim - 1.001)
    lo = np.floor(t).astype(int)
    w = (t - lo)[..., None]
    return grid[lo] * (1.0 - w) + grid[lo + 1] * w


@pytest.mark.parametrize("where", ["layers", "interfaces"])
def test_planck_lookup_matches_numpy_oracle(rng, where):
    """fp64 Planck lookup (a plain gather + blend) vs numpy, including
    temperatures clamped at both ends of the table."""
    dim, step, nlayer = 400, 5, 9
    edges = np.geomspace(1e-5, 1e-2, 13)
    grid = np.asarray(planck_mod.build_planck_table(
        edges, np.diff(edges), T_star=5000.0, dim=dim, step=step))
    T = np.concatenate([rng.uniform(1.0, dim * step, nlayer - 1),
                        [dim * step + 500.0], [0.5]])
    star = rng.uniform(1.0, 2.0, 12)
    if where == "layers":
        got = planck_mod.planckband_layers(
            jnp.asarray(grid), jnp.asarray(T), jnp.asarray(star),
            real_star=1, dim=dim, step=step)
        want = np.concatenate([
            _planck_lookup_oracle(grid, T[:nlayer], dim, step),
            star[None] / np.pi,
            _planck_lookup_oracle(grid, T[nlayer:], dim, step)])
    else:
        got = planck_mod.planckband_interfaces(
            jnp.asarray(grid), jnp.asarray(T), dim=dim, step=step)
        want = _planck_lookup_oracle(grid, T, dim, step)
    assert got.dtype == jnp.float64 and got.shape == want.shape
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-14)


def test_stellar_energy_correction():
    edges = np.geomspace(1e-6, 1.0, 3001)
    dl = np.diff(edges)
    T_star = 5000.0
    grid = planck_mod.build_planck_table(edges, dl, T_star=T_star,
                                         dim=10, step=2)
    grid2, _, corr = planck_mod.correct_incident_energy(
        grid, jnp.zeros(len(dl)), jnp.asarray(dl), real_star=0,
        T_star=T_star, dim=10)
    total = np.pi * np.sum(np.asarray(grid2[10]) * dl)
    assert total == pytest.approx(pc.SIGMA_SB * T_star ** 4, rel=1e-12)
    assert abs(float(corr) - 1.0) < 1e-4  # wide grid: tiny correction


# --------------------------------------------------------------------------- #
# two-stream helper functions vs oracle
# --------------------------------------------------------------------------- #

def test_twostream_helpers_match_oracle(rng):
    i2s = 0.1
    for _ in range(50):
        w0 = rng.uniform(0, 1 - 1e-10)
        g0 = rng.uniform(-0.9, 0.9)
        dtau = 10 ** rng.uniform(-8, 2)
        epsi, epsi2, mu = 0.5, 0.5, -0.6830127018922193
        for scat_corr in (0, 1):
            assert float(ts.E_maybe(jnp.asarray(w0), jnp.asarray(g0),
                                    scat_corr, i2s)) == pytest.approx(
                ref.E_parameter(w0, g0, i2s, scat_corr), rel=1e-14)
            assert float(ts.trans_func(epsi, jnp.asarray(dtau),
                                       jnp.asarray(w0), jnp.asarray(g0),
                                       scat_corr, i2s)) == pytest.approx(
                ref.trans_func(epsi, dtau, w0, g0, i2s, scat_corr),
                rel=1e-12, abs=1e-300)
            for sign, fn in ((+1, ts.zeta_plus), (-1, ts.zeta_minus)):
                assert float(fn(jnp.asarray(w0), jnp.asarray(g0), scat_corr,
                                i2s)) == pytest.approx(
                    ref.zeta(w0, g0, i2s, scat_corr, sign), rel=1e-13)
            for sign, fn in ((+1, ts.G_plus), (-1, ts.G_minus)):
                assert float(fn(jnp.asarray(w0), jnp.asarray(g0), epsi,
                                epsi2, mu, scat_corr, i2s)) == pytest.approx(
                    ref.G_func(w0, g0, epsi, epsi2, mu, i2s, scat_corr, sign),
                    rel=1e-12)


def test_pure_absorption_limit():
    """w0 -> 0: the sweep equation reduces to the absorption recurrence
    F_down[i] = t*F_down[i+1] + 2 pi eps (1-t) B."""
    epsi, i2s = 0.5, 0.1
    w0 = jnp.asarray(1e-14)
    g0 = jnp.asarray(0.0)
    dtau = jnp.asarray(0.7)
    t = float(ts.trans_func(epsi, dtau, w0, g0, 0, i2s))
    zm = float(ts.zeta_minus(w0, g0, 0, i2s))
    zp = float(ts.zeta_plus(w0, g0, 0, i2s))
    M = zm * zm * t * t - zp * zp
    N = zp * zm * (1 - t * t)
    P = (zm * zm - zp * zp) * t
    # (N + M - P)/M * (1-w0)/(E-w0) -> (1 - t)... and P/M -> t
    assert P / M == pytest.approx(t, abs=1e-10)
    assert (N + M - P) / M == pytest.approx(1 - t, abs=1e-10)
    assert abs(N / M) < 1e-10


# --------------------------------------------------------------------------- #
# interpolation vs oracle
# --------------------------------------------------------------------------- #

def test_bilinear_interp_matches_oracle(rng):
    ntemp, npress, B, Y = 7, 5, 3, 2
    table = rng.uniform(0.1, 10.0, (ntemp, npress, B, Y))
    temps = np.linspace(100.0, 4000.0, ntemp)
    press = np.logspace(0, 8, npress)
    T_q = rng.uniform(50.0, 5000.0, 11)     # includes out-of-range
    p_q = 10 ** rng.uniform(-1, 9, 11)
    got = interp_ops.bilinear_tp(jnp.asarray(table), jnp.asarray(temps),
                                 jnp.asarray(press), jnp.asarray(T_q),
                                 jnp.asarray(p_q))
    for i in range(len(T_q)):
        want = ref.bilinear_interpol(table, temps, press, T_q[i], p_q[i])
        np.testing.assert_allclose(np.asarray(got[i]), want, rtol=1e-12)


def test_bilinear_log_temp(rng):
    ntemp, npress = 6, 4
    table = rng.uniform(1.0, 2.0, (ntemp, npress))
    temps = np.geomspace(100.0, 3000.0, ntemp)
    press = np.logspace(2, 8, npress)
    T_q = np.array([432.1])
    p_q = np.array([3.3e5])
    got = interp_ops.interpolate_cp(jnp.asarray(table), jnp.asarray(temps),
                                    jnp.asarray(press), jnp.asarray(T_q),
                                    jnp.asarray(p_q))
    want = ref.bilinear_interpol(table, temps, press, T_q[0], p_q[0],
                                 log_temp=True)
    assert float(got[0]) == pytest.approx(want, rel=1e-12)


def test_interface_temperatures():
    T_lay = jnp.asarray([100.0, 200.0, 400.0, 999.0])  # last = surface ghost
    T_int = interp_ops.interface_temperatures(T_lay)
    np.testing.assert_allclose(
        np.asarray(T_int), [50.0, 150.0, 300.0, 500.0])


# --------------------------------------------------------------------------- #
# thomas solver
# --------------------------------------------------------------------------- #

def test_thomas_matches_oracle_and_dense(rng):
    n = 12
    b = rng.uniform(1.5, 3.0, n)
    c = rng.uniform(-1.0, 1.0, n)
    c[-1] = 0.0
    d = rng.uniform(-2.0, 2.0, n)
    x_ref = ref.thomas_reference(b, c, d)

    x_ours = thomas_ops.thomas_solve(
        jnp.asarray(b)[:, None, None], jnp.asarray(c)[:, None, None],
        jnp.asarray(d)[:, None, None])[:, 0, 0]
    np.testing.assert_allclose(np.asarray(x_ours), x_ref, rtol=1e-12)

    # cross-check against a dense solve of the same tridiagonal system
    A = np.zeros((n, n))
    for i in range(n):
        A[i, i] = b[i]
        if i + 1 < n:
            A[i, i + 1] = c[i]
        if i > 0:
            A[i, i - 1] = c[i - 1]   # reference convention: a_i = c_{i-1}
    x_dense = np.linalg.solve(A, d)
    np.testing.assert_allclose(x_ref, x_dense, rtol=1e-9)


# --------------------------------------------------------------------------- #
# direct beam vs oracle
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("geom", [0, 1])
def test_fdir_iso_matches_oracle(rng, geom):
    L, B, Y = 6, 4, 3
    dtau = rng.uniform(0.01, 0.5, (L, B, Y))
    z_lay = np.sort(rng.uniform(0, 1e8, L))
    planck_star = rng.uniform(1e3, 1e5, B)
    mu_star = -0.5
    Rp, Rs, a = 7e9, 7e10, 1.5e12

    planckband_lay = np.zeros((L + 2, B))
    planckband_lay[L] = planck_star

    got = beam_ops.fdir_iso(
        jnp.asarray(planckband_lay), jnp.asarray(dtau), jnp.asarray(z_lay),
        mu_star=mu_star, R_planet=Rp, R_star=Rs, a=a, dir_beam=1,
        geom_zenith_corr=geom)
    want = ref.fdir_iso(planck_star, dtau, z_lay, mu_star, Rp, Rs, a, 1, geom)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-10)


@pytest.mark.parametrize("geom", [0, 1])
def test_fdir_noniso_matches_oracle(rng, geom):
    L, B, Y = 5, 3, 2
    dtau_up = rng.uniform(0.01, 0.3, (L, B, Y))
    dtau_low = rng.uniform(0.01, 0.3, (L, B, Y))
    z_lay = np.sort(rng.uniform(0, 1e8, L))
    planck_star = rng.uniform(1e3, 1e5, B)
    mu_star = -0.7
    Rp, Rs, a = 7e9, 7e10, 1.5e12

    planckband_lay = np.zeros((L + 2, B))
    planckband_lay[L] = planck_star

    got_F, got_Fc = beam_ops.fdir_noniso(
        jnp.asarray(planckband_lay), jnp.asarray(dtau_up),
        jnp.asarray(dtau_low), jnp.asarray(z_lay), mu_star=mu_star,
        R_planet=Rp, R_star=Rs, a=a, dir_beam=1, geom_zenith_corr=geom)
    want_F, want_Fc = ref.fdir_noniso(planck_star, dtau_up, dtau_low, z_lay,
                                      mu_star, Rp, Rs, a, 1, geom)
    np.testing.assert_allclose(np.asarray(got_F), want_F, rtol=1e-10)
    np.testing.assert_allclose(np.asarray(got_Fc), want_Fc, rtol=1e-10)
