"""Planck function utilities: band-integrated Planck table and lookups.

Redesign of the reference's Planck machinery
(source/kernels.cu:55-105 planck_func/analyt_planck, :362-416 plancktable,
:923-1010 planck_interpol_layer/interface):

* the table is built in one vectorized pass -- the 200-term analytic series
  is evaluated per *bin edge* and differenced across edges (mathematically
  identical to the reference's per-bin evaluation, at half the flops),
* lookups are vectorized gathers with the same clamped linear interpolation
  index math as the reference.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from helios_tpu import constants as pc

_N_SERIES = 200  # reference kernels.cu:410: n = 1..199


def planck_lambda(lamda, T):
    """Spectral radiance B_lambda(T) [erg s^-1 cm^-2 cm^-1 sr^-1].

    Reference kernels.cu:55-61.
    """
    num = 2.0 * pc.H * pc.C * pc.C
    denom = lamda ** 5 * (jnp.exp(pc.H * pc.C / (lamda * pc.K_B * T)) - 1.0)
    return num / denom


def dB_dT(lamda, T):
    """Temperature derivative of the Planck function (kernels.cu:294-308)."""
    D = 2.0 * pc.H * pc.C ** 3 * pc.H / (lamda ** 6 * pc.K_B * T * T)
    e = jnp.exp(pc.H * pc.C / (lamda * pc.K_B * T))
    return D * e / ((e - 1.0) * (e - 1.0))


def _series_antiderivative(y, n_terms=_N_SERIES):
    """S(y) = sum_{n=1}^{n_terms-1} exp(-n y)(y^3/n + 3y^2/n^2 + 6y/n^3 + 6/n^4).

    The reference evaluates, per bin, sum_n [E_n(y_top) - E_n(y_bot)]
    (kernels.cu:95-105, :410-412); we evaluate the summed antiderivative per
    bin *edge* and difference across edges -- identical math, shared work.
    """
    def body(n, acc):
        dn = n.astype(y.dtype)
        e = jnp.exp(-dn * y)
        return acc + e * (y ** 3 / dn + 3.0 * y ** 2 / dn ** 2
                          + 6.0 * y / dn ** 3 + 6.0 / dn ** 4)

    acc0 = jnp.zeros_like(y)
    return jax.lax.fori_loop(1, n_terms, body, acc0)


def integrated_planck_over_bins(lambda_edge, delta_lambda, T):
    """Band-mean Planck function over wavelength bins for temperatures T.

    Args:
      lambda_edge: [nbin+1] bin edge wavelengths [cm] (increasing).
      delta_lambda: [nbin] bin widths [cm].
      T: [...,] temperatures [K].

    Returns:
      [..., nbin] band-integrated B divided by bin width (like the
      reference's planck_grid, kernels.cu:395-414).
    """
    T = jnp.asarray(T)
    Tb = T[..., None]                              # [..., 1]
    y_edge = pc.H * pc.C / (lambda_edge * pc.K_B * Tb)   # [..., nbin+1]
    # y decreases with lambda: y_bot = y at lambda_edge[x], y_top at [x+1]
    S = _series_antiderivative(y_edge)
    D = (2.0 * (pc.K_B / pc.H) ** 3 * pc.K_B * Tb ** 4) / (pc.C * pc.C)
    # integral over bin = D * (E(y_top) - E(y_bot)) summed over n
    band = D * (S[..., 1:] - S[..., :-1])
    band = jnp.where(Tb > 0.01, band, 0.0)
    return band / delta_lambda


def build_planck_table(lambda_edge, delta_lambda, T_star,
                       dim: int = 8000, step: int = 2,
                       dtype=jnp.float64):
    """Pre-tabulated band-integrated Planck grid.

    Temperature grid: T_t = t*step + 1 for t = 0..dim-1, plus one extra row
    at T_star (reference kernels.cu:384-393).  Returns [dim+1, nbin].
    """
    t_idx = jnp.arange(dim, dtype=dtype)
    T_grid = t_idx * step + 1.0
    T_all = jnp.concatenate([T_grid, jnp.asarray([T_star], dtype=dtype)])
    lambda_edge = jnp.asarray(lambda_edge, dtype)
    delta_lambda = jnp.asarray(delta_lambda, dtype)
    return integrated_planck_over_bins(lambda_edge, delta_lambda, T_all)


def interpolate_planck(planck_grid, T, dim: int, step: int):
    """Linear lookup of band Planck values at temperatures T: a row gather
    and a blend in the grid's own precision.

    Index math follows reference kernels.cu:952-974: t = (T-1)/step clamped
    to [0.001, dim-1.001].  Returns [..., nbin].
    """
    t = (T - 1.0) / step
    t = jnp.clip(t, 0.001, dim - 1.001)
    tdown = jnp.floor(t).astype(jnp.int32)
    w = (t - tdown)[..., None]
    lo = planck_grid[tdown]
    hi = planck_grid[tdown + 1]
    return lo * (1.0 - w) + hi * w


def planckband_layers(planck_grid, T_lay, starflux, *, real_star: int,
                      dim: int, step: int):
    """Planck band values for layers + stellar row + surface row.

    Returns [nlayer+2, nbin]: rows 0..nlayer-1 from layer temperatures,
    row nlayer = stellar flux / pi (or the tabulated B(T_star) row),
    row nlayer+1 = surface/BOA blackbody at T_lay[nlayer]
    (reference kernels.cu:923-977; layout note SURVEY.md section 2.3).

    T_lay: [nlayer+1] including surface ghost layer at index nlayer.
    """
    nlayer = T_lay.shape[0] - 1
    lay_rows = interpolate_planck(planck_grid, T_lay[:nlayer], dim, step)
    surf_row = interpolate_planck(planck_grid, T_lay[nlayer], dim, step)
    if real_star:
        star_row = starflux / jnp.pi
    else:
        star_row = planck_grid[dim]
    return jnp.concatenate(
        [lay_rows, star_row[None, :], surf_row[None, :]], axis=0)


def planckband_interfaces(planck_grid, T_int, *, dim: int, step: int):
    """Planck band values at interface temperatures: [ninterface, nbin]."""
    return interpolate_planck(planck_grid, T_int, dim, step)


def correct_incident_energy(planck_grid, starflux, delta_lambda, *,
                            real_star: int, T_star: float, dim: int):
    """Rescale stellar spectrum / BB row so the integral equals sigma*T_star^4.

    Reference kernels.cu:420-468.  Returns (planck_grid, starflux,
    corr_factor).
    """
    if real_star:
        num_flux = jnp.sum(delta_lambda * starflux)
    else:
        num_flux = jnp.sum(delta_lambda * jnp.pi * planck_grid[dim])
    theo_flux = pc.SIGMA_SB * T_star ** 4.0
    corr = theo_flux / num_flux
    if real_star:
        starflux = starflux * corr
    else:
        planck_grid = planck_grid.at[dim].multiply(corr)
    return planck_grid, starflux, corr
