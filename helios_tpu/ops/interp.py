"""Vectorized table interpolation ops.

Vectorized replacements for the reference's per-thread bilinear interpolation
kernels (source/kernels.cu:496-919, :3209-3259): one gather + weighted-sum
expression over the whole layer column instead of a CUDA thread per cell.
The clamped index math matches the reference exactly so parity tests agree
to machine precision.
"""

from __future__ import annotations

import jax.numpy as jnp


def interface_temperatures(T_lay):
    """Layer -> interface temperature interpolation (kernels.cu:496-520).

    T_lay: [nlayer+1] (index nlayer = surface ghost layer, unused here).
    Returns T_int: [nlayer+1] interface temperatures.
    """
    t = T_lay[:-1]                    # actual layer temperatures [nlayer]
    inner = 0.5 * (t[:-1] + t[1:])    # interfaces 1..nlayer-1
    bottom = t[0] - 0.5 * (t[1] - t[0])
    top = t[-1] + 0.5 * (t[-1] - t[-2])
    return jnp.concatenate([bottom[None], inner, top[None]])


def _fractional_index(x, x0, dx, n, lo=0.001):
    """Clamped fractional table index t with floor/weight decomposition.

    Matches kernels.cu:545-559: t = (x - x0)/dx clamped to [lo, n-1-lo].
    Returns (idx_down, weight_up) where value = v[idx]*(1-w) + v[idx+1]*w.
    The reference's four tdown/tup branch cases collapse into this single
    expression (weight 0 reproduces the degenerate branches).
    """
    t = (x - x0) / dx
    t = jnp.clip(t, lo, n - 1.0 - lo)
    td = jnp.floor(t).astype(jnp.int32)
    td = jnp.minimum(td, n - 2)
    return td, t - td


def bilinear_tp(table, temps, press, T, p, *,
                log_temp: bool = False, clamp_lo: float = 0.001):
    """Bilinear interpolation in (T, log10 P) of a pre-tabulated quantity.

    Args:
      table: [ntemp, npress, ...trailing] values on the (T, P) grid.
      temps: [ntemp] table temperatures (uniformly spaced; in log10 if
        ``log_temp``).
      press: [npress] table pressures (uniform in log10).
      T, p: [n] atmospheric temperatures and pressures to evaluate at.
      log_temp: interpolate in log10(T) (used for c_p / entropy tables,
        kernels.cu:777-779).

    Returns [n, ...trailing].
    """
    ntemp, npress = table.shape[0], table.shape[1]
    if log_temp:
        tx, t0 = jnp.log10(T), jnp.log10(temps[0])
        dT = (jnp.log10(temps[-1]) - jnp.log10(temps[0])) / (ntemp - 1.0)
    else:
        tx, t0 = T, temps[0]
        dT = (temps[-1] - temps[0]) / (ntemp - 1.0)
    dP = (jnp.log10(press[-1]) - jnp.log10(press[0])) / (npress - 1.0)

    td, wt = _fractional_index(tx, t0, dT, ntemp, clamp_lo)
    pd, wp = _fractional_index(jnp.log10(p), jnp.log10(press[0]), dP,
                               npress, clamp_lo)

    v00 = table[td, pd]
    v01 = table[td, pd + 1]
    v10 = table[td + 1, pd]
    v11 = table[td + 1, pd + 1]

    extra_dims = (1,) * (table.ndim - 2)
    wt = wt.reshape(wt.shape + extra_dims)
    wp = wp.reshape(wp.shape + extra_dims)

    return (v00 * (1 - wp) * (1 - wt) + v01 * wp * (1 - wt)
            + v10 * (1 - wp) * wt + v11 * wp * wt)


def interpolate_opacity(ktable, scat_cross_table, temps, press, T, p):
    """Premixed opacity + Rayleigh cross-section interpolation.

    Vectorized equivalent of opac_interpol (kernels.cu:524-609).

    Args:
      ktable: [ntemp, npress, nbin, ny] opacities [cm^2/g].
      scat_cross_table: [ntemp, npress, nbin] Rayleigh cross sections [cm^2].
      temps/press: table grids; T/p: [n] profile values.

    Returns (opac [n, nbin, ny], scat_cross [n, nbin]).
    """
    opac = bilinear_tp(ktable, temps, press, T, p)
    scat = bilinear_tp(scat_cross_table, temps, press, T, p)
    return opac, scat


def interpolate_species_opacity(ktable, temps, press, T, p):
    """Per-species opacity interpolation (opac_species_interpol,
    kernels.cu:3209-3259; clamps to [0, n-1] instead of [0.001, ...])."""
    return bilinear_tp(ktable, temps, press, T, p, clamp_lo=0.0)


def interpolate_meanmolmass(meanmass_table, temps, press, T, p):
    """Mean molecular mass interpolation (kernels.cu:649-698)."""
    return bilinear_tp(meanmass_table, temps, press, T, p)


def interpolate_kappa(kappa_table, temps, press, T, p):
    """Adiabatic coefficient kappa(T, P), linear-T log-P (kernels.cu:703-756)."""
    return bilinear_tp(kappa_table, temps, press, T, p)


def interpolate_cp(cp_table, temps, press, T, p):
    """Heat capacity c_p(T, P), log-log (kernels.cu:761-810)."""
    return bilinear_tp(cp_table, temps, press, T, p, log_temp=True)


def interpolate_entropy(entropy_table, temps, press, T, p):
    """Entropy(T, P), log-log (kernels.cu:815-865)."""
    return bilinear_tp(entropy_table, temps, press, T, p, log_temp=True)


def interpolate_phase_number(state_table, temps, press, T, p):
    """Water phase state number, linear-T log-P (kernels.cu:869-919)."""
    return bilinear_tp(state_table, temps, press, T, p)
