"""Spectral integration and post-processing reductions.

Vectorized replacements for the reference's atomicAdd-based reductions
(integrate_flux_double, kernels.cu:2428-2513) and the post-processing
kernels (:2888-3139): plain weighted contractions that XLA compiles to
fixed reductions, deterministic by construction (fixed reduction order -- important
for the 1e-8 equilibrium criterion under sharding, SURVEY.md section 7.2).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from helios_tpu import constants as pc
from helios_tpu.planck import dB_dT

# full-precision products in fp32 too (no TF32 on the GPU)
_HIGHEST = jax.lax.Precision.HIGHEST


def gauss_band(f_wg, gauss_weight):
    """Gauss-quadrature reduction over the y axis: 0.5 * sum_y w_y f.

    f_wg: [..., B, Y]; returns [..., B].  (kernels.cu:2474-2476)
    """
    return 0.5 * jnp.einsum("...by,y->...b", f_wg, gauss_weight,
                            precision=_HIGHEST)


class FluxTotals(NamedTuple):
    F_down_band: jnp.ndarray   # [I, B] (excl. direct)
    F_up_band: jnp.ndarray     # [I, B]
    F_dir_band: jnp.ndarray    # [I, B]
    F_down_tot: jnp.ndarray    # [I]  (incl. direct)
    F_up_tot: jnp.ndarray      # [I]
    F_net: jnp.ndarray         # [I]  F_up - F_down


def integrate_flux(F_down_wg, F_up_wg, F_dir_wg, gauss_weight,
                   delta_lambda) -> FluxTotals:
    """Band and total flux integration (kernels.cu:2428-2513)."""
    F_down_band = gauss_band(F_down_wg, gauss_weight)
    F_up_band = gauss_band(F_up_wg, gauss_weight)
    F_dir_band = gauss_band(F_dir_wg, gauss_weight)
    F_up_tot = jnp.einsum("ib,b->i", F_up_band, delta_lambda,
                          precision=_HIGHEST)
    F_down_tot = jnp.einsum("ib,b->i", F_dir_band + F_down_band,
                            delta_lambda, precision=_HIGHEST)
    return FluxTotals(F_down_band=F_down_band, F_up_band=F_up_band,
                      F_dir_band=F_dir_band, F_down_tot=F_down_tot,
                      F_up_tot=F_up_tot, F_net=F_up_tot - F_down_tot)


def integrate_beamflux(F_dir_band, delta_lambda):
    """Total direct beam flux per interface (kernels.cu:3119-3139)."""
    return jnp.einsum("ib,b->i", F_dir_band, delta_lambda,
                      precision=_HIGHEST)


def integrate_optdepth_transmission_iso(delta_tau_wg, trans_wg, gauss_weight):
    """Band-integrated optical depth and transmission (kernels.cu:2888-2912).

    Returns (delta_tau_band [L, B], trans_band [L, B]).
    """
    return (gauss_band(delta_tau_wg, gauss_weight),
            gauss_band(trans_wg, gauss_weight))


def integrate_optdepth_transmission_noniso(delta_tau_up, delta_tau_low,
                                           trans_up, trans_low, gauss_weight):
    """Non-isothermal variant (kernels.cu:2916-2946); the transmission of a
    full layer is the product of its half-layer transmissions."""
    return (gauss_band(delta_tau_up + delta_tau_low, gauss_weight),
            gauss_band(trans_up * trans_low, gauss_weight))


def contribution_function(trans_wg, planckband_lay, gauss_weight, epsi):
    """Contribution function 2 pi eps B (1 - T_i) prod_{j>i} T_j.

    kernels.cu:2951-3019.  trans_wg: [L, B, Y] full-layer transmission (for
    non-iso pass trans_up*trans_low).  Returns (trans_weight_band [L, B],
    contr_func_band [L, B]).
    """
    L = trans_wg.shape[0]
    # cumulative product of transmissions above each layer:
    # trans_to_top[i] = prod_{j>i} trans[j]
    log_t = jnp.log(jnp.maximum(trans_wg, 1e-30))
    csum = jnp.cumsum(log_t[::-1], axis=0)[::-1]      # sum_{j>=i}
    trans_to_top = jnp.exp(csum - log_t)              # exclude own layer
    tw = gauss_band((1.0 - trans_wg) * trans_to_top, gauss_weight)
    B_lay = planckband_lay[:L]
    contr = 2.0 * pc.PI * epsi * B_lay * tw
    return tw, contr


def mean_opacities(opac_wg_lay, cloud_abs_cross_lay, meanmolmass_lay,
                   planckband_lay, lambda_edge, delta_lambda, T_lay,
                   gauss_weight, gauss_y, T_star):
    """Planck and Rosseland mean opacities per layer (kernels.cu:3024-3115).

    Returns dict with planck/ross means weighted by B(T_lay) and B(T_star),
    plus the band-integrated opacity.
    """
    L = opac_wg_lay.shape[0]
    opac_band = gauss_band(opac_wg_lay, gauss_weight)          # [L, B]
    kappa_tot = opac_band + cloud_abs_cross_lay / meanmolmass_lay[:, None]

    B_lay = planckband_lay[:L]                                  # [L, B]
    B_star = planckband_lay[L]                                  # [B]

    def planck_mean(B):
        num = jnp.sum(kappa_tot * B * delta_lambda, axis=-1)
        denom = jnp.sum(B * delta_lambda, axis=-1)
        return num / denom

    # integrated dB/dT over each bin via Gauss-Legendre on [edge, edge+1]
    # (kernels.cu:312-329): x = (y-0.5)*2, arg = half-width*x + midpoint
    lam_bot = lambda_edge[:-1]
    lam_top = lambda_edge[1:]
    half = 0.5 * (lam_top - lam_bot)                            # [B]
    mid = 0.5 * (lam_top + lam_bot)
    x = (gauss_y - 0.5) * 2.0                                   # [Y]
    arg = half[:, None] * x[None, :] + mid[:, None]             # [B, Y]

    def ross_mean(T):
        # T: [L] or scalar
        Tb = jnp.asarray(T)
        if Tb.ndim == 0:
            dB = dB_dT(arg, Tb)                                 # [B, Y]
            idB = half * jnp.einsum("by,y->b", dB, gauss_weight,
                                    precision=_HIGHEST)
            idB = idB[None, :]                                  # [1, B]
        else:
            dB = dB_dT(arg[None], Tb[:, None, None])            # [L, B, Y]
            idB = half[None] * jnp.einsum("lby,y->lb", dB, gauss_weight,
                                          precision=_HIGHEST)
        num = jnp.sum(idB, axis=-1)
        denom = jnp.sum(jnp.where(kappa_tot > 0, idB / kappa_tot, 0.0),
                        axis=-1)
        return num / denom

    planck_T_pl = planck_mean(B_lay)
    ross_T_pl = jnp.where(T_lay[:L] < 70.0, -3.0, ross_mean(T_lay[:L]))
    planck_T_star = planck_mean(B_star[None, :])
    ross_T_star = ross_mean(jnp.asarray(T_star))
    if T_star < 70.0:
        planck_T_star = jnp.full((L,), -3.0, opac_band.dtype)
        ross_T_star = jnp.full((L,), -3.0, opac_band.dtype)
    else:
        planck_T_star = jnp.broadcast_to(planck_T_star, (L,))
        ross_T_star = jnp.broadcast_to(ross_T_star, (L,))

    return dict(opac_band_lay=opac_band,
                planck_opac_T_pl=planck_T_pl, ross_opac_T_pl=ross_T_pl,
                planck_opac_T_star=planck_T_star,
                ross_opac_T_star=ross_T_star)
