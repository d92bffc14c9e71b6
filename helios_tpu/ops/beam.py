"""Direct stellar beam attenuation.

Redesign of fdir_iso / fdir_noniso (source/kernels.cu:1265-1362):
the reference runs an O(nlayer) sequential loop per interface (O(n^2) work
per spectral point, one CUDA thread each).  Here the same attenuation sums
are expressed as a single [ninterface, nlayer] x [nlayer, B*Y] matrix
contraction -- a matrix product -- using log-space accumulation:

  F_dir[i] = -dir_beam * mu* * I_dir * exp( sum_{j>=i} dtau[j] / mu(i,j) )

With the geometric zenith-angle correction, mu(i,j) depends on both the
target interface i and the traversed layer j (kernels.cu:1298-1303), which
is exactly a dense weight matrix; without it the matrix degenerates to a
masked 1/mu* triangle.  (mu* is negative, so the exponent is negative.)
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from helios_tpu import constants as pc

# full-precision products in fp32 too (no TF32 on the GPU)
_HIGHEST = jax.lax.Precision.HIGHEST


def _mu_star_matrix(z_lay, mu_star, R_planet, geom_zenith_corr: int,
                    ninterface: int, dtype):
    """mu(i, j): zenith cosine seen at interface i through layer j.

    Returns [ninterface, nlayer].  Reference kernels.cu:1296-1303.  Note the
    reference indexes z_lay[i] with the *interface* index i, pairing
    interface i with layer center i; we reproduce that exactly (z has length
    nlayer, so interface ninterface-1 reuses the top layer's z -- its row is
    masked out anyway since no layers lie above it).
    """
    nlayer = ninterface - 1
    if not geom_zenith_corr:
        return jnp.full((ninterface, nlayer), mu_star, dtype)
    z_i = jnp.concatenate([z_lay, z_lay[-1:]])        # [ninterface]
    ratio = (R_planet + z_i[:, None]) / (R_planet + z_lay[None, :])
    return -jnp.sqrt(1.0 - ratio ** 2 * (1.0 - mu_star ** 2))


def fdir_iso(planckband_lay, delta_tau_tot, z_lay, *,
             mu_star: float, R_planet: float, R_star: float, a: float,
             dir_beam: int, geom_zenith_corr: int):
    """Direct beam flux at interfaces, isothermal mode.

    Args:
      planckband_lay: [L+2, B]; row L is the stellar row.
      delta_tau_tot: [L, B, Y] total (gas+cloud) optical depth per layer.
      z_lay: [L] layer-center altitudes.

    Returns F_dir: [L+1, B, Y].
    """
    L, B, Y = delta_tau_tot.shape
    nint = L + 1
    dtype = delta_tau_tot.dtype

    I_dir = (R_star / a) ** 2 * pc.PI * planckband_lay[L]      # [B]

    mu_mat = _mu_star_matrix(z_lay, mu_star, R_planet, geom_zenith_corr,
                             nint, dtype)
    mask = (jnp.arange(L)[None, :] >= jnp.arange(nint)[:, None])
    W = jnp.where(mask, 1.0 / mu_mat, 0.0)                     # [nint, L]

    # exponent[i, b, y] = sum_j W[i,j] * dtau[j,b,y]
    expo = jnp.einsum("il,lby->iby", W, delta_tau_tot,
                      preferred_element_type=dtype, precision=_HIGHEST)
    F0 = -dir_beam * mu_star * I_dir                           # [B]
    return F0[None, :, None] * jnp.exp(expo)


def fdir_noniso(planckband_lay, delta_tau_up, delta_tau_low, z_lay, *,
                mu_star: float, R_planet: float, R_star: float, a: float,
                dir_beam: int, geom_zenith_corr: int):
    """Direct beam at interfaces and half-layer centers, non-isothermal mode.

    Reference kernels.cu:1313-1362: F_dir[i] attenuates through all full
    layers above interface i; Fc_dir[i] additionally passes the upper half
    of layer i (the reference computes Fc one loop step before finishing).

    Args:
      delta_tau_up/low: [L, B, Y] upper/lower half-layer optical depths
        (total gas+cloud).

    Returns (F_dir [L+1, B, Y], Fc_dir [L, B, Y]).
    """
    L, B, Y = delta_tau_up.shape
    nint = L + 1
    dtype = delta_tau_up.dtype

    I_dir = (R_star / a) ** 2 * pc.PI * planckband_lay[L]

    mu_mat = _mu_star_matrix(z_lay, mu_star, R_planet, geom_zenith_corr,
                             nint, dtype)
    mask_ge = (jnp.arange(L)[None, :] >= jnp.arange(nint)[:, None])
    W_full = jnp.where(mask_ge, 1.0 / mu_mat, 0.0)             # [nint, L]

    dtau_full = delta_tau_up + delta_tau_low
    expo_full = jnp.einsum("il,lby->iby", W_full, dtau_full,
                           preferred_element_type=dtype,
                           precision=_HIGHEST)
    F0 = -dir_beam * mu_star * I_dir
    F_dir = F0[None, :, None] * jnp.exp(expo_full)

    # Fc_dir[i]: full layers strictly above i, plus upper half of layer i.
    mask_gt = (jnp.arange(L)[None, :] > jnp.arange(L)[:, None])
    mu_c = mu_mat[:L]                                          # [L, L]
    W_above = jnp.where(mask_gt, 1.0 / mu_c, 0.0)
    mu_diag = jnp.diagonal(mu_c)                               # mu(i, i), [L]
    expo_c = (jnp.einsum("il,lby->iby", W_above, dtau_full,
                         preferred_element_type=dtype,
                         precision=_HIGHEST)
              + delta_tau_up / mu_diag[:, None, None])
    Fc_dir = F0[None, :, None] * jnp.exp(expo_c)
    return F_dir, Fc_dir
