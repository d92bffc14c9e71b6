"""Flat-layout fast path: the per-iteration compute pipeline on [.., S]
arrays, S = nbin * ny.

Flattening the spectral axes to S = bin*y gives every per-layer operation
one long contiguous axis of independent columns, instead of a short
trailing y axis of 20 points; the sweep kernels give one lane to each
column of it.

The modules in ops/ keep the reference-shaped [L, B, Y] implementations --
they are the tested oracle; everything here is verified against them.
Ordering: s = b * ny + y (bin-major), so a contiguous shard of S is a
contiguous run of wavelength bins.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from helios_tpu import constants as pc
from helios_tpu.ops.twostream import (E_maybe, G_limiter, _G_pm,
                                      single_scat_albedo, trans_func,
                                      zeta_minus, zeta_plus)


def band_to_flat(x_band, ny: int):
    """[.., B] -> [.., B*ny] repeating each band value over its y-points."""
    return jnp.repeat(x_band, ny, axis=-1)


def cube_to_flat(x):
    """[.., B, Y] -> [.., B*Y]."""
    return x.reshape(x.shape[:-2] + (x.shape[-2] * x.shape[-1],))


def flat_to_cube(x, ny: int):
    """[.., S] -> [.., B, Y]."""
    return x.reshape(x.shape[:-1] + (x.shape[-1] // ny, ny))


class FlatCells(NamedTuple):
    """Per-cell two-stream quantities, flat layout [L, S]."""
    w0: jnp.ndarray
    delta_tau: jnp.ndarray         # gas-only optical depth
    delta_tau_total: jnp.ndarray   # gas + clouds
    trans: jnp.ndarray
    M: jnp.ndarray
    N: jnp.ndarray
    P: jnp.ndarray
    G_pl: jnp.ndarray
    G_min: jnp.ndarray
    g0: jnp.ndarray                # effective asymmetry, flat


def cell_quantities_flat(opac_flat, meanmolmass, ray_band, cloud_abs_band,
                         cloud_scat_band, delta_colmass, g0_band, ny, *,
                         epsi, epsi2, mu_star, w_0_limit, scat_corr,
                         i2s_transition) -> FlatCells:
    """Flat-layout calc_trans cell quantities (ops.twostream
    ._cell_quantities math; kernels.cu:1015-1104).

    opac_flat: [L, S]; per-band inputs [L, B]; delta_colmass/meanmolmass
    [L]; returns FlatCells with [L, S] members.
    """
    mmm = meanmolmass[:, None]
    dcm = delta_colmass[:, None]

    scat_tot = band_to_flat(ray_band + cloud_scat_band, ny)
    cloud_abs = band_to_flat(cloud_abs_band, ny)
    abs_tot = opac_flat * mmm + cloud_abs
    w0 = single_scat_albedo(scat_tot, abs_tot, w_0_limit)

    delta_tau = dcm * (opac_flat + band_to_flat(ray_band, ny) / mmm)
    delta_tau_clouds = (dcm * band_to_flat(
        cloud_abs_band + cloud_scat_band, ny) / mmm)
    del_tau = delta_tau + delta_tau_clouds

    g0 = band_to_flat(g0_band, ny)
    trans = trans_func(epsi, del_tau, w0, g0, scat_corr, i2s_transition)
    zm = zeta_minus(w0, g0, scat_corr, i2s_transition)
    zp = zeta_plus(w0, g0, scat_corr, i2s_transition)

    M = zm * zm * trans * trans - zp * zp
    N = zp * zm * (1.0 - trans * trans)
    P = (zm * zm - zp * zp) * trans

    G_pl = G_limiter(_G_pm(w0, g0, epsi, epsi2, mu_star, scat_corr,
                           i2s_transition, +1.0))
    G_min = G_limiter(_G_pm(w0, g0, epsi, epsi2, mu_star, scat_corr,
                            i2s_transition, -1.0))

    return FlatCells(w0=w0, delta_tau=delta_tau, delta_tau_total=del_tau,
                     trans=trans, M=M, N=N, P=P, G_pl=G_pl, G_min=G_min,
                     g0=g0)


# --------------------------------------------------------------------------- #
# direct beam
# --------------------------------------------------------------------------- #

def _rev_cumsum_above(dtau):
    """[L, S] -> [L+1, S]: row i = sum of dtau over layers l >= i (the
    optical depth above interface i); row L (TOA) is zero."""
    rev = jnp.cumsum(dtau[::-1], axis=0)[::-1]
    return jnp.concatenate([rev, jnp.zeros_like(dtau[:1])], axis=0)


def fdir_iso_flat(planck_star_flat, delta_tau_tot, mu_weights, *,
                  mu_star, R_star, a, dir_beam):
    """Flat direct beam: F_dir [I, S] (ops.beam.fdir_iso math).

    mu_weights: [I, L] masked 1/mu matrix for the geometric
    zenith-corrected path (ops.beam._mu_star_matrix logic), or ``None``
    for plain mu*: the exponent then degenerates to a cumulative sum
    over layers -- O(L) instead of the O(L^2) per-interface loop of the
    reference (fdir_iso, kernels.cu:1296-1307)."""
    I_dir = (R_star / a) ** 2 * pc.PI * planck_star_flat   # [S]
    if mu_weights is None:
        expo = _rev_cumsum_above(delta_tau_tot) / mu_star
    else:
        expo = jnp.sum(mu_weights[:, :, None] * delta_tau_tot[None, :, :],
                       axis=1)
    F0 = -dir_beam * mu_star * I_dir
    return F0[None, :] * jnp.exp(expo)


def fdir_noniso_flat(planck_star_flat, dtau_up, dtau_low, mu_weights,
                     mu_diag, *, mu_star, R_star, a, dir_beam):
    """Flat non-isothermal beam: (F_dir [I,S], Fc_dir [L,S]).

    ``mu_weights=None`` selects the cumulative-sum path (plain mu*, no
    zenith-geometry correction), see fdir_iso_flat."""
    I_dir = (R_star / a) ** 2 * pc.PI * planck_star_flat
    dtau_full = dtau_up + dtau_low
    F0 = -dir_beam * mu_star * I_dir

    if mu_weights is None:
        above = _rev_cumsum_above(dtau_full)
        F_dir = F0[None, :] * jnp.exp(above / mu_star)
        # Fc_dir[i]: full layers strictly above i + upper half of layer i
        Fc_dir = F0[None, :] * jnp.exp((above[1:] + dtau_up) / mu_star)
        return F_dir, Fc_dir

    expo_full = jnp.sum(mu_weights[:, :, None] * dtau_full[None, :, :],
                        axis=1)
    F_dir = F0[None, :] * jnp.exp(expo_full)

    L = dtau_up.shape[0]
    mask_gt = (jnp.arange(L)[None, :] > jnp.arange(L)[:, None])
    W_above = jnp.where(mask_gt, mu_weights[:L], 0.0)
    expo_c = (jnp.sum(W_above[:, :, None] * dtau_full[None, :, :], axis=1)
              + dtau_up / mu_diag[:, None])
    Fc_dir = F0[None, :] * jnp.exp(expo_c)
    return F_dir, Fc_dir


# --------------------------------------------------------------------------- #
# iterative sweeps (flat)
# --------------------------------------------------------------------------- #

class FlatIsoCoeffs(NamedTuple):
    a: jnp.ndarray          # P/M        [L, S]
    b_nm: jnp.ndarray       # -N/M       [L, S]
    src_down: jnp.ndarray   # [L, S]
    src_up: jnp.ndarray     # [L, S]
    boa_refl: jnp.ndarray   # [S]
    boa_emis: jnp.ndarray   # [S]
    toa: jnp.ndarray        # [S]


def iso_sweep_coeffs_flat(cells: FlatCells, planck_lay_flat,
                          planck_star_flat, planck_surf_flat, F_dir,
                          surf_albedo_flat, *, scat_corr, i2s_transition,
                          epsi, mu_star, dir_beam, f_factor, R_star, a
                          ) -> FlatIsoCoeffs:
    """Flat iso sweep coefficients (ops.sweep.iso_sweep_coeffs math)."""
    w0, M, N, P = cells.w0, cells.M, cells.N, cells.P
    G_pl, G_min = cells.G_pl, cells.G_min
    E = E_maybe(w0, cells.g0, scat_corr, i2s_transition)

    planck = (2.0 * pc.PI * epsi * (1.0 - w0) / (E - w0) * planck_lay_flat
              * (N + M - P))
    inv_neg_mu = 1.0 / (-mu_star)
    Fd_top, Fd_bot = F_dir[1:], F_dir[:-1]
    dir_down = jnp.minimum(
        0.0, Fd_bot * inv_neg_mu * (G_min * M + G_pl * N)
        - Fd_top * inv_neg_mu * P * G_min)
    dir_up = jnp.minimum(
        0.0, Fd_top * inv_neg_mu * (G_min * N + G_pl * M)
        - Fd_bot * inv_neg_mu * P * G_pl)

    boa_emis = ((1.0 - surf_albedo_flat) * pc.PI
                * (1.0 - w0[0]) / (E[0] - w0[0]) * planck_surf_flat)
    toa = ((1.0 - dir_beam) * f_factor * (R_star / a) ** 2 * pc.PI
           * planck_star_flat)

    return FlatIsoCoeffs(a=P / M, b_nm=-N / M,
                         src_down=(planck + dir_down) / M,
                         src_up=(planck + dir_up) / M,
                         boa_refl=surf_albedo_flat, boa_emis=boa_emis,
                         toa=toa)


class IsoCoeffCache(NamedTuple):
    """The temperature-independent part of FlatIsoCoeffs, precomputed at
    cell-cache refresh time (every 10th iteration).

    The reference recomputes the full coefficient set every flux solve
    (fband_iso reads M/N/P/G each call, kernels.cu:1366-1515); but between
    cache refreshes only the Planck arrays change, and every source term
    is LINEAR in them -- so the per-iteration work collapses to two fmas:
      src_down = planck_coeff * B_lay + dir_down
      src_up   = planck_coeff * B_lay + dir_up
      boa_emis = boa_coeff * B_surf
    This keeps the coefficient pipeline out of the per-iteration hot loop.
    """
    a: jnp.ndarray             # P/M                       [L, S]
    b_nm: jnp.ndarray          # -N/M                      [L, S]
    planck_coeff: jnp.ndarray  # 2*pi*eps*(1-w0)/(E-w0)*(N+M-P)/M  [L, S]
    dir_down: jnp.ndarray      # min(0, ...)/M             [L, S]
    dir_up: jnp.ndarray        # min(0, ...)/M             [L, S]
    boa_coeff: jnp.ndarray     # (1-alb)*pi*(1-w0_0)/(E_0-w0_0)  [S]
    boa_refl: jnp.ndarray      # [S]
    toa: jnp.ndarray           # [S] (star row is iteration-invariant)


def iso_coeff_cache(cells: FlatCells, planck_star_flat, F_dir,
                    surf_albedo_flat, *, scat_corr, i2s_transition, epsi,
                    mu_star, dir_beam, f_factor, R_star, a
                    ) -> IsoCoeffCache:
    """Precompute the static iso sweep coefficients (math of
    ops.sweep.iso_sweep_coeffs, refactored into Planck-linear form)."""
    w0, M, N, P = cells.w0, cells.M, cells.N, cells.P
    G_pl, G_min = cells.G_pl, cells.G_min
    E = E_maybe(w0, cells.g0, scat_corr, i2s_transition)

    planck_coeff = (2.0 * pc.PI * epsi * (1.0 - w0) / (E - w0)
                    * (N + M - P)) / M
    inv_neg_mu = 1.0 / (-mu_star)
    Fd_top, Fd_bot = F_dir[1:], F_dir[:-1]
    dir_down = jnp.minimum(
        0.0, Fd_bot * inv_neg_mu * (G_min * M + G_pl * N)
        - Fd_top * inv_neg_mu * P * G_min) / M
    dir_up = jnp.minimum(
        0.0, Fd_top * inv_neg_mu * (G_min * N + G_pl * M)
        - Fd_bot * inv_neg_mu * P * G_pl) / M

    boa_coeff = ((1.0 - surf_albedo_flat) * pc.PI
                 * (1.0 - w0[0]) / (E[0] - w0[0]))
    toa = ((1.0 - dir_beam) * f_factor * (R_star / a) ** 2 * pc.PI
           * planck_star_flat)
    return IsoCoeffCache(a=P / M, b_nm=-N / M, planck_coeff=planck_coeff,
                         dir_down=dir_down, dir_up=dir_up,
                         boa_coeff=boa_coeff, boa_refl=surf_albedo_flat,
                         toa=toa)


def iso_coeffs_from_cache(cc: IsoCoeffCache, planck_lay_flat,
                          planck_surf_flat) -> FlatIsoCoeffs:
    """Assemble the per-iteration FlatIsoCoeffs: two fmas + one mul."""
    return FlatIsoCoeffs(
        a=cc.a, b_nm=cc.b_nm,
        src_down=cc.planck_coeff * planck_lay_flat + cc.dir_down,
        src_up=cc.planck_coeff * planck_lay_flat + cc.dir_up,
        boa_refl=cc.boa_refl,
        boa_emis=cc.boa_coeff * planck_surf_flat,
        toa=cc.toa)


def fband_iso_flat(C: FlatIsoCoeffs, F_dir0, F_up_prev, *, n_passes: int,
                   use_pallas: bool):
    """Iterative iso solve on flat arrays; returns (F_down, F_up) [I, S].

    ``use_pallas``: run the fused GPU kernel (kernels/sweep_triton.py)
    instead of the `lax.scan` form below."""
    if use_pallas:
        from helios_tpu.kernels import sweep_triton
        return sweep_triton.iso_sweep(
            C.a, C.b_nm, C.src_down, C.src_up, C.toa, C.boa_refl,
            C.boa_emis, F_dir0, F_up_prev, n_passes=n_passes)

    toa = jnp.broadcast_to(C.toa, F_up_prev.shape[1:]).astype(
        F_up_prev.dtype)

    def one_pass(_, FdFu):
        _, F_up = FdFu

        def dstep(carry, xs):
            a_i, bn_i, s_i, fu_i = xs
            f = a_i * carry + bn_i * fu_i + s_i
            return f, f

        _, downs = jax.lax.scan(
            dstep, toa,
            (C.a[::-1], C.b_nm[::-1], C.src_down[::-1], F_up[:-1][::-1]))
        F_down = jnp.concatenate([downs[::-1], toa[None]], axis=0)

        boa = C.boa_refl * (F_dir0 + F_down[0]) + C.boa_emis

        def ustep(carry, xs):
            a_i, bn_i, s_i, fd_i = xs
            f = a_i * carry + bn_i * fd_i + s_i
            return f, f

        _, ups = jax.lax.scan(ustep, boa, (C.a, C.b_nm, C.src_up,
                                           F_down[1:]))
        F_up_new = jnp.concatenate([boa[None], ups], axis=0)
        return F_down, F_up_new

    F_down0 = jnp.zeros_like(F_up_prev)
    return jax.lax.fori_loop(0, n_passes, one_pass, (F_down0, F_up_prev))


class FlatNonIsoCoeffs(NamedTuple):
    a_up: jnp.ndarray
    b_up: jnp.ndarray
    src_up_down: jnp.ndarray
    src_up_up: jnp.ndarray
    a_low: jnp.ndarray
    b_low: jnp.ndarray
    src_low_down: jnp.ndarray
    src_low_up: jnp.ndarray
    boa_refl: jnp.ndarray
    boa_emis: jnp.ndarray
    toa: jnp.ndarray


def _noniso_planck_terms_flat(Bt, Bb, M, N, P, del_tau, epsi, E, w0, g0,
                              delta_tau_limit, up_direction: bool):
    """ops.sweep._noniso_planck_terms on flat arrays."""
    iso_term = 0.5 * (Bt + Bb) * (N + M - P)
    grad = (Bt - Bb) / jnp.maximum(del_tau, 1e-30)
    if up_direction:
        noniso = (Bt * (M + N) - Bb * P
                  + epsi / (E * (1.0 - w0 * g0)) * (M - N - P) * (-grad))
    else:
        noniso = (Bt * (M + N) - Bb * P
                  + epsi / (E * (1.0 - w0 * g0)) * (P - M + N) * grad)
    return jnp.where(del_tau < delta_tau_limit, iso_term, noniso)


def noniso_sweep_coeffs_flat(upper: FlatCells, lower: FlatCells,
                             B_lay, B_int_below, B_int_above, B_star,
                             B_surf, F_dir, Fc_dir, surf_albedo_flat, *,
                             scat_corr, i2s_transition, epsi, mu_star,
                             dir_beam, f_factor, R_star, a,
                             delta_tau_limit) -> FlatNonIsoCoeffs:
    """Flat non-iso sweep coefficients (ops.sweep.noniso_sweep_coeffs
    math).  All Planck inputs pre-flattened [L, S] (or [S] for star/surf).
    """
    inv_neg_mu = 1.0 / (-mu_star)
    out = {}
    for half, cells in (("up", upper), ("low", lower)):
        w0, M, N, P = cells.w0, cells.M, cells.N, cells.P
        G_pl, G_min = cells.G_pl, cells.G_min
        E = E_maybe(w0, cells.g0, scat_corr, i2s_transition)
        del_tau = cells.delta_tau_total
        pref = 2.0 * pc.PI * epsi * (1.0 - w0) / (E - w0)

        if half == "up":
            pl_down = _noniso_planck_terms_flat(
                B_lay, B_int_above, M, N, P, del_tau, epsi, E, w0,
                cells.g0, delta_tau_limit, False)
            pl_up = _noniso_planck_terms_flat(
                B_int_above, B_lay, M, N, P, del_tau, epsi, E, w0,
                cells.g0, delta_tau_limit, True)
            dir_down = jnp.minimum(
                0.0, Fc_dir * inv_neg_mu * (G_min * M + G_pl * N)
                - F_dir[1:] * inv_neg_mu * G_min * P)
            dir_up = jnp.minimum(
                0.0, F_dir[1:] * inv_neg_mu * (G_min * N + G_pl * M)
                - Fc_dir * inv_neg_mu * P * G_pl)
        else:
            pl_down = _noniso_planck_terms_flat(
                B_int_below, B_lay, M, N, P, del_tau, epsi, E, w0,
                cells.g0, delta_tau_limit, False)
            pl_up = _noniso_planck_terms_flat(
                B_lay, B_int_below, M, N, P, del_tau, epsi, E, w0,
                cells.g0, delta_tau_limit, True)
            dir_down = jnp.minimum(
                0.0, F_dir[:-1] * inv_neg_mu * (G_min * M + G_pl * N)
                - Fc_dir * inv_neg_mu * P * G_min)
            dir_up = jnp.minimum(
                0.0, Fc_dir * inv_neg_mu * (G_min * N + G_pl * M)
                - F_dir[:-1] * inv_neg_mu * P * G_pl)
            w0_0, E_0 = w0[0], E[0]

        out[f"a_{half}"] = P / M
        out[f"b_{half}"] = -N / M
        out[f"src_{half}_down"] = (pref * pl_down + dir_down) / M
        out[f"src_{half}_up"] = (pref * pl_up + dir_up) / M

    boa_emis = ((1.0 - surf_albedo_flat) * pc.PI
                * (1.0 - w0_0) / (E_0 - w0_0) * B_surf)
    toa = ((1.0 - dir_beam) * f_factor * (R_star / a) ** 2 * pc.PI
           * B_star)
    return FlatNonIsoCoeffs(
        a_up=out["a_up"], b_up=out["b_up"],
        src_up_down=out["src_up_down"], src_up_up=out["src_up_up"],
        a_low=out["a_low"], b_low=out["b_low"],
        src_low_down=out["src_low_down"], src_low_up=out["src_low_up"],
        boa_refl=surf_albedo_flat, boa_emis=boa_emis, toa=toa)


class NonIsoCoeffCache(NamedTuple):
    """Temperature-independent non-iso sweep coefficients (the analogue of
    IsoCoeffCache): every source term of noniso_sweep_coeffs_flat is
    linear in its two Planck inputs (Bt, Bb), including the
    delta_tau < limit isothermal fallback -- the select only involves
    cache-static quantities.  Per direction/half:
        src = At * Bt + Ab * Bb + D
    with (Bt, Bb) drawn per half from (B_lay, B_int_above, B_int_below).
    """
    a_up: jnp.ndarray
    b_up: jnp.ndarray
    a_low: jnp.ndarray
    b_low: jnp.ndarray
    # src_up_down: Bt = B_lay, Bb = B_int_above
    At_ud: jnp.ndarray
    Ab_ud: jnp.ndarray
    D_ud: jnp.ndarray
    # src_up_up: Bt = B_int_above, Bb = B_lay
    At_uu: jnp.ndarray
    Ab_uu: jnp.ndarray
    D_uu: jnp.ndarray
    # src_low_down: Bt = B_int_below, Bb = B_lay
    At_ld: jnp.ndarray
    Ab_ld: jnp.ndarray
    D_ld: jnp.ndarray
    # src_low_up: Bt = B_lay, Bb = B_int_below
    At_lu: jnp.ndarray
    Ab_lu: jnp.ndarray
    D_lu: jnp.ndarray
    boa_coeff: jnp.ndarray     # [S]
    boa_refl: jnp.ndarray      # [S]
    toa: jnp.ndarray           # [S]


def _noniso_planck_linear(M, N, P, del_tau, epsi, E, w0, g0,
                          delta_tau_limit):
    """(alpha_t, alpha_b) with planck_terms = alpha_t*Bt + alpha_b*Bb
    (the linear-in-Planck form of _noniso_planck_terms_flat).

    Both sweep directions yield the SAME coefficients: the up branch is
    c*(M-N-P)*(-grad) and the down branch c*(P-M+N)*grad with
    (P-M+N) == -(M-N-P), so the direction sign cancels -- the directions
    differ only in which Planck arrays feed (Bt, Bb)."""
    iso_c = 0.5 * (N + M - P)
    c_over_d = (epsi / (E * (1.0 - w0 * g0))
                / jnp.maximum(del_tau, 1e-30) * (M - N - P))
    a_t = (M + N) - c_over_d
    a_b = -P + c_over_d
    small = del_tau < delta_tau_limit
    return jnp.where(small, iso_c, a_t), jnp.where(small, iso_c, a_b)


def noniso_coeff_cache(upper: FlatCells, lower: FlatCells, B_star,
                       F_dir, Fc_dir, surf_albedo_flat, *, scat_corr,
                       i2s_transition, epsi, mu_star, dir_beam, f_factor,
                       R_star, a, delta_tau_limit) -> NonIsoCoeffCache:
    """Precompute the static non-iso coefficients (math of
    noniso_sweep_coeffs_flat, refactored into Planck-linear form)."""
    inv_neg_mu = 1.0 / (-mu_star)
    out = {}
    for half, cells in (("up", upper), ("low", lower)):
        w0, M, N, P = cells.w0, cells.M, cells.N, cells.P
        G_pl, G_min = cells.G_pl, cells.G_min
        E = E_maybe(w0, cells.g0, scat_corr, i2s_transition)
        del_tau = cells.delta_tau_total
        pref_M = 2.0 * pc.PI * epsi * (1.0 - w0) / (E - w0) / M

        at_d, ab_d = _noniso_planck_linear(
            M, N, P, del_tau, epsi, E, w0, cells.g0, delta_tau_limit)
        at_u, ab_u = at_d, ab_d

        if half == "up":
            dir_down = jnp.minimum(
                0.0, Fc_dir * inv_neg_mu * (G_min * M + G_pl * N)
                - F_dir[1:] * inv_neg_mu * G_min * P)
            dir_up = jnp.minimum(
                0.0, F_dir[1:] * inv_neg_mu * (G_min * N + G_pl * M)
                - Fc_dir * inv_neg_mu * P * G_pl)
        else:
            dir_down = jnp.minimum(
                0.0, F_dir[:-1] * inv_neg_mu * (G_min * M + G_pl * N)
                - Fc_dir * inv_neg_mu * P * G_min)
            dir_up = jnp.minimum(
                0.0, Fc_dir * inv_neg_mu * (G_min * N + G_pl * M)
                - F_dir[:-1] * inv_neg_mu * P * G_pl)
            w0_0, E_0 = w0[0], E[0]

        out[f"a_{half}"] = P / M
        out[f"b_{half}"] = -N / M
        k = "u" if half == "up" else "l"
        out[f"At_{k}d"] = pref_M * at_d
        out[f"Ab_{k}d"] = pref_M * ab_d
        out[f"D_{k}d"] = dir_down / M
        out[f"At_{k}u"] = pref_M * at_u
        out[f"Ab_{k}u"] = pref_M * ab_u
        out[f"D_{k}u"] = dir_up / M

    boa_coeff = ((1.0 - surf_albedo_flat) * pc.PI
                 * (1.0 - w0_0) / (E_0 - w0_0))
    toa = ((1.0 - dir_beam) * f_factor * (R_star / a) ** 2 * pc.PI
           * B_star)
    return NonIsoCoeffCache(
        a_up=out["a_up"], b_up=out["b_up"], a_low=out["a_low"],
        b_low=out["b_low"],
        At_ud=out["At_ud"], Ab_ud=out["Ab_ud"], D_ud=out["D_ud"],
        At_uu=out["At_uu"], Ab_uu=out["Ab_uu"], D_uu=out["D_uu"],
        At_ld=out["At_ld"], Ab_ld=out["Ab_ld"], D_ld=out["D_ld"],
        At_lu=out["At_lu"], Ab_lu=out["Ab_lu"], D_lu=out["D_lu"],
        boa_coeff=boa_coeff, boa_refl=surf_albedo_flat, toa=toa)


def noniso_coeffs_from_cache(cc: NonIsoCoeffCache, B_lay, B_int_below,
                             B_int_above, B_surf) -> FlatNonIsoCoeffs:
    """Assemble the per-iteration FlatNonIsoCoeffs: 4 x (2 fma) + 1 mul."""
    return FlatNonIsoCoeffs(
        a_up=cc.a_up, b_up=cc.b_up,
        src_up_down=cc.At_ud * B_lay + cc.Ab_ud * B_int_above + cc.D_ud,
        src_up_up=cc.At_uu * B_int_above + cc.Ab_uu * B_lay + cc.D_uu,
        a_low=cc.a_low, b_low=cc.b_low,
        src_low_down=cc.At_ld * B_int_below + cc.Ab_ld * B_lay + cc.D_ld,
        src_low_up=cc.At_lu * B_lay + cc.Ab_lu * B_int_below + cc.D_lu,
        boa_refl=cc.boa_refl,
        boa_emis=cc.boa_coeff * B_surf,
        toa=cc.toa)


def fband_noniso_flat(C: FlatNonIsoCoeffs, F_dir0, F_up_prev, Fc_up_prev,
                      *, n_passes: int, use_pallas: bool = False):
    """Iterative non-iso solve (flat); returns (F_down, F_up, Fc_down,
    Fc_up).  ``use_pallas`` as in fband_iso_flat."""
    if use_pallas:
        from helios_tpu.kernels import sweep_triton
        return sweep_triton.noniso_sweep(
            C.a_up, C.b_up, C.src_up_down, C.src_up_up, C.a_low, C.b_low,
            C.src_low_down, C.src_low_up, C.toa, C.boa_refl, C.boa_emis,
            F_dir0, F_up_prev, Fc_up_prev, n_passes=n_passes)

    toa = jnp.broadcast_to(C.toa, F_up_prev.shape[1:]).astype(
        F_up_prev.dtype)

    def down_pass(F_up, Fc_up):
        def step(carry, xs):
            a_up, b_up, s_ud, a_low, b_low, s_ld, fcu, fu = xs
            fc_down = a_up * carry + b_up * fcu + s_ud
            f_down = a_low * fc_down + b_low * fu + s_ld
            return f_down, (f_down, fc_down)

        xs = tuple(arr[::-1] for arr in (
            C.a_up, C.b_up, C.src_up_down, C.a_low, C.b_low,
            C.src_low_down, Fc_up, F_up[:-1]))
        _, (downs, fc_downs) = jax.lax.scan(step, toa, xs)
        return (jnp.concatenate([downs[::-1], toa[None]], axis=0),
                fc_downs[::-1])

    def up_pass(F_down, Fc_down):
        boa = C.boa_refl * (F_dir0 + F_down[0]) + C.boa_emis

        def step(carry, xs):
            a_low, b_low, s_lu, a_up, b_up, s_uu, fcd, fd_above = xs
            fc_up = a_low * carry + b_low * fcd + s_lu
            f_up = a_up * fc_up + b_up * fd_above + s_uu
            return f_up, (f_up, fc_up)

        xs = (C.a_low, C.b_low, C.src_low_up, C.a_up, C.b_up, C.src_up_up,
              Fc_down, F_down[1:])
        _, (ups, fc_ups) = jax.lax.scan(step, boa, xs)
        return jnp.concatenate([boa[None], ups], axis=0), fc_ups

    def one_pass(_, state):
        F_down, F_up, Fc_down, Fc_up = state
        F_down, Fc_down = down_pass(F_up, Fc_up)
        F_up, Fc_up = up_pass(F_down, Fc_down)
        return F_down, F_up, Fc_down, Fc_up

    F_down0 = jnp.zeros_like(F_up_prev)
    Fc_down0 = jnp.zeros_like(Fc_up_prev)
    return jax.lax.fori_loop(0, n_passes, one_pass,
                             (F_down0, F_up_prev, Fc_down0, Fc_up_prev))


# --------------------------------------------------------------------------- #
# spectral integration (flat)
# --------------------------------------------------------------------------- #

def gauss_band_flat(f_flat, gauss_weight):
    """[.., S] -> [.., B]: 0.5 * sum_y w_y f (multiply + axis-sum)."""
    ny = gauss_weight.shape[0]
    return 0.5 * jnp.sum(flat_to_cube(f_flat, ny) * gauss_weight, axis=-1)
