"""Iterative spectral flux sweeps (the two-stream down/up recurrences).

Vectorized formulation of fband_iso / fband_noniso
(source/kernels.cu:1366-1799).  The reference runs, per (bin, Gauss-point)
CUDA thread, a sequential recurrence down over interfaces then up.  Here all
layer-local coefficients (Planck source terms, direct-beam terms, M/N/P
ratios) are precomputed as dense [L, B, Y] tensors *once per flux solve*,
and the only sequential part -- the first-order recurrences
F[i] = a[i] * F[i+1] + b[i] -- runs as `lax.scan` over layers with [B, Y]
carries, vectorized across the whole spectral grid.

Because up- and down-streams are coupled through scattering, the pair of
sweeps is repeated (3*scat + 1 times during iteration, 1000*scat + 1 in
post-processing -- reference computation.py:528-537); the repeats reuse the
precomputed coefficients, so each extra pass costs only the two scans.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from helios_tpu import constants as pc
from helios_tpu.ops.twostream import CellQuantities, E_maybe


def toa_incident_flux(planckband_lay, *, dir_beam, f_factor, R_star, a):
    """TOA downward boundary flux (kernels.cu:1420).  [B]."""
    nlayer = planckband_lay.shape[0] - 2
    return ((1.0 - dir_beam) * f_factor * (R_star / a) ** 2 * pc.PI
            * planckband_lay[nlayer])


class IsoSweepCoeffs(NamedTuple):
    """Precomputed layer-local coefficients for the isothermal sweeps."""
    a: jnp.ndarray        # P/M                  [L, B, Y]
    b_nm: jnp.ndarray     # -N/M                 [L, B, Y]
    src_down: jnp.ndarray  # (planck+direct)/M down-dir [L, B, Y]
    src_up: jnp.ndarray    # (planck+direct)/M up-dir   [L, B, Y]
    boa_refl: jnp.ndarray  # surface albedo      [B]
    boa_emis: jnp.ndarray  # (1-alb)*pi*(1-w0)/(E-w0)*B_surf at layer 0 [B, Y]
    toa: jnp.ndarray       # TOA incident flux   [B]


def iso_sweep_coeffs(cells: CellQuantities, planckband_lay, F_dir,
                     surf_albedo, *, scat_corr: int, i2s_transition: float,
                     epsi: float, mu_star: float, dir_beam: int,
                     f_factor: float, R_star: float, a: float
                     ) -> IsoSweepCoeffs:
    """Precompute everything layer-local in fband_iso (kernels.cu:1416-1515)."""
    L = cells.M.shape[0]
    nlayer = planckband_lay.shape[0] - 2
    w0, M, N, P = cells.w0, cells.M, cells.N, cells.P
    G_pl, G_min = cells.G_pl, cells.G_min
    g0b = cells.g0[:, :, None]
    E = E_maybe(w0, g0b, scat_corr, i2s_transition)

    B_lay = planckband_lay[:L][:, :, None]               # [L, B, 1]
    planck = 2.0 * pc.PI * epsi * (1.0 - w0) / (E - w0) * B_lay * (N + M - P)

    Fd_top = F_dir[1:]      # F_dir at interface i+1 (above layer i)
    Fd_bot = F_dir[:-1]     # F_dir at interface i
    inv_neg_mu = 1.0 / (-mu_star)
    dir_down = jnp.minimum(
        0.0, Fd_bot * inv_neg_mu * (G_min * M + G_pl * N)
        - Fd_top * inv_neg_mu * P * G_min)
    dir_up = jnp.minimum(
        0.0, Fd_top * inv_neg_mu * (G_min * N + G_pl * M)
        - Fd_bot * inv_neg_mu * P * G_pl)

    # BOA emission uses layer 0's w0/E (reference's stale-variable BC,
    # kernels.cu:1469-1474)
    B_surf = planckband_lay[nlayer + 1]                  # [B]
    boa_emis = ((1.0 - surf_albedo)[:, None] * pc.PI
                * (1.0 - w0[0]) / (E[0] - w0[0]) * B_surf[:, None])

    return IsoSweepCoeffs(
        a=P / M, b_nm=-N / M,
        src_down=(planck + dir_down) / M,
        src_up=(planck + dir_up) / M,
        boa_refl=surf_albedo,
        boa_emis=boa_emis,
        toa=toa_incident_flux(planckband_lay, dir_beam=dir_beam,
                              f_factor=f_factor, R_star=R_star, a=a))


def _down_scan(a, b_nm, src, F_up, toa_flux):
    """F_down[i] = a[i]*F_down[i+1] + b_nm[i]*F_up[i] + src[i], top to bottom.

    Returns F_down [L+1, B, Y] with F_down[L] = TOA boundary value.
    """
    def step(carry, xs):
        a_i, bn_i, s_i, fu_i = xs
        f = a_i * carry + bn_i * fu_i + s_i
        return f, f

    xs = (a[::-1], b_nm[::-1], src[::-1], F_up[:-1][::-1])
    _, downs = jax.lax.scan(step, toa_flux, xs)
    return jnp.concatenate([downs[::-1], toa_flux[None]], axis=0)


def _up_scan(a, b_nm, src, F_down, boa_flux):
    """F_up[i] = a[i-1]*F_up[i-1] + b_nm[i-1]*F_down[i] + src[i-1], bottom up.

    Returns F_up [L+1, B, Y] with F_up[0] = BOA boundary value.
    """
    def step(carry, xs):
        a_i, bn_i, s_i, fd_i = xs
        f = a_i * carry + bn_i * fd_i + s_i
        return f, f

    xs = (a, b_nm, src, F_down[1:])
    _, ups = jax.lax.scan(step, boa_flux, xs)
    return jnp.concatenate([boa_flux[None], ups], axis=0)


def fband_iso(cells: CellQuantities, planckband_lay, F_dir, surf_albedo,
              F_up_prev, *, n_passes: int, scat_corr: int,
              i2s_transition: float, epsi: float, mu_star: float,
              dir_beam: int, f_factor: float, R_star: float, a: float
              ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Iterative isothermal flux solve.

    Args:
      F_up_prev: [L+1, B, Y] upward fluxes from the previous solve (state
        carried across RCE iterations, like the reference's persistent
        device arrays).
      n_passes: number of down+up sweep pairs (3*scat+1 or 1000*scat+1).

    Returns (F_down, F_up): [L+1, B, Y].
    """
    C = iso_sweep_coeffs(cells, planckband_lay, F_dir, surf_albedo,
                         scat_corr=scat_corr, i2s_transition=i2s_transition,
                         epsi=epsi, mu_star=mu_star, dir_beam=dir_beam,
                         f_factor=f_factor, R_star=R_star, a=a)
    toa = jnp.broadcast_to(C.toa[:, None], F_up_prev.shape[1:])
    toa = toa.astype(F_up_prev.dtype)

    def one_pass(_, FdFu):
        _, F_up = FdFu
        F_down = _down_scan(C.a, C.b_nm, C.src_down, F_up, toa)
        boa = C.boa_refl[:, None] * (F_dir[0] + F_down[0]) + C.boa_emis
        F_up_new = _up_scan(C.a, C.b_nm, C.src_up, F_down, boa)
        return F_down, F_up_new

    F_down0 = jnp.zeros_like(F_up_prev)
    F_down, F_up = jax.lax.fori_loop(0, n_passes, one_pass,
                                     (F_down0, F_up_prev))
    return F_down, F_up


# --------------------------------------------------------------------------- #
# non-isothermal
# --------------------------------------------------------------------------- #

class NonIsoSweepCoeffs(NamedTuple):
    # upper half-layer
    a_up: jnp.ndarray
    b_up: jnp.ndarray
    src_up_down: jnp.ndarray   # source for Fc_down step
    src_up_up: jnp.ndarray     # source for F_up step
    # lower half-layer
    a_low: jnp.ndarray
    b_low: jnp.ndarray
    src_low_down: jnp.ndarray  # source for F_down step
    src_low_up: jnp.ndarray    # source for Fc_up step
    boa_refl: jnp.ndarray
    boa_emis: jnp.ndarray
    toa: jnp.ndarray


def _noniso_planck_terms(Bt, Bb, M, N, P, del_tau, epsi, E, w0, g0,
                         delta_tau_limit, up_direction: bool):
    """Linear-in-tau Planck source across a half-layer, with the isothermal
    fallback at small optical depth (kernels.cu:1640-1780).

    Bt: Planck at the 'from' boundary in sweep direction... concretely this
    helper takes (B_near, B_far) in the orientation the reference uses:
    for the downward step the gradient is (B_lower_boundary - B_upper
    boundary)/del_tau with signs as in kernels.cu:1646-1648; we pass
    arguments so that:
      iso branch: (Bt + Bb)/2 * (N + M - P)
      down:  Bt*(M+N) - Bb*P + epsi/(E(1-w0 g0)) * (P - M + N) * (Bt-Bb)/dtau
      up:    Bt*(M+N) - Bb*P + epsi/(E(1-w0 g0)) * (M - N - P) * (Bb-Bt)/dtau
    """
    iso_term = 0.5 * (Bt + Bb) * (N + M - P)
    grad = (Bt - Bb) / jnp.maximum(del_tau, 1e-30)
    if up_direction:
        noniso_term = (Bt * (M + N) - Bb * P
                       + epsi / (E * (1.0 - w0 * g0)) * (M - N - P) * (-grad))
    else:
        noniso_term = (Bt * (M + N) - Bb * P
                       + epsi / (E * (1.0 - w0 * g0)) * (P - M + N) * grad)
    return jnp.where(del_tau < delta_tau_limit, iso_term, noniso_term)


def noniso_sweep_coeffs(upper: CellQuantities, lower: CellQuantities,
                        planckband_lay, planckband_int, F_dir, Fc_dir,
                        surf_albedo, *, scat_corr: int, i2s_transition: float,
                        epsi: float, mu_star: float, dir_beam: int,
                        f_factor: float, R_star: float, a: float,
                        delta_tau_limit: float) -> NonIsoSweepCoeffs:
    """Precompute the layer-local parts of fband_noniso
    (kernels.cu:1597-1798)."""
    L = upper.M.shape[0]
    nlayer = planckband_lay.shape[0] - 2
    inv_neg_mu = 1.0 / (-mu_star)

    B_lay = planckband_lay[:L][:, :, None]          # [L, B, 1]
    B_int = planckband_int[:, :, None]              # [L+1, B, 1]
    B_int_below = B_int[:-1]                        # interface i
    B_int_above = B_int[1:]                         # interface i+1

    out = {}
    for half, cells in (("up", upper), ("low", lower)):
        w0, M, N, P = cells.w0, cells.M, cells.N, cells.P
        G_pl, G_min = cells.G_pl, cells.G_min
        g0b = cells.g0[:, :, None]
        E = E_maybe(w0, g0b, scat_corr, i2s_transition)
        del_tau = cells.delta_tau_total
        pref = 2.0 * pc.PI * epsi * (1.0 - w0) / (E - w0)

        if half == "up":
            # upper half: between layer center i and interface i+1
            pl_down = _noniso_planck_terms(B_lay, B_int_above, M, N, P,
                                           del_tau, epsi, E, w0, g0b,
                                           delta_tau_limit, False)
            pl_up = _noniso_planck_terms(B_int_above, B_lay, M, N, P,
                                         del_tau, epsi, E, w0, g0b,
                                         delta_tau_limit, True)
            dir_down = jnp.minimum(
                0.0, Fc_dir * inv_neg_mu * (G_min * M + G_pl * N)
                - F_dir[1:] * inv_neg_mu * G_min * P)
            dir_up = jnp.minimum(
                0.0, F_dir[1:] * inv_neg_mu * (G_min * N + G_pl * M)
                - Fc_dir * inv_neg_mu * P * G_pl)
        else:
            # lower half: between interface i and layer center i
            pl_down = _noniso_planck_terms(B_int_below, B_lay, M, N, P,
                                           del_tau, epsi, E, w0, g0b,
                                           delta_tau_limit, False)
            pl_up = _noniso_planck_terms(B_lay, B_int_below, M, N, P,
                                         del_tau, epsi, E, w0, g0b,
                                         delta_tau_limit, True)
            dir_down = jnp.minimum(
                0.0, F_dir[:-1] * inv_neg_mu * (G_min * M + G_pl * N)
                - Fc_dir * inv_neg_mu * P * G_min)
            dir_up = jnp.minimum(
                0.0, Fc_dir * inv_neg_mu * (G_min * N + G_pl * M)
                - F_dir[:-1] * inv_neg_mu * P * G_pl)

        out[f"a_{half}"] = P / M
        out[f"b_{half}"] = -N / M
        out[f"src_{half}_down"] = (pref * pl_down + dir_down) / M
        out[f"src_{half}_up"] = (pref * pl_up + dir_up) / M
        if half == "low":
            w0_0, E_0 = w0[0], E[0]

    B_surf = planckband_lay[nlayer + 1]
    boa_emis = ((1.0 - surf_albedo)[:, None] * pc.PI
                * (1.0 - w0_0) / (E_0 - w0_0) * B_surf[:, None])

    return NonIsoSweepCoeffs(
        a_up=out["a_up"], b_up=out["b_up"],
        src_up_down=out["src_up_down"], src_up_up=out["src_up_up"],
        a_low=out["a_low"], b_low=out["b_low"],
        src_low_down=out["src_low_down"], src_low_up=out["src_low_up"],
        boa_refl=surf_albedo, boa_emis=boa_emis,
        toa=toa_incident_flux(planckband_lay, dir_beam=dir_beam,
                              f_factor=f_factor, R_star=R_star, a=a))


def fband_noniso(upper: CellQuantities, lower: CellQuantities,
                 planckband_lay, planckband_int, F_dir, Fc_dir, surf_albedo,
                 F_up_prev, Fc_up_prev, *, n_passes: int, scat_corr: int,
                 i2s_transition: float, epsi: float, mu_star: float,
                 dir_beam: int, f_factor: float, R_star: float, a: float,
                 delta_tau_limit: float):
    """Iterative non-isothermal flux solve (kernels.cu:1521-1798).

    Returns (F_down [L+1,B,Y], F_up [L+1,B,Y],
             Fc_down [L,B,Y], Fc_up [L,B,Y]).
    """
    C = noniso_sweep_coeffs(
        upper, lower, planckband_lay, planckband_int, F_dir, Fc_dir,
        surf_albedo, scat_corr=scat_corr, i2s_transition=i2s_transition,
        epsi=epsi, mu_star=mu_star, dir_beam=dir_beam, f_factor=f_factor,
        R_star=R_star, a=a, delta_tau_limit=delta_tau_limit)
    toa = jnp.broadcast_to(C.toa[:, None], F_up_prev.shape[1:])
    toa = toa.astype(F_up_prev.dtype)

    def down_pass(F_up, Fc_up):
        def step(carry, xs):
            a_up, b_up, s_ud, a_low, b_low, s_ld, fcu, fu = xs
            fc_down = a_up * carry + b_up * fcu + s_ud
            f_down = a_low * fc_down + b_low * fu + s_ld
            return f_down, (f_down, fc_down)

        xs = tuple(arr[::-1] for arr in (
            C.a_up, C.b_up, C.src_up_down, C.a_low, C.b_low, C.src_low_down,
            Fc_up, F_up[:-1]))
        _, (downs, fc_downs) = jax.lax.scan(step, toa, xs)
        F_down = jnp.concatenate([downs[::-1], toa[None]], axis=0)
        return F_down, fc_downs[::-1]

    def up_pass(F_down, Fc_down):
        boa = C.boa_refl[:, None] * (F_dir[0] + F_down[0]) + C.boa_emis

        def step(carry, xs):
            a_low, b_low, s_lu, a_up, b_up, s_uu, fcd, fd_above = xs
            fc_up = a_low * carry + b_low * fcd + s_lu
            f_up = a_up * fc_up + b_up * fd_above + s_uu
            return f_up, (f_up, fc_up)

        xs = (C.a_low, C.b_low, C.src_low_up, C.a_up, C.b_up, C.src_up_up,
              Fc_down, F_down[1:])
        _, (ups, fc_ups) = jax.lax.scan(step, boa, xs)
        F_up = jnp.concatenate([boa[None], ups], axis=0)
        return F_up, fc_ups

    def one_pass(_, state):
        F_down, F_up, Fc_down, Fc_up = state
        F_down, Fc_down = down_pass(F_up, Fc_up)
        F_up, Fc_up = up_pass(F_down, Fc_down)
        return F_down, F_up, Fc_down, Fc_up

    F_down0 = jnp.zeros_like(F_up_prev)
    Fc_down0 = jnp.zeros_like(Fc_up_prev)
    state = jax.lax.fori_loop(
        0, n_passes, one_pass, (F_down0, F_up_prev, Fc_down0, Fc_up_prev))
    return state
