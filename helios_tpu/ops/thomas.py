"""Exact coupled flux solve via tridiagonal (Thomas) elimination.

Vectorized formulation of fband_matrix_iso / fband_matrix_noniso
(source/kernels.cu:1803-2424).  The interleaved up/down flux system along
each spectral column is a tridiagonal system of size 2*ninterface (iso) or
4*ninterface - 2 (non-iso); we build the diagonals as dense
[n_matrix, B, Y] tensors and run the forward-elimination and
back-substitution recurrences as two `lax.scan`s vectorized over the whole
spectral grid.

The reference's elimination hardcodes the sub-diagonal as the previous row's
super-diagonal (a_i = c_{i-1}, kernels.cu:1928-1950); we keep that exact
convention for parity.

Columns whose `scat_trigger` is unset use the pure-absorption recurrence
instead (kernels.cu:1969-2022, :2286-2421); both paths are computed dense
and the per-(bin, y) choice is a `where` select -- the absorption path is a
cheap pair of scans, so this costs little and keeps the program shape
static.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from helios_tpu import constants as pc
from helios_tpu.ops.twostream import CellQuantities, E_maybe
from helios_tpu.ops import sweep as sweep_ops


def thomas_solve(b, c, d):
    """Solve the tridiagonal system with sub-diagonal a_i = c_{i-1}.

    b, c, d: [n, ...]; returns x: [n, ...].
    Forward: c'_i = c_i/(b_i - c_{i-1} c'_{i-1}),
             d'_i = (d_i - c_{i-1} d'_{i-1})/(b_i - c_{i-1} c'_{i-1});
    backward: x_i = d'_i - c'_i x_{i+1}.
    """
    c_prev = jnp.concatenate([jnp.zeros_like(c[:1]), c[:-1]], axis=0)

    def fwd(carry, xs):
        cp_prev, dp_prev = carry
        b_i, c_i, d_i, cm1 = xs
        denom = b_i - cm1 * cp_prev
        cp = c_i / denom
        dp = (d_i - cm1 * dp_prev) / denom
        return (cp, dp), (cp, dp)

    init = (jnp.zeros_like(b[0]), jnp.zeros_like(b[0]))
    _, (cp, dp) = jax.lax.scan(fwd, init, (b, c, d, c_prev))

    def bwd(carry, xs):
        cp_i, dp_i = xs
        x = dp_i - cp_i * carry
        return x, x

    _, xs_rev = jax.lax.scan(bwd, jnp.zeros_like(b[0]),
                             (cp[::-1], dp[::-1]))
    return xs_rev[::-1]


def _interleave(rows):
    """Stack k row-arrays [L, B, Y] into [k*L, B, Y] with row-major
    interleaving (row j of layer l lands at index k*l + j)."""
    stacked = jnp.stack(rows, axis=1)          # [L, k, B, Y]
    return stacked.reshape((-1,) + stacked.shape[2:])


def fband_matrix_iso(cells: CellQuantities, planckband_lay, F_dir,
                     surf_albedo, scat_trigger, *, scat_corr: int,
                     i2s_transition: float, epsi: float, mu_star: float,
                     dir_beam: int, f_factor: float, R_star: float,
                     a: float) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Isothermal Thomas-method flux solve (kernels.cu:1803-2024).

    Returns (F_down, F_up): [L+1, B, Y].
    """
    L, B, Y = cells.M.shape
    nint = L + 1
    nlayer = planckband_lay.shape[0] - 2
    dtype = cells.M.dtype

    w0, M, N, P = cells.w0, cells.M, cells.N, cells.P
    G_pl, G_min = cells.G_pl, cells.G_min
    g0b = cells.g0[:, :, None]
    E = E_maybe(w0, g0b, scat_corr, i2s_transition)
    inv_neg_mu = 1.0 / (-mu_star)

    alpha = P / M
    beta = -N / M

    B_lay = planckband_lay[:L][:, :, None]
    planck = (2.0 * pc.PI * epsi * (1.0 - w0) / (E - w0)
              * (N + M - P) * B_lay)
    dir_down = jnp.minimum(
        0.0, F_dir[:-1] * inv_neg_mu * (G_min * M + G_pl * N)
        - F_dir[1:] * inv_neg_mu * P * G_min)
    dir_up = jnp.minimum(
        0.0, F_dir[1:] * inv_neg_mu * (G_min * N + G_pl * M)
        - F_dir[:-1] * inv_neg_mu * P * G_pl)
    src_down = (planck + dir_down) / M
    src_up = (planck + dir_up) / M

    toa = sweep_ops.toa_incident_flux(
        planckband_lay, dir_beam=dir_beam, f_factor=f_factor,
        R_star=R_star, a=a)
    B_surf = planckband_lay[nlayer + 1]
    src_boa = (surf_albedo[:, None] * F_dir[0]
               + (1.0 - surf_albedo)[:, None] * pc.PI
               * (1.0 - w0[0]) / (E[0] - w0[0]) * B_surf[:, None])

    # assemble diagonals, n_matrix = 2*nint (kernels.cu:1916-1950):
    #   row 0:          b=-albedo, c=1,           d=src_boa
    #   odd row i:      b=-beta[j], c=-alpha[j],  d=src_down[j], j=(i-1)/2
    #   even row i>=2:  b=-beta[j], c=1,          d=src_up[j],   j=i/2-1
    #   row n-1:        b=0,        c=0,          d=src_toa
    full = jnp.ones((1, B, Y), dtype)
    b_rows = _interleave([-beta, -beta])        # rows 1..2L (odd, even)
    c_rows = _interleave([-alpha, jnp.ones_like(alpha)])
    d_rows = _interleave([src_down, src_up])

    alb_row = jnp.broadcast_to(-surf_albedo[None, :, None], (1, B, Y))
    b = jnp.concatenate([alb_row.astype(dtype), b_rows,
                         jnp.zeros((1, B, Y), dtype)], axis=0)
    c = jnp.concatenate([full, c_rows,
                         jnp.zeros((1, B, Y), dtype)], axis=0)
    toa_row = jnp.broadcast_to(toa[None, :, None], (1, B, Y)).astype(dtype)
    d = jnp.concatenate([src_boa[None], d_rows, toa_row], axis=0)

    x = thomas_solve(b, c, d)        # [2*nint, B, Y]

    F_down_mat = x[0::2]                         # [nint, B, Y]
    F_up_mat = x[1::2]

    # pure-absorption fallback (kernels.cu:1969-2022)
    trans = cells.trans
    F_down_abs = _absorption_down(trans, B_lay, toa, epsi)
    boa_abs = (surf_albedo[:, None] * (F_dir[0] + F_down_abs[0])
               + (1.0 - surf_albedo)[:, None] * pc.PI * B_surf[:, None])
    F_up_abs = _absorption_up(trans, B_lay, boa_abs, epsi)

    sel = scat_trigger[None]                     # [1, B, Y]
    F_down = jnp.where(sel, F_down_mat, F_down_abs)
    F_up = jnp.where(sel, F_up_mat, F_up_abs)
    return F_down, F_up


def _absorption_down(trans, B_lay, toa, epsi):
    """F_down[i] = t[i] F_down[i+1] + 2 pi eps (1-t[i]) B_lay[i]."""
    src = 2.0 * pc.PI * epsi * (1.0 - trans) * B_lay

    def step(carry, xs):
        t_i, s_i = xs
        f = t_i * carry + s_i
        return f, f

    toa_b = jnp.broadcast_to(toa[:, None], trans.shape[1:]).astype(trans.dtype)
    _, downs = jax.lax.scan(step, toa_b, (trans[::-1], src[::-1]))
    return jnp.concatenate([downs[::-1], toa_b[None]], axis=0)


def _absorption_up(trans, B_lay, boa, epsi):
    """F_up[i] = t[i-1] F_up[i-1] + 2 pi eps (1-t[i-1]) B_lay[i-1]."""
    src = 2.0 * pc.PI * epsi * (1.0 - trans) * B_lay

    def step(carry, xs):
        t_i, s_i = xs
        f = t_i * carry + s_i
        return f, f

    _, ups = jax.lax.scan(step, boa, (trans, src))
    return jnp.concatenate([boa[None], ups], axis=0)


def fband_matrix_noniso(upper: CellQuantities, lower: CellQuantities,
                        planckband_lay, planckband_int, F_dir, Fc_dir,
                        surf_albedo, scat_trigger, *, scat_corr: int,
                        i2s_transition: float, epsi: float, mu_star: float,
                        dir_beam: int, f_factor: float, R_star: float,
                        a: float, delta_tau_limit: float):
    """Non-isothermal Thomas-method flux solve (kernels.cu:2028-2424).

    Returns (F_down, F_up, Fc_down, Fc_up).
    """
    L, B, Y = upper.M.shape
    nint = L + 1
    nlayer = planckband_lay.shape[0] - 2
    dtype = upper.M.dtype
    inv_neg_mu = 1.0 / (-mu_star)

    B_lay = planckband_lay[:L][:, :, None]
    B_int = planckband_int[:, :, None]
    B_int_below, B_int_above = B_int[:-1], B_int[1:]

    # per-half coefficient rows j: even j = lower half, odd j = upper half
    halves = {}
    for name, cells in (("low", lower), ("up", upper)):
        w0, M, N, P = cells.w0, cells.M, cells.N, cells.P
        G_pl, G_min = cells.G_pl, cells.G_min
        g0b = cells.g0[:, :, None]
        E = E_maybe(w0, g0b, scat_corr, i2s_transition)
        del_tau = cells.delta_tau_total
        pref = 2.0 * pc.PI * epsi * (1.0 - w0) / (E - w0)

        if name == "low":
            pl_down = sweep_ops._noniso_planck_terms(
                B_int_below, B_lay, M, N, P, del_tau, epsi, E, w0, g0b,
                delta_tau_limit, False)
            pl_up = sweep_ops._noniso_planck_terms(
                B_lay, B_int_below, M, N, P, del_tau, epsi, E, w0, g0b,
                delta_tau_limit, True)
            dir_down = jnp.minimum(
                0.0, F_dir[:-1] * inv_neg_mu * (G_min * M + G_pl * N)
                - Fc_dir * inv_neg_mu * P * G_min)
            dir_up = jnp.minimum(
                0.0, Fc_dir * inv_neg_mu * (G_min * N + G_pl * M)
                - F_dir[:-1] * inv_neg_mu * P * G_pl)
            w0_low0, E_low0 = w0[0], E[0]
        else:
            pl_down = sweep_ops._noniso_planck_terms(
                B_lay, B_int_above, M, N, P, del_tau, epsi, E, w0, g0b,
                delta_tau_limit, False)
            pl_up = sweep_ops._noniso_planck_terms(
                B_int_above, B_lay, M, N, P, del_tau, epsi, E, w0, g0b,
                delta_tau_limit, True)
            dir_down = jnp.minimum(
                0.0, Fc_dir * inv_neg_mu * (G_min * M + G_pl * N)
                - F_dir[1:] * inv_neg_mu * P * G_min)
            dir_up = jnp.minimum(
                0.0, F_dir[1:] * inv_neg_mu * (G_min * N + G_pl * M)
                - Fc_dir * inv_neg_mu * P * G_pl)

        halves[name] = dict(
            alpha=P / M, beta=-N / M,
            src_down=(pref * pl_down + dir_down) / M,
            src_up=(pref * pl_up + dir_up) / M)

    toa = sweep_ops.toa_incident_flux(
        planckband_lay, dir_beam=dir_beam, f_factor=f_factor,
        R_star=R_star, a=a)
    B_surf = planckband_lay[nlayer + 1]
    src_boa = (surf_albedo[:, None] * F_dir[0]
               + (1.0 - surf_albedo)[:, None] * pc.PI
               * (1.0 - w0_low0) / (E_low0 - w0_low0) * B_surf[:, None])

    # interleaved coefficient rows: [2L] rows, even=lower, odd=upper
    alpha_r = _interleave([halves["low"]["alpha"], halves["up"]["alpha"]])
    beta_r = _interleave([halves["low"]["beta"], halves["up"]["beta"]])
    srcd_r = _interleave([halves["low"]["src_down"], halves["up"]["src_down"]])
    srcu_r = _interleave([halves["low"]["src_up"], halves["up"]["src_up"]])

    # matrix rows, n = 4*nint - 2 (kernels.cu:2218-2252):
    #   row 0: b=-albedo, c=1, d=src_boa
    #   odd i:  j=(i-1)/2: b=-beta_r[j], c=-alpha_r[j], d=srcd_r[j]
    #   even i: j=i/2-1:   b=-beta_r[j], c=1,           d=srcu_r[j]
    #   row n-1: b=0, d=src_toa
    full = jnp.ones((1, B, Y), dtype)
    b_rows = _interleave([-beta_r, -beta_r])     # [4L, B, Y] (odd, even pairs)
    c_rows = _interleave([-alpha_r, jnp.ones_like(alpha_r)])
    d_rows = _interleave([srcd_r, srcu_r])

    alb_row = jnp.broadcast_to(-surf_albedo[None, :, None], (1, B, Y))
    toa_row = jnp.broadcast_to(toa[None, :, None], (1, B, Y)).astype(dtype)
    b = jnp.concatenate([alb_row.astype(dtype), b_rows,
                         jnp.zeros((1, B, Y), dtype)], axis=0)
    c = jnp.concatenate([full, c_rows,
                         jnp.zeros((1, B, Y), dtype)], axis=0)
    d = jnp.concatenate([src_boa[None], d_rows, toa_row], axis=0)

    x = thomas_solve(b, c, d)        # [4*nint-2, B, Y]

    # translate (kernels.cu:2272-2283): i%4==0 -> F_down[i/4],
    # 1 -> F_up, 2 -> Fc_down, 3 -> Fc_up; the final row n-1 = 4*nint-3 is
    # congruent 1 mod 4, so x[1::4] already yields all nint F_up values
    F_down_mat = x[0::4]
    F_up_mat = x[1::4]
    Fc_down_mat = x[2::4]
    Fc_up_mat = x[3::4]

    # pure-absorption fallback (kernels.cu:2286-2421)
    F_down_abs, F_up_abs, Fc_down_abs, Fc_up_abs = _absorption_noniso(
        upper, lower, B_lay, B_int, toa, F_dir, surf_albedo, B_surf,
        epsi=epsi, delta_tau_limit=delta_tau_limit)

    sel = scat_trigger[None]
    return (jnp.where(sel, F_down_mat, F_down_abs),
            jnp.where(sel, F_up_mat, F_up_abs),
            jnp.where(sel, Fc_down_mat, Fc_down_abs),
            jnp.where(sel, Fc_up_mat, Fc_up_abs))


def _absorption_noniso(upper, lower, B_lay, B_int, toa, F_dir, surf_albedo,
                       B_surf, *, epsi, delta_tau_limit):
    """Pure-absorption non-isothermal recurrences (kernels.cu:2294-2421)."""
    B_int_below, B_int_above = B_int[:-1], B_int[1:]

    def planck_terms(trans, del_tau, B_from, B_to, up: bool):
        iso_term = 0.5 * (B_from + B_to) * (1.0 - trans)
        grad = (B_from - B_to) / jnp.maximum(del_tau, 1e-30)
        if up:
            # up: B_to - trans*B_from + eps*grad_ref*(1-trans); see
            # kernels.cu:2386-2409 (grad_ref defined per half below)
            noniso = B_to - trans * B_from + epsi * grad * (1.0 - trans)
        else:
            noniso = B_from - trans * B_to + epsi * (trans - 1.0) * grad
        return jnp.where(del_tau < delta_tau_limit, iso_term, noniso)

    t_up, dt_up = upper.trans, upper.delta_tau_total
    t_low, dt_low = lower.trans, lower.delta_tau_total

    # downward: Fc_down[i] = t_up F_down[i+1] + 2 pi eps pl_up_down
    #           F_down[i] = t_low Fc_down[i] + 2 pi eps pl_low_down
    pl_up_down = planck_terms(t_up, dt_up, B_lay, B_int_above, False)
    pl_low_down = planck_terms(t_low, dt_low, B_int_below, B_lay, False)

    def down_step(carry, xs):
        tu, su, tl, sl = xs
        fc = tu * carry + su
        f = tl * fc + sl
        return f, (f, fc)

    toa_b = jnp.broadcast_to(toa[:, None], t_up.shape[1:]).astype(t_up.dtype)
    xs = tuple(arr[::-1] for arr in (
        t_up, 2.0 * pc.PI * epsi * pl_up_down,
        t_low, 2.0 * pc.PI * epsi * pl_low_down))
    _, (downs, fc_downs) = jax.lax.scan(down_step, toa_b, xs)
    F_down = jnp.concatenate([downs[::-1], toa_b[None]], axis=0)
    Fc_down = fc_downs[::-1]

    # upward (kernels.cu:2356-2419): note the reference's up-path grads:
    #  lower: pgrad_low = (B_int[i-1]-B_lay[i-1])/dt; planck = B_lay - t*B_int
    #         + eps*pgrad*(1-t)
    #  upper: pgrad_up = (B_lay[i-1]-B_int[i])/dt; planck = B_int - t*B_lay
    #         + eps*pgrad*(1-t)
    pl_low_up = jnp.where(
        dt_low < delta_tau_limit,
        0.5 * (B_int_below + B_lay) * (1.0 - t_low),
        B_lay - t_low * B_int_below
        + epsi * ((B_int_below - B_lay) / jnp.maximum(dt_low, 1e-30))
        * (1.0 - t_low))
    pl_up_up = jnp.where(
        dt_up < delta_tau_limit,
        0.5 * (B_int_above + B_lay) * (1.0 - t_up),
        B_int_above - t_up * B_lay
        + epsi * ((B_lay - B_int_above) / jnp.maximum(dt_up, 1e-30))
        * (1.0 - t_up))

    boa = (surf_albedo[:, None] * (F_dir[0] + F_down[0])
           + (1.0 - surf_albedo)[:, None] * pc.PI * B_surf[:, None])
    boa = jnp.broadcast_to(boa, t_up.shape[1:]).astype(t_up.dtype)

    def up_step(carry, xs):
        tl, sl, tu, su = xs
        fc = tl * carry + sl
        f = tu * fc + su
        return f, (f, fc)

    xs = (t_low, 2.0 * pc.PI * epsi * pl_low_up,
          t_up, 2.0 * pc.PI * epsi * pl_up_up)
    _, (ups, fc_ups) = jax.lax.scan(up_step, boa, xs)
    F_up = jnp.concatenate([boa[None], ups], axis=0)
    Fc_up = fc_ups
    return F_down, F_up, Fc_down, Fc_up
