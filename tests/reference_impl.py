"""Loop-based numpy oracle of the reference equations, used as the parity
yardstick for the vectorized device ops.

Each function re-expresses the corresponding reference kernel's math
(citations per function) with explicit Python loops over small grids --
slow, simple, and independent of the vectorized formulation, so agreement is
a meaningful test.  This is the "golden-value parity vs the reference
equations on tiny grids" stratum of the test pyramid (SURVEY.md section 4b).
"""

import numpy as np

PI = 3.141592653589793


def E_parameter(w0, g0, i2s, scat_corr):
    # kernels.cu:109-124
    if not scat_corr:
        return 1.0
    if w0 > i2s and g0 >= 0:
        return max(1.0, 1.225 - 0.1582 * g0 - 0.1777 * w0
                   - 0.07465 * g0 ** 2 + 0.2351 * w0 * g0 - 0.05582 * w0 ** 2)
    return 1.0


def zeta(w0, g0, i2s, scat_corr, sign):
    # kernels.cu:260-290
    E = E_parameter(w0, g0, i2s, scat_corr)
    return 0.5 * (1.0 + sign * np.sqrt((E - w0) / (E * (1.0 - w0 * g0))))


def trans_func(epsi, dtau, w0, g0, i2s, scat_corr):
    # kernels.cu:128-145
    E = E_parameter(w0, g0, i2s, scat_corr)
    return np.exp(-1.0 / epsi * np.sqrt(E * (1.0 - w0 * g0) * (E - w0)) * dtau)


def G_func(w0, g0, epsi, epsi2, mu_star, i2s, scat_corr, sign):
    # kernels.cu:149-213 (+ limiter :218-231)
    E = E_parameter(w0, g0, i2s, scat_corr)
    num = w0 * (E * (1.0 - w0 * g0) + g0 * epsi / epsi2)
    denom = E * epsi ** -2.0 * (E - w0) * (1.0 - w0 * g0) - mu_star ** -2.0
    second = 1.0 / epsi + sign * 1.0 / (mu_star * E * (1.0 - w0 * g0))
    third = epsi * w0 * g0 * mu_star / (epsi2 * E * (1.0 - w0 * g0))
    G = 0.5 * (num / denom * second + sign * third)
    if abs(G) >= 1e8:
        G = 1e8 * np.sign(G)
    return G


def fdir_iso(planck_star, dtau_tot, z_lay, mu_star, R_planet, R_star, a,
             dir_beam, geom):
    """kernels.cu:1265-1309.  dtau_tot: [L, B, Y]; returns [I, B, Y]."""
    L, B, Y = dtau_tot.shape
    nint = L + 1
    F = np.zeros((nint, B, Y))
    for i in range(nint):
        for x in range(B):
            for y in range(Y):
                I_dir = (R_star / a) ** 2 * PI * planck_star[x]
                f = -dir_beam * mu_star * I_dir
                for j in range(nint - 2, i - 1, -1):
                    if geom:
                        zi = z_lay[i] if i < L else z_lay[L - 1]
                        mu = -np.sqrt(1.0 - ((R_planet + zi)
                                             / (R_planet + z_lay[j])) ** 2
                                      * (1.0 - mu_star ** 2))
                    else:
                        mu = mu_star
                    f *= np.exp(dtau_tot[j, x, y] / mu)
                F[i, x, y] = f
    return F


def fdir_noniso(planck_star, dtau_up, dtau_low, z_lay, mu_star, R_planet,
                R_star, a, dir_beam, geom):
    """kernels.cu:1313-1362."""
    L, B, Y = dtau_up.shape
    nint = L + 1
    F = np.zeros((nint, B, Y))
    Fc = np.zeros((L, B, Y))
    for i in range(nint):
        for x in range(B):
            for y in range(Y):
                I_dir = (R_star / a) ** 2 * PI * planck_star[x]
                f = -dir_beam * mu_star * I_dir
                fc = 0.0
                for j in range(nint - 2, i - 1, -1):
                    if geom:
                        zi = z_lay[i] if i < L else z_lay[L - 1]
                        mu = -np.sqrt(1.0 - ((R_planet + zi)
                                             / (R_planet + z_lay[j])) ** 2
                                      * (1.0 - mu_star ** 2))
                    else:
                        mu = mu_star
                    dtau = dtau_up[j, x, y] + dtau_low[j, x, y]
                    fc = f * np.exp(dtau_up[j, x, y] / mu)
                    f *= np.exp(dtau / mu)
                F[i, x, y] = f
                if i < L:
                    Fc[i, x, y] = fc
    return F, Fc


def fband_iso_sweep(F_down, F_up, F_dir, B_lay, B_star_row, B_surf_row,
                    w0, M, N, P, Gp, Gm, g0_eff, surf_albedo, *,
                    scat_corr, i2s, epsi, mu_star, dir_beam, f_factor,
                    R_star, a, n_passes):
    """kernels.cu:1366-1517.  All per-cell arrays [L, B, Y]; B_lay [L, B];
    in-place update of F_down/F_up [I, B, Y]; returns them."""
    L = w0.shape[0]
    nint = L + 1
    B = w0.shape[1]
    Y = w0.shape[2]
    for _ in range(n_passes):
        for x in range(B):
            for y in range(Y):
                # downward
                for i in range(nint - 1, -1, -1):
                    if i == nint - 1:
                        F_down[i, x, y] = ((1.0 - dir_beam) * f_factor
                                           * (R_star / a) ** 2 * PI
                                           * B_star_row[x])
                    else:
                        E = E_parameter(w0[i, x, y], g0_eff[i, x], i2s,
                                        scat_corr)
                        flux_terms = (P[i, x, y] * F_down[i + 1, x, y]
                                      - N[i, x, y] * F_up[i, x, y])
                        planck_terms = B_lay[i, x] * (N[i, x, y] + M[i, x, y]
                                                      - P[i, x, y])
                        direct = (F_dir[i, x, y] / (-mu_star)
                                  * (Gm[i, x, y] * M[i, x, y]
                                     + Gp[i, x, y] * N[i, x, y])
                                  - F_dir[i + 1, x, y] / (-mu_star)
                                  * P[i, x, y] * Gm[i, x, y])
                        direct = min(0.0, direct)
                        F_down[i, x, y] = 1.0 / M[i, x, y] * (
                            flux_terms + 2.0 * PI * epsi
                            * (1.0 - w0[i, x, y]) / (E - w0[i, x, y])
                            * planck_terms + direct)
                # upward; w0/E stale from layer 0 (kernels.cu:1469-1474)
                w0_boa = w0[0, x, y]
                E_boa = E_parameter(w0_boa, g0_eff[0, x], i2s, scat_corr)
                for i in range(nint):
                    if i == 0:
                        refl = surf_albedo[x] * (F_dir[0, x, y]
                                                 + F_down[0, x, y])
                        emis = ((1.0 - surf_albedo[x]) * PI
                                * (1.0 - w0_boa) / (E_boa - w0_boa)
                                * B_surf_row[x])
                        F_up[i, x, y] = refl + emis
                    else:
                        j = i - 1
                        E = E_parameter(w0[j, x, y], g0_eff[j, x], i2s,
                                        scat_corr)
                        flux_terms = (P[j, x, y] * F_up[j, x, y]
                                      - N[j, x, y] * F_down[i, x, y])
                        planck_terms = B_lay[j, x] * (N[j, x, y] + M[j, x, y]
                                                      - P[j, x, y])
                        direct = (F_dir[i, x, y] / (-mu_star)
                                  * (Gm[j, x, y] * N[j, x, y]
                                     + Gp[j, x, y] * M[j, x, y])
                                  - F_dir[j, x, y] / (-mu_star)
                                  * P[j, x, y] * Gp[j, x, y])
                        direct = min(0.0, direct)
                        F_up[i, x, y] = 1.0 / M[j, x, y] * (
                            flux_terms + 2.0 * PI * epsi
                            * (1.0 - w0[j, x, y]) / (E - w0[j, x, y])
                            * planck_terms + direct)
    return F_down, F_up


def thomas_reference(b, c, d):
    """kernels.cu:1916-1967 elimination with a_i = c_{i-1}; 1-D arrays."""
    n = len(b)
    cp = np.zeros(n)
    dp = np.zeros(n)
    cp[0] = c[0] / b[0]
    dp[0] = d[0] / b[0]
    for i in range(1, n):
        cm1 = c[i - 1]
        denom = b[i] - cm1 * cp[i - 1]
        cp[i] = c[i] / denom
        dp[i] = (d[i] - cm1 * dp[i - 1]) / denom
    x = np.zeros(n)
    x[n - 1] = dp[n - 1]
    for i in range(n - 2, -1, -1):
        x[i] = dp[i] - cp[i] * x[i + 1]
    return x


def bilinear_interpol(table, temps, press, T, p, log_temp=False,
                      clamp_lo=0.001):
    """kernels.cu:524-609 index math; table [ntemp, npress, ...]."""
    ntemp, npress = table.shape[0], table.shape[1]
    if log_temp:
        dT = (np.log10(temps[-1]) - np.log10(temps[0])) / (ntemp - 1.0)
        t = (np.log10(T) - np.log10(temps[0])) / dT
    else:
        dT = (temps[-1] - temps[0]) / (ntemp - 1.0)
        t = (T - temps[0]) / dT
    t = min(ntemp - 1.0 - clamp_lo, max(clamp_lo, t))
    dP = (np.log10(press[-1]) - np.log10(press[0])) / (npress - 1.0)
    p_ = (np.log10(p) - np.log10(press[0])) / dP
    p_ = min(npress - 1.0 - clamp_lo, max(clamp_lo, p_))
    td, tu = int(np.floor(t)), int(np.ceil(t))
    pd, pu = int(np.floor(p_)), int(np.ceil(p_))
    if td != tu and pd != pu:
        return (table[td, pd] * (pu - p_) * (tu - t)
                + table[td, pu] * (p_ - pd) * (tu - t)
                + table[tu, pd] * (pu - p_) * (t - td)
                + table[tu, pu] * (p_ - pd) * (t - td))
    if td == tu and pd != pu:
        return table[td, pd] * (pu - p_) + table[td, pu] * (p_ - pd)
    if td != tu and pd == pu:
        return table[td, pd] * (tu - t) + table[tu, pd] * (t - td)
    return table[td, pd]
