"""The forward radiative-transfer model: T profile -> spectral fluxes.

Composes the ops modules into the per-iteration flux pipeline of the
reference's radiation loop (source/computation.py:856-888): temperature
interpolation -> Planck lookup -> opacity interpolation -> transmission
cell quantities -> altitude -> direct beam -> flux solve -> integration.
The whole pipeline is one jit-compiled function; there are no host
round-trips (the reference's delta_z/z_lay host detour,
computation.py:875-878, is device-side here).

Static physics scalars live in :class:`Phys` (hashable, passed statically so
XLA constant-folds them); device arrays live in :class:`ModelArrays`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from helios_tpu import constants as pc
from helios_tpu import grid as grid_mod
from helios_tpu import planck as planck_mod
from helios_tpu.config import HeliosConfig
from helios_tpu.io.opacity import OpacityTable, gauss_legendre_ypoints
from helios_tpu.ops import beam as beam_ops
from helios_tpu.ops import integrate as int_ops
from helios_tpu.ops import interp as interp_ops
from helios_tpu.ops import sweep as sweep_ops
from helios_tpu.ops import thomas as thomas_ops
from helios_tpu.ops import twostream as ts_ops


@dataclass(frozen=True)
class Phys:
    """Static (compile-time) physics configuration."""
    nlayer: int
    nbin: int
    ny: int
    iso: int
    scat: int
    scat_corr: int
    clouds: int
    dir_beam: int
    geom_zenith_corr: int
    singlewalk: int
    real_star: int
    energy_correction: int
    flux_calc_method: str          # "iteration" | "matrix"
    planet_type: str               # "gas" | "rocky" | "no_atmosphere"
    debug: int
    g: float
    R_planet: float
    R_star: float
    a: float
    T_star: float
    T_intern: float
    F_intern: float
    mu_star: float
    f_factor: float
    epsi: float
    epsi2: float
    g_0: float
    w_0_limit: float
    w_0_scat_limit: float
    delta_tau_limit: float
    i2s_transition: float
    plancktable_dim: int
    plancktable_step: int
    smooth: int
    adapt_interval: int
    foreplay: int
    physical_tstep: float
    convection: int
    no_atmo: int
    dtype: str
    rad_convergence_limit: float = 1e-8
    crit_relaxation_numbers: tuple = (10000, 20000)
    max_nr_iterations: int = 100000
    runtime_limit: float = 86400.0
    input_dampara: str = "automatic"
    opacity_mixing: str = "premixed"     # premixed | on-the-fly
    ro_method: int = 1                   # 1 = Random Overlap, 0 = corr-k
    use_pallas: str = "auto"             # auto | yes | no

    @property
    def pallas_active(self) -> bool:
        """Whether the iterative flux solve runs the fused GPU sweep
        kernels (kernels/sweep_triton.py) instead of XLA's `lax.scan`.

        "auto" picks them on the GPU backend only; "yes" demands them and
        raises on any other backend; "no" keeps the scan."""
        if self.use_pallas == "no":
            return False
        on_gpu = jax.default_backend() == "gpu"
        if self.use_pallas == "yes" and not on_gpu:
            raise RuntimeError(
                "use_pallas=yes needs the GPU backend, found "
                f"{jax.default_backend()!r}")
        return on_gpu

    @property
    def ninterface(self) -> int:
        return self.nlayer + 1

    @property
    def n_sweep_passes(self) -> int:
        """3*scat+1 during iteration, 1000*scat+1 in post-processing
        (reference computation.py:531-537)."""
        nscat_step = 1000 if self.singlewalk else 3
        return nscat_step * self.scat + 1

    @classmethod
    def from_config(cls, cfg: HeliosConfig, nbin: int, ny: int) -> "Phys":
        assert cfg._finalized, "call cfg.finalize() first"
        return cls(
            nlayer=int(cfg.nlayer), nbin=nbin, ny=ny, iso=int(cfg.iso),
            scat=int(cfg.scat), scat_corr=int(cfg.scat_corr),
            clouds=int(cfg.clouds), dir_beam=int(cfg.dir_beam),
            geom_zenith_corr=int(cfg.geom_zenith_corr),
            singlewalk=int(cfg.singlewalk), real_star=int(cfg.real_star),
            energy_correction=int(cfg.energy_correction),
            flux_calc_method=cfg.flux_calc_method,
            planet_type=cfg.planet_type, debug=int(cfg.debug),
            g=float(cfg.g), R_planet=float(cfg.R_planet),
            R_star=float(cfg.R_star), a=float(cfg.a),
            T_star=float(cfg.T_star), T_intern=float(cfg.T_intern),
            F_intern=float(cfg.F_intern), mu_star=float(cfg.mu_star),
            f_factor=float(cfg.f_factor), epsi=float(cfg.epsi),
            epsi2=float(cfg.epsi2), g_0=float(cfg.g_0),
            w_0_limit=float(cfg.w_0_limit),
            w_0_scat_limit=float(cfg.w_0_scat_limit),
            delta_tau_limit=float(cfg.delta_tau_limit),
            i2s_transition=float(cfg.i2s_transition),
            plancktable_dim=int(cfg.plancktable_dim),
            plancktable_step=int(cfg.plancktable_step),
            smooth=int(cfg.smooth), adapt_interval=int(cfg.adapt_interval),
            foreplay=int(cfg.foreplay),
            physical_tstep=float(cfg.physical_tstep),
            convection=int(cfg.convection), no_atmo=int(cfg.no_atmo),
            dtype=cfg.dtype,
            rad_convergence_limit=float(cfg.rad_convergence_limit),
            crit_relaxation_numbers=tuple(
                int(n) for n in cfg.crit_relaxation_numbers),
            max_nr_iterations=int(cfg.max_nr_iterations),
            runtime_limit=float(cfg.runtime_limit),
            input_dampara=(cfg.input_dampara
                           if isinstance(cfg.input_dampara, str)
                           else str(float(cfg.input_dampara))),
            opacity_mixing=cfg.opacity_mixing,
            ro_method=1 if cfg.k_mixing_method == "RO" else 0,
            use_pallas=(cfg.use_pallas if isinstance(cfg.use_pallas, str)
                        else ("yes" if cfg.use_pallas else "no")))


class ModelArrays(NamedTuple):
    """Device-resident static inputs of the forward model."""
    # vertical grid
    p_lay: jnp.ndarray
    p_int: jnp.ndarray
    delta_colmass: jnp.ndarray
    delta_col_upper: jnp.ndarray
    delta_col_lower: jnp.ndarray
    # opacity table (flat spectral layout for lane-friendly gathers)
    ktable: jnp.ndarray            # [ntemp, npress, S]
    scat_cross_table: jnp.ndarray  # [ntemp, npress, B]
    meanmolmass_table: jnp.ndarray  # [ntemp, npress]
    ktemps: jnp.ndarray
    kpress: jnp.ndarray
    # spectral grid
    lambda_centers: jnp.ndarray
    lambda_edges: jnp.ndarray
    delta_lambda: jnp.ndarray
    gauss_y: jnp.ndarray
    gauss_weight: jnp.ndarray
    # radiation inputs
    planck_grid: jnp.ndarray       # [dim+1, B]
    starflux: jnp.ndarray          # [B]
    surf_albedo: jnp.ndarray       # [B]
    # clouds (zeros if inactive)
    cloud_abs_cross_lay: jnp.ndarray   # [L, B]
    cloud_scat_cross_lay: jnp.ndarray  # [L, B]
    g_0_cloud_lay: jnp.ndarray         # [L, B]
    cloud_abs_cross_int: jnp.ndarray   # [L+1, B]
    cloud_scat_cross_int: jnp.ndarray  # [L+1, B]
    g_0_cloud_int: jnp.ndarray         # [L+1, B]
    # additional heating density [erg s^-1 cm^-3] (zeros if inactive)
    add_heat_dens: jnp.ndarray         # [L]
    # stellar energy-budget correction factor applied to starflux /
    # planck_grid[dim] (kernels.cu:420-468); calc_F_ratio divides it back
    # out to recover the ORIGINAL stellar BB (host_functions.py:663)
    star_corr_factor: jnp.ndarray = 1.0  # scalar


class FluxState(NamedTuple):
    """Fluxes carried across RCE iterations (the reference's persistent
    device arrays).  Flat spectral layout: [.., S], S = nbin * ny."""
    F_down: jnp.ndarray   # [I, S]
    F_up: jnp.ndarray     # [I, S]
    Fc_down: jnp.ndarray  # [L, S] (noniso only; zeros otherwise)
    Fc_up: jnp.ndarray    # [L, S]


class CellCache(NamedTuple):
    """Per-cell quantities refreshed every 10th iteration
    (reference computation.py:860-879)."""
    cells_or_upper: "fp.FlatCells"    # flat [L, S] layout, S = B*Y
    lower: "fp.FlatCells"             # == upper placeholder when iso
    scat_trigger: jnp.ndarray         # [S] bool
    F_dir: jnp.ndarray                # [I, S]
    Fc_dir: jnp.ndarray               # [L, S]
    meanmolmass_lay: jnp.ndarray      # [L]
    z_lay: jnp.ndarray                # [L]
    opac_lay: jnp.ndarray             # [L, S] (diagnostics/mean opac)
    scat_cross_lay: jnp.ndarray       # [L, B]
    F_add_heat_lay: jnp.ndarray       # [L]  add_heat_dens * delta_z
    F_add_heat_sum: jnp.ndarray       # [L]  cumulative sum
    # precomputed sweep coefficients (IsoCoeffCache / NonIsoCoeffCache):
    # everything of the flux-solve inputs that does not depend on the
    # current Planck arrays, so the per-iteration coefficient assembly
    # is a handful of fmas instead of the full coefficient pipeline
    coeff: tuple = ()


def init_flux_state(phys: Phys, dtype) -> FluxState:
    L, S = phys.nlayer, phys.nbin * phys.ny
    return FluxState(
        F_down=jnp.zeros((L + 1, S), dtype),
        F_up=jnp.zeros((L + 1, S), dtype),
        Fc_down=jnp.zeros((L, S), dtype),
        Fc_up=jnp.zeros((L, S), dtype))


def build_model(cfg: HeliosConfig, table: OpacityTable,
                starflux: Optional[np.ndarray] = None,
                surf_albedo: Optional[np.ndarray] = None,
                cloud_result=None,
                ) -> Tuple[Phys, ModelArrays]:
    """Assemble (Phys, ModelArrays) from config + opacity table."""
    phys = Phys.from_config(cfg, nbin=table.nbin, ny=table.ny)
    dt = jnp.dtype(cfg.dtype)

    g = grid_mod.build_grid(cfg.p_boa, cfg.p_toa, cfg.nlayer, cfg.g,
                            dtype=cfg.np_dtype)

    _, gauss_w = gauss_legendre_ypoints(table.ny)

    planck_grid = planck_mod.build_planck_table(
        table.wave_edges, table.delta_wave, phys.T_star,
        dim=phys.plancktable_dim, step=phys.plancktable_step, dtype=dt)

    if starflux is None:
        starflux = np.zeros(table.nbin, cfg.np_dtype)
    starflux = jnp.asarray(starflux, dt)

    star_corr = jnp.asarray(1.0, dt)
    if phys.energy_correction:
        planck_grid, starflux, star_corr = (
            planck_mod.correct_incident_energy(
                planck_grid, starflux, jnp.asarray(table.delta_wave, dt),
                real_star=phys.real_star, T_star=phys.T_star,
                dim=phys.plancktable_dim))

    if surf_albedo is None:
        alb = cfg.surf_albedo if not isinstance(cfg.surf_albedo, str) else 0.0
        surf_albedo = np.full(table.nbin, alb, cfg.np_dtype)

    L, B = phys.nlayer, phys.nbin
    zeros_lb = jnp.zeros((L, B), dt)
    zeros_ib = jnp.zeros((L + 1, B), dt)
    zeros_l = jnp.zeros((L,), dt)

    kpoints = table.kpoints
    if phys.no_atmo:
        kpoints = np.full_like(kpoints, 1e-30)  # read.py:1014-1023

    # on-the-fly mode: the table only donates the spectral/T/P grids; the
    # premixed fields stay as dummies (species tables live in the
    # SpeciesSet)
    scat_tab = table.scat_cross
    mmm_tab = table.meanmolmass
    if scat_tab is None:
        scat_tab = np.zeros(kpoints.shape[:2] + (table.nbin,), cfg.np_dtype)
    if mmm_tab is None:
        mmm_tab = np.full(kpoints.shape[:2], 2.3 * pc.AMU, cfg.np_dtype)

    arrays = ModelArrays(
        p_lay=jnp.asarray(g.p_lay, dt),
        p_int=jnp.asarray(g.p_int, dt),
        delta_colmass=jnp.asarray(g.delta_colmass, dt),
        delta_col_upper=jnp.asarray(g.delta_col_upper, dt),
        delta_col_lower=jnp.asarray(g.delta_col_lower, dt),
        ktable=jnp.asarray(
            kpoints.reshape(kpoints.shape[0], kpoints.shape[1], -1), dt),
        scat_cross_table=jnp.asarray(scat_tab, dt),
        meanmolmass_table=jnp.asarray(mmm_tab, dt),
        ktemps=jnp.asarray(table.temperatures, dt),
        kpress=jnp.asarray(table.pressures, dt),
        lambda_centers=jnp.asarray(table.wave_centers, dt),
        lambda_edges=jnp.asarray(table.wave_edges, dt),
        delta_lambda=jnp.asarray(table.delta_wave, dt),
        gauss_y=jnp.asarray(table.gauss_y, dt),
        gauss_weight=jnp.asarray(gauss_w, dt),
        planck_grid=planck_grid.astype(dt),
        starflux=starflux,
        surf_albedo=jnp.asarray(surf_albedo, dt),
        cloud_abs_cross_lay=(jnp.asarray(cloud_result.abs_cross_lay, dt)
                             if cloud_result is not None else zeros_lb),
        cloud_scat_cross_lay=(jnp.asarray(cloud_result.scat_cross_lay, dt)
                              if cloud_result is not None else zeros_lb),
        g_0_cloud_lay=(jnp.asarray(cloud_result.g_0_lay, dt)
                       if cloud_result is not None else zeros_lb),
        cloud_abs_cross_int=(jnp.asarray(cloud_result.abs_cross_int, dt)
                             if cloud_result is not None else zeros_ib),
        cloud_scat_cross_int=(jnp.asarray(cloud_result.scat_cross_int, dt)
                              if cloud_result is not None else zeros_ib),
        g_0_cloud_int=(jnp.asarray(cloud_result.g_0_int, dt)
                       if cloud_result is not None else zeros_ib),
        add_heat_dens=zeros_l,
        star_corr_factor=star_corr)
    return phys, arrays


# --------------------------------------------------------------------------- #
# altitude (device-side; reference does this on host, host_functions.py:673-698)
# --------------------------------------------------------------------------- #

def altitude_z(phys: Phys, m: ModelArrays, T_lay, meanmolmass_lay):
    """Layer thickness and center altitudes.

    delta_z = k_B T/(mu g) ln(p_i/p_{i+1}) (calc_delta_z, kernels.cu:1247-1261)
    then integrated with the gas-planet 10-bar anchor or the surface anchor
    (host_functions.py:673-698).
    """
    L = phys.nlayer
    delta_z = (pc.K_B * T_lay[:L] / (meanmolmass_lay * phys.g)
               * jnp.log(m.p_int[:L] / m.p_int[1:]))
    # cumulative midpoint sums: s[0] = 0, s[i] = s[i-1] + (dz[i-1]+dz[i])/2
    mid = 0.5 * (delta_z[:-1] + delta_z[1:])
    s = jnp.concatenate([jnp.zeros((1,), delta_z.dtype), jnp.cumsum(mid)])
    if phys.planet_type == "gas":
        mask = m.p_lay >= 1e7
        idx = jnp.where(mask, jnp.arange(L), -1).max()
        anchor = jnp.where(idx >= 0, s[jnp.maximum(idx, 0)], s[0])
        z_lay = s - anchor
    else:
        z_lay = s + 0.5 * delta_z[0]
    return delta_z, z_lay


# --------------------------------------------------------------------------- #
# per-cell quantities refresh (every 10th iteration in the reference)
# --------------------------------------------------------------------------- #

def _gas_properties(phys: Phys, m: ModelArrays, T, p, sset):
    """(opacity, Rayleigh cross-section, mean molecular mass) on a T-P
    profile -- premixed-table interpolation or on-the-fly species mixing."""
    if phys.opacity_mixing == "on-the-fly":
        from helios_tpu import chem
        return chem.mixed_opacities(
            sset, T, p, m.lambda_centers, m.gauss_weight, m.gauss_y,
            ro_method=phys.ro_method, scat=phys.scat)
    opac, scat = interp_ops.interpolate_opacity(
        m.ktable, m.scat_cross_table, m.ktemps, m.kpress, T, p)
    mmm = interp_ops.interpolate_meanmolmass(
        m.meanmolmass_table, m.ktemps, m.kpress, T, p)
    return opac, scat, mmm


def _effective_g0(phys: Phys, m: ModelArrays, scat_band, cloud_scat,
                  g0_cloud, n):
    if phys.clouds:
        return ts_ops.g0_total(scat_band, g0_cloud, cloud_scat, phys.g_0)
    return jnp.full(scat_band.shape, phys.g_0, scat_band.dtype)


def compute_cells(phys: Phys, m: ModelArrays, T_lay, T_int,
                  sset=None) -> CellCache:
    """Opacity interpolation + transmission + direct beam: the block the
    reference refreshes every 10th iteration (computation.py:860-879).

    All spectral outputs are in the flat [.., S] layout (see fastpath).
    """
    from helios_tpu import fastpath as fp

    L, Y = phys.nlayer, phys.ny

    opac_lay, scat_lay, mmm_lay = _gas_properties(
        phys, m, T_lay[:L], m.p_lay, sset)
    if opac_lay.ndim == 3:        # on-the-fly mixing returns [L, B, Y]
        opac_lay = fp.cube_to_flat(opac_lay)

    delta_z, z_lay = altitude_z(phys, m, T_lay, mmm_lay)

    planckband_lay = planck_mod.planckband_layers(
        m.planck_grid, T_lay, m.starflux, real_star=phys.real_star,
        dim=phys.plancktable_dim, step=phys.plancktable_step)
    planck_star_flat = fp.band_to_flat(planckband_lay[L], Y)

    # scattering on/off (kernels.cu scat flag): zero the cross sections
    if phys.scat:
        ray_lay = scat_lay
        cld_scat_lay = m.cloud_scat_cross_lay
        cld_scat_int = m.cloud_scat_cross_int
    else:
        ray_lay = jnp.zeros_like(scat_lay)
        cld_scat_lay = jnp.zeros_like(m.cloud_scat_cross_lay)
        cld_scat_int = jnp.zeros_like(m.cloud_scat_cross_int)

    g0_lay = _effective_g0(phys, m, scat_lay, m.cloud_scat_cross_lay,
                           m.g_0_cloud_lay, L)

    kw = dict(epsi=phys.epsi, epsi2=phys.epsi2, mu_star=phys.mu_star,
              w_0_limit=phys.w_0_limit, scat_corr=phys.scat_corr,
              i2s_transition=phys.i2s_transition)

    nint = L + 1
    # masked 1/mu matrix only for the geometric zenith correction; the
    # plain-mu* beam uses the O(L) cumulative-sum path inside fdir_*_flat
    # (and when the beam is off entirely, F_dir is identically zero and
    # nothing is computed at all)
    if phys.dir_beam and phys.geom_zenith_corr:
        mu_mat = beam_ops._mu_star_matrix(z_lay, phys.mu_star,
                                          phys.R_planet,
                                          phys.geom_zenith_corr, nint,
                                          opac_lay.dtype)
        mask = (jnp.arange(L)[None, :] >= jnp.arange(nint)[:, None])
        mu_weights = jnp.where(mask, 1.0 / mu_mat, 0.0)
        mu_diag = jnp.diagonal(mu_mat[:L])
    else:
        mu_weights = None
        mu_diag = None

    S = opac_lay.shape[-1]
    alb_flat = fp.band_to_flat(m.surf_albedo, Y)
    coeff_kw = dict(scat_corr=phys.scat_corr,
                    i2s_transition=phys.i2s_transition, epsi=phys.epsi,
                    mu_star=phys.mu_star, dir_beam=phys.dir_beam,
                    f_factor=phys.f_factor, R_star=phys.R_star, a=phys.a)

    if phys.iso:
        cells = fp.cell_quantities_flat(
            opac_lay, mmm_lay, ray_lay, m.cloud_abs_cross_lay,
            cld_scat_lay, m.delta_colmass, g0_lay, Y, **kw)
        if phys.dir_beam:
            # reference attenuates the direct beam through the gas-only
            # optical depth (delta_tau_wg, kernels.cu:1306) -- clouds
            # excluded
            F_dir = fp.fdir_iso_flat(
                planck_star_flat, cells.delta_tau, mu_weights,
                mu_star=phys.mu_star, R_star=phys.R_star, a=phys.a,
                dir_beam=phys.dir_beam)
        else:
            F_dir = jnp.zeros((nint, S), opac_lay.dtype)
        Fc_dir = jnp.zeros((L,) + F_dir.shape[1:], F_dir.dtype)
        lower = cells
        scat_trigger = jnp.any(cells.w0 > phys.w_0_scat_limit, axis=0)
        coeff = fp.iso_coeff_cache(cells, planck_star_flat, F_dir,
                                   alb_flat, **coeff_kw)
    else:
        opac_int, scat_int, mmm_int = _gas_properties(
            phys, m, T_int, m.p_int, sset)
        if opac_int.ndim == 3:
            opac_int = fp.cube_to_flat(opac_int)
        g0_int = _effective_g0(phys, m, scat_int, m.cloud_scat_cross_int,
                               m.g_0_cloud_int, nint)
        if not phys.scat:
            ray_int = jnp.zeros_like(scat_int)
        else:
            ray_int = scat_int

        # upper/lower half-layer averages (calc_trans_noniso,
        # kernels.cu:1171-1196)
        def up_mean(lay, intr):
            return 0.5 * (lay + intr[1:])

        def low_mean(lay, intr):
            return 0.5 * (intr[:-1] + lay)

        upper = fp.cell_quantities_flat(
            up_mean(opac_lay, opac_int), up_mean(mmm_lay, mmm_int),
            up_mean(ray_lay, ray_int),
            up_mean(m.cloud_abs_cross_lay, m.cloud_abs_cross_int),
            up_mean(cld_scat_lay, cld_scat_int),
            m.delta_col_upper, up_mean(g0_lay, g0_int), Y, **kw)
        lower = fp.cell_quantities_flat(
            low_mean(opac_lay, opac_int), low_mean(mmm_lay, mmm_int),
            low_mean(ray_lay, ray_int),
            low_mean(m.cloud_abs_cross_lay, m.cloud_abs_cross_int),
            low_mean(cld_scat_lay, cld_scat_int),
            m.delta_col_lower, low_mean(g0_lay, g0_int), Y, **kw)
        scat_trigger = (jnp.any(upper.w0 > phys.w_0_scat_limit, axis=0)
                        | jnp.any(lower.w0 > phys.w_0_scat_limit, axis=0))

        if phys.dir_beam:
            F_dir, Fc_dir = fp.fdir_noniso_flat(
                planck_star_flat, upper.delta_tau, lower.delta_tau,
                mu_weights, mu_diag, mu_star=phys.mu_star,
                R_star=phys.R_star, a=phys.a, dir_beam=phys.dir_beam)
        else:
            F_dir = jnp.zeros((nint, S), opac_lay.dtype)
            Fc_dir = jnp.zeros((L, S), opac_lay.dtype)
        cells = upper
        coeff = fp.noniso_coeff_cache(
            upper, lower, planck_star_flat, F_dir, Fc_dir, alb_flat,
            delta_tau_limit=phys.delta_tau_limit, **coeff_kw)

    # additional heating flux per layer: volumetric density * layer height
    # (host_functions.py:701-711), refreshed with delta_z every cell update
    F_add_heat_lay = m.add_heat_dens * delta_z
    F_add_heat_sum = jnp.cumsum(F_add_heat_lay)

    return CellCache(cells_or_upper=cells, lower=lower,
                     scat_trigger=scat_trigger, F_dir=F_dir, Fc_dir=Fc_dir,
                     meanmolmass_lay=mmm_lay, z_lay=z_lay,
                     opac_lay=opac_lay, scat_cross_lay=scat_lay,
                     F_add_heat_lay=F_add_heat_lay,
                     F_add_heat_sum=F_add_heat_sum,
                     coeff=coeff)


# --------------------------------------------------------------------------- #
# flux solve (every iteration)
# --------------------------------------------------------------------------- #

def _matrix_cells(cells, ny):
    """Legacy CellQuantities whose delta_tau carries the TOTAL optical
    depth (the matrix path reads delta_tau_total = delta_tau + clouds,
    with the cloud part folded in here)."""
    from helios_tpu import fastpath as fp
    c = lambda x: fp.flat_to_cube(x, ny)
    return ts_ops.CellQuantities(
        w0=c(cells.w0), delta_tau=c(cells.delta_tau_total),
        delta_tau_clouds=jnp.zeros(cells.w0.shape[:-1]
                                   + (cells.w0.shape[-1] // ny,),
                                   cells.w0.dtype),
        trans=c(cells.trans), M=c(cells.M), N=c(cells.N), P=c(cells.P),
        G_pl=c(cells.G_pl), G_min=c(cells.G_min),
        g0=c(cells.g0)[..., 0])


def solve_fluxes(phys: Phys, m: ModelArrays, cache: CellCache, T_lay,
                 flux_state: FluxState) -> FluxState:
    """One spectral flux solve (iterative sweeps or Thomas matrix).

    Flat [.., S] layout throughout the iterative path; the matrix method
    reshapes to the reference layout around the tridiagonal solve."""
    from helios_tpu import fastpath as fp

    L, Y = phys.nlayer, phys.ny

    planckband_lay = planck_mod.planckband_layers(
        m.planck_grid, T_lay, m.starflux, real_star=phys.real_star,
        dim=phys.plancktable_dim, step=phys.plancktable_step)

    common = dict(scat_corr=phys.scat_corr,
                  i2s_transition=phys.i2s_transition, epsi=phys.epsi,
                  mu_star=phys.mu_star, dir_beam=phys.dir_beam,
                  f_factor=phys.f_factor, R_star=phys.R_star, a=phys.a)

    B_lay_flat = fp.band_to_flat(planckband_lay[:L], Y)
    B_surf_flat = fp.band_to_flat(planckband_lay[L + 1], Y)

    if phys.iso:
        cells = cache.cells_or_upper
        if phys.flux_calc_method == "iteration":
            C = fp.iso_coeffs_from_cache(cache.coeff, B_lay_flat,
                                         B_surf_flat)
            F_down, F_up = fp.fband_iso_flat(
                C, cache.F_dir[0], flux_state.F_up,
                n_passes=phys.n_sweep_passes,
                use_pallas=phys.pallas_active)
        else:
            Fd, Fu = thomas_ops.fband_matrix_iso(
                _matrix_cells(cells, Y), planckband_lay,
                fp.flat_to_cube(cache.F_dir, Y), m.surf_albedo,
                fp.flat_to_cube(cache.scat_trigger[None], Y)[0], **common)
            F_down, F_up = fp.cube_to_flat(Fd), fp.cube_to_flat(Fu)
        return flux_state._replace(F_down=F_down, F_up=F_up)
    else:
        T_int = interp_ops.interface_temperatures(T_lay)
        planckband_int = planck_mod.planckband_interfaces(
            m.planck_grid, T_int, dim=phys.plancktable_dim,
            step=phys.plancktable_step)
        upper, lower = cache.cells_or_upper, cache.lower
        if phys.flux_calc_method == "iteration":
            B_int_flat = fp.band_to_flat(planckband_int, Y)
            C = fp.noniso_coeffs_from_cache(
                cache.coeff, B_lay_flat, B_int_flat[:-1], B_int_flat[1:],
                B_surf_flat)
            F_down, F_up, Fc_down, Fc_up = fp.fband_noniso_flat(
                C, cache.F_dir[0], flux_state.F_up, flux_state.Fc_up,
                n_passes=phys.n_sweep_passes,
                use_pallas=phys.pallas_active)
        else:
            res = thomas_ops.fband_matrix_noniso(
                _matrix_cells(upper, Y), _matrix_cells(lower, Y),
                planckband_lay, planckband_int,
                fp.flat_to_cube(cache.F_dir, Y),
                fp.flat_to_cube(cache.Fc_dir, Y), m.surf_albedo,
                fp.flat_to_cube(cache.scat_trigger[None], Y)[0],
                delta_tau_limit=phys.delta_tau_limit, **common)
            F_down, F_up, Fc_down, Fc_up = (fp.cube_to_flat(x)
                                            for x in res)
        return FluxState(F_down=F_down, F_up=F_up, Fc_down=Fc_down,
                         Fc_up=Fc_up)


def integrate_flux_flat(phys: Phys, m: ModelArrays, flux_state: FluxState,
                        F_dir_flat, axis_name: Optional[str] = None
                        ) -> int_ops.FluxTotals:
    """Band + total integration from flat fluxes (kernels.cu:2428-2513).

    ``axis_name``: mesh axis holding spectral shards (when called inside
    shard_map); the band->total reduction then psums the partial sums
    across devices -- the only collective in the whole RCE iteration
    (SURVEY.md section 2.4: all other physics is bin-local).
    """
    from helios_tpu import fastpath as fp
    F_down_band = fp.gauss_band_flat(flux_state.F_down, m.gauss_weight)
    F_up_band = fp.gauss_band_flat(flux_state.F_up, m.gauss_weight)
    F_dir_band = fp.gauss_band_flat(F_dir_flat, m.gauss_weight)
    F_up_tot = jnp.sum(F_up_band * m.delta_lambda, axis=-1)
    F_down_tot = jnp.sum((F_dir_band + F_down_band) * m.delta_lambda,
                         axis=-1)
    if axis_name is not None:
        F_up_tot = jax.lax.psum(F_up_tot, axis_name)
        F_down_tot = jax.lax.psum(F_down_tot, axis_name)
    return int_ops.FluxTotals(
        F_down_band=F_down_band, F_up_band=F_up_band,
        F_dir_band=F_dir_band, F_down_tot=F_down_tot, F_up_tot=F_up_tot,
        F_net=F_up_tot - F_down_tot)


def forward_fluxes(phys: Phys, m: ModelArrays, T_lay,
                   flux_state: Optional[FluxState] = None, sset=None,
                   axis_name: Optional[str] = None
                   ) -> Tuple[FluxState, int_ops.FluxTotals, CellCache]:
    """Full forward model: temperatures -> integrated fluxes.

    ``axis_name``: spectral mesh axis when running inside shard_map (the
    model arrays then hold this device's wavelength shard)."""
    if flux_state is None:
        flux_state = init_flux_state(phys, T_lay.dtype)
    T_int = interp_ops.interface_temperatures(T_lay)
    cache = compute_cells(phys, m, T_lay, T_int, sset)
    flux_state = solve_fluxes(phys, m, cache, T_lay, flux_state)
    totals = integrate_flux_flat(phys, m, flux_state, cache.F_dir,
                                 axis_name)
    return flux_state, totals, cache
