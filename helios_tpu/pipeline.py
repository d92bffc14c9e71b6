"""The end-to-end run pipeline: config -> loops -> outputs.

Equivalent of the reference's run_helios (helios.py:35-137): read config,
build the model, run the radiative and convective loops (each a single
jitted device program), then one device->host transfer and the output
writers.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from helios_tpu import constants as pc
from helios_tpu import grid as grid_mod
from helios_tpu import planck as planck_mod
from helios_tpu.config import HeliosConfig
from helios_tpu.forward import (ModelArrays, Phys, build_model,
                                compute_cells, forward_fluxes)
from helios_tpu.io import writers
from helios_tpu.io.opacity import OpacityTable, load_opacity_file
from helios_tpu.ops import integrate as int_ops
from helios_tpu.ops import interp as interp_ops
from helios_tpu.rce import convect
from helios_tpu.rce.loop import ConvLoopState, convection_loop
from helios_tpu.rce.radiative import (RadLoopState, ThermoProps,
                                      kappa_cp_lay, make_const_thermo,
                                      radiation_loop)


def initial_temperatures(cfg: HeliosConfig, phys: Phys,
                         m: ModelArrays) -> np.ndarray:
    """Initial TP profile: isothermal at T_eff (host_functions.py:164-184)
    or restart from a previous tp file (read.py:1274-1322)."""
    if cfg.singlewalk or cfg.force_start_tp_from_file:
        return load_tp_file(cfg.temp_path, cfg.temp_format, phys.nlayer,
                            np.asarray(m.p_lay), np.asarray(m.p_int))
    return grid_mod.initial_temperature(
        phys.nlayer, f_factor=phys.f_factor, dir_beam=phys.dir_beam,
        mu_star=phys.mu_star, R_star=phys.R_star, a=phys.a,
        T_star=phys.T_star)


def load_tp_file(path: str, fmt: str, nlayer: int, p_lay: np.ndarray,
                 p_int: np.ndarray) -> np.ndarray:
    """Read a TP restart file (read.py:1274-1322).

    "helios" format: the reference's *_tp.dat layout (BOA row then layers,
    temperature in column 1).  "TP"/"PT": two-column ASCII with pressure in
    [10^-6 bar], interpolated in log-P onto the model grid (clamped at the
    file's pressure range).

    Returns [nlayer+1] with the surface/BOA ghost at index nlayer.
    """
    if fmt == "helios":
        T = []
        with open(path) as f:
            lines = [ln.split() for ln in f if ln.strip()]
        # row 2 = BOA (surface), rows 3.. = layers (write.py:128-145)
        T_surf = float(lines[2][1])
        for ln in lines[3:]:
            T.append(float(ln[1]))
        T = np.asarray(T)
        if len(T) != nlayer:
            raise ValueError(
                f"restart file has {len(T)} layers, expected {nlayer}")
        return np.concatenate([T, [T_surf]])

    cols = np.loadtxt(path)
    if fmt == "PT":
        press, temp = cols[:, 0], cols[:, 1]
    elif fmt == "TP":
        temp, press = cols[:, 0], cols[:, 1]
    else:
        raise ValueError(f"unknown TP format {fmt!r}")
    order = np.argsort(press)
    logp, temp = np.log10(press[order]), temp[order]
    T_lay = np.interp(np.log10(p_lay), logp, temp)
    T_surf = np.interp(np.log10(p_int[0]), logp, temp)
    return np.concatenate([T_lay, [T_surf]])


@dataclass
class RunOutput:
    phys: Phys
    arrays: ModelArrays
    rad: RadLoopState
    conv: Optional[ConvLoopState]
    result: writers.RunResult
    wall_seconds: float


def post_process(phys: Phys, m: ModelArrays, T_lay, flux_state,
                 F_smooth_sum, conv_layer=None, thermo=None, sset=None):
    """Final-state diagnostics (computation.py:1176-1296): band-integrated
    optical depth/transmission, contribution function, mean opacities,
    beam flux.  One jitted call."""
    from helios_tpu import fastpath as fp
    from helios_tpu.forward import integrate_flux_flat

    Y = phys.ny
    cube = lambda x: fp.flat_to_cube(x, Y)
    T_int = interp_ops.interface_temperatures(T_lay)
    cache = compute_cells(phys, m, T_lay, T_int, sset)
    totals = integrate_flux_flat(phys, m, flux_state, cache.F_dir)
    if phys.iso:
        cells = cache.cells_or_upper
        trans_full = cube(cells.trans)
        dtau_band, trans_band = int_ops.integrate_optdepth_transmission_iso(
            cube(cells.delta_tau_total), cube(cells.trans), m.gauss_weight)
    else:
        up, low = cache.cells_or_upper, cache.lower
        trans_full = cube(up.trans) * cube(low.trans)
        dtau_band, trans_band = (
            int_ops.integrate_optdepth_transmission_noniso(
                cube(up.delta_tau_total), cube(low.delta_tau_total),
                cube(up.trans), cube(low.trans), m.gauss_weight))

    planckband_lay = planck_mod.planckband_layers(
        m.planck_grid, T_lay, m.starflux, real_star=phys.real_star,
        dim=phys.plancktable_dim, step=phys.plancktable_step)
    trans_weight_band, contr_band = int_ops.contribution_function(
        trans_full, planckband_lay, m.gauss_weight, phys.epsi)

    means = int_ops.mean_opacities(
        cube(cache.opac_lay), m.cloud_abs_cross_lay, cache.meanmolmass_lay,
        planckband_lay, m.lambda_edges, m.delta_lambda, T_lay,
        m.gauss_weight, m.gauss_y, phys.T_star)

    return dict(cache=cache, totals=totals, dtau_band=dtau_band,
                trans_band=trans_band, trans_weight_band=trans_weight_band,
                contr_band=contr_band, means=means,
                planckband_lay=planckband_lay)


def collect_result(cfg: HeliosConfig, phys: Phys, m: ModelArrays,
                   final_T, flux_state, post, *, conv_unstable=None,
                   conv_layer=None, F_smooth_sum=None, F_net_diff=None,
                   kappa_lay=None, c_p_lay=None, entropy_lay=None,
                   phase_number_lay=None, relaxed=0,
                   final_limit=None, singlewalk=None,
                   star_corr_factor=None,
                   cloud_result=None) -> writers.RunResult:
    """Assemble the host-side RunResult snapshot (one device->host pull)."""
    L = phys.nlayer
    cache = post["cache"]
    totals = post["totals"]
    # the stellar energy-budget correction rides on ModelArrays so every
    # caller (pipeline, ensemble, tests) gets the right eclipse-depth
    # normalisation (host_functions.py:663)
    if star_corr_factor is None:
        star_corr_factor = float(np.asarray(m.star_corr_factor))

    delta_z, z_lay = None, None
    from helios_tpu.forward import altitude_z
    delta_z, z_lay = altitude_z(phys, m, final_T, cache.meanmolmass_lay)

    F_smooth_sum = (np.zeros(L) if F_smooth_sum is None
                    else np.asarray(F_smooth_sum))
    conv_layer_np = (np.zeros(L + 1, int) if conv_layer is None
                     else np.asarray(conv_layer).astype(int))
    F_net = np.asarray(totals.F_net)

    r = writers.RunResult(
        name=cfg.name, output_dir=cfg.output_dir, nlayer=L, nbin=phys.nbin,
        iso=phys.iso, convection=phys.convection,
        singlewalk=phys.singlewalk if singlewalk is None else singlewalk,
        T_star=phys.T_star, R_planet=phys.R_planet, R_star=phys.R_star,
        F_intern=phys.F_intern, star_corr_factor=float(star_corr_factor),
        input_kappa_value=cfg.kappa_value,
        input_surf_albedo=cfg.surf_albedo,
        albedo_file_surface_name=cfg.albedo_surface_name,
        p_lay=np.asarray(m.p_lay), p_int=np.asarray(m.p_int),
        delta_colmass=np.asarray(m.delta_colmass),
        T_lay=np.asarray(final_T),
        z_lay=np.asarray(z_lay), delta_z_lay=np.asarray(delta_z),
        meanmolmass_lay=np.asarray(cache.meanmolmass_lay),
        c_p_lay=(np.asarray(c_p_lay) if c_p_lay is not None
                 else np.zeros(L)),
        kappa_lay=(np.asarray(kappa_lay) if kappa_lay is not None
                   else np.zeros(L)),
        entropy_lay=(np.asarray(entropy_lay) if entropy_lay is not None
                     else np.zeros(L)),
        phase_number_lay=(np.asarray(phase_number_lay)
                          if phase_number_lay is not None else None),
        conv_unstable=(np.asarray(conv_unstable).astype(int)
                       if conv_unstable is not None
                       else np.zeros(L + 1, int)),
        conv_layer=conv_layer_np,
        opac_wave=np.asarray(m.lambda_centers),
        opac_interwave=np.asarray(m.lambda_edges),
        opac_deltawave=np.asarray(m.delta_lambda),
        F_down_tot=np.asarray(totals.F_down_tot),
        F_up_tot=np.asarray(totals.F_up_tot),
        F_net=F_net,
        F_dir_tot=np.asarray(int_ops.integrate_beamflux(
            totals.F_dir_band, m.delta_lambda)),
        F_net_diff=(np.asarray(F_net_diff) if F_net_diff is not None
                    else F_net[:L] - F_net[1:]),
        F_add_heat_lay=np.asarray(cache.F_add_heat_lay),
        F_add_heat_sum=np.asarray(cache.F_add_heat_sum),
        F_smooth_sum=F_smooth_sum,
        F_down_band=np.asarray(totals.F_down_band),
        F_up_band=np.asarray(totals.F_up_band),
        F_dir_band=np.asarray(totals.F_dir_band),
        planckband_lay=np.asarray(post["planckband_lay"]),
        planckband_int=(np.asarray(planck_mod.planckband_interfaces(
            m.planck_grid, interp_ops.interface_temperatures(final_T),
            dim=phys.plancktable_dim, step=phys.plancktable_step))
            if phys.iso == 0 else None),
        opac_band_lay=np.asarray(post["means"]["opac_band_lay"]),
        scat_cross_lay=np.asarray(cache.scat_cross_lay),
        g_0_tot_lay=(np.asarray(cache.cells_or_upper.g0).reshape(
            L, phys.nbin, phys.ny)[:, :, 0] if phys.clouds
            else np.full((L, phys.nbin), phys.g_0)),
        trans_band=np.asarray(post["trans_band"]),
        delta_tau_band=np.asarray(post["dtau_band"]),
        contr_func_band=np.asarray(post["contr_band"]),
        trans_weight_band=np.asarray(post["trans_weight_band"]),
        planck_opac_T_pl=np.asarray(post["means"]["planck_opac_T_pl"]),
        ross_opac_T_pl=np.asarray(post["means"]["ross_opac_T_pl"]),
        planck_opac_T_star=np.asarray(post["means"]["planck_opac_T_star"]),
        ross_opac_T_star=np.asarray(post["means"]["ross_opac_T_star"]),
        surf_albedo=np.asarray(m.surf_albedo),
        relaxed_criterion_trigger=relaxed,
        rad_convergence_limit=(float(final_limit) if final_limit is not None
                               else phys.rad_convergence_limit),
    )
    if cloud_result is not None:
        r.f_all_clouds_lay = cloud_result.f_lay
        r.abs_cross_all_clouds_lay = cloud_result.abs_cross_lay
        r.scat_cross_all_clouds_lay = cloud_result.scat_cross_lay
        dcm = np.asarray(m.delta_colmass)[:, None]
        mmm = np.asarray(cache.meanmolmass_lay)[:, None]
        r.delta_tau_all_clouds = (dcm * (cloud_result.abs_cross_lay
                                         + cloud_result.scat_cross_lay)
                                  / mmm)
    r.F_net_conv = writers.calculate_conv_flux(r)
    return r


def load_starflux(cfg: HeliosConfig, nbin: int) -> np.ndarray:
    """Stellar spectrum from HDF5 or zeros for blackbody mode
    (read.py:1195-1236)."""
    if cfg.stellar_model == "file":
        import h5py
        with h5py.File(cfg.stellar_path, "r") as f:
            starflux = np.asarray(f[cfg.stellar_dataset][:], float)
        if len(starflux) != nbin:
            raise OverflowError(
                "Stellar spectrum and opacity files have different "
                f"lengths ({len(starflux)} vs {nbin}).")
        return starflux
    if cfg.stellar_model == "blackbody":
        return np.zeros(nbin)
    raise IOError("Unknown stellar model. Please check your input.")


def build_species_set_from_files(cfg: HeliosConfig):
    """On-the-fly inputs from the configured file paths (helios.py:51-55).

    Returns (SpeciesSet, donor OpacityTable carrying the spectral/T/P
    grids from the first absorbing species file)."""
    import os

    from helios_tpu import chem
    from helios_tpu.io.opacity import load_opacity_file as _load

    specs = chem.parse_species_file(cfg.species_path)

    donor = None
    opacity_tables = {}
    for spec in specs:
        if not spec.absorbing:
            continue
        for suffix in ("_opac_ip_kdistr.h5", "_opac_ip.h5",
                       "_opac_ip_sampling.h5"):
            path = os.path.join(cfg.species_opacity_dir,
                                spec.name + suffix)
            if os.path.exists(path):
                t = _load(path, premixed=False)
                opacity_tables[spec.name] = t.kpoints
                if donor is None:
                    donor = t
                break
        else:
            raise IOError(f"No opacity file found for {spec.name} in "
                          f"{cfg.species_opacity_dir}")

    scat_tables = {}
    scat_path = os.path.join(cfg.species_opacity_dir,
                             "scat_cross_sections.h5")
    if os.path.exists(scat_path):
        import h5py
        with h5py.File(scat_path, "r") as f:
            for spec in specs:
                key = "rayleigh_" + spec.name
                if spec.scattering and spec.name != "H2O" and key in f:
                    scat_tables[spec.name] = np.asarray(f[key][:], float)

    vmr_table = vmr_press = None
    if any(s.source_for_vmr == "file" for s in specs):
        vmr_table = np.genfromtxt(cfg.vmr_file_path, names=True, dtype=None,
                                  skip_header=cfg.vmr_file_header_lines)
        vmr_press = np.asarray(vmr_table[cfg.vmr_file_press_name], float)
        if cfg.vmr_file_press_unit == "Pa":
            vmr_press = vmr_press * 10.0
        elif cfg.vmr_file_press_unit == "bar":
            vmr_press = vmr_press * 1e6

    g = grid_mod.build_grid(cfg.p_boa, cfg.p_toa, cfg.nlayer, cfg.g)
    sset = chem.build_species_set(
        specs, ktemps=donor.temperatures, kpress=donor.pressures,
        nbin=donor.nbin, ny=donor.ny, nlayer=cfg.nlayer,
        opacity_tables=opacity_tables, scat_tables=scat_tables,
        vmr_file_table=vmr_table, vmr_file_press=vmr_press,
        fastchem_dir=cfg.fastchem_dir, p_lay=g.p_lay, p_int=g.p_int)
    return sset, donor


def make_thermo(cfg: HeliosConfig):
    """kappa/c_p/entropy source (read.py:1105-1193): a constant, or the
    "file"/"water_atmo" ASCII table modes for real-gas thermodynamics.
    The table is loaded whenever a file mode is selected -- even for
    post-processing runs -- because entropy/phase diagnostics are
    interpolated from it at the end (computation.py:252-292)."""
    if (isinstance(cfg.kappa_value, str)
            and cfg.kappa_value in ("file", "water_atmo")):
        from helios_tpu import thermo as thermo_mod
        from helios_tpu.rce.radiative import make_table_thermo
        tbl = thermo_mod.load_entropy_table(cfg.kappa_file_path,
                                            cfg.kappa_value)
        return make_table_thermo(tbl, jnp.dtype(cfg.dtype))
    if cfg.convection:
        return make_const_thermo(float(cfg.kappa_value))
    return None


def prepare_model(cfg: HeliosConfig, table: OpacityTable):
    """Input preprocessing + model assembly (helios.py:56-79): Koll
    f-factor, stellar spectrum, surface albedo, cloud decks, additional
    heating.  Returns (phys, arrays, cloud_result).  Shared by
    pipeline.run and the planet-ensemble driver."""
    from helios_tpu import host_physics as hp

    # Koll (2021) f-factor approximation for rocky planets
    # (helios.py:67-68)
    if cfg.approx_f and cfg.planet_type == "rocky":
        tau_lw = hp.read_tau_lw_from_file(cfg.output_dir, cfg.name)
        if tau_lw is not None:
            cfg.tau_lw = tau_lw
        cfg.f_factor = hp.approx_f_from_formula(
            tau_lw=cfg.tau_lw, p_boa=cfg.p_boa, R_star=cfg.R_star,
            a=cfg.a, T_star=cfg.T_star)

    starflux = load_starflux(cfg, table.nbin)
    surf_albedo = hp.load_surf_albedo(cfg, table.wave_centers)

    cloud_result = None
    if cfg.clouds:
        from helios_tpu import clouds as clouds_mod
        g = grid_mod.build_grid(cfg.p_boa, cfg.p_toa, cfg.nlayer, cfg.g)
        cloud_result = clouds_mod.cloud_pre_processing(
            cfg, table.wave_centers, table.wave_edges, g.p_lay, g.p_int,
            cfg.iso)

    phys, arrays = build_model(cfg, table, starflux=starflux,
                               surf_albedo=surf_albedo,
                               cloud_result=cloud_result)

    if cfg.add_heating:
        arrays = arrays._replace(add_heat_dens=jnp.asarray(
            hp.load_additional_heating(cfg, np.asarray(arrays.p_lay))))
    return phys, arrays, cloud_result


def radiation_program(phys: Phys, thermo, sset=None):
    """The radiative loop `run` executes on one device, jitted:
    (arrays, T0) -> RadLoopState."""
    return jax.jit(lambda m, T0: radiation_loop(phys, m, thermo, T0,
                                                sset=sset))


def convection_program(phys: Phys, thermo, sset=None):
    """The convective loop `run` executes on one device, jitted:
    (arrays, RadLoopState) -> ConvLoopState."""
    return jax.jit(lambda m, rad: convection_loop(phys, m, thermo, rad,
                                                  sset=sset))


def run(cfg: HeliosConfig, table: Optional[OpacityTable] = None,
        write_output: bool = True, sset=None) -> RunOutput:
    """Full pipeline run (the run_helios equivalent, helios.py:35-137)."""
    from helios_tpu import host_physics as hp

    t0 = time.time()
    if not cfg._finalized:
        cfg = cfg.finalize()

    if cfg.opacity_mixing == "on-the-fly" and sset is None and table is None:
        sset, table = build_species_set_from_files(cfg)
    if table is None:
        table = load_opacity_file(cfg.opacity_path)

    phys, arrays, cloud_result = prepare_model(cfg, table)

    thermo = make_thermo(cfg)

    T0 = jnp.asarray(initial_temperatures(cfg, phys, arrays))

    # multi-device: shard the lambda x y grid over `n_spectral_shards`
    # devices; the RCE loops then run under shard_map with one
    # band->total psum per iteration (parallel/sharding.py).  The
    # reference has no distributed mode at all (SURVEY.md section 2.4).
    mesh = None
    phys_run, arrays_run, sset_run = phys, arrays, sset
    if int(cfg.n_spectral_shards) > 1:
        from helios_tpu.parallel import sharding as shd
        n_spec = int(cfg.n_spectral_shards)
        devs = jax.devices()
        if len(devs) < n_spec:
            raise RuntimeError(
                f"n_spectral_shards={n_spec} but only {len(devs)} "
                "devices are visible")
        # any bin count runs on any shard count: pad the spectral axis
        # up to a shard multiple with zero delta_lambda (the reference
        # grid is 385 = 5*7*11 bins, indivisible by 2/4/8 devices)
        if phys.nbin % n_spec != 0:
            phys_run, arrays_run = shd.pad_spectral(phys, arrays, n_spec)
            if sset is not None:
                sset_run = shd.pad_species(sset, n_spec)
        mesh = shd.make_mesh(n_planet=1, n_spectral=n_spec,
                             devices=devs[:n_spec])
        arrays_run = shd.place_model(arrays_run, mesh)
        if sset_run is not None:
            sset_run = shd.place_species(sset_run, mesh)
        if phys_run.nbin == phys.nbin:
            # no padding: post-processing can reuse the placed arrays
            arrays, sset = arrays_run, sset_run

    # mid-run coupling TP writes need the chunked runner, as does debug
    # mode (its finiteness/negative-flux checks run at chunk boundaries)
    coupl_interval = (int(cfg.coupl_tp_write_interval) if cfg.coupling
                      else 0)
    monitored = (cfg.checkpoint_every > 0 or cfg.realtime_plot
                 or cfg.metrics_file or cfg.profile_dir
                 or cfg.progress or phys.debug
                 or coupl_interval > 0) and not phys.singlewalk
    if monitored:
        from helios_tpu import checkpoint as ckpt_mod
        from helios_tpu import monitor as monitor_mod

        obs_callbacks = []   # observability only (reused by convection)
        state0 = None
        if cfg.progress:
            obs_callbacks.append(monitor_mod.ProgressPrinter(phys.nlayer))
        if cfg.metrics_file:
            obs_callbacks.append(
                monitor_mod.MetricsWriter(cfg.metrics_file))
        if cfg.realtime_plot:
            obs_callbacks.append(monitor_mod.PlotCallback(phys))
        if phys.debug:
            obs_callbacks.append(monitor_mod.DebugChecker())
        if coupl_interval > 0:
            obs_callbacks.append(monitor_mod.CouplingTPWriter(
                _coupling_tp_path(cfg, cfg.coupling_iter_nr), phys.nlayer,
                np.asarray(arrays.p_lay), np.asarray(arrays.p_int),
                coupl_interval))
        callbacks = list(obs_callbacks)
        ckpt_path = conv_ckpt_path = None
        if cfg.checkpoint_every > 0:
            ckpt_path = cfg.checkpoint_path or os.path.join(
                cfg.output_dir, cfg.name, "restart.ckpt.npz")
            # insert the _conv suffix before the (possibly compound)
            # extension so ANY user-supplied path yields a distinct file
            base, ext = os.path.splitext(ckpt_path)
            if base.endswith(".ckpt"):
                base, ext = base[:-5], ".ckpt" + ext
            conv_ckpt_path = base + "_conv" + ext
            assert conv_ckpt_path != ckpt_path
            ckpt = ckpt_mod.load_rad_checkpoint(ckpt_path)
            if ckpt is not None:
                state0 = ckpt_mod.restore_rad_state(phys_run, arrays_run,
                                                    ckpt, sset_run)
            callbacks.append(ckpt_mod.CheckpointCallback(
                ckpt_path, cfg.checkpoint_every, phys_run))

        chunk = cfg.chunk_iters
        if cfg.checkpoint_every > 0:
            chunk = min(chunk, cfg.checkpoint_every)
        if cfg.realtime_plot:
            chunk = min(chunk, cfg.n_plot)
        if coupl_interval > 0:
            chunk = min(chunk, coupl_interval)
        # round to the 10-iteration cache-refresh cadence so checkpoints
        # land on refresh boundaries and resume is bitwise-exact
        chunk = max(chunk // 10 * 10, 10)
        rad = monitor_mod.run_radiation_chunked(
            phys_run, arrays_run, thermo, T0, chunk_iters=chunk,
            sset=sset_run, callbacks=callbacks, state0=state0,
            profile_dir=cfg.profile_dir or None, mesh=mesh)
    elif mesh is not None:
        from helios_tpu import monitor as monitor_mod
        rad = monitor_mod.run_radiation_chunked(
            phys_run, arrays_run, thermo, T0, chunk_iters=None,
            sset=sset_run, mesh=mesh)
    else:
        rad = radiation_program(phys_run, thermo, sset_run)(arrays_run, T0)

    conv = None
    if phys.convection and not phys.singlewalk and not phys.iso:
        if monitored:
            from helios_tpu import checkpoint as ckpt_mod
            from helios_tpu import monitor as monitor_mod
            conv_callbacks = list(obs_callbacks)
            conv_state0 = None
            if conv_ckpt_path is not None:
                cckpt = ckpt_mod.load_conv_checkpoint(conv_ckpt_path)
                if (cckpt is not None
                        and ckpt_mod.checkpoint_phase(cckpt)
                        == "convection"):
                    conv_state0 = ckpt_mod.restore_conv_state(
                        phys_run, arrays_run, cckpt, sset_run)
                conv_callbacks.append(ckpt_mod.ConvCheckpointCallback(
                    conv_ckpt_path, cfg.checkpoint_every, phys_run))
            conv = monitor_mod.run_convection_chunked(
                phys_run, arrays_run, thermo, rad, chunk_iters=chunk,
                sset=sset_run, callbacks=conv_callbacks,
                state0=conv_state0, mesh=mesh)
        elif mesh is not None:
            from helios_tpu import monitor as monitor_mod
            conv = monitor_mod.run_convection_chunked(
                phys_run, arrays_run, thermo, rad, chunk_iters=None,
                sset=sset_run, mesh=mesh)
        else:
            conv = convection_program(phys_run, thermo, sset_run)(
                arrays_run, rad)
        final_T = conv.T_lay
        flux_state = conv.flux
        F_smooth_sum = conv.F_smooth_sum
        conv_layer = conv.conv_layer
        final_limit = conv.local_limit
    else:
        final_T = rad.T_lay
        flux_state = rad.flux
        F_smooth_sum = rad.F_smooth_sum
        conv_layer = None
        final_limit = rad.local_limit

    # drop padded bins before post-processing (outputs carry only the
    # real spectral grid; padded bins had delta_lambda = 0 anyway)
    if phys_run.nbin != phys.nbin:
        from helios_tpu.parallel import sharding as shd
        flux_state = shd.strip_flux(flux_state, phys.nbin, phys.ny)

    if thermo is not None:
        kappa_lay, c_p_lay = kappa_cp_lay(thermo, final_T, arrays.p_lay)
        T_int = interp_ops.interface_temperatures(final_T)
        from helios_tpu.rce.radiative import kappa_int as kint_fn
        kap_int = kint_fn(thermo, T_int, arrays.p_int)
        conv_unstable = convect.conv_check(final_T, arrays.p_lay,
                                           arrays.p_int, kappa_lay, kap_int)
    else:
        kappa_lay = c_p_lay = conv_unstable = None

    # entropy / water-phase diagnostics from the thermo table
    # (computation.py:252-292, entropy_interpol / phase_number_interpol)
    entropy_lay = phase_number_lay = None
    if thermo is not None and thermo.from_table:
        entropy_lay = interp_ops.interpolate_entropy(
            thermo.entropy_table, thermo.temps, thermo.press,
            final_T[:phys.nlayer], arrays.p_lay)
        if thermo.has_phase:
            phase_number_lay = interp_ops.interpolate_phase_number(
                thermo.phase_table, thermo.temps, thermo.press,
                final_T[:phys.nlayer], arrays.p_lay)

    post = post_process(phys, arrays, final_T, flux_state, F_smooth_sum,
                        sset=sset)

    relaxed = int(float(final_limit) > phys.rad_convergence_limit * 1.5)
    result = collect_result(
        cfg, phys, arrays, final_T, flux_state, post,
        conv_unstable=conv_unstable, conv_layer=conv_layer,
        F_smooth_sum=F_smooth_sum, kappa_lay=kappa_lay, c_p_lay=c_p_lay,
        entropy_lay=entropy_lay, phase_number_lay=phase_number_lay,
        relaxed=relaxed, final_limit=final_limit,
        cloud_result=cloud_result)

    if write_output:
        writers.write_all(result)
        if (rad.aborted if conv is None else conv.aborted):
            writers.write_abort_file(result)

        # coupling: TP write + cross-iteration convergence test
        # (helios.py:129-131)
        if cfg.coupling:
            T_prev = None
            if cfg.coupling_speed_up and cfg.coupling_iter_nr > 0:
                T_prev = _read_coupling_tp(cfg, cfg.coupling_iter_nr - 1)
            result.coupling_speed_up = int(cfg.coupling_speed_up)
            result.coupling_iter_nr = int(cfg.coupling_iter_nr)
            result.coupling_full_output = int(cfg.coupling_full_output)
            writers.write_tp_for_coupling(result, T_previous=T_prev)
            _coupling_convergence(cfg, result)

        # tau_lw / tau_sw estimate for the Koll f approximation
        # (helios.py:133-134)
        if cfg.approx_f:
            tau_lw, tau_sw = hp.calc_tau_lw_sw(
                result.delta_tau_band, result.opac_wave,
                result.opac_deltawave, result.T_lay[phys.nlayer],
                phys.T_star)
            hp.write_tau_lw_sw_file(cfg.output_dir, cfg.name, tau_lw,
                                    tau_sw, phys.f_factor)

    return RunOutput(phys=phys, arrays=arrays, rad=rad, conv=conv,
                     result=result, wall_seconds=time.time() - t0)


def _coupling_tp_path(cfg: HeliosConfig, iter_nr: int) -> str:
    """Path of a coupling TP file (write.py:725-746 naming)."""
    import os
    name = cfg.name
    if cfg.coupling_full_output:
        base = name[:name.rfind("_") + 1]
        name = base + str(iter_nr)
    return os.path.join(cfg.output_dir, name,
                        f"{name}_tp_coupling_{iter_nr}.dat")


def _read_coupling_tp(cfg: HeliosConfig, iter_nr: int) -> np.ndarray:
    T = []
    with open(_coupling_tp_path(cfg, iter_nr)) as f:
        next(f)
        for line in f:
            col = line.split()
            if len(col) > 1:
                T.append(float(col[1]))
    return np.asarray(T)


def _coupling_convergence(cfg: HeliosConfig, result) -> int:
    """Cross-iteration TP convergence (host_functions.py:962-1018)."""
    import os
    converged = 0
    if cfg.coupling_iter_nr > 0 and not cfg.singlewalk:
        prev = _read_coupling_tp(cfg, cfg.coupling_iter_nr - 1)
        cur = _read_coupling_tp(cfg, cfg.coupling_iter_nr)
        rel = np.abs(prev - cur) / cur
        converged = int(np.all(rel < cfg.coupl_convergence_limit))
        with open(os.path.join(
                result.out,
                f"{result.name}_coupling_convergence.dat"), "w") as f:
            f.write(str(converged))
    return converged
