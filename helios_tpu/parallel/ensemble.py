"""Planet-ensemble data parallelism: one command, N atmospheres.

The reference is strictly single-GPU/single-planet -- multi-planet studies
run as N separate processes (SURVEY.md section 2.4).  Here N independent
columns share one compiled RCE program, batched with `vmap` and, with
``n_planet_batch`` > 1, sharded over the mesh's "planet" axis with zero
cross-planet communication.

Ensemble members must share the compile-time physics (`Phys`): same grid
shapes and scalar parameters.  Everything that lives in `ModelArrays` may
vary per planet -- stellar spectrum, surface albedo, cloud decks,
additional heating, opacity table -- as may the initial TP profile.
That covers the production ensemble cases: population studies over
stellar types/albedos, coupling-chemistry grids, retrieval priors.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

import jax
import jax.numpy as jnp

from helios_tpu.forward import ModelArrays, Phys
from helios_tpu.rce.radiative import RadLoopState


def stack_models(models: Sequence[ModelArrays]) -> ModelArrays:
    """Stack N ModelArrays along a new leading planet axis."""
    return jax.tree.map(lambda *xs: jnp.stack(xs), *models)


def _check_same_phys(physes: Sequence[Phys]) -> Phys:
    p0 = physes[0]
    for i, p in enumerate(physes[1:], 1):
        if p != p0:
            diff = [f for f in p0.__dataclass_fields__
                    if getattr(p, f) != getattr(p0, f)]
            raise ValueError(
                "ensemble members must share the compile-time physics; "
                f"config {i} differs from config 0 in {diff}. Per-planet "
                "variation goes through ModelArrays (star, albedo, "
                "clouds, heating, opacity) and the initial TP profile.")
    return p0


def run_ensemble_loops(phys: Phys, models: Sequence[ModelArrays],
                       thermo, T0s, mesh=None, max_steps=None,
                       conv_max_steps=None):
    """Run the radiation (and, when enabled, convection) loops for N
    planets as one batched device program.

    Args:
      models: one ModelArrays per planet (same shapes).
      T0s: [N, L+1] initial profiles.
      mesh: optional ("planet", "spectral") Mesh; the batch is then
        sharded over the planet axis (and spectral arrays over the
        spectral axis) via shard_map -- pure data parallelism, no
        cross-planet collectives.

    Returns (rad_states, conv_states_or_None), both with a leading
    planet axis.
    """
    from helios_tpu.rce.loop import convection_loop
    from helios_tpu.rce.radiative import radiation_loop

    m_stacked = stack_models(models)
    T0s = jnp.asarray(T0s)
    n = T0s.shape[0]
    want_conv = (phys.convection and not phys.singlewalk and not phys.iso)

    if mesh is None:
        rad_fn = jax.jit(jax.vmap(
            lambda m, t: radiation_loop(phys, m, thermo, t,
                                        max_steps=max_steps)))
        rad = rad_fn(m_stacked, T0s)
        conv = None
        if want_conv:
            conv_fn = jax.jit(jax.vmap(
                lambda m, r: convection_loop(phys, m, thermo, r,
                                             max_steps=conv_max_steps)))
            conv = conv_fn(m_stacked, rad)
        return rad, conv

    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from helios_tpu.parallel import sharding as shd

    assert n % mesh.shape["planet"] == 0, (
        f"{n} planets not divisible by planet axis "
        f"{mesh.shape['planet']}")
    phys_l = shd._phys_local(phys, mesh)

    # every stacked leaf: planet axis first, then its spectral spec
    m_specs = ModelArrays(**{
        k: P("planet", *v) for k, v in shd._MODEL_SPECS.items()})
    t_spec = P("planet", None)
    rad_specs = shd._rad_state_specs(phys, planet=True)

    m_placed = jax.device_put(
        m_stacked, jax.tree.map(
            lambda s: jax.sharding.NamedSharding(mesh, s), m_specs))

    def rad_body(m, t):
        return jax.vmap(lambda mi, ti: radiation_loop(
            phys_l, mi, thermo, ti, max_steps=max_steps,
            axis_name=shd.AXIS))(m, t)

    rad = jax.jit(shard_map(rad_body, mesh=mesh,
                            in_specs=(m_specs, t_spec),
                            out_specs=rad_specs,
                            check_vma=False))(m_placed, T0s)
    conv = None
    if want_conv:
        conv_specs = shd._conv_state_specs(phys, planet=True)

        def conv_body(m, r):
            return jax.vmap(lambda mi, ri: convection_loop(
                phys_l, mi, thermo, ri, max_steps=conv_max_steps,
                axis_name=shd.AXIS))(m, r)

        conv = jax.jit(shard_map(conv_body, mesh=mesh,
                                 in_specs=(m_specs, rad_specs),
                                 out_specs=conv_specs,
                                 check_vma=False))(m_placed, rad)
    return rad, conv


# --------------------------------------------------------------------------- #
# chunked batched loops (monitoring + checkpointing for the ensemble)
# --------------------------------------------------------------------------- #

def _batched_runners(phys: Phys, thermo, sset, mesh, chunk):
    """Jitted batched (init, rad_step, conv_enter, conv_step), each
    called as fn(m_stacked, sarr, state) where ``sarr`` is
    sharding.sset_arrays(sset) (() when sset is None).  ``chunk`` caps
    iterations per call (None = run to convergence).

    Under a mesh the species arrays are THREADED through shard_map with
    their spectral PartitionSpecs (same mechanism as
    sharding.production_runners) -- closing over a spectrally sharded
    sset would hand the shard-local body global-bin tables."""
    import dataclasses

    from helios_tpu.rce.loop import convection_loop
    from helios_tpu.rce.radiative import init_rad_state, radiation_loop

    if mesh is None:
        # unsharded: the (global) species tables are safe to close over;
        # sarr is accepted and ignored for a uniform call signature
        init_v = jax.jit(jax.vmap(
            lambda m, t: init_rad_state(phys, m, t, sset)))
        rad_step_v = jax.jit(jax.vmap(lambda m, s: radiation_loop(
            phys, m, thermo, s.T_lay, max_steps=chunk, sset=sset,
            state0=s)))
        conv_enter_v = jax.jit(jax.vmap(lambda m, r: convection_loop(
            phys, m, thermo, r, max_steps=0, sset=sset)))
        conv_step_v = jax.jit(jax.vmap(lambda m, s: convection_loop(
            phys, m, thermo, None, max_steps=chunk, sset=sset,
            state0=s)))
        return (lambda m, sarr, t: init_v(m, t),
                lambda m, sarr, s: rad_step_v(m, s),
                lambda m, sarr, r: conv_enter_v(m, r),
                lambda m, sarr, s: conv_step_v(m, s))

    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from helios_tpu.parallel import sharding as shd

    phys_l = shd._phys_local(phys, mesh)
    m_specs = ModelArrays(**{
        k: P("planet", *v) for k, v in shd._MODEL_SPECS.items()})
    t_spec = P("planet", None)
    rad_specs = shd._rad_state_specs(phys, planet=True)
    conv_specs = shd._conv_state_specs(phys, planet=True)
    s_specs = shd._sset_specs(sset) if sset is not None else ()

    def local_sset(sarr):
        if sset is None:
            return None
        data, kt, kp = sarr
        return dataclasses.replace(sset, data=list(data), ktemps=kt,
                                   kpress=kp)

    def _shm(body, in_specs, out_specs):
        return jax.jit(shard_map(body, mesh=mesh, in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False))

    init = _shm(
        lambda m, sarr, t: jax.vmap(lambda mi, ti: init_rad_state(
            phys_l, mi, ti, local_sset(sarr), axis_name=shd.AXIS))(m, t),
        (m_specs, s_specs, t_spec), rad_specs)
    rad_step = _shm(
        lambda m, sarr, s: jax.vmap(lambda mi, si: radiation_loop(
            phys_l, mi, thermo, si.T_lay, max_steps=chunk,
            sset=local_sset(sarr), state0=si,
            axis_name=shd.AXIS))(m, s),
        (m_specs, s_specs, rad_specs), rad_specs)
    conv_enter = _shm(
        lambda m, sarr, r: jax.vmap(lambda mi, ri: convection_loop(
            phys_l, mi, thermo, ri, max_steps=0,
            sset=local_sset(sarr), axis_name=shd.AXIS))(m, r),
        (m_specs, s_specs, rad_specs), conv_specs)
    conv_step = _shm(
        lambda m, sarr, s: jax.vmap(lambda mi, si: convection_loop(
            phys_l, mi, thermo, None, max_steps=chunk,
            sset=local_sset(sarr), state0=si,
            axis_name=shd.AXIS))(m, s),
        (m_specs, s_specs, conv_specs), conv_specs)
    return init, rad_step, conv_enter, conv_step


def _restore_batched_rad(phys_run, init, m_stacked, sarr, ckpt):
    """Batched analogue of checkpoint.restore_rad_state.

    ``phys_run`` is the (possibly spectrally padded) physics the loop
    actually runs with -- the fingerprint must guard the SAVED shapes,
    so save and restore both use phys_run, like pipeline.run."""
    from helios_tpu import checkpoint as ckpt_mod
    from helios_tpu.forward import FluxState, integrate_flux_flat

    ckpt_mod._check_fingerprint(phys_run, ckpt)
    T = jnp.asarray(ckpt["T_lay"])                 # [N, L+1]
    fresh = init(m_stacked, sarr, T)
    flux = FluxState(**{f: jnp.asarray(ckpt["flux__" + f])
                        for f in FluxState._fields})
    totals = jax.vmap(lambda m, fl, fd: integrate_flux_flat(
        phys_run, m, fl, fd))(m_stacked, flux, fresh.cache.F_dir)
    return fresh._replace(
        flux=flux, totals=totals,
        **{f: jnp.asarray(ckpt[f]) for f in ckpt_mod._STATE_FIELDS})


def _restore_batched_conv(phys_run, m_stacked, sset, ckpt):
    """Batched analogue of checkpoint.restore_conv_state: the bulk cell
    cache is recomputed from the restored temperatures; the stale fields
    the convection body reads before the 10-step refresh (totals,
    meanmolmass, cumulative additional heating) come from the payload."""
    from helios_tpu import checkpoint as ckpt_mod
    from helios_tpu.forward import FluxState, compute_cells
    from helios_tpu.ops import interp as interp_ops
    from helios_tpu.ops.integrate import FluxTotals
    from helios_tpu.rce.loop import ConvLoopState

    ckpt_mod._check_fingerprint(phys_run, ckpt)
    T_lay = jnp.asarray(ckpt["T_lay"])             # [N, L+1]

    def mk_cache(m, t):
        return compute_cells(phys_run, m, t,
                             interp_ops.interface_temperatures(t), sset)

    cache = jax.jit(jax.vmap(mk_cache))(m_stacked, T_lay)
    cache = cache._replace(
        meanmolmass_lay=jnp.asarray(ckpt["cache__meanmolmass_lay"]),
        F_add_heat_sum=jnp.asarray(ckpt["cache__F_add_heat_sum"]))
    flux = FluxState(**{f: jnp.asarray(ckpt["flux__" + f])
                        for f in FluxState._fields})
    totals = FluxTotals(**{f: jnp.asarray(ckpt["totals__" + f])
                           for f in FluxTotals._fields})
    return ConvLoopState(
        cache=cache, flux=flux, totals=totals,
        **{f: jnp.asarray(ckpt[f]) for f in ckpt_mod._CONV_FIELDS})


def _ensemble_progress(phase, state, names, wall_s, stream=None):
    import sys
    stream = stream or sys.stdout
    its = np.asarray(state.it).astype(int)
    running = np.asarray(state.keep_running).astype(bool)
    n_done = int((~running).sum())
    stream.write(f"[ensemble/{phase}] iters={its.min()}..{its.max()}  "
                 f"converged {n_done}/{len(names)} planets  "
                 f"({wall_s:.1f} s/chunk)\n")
    stream.flush()


def run_ensemble(cfgs: Sequence, tables: Optional[Sequence] = None,
                 write_output: bool = True, sset=None):
    """pipeline.run for N planets in ONE batched device program.

    Each config gets its own output directory / writers; the RCE loops
    run vmapped (and mesh-sharded when cfg.n_planet_batch > 1 and enough
    devices are visible).  Per-planet variation goes through ModelArrays
    (star, albedo, clouds, heating, opacity table) and the initial TP
    profile; compile-time physics (Phys) must match across members.

    Config 0 drives the shared machinery: thermodynamics source
    (constant kappa or the file/water_atmo table modes), on-the-fly
    species set, chunking/progress/checkpoint knobs.  Returns a list of
    RunOutput.
    """
    import time

    from helios_tpu import pipeline as pl
    from helios_tpu.io.opacity import load_opacity_file
    from helios_tpu.ops import interp as interp_ops
    from helios_tpu.rce import convect
    from helios_tpu.rce.radiative import kappa_cp_lay, kappa_int

    t0 = time.time()
    cfgs = [c if c._finalized else c.finalize() for c in cfgs]
    cfg0 = cfgs[0]

    if (sset is None and cfg0.opacity_mixing == "on-the-fly"
            and tables is None):
        sset, donor = pl.build_species_set_from_files(cfg0)
        tables = [donor] * len(cfgs)
    if tables is None:
        cache = {}
        tables = []
        for c in cfgs:
            if c.opacity_path not in cache:
                cache[c.opacity_path] = load_opacity_file(c.opacity_path)
            tables.append(cache[c.opacity_path])

    physes, models, T0s, cloud_results = [], [], [], []
    for cfg, table in zip(cfgs, tables):
        phys, arrays, clouds_i = pl.prepare_model(cfg, table)
        physes.append(phys)
        models.append(arrays)
        cloud_results.append(clouds_i)
        T0s.append(pl.initial_temperatures(cfg, phys, arrays))
    phys = _check_same_phys(physes)

    thermo = pl.make_thermo(cfg0)

    mesh = None
    n_pl = int(cfg0.n_planet_batch)
    if n_pl > 1:
        from helios_tpu.parallel import sharding as shd
        n_spec = max(int(cfg0.n_spectral_shards), 1)
        need = n_pl * n_spec
        devs = jax.devices()
        if len(devs) < need:
            raise RuntimeError(
                f"n_planet_batch={n_pl} x n_spectral_shards={n_spec} needs "
                f"{need} devices but only {len(devs)} are visible")
        mesh = shd.make_mesh(n_planet=n_pl, n_spectral=n_spec,
                             devices=devs[:need])

    want_conv = (phys.convection and not phys.singlewalk and not phys.iso)
    progress = bool(cfg0.progress)
    ckpt_path = None
    if cfg0.checkpoint_every > 0:
        import os
        # one checkpoint for the whole batch, under the first member's
        # output directory (unless -checkpoint_path overrides)
        ckpt_path = cfg0.checkpoint_path or os.path.join(
            cfg0.output_dir, cfg0.name, "ensemble.ckpt.npz")
    monitored = progress or ckpt_path is not None
    chunk = None
    if monitored and not phys.singlewalk:
        chunk = cfg0.chunk_iters
        if cfg0.checkpoint_every > 0:
            chunk = min(chunk, cfg0.checkpoint_every)
        chunk = max(chunk // 10 * 10, 10)   # cache-refresh cadence

    # spectral padding: the loop runs on a padded copy when the bin
    # count does not divide the spectral axis (sharding.pad_spectral);
    # post-processing keeps the original models
    phys_run, models_run, sset_run = phys, models, sset
    if mesh is not None and mesh.shape["spectral"] > 1:
        from helios_tpu.parallel import sharding as shd
        n_spec = mesh.shape["spectral"]
        if phys.nbin % n_spec != 0:
            padded = [shd.pad_spectral(phys, m, n_spec) for m in models]
            phys_run = padded[0][0]
            models_run = [m for _, m in padded]
            if sset is not None:
                sset_run = shd.pad_species(sset, n_spec)

    m_stacked = stack_models(models_run)
    T0b = jnp.asarray(np.stack(T0s))
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        from helios_tpu.parallel import sharding as shd
        m_specs = ModelArrays(**{
            k: P("planet", *v) for k, v in shd._MODEL_SPECS.items()})
        m_stacked = jax.device_put(m_stacked, jax.tree.map(
            lambda s: NamedSharding(mesh, s), m_specs))
        if sset_run is not None:
            sset_run = shd.place_species(sset_run, mesh)

    init, rad_step, conv_enter, conv_step = _batched_runners(
        phys_run, thermo, sset_run, mesh, chunk)
    if mesh is not None:
        sarr = shd.sset_arrays(sset_run)
    else:
        sarr = ()

    from helios_tpu import checkpoint as ckpt_mod
    names = [c.name for c in cfgs]
    conv_ckpt_path = None
    if ckpt_path is not None:
        import os
        base, ext = os.path.splitext(ckpt_path)
        if base.endswith(".ckpt"):
            base, ext = base[:-5], ".ckpt" + ext
        conv_ckpt_path = base + "_conv" + ext

    rads = None
    conv_resume = None
    if ckpt_path is not None and chunk is not None:
        if want_conv and conv_ckpt_path is not None:
            cck = ckpt_mod.load_conv_checkpoint(conv_ckpt_path)
            if (cck is not None
                    and ckpt_mod.checkpoint_phase(cck) == "convection"):
                conv_resume = _restore_batched_conv(
                    phys_run, m_stacked, sset_run, cck)
        if conv_resume is None:
            ck = ckpt_mod.load_rad_checkpoint(ckpt_path)
            if (ck is not None
                    and ckpt_mod.checkpoint_phase(ck) == "radiation"):
                rads = _restore_batched_rad(phys_run, init, m_stacked,
                                            sarr, ck)
    if rads is None and conv_resume is None:
        rads = init(m_stacked, sarr, T0b)

    if chunk is None:
        # unmonitored: rad_step/conv_step were built uncapped
        rads = rad_step(m_stacked, sarr, rads)
        convs = None
        if want_conv:
            convs = conv_enter(m_stacked, sarr, rads)
            convs = conv_step(m_stacked, sarr, convs)
    else:
        if conv_resume is None:
            while bool(np.asarray(rads.keep_running).any()):
                tc = time.time()
                rads = rad_step(m_stacked, sarr, rads)
                jax.block_until_ready(rads.T_lay)
                if progress:
                    _ensemble_progress("radiation", rads, names,
                                       time.time() - tc)
                if ckpt_path is not None:
                    ckpt_mod.save_rad_checkpoint(ckpt_path, rads,
                                                 phys_run)
        convs = None
        if want_conv:
            if conv_resume is not None:
                convs = conv_resume
                ck = ckpt_mod.load_rad_checkpoint(ckpt_path)
                rads = (_restore_batched_rad(phys_run, init, m_stacked,
                                             sarr, ck)
                        if ck is not None else init(m_stacked, sarr, T0b))
            else:
                convs = conv_enter(m_stacked, sarr, rads)
            while bool(np.asarray(convs.keep_running).any()):
                tc = time.time()
                convs = conv_step(m_stacked, sarr, convs)
                jax.block_until_ready(convs.T_lay)
                if progress:
                    _ensemble_progress("convection", convs, names,
                                       time.time() - tc)
                if conv_ckpt_path is not None:
                    ckpt_mod.save_conv_checkpoint(conv_ckpt_path, convs,
                                                  phys_run)

    outs = []
    for i, (cfg, arrays) in enumerate(zip(cfgs, models)):
        rad_i = jax.tree.map(lambda x: x[i], rads)
        conv_i = (jax.tree.map(lambda x: x[i], convs)
                  if convs is not None else None)
        if conv_i is not None:
            final_T, flux, F_smooth_sum = (conv_i.T_lay, conv_i.flux,
                                           conv_i.F_smooth_sum)
            conv_layer, final_limit = conv_i.conv_layer, conv_i.local_limit
        else:
            final_T, flux, F_smooth_sum = (rad_i.T_lay, rad_i.flux,
                                           rad_i.F_smooth_sum)
            conv_layer, final_limit = None, rad_i.local_limit

        if phys_run.nbin != phys.nbin:
            from helios_tpu.parallel import sharding as shd
            flux = shd.strip_flux(flux, phys.nbin, phys.ny)

        if thermo is not None:
            kappa_lay, c_p_lay = kappa_cp_lay(thermo, final_T,
                                              arrays.p_lay)
            T_int = interp_ops.interface_temperatures(final_T)
            kap_int = kappa_int(thermo, T_int, arrays.p_int)
            conv_unstable = convect.conv_check(
                final_T, arrays.p_lay, arrays.p_int, kappa_lay, kap_int)
        else:
            kappa_lay = c_p_lay = conv_unstable = None

        # entropy / water-phase diagnostics (computation.py:252-292)
        entropy_lay = phase_number_lay = None
        if thermo is not None and thermo.from_table:
            entropy_lay = interp_ops.interpolate_entropy(
                thermo.entropy_table, thermo.temps, thermo.press,
                final_T[:phys.nlayer], arrays.p_lay)
            if thermo.has_phase:
                phase_number_lay = interp_ops.interpolate_phase_number(
                    thermo.phase_table, thermo.temps, thermo.press,
                    final_T[:phys.nlayer], arrays.p_lay)

        post = pl.post_process(phys, arrays, final_T, flux, F_smooth_sum,
                               sset=sset)
        # mirror pipeline.run's end-of-run bookkeeping so a batch member
        # writes exactly the file set a solo run writes (write.py:63-95
        # abort/warning, write.py:434-530 cloud decks)
        relaxed = int(float(final_limit) > phys.rad_convergence_limit * 1.5)
        result = pl.collect_result(
            cfg, phys, arrays, final_T, flux, post,
            conv_unstable=conv_unstable, conv_layer=conv_layer,
            F_smooth_sum=F_smooth_sum, kappa_lay=kappa_lay,
            c_p_lay=c_p_lay, entropy_lay=entropy_lay,
            phase_number_lay=phase_number_lay, relaxed=relaxed,
            final_limit=final_limit, cloud_result=cloud_results[i])
        if write_output:
            from helios_tpu.io import writers
            writers.write_all(result)
            aborted_i = (rad_i.aborted if conv_i is None
                         else conv_i.aborted)
            if bool(aborted_i):
                writers.write_abort_file(result)
        outs.append(pl.RunOutput(phys=phys, arrays=arrays, rad=rad_i,
                                 conv=conv_i, result=result,
                                 wall_seconds=time.time() - t0))
    return outs


# --------------------------------------------------------------------------- #
# planet-ensemble file: the CLI product surface
# --------------------------------------------------------------------------- #

def parse_ensemble_file(path: str):
    """Parse a planet-ensemble override file.

    Format: '#' comments; the first non-comment line names HeliosConfig
    fields (whitespace-separated, e.g. ``name T_star R_star a g``); each
    following line is one planet's values.  Values keep their string
    form -- HeliosConfig.finalize coerces/validates exactly as it does
    for param.dat entries.  Returns a list of {field: value} dicts.
    """
    rows, header = [], None
    with open(path) as f:
        for ln in f:
            ln = ln.split("#", 1)[0].strip()
            if not ln:
                continue
            cols = ln.split()
            if header is None:
                header = cols
                continue
            if len(cols) != len(header):
                raise ValueError(
                    f"{path}: row {ln!r} has {len(cols)} values, header "
                    f"names {len(header)} fields")
            rows.append(dict(zip(header, cols)))
    if header is None:
        raise ValueError(f"{path}: empty ensemble file")
    if not rows:
        raise ValueError(
            f"{path}: ensemble file names fields {header} but contains "
            "no planet rows")
    from helios_tpu.config import HeliosConfig
    bad = [h for h in header
           if h not in HeliosConfig.__dataclass_fields__]
    if bad:
        raise ValueError(f"{path}: unknown config fields {bad}")
    return rows


def _coerce_like(cur, v: str):
    if isinstance(cur, bool):
        return v.lower() in ("1", "yes", "true", "on")
    if isinstance(cur, int) and not isinstance(cur, bool):
        try:
            return int(v)
        except ValueError:
            return v
    if isinstance(cur, float):
        try:
            return float(v)
        except ValueError:
            return v
    return v


def configs_from_ensemble(base_cfg, rows):
    """One un-finalized HeliosConfig per planet: a copy of ``base_cfg``
    with the row's overrides applied (then finalized)."""
    import copy

    cfgs = []
    for i, row in enumerate(rows):
        c = copy.deepcopy(base_cfg)
        c._finalized = False
        for field, v in row.items():
            setattr(c, field, _coerce_like(getattr(c, field), v))
        if "name" not in row:
            c.name = f"{base_cfg.name}_{i}"
        cfgs.append(c.finalize())
    names = [c.name for c in cfgs]
    if len(set(names)) != len(names):
        raise ValueError(f"ensemble planet names must be unique: {names}")
    return cfgs
