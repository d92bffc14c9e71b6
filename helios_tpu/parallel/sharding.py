"""Multi-device sharding: planet-ensemble data parallelism x spectral sharding.

The reference is strictly single-GPU (SURVEY.md section 2.4); this module
spreads one run, or a batch of runs, over several cards of a host:

* **spectral axis**: the wavelength-bin axis of every [.., bin, y] array is
  sharded across devices.  All per-cell physics (opacity interp,
  transmission, the layer-sequential sweeps) is embarrassingly parallel
  across bins, so the only communication is the band->total flux reduction
  in `integrate_flux` (a `psum`) and the scalar convergence predicates.
* **planet axis**: independent atmospheres batched with `vmap`; no
  communication at all.

Two mechanisms:
* `sharded_forward` uses `NamedSharding` + `jit` (GSPMD auto
  partitioning) -- fine for the pure-XLA scan path.
* The RCE loop entry points (`sharded_radiation_loop`,
  `batched_rce_step`) use **shard_map**: the fused sweep kernels are
  custom calls GSPMD cannot partition, so each device explicitly runs
  the loop on its local wavelength shard.  The band->total `psum` inside
  `integrate_flux_flat` is the single per-iteration collective and makes
  all convergence predicates replica-identical, so devices iterate in
  lockstep.  The layer recursion needs no communication at all (bins are
  independent).
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from helios_tpu.forward import (FluxState, ModelArrays, Phys, forward_fluxes,
                                init_flux_state)
from helios_tpu.rce.radiative import ThermoProps


def make_mesh(n_planet: int = 1, n_spectral: Optional[int] = None,
              devices=None) -> Mesh:
    """Device mesh with ("planet", "spectral") axes.

    The cards of a host are joined all to all, so the mesh is a plain
    reshape of the device list: the layout follows the algorithm alone.
    """
    devices = devices if devices is not None else jax.devices()
    if n_spectral is None:
        n_spectral = len(devices) // n_planet
    assert n_planet * n_spectral == len(devices), (
        f"{n_planet} x {n_spectral} != {len(devices)} devices")
    dev_array = np.asarray(devices).reshape(n_planet, n_spectral)
    return Mesh(dev_array, ("planet", "spectral"))


# PartitionSpecs for ModelArrays fields: shard every wavelength-bin axis
# over "spectral", replicate the rest.
_MODEL_SPECS = dict(
    p_lay=P(), p_int=P(), delta_colmass=P(), delta_col_upper=P(),
    delta_col_lower=P(),
    # ktable is [ntemp, npress, S] with S = nbin*ny bin-major, so sharding
    # S over "spectral" is contiguous-wavelength-band sharding
    ktable=P(None, None, "spectral"),
    scat_cross_table=P(None, None, "spectral"),
    meanmolmass_table=P(), ktemps=P(), kpress=P(),
    lambda_centers=P("spectral"), lambda_edges=P(),
    delta_lambda=P("spectral"),
    gauss_y=P(), gauss_weight=P(),
    planck_grid=P(None, "spectral"),
    starflux=P("spectral"), surf_albedo=P("spectral"),
    cloud_abs_cross_lay=P(None, "spectral"),
    cloud_scat_cross_lay=P(None, "spectral"),
    g_0_cloud_lay=P(None, "spectral"),
    cloud_abs_cross_int=P(None, "spectral"),
    cloud_scat_cross_int=P(None, "spectral"),
    g_0_cloud_int=P(None, "spectral"),
    add_heat_dens=P(),
    star_corr_factor=P(),
)


def model_shardings(mesh: Mesh) -> ModelArrays:
    """NamedShardings (as a ModelArrays-shaped pytree) for the inputs."""
    return ModelArrays(**{k: NamedSharding(mesh, v)
                          for k, v in _MODEL_SPECS.items()})


def flux_shardings(mesh: Mesh, batched: bool = False) -> FluxState:
    lead = ("planet",) if batched else ()
    s = NamedSharding(mesh, P(*lead, None, "spectral", None))
    return FluxState(F_down=s, F_up=s, Fc_down=s, Fc_up=s)


def place_model(m: ModelArrays, mesh: Mesh) -> ModelArrays:
    """device_put every model array with its spectral sharding."""
    sh = model_shardings(mesh)
    return ModelArrays(*(jax.device_put(a, s) for a, s in zip(m, sh)))


# --------------------------------------------------------------------------- #
# spectral padding: run ANY bin count on ANY shard count
# --------------------------------------------------------------------------- #
# The reference workload is 385 bins (R=50 table, SURVEY.md section 0) =
# 5*7*11 -- indivisible by 2/4/8 chips.  Padding the bin axis up to a
# shard multiple with zero `delta_lambda` makes sharding bin-count
# agnostic: padded bins replicate the LAST real bin, so every per-cell
# quantity stays finite and physical, while the band->total integrals
# weight them by delta_lambda = 0 -- adding exact float zeros to the
# per-shard partial sums.  The temperature trajectory and all
# convergence predicates are therefore unchanged.

def padded_nbin(nbin: int, n_shards: int) -> int:
    return -(-nbin // n_shards) * n_shards


def _edge_pad(a, axis: int, n: int):
    """Pad axis by n entries replicating the last slice."""
    if n == 0:
        return a
    pad = [(0, 0)] * a.ndim
    pad[axis] = (0, n)
    return jnp.pad(a, pad, mode="edge")


def pad_spectral(phys: Phys, m: ModelArrays,
                 n_shards: int) -> Tuple[Phys, ModelArrays]:
    """Pad the wavelength-bin axis of (Phys, ModelArrays) to a multiple
    of ``n_shards``.  Identity when already divisible."""
    import dataclasses

    B, Y = phys.nbin, phys.ny
    Bp = padded_nbin(B, n_shards)
    nb = Bp - B
    if nb == 0:
        return phys, m

    def pad_S(a):  # [.., S] bin-major flat spectral axis
        lead = a.shape[:-1]
        cube = a.reshape(lead + (B, Y))
        return _edge_pad(cube, len(lead), nb).reshape(lead + (Bp * Y,))

    zeros_dl = jnp.zeros((nb,), m.delta_lambda.dtype)
    m = m._replace(
        ktable=pad_S(m.ktable),
        scat_cross_table=_edge_pad(m.scat_cross_table, 2, nb),
        lambda_centers=_edge_pad(m.lambda_centers, 0, nb),
        lambda_edges=_edge_pad(m.lambda_edges, 0, nb),
        delta_lambda=jnp.concatenate([m.delta_lambda, zeros_dl]),
        planck_grid=_edge_pad(m.planck_grid, 1, nb),
        starflux=_edge_pad(m.starflux, 0, nb),
        surf_albedo=_edge_pad(m.surf_albedo, 0, nb),
        cloud_abs_cross_lay=_edge_pad(m.cloud_abs_cross_lay, 1, nb),
        cloud_scat_cross_lay=_edge_pad(m.cloud_scat_cross_lay, 1, nb),
        g_0_cloud_lay=_edge_pad(m.g_0_cloud_lay, 1, nb),
        cloud_abs_cross_int=_edge_pad(m.cloud_abs_cross_int, 1, nb),
        cloud_scat_cross_int=_edge_pad(m.cloud_scat_cross_int, 1, nb),
        g_0_cloud_int=_edge_pad(m.g_0_cloud_int, 1, nb))
    return dataclasses.replace(phys, nbin=Bp), m


def pad_species(sset, n_shards: int):
    """Pad every per-species wavelength-bin axis like pad_spectral."""
    import dataclasses

    B = sset.data[0].opacity_pretab.shape[2]
    nb = padded_nbin(B, n_shards) - B
    if nb == 0:
        return sset
    data = [d._replace(opacity_pretab=_edge_pad(d.opacity_pretab, 2, nb),
                       scat_cross=_edge_pad(d.scat_cross, 0, nb))
            for d in sset.data]
    return dataclasses.replace(sset, data=data)


def strip_flux(flux: FluxState, nbin: int, ny: int) -> FluxState:
    """Drop padded bins from a FluxState ([.., S_pad] -> [.., nbin*ny])."""
    S = flux.F_down.shape[-1]
    if S == nbin * ny:
        return flux

    def strip(a):
        lead = a.shape[:-1]
        cube = a.reshape(lead + (S // ny, ny))
        return cube[..., :nbin, :].reshape(lead + (nbin * ny,))

    return jax.tree.map(strip, flux)


def sharded_forward(phys: Phys, mesh: Mesh):
    """jit-compiled sharded forward step: T_lay [L+1] -> FluxTotals.

    Totals come out replicated (XLA all-reduces the band integrals over the
    spectral axis).
    """
    t_sh = NamedSharding(mesh, P())

    @partial(jax.jit,
             in_shardings=(model_shardings(mesh), t_sh),
             out_shardings=None)
    def fwd(m, T_lay):
        _flux, totals, _cache = forward_fluxes(phys, m, T_lay)
        return totals

    return fwd


AXIS = "spectral"


def _spec(*dims, planet: bool = False):
    return P(*((("planet",) if planet else ()) + dims))


def _coeff_specs(phys: Phys, planet: bool = False):
    """PartitionSpec pytree for CellCache.coeff (Iso/NonIsoCoeffCache):
    [L, S] members shard the spectral axis, [S] boundary rows too."""
    from helios_tpu import fastpath as fpath

    sp = _spec(None, AXIS, planet=planet)
    row = _spec(AXIS, planet=planet)
    if phys.iso:
        return fpath.IsoCoeffCache(
            a=sp, b_nm=sp, planck_coeff=sp, dir_down=sp, dir_up=sp,
            boa_coeff=row, boa_refl=row, toa=row)
    lay_fields = {f: sp for f in fpath.NonIsoCoeffCache._fields
                  if f not in ("boa_coeff", "boa_refl", "toa")}
    return fpath.NonIsoCoeffCache(boa_coeff=row, boa_refl=row, toa=row,
                                  **lay_fields)


def _rad_state_specs(phys: Phys, planet: bool = False):
    """PartitionSpec pytree mirroring RadLoopState for shard_map.

    Spectral ([.., S] or [.., B]) leaves shard their last axis; layer
    vectors and scalars are replicated (optionally with a leading planet
    axis).  Keep in sync with FlatCells / CellCache / FluxState /
    FluxTotals / RadLoopState field lists.
    """
    from helios_tpu import fastpath as fpath
    from helios_tpu.forward import CellCache, FluxState
    from helios_tpu.ops.integrate import FluxTotals
    from helios_tpu.rce.radiative import RadLoopState

    sp = _spec(None, AXIS, planet=planet)     # [.., L/I, S]
    rep1 = _spec(None, planet=planet)         # [.., L/I]
    rep0 = _spec(planet=planet)               # scalars
    cells = fpath.FlatCells(*([sp] * len(fpath.FlatCells._fields)))
    cache = CellCache(
        cells_or_upper=cells, lower=cells,
        scat_trigger=_spec(AXIS, planet=planet),
        F_dir=sp, Fc_dir=sp, meanmolmass_lay=rep1, z_lay=rep1,
        opac_lay=sp, scat_cross_lay=sp,
        F_add_heat_lay=rep1, F_add_heat_sum=rep1,
        coeff=_coeff_specs(phys, planet=planet))
    flux = FluxState(F_down=sp, F_up=sp, Fc_down=sp, Fc_up=sp)
    totals = FluxTotals(F_down_band=sp, F_up_band=sp, F_dir_band=sp,
                        F_down_tot=rep1, F_up_tot=rep1, F_net=rep1)
    return RadLoopState(
        T_lay=rep1, flux=flux, cache=cache, totals=totals, T_store=rep1,
        prefactor=rep1, F_smooth_sum=rep1, abort=rep1, it=rep0,
        local_limit=rep0, keep_running=rep0, goto_convection=rep0,
        aborted=rep0)


def _phys_local(phys: Phys, mesh: Mesh) -> Phys:
    """Phys with the per-chip wavelength-bin count (inside shard_map every
    spectral array holds only this chip's shard)."""
    import dataclasses
    n = mesh.shape[AXIS]
    assert phys.nbin % n == 0, (
        f"nbin {phys.nbin} not divisible by spectral axis {n}")
    return dataclasses.replace(phys, nbin=phys.nbin // n)


def sharded_radiation_loop(phys: Phys, mesh: Mesh,
                           thermo: Optional[ThermoProps],
                           max_steps: Optional[int] = None):
    """The full RCE radiation loop under shard_map: each chip runs the
    while_loop on its wavelength shard; the band->total psum keeps every
    convergence predicate replica-identical, so all chips iterate in
    lockstep with ONE collective per iteration over the spectral axis.

    shard_map (not GSPMD auto-sharding) is required here: the fused
    Pallas sweep kernels are custom calls the partitioner cannot split,
    so each chip must invoke them on its local shard explicitly.

    Returns jitted ``run(m_sharded, T0_batch) -> RadLoopState`` where
    T0_batch is [n_planet_local_total, L+1] sharded over the planet axis
    (use n_planet = mesh planet size for one planet per planet-group).
    """
    from jax import shard_map

    from helios_tpu.rce.radiative import radiation_loop

    phys_l = _phys_local(phys, mesh)
    m_specs = ModelArrays(**_MODEL_SPECS)

    def body(m_local, T0_local):
        run_one = lambda t: radiation_loop(
            phys_l, m_local, thermo, t, max_steps=max_steps,
            axis_name=AXIS)
        return jax.vmap(run_one)(T0_local)

    shm = shard_map(body, mesh=mesh,
                    in_specs=(m_specs, _spec(None, planet=True)),
                    out_specs=_rad_state_specs(phys, planet=True),
                    check_vma=False)
    return jax.jit(shm)


def batched_rce_step(phys: Phys, mesh: Mesh, thermo: Optional[ThermoProps]):
    """The full per-iteration RCE "training step", batched over a planet
    ensemble and sharded over the spectral axis via shard_map.

    Step = flux solve + integration + radiative temperature update
    (the body of the radiation loop).  Input/output state is a
    RadLoopState pytree with a leading planet-batch axis.
    """
    from jax import shard_map

    from helios_tpu.rce.radiative import (_one_radiation_iteration,
                                          init_rad_state)

    phys_l = _phys_local(phys, mesh)
    m_specs = ModelArrays(**_MODEL_SPECS)
    state_specs = _rad_state_specs(phys, planet=True)

    def step_body(m_local, state_local):
        one = lambda s: _one_radiation_iteration(phys_l, m_local, thermo,
                                                 s, axis_name=AXIS)
        return jax.vmap(one)(state_local)

    def init_body(m_local, T0_local):
        one = lambda t: init_rad_state(phys_l, m_local, t, axis_name=AXIS)
        return jax.vmap(one)(T0_local)

    step = jax.jit(shard_map(
        step_body, mesh=mesh, in_specs=(m_specs, state_specs),
        out_specs=state_specs, check_vma=False))
    init = jax.jit(shard_map(
        init_body, mesh=mesh,
        in_specs=(m_specs, _spec(None, planet=True)),
        out_specs=state_specs, check_vma=False))
    return init, step


# --------------------------------------------------------------------------- #
# production pipeline path: single-planet spectral sharding, full RCE
# --------------------------------------------------------------------------- #

def _conv_state_specs(phys: Phys, planet: bool = False):
    """PartitionSpec pytree mirroring ConvLoopState for shard_map."""
    from helios_tpu import fastpath as fpath
    from helios_tpu.forward import CellCache, FluxState
    from helios_tpu.ops.integrate import FluxTotals
    from helios_tpu.rce.loop import ConvLoopState

    sp = _spec(None, AXIS, planet=planet)
    rep1 = _spec(None, planet=planet)
    rep0 = _spec(planet=planet)
    cells = fpath.FlatCells(*([sp] * len(fpath.FlatCells._fields)))
    cache = CellCache(
        cells_or_upper=cells, lower=cells,
        scat_trigger=_spec(AXIS, planet=planet),
        F_dir=sp, Fc_dir=sp, meanmolmass_lay=rep1, z_lay=rep1,
        opac_lay=sp, scat_cross_lay=sp,
        F_add_heat_lay=rep1, F_add_heat_sum=rep1,
        coeff=_coeff_specs(phys, planet=planet))
    flux = FluxState(F_down=sp, F_up=sp, Fc_down=sp, Fc_up=sp)
    totals = FluxTotals(F_down_band=sp, F_up_band=sp, F_dir_band=sp,
                        F_down_tot=rep1, F_up_tot=rep1, F_net=rep1)
    return ConvLoopState(
        T_lay=rep1, flux=flux, cache=cache, totals=totals, T_store=rep1,
        prefactor=rep1, F_smooth_sum=rep1, conv_layer=rep1,
        marked_red=rep1, it=rep0, local_limit=rep0, keep_running=rep0,
        aborted=rep0)


def _sset_arrays(sset):
    """The device-array pytree of a SpeciesSet: (data tuple, ktemps,
    kpress).  The static parts (specs list, ordering) stay in closure."""
    return (tuple(sset.data), sset.ktemps, sset.kpress)


def _sset_specs(sset):
    """PartitionSpecs matching _sset_arrays: per-species opacity tables
    shard their wavelength-bin axis, Rayleigh cross-sections shard too;
    VMR sources and (T, P) grids are replicated (they are bin-free)."""
    from helios_tpu.chem import SpeciesDeviceData

    d = SpeciesDeviceData(
        opacity_pretab=P(None, None, AXIS, None),
        scat_cross=P(AXIS),
        vmr_pretab=P(), vmr_profile_lay=P(), vmr_profile_int=P())
    return (tuple(d for _ in sset.data), P(), P())


def place_species(sset, mesh: Mesh):
    """device_put every SpeciesSet array with its spectral sharding."""
    import dataclasses

    from helios_tpu.chem import SpeciesDeviceData

    specs = _sset_specs(sset)
    data = [SpeciesDeviceData(*(jax.device_put(a, NamedSharding(mesh, s))
                                for a, s in zip(d, ds)))
            for d, ds in zip(sset.data, specs[0])]
    return dataclasses.replace(
        sset, data=data,
        ktemps=jax.device_put(sset.ktemps, NamedSharding(mesh, P())),
        kpress=jax.device_put(sset.kpress, NamedSharding(mesh, P())))


def production_runners(phys: Phys, mesh: Mesh,
                       thermo: Optional[ThermoProps], sset=None,
                       chunk_iters: Optional[int] = None):
    """The production multi-chip path of pipeline.run: the FULL radiation
    and convection loops (incl. on-the-fly opacity mixing when ``sset``
    is given) for one planet under spectral shard_map.

    Each chip runs the while_loop on its wavelength shard; the
    band->total psum inside integrate_flux_flat is the single
    per-iteration collective and keeps every convergence predicate
    (and the convective adjustment, which consumes the psummed totals)
    replica-identical, so chips iterate in lockstep.

    Returns (rad_init, rad_run, conv_enter, conv_run), all jitted:
      rad_init(m, sarr, T0 [L+1])      -> RadLoopState
      rad_run(m, sarr, state)          -> RadLoopState (chunk_iters cap)
      conv_enter(m, sarr, rad_state)   -> ConvLoopState (entry check only)
      conv_run(m, sarr, state)         -> ConvLoopState (chunk_iters cap)
    ``sarr`` is place_species(sset).data repackaged via sset_arrays(sset)
    (pass () when sset is None).  ``chunk_iters=None`` runs to
    convergence in one call.
    """
    import dataclasses

    from jax import shard_map

    from helios_tpu.rce.loop import ConvLoopState, convection_loop
    from helios_tpu.rce.radiative import init_rad_state, radiation_loop

    phys_l = _phys_local(phys, mesh)
    m_specs = ModelArrays(**_MODEL_SPECS)
    rad_specs = _rad_state_specs(phys)
    conv_specs = _conv_state_specs(phys)
    t_spec = _spec(None)
    s_specs = _sset_specs(sset) if sset is not None else ()

    def local_sset(sarr):
        if sset is None:
            return None
        data, kt, kp = sarr
        return dataclasses.replace(sset, data=list(data), ktemps=kt,
                                   kpress=kp)

    def _shm(body, in_specs, out_specs):
        return jax.jit(shard_map(body, mesh=mesh, in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False))

    rad_init = _shm(
        lambda m, sarr, T0: init_rad_state(phys_l, m, T0,
                                           local_sset(sarr),
                                           axis_name=AXIS),
        (m_specs, s_specs, t_spec), rad_specs)

    rad_run = _shm(
        lambda m, sarr, state: radiation_loop(
            phys_l, m, thermo, state.T_lay, max_steps=chunk_iters,
            sset=local_sset(sarr), state0=state, axis_name=AXIS),
        (m_specs, s_specs, rad_specs), rad_specs)

    conv_enter = _shm(
        lambda m, sarr, rad: convection_loop(
            phys_l, m, thermo, rad, max_steps=0, sset=local_sset(sarr),
            axis_name=AXIS),
        (m_specs, s_specs, rad_specs), conv_specs)

    conv_run = _shm(
        lambda m, sarr, state: convection_loop(
            phys_l, m, thermo, None, max_steps=chunk_iters,
            sset=local_sset(sarr), state0=state, axis_name=AXIS),
        (m_specs, s_specs, conv_specs), conv_specs)

    return rad_init, rad_run, conv_enter, conv_run


def sset_arrays(sset):
    """Public alias: the shardable array pytree of a SpeciesSet (pass to
    production_runners' ``sarr`` argument); () for sset=None."""
    return () if sset is None else _sset_arrays(sset)
