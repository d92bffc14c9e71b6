"""Radiative temperature iteration: the RCE driver, fully on device.

Redesign of the reference's rad_temp_iter kernel
(source/kernels.cu:2606-2763) and radiation_loop driver
(source/computation.py:827-990).  The reference round-trips the per-layer
abort flags to the host every iteration and temperatures every 100th; here
the entire loop -- flux solve, temperature update, adaptive pseudo-timestep
bookkeeping, convergence predicates, criterion relaxation, surface-overheat
detection -- is one `lax.while_loop` inside a single jitted program.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from helios_tpu import constants as pc
from helios_tpu import planck as planck_mod
from helios_tpu.forward import (CellCache, FluxState, ModelArrays, Phys,
                                compute_cells, init_flux_state,
                                integrate_flux_flat, solve_fluxes)
from helios_tpu.ops import integrate as int_ops
from helios_tpu.ops import interp as interp_ops


class ThermoProps(NamedTuple):
    """kappa / c_p / entropy / phase source: constant values or a (T, P)
    table.

    Reference read.py:1105-1193: constant kappa => c_p = R_univ / kappa
    [erg/K/mol]; "file"/"water_atmo" mode interpolates everything from
    the loaded entropy table (kernels.cu:703-919).
    """
    kappa_table: jnp.ndarray    # [nt, np] (dummy [2,2] when constant)
    cp_table: jnp.ndarray       # [nt, np]
    entropy_table: jnp.ndarray  # [nt, np] (zeros when absent)
    phase_table: jnp.ndarray    # [nt, np] (water_atmo only; else dummy)
    temps: jnp.ndarray          # [nt]
    press: jnp.ndarray          # [np]
    const_kappa: float          # used when from_table == 0
    from_table: int             # static flag
    has_phase: int = 0          # static flag (water_atmo format)


def make_const_thermo(kappa_value: float, dtype=jnp.float64) -> ThermoProps:
    dummy = jnp.zeros((2, 2), dtype)
    grid = jnp.asarray([1.0, 2.0], dtype)
    return ThermoProps(kappa_table=dummy, cp_table=dummy,
                       entropy_table=dummy, phase_table=dummy, temps=grid,
                       press=grid, const_kappa=float(kappa_value),
                       from_table=0)


def make_table_thermo(tbl, dtype=jnp.float64) -> ThermoProps:
    """ThermoProps from a loaded :class:`helios_tpu.thermo.EntropyTable`
    (the kappa_value = "file"/"water_atmo" modes, read.py:1121-1165)."""
    dummy = jnp.zeros((2, 2), dtype)
    return ThermoProps(
        kappa_table=jnp.asarray(tbl.kappa, dtype),
        cp_table=jnp.asarray(tbl.cp, dtype),
        entropy_table=jnp.asarray(tbl.entropy, dtype),
        phase_table=(jnp.asarray(tbl.phase, dtype)
                     if tbl.phase is not None else dummy),
        temps=jnp.asarray(tbl.temps, dtype),
        press=jnp.asarray(tbl.press, dtype),
        const_kappa=0.0, from_table=1,
        has_phase=int(tbl.phase is not None))


def kappa_cp_lay(thermo: ThermoProps, T_lay, p_lay):
    """kappa(T,P) and c_p(T,P) on layer centers (computation.py:199-232)."""
    L = p_lay.shape[0]
    if thermo.from_table:
        kappa = interp_ops.interpolate_kappa(
            thermo.kappa_table, thermo.temps, thermo.press, T_lay[:L], p_lay)
        cp = interp_ops.interpolate_cp(
            thermo.cp_table, thermo.temps, thermo.press, T_lay[:L], p_lay)
    else:
        kappa = jnp.full(L, thermo.const_kappa, T_lay.dtype)
        cp = jnp.full(L, pc.R_UNIV / thermo.const_kappa, T_lay.dtype)
    return kappa, cp


def kappa_int(thermo: ThermoProps, T_int, p_int):
    if thermo.from_table:
        return interp_ops.interpolate_kappa(
            thermo.kappa_table, thermo.temps, thermo.press, T_int, p_int)
    return jnp.full(p_int.shape[0], thermo.const_kappa, T_int.dtype)


# --------------------------------------------------------------------------- #
# smoothing flux
# --------------------------------------------------------------------------- #

def smoothing_flux(phys: Phys, T_lay, p_lay):
    """Temperature smoothing force and its cumulative sum
    (kernels.cu:2653-2670).

    F_smooth[i] = (t_mid - T[i])^7 where t_mid is the neighbor average for
    0 < i < L-1 with p_lay < 1 bar, else T[i] (=> zero force).
    Returns (F_smooth [L], F_smooth_sum [L]).
    """
    L = phys.nlayer
    if not phys.smooth:
        z = jnp.zeros(L, T_lay.dtype)
        return z, z
    t = T_lay[:L]
    mid = jnp.concatenate([t[:1], 0.5 * (t[:-2] + t[2:]), t[-1:]])
    use_mid = (p_lay < 1e6) & (jnp.arange(L) > 0) & (jnp.arange(L) < L - 1)
    t_mid = jnp.where(use_mid, mid, t)
    F_smooth = (t_mid - t) ** 7.0
    return F_smooth, jnp.cumsum(F_smooth)


# --------------------------------------------------------------------------- #
# the temperature step
# --------------------------------------------------------------------------- #

class RadTempResult(NamedTuple):
    T_lay: jnp.ndarray
    T_store: jnp.ndarray
    prefactor: jnp.ndarray
    F_smooth_sum: jnp.ndarray   # [L]
    abort: jnp.ndarray          # [L+1] bool


def rad_temp_step(phys: Phys, m: ModelArrays, totals: int_ops.FluxTotals,
                  T_lay, T_store, prefactor, it, local_limit,
                  c_p_lay=None, meanmolmass_lay=None,
                  F_add_heat_lay=None, F_add_heat_sum=None) -> RadTempResult:
    """One radiative temperature update (rad_temp_iter, kernels.cu:2606-2763).

    All [L+1] vectors include the surface/BOA ghost layer at index L.
    """
    L = phys.nlayer
    F_net = totals.F_net
    dtype = T_lay.dtype

    if F_add_heat_lay is None:
        F_add_heat_lay = jnp.zeros(L, dtype)
        F_add_heat_sum = jnp.zeros(L, dtype)
    F_net_diff = F_net[:L] - F_net[1:L + 1] + F_add_heat_lay
    F_smooth, F_smooth_sum = smoothing_flux(phys, T_lay, m.p_lay)
    combined_lay = F_net_diff + F_smooth

    # ghost layer: driven by F_intern - F_net[0], or F_net[1] when the
    # bottom layer is not converged (kernels.cu:2675-2683)
    denom_crit = totals.F_down_tot[L] + phys.F_intern
    use_above = (jnp.abs(phys.F_intern - F_net[1]) / denom_crit
                 > 0.5 * local_limit)
    combined_surf = jnp.where(use_above, phys.F_intern - F_net[1],
                              phys.F_intern - F_net[0])
    combined = jnp.concatenate([combined_lay, combined_surf[None]])

    if phys.physical_tstep == 0.0:
        # adaptive pseudo-timestep (kernels.cu:2686-2724)
        prefactor = jnp.where(it == phys.foreplay,
                              jnp.ones_like(prefactor), prefactor)
        prefactor = jnp.where(it == 10000,
                              jnp.full_like(prefactor, 1e-1), prefactor)

        # delta_T = c/(dp) * pref*p0/|c|^0.9 == pref*p0/dp * sign(c)*|c|^0.1
        # -- algebraically identical to kernels.cu:2695-2698 but without
        # the |c|^-0.9 intermediate that overflows the fp32 exponent
        # range for tiny flux residuals in single precision
        absc = jnp.abs(combined)
        delta_T = (prefactor * m.p_lay[0] / (m.p_int[0] - m.p_int[1])
                   * jnp.sign(combined) * absc ** 0.1)
        delta_T = jnp.where(jnp.abs(delta_T) > 500.0,
                            500.0 * jnp.sign(combined), delta_T)

        T_store = jnp.where(it % phys.adapt_interval == 0, T_lay, T_store)
        oscillating = (jnp.abs(T_lay - T_store)
                       < phys.adapt_interval / 2.0 * jnp.abs(delta_T))
        adapt_now = it % phys.adapt_interval == phys.adapt_interval - 1
        prefactor = jnp.where(
            adapt_now,
            jnp.where(oscillating, prefactor / 1.5, prefactor * 1.1),
            prefactor)
    else:
        # constant physical timestep with c_p (kernels.cu:2727-2735)
        cp_per_g = c_p_lay / (meanmolmass_lay / pc.AMU)
        dp = m.p_int[:L] - m.p_int[1:]
        dT_lay = (phys.g / cp_per_g * combined_lay / dp
                  * phys.physical_tstep)
        dT_surf = (phys.g / cp_per_g[0] * combined_surf
                   / (m.p_int[0] - m.p_int[1]) * phys.physical_tstep)
        delta_T = jnp.concatenate([dT_lay, dT_surf[None]])

    T_new = T_lay + delta_T
    if phys.no_atmo:
        T_new = T_new.at[:L].set(1.001)   # kernels.cu:2741-2743
    max_limit = phys.plancktable_dim * phys.plancktable_step - 1.001
    T_new = jnp.clip(T_new, 1.001, max_limit)

    # per-layer convergence flags (kernels.cu:2750-2762)
    crit_lay = (jnp.abs(phys.F_intern + F_add_heat_sum + F_smooth_sum
                        - F_net[1:L + 1]) / denom_crit < local_limit)
    crit_surf = jnp.abs(phys.F_intern - F_net[0]) / denom_crit < local_limit
    abort = jnp.concatenate([crit_lay, crit_surf[None]])

    return RadTempResult(T_lay=T_new, T_store=T_store, prefactor=prefactor,
                         F_smooth_sum=F_smooth_sum, abort=abort)


# --------------------------------------------------------------------------- #
# the radiation loop
# --------------------------------------------------------------------------- #

class RadLoopState(NamedTuple):
    T_lay: jnp.ndarray
    flux: FluxState
    cache: CellCache
    totals: int_ops.FluxTotals
    T_store: jnp.ndarray
    prefactor: jnp.ndarray
    F_smooth_sum: jnp.ndarray
    abort: jnp.ndarray
    it: jnp.ndarray               # int32 iteration counter
    local_limit: jnp.ndarray      # relaxable convergence criterion
    keep_running: jnp.ndarray     # bool
    goto_convection: jnp.ndarray  # bool (surface overheat fast path)
    aborted: jnp.ndarray          # bool (max iteration cap hit)


def _one_radiation_iteration(phys: Phys, m: ModelArrays,
                             thermo: Optional[ThermoProps],
                             s: RadLoopState, sset=None,
                             axis_name=None) -> RadLoopState:
    """Body of the radiation loop (computation.py:851-981).

    ``axis_name``: spectral mesh axis when running inside shard_map; the
    band->total psum makes totals (and so every convergence predicate)
    replica-identical across chips."""
    L = phys.nlayer
    T_int = interp_ops.interface_temperatures(s.T_lay)

    # every 10th iteration: refresh opacities/transmission/beam
    cache = jax.lax.cond(
        s.it % 10 == 0,
        lambda: compute_cells(phys, m, s.T_lay, T_int, sset),
        lambda: s.cache)

    flux = solve_fluxes(phys, m, cache, s.T_lay, s.flux)
    totals = integrate_flux_flat(phys, m, flux, cache.F_dir, axis_name)

    if phys.physical_tstep != 0.0 and thermo is not None:
        _kappa_lay, c_p_lay = kappa_cp_lay(thermo, s.T_lay, m.p_lay)
    else:
        c_p_lay = None

    def do_step():
        return rad_temp_step(phys, m, totals, s.T_lay, s.T_store,
                             s.prefactor, s.it, s.local_limit,
                             c_p_lay=c_p_lay,
                             meanmolmass_lay=cache.meanmolmass_lay,
                             F_add_heat_lay=cache.F_add_heat_lay,
                             F_add_heat_sum=cache.F_add_heat_sum)

    def no_step():
        return RadTempResult(T_lay=s.T_lay, T_store=s.T_store,
                             prefactor=s.prefactor,
                             F_smooth_sum=s.F_smooth_sum,
                             abort=jnp.zeros(L + 1, bool))

    # temperature stepping only after the foreplay prerun
    # (computation.py:906-932)
    res = jax.lax.cond(s.it >= phys.foreplay, do_step, no_step)

    it_next = s.it + 1

    # criterion relaxation x10 at the configured iteration numbers
    # (computation.py:974-975, host_functions.py:243-248)
    local_limit = s.local_limit
    for n in phys.crit_relaxation_numbers:
        local_limit = jnp.where(it_next == int(n), local_limit * 10.0,
                                local_limit)

    # surface overheat -> jump to convection loop (computation.py:946-952);
    # checked every 100th iteration like the reference
    overheat = ((s.it % 100 == 0)
                & (res.T_lay[L]
                   >= phys.plancktable_dim * phys.plancktable_step - 2))
    goto_conv = s.goto_convection | overheat

    converged = jnp.all(res.abort) & (s.it >= phys.foreplay)
    hit_cap = it_next > phys.max_nr_iterations
    keep = ~converged & ~overheat & ~hit_cap
    if phys.physical_tstep != 0.0:
        keep = keep & ((it_next.astype(jnp.float64) * phys.physical_tstep)
                       < phys.runtime_limit)

    return RadLoopState(
        T_lay=res.T_lay, flux=flux, cache=cache, totals=totals,
        T_store=res.T_store, prefactor=res.prefactor,
        F_smooth_sum=res.F_smooth_sum, abort=res.abort, it=it_next,
        local_limit=local_limit, keep_running=keep,
        goto_convection=goto_conv, aborted=s.aborted | hit_cap)


def init_rad_state(phys: Phys, m: ModelArrays, T_lay0,
                   sset=None, axis_name=None) -> RadLoopState:
    L = phys.nlayer
    dtype = T_lay0.dtype
    T_int = interp_ops.interface_temperatures(T_lay0)
    cache = compute_cells(phys, m, T_lay0, T_int, sset)
    flux = init_flux_state(phys, dtype)
    totals = integrate_flux_flat(phys, m, flux, cache.F_dir, axis_name)
    return RadLoopState(
        T_lay=T_lay0, flux=flux, cache=cache, totals=totals,
        T_store=jnp.zeros(L + 1, dtype),
        prefactor=jnp.ones(L + 1, dtype),
        F_smooth_sum=jnp.zeros(L, dtype),
        abort=jnp.zeros(L + 1, bool),
        it=jnp.asarray(0, jnp.int32),
        local_limit=jnp.asarray(phys.rad_convergence_limit, dtype),
        keep_running=jnp.asarray(True),
        goto_convection=jnp.asarray(False),
        aborted=jnp.asarray(False))


def radiation_loop(phys: Phys, m: ModelArrays,
                   thermo: Optional[ThermoProps], T_lay0,
                   max_steps: Optional[int] = None,
                   sset=None, state0: Optional[RadLoopState] = None,
                   axis_name=None) -> RadLoopState:
    """Run the radiative-equilibrium iteration to convergence on device.

    One jitted `lax.while_loop`; equivalent of computation.py:827-990.
    ``max_steps`` optionally caps the loop (for chunked host monitoring);
    ``state0`` continues from a prior/restored state (checkpoint resume)
    instead of initializing from T_lay0.
    """
    state = state0 if state0 is not None else init_rad_state(
        phys, m, T_lay0, sset, axis_name)
    if phys.singlewalk:
        # post-processing: one flux solve (with the 1000*scat+1 sweep
        # passes), no temperature iteration (computation.py:983-984)
        flux = solve_fluxes(phys, m, state.cache, state.T_lay, state.flux)
        totals = integrate_flux_flat(phys, m, flux, state.cache.F_dir,
                                     axis_name)
        return state._replace(flux=flux, totals=totals)

    start_it = state.it

    def cond(s):
        c = s.keep_running
        if max_steps is not None:
            c = c & (s.it - start_it < max_steps)
        return c

    return jax.lax.while_loop(
        cond,
        lambda s: _one_radiation_iteration(phys, m, thermo, s, sset,
                                           axis_name),
        state)
