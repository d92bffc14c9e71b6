"""The radiative-convective interplay loop, fully on device.

Redesign of convection_loop (source/computation.py:992-1174) and
conv_temp_iter (source/kernels.cu:2768-2884).  The reference ping-pongs
host<->device every iteration because convective adjustment is CPU code;
here adjustment is the device-side segmented-scan implementation in
:mod:`helios_tpu.rce.convect`, so the whole loop is one `lax.while_loop`.

Convection requires non-isothermal mode: the reference only ever runs its
instability check when iso == 0 (computation.py:1004-1007).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from helios_tpu import constants as pc
from helios_tpu.forward import (CellCache, FluxState, ModelArrays, Phys,
                                compute_cells, init_flux_state,
                                integrate_flux_flat, solve_fluxes)
from helios_tpu.ops import integrate as int_ops
from helios_tpu.ops import interp as interp_ops
from helios_tpu.rce import convect
from helios_tpu.rce.radiative import (RadLoopState, ThermoProps, kappa_cp_lay,
                                      kappa_int, smoothing_flux)


class ConvLoopState(NamedTuple):
    T_lay: jnp.ndarray
    flux: FluxState
    cache: CellCache
    totals: int_ops.FluxTotals
    T_store: jnp.ndarray
    prefactor: jnp.ndarray
    F_smooth_sum: jnp.ndarray      # [L]
    conv_layer: jnp.ndarray        # [L+1] bool
    marked_red: jnp.ndarray        # [L+1] bool (non-converged radiative)
    it: jnp.ndarray
    local_limit: jnp.ndarray
    keep_running: jnp.ndarray
    aborted: jnp.ndarray


def conv_temp_step(phys: Phys, m: ModelArrays, totals: int_ops.FluxTotals,
                   T_lay, T_store, prefactor, marked_red, it,
                   F_add_heat_lay=None):
    """Radiative forward step during the convective phase
    (conv_temp_iter, kernels.cu:2768-2884).

    Differences from the radiative step: prefactor seeds 1e-2 (reset 1e-3 at
    iteration 6000), exponent 0.5, delta-T clamp +-20 K, the surface is
    driven by the net flux at the first non-converged radiative layer, and
    only the lower temperature bound is enforced.
    """
    L = phys.nlayer
    F_net = totals.F_net

    if F_add_heat_lay is None:
        F_add_heat_lay = jnp.zeros(L, T_lay.dtype)
    F_net_diff = F_net[:L] - F_net[1:L + 1] + F_add_heat_lay
    F_smooth, F_smooth_sum = smoothing_flux(phys, T_lay, m.p_lay)
    combined_lay = F_net_diff + F_smooth

    # surface: F_intern - F_net[j+1] for the first marked_red layer j,
    # falling back to F_net[0] (kernels.cu:2825-2837)
    idx = jnp.arange(L)
    first_red = jnp.min(jnp.where(marked_red[:L], idx, L))
    combined_surf = jnp.where(
        first_red < L,
        phys.F_intern - F_net[jnp.minimum(first_red, L - 1) + 1],
        phys.F_intern - F_net[0])
    combined = jnp.concatenate([combined_lay, combined_surf[None]])

    prefactor = jnp.where(it == 0, jnp.full_like(prefactor, 1e-2), prefactor)
    prefactor = jnp.where(it == 6000, jnp.full_like(prefactor, 1e-3),
                          prefactor)

    # c/(dp) * pref*p0/|c|^0.5 == pref*p0/dp * sign(c)*|c|^0.5; avoids the
    # |c|^-0.5 overflow for tiny residuals (see rad_temp_step)
    absc = jnp.abs(combined)
    delta_T = (prefactor * m.p_lay[0] / (m.p_int[0] - m.p_int[1])
               * jnp.sign(combined) * absc ** 0.5)
    delta_T = jnp.where(jnp.abs(delta_T) > 20.0,
                        20.0 * jnp.sign(combined), delta_T)

    T_store = jnp.where(it % phys.adapt_interval == 0, T_lay, T_store)
    oscillating = (jnp.abs(T_lay - T_store)
                   < phys.adapt_interval / 2.0 * jnp.abs(delta_T))
    adapt_now = it % phys.adapt_interval == phys.adapt_interval - 1
    prefactor = jnp.where(
        adapt_now,
        jnp.where(oscillating, prefactor / 1.5, prefactor * 1.1),
        prefactor)

    T_new = jnp.maximum(T_lay + delta_T, 1.001)
    return T_new, T_store, prefactor, F_smooth_sum


def _one_convection_iteration(phys: Phys, m: ModelArrays,
                              thermo: ThermoProps,
                              s: ConvLoopState, sset=None,
                              axis_name=None) -> ConvLoopState:
    """Body of the convection loop (computation.py:1030-1164).

    ``axis_name``: spectral mesh axis when running inside shard_map; the
    band->total psum in integrate_flux_flat keeps the totals (and so the
    convective adjustment and every convergence predicate)
    replica-identical across chips."""
    L = phys.nlayer

    # --- convective adjustment (uses previous iteration's fluxes) ---
    kappa_lay, c_p_lay = kappa_cp_lay(thermo, s.T_lay, m.p_lay)
    T_int = interp_ops.interface_temperatures(s.T_lay)
    kap_int = kappa_int(thermo, T_int, m.p_int)

    T_adj, _conv = convect.convective_adjustment(
        s.T_lay, m.p_lay, m.p_int, kappa_lay, kap_int, c_p_lay,
        s.cache.meanmolmass_lay, iter_value=s.it,
        T_star=phys.T_star, input_dampara=phys.input_dampara,
        F_intern=phys.F_intern, F_add_heat_sum=s.cache.F_add_heat_sum,
        F_smooth_sum=s.F_smooth_sum, F_down_tot=s.totals.F_down_tot,
        F_up_tot=s.totals.F_up_tot)

    # --- flux calculation with the adjusted profile ---
    T_int = interp_ops.interface_temperatures(T_adj)
    cache = jax.lax.cond(
        s.it % 10 == 0,
        lambda: compute_cells(phys, m, T_adj, T_int, sset),
        lambda: s.cache)
    flux = solve_fluxes(phys, m, cache, T_adj, s.flux)
    totals = integrate_flux_flat(phys, m, flux, cache.F_dir, axis_name)

    # --- re-mark convective zones with the post-solve temperatures ---
    kappa_lay, c_p_lay = kappa_cp_lay(thermo, T_adj, m.p_lay)
    kap_int = kappa_int(thermo, T_int, m.p_int)
    conv_layer = convect.mark_convective_layers(
        T_adj, m.p_lay, m.p_int, kappa_lay, kap_int, stitching=1,
        iter_value=s.it)

    # --- convergence on radiative layers only; min 400 iterations ---
    criterion, _converged, marked_red = convect.check_for_radiative_eq(
        T_adj, conv_layer, totals.F_net, totals.F_down_tot,
        F_intern=phys.F_intern, F_add_heat_sum=cache.F_add_heat_sum,
        F_smooth_sum=s.F_smooth_sum,
        rad_convergence_limit=s.local_limit)
    not_done = (~criterion) | (s.it < 400) | (jnp.sum(conv_layer) == 0)

    if phys.physical_tstep != 0.0:
        # one convective adjustment only, no temperature iteration
        # (computation.py:1109-1111)
        not_done = jnp.asarray(False)

    # --- radiative forward step while not converged ---
    def step():
        T_new, T_store, prefactor, F_smooth_sum = conv_temp_step(
            phys, m, totals, T_adj, s.T_store, s.prefactor, marked_red,
            s.it, F_add_heat_lay=cache.F_add_heat_lay)
        return T_new, T_store, prefactor, F_smooth_sum, s.it + 1

    def no_step():
        return T_adj, s.T_store, s.prefactor, s.F_smooth_sum, s.it

    T_new, T_store, prefactor, F_smooth_sum, it_next = jax.lax.cond(
        not_done, step, no_step)

    local_limit = s.local_limit
    for n in phys.crit_relaxation_numbers:
        local_limit = jnp.where(it_next == int(n), local_limit * 10.0,
                                local_limit)

    hit_cap = it_next > phys.max_nr_iterations
    keep = not_done & ~hit_cap

    return ConvLoopState(
        T_lay=T_new, flux=flux, cache=cache, totals=totals,
        T_store=T_store, prefactor=prefactor, F_smooth_sum=F_smooth_sum,
        conv_layer=conv_layer, marked_red=marked_red, it=it_next,
        local_limit=local_limit, keep_running=keep,
        aborted=s.aborted | hit_cap)


def convection_loop(phys: Phys, m: ModelArrays, thermo: ThermoProps,
                    rad: RadLoopState,
                    max_steps: Optional[int] = None,
                    sset=None,
                    state0: Optional[ConvLoopState] = None,
                    axis_name=None) -> ConvLoopState:
    """Run the radiative-convective interplay to equilibrium on device.

    Entered from the final radiation-loop state; like the reference, the
    loop only runs when convection is enabled, mode is non-isothermal, and
    an instability is present (computation.py:996-1009).

    ``max_steps`` caps this call (chunked host monitoring, relative to
    the entry iteration); ``state0`` continues a previous chunk instead
    of initializing from ``rad``.
    """
    L = phys.nlayer

    if state0 is not None:
        # continuation: ``rad`` may be None (the restored state carries
        # everything)
        start_it = state0.it

        def cond0(s):
            c = s.keep_running
            if max_steps is not None:
                c = c & (s.it - start_it < max_steps)
            return c

        return jax.lax.while_loop(
            cond0,
            lambda s: _one_convection_iteration(phys, m, thermo, s, sset,
                                                axis_name),
            state0)

    dtype = rad.T_lay.dtype
    state = ConvLoopState(
        T_lay=rad.T_lay, flux=rad.flux, cache=rad.cache, totals=rad.totals,
        T_store=jnp.zeros(L + 1, dtype),
        prefactor=jnp.full(L + 1, 1e-2, dtype),
        F_smooth_sum=rad.F_smooth_sum,
        conv_layer=jnp.zeros(L + 1, bool),
        marked_red=jnp.zeros(L + 1, bool),
        it=jnp.asarray(0, jnp.int32),
        local_limit=jnp.asarray(phys.rad_convergence_limit, dtype),
        keep_running=jnp.asarray(True),
        aborted=jnp.asarray(False))

    if phys.singlewalk or not phys.convection or phys.iso:
        return state._replace(keep_running=jnp.asarray(False))

    # entry check: any convectively unstable layers?
    kappa_lay, _ = kappa_cp_lay(thermo, rad.T_lay, m.p_lay)
    T_int = interp_ops.interface_temperatures(rad.T_lay)
    kap_int = kappa_int(thermo, T_int, m.p_int)
    unstable = convect.conv_check(rad.T_lay, m.p_lay, m.p_int, kappa_lay,
                                  kap_int)
    entry = jnp.any(unstable) | rad.goto_convection
    state = state._replace(keep_running=entry)

    def cond(s):
        c = s.keep_running
        if max_steps is not None:
            c = c & (s.it < max_steps)
        return c

    return jax.lax.while_loop(
        cond,
        lambda s: _one_convection_iteration(phys, m, thermo, s, sset,
                                            axis_name),
        state)
