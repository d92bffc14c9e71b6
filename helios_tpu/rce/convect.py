"""Device-side convective adjustment.

The reference performs convective adjustment on the host every iteration of
the convection loop (source/host_functions.py:337-635, called from
computation.py:1061) -- the main structural inefficiency of the reference
(SURVEY.md section 3.3).  Here the whole machinery -- instability check,
zone marking, hole stitching, enthalpy-conserving dry-adiabat correction
with fudge-factor energy rebalancing -- is reformulated as vectorized
segment operations (masked cumulative sums/products over zone segments) so
it runs inside the jitted iteration loop with no host round-trips.

Index conventions follow the reference: layers 0..L-1 bottom-up, plus a
surface/BOA "ghost layer" at index L.  A convective zone that includes the
ghost layer is treated as starting at virtual index -1 (host_functions.py:
388-389).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from helios_tpu import constants as pc

# pressure above which the top atmosphere is ignored by the instability
# check (artificial temperature peaks occur there); reference
# host_functions.py:345
P_TOP_IGNORE = 1e1
# zone-gap width threshold: gaps narrower than one scale height (ratio 1/e)
# are stitched / skipped when picking the fudge test interface
# (host_functions.py:418, :631)
GAP_RATIO = 1.0 / jnp.e


def _pair_unstable(T_lay, p_lay, p_int, kappa_lay, kappa_int, pert):
    """Adjacent-layer instability flags pair[i] for i = 0..L-2.

    pair[i] is True when layer i+1 is colder than the adiabat through layer
    i (host_functions.py:343-355 with perturbation +1e-6, :552-565 with
    -1e-6).  Layers with p_lay <= 10 ubar are masked (the reference breaks
    out of the loop there; pressures decrease monotonically so break ==
    mask).
    """
    L = T_lay.shape[0] - 1
    T_between = T_lay[:L - 1] * (p_int[1:L] / p_lay[:L - 1]) ** (
        kappa_lay[:L - 1] * (1.0 + pert))
    T_ad = T_between * (p_lay[1:L] / p_int[1:L]) ** (
        kappa_int[1:L] * (1.0 + pert))
    mask = p_lay[:L - 1] > P_TOP_IGNORE
    return (T_lay[1:L] < T_ad) & mask


def _surface_unstable(T_lay, p_lay, p_int, kappa_int, pert):
    """Ghost-layer/BOA instability (host_functions.py:357-362, :572-577)."""
    L = T_lay.shape[0] - 1
    T_ad = T_lay[L] * (p_lay[0] / p_int[0]) ** (kappa_int[0] * (1.0 + pert))
    return T_lay[0] < T_ad


def conv_check(T_lay, p_lay, p_int, kappa_lay, kappa_int):
    """Unstable-layer flags [L+1] (host_functions.py:337-362)."""
    L = T_lay.shape[0] - 1
    pair = _pair_unstable(T_lay, p_lay, p_int, kappa_lay, kappa_int, +1e-6)
    unstable = jnp.zeros(L + 1, bool)
    # pair i marks layers i and i+1
    unstable = unstable.at[:L - 1].set(pair)
    unstable = unstable.at[1:L].set(unstable[1:L] | pair)
    surf = _surface_unstable(T_lay, p_lay, p_int, kappa_int, +1e-6)
    unstable = unstable.at[L].set(surf)
    unstable = unstable.at[0].set(unstable[0] | surf)
    return unstable


def mark_convective_layers(T_lay, p_lay, p_int, kappa_lay, kappa_int, *,
                           stitching, iter_value):
    """Convective-zone flags [L+1] (host_functions.py:545-582).

    The reference's sequential mark/unmark loop reduces to
    conv[k] = pair[k-1] | pair[k] (writes to index k happen at loop
    iterations k-1 and k, in that order), followed by the kink removal
    (conv[i] = 0 where T[i+1] > T[i]) and the surface condition.
    """
    L = T_lay.shape[0] - 1
    pair = _pair_unstable(T_lay, p_lay, p_int, kappa_lay, kappa_int, -1e-6)
    conv = jnp.zeros(L + 1, bool)
    conv = conv.at[:L - 1].set(pair)
    conv = conv.at[1:L].set(conv[1:L] | pair)
    # kink removal at the top edge of convective zones (:568-570)
    kink = T_lay[1:L] > T_lay[:L - 1]
    conv = conv.at[:L - 1].set(conv[:L - 1] & ~kink)
    surf = _surface_unstable(T_lay, p_lay, p_int, kappa_int, -1e-6)
    conv = conv.at[L].set(surf)
    conv = conv.at[0].set(conv[0] | surf)

    if stitching:
        conv = jax.lax.cond(
            iter_value > 5000,  # reference hardcoded threshold (:581)
            lambda c: stitch_zone_holes(c, p_lay, p_int),
            lambda c: c, conv)
    return conv


def stitch_zone_holes(conv, p_lay, p_int):
    """Fill radiative gaps narrower than one scale height between convective
    zones (host_functions.py:585-635).

    For each radiative layer i: find the nearest convective layer below
    (or the ghost layer, acting as virtual index -1) and above; the gap is
    filled iff both exist and p_lay[above] / p_bot > 1/e, where p_bot is
    p_lay[below] (or p_int[0] for the ghost).
    """
    L = p_lay.shape[0]
    idx = jnp.arange(L)

    # nearest convective index below (inclusive scan downward); ghost = -1
    ghost_below = jnp.where(conv[L], -1, -jnp.inf)
    below_seed = jnp.where(conv[:L], idx.astype(p_lay.dtype), -jnp.inf)
    below = jax.lax.associative_scan(jnp.maximum,
                                     jnp.concatenate([ghost_below[None],
                                                      below_seed]))[1:]
    # nearest convective index above (reverse scan)
    above_seed = jnp.where(conv[:L], idx.astype(p_lay.dtype), jnp.inf)
    above = jax.lax.associative_scan(jnp.minimum, above_seed, reverse=True)

    has_below = below > -jnp.inf
    has_above = above < jnp.inf
    below_i = jnp.clip(below, -1, L - 1).astype(jnp.int32)
    above_i = jnp.clip(above, 0, L - 1).astype(jnp.int32)

    p_bot = jnp.where(below_i >= 0, p_lay[jnp.maximum(below_i, 0)], p_int[0])
    p_top = p_lay[above_i]
    fill = (~conv[:L]) & has_below & has_above & (p_top / p_bot > GAP_RATIO)
    return conv.at[:L].set(conv[:L] | fill)


# --------------------------------------------------------------------------- #
# zone segmentation
# --------------------------------------------------------------------------- #

class Zones(NamedTuple):
    """Fixed-size zone description over the extended index range.

    Extended position 0 represents the ghost layer (virtual index -1);
    position i+1 represents layer i.  Up to L+1 zones, padded with -2.
    """
    zone_of_layer: jnp.ndarray   # [L] zone id of each layer (-1 if radiative)
    start: jnp.ndarray           # [L+1] start layer index per zone (-1=ghost)
    end: jnp.ndarray             # [L+1] end layer index per zone (-1=ghost-only)
    n_zones: jnp.ndarray         # scalar int32
    ghost_in_zone0: jnp.ndarray  # scalar bool: ghost belongs to zone 0


def find_zones(corrected) -> Zones:
    """Segment the corrected[L+1] flags into contiguous zones.

    corrected: [L+1] bool, index L = ghost layer.  Matches the reference's
    list manipulation in host_functions.py:371-395 (ghost becomes virtual
    index -1, merging with a zone starting at layer 0 if present).
    """
    L = corrected.shape[0] - 1
    # extended flags: position 0 = ghost, position i+1 = layer i
    ext = jnp.concatenate([corrected[L:L + 1], corrected[:L]])
    prev = jnp.concatenate([jnp.zeros(1, bool), ext[:-1]])
    is_start = ext & ~prev
    nxt = jnp.concatenate([ext[1:], jnp.zeros(1, bool)])
    is_end = ext & ~nxt

    zone_id_ext = jnp.cumsum(is_start.astype(jnp.int32)) - 1  # 0-based
    zone_id_ext = jnp.where(ext, zone_id_ext, -1)

    layer_index_ext = jnp.arange(-1, L, dtype=jnp.int32)   # ghost = -1
    n_max = L + 1
    start = jnp.full(n_max, -2, jnp.int32)
    end = jnp.full(n_max, -2, jnp.int32)
    # sentinel n_max is out of bounds and dropped (negative indices would
    # wrap, not drop)
    sidx = jnp.where(is_start, zone_id_ext, n_max)
    eidx = jnp.where(is_end, zone_id_ext, n_max)
    start = start.at[sidx].set(layer_index_ext, mode="drop")
    end = end.at[eidx].set(layer_index_ext, mode="drop")
    n_zones = jnp.sum(is_start.astype(jnp.int32))
    return Zones(zone_of_layer=zone_id_ext[1:], start=start, end=end,
                 n_zones=n_zones, ghost_in_zone0=ext[0])


# --------------------------------------------------------------------------- #
# dry-adiabat correction
# --------------------------------------------------------------------------- #

def _adiabat_factors(p_lay, p_int, kappa_lay, kappa_int, zones: Zones):
    """Per-layer adiabat factor within its zone.

    factor(i) = b[i] * prod_{j=s..i-1} a[j]  with
      a[j] = (p_lay[j]/p_int[j])^kappa_int[j] * (p_int[j+1]/p_lay[j])^kappa_lay[j]
      b[i] = (p_lay[i]/p_int[i])^kappa_int[i]
    and s = max(0, zone start)  (host_functions.py:467-499).
    """
    L = p_lay.shape[0]
    log_a = (kappa_int[:L] * jnp.log(p_lay / p_int[:L])
             + kappa_lay * jnp.log(p_int[1:] / p_lay))
    log_b = kappa_int[:L] * jnp.log(p_lay / p_int[:L])

    cs = jnp.cumsum(log_a)
    cs_prev = jnp.concatenate([jnp.zeros(1, cs.dtype), cs[:-1]])  # sum_{j<i}

    s = jnp.maximum(zones.start[jnp.maximum(zones.zone_of_layer, 0)], 0)
    # sum_{j=s..i-1} log_a[j] = cs_prev[i] - cs_prev[s]
    seg_sum = cs_prev - cs_prev[s]
    idx = jnp.arange(L)
    seg_sum = jnp.where(idx > s, seg_sum, 0.0)
    return jnp.exp(log_b + seg_sum)


def conv_correct(T_lay, p_lay, p_int, kappa_lay, kappa_int, c_p_lay,
                 meanmolmass_lay, corrected, fudge_per_zone=None):
    """Set each corrected zone onto its dry adiabat, conserving enthalpy
    (host_functions.py:368-506).

    Args:
      corrected: [L+1] bool flags (conv_unstable | conv_layer).
      fudge_per_zone: optional [L+1] per-zone fudge factors (from
        :func:`fudge_factors`); None -> 1.

    Returns adjusted T_lay [L+1].
    """
    L = T_lay.shape[0] - 1
    zones = find_zones(corrected)
    factor = _adiabat_factors(p_lay, p_int, kappa_lay, kappa_int, zones)

    # enthalpy weight c_p/mmm * delta_p, rescaled by AMU/p_int[0]: the
    # global scale cancels in mean_pot = num/denom, and the raw weight
    # (~1e42 cgs) would overflow the fp32 exponent range in single
    # precision
    w = (c_p_lay / (meanmolmass_lay / pc.AMU)
         * ((p_int[:L] - p_int[1:]) / p_int[0]))
    zl = zones.zone_of_layer
    in_zone = zl >= 0
    seg = jnp.where(in_zone, zl, L)   # dump radiative layers in slot L

    # per-zone sums as reductions over a [zone, layer] mask, in a fixed
    # order: segment_sum lowers to a scatter-add, whose atomic order on
    # the GPU changes from run to run, and the RCE trajectory amplifies
    # those last-bit differences
    member = seg[None, :] == jnp.arange(L + 1)[:, None]       # [L+1, L]
    zone_sum = lambda v: jnp.sum(jnp.where(member, v, 0.0), axis=1)
    num = zone_sum(jnp.where(in_zone, w * T_lay[:L], 0.0))
    denom = zone_sum(jnp.where(in_zone, w * factor, 0.0))
    mean_pot = jnp.where(denom != 0.0, num / jnp.where(denom == 0, 1.0, denom),
                         0.0)
    if fudge_per_zone is not None:
        mean_pot = mean_pot * fudge_per_zone
    T_new_lay = jnp.where(in_zone, mean_pot[seg] * factor, T_lay[:L])

    # ghost layer: if zone 0 includes the ghost, set T_surface to the zone's
    # mean potential temperature (host_functions.py:503-506)
    T_surf = jnp.where(zones.ghost_in_zone0, mean_pot[0], T_lay[L])
    return jnp.concatenate([T_new_lay, T_surf[None]])


def fudge_factors(zones: Zones, p_lay, p_int, T_star, input_dampara,
                  F_intern, F_add_heat_sum, F_smooth_sum, F_down_tot,
                  F_up_tot):
    """Per-zone energy-rebalancing fudge factors (host_functions.py:404-447).

    For zone n, scan zones m >= n for the first whose overlying radiative
    gap is wider than a scale height; the test interface is the middle of
    that gap.  If none, use the top-layer formula
    int(0.8*end_last + 0.2*L).  dampara: 0.5 intermediate / 4 top (stellar
    irradiation) or 8 (self-luminous), unless user-set.

    Returns [L+1] per-zone factors (1.0 for empty slots).
    """
    L = p_lay.shape[0]
    n_max = L + 1
    z = jnp.arange(n_max)
    valid = z < zones.n_zones
    last = zones.n_zones - 1

    start_next = zones.start[jnp.minimum(z + 1, n_max - 1)]  # zone m+1 start
    end_m = zones.end[z]
    p_bot = jnp.where(end_m >= 0, p_lay[jnp.maximum(end_m, 0)], p_int[0])
    p_top = p_lay[jnp.clip(start_next, 0, L - 1)]
    wide = (p_top / p_bot) < GAP_RATIO            # gap wider than H
    wide = wide & (z < last) & valid

    cand_itf = ((end_m + start_next + 1) // 2).astype(jnp.int32)

    # first wide gap at index >= n: reverse running "first such m"
    def scan_fn(carry, x):
        m_idx, is_wide = x
        sel = jnp.where(is_wide, m_idx, carry)
        return sel, sel

    _, first_wide_rev = jax.lax.scan(
        scan_fn, jnp.asarray(-1, jnp.int32),
        (z[::-1].astype(jnp.int32), wide[::-1]))
    first_wide = first_wide_rev[::-1]             # -1 if none at or above n

    has_wide = first_wide >= 0
    end_last = zones.end[jnp.maximum(last, 0)]
    itf_top = (0.8 * end_last + 0.2 * L).astype(jnp.int32)
    itf = jnp.where(has_wide, cand_itf[jnp.maximum(first_wide, 0)], itf_top)
    itf = jnp.clip(itf, 1, L)   # itf-1 indexes F_*_sum; reference never hits 0

    if input_dampara == "automatic":
        if T_star > 10.0:
            dampara = jnp.where(z < last, 0.5, 4.0)
        else:
            dampara = jnp.full(n_max, 8.0)
    else:
        dampara = jnp.full(n_max, float(input_dampara))

    fudge = ((F_intern + F_add_heat_sum[itf - 1] + F_smooth_sum[itf - 1]
              + F_down_tot[itf]) / F_up_tot[itf]) ** (1.0 / dampara)
    fudge = jnp.clip(fudge, 0.99, 1.01)           # (:447)
    return jnp.where(valid, fudge, 1.0)


def convective_adjustment(T_lay, p_lay, p_int, kappa_lay, kappa_int,
                          c_p_lay, meanmolmass_lay, *, iter_value,
                          T_star, input_dampara, F_intern, F_add_heat_sum,
                          F_smooth_sum, F_down_tot, F_up_tot):
    """Full convective adjustment (host_functions.py:509-542), device-side.

    Iterates (mark -> correct -> re-check) until no instability remains,
    then applies the stitched, fudged final correction.

    Returns (T_lay, conv_layer [L+1] bool).
    """
    def unstable_any(T):
        return jnp.any(conv_check(T, p_lay, p_int, kappa_lay, kappa_int))

    def body(T):
        conv_layer = mark_convective_layers(
            T, p_lay, p_int, kappa_lay, kappa_int, stitching=0,
            iter_value=iter_value)
        unstable = conv_check(T, p_lay, p_int, kappa_lay, kappa_int)
        return conv_correct(T, p_lay, p_int, kappa_lay, kappa_int,
                            c_p_lay, meanmolmass_lay, unstable | conv_layer)

    T_lay = jax.lax.while_loop(unstable_any, body, T_lay)

    conv_layer = mark_convective_layers(
        T_lay, p_lay, p_int, kappa_lay, kappa_int, stitching=1,
        iter_value=iter_value)
    unstable = conv_check(T_lay, p_lay, p_int, kappa_lay, kappa_int)
    corrected = unstable | conv_layer
    zones = find_zones(corrected)
    fudge = fudge_factors(zones, p_lay, p_int, T_star, input_dampara,
                          F_intern, F_add_heat_sum, F_smooth_sum,
                          F_down_tot, F_up_tot)
    T_lay = conv_correct(T_lay, p_lay, p_int, kappa_lay, kappa_int,
                         c_p_lay, meanmolmass_lay, corrected,
                         fudge_per_zone=fudge)
    return T_lay, conv_layer


def check_for_radiative_eq(T_lay, conv_layer, F_net, F_down_tot, *,
                           F_intern, F_add_heat_sum, F_smooth_sum,
                           rad_convergence_limit):
    """Per-layer radiative equilibrium on non-convective layers
    (host_functions.py:251-286).

    Returns (criterion_met scalar bool, converged [L+1], marked_red [L+1]).
    """
    L = T_lay.shape[0] - 1
    diff_lay = jnp.abs(F_intern + F_add_heat_sum + F_smooth_sum
                       - F_net[1:L + 1])
    diff_surf = jnp.abs(F_intern - F_net[0])
    local_diff = jnp.concatenate([diff_lay, diff_surf[None]])
    denom = F_down_tot[L] + F_intern
    is_rad = ~conv_layer
    converged = is_rad & (local_diff < rad_convergence_limit * denom)
    marked_red = is_rad & ~converged
    criterion = jnp.sum(converged) == jnp.sum(is_rad)
    return criterion, converged, marked_red
