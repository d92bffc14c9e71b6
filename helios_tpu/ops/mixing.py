"""On-the-fly opacity mixing: correlated-k addition and Random Overlap.

Redesign of add_to_mixed_opac (source/kernels.cu:3263-3399),
calc_h2o_scat (:3404-3440) and add_to_mixed_scat (:3444-3459).

The reference's Random Overlap runs, per (bin, layer) CUDA thread, an
insertion sort of the 400 pairwise opacity sums (with a fill-order trick to
pre-sort; the value multiset is identical).  Here the whole grid is mixed
at once, in vector ops end to end: one batched `lax.sort` over a
[layer, bin, ny*ny] tensor, a log-shift cumsum (`_cumsum_lanes`), a
closed-form rebin-index recurrence (`_rebin_indices`, preserving the
reference quirk that the interval index advances at least one step per
output point), and gather-free exact interval selection (`_select_at`).
The shapes of `_cumsum_lanes` and `_select_at` were chosen for an earlier
vector machine; whether they still pay on the GPU is not measured yet.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from helios_tpu import constants as pc


def correlated_k_add(mixed_opac, new_opac):
    """Correlated-k mixing: plain addition (kernels.cu:3304-3310)."""
    return mixed_opac + new_opac


def _rebin_indices(yg, gauss_y):
    """Interval index w(y) used to rebin the sorted k-function onto each
    Gauss point (kernels.cu:3379-3396).

    The reference walks w upward and advances y when yg[w] first exceeds
    gauss_y[y]; because w keeps moving, the interval used for y is
    max(first crossing, w(y-1)+1) -- consecutive Gauss points never share
    an interval even when they fall inside the same one.

    The recurrence w_y = clip(max(first_y, w_{y-1}+1), 1, n2-1) has the
    closed form w_y = clip(max(y+1, y + max_{j<=y}(first_j - j)), 1, n2-1):
    substituting the unclipped unrolling max_j(first_j + (y-j)) plus the
    y=0 lower clip propagated as w_y >= y+1; the upper clip commutes with
    the +1 steps because once at the cap the recurrence stays at the cap.
    This removes the scan: one vectorized compare-sum and a cummax over
    the tiny Gauss axis.

    yg: [..., n2]; gauss_y: [ny].  Returns w: [..., ny] int32 in [1, n2-1].
    """
    n2 = yg.shape[-1]
    # first_y = #{yg <= g_y}, all Gauss points at once
    first = jnp.sum(yg[..., None] <= gauss_y, axis=-2).astype(jnp.int32)
    yi = jnp.arange(gauss_y.shape[0], dtype=jnp.int32)
    m = jax.lax.cummax(first - yi, axis=first.ndim - 1)
    w = jnp.maximum(yi + m, yi + 1)
    return jnp.clip(w, 1, n2 - 1)


def _cumsum_lanes(x):
    """Inclusive cumsum along the last axis via log2(n) shifted adds
    (Hillis-Steele): ~9 vector passes for n = 400."""
    n = x.shape[-1]
    pad = [(0, 0)] * (x.ndim - 1)
    s = 1
    while s < n:
        x = x + jnp.pad(x[..., :-s], pad + [(s, 0)])
        s *= 2
    return x


def _split_f32(x):
    """Two-float32 split, x ~= hi + lo to ~2^-47 relative (hi carries 24
    bits, lo the next ~24 of fp64's 53).  Identity (x, 0) for single
    precision.

    hi is x with its low 29 mantissa bits cleared, so it converts to
    float32 exactly: a float64 -> float32 -> float64 round trip, the
    obvious way to get hi, is one that XLA may fold away when it allows
    excess precision (the GPU default), which would leave lo = 0."""
    if x.dtype != jnp.float64:
        return x.astype(jnp.float32), jnp.zeros_like(x, jnp.float32)
    bits = jax.lax.bitcast_convert_type(x, jnp.uint64)
    hi = jax.lax.bitcast_convert_type(
        bits & jnp.uint64(~((1 << 29) - 1) & (2 ** 64 - 1)), x.dtype)
    return hi.astype(jnp.float32), (x - hi).astype(jnp.float32)


def _select_at(w, arrays):
    """Gather-free selection: for each array a, return (a[w-1], a[w])
    along the last axis, batched over leading dims.

    Instead of take_along_axis, build ONE f32 one-hot of w and contract
    it as a matrix product.  The CONTRACTION is exact (every one-hot row
    has a single 1.0, so each product and sum is a plain copy); the
    selected values carry the two-float32 split's ~49 significand bits
    (see _split_f32).
    """
    n2 = arrays[0].shape[-1]
    dtype = arrays[0].dtype
    p = jnp.arange(n2, dtype=jnp.int32)
    onehot = (w[..., :, None] == p).astype(jnp.float32)   # [..., ny, n2]

    cols = []
    for a in arrays:
        hi, lo = _split_f32(a)
        # a[w-1] == shift-right(a)[w]  (w >= 1 always)
        sh_hi = jnp.concatenate([hi[..., :1], hi[..., :-1]], axis=-1)
        sh_lo = jnp.concatenate([lo[..., :1], lo[..., :-1]], axis=-1)
        cols += [hi, lo, sh_hi, sh_lo]
    stacked = jnp.stack(cols, axis=-1)                    # [..., n2, 4A]
    # the plain fp32 algorithm is load-bearing: a default-precision f32
    # matmul may run in TF32 (~1e-3 relative), and even HIGHEST may be
    # emulated from narrower products on the GPU (~1e-7), either of which
    # would round the "exactly selected" values
    sel = jnp.einsum("...yp,...pk->...yk", onehot, stacked,
                     precision=jax.lax.DotAlgorithmPreset.F32_F32_F32,
                     preferred_element_type=jnp.float32)
    out = []
    for i in range(len(arrays)):
        at_w = sel[..., 4 * i].astype(dtype) + sel[..., 4 * i + 1]
        at_wm1 = sel[..., 4 * i + 2].astype(dtype) + sel[..., 4 * i + 3]
        out.append((at_wm1, at_w))
    return out


def random_overlap_mix(mixed_opac, new_opac, gauss_weight, gauss_y):
    """Random Overlap of two k-distributions (kernels.cu:3311-3397).

    Args:
      mixed_opac, new_opac: [..., ny] k-coefficients (ascending in y).
      gauss_weight, gauss_y: [ny] quadrature weights and shifted nodes.

    Returns the re-binned mixed k-coefficients [..., ny].

    Instead of the reference's per-thread insertion sort of 400 pairwise
    sums: one batched variadic `lax.sort`, then exact vector forms of the
    cumsum, the rebin index and the interval lookup (`_cumsum_lanes`,
    `_rebin_indices`, `_select_at`).
    """
    ny = gauss_y.shape[0]
    sums = mixed_opac[..., :, None] + new_opac[..., None, :]
    sums = sums.reshape(mixed_opac.shape[:-1] + (ny * ny,))
    w2 = (0.5 * gauss_weight[:, None]) * (0.5 * gauss_weight[None, :])
    w2 = jnp.broadcast_to(w2.reshape(ny * ny), sums.shape)

    sorted_k, sorted_w = jax.lax.sort((sums, w2), dimension=-1,
                                      num_keys=1)

    # cumulative y positions: yg[w] = sum_{v<w} wt[v] + 0.5*wt[w]
    csum = _cumsum_lanes(sorted_w)
    yg = csum - 0.5 * sorted_w

    w = _rebin_indices(yg, gauss_y)                # [..., ny]
    (yg_lo, yg_hi), (k_lo, k_hi) = _select_at(w, [yg, sorted_k])
    g = gauss_y.reshape((1,) * (yg.ndim - 1) + (ny,))
    return (k_lo * (yg_hi - g) + k_hi * (g - yg_lo)) / (yg_hi - yg_lo)


def add_species_opacity(mixed_opac, opac_spec, vmr, mass_spec,
                        meanmolmass, gauss_weight, gauss_y, *,
                        species_index: int, ro_method: int):
    """Mix one species into the running opacity (add_to_mixed_opac,
    kernels.cu:3263-3399).

    Args:
      mixed_opac: [L, B, Y] running mixed opacity [cm^2/g].
      opac_spec: [L, B, Y] species opacity [cm^2/g of species].
      vmr: [L] volume mixing ratio; mass_spec: species mass [g];
      meanmolmass: [L] mean molecular mass [g].
      species_index: position in the mixing order (0 => correlated-k).
      ro_method: 1 for Random Overlap, 0 for correlated-k.

    Returns updated mixed opacity [L, B, Y].
    """
    ny = mixed_opac.shape[-1]
    new_opac = (vmr * mass_spec / meanmolmass)[:, None, None] * opac_spec

    if ro_method == 0 or species_index == 0 or ny == 1:
        return correlated_k_add(mixed_opac, new_opac)

    # per-cell negligible-overlap test (kernels.cu:3296-3302): if one
    # opacity's maximum is under 1% of the other's minimum, skip RO
    negligible = ((0.01 * mixed_opac[..., 0] > new_opac[..., ny - 1])
                  | (0.01 * new_opac[..., 0] > mixed_opac[..., ny - 1]))
    ck = correlated_k_add(mixed_opac, new_opac)
    ro = random_overlap_mix(mixed_opac, new_opac, gauss_weight, gauss_y)
    return jnp.where(negligible[..., None], ck, ro)


# --------------------------------------------------------------------------- #
# Rayleigh scattering accumulation
# --------------------------------------------------------------------------- #

def add_species_scat(mixed_scat, scat_cross_spec, vmr):
    """scat += vmr * sigma_species (add_to_mixed_scat, kernels.cu:3444-3459).

    mixed_scat: [L, B]; scat_cross_spec: [B] or [L, B]; vmr: [L].
    """
    return mixed_scat + vmr[:, None] * scat_cross_spec


def h2o_refractive_index(wave, press, temp, f_h2o, mass_h2o):
    """Density-dependent H2O refractive index (calc_index_h2o,
    kernels.cu:3174-3205; Schiebener et al. 1990 formulation).

    wave: [B]; press/temp/f_h2o: [L].  Returns [L, B].
    """
    dens = f_h2o * press * mass_h2o / (pc.K_B * temp)       # [L]
    lamda = (wave / 0.589e-4)[None, :]                      # [L?, B]
    delta = jnp.minimum(1.0, dens)[:, None]
    theta = (temp / 273.15)[:, None]

    lamda_UV, lamda_IR = 0.229202, 5.432937
    a0, a1, a2, a3 = 0.244257733, 0.974634476e-2, -0.373234996e-2, \
        0.268678472e-3
    a4, a5, a6, a7 = 0.158920570e-2, 0.245934259e-2, 0.900704920, \
        -0.166626219e-1

    A = delta * (a0 + a1 * delta + a2 * theta + a3 * lamda ** 2 * theta
                 + a4 * lamda ** -2
                 + a5 / (lamda ** 2 - lamda_UV ** 2)
                 + a6 / (lamda ** 2 - lamda_IR ** 2)
                 + a7 * delta ** 2)
    return jnp.sqrt((2.0 * A + 1.0) / (1.0 - A))


def h2o_scat_cross(wave, press, temp, vmr_h2o, mass_h2o):
    """On-the-fly H2O Rayleigh cross section (calc_h2o_scat,
    kernels.cu:3404-3440).  Returns [L, B]."""
    index = h2o_refractive_index(wave, press, temp, vmr_h2o, mass_h2o)
    n_ref = (vmr_h2o * press / (pc.K_B * temp))[:, None]    # [L, 1]
    King = (6.0 + 3.0 * 3e-4) / (6.0 - 7.0 * 3e-4)
    lamda_limit = 2.5e-4
    cross = (24.0 * pc.PI ** 3 / (n_ref ** 2 * wave[None, :] ** 4)
             * ((index ** 2 - 1.0) / (index ** 2 + 2.0)) ** 2 * King)
    return jnp.where(wave[None, :] < lamda_limit, cross, 0.0)
