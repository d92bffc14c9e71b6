"""Fused two-stream flux sweeps for NVIDIA GPUs (Pallas through Triton).

The iterative flux solve is the hot loop of every RCE iteration: per pass a
downward then an upward first-order recurrence over the layers, elementwise
across the S = nbin * ny spectral columns.  XLA runs it as a `lax.scan` of
2 * n_passes * nlayer dependent steps, each a small launch over S columns.

These kernels follow the reference's own design (fband_iso / fband_noniso,
source/kernels.cu:1366-1800): one lane per spectral column, and the layer
and pass loops inside one program, with the carried flux in registers.
Coefficients stay in device memory and are read one layer row at a time;
the rows of a chunk of layers are loaded before its dependent chain runs,
so their latencies overlap instead of adding up.  Columns need no padding:
the last program masks its loads and stores.

The arithmetic of each step is that of `fastpath.fband_iso_flat` /
`fband_noniso_flat` in the same order; results differ from the scan only
by fused multiply-add rounding.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

BLOCK = 32       # spectral columns per program: one warp, one column a lane
NUM_WARPS = 1
CHUNK = 8        # layer rows loaded ahead of each dependent chain


def _i32(i):
    # one index type throughout, also under jax_enable_x64
    return jnp.asarray(i, jnp.int32)


def _columns(S: int):
    start = pl.program_id(0) * BLOCK
    cols = pl.ds(start, BLOCK)
    mask = start + jnp.arange(BLOCK, dtype=jnp.int32) < S
    return cols, mask


def _layer_loop(L: int, reverse: bool, load_rows, step, carry):
    """carry = step(i, rows(i), carry) over layers i = 0..L-1 (or L-1..0),
    loading each chunk's rows before its chain of dependent steps."""
    layer = (lambda k: L - 1 - k) if reverse else (lambda k: k)

    def run(k0, n, carry):
        rows = [load_rows(layer(k0 + j)) for j in range(n)]
        for j, r in enumerate(rows):
            carry = step(layer(k0 + j), r, carry)
        return carry

    n_full = L // CHUNK
    carry = jax.lax.fori_loop(
        np.int32(0), np.int32(n_full),
        lambda c, carry: run(c * CHUNK, CHUNK, carry), carry)
    return run(np.int32(n_full * CHUNK), L % CHUNK, carry)


def _iso_kernel(a_ref, b_ref, sd_ref, su_ref, toa_ref, refl_ref, emis_ref,
                fdir0_ref, _fup_prev_ref, fdown_ref, fup_ref, *,
                n_passes: int):
    L, S = a_ref.shape
    cols, mask = _columns(S)
    row = lambda ref: pltriton.load(ref.at[cols], mask=mask, other=0.0)
    load = lambda ref, i: pltriton.load(ref.at[_i32(i), cols], mask=mask,
                                        other=0.0)
    store = lambda ref, i, v: pltriton.store(ref.at[_i32(i), cols], v,
                                             mask=mask)

    toa = row(toa_ref)
    store(fdown_ref, L, toa)
    refl, emis, fdir0 = row(refl_ref), row(emis_ref), row(fdir0_ref)

    # F_down[i] = a[i] F_down[i+1] + b[i] F_up[i] + sd[i]
    def down_rows(i):
        return load(a_ref, i), load(b_ref, i), load(sd_ref, i), \
            load(fup_ref, i)

    def down_step(i, r, f):
        a, b, s, fu = r
        f = a * f + b * fu + s
        store(fdown_ref, i, f)
        return f

    # F_up[i+1] = a[i] F_up[i] + b[i] F_down[i+1] + su[i]
    def up_rows(i):
        return load(a_ref, i), load(b_ref, i), load(su_ref, i), \
            load(fdown_ref, i + 1)

    def up_step(i, r, f):
        a, b, s, fd = r
        f = a * f + b * fd + s
        store(fup_ref, i + 1, f)
        return f

    def one_pass(_, carry):
        f_boa = _layer_loop(L, True, down_rows, down_step, toa)
        boa = refl * (fdir0 + f_boa) + emis
        store(fup_ref, 0, boa)
        _layer_loop(L, False, up_rows, up_step, boa)
        return carry

    jax.lax.fori_loop(np.int32(0), np.int32(n_passes), one_pass,
                      np.int32(0))


def _noniso_kernel(au_ref, bu_ref, sud_ref, suu_ref, al_ref, bl_ref,
                   sld_ref, slu_ref, toa_ref, refl_ref, emis_ref,
                   fdir0_ref, _fup_prev_ref, _fcup_prev_ref,
                   fdown_ref, fup_ref, fcdown_ref, fcup_ref, *,
                   n_passes: int):
    L, S = au_ref.shape
    cols, mask = _columns(S)
    row = lambda ref: pltriton.load(ref.at[cols], mask=mask, other=0.0)
    load = lambda ref, i: pltriton.load(ref.at[_i32(i), cols], mask=mask,
                                        other=0.0)
    store = lambda ref, i, v: pltriton.store(ref.at[_i32(i), cols], v,
                                             mask=mask)

    toa = row(toa_ref)
    store(fdown_ref, L, toa)
    refl, emis, fdir0 = row(refl_ref), row(emis_ref), row(fdir0_ref)

    # Fc_down[i] = au F_down[i+1] + bu Fc_up[i] + sud;
    # F_down[i] = al Fc_down[i] + bl F_up[i] + sld
    def down_rows(i):
        return tuple(load(r, i) for r in (au_ref, bu_ref, sud_ref, al_ref,
                                          bl_ref, sld_ref, fcup_ref,
                                          fup_ref))

    def down_step(i, r, f):
        au, bu, sud, al, bl, sld, fcu, fu = r
        fc = au * f + bu * fcu + sud
        f = al * fc + bl * fu + sld
        store(fcdown_ref, i, fc)
        store(fdown_ref, i, f)
        return f

    # Fc_up[i] = al F_up[i] + bl Fc_down[i] + slu;
    # F_up[i+1] = au Fc_up[i] + bu F_down[i+1] + suu
    def up_rows(i):
        return tuple(load(r, i) for r in (al_ref, bl_ref, slu_ref, au_ref,
                                          bu_ref, suu_ref, fcdown_ref)) \
            + (load(fdown_ref, i + 1),)

    def up_step(i, r, f):
        al, bl, slu, au, bu, suu, fcd, fd = r
        fc = al * f + bl * fcd + slu
        f = au * fc + bu * fd + suu
        store(fcup_ref, i, fc)
        store(fup_ref, i + 1, f)
        return f

    def one_pass(_, carry):
        f_boa = _layer_loop(L, True, down_rows, down_step, toa)
        boa = refl * (fdir0 + f_boa) + emis
        store(fup_ref, 0, boa)
        _layer_loop(L, False, up_rows, up_step, boa)
        return carry

    jax.lax.fori_loop(np.int32(0), np.int32(n_passes), one_pass,
                      np.int32(0))


def _call(kernel, name, out_rows, args, aliases, *, n_passes, interpret):
    S, dt = args[0].shape[1], args[0].dtype
    return pl.pallas_call(
        partial(kernel, n_passes=n_passes),
        grid=(pl.cdiv(S, BLOCK),),
        out_shape=tuple(jax.ShapeDtypeStruct((n, S), dt) for n in out_rows),
        input_output_aliases=aliases,
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=NUM_WARPS,
                                                num_stages=1),
        interpret=interpret,
        name=name,
    )(*args)


@partial(jax.jit, static_argnames=("n_passes", "interpret"))
def iso_sweep(a, b_nm, src_down, src_up, toa, boa_refl, boa_emis, F_dir0,
              F_up_prev, *, n_passes: int, interpret: bool = False):
    """Iterative isothermal flux solve (`fastpath.fband_iso_flat`).

    a, b_nm, src_down, src_up: [L, S]; toa, boa_refl, boa_emis, F_dir0: [S]
    (toa may be a scalar); F_up_prev: [L+1, S].  Returns (F_down, F_up)
    [L+1, S].  ``interpret`` runs the kernel in the Pallas interpreter
    (tests on the CPU).
    """
    L, S = a.shape
    row = lambda x: jnp.broadcast_to(x, (S,)).astype(a.dtype)
    args = (a, b_nm, src_down, src_up, row(toa), row(boa_refl),
            row(boa_emis), row(F_dir0), F_up_prev)
    # F_up is updated in place (F_up_prev aliases the F_up output): the
    # first down sweep reads the previous solve's, every up sweep rewrites
    return _call(_iso_kernel, "iso_flux_sweep", (L + 1, L + 1), args,
                 {8: 1}, n_passes=n_passes, interpret=interpret)


@partial(jax.jit, static_argnames=("n_passes", "interpret"))
def noniso_sweep(a_up, b_up, src_up_down, src_up_up, a_low, b_low,
                 src_low_down, src_low_up, toa, boa_refl, boa_emis, F_dir0,
                 F_up_prev, Fc_up_prev, *, n_passes: int,
                 interpret: bool = False):
    """Iterative non-isothermal flux solve (`fastpath.fband_noniso_flat`).

    Half-layer coefficients [L, S], boundaries [S], F_up_prev [L+1, S],
    Fc_up_prev [L, S].  Returns (F_down, F_up, Fc_down, Fc_up).
    """
    L, S = a_up.shape
    row = lambda x: jnp.broadcast_to(x, (S,)).astype(a_up.dtype)
    args = (a_up, b_up, src_up_down, src_up_up, a_low, b_low, src_low_down,
            src_low_up, row(toa), row(boa_refl), row(boa_emis), row(F_dir0),
            F_up_prev, Fc_up_prev)
    # F_up and Fc_up are updated in place, as in iso_sweep
    return _call(_noniso_kernel, "noniso_flux_sweep",
                 (L + 1, L + 1, L, L), args, {12: 1, 13: 3},
                 n_passes=n_passes, interpret=interpret)
