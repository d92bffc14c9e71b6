"""Checkpoint / resume of the RCE iteration state.

The reference's only resume mechanism is re-reading a previous run's
``*_tp.dat`` as the initial temperature profile (read.py:1274-1322,
host_functions.py:178-184) -- which loses the adaptive-timestep
prefactors, the oscillation-detection store, and the iteration counter,
so a resumed run re-converges from scratch.  Here the full restartable
radiation-loop state (temperatures, fluxes, per-layer prefactors,
T_store, relaxed criterion, counters) is serialized every N iterations,
so a preempted job continues exactly where it stopped -- the standard
requirement for shared GPU clusters where preemption is routine.

Format: a single ``.npz`` written atomically (tmp file + rename).  The
non-restartable members of RadLoopState (cell cache, band totals) are
derived data and are rebuilt on restore.
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from helios_tpu.forward import (FluxState, ModelArrays, Phys,
                                integrate_flux_flat)
from helios_tpu.rce.radiative import (RadLoopState, init_rad_state,
                                      radiation_loop)

_FORMAT_VERSION = 1

# Model-identity fingerprint stored in every checkpoint: a leftover file
# from a differently-configured run at the same path must fail loudly
# instead of resuming into shape errors or silently wrong physics.
_FINGERPRINT_FIELDS = ("nlayer", "nbin", "ny", "iso", "T_star", "T_intern",
                       "g", "a")


def _fingerprint(phys: Phys) -> dict:
    return {"fp__" + f: np.float64(getattr(phys, f))
            for f in _FINGERPRINT_FIELDS}


def _check_fingerprint(phys: Phys, ckpt: dict, path_hint: str = "") -> None:
    mismatches = []
    for f in _FINGERPRINT_FIELDS:
        key = "fp__" + f
        if key not in ckpt:
            return   # pre-fingerprint checkpoint: accept (format v1 era)
        have, want = float(ckpt[key]), float(getattr(phys, f))
        if have != want:
            mismatches.append(f"{f}: checkpoint={have:g} run={want:g}")
    if mismatches:
        raise ValueError(
            "checkpoint does not match this run's configuration "
            f"({'; '.join(mismatches)}). Delete the stale checkpoint "
            "or point -checkpoint_path elsewhere.")

# RadLoopState leaves that fully determine a resume (cache/totals are
# recomputed); FluxState is stored field-wise with a "flux__" prefix.
_STATE_FIELDS = ("T_lay", "T_store", "prefactor", "F_smooth_sum", "abort",
                 "it", "local_limit", "keep_running", "goto_convection",
                 "aborted")

# ConvLoopState restartable leaves (same recompute rule for cache/totals)
_CONV_FIELDS = ("T_lay", "T_store", "prefactor", "F_smooth_sum",
                "conv_layer", "marked_red", "it", "local_limit",
                "keep_running", "aborted")


def save_rad_checkpoint(path: str, state: RadLoopState,
                        phys: Optional[Phys] = None) -> None:
    """Atomically write the restartable radiation-loop state."""
    payload = {"format_version": np.int64(_FORMAT_VERSION),
               "phase": np.bytes_(b"radiation")}
    if phys is not None:
        payload.update(_fingerprint(phys))
    for f in _STATE_FIELDS:
        payload[f] = np.asarray(getattr(state, f))
    for f, v in state.flux._asdict().items():
        payload["flux__" + f] = np.asarray(v)
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".ckpt.tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            np.savez(fh, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_rad_checkpoint(path: str) -> Optional[dict]:
    """Read a checkpoint; None if absent."""
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        if int(z["format_version"]) != _FORMAT_VERSION:
            raise ValueError(
                f"checkpoint {path}: format {int(z['format_version'])}, "
                f"expected {_FORMAT_VERSION}")
        return {k: z[k] for k in z.files if k != "format_version"}


load_conv_checkpoint = load_rad_checkpoint   # same container format


def checkpoint_phase(ckpt: dict) -> str:
    """"radiation" or "convection" (files predating the phase tag are
    radiation checkpoints)."""
    ph = ckpt.get("phase")
    return bytes(ph).decode() if ph is not None else "radiation"


def restore_rad_state(phys: Phys, m: ModelArrays, ckpt: dict,
                      sset=None) -> RadLoopState:
    """Rebuild a full RadLoopState from a checkpoint payload.

    The cell cache and band totals are recomputed from the restored
    temperatures.  Like convection resume, this is bitwise-exact only
    when the saved iteration is a multiple of the 10-step cache-refresh
    cadence (the pipeline rounds its chunk size to enforce this);
    otherwise the resumed cache is fresher than the stale one the
    uninterrupted run would have used -- numerically equivalent, not
    bitwise."""
    if checkpoint_phase(ckpt) != "radiation":
        raise ValueError(
            "checkpoint holds a convection-phase payload; refusing to "
            "restore it as radiation state (stale or misrouted "
            "checkpoint path).")
    _check_fingerprint(phys, ckpt)
    if not bool(ckpt["keep_running"]):
        import warnings
        warnings.warn("resuming from an already-converged checkpoint; "
                      "the loop will exit immediately", stacklevel=2)
    T_lay = jnp.asarray(ckpt["T_lay"])
    fresh = init_rad_state(phys, m, T_lay, sset)
    flux = FluxState(**{f: jnp.asarray(ckpt["flux__" + f])
                        for f in fresh.flux._fields})
    totals = integrate_flux_flat(phys, m, flux, fresh.cache.F_dir)
    return fresh._replace(
        flux=flux, totals=totals,
        **{f: jnp.asarray(ckpt[f]) for f in _STATE_FIELDS})


def save_conv_checkpoint(path: str, state,
                         phys: Optional[Phys] = None) -> None:
    """Atomically write the restartable convection-loop state.

    Unlike the radiation body, the convection body consumes the PREVIOUS
    iteration's band totals and two cache fields (mean molecular mass,
    cumulative additional-heating flux) in the convective adjustment
    BEFORE the 10-step cache refresh, so those are serialized too."""
    payload = {"format_version": np.int64(_FORMAT_VERSION),
               "phase": np.bytes_(b"convection")}
    if phys is not None:
        payload.update(_fingerprint(phys))
    for f in _CONV_FIELDS:
        payload[f] = np.asarray(getattr(state, f))
    for f, v in state.flux._asdict().items():
        payload["flux__" + f] = np.asarray(v)
    for f, v in state.totals._asdict().items():
        payload["totals__" + f] = np.asarray(v)
    payload["cache__meanmolmass_lay"] = np.asarray(
        state.cache.meanmolmass_lay)
    payload["cache__F_add_heat_sum"] = np.asarray(
        state.cache.F_add_heat_sum)
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".ckpt.tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            np.savez(fh, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def restore_conv_state(phys: Phys, m: ModelArrays, ckpt: dict, sset=None):
    """Rebuild a ConvLoopState from a checkpoint payload.

    The bulk cell cache is recomputed from the restored temperatures; the
    stale fields the body reads before the refresh (totals,
    meanmolmass_lay, F_add_heat_sum) come from the checkpoint.  Resume is
    bitwise-exact when the checkpoint interval is a multiple of the
    10-iteration cache-refresh cadence, equivalent-but-not-bitwise
    otherwise.
    """
    from helios_tpu.forward import compute_cells
    from helios_tpu.ops import interp as interp_ops
    from helios_tpu.ops.integrate import FluxTotals
    from helios_tpu.rce.loop import ConvLoopState

    if checkpoint_phase(ckpt) != "convection":
        raise ValueError(
            "checkpoint holds a radiation-phase payload; refusing to "
            "restore it as convection state.")
    _check_fingerprint(phys, ckpt)
    T_lay = jnp.asarray(ckpt["T_lay"])
    T_int = interp_ops.interface_temperatures(T_lay)
    cache = compute_cells(phys, m, T_lay, T_int, sset)
    cache = cache._replace(
        meanmolmass_lay=jnp.asarray(ckpt["cache__meanmolmass_lay"]),
        F_add_heat_sum=jnp.asarray(ckpt["cache__F_add_heat_sum"]))
    flux = FluxState(**{f: jnp.asarray(ckpt["flux__" + f])
                        for f in FluxState._fields})
    totals = FluxTotals(**{f: jnp.asarray(ckpt["totals__" + f])
                           for f in FluxTotals._fields})
    return ConvLoopState(
        cache=cache, flux=flux, totals=totals,
        **{f: jnp.asarray(ckpt[f]) for f in _CONV_FIELDS})


class ConvCheckpointCallback:
    """monitor.run_convection_chunked callback: checkpoint every N
    iterations (and always on the final chunk)."""

    def __init__(self, path: str, every: int,
                 phys: Optional[Phys] = None):
        self.path = path
        self.every = max(int(every), 1)
        self.phys = phys
        self._last_saved = None

    def __call__(self, info) -> None:
        it = int(info.state.it)
        done = not bool(info.state.keep_running)
        if (self._last_saved is None or done
                or it - self._last_saved >= self.every):
            save_conv_checkpoint(self.path, info.state, self.phys)
            self._last_saved = it


class CheckpointCallback:
    """monitor.run_radiation_chunked callback: checkpoint every N
    iterations (and always on the final chunk)."""

    def __init__(self, path: str, every: int,
                 phys: Optional[Phys] = None):
        self.path = path
        self.every = max(int(every), 1)
        self.phys = phys
        self._last_saved = None

    def __call__(self, info) -> None:
        it = int(info.state.it)
        done = not bool(info.state.keep_running)
        if (self._last_saved is None or done
                or it - self._last_saved >= self.every):
            save_rad_checkpoint(self.path, info.state, self.phys)
            self._last_saved = it


def run_radiation_checkpointed(phys: Phys, m: ModelArrays, thermo,
                               T_lay0, *, path: str, every: int = 1000,
                               sset=None) -> RadLoopState:
    """Radiation loop in chunks of ``every`` iterations with a checkpoint
    written after each chunk; resumes from ``path`` if it exists.

    The chunking costs nothing on device (the same compiled while_loop
    body runs with an extra iteration cap) and bounds lost work to one
    chunk on preemption.
    """
    if phys.singlewalk:
        # post-processing mode has no iteration state worth checkpointing
        return radiation_loop(phys, m, thermo, T_lay0, sset=sset)

    ckpt = load_rad_checkpoint(path)
    if ckpt is not None:
        state = restore_rad_state(phys, m, ckpt, sset)
    else:
        state = init_rad_state(phys, m, T_lay0, sset)

    step = jax.jit(lambda s: radiation_loop(
        phys, m, thermo, s.T_lay, max_steps=every, sset=sset, state0=s))

    while bool(state.keep_running):
        state = step(state)
        jax.block_until_ready(state.T_lay)
        save_rad_checkpoint(path, state, phys)
    return state
