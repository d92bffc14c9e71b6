"""Run observability: chunked iteration driver, progress telemetry,
realtime plotting, structured metrics, profiler traces.

The reference's observability is print-based (converged-layer counts
computation.py:934-935, wall time per 100 iterations :902-905) plus a
live matplotlib panel every ``n_plot`` iterations
(realtime_plotting.py:37-151).  Here the RCE loop is one device-side
`lax.while_loop`, so observation happens at chunk boundaries: the loop
runs ``chunk_iters`` device-resident iterations per host sync (the same
``state0`` continuation mechanism the checkpointer uses), then each
registered callback sees the current state.  A chunk costs one extra
host sync, once per ``chunk_iters`` iterations.

Built-in callbacks:
  - ProgressPrinter: reference-style progress lines
  - MetricsWriter:   one JSON object per chunk to a .jsonl file
  - PlotCallback:    drives plotting.Plot (live or saved frames)
Profiling: ``profile_trace(dir)`` wraps a chunk in jax.profiler.trace
for perfetto/tensorboard inspection.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, List, NamedTuple, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from helios_tpu.forward import ModelArrays, Phys
from helios_tpu.rce.radiative import (RadLoopState, init_rad_state,
                                      radiation_loop)


class ChunkInfo(NamedTuple):
    state: RadLoopState
    its_done: int          # iterations in this chunk
    wall_s: float          # wall time of this chunk
    phase: str             # "radiation" (convection monitors separately)
    includes_compile: bool = False   # first chunk: wall_s includes XLA
    #                                  compilation, so ms/iter is not
    #                                  steady-state


Callback = Callable[[ChunkInfo], None]


def run_radiation_chunked(phys: Phys, m: ModelArrays, thermo, T_lay0, *,
                          chunk_iters: Optional[int] = 100, sset=None,
                          callbacks: Sequence[Callback] = (),
                          state0: Optional[RadLoopState] = None,
                          profile_dir: Optional[str] = None,
                          mesh=None) -> RadLoopState:
    """Radiation loop with host observation every ``chunk_iters`` steps.

    Identical trajectory to the single while_loop (the chunk cap is the
    only extra predicate); callbacks run between chunks on host.

    ``mesh``: run the loop spectrally sharded over this device mesh
    (``m``/``sset`` must already be placed with
    parallel.sharding.place_model/place_species); callbacks and
    checkpointing work unchanged -- every field they read is
    replica-identical, and np.asarray gathers sharded leaves.
    """
    if mesh is not None:
        from helios_tpu.parallel import sharding as shd
        sarr = shd.sset_arrays(sset)
        rad_init, rad_run, _, _ = shd.production_runners(
            phys, mesh, thermo, sset, chunk_iters=chunk_iters)
        state = state0 if state0 is not None else rad_init(m, sarr,
                                                           T_lay0)
        if phys.singlewalk:
            return rad_run(m, sarr, state)
        step = lambda s: rad_run(m, sarr, s)
    else:
        state = state0 if state0 is not None else init_rad_state(
            phys, m, T_lay0, sset)
        if phys.singlewalk:
            return radiation_loop(phys, m, thermo, T_lay0, sset=sset)

        step = jax.jit(lambda s: radiation_loop(
            phys, m, thermo, s.T_lay, max_steps=chunk_iters, sset=sset,
            state0=s))

    # profile the SECOND chunk: the first includes XLA compilation, which
    # would dominate the trace (and the first record's ms/iter, which is
    # flagged via includes_compile instead)
    chunk_idx = 0
    while bool(state.keep_running):
        it_before = int(state.it)
        t0 = time.perf_counter()
        if chunk_idx == 1 and profile_dir:
            with jax.profiler.trace(profile_dir):
                state = step(state)
                jax.block_until_ready(state.T_lay)
        else:
            state = step(state)
            jax.block_until_ready(state.T_lay)
        info = ChunkInfo(state=state, its_done=int(state.it) - it_before,
                         wall_s=time.perf_counter() - t0,
                         phase="radiation",
                         includes_compile=(chunk_idx == 0))
        for cb in callbacks:
            cb(info)
        chunk_idx += 1
    return state


def run_convection_chunked(phys: Phys, m: ModelArrays, thermo, rad, *,
                           chunk_iters: Optional[int] = 100, sset=None,
                           callbacks: Sequence[Callback] = (),
                           state0=None, mesh=None):
    """Convection loop with host observation every ``chunk_iters`` steps
    (same continuation mechanism as run_radiation_chunked).  ``state0``
    resumes from a restored ConvLoopState instead of entering from the
    radiation result.  ``mesh``: spectrally sharded execution (see
    run_radiation_chunked)."""
    from helios_tpu.rce.loop import convection_loop

    if mesh is not None:
        from helios_tpu.parallel import sharding as shd
        sarr = shd.sset_arrays(sset)
        _, _, conv_enter, conv_run = shd.production_runners(
            phys, mesh, thermo, sset, chunk_iters=chunk_iters)
        state = state0 if state0 is not None else conv_enter(m, sarr, rad)
        step = lambda s: conv_run(m, sarr, s)
    else:
        state = state0 if state0 is not None else jax.jit(
            lambda r: convection_loop(phys, m, thermo, r, max_steps=0,
                                      sset=sset))(rad)

        step = jax.jit(lambda s: convection_loop(
            phys, m, thermo, rad, max_steps=chunk_iters, sset=sset,
            state0=s))

    chunk_idx = 0
    while bool(state.keep_running):
        it_before = int(state.it)
        t0 = time.perf_counter()
        state = step(state)
        jax.block_until_ready(state.T_lay)
        info = ChunkInfo(state=state, its_done=int(state.it) - it_before,
                         wall_s=time.perf_counter() - t0,
                         phase="convection",
                         includes_compile=(chunk_idx == 0))
        for cb in callbacks:
            cb(info)
        chunk_idx += 1
    return state


def _converged_layers(state) -> int:
    """Converged-layer count for either loop state: the radiation loop
    carries per-layer abort flags; the convection loop tracks the
    non-converged radiative layers as marked_red."""
    if hasattr(state, "abort"):
        return int(jnp.sum(state.abort))
    return int(jnp.sum(~state.marked_red))


class ProgressPrinter:
    """Reference-style progress lines (computation.py:902-905, 934-935)."""

    def __init__(self, nlayer: int, stream=None):
        self.nlayer = nlayer
        self.stream = stream

    def __call__(self, info: ChunkInfo) -> None:
        s = info.state
        n_conv = _converged_layers(s)
        line = (f"[{info.phase[:4]}] iteration {int(s.it):6d} "
                f"| converged layers "
                f"{n_conv}/{self.nlayer + 1} | criterion "
                f"{float(s.local_limit):.1e} | "
                f"{info.wall_s / max(info.its_done, 1) * 1e3:6.2f} ms/iter"
                f" ({info.its_done / max(info.wall_s, 1e-9):7.1f} it/s)"
                + (" [incl. compile]" if info.includes_compile else ""))
        print(line, file=self.stream, flush=True)


class MetricsWriter:
    """Structured metrics: one JSON object per chunk, append-only.

    Opens in append mode so a resumed (checkpoint-restored) run keeps the
    previous history; each construction writes a run-start marker record
    instead of truncating."""

    def __init__(self, path: str):
        self.path = path
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(self.path, "a") as fh:
            fh.write(json.dumps({"event": "run_start",
                                 "time": time.time()}) + "\n")

    def __call__(self, info: ChunkInfo) -> None:
        s = info.state
        rec = {
            "phase": info.phase,
            "iteration": int(s.it),
            "chunk_iters": info.its_done,
            "wall_s": round(info.wall_s, 6),
            "it_per_s": round(info.its_done / max(info.wall_s, 1e-9), 2),
            "includes_compile": bool(info.includes_compile),
            "converged_layers": _converged_layers(s),
            "criterion": float(s.local_limit),
            "T_min": float(jnp.min(s.T_lay)),
            "T_max": float(jnp.max(s.T_lay)),
            "F_net_toa": float(s.totals.F_net[-1]),
        }
        with open(self.path, "a") as fh:
            fh.write(json.dumps(rec) + "\n")


class PlotCallback:
    """Realtime TP/flux panel per chunk (realtime_plotting.py cadence is
    per-n_plot-iterations; here the natural cadence is per chunk)."""

    def __init__(self, phys: Phys, interactive: bool = True,
                 save_dir: Optional[str] = None):
        from helios_tpu.plotting import Plot
        self.phys = phys
        self.plot = Plot(interactive=interactive)
        self.save_dir = save_dir
        if save_dir:
            os.makedirs(save_dir, exist_ok=True)

    def __call__(self, info: ChunkInfo) -> None:
        s = info.state
        save = (os.path.join(self.save_dir,
                             f"frame_{int(s.it):06d}.png")
                if self.save_dir else None)
        if hasattr(s, "abort"):
            marked_red = ~np.asarray(s.abort)
            conv_layer = None
        else:
            marked_red = np.asarray(s.marked_red)
            conv_layer = np.asarray(s.conv_layer)
        self.plot.plot_tp_and_flux(
            T_lay=np.asarray(s.T_lay), F_net=np.asarray(s.totals.F_net),
            F_intern=self.phys.F_intern, p_boa=self.phys.p_boa,
            p_toa=self.phys.p_toa,
            marked_red=marked_red, conv_layer=conv_layer,
            iter_value=int(s.it), savefig=save)
        if self.plot.interactive:
            import matplotlib.pyplot as plt
            plt.pause(0.001)


class DebugChecker:
    """``debug = yes`` runtime diagnostics.

    The reference's debug mode printf-warns from inside the CUDA kernels
    on negative spectral fluxes (kernels.cu:1456-1459) and relies on the
    user watching stdout; inside a jitted while_loop there is no such
    hook, so this analogue checks the loop state at every chunk
    boundary: finiteness assertions on temperatures and fluxes (raising
    FloatingPointError like jax.config.debug_nans would) and
    negative-flux counters printed as warnings.
    """

    def __init__(self, stream=None):
        self.stream = stream

    def __call__(self, info: ChunkInfo) -> None:
        s = info.state
        it = int(s.it)
        T = np.asarray(s.T_lay)
        if not np.all(np.isfinite(T)):
            raise FloatingPointError(
                f"[debug] non-finite temperature at iteration {it}: "
                f"{T}")
        for name in ("F_down", "F_up"):
            arr = np.asarray(getattr(s.flux, name))
            if not np.all(np.isfinite(arr)):
                raise FloatingPointError(
                    f"[debug] non-finite {name} at iteration {it}")
            neg = int((arr < 0).sum())
            if neg:
                print(f"[debug] WARNING: {neg} negative {name} values "
                      f"at iteration {it} (kernels.cu:1456-1459 "
                      "debug warning analogue)",
                      file=self.stream, flush=True)


class CouplingTPWriter:
    """Mid-run coupling TP writes every ``interval`` iterations
    (reference computation.py:967-971, write.py:716-771): external
    chemistry codes watch this file to iterate against a live HELIOS run.
    """

    def __init__(self, path: str, nlayer: int, p_lay, p_int,
                 interval: int):
        self.path = path
        self.nlayer = nlayer
        self.p_lay = np.asarray(p_lay)
        self.p_int = np.asarray(p_int)
        self.interval = max(int(interval), 1)
        self._last = None

    def __call__(self, info: ChunkInfo) -> None:
        from helios_tpu.io.writers import write_tp_coupling_snapshot
        it = int(info.state.it)
        if self._last is not None and it - self._last < self.interval:
            return
        self._last = it
        write_tp_coupling_snapshot(
            self.path, self.nlayer, self.p_lay, self.p_int,
            np.asarray(info.state.T_lay))
