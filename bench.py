"""Benchmarks: throughput of the hot paths on the reference workload.

    python bench.py

Runs on one NVIDIA GPU, in this one process, and fails without one.  It
first prints the card's name, power limit and the device count, then one
JSON line per metric, each naming the device it ran on:

  fluxpass_gridcells_per_s_per_chip   full forward flux pass (opacity
      interpolation -> transmission -> beam -> sweep -> integration), iso,
      105 layers x 385 bins x 20 Gauss points, fp64
  fluxpass_noniso_gridcells_per_s     the same, non-isothermal
  fluxpass_matrix_gridcells_per_s     the same with the Thomas solve
  beam_zenith_ms                      zenith-corrected direct beam
  ro_mix_ms                           one on-the-fly Random Overlap pass
  rce_iterations_per_s                radiative iterations, iso premixed
  rce_iterations_per_s_on_the_fly     the same with on-the-fly mixing
  flagship_*                          the flagship run to convergence
                                      (workloads.FLAGSHIP): seconds,
                                      iterations and rate of each phase
  ensemble_*                          4 flagship-sized planets, one program

Repeated work is chained inside one jitted program with a traced trip
count (one compile for every count), and every timed region ends in
`block_until_ready`.
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

_TARGET_S = 1.0       # minimum timed-region length
_DEVICE = {}


def _emit(metric, value, unit):
    print(json.dumps({"metric": metric, "value": float(value),
                      "unit": unit, "device": _DEVICE}), flush=True)


def _fail(metric, e):
    print(json.dumps({"metric": metric, "error": str(e)[:300],
                      "device": _DEVICE}), flush=True)


def _timed(f, k) -> float:
    import jax
    t0 = time.perf_counter()
    jax.block_until_ready(f(k))
    return time.perf_counter() - t0


def _calibrated(f, k0: int, reps: int = 3):
    """Seconds per unit of ``f(k)`` (k units chained in one program; ``f``
    must take k as a traced argument).  k grows until one call spans
    _TARGET_S; returns the median of ``reps`` calls over k."""
    _timed(f, k0)                        # compile + warm
    k = k0
    while True:
        dt = _timed(f, k)
        if dt >= 0.7 * _TARGET_S or k >= (1 << 20):
            break
        k = max(k + 1, min(int(k * _TARGET_S / max(dt, 1e-4) * 1.2),
                           k * 8))
    ts = sorted([dt] + [_timed(f, k) for _ in range(reps - 1)])
    return ts[len(ts) // 2] / k


# --------------------------------------------------------------------------- #
# forward flux pass
# --------------------------------------------------------------------------- #

def _workload(iso=True, **over):
    from helios_tpu import workloads
    from helios_tpu.config import HeliosConfig
    from helios_tpu.forward import build_model
    from helios_tpu.io.opacity import synthetic_premixed_table

    table = synthetic_premixed_table(nbin=workloads.NBIN, ny=workloads.NY)
    kw = dict(
        planet="manual", g=2140.0, a=0.03142, R_planet=1.138,
        R_star=0.805, T_star=5040.0, T_intern=100.0,
        scattering="yes", direct_beam="no", convection="no",
        run_type="iterative", iso_input="yes" if iso else "no")
    kw.update(over)
    return build_model(HeliosConfig(**kw).finalize(), table)


def bench_fluxpass(iso=True, **over):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from helios_tpu.forward import forward_fluxes

    phys, arrays = _workload(iso=iso, **over)
    T_lay = jnp.asarray(np.linspace(1800.0, 600.0, phys.nlayer + 1))

    @jax.jit
    def fwd(m, T, k):
        def body(_, T):
            _flux, totals, _cache = forward_fluxes(phys, m, T)
            return T + 1e-12 * totals.F_net   # data-dependent chaining
        return jax.lax.fori_loop(0, k, body, T)

    per_pass = _calibrated(lambda k: fwd(arrays, T_lay, k), 20)
    return phys.nlayer * phys.nbin * phys.ny / per_pass


def bench_beam_zenith():
    """Zenith-geometry-corrected direct beam (the terminator/rocky-planet
    path, kernels.cu:1265-1362): one [I, L] x [L, S] triangular
    contraction in mul+sum form."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from helios_tpu import fastpath as fp
    from helios_tpu.ops.beam import _mu_star_matrix

    L, S = 105, 385 * 20
    rng = np.random.default_rng(0)
    dtau = jnp.asarray(np.exp(rng.normal(-2.0, 1.0, (L, S))))
    z_lay = jnp.asarray(np.sort(rng.uniform(0.0, 5e8, L)))
    planck_star = jnp.asarray(rng.uniform(1e3, 1e5, S))
    mu_mat = _mu_star_matrix(z_lay, -0.2, 7e9, 1, L + 1, dtau.dtype)
    mask = (jnp.arange(L)[None, :] >= jnp.arange(L + 1)[:, None])
    W = jnp.where(mask, 1.0 / mu_mat, 0.0)

    @jax.jit
    def beam(dt, k):
        def body(_, dt):
            F = fp.fdir_iso_flat(planck_star, dt, W, mu_star=-0.2,
                                 R_star=7e10, a=1.5e12, dir_beam=1)
            return dt * (1.0 + 1e-12 * jnp.tanh(F[0]))
        return jax.lax.fori_loop(0, k, body, dt)

    return _calibrated(lambda k: beam(dtau, k), 10) * 1e3


# --------------------------------------------------------------------------- #
# RCE loops
# --------------------------------------------------------------------------- #
#
# Iteration rates and whole runs share one set of compiled programs per
# workload: a jitted state init and fixed-size chunk continuations of
# radiation_loop / convection_loop.  Each chunk ends in an int(s.it)
# fetch, as the production chunked runner's does.

_CHUNK = 400
_RAD_CAP = 4000
_CONV_CAP = 4000


class _Runner:
    def __init__(self, phys, arrays, thermo=None, sset=None,
                 chunk=_CHUNK):
        import jax

        from helios_tpu.rce.loop import convection_loop
        from helios_tpu.rce.radiative import init_rad_state, radiation_loop

        self.init = jax.jit(
            lambda t: init_rad_state(phys, arrays, t, sset))
        self.rad_chunk = jax.jit(
            lambda s: radiation_loop(phys, arrays, thermo, None,
                                     max_steps=chunk, sset=sset,
                                     state0=s))
        self.conv_entry = jax.jit(
            lambda r: convection_loop(phys, arrays, thermo, r,
                                      max_steps=chunk, sset=sset))
        self.conv_chunk = jax.jit(
            lambda s: convection_loop(phys, arrays, thermo, None,
                                      max_steps=chunk, sset=sset,
                                      state0=s))


def _timed_chunk(step, s):
    """One chunk; returns (iterations/s, or 0 if the loop had stopped,
    new state)."""
    it0 = int(s.it)
    t0 = time.perf_counter()
    s = step(s)
    d = int(s.it) - it0
    dt = time.perf_counter() - t0
    return (d / dt if d else 0.0), s


def bench_rce_iterations(sset_workload=False):
    """Radiation while_loop iterations per second: sweep every step,
    cell-cache refresh every 10th, temperature update and convergence
    predicates.  With ``sset_workload`` the refresh mixes opacities on
    the fly (Random Overlap) instead of reading the premixed table."""
    import jax.numpy as jnp
    import numpy as np

    if sset_workload:
        from helios_tpu import workloads
        from helios_tpu.config import HeliosConfig
        from helios_tpu.forward import build_model

        donor, sset = workloads.onthefly_species()
        cfg = HeliosConfig(
            planet="manual", g=2140.0, a=0.03142, R_planet=1.138,
            R_star=0.805, T_star=5040.0, T_intern=100.0,
            scattering="yes", direct_beam="no", convection="no",
            run_type="iterative", iso_input="yes",
            opacity_mixing="on-the-fly").finalize()
        phys, arrays = build_model(cfg, donor)
    else:
        phys, arrays = _workload(iso=True)
        sset = None
    r = _Runner(phys, arrays, sset=sset)
    T0 = jnp.asarray(np.linspace(1800.0, 600.0, phys.nlayer + 1))

    s = r.init(T0)
    _rate, s = _timed_chunk(r.rad_chunk, s)     # compile + warm
    rates = []
    for _ in range(2):
        rate, s = _timed_chunk(r.rad_chunk, s)
        rates.append(rate)
    assert min(rates) > 0, "radiation loop stopped before the timed chunks"
    return max(rates)


def bench_ro_mix():
    """One on-the-fly Random Overlap mixing pass (2 absorbers, 105
    layers x 385 bins x 20 y)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from helios_tpu import chem, workloads
    from helios_tpu.io.opacity import gauss_legendre_ypoints

    L = 105
    donor, sset = workloads.onthefly_species(L)
    _, gw = gauss_legendre_ypoints(workloads.NY)
    T = jnp.asarray(np.linspace(1800.0, 600.0, L))
    p = jnp.asarray(np.geomspace(1e9, 1e-1, L))
    wave, gy = jnp.asarray(donor.wave_centers), jnp.asarray(donor.gauss_y)
    gw = jnp.asarray(gw)

    @jax.jit
    def mix(T, k):
        def body(_, T):
            opac, _scat, _mmm = chem.mixed_opacities(
                sset, T, p, wave, gw, gy, ro_method=1, scat=0)
            return T * (1.0 + 1e-12 * jnp.tanh(opac[0, 0, 0]))
        return jax.lax.fori_loop(0, k, body, T)

    return _calibrated(lambda k: mix(T, k), 5) * 1e3


def bench_flagship():
    """Full RCE run to convergence (radiative + convective phase) on the
    flagship workload.  Run twice; the first compiles the chunk programs,
    the second gives the numbers."""
    import jax.numpy as jnp
    import numpy as np

    from helios_tpu import workloads
    from helios_tpu.config import HeliosConfig
    from helios_tpu.forward import build_model
    from helios_tpu.rce.radiative import make_const_thermo

    cfg = HeliosConfig(**workloads.FLAGSHIP).finalize()
    phys, arrays = build_model(cfg, workloads.flagship_table())
    r = _Runner(phys, arrays, thermo=make_const_thermo(cfg.kappa_value))
    T0 = jnp.asarray(workloads.flagship_start_profile(
        np.asarray(arrays.p_lay)))

    def one_run():
        t_start = time.perf_counter()
        s = r.init(T0)
        while True:
            s = r.rad_chunk(s)
            if not bool(s.keep_running) or int(s.it) >= _RAD_CAP:
                break
        rad_its = int(s.it)
        t_rad = time.perf_counter()
        c = r.conv_entry(s)
        while bool(c.keep_running) and int(c.it) < _CONV_CAP:
            c = r.conv_chunk(c)
        conv_its = int(c.it)
        t_end = time.perf_counter()
        converged = (rad_its < _RAD_CAP and 0 < conv_its < _CONV_CAP
                     and not bool(c.keep_running))
        return [("flagship_run_seconds", t_end - t_start, "s"),
                ("flagship_radiative_iterations", rad_its, "it"),
                ("flagship_convective_iterations", conv_its, "it"),
                ("flagship_run_converged", int(converged), "flag"),
                ("rce_iterations_per_s_noniso", rad_its / (t_rad - t_start),
                 "it/s"),
                ("conv_iterations_per_s", conv_its / (t_end - t_rad),
                 "it/s")]

    one_run()
    return one_run()


def bench_ensemble():
    """Batched-planet throughput: 4 flagship-sized members (noniso +
    convection) as one vmapped device program; members differ in their
    opacity scale.  The first call compiles, the second is measured."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from helios_tpu import workloads
    from helios_tpu.config import HeliosConfig
    from helios_tpu.forward import build_model
    from helios_tpu.parallel.ensemble import stack_models
    from helios_tpu.rce.loop import convection_loop
    from helios_tpu.rce.radiative import make_const_thermo, radiation_loop

    n = 4
    cfg = HeliosConfig(**workloads.FLAGSHIP).finalize()
    thermo = make_const_thermo(cfg.kappa_value)
    models = []
    for i in range(n):
        table = workloads.flagship_table()
        table.kpoints *= 1.0 + 0.05 * i
        phys, arrays = build_model(cfg, table)
        models.append(arrays)
    m_stacked = stack_models(models)
    T0 = workloads.flagship_start_profile(np.asarray(models[0].p_lay))
    T0s = jnp.asarray(np.tile(T0, (n, 1)))

    rad_fn = jax.jit(jax.vmap(
        lambda m, t: radiation_loop(phys, m, thermo, t,
                                    max_steps=_RAD_CAP)))
    conv_fn = jax.jit(jax.vmap(
        lambda m, r: convection_loop(phys, m, thermo, r,
                                     max_steps=_CONV_CAP)))

    def one_run():
        t0 = time.perf_counter()
        rad = rad_fn(m_stacked, T0s)
        conv = jax.block_until_ready(conv_fn(m_stacked, rad))
        wall = time.perf_counter() - t0
        its = int(np.sum(np.asarray(rad.it)) + np.sum(np.asarray(conv.it)))
        return wall, its

    one_run()
    wall, its = one_run()
    return [("ensemble_planets_per_hour", n * 3600.0 / wall, "planets/h"),
            ("ensemble_batched_iterations_per_s", its / wall, "it/s")]


def main():
    from helios_tpu.compile_cache import enable_compile_cache
    enable_compile_cache()
    import jax

    if jax.default_backend() != "gpu":
        sys.exit(f"bench.py needs an NVIDIA GPU; JAX's backend is "
                 f"{jax.default_backend()!r}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    devices = jax.devices()
    _DEVICE.update(platform=devices[0].platform,
                   kind=devices[0].device_kind, count=len(devices))
    print(json.dumps({"nvidia_smi": smi.splitlines(), "device": _DEVICE}),
          flush=True)

    sections = [
        ("fluxpass_gridcells_per_s_per_chip",
         lambda: bench_fluxpass(iso=True), "cells/s"),
        ("fluxpass_noniso_gridcells_per_s",
         lambda: bench_fluxpass(iso=False), "cells/s"),
        ("fluxpass_matrix_gridcells_per_s",
         lambda: bench_fluxpass(iso=True, flux_calc_method="matrix"),
         "cells/s"),
        ("beam_zenith_ms", bench_beam_zenith, "ms"),
        ("ro_mix_ms", bench_ro_mix, "ms"),
        ("rce_iterations_per_s", bench_rce_iterations, "it/s"),
        ("rce_iterations_per_s_on_the_fly",
         lambda: bench_rce_iterations(sset_workload=True), "it/s"),
        ("flagship", bench_flagship, None),
        ("ensemble", bench_ensemble, None),
    ]
    for name, fn, unit in sections:
        try:
            res = fn()
        except Exception as e:      # report and go on to the next section
            _fail(name, e)
            continue
        for metric, value, u in (res if unit is None
                                 else [(name, res, unit)]):
            _emit(metric, value, u)


if __name__ == "__main__":
    main()
