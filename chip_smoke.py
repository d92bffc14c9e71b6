#!/usr/bin/env python3
"""Smoke run of the main path on an NVIDIA GPU.

    python chip_smoke.py           # one card
    python chip_smoke.py --multi   # four cards: the multi-device paths only

One card: runs the flagship RCE configuration (105 layers x 385 bins x 20
Gauss points, fp64, non-isothermal, scattering and convection, premixed
table) to convergence through `pipeline.run`, which writes its outputs
under output/; times and checks each kernel of that path against its
plain XLA reference at the flagship width (the flux sweep kernels against
`lax.scan`, the flagship run with the sweep kernel against the run
without it); times one matrix-method solve and one on-the-fly Random
Overlap pass, the latter checked against tests/reference_mixing.py; and
runs the tests marked `gpu`.

--multi: the flagship run spread over 4 cards (n_spectral_shards=4)
against the same run on one card, and a 4-planet batch
(n_planet_batch=4) against each member run alone.

Every line but the last is a report.  The last line is one JSON object,
{"ok": true, "device": {...}}, printed only when every phase ran and every
comparison is within its tolerance.  Without a GPU the script exits with
a non-zero code before any phase.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "output")

_failures = []

# Two converged runs of the flagship whose trajectories differ (the sweep
# kernel against the scan, 4 cards against 1) stop once every layer's net
# flux is within the 1e-8 relative criterion; their final T_lay then agree
# to about 1e-6, not to rounding.
FINAL_T_TOL = 1e-6


def log(*args):
    print(*args, flush=True)


def rel_err(got, want) -> float:
    """Largest elementwise relative error |got - want| / |want|."""
    import numpy as np
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    tiny = np.finfo(want.dtype).tiny
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), tiny)))


def compare(name: str, err: float, tol: float):
    ok = bool(err <= tol)       # NaN fails
    log(f"  compare {name}: max rel err {err:.3e} "
        f"(tolerance {tol:.0e}) {'ok' if ok else 'FAILED'}")
    if not ok:
        _failures.append(name)


def require(name: str, cond: bool):
    log(f"  check {name}: {'ok' if cond else 'FAILED'}")
    if not cond:
        _failures.append(name)


def timed(f, reps: int = 3) -> float:
    """Median wall seconds of ``f()`` after one warm call."""
    import jax
    jax.block_until_ready(f())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(f())
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2]


class CompileClock:
    """Seconds JAX spends tracing, lowering and compiling, summed from its
    monitoring events."""
    EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
              "/jax/core/compile/jaxpr_to_mlir_module_duration",
              "/jax/core/compile/backend_compile_duration")

    def __init__(self):
        import jax
        self.seconds = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **_):
        if event in self.EVENTS:
            self.seconds += duration


def memory_line(compiled) -> str:
    m = compiled.memory_analysis()
    mib = lambda b: f"{b / 2 ** 20:.1f} MiB"    # noqa: E731
    return (f"arguments {mib(m.argument_size_in_bytes)}, outputs "
            f"{mib(m.output_size_in_bytes)}, temporaries "
            f"{mib(m.temp_size_in_bytes)}, aliased "
            f"{mib(m.alias_size_in_bytes)}, code "
            f"{mib(m.generated_code_size_in_bytes)}")


# --------------------------------------------------------------------------- #
# phases on one card
# --------------------------------------------------------------------------- #

def phase_sweeps():
    """Sweep kernels against the lax.scan form at 105 x 7700."""
    from functools import partial

    import jax
    import jax.numpy as jnp
    import numpy as np

    from helios_tpu import fastpath as fp

    log("phase sweeps: fused sweep kernels vs lax.scan, 105 layers x 7700 "
        "columns")
    L, S = 105, 385 * 20
    rng = np.random.default_rng(0)
    for dtype, tol in ((jnp.float64, 1e-12), (jnp.float32, 1e-5)):
        u = lambda *shape, lo=0.0, hi=1.0: jnp.asarray(   # noqa: E731
            rng.uniform(lo, hi, shape), dtype)
        coeff = lambda: u(L, S, lo=0.3, hi=0.8)           # noqa: E731
        src = lambda: u(L, S, hi=1e3)                     # noqa: E731
        iso = fp.FlatIsoCoeffs(
            a=coeff(), b_nm=u(L, S, hi=0.1), src_down=src(), src_up=src(),
            boa_refl=u(S, hi=0.3), boa_emis=u(S, hi=1e4), toa=u(S, hi=1e3))
        non = fp.FlatNonIsoCoeffs(
            a_up=coeff(), b_up=u(L, S, hi=0.1), src_up_down=src(),
            src_up_up=src(), a_low=coeff(), b_low=u(L, S, hi=0.1),
            src_low_down=src(), src_low_up=src(), boa_refl=u(S, hi=0.3),
            boa_emis=u(S, hi=1e4), toa=u(S, hi=1e3))
        F_dir0, F_up = u(S, hi=1e3), u(L + 1, S, hi=1e4)
        Fc_up = u(L, S, hi=1e4)
        name = jnp.dtype(dtype).name
        for n_passes in (4, 1001):
            reps = 3 if n_passes == 4 else 1
            for label, solve, args in (
                    ("iso", fp.fband_iso_flat, (iso, F_dir0, F_up)),
                    ("noniso", fp.fband_noniso_flat,
                     (non, F_dir0, F_up, Fc_up))):
                scan = jax.jit(partial(solve, n_passes=n_passes,
                                       use_pallas=False))
                kern = jax.jit(partial(solve, n_passes=n_passes,
                                       use_pallas=True))
                t_scan = timed(lambda: scan(*args), reps)
                t_kern = timed(lambda: kern(*args))
                log(f"  {label} {name} n_passes={n_passes}: lax.scan "
                    f"{t_scan * 1e3:.3f} ms, kernel {t_kern * 1e3:.3f} ms "
                    f"({t_scan / t_kern:.1f}x)")
                err = max(rel_err(g, w)
                          for g, w in zip(kern(*args), scan(*args)))
                compare(f"sweep {label} {name} n_passes={n_passes}", err,
                        tol)


def flagship_programs(cfg, table, label):
    """Compile and run the loop programs of `pipeline.run` for ``cfg``
    ahead of time.  Returns a dict: the model, the radiative and final
    states, the run seconds."""
    import jax
    import jax.numpy as jnp

    from helios_tpu import pipeline

    phys, arrays, _ = pipeline.prepare_model(cfg, table)
    thermo = pipeline.make_thermo(cfg)
    T0 = jnp.asarray(pipeline.initial_temperatures(cfg, phys, arrays))

    t0 = time.perf_counter()
    rad_c = pipeline.radiation_program(phys, thermo).lower(
        arrays, T0).compile()
    t_rc = time.perf_counter() - t0
    t0 = time.perf_counter()
    rad = jax.block_until_ready(rad_c(arrays, T0))
    t_rad = time.perf_counter() - t0

    t0 = time.perf_counter()
    conv_c = pipeline.convection_program(phys, thermo).lower(
        arrays, rad).compile()
    t_cc = time.perf_counter() - t0
    t0 = time.perf_counter()
    conv = jax.block_until_ready(conv_c(arrays, rad))
    t_conv = time.perf_counter() - t0

    rad_its, conv_its = int(rad.it), int(conv.it)
    converged = not bool(rad.aborted) and not bool(conv.aborted)
    log(f"  {label}: compile {t_rc + t_cc:.1f} s (radiative {t_rc:.1f}, "
        f"convective {t_cc:.1f}); run {t_rad + t_conv:.3f} s (radiative "
        f"{t_rad:.3f} s for {rad_its} iterations, convective {t_conv:.3f} "
        f"s for {conv_its} iterations); converged {converged}")
    log(f"  {label} radiative program memory: {memory_line(rad_c)}")
    log(f"  {label} convective program memory: {memory_line(conv_c)}")
    require(f"{label} ran both phases and converged",
            converged and rad_its > 0 and conv_its > 0)

    # the same executables again: the device run itself is deterministic
    again = conv_c(arrays, rad_c(arrays, T0))
    compare(f"{label}, second run of the same programs",
            rel_err(again.T_lay, conv.T_lay), 0.0)
    return dict(phys=phys, arrays=arrays, T0=T0, rad=rad, conv=conv,
                seconds=t_rad + t_conv)


def phase_flagship():
    """The flagship run: with the sweep kernel and without it, then
    through pipeline.run, which writes the outputs."""
    import jax
    import numpy as np

    from helios_tpu import host_physics as hp
    from helios_tpu import pipeline, workloads
    from helios_tpu.forward import forward_fluxes

    log("phase flagship: 105 x 385 x 20 fp64, non-isothermal, scattering, "
        "convection, premixed table")
    table = workloads.flagship_table()
    cfg_k = workloads.flagship_config(OUT, "flagship")
    cfg_s = workloads.flagship_config(OUT, "flagship_scan", use_pallas="no")
    k = flagship_programs(cfg_k, table, "with sweep kernel")
    s = flagship_programs(cfg_s, table, "with lax.scan sweep")
    log(f"  flagship run seconds: kernel {k['seconds']:.3f}, lax.scan "
        f"{s['seconds']:.3f} ({s['seconds'] / k['seconds']:.2f}x)")

    # one forward pass at the start profile: the kernel inside the full
    # program, on the flagship's own coefficients
    fwd = lambda run: jax.jit(                          # noqa: E731
        lambda m, t: forward_fluxes(run["phys"], m, t)[:2])(
            run["arrays"], run["T0"])
    (fs_k, tot_k), (fs_s, tot_s) = fwd(k), fwd(s)
    compare("flagship forward pass fluxes, kernel vs lax.scan",
            max(rel_err(a, b) for a, b in zip(fs_k + tot_k, fs_s + tot_s)),
            1e-12)
    compare("flagship T_lay after the radiative phase, kernel vs lax.scan",
            rel_err(k["rad"].T_lay, s["rad"].T_lay), 1e-6)
    compare("flagship final T_lay, kernel vs lax.scan",
            rel_err(k["conv"].T_lay, s["conv"].T_lay), FINAL_T_TOL)

    clock = CompileClock()
    t0 = time.perf_counter()
    out = pipeline.run(cfg_k, table=table)
    wall = time.perf_counter() - t0
    r = out.result
    rad_its = int(out.rad.it)
    conv_its = int(out.conv.it) if out.conv is not None else 0
    converged = (out.conv is not None and not bool(out.rad.aborted)
                 and not bool(out.conv.aborted))
    log(f"  pipeline.run: {wall:.2f} s wall, of which {clock.seconds:.2f} s "
        f"tracing and compiling; radiative {rad_its} + convective "
        f"{conv_its} iterations; converged {converged}")
    require("pipeline.run ran both phases and converged",
            converged and rad_its > 0 and conv_its > 0)
    require("pipeline.run T_lay finite, one value per layer and surface",
            r.T_lay.shape == (r.nlayer + 1,)
            and bool(np.all(np.isfinite(r.T_lay))))
    # the same loop programs on the same inputs
    compare("pipeline.run T_lay after the radiative phase vs ahead-of-time "
            "programs", rel_err(out.rad.T_lay, k["rad"].T_lay), 1e-12)
    compare("pipeline.run final T_lay vs ahead-of-time programs",
            rel_err(r.T_lay, k["conv"].T_lay), 1e-12)
    imbalance = hp.global_energy_balance(
        r.F_net, r.F_add_heat_sum, r.F_smooth_sum, r.F_intern,
        r.F_down_tot[r.nlayer])
    log(f"  global energy imbalance: {imbalance * 1e6:.3f} ppm")
    # the standard output set (writers.write_all) of a run without
    # clouds, phase table or relaxed criterion: 20 files
    files = sorted(os.listdir(r.out))
    log(f"  outputs: {len(files)} files in {os.path.relpath(r.out, ROOT)}")
    require("standard output set written", len(files) == 20)


def phase_matrix():
    """One matrix-method (Thomas) solve at the flagship shape."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from helios_tpu import workloads
    from helios_tpu.config import HeliosConfig
    from helios_tpu.forward import (build_model, compute_cells,
                                    init_flux_state, solve_fluxes)
    from helios_tpu.ops import interp as interp_ops

    log("phase matrix: one Thomas-method flux solve, 105 x 385 x 20 fp64")
    table = workloads.flagship_table()
    out = {}
    for method in ("matrix", "iteration"):
        cfg = HeliosConfig(**{**workloads.FLAGSHIP,
                              "flux_calc_method": method}).finalize()
        phys, arrays = build_model(cfg, table)
        T = jnp.asarray(workloads.flagship_start_profile(
            np.asarray(arrays.p_lay)))
        cache = jax.jit(lambda m, t: compute_cells(
            phys, m, t, interp_ops.interface_temperatures(t)))(arrays, T)
        fs0 = init_flux_state(phys, T.dtype)
        solve = jax.jit(lambda m, c, t, fs: solve_fluxes(phys, m, c, t, fs))
        t = timed(lambda: solve(arrays, cache, T, fs0))
        out[method] = solve(arrays, cache, T, fs0)
        log(f"  {method} solve: {t * 1e3:.3f} ms")
    require("matrix fluxes finite",
            all(bool(jnp.all(jnp.isfinite(x))) for x in out["matrix"]))


def phase_random_overlap():
    """One on-the-fly Random Overlap pass (2 absorbers) at 105 x 385 x 20;
    its Random Overlap step checked against the per-cell numpy oracle of
    the reference kernel on the same inputs."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import reference_mixing as refm

    from helios_tpu import chem, workloads
    from helios_tpu.io.opacity import gauss_legendre_ypoints
    from helios_tpu.ops import interp as interp_ops
    from helios_tpu.ops import mixing as mix_ops

    log("phase random overlap: on-the-fly mixing pass, 2 absorbers, "
        "105 x 385 x 20 fp64")
    L = 105
    donor, sset = workloads.onthefly_species(L)
    _, gw = gauss_legendre_ypoints(workloads.NY)
    gw, gy = jnp.asarray(gw), jnp.asarray(donor.gauss_y)
    wave = jnp.asarray(donor.wave_centers)
    T = jnp.asarray(np.linspace(1800.0, 600.0, L))
    p = jnp.asarray(np.geomspace(1e9, 1e-1, L))

    mix = jax.jit(lambda t: chem.mixed_opacities(
        sset, t, p, wave, gw, gy, ro_method=1, scat=0)[0])
    log(f"  mixing pass: {timed(lambda: mix(T)) * 1e3:.3f} ms")

    # the two absorbers' weighted opacities as add_species_opacity forms
    # them: the first is mixed by addition, the second by Random Overlap
    mmm = chem.mean_molecular_mass(sset, T, p)
    new = []
    for spec, dat in zip(sset.specs, sset.data):
        if spec.absorbing:
            k = interp_ops.interpolate_species_opacity(
                dat.opacity_pretab, sset.ktemps, sset.kpress, T, p)
            vmr = chem.species_vmr(spec, dat, sset, T, p)
            new.append((vmr * spec.mass / mmm)[:, None, None] * k)
    assert len(new) == 2
    ones = jnp.ones(L, new[0].dtype)
    step = jax.jit(lambda a, b: mix_ops.add_species_opacity(
        a, b, ones, 1.0, ones, gw, gy, species_index=1, ro_method=1))
    log(f"  Random Overlap step alone: "
        f"{timed(lambda: step(*new)) * 1e3:.3f} ms")
    got = np.asarray(step(*new))
    a, b = (np.asarray(x) for x in new)
    layers = list(range(0, L, 7))
    want = np.array([[refm.add_to_mixed_opac_cell(
        a[l, j], b[l, j], np.asarray(gw), np.asarray(gy), 1, 1)
        for j in range(workloads.NBIN)] for l in layers])
    compare(f"random overlap vs reference oracle ({len(layers)} layers x "
            f"{workloads.NBIN} bins)", rel_err(got[layers], want), 1e-10)
    log(f"  whole mixing pass vs the same oracle: max rel err "
        f"{rel_err(np.asarray(mix(T))[layers], want):.3e} (measured)")


def phase_gpu_tests():
    import pytest

    log("phase tests: pytest -m gpu")
    os.environ["HELIOS_TEST_PLATFORM"] = "gpu"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "-p", "no:randomly", os.path.join(ROOT, "tests")])
    require("tests marked gpu pass", int(rc) == 0)


# --------------------------------------------------------------------------- #
# phases on four cards
# --------------------------------------------------------------------------- #

def radiative_steps(cfg, table, steps: int):
    """T_lay after ``steps`` radiative iterations of the flagship, on
    ``cfg.n_spectral_shards`` cards, set up as `pipeline.run` does."""
    import jax
    import jax.numpy as jnp

    from helios_tpu import pipeline
    from helios_tpu.parallel import sharding as shd
    from helios_tpu.rce.radiative import radiation_loop

    phys, arrays, _ = pipeline.prepare_model(cfg, table)
    thermo = pipeline.make_thermo(cfg)
    T0 = jnp.asarray(pipeline.initial_temperatures(cfg, phys, arrays))
    n = int(cfg.n_spectral_shards)
    if n == 1:
        return jax.jit(lambda m, t: radiation_loop(
            phys, m, thermo, t, max_steps=steps).T_lay)(arrays, T0)
    if phys.nbin % n:
        phys, arrays = shd.pad_spectral(phys, arrays, n)
    mesh = shd.make_mesh(n_planet=1, n_spectral=n,
                         devices=jax.devices()[:n])
    m = shd.place_model(arrays, mesh)
    rad_init, rad_run, _, _ = shd.production_runners(
        phys, mesh, thermo, None, chunk_iters=steps)
    return rad_run(m, (), rad_init(m, (), T0)).T_lay


def phase_spectral_shards():
    from helios_tpu import pipeline, workloads

    log("phase spectral shards: flagship on 4 cards (385 bins padded to "
        "388) vs 1 card")
    table = workloads.flagship_table()
    # Only the order of the band sums differs between the two.  One
    # iteration shows that difference before the loop amplifies it: a
    # padding or reduction fault would show here far above rounding.
    one = {n: radiative_steps(workloads.flagship_config(
        OUT, f"flagship_{n}card_step", n_spectral_shards=n), table, 1)
        for n in (1, 4)}
    compare("T_lay after one radiative iteration, 4 cards vs 1 card",
            rel_err(one[4], one[1]), 1e-10)
    res, rad, rad_its = {}, {}, {}
    for n in (1, 4):
        cfg = workloads.flagship_config(OUT, f"flagship_{n}card",
                                        n_spectral_shards=n)
        t0 = time.perf_counter()
        out = pipeline.run(cfg, table=table, write_output=False)
        wall = time.perf_counter() - t0
        converged = (out.conv is not None and not bool(out.rad.aborted)
                     and not bool(out.conv.aborted))
        log(f"  {n} card(s): {wall:.2f} s wall including compilation; "
            f"radiative {int(out.rad.it)} + convective {int(out.conv.it)} "
            f"iterations; converged {converged}")
        require(f"{n}-card run converged", converged)
        res[n] = out.result.T_lay
        rad[n], rad_its[n] = out.rad.T_lay, int(out.rad.it)
    # Over the run the adaptive steps amplify that rounding, and the
    # convective phase may stop at another iteration: the phases' end
    # states agree as far as the convergence criterion pins them.
    log(f"  radiative iterations: 4 cards {rad_its[4]}, 1 card {rad_its[1]}")
    compare("T_lay after the radiative phase, 4 cards vs 1 card",
            rel_err(rad[4], rad[1]), FINAL_T_TOL)
    compare("final T_lay, 4 cards vs 1 card", rel_err(res[4], res[1]),
            FINAL_T_TOL)


def phase_planet_batch():
    from helios_tpu import pipeline, workloads
    from helios_tpu.parallel import ensemble

    log("phase planet batch: 4 planets, n_planet_batch=4, vs each alone")
    n = 4
    tables = []
    for i in range(n):
        t = workloads.flagship_table()
        t.kpoints *= 1.0 + 0.05 * i     # members differ in opacity
        tables.append(t)
    cfgs = [workloads.flagship_config(OUT, f"planet_{i}", n_planet_batch=n)
            for i in range(n)]
    t0 = time.perf_counter()
    outs = ensemble.run_ensemble(cfgs, tables=tables)
    log(f"  batch: {time.perf_counter() - t0:.2f} s wall including "
        f"compilation")
    for i, (cfg, o) in enumerate(zip(cfgs, outs)):
        solo_cfg = workloads.flagship_config(OUT, f"planet_{i}_alone")
        solo = pipeline.run(solo_cfg, table=tables[i], write_output=False)
        log(f"  planet {i}: batch {int(o.rad.it)} + {int(o.conv.it)} "
            f"iterations, alone {int(solo.rad.it)} + {int(solo.conv.it)}")
        compare(f"planet {i} T_lay, batch vs alone",
                rel_err(o.result.T_lay, solo.result.T_lay), 1e-6)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run the four-card phases only")
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    from helios_tpu.compile_cache import enable_compile_cache
    enable_compile_cache()

    import jax
    if jax.default_backend() != "gpu":
        print(f"no GPU: JAX's backend is {jax.default_backend()!r}",
              file=sys.stderr)
        return 2
    devices = jax.devices()
    if args.multi and len(devices) < 4:
        print(f"--multi needs 4 GPUs, found {len(devices)}", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    for line in smi.stdout.strip().splitlines():
        log(line)
    log(f"jax {jax.__version__}: {len(devices)} x {devices[0].device_kind}")

    t0 = time.perf_counter()
    phases = ((phase_spectral_shards, phase_planet_batch) if args.multi
              else (phase_sweeps, phase_flagship, phase_matrix,
                    phase_random_overlap, phase_gpu_tests))
    for phase in phases:
        t = time.perf_counter()
        phase()
        log(f"  ({phase.__name__}: {time.perf_counter() - t:.1f} s)")
    log(f"total {time.perf_counter() - t0:.1f} s")

    if _failures:
        log(f"FAILED: {', '.join(_failures)}")
        return 1
    d = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
