"""Multi-chip sharding tests on the virtual 8-device CPU mesh: sharded
results must match the single-device results exactly (same reduction
order), the SURVEY.md section 4d stratum."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from helios_tpu.config import HeliosConfig
from helios_tpu.forward import build_model, forward_fluxes
from helios_tpu.io.opacity import synthetic_premixed_table
from helios_tpu.parallel import sharding as shd
from helios_tpu.rce.radiative import init_rad_state, radiation_loop


pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices")


def _setup(nbin=16, ny=4, nlayer=10):
    table = synthetic_premixed_table(nbin=nbin, ny=ny, ntemp=10, npress=8,
                                     seed=2)
    cfg = HeliosConfig(planet="manual", g=2288.0, a=0.0153, R_planet=1.0,
                       R_star=1.0, T_star=4000.0, T_intern=100.0,
                       scattering="yes", direct_beam="no", convection="no",
                       run_type="iterative", iso_input="yes", nlayer=nlayer,
                       p_boa=1e8, p_toa=1e3).finalize()
    phys, arrays = build_model(cfg, table)
    return phys, arrays


def test_sharded_forward_matches_single_device():
    phys, arrays = _setup()
    T_lay = jnp.linspace(1500.0, 800.0, phys.nlayer + 1)

    _, want, _ = forward_fluxes(phys, arrays, T_lay)

    mesh = shd.make_mesh(n_planet=2, n_spectral=4)
    m_sharded = shd.place_model(arrays, mesh)
    fwd = shd.sharded_forward(phys, mesh)
    got = fwd(m_sharded, T_lay)

    np.testing.assert_allclose(np.asarray(got.F_net),
                               np.asarray(want.F_net), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(got.F_up_band),
                               np.asarray(want.F_up_band), rtol=1e-12)


def test_batched_rce_step_matches_per_planet_loop():
    phys, arrays = _setup()
    n_planet = 2
    mesh = shd.make_mesh(n_planet=n_planet, n_spectral=4)
    m_sharded = shd.place_model(arrays, mesh)

    T0s = jnp.stack([jnp.full(phys.nlayer + 1, 900.0),
                     jnp.full(phys.nlayer + 1, 1400.0)])

    init, step = shd.batched_rce_step(phys, mesh, None)
    state = init(m_sharded, T0s)
    for _ in range(3):
        state = step(m_sharded, state)

    # reference: unsharded loop, 3 iterations per planet
    for p in range(n_planet):
        want = radiation_loop(phys, arrays, None, T0s[p], max_steps=3)
        np.testing.assert_allclose(np.asarray(state.T_lay[p]),
                                   np.asarray(want.T_lay), rtol=1e-11)
        # band->total reduction order differs across shards: not bitwise,
        # but deterministic for a fixed topology
        np.testing.assert_allclose(np.asarray(state.totals.F_net[p]),
                                   np.asarray(want.totals.F_net), rtol=1e-8)
        assert int(state.it[p]) == int(want.it) == 3


def test_sharded_radiation_loop_matches_single_device():
    """Full while_loop under shard_map == unsharded loop, per planet."""
    from helios_tpu.rce.radiative import radiation_loop

    phys, arrays = _setup()
    n_planet = 2
    mesh = shd.make_mesh(n_planet=n_planet, n_spectral=4)
    m_sharded = shd.place_model(arrays, mesh)

    T0s = jnp.stack([jnp.full(phys.nlayer + 1, 900.0 + 150.0 * p)
                     for p in range(n_planet)])
    run = shd.sharded_radiation_loop(phys, mesh, None, max_steps=120)
    state = run(m_sharded, T0s)

    for p in range(n_planet):
        want = jax.jit(lambda t: radiation_loop(
            phys, arrays, None, t, max_steps=120))(T0s[p])
        assert int(state.it[p]) == int(want.it)
        # the sharded and single programs are separate XLA compilations:
        # per-bin results can differ in the last bit (instruction
        # scheduling), and the adaptive |c|^0.1 step amplifies that
        # transiently -- physically far below the 1e-8 criterion
        np.testing.assert_allclose(
            np.asarray(state.T_lay[p]), np.asarray(want.T_lay),
            rtol=1e-8, atol=0)
        want_net = np.asarray(want.totals.F_net)
        np.testing.assert_allclose(
            np.asarray(state.totals.F_net[p]), want_net,
            rtol=1e-6, atol=1e-6 * np.abs(want_net).max())


def _setup_noniso_conv(nbin=16, ny=4, nlayer=12):
    """Strongly-heated interior + optically thick + shallow adiabat:
    convective instability appears within a few dozen radiation steps
    (the test_rce.py end-to-end convection scenario)."""
    table = synthetic_premixed_table(nbin=nbin, ny=ny, ntemp=10, npress=8,
                                     seed=3)
    table.kpoints *= 10.0
    cfg = HeliosConfig(planet="manual", g=2288.0, a=0.0153, R_planet=1.0,
                       R_star=30.0, T_star=30.0, T_intern=700.0,
                       scattering="yes", direct_beam="no",
                       convection="yes", run_type="iterative",
                       kappa_value=0.1, nlayer=nlayer,
                       p_boa=1e9, p_toa=1e3, adapt_interval=6).finalize()
    phys, arrays = build_model(cfg, table)
    assert phys.iso == 0
    return phys, arrays


def test_production_runners_full_rce_matches_single():
    """The production pipeline path (radiation AND convection under
    shard_map, non-iso) matches the unsharded loops -- the multi-chip
    mode pipeline.run enables via n_spectral_shards."""
    from helios_tpu.rce.loop import convection_loop
    from helios_tpu.rce.radiative import make_const_thermo

    phys, arrays = _setup_noniso_conv()
    thermo = make_const_thermo(0.1)
    mesh = shd.make_mesh(n_planet=1, n_spectral=4,
                         devices=jax.devices()[:4])
    m_sharded = shd.place_model(arrays, mesh)

    # non-isothermal start: from an isothermal profile F_net is pure
    # rounding residue and |c|^0.1 amplifies psum-order noise into fake
    # trajectory divergence (see .claude/skills/verify notes)
    T0 = jnp.linspace(1500.0, 500.0, phys.nlayer + 1)

    rad_init, rad_run, conv_enter, conv_run = shd.production_runners(
        phys, mesh, thermo, None, chunk_iters=200)
    state = rad_init(m_sharded, (), T0)
    state = rad_run(m_sharded, (), state)
    cstate = conv_enter(m_sharded, (), state)
    assert bool(cstate.keep_running), "no convective instability in test"
    cstate = conv_run(m_sharded, (), cstate)

    want_rad = jax.jit(lambda t: radiation_loop(
        phys, arrays, thermo, t, max_steps=200))(T0)
    assert int(state.it) == int(want_rad.it)
    # separate compilations: last-bit scheduling differences, amplified
    # transiently by the adaptive step (see comment above)
    np.testing.assert_allclose(np.asarray(state.T_lay),
                               np.asarray(want_rad.T_lay), rtol=1e-6)

    want_conv = jax.jit(lambda r: convection_loop(
        phys, arrays, thermo, r, max_steps=200))(want_rad)
    assert int(cstate.it) == int(want_conv.it)
    np.testing.assert_allclose(np.asarray(cstate.T_lay),
                               np.asarray(want_conv.T_lay), rtol=1e-6)
    want_net = np.asarray(want_conv.totals.F_net)
    np.testing.assert_allclose(np.asarray(cstate.totals.F_net), want_net,
                               rtol=1e-5,
                               atol=1e-5 * np.abs(want_net).max())
    np.testing.assert_array_equal(np.asarray(cstate.conv_layer),
                                  np.asarray(want_conv.conv_layer))


def test_production_runners_on_the_fly_sharded():
    """On-the-fly opacity mixing (RO) under spectral shard_map: species
    tables sharded over wavelength bins, loop matches the single device."""
    from helios_tpu import chem

    B, ny, L = 16, 4, 8
    donor = synthetic_premixed_table(nbin=B, ny=ny, ntemp=8, npress=6,
                                     seed=1)
    specs = [chem.SpeciesSpec("H2O", True, True, "1e-3"),
             chem.SpeciesSpec("CO2", True, False, "1e-4"),
             chem.SpeciesSpec("H2", False, True, "0.9"),
             chem.SpeciesSpec("He", False, False, "0.1")]
    sset = chem.build_species_set(
        specs, ktemps=donor.temperatures, kpress=donor.pressures,
        nbin=B, ny=ny, nlayer=L,
        opacity_tables={"H2O": donor.kpoints, "CO2": donor.kpoints * 3.0},
        scat_tables={"H2": 8.49e-45 / donor.wave_centers ** 4})

    cfg = HeliosConfig(planet="manual", g=2288.0, a=0.0153, R_planet=1.0,
                       R_star=1.0, T_star=4000.0, T_intern=200.0,
                       scattering="yes", direct_beam="no", convection="no",
                       run_type="iterative", iso_input="yes", nlayer=L,
                       p_boa=1e8, p_toa=1e3,
                       opacity_mixing="on-the-fly").finalize()
    phys, arrays = build_model(cfg, donor)

    mesh = shd.make_mesh(n_planet=1, n_spectral=4,
                         devices=jax.devices()[:4])
    m_sharded = shd.place_model(arrays, mesh)
    sset_sh = shd.place_species(sset, mesh)
    sarr = shd.sset_arrays(sset_sh)

    T0 = jnp.linspace(1500.0, 700.0, L + 1)
    rad_init, rad_run, _, _ = shd.production_runners(
        phys, mesh, None, sset_sh, chunk_iters=25)
    state = rad_init(m_sharded, sarr, T0)
    state = rad_run(m_sharded, sarr, state)

    want = jax.jit(lambda t: radiation_loop(
        phys, arrays, None, t, max_steps=25, sset=sset))(T0)
    assert int(state.it) == int(want.it) == 25
    np.testing.assert_allclose(np.asarray(state.T_lay),
                               np.asarray(want.T_lay), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(state.totals.F_net),
                               np.asarray(want.totals.F_net), rtol=1e-8)


def test_run_ensemble_matches_individual_runs(tmp_path):
    """One command runs N planets (different stars/albedos) as a single
    batched program, sharded over the (planet, spectral) mesh, writing
    per-planet outputs that match individual pipeline.run results."""
    import os

    from helios_tpu import pipeline
    from helios_tpu.parallel.ensemble import run_ensemble

    table = synthetic_premixed_table(nbin=16, ny=4, ntemp=10, npress=8,
                                     seed=2)

    def mk(name, T_star, albedo):
        return HeliosConfig(
            name=name, output_dir=str(tmp_path) + "/",
            planet="manual", g=2288.0, a=0.0153, R_planet=1.0,
            R_star=1.0, T_star=T_star, T_intern=200.0,
            scattering="no", direct_beam="no", convection="no",
            run_type="iterative", iso_input="yes", nlayer=10,
            p_boa=1e8, p_toa=1e3, rad_convergence_limit=1e-6,
            surf_albedo=albedo, n_planet_batch=2, n_spectral_shards=4)

    # T_star enters Phys: ensemble members must share it; vary albedo
    cfgs = [mk("pl_a", 4000.0, 0.0), mk("pl_b", 4000.0, 0.9)]
    outs = run_ensemble(cfgs, tables=[table, table])
    assert len(outs) == 2

    for cfg, out in zip(cfgs, outs):
        d = os.path.join(str(tmp_path), cfg.name)
        assert os.path.exists(os.path.join(d, f"{cfg.name}_tp.dat"))
        want = pipeline.run(
            HeliosConfig(**{**cfg.__dict__, "name": cfg.name + "_solo",
                            "n_planet_batch": 1, "n_spectral_shards": 1}),
            table=table)
        np.testing.assert_allclose(out.result.T_lay, want.result.T_lay,
                                   rtol=1e-6)
    # the two planets genuinely differ (different stellar spectra; the
    # optically-thick synthetic-table equilibrium responds mostly at the
    # surface, so the signal is small but far above the convergence noise)
    rel = np.abs(outs[0].result.T_lay - outs[1].result.T_lay) / np.abs(
        outs[1].result.T_lay)
    assert rel.max() > 1e-5


def test_ensemble_rejects_mismatched_phys(tmp_path):
    from helios_tpu.parallel.ensemble import run_ensemble

    table = synthetic_premixed_table(nbin=16, ny=4, ntemp=10, npress=8)
    kw = dict(output_dir=str(tmp_path) + "/", planet="manual", g=2288.0,
              a=0.0153, R_planet=1.0, R_star=1.0, T_intern=200.0,
              scattering="no", direct_beam="no", convection="no",
              run_type="iterative", iso_input="yes", nlayer=10,
              p_boa=1e8, p_toa=1e3)
    cfgs = [HeliosConfig(name="x", T_star=4000.0, **kw),
            HeliosConfig(name="y", T_star=5000.0, **kw)]
    with pytest.raises(ValueError, match="compile-time physics"):
        run_ensemble(cfgs, tables=[table, table], write_output=False)


def test_ensemble_needs_enough_devices(tmp_path):
    """A planet batch wider than the visible devices raises, as
    pipeline.run does for spectral shards."""
    from helios_tpu.parallel.ensemble import run_ensemble

    table = synthetic_premixed_table(nbin=16, ny=4, ntemp=10, npress=8)
    n = len(jax.devices()) + 1
    cfgs = [HeliosConfig(name=f"p{i}", output_dir=str(tmp_path) + "/",
                         planet="manual", g=2288.0, a=0.0153,
                         R_planet=1.0, R_star=1.0, T_star=4000.0,
                         T_intern=200.0, scattering="no", direct_beam="no",
                         convection="no", run_type="iterative",
                         iso_input="yes", nlayer=10, p_boa=1e8, p_toa=1e3,
                         n_planet_batch=n)
            for i in range(2)]
    with pytest.raises(RuntimeError, match="devices"):
        run_ensemble(cfgs, tables=[table, table], write_output=False)


def test_ensemble_cli_end_to_end(tmp_path, capsys):
    """The planet-ensemble product surface: ONE CLI command + an
    ensemble override file runs N planets with per-planet outputs,
    chunked progress lines, and a resumable ensemble checkpoint
    (VERDICT r2 item 4)."""
    import os

    from helios_tpu.__main__ import main
    from helios_tpu.io.opacity import save_opacity_file

    table = synthetic_premixed_table(nbin=16, ny=4, ntemp=10, npress=8,
                                     seed=2)
    opac = str(tmp_path / "opac.h5")
    save_opacity_file(opac, table)
    ens = tmp_path / "planets.dat"
    ens.write_text("# per-planet overrides\n"
                   "name      surf_albedo\n"
                   "ens_a     0.0\n"
                   "ens_b     0.9\n")

    argv = ["-planet_ensemble_file", str(ens),
            "-name", "base", "-output_directory", str(tmp_path) + "/",
            "-planet", "manual", "-surface_gravity", "2288.0",
            "-orbital_distance", "0.0153", "-radius_planet", "1.0",
            "-radius_star", "1.0", "-temperature_star", "4000.0",
            "-internal_temperature", "200.0", "-scattering", "no",
            "-direct_irradiation_beam", "no",
            "-convective_adjustment", "no", "-run_type", "iterative",
            "-isothermal_layers", "yes", "-number_of_layers", "10",
            "-boa_pressure", "1e8", "-toa_pressure", "1e3",
            "-radiative_equilibrium_criterion", "1e-6",
            "-path_to_opacity_file", opac,
            "-progress", "yes", "-checkpoint_every", "40"]
    assert main(argv) == 0
    out = capsys.readouterr().out
    assert "[ensemble/radiation]" in out          # chunked progress line
    assert "Ensemble of 2 planets" in out

    for name in ("ens_a", "ens_b"):
        d = os.path.join(str(tmp_path), name)
        assert os.path.exists(os.path.join(d, f"{name}_tp.dat"))
        assert os.path.exists(
            os.path.join(d, f"{name}_TOA_flux_eclipse.dat"))
    # the ensemble checkpoint exists (written under the first member)
    assert os.path.exists(os.path.join(str(tmp_path), "ens_a",
                                       "ensemble.ckpt.npz"))

    # resume: a second identical invocation restores from the converged
    # checkpoint and exits immediately with identical outputs
    with open(os.path.join(str(tmp_path), "ens_a", "ens_a_tp.dat")) as f:
        tp_first = f.read()
    assert main(argv) == 0
    with open(os.path.join(str(tmp_path), "ens_a", "ens_a_tp.dat")) as f:
        assert f.read() == tp_first


def test_ensemble_table_thermo_and_convection(tmp_path):
    """run_ensemble supports the file/water_atmo thermodynamics modes
    (the round-2 float(kappa_value) crash) and the convection loop."""
    from helios_tpu.parallel.ensemble import run_ensemble

    # small kappa/cp/entropy table in the reference ASCII layout
    import itertools
    temps = [100.0 * (i + 1) for i in range(12)]
    press = [10.0 ** e for e in range(3, 10)]
    lines = ["# synthetic kappa/cp/entropy table", "# T P kappa cp log10S"]
    for T, p in itertools.product(temps, press):
        kappa = 0.28 + 0.0001 * (T / 100.0)
        cp = 1.3e8
        lines.append(f"{T} {p} {kappa} {cp} {9.0 + T * 1e-4}")
    ktab = tmp_path / "thermo.dat"
    ktab.write_text("\n".join(lines) + "\n")

    table = synthetic_premixed_table(nbin=16, ny=4, ntemp=10, npress=8,
                                     seed=4)
    table.kpoints *= 10.0     # optically thick -> convective

    def mk(name, T_intern):
        return HeliosConfig(
            name=name, output_dir=str(tmp_path) + "/",
            planet="manual", g=2288.0, a=0.0153, R_planet=1.0,
            R_star=1.0, T_star=30.0, T_intern=T_intern,
            scattering="no", direct_beam="no", convection="yes",
            kappa_value="file", kappa_file_path=str(ktab),
            run_type="iterative", nlayer=8,
            p_boa=1e9, p_toa=1e4, rad_convergence_limit=1e-5)

    # T_intern enters Phys; ensemble members must share it -- vary albedo
    cfgs = [mk("th_a", 700.0), mk("th_b", 700.0)]
    cfgs[1].surf_albedo = 0.5
    outs = run_ensemble(cfgs, tables=[table, table])
    assert len(outs) == 2
    for out in outs:
        assert np.all(np.isfinite(out.result.T_lay))
        # entropy diagnostics came from the thermo table
        assert out.result.entropy_lay is not None
        assert np.all(out.result.entropy_lay > 0)


def test_run_ensemble_padded_spectral_mesh(tmp_path):
    """Planet x spectral mesh with a bin count indivisible by the
    spectral axis: the ensemble pads transparently and matches
    individual unsharded runs."""
    from helios_tpu import pipeline
    from helios_tpu.parallel.ensemble import run_ensemble

    table = synthetic_premixed_table(nbin=21, ny=4, ntemp=10, npress=8,
                                     seed=6)

    def mk(name, albedo, **over):
        kw = dict(
            name=name, output_dir=str(tmp_path) + "/",
            planet="manual", g=2288.0, a=0.0153, R_planet=1.0,
            R_star=1.0, T_star=4000.0, T_intern=200.0,
            scattering="no", direct_beam="no", convection="no",
            run_type="iterative", iso_input="yes", nlayer=10,
            p_boa=1e8, p_toa=1e3, rad_convergence_limit=1e-6,
            surf_albedo=albedo)
        kw.update(over)
        return HeliosConfig(**kw)

    cfgs = [mk("pp_a", 0.0, n_planet_batch=2, n_spectral_shards=4),
            mk("pp_b", 0.7, n_planet_batch=2, n_spectral_shards=4)]
    outs = run_ensemble(cfgs, tables=[table, table])
    for cfg, out in zip(cfgs, outs):
        assert out.result.F_up_band.shape[1] == 21
        want = pipeline.run(mk(cfg.name + "_solo",
                               float(cfg.surf_albedo)), table=table)
        np.testing.assert_allclose(out.result.T_lay, want.result.T_lay,
                                   rtol=1e-6)
        np.testing.assert_allclose(
            out.result.F_up_band[10], want.result.F_up_band[10],
            rtol=1e-5)


def test_run_ensemble_on_the_fly_sharded_mesh(tmp_path):
    """Ensemble + on-the-fly mixing + (planet x spectral) mesh: the
    species tables must be THREADED through shard_map (a closed-over
    sharded sset hands the shard-local body global-bin tables)."""
    from helios_tpu import chem, pipeline
    from helios_tpu.parallel.ensemble import run_ensemble

    B, ny, L = 16, 4, 10
    donor = synthetic_premixed_table(nbin=B, ny=ny, ntemp=8, npress=6,
                                     seed=9)
    specs = [chem.SpeciesSpec("H2O", True, False, "1e-3"),
             chem.SpeciesSpec("CO2", True, False, "1e-4"),
             chem.SpeciesSpec("H2", False, False, "0.9"),
             chem.SpeciesSpec("He", False, False, "0.1")]

    def mk_sset():
        return chem.build_species_set(
            specs, ktemps=donor.temperatures, kpress=donor.pressures,
            nbin=B, ny=ny, nlayer=L,
            opacity_tables={"H2O": donor.kpoints,
                            "CO2": donor.kpoints * 3.0})

    def mk(name, albedo, **over):
        kw = dict(name=name, output_dir=str(tmp_path) + "/",
                  planet="manual", g=2288.0, a=0.0153, R_planet=1.0,
                  R_star=1.0, T_star=4000.0, T_intern=200.0,
                  scattering="no", direct_beam="no", convection="no",
                  run_type="iterative", iso_input="yes", nlayer=L,
                  p_boa=1e8, p_toa=1e3, rad_convergence_limit=1e-6,
                  surf_albedo=albedo, opacity_mixing="on-the-fly")
        kw.update(over)
        return HeliosConfig(**kw)

    cfgs = [mk("otf_a", 0.0, n_planet_batch=2, n_spectral_shards=4),
            mk("otf_b", 0.6, n_planet_batch=2, n_spectral_shards=4)]
    outs = run_ensemble(cfgs, tables=[donor, donor], sset=mk_sset())
    for cfg, out in zip(cfgs, outs):
        want = pipeline.run(mk(cfg.name + "_solo",
                               float(cfg.surf_albedo)),
                            table=donor, sset=mk_sset())
        np.testing.assert_allclose(out.result.T_lay, want.result.T_lay,
                                   rtol=1e-6)


def test_ensemble_conv_checkpoint_resume(tmp_path):
    """The ensemble convection phase checkpoints and resumes (the
    radiation-only checkpoint would silently replay convection)."""
    import os

    from helios_tpu.parallel.ensemble import run_ensemble

    table = synthetic_premixed_table(nbin=16, ny=4, ntemp=10, npress=8,
                                     seed=3)
    table.kpoints *= 10.0

    def mk():
        return [HeliosConfig(
            name=f"cv_{i}", output_dir=str(tmp_path) + "/",
            planet="manual", g=2288.0, a=0.0153, R_planet=1.0,
            R_star=30.0, T_star=30.0, T_intern=700.0,
            scattering="no", direct_beam="no", convection="yes",
            kappa_value=0.1, run_type="iterative", nlayer=10,
            p_boa=1e9, p_toa=1e3, adapt_interval=6,
            surf_albedo=0.1 * i, checkpoint_every=40, chunk_iters=40)
            for i in range(2)]

    outs = run_ensemble(mk(), tables=[table, table])
    assert outs[0].conv is not None
    d = os.path.join(str(tmp_path), "cv_0")
    assert os.path.exists(os.path.join(d, "ensemble.ckpt.npz"))
    assert os.path.exists(os.path.join(d, "ensemble_conv.ckpt.npz"))

    # rerun: the converged convection checkpoint restores and the run
    # exits immediately with identical results
    outs2 = run_ensemble(mk(), tables=[table, table])
    np.testing.assert_allclose(outs2[0].result.T_lay,
                               outs[0].result.T_lay, rtol=1e-12)
    np.testing.assert_allclose(outs2[1].result.T_lay,
                               outs[1].result.T_lay, rtol=1e-12)


def test_ensemble_file_header_only_raises(tmp_path):
    from helios_tpu.parallel.ensemble import parse_ensemble_file

    p = tmp_path / "planets.dat"
    p.write_text("# comment\nname surf_albedo\n")
    with pytest.raises(ValueError, match="no planet rows"):
        parse_ensemble_file(str(p))


def _mk_mie_dir(d):
    """Tiny synthetic LX-Mie directory (same recipe as test_clouds.mie_dir)."""
    import os

    from helios_tpu import clouds as clouds_mod
    os.makedirs(d, exist_ok=True)
    lam_um = np.geomspace(0.3, 30.0, 50)
    for r in clouds_mod.R_VALUES_MICRON:
        x = 2 * np.pi * r / lam_um
        scat = 1e-8 * r ** 2 * np.minimum(x ** 4, 2.0)
        absx = 1e-8 * r ** 2 * np.minimum(x, 1.0)
        g0 = np.clip(0.9 * np.minimum(x, 1.0), 0, 1)
        with open(os.path.join(d, "r{:.6f}.dat".format(r)), "w") as f:
            f.write("# lam c2 c3 scat abs c5 g0\n")
            for i in range(len(lam_um)):
                f.write(f"{lam_um[i]:.6e} 0 0 {scat[i]:.6e} {absx[i]:.6e} "
                        f"0 {g0[i]:.6e}\n")
    return d


def test_ensemble_cloudy_member_writes_solo_file_set(tmp_path):
    """A cloudy ensemble member writes exactly the files a solo run writes —
    including the 4 cloud deck files (write.py:434-530) and, for an aborted
    run, the ABORT file (write.py:63-95). VERDICT r3 item 2."""
    import os

    from helios_tpu import pipeline
    from helios_tpu.parallel.ensemble import run_ensemble

    mie = _mk_mie_dir(str(tmp_path / "mie"))
    table = synthetic_premixed_table(nbin=16, ny=4, ntemp=10, npress=8,
                                     seed=4, lambda_min=0.5e-4,
                                     lambda_max=15e-4)

    def mk(name, outdir, albedo, max_iter=3000):
        return HeliosConfig(
            name=name, output_dir=outdir + "/",
            planet="manual", g=2288.0, a=0.0153, R_planet=1.0,
            R_star=1.0, T_star=4000.0, T_intern=100.0,
            scattering="yes", direct_beam="no", convection="no",
            run_type="iterative", iso_input="yes", nlayer=10,
            p_boa=1e8, p_toa=1e3, rad_convergence_limit=1e-5,
            surf_albedo=albedo, max_nr_iterations=max_iter,
            nr_cloud_decks=1, mie_dirs=[mie],
            cloud_radius_mode=[1.0], cloud_radius_geo_std=[1.5],
            cloud_mixing_ratio_source="manual",
            cloud_bottom_pressure=[1e6],
            cloud_bottom_mixing_ratio=[1e-6],
            cloud_to_gas_scale_height=[0.8],
            n_planet_batch=2, n_spectral_shards=4)

    ens_dir = str(tmp_path / "ens")
    solo_dir = str(tmp_path / "solo")
    cfgs = [mk("pl_a", ens_dir, 0.0), mk("pl_b", ens_dir, 0.9)]
    run_ensemble(cfgs, tables=[table, table])

    for cfg in cfgs:
        solo_cfg = HeliosConfig(**{**cfg.__dict__, "output_dir":
                                   solo_dir + "/", "n_planet_batch": 1,
                                   "n_spectral_shards": 1})
        pipeline.run(solo_cfg, table=table)
        ens_files = sorted(os.listdir(os.path.join(ens_dir, cfg.name)))
        solo_files = sorted(os.listdir(os.path.join(solo_dir, cfg.name)))
        assert ens_files == solo_files, (
            f"{cfg.name}: ensemble file set differs from solo run:\n"
            f"only-ensemble: {set(ens_files) - set(solo_files)}\n"
            f"only-solo: {set(solo_files) - set(ens_files)}")
        for needle in ("_cloud_mixing_ratio.dat", "_cloud_opacities.dat",
                       "_cloud_scat_cross_sect.dat", "_cloud_optdepth.dat"):
            assert any(f.endswith(needle) for f in ens_files), needle

    # aborted members write the ABORT file, exactly like a solo run
    abort_dir = str(tmp_path / "abort")
    acfgs = [mk("ab_a", abort_dir, 0.0, max_iter=2),
             mk("ab_b", abort_dir, 0.9, max_iter=2)]
    run_ensemble(acfgs, tables=[table, table])
    for cfg in acfgs:
        files = os.listdir(os.path.join(abort_dir, cfg.name))
        assert any("ABORT" in f for f in files), files
