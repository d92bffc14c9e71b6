"""CLI, plotting, and star_tool tests."""

import os
import subprocess
import sys

import numpy as np
import pytest

from helios_tpu.io.opacity import save_opacity_file, synthetic_premixed_table

DATA = os.path.join(os.path.dirname(__file__), "data")


def test_param_file_parses_reference_param_dat():
    from helios_tpu.config import parse_param_file
    cfg = parse_param_file(os.path.join(DATA, "reference_param.dat"))
    c = cfg.finalize()
    assert c.nlayer == 105
    assert c.iso == 0 and c.scat == 1
    assert c.p_boa == 1e9 and c.p_toa == 1e-1
    # GJ 1214b planet parameters resolved from the database
    assert c.T_star > 2000 and c.a > 1e11


def test_cli_end_to_end(tmp_path):
    """`python -m helios_tpu` runs a small configuration from a param file
    and writes the output set."""
    table = synthetic_premixed_table(nbin=12, ny=4, ntemp=8, npress=6)
    opac_path = str(tmp_path / "table.h5")
    save_opacity_file(opac_path, table)

    param = tmp_path / "param.dat"
    param.write_text(f"""
name =                       clirun
output directory =           {tmp_path}/out/
realtime plotting =          no
planet type =                gas
TOA pressure [10^-6 bar] =   1e3
BOA pressure [10^-6 bar] =   1e8
run type =                   iterative
scattering =                 no
direct irradiation beam =    no
internal temperature [K] =   150
opacity mixing =             premixed
path to opacity file =       {opac_path}
convective adjustment =      no
plancktable dimension and stepsize = 8000 2
number of layers =           8
isothermal layers =          yes
radiative equilibrium criterion = 1e-5
planet =                     manual
surface gravity [cm s^-2] =  2288
orbital distance [au] =      0.0153
radius planet [r_jup] =      1.0
radius star [r_sun] =        1.0
temperature star [k] =       4000
""")
    env = dict(os.environ, JAX_PLATFORMS="", PYTHONPATH="/root/repo")
    proc = subprocess.run(
        [sys.executable, "-c",
         "import jax; jax.config.update('jax_platforms','cpu');"
         "import helios_tpu.__main__ as m; m.main("
         f"['-parameter_file', '{param}'])"],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "Done!" in proc.stdout
    out_dir = str(tmp_path / "out" / "clirun")
    assert os.path.exists(os.path.join(out_dir, "clirun_tp.dat"))
    assert os.path.exists(os.path.join(out_dir,
                                       "clirun_TOA_flux_eclipse.dat"))


def test_realtime_plot_renders(tmp_path):
    from helios_tpu.plotting import Plot
    L = 10
    p = Plot(interactive=False)
    png = str(tmp_path / "frame.png")
    p.plot_tp_and_flux(
        T_lay=np.linspace(1500, 700, L + 1),
        F_net=np.linspace(100, 90, L + 1), F_intern=95.0,
        p_boa=1e8, p_toa=1e3,
        marked_red=np.r_[np.ones(3, int), np.zeros(L - 2, int)],
        conv_layer=np.r_[np.zeros(L - 2, int), np.ones(3, int)],
        savefig=png)
    assert os.path.getsize(png) > 5000


def test_posthoc_plots(tmp_path):
    """Post-hoc plotting scripts parse the output files we write."""
    import jax.numpy as jnp
    from helios_tpu import pipeline, plotting
    from helios_tpu.config import HeliosConfig

    table = synthetic_premixed_table(nbin=12, ny=4, ntemp=8, npress=6)
    cfg = HeliosConfig(name="pp", output_dir=str(tmp_path) + "/",
                       planet="manual", g=2288.0, a=0.0153, R_planet=1.0,
                       R_star=1.0, T_star=4000.0, T_intern=150.0,
                       scattering="no", direct_beam="no", convection="no",
                       run_type="iterative", iso_input="yes", nlayer=8,
                       p_boa=1e8, p_toa=1e3, rad_convergence_limit=1e-5)
    pipeline.run(cfg, table=table)
    d = os.path.join(str(tmp_path), "pp")
    plotting.plot_tp_from_file(os.path.join(d, "pp_tp.dat"),
                               str(tmp_path / "tp.png"))
    plotting.plot_spectrum_from_file(
        os.path.join(d, "pp_TOA_flux_eclipse.dat"),
        str(tmp_path / "spec.png"))
    assert os.path.getsize(str(tmp_path / "tp.png")) > 5000
    assert os.path.getsize(str(tmp_path / "spec.png")) > 5000


def test_startool_ascii_conversion(tmp_path):
    """ASCII stellar spectrum rebinned onto an opacity grid with automatic
    blackbody extrapolation; result loadable as model starflux."""
    from helios_tpu import constants as pc
    from helios_tpu import host_physics as hp
    from helios_tpu.startool import functions as st

    table = synthetic_premixed_table(nbin=24, ny=4, ntemp=8, npress=6,
                                     lambda_min=0.3e-4, lambda_max=50e-4)
    opac_path = str(tmp_path / "table.h5")
    save_opacity_file(opac_path, table)

    # synthetic stellar spectrum: a 4500 K blackbody at 1 AU scaled back
    T_star = 4500.0
    lam_um = np.geomspace(0.2, 6.0, 4000)      # truncated -> needs BB tail
    lam_cm = lam_um * 1e-4
    surf_flux = np.pi * hp.planck_lambda_np(lam_cm, T_star)
    flux_1au = surf_flux / (pc.AU / pc.R_SUN) ** 2
    src = tmp_path / "star.dat"
    with open(src, "w") as f:
        f.write("#\n" * 8)
        for l, fl in zip(lam_um, flux_1au):
            f.write(f"{l:.6e} {fl:.6e}\n")

    star = dict(name="test", data_format="ascii", temp=T_star,
                source_file=str(src), w_conversion_factor=1e-4,
                flux_conversion_factor=1.0)
    out_h5 = str(tmp_path / "star_out.h5")
    lam, conv = st.convert_star(star, "r50", opac_path, out_h5,
                                mode="automatic")

    # the converted spectrum matches pi*B(T_star) everywhere (BB source +
    # BB extrapolation at the fitted temperature)
    import h5py
    with h5py.File(out_h5) as f:
        stored = np.asarray(f["/r50/ascii/test"])
    np.testing.assert_allclose(stored, conv)
    edges = table.wave_edges
    from helios_tpu import tools
    want = np.pi * tools.calc_analyt_planck_in_interval(
        T_star, edges[:-1], edges[1:])
    np.testing.assert_allclose(conv, want, rtol=0.05)


def test_phoenix_missing_files_error_lists_urls(tmp_path):
    """ensure_phoenix_files names every missing grid file with its
    Goettingen URL (reference star_tool/functions.py:119-129), and the
    download path is exercised via a local file:// fetch."""
    import pytest

    from helios_tpu.startool import functions as st

    with pytest.raises(FileNotFoundError) as e:
        st.ensure_phoenix_files(str(tmp_path), "gj1214",
                                [(3000, 5.0, 0.0)], download=False)
    msg = str(e.value)
    assert "lte03000-5.00-0.0.PHOENIX-ACES-AGSS-COND-2011-HiRes.fits" in msg
    assert "WAVE_PHOENIX-ACES-AGSS-COND-2011.fits" in msg
    assert str(tmp_path) in msg

    # download machinery works (file:// URL; no egress needed)
    src = tmp_path / "src.fits"
    src.write_bytes(b"FITSDATA")
    dest = tmp_path / "sub" / "out.fits"
    st.download_phoenix_file(f"file://{src}", str(dest))
    assert dest.read_bytes() == b"FITSDATA"


def test_cli_accepts_every_reference_flag():
    """Every command-line flag of the reference (read.py:214-321, listed
    in tests/data/reference_cli_flags.txt) is accepted by our CLI."""
    from helios_tpu.config import build_arg_parser

    with open(os.path.join(DATA, "reference_cli_flags.txt")) as f:
        ref_flags = [ln.strip() for ln in f
                     if ln.strip() and not ln.startswith("#")]
    assert len(ref_flags) > 60
    ap = build_arg_parser()
    ours = {s for a in ap._actions for s in a.option_strings}
    missing = [f for f in ref_flags if f not in ours]
    assert missing == [], f"CLI flags missing vs reference: {missing}"


def test_cli_cloud_flags_set_deck_lists():
    """Per-deck cloud flags land as lists (reference read.py:762-787) and the
    coupling/heating spellings map to their config fields."""
    from helios_tpu.config import config_from_cli
    cfg = config_from_cli([
        "-aerosol_name", "KCl[s]",
        "-aerosol_radius_mode", "1.0",
        "-aerosol_radius_geometric_std_dev", "1.5",
        "-cloud_bottom_pressure", "1e6",
        "-cloud_bottom_mixing_ratio", "1e-4",
        "-cloud_to_gas_scale_height_ratio", "0.5",
        "-path_to_mie_files", "./mie/kcl/",
        "-include_additional_heating", "yes",
        "-path_to_heating_file", "./heat.dat",
        "-coupling_speed_up", "no",
        "-force_eq_chem_for_first_iteration", "yes",
        "-full_output_each_iteration_step", "yes",
        "-write_tp_profile_during_run", "5",
        "-convergence_criterion", "1e-5",
    ], finalize=False)
    assert cfg.aerosol_names == ["KCl[s]"]
    assert cfg.cloud_radius_mode == [1.0]
    assert cfg.cloud_radius_geo_std == [1.5]
    assert cfg.cloud_bottom_pressure == [1e6]
    assert cfg.cloud_bottom_mixing_ratio == [1e-4]
    assert cfg.cloud_to_gas_scale_height == [0.5]
    assert cfg.mie_dirs == ["./mie/kcl/"]
    assert cfg.add_heating == "yes"
    assert cfg.add_heating_path == "./heat.dat"
    assert cfg.coupling_speed_up == "no"
    assert cfg.coupling_force_eq_chem == "yes"
    assert cfg.coupling_full_output == "yes"
    assert cfg.coupl_tp_write_interval == "5"
    assert cfg.coupl_convergence_limit == 1e-5
    # multi-deck comma-split superset
    cfg2 = config_from_cli(["-aerosol_name", "KCl[s],ZnS[s]",
                            "-aerosol_radius_mode", "1.0,2.0"], finalize=False)
    assert cfg2.aerosol_names == ["KCl[s]", "ZnS[s]"]
    assert cfg2.cloud_radius_mode == [1.0, 2.0]
