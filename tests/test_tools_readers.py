"""HELIOS output readers, resolution rebinner, param_ktable parser,
startool CLI (reference tools.py:297-486, source_ktable/param.py:46-199,
star_tool/run.py:46-53)."""

import json
import os

import numpy as np
import pytest

from helios_tpu import tools
from helios_tpu.config import HeliosConfig
from helios_tpu import pipeline
from helios_tpu.io.opacity import save_opacity_file, synthetic_premixed_table
from helios_tpu.ktable.params import (KtableParams, parse_param_ktable_file,
                                      read_param_file_and_command_line)


@pytest.fixture(scope="module")
def run_outputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("run")
    table = synthetic_premixed_table(nbin=12, ny=4, ntemp=8, npress=6)
    cfg = HeliosConfig(name="rd", output_dir=str(tmp) + "/",
                       planet="manual", g=2288.0, a=0.0153, R_planet=1.0,
                       R_star=1.0, T_star=4000.0, T_intern=150.0,
                       scattering="no", direct_beam="no", convection="no",
                       run_type="iterative", iso_input="yes", nlayer=8,
                       p_boa=1e8, p_toa=1e3, rad_convergence_limit=1e-5)
    out = pipeline.run(cfg, table=table)
    return out, os.path.join(str(tmp), "rd")


def test_read_helios_spectrum(run_outputs):
    out, d = run_outputs
    path = os.path.join(d, "rd_TOA_flux_eclipse.dat")
    lam, emis = tools.read_helios_spectrum(path, type="emission")
    assert len(lam) == out.result.nbin
    # the file stores wavelengths in micron (write.py TOA writer)
    np.testing.assert_allclose(lam, out.result.opac_wave * 1e4, rtol=1e-5)
    np.testing.assert_allclose(emis, out.result.F_up_band[out.result.nlayer],
                               rtol=1e-4)
    _, star = tools.read_helios_spectrum(path, type="star",
                                         star_fudge_factor=2.0)
    _, ecl = tools.read_helios_spectrum(path, type="eclipse",
                                        star_fudge_factor=2.0)
    _, star1 = tools.read_helios_spectrum(path, type="star")
    np.testing.assert_allclose(star, 2.0 * star1)
    with pytest.raises(ValueError):
        tools.read_helios_spectrum(path, type="bogus")


def test_read_helios_tp(run_outputs):
    out, d = run_outputs
    press, temp, *zones = tools.read_helios_tp(
        os.path.join(d, "rd_tp.dat"))
    # BOA row + nlayer rows; pressures converted to bar
    assert len(press) == out.result.nlayer + 1
    np.testing.assert_allclose(press[0], out.result.p_int[0] * 1e-6,
                               rtol=1e-5)
    np.testing.assert_allclose(temp[1:], out.result.T_lay[:out.result.nlayer],
                               rtol=1e-5)
    # no convection -> all four zones empty
    assert all(len(z) == 0 for z in zones)


def test_read_helios_tp_convective_zones(tmp_path):
    """Synthetic tp file with two convective zones; the reference's
    zone-splitting picks them up separately (tools.py:440-478)."""
    path = str(tmp_path / "tp.dat")
    conv = [0, 1, 1, 0, 0, 1, 1, 1, 0, 0]
    with open(path, "w") as f:
        f.write("header\ncolumns\n")
        for i, c in enumerate(conv):
            f.write(f"{i} {1000 + i} {10 ** (8 - 0.5 * i):.6e} 0 0 0 {c}\n")
    press, temp, p0, t0, p1, t1, p2, t2, p3, t3 = tools.read_helios_tp(path)
    assert t0 == [1001.0, 1002.0]
    assert t1 == [1005.0, 1006.0, 1007.0]
    assert p2 == [] and p3 == []


def test_read_helios_tp_coupling_format(tmp_path):
    path = str(tmp_path / "tpc.dat")
    with open(path, "w") as f:
        f.write("header\n")
        for i in range(5):
            f.write(f"{10 ** (8 - i):.6e} {900 + i}\n")
    press, temp, *zones = tools.read_helios_tp(path, coupling_format=1)
    assert temp == [900.0, 901.0, 902.0, 903.0, 904.0]
    np.testing.assert_allclose(press[0], 100.0)


def test_rebin_spectrum_to_resolution():
    lam = np.geomspace(1e-5, 1e-3, 5000)
    flux = np.full_like(lam, 7.5)
    new_lam, new_flux = tools.rebin_spectrum_to_resolution(lam, flux, 50.0)
    # R=50 log grid from the first to below the last old wavelength
    assert new_lam[0] == lam[0] and new_lam[-1] < lam[-1]
    ratios = new_lam[1:] / new_lam[:-1]
    np.testing.assert_allclose(ratios, 51.0 / 50.0, rtol=1e-12)
    # constant spectrum is preserved exactly by energy-conserving rebin
    # (first/last bins touch outside the old grid -> extrapolated to 0,
    # like the reference)
    np.testing.assert_allclose(new_flux[1:-1], 7.5, rtol=1e-9)

    # micron units round-trip
    new_um, _ = tools.rebin_spectrum_to_resolution(lam * 1e4, flux, 50.0,
                                                   w_unit="micron")
    np.testing.assert_allclose(new_um, new_lam * 1e4, rtol=1e-12)

    # gaussian mode runs and conserves a constant away from the edges
    _, g = tools.rebin_spectrum_to_resolution(lam, flux, 50.0,
                                              type="gaussian")
    np.testing.assert_allclose(g[5:-5], 7.5, rtol=1e-6)


PARAM_KTABLE = os.path.join(os.path.dirname(__file__), "data",
                            "param_ktable.dat")


def test_param_ktable_reference_file_parses():
    p = parse_param_ktable_file(PARAM_KTABLE)
    assert p.building == "yes" and p.mixing == "yes"
    assert p.format == "k-distribution"
    assert p.heliosk_format == "binary"
    assert p.resolution == 50.0
    assert p.grid_limits == [0.244, 500.0]
    assert p.n_gauss == 20
    assert p.individual_calc_path == "./output/r50_kdistr/"
    assert p.fastchem_path == "../input/chemistry/lodders_m0/"
    assert p.units == "CGS"


def test_param_ktable_cli_overrides(tmp_path):
    p = read_param_file_and_command_line([
        "-parameter_file", PARAM_KTABLE,
        "-format", "sampling", "-number_of_gaussian_points", "31",
        "-units_of_mixed_opacity_table", "MKS",
        "-wavelength_grid", "100 0.5 20",
        "-mixed_table_output_directory", str(tmp_path)])
    assert p.format == "sampling" and p.n_gauss == 31
    assert p.units == "MKS"
    assert p.resolution == 100.0 and p.grid_limits == [0.5, 20.0]
    assert p.final_path == str(tmp_path)


def test_param_ktable_bad_units():
    with pytest.raises(ValueError, match="units"):
        read_param_file_and_command_line(
            ["-units_of_mixed_opacity_table", "IMPERIAL"])


def test_grid_file_mode(tmp_path):
    from helios_tpu.ktable import build as kb
    grid = np.geomspace(1e-4, 1e-3, 21)
    gpath = str(tmp_path / "grid.dat")
    np.savetxt(gpath, grid)
    cfg = kb.BuildConfig(grid_format="file", grid_file_path=gpath)
    lam, lam_int, dlam, y = kb.build_wavelength_grid(cfg)
    np.testing.assert_allclose(lam_int, grid)
    np.testing.assert_allclose(lam, 0.5 * (grid[1:] + grid[:-1]))
    with pytest.raises(IOError):
        kb.build_wavelength_grid(
            kb.BuildConfig(grid_format="native_helios-k"))


def test_startool_cli(tmp_path):
    """python -m helios_tpu.startool main() with a JSON star file."""
    from helios_tpu import constants as pc
    from helios_tpu import host_physics as hp
    from helios_tpu.startool.__main__ import main as st_main

    table = synthetic_premixed_table(nbin=16, ny=4, ntemp=8, npress=6,
                                     lambda_min=0.3e-4, lambda_max=50e-4)
    opac_path = str(tmp_path / "table.h5")
    save_opacity_file(opac_path, table)

    T_star = 4500.0
    lam_um = np.geomspace(0.2, 6.0, 2000)
    flux_1au = (np.pi * hp.planck_lambda_np(lam_um * 1e-4, T_star)
                / (pc.AU / pc.R_SUN) ** 2)
    src = tmp_path / "star.dat"
    with open(src, "w") as f:
        f.write("#\n" * 8)
        for l, fl in zip(lam_um, flux_1au):
            f.write(f"{l:.6e} {fl:.6e}\n")

    star = dict(name="cli", data_format="ascii", temp=T_star,
                source_file=str(src), w_conversion_factor=1e-4,
                flux_conversion_factor=1.0)
    star_json = str(tmp_path / "star.json")
    with open(star_json, "w") as f:
        json.dump(star, f)
    out_h5 = str(tmp_path / "out.h5")

    rc = st_main(["-star_file", star_json, "-opac_file", opac_path,
                  "-output_file", out_h5, "-convert_to", "r50"])
    assert rc == 0
    import h5py
    with h5py.File(out_h5) as f:
        stored = np.asarray(f["/r50/ascii/cli"])
        lam_grid = np.asarray(f["/r50/lambda"])
    assert len(stored) == table.nbin
    assert np.all(stored > 0)
    np.testing.assert_allclose(lam_grid, table.wave_centers)

    # flag-based invocation (no JSON file)
    rc = st_main(["-data_format", "ascii", "-name", "cli2",
                  "-temp", str(T_star), "-source_file", str(src),
                  "-w_conversion_factor", "1e-4",
                  "-flux_conversion_factor", "1.0",
                  "-opac_file", opac_path, "-output_file", out_h5,
                  "-convert_to", "r50"])
    assert rc == 0
    with h5py.File(out_h5) as f:
        assert "/r50/ascii/cli2" in f
