"""Workloads at the reference's full width, built in memory from a seed.

105 layers x 385 wavelength bins x 20 Gauss points (the reference's R=50
k-distribution setup, SURVEY.md section 0) with a synthetic opacity
table, so a run needs no input files.  Shared by bench.py and
chip_smoke.py.
"""

from __future__ import annotations

import os

import numpy as np

from helios_tpu import chem
from helios_tpu import grid as grid_mod
from helios_tpu.config import HeliosConfig
from helios_tpu.io.opacity import OpacityTable, synthetic_premixed_table

NBIN, NY = 385, 20

# The production-default run type at the flagship shape: non-isothermal
# (the reference's iterative run_type sets iso=0, read.py:888-895),
# scattering and convection on, an irradiated hot Jupiter with a thick
# interior (10x opacity, T_intern = 500 K, kappa = 0.25), so the run
# exercises both phases: the radiative loop hands over to the convective
# one, which then converges.
FLAGSHIP = dict(
    planet="manual", g=2140.0, a=0.03142, R_planet=1.138, R_star=0.805,
    T_star=5040.0, T_intern=500.0, scattering="yes", direct_beam="no",
    convection="yes", kappa_value=0.25, run_type="iterative",
    iso_input="no", adapt_interval=6, realtime_plot="no")


def flagship_table(seed: int = 0) -> OpacityTable:
    table = synthetic_premixed_table(nbin=NBIN, ny=NY, seed=seed)
    table.kpoints *= 10.0           # optically thick -> convective
    return table


def flagship_start_profile(p_lay: np.ndarray) -> np.ndarray:
    """Super-adiabatic deep start (slope 0.30 > kappa 0.25 wherever the
    900 K floor does not bind): whether the convective phase engages is
    trajectory-dependent in this marginally convective atmosphere, and the
    steep start pins the run on the convective branch.  [L+1] with the
    surface ghost layer at index L."""
    T = np.clip(4300.0 * (p_lay / p_lay[0]) ** 0.30, 900.0, None)
    return np.append(T, T[0])


def flagship_config(output_dir: str, name: str = "flagship",
                    **over) -> HeliosConfig:
    """Finalized flagship config for `pipeline.run`.

    Writes the start profile (`flagship_start_profile`) as a pressure /
    temperature file under ``output_dir`` and points the config at it.
    """
    cfg = HeliosConfig(name=name, output_dir=output_dir,
                       **{**FLAGSHIP, **over}).finalize()
    g = grid_mod.build_grid(cfg.p_boa, cfg.p_toa, cfg.nlayer, cfg.g)
    T0 = flagship_start_profile(g.p_lay)
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, f"{name}_start_tp.dat")
    # pressure in 10^-6 bar (= cgs) at the layer centres; the BOA value is
    # clamped to the deepest layer's, as the profile's ghost layer is
    np.savetxt(path, np.column_stack([g.p_lay, T0[:-1]]))
    cfg.force_start_tp_from_file = 1
    cfg.temp_path = path
    cfg.temp_format = "PT"
    return cfg


def onthefly_species(nlayer: int = 105, seed: int = 1):
    """(donor table, SpeciesSet) for on-the-fly mixing at the flagship
    shape: H2O and CO2 absorbing, H2 Rayleigh scattering, He inert."""
    donor = synthetic_premixed_table(nbin=NBIN, ny=NY, ntemp=8, npress=6,
                                     seed=seed)
    specs = [chem.SpeciesSpec("H2O", True, False, "1e-3"),
             chem.SpeciesSpec("CO2", True, False, "1e-4"),
             chem.SpeciesSpec("H2", False, True, "0.9"),
             chem.SpeciesSpec("He", False, False, "0.1")]
    sset = chem.build_species_set(
        specs, ktemps=donor.temperatures, kpress=donor.pressures,
        nbin=NBIN, ny=NY, nlayer=nlayer,
        opacity_tables={"H2O": donor.kpoints, "CO2": donor.kpoints * 3.0},
        scat_tables={"H2": 8.49e-45 / donor.wave_centers ** 4})
    return donor, sset
