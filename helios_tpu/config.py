"""Typed configuration covering the reference's full parameter surface.

The knob set mirrors ``param.dat`` plus the ~70 command-line overrides parsed
by the reference (source/read.py:210-988).  ``HeliosConfig`` holds the raw
user-facing values; :meth:`HeliosConfig.finalize` resolves the "automatic"
and derived settings exactly like the reference's derived-settings block
(source/read.py:884-988) and unit conversions (source/host_functions.py:33-48),
producing a ready-to-run config.

A ``param.dat``-compatible file parser (:func:`parse_param_file`) and an
argparse CLI (:func:`build_arg_parser`) are provided so users of the
reference can keep their existing parameter files.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
from dataclasses import dataclass, field
from typing import List, Optional, Union

import numpy as np

from helios_tpu import constants as pc
from helios_tpu import planets


def _yes_no(v) -> int:
    if isinstance(v, (int, np.integer)):
        return int(v)
    s = str(v).strip().lower()
    if s in ("yes", "y", "true", "1", "on"):
        return 1
    if s in ("no", "n", "false", "0", "off"):
        return 0
    raise ValueError(f"Cannot interpret {v!r} as yes/no.")


@dataclass
class HeliosConfig:
    # === GENERAL ===
    name: str = "0"
    output_dir: str = "./output/"
    realtime_plot: Union[str, int] = "no"      # yes, no, or plot interval
    planet_type: str = "gas"                   # rocky, gas, no_atmosphere

    # === GRID ===
    p_toa: float = 1e-1                        # [1e-6 bar]
    p_boa: float = 1e9                         # [1e-6 bar]

    # === ITERATION ===
    run_type: str = "iterative"                # iterative, post-processing
    temp_path: str = "./output/0/0_tp.dat"
    temp_format: str = "helios"                # helios, TP, PT

    # === RADIATION ===
    scattering: Union[str, int] = "yes"
    direct_beam: Union[str, int] = "no"
    f_factor: float = 0.5
    zenith_angle_deg: float = 60.0
    T_intern: float = 30.0
    surf_albedo: Union[str, float] = 0.0       # "file" or number
    albedo_file: str = "./input/albedo.dat"
    albedo_file_header_lines: int = 2
    albedo_file_wavelength_name: str = "Wavelength"
    albedo_file_wavelength_unit: str = "micron"
    albedo_surface_name: str = "Feldspathic"
    approx_f: Union[str, int] = "no"           # rocky: use Koll (2021) formula
    tau_lw: float = 1.0

    # === OPACITY MIXING ===
    opacity_mixing: str = "premixed"           # premixed, on-the-fly
    opacity_path: str = "./input/r50_kdistr_solar_eq.h5"
    species_path: str = "./input/species.dat"
    vmr_file_path: str = "./input/vmr_mix.txt"
    vmr_file_header_lines: int = 1
    vmr_file_press_name: str = "Pressure"
    vmr_file_press_unit: str = "cgs"
    fastchem_dir: str = "./input/chemistry/lodders_m0/"
    species_opacity_dir: str = "./input/opacity/r50_kdistr/"

    # === CONVECTIVE ADJUSTMENT ===
    convection: Union[str, int] = "yes"
    kappa_value: Union[str, float] = 0.285714  # "file", "water_atmo" or number
    kappa_file_path: str = "./input/delad_example.dat"

    # === STELLAR AND PLANETARY PARAMETERS ===
    stellar_model: str = "blackbody"           # blackbody, file
    stellar_path: str = "./input/star_2022.h5"
    stellar_dataset: str = "/r50_kdistr/phoenix/gj1214"
    planet: str = "manual"                     # manual or database name
    g: float = 2000.0                          # [cm s^-2] or log10 if < 10
    a: float = 0.0124                          # [AU] (converted to cm in finalize)
    R_planet: float = 1.0                      # [R_Jup] (converted to cm)
    R_star: float = 1.0                        # [R_Sun] (converted to cm)
    T_star: float = 0.0                        # [K]

    # === CLOUDS ===
    nr_cloud_decks: int = 0
    mie_dirs: List[str] = field(default_factory=list)
    cloud_radius_mode: List[float] = field(default_factory=list)   # [micron]
    cloud_radius_geo_std: List[float] = field(default_factory=list)
    cloud_mixing_ratio_source: str = "manual"  # manual, file
    cloud_file: str = "./input/cloud_file.txt"
    cloud_file_header_lines: int = 1
    cloud_file_press_name: str = "Pressure"
    cloud_file_press_unit: str = "cgs"
    aerosol_names: List[str] = field(default_factory=list)
    cloud_bottom_pressure: List[float] = field(default_factory=list)  # [1e-6 bar]
    cloud_bottom_mixing_ratio: List[float] = field(default_factory=list)
    cloud_to_gas_scale_height: List[float] = field(default_factory=list)

    # === COUPLING ===
    coupling: Union[str, int] = "no"
    coupling_full_output: Union[str, int] = "no"
    coupling_force_eq_chem: Union[str, int] = "yes"
    coupling_speed_up: Union[str, int] = "yes"
    coupling_iter_nr: int = 0
    coupl_tp_write_interval: Union[str, int] = "no"
    coupl_convergence_limit: float = 5e-4

    # === ADVANCED ===
    debug: Union[str, int] = "no"
    precision: str = "double"                  # double, single
    nlayer: Union[str, int] = "automatic"
    iso_input: Union[str, int] = "automatic"   # isothermal layers
    adapt_interval: int = 20
    smooth: Union[str, int] = "no"             # TP profile smoothing
    scat_corr: Union[str, int] = "no"          # improved two-stream correction
    i2s_transition: float = 0.1
    g_0: float = 0.0                           # asymmetry factor
    diffusivity: float = 2.0
    epsi2: float = 0.5                         # second Eddington coefficient
    geom_zenith_corr: Union[str, int] = "automatic"
    flux_calc_method: str = "iteration"        # iteration, matrix
    k_mixing_method: str = "RO"                # correlated-k, RO
    energy_correction: Union[str, int] = "automatic"
    input_dampara: Union[str, float] = "automatic"
    plancktable_dim: int = 8000
    plancktable_step: int = 2
    max_nr_iterations: int = 100000
    rad_convergence_limit: float = 1e-8
    crit_relaxation_numbers: List[float] = field(
        default_factory=lambda: [1e4, 2e4])
    foreplay: int = 0                          # number of prerun timesteps
    physical_tstep: Union[str, float] = "no"   # "no" or seconds
    runtime_limit: float = 86400.0
    force_start_tp_from_file: Union[str, int] = "no"

    # === additional heating (CL-only flags in the reference) ===
    add_heating: Union[str, int] = "no"
    add_heating_path: str = "./input/add_heating.dat"
    add_heating_file_header_lines: int = 2
    add_heating_file_press_name: str = "Pressure"
    add_heating_file_press_unit: str = "cgs"

    # === new in this framework ===
    dtype: str = ""                 # resolved from precision
    n_spectral_shards: int = 1      # device shards of the lambda x y grid
    n_planet_batch: int = 1         # planet-ensemble data-parallel batch
    planet_ensemble_file: str = ""  # per-planet override table (ensemble)
    use_pallas: Union[str, int] = "auto"  # GPU sweep kernel: auto, yes, no
    chunk_iters: int = 100          # device-resident iterations per host sync
    checkpoint_every: int = 0       # iterations per checkpoint (0 = off)
    checkpoint_path: str = ""       # default: <output_dir>/<name>/restart.ckpt.npz
    metrics_file: str = ""          # per-chunk JSONL metrics (empty = off)
    profile_dir: str = ""           # jax.profiler trace of first chunk
    progress: Union[str, int] = "no"  # print per-chunk progress lines

    # ------- derived fields (populated by finalize) -------
    singlewalk: int = 0
    iso: int = 1
    scat: int = 1
    dir_beam: int = 0
    mu_star: float = -0.5
    ninterface: int = 0
    epsi: float = 0.5
    clouds: int = 0
    no_atmo: int = 0
    real_star: int = 0
    F_intern: float = 0.0
    n_plot: int = 10
    w_0_limit: float = 1.0 - 1e-10
    w_0_scat_limit: float = 1e-3
    delta_tau_limit: float = 1e-4
    _finalized: bool = False

    # ----------------------------------------------------------------- #

    def finalize(self) -> "HeliosConfig":
        """Resolve automatic/derived settings; returns a new finalized config.

        Mirrors the reference's derived-settings resolution
        (source/read.py:884-988) and planet_param unit conversion
        (source/host_functions.py:33-48).
        """
        c = dataclasses.replace(self)

        # yes/no normalisation
        c.scat = _yes_no(c.scattering)
        c.dir_beam = _yes_no(c.direct_beam)
        c.convection = _yes_no(c.convection)
        c.smooth = _yes_no(c.smooth)
        c.scat_corr = _yes_no(c.scat_corr)
        c.debug = _yes_no(c.debug)
        c.coupling = _yes_no(c.coupling)
        c.coupling_full_output = _yes_no(c.coupling_full_output)
        c.coupling_force_eq_chem = _yes_no(c.coupling_force_eq_chem)
        c.coupling_speed_up = _yes_no(c.coupling_speed_up)
        c.add_heating = _yes_no(c.add_heating)
        c.force_start_tp_from_file = _yes_no(c.force_start_tp_from_file)
        c.approx_f = _yes_no(c.approx_f)

        if isinstance(c.realtime_plot, str) and c.realtime_plot not in ("yes", "no"):
            c.n_plot = int(float(c.realtime_plot))
            c.realtime_plot = 1
        else:
            c.n_plot = 10
            c.realtime_plot = _yes_no(c.realtime_plot)
        c.progress = _yes_no(c.progress)

        # run type -> singlewalk / iso / energy correction (read.py:888-895)
        if c.run_type == "iterative":
            c.singlewalk = 0
            c.iso = 0
            energy_corr_auto = 1
        elif c.run_type == "post-processing":
            c.singlewalk = 1
            c.iso = 1
            energy_corr_auto = 0
        else:
            raise ValueError(f"Unknown run type {c.run_type!r}")

        if c.energy_correction == "automatic":
            c.energy_correction = energy_corr_auto
        else:
            c.energy_correction = _yes_no(c.energy_correction)

        # isothermal layers override (read.py:933-934)
        if c.iso_input != "automatic":
            c.iso = _yes_no(c.iso_input)

        # zenith angle -> mu_star (read.py:897-899); mu_star is negative
        dir_angle = (180.0 - c.zenith_angle_deg) * math.pi / 180.0
        c.mu_star = float(np.cos(dir_angle))

        # zenith correction automatic for angles > 70 deg (read.py:940-946)
        if c.geom_zenith_corr == "automatic":
            c.geom_zenith_corr = 1 if c.zenith_angle_deg > 70 else 0
        else:
            c.geom_zenith_corr = _yes_no(c.geom_zenith_corr)

        # clouds active?
        if c.nr_cloud_decks < 0:
            raise ValueError("Number of cloud decks must be >= 0.")
        c.clouds = 1 if c.nr_cloud_decks > 0 else 0

        if c.coupling == 1 and c.opacity_mixing == "premixed":
            raise ValueError(
                "Coupling mode cannot be used with a premixed opacity table.")
        if c.coupling == 1 and c.coupling_full_output == 1:
            c.name = f"{c.name}_{c.coupling_iter_nr}"

        # precision -> dtype
        if not c.dtype:
            c.dtype = {"double": "float64", "single": "float32"}[c.precision]

        # planet parameters (host_functions.py:33-48)
        if c.planet != "manual":
            p = planets.lookup(c.planet)
            c.R_planet = p.R_p
            c.g = p.g_p
            c.a = p.a
            c.R_star = p.R_star
            c.T_star = p.T_star
        if c.g < 10:
            c.g = 10.0 ** c.g
        c.a = c.a * pc.AU
        c.R_planet = c.R_planet * pc.R_JUP
        c.R_star = c.R_star * pc.R_SUN
        c.T_star = max(c.T_star, 2.7)   # CMB floor (host_functions.py:48)

        c.real_star = 1 if c.stellar_model == "file" else 0

        # physical timestep
        if c.physical_tstep in ("no", 0, 0.0):
            c.physical_tstep = 0.0
        else:
            c.physical_tstep = float(c.physical_tstep)
        if c.physical_tstep > 0 and c.convection == 0:
            raise ValueError(
                "Physical timestepping needs convective adjustment switched on "
                "(it needs the c_p derived from kappa).")

        # no-atmosphere special mode -- overwrites previous settings
        # (read.py:968-982)
        if c.planet_type == "no_atmosphere":
            c.no_atmo = 1
            c.p_toa = 1e-3
            c.p_boa = 2e-3
            c.scat = 0
            c.convection = 0
            c.nlayer = 2

        # layers (read.py:923-926)
        if c.nlayer == "automatic":
            c.nlayer = int(np.ceil(10.5 * np.log10(c.p_boa / c.p_toa)))
        else:
            c.nlayer = int(c.nlayer)
        c.ninterface = c.nlayer + 1

        # first Eddington coefficient from diffusivity (read.py:937)
        c.epsi = 1.0 / c.diffusivity

        if c.flux_calc_method == "iterative":
            c.flux_calc_method = "iteration"
        if c.flux_calc_method not in ("iteration", "matrix"):
            raise ValueError(
                f"Unknown flux calculation method {c.flux_calc_method!r}")

        # coupling TP write interval
        if c.coupl_tp_write_interval in ("no", 0):
            c.coupl_tp_write_interval = 0
        else:
            c.coupl_tp_write_interval = int(c.coupl_tp_write_interval)

        # internal heat flux F_intern = sigma T_int^4 (host_functions.py:203)
        c.F_intern = pc.SIGMA_SB * float(c.T_intern) ** 4.0

        # numerical limits (host_functions.py:209-222)
        c.w_0_limit = 1.0 - 1e-10
        c.w_0_scat_limit = 1e-3
        c.delta_tau_limit = 1e-4

        # surface albedo numeric clamp (read.py:1260-1262)
        if not isinstance(c.surf_albedo, str):
            c.surf_albedo = max(1e-8, min(0.999, float(c.surf_albedo)))

        c._finalized = True
        return c

    @property
    def np_dtype(self):
        return np.dtype(self.dtype if self.dtype else "float64")


# --------------------------------------------------------------------------- #
# param.dat-compatible parser
# --------------------------------------------------------------------------- #

# map of normalized param.dat keys -> (config field, converter)
def _num(x):
    v = float(x)
    return v


def _num_or_str(x):
    try:
        return float(x)
    except ValueError:
        return x


def _int_or_str(x):
    try:
        return int(float(x))
    except ValueError:
        return x


_PARAM_KEYS = {
    "name": ("name", str),
    "output directory": ("output_dir", str),
    "realtime plotting": ("realtime_plot", str),
    "planet type": ("planet_type", str),
    "toa pressure [10^-6 bar]": ("p_toa", _num),
    "boa pressure [10^-6 bar]": ("p_boa", _num),
    "run type": ("run_type", str),
    "path to temperature file": ("temp_path", str),
    "temperature file format": ("temp_format", str),
    "scattering": ("scattering", str),
    "direct irradiation beam": ("direct_beam", str),
    "f factor": ("f_factor", _num),
    "stellar zenith angle [deg]": ("zenith_angle_deg", _num),
    "internal temperature [k]": ("T_intern", _num),
    "surface albedo": ("surf_albedo", _num_or_str),
    "path to albedo file": ("albedo_file", str),
    "surface name": ("albedo_surface_name", str),
    "use f approximation formula": ("approx_f", str),
    "opacity mixing": ("opacity_mixing", str),
    "path to opacity file": ("opacity_path", str),
    "path to species file": ("species_path", str),
    "file with vertical mixing ratios": ("vmr_file_path", str),
    "directory with fastchem files": ("fastchem_dir", str),
    "directory with opacity files": ("species_opacity_dir", str),
    "convective adjustment": ("convection", str),
    "kappa value": ("kappa_value", _num_or_str),
    "kappa file path": ("kappa_file_path", str),
    "stellar spectral model": ("stellar_model", str),
    "path to stellar spectrum file": ("stellar_path", str),
    "dataset in stellar spectrum file": ("stellar_dataset", str),
    "planet": ("planet", str),
    "surface gravity [cm s^-2]": ("g", _num),
    "orbital distance [au]": ("a", _num),
    "radius planet [r_jup]": ("R_planet", _num),
    "radius star [r_sun]": ("R_star", _num),
    "temperature star [k]": ("T_star", _num),
    "number of cloud decks": ("nr_cloud_decks", _int_or_str),
    "path to mie files": ("mie_dirs", None),
    "aerosol radius mode [micron]": ("cloud_radius_mode", None),
    "aerosol radius geometric std dev": ("cloud_radius_geo_std", None),
    "cloud mixing ratio": ("cloud_mixing_ratio_source", str),
    "path to file with cloud data": ("cloud_file", str),
    "aerosol name": ("aerosol_names", None),
    "cloud bottom pressure [10^-6 bar]": ("cloud_bottom_pressure", None),
    "cloud bottom mixing ratio": ("cloud_bottom_mixing_ratio", None),
    "cloud to gas scale height ratio": ("cloud_to_gas_scale_height", None),
    "coupling mode": ("coupling", str),
    "full output each iteration step": ("coupling_full_output", str),
    "force eq chem for first iteration": ("coupling_force_eq_chem", str),
    "coupling speed up": ("coupling_speed_up", str),
    "coupling iteration step": ("coupling_iter_nr", _int_or_str),
    "debugging feedback": ("debug", str),
    "precision": ("precision", str),
    "number of layers": ("nlayer", _int_or_str),
    "isothermal layers": ("iso_input", str),
    "adaptive interval": ("adapt_interval", _int_or_str),
    "tp profile smoothing": ("smooth", str),
    "improved two stream correction": ("scat_corr", str),
    "i2s transition point": ("i2s_transition", _num),
    "asymmetry factor g_0": ("g_0", _num),
    "diffusivity factor": ("diffusivity", _num),
    "second eddington coefficient": ("epsi2", _num),
    "geometric zenith angle correction": ("geom_zenith_corr", str),
    "flux calculation method": ("flux_calc_method", str),
    "k coefficients mixing method": ("k_mixing_method", str),
    "energy budget correction": ("energy_correction", str),
    "convective damping parameter": ("input_dampara", _num_or_str),
    "plancktable dimension and stepsize": ("plancktable_dim", None),
    "maximum number of iterations": ("max_nr_iterations", _int_or_str),
    "radiative equilibrium criterion": ("rad_convergence_limit", _num),
    "relax radiative criterion at": ("crit_relaxation_numbers", None),
    "number of prerun timesteps": ("foreplay", _int_or_str),
    "physical timestep [s]": ("physical_tstep", _num_or_str),
    "runtime limit [s]": ("runtime_limit", _num),
    "start from provided tp profile": ("force_start_tp_from_file", str),
}


def parse_param_file(path: str,
                     base: Optional[HeliosConfig] = None) -> HeliosConfig:
    """Parse a reference-format ``param.dat`` file into a HeliosConfig."""
    cfg = base if base is not None else HeliosConfig()

    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            key_part, _, value_part = line.partition("=")
            key = key_part.strip().lstrip("-> ").strip().lower()
            # remove leading option markers like "file -->", "yes -->"
            for marker in ("-->",):
                if marker in key:
                    key = key.split(marker, 1)[1].strip()
            # drop trailing bracketed comment columns
            tokens = value_part.split()
            # strip anything starting at the first '[' (format hints)
            vals = []
            for t in tokens:
                if t.startswith("["):
                    break
                vals.append(t)
            if not vals:
                continue
            if key not in _PARAM_KEYS:
                continue
            fieldname, conv = _PARAM_KEYS[key]
            if fieldname == "plancktable_dim":
                cfg.plancktable_dim = int(float(vals[0]))
                if len(vals) > 1:
                    cfg.plancktable_step = int(float(vals[1]))
            elif fieldname == "crit_relaxation_numbers":
                cfg.crit_relaxation_numbers = [float(v) for v in vals]
            elif fieldname in ("mie_dirs", "aerosol_names"):
                setattr(cfg, fieldname, vals)
            elif fieldname in ("cloud_radius_mode", "cloud_radius_geo_std",
                               "cloud_bottom_pressure",
                               "cloud_bottom_mixing_ratio",
                               "cloud_to_gas_scale_height"):
                setattr(cfg, fieldname, [float(v) for v in vals])
            else:
                value = " ".join(vals) if conv is str else conv(vals[0])
                setattr(cfg, fieldname, value)

            # special sub-format lines with extra columns
            if key == "albedo file format" and len(vals) >= 3:
                cfg.albedo_file_header_lines = int(vals[0])
                cfg.albedo_file_wavelength_name = vals[1]
                cfg.albedo_file_wavelength_unit = vals[2]
            if key == "vertical vmr file format" and len(vals) >= 3:
                cfg.vmr_file_header_lines = int(vals[0])
                cfg.vmr_file_press_name = vals[1]
                cfg.vmr_file_press_unit = vals[2]
            if key == "cloud file format" and len(vals) >= 3:
                cfg.cloud_file_header_lines = int(vals[0])
                cfg.cloud_file_press_name = vals[1]
                cfg.cloud_file_press_unit = vals[2]
    return cfg


# --------------------------------------------------------------------------- #
# command-line interface (the reference's ~70 argparse overrides)
# --------------------------------------------------------------------------- #

def _csv_str(s: str) -> List[str]:
    """Comma- or space-separated list of strings (one entry per cloud deck).

    The reference CL override wraps a single value in a one-element list
    (read.py:762-787); comma splitting is a compatible superset for multi-deck
    command lines.
    """
    return [v for v in s.replace(",", " ").split()]


def _csv_float(s: str) -> List[float]:
    return [float(v) for v in s.replace(",", " ").split()]


_CLI_FLAGS = [
    # (flag, config field, type)
    ("-name", "name", str),
    ("-output_directory", "output_dir", str),
    ("-realtime_plotting", "realtime_plot", str),
    ("-planet_type", "planet_type", str),
    ("-toa_pressure", "p_toa", float),
    ("-boa_pressure", "p_boa", float),
    ("-run_type", "run_type", str),
    ("-path_to_temperature_file", "temp_path", str),
    ("-temperature_file_format", "temp_format", str),
    ("-scattering", "scattering", str),
    ("-direct_irradiation_beam", "direct_beam", str),
    ("-f_factor", "f_factor", float),
    ("-stellar_zenith_angle", "zenith_angle_deg", float),
    ("-internal_temperature", "T_intern", float),
    ("-surface_albedo", "surf_albedo", str),
    ("-path_to_albedo_file", "albedo_file", str),
    ("-surface_name", "albedo_surface_name", str),
    ("-use_f_approximation_formula", "approx_f", str),
    ("-opacity_mixing", "opacity_mixing", str),
    ("-path_to_opacity_file", "opacity_path", str),
    ("-path_to_species_file", "species_path", str),
    ("-file_with_vertical_mixing_ratios", "vmr_file_path", str),
    ("-directory_with_fastchem_files", "fastchem_dir", str),
    ("-directory_with_opacity_files", "species_opacity_dir", str),
    ("-convective_adjustment", "convection", str),
    ("-kappa_value", "kappa_value", str),
    ("-kappa_file_path", "kappa_file_path", str),
    ("-stellar_spectral_model", "stellar_model", str),
    ("-path_to_stellar_spectrum_file", "stellar_path", str),
    ("-dataset_in_stellar_spectrum_file", "stellar_dataset", str),
    ("-planet", "planet", str),
    ("-surface_gravity", "g", float),
    ("-orbital_distance", "a", float),
    ("-radius_planet", "R_planet", float),
    ("-radius_star", "R_star", float),
    ("-temperature_star", "T_star", float),
    ("-number_of_cloud_decks", "nr_cloud_decks", int),
    ("-cloud_mixing_ratio", "cloud_mixing_ratio_source", str),
    ("-path_to_file_with_cloud_data", "cloud_file", str),
    # per-deck cloud flags (reference read.py:762-787)
    ("-path_to_mie_files", "mie_dirs", _csv_str),
    ("-aerosol_name", "aerosol_names", _csv_str),
    ("-aerosol_radius_mode", "cloud_radius_mode", _csv_float),
    ("-aerosol_radius_geometric_std_dev", "cloud_radius_geo_std", _csv_float),
    ("-cloud_bottom_pressure", "cloud_bottom_pressure", _csv_float),
    ("-cloud_bottom_mixing_ratio", "cloud_bottom_mixing_ratio", _csv_float),
    ("-cloud_to_gas_scale_height_ratio", "cloud_to_gas_scale_height", _csv_float),
    ("-coupling_mode", "coupling", str),
    ("-coupling_full_output", "coupling_full_output", str),
    # reference spelling of the same switch (read.py:793-794)
    ("-full_output_each_iteration_step", "coupling_full_output", str),
    ("-force_eq_chem_for_first_iteration", "coupling_force_eq_chem", str),
    ("-coupling_speed_up", "coupling_speed_up", str),
    ("-coupling_iteration_step", "coupling_iter_nr", int),
    ("-write_tp_profile_during_run", "coupl_tp_write_interval", str),
    ("-convergence_criterion", "coupl_convergence_limit", float),
    ("-include_additional_heating", "add_heating", str),
    ("-path_to_heating_file", "add_heating_path", str),
    ("-debugging_feedback", "debug", str),
    ("-precision", "precision", str),
    ("-number_of_layers", "nlayer", str),
    ("-isothermal_layers", "iso_input", str),
    ("-adaptive_interval", "adapt_interval", int),
    ("-tp_profile_smoothing", "smooth", str),
    ("-improved_two_stream_correction", "scat_corr", str),
    ("-i2s_transition_point", "i2s_transition", float),
    ("-asymmetry_factor_g_0", "g_0", float),
    ("-diffusivity_factor", "diffusivity", float),
    ("-second_eddington_coefficient", "epsi2", float),
    ("-geometric_zenith_angle_correction", "geom_zenith_corr", str),
    ("-flux_calculation_method", "flux_calc_method", str),
    ("-k_coefficients_mixing_method", "k_mixing_method", str),
    ("-energy_budget_correction", "energy_correction", str),
    ("-convective_damping_parameter", "input_dampara", str),
    ("-maximum_number_of_iterations", "max_nr_iterations", int),
    ("-radiative_equilibrium_criterion", "rad_convergence_limit", float),
    ("-number_of_prerun_timesteps", "foreplay", int),
    ("-physical_timestep", "physical_tstep", str),
    ("-runtime_limit", "runtime_limit", float),
    ("-start_from_provided_tp_profile", "force_start_tp_from_file", str),
    ("-n_spectral_shards", "n_spectral_shards", int),
    ("-n_planet_batch", "n_planet_batch", int),
    ("-planet_ensemble_file", "planet_ensemble_file", str),
    ("-use_pallas", "use_pallas", str),
    ("-checkpoint_every", "checkpoint_every", int),
    ("-checkpoint_path", "checkpoint_path", str),
    ("-metrics_file", "metrics_file", str),
    ("-profile_dir", "profile_dir", str),
    ("-progress", "progress", str),
]


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m helios_tpu",
        description="HELIOS in JAX: two-stream radiative transfer in "
                    "radiative-convective equilibrium.")
    ap.add_argument("-parameter_file", default="param.dat",
                    help="path to a param.dat-format parameter file")
    for flag, fieldname, typ in _CLI_FLAGS:
        ap.add_argument(flag, dest=fieldname, type=typ, default=None)
    return ap


def config_from_cli(argv=None, finalize: bool = True) -> HeliosConfig:
    ap = build_arg_parser()
    args = ap.parse_args(argv)
    import os
    if os.path.exists(args.parameter_file):
        cfg = parse_param_file(args.parameter_file)
    else:
        cfg = HeliosConfig()
    for flag, fieldname, _typ in _CLI_FLAGS:
        v = getattr(args, fieldname, None)
        if v is not None:
            setattr(cfg, fieldname, v)
    return cfg.finalize() if finalize else cfg
