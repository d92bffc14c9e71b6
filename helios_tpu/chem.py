"""On-the-fly opacity mixing: species sets, VMR sources, device mixing.

Rebuild of the reference's on-the-fly mode (computation.py:1454-1501,
read.py:1324-1645, host_functions.py:783-958) with one structural change:
the reference pulls temperatures to the host every 10th iteration to
interpolate FastChem abundances with scipy; here the pretabulated VMR
tables live on device and are interpolated with the same bilinear op as
the opacities, so the whole mixing pass stays inside the jitted iteration.

A species' VMR source is one of
  * a constant (from the species file),
  * a vertical profile (from a VMR file, interpolated in log-P at load),
  * FastChem: pretabulated chem.dat abundances, interpolated offline onto
    the opacity (T, P) grid and on-the-fly onto the current T-P profile.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, NamedTuple, Optional, Sequence

import numpy as np

import jax.numpy as jnp

from helios_tpu import constants as pc
from helios_tpu import species as sdb
from helios_tpu.ops import interp as interp_ops
from helios_tpu.ops import mixing as mix_ops


@dataclass
class SpeciesSpec:
    """Static per-species configuration (reference Species class +
    species-file row, read.py:1324-1408)."""
    name: str
    absorbing: bool
    scattering: bool
    source_for_vmr: str        # "file" | "FastChem" | numeric string
    weight: float = None       # [g/mol]
    fc_name: str = None

    def __post_init__(self):
        if self.weight is None:
            info = sdb.SPECIES.get(self.name)
            if info is None:
                raise IOError(
                    f"Species {self.name!r} not found in the species "
                    "database.")
            self.weight = info.weight
            self.fc_name = info.fc_name

    @property
    def mass(self) -> float:
        return self.weight * pc.AMU

    @property
    def counts_for_meanmolmass(self) -> bool:
        return sdb.is_mean_molmass_contributor(self.name)


class SpeciesDeviceData(NamedTuple):
    """Per-species device arrays (zeros where unused)."""
    opacity_pretab: jnp.ndarray   # [ntemp, npress, B, Y]
    scat_cross: jnp.ndarray       # [B] pretabulated Rayleigh cross-section
    vmr_pretab: jnp.ndarray       # [ntemp, npress] (FastChem source)
    vmr_profile_lay: jnp.ndarray  # [L] (constant or file source)
    vmr_profile_int: jnp.ndarray  # [L+1]


@dataclass
class SpeciesSet:
    """The full on-the-fly species configuration + device data."""
    specs: List[SpeciesSpec]
    data: List[SpeciesDeviceData]
    ktemps: jnp.ndarray           # opacity-table T grid
    kpress: jnp.ndarray           # opacity-table P grid

    def __post_init__(self):
        assert len(self.specs) == len(self.data)
        if not any(s.absorbing for s in self.specs):
            raise IOError("At least one species needs to be absorbing.")
        # reshuffle so the first entry absorbs (read.py:1373-1384); the
        # first species is mixed by plain addition, all later ones by RO
        for i, s in enumerate(self.specs):
            if s.absorbing:
                if i != 0:
                    self.specs.insert(0, self.specs.pop(i))
                    self.data.insert(0, self.data.pop(i))
                break


def parse_species_file(path: str) -> List[SpeciesSpec]:
    """Read the species input file (read.py:1324-1361).  The H- row
    expands into H-_bf and H-_ff pseudo-species."""
    specs = []
    with open(path) as f:
        next(f)
        for line in f:
            col = line.split()
            if not col:
                continue
            name, absorbing, scattering, source = (
                col[0], col[1] == "yes", col[2] == "yes", col[3])
            if name == "H-":
                specs.append(SpeciesSpec("H-_bf", absorbing, scattering,
                                         source))
                specs.append(SpeciesSpec("H-_ff", absorbing, scattering,
                                         source))
            else:
                specs.append(SpeciesSpec(name, absorbing, scattering,
                                         source))
    return specs


def constant_vmr_profile(spec: SpeciesSpec, nlayer: int, dtype=np.float64):
    """Constant-VMR profiles; CIA rows hold 'x&y' pair products
    (read.py:1501-1518)."""
    if "CIA" in spec.name:
        a, b = spec.source_for_vmr.split("&")
        v = float(a) * float(b)
    else:
        v = float(spec.source_for_vmr)
    return (np.full(nlayer, v, dtype), np.full(nlayer + 1, v, dtype))


def vertical_vmr_from_file(vmr_table: dict, spec: SpeciesSpec,
                           file_press: np.ndarray, p_lay: np.ndarray,
                           p_int: np.ndarray):
    """Vertical VMR profile from a file table, interpolated in log-P
    (read.py:1520-1569).  ``vmr_table`` maps column name -> array."""
    if ("CIA" not in spec.name) and ("H-" not in spec.name) \
            and spec.name != "He-":
        v = np.asarray(vmr_table[spec.name], float)
    elif "CIA" in spec.name:
        n1, n2 = spec.fc_name.split("&")
        name1 = next(k for k, s in sdb.SPECIES.items() if s.fc_name == n1)
        name2 = next(k for k, s in sdb.SPECIES.items() if s.fc_name == n2)
        v = (np.asarray(vmr_table[name1], float)
             * np.asarray(vmr_table[name2], float))
    elif spec.name == "H-_bf":
        v = np.asarray(vmr_table["H-"], float)
    elif spec.name == "H-_ff":
        v = (np.asarray(vmr_table["H"], float)
             * np.asarray(vmr_table["e-"], float))
    elif spec.name == "He-":
        v = (np.asarray(vmr_table["He"], float)
             * np.asarray(vmr_table["e-"], float))

    logf = np.log10(file_press)
    order = np.argsort(logf)
    logf, v = logf[order], v[order]
    vmr_lay = np.interp(np.log10(p_lay), logf, v)
    vmr_int = np.interp(np.log10(p_int), logf, v)
    return vmr_lay, vmr_int


def load_fastchem_table(fastchem_dir: str):
    """Load FastChem chem.dat (or chem_low/high.dat pair) into a dict of
    column -> [nT*nP] arrays plus the (T, P[cgs]) grids (read.py:1410-1442).
    """
    import os
    delete = " !#$%&'()*,./:;<=>?@[\\]^{|}~"
    single = os.path.join(fastchem_dir, "chem.dat")
    if os.path.exists(single):
        data = np.genfromtxt(single, names=True, dtype=None,
                             deletechars=delete)
    else:
        low = np.genfromtxt(os.path.join(fastchem_dir, "chem_low.dat"),
                            names=True, dtype=None, deletechars=delete)
        high = np.genfromtxt(os.path.join(fastchem_dir, "chem_high.dat"),
                             names=True, dtype=None, deletechars=delete)
        data = np.concatenate([low, high])
    press = np.sort(np.unique(data["Pbar"])) * 1e6
    temps = np.sort(np.unique(data["Tk"]))
    return data, temps, press


def fastchem_vmr_to_opacity_grid(chem_vmr, fc_temps, fc_press, ktemps,
                                 kpress):
    """Bilinear interpolation (linear T, log P, edge-clamped) of a FastChem
    column onto the opacity-table grid (host_functions.py:783-871).

    chem_vmr: [n_fcT * n_fcP] ordered P-fastest.  Returns [ntemp, npress].
    """
    nt, npf = len(fc_temps), len(fc_press)
    grid = np.asarray(chem_vmr, float).reshape(nt, npf)
    logp_f = np.log10(fc_press)

    out = np.empty((len(ktemps), len(kpress)))
    t_idx = np.clip(np.searchsorted(fc_temps, ktemps, side="right") - 1,
                    0, nt - 1)
    p_idx = np.clip(np.searchsorted(fc_press, kpress, side="right") - 1,
                    0, npf - 1)
    for i, (T, ti) in enumerate(zip(ktemps, t_idx)):
        ti2 = min(ti + 1, nt - 1)
        wt = 0.0 if ti2 == ti else ((T - fc_temps[ti])
                                    / (fc_temps[ti2] - fc_temps[ti]))
        wt = 0.0 if ti == nt - 1 or T < fc_temps[0] else wt
        for j, (P, pi) in enumerate(zip(kpress, p_idx)):
            pi2 = min(pi + 1, npf - 1)
            wp = 0.0 if pi2 == pi else ((np.log10(P) - logp_f[pi])
                                        / (logp_f[pi2] - logp_f[pi]))
            wp = 0.0 if pi == npf - 1 or P < fc_press[0] else wp
            out[i, j] = (grid[ti, pi] * (1 - wt) * (1 - wp)
                         + grid[ti, pi2] * (1 - wt) * wp
                         + grid[ti2, pi] * wt * (1 - wp)
                         + grid[ti2, pi2] * wt * wp)
    return out


def fastchem_column(data, spec: SpeciesSpec):
    """FastChem abundance column for a species, incl. '&' pair products
    (read.py:1571-1596)."""
    if ("CIA" not in spec.name) and spec.name not in ("H-_ff", "He-"):
        return np.asarray(data[spec.fc_name], float)
    n1, n2 = spec.fc_name.split("&")
    return np.asarray(data[n1], float) * np.asarray(data[n2], float)


# --------------------------------------------------------------------------- #
# device-side per-iteration computation
# --------------------------------------------------------------------------- #

def species_vmr(spec: SpeciesSpec, dat: SpeciesDeviceData, sset: SpeciesSet,
                T, p):
    """VMR of one species on the current profile (layers or interfaces)."""
    if spec.source_for_vmr == "FastChem":
        return interp_ops.bilinear_tp(dat.vmr_pretab, sset.ktemps,
                                      sset.kpress, T, p, clamp_lo=0.0)
    if T.shape[0] == dat.vmr_profile_lay.shape[0]:
        return dat.vmr_profile_lay
    return dat.vmr_profile_int


def mean_molecular_mass(sset: SpeciesSet, T, p):
    """Mean molecular mass [g] from the species VMRs
    (host_functions.py:927-958)."""
    num = 0.0
    den = 0.0
    for spec, dat in zip(sset.specs, sset.data):
        if not spec.counts_for_meanmolmass:
            continue
        vmr = species_vmr(spec, dat, sset, T, p)
        num = num + vmr * spec.weight
        den = den + vmr
    return num / den * pc.AMU


def mixed_opacities(sset: SpeciesSet, T, p, wave_centers, gauss_weight,
                    gauss_y, *, ro_method: int, scat: int):
    """One full mixing pass: (T, p) profile -> (opac [n,B,Y], scat [n,B],
    meanmolmass [n]) (computation.py:1454-1501).

    The species loop is unrolled at trace time (the list is static).
    """
    n = T.shape[0]
    nbin = wave_centers.shape[0]
    ny = gauss_y.shape[0]
    dtype = T.dtype

    meanmolmass = mean_molecular_mass(sset, T, p)

    opac = jnp.zeros((n, nbin, ny), dtype)
    scat_cross = jnp.zeros((n, nbin), dtype)

    for s, (spec, dat) in enumerate(zip(sset.specs, sset.data)):
        vmr = species_vmr(spec, dat, sset, T, p)

        if spec.absorbing:
            opac_spec = interp_ops.interpolate_species_opacity(
                dat.opacity_pretab, sset.ktemps, sset.kpress, T, p)
            opac = mix_ops.add_species_opacity(
                opac, opac_spec, vmr, spec.mass, meanmolmass,
                gauss_weight, gauss_y, species_index=s,
                ro_method=ro_method)

        if spec.scattering and scat:
            if spec.name == "H2O":
                sigma = mix_ops.h2o_scat_cross(wave_centers, p, T, vmr,
                                               spec.mass)
            else:
                sigma = dat.scat_cross[None, :]
            scat_cross = scat_cross + vmr[:, None] * sigma

    return opac, scat_cross, meanmolmass


# --------------------------------------------------------------------------- #
# assembly
# --------------------------------------------------------------------------- #

def build_species_set(specs: Sequence[SpeciesSpec], *,
                      ktemps, kpress, nbin: int, ny: int, nlayer: int,
                      opacity_tables: dict = None,
                      scat_tables: dict = None,
                      vmr_file_table: dict = None,
                      vmr_file_press: np.ndarray = None,
                      fastchem_dir: str = None,
                      fastchem_data: tuple = None,
                      p_lay=None, p_int=None,
                      dtype=np.float64) -> SpeciesSet:
    """Assemble the device data for a species list.

    opacity_tables: name -> [ntemp, npress, nbin, ny] arrays.
    scat_tables: name -> [nbin] Rayleigh cross sections.
    fastchem_data: pre-loaded (data, temps, press_cgs) triple in the
        `load_fastchem_table` convention -- e.g. from
        `chem_analytic.as_fastchem_table` -- used instead of reading
        chem.dat from ``fastchem_dir``.
    """
    ntemp, npress = len(ktemps), len(kpress)
    fc = None
    if any(s.source_for_vmr == "FastChem" for s in specs):
        if fastchem_data is not None:
            fc_data, fc_temps, fc_press = fastchem_data
        else:
            fc_data, fc_temps, fc_press = load_fastchem_table(fastchem_dir)

    data = []
    for spec in specs:
        opac = np.zeros((1, 1, nbin, ny), dtype)
        if spec.absorbing:
            opac = np.asarray(opacity_tables[spec.name], dtype)
            assert opac.shape == (ntemp, npress, nbin, ny), (
                f"{spec.name}: {opac.shape}")
        sc = np.zeros(nbin, dtype)
        if spec.scattering and spec.name != "H2O" and scat_tables:
            sc = np.asarray(scat_tables[spec.name], dtype)

        vmr_pre = np.zeros((2, 2), dtype)
        vmr_lay = np.zeros(nlayer, dtype)
        vmr_int = np.zeros(nlayer + 1, dtype)
        if spec.source_for_vmr == "FastChem":
            col = fastchem_column(fc_data, spec)
            vmr_pre = fastchem_vmr_to_opacity_grid(
                col, fc_temps, fc_press, np.asarray(ktemps),
                np.asarray(kpress)).astype(dtype)
        elif spec.source_for_vmr == "file":
            vmr_lay, vmr_int = vertical_vmr_from_file(
                vmr_file_table, spec, vmr_file_press,
                np.asarray(p_lay), np.asarray(p_int))
        else:
            vmr_lay, vmr_int = constant_vmr_profile(spec, nlayer, dtype)

        data.append(SpeciesDeviceData(
            opacity_pretab=jnp.asarray(opac),
            scat_cross=jnp.asarray(sc),
            vmr_pretab=jnp.asarray(vmr_pre),
            vmr_profile_lay=jnp.asarray(vmr_lay),
            vmr_profile_int=jnp.asarray(vmr_int)))

    return SpeciesSet(specs=list(specs), data=data,
                      ktemps=jnp.asarray(ktemps),
                      kpress=jnp.asarray(kpress))
