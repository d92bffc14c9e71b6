"""HELIOS in JAX: a radiative-transfer framework for exoplanet atmospheres.

A from-scratch JAX/XLA/Pallas implementation of the physics covered by the
reference HELIOS code (exoclime/HELIOS): hemispheric two-stream radiative
transfer with non-isotropic multiple scattering, opacity interpolation and
on-the-fly mixing (correlated-k and Random Overlap), convective adjustment,
and the radiative-convective-equilibrium temperature iteration.  It runs on
NVIDIA GPUs (and on the CPU for tests):

* dense ``[layer, bin, y]`` arrays instead of flat 1-D device buffers,
* XLA-compiled whole-iteration steps (no host round-trips inside the RCE loop),
* a fused Pallas (Triton) kernel for the sequential layer recursion of the
  flux sweeps, with a ``lax.scan`` form as its reference,
* ``jax.sharding`` meshes for multi-device spectral x planet-ensemble scaling.

Double precision (the reference default) requires x64 mode, enabled here at
import; the GPU runs it natively.  Single precision is available through the
config (``precision``), mirroring the reference's ``USE_SINGLE`` switch
(kernels.cu:24-32).
"""

import os as _os

import jax as _jax

if _os.environ.get("HELIOS_TPU_DISABLE_X64", "0") != "1":
    _jax.config.update("jax_enable_x64", True)

__version__ = "0.1.0"

from helios_tpu import constants  # noqa: E402,F401
from helios_tpu.config import HeliosConfig  # noqa: E402,F401
