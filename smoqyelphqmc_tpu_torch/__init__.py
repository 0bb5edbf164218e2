"""smoqyelphqmc_tpu_torch: the PyTorch + CUDA port of the JAX package beside it.

The JAX package beside this one is the reference; this package computes the same
functions on one NVIDIA H100 (sm_90a), with hand-written CUDA kernels where the
JAX package has Pallas kernels:

- K1 `ops/mtm.py` + `csrc/mtm.cu`: the M^T M matvec (f32 and f64), replacing
  `_mtm_kernel_roll` (the JAX package's ops/pallas_fused.py);
- K2 `ops/pcg.py` + `csrc/pcg.cu`: the whole-solve spectral PCG, replacing
  `_pcg_kernel` (same file);
- K3 `ops/pcg_force.py` + `csrc/pcg_force.cu`: the same solve with an
  in-kernel warm start and the Holstein force epilogue, over a walker batch,
  replacing `_pcg_force_kernel`;
- K4 `ops/force.py` + `csrc/force.cu`: the force epilogue alone, replacing
  `_force_kernel`;
- K6 and K7 `ops/kpm_mf.py` + `csrc/kpm_mf.cu`: the matrix-free KPM
  preconditioner apply, symmetric and asymmetric factorizations, replacing
  `_kpm_mf_kernel` and `_kpm_mf_asym_kernel`.

K1's partner gather also computes `_mtm_kernel_mm`'s function (K5).

Policy (the JAX package turns x64 on globally; torch defaults to f32):

- every tensor states its dtype; float64 is the default (`DEFAULT_DTYPE`);
- the entry points (`driver.run_updates`, the parameters' `from_model`, the
  `convert` helpers, `TauFourier`) run on the card unless the caller passes
  `device="cpu"`; everything else follows the device of its inputs;
- random draws live outside the compute functions (see `updates/`), made from an
  explicit `torch.Generator`;
- TF32 is off for matmuls and cuDNN: the dense Bbar build and the EFA / Fourier
  paths rely on plain f32 / f64 products.

The package imports neither `jax` nor the JAX package.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DEFAULT_DTYPE = torch.float64

from .lattice import Bond, Lattice, ModelGeometry, UnitCell  # noqa: E402
from .models.electron_phonon import (  # noqa: E402
    DispersionCoupling,
    ElectronPhononModel,
    ElectronPhononParameters,
    HolsteinCoupling,
    PhononMode,
    SSHCoupling,
)
from .models.tight_binding import TightBindingModel, TightBindingParameters  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "DEFAULT_DTYPE",
    "UnitCell",
    "Lattice",
    "Bond",
    "ModelGeometry",
    "TightBindingModel",
    "TightBindingParameters",
    "PhononMode",
    "HolsteinCoupling",
    "SSHCoupling",
    "DispersionCoupling",
    "ElectronPhononModel",
    "ElectronPhononParameters",
]
