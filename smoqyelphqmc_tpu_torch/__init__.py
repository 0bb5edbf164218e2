"""smoqyelphqmc_tpu_torch: the PyTorch + CUDA port of smoqyelphqmc_tpu.

The JAX package beside this one is the reference; this package computes the same
functions on one NVIDIA H100 (sm_90a), with hand-written CUDA kernels where the
JAX package has Pallas kernels:

- K1 `ops/mtm.py` + `csrc/mtm.cu`: the M^T M matvec (f32 and f64), replacing
  `_mtm_kernel_roll` (smoqyelphqmc_tpu/ops/pallas_fused.py);
- K2 `ops/pcg.py` + `csrc/pcg.cu`: the whole-solve spectral PCG, replacing
  `_pcg_kernel` (same file).

Policy (the JAX package turns x64 on globally; torch defaults to f32):

- every tensor states its dtype; float64 is the default (`DEFAULT_DTYPE`);
- every constructor takes an explicit `device`;
- random draws live outside the compute functions (see `updates/`), made from an
  explicit `torch.Generator`;
- TF32 is off for matmuls and cuDNN: the dense Bbar build and the EFA / Fourier
  paths rely on plain f32 / f64 products.

The package imports neither `jax` nor `smoqyelphqmc_tpu`.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DEFAULT_DTYPE = torch.float64

from .lattice import Bond, Lattice, ModelGeometry, UnitCell  # noqa: E402
from .models.electron_phonon import (  # noqa: E402
    ElectronPhononModel,
    ElectronPhononParameters,
    HolsteinCoupling,
    PhononMode,
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
    "ElectronPhononModel",
    "ElectronPhononParameters",
]
