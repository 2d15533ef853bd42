"""CFAR detectors: the plain PyTorch versions (``cfar.py``), the CUDA kernels
with their wrapper (``cfar_cuda.py``, counterpart of the JAX package's
``cfar_pallas.py``) and the threshold-factor math (``cfar_factors.py``)."""

from .cfar import (
    CFAR,
    cfar_ca,
    cfar_ca2,
    cfar_goca,
    cfar_goca2,
    cfar_os,
    cfar_os2,
    cfar_soca,
    cfar_soca2,
)
from .cfar_cuda import cfar_detect, cfar_os_plain, cfar_plain
from .cfar_factors import (
    threshold_factor_ca,
    threshold_factor_goca,
    threshold_factor_os,
    threshold_factor_soca,
)
