"""Float32 pins for the port's entry points.

The JAX package pins ``Precision.HIGHEST`` on every matmul whose inputs are
30 m-scale coordinates or registration normal equations: a reduced-precision
pass quantizes them to centimetres. On the card the counterpart is keeping
TF32 off for matmuls and convolutions.
"""

import torch


def pin_fp32() -> None:
    """Full float32 matmuls and convolutions (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
