"""Matmul precision of a reference run.

The port pins full float32 at its entry points (``pin_fp32``). Here
``pin_fp32`` does nothing, so that ``use`` decides for a whole run: full
float32 for the reference, TF32 for the control (the nearest precision below
the configuration's float32)."""

import torch

PRECISIONS = ("float32", "tf32")


def pin_fp32() -> None:
    """Leaves the precision ``use`` set."""


def use(precision: str) -> None:
    """Set the matmul and convolution precision of the reference's run."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown reference precision {precision!r}")
    tf32 = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
