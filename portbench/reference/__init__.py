"""Plain PyTorch references of the benchmarked codecs.

Written from the codecs' published descriptions, in float32 with TF32 off,
and importing nothing of the program under test: the reference spreads its
own watermarks, transforms its own frames and decides its own bits.  Every
function takes a ``dtype``: float32 is the reference, bfloat16 the
precision control (the nearest precision below the one the configurations
state).
"""

import torch


def strict_fp32() -> None:
    """No TF32 anywhere: a float32 matrix product stays float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
