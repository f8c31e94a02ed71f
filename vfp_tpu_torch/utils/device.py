"""The device an entry point runs on: CUDA unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(name) -> torch.device:
    """``torch.device(name)``; raises for a CUDA device when there is no GPU,
    never falling back to the CPU.  On CUDA it turns TF32 off: QIM bins need
    full float32 products on the codecs' tensor paths."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device cuda needs a CUDA GPU and none is available; "
                               "pass --device cpu (device='cpu') to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device
