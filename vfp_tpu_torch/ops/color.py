"""cv2-compatible float BGR<->YUV conversion (port of ``vfp_tpu/ops/color.py``).

cv2's float path uses BT.601-derived constants with a fixed ``+0.5`` chroma
offset even for 0..255-ranged floats; the offset is kept bit-for-bit because
QIM bins depend on it.  The constants are built exactly as the JAX package
builds them (float64 array cast to float32), so both packages hold the same
bits; ``tests/test_torch_ops.py`` checks that.
"""

from __future__ import annotations

import numpy as np
import torch

_B2Y, _G2Y, _R2Y = 0.114, 0.587, 0.299
_U_SC, _V_SC = 0.492, 0.877

# Forward: yuv = M_FWD @ [B, G, R] + OFF_FWD
M_FWD = np.array(
    [
        [_B2Y, _G2Y, _R2Y],
        [_U_SC * (1.0 - _B2Y), -_U_SC * _G2Y, -_U_SC * _R2Y],
        [-_V_SC * _B2Y, -_V_SC * _G2Y, _V_SC * (1.0 - _R2Y)],
    ],
    dtype=np.float64,
).astype(np.float32)
OFF_FWD = np.array([0.0, 0.5, 0.5], dtype=np.float32)

# Backward: bgr = M_BWD @ [Y, U - 0.5, V - 0.5]
M_BWD = np.array(
    [
        [1.0, 2.032, 0.0],
        [1.0, -0.395, -0.581],
        [1.0, 0.0, 1.140],
    ],
    dtype=np.float64,
).astype(np.float32)
OFF_BWD = np.array([0.0, 0.5, 0.5], dtype=np.float32)


def _const(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32, device=like.device)


def bgr_to_yuv(bgr: torch.Tensor) -> torch.Tensor:
    """[..., 3] float BGR -> float YUV, as cv2.COLOR_BGR2YUV (float path)."""
    return torch.einsum("...c,kc->...k", bgr, _const(M_FWD, bgr)) + _const(OFF_FWD, bgr)


def yuv_to_bgr(yuv: torch.Tensor) -> torch.Tensor:
    """[..., 3] float YUV -> float BGR, as cv2.COLOR_YUV2BGR (float path)."""
    return torch.einsum("...c,kc->...k", yuv - _const(OFF_BWD, yuv), _const(M_BWD, yuv))
