"""cv2's float BGR <-> YUV (COLOR_BGR2YUV / COLOR_YUV2BGR on float images):
BT.601 weights with the fixed 0.5 chroma offset cv2 applies to floats."""

import numpy as np
import torch

_B2Y, _G2Y, _R2Y = 0.114, 0.587, 0.299
_U_SC, _V_SC = 0.492, 0.877

# yuv = M_FWD @ [B, G, R] + OFF
M_FWD = np.array([
    [_B2Y, _G2Y, _R2Y],
    [_U_SC * (1.0 - _B2Y), -_U_SC * _G2Y, -_U_SC * _R2Y],
    [-_V_SC * _B2Y, -_V_SC * _G2Y, _V_SC * (1.0 - _R2Y)],
], dtype=np.float64).astype(np.float32)
# bgr = M_BWD @ (yuv - OFF)
M_BWD = np.array([
    [1.0, 2.032, 0.0],
    [1.0, -0.395, -0.581],
    [1.0, 0.0, 1.140],
], dtype=np.float64).astype(np.float32)
OFF = np.array([0.0, 0.5, 0.5], dtype=np.float32)


def channel(bgr: torch.Tensor, k: int) -> torch.Tensor:
    """YUV channel ``k`` of [..., 3] BGR, in ``bgr``'s dtype."""
    m = [float(v) for v in M_FWD[k]]
    return m[0] * bgr[..., 0] + m[1] * bgr[..., 1] + m[2] * bgr[..., 2] + float(OFF[k])


def to_yuv(bgr: torch.Tensor) -> torch.Tensor:
    return torch.stack([channel(bgr, k) for k in range(3)], dim=-1)


def to_bgr(yuv: torch.Tensor) -> torch.Tensor:
    d = [yuv[..., k] - float(OFF[k]) for k in range(3)]
    return torch.stack([float(M_BWD[k, 0]) * d[0] + float(M_BWD[k, 1]) * d[1]
                        + float(M_BWD[k, 2]) * d[2] for k in range(3)], dim=-1)


def to_u8(x: torch.Tensor) -> torch.Tensor:
    """clip to [0, 255], round half to even, uint8 (cv2's saturate_cast of
    the float result, as the codecs' descriptions state)."""
    return torch.round(torch.clamp(x.to(torch.float32), 0.0, 255.0)).to(torch.uint8)
