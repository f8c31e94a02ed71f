"""Shared inputs for the tests that hold vfp_tpu_torch against vfp_tpu."""

import numpy as np
import pytest
import torch

PAYLOAD = np.array([0, 1, 1, 0, 0, 1, 0, 1])


def natural_frames(rng, b, h, w):
    """Smooth content without cv2: coarse noise upsampled 8x plus mild grain."""
    small = rng.rand(b, -(-h // 8), -(-w // 8), 3)
    f = np.repeat(np.repeat(small, 8, axis=1), 8, axis=2)[:, :h, :w] * 220
    return np.clip(f + rng.rand(b, h, w, 3) * 20, 0, 255).astype(np.uint8)


def spread_wm(h, w, key=0, payload=PAYLOAD):
    """Flat float32 watermark plane of an H x W frame, spread by the JAX package."""
    from vfp_tpu.wm import Shuffler

    cap = (1, h * w // 64)
    return np.asarray(Shuffler(key=key).generate_wm(payload, cap), np.float32).reshape(-1)


def despread(bits, key=0, payload_len=len(PAYLOAD)):
    """[B, capacity] decoded bits -> [B, P] payloads through the port's DeShuffler."""
    from vfp_tpu_torch.wm import DeShuffler

    deg = DeShuffler(key=key, threshold="fixed").set_shape((payload_len,))
    return deg.degenerate_batch(torch.as_tensor(np.asarray(bits, np.float32))).numpy()


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where torch sees none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: on the card, python -m pytest --noconftest "
                    "tests/test_torch_cuda.py")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)
