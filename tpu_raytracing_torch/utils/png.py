"""PNG output for render results (parity: raytracing-cpu/src/utils.rs:7-47).

Linear radiance -> 8-bit with an exposure divisor; gamma is recorded via the
PNG gAMA chunk like the reference (gamma 1/2.2), i.e. pixel values stay
linear after the exposure divide and viewers apply the display gamma.
"""
from __future__ import annotations

import numpy as np

F = np.float32


def _to_u8(linear: np.ndarray, exposure: float) -> np.ndarray:
    scaled = np.clip(np.asarray(linear, F) / F(exposure), 0.0, 1.0)
    return (scaled * 255.0 + 0.5).astype(np.uint8)


def save_png(path, rgb: np.ndarray, exposure: float = 1.0) -> None:
    """Save (H, W, 3) linear float RGB with an exposure divisor + gAMA chunk."""
    from PIL import Image as PILImage
    from PIL.PngImagePlugin import PngInfo

    u8 = _to_u8(rgb, exposure)
    img = PILImage.fromarray(u8, "RGB")
    info = PngInfo()
    img.save(path, pnginfo=info, gamma=1.0 / 2.2)


def normals_to_rgb(normals: np.ndarray) -> np.ndarray:
    """Map [-1, 1] normals to [0, 1] rgb."""
    return (np.asarray(normals, F) * 0.5 + 0.5).astype(F)


def uvs_to_rgb(uvs: np.ndarray) -> np.ndarray:
    """(H, W, 2) uv -> rgb with zero blue channel."""
    uvs = np.asarray(uvs, F)
    return np.concatenate(
        [uvs, np.zeros((*uvs.shape[:2], 1), F)], axis=-1
    )
