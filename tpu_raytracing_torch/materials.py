"""Materials, textures, and images (host-side scene description).

Capability parity with crates/raytracing/src/materials/: the Material variants
(mod.rs:2-56) whose parameters are all texture ids, the Texture variants
(texture.rs:81-112) with wrap/filter sampler state, and Image with
sRGB->linear conversion on load (image.rs:133-142). Device-side evaluation
lives in tpu_raytracing_torch.ops.textures / ops.bsdf.
"""
from __future__ import annotations

import enum
import io
from dataclasses import dataclass, field
from typing import Optional, Union

import numpy as np

F = np.float32


# ---------------------------------------------------------------- textures

class WrapMode(enum.IntEnum):
    REPEAT = 0
    MIRROR = 1
    CLAMP = 2


class FilterMode(enum.IntEnum):
    NEAREST = 0
    BILINEAR = 1
    TRILINEAR = 2


@dataclass
class TextureSampler:
    filter: FilterMode = FilterMode.BILINEAR
    wrap: WrapMode = WrapMode.REPEAT


@dataclass
class ImageTexture:
    image: int  # ImageId
    sampler: TextureSampler = field(default_factory=TextureSampler)


@dataclass
class ConstantTexture:
    value: np.ndarray  # (4,) f32

    def __post_init__(self):
        self.value = np.asarray(self.value, F).reshape(4)


@dataclass
class CheckerTexture:
    color1: np.ndarray
    color2: np.ndarray

    def __post_init__(self):
        self.color1 = np.asarray(self.color1, F).reshape(4)
        self.color2 = np.asarray(self.color2, F).reshape(4)


@dataclass
class ScaleTexture:
    a: int  # TextureId
    b: int  # TextureId


@dataclass
class MixTexture:
    a: int  # TextureId
    b: int  # TextureId
    c: int  # TextureId (mix factor)


Texture = Union[ImageTexture, ConstantTexture, CheckerTexture, ScaleTexture, MixTexture]


# ---------------------------------------------------------------- images

def _srgb_to_linear(c: np.ndarray) -> np.ndarray:
    c = np.asarray(c, F)
    return np.where(
        c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4
    ).astype(F)


@dataclass
class Image:
    """Decoded image as a linear-light (H, W, 4) float32 array."""

    data: np.ndarray

    def __post_init__(self):
        data = np.asarray(self.data, F)
        if data.ndim == 2:
            data = data[:, :, None]
        if data.shape[2] == 1:
            data = np.repeat(data, 3, axis=2)
        if data.shape[2] == 3:
            data = np.concatenate(
                [data, np.ones((*data.shape[:2], 1), F)], axis=2
            )
        self.data = np.ascontiguousarray(data[:, :, :4], dtype=F)

    @property
    def width(self) -> int:
        return self.data.shape[1]

    @property
    def height(self) -> int:
        return self.data.shape[0]

    @staticmethod
    def load_from_bytes(raw: bytes) -> "Image":
        """Decode PNG/JPEG/EXR bytes; 8/16-bit color is converted sRGB->linear."""
        if raw[:4] == b"\x76\x2f\x31\x01":  # EXR magic
            from .utils import exr

            channels, width, height = exr.read_exr_bytes(raw)
            rgb = [channels.get(k) for k in ("R", "G", "B")]
            if rgb[0] is None:
                first = next(iter(channels.values()))
                rgb = [first, first, first]
            a = channels.get("A", np.ones_like(rgb[0]))
            data = np.stack(
                [c if c is not None else rgb[0] for c in rgb] + [a], axis=-1
            )
            return Image(data)

        from PIL import Image as PILImage

        img = PILImage.open(io.BytesIO(raw))
        mode = img.mode
        if mode in ("I;16", "I"):
            arr = np.asarray(img, np.float32) / 65535.0
            return Image(_srgb_to_linear(arr))
        if mode not in ("RGB", "RGBA", "L", "LA"):
            img = img.convert("RGBA")
            mode = "RGBA"
        arr = np.asarray(img, np.float32) / 255.0
        if arr.ndim == 2:
            arr = arr[:, :, None]
        # color channels are sRGB-encoded; alpha stays linear
        ncolor = {"L": 1, "LA": 1, "RGB": 3, "RGBA": 3}[mode]
        arr[..., :ncolor] = _srgb_to_linear(arr[..., :ncolor])
        return Image(arr)

    @staticmethod
    def load_from_file(path) -> "Image":
        with open(path, "rb") as f:
            return Image.load_from_bytes(f.read())

    @staticmethod
    def from_raw(
        data: np.ndarray, srgb: bool = False
    ) -> "Image":
        """Build from an already-decoded array (e.g. GLTF buffer images)."""
        data = np.asarray(data, F)
        if srgb:
            ncolor = min(3, data.shape[-1]) if data.ndim == 3 else 1
            data = data.copy()
            data[..., :ncolor] = _srgb_to_linear(data[..., :ncolor])
        return Image(data)

    def get_pixel(self, x: int, y: int) -> np.ndarray:
        return self.data[y, x]


# ---------------------------------------------------------------- materials

@dataclass
class Diffuse:
    albedo: int  # TextureId


@dataclass
class SmoothDielectric:
    eta: int


@dataclass
class SmoothConductor:
    eta: int
    kappa: int


@dataclass
class RoughDielectric:
    eta: int
    remap_roughness: bool
    roughness: int


@dataclass
class RoughConductor:
    eta: int
    kappa: int
    remap_roughness: bool
    roughness: int


@dataclass
class CoatedDiffuse:
    diffuse_albedo: int
    dielectric_eta: int
    dielectric_remap_roughness: bool
    dielectric_roughness: Optional[int]
    thickness: int
    coat_albedo: int


Material = Union[
    Diffuse, SmoothDielectric, SmoothConductor,
    RoughDielectric, RoughConductor, CoatedDiffuse,
]
