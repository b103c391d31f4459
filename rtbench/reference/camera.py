"""Pinhole camera of the reference: look-at frame, perspective projection
and jittered camera rays, in the renderer's conventions (the camera looks
down +z of its frame, raster y = 0 at the top, 4x4 matrices row-major for
column vectors). The matrices are built in numpy as the renderer's scene
description builds them; rays go through the frozen elementwise helpers.
"""
from __future__ import annotations

import numpy as np
import torch

from .linalg import apply_point, apply_vector, normalize
from .rng import sample_uniform2

F = np.float32
NEAR_CLIP = 0.01
FAR_CLIP = 1000.0


class _Xf:
    """A transform with its inverse, composed as the scene description
    composes them (`a.then(b)` applies a, then b)."""

    def __init__(self, fwd, inv):
        self.fwd, self.inv = fwd, inv

    @staticmethod
    def matrix(m) -> "_Xf":
        m = np.asarray(m, F)
        return _Xf(m, np.linalg.inv(np.asarray(m, np.float64)).astype(F))

    @staticmethod
    def translate(d) -> "_Xf":
        return _Xf(_translation(d), _translation(-np.asarray(d, F)))

    @staticmethod
    def scale(s) -> "_Xf":
        s = np.asarray(s, F)
        return _Xf(_scaling(s), _scaling(1.0 / s))

    def then(self, other: "_Xf") -> "_Xf":
        return _Xf((other.fwd @ self.fwd).astype(F),
                   (self.inv @ other.inv).astype(F))


def _translation(d) -> np.ndarray:
    m = np.eye(4, dtype=F)
    m[:3, 3] = np.asarray(d, F)
    return m


def _scaling(s) -> np.ndarray:
    m = np.eye(4, dtype=F)
    m[0, 0], m[1, 1], m[2, 2] = np.asarray(s, F)
    return m


def look_at(position, target, up) -> np.ndarray:
    """Camera-to-world: x = -normalize(view x up), y = view x x."""
    position = np.asarray(position, F)
    view = np.asarray(target, F) - position
    view = view / np.linalg.norm(view)
    cx = -np.cross(view, np.asarray(up, F))
    cx = cx / np.linalg.norm(cx)
    cy = np.cross(view, cx)
    m = np.eye(4, dtype=F)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = cx, cy, view, position
    return _Xf.matrix(m).fwd


def raster_to_camera(yfov: float, width: int, height: int) -> np.ndarray:
    """Inverse of camera -> screen (perspective divide, then the fov scale
    with x and y flipped) -> raster (y = 0 at the top)."""
    far, near = FAR_CLIP, NEAR_CLIP
    persp = _Xf.matrix(np.array(
        [[1, 0, 0, 0], [0, 1, 0, 0],
         [0, 0, far / (far - near), -(far * near) / (far - near)],
         [0, 0, 1, 0]], dtype=F))
    wide = width >= height
    fov = yfov * (width / height) if wide else yfov
    invt = 1.0 / np.tan(fov / 2.0)
    fov_scale = _Xf.scale([-invt, -invt, 1.0])
    if wide:
        top_left = [-1.0, -(height / width), 0.0]
        bottom_right = [1.0, height / width, 0.0]
    else:
        top_left = [-(width / height), -1.0, 0.0]
        bottom_right = [width / height, 1.0, 0.0]
    span = np.asarray(bottom_right, F) - np.asarray(top_left, F)
    s2r = (_Xf.translate(-np.asarray(top_left, F))
           .then(_Xf.scale([1.0 / span[0], 1.0 / span[1], 1.0]))
           .then(_Xf.scale([float(width), float(height), 1.0])))
    return persp.then(fov_scale).then(s2r).inv


class PinholeCamera:
    """Raster-to-camera and camera-to-world matrices on `device`."""

    def __init__(self, desc: dict, width: int, height: int, device):
        r2c = raster_to_camera(np.deg2rad(desc["yfov_deg"]), width, height)
        c2w = look_at(desc["position"], desc["target"], desc["up"])
        self.r2c = torch.from_numpy(r2c).to(device)
        self.c2w = torch.from_numpy(c2w).to(device)
        self.near, self.far = NEAR_CLIP, FAR_CLIP

    def rays(self, px, py, cfg, stream):
        """Jittered rays through pixels (px, py): (origin, direction,
        stream advanced by two dimensions)."""
        u, stream = sample_uniform2(cfg, stream)
        x = px.to(torch.float32) + u[:, 0]
        y = py.to(torch.float32) + u[:, 1]
        raster = torch.stack([x, y, torch.zeros_like(x)], dim=-1)
        p_cam = apply_point(self.r2c, raster)
        o_cam = torch.zeros_like(p_cam)
        d_cam = normalize(p_cam)
        return (apply_point(self.c2w, o_cam),
                normalize(apply_vector(self.c2w, d_cam)), stream)
