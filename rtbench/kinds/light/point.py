"""A point light: `position` and `intensity` (RGB). The renderer takes
one sample of it a shading point whatever the light-sample count."""
import torch

from reference.linalg import norm
from reference.scene import LightSample


def port(sb, light: dict) -> None:
    from tpu_raytracing_torch.geometry import v3
    sb.add_point_light(v3(*light["position"]), v3(*light["intensity"]))


class PointLight:
    def __init__(self, light: dict, device):
        self.pos = torch.as_tensor(light["position"], dtype=torch.float32,
                                   device=device)
        self.intensity = torch.as_tensor(light["intensity"],
                                         dtype=torch.float32, device=device)

    def samples(self, light_sample_count: int) -> int:
        return 1

    def sample(self, point, cfg, stream):
        d_vec = point - self.pos
        dist = norm(d_vec)
        safe = torch.where(dist == 0.0, 1.0, dist)
        return LightSample(
            radiance=self.intensity / (safe * safe)[:, None],
            origin=self.pos.expand(point.shape),
            direction=d_vec / safe[:, None],
            distance=dist,
            pdf=torch.ones_like(dist)), stream


def reference(light: dict, scene) -> PointLight:
    return PointLight(light, scene.device)
