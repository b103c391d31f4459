"""A perspective look-at camera: `position`, `target`, `up`, `yfov_deg`
(the vertical field of view)."""
import numpy as np

from reference.camera import PinholeCamera


def port(sb, cam: dict, width: int, height: int) -> None:
    from tpu_raytracing_torch.geometry import v3
    from tpu_raytracing_torch.scene.camera import Camera
    sb.add_camera(Camera.lookat_camera_perspective(
        v3(*cam["position"]), v3(*cam["target"]), v3(*cam["up"]), False,
        np.deg2rad(cam["yfov_deg"]), width, height))


def reference(cam: dict, width: int, height: int, device):
    return PinholeCamera(cam, width, height, device)
