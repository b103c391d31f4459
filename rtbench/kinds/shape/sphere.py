"""A sphere: `center` and `radius` in its own frame."""


def port(shape: dict, root):
    from tpu_raytracing_torch.geometry import Sphere, v3
    return Sphere(v3(*shape["center"]), shape["radius"])


def reference(shape: dict, root) -> dict:
    return dict(center=shape["center"], radius=shape["radius"])
