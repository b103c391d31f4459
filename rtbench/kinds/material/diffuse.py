"""A Lambertian material: `albedo` (RGB)."""
from reference.kinds import MAT_DIFFUSE, material_row


def port(m: dict, tex):
    from tpu_raytracing_torch.materials import Diffuse
    return Diffuse(albedo=tex(*m["albedo"], 1.0))


def row(m: dict) -> dict:
    return material_row(MAT_DIFFUSE, albedo=m["albedo"], eta=m["albedo"])
