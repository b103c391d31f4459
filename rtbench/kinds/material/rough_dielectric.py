"""A rough dielectric: `eta`, Trowbridge-Reitz `roughness` (x, y),
`remap_roughness`."""
from reference.kinds import MAT_ROUGH_DIELECTRIC, material_row


def port(m: dict, tex):
    from tpu_raytracing_torch.materials import RoughDielectric
    return RoughDielectric(eta=tex(m["eta"]),
                           remap_roughness=m["remap_roughness"],
                           roughness=tex(*m["roughness"]))


def row(m: dict) -> dict:
    eta = [m["eta"], 0.0, 0.0]
    return material_row(MAT_ROUGH_DIELECTRIC, albedo=eta, eta=eta,
                        alpha=m["roughness"], remap=m["remap_roughness"],
                        has_rough=True)
