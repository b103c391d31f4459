"""A diffuse base under a rough dielectric coat (the layered walk):
`diffuse_albedo`, `coat_albedo` (RGB), `eta`, `roughness` (x, y),
`remap_roughness`, `thickness`."""
from reference.kinds import MAT_COATED_DIFFUSE, material_row


def port(m: dict, tex):
    from tpu_raytracing_torch.materials import CoatedDiffuse
    return CoatedDiffuse(
        diffuse_albedo=tex(*m["diffuse_albedo"], 1.0),
        dielectric_eta=tex(m["eta"]),
        dielectric_remap_roughness=m["remap_roughness"],
        dielectric_roughness=tex(*m["roughness"]),
        thickness=tex(m["thickness"]),
        coat_albedo=tex(*m["coat_albedo"], 1.0))


def row(m: dict) -> dict:
    eta = [m["eta"], 0.0, 0.0]
    return material_row(MAT_COATED_DIFFUSE, albedo=m["diffuse_albedo"],
                        eta=eta, kappa=eta, alpha=m["roughness"],
                        remap=m["remap_roughness"], has_rough=True,
                        thickness=m["thickness"],
                        coat_albedo=m["coat_albedo"])
