"""A smooth conductor: complex index of refraction `eta` + i `kappa`
(RGB each)."""
from reference.kinds import MAT_SMOOTH_CONDUCTOR, material_row


def port(m: dict, tex):
    from tpu_raytracing_torch.materials import SmoothConductor
    return SmoothConductor(eta=tex(*m["eta"]), kappa=tex(*m["kappa"]))


def row(m: dict) -> dict:
    return material_row(MAT_SMOOTH_CONDUCTOR, albedo=m["eta"], eta=m["eta"],
                        kappa=m["kappa"])
