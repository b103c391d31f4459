"""The frozen byte count of the walk's roofline, against values worked
out by hand, and the scenes' triangle counts."""
from types import SimpleNamespace

import pytest
import torch

from rtbench_helpers import BENCH, REPO


def _reader(name):
    from harness.spec import load_module
    return load_module(BENCH / "metrics" / f"{name}.py")


def test_call_bytes_by_hand():
    m = _reader("traversal.bvh8t_walk_roofline")
    # 3 active rays: 33 B in + 8 B out; 2 idle: 5 B in + 8 B out;
    # 2 triangles of 10 words
    assert m.call_bytes(3, 5, 2) == 3 * 41 + 2 * 13 + 2 * 10 * 4 == 229
    assert m.call_bytes(0, 0, 0) == 0


def test_roofline_share_by_hand():
    m = _reader("traversal.bvh8t_walk_roofline")
    active = torch.tensor([True, True, True, False, False])
    # one call of 229 B against 1 us of walk: 229 / 3.35e12 s over 1e-6 s
    trace = SimpleNamespace(
        kernels=[("void bvh8t_walk_kernel<true>", 0, 600),
                 ("elementwise", 600, 5000), ("bvh8t_walk_x", 700, 1100)],
        spans=[("intersect_scene", 0, 1, active),
               ("bsdf_eval", 1, 2, None)])
    got = m.read(SimpleNamespace(trace=trace, n_tris=2))
    assert got == pytest.approx(100 * (229 / 3.35e12) / 1e-6)
    assert m.read(SimpleNamespace(trace=None, n_tris=2)) is None


def test_scene_triangles():
    import json
    from reference.scene import RefScene
    counts = {}
    for name in ("coated_diffuse_bunny", "rough_dielectric"):
        cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
        counts[name] = RefScene(cfg["scene"], 4, 4, BENCH, "cpu").n_tris
    assert counts == {"coated_diffuse_bunny": 28586, "rough_dielectric": 10}


def test_bunny_copy_matches_the_port_loader():
    import gzip
    import numpy as np
    from reference.ply import read_ply
    from tpu_raytracing_torch.geometry import load_ply
    path = BENCH / "assets" / "bunny.ply.gz"
    v, n, tri = read_ply(path)
    mesh = load_ply(gzip.decompress(path.read_bytes()))
    assert np.array_equal(v, mesh.vertices) and np.array_equal(n, mesh.normals)
    assert np.array_equal(tri, mesh.tris.astype(np.int64))
    assert REPO.exists()
