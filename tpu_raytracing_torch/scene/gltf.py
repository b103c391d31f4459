"""GLTF 2.0 / GLB importer (from-scratch parser, no gltf library).

Capability parity with the reference importer
(crates/raytracing/src/scene/scene.rs:249-522):

- raster height fixed at 600; width from the camera aspect ratio
  (scene.rs:247, camera.rs:133-203)
- images decoded from bufferViews/URIs; samplers mapped to
  TextureSampler wrap/filter (scene.rs:282-305); differing wrap_s/wrap_t
  falls back to wrap_s with a warning
- pbrMetallicRoughness -> Diffuse; base-color factor != 1 wraps the image
  texture in Constant+Scale textures; a metallic-roughness texture entry is
  materialized the same way even though the material is always Diffuse
  (scene.rs:334-407)
- gltf-level instancing: the first node using a mesh creates its
  BasicPrimitives, later nodes add TransformPrimitives over the recorded
  primitive range (scene.rs:256,430-443)
- non-zero emissive_factor -> DiffuseAreaLight per emissive primitive
  (scene.rs:455-467)
- KHR_lights_punctual point/directional; spot warned-unsupported
  (lights/light.rs:41-82)
- camera from the camera node with flip-y camera_to_world
  (camera.rs:133-203); only the scene's root nodes are walked, matching the
  reference's flat traversal
"""
from __future__ import annotations

import base64
import io
import json
import logging
import struct
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..geometry import Mesh, Transform, TriangleMesh
from ..lights import DiffuseAreaLight, DirectionLight, PointLight
from ..materials import (
    ConstantTexture, Diffuse, FilterMode, Image, ImageTexture, ScaleTexture,
    TextureSampler, WrapMode,
)
from ..scene.camera import (
    Camera, Orthographic, PinholePerspective, create_orthographic_transform,
    create_perspective_transform,
)
from ..scene.primitive import (
    AggregatePrimitive, BasicPrimitive, TransformPrimitive,
)
from ..scene.scene import Scene

log = logging.getLogger("tpu_raytracing_torch")

F = np.float32
HEIGHT = 600

_COMPONENT_DTYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}
_TYPE_DIMS = {
    "SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
    "MAT2": 4, "MAT3": 9, "MAT4": 16,
}

# sampler enums (GL constants)
_WRAP = {
    10497: WrapMode.REPEAT,
    33648: WrapMode.MIRROR,
    33071: WrapMode.CLAMP,
}
_MIN_NEAREST = 9728
_MIN_LINEAR = 9729
_MIN_LINEAR_MIPMAP_LINEAR = 9987
_MAG_NEAREST = 9728
_MAG_LINEAR = 9729


class GltfDocument:
    """Parsed container: JSON tree + resolved binary buffers."""

    def __init__(self, tree: dict, buffers: List[bytes]):
        self.tree = tree
        self.buffers = buffers

    @staticmethod
    def from_file(path) -> "GltfDocument":
        path = Path(path)
        raw = path.read_bytes()
        if raw[:4] == b"glTF":
            return GltfDocument._from_glb(raw)
        tree = json.loads(raw)
        buffers = [
            _resolve_buffer_uri(b.get("uri"), path.parent, b["byteLength"])
            for b in tree.get("buffers", [])
        ]
        return GltfDocument(tree, buffers)

    @staticmethod
    def _from_glb(raw: bytes) -> "GltfDocument":
        magic, version, _length = struct.unpack_from("<III", raw, 0)
        if version != 2:
            raise ValueError(f"unsupported GLB version {version}")
        offset = 12
        tree = None
        bin_chunk = b""
        while offset + 8 <= len(raw):
            clen, ctype = struct.unpack_from("<II", raw, offset)
            chunk = raw[offset + 8 : offset + 8 + clen]
            if ctype == 0x4E4F534A:  # 'JSON'
                tree = json.loads(chunk)
            elif ctype == 0x004E4942:  # 'BIN\0'
                bin_chunk = chunk
            offset += 8 + clen + (-clen % 4 if ctype == 0 else 0)
        if tree is None:
            raise ValueError("GLB missing JSON chunk")
        buffers = []
        for i, b in enumerate(tree.get("buffers", [])):
            if "uri" in b:
                buffers.append(_resolve_buffer_uri(b["uri"], None, b["byteLength"]))
            else:
                buffers.append(bin_chunk[: b["byteLength"]])
        return GltfDocument(tree, buffers)

    # ---------------------------------------------------------- accessors

    def view_bytes(self, view_idx: int) -> bytes:
        v = self.tree["bufferViews"][view_idx]
        buf = self.buffers[v["buffer"]]
        off = v.get("byteOffset", 0)
        return buf[off : off + v["byteLength"]]

    def read_accessor(self, idx: int) -> np.ndarray:
        """Return (count, dims) array; normalized ints scaled to [0,1]/[-1,1]."""
        a = self.tree["accessors"][idx]
        dtype = _COMPONENT_DTYPES[a["componentType"]]
        dims = _TYPE_DIMS[a["type"]]
        count = a["count"]
        itemsize = np.dtype(dtype).itemsize
        natural = itemsize * dims
        if "bufferView" in a:
            v = self.tree["bufferViews"][a["bufferView"]]
            buf = self.buffers[v["buffer"]]
            start = v.get("byteOffset", 0) + a.get("byteOffset", 0)
            stride = v.get("byteStride") or natural
            if stride == natural:
                out = np.frombuffer(
                    buf, dtype=dtype, count=count * dims, offset=start
                ).reshape(count, dims)
            else:
                rows = np.frombuffer(
                    buf, dtype=np.uint8, count=stride * (count - 1) + natural,
                    offset=start,
                )
                strided = np.lib.stride_tricks.as_strided(
                    rows, shape=(count, natural), strides=(stride, 1)
                )
                out = strided.copy().view(dtype).reshape(count, dims)
        else:
            out = np.zeros((count, dims), dtype)
        if "sparse" in a:
            s = a["sparse"]
            n = s["count"]
            ind_dtype = _COMPONENT_DTYPES[s["indices"]["componentType"]]
            iv = self.tree["bufferViews"][s["indices"]["bufferView"]]
            ioff = iv.get("byteOffset", 0) + s["indices"].get("byteOffset", 0)
            indices = np.frombuffer(
                self.buffers[iv["buffer"]], dtype=ind_dtype, count=n, offset=ioff
            )
            vv = self.tree["bufferViews"][s["values"]["bufferView"]]
            voff = vv.get("byteOffset", 0) + s["values"].get("byteOffset", 0)
            values = np.frombuffer(
                self.buffers[vv["buffer"]], dtype=dtype, count=n * dims,
                offset=voff,
            ).reshape(n, dims)
            out = out.copy()
            out[indices] = values
        if a.get("normalized") and dtype != np.float32:
            info = np.iinfo(dtype)
            out = np.maximum(out.astype(F) / info.max, -1.0)
        return out


def _resolve_buffer_uri(uri: Optional[str], base: Optional[Path], length: int) -> bytes:
    if uri is None:
        raise ValueError("buffer without uri outside GLB")
    if uri.startswith("data:"):
        _, b64 = uri.split(",", 1)
        return base64.b64decode(b64)[:length]
    if base is None:
        raise ValueError("external buffer uri in GLB container")
    return (base / uri).read_bytes()[:length]


def _node_matrix(node: dict) -> np.ndarray:
    """Row-major 4x4 local transform (gltf stores column-major)."""
    if "matrix" in node:
        return np.asarray(node["matrix"], F).reshape(4, 4).T
    m = np.eye(4, dtype=F)
    if "scale" in node:
        m[:3, :3] = np.diag(np.asarray(node["scale"], F))
    if "rotation" in node:
        x, y, z, w = [float(c) for c in node["rotation"]]
        r = np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
            ],
            F,
        )
        m[:3, :3] = r @ m[:3, :3]
    if "translation" in node:
        m[:3, 3] = np.asarray(node["translation"], F)
    return m


def _decompose_trs(m: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(translation, rotation quaternion wxyz) of a TRS matrix."""
    t = m[:3, 3].copy()
    r = m[:3, :3].copy()
    scale = np.linalg.norm(r, axis=0)
    scale[scale == 0] = 1.0
    r = r / scale
    # Shepperd-style quaternion extraction
    tr = np.trace(r)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = np.array(
            [0.25 * s, (r[2, 1] - r[1, 2]) / s, (r[0, 2] - r[2, 0]) / s,
             (r[1, 0] - r[0, 1]) / s], F,
        )
    elif r[0, 0] > r[1, 1] and r[0, 0] > r[2, 2]:
        s = np.sqrt(1.0 + r[0, 0] - r[1, 1] - r[2, 2]) * 2
        q = np.array(
            [(r[2, 1] - r[1, 2]) / s, 0.25 * s, (r[0, 1] + r[1, 0]) / s,
             (r[0, 2] + r[2, 0]) / s], F,
        )
    elif r[1, 1] > r[2, 2]:
        s = np.sqrt(1.0 + r[1, 1] - r[0, 0] - r[2, 2]) * 2
        q = np.array(
            [(r[0, 2] - r[2, 0]) / s, (r[0, 1] + r[1, 0]) / s, 0.25 * s,
             (r[1, 2] + r[2, 1]) / s], F,
        )
    else:
        s = np.sqrt(1.0 + r[2, 2] - r[0, 0] - r[1, 1]) * 2
        q = np.array(
            [(r[1, 0] - r[0, 1]) / s, (r[0, 2] + r[2, 0]) / s,
             (r[1, 2] + r[2, 1]) / s, 0.25 * s], F,
        )
    return t, q


def _decode_image(doc: GltfDocument, img: dict, base: Optional[Path]) -> Image:
    if "bufferView" in img:
        raw = doc.view_bytes(img["bufferView"])
    else:
        uri = img["uri"]
        if uri.startswith("data:"):
            _, b64 = uri.split(",", 1)
            raw = base64.b64decode(b64)
        else:
            raw = (base / uri).read_bytes()
    return Image.load_from_bytes(raw)


def _sampler_to_texture_sampler(sampler: dict, name: str) -> TextureSampler:
    wrap_s = _WRAP.get(sampler.get("wrapS", 10497), WrapMode.REPEAT)
    wrap_t = _WRAP.get(sampler.get("wrapT", 10497), WrapMode.REPEAT)
    if wrap_s != wrap_t:
        log.warning(
            "gltf sampler (%s) has different wrap modes s=%s t=%s; using s",
            name, wrap_s, wrap_t,
        )
    min_f = sampler.get("minFilter")
    mag_f = sampler.get("magFilter")
    if min_f is None:
        filt = (
            FilterMode.BILINEAR if mag_f == _MAG_LINEAR else FilterMode.NEAREST
        )
    elif min_f == _MIN_NEAREST:
        filt = FilterMode.NEAREST
    elif min_f == _MIN_LINEAR:
        filt = FilterMode.BILINEAR
    elif min_f == _MIN_LINEAR_MIPMAP_LINEAR:
        filt = FilterMode.TRILINEAR
    else:
        log.warning("gltf min filter %s not supported, using nearest", min_f)
        filt = FilterMode.NEAREST
    return TextureSampler(filter=filt, wrap=wrap_s)


def _mesh_from_primitive(doc: GltfDocument, mesh: dict, prim: dict) -> Mesh:
    attrs = prim["attributes"]
    if "POSITION" not in attrs:
        raise ValueError("gltf primitive without POSITION")
    vertices = doc.read_accessor(attrs["POSITION"]).astype(F)
    if "indices" in prim:
        idx = doc.read_accessor(prim["indices"]).reshape(-1).astype(np.uint32)
    else:
        idx = np.arange(len(vertices), dtype=np.uint32)
    n = (len(idx) // 3) * 3
    tris = idx[:n].reshape(-1, 3)
    if "NORMAL" not in attrs:
        raise ValueError("gltf primitive without NORMAL not supported")
    normals = doc.read_accessor(attrs["NORMAL"]).astype(F)
    if "TEXCOORD_0" in attrs:
        uvs = doc.read_accessor(attrs["TEXCOORD_0"]).astype(F)[:, :2]
    else:
        log.warning(
            "no uvs loaded for gltf primitive in mesh %s",
            mesh.get("name", "?"),
        )
        uvs = np.zeros((0, 2), F)
    return Mesh(vertices=vertices, tris=tris, normals=normals, uvs=uvs)


def _camera_from_node(node: dict, cam: dict, height: int) -> Camera:
    m = _node_matrix(node)
    position, rotation = _decompose_trs(m)
    cam_to_world_matrix = Transform.from_matrix(m)
    flip_y = Transform.scale([1.0, -1.0, 1.0])
    camera_to_world = flip_y.compose(cam_to_world_matrix)
    world_to_camera = cam_to_world_matrix.invert()

    if cam["type"] == "perspective":
        p = cam["perspective"]
        aspect = p.get("aspectRatio", 1.0)
        width = int(height * aspect)
        r2c_clips = (-p.get("zfar", 1000.0), -p["znear"])
        ssh_sign = 1.0
        camera_to_raster = create_perspective_transform(
            r2c_clips[0], r2c_clips[1], p["yfov"], width, height
        )
        camera_type = PinholePerspective(yfov=p["yfov"])
    else:
        o = cam["orthographic"]
        ssw, ssh = o["xmag"], o["ymag"]
        width = int(height * ssw / ssh)
        r2c_clips = (-o["zfar"], -o["znear"])
        ssh_sign = -1.0
        camera_to_raster = create_orthographic_transform(
            r2c_clips[0], r2c_clips[1], width, height, ssw, -ssh
        )
        camera_type = Orthographic(ssw, ssh)

    world_to_raster = world_to_camera.compose(camera_to_raster)
    return Camera(
        camera_position=position,
        camera_rotation=rotation,
        camera_type=camera_type,
        raster_width=width,
        raster_height=height,
        near_clip=0.01,
        far_clip=1000.0,
        world_to_raster=world_to_raster,
        camera_to_world=camera_to_world,
        raster_to_camera=camera_to_raster.invert(),
        r2c_clips=r2c_clips,
        r2c_ssh_sign=ssh_sign,
        world_to_camera=world_to_camera,
    )


def load_gltf_scene(path) -> Scene:
    path = Path(path)
    doc = GltfDocument.from_file(path)
    tree = doc.tree
    base = path.parent

    images = [_decode_image(doc, img, base) for img in tree.get("images", [])]

    samplers = tree.get("samplers", [])
    textures: List = []
    for tex in tree.get("textures", []):
        s_idx = tex.get("sampler")
        sampler = samplers[s_idx] if s_idx is not None else {}
        ts = _sampler_to_texture_sampler(sampler, str(s_idx))
        textures.append(ImageTexture(image=tex["source"], sampler=ts))

    materials: List = []
    material_emissions: List[np.ndarray] = []
    for mat in tree.get("materials", []):
        pbr = mat.get("pbrMetallicRoughness", {})
        base_fac = pbr.get("baseColorFactor", [1.0, 1.0, 1.0, 1.0])
        bct = pbr.get("baseColorTexture")
        if bct is not None:
            if bct.get("texCoord", 0) != 0:
                log.warning(
                    "material %s uses non-zero TEXCOORD for base color",
                    mat.get("name", "?"),
                )
            base_id = bct["index"]
            if list(base_fac) != [1.0, 1.0, 1.0, 1.0]:
                factor_id = len(textures)
                textures.append(ConstantTexture(value=np.asarray(base_fac, F)))
                scale_id = len(textures)
                textures.append(ScaleTexture(a=base_id, b=factor_id))
                albedo = scale_id
            else:
                albedo = base_id
        else:
            albedo = len(textures)
            textures.append(ConstantTexture(value=np.asarray(base_fac, F)))

        # metallic-roughness texture entries are materialized for id parity
        # with the reference even though the material is always Diffuse
        # (scene.rs:368-405,407)
        mrt = pbr.get("metallicRoughnessTexture")
        metallic = pbr.get("metallicFactor", 1.0)
        roughness = pbr.get("roughnessFactor", 1.0)
        if mrt is not None:
            if mrt.get("texCoord", 0) != 0:
                log.warning(
                    "material %s uses non-zero TEXCOORD for metallic-roughness",
                    mat.get("name", "?"),
                )
            if metallic != 1.0 or roughness != 1.0:
                factor_id = len(textures)
                textures.append(
                    ConstantTexture(value=np.asarray([0.0, roughness, metallic, 0.0], F))
                )
                textures.append(ScaleTexture(a=mrt["index"], b=factor_id))
        else:
            textures.append(
                ConstantTexture(value=np.asarray([0.0, roughness, metallic, 0.0], F))
            )

        materials.append(Diffuse(albedo=albedo))
        material_emissions.append(np.asarray(mat.get("emissiveFactor", [0, 0, 0]), F))

    if not materials:
        albedo = len(textures)
        textures.append(ConstantTexture(value=np.asarray([1, 1, 1, 1], F)))
        materials.append(Diffuse(albedo=albedo))
        material_emissions.append(np.zeros(3, F))

    nodes = tree.get("nodes", [])
    cameras = tree.get("cameras", [])
    meshes = tree.get("meshes", [])
    ext_lights = (
        tree.get("extensions", {}).get("KHR_lights_punctual", {}).get("lights", [])
    )

    scene_idx = tree.get("scene", 0)
    scene_nodes = tree["scenes"][scene_idx].get("nodes", [])

    camera: Optional[Camera] = None
    primitives: List = []
    lights: List = []
    root_children: List[int] = []
    instancing_map: Dict[int, range] = {}

    for node_idx in scene_nodes:
        node = nodes[node_idx]
        if "camera" in node:
            camera = _camera_from_node(node, cameras[node["camera"]], HEIGHT)

        if "mesh" in node:
            mesh_idx = node["mesh"]
            transform = Transform.from_matrix(_node_matrix(node))

            if mesh_idx in instancing_map:
                for basic_idx in instancing_map[mesh_idx]:
                    tp_idx = len(primitives)
                    primitives.append(
                        TransformPrimitive(primitive=basic_idx, transform=transform)
                    )
                    root_children.append(tp_idx)
            else:
                gltf_mesh = meshes[mesh_idx]
                start = len(primitives)
                for prim in gltf_mesh.get("primitives", []):
                    material_idx = prim.get("material", 0)
                    rt_mesh = _mesh_from_primitive(doc, gltf_mesh, prim)
                    basic_idx = len(primitives)
                    emission = material_emissions[material_idx]
                    area_light_idx = None
                    if np.any(emission != 0.0):
                        area_light_idx = len(lights)
                        lights.append(
                            DiffuseAreaLight(
                                prim_id=basic_idx,
                                radiance=emission,
                                light_to_world=transform.forward,
                            )
                        )
                    primitives.append(
                        BasicPrimitive(
                            shape=TriangleMesh(mesh=rt_mesh),
                            material=material_idx,
                            area_light=area_light_idx,
                        )
                    )
                end = len(primitives)
                instancing_map[mesh_idx] = range(start, end)
                for basic_idx in range(start, end):
                    tp_idx = len(primitives)
                    primitives.append(
                        TransformPrimitive(primitive=basic_idx, transform=transform)
                    )
                    root_children.append(tp_idx)

        light_ext = node.get("extensions", {}).get("KHR_lights_punctual")
        if light_ext is not None:
            light = ext_lights[light_ext["light"]]
            converted = _punctual_light(node, light)
            if converted is not None:
                lights.append(converted)

    root_idx = len(primitives)
    primitives.append(AggregatePrimitive(children=root_children))

    if camera is None:
        raise ValueError("gltf scene must have a camera")

    return Scene(
        camera=camera,
        primitives=primitives,
        root_primitive=root_idx,
        environment_light=None,
        lights=lights,
        materials=materials,
        textures=textures,
        images=images,
    )


def _punctual_light(node: dict, light: dict):
    if light.get("range") is not None:
        log.warning("`range` property of light not supported")
    color = np.asarray(light.get("color", [1, 1, 1]), F)
    intensity = float(light.get("intensity", 1.0))
    kind = light["type"]
    if kind == "directional":
        m = _node_matrix(node)
        _, q = _decompose_trs(m)
        w, x, y, z = [float(c) for c in q]
        # rotate (0,0,-1) by the node rotation
        v = np.array([0.0, 0.0, -1.0], F)
        u = np.array([x, y, z], F)
        direction = (
            2.0 * np.dot(u, v) * u
            + (w * w - np.dot(u, u)) * v
            + 2.0 * w * np.cross(u, v)
        ).astype(F)
        return DirectionLight(direction=direction, radiance=color * intensity)
    if kind == "point":
        m = _node_matrix(node)
        t, _ = _decompose_trs(m)
        return PointLight(position=t, intensity=color * intensity)
    log.warning("gltf %s light not implemented", kind)
    return None
