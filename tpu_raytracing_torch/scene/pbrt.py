"""PBRT v3/v4 scene-file importer (subset).

Capability parity with the reference importer
(crates/raytracing/src/scene/pbrt.rs; supported-subset doc pbrt.rs:1-47):

- directives: Identity, LookAt (handedness swap), Translate, Scale, Rotate,
  Transform/ConcatTransform (column-major), Film (x/yresolution), Camera
  (perspective w/ fov, orthographic; unknown -> perspective),
  Material (diffuse, conductor, dielectric, coateddiffuse; roughness and
  anisotropic uroughness/vroughness extraction; unknown -> gray diffuse),
  MakeNamedMaterial/NamedMaterial, Texture (constant, imagemap, scale,
  checkerboard; unknown -> white), Shape (sphere, trianglemesh, plymesh
  w/ CW winding, disk -> sphere fallback; unknown skipped), LightSource
  (point, distant, spot -> point, infinite warned), AreaLightSource
  (diffuse -> pending radiance applied to the next Shape), WorldBegin/End,
  AttributeBegin/End + TransformBegin/End (transform+material+arealight
  stack), Include (recursive), skipped: Sampler/Integrator/PixelFilter/
  Accelerator/ColorSpace/ReverseOrientation/Object*/Medium*
- parameter lists: typed "type name" [values...] with scalar fallbacks,
  spectrum treated as rgb with a warning, unknown types skipped
"""
from __future__ import annotations

import logging
import math
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..geometry import Mesh, Shape, Sphere, Transform, TriangleMesh, load_ply
from ..lights import DirectionLight, PointLight
from ..materials import (
    CheckerTexture, CoatedDiffuse, ConstantTexture, Diffuse, FilterMode,
    Image, ImageTexture, RoughConductor, RoughDielectric, SmoothConductor,
    SmoothDielectric, TextureSampler, WrapMode,
)
from .camera import Camera
from .scene import Scene, SceneBuilder

log = logging.getLogger("tpu_raytracing_torch")

F = np.float32


class PbrtParseError(Exception):
    pass


# ------------------------------------------------------------------ tokens


class TokenStream:
    """Whitespace/comment-aware tokenizer: quoted strings, brackets, atoms."""

    def __init__(self, text: str):
        self.text = text
        self.pos = 0

    def _skip_ws(self) -> None:
        t, n = self.text, len(self.text)
        i = self.pos
        while i < n:
            c = t[i]
            if c == "#":
                while i < n and t[i] != "\n":
                    i += 1
            elif c.isspace():
                i += 1
            else:
                break
        self.pos = i

    def peek(self) -> Optional[str]:
        self._skip_ws()
        t, n = self.text, len(self.text)
        i = self.pos
        if i >= n:
            return None
        if t[i] == '"':
            j = i + 1
            while j < n and t[j] != '"':
                j += 1
            if j < n:
                j += 1
            return t[i:j]
        if t[i] in "[]":
            return t[i]
        j = i
        while j < n and not (t[j].isspace() or t[j] in '[]"#'):
            j += 1
        return t[i:j]

    def next(self) -> Optional[str]:
        tok = self.peek()
        if tok is not None:
            self.pos += len(tok)
        return tok

    def expect(self, expected: str) -> None:
        tok = self.next()
        if tok != expected:
            raise PbrtParseError(f"expected {expected!r}, got {tok!r}")


def _unquote(tok: Optional[str]) -> str:
    if tok is None:
        raise PbrtParseError("unexpected end of file")
    if len(tok) >= 2 and tok.startswith('"') and tok.endswith('"'):
        return tok[1:-1]
    raise PbrtParseError(f"bad string: {tok!r}")


def _float(tok: Optional[str]) -> float:
    if tok is None:
        raise PbrtParseError("unexpected end of file")
    try:
        return float(tok)
    except ValueError:
        raise PbrtParseError(f"bad float: {tok!r}")


# -------------------------------------------------------------- parameters


@dataclass
class ParameterList:
    params: List[Tuple[str, str, object]] = field(default_factory=list)
    # entries: (name, type, value); type in {integer,float,point2,point3,
    # vector3,normal3,rgb,bool,string,texture}

    def _get(self, name):
        for n, t, v in self.params:
            if n == name:
                return t, v
        return None

    def get_float(self, name, default=None):
        e = self._get(name)
        if e is None:
            return default
        t, v = e
        if t in ("float", "integer") and v:
            return float(v[0])
        return default

    def get_integer(self, name, default=None):
        e = self._get(name)
        if e is None or e[0] != "integer" or not e[1]:
            return default
        return int(e[1][0])

    def get_integers(self, name):
        e = self._get(name)
        return list(e[1]) if e and e[0] == "integer" else None

    def get_floats(self, name):
        e = self._get(name)
        return list(e[1]) if e and e[0] == "float" else None

    def get_point3s(self, name):
        e = self._get(name)
        if e and e[0] in ("point3", "vector3", "normal3"):
            return e[1]
        return None

    def get_point3(self, name, default=None):
        v = self.get_point3s(name)
        return list(v[0]) if v else default

    def get_point2s(self, name):
        e = self._get(name)
        return e[1] if e and e[0] == "point2" else None

    def get_rgb(self, name, default=None):
        e = self._get(name)
        if e is None:
            return default
        t, v = e
        if t == "rgb":
            return np.asarray(v, F)
        if t == "float" and len(v) >= 3:
            return np.asarray(v[:3], F)
        return default

    def get_string(self, name, default=None):
        e = self._get(name)
        return e[1] if e and e[0] == "string" else default

    def get_texture(self, name):
        e = self._get(name)
        return e[1] if e and e[0] == "texture" else None

    def get_bool(self, name, default=None):
        e = self._get(name)
        return e[1] if e and e[0] == "bool" else default

    def has(self, name) -> bool:
        return self._get(name) is not None


_VECTOR_TYPES = {
    "point2": 2, "point3": 3, "point": 3, "vector3": 3, "vector": 3,
    "normal3": 3, "normal": 3,
}
_TYPE_CANON = {
    "point": "point3", "vector": "vector3", "normal": "normal3",
    "color": "rgb",
}


def parse_parameter_list(toks: TokenStream) -> ParameterList:
    out = ParameterList()
    while True:
        tok = toks.peek()
        if tok is None or not tok.startswith('"'):
            break
        decl = _unquote(toks.next())
        parts = decl.split()
        if len(parts) != 2:
            raise PbrtParseError(f"bad parameter declaration: {decl!r}")
        ptype, pname = parts
        ptype = _TYPE_CANON.get(ptype, ptype)

        bracketed = toks.peek() == "["
        if bracketed:
            toks.next()

        def atoms():
            while True:
                t = toks.peek()
                if t is None or t == "]" or t.startswith('"'):
                    return
                yield toks.next()
                if not bracketed:
                    return

        if ptype in ("integer", "float"):
            conv = int if ptype == "integer" else float
            vals = []
            for a in atoms():
                try:
                    vals.append(conv(float(a)) if ptype == "integer" else float(a))
                except ValueError:
                    raise PbrtParseError(f"bad {ptype}: {a!r}")
            out.params.append((pname, ptype, vals))
        elif ptype in _VECTOR_TYPES:
            dims = _VECTOR_TYPES[ptype]
            flat = [_float(a) for a in atoms()]
            if bracketed:
                # bracketed vector lists consume all atoms; regroup
                pass
            else:
                # unbracketed: single tuple, remaining components follow
                while len(flat) < dims:
                    flat.append(_float(toks.next()))
            if len(flat) % dims != 0:
                raise PbrtParseError(
                    f"{ptype} {pname}: {len(flat)} scalars not divisible by {dims}"
                )
            vals = [flat[i : i + dims] for i in range(0, len(flat), dims)]
            out.params.append((pname, ptype, vals))
        elif ptype in ("rgb", "spectrum", "blackbody"):
            if ptype != "rgb":
                log.warning("%s parameters treated as rgb", ptype)
            vals = [_float(a) for a in atoms()]
            while len(vals) < 3:
                vals.append(_float(toks.next()))
            out.params.append((pname, "rgb", vals[:3]))
        elif ptype == "bool":
            # values are quoted ("true") or bare; read the token directly
            a = toks.next()
            if a is None:
                raise PbrtParseError(f"bool {pname}: missing value")
            s = a.strip('"')
            if s not in ("true", "false"):
                raise PbrtParseError(f"bad bool: {a!r}")
            out.params.append((pname, "bool", s == "true"))
        elif ptype in ("string", "texture"):
            out.params.append((pname, ptype, _unquote(toks.next())))
        else:
            log.warning("unknown parameter type %r, skipping", ptype)
            for _ in atoms():
                pass
            out.params.append((pname, "float", [0.0]))

        if bracketed:
            toks.expect("]")
    return out


# ------------------------------------------------------------------ state


@dataclass
class ParserState:
    current_transform: Transform = field(default_factory=Transform.identity)
    attribute_stack: List[tuple] = field(default_factory=list)
    film_width: int = 640
    film_height: int = 480
    named_materials: Dict[str, int] = field(default_factory=dict)
    named_textures: Dict[str, int] = field(default_factory=dict)
    current_material: Optional[int] = None
    area_light_radiance: Optional[np.ndarray] = None
    has_camera: bool = False
    has_lights: bool = False

    def push(self):
        self.attribute_stack.append(
            (self.current_transform, self.current_material, self.area_light_radiance)
        )

    def pop(self):
        if self.attribute_stack:
            (
                self.current_transform,
                self.current_material,
                self.area_light_radiance,
            ) = self.attribute_stack.pop()
        else:
            log.warning("AttributeEnd without matching AttributeBegin")


# -------------------------------------------------------------- materials


def _resolve_texture(state, builder, params, name, default_rgb):
    tex_name = params.get_texture(name)
    if tex_name is not None and tex_name in state.named_textures:
        return state.named_textures[tex_name]
    color = params.get_rgb(name, np.asarray(default_rgb, F))
    return builder.add_constant_texture([color[0], color[1], color[2], 1.0])


def _resolve_float_texture(state, builder, params, name, default):
    tex_name = params.get_texture(name)
    if tex_name is not None and tex_name in state.named_textures:
        return state.named_textures[tex_name]
    v = params.get_float(name, default)
    return builder.add_constant_texture([v, v, v, 1.0])


def _extract_roughness(params, builder, state) -> Optional[int]:
    has_r = params.has("roughness")
    has_u, has_v = params.has("uroughness"), params.has("vroughness")
    if has_u != has_v:
        log.warning(
            "bad anisotropic roughness; both u and v required, falling back to smooth"
        )
        return None
    aniso = has_u and has_v
    if has_r and aniso:
        log.warning(
            "both roughness and uroughness/vroughness provided, falling back to smooth"
        )
        return None
    if has_r:
        return _resolve_float_texture(state, builder, params, "roughness", 0.0)
    if aniso:
        ax = params.get_float("uroughness")
        ay = params.get_float("vroughness")
        return builder.add_constant_texture([ax, ay, 0.0, 0.0])
    return None


def _create_material(mat_type, params, state, builder):
    if mat_type == "diffuse":
        albedo = _resolve_texture(state, builder, params, "reflectance", (0.5, 0.5, 0.5))
        return Diffuse(albedo=albedo)
    if mat_type == "conductor":
        eta = _resolve_texture(state, builder, params, "eta", (0.2, 0.2, 0.2))
        k = _resolve_texture(state, builder, params, "k", (3.0, 3.0, 3.0))
        rough = _extract_roughness(params, builder, state)
        if rough is not None:
            remap = params.get_bool("remaproughness", True)
            return RoughConductor(eta=eta, kappa=k, remap_roughness=remap, roughness=rough)
        return SmoothConductor(eta=eta, kappa=k)
    if mat_type == "dielectric":
        ior = params.get_float("eta", 1.5)
        eta = builder.add_constant_texture([ior, 0.0, 0.0, 0.0])
        rough = _extract_roughness(params, builder, state)
        if rough is not None:
            remap = params.get_bool("remaproughness", True)
            return RoughDielectric(eta=eta, remap_roughness=remap, roughness=rough)
        return SmoothDielectric(eta=eta)
    if mat_type == "coateddiffuse":
        diffuse_albedo = _resolve_texture(
            state, builder, params, "reflectance", (0.5, 0.5, 0.5)
        )
        coat_eta = params.get_float("eta", 1.5)
        dielectric_eta = builder.add_constant_texture([coat_eta, 0.0, 0.0, 0.0])
        rough = _extract_roughness(params, builder, state)
        remap = params.get_bool("remaproughness", True)
        thickness_val = params.get_float("thickness", 0.01)
        thickness = builder.add_constant_texture([thickness_val, 0.0, 0.0, 0.0])
        coat_rgb = params.get_rgb("albedo", np.asarray([1.0, 1.0, 1.0], F))
        coat_albedo = builder.add_constant_texture(
            [coat_rgb[0], coat_rgb[1], coat_rgb[2], 1.0]
        )
        return CoatedDiffuse(
            diffuse_albedo=diffuse_albedo,
            dielectric_eta=dielectric_eta,
            dielectric_remap_roughness=remap,
            dielectric_roughness=rough,
            thickness=thickness,
            coat_albedo=coat_albedo,
        )
    log.warning("unsupported material type %r, defaulting to diffuse gray", mat_type)
    albedo = builder.add_constant_texture([0.5, 0.5, 0.5, 1.0])
    return Diffuse(albedo=albedo)


# ------------------------------------------------------------- directives


def _parse_camera(toks, state, builder):
    cam_type = _unquote(toks.next())
    params = parse_parameter_list(toks)
    c2w = state.current_transform.invert()
    position = c2w.apply_point([0.0, 0.0, 0.0])
    target = c2w.apply_point([0.0, 0.0, 1.0])
    up = c2w.apply_vector([0.0, 1.0, 0.0])
    if cam_type == "orthographic":
        cam = Camera.lookat_camera_orthographic(
            position, target, up, False,
            state.film_width, state.film_height,
            1.0 / min(state.film_width, state.film_height),
        )
    else:
        if cam_type != "perspective":
            log.warning(
                "unsupported camera type %r, defaulting to perspective", cam_type
            )
            fov = 90.0
        else:
            fov = params.get_float("fov", 90.0)
        cam = Camera.lookat_camera_perspective(
            position, target, up, False,
            math.radians(fov), state.film_width, state.film_height,
        )
    builder.add_camera(cam)
    state.has_camera = True


def _parse_texture(toks, state, builder, base_path):
    name = _unquote(toks.next())
    _color_type = _unquote(toks.next())
    tex_type = _unquote(toks.next())
    params = parse_parameter_list(toks)

    if tex_type == "constant":
        v = params.get_rgb("value", np.asarray([1.0, 1.0, 1.0], F))
        tex = ConstantTexture(value=np.asarray([v[0], v[1], v[2], 1.0], F))
    elif tex_type == "imagemap":
        filename = params.get_string("filename")
        if filename is None:
            log.warning("imagemap texture missing filename")
            tex = ConstantTexture(value=np.asarray([1.0, 0.0, 1.0, 1.0], F))
        else:
            try:
                image = Image.load_from_file(base_path / filename)
                image_id = builder.add_image(image)
                tex = ImageTexture(
                    image=image_id,
                    sampler=TextureSampler(
                        filter=FilterMode.BILINEAR, wrap=WrapMode.REPEAT
                    ),
                )
            except Exception as e:
                log.warning("failed to load texture %r: %s", filename, e)
                tex = ConstantTexture(value=np.asarray([1.0, 0.0, 1.0, 1.0], F))
    elif tex_type == "scale":
        s = params.get_float("scale", 1.0)
        tex = ConstantTexture(value=np.asarray([s, s, s, 1.0], F))
    elif tex_type == "checkerboard":
        t1 = params.get_rgb("tex1", np.asarray([0.0, 0.0, 0.0], F))
        t2 = params.get_rgb("tex2", np.asarray([1.0, 1.0, 1.0], F))
        tex = CheckerTexture(
            color1=np.asarray([t1[0], t1[1], t1[2], 1.0], F),
            color2=np.asarray([t2[0], t2[1], t2[2], 1.0], F),
        )
    else:
        log.warning("unsupported texture type %r, using constant white", tex_type)
        tex = ConstantTexture(value=np.asarray([1.0, 1.0, 1.0, 1.0], F))

    state.named_textures[name] = builder.add_texture(tex)


def _parse_shape(toks, state, builder, base_path):
    shape_type = _unquote(toks.next())
    params = parse_parameter_list(toks)

    if state.current_material is not None:
        material_id = state.current_material
    else:
        albedo = builder.add_constant_texture([0.5, 0.5, 0.5, 1.0])
        material_id = builder.add_material(Diffuse(albedo=albedo))

    if shape_type == "sphere":
        shape = Sphere(center=np.zeros(3, F), radius=params.get_float("radius", 1.0))
    elif shape_type == "trianglemesh":
        positions = params.get_point3s("P")
        if positions is None:
            raise PbrtParseError("trianglemesh missing P")
        vertices = np.asarray(positions, F)
        indices = params.get_integers("indices")
        if indices is not None:
            tris = np.asarray(indices, np.uint32).reshape(-1, 3)
        else:
            tris = np.arange(len(vertices) // 3 * 3, dtype=np.uint32).reshape(-1, 3)
        normals = params.get_point3s("N")
        normals = np.asarray(normals, F) if normals is not None else np.zeros((0, 3), F)
        uvs = params.get_point2s("uv")
        if uvs is None:
            flat = params.get_floats("uv")
            uvs = (
                np.asarray(flat, F).reshape(-1, 2)
                if flat is not None
                else np.zeros((0, 2), F)
            )
        else:
            uvs = np.asarray(uvs, F)
        shape = TriangleMesh(
            mesh=Mesh(vertices=vertices, tris=tris, normals=normals, uvs=uvs)
        )
    elif shape_type == "plymesh":
        filename = params.get_string("filename")
        if filename is None:
            raise PbrtParseError("plymesh missing filename")
        try:
            # pbrt meshes appear to have CW winding order
            mesh = load_ply(base_path / filename, swap_handedness=True)
        except Exception as e:
            log.warning("failed to load PLY file %r: %s", filename, e)
            return
        shape = TriangleMesh(mesh=mesh)
    elif shape_type == "disk":
        log.warning("disk shape not supported, creating placeholder sphere")
        shape = Sphere(center=np.zeros(3, F), radius=params.get_float("radius", 1.0))
    else:
        log.warning("unsupported shape type %r, skipping", shape_type)
        return

    if state.area_light_radiance is not None:
        state.has_lights = True
    builder.add_shape_with_transform(
        shape, material_id, state.current_transform, state.area_light_radiance
    )
    state.area_light_radiance = None


def _parse_light_source(toks, state, builder):
    light_type = _unquote(toks.next())
    params = parse_parameter_list(toks)
    if light_type == "point":
        intensity = params.get_rgb("I", np.asarray([1.0, 1.0, 1.0], F))
        scale = params.get_float("scale", 1.0)
        frm = params.get_point3("from", [0.0, 0.0, 0.0])
        position = state.current_transform.apply_point(frm)
        builder.add_light(PointLight(position=position, intensity=intensity * scale))
        state.has_lights = True
    elif light_type == "distant":
        radiance = params.get_rgb("L", np.asarray([1.0, 1.0, 1.0], F))
        scale = params.get_float("scale", 1.0)
        frm = np.asarray(params.get_point3("from", [0.0, 0.0, 1.0]), F)
        to = np.asarray(params.get_point3("to", [0.0, 0.0, 0.0]), F)
        d = to - frm
        d = d / np.linalg.norm(d)
        direction = state.current_transform.apply_vector(d)
        builder.add_light(
            DirectionLight(direction=direction, radiance=radiance * scale)
        )
        state.has_lights = True
    elif light_type in ("infinite", "environment"):
        log.warning("infinite/environment lights not supported")
    elif light_type == "spot":
        log.warning("spot light converted to point light")
        intensity = params.get_rgb("I", np.asarray([1.0, 1.0, 1.0], F))
        frm = params.get_point3("from", [0.0, 0.0, 0.0])
        position = state.current_transform.apply_point(frm)
        builder.add_light(PointLight(position=position, intensity=intensity))
        state.has_lights = True
    else:
        log.warning("unsupported light type %r, skipping", light_type)


def _skip_directive(toks):
    tok = toks.peek()
    if tok is not None and tok.startswith('"'):
        toks.next()
    parse_parameter_list(toks)


# ------------------------------------------------------------------ entry


def load_pbrt_scene(path) -> Scene:
    path = Path(path)
    state = ParserState()
    builder = SceneBuilder()
    _parse_content(path.read_text(), path.parent, state, builder)
    if not state.has_camera:
        raise PbrtParseError("no camera in scene")
    if not state.has_lights:
        log.warning("no lights found in scene")
    return builder.build()


def _parse_content(content, base_path, state, builder):
    toks = TokenStream(content)
    while True:
        directive = toks.next()
        if directive is None:
            break
        if directive == "Identity":
            state.current_transform = Transform.identity()
        elif directive == "LookAt":
            vals = [_float(toks.next()) for _ in range(9)]
            eye, look, up = vals[0:3], vals[3:6], vals[6:9]
            # pbrt is left-handed: apply a handedness swap in camera2world
            t = Transform.look_at(eye, look, up, True)
            state.current_transform = state.current_transform.compose(t.invert())
        elif directive == "Translate":
            v = [_float(toks.next()) for _ in range(3)]
            state.current_transform = state.current_transform.compose(
                Transform.translate(v)
            )
        elif directive == "Scale":
            v = [_float(toks.next()) for _ in range(3)]
            state.current_transform = state.current_transform.compose(
                Transform.scale(v)
            )
        elif directive == "Rotate":
            a = _float(toks.next())
            axis = [_float(toks.next()) for _ in range(3)]
            state.current_transform = state.current_transform.compose(
                Transform.rotate(math.radians(a), axis)
            )
        elif directive in ("Transform", "ConcatTransform"):
            toks.expect("[")
            m = np.asarray([_float(toks.next()) for _ in range(16)], F)
            toks.expect("]")
            t = Transform.from_matrix(m.reshape(4, 4).T)  # column-major input
            if directive == "Transform":
                state.current_transform = t
            else:
                state.current_transform = state.current_transform.compose(t)
        elif directive == "Film":
            _unquote(toks.next())
            params = parse_parameter_list(toks)
            state.film_width = params.get_integer("xresolution", 640)
            state.film_height = params.get_integer("yresolution", 480)
        elif directive == "Camera":
            _parse_camera(toks, state, builder)
        elif directive == "Material":
            mat_type = _unquote(toks.next())
            params = parse_parameter_list(toks)
            mat = _create_material(mat_type, params, state, builder)
            state.current_material = builder.add_material(mat)
        elif directive == "MakeNamedMaterial":
            name = _unquote(toks.next())
            params = parse_parameter_list(toks)
            mat_type = params.get_string("type", "diffuse")
            mat = _create_material(mat_type, params, state, builder)
            state.named_materials[name] = builder.add_material(mat)
        elif directive == "NamedMaterial":
            name = _unquote(toks.next())
            if name in state.named_materials:
                state.current_material = state.named_materials[name]
            else:
                log.warning("unknown named material %r, using current material", name)
        elif directive == "Texture":
            _parse_texture(toks, state, builder, base_path)
        elif directive == "Shape":
            _parse_shape(toks, state, builder, base_path)
        elif directive == "LightSource":
            _parse_light_source(toks, state, builder)
        elif directive == "AreaLightSource":
            light_type = _unquote(toks.next())
            params = parse_parameter_list(toks)
            if light_type == "diffuse":
                radiance = params.get_rgb("L", np.asarray([1.0, 1.0, 1.0], F))
                scale = params.get_float("scale", 1.0)
                state.area_light_radiance = radiance * scale
            else:
                log.warning("unsupported area light type %r, ignoring", light_type)
        elif directive == "WorldBegin":
            state.current_transform = Transform.identity()
        elif directive == "WorldEnd":
            break
        elif directive in ("AttributeBegin", "TransformBegin"):
            state.push()
        elif directive in ("AttributeEnd", "TransformEnd"):
            state.pop()
        elif directive == "Include":
            inc = _unquote(toks.next())
            inc_path = base_path / inc
            _parse_content(
                inc_path.read_text(), inc_path.parent, state, builder
            )
        elif directive in (
            "Sampler", "Integrator", "PixelFilter", "Accelerator", "ColorSpace",
        ):
            _skip_directive(toks)
        elif directive == "ReverseOrientation":
            pass
        elif directive in ("ObjectBegin", "ObjectEnd", "ObjectInstance"):
            if directive in ("ObjectBegin", "ObjectInstance"):
                _skip_directive(toks)
            log.warning("instancing (ObjectBegin/End/Instance) not supported")
        elif directive in ("MediumInterface", "MakeNamedMedium"):
            _skip_directive(toks)
            log.warning("media/volumes not supported")
        else:
            if directive.startswith('"'):
                continue
            log.warning("unknown directive %r, ignoring", directive)
