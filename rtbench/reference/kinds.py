"""Material kind codes of the reference's tables, and the loader of the
benchmark's kind files.

Every kind a configuration or a traffic file names is a file of its own,
`kinds/<group>/<kind>.py` under the benchmark's directory (groups:
camera, material, shape, light, traffic), found by that name: a later
cell that brings a new kind brings its file and edits none.
"""
from __future__ import annotations

import importlib.util
import re
from pathlib import Path
from types import ModuleType

MAT_DIFFUSE = 0
MAT_SMOOTH_DIELECTRIC = 1
MAT_SMOOTH_CONDUCTOR = 2
MAT_ROUGH_DIELECTRIC = 3
MAT_ROUGH_CONDUCTOR = 4
MAT_COATED_DIFFUSE = 5

_NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
_LOADED: dict = {}


def load_kind(root: Path, group: str, name: str) -> ModuleType:
    """The kind file `root/kinds/<group>/<name>.py`, loaded once."""
    if not isinstance(name, str) or not _NAME.fullmatch(name):
        raise ValueError(f"{group} kind {name!r} is not a name")
    path = Path(root) / "kinds" / group / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {group} kind file {path}")
    return load_file(path)


def load_file(path: Path) -> ModuleType:
    """The Python file at `path` as a module, loaded once; its name may
    hold dots and dashes."""
    if path not in _LOADED:
        mod_name = "rtbench_" + re.sub(r"\W", "_", str(path.relative_to(
            path.parent.parent.parent)).removesuffix(".py"))
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[path] = mod
    return _LOADED[path]


def material_row(kind: int, **fields) -> dict:
    """A row of the reference's material table: what get_bsdf_params
    reads, each field zero (false) where the material does not set it."""
    row = dict(kind=kind, albedo=[0.0] * 3, eta=[0.0] * 3, kappa=[0.0] * 3,
               alpha=[0.0, 0.0], remap=False, has_rough=False, thickness=0.0,
               coat_albedo=[0.0] * 3)
    unknown = set(fields) - set(row)
    if unknown:
        raise ValueError(f"material fields {sorted(unknown)}")
    row.update(fields)
    return row
