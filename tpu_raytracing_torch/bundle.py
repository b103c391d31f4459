"""Distribution bundler (parity: crates/xtask `cargo xtask bundle`).

Counterpart of tpu_raytracing/bundle.py. The reference bundler builds the
CLI, collects its native libraries next to it, and patches $ORIGIN rpaths
(crates/xtask/src/bundle.rs:36-82). Here the port's package is copied into
a self-contained dist/ tree with its sources and without what it builds
(`_build/`, `__pycache__`, the harness's `rttest/out/`), with the rttest
suite file the harness reads by path (visual_testing/tests/tests.toml), and
launcher scripts that pin PYTHONPATH are written beside it. The bundled
package builds its native host library (g++) and its CUDA kernels (nvcc)
at first use from the copied sources, as the repository does.

Usage: python -m tpu_raytracing_torch.bundle [--output-dir dist]
"""
from __future__ import annotations

import argparse
import shutil
import stat
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
SUITE = Path("visual_testing") / "tests" / "tests.toml"
LAUNCHERS = (
    ("tpu-raytracing-torch", "tpu_raytracing_torch.cli"),
    ("tpu-raytracing-torch-viewer", "tpu_raytracing_torch.viewer"),
    ("rttest-torch", "tpu_raytracing_torch.rttest"),
)


def _ignore(directory, names):
    """What the package builds or writes at run time."""
    return [n for n in names
            if n in ("__pycache__", "_build") or n.endswith(".pyc")
            or (n == "out" and Path(directory).name == "rttest")]


def bundle(output_dir: Path) -> Path:
    output_dir = output_dir.resolve()
    if output_dir.exists():
        shutil.rmtree(output_dir)
    output_dir.mkdir(parents=True)
    shutil.copytree(REPO / "tpu_raytracing_torch",
                    output_dir / "tpu_raytracing_torch", ignore=_ignore)
    (output_dir / SUITE).parent.mkdir(parents=True)
    shutil.copy(REPO / SUITE, output_dir / SUITE)
    for name, module in LAUNCHERS:  # the $ORIGIN-rpath equivalent
        path = output_dir / name
        path.write_text(
            "#!/bin/sh\n"
            'HERE="$(cd "$(dirname "$0")" && pwd)"\n'
            f'PYTHONPATH="$HERE${{PYTHONPATH:+:$PYTHONPATH}}" '
            f'exec {sys.executable} -m {module} "$@"\n'
        )
        path.chmod(path.stat().st_mode | stat.S_IEXEC | stat.S_IXGRP
                   | stat.S_IXOTH)
    return output_dir


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tpu-raytracing-torch-bundle")
    p.add_argument("--output-dir", type=Path, default=REPO / "dist")
    args = p.parse_args(argv)
    out = bundle(args.output_dir)
    print(f"bundled -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
