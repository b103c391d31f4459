"""Test runner: the port's copy of visual_testing/rttest/runner.py.

Per test: delete stale output, invoke the port's CLI
(`python -m tpu_raytracing_torch.cli`) as a subprocess with the JAX
harness's timeout and perf_counter timing, then classify: ERROR (renderer
failed, or the reference does not fit the row), NEW (no reference), PASS
or FAIL by the statistical gate against the JAX package's CPU reference
(a digest record, or a full EXR for the AOV rows). skip_visual tests only
record timing.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

from .diff import compare_digest, compare_images, load_exr_channels
from .digest import References, row_args
from .test_spec import TestSpec

# the layered coated_diffuse bunny takes over 20 min single-process on the
# CPU backend
TIMEOUT_SECONDS = int(os.environ.get("RTTEST_TIMEOUT", "2400"))
REPO = Path(__file__).resolve().parents[2]


@dataclass
class TestResult:
    name: str
    status: str                       # PASS | FAIL | NEW | ERROR | SKIP
    render_time_seconds: float = 0.0
    mse: Optional[float] = None
    max_diff: Optional[float] = None
    message: str = ""
    output_path: Optional[str] = None
    reference_path: Optional[str] = None
    channel_group: Optional[str] = None
    rel_mean: Optional[float] = None
    block_rel: Optional[float] = None

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "status": self.status,
            "render_time_seconds": self.render_time_seconds,
            "mse": self.mse,
            "max_diff": self.max_diff,
            "group": self.channel_group,
            "rel_mean": self.rel_mean,
            "block_rel": self.block_rel,
            "message": self.message,
            "output": self.output_path,
            "reference": self.reference_path,
        }


def build_command(
    spec: TestSpec,
    output_path: Path,
    renderer_args: List[str],
    backend: str,
    base_dir: Path,
) -> List[str]:
    cmd = [sys.executable, "-m", "tpu_raytracing_torch.cli"]
    cmd += spec.scene_cli_args(base_dir)
    cmd += ["-o", str(output_path), "--backend", backend]
    cmd += renderer_args
    cmd += spec.settings.to_cli_args()
    return cmd


def gate(spec: TestSpec, output_path: Path, refs: References,
         base_dir: Path):
    """(status, DiffResult or None, message, reference path or None) of an
    output EXR against the row's reference."""
    rec, ref_exr = refs.lookup(spec.name)
    if rec is None and ref_exr is None:
        return ("NEW", None, "no reference; make the JAX package's with "
                "`python -m tpu_raytracing_torch.rttest digest`", None)
    args = row_args(spec, base_dir)
    if rec is not None and rec["args"] != args:
        return ("ERROR", None, f"reference rendered with {rec['args']}, the "
                f"row renders with {args}", None)
    if ref_exr is not None:
        diff = compare_images(output_path, ref_exr)
    else:
        group, out = load_exr_channels(output_path)
        diff = compare_digest(group, out, rec)
    ok = diff.stat_passes(spec.settings.stat_rel_mean,
                          spec.settings.stat_block_rel)
    tol = spec.settings.stat_rel_mean
    msg = (
        f"stat gate [{diff.channel_group}]: rel_mean={diff.rel_mean:.4f}"
        + (f" (tol {tol})" if tol is not None else "")
        + f" block_rel={diff.block_rel:.4f}"
        + (f" mse={diff.mse:.2e}" if diff.mse is not None else "")
    )
    ref = ref_exr if ref_exr is not None else refs.path / "digest.json"
    return ("PASS" if ok else "FAIL"), diff, msg, ref


def run_single_test(
    spec: TestSpec,
    output_dir: Path,
    refs: References,
    renderer_args: List[str],
    backend: str,
    base_dir: Path,
    visual: bool = True,
) -> TestResult:
    output_path = output_dir / f"{spec.name}.exr"
    output_path.unlink(missing_ok=True)
    output_dir.mkdir(parents=True, exist_ok=True)

    # external scene assets are not version-controlled; classify their
    # absence as a one-line missing-asset ERROR, not a renderer traceback
    if spec.scene_path is not None:
        scene_file = base_dir / spec.scene_path
        if not scene_file.exists():
            return TestResult(
                spec.name, "ERROR", 0.0,
                message=f"missing scene asset: {spec.scene_path} "
                        "(external blob, not in checkout)",
            )

    # the CLI writes under scenes/output/<path>; hand it an absolute path
    cmd = build_command(spec, output_path.resolve(), renderer_args, backend,
                        base_dir)
    t0 = time.perf_counter()
    try:
        env = dict(os.environ)
        env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
        proc = subprocess.run(
            cmd, capture_output=True, text=True, timeout=TIMEOUT_SECONDS,
            cwd=base_dir, env=env,
        )
    except subprocess.TimeoutExpired:
        return TestResult(
            spec.name, "ERROR", time.perf_counter() - t0,
            message=f"renderer timed out after {TIMEOUT_SECONDS}s",
        )
    elapsed = time.perf_counter() - t0

    actual = _locate_output(base_dir, output_path)
    if proc.returncode != 0:
        return TestResult(
            spec.name, "ERROR", elapsed,
            message=_error_summary(proc.stderr, proc.returncode),
        )
    if actual is None:
        return TestResult(
            spec.name, "ERROR", elapsed, message="renderer produced no output"
        )
    if actual != output_path:
        output_path.parent.mkdir(parents=True, exist_ok=True)
        actual.replace(output_path)

    if not visual or spec.skip_visual:
        return TestResult(
            spec.name, "SKIP", elapsed, output_path=str(output_path)
        )

    try:
        status, diff, msg, ref = gate(spec, output_path, refs, base_dir)
    except Exception as e:
        return TestResult(
            spec.name, "ERROR", elapsed, message=f"diff failed: {e}",
            output_path=str(output_path),
        )
    res = TestResult(
        spec.name, status, elapsed, message=msg,
        output_path=str(output_path),
        reference_path=None if ref is None else str(ref),
    )
    if diff is not None:
        res.mse, res.max_diff = diff.mse, diff.max_diff
        res.channel_group = diff.channel_group
        res.rel_mean, res.block_rel = diff.rel_mean, diff.block_rel
    return res


def _error_summary(stderr: str, returncode: int) -> str:
    """One readable line from a failed renderer's stderr: the exception
    line rather than trailing boilerplate."""
    if not stderr:
        return f"renderer failed (exit {returncode})"
    lines = [ln.strip() for ln in stderr.strip().splitlines() if ln.strip()]
    for ln in reversed(lines):
        # 'SomeError: message' / 'Exception: message' shaped lines
        head = ln.split(":", 1)[0]
        if head.endswith(("Error", "Exception", "Interrupt")) and " " not in head:
            return ln[:300]
    for ln in reversed(lines):
        if "error" in ln.lower() or "crash" in ln.lower():
            return ln[:300]
    return lines[-1][:300]


def _locate_output(base_dir: Path, requested: Path) -> Optional[Path]:
    """The CLI joins -o onto scenes/output/; find the file it wrote."""
    if requested.exists():
        return requested
    joined = base_dir / "scenes" / "output" / requested.name
    if joined.exists():
        return joined
    # absolute -o joined onto scenes/output keeps the abs path's tail on
    # POSIX (Path('/a') / Path('/b/c.exr') -> '/b/c.exr'), so requested is
    # normally correct; this is a fallback for relative -o
    rel = base_dir / "scenes" / "output" / requested
    return rel if rel.exists() else None


def run_tests(
    specs: List[TestSpec],
    output_dir: Path,
    refs: References,
    renderer_args: List[str],
    backend: str,
    base_dir: Path,
    visual: bool = True,
) -> List[TestResult]:
    results = []
    for spec in specs:
        res = run_single_test(
            spec, output_dir, refs, renderer_args, backend, base_dir, visual,
        )
        icon = {
            "PASS": "✓", "FAIL": "✗", "NEW": "?", "ERROR": "!", "SKIP": "-"
        }[res.status]
        print(
            f"  {icon} {res.name:<24} {res.status:<5} "
            f"{res.render_time_seconds:7.2f}s"
            + (f"  {res.message}" if res.message else ""),
            flush=True,
        )
        results.append(res)
    return results
