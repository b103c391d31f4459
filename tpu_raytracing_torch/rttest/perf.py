"""Performance tracking: the port's copy of visual_testing/rttest/perf.py.

Every run appends a PerfRecord to perf_history.jsonl; blessed baselines in
perf_baseline.json gate regressions: flagged iff the settings hash matches
and the slowdown exceeds the threshold percentage.
"""
from __future__ import annotations

import hashlib
import json
import subprocess
import time
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Dict, List, Optional


def settings_hash(renderer_args: List[str], backend: str) -> str:
    """12-hex digest of the sorted renderer args + backend."""
    blob = json.dumps({"args": sorted(renderer_args), "backend": backend})
    return hashlib.sha256(blob.encode()).hexdigest()[:12]


def git_short_hash() -> str:
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, check=True,
        ).stdout.strip()
    except Exception:
        return "unknown"


@dataclass
class PerfRecord:
    scene: str
    commit: str
    timestamp: float
    render_time_seconds: float
    settings_hash: str
    spp: Optional[int]
    light_samples: Optional[int]
    backend: str

    def to_dict(self) -> dict:
        return asdict(self)


class PerfHistory:
    """Append-only jsonl of every timed run."""

    def __init__(self, path: Path):
        self.path = path

    def append(self, record: PerfRecord) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        with open(self.path, "a") as f:
            f.write(json.dumps(record.to_dict()) + "\n")

    def records_for(self, scene: str) -> List[PerfRecord]:
        if not self.path.exists():
            return []
        out = []
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                d = json.loads(line)
                if d.get("scene") == scene:
                    out.append(PerfRecord(**d))
        return out


class PerfBaseline:
    """Blessed per-(scene, settings_hash) timings."""

    def __init__(self, path: Path):
        self.path = path
        self.data: Dict[str, dict] = {}
        if path.exists():
            self.data = json.loads(path.read_text())

    def _key(self, scene: str, shash: str) -> str:
        return f"{scene}:{shash}"

    def set(self, record: PerfRecord) -> None:
        self.data[self._key(record.scene, record.settings_hash)] = record.to_dict()

    def save(self) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.path.write_text(json.dumps(self.data, indent=2))

    def check_regression(
        self, record: PerfRecord, threshold_pct: float
    ) -> Optional[dict]:
        """A regression dict if this run is > threshold% slower than the
        blessed baseline with the same settings hash, else None."""
        base = self.data.get(self._key(record.scene, record.settings_hash))
        if base is None:
            return None
        base_t = base["render_time_seconds"]
        if base_t <= 0:
            return None
        delta_pct = (record.render_time_seconds - base_t) / base_t * 100.0
        if delta_pct > threshold_pct:
            return {
                "scene": record.scene,
                "baseline_seconds": base_t,
                "current_seconds": record.render_time_seconds,
                "delta_pct": delta_pct,
            }
        return None


def make_record(
    scene: str, seconds: float, renderer_args: List[str], backend: str,
    spp: Optional[int], light_samples: Optional[int],
) -> PerfRecord:
    return PerfRecord(
        scene=scene,
        commit=git_short_hash(),
        timestamp=time.time(),
        render_time_seconds=seconds,
        settings_hash=settings_hash(renderer_args, backend),
        spp=spp,
        light_samples=light_samples,
        backend=backend,
    )
