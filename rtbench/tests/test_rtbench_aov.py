"""The `bunny-aov` cell (AOV-only feature buffers through the port's
`render`): a tiny run on the CPU is correct, a traced one carries the
port's span counters to the `aov.*` readers, and the check fails the
control (the reference in the program's place, in TF32) and a run with
the timed path broken underneath, once for each fault an AOV frame can
have (bent normals, a wrong albedo, a walk that loses hits, half of the
frame left out, jittered camera rays, a ray counter off, a frame that
differs from the first). On the card, a traced run reports every metric
of the cell."""
import importlib

import pytest
import torch

from rtbench_helpers import SEED, Args, run_cell, tiny_cell

CELL = "bunny-aov"
READERS = ("aov.chunk_host_pct", "aov.to_host_pct")


@pytest.mark.parametrize("width", [16, 24])
def test_tiny_run_is_correct(width, capsys):
    res = run_cell(tiny_cell(CELL, width), capsys, seconds=0.5)
    assert res["correct"] is True
    assert res["attempted"] >= 2 and res["failed"] == 0
    assert set(res["metrics"]) == {"mrays_per_s", "setup_s"}
    check = res["check"]
    assert list(check) == list(tiny_cell(CELL, width).job.NUMBERS)
    assert check["camera_ray_err"]["value"] == 0.0
    assert check["frame_drift"]["value"] == 0.0
    assert check["rays_counter_diff"]["value"] == 0.0


def test_tiny_traced_run_reads_the_program_spans(capsys):
    res = run_cell(tiny_cell(CELL, 12), capsys, trace=1)
    assert res["correct"] is True
    # the captured frame, the two profiled, and two more with the spans on
    assert res["attempted"] == 5
    assert set(res["metrics"]) == set(READERS)
    chunk, to_host = (res["metrics"][m]["value"] for m in READERS)
    assert 0 < chunk < 100 and 0 < to_host < 100 and chunk + to_host <= 100


def test_readers_read_nothing_without_the_counters():
    """A program without the span counters (or a run without a traced
    window) gives no value, and no error."""
    from types import SimpleNamespace
    from harness.spec import load_module
    from rtbench_helpers import BENCH
    for name in READERS:
        m = load_module(BENCH / "metrics" / f"{name}.py")
        for window in (SimpleNamespace(),
                       SimpleNamespace(program_trace=None),
                       SimpleNamespace(program_trace={
                           "counts": {"sync.render.to_host": 2},
                           "wall_ns": 10})):
            assert m.read(SimpleNamespace(window=window, trace=None)) is None
        got = m.read(SimpleNamespace(window=SimpleNamespace(program_trace={
            "counts": {"host_ns." + m.SPAN: 3}, "wall_ns": 12}), trace=None))
        assert got == 25.0


def test_readers_raise_on_a_traced_window_without_its_trace():
    """A traced run whose aov window carries no program trace (the kind
    found no Slice behind `after_pass`) raises, rather than leaving the
    metrics out."""
    from types import SimpleNamespace
    from harness.spec import load_module
    from rtbench_helpers import BENCH
    for name in READERS:
        m = load_module(BENCH / "metrics" / f"{name}.py")
        run = SimpleNamespace(window=SimpleNamespace(program_trace=None),
                              trace=None, traced_passes=2)
        with pytest.raises(RuntimeError, match="no program trace"):
            m.read(run)
        # a beauty window has no such field: nothing to read, no error
        run.window = SimpleNamespace()
        assert m.read(run) is None


@pytest.mark.parametrize("width", [12, 16])
def test_control_fails_the_check(width):
    import control
    cell = tiny_cell(CELL, width)
    numbers = control.control_numbers(cell, SEED, 3, "cpu")
    failed = [k for k in cell.job.NUMBERS if numbers[k] > cell.limits[k]]
    assert {"camera_ray_err", "normal_mismatch",
            "albedo_mismatch"} <= set(failed)


def _render():
    return importlib.import_module("tpu_raytracing_torch.integrator.render")


def _chunk_fault(monkeypatch, change):
    """`render_aov_chunk`'s outputs passed through `change`."""
    mod = _render()
    real = mod.render_aov_chunk

    def changed(*args, **kw):
        return change(*real(*args, **kw))
    monkeypatch.setattr(mod, "render_aov_chunk", changed)


def fault_normals(monkeypatch):
    """The normals are bent by 1e-4 where they are produced."""
    _chunk_fault(monkeypatch, lambda n, a, uv, mip: (
        torch.where(n != 0, n + 1e-4, n), a, uv, mip))


def fault_albedo(monkeypatch):
    """The albedo's red channel is off by 1%."""
    def change(n, a, uv, mip):
        a = a.clone()
        a[:, 0] *= 1.01
        return n, a, uv, mip
    _chunk_fault(monkeypatch, change)


def fault_walk(monkeypatch):
    """Traversal reports a miss on every eighth lane."""
    mod = _render()
    real = mod.intersect_scene

    def blind(*args, **kw):
        t, prim = real(*args, **kw)
        prim = prim.clone()
        prim[::8] = -1
        return torch.where(prim >= 0, t, float("inf")), prim
    monkeypatch.setattr(mod, "intersect_scene", blind)


def fault_half(monkeypatch):
    """Half of each chunk's lanes are walked dead."""
    mod = _render()
    real = mod.render_aov_chunk

    def half(*args, active=None, **kw):
        keep = active.clone()
        keep[keep.shape[0] // 2:] = False
        return real(*args, active=keep, **kw)
    monkeypatch.setattr(mod, "render_aov_chunk", half)


def fault_jitter(monkeypatch):
    """The camera rays are jittered, as the beauty pass's are."""
    mod = _render()
    real = mod.generate_rays

    def jittered(ds, px, py, cfg, stream, spp, jitter):
        return real(ds, px, py, cfg, stream, spp, True)
    monkeypatch.setattr(mod, "generate_rays", jittered)


def fault_counter(monkeypatch):
    """`aov_rays_traced` counts each ray twice."""
    mod = _render()
    real = mod.render

    def double(*args, **kw):
        out = real(*args, **kw)
        out.aov_rays_traced *= 2
        return out
    monkeypatch.setattr(mod, "render", double)


def fault_drift(monkeypatch):
    """Every frame after the first bends the normals of one pixel in
    four."""
    mod = _render()
    real = mod.render
    frames = []

    def drifting(*args, **kw):
        out = real(*args, **kw)
        frames.append(1)
        if len(frames) > 1:
            out.normals = out.normals.copy()
            out.normals.reshape(-1, 3)[::4] += 1e-3
        return out
    monkeypatch.setattr(mod, "render", drifting)


FAULTS = [fault_normals, fault_albedo, fault_walk, fault_half, fault_jitter,
          fault_counter, fault_drift]


@pytest.mark.parametrize("fault", FAULTS)
def test_broken_program_is_not_correct(fault, monkeypatch, capsys):
    cell = tiny_cell(CELL, 12)
    cell = cell._replace(settings=dict(cell.settings, warmup_passes=0))
    fault(monkeypatch)
    res = run_cell(cell, capsys, seconds=0.5)
    assert res["correct"] is False


@pytest.mark.cuda
def test_card_traced_run_reports_every_layer(card, capsys):
    import run as bench_run
    import json
    cell = tiny_cell(CELL, 64)
    assert bench_run.measure(cell, Args(trace=1), torch, on_card=True) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["correct"] is True
    assert set(res["metrics"]) == {
        "device.idle_pct", "device.launches_per_pass",
        "integrator.syncs_per_pass", "traversal.device_ms_per_pass",
        "traversal.bvh8t_walk_roofline", *READERS}
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    assert res["metrics"]["traversal.bvh8t_walk_roofline"]["value"] <= 100
    # the profiled frames ran with the port's spans off: no span on the
    # card's timeline among the kernels
    assert not any(name.startswith("rt.")
                   for name, _ in res["breakdown"]["device_ops"])
