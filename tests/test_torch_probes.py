"""The cost probes P3 (iteration cost) and P4 (bf16 slab): each plain
version against the JAX package's Pallas probe it stands for.

The probes are scripts (scripts/probe_iter_cost.py, probe_bf16_vpu.py),
loaded here by path with their jax.config.update calls dropped (they point
JAX's compilation cache into the repo), and run in interpret mode with
pallas_call patched and the module's ITERS set small. Their CUDA
counterparts (csrc/probe_*.cu) are held against the same plain versions on
the card, in tests/test_torch_cuda.py.

P3's kernel runs K3's exact prefilter before its divides: on P3's inputs
the prefilter's plain twin rejects no test the plain version accepts, and
the host's count of the full tests it leaves the kernel is bounded.

Tolerances: P4 is bit-equal in float32 and in bf16. P3's output
t_best + float(best) is bit-equal too (no multiply-add is contracted), on
the script's inputs, whose ids are random float bits near 1e9 that hide
t, and on inputs whose id lanes hold small integers, where t shows.
"""
import functools
import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from tpu_raytracing_torch.native_cuda import (
    launch_counts, reset_launch_counts,
)
from tpu_raytracing_torch.ops.intersect import prefilter_rejects
from tpu_raytracing_torch.probes import bf16_vpu as P4
from tpu_raytracing_torch.probes import common
from tpu_raytracing_torch.probes import iter_cost as P3

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
P3_ITERS = 16
P4_ITERS = 32
# the script's five, plus a static read without roll and a chain under
# fori, which the plain version takes and the kernel does not
P3_CASES = list(P3.CONFIGS) + [(2, False, False, False, "fori"),
                               (4, False, True, True, "fori")]
CACHE_KEYS = ("jax_compilation_cache_dir",
              "jax_persistent_cache_min_compile_time_secs")


@pytest.fixture(scope="module")
def scripts():
    """The two probe scripts as modules; the JAX settings they would change
    stay as they were, and no cache directory appears."""
    before = {k: getattr(jax.config, k) for k in CACHE_KEYS}
    mods = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.config, "update", lambda *a, **k: None)
        for name in ("probe_iter_cost", "probe_bf16_vpu"):
            spec = importlib.util.spec_from_file_location(
                f"_script_{name}", ROOT / "scripts" / f"{name}.py")
            mods[name] = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mods[name])
    assert {k: getattr(jax.config, k) for k in CACHE_KEYS} == before
    assert not (ROOT / ".jax_cache").exists()
    return mods


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _p3_inputs(kind):
    """The script's inputs, or the same with small integer ids."""
    return [x.numpy() for x in P3.script_inputs(small_ids=kind == "small_ids")]


@pytest.mark.parametrize("inputs", ["script", "small_ids"])
@pytest.mark.parametrize("config", P3_CASES, ids=[
    P3.label(c).replace(" ", ",") for c in P3_CASES])
def test_iter_cost_plain_vs_pallas(scripts, interpret, monkeypatch, config,
                                   inputs):
    mod = scripts["probe_iter_cost"]
    monkeypatch.setattr(mod, "ITERS", P3_ITERS)
    arrays = _p3_inputs(inputs)
    want = np.asarray(jax.jit(mod.make(*config))(*map(jnp.asarray, arrays)))
    got = P3.iter_cost_plain(*map(torch.from_numpy, arrays), *config,
                             P3_ITERS).numpy()
    fin = np.isfinite(want)
    assert want.shape == got.shape == (config[0], P3.LANE)
    assert 0.0 < fin.mean() < 1.0  # part of the rays hit, part do not
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    if inputs == "small_ids":  # ids below 4096: t shows in the output
        assert np.all(want[fin] < 4096 + 1e3)


def test_iter_cost_roll_reads_forward(scripts, interpret, monkeypatch):
    """One iteration at q = 1 reads lanes 10..19 (pltpu.roll by 118 is
    jnp.roll's direction), with the chain's address at 1 too."""
    mod = scripts["probe_iter_cost"]
    monkeypatch.setattr(mod, "ITERS", 2)
    tris, o, d, tmn = _p3_inputs("small_ids")
    tris[:, :10] = 0.0  # iteration 0's triangles hit nothing
    want = np.asarray(jax.jit(mod.make(1, True, True, False, "fori"))(
        tris, o, d, tmn))
    got = P3.iter_cost_plain(*map(torch.from_numpy, (tris, o, d, tmn)),
                             1, True, True, False, "fori", 2).numpy()
    assert np.isfinite(want).any()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def _jax_to_torch(x):
    """A JAX array as a torch tensor of the same bits (bf16 included)."""
    a = np.asarray(x)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _p4_script_inputs(jdt, seed=0):
    """box, ray as the script draws them, in its order (f32 first)."""
    rng = np.random.default_rng(seed)
    draws = [rng.standard_normal(P4.SHAPE) for _ in range(4)]
    first = 0 if jdt == jnp.float32 else 2
    return [jnp.asarray(x, jdt) for x in draws[first:first + 2]]


@pytest.mark.parametrize("seed", [0, 1], ids=["script", "seed1"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bf16_vpu_plain_vs_pallas(scripts, interpret, monkeypatch, dtype,
                                  seed):
    mod = scripts["probe_bf16_vpu"]
    monkeypatch.setattr(mod, "ITERS", P4_ITERS)
    jdt = jnp.dtype(dtype)
    box, ray = _p4_script_inputs(jdt, seed)
    want = np.asarray(jax.jit(mod.make(jdt))(box, ray))
    got = P4.bf16_vpu_plain(_jax_to_torch(box), _jax_to_torch(ray),
                            P4_ITERS).numpy()
    assert got.dtype == want.dtype == np.float32
    assert np.isfinite(want).all()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bf16_vpu_needs_one_axis_pass(dtype):
    """The function needs 11 operations an element an iteration, not the 27
    written: one axis pass gives the three passes' output bit for bit."""
    box, ray = P4.script_inputs()[dtype]
    c = lambda x: torch.tensor(x, dtype=box.dtype)  # noqa: E731
    t0, t1 = torch.full_like(box, -1e3), torch.full_like(box, 1e3)
    b = box
    for _ in range(P4_ITERS):
        b = b + t0 * c(1e-7)
        lo, hi = (b - ray) * c(0.5), (b + ray) * c(0.5)
        t0 = torch.maximum(t0, torch.minimum(lo, hi))
        t1 = torch.minimum(t1, torch.maximum(lo, hi))
        t0 = t0 * c(0.999)
    one_pass = t0.float() + t1.float()
    assert P4.OPS_PER_ELEMENT == 11
    assert torch.equal(one_pass.view(torch.int32),
                       P4.bf16_vpu_plain(box, ray, P4_ITERS).view(torch.int32))


def test_script_inputs_equal_the_scripts():
    """The mains draw the scripts' inputs: P3's bit for bit, and P4's bf16
    rounded through float32 gives the script's direct rounding."""
    rng = np.random.default_rng(0)
    want = [np.asarray(jnp.asarray(rng.standard_normal(s), jnp.float32))
            for s in ((128, 128), (12, 128), (12, 128))]
    for a, b in zip(P3.script_inputs(), want):
        np.testing.assert_array_equal(a.numpy(), b)
    got = P4.script_inputs()
    for name, jdt in (("float32", jnp.float32), ("bfloat16", jnp.bfloat16)):
        for a, b in zip(got[name], _p4_script_inputs(jdt)):
            assert torch.equal(a, _jax_to_torch(b))


def test_wrappers_run_plain_on_cpu():
    """On CPU tensors each wrapper is its plain version and counts no
    launch."""
    reset_launch_counts()
    ins = P3.script_inputs()
    config = P3.CONFIGS[3]
    assert torch.equal(P3.iter_cost(*ins, *config, 8),
                       P3.iter_cost_plain(*ins, *config, 8))
    box, ray = P4.script_inputs()["bfloat16"]
    assert torch.equal(P4.bf16_vpu(box, ray, 8), P4.bf16_vpu_plain(box, ray, 8))
    assert not launch_counts()


@pytest.mark.parametrize("inputs", ["script", "small_ids"])
def test_prefilter_keeps_every_hit(inputs):
    """K3's exact prefilter (ops/intersect.py::prefilter_rejects, the twin
    of the kernels' surely_misses) on P3's inputs, every block x shift x
    ray: it rejects no test that the plain Moller-Trumbore accepts at
    t_best = inf, from the den and numerators that test computes; and it
    keeps few of them (about 3%: the divides the kernel skips)."""
    tris, o, d, t_min = P3.script_inputs(small_ids=inputs == "small_ids")
    R = P3.RMAX
    o3, d3 = o.reshape(3, R, 1, P3.LANE), d.reshape(3, R, 1, P3.LANE)
    t_best = torch.full((R, P3.LANE), float("inf"))
    tests = kept = hits = 0
    for block in range(P3.NB):
        for shift in range(0, 120, 10):
            den, nu, nv, ok, _ = common.mt_rows(
                tris, o3, d3, t_min[:, None, :], t_best, block, shift)
            keep = ~prefilter_rejects(den, nu, nv)
            assert not (ok & ~keep).any()
            assert torch.equal(keep, P3.kept(tris, o, d, t_min, R, block,
                                              shift))
            tests, kept, hits = (tests + keep.numel(), kept + int(keep.sum()),
                                 hits + int(ok.sum()))
    print(f"{inputs}: the prefilter keeps {kept} of {tests} tests "
          f"({kept / tests * 100:.2f}%); {hits} of them hit")
    assert 0 < hits <= kept < 0.05 * tests


@pytest.mark.parametrize("S", [1, 2, 4])
@pytest.mark.parametrize("R", [4, 1])
def test_deferred_trips_bound_the_kept_tests(R, S):
    """A warp trip of the kernel's second pass takes at most one kept test
    a thread, and no thread takes more than its 16 x S: the host's count
    of them lies between those bounds on 24 iterations, at the kernel's S
    (RAYS_PER_THREAD) and at the others its source takes."""
    ins = P3.script_inputs()
    trace = [(q % P3.NB, (q % 12) * 10) for q in range(24)]
    warps = R * P3.LANE // S // 32
    trips = P3.deferred_trips(*ins, R, S, trace)
    kept = sum(int(P3.kept(*ins, R, *key).sum()) for key in trace)
    assert kept / 32 <= trips <= len(trace) * warps * P3.LG * S
    assert trips <= kept


@pytest.mark.parametrize("config", P3.CONFIGS, ids=P3.label)
def test_iter_cost_plain_traces_its_iterations(config):
    """The plain version's trace: one (block, shift) an iteration run,
    block q % 8 and shift (q % 12) * 10 along the addresses q visited."""
    trace, counts = [], torch.zeros(1, dtype=torch.int32)
    P3.iter_cost_plain(*P3.script_inputs(), *config, 48, counts=counts,
                       trace=trace)
    assert len(trace) == int(counts.item())
    for block, shift in trace:
        assert block in range(P3.NB) and shift in range(0, 120, 10)
    if not config[3]:
        assert trace == [(q % P3.NB, (q % 12) * 10) for q in range(48)]


@pytest.mark.parametrize("config", P3.CONFIGS, ids=P3.label)
def test_iter_cost_counts_iterations_run(config):
    """Without the chain every iteration runs; the chain skips the
    addresses its drain jumps over."""
    counts = torch.zeros(1, dtype=torch.int32)
    P3.iter_cost(*P3.script_inputs(), *config, 64, counts=counts)
    n = int(counts.item())
    if config[3]:
        assert 64 // 2 <= n < 64
    else:
        assert n == 64


def test_wrappers_reject_what_the_kernels_do_not_take():
    ins = P3.script_inputs()
    with pytest.raises(ValueError, match="configurations"):
        P3.iter_cost(*ins, *P3_CASES[5], 8)
    with pytest.raises(ValueError, match="dynfori"):
        P3.iter_cost_plain(*ins, 4, True, True, True, "dynfori", 8)
    with pytest.raises(ValueError, match="unsupported device"):
        P3.iter_cost(*[x.to("meta") for x in ins], *P3.CONFIGS[0], 8)
    box, ray = P4.script_inputs()["float32"]
    with pytest.raises(ValueError, match="float16"):
        P4.bf16_vpu(box.half(), ray.half(), 8)
    with pytest.raises(ValueError, match="unsupported device"):
        P4.bf16_vpu(box.to("meta"), ray.to("meta"), 8)


def test_mains_on_cpu(capsys):
    """--device cpu runs the plain versions and prints the scripts'
    lines."""
    res3 = P3.main(["--device", "cpu", "--iters", "8"])
    res4 = P4.main(["--device", "cpu", "--iters", "8"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "device=cpu" and lines[6] == "device=cpu"
    for line, config in zip(lines[1:6], P3.CONFIGS):
        assert re.fullmatch(re.escape(P3.label(config)) + r": +[0-9.]+ ns/iter "
                            r"\( *[0-9.]+ ns per iteration run; \d+ of 8 run\)",
                            line), line
    for line, name in zip(lines[7:], P4.DTYPES):
        assert re.fullmatch(rf" *{name}: +[0-9.]+ ms \([0-9.]+ ns per "
                            r"\(16,128\) op, 11 ops per iteration, 27 "
                            r"written\)", line), line
    assert [r["config"] for r in res3] == [P3.label(c) for c in P3.CONFIGS]
    assert [r["dtype"] for r in res4] == list(P4.DTYPES)


def test_mains_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for main in (P3.main, P4.main):
        with pytest.raises(RuntimeError, match="CUDA"):
            main([])
