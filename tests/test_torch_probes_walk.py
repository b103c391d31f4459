"""The cost probes P2 (slab cost) and P1 (walk-visit ablation): each plain
version against the JAX package's Pallas probe it stands for, visit by
visit.

The probes are scripts (scripts/probe_slab_cost.py, probe_walk_cost.py),
loaded here by path with their jax.config.update calls dropped (they point
JAX's compilation cache into the repo) and run in interpret mode with
pallas_call patched and the module's ITERS set small. Their outputs show
little of the slab: every P2 variant but row0 and every P1 level but the
two with leaf trips return inf on every ray by construction. What shows it
is each visit's drained mask_s, the one value a visit hands the next: the
scripts compute it as jnp.sum with no axis (and only it), so the tests give
the loaded module a jax.numpy whose sum also records those values in visit
order (jax.debug.callback). The scripts stay as they are. The CUDA kernels
are held against the same plain versions on the card, in
tests/test_torch_cuda.py.

Tolerance: none. Outputs are bit-equal, and the drain sequences equal, on
the scripts' inputs and on a second seeded set whose drains vary from
visit to visit.

Two facts P1's CUDA kernel relies on are held here too: the slots at or
past a node's child count are dead (the kernel does not test them), and
its leaf fold, in lane order, equals group()'s fold in row order.
"""
import functools
import importlib.util
import re
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from tpu_raytracing.ops.traverse_pallas import _ffs
from tpu_raytracing_torch.native_cuda import (
    launch_counts, reset_launch_counts,
)
from tpu_raytracing_torch.probes import common
from tpu_raytracing_torch.probes import slab_cost as P2
from tpu_raytracing_torch.probes import walk_cost as P1

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
VISITS = 24
CACHE_KEYS = ("jax_compilation_cache_dir",
              "jax_persistent_cache_min_compile_time_secs")
INPUTS = {"script": "script_inputs", "varied": "varied_inputs"}


@pytest.fixture(scope="module")
def scripts():
    """The two probe scripts as modules; the JAX settings they would change
    stay as they were, and no cache directory appears."""
    before = {k: getattr(jax.config, k) for k in CACHE_KEYS}
    mods = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.config, "update", lambda *a, **k: None)
        for name in ("probe_slab_cost", "probe_walk_cost"):
            spec = importlib.util.spec_from_file_location(
                f"_script_{name}", ROOT / "scripts" / f"{name}.py")
            mods[name] = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mods[name])
    assert {k: getattr(jax.config, k) for k in CACHE_KEYS} == before
    assert not (ROOT / ".jax_cache").exists()
    return mods


@pytest.fixture
def run_pallas(monkeypatch):
    """run(module, build, *arrays) -> (output, the drains recorded in visit
    order): the module's probe in interpret mode, ITERS = VISITS, its jnp
    swapped for one whose no-axis sum records what it returns."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    drains = []

    def recording_sum(x, *args, **kwargs):
        out = jnp.sum(x, *args, **kwargs)
        if not args and kwargs.get("axis") is None:
            jax.debug.callback(lambda v: drains.append(int(v)), out,
                               ordered=False)
        return out

    hooked = types.ModuleType("jnp_recording_drains")
    hooked.__dict__.update(vars(jnp))
    hooked.sum = recording_sum

    def run(mod, build, *arrays):
        monkeypatch.setattr(mod, "jnp", hooked)
        monkeypatch.setattr(mod, "ITERS", VISITS)
        drains.clear()
        out = np.asarray(jax.jit(build)(*map(jnp.asarray, arrays)))
        jax.effects_barrier()
        return out, list(drains)

    return run


def _plain(fn, ins, case):
    """(output, drains, stats) of a plain version."""
    visits = torch.full((VISITS,), -7, dtype=torch.int32)
    out, stats = fn(*ins, case, VISITS, visits)
    n = int(stats[0])
    assert torch.all(visits[n:] == 0)
    return out.numpy(), visits[:n].tolist(), stats.tolist()


def _fold(seq):
    f = 0
    for m in seq:
        f = (f * 33 + m) & 0xFFFFFFFF
    return common.int32(f)


@pytest.mark.parametrize("inputs", list(INPUTS))
@pytest.mark.parametrize("variant", P2.VARIANTS)
def test_slab_cost_plain_vs_pallas(scripts, run_pallas, variant, inputs):
    mod = scripts["probe_slab_cost"]
    ins = getattr(P2, INPUTS[inputs])()
    nodes, o, inv, tmn, act = (x.numpy() for x in ins)
    want, drains = run_pallas(mod, mod.make(variant), nodes, *o, *inv, tmn,
                              act)
    got, seq, stats = _plain(P2.slab_cost_plain, ins, variant)
    assert want.shape == got.shape == (P2.R, P2.LANE)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert seq == drains
    assert stats == [len(seq), _fold(seq)]
    # q steps by 1 + (mask_s & 1)
    assert sum(1 + (m & 1) for m in seq[:-1]) < VISITS <= sum(
        1 + (m & 1) for m in seq)
    assert np.isfinite(want).all() == (variant == "row0")
    assert not np.isfinite(want).any() or variant == "row0"
    # the script's arithmetic on the drained mask
    if variant == "floor":
        assert all(m % P2.LANE == 0 for m in seq)
    if variant in ("cur", "hoist"):
        assert all(m % 2 == 0 for m in seq)
    if inputs == "varied":
        assert len(set(seq)) > 1
        if variant in ("row0", "mxu"):
            assert {m & 1 for m in seq} == {0, 1}


@pytest.mark.parametrize("inputs", list(INPUTS))
@pytest.mark.parametrize("level", P1.LEVELS)
def test_walk_cost_plain_vs_pallas(scripts, run_pallas, level, inputs):
    mod = scripts["probe_walk_cost"]
    ins = getattr(P1, INPUTS[inputs])()
    want, drains = run_pallas(mod, mod.make(level), *(x.numpy() for x in ins))
    got, seq, stats = _plain(P1.walk_cost_plain, ins, level)
    assert want.shape == got.shape == (P1.R, P1.LANE)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert seq == drains and len(seq) == VISITS
    assert stats == [VISITS, _fold(seq)]
    fin = np.isfinite(want)
    if level in ("inner50", "cond50"):
        assert 0.0 < fin.mean() < 1.0  # some rays hit a leaf, not all
    else:
        assert not fin.any()
    assert len(set(seq)) > 1
    if inputs == "varied":
        assert {m & 1 for m in seq} == {0, 1}


def test_second_input_sets_move_the_leaves():
    """On the varied inputs, the leaf trips change what later visits see:
    inner50's drains leave when's once t_best is finite."""
    ins = P1.varied_inputs()
    _, when, _ = _plain(P1.walk_cost_plain, ins, "when")
    _, inner, _ = _plain(P1.walk_cost_plain, ins, "inner50")
    assert when != inner
    out, _ = P1.walk_cost_plain(*ins, "inner50", VISITS)
    fin = out[torch.isfinite(out)]
    assert len(fin) and torch.all(fin < 4096 + 1e3)  # small ids: t shows


def test_ffs_equals_the_jax_package():
    """The port's _ffs against traverse_pallas.py::_ffs(m, 16) on every
    16-bit mask, m = 0 included (slot 0, low 0)."""
    m = np.arange(1 << 16, dtype=np.int32)
    slot, low = (np.asarray(x) for x in _ffs(jnp.asarray(m), 16))
    got = np.array([common.ffs16(int(x)) for x in m])
    np.testing.assert_array_equal(got[:, 0], slot)
    np.testing.assert_array_equal(got[:, 1], low)
    assert common.ffs16(0) == (0, 0)


def test_script_inputs_equal_the_scripts():
    """The mains draw the scripts' inputs bit for bit, in their order."""
    rng = np.random.default_rng(0)
    nodes = np.asarray(jnp.asarray(rng.standard_normal((1024, 128)),
                                   jnp.float32))
    rows = [np.asarray(jnp.asarray(rng.standard_normal((4, 128)), jnp.float32))
            for _ in range(6)]
    n2, o2, inv2, tmn2, act2 = P2.script_inputs()
    np.testing.assert_array_equal(n2.numpy(), nodes)
    np.testing.assert_array_equal(o2.numpy(), np.stack(rows[:3]))
    np.testing.assert_array_equal(inv2.numpy(), np.stack(rows[3:]))
    assert torch.all(tmn2 == np.float32(1e-3)) and torch.all(act2 == 1.0)
    rng = np.random.default_rng(0)
    f32 = lambda shape: np.asarray(  # noqa: E731
        jnp.asarray(rng.standard_normal(shape), jnp.float32))
    want = [f32((256, 128)), f32((256, 128)),
            np.asarray(jnp.asarray(rng.integers(0, 1 << 10, (1024, 2)),
                                   jnp.int32)),
            f32((12, 128)), f32((12, 128))]
    got = P1.script_inputs()
    for a, b in zip(got, want):
        assert a.numpy().dtype == b.dtype
        np.testing.assert_array_equal(a.numpy(), b)


def test_wrappers_run_plain_on_cpu():
    """On CPU tensors each wrapper is its plain version and counts no
    launch."""
    reset_launch_counts()
    ins = P2.varied_inputs()
    for a, b in zip(P2.slab_cost(*ins, "row0", 8),
                    P2.slab_cost_plain(*ins, "row0", 8)):
        assert torch.equal(a, b)
    ins = P1.varied_inputs()
    for a, b in zip(P1.walk_cost(*ins, "cond50", 8),
                    P1.walk_cost_plain(*ins, "cond50", 8)):
        assert torch.equal(a, b)
    assert not launch_counts()


def test_wrappers_reject_what_the_kernels_do_not_take():
    ins = P2.script_inputs()
    with pytest.raises(ValueError, match="variant"):
        P2.slab_cost(*ins, "kn3", 8)
    with pytest.raises(ValueError, match="unsupported device"):
        P2.slab_cost(*[x.to("meta") for x in ins], "cur", 8)
    ins = P1.script_inputs()
    with pytest.raises(ValueError, match="level"):
        P1.walk_cost(*ins, "inner25", 8)
    with pytest.raises(ValueError, match="unsupported device"):
        P1.walk_cost(*[x.to("meta") for x in ins], "slab", 8)


@pytest.mark.parametrize("level", P1.LEVELS)
def test_walk_cost_counts_the_work_it_needs(level):
    """walk_cost_plain's `work`: the slots below each visit's ni (8 without
    the meta table), and on the leaf levels one trip on each even visit
    whose mask is odd, its gated rays fewer than all 512."""
    ins = P1.varied_inputs()
    work = {}
    visits = torch.zeros(VISITS, dtype=torch.int32)
    P1.walk_cost_plain(*ins, level, VISITS, visits, work)
    seq = visits.tolist()
    rays = P1.R * P1.LANE
    if level == "slab":
        assert work["slab_tests"] == VISITS * 8 * rays
    else:
        assert 0 < work["slab_tests"] <= VISITS * P1.W * rays
        assert work["slab_tests"] % rays == 0
    trips = sum(1 for q, m in enumerate(seq) if q % 2 == 0 and m & 1)
    if level in ("inner50", "cond50"):
        assert work["leaf_trips"] == trips > 0
        assert 0 < work["leaf_tests"] < trips * rays * common.LG
        assert work["leaf_tests"] % common.LG == 0
    else:
        assert work["leaf_trips"] == work["leaf_tests"] == 0


def test_mains_on_cpu(capsys):
    """--device cpu runs the plain versions and prints the scripts'
    lines."""
    res2 = P2.main(["--device", "cpu", "--iters", "8"])
    res1 = P1.main(["--device", "cpu", "--iters", "8"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "device=cpu"
    assert lines[6] == "device=cpu iters=8 tiles=1 nb=16"
    for line, variant in zip(lines[1:6], P2.VARIANTS):
        assert re.fullmatch(rf"{variant} *: +[0-9.]+ ns/visit \( *[0-9.]+ ns "
                            r"per visit run; \d+ of 8 run\)", line), line
    for line, level in zip(lines[7:], P1.LEVELS):
        assert re.fullmatch(rf"{level} *: +[0-9.]+ ns/iter", line), line
    assert [r["variant"] for r in res2] == list(P2.VARIANTS)
    assert [r["level"] for r in res1] == list(P1.LEVELS)
    assert [r["visits_run"] for r in res2] == [8, 8, 8, 4, 4]


def test_mains_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for main in (P2.main, P1.main):
        with pytest.raises(RuntimeError, match="CUDA"):
            main([])


def _dead_slots_filled(ins, level):
    """The node table with the box of every slot at or above the visit's
    slot count (8 at the slab level, else min(ni, 16) from the node's meta
    row) replaced by a box that every ray of the inputs hits."""
    nodes, meta = ins[0].clone(), ins[2]
    for nid in range(P1.NODES):
        ni = 8 if level == "slab" else int(meta[nid, 0]) & 31
        for w in range(min(ni, P1.W), P1.W):
            row, s = (nid // 16) * P1.W + w, (nid % 16) * 8
            nodes[row, s:s + 3] = -1e6
            nodes[row, s + 3:s + 6] = 1e6
    return [nodes, *ins[1:]]


@pytest.mark.parametrize("inputs", list(INPUTS))
@pytest.mark.parametrize("level", P1.LEVELS)
def test_walk_cost_slots_past_ni_are_dead(scripts, run_pallas, level,
                                          inputs):
    """Only the slots below a visit's slot count reach anything the probe
    returns: with boxes that every ray hits in all the others, the script's
    Pallas probe and the plain version give the output and every visit's
    drained mask (and the plain version the stats) of the original table,
    bit for bit. So the kernel, which tests those slots only, computes what
    the script does."""
    mod = scripts["probe_walk_cost"]
    ins = getattr(P1, INPUTS[inputs])()
    filled = _dead_slots_filled(ins, level)
    want, seq, stats = _plain(P1.walk_cost_plain, ins, level)
    got, seq2, stats2 = _plain(P1.walk_cost_plain, filled, level)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert seq2 == seq and stats2 == stats
    pallas, drains = run_pallas(mod, mod.make(level),
                                *(x.numpy() for x in filled))
    np.testing.assert_array_equal(pallas.view(np.int32), want.view(np.int32))
    assert drains == seq
    # every ray hits the filled boxes: here those of the first node with
    # fewer than 16 slots
    counts = [8 if level == "slab" else int(m) & 31 for m in ins[2][:16, 0]]
    nid = next(i for i, n in enumerate(counts) if n < P1.W)
    ni, s = counts[nid], nid * 8
    box = filled[0][:P1.W, s:s + 6]
    t0, t1 = common.slab(box, ins[3].reshape(3, P1.R, P1.LANE),
                         1.0 / ins[4].reshape(3, P1.R, P1.LANE))
    hit = (t0 <= t1) & (t1 >= ins[5][:, None, :])
    assert hit[:, ni:, :].all()


def _lane_order_fold(ok, t, ids):
    """The kernel's leaf fold (probe_walk_cost.cu::leaf_trip) in plain
    PyTorch: a warp half's 16 lanes hold one ray's rows, lane j row j,
    folded as the butterfly __shfl_xor_sync(8, 4, 2, 1) folds them: fminf
    of t over the lanes, then the least id of the lanes whose accepted t
    equals it, and their count. ok, t (..., 16, LANE), ids (16,) int32.
    Returns (t, id, ties), each (..., LANE)."""
    lanes = torch.arange(common.LG)
    tg = torch.where(ok, t, float("inf"))
    for m in (8, 4, 2, 1):
        tg = torch.fmin(tg, tg[..., lanes ^ m, :])
    tie = ok & (t == tg)
    idb = ids.to(torch.int64)[:, None].expand_as(t)
    id_ = torch.where(tie, idb, (1 << 31) - 1)
    for m in (8, 4, 2, 1):
        id_ = torch.minimum(id_, id_[..., lanes ^ m, :])
    return tg[..., 0, :], id_[..., 0, :], tie.sum(dim=-2)


def _fold_matches_group(tris, o, d, t_min, t_best, best, block, shift, gate):
    """The lane-order fold's (t_best, best) against common.group's."""
    ids = tris.contiguous().view(torch.int32)
    o4, d4 = o[:, :, None, :], d[:, :, None, :]
    want_t, want_b = common.group(tris, ids, o4, d4, t_min[:, None, :], t_best,
                                  best, block, shift, gate=gate)
    *_, ok, t = common.mt_rows(tris, o4, d4, t_min[:, None, :], t_best, block,
                               shift)
    ok = ok & gate[:, None, :]
    row_ids = ids[block * common.LG:(block + 1) * common.LG,
                  (shift + 9) % common.LANE]
    tg, idw, ties = _lane_order_fold(ok, t, row_ids)
    take = tg < float("inf")
    got_b = torch.where(ties == common.LG, idw,
                        torch.clamp(idw, max=common.NO_ID)).to(torch.int32)
    got_t = torch.where(take, tg, t_best)
    got_b = torch.where(take, got_b, best)
    assert torch.equal(got_t.view(torch.int32), want_t.view(torch.int32))
    assert torch.equal(got_b, want_b)
    return int(take.sum())


@pytest.mark.parametrize("inputs", list(INPUTS))
def test_lane_order_leaf_fold_equals_group(inputs):
    """The kernel's cooperative leaf fold, in lane order, gives group()'s
    row-order fold bit for bit on each input set's leaf trips: every
    triangle group, each ray gated on its hit of the visit's slot 0."""
    nodes, tris, meta, o, d, t_min = getattr(P1, INPUTS[inputs])()
    o3 = o.reshape(3, P1.R, P1.LANE)
    d3 = d.reshape(3, P1.R, P1.LANE)
    t_best = torch.full((P1.R, P1.LANE), float("inf"))
    best = torch.full((P1.R, P1.LANE), -1, dtype=torch.int32)
    hits = 0
    for gq in range(P1.GROUPS):
        t0, t1 = common.slab(nodes[gq:gq + 1, 0:6], o3, 1.0 / d3)
        gate = ((t0 <= t1) & (t1 >= t_min[:, None, :]))[:, 0, :]
        hits += _fold_matches_group(tris, o3, d3, t_min, t_best, best,
                                    gq // 12, (gq % 12) * 10, gate)
    assert hits > 0


@pytest.mark.parametrize("high_ids", [False, True],
                         ids=["ids_below_no_id", "ids_above_no_id"])
@pytest.mark.parametrize("tied", [2, 15, 16])
def test_lane_order_leaf_fold_ties(tied, high_ids):
    """Crafted ties: `tied` rows of a block hold one triangle at t = 1
    under different ids, the others a triangle at t = 2 or one the rays
    miss; the kernel's lane-order fold gives group()'s winner, which is
    the least tied id only when all 16 rows tie (else at most NO_ID), with
    ids below and above NO_ID."""
    rng = np.random.default_rng(tied)
    tris = rng.standard_normal((common.LG, common.LANE)).astype(np.float32)
    shift = 30
    order = rng.permutation(common.LG)
    base = (1 << 30) + 5 if high_ids else 40
    ids = (base + rng.permutation(1000)[:common.LG]).astype(np.int32)
    for j, row in enumerate(order):
        z = 0.0 if j < tied else 1.0
        p0 = [-1.0, -1.0, z] if j < tied or j % 2 else [10.0, 10.0, z]
        tris[row, shift:shift + 9] = [*p0, 3.0, 0.0, 0.0, 0.0, 3.0, 0.0]
        tris[row, shift + 9] = ids[j:j + 1].view(np.float32)[0]
    tris = torch.from_numpy(tris)
    R = 2
    o = torch.zeros((3, R, common.LANE))
    o[0] = torch.from_numpy(rng.uniform(-0.5, 0.5, (R, common.LANE)))
    o[1] = torch.from_numpy(rng.uniform(-0.5, 0.5, (R, common.LANE)))
    o[2] = -1.0
    d = torch.zeros((3, R, common.LANE))
    d[2] = 1.0
    d[0, 1] = 1e-3  # row 1 slightly oblique: another t, same ties
    t_min = torch.full((R, common.LANE), 1e-3)
    t_best = torch.full((R, common.LANE), float("inf"))
    best = torch.full((R, common.LANE), -1, dtype=torch.int32)
    gate = torch.ones((R, common.LANE), dtype=torch.bool)
    gate[:, ::7] = False
    assert _fold_matches_group(tris, o, d, t_min, t_best, best, 0, shift,
                               gate) == int(gate.sum())
    _, want_b = common.group(tris, tris.view(torch.int32), o[:, :, None, :],
                             d[:, :, None, :], t_min[:, None, :], t_best,
                             best, 0, shift, gate=gate)
    least = int(ids[:tied].min())
    expect = least if tied == common.LG else min(least, common.NO_ID)
    assert torch.all(want_b[gate] == expect)
