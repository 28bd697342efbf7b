"""The port's placement auditor against the JAX package's.

- The bulk pass: `simtpu_torch.kernels.audit.audit_bulk_plain` (K8's plain
  version) against `simtpu.audit.checker._bulk_flags_numpy` on the same
  numpy inputs — a placement of the port's own (CPU) simulator, clean, with
  every optional family cut to width 0, under every mutation class of
  `simtpu/audit/fuzz.py` (`_mutation_fixture`, `_mutate_nodes`; the port's
  copy is held equal to it), and under the corruptions of what only the
  bulk pass checks (exclusive volumes, attach limits, Open-Local storage,
  GPU memory, forced and pinned entries, a node filled exactly and one
  just past it). The flag words must be equal, and each corruption must
  set its class's bit.
- `audit_placement` and `audit_simulation`: equal reports (verdict,
  counters, violation classes, rows, pods, nodes and witnesses) from both
  packages — mutated placements, the preempting cases of
  tests/test_preemption.py, and an injected divergence.

The JAX side runs its numpy twin (`SIMTPU_AUDIT_JIT=0`, set per test).
"""

import dataclasses

import numpy as np
import pytest
import torch

import simtpu
import simtpu.audit.checker as jchecker
import simtpu.audit.fuzz as jfuzz
import simtpu_torch
from simtpu_torch.api import Simulator
from simtpu_torch.audit import checker, fuzz
from simtpu_torch.kernels import audit as kaudit
from simtpu_torch.kernels import cuda

from .test_torch_preemption import CASES as PREEMPT_CASES
from .test_torch_simulate import _demo
from ._threads import one_torch_thread  # noqa: F401 (autouse)

CPU = simtpu_torch.device.resolve_device("cpu")
BIT = {kind: i for i, kind in enumerate(kaudit.BULK_BITS)}
#: the flag bit each corruption must set
EXPECT_BIT = {
    "volume-conflict": BIT["volume-conflict"],
    "read-only-conflict": BIT["volume-conflict"],
    "attach-limit": BIT["attach-limit"],
    "storage-space": BIT["storage"],
    "device-double-take": BIT["storage"],
    "gpu": BIT["gpu"],
    "forced-elsewhere": BIT["invalid-node"],
    "forced-overcommit": BIT["overcommit"],
    "pin-missing": BIT["invalid-node"],
    "pin-elsewhere": BIT["invalid-node"],
    "just-past-fill": BIT["overcommit"],
    "invalid-node": BIT["invalid-node"],
    "overcommit": BIT["overcommit"],
    "port-conflict": BIT["port-conflict"],
}
NODE_MUTATIONS = tuple(k for k in fuzz.MUTATION_CLASSES if k != "illegal-eviction")


@pytest.fixture(autouse=True)
def _numpy_twin(monkeypatch):
    monkeypatch.setenv("SIMTPU_AUDIT_JIT", "0")


def _placed(cluster, apps):
    """(tensors, entries) of the port's serial simulator on the CPU."""
    sim = Simulator(device="cpu")
    sim.run_cluster(cluster)
    for app in apps:
        sim.schedule_app(app)
    return checker.simulation_entries(sim)


@pytest.fixture(scope="module")
def placements():
    simtpu_torch.workloads.expand.seed_name_hashes(5)
    try:
        return {"mut": _placed(*fuzz._mutation_fixture()), "bulk": _placed(*fuzz.bulk_fixture())}
    finally:
        simtpu_torch.workloads.expand.seed_name_hashes(None)


def _both(tensors, e):
    nv = np.ones(tensors.alloc.shape[0], bool)
    cuda.reset_counts()
    got = checker.bulk_flags(tensors, e, nv, CPU)
    assert cuda.PLAIN_CALLS["audit_bulk"] == 1 and not cuda.LAUNCHES
    want = jchecker._bulk_flags_numpy(tensors, e, nv)
    np.testing.assert_array_equal(got, want)
    return want


def _bulk_cases():
    cases = [(fx, "clean") for fx in ("mut", "bulk")] + [(fx, "zero-widths") for fx in ("mut", "bulk")]
    cases += [("mut", k) for k in NODE_MUTATIONS]
    cases += [("bulk", k) for k in ("overcommit", "port-conflict")]
    cases += [("bulk", k) for k in fuzz.BULK_CORRUPTIONS]
    cases += [("mut", k) for k in ("forced-elsewhere", "forced-overcommit", "pin-missing",
                                   "pin-elsewhere", "exact-fill", "just-past-fill")]
    # skewed logs: every entry on one node; most nodes empty
    cases += [(fx, k) for fx in ("mut", "bulk") for k in ("one-node", "most-empty")]
    return cases


@pytest.mark.parametrize("fixture,kind", _bulk_cases())
def test_bulk_plain_flags_equal_the_numpy_twin(placements, fixture, kind):
    tensors, e = placements[fixture]
    rng_seed = 3
    if kind == "clean":
        inputs = (tensors, e)
    elif kind == "zero-widths":
        inputs = fuzz.zero_widths(tensors, e)
        x = checker._upload(*inputs, np.ones(tensors.alloc.shape[0], bool), CPU)
        assert x.ports.shape[1] == x.vol_rw.shape[1] == x.vol_class_mask.shape[0] == 0
        assert x.vg_avail0.shape[1] == x.sdev_free0.shape[1] == x.gpu_total.shape[1] == 0
    elif kind == "one-node":
        inputs = (tensors, dataclasses.replace(e, n=np.full_like(e.n, e.n[len(e.n) // 2])))
    elif kind == "most-empty":
        last = tensors.alloc.shape[0] - 1
        inputs = (tensors, dataclasses.replace(e, n=np.where(e.n % 2 == 0, 0, last).astype(e.n.dtype)))
    elif kind in NODE_MUTATIONS:
        mut = fuzz.mutate_entries(kind, tensors, e, np.random.default_rng(rng_seed))
        ref = jfuzz._mutate_nodes(kind, tensors, fuzz.entries_as_batch(e), e.n,
                                  np.random.default_rng(rng_seed))
        assert mut is not None and ref is not None, kind
        np.testing.assert_array_equal(mut.n, ref)  # the port's copy mutates alike
        inputs = (tensors, mut)
    else:
        inputs = fuzz.corrupt(kind, tensors, e, np.random.default_rng(rng_seed))
        assert inputs is not None, kind
    flags = _both(*inputs)
    if kind in ("clean", "zero-widths", "exact-fill"):
        assert not flags.any()
    elif kind in EXPECT_BIT:
        assert (flags >> EXPECT_BIT[kind] & 1).any(), (kind, flags[flags != 0])


def test_exact_fill_sits_on_the_boundary(placements):
    """The exact fill leaves the entry's free cpu equal to its request (not
    flagged); one unit more is flagged — in both forms of the prefix sum."""
    from simtpu_torch.core.tensorize import RES_CPU

    tensors, e = placements["mut"]
    t1, e1 = fuzz.corrupt("exact-fill", tensors, e, np.random.default_rng(0))
    j = int(np.flatnonzero(e1.req[:, RES_CPU] != e.req[:, RES_CPU])[0])
    before = (np.arange(len(e.n)) < j) & (e1.n == e1.n[j])
    free = float(np.asarray(tensors.alloc, np.float64)[e1.n[j], RES_CPU]) - e1.req[before, RES_CPU].sum()
    assert e1.req[j, RES_CPU] == free
    assert not _both(t1, e1)[j]
    _, e2 = fuzz.corrupt("just-past-fill", tensors, e, np.random.default_rng(0))
    assert _both(tensors, e2)[j] == 1 << BIT["overcommit"]


def test_no_entries(placements):
    tensors, e = placements["bulk"]
    empty = dataclasses.replace(e, g=e.g[:0], n=e.n[:0], req=e.req[:0], forced=e.forced[:0],
                                pin=e.pin[:0], lvm=e.lvm[:0], sdev=e.sdev[:0], gpu=e.gpu[:0],
                                rows=e.rows[:0], names=[])
    assert _both(tensors, empty).shape == (0,)


def _report(rep):
    """An AuditReport without its timings and mode."""
    return {
        "ok": rep.ok, "checked": rep.checked, "total": rep.total, "by_class": rep.by_class,
        "violations": [(v.kind, v.row, v.pod, v.node, v.node_name,
                        {k: str(w) for k, w in v.witness.items()}) for v in rep.violations],
    }


@pytest.mark.parametrize("kind", ["clean", *NODE_MUTATIONS, "volume-conflict", "storage-space",
                                  "pin-missing", "just-past-fill"])
def test_audit_placement_reports_equal(placements, kind):
    """The whole pass — bulk flags, witnesses and the host interpod/spread
    checks — gives the JAX package's report on the same entries."""
    fixture = "bulk" if kind in ("volume-conflict", "storage-space") else "mut"
    tensors, e = placements[fixture]
    rng = np.random.default_rng(4)
    if kind in NODE_MUTATIONS:
        e = fuzz.mutate_entries(kind, tensors, e, rng)
    elif kind != "clean":
        tensors, e = fuzz.corrupt(kind, tensors, e, rng)
    got = checker.audit_placement(tensors, None, e.n, entries=e, device="cpu")
    want = jchecker.audit_placement(tensors, None, e.n, entries=e, jit=False)
    assert got.mode == "plain" and set(got.split) == {"upload", "bulk", "host"}
    assert _report(got) == _report(want)
    assert got.ok == (kind == "clean")


def _audited(pkg, build, inject=False):
    cluster, apps = build(pkg)[:2]
    pkg.workloads.expand.seed_name_hashes(17)
    try:
        if pkg is simtpu:
            return simtpu.simulate(cluster, apps, audit=True, _audit_inject=inject)
        return simtpu_torch.simulate(cluster, apps, audit=True, _audit_inject=inject, device="cpu")
    finally:
        pkg.workloads.expand.seed_name_hashes(None)


AUDIT_CASES = {
    "at-scale-serial": PREEMPT_CASES["at-scale-serial"],
    "gpu-share-preemption": PREEMPT_CASES["gpu-share-preemption"],
    "open-local-preemption": PREEMPT_CASES["open-local-preemption"],
    "pdb-flips-the-chosen-victim-node": PREEMPT_CASES["pdb-flips-the-chosen-victim-node"],
    "demo": _demo,
}


@pytest.mark.parametrize("inject", [False, True], ids=["clean", "injected"])
@pytest.mark.parametrize("case", sorted(AUDIT_CASES))
def test_audit_simulation_reports_equal(case, inject):
    want = _audited(simtpu, AUDIT_CASES[case], inject).audit
    got = _audited(simtpu_torch, AUDIT_CASES[case], inject).audit
    assert want.mode == "numpy" and got.mode == "plain"
    assert _report(got) == _report(want)
    if not inject:
        assert got.ok
    elif case in ("at-scale-serial", "demo"):
        # (the injection needs a node the pod's group rejects or a second
        # soft placement to stack; the small cases may have neither)
        assert not got.ok
    c_got, c_want = got.counters(), want.counters()
    for doc in (c_got, c_want):
        del doc["wall_s"], doc["mode"]
    assert c_got == c_want


def test_audit_catches_forged_preemption_records():
    """Preemption legality: a forged priority inversion and a victim
    reported evicted but still placed, reported alike by both packages."""
    reps = []
    for pkg in (simtpu, simtpu_torch):
        cluster, apps = PREEMPT_CASES["high-priority-preempts-lower"](pkg)
        sim = pkg.Simulator() if pkg is simtpu else pkg.Simulator(device="cpu")
        pkg.workloads.expand.seed_name_hashes(17)
        sim.run_cluster(cluster)
        pkg.workloads.expand.seed_name_hashes(None)
        assert sim._preempted
        sim._preempted[0].pod["spec"]["priority"] = 5000
        sim._preempted.append(type(sim._preempted[0])(
            pod=sim._scheduled[0], preempted_by=sim._preempted[0].preempted_by, node=""))
        mod = jchecker if pkg is simtpu else checker
        reps.append(mod.audit_simulation(sim))
        sim.close()
    want, got = reps
    assert not got.ok and set(got.by_class) == {"preemption"} and got.total >= 2
    assert _report(got) == _report(want)
