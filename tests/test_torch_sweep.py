"""simtpu_torch's batched capacity sweep against the JAX package's.

`simtpu_torch/parallel/sweep.py` (`sweep_feasibility`,
`plan_capacity_batched`, and `sweep_scan`: K18 `sweep_drain` with no
entries, then K19 `sweep_place` over the whole pod list per candidate
mask) is held against `simtpu/parallel/sweep.py` on the cases of
tests/test_parallel.py's TestBatchedSweep that need no mesh, and the JAX
package's compiled `_sweep_scan` against the plain K18 and K19 on the same
numpy inputs: every candidate's landing nodes, reasons and final state
planes equal.
"""

import numpy as np
import pytest

import simtpu
import simtpu_torch
from simtpu.engine import scan as jscan
from simtpu.engine import state as jstate
from simtpu.parallel import sweep as jps
from simtpu_torch import smoke
from simtpu_torch.engine import batched
from simtpu_torch.engine import scan as tscan
from simtpu_torch.engine import state as tstate
from simtpu_torch.kernels import cuda
from simtpu_torch.parallel import sweep as tps

from .test_torch_faults import _small_plan, _synth
from .test_torch_kernels import _numpy_tree, _port_flags


@pytest.fixture(autouse=True)
def _numpy_twin(monkeypatch):
    monkeypatch.setenv("SIMTPU_AUDIT_JIT", "0")


def _scenario(pkg):
    synth = _synth(pkg)
    cluster = synth.synth_cluster(11, seed=21, zones=3, taint_frac=0.2, gpu_frac=0.3, storage_frac=0.3)
    apps = synth.synth_apps(40, seed=22, zones=3, pods_per_deployment=8, selector_frac=0.3,
                            toleration_frac=0.2, anti_affinity_frac=0.4, gpu_frac=0.2,
                            storage_frac=0.2)
    template = synth.make_node("tmpl", 64000, 256, {"kubernetes.io/hostname": "tmpl"})
    return cluster, apps, template


def _seeded(pkg, fn):
    pkg.workloads.expand.seed_name_hashes(17)
    try:
        return fn()
    finally:
        pkg.workloads.expand.seed_name_hashes(None)


class TestBatchedSweep:
    @pytest.mark.parametrize("build", [_scenario, _small_plan], ids=["infeasible", "feasible"])
    def test_matches_serial_planner(self, build):
        """The port's batched planner finds the JAX batched planner's count,
        probes and winning placement, and the port's serial planner's
        count (on a problem the sweep finds feasible, and on one where it
        hands over to the serial planner)."""
        from simtpu_torch.plan.capacity import plan_capacity

        plans = []
        for pkg, fn, extra in ((simtpu, jps.plan_capacity_batched, {}),
                               (simtpu_torch, tps.plan_capacity_batched, {"device": "cpu"})):
            cluster, apps, template = build(pkg)
            plans.append(_seeded(pkg, lambda: fn(cluster, apps, template, max_new_nodes=4, **extra)))
        want, got = plans
        assert (got.success, got.nodes_added, got.message) == (want.success, want.nodes_added, want.message)
        assert got.probes == want.probes
        assert smoke.placement_record(got.result) == smoke.placement_record(want.result)
        cluster, apps, template = build(simtpu_torch)
        serial = plan_capacity(cluster, apps, template, max_new_nodes=4, device="cpu", audit=False)
        assert (got.success, got.nodes_added) == (serial.success, serial.nodes_added)
        assert got.success == (build is _small_plan)

    def test_feasibility_monotone(self):
        out = []
        for pkg, fn, extra in ((simtpu, jps.sweep_feasibility, {}),
                               (simtpu_torch, tps.sweep_feasibility, {"device": "cpu"})):
            cluster, apps, template = _scenario(pkg)
            out.append(_seeded(pkg, lambda: fn(cluster, apps, template, candidates=range(6), **extra)))
        (j_fail, j_base, _), (failures, n_base, _) = out
        assert n_base == j_base == 11
        assert np.array_equal(failures, j_fail)
        assert np.all(np.diff(failures) <= 0)

    def test_mesh_is_not_ported(self):
        cluster, apps, template = _scenario(simtpu_torch)
        with pytest.raises(NotImplementedError, match="#10"):
            tps.sweep_feasibility(cluster, apps, template, range(3), mesh=object(), device="cpu")


def _jax_inputs(candidates):
    cluster, apps, template = _scenario(simtpu)
    tz, all_nodes, n_base, ordered = jps.assemble_planning_problem(
        cluster, apps, template, max(candidates))
    batch = tz.add_pods(ordered)
    tensors = tz.freeze()
    r = tensors.alloc.shape[1]
    _, pods = jscan.build_pod_arrays(batch, r)
    state = jstate.build_state(tensors, np.zeros(0, np.int32), np.zeros(0, np.int32),
                               np.zeros((0, r), np.float32), None)
    clone = np.arange(len(all_nodes)) - n_base
    valid_s = (clone[None, :] < np.asarray(candidates)[:, None]) | (clone[None, :] < 0)
    return tensors, batch, jscan.statics_from(tensors), state, tuple(np.asarray(p) for p in pods), valid_s


def _plain_sweep_scan(statics, valid_s, state, pods, flags):
    """The plain K18 (no entries: the broadcast) then the plain K19 over
    the whole pod list per candidate; returns the SweepBuffers."""
    valid, rows, batch_buf = tps._sweep_inputs(statics, valid_s, state, pods, flags)
    reps = batched.sweep_drain_plain(statics, state, batched.empty_log_like(state), rows[:, :0].contiguous())
    sb = batched.SweepBuffers(batch_buf, pods, statics, reps, valid, rows)
    batched.sweep_place_plain(sb)
    return sb


def test_sweep_scan_plain_equals_the_jax_sweep_scan():
    """The JAX package's compiled `_sweep_scan` and the port's plain K18
    and K19 (what `sweep_scan` runs on the CPU) on the same numpy inputs:
    each candidate's landing nodes, reasons and final state planes
    equal."""
    tensors, batch, statics, state, pods, valid_s = _jax_inputs([0, 1, 3, 5])
    flags = jscan.flags_from(tensors, batch.ext)
    j_states, outs = jps._sweep_scan(statics, valid_s, state, pods, flags)
    j_nodes, j_reasons = np.asarray(outs[0]), np.asarray(outs[1])
    t_statics = tscan.statics_from_numpy(_numpy_tree(statics), "cpu")
    t_state = tstate.state_from_numpy(_numpy_tree(state), "cpu")
    sb = _plain_sweep_scan(t_statics, valid_s, t_state, pods, _port_flags(flags))
    nodes, reasons = sb.outputs()
    assert np.array_equal(nodes, j_nodes) and np.array_equal(reasons, j_reasons)
    assert (nodes < 0).any() and (nodes >= 0).any()
    for name, got, want in zip(tstate.SchedState._fields, sb.reps, _numpy_tree(j_states)):
        assert np.array_equal(got.numpy(), want), name
    # the input state is only read
    assert all(np.array_equal(a.numpy(), b) for a, b in zip(t_state, _numpy_tree(state)))


def test_sweep_scan_on_the_cpu_is_its_plain_version():
    tensors, batch, statics, state, pods, valid_s = _jax_inputs([0, 2, 4])
    t_statics = tscan.statics_from_numpy(_numpy_tree(statics), "cpu")
    t_state = tstate.state_from_numpy(_numpy_tree(state), "cpu")
    flags = _port_flags(jscan.flags_from(tensors, batch.ext))
    cuda.reset_counts()
    got = tps.sweep_scan(t_statics, valid_s, t_state, pods, flags)
    assert not cuda.LAUNCHES
    assert cuda.PLAIN_CALLS["sweep_drain"] == cuda.PLAIN_CALLS["sweep_place"] == 1
    want = _plain_sweep_scan(t_statics, valid_s, t_state, pods, flags).outputs()
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
