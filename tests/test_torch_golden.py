"""The golden records of the smoke problems (simtpu_torch/smoke.py).

`compute_golden()` runs the JAX package's `simtpu.simulate` on the CPU at
the smoke shape (1000 nodes × 10 000 pods) and returns its placement
record; `compute_extended_golden()` does the same for the extended problem
(Open-Local storage, GPU-share and a priority tier that preempts).
`tests/data/torch_serial_smoke.json.gz` and
`tests/data/torch_extended_smoke.json.gz` are those records, which
`chip_smoke.py` holds the port's on-card runs against. Regenerate both with
`JAX_PLATFORMS=cpu SIMTPU_WAVEFRONT=0 python tests/test_torch_golden.py --write`.

A full recompute takes tens of seconds on the CPU, so it is marked slow;
the fast tier checks the committed files' shape.
"""

import sys

import pytest

from simtpu_torch import smoke


def _record(problem) -> dict:
    import simtpu
    from simtpu.workloads.expand import seed_name_hashes

    seed_name_hashes(smoke.NAME_SEED)
    try:
        return smoke.placement_record(simtpu.simulate(*problem))
    finally:
        seed_name_hashes(None)


def compute_golden() -> dict:
    from simtpu.synth import synth_apps, synth_cluster

    return _record(smoke.smoke_problem(synth_cluster, synth_apps))


def compute_extended_golden() -> dict:
    import simtpu
    from simtpu import synth

    return _record(smoke.extended_problem(synth, simtpu.AppResource, simtpu.ResourceTypes))


def test_committed_golden_is_whole():
    golden = smoke.load_record()
    assert len(golden["nodes"]) == smoke.N_NODES
    assert len(golden["placed"]) + len(golden["failed"]) == smoke.N_PODS
    assert all(0 <= i < smoke.N_NODES for i in golden["placed"].values())
    assert golden["preempted"] == [] and golden["gpu_index"] == {} and golden["node_ext"] == {}


def test_committed_extended_golden_is_whole():
    golden = smoke.load_record(smoke.EXT_GOLDEN)
    n_tier = sum(replicas for _, replicas, _ in smoke.EXT_TIER)
    assert len(golden["nodes"]) == smoke.N_NODES
    assert len(golden["placed"]) + len(golden["failed"]) + len(golden["preempted"]) == (
        smoke.N_PODS + n_tier
    )
    assert len(golden["preempted"]) >= 50
    assert sum("/tier-" in k for k in golden["placed"]) == n_tier
    assert golden["gpu_index"] and golden["node_ext"]
    assert set(golden["gpu_index"]) <= set(golden["placed"])


@pytest.mark.slow
def test_golden_matches_a_fresh_jax_run():
    assert smoke.record_differences(compute_golden(), smoke.load_record()) == []


@pytest.mark.slow
def test_extended_golden_matches_a_fresh_jax_run():
    want = smoke.load_record(smoke.EXT_GOLDEN)
    assert smoke.record_differences(compute_extended_golden(), want) == []


if __name__ == "__main__" and "--write" in sys.argv:
    smoke.save_record(compute_golden())
    smoke.save_record(compute_extended_golden(), smoke.EXT_GOLDEN)
    print("wrote", smoke.GOLDEN, smoke.EXT_GOLDEN)
