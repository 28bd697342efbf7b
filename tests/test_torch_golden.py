"""The golden placements of the serial smoke problem (simtpu_torch/smoke.py).

`compute_golden()` runs the JAX package's `simtpu.simulate` on the CPU at
the smoke shape (1000 nodes × 10 000 pods) and returns its placement
record; `tests/data/torch_serial_smoke.json.gz` is that record, which
`chip_smoke.py` holds the port's on-card run against. Regenerate it with
`JAX_PLATFORMS=cpu SIMTPU_WAVEFRONT=0 python tests/test_torch_golden.py --write`.

The full recompute takes tens of seconds on the CPU, so it is marked slow;
the fast tier checks the committed file's shape.
"""

import sys

import pytest

from simtpu_torch import smoke


def compute_golden() -> dict:
    import simtpu
    from simtpu.synth import synth_apps, synth_cluster
    from simtpu.workloads.expand import seed_name_hashes

    cluster, apps = smoke.smoke_problem(synth_cluster, synth_apps)
    seed_name_hashes(smoke.NAME_SEED)
    try:
        return smoke.placement_record(simtpu.simulate(cluster, apps))
    finally:
        seed_name_hashes(None)


def test_committed_golden_is_whole():
    golden = smoke.load_record()
    assert len(golden["nodes"]) == smoke.N_NODES
    assert len(golden["placed"]) + len(golden["failed"]) == smoke.N_PODS
    assert all(0 <= i < smoke.N_NODES for i in golden["placed"].values())


@pytest.mark.slow
def test_golden_matches_a_fresh_jax_run():
    assert smoke.record_differences(compute_golden(), smoke.load_record()) == []


if __name__ == "__main__" and "--write" in sys.argv:
    smoke.save_record(compute_golden())
    print("wrote", smoke.GOLDEN)
