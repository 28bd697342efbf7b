"""simtpu_torch's differential fuzz harness against the JAX package's.

`simtpu_torch/audit/fuzz.py` (case generation, the engine-config matrix,
shrinking and reproducers, mutation-kill) and the `fuzz` command are held
against `simtpu/audit/fuzz.py` and `simtpu fuzz` on the CPU: the same
generated cases, the same serial-baseline landing vectors, the same
mutation-kill counters and the same exit codes. The port's matrix holds
the wavefront and compact-carry cells; the JAX package's injected-OOM and
sharded cells wait for their ports and raise where asked for.

The JAX side runs its auditor's numpy twin (`SIMTPU_AUDIT_JIT=0`).
"""

import json

import numpy as np
import pytest

import simtpu.audit.fuzz as jfuzz
import simtpu.cli as jcli
import simtpu_torch.audit.fuzz as tfuzz
import simtpu_torch.cli as tcli
from simtpu_torch import smoke
from ._threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(autouse=True)
def _numpy_twin(monkeypatch):
    monkeypatch.setenv("SIMTPU_AUDIT_JIT", "0")


def _plain(obj):
    return json.loads(json.dumps(obj))


@pytest.mark.parametrize("seed", [0, 1000, 4000])
def test_gen_case_equals_jax(seed):
    jc, ja, jmix = jfuzz.gen_case(seed, 16, 60)
    tc, ta, tmix = tfuzz.gen_case(seed, 16, 60)
    assert tmix == jmix
    assert _plain(tc.nodes) == _plain(jc.nodes)
    assert _plain(tc.storage_classes) == _plain(jc.storage_classes)
    assert [a.name for a in ta] == [a.name for a in ja]
    for x, y in zip(ta, ja):
        assert _plain(x.resource.deployments) == _plain(y.resource.deployments)


def test_engine_configs_and_refusals():
    assert [c["name"] for c in tfuzz.engine_configs()] == ["wavefront", "compact", "wavefront+compact"]
    jcells = {c["name"]: c for c in jfuzz.engine_configs(include_shard=False)}
    for cell in tfuzz.engine_configs():
        assert {k: v for k, v in jcells[cell["name"]].items()} == cell
    with pytest.raises(NotImplementedError, match="#10"):
        tfuzz.engine_configs(include_shard=True)
    cluster, apps, _ = tfuzz.gen_case(0, 8, 24)
    with pytest.raises(NotImplementedError, match="#8"):
        tfuzz._place_with(cluster, apps, {"name": "oom-backoff", "oom": 2}, "cpu")


def test_run_differential_clean_with_jax_baselines(monkeypatch):
    """Two cases through the port's matrix on the CPU: clean, 1 + 3
    configs per case; each case's serial baseline lands every pod where
    the JAX package's does."""
    baselines = []
    place = tfuzz._place_with

    def recording(cluster, apps, cfg, device=None):
        pc = place(cluster, apps, cfg, device)
        if cfg["name"] == "serial":
            baselines.append(np.asarray(pc.nodes))
        return pc

    monkeypatch.setattr(tfuzz, "_place_with", recording)
    res = tfuzz.run_differential(cases=2, n_nodes=16, n_pods=60, device="cpu")
    assert res.ok and res.counters() == {"ok": True, "cases": 2, "configs_run": 8, "audits_clean": 8,
                                         "failures": []}
    assert len(baselines) == 2
    for c, got in enumerate(baselines):
        cluster, apps, _ = jfuzz.gen_case(c * 1000, 16, 60)
        want = np.asarray(jfuzz._place_with(cluster, apps, {"name": "serial"}).nodes)
        np.testing.assert_array_equal(got, want)
        assert (want >= 0).sum() > 0


def test_mutation_kill_counters_equal_jax():
    got = tfuzz.run_mutation_kill(seed=0, per_class=4, device="cpu")
    assert got == jfuzz.run_mutation_kill(seed=0, per_class=4)
    assert got["kill_rate"] == 1.0 and not got["missed"] and got["classes"] == got["classes_total"]


def test_reproducer_round_trip_and_replay(tmp_path):
    cluster, apps, _ = tfuzz.gen_case(1000, 12, 40)
    path = tfuzz.write_reproducer(cluster, apps, str(tmp_path / "case.yaml"))
    t_cluster, t_apps = tfuzz.load_reproducer(path)
    j_cluster, j_apps = jfuzz.load_reproducer(path)
    assert _plain(t_cluster.nodes) == _plain(j_cluster.nodes)
    # the loader records each object's source file beside its fields
    assert [{k: v for k, v in n.items() if k != "__simtpu_source__"} for n in _plain(t_cluster.nodes)] == _plain(
        cluster.nodes)
    assert _plain(t_apps[0].resource.deployments) == _plain(j_apps[0].resource.deployments)
    assert len(t_apps[0].resource.deployments) == sum(len(a.resource.deployments) for a in apps)
    assert tfuzz.replay_case(path, device="cpu") is None


def _run(main, argv):
    return smoke.run_cli_json(main, argv)


@pytest.mark.parametrize("case", ["clean", "finding", "unreadable"])
def test_fuzz_exit_codes_match_jax(case, tmp_path, monkeypatch):
    """0 for a clean run, 4 for a finding (a divergence forced into both
    packages' case check), 1 when a reproducer does not load — the JAX
    CLI's codes, and the same documents."""
    path = str(tmp_path / "missing.yaml")
    argv = {"clean": ["fuzz", "--cases", "1", "--nodes", "8", "--pods", "24", "--json"],
            "finding": ["fuzz", "--cases", "1", "--nodes", "8", "--pods", "24", "--json"],
            "unreadable": ["fuzz", "--replay", path, "--json"]}[case]
    if case == "finding":
        for mod in (jfuzz, tfuzz):
            monkeypatch.setattr(mod, "_check_case",
                                lambda *a, **k: ("wavefront", "divergence", "1 divergent pod(s), first row 0"))
    jrc, jdoc = _run(jcli.main, argv + ["--no-shard"])
    trc, tdoc = _run(tcli.main, argv + ["--device", "cpu"])
    assert trc == jrc == {"clean": 0, "finding": 4, "unreadable": 1}[case]
    if case == "clean":
        assert tdoc["ok"] and tdoc["configs_run"] == 4 and jdoc["configs_run"] == 5
    elif case == "finding":
        # the JAX matrix runs one more cell (injected-OOM backoff)
        assert tdoc == {**jdoc, "configs_run": jdoc["configs_run"] - 1}
    else:
        assert tdoc["ok"] is jdoc["ok"] is False


def test_fuzz_shard_and_mutation_kill_cli(capsys):
    rc = tcli.main(["fuzz", "--shard", "--json", "--device", "cpu"])
    out, err = capsys.readouterr()
    assert rc == 1 and "ROADMAP queue 1 #10" in err and json.loads(out)["ok"] is False
    rc, doc = _run(tcli.main, ["fuzz", "--mutation-kill", "--json", "--device", "cpu"])
    assert rc == 0 and doc["ok"] and doc["kill_rate"] == 1.0
