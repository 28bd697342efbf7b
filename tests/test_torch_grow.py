"""simtpu_torch's grow mode against the JAX package's.

`Engine.enable_grow()` / `Engine.grow_nodes()` (`simtpu_torch/engine/
scan.py`) carry a dense state with bucket-padded term axes and extend it in
place as the vocabulary or the node axis grows, through K24 `grow_terms`
and K25 `grow_nodes` (`simtpu_torch/engine/state.py`). Held against the
JAX package, zero tolerance:

- the plain versions of K24/K25 (`pad_terms`, `extend_state`,
  `extend_state_nodes` on CPU tensors) bit for bit against the JAX
  `_pad_terms_kernel`, `_extend_terms_kernel` and `_extend_nodes_kernel` on
  random states: bucket promotions, `perm` with -1, `ids` with -1,
  `ti_cap = 0`;
- the host planners `grow_plan_terms` / `grow_plan_nodes` equal to the JAX
  package's;
- tests/test_grow.py's four-wave problem through the port's `RoundsEngine`
  and `Engine`: grow against compact against dense against the JAX grow
  run, placements and final planes bit-identical, extends >= 2, rebuilds 0,
  promotions >= 1 (the port's cases of `TestExtendStateBitIdentity`);
- mid-run node growth (`Tensorizer.add_clone_nodes` + `grow_nodes`) equal
  to a rebuild and to the JAX run, `node_extends` 1 (`TestNodeGrowth`);
- K7 over the padded carry (`remove_placements` / `restore_placements` on
  a grow engine) equal to the dense engine's;
- `apply --json`'s `engine.grow` keys equal to the JAX package's.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from simtpu.engine import state as jstate
from simtpu.obs.metrics import REGISTRY
from simtpu_torch.engine import state as tstate
from simtpu_torch.engine.rounds import RoundsEngine
from simtpu_torch.engine.scan import Engine
from simtpu_torch.kernels import cuda

from . import test_grow as jgrow
from .test_torch_plan import REPO
from ._threads import one_torch_thread  # noqa: F401 (autouse)


def _rand_state(rng, n: int, t: int, ti: int, r=3, v=2, sd=1, gd=4, p=2, w=3) -> dict:
    """A SchedState's fields as numpy arrays: integer-valued count planes,
    random continuous planes."""
    def cnt(*shape):
        return rng.integers(0, 5, shape).astype(np.float32)

    return {"free": rng.random((n, r)).astype(np.float32), "cnt_match": cnt(t, n), "cnt_total": cnt(t),
            "cnt_own_anti": cnt(ti, n), "cnt_own_aff": cnt(ti, n),
            "w_own_aff_pref": rng.random((ti, n)).astype(np.float32),
            "w_own_anti_pref": rng.random((ti, n)).astype(np.float32),
            "vg_free": rng.random((n, v)).astype(np.float32), "sdev_free": rng.random((n, sd)) < 0.5,
            "gpu_free": rng.random((n, gd)).astype(np.float32), "ports_used": cnt(n, p),
            "vols_any": cnt(n, w), "vols_rw": cnt(n, w)}


def _jax_state(fields):
    import jax.numpy as jnp

    return jstate.SchedState(**{k: jnp.asarray(v) for k, v in fields.items()})


def _assert_same_state(got, want):
    for name in tstate.SchedState._fields:
        a = getattr(got, name)
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = np.asarray(getattr(want, name))
        assert a.shape == b.shape and a.dtype == b.dtype, (name, a.shape, b.shape)
        assert np.array_equal(a, b), name


@pytest.mark.parametrize("t,ti,t_cap,ti_cap", [(5, 3, 8, 4), (8, 0, 8, 0), (9, 4, 16, 4), (1, 1, 1, 1)])
def test_pad_terms_plain_equals_the_jax_pad(t, ti, t_cap, ti_cap):
    fields = _rand_state(np.random.default_rng(t * 10 + ti), 12, t, ti)
    want = jstate._pad_terms_kernel(t_cap, ti_cap, _jax_state(fields))
    cuda.reset_counts()
    got = tstate.pad_terms(tstate.state_from_numpy(fields, "cpu"), t_cap, ti_cap)
    assert cuda.PLAIN_CALLS["grow_terms"] == 1 and not cuda.LAUNCHES
    _assert_same_state(got, want)


@pytest.mark.parametrize("case", ["in-bucket", "promotion", "padded-ids", "ti-cap-0", "fresh-own"])
def test_extend_state_plain_equals_the_jax_extension(case):
    rng = np.random.default_rng(len(case))
    n, t_old, ti_old = 10, 5, 3
    t_cap_old, ti_cap_old = 8, 4
    t_new, ti_new, ti_cap = {"in-bucket": (7, 3, 4), "promotion": (12, 6, 8), "padded-ids": (6, 4, 4),
                             "ti-cap-0": (6, 0, 0), "fresh-own": (8, 4, 4)}[case]
    if case in ("ti-cap-0", "fresh-own"):  # no own rows carried yet
        ti_old, ti_cap_old = 0, 0
    fields = _rand_state(rng, n, t_cap_old, ti_cap_old)
    fields["cnt_match"][t_old:] = 0
    fields["cnt_total"][t_old:] = 0
    for f in tstate.OWN_PLANES:
        fields[f][ti_old:] = 0
    m = t_new - t_old
    m_cap = tstate.snap_pow2(m)
    ids = np.full(m_cap, -1, np.int32)
    ids[:m] = np.arange(t_old, t_new)
    rows = rng.integers(0, 4, (m_cap, n)).astype(np.float32)
    tot = rng.integers(0, 9, m_cap).astype(np.float32)
    perm = np.full(ti_cap, -1, np.int32)
    if ti_old:
        perm[:ti_new] = rng.permutation(np.concatenate([np.arange(ti_old), -np.ones(max(ti_new - ti_old, 0),
                                                                                     np.int64)]))[:ti_new]
    t_cap = tstate.snap_pow2(t_new)
    plan = {"ids": ids, "rows": rows, "tot": tot, "perm": perm, "t_cap": t_cap, "ti_cap": ti_cap}
    want = jstate.extend_state(_jax_state(fields), plan)
    got = tstate.extend_state(tstate.state_from_numpy(fields, "cpu"), plan)
    _assert_same_state(got, want)


@pytest.mark.parametrize("a", [1, 2, 5])
def test_extend_state_nodes_plain_equals_the_jax_extension(a):
    rng = np.random.default_rng(a)
    n, t_cap, ti_cap = 9, 8, 4
    fields = _rand_state(rng, n, t_cap, ti_cap)
    plan = {"free": rng.random((a, 3)).astype(np.float32),
            "cnt_cols": rng.integers(0, 4, (t_cap, a)).astype(np.float32),
            "own_cols": rng.random((4, ti_cap, a)).astype(np.float32),
            "vg": rng.random((a, 2)).astype(np.float32), "sdev": rng.random((a, 1)) < 0.5,
            "gpu": rng.random((a, 4)).astype(np.float32), "n": n + a}

    class _Sizes:
        n_ports, n_vols = 2, 3

    want = jstate.extend_state_nodes(_jax_state(fields), plan, _Sizes)
    cuda.reset_counts()
    got = tstate.extend_state_nodes(tstate.state_from_numpy(fields, "cpu"), plan)
    assert cuda.PLAIN_CALLS["grow_nodes"] == 1 and not cuda.LAUNCHES
    _assert_same_state(got, want)


# ---- the four-wave problem ---------------------------------------------------


def _port_problem():
    """tests/test_grow.py's make_problem / expand_app, built with the port's
    own synth, objects and expansion."""
    from simtpu_torch import constants as C
    from simtpu_torch.api import _sort_app_pods
    from simtpu_torch.core.objects import AppResource, ResourceTypes, set_label
    from simtpu_torch.synth import make_deployment, synth_cluster
    from simtpu_torch.workloads.expand import get_valid_pods_exclude_daemonset, make_valid_pods_by_daemonset

    def app(name, deps):
        res = ResourceTypes()
        res.deployments.extend(deps)
        return AppResource(name=name, resource=res)

    host, zone = "kubernetes.io/hostname", "topology.kubernetes.io/zone"
    cluster = synth_cluster(8, seed=11, zones=3, taint_frac=0.1, gpu_frac=0.2, storage_frac=0.3)
    waves = [
        app("w0", [make_deployment("a0", 4, 250, 256),
                   make_deployment("a1", 4, 250, 256, anti_affinity_topo=host, anti_affinity_required=True),
                   make_deployment("a2", 4, 250, 256, spread_topo=zone, spread_hard=True),
                   make_deployment("a3", 3, 250, 256, anti_affinity_topo=host)]),
        app("w1", [make_deployment("b0", 3, 250, 256, anti_affinity_topo=host, anti_affinity_required=True),
                   make_deployment("b1", 3, 250, 256, affinity_topo=zone)]),
        app("w2", [make_deployment("c0", 4, 250, 256)]),
        app("w3", [make_deployment(f"d{i}", 2, 125, 128, anti_affinity_topo=host,
                                   anti_affinity_required=(i % 2 == 0), spread_topo=zone) for i in range(10)]),
    ]

    def expand(a, all_nodes):
        pods = get_valid_pods_exclude_daemonset(a.resource)
        for ds in a.resource.daemon_sets:
            pods.extend(make_valid_pods_by_daemonset(ds, all_nodes))
        for pod in pods:
            set_label(pod, C.LABEL_APP_NAME, a.name)
        return _sort_app_pods(pods)

    return cluster, waves, expand


def _port_run(cls, mode: str, node_growth: bool = False):
    """The four waves through a port engine of class `cls` on the CPU in
    `mode` (grow | compact | dense); with `node_growth`, two clones of
    node 0 join before the last wave. Returns (placements, final dense
    state, engine, tensorizer, the grow counts' delta)."""
    from simtpu_torch.parallel.sweep import assemble_planning_problem
    from simtpu_torch.plan.capacity import new_fake_nodes

    cluster, waves, expand = _port_problem()
    tz, all_nodes, _nb, ordered = assemble_planning_problem(cluster, [waves[0]], cluster.nodes[0], 0)
    eng = cls(tz, "cpu")
    if mode == "grow":
        eng.enable_grow()
    else:
        eng.compact = mode == "compact"
    before = dict(tstate.GROW_COUNTS)
    placements = [np.asarray(eng.place(tz.add_pods(ordered))[0])]
    for i, wave in enumerate(waves[1:], 1):
        if node_growth and i == 3:
            clones = new_fake_nodes(cluster.nodes[0], 2)
            tz.add_clone_nodes(clones)
            all_nodes = all_nodes + clones
            if mode == "grow":
                assert eng.grow_nodes()
        placements.append(np.asarray(eng.place(tz.add_pods(expand(wave, all_nodes)))[0]))
    state = tstate.ensure_dense(eng.carried_state(), tz.freeze())
    delta = {k: tstate.GROW_COUNTS[k] - before.get(k, 0) for k in tstate.GROW_COUNTERS}
    return placements, state, eng, tz, delta


def _assert_same_run(got, want):
    for i, (x, y) in enumerate(zip(got[0], want[0])):
        assert x.shape == y.shape and np.array_equal(x, y), i
    _assert_same_state(got[1], want[1])


@pytest.fixture(scope="module")
def jax_grow():
    before = REGISTRY.snapshot()
    run = jgrow.run_waves(True)
    return run, REGISTRY.delta_since(before)


@pytest.mark.parametrize("cls", [RoundsEngine, Engine], ids=["rounds", "serial"])
def test_grow_matches_compact_dense_and_jax(jax_grow, cls):
    (jpl, jst, _eng, _tz), jdelta = jax_grow
    grow = _port_run(cls, "grow")
    _assert_same_run(grow, (jpl, jst))
    _assert_same_run(_port_run(cls, "compact"), grow)
    _assert_same_run(_port_run(cls, "dense"), grow)
    d = grow[4]
    assert d["grow.extends"] >= 2 and d["grow.rebuilds"] == 0 and d["grow.bucket_promotions"] >= 1
    for key in ("grow.extends", "grow.bucket_promotions", "grow.rebuilds"):
        assert d[key] == jdelta.get(key, 0), key
    eng = grow[2]
    assert eng.grow and not eng.compact and not isinstance(eng.last_state, tstate.CompactState)
    assert eng.last_state.cnt_match.shape[0] == eng._grow_ref["t_cap"] > eng._grow_ref["t"]


def test_grow_plans_equal_the_jax_plans():
    """grow_plan_terms / grow_plan_nodes of the four-wave problem's final
    log against the JAX package's, on both packages' own tensors."""
    from simtpu.plan.capacity import new_fake_nodes as j_clones
    from simtpu_torch.plan.capacity import new_fake_nodes as t_clones

    _pl, _st, eng, tz, _d = _port_run(RoundsEngine, "grow")
    _jpl, _jst, jeng, jtz = jgrow.run_waves(True)
    pg, pn = np.asarray(eng.placed_group, np.int32), np.asarray(eng.placed_node, np.int32)
    assert np.array_equal(pg, np.asarray(jeng.placed_group)) and np.array_equal(pn, np.asarray(jeng.placed_node))
    t_old, ip_old = 6, np.array([1, 3], np.int64)
    got = tstate.grow_plan_terms(tz.freeze(), t_old, ip_old, pg, pn)
    want = jstate.grow_plan_terms(jtz.freeze(), t_old, ip_old, pg, pn)
    assert set(got) == set(want)
    for k in got:
        assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k
    cluster, _w, _e = _port_problem()
    tz.add_clone_nodes(t_clones(cluster.nodes[0], 2))
    jtz.add_clone_nodes(j_clones(jgrow.make_problem()[0].nodes[0], 2))
    n_old = len(cluster.nodes)
    got = tstate.grow_plan_nodes(tz.freeze(), n_old, pg, pn, 64, 32)
    want = jstate.grow_plan_nodes(jtz.freeze(), n_old, pg, pn, 64, 32)
    assert set(got) == set(want)
    for k in got:
        assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k


def test_mid_run_node_growth_bit_identical():
    base = _port_run(RoundsEngine, "dense", node_growth=True)
    grown = _port_run(RoundsEngine, "grow", node_growth=True)
    _assert_same_run(grown, base)
    assert grown[4]["grow.node_extends"] == 1 and grown[4]["grow.rebuilds"] == 0
    assert grown[2]._grow_ref["n"] == base[3].freeze().alloc.shape[0] == 10


def test_mid_run_node_growth_matches_jax():
    """The JAX package's TestNodeGrowth leg, on the same waves."""
    from simtpu.engine.rounds import RoundsEngine as JRounds
    from simtpu.engine.state import ensure_dense
    from simtpu.parallel.sweep import assemble_planning_problem
    from simtpu.plan.capacity import new_fake_nodes

    cluster, waves = jgrow.make_problem()
    tz, all_nodes, _nb, ordered = assemble_planning_problem(cluster, [waves[0]], cluster.nodes[0], 0)
    eng = JRounds(tz)
    eng.enable_grow()
    placements = [np.asarray(eng.place(tz.add_pods(ordered))[0])]
    for app in waves[1:3]:
        placements.append(np.asarray(eng.place(tz.add_pods(jgrow.expand_app(app, all_nodes)))[0]))
    clones = new_fake_nodes(cluster.nodes[0], 2)
    tz.add_clone_nodes(clones)
    assert eng.grow_nodes()
    placements.append(np.asarray(eng.place(tz.add_pods(jgrow.expand_app(waves[3], all_nodes + clones)))[0]))
    want = (placements, ensure_dense(eng.carried_state(), tz.freeze()))
    _assert_same_run(_port_run(RoundsEngine, "grow", node_growth=True), want)


def test_grow_carry_takes_signed_deltas_like_the_dense_carry():
    """K7's plain version over the bucket-padded carry: evicting and
    restoring log entries on a grow engine moves its planes exactly as on
    a dense engine, and the round trip restores them."""
    grow = _port_run(Engine, "grow")
    dense = _port_run(Engine, "dense")
    picks = [0, 3, 7, 20]
    saved_g, saved_d = grow[2].remove_placements(picks), dense[2].remove_placements(picks)
    _assert_same_state(tstate.ensure_dense(grow[2].carried_state(), grow[3].freeze()),
                       tstate.state_to_numpy(dense[2].carried_state()))
    assert not grow[2]._state_dirty and grow[2].last_state.cnt_match.shape[0] == grow[2]._grow_ref["t_cap"]
    grow[2].restore_placements(saved_g)
    dense[2].restore_placements(saved_d)
    _assert_same_state(grow[2].carried_state(), tstate.state_to_numpy(grow[1]))


def test_carried_state_is_the_exact_shape_view():
    _pl, st, eng, tz, _d = _port_run(RoundsEngine, "grow")
    view = eng.carried_state()
    ref = eng._grow_ref
    assert view.cnt_match.shape[0] == ref["t"] == tz.freeze().n_terms
    assert view.cnt_own_anti.shape[0] == ref["ti"]
    assert view.cnt_match.data_ptr() == eng.last_state.cnt_match.data_ptr()  # a view, not a copy


def test_apply_json_grow_block_keys_equal_the_jax_package(monkeypatch, capsys):
    from simtpu.cli import main as jmain
    from simtpu_torch.cli import main as tmain

    monkeypatch.setenv("SIMTPU_AUDIT_JIT", "0")
    monkeypatch.chdir(REPO)
    docs = []
    for main, extra in ((jmain, []), (tmain, ["--device", "cpu"])):
        rc = main(["apply", "-f", "examples/simtpu-config.yaml", "--json", *extra])
        docs.append((rc, json.loads(capsys.readouterr().out.strip().splitlines()[-1])))
    (rc_j, want), (rc_t, got) = docs
    assert rc_t == rc_j == 0
    assert list(got["engine"]["grow"]) == list(want["engine"]["grow"])
    assert got["engine"]["grow"] == tstate.grow_counters_doc()
    assert got["engine"]["grow"]["compile.grow"] == 0
