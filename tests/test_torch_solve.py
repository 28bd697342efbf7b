"""simtpu_torch's global-solver backend against the JAX package's.

`simtpu_torch/solve` (the relaxation, its plain K22/K23 versions, the
rounding, the planner surface) and its users — `plan_capacity(solver=)`,
`plan_capacity_incremental(solver=)`, `plan_resilience(solver=)` and
`--solver/--no-solver` on `apply` — held against the JAX package on the
same inputs:

- the plain relaxation (`relax_plain` through `relax_candidates` on the
  CPU) against the JAX `relax_candidates` on seeded problems with a stuck
  class and zero-count rows, at 50 and 400 iterations: y to
  `smoke.SOLVE_Y_ATOL`, the residual to `smoke.SOLVE_RES_ATOL` (absolute,
  scaled units), and the feasible sets (residual <= RESIDUAL_TOL) equal;
- `project_rows_plain` against `_project_rows` (ties, all-masked rows,
  a = 0) to 1e-6;
- `build_relax_problem` field for field; `round_candidate` /
  `nodes_from_counts` on the JAX package's y;
- the zero extras: the port's audit of a rounded solver candidate equals
  the JAX audit with [P, GD] extras, and the JAX audit with its own [P]
  extras where those run (no GPU devices; with GPU devices the JAX audit
  twin refuses its [M, M] broadcast);
- every case of tests/test_solve.py with a counterpart, port against JAX:
  the exact minimum (3) with its certificate, the infeasible spec proven,
  the rounding ties and repair, the facade / incremental / resilience
  planners, the injected-audit `accepted_fallback`, preemption honesty,
  and `apply --solver --json` / `--no-solver` (solve records equal apart
  from `wall_s`).

Two cases of tests/test_solve.py have no counterpart: the compile budget
(`TestSolveCompileBudget`: the port has no per-shape executables, ROADMAP
queue 1 #10) and the `SIMTPU_SOLVER` default (the port reads no
environment switch; `solver=None` is off). The JAX side runs its
auditor's numpy twin (`SIMTPU_AUDIT_JIT=0`); its injected divergence is
`SIMTPU_AUDIT_INJECT=1`, the port's the planners' `_audit_inject`.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import simtpu
import simtpu_torch
import simtpu_torch.plan.capacity as tcap
from simtpu.plan.capacity import plan_capacity as j_plan_capacity
from simtpu.plan.incremental import plan_capacity_incremental as j_incremental
from simtpu.plan.resilience import plan_resilience as j_resilience
from simtpu.solve import planner as jplanner
from simtpu.solve import relax as jrelax
from simtpu.solve import rounding as jrounding
from simtpu_torch import smoke
from simtpu_torch.kernels import cuda
from simtpu_torch.plan.incremental import plan_capacity_incremental as t_incremental
from simtpu_torch.plan.resilience import plan_resilience as t_resilience
from simtpu_torch.solve import planner as tplanner
from simtpu_torch.solve import relax as trelax
from simtpu_torch.solve import rounding as trounding

from .fixtures import make_fake_deployment, make_fake_node
from .test_torch_plan import REPO


@pytest.fixture(autouse=True)
def _numpy_twin(monkeypatch):
    monkeypatch.setenv("SIMTPU_AUDIT_JIT", "0")


@pytest.fixture(autouse=True)
def _one_thread():
    # the plain relaxation is hundreds of small ops per iteration: on a
    # shared CPU, intra-op threads cost more than they give
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _small_plan_problem(pkg, replicas=7, cpu="2", memory="4Gi"):
    """tests/test_solve.py's problem: 1×(4cpu,8Gi) base + N×(2cpu,4Gi)
    pods + a (4cpu,8Gi) template (min clones = 3 at N=7)."""
    cluster = pkg.ResourceTypes()
    cluster.nodes = [make_fake_node("base-1", "4", "8Gi")]
    dep = make_fake_deployment("web", "default", replicas, cpu, memory)
    apps = [pkg.AppResource(name="app", resource=pkg.ResourceTypes(deployments=[dep]))]
    return cluster, apps, make_fake_node("template", "4", "8Gi")


def _assembled(pkg, cluster, apps, template, max_new=7):
    """(tz, tensors, batch, valid_s, all_nodes, n_base) of a package's
    planning problem."""
    from importlib import import_module

    sweep = import_module(f"{pkg.__name__}.parallel.sweep")
    tz, all_nodes, n_base, ordered = sweep.assemble_planning_problem(cluster, apps, template, max_new, ())
    batch = tz.add_pods(ordered)
    tensors = tz.freeze()
    clone_idx = np.arange(len(all_nodes)) - n_base
    cands = np.arange(max_new + 1)
    valid_s = (clone_idx[None, :] < cands[:, None]) | (clone_idx[None, :] < 0)
    return tz, tensors, batch, valid_s, all_nodes, n_base


def _both(build, fn):
    """fn(pkg, *build(pkg)) for the JAX package then the port, pod names
    seeded alike."""
    out = []
    for pkg in (simtpu, simtpu_torch):
        pkg.workloads.expand.seed_name_hashes(11)
        try:
            out.append(fn(pkg, *build(pkg)))
        finally:
            pkg.workloads.expand.seed_name_hashes(None)
    return out


def _solve_doc(doc: dict) -> dict:
    return {k: v for k, v in doc.items() if k != "wall_s"}


# ---- the relaxation ----------------------------------------------------------


def _random_problem(seed: int):
    """A seeded RelaxProblem-shaped statement (S 4-8, C 3-6, N 16-64, R
    2-4) with one stuck class (feasible only on nodes some candidates drop)
    and one zero-count class."""
    rng = np.random.default_rng(seed)
    s, c, n, r = int(rng.integers(4, 9)), int(rng.integers(3, 7)), int(rng.integers(16, 65)), int(rng.integers(2, 5))
    feas = rng.random((c, n)) < 0.6
    feas[0] = False
    feas[0, :2] = True  # class 0 lives on nodes 0-1 only
    req = (rng.random((c, r)) * 0.4 / c).astype(np.float32)
    cnt = rng.integers(1, 3 * n // c + 2, c).astype(np.float32)
    cnt[1] = 0.0
    cap = (0.5 + rng.random((n, r))).astype(np.float32)
    fixed = (rng.random((n, r)) * 0.2).astype(np.float32)
    valid = rng.random((s, n)) < 0.75
    valid[0, :2] = False  # candidate 0 strands class 0
    valid[1:, 0] = True
    lr = 0.9 / max(float(np.linalg.norm(req, 2)) ** 2, 1e-12)
    prob = trelax.RelaxProblem(
        cls_rows=[np.arange(int(x)) for x in cnt], cls_group=np.arange(c, dtype=np.int32), cnt=cnt, req=req,
        req_raw=req.astype(np.float64), feas=feas, fixed=fixed, fixed_raw=fixed.astype(np.float64), cap=cap,
        cap_raw=cap.astype(np.float64), scale=np.ones(r), lr=lr, pinned_rows=np.zeros(0, np.int64))
    return prob, valid


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("iters", [50, 400])
def test_relax_plain_equals_the_jax_relaxation(seed, iters):
    prob, valid = _random_problem(seed)
    want = jrelax.relax_candidates(jrelax.RelaxProblem(*prob), valid, iters)
    cuda.reset_counts()
    got = trelax.relax_candidates(prob, valid, iters, device="cpu")
    assert not cuda.LAUNCHES
    assert cuda.PLAIN_CALLS["relax_load"] == iters + 1 and cuda.PLAIN_CALLS["relax_project"] == iters + 1
    s, c, n = got.y_s.shape
    assert got.bucket == (s, c, n, prob.cap.shape[1]) and (got.c, got.n) == (want.c, want.n)
    y_want = np.asarray(want.y_s)[:s, :c, :n]
    assert np.abs(got.y_s.numpy() - y_want).max() <= smoke.SOLVE_Y_ATOL
    inf_w, inf_g = np.isinf(want.residual), np.isinf(got.residual)
    assert inf_w[0] and (inf_w == inf_g).all()
    assert np.abs(got.residual[~inf_g] - want.residual[~inf_w]).max() <= smoke.SOLVE_RES_ATOL
    assert ((got.residual <= trelax.RESIDUAL_TOL) == (want.residual <= jrelax.RESIDUAL_TOL)).all()
    for k in range(s):
        assert np.array_equal(trelax.fetch_y(got, k).shape, jrelax.fetch_y(want, k).shape)
    y, res = trelax.relax_plain(prob.feas, prob.req, prob.cnt, prob.fixed, prob.cap, valid, prob.lr, iters)
    assert torch.equal(y, got.y_s) and np.array_equal(res.numpy(), got.residual)


@pytest.mark.parametrize("n", [24, 1024, 1025])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_project_rows_plain_equals_the_jax_projection(seed, n):
    """Also at K23's launch-plan boundary (1024 / 1025 nodes), with -0.0
    beside +0.0 in one row and long runs of ties."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    rows = 9
    v = rng.standard_normal((rows, n)).astype(np.float32)
    v[1, 3] = v[1, 5] = v[1, 7]  # ties
    v[2] = 0.25  # a whole row of ties
    v[5] = np.where(rng.random(n) < 0.5, np.float32(-0.0), np.float32(0.0))  # signed zeros
    v[5, ::5] = 0.75
    v[6] = rng.choice(np.float32([0.5, 0.25, -0.125]), n)  # long runs of ties
    a = (rng.random(rows) * 4).astype(np.float32)
    a[4] = 0.0  # a = 0
    mask = rng.random((rows, n)) < 0.6
    mask[3] = False  # all masked
    mask[2] = True
    mask[5, ::5] = True
    want = np.asarray(jrelax._project_rows(jnp.asarray(v), jnp.asarray(a), jnp.asarray(mask)))
    got = trelax.project_rows_plain(torch.tensor(v), torch.tensor(a), torch.tensor(mask)).numpy()
    assert np.abs(got - want).max() <= 1e-6
    assert not got[3].any() and not got[4].any()
    live = (a > 0) & mask.any(axis=1)
    assert np.allclose(got.sum(axis=1)[live], a[live], rtol=1e-5)


def _mixed_problem(pkg):
    """A synthetic cluster with spread, affinity and anti-affinity pods,
    DaemonSet-free, at test size."""
    from importlib import import_module

    synth = import_module(f"{pkg.__name__}.synth")
    cluster = synth.synth_cluster(24, seed=5, zones=3, taint_frac=0.1, storage_frac=0, gpu_frac=0)
    apps = synth.synth_apps(160, seed=6, zones=3, pods_per_deployment=10, selector_frac=0.3,
                            toleration_frac=0.2, anti_affinity_frac=0.2, spread_frac=0.3, storage_frac=0,
                            gpu_frac=0)
    return cluster, apps, smoke.template_node(synth)


@pytest.mark.parametrize("build", [_small_plan_problem, _mixed_problem], ids=["small", "mixed"])
def test_build_relax_problem_field_for_field(build):
    want, got = _both(build, lambda pkg, *p: _assembled(pkg, *p))
    pw = jrelax.build_relax_problem(want[1], want[2])
    pg = trelax.build_relax_problem(got[1], got[2])
    assert len(pg.cls_rows) == len(pw.cls_rows) > 0
    for a, b in zip(pg.cls_rows, pw.cls_rows):
        assert np.array_equal(a, b)
    for field in trelax.RelaxProblem._fields[1:]:
        a, b = getattr(pg, field), getattr(pw, field)
        if field == "lr":
            assert a == b
        else:
            assert a.dtype == b.dtype and np.array_equal(a, b), field
    assert np.array_equal(got[3], want[3])


def test_rounding_and_expansion_on_the_jax_y():
    want, got = _both(_mixed_problem, lambda pkg, *p: _assembled(pkg, *p, max_new=6))
    prob_j = jrelax.build_relax_problem(want[1], want[2])
    prob_t = trelax.build_relax_problem(got[1], got[2])
    verd = jrelax.relax_candidates(prob_j, want[3], 200)
    for k in range(want[3].shape[0]):
        y = jrelax.fetch_y(verd, k)
        mj, why_j = jrounding.round_candidate(prob_j, y, want[3][k])
        mt, why_t = trounding.round_candidate(prob_t, y, got[3][k])
        assert why_t == why_j
        if mj is None:
            assert mt is None
            continue
        assert np.array_equal(mt, mj)
        pin = np.asarray(want[2].pin)
        assert np.array_equal(trounding.nodes_from_counts(prob_t, pin, mt),
                              jrounding.nodes_from_counts(prob_j, pin, mj))


def _gpu_problem(gpu_frac):
    def build(pkg):
        from importlib import import_module

        synth = import_module(f"{pkg.__name__}.synth")
        cluster = synth.synth_cluster(12, seed=7, zones=2, taint_frac=0.0, storage_frac=0, gpu_frac=gpu_frac)
        dep = synth.make_deployment("web", 30, 2000, 2048)
        app = pkg.AppResource(name="app", resource=pkg.ResourceTypes(deployments=[dep]))
        return cluster, [app], smoke.template_node(synth)

    return build


@pytest.mark.parametrize("gpu_frac", [0.0, 0.5], ids=["no-gpu", "gpu"])
def test_zero_extras_of_the_engine_shape_give_the_same_audit(gpu_frac):
    """The port's solver extras carry gpu_shares [P, GD] where the JAX
    package's carry [P], which its audit broadcasts to an [M, M] array. On
    a rounded solver candidate the port's audit equals the JAX audit with
    [P, GD] extras, and — where the JAX package's own extras run at all —
    with those too: on a cluster with GPU devices (GD > 1, M != GD) the
    JAX audit twin refuses its own [M, M] array with a broadcast error."""
    from simtpu.audit.checker import audit_placement as j_audit
    from simtpu_torch.audit.checker import audit_placement as t_audit

    want, got = _both(_gpu_problem(gpu_frac), lambda pkg, *p: _assembled(pkg, *p, max_new=3))
    tensors_j, batch_j, valid_s = want[1], want[2], want[3]
    gd = tensors_j.ext.gpu_dev_total.shape[1]
    prob = jrelax.build_relax_problem(tensors_j, batch_j)
    verd = jrelax.relax_candidates(prob, valid_s, 100)
    k = int(np.flatnonzero(verd.residual <= jrelax.RESIDUAL_TOL)[0])
    m, why = jrounding.round_candidate(prob, jrelax.fetch_y(verd, k), valid_s[k])
    assert m is not None, why
    nodes = jrounding.nodes_from_counts(prob, np.asarray(batch_j.pin), m)
    nodes[(np.asarray(batch_j.pin) - want[5]) >= k] = -1
    p = len(nodes)
    ext_p = jplanner._zero_extras(tensors_j, p)
    ext_pgd = tplanner._zero_extras(got[1], p)
    assert ext_p["gpu_shares"].shape == (p,) and ext_pgd["gpu_shares"].shape == (p, gd)
    kw = dict(node_valid=valid_s[k], require_all=True, expect_mask=nodes >= 0)

    def counters(rep):
        return {k: v for k, v in rep.counters().items() if k not in ("wall_s", "mode")}

    port = counters(t_audit(got[1], got[2], nodes, ext_pgd, device="cpu", **kw))
    assert port == counters(j_audit(tensors_j, batch_j, nodes, ext_pgd, **kw))
    if gd > 1:
        with pytest.raises(ValueError, match="broadcast"):
            j_audit(tensors_j, batch_j, nodes, ext_p, **kw)
    else:
        assert port == counters(j_audit(tensors_j, batch_j, nodes, ext_p, **kw))


# ---- tests/test_solve.py, port against JAX -------------------------------------


def test_relaxation_finds_the_exact_minimum_with_its_certificate():
    want, got = _both(_small_plan_problem, lambda pkg, *p: _assembled(pkg, *p))
    prob_j = jrelax.build_relax_problem(want[1], want[2])
    prob_t = trelax.build_relax_problem(got[1], got[2])
    vj = jrelax.relax_candidates(prob_j, want[3])
    vt = trelax.relax_candidates(prob_t, got[3], device="cpu")
    fj = np.flatnonzero(vj.residual <= jrelax.RESIDUAL_TOL)
    ft = np.flatnonzero(vt.residual <= trelax.RESIDUAL_TOL)
    assert np.array_equal(ft, fj) and int(ft[0]) == 3
    for k, proven in ((2, True), (3, False)):
        assert trelax.infeasibility_certificate(prob_t, trelax.fetch_y(vt, k), got[3][k]) is proven
        assert jrelax.infeasibility_certificate(prob_j, jrelax.fetch_y(vj, k), want[3][k]) is proven


def test_infeasible_spec_is_proven_not_rounded():
    def run(pkg, cluster, apps, template):
        if pkg is simtpu:
            return j_plan_capacity(cluster, apps, template, 4, solver=True)
        return tcap.plan_capacity(cluster, apps, template, 4, solver=True, device="cpu")

    want, got = _both(lambda pkg: _small_plan_problem(pkg, replicas=2, cpu="16"), run)
    assert not got.success and got.solve["status"] == "infeasible"
    assert got.solve["lower_bound"] == 4 and "k" not in got.solve
    assert _solve_doc(got.solve) == _solve_doc(want.solve)
    assert (got.message, got.nodes_added, got.probes) == (want.message, want.nodes_added, want.probes)


def _toy_problem(mod, cap, feas, cnt=3.0, req=1.0):
    """tests/test_solve.py's single-class single-resource RelaxProblem."""
    cap = np.asarray(cap, np.float64).reshape(-1, 1)
    n = cap.shape[0]
    scale = np.maximum(cap.max(axis=0), 1e-9)
    return mod.RelaxProblem(
        cls_rows=[np.arange(int(cnt))], cls_group=np.zeros(1, np.int32), cnt=np.array([cnt], np.float32),
        req=np.array([[req]], np.float32) / scale.astype(np.float32), req_raw=np.array([[req]], np.float64),
        feas=np.asarray(feas, bool).reshape(1, n), fixed=np.zeros((n, 1), np.float32),
        fixed_raw=np.zeros((n, 1), np.float64), cap=(cap / scale).astype(np.float32), cap_raw=cap, scale=scale,
        lr=0.1, pinned_rows=np.zeros(0, np.int64))


@pytest.mark.parametrize("cap,feas,y,want", [
    ([4.0, 4.0], [True, True], [[1.5, 1.5]], [[2, 1]]),  # tie toward the lower index
    ([4.0, 4.0, 4.0], [True, True, True], [[0.5, 1.0, 1.5]], [[1, 1, 1]]),  # reversed tie
    ([2.0, 4.0], [True, True], [[3.0, 0.0]], [[2, 1]]),  # repair moves load off
    ([2.0], [True], [[3.0]], None),  # repair failure is a reason
], ids=["tie", "reversed-tie", "repair", "repair-fails"])
def test_rounding_ties_and_repair(cap, feas, y, want):
    valid = np.ones(len(cap), bool)
    mt, why_t = trounding.round_candidate(_toy_problem(trelax, cap, feas), np.array(y), valid)
    mj, why_j = jrounding.round_candidate(_toy_problem(jrelax, cap, feas), np.array(y), valid)
    assert why_t == why_j
    if want is None:
        assert mt is None and mj is None and why_t in ("repair_budget", "repair_stuck")
    else:
        assert why_t == "" and mt.tolist() == mj.tolist() == want


def _plan_both(planner_j, planner_t, build=_small_plan_problem, inject=False, **kw):
    def run(pkg, cluster, apps, template):
        if pkg is simtpu:
            return planner_j(cluster, apps, template, **kw)
        return planner_t(cluster, apps, template, device="cpu", _audit_inject=inject, **kw)

    return _both(build, run)


def _assert_same_plan(want, got):
    assert _solve_doc(got.solve) == _solve_doc(want.solve)
    assert (got.success, got.nodes_added, got.message) == (want.success, want.nodes_added, want.message)
    assert got.probes == want.probes
    for key in smoke.AUDIT_KEYS + ("fallback",):
        assert got.audit.get(key) == want.audit.get(key), key
    if want.result is not None:
        assert smoke.placement_record(got.result) == smoke.placement_record(want.result)


def test_facade_solver_matches_exact_search():
    want, got = _plan_both(j_plan_capacity, tcap.plan_capacity, max_new_nodes=8, solver=True)
    _assert_same_plan(want, got)
    assert got.success and got.nodes_added == 3 and got.solve["status"] == "accepted"
    assert got.solve["certified_lb"] is True and got.audit["ok"] is True and got.probes == {3: 0}
    exact = tcap.plan_capacity(*_small_plan_problem(simtpu_torch), 8, device="cpu")
    assert exact.nodes_added == got.nodes_added


def test_incremental_solver_matches_exact_search():
    want, got = _plan_both(j_incremental, t_incremental, max_new_nodes=8, solver=True)
    _assert_same_plan(want, got)
    assert got.success and got.solve["status"] == "accepted" and got.audit["ok"] is True
    exact = t_incremental(*_small_plan_problem(simtpu_torch), 8, device="cpu")
    assert exact.nodes_added == got.nodes_added


def test_solver_off_is_unrecorded():
    plan = tcap.plan_capacity(*_small_plan_problem(simtpu_torch), 8, solver=False, device="cpu")
    default = tcap.plan_capacity(*_small_plan_problem(simtpu_torch), 8, device="cpu")
    assert plan.success and plan.solve == {} and default.solve == {}
    assert (plan.nodes_added, plan.probes) == (default.nodes_added, default.probes)


def test_resilience_lower_bound_warm_start():
    want, got = _plan_both(j_resilience, t_resilience, k=1, max_new_nodes=10, solver=True)
    assert got.success and got.nodes_added == want.nodes_added
    assert _solve_doc(got.solve) == _solve_doc(want.solve)
    assert got.solve["mode"] == "lower_bound" and got.solve["status"] == "certified"
    assert got.solve["lower_bound"] <= got.nodes_added
    assert got.probes == want.probes
    exact = t_resilience(*_small_plan_problem(simtpu_torch), k=1, max_new_nodes=10, device="cpu")
    assert exact.nodes_added == got.nodes_added


@pytest.mark.parametrize("planner", ["facade", "incremental"])
def test_injected_audit_falls_back_to_exact(monkeypatch, planner):
    monkeypatch.setenv("SIMTPU_AUDIT_INJECT", "1")
    pair = (j_plan_capacity, tcap.plan_capacity) if planner == "facade" else (j_incremental, t_incremental)
    want, got = _plan_both(*pair, inject=True, max_new_nodes=8, solver=True)
    _assert_same_plan(want, got)
    assert got.success and got.nodes_added == 3
    assert got.solve["status"] == "accepted_fallback" and got.solve["fallback"] is True
    doc = got.audit
    assert doc["fallback"] is True and doc["violations"] >= 1 and doc["ok"] is True
    assert doc["fallback_audit"]["ok"] is True and doc["divergence"] == want.audit["divergence"]
    if planner == "facade":
        assert not got.result.unscheduled_pods
        clean = tcap.plan_capacity(*_small_plan_problem(simtpu_torch), 8, solver=True, device="cpu")
        assert clean.solve["status"] == "accepted" and clean.nodes_added == got.nodes_added


def _priority_problem(pkg):
    cluster, apps, template = _small_plan_problem(pkg)
    apps[0].resource.deployments[0]["spec"]["template"]["spec"]["priority"] = 100
    return cluster, apps, template


@pytest.mark.parametrize("build,loud", [(_priority_problem, True), (_small_plan_problem, False)],
                         ids=["priority", "clean"])
def test_preemption_honesty(capsys, build, loud):
    plan = t_incremental(*build(simtpu_torch), 8, solver=True, device="cpu")
    err = capsys.readouterr().err
    assert plan.success and plan.preemption_ignored is loud
    assert ("IGNORED" in err) is loud


def _cli_doc(pkg, argv, capsys, monkeypatch=None):
    from importlib import import_module

    monkeypatch.chdir(REPO)
    main = import_module(f"{pkg.__name__}.cli").main
    pkg.workloads.expand.seed_name_hashes(23)
    try:
        rc = main(argv + ([] if pkg is simtpu else ["--device", "cpu"]))
    finally:
        pkg.workloads.expand.seed_name_hashes(None)
    return rc, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("flag", ["--solver", "--no-solver"])
def test_apply_solver_json_records_the_backend(monkeypatch, capsys, flag):
    argv = ["apply", "-f", "examples/simtpu-config.yaml", "--json", flag]
    rc_j, want = _cli_doc(simtpu, argv, capsys, monkeypatch)
    rc_t, got = _cli_doc(simtpu_torch, argv, capsys, monkeypatch)
    assert rc_t == rc_j == 0
    assert smoke.solve_doc_record(got) == {**smoke.solve_doc_record(want),
                                           "engine": {**smoke.solve_doc_record(want)["engine"],
                                                      "grow": got["engine"]["grow"]}}
    assert set(got["engine"]["grow"]) == set(want["engine"]["grow"])
    if flag == "--solver":
        assert got["engine"]["solve"]["status"] == "accepted" and got["engine"]["solve"]["certified_lb"] is True
        assert got["engine"]["audit"]["ok"] is True
    else:
        assert got["engine"]["solve"] == {"enabled": False} and got["engine"]["preemption_ignored"] is False


def test_injected_divergence_solver_fallback_exit_4(monkeypatch, capsys):
    from simtpu_torch.cli import EXIT_AUDIT

    argv = ["apply", "-f", "examples/simtpu-config.yaml", "--json", "--solver"]
    monkeypatch.setenv("SIMTPU_AUDIT_INJECT", "1")
    rc_j, want = _cli_doc(simtpu, argv, capsys, monkeypatch)
    plan0 = tcap.plan_capacity
    monkeypatch.setattr(tcap, "plan_capacity", lambda *a, **kw: plan0(*a, _audit_inject=True, **kw))
    rc_t, got = _cli_doc(simtpu_torch, argv, capsys, monkeypatch)
    assert rc_t == rc_j == EXIT_AUDIT == 4 and got["success"] is True
    assert got["engine"]["solve"]["status"] == "accepted_fallback"
    assert got["engine"]["audit"]["fallback"] is True and got["engine"]["audit"]["fallback_audit"]["ok"] is True
    assert smoke.solve_doc_record(got)["engine"]["solve"] == smoke.solve_doc_record(want)["engine"]["solve"]
    assert smoke.solve_doc_record(got)["engine"]["audit"] == smoke.solve_doc_record(want)["engine"]["audit"]
