"""The port has no width or node-count cap that the JAX package lacks.

1. The wide problem (`simtpu_torch/smoke.py wide_problem`: a node with 40
   GPU devices, one with 36 VGs and 36 SSDs, pods that reach past index 32
   on each axis) through both packages' `simulate`: placements, reasons,
   GPU-index and node annotations and every final state plane, bit for
   bit; also with the wide node alone on each axis. Then one engine batch
   with the port's wavefront on (K9/K10's plain versions) and off (K1-K6's)
   against the JAX package's serial scan — nodes, reasons, the extended
   plans and the final planes — and `simulate(bulk=True)` (the rounds
   engine, K14-K16's plain versions) in both packages.
2. The kernels' argument blocks (`kernels/cuda.py make_ctx`, `relax_ctx`)
   built from CPU tensors at those widths and at N = 20 000 nodes: no
   refusal, the widths and K23's wide-row plan (a persistent grid of
   scratch slabs) as the kernels read them; no MAX_EXT / RELAX_MAX_ROW
   left in the wrappers or the CUDA sources.
3. A relaxation at N = 20 000 (past K23's shared-memory row): the port's
   `project_rows_plain` against the JAX `_project_rows`, and `relax_plain`
   against the JAX `_relax_kernel` (S = 2, C = 3, 3 iterations), to
   `smoke.SOLVE_Y_ATOL` / `SOLVE_RES_ATOL`.

All inputs come from numpy seeds; the JAX side runs on the CPU.
"""

import importlib

import numpy as np
import pytest
import torch

import simtpu
import simtpu_torch
from simtpu.solve import relax as jrelax
from simtpu_torch import smoke
from simtpu_torch.core.tensorize import Tensorizer
from simtpu_torch.engine import scan as tscan
from simtpu_torch.engine import state as tstate
from simtpu_torch.kernels import cuda
from simtpu_torch.solve import relax as trelax
from simtpu_torch.workloads.expand import get_valid_pods_exclude_daemonset

from .test_torch_rounds import _simulate_both
from .test_torch_simulate import assert_same_simulation
from .test_torch_wavefront import _assert_same, _place


@pytest.fixture(autouse=True)
def _numpy_twin(monkeypatch):
    monkeypatch.setenv("SIMTPU_AUDIT_JIT", "0")


def _wide(pkg, keep=None):
    synth = importlib.import_module(f"{pkg.__name__}.synth")
    cluster, apps = smoke.wide_problem(synth, pkg.AppResource, pkg.ResourceTypes)
    if keep is not None:
        cluster.nodes = [n for n in cluster.nodes if n["metadata"]["name"] not in keep]
        res = apps[0].resource
        res.deployments = [d for d in res.deployments if not d["metadata"]["name"].startswith(keep)]
    return cluster, apps


WIDE_CASES = {
    "both": lambda pkg: _wide(pkg),
    "gpu-axis": lambda pkg: _wide(pkg, ("disk-wide", "lvm-wide", "ssd-wide")),
    "storage-axes": lambda pkg: _wide(pkg, ("gpu-wide", "gpu-stack", "gpu-one", "gpu-small")),
}


@pytest.mark.parametrize("case", sorted(WIDE_CASES))
def test_wide_axes_simulate_bit_identical(case, monkeypatch):
    want, got = assert_same_simulation(WIDE_CASES[case], monkeypatch)
    assert want["placed"] and want["failed"]
    if case != "storage-axes":
        # a pod on devices past 32, and one on a device past 32 alone
        assert any(len(v.split(",")) == smoke.WIDE_VGS or "-" in v for v in want["gpu_index"].values())
        assert any(int(v) >= 32 for v in want["gpu_index"].values() if v.isdigit())
    if case != "gpu-axis":
        assert want["node_ext"]


@pytest.mark.parametrize("speculate", [True, False], ids=["wavefront-on", "wavefront-off"])
def test_wide_axes_engine_matches_the_jax_scan(speculate, monkeypatch):
    want = _place(simtpu, lambda pkg: _wide(pkg), False, True, monkeypatch)
    got = _place(simtpu_torch, lambda pkg: _wide(pkg), speculate)
    _assert_same(got, want)
    # plans past index 32 on the GPU and the storage axes
    assert (want[2]["gpu_shares"][:, 32:] > 0).any()
    assert (want[2]["lvm_alloc"][:, 32:] > 0).any() and want[2]["dev_take"][:, 32:].any()


def test_wide_axes_bulk_matches_jax():
    res = _simulate_both(lambda pkg: _wide(pkg))
    assert res.unscheduled_pods and res.node_status


def _wide_buffers():
    cluster, apps = _wide(simtpu_torch)
    pods = [pod for app in apps for pod in get_valid_pods_exclude_daemonset(app.resource)]
    tz = Tensorizer(cluster.nodes, storage_classes=list(cluster.storage_classes))
    batch = tz.add_pods(pods)
    tensors = tz.freeze()
    _, arrays = tscan.build_pod_arrays(batch, tensors.alloc.shape[1])
    statics = tscan.statics_from(tensors, None, torch.device("cpu"))
    state = tstate.build_state(tensors, np.zeros(0, np.int32), np.zeros(0, np.int32),
                               np.zeros((0, tensors.alloc.shape[1]), np.float32), None, "cpu")
    return tensors, tscan.StepBuffers(statics, state, arrays, tscan.flags_from(tensors, batch.ext))


def test_step_argument_block_takes_any_width():
    tensors, buf = _wide_buffers()
    ctx = cuda.make_ctx(buf)
    assert (ctx.v, ctx.sd, ctx.gd) == (smoke.WIDE_VGS, smoke.WIDE_VGS, smoke.WIDE_GPUS)
    assert ctx.st_fr == buf.st_fr.data_ptr() and tuple(buf.st_fr.shape) == (tensors.n_nodes, smoke.WIDE_VGS)
    wctx = cuda.make_wave_ctx(buf, 0, 2, (True, False, 0))
    assert wctx.k == tensors.node_dom.shape[0]
    assert not hasattr(cuda, "MAX_EXT") and not hasattr(cuda, "RELAX_MAX_ROW")
    for src in cuda.CSRC.glob("*.cu*"):
        text = src.read_text()
        assert "MAX_EXT" not in text and "RELAX_MAX_ROW" not in text, src.name


def _relax_inputs(seed, s, c, n, r=3):
    rng = np.random.default_rng(seed)
    feas = rng.random((c, n)) < 0.8
    valid = rng.random((s, n)) < 0.9
    cap = rng.uniform(0.5, 1.0, (n, r)).astype(np.float32)
    fixed = (cap * rng.uniform(0.0, 0.2, (n, r))).astype(np.float32)
    cnt = rng.integers(n // 4, n, c).astype(np.float32)
    req = (0.6 * cap.sum(axis=0) / cnt.sum() * rng.uniform(0.5, 1.5, (c, r))).astype(np.float32)
    lr = np.float32(0.9 / max(float(np.linalg.norm(req, 2)) ** 2, 1e-12))
    return feas, req, cnt, fixed, cap, valid, lr


@pytest.mark.parametrize("n", [20000, 100000])
def test_relax_argument_block_plans_wide_rows(n):
    s, c = 2, 3
    rb = trelax.relax_buffers(*_relax_inputs(0, s, c, n), "cpu")
    ctx = cuda.relax_ctx(rb)
    np2 = 1 << (n - 1).bit_length()
    assert (ctx.n, ctx.np2) == (n, np2) and np2 > cuda.RELAX_SHARED_ROW
    # a CPU block plans RELAX_SLABS_PER_SM slabs, at most one per row
    assert ctx.slabs == min(s * c, cuda.RELAX_SLABS_PER_SM)
    scratch = rb.cache["scratch"]
    assert scratch.numel() == ctx.slabs * np2 * 12 and ctx.scratch == scratch.data_ptr()
    small = trelax.relax_buffers(*_relax_inputs(0, s, c, 1000), "cpu")
    assert cuda.relax_ctx(small).slabs == 0 and "scratch" not in small.cache


def test_wide_projection_matches_jax():
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    rows, n = 4, 20000
    v = rng.standard_normal((rows, n)).astype(np.float32)
    v[1, 100:200] = v[1, 50]  # ties
    a = rng.uniform(1.0, 50.0, rows).astype(np.float32)
    a[2] = 0.0
    mask = rng.random((rows, n)) < 0.8
    want = np.asarray(jrelax._project_rows(jnp.asarray(v), jnp.asarray(a), jnp.asarray(mask)))
    got = trelax.project_rows_plain(torch.tensor(v), torch.tensor(a), torch.tensor(mask)).numpy()
    assert np.abs(got - want).max() <= smoke.SOLVE_Y_ATOL
    assert not got[2].any()


def test_wide_relaxation_matches_jax():
    import jax.numpy as jnp

    feas, req, cnt, fixed, cap, valid, lr = _relax_inputs(1, 2, 3, 20000)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        y, res = trelax.relax_plain(feas, req, cnt, fixed, cap, valid, lr, 3)
    finally:
        torch.set_num_threads(threads)
    y_want, res_want = jrelax._relax_kernel(3, *(jnp.asarray(x) for x in (feas, req, cnt, fixed, cap, valid)),
                                           jnp.float32(lr))
    assert np.abs(y.numpy() - np.asarray(y_want)).max() <= smoke.SOLVE_Y_ATOL
    assert np.abs(res.numpy() - np.asarray(res_want)).max() <= smoke.SOLVE_RES_ATOL
