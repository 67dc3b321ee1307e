"""The port's vocab-sharded head on a ("data", "model") mesh of gloo ranks
on the CPU: the collectives and the sharded optimizer update, as
``tests/test_parallel.py`` and ``tests/test_state_memory.py::
TestShardedState`` check the reference's.

One world of 4 ranks computes everything once (module fixture) on two
meshes, (1, 4) and (2, 2); each test reads its part. The port's sharded
results are held against the JAX package's unsharded functions on the same
numpy inputs (``candidate_scores``, ``apply_updates`` without a mesh), and
against the port's own unsharded functions, where the per-row arithmetic
is the same, bit for bit. ``compressed_grad_allreduce`` is held against the
reference's own, run on 4 host devices in a subprocess (its mesh needs
them).

Tolerances: scores 1e-5 (the reference's test); rows and optimizer
updates 1e-5 relative + 1e-6 absolute against JAX (``TestShardedState``'s
bound; float32 in another order), exact against the port; the compressed
mean within 2% of the largest gradient (one int8 step of the shared
scale, as the reference's test), and against the reference's own to
1e-6.
"""
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

import _torch_world as W
from repro_torch import tree_util
from repro_torch.core import heads as theads
from repro_torch.optim import OptimizerConfig, apply_updates, init_opt_state
from repro_torch.optim.sparse import SparseRows
from repro_torch.parallel import merge_disjoint

N_RANKS = 4
MESHES = ("1x4", "2x2")

WORLD = """
import numpy as np
import torch
from repro_torch import tree_util
from repro_torch.core.heads import HeadParams
from repro_torch.optim import OptimizerConfig, apply_updates, init_opt_state
from repro_torch.optim.sparse import SparseRows
from repro_torch.parallel import collectives, gather_head, shard_head, sharding
from repro_torch.parallel import gather_train_state, shard_train_state
import _torch_world as W

meshes = {"1x4": mesh_of(4), "2x2": mesh_of(2)}
out = {}
w, b, h, ids = (torch.as_tensor(a) for a in W.score_inputs())
for name, mesh in meshes.items():
    lo, hi = sharding.row_range(w.shape[0], mesh)
    out["scores", name] = collectives.sharded_candidate_scores(mesh, w[lo:hi], b[lo:hi], h, ids)
    out["rows", name] = collectives.sharded_gather_rows(mesh, w[lo:hi], ids)

mesh = meshes["1x4"]
w, nu, ids, vals = (torch.as_tensor(a) for a in W.rows_inputs())


def fn(rows, vals_t):
    p, n = rows
    (g,) = vals_t
    n2 = n + g * g
    return (p - 0.1 * g / (torch.sqrt(n2) + 1e-8), n2)


w_l, nu_l = sharding.shard_rows(w, mesh), sharding.shard_rows(nu, mesh)
collectives.sharded_rows_update(mesh, fn, ids, (vals,), [w_l, nu_l])
out["rows_update"] = (sharding.gather_rows(w_l, mesh), sharding.gather_rows(nu_l, mesh))

w0, b0, steps = W.opt_inputs()
for rule, sd in W.OPT_CASES:
    cfg = OptimizerConfig(**W.opt_config(rule, sd))
    params = HeadParams(torch.as_tensor(w0), torch.as_tensor(b0))
    state = init_opt_state(cfg, params)
    params, state = shard_head(params, meshes["2x2"]), shard_head(state, meshes["2x2"])
    for s_ids, dw, db in steps:
        g = SparseRows(torch.as_tensor(s_ids), torch.as_tensor(dw), torch.as_tensor(db))
        params, state, _ = apply_updates(cfg, params, g, state, mesh=meshes["2x2"])
    out["opt", rule, sd] = (gather_head(params, meshes["2x2"]),
                           gather_head(state, meshes["2x2"]))

# The sharded state of an LM tree round-trips, SM3's column cover whole.
tree_cfg = OptimizerConfig(name="adamw", head_name="sm3", state_dtype="int8")
full = {"embed": torch.arange(32.0).reshape(8, 4), "head": {"w": torch.ones(8, 4),
        "b": torch.arange(8.0)}, "trunk": torch.ones(3)}
tree_state = init_opt_state(tree_cfg, full)
local = shard_train_state({"params": full, "opt_state": tree_state}, meshes["1x4"])
out["local_shapes"] = [tuple(x.shape) for x in tree_util.leaves(local)
                       if isinstance(x, torch.Tensor)]
out["round_trip"] = gather_train_state(local, meshes["1x4"])

ef_mesh = mesh_of(1)           # (4, 1): every rank a data replica
g = {k: torch.as_tensor(v[RANK]) for k, v in W.ef_inputs().items()}
mean, ef = collectives.compressed_grad_allreduce(
    ef_mesh, g, {k: torch.zeros_like(v) for k, v in g.items()})
out["ef"] = (mean, ef)
save(out)
"""

JAX_EF = """
import numpy as np, jax, jax.numpy as jnp
from repro.parallel import AxisType, make_mesh
from repro.parallel.collectives import compressed_grad_allreduce
sys.path.insert(0, {tests!r})
import _torch_world as W
mesh = make_mesh((4, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
g = {{k: jnp.asarray(v) for k, v in W.ef_inputs().items()}}
mean, ef = compressed_grad_allreduce(mesh, g, jax.tree.map(jnp.zeros_like, g))
np.savez({path!r}, **{{"mean_" + k: np.asarray(v) for k, v in mean.items()}},
         **{{"ef_" + k: np.asarray(v) for k, v in ef.items()}})
"""


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("collectives")
    ref_path = str(tmp / "jax_ef.npz")
    env = dict(os.environ, PYTHONPATH=os.path.join(W.ROOT, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    jax_ref = subprocess.Popen(
        [sys.executable, "-c", "import sys\n" + textwrap.dedent(JAX_EF).format(
            tests=os.path.join(W.ROOT, "tests"), path=ref_path)],
        cwd=W.ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        W.run_world(tmp, N_RANKS, WORLD)
        _, err = jax_ref.communicate(timeout=120)
    finally:
        if jax_ref.poll() is None:
            jax_ref.kill()
    assert jax_ref.returncode == 0, err[-4000:]
    return W.load_outputs(tmp, N_RANKS), dict(np.load(ref_path))


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_candidate_scores(world, mesh):
    import jax.numpy as jnp
    from repro.core.heads import HeadParams as JHeadParams
    from repro.core.heads import candidate_scores
    w, b, h, ids = W.score_inputs()
    want = candidate_scores(JHeadParams(w=jnp.asarray(w), b=jnp.asarray(b)), jnp.asarray(h),
                            jnp.asarray(ids))
    plain = theads.kernel_scores(theads.HeadParams(torch.as_tensor(w), torch.as_tensor(b)),
                                 torch.as_tensor(h), torch.as_tensor(ids))
    for out in world[0]:
        got = out["scores", mesh]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
        assert torch.equal(got, plain)


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_gather_rows_is_the_gather(world, mesh):
    w, _, _, ids = W.score_inputs()
    for out in world[0]:
        assert torch.equal(out["rows", mesh], torch.as_tensor(w)[torch.as_tensor(ids)])


def test_sharded_rows_update(world):
    """Each model rank writes only the ids it owns; the sentinel (== V)
    drops; the result equals the unsharded gather-update-scatter."""
    import jax.numpy as jnp
    w, nu, ids, vals = W.rows_inputs()
    v = w.shape[0]
    jw, jnu, jids, jvals = (jnp.asarray(a) for a in (w, nu, ids.astype(np.int32), vals))
    exp_nu = jnu.at[jids].add(jvals ** 2, mode="drop")
    safe = jnp.clip(jids, 0, v - 1)
    n2 = jnu[safe] + jvals * jvals
    exp_w = jw.at[jids].set(jw[safe] - 0.1 * jvals / (jnp.sqrt(n2) + 1e-8), mode="drop")
    live = ids < v
    t_nu = torch.as_tensor(nu).clone()
    t_w = torch.as_tensor(w).clone()
    tv, ti = torch.as_tensor(vals)[live], torch.as_tensor(ids)[live]
    tn2 = t_nu[ti] + tv * tv
    t_w[ti] = t_w[ti] - 0.1 * tv / (torch.sqrt(tn2) + 1e-8)
    t_nu[ti] = tn2
    for out in world[0]:
        got_w, got_nu = out["rows_update"]
        np.testing.assert_allclose(got_nu.numpy(), np.asarray(exp_nu), rtol=1e-6)
        np.testing.assert_allclose(got_w.numpy(), np.asarray(exp_w), rtol=1e-6)
        assert torch.equal(got_w, t_w) and torch.equal(got_nu, t_nu)


def _unsharded(rule, sd):
    """The port's and the JAX package's head after the same sparse steps
    without a mesh."""
    import jax.numpy as jnp
    from repro.core.heads import HeadParams as JHeadParams
    from repro.optim import OptimizerConfig as JOptimizerConfig
    from repro.optim import apply_updates as japply
    from repro.optim import init_opt_state as jinit
    from repro.optim.sparse import SparseRows as JSparseRows
    w0, b0, steps = W.opt_inputs()
    cfg = OptimizerConfig(**W.opt_config(rule, sd))
    params = theads.HeadParams(torch.as_tensor(w0).clone(), torch.as_tensor(b0).clone())
    state = init_opt_state(cfg, params)
    jcfg = JOptimizerConfig(**W.opt_config(rule, sd))
    jparams = JHeadParams(w=jnp.asarray(w0), b=jnp.asarray(b0))
    jstate = jinit(jcfg, jparams)
    for ids, dw, db in steps:
        g = SparseRows(torch.as_tensor(ids), torch.as_tensor(dw), torch.as_tensor(db))
        params, state, _ = apply_updates(cfg, params, g, state)
        jg = JSparseRows(ids=jnp.asarray(ids.astype(np.int32)), dw=jnp.asarray(dw),
                         db=jnp.asarray(db))
        jparams, jstate, _ = japply(jcfg, jparams, jg, jstate)
    return (params, state), jparams


@pytest.mark.parametrize("rule,state_dtype", W.OPT_CASES)
def test_sharded_apply_updates(world, rule, state_dtype):
    """apply_updates(mesh=) on a (2, 2) mesh against the unsharded update:
    SM3's column cover recombined by all_reduce MAX, AdamW's catch-up
    masked to owned rows, int8 rows quantized with their own scales."""
    (params, state), jparams = _unsharded(rule, state_dtype)
    want_leaves = tree_util.leaves((params, state))
    for out in world[0]:
        got = out["opt", rule, state_dtype]
        np.testing.assert_allclose(got[0].w.numpy(), np.asarray(jparams.w), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(got[0].b.numpy(), np.asarray(jparams.b), rtol=1e-5,
                                   atol=1e-6)
        got_leaves = tree_util.leaves(got)
        assert len(got_leaves) == len(want_leaves)
        for g, w in zip(got_leaves, want_leaves):
            if isinstance(w, torch.Tensor):
                assert torch.equal(g, w)
            else:
                assert g == w


def test_sharded_state_round_trip(world):
    """shard_train_state keeps a model rank's rows of every row-indexed
    leaf (embedding, head, int8 payload and scales, SM3's row cover, lazy
    AdamW's last) and SM3's column cover and the trunk whole;
    gather_train_state restores the full state bit for bit."""
    from repro_torch.optim import OptimizerConfig as O
    full = {"embed": torch.arange(32.0).reshape(8, 4), "head": {"w": torch.ones(8, 4),
            "b": torch.arange(8.0)}, "trunk": torch.ones(3)}
    want = {"params": full,
            "opt_state": init_opt_state(O(name="adamw", head_name="sm3", state_dtype="int8"),
                                        full)}
    shapes = [tuple(x.shape) for x in tree_util.leaves(want) if isinstance(x, torch.Tensor)]
    for out in world[0]:
        local = iter(out["local_shapes"])
        for path_shape in shapes:
            got = next(local)
            assert got == path_shape or (got[0] * 4 == path_shape[0]
                                         and got[1:] == path_shape[1:])
        back = tree_util.leaves(out["round_trip"])
        for g, w in zip(back, tree_util.leaves(want)):
            assert torch.equal(g, w) if isinstance(w, torch.Tensor) else g == w
    # The column cover (K,) and the trunk stay whole; the head's w rows shard.
    assert world[0][0]["local_shapes"].count((2, 4)) >= 2
    assert (4,) in world[0][0]["local_shapes"] and (3,) in world[0][0]["local_shapes"]


def test_compressed_grad_allreduce(world):
    """The int8 error-feedback mean over 4 data replicas: against the
    reference's own on the same inputs, near the fp32 mean, and the
    residual is what quantization dropped."""
    outs, ref = world
    g = W.ef_inputs()
    for r, out in enumerate(outs):
        mean, ef = out["ef"]
        for k, stack in g.items():
            want = stack.mean(0)
            np.testing.assert_allclose(mean[k].numpy(), want,
                                       atol=0.02 * np.abs(want).max() + 1e-6)
            np.testing.assert_allclose(mean[k].numpy(), ref["mean_" + k], rtol=1e-6,
                                       atol=1e-7)
            np.testing.assert_allclose(ef[k].numpy(), ref["ef_" + k][r], rtol=1e-6, atol=1e-7)
            amax = max(np.abs(stack[i]).max() for i in range(W.N_DP))
            scale = amax / 127.0
            q = np.clip(np.round(stack[r] / scale), -127, 127)
            np.testing.assert_allclose(ef[k].numpy(), stack[r] - q * scale, atol=1e-6)


def test_merge_disjoint_matches_jax():
    from repro.parallel.work import merge_disjoint as jmerge
    rng = np.random.default_rng(4)
    owner = rng.integers(0, 3, (6, 5))
    parts = [np.where(owner == i, rng.standard_normal((6, 5)), 0.0) for i in range(3)]
    got = merge_disjoint(parts)
    np.testing.assert_array_equal(got, jmerge(parts))
    np.testing.assert_array_equal(got, sum(parts))
    filled = [np.where(owner == i, p, -1.0) for i, p in enumerate(parts)]
    np.testing.assert_array_equal(merge_disjoint(filled, fill=-1.0), jmerge(filled, fill=-1.0))
    with pytest.raises(ValueError):
        merge_disjoint([])


def test_rank_failure_fails_the_world_within_its_timeout(tmp_path):
    """One rank raises before a collective: the other, left waiting in an
    all_reduce, fails too, well inside the mesh's timeout, instead of
    hanging."""
    body = """
    import torch.distributed as dist
    mesh = mesh_of(2)
    if RANK == 1:
        raise RuntimeError("rank 1 fails before its collective")
    x = torch.ones(3)
    dist.all_reduce(x, group=mesh.get_group("model"))
    """
    t0 = time.perf_counter()
    out, seconds = W.run_world(tmp_path, 2, body, timeout=W.MESH_TIMEOUT_S + 30, check=False)
    assert [rc != 0 for rc, _, _ in out] == [True, True], out
    assert "rank 1 fails" in out[1][2]
    assert time.perf_counter() - t0 < W.MESH_TIMEOUT_S + 20


@pytest.mark.parametrize("launcher", ["serve", "train"])
def test_model_axis_without_torchrun_raises(launcher, monkeypatch):
    for key in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    if launcher == "serve":
        from repro_torch.launch.serve import main
    else:
        from repro_torch.launch.train import main
    with pytest.raises(ValueError, match="torch.distributed.run"):
        main(["--model-axis", "2", "--device", "cpu"])


def test_mesh_must_be_a_device_mesh():
    cfg = OptimizerConfig()
    params = theads.HeadParams(torch.zeros(4, 3), torch.zeros(4))
    rows = SparseRows(torch.tensor([1]), torch.ones(1, 3), torch.ones(1))
    with pytest.raises(TypeError, match="DeviceMesh"):
        apply_updates(cfg, params, rows, init_opt_state(cfg, params), mesh=object())
