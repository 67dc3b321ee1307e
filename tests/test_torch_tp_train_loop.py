"""Training with the trunk sharded over the mesh's ``model`` axis, on a
(1, 2) mesh of gloo ranks on the CPU: three steps against one rank and
against JAX, the optimizer rules on a rank's part of the trunk, the state
built on the mesh, the loop with an asynchronous generator fit, checkpoints
across meshes, and the training launcher under ``torchrun``.

The model is reduced stablelm-3b with two layers in float32, as in
``tests/test_torch_parallel_train.py`` (which runs the (2, 2) mesh), and
the same fixed sampling: the mesh maps the global uniforms of the step's
generator to labels, the one-rank port and the JAX side take those labels.

- Steps: SGD, whose update is linear in the gradient, at that file's
  bounds: one rank's loss and parameters within 1e-6, JAX's 1e-5 and
  1e-4.
- Optimizer rules on split leaves: Adagrad, AdamW and SM3 (the trunk's
  2-D leaves split along dim 0, ``w_down``, and along dim 1, ``w_gate``
  and ``w_up``, so SM3's whole covers recombine by MAX) take 3 steps of
  the same gradients, a rank's part of each, against one rank's update of
  the whole, at the reference's bounds (1e-3 relative plus 1e-4,
  ``tests/test_parallel.py:65-70``), with the clip norm the same on every
  rank. The same gradients on both sides: Adagrad's first step,
  -lr·g/(|g| + eps), turns the float32 reordering of a sharded gradient
  at |g| near eps into differences above those bounds, a property of the
  rule, not of the placement.
- ``init_train_state(mesh=)`` bit-equal to ``shard_train_state`` of the
  one-rank state, for the dense, expert-split, ``d_ff``-split and hybrid
  blocks under SM3 and AdamW.
- The loop: 4 steps, an asynchronous fit at step 1 swapped in at 2,
  checkpoints at 2 and 4; every rank's tree bit-equal, its label maps
  equal to the one-rank loop's and its nodes' parameters within the
  reference's bounds of them (the fit's Newton solves take the sharded
  forward's float32 reordering of the features up to 1.4e-4), the losses
  within 1e-5; the mesh's checkpoint
  restored by one process bit-equal to the mesh's gathered state, and a
  one-rank checkpoint restored on the mesh bit-equal to each rank's part.
"""
import dataclasses
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from test_torch_parallel_train import OPT, TFixed, _cfgs, _draws, _jfixed

import _torch_world as W
from repro_torch import configs as tconfigs
from repro_torch import convert, tree_util
from repro_torch.core.samplers import UniformSampler
from repro_torch.models import lm_head as tlm_head
from repro_torch.optim import OptimizerConfig
from repro_torch.train import LoopConfig, run_loop
from repro_torch.train import step as tstep
from repro_torch.train.generator_fit import make_gen_fit_fn

N_STEPS, LOOP_STEPS = 3, 4
MESH_TOL = dict(atol=1e-6, rtol=0)
REF_TOL = dict(atol=1e-4, rtol=1e-3)           # tests/test_parallel.py:65-70
OPT_RULES = {"adagrad": dict(name="adagrad", learning_rate=0.05, clip_norm=1.0),
             "adamw": dict(name="adamw", learning_rate=0.01, weight_decay=0.1, clip_norm=1.0),
             "sm3": dict(name="sm3", learning_rate=0.05, clip_norm=1.0)}
INIT_ARCHS = ("stablelm-3b", "deepseek-moe-16b", "mixtral-8x22b", "hymba-1.5b")
INIT_RULES = ("sm3", "adamw")

WORLD = """
from repro_torch import tree_util
from repro_torch.checkpoint import restore_checkpoint
from repro_torch.core.samplers import UniformSampler
from repro_torch.models import lm_head
from repro_torch.optim import OptimizerConfig, apply_updates
from repro_torch.optim.sparse import SparseRows
from repro_torch.parallel import gather_train_state, shard_train_state, sharding
from repro_torch.train import LoopConfig, init_train_state, run_loop
from repro_torch.train import step as tstep
from repro_torch.train.generator_fit import make_gen_fit_fn

inp = torch.load(os.path.join(OUT, "inputs.pt"), weights_only=False)
mesh = mesh_of(2)
cfg = inp["cfg"]
hcfg = lm_head.head_config(cfg, "adversarial_ns", n_neg=1, reg=1e-4)
out = {}

# Three SGD steps.
state = shard_train_state(inp["state"], mesh, cfg)
step = tstep.make_train_step(cfg, hcfg, OptimizerConfig(**inp["opt"]),
                             sampler=UniformSampler(cfg.vocab_size), mesh=mesh)
metrics = []
for s, batch in enumerate(inp["batches"]):
    state, m = step(state, batch, torch.Generator().manual_seed(s))
    metrics.append({k: float(v) for k, v in m.items()})
out["steps"] = {"metrics": metrics, "params": gather_train_state(state.params, mesh, cfg)}

# The optimizer rules on a rank's part of the trunk, the same gradients.
split = sharding.split_dims(cfg, mesh, shard_train_state(inp["opt_params"], mesh, cfg))
for rule, kw in inp["rules"].items():
    st = shard_train_state(inp["opt_states"][rule], mesh, cfg)
    params, opt_state = st.params, st.opt_state
    norms = []
    for g in inp["opt_grads"]:
        local = {**shard_train_state({"layers": g["layers"]}, mesh, cfg),
                 "final_norm": g["final_norm"], "head": g["head"], "embed": g["embed"]}
        params, opt_state, m = apply_updates(OptimizerConfig(**kw), params, local, opt_state,
                                             mesh=mesh, split_dims=split)
        norms.append(m["grad_norm"])
    out["opt", rule] = (gather_train_state(params, mesh, cfg),
                        gather_train_state(opt_state, mesh, cfg), norms)

# init_train_state on the mesh.
for key, (arch_cfg, rule) in inp["init"].items():
    out["init", key] = init_train_state(torch.Generator().manual_seed(3), arch_cfg,
                                        OptimizerConfig(name=rule), "adversarial_ns",
                                        device="cpu", mesh=mesh)

# The loop: an async fit at step 1, swapped in at 2; checkpoints at 2 and 4.
batch_fn = lambda s: inp["batches"][s % len(inp["batches"])]
fit = make_gen_fit_fn(cfg, batch_fn, kind="adversarial_ns", max_tokens=64, n_batches=2)
loop_step = tstep.make_train_step(cfg, hcfg, OptimizerConfig(**inp["opt"]), mesh=mesh)
loop_state, hist = run_loop(
    shard_train_state(inp["loop_state"], mesh, cfg), loop_step, batch_fn,
    LoopConfig(total_steps=inp["loop_steps"], checkpoint_every=2,
               checkpoint_dir=os.path.join(OUT, "ckpt"), gen_warmup_steps=1, gen_async=True,
               gen_swap_delay=1), seed=1, gen_fit_fn=fit, mesh=mesh, model_cfg=cfg)
out["loop"] = {"loss": hist["loss"], "swaps": hist.get("gen_swap_steps"),
               "tree": tree_util.leaves(loop_state.head_state.gen.tree),
               "state": gather_train_state(loop_state, mesh, cfg)}

# A one-rank checkpoint restored on the mesh.
like = shard_train_state(inp["one_ckpt_state"], mesh, cfg)
restored, _ = restore_checkpoint(inp["one_ckpt"], like.as_pytree(),
                                 layout=sharding.StateLayout(like.as_pytree(), mesh, cfg))
out["restored_part"] = restored
save(out)
"""


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _steps_batches(tcfg):
    from test_torch_parallel_train import _batch
    return [{k: torch.as_tensor(v) for k, v in _batch(tcfg, s).items()} for s in range(N_STEPS)]


def _opt_grads(cfg, params, seed=4):
    """3 steps of gradients: dense for the trunk, sparse rows for the head
    and the embedding, drawn with numpy."""
    from repro_torch.optim.sparse import SparseRows
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(N_STEPS):
        g = tree_util.tree_map(lambda p: torch.as_tensor(
            rng.standard_normal(tuple(p.shape)).astype(np.float32) * 0.1),
            {"layers": params["layers"], "final_norm": params["final_norm"]})
        ids = torch.as_tensor(np.sort(rng.choice(cfg.padded_vocab, 9, replace=False)))
        g["head"] = SparseRows(ids, torch.as_tensor(rng.standard_normal((9, cfg.d_model))
                                                    .astype(np.float32)),
                               torch.as_tensor(rng.standard_normal(9).astype(np.float32)))
        g["embed"] = SparseRows(ids, torch.as_tensor(rng.standard_normal((9, cfg.d_model))
                                                     .astype(np.float32)), None)
        out.append(g)
    return out


def _init_cfg(arch):
    over = {"n_experts": 3} if arch == "mixtral-8x22b" else {}
    return dataclasses.replace(tconfigs.reduced_config(arch), dtype="float32", **over)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    import jax
    from repro.optim import OptimizerConfig as JOptimizerConfig
    from repro.train import step as jstep
    jcfg, tcfg = _cfgs()
    jstate = jstep.init_train_state(jax.random.PRNGKey(0), jcfg, JOptimizerConfig(**OPT),
                                    "adversarial_ns")
    np_state = jax.tree.map(np.asarray, jstate)
    full = convert.train_state_from_numpy(np_state, device="cpu")
    batches = _steps_batches(tcfg)
    tmp = tmp_path_factory.mktemp("tp_train_loop")
    opt_states = {rule: tstep.init_train_state(torch.Generator().manual_seed(2), tcfg,
                                               OptimizerConfig(**kw), "adversarial_ns",
                                               device="cpu")
                  for rule, kw in OPT_RULES.items()}
    grads = _opt_grads(tcfg, full.params)
    # The one-rank loop (its checkpoint at step 4 is the one the mesh restores).
    loop = _one_rank_loop(tcfg, convert.train_state_from_numpy(np_state, device="cpu"),
                          batches, str(tmp / "one_ckpt"))
    torch.save({"cfg": tcfg, "opt": OPT, "state": full, "batches": batches,
                "rules": OPT_RULES, "opt_states": opt_states, "opt_grads": grads,
                "opt_params": opt_states["sm3"].params,
                "init": {(arch, rule): (_init_cfg(arch), rule)
                         for arch in INIT_ARCHS for rule in INIT_RULES},
                "loop_state": convert.train_state_from_numpy(np_state, device="cpu"),
                "loop_steps": LOOP_STEPS, "one_ckpt": str(tmp / "one_ckpt"),
                "one_ckpt_state": loop[0]}, tmp / "inputs.pt")
    W.run_world(tmp, 2, WORLD, timeout=150)
    return dict(jcfg=jcfg, tcfg=tcfg, jstate=jstate, np_state=np_state, batches=batches,
                opt_states=opt_states, grads=grads, loop=loop,
                outs=W.load_outputs(tmp, 2), tmp=tmp)


def _one_rank_loop(cfg, state, batches, ckpt):
    hcfg = tlm_head.head_config(cfg, "adversarial_ns", n_neg=1, reg=1e-4)
    batch_fn = lambda s: batches[s % len(batches)]  # noqa: E731
    fit = make_gen_fit_fn(cfg, batch_fn, kind="adversarial_ns", max_tokens=64, n_batches=2)
    return run_loop(state, tstep.make_train_step(cfg, hcfg, OptimizerConfig(**OPT)), batch_fn,
                    LoopConfig(total_steps=LOOP_STEPS, checkpoint_every=2, checkpoint_dir=ckpt,
                               gen_warmup_steps=1, gen_async=True, gen_swap_delay=1),
                    seed=1, gen_fit_fn=fit)


def test_steps_match_one_rank_and_jax(setup):
    import jax
    from repro.models import lm_head as jlm_head
    from repro.optim import OptimizerConfig as JOptimizerConfig
    from repro.train import step as jstep
    tcfg, jcfg = setup["tcfg"], setup["jcfg"]
    hcfg = tlm_head.head_config(tcfg, "adversarial_ns", n_neg=1, reg=1e-4)
    state = convert.train_state_from_numpy(setup["np_state"], device="cpu")
    one = tstep.make_train_step(tcfg, hcfg, OptimizerConfig(**OPT),
                                sampler=TFixed(_draws(tcfg), tcfg.vocab_size))
    jh = jlm_head.head_config(jcfg, "adversarial_ns", n_neg=1, reg=1e-4)
    jfn = jax.jit(jstep.make_train_step(jcfg, jh, JOptimizerConfig(**OPT),
                                        sampler=_jfixed(_draws(tcfg), jcfg.vocab_size)))
    jstate = setup["jstate"]
    for s, batch in enumerate(setup["batches"]):
        state, m = one(state, batch, torch.Generator().manual_seed(s))
        jstate, jm = jfn(jstate, {k: v.numpy() for k, v in batch.items()},
                         jax.random.PRNGKey(s))
        for out in setup["outs"]:
            got = out["steps"]["metrics"][s]
            for k in ("loss", "grad_norm"):
                np.testing.assert_allclose(got[k], float(m[k]), rtol=1e-6, err_msg=k)
                np.testing.assert_allclose(got[k], float(jm[k]), rtol=1e-5, atol=1e-5,
                                           err_msg=k)
    want_j = convert._lm_tree(jax.tree.map(np.asarray, jstate.params), torch.device("cpu"),
                              n_layers=jcfg.num_layers)
    for out in setup["outs"]:
        got = tree_util.leaves(out["steps"]["params"])
        for g, w, j in zip(got, tree_util.leaves(state.params), tree_util.leaves(want_j)):
            np.testing.assert_allclose(g.numpy(), w.numpy(), **MESH_TOL)
            np.testing.assert_allclose(g.numpy(), j.numpy(), atol=1e-4, rtol=0)


@pytest.mark.parametrize("rule", list(OPT_RULES))
def test_optimizer_rules_on_split_leaves(setup, rule):
    from repro_torch.optim import apply_updates
    st = setup["opt_states"][rule]
    cfg = OptimizerConfig(**OPT_RULES[rule])
    params = tree_util.tree_map(lambda t: t.clone(), st.params)
    opt_state = tree_util.tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t,
                                   st.opt_state)
    norms = []
    for g in setup["grads"]:
        params, opt_state, m = apply_updates(cfg, params, g, opt_state)
        norms.append(float(m["grad_norm"]))
    for out in setup["outs"]:
        got_p, got_s, got_norms = out["opt", rule]
        np.testing.assert_allclose([float(n) for n in got_norms], norms, rtol=1e-6)
        for g, w in zip(tree_util.leaves((got_p, got_s)), tree_util.leaves((params, opt_state))):
            if isinstance(w, torch.Tensor):
                np.testing.assert_allclose(g.float().numpy(), w.float().numpy(), **REF_TOL)
            else:
                assert g == w
    a, b = (out["opt", rule][2] for out in setup["outs"])
    assert all(torch.equal(x, y) for x, y in zip(a, b))      # the clip decides alike


@pytest.mark.parametrize("rule", INIT_RULES)
@pytest.mark.parametrize("arch", INIT_ARCHS)
def test_init_train_state_on_the_mesh_is_the_one_rank_part(setup, arch, rule):
    from repro_torch.parallel import sharding

    class Rank:                   # the (1, 2) mesh's rank r, for the rules alone
        shape = (1, 2)
        mesh_dim_names = sharding.MESH_DIMS

        def __init__(self, r):
            self.r = r

        def get_local_rank(self, dim):
            return self.r if dim == "model" else 0

    cfg = _init_cfg(arch)
    one = tstep.init_train_state(torch.Generator().manual_seed(3), cfg,
                                 OptimizerConfig(name=rule), "adversarial_ns", device="cpu")
    for r, out in enumerate(setup["outs"]):
        want = sharding.shard_train_state(one, Rank(r), cfg)
        got_l, got_s = tree_util.flatten(out["init", (arch, rule)])
        want_l, want_s = tree_util.flatten(want)
        assert got_s == want_s
        for g, w in zip(got_l, want_l):
            assert (torch.equal(g, w) if isinstance(w, torch.Tensor) else g == w)


def test_loop_fits_one_generator_and_checkpoints_restore_across_meshes(setup):
    from repro_torch.checkpoint import latest_step, restore_checkpoint
    from repro_torch.parallel import sharding
    outs = setup["outs"]
    one_state, one_hist = setup["loop"]
    for o in outs:
        assert o["loop"]["swaps"] == one_hist["gen_swap_steps"] == [2]
        np.testing.assert_allclose(o["loop"]["loss"], one_hist["loss"], rtol=1e-5)
        for a, b in zip(o["loop"]["tree"], outs[0]["loop"]["tree"]):
            assert torch.equal(a, b)
        one_tree = tree_util.leaves(one_state.head_state.gen.tree)
        for a, b in zip(o["loop"]["tree"], one_tree):       # the label maps
            assert a.is_floating_point() or torch.equal(a, b)
        for a, b in zip(o["loop"]["tree"], one_tree):       # the nodes' parameters
            if a.is_floating_point():
                np.testing.assert_allclose(a.numpy(), b.numpy(), **REF_TOL)
    # The mesh's checkpoint, restored by one process.
    ckpt = str(setup["tmp"] / "ckpt")
    assert latest_step(ckpt) == LOOP_STEPS
    full = outs[0]["loop"]["state"].as_pytree()
    restored, _ = restore_checkpoint(ckpt, one_state.as_pytree())
    for g, w in zip(tree_util.leaves(restored), tree_util.leaves(full)):
        assert torch.equal(g, w) if isinstance(w, torch.Tensor) else g == w
    # The one-rank checkpoint, restored on the mesh: each rank's part.
    for r, o in enumerate(outs):
        class Rank:
            shape = (1, 2)
            mesh_dim_names = sharding.MESH_DIMS

            def get_local_rank(self, dim):
                return r if dim == "model" else 0

        want = sharding.shard_train_state(one_state.as_pytree(), Rank(), setup["tcfg"])
        for g, w in zip(tree_util.leaves(o["restored_part"]), tree_util.leaves(want)):
            assert torch.equal(g, w) if isinstance(w, torch.Tensor) else g == w


def test_train_launcher_prints_each_ranks_bytes(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(W.ROOT, "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
         "2", "-m", "repro_torch.launch.train", "--arch", "hymba-1.5b", "--reduced",
         "--device", "cpu", "--model-axis", "2", "--optimizer", "sm3", "--steps", "2",
         "--batch", "2", "--seq", "16"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.count("final loss") == 1
    for label in ("parameter", "optimizer-state"):
        m = re.search(label + r" bytes a rank \[(\d+), (\d+)\] \(one rank's (\d+): (\d+) split "
                      r"over model, (\d+) whole\)", proc.stdout)
        assert m, proc.stdout[:2000]
        a, b, total, split, whole = map(int, m.groups())
        assert a == b == split // 2 + whole and total == split + whole and split > 0
