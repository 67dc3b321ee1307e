"""The port's data-parallel training step with the vocab-sharded head, on a
(2, 2) mesh of gloo ranks on the CPU, as ``tests/test_parallel.py::
test_sharded_train_step_matches_single_device`` and
``test_sparse_train_step_on_mesh`` check the reference's; the loop under
the mesh (an async generator fit, checkpoints); and the training
launcher under ``torchrun``.

The model is reduced stablelm-3b with two layers in float32, its state the
JAX package's ``init_train_state`` carried across. The global batch is 8 ×
16 tokens with a masked tail, so a data rank's mask count differs from
the other's. Sampling is held fixed: the mesh draws the global batch's
uniforms from the step's generator and keeps its rows, and the uniform
sampler maps them to labels (floor(u·C)); the JAX side and the one-rank
port take those labels through a test-only fixed sampler.

Optimizer: SGD (lr 0.05, clip 1.0), whose update is linear in the
gradient: Adagrad's first step, -lr·g/(|g| + eps), turns the float32
reordering of a data-parallel sum at |g| near eps into 1e-4 parameter
differences, a property of that rule, not of the mesh.

Tolerances: against JAX the single-device bounds of
``tests/test_torch_lm_train.py`` (losses and metrics 1e-5; parameters
1e-4 absolute); one rank against the mesh, the loss to 1e-6 relative and
the parameters to 1e-6 absolute (float32 sums over the two data ranks in
another order).
"""
import dataclasses
import os
import subprocess
import sys
from typing import NamedTuple

import numpy as np
import pytest
import torch

import _torch_world as W
from repro_torch import configs as tconfigs
from repro_torch import convert, tree_util
from repro_torch.models import lm_head as tlm_head
from repro_torch.optim import OptimizerConfig
from repro_torch.train import step as tstep

B, S, N_STEPS, N_NEG = 8, 16, 3, 1
N_RANKS = 4
OPT = dict(name="sgd", learning_rate=0.05, clip_norm=1.0)
MESH_TOL = dict(atol=1e-6, rtol=0)

WORLD = """
import dataclasses
import torch
from repro_torch import configs, tree_util
from repro_torch.core.samplers import UniformSampler
from repro_torch.models import lm_head
from repro_torch.optim import OptimizerConfig
from repro_torch.parallel import gather_train_state, shard_train_state
from repro_torch.train import LoopConfig, run_loop
from repro_torch.train import step as tstep
from repro_torch.train.generator_fit import make_gen_fit_fn

mesh = mesh_of(2)
inp = torch.load(os.path.join(OUT, "inputs.pt"), weights_only=False)
cfg = dataclasses.replace(configs.reduced_config("stablelm-3b"), num_layers=2,
                          dtype="float32")
hcfg = lm_head.head_config(cfg, "adversarial_ns", n_neg=inp["n_neg"], reg=1e-4)
opt = OptimizerConfig(**inp["opt"])
state = shard_train_state(inp["state"], mesh, cfg)
step = tstep.make_train_step(cfg, hcfg, opt, sampler=UniformSampler(cfg.vocab_size), mesh=mesh)
metrics = []
for s, batch in enumerate(inp["batches"]):
    state, m = step(state, batch, torch.Generator().manual_seed(s))
    metrics.append({k: float(v) for k, v in m.items()})
out = {"metrics": metrics, "params": gather_train_state(state, mesh, cfg).params,
       "eval": {k: float(v) for k, v in
                tstep.make_eval_step(cfg, hcfg, mesh=mesh)(state, inp["eval_batch"]).items()}}

# The loop under the mesh: an async fit at step 1, swapped in at 2, on the
# default tree sampler; checkpoints at 2 and 4.
batch_fn = lambda s: inp["batches"][s % len(inp["batches"])]
fit = make_gen_fit_fn(cfg, batch_fn, kind="adversarial_ns", max_tokens=64, n_batches=2)
loop_step = tstep.make_train_step(cfg, hcfg, opt, mesh=mesh)
loop_state = shard_train_state(inp["loop_state"], mesh, cfg)
ckpt = os.path.join(OUT, "ckpt")
loop_state, hist = run_loop(
    loop_state, loop_step, batch_fn, LoopConfig(total_steps=4, checkpoint_every=2,
    checkpoint_dir=ckpt, gen_warmup_steps=1, gen_async=True, gen_swap_delay=1), seed=1,
    gen_fit_fn=fit, mesh=mesh, model_cfg=cfg)
out["loop"] = {"loss": hist["loss"], "swaps": hist.get("gen_swap_steps"),
               "tree": tree_util.leaves(loop_state.head_state.gen.tree),
               "state": gather_train_state(loop_state, mesh, cfg)}
save(out)
"""


def _cfgs():
    from repro import configs as jconfigs
    jcfg = dataclasses.replace(jconfigs.reduced_config("stablelm-3b"), num_layers=2,
                               dtype="float32")
    tcfg = dataclasses.replace(tconfigs.reduced_config("stablelm-3b"), num_layers=2,
                               dtype="float32")
    return jcfg, tcfg


def _batch(cfg, step):
    rng = np.random.default_rng((7, step))
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    mask = np.ones((B, S), np.float32)
    mask[0, -5:] = 0.0                  # data rank 0 counts 5 fewer tokens
    mask[6, :2] = 0.0
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:], "mask": mask}


def _draws(cfg):
    """The labels the mesh draws at each step: floor(u·C) of the global
    uniforms of the step's generator."""
    out = []
    for s in range(N_STEPS):
        u = torch.rand((B, S, N_NEG), generator=torch.Generator().manual_seed(s))
        out.append((u.double() * cfg.vocab_size).long().clamp(max=cfg.vocab_size - 1))
    return torch.stack(out).numpy()


class TFixed:
    """The mesh's draws for the one-rank port: step s = the generator's seed."""

    def __init__(self, ids, c):
        self.ids, self.logp = torch.as_tensor(ids), -float(np.log(c))

    def sample(self, generator, x_gen, shape, u=None):
        ids = self.ids[generator.initial_seed()].reshape(shape)
        return ids, torch.full(shape, self.logp)

    def log_prob(self, x_gen, y):
        return torch.full(y.shape, self.logp)


def _jfixed(ids, c):
    import jax.numpy as jnp

    class JFixed(NamedTuple):
        ids: object

        def sample(self, rng, x_gen, shape):
            picked = jnp.take(self.ids, rng[1], axis=0).reshape(shape)
            return picked, jnp.full(shape, -np.log(c), jnp.float32)

        def log_prob(self, x_gen, y):
            return jnp.full(y.shape, -np.log(c), jnp.float32)

    return JFixed(jnp.asarray(ids.astype(np.int32)))


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    import jax
    from repro.optim import OptimizerConfig as JOptimizerConfig
    from repro.train import step as jstep
    jcfg, tcfg = _cfgs()
    jstate = jstep.init_train_state(jax.random.PRNGKey(0), jcfg, JOptimizerConfig(**OPT),
                                    "adversarial_ns")
    np_state = jax.tree.map(np.asarray, jstate)
    batches = [{k: torch.as_tensor(v) for k, v in _batch(tcfg, s).items()}
               for s in range(N_STEPS)]
    tmp = tmp_path_factory.mktemp("train_world")
    torch.save({"state": convert.train_state_from_numpy(np_state, device="cpu"),
                "loop_state": convert.train_state_from_numpy(np_state, device="cpu"),
                "batches": batches, "eval_batch": batches[0], "opt": OPT, "n_neg": N_NEG},
               tmp / "inputs.pt")
    W.run_world(tmp, N_RANKS, WORLD, timeout=150)
    return dict(jcfg=jcfg, tcfg=tcfg, jstate=jstate, np_state=np_state, batches=batches,
                outs=W.load_outputs(tmp, N_RANKS), tmp=tmp)


def _one_rank(setup):
    tcfg = setup["tcfg"]
    hcfg = tlm_head.head_config(tcfg, "adversarial_ns", n_neg=N_NEG, reg=1e-4)
    state = convert.train_state_from_numpy(setup["np_state"], device="cpu")
    step = tstep.make_train_step(tcfg, hcfg, OptimizerConfig(**OPT),
                                 sampler=TFixed(_draws(tcfg), tcfg.vocab_size))
    metrics = []
    for s, batch in enumerate(setup["batches"]):
        state, m = step(state, batch, torch.Generator().manual_seed(s))
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def test_sharded_train_step_matches_one_rank(setup):
    state, metrics = _one_rank(setup)
    for out in setup["outs"]:
        for got, want in zip(out["metrics"], metrics):
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7, err_msg=k)
        for g, w in zip(tree_util.leaves(out["params"]), tree_util.leaves(state.params)):
            np.testing.assert_allclose(g.numpy(), w.numpy(), **MESH_TOL)


def test_sharded_train_step_matches_jax(setup):
    """Three steps on the (2, 2) mesh against the JAX package's one-device
    step on the same candidates."""
    import jax
    from repro.models import lm_head as jlm_head
    from repro.optim import OptimizerConfig as JOptimizerConfig
    from repro.train import step as jstep
    jcfg, tcfg = setup["jcfg"], setup["tcfg"]
    jh = jlm_head.head_config(jcfg, "adversarial_ns", n_neg=N_NEG, reg=1e-4)
    jfn = jax.jit(jstep.make_train_step(jcfg, jh, JOptimizerConfig(**OPT),
                                        sampler=_jfixed(_draws(tcfg), jcfg.vocab_size)))
    jstate = setup["jstate"]
    for s in range(N_STEPS):
        batch = {k: v.numpy() for k, v in setup["batches"][s].items()}
        jstate, jm = jfn(jstate, batch, jax.random.PRNGKey(s))
        for k in ("loss", "grad_norm", "pos_score", "neg_score", "snr_proxy"):
            for out in setup["outs"]:
                np.testing.assert_allclose(out["metrics"][s][k], float(jm[k]), atol=1e-5,
                                           rtol=1e-5, err_msg=k)
    want = convert._lm_tree(jax.tree.map(np.asarray, jstate.params), torch.device("cpu"),
                            n_layers=2)
    for out in setup["outs"]:
        for g, w in zip(tree_util.leaves(out["params"]), tree_util.leaves(want)):
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-4, rtol=0)


def test_sharded_eval_step_matches_one_rank(setup):
    tcfg = setup["tcfg"]
    hcfg = tlm_head.head_config(tcfg, "adversarial_ns", n_neg=N_NEG, reg=1e-4)
    state, _ = _one_rank(setup)
    want = tstep.make_eval_step(tcfg, hcfg)(state, setup["batches"][0])
    for out in setup["outs"]:
        for k in ("eval_loglik", "eval_acc"):
            np.testing.assert_allclose(out["eval"][k], float(want[k]), atol=1e-5, rtol=1e-5)


def test_loop_under_mesh_fits_one_generator_and_writes_full_checkpoints(setup):
    """The async fit's generator is bit-equal on every rank; the checkpoint
    written under the mesh holds the full arrays, and one process restores
    them bit-equal to the mesh's gathered state."""
    from repro_torch.checkpoint import latest_step, restore_checkpoint
    outs = setup["outs"]
    assert all(o["loop"]["swaps"] == [2] for o in outs)
    assert all(np.isfinite(o["loop"]["loss"]).all() for o in outs)
    for o in outs[1:]:
        assert o["loop"]["loss"] == outs[0]["loop"]["loss"]
        for a, b in zip(o["loop"]["tree"], outs[0]["loop"]["tree"]):
            assert torch.equal(a, b)
    ckpt = str(setup["tmp"] / "ckpt")
    assert latest_step(ckpt) == 4
    full = outs[0]["loop"]["state"]
    restored, _ = restore_checkpoint(ckpt, full.as_pytree())
    got, want = tree_util.flatten(restored)[0], tree_util.flatten(full.as_pytree())[0]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, torch.Tensor):
            assert torch.equal(g, w)
        else:
            assert g == w
    assert restored["params"]["head"]["w"].shape[0] == setup["tcfg"].padded_vocab


def test_train_launcher_under_torchrun(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(W.ROOT, "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
         "4", "-m", "repro_torch.launch.train", "--arch", "stablelm-3b", "--reduced",
         "--device", "cpu", "--model-axis", "2", "--steps", "3", "--batch", "4", "--seq",
         "16", "--gen-warmup", "1"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=150)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "mesh: {'data': 2, 'model': 2} over 4 ranks, backend gloo" in proc.stdout
    assert proc.stdout.count("final loss") == 1        # rank 0 alone prints
