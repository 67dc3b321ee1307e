"""Gradients of the trunk sharded over the mesh's ``model`` axis, on gloo
ranks on the CPU: one sparse training step's gradients through
``make_grad_fn(mesh=)`` on a rank's part of the state
(``parallel.shard_train_state``) on (1, 2) and (1, 4) meshes, against the
port's one-rank gradients and the JAX package's jitted step on the same
converted parameters.

Cases and the branch each takes (reduced configs, float32, the JAX
package's ``init_train_state`` carried across):
- h2o-danube: at tp 2 its 2 KV heads split with the query heads; at tp 4
  they stay whole and each rank reads the one its query head uses, so
  ``wk`` and ``wv`` have partial gradients, summed over ``model``;
- deepseek-moe: 8 experts split (4 and 2 a rank), the shared expert's
  ``d_ff`` split, the router's gradient partial;
- mixtral with 3 experts: they do not divide, so each expert's ``d_ff`` is
  split;
- mamba2: SSD heads and ``w_out`` rows split; ``w_in``, the conv, the
  decay and skip parameters and the gated norm's scale read in part;
- hymba: 5 heads whole on every rank, the SSM branch split; and hinted
  (the queries split along the sequence under ``sharding_hints``) with
  ``cfg.remat``, so the checkpointed layers recompute their collectives.

Sampling is held fixed as in ``tests/test_torch_parallel_train.py``: the
mesh draws the global uniforms from the step's generator and maps them
to labels, the one-rank port and the JAX side take those labels.

Bounds: every leaf's gradient, gathered (the head's and the embedding's
``SparseRows`` made dense), within 1e-5 relative RMS of one rank's; the
mesh's one SGD step (lr 0.5, its update lr times the gradient) within the
bound ``tests/test_torch_model_families.py`` holds the port's against
JAX's, 1e-5; every leaf a rank holds whole, and the sparse rows,
bit-equal across ranks. Two planted faults must fail the first bound: the
SSM's ``w_in`` without its sum over ``model`` (its gradient stays
partial), and the norms' scales summed over ``model`` though every rank
uses them whole (their gradient multiplied by tp).
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
from test_torch_parallel_train import TFixed, _batch, _draws, _jfixed

import _torch_world as W
from repro import configs as jconfigs
from repro.models import lm_head as jlm_head
from repro.optim import OptimizerConfig as JOptimizerConfig
from repro.train import step as jstep
from repro_torch import configs as tconfigs
from repro_torch import convert, tree_util
from repro_torch.models import lm_head as tlm_head
from repro_torch.parallel import sharding
from repro_torch.train import step as tstep

CASES = {   # name: (arch, config overrides, hinted)
    "danube": ("h2o-danube-3-4b", {}, False),
    "deepseek_moe": ("deepseek-moe-16b", {}, False),
    "mixtral_3_experts": ("mixtral-8x22b", {"n_experts": 3}, False),
    "mamba2": ("mamba2-370m", {}, False),
    "hymba": ("hymba-1.5b", {}, False),
    "hymba_hinted_remat": ("hymba-1.5b", {"remat": True}, True),
}
TPS = (2, 4)
FAULTS = {"ssm_w_in_not_summed": "mamba2", "whole_norms_summed": "danube"}
GRAD_REL_RMS = 1e-5
LR = 0.5
STEP_TOL = dict(atol=1e-5, rtol=1e-5)          # tests/test_torch_model_families.py

WORLD = """
import threading
import types
from repro_torch import tree_util
from repro_torch.core.samplers import UniformSampler
from repro_torch.models import layers, lm_head, ssm, transformer
from repro_torch.parallel import collectives, gather_train_state, shard_train_state, sharding
from repro_torch.parallel.collectives import TRUNK
from repro_torch.parallel.hints import sharding_hints
from repro_torch.train import step as tstep

inp = torch.load(os.path.join(OUT, "inputs.pt"), weights_only=False)
mesh = mesh_of(inp["tp"])


def grads_of(case):
    cfg = case["cfg"]
    hcfg = lm_head.head_config(cfg, "adversarial_ns", n_neg=1, reg=1e-4)
    state = shard_train_state(case["state"], mesh, cfg)
    fn = tstep.make_grad_fn(cfg, hcfg, sampler=UniformSampler(cfg.vocab_size), mesh=mesh)
    TRUNK.reset()
    with sharding_hints(mesh) if case["hinted"] else __import__("contextlib").nullcontext():
        grads, metrics = fn(state, inp["batch"], torch.Generator().manual_seed(0))
    trunk = {k: v for k, v in grads.items() if k not in ("head", "embed")}
    return dict(local=trunk, full=gather_train_state(trunk, mesh, cfg),
                head=grads["head"], embed=grads["embed"], loss=float(metrics["loss"]),
                phases=TRUNK.phases)


out = {name: grads_of(case) for name, case in inp["cases"].items()}

# The hinted remat case's backward on another thread, outside the hint's
# context (as autograd runs it on the card), against the same backward
# inside it: the recompute must run under the forward's hints.
case = inp["cases"]["hymba_hinted_remat"]
cfg, tokens = case["cfg"], inp["batch"]["tokens"]
params = shard_train_state(case["state"], mesh, cfg).params
with torch.no_grad():
    embeds = transformer.embed_inputs(params, cfg, tokens, mesh=mesh)
recomputed = []
for on_thread in (False, True):
    trunk = tree_util.tree_map(lambda t: t.detach().requires_grad_(),
                               {k: v for k, v in params.items() if k not in ("head", "embed")})
    leaves = tree_util.leaves(trunk)
    with sharding_hints(mesh):
        h = transformer.forward(trunk, cfg, tokens, inputs_embeds=embeds, attn_impl="plain",
                                mesh=mesh)[0]
        loss = h.pow(2).sum()
        if not on_thread:
            recomputed.append(torch.autograd.grad(loss, leaves))
    if on_thread:
        box = []
        worker = threading.Thread(target=lambda: box.append(torch.autograd.grad(loss, leaves)))
        worker.start()
        worker.join()
        recomputed.append(box[0])
out["recompute_on_another_thread"] = recomputed
if inp["tp"] == 2:
    # Planted faults: the SSM's w_in without copy_to_model, and the norms'
    # scales (used whole) through it.
    w_in_shape = tuple(inp["cases"]["mamba2"]["state"].params["layers"][0]["ssm"]["w_in"].shape)
    proxy = types.SimpleNamespace(**vars(collectives))
    proxy.copy_to_model = lambda m, t: (t if tuple(t.shape) == w_in_shape
                                        else collectives.copy_to_model(m, t))
    ssm.collectives = proxy
    out["ssm_w_in_not_summed"] = grads_of(inp["cases"]["mamba2"])
    ssm.collectives = collectives
    norm = layers.rmsnorm
    layers.rmsnorm = lambda p, x, eps=1e-6: norm(
        {"scale": collectives.copy_to_model(mesh, p["scale"])}, x, eps)
    out["whole_norms_summed"] = grads_of(inp["cases"]["danube"])
    layers.rmsnorm = norm
save(out)
"""


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _jax_state(arch, over):
    jcfg = dataclasses.replace(jconfigs.reduced_config(arch), dtype="float32", **dict(over))
    return jax.jit(lambda k: jstep.init_train_state(
        k, jcfg, JOptimizerConfig(name="sgd", learning_rate=LR), "adversarial_ns"))(
        jax.random.PRNGKey(0))


def _carried(name):
    """(JAX config, port config, JAX state, numpy state) of a case; remat
    changes no parameter, so a remat case shares its arch's state."""
    arch, over, _ = CASES[name]
    kw = dict(over, dtype="float32")
    jcfg = dataclasses.replace(jconfigs.reduced_config(arch), **kw)
    tcfg = dataclasses.replace(tconfigs.reduced_config(arch), **kw)
    jstate = _jax_state(arch, tuple(sorted((k, v) for k, v in over.items() if k != "remat")))
    return jcfg, tcfg, jstate, jax.tree.map(np.asarray, jstate)


def _state(name):
    return convert.train_state_from_numpy(_carried(name)[3], device="cpu")


def _torch_batch(cfg):
    return {k: torch.as_tensor(v) for k, v in _batch(cfg, 0).items()}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    cases = {name: dict(cfg=_carried(name)[1], state=_state(name), hinted=hinted)
             for name, (_, _, hinted) in CASES.items()}
    out = {}
    for tp in TPS:
        tmp = tmp_path_factory.mktemp(f"tp_train{tp}")
        torch.save({"tp": tp, "cases": cases,
                    "batch": _torch_batch(cases["danube"]["cfg"])}, tmp / "inputs.pt")
        W.run_world(tmp, tp, WORLD, timeout=150)
        out[tp] = W.load_outputs(tmp, tp)
    return out


def _dense(rows, n_rows):
    """A ``SparseRows``'s (dw, db) as dense tables."""
    dw = torch.zeros((n_rows,) + tuple(rows.dw.shape[1:])).index_add_(0, rows.ids, rows.dw)
    db = None if rows.db is None else torch.zeros(n_rows).index_add_(0, rows.ids, rows.db)
    return dw, db


def _flat(out, cfg):
    """{path: dense gradient} of a step's gradients: the trunk's gathered,
    the head's and the embedding's rows made dense."""
    flat = {p: g for p, g in tree_util.flatten_with_paths(out["full"])[0]}
    flat[("head", "w")], flat[("head", "b")] = _dense(out["head"], cfg.padded_vocab)
    flat[("embed",)] = _dense(out["embed"], cfg.padded_vocab)[0]
    return flat


@functools.lru_cache(maxsize=None)
def _one_rank(name):
    cfg = _carried(name)[1]
    hcfg = tlm_head.head_config(cfg, "adversarial_ns", n_neg=1, reg=1e-4)
    fn = tstep.make_grad_fn(cfg, hcfg, sampler=TFixed(_draws(cfg), cfg.vocab_size))
    grads, metrics = fn(_state(name), _torch_batch(cfg), torch.Generator().manual_seed(0))
    trunk = {k: v for k, v in grads.items() if k not in ("head", "embed")}
    return _flat(dict(full=trunk, head=grads["head"], embed=grads["embed"]), cfg), \
        float(metrics["loss"])


def _worst_rel_rms(got: dict, want: dict):
    assert set(got) == set(want)
    worst, at = 0.0, None
    for path, w in want.items():
        diff = float((got[path] - w).pow(2).mean().sqrt())
        scale = float(w.pow(2).mean().sqrt())
        rel = diff / scale if scale > 0 else (0.0 if diff == 0 else float("inf"))
        if rel > worst:
            worst, at = rel, path
    return worst, at


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("name", list(CASES))
def test_gathered_gradients_match_one_rank(worlds, name, tp):
    want, loss = _one_rank(name)
    cfg = _carried(name)[1]
    for out in worlds[tp]:
        got = out[name]
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-6)
        worst, at = _worst_rel_rms(_flat(got, cfg), want)
        assert worst <= GRAD_REL_RMS, (name, tp, at, worst)


@pytest.mark.parametrize("name", [n for n in CASES if "remat" not in n])
def test_mesh_step_matches_jax(worlds, name):
    """One SGD step of the (1, 2) mesh's gradients against the JAX
    package's step on the same converted parameters and candidates (the
    hinted remat case runs hymba's math, held to JAX by the hymba case, so
    it is held to one rank's alone)."""
    jcfg, tcfg, jstate, np_state = _carried(name)
    jh = jlm_head.head_config(jcfg, "adversarial_ns", n_neg=1, reg=1e-4)
    jfn = jax.jit(jstep.make_train_step(jcfg, jh, JOptimizerConfig(name="sgd", learning_rate=LR),
                                        sampler=_jfixed(_draws(tcfg), jcfg.vocab_size)))
    batch = _batch(tcfg, 0)
    jnew, _ = jfn(jstate, batch, jax.random.PRNGKey(0))
    before = convert._lm_tree(np_state.params, torch.device("cpu"), jcfg.num_layers)
    after = convert._lm_tree(jax.tree.map(np.asarray, jnew.params), torch.device("cpu"),
                             jcfg.num_layers)
    got = _flat(worlds[2][0][name], tcfg)
    for (path, b), a in zip(tree_util.flatten_with_paths(before)[0], tree_util.leaves(after)):
        np.testing.assert_allclose((-LR * got[path]).numpy(), (a - b).numpy(), **STEP_TOL,
                                   err_msg=str(path))


@pytest.mark.parametrize("tp", TPS)
def test_whole_leaves_and_rows_bit_equal_across_ranks(worlds, tp):
    for name in CASES:
        cfg = _carried(name)[1]
        split = sharding.split_dims(cfg, (1, tp), _state(name).params)
        ranks = worlds[tp]
        for out in ranks[1:]:
            for path, g in tree_util.flatten_with_paths(out[name]["local"])[0]:
                if path not in split:
                    ref = dict(tree_util.flatten_with_paths(ranks[0][name]["local"])[0])[path]
                    assert torch.equal(g, ref), (name, path)
            for key in ("head", "embed"):
                for a, b in zip(out[name][key], ranks[0][name][key]):
                    assert (a is None and b is None) or torch.equal(a, b), (name, key)


def test_collectives_by_phase(worlds):
    """Forward, recompute and backward calls are counted apart: only the
    remat case recomputes, and every split case's backward sums."""
    for name in CASES:
        phases = worlds[2][0][name]["phases"]
        assert phases["forward"]["calls"] > 0 and phases["backward"]["calls"] > 0, name
        assert (phases["recompute"]["calls"] > 0) == (name == "hymba_hinted_remat"), name


def test_recompute_runs_under_the_forwards_hints(worlds):
    """A checkpointed layer recomputed on another thread, outside the
    hint's context (autograd's device thread on the card), gives the
    gradients of the backward run inside it, bit for bit."""
    for out in worlds[2] + worlds[4]:
        inside, elsewhere = out["recompute_on_another_thread"]
        assert len(inside) == len(elsewhere)
        assert all(torch.equal(a, b) for a, b in zip(inside, elsewhere))


@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_faults_fail_the_gradient_bound(worlds, fault):
    name = FAULTS[fault]
    want, _ = _one_rank(name)
    worst, at = _worst_rel_rms(_flat(worlds[2][0][fault], _carried(name)[1]), want)
    assert worst > 1e3 * GRAD_REL_RMS, (fault, at, worst)
