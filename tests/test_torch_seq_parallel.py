"""Sequence parallelism over the mesh's ``model`` axis (the hint
``seq_parallel_residual``), on gloo ranks on the CPU: the residual stream
split along S between the blocks, gathered at each entry into split
weights and reduce-scattered at each row-parallel exit.

Two worlds run side by side:
- (1, 2), reduced configs in float32 on the JAX package's weights:
  stablelm-3b and h2o-danube-3-4b (heads and ``d_ff`` split),
  deepseek-moe-16b (experts split), mamba2-370m (SSD heads split) and
  hymba-1.5b (25-head-like whole attention under the attention hint beside
  its split SSM). The hiddens of a teacher-forced forward and the gradient
  of every leaf of ``sum(h * probe)`` (the embedding's rows gathered)
  within 1e-5 relative RMS of the port's one-rank run, and against the JAX
  package's one-device forward and ``jax.grad`` on the same weights (the
  reference's hint changes placement, not values) within the float32 bound
  of ``tests/test_torch_lm.py``. Layer 0's MoE top-k ids bit-equal to one
  rank's, the drops equal. A prefill's cache equal to the unhinted one's;
  an S that tp does not divide, and a decode step, bit-equal to the
  unhinted runs. The trunk's collectives' calls and bytes by phase equal
  the count from the shapes; each checkpointed layer keeps its input's
  rows alone, 1/tp of the unhinted bytes. Two planted faults fail the
  gradient bound: the head gather's backward summed over ``model``
  instead of sliced, and a block-entry gather's backward sliced instead of
  reduce-scattered.
- (2, 2): the sparse training step (``make_grad_fn(mesh=)``, FSDP over
  ``data``) under the hint for h2o-danube, deepseek-moe, mamba2 and hymba,
  and stablelm-3b's ``softmax`` head and dense tree head with the dense
  embedding, every leaf's gradient within 1e-5 relative RMS of one rank's
  (``tests/test_torch_tp_train.py``'s and
  ``tests/test_torch_dense_head_mesh.py``'s references, the same sampling).
"""
import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import test_torch_dense_head_mesh as dhm
import test_torch_tp_train as tpt
from test_torch_tp_train import _flat, _torch_batch, _worst_rel_rms

import _torch_world as W
from repro import configs as jconfigs
from repro.models import transformer as jtransformer
from repro_torch import configs as tconfigs
from repro_torch import convert, tree_util
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttransformer

ARCHS = {"stablelm": "stablelm-3b", "danube": "h2o-danube-3-4b",
         "deepseek_moe": "deepseek-moe-16b", "mamba2": "mamba2-370m", "hymba": "hymba-1.5b"}
STEP_CASES = ("danube", "deepseek_moe", "mamba2", "hymba")     # the (2, 2) world's
DENSE_CASES = ("softmax", "tree_dense")     # tests/test_torch_dense_head_mesh.py's
B, S, ODD_S = 2, 8, 7
GRAD_REL_RMS = 1e-5
F32_TOL = dict(atol=2e-4, rtol=2e-4)            # tests/test_torch_lm.py, against JAX
JAX_GRAD_REL_RMS = 2e-4
FAULTS = ("head_gather_summed", "entry_gather_sliced")

WORLD_TP = """
import contextlib
import dataclasses
import types
from repro_torch import tree_util
from repro_torch.models import moe, transformer
from repro_torch.parallel import collectives, gather_train_state, shard_train_state
from repro_torch.parallel.collectives import TRUNK
from repro_torch.parallel.hints import sharding_hints

inp = torch.load(os.path.join(OUT, "inputs.pt"), weights_only=False)
mesh = mesh_of(2)


def hint(sp):
    return sharding_hints(mesh, seq_parallel_residual=True) if sp else contextlib.nullcontext()


def grads_of(case, sp=True, remat=False):
    cfg = dataclasses.replace(case["cfg"], remat=remat)
    params = shard_train_state(case["params"], mesh, cfg)
    tree = tree_util.tree_map(lambda t: t.detach().requires_grad_(),
                              {k: v for k, v in params.items() if k != "head"})
    leaves, spec = tree_util.flatten(tree)
    routes, saved = [], []
    route, ckpt = moe._route, transformer.checkpoint_lib.checkpoint

    def recorded_route(*a):
        out = route(*a)
        routes.append(out[1])
        return out

    def recorded_ckpt(fn, lp, x, **kw):       # what each checkpointed layer keeps
        saved.append(x.untyped_storage().nbytes())
        return ckpt(fn, lp, x, **kw)

    moe._route = recorded_route
    transformer.checkpoint_lib = types.SimpleNamespace(checkpoint=recorded_ckpt)
    TRUNK.reset()
    try:
        with hint(sp):
            h, _, metrics = transformer.forward(tree, cfg, case["tokens"], attn_impl="plain",
                                                mesh=mesh)
            grads = torch.autograd.grad((h * case["probe"]).sum(), leaves)
    finally:
        moe._route = route
        transformer.checkpoint_lib = torch.utils.checkpoint
    full = gather_train_state(tree_util.unflatten(spec, list(grads)), mesh, cfg)
    return dict(h=h.detach(), grads=full, routes=routes, saved=saved,
                metrics={k: float(v) for k, v in metrics.items()},
                trunk={p: dict(c) for p, c in TRUNK.phases.items()})


def serve_of(case, sp):
    cfg = case["cfg"]
    params = shard_train_state(case["params"], mesh, cfg)
    cache = transformer.init_cache(cfg, case["tokens"].shape[0], case["tokens"].shape[1] + 1,
                                   dtype=torch.float32, device="cpu", mesh=mesh)
    with torch.no_grad(), hint(sp):
        h, cache, _ = transformer.forward(params, cfg, case["tokens"], cache=cache,
                                          cache_pos=0, mesh=mesh)
        odd = transformer.forward(params, cfg, case["odd"], attn_impl="plain", mesh=mesh)[0]
    return dict(prefill=h, cache=cache, odd=odd, params=params)


def decode_of(case, params, cache, sp):
    cache = {k: v.clone() for k, v in cache.items()}
    TRUNK.reset()
    with torch.no_grad(), hint(sp):
        d = transformer.forward(params, case["cfg"], case["decode"], cache=cache,
                                cache_pos=case["tokens"].shape[1], mesh=mesh)[0]
    return d, TRUNK.calls, TRUNK.bytes


out = {}
for name, case in inp["cases"].items():
    out[name] = grads_of(case)
    sp, plain = serve_of(case, True), serve_of(case, False)
    d_sp = decode_of(case, plain["params"], plain["cache"], True)
    d_plain = decode_of(case, plain["params"], plain["cache"], False)
    out[name]["serve"] = dict(
        prefill=(sp["prefill"], plain["prefill"]), cache=(sp["cache"], plain["cache"]),
        odd=(sp["odd"], plain["odd"]), decode=(d_sp, d_plain))

case = inp["cases"]["stablelm"]
out["saved"] = {sp: grads_of(case, sp, remat=True)["saved"] for sp in (True, False)}

# Planted: the head gather's backward summed over model instead of sliced.
real = collectives._GatherSeq.backward
collectives._GatherSeq.backward = staticmethod(
    lambda ctx, g: (collectives._scatter_seq_f32(ctx.mesh, g).to(g.dtype), None))
out["head_gather_summed"] = grads_of(case)
collectives._GatherSeq.backward = real

# Planted: a block-entry gather's backward sliced instead of reduce-scattered.
real = collectives._GatherSeqForModel.backward


def sliced(ctx, g):
    n = g.shape[1] // 2
    lo = collectives.sharding.rank(ctx.mesh, "model") * n
    return g[:, lo:lo + n].contiguous(), None


collectives._GatherSeqForModel.backward = staticmethod(sliced)
out["entry_gather_sliced"] = grads_of(case)
collectives._GatherSeqForModel.backward = real
save(out)
"""

WORLD_STEP = """
import _torch_world as W
from repro_torch.core.samplers import UniformSampler
from repro_torch.models import lm_head
from repro_torch.parallel import gather_train_state, shard_train_state
from repro_torch.parallel.hints import sharding_hints
from repro_torch.train import step as tstep

inp = torch.load(os.path.join(OUT, "inputs.pt"), weights_only=False)
mesh = mesh_of(2)
out = {}
for name, case in inp["cases"].items():
    cfg = case["cfg"]
    hcfg = lm_head.head_config(cfg, "adversarial_ns", n_neg=1, reg=1e-4)
    fn = tstep.make_grad_fn(cfg, hcfg, sampler=UniformSampler(cfg.vocab_size), mesh=mesh)
    with sharding_hints(mesh, seq_parallel_residual=True):
        grads, metrics = fn(shard_train_state(case["state"], mesh, cfg), inp["batch"],
                            torch.Generator().manual_seed(0))
    trunk = {k: v for k, v in grads.items() if k not in ("head", "embed")}
    out[name] = dict(full=gather_train_state(trunk, mesh, cfg),
                     head=W.whole_rows(mesh, grads["head"]),
                     embed=W.whole_rows(mesh, grads["embed"]), loss=float(metrics["loss"]))

# The dense heads and the dense embedding under the hint: the softmax head's
# own sum of h's gradient over model, and the embedding's whole gradient
# through the split's all-gather.
dense = inp["dense"]
for name, (kind, head_update, embed_update) in dense["cases"].items():
    cfg = dense["cfg"]
    fn = tstep.make_grad_fn(cfg, lm_head.head_config(cfg, kind, n_neg=1, reg=1e-4),
                            head_update=head_update, embed_update=embed_update,
                            sampler=UniformSampler(cfg.vocab_size), mesh=mesh)
    with sharding_hints(mesh, seq_parallel_residual=True):
        grads, metrics = fn(shard_train_state(dense["states"][kind], mesh, cfg),
                            dense["batch"], torch.Generator().manual_seed(0))
    rows = grads.pop("head") if not isinstance(grads["head"], dict) else None
    rows = None if rows is None else W.whole_rows(mesh, rows)
    out["dense", name] = dict(full=gather_train_state(grads, mesh, cfg), rows=rows,
                              loss=float(metrics["loss"]))
save(out)
"""


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _carried(name):
    """(JAX config, port config, JAX params, the port's params) of a case."""
    kw = dict(dtype="float32")
    jcfg = dataclasses.replace(jconfigs.reduced_config(ARCHS[name]), **kw)
    tcfg = dataclasses.replace(tconfigs.reduced_config(ARCHS[name]), **kw)
    params = jax.jit(lambda k: jtransformer.init_params(k, jcfg))(jax.random.PRNGKey(3))
    tparams = convert.lm_params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    return jcfg, tcfg, params, tparams


@functools.lru_cache(maxsize=None)
def _inputs(name):
    cfg = _carried(name)[1]
    rng = np.random.default_rng(sorted(ARCHS).index(name))
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1 + ODD_S)).astype(np.int64)
    probe = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return dict(tokens=torch.from_numpy(toks[:, :S]), decode=torch.from_numpy(toks[:, S:S + 1]),
                odd=torch.from_numpy(toks[:, S + 1:]), probe=torch.from_numpy(probe))


@functools.lru_cache(maxsize=None)
def _one_rank(name):
    """The port's one-rank hiddens, gradients (embedding included) and
    layer 0's top-k ids."""
    cfg, inp = _carried(name)[1], _inputs(name)
    tree = tree_util.tree_map(lambda t: t.detach().clone().requires_grad_(),
                              {k: v for k, v in _carried(name)[3].items() if k != "head"})
    leaves, spec = tree_util.flatten(tree)
    routes, route = [], tmoe._route
    tmoe._route = lambda *a: routes.append(route(*a)[1]) or route(*a)
    try:
        h, _, metrics = ttransformer.forward(tree, cfg, inp["tokens"], attn_impl="plain")
    finally:
        tmoe._route = route
    grads = torch.autograd.grad((h * inp["probe"]).sum(), leaves)
    return h.detach(), tree_util.unflatten(spec, list(grads)), routes, metrics


@functools.lru_cache(maxsize=None)
def _jax(name):
    """JAX's one-device hiddens and ``jax.grad`` of the same probe, in the
    port's layout."""
    jcfg, _, params, _ = _carried(name)
    inp = _inputs(name)
    toks, probe = jnp.asarray(inp["tokens"].numpy()), jnp.asarray(inp["probe"].numpy())
    trunk = {k: v for k, v in params.items() if k != "head"}

    def loss(p):
        h = jtransformer.forward({**p, "head": params["head"]}, jcfg, toks)[0]
        return (h * probe).sum(), h

    (_, h), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(trunk)
    return np.asarray(h), convert._lm_tree(jax.tree.map(np.asarray, g), torch.device("cpu"),
                                           jcfg.num_layers)


def _paths(tree):
    return {p: x for p, x in tree_util.flatten_with_paths(tree)[0]}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tp_tmp, step_tmp = tmp_path_factory.mktemp("sp_tp"), tmp_path_factory.mktemp("sp_step")
    torch.save({"cases": {name: dict(cfg=_carried(name)[1], params=_carried(name)[3],
                                     **_inputs(name)) for name in ARCHS}},
               tp_tmp / "inputs.pt")
    dcfg = dhm._cfgs()[1]
    torch.save({"cases": {name: dict(cfg=tpt._carried(name)[1], state=tpt._state(name))
                          for name in STEP_CASES},
                "batch": _torch_batch(tpt._carried("danube")[1]),
                "dense": {"cfg": dcfg, "cases": {n: dhm.CASES[n] for n in DENSE_CASES},
                          "states": {dhm.CASES[n][0]: dhm._state(dhm.CASES[n][0])
                                     for n in DENSE_CASES},
                          "batch": dhm._batches(dcfg)[0]}}, step_tmp / "inputs.pt")
    with ThreadPoolExecutor(2) as pool:
        tp = pool.submit(W.run_world, tp_tmp, 2, WORLD_TP, 150)
        step = pool.submit(W.run_world, step_tmp, 4, WORLD_STEP, 150)
        tp.result(), step.result()
    return W.load_outputs(tp_tmp, 2), W.load_outputs(step_tmp, 4)


@pytest.mark.parametrize("name", list(ARCHS))
def test_hiddens_and_gradients_match_one_rank(worlds, name):
    h1, g1, _, _ = _one_rank(name)
    for out in worlds[0]:
        got = out[name]
        np.testing.assert_allclose(got["h"].numpy(), h1.numpy(), atol=1e-5 * float(
            h1.abs().max()), rtol=0)
        worst, at = _worst_rel_rms(_paths(got["grads"]), _paths(g1))
        assert worst <= GRAD_REL_RMS, (name, at, worst)


@pytest.mark.parametrize("name", list(ARCHS))
def test_hiddens_and_gradients_match_jax(worlds, name):
    jh, jg = _jax(name)
    got = worlds[0][0][name]
    np.testing.assert_allclose(got["h"].numpy(), jh, **F32_TOL)
    worst, at = _worst_rel_rms(_paths(got["grads"]), _paths(jg))
    assert worst <= JAX_GRAD_REL_RMS, (name, at, worst)


def test_moe_routing_bit_equal(worlds):
    _, _, routes, metrics = _one_rank("deepseek_moe")
    for out in worlds[0]:
        got = out["deepseek_moe"]
        assert len(got["routes"]) == len(routes)
        assert torch.equal(got["routes"][0], routes[0])
        assert got["metrics"]["moe_dropped_frac"] == float(metrics["moe_dropped_frac"])


@pytest.mark.parametrize("name", list(ARCHS))
def test_prefill_cache_and_unsplit_lengths(worlds, name):
    """A prefill's cache and hiddens as the unhinted run's; S = 7 (odd over
    tp 2) and a decode step (S = 1) take the unhinted path bit for bit, the
    decode issuing the same collectives."""
    for out in worlds[0]:
        sv = out[name]["serve"]
        hinted, plain = sv["prefill"]
        np.testing.assert_allclose(hinted.numpy(), plain.numpy(), atol=1e-5 * float(
            plain.abs().max()), rtol=0)
        for key, leaf in sv["cache"][1].items():
            np.testing.assert_allclose(sv["cache"][0][key].numpy(), leaf.numpy(),
                                       atol=1e-5 * max(float(leaf.abs().max()), 1.0), rtol=0,
                                       err_msg=key)
        assert torch.equal(*sv["odd"])
        (d_sp, calls_sp, bytes_sp), (d_plain, calls_plain, bytes_plain) = sv["decode"]
        assert torch.equal(d_sp, d_plain)
        assert (calls_sp, bytes_sp) == (calls_plain, bytes_plain)


def _predicted_trunk(cfg, tp):
    """The trunk collectives of one hinted forward and backward of a model
    whose attention and MLP are both split (stablelm, h2o-danube at tp 2),
    float32: at each of the two entries a layer an all-gather of the rank's
    rows (counted at the part sent) and at each exit a reduce-scatter of
    the float32 partial (counted at its whole input); after the last block
    one gather. Backward: each gather's transpose a reduce-scatter, each
    reduce-scatter's a gather, the embedding's split a gather, the head
    gather's a slice (nothing), and an all-reduce of each norm scale."""
    part, whole, d = B * S // tp * cfg.d_model * 4, B * S * cfg.d_model * 4, cfg.d_model * 4
    n = cfg.num_layers
    return {"forward": dict(calls=4 * n + 1, bytes=n * (2 * part + 2 * whole) + part),
            "recompute": dict(calls=0, bytes=0),
            "backward": dict(calls=6 * n + 1, bytes=n * (2 * whole + 2 * part + 2 * d) + part)}


@pytest.mark.parametrize("name", ["stablelm", "danube"])
def test_collectives_counted_from_the_shapes(worlds, name):
    cfg = _carried(name)[1]
    want = _predicted_trunk(cfg, 2)
    for out in worlds[0]:
        got = {p: dict(calls=c["calls"], bytes=c["bytes"]) for p, c in out[name]["trunk"].items()}
        assert got == want, (name, got, want)


def test_checkpointed_layers_keep_their_rows_alone(worlds):
    for out in worlds[0]:
        hinted, plain = out["saved"][True], out["saved"][False]
        assert len(hinted) == len(plain) == _carried("stablelm")[1].num_layers
        assert all(p == 2 * h > 0 for h, p in zip(hinted, plain)), (hinted, plain)


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_faults_fail_the_gradient_bound(worlds, fault):
    _, g1, _, _ = _one_rank("stablelm")
    worst, at = _worst_rel_rms(_paths(worlds[0][0][fault]["grads"]), _paths(g1))
    assert worst > 1e3 * GRAD_REL_RMS, (fault, at, worst)


@pytest.mark.parametrize("name", STEP_CASES)
def test_training_step_gradients_on_fsdp_mesh(worlds, name):
    want, loss = tpt._one_rank(name)
    cfg = tpt._carried(name)[1]
    for out in worlds[1]:
        got = out[name]
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-6)
        worst, at = _worst_rel_rms(_flat(got, cfg), want)
        assert worst <= GRAD_REL_RMS, (name, at, worst)


@pytest.mark.parametrize("name", DENSE_CASES)
def test_dense_heads_and_embedding_on_fsdp_mesh(worlds, name):
    """The ``softmax`` head (its sum of h's gradient over ``model`` taken
    once, after the head gather's slice) and the dense tree head with the
    dense embedding (the table's gradient whole through the split's
    all-gather) under the hint, against one rank's
    (``tests/test_torch_dense_head_mesh.py``'s references)."""
    want, loss = dhm._one_rank(name)
    cfg = dhm._cfgs()[1]
    for out in worlds[1]:
        got = out["dense", name]
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-6)
        worst, at = _worst_rel_rms(dhm._flat(got["full"], got["rows"], cfg), want)
        assert worst <= GRAD_REL_RMS, (name, at, worst)
