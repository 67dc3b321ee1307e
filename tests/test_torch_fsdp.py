"""FSDP over the mesh's ``data`` axis, on gloo ranks on the CPU: each trunk
matrix cut over ``data`` along the dim ``param_spec`` names (inside its
``model`` part), gathered a layer at a time in the forward and its
gradient reduce-scattered back, against the port's one-rank step and the
JAX package's.

A (2, 2) world of 4 ranks, reduced configs in float32 unless named:
- Gradients of one sparse step (``make_grad_fn(mesh=)``) for h2o-danube,
  deepseek-moe (experts split), mixtral with 3 experts (each expert's
  ``d_ff`` split), mamba2 and hymba (hinted): every leaf, gathered, within
  1e-5 relative RMS of one rank's; every leaf a rank holds whole, and the
  sparse rows, bit-equal across ranks. Two planted faults fail that bound:
  one leaf's gradient taken without its reduce-scatter, and every FSDP
  leaf's gradient summed over ``data`` a second time.
- The hints, deepseek-moe in bfloat16: ``fsdp_gather_weights`` gives the
  unhinted gradients bit for bit with the expert leaves' gather bytes
  halved and the same collectives; ``hint_expert_act`` (a context without
  the FSDP hint) changes no bit and no count.
- Memory: no gathered weight is saved for the backward (the layer runs
  under a checkpoint whose recompute gathers again); with the checkpoint
  planted away, every layer's gathered weights are.
- Checkpoints: written under FSDP leaf by leaf, restored by one process
  bit-equal, and a one-rank checkpoint restored on the mesh bit-equal to
  each rank's part.
- Steps: three steps of Adagrad, AdamW and SM3 on (2, 2) and on a (2, 1)
  world against the JAX package's one-device step on the same candidates,
  at the reference's bounds (``tests/test_parallel.py:65-71``: the loss
  1e-5 relative, the parameters 1e-3 relative plus 1e-4), the clip's norm
  equal on every rank.

Sampling is held fixed as in ``tests/test_torch_parallel_train.py``.
"""
import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from test_torch_parallel_train import TFixed, _batch, _draws, _jfixed
from test_torch_tp_train import _flat, _worst_rel_rms

import _torch_world as W
from repro_torch import configs as tconfigs
from repro_torch import convert, tree_util
from repro_torch.models import lm_head as tlm_head
from repro_torch.optim import OptimizerConfig
from repro_torch.parallel import sharding
from repro_torch.train import step as tstep

CASES = {   # name: (arch, config overrides, hinted)
    "danube": ("h2o-danube-3-4b", {}, False),
    "deepseek_moe": ("deepseek-moe-16b", {}, False),
    "mixtral_3_experts": ("mixtral-8x22b", {"n_experts": 3}, False),
    "mamba2": ("mamba2-370m", {}, False),
    "hymba_hinted": ("hymba-1.5b", {}, True),
}
GRAD_REL_RMS = 1e-5
STEPS = 3
# eps 1e-3: the first steps of these rules, -lr·g/(|g| + eps) and its kin,
# turn the float32 reordering of a data-parallel sum at |g| near eps into
# parameter jumps (a property of the rules, which the reference's own mesh
# test meets by taking one step); at 1e-3 a reordering moves a parameter
# by about lr·1e3 times the gradient's own rounding.
RULES = {"adagrad": dict(name="adagrad", learning_rate=0.05, eps=1e-3, clip_norm=1.0),
         "adamw": dict(name="adamw", learning_rate=0.01, weight_decay=0.1, eps=1e-3,
                       clip_norm=1.0),
         "sm3": dict(name="sm3", learning_rate=0.05, eps=1e-3, clip_norm=1.0)}
REF_TOL = dict(atol=1e-4, rtol=1e-3)           # tests/test_parallel.py:65-70
EXPERTS = ("moe/w_gate", "moe/w_up", "moe/w_down")

WORLD = """
import contextlib
import types
from repro_torch import tree_util
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.core.samplers import UniformSampler
from repro_torch.models import lm_head, transformer
from repro_torch.optim import OptimizerConfig
from repro_torch.parallel import collectives, gather_train_state, shard_train_state, sharding
from repro_torch.parallel import iter_gathered_leaves
from repro_torch.parallel.collectives import FSDP, TRUNK
from repro_torch.parallel.hints import sharding_hints
from repro_torch.train import step as tstep
import _torch_world as W

inp = torch.load(os.path.join(OUT, "inputs.pt"), weights_only=False)
mesh = mesh_of(inp["tp"])
out = {}


def grads_of(case, hints=None):
    cfg = case["cfg"]
    hcfg = lm_head.head_config(cfg, "adversarial_ns", n_neg=1, reg=1e-4)
    state = shard_train_state(case["state"], mesh, cfg)
    fn = tstep.make_grad_fn(cfg, hcfg, sampler=UniformSampler(cfg.vocab_size), mesh=mesh)
    TRUNK.reset()
    FSDP.reset()
    with sharding_hints(mesh, **hints) if hints is not None else contextlib.nullcontext():
        grads, metrics = fn(state, inp["batch"], torch.Generator().manual_seed(0))
    trunk = {k: v for k, v in grads.items() if k not in ("head", "embed")}
    return dict(local=trunk, full=gather_train_state(trunk, mesh, cfg),
                head=W.whole_rows(mesh, grads["head"]), embed=W.whole_rows(mesh, grads["embed"]),
                loss=float(metrics["loss"]),
                trunk={p: dict(c) for p, c in TRUNK.phases.items()},
                fsdp={p: dict(c) for p, c in FSDP.phases.items()},
                fsdp_leaves=dict(FSDP.leaves),
                part_shapes=[tuple(x.shape) for x in tree_util.leaves(state.params)])


def steps(cfg, rule, state):
    hcfg = lm_head.head_config(cfg, "adversarial_ns", n_neg=1, reg=1e-4)
    step = tstep.make_train_step(cfg, hcfg, OptimizerConfig(**rule),
                                 sampler=UniformSampler(cfg.vocab_size), mesh=mesh)
    state = shard_train_state(state, mesh, cfg)      # each rule's own input state
    metrics = []
    for s, batch in enumerate(inp["batches"]):
        state, m = step(state, batch, torch.Generator().manual_seed(s))
        metrics.append({k: float(v) for k, v in m.items()})
    return dict(metrics=metrics, params=gather_train_state(state.params, mesh, cfg))


for name, rule in inp["rules"].items():
    out["steps", name] = steps(inp["step_cfg"], rule, inp["step_states"][name])

if inp["tp"] == 2:
    for name, case in inp["cases"].items():
        out[name] = grads_of(case, {} if case["hinted"] else None)

    # The hints, deepseek-moe in bf16.
    moe = inp["moe_bf16"]
    out["moe", "plain"] = grads_of(moe)
    out["moe", "expert_act"] = grads_of(moe, {})
    out["moe", "gathered_weight"] = grads_of(moe, {"fsdp_gather_weights": True})

    # Planted: one FSDP leaf's gradient left without its reduce-scatter.
    backward = collectives._GatherOverData.backward

    def unsummed_first(ctx, *grads):
        res = list(backward(ctx, *grads))
        dp = sharding.size(ctx.mesh, "data")
        mine = grads[0].chunk(dp, ctx.dims[0])[sharding.rank(ctx.mesh, "data")]
        res[4] = mine.contiguous().to(res[4].dtype)
        return tuple(res)

    collectives._GatherOverData.backward = staticmethod(unsummed_first)
    out["fault_no_reduce_scatter"] = grads_of(inp["cases"]["danube"])
    collectives._GatherOverData.backward = staticmethod(backward)

    # Planted: FSDP leaves summed over data again after their reduce-scatter.
    proxy = types.SimpleNamespace(**vars(sharding))
    proxy.split_axes = lambda sp, m: {k: v for k, v in sharding.split_axes(sp, m).items()
                                      if k != "data"}
    tstep.sharding = proxy
    out["fault_summed_twice"] = grads_of(inp["cases"]["danube"])
    tstep.sharding = sharding

    # Memory: the gathered weights saved for the backward, by storage.
    mem = inp["memory"]
    cfg = mem["cfg"]
    params = shard_train_state(mem["params"], mesh, cfg)
    gathered = {}
    gather = collectives.gather_over_data

    calls = []

    def recorded(*a, **kw):
        full = gather(*a, **kw)
        for x in full:
            gathered[x.untyped_storage().data_ptr()] = x.untyped_storage().nbytes()
        calls.append(sum(x.untyped_storage().nbytes() for x in full))
        return full

    def saved_gathered_bytes():
        seen = {}

        def pack(t):
            st = t.untyped_storage()
            if st.data_ptr() in gathered:
                seen[st.data_ptr()] = st.nbytes()
            return t

        trunk = tree_util.tree_map(lambda t: t.detach().requires_grad_(),
                                   {k: v for k, v in params.items() if k != "head"})
        gathered.clear()
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            h = transformer.forward(trunk, cfg, mem["tokens"], attn_impl="plain", mesh=mesh)[0]
        torch.autograd.grad(h.pow(2).sum(), tree_util.leaves(trunk))
        return sum(seen.values())

    collectives.gather_over_data = recorded
    out["memory"] = dict(saved=saved_gathered_bytes())
    real = transformer.checkpoint_lib
    transformer.checkpoint_lib = types.SimpleNamespace(
        checkpoint=lambda fn, *a, use_reentrant, context_fn: fn(*a))
    out["memory"]["saved_without_checkpoint"] = saved_gathered_bytes()
    transformer.checkpoint_lib = real
    collectives.gather_over_data = gather
    out["memory"]["layer_bytes"] = calls[0]      # one layer's gathered leaves

    # Checkpoints across meshes.
    ck = inp["ckpt"]
    local = shard_train_state(ck["state"], mesh, ck["cfg"])
    tree = local.as_pytree()
    leaves = iter_gathered_leaves(tree, mesh, ck["cfg"])
    if RANK == 0:
        save_checkpoint(os.path.join(OUT, "ckpt"), 1, tree, leaves=leaves)
    else:
        for _ in leaves:
            pass
    torch.distributed.barrier()
    part, _ = restore_checkpoint(ck["one"], tree,
                                 layout=sharding.StateLayout(tree, mesh, ck["cfg"]))
    out["ckpt_part_equal"] = all(
        torch.equal(a, b) if isinstance(b, torch.Tensor) else a == b
        for a, b in zip(tree_util.leaves(part), tree_util.leaves(tree)))
save(out)
"""


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(arch, **over):
    return dataclasses.replace(tconfigs.reduced_config(arch), **{"dtype": "float32", **over})


@functools.lru_cache(maxsize=None)
def _state(name):
    arch, over, _ = CASES[name]
    return tstep.init_train_state(torch.Generator().manual_seed(1), _cfg(arch, **over),
                                  OptimizerConfig(name="sgd"), "adversarial_ns",
                                  device="cpu")


def _torch_batch(cfg, step=0):
    return {k: torch.as_tensor(v) for k, v in _batch(cfg, step).items()}


@functools.lru_cache(maxsize=None)
def _jax_steps_state():
    """The JAX side's config and initial states. Its layers are unstacked
    (``scan_layers=False``), so that SM3 factors each 2-D layer leaf as the
    port does (a stacked 3-D leaf keeps a full accumulator)."""
    import jax
    from repro import configs as jconfigs
    from repro.optim import OptimizerConfig as JOptimizerConfig
    from repro.train import step as jstep
    jcfg = dataclasses.replace(jconfigs.reduced_config("stablelm-3b"), dtype="float32",
                               scan_layers=False)
    return jcfg, {name: jax.jit(lambda k, r=rule: jstep.init_train_state(
        k, jcfg, JOptimizerConfig(**r), "adversarial_ns"))(jax.random.PRNGKey(0))
        for name, rule in RULES.items()}


def _stack(tree):
    """A JAX params-shaped tree with its layer list stacked, as numpy."""
    import jax
    if tree is None:
        return None
    return {**tree, "layers": jax.tree.map(lambda *xs: np.stack(xs), *tree["layers"])}


def _carried(jstate):
    """The port's state from a JAX ``TrainState`` of unstacked layers."""
    import jax
    st = jax.tree.map(np.asarray, jstate)
    opt = st.opt_state
    return convert.train_state_from_numpy(st._replace(
        params=_stack(st.params), opt_state=opt._replace(
            mu=_stack(opt.mu), nu=_stack(opt.nu), last=_stack(opt.last))), device="cpu")


def _ckpt_state():
    """A one-rank SM3 state with every float leaf random."""
    cfg = _cfg("hymba-1.5b")
    state = tstep.init_train_state(torch.Generator().manual_seed(2), cfg,
                                   OptimizerConfig(name="sm3"), "adversarial_ns", device="cpu")
    gen = torch.Generator().manual_seed(3)
    return cfg, tree_util.tree_map(
        lambda t: torch.rand(t.shape, generator=gen)
        if isinstance(t, torch.Tensor) and t.is_floating_point() else t, state)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    from repro_torch.checkpoint import save_checkpoint
    jcfg, jstates = _jax_steps_state()
    step_cfg = _cfg("stablelm-3b")
    step_states = {name: _carried(s) for name, s in jstates.items()}
    cases = {name: dict(cfg=_cfg(arch, **over), state=_state(name), hinted=hinted)
             for name, (arch, over, hinted) in CASES.items()}
    moe_cfg = tconfigs.reduced_config("deepseek-moe-16b")          # bfloat16
    moe = dict(cfg=moe_cfg, state=tstep.init_train_state(
        torch.Generator().manual_seed(4), moe_cfg, OptimizerConfig(name="sgd"),
        "adversarial_ns", device="cpu"), hinted=False)
    mem_cfg = _cfg("stablelm-3b")
    ck_cfg, ck_state = _ckpt_state()
    out = {}
    for tp, n_ranks in ((2, 4), (1, 2)):
        out[n_ranks] = tmp = tmp_path_factory.mktemp(f"fsdp{n_ranks}")
        inp = {"tp": tp, "rules": RULES, "step_cfg": step_cfg, "step_states": step_states,
               "batches": [_torch_batch(step_cfg, s) for s in range(STEPS)]}
        if tp == 2:
            save_checkpoint(str(tmp / "one"), 1, ck_state.as_pytree())
            inp.update(cases=cases, moe_bf16=moe, batch=_torch_batch(cases["danube"]["cfg"]),
                       memory=dict(cfg=mem_cfg, params=tstep.init_train_state(
                           torch.Generator().manual_seed(5), mem_cfg,
                           OptimizerConfig(name="sgd"), "adversarial_ns",
                           device="cpu").params,
                           tokens=_torch_batch(mem_cfg)["tokens"]),
                       ckpt=dict(cfg=ck_cfg, state=ck_state, one=str(tmp / "one")))
        torch.save(inp, tmp / "inputs.pt")
    with ThreadPoolExecutor(2) as pool:        # the two worlds side by side
        list(pool.map(lambda n: W.run_world(out[n], n, WORLD, timeout=150), out))
    return {n: dict(tmp=tmp, outs=W.load_outputs(tmp, n)) for n, tmp in out.items()}


@functools.lru_cache(maxsize=None)
def _one_rank(name):
    cfg = _cfg(CASES[name][0], **CASES[name][1])
    hcfg = tlm_head.head_config(cfg, "adversarial_ns", n_neg=1, reg=1e-4)
    fn = tstep.make_grad_fn(cfg, hcfg, sampler=TFixed(_draws(cfg), cfg.vocab_size))
    grads, metrics = fn(_state(name), _torch_batch(cfg), torch.Generator().manual_seed(0))
    trunk = {k: v for k, v in grads.items() if k not in ("head", "embed")}
    return _flat(dict(full=trunk, head=grads["head"], embed=grads["embed"]), cfg), \
        float(metrics["loss"])


@pytest.mark.parametrize("name", list(CASES))
def test_fsdp_gradients_match_one_rank(worlds, name):
    want, loss = _one_rank(name)
    cfg = _cfg(CASES[name][0], **CASES[name][1])
    ranks = worlds[4]["outs"]
    split = sharding.split_dims(cfg, (2, 2), _state(name).params)
    cut = sum(p[:2] == ("layers", "0") and "data" in ax for p, ax in split.items())
    for out in ranks:
        got = out[name]
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-6)
        worst, at = _worst_rel_rms(_flat(got, cfg), want)
        assert worst <= GRAD_REL_RMS, (name, at, worst)
        # One gather a layer in the forward and again in its recompute, one
        # reduce-scatter a cut leaf.
        assert got["fsdp"]["forward"]["calls"] == got["fsdp"]["recompute"]["calls"] \
            == cfg.num_layers
        assert got["fsdp"]["backward"]["calls"] == cfg.num_layers * cut > 0
    for out in ranks[1:]:
        for path, g in tree_util.flatten_with_paths(out[name]["local"])[0]:
            if path not in split:
                ref = dict(tree_util.flatten_with_paths(ranks[0][name]["local"])[0])[path]
                assert torch.equal(g, ref), (name, path)
        for key in ("head", "embed"):
            for a, b in zip(out[name][key], ranks[0][name][key]):
                assert (a is None and b is None) or torch.equal(a, b), (name, key)


@pytest.mark.parametrize("fault", ["fault_no_reduce_scatter", "fault_summed_twice"])
def test_planted_faults_fail_the_gradient_bound(worlds, fault):
    want, _ = _one_rank("danube")
    got = worlds[4]["outs"][0][fault]
    worst, at = _worst_rel_rms(_flat(got, _cfg("h2o-danube-3-4b")), want)
    assert worst > 1e3 * GRAD_REL_RMS, (fault, at, worst)


def test_fsdp_gather_weights_hint_is_bit_equal_with_half_the_expert_bytes(worlds):
    for out in worlds[4]["outs"]:
        plain, hinted = out["moe", "plain"], out["moe", "gathered_weight"]
        for a, b in zip(tree_util.leaves(plain["local"]), tree_util.leaves(hinted["local"])):
            assert torch.equal(a, b)
        assert plain["loss"] == hinted["loss"]
        for key in ("head", "embed"):
            for a, b in zip(plain[key], hinted[key]):
                assert (a is None and b is None) or torch.equal(a, b)
        for leaf, n in plain["fsdp_leaves"].items():
            assert hinted["fsdp_leaves"][leaf] == (n // 2 if leaf in EXPERTS else n), leaf
        assert all(leaf in plain["fsdp_leaves"] for leaf in EXPERTS)
        for kind in ("trunk", "fsdp"):
            for phase, c in plain[kind].items():
                assert hinted[kind][phase]["calls"] == c["calls"], (kind, phase)
        assert hinted["trunk"] == plain["trunk"]


def test_hint_expert_act_changes_no_bit_and_no_collective(worlds):
    for out in worlds[4]["outs"]:
        plain, act = out["moe", "plain"], out["moe", "expert_act"]
        for a, b in zip(tree_util.leaves(plain["local"]), tree_util.leaves(act["local"])):
            assert torch.equal(a, b)
        assert act["trunk"] == plain["trunk"] and act["fsdp"] == plain["fsdp"]
        assert act["fsdp_leaves"] == plain["fsdp_leaves"]


def test_gathered_weights_are_not_saved_for_the_backward(worlds):
    """With the trunk's remat off, a layer's gathered weights die with its
    forward: none is saved, so at the backward's start a rank holds its
    parts and at most the layer being recomputed. The planted fault (the
    checkpoint taken away) saves every layer's."""
    for out in worlds[4]["outs"]:
        mem = out["memory"]
        assert mem["saved"] <= mem["layer_bytes"]
        assert mem["saved_without_checkpoint"] >= 2 * mem["layer_bytes"] > 0


def test_checkpoints_restore_across_meshes_bit_equal(worlds):
    from repro_torch.checkpoint import restore_checkpoint
    _, state = _ckpt_state()
    restored, _ = restore_checkpoint(str(worlds[4]["tmp"] / "ckpt"), state.as_pytree())
    for a, b in zip(tree_util.leaves(restored), tree_util.leaves(state.as_pytree())):
        assert torch.equal(a, b) if isinstance(b, torch.Tensor) else a == b
    assert all(out["ckpt_part_equal"] for out in worlds[4]["outs"])


@pytest.mark.parametrize("rule", list(RULES))
@pytest.mark.parametrize("n_ranks", [4, 2])
def test_fsdp_steps_match_jax(worlds, rule, n_ranks):
    """Three steps on (2, 2) and (2, 1) against the JAX package's one-device
    step on the same candidates; the clip's norm equal on every rank."""
    import jax
    from repro.models import lm_head as jlm_head
    from repro.optim import OptimizerConfig as JOptimizerConfig
    from repro.train import step as jstep
    jcfg, jstates = _jax_steps_state()
    tcfg = _cfg("stablelm-3b")
    jh = jlm_head.head_config(jcfg, "adversarial_ns", n_neg=1, reg=1e-4)
    jfn = jax.jit(jstep.make_train_step(jcfg, jh, JOptimizerConfig(**RULES[rule]),
                                        sampler=_jfixed(_draws(tcfg), jcfg.vocab_size)))
    jstate, losses = jstates[rule], []
    for s in range(STEPS):
        batch = {k: np.asarray(v) for k, v in _batch(tcfg, s).items()}
        jstate, jm = jfn(jstate, batch, jax.random.PRNGKey(s))
        losses.append(float(jm["loss"]))
    want = convert._lm_tree(_stack(jax.tree.map(np.asarray, jstate.params)),
                            torch.device("cpu"), n_layers=tcfg.num_layers)
    outs = worlds[n_ranks]["outs"]
    for out in outs:
        got = out["steps", rule]
        np.testing.assert_allclose([m["loss"] for m in got["metrics"]], losses, rtol=1e-5)
        assert [m["grad_norm"] for m in got["metrics"]] == \
            [m["grad_norm"] for m in outs[0]["steps", rule]["metrics"]]
        for g, w in zip(tree_util.leaves(got["params"]), tree_util.leaves(want)):
            np.testing.assert_allclose(g.numpy(), w.numpy(), **REF_TOL)
