"""The port's model over all ten architectures (``repro_torch.models``,
``.configs``, ``.train.step``): ``tests/test_models_smoke.py`` mirrored torch
against torch, and the five families of the backbone's last slice
(mamba2-370m, hymba-1.5b, mixtral-8x22b, deepseek-moe-16b, qwen2-vl-7b)
against the JAX package on the same numpy inputs, with the reference's
``init_params`` / ``init_train_state`` carried by ``repro_torch.convert``
and the JAX side under ``jax.jit``.

Tolerances: float32 hiddens within 2e-4 absolute and relative (two layers
of float32 matmuls summed in another order, as ``tests/test_torch_lm.py``),
the MoE metrics within 1e-6 relative; M-RoPE within 1e-5 at positions
below 64 (a float32 angle's ulp there is 3.8e-6, and the two libraries'
``pow``, cos and sin round differently); the port's own prefill + decode against its full
forward within 2e-2 in float32 (the reference's own bound; MoE at a
capacity factor of 8 drops nothing). The train step, on fixed candidates
(threefry and Philox streams differ): the loss within 1e-5, and one SGD
step's update, lr times the gradient, within 1e-5 absolute.
"""
import dataclasses
import functools
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_lm_train import JFixed, TFixed

from repro import configs as jconfigs
from repro.models import layers as jlayers
from repro.models import lm_head as jlm_head
from repro.models import transformer as jtransformer
from repro.optim import OptimizerConfig as JOptimizerConfig
from repro.train import step as jstep
from repro_torch import configs as tconfigs
from repro_torch import convert, tree_util
from repro_torch.models import layers as tlayers
from repro_torch.models import lm_head as tlm_head
from repro_torch.models import specs as tspecs
from repro_torch.models import transformer as ttransformer
from repro_torch.optim import OptimizerConfig
from repro_torch.train import step as tstep

ARCHS = tconfigs.ARCHS
NEW = ["mamba2-370m", "hymba-1.5b", "mixtral-8x22b", "deepseek-moe-16b", "qwen2-vl-7b"]
F32_TOL = dict(atol=2e-4, rtol=2e-4)
STEP_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _data(cfg, batch=2, seq=16, seed=0):
    """Numpy batch as ``tests/test_models_smoke.py`` draws it: a vision arch
    takes ``num_vision_tokens`` embeddings ahead of its tokens and (3, B, S)
    positions."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32),
           "mask": np.ones((batch, seq), np.float32)}
    if cfg.modality == "vision":
        nv = cfg.num_vision_tokens
        out["tokens"] = out["tokens"][:, :seq - nv]
        out["vision_embeds"] = (0.02 * rng.standard_normal((batch, nv, cfg.d_model))
                                ).astype(np.float32)
        out["positions"] = np.broadcast_to(np.arange(seq)[None, None],
                                           (3, batch, seq)).astype(np.int32)
    return out


def _torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _carried(arch):
    """JAX float32 config and weights, the port's config and copy."""
    jcfg = dataclasses.replace(jconfigs.reduced_config(arch), dtype="float32")
    tcfg = dataclasses.replace(tconfigs.reduced_config(arch), dtype="float32")
    params = jtransformer.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = convert.lm_params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    return jcfg, tcfg, params, tparams


# ---------------------------------------------------------------------------
# tests/test_models_smoke.py, torch against torch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_jax(arch):
    for fn in ("get_config", "reduced_config"):
        assert (dataclasses.asdict(getattr(tconfigs, fn)(arch))
                == dataclasses.asdict(getattr(jconfigs, fn)(arch)))
    assert tconfigs.shape_cells(arch) == jconfigs.shape_cells(arch)
    assert tconfigs.LONG_CONTEXT_OK[arch] == jconfigs.LONG_CONTEXT_OK[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_train_step(arch):
    """One bfloat16 forward and one adversarial-NS loss with its gradients:
    shapes, finite values, a non-zero head gradient."""
    cfg = tconfigs.reduced_config(arch)
    params = ttransformer.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    data = _torch(_data(cfg))
    h, _, metrics = ttransformer.forward(params, cfg, data["tokens"],
                                         positions=data.get("positions"),
                                         vision_embeds=data.get("vision_embeds"))
    assert h.shape == (2, 16, cfg.d_model) and torch.isfinite(h.float()).all()
    assert set(metrics) == ({"moe_dropped_frac", "moe_router_entropy"} if cfg.is_moe else set())

    hcfg = tlm_head.head_config(cfg, "adversarial_ns", reg=1e-4)
    state = tlm_head.default_head_state(torch.Generator().manual_seed(1), cfg,
                                        "adversarial_ns", device="cpu")
    leaves, spec = tree_util.flatten(params)
    leaves = [t.detach().requires_grad_() for t in leaves]
    with torch.enable_grad():
        loss, _ = tstep.loss_fn(tree_util.unflatten(spec, leaves), cfg, hcfg, state, data,
                                torch.Generator().manual_seed(2))
        grads = tree_util.unflatten(spec, list(torch.autograd.grad(loss, leaves)))
    assert np.isfinite(float(loss.detach()))
    assert all(torch.isfinite(g.float()).all() for g in tree_util.flatten(grads)[0])
    assert float(grads["head"]["w"].abs().sum()) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """Prefill + stepwise decode == full forward on the same tokens (float32,
    text only, capacity factor 8: drops depend on the batch shape)."""
    cfg = dataclasses.replace(tconfigs.reduced_config(arch), modality="text",
                              num_vision_tokens=0, mrope_sections=(), dtype="float32",
                              capacity_factor=8.0)
    params = ttransformer.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 12)))
    h_full, _, _ = ttransformer.forward(params, cfg, tokens)
    cache = ttransformer.init_cache(cfg, 2, 12, dtype=torch.float32, device="cpu")
    h_pre, cache, _ = ttransformer.forward(params, cfg, tokens[:, :8], cache=cache, cache_pos=0)
    hs = [h_pre]
    for t in range(8, 12):
        h_t, cache, _ = ttransformer.forward(params, cfg, tokens[:, t:t + 1], cache=cache,
                                             cache_pos=t)
        hs.append(h_t)
    np.testing.assert_allclose(torch.cat(hs, 1).numpy(), h_full.numpy(), rtol=2e-2, atol=2e-2)


def test_full_config_shapes_without_allocation():
    """Full configs build meta-device parameters and input specs only."""
    for arch in ARCHS:
        cfg = tconfigs.get_config(arch)
        leaves = tree_util.flatten(tspecs.params_specs(cfg))[0]
        assert all(t.device.type == "meta" for t in leaves)
        assert sum(t.numel() for t in leaves) > 0
        for cell in tconfigs.shape_cells(arch).values():
            if cell is None:
                continue
            fn = {"train": tspecs.train_input_specs,
                  "prefill": tspecs.prefill_input_specs}.get(cell["mode"],
                                                             tspecs.decode_input_specs)
            specs = fn(cfg, cell["seq_len"], cell["global_batch"])
            assert specs and all(t.device.type == "meta"
                                 for t in tree_util.flatten(specs)[0])


def test_param_count_sane():
    """param_count() lands within a factor ~2 of the nameplate sizes, and
    equals the meta parameters' count up to the norms it leaves out."""
    expected = {
        "mamba2-370m": 0.37e9, "stablelm-3b": 3e9, "deepseek-7b": 7e9,
        "gemma2-27b": 27e9, "mixtral-8x22b": 141e9,
        "deepseek-moe-16b": 16e9, "hymba-1.5b": 1.5e9,
    }
    for arch, target in expected.items():
        cfg = tconfigs.get_config(arch)
        n = cfg.param_count()
        assert 0.4 * target < n < 2.5 * target, (arch, n, target)
        counted = sum(t.numel() for t in tree_util.flatten(tspecs.params_specs(cfg))[0])
        assert abs(counted - n) < 1e-3 * n, (arch, counted, n)


@pytest.mark.parametrize("arch", ["mamba2-370m", "hymba-1.5b", "deepseek-moe-16b"])
def test_init_params_dtype_casts_each_layer(arch):
    """``init_params(cast=True)`` draws the same numbers and casts as
    ``cast_params`` does: bit for bit, norms, router and SSM scalars in
    float32."""
    cfg = tconfigs.reduced_config(arch)
    want = ttransformer.cast_params(
        ttransformer.init_params(torch.Generator().manual_seed(5), cfg, device="cpu"), cfg)
    got = ttransformer.init_params(torch.Generator().manual_seed(5), cfg, device="cpu",
                                   cast=True)
    got_l, got_s = tree_util.flatten(got)
    want_l, want_s = tree_util.flatten(want)
    assert got_s == want_s
    assert all(g.dtype == w.dtype and torch.equal(g, w) for g, w in zip(got_l, want_l))
    lp = got["layers"][0]
    assert lp["norm_mix"]["scale"].dtype == torch.float32
    if "ssm" in lp:
        assert lp["ssm"]["w_in"].dtype == torch.bfloat16
        assert lp["ssm"]["conv_w"].dtype == torch.float32
    if "moe" in lp:
        assert lp["moe"]["router"].dtype == torch.float32
        assert lp["moe"]["shared"]["w_down"].dtype == torch.bfloat16


def test_serve_build_cuts_depth_and_casts():
    """The serving launcher's build: the config's depth cut by
    ``num_layers``, the expert matrices in bf16 and the router in float32,
    as ``init_params(cast=True)`` draws them."""
    from repro_torch.launch import serve as tserve
    cfg, params, _, _ = tserve.build("mixtral-8x22b", reduced=True, head="adversarial_ns",
                                     seed=3, device="cpu", num_layers=1)
    assert cfg.num_layers == 1 and len(params["layers"]) == 1
    moe = params["layers"][0]["moe"]
    assert moe["w_up"].dtype == torch.bfloat16 and moe["router"].dtype == torch.float32
    want = ttransformer.init_params(torch.Generator().manual_seed(3), cfg, device="cpu",
                                    cast=True)
    assert torch.equal(params["embed"], want["embed"])


def test_remat_carries_moe_metrics():
    """Under remat each layer's checkpoint returns its MoE metrics with its
    hiddens: the same loss, metrics and gradients as without."""
    cfg = dataclasses.replace(tconfigs.reduced_config("deepseek-moe-16b"), dtype="float32")
    params = ttransformer.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    tokens = torch.from_numpy(_data(cfg)["tokens"])
    out = []
    for remat in (False, True):
        leaves, spec = tree_util.flatten(params)
        leaves = [t.detach().requires_grad_() for t in leaves]
        with torch.enable_grad():
            h, _, metrics = ttransformer.forward(
                tree_util.unflatten(spec, leaves), dataclasses.replace(cfg, remat=remat),
                tokens, attn_impl="plain")
            grads = torch.autograd.grad((h ** 2).sum(), leaves, allow_unused=True)
        out.append((metrics, [g for g in grads if g is not None]))   # not the head
    assert set(out[1][0]) == {"moe_dropped_frac", "moe_router_entropy"}
    assert all(torch.equal(out[0][0][k], out[1][0][k]) for k in out[0][0])
    assert len(out[0][1]) == len(out[1][1]) > 0
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def test_eval_step_takes_a_vision_batch():
    """The eval step scores the text positions of a vision batch (the
    prefix carries no label), as the loss does."""
    cfg = dataclasses.replace(tconfigs.reduced_config("qwen2-vl-7b"), dtype="float32")
    state = tstep.init_train_state(torch.Generator().manual_seed(0), cfg, OptimizerConfig(),
                                   "adversarial_ns", device="cpu")
    data = _data(cfg)
    nv = cfg.num_vision_tokens
    data["labels"], data["mask"] = data["labels"][:, nv:], data["mask"][:, nv:]
    metrics = tstep.make_eval_step(cfg, tlm_head.head_config(cfg, "adversarial_ns"))(
        state, _torch(data))
    assert all(np.isfinite(float(v)) for v in metrics.values())


# ---------------------------------------------------------------------------
# Against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", NEW)
def test_forward_matches_jax(arch):
    """The jitted JAX forward against the port's (its kernel path's plain
    version on the CPU), float32, with the MoE metrics; the parameter trees
    carried by ``lm_params_from_numpy`` have the port's own structure."""
    jcfg, tcfg, params, tparams = _carried(arch)
    own = ttransformer.init_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    assert tree_util.flatten(own)[1] == tree_util.flatten(tparams)[1]
    data = _data(jcfg, seed=1)
    kw = {k: data[k] for k in ("positions", "vision_embeds") if k in data}
    hj, _, mj = jax.jit(lambda p, t, **k: jtransformer.forward(p, jcfg, t, **k))(
        params, data["tokens"], **kw)
    for impl in ("kernel", "plain"):
        ht, _, mt = ttransformer.forward(tparams, tcfg, torch.from_numpy(data["tokens"]),
                                         attn_impl=impl,
                                         **{k: torch.from_numpy(v) for k, v in kw.items()})
        np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **F32_TOL)
        assert set(mt) == set(mj)
        for k in mj:
            np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=1e-6, atol=1e-7)


def test_mrope_matches_jax():
    """M-RoPE with three distinct streams over qwen2-vl's sections; with
    three equal streams it is standard RoPE, bit for bit."""
    rng = np.random.default_rng(0)
    sections = (16, 24, 24)
    x = rng.standard_normal((2, 7, 4, 128)).astype(np.float32)
    pos = rng.integers(0, 64, (3, 2, 7)).astype(np.int32)
    want = jax.jit(lambda a, p: jlayers.apply_rope(a, p, 1e6, sections))(x, pos)
    got = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6, sections)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    same = torch.from_numpy(np.broadcast_to(pos[:1], pos.shape).copy())
    assert torch.equal(tlayers.apply_rope(torch.from_numpy(x), same, 1e6, sections),
                       tlayers.apply_rope(torch.from_numpy(x), same[0], 1e6))


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_vision_inputs_match_jax(impl):
    """qwen2-vl with vision embeddings and three distinct position streams
    (a 2 x 2 grid over the image, the index over the text). The kernel path
    takes them where the temporal stream is the index; the plain path also
    where it is not, masking by it as the reference does."""
    jcfg, tcfg, params, tparams = _carried("qwen2-vl-7b")
    rng = np.random.default_rng(2)
    nv, s = jcfg.num_vision_tokens, 12
    tokens = rng.integers(0, jcfg.vocab_size, (2, s - nv)).astype(np.int32)
    vision = (0.02 * rng.standard_normal((2, nv, jcfg.d_model))).astype(np.float32)
    grid = np.arange(nv) // 2, np.arange(nv) % 2
    text = np.arange(2, 2 + s - nv)
    streams = [np.arange(s), np.concatenate([grid[0], text]), np.concatenate([grid[1], text])]
    if impl == "plain":
        streams[0] = np.concatenate([np.zeros(nv, int), 1 + np.arange(s - nv)])
    pos = np.broadcast_to(np.stack(streams)[:, None], (3, 2, s)).astype(np.int32)
    hj, _, _ = jax.jit(lambda p, t, v, q: jtransformer.forward(
        p, jcfg, t, positions=q, vision_embeds=v))(params, tokens, vision, pos)
    ht, _, _ = ttransformer.forward(tparams, tcfg, torch.from_numpy(tokens),
                                    positions=torch.from_numpy(pos),
                                    vision_embeds=torch.from_numpy(vision), attn_impl=impl)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **F32_TOL)
    if impl == "plain":
        with pytest.raises(ValueError, match="masks by index"):
            ttransformer.forward(tparams, tcfg, torch.from_numpy(tokens),
                                 positions=torch.from_numpy(pos),
                                 vision_embeds=torch.from_numpy(vision))


@pytest.mark.parametrize("arch", NEW)
def test_prefill_and_decode_match_jax(arch):
    """``make_prefill`` and three ``make_serve_step`` steps (dense Eq. 5)
    against the reference's, float32 caches: the prefill hiddens, the
    tokens, and the cache leaves after the last step. qwen2-vl prefills a
    vision prefix and decodes with (3, B, 1) positions."""
    jcfg, tcfg, params, tparams = _carried(arch)
    jstate = jlm_head.default_head_state(jax.random.PRNGKey(1), jcfg, "adversarial_ns")
    tstate = convert.lm_head_state_from_numpy(
        np.asarray(jstate.proj), [np.asarray(a) for a in jstate.gen.tree], device="cpu")
    jh = jlm_head.head_config(jcfg, "adversarial_ns")
    th = tlm_head.head_config(tcfg, "adversarial_ns")
    data = _data(jcfg, seq=10, seed=4)
    s = 10
    kw = {k: data[k] for k in ("vision_embeds", "positions") if k in data}
    jcache = jtransformer.init_cache(jcfg, 2, s + 3, dtype=jnp.float32)
    tcache = ttransformer.init_cache(tcfg, 2, s + 3, dtype=torch.float32, device="cpu")
    hj, jcache = jax.jit(jstep.make_prefill(jcfg))(params, data["tokens"], jcache, **kw)
    htt, tcache = tstep.make_prefill(tcfg)(
        tparams, torch.from_numpy(data["tokens"]), tcache,
        **{k: torch.from_numpy(v) for k, v in kw.items()})
    np.testing.assert_allclose(htt.numpy(), np.asarray(hj), **F32_TOL)
    jserve = jax.jit(jstep.make_serve_step(jcfg, jh))
    tserve = tstep.make_serve_step(tcfg, th)
    jtok = ttok = data["tokens"][:, -1:]
    for t in range(3):
        pos = (np.full((3, 2, 1), s + t, np.int32) if jcfg.mrope_sections else None)
        jtok, jcache = jserve(params, jstate, jnp.asarray(jtok), jcache, jnp.int32(s + t),
                              positions=pos)
        ttok, tcache = tserve(tparams, tstate, torch.as_tensor(np.asarray(ttok)), tcache, s + t,
                              positions=None if pos is None else torch.from_numpy(pos))
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    for key in jcache:
        np.testing.assert_allclose(tcache[key].numpy(), np.asarray(jcache[key]), **F32_TOL)


@pytest.mark.parametrize("arch", NEW)
def test_train_step_matches_jax(arch):
    """One sparse-head, sparse-embedding SGD step on fixed candidates: the
    loss and metrics (the MoE's included) and every parameter's update. The
    vision batch carries labels for its text only."""
    jcfg = dataclasses.replace(jconfigs.reduced_config(arch), dtype="float32")
    tcfg = dataclasses.replace(tconfigs.reduced_config(arch), dtype="float32")
    jopt = JOptimizerConfig(name="sgd", learning_rate=0.5)
    jstate = jstep.init_train_state(jax.random.PRNGKey(0), jcfg, jopt, "adversarial_ns")
    tstate = convert.train_state_from_numpy(jax.tree.map(np.asarray, jstate), device="cpu")
    before = [t.clone() for t in tree_util.flatten(tstate.params)[0]]
    data = _data(jcfg, seed=5)
    if jcfg.modality == "vision":
        data["labels"] = data["labels"][:, jcfg.num_vision_tokens:]
        data["mask"] = data["mask"][:, jcfg.num_vision_tokens:]
    # tests/test_torch_lm_train.py's fixed sampler: step 1's candidates.
    rng = np.random.default_rng(6)
    ids = rng.integers(0, jcfg.vocab_size, (2,) + data["labels"].shape + (1,)).astype(np.int32)
    table = np.log(rng.dirichlet(np.ones(jcfg.vocab_size))).astype(np.float32)
    jh = jlm_head.head_config(jcfg, "adversarial_ns", reg=1e-4)
    th = tlm_head.head_config(tcfg, "adversarial_ns", reg=1e-4)
    jnew, jm = jax.jit(jstep.make_train_step(jcfg, jh, jopt, sampler=JFixed(
        jnp.asarray(ids), jnp.asarray(table))))(jstate, data, jax.random.PRNGKey(1))
    tnew, tm = tstep.make_train_step(tcfg, th, OptimizerConfig(name="sgd", learning_rate=0.5),
                                     sampler=TFixed(ids, table))(
        tstate, _torch(data), torch.Generator().manual_seed(1))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **STEP_TOL)
    for k in ("moe_dropped_frac", "moe_router_entropy"):
        assert (k in tm) == (k in jm) == jcfg.is_moe
        if k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6, atol=1e-7)
    want = convert._lm_tree(jax.tree.map(np.asarray, jnew.params), torch.device("cpu"),
                            n_layers=jcfg.num_layers)
    want_l, want_s = tree_util.flatten(want)
    got_l, got_s = tree_util.flatten(tnew.params)
    assert got_s == want_s
    for i, (b, g, w) in enumerate(zip(before, got_l, want_l)):
        np.testing.assert_allclose((g - b).numpy(), (w - b).numpy(), **STEP_TOL,
                                   err_msg=f"leaf {i}")
    assert any(float((g - b).abs().max()) > 0 for b, g in zip(before, got_l))

