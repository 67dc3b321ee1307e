"""The port's LM serving slice (``repro_torch.models``, ``.train.step``,
``.launch.serve``) against the JAX package, on reduced h2o-danube-3-4b (GQA,
window 8), gemma2-27b (attention softcap, local/global windows, final
softcap) and stablelm-3b (MHA, full attention).

The JAX side runs under ``jax.jit``; its ``init_params`` weights and
``default_head_state`` tree are carried across with ``repro_torch.convert``.
Tolerances: float32 hiddens and scores within 2e-4 absolute and relative
(two layers of float32 matmuls, RoPE's cos/sin and the softmax summed in
another order; the hiddens leave an RMSNorm at unit scale); bfloat16 hiddens
within 6e-2 (a bfloat16 ulp is 2^-8 relative, rounded at every matmul and
residual add of two layers, and the reference rounds the attention
probabilities to bfloat16 where the port keeps them in float32). The port's
own prefill + decode against its full forward is torch against torch, in
float32, within 1e-5.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as jlayers
from repro.models import lm_head as jlm_head
from repro.models import transformer as jtransformer
from repro.train import step as jstep
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.core.heads import HeadParams
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as tlayers
from repro_torch.models import lm_head as tlm_head
from repro_torch.models import transformer as ttransformer
from repro_torch.train import step as tstep

ARCHS = ["h2o-danube-3-4b", "gemma2-27b", "stablelm-3b"]
F32_TOL = dict(atol=2e-4, rtol=2e-4)
BF16_TOL = dict(atol=6e-2, rtol=6e-2)
SELF_TOL = dict(atol=1e-5, rtol=1e-5)
BATCH, SEQ, PROMPT = 2, 16, 10


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


@functools.lru_cache(maxsize=None)
def _carried(arch):
    """JAX weights and head state, and the port's copies of them."""
    jcfg = jconfigs.reduced_config(arch)
    params = jtransformer.init_params(jax.random.PRNGKey(0), jcfg)
    state = jlm_head.default_head_state(jax.random.PRNGKey(1), jcfg, "adversarial_ns")
    tparams = convert.lm_params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    tstate = convert.lm_head_state_from_numpy(
        np.asarray(state.proj), [np.asarray(a) for a in state.gen.tree], device="cpu")
    tokens = np.random.default_rng(len(arch)).integers(0, jcfg.vocab_size, (BATCH, SEQ))
    return jcfg, params, state, tparams, tstate, tokens


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_copies(arch):
    for fn in ("get_config", "reduced_config"):
        want = dataclasses.asdict(getattr(jconfigs, fn)(arch))
        got = dataclasses.asdict(getattr(tconfigs, fn)(arch))
        assert got == want
    full = tconfigs.get_config(arch)
    assert full.param_count() == jconfigs.get_config(arch).param_count()
    assert full.layer_windows() == jconfigs.get_config(arch).layer_windows()


@pytest.mark.parametrize("arch", ["mamba2-370m", "hymba-1.5b", "mixtral-8x22b",
                                  "deepseek-moe-16b", "qwen2-vl-7b"])
def test_unported_archs_raise(arch):
    """The five architectures the model once refused are copies now, and
    the model builds them (``tests/test_torch_model_families.py`` holds them
    against JAX)."""
    for fn in ("get_config", "reduced_config"):
        assert (dataclasses.asdict(getattr(tconfigs, fn)(arch))
                == dataclasses.asdict(getattr(jconfigs, fn)(arch)))
    cfg = tconfigs.reduced_config(arch)
    params = ttransformer.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert len(params["layers"]) == cfg.num_layers


def test_carried_params_have_the_port_layout():
    jcfg, params, _, tparams, _, _ = _carried("h2o-danube-3-4b")
    assert len(tparams["layers"]) == jcfg.num_layers
    for i, lp in enumerate(tparams["layers"]):
        np.testing.assert_array_equal(lp["attn"]["wq"].numpy(),
                                      np.asarray(params["layers"]["attn"]["wq"][i]))
        assert lp["attn"]["wk"].shape == (jcfg.d_model, jcfg.num_kv_heads,
                                          jcfg.resolved_head_dim)
    assert tparams["head"]["w"].shape == (jcfg.padded_vocab, jcfg.d_model)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax_float32(arch):
    jcfg, params, _, tparams, _, tokens = _carried(arch)
    cfg = _f32(jcfg)
    want = jax.jit(lambda p, t: jtransformer.forward(p, cfg, t)[0])(params, jnp.asarray(tokens))
    got, _, _ = ttransformer.forward(tparams, _f32(tconfigs.reduced_config(arch)),
                                     torch.from_numpy(tokens))
    assert got.dtype == torch.float32 and got.shape == (BATCH, SEQ, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_forward_matches_jax_bfloat16():
    arch = "h2o-danube-3-4b"
    jcfg, params, _, tparams, _, tokens = _carried(arch)
    want = jax.jit(lambda p, t: jtransformer.forward(p, jcfg, t)[0])(params, jnp.asarray(tokens))
    got, _, _ = ttransformer.forward(tparams, tconfigs.reduced_config(arch),
                                     torch.from_numpy(tokens))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **BF16_TOL)


def test_cast_params_is_the_same_function():
    arch = "gemma2-27b"
    _, _, _, tparams, _, tokens = _carried(arch)
    cfg = tconfigs.reduced_config(arch)
    cast = ttransformer.cast_params(tparams, cfg)
    assert cast["layers"][0]["mlp"]["w_up"].dtype == torch.bfloat16
    assert cast["head"]["w"].dtype == torch.float32
    assert cast["layers"][0]["norm_mix"]["scale"].dtype == torch.float32
    a, _, _ = ttransformer.forward(tparams, cfg, torch.from_numpy(tokens))
    b, _, _ = ttransformer.forward(cast, cfg, torch.from_numpy(tokens))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_rope_matches_jax_at_long_positions():
    """RoPE at the serving cell's positions (up to 4,640): the angle is
    pos * inv_freq in float32, and the two frameworks' pow may differ by an
    ulp in inv_freq, which moves cos/sin by up to ~pos * 6e-8 = 3e-4."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 3, 120)).astype(np.float32)
    pos = np.array([[0, 1, 4095, 4096, 4639], [7, 100, 2048, 3000, 4600]])
    want = jax.jit(lambda a, p: jlayers.apply_rope(a, p, 10_000.0))(jnp.asarray(x),
                                                                    jnp.asarray(pos))
    got = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("window", [0, 4])
def test_causal_window_mask_matches_jax(window):
    want = np.asarray(jlayers.causal_window_mask(10, window))
    np.testing.assert_array_equal(tlayers.causal_window_mask(10, window).numpy(), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_full_forward(arch):
    """torch against torch: prefill + stepwise decode through the cache ==
    the cache-free forward on the same tokens (float32, float32 cache)."""
    _, _, _, tparams, _, tokens = _carried(arch)
    cfg = _f32(tconfigs.reduced_config(arch))
    toks = torch.from_numpy(tokens)
    full, _, _ = ttransformer.forward(tparams, cfg, toks)
    cache = ttransformer.init_cache(cfg, BATCH, SEQ, dtype=torch.float32, device="cpu")
    h_pre, cache, _ = ttransformer.forward(tparams, cfg, toks[:, :PROMPT], cache=cache,
                                           cache_pos=0)
    torch.testing.assert_close(h_pre, full[:, :PROMPT], **SELF_TOL)
    for t in range(PROMPT, SEQ):
        h_t, cache, _ = ttransformer.forward(tparams, cfg, toks[:, t:t + 1], cache=cache,
                                             cache_pos=torch.tensor(t))
        torch.testing.assert_close(h_t[:, 0], full[:, t], **SELF_TOL)


def _prefilled(arch):
    """Both packages' float32 models after a prefill of PROMPT tokens into a
    float32 cache of SEQ positions."""
    jcfg, params, state, tparams, tstate, tokens = _carried(arch)
    cfg, tcfg = _f32(jcfg), _f32(tconfigs.reduced_config(arch))
    prompt = tokens[:, :PROMPT]
    jcache = jtransformer.init_cache(cfg, BATCH, SEQ, dtype=jnp.float32)
    _, jcache = jax.jit(jstep.make_prefill(cfg))(params, jnp.asarray(prompt), jcache)
    tcache = ttransformer.init_cache(tcfg, BATCH, SEQ, dtype=torch.float32, device="cpu")
    _, tcache = tstep.make_prefill(tcfg)(tparams, torch.from_numpy(prompt), tcache)
    return cfg, tcfg, params, state, tparams, tstate, prompt, jcache, tcache


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_step_scores_match_jax(arch):
    """One decode step after the prefill, compared by scores: the dense
    Eq. 5 scores and the beam top-k scores from the decode step's hidden,
    and each serve step's token scores the JAX maximum (dense) or the JAX
    score of its label (beam)."""
    cfg, tcfg, params, state, tparams, tstate, prompt, jcache, tcache = _prefilled(arch)
    hcfg, thcfg = (jlm_head.head_config(cfg, "adversarial_ns"),
                   tlm_head.head_config(tcfg, "adversarial_ns"))
    token = prompt[:, -1:]

    @jax.jit
    def jax_scores(p, c):
        h, _, _ = jtransformer.forward(p, cfg, jnp.asarray(token), cache=c,
                                       cache_pos=jnp.int32(PROMPT))
        hp = jlm_head.HeadParams(**p["head"])
        dense = jlm_head.lm_predictive_scores(cfg, hcfg, hp, state, h[:, -1])
        top, labels = jlm_head.lm_predictive_topk(cfg, hcfg, hp, state, h[:, -1],
                                                  topk=5, beam=16)
        return dense, top, labels

    dense, top, labels = (np.asarray(a) for a in jax_scores(params, jcache))
    jtok, _ = jax.jit(jstep.make_serve_step(cfg, hcfg))(
        params, state, jnp.asarray(token), jcache, jnp.int32(PROMPT))

    th, _, _ = ttransformer.forward(tparams, tcfg, torch.from_numpy(token),
                                    cache={k: v.clone() for k, v in tcache.items()},
                                    cache_pos=PROMPT)
    hp = HeadParams(**tparams["head"])
    tdense = tlm_head.lm_predictive_scores(tcfg, thcfg, hp, tstate, th[:, -1])
    ttop, tlabels = tlm_head.lm_predictive_topk(tcfg, thcfg, hp, tstate, th[:, -1],
                                                topk=5, beam=16)
    real = slice(0, cfg.vocab_size)
    np.testing.assert_allclose(tdense.numpy()[:, real], dense[:, real], **F32_TOL)
    np.testing.assert_allclose(ttop.numpy(), top, **F32_TOL)
    at_labels = np.take_along_axis(dense, tlabels.numpy(), axis=-1)
    np.testing.assert_allclose(ttop.numpy(), at_labels, **F32_TOL)

    for beam in (0, 16):
        step = tstep.make_serve_step(tcfg, thcfg, topk_beam=beam)
        tok, cache = step(tparams, tstate, torch.from_numpy(token),
                          {k: v.clone() for k, v in tcache.items()}, PROMPT)
        assert tok.shape == (BATCH, 1) and cache["k"].shape[2] == SEQ
        picked = np.take_along_axis(dense, tok.numpy(), axis=-1)[:, 0]
        want = dense.max(-1) if beam == 0 else top[:, 0]
        np.testing.assert_allclose(picked, want, **F32_TOL)
    np.testing.assert_allclose(np.take_along_axis(dense, np.asarray(jtok), -1)[:, 0],
                               dense.max(-1), rtol=0, atol=0)


def test_attention_raises_for_other_serving_branches():
    """A per-row ``cache_pos`` (the serving engine's slotted decode) runs and
    gives each row what a decode at its own scalar position gives; explicit
    positions reach the kernel only where they equal the index (the
    kernel's mask), and a write past the cache raises."""
    cfg = tconfigs.reduced_config("h2o-danube-3-4b")
    gen = torch.Generator().manual_seed(0)
    params = ttransformer.init_params(gen, cfg, device="cpu")
    cache = ttransformer.init_cache(cfg, 2, 8, device="cpu")
    cache = {k: torch.randn(v.shape, generator=gen).to(v.dtype) for k, v in cache.items()}
    tokens = torch.tensor([[3], [7]], dtype=torch.int64)
    h, _, _ = ttransformer.forward(params, cfg, tokens,
                                   cache={k: v.clone() for k, v in cache.items()},
                                   cache_pos=torch.tensor([1, 2]))
    for row, pos in enumerate((1, 2)):
        one = {k: v[:, row:row + 1].clone() for k, v in cache.items()}
        want, _, _ = ttransformer.forward(params, cfg, tokens[row:row + 1], cache=one,
                                          cache_pos=pos)
        np.testing.assert_allclose(h[row].float().numpy(), want[0].float().numpy(),
                                   **SELF_TOL)
    with pytest.raises(ValueError, match="masks by index"):
        ttransformer.forward(params, cfg, tokens, positions=torch.zeros((2, 1)),
                             cache={k: v.clone() for k, v in cache.items()}, cache_pos=3)
    at_index, _, _ = ttransformer.forward(params, cfg, tokens,
                                          cache={k: v.clone() for k, v in cache.items()},
                                          cache_pos=3, positions=torch.full((2, 1), 3))
    default, _, _ = ttransformer.forward(params, cfg, tokens,
                                         cache={k: v.clone() for k, v in cache.items()},
                                         cache_pos=3)
    assert torch.equal(at_index, default)
    with pytest.raises(ValueError, match="cache holds 8"):
        ttransformer.forward(params, cfg, tokens, cache=cache, cache_pos=8)


@pytest.mark.parametrize("beam", [0, 16])
def test_run_lockstep_on_cpu(capsys, beam):
    args = tserve.parse_args(["--lockstep", "--arch", "h2o-danube-3-4b", "--device", "cpu",
                              "--batch", "3", "--prompt-len", "12", "--gen", "4",
                              "--topk-beam", str(beam)])
    cfg, params, state, hcfg = tserve.build(args.arch, reduced=True, head=args.head,
                                            seed=args.seed, device="cpu")
    out = tserve.run_lockstep(args, cfg, params, state, hcfg, torch.device("cpu"))
    assert out["tokens"].shape == (3, 4) and out["steps"] == 4
    assert ((out["tokens"] >= 0) & (out["tokens"] < cfg.vocab_size)).all()
    assert "decode 4 steps" in capsys.readouterr().out


def test_launcher_main(capsys):
    assert tserve.main(["--lockstep", "--arch", "gemma2-27b", "--device", "cpu",
                        "--batch", "2", "--prompt-len", "6", "--gen", "3",
                        "--eos-id", "5"]) == 0
    assert "sample:" in capsys.readouterr().out
    assert tserve.main(["--device", "cpu"]) == 0
    assert "engine: 4 requests over 4 slots" in capsys.readouterr().out
