"""The trunk sharded over the mesh's ``model`` axis, on gloo ranks on the
CPU: every block kind's prefill and four teacher-forced decode steps
through ``transformer.forward(mesh=)`` on a rank's part of the weights
(``parallel.sharding.shard_train_state``) and of the cache
(``init_cache(mesh=)``), against the port's one-rank run and the JAX
package's jitted forward on the same weights.

Cases and the branch each takes (reduced configs, float32):
- h2o-danube at tp 2 (4 query heads over 2 KV heads: both split) and at
  tp 4 (the KV heads stay whole; each rank reads the one its query head
  uses);
- deepseek-moe at tp 2: 8 experts, 4 a rank; the shared expert's d_ff split;
- mixtral with 3 experts at tp 2: they do not divide, so each expert's
  d_ff (96) is split;
- hymba at tp 2: 5 heads over 1 KV head, so attention is whole on every
  rank; 8 SSD heads split; with and without ``sharding_hints`` (the
  prefill's queries split along the sequence);
- mamba2 at tp 2.

Bounds: within 1e-5 of the one-rank run relative to its largest value
(the reference's bound for sharded against one device,
``tests/test_parallel.py:65``); against JAX the float32 bound of
``tests/test_torch_lm.py`` (2e-4); the ranks bit-equal among themselves;
``gather_train_state`` after ``shard_train_state`` bit-equal to the start.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_world as W
from repro import configs as jconfigs
from repro.models import transformer as jtransformer
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.models import transformer as ttransformer

BATCH, PROMPT, DECODE = 2, 8, 4
CASES = {   # name: (arch, config overrides, tp, hinted)
    "danube_tp2": ("h2o-danube-3-4b", {}, 2, False),
    "danube_tp4_kv_whole": ("h2o-danube-3-4b", {}, 4, False),
    "deepseek_moe_experts": ("deepseek-moe-16b", {}, 2, False),
    "mixtral_3_experts_dff": ("mixtral-8x22b", {"n_experts": 3}, 2, False),
    "hymba": ("hymba-1.5b", {}, 2, False),
    "hymba_hinted": ("hymba-1.5b", {}, 2, True),
    "mamba2": ("mamba2-370m", {}, 2, False),
}
SHARDED_TOL = 1e-5
F32_TOL = dict(atol=2e-4, rtol=2e-4)

WORLD = """
import dataclasses
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.parallel.collectives import TRUNK
from repro_torch.parallel import gather_train_state, shard_train_state
from repro_torch.parallel.hints import HintContext, sharding_hints

inp = torch.load(os.path.join(OUT, "inputs.pt"), weights_only=False)
mesh = mesh_of(inp["tp"])
out = {}
with torch.no_grad():
    for name, case in inp["cases"].items():
        cfg = ModelConfig(**case["cfg"])
        params = shard_train_state(case["params"], mesh, cfg)
        back = gather_train_state(params, mesh, cfg)
        flat = lambda t: [x for x in __import__("repro_torch").tree_util.leaves(t)]
        round_trip = all(torch.equal(a, b) for a, b in zip(flat(back), flat(case["params"])))
        cache = transformer.init_cache(cfg, case["tokens"].shape[0], case["max_len"],
                                       dtype=torch.float32, device="cpu", mesh=mesh)
        hint = sharding_hints(mesh) if case["hinted"] else __import__("contextlib").nullcontext()
        TRUNK.reset()
        with hint:
            h, cache, _ = transformer.forward(params, cfg, case["tokens"], cache=cache,
                                              cache_pos=0, mesh=mesh)
            steps = []
            pos = case["tokens"].shape[1]
            for t in range(case["decode"].shape[1]):
                hs, cache, _ = transformer.forward(params, cfg, case["decode"][:, t:t + 1],
                                                   cache=cache, cache_pos=pos + t, mesh=mesh)
                steps.append(hs)
        out[name] = dict(prefill=h, decode=torch.cat(steps, 1), round_trip=round_trip,
                         cache_shapes={k: tuple(v.shape) for k, v in cache.items()},
                         trunk_calls=TRUNK.calls)
taken = []
for kw in ("seq_parallel_residual", "fsdp_gather_weights"):
    taken.append((kw, getattr(HintContext(mesh, **{kw: True}), kw)))
out["taken"] = taken
save(out)
"""


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _carried(arch, overrides):
    kw = dict(overrides, dtype="float32")
    jcfg = dataclasses.replace(jconfigs.reduced_config(arch), **kw)
    tcfg = dataclasses.replace(tconfigs.reduced_config(arch), **kw)
    params = jax.jit(lambda k: jtransformer.init_params(k, jcfg))(jax.random.PRNGKey(0))
    tparams = convert.lm_params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    return jcfg, tcfg, params, tparams


def _inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (BATCH, PROMPT + DECODE)).astype(np.int64)
    return toks[:, :PROMPT], toks[:, PROMPT:]


def _one_rank(tcfg, tparams, tokens, decode):
    cache = ttransformer.init_cache(tcfg, BATCH, PROMPT + DECODE, dtype=torch.float32,
                                    device="cpu")
    with torch.no_grad():
        h, cache, _ = ttransformer.forward(tparams, tcfg, torch.from_numpy(tokens),
                                           cache=cache, cache_pos=0)
        steps = [ttransformer.forward(tparams, tcfg, torch.from_numpy(decode[:, t:t + 1]),
                                      cache=cache, cache_pos=PROMPT + t)[0]
                 for t in range(DECODE)]
    return h.numpy(), torch.cat(steps, 1).numpy()


def _jax(jcfg, params, tokens, decode):
    cache = jtransformer.init_cache(jcfg, BATCH, PROMPT + DECODE, dtype=jnp.float32)
    fwd = jax.jit(lambda p, t, c, pos: jtransformer.forward(p, jcfg, t, cache=c,
                                                            cache_pos=pos)[:2])
    h, cache = fwd(params, jnp.asarray(tokens), cache, jnp.int32(0))
    steps = []
    for t in range(DECODE):
        hs, cache = fwd(params, jnp.asarray(decode[:, t:t + 1]), cache, jnp.int32(PROMPT + t))
        steps.append(np.asarray(hs))
    return np.asarray(h), np.concatenate(steps, 1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both worlds (tp 2 and tp 4), each running all of its cases."""
    out = {}
    for tp in sorted({c[2] for c in CASES.values()}):
        cases = {}
        for i, (name, (arch, over, case_tp, hinted)) in enumerate(CASES.items()):
            if case_tp != tp:
                continue
            _, tcfg, _, tparams = _carried(arch, tuple(sorted(over.items())))
            tokens, decode = _inputs(tcfg, seed=10 + i)
            cases[name] = dict(cfg=dataclasses.asdict(tcfg), params=tparams, hinted=hinted,
                               tokens=torch.from_numpy(tokens), decode=torch.from_numpy(decode),
                               max_len=PROMPT + DECODE)
        tmp = tmp_path_factory.mktemp(f"tp{tp}")
        torch.save({"tp": tp, "cases": cases}, tmp / "inputs.pt")
        W.run_world(tmp, tp, WORLD)
        out[tp] = W.load_outputs(tmp, tp)
    return out


def _case(name):
    arch, over, tp, _ = CASES[name]
    i = list(CASES).index(name)
    jcfg, tcfg, params, tparams = _carried(arch, tuple(sorted(over.items())))
    tokens, decode = _inputs(tcfg, seed=10 + i)
    return jcfg, tcfg, params, tparams, tokens, decode, tp


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_matches_one_rank(runs, name):
    _, tcfg, _, tparams, tokens, decode, tp = _case(name)
    want = _one_rank(tcfg, tparams, tokens, decode)
    for ranks in (runs[tp],):
        for out in ranks:
            for got, ref in zip((out[name]["prefill"], out[name]["decode"]), want):
                err = np.abs(got.numpy() - ref).max()
                assert err <= SHARDED_TOL * np.abs(ref).max(), (name, err)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_matches_jax(runs, name):
    jcfg, _, params, _, tokens, decode, tp = _case(name)
    want = _jax(jcfg, params, tokens, decode)
    got = runs[tp][0][name]
    np.testing.assert_allclose(got["prefill"].numpy(), want[0], **F32_TOL)
    np.testing.assert_allclose(got["decode"].numpy(), want[1], **F32_TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_ranks_bit_equal_and_params_round_trip(runs, name):
    _, tcfg, _, _, _, _, tp = _case(name)
    ranks = runs[tp]
    for out in ranks:
        assert out[name]["round_trip"]
        for key in ("prefill", "decode"):
            assert torch.equal(out[name][key], ranks[0][name][key]), (name, key)
    shapes = ranks[0][name]["cache_shapes"]
    if "k" in shapes:      # KV heads split where they divide
        kv = tcfg.num_kv_heads
        assert shapes["k"][3] == (kv // tp if kv % tp == 0 else kv)
    if "state" in shapes:
        h = tcfg.ssm_heads
        assert shapes["state"][2] == (h // tp if h % tp == 0 else h)


def test_hint_gathers_the_prefill_queries(runs):
    """hymba's prefill under the hint: one more collective a layer (the
    output gathered along the sequence); decode steps (S = 1) take none."""
    plain, hinted = runs[2][0]["hymba"], runs[2][0]["hymba_hinted"]
    layers = tconfigs.reduced_config("hymba-1.5b").num_layers
    assert hinted["trunk_calls"] == plain["trunk_calls"] + layers


def test_hint_context_takes_seq_parallel_residual(runs):
    """Both hints are taken on a real mesh (sequence parallelism's
    numerics are ``tests/test_torch_seq_parallel.py``'s)."""
    assert runs[2][0]["taken"] == [("seq_parallel_residual", True),
                                   ("fsdp_gather_weights", True)]
