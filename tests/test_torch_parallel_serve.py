"""The port's serving on a (1, 2) mesh of gloo ranks on the CPU, as
``tests/test_serve_engine.py::TestMeshScoring`` and
``tests/test_parallel.py::test_launcher_entry_points`` check the
reference's: the lock-step decode (dense Eq. 5, whose argmax is merged
over the ranks' vocabulary slices, and beam, whose candidates are scored by
``sharded_candidate_scores``) and the engine, each rank serving the same
requests with its part of the model (``parallel.shard_train_state``: the
vocabulary rows and the trunk's heads and ``d_ff``); then the serving
launcher under ``torchrun``.

The weights are the JAX package's, carried across. The port's one-rank
tokens equal the JAX package's ``lockstep_decode`` and engine, token for
token. On the mesh the trunk's sums are split across the ranks, so it is
held as the reference holds its sharded runs (``tests/test_parallel.py:65``):
the dense Eq. 5 scores of a decode fed the one-rank tokens within 1e-5 of
the one-rank scores, relative to their largest; every rank's tokens equal
to every other rank's; and the engine's tokens on the mesh equal to the
lock-step decode of each request alone on the same mesh.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_world as W
from repro_torch import convert
from repro_torch.models import lm_head
from repro_torch.models.config import ModelConfig
from repro_torch.serve import Engine, Request, ServeConfig, lockstep_decode

N_RANKS = 2
PARITY = dict(name="mesh-parity", num_layers=2, d_model=32, d_ff=64, vocab_size=100,
              num_heads=4, num_kv_heads=2, vocab_pad_multiple=128, gen_feature_dim=8,
              dtype="float32", remat=False, window_size=5)
MAX_LEN, GEN, BEAM = 12, 4, 8
ENGINE = dict(n_slots=2, max_len=MAX_LEN, page_len=3, n_pages=8)

WORLD = """
import numpy as np
from repro_torch.core.heads import HeadParams
from repro_torch.models import lm_head, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import shard_train_state, sharding
from repro_torch.serve import Engine, Request, ServeConfig, lockstep_decode

mesh = mesh_of(2)
inp = torch.load(os.path.join(OUT, "inputs.pt"), weights_only=False)
cfg = ModelConfig(**inp["cfg"])
hcfg = lm_head.head_config(cfg, "adversarial_ns")
params = shard_train_state(inp["params"], mesh, cfg)
out = {}
for beam in (0, inp["beam"]):
    out["lockstep", beam] = lockstep_decode(cfg, hcfg, params, inp["state"], inp["prompts"],
                                            inp["gen"], topk_beam=beam, mesh=mesh)
    eng = Engine(cfg, hcfg, params, inp["state"], ServeConfig(
        beam=beam, mesh=mesh, cache_dtype=torch.float32, **inp["engine"]))
    handles = [eng.submit(Request(prompt=p, max_new_tokens=n)) for p, n in inp["requests"]]
    eng.run()
    eng.pool.check_invariants()
    out["engine", beam] = [h.tokens for h in handles]
    out["alone", beam] = [lockstep_decode(cfg, hcfg, params, inp["state"], p[None], n,
                                          topk_beam=beam, mesh=mesh)[0].tolist()
                          for p, n in inp["requests"]]

# The dense Eq. 5 scores of this rank's vocabulary rows, fed the one-rank tokens.
lo, _ = sharding.row_range(cfg.padded_vocab, mesh)
head = HeadParams(w=params["head"]["w"], b=params["head"]["b"])
prompts = torch.as_tensor(inp["prompts"], dtype=torch.int64)
forced = torch.as_tensor(inp["forced"], dtype=torch.int64)
b, pl = prompts.shape
cache = transformer.init_cache(cfg, b, pl + inp["gen"], dtype=torch.float32, device="cpu",
                               mesh=mesh)
with torch.no_grad():
    h, cache, _ = transformer.forward(params, cfg, prompts, cache=cache, cache_pos=0, mesh=mesh)
    scores = [lm_head.lm_predictive_scores(cfg, hcfg, head, inp["state"], h[:, -1], lo=lo)]
    for t in range(inp["gen"] - 1):
        h, cache, _ = transformer.forward(params, cfg, forced[:, t:t + 1], cache=cache,
                                          cache_pos=pl + t, mesh=mesh)
        scores.append(lm_head.lm_predictive_scores(cfg, hcfg, head, inp["state"], h[:, -1],
                                                   lo=lo))
out["scores"] = (lo, torch.stack(scores, 1))
save(out)
"""
SCORES_TOL = 1e-5          # tests/test_parallel.py:65, relative to the largest score


def _forced_scores(cfg, params, state, prompts, forced):
    """The one-rank dense Eq. 5 scores (B, GEN, V_pad) of the decode fed
    ``forced`` after ``prompts``."""
    from repro_torch.core.heads import HeadParams
    from repro_torch.models import transformer
    hcfg = lm_head.head_config(cfg, "adversarial_ns")
    head = HeadParams(w=params["head"]["w"], b=params["head"]["b"])
    prompts, forced = torch.as_tensor(prompts).long(), torch.as_tensor(forced).long()
    b, pl = prompts.shape
    cache = transformer.init_cache(cfg, b, pl + GEN, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        h, cache, _ = transformer.forward(params, cfg, prompts, cache=cache, cache_pos=0)
        scores = [lm_head.lm_predictive_scores(cfg, hcfg, head, state, h[:, -1])]
        for t in range(GEN - 1):
            h, cache, _ = transformer.forward(params, cfg, forced[:, t:t + 1], cache=cache,
                                              cache_pos=pl + t)
            scores.append(lm_head.lm_predictive_scores(cfg, hcfg, head, state, h[:, -1]))
    return torch.stack(scores, 1)


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    import jax
    from repro.models import lm_head as jlm_head
    from repro.models import transformer as jtransformer
    from repro.models.config import ModelConfig as JModelConfig
    jcfg, tcfg = JModelConfig(**PARITY), ModelConfig(**PARITY)
    params = jtransformer.init_params(jax.random.PRNGKey(0), jcfg)
    state = jlm_head.default_head_state(jax.random.PRNGKey(1), jcfg, "adversarial_ns")
    tparams = convert.lm_params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    tstate = convert.lm_head_state_from_numpy(
        np.asarray(state.proj), [np.asarray(a) for a in state.gen.tree], device="cpu")
    rng = np.random.default_rng(41)
    prompts = rng.integers(0, tcfg.vocab_size, (3, 5)).astype(np.int32)
    requests = [(rng.integers(0, tcfg.vocab_size, n).astype(np.int32), g)
                for n, g in ((2, 3), (6, 4), (4, 1), (3, 4))]
    forced = lockstep_decode(tcfg, lm_head.head_config(tcfg, "adversarial_ns"), tparams, tstate,
                             prompts, GEN)
    tmp = tmp_path_factory.mktemp("serve_world")
    torch.save({"cfg": PARITY, "params": tparams, "state": tstate, "prompts": prompts,
                "requests": requests, "gen": GEN, "beam": BEAM, "engine": ENGINE,
                "forced": forced}, tmp / "inputs.pt")
    W.run_world(tmp, N_RANKS, WORLD)
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, state=state, tparams=tparams,
                tstate=tstate, prompts=prompts, requests=requests, forced=forced,
                outs=W.load_outputs(tmp, N_RANKS))


@pytest.mark.parametrize("beam", [0, BEAM])
def test_mesh_lockstep_matches_one_rank_and_jax(setup, beam):
    import jax.numpy as jnp
    from repro.models import lm_head as jlm_head
    from repro.serve import lockstep_decode as jlockstep
    tcfg, jcfg = setup["tcfg"], setup["jcfg"]
    want = lockstep_decode(tcfg, lm_head.head_config(tcfg, "adversarial_ns"), setup["tparams"],
                           setup["tstate"], setup["prompts"], GEN, topk_beam=beam)
    jwant = jlockstep(jcfg, jlm_head.head_config(jcfg, "adversarial_ns"), setup["params"],
                      setup["state"], setup["prompts"], GEN, topk_beam=beam,
                      cache_dtype=jnp.float32)
    np.testing.assert_array_equal(want, np.asarray(jwant))
    outs = setup["outs"]
    for out in outs:
        np.testing.assert_array_equal(out["lockstep", beam], outs[0]["lockstep", beam])
    one = _forced_scores(tcfg, setup["tparams"], setup["tstate"], setup["prompts"],
                         setup["forced"])[..., :tcfg.vocab_size]
    for out in outs:
        lo, got = out["scores"]
        ref = one[..., lo:lo + got.shape[-1]]
        n = max(0, min(got.shape[-1], tcfg.vocab_size - lo))
        err = (got[..., :n] - ref[..., :n]).abs().max()
        assert err <= SCORES_TOL * one.abs().max(), err


@pytest.mark.parametrize("beam", [0, BEAM])
def test_mesh_engine_matches_one_rank_and_jax(setup, beam):
    import jax.numpy as jnp
    from repro.models import lm_head as jlm_head
    from repro.serve import Engine as JEngine
    from repro.serve import Request as JRequest
    from repro.serve import ServeConfig as JServeConfig
    tcfg, jcfg = setup["tcfg"], setup["jcfg"]
    eng = Engine(tcfg, lm_head.head_config(tcfg, "adversarial_ns"), setup["tparams"],
                 setup["tstate"], ServeConfig(beam=beam, cache_dtype=torch.float32, **ENGINE))
    jeng = JEngine(jcfg, jlm_head.head_config(jcfg, "adversarial_ns"), setup["params"],
                   setup["state"], JServeConfig(beam=beam, cache_dtype=jnp.float32, **ENGINE))
    handles = [eng.submit(Request(prompt=p, max_new_tokens=n)) for p, n in setup["requests"]]
    jhandles = [jeng.submit(JRequest(prompt=p, max_new_tokens=n))
                for p, n in setup["requests"]]
    eng.run()
    jeng.run()
    want = [h.tokens for h in handles]
    assert want == [list(h.tokens) for h in jhandles]
    outs = setup["outs"]
    for out in outs:
        assert out["engine", beam] == outs[0]["engine", beam]
        assert [list(t) for t in out["engine", beam]] == out["alone", beam]


def _serve(tmp_path, name, extra, torchrun):
    report = tmp_path / name
    args = ["-m", "repro_torch.launch.serve", "--arch", "h2o-danube-3-4b", "--reduced",
            "--device", "cpu", "--batch", "3", "--prompt-len", "8", "--gen", "4",
            "--report-dir", str(report)] + extra
    if torchrun:
        args = (["-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
                 str(N_RANKS)] + args + ["--model-axis", "2", "--shard-scores"])
    env = dict(os.environ, PYTHONPATH=os.path.join(W.ROOT, "src"), OMP_NUM_THREADS="1")
    for key in ("RANK", "WORLD_SIZE"):
        env.pop(key, None)
    proc = subprocess.Popen([sys.executable] + args, cwd=str(tmp_path), env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    return proc, report


@pytest.mark.parametrize("path", ["lockstep", "engine"])
def test_serve_launcher_under_torchrun(tmp_path, path):
    """``torchrun --nproc-per-node 2 -m repro_torch.launch.serve --model-axis 2
    --shard-scores --topk-beam 8``: both ranks serve the one-rank run's
    tokens, rank 0 alone prints."""
    extra = ["--topk-beam", "8"] + (["--lockstep"] if path == "lockstep" else [])
    runs = [_serve(tmp_path, name, extra, torchrun) for name, torchrun in
            (("mesh", True), ("one", False))]
    outs = []
    for proc, _ in runs:
        o, e = proc.communicate(timeout=150)
        assert proc.returncode == 0, e[-4000:]
        outs.append(o)
    mesh_out, one_out = outs
    assert "mesh: {'data': 1, 'model': 2} over 2 ranks, backend gloo" in mesh_out
    assert mesh_out.count("sample:") == 1
    import json
    one = json.loads((runs[1][1] / "serve_rank0.json").read_text())
    for r in range(N_RANKS):
        got = json.loads((runs[0][1] / f"serve_rank{r}.json").read_text())
        assert got["rank"] == r and got["path"] == path and got["beam"] == 8
        assert got["tokens"] == one["tokens"]
    assert mesh_out.split("sample:")[1].split("\n")[0] == \
        one_out.split("sample:")[1].split("\n")[0]
