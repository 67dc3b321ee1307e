"""Serving with the trunk sharded over ``model`` on a (1, 2) mesh of gloo
ranks on the CPU, at the reduced h2o-danube config in float32: each rank
builds its part layer by layer (``init_params(mesh=)``), then serves the
same requests through the lock-step decode and the engine, dense and beam.
Every rank's tokens equal every other rank's and the one-rank run's; the
arena a rank holds is half the one-rank arena (2 KV heads over 2 ranks).
Then the engine under ``sharding_hints`` on paged arenas, where attention
is whole on every rank and a prefill's queries are split along the
sequence: hymba (5 heads over 1 KV head, its SSD heads split) and
h2o-danube with 3 heads over 1 KV head and prefix sharing, whose suffix
prefills read shared pages through the page table with the keys cut at the
rank's last query; each request's tokens, its prefill's last hidden and
its first decode step's hidden against one rank's. Then the serving
launcher under ``torchrun --model-axis 2``: its ``mesh:`` line gives each
rank's trunk bytes, the split leaves' half plus the whole ones."""
import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_world as W
from repro_torch import configs as tconfigs
from repro_torch.launch import serve as tserve
from repro_torch.models import lm_head, transformer
from repro_torch.parallel import sharding
from repro_torch.serve import Engine, Request, ServeConfig, lockstep_decode

ARCH = "h2o-danube-3-4b"
N_RANKS, GEN, BEAM = 2, 4, 8
ENGINE = dict(n_slots=2, max_len=14, page_len=4, n_pages=8)
HINTED = {   # name: (arch, config overrides, engine overrides)
    "hymba": ("hymba-1.5b", {}, {}),
    "danube_3_heads_sharing": ("h2o-danube-3-4b", dict(num_heads=3, num_kv_heads=1,
                                                       head_dim=16),
                               dict(prefix_sharing=True, n_pages=12)),
}
HIDDEN_TOL = 1e-5

WORLD = """
import dataclasses
import numpy as np
from repro_torch import configs, tree_util
from repro_torch.models import lm_head, transformer
from repro_torch.parallel import shard_train_state
from repro_torch.serve import Engine, Request, ServeConfig, lockstep_decode

mesh = mesh_of(2)
inp = torch.load(os.path.join(OUT, "inputs.pt"), weights_only=False)
cfg = dataclasses.replace(configs.reduced_config(inp["arch"]), dtype="float32")
gen = torch.Generator().manual_seed(0)
params = transformer.init_params(gen, cfg, device="cpu", mesh=mesh)
state = lm_head.default_head_state(gen, cfg, "adversarial_ns", device="cpu")
full = transformer.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
out = {"built_as_cut": all(torch.equal(a, b) for a, b in zip(
    tree_util.leaves(params), tree_util.leaves(shard_train_state(full, mesh, cfg))))}
del full
hcfg = lm_head.head_config(cfg, "adversarial_ns")
for beam in (0, inp["beam"]):
    out["lockstep", beam] = lockstep_decode(cfg, hcfg, params, state, inp["prompts"],
                                            inp["gen"], topk_beam=beam, mesh=mesh)
    eng = Engine(cfg, hcfg, params, state, ServeConfig(
        beam=beam, mesh=mesh, cache_dtype=torch.float32, **inp["engine"]))
    handles = [eng.submit(Request(prompt=p, max_new_tokens=n)) for p, n in inp["requests"]]
    eng.run()
    eng.pool.check_invariants()
    out["engine", beam] = [list(h.tokens) for h in handles]
    out["arena_bytes", beam] = eng.stats()["arena_bytes_this_rank"]

from repro_torch.launch.serve import HiddenTap
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import collectives
from repro_torch.parallel.hints import sharding_hints
gathered = []
gather = collectives.gather_seq_over_model
collectives.gather_seq_over_model = lambda m, part, *a: (
    gathered.append(part.shape[1]), gather(m, part, *a))[1]
for name, case in inp["hinted"].items():
    hcfg_m = ModelConfig(**case["cfg"])
    gen = torch.Generator().manual_seed(1)
    hp = transformer.init_params(gen, hcfg_m, device="cpu", mesh=mesh)
    hs = lm_head.default_head_state(gen, hcfg_m, "adversarial_ns", device="cpu")
    eng = Engine(hcfg_m, lm_head.head_config(hcfg_m, "adversarial_ns"), hp, hs,
                 ServeConfig(mesh=mesh, cache_dtype=torch.float32, **case["engine"]))
    tap = HiddenTap(eng)
    gathered.clear()
    with sharding_hints(mesh):
        handles = [eng.submit(Request(prompt=p, max_new_tokens=n)) for p, n in case["requests"]]
        eng.run()
    eng.pool.check_invariants()
    out["hinted", name] = dict(tokens=[list(h.tokens) for h in handles],
                               share_hits=eng.share_hits, gathered=list(gathered),
                               **tap.tensors())
save(out)
"""


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _hinted_cfg(name):
    arch, over, _ = HINTED[name]
    return dataclasses.replace(tconfigs.reduced_config(arch), dtype="float32", **over)


def _hinted_requests():
    """A template of two pages, two requests that extend it (the second
    admitted once the first's pages are in the prefix index), and two
    others; prompt lengths odd and even, so some prefills split."""
    rng = np.random.default_rng(11)
    tok = lambda n: rng.integers(0, 97, n).astype(np.int32)
    template = tok(8)
    return [(np.concatenate([template, tok(2)]), 3), (tok(6), 4),
            (np.concatenate([template, tok(4)]), 2), (tok(5), 3)]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    cfg = dataclasses.replace(tconfigs.reduced_config(ARCH), dtype="float32")
    rng = np.random.default_rng(7)
    prompts = rng.integers(0, cfg.vocab_size, (3, 6)).astype(np.int32)
    requests = [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), g)
                for n, g in ((5, 4), (9, 3), (2, 4), (7, 2))]
    hinted = {name: dict(cfg=dataclasses.asdict(_hinted_cfg(name)),
                         engine=dict(ENGINE, **HINTED[name][2]), requests=_hinted_requests())
              for name in HINTED}
    tmp = tmp_path_factory.mktemp("tp_serve")
    torch.save({"arch": ARCH, "prompts": prompts, "requests": requests, "gen": GEN,
                "beam": BEAM, "engine": ENGINE, "hinted": hinted}, tmp / "inputs.pt")
    W.run_world(tmp, N_RANKS, WORLD)
    gen = torch.Generator().manual_seed(0)
    params = transformer.init_params(gen, cfg, device="cpu")
    state = lm_head.default_head_state(gen, cfg, "adversarial_ns", device="cpu")
    return dict(cfg=cfg, params=params, state=state, prompts=prompts, requests=requests,
                outs=W.load_outputs(tmp, N_RANKS))


def test_each_rank_builds_its_cut_of_the_model(setup):
    assert all(out["built_as_cut"] for out in setup["outs"])


@pytest.mark.parametrize("beam", [0, BEAM])
def test_lockstep_tokens_equal_one_rank(setup, beam):
    cfg = setup["cfg"]
    want = lockstep_decode(cfg, lm_head.head_config(cfg, "adversarial_ns"), setup["params"],
                           setup["state"], setup["prompts"], GEN, topk_beam=beam)
    for out in setup["outs"]:
        np.testing.assert_array_equal(out["lockstep", beam], setup["outs"][0]["lockstep", beam])
        np.testing.assert_array_equal(out["lockstep", beam], want)


@pytest.mark.parametrize("beam", [0, BEAM])
def test_engine_tokens_equal_one_rank(setup, beam):
    cfg = setup["cfg"]
    eng = Engine(cfg, lm_head.head_config(cfg, "adversarial_ns"), setup["params"],
                 setup["state"], ServeConfig(beam=beam, cache_dtype=torch.float32, **ENGINE))
    handles = [eng.submit(Request(prompt=p, max_new_tokens=n)) for p, n in setup["requests"]]
    eng.run()
    want = [list(h.tokens) for h in handles]
    for out in setup["outs"]:
        assert out["engine", beam] == setup["outs"][0]["engine", beam]
        assert out["engine", beam] == want
        assert 2 * out["arena_bytes", beam] == eng.stats()["arena_bytes_this_rank"]


@pytest.mark.parametrize("name", list(HINTED))
def test_hinted_paged_engine_matches_one_rank(setup, name):
    cfg = _hinted_cfg(name)
    gen = torch.Generator().manual_seed(1)
    params = transformer.init_params(gen, cfg, device="cpu")
    state = lm_head.default_head_state(gen, cfg, "adversarial_ns", device="cpu")
    eng = Engine(cfg, lm_head.head_config(cfg, "adversarial_ns"), params, state,
                 ServeConfig(cache_dtype=torch.float32, **dict(ENGINE, **HINTED[name][2])))
    tap = tserve.HiddenTap(eng)
    handles = [eng.submit(Request(prompt=p, max_new_tokens=n)) for p, n in _hinted_requests()]
    eng.run()
    want = dict(tokens=[list(h.tokens) for h in handles], **tap.tensors())
    for out in setup["outs"]:
        got = out["hinted", name]
        assert got["gathered"], "the hint split no prefill"
        assert got["tokens"] == want["tokens"]
        assert got["share_hits"] == eng.share_hits
        for key in ("prefill_last", "decode_first"):
            assert got[key].shape == want[key].shape
            err = (got[key] - want[key]).abs().max()
            assert err <= HIDDEN_TOL * want[key].abs().max(), (name, key, err)
    if HINTED[name][2].get("prefix_sharing"):
        assert eng.share_hits > 0
        # A suffix prefill of 4 tokens after the 8 shared ones, split 2 / 2.
        assert 2 in setup["outs"][0]["hinted", name]["gathered"]


def test_launcher_prints_each_ranks_bytes(tmp_path):
    """``torchrun --nproc-per-node 2 -m repro_torch.launch.serve --model-axis
    2``: each rank's trunk bytes are the split leaves' half plus the whole
    leaves, below the one-rank trunk's; and the one-rank trunk's are what a
    one-rank build holds. With ``--teacher-tokens`` each rank writes its
    vocabulary rows' scores of the decode fed them, and with
    ``--time-collectives`` the trunk collectives' seconds."""
    env = dict(os.environ, PYTHONPATH=os.path.join(W.ROOT, "src"), OMP_NUM_THREADS="1")
    for key in ("RANK", "WORLD_SIZE"):
        env.pop(key, None)
    np.save(tmp_path / "teacher.npy", np.arange(4, dtype=np.int64).reshape(2, 2))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
         str(N_RANKS), "-m", "repro_torch.launch.serve", "--arch", ARCH, "--reduced",
         "--device", "cpu", "--lockstep", "--batch", "2", "--prompt-len", "6", "--gen", "2",
         "--model-axis", str(N_RANKS), "--report-dir", "rep", "--time-collectives",
         "--teacher-tokens", str(tmp_path / "teacher.npy")],
        cwd=str(tmp_path), env=env, text=True, capture_output=True, timeout=150)
    assert proc.returncode == 0, proc.stderr[-4000:]
    cfg = tconfigs.reduced_config(ARCH)
    for r in range(N_RANKS):
        forced = torch.load(tmp_path / "rep" / f"serve_rank{r}.pt", weights_only=False)
        n = cfg.padded_vocab // N_RANKS
        assert forced["lo"] == r * n and forced["scores"].shape == (2, 2, n)
        assert forced["prefill_last"].shape == (2, cfg.d_model)
        assert forced["trunk_collectives"]["seconds"] > 0
    line = next(x for x in proc.stdout.splitlines() if x.startswith("mesh:"))
    ranks = [int(x) for x in re.search(r"trunk bytes a rank \[([^\]]*)\]", line)[1].split(",")]
    one, split, whole = (int(x) for x in re.search(
        r"one rank's trunk (\d+): (\d+) split over model, (\d+) whole", line).groups())
    assert len(ranks) == N_RANKS and split > 0 and split + whole == one
    assert ranks == [split // N_RANKS + whole] * N_RANKS
    cfg, params, _, _ = tserve.build(ARCH, reduced=True, head="adversarial_ns", seed=0,
                                     device="cpu")
    assert sharding.tree_bytes(params["layers"]) == one
