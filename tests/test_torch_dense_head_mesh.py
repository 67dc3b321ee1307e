"""The dense head and the dense embedding on a ("data", "model") mesh, on
gloo ranks on the CPU, against the port's one-rank step and the JAX
package's ``make_train_step(head_update="dense")`` on one device; and the
launchers on a mesh of data ranks alone (FSDP weights).

Reduced stablelm-3b, two layers, float32, the global batch 8 × 16 with a
masked tail, on (1, 2) and (2, 2):
- ``softmax``, the embedding dense: the vocab-parallel cross entropy (each
  model rank scores its rows; the maximum, the sum of exponentials and the
  label's score combined over ``model``);
- the tree head (``adversarial_ns``) with ``head_update="dense"``: the
  candidates' rows gathered from their owners under autograd;
- the tree head, sparse, with ``embed_update="dense"``.

Sampling is held fixed as in ``tests/test_torch_parallel_train.py``.
Bounds: every leaf's gradient, gathered, within 1e-5 relative RMS of one
rank's; the JAX step's gradient (its first SGD step's update over the
learning rate and the clip's scale) within 1e-5; three SGD steps (lr 0.05,
clip 1.0) at the reference's bounds (``tests/test_parallel.py:65-71``: the
loss 1e-5 relative, the parameters 1e-3 relative plus 1e-4). Two planted
faults fail the first bound: the gathered rows' gradient summed over
``model`` (every rank holds it whole, so the sum multiplies it by tp), and
``h`` entering the softmax without its sum over ``model`` (its gradient
stays the rank's partial over its rows).
"""
import functools
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from test_torch_parallel_train import OPT, TFixed, _batch, _cfgs, _draws, _jfixed
from test_torch_tp_train import _worst_rel_rms

import _torch_world as W
from repro_torch import convert, tree_util
from repro_torch.models import lm_head as tlm_head
from repro_torch.optim.sparse import SparseRows
from repro_torch.train import step as tstep

CASES = {   # name: (head kind, head_update, embed_update)
    "softmax": ("softmax", "auto", "auto"),
    "tree_dense": ("adversarial_ns", "dense", "dense"),
    "tree_sparse_embed_dense": ("adversarial_ns", "sparse", "dense"),
}
N_STEPS = 3
GRAD_REL_RMS = 1e-5
JAX_GRAD_TOL = dict(atol=1e-5, rtol=1e-5)
REF_TOL = dict(atol=1e-4, rtol=1e-3)           # tests/test_parallel.py:65-70

WORLD = """
import _torch_world as W
from repro_torch import tree_util
from repro_torch.core.samplers import UniformSampler
from repro_torch.models import lm_head
from repro_torch.optim import OptimizerConfig
from repro_torch.parallel import collectives, gather_train_state, shard_train_state
from repro_torch.train import step as tstep

inp = torch.load(os.path.join(OUT, "inputs.pt"), weights_only=False)
mesh = mesh_of(2)
cfg = inp["cfg"]
out = {}


def hcfg_of(kind):
    return lm_head.head_config(cfg, kind, n_neg=1, reg=1e-4)


def state_of(kind):          # a fresh copy's part: the steps update it in place
    return shard_train_state(tree_util.tree_map(
        lambda t: t.clone() if isinstance(t, torch.Tensor) else t, inp["states"][kind]),
        mesh, cfg)


def grads_of(name):
    kind, head_update, embed_update = inp["cases"][name]
    fn = tstep.make_grad_fn(cfg, hcfg_of(kind), head_update=head_update,
                            embed_update=embed_update,
                            sampler=UniformSampler(cfg.vocab_size), mesh=mesh)
    grads, metrics = fn(state_of(kind), inp["batches"][0], torch.Generator().manual_seed(0))
    rows = grads.pop("head") if not isinstance(grads["head"], dict) else None
    rows = None if rows is None else W.whole_rows(mesh, rows)
    return dict(full=gather_train_state(grads, mesh, cfg), rows=rows,
                loss=float(metrics["loss"]))


def steps_of(name):
    kind, head_update, embed_update = inp["cases"][name]
    step = tstep.make_train_step(cfg, hcfg_of(kind), OptimizerConfig(**inp["opt"]),
                                 head_update=head_update, embed_update=embed_update,
                                 sampler=UniformSampler(cfg.vocab_size), mesh=mesh)
    state = state_of(kind)
    metrics = []
    for s, batch in enumerate(inp["batches"]):
        state, m = step(state, batch, torch.Generator().manual_seed(s))
        metrics.append({k: float(v) for k, v in m.items()})
    return dict(metrics=metrics, params=gather_train_state(state.params, mesh, cfg))


for name in inp["cases"]:
    out["grads", name] = grads_of(name)
    out["steps", name] = steps_of(name)

# Planted: the gathered rows' gradient summed over model.
backward = collectives._ShardedGatherRows.backward


def summed_rows(ctx, g):
    g = g.clone()
    torch.distributed.all_reduce(g, group=mesh.get_group("model"))
    return backward(ctx, g)


collectives._ShardedGatherRows.backward = staticmethod(summed_rows)
out["fault_rows_summed"] = grads_of("tree_dense")
collectives._ShardedGatherRows.backward = staticmethod(backward)

# Planted: h enters the softmax without its sum over model.
copy, loss_fn, planted = collectives.copy_to_model, lm_head.lm_sharded_dense_loss, []
collectives.copy_to_model = lambda m, x: x if planted else copy(m, x)


def unsummed_h(*a, **kw):
    planted.append(True)
    try:
        return loss_fn(*a, **kw)
    finally:
        planted.clear()


lm_head.lm_sharded_dense_loss = unsummed_h
out["fault_h_unsummed"] = grads_of("softmax")
lm_head.lm_sharded_dense_loss = loss_fn
collectives.copy_to_model = copy
save(out)
"""


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _jax_state(kind):
    import jax
    from repro.optim import OptimizerConfig as JOptimizerConfig
    from repro.train import step as jstep
    jcfg, _ = _cfgs()
    return jax.jit(lambda k: jstep.init_train_state(k, jcfg, JOptimizerConfig(**OPT), kind))(
        jax.random.PRNGKey(0))


def _state(kind):
    import jax
    return convert.train_state_from_numpy(jax.tree.map(np.asarray, _jax_state(kind)),
                                          device="cpu")


def _batches(cfg):
    return [{k: torch.as_tensor(v) for k, v in _batch(cfg, s).items()} for s in range(N_STEPS)]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    _, tcfg = _cfgs()
    kinds = {kind for kind, _, _ in CASES.values()}
    inp = {"cfg": tcfg, "cases": CASES, "opt": OPT, "batches": _batches(tcfg),
           "states": {kind: _state(kind) for kind in kinds}}
    tmps = {}
    for n_ranks in (2, 4):
        tmps[n_ranks] = tmp_path_factory.mktemp(f"dense{n_ranks}")
        torch.save(inp, tmps[n_ranks] / "inputs.pt")
    with ThreadPoolExecutor(2) as pool:        # the two worlds side by side
        list(pool.map(lambda n: W.run_world(tmps[n], n, WORLD, timeout=150), tmps))
    return {n: W.load_outputs(tmp, n) for n, tmp in tmps.items()}


def _dense_rows(rows: SparseRows, n_rows: int):
    dw = torch.zeros((n_rows,) + tuple(rows.dw.shape[1:])).index_add_(0, rows.ids, rows.dw)
    return dw, torch.zeros(n_rows).index_add_(0, rows.ids, rows.db)


def _flat(grads, rows, cfg) -> dict:
    flat = dict(tree_util.flatten_with_paths(grads)[0])
    if rows is not None:
        flat[("head", "w")], flat[("head", "b")] = _dense_rows(rows, cfg.padded_vocab)
    return flat


@functools.lru_cache(maxsize=None)
def _one_rank(name):
    kind, head_update, embed_update = CASES[name]
    _, cfg = _cfgs()
    hcfg = tlm_head.head_config(cfg, kind, n_neg=1, reg=1e-4)
    fn = tstep.make_grad_fn(cfg, hcfg, head_update=head_update, embed_update=embed_update,
                            sampler=TFixed(_draws(cfg), cfg.vocab_size))
    grads, metrics = fn(_state(kind), _batches(cfg)[0], torch.Generator().manual_seed(0))
    rows = grads.pop("head") if not isinstance(grads["head"], dict) else None
    return _flat(grads, rows, cfg), float(metrics["loss"])


@functools.lru_cache(maxsize=None)
def _jax_run(name):
    """The JAX package's three SGD steps: losses, grad norms, the first
    step's parameters and the last's."""
    import jax
    from repro.models import lm_head as jlm_head
    from repro.optim import OptimizerConfig as JOptimizerConfig
    from repro.train import step as jstep
    kind, head_update, embed_update = CASES[name]
    jcfg, tcfg = _cfgs()
    jh = jlm_head.head_config(jcfg, kind, n_neg=1, reg=1e-4)
    jfn = jax.jit(jstep.make_train_step(
        jcfg, jh, JOptimizerConfig(**OPT), head_update=head_update, embed_update=embed_update,
        sampler=_jfixed(_draws(tcfg), jcfg.vocab_size)))
    jstate, metrics, params = _jax_state(kind), [], []
    for s in range(N_STEPS):
        batch = {k: np.asarray(v) for k, v in _batch(tcfg, s).items()}
        jstate, jm = jfn(jstate, batch, jax.random.PRNGKey(s))
        metrics.append({k: float(v) for k, v in jm.items()})
        params.append(convert._lm_tree(jax.tree.map(np.asarray, jstate.params),
                                       torch.device("cpu"), n_layers=tcfg.num_layers))
    return metrics, params


@pytest.mark.parametrize("n_ranks", [2, 4])
@pytest.mark.parametrize("name", list(CASES))
def test_dense_gradients_match_one_rank(worlds, name, n_ranks):
    want, loss = _one_rank(name)
    _, cfg = _cfgs()
    for out in worlds[n_ranks]:
        got = out["grads", name]
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-6)
        worst, at = _worst_rel_rms(_flat(got["full"], got["rows"], cfg), want)
        assert worst <= GRAD_REL_RMS, (name, n_ranks, at, worst)


@pytest.mark.parametrize("name", list(CASES))
def test_dense_gradients_match_jax(worlds, name):
    """The (2, 2) mesh's gradient against the JAX step's: its first SGD
    update, -lr · min(1, clip / norm) · g."""
    _, cfg = _cfgs()
    metrics, params = _jax_run(name)
    scale = OPT["learning_rate"] * min(1.0, OPT["clip_norm"] / metrics[0]["grad_norm"])
    before = dict(tree_util.flatten_with_paths(_state(CASES[name][0]).params)[0])
    after = dict(tree_util.flatten_with_paths(params[0])[0])
    out = worlds[4][0]["grads", name]
    got = _flat(out["full"], out["rows"], cfg)
    np.testing.assert_allclose(out["loss"], metrics[0]["loss"], rtol=1e-5)
    for path, g in got.items():
        np.testing.assert_allclose((-scale * g).numpy(), (after[path] - before[path]).numpy(),
                                   **JAX_GRAD_TOL, err_msg=str(path))


@pytest.mark.parametrize("n_ranks", [2, 4])
@pytest.mark.parametrize("name", list(CASES))
def test_dense_steps_match_jax(worlds, name, n_ranks):
    metrics, params = _jax_run(name)
    outs = worlds[n_ranks]
    for out in outs:
        got = out["steps", name]
        np.testing.assert_allclose([m["loss"] for m in got["metrics"]],
                                   [m["loss"] for m in metrics], rtol=1e-5)
        assert [m["grad_norm"] for m in got["metrics"]] == \
            [m["grad_norm"] for m in outs[0]["steps", name]["metrics"]]
        for g, w in zip(tree_util.leaves(got["params"]), tree_util.leaves(params[-1])):
            np.testing.assert_allclose(g.numpy(), w.numpy(), **REF_TOL)


@pytest.mark.parametrize("fault,name", [("fault_rows_summed", "tree_dense"),
                                        ("fault_h_unsummed", "softmax")])
def test_planted_faults_fail_the_gradient_bound(worlds, fault, name):
    want, _ = _one_rank(name)
    _, cfg = _cfgs()
    got = worlds[4][0][fault]
    worst, at = _worst_rel_rms(_flat(got["full"], got["rows"], cfg), want)
    assert worst > 1e3 * GRAD_REL_RMS, (fault, at, worst)


def _env():
    env = dict(os.environ, PYTHONPATH=os.path.join(W.ROOT, "src"), OMP_NUM_THREADS="1")
    for key in ("RANK", "WORLD_SIZE"):
        env.pop(key, None)
    return env


def test_serve_launcher_on_data_ranks_gives_one_ranks_tokens(tmp_path):
    """``torchrun --nproc-per-node 2 -m repro_torch.launch.serve --model-axis
    1 --lockstep``: a (2, 1) mesh, every trunk matrix cut over ``data`` and
    gathered a layer at a time at every step; both ranks serve the
    one-process run's tokens, and each holds the exact FSDP bytes."""
    flags = ["-m", "repro_torch.launch.serve", "--arch", "stablelm-3b", "--reduced",
             "--device", "cpu", "--lockstep", "--batch", "2", "--prompt-len", "6", "--gen",
             "3"]
    runs = []
    for name, pre in (("mesh", ["-m", "torch.distributed.run", "--standalone",
                                "--nproc-per-node", "2"]), ("one", [])):
        extra = ["--model-axis", "1"] if pre else []
        runs.append(subprocess.Popen(
            [sys.executable] + pre + flags + extra + ["--report-dir", str(tmp_path / name)],
            cwd=str(tmp_path), env=_env(), text=True, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE))
    outs = []
    for proc in runs:
        o, e = proc.communicate(timeout=150)
        assert proc.returncode == 0, e[-4000:]
        outs.append(o)
    one = json.loads((tmp_path / "one" / "serve_rank0.json").read_text())
    for r in range(2):
        got = json.loads((tmp_path / "mesh" / f"serve_rank{r}.json").read_text())
        assert got["tokens"] == one["tokens"]
    line = next(x for x in outs[0].splitlines() if x.startswith("mesh:"))
    assert line.startswith("mesh: {'data': 2, 'model': 1} over 2 ranks, backend gloo")
    ranks = [int(x) for x in re.search(r"trunk bytes a rank \[([^\]]*)\]", line)[1].split(",")]
    total, model, whole, data, both = (int(x) for x in re.search(
        r"one rank's trunk (\d+): (\d+) split over model, (\d+) whole\) \+ \((\d+) split "
        r"over data, (\d+) over both\)", line).groups())
    assert model == both == 0 and data > 0 and total == data + whole
    assert ranks == [data // 2 + whole] * 2


def test_train_launcher_trains_a_softmax_head_on_data_ranks(tmp_path):
    """``torchrun --nproc-per-node 2 -m repro_torch.launch.train --model-axis
    1 --head softmax``: the dense head on a (2, 1) mesh trains, and each
    rank's parameter and optimizer-state bytes are exactly its FSDP parts
    plus the whole leaves."""
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
         "2", "-m", "repro_torch.launch.train", "--arch", "stablelm-3b", "--reduced",
         "--device", "cpu", "--model-axis", "1", "--head", "softmax", "--steps", "2",
         "--batch", "2", "--seq", "16"],
        cwd=str(tmp_path), env=_env(), capture_output=True, text=True, timeout=150)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.count("final loss") == 1
    losses = [float(x) for x in re.findall(r"loss=([-0-9.naif]+)", proc.stdout)]
    assert len(losses) == 2 and all(np.isfinite(losses))
    for label in ("parameter", "optimizer-state"):
        m = re.search(label + r" bytes a rank \[(\d+), (\d+)\] \(one rank's (\d+): (\d+) split "
                      r"over model, (\d+) whole\) \+ \((\d+) split over data, (\d+) over "
                      r"both\)", proc.stdout)
        assert m, proc.stdout[:2000]
        a, b, total, model, whole, data, both = map(int, m.groups())
        assert model == both == 0 and data > 0 and total == data + whole
        assert a == b == data // 2 + whole
