"""The dry run (``repro_torch.launch.dryrun``) on a fake world of (2, 4)
ranks, in a subprocess of its own: reduced stablelm-3b cells of each mode
counted at 1 and 2 layers, every count held against a reckoning from the
shapes.

- One layer's FLOPs (the 2-layer count less the 1-layer one): its
  projections' matmuls on the rank's part (heads and ``d_ff`` over tp 4,
  the rank's rows of the batch over data 2) and, where the kernel runs,
  ``flash_attention``'s formula; training 3 times the forward's matmuls
  and the recompute's (``cfg.remat``: the layer runs under a checkpoint).
- One layer's collective bytes by axis: over ``model`` the two float32
  row-parallel sums, over ``data`` FSDP's gather of the layer's parts
  (each leaf's rank part, 16-byte aligned).
- Each kernel's launches: a decode or prefill step ``flash_attention``
  once a layer and ``tree_logprob_all`` once; a training step
  ``sampled_head_loss`` once, ``segment_stats`` 3 and 3 more for the sums
  over ``data``, no ``flash_attention``.
- A prefill counts ``flash_attention`` calls and no (B, H, S, S) tensor.
- ``skipped`` (long context on a quadratic attention) and ``error``
  statuses and the artifact's keys: the reference's, with
  ``flops_per_device`` and ``bytes_accessed_per_device`` for its two HLO
  keys, and ``collectives_by_axis`` and ``assumptions`` added.
"""
import json
import os
import subprocess
import sys

import pytest

from repro_torch import configs
from repro_torch.kernels import flash_attention

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DP, TP = 2, 4
SEQ, BATCH = 96, 4          # S unlike every width, so an (S, S) tensor is the logits
ROWS = BATCH // DP

SCRIPT = f"""
import dataclasses, json, sys
import torch
from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.parallel import sharding
from repro_torch.models import transformer

mesh = dryrun.mesh_of(({DP}, {TP}))
base = configs.reduced_config("stablelm-3b")
out = {{}}
for mode in ("decode", "prefill", "train"):
    for n in (1, 2):
        cfg = dataclasses.replace(base, num_layers=n)
        shapes = []
        if mode == "prefill" and n == 2:
            track = dryrun.Counter._track
            def rec(self, o):
                shapes.extend(tuple(t.shape) for t in dryrun._tensors(o))
                return track(self, o)
            dryrun.Counter._track = rec
        res = dryrun.run_cell("stablelm-3b", "reduced", "single", "adversarial_ns",
                              cfg_override=cfg, mesh=mesh,
                              cell=dict(mode=mode, seq_len={SEQ}, global_batch={BATCH}))
        if shapes:
            dryrun.Counter._track = track
            res["shapes"] = shapes
        out[mode, n] = res
# FSDP's gather of one layer a rank: its data parts, each 16-byte aligned.
params = transformer.init_params(torch.Generator(), base, device="meta", cast=True)
layer = 0
for (path, sp), x in zip(sharding.train_state_spec(base, mesh, params["layers"][0],
                                                   ("layers", "0")),
                         __import__("repro_torch").tree_util.leaves(params["layers"][0])):
    if "data" in sharding.split_axes(sp, mesh):
        nb = x.element_size() * torch.Size(sharding.local_shape(x.shape, sp, mesh)).numel()
        layer += nb + (-nb % 16)
out["fsdp_layer_bytes"] = layer
import tempfile, os
tmp = tempfile.mkdtemp()
rc_skip = dryrun.main(["--arch", "stablelm-3b", "--shape", "long_500k", "--mesh", "single",
                       "--out", tmp])
def boom(*a, **kw):
    raise RuntimeError("planted")
dryrun.run_cell = boom
rc_err = dryrun.main(["--arch", "stablelm-3b", "--shape", "train_4k", "--mesh", "single",
                      "--out", tmp])
arts = {{f: json.load(open(os.path.join(tmp, f))) for f in os.listdir(tmp)}}
out = {{"|".join(map(str, k)) if isinstance(k, tuple) else k: v for k, v in out.items()}}
json.dump(dict(cells=out, rc_skip=rc_skip, rc_err=rc_err, artifacts=arts), sys.stdout)
"""

REFERENCE_KEYS = {"arch", "shape", "mesh", "mode", "seq_len", "global_batch", "head", "chips",
                  "status", "seq_shard_attn", "seq_parallel_residual", "fsdp_gather",
                  "compile_s", "argument_size_in_bytes", "output_size_in_bytes",
                  "temp_size_in_bytes", "bytes_per_device", "collective_bytes_per_device",
                  "collectives", "compute_s", "memory_s", "collective_s", "bottleneck",
                  "model_flops", "useful_flops_fraction", "mfu_bound"}
RENAMED_AND_ADDED = {"flops_per_device", "bytes_accessed_per_device", "collectives_by_axis",
                     "assumptions"}


@pytest.fixture(scope="module")
def run():
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                                  OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _layer(run, mode, key):
    cells = run["cells"]
    a, b = cells[f"{mode}|1"], cells[f"{mode}|2"]
    if isinstance(a[key], dict):
        return {k: b[key].get(k, 0) - a[key].get(k, 0) for k in set(a[key]) | set(b[key])}
    return b[key] - a[key]


def _projection_flops(cfg, tokens):
    """2·M·N·K of one layer's matmuls on a rank's part."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    qkv = d * (cfg.num_heads + 2 * cfg.num_kv_heads) // TP * hd
    out = cfg.num_heads // TP * hd * d
    mlp = 3 * d * cfg.d_ff // TP
    return 2 * tokens * (qkv + out + mlp)


@pytest.mark.parametrize("mode", ["decode", "prefill"])
def test_serving_layer_flops_from_the_shapes(run, mode):
    cfg = configs.reduced_config("stablelm-3b")
    sq = 1 if mode == "decode" else SEQ
    attn, _ = flash_attention.cost(ROWS, cfg.num_heads // TP, cfg.num_kv_heads // TP, sq, SEQ,
                                   cfg.resolved_head_dim, True, 0, 2, 2)
    assert _layer(run, mode, "flops_per_device") == _projection_flops(cfg, ROWS * sq) + attn


def test_training_layer_flops_from_the_shapes(run):
    """The forward's projections, their recompute and the backward's two
    matmuls each (3 + 1 times), and the plain attention's two batched
    matmuls in the same four passes."""
    cfg = configs.reduced_config("stablelm-3b")
    t = ROWS * SEQ
    attn = 2 * 2 * ROWS * cfg.num_heads // TP * SEQ * SEQ * cfg.resolved_head_dim
    assert _layer(run, "train", "flops_per_device") == 4 * (_projection_flops(cfg, t) + attn)


@pytest.mark.parametrize("mode", ["decode", "prefill"])
def test_layer_collective_bytes_by_axis(run, mode):
    cfg = configs.reduced_config("stablelm-3b")
    sq = 1 if mode == "decode" else SEQ
    got = _layer(run, mode, "collectives_by_axis")
    assert got["model"] == 2 * ROWS * sq * cfg.d_model * 4
    assert got["data"] == run["cells"]["fsdp_layer_bytes"]


@pytest.mark.parametrize("mode,want", [
    ("decode", {"flash_attention": 1, "tree_logprob_all": 1}),
    ("prefill", {"flash_attention": 1, "tree_logprob_all": 1}),
    ("train", {"sampled_head_loss": 1, "segment_stats": 6, "segment_plan": 4})])
def test_kernel_launches(run, mode, want):
    """At 1 layer the whole step's launches; a layer adds one
    ``flash_attention`` to a serving step and nothing to a training step."""
    one = run["cells"][f"{mode}|1"]["kernels"]
    assert one == want
    assert _layer(run, mode, "kernels") == {k: int(k == "flash_attention" and mode != "train")
                                            for k in want}


def test_prefill_counts_flash_attention_not_the_logits(run):
    cell = run["cells"]["prefill|2"]
    assert cell["kernels"]["flash_attention"] == 2
    assert cell["shapes"] and not any(s[-2:] == [SEQ, SEQ] for s in cell["shapes"]), \
        "a (B, H, S, S) tensor was made"


def test_statuses_and_artifact_keys(run):
    arts = run["artifacts"]
    skipped = arts["stablelm-3b_long_500k_single_adversarial_ns.json"]
    assert skipped["status"] == "skipped" and "sub-quadratic" in skipped["reason"]
    assert run["rc_skip"] == 0
    err = arts["stablelm-3b_train_4k_single_adversarial_ns.json"]
    assert err["status"] == "error" and "planted" in err["error"] and "trace" in err
    assert run["rc_err"] == 1
    for key, cell in run["cells"].items():
        if key == "fsdp_layer_bytes":
            continue
        assert cell["status"] == "ok", key
        assert REFERENCE_KEYS | RENAMED_AND_ADDED <= set(cell), key
        assert not {"hlo_flops_per_device", "hlo_bytes_per_device"} & set(cell)
        assert cell["chips"] == DP * TP and cell["bytes_per_device"] == (
            cell["argument_size_in_bytes"] + cell["temp_size_in_bytes"])


def test_peak_counts_the_steps_storage_alone():
    """The step's arguments are held before it starts: an in-place update
    of one, or a view of it, allocates nothing; a new tensor does, and its
    storage leaves the live count when it dies."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.dryrun import Counter
    counter = Counter({})
    with FakeTensorMode():
        w = torch.zeros(256, 256)
        counter.adopt(w)
        with counter:
            w.mul_(2.0)
            w.detach().add_(1.0)
            assert counter.peak == 0
            x = w * 3.0
            del x
    assert counter.peak == 256 * 256 * 4 and counter.live == 0
