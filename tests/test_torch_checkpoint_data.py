"""The port's checkpointing and data pipeline, torch only (but for the data's
bit-equality with the JAX package): ``TestCheckpoint`` and the loader case
of ``tests/test_substrate.py``, the checkpoint, pipeline and SIGKILL chaos
cases of ``tests/test_resilience.py``, and ``TestCheckpoint`` of
``tests/test_state_memory.py`` (bfloat16 and int8 optimizer state round
trips and a mid-run resume, bit for bit)."""
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro.data import pipeline as jpipeline
from repro.data import synthetic as jsynthetic
from repro_torch import tree_util
from repro_torch.checkpoint import (latest_step, restore_checkpoint, save_checkpoint,
                                    verify_checkpoint)
from repro_torch.core import heads as heads_lib
from repro_torch.core import tree as tree_lib
from repro_torch.core.heads import HeadConfig, HeadParams
from repro_torch.data import HostShardedLoader, ProducerError, lm_batch_fn, zipf_token_stream
from repro_torch.optim import OptimizerConfig, apply_updates, init_opt_state
from repro_torch.resilience import faults
from repro_torch.resilience.faults import Fault, FaultPlan, InjectedFault

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """The model here is tiny: one thread per op is as fast, and leaves the
    other test workers' cores alone (the default spins a thread per core
    in every op)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _assert_trees_equal(a, b):
    la, sa = tree_util.flatten(a)
    lb, sb = tree_util.flatten(b)
    assert sa == sb
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.shape == y.shape
            assert torch.equal(x, y)
        else:
            assert type(x) is type(y) and x == y


# ---------------------------------------------------------------------------
# tests/test_substrate.py::TestCheckpoint
# ---------------------------------------------------------------------------

def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(8, 4, generator=g),
            "b": {"c": torch.arange(5), "d": 3.5, "e": [torch.randn(3, generator=g)
                                                        .to(torch.bfloat16), None, 7]}}


def test_roundtrip_bit_exact(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 7, t)
    restored, step = restore_checkpoint(str(tmp_path), t)
    assert step == 7
    _assert_trees_equal(t, restored)


def test_latest_pointer_and_gc(tmp_path):
    t = _tree()
    for s in (1, 2, 3, 4, 5):
        save_checkpoint(str(tmp_path), s, t, keep=2)
    assert latest_step(str(tmp_path)) == 5
    assert sorted(d for d in os.listdir(tmp_path) if d.startswith("step_")) == [
        "step_00000004", "step_00000005"]


def test_no_partial_checkpoint_visible(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 1, t)
    os.makedirs(tmp_path / ".tmp_ckpt_dead", exist_ok=True)
    (tmp_path / ".tmp_ckpt_dead" / "arr_00000.npy").write_bytes(b"junk")
    assert latest_step(str(tmp_path)) == 1
    restored, _ = restore_checkpoint(str(tmp_path), t)
    assert len(tree_util.leaves(restored)) == 5


def test_restore_follows_the_like_trees_devices_and_types(tmp_path):
    """Device independence: leaves come back where ``tree_like`` has them
    (here the CPU) with the saved dtypes, Python numbers as numbers."""
    t = _tree(1)
    save_checkpoint(str(tmp_path), 2, t)
    like = tree_util.tree_map(lambda x: torch.zeros_like(x) if isinstance(x, torch.Tensor)
                              else x, t)
    restored, _ = restore_checkpoint(str(tmp_path), like)
    _assert_trees_equal(t, restored)
    with open(tmp_path / "step_00000002" / "manifest.json") as f:
        dtypes = [leaf["dtype"] for leaf in json.load(f)["leaves"]]
    assert dtypes == ["float32", "int64", "float64", "bfloat16", "int64"]


# ---------------------------------------------------------------------------
# tests/test_resilience.py: checkpoint integrity
# ---------------------------------------------------------------------------

def _tiny_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": torch.from_numpy(rng.normal(size=(4, 3)).astype(np.float32)),
            "b": torch.from_numpy(rng.normal(size=(3,)).astype(np.float32))}


def _damage(path, mode):
    arr = os.path.join(path, "arr_00000.npy")
    man = os.path.join(path, "manifest.json")
    if mode == "flip_byte":
        with open(arr, "r+b") as f:
            f.seek(-1, 2)
            last = f.read(1)
            f.seek(-1, 2)
            f.write(bytes([last[0] ^ 0xFF]))
    elif mode == "truncate_arr":
        with open(arr, "r+b") as f:
            f.truncate(max(os.path.getsize(arr) // 2, 1))
    elif mode == "delete_manifest":
        os.remove(man)
    elif mode == "garbage_manifest":
        with open(man, "w") as f:
            f.write("{not json")
    elif mode == "delete_arr":
        os.remove(arr)


@pytest.mark.parametrize("mode", ["flip_byte", "truncate_arr", "delete_manifest",
                                  "garbage_manifest", "delete_arr"])
def test_restore_never_returns_corrupt_state(tmp_path, mode):
    d = str(tmp_path)
    for step in (1, 2, 3):
        save_checkpoint(d, step, _tiny_tree(step), keep=0)
    newest = os.path.join(d, "step_00000003")
    assert verify_checkpoint(newest)
    _damage(newest, mode)
    assert not verify_checkpoint(newest)
    assert latest_step(d) == 2
    tree, got = restore_checkpoint(d, _tiny_tree(0))
    assert got == 2
    assert torch.equal(tree["w"], _tiny_tree(2)["w"])
    with pytest.raises((IOError, FileNotFoundError)):
        restore_checkpoint(d, _tiny_tree(0), step=3)


def test_latest_step_ignores_stale_tmp_dirs(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 5, _tiny_tree(5), keep=0)
    os.makedirs(os.path.join(d, ".tmp_ckpt_dead"))
    with open(os.path.join(d, ".tmp_ckpt_dead", "arr_00000.npy"), "wb") as f:
        f.write(b"\x00" * 16)
    assert latest_step(d) == 5


def test_injected_raise_mid_save_leaves_no_tmp(tmp_path):
    d = str(tmp_path)
    with faults.install(FaultPlan([Fault("checkpoint/write", 0, "raise")])):
        with pytest.raises(InjectedFault):
            save_checkpoint(d, 1, _tiny_tree(1), keep=0)
    assert not any(n.startswith(".tmp") for n in os.listdir(d))
    assert latest_step(d) is None
    save_checkpoint(d, 1, _tiny_tree(1), keep=0)
    assert latest_step(d) == 1


# ---------------------------------------------------------------------------
# tests/test_state_memory.py::TestCheckpoint
# ---------------------------------------------------------------------------

C, KDIM, KG = 40, 12, 4


def _fitted(ocfg, steps=3):
    """A head trained ``steps`` sparse steps, and a function for more."""
    cfg = HeadConfig(num_labels=C, kind="adversarial_ns", n_neg=2, reg=1e-3)
    g = torch.Generator().manual_seed(0)
    gen = heads_lib.make_tree_generator(tree_lib.init_tree(g, C, KG, scale=0.5,
                                                           device="cpu"))
    h = torch.randn(48, KDIM, generator=g)
    xg = torch.randn(48, KG, generator=g)
    y = torch.randint(0, C, (48,), generator=g)
    params = heads_lib.init_head_params(g, C, KDIM, device="cpu")
    if ocfg.state_dtype != "fp32":
        params = HeadParams(w=params.w.to(torch.bfloat16), b=params.b.to(torch.bfloat16))
    opt = init_opt_state(ocfg, params)

    def more(params, opt, n, base):
        for s in range(n):
            _, _, rows, _ = heads_lib.sparse_head_loss(
                cfg, params, gen, h, xg, y, torch.Generator().manual_seed(41 + base + s))
            params, opt, _ = apply_updates(ocfg, params, rows, opt)
        return params, opt

    params, opt = more(params, opt, steps, 0)
    return params, opt, more


@pytest.mark.parametrize("name,sd", [("sm3", "bf16"), ("adamw", "int8")])
def test_optimizer_state_round_trip_bit_stable(tmp_path, name, sd):
    ocfg = OptimizerConfig(name=name, learning_rate=0.05, state_dtype=sd)
    params, opt, _ = _fitted(ocfg)
    tree = {"params": params, "opt": opt}
    save_checkpoint(str(tmp_path), 3, tree)
    got, step = restore_checkpoint(str(tmp_path), tree)
    assert step == 3
    _assert_trees_equal(tree, got)


def test_resume_mid_run_replays_exactly(tmp_path):
    ocfg = OptimizerConfig(name="sm3", learning_rate=0.05, state_dtype="bf16")
    params, opt, more = _fitted(ocfg, steps=3)
    save_checkpoint(str(tmp_path), 3, {"params": params, "opt": opt})
    snap = tree_util.tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor) else x,
                              {"params": params, "opt": opt})
    pa, oa = more(params, opt, 2, 3)          # straight through (in place)
    got, _ = restore_checkpoint(str(tmp_path), snap)
    pb, ob = more(got["params"], got["opt"], 2, 3)
    _assert_trees_equal((pa, oa), (pb, ob))


# ---------------------------------------------------------------------------
# The data: bit-equal to the JAX package's; the host-sharded loader
# ---------------------------------------------------------------------------

def test_lm_batch_fn_and_token_stream_bit_equal_to_jax():
    for args in ((101, 8, 16, 0), (50_304, 2, 33, 3)):
        want = jpipeline.lm_batch_fn(*args[:3], seed=args[3])
        got = lm_batch_fn(*args[:3], seed=args[3])
        for step in (0, 5, 10_000):
            w, g = want(step), got(step)
            assert set(w) == set(g)
            for k in w:
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k])
    it_w = jsynthetic.zipf_token_stream(97, 3, 12, seed=4, n_clusters=8)
    it_g = zipf_token_stream(97, 3, 12, seed=4, n_clusters=8)
    for _ in range(3):
        np.testing.assert_array_equal(next(it_g), next(it_w))


def test_host_sharded_loader_slices_and_seeks():
    fn = lm_batch_fn(vocab_size=101, global_batch=8, seq_len=16, seed=0)
    loaders = [HostShardedLoader(fn, 8, num_hosts=2, host_id=h, prefetch=0)
               for h in (0, 1)]
    its = [iter(ld) for ld in loaders]
    s0, b0 = next(its[0])
    s1, b1 = next(its[1])
    assert s0 == s1 == 0
    assert b0["tokens"].shape == (4, 16)
    np.testing.assert_array_equal(np.concatenate([b0["tokens"], b1["tokens"]]),
                                  fn(0)["tokens"])
    loaders[0].seek(5)
    s, b = next(iter(loaders[0]))
    assert s == 5
    np.testing.assert_array_equal(b["tokens"], fn(5)["tokens"][:4])
    for ld in loaders:
        ld.close()


def test_pipeline_producer_exception_propagates():
    def boom(step):
        if step >= 2:
            raise ValueError("bad shard")
        return {"tokens": np.zeros((4, 4), np.int32)}

    ld = HostShardedLoader(boom, 4, prefetch=2)
    seen = []
    with pytest.raises(ProducerError, match="bad shard"):
        for s, b in ld:
            seen.append(s)
            if len(seen) > 10:
                break
    assert seen == [0, 1]
    assert not ld.failed


def test_pipeline_injected_producer_fault():
    ld = HostShardedLoader(lm_batch_fn(64, 4, 8), 4, prefetch=2)
    with faults.install(FaultPlan([Fault("data/produce", 2, "raise")])):
        with pytest.raises(ProducerError) as exc:
            for s, b in ld:
                pass
    assert isinstance(exc.value.__cause__, InjectedFault)


def test_pipeline_wedged_producer_marks_failed():
    started = []

    def slow(step):
        started.append(step)
        if step == 0:
            return {"tokens": np.zeros((4, 4), np.int32)}
        time.sleep(1200)               # daemon thread; dies with the process

    ld = HostShardedLoader(slow, 4, prefetch=1)
    it = iter(ld)
    next(it)
    deadline = time.perf_counter() + 5
    while len(started) < 2 and time.perf_counter() < deadline:
        time.sleep(0.01)
    ld.close()
    assert ld.failed
    with pytest.raises(AssertionError):
        next(iter(ld))


# ---------------------------------------------------------------------------
# tests/test_resilience.py: kill -9 mid-checkpoint / mid-gensnap
# ---------------------------------------------------------------------------

_VICTIM = """
import dataclasses, sys
import torch
from repro_torch import configs as cfg_lib
from repro_torch.data import lm_batch_fn
from repro_torch.models import lm_head
from repro_torch.optim import OptimizerConfig
from repro_torch.train import LoopConfig, init_train_state, make_train_step, run_loop

ckpt, variant = sys.argv[1], sys.argv[2]
gen = variant == "gen"
cfg = dataclasses.replace(cfg_lib.reduced_config("stablelm-3b"), num_layers=1,
                          dtype="float32")
hcfg = lm_head.head_config(cfg, "adversarial_ns", reg=1e-4)
opt = OptimizerConfig(name="adagrad", learning_rate=0.05, clip_norm=1.0)
state = init_train_state(torch.Generator().manual_seed(0), cfg, opt, "adversarial_ns",
                         device="cpu")
step_fn = make_train_step(cfg, hcfg, opt, skip_nonfinite=True)
make = lm_batch_fn(cfg.vocab_size, global_batch=4, seq_len=16, seed=1)
batch_fn = lambda s: {k: torch.as_tensor(v) for k, v in make(s).items()}
gen_fit = None
if gen:
    from repro_torch.train.generator_fit import make_gen_fit_fn
    gen_fit = make_gen_fit_fn(cfg, batch_fn, kind="adversarial_ns", max_tokens=128,
                              n_batches=2)
loop = LoopConfig(total_steps=12, checkpoint_every=4, checkpoint_dir=ckpt,
                  gen_warmup_steps=2 if gen else 0, gen_refresh_steps=4 if gen else 0,
                  gen_async=gen, gen_swap_delay=2 if gen else 0)
state, hist = run_loop(state, step_fn, batch_fn, loop, 7, gen_fit_fn=gen_fit)
print("DONE", state.step, flush=True)
"""


def _run_victim(script, ckpt, variant, extra_env=None, wait=True):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    env.pop("REPRO_FAULT_PLAN", None)
    if extra_env:
        env.update(extra_env)
    proc = subprocess.Popen([sys.executable, script, ckpt, variant], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    if not wait:
        return proc
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err
    assert "DONE 12" in out, (out, err)
    return proc


def _final_crcs(ckpt):
    with open(os.path.join(ckpt, "step_00000012", "manifest.json")) as f:
        return [leaf["crc32"] for leaf in json.load(f)["leaves"]]


@pytest.mark.parametrize("variant,site,nth", [
    ("plain", "checkpoint/commit", 1),     # kill mid-commit of ckpt 8
    ("gen", "checkpoint/write", 2),        # kill mid-write of gensnap 6
])
def test_sigkill_mid_save_resumes_bit_exact(tmp_path, variant, site, nth):
    """SIGKILL a training process while a checkpoint (or gensnap) is
    mid-write: the torn artifact is invisible to resume, and the resumed
    run replays to a bit-identical final state."""
    script = str(tmp_path / "victim.py")
    with open(script, "w") as f:
        f.write(_VICTIM)
    ref = str(tmp_path / "ref")
    _run_victim(script, ref, variant)
    ref_crcs = _final_crcs(ref)

    kill_dir = str(tmp_path / "kill")
    plan = FaultPlan([Fault(site, nth, "delay", seconds=600.0)])
    proc = _run_victim(script, kill_dir, variant, wait=False,
                       extra_env={"REPRO_FAULT_PLAN": plan.to_json()})
    try:
        deadline = time.perf_counter() + 240
        while time.perf_counter() < deadline:
            if proc.poll() is not None:
                out, err = proc.communicate()
                raise AssertionError(f"victim exited early: {err}")
            names = os.listdir(kill_dir) if os.path.isdir(kill_dir) else []
            if "step_00000004" in names and any(n.startswith(".tmp_ckpt_")
                                                for n in names):
                break
            time.sleep(0.05)
        else:
            raise AssertionError("victim never reached the delayed save")
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert [n for n in os.listdir(kill_dir) if n.startswith(".tmp_ckpt_")]
    assert latest_step(kill_dir) == 4
    _run_victim(script, kill_dir, variant)
    assert latest_step(kill_dir) == 12
    assert _final_crcs(kill_dir) == ref_crcs
