"""The serving engine over SSM and hybrid models (``repro_torch.serve`` with
``repro_torch.models.ssm``): ``tests/test_serve_engine.py::
test_ssm_engine_matches_oracle_mixed_lengths`` mirrored, a hybrid case
(attention pages and lane-indexed SSM rows side by side), the paged steps
against the JAX package's ``make_batched_prefill`` / ``make_paged_decode``
on reduced mamba2-370m and hymba-1.5b, spill and restore of a lane's SSM
rows byte for byte, and the refusal of prefix sharing and speculative
decode for recurrent state.

Engine against lock-step is torch against torch in float32: token ids
equal (the engine's outputs are a pure function of the prompt). Against
JAX, float32 within 2e-4 (two layers of float32 matmuls and the chunked
scan summed in another order, as ``tests/test_torch_lm.py``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as jtransformer
from repro.train import step as jstep
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.models import lm_head, transformer
from repro_torch.serve import Engine, Request, ServeConfig, lockstep_decode
from repro_torch.serve.cache_pool import PagedPool
from repro_torch.train import step as tstep

F32_TOL = dict(atol=2e-4, rtol=2e-4)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _model(arch):
    cfg = dataclasses.replace(tconfigs.reduced_config(arch), dtype="float32", remat=False)
    params = transformer.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    hs = lm_head.default_head_state(torch.Generator().manual_seed(1), cfg, "adversarial_ns",
                                    device="cpu")
    return cfg, lm_head.head_config(cfg, "adversarial_ns"), params, hs


def _prompts(cfg, lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lengths]


def test_ssm_engine_matches_oracle_mixed_lengths():
    """SSM models through the paged engine: recurrent state is not
    position-local, so the batched prefill groups by exact prompt length
    instead of padding the length. Mixed lengths, one shorter than the conv
    window, match the per-request oracle token for token."""
    cfg, hcfg, params, hs = _model("mamba2-370m")
    prompts = _prompts(cfg, (5, 3, 5, 2), 3)     # 2 < ssm_conv_width - 1
    refs = [lockstep_decode(cfg, hcfg, params, hs, p[None], 3, topk_beam=0)[0]
            for p in prompts]
    eng = Engine(cfg, hcfg, params, hs, ServeConfig(
        n_slots=4, max_len=12, beam=0, page_len=3, cache_dtype=torch.float32))
    # Pure SSM has no K/V arena: one nominal page per lane.
    assert eng.pool.page_len == 12 and eng.pool.n_pages == 4
    assert set(eng.pool.cache) == {"conv", "state"}
    handles = [eng.submit(Request(prompt=p, max_new_tokens=3)) for p in prompts]
    eng.run()
    for h, ref in zip(handles, refs):
        np.testing.assert_array_equal(h.result(), ref)
    # One prefill launch per distinct prompt length; FIFO audit trail kept.
    assert eng.prefill_calls == 3
    assert list(eng.admission_order) == [h.request_id for h in handles]
    eng.pool.check_invariants()


@pytest.mark.parametrize("beam", [0, 8])
def test_hybrid_engine_matches_oracle_mixed_lengths(beam):
    """hymba's parallel attention and SSM: pages of 3 for the K/V, lanes for
    the SSM rows, prompts past the window of 8, more requests than lanes."""
    cfg, hcfg, params, hs = _model("hymba-1.5b")
    prompts = _prompts(cfg, (10, 3, 10, 2, 9), 5)
    refs = [lockstep_decode(cfg, hcfg, params, hs, p[None], 4, topk_beam=beam)[0]
            for p in prompts]
    eng = Engine(cfg, hcfg, params, hs, ServeConfig(
        n_slots=3, max_len=16, beam=beam, page_len=3, cache_dtype=torch.float32))
    assert set(eng.pool.cache) == {"k", "v", "conv", "state"}
    handles = [eng.submit(Request(prompt=p, max_new_tokens=4)) for p in prompts]
    eng.run()
    for h, ref in zip(handles, refs):
        np.testing.assert_array_equal(h.result(), ref)
    eng.pool.check_invariants()
    assert eng.pool.num_in_use == 0


def test_hybrid_preemption_restores_lane_rows():
    """A higher class preempts a running hybrid request: its pages and SSM
    rows spill to the host and come back in another lane, and both requests
    still decode the oracle's tokens."""
    cfg, hcfg, params, hs = _model("hymba-1.5b")
    whale_p, quick_p = _prompts(cfg, (5, 4), 137)
    ref_w = lockstep_decode(cfg, hcfg, params, hs, whale_p[None], 7)[0]
    ref_q = lockstep_decode(cfg, hcfg, params, hs, quick_p[None], 3)[0]
    eng = Engine(cfg, hcfg, params, hs, ServeConfig(
        n_slots=2, max_len=12, beam=0, page_len=3, n_pages=6, preemption=True,
        cache_dtype=torch.float32))
    hw = eng.submit(Request(prompt=whale_p, max_new_tokens=7, priority=0))
    eng.step()
    hq = eng.submit(Request(prompt=quick_p, max_new_tokens=3, priority=1))
    eng.run()
    np.testing.assert_array_equal(hw.result(), ref_w)
    np.testing.assert_array_equal(hq.result(), ref_q)
    st = eng.stats()["sched"]
    assert st["preemptions"] >= 1 and st["restores"] >= 1
    eng.pool.check_invariants()


@pytest.mark.parametrize("arch", ["mamba2-370m", "hymba-1.5b"])
def test_spill_restore_lane_rows_byte_for_byte(arch):
    cfg = tconfigs.reduced_config(arch)
    pool = PagedPool(cfg, n_lanes=3, n_pages=6, page_len=4, max_len=8,
                     dtype=torch.bfloat16, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for leaf in pool.cache.values():
        leaf.copy_(torch.randn(leaf.shape, generator=gen).to(leaf.dtype))
    assert pool.cache["conv"].dtype == pool.cache["state"].dtype == torch.float32
    lane, pages = pool.alloc(2)
    before = {k: v.clone() for k, v in pool.cache.items()}
    image = pool.spill(lane)
    assert set(image.lane_rows) == {"conv", "state"}
    pool.release(lane)
    other, _ = pool.alloc(1)              # the spilled lane is taken, and
    for leaf in pool.cache.values():      # every byte is overwritten
        leaf.copy_(torch.randn(leaf.shape, generator=gen).to(leaf.dtype))
    new_lane, new_pages = pool.restore(image)
    assert new_lane != lane and other == lane
    for key in ("conv", "state"):
        assert torch.equal(pool.cache[key][:, new_lane], before[key][:, lane])
    for key in set(pool.cache) & {"k", "v"}:
        assert torch.equal(pool.cache[key][:, new_pages], before[key][:, pages])
    pool.check_invariants()


@pytest.mark.parametrize("arch", ["mamba2-370m", "hymba-1.5b"])
def test_ssm_refuses_sharing_and_speculation(arch):
    cfg, hcfg, params, hs = _model(arch)
    for flag in ("prefix_sharing", "spec_decode"):
        with pytest.raises(AssertionError, match="recurrent state"):
            Engine(cfg, hcfg, params, hs, ServeConfig(n_slots=2, max_len=12, **{flag: True}))
    with pytest.raises(AssertionError, match="recurrent"):
        tstep.make_paged_prefill(cfg)


@pytest.mark.parametrize("arch", ["mamba2-370m", "hymba-1.5b"])
def test_paged_steps_match_reference(arch):
    """Batched prefill of two equal-length prompts and a padding row (an
    out-of-range lane, dropped) into lanes 2 and 0 and out-of-order pages,
    then two paged decode steps with a free lane: hiddens, every lane row
    written, and the mapped pages against the reference's."""
    jcfg = dataclasses.replace(jconfigs.reduced_config(arch), dtype="float32")
    tcfg = dataclasses.replace(tconfigs.reduced_config(arch), dtype="float32")
    params = jtransformer.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = convert.lm_params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    page_len, n_phys, n_lanes = 4, 10, 3
    sink = n_phys - 1
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, jcfg.vocab_size, (3, 9)).astype(np.int32)
    lengths = np.array([9, 9, 0], np.int32)
    lanes = np.array([2, 0, n_lanes], np.int32)
    tables = np.array([[5, 2, 7, 1], [0, 3, 6, 8], [sink] * 4], np.int32)
    jarena = jtransformer.init_paged_cache(jcfg, n_lanes, n_phys, page_len, dtype=jnp.float32)
    tarena = transformer.init_paged_cache(tcfg, n_lanes, n_phys, page_len,
                                          dtype=torch.float32, device="cpu")
    mapped = [5, 2, 7, 1, 0, 3, 6, 8]

    def arenas_close():
        for key in jarena:
            if key in ("k", "v"):
                got, want = tarena[key][:, mapped], jarena[key][:, np.array(mapped)]
            else:
                got, want = tarena[key][:, [0, 2]], jarena[key][:, np.array([0, 2])]
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL, err_msg=key)

    jh, jarena = jax.jit(jstep.make_batched_prefill(jcfg, page_len, sink,
                                                    cache_dtype=jnp.float32))(
        params, tokens, lengths, lanes, jarena, tables)
    th, tarena = tstep.make_batched_prefill(tcfg, page_len, sink, cache_dtype=torch.float32)(
        tparams, tokens, lengths, lanes, tarena, tables)
    np.testing.assert_allclose(th[:2].numpy(), np.asarray(jh[:2]), **F32_TOL)
    arenas_close()
    assert not tarena["conv"][:, 1].any()          # lane 1 untouched

    # Decode rows are lanes: 0 and 2 live at position 9 (then 10), 1 free.
    dtab = np.full((n_lanes, 4), sink, np.int32)
    dtab[2], dtab[0] = tables[0], tables[1]
    for step in range(2):
        token = rng.integers(0, jcfg.vocab_size, (n_lanes, 1)).astype(np.int32)
        pos = np.array([9 + step, 0, 9 + step], np.int32)
        jh, jarena = jax.jit(jstep.make_paged_decode(jcfg))(params, token, jarena, pos, dtab)
        th, tarena = tstep.make_paged_decode(tcfg)(tparams, token, tarena, pos, dtab)
        np.testing.assert_allclose(th[[0, 2]].numpy(), np.asarray(jh[np.array([0, 2])]),
                                   **F32_TOL)
        arenas_close()


@pytest.mark.parametrize("arch", ["mamba2-370m", "hymba-1.5b", "mixtral-8x22b",
                                  "deepseek-moe-16b", "qwen2-vl-7b"])
def test_launchers_run_every_new_arch(arch, capsys):
    """``python -m repro_torch.launch.serve`` (engine and lock-step) and
    ``python -m repro_torch.launch.train`` at the reduced config on the CPU."""
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train
    common = ["--arch", arch, "--reduced", "--device", "cpu"]
    assert launch_serve.main(common + ["--batch", "2", "--prompt-len", "5", "--gen", "3"]) == 0
    assert launch_serve.main(common + ["--lockstep", "--batch", "2", "--prompt-len", "5",
                                       "--gen", "3", "--topk-beam", "8"]) == 0
    _, hist = launch_train.main(common + ["--steps", "2", "--batch", "2", "--seq", "8"])
    out = capsys.readouterr().out
    assert "engine: 2 requests" in out and "lock-step" in out and "final loss" in out
    assert np.isfinite(hist["loss"]).all()
