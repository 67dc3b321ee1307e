"""Card tests of the backbone's last slice: ``flash_attention`` at the
geometries the new families give it, the mixture-of-experts dispatch and
the SSD scan on the card. This file imports no JAX, so it runs on a machine
without it:

  PYTHONPATH=src python -m pytest -q -p no:cacheprovider --noconftest -k cuda \
      tests/test_torch_families_cuda.py

- ``flash_attention`` (hymba-1.5b: G = 5, hd 64, window 1,024; qwen2-vl-7b:
  G = 7, hd 128; deepseek-moe-16b: G = 1, hd 128; mixtral-8x22b: G = 6,
  hd 128, window 4,096), prefill on the tensor-core kernel and decode on
  the decode kernel, against the plain version: each output within one
  bf16 ulp of its (b, h, i) row's scale plus one rounding of its own
  value, and 2^-11 relative RMS over the whole output (the tolerance of
  ``tests/test_torch_flash_attention.py``); two calls bit-equal.
- ``moe_ffn`` at full width, one layer, bf16: two calls bit-equal (the
  combine gathers; nothing adds with atomics), and at capacity factor 8
  against ``moe_ffn_dense_oracle`` (float32 over the same bf16 weights)
  within 2^-6 relative RMS: the dispatch rounds g, u, silu(g)·u and the
  expert output to bf16, each 2^-9 relative on average.
- ``ssd_chunked`` against ``ssd_sequential`` at mamba2-370m's heads and
  chunk, float32, within 1e-4 relative RMS, and its ``dt`` gradient finite.

The CPU cases check which kernel each geometry selects (the selection is
host code) and that the CPU takes the plain version.
"""
import dataclasses

import pytest
import torch
from test_torch_flash_attention import _card_close

from repro_torch import configs
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import decode_path, tensor_core_path
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib

# (name, B, H, KV, Sq, Skv, hd, window): each family's prefill and decode.
GEOMETRIES = [
    ("hymba_prefill", 2, 25, 5, 1100, 1100, 64, 1024),
    ("hymba_decode", 8, 25, 5, 1, 1100, 64, 1024),
    ("qwen2vl_prefill", 1, 28, 4, 600, 600, 128, 0),
    ("qwen2vl_decode", 2, 28, 4, 1, 2080, 128, 0),
    ("deepseek_moe_prefill", 1, 16, 16, 300, 300, 128, 0),
    ("deepseek_moe_decode", 4, 16, 16, 1, 2080, 128, 0),
    ("mixtral_prefill", 1, 48, 8, 500, 500, 128, 4096),
    ("mixtral_decode", 2, 48, 8, 1, 4200, 128, 4096),
]
IDS = [g[0] for g in GEOMETRIES]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels, no CPU mode)")
    return torch.device("cuda")


def _qkv(case, device):
    _, b, h, kv, sq, skv, hd, _ = case
    gen = torch.Generator(device=device).manual_seed(sq * 31 + h)
    q = torch.randn((b, h, sq, hd), generator=gen, device=device).bfloat16()
    k = torch.randn((b, kv, skv, hd), generator=gen, device=device).bfloat16()
    v = torch.randn((b, kv, skv, hd), generator=gen, device=device).bfloat16()
    return q, k, v


@pytest.mark.parametrize("case", GEOMETRIES, ids=IDS)
def test_geometry_selects_its_kernel(case):
    """Decode (Sq * G <= 16) takes the decode kernel, prefill the
    tensor-core kernel (hd <= 128, unsplit); on CPU tensors the wrapper
    runs the plain version."""
    q, k, v = _qkv(case, torch.device("cpu"))
    decode = case[4] == 1
    assert decode_path(q, k, v) == decode
    assert tensor_core_path(q, k, v, split=1) == (not decode)
    if case[4] * case[5] <= 600 * 600:
        window = case[7]
        before = ops.flash_attention.launches
        got = ops.flash_attention(q[:, :, :64], k[:, :, :64], v[:, :, :64], window=window)
        want = tref.flash_attention_ref(q[:, :, :64], k[:, :, :64], v[:, :, :64], window=window)
        assert ops.flash_attention.launches == before and torch.equal(got, want)


@pytest.mark.parametrize("case", GEOMETRIES, ids=IDS)
def test_cuda_new_geometries_match_plain(cuda, case):
    q, k, v = _qkv(case, cuda)
    window = case[7]
    decode = case[4] == 1
    counter = "decode_launches" if decode else "tensor_core_launches"
    before = getattr(ops.flash_attention, counter)
    got = ops.flash_attention(q, k, v, window=window)
    again = ops.flash_attention(q, k, v, window=window)
    want = tref.flash_attention_ref(q, k, v, window=window)
    torch.cuda.synchronize()
    assert getattr(ops.flash_attention, counter) == before + 2
    assert torch.equal(got, again)
    assert _card_close(got, want), float((got.float() - want.float()).abs().max())


def _rel_rms(got, want):
    g, w = got.float(), want.float()
    return float((g - w).pow(2).mean().sqrt() / w.pow(2).mean().sqrt())


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "mixtral-8x22b"])
def test_cuda_moe_bit_equal_and_oracle(cuda, arch):
    cfg = dataclasses.replace(configs.get_config(arch), capacity_factor=8.0)
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = moe_lib.init_moe(gen, cfg, device=cuda)
    params = {k: (v if k == "router" else
                  {kk: vv.bfloat16() for kk, vv in v.items()} if isinstance(v, dict)
                  else v.bfloat16()) for k, v in params.items()}
    x = torch.randn((2, 256, cfg.d_model), generator=gen, device=cuda).bfloat16()
    y1, m1 = moe_lib.moe_ffn(params, cfg, x)
    y2, m2 = moe_lib.moe_ffn(params, cfg, x)
    assert torch.equal(y1, y2) and all(torch.equal(m1[k], m2[k]) for k in m1)
    assert float(m1["moe_dropped_frac"]) == 0.0
    assert _rel_rms(y1, moe_lib.moe_ffn_dense_oracle(params, cfg, x)) <= 2.0 ** -6


def test_cuda_ssd_chunked_matches_sequential(cuda):
    cfg = configs.get_config("mamba2-370m")
    b, s, h, p, n = 1, 1024, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((b, s, h, p), generator=gen, device=cuda)
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=gen, device=cuda) - 0.5)
    a = -torch.exp(0.3 * torch.randn((h,), generator=gen, device=cuda))
    bm = torch.randn((b, s, n), generator=gen, device=cuda) / n ** 0.5
    cm = torch.randn((b, s, n), generator=gen, device=cuda) / n ** 0.5
    d = torch.ones((h,), device=cuda)
    dt.requires_grad_()
    y, state = ssm_lib.ssd_chunked(x, dt, a, bm, cm, d, cfg.ssm_chunk)
    (g_dt,) = torch.autograd.grad(y.sum(), dt)
    with torch.no_grad():
        y_ref, state_ref = ssm_lib.ssd_sequential(x, dt, a, bm, cm, d)
    assert _rel_rms(y.detach(), y_ref) <= 1e-4 and _rel_rms(state.detach(), state_ref) <= 1e-4
    assert bool(torch.isfinite(g_dt).all())
