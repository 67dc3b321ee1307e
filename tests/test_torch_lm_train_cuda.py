"""Card tests of the port's LM training slice. This file imports no JAX, so
it runs on a machine without it:

  PYTHONPATH=src python -m pytest -q -p no:cacheprovider --noconftest -k cuda \
      tests/test_torch_lm_train_cuda.py

- ``flash_attention`` on the card refuses inputs that need gradients (its
  output has no ``grad_fn``), and the training forward never calls it.
- One sparse training step at full stablelm-3b width (2 layers) through the
  ``sampled_head_loss`` kernel against the same step through its plain
  version, on the same candidates: the loss and the head's SparseRows
  within 1e-5 absolute + 1e-5 relative, every trunk gradient within 1e-2
  of its norm (dh is rounded to bfloat16 on its way into the trunk, so one
  bfloat16 ulp, 2^-8 relative, separates the two where the float32 dh
  differ in their last bits).
"""
import contextlib
import dataclasses

import pytest
import torch

from repro_torch import configs, tree_util
from repro_torch.kernels import ops, ref
from repro_torch.models import lm_head
from repro_torch.optim import OptimizerConfig
from repro_torch.train import step as step_lib

TOL = dict(atol=1e-5, rtol=1e-5)
TRUNK_REL_TOL = 1e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels, no CPU mode)")
    return torch.device("cuda")


@contextlib.contextmanager
def _plain_sampled_loss():
    kernel = ops.sampled_head_loss
    ops.sampled_head_loss = ref.sampled_head_loss_ref
    try:
        yield
    finally:
        ops.sampled_head_loss = kernel


def test_plain_attention_on_cpu_is_differentiable():
    """On the CPU the kernel's plain version runs, under autograd; the
    training forward takes the plain attention either way."""
    q = torch.randn(1, 2, 8, 16, requires_grad=True)
    out = ops.flash_attention(q, q.detach(), q.detach())
    out.sum().backward()
    assert q.grad is not None and bool(torch.isfinite(q.grad).all())


def test_cuda_flash_attention_refuses_grad(cuda):
    q = torch.randn(2, 4, 64, 80, device=cuda, dtype=torch.bfloat16)
    k = torch.randn(2, 4, 64, 80, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="forward-only"):
        ops.flash_attention(q.clone().requires_grad_(), k, k)
    with pytest.raises(RuntimeError, match="forward-only"):
        ops.flash_attention(q, k.clone().requires_grad_(), k)
    before = ops.flash_attention.launches
    with torch.no_grad():              # no gradient wanted: the kernel runs
        out = ops.flash_attention(q, k.clone().requires_grad_(), k)
    assert ops.flash_attention.launches == before + 1 and out.grad_fn is None
    ops.flash_attention(q, k, k)       # nothing requires grad: the kernel runs
    assert ops.flash_attention.launches == before + 2


def test_cuda_full_width_sparse_step_kernel_vs_plain(cuda):
    cfg = dataclasses.replace(configs.get_config("stablelm-3b"), num_layers=2)
    hcfg = lm_head.head_config(cfg, "adversarial_ns", n_neg=1, reg=1e-4)
    state = step_lib.init_train_state(torch.Generator(device=cuda).manual_seed(0), cfg,
                                      OptimizerConfig(), "adversarial_ns", device=cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (4, 2049), generator=g, device=cuda)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "mask": torch.ones(4, 2048, device=cuda)}
    grad_fn = step_lib.make_grad_fn(cfg, hcfg)
    launches = ops.sampled_head_loss.launches
    flash = ops.flash_attention.launches
    got, got_m = grad_fn(state, batch, torch.Generator(device=cuda).manual_seed(2))
    assert ops.sampled_head_loss.launches == launches + 1
    assert ops.flash_attention.launches == flash
    with _plain_sampled_loss():
        want, want_m = grad_fn(state, batch, torch.Generator(device=cuda).manual_seed(2))
    assert ops.sampled_head_loss.launches == launches + 1
    torch.testing.assert_close(got_m["loss"], want_m["loss"], **TOL)
    assert torch.equal(got["head"].ids, want["head"].ids)
    torch.testing.assert_close(got["head"].dw, want["head"].dw, **TOL)
    torch.testing.assert_close(got["head"].db, want["head"].db, **TOL)
    assert torch.equal(got["embed"].ids, want["embed"].ids)
    pairs = [(got["embed"].dw, want["embed"].dw)] + list(zip(
        *(tree_util.leaves({k: v for k, v in gr.items() if k not in ("head", "embed")})
          for gr in (got, want))))
    for a, b in pairs:
        assert bool(torch.isfinite(a).all()) and float(a.abs().sum()) > 0
        rel = float((a.float() - b.float()).norm() / b.float().norm())
        assert rel <= TRUNK_REL_TOL, rel
