"""PyTorch and CUDA port of :mod:`repro` for NVIDIA Hopper.

The port grows slice by slice beside the JAX package and keeps its module
names and public layouts (leaf order, slot 0 is the positive, (B, C)
outputs). It imports ``torch`` and numpy only: nothing of ``jax`` and
nothing of ``repro``.

Entry points that create tensors put them on ``device="cuda"`` unless the
caller asks for another device (the CPU tests pass ``device="cpu"``);
functions on tensors follow their inputs' device. Randomness comes from an
explicit ``torch.Generator`` or from uniforms passed in.

Slice 1 is prediction with Eq. 5 bias removal: :mod:`repro_torch.core.tree`,
the prediction half of :mod:`repro_torch.core.heads` and
:mod:`repro_torch.core.samplers`, and the hand-written CUDA kernels
``gather_scores`` and ``tree_logprob_all`` in :mod:`repro_torch.kernels`.
"""
