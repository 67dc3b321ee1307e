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
the prediction half of :mod:`repro_torch.core.heads`, the log-probs of
:mod:`repro_torch.core.samplers`, and the hand-written CUDA kernels
``gather_scores`` and ``tree_logprob_all`` in :mod:`repro_torch.kernels`.

Slice 2 is training, steps 1–2 of the paper's pipeline:
:mod:`repro_torch.data.synthetic`, the tree fit of
:mod:`repro_torch.core.tree_fit`, the samplers' draws, the training losses
of :mod:`repro_torch.core.heads` (dense under autograd, and sparse through
the hand-written CUDA kernel ``sampled_head_loss``),
:mod:`repro_torch.optim` (``SparseRows``, Adagrad and SGD with in-place row
updates) and :mod:`repro_torch.core.xc_train`.

Slice 3 fits the generator at the paper's size: :mod:`repro_torch.genfit`
(level-parallel, warm-refit and subtree-sharded fitting, deterministic bit
for bit) with :mod:`repro_torch.parallel`, its segment sums in the
hand-written CUDA kernel ``segment_stats``.

Slice 4 serves an LM lock-step: :mod:`repro_torch.configs` (the attention
configs without experts), :mod:`repro_torch.models` (layers, the decoder
stack with a contiguous KV cache, the serving half of the LM head),
:mod:`repro_torch.train.step` (``make_prefill``, ``make_serve_step``) and
:mod:`repro_torch.launch.serve`, with attention in the hand-written CUDA
kernel ``flash_attention``.

Slice 5 completes the head math and adds the observability layer:
:mod:`repro_torch.core.snr` (the gradient SNR of Theorem 2), the LSH and
RFF proposals and ``fit_sampler`` in :mod:`repro_torch.core.samplers`,
AdamW with its exact lazy catch-up, SM3 and bf16/int8 head state in
:mod:`repro_torch.optim` (with :mod:`repro_torch.optim.compression`), and
:mod:`repro_torch.obs` and :mod:`repro_torch.resilience` (metrics, spans
as ``torch.profiler`` ranges, exporters, fault injection). It adds no
kernel: its training steps run ``sampled_head_loss`` and its SNR tables
``tree_logprob_all``.

Slice 8 completes the LM backbone: the Mamba-2 SSD block
(:mod:`repro_torch.models.ssm`), the mixture-of-experts FFN
(:mod:`repro_torch.models.moe`), hymba's hybrid block, M-RoPE and vision
inputs, meta-device specs (:mod:`repro_torch.models.specs`) and the
configs of all ten architectures, served by the engine's lane-indexed SSM
rows. It adds no kernel: the scan, the dispatch and M-RoPE are plain torch,
as in the reference.
"""
