"""The port's kernel entry points, under the names of the JAX package's
``repro.kernels.ops``.

Each takes CPU tensors through its plain PyTorch version and CUDA tensors
through its hand-written CUDA kernel; there is no switch between the two.
Each keeps a plain integer count of kernel launches in its ``launches``
attribute.
"""
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.gather_scores import gather_scores
from repro_torch.kernels.sampled_loss import sampled_head_loss
from repro_torch.kernels.segment_scores import segment_plan, segment_stats
from repro_torch.kernels.tree_logprob import tree_logprob_all

__all__ = ["flash_attention", "gather_scores", "sampled_head_loss", "segment_plan",
           "segment_stats", "tree_logprob_all"]
