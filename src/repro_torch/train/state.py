"""TrainState: trainable params + optimizer state + non-trainable head state
(the paper's generator is deliberately not optimized — §2.2 "we can keep
[the generator] constant while training the discriminator"), as
``repro.train.state``."""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.models.lm_head import LMHeadState


def snr_reset_pair(device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fresh (snr_ewma, snr_ref) = (-1.0, -1.0): two distinct float32
    scalars on ``device`` (the training step updates ``snr_ewma``, the loop
    arms ``snr_ref`` from it)."""
    return (torch.full((), -1.0, dtype=torch.float32, device=device),
            torch.full((), -1.0, dtype=torch.float32, device=device))


class TrainState(NamedTuple):
    step: int
    params: Any
    opt_state: Any
    head_state: LMHeadState
    # Step at which the current generator was (re)fitted; -1 before the
    # first fit. Checkpointed so a resumed run knows which refresh window
    # it is in (repro_torch.genfit.refresh) and replays swaps bit-exactly.
    gen_fit_step: int
    # Online gradient-SNR proxy (heads._sampled_metrics "snr_proxy"): EWMA
    # of the per-batch signal-mass estimate, and the post-refresh reference
    # level it is compared against. Both float32 scalars, -1.0 before a
    # value exists and reset to -1.0 whenever a new generator is installed;
    # checkpointed so the SNR-driven refresh trigger replays on resume.
    snr_ewma: torch.Tensor
    snr_ref: torch.Tensor

    def as_pytree(self):
        return self._asdict()
