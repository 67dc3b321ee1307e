"""Where the port's tensors are created, and the card's numeric settings."""
from __future__ import annotations

import torch


def resolve(device) -> torch.device:
    """The device an entry point creates its tensors on.

    A CUDA device that is not there raises: the port never moves work to
    the CPU behind the caller's back. Asking for a CUDA device also turns
    TF32 off in matrix products and convolutions: TF32 keeps about three
    decimal digits, and the dense Eq. 5 scores (``heads.full_logits``, a
    ``torch.matmul``) must agree with the beam path's gathered dot products
    to 1e-5.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but CUDA is not available; "
                "pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
