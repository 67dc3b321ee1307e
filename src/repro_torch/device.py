"""Where the port's tensors are created, and the card's numeric settings.

:func:`fake_card` stands a card in for the dry run
(:mod:`repro_torch.launch.dryrun`), which runs the port on fake tensors
(``torch._subclasses.fake_tensor.FakeTensorMode``) with no card. Inside it
:func:`resolve` maps ``cuda`` to the CPU device (the fake tensors stand
for the card's there: autograd needs a device guard for a tensor's device,
and a build of torch without CUDA has none for ``cuda``), :func:`sm_count`
gives the stand-in card's, and every place that picks the card's path
takes it for a fake tensor (:func:`on_card`): each kernel wrapper returns
fake outputs of the kernel's shapes and reports the launch to the card's
``record`` instead of launching. Outside it nothing changes, and a real
tensor never takes that branch.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
from typing import Callable, Optional

import torch


@dataclasses.dataclass(frozen=True)
class FakeCard:
    """The card the dry run counts for: its name, its SMs (the kernels'
    launch plans read them) and ``record(kernel, flops, bytes)``, called
    once for each kernel a wrapper would launch."""
    name: str
    sm_count: int
    record: Callable[[str, float, float], None]


_FAKE_CARD: contextvars.ContextVar = contextvars.ContextVar("repro_torch_fake_card",
                                                            default=None)


@contextlib.contextmanager
def fake_card(card: FakeCard):
    """Install ``card`` for the block (the dry run alone does)."""
    tok = _FAKE_CARD.set(card)
    try:
        yield card
    finally:
        _FAKE_CARD.reset(tok)


def is_fake(t: torch.Tensor) -> bool:
    """Whether ``t`` is a fake tensor under an installed :func:`fake_card`:
    the kernels' dry-run branch."""
    from torch._subclasses.fake_tensor import FakeTensor
    return _FAKE_CARD.get() is not None and isinstance(t, FakeTensor)


def on_card(t: torch.Tensor) -> bool:
    """Whether ``t`` takes the card's path: a CUDA tensor, or a fake one
    under :func:`fake_card`."""
    return t.is_cuda or is_fake(t)


def record_launch(name: str, flops: float, n_bytes: float) -> None:
    """Report one launch of kernel ``name`` to the installed card."""
    _FAKE_CARD.get().record(name, float(flops), float(n_bytes))


@functools.lru_cache(maxsize=None)
def _real_sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(index: Optional[int]) -> int:
    """The SMs of card ``index`` (the stand-in card's under :func:`fake_card`)."""
    card = _FAKE_CARD.get()
    return card.sm_count if card is not None else _real_sm_count(index)


def resolve(device) -> torch.device:
    """The device an entry point creates its tensors on.

    A CUDA device that is not there raises: the port never moves work to
    the CPU behind the caller's back (under :func:`fake_card` ``cuda`` is
    the CPU device of the fake tensors that stand for the card's). Asking for a CUDA device also
    turns TF32 off in matrix products and convolutions: TF32 keeps about
    three decimal digits, and the dense Eq. 5 scores (``heads.full_logits``,
    a ``torch.matmul``) must agree with the beam path's gathered dot
    products to 1e-5.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if _FAKE_CARD.get() is not None:
            return torch.device("cpu")
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but CUDA is not available; "
                "pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
