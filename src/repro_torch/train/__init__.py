"""Training and serving steps of the LM: the serving half (prefill and the
greedy decode step) in :mod:`repro_torch.train.step`."""
from repro_torch.train.step import make_prefill, make_serve_step

__all__ = ["make_prefill", "make_serve_step"]
