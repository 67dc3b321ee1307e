"""Training and serving of the LM: the state, the steps, the generator
refit and the fault-tolerant loop (:mod:`repro_torch.train.loop`)."""
from repro_torch.train.loop import LoopConfig, Preemption, StragglerMonitor, run_loop
from repro_torch.train.state import TrainState
from repro_torch.train.step import (init_train_state, make_batched_prefill, make_eval_step,
                                    make_paged_decode, make_paged_prefill, make_prefill,
                                    make_serve_step, make_train_step)

__all__ = ["LoopConfig", "Preemption", "StragglerMonitor", "run_loop", "TrainState",
           "init_train_state", "make_batched_prefill", "make_eval_step",
           "make_paged_decode", "make_paged_prefill", "make_prefill", "make_serve_step",
           "make_train_step"]
