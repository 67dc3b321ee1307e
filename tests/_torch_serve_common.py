"""Shared set-up of the port's serving-engine tests (``tests/test_torch_serve_*.py``):
the small attention config of ``tests/test_serve_engine.py``, the port's
weights drawn from a torch generator on the CPU, the lock-step oracle and
one engine per geometry."""
import numpy as np
import pytest
import torch

from repro_torch.models import lm_head, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.serve import Engine, ServeConfig, lockstep_decode

CFG = ModelConfig(
    name="engine-test", num_layers=1, d_model=32, d_ff=64, vocab_size=100,
    num_heads=2, num_kv_heads=2, vocab_pad_multiple=128, gen_feature_dim=8,
    dtype="float32", remat=False)
HCFG = lm_head.head_config(CFG, "adversarial_ns")
_GEN = torch.Generator().manual_seed(0)
PARAMS = transformer.init_params(_GEN, CFG, device="cpu")
HEAD_STATE = lm_head.default_head_state(torch.Generator().manual_seed(1), CFG,
                                        "adversarial_ns", device="cpu")
MAX_LEN = 12
BEAM = 8
N_SLOTS = 2

_ENGINES = {}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the engines' ops are tiny, and the suite runs
    several test workers side by side."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def shared_engine(page_len: int = 0, batched: bool = True, n_pages: int = 0,
                  **kw) -> Engine:
    """One engine per configuration; between runs all lanes and pages are
    free and the queues empty, so what carries over is the candidate
    cache, which never changes outputs."""
    key = (page_len, batched, n_pages, tuple(sorted(kw.items())))
    if key not in _ENGINES:
        base = dict(n_slots=N_SLOTS, max_len=MAX_LEN, beam=BEAM, page_len=page_len,
                    n_pages=n_pages, batched_prefill=batched, cache_dtype=torch.float32)
        base.update(kw)
        _ENGINES[key] = Engine(CFG, HCFG, PARAMS, HEAD_STATE, ServeConfig(**base))
    return _ENGINES[key]


def mt_engine(**kw) -> Engine:
    base = dict(n_slots=N_SLOTS, max_len=MAX_LEN, beam=BEAM, page_len=3,
                n_pages=8, cache_dtype=torch.float32)
    base.update(kw)
    return Engine(CFG, HCFG, PARAMS, HEAD_STATE, ServeConfig(**base))


def prompts(rng, n, lo=2, hi=4):
    return [rng.integers(0, CFG.vocab_size, rng.integers(lo, hi + 1)).astype(np.int32)
            for _ in range(n)]


def lockstep(prompts_, gen_tokens, beam, head_state=HEAD_STATE):
    """The port's fixed-batch oracle."""
    return lockstep_decode(CFG, HCFG, PARAMS, head_state, prompts_, gen_tokens,
                           topk_beam=beam)
