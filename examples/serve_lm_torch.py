"""Batched serving with the adversarial head's bias removal (Eq. 5), on the
PyTorch port: the counterpart of ``examples/serve_lm.py``.

Part 1 — lock-step decode, three head paths on the same prompts:

- dense path: xi + log p_n over the full vocab (O(C·K) logits matmul plus
  the O(C·k) tree pass, the ``tree_logprob_all`` kernel on the card);
- beam path: tree-guided beam search proposes a handful of candidates in
  O(beam·k·log C), only those are scored (the ``gather_scores`` kernel on
  the card) and debiased — decode never touches O(C);
- exhaustive beam (= padded vocab): must reproduce dense token-for-token.

Part 2 — the same prompts through the continuous-batching engine
(``repro_torch.serve``): a paged KV pool sized to HALF the one-buffer-per-
lane bytes (pages of 8 positions), fewer decode lanes than requests (so
admission queues), batched multi-request prefill, per-request EOS +
max-new-tokens retirement with page reclamation, and the prefix-keyed
candidate cache skipping the tree descent on resubmitted prompts. Then the
multi-tenant features: prefix sharing, speculative decode, preemption and
on-demand page growth. Engine outputs are asserted equal to the lock-step
decode — paging changes physical KV addressing, never the math.

Run:  PYTHONPATH=src python examples/serve_lm_torch.py [--device cuda|cpu]
"""
import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch import device as device_lib  # noqa: E402
from repro_torch.models import lm_head, transformer  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.serve import Engine, Request, ServeConfig, lockstep_decode  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = device_lib.resolve(args.device)
    torch.manual_seed(0)
    cfg = ModelConfig(
        name="serve-demo", num_layers=2, d_model=128, d_ff=384,
        vocab_size=1024, num_heads=4, num_kv_heads=2,
        vocab_pad_multiple=128, gen_feature_dim=16, dtype="float32",
        remat=False)
    batch, prompt_len, gen_tokens, max_len = 8, 24, 16, 48

    gen = torch.Generator(device=dev).manual_seed(0)
    params = transformer.init_params(gen, cfg, device=dev)
    head_state = lm_head.default_head_state(gen, cfg, "adversarial_ns", device=dev)
    hcfg = lm_head.head_config(cfg, "adversarial_ns")
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=gen, device=dev).cpu().numpy()

    # beam=32: the fast sublinear path; beam=1024 (= padded vocab): an
    # exhaustive beam, which must reproduce the dense decode token-for-token.
    decoded = {}
    for name, beam in (("dense", 0), ("beam=32", 32), ("beam=full", 1024)):
        t0 = time.perf_counter()
        out = lockstep_decode(cfg, hcfg, params, head_state, prompts, gen_tokens,
                              topk_beam=beam)
        dt = time.perf_counter() - t0
        print(f"[{name}] lock-step: {gen_tokens} tokens x {batch} seqs in "
              f"{dt * 1e3:.0f} ms; sample: {out[0].tolist()}")
        assert out.shape == (batch, gen_tokens)
        assert 0 <= out.min() and out.max() < cfg.vocab_size
        decoded[name] = out
    assert (decoded["dense"] == decoded["beam=full"]).all(), \
        "exhaustive beam must match the dense decode exactly"
    agree = float((decoded["dense"] == decoded["beam=32"]).mean())
    # The demo generator is a random init, so its beam proposes near-uniform
    # candidates; agreement climbs towards 100% once the tree is fitted.
    print(f"dense/beam=32 token agreement: {agree:.0%} (unfitted generator)")

    # --- Part 2: continuous-batching engine over a paged KV pool --------
    # Half as many lanes as requests AND half the one-buffer-per-lane KV
    # bytes: pages of 8 positions, 12 pages = (4 lanes x 48) / 2 positions.
    # Each request maps ceil(40 / 8) = 5 pages, so two run at once.
    page_len = 8
    n_pages = (batch // 2) * max_len // 2 // page_len
    engine = Engine(cfg, hcfg, params, head_state, ServeConfig(
        n_slots=batch // 2, max_len=max_len, beam=32, page_len=page_len,
        n_pages=n_pages, cache_dtype=torch.float32))
    t0 = time.perf_counter()
    handles = [engine.submit(Request(prompt=p, max_new_tokens=gen_tokens))
               for p in prompts]
    engine.run()
    dt = time.perf_counter() - t0
    out = np.stack([h.result() for h in handles])
    assert (out == decoded["beam=32"]).all(), \
        "engine must reproduce the lock-step beam decode"
    st = engine.stats()
    assert st["peak_pages_in_use"] <= n_pages and st["pages_in_use"] == 0
    engine.pool.check_invariants()
    print(f"[engine] {batch} requests over {batch // 2} lanes / {n_pages} pages "
          f"x {page_len} in {dt * 1e3:.0f} ms; outputs == lock-step beam=32; "
          f"peak pages {st['peak_pages_in_use']}/{n_pages}, "
          f"{st['prefill_calls']} batched prefill launches")

    # Resubmit the same prompts: every step's candidate set is a prefix hit,
    # so the tree descent is skipped (descent_skips > 0).
    before = engine.candidate_cache.stats()
    skips_before = engine.descent_skips
    for p in prompts:
        engine.submit(Request(prompt=p, max_new_tokens=gen_tokens))
    engine.run()
    after = engine.candidate_cache.stats()
    hits = after["hits"] - before["hits"]
    lookups = hits + after["misses"] - before["misses"]
    skips = engine.descent_skips - skips_before
    assert hits > 0 and skips > 0
    print(f"[engine] resubmitted prompts: candidate-cache hit rate "
          f"{hits / lookups:.0%}, {skips} decode steps skipped the tree descent")

    # EOS + per-request max-length: stop at a token the greedy decode emits.
    eos = int(out[0, 3])
    first = out[0].tolist().index(eos)   # the token may repeat earlier
    h_eos = engine.submit(Request(prompt=prompts[0], max_new_tokens=gen_tokens,
                                  eos_id=eos))
    h_short = engine.submit(Request(prompt=prompts[1], max_new_tokens=3))
    engine.run()
    assert h_eos.eos_hit and len(h_eos.tokens) == first + 1, h_eos.tokens
    assert len(h_short.tokens) == 3
    print(f"[engine] eos_id={eos}: stopped after {len(h_eos.tokens)} tokens "
          f"(max was {gen_tokens}); max_new_tokens=3 request emitted "
          f"{len(h_short.tokens)}")

    # Multi-tenant: a shared 16-token preamble, speculative decode,
    # preemption and on-demand growth on an undersized pool, dense head.
    shared = np.concatenate([np.repeat(prompts[:1, :16], batch, 0),
                             prompts[:, 16:]], axis=1)
    want = lockstep_decode(cfg, hcfg, params, head_state, shared, gen_tokens)
    mt = Engine(cfg, hcfg, params, head_state, ServeConfig(
        n_slots=batch // 2, max_len=max_len, page_len=page_len, n_pages=14,
        cache_dtype=torch.float32, prefix_sharing=True, spec_decode=True,
        max_draft=4, preemption=True, page_growth="ondemand"))
    # Two rounds: the second replays the first's continuations as drafts.
    for _ in range(2):
        handles = [mt.submit(Request(prompt=p, max_new_tokens=gen_tokens,
                                     priority=i % 2))
                   for i, p in enumerate(shared)]
        mt.run()
        got = np.stack([h.result() for h in handles])
        assert (got == want).all(), "multi-tenant engine must reproduce the lock-step decode"
        mt.pool.check_invariants()
    st = mt.stats()
    assert st["prefix"]["hits"] > 0 and st["spec"]["drafts_accepted"] > 0
    assert st["pages_in_use"] == 0
    print(f"[engine] shared preamble + spec + preemption + on-demand pages: "
          f"outputs == lock-step; share hits {st['prefix']['hits']}, "
          f"drafts accepted {st['spec']['drafts_accepted']}/"
          f"{st['spec']['drafts_proposed']}, preemptions "
          f"{st['sched']['preemptions']}, page grows {st['sched']['page_grows']}")
    print("OK")


if __name__ == "__main__":
    main()
