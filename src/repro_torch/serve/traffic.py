"""Synthetic traffic driver: Poisson arrivals against a live engine.

Models the ROADMAP's "heavy traffic from millions of users" shape at bench
scale: requests arrive as a Poisson process (exponential inter-arrival
gaps at ``rate`` req/s), prompts are random token strings — a fixed
length by default (one length bucket, one prefill jit entry), or mixed
lengths via ``prompt_len_choices``/``gen_tokens_choices`` (the skewed
shape the paged KV pool packs; each distinct length adds a prefill
bucket, so warm them via ``Engine.warm_prefill_buckets`` before timing) —
and a configurable fraction of requests reuse a small set of shared
prompts — the repeated-prefix workload the candidate cache exists for
(shared system prompts / common query heads in production).

The driver is open-loop: a request is submitted the moment its arrival
time passes on the wall clock, regardless of engine backlog, so a slow
serving path shows up as queueing delay in the latency tail rather than
as reduced offered load. ``drive`` pumps ``Engine.step`` until all
requests complete and reports request throughput plus p50/p99 end-to-end
latency (submit → last token).
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serve.engine import Engine, Request, ResultStream


@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    n_requests: int = 32
    rate: float = 50.0            # offered load, requests/second
    prompt_len: int = 8
    gen_tokens: int = 8           # max_new_tokens per request
    # Mixed-length traffic (the skewed shape the paged KV pool exists
    # for): when set, each non-shared request draws its prompt length /
    # token budget uniformly from these choices instead of the scalars
    # above. Shared prompts keep the scalar prompt_len so repeats stay
    # exact repeats.
    prompt_len_choices: Optional[Tuple[int, ...]] = None
    gen_tokens_choices: Optional[Tuple[int, ...]] = None
    vocab_size: int = 1024
    repeat_frac: float = 0.0      # fraction drawing from shared prompts
    n_shared_prompts: int = 1
    eos_id: Optional[int] = None
    seed: int = 0
    # -- adversarial generators: the traffic shapes prefix
    #    sharing / speculative decode / SLA scheduling target. --
    # shared-prefix burst (make_shared_prefix_burst): Zipf over a
    # template pool of long preambles, short unique suffixes, arrivals
    # in bursts — N requests paying one preamble's KV/prefill.
    n_templates: int = 8
    zipf_a: float = 1.5           # template popularity skew (>1)
    template_len: int = 24        # shared preamble tokens
    suffix_len: int = 4           # unique per-request tail tokens
    exact_repeat_frac: float = 0.25   # requests with NO suffix (exact
    #                                   prompt repeats: COW-tail +
    #                                   replay-draft hits)
    burst: int = 4                # arrivals per burst instant
    # heavy-tail mix (make_heavy_tail_mix): mostly-short interactive
    # requests sharing the pool with rare long batch jobs — the shape
    # FIFO handles worst and priority/preemption exist for.
    interactive_frac: float = 0.75
    interactive_priority: int = 1
    interactive_deadline_s: Optional[float] = None
    tail_alpha: float = 1.2       # Pareto shape for batch lengths


def make_workload(tcfg: TrafficConfig) -> List[Tuple[float, Request]]:
    """Returns [(arrival_offset_seconds, Request)] sorted by arrival."""
    rng = np.random.default_rng(tcfg.seed)
    gaps = rng.exponential(1.0 / tcfg.rate, size=tcfg.n_requests)
    arrivals = np.cumsum(gaps) - gaps[0]         # first request at t=0
    shared = rng.integers(0, tcfg.vocab_size,
                          (max(1, tcfg.n_shared_prompts), tcfg.prompt_len))

    def pick(choices, default):
        if choices is None:
            return default
        return int(choices[rng.integers(0, len(choices))])

    out = []
    for t in arrivals:
        gen = pick(tcfg.gen_tokens_choices, tcfg.gen_tokens)
        if rng.random() < tcfg.repeat_frac:
            prompt = shared[rng.integers(0, len(shared))]
        else:
            pl = pick(tcfg.prompt_len_choices, tcfg.prompt_len)
            prompt = rng.integers(0, tcfg.vocab_size, pl)
        out.append((float(t), Request(prompt=np.asarray(prompt, np.int32),
                                      max_new_tokens=gen,
                                      eos_id=tcfg.eos_id)))
    return out


def make_shared_prefix_burst(tcfg: TrafficConfig,
                             ) -> List[Tuple[float, Request]]:
    """Adversarial shape #1: Zipf-popular templates, bursty arrivals.

    A pool of ``n_templates`` preambles (``template_len`` tokens each) is
    sampled once; every request picks a template with Zipf(``zipf_a``)
    popularity and appends either nothing (``exact_repeat_frac`` — exact
    prompt repeats, the COW-tail + replay-draft case) or a short unique
    suffix. Arrivals come ``burst`` at a time at Poisson burst instants,
    so a whole burst of one popular template is in the queue at once —
    prefix sharing pays that preamble's KV and prefill exactly once,
    FIFO-without-sharing pays it per request. Interactive requests (short
    ``gen_tokens``) carry ``interactive_priority``.
    """
    rng = np.random.default_rng(tcfg.seed)
    n_bursts = -(-tcfg.n_requests // max(1, tcfg.burst))
    gaps = rng.exponential(max(1, tcfg.burst) / tcfg.rate, size=n_bursts)
    burst_at = np.cumsum(gaps) - gaps[0]
    templates = rng.integers(0, tcfg.vocab_size,
                             (max(1, tcfg.n_templates), tcfg.template_len))
    ranks = np.arange(1, len(templates) + 1, dtype=np.float64)
    zipf = ranks ** -tcfg.zipf_a
    zipf /= zipf.sum()
    out: List[Tuple[float, Request]] = []
    for b in range(n_bursts):
        for _ in range(max(1, tcfg.burst)):
            if len(out) >= tcfg.n_requests:
                break
            t_idx = rng.choice(len(templates), p=zipf)
            prompt = templates[t_idx]
            if rng.random() >= tcfg.exact_repeat_frac and tcfg.suffix_len:
                suffix = rng.integers(0, tcfg.vocab_size, tcfg.suffix_len)
                prompt = np.concatenate([prompt, suffix])
            interactive = rng.random() < tcfg.interactive_frac
            gen = (tcfg.gen_tokens if interactive
                   else pick_from(rng, tcfg.gen_tokens_choices,
                                  tcfg.gen_tokens))
            out.append((float(burst_at[b]), Request(
                prompt=np.asarray(prompt, np.int32), max_new_tokens=gen,
                eos_id=tcfg.eos_id,
                priority=(tcfg.interactive_priority if interactive else 0),
                deadline_s=(tcfg.interactive_deadline_s
                            if interactive else None))))
    return out


def make_heavy_tail_mix(tcfg: TrafficConfig,
                        ) -> List[Tuple[float, Request]]:
    """Adversarial shape #2: heavy-tailed prompt/gen lengths + SLA mix.

    ``interactive_frac`` of requests are short interactive probes
    (scalar ``prompt_len`` / ``gen_tokens``, ``interactive_priority``);
    the rest are batch jobs whose prompt and budget draw a discrete
    Pareto(``tail_alpha``) between the scalar and the longest configured
    choice — the occasional whale that clogs a FIFO pool for everyone.
    ``prompt_len_choices`` / ``gen_tokens_choices`` (required) bound the
    lengths so every request still fits the engine's ``max_len``.
    """
    assert tcfg.prompt_len_choices and tcfg.gen_tokens_choices, (
        "heavy-tail mix needs prompt_len_choices / gen_tokens_choices "
        "as the length buckets (and prefill-jit shapes) it draws from")
    rng = np.random.default_rng(tcfg.seed)
    gaps = rng.exponential(1.0 / tcfg.rate, size=tcfg.n_requests)
    arrivals = np.cumsum(gaps) - gaps[0]

    def tail_pick(choices) -> int:
        # Pareto-weighted choice over the sorted buckets: index grows
        # like a heavy tail, snapped to a configured (pre-warmed) bucket.
        cs = sorted(int(c) for c in choices)
        u = float(rng.pareto(tcfg.tail_alpha))
        idx = min(int(u), len(cs) - 1)
        return cs[idx]

    out: List[Tuple[float, Request]] = []
    for t in arrivals:
        interactive = rng.random() < tcfg.interactive_frac
        if interactive:
            pl, gen, pri = (tcfg.prompt_len, tcfg.gen_tokens,
                            tcfg.interactive_priority)
        else:
            pl, gen, pri = (tail_pick(tcfg.prompt_len_choices),
                            tail_pick(tcfg.gen_tokens_choices), 0)
        prompt = rng.integers(0, tcfg.vocab_size, pl)
        out.append((float(t), Request(
            prompt=np.asarray(prompt, np.int32), max_new_tokens=gen,
            eos_id=tcfg.eos_id, priority=pri,
            deadline_s=(tcfg.interactive_deadline_s
                        if interactive else None))))
    return out


def pick_from(rng, choices, default) -> int:
    if choices is None:
        return int(default)
    return int(choices[rng.integers(0, len(choices))])


def drive(engine: Engine, workload: Sequence[Tuple[float, Request]],
          time_scale: float = 1.0) -> dict:
    """Run the workload against the engine, open-loop.

    ``time_scale`` compresses the arrival schedule (0.5 = twice the offered
    rate) without regenerating the workload. Returns throughput and latency
    percentiles; handles stay on ``engine.completed`` for deeper digging.
    """
    handles: List[ResultStream] = []
    due: List[float] = []            # absolute scheduled arrival times
    t0 = time.perf_counter()
    i = 0
    while i < len(workload) or engine.num_pending or engine.num_active:
        now = time.perf_counter() - t0
        while i < len(workload) and workload[i][0] * time_scale <= now:
            handles.append(engine.submit(workload[i][1]))
            due.append(t0 + workload[i][0] * time_scale)
            i += 1
        if not engine.step() and i < len(workload):
            # Idle engine waiting on the next arrival: sleep to it.
            next_due = workload[i][0] * time_scale
            wait = next_due - (time.perf_counter() - t0)
            if wait > 0:
                time.sleep(min(wait, 0.01))
    elapsed = time.perf_counter() - t0

    # Latency is measured from the *scheduled* arrival, not the actual
    # submit call: arrivals falling due while the engine is inside a step
    # are submitted late, and that wait is queueing delay the tail must
    # show, not timing noise to exclude.
    lat = np.asarray([h.finished_at - d for h, d in zip(handles, due)])
    tokens = sum(len(h.tokens) for h in handles)
    out = {
        "n_requests": len(handles),
        "elapsed_s": elapsed,
        "throughput_rps": len(handles) / elapsed,
        "throughput_tok_s": tokens / elapsed,
        "latency_p50_ms": float(np.percentile(lat, 50) * 1e3),
        "latency_p99_ms": float(np.percentile(lat, 99) * 1e3),
        "latency_mean_ms": float(lat.mean() * 1e3),
    }
    # Per-SLA-class tails: the whole point of priority scheduling is the
    # interactive class's p99, so it is reported per class, always (a
    # single class shows up as one entry keyed by its priority).
    by_class: dict = {}
    for h, d in zip(handles, due):
        by_class.setdefault(h.priority, []).append(h.finished_at - d)
    out["per_class"] = {
        int(pri): {
            "n": len(ls),
            "latency_p50_ms": float(np.percentile(ls, 50) * 1e3),
            "latency_p99_ms": float(np.percentile(ls, 99) * 1e3),
            "latency_mean_ms": float(np.mean(ls) * 1e3),
        } for pri, ls in sorted(by_class.items())}
    # Raw per-request latencies in submission order: benchmarks comparing
    # an SLA run against a priority-stripped FIFO baseline need to regroup
    # the FIFO latencies by the *original* class of each request.
    out["per_request_latency_s"] = [float(x) for x in lat]
    return out
