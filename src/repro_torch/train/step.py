"""Training, evaluation and serving steps of the LM, as ``repro.train.step``.

The ``make_*`` functions close over static configs and return functions on
the port's state: ``train_step(state, batch, generator) -> (state, metrics)``,
``eval_step(state, batch) -> metrics``, and the serving pair
``make_prefill`` / ``make_serve_step``. The head strategy (the paper's
adversarial sampling, or a baseline) is a config knob; serving applies the
Eq. 5 bias removal over the full vocabulary or a beam's candidates.

Every forward of training and evaluation runs the reference's attention in
plain torch (``attn_impl="plain"``): the CUDA ``flash_attention`` kernel is
forward-only and serves the decode path alone.

Every ``make_*`` function takes a ``mesh`` (a ``("data", "model")`` ``DeviceMesh``,
:mod:`repro_torch.launch.mesh`): the model is then placed by ``param_spec``
(:mod:`repro_torch.parallel.sharding`): over ``model`` the embedding's and
the head's rows, and the trunk's heads, ``d_ff``, experts and SSM heads;
over ``data`` (FSDP) the dim each trunk matrix names, gathered a layer at
a time in the forward (``transformer.forward``); the optimizer state
mirrors the parameters (``train_state_spec``). Serving gathers the token
rows and scores through :mod:`repro_torch.parallel.collectives`; the dense
Eq. 5 path scores each rank's slice of the vocabulary and merges the
argmax. The training step takes the global batch and equals the one-rank
step on it: each rank runs its ``data`` slice through its part of the
trunk (the forward's partial sums and the backward's partial gradients
summed over ``model``), draws the global batch's uniforms and keeps its
rows, and normalises by the global mask count. The sparse head assembles
its candidates' rows from their owners; the dense head (``softmax``
vocab-parallel, or the sampled kinds on rows gathered under autograd) and
the dense embedding train their row-sharded tables through autograd. The
FSDP leaves' gradients arrive reduce-scattered over ``data``; every other
gradient (whole leaves, the dense head and embedding, the ``SparseRows``)
is summed over ``data`` before the update, and the gradient norm over the
axes that cut each leaf, so the clip and the non-finite guard decide alike
on every rank.

The sparse training step marks its phases as ``record_function`` ranges
(``train/forward``, ``train/head``, ``train/backward``,
``train/embed_rows``, ``train/optimizer``), so a ``torch.profiler``
capture attributes the device time to them. The backward pass (with the
recompute of each layer under ``cfg.remat``) runs on autograd's own
thread, so its kernels fall outside the ranges.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch import device as device_lib
from repro_torch import tree_util
from repro_torch.core.heads import HeadConfig, HeadParams, resolve_head_update
from repro_torch.models import layers, lm_head, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.optim import OptimizerConfig, apply_updates, global_norm, init_opt_state
from repro_torch.optim import sparse as sparse_opt
from repro_torch.parallel import sharding
from repro_torch.train.state import TrainState, snr_reset_pair


def _head(params) -> HeadParams:
    return HeadParams(**params["head"])


def _leaves_requiring_grad(tree):
    """The tree with every tensor replaced by a detached alias that requires
    grad: the autograd leaves of one step, sharing the parameters' storage."""
    return tree_util.tree_map(lambda t: t.detach().requires_grad_(), tree)


def loss_fn(params, cfg: ModelConfig, hcfg: HeadConfig, head_state,
            batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator],
            sampler=None):
    """Dense-path loss under autograd. Returns (loss, metrics). A vision
    batch's ``vision_embeds`` and ``positions`` go to the forward; the
    vision prefix carries no next-token loss."""
    h, _, fwd_metrics = transformer.forward(
        params, cfg, batch["tokens"], positions=batch.get("positions"),
        vision_embeds=batch.get("vision_embeds"), attn_impl="plain")
    h = h[:, _n_vis(cfg, h, batch):]
    loss, head_metrics = lm_head.lm_head_loss(
        cfg, hcfg, _head(params), head_state, h, batch["labels"], generator,
        mask=batch.get("mask"), sampler=sampler)
    return loss, {"loss": loss, **fwd_metrics, **head_metrics}


def _n_vis(cfg: ModelConfig, h: torch.Tensor, batch) -> int:
    """The vision prefix's length: the hiddens past the labels."""
    if cfg.modality == "vision" and batch["labels"].shape[1] != h.shape[1]:
        return h.shape[1] - batch["labels"].shape[1]
    return 0


def _detached(metrics: dict) -> dict:
    return {k: v.detach() for k, v in metrics.items()}


def make_grad_fn(cfg: ModelConfig, hcfg: HeadConfig, head_update: str = "auto",
                 sampler=None, embed_update: str = "auto", mesh=None):
    """``grad_fn(state, batch, generator) -> (grads, metrics)``: the loss and
    gradient half of :func:`make_train_step`, exposed for tests and for the
    card's gradient checks. ``grads`` mirrors ``state.params``; on the
    sparse path its ``head`` (and, with sparse embedding updates, its
    ``embed``) is a ``SparseRows``. Under ``mesh`` (module docstring) the
    grads are the global batch's: the ``SparseRows`` the same on every
    rank, every dense grad the rank's part of its leaf."""
    mode = resolve_head_update(head_update, hcfg.kind)
    if embed_update not in ("auto", "sparse", "dense"):
        raise ValueError(f"embed_update must be auto, sparse or dense, got {embed_update!r}")
    emode = embed_update if embed_update != "auto" else (
        "sparse" if mode == "sparse" else "dense")
    if emode == "sparse" and mode == "dense":
        raise ValueError("sparse embedding updates ride the sparse-head step; the "
                         "dense autograd path cannot deliver them")
    if mesh is not None:
        sharding.check_mesh(mesh)
        return _sharded_grad_fn(cfg, hcfg, sampler, mesh, mode, emode)

    def dense_grads(state: TrainState, batch, generator):
        params = _leaves_requiring_grad(state.params)
        leaves, spec = tree_util.flatten(params)
        with torch.enable_grad():
            loss, metrics = loss_fn(params, cfg, hcfg, state.head_state, batch,
                                    generator, sampler)
            grads = torch.autograd.grad(loss, leaves)
        return tree_util.unflatten(spec, list(grads)), _detached(metrics)

    def sparse_grads(state: TrainState, batch, generator):
        # The trunk runs under autograd; the head's loss, its SparseRows and
        # dh come from the analytic sparse path, and dh drives the trunk's
        # backward. With sparse embedding updates the token gather runs
        # outside the graph and its rows' gradients are collected as
        # SparseRows instead of a dense (V, d) table.
        params = state.params
        tokens = batch["tokens"]
        embed_sparse = emode == "sparse" and "embed" in params
        drop = {"head", "embed"} if embed_sparse else {"head"}
        trunk = _leaves_requiring_grad({k: v for k, v in params.items() if k not in drop})
        leaves, spec = tree_util.flatten(trunk)
        vision, positions = batch.get("vision_embeds"), batch.get("positions")
        with torch.enable_grad(), record_function("train/forward"):
            if embed_sparse:
                h0 = transformer.embed_inputs(params, cfg, tokens).requires_grad_()
                inputs = leaves + [h0]
                ie = h0 if vision is None else torch.cat(
                    [vision.to(h0.dtype), h0], dim=1)
                h, _, fwd_metrics = transformer.forward(
                    trunk, cfg, tokens, positions=positions, inputs_embeds=ie,
                    attn_impl="plain")
            else:
                inputs = leaves
                h, _, fwd_metrics = transformer.forward(
                    trunk, cfg, tokens, positions=positions, vision_embeds=vision,
                    attn_impl="plain")
        n_vis = _n_vis(cfg, h, batch)
        with record_function("train/head"):
            loss, head_metrics, head_rows, dh = lm_head.lm_sparse_head_loss(
                cfg, hcfg, _head(params), state.head_state, h[:, n_vis:],
                batch["labels"], generator, mask=batch.get("mask"), sampler=sampler)
        if n_vis:       # the vision prefix carries no next-token loss
            dh = torch.nn.functional.pad(dh, (0, 0, n_vis, 0))
        with record_function("train/backward"):
            outs = torch.autograd.grad(h, inputs, dh.to(h.dtype))
        grads = {**tree_util.unflatten(spec, list(outs[:len(leaves)])), "head": head_rows}
        if embed_sparse:
            dh0 = outs[-1]
            with record_function("train/embed_rows"):
                grads["embed"] = sparse_opt.accumulate_embed_rows(
                    tokens.reshape(-1), dh0.reshape(-1, dh0.shape[-1]),
                    params["embed"].shape[0])
        return grads, _detached({"loss": loss, **fwd_metrics, **head_metrics})

    return dense_grads if mode == "dense" else sparse_grads


def _sharded_grad_fn(cfg: ModelConfig, hcfg: HeadConfig, sampler, mesh, mode: str,
                     emode: str):
    """The step's gradients under a mesh (module docstring): the trunk's
    leaves are the rank's parts, and so are their gradients, and so are a
    dense head's and a dense embedding's (the rank's rows)."""
    from repro_torch.parallel import collectives
    dense_head, dense_embed = mode == "dense", emode == "dense"
    reduced = None        # the trunk leaves whose gradient is reduce-scattered over data

    def grad_fn(state: TrainState, batch, generator):
        nonlocal reduced
        params = state.params
        local = sharding.shard_batch(batch, mesh)
        tokens = local["tokens"]
        trunk = _leaves_requiring_grad(
            {k: v for k, v in params.items() if k not in ("head", "embed")})
        leaves, spec = tree_util.flatten(trunk)
        if reduced is None:
            reduced = ["data" in sharding.split_axes(sp, mesh)
                       for _, sp in sharding.train_state_spec(cfg, mesh, trunk)]
        tables = _leaves_requiring_grad(
            {**({"embed": params["embed"]} if dense_embed else {}),
             **({"head": params["head"]} if dense_head else {})})
        t_leaves, t_spec = tree_util.flatten(tables)
        vision = local.get("vision_embeds")
        with torch.enable_grad(), record_function("train/forward"):
            h0 = transformer.embed_inputs(tables if dense_embed else params, cfg, tokens,
                                          mesh=mesh)
            if not dense_embed:
                h0.requires_grad_()
            ie = h0 if vision is None else torch.cat([vision.to(h0.dtype), h0], dim=1)
            h, _, fwd_metrics = transformer.forward(
                trunk, cfg, tokens, positions=local.get("positions"), inputs_embeds=ie,
                attn_impl="plain", mesh=mesh)
        n_vis = _n_vis(cfg, h, local)
        shape = tuple(batch["labels"].shape)
        with record_function("train/head"):
            if dense_head:
                with torch.enable_grad():
                    loss, head_metrics = lm_head.lm_sharded_dense_loss(
                        cfg, hcfg, HeadParams(**tables["head"]), state.head_state,
                        h[:, n_vis:], local["labels"], generator, mesh, shape,
                        mask=local.get("mask"), sampler=sampler)
            else:
                loss, head_metrics, head_rows, dh = lm_head.lm_sharded_head_loss(
                    cfg, hcfg, _head(params), state.head_state, h[:, n_vis:],
                    local["labels"], generator, mesh, shape, mask=local.get("mask"),
                    sampler=sampler)
                if n_vis:
                    dh = torch.nn.functional.pad(dh, (0, 0, n_vis, 0))
        inputs = leaves + t_leaves + ([] if dense_embed else [h0])
        with record_function("train/backward"):
            if dense_head:
                outs = torch.autograd.grad(loss, inputs)
            else:
                outs = torch.autograd.grad(h, inputs, dh.to(h.dtype))
        trunk_grads = list(outs[:len(leaves)])
        table_grads = list(outs[len(leaves):len(leaves) + len(t_leaves)])
        grads = {}
        if not dense_embed:
            dh0 = outs[-1]
            with record_function("train/embed_rows"):
                grads["embed"] = sparse_opt.accumulate_embed_rows(
                    tokens.reshape(-1), dh0.reshape(-1, dh0.shape[-1]), 0)
        with record_function("train/data_sum"):
            # FSDP leaves come back reduce-scattered over data; a sum here
            # would count them dp times.
            collectives.all_reduce_over_data(
                mesh, [g for g, r in zip(trunk_grads, reduced) if not r])
            for g in table_grads:           # each (V/tp, d) table in place
                collectives.all_reduce_over_data(mesh, [g])
            # The sparse rows come back as this rank's model slice of them.
            if not dense_head:
                grads["head"] = collectives.sum_rows_over_data(
                    mesh, head_rows, params["head"]["w"].shape[0])
            if not dense_embed:
                grads["embed"] = collectives.sum_rows_over_data(
                    mesh, grads["embed"], params["embed"].shape[0])
            # Each data rank's loss and head metrics are its share of the
            # global means; the forward's metrics are per-rank means.
            summed = {"loss": loss, **head_metrics}
            scalars = torch.stack([v.detach().float() for v in summed.values()]
                                  + [v.detach().float() for v in fwd_metrics.values()])
            collectives.all_reduce_over_data(mesh, [scalars])
            n_sum = len(summed)
            metrics = dict(zip(summed, scalars[:n_sum]))
            metrics.update(zip(fwd_metrics, scalars[n_sum:] / sharding.size(mesh, "data")))
        grads = {**tree_util.unflatten(spec, trunk_grads),
                 **tree_util.unflatten(t_spec, table_grads), **grads}
        return grads, metrics

    return grad_fn


def make_train_step(cfg: ModelConfig, hcfg: HeadConfig, opt_cfg: OptimizerConfig,
                    head_update: str = "auto", sampler=None, snr_alpha: float = 0.1,
                    embed_update: str = "auto", skip_nonfinite: bool = False,
                    mesh=None):
    """Returns ``train_step(state, batch, generator) -> (state, metrics)``.

    ``head_update`` picks the head-gradient path: ``dense`` is autograd end
    to end (a dense (C, K) head gradient, every row updated); ``sparse``
    backpropagates the trunk from the analytic ``dh`` of
    ``lm_sparse_head_loss`` (the ``sampled_head_loss`` kernel on the card)
    and updates only the touched head rows; ``auto`` is sparse for the
    sampled heads and dense for ``softmax``. ``embed_update`` extends the
    sparse treatment to the input embedding (``auto``: with the head).
    ``sampler`` overrides the negative-sampling proposal; negatives are
    drawn from ``generator``. ``snr_alpha`` weighs the EWMA of the online
    SNR proxy kept in ``TrainState.snr_ewma``.

    The parameters and optimizer state are updated in place, as the
    reference donates them. ``skip_nonfinite`` therefore checks the loss
    and the gradient norm (one host read) before any write: a non-finite
    step leaves params, optimizer state and ``snr_ewma`` bit for bit as
    they were, advances ``step`` by 1 (the data and sampling streams are
    step-indexed) and reports ``metrics["nonfinite"] = 1``.

    ``mesh``: the state is a rank's (:func:`init_train_state` with the
    mesh, or :func:`repro_torch.parallel.shard_train_state`), the batch the
    global one (module docstring).
    """
    from repro_torch.parallel import collectives
    grad_fn = make_grad_fn(cfg, hcfg, head_update, sampler=sampler,
                           embed_update=embed_update, mesh=mesh)
    split_dims = None           # the mesh's cut leaves, read once from the first state
    sparse_axes = collectives.data_sum_axes(mesh)     # the axes that cut the SparseRows

    def train_step(state: TrainState, batch, generator):
        nonlocal split_dims
        if split_dims is None:
            split_dims = ({} if mesh is None
                          else sharding.split_dims(cfg, mesh, state.params))
        grads, metrics = grad_fn(state, batch, generator)
        with record_function("train/optimizer"):
            return _update(state, grads, metrics)

    def _update(state: TrainState, grads, metrics):
        norm = (global_norm(grads, mesh, split_dims, sparse_axes=sparse_axes)
                if opt_cfg.clip_norm else None)
        snr_ewma = state.snr_ewma
        if "snr_proxy" in metrics:
            # Fold the per-batch signal-mass proxy into the EWMA the SNR
            # refresh trigger watches; snr_ref is armed by the loop.
            p = metrics["snr_proxy"].float()
            snr_ewma = torch.where(state.snr_ewma < 0, p,
                                   (1.0 - snr_alpha) * state.snr_ewma + snr_alpha * p)
            metrics["snr_ewma"] = snr_ewma
        if skip_nonfinite:
            ok = torch.isfinite(metrics["loss"])
            if norm is not None:
                ok = ok & torch.isfinite(norm)
            metrics["nonfinite"] = (~ok).float()
            if not bool(ok):
                if norm is not None:
                    metrics["grad_norm"] = norm
                return state._replace(step=state.step + 1), metrics
        params, opt_state, opt_metrics = apply_updates(
            opt_cfg, state.params, grads, state.opt_state, mesh=mesh, norm=norm,
            split_dims=split_dims)
        metrics.update(opt_metrics)
        return state._replace(step=state.step + 1, params=params, opt_state=opt_state,
                              snr_ewma=snr_ewma), metrics

    return train_step


# Step metric name -> repro_torch.obs gauge (the `snr/*` and `train/*`
# namespaces). The SNR triple drives the refresh trigger (snr_proxy = the
# per-batch signal mass, snr_ewma = its smoothed TrainState series, snr_ref =
# the armed post-install reference).
STEP_METRIC_GAUGES = {
    "loss": "train/loss",
    "grad_norm": "train/grad_norm",
    "snr_proxy": "snr/proxy",
    "snr_ewma": "snr/ewma",
}


def publish_step_metrics(registry, host_metrics: Dict[str, float],
                         snr_ref: Optional[float] = None,
                         head_state_bytes: Optional[int] = None) -> None:
    """Host-side bridge from a step's metrics (read once per step as
    floats) to the obs registry. ``snr_ref`` lives on TrainState and is
    passed separately; ``head_state_bytes`` (``optim.head_state_bytes``,
    computed once per loop) lands on the ``train/head_state_bytes`` gauge."""
    registry.counter("train/steps").inc()
    for src, name in STEP_METRIC_GAUGES.items():
        if src in host_metrics:
            registry.gauge(name).set(host_metrics[src])
    if snr_ref is not None:
        registry.gauge("snr/ref").set(snr_ref)
    if head_state_bytes is not None:
        registry.gauge("train/head_state_bytes").set(head_state_bytes)


def make_eval_step(cfg: ModelConfig, hcfg: HeadConfig, mesh=None):
    """Debiased predictive log-likelihood and accuracy (the paper's Fig. 1
    axes): Eq. 5 over the whole vocabulary, whose tree term is the
    ``tree_logprob_all`` kernel on the card. Under ``mesh`` each rank
    runs its ``data`` slice of the global batch through its part of the
    trunk (under the attention hint where the caller installed it) and
    scores it over its slice of the vocabulary; the softmax's normaliser,
    the label's score and the argmax are reduced over ``model``, the sums
    over ``data``."""
    if mesh is not None:
        return _sharded_eval_step(cfg, hcfg, mesh)

    def eval_step(state: TrainState, batch):
        with torch.no_grad():
            h, _, _ = transformer.forward(
                state.params, cfg, batch["tokens"], positions=batch.get("positions"),
                vision_embeds=batch.get("vision_embeds"), attn_impl="plain")
            h = h[:, _n_vis(cfg, h, batch):]
            scores = lm_head.lm_predictive_scores(
                cfg, hcfg, _head(state.params), state.head_state,
                h.reshape(-1, h.shape[-1])).reshape(h.shape[:-1] + (-1,))
            labels = batch["labels"].long()
            mask = batch.get("mask")
            if mask is None:
                mask = torch.ones(labels.shape, dtype=torch.float32, device=h.device)
            logp = scores - torch.logsumexp(scores, dim=-1, keepdim=True)
            pos = torch.gather(logp, -1, labels[..., None])[..., 0]
            acc = (scores.argmax(dim=-1) == labels).float()
            denom = mask.sum().clamp(min=1.0)
            return {"eval_loglik": (pos * mask).sum() / denom,
                    "eval_acc": (acc * mask).sum() / denom}

    return eval_step


def _sharded_eval_step(cfg: ModelConfig, hcfg: HeadConfig, mesh):
    from repro_torch.parallel import collectives
    lo, _ = sharding.row_range(cfg.padded_vocab, mesh)

    def eval_step(state: TrainState, batch):
        local = sharding.shard_batch(batch, mesh)
        with torch.no_grad():
            h, _, _ = transformer.forward(
                state.params, cfg, local["tokens"], positions=local.get("positions"),
                vision_embeds=local.get("vision_embeds"), attn_impl="plain", mesh=mesh)
            h = h[:, _n_vis(cfg, h, local):]
            scores = lm_head.lm_predictive_scores(
                cfg, hcfg, _head(state.params), state.head_state,
                h.reshape(-1, h.shape[-1]), lo=lo)
            labels = local["labels"].long().reshape(-1)
            mask = local.get("mask")
            mask = (torch.ones(labels.shape, dtype=torch.float32, device=h.device)
                    if mask is None else mask.reshape(-1).float())
            logp, _ = lm_head.sharded_label_logprob(mesh, scores, labels, lo)
            acc = (lm_head.sharded_argmax(mesh, scores, lo) == labels).float()
            sums = torch.stack([(logp * mask).sum(), (acc * mask).sum(), mask.sum()])
            collectives.all_reduce_over_data(mesh, [sums])
            denom = sums[2].clamp(min=1.0)
            return {"eval_loglik": sums[0] / denom, "eval_acc": sums[1] / denom}

    return eval_step


def dense_next_token(cfg: ModelConfig, hcfg: HeadConfig, params, head_state,
                     h: torch.Tensor, mesh=None) -> torch.Tensor:
    """The dense Eq. 5 argmax of final hiddens h (B, d): one rank's scores
    over the vocabulary, or under ``mesh`` each rank's slice and the merged
    argmax (equal to the one-rank argmax)."""
    if mesh is None:
        scores = lm_head.lm_predictive_scores(cfg, hcfg, _head(params), head_state, h)
        return scores.argmax(dim=-1)
    lo, _ = sharding.row_range(cfg.padded_vocab, mesh)
    scores = lm_head.lm_predictive_scores(cfg, hcfg, _head(params), head_state, h, lo=lo)
    return lm_head.sharded_argmax(mesh, scores, lo)


def make_serve_step(cfg: ModelConfig, hcfg: HeadConfig, topk_beam: int = 0, mesh=None):
    """Greedy decode step: one token in, one token out, cache updated in
    place.

    With ``topk_beam == 0`` (default) the predictive scores are dense: the
    paper's bias removal (Eq. 5) as an O(C·k) tree pass (the
    ``tree_logprob_all`` kernel on the card) riding on top of the O(C·K)
    logits matmul. With ``topk_beam > 0`` the decode never touches O(C):
    beam search over the generator tree proposes ``topk_beam`` candidates in
    O(beam·k·log C) and only those are scored (the ``gather_scores`` kernel
    on the card) and debiased. Both paths pick the same argmax whenever the
    true top-1 label survives the beam.

    Under ``mesh`` the beam's candidates are scored by
    ``sharded_candidate_scores`` (the head is always row-sharded there) and
    the dense path by :func:`dense_next_token`'s merged argmax.
    """
    score_fn = lm_head.serving_score_fn(cfg, mesh=mesh)

    def serve_step(params, head_state, token, cache, cache_pos, positions=None):
        h, new_cache, _ = transformer.forward(
            params, cfg, token, positions=positions, cache=cache,
            cache_pos=cache_pos, mesh=mesh)
        if topk_beam:
            _, labels = lm_head.lm_predictive_topk(
                cfg, hcfg, _head(params), head_state, h[:, -1], topk=1,
                beam=topk_beam, score_fn=score_fn)
            next_token = labels[..., 0]
        else:
            next_token = dense_next_token(cfg, hcfg, params, head_state, h[:, -1], mesh)
        return next_token[:, None], new_cache

    return serve_step


def make_prefill(cfg: ModelConfig, mesh=None):
    def prefill(params, tokens, cache, vision_embeds=None, positions=None):
        h, new_cache, _ = transformer.forward(
            params, cfg, tokens, positions=positions,
            vision_embeds=vision_embeds, cache=cache, cache_pos=0, mesh=mesh)
        return h, new_cache

    return prefill


def _on(device, a, dtype=torch.int64) -> torch.Tensor:
    return torch.as_tensor(a).to(device=device, dtype=dtype)


def make_batched_prefill(cfg: ModelConfig, page_len: int, sink_page: int,
                         cache_dtype=torch.bfloat16, mesh=None):
    """Prefill a batch of newly admitted requests into their pages (the
    serving engine): every request admitted in an engine iteration runs
    through ONE padded forward.

    Returns ``batched_prefill(params, tokens, lengths, lanes, arena,
    page_tables)`` -> ``(h, arena)``:

    - ``tokens`` (N, S): right-padded prompts. Causal attention never looks
      forward, so each row's K/V and hiddens are those of an unpadded
      prefill.
    - ``lengths`` (N,): true prompt lengths; positions at or past a row's
      length go to ``sink_page`` instead of a mapped page.
    - ``lanes`` (N,): each row's decode lane, for the lane-indexed SSM conv
      and state leaves. Padding rows carry an out-of-range lane and are
      dropped: the reference's scatter drops them, torch indexing would
      not, so they are filtered on the host.
    - ``page_tables`` (N, max_pages): each row's logical -> physical page
      map; logical position p lands at ``(page_tables[n, p // page_len],
      p % page_len)``, a logical page past the table at its last entry, as
      the reference's gather clamps.

    ``lengths``, ``lanes`` and ``page_tables`` are read on the host (numpy
    arrays, or tensors that are copied there). The forward runs against a
    fresh contiguous (N, S) cache — the lock-step prefill's math, on the
    tensor-core kernel on the card — and one ``index_copy_`` per leaf then
    writes the K/V into the arena's pages and the SSM rows into their lanes,
    in place (the reference donates the arena; the port updates it), at the
    rows ``layers.cache_index`` gives the paged steps.
    """

    def batched_prefill(params, tokens, lengths, lanes, arena, page_tables):
        dev = next(iter(arena.values())).device
        tokens = _on(dev, tokens)
        n, s = tokens.shape
        fresh = transformer.init_cache(cfg, n, s, dtype=cache_dtype, device=dev, mesh=mesh)
        h, new_cache, _ = transformer.forward(params, cfg, tokens, cache=fresh, cache_pos=0,
                                              mesh=mesh)
        if "k" in arena:
            index = layers.cache_index(
                0, n, s, dev, page_table=page_tables, page_len=page_len, sink=sink_page,
                write_mask=np.arange(s)[None] < layers.to_host(lengths)[:, None])
            for key in ("k", "v"):     # (L, P, page_len, KV, hd) <- (L, N, S, KV, hd)
                leaf = arena[key]
                leaf.view(leaf.shape[0], -1, *leaf.shape[3:]).index_copy_(
                    1, index.write_rows,
                    new_cache[key].reshape(leaf.shape[0], n * s, *leaf.shape[3:]).to(leaf.dtype))
        if "conv" in arena:
            lane = layers.to_host(lanes).astype(np.int64)
            rows = np.nonzero(lane < arena["conv"].shape[1])[0]
            dst, src = _on(dev, lane[rows]), _on(dev, rows)
            for key in ("conv", "state"):  # (L, n_lanes, ...) <- (L, N, ...)
                arena[key].index_copy_(1, dst, new_cache[key].index_select(1, src))
        return h, arena

    return batched_prefill


def make_paged_prefill(cfg: ModelConfig, mesh=None):
    """Multi-token forward against the paged arena: per-lane start positions
    and page tables, S tokens a row.

    Returns ``paged_prefill(params, tokens, start, lengths, arena,
    page_tables)`` -> ``(h (B, S, d), arena)``. The serving engine's
    shared-prefix suffix prefill and its speculative verify step share it:
    row r's tokens sit at ``start[r] ..``, attention reads the row's earlier
    K/V (shared prefix pages, or its own decode writes) through the page
    table, and positions at or past ``lengths[r]`` write to the sink page
    (their hiddens are garbage the caller drops). Attention-family models
    only, as the reference: an SSM branch carries recurrent state that is
    neither paged nor position-local.
    """
    assert cfg.block == "attn", (
        "paged multi-token steps (prefix sharing / speculative verify) "
        "need position-local state; SSM/hybrid caches are recurrent")

    def paged_prefill(params, tokens, start, lengths, arena, page_tables):
        tokens = _on(next(iter(arena.values())).device, tokens)
        s = tokens.shape[1]
        wmask = np.arange(s)[None] < layers.to_host(lengths)[:, None]
        h, new_arena, _ = transformer.forward(
            params, cfg, tokens, cache=arena, cache_pos=start,
            page_table=page_tables, write_mask=wmask, mesh=mesh)
        return h, new_arena

    return paged_prefill


def make_paged_decode(cfg: ModelConfig, mesh=None):
    """Masked decode step over a paged pool: per-lane ``cache_pos`` and page
    tables.

    Returns ``paged_decode(params, token, arena, cache_pos, page_table)`` ->
    ``(h_last (B, d), arena)``. ``token`` is (B, 1), one in-flight token a
    lane; ``cache_pos`` (B,) puts each lane at its own depth; ``page_table``
    (B, max_pages) maps each lane's logical pages onto the arena. Free lanes
    ride along: their page-table rows point at the sink page, so their
    writes land there and the caller drops their hiddens. An SSM branch
    steps every lane's row of the lane-indexed conv and state leaves (a free
    lane's garbage too, which its next prefill overwrites). Head scoring is
    the engine's, so that its candidate cache can skip the tree descent.
    """

    def paged_decode(params, token, arena, cache_pos, page_table):
        h, new_arena, _ = transformer.forward(
            params, cfg, _on(next(iter(arena.values())).device, token), cache=arena,
            cache_pos=cache_pos, page_table=page_table, mesh=mesh)
        return h[:, -1], new_arena

    return paged_decode


def init_train_state(generator: torch.Generator, cfg: ModelConfig,
                     opt_cfg: OptimizerConfig, head_kind: str,
                     device="cuda", mesh=None) -> TrainState:
    """Fresh state: parameters and the default head state drawn from
    ``generator`` (on its device), put on ``device``, with zero optimizer
    state. With ``mesh`` the state is this rank's part of the one-rank
    state, bit for bit (``shard_train_state`` of it): each tensor is drawn
    from the same generator state on every rank and cut before the next
    layer is drawn (``transformer.init_params(mesh=)``), and the optimizer
    state is built on the parts, so no rank holds the whole trunk (each
    layer cut over ``model`` and, with FSDP, over ``data``)."""
    dev = device_lib.resolve(device)
    params = transformer.init_params(generator, cfg, device=dev, mesh=mesh)
    col_lens = {}
    if mesh is not None:        # SM3's column cover of a column-cut leaf is whole
        leaves = dict(tree_util.flatten_with_paths(params)[0])
        col_lens = {path: leaves[path].shape[1] * sharding.size(mesh, axes[1])
                    for path, axes in sharding.split_dims(cfg, mesh, params).items()
                    if len(axes) > 1 and axes[1]}
    ewma0, ref0 = snr_reset_pair(dev)
    return TrainState(
        step=0, params=params, opt_state=init_opt_state(opt_cfg, params, col_lens),
        head_state=lm_head.default_head_state(generator, cfg, head_kind, device=dev),
        gen_fit_step=-1, snr_ewma=ewma0, snr_ref=ref0)
