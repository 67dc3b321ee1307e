"""Dry run: count one rank's step of every (arch × shape × mesh) cell on the
production mesh, with no card, the port of ``repro.launch.dryrun``.

The reference lowers and compiles each cell for 256 or 512 placeholder TPU
devices and reads XLA's cost and memory analyses. The port has no
compiler to ask, so it runs one rank's program itself on fake tensors:

- a fake world of 256 (or 512) ranks (``torch.distributed``'s ``fake``
  backend, this process rank 0) and the production mesh on it
  (:func:`repro_torch.launch.mesh.make_production_mesh`);
- the state built by the launchers' own calls (``init_train_state(mesh=)``,
  ``init_params(cast=True, mesh=)``, ``init_cache(mesh=)``) under
  ``FakeTensorMode``: a rank's part at full width and depth, nothing
  allocated. The fake tensors stand for the card's but lie on the CPU
  device: autograd takes a device guard for every tensor's device, which a
  build of torch without CUDA does not have, so under
  :func:`repro_torch.device.fake_card` ``device.resolve("cuda")`` gives the
  CPU, and every place where the port picks the card's path (each kernel
  wrapper, ``collectives.partial_matmul``) takes it for a fake tensor;
- the step under a counting ``TorchDispatchMode`` (:class:`Counter`):
  FLOPs by ``torch.utils.flop_counter``'s formulas, bytes accessed (each
  op's input and output bytes; a view adds none), every ``c10d``
  collective's bytes by kind (the reference's operand convention,
  :mod:`repro_torch.analysis.roofline`) and by mesh axis, and the peak of
  the storage the step allocates;
- the kernels through their wrappers: under
  :func:`repro_torch.device.fake_card` (the production card, 132 SMs) a
  wrapper handed fake tensors returns outputs of the kernel's
  shapes and reports the launch with its kernel module's FLOP and byte
  formula, the one ``chip_smoke.py``'s bounds read; nothing falls back to
  the plain version, so a prefill counts ``flash_attention`` calls, not a
  (B, H, S, S) logits tensor.

What the data decides is taken at a stated bound and written to the
artifact's ``assumptions``: the sparse rows' dedupe counts every drawn id
distinct (the most rows a step touches, ``optim.sparse.unique_rows``), a
ragged gather over ``data`` counts every rank's rows equal to this rank's,
no step is skipped as non-finite. A batch that does not divide over
``data`` is whole on every data rank, as the reference's
``batch_shardings`` leaves it.

``bytes_per_device`` is the rank's arguments (its part of the state, the
cache and its batch, ``argument_size_in_bytes``) plus the peak of the
storage the step allocates (``temp_size_in_bytes``), the counterpart of
XLA's ``memory_analysis()``. The port's layers are a Python loop, so every
trip is counted and nothing is extrapolated. The roofline terms use the
H100's constants (:mod:`repro_torch.launch.mesh`), the links by axis.

Usage (no card needed; artifacts under ``build/dryrun_torch/``):
  python -m repro_torch.launch.dryrun --arch h2o-danube-3-4b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --skip-existing
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
import weakref
from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch import configs as cfg_lib
from repro_torch import device as device_lib
from repro_torch import tree_util
from repro_torch.analysis import roofline as rl
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import lm_head, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.optim import OptimizerConfig
from repro_torch.parallel import sharding
from repro_torch.parallel.hints import sharding_hints

OUT_DEFAULT = "build/dryrun_torch"
CARD = "NVIDIA H100 80GB HBM3"
CARD_SM_COUNT = 132
ASSUMPTIONS = {
    "sparse_rows": "every drawn id distinct: the most rows a step touches",
    "ragged_gathers": "every data rank's sparse rows as many as this rank's",
    "nonfinite": "no step skipped (skip_nonfinite off)",
    "positions": "explicit (M-RoPE) positions taken as the kernel's default, "
                 "cache_pos + arange(S) in the first stream",
}

# c10d op -> (the reference's kind, the argument whose bytes count): an
# all-gather counts the part sent, a reduce-scatter its whole input, an
# all-reduce (and a broadcast) the tensor.
_C10D = {"allreduce_": ("all-reduce", 0), "allreduce_coalesced_": ("all-reduce", 0),
         "allgather_": ("all-gather", 1), "_allgather_base_": ("all-gather", 1),
         "allgather_into_tensor_coalesced_": ("all-gather", 1),
         "reduce_scatter_": ("reduce-scatter", 1),
         "_reduce_scatter_base_": ("reduce-scatter", 1),
         "alltoall_": ("all-to-all", 1), "alltoall_base_": ("all-to-all", 1),
         "broadcast_": ("broadcast", 0)}


def _tensor_bytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in tree_util.leaves(x)
               if isinstance(t, torch.Tensor))


def _read_bytes(x) -> int:
    """The bytes an op reads of its tensor arguments: a broadcast (stride 0)
    dim is read once."""
    n = 0
    for t in tree_util.leaves(x):
        if isinstance(t, torch.Tensor):
            n += t.element_size() * math.prod(d for d, st in zip(t.shape, t.stride()) if st)
    return n


# Operators that move no data: queries, allocations (written by the op
# that fills them) and views the schema does not mark as views.
_NO_DATA = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
            "_unsafe_view", "alias", "lift_fresh", "detach", "_local_scalar_dense",
            "sym_size", "sym_stride", "sym_numel", "is_same_size"}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)


def _flops(packet, args, kwargs, out) -> int:
    """``torch.utils.flop_counter``'s count of one op. An overload with a
    trailing non-tensor argument (``bmm``'s and ``mm``'s ``out_dtype``)
    is counted on its tensors, which its formula reads."""
    try:
        return flop_registry[packet](*args, **kwargs, out_val=out)
    except TypeError:
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        return flop_registry[packet](*tensors, out_val=out)


class Counter(TorchDispatchMode):
    """Counts what one rank's step does (module docstring). ``groups`` maps
    a process group's name to its mesh axis; a collective on any other
    group is counted under ``world``."""

    def __init__(self, groups: Dict[str, str], with_cost: bool = True):
        super().__init__()
        self.groups, self.with_cost = groups, with_cost
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives: Dict[str, int] = {k: 0 for k in rl.COLLECTIVES}
        self.by_axis: Dict[str, int] = {}
        self.calls: Dict[str, int] = {}
        self.kernels: Dict[str, int] = {}
        self.live = self.peak = 0
        self._tracked = set()

    def record_kernel(self, name: str, flops: float, n_bytes: float) -> None:
        """:class:`repro_torch.device.FakeCard`'s ``record``."""
        self.kernels[name] = self.kernels.get(name, 0) + 1
        self.flops += flops
        self.bytes += n_bytes

    def adopt(self, tree) -> None:
        """Mark the storage of every tensor in ``tree`` (the step's
        arguments) as held before the step: an op that writes or views it
        (an in-place update, a ``detach``) allocates nothing."""
        for t in tree_util.leaves(tree):
            if isinstance(t, torch.Tensor):
                self._tracked.add(id(t.untyped_storage()))

    def _free(self, key: int, n: int) -> None:
        self._tracked.discard(key)
        self.live -= n

    def _track(self, out) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            key = id(st)
            if key in self._tracked:
                continue
            n = st.nbytes()
            self._tracked.add(key)
            self.live += n
            weakref.finalize(st, self._free, key, n)
        self.peak = max(self.peak, self.live)

    def _collective(self, func, args) -> None:
        name = func.__name__.split(".")[0]
        kind, arg = _C10D.get(name, (name, 0))
        pg = next(a for a in args if type(a).__name__ == "ScriptObject")
        group = torch._C._distributed_c10d.ProcessGroup.unbox(pg).group_name
        axis = self.groups.get(group, "world")
        n = _tensor_bytes(args[arg])
        self.collectives[kind] = self.collectives.get(kind, 0) + n
        self.by_axis[axis] = self.by_axis.get(axis, 0) + n
        self.calls[kind] = self.calls.get(kind, 0) + 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "c10d":
            self._collective(func, args)
            return out
        if self.with_cost and func.namespace == "aten":
            packet = func._overloadpacket
            if packet in flop_registry:
                self.flops += _flops(packet, args, kwargs, out)
            if not func.is_view and packet.__name__ not in _NO_DATA:
                self.bytes += (_read_bytes(args) + _read_bytes(list(kwargs.values()))
                               + _tensor_bytes(out))
        self._track(out)
        return out

    def report(self) -> rl.CostReport:
        return rl.CostReport(flops=self.flops, bytes_accessed=self.bytes,
                             collectives=dict(self.collectives),
                             collectives_by_axis=dict(self.by_axis))


# ---------------------------------------------------------------------------
# The fake world
# ---------------------------------------------------------------------------

def fake_world(world_size: int) -> None:
    """(Re)join a fake process group of ``world_size`` ranks as rank 0."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world_size and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def production_mesh(kind: str):
    """The production mesh on a fake world: ``single`` (32, 8), ``multi``
    (64, 8)."""
    shape = mesh_lib.production_mesh_shape(multi_pod=kind == "multi")
    fake_world(shape[0] * shape[1])
    return mesh_lib.make_production_mesh(multi_pod=kind == "multi")


def mesh_of(shape):
    """A ("data", "model") mesh of ``shape`` on a fake world of its size
    (tests and reduced cells)."""
    from torch.distributed.device_mesh import init_device_mesh
    fake_world(shape[0] * shape[1])
    return init_device_mesh("cuda", tuple(shape), mesh_dim_names=sharding.MESH_DIMS)


def _groups(mesh) -> Dict[str, str]:
    if mesh is None:
        return {}
    return {mesh.get_group(ax).group_name: ax for ax in sharding.MESH_DIMS}


# ---------------------------------------------------------------------------
# Cells: each returns (arguments, step) on fake tensors; step() runs it.
# ---------------------------------------------------------------------------

def _zeros(shape, dtype):
    return torch.zeros(shape, dtype=dtype, device=device_lib.resolve("cuda"))


def _rows(batch: int, mesh) -> int:
    """A rank's batch rows: its slice over ``data`` where the batch
    divides, else the whole batch (``sharding.batch_slice``)."""
    if mesh is None:
        return batch
    sl = sharding.batch_slice(batch, mesh)
    return sl.stop - sl.start


def _vision(cfg: ModelConfig, rows: int, seq_len: int, positions_len: int) -> Dict[str, Any]:
    """The vision frontend stub's inputs (precomputed embeddings, M-RoPE
    positions), as the reference's specs give them."""
    if cfg.modality != "vision":
        return {}
    return {"vision_embeds": _zeros((rows, cfg.num_vision_tokens, cfg.d_model),
                                    torch.bfloat16),
            "positions": _zeros((3, rows, positions_len), torch.int64)}


def build_train_cell(cfg: ModelConfig, mesh, seq_len: int, batch: int, head_kind: str):
    """Adagrad, lr 0.01, clip 1.0; the head with 1 negative, reg 1e-3 (the
    reference's train cell); the global batch, each rank taking its rows."""
    from repro_torch.train import step as step_lib
    hcfg = lm_head.head_config(cfg, head_kind, n_neg=1, reg=1e-3)
    opt = OptimizerConfig(name="adagrad", learning_rate=0.01, clip_norm=1.0)
    state = step_lib.init_train_state(torch.Generator().manual_seed(0), cfg, opt, head_kind,
                                      device="cuda", mesh=mesh)
    n_text = seq_len - (cfg.num_vision_tokens if cfg.modality == "vision" else 0)
    data = {"tokens": _zeros((batch, n_text), torch.int64),
            "labels": _zeros((batch, n_text), torch.int64),
            "mask": torch.ones((batch, n_text), dtype=torch.float32,
                               device=device_lib.resolve("cuda")),
            **_vision(cfg, batch, seq_len, seq_len)}
    train_step = step_lib.make_train_step(cfg, hcfg, opt, mesh=mesh)
    gen = torch.Generator().manual_seed(1)
    local = data if mesh is None else sharding.shard_batch(data, mesh)
    return (state, local), lambda: train_step(state, data, gen)


def build_decode_cell(cfg: ModelConfig, mesh, seq_len: int, batch: int, head_kind: str):
    """One greedy decode step (``make_serve_step``, dense Eq. 5) against a
    cache of ``seq_len`` positions, the new token at the last; a rank
    serves its rows of the batch."""
    from repro_torch.train import step as step_lib
    hcfg = lm_head.head_config(cfg, head_kind)
    rows = _rows(batch, mesh)
    gen = torch.Generator().manual_seed(0)
    params = transformer.init_params(gen, cfg, device="cuda", cast=True, mesh=mesh)
    head_state = lm_head.default_head_state(gen, cfg, head_kind, device="cuda")
    cache = transformer.init_cache(cfg, rows, seq_len, device="cuda", mesh=mesh)
    token = _zeros((rows, 1), torch.int64)
    positions = _zeros((3, rows, 1), torch.int64) if cfg.mrope_sections else None
    serve_step = step_lib.make_serve_step(cfg, hcfg, mesh=mesh)
    return ((params, head_state, cache, token),
            lambda: serve_step(params, head_state, token, cache, seq_len - 1, positions))


def build_prefill_cell(cfg: ModelConfig, mesh, seq_len: int, batch: int, head_kind: str):
    """The forward with a cache over the prompt, the predictive scores of
    the last position and their argmax (the reference's prefill cell); a
    rank prefills its rows of the batch."""
    from repro_torch.train import step as step_lib
    hcfg = lm_head.head_config(cfg, head_kind)
    rows = _rows(batch, mesh)
    gen = torch.Generator().manual_seed(0)
    params = transformer.init_params(gen, cfg, device="cuda", cast=True, mesh=mesh)
    head_state = lm_head.default_head_state(gen, cfg, head_kind, device="cuda")
    cache = transformer.init_cache(cfg, rows, seq_len, device="cuda", mesh=mesh)
    n_text = seq_len - (cfg.num_vision_tokens if cfg.modality == "vision" else 0)
    tokens = _zeros((rows, n_text), torch.int64)
    extra = _vision(cfg, rows, seq_len, seq_len)

    def step():
        h, new_cache, _ = transformer.forward(
            params, cfg, tokens, positions=extra.get("positions"),
            vision_embeds=extra.get("vision_embeds"), cache=cache, cache_pos=0, mesh=mesh)
        token = step_lib.dense_next_token(cfg, hcfg, params, head_state, h[:, -1], mesh)
        return token[:, None], new_cache

    return (params, head_state, cache, tokens, extra), step


BUILDERS: Dict[str, Callable] = {"train": build_train_cell, "decode": build_decode_cell,
                                 "prefill": build_prefill_cell}


# ---------------------------------------------------------------------------
# Cell runner
# ---------------------------------------------------------------------------

def count_cell(cfg: ModelConfig, mesh, mode: str, seq_len: int, batch: int, head_kind: str,
               seq_shard_attn: bool = False, seq_parallel_residual: bool = False,
               fsdp_gather: bool = False, with_cost: bool = True) -> Dict[str, Any]:
    """Build one cell on fake tensors and count its step (module docstring)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    counter = Counter(_groups(mesh), with_cost=with_cost)
    card = device_lib.FakeCard(CARD, CARD_SM_COUNT, counter.record_kernel)
    any_hint = seq_shard_attn or seq_parallel_residual or fsdp_gather
    hints = (sharding_hints(mesh, seq_parallel_residual=seq_parallel_residual,
                            fsdp_gather_weights=fsdp_gather)
             if any_hint and mesh is not None else contextlib.nullcontext())
    with FakeTensorMode(), device_lib.fake_card(card):
        args, step = BUILDERS[mode](cfg, mesh, seq_len, batch, head_kind)
        arg_bytes = _tensor_bytes(args)
        counter.adopt(args)
        with hints, counter:
            out = step()
        out_bytes = _tensor_bytes(out[0]) if mode != "train" else 0
    return dict(counter=counter, argument_size_in_bytes=arg_bytes,
                output_size_in_bytes=out_bytes, temp_size_in_bytes=counter.peak)


def model_flops(cfg: ModelConfig, mode: str, seq_len: int, batch: int) -> float:
    """6 (training) or 2 · active parameters · tokens, as the reference."""
    tokens = batch * seq_len if mode in ("train", "prefill") else batch
    return (6.0 if mode == "train" else 2.0) * cfg.active_param_count() * tokens


def run_cell(arch: str, shape: str, mesh_kind: str, head_kind: str, with_cost: bool = True,
             cfg_override: Optional[ModelConfig] = None, seq_shard_attn: bool = False,
             seq_parallel_residual: bool = False, fsdp_gather: bool = False,
             mesh=None, cell: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """One cell's artifact. ``mesh`` overrides the production mesh (tests
    and reduced cells), and ``cfg_override`` the arch's config;
    ``mesh_kind`` ``one`` counts one rank with no mesh (the launchers'
    one-card step). ``cell`` ({"mode", "seq_len", "global_batch"})
    replaces the shape's."""
    cfg = cfg_override or cfg_lib.get_config(arch)
    cell = cell or cfg_lib.shape_cells(arch)[shape]
    if cell is None:
        return {"arch": arch, "shape": shape, "mesh": mesh_kind, "status": "skipped",
                "reason": "long-context requires sub-quadratic attention"}
    if mesh is None and mesh_kind != "one":
        mesh = production_mesh(mesh_kind)
    mode, seq_len, batch = cell["mode"], cell["seq_len"], cell["global_batch"]
    chips = 1 if mesh is None else mesh.size()
    result: Dict[str, Any] = {
        "arch": arch, "shape": shape, "mesh": mesh_kind, "mode": mode,
        "seq_len": seq_len, "global_batch": batch, "head": head_kind,
        "chips": chips, "mesh_shape": [1, 1] if mesh is None else list(sharding.mesh_shape(mesh)),
        "status": "ok",
        "seq_shard_attn": seq_shard_attn, "seq_parallel_residual": seq_parallel_residual,
        "fsdp_gather": fsdp_gather, "card": CARD,
    }
    assumptions = dict(ASSUMPTIONS)
    if mesh is not None and batch % sharding.size(mesh, "data"):
        assumptions["whole_batch"] = (f"batch {batch} does not divide over data "
                                      f"{sharding.size(mesh, 'data')}: whole on every "
                                      "data rank")
    result["assumptions"] = assumptions
    t0 = time.time()
    counted = count_cell(cfg, mesh, mode, seq_len, batch, head_kind,
                         seq_shard_attn=seq_shard_attn,
                         seq_parallel_residual=seq_parallel_residual,
                         fsdp_gather=fsdp_gather, with_cost=with_cost)
    result["compile_s"] = round(time.time() - t0, 1)
    counter = counted.pop("counter")
    result.update(counted)
    result["bytes_per_device"] = (counted["argument_size_in_bytes"]
                                  + counted["temp_size_in_bytes"])
    result["kernels"] = dict(counter.kernels)
    result["collective_calls"] = dict(counter.calls)
    if with_cost:
        total = counter.report()
        mf = model_flops(cfg, mode, seq_len, batch)
        roof = rl.roofline_terms(total, chips, mf)
        result.update({
            "flops_per_device": total.flops,
            "bytes_accessed_per_device": total.bytes_accessed,
            "collective_bytes_per_device": total.collective_total,
            "collectives": total.collectives,
            "collectives_by_axis": total.collectives_by_axis,
            "compute_s": roof.compute_s,
            "memory_s": roof.memory_s,
            "collective_s": roof.collective_s,
            "bottleneck": roof.bottleneck,
            "step_time_s": roof.step_time_s,
            "model_flops": mf,
            "useful_flops_fraction": roof.useful_flops_fraction,
            "mfu_bound": roof.mfu_bound,
        })
    return result


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--head", default="adversarial_ns")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-cost", action="store_true",
                    help="count the memory alone (no FLOPs, bytes or collectives)")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--seq-shard-attn", action="store_true",
                    help="hint: sequence-shard attention for archs with head counts "
                         "that do not divide over the model axis")
    ap.add_argument("--seq-parallel-residual", action="store_true",
                    help="hint: sequence-parallel residual stream")
    ap.add_argument("--fsdp-gather", action="store_true",
                    help="hint: gather the experts' weights over data in bf16")
    ap.add_argument("--softmax-dtype", default=None,
                    help="override attention softmax dtype (e.g. bfloat16)")
    ap.add_argument("--ssm-chunk", type=int, default=None,
                    help="override the SSD chunk length")
    ap.add_argument("--tag", default="", help="artifact filename suffix")
    ap.add_argument("--out", default=OUT_DEFAULT)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    archs = [args.arch] if args.arch else list(cfg_lib.ARCHS)
    shapes = [args.shape] if args.shape else list(cfg_lib.SHAPES)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    os.makedirs(args.out, exist_ok=True)
    over = {k: v for k, v in (("softmax_dtype", args.softmax_dtype),
                              ("ssm_chunk", args.ssm_chunk)) if v}
    n_fail = 0
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                tag = f"{arch}_{shape}_{mesh_kind}_{args.head}{args.tag}"
                path = os.path.join(args.out, tag + ".json")
                if args.skip_existing and os.path.exists(path):
                    print(f"[skip] {tag}")
                    continue
                try:
                    cfg_over = (dataclasses.replace(cfg_lib.get_config(arch), **over)
                                if over else None)
                    res = run_cell(arch, shape, mesh_kind, args.head,
                                   with_cost=not args.no_cost, cfg_override=cfg_over,
                                   seq_shard_attn=args.seq_shard_attn,
                                   seq_parallel_residual=args.seq_parallel_residual,
                                   fsdp_gather=args.fsdp_gather)
                except Exception as e:          # noqa: BLE001
                    res = {"arch": arch, "shape": shape, "mesh": mesh_kind,
                           "head": args.head, "status": "error",
                           "error": f"{type(e).__name__}: {e}",
                           "trace": traceback.format_exc()[-2000:]}
                    n_fail += 1
                with open(path, "w") as f:
                    json.dump(res, f, indent=1)
                extra = ""
                if res["status"] == "ok" and "bottleneck" in res:
                    extra = (f" bottleneck={res['bottleneck']}"
                             f" mfu_bound={res['mfu_bound']:.3f}"
                             f" GB/device={res['bytes_per_device'] / 1e9:.2f}")
                print(f"[{res['status']}] {tag}{extra}", flush=True)
    print(f"done; {n_fail} failures")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
