"""The process mesh of a ``torchrun`` launch, as ``repro.launch.mesh``'s
``make_host_mesh``: a ``DeviceMesh`` of shape (world / model_axis,
model_axis) with dims ("data", "model"), one process per rank.

  python -m torch.distributed.run --standalone --nproc-per-node N \
      -m repro_torch.launch.{train,serve} --model-axis M --device cpu|cuda|cuda:0

Ranks come from the ``torchrun`` environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``). ``--device cuda`` puts rank r of a host on ``cuda:r``
(``LOCAL_RANK``) and raises if that card is absent; an explicit
``cuda:N`` puts every rank on that card. The backend is NCCL where every
rank has a card of its own, gloo on the CPU and where ranks share a card
(NCCL refuses two ranks on one device); nothing retries another backend.
Every group of the mesh gets a finite timeout, so a rank left waiting on a
collective fails instead of hanging.

What a rank holds is the launcher's: both launchers shard the whole model
over ``model`` (the trunk's heads, ``d_ff``, experts and SSM heads, the
embedding's and the head's rows) and each trunk matrix over ``data``
(FSDP), serving its cache by KV heads, training its optimizer state with
the parameters.

The production mesh (:func:`production_mesh_shape`,
:func:`make_production_mesh`) is the H100 cluster's: 256 GPUs as
(data 32, model 8), or 512 as (64, 8). The ``model`` axis is the 8 GPUs of
one HGX H100 node, joined all to all by NVLink; the ``data`` axis crosses
nodes over InfiniBand. The reference's TPU meshes are (16, 16) and (2, 16,
16), whose "pod" axis is the TPU's cross-pod network; the port's two mesh
dims keep that traffic in ``data``. The dry run
(:mod:`repro_torch.launch.dryrun`) builds it on a fake world, and the
roofline (:mod:`repro_torch.analysis.roofline`) reads the card's and the
links' constants below.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch import device as device_lib

TIMEOUT_S = 300.0

# One NVIDIA H100 SXM as nvidia-smi reports it ("NVIDIA H100 80GB HBM3,
# 700.00 W"), by NVIDIA's data sheet:
PEAK_FLOPS_BF16 = 989e12       # FLOP/s, bf16 tensor cores, dense
HBM_BW = 3.35e12               # bytes/s of HBM3
NVLINK_BW = 450e9              # bytes/s each way a GPU (NVLink 4: 900 GB/s both ways)
IB_BW = 50e9                   # bytes/s a GPU: one 400 Gb/s NDR InfiniBand link
LINK_BW = {"model": NVLINK_BW, "data": IB_BW}    # by mesh axis
MODEL_AXIS = 8                 # the GPUs of one HGX H100 node
LAUNCH_HINT = ("start it under torchrun: python -m torch.distributed.run --standalone "
               "--nproc-per-node N -m {module} --model-axis M ...")


def in_launch() -> bool:
    """Whether this process was started by ``torchrun``."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def rank_device(device) -> torch.device:
    """This rank's device: ``cuda`` means ``cuda:LOCAL_RANK``; an explicit
    index is kept; ``cpu`` is the CPU. A missing card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    dev = device_lib.resolve(dev)
    if dev.type == "cuda" and dev.index >= torch.cuda.device_count():
        raise RuntimeError(f"rank device {dev} requested but only "
                           f"{torch.cuda.device_count()} CUDA devices are visible")
    return dev


def backend_for(device: torch.device, explicit_index: bool) -> str:
    """NCCL when every rank has its own card, else gloo."""
    shared = explicit_index and int(os.environ.get("LOCAL_WORLD_SIZE", "1")) > 1
    return "nccl" if device.type == "cuda" and not shared else "gloo"


def make_host_mesh(model_axis: int = 1, device="cuda", timeout_s: float = TIMEOUT_S,
                   init_method: Optional[str] = None):
    """Join the process group (ranks from the ``torchrun`` environment;
    rendezvous there too, or at ``init_method``, e.g. a ``file://`` store)
    and return the ("data", "model") ``DeviceMesh``. ``device`` is this
    rank's device (:func:`rank_device`'s result, or a device string with
    ``cuda``, the default, meaning the local rank's card; pass ``cpu`` for
    a world of CPU processes). A missing card raises."""
    from torch.distributed.device_mesh import init_device_mesh
    explicit = torch.device(device).index is not None
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    timeout = datetime.timedelta(seconds=timeout_s)
    if not dist.is_initialized():
        dist.init_process_group(backend_for(dev, explicit), init_method=init_method,
                                timeout=timeout, rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]))
    world = dist.get_world_size()
    if model_axis < 1 or world % model_axis:
        raise ValueError(f"--model-axis {model_axis} does not divide the world of {world}")
    mesh = init_device_mesh(dev.type, (world // model_axis, model_axis),
                            mesh_dim_names=("data", "model"))
    for name in ("data", "model"):
        dist.distributed_c10d._set_pg_timeout(timeout, mesh.get_group(name))
    return mesh


def production_mesh_shape(multi_pod: bool = False) -> tuple:
    """(data, model) of the production mesh: (32, 8) for 256 GPUs, (64, 8)
    for 512 (module docstring)."""
    return (64 if multi_pod else 32), MODEL_AXIS


def make_production_mesh(*, multi_pod: bool = False):
    """The production ``DeviceMesh`` over the initialized world, which must
    hold exactly its 256 (or 512) ranks; the device type is the world's
    (``cuda``; the dry run's fake world takes it without a card)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = production_mesh_shape(multi_pod)
    n = shape[0] * shape[1]
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world != n:
        raise ValueError(f"the production mesh {shape} needs a world of {n} ranks, "
                         f"got {world}")
    return init_device_mesh("cuda", shape, mesh_dim_names=("data", "model"))


def launcher_mesh(model_axis: int, device, module: str):
    """The launchers' mesh: under ``torchrun`` a mesh of the world, without
    it None (one process, no group) for ``model_axis == 1``; a larger
    ``model_axis`` without ``torchrun`` raises."""
    if in_launch():
        return make_host_mesh(model_axis, device)
    if model_axis > 1:
        raise ValueError(f"--model-axis {model_axis} needs one process per rank: "
                         + LAUNCH_HINT.format(module=module))
    return None


def describe(mesh) -> str:
    """The launchers' ``mesh:`` line."""
    return (f"mesh: {{'data': {mesh.shape[0]}, 'model': {mesh.shape[1]}}} over "
            f"{dist.get_world_size()} ranks, backend {dist.get_backend()}")


def is_lead(mesh) -> bool:
    """Rank 0 prints; one process without a mesh is its own lead."""
    return mesh is None or dist.get_rank() == 0
