"""Roofline terms of one rank's step, the port of ``repro.analysis.roofline``.

  compute    = FLOPs        / peak FLOP/s
  memory     = bytes        / HBM bytes/s
  collective = coll. bytes  / link bytes/s

all per device. The reference reads FLOPs and bytes from XLA's
``cost_analysis()`` and the collectives' bytes from the compiled HLO
(``collective_bytes``). The port has no HLO: :func:`collective_bytes`
counts the same quantity from the collectives a rank issues, as the dry
run's dispatch mode records them (:mod:`repro_torch.launch.dryrun`), under
the reference's kind names and its operand-byte convention: an all-gather
counts the part the rank sends, a reduce-scatter its whole input, an
all-reduce the tensor.

One addition: ``link_bw`` may be a dict by mesh axis (``{"model":
NVLINK_BW, "data": IB_BW}``), and :class:`CostReport` then carries the
bytes by axis (``collectives_by_axis``); the collective term is the sum
over axes of each axis's bytes over its link. With one number the
reference's formula holds exactly. The port's layers are a Python loop,
so the dry run counts every trip and needs no L=1/L=2 extrapolation;
:func:`extrapolate_layers` is kept with the reference's formula.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Mapping, Optional, Tuple, Union

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def collective_bytes(records: Iterable[Tuple[str, int]]) -> Dict[str, int]:
    """Bytes per collective kind of ``(kind, bytes)`` records (the dry run's
    counted collectives, each already in the operand-byte convention)."""
    out = {k: 0 for k in COLLECTIVES}
    for kind, n in records:
        out[kind] += int(n)
    return out


@dataclasses.dataclass
class CostReport:
    flops: float = 0.0            # per-device program FLOPs
    bytes_accessed: float = 0.0   # per-device HBM traffic
    collectives: Dict[str, int] = dataclasses.field(default_factory=dict)
    collectives_by_axis: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def collective_total(self) -> int:
        return sum(self.collectives.values())

    def scale_add(self, other: "CostReport", k: float) -> "CostReport":
        def mix(a: Mapping[str, int], b: Mapping[str, int]) -> Dict[str, int]:
            return {key: int(a.get(key, 0) + k * b.get(key, 0)) for key in set(a) | set(b)}

        return CostReport(flops=self.flops + k * other.flops,
                          bytes_accessed=self.bytes_accessed + k * other.bytes_accessed,
                          collectives=mix(self.collectives, other.collectives),
                          collectives_by_axis=mix(self.collectives_by_axis,
                                                  other.collectives_by_axis))


def extrapolate_layers(c1: CostReport, c2: CostReport, num_layers: int) -> CostReport:
    """total = C(1) + (L-1) * (C(2) - C(1)); exact for homogeneous stacks."""
    delta = c2.scale_add(c1, -1.0)
    return c1.scale_add(delta, float(num_layers - 1))


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float            # 6 (or 2) * N_active * tokens
    hlo_flops_total: float        # per-device flops * chips
    chips: int
    peak_flops: Optional[float] = None    # the mfu_bound's peak (default the H100's)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline-model step time: max of the three terms (perfect
        overlap assumption — the optimistic bound)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_fraction(self) -> float:
        return self.model_flops / max(self.hlo_flops_total, 1.0)

    @property
    def mfu_bound(self) -> float:
        """Model-FLOPs utilization at the roofline step time."""
        from repro_torch.launch.mesh import PEAK_FLOPS_BF16
        denom = self.step_time_s * self.chips
        return self.model_flops / max(denom * (self.peak_flops or PEAK_FLOPS_BF16), 1.0)


def roofline_terms(report: CostReport, chips: int, model_flops: float,
                   peak_flops: Optional[float] = None,
                   hbm_bw: Optional[float] = None,
                   link_bw: Union[None, float, Mapping[str, float]] = None) -> Roofline:
    """The three terms of ``report`` (one device's counts). ``link_bw``: one
    number (the reference's form: every collective byte over it), or a dict
    by mesh axis over ``report.collectives_by_axis``; default the H100's
    NVLink and InfiniBand by axis."""
    from repro_torch.launch import mesh as mesh_lib

    peak = peak_flops or mesh_lib.PEAK_FLOPS_BF16
    hbm = hbm_bw or mesh_lib.HBM_BW
    link = link_bw or mesh_lib.LINK_BW
    if isinstance(link, Mapping):
        missing = set(report.collectives_by_axis) - set(link)
        if missing:
            raise ValueError(f"no link bandwidth for mesh axes {sorted(missing)}")
        collective_s = sum(n / link[ax] for ax, n in report.collectives_by_axis.items())
    else:
        collective_s = report.collective_total / link
    return Roofline(
        compute_s=report.flops / peak,
        memory_s=report.bytes_accessed / hbm,
        collective_s=collective_s,
        model_flops=model_flops,
        hlo_flops_total=report.flops * chips,
        chips=chips, peak_flops=peak_flops)
