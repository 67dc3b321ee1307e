"""The port's roofline (``repro_torch.analysis.roofline``) against the JAX
package's on the same numbers, the production mesh's shapes and its H100
constants, and the analysis and dry-run modules importing no JAX.

With ``link_bw`` one number every formula is the reference's, term for
term; ``mfu_bound`` reads the peak it is given (the reference's reads its
module constant, so both are given that one). ``collective_bytes``: the
reference parses HLO, the port sums the collectives a rank issued; on the
same collectives both count the reference's operand bytes (an all-gather
its part, a reduce-scatter its whole input, an all-reduce its tensor)."""
import math
import os
import subprocess
import sys

import pytest

from repro.analysis import roofline as jrl
from repro.launch import mesh as jmesh
from repro_torch.analysis import roofline as trl
from repro_torch.launch import mesh as tmesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPORTS = [dict(flops=3.1e14, bytes_accessed=7.5e11,
                collectives={"all-gather": 4_000_000, "all-reduce": 9_000_000}),
           dict(flops=5.0e10, bytes_accessed=2.2e12, collectives={"reduce-scatter": 1}),
           dict(flops=1.0, bytes_accessed=1.0, collectives={"all-reduce": 10 ** 12})]
HLO = """
HloModule m
ENTRY %main {
  %p0 = f32[8,16]{1,0} parameter(0)
  %ag = f32[32,16]{1,0} all-gather(f32[8,16]{1,0} %p0), dimensions={0}
  %ar = f32[8,16]{1,0} all-reduce(f32[8,16]{1,0} %p0), to_apply=%add
  %rs = f32[2,16]{1,0} reduce-scatter(f32[8,16]{1,0} %p0), dimensions={0}
  ROOT %out = f32[8,16]{1,0} add(%ar, %p0)
}
"""


def _pair(kw):
    return jrl.CostReport(**kw), trl.CostReport(**kw)


@pytest.mark.parametrize("i", range(len(REPORTS)))
def test_roofline_terms_match_reference(i):
    j, t = _pair(REPORTS[i])
    kw = dict(peak_flops=jmesh.PEAK_FLOPS_BF16, hbm_bw=3.35e12, link_bw=50e9)
    jr = jrl.roofline_terms(j, 256, 2.5e16, **kw)
    tr = trl.roofline_terms(t, 256, 2.5e16, **kw)
    for name in ("compute_s", "memory_s", "collective_s", "model_flops", "hlo_flops_total",
                 "chips", "bottleneck", "step_time_s", "useful_flops_fraction", "mfu_bound"):
        assert getattr(tr, name) == getattr(jr, name), name
    assert t.collective_total == j.collective_total


def test_scale_add_and_extrapolate_match_reference():
    (j1, t1), (j2, t2) = _pair(REPORTS[0]), _pair(REPORTS[1])
    for jr, tr in ((j1.scale_add(j2, -0.5), t1.scale_add(t2, -0.5)),
                   (jrl.extrapolate_layers(j1, j2, 24), trl.extrapolate_layers(t1, t2, 24))):
        assert (tr.flops, tr.bytes_accessed, tr.collectives) == \
            (jr.flops, jr.bytes_accessed, jr.collectives)


def test_collective_bytes_follow_the_reference_convention():
    got = trl.collective_bytes([("all-gather", 512), ("all-reduce", 512),
                                ("reduce-scatter", 512)])
    assert got == jrl.collective_bytes(HLO)
    assert trl.COLLECTIVES == jrl.COLLECTIVES


def test_link_bandwidth_by_axis():
    """A dict by mesh axis: each axis's bytes over its link; the H100's
    NVLink and InfiniBand by default."""
    rep = trl.CostReport(flops=1e15, bytes_accessed=1e12,
                         collectives={"all-reduce": 3_000_000_000},
                         collectives_by_axis={"model": 2_000_000_000, "data": 1_000_000_000})
    r = trl.roofline_terms(rep, 256, 1e17)
    assert math.isclose(r.collective_s, 2e9 / tmesh.NVLINK_BW + 1e9 / tmesh.IB_BW)
    assert math.isclose(r.compute_s, 1e15 / tmesh.PEAK_FLOPS_BF16)
    assert math.isclose(r.memory_s, 1e12 / tmesh.HBM_BW)
    assert math.isclose(r.mfu_bound, 1e17 / (r.step_time_s * 256 * tmesh.PEAK_FLOPS_BF16))
    with pytest.raises(ValueError, match="data"):
        trl.roofline_terms(rep, 256, 1e17, link_bw={"model": 1e9})


def test_h100_constants():
    """NVIDIA's data sheet for the H100 SXM ("NVIDIA H100 80GB HBM3,
    700.00 W"); no TPU figure."""
    assert (tmesh.PEAK_FLOPS_BF16, tmesh.HBM_BW, tmesh.NVLINK_BW, tmesh.IB_BW) == \
        (989e12, 3.35e12, 450e9, 50e9)
    assert tmesh.LINK_BW == {"model": tmesh.NVLINK_BW, "data": tmesh.IB_BW}
    assert not hasattr(tmesh, "ICI_BW")


@pytest.mark.parametrize("multi_pod,shape", [(False, (32, 8)), (True, (64, 8))])
def test_production_mesh_shape(multi_pod, shape):
    """The reference's chip counts (16 x 16, 2 x 16 x 16), on H100 nodes of 8."""
    assert tmesh.production_mesh_shape(multi_pod) == shape
    assert math.prod(shape) == (512 if multi_pod else 256)


def test_production_mesh_and_no_jax_in_a_subprocess():
    """In a fresh process: the production mesh on a fake world of 256
    ranks, a world of another size refused, and neither the analysis nor
    the dry run importing ``jax`` or the JAX package."""
    code = """
import sys
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
import repro_torch.analysis.roofline, repro_torch.launch.dryrun
from repro_torch.launch import mesh
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "repro.")) or m == "repro")
assert not bad, bad
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=16)
try:
    mesh.make_production_mesh()
    raise SystemExit("a world of 16 was taken")
except ValueError as e:
    assert "256" in str(e), e
dist.destroy_process_group()
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=256)
m = mesh.make_production_mesh()
assert tuple(m.shape) == (32, 8) and m.mesh_dim_names == ("data", "model"), m
print("OK")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")), timeout=120)
    assert out.returncode == 0 and out.stdout.strip().endswith("OK"), out.stderr[-3000:]
