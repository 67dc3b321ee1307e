"""Shared set-up of the port's mesh tests (``tests/test_torch_parallel*.py``):
a world of gloo ranks on the CPU, each a subprocess with one intra-op
thread, meeting at a file store in the test's temporary directory (so that
files run side by side never share a port), and the numpy inputs both the
ranks and the JAX side draw from a seed. Nothing here imports ``jax``: the
ranks import this module."""
import os
import subprocess
import sys
import textwrap
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH_TIMEOUT_S = 30

PRELUDE = f"""
import atexit, os, sys
import torch
import torch.distributed
torch.set_num_threads(1)
sys.path.insert(0, {os.path.join(ROOT, "tests")!r})
from repro_torch.launch.mesh import make_host_mesh
RANK = int(os.environ["RANK"])
OUT = os.environ["WORLD_OUT"]
# Tear the group down before the interpreter does: a live gloo group at
# exit can abort the process after its work is done.
atexit.register(lambda: torch.distributed.is_initialized()
                and torch.distributed.destroy_process_group())


def mesh_of(model_axis):
    return make_host_mesh(model_axis, "cpu", timeout_s={MESH_TIMEOUT_S},
                          init_method=os.environ["WORLD_STORE"])


def save(obj):
    torch.save(obj, os.path.join(OUT, f"out_{{RANK}}.pt"))
"""


def run_world(tmp_path, n_ranks: int, body: str, timeout: float = 120.0, check=True):
    """Run ``body`` (after :data:`PRELUDE`) as ``n_ranks`` ranks; returns
    [(returncode, stdout, stderr)] by rank, and the seconds it took. With
    ``check`` every rank must exit 0."""
    script = tmp_path / "world.py"
    script.write_text(PRELUDE + textwrap.dedent(body))
    base = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1",
                WORLD_SIZE=str(n_ranks), LOCAL_WORLD_SIZE=str(n_ranks),
                WORLD_STORE=f"file://{tmp_path / 'store'}", WORLD_OUT=str(tmp_path))
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(script)], cwd=ROOT, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              env=dict(base, RANK=str(r), LOCAL_RANK=str(r)))
             for r in range(n_ranks)]
    out = []
    try:
        for p in procs:
            left = max(timeout - (time.perf_counter() - t0), 1.0)
            o, e = p.communicate(timeout=left)
            out.append((p.returncode, o, e))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    seconds = time.perf_counter() - t0
    if check:
        for r, (rc, o, e) in enumerate(out):
            assert rc == 0, f"rank {r} exited {rc}\nSTDOUT:\n{o}\nSTDERR:\n{e[-4000:]}"
    return out, seconds


def load_outputs(tmp_path, n_ranks: int):
    import torch
    return [torch.load(tmp_path / f"out_{r}.pt", weights_only=False) for r in range(n_ranks)]


def gather_ragged(x, g):
    """Every rank's ``x`` of the process group ``g``, whose dimension 0 may
    differ, in rank order (padded to the largest for the gather)."""
    import torch
    import torch.distributed as dist
    n = torch.tensor([x.shape[0]], dtype=torch.int64, device=x.device)
    sizes = [torch.empty_like(n) for _ in range(dist.get_world_size(g))]
    dist.all_gather(sizes, n, group=g)
    sizes = [int(s) for s in sizes]
    buf = torch.zeros((max(sizes),) + x.shape[1:], dtype=x.dtype, device=x.device)
    buf[:x.shape[0]] = x
    parts = [torch.empty_like(buf) for _ in sizes]
    dist.all_gather(parts, buf, group=g)
    return [p[:s] for p, s in zip(parts, sizes)]


def whole_rows(mesh, rows):
    """A training step's ``SparseRows`` gradient, whole: with more than one
    data rank the step leaves each rank its ``model`` slice of the rows
    (``collectives.sum_rows_over_data``), gathered here over ``model`` in
    rank order (disjoint slices, so the ids stay sorted and unique)."""
    import torch
    from repro_torch.optim.sparse import SparseRows
    from repro_torch.parallel import collectives, sharding
    if not collectives.data_sum_axes(mesh):
        return rows
    g = sharding.group(mesh, "model")
    parts = [torch.cat(gather_ragged(x, g)) for x in (rows.ids, rows.dw)]
    db = None if rows.db is None else torch.cat(gather_ragged(rows.db, g))
    return SparseRows(parts[0], parts[1], db)


# ---------------------------------------------------------------------------
# Inputs, drawn from seeds with numpy on both sides.
# ---------------------------------------------------------------------------

SCORE_SHAPE = dict(c=64, k=16, t=8, n=3)
ROWS_SHAPE = dict(v=64, k=8)
OPT_CASES = (("adagrad", "fp32"), ("sgd", "fp32"), ("adagrad", "bf16"), ("adagrad", "int8"),
             ("sm3", "fp32"), ("sm3", "bf16"), ("adamw", "fp32"), ("adamw", "int8"))
OPT_C, OPT_K, OPT_STEPS = 64, 8, 4
EF_SHAPES = {"w": (32, 8), "b": (16,)}
N_DP = 4


def score_inputs(seed=0):
    s = SCORE_SHAPE
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((s["c"], s["k"])).astype(np.float32)
    b = rng.standard_normal(s["c"]).astype(np.float32)
    h = rng.standard_normal((s["t"], s["k"])).astype(np.float32)
    ids = rng.integers(0, s["c"], (s["t"], s["n"])).astype(np.int64)
    return w, b, h, ids


def rows_inputs(seed=1):
    v, k = ROWS_SHAPE["v"], ROWS_SHAPE["k"]
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((v, k)).astype(np.float32)
    nu = np.abs(rng.standard_normal((v, k))).astype(np.float32)
    ids = np.array([3, 17, 63, 0, 40, 25, v], np.int64)          # v: the sentinel
    vals = rng.standard_normal((len(ids), k)).astype(np.float32)
    vals[-1] = 0.0
    return w, nu, ids, vals


def opt_config(rule: str, state_dtype: str) -> dict:
    kw = dict(name=rule, learning_rate=0.1 if rule == "sm3" else 0.05,
              state_dtype=state_dtype, clip_norm=1.0)
    if rule == "adamw":
        kw["weight_decay"] = 0.2
    return kw


def opt_inputs(seed=2):
    """The head and 4 steps of unique sparse rows (7 rows, then all C)."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((OPT_C, OPT_K)).astype(np.float32)
    b = rng.standard_normal(OPT_C).astype(np.float32)
    steps = []
    for t in range(OPT_STEPS):
        n = 7 if t < OPT_STEPS - 1 else OPT_C
        ids = np.sort(rng.choice(OPT_C, n, replace=False)) if n < OPT_C else np.arange(OPT_C)
        steps.append((ids.astype(np.int64), rng.standard_normal((n, OPT_K)).astype(np.float32),
                      rng.standard_normal(n).astype(np.float32)))
    return w, b, steps


def ef_inputs(seed=3):
    """Per-replica gradients, stacked on a leading axis of N_DP."""
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal((N_DP,) + s).astype(np.float32)
            for k, s in EF_SHAPES.items()}
