"""The sum of the sparse rows over ``data`` by owner
(``collectives.sum_rows_over_data``), on (2, 2) and (4, 1) meshes of gloo
ranks on the CPU, held bit for bit against the gather-everything sum it
replaced, kept here as the oracle: every data rank's rows gathered, in
rank order, and summed per unique id by ``segment_stats``, then cut to the
rank's ``model`` slice.

One world of 4 ranks computes everything once (module fixture):
- the sum on Zipf-skewed ids (most rows fall to one owner), with a rank
  that has no rows, and without ``db``;
- one training step of reduced stablelm-3b (2 layers, float32) with
  Adagrad and two with lazy AdamW, under clipping that bites, through the
  new sum and through the oracle patched into ``collectives``: the
  parameters, the optimizer state and the gradient norm bit-equal;
- the step's gradient norm with two faults planted in the sparse rows'
  share of it (summed over ``model`` twice, not summed): the present sum's
  step (whole rows, counted once) tells them apart.

The dry run's count of the sum's bytes (a fake world, one subprocess) stays
within the bound of ``collectives.data_sum_plan`` at dp = 2, 4 and 8, and
does not grow with dp. No JAX here: the reference is the port's own
previous sum, whose bits the new one must keep.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import _torch_world as W

N_RANKS = 4
MESHES = ("2x2", "4x1")
V, D = 96, 6                     # the table's rows and width
RULES = ("adagrad", "adamw")

WORLD = """
import dataclasses
import numpy as np
import torch
from repro_torch import configs, tree_util
from repro_torch.core.samplers import UniformSampler
from repro_torch.kernels import ops
from repro_torch.models import lm_head
from repro_torch.optim import OptimizerConfig, init_opt_state, sparse as sparse_lib
from repro_torch.optim.sparse import SparseRows
from repro_torch.parallel import collectives, gather_train_state, shard_train_state, sharding
from repro_torch.train import init_train_state
from repro_torch.train import step as tstep
import _torch_world as W
import test_torch_rows_data_sum as T

meshes = {"2x2": mesh_of(2), "4x1": mesh_of(1)}
present = collectives.sum_rows_over_data


def oracle_whole(mesh, rows, n_rows):
    # The gather-everything sum: every data rank's rows, in rank order.
    if sharding.size(mesh, "data") == 1:
        return rows
    g = sharding.group(mesh, "data")
    parts = [rows.ids, rows.dw] + ([] if rows.db is None else [rows.db])
    ids, dw, *db = [torch.cat(W.gather_ragged(x, g)) for x in parts]
    uniq, inv = sparse_lib.unique_rows(ids)
    plan = ops.segment_plan(inv, uniq.shape[0])
    out_db = (ops.segment_stats(db[0][:, None], inv, uniq.shape[0], plan=plan)[:, 0]
              if db else None)
    return SparseRows(uniq, ops.segment_stats(dw, inv, uniq.shape[0], plan=plan), out_db)


def oracle(mesh, rows, n_rows):
    # The oracle cut to the rank's model slice, as the new sum leaves it.
    whole = oracle_whole(mesh, rows, n_rows)
    if sharding.size(mesh, "data") == 1:
        return whole
    lo = sharding.rank(mesh, "model") * n_rows
    keep = (whole.ids >= lo) & (whole.ids < lo + n_rows)
    return SparseRows(whole.ids[keep], whole.dw[keep],
                      None if whole.db is None else whole.db[keep])


out = {}
for name, mesh in meshes.items():
    dp = sharding.size(mesh, "data")
    n_rows = T.V // sharding.size(mesh, "model")
    for case in T.SUM_CASES:
        rows = T.sum_rows(case, sharding.rank(mesh, "data"))
        out["sum", name, case] = (present(mesh, rows, n_rows), oracle(mesh, rows, n_rows))

cfg = dataclasses.replace(configs.reduced_config("stablelm-3b"), num_layers=2,
                          dtype="float32")
hcfg = lm_head.head_config(cfg, "adversarial_ns", n_neg=2, reg=1e-4)
batches = T.lm_batches(cfg)


def run(mesh, rule, n_steps, sum_fn, axes_fn=None):
    collectives.sum_rows_over_data = sum_fn
    if axes_fn is not None:
        collectives.data_sum_axes = axes_fn
    try:
        opt = OptimizerConfig(**T.opt(rule))
        full = init_train_state(torch.Generator().manual_seed(5), cfg, opt, "adversarial_ns",
                                device="cpu")
        state = shard_train_state(full, mesh, cfg)
        step = tstep.make_train_step(cfg, hcfg, opt, sampler=UniformSampler(cfg.vocab_size),
                                     mesh=mesh)
        norms = []
        for s in range(n_steps):
            state, m = step(state, batches[s], torch.Generator().manual_seed(s))
            norms.append(m["grad_norm"])
        return gather_train_state(state, mesh, cfg), norms
    finally:
        collectives.sum_rows_over_data = present
        collectives.data_sum_axes = AXES


AXES = collectives.data_sum_axes
for name, mesh in meshes.items():
    for rule in T.RULES:
        n = T.RULE_STEPS[rule]
        out["step", name, rule] = (run(mesh, rule, n, present), run(mesh, rule, n, oracle))
mesh = meshes["2x2"]
out["norm", "whole"] = run(mesh, "adagrad", 1, oracle_whole, lambda m: ())[1]
out["norm", "twice"] = run(mesh, "adagrad", 1, present, lambda m: ("model", "model"))[1]
out["norm", "unsummed"] = run(mesh, "adagrad", 1, present, lambda m: ())[1]
save(out)
"""

DRY = """
import json, sys
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch import device as device_lib
from repro_torch.launch import dryrun
from repro_torch.optim.sparse import SparseRows
from repro_torch.parallel import collectives

n_rows, d, n_ids, tp = {n_rows}, {d}, {n_ids}, 2
out = {{}}
for dp in (2, 4, 8):
    mesh = dryrun.mesh_of((dp, tp))
    counter = dryrun.Counter(dryrun._groups(mesh))
    card = device_lib.FakeCard(dryrun.CARD, dryrun.CARD_SM_COUNT, counter.record_kernel)
    with FakeTensorMode(), device_lib.fake_card(card):
        rows = SparseRows(torch.zeros(n_ids, dtype=torch.int64), torch.zeros(n_ids, d),
                          torch.zeros(n_ids))
        counter.adopt(rows)
        with counter:
            got = collectives.sum_rows_over_data(mesh, rows, n_rows)
    out[dp] = dict(peak=counter.peak, rows=got.ids.shape[0],
                   plan=collectives.data_sum_plan(n_ids, n_rows, dp),
                   all_to_all=counter.collectives.get("all-to-all", 0))
print(json.dumps(out))
"""

# ---------------------------------------------------------------------------
# Inputs, drawn from seeds with numpy.
# ---------------------------------------------------------------------------

SUM_CASES = ("zipf", "empty_rank", "no_db")
RULE_STEPS = {"adagrad": 1, "adamw": 2}     # AdamW's second step catches idle rows up
B, S = 4, 8


def sum_rows(case: str, data_rank: int):
    """A data rank's deduped rows (sorted ids, as ``unique_rows`` leaves
    them, then shuffled: the sum must not rely on their order)."""
    from repro_torch.optim.sparse import SparseRows
    rng = np.random.default_rng((11, data_rank, SUM_CASES.index(case)))
    if case == "empty_rank" and data_rank == 1:
        n = 0
    else:
        n = 40
    ids = np.unique(np.minimum(rng.zipf(1.3, n) - 1, V - 1)) if n else np.zeros(0, np.int64)
    ids = rng.permutation(ids).astype(np.int64)
    dw = rng.standard_normal((len(ids), D)).astype(np.float32)
    db = rng.standard_normal(len(ids)).astype(np.float32)
    return SparseRows(torch.as_tensor(ids), torch.as_tensor(dw),
                      None if case == "no_db" else torch.as_tensor(db))


def lm_batches(cfg, n=2):
    out = []
    for s in range(n):
        rng = np.random.default_rng((13, s))
        toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int64)
        out.append({"tokens": torch.as_tensor(toks[:, :-1]),
                    "labels": torch.as_tensor(toks[:, 1:]),
                    "mask": torch.ones((B, S))})
    return out


def opt(rule: str) -> dict:
    # A clip far below the gradient's norm: every step's updates scale by it.
    kw = dict(name=rule, learning_rate=0.05, clip_norm=1e-3)
    if rule == "adamw":
        kw["weight_decay"] = 0.1
    return kw


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("rows_data_sum")
    W.run_world(tmp, N_RANKS, WORLD, timeout=150)
    return W.load_outputs(tmp, N_RANKS)


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rank_coords(mesh: str, rank: int):
    """(data rank, model rank, tp) of a world rank on a ("data", "model") mesh."""
    tp = 2 if mesh == "2x2" else 1
    return rank // tp, rank % tp, tp


def _same(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("case", SUM_CASES)
@pytest.mark.parametrize("mesh", MESHES)
def test_sum_is_bit_equal_to_the_gather_everything_sum(world, mesh, case):
    """The owner's sum keeps every bit of the present sum, cut to the rank's
    slice; ids sorted and all in the slice."""
    for rank, out in enumerate(world):
        got, want = out["sum", mesh, case]
        assert _same(got.ids, want.ids) and _same(got.dw, want.dw) and _same(got.db, want.db)
        _, m, tp = _rank_coords(mesh, rank)
        lo, n_rows = m * V // tp, V // tp
        assert bool(((got.ids >= lo) & (got.ids < lo + n_rows)).all())
        assert torch.equal(got.ids, torch.sort(got.ids).values)


@pytest.mark.parametrize("mesh", MESHES)
def test_zipf_ids_load_one_owner_and_every_touched_id_is_kept(world, mesh):
    """Skewed ids: the first owner of each slice sums most of the rows; the
    union is exactly the ids any data rank of the slice touched."""
    for rank, out in enumerate(world):
        got, _ = out["sum", mesh, "zipf"]
        d, m, tp = _rank_coords(mesh, rank)
        lo, n_rows = m * V // tp, V // tp
        dp = N_RANKS // tp
        touched = np.unique(np.concatenate([sum_rows("zipf", r).ids.numpy()
                                            for r in range(dp)]))
        want = touched[(touched >= lo) & (touched < lo + n_rows)]
        np.testing.assert_array_equal(got.ids.numpy(), want)
        if m == 0 and dp > 1:
            sub = -(-n_rows // dp)
            assert (got.ids < lo + sub).sum() > len(got.ids) // 2


@pytest.mark.parametrize("case", SUM_CASES)
@pytest.mark.parametrize("mesh", MESHES)
def test_every_data_rank_of_a_slice_holds_the_same_rows(world, mesh, case):
    tp = 2 if mesh == "2x2" else 1
    for rank, out in enumerate(world):
        first = world[rank % tp]["sum", mesh, case][0]
        got = out["sum", mesh, case][0]
        assert _same(got.ids, first.ids) and _same(got.dw, first.dw) and _same(got.db, first.db)


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("mesh", MESHES)
def test_training_step_bit_equal_through_the_present_sum(world, mesh, rule):
    """Adagrad and lazy AdamW steps under a clip that bites: the state and
    the gradient norm through the new sum equal those through the oracle
    (patched into ``collectives``), bit for bit."""
    for out in world:
        (state, norms), (want_state, want_norms) = out["step", mesh, rule]
        for a, b in zip(norms, want_norms):
            assert torch.equal(a, b)
            assert float(a) > 100 * opt(rule)["clip_norm"]          # the clip bites
        got_leaves, want_leaves = W_leaves(state), W_leaves(want_state)
        assert len(got_leaves) == len(want_leaves)
        for a, b in zip(got_leaves, want_leaves):
            assert torch.equal(a, b)


def W_leaves(tree):
    from repro_torch import tree_util
    return [x for x in tree_util.leaves(tree) if isinstance(x, torch.Tensor)]


def test_global_norm_sums_the_slices_over_model_once(world):
    """On (2, 2) the step's norm equals the present sum's (whole rows,
    counted once) to float32 reordering; summing the slices' squares over
    ``model`` twice, or not at all, is caught."""
    for out in world:
        want = float(out["norm", "whole"][0])
        for fault in ("twice", "unsummed"):
            got = float(out["norm", fault][0])
            assert abs(got - want) > 1e-4 * want, fault
    for out in world:
        (_, norms), _ = out["step", "2x2", "adagrad"]
        want = float(out["norm", "whole"][0])
        assert abs(float(norms[0]) - want) <= 1e-6 * want


def test_dry_run_bytes_of_the_sum_are_bounded_and_do_not_grow_with_dp(tmp_path):
    """Counted on fake tensors (every id distinct, each rank touching its
    whole slice): the sum's peak stays under its own kept rows, the rows it
    receives and the union, each at most the slice; its all-to-all sends
    each row once; neither grows with the data ranks."""
    n_rows, d, n_ids = 4096, 64, 10_000
    script = tmp_path / "dry.py"
    script.write_text(textwrap.dedent(DRY.format(n_rows=n_rows, d=d, n_ids=n_ids)))
    env = dict(os.environ, PYTHONPATH=os.path.join(W.ROOT, "src"), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, str(script)], cwd=W.ROOT, env=env, text=True,
                         capture_output=True, timeout=120)
    assert res.returncode == 0, res.stderr[-4000:]
    import json
    got = {int(k): v for k, v in json.loads(res.stdout.strip().splitlines()[-1]).items()}
    row_bytes = (d + 1) * 4 + 8
    for dp, r in got.items():
        own, received, union = r["plan"]
        assert own == n_rows and received <= n_rows + dp and union <= n_rows + dp
        assert r["rows"] == union
        assert r["peak"] <= (own + received + union) * row_bytes
        assert r["all_to_all"] <= own * row_bytes + 8 * dp
    assert got[8]["peak"] <= got[4]["peak"] <= got[2]["peak"]
