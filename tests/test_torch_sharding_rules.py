"""The port's placement rules against the reference's
``repro.parallel.sharding``, for all ten configs at full width on six mesh
shapes: ``param_spec`` leaf by leaf (the JAX side's shapes from
``jax.eval_shape`` of ``init_params``, the port's from a meta-device
build); ``train_state_spec`` against ``train_state_shardings`` for
adagrad, adamw, sm3 and adamw with int8 head state, leaf by leaf over the
parameters, the optimizer state and the step counters; and the cache
specs, equal for the SSM's ``state`` and ``conv`` and different, as
documented, for ``k`` and ``v``: the port splits the KV heads over
``model`` where the reference splits the sequence. No process group: the
port's rules take a (data, model) shape, the reference's an
``AbstractMesh``.

The training state differs in structure where the reference stacks the
layers: SM3 factors a 2-D leaf into a row and a column cover and keeps a
3-D one whole, and lazy AdamW's ``last`` indexes a leaf's dim 0, which is
the stacked layer dim in the reference and the leaf's rows in the port.
For those pieces the expected placement is the reference's own rule
(``_state_leaf_sharding``) on the port's per-layer leaf."""
import functools

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch import tree_util
from repro_torch.models import transformer as ttransformer
from repro_torch.parallel import sharding

ARCHS = ("mamba2-370m", "musicgen-medium", "stablelm-3b", "deepseek-7b", "gemma2-27b",
         "h2o-danube-3-4b", "qwen2-vl-7b", "deepseek-moe-16b", "mixtral-8x22b", "hymba-1.5b")
MESHES = ((1, 2), (1, 4), (1, 3), (2, 2), (1, 16), (16, 16))
CACHE_BATCH = 4


def _entry(e):
    """A PartitionSpec entry as the port writes it: a one-axis tuple is
    the axis's name."""
    if isinstance(e, tuple):
        return e[0] if len(e) == 1 else e
    return e


def _spec(p, ndim: int, drop_lead: bool) -> tuple:
    spec = tuple(_entry(e) for e in p)
    spec = spec + (None,) * (ndim - len(spec))
    return spec[1:] if drop_lead else spec


@functools.lru_cache(maxsize=None)
def _jax_leaves(arch: str):
    import jax
    from jax.tree_util import DictKey, tree_flatten_with_path
    from repro import configs as jconfigs
    from repro.models import transformer as jtransformer
    cfg = jconfigs.get_config(arch)
    shapes = jax.eval_shape(lambda k: jtransformer.init_params(k, cfg), jax.random.PRNGKey(0))
    flat, _ = tree_flatten_with_path(shapes)
    return cfg, {tuple(str(p.key) for p in path if isinstance(p, DictKey)): (path, leaf)
                 for path, leaf in flat}


def _abstract_mesh(shape):
    from jax.sharding import AbstractMesh
    return AbstractMesh(shape, ("data", "model"))


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_param_spec_matches_reference(arch, mesh):
    from repro.parallel.sharding import param_spec as jparam_spec
    jcfg, jleaves = _jax_leaves(arch)
    cfg = tconfigs.get_config(arch)
    params = ttransformer.init_params(torch.Generator(), cfg, device="meta")
    jmesh = _abstract_mesh(mesh)
    pairs, _ = tree_util.flatten_with_paths(params)
    seen = set()
    for path, leaf in pairs:
        layer = path[0] == "layers"
        key = ("layers",) + path[2:] if layer else path
        jpath, jleaf = jleaves[key]
        assert tuple(jleaf.shape) == ((cfg.num_layers,) if layer else ()) + tuple(leaf.shape)
        want = _spec(jparam_spec(jcfg, jmesh, jpath, jleaf), jleaf.ndim, layer)
        got = sharding.param_spec(cfg, mesh, path, leaf)
        assert got == want, (path, got, want)
        seen.add(key)
    assert seen == set(jleaves)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_reference_but_kv(arch, mesh):
    """state and conv as the reference places them; k and v over their KV
    heads where those divide (whole otherwise), never over the sequence."""
    import jax
    from repro.models import transformer as jtransformer
    from repro.parallel.sharding import cache_shardings, paged_cache_shardings
    jcfg, _ = _jax_leaves(arch)
    cfg = tconfigs.get_config(arch)
    jmesh = _abstract_mesh(mesh)
    dp, tp = mesh
    kv_ax = "model" if cfg.num_kv_heads and cfg.num_kv_heads % tp == 0 else None
    jcache = jax.eval_shape(lambda: jtransformer.init_cache(jcfg, CACHE_BATCH, 16))
    jpaged = jax.eval_shape(lambda: jtransformer.init_paged_cache(jcfg, CACHE_BATCH, 5, 4))
    for got, jtree, jfn in (
            (sharding.cache_spec(cfg, mesh, CACHE_BATCH), jcache, cache_shardings),
            (sharding.paged_cache_spec(cfg, mesh, CACHE_BATCH), jpaged, paged_cache_shardings)):
        want = {k: _spec(s.spec, jtree[k].ndim, False)
                for k, s in jfn(jcfg, jmesh, jtree, CACHE_BATCH).items()}
        assert set(got) == set(want)
        for key in set(got) & {"state", "conv"}:
            assert got[key] == want[key], (key, got[key], want[key])
        for key in set(got) & {"k", "v"}:
            assert want[key][2] is not None and got[key][2] is None   # the sequence dim
            assert got[key][3] == kv_ax and want[key][3] is None      # the KV heads
            assert got[key][4] is None


OPT_CASES = {"adagrad": dict(name="adagrad"), "adamw": dict(name="adamw"),
             "sm3": dict(name="sm3"), "int8": dict(name="adamw", state_dtype="int8")}


@functools.lru_cache(maxsize=None)
def _jax_params(arch: str):
    import jax
    from repro.models import transformer as jtransformer
    cfg, _ = _jax_leaves(arch)
    return jax.eval_shape(lambda k: jtransformer.init_params(k, cfg), jax.random.PRNGKey(0))


def _jax_train_state(arch: str, opt: str):
    """The reference's ``TrainState`` of shapes, its head state left out
    (the placement replicates it whatever it holds)."""
    import jax
    from repro.optim import OptimizerConfig as JOptimizerConfig
    from repro.optim import init_opt_state as jinit_opt_state
    from repro.train.state import TrainState as JTrainState
    params = _jax_params(arch)
    scalar = jax.ShapeDtypeStruct((), np.int32)
    return JTrainState(step=scalar, params=params, opt_state=jax.eval_shape(
        lambda p: jinit_opt_state(JOptimizerConfig(**OPT_CASES[opt]), p), params),
        head_state=None, gen_fit_step=scalar, snr_ewma=scalar, snr_ref=scalar)


def _names(path) -> tuple:
    out = []
    for p in path:
        for attr in ("key", "name", "idx"):
            if hasattr(p, attr):
                out.append(str(getattr(p, attr)))
                break
    return tuple(out)


@pytest.mark.parametrize("opt", list(OPT_CASES))
@pytest.mark.parametrize("arch", ARCHS)
def test_train_state_spec_matches_reference(arch, opt):
    import jax
    from jax.sharding import PartitionSpec as P
    from repro.optim.optimizers import Sm3Cover as JSm3Cover
    from repro.parallel.sharding import _state_leaf_sharding, train_state_shardings
    from repro_torch.optim import OptimizerConfig, init_opt_state
    jcfg, _ = _jax_leaves(arch)
    jstate = _jax_train_state(arch, opt)
    cfg = tconfigs.get_config(arch)
    params = ttransformer.init_params(torch.Generator(), cfg, device="meta")
    state = {"step": 0, "params": params,
             "opt_state": init_opt_state(OptimizerConfig(**OPT_CASES[opt]), params)}
    ndim = {_names(p): len(getattr(x, "shape", ()))
            for p, x in jax.tree_util.tree_flatten_with_path(jstate)[0]}
    sds = jax.ShapeDtypeStruct((1,), np.float32)
    for mesh in MESHES:
        jmesh = _abstract_mesh(mesh)
        want = {_names(p): sh.spec for p, sh in jax.tree_util.tree_flatten_with_path(
            train_state_shardings(jcfg, jmesh, jstate))[0]}
        seen = set()
        for path, got in sharding.train_state_spec(cfg, mesh, state):
            layer = "layers" in path
            key = tuple(n for i, n in enumerate(path) if not (layer and path[i - 1] == "layers"))
            if key in want and ndim[key] == len(got) + layer:
                expect = _spec(want[key], ndim[key], layer)
                seen.add(key)
            else:      # a per-layer piece of a leaf the reference stacks: its rule
                assert layer and key[0] == "opt_state", path
                box = key[-1] in ("row", "col")
                base = key[:-1] if box else key
                p_key = ("params",) + base[2:]
                p_spec = P(*_spec(want[p_key], ndim[p_key], True))
                if box:
                    placed = getattr(_state_leaf_sharding(
                        jmesh, p_spec, JSm3Cover(row=sds, col=sds)), key[-1])
                else:
                    placed = _state_leaf_sharding(
                        jmesh, p_spec, jax.ShapeDtypeStruct((1,) * len(got), np.float32))
                expect = _spec(placed.spec, len(got), False)
                seen.update(k for k in (base, base + ("row",), base + ("col",)) if k in want)
            assert got == expect, (mesh, path, got, expect)
        assert seen == {k for k in want if k[0] in ("step", "params", "opt_state")}


@pytest.mark.parametrize("arch", ARCHS)
def test_shard_params_cuts_what_the_spec_splits(arch):
    """On a (1, 2) mesh of the reduced config: every leaf's local shape is
    the full one with each ``model`` dim halved, and the split and whole
    trunk bytes add up to the one-rank trunk."""
    cfg = tconfigs.reduced_config(arch)
    params = ttransformer.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")

    class Rank1Of2:               # stands in for a DeviceMesh: rank 1 of tp 2
        shape = (1, 2)
        mesh_dim_names = sharding.MESH_DIMS

        def get_local_rank(self, dim):
            return 1 if dim == "model" else 0

    local = sharding.shard_train_state(params, Rank1Of2(), cfg)
    for (path, full), (_, part) in zip(tree_util.flatten_with_paths(params)[0],
                                       tree_util.flatten_with_paths(local)[0]):
        spec = sharding.param_spec(cfg, (1, 2), path, full)
        assert tuple(part.shape) == sharding.local_shape(full.shape, spec, (1, 2)), path
        if "model" in spec:
            dim = spec.index("model")
            n = full.shape[dim] // 2
            assert torch.equal(part, full.narrow(dim, n, n)), path
        else:
            assert part is full
    b = sharding.split_bytes({"layers": params["layers"]}, cfg, (1, 2))
    assert b.data == b.both == 0              # one data rank cuts nothing
    assert b.model + b.whole == sharding.tree_bytes(params["layers"])
    assert sharding.tree_bytes(local["layers"]) == b.model // 2 + b.whole


FSDP_MESHES = ((2, 1), (2, 2), (4, 1), (2, 4))


class _Rank:
    """Stands in for a ``DeviceMesh`` of ``shape``: the rank at ``coords``
    (data, model), for the rules alone."""
    mesh_dim_names = sharding.MESH_DIMS

    def __init__(self, shape, coords):
        self.shape, self.coords = shape, coords

    def get_local_rank(self, dim):
        return self.coords[sharding.MESH_DIMS.index(dim)]


@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_local_shapes_match_reference_shard_shape(arch):
    """On (2, 1), (2, 2), (4, 1) and (2, 4), at full width on the meta
    device: every leaf of the parameters and of Adagrad's, AdamW's, SM3's
    and int8 AdamW's state, after ``shard_train_state``, has the shape the
    reference's ``NamedSharding(mesh, spec).shard_shape`` gives its full
    shape, and the bytes a rank holds are exactly model / tp + data / dp +
    both / (dp·tp) + whole of the one-rank state's."""
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P
    from repro_torch.optim import OptimizerConfig, init_opt_state
    cfg = tconfigs.get_config(arch)
    params = ttransformer.init_params(torch.Generator(), cfg, device="meta")
    trees = {"params": params}
    trees.update({opt: init_opt_state(OptimizerConfig(**kw), params)
                  for opt, kw in OPT_CASES.items()})
    for mesh in FSDP_MESHES:
        jmesh = _abstract_mesh(mesh)
        rank = _Rank(mesh, (mesh[0] - 1, mesh[1] - 1))
        for name, tree in trees.items():
            local = sharding.shard_train_state(tree, rank, cfg)
            for (path, sp), full, part in zip(sharding.train_state_spec(cfg, mesh, tree),
                                              tree_util.leaves(tree), tree_util.leaves(local)):
                if not isinstance(full, torch.Tensor):
                    continue
                want = NamedSharding(jmesh, P(*sp)).shard_shape(tuple(full.shape))
                assert tuple(part.shape) == tuple(want), (mesh, name, path, sp)
            b = sharding.split_bytes(tree, cfg, mesh)
            assert b.total == sharding.tree_bytes(tree)
            assert sharding.tree_bytes(local) == b.a_rank(mesh), (mesh, name)
            if mesh[0] > 1:
                assert b.data + b.both > 0
            if mesh[1] == 1:
                assert b.model == b.both == 0


def test_fsdp_raises_on_a_data_dim_that_does_not_divide():
    cfg = tconfigs.reduced_config("h2o-danube-3-4b")          # d_model 64 over 3 ranks
    params = ttransformer.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    with pytest.raises(ValueError, match="layers/0/attn/wk: dimension 0 of 64 does not "
                                         "divide over 3 data ranks"):
        sharding.shard_train_state({"layers": params["layers"]}, _Rank((3, 1), (0, 0)), cfg)


def test_shard_params_raises_on_a_dim_that_does_not_divide():
    cfg = tconfigs.reduced_config("h2o-danube-3-4b")          # d_ff 160 over 3 ranks
    params = ttransformer.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")

    class Rank0Of3:
        shape = (1, 3)
        mesh_dim_names = sharding.MESH_DIMS

        def get_local_rank(self, dim):
            return 0

    with pytest.raises(ValueError, match="layers/0/mlp/w_down: dimension 0 of 160"):
        sharding.shard_train_state({"layers": params["layers"]}, Rank0Of3(), cfg)


def test_hint_context_takes_seq_parallel_residual(monkeypatch):
    """A stand-in mesh is refused; past that check (patched here)
    ``seq_parallel_residual`` and ``fsdp_gather_weights`` are taken, and
    the residual rows follow the model axis: none on one model rank or an
    S that does not divide, none without the hint."""
    from repro_torch.parallel import hints

    class Mesh:
        shape = (1, 2)
        mesh_dim_names = sharding.MESH_DIMS

    with pytest.raises(TypeError):
        hints.HintContext(Mesh())                              # not a DeviceMesh
    assert hints.hinted_rows(5, 4) is None                     # no context: no hint
    w = torch.zeros(2, 3)
    assert hints.hint_gathered_weight(w, torch.bfloat16) == torch.float32
    assert hints.hint_expert_act(w) is w
    monkeypatch.setattr(hints.sharding, "check_mesh", lambda mesh: None)
    monkeypatch.setattr(hints.sharding, "rank", lambda mesh, dim: 1)
    assert hints.residual_rows(8) is None
    with hints.sharding_hints(Mesh(), seq_parallel_residual=True):
        assert hints.current().seq_parallel_residual
        assert hints.residual_rows(8) == (4, 8)
        assert hints.residual_rows(7) is None and hints.residual_rows(1) is None
        x = torch.zeros(2, 4, 3)
        assert hints.hint_residual(x, (4, 8)) is x          # already the rank's rows
    with hints.sharding_hints(Mesh()):
        assert not hints.current().seq_parallel_residual
        assert hints.residual_rows(8) is None
    with hints.sharding_hints(Mesh(), fsdp_gather_weights=True):
        assert hints.current().fsdp_gather_weights
        assert hints.hint_gathered_weight(w, torch.bfloat16) == torch.bfloat16
    with hints.sharding_hints(Mesh()):
        assert hints.hint_gathered_weight(w, torch.bfloat16) == torch.float32
