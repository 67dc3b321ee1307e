"""The port's placement rules against the reference's
``repro.parallel.sharding``, for all ten configs at full width on six mesh
shapes: ``param_spec`` leaf by leaf (the JAX side's shapes from
``jax.eval_shape`` of ``init_params``, the port's from a meta-device
build), and the cache specs, equal for the SSM's ``state`` and ``conv``
and different, as documented, for ``k`` and ``v``: the port splits the KV
heads over ``model`` where the reference splits the sequence. No process
group: the port's rules take a (data, model) shape, the reference's an
``AbstractMesh``."""
import functools

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

    local = sharding.shard_params(params, cfg, Rank1Of2())
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
    split, whole = sharding.split_trunk_bytes(params, cfg, (1, 2))
    assert split + whole == sharding.trunk_bytes(params)
    assert sharding.trunk_bytes(local) == split // 2 + whole


def test_shard_params_raises_on_a_dim_that_does_not_divide():
    cfg = tconfigs.reduced_config("h2o-danube-3-4b")          # d_ff 160 over 3 ranks
    params = ttransformer.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")

    class Rank0Of3:
        shape = (1, 3)
        mesh_dim_names = sharding.MESH_DIMS

        def get_local_rank(self, dim):
            return 0

    with pytest.raises(ValueError, match="layers/0/mlp/w_down: dimension 0 of 160"):
        sharding.shard_params({"layers": params["layers"]}, cfg, Rank0Of3())


def test_hint_context_refuses_slice_11_options():
    from repro_torch.parallel import hints

    class Mesh:
        shape = (1, 2)
        mesh_dim_names = sharding.MESH_DIMS

    with pytest.raises(TypeError):
        hints.HintContext(Mesh())                              # not a DeviceMesh
    q = torch.zeros(1, 4, 5, 8)
    assert hints.hint_attn_q(q, 5) == (q, None)                # no context: no hint
