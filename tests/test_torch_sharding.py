"""The port's sharding rules (`repro_torch.runtime.sharding`) and meshes
(`repro_torch.launch.mesh`) against the reference's, on the CPU, with no
ranks: the specs resolve against shape-only meshes.

  * every arch at its full config: the reference's abstract params and
    optimizer state (`jax.eval_shape` of its `make_train_state`, nothing
    allocated) through both packages' `_param_logical` + `_resolve`, on the
    production meshes (16, 16) ("data", "model") with multi_pod False and
    (2, 16, 16) ("pod", "data", "model") with multi_pod True: equal leaf
    for leaf (the optimizer state through the port's `opt_shardings`);
  * every arch's reduced caches the same through `_cache_logical`;
  * the port's own reduced trees: the reference's keys and shapes
    (`Group.key` / `Group.shape`, the optimizer state's), and each
    per-layer tensor's spec is its stacked leaf's less the "layers" entry;
  * the DTensor placements of a dim on ("pod", "data").
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models.model import build_model as ref_build_model
from repro.runtime import sharding as ref_shd
from repro.runtime.train_lib import make_train_state as ref_make_train_state
from repro_torch.configs import get_config, list_archs
from repro_torch.core.tree import tree_paths
from repro_torch.data.tokens import lm_batch
from repro_torch.launch.mesh import ShapeMesh, make_host_mesh, make_production_mesh
from repro_torch.models import build_model
from repro_torch.optim import param_groups
from repro_torch.runtime import sharding as shd
from repro_torch.runtime.train_lib import make_train_state

MESHES = ((False, make_production_mesh(multi_pod=False)),
          (True, make_production_mesh(multi_pod=True)))
REF_OPT_KEYS = ("m", "v", "vr", "vc", "mu", "nu", "count", "ef")


class FakeMesh:
    """The reference test's shape-only mesh."""
    def __init__(self, shape: dict):
        self.shape = shape


@functools.lru_cache(maxsize=None)
def ref_abstract(arch: str, reduced: bool):
    cfg = ref_get_config(arch)
    cfg = cfg.reduced() if reduced else cfg
    model = ref_build_model(cfg)
    state = jax.eval_shape(lambda r: ref_make_train_state(model, r), jax.random.PRNGKey(0))
    return cfg, state


def ref_specs(tree, cfg, mesh, multi_pod: bool, strip=(), logical=None) -> dict:
    """{path: spec} of the reference's rules over its tree."""
    rules = ref_shd.logical_rules(cfg, multi_pod)
    logical = logical or ref_shd._param_logical
    out = {}

    def one(path, leaf):
        names = tuple(ref_shd._path_name(p) for p in path)
        kept = tuple(n for n in names if n not in strip)
        out["/".join(names)] = tuple(ref_shd._resolve(logical(kept, len(leaf.shape)),
                                                      leaf.shape, rules, mesh))
    jax.tree_util.tree_map_with_path(one, tree)
    return out


def port_specs(tree, cfg, mesh, multi_pod: bool, logical=None) -> dict:
    """{path: spec} of the port's `_param_logical` (or `logical`) +
    `_resolve` over the reference's tree."""
    rules = shd.logical_rules(cfg, multi_pod)
    logical = logical or shd._param_logical
    out = {}

    def one(path, leaf):
        names = tuple(ref_shd._path_name(p) for p in path)
        out["/".join(names)] = shd._resolve(logical(names, len(leaf.shape)), leaf.shape,
                                            rules, mesh)
    jax.tree_util.tree_map_with_path(one, tree)
    return out


@pytest.mark.parametrize("arch", list_archs())
def test_full_config_specs_equal_the_reference(arch):
    ref_cfg, state = ref_abstract(arch, False)
    cfg = get_config(arch)
    assert all(getattr(cfg, f) == getattr(ref_cfg, f)
               for f in ("fsdp", "fsdp_pod", "prefer_dp", "emb_vocab_sharded"))
    for multi_pod, mesh in MESHES:
        fake = FakeMesh(mesh.shape)
        want = ref_specs(state.params, ref_cfg, fake, multi_pod)
        assert port_specs(state.params, cfg, mesh, multi_pod) == want
        assert any(s != (None,) * len(s) for s in want.values())
        want_opt = ref_specs(state.opt, ref_cfg, fake, multi_pod, strip=REF_OPT_KEYS)
        got_opt = {k: s.spec for k, s in
                   tree_paths(shd.opt_shardings(state.opt, cfg, mesh, multi_pod=multi_pod))}
        assert got_opt == want_opt


@pytest.mark.parametrize("arch", list_archs())
def test_cache_specs_equal_the_reference(arch):
    """The reference's stacked caches through both rules; the port's
    per-layer caches take the stacked spec less its "layers" entry."""
    ref_cfg, _ = ref_abstract(arch, True)
    cfg = get_config(arch).reduced()
    caches = jax.eval_shape(lambda: ref_build_model(ref_cfg).init_cache(16, 32))
    for multi_pod, mesh in MESHES:
        want = ref_specs(caches, ref_cfg, FakeMesh(mesh.shape), multi_pod,
                         logical=ref_shd._cache_logical)
        assert port_specs(caches, cfg, mesh, multi_pod, logical=shd._cache_logical) == want
        by_leaf = {}
        for (path, spec), (_, leaf) in zip(sorted(want.items()),
                                           sorted(ref_paths_shapes(caches).items())):
            by_leaf[(path.rsplit("/", 1)[-1], leaf[1:])] = spec[1:]
        port = build_model(cfg, "cpu").init_cache(16, 32)
        got = tree_paths(shd.cache_shardings(port, cfg, mesh, multi_pod=multi_pod))
        leaves = dict(tree_paths(port))
        assert len(got) == len(leaves) > 0
        for path, s in got:
            assert s.spec == by_leaf[(path.rsplit("/", 1)[-1], tuple(leaves[path].shape))], path


def ref_paths_shapes(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(ref_shd._path_name(e) for e in p): tuple(v.shape) for p, v in leaves}


@pytest.mark.parametrize("arch", list_archs())
def test_port_trees_take_the_reference_keys_and_specs(arch):
    ref_cfg, ref_state = ref_abstract(arch, True)
    cfg = get_config(arch).reduced()
    state = make_train_state(build_model(cfg, "cpu"), torch.Generator("cpu").manual_seed(0))
    groups = param_groups(state.params, cfg)
    assert {g.key: g.shape for g in groups} == ref_paths_shapes(ref_state.params)
    assert {k: tuple(t.shape) for k, t in tree_paths(state.opt)} == \
        ref_paths_shapes(ref_state.opt)
    for multi_pod, mesh in MESHES:
        fake = FakeMesh(mesh.shape)
        want = ref_specs(ref_state.params, ref_cfg, fake, multi_pod)
        specs = dict(tree_paths(shd.param_shardings(state.params, cfg, mesh,
                                                    multi_pod=multi_pod)))
        by_id = {id(t): specs[k].spec for k, t in tree_paths(state.params)}
        for g in groups:
            layer = [by_id[id(t)] for t in g.params]
            assert all(s == layer[0] for s in layer), g.key
            got = (None, *layer[0]) if g.stacked else layer[0]
            assert got == want[g.key], (g.key, got, want[g.key])
        want_opt = ref_specs(ref_state.opt, ref_cfg, fake, multi_pod, strip=REF_OPT_KEYS)
        got_opt = {k: s.spec for k, s in
                   tree_paths(shd.opt_shardings(state.opt, cfg, mesh, multi_pod=multi_pod))}
        assert got_opt == want_opt


def test_batch_and_scalar_specs():
    cfg = get_config("qwen2-0.5b")
    batch = lm_batch(cfg.reduced(), batch=32, seq=8)
    for multi_pod, mesh in MESHES:
        specs = dict(tree_paths(shd.batch_shardings(batch, cfg, mesh, multi_pod=multi_pod)))
        want = (("pod", "data"), None) if multi_pod else ("data", None)
        assert {k: s.spec for k, s in specs.items()} == {"tokens": want, "labels": want}
        assert shd.scalar_sharding(mesh).spec == ()


def test_placements_of_a_pod_data_dim():
    from torch.distributed.tensor import Replicate, Shard
    mesh = make_production_mesh(multi_pod=True)
    assert shd.placements((("pod", "data"), "model"), mesh) == [Shard(0), Shard(0), Shard(1)]
    assert shd.placements((None, "data"), mesh) == [Replicate(), Shard(1), Replicate()]
    with pytest.raises(ValueError, match="order"):
        shd.placements((("data", "pod"), None), mesh)


def test_meshes():
    assert make_production_mesh().shape == {"data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True).shape == {"pod": 2, "data": 16, "model": 16}
    assert shd.axis_sizes(ShapeMesh(("data", "model"), (2, 4))) == {"data": 2, "model": 4}
    with pytest.raises(RuntimeError, match="process group"):
        make_host_mesh()


def test_shard_of_is_pod_major():
    """A (pod, data) split of dim 0 over a (2, 2) mesh: rank (p, d) holds
    block 2p + d, as a JAX PartitionSpec(("pod", "data")) gives."""
    from torch.distributed.tensor import Shard

    class Mesh22:
        def __init__(self, coord):
            self.coord = coord

        def get_coordinate(self):
            return self.coord

        def size(self, i):
            return 2
    full = torch.arange(16).reshape(8, 2)
    for p in range(2):
        for d in range(2):
            got = shd.shard_of(full, Mesh22([p, d]), [Shard(0), Shard(0)])
            assert np.array_equal(got.numpy(), full[(2 * p + d) * 2:(2 * p + d + 1) * 2].numpy())
