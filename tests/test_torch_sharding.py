"""The port's partitioning rules and mesh surface against the JAX package.

``launch.sharding.resolve_pspec`` must give the reference's partition spec
for every parameter leaf of every registered config, on every mesh shape,
profile and FSDP setting of the grid (the rules read nothing of a mesh but
``.shape``, so a stub carries it).  ``MeshSpec`` parses, sizes and refuses
as ``tests/test_mesh_serving.py:159-202`` holds the reference's; meshes
validate the world size as the reference validates the device count; a
1 x 1 mesh needs no process group."""
import types

import jax  # noqa: F401  (the reference's sharding module imports it)
import pytest
import torch

import repro.configs as JC
from repro.launch import sharding as JS
from repro.models import model as JM
from repro.models.params import is_spec as j_is_spec
import repro_torch.configs as TC
from repro_torch.configs import reduce_config
from repro_torch.launch import mesh as TMESH
from repro_torch.launch import sharding as TS
from repro_torch.models import model as TM
from repro_torch.models.params import ParamSpec
from repro_torch.models.params import is_spec as t_is_spec
from repro_torch.serving import Engine, EngineConfig, MeshSpec


def _leaves(tree, is_spec, path=()):
    if is_spec(tree):
        yield "/".join(path), tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], is_spec, path + (str(k),))
    else:
        for i, v in enumerate(tree):
            yield from _leaves(v, is_spec, path + (str(i),))


MESHES = [(1, 2), (2, 4), (16, 16), (2, 16, 16)]


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("mode", ["2d", "fsdp"])
@pytest.mark.parametrize("shape", MESHES)
def test_resolve_pspec_equals_jax(shape, mode, fsdp):
    """Every ``param_specs`` leaf of every config shared by both registries,
    entry for entry (the fsdp profile without FSDP shards nothing)."""
    axes = ("pod", "data", "model")[-len(shape):]
    mesh = types.SimpleNamespace(shape=dict(zip(axes, shape)))
    jprof = JS.profile_for(types.SimpleNamespace(parallel_mode=mode))
    tprof = TS.profile_for(types.SimpleNamespace(parallel_mode=mode))
    names = sorted(set(JC.REGISTRY) & set(TC.REGISTRY))
    assert len(names) == len(TC.REGISTRY) >= 11
    checked = sharded = 0
    for name in names:
        jl = dict(_leaves(JM.param_specs(JC.get_config(name)), j_is_spec))
        tl = dict(_leaves(TM.param_specs(TC.get_config(name)), t_is_spec))
        assert set(jl) == set(tl), name
        for key, tspec in tl.items():
            want = tuple(JS.resolve_pspec(jl[key], mesh, fsdp=fsdp, profile=jprof))
            got = TS.resolve_pspec(tspec, mesh, fsdp=fsdp, profile=tprof)
            assert got == want, (name, key, got, want)
            checked += 1
            sharded += bool(TS.sliced_dims(got))
    assert checked > 300 and (sharded > 0) == (mode == "2d" or fsdp)


def test_batch_rule_and_local_shapes():
    """The graded batch fallback (data, then none) and a rank's share of a
    paged pool: kv_heads over model when they divide, whole when not."""
    mesh = types.SimpleNamespace(shape={"data": 2, "model": 4})
    assert TS.resolve_pspec(ParamSpec((8, 3), ("batch", None)), mesh) == ("data", None)
    assert TS.resolve_pspec(ParamSpec((3, 3), ("batch", None)), mesh) == (None, None)
    assert TS.resolve_pspec(ParamSpec((8, 6), ("kv_heads", "heads")), mesh) == ("model", None)

    class Stub:
        shape = {"data": 1, "model": 2}

        def size(self, a):
            return self.shape.get(a, 1)

        def index(self, a):
            return 1 if a == "model" else 0

    cfg = reduce_config(TC.get_config("deepseek-67b"))  # 4 heads over 2 KV heads
    pools = TM.paged_cache_specs(cfg, 2, 5, 8, Stub())
    k = pools[0]["0"]["k"]
    assert k.shape == (cfg.num_layers, 5, 8, 1, cfg.head_dim)
    w = torch.arange(24.0).reshape(2, 3, 4)
    got = TS.local_slice(w, Stub(), (None, None, "model"))
    assert torch.equal(got, w[:, :, 2:]) and got.is_contiguous()


def test_mesh_spec_parse():
    assert MeshSpec.parse("1x8") == MeshSpec(1, 8)
    assert MeshSpec.parse("2x4") == MeshSpec(2, 4)
    assert MeshSpec.parse("4") == MeshSpec(1, 4)
    assert MeshSpec.parse("2×4") == MeshSpec(2, 4)
    assert MeshSpec.parse(MeshSpec(1, 2)) == MeshSpec(1, 2)
    assert MeshSpec(2, 4).size == 8
    with pytest.raises(ValueError):
        MeshSpec.parse("1x2x3")
    with pytest.raises(ValueError):
        MeshSpec.parse("ax2")
    with pytest.raises(ValueError):
        MeshSpec(0, 4)


def test_engine_config_coerces_mesh_strings():
    assert EngineConfig(mesh="1x2").mesh == MeshSpec(1, 2)
    assert EngineConfig(mesh=None).mesh is None
    assert EngineConfig(mesh=MeshSpec(1, 4)).mesh == MeshSpec(1, 4)
    assert EngineConfig(mesh="2").mesh == MeshSpec(1, 2)


def test_make_device_mesh_validates_count():
    """Without a process group the world is one rank: a 1 x 1 mesh builds,
    a larger one is refused with the way to start the ranks."""
    mesh = TMESH.make_device_mesh((1, 1), ("data", "model"))
    assert dict(mesh.shape) == {"data": 1, "model": 1} and mesh.groups == {}
    with pytest.raises(ValueError, match="devices.*init_process_group"):
        TMESH.make_device_mesh((1, 2), ("data", "model"))
    assert TMESH.data_axes(mesh) == ("data",)


def test_make_production_mesh_validates_count():
    mesh = TMESH.make_production_mesh(shape=(1, 1))
    assert mesh.devices.size == 1 and mesh.axis_names == ("data", "model")
    with pytest.raises(ValueError, match="device"):
        TMESH.make_production_mesh(shape=(3, 5))
    with pytest.raises(ValueError, match="256 devices"):
        TMESH.make_production_mesh()


def test_mesh_spec_1x1_needs_no_group():
    """A 1 x 1 spec builds with no process group, and an engine given it
    serves on its one device exactly as without a mesh."""
    assert not torch.distributed.is_initialized()
    mesh = MeshSpec(1, 1).build()
    assert dict(mesh.shape) == {"data": 1, "model": 1}
    assert TMESH.host_mesh().size_total == 1
    cfg = reduce_config(TC.get_config("cgra-edge"))
    params = TM.init(cfg, seed=0, device="cpu")
    kw = dict(max_batch=2, max_len=64, page_size=16)
    prompts = [[5, 6, 7], [1, 2, 3, 4, 5]]
    base, _ = Engine(cfg, params, EngineConfig(**kw), device="cpu").generate(prompts, 4)
    eng = Engine(cfg, params, EngineConfig(mesh="1x1", **kw), device="cpu")
    assert eng.mesh is None
    assert eng.generate(prompts, 4)[0] == base
