"""Logical-axis -> mesh partitioning rules (port of ``repro.launch.sharding``).

Every parameter and cache dimension carries a logical axis name
(``models.params.ParamSpec``); :func:`resolve_pspec` maps those names onto
the mesh exactly as the reference computes it: the tensor-parallel rules,
the graded batch fallback, the divisibility fallback (a 16-way model axis
cannot shard 8 KV heads: replicate) and the FSDP choice.  A partition spec
is a tuple with one entry a dimension: a mesh axis name, a tuple of them,
or None (the reference's ``PartitionSpec`` entries).

In the port a spec says which slice of a leaf a rank *holds*
(:func:`local_slice`, :func:`local_shape`); there is no partitioner, so
there is no counterpart of the reference's ``constrain`` (a hint to XLA's
sharding propagation) and no ``NamedSharding``.  :func:`activation_mesh` /
:func:`current_mesh` carry the mesh to the model code, as the reference's
trace-time context does, here at call time.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses as _dc

from repro_torch.models.params import ParamSpec, tree_map_specs

# tensor-parallel rules: logical axis -> mesh axis
TP_RULES: dict[str, str] = {
    "vocab": "model",
    "ffn": "model",
    "heads": "model",
    "kv_heads": "model",
    "experts": "model",
}
# data-parallel rules for activations/inputs (pod-major batch)
BATCH_AXES = ("pod", "data")
# FSDP preference order: which logical axis to shard over `data`
FSDP_PREF = ("embed", "ffn", "vocab", "frontend", "lora", "qk")


@_dc.dataclass(frozen=True)
class ShardingProfile:
    """Parallelism layout.  "2d" = TP over `model` + FSDP over `data`
    (default); "fsdp" = no tensor parallelism, batch and parameters sharded
    over both axes."""
    tp_rules: dict = _dc.field(default_factory=lambda: dict(TP_RULES))
    batch_axes: tuple = BATCH_AXES
    fsdp_axes: tuple = ("data",)


def profile_for(cfg) -> ShardingProfile:
    if getattr(cfg, "parallel_mode", "2d") == "fsdp":
        return ShardingProfile(tp_rules={},
                               batch_axes=("pod", "data", "model"),
                               fsdp_axes=("data", "model"))
    return ShardingProfile()


def _divisible(dim: int, size: int) -> bool:
    return dim % size == 0 and dim >= size


def resolve_pspec(spec, mesh, *, fsdp: bool = False,
                  extra_rules: dict | None = None,
                  profile: ShardingProfile | None = None) -> tuple:
    """The partition spec of ``spec`` (a ``ParamSpec``, or anything with
    ``.shape`` and ``.axes``) on ``mesh`` (anything with ``.shape``, a dict
    axis -> size): the reference's ``resolve_pspec``, entry for entry."""
    profile = profile or _current_profile()
    rules = dict(profile.tp_rules)
    if extra_rules:
        rules.update(extra_rules)
    assigned: list = []
    used: set = set()
    for dim, ax in zip(spec.shape, spec.axes):
        entry = None
        if ax == "batch":
            # graded fallback: full batch axes, then drop leading axes
            bax = tuple(a for a in profile.batch_axes if a in mesh.shape)
            cands = [bax[i:] for i in range(len(bax))]
            for cand in cands:
                size = 1
                for a in cand:
                    size *= mesh.shape[a]
                if cand and not (used & set(cand)) and _divisible(dim, size):
                    entry = cand if len(cand) > 1 else cand[0]
                    used |= set(cand)
                    break
        elif ax in rules:
            m = rules[ax]
            if m and m in mesh.shape and m not in used and _divisible(dim, mesh.shape[m]):
                entry = m
                used.add(m)
        assigned.append(entry)
    fax = tuple(a for a in profile.fsdp_axes if a in mesh.shape and a not in used)
    if fsdp and fax:
        fsize = 1
        for a in fax:
            fsize *= mesh.shape[a]
        # prefer the canonical FSDP axes, then any unassigned divisible dim
        order = sorted(
            range(len(assigned)),
            key=lambda i: (FSDP_PREF.index(spec.axes[i])
                           if spec.axes[i] in FSDP_PREF else len(FSDP_PREF)),
        )
        for i in order:
            if assigned[i] is None and spec.axes[i] is not None \
                    and _divisible(spec.shape[i], fsize):
                assigned[i] = fax if len(fax) > 1 else fax[0]
                break
    return tuple(assigned)


def tree_pspecs(spec_tree, mesh, *, fsdp: bool = False,
                extra_rules: dict | None = None,
                profile: ShardingProfile | None = None):
    """:func:`resolve_pspec` of every leaf of a spec tree."""
    return tree_map_specs(lambda s: resolve_pspec(s, mesh, fsdp=fsdp,
                                                  extra_rules=extra_rules,
                                                  profile=profile), spec_tree)


def sliced_dims(pspec: tuple) -> list[int]:
    """The dimensions a rank slices under ``pspec`` (empty: replicated)."""
    return [i for i, e in enumerate(pspec) if e is not None]


def _entry_axes(entry) -> tuple:
    return entry if isinstance(entry, tuple) else (entry,)


def _shards(mesh, entry) -> tuple[int, int]:
    """(shard count, this rank's shard) of a dimension split over the mesh
    axes of ``entry``, major to minor, as JAX lays a multi-axis entry."""
    n, i = 1, 0
    for a in _entry_axes(entry):
        n, i = n * mesh.size(a), i * mesh.size(a) + mesh.index(a)
    return n, i


def local_shape(spec: ParamSpec, mesh, pspec: tuple | None = None) -> ParamSpec:
    """``spec`` with every sliced dimension cut to this rank's share."""
    pspec = resolve_pspec(spec, mesh) if pspec is None else pspec
    shape = list(spec.shape)
    for d in sliced_dims(pspec):
        shape[d] //= _shards(mesh, pspec[d])[0]
    return spec._replace(shape=tuple(shape))


def local_slice(x, mesh, pspec: tuple):
    """This rank's slice of the whole tensor ``x`` under ``pspec``, as a
    tensor of its own (the whole tensor is not kept alive by it)."""
    for d in sliced_dims(pspec):
        n, i = _shards(mesh, pspec[d])
        size = x.shape[d] // n
        x = x.narrow(d, i * size, size)
    return x.contiguous().clone() if sliced_dims(pspec) else x


def tp_size(mesh=None) -> int:
    """Size of the tensor-parallel (`model`) axis; 1 when no mesh is active."""
    mesh = mesh if mesh is not None else _ACT_MESH.get()
    if mesh is None:
        return 1
    return dict(mesh.shape).get("model", 1)


_ACT_MESH: contextvars.ContextVar = contextvars.ContextVar("act_mesh", default=None)
_ACT_PROFILE: contextvars.ContextVar = contextvars.ContextVar("act_profile",
                                                              default=None)


@contextlib.contextmanager
def activation_mesh(mesh, profile: ShardingProfile | None = None):
    """Run the model code inside with ``mesh`` current: each layer then
    computes this rank's shard and issues the collectives that join them."""
    tok = _ACT_MESH.set(mesh)
    tok2 = _ACT_PROFILE.set(profile)
    try:
        yield
    finally:
        _ACT_MESH.reset(tok)
        _ACT_PROFILE.reset(tok2)


def current_mesh():
    return _ACT_MESH.get()


def _current_profile() -> ShardingProfile:
    return _ACT_PROFILE.get() or ShardingProfile()

