"""Logical-axis -> mesh partitioning rules (port of ``repro.launch.sharding``).

Every parameter and cache dimension carries a logical axis name
(``models.params.ParamSpec``); :func:`resolve_pspec` maps those names onto
the mesh exactly as the reference computes it: the tensor-parallel rules,
the graded batch fallback, the divisibility fallback (a 16-way model axis
cannot shard 8 KV heads: replicate) and the FSDP choice.  A partition spec
is a tuple with one entry a dimension: a mesh axis name, a tuple of them,
or None (the reference's ``PartitionSpec`` entries).

In the port a spec says which slice of a leaf a rank *holds*
(:func:`local_slice`, :func:`local_shape`; :func:`gather_whole` joins the
slices again); there is no partitioner, so there is no counterpart of the
reference's ``constrain`` (a hint to XLA's sharding propagation) and no
``NamedSharding``.  :func:`moment_pspecs` places AdamW's moments as the
reference's ``moment_pspecs`` / ``qtensor_pspecs`` do, :func:`fsdp_dims`
says which dims of a held leaf a layer gathers before it computes, and
:func:`batch_entry` how a batch splits over the ranks.
:func:`activation_mesh` / :func:`current_mesh` carry the mesh (and a train
step's batch split) to the model code, as the reference's trace-time
context does, here at call time.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses as _dc

from repro_torch.core.quant import QTensor
from repro_torch.core.tree import tree_map
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


def spec_axes(pspec: tuple, dims=None) -> tuple:
    """The mesh axes that cut any of ``dims`` (default every dim) under
    ``pspec``, in dim order."""
    return tuple(a for d in sliced_dims(pspec or ()) if dims is None or d in dims
                 for a in _entry_axes(pspec[d]))


def _shards(mesh, entry) -> tuple[int, int]:
    """(shard count, this rank's shard) of a dimension split over the mesh
    axes of ``entry``, major to minor, as JAX lays a multi-axis entry."""
    n, i = 1, 0
    if entry is None:
        return n, i
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


def gather_whole(x, mesh, pspec: tuple):
    """The whole tensor of which ``x`` is this rank's slice under ``pspec``
    (every rank calls it; a plain collective, not differentiable)."""
    for d in sliced_dims(pspec):
        x = mesh.all_gather(x, _entry_axes(pspec[d]), d)
    return x


def fsdp_dims(pspec: tuple, profile: ShardingProfile) -> list[tuple[int, tuple]]:
    """(dim, axes) of every FSDP entry of a held leaf's spec: an entry whose
    axes are all FSDP axes of ``profile`` (``data`` under "2d", where
    ``model`` is the tensor-parallel axis; ``data`` and ``model`` under
    "fsdp")."""
    return [(d, _entry_axes(pspec[d])) for d in sliced_dims(pspec)
            if set(_entry_axes(pspec[d])) <= set(profile.fsdp_axes)]


def moment_pspecs(param_pspecs, kind: str = "f32"):
    """Specs of AdamW's moments: each moment follows its parameter's spec;
    an int8 moment is a ``QTensor`` whose values follow it and whose scale
    (``quantize(x, axis=-1)``: [1, ..., 1, N] for a leaf [..., N], one scale
    an element for a vector) keeps only the last dim's entry -- the dims its
    max reduces over are size 1 in the scale, so no shard cuts them there.
    (The reference's ``qtensor_pspecs`` keeps the other entries and drops
    the last, for its dry-run ``[..., 1]`` scales, which its update does
    not make: ROADMAP Queue 3.)"""
    def conv(ps):
        if kind != "int8":
            return ps
        scale = ps if len(ps) <= 1 else (None,) * (len(ps) - 1) + (ps[-1],)
        return QTensor(ps, scale)
    return tree_map(conv, param_pspecs)


def batch_entry(mesh, batch: int, profile: ShardingProfile | None = None):
    """The mesh axes (a tuple, major to minor; empty: replicated) that a
    batch of ``batch`` rows splits over: ``resolve_pspec``'s ``batch``
    entry, pod-major, its graded fallback included."""
    ps = resolve_pspec(ParamSpec((batch,), ("batch",)), mesh, profile=profile)
    return () if ps[0] is None else _entry_axes(ps[0])


def batch_rows(mesh, batch: int, profile: ShardingProfile | None = None) -> slice:
    """This rank's rows of a batch of ``batch`` rows (:func:`batch_entry`)."""
    n, i = _shards(mesh, batch_entry(mesh, batch, profile) or None)
    return slice(i * (batch // n), (i + 1) * (batch // n))


def tp_size(mesh=None) -> int:
    """Size of the tensor-parallel (`model`) axis; 1 when no mesh is active
    or the current profile has no tensor parallelism (``"fsdp"``, where the
    model axis carries batch and FSDP shards instead)."""
    mesh = mesh if mesh is not None else _ACT_MESH.get()
    if mesh is None or "model" not in _current_profile().tp_rules.values():
        return 1
    return dict(mesh.shape).get("model", 1)


_ACT_MESH: contextvars.ContextVar = contextvars.ContextVar("act_mesh", default=None)
_ACT_PROFILE: contextvars.ContextVar = contextvars.ContextVar("act_profile",
                                                              default=None)
_ACT_BATCH: contextvars.ContextVar = contextvars.ContextVar("act_batch", default=())


@contextlib.contextmanager
def activation_mesh(mesh, profile: ShardingProfile | None = None, batch_axes: tuple = ()):
    """Run the model code inside with ``mesh`` current: each layer then
    computes this rank's shard and issues the collectives that join them.
    ``batch_axes``: the axes a train step's batch is split over
    (:func:`batch_entry`), whose ranks each hold their own rows; statistics
    over the whole batch (the MoE aux) are averaged over them."""
    tok = _ACT_MESH.set(mesh)
    tok2 = _ACT_PROFILE.set(profile)
    tok3 = _ACT_BATCH.set(tuple(batch_axes))
    try:
        yield
    finally:
        _ACT_MESH.reset(tok)
        _ACT_PROFILE.reset(tok2)
        _ACT_BATCH.reset(tok3)


def current_mesh():
    return _ACT_MESH.get()


def activation_context() -> tuple:
    """The (mesh, profile, batch axes) :func:`activation_mesh` set, to be
    set again with it where the code runs on another thread: a checkpointed
    layer group's recompute runs inside the backward pass, on the autograd
    engine's thread for a CUDA device, which does not see these context
    variables."""
    return _ACT_MESH.get(), _ACT_PROFILE.get(), _ACT_BATCH.get()


def current_batch_axes() -> tuple:
    return _ACT_BATCH.get()


def _current_profile() -> ShardingProfile:
    return _ACT_PROFILE.get() or ShardingProfile()

