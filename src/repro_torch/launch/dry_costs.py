"""What a step costs, counted on meta tensors: the dry run's counter (the
port's counterpart of the reference's ``compiled.cost_analysis()`` and
``memory_analysis()``, which read XLA's compile artifacts).

:class:`DryCounter` is a ``TorchDispatchMode`` under which the port's own
step functions run on ``meta`` tensors (shapes and dtypes, no data, no
allocation), eagerly and unfused, as the card runs them:

- **FLOPs**: each ATen op by ``torch.utils.flop_counter``'s formulas (the
  products: ``mm``, ``bmm``, convolutions, ...), plus each kernel call's
  report (``kernels.dry.report``: the wrappers' CUDA route reports in place
  of the launch);
- **bytes**: each ATen op's input and output bytes (a view, an allocation
  and an op that only writes count what they move: nothing, nothing, the
  output; an indexed read or write counts the rows it touches), plus the
  kernels' reports (operands read once, output written once);
- **memory**: live storage bytes, each storage once (views share it),
  followed through weak references, so a tensor autograd saves stays
  counted while the graph holds it and goes when the backward frees it;
  the arguments' bytes, the outputs' and the peak;
- **scopes**: the bytes of the ATen ops run inside a
  ``kernels.dry.scoped`` region (the plain attention's core, ``attn_core``)
  and of the backward ops of the autograd nodes that region recorded.

The kernels' calls are counted by name in :attr:`DryCounter.kernel_calls`;
their ``.launches`` do not move.  A host read of a meta tensor (``.item()``,
a shape that depends on data) raises: the train, prefill and decode paths
have none.  Collectives are counted by the mesh (``launch.mesh.DryMesh``).
"""
from __future__ import annotations

import weakref
from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import dry

# ATen ops that move no bytes: allocations and aliases (views are known by
# their schema, ``OpOverload.is_view``)
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided",
               "_unsafe_view", "alias", "detach", "lift_fresh", "set_"}
# ATen ops that only write their output (a tensor input gives a shape)
_WRITE_ONLY = {"zero_", "fill_", "zeros_like", "ones_like", "full_like", "new_zeros",
               "new_ones", "new_full", "rand_like", "randn_like", "normal_", "uniform_"}
# indexed writes: (position of the values written) -- the values and the
# indices read, the values' rows written, not the whole destination
_SCATTER = {"index_put_": 2, "index_put": 2, "_index_put_impl_": 2, "index_copy_": 3,
            "index_copy": 3, "index_add_": 3, "index_add": 3, "scatter_": 3, "scatter": 3,
            "scatter_add_": 3, "scatter_add": 3}
# indexed reads: the output's rows read and written, and the indices
_GATHER = {"index", "index_select", "gather", "embedding", "take_along_dim"}


def _tensors(tree, out=None) -> list:
    """The tensors of an op's arguments or results (nested tuples, lists
    and dicts), in order."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            _tensors(v, out)
    elif isinstance(tree, dict):
        for v in tree.values():
            _tensors(v, out)
    return out


def _op_bytes(name: str, args, ins: list, outs: list) -> int:
    """The bytes one eager ATen op ``name`` must move."""
    if name in _NO_TRAFFIC:
        return 0
    if name in _WRITE_ONLY:
        return sum(t.nbytes for t in outs)
    if name in _SCATTER:
        vals = args[_SCATTER[name]] if len(args) > _SCATTER[name] else None
        idx = [t for t in ins if t.dtype in (torch.int64, torch.int32, torch.bool)]
        n = vals.nbytes if isinstance(vals, torch.Tensor) else idx[-1].numel() * outs[0].itemsize
        return 2 * n + sum(t.nbytes for t in idx)
    if name in _GATHER:
        idx = [t for t in ins[1:] if t.dtype in (torch.int64, torch.int32, torch.bool)]
        return 2 * sum(t.nbytes for t in outs) + sum(t.nbytes for t in idx)
    if name == "copy_":
        return 2 * outs[0].nbytes
    return sum(t.nbytes for t in ins) + sum(t.nbytes for t in outs)


class DryCounter(TorchDispatchMode):
    """Counts a step run on meta tensors (see the module docstring).  Used
    as a context; while it is entered the kernel wrappers take meta tensors
    (``kernels.dry.COUNTER``)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        #: kernel calls by wrapper name
        self.kernel_calls: Counter = Counter()
        #: ATen bytes booked under each scope name
        self.scope_bytes: Counter = Counter()
        self.live = 0
        self.peak = 0
        self.argument_bytes = 0
        self.output_bytes = 0
        self.alias_bytes = 0
        self._sizes: dict[int, int] = {}  # id(storage) -> nbytes, live storages
        self._arg_keys: set = set()
        self._scope = None
        self._scratch = (None, None)

    def __enter__(self):
        self._token = dry.COUNTER.set(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            dry.COUNTER.reset(self._token)

    # -- memory --------------------------------------------------------------

    def track(self, *tensors) -> int:
        """Count the storages of ``tensors`` not yet counted as live until
        they die; returns the bytes newly counted."""
        new = 0
        for t in tensors:
            st = t.untyped_storage()
            key = id(st)
            if key in self._sizes:
                continue
            n = st.nbytes()
            self._sizes[key] = n
            weakref.finalize(st, self._free, key).atexit = False
            new += n
        if new:
            self.live += new
            self.peak = max(self.peak, self.live)
        return new

    def _free(self, key: int):
        self.live -= self._sizes.pop(key)

    def arguments(self, tree):
        """Count ``tree``'s tensors as the step's arguments (before it runs)."""
        ts = _tensors(tree)
        self.argument_bytes += self.track(*ts)
        self._arg_keys.update(id(t.untyped_storage()) for t in ts)

    def outputs(self, tree):
        """Record the step's outputs: their bytes, and those that are an
        argument's storage (written in place: decode's caches)."""
        seen = {id(t.untyped_storage()): t.untyped_storage().nbytes() for t in _tensors(tree)}
        self.output_bytes = sum(seen.values())
        self.alias_bytes = sum(n for k, n in seen.items() if k in self._arg_keys)

    def memory(self) -> dict:
        """The reference's ``memory_analysis`` record: ``temp_bytes`` is the
        peak less the arguments (the outputs among them); ``alias_bytes``
        the outputs that are arguments' storages, counted in both."""
        return {"argument_bytes": self.argument_bytes, "output_bytes": self.output_bytes,
                "temp_bytes": self.peak - self.argument_bytes, "alias_bytes": self.alias_bytes,
                "peak_per_device_gib": round(self.peak / 2 ** 30, 3)}

    # -- the kernels' side door (kernels.dry) ---------------------------------

    def kernel(self, name: str, flops: float, nbytes: float, outputs=()):
        self.kernel_calls[name] += 1
        self.flops += flops
        self.bytes += nbytes
        self.track(*outputs)

    def scratch(self, n_part: int, n_tickets: int):
        part, tickets = self._scratch
        if part is None or part.numel() < n_part:
            part = torch.empty(max(n_part, 1), dtype=torch.float32, device="meta")
        if tickets is None or tickets.numel() < n_tickets:
            tickets = torch.empty(max(n_tickets, 1), dtype=torch.int32, device="meta")
        self._scratch = (part, tickets)
        self.track(part, tickets)
        return part, tickets

    def scoped(self, name: str, fn, *args, **kwargs):
        prev, self._scope = self._scope, name
        try:
            out = fn(*args, **kwargs)
        finally:
            self._scope = prev
        if isinstance(out, torch.Tensor) and out.grad_fn is not None:
            self._tag(out.grad_fn, args, name)
        return out

    @staticmethod
    def _tag(root, inputs, name: str):
        """Mark the autograd nodes between ``root`` and the nodes of
        ``inputs`` with ``name``: their backward ops are the region's."""
        stop = {t.grad_fn for t in inputs if isinstance(t, torch.Tensor)
                and t.grad_fn is not None}
        todo, seen = [root], set()
        while todo:
            node = todo.pop()
            if node is None or node in stop or node in seen \
                    or type(node).__name__ == "AccumulateGrad":
                continue
            seen.add(node)
            node.metadata["dry_scope"] = name
            todo.extend(n for n, _ in node.next_functions)

    # -- ATen ops ------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        self.track(*outs)
        if func.namespace != "aten":  # the registered GEMM: its wrapper reported it
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            # a product's ``out_dtype`` overload: the formula takes the operands
            fargs = args[:2] if func._overloadname == "dtype" else args
            self.flops += flop_registry[packet](*fargs, **kwargs, out_val=out)
        n = 0 if func.is_view else _op_bytes(packet.__name__, args,
                                              _tensors((args, kwargs)), outs)
        self.bytes += n
        scope = self._scope
        if scope is None:
            node = torch._C._current_autograd_node()
            scope = node.metadata.get("dry_scope") if node is not None else None
        if scope is not None:
            self.scope_bytes[scope] += n
        return out
