"""ATen-op lints (rules J001-J006): the port's counterpart of
``repro.analysis.jaxpr_lints``.

The reference walks the jaxpr of a traced entry.  Eager PyTorch has no
jaxpr, so :class:`OpRecorder`, a ``TorchDispatchMode``, records every ATen
op an entry runs -- its name, the dtypes and devices of its inputs and
outputs, its output bytes -- with the ``file:line`` of the innermost frame
of ``repro_torch/`` outside ``analysis/`` (the analogue of ``_src``), and
:func:`lint_ops` applies J001-J005 to the record.  The entry runs in one of
three modes (``runner.MODES``): CPU tensors through the kernels' plain
versions, ``meta`` tensors through the wrappers' card route under a
``launch.dry_costs.DryCounter`` (dtypes and ops with no data: the port's
``make_jaxpr``; a host read raises there), or the card itself.

The kernels' plain versions (``kernels/ref.py``, and
``core/quant.py``'s ``*_ref``) stand in for CUDA kernels that the
recorder never sees into: in particular their f64 sums of int8 products
are the port's int32-accumulate epilogue, CUDA having no integer matmul.
So an op run inside a plain version is booked under its kernel's name
(:attr:`OpRecorder.kernels`) and is not linted.
"""
from __future__ import annotations

import dataclasses
import os
import sys
from collections import Counter
from typing import List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.findings import Finding

# host arrays above this many bytes copied in by an entry are a hazard
CONST_BYTES_THRESHOLD = 64 * 1024

_LOW_FLOATS = {torch.bfloat16, torch.float16}
_INT8S = {torch.int8, torch.uint8}
_WIDE = {torch.float64, torch.complex128}
# products: (position of the two operands)
_PRODUCTS = {"mm": (0, 1), "bmm": (0, 1), "addmm": (1, 2), "baddbmm": (1, 2),
             "addbmm": (1, 2), "_int_mm": (0, 1), "mv": (0, 1), "addmv": (1, 2),
             "dot": (0, 1), "vdot": (0, 1), "convolution": (0, 1),
             "_convolution": (0, 1)}
# ops whose output shape depends on data: a host read of the sizes
_DATA_SHAPED = {"nonzero", "masked_select", "_unique", "_unique2", "unique_dim",
                "unique_consecutive", "unique_dim_consecutive", "repeat_interleave",
                "_local_scalar_dense"}
_PKG = os.sep + "repro_torch" + os.sep
_ANALYSIS = _PKG + "analysis" + os.sep
_PLAIN_FILES = (os.path.join("repro_torch", "kernels", "ref.py"),
                os.path.join("repro_torch", "core", "quant.py"))


@dataclasses.dataclass
class Op:
    name: str
    in_dtypes: Tuple
    out_dtypes: Tuple
    in_devices: Tuple
    out_devices: Tuple
    out_bytes: int
    file: Optional[str]
    line: Optional[int]


def _tensors(tree, out=None) -> list:
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


def _where() -> Tuple[Optional[str], Optional[int], Optional[str]]:
    """(file, line) of the innermost ``repro_torch/`` frame outside
    ``analysis/`` (else the innermost frame outside torch and this
    package), and the kernel whose plain version the op runs in, if any
    (the outermost ``*_ref`` frame: the kernel the caller called)."""
    f = sys._getframe(2)
    repo = user = None
    plain = None
    while f is not None:
        name = f.f_code.co_filename
        if name.endswith(_PLAIN_FILES) and f.f_code.co_name.endswith("_ref"):
            plain = f.f_code.co_name[:-4]  # the outermost: the kernel called
        if repo is None and _PKG in name and _ANALYSIS not in name:
            repo = (name, f.f_lineno)
        if user is None and _PKG not in name and os.sep + "torch" + os.sep not in name \
                and "site-packages" not in name and "<" not in name[:1]:
            user = (name, f.f_lineno)
        f = f.f_back
    file, line = repo or user or (None, None)
    return file, line, plain


class OpRecorder(TorchDispatchMode):
    """Records every ATen op run while it is entered (see the module
    docstring): :attr:`ops` outside the plain versions, :attr:`kernels`
    the ops booked under each plain version's kernel."""

    def __init__(self):
        super().__init__()
        self.ops: List[Op] = []
        self.kernels: Counter = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        file, line, plain = _where()
        name = func._schema.name.split("::")[-1]
        ins = _tensors(args) + _tensors(kwargs)
        if plain is not None:
            self.kernels[plain] += 1
            return func(*args, **kwargs)
        rec = Op(name, tuple(t.dtype for t in ins), (), tuple(t.device.type for t in ins), (),
                 0, file, line)
        self.ops.append(rec)  # before the op runs: a host read of meta raises in it
        out = func(*args, **kwargs)
        outs = _tensors(out)
        rec.out_dtypes = tuple(t.dtype for t in outs)
        rec.out_devices = tuple(t.device.type for t in outs)
        rec.out_bytes = sum(t.numel() * t.element_size() for t in outs)
        return out


def lint_ops(ops: List[Op], context: str = "", device: str = "cpu") -> List[Finding]:
    """Rules J001-J005 over the ops of one entry run on ``device`` (the
    step's: "cpu" for plain, "meta", "cuda")."""
    out: List[Finding] = []
    for op in ops:
        name = op.name
        src = op.in_dtypes[0] if op.in_dtypes else None
        dst = op.out_dtypes[0] if op.out_dtypes else None
        where = dict(file=op.file, line=op.line)
        if name in ("_to_copy", "copy_", "to") and op.in_dtypes:
            src = op.in_dtypes[-1] if name == "copy_" else src
            if src in _INT8S and dst is not None and dst.is_floating_point:
                out.append(Finding(
                    "J001", f"{src} -> {dst} copy: dequantization goes through the int8 "
                            f"GEMM's epilogue (int32 sums, one scaled store), not a stray "
                            f"element cast", context, **where))
        if name in _PRODUCTS and len(op.in_dtypes) >= 2:
            i, j = _PRODUCTS[name]
            lhs, rhs = op.in_dtypes[i], op.in_dtypes[j] if len(op.in_dtypes) > j else None
            if lhs in _INT8S or rhs in _INT8S:
                if dst != torch.int32:
                    out.append(Finding(
                        "J002", f"int8 {name} accumulates into {dst}; packed products "
                                f"keep int32 sums", context, **where))
            elif (lhs in _LOW_FLOATS or rhs in _LOW_FLOATS) and dst in _LOW_FLOATS:
                out.append(Finding(
                    "J002", f"{lhs} x {rhs} {name} stores {dst}: accumulate and store f32 "
                            f"(bmm(..., out_dtype=torch.float32) on the card) and cast "
                            f"the result once", context, **where))
        if name in _DATA_SHAPED:
            out.append(Finding(
                "J003", f"host read '{name}' inside a model entry (a device -> host "
                        f"transfer: its result or its shape comes from the data)",
                context, **where))
        elif name in ("_to_copy", "copy_") and device != "cpu" and op.out_devices \
                and "cpu" in op.out_devices and any(d != "cpu" for d in op.in_devices):
            out.append(Finding(
                "J003", f"device -> host copy '{name}' inside a model entry",
                context, **where))
        if name == "lift_fresh" or (
                name in ("_to_copy", "copy_") and device != "cpu" and op.in_devices
                and op.in_devices[-1 if name == "copy_" else 0] == "cpu"
                and op.out_devices and op.out_devices[0] == device):
            if op.out_bytes > CONST_BYTES_THRESHOLD:
                out.append(Finding(
                    "J004", f"host array of {op.out_bytes} bytes copied to the step's "
                            f"device by '{name}' inside an entry: rebuilt every call, "
                            f"and a captured decode graph replays it stale -- pass it "
                            f"as an argument", context, **where))
        wide = [d for d in op.out_dtypes if d in _WIDE]
        if wide:
            out.append(Finding(
                "J005", f"{wide[0]} value produced by '{name}' inside a served entry",
                context, **where))
    return out


def check_logits_dtype(logits, context: str = "") -> List[Finding]:
    """Rule J006: serving logits must reach the sampler in f32."""
    dt = getattr(logits, "dtype", torch.float32)
    if dt != torch.float32:
        return [Finding(
            "J006",
            f"model entry returns logits in {dt}; the sampler's f32 upcast then "
            f"operates on quantized values (argmax ties / top-k tails resolve "
            f"wrong) -- request f32 from the logits GEMM epilogue", context)]
    return []
