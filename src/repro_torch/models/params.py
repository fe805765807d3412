"""Parameter declaration (port of ``repro.models.params``).

Models declare their parameters once as a nested dict of :class:`ParamSpec`
(shape + logical axes + init kind).  :func:`init_params` materializes it
with the JAX package's init rules from an explicit ``torch.Generator``.
The port cannot reproduce ``jax.random``'s numbers, so a parity test never
initialises its weights here: it loads the JAX tree through
``repro_torch.models.bridge``.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch


class ParamSpec(NamedTuple):
    shape: tuple
    axes: tuple  # logical axis name (or None) per dim
    init: str = "scaled"  # scaled | normal | zeros | ones | ssm_a | dt_bias
    dtype: Any = None  # None -> the default dtype init_params is given

    def stacked(self, n: int, axis_name: str = "layers") -> "ParamSpec":
        return ParamSpec((n,) + tuple(self.shape), (axis_name,) + tuple(self.axes),
                         self.init, self.dtype)


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def tree_map_specs(fn, tree):
    """Apply ``fn`` to every ParamSpec leaf of nested dicts/lists."""
    if is_spec(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map_specs(fn, v) for v in tree]
    raise TypeError(f"unexpected node {type(tree)!r} in a spec tree")


def stack_tree(spec_tree, n: int, axis_name: str = "layers"):
    return tree_map_specs(lambda s: s.stacked(n, axis_name), spec_tree)


def count_params(spec_tree) -> int:
    total = 0

    def add(s):
        nonlocal total
        total += math.prod(s.shape)
        return s

    tree_map_specs(add, spec_tree)
    return total


#: leaves with more elements than this are drawn in slices along their
#: leading axis straight into the finished tensor: one f32 draw of full
#: qwen3-moe-30b-a3b's expert stack [48, 128, 2048, 768] and its scaled
#: copy would take 2 x 38.7 GB before the cast
MAX_DRAW = 2 ** 30


_LN2 = 0.6931471805599453


def _log(u):
    """``log(u)`` for positive f32 ``u``, in f64 additions, products and
    quotients only, rounded once to f32: ``e ln 2 + 2 atanh(s)`` with ``u =
    m 2^e``, ``m`` in [0.5, 1), ``s = (m - 1) / (m + 1)`` in [-1/3, 0), the
    series to 24 terms (|s|^49 < 2^-77).  Every step is one exactly rounded
    IEEE operation, so the bits depend on ``u`` alone: not on the thread
    count, the buffer or which vectorised or scalar path a library's ``log``
    takes for an element."""
    m, e = torch.frexp(u.double())
    s = (m - 1.0) / (m + 1.0)
    s2 = s * s
    acc = torch.full_like(s, 1.0 / 47.0)
    for k in range(45, 0, -2):
        acc = acc * s2 + 1.0 / k
    return (e.double() * _LN2 + 2.0 * s * acc).float()


def _expm1(u):
    """``exp(u) - 1`` for f32 ``u`` in [0, 0.1], as :func:`_log`: the Taylor
    series to 16 terms in f64 (0.1^17 / 17! < 2^-110), rounded once to f32."""
    x = u.double()
    acc = torch.full_like(x, 1.0)
    for k in range(16, 1, -1):
        acc = acc * x / k + 1.0
    return (x * acc).float()


def _init_leaf(spec: ParamSpec, gen: torch.Generator, default_dtype, device):
    dtype = spec.dtype or default_dtype
    shape = tuple(int(s) for s in spec.shape)
    if spec.init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if spec.init in ("ssm_a", "dt_bias"):
        lo, hi = (1.0, 16.0) if spec.init == "ssm_a" else (1e-3, 1e-1)
        u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
        u = u * (hi - lo) + lo
        # A_log ~ log U[1, 16]; dt_bias = inverse softplus of U[1e-3, 1e-1]
        return (_log(u) if spec.init == "ssm_a" else _log(_expm1(u))).to(dtype)
    if spec.init == "normal":
        std = 0.02
    elif spec.init == "scaled":
        # std 1/sqrt(fan_in), fan_in = product of all dims but the last
        # (stacked axes included, as the reference)
        std = 1.0 / math.sqrt(max(1, math.prod(shape[:-1])))
    else:
        raise NotImplementedError(f"init {spec.init!r} is not ported")
    if math.prod(shape) <= MAX_DRAW or len(shape) < 2:
        x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
        return (x * std).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=device)
    step = max(1, MAX_DRAW // math.prod(shape[1:]))
    for i in range(0, shape[0], step):
        n = min(step, shape[0] - i)
        out[i: i + n] = torch.randn((n, *shape[1:]), generator=gen, dtype=torch.float32,
                                    device=device).mul_(std)
    return out


def init_params(spec_tree, generator: torch.Generator, default_dtype=torch.float32):
    """Materialize a spec tree on the generator's device.  Leaves are drawn
    in sorted-key order, so a seed fixes every tensor; a leaf of more than
    ``MAX_DRAW`` elements is drawn slice by slice along its leading axis,
    with the whole leaf's std."""
    device = generator.device

    def walk(t):
        if is_spec(t):
            return _init_leaf(t, generator, default_dtype, device)
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        return [walk(v) for v in t]

    return walk(spec_tree)
