"""Per-device counts of one traced step: flops, bytes, collectives and
the live set (the role of ``repro.ecm.hlo_cost``).

``StepCounter`` is a ``TorchDispatchMode`` run around one step on fake
tensors. DTensor ops are let through (the mode declines them), so it sees
what each device runs: the local aten ops, the collectives DTensor's
redistributions issue, and the card kernels' operators
(``repro_torch::<name>``, ``kernels.traced``), all on local shapes. The
rules are
``hlo_cost``'s:

  * dot flops = 2 |out| K (``mm``, ``bmm``, ``addmm``, ``baddbmm`` and
    their ``out_dtype`` forms);
  * elementwise flops = |out| for arithmetic ops, |in| for reductions;
  * bytes = operand + result bytes of every op that materialises a
    buffer (views and fresh allocations move nothing; a gather reads
    what it gathers, an indexed write writes what it writes);
  * collective bytes weighted by a ring factor over the group's size n:
    all-reduce 2(n-1)/n b; all-gather (its output), reduce-scatter and
    all-to-all (n-1)/n b; a permute 1 b;
  * a kernel operator's call by the kernel's own counts, read by its
    name (``traced.price``); its scratch is live beside its outputs.

Every count is per device; replicated work counts in full on each.
Ops that DTensor runs to propagate shapes (global-shaped fakes) are not
the device's and are skipped.

Loops the port unrolls in Python repeat one body. ``trips(n)`` marks such
a loop: under a counter built with ``extrapolate=True``, and while
autograd records nothing, it runs the body once and counts it n times
(``fill`` pads what the skipped iterations would have made). The layers
are extrapolated by the dry run from traces at two or three depths.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import traced

_ACTIVE: list = []         # the counters entered, innermost last
_DEVICE = torch.ops.prim.device.default

_DOTS = {"mm", "bmm", "addmm", "baddbmm", "_scaled_mm"}

_ELEMENTWISE = {
    "add", "sub", "mul", "div", "neg", "abs", "exp", "exp2", "expm1", "log",
    "log1p", "log2", "rsqrt", "sqrt", "tanh", "sigmoid", "silu", "gelu",
    "relu", "pow", "maximum", "minimum", "where", "clamp", "clamp_min",
    "clamp_max", "eq", "ne", "lt", "le", "gt", "ge", "logical_and",
    "logical_or", "logical_not", "bitwise_and", "bitwise_or", "bitwise_not",
    "bitwise_xor", "erf", "sin", "cos", "remainder", "floor", "ceil",
    "round", "sign", "reciprocal", "square", "fmod", "floor_divide",
    "masked_fill", "lerp", "addcmul", "addcdiv", "softplus", "rsub",
    "silu_backward", "gelu_backward", "sigmoid_backward", "tanh_backward",
    "threshold_backward", "isnan", "isinf", "atan2", "trunc",
}

_REDUCTIONS = {
    "sum", "mean", "amax", "amin", "max", "min", "prod", "logsumexp",
    "_softmax", "_log_softmax", "_softmax_backward_data",
    "_log_softmax_backward_data", "cumsum", "var", "var_mean", "std",
    "norm", "linalg_vector_norm", "argmax", "argmin", "any", "all",
    "topk", "sort",
}

# allocations and metadata: no bytes move
_NO_BYTES = {
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "detach", "alias", "lift_fresh", "_to_local",
    "_local_scalar_dense", "resize_", "set_",
}

# gathers read what they gather; indexed writes write what they write
_GATHERS = {"index", "index_select", "gather", "embedding"}
_SCATTERS = {"index_put", "index_put_", "_index_put_impl_", "index_copy",
             "index_copy_", "scatter", "scatter_", "scatter_add",
             "scatter_add_", "index_add", "index_add_", "_unsafe_index_put",
             "masked_scatter", "masked_scatter_"}

# c10d functional op -> (kind, ring factor, volume from the output)
_COLLECTIVES = {
    "all_reduce": ("all-reduce", 2.0, False),
    "all_reduce_coalesced": ("all-reduce", 2.0, False),
    "all_gather_into_tensor": ("all-gather", 1.0, True),
    "all_gather_into_tensor_coalesced": ("all-gather", 1.0, True),
    "reduce_scatter_tensor": ("reduce-scatter", 1.0, False),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", 1.0, False),
    "all_to_all_single": ("all-to-all", 1.0, False),
    "shard_dim_alltoall": ("all-to-all", 1.0, False),
    "broadcast": ("collective-permute", 1.0, False),
}


@dataclass
class StepCost:
    """One step's per-device counts (the fields of ``hlo_cost.HloCost``,
    plus the kernels' calls, the collectives per mesh axis and the peak of
    the live set)."""
    flops: float = 0.0
    dot_flops: float = 0.0
    elementwise_flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_bytes: dict = field(default_factory=dict)   # kind -> raw
    collective_count: dict = field(default_factory=dict)
    weighted_collective_bytes: float = 0.0                 # ring-weighted
    axis_bytes: dict = field(default_factory=dict)   # axis -> ring-weighted
    kernel_calls: dict = field(default_factory=dict)
    peak_bytes: float = 0.0          # the largest live set of the step
    end_bytes: float = 0.0           # the live set the step ends with
    warnings: list = field(default_factory=list)

    _SCALARS = ("flops", "dot_flops", "elementwise_flops", "bytes_accessed",
                "weighted_collective_bytes", "peak_bytes", "end_bytes")
    _DICTS = ("collective_bytes", "collective_count", "axis_bytes",
              "kernel_calls")

    @staticmethod
    def combine(terms) -> "StepCost":
        """sum of coef * cost over ``terms`` ((coef, StepCost) pairs),
        field by field: a linear extrapolation of traces."""
        out = StepCost()
        for coef, c in terms:
            for f in StepCost._SCALARS:
                setattr(out, f, getattr(out, f) + coef * getattr(c, f))
            for f in StepCost._DICTS:
                d = getattr(out, f)
                for k, v in getattr(c, f).items():
                    d[k] = d.get(k, 0.0) + coef * v
            out.warnings += [w for w in c.warnings if w not in out.warnings]
        for f in StepCost._DICTS:
            setattr(out, f, {k: v for k, v in getattr(out, f).items()
                             if v != 0})
        return out


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _base(func) -> str:
    name = func.__name__ if hasattr(func, "__name__") else str(func)
    return name.split(".")[0]


def _is_view(func) -> bool:
    schema = func._schema
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in schema.returns)


def _propagation_hooks():
    """The DTensor sharding propagator's methods that run ops on
    global-shaped fakes (whichever this torch has)."""
    try:
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator
    except ImportError:
        return []
    return [(ShardingPropagator, n) for n in
            ("_propagate_tensor_meta_non_cached", "_propagate_tensor_meta",
             "propagate_op_sharding_non_cached")
            if hasattr(ShardingPropagator, n)]


class StepCounter(TorchDispatchMode):
    """Counts one step's per-device work (module docstring). ``groups``
    maps a process group's name to (mesh axis label, size): the axis a
    collective's bytes are charged to. ``extrapolate`` turns ``trips``
    loops into one counted iteration."""

    def __init__(self, groups: dict | None = None, *,
                 extrapolate: bool = False):
        super().__init__()
        self.groups = dict(groups or {})
        self.extrapolate = extrapolate
        self.cost = StepCost()
        self._weights = [1.0]
        self._hidden = 0
        self._live = 0
        self._storages: dict = {}
        self._patched: list = []

    # -- the mode -----------------------------------------------------------
    def __enter__(self):
        for owner, name in _propagation_hooks():
            orig = getattr(owner, name)
            self._patched.append((owner, name, orig))

            def hidden(*a, _orig=orig, **k):
                self._hidden += 1
                try:
                    return _orig(*a, **k)
                finally:
                    self._hidden -= 1
            setattr(owner, name, hidden)
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _ACTIVE.remove(self)
            for owner, name, orig in reversed(self._patched):
                setattr(owner, name, orig)
            self._patched.clear()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if func is _DEVICE:            # a metadata query, most of the calls
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if not self._hidden:
            self._count(func, args, kwargs, out)
            if not any(r.alias_info is not None
                       for r in func._schema.returns):
                self._track(out)     # views and in-place ops allocate none
        return out

    # -- counting -----------------------------------------------------------
    @property
    def weight(self) -> float:
        return self._weights[-1]

    def _count(self, func, args, kwargs, out) -> None:
        ns = func.namespace if hasattr(func, "namespace") else ""
        base = _base(func)
        w = self.weight
        c = self.cost
        if ns == traced.LIBRARY:
            self._kernel(base, args, out, w)
            return
        if ns in ("_c10d_functional", "_dtensor", "c10d_functional") \
                and base in _COLLECTIVES:
            self._collective(base, args, kwargs, out, w)
            return
        if ns in ("_c10d_functional", "c10d_functional") or \
                base in _NO_BYTES or _is_view(func):
            return
        ins = [t for t in _tensors((args, kwargs))]
        outs = [t for t in _tensors(out)]
        if not outs:
            return
        out_elems = sum(t.numel() for t in outs)
        if base in _DOTS:
            a = args[1] if base in ("addmm", "baddbmm") else args[0]
            f = 2.0 * out_elems * a.shape[-1]
            c.dot_flops += f * w
            c.flops += f * w
        elif base in _ELEMENTWISE or base.rstrip("_") in _ELEMENTWISE:
            c.elementwise_flops += out_elems * w
            c.flops += out_elems * w
        elif base in _REDUCTIONS:
            n = ins[0].numel() if ins else 0
            c.elementwise_flops += n * w
            c.flops += n * w
        if base in _GATHERS:
            nb = 2 * sum(_nbytes(t) for t in outs) + sum(
                _nbytes(t) for t in ins[1:] if not t.is_floating_point())
        elif base in _SCATTERS:
            vals = ins[2] if len(ins) > 2 else ins[-1]
            nb = 2 * _nbytes(vals) + sum(
                _nbytes(t) for t in ins[1:] if not t.is_floating_point())
        elif base.endswith("_") or base == "copy_":
            # in place: the written operand counts once
            nb = sum(_nbytes(t) for t in ins) + _nbytes(ins[0]) \
                if ins else 0
        else:
            nb = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        c.bytes_accessed += nb * w

    def _collective(self, base, args, kwargs, out, w) -> None:
        kind, factor, from_out = _COLLECTIVES[base]
        name = next((a for a in list(args) + list(kwargs.values())
                     if isinstance(a, str) and a in self.groups), None)
        if name is None:
            axis, n = "?", _group_size(args, kwargs)
            warn = f"collective {base} on a group of no mesh axis"
            if warn not in self.cost.warnings:
                self.cost.warnings.append(warn)
        else:
            axis, n = self.groups[name]
        vol = sum(_nbytes(t) for t in (_tensors(out) if from_out
                                        else _tensors(args[:1])))
        frac = 1.0 if kind == "collective-permute" else (
            (n - 1) / n if n > 1 else 0.0)
        c = self.cost
        c.collective_bytes[kind] = c.collective_bytes.get(kind, 0.0) + vol * w
        c.collective_count[kind] = c.collective_count.get(kind, 0) + w
        weighted = vol * factor * frac * w
        c.weighted_collective_bytes += weighted
        c.axis_bytes[axis] = c.axis_bytes.get(axis, 0.0) + weighted
        c.bytes_accessed += 2 * vol * w

    def _kernel(self, name, args, out, w) -> None:
        dot, elementwise, nbytes, scratch = traced.price(name, args)
        c = self.cost
        c.dot_flops += dot * w
        c.elementwise_flops += elementwise * w
        c.flops += (dot + elementwise) * w
        c.bytes_accessed += nbytes * w
        c.kernel_calls[name] = c.kernel_calls.get(name, 0) + w
        made = sum(_nbytes(t) for t in _tensors(out))
        c.peak_bytes = max(c.peak_bytes, self._live + made + scratch)

    # -- the live set -------------------------------------------------------
    @property
    def live_bytes(self) -> float:
        return self._live

    def _track(self, out) -> None:
        for t in _tensors(out):
            try:
                st = t.untyped_storage()
            except (RuntimeError, NotImplementedError):
                continue
            key = id(st)
            if key in self._storages:
                continue
            n = st.nbytes()
            try:
                weakref.finalize(st, self._free, key, n)
            except TypeError:
                continue
            self._storages[key] = n
            self._live += n
            self.cost.peak_bytes = max(self.cost.peak_bytes, self._live)

    def _free(self, key, n) -> None:
        if self._storages.pop(key, None) is not None:
            self._live -= n

    # -- trips --------------------------------------------------------------
    def _trip(self, weight: float):
        self._weights.append(self.weight * weight)
        try:
            yield 0
        finally:
            self._weights.pop()


def _group_size(args, kwargs) -> int:
    """The size of the group a functional collective names."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, str):
            try:
                return _resolve_process_group(a).size()
            except (ValueError, RuntimeError, KeyError):
                continue
    return 1


def active() -> StepCounter | None:
    return _ACTIVE[-1] if _ACTIVE else None


def trips(n: int, *, weight: float | None = None):
    """``range(n)`` for a loop the port unrolls; under an extrapolating
    counter, while autograd records nothing, one iteration counted
    ``weight`` (default n) times."""
    mode = active()
    if mode is None or not mode.extrapolate or n < 1 or \
            torch.is_grad_enabled():
        return range(n)
    return mode._trip(float(n if weight is None else weight))


def fill(items: list, n: int) -> list:
    """``items`` padded to n with fresh tensors like its last: what a
    ``trips`` loop that ran once stands in for (no-op otherwise)."""
    return items + [torch.empty_like(items[-1])
                    for _ in range(n - len(items))]
