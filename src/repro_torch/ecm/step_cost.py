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

The peak is a maximum over time, not a sum, so ``combine`` does not
extrapolate it linearly. The counter keeps it per phase of the step:
the forward (everything before autograd's first backward op), the
backward (ops inside autograd's graph task, a checkpoint's recompute
included) and what follows it (the optimizer); a step without a
backward is one forward. Of each phase's live set it keeps the part
that stacks with depth: the storages that were made before the phase
or outlive it (the layer inputs remat keeps to the backward, a
prefill's caches, the gradients, the optimizer's new state), at the
phase's peak and at its largest (the top of the stack), and the live
set at that top. ``combine`` extrapolates each stacked set linearly and
adds the transients on top of it, three ways:

  * top: the top of the stack, with the largest transient a trace
    shows there. That moment exists at any depth: a lower bound;
  * any: the top with the most any trace's peak rises above its own:
    every transient as if it sat on the whole stack. A training
    forward's and backward's worst transients are a layer's, which the
    deepest layers set on top of (nearly) the whole stack, so this is
    their estimate, whichever layer kind each trace peaks in (a cut
    ending in a Mamba2 layer, another in the shared attention block);
  * matched: the stacked set at the peak, with the largest transient
    there, exact where every trace peaks at the same moment. An
    optimizer's worst leaf, or a prefill's embedding, may come before
    the stack has grown, where the any estimate would set it on top;
    there the matched estimate, held between the other two, is the
    phase's peak.
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

# ops whose kernels make a temporary this mode cannot see (their inner
# calls run below it), in bytes of their first input: logsumexp's
# exp(x - max) (on the card a [tokens, vocab] f32 buffer at the loss)
_HIDDEN_TEMPS = {"logsumexp": 1}

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
    # the largest live set of each phase (forward, backward, after it),
    # and (stacked at its peak, stacked at most, live there) (docstring)
    phase_peaks: dict = field(default_factory=dict)
    phase_stacked: dict = field(default_factory=dict)
    # (op, local shape, dtype, bytes) live at the peak, when recorded
    peak_tensors: list = field(default_factory=list)
    # the same of every storage the step made, when recorded
    made_tensors: list = field(default_factory=list)
    warnings: list = field(default_factory=list)

    _SCALARS = ("flops", "dot_flops", "elementwise_flops", "bytes_accessed",
                "weighted_collective_bytes", "end_bytes")
    _DICTS = ("collective_bytes", "collective_count", "axis_bytes",
              "kernel_calls")

    @staticmethod
    def combine(terms) -> "StepCost":
        """sum of coef * cost over ``terms`` ((coef, StepCost) pairs),
        field by field: a linear extrapolation of traces; the peak by
        ``extrapolate_peak``."""
        terms = list(terms)
        out = StepCost()
        out.peak_bytes, out.phase_peaks = StepCost.extrapolate_peak(terms)
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

    @staticmethod
    def extrapolate_peak(terms) -> tuple:
        """(peak, phase peaks) of the step the traces in ``terms`` span
        (module docstring): a training forward's and backward's any
        estimate; elsewhere the matched one held between top and any."""
        costs = [c for _, c in terms]
        trained = all("backward" in c.phase_stacked for c in costs)
        peaks = {}
        for p in (p for p in PHASES if all(p in c.phase_stacked
                                           for c in costs)):
            def lin(i):
                return sum(coef * c.phase_stacked[p][i] for coef, c in terms)
            at_top = lin(1) + max(c.phase_stacked[p][2]
                                  - c.phase_stacked[p][1] for c in costs)
            any_ = lin(1) + max(c.phase_peaks[p] - c.phase_stacked[p][1]
                                for c in costs)
            matched = lin(0) + max(c.phase_peaks[p] - c.phase_stacked[p][0]
                                   for c in costs)
            peaks[p] = any_ if trained and p != "after" else \
                min(max(matched, at_top), any_)
        return max(peaks.values(), default=0.0), peaks


PHASES = ("forward", "backward", "after")


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
    loops into one counted iteration. ``record`` keeps each storage's
    op, shape and dtype, and ``finish`` lists those live at the peak and
    all of them."""

    def __init__(self, groups: dict | None = None, *,
                 extrapolate: bool = False, record: bool = False):
        super().__init__()
        self.groups = dict(groups or {})
        self.extrapolate = extrapolate
        self.cost = StepCost()
        self._weights = [1.0]
        self._hidden = 0
        self._live = 0
        self._storages: dict = {}
        self._patched: list = []
        self._phase = "forward"
        self._clock = 0                  # allocations and frees so far
        self._peak_clock: dict = {}      # phase -> clock at its peak
        self._start = {"forward": 0}     # phase -> clock it began at
        self._last_op: dict = {}         # phase -> clock after its last op
        self._record = record
        # (key, born) -> [bytes, born, died, (op, shape, dtype) or None]
        self._lifetimes: dict = {}

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
        self._enter_phase()
        out = func(*args, **kwargs)
        if not self._hidden:
            self._count(func, args, kwargs, out)
            if not any(r.alias_info is not None
                       for r in func._schema.returns):
                self._track(out, func)  # views, in-place ops allocate none
        self._last_op[self._phase] = self._clock
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
        if base in _HIDDEN_TEMPS:
            self._note_peak(self._live + sum(_nbytes(t) for t in outs)
                            + _HIDDEN_TEMPS[base] * _nbytes(ins[0]))

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
        self._note_peak(self._live + made + scratch)

    # -- the live set -------------------------------------------------------
    @property
    def live_bytes(self) -> float:
        return self._live

    def _enter_phase(self) -> None:
        """Move to the backward phase at autograd's first backward op,
        and to the phase after it at each op outside the backward that
        follows one inside; ops outside it between two backward ops (a
        collective's wait) count as the backward's."""
        in_backward = torch._C._current_graph_task_id() != -1
        peaks = self.cost.phase_peaks
        if in_backward and self._phase != "backward":
            self._start.setdefault("backward", self._clock)
            if self._phase == "after":
                del self._start["after"]
                after = peaks.pop("after")
                if after > peaks["backward"]:
                    peaks["backward"] = after
                    self._peak_clock["backward"] = self._peak_clock["after"]
            self._phase = "backward"
        elif not in_backward and self._phase == "backward":
            self._start["after"] = self._clock
            self._phase = "after"
        self._note_peak(self._live)

    def _note_peak(self, live: float) -> None:
        c = self.cost
        if live > c.peak_bytes:
            c.peak_bytes = live
            self._peak_clock["step"] = self._clock
        if live > c.phase_peaks.get(self._phase, -1.0):
            c.phase_peaks[self._phase] = live
            self._peak_clock[self._phase] = self._clock

    def _stacked(self, start: int, end: int, peak_t: int) -> tuple:
        """Of the storages live between the clocks ``start`` and ``end``,
        those made before ``start`` or outliving ``end``: their bytes at
        ``peak_t``, at their largest, and every storage's bytes there."""
        import numpy as np
        lts = list(self._lifetimes.values())
        never = self._clock + 2
        n = np.array([lt[0] for lt in lts], dtype=np.float64)
        born = np.array([lt[1] for lt in lts], dtype=np.int64)
        died = np.array([never if lt[2] is None else lt[2] for lt in lts],
                        dtype=np.int64)

        def curve(mask):                 # bytes live at t: born < t <= died
            d = np.zeros(never + 2)
            np.add.at(d, born[mask] + 1, n[mask])
            np.add.at(d, died[mask] + 1, -n[mask])
            return np.cumsum(d)
        live = curve(np.ones(len(lts), dtype=bool))
        stacked = curve((born < start) | (died >= end))
        window = np.arange(start + 1, max(end, start + 1) + 1)
        top = window[np.lexsort((live[window], stacked[window]))[-1]]
        return (float(stacked[peak_t]), float(stacked[top]),
                float(live[top]))

    def finish(self) -> None:
        """Close the step: its end set, and each phase's stacked part:
        the storages live in it that were made before it began or
        outlive its last op (what the phase frees only as it returns,
        the backward's gradient buffers, the optimizer's clipped
        gradients, stacks too)."""
        c = self.cost
        c.end_bytes = float(self._live)
        for p, start in self._start.items():
            if p in c.phase_peaks:
                c.phase_stacked[p] = self._stacked(
                    start, self._last_op.get(p, start), self._peak_clock[p])
        if self._record:
            t = self._peak_clock.get("step", 0)
            c.peak_tensors = sorted(
                [meta + (n,) for n, born, died, meta in
                 self._lifetimes.values()
                 if born < t and (died is None or died >= t)],
                key=lambda r: -r[3])
            c.made_tensors = [meta + (n,) for n, _, _, meta in
                              self._lifetimes.values()]

    def _track(self, out, func=None) -> None:
        for t in _tensors(out):
            try:
                st = t.untyped_storage()
            except (RuntimeError, NotImplementedError):
                continue
            key = id(st)
            if key in self._storages:
                continue
            # a collective's output is a buffer of its own on the card;
            # a fake one may view a larger one (shard_dim_alltoall's
            # fake chunks the whole gathered tensor)
            n = _nbytes(t) if _base(func) in _COLLECTIVES else st.nbytes()
            try:
                weakref.finalize(st, self._free, key, n)
            except TypeError:
                continue
            self._storages[key] = (n, self._clock)
            self._lifetimes[(key, self._clock)] = [
                n, self._clock, None,
                (_base(func), tuple(t.shape), str(t.dtype))
                if self._record else None]
            self._clock += 1
            self._live += n
            self._note_peak(self._live)

    def _free(self, key, n) -> None:
        entry = self._storages.pop(key, None)
        if entry is not None:
            self._live -= n
            self._lifetimes[(key, entry[1])][2] = self._clock
            self._clock += 1

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
