"""Op-level cost counter: the port's counterpart of the reference's HLO
analysis (``repro/launch/hlo_analysis.py``).

The port has no compiled module to parse: one step of a cell runs op by
op on the eager plan over tensors on the ``meta`` device (shapes and
dtypes, no storage: full width costs nothing) while a
``TorchDispatchMode`` prices every ATen op it sees with the reference's
conventions (``hlo_analysis.py:46-63``, ``:285-347``):

* a dot is 2·M·N·K, batched (``torch.utils.flop_counter``'s formulas);
* an elementwise op is one flop per output element, a reduction (and a
  scan or sort) one per input element; a softmax counts the five passes
  XLA lowers it to;
* data movement is free: views, reshapes, copies, dtype conversions,
  gathers, scatters, concatenations, pads, factories (the reference's
  ``FREE`` set); so is an op the counter does not know (``count_step``
  lists them);
* bytes are each counted op's operands plus results (a broadcast
  operand counted once), the eager counterpart of XLA's fusion-boundary
  bytes: the eager plan's traffic, far above what the kernel plan moves
  between its stages, so only the FLOPs do not depend on what runs the
  step;
* collectives are zero on one card, under the reference's keys.

Meta tensors rather than ``FakeTensorMode``: the fake mode's per-op
Python layer took the whole dry-run from 27 to 73 s on an 8-core host
for the same counts, and the eager plan needs no device (a kernel
wrapper raises for a meta tensor, so a kernel-plan config is counted as
its eager plan).

The port's layers run in a Python loop, so nothing is counted once where
it runs many times; the counterpart of XLA's ``known_trip_count`` is
what keeps a full-width count fast.  ``count_cell`` counts a cell
without layers and with one and two layers of each kind, and extends
each kind to its layer count; the recurrences' loops (``ref.wkv6`` token
by token, ``wkv6_chunked`` chunk by chunk) are counted at 2, 3 and 4
steps, forward and backward, and extended to every step by forward
differences.  Every count is an integer, so a scaled count equals the
full-depth one exactly (``tests/test_torch_launch_scaling.py``).

``temp_bytes`` is the peak of live storage the counted ops created (the
arguments excluded), scaled the same way; the recurrences' recomputed
graphs (the per-step tensors autograd keeps under remat) are held at
their backward.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import weakref
from typing import Dict, Iterator, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map
from torch.utils.flop_counter import flop_registry

from ..configs.base import ModelConfig, ShapeConfig

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

aten = torch.ops.aten
# Data movement and factories, never priced even where ATen tags them
# pointwise (``_to_copy`` is XLA's ``convert``, ``copy_`` its ``copy``).
FREE = {
    aten._to_copy, aten.copy_, aten.clone, aten.detach, aten.alias,
    aten.lift_fresh, aten.lift_fresh_copy, aten.empty, aten.empty_like,
    aten.empty_strided, aten.new_empty, aten.new_empty_strided, aten.zeros,
    aten.zeros_like, aten.new_zeros, aten.ones, aten.ones_like,
    aten.new_ones, aten.full, aten.full_like, aten.new_full, aten.fill_,
    aten.fill, aten.zero_, aten.scalar_tensor, aten.arange, aten.linspace,
    aten.cat, aten.stack, aten.constant_pad_nd, aten.index, aten.index_put,
    aten.index_put_, aten._unsafe_index_put, aten.index_select,
    aten.gather, aten.scatter, aten.scatter_, aten.embedding,
    aten.embedding_dense_backward, aten.slice_scatter, aten.select_scatter,
    aten.masked_scatter, aten.repeat, aten.flip, aten.roll,
    aten.scatter_add, aten.index_add, aten.select_backward,
    aten.slice_backward, aten._unsafe_view, aten._local_scalar_dense,
}
# Elementwise ops ATen does not tag pointwise (in-place forms, masks of
# a triangle: XLA's ``select`` over an iota compare).
POINTWISE = {aten.masked_fill, aten.masked_fill_, aten.where, aten.tril,
             aten.triu, aten.softplus_backward}
# Ops XLA lowers to several passes over their input (``(name, passes)``):
# softmax = reduce-max, subtract, exponential, reduce-sum, divide.
PASSES = {aten._softmax: 5, aten._log_softmax: 5,
          aten._softmax_backward_data: 4, aten._log_softmax_backward_data: 4}
# Reductions, scans and sorts the tags do not mark: input elements.
BY_INPUT = {aten.cumsum, aten.cumprod, aten.topk, aten.sort, aten.logsumexp,
            aten.max, aten.min, aten.amax, aten.amin, aten.sum, aten.mean,
            aten.prod, aten.var_mean, aten.norm, aten.linalg_vector_norm,
            aten.all, aten.any, aten.argmax, aten.argmin}


def _tensors(tree) -> List[torch.Tensor]:
    """The tensors of nested tuples, lists and dicts (op arguments and
    results, input trees)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        out = []
        for x in tree:
            out.extend(_tensors(x))
        return out
    if isinstance(tree, dict):
        return _tensors(list(tree.values()))
    return []


def span_bytes(t: torch.Tensor) -> int:
    """Bytes a tensor's distinct elements take: a broadcast (stride 0)
    dimension counted once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size()


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def storage_bytes(tree) -> int:
    """Bytes of the distinct storages the tensors of ``tree`` lie on."""
    seen: Dict[int, int] = {}
    for t in _tensors(tree):
        seen[_storage_key(t)] = t.untyped_storage().nbytes()
    return sum(seen.values())


def op_cost(func, args, kwargs, out) -> Optional[Tuple[int, int]]:
    """(flops, bytes) of one ATen op, or None where it is free."""
    packet = func.overloadpacket
    if packet in FREE:
        return None
    flops = None
    if packet in flop_registry:
        flops = int(flop_registry[packet](*args, **kwargs, out_val=out))
    elif packet in PASSES:
        flops = PASSES[packet] * _tensors(args)[0].numel()
    elif packet in BY_INPUT or torch.Tag.reduction in func.tags:
        flops = sum(t.numel() for t in _tensors(args))
    elif packet in POINTWISE or torch.Tag.pointwise in func.tags:
        flops = sum(t.numel() for t in _tensors(out))
    if flops is None:
        return None
    nbytes = sum(span_bytes(t) for t in _tensors((args, kwargs)))
    nbytes += sum(span_bytes(t) for t in _tensors(out))
    return flops, nbytes


@dataclasses.dataclass
class OpCount:
    """Integer cost totals; ``by_op`` maps (op, result shapes) to [calls,
    flops, bytes].  ``temp_bytes`` is a peak, the rest are sums."""
    flops: int = 0
    bytes: int = 0
    num_ops: int = 0
    temp_bytes: int = 0
    by_op: Dict[Tuple[str, str], List[int]] = dataclasses.field(
        default_factory=dict)

    def record(self, name: str, shapes: str, flops: int, nbytes: int):
        self.flops += flops
        self.bytes += nbytes
        self.num_ops += 1
        row = self.by_op.setdefault((name, shapes), [0, 0, 0])
        row[0] += 1
        row[1] += flops
        row[2] += nbytes

    def axpy(self, other: "OpCount", factor: int = 1) -> None:
        """self += factor * other (sums and the op table; not the peak)."""
        self.flops += factor * other.flops
        self.bytes += factor * other.bytes
        self.num_ops += factor * other.num_ops
        for key, (n, f, b) in other.by_op.items():
            row = self.by_op.setdefault(key, [0, 0, 0])
            row[0] += factor * n
            row[1] += factor * f
            row[2] += factor * b
        self.by_op = {k: r for k, r in self.by_op.items() if any(r)}


class CountingMode(TorchDispatchMode):
    """Prices every op dispatched under it into the innermost section
    (``section()``) and tracks the live bytes of the storages the ops
    create (the storages of ``arguments`` excluded)."""

    def __init__(self, arguments=()):
        super().__init__()
        self.sections: List[OpCount] = [OpCount()]
        self.unknown: Dict[str, int] = {}
        self._args = {_storage_key(t) for t in _tensors(arguments)}
        self._live: Dict[int, List[int]] = {}
        self.live_bytes = 0
        self._paused = 0

    @property
    def total(self) -> OpCount:
        return self.sections[0]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        for t in _tensors(out):
            self._track(t)
        if self._paused or func.is_view:
            return out
        cost = op_cost(func, args, kwargs, out)
        if cost is None:
            if not (func.overloadpacket in FREE
                    or func.namespace == "prim"):
                name = str(func.overloadpacket)
                self.unknown[name] = self.unknown.get(name, 0) + 1
            return out
        shapes = ",".join("x".join(map(str, t.shape)) or "()"
                          for t in _tensors(out))
        self.sections[-1].record(str(func), shapes, *cost)
        return out

    # -------------------------------------------------------- live bytes
    def _track(self, t: torch.Tensor) -> None:
        key = _storage_key(t)
        if key in self._args:
            return
        row = self._live.get(key)
        if row is None:
            row = self._live[key] = [t.untyped_storage().nbytes(), 0]
            self.hold(row[0])
        row[1] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
        row = self._live.get(key)
        if row is None:
            return
        row[1] -= 1
        if not row[1]:
            del self._live[key]
            self.hold(-row[0])

    def hold(self, nbytes: int) -> None:
        """Count ``nbytes`` more (fewer) live bytes, raising every open
        section's peak."""
        self.live_bytes += nbytes
        for sec in self.sections:
            sec.temp_bytes = max(sec.temp_bytes, self.live_bytes)

    # ---------------------------------------------------------- sections
    @contextlib.contextmanager
    def section(self) -> Iterator[OpCount]:
        """Ops inside go to a fresh count, handed back and not added to
        the enclosing one (the caller scales it); its peak starts at the
        live bytes on entry."""
        sec = OpCount(temp_bytes=self.live_bytes)
        self.sections.append(sec)
        try:
            yield sec
        finally:
            self.sections.pop()

    @contextlib.contextmanager
    def paused(self) -> Iterator[None]:
        """Ops inside are not priced (their storages are tracked)."""
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    def add_loop(self, runs: List[OpCount], steps: int) -> None:
        """Add a loop counted at 2, 3 and 4 steps as ``steps`` steps:
        Newton's forward differences, exact while the count is quadratic
        in the steps (autograd sums a loop's per-step slices of a whole
        tensor's gradient in one full-size add each)."""
        two, three, four = runs
        d1, d2 = OpCount(), OpCount()
        d1.axpy(three)
        d1.axpy(two, -1)
        d2.axpy(four)
        d2.axpy(three, -2)
        d2.axpy(two)
        n = steps - 2
        self.sections[-1].axpy(two)
        self.sections[-1].axpy(d1, n)
        self.sections[-1].axpy(d2, n * (n - 1) // 2)


# --------------------------------------------------------------------- #
# The recurrences' loops (``ref.wkv6`` token by token, ``wkv6_chunked``
# chunk by chunk): 2, 3 and 4 steps, forward and backward
# --------------------------------------------------------------------- #

class _ScaledLoop(torch.autograd.Function):
    """``run(n, *inputs)`` (the recurrence over its first ``n`` steps,
    ``unit`` tokens each) over all S / unit steps, priced from its runs at
    2, 3 and 4 steps (``CountingMode.add_loop``); the outputs are fresh
    tensors of the right shapes and the gradients fresh tensors of the
    inputs' (values are never read)."""

    @staticmethod
    def forward(ctx, mode, run, unit, r, k, v, w, u, *st):
        ctx.set_materialize_grads(False)
        ctx.mode, ctx.run, ctx.steps = mode, run, r.shape[1] // unit
        ctx.save_for_backward(r, k, v, w, u, *st)
        runs = []
        for n in (2, 3, 4):
            with mode.section() as sec:
                run(n, r, k, v, w, u, *st)
            runs.append(sec)
        mode.add_loop(runs, ctx.steps)
        b, s, h, d = r.shape
        return (r.new_empty((b, s, h, d)),
                r.new_empty((b, h, d, d), dtype=torch.float32))

    @staticmethod
    def backward(ctx, gy, gstate):
        mode, steps = ctx.mode, ctx.steps
        saved = ctx.saved_tensors
        wants = ctx.needs_input_grad[3:]
        runs, held = [], []
        for n in (2, 3, 4):
            ins = [t.detach().requires_grad_(want)
                   for t, want in zip(saved, wants)]
            before = mode.live_bytes
            with mode.paused(), torch.enable_grad():
                y, state = ctx.run(n, *ins)
            held.append(mode.live_bytes - before)
            outs, grads = [], []
            if gy is not None:
                outs.append(y)
                grads.append(gy[:, :y.shape[1]])
            if gstate is not None:
                outs.append(state)
                grads.append(gstate)
            diff = [t for t in ins if t.requires_grad]
            with mode.section() as sec:
                if outs and diff:
                    torch.autograd.grad(outs, diff, grads, allow_unused=True)
            runs.append(sec)
            del y, state, outs
        # The graph the recomputed loop holds before its gradient runs.
        graph = held[0] + (steps - 2) * (held[1] - held[0])
        mode.hold(graph)
        mode.hold(-graph)
        mode.add_loop(runs, steps)
        return (None, None, None) + tuple(
            torch.empty_like(t) if want else None
            for t, want in zip(saved, wants))


@contextlib.contextmanager
def _scaled_loops(mode: CountingMode) -> Iterator[None]:
    """Route the model's ``layers.wkv6`` and ``layers.wkv6_chunked``
    through ``_ScaledLoop`` above 4 steps while counting."""
    from ..models import layers
    plain, chunked = layers.wkv6, layers.wkv6_chunked

    def wkv6(r, k, v, w, u, init_state=None):
        if r.shape[1] <= 4:
            return plain(r, k, v, w, u, init_state)

        def run(n, r, k, v, w, u, *st):
            return plain(*(t[:, :n] for t in (r, k, v, w)), u, *st)

        st = () if init_state is None else (init_state,)
        return _ScaledLoop.apply(mode, run, 1, r, k, v, w, u, *st)

    def wkv6_chunked(r, k, v, w, u, init_state=None, *, chunk=16,
                     min_log_w=-5.0):
        s = r.shape[1]
        c = min(chunk, s)
        if s % c:
            c = math.gcd(s, c)
        if s // c <= 4:
            return chunked(r, k, v, w, u, init_state, chunk=chunk,
                           min_log_w=min_log_w)

        def run(n, r, k, v, w, u, *st):
            return chunked(*(t[:, :n * c] for t in (r, k, v, w)), u, *st,
                           chunk=c, min_log_w=min_log_w)

        st = () if init_state is None else (init_state,)
        return _ScaledLoop.apply(mode, run, c, r, k, v, w, u, *st)

    layers.wkv6, layers.wkv6_chunked = wkv6, wkv6_chunked
    try:
        yield
    finally:
        layers.wkv6, layers.wkv6_chunked = plain, chunked


# --------------------------------------------------------------------- #
# One step, one cell
# --------------------------------------------------------------------- #

def _fresh(inputs):
    """New meta tensors of the inputs' shapes and dtypes (no state, such
    as ``requires_grad``, carried from one count to the next)."""
    def one(t):
        if not isinstance(t, torch.Tensor):
            return t
        return torch.empty(t.shape, dtype=t.dtype, device="meta")
    return tree_map(one, inputs)


def count_step(fn, *inputs, scale: bool = True
               ) -> Tuple[OpCount, Dict[str, int]]:
    """Run ``fn(*inputs)`` once on meta tensors of the inputs' shapes and
    price it (``scale``: the recurrences' loops from 2, 3 and 4 steps).
    Returns the count and the memory record (``argument_bytes``,
    ``output_bytes``, ``alias_bytes``)."""
    args = _fresh(inputs)
    mode = CountingMode(arguments=args)
    loops = _scaled_loops(mode) if scale else contextlib.nullcontext()
    with loops, mode:
        out = fn(*args)
    arg_keys = {_storage_key(t) for t in _tensors(args)}
    outs = {_storage_key(t): t.untyped_storage().nbytes()
            for t in _tensors(out)}
    memory = {
        "argument_bytes": storage_bytes(args),
        "output_bytes": sum(b for k, b in outs.items() if k not in arg_keys),
        "alias_bytes": sum(b for k, b in outs.items() if k in arg_keys),
    }
    if mode.unknown:
        memory["unpriced_ops"] = dict(mode.unknown)
    return mode.total, memory


def kind_probes(cfg: ModelConfig) -> Dict[str, Tuple[int, ModelConfig]]:
    """Per layer kind of ``cfg``: (how many layers have it, a config whose
    first two layers have it).  Where layers 0 and 1 of the pattern do not
    both have the kind (gemma3's global layer, zamba2's shared-attention
    layer, any kind of a period-2 pattern) the pattern's period is set to
    1 or 3; everything else (the shared block's weights included) stays
    as it is."""
    kinds: Dict[str, int] = {}
    for i in range(cfg.num_layers):
        kind = cfg.layer_kind(i)
        kinds[kind] = kinds.get(kind, 0) + 1
    every = ("shared_attn_every" if cfg.shared_attn_every
             else "global_attn_every")
    candidates = [cfg] + [dataclasses.replace(cfg, **{every: k})
                          for k in (1, 3) if getattr(cfg, every)]
    probes = {}
    for kind, n in kinds.items():
        probe = next((c for c in candidates
                      if {c.layer_kind(0), c.layer_kind(1)} == {kind}), None)
        if probe is None:
            raise ValueError(f"no probe for {cfg.name}'s {kind!r} layers")
        probes[kind] = (n, probe)
    return probes


def count_cell(cfg: ModelConfig, shape: ShapeConfig, *, perf: object = False,
               scale: bool = True) -> Tuple[OpCount, Dict[str, int]]:
    """Price one step of the (``cfg`` x ``shape``) cell
    (``distributed.steps.trace_cell`` on meta tensors).  With
    ``scale`` the stack runs without layers (the embedding, head, loss
    and optimizer alone) and with one and two layers of each kind
    (``kind_probes``): a kind's first layer adds its one-layer count's
    difference from the layerless one, each further layer the two-layer
    count's from the one-layer one (a frontend's first layer computes no
    input gradient; zamba2's shared block sums its gradient once per
    further use).  The memory record's ``argument_bytes`` are the
    full-depth inputs' either way."""
    from ..distributed.steps import trace_cell

    fn, inputs = trace_cell(_eager(cfg), shape, perf, device="meta")
    if not scale:
        return count_step(fn, *inputs, scale=False)
    base, memory = count_step(*_traced(cfg, 0, shape, perf))
    total = OpCount(temp_bytes=base.temp_bytes)
    total.axpy(base)
    out = {k: memory[k] for k in ("output_bytes", "alias_bytes")}
    unpriced = dict(memory.get("unpriced_ops", {}))
    for n, probe in kind_probes(cfg).values():
        (one, mem1), (two, mem2) = (count_step(*_traced(probe, g, shape, perf))
                                    for g in (1, 2))
        total.axpy(one)
        total.axpy(base, -1)
        total.axpy(two, n - 1)
        total.axpy(one, 1 - n)
        total.temp_bytes += max(0, one.temp_bytes - base.temp_bytes) + (
            n - 1) * max(0, two.temp_bytes - one.temp_bytes)
        for k in out:
            out[k] += mem1[k] - memory[k] + (n - 1) * (mem2[k] - mem1[k])
        for mem in (mem1, mem2):
            for op, calls in mem.get("unpriced_ops", {}).items():
                unpriced[op] = unpriced.get(op, 0) + calls
    out["argument_bytes"] = storage_bytes(inputs)
    if unpriced:
        out["unpriced_ops"] = unpriced
    return total, out


def _eager(cfg: ModelConfig, **changes) -> ModelConfig:
    """The cell's config on the eager plan: a kernel wrapper raises for a
    meta tensor, so a kernel-plan config is counted as its eager plan (the
    registry's configs run it already)."""
    return dataclasses.replace(cfg, use_fused_kernels=False, **changes)


def _traced(cfg: ModelConfig, layers: int, shape: ShapeConfig, perf):
    from ..distributed.steps import trace_cell
    fn, inputs = trace_cell(_eager(cfg, num_layers=layers), shape, perf,
                            device="meta")
    return (fn, *inputs)


def analyze_step(cfg: ModelConfig, shape: ShapeConfig, *,
                 perf: object = False, scale: bool = True
                 ) -> Dict[str, object]:
    """``analyze_hlo``'s keys (``hlo_analysis.py:366``) for one cell's step
    (``count_cell``); ``num_ops`` (the priced op calls) in place of
    ``num_computations``, the collectives zero on one card."""
    count = count_cell(cfg, shape, perf=perf, scale=scale)[0]
    zeros = {k: 0.0 for k in COLLECTIVES}
    return {
        "flops": float(count.flops),
        "bytes_accessed": float(count.bytes),
        "collective_link_bytes": dict(zeros),
        "collective_operand_bytes": dict(zeros),
        "collective_link_total": 0.0,
        "collective_operand_total": 0.0,
        "collective_count": 0,
        "num_ops": count.num_ops,
    }


def top_items(count: OpCount, n: int = 20, kind: str = "bytes"
              ) -> List[Tuple[float, str, str]]:
    """The heaviest ops of a count: [(cost, 'op xcalls', result shapes)]
    sorted descending; ``kind``: 'bytes' | 'flops' | 'collective' (none on
    one card)."""
    if kind not in ("bytes", "flops", "collective"):
        raise ValueError(f"unknown kind {kind!r}")
    if kind == "collective":
        return []
    col = 2 if kind == "bytes" else 1
    items = [(float(row[col]), f"{name} x{row[0]}", shapes)
             for (name, shapes), row in count.by_op.items() if row[col]]
    items.sort(key=lambda t: -t[0])
    return items[:n]
