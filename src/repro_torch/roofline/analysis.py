"""Roofline terms of one step, per rank, on one NVIDIA H100 SXM.

    compute    = Σ over units of the unit's FLOPs / its peak
    memory     = bytes / HBM_BW
    collective = wire bytes within a node / NVLINK_BW
                 + wire bytes of groups that span nodes / NETWORK_BW

The reference reads FLOPs and bytes from XLA's cost analysis of the
compiled per-chip program and parses its collectives out of the HLO text.
The port has no compiled program: ``from_step`` runs the step once on fake
tensors (``torch._subclasses.fake_tensor``) under ``StepCounter``, a
``TorchDispatchMode`` that sees every ATen operation a rank runs, at the
shapes that rank holds:

* FLOPs are ``torch.utils.flop_counter``'s formulas (matrix products,
  convolutions, attention), on the unit that runs them: float32 on the CUDA
  cores (``device.py`` turns TF32 off), bfloat16 and float16 on the tensor
  cores;
* bytes are each operation's distinct inputs plus its outputs, each at most
  its storage's size (a broadcast input is read once); an operation that
  returns a view, and an allocation that writes nothing, counts zero; a
  gather counts its source at most as many bytes as it writes out, and an
  in-place scatter its destination at most as many bytes as it writes in
  (a decode step's K/V write touches B rows of a 2 GB cache, not all of it);
* collectives are the functional ones (``_c10d_functional``, what DTensor
  issues) and the in-place ``c10d.*_`` ones (``dist.all_reduce``), each
  recorded as (kind, result bytes, the group's ranks) and costed with the
  reference's ring formulas (``collective_bytes``);
* a hand-written kernel's wrapper, given fake tensors, records its own
  work (``record_kernel``: each kernel module's ``work``) and launches
  nothing.

DTensors.  The counter returns ``NotImplemented`` for an operation on
DTensors, so DTensor turns it into operations on each rank's local shards
(and the collectives of a redistribution), which the counter sees at local
shapes.  DTensor also runs each new operation once on fake tensors of the
*global* shapes to learn its output's metadata; ``StepCounter`` runs that
propagation with every dispatch mode set aside, so neither it nor a memory
tracker counts it.  A (2048, 4096) @ (4096, 4096) product on a 16 × 16 mesh,
x split by rows over ``data`` and w by columns over ``model``, counts a
rank's 2·128·4096·256 FLOPs, where ``FlopCounterMode`` reports the global
68.7 GFLOP.
"""
from __future__ import annotations

import contextlib
import dataclasses
from collections import Counter
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes
from torch.utils._pytree import tree_flatten

# One H100 SXM5 (NVIDIA H100 Tensor Core GPU datasheet; the tensor-core
# peaks are the datasheet's dense figures, half its "with sparsity" ones,
# as in the Hopper architecture whitepaper)
HBM_BW = 3.35e12             # B/s, HBM3
FP32_FLOPS = 67e12           # float32 on the CUDA cores
TF32_FLOPS = 494.7e12        # TF32 tensor cores, dense (K3: three passes a product)
BF16_FLOPS = 989.4e12        # bfloat16 / float16 tensor cores, dense
NVLINK_BW = 450e9            # B/s each way a GPU, NVLink 4 (900 GB/s both ways)
# A group whose ranks lie on more than one node of GPUS_PER_NODE GPUs moves
# its bytes over the network: one 400 Gb/s NDR InfiniBand port a GPU, the
# DGX H100's layout (NVIDIA DGX H100 datasheet)
NETWORK_BW = 50e9            # B/s each way a GPU
GPUS_PER_NODE = 8

PEAKS = {"fp32": FP32_FLOPS, "tf32": TF32_FLOPS, "bf16": BF16_FLOPS}
# the reference's names: the default compute peak and link rate
PEAK_FLOPS = FP32_FLOPS
ICI_BW = NVLINK_BW

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")


def ring_bytes(kind: str, nbytes: int, s: int) -> int:
    """Wire bytes a rank moves for one collective of result ``nbytes`` over
    a group of ``s`` ranks (the reference's ring costs):

        all-gather        result × (S-1)/S         (bytes received per chip)
        reduce-scatter    result × (S-1)            (operand = result × S)
        all-reduce        2 × result × (S-1)/S      (reduce-scatter + gather)
        all-to-all        result × (S-1)/S
        collective-permute result                   (one hop)
    """
    if kind == "all-gather":
        return nbytes * (s - 1) // max(s, 1)
    if kind == "reduce-scatter":
        return nbytes * (s - 1)
    if kind == "all-reduce":
        return 2 * nbytes * (s - 1) // max(s, 1)
    if kind == "all-to-all":
        return nbytes * (s - 1) // max(s, 1)
    if kind == "collective-permute":
        return nbytes
    raise ValueError(f"unknown collective {kind!r}")


def collective_bytes(records) -> dict[str, int]:
    """Per-kind wire bytes of recorded collectives, each ``(kind, result
    bytes, group size)``: the reference's ``collective_bytes`` on a list
    in place of HLO text."""
    out = {k: 0 for k in _COLLECTIVES}
    for kind, nbytes, s in records:
        out[kind] += ring_bytes(kind, nbytes, s)
    return out


@dataclasses.dataclass
class Roofline:
    """The reference's fields and properties, per rank.  ``flops_by_unit``,
    when given, makes the compute term the sum of each unit's FLOPs over
    its own peak (``PEAKS``); ``network_bytes`` is the part of the wire
    bytes whose groups span nodes, at NETWORK_BW; the rest moves at
    ``ici_bw`` (NVLink).  ``model_flops`` is global, divided by ``chips``
    for the useful-compute ratio."""
    flops: float                 # per-rank FLOPs, all units
    bytes_accessed: float        # per-rank bytes
    coll_bytes: dict[str, int]   # per-rank wire bytes by kind
    chips: int
    model_flops: float           # global (6·N·D convention)

    peak_flops: float = PEAK_FLOPS
    hbm_bw: float = HBM_BW
    ici_bw: float = ICI_BW
    flops_by_unit: dict[str, float] | None = None
    network_bytes: int = 0

    @property
    def model_flops_per_chip(self) -> float:
        return self.model_flops / self.chips

    @property
    def t_compute(self) -> float:
        if self.flops_by_unit is None:
            return self.flops / self.peak_flops
        return sum(f / PEAKS[u] for u, f in self.flops_by_unit.items())

    @property
    def t_memory(self) -> float:
        return self.bytes_accessed / self.hbm_bw

    @property
    def t_collective(self) -> float:
        total = sum(self.coll_bytes.values())
        return (total - self.network_bytes) / self.ici_bw + self.network_bytes / NETWORK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops_per_chip / self.flops if self.flops else 0.0

    @property
    def roofline_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def roofline_fraction(self) -> float:
        """MODEL_FLOPS-normalized fraction of the compute roofline achieved
        at the modeled bound: (model_flops/chip)/peak ÷ max-term."""
        t = self.roofline_time
        return (self.model_flops_per_chip / self.peak_flops) / t if t else 0.0

    def to_dict(self) -> dict:
        return {
            "flops": self.flops, "bytes_accessed": self.bytes_accessed,
            "collective_bytes": self.coll_bytes, "chips": self.chips,
            "model_flops": self.model_flops,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            # the port's own keys
            "flops_by_unit": self.flops_by_unit, "peak_flops": self.peak_flops,
            "network_collective_bytes": self.network_bytes,
        }


def extrapolate(r1: Roofline, r2: Roofline, n_layers: int, model_flops: float, *,
                first: int = 1) -> Roofline:
    """The terms of an ``n_layers`` stack from counts at L = ``first`` and
    ``first`` + 1 (the reference's sweep: 1 and 2): term(L) = term(first) +
    (L−first)·(term(first+1) − term(first)), exact for a layer-homogeneous
    stack."""
    def lin(a, b):
        return a + (n_layers - first) * (b - a)

    units = {u: lin(r1.flops_by_unit.get(u, 0.0), r2.flops_by_unit.get(u, 0.0))
             for u in set(r1.flops_by_unit or {}) | set(r2.flops_by_unit or {})}
    return dataclasses.replace(
        r1, flops=sum(units.values()), flops_by_unit=units, model_flops=model_flops,
        bytes_accessed=lin(r1.bytes_accessed, r2.bytes_accessed),
        coll_bytes={k: int(lin(r1.coll_bytes[k], r2.coll_bytes[k])) for k in r1.coll_bytes},
        network_bytes=int(lin(r1.network_bytes, r2.network_bytes)))


# ------------------------------------------------------------------ counting

# allocations that write nothing, metadata queries: no bytes
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided",
               "detach", "alias", "_unsafe_view", "lift_fresh", "lift_fresh_copy",
               "_local_scalar_dense",
               "sym_size", "sym_stride", "sym_numel", "sym_storage_offset", "is_same_size",
               "device", "resize_", "set_"}
# gathers: the source is read at most as many bytes as the result holds
_GATHERS = {"embedding", "index_select", "index", "gather", "take"}
# in-place scatters into their first argument: the destination is read and
# written at most as many bytes as the largest other input (the values)
_SCATTERS = {"index_put_", "_index_put_impl_", "index_add_", "index_copy_", "scatter_",
             "scatter_add_", "scatter_reduce_"}
_LINK_OPS = {"_c10d_functional", "c10d_functional", "c10d"}
_KINDS = (("all_gather", "all-gather"), ("allgather", "all-gather"),
          ("reduce_scatter", "reduce-scatter"), ("all_reduce", "all-reduce"),
          ("allreduce", "all-reduce"), ("all_to_all", "all-to-all"),
          ("alltoall", "all-to-all"), ("broadcast", "collective-permute"),
          ("send", "collective-permute"), ("permute", "collective-permute"))

_COUNTERS: list["StepCounter"] = []


def record_kernel(name: str, flops_by_unit: dict[str, float], nbytes: float) -> None:
    """A hand-written kernel's work on fake tensors, added to every active
    ``StepCounter`` (nothing when none is active)."""
    for c in _COUNTERS:
        c.add_kernel(name, flops_by_unit, nbytes)


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def tensor_bytes(t: torch.Tensor) -> int:
    """The bytes a pass over ``t`` reads or writes: its elements, but no
    more than its storage holds (an expanded tensor repeats its storage)."""
    n = t.numel() * t.element_size()
    try:
        return min(n, t.untyped_storage().nbytes())
    except (NotImplementedError, RuntimeError):
        return n


def _unit(dtype: torch.dtype) -> str:
    return "bf16" if dtype in (torch.bfloat16, torch.float16) else "fp32"


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _group_ranks(args) -> list[int] | None:
    """The ranks of the process group a collective's arguments name."""
    import torch.distributed as dist
    from torch.distributed import distributed_c10d as c10d
    for a in tree_flatten(args)[0]:
        pg = None
        if isinstance(a, str):
            try:
                pg = c10d._resolve_process_group(a)
            except (RuntimeError, ValueError, KeyError):
                continue
        elif isinstance(a, dist.ProcessGroup):
            pg = a
        elif isinstance(a, torch.ScriptObject):     # a c10d op's boxed group
            try:
                pg = dist.ProcessGroup.unbox(a)
            except (RuntimeError, TypeError):
                continue
        if pg is not None:
            return dist.get_process_group_ranks(pg)
    return None


# DTensor's sharding propagator: the methods that run an operation on
# tensors of the global shapes (fake or meta) to learn its output's
# metadata and its strategy
_PROPAGATION = ("propagate_op_sharding_non_cached", "_propagate_tensor_meta_non_cached")


@contextlib.contextmanager
def _propagation_apart():
    """DTensor's propagation, run with every dispatch mode set aside, so
    that no counter or tracker sees its operations."""
    from torch.distributed.tensor import DTensor
    prop = DTensor._op_dispatcher.sharding_propagator
    names = [n for n in _PROPAGATION if hasattr(prop, n)]
    if not names:
        raise RuntimeError(f"torch {torch.__version__}: DTensor's sharding propagator has none "
                           f"of {_PROPAGATION}; the counter cannot set its propagation apart")

    def apart(inner):
        def run(*args, **kwargs):
            with _disable_current_modes():
                return inner(*args, **kwargs)
        return run

    for n in names:
        setattr(prop, n, apart(getattr(prop, n)))
    try:
        yield
    finally:
        for n in names:
            delattr(prop, n)


class StepCounter(TorchDispatchMode):
    """Counts what a rank runs: FLOPs by unit, bytes, collectives (kind,
    result bytes, group ranks), the hand-written kernels' calls and work,
    and each ATen operation's calls and bytes.  Enter it with the fake mode
    of the step's tensors active: an operation counts when every tensor it
    takes and gives is one of that mode's fake tensors (what DTensor runs on
    other tensors to propagate shapes does not)."""

    def __init__(self, fake_mode):
        super().__init__()
        self.fake_mode = fake_mode
        self.flops_by_unit: Counter = Counter()
        self.bytes = 0
        self.collectives: list[tuple[str, int, tuple[int, ...]]] = []
        self.kernels: dict[str, dict] = {}
        self.ops: Counter = Counter()
        self.op_bytes: Counter = Counter()

    def __enter__(self):
        if self not in _COUNTERS:
            _COUNTERS.append(self)
        self._depth = getattr(self, "_depth", 0) + 1
        return super().__enter__()

    def __exit__(self, *exc):
        self._depth -= 1
        if not self._depth:
            _COUNTERS.remove(self)
        return super().__exit__(*exc)

    def add_kernel(self, name: str, flops_by_unit: dict[str, float], nbytes: float) -> None:
        k = self.kernels.setdefault(name, {"calls": 0, "flops_by_unit": Counter(), "bytes": 0})
        k["calls"] += 1
        k["flops_by_unit"].update(flops_by_unit)
        k["bytes"] += nbytes
        self.flops_by_unit.update(flops_by_unit)
        self.bytes += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented            # DTensor runs it as local operations
        from torch.utils.flop_counter import flop_registry
        if func._overloadpacket not in flop_registry and func.namespace == "aten":
            # a composite operation (``matmul`` and ``einsum`` reach a mode
            # whole under inference mode) counts as what it decomposes into
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if all(getattr(t, "fake_mode", None) is self.fake_mode
               for t in _tensors((args, kwargs, out))):
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        name = func._schema.name.split("::")[-1]
        self.ops[f"{func.namespace}.{name}"] += 1
        if func.namespace in _LINK_OPS:
            self._collective(func, name, args, kwargs, out)
            return
        if name in _NO_TRAFFIC or func.namespace == "prim" or _is_view(func):
            return
        from torch.utils.flop_counter import flop_registry
        formula = flop_registry.get(func._overloadpacket)
        ins = list({id(t): t for t in _tensors((args, kwargs))}.values())
        if formula is not None and ins:
            self.flops_by_unit[_unit(ins[0].dtype)] += formula(*args, **kwargs, out_val=out)
        outs = _tensors(out)
        out_bytes = sum(tensor_bytes(t) for t in outs)
        in_bytes = [tensor_bytes(t) for t in ins]
        if name in _GATHERS and in_bytes:
            in_bytes[0] = min(in_bytes[0], out_bytes)
        if name in _SCATTERS and len(in_bytes) > 1:
            written = max(in_bytes[1:])
            in_bytes[0] = min(in_bytes[0], written)
            out_bytes = min(out_bytes, written)
        self.bytes += sum(in_bytes) + out_bytes
        self.op_bytes[f"{func.namespace}.{name}"] += sum(in_bytes) + out_bytes

    def _collective(self, func, name, args, kwargs, out) -> None:
        kind = next((k for key, k in _KINDS if key in name), None)
        if kind is None:                     # wait_tensor and the like
            return
        # the in-place c10d ops write their first argument; the functional
        # ones return their result
        result = _tensors(args[0]) if func.namespace == "c10d" else _tensors(out)
        ranks = _group_ranks((args, kwargs))
        ranks = tuple(ranks) if ranks is not None else (0,)
        self.collectives.append((kind, sum(tensor_bytes(t) for t in result), ranks))

    def roofline(self, chips: int, model_flops: float,
                 peak_flops: float | None = None) -> Roofline:
        """The counts as a ``Roofline``.  ``peak_flops`` defaults to the peak
        of the unit that did most of the FLOPs (float32 when none)."""
        units = {u: float(f) for u, f in self.flops_by_unit.items() if f}
        if peak_flops is None:
            peak_flops = PEAKS[max(units, key=units.get)] if units else PEAK_FLOPS
        records = [(k, n, len(r)) for k, n, r in self.collectives]
        network = sum(ring_bytes(k, n, len(r)) for k, n, r in self.collectives
                      if len({x // GPUS_PER_NODE for x in r}) > 1)
        return Roofline(flops=sum(units.values()), bytes_accessed=float(self.bytes),
                        coll_bytes=collective_bytes(records), chips=chips,
                        model_flops=model_flops, peak_flops=peak_flops,
                        flops_by_unit=units, network_bytes=network)


def fake_mode_of(tree):
    """The fake mode of the first fake tensor in ``tree`` (DTensors' local
    shards included)."""
    from torch._subclasses.fake_tensor import is_fake
    from torch.distributed.tensor import DTensor
    for t in _tensors(tree):
        t = t.to_local() if isinstance(t, DTensor) else t
        if is_fake(t):
            return t.fake_mode
    raise ValueError("the step's arguments hold no fake tensor")


def local_tensors(tree) -> list[torch.Tensor]:
    """Every tensor of ``tree``, a DTensor as its local shard."""
    from torch.distributed.tensor import DTensor
    return [t.to_local() if isinstance(t, DTensor) else t for t in _tensors(tree)]


@contextlib.contextmanager
def counting(fake_mode, *, track: list | None = None):
    """Count what runs inside, on ``fake_mode``'s tensors: yields a
    ``StepCounter``; with ``track`` (tensors live from the start), its
    ``.mem_tracker`` is a ``MemTracker`` that holds them, else None."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(fake_mode)
        stack.enter_context(_propagation_apart())
        tracker = None
        if track is not None:
            from torch.distributed._tools.mem_tracker import MemTracker
            tracker = MemTracker()
            tracker.track_external(*track)
            stack.enter_context(tracker)
        counter = StepCounter(fake_mode)
        counter.mem_tracker = tracker
        stack.enter_context(counter)
        yield counter


def peak_bytes(tracker) -> int:
    """The peak of a ``MemTracker``'s live bytes on its busiest device."""
    snap = tracker.get_tracker_snapshot("peak")
    return max((int(d.get("Total", 0)) for d in snap.values()), default=0)


def from_step(fn: Callable, args: tuple, chips: int, model_flops: float, *,
              peak_flops: float | None = None) -> Roofline:
    """Run ``fn(*args)`` once on its fake tensors (plain, or DTensors of
    fake shards) under a ``StepCounter``: the per-rank ``Roofline``."""
    with counting(fake_mode_of(args)) as c:
        fn(*args)
    return c.roofline(chips, model_flops, peak_flops)


def count(fn: Callable, args: tuple, *, memory: bool = False) -> tuple[Any, StepCounter]:
    """``fn(*args)``'s result and its ``StepCounter`` (with a memory
    tracker when ``memory``: every argument's local shard live from the
    start)."""
    with counting(fake_mode_of(args), track=local_tensors(args) if memory else None) as c:
        out = fn(*args)
    return out, c
