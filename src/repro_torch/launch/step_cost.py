"""Per-device cost of one eager call: FLOPs, bytes, collective traffic, and
the roofline terms they give on the card.

Counterpart of ``repro.launch.hlo_cost`` (``analyze``, ``HloCost``) and
``repro.launch.hlo_analysis`` (``_ring_factor``, ``RooflineTerms``). The
reference parses the post-optimization HLO text of a compiled program and
multiplies each loop body by its trip count. PyTorch runs eagerly and
never produces HLO: ``analyze`` runs the function once and watches every
operation it dispatches, so every trip of every loop is counted as it runs
(``unknown_loops`` is always 0). The HLO text parsers ``parse_module`` and
``collective_stats(hlo_text)`` have nothing to read here and are not
ported.

Under DTensor (``torch.distributed.tensor``) each operation on the global
tensors runs as operations on one device's local shards plus the
collectives that move them; ``analyze`` counts those, so every number is
per device, as the reference's are on its partitioned module:

  * FLOPs: ``torch.utils.flop_counter``'s per-op formulas (the table
    ``FlopCounterMode`` reads: matrix products, convolutions, attention),
    applied to each local operation. On plain tensors the count equals
    ``FlopCounterMode``'s.
  * bytes: operand plus result bytes of every operation that is not a
    view or an allocation. Eager execution fuses nothing, so this is an
    upper bound on HBM traffic, as the reference's CPU-backend count is;
    ``launch.modelbytes`` gives the floor.
  * collectives (``_c10d_functional``): result bytes and group size of
    each, and the link bytes through the reference's ring factors.

The functions run on ``meta`` tensors as well, which is how ``dryrun``
costs a full-size cell without allocating it.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

# One NVIDIA H100 SXM (NVIDIA's data sheet: dense bf16 tensor-core rate,
# HBM3 bandwidth, NVLink 4 at 900 GB/s both directions together). The
# rates assume the card's full 700 W power limit; ``chip_smoke.py`` prints
# the name and limit of the card it ran on beside every roofline.
PEAK_FLOPS = 989e12          # bf16 / card
HBM_BW = 3.35e12             # bytes / s / card
LINK_BW = 450e9              # bytes / s / card, one direction

# the reference's collective kinds, by _c10d_functional op name
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
# ops that move no bytes: allocations, and the waits and autograd wrappers
# of the functional collectives (their bytes are the collective's)
_FREE = {"empty", "empty_strided", "empty_like", "new_empty",
         "new_empty_strided", "wait_tensor", "_wrap_tensor_autograd",
         "detach", "lift_fresh"}


def _ring_factor(kind: str, g: int) -> float:
    """Per-chip link bytes per RESULT byte under ring algorithms (a copy of
    the reference's ``hlo_analysis._ring_factor``).

    all-gather result = gathered (full) buffer -> (g-1)/g of it crosses
    links per chip; all-reduce result = full buffer -> 2(g-1)/g;
    reduce-scatter result = the 1/g shard -> (g-1) result-sized chunks
    cross links; all-to-all result is full-size -> (g-1)/g.
    """
    if g <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * (g - 1) / g
    if kind == "reduce-scatter":
        return float(g - 1)
    if kind in ("all-gather", "all-to-all"):
        return (g - 1) / g
    return 1.0                                   # collective-permute


@dataclass
class StepCost:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    coll_bytes: Dict[str, float] = field(default_factory=dict)
    coll_link_bytes: Dict[str, float] = field(default_factory=dict)
    coll_ops: Dict[str, int] = field(default_factory=dict)
    unknown_loops: int = 0

    @property
    def total_coll_link_bytes(self) -> float:
        return sum(self.coll_link_bytes.values())

    def to_dict(self) -> Dict:
        return {"flops": self.flops, "hbm_bytes": self.hbm_bytes,
                "coll_bytes": self.coll_bytes,
                "coll_link_bytes": self.coll_link_bytes,
                "coll_ops": self.coll_ops,
                "total_coll_link_bytes": self.total_coll_link_bytes,
                "unknown_loops": self.unknown_loops}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


def _group_size(args) -> int:
    """The group size of a functional collective: its last argument names
    its process group."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(args[-1]).size()


class _CostMode(TorchDispatchMode):
    """Counts the operations that run on one device's tensors. An op on
    DTensors is declined (``NotImplemented``), so DTensor runs it as local
    ops and collectives, which come back through this mode; an op on the
    fake tensors of DTensor's shape propagation runs uncounted."""

    def __init__(self, cost: StepCost):
        super().__init__()
        self.cost = cost

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if any(issubclass(t, FakeTensor) for t in types):
            return func(*args, **kwargs)
        packet = func._overloadpacket
        if packet not in flop_registry \
                and func is not torch.ops.prim.device.default:
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        c = self.cost
        if packet in flop_registry:
            c.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        name = packet.__name__
        kind = _COLLECTIVES.get(name) \
            if func.namespace == "_c10d_functional" else None
        if kind is not None:
            rb = _nbytes(out)
            g = _group_size(args)
            c.coll_ops[kind] = c.coll_ops.get(kind, 0) + 1
            c.coll_bytes[kind] = c.coll_bytes.get(kind, 0.0) + rb
            c.coll_link_bytes[kind] = c.coll_link_bytes.get(kind, 0.0) \
                + rb * _ring_factor(kind, g)
        if not func.is_view and name not in _FREE:
            c.hbm_bytes += _nbytes(out) + _nbytes(args) + _nbytes(kwargs)
        return out


@contextlib.contextmanager
def counting():
    """Counts what runs inside the block into the ``StepCost`` it yields."""
    cost = StepCost()
    with _CostMode(cost):
        yield cost


def analyze(fn, *args, **kw) -> StepCost:
    """The cost of ``fn(*args, **kw)`` on one device."""
    with counting() as cost:
        fn(*args, **kw)
    return cost


@dataclass
class RooflineTerms:
    flops_per_device: float
    hbm_bytes_per_device: float
    collective_link_bytes: float
    n_devices: int

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes_per_device / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_link_bytes / LINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def to_dict(self) -> Dict:
        return {"flops_per_device": self.flops_per_device,
                "hbm_bytes_per_device": self.hbm_bytes_per_device,
                "collective_link_bytes": self.collective_link_bytes,
                "compute_s": self.compute_s, "memory_s": self.memory_s,
                "collective_s": self.collective_s,
                "dominant": self.dominant}


def roofline(cost: StepCost, n_devices: int) -> RooflineTerms:
    return RooflineTerms(cost.flops, cost.hbm_bytes,
                         cost.total_coll_link_bytes, n_devices)
