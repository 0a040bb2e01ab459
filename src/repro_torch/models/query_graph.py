"""The campaign's LM query as one CUDA graph replay.

``core/characterize.py::lm_eval_fn`` owns a ``QueryGraph`` and makes it
the ambient one while its query calls ``forward``. ``forward`` then hands
the call to it (``active`` is the one module-level read it costs
elsewhere). The graph serves a call it can capture: tokens on the card
and nothing else in the batch, an attention family of the language
models (dense or moe), contiguous leaves on the tokens' device that need
no gradient, no remat, no returned cache, no ambient mesh under
``shard_hints``. The first such query runs eagerly and warms the
libraries up; the second captures the eager forward's ops, unchanged,
over static buffers, then replays them; every later one replays. A call
with another token shape or dtype, or other leaf paths, shapes or dtypes
than the captured ones, runs eagerly, as does every call the graph
cannot capture. While the graph runs a forward eagerly or captures one,
no graph is ambient, so the forward does not come back to it.

The graph reads a private mirror of every leaf. Before a replay each
leaf that is not the tensor last copied at its path, or is that tensor
written in place since (its ``_version`` moved), is copied into the
mirror: a strike rebuilds the struck leaf as a new tensor, so a trial
copies the struck leaf in and the next trial the clean one back. The
mirror never aliases a caller's tensor and holds none alive. The tokens
are copied in on every replay, and the logits and the aux loss come back
as fresh clones, so a later replay never overwrites a returned tensor.

Counters, in the innermost open span: ``query_replays`` and
``query_eager``, one a query that passes through the graph;
``query_copied_bytes``, the mirror bytes copied before a replay; and
every replay adds the counts its capture made (``moe_routed``,
``moe_slots``), which the capture collected instead of recording.
"""
from __future__ import annotations

import contextlib
import weakref
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch

from repro_torch import telemetry
from repro_torch.sharding.mesh import ambient_mesh

Path = Tuple[str, ...]
_FAMILIES = ("dense", "moe")

active: Optional["QueryGraph"] = None     # the graph of the running query


# ``core/tree.py``'s order (keys sorted, depth first), kept here since
# importing ``repro_torch.core`` from the models would import it in a cycle
def _flat(tree, path: Path, out: List[Tuple[Path, torch.Tensor]]) -> None:
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flat(tree[k], path + (k,), out)
    else:
        out.append((path, tree))


def _nest(flat: List[Tuple[Path, torch.Tensor]]) -> dict:
    tree: dict = {}
    for path, leaf in flat:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return tree


def leaves(tree) -> List[Tuple[Path, torch.Tensor]]:
    """``(path, leaf)`` of every leaf of ``tree``, in ``_flat``'s order."""
    out: List[Tuple[Path, torch.Tensor]] = []
    _flat(tree, (), out)
    return out


def capture(fn: Callable, *args, stream: torch.cuda.Stream, pool=None
            ) -> Tuple[torch.cuda.CUDAGraph, object, Dict[str, int]]:
    """``(graph, outputs, counts)``: ``fn(*args)``'s ops captured on the
    side ``stream`` into a new CUDA graph (with no query graph ambient),
    its static outputs, and the counts it made, collected instead of
    recorded. ``pool``, another graph's ``pool()``, makes the capture
    allocate from that graph's memory, which may then no longer be
    replayed; its blocks serve only a capture on that graph's stream.

    Unlike ``torch.cuda.graph`` this neither synchronises the device nor
    empties the allocator's cache first: an engine captures its decode
    again after every params scrub, and an emptied cache would make the
    next prefill, KV check and scrub ``cudaMalloc`` their buffers
    anew."""
    graph = torch.cuda.CUDAGraph()
    stream.wait_stream(torch.cuda.current_stream())
    with _ambient(None), telemetry.collecting() as counts, \
            torch.cuda.stream(stream):
        graph.capture_begin(pool=pool)
        try:
            out = fn(*args)
        finally:
            graph.capture_end()
    return graph, out, counts


def replay(graph: torch.cuda.CUDAGraph, counts: Dict[str, int]) -> None:
    """Launch ``graph`` and count what its capture counted."""
    graph.replay()
    for name, n in counts.items():
        telemetry.count(name, n)


def _captures_on(device: torch.device) -> bool:
    """Whether a graph is captured for tensors on ``device``."""
    return device.type == "cuda"


def signature(p, batch, cfg, remat: str = "none",
              return_cache: bool = False):
    """``(flat leaves, key)`` of a forward call a graph can serve, the key
    being the tokens' shape and dtype and each leaf's path, shape and
    dtype; None for a call it cannot."""
    if cfg.family not in _FAMILIES or remat != "none" or return_cache:
        return None
    if cfg.shard_hints and ambient_mesh() is not None:
        return None
    if not isinstance(batch, dict) or list(batch) != ["tokens"]:
        return None
    tok = batch["tokens"]
    if not _captures_on(tok.device):
        return None
    flat = leaves(p)
    for _, t in flat:
        if not isinstance(t, torch.Tensor) or t.requires_grad \
                or t.device != tok.device or not t.is_contiguous():
            return None
    key = (tuple(tok.shape), tok.dtype,
           tuple((path, tuple(t.shape), t.dtype) for path, t in flat))
    return flat, key


class Mirror:
    """Private contiguous copies of a list of leaves, refreshed from the
    leaves that changed: another tensor at a position, or the same tensor
    written in place since its last copy."""

    def __init__(self, leaves: List[torch.Tensor]):
        self.copies = [torch.empty(t.shape, dtype=t.dtype, device=t.device)
                       for t in leaves]
        self._last: List[Optional[Tuple[weakref.ref, int]]] = \
            [None] * len(leaves)

    def sync(self, leaves: List[torch.Tensor]) -> int:
        """Copy in the leaves that changed; the bytes copied."""
        copied = 0
        for i, t in enumerate(leaves):
            last = self._last[i]
            if last is None or last[0]() is not t or last[1] != t._version:
                self.copies[i].copy_(t)
                self._last[i] = (weakref.ref(t), t._version)
                copied += t.numel() * t.element_size()
        return copied


@contextlib.contextmanager
def _ambient(graph: Optional["QueryGraph"]) -> Iterator[None]:
    global active
    prev, active = active, graph
    try:
        yield
    finally:
        active = prev


class QueryGraph:
    """One query's forward, captured on its second run and replayed after
    (module docstring)."""

    def __init__(self):
        self._key = None            # of the warm-up query, then the capture
        self._graph = None
        self._mirror: Optional[Mirror] = None
        self._tokens: Optional[torch.Tensor] = None
        self._out: Tuple[torch.Tensor, torch.Tensor] = ()
        self._counts: Dict[str, int] = {}

    def engaged(self):
        """A context manager: this graph is the ambient one inside."""
        return _ambient(self)

    def forward(self, forward: Callable, p, batch, cfg, remat: str = "none",
                return_cache: bool = False):
        """``forward(p, batch, cfg, remat, return_cache)``'s result, replayed
        where the call is the captured one."""
        sig = signature(p, batch, cfg, remat, return_cache)
        if sig is not None and self._key is not None and sig[1] == self._key:
            if self._graph is None:
                self._capture(forward, sig[0], batch, cfg)
            return self._replay(sig[0], batch)
        if sig is not None and self._key is None:
            self._key = sig[1]                      # the warm-up
        telemetry.count("query_eager", 1)
        with _ambient(None):
            return forward(p, batch, cfg, remat=remat,
                           return_cache=return_cache)

    def _capture(self, forward: Callable, flat, batch, cfg) -> None:
        self._mirror = Mirror([t for _, t in flat])
        self._tokens = torch.empty_like(batch["tokens"])
        weights = _nest([(path, c) for (path, _), c in
                         zip(flat, self._mirror.copies)])
        self._graph, out, self._counts = capture(
            forward, weights, {"tokens": self._tokens}, cfg,
            stream=torch.cuda.Stream(self._tokens.device))
        self._out = out[:2]

    def _replay(self, flat, batch):
        copied = self._mirror.sync([t for _, t in flat])
        self._tokens.copy_(batch["tokens"])
        replay(self._graph, self._counts)
        telemetry.count("query_replays", 1)
        telemetry.count("query_copied_bytes", copied)
        logits, aux = self._out
        return logits.clone(), aux.clone(), None
