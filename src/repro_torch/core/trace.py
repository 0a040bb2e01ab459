"""Field-trace error replay: recorded (or field-shaped synthetic) error
streams driven into live ``MemoryDomain``s event-by-event.

Counterpart of ``repro.core.trace``, numpy as it is there: the same
``.npz`` format (a file written by either package loads in the other),
the same binding of events onto the leaves of ``dom.spec.protectable`` (in
the reference's sorted leaf order), and the same replay through the port's
``MemoryDomain.apply_plan``.

Every campaign and availability number in this repo used to draw iid
strikes from ``ErrorModel``. The field studies those rates come from
(Meza+15; the datacenter DRAM study of arXiv:1901.03401) show errors are
anything but iid: they arrive in temporal bursts (heavy-tailed
inter-arrival times), repeat at the same physical address (hard faults —
a handful of repeat-offender rows produce most of a fleet's error count),
strike adjacent bits in one word (wordline/bitline defects), and skew
heavily across DIMMs. ``ErrorTrace`` is the recorded form of such a
stream; ``core.tracegen`` synthesizes one calibrated to the field-study
shape (constants: docs/DESIGN.md §8.3); this module replays one.

Format — parallel arrays, one entry per error event, sorted by time:

    t      float64  seconds since trace start
    dimm   int32    device/DIMM the error struck
    addr   int64    byte address within that DIMM's ``dimm_bytes`` space
    bit    int8     first struck bit within the 64-bit word (0..63)
    burst  int8     number of *adjacent* bits struck (1 = single bit)
    hard   bool     sticky device defect (re-asserts until retired)

Traces round-trip through a single ``.npz`` (arrays + JSON-encoded
provenance ``meta``).

Replay maps the physical (dimm, addr) space onto a domain's protected
leaves: the leaves' covered bytes are concatenated in leaf-table order
into one flat span, each DIMM's address space tiles it, and an event
lands on the word containing its mapped byte. The mapping is pure
arithmetic over the trace arrays — replaying the same trace into the
same domain layout is bit-deterministic: two replays give the same
outcomes.

``TraceReplayer`` drives one domain on a virtual clock::

    rep = TraceReplayer(trace, domain)
    domain, fired = rep.play(domain, until=now)   # injects every due event

``bind_trace`` is the multi-domain form (params and KV pools share one
physical address space, so one recorded server-month covers both); the
online serving engine (``repro_torch.serve.engine``) uses it.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.errormodel import InjectionPlan
from repro_torch.kernels.ops import LANES

SECONDS_PER_MONTH = 30 * 24 * 3600.0
# logical per-DIMM address space; replay tiles it onto the bound domains'
# covered bytes, so it only sets the *granularity* of address reuse
DEFAULT_DIMM_BYTES = 1 << 26


@dataclass
class ErrorTrace:
    """One recorded error stream (see module docstring for the format)."""
    t: np.ndarray
    dimm: np.ndarray
    addr: np.ndarray
    bit: np.ndarray
    burst: np.ndarray
    hard: np.ndarray
    dimm_bytes: int = DEFAULT_DIMM_BYTES
    duration_s: float = 0.0        # 0 -> t[-1] (recording span, not last event)
    meta: Dict = field(default_factory=dict)

    # ------------------------------------------------------- invariants
    def __post_init__(self):
        n = len(self.t)
        self.t = np.asarray(self.t, np.float64)
        self.dimm = np.asarray(self.dimm, np.int32)
        self.addr = np.asarray(self.addr, np.int64)
        self.bit = np.asarray(self.bit, np.int8)
        self.burst = np.asarray(self.burst, np.int8)
        self.hard = np.asarray(self.hard, np.bool_)
        for name in ("dimm", "addr", "bit", "burst", "hard"):
            if len(getattr(self, name)) != n:
                raise ValueError(f"trace array {name!r} length "
                                 f"{len(getattr(self, name))} != {n}")
        if n and np.any(np.diff(self.t) < 0):
            raise ValueError("trace timestamps must be sorted")
        if n and (self.bit.min() < 0 or self.bit.max() > 63):
            raise ValueError("bit indices must be in [0, 64)")
        if n and self.burst.min() < 1:
            raise ValueError("burst widths must be >= 1")
        if n and np.any(self.bit.astype(np.int32)
                        + self.burst.astype(np.int32) > 64):
            raise ValueError("burst must fit inside one 64-bit word")

    # ------------------------------------------------------- accessors
    def __len__(self) -> int:
        return len(self.t)

    @property
    def duration(self) -> float:
        if self.duration_s > 0:
            return self.duration_s
        return float(self.t[-1]) if len(self.t) else 0.0

    @property
    def months(self) -> float:
        return max(self.duration, 1e-9) / SECONDS_PER_MONTH

    def n_dimms(self) -> int:
        return int(self.dimm.max()) + 1 if len(self.dimm) else 0

    def summary(self) -> str:
        n = len(self)
        if not n:
            return "ErrorTrace(empty)"
        n_hard = int(self.hard.sum())
        n_multi = int((self.burst > 1).sum())
        uniq = len(np.unique(
            self.dimm.astype(np.int64) * (self.dimm_bytes + 1) + self.addr))
        return (f"ErrorTrace({n} events over {self.duration / 86400:.1f} d, "
                f"{self.n_dimms()} dimms, hard={n_hard} "
                f"({n_hard / n:.0%}), multi-bit={n_multi} "
                f"({n_multi / n:.1%}), unique addrs={uniq})")

    # ------------------------------------------------------------- I/O
    def save(self, path) -> Path:
        path = Path(path)
        meta = dict(self.meta)
        meta["dimm_bytes"] = int(self.dimm_bytes)
        meta["duration_s"] = float(self.duration)
        np.savez(path, t=self.t, dimm=self.dimm, addr=self.addr,
                 bit=self.bit, burst=self.burst, hard=self.hard,
                 meta=np.frombuffer(json.dumps(meta).encode(), np.uint8))
        return path if path.suffix == ".npz" else path.with_suffix(".npz")

    @classmethod
    def load(cls, path) -> "ErrorTrace":
        with np.load(path) as z:
            meta = json.loads(bytes(z["meta"]).decode()) if "meta" in z \
                else {}
            return cls(z["t"], z["dimm"], z["addr"], z["bit"], z["burst"],
                       z["hard"],
                       dimm_bytes=int(meta.get("dimm_bytes",
                                               DEFAULT_DIMM_BYTES)),
                       duration_s=float(meta.get("duration_s", 0.0)),
                       meta=meta)


# =====================================================================
# binding a trace onto domain leaves
# =====================================================================
class BoundStrike(NamedTuple):
    """One trace event resolved to a concrete (domain, leaf, word, bits)."""
    t: float
    domain: str                 # key into the domains mapping it was bound to
    path: str                   # leaf path within that domain
    word: int                   # word index within the leaf's packed words
    bits: Tuple[int, ...]       # struck bit positions within the word
    hard: bool
    dimm: int

    def plan(self, pad_to: int = 8) -> InjectionPlan:
        e = max(pad_to, -(-len(self.bits) // pad_to) * pad_to)
        wi = np.full(e, -1, np.int32)
        bi = np.zeros(e, np.int32)
        wi[:len(self.bits)] = self.word
        bi[:len(self.bits)] = np.asarray(self.bits, np.int32)
        return InjectionPlan(wi, bi, self.hard)


def _leaf_table(domains: Mapping[str, "object"]
                ) -> Tuple[List[Tuple[str, str, int]], np.ndarray, int]:
    """Concatenate every protectable leaf's *covered* bytes (whole packed
    words only) across domains, in leaf-table order. Returns
    (rows of (domain, path, covered_words), byte start offsets, total)."""
    rows: List[Tuple[str, str, int]] = []
    starts: List[int] = []
    off = 0
    for dname, dom in domains.items():
        for s in dom.spec.protectable:
            words = s.rows * LANES
            rows.append((dname, s.path, words))
            starts.append(off)
            off += words * 8
    if not rows:
        raise ValueError("no protectable leaves to bind the trace onto")
    return rows, np.asarray(starts, np.int64), off


def bind_trace(trace: ErrorTrace, domains: Mapping[str, "object"], *,
               span: Optional[float] = None) -> List[BoundStrike]:
    """Resolve every trace event to a (domain, leaf, word, bits) strike.

    ``domains`` maps names to live ``MemoryDomain``s; their protected
    leaves form one flat byte span the per-DIMM address space tiles.
    ``span`` rescales timestamps onto ``[0, span]`` (the serving engine
    compresses a recorded month into one trace's arrival window, the same
    way ``--storm-errors`` compresses the analytic budget).
    """
    if not len(trace):
        return []
    rows, starts, total = _leaf_table(domains)
    phys = (trace.dimm.astype(np.int64) * trace.dimm_bytes
            + trace.addr) % total
    idx = np.searchsorted(starts, phys, side="right") - 1
    t = trace.t
    if span is not None:
        t = t * (span / max(trace.duration, 1e-9))
    out: List[BoundStrike] = []
    for i in range(len(trace)):
        dname, path, words = rows[int(idx[i])]
        word = int((phys[i] - starts[idx[i]]) >> 3)
        w = int(trace.burst[i])
        b0 = min(int(trace.bit[i]), 64 - w)
        out.append(BoundStrike(float(t[i]), dname, path, word,
                               tuple(range(b0, b0 + w)),
                               bool(trace.hard[i]), int(trace.dimm[i])))
    return out


class TraceReplayer:
    """Replay one trace into one domain on a virtual clock.

    The replayer is a cursor over the bound strikes; ``play`` injects
    every event due by ``until`` (all of them when ``until`` is None) and
    returns the struck domain plus the fired strikes. Hard events are
    recorded in the domain's hard-error map so they re-assert on
    ``reassert_hard`` — the trace's repeat-offender addresses land on the
    same words, reproducing the field studies' sticky-fault behaviour.
    """

    def __init__(self, trace: ErrorTrace, domain, *,
                 span: Optional[float] = None, domain_name: str = "domain"):
        self.trace = trace
        self.strikes = bind_trace(trace, {domain_name: domain}, span=span)
        self.cursor = 0

    def __len__(self) -> int:
        return len(self.strikes)

    @property
    def remaining(self) -> int:
        return len(self.strikes) - self.cursor

    def next_time(self) -> Optional[float]:
        if self.cursor >= len(self.strikes):
            return None
        return self.strikes[self.cursor].t

    def reset(self) -> None:
        self.cursor = 0

    def play(self, domain, until: Optional[float] = None
             ) -> Tuple["object", List[BoundStrike]]:
        fired: List[BoundStrike] = []
        while self.cursor < len(self.strikes):
            s = self.strikes[self.cursor]
            if until is not None and s.t > until:
                break
            domain = domain.apply_plan(s.path, s.plan(),
                                       record_hard=s.hard)
            fired.append(s)
            self.cursor += 1
        return domain, fired
