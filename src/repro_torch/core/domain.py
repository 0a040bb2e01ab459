"""Unified memory-domain API: one HRM object over a nested-dict state.

Counterpart of ``repro.core.domain``. A ``MemoryDomain`` owns

    payload          the protected state: nested dicts of tensors, one or
                     several roots (``params``, ``opt``, ``kv_cache``)
    sidecar          per-*tier* concatenated ECC/parity buffers
    hard_errors      live sticky (hard) errors, re-asserted on writes
    spec             static region->tier assignment and buffer layout

and the verbs ``protect``, ``scrub``, ``scrub_partial``, ``inject``,
``apply_plan``, ``reassert_hard``, ``clear_hard``, ``recover``,
``refresh``, ``adopt``, ``with_leaf``, ``stats`` and ``region_profile``.
Every verb returns a new domain and leaves the one it was called on as it
was.

Execution is tier-batched as in the reference: the payload is flattened
once (in ``jax.tree_util`` order, see ``core.tree``), same-tier leaves are
packed into one ``(rows, LANES)`` int64 word buffer per tier, one kernel
launch encodes or scrubs the whole tier, and corrected leaves come back as
views of the corrected buffer. Buffers, sidecars and counts are
byte-identical to the reference's (``tests/test_torch_domain.py``). The
verbs run on the device the state lies on: the CUDA kernels on a card, the
plain PyTorch versions on the CPU. PyTorch runs eagerly, so there is no
compiled-program cache.

Pad rows hold zero words whose code bits are also zero (every tier's code
is linear), so padding contributes no corrections.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, NamedTuple, Optional, \
    Tuple

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.core import tree
from repro_torch.core.costmodel import RegionProfile
from repro_torch.core.errormodel import InjectionPlan
from repro_torch.core.policy import HRMPolicy, classify_path
from repro_torch.core.recovery import (Response, RestartRequired,
                                       RetirementMap, flagged_blocks)
from repro_torch.core.sidecar import ScrubReport, _path_str
from repro_torch.core.tiers import Tier
from repro_torch.kernels import ops
from repro_torch.kernels.burst import burst_encode_words, burst_scrub_words
from repro_torch.kernels.dected import dected_encode_words, dected_scrub_words
from repro_torch.kernels.ops import LANES, _round_rows
from repro_torch.kernels.parity import parity_check_words, parity_encode_words
from repro_torch.kernels.ref import unpack_bits
from repro_torch.kernels.secded import secded_encode_words, secded_scrub_words

# top-level payload keys recognized as roots with their classifier kind
_ROOT_KIND = {"params": "params", "opt": "opt", "kv_cache": "cache",
              "cache": "cache", "graph": "graph"}

class LeafSpec(NamedTuple):
    """Static description of one payload leaf."""
    path: str                  # full path string, root prefix included
    pos: int                   # index into the flattened payload leaves
    region: str                # HRM region (policy granularity)
    tier: Tier
    shape: Tuple[int, ...]
    dtype: str                 # dtype name as numpy spells it ("bfloat16")
    rows: int                  # packed (rows, LANES) 64-bit-word rows
    row_start: int             # row offset in its tier buffer (-1: NONE)

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def nbytes(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n * self.torch_dtype.itemsize


def _classify(path: Tuple[str, ...]) -> str:
    """Region of a full-payload path: the first key selects the root kind
    (``params``/``opt``/``kv_cache``); bare params trees classify whole."""
    if len(path) > 1:
        kind = _ROOT_KIND.get(str(path[0]).lower())
        if kind is not None:
            return classify_path(path[1:], kind)
    return classify_path(path, "params")


def _supported(leaf) -> bool:
    return isinstance(leaf, torch.Tensor) and \
        leaf.dtype.itemsize in (1, 2, 4)


def _dtype_name(leaf) -> str:
    dt = getattr(leaf, "dtype", "float32")
    return str(dt).removeprefix("torch.")


class DomainSpec:
    """Static layout of a domain: policy + leaf table + tier grouping."""
    __slots__ = ("policy", "leaves", "treedef", "groups", "by_path",
                 "protectable", "_byte_weights")

    def __init__(self, policy: HRMPolicy, leaves: Tuple[LeafSpec, ...],
                 treedef):
        self.policy = policy
        self.leaves = leaves
        self.treedef = treedef
        grouped: Dict[Tier, List[LeafSpec]] = {}
        for s in leaves:
            if s.tier is not Tier.NONE:
                grouped.setdefault(s.tier, []).append(s)
        self.groups: Dict[Tier, Tuple[int, Tuple[LeafSpec, ...]]] = {
            t: (_round_rows(sum(x.rows for x in ls)), tuple(ls))
            for t, ls in grouped.items()}
        self.by_path = {s.path: s for s in leaves}
        self.protectable = tuple(s for s in leaves if s.rows > 0)
        w = np.array([s.nbytes for s in self.protectable], dtype=np.float64)
        self._byte_weights = w / w.sum() if w.size and w.sum() > 0 else w

    def paths_key(self, paths: Optional[Iterable[str]]
                  ) -> Optional[Tuple[str, ...]]:
        """Normalize a path subset (in leaf order, protected leaves only);
        None selects every protected leaf."""
        if paths is None:
            return None
        want = set(paths)
        return tuple(s.path for s in self.leaves
                     if s.path in want and s.tier is not Tier.NONE)

    def select(self, key: Optional[Tuple[str, ...]]
               ) -> Dict[Tier, Tuple[LeafSpec, ...]]:
        if key is None:
            return {t: g[1] for t, g in self.groups.items()}
        want = set(key)
        out = {}
        for t, (_, ls) in self.groups.items():
            sel = tuple(s for s in ls if s.path in want)
            if sel:
                out[t] = sel
        return out


# =====================================================================
# tier-batched encode and scrub
# =====================================================================
def _tier_order(groups) -> List[Tier]:
    return sorted(groups, key=lambda t: t.value)


Piece = Tuple[LeafSpec, int, int]   # a leaf and its packed rows [a, b)
_ROW_BYTES = LANES * 8


def _whole(sel: Tuple[LeafSpec, ...]) -> Tuple[Piece, ...]:
    """Every row of each selected leaf."""
    return tuple((s, 0, s.rows) for s in sel)


def _window(sel: Tuple[LeafSpec, ...], lo: int, hi: int
            ) -> Tuple[Piece, ...]:
    """The leaf pieces in rows ``[lo, hi)`` of the selected leaves' rows
    laid end to end, in leaf-local rows."""
    out, off = [], 0
    for s in sel:
        a, b = max(lo - off, 0), min(hi - off, s.rows)
        if a < b:
            out.append((s, a, b))
        off += s.rows
    return tuple(out)


def _leaf_bytes(leaf: torch.Tensor, a: int, b: int) -> torch.Tensor:
    """The bytes of packed rows ``[a, b)`` of ``leaf`` (the leaf's last row
    may be short)."""
    return leaf.reshape(-1).view(torch.uint8)[a * _ROW_BYTES:b * _ROW_BYTES]


def _gather_packed(leaves, pieces: Tuple[Piece, ...], rows: int
                   ) -> torch.Tensor:
    """Pack the pieces, in order, into one (rows, LANES) buffer; rows past
    them are zero."""
    buf = torch.empty((rows, LANES), dtype=torch.int64,
                      device=leaves[pieces[0][0].pos].device)
    off = 0
    for s, a, b in pieces:
        ops.pack_words_into(buf[off:off + b - a],
                            _leaf_bytes(leaves[s.pos], a, b))
        off += b - a
    buf[off:].zero_()
    return buf


def _gather_rows(buf: torch.Tensor, pieces: Tuple[Piece, ...]
                 ) -> torch.Tensor:
    return torch.cat([buf[s.row_start + a:s.row_start + b]
                      for s, a, b in pieces])


def _scatter_rows(buf: torch.Tensor, pieces: Tuple[Piece, ...],
                  new: torch.Tensor) -> torch.Tensor:
    out = buf.clone()
    off = 0
    for s, a, b in pieces:
        out[s.row_start + a:s.row_start + b] = new[off:off + b - a]
        off += b - a
    return out


def _unpack_piece(leaves, piece: Piece, words: torch.Tensor
                  ) -> torch.Tensor:
    """The piece's leaf with its rows replaced by ``words``: a view of
    ``words`` when the piece is the whole leaf, else a copy of the leaf."""
    s, a, b = piece
    if a == 0 and b == s.rows:
        return ops.unpack_words(words, s.shape, s.torch_dtype)
    leaf = leaves[s.pos].reshape(-1).clone()
    dst = _leaf_bytes(leaf, a, b)
    dst.copy_(words.reshape(-1).view(torch.uint8)[:dst.numel()])
    return leaf.reshape(s.shape)


def _encode_tier(tier: Tier, words: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Fresh sidecar buffers of one tier for packed ``words``."""
    if tier is Tier.SECDED:
        return {"ecc": secded_encode_words(words)}
    if tier is Tier.DECTED:
        return {"ecc": dected_encode_words(words)}
    if tier is Tier.BURST:
        return {"ecc": burst_encode_words(words)}
    if tier is Tier.PARITY_R:
        return {"par": parity_encode_words(words)}
    if tier is Tier.MIRROR:
        return {"copy": words, "par": parity_encode_words(words)}
    raise ValueError(tier)


def _scrub_tier_buf(tier: Tier, words: torch.Tensor, pull, push):
    """Run one tier's scrub over a packed (rows, LANES) word buffer.

    ``pull(name)`` / ``push(name, new)`` read and write the sidecar rows
    matching the buffer. Returns per-row ``(words', corrected,
    uncorrectable, data_modified)``: detect-only PARITY_R modifies nothing
    and reports its counts as uncorrectable.
    """
    if tier is Tier.SECDED:
        words2, ecc2, c, u = secded_scrub_words(words, pull("ecc"))
        push("ecc", ecc2)
    elif tier is Tier.DECTED:
        words2, ecc2, c, u = dected_scrub_words(words, pull("ecc"))
        push("ecc", ecc2)
    elif tier is Tier.BURST:
        words2, ecc2, c, u = burst_scrub_words(words, pull("ecc"))
        push("ecc", ecc2)
    elif tier is Tier.PARITY_R:
        _err, cnt = parity_check_words(words, pull("par"))
        return words, torch.zeros_like(cnt), cnt, False
    elif tier is Tier.MIRROR:
        err, _ = parity_check_words(words, pull("par"))
        mask = unpack_bits(err)         # (rows, LANES // 8) -> (rows, LANES)
        words2 = torch.where(mask, pull("copy"), words)
        c = mask.sum(1, dtype=torch.int32)
        u = torch.zeros_like(c)
    else:
        raise ValueError(tier)
    return words2, c, u, True


def _scrub(spec: DomainSpec, key: Optional[Tuple[str, ...]], leaves,
           sidecar, window: Optional[Tuple[int, int]] = None):
    """Scrub the selected leaves, tier-batched: all their rows, or with
    ``window = (idx, slices)`` row slice ``idx`` of ``slices``. Returns
    (modified {pos: leaf}, new sidecar, corrected {path: n},
    uncorrectable {path: n}); the counts are 0-d tensors on the payload's
    device.

    Per tier the window is rows ``[idx*total//slices,
    (idx+1)*total//slices)`` of the selected leaves' rows laid end to end,
    so every tier advances each call and all finish after ``slices`` calls.
    A row holds whole words of one leaf, so no codeword is split."""
    selected = spec.select(key)
    mod: Dict[int, torch.Tensor] = {}
    new_sc = {k: dict(v) for k, v in sidecar.items()}
    corr: Dict[str, torch.Tensor] = {}
    unc: Dict[str, torch.Tensor] = {}
    for tier in _tier_order(selected):
        sel = selected[tier]
        full_rows, full_specs = spec.groups[tier]
        if window is None:
            pieces = _whole(sel)
            is_full = len(sel) == len(full_specs)
        else:
            idx, slices = window
            total = sum(s.rows for s in sel)
            pieces = _window(sel, idx * total // slices,
                             (idx + 1) * total // slices)
            if not pieces:
                continue
            is_full = False
        sc = sidecar[tier.value]

        def pull(name):
            return sc[name] if is_full else _gather_rows(sc[name], pieces)

        def push(name, new):
            new_sc[tier.value][name] = new if is_full else \
                _scatter_rows(sc[name], pieces, new)

        rows = full_rows if is_full else sum(b - a for _, a, b in pieces)
        words = _gather_packed(leaves, pieces, rows)
        words2, c, u, wrote = _scrub_tier_buf(tier, words, pull, push)
        off = 0
        for piece in pieces:
            s, a, b = piece
            sl = slice(off, off + b - a)
            if wrote:
                mod[s.pos] = _unpack_piece(leaves, piece, words2[sl])
                corr[s.path] = c[sl].sum()
            unc[s.path] = u[sl].sum()
            off += b - a
    # paths in sorted order, as the reference's jit program returns them:
    # recovery walks them in this order
    return mod, new_sc, dict(sorted(corr.items())), dict(sorted(unc.items()))


def _encode(spec: DomainSpec, key: Optional[Tuple[str, ...]], leaves,
            sidecar=None):
    """Encode sidecars: every tier's whole buffer (``key`` None), or only
    the rows of the selected leaves, written into a copy of ``sidecar``."""
    selected = spec.select(key)
    if key is None:
        return {tier.value: _encode_tier(tier, _gather_packed(
                    leaves, _whole(selected[tier]), spec.groups[tier][0]))
                for tier in _tier_order(selected)}
    new_sc = {k: dict(v) for k, v in sidecar.items()}
    for tier in _tier_order(selected):
        pieces = _whole(selected[tier])
        fresh = _encode_tier(tier, _gather_packed(
            leaves, pieces, sum(s.rows for s, _, _ in pieces)))
        for name, new in fresh.items():
            new_sc[tier.value][name] = _scatter_rows(
                sidecar[tier.value][name], pieces, new)
    return new_sc


def _as_leaf(value, s: LeafSpec, like: torch.Tensor) -> torch.Tensor:
    """``value`` as leaf ``s``: its shape and dtype, on ``like``'s device."""
    return torch.as_tensor(value, device=like.device).reshape(
        s.shape).to(s.torch_dtype)


def _strikes(plan: InjectionPlan, device) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """The plan's (word, bit) indices as the int64 tensors the bit-flip
    kernel reads, so re-asserting them casts nothing."""
    return (torch.as_tensor(plan.word_idx, dtype=torch.int64, device=device),
            torch.as_tensor(plan.bit_idx, dtype=torch.int64, device=device))


def _record_hard(hard_map, path: str, wi: torch.Tensor, bi: torch.Tensor):
    prev = hard_map.get(path)
    if prev is not None:
        wi = torch.cat([prev["word"], wi])
        bi = torch.cat([prev["bit"], bi])
    hard_map[path] = {"word": wi, "bit": bi}


# =====================================================================
# the domain object
# =====================================================================
@dataclass(frozen=True)
class DomainStats:
    """Measured footprint of a domain (no device sync needed)."""
    payload_bytes: int
    sidecar_bytes: int
    n_leaves: int
    n_protected: int
    n_hard_errors: int
    region_bytes: Dict[str, int]
    region_tiers: Dict[str, str]

    @property
    def overhead(self) -> float:
        return self.sidecar_bytes / max(self.payload_bytes, 1)

    def summary(self) -> str:
        return (f"payload={self.payload_bytes}B sidecar={self.sidecar_bytes}B"
                f" ({self.overhead:.2%}) leaves={self.n_protected}"
                f"/{self.n_leaves} protected, "
                f"hard_errors={self.n_hard_errors}")


class MemoryDomain:
    """A reliability domain: payload + sidecar + policy + hard-error map.

    Functional style: every verb returns a new ``MemoryDomain`` sharing
    untouched tensors, and no verb writes into a tensor it was given.
    """

    def __init__(self, payload, sidecar, hard_errors, spec: DomainSpec):
        self.payload = payload
        self.sidecar = sidecar
        self.hard_errors = hard_errors
        self.spec = spec

    # ------------------------------------------------------- creation
    @classmethod
    def protect(cls, state, policy: HRMPolicy, *,
                roots: Optional[Iterable[str]] = None) -> "MemoryDomain":
        """Classify every leaf of ``state`` into an HRM region, bind each
        region to its policy tier, and materialize the tier sidecars.

        ``state`` may be a single root (a params tree) or a multi-root
        mapping (``{"params": ..., "opt": ..., "kv_cache": ...}``);
        ``roots`` restricts protection to a subset of top-level keys.
        """
        if roots is not None:
            state = {k: state[k] for k in roots}
        flat, treedef = tree.flatten_with_path(state)
        specs: List[LeafSpec] = []
        cursors: Dict[Tier, int] = {}
        for pos, (path, leaf) in enumerate(flat):
            ok = _supported(leaf)
            region = _classify(path)
            tier = policy.tier_of(region) if ok else Tier.NONE
            rows = ops.words_per_tensor(leaf) // LANES if ok else 0
            if tier is Tier.NONE:
                start = -1
            else:
                start = cursors.get(tier, 0)
                cursors[tier] = start + rows
            specs.append(LeafSpec(
                _path_str(path), pos, region, tier,
                tuple(int(d) for d in getattr(leaf, "shape", ())),
                _dtype_name(leaf), rows, start))
        spec = DomainSpec(policy, tuple(specs), treedef)
        leaves = [leaf for _, leaf in flat]
        sidecar = _encode(spec, None, leaves) if spec.groups else {}
        return cls(tree.unflatten(treedef, leaves), sidecar, {}, spec)

    # ------------------------------------------------------ accessors
    @property
    def state(self):
        """The protected payload (alias)."""
        return self.payload

    @property
    def policy(self) -> HRMPolicy:
        return self.spec.policy

    def root(self, name: str):
        return self.payload[name]

    def paths(self, protected_only: bool = False) -> List[str]:
        return [s.path for s in self.spec.leaves
                if not protected_only or s.tier is not Tier.NONE]

    def leaf(self, path: str):
        return self._leaves()[self.spec.by_path[path].pos]

    def region_of(self, path: str) -> str:
        return self.spec.by_path[path].region

    def tier_of(self, path: str) -> Tier:
        return self.spec.by_path[path].tier

    def _leaves(self) -> List:
        return tree.leaves(self.payload)

    def _rebuild(self, leaves, sidecar=None, hard_errors=None
                 ) -> "MemoryDomain":
        return MemoryDomain(
            tree.unflatten(self.spec.treedef, leaves),
            self.sidecar if sidecar is None else sidecar,
            self.hard_errors if hard_errors is None else hard_errors,
            self.spec)

    # ---------------------------------------------------------- scrub
    def scrub(self, step: Optional[int] = None, *,
              paths: Optional[Iterable[str]] = None
              ) -> Tuple["MemoryDomain", Optional[ScrubReport]]:
        """Verify + correct every protected leaf (or the ``paths`` subset),
        one kernel launch per tier.

        With ``step`` given, runs only on the policy's scrub schedule and
        returns ``(self, None)`` off-schedule.
        """
        if step is not None:
            iv = self.spec.policy.scrub_interval
            if iv <= 0 or step % iv != 0:
                return self, None
        return self._scrubbed(paths)

    def scrub_partial(self, cursor: int, *, slices: int = 8,
                      paths: Optional[Iterable[str]] = None
                      ) -> Tuple["MemoryDomain", ScrubReport]:
        """Incremental scrub: verify and correct row slice ``cursor %
        slices`` of the selected leaves (1/``slices`` of each tier's packed
        rows). Called once per iteration with an advancing cursor, it
        completes a full pass every ``slices`` calls with only a slice of
        the work on each iteration's critical path: the scrub/compute
        overlap behind ``pagerank_scrubbed`` and ``bfs_scrubbed``. One
        full cycle corrects what one ``scrub()`` would. Returns (domain,
        ScrubReport of this slice)."""
        if slices <= 1:
            return self.scrub(paths=paths)
        return self._scrubbed(paths, (int(cursor) % slices, int(slices)))

    def _scrubbed(self, paths, window=None
                  ) -> Tuple["MemoryDomain", ScrubReport]:
        with telemetry.span("domain.scrub"):
            if not self.spec.groups:
                return self, ScrubReport()
            leaves = self._leaves()
            mod, new_sc, corr, unc = _scrub(
                self.spec, self.spec.paths_key(paths), leaves, self.sidecar,
                window)
            for pos, leaf in mod.items():
                leaves[pos] = leaf
            report = ScrubReport(corrected=corr, detected_uncorrectable=unc)
            return self._rebuild(leaves, sidecar=new_sc), report

    # -------------------------------------------------------- refresh
    def adopt(self, state) -> "MemoryDomain":
        """Swap in an updated payload with the same structure (sidecar is
        stale until ``refresh``)."""
        if tree.structure(state) != self.spec.treedef:
            raise ValueError("adopted state structure differs from the "
                             "protected payload")
        return MemoryDomain(state, self.sidecar, self.hard_errors, self.spec)

    def with_leaf(self, path: str, value) -> "MemoryDomain":
        """Replace one payload leaf (its sidecar rows are stale until a
        ``refresh(paths=[path])``)."""
        s = self.spec.by_path[path]
        leaves = self._leaves()
        leaves[s.pos] = _as_leaf(value, s, leaves[s.pos])
        return self._rebuild(leaves)

    def refresh(self, state=None, *, paths: Optional[Iterable[str]] = None
                ) -> "MemoryDomain":
        """Re-encode sidecars after legitimate writes (optimizer update,
        clean-copy reload). One batched encode per tier; ``paths`` limits
        the rewrite to the touched leaves."""
        with telemetry.span("domain.refresh"):
            dom = self if state is None else self.adopt(state)
            if not dom.spec.groups:
                return dom
            key = dom.spec.paths_key(paths)
            if key is not None and not key:
                return dom
            sidecar = _encode(dom.spec, key, dom._leaves(), dom.sidecar)
            return MemoryDomain(dom.payload, sidecar, dom.hard_errors,
                                dom.spec)

    # ------------------------------------------------------ injection
    def inject(self, rng, n: int = 1, *, hard: bool = False,
               paths: Optional[Iterable[str]] = None,
               multi_bit_fraction: Optional[float] = None,
               adjacent_fraction: Optional[float] = None,
               errors_per_site: int = 1
               ) -> Tuple["MemoryDomain", List[dict]]:
        """Strike ``n`` random protected-or-not leaves with bit flips,
        sampled byte-weighted, drawing the reference's numpy stream. Hard
        errors are recorded in the hard-error map and re-assert on every
        ``reassert_hard`` until retired.

        ``multi_bit_fraction``/``adjacent_fraction`` default to the
        policy's ``ErrorModel``; pass 0.0 for pure single-bit strikes. A
        strike in a pad word past a leaf's last byte is lost, and still
        counts in the event's ``words``, as in the reference."""
        em = self.spec.policy.error_model
        if multi_bit_fraction is None:
            multi_bit_fraction = em.multi_bit_fraction
        if adjacent_fraction is None:
            adjacent_fraction = em.adjacent_fraction
        rng = np.random.default_rng(rng)
        if paths is None:
            cands = self.spec.protectable
            weights = self.spec._byte_weights
        else:
            want = set(paths)
            cands = tuple(s for s in self.spec.protectable
                          if s.path in want)
            w = np.array([s.nbytes for s in cands], dtype=np.float64)
            weights = w / w.sum() if w.size and w.sum() > 0 else None
        if not cands:
            return self, []
        leaves = self._leaves()
        hard_map = dict(self.hard_errors)
        events = []
        for _ in range(n):
            s = cands[rng.choice(len(cands), p=weights)]
            plan = InjectionPlan.sample(rng, s.rows * LANES,
                                        errors_per_site, hard,
                                        multi_bit_fraction,
                                        adjacent_fraction)
            wi, bi = _strikes(plan, leaves[s.pos].device)
            leaves[s.pos] = ops.inject_bitflips(leaves[s.pos], wi, bi)
            if hard:
                _record_hard(hard_map, s.path, wi, bi)
            events.append({"path": s.path, "hard": hard,
                           "words": int((plan.word_idx >= 0).sum())})
        return self._rebuild(leaves, hard_errors=hard_map), events

    def apply_plan(self, path: str, plan: InjectionPlan, *,
                   record_hard: bool = False) -> "MemoryDomain":
        """Apply a pre-sampled injection plan to one leaf (Fig.2 step 2).

        ``record_hard=True`` additionally registers the flips in the
        hard-error map (sticky: re-asserted by ``reassert_hard`` until
        retired)."""
        with telemetry.span("domain.apply_plan"):
            s = self.spec.by_path[path]
            leaves = self._leaves()
            wi, bi = _strikes(plan, leaves[s.pos].device)
            leaves[s.pos] = ops.inject_bitflips(leaves[s.pos], wi, bi)
            hard_map = self.hard_errors
            if record_hard:
                hard_map = dict(hard_map)
                _record_hard(hard_map, path, wi, bi)
            return self._rebuild(leaves, hard_errors=hard_map)

    def reassert_hard(self) -> "MemoryDomain":
        """Re-apply all sticky errors (call after every program write:
        a damaged cell keeps biting)."""
        if not self.hard_errors:
            return self
        leaves = self._leaves()
        for path, err in self.hard_errors.items():
            s = self.spec.by_path[path]
            leaves[s.pos] = ops.inject_bitflips(
                leaves[s.pos], err["word"], err["bit"])
        return self._rebuild(leaves)

    def clear_hard(self, path: Optional[str] = None) -> "MemoryDomain":
        if path is None:
            hard = {}
        else:
            hard = {k: v for k, v in self.hard_errors.items() if k != path}
        return MemoryDomain(self.payload, self.sidecar, hard, self.spec)

    # ------------------------------------------------------- recovery
    def recover(self, report: ScrubReport, *,
                clean_copy: Callable[[str], Any],
                response: Response = Response.RELOAD_CLEAN_COPY,
                strikes: Optional[Dict[str, int]] = None,
                retirement: Optional[RetirementMap] = None,
                retire_after: int = 3,
                needs: Optional[Dict[str, int]] = None
                ) -> Tuple["MemoryDomain", List[dict]]:
        """Software response to detected-uncorrectable errors (Table 2):
        reload flagged leaves from a clean copy (disk checkpoint, or a peer
        replica under ``Response.PEER_COPY``), re-encode their sidecar
        rows, and escalate recurring offenders to block retirement,
        clearing their sticky errors.

        Pass ``needs`` (a precomputed ``report.needs_recovery()``) to
        avoid fetching the per-leaf counters again."""
        with telemetry.span("domain.recover"):
            if needs is None:
                needs = report.needs_recovery()
            if not needs:
                return self, []
            if response is Response.CONSUME:
                return self, [{"action": "consume", "paths": list(needs)}]
            if response is Response.RESTART:
                raise RestartRequired(str(list(needs)))
            leaves = self._leaves()
            hard_map = dict(self.hard_errors)
            events = []
            for path, n_words in needs.items():
                s = self.spec.by_path[path]
                if strikes is not None:
                    strikes[path] = strikes.get(path, 0) + 1
                # in storage of its own: a caller that writes the payload in
                # place (the serving engine's KV pools) never reaches the copy
                clean = _as_leaf(clean_copy(path), s, leaves[s.pos]).clone()
                action = ("peer_copy" if response is Response.PEER_COPY
                          else "reload_clean_copy")
                if strikes is not None and strikes[path] >= retire_after:
                    if retirement is not None:
                        # retire the damaged 512-byte blocks: the diff of the
                        # still-corrupted leaf against its clean replacement
                        for block in flagged_blocks(leaves[s.pos], clean):
                            retirement.retire(path, block)
                    # retired blocks are remapped: their sticky cells stop
                    # biting (page-offlining analogue)
                    hard_map.pop(path, None)
                    action += "+retire"
                leaves[s.pos] = clean
                events.append({"action": action, "path": path,
                               "words": int(n_words)})
            dom = self._rebuild(leaves, hard_errors=hard_map)
            return dom.refresh(paths=list(needs)), events

    # ---------------------------------------------------------- stats
    def stats(self) -> DomainStats:
        region_bytes: Dict[str, int] = {}
        region_tiers: Dict[str, str] = {}
        for s in self.spec.leaves:
            region_bytes[s.region] = region_bytes.get(s.region, 0) + s.nbytes
            region_tiers[s.region] = s.tier.value
        sc_bytes = sum(v.numel() * v.element_size()
                       for tier_buf in self.sidecar.values()
                       for v in tier_buf.values())
        return DomainStats(
            payload_bytes=sum(s.nbytes for s in self.spec.leaves),
            sidecar_bytes=int(sc_bytes),
            n_leaves=len(self.spec.leaves),
            n_protected=sum(1 for s in self.spec.leaves
                            if s.tier is not Tier.NONE),
            n_hard_errors=len(self.hard_errors),
            region_bytes=region_bytes,
            region_tiers=region_tiers)

    def region_profile(self) -> RegionProfile:
        """Measured byte fraction per region (drives the cost model)."""
        stats = self.stats()
        total = max(stats.payload_bytes, 1)
        return RegionProfile({r: b / total
                              for r, b in stats.region_bytes.items()})

    def __repr__(self) -> str:
        tiers = sorted(t.value for t in self.spec.groups)
        return (f"MemoryDomain(policy={self.spec.policy.name!r}, "
                f"leaves={len(self.spec.leaves)}, tiers={tiers}, "
                f"hard_errors={len(self.hard_errors)})")
