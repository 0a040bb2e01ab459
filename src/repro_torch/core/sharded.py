"""Sharded memory domains with replication-aware recovery.

Counterpart of ``repro.core.sharded``. ``ShardedMemoryDomain`` lays one
logical HRM domain out as replicas x shards: leaves partition at leaf
granularity over the shards (each shard's tier sidecars live with its
leaves, so sidecar rows partition with their payload rows), and the whole
domain replicates over the replicas. Each (replica, shard) cell is a plain
``MemoryDomain``, so every verb reuses its kernels unchanged, and the scrub
of a cell packs only that shard's bytes.

Per-word ECC math is position-independent, so scrubbing shard by shard and
summing the per-shard ``ScrubReport``s (``ShardedScrubReport``) gives the
unsharded domain's counts path for path (``tests/test_torch_sharded.py``).

Replication makes ``Response.PEER_COPY`` real: a leaf flagged
detected-uncorrectable on one replica recovers from a replica whose copy
of it is clean, a device-to-device copy onto the flagged replica's device,
and falls back to ``RELOAD_CLEAN_COPY`` only when every replica of the leaf
is flagged at once.

Placement: pass a mesh with ``data`` and ``model`` axes
(``launch.mesh.make_domain_mesh``, or a hand-built ``DomainMesh``) to put
each cell's leaves on its own device. Without one the same structure runs
on the devices the state lies on ("virtual" mode), and the replicas start
from the same cells: no verb writes into a tensor it was given, so they
part only where a verb returns new leaves.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import tree
from repro_torch.core.costmodel import RegionProfile
from repro_torch.core.domain import DomainStats, MemoryDomain
from repro_torch.core.errormodel import InjectionPlan
from repro_torch.core.policy import HRMPolicy
from repro_torch.core.recovery import (Response, RestartRequired,
                                       RetirementMap, flagged_blocks)
from repro_torch.core.sidecar import ScrubReport, _path_str
from repro_torch.core.tiers import Tier
from repro_torch.launch.mesh import mesh_grid


# =====================================================================
# aggregated scrub report
# =====================================================================
@dataclass(frozen=True)
class ShardedScrubReport:
    """Per-shard scrub results aggregated across a sharded domain.

    ``replicas[r]`` is replica ``r``'s merged report (its shards' path
    sets are disjoint, so merging is a union); ``per_shard[r][s]`` keeps
    the raw per-cell reports; ``domain_report()`` folds everything into
    one domain-level ``ScrubReport`` (counts sum across replicas)."""
    replicas: Tuple[ScrubReport, ...]
    per_shard: Tuple[Tuple[ScrubReport, ...], ...]

    def domain_report(self) -> ScrubReport:
        return ScrubReport.merged(self.replicas)

    def totals(self) -> Tuple[int, int]:
        return self.domain_report().totals()

    def needs_recovery(self) -> Dict[int, Dict[str, int]]:
        """{replica: {path: n_flagged_words}} over non-clean replicas."""
        out = {}
        for r, rep in enumerate(self.replicas):
            needs = rep.needs_recovery()
            if needs:
                out[r] = needs
        return out


def _nest(entries: List[Tuple[str, Any]]) -> Dict:
    """Rebuild a nested dict state from ``(path_str, leaf)`` pairs. Path
    segments become dict keys, so the re-flattened path strings (and with
    them region classification) match the unsharded domain's exactly."""
    out: Dict = {}
    for pstr, leaf in entries:
        node = out
        parts = pstr.split("/")
        for k in parts[:-1]:
            node = node.setdefault(k, {})
        node[parts[-1]] = leaf
    return out


def _leaf_bytes(leaf) -> int:
    if not isinstance(leaf, torch.Tensor):
        return 0
    return leaf.numel() * leaf.element_size()


# =====================================================================
# the sharded domain
# =====================================================================
class ShardedMemoryDomain:
    """A logical ``MemoryDomain`` laid out as replicas x shards of local
    domains. Functional style like ``MemoryDomain``: every verb returns a
    new ``ShardedMemoryDomain`` sharing untouched cells."""

    def __init__(self, shards, shard_of: Dict[str, int],
                 order: Tuple[str, ...], treedef, devices=None):
        self.shards: Tuple[Tuple[MemoryDomain, ...], ...] = tuple(
            tuple(row) for row in shards)
        self.shard_of = shard_of          # path -> shard index
        self.order = order                # original flatten order
        self.treedef = treedef            # original (unsharded) treedef
        self.devices = devices            # [replica][shard] or None

    # ------------------------------------------------------- creation
    @classmethod
    def protect(cls, state, policy: HRMPolicy, *,
                mesh=None,
                n_replicas: Optional[int] = None,
                n_shards: Optional[int] = None,
                roots: Optional[Iterable[str]] = None,
                replica_axis: str = "data",
                shard_axis: str = "model") -> "ShardedMemoryDomain":
        """Shard ``state`` over ``mesh``'s (``data``, ``model``) axes.

        Leaves partition greedily balanced by bytes over ``n_shards``
        (default: the mesh's ``model`` axis size), and the whole domain is
        replicated ``n_replicas`` times (default: the ``data`` axis size).
        Without a mesh the same structure is built on the devices the
        leaves lie on (``n_replicas``/``n_shards`` default to 2).
        """
        if roots is not None:
            state = {k: state[k] for k in roots}
        devices = None
        if mesh is not None:
            grid = mesh_grid(mesh, replica_axis, shard_axis)
            n_replicas = grid.shape[0] if n_replicas is None else n_replicas
            n_shards = grid.shape[1] if n_shards is None else n_shards
            if n_replicas > grid.shape[0] or n_shards > grid.shape[1]:
                raise ValueError(
                    f"requested {n_replicas}x{n_shards} exceeds the mesh "
                    f"grid {grid.shape[0]}x{grid.shape[1]}")
            devices = tuple(tuple(grid[r, s] for s in range(n_shards))
                            for r in range(n_replicas))
        n_replicas = 2 if n_replicas is None else n_replicas
        n_shards = 2 if n_shards is None else n_shards
        if n_replicas < 1 or n_shards < 1:
            raise ValueError("need at least one replica and one shard")

        flat, treedef = tree.flatten_with_path(state)
        entries = [(_path_str(p), leaf) for p, leaf in flat]
        order = tuple(p for p, _ in entries)

        # greedy balanced partition: largest leaf to the lightest shard
        # (deterministic: ties break on path, then lowest shard index)
        by_size = sorted(range(len(entries)),
                         key=lambda i: (-_leaf_bytes(entries[i][1]),
                                        entries[i][0]))
        loads = [0] * n_shards
        shard_of: Dict[str, int] = {}
        for i in by_size:
            s = min(range(n_shards), key=lambda j: (loads[j], j))
            shard_of[entries[i][0]] = s
            loads[s] += _leaf_bytes(entries[i][1])

        rows: List[List[MemoryDomain]] = []
        for r in range(n_replicas):
            if r and devices is None:
                # virtual mode: the replicas start from the same cells
                rows.append(list(rows[0]))
                continue
            row = []
            for s in range(n_shards):
                sub = _nest([(p, leaf) for p, leaf in entries
                             if shard_of[p] == s])
                if devices is not None:
                    dev = devices[r][s]
                    sub = tree.map_leaves(
                        lambda x: x.to(dev) if isinstance(x, torch.Tensor)
                        else x, sub)
                row.append(MemoryDomain.protect(sub, policy))
            rows.append(row)
        return cls(rows, shard_of, order, treedef, devices)

    # ------------------------------------------------------ accessors
    @property
    def n_replicas(self) -> int:
        return len(self.shards)

    @property
    def n_shards(self) -> int:
        return len(self.shards[0])

    @property
    def policy(self) -> HRMPolicy:
        return self.shards[0][0].spec.policy

    def _with(self, shards) -> "ShardedMemoryDomain":
        return ShardedMemoryDomain(shards, self.shard_of, self.order,
                                   self.treedef, self.devices)

    def _cell(self, path: str, replica: int) -> MemoryDomain:
        return self.shards[replica][self.shard_of[path]]

    def paths(self, protected_only: bool = False) -> List[str]:
        if not protected_only:
            return list(self.order)
        keep = set()
        for dom in self.shards[0]:
            keep.update(dom.paths(protected_only=True))
        return [p for p in self.order if p in keep]

    def leaf(self, path: str, replica: int = 0):
        return self._cell(path, replica).leaf(path)

    def region_of(self, path: str) -> str:
        return self._cell(path, 0).region_of(path)

    def tier_of(self, path: str) -> Tier:
        return self._cell(path, 0).tier_of(path)

    def state(self, replica: int = 0):
        """Reassemble replica ``replica``'s payload into the original
        (unsharded) tree structure, the leaves where their cells hold
        them."""
        leaves = [self.leaf(p, replica) for p in self.order]
        return tree.unflatten(self.treedef, leaves)

    # ---------------------------------------------------------- scrub
    def scrub(self, step: Optional[int] = None, *,
              paths: Optional[Iterable[str]] = None
              ) -> Tuple["ShardedMemoryDomain",
                         Optional[ShardedScrubReport]]:
        """Run the tier-batched scrub per shard on every replica and
        aggregate the per-shard reports (``ShardedScrubReport``). Same
        schedule semantics as ``MemoryDomain.scrub``."""
        if step is not None:
            iv = self.policy.scrub_interval
            if iv <= 0 or step % iv != 0:
                return self, None
        want = None if paths is None else set(paths)
        new = [list(row) for row in self.shards]
        per_shard: List[Tuple[ScrubReport, ...]] = []
        per_replica: List[ScrubReport] = []
        for r in range(self.n_replicas):
            reps = []
            for s in range(self.n_shards):
                sel = None
                if want is not None:
                    sel = [p for p in want if self.shard_of.get(p) == s]
                    if not sel:
                        reps.append(ScrubReport())
                        continue
                new[r][s], rep = new[r][s].scrub(paths=sel)
                reps.append(rep)
            per_shard.append(tuple(reps))
            per_replica.append(ScrubReport.merged(reps))
        return self._with(new), ShardedScrubReport(tuple(per_replica),
                                                   tuple(per_shard))

    # -------------------------------------------------------- refresh
    def refresh(self, *, paths: Optional[Iterable[str]] = None,
                replica: Optional[int] = None) -> "ShardedMemoryDomain":
        new = [list(row) for row in self.shards]
        for r in range(self.n_replicas):
            if replica is not None and r != replica:
                continue
            for s in range(self.n_shards):
                sel = None
                if paths is not None:
                    sel = [p for p in paths if self.shard_of.get(p) == s]
                    if not sel:
                        continue
                new[r][s] = new[r][s].refresh(paths=sel)
        return self._with(new)

    # ------------------------------------------------------ injection
    def inject(self, rng, n: int = 1, *, replica: int = 0,
               hard: bool = False,
               paths: Optional[Iterable[str]] = None,
               **kwargs) -> Tuple["ShardedMemoryDomain", List[dict]]:
        """Strike ``n`` random protected leaves of one replica, sampled
        byte-weighted across all its shards (errors strike uniformly over
        that replica's physical bytes), drawing the reference's numpy
        stream."""
        rng = np.random.default_rng(rng)
        want = None if paths is None else set(paths)
        cands: List[Tuple[int, str]] = []
        weights: List[float] = []
        for s, dom in enumerate(self.shards[replica]):
            for ls in dom.spec.protectable:
                if want is None or ls.path in want:
                    cands.append((s, ls.path))
                    weights.append(float(ls.nbytes))
        if not cands:
            return self, []
        w = np.asarray(weights, dtype=np.float64)
        w = w / w.sum()
        new = [list(row) for row in self.shards]
        events: List[dict] = []
        for _ in range(n):
            s, path = cands[rng.choice(len(cands), p=w)]
            new[replica][s], evs = new[replica][s].inject(
                rng, 1, hard=hard, paths=[path], **kwargs)
            for e in evs:
                e["replica"] = replica
            events.extend(evs)
        return self._with(new), events

    def apply_plan(self, path: str, plan: InjectionPlan, *,
                   replica: int = 0, record_hard: bool = False
                   ) -> "ShardedMemoryDomain":
        """Apply a pre-sampled injection plan to one replica's leaf. Word
        indices are leaf-local, so the same plan hits the same bits as on
        an unsharded domain."""
        s = self.shard_of[path]
        new = [list(row) for row in self.shards]
        new[replica][s] = new[replica][s].apply_plan(
            path, plan, record_hard=record_hard)
        return self._with(new)

    def reassert_hard(self, replica: Optional[int] = None
                      ) -> "ShardedMemoryDomain":
        new = [list(row) for row in self.shards]
        for r in range(self.n_replicas):
            if replica is not None and r != replica:
                continue
            for s in range(self.n_shards):
                new[r][s] = new[r][s].reassert_hard()
        return self._with(new)

    # ------------------------------------------------------- recovery
    def recover(self, report: Optional[ShardedScrubReport], *,
                clean_copy=None,
                response: Response = Response.PEER_COPY,
                strikes: Optional[Dict[str, int]] = None,
                retirement: Optional[RetirementMap] = None,
                retire_after: int = 3,
                needs: Optional[Dict[int, Dict[str, int]]] = None
                ) -> Tuple["ShardedMemoryDomain", List[dict]]:
        """Replication-aware software response (Table 2).

        Under ``Response.PEER_COPY`` every flagged (replica, leaf) picks a
        live donor replica whose copy of that leaf is not flagged and
        copies it onto the flagged replica's device. When *every* replica
        of a leaf is flagged at once, the event falls back to
        ``clean_copy`` (the disk path, named ``reload_clean_copy``); with
        no ``clean_copy`` either, ``RestartRequired``. Strike counts and
        retirement are kept per (replica, leaf) under
        ``"replica{r}/{path}"`` keys; escalation retires the damaged
        512-byte blocks and clears the replica's sticky errors, as the
        single-domain path does. Every reloaded leaf is a copy in storage
        of its own: a caller that writes one in place reaches neither the
        donor nor the clean copy.
        """
        if needs is None:
            needs = report.needs_recovery() if report is not None else {}
        needs = {r: dict(v) for r, v in needs.items() if v}
        if not needs:
            return self, []
        if response is Response.CONSUME:
            return self, [{"action": "consume", "replica": r,
                           "paths": list(v)} for r, v in needs.items()]
        if response is Response.RESTART:
            raise RestartRequired(str({r: list(v)
                                       for r, v in needs.items()}))
        new = [list(row) for row in self.shards]
        touched: Dict[Tuple[int, int], List[str]] = {}
        events: List[dict] = []
        for r in sorted(needs):
            for path, n_words in needs[r].items():
                s = self.shard_of[path]
                key = f"replica{r}/{path}"
                if strikes is not None:
                    strikes[key] = strikes.get(key, 0) + 1
                donor = None
                if response is Response.PEER_COPY and self.n_replicas > 1:
                    donor = next(
                        (r2 for r2 in range(self.n_replicas)
                         if r2 != r and path not in needs.get(r2, {})),
                        None)
                if donor is not None:
                    clean = new[donor][s].leaf(path)
                    action = "peer_copy"
                elif clean_copy is not None:
                    clean = clean_copy(path)
                    action = "reload_clean_copy"
                else:
                    raise RestartRequired(
                        f"{key}: no live donor replica and no clean_copy")
                dom = new[r][s]
                spec = dom.spec.by_path[path]
                # one copy, onto the flagged cell's device: the donor's
                # leaf and the caller's clean copy stay untouched
                clean = torch.as_tensor(clean).to(
                    device=dom.leaf(path).device, dtype=spec.torch_dtype,
                    copy=True).reshape(spec.shape)
                if strikes is not None and strikes[key] >= retire_after:
                    if retirement is not None:
                        for block in flagged_blocks(dom.leaf(path), clean):
                            retirement.retire(key, block)
                    dom = dom.clear_hard(path)
                    action += "+retire"
                new[r][s] = dom.with_leaf(path, clean)
                touched.setdefault((r, s), []).append(path)
                event = {"action": action, "path": path, "replica": r,
                         "words": int(n_words)}
                if donor is not None:
                    event["donor"] = donor
                events.append(event)
        for (r, s), ps in touched.items():
            new[r][s] = new[r][s].refresh(paths=ps)
        return self._with(new), events

    # ---------------------------------------------------------- stats
    def stats(self, replica: int = 0) -> DomainStats:
        """Logical (one-replica) footprint, aggregated across shards:
        payload and region bytes equal the unsharded domain's (sidecar
        bytes may differ by per-shard padding rows)."""
        parts = [dom.stats() for dom in self.shards[replica]]
        region_bytes: Dict[str, int] = {}
        region_tiers: Dict[str, str] = {}
        for st in parts:
            for k, v in st.region_bytes.items():
                region_bytes[k] = region_bytes.get(k, 0) + v
            region_tiers.update(st.region_tiers)
        return DomainStats(
            payload_bytes=sum(st.payload_bytes for st in parts),
            sidecar_bytes=sum(st.sidecar_bytes for st in parts),
            n_leaves=sum(st.n_leaves for st in parts),
            n_protected=sum(st.n_protected for st in parts),
            n_hard_errors=sum(st.n_hard_errors for st in parts),
            region_bytes=region_bytes,
            region_tiers=region_tiers)

    def physical_stats(self) -> Dict[str, int]:
        """Whole-fleet footprint: replication multiplies the capacity (the
        premium the ``peer_dr_l`` design point trades against cheaper
        local tiers; the replicas already exist for data parallelism)."""
        payload = sidecar = 0
        for row in self.shards:
            for dom in row:
                st = dom.stats()
                payload += st.payload_bytes
                sidecar += st.sidecar_bytes
        return {"payload_bytes": payload, "sidecar_bytes": sidecar,
                "n_replicas": self.n_replicas, "n_shards": self.n_shards}

    def region_profile(self, replica: int = 0) -> RegionProfile:
        st = self.stats(replica)
        total = max(st.payload_bytes, 1)
        return RegionProfile({r: b / total
                              for r, b in st.region_bytes.items()})

    def __repr__(self) -> str:
        placed = "mesh" if self.devices is not None else "virtual"
        return (f"ShardedMemoryDomain(policy={self.policy.name!r}, "
                f"replicas={self.n_replicas}, shards={self.n_shards}, "
                f"leaves={len(self.order)}, placement={placed})")
