"""Sharded memory domain + replication-aware PEER_COPY recovery.

Counterpart of ``examples/sharded_domain.py``. Lays one HRM domain out as
2 replicas x 4 shards, strikes one replica, and recovers the flagged
leaves with a device-to-device copy from the live peer replica: no disk
involved.

``--placement mesh`` (the default) puts each (replica, shard) cell on its
own CUDA device of a ``(data, model)`` mesh, and needs 8 of them: with
fewer it raises, and it takes no ``--device``. ``--placement virtual`` runs
the same 2 x 4 structure on ``--device``:

  PYTHONPATH=src python -m repro_torch.examples.sharded_domain
  PYTHONPATH=src python -m repro_torch.examples.sharded_domain \\
      --placement virtual --device cpu
"""
from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.configs import get_tiny
from repro_torch.core import ShardedMemoryDomain, peer_dr_l
from repro_torch.examples._common import add_device, same_bits
from repro_torch.launch.mesh import make_domain_mesh
from repro_torch.models import init_params

N_REPLICAS, N_SHARDS = 2, 4


def main(argv: Optional[List[str]] = None) -> int:
    ap = add_device(argparse.ArgumentParser(description=__doc__))
    ap.add_argument("--placement", choices=("mesh", "virtual"),
                    default="mesh")
    args = ap.parse_args(argv)
    if args.placement == "mesh" and args.device is not None:
        ap.error("--device applies to --placement virtual only: the mesh "
                 "places each cell on its own card")

    # 1. shard one logical domain over a (data=2, model=4) grid: leaves
    #    partition byte-balanced over the model axis, sidecars travel with
    #    their leaves, and the data axis carries two full replicas
    mesh = None
    if args.placement == "mesh":
        mesh = make_domain_mesh(n_replicas=N_REPLICAS, n_shards=N_SHARDS)
        device = mesh.devices[0, 0]
    else:
        device = resolve_device(args.device)
    cfg = get_tiny("llama3-8b")
    params = init_params(cfg, seed=0, device=device)
    sh = ShardedMemoryDomain.protect(params, peer_dr_l(), mesh=mesh,
                                     n_replicas=N_REPLICAS,
                                     n_shards=N_SHARDS)
    print(sh)
    phys = sh.physical_stats()
    print(f"fleet: {phys['n_replicas']} replicas x {phys['n_shards']} "
          f"shards, {phys['payload_bytes'] / 1e6:.1f} MB payload "
          f"(+{phys['sidecar_bytes'] / 1e6:.2f} MB sidecar)")

    # 2. strike replica 0; the per-shard tier-batched scrub aggregates
    #    every cell's report into one domain-level ScrubReport
    rng = np.random.default_rng(7)
    sh, events = sh.inject(rng, 3, replica=0)
    print("struck:", [(e["replica"], e["path"]) for e in events])
    sh, report = sh.scrub()
    c, u = report.totals()
    print(f"aggregated scrub: corrected={c} detected_uncorrectable={u}")
    needs = report.needs_recovery()
    if 0 not in needs or 1 in needs:
        raise AssertionError(f"flagged replicas {sorted(needs)}, not [0]")

    # 3. PEER_COPY: the flagged leaves take their clean bytes from the
    #    live replica 1, device to device; disk never touched
    sh, rec = sh.recover(report)
    for e in rec:
        print(f"  {e['action']}: replica{e['replica']}/{e['path']} "
              f"<- replica{e['donor']}")
    if not all(e["action"] == "peer_copy" for e in rec):
        raise AssertionError(f"not every recovery was a peer copy: {rec}")

    # 4. the recovered replica is bit-identical to the original state
    restored = same_bits(sh.state(0), params)
    print("bit-exact peer restore:", restored)
    if not restored:
        raise AssertionError("the peer copy did not restore replica 0")
    _, rep2 = sh.scrub()
    if rep2.totals() != (0, 0):
        raise AssertionError(f"a second scrub found {rep2.totals()}")
    print("SHARDED SMOKE OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
