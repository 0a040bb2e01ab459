"""Quickstart: the unified memory-domain API.

Counterpart of ``examples/quickstart.py``:

  PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
"""
from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.configs import get_tiny
from repro_torch.core import (MemoryDomain, detect_recover,
                              paper_design_availability, paper_design_costs,
                              typical_server)
from repro_torch.examples._common import add_device, same_bits
from repro_torch.models import init_params


def main(argv: Optional[List[str]] = None) -> int:
    ap = add_device(argparse.ArgumentParser(description=__doc__))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # 1. a model's state is a set of HRM *regions*; MemoryDomain.protect
    #    classifies every leaf and materializes the policy's ECC sidecars
    cfg = get_tiny("llama3-8b")
    params = init_params(cfg, seed=0, device=device)
    domain = MemoryDomain.protect(params, typical_server())
    print(domain)
    stats = domain.stats()
    print("regions:", {r: round(b / stats.payload_bytes, 3)
                       for r, b in stats.region_bytes.items()})
    print("sidecar overhead:", f"{stats.overhead:.2%}")

    # 2. a cosmic ray strikes a weight...
    rng = np.random.default_rng(7)
    corrupted, events = domain.inject(rng, 1)
    print("struck:", events[0]["path"])

    # 3. ...the scheduled scrub corrects it in place: one tier-batched
    #    kernel pass over every protected leaf, all roots at once
    fixed, report = corrupted.scrub()
    print("scrub report: corrected=%d uncorrectable=%d" % report.totals())
    restored = same_bits(fixed.payload, params)
    print("bit-exact restore:", restored)

    # 4. with the cheaper Par+R policy, detection triggers a clean-copy
    #    reload
    par_domain = MemoryDomain.protect(params, detect_recover())
    clean = {p: par_domain.leaf(p) for p in par_domain.paths()}
    corrupted2, _ = par_domain.inject(rng, 1)
    scrubbed, rep = corrupted2.scrub()
    _, rec_events = scrubbed.recover(rep, clean_copy=clean.__getitem__)
    print("Par+R events:", rec_events)

    # 5. the Fig-5 economics: what each design point costs and delivers
    costs, avail = paper_design_costs(), paper_design_availability()
    for name in costs:
        print(f"  {name:18s} server_saving={costs[name].server_saving:6.2%} "
              f"availability={avail[name].availability:.4%}")
    if not restored:
        raise AssertionError("the scrub did not restore the struck weight")
    print("QUICKSTART OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
