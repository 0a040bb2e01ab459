"""The traced window of a ``--trace 1`` run: ``torch.profiler`` over a
stretch of the window, reduced to what the per-layer metrics read.

Device busy time is the union of the device operations' intervals (the
harness's own labels, which the profiler also puts on the device's
timeline, are left out); an idle gap between two of them is charged to
the innermost harness span (``record_function`` label) the host was in at
the gap's middle, or to ``host`` outside every span. Kernel time is summed
by kernel name.
"""
from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch


def sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Window:
    """``start()`` .. ``stop()`` under the profiler; then ``busy_s``,
    ``window_s``, ``kernels`` ({name: [device s, count]}), ``top_ops`` and
    ``idle_by_host``."""

    def __init__(self, device: torch.device):
        self.device = device
        self.prof = None
        self.window_s = None
        self.active = False

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        sync()
        self.prof = profile(activities=acts)
        self.prof.start()
        self.t0 = time.perf_counter()
        self.active = True

    def stop(self) -> None:
        sync()
        self.window_s = time.perf_counter() - self.t0
        self.prof.stop()
        self.active = False
        self._reduce(self.prof.profiler.kineto_results.events())
        self.prof = None

    def _reduce(self, events) -> None:
        from torch.autograd import DeviceType
        dev: List[Tuple[int, int]] = []
        spans: List[Tuple[int, int, str]] = []
        kernels: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
        for e in events:
            if e.is_user_annotation():
                # a harness label: its device-side copy spans the label's
                # kernels and is no operation of its own
                if e.device_type() == DeviceType.CPU:
                    spans.append((e.start_ns(),
                                  e.start_ns() + e.duration_ns(), e.name()))
            elif e.device_type() == DeviceType.CUDA:
                s, d = e.start_ns(), e.duration_ns()
                if d <= 0:
                    continue
                dev.append((s, s + d))
                k = kernels[e.name()]
                k[0] += d * 1e-9
                k[1] += 1
        dev.sort()
        busy = 0
        gaps: List[Tuple[int, int]] = []
        cur_s = cur_e = None
        for s, e in dev:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                    gaps.append((cur_e, s))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        self.busy_s = busy * 1e-9
        self.kernels = dict(kernels)
        self.top_ops = sorted(([n, v[0]] for n, v in kernels.items()),
                              key=lambda x: -x[1])[:10]
        idle: Dict[str, float] = defaultdict(float)
        spans.sort()
        i, active = 0, []
        for a, b in gaps:                      # ascending, as dev was
            mid = (a + b) // 2
            while i < len(spans) and spans[i][0] <= mid:
                active.append(spans[i])
                i += 1
            active = [sp for sp in active if sp[1] >= mid]
            label = min(active, key=lambda sp: sp[1] - sp[0])[2] \
                if active else "host"
            idle[label] += (b - a) * 1e-9
        self.idle_by_host = sorted(([n, v] for n, v in idle.items()),
                                   key=lambda x: -x[1])[:10]
