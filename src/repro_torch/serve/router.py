"""Request router: the admission front door of the online plane.

Counterpart of ``repro.serve.router``, copied.

Holds the not-yet-arrived tail of the trace, surfaces requests whose
arrival time has passed into a FIFO admission queue, and applies optional
backpressure (a bounded queue that sheds load instead of growing without
bound: a shed request is a counted SLO violation, not a silent drop).
"""
from __future__ import annotations

from collections import deque
from typing import Deque, List, Optional

from repro_torch.serve.traffic import Request


class RequestRouter:
    def __init__(self, trace: List[Request],
                 max_queue: Optional[int] = None):
        self._pending: Deque[Request] = deque(
            sorted(trace, key=lambda r: r.arrival))
        self.queue: Deque[Request] = deque()
        self.max_queue = max_queue
        self.shed: List[Request] = []
        self.peak_queue = 0

    # ------------------------------------------------------------ intake
    def poll(self, now: float) -> int:
        """Move every request with ``arrival <= now`` into the admission
        queue (or shed it when the queue is at its bound)."""
        n = 0
        while self._pending and self._pending[0].arrival <= now:
            req = self._pending.popleft()
            if self.max_queue is not None and len(self.queue) >= \
                    self.max_queue:
                self.shed.append(req)
            else:
                self.queue.append(req)
                n += 1
        self.peak_queue = max(self.peak_queue, len(self.queue))
        return n

    def next_arrival(self) -> Optional[float]:
        return self._pending[0].arrival if self._pending else None

    # --------------------------------------------------------- admission
    def peek(self) -> Optional[Request]:
        return self.queue[0] if self.queue else None

    def take(self) -> Request:
        return self.queue.popleft()

    def requeue(self, req: Request) -> None:
        """Put a request back at the head (failed admission / crash
        restart)."""
        self.queue.appendleft(req)

    # ------------------------------------------------------------- state
    @property
    def drained(self) -> bool:
        return not self._pending and not self.queue

    def __len__(self) -> int:
        return len(self.queue)
