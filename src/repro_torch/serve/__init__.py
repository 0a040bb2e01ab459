"""The online serving plane: router -> continuous-batching scheduler ->
paged HRM-protected KV cache, driven against an SLO while an error storm
fires live.

Counterpart of ``repro.serve``, with the reference's exports.
"""
from repro_torch.serve.engine import (  # noqa: F401
    OnlineEngine, ServiceModel, kv_policy,
)
from repro_torch.serve.metrics import (  # noqa: F401
    SLOCounters, SLOReport, build_report, incorrect_rate,
)
from repro_torch.serve.paged_kv import NULL_PAGE, PagedKVCache  # noqa: F401
from repro_torch.serve.router import RequestRouter  # noqa: F401
from repro_torch.serve.scheduler import (  # noqa: F401
    CompletedRequest, ContinuousBatchingScheduler, SlotState,
)
from repro_torch.serve.traffic import (  # noqa: F401
    Request, TrafficConfig, generate_trace,
)
