"""Driver ``online``: an open loop of requests, each due at its arrival,
served by the port's ``OnlineEngine`` until every request due in the window
has finished. Reports the tails of time to first token and time per output
token on the serving clock."""
from __future__ import annotations

from hrmbench.drivers import _serving


def run(ctx) -> dict:
    return _serving.run(ctx, drain=True)
