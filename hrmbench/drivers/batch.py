"""Driver ``batch``: an offline batch, every request due at 0 and more of
them than the window can serve, through the port's ``OnlineEngine``; the
serving clock stops at the window's end. Reports the tokens generated in
the window over its length."""
from __future__ import annotations

from hrmbench.drivers import _serving


def run(ctx) -> dict:
    return _serving.run(ctx, drain=False)
