"""device_idle: the device: the share of the traced window in which no
kernel, copy or memset runs on the card (the union of their spans), %."""
from __future__ import annotations


def read(ctx):
    t = ctx.trace
    if not t or not t.get("window_s") or not t.get("gpu_events"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
