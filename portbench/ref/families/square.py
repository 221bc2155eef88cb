"""Square's public instance: signal^2 mod r."""
from __future__ import annotations

from ..circuits import signal as classes
from ..fields.bn254 import R


def instances(config, request) -> list[list[int]]:
    return [[request["signal"] * request["signal"] % R]]
