"""What the serving cells' readers share: the engine calls that started
in the window, and each request's engine call."""

from __future__ import annotations

from typing import Dict, List


def window_calls(data: Dict) -> List[Dict]:
    """Engine calls that started inside the measured window."""
    t0, t1 = data["window"]
    return [c for c in data["calls"] if t0 <= c["start"] < t1]


def taken_at(data: Dict) -> Dict[int, float]:
    """Request id -> the start of the engine call that took it."""
    return {rid: c["start"] for c in data["calls"] for rid in c["ids"]}
