"""The straggler monitor.

The part of the reference's ``distributed/compression.py`` that the
one-device trainer uses; the int8-compressed data-parallel all-reduce
needs the LM sharding, which the port does not have yet.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class StragglerMonitor:
    """Step-time EWMA monitor.

    In a real deployment each host reports step durations; a step slower
    than ``threshold`` x the EWMA flags its host as a straggler, which the
    orchestrator answers by (1) shrinking that host's data shard
    (rebalance), or (2) promoting a hot spare and re-sharding via the
    checkpoint path. This class implements the detection half and records
    the decisions it would take.
    """

    alpha: float = 0.2
    threshold: float = 2.0
    warmup: int = 5
    ewma: Optional[float] = None
    steps: int = 0
    flags: List[Dict[str, Any]] = field(default_factory=list)

    def record(self, step_time_s: float, host: int = 0) -> bool:
        self.steps += 1
        if self.ewma is None:
            self.ewma = step_time_s
            return False
        is_straggler = (
            self.steps > self.warmup and step_time_s > self.threshold * self.ewma
        )
        if is_straggler:
            self.flags.append(
                {
                    "host": host,
                    "step_time_s": step_time_s,
                    "ewma_s": self.ewma,
                    "action": "rebalance-or-replace",
                    "at_step": self.steps,
                }
            )
        # stragglers do not poison the EWMA
        if not is_straggler:
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * step_time_s
        return is_straggler
