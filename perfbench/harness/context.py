"""What a loop is handed, and what it hands back."""

from __future__ import annotations

import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional


@dataclass
class Context:
    root: Path
    cell: Dict
    config: Dict
    traffic: Dict
    limits: Dict
    seed: int
    seconds: float
    trace: bool
    t_start: float            # perf_counter() when the process began its work
    device: Any               # torch.device
    control: Optional[str] = None  # the control: 'w8a8' (renders), 'fp8' (training)

    def log(self, msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)


@dataclass
class Record:
    """A run as the metric readers see it.  Times are perf_counter seconds;
    `jobs` hold each job's start, end, units of output and what the program
    reported for it."""

    setup_s: float
    window_start: float
    deadline: float
    jobs: List[Dict]
    shape: Dict
    trace: Any = None
    checks: List[Dict] = field(default_factory=list)
    attempted: int = 0
    failed: int = 0
    peak_reserved: int = 0
    notes: Dict = field(default_factory=dict)  # readings: every number the check computes
