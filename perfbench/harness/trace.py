"""The traced run: torch.profiler over the CPU and the card, read from its
raw (Kineto) events, never exported to disk.

`Trace` collects, on one clock (nanoseconds since the epoch, the clock of
time.time_ns()):

* the device operations (kernels, copies, memsets), each with its name;
* the harness's own spans (record_function ranges named `perfbench.*`),
  which label the idle gaps by what the host was doing.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional, Tuple

from . import stats

SPAN_PREFIX = "perfbench."


class Trace:
    def __init__(self):
        self.device_ops: List[Tuple[str, int, int]] = []  # (name, start_ns, end_ns)
        self.spans: List[Tuple[str, int, int]] = []
        self.start_ns = 0
        self.end_ns = 0

    # -- reading -----------------------------------------------------------

    def busy_ns(self) -> int:
        return int(stats.union_length([(s, e) for _, s, e in self.clipped()]))

    def clipped(self) -> List[Tuple[str, int, int]]:
        """Device operations cut to the traced window."""
        out = []
        for name, s, e in self.device_ops:
            s, e = max(s, self.start_ns), min(e, self.end_ns)
            if e > s:
                out.append((name, s, e))
        return out

    def device_seconds(self, match) -> Tuple[float, int]:
        """(seconds, count) of the device operations whose name match(name)
        accepts, inside the window."""
        total, n = 0, 0
        for name, s, e in self.clipped():
            if match(name):
                total += e - s
                n += 1
        return total / 1e9, n

    def top_ops(self, k: int = 10) -> List[List]:
        by_name: Dict[str, int] = defaultdict(int)
        for name, s, e in self.clipped():
            by_name[name] += e - s
        ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:k]
        return [[name[:120], ns / 1e9] for name, ns in ranked]

    def idle_gaps(self, k: int = 10) -> List[List]:
        """The longest stretches with no device operation, each named by the
        innermost harness span around its start ("outside spans" if none)."""
        holes = stats.gaps([(s, e) for _, s, e in self.clipped()], self.start_ns,
                           self.end_ns)
        holes.sort(key=lambda g: -(g[1] - g[0]))
        out = []
        for s, e in holes[:k]:
            around = [sp for sp in self.spans if sp[1] <= s < sp[2]]
            label = min(around, key=lambda sp: sp[2] - sp[1])[0] if around else "outside spans"
            out.append([label, (e - s) / 1e9])
        return out


@contextlib.contextmanager
def traced(enabled: bool, sync) -> Iterator[Optional[Trace]]:
    """Profile the enclosed work when enabled (CPU and CUDA activities);
    yields the Trace, filled when the block ends.  sync() waits for the
    device before the window's end is read."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    import torch

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    tr = Trace()
    with profile(activities=activities) as prof:
        sync()
        tr.start_ns = time.time_ns()
        yield tr
        sync()
        tr.end_ns = time.time_ns()
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        on_device = str(ev.device_type()).endswith("CUDA")
        if name.startswith(SPAN_PREFIX):
            if not on_device:  # the GPU-side copy of a range is no device work
                tr.spans.append((name[len(SPAN_PREFIX):], ev.start_ns(), ev.end_ns()))
        elif on_device and not _is_annotation(ev) and not name.startswith("Command Buffer"):
            tr.device_ops.append((name, ev.start_ns(), ev.end_ns()))


def _is_annotation(ev) -> bool:
    """A user range mirrored onto the device timeline (newer PyTorch names
    the activity; older ones only flag it)."""
    kind = getattr(ev, "activity_type", None)
    if kind is not None and "annotation" in str(kind()):
        return True
    flag = getattr(ev, "is_user_annotation", None)
    return bool(flag()) if flag is not None else False

def span(name: str):
    """A harness span in the traced run (a no-op range otherwise)."""
    from torch.profiler import record_function

    return record_function(SPAN_PREFIX + name)
