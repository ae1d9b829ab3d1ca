"""What a per-layer metric's reader gets: the run's spans, counters and
trace summary, and the work counts of the traced calls."""
from __future__ import annotations

import dataclasses

from perfbench.harness.bench import Cell
from perfbench.harness.record import OpRecorder
from perfbench.harness.trace import Summary


@dataclasses.dataclass
class Context:
    cell: Cell
    window_s: float                 # the measured window, host clock
    work: int                       # steps or requests completed in it
    spans: list                     # (start, end) of the step spans in it
    counters: dict                  # program counters over the window
    trace: Summary | None = None    # the traced phase after the window
    trace_work: int = 0             # steps or requests in the traced phase
    ops: OpRecorder | None = None   # calls recorded in the traced phase
    flops: float = 0.0              # model FLOPs of the window's work

    def roofline(self, op: str) -> float | None:
        """% of the bound: the recorded calls' least time over the device
        time of the kernels they launched; None where the trace saw no
        call of ``op``."""
        if self.trace is None or self.ops is None:
            return None
        calls, _, _, bound = self.ops.totals.get(op, (0, 0.0, 0.0, 0.0))
        device_s = self.trace.op_s.get(op, 0.0)
        if calls == 0 or device_s <= 0:
            return None
        return 100.0 * bound / device_s
