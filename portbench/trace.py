"""The reduction of a torch.profiler trace to what the metrics read.

The traced window runs the cell's requests under torch.profiler (CPU and
CUDA activity), each request inside the benchmark's own ``pb.request``
span and its calls into the program inside ``pb.<layer>`` spans. From the
trace: the window (the first request span's start to the last one's end),
the device's busy time (the union of its kernel, memcpy and memset
intervals inside the window; the spans' own ranges on the device's
timeline are no device work), the device time of each operation by name,
the device-to-host copy time, and the idle gaps between device intervals,
each labelled by the benchmark span and the innermost host operation in
flight at its middle.
"""

from __future__ import annotations

import re
from collections import defaultdict

SPAN = "pb."
REQUEST = SPAN + "request"


def short(name: str) -> str:
    """A device operation's name without its argument list."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"\(.*$", "", name).strip()
    return name[:120]


class Trace:
    """What the metrics read from one traced window."""

    def __init__(self, events, requests: int, viewpoints: int, work: dict):
        import torch
        cuda = torch.autograd.DeviceType.CUDA
        dev, cpu = [], []
        for e in events:
            rng = (e.time_range.start, e.time_range.end)
            if e.device_type == cuda:
                # a span's range on the device's timeline is no device work
                if not (getattr(e, "is_user_annotation", False)
                        or e.name.startswith(SPAN)):
                    dev.append((rng[0], rng[1], e.name))
            else:
                cpu.append((rng[0], rng[1], e.name, e.thread))
        spans = [c for c in cpu if c[2] == REQUEST]
        if not spans:
            raise RuntimeError("the trace holds no request span")
        # the host operations of the thread that ran the requests
        cpu = sorted(c[:3] for c in cpu if c[3] == spans[0][3])
        self.t0 = min(s[0] for s in spans)
        self.t1 = max(s[1] for s in spans)
        self.window_s = (self.t1 - self.t0) / 1e6
        self.requests = requests
        self.viewpoints = viewpoints
        self.work = work
        dev = [d for d in dev if d[1] > self.t0 and d[0] < self.t1]
        self.op_s = defaultdict(float)
        for s, t, name in dev:
            self.op_s[name] += (t - s) / 1e6
        # the union of the device intervals, clipped to the window
        iv = sorted((max(s, self.t0), min(t, self.t1)) for s, t, _ in dev)
        merged = []
        for s, t in iv:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        self.busy_s = sum(t - s for s, t in merged) / 1e6
        edges = [self.t0] + [x for m in merged for x in m] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        self.idle_gaps = self._label(gaps, cpu)

    @staticmethod
    def _label(gaps, cpu):
        """{label: idle seconds}: each gap labelled by the innermost
        benchmark span and the innermost other host operation in flight at
        its middle (one pass over the gaps and the host operations, which
        nest on one thread)."""
        out = defaultdict(float)
        stack, i = [], 0
        for mid, length in sorted((0.5 * (s + t), t - s) for s, t in gaps):
            while i < len(cpu) and cpu[i][0] <= mid:
                while stack and stack[-1][0] < cpu[i][0]:
                    stack.pop()
                stack.append((cpu[i][1], cpu[i][2]))
                i += 1
            while stack and stack[-1][0] < mid:
                stack.pop()
            ours = next((n for _, n in reversed(stack) if n.startswith(SPAN)),
                        None)
            other = next((n for _, n in reversed(stack)
                          if not n.startswith(SPAN)), None)
            label = " > ".join(x for x in (ours, other) if x)
            out[label or "outside any span"] += length / 1e6
        return dict(out)

    def device_s(self, match=None, exclude=()) -> float:
        """Device seconds of the operations whose name contains ``match``
        (every operation for None), less those that contain any of
        ``exclude``."""
        return sum(v for k, v in self.op_s.items()
                   if (match is None or match in k)
                   and not any(x in k for x in exclude))

    def breakdown(self) -> dict:
        ops = defaultdict(float)
        for k, v in self.op_s.items():
            ops[short(k)] += v
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.idle_gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in top],
                "idle_gaps": [[k, v] for k, v in gaps]}
