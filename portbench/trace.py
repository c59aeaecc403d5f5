"""The device trace of a traced run (torch.profiler, CUPTI), reduced to
what the per-layer metrics read: each device operation's interval and
name, the union of busy time, and the host's spans (the benchmark's own
ranges `bench.*` and the program's `flac.*` ranges) to say what the host
was doing in each idle gap."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

@dataclass
class Trace:
    window: tuple = (0, 0)        # ns, the traced window's ends
    ops: list = field(default_factory=list)      # (name, kind, start, end)
    spans: list = field(default_factory=list)    # (name, start, end)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy_intervals(self) -> np.ndarray:
        """[k, 2] ns: the union of the device operations' intervals
        inside the window."""
        if not self.ops:
            return np.zeros((0, 2), np.int64)
        iv = np.array([(s, e) for _, _, s, e in self.ops], np.int64)
        iv = np.clip(iv, *self.window)
        iv = iv[np.argsort(iv[:, 0])]
        out = []
        cs, ce = iv[0]
        for s, e in iv[1:]:
            if s > ce:
                out.append((cs, ce))
                cs, ce = s, e
            else:
                ce = max(ce, e)
        out.append((cs, ce))
        return np.array(out, np.int64)

    def busy_s(self) -> float:
        iv = self.busy_intervals()
        return float((iv[:, 1] - iv[:, 0]).sum()) / 1e9

    def kernel_seconds(self, match=None) -> dict:
        """{kernel name: device seconds} (names containing `match` only,
        where given)."""
        out: dict = {}
        for name, kind, s, e in self.ops:
            if kind == "kernel" and (match is None or match in name):
                out[name] = out.get(name, 0.0) + (e - s) / 1e9
        return out

    def kernel_launches(self, match: str) -> int:
        return sum(1 for name, kind, _, _ in self.ops
                   if kind == "kernel" and match in name)

    def idle_by_host(self, top: int = 10) -> list:
        """[[what the host was in, idle seconds]]: each gap between busy
        intervals inside the window, named by the innermost host span
        around its middle, summed by name; the largest first."""
        iv = self.busy_intervals()
        edges = np.concatenate([[self.window[0]], iv.ravel(),
                                [self.window[1]]]).reshape(-1, 2)
        edges = edges[edges[:, 1] > edges[:, 0]]
        segs = flatten(self.spans)
        starts = np.array([s for s, _, _ in segs] or [0], np.int64)
        ends = np.array([e for _, e, _ in segs] or [0], np.int64)
        mid = (edges[:, 0] + edges[:, 1]) // 2
        at = np.searchsorted(starts, mid, side="right") - 1
        inside = (at >= 0) & (mid < ends[at.clip(min=0)])
        names = [segs[i][2] if ok else "outside any span"
                 for i, ok in zip(at.tolist(), inside.tolist())]
        out: dict = {}
        for name, (s, e) in zip(names, edges.tolist()):
            out[name] = out.get(name, 0.0) + (e - s) / 1e9
        return sorted(([k, v] for k, v in out.items()),
                      key=lambda kv: -kv[1])[:top]


def flatten(spans: list) -> list:
    """Nested (name, start, end) spans -> [(start, end, name)] segments,
    each named by the innermost span over it, in time order."""
    segs, stack, t = [], [], 0
    for name, s, e in sorted(spans, key=lambda x: (x[1], -x[2])):
        while stack and stack[-1][0] <= s:
            end, nm = stack.pop()
            if t < end:
                segs.append((t, end, nm))
                t = end
        if stack and t < s:
            segs.append((t, s, stack[-1][1]))
        t = max(t, s)
        stack.append((e, name))
    while stack:
        end, nm = stack.pop()
        if t < end:
            segs.append((t, end, nm))
            t = end
    return segs


def reduce(prof, window_name: str = "bench.window") -> Trace:
    """A Trace from a finished torch.profiler.profile: its window is the
    host span named `window_name`."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    tr = Trace()
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        ours = name.startswith(("bench.", "flac."))
        if ev.device_type() == cuda:
            if ours:          # a range's image on the device's timeline
                continue
            kind = "gpu_memcpy" if name.startswith("Memcpy") else \
                "gpu_memset" if name.startswith("Memset") else "kernel"
            tr.ops.append((name, kind, ev.start_ns(), ev.end_ns()))
        elif name == window_name:
            tr.window = (ev.start_ns(), ev.end_ns())
        elif ours:
            tr.spans.append((name, ev.start_ns(), ev.end_ns()))
    return tr
