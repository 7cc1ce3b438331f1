"""The traced run's device timeline, from ``torch.profiler``.

``profiled(fn)`` runs ``fn`` under the profiler (CPU and CUDA activity)
inside a ``record_function`` span that ends after a synchronize, and
returns a ``Timeline``: every device activity (kernels, copies, sets) as
(name, start, end) in seconds, the host's operations, and the span's
window, all on the profiler's clock. The events are read from the raw
kineto results, which take well under a second for the 10^4-10^5 events
of a 1080p sample (``key_averages()`` takes many seconds).
"""
from __future__ import annotations

import dataclasses
import re

WINDOW_SPAN = "benchmark.profiled"
# The program's hand-written kernels (``path_tracer_torch/csrc``), by the
# identifier in the profiler's kernel name.
PORT_KERNEL = re.compile(
    r"\b(mt_closest_hit|sphere_closest_hit|sph_walk|flat_closest_hit"
    r"|flat_occluded|flat2_closest_hit|flat2_occluded|alpha_walk|trans_walk"
    r"|sph_occ_dense|sph_occ_walk|fused_shadow|khit|tree_closest"
    r"|tree_occluded)_kernel\b")


@dataclasses.dataclass
class Timeline:
    device: list  # (name, start_s, end_s), sorted by start
    host: list  # (name, start_s, end_s) of host-side operations
    window: tuple  # (start_s, end_s)
    # Per device activity, the innermost ATen operator on the host that
    # launched it (None where not known).
    launched_by: list = dataclasses.field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_intervals(self) -> list:
        """The union of device activity inside the window, merged."""
        lo, hi = self.window
        merged = []
        for _, a, b in self.device:
            a, b = max(a, lo), min(b, hi)
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def device_seconds(self, pattern=None) -> float:
        """Summed device time of activities whose name matches ``pattern``
        (a compiled regex, or None for all)."""
        return sum(b - a for n, a, b in self.device
                   if pattern is None or pattern.search(n))


    def top_ops(self, k: int = 10) -> list:
        """[[name, seconds]] of the device operations that took most time,
        summed by the host operator that launched each and its kernel's
        short name."""
        tot = {}
        for i, (n, a, b) in enumerate(self.device):
            op = self.launched_by[i] if self.launched_by else None
            key = f"{op}: {short_name(n)}" if op else short_name(n)
            tot[key] = tot.get(key, 0.0) + (b - a)
        return [[n, s] for n, s in sorted(tot.items(), key=lambda x: -x[1])[:k]]

    def idle_gaps(self, k: int = 10) -> list:
        """[[what the host was doing, seconds]] of the k longest gaps with
        no device activity inside the window: the innermost host operation
        spanning the gap's middle ("host code between operations" where
        none does)."""
        lo, hi = self.window
        edges = [lo] + [x for ab in self.busy_intervals() for x in ab] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:k]:
            mid = 0.5 * (a + b)
            inner = [(e - s, n) for n, s, e in self.host
                     if s <= mid <= e and n != WINDOW_SPAN]
            label = min(inner)[1] if inner else "host code between operations"
            out.append([label, b - a])
        return out


def short_name(name: str) -> str:
    """A kernel's identifier without its template and argument lists."""
    m = re.search(r"(\w+_kernel)\b", name)
    if m and "at::" not in name:
        return m.group(1)
    name = re.sub(r"^void ", "", name)
    return name.split("(")[0][:80]


def profiled(fn) -> Timeline:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        with record_function(WINDOW_SPAN):
            fn()
            sync()
    device, host, window = [], [], None
    dev_corr, launch_at = [], {}
    for e in prof.profiler.kineto_results.events():
        dur = e.duration_ns()
        start = (e.start_ns() if hasattr(e, "start_ns") else e.start_us() * 1e3)
        row = (e.name(), start * 1e-9, (start + dur) * 1e-9)
        corr = e.correlation_id() if hasattr(e, "correlation_id") else 0
        if e.device_type() == DeviceType.CUDA:
            # The window span's own device-side annotation is no activity.
            if dur > 0 and e.name() != WINDOW_SPAN:
                device.append(row)
                dev_corr.append(corr)
        else:
            host.append(row)
            if corr:
                launch_at[corr] = row[1]
            if e.name() == WINDOW_SPAN:
                window = row[1:]
    if window is None:
        raise RuntimeError("the profiler recorded no window span")
    order = sorted(range(len(device)), key=lambda i: device[i][1])
    device = [device[i] for i in order]
    ops = launching_ops(host, [launch_at.get(dev_corr[i]) for i in order])
    return Timeline(device, host, window, ops)


def launching_ops(host: list, launch_times: list) -> list:
    """For each launch time (None: unknown), the innermost ``aten::``
    operator spanning it on the host, by a sweep over the operators in
    start order (they nest)."""
    aten = sorted((r for r in host if r[0].startswith("aten::")),
                  key=lambda r: (r[1], -r[2]))
    idx = sorted((t, i) for i, t in enumerate(launch_times) if t is not None)
    out = [None] * len(launch_times)
    stack, j = [], 0
    for t, i in idx:
        while j < len(aten) and aten[j][1] <= t:
            while stack and stack[-1][2] < aten[j][1]:
                stack.pop()
            stack.append(aten[j])
            j += 1
        while stack and stack[-1][2] < t:
            stack.pop()
        out[i] = stack[-1][0] if stack else None
    return out
