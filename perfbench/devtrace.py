"""What the device did in a traced window: ``torch.profiler`` (CPU and
CUDA activities) over the window, reduced to busy time, device time by
operation and the idle gaps by what the host was doing.

The window is the harness's own ``record_function("window")`` span, so its
ends are read on the trace's clock. Busy time is the union of every device
operation (kernel, memcpy, memset) inside it. Each idle gap between them
is named by the innermost host event that covers its middle on the
window's thread (an aten op, a CUDA runtime call, or one of the harness's
spans around its calls into the index).
"""

from __future__ import annotations

from collections.abc import Callable, Iterable
from dataclasses import dataclass, field

__all__ = ["DeviceTrace", "WINDOW", "is_b1", "is_b2", "is_copy", "is_kernel", "profiler", "read",
           "summarize"]

WINDOW = "window"
NAME_CHARS = 160  # kernel names carry whole C++ signatures


def profiler():
    """A ``torch.profiler.profile`` over CPU and CUDA activities."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


@dataclass
class DeviceTrace:
    window_s: float
    busy_s: float
    ops: dict[str, list] = field(default_factory=dict)  # device op -> [seconds, calls]
    gaps: dict[str, float] = field(default_factory=dict)  # host activity -> idle seconds

    def time(self, pred: Callable[[str], bool]) -> tuple[float, int]:
        """Seconds and calls of the device operations whose name passes."""
        s, n = 0.0, 0
        for name, (sec, calls) in self.ops.items():
            if pred(name):
                s += sec
                n += calls
        return s, n

    def breakdown(self, top: int = 10) -> dict:
        def head(d: dict) -> list:
            rows = sorted(d.items(), key=lambda kv: -kv[1])[:top]
            return [[name[:NAME_CHARS], sec] for name, sec in rows]

        return {"device_ops": head({k: v[0] for k, v in self.ops.items()}),
                "idle_gaps": head(self.gaps)}


def is_copy(name: str, kind: str) -> bool:
    """A memcpy of ``kind`` ("HtoD", "DtoH", "DtoD")."""
    return name.startswith(f"Memcpy {kind}")


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def is_b1(name: str) -> bool:
    """Kernel B1, ``csrc/collision_group_max.cu``."""
    return "collision_group_max_kernel" in name


def is_b2(name: str) -> bool:
    """Kernel B2, ``csrc/hamming_wgmma.cuh``'s planes instantiation
    (``hamming_group_max_kernel<G, false>``; B3 is ``<G, true>``)."""
    head, sep, rest = name.partition("hamming_group_max_kernel<")
    return bool(sep) and "true" not in rest.split(">")[0] and "(bool)1" not in rest.split(">")[0]


def summarize(device: Iterable[tuple[int, int, str]],
              host: Iterable[tuple[int, int, str]],
              window: tuple[int, int]) -> DeviceTrace:
    """Reduce ``(start_ns, end_ns, name)`` device operations and host
    events of the window's thread to a `DeviceTrace` of ``window``."""
    w0, w1 = window
    ops: dict[str, list] = {}
    spans = []
    for s, e, name in device:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        rec = ops.setdefault(name, [0.0, 0])
        rec[0] += (e - s) * 1e-9
        rec[1] += 1
        spans.append((s, e))
    spans.sort()
    busy, gaps, cursor = 0, [], w0
    for s, e in spans:
        if s > cursor:
            gaps.append((cursor, s))
        if e > cursor:
            busy += e - max(s, cursor)
            cursor = e
    if w1 > cursor:
        gaps.append((cursor, w1))
    return DeviceTrace(window_s=(w1 - w0) * 1e-9, busy_s=busy * 1e-9, ops=ops,
                       gaps=_name_gaps(gaps, sorted(host, key=lambda h: (h[0], -h[1]))))


def _name_gaps(gaps: list[tuple[int, int]], host: list[tuple[int, int, str]]) -> dict:
    """Idle seconds by the innermost host event covering each gap's middle
    (host events of one thread nest, so a stack sweep finds it)."""
    out: dict[str, float] = {}
    stack: list[tuple[int, int, str]] = []
    i = 0
    for g0, g1 in gaps:  # in time order
        mid = (g0 + g1) // 2
        while i < len(host) and host[i][0] <= mid:
            while stack and stack[-1][1] < host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        name = stack[-1][2] if stack else "(no host event)"
        out[name] = out.get(name, 0.0) + (g1 - g0) * 1e-9
    return out


def read(prof) -> DeviceTrace:
    """The `DeviceTrace` of a finished profiler's ``window`` span."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    device, host_all, window, tid = [], [], None, None
    for ev in events:
        name = ev.name()
        if ev.device_type() == DeviceType.CUDA:
            if not ev.is_user_annotation():  # the harness's spans, mirrored on the card
                device.append((ev.start_ns(), ev.end_ns(), name))
        elif ev.device_type() == DeviceType.CPU:
            host_all.append((ev.start_ns(), ev.end_ns(), name, ev.start_thread_id()))
            if name == WINDOW:
                window, tid = (ev.start_ns(), ev.end_ns()), ev.start_thread_id()
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW!r} span")
    host = [(s, e, name) for s, e, name, t in host_all
            if t == tid and name != WINDOW and e >= window[0] and s <= window[1]]
    return summarize(device, host, window)
