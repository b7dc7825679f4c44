"""The traced run's reading of the card: ``torch.profiler`` over the
measured window, the device's busy time as the union of its kernels' and
copies' intervals (a frozen copy of ``scripts/profile_train_step.py``'s
busy-union), and the breakdown the result line carries.

The profiler records the card's activity alone (kernels, copies,
memsets), not every host operation of the client threads. The
benchmark's own spans are the host times of its cold starts
(``time.time_ns``, the epoch clock the profiler's events carry), so an
idle gap on the card is named by whether a cold start was in flight
around it.
"""
from __future__ import annotations

SPAN = "cold_start"


def busy_union(spans) -> float:
    """Length of the union of (start, end) intervals."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def idle_gaps(spans) -> list:
    """(start, end) of the gaps between the union's intervals."""
    gaps, cur_e = [], None
    for s, e in sorted(spans):
        if cur_e is not None and s > cur_e:
            gaps.append((cur_e, s))
        cur_e = e if cur_e is None else max(cur_e, e)
    return gaps


class DeviceTrace:
    """Device events (name, start s, end s) and the benchmark's spans of
    one profiled window, read from a finished ``torch.profiler``."""

    def __init__(self, events: list, spans: list):
        self.events = events
        self.spans = spans

    @classmethod
    def from_profiler(cls, prof, spans: list) -> "DeviceTrace":
        """The device events of a finished profiler, in seconds of the
        epoch clock, beside the host `spans` ((start, end) of each cold
        start, in the same clock)."""
        import torch
        cuda = torch.autograd.DeviceType.CUDA
        events = [(e.name(), e.start_ns() * 1e-9,
                   (e.start_ns() + e.duration_ns()) * 1e-9)
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type() == cuda]
        return cls(events, spans)

    @staticmethod
    def is_copy(name: str) -> bool:
        return name.lower().startswith(("memcpy", "memset"))

    def kernels(self) -> list:
        return [e for e in self.events if not self.is_copy(e[0])]

    def busy_s(self) -> float:
        return busy_union((s, e) for _, s, e in self.events)

    def kernel_s(self) -> float:
        return sum(e - s for _, s, e in self.kernels())

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took the most time, and the longest
        idle gaps, each named by the span in flight at its middle."""
        by_name: dict = {}
        for name, s, e in self.events:
            by_name[name] = by_name.get(name, 0.0) + (e - s)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(idle_gaps((s, e) for _, s, e in self.events),
                      key=lambda g: g[0] - g[1])[:top]

        def where(g):
            mid = (g[0] + g[1]) / 2
            return SPAN if any(s <= mid <= e for s, e in self.spans) \
                else "no_cold_start"
        return {"device_ops": [[n[:120], t] for n, t in ops],
                "idle_gaps": [[where(g), g[1] - g[0]] for g in gaps]}
