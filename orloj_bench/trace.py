"""The device trace of a traced run: ``torch.profiler``'s CUPTI records of
every kernel over the whole window, kept in memory and reduced to numbers.

Only device activity is recorded (no CPU operator events), and the raw
Kineto events are read directly, so a window of a million kernels costs
seconds and writes nothing to disk.  Kineto stamps events in nanoseconds
of the host's wall clock (``time.time_ns``), and so does the benchmark's
own spans, which name the host's work in each idle gap.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np


@dataclasses.dataclass
class Trace:
    names: list[str]
    start_ns: np.ndarray  # int64, sorted
    end_ns: np.ndarray
    window: tuple[int, int]  # the traced window, host wall-clock ns
    _by_name: dict | None = None

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy_intervals(self) -> np.ndarray:
        """The union of kernel intervals inside the window, (n, 2) ns."""
        lo, hi = self.window
        s = np.clip(self.start_ns, lo, hi)
        e = np.clip(self.end_ns, lo, hi)
        keep = e > s
        s, e = s[keep], e[keep]
        if not len(s):
            return np.zeros((0, 2), np.int64)
        order = np.argsort(s, kind="stable")
        s, e = s[order], np.maximum.accumulate(e[order])
        new = np.ones(len(s), bool)
        new[1:] = s[1:] > e[:-1]
        starts = s[new]
        ends = np.append(e[np.flatnonzero(new)[1:] - 1], e[-1])
        return np.stack([starts, ends], 1)

    def busy_s(self) -> float:
        iv = self.busy_intervals()
        return float((iv[:, 1] - iv[:, 0]).sum()) / 1e9

    def idle_gaps(self) -> np.ndarray:
        """The gaps of the window that no kernel covers, (n, 2) ns."""
        iv = self.busy_intervals()
        lo, hi = self.window
        edges = np.concatenate([[lo], iv.ravel(), [hi]]).reshape(-1, 2)
        return edges[edges[:, 1] > edges[:, 0]]

    def seconds_by_name(self) -> dict[str, float]:
        if self._by_name is None:
            out: dict[str, float] = {}
            for n, d in zip(self.names, (self.end_ns - self.start_ns).tolist()):
                out[n] = out.get(n, 0.0) + d / 1e9
            self._by_name = out
        return self._by_name


def _config():
    from torch._C._profiler import ProfilerConfig, ProfilerState, _ExperimentalConfig

    args = (ProfilerState.KINETO, False, False, False, False, False, _ExperimentalConfig())
    try:
        return ProfilerConfig(*args, "")
    except TypeError:
        return ProfilerConfig(*args)


class Recorder:
    """Start the device trace at construction; :meth:`stop` ends it and returns
    the :class:`Trace`."""

    def __init__(self):
        from torch._C._autograd import _enable_profiler, _prepare_profiler
        from torch._C._profiler import ProfilerActivity

        acts = {ProfilerActivity.CUDA}
        cfg = _config()
        _prepare_profiler(cfg, acts)
        _enable_profiler(cfg, acts)
        self.t0 = time.time_ns()

    def stop(self) -> Trace:
        import torch
        from torch._C._autograd import _disable_profiler

        torch.cuda.synchronize()
        t1 = time.time_ns()
        events = _disable_profiler().events()
        names, starts, ends = [], [], []
        cuda = torch.autograd.DeviceType.CUDA
        for ev in events:
            if ev.device_type() != cuda:
                continue
            s = ev.start_ns()
            names.append(ev.name())
            starts.append(s)
            ends.append(s + ev.duration_ns())
        order = np.argsort(np.asarray(starts, np.int64), kind="stable")
        return Trace(
            names=[names[i] for i in order],
            start_ns=np.asarray(starts, np.int64)[order],
            end_ns=np.asarray(ends, np.int64)[order],
            window=(self.t0, t1),
        )
