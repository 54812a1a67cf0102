"""The program's spans and counters, on the profiler's clock.

A span is a named interval of host time around one call into a layer
(``span("denoise.step")``); a counter adds a number under a name
(``count("amg.kept", n)``). Every place where the host waits on the card
counts one ``sync.<site>``: explicit reads go through ``host_read``, and
the implicit ones (a copy from pageable host memory, a boolean-mask index)
call ``count("sync.<site>")`` at their statement, on any device: on the
CPU they mark where a card would wait.

Tracing is on while ``enable()`` holds or while a ``torch.profiler``
profile is recording; otherwise each span, counter and read checks one
flag and does nothing more. When on, a span appends ``(name, start_ns,
end_ns, depth)`` at its end and a counter ``(name, t_ns, n)`` to one ring
buffer of ``CAPACITY`` events (``events()``), the oldest dropped first.
Both stamp ``time.time_ns()``: the clock that the profiler stamps its
events with, so that a kernel's launch in a device trace falls inside the
span of the call that issued it.

A span is host time only. It opens no ``record_function`` range: the
profiler copies each such range onto the device's timeline, where it
would read as work between kernels. It neither synchronises nor touches
the device.

``snapshot()`` sums the buffer per span and per counter, beside the
kernel wrappers' own ``launches`` attributes.
"""

from __future__ import annotations

import collections
import threading
import time

import torch
from torch.autograd import profiler as _profiler

CAPACITY = 1 << 16

_enabled = False
_events = collections.deque(maxlen=CAPACITY)
_local = threading.local()      # each thread's span depth


def enable() -> None:
    """Record spans and counters until ``disable()``, profiled or not."""
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


class _Span:
    __slots__ = ("name", "start", "depth")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.depth = getattr(_local, "depth", 0)
        _local.depth = self.depth + 1
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        _events.append((self.name, self.start, time.time_ns(), self.depth))
        _local.depth = self.depth
        return False


class _Off:
    """The span of tracing off: enters and leaves, records nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str):
    """``with span(name):`` records the enclosed host interval when
    tracing is on; one flag check otherwise."""
    if _enabled or _profiler._is_profiler_enabled:
        return _Span(name)
    return _OFF


def count(name: str, n: int = 1) -> None:
    """Add `n` to counter `name` when tracing is on."""
    if _enabled or _profiler._is_profiler_enabled:
        _events.append((name, time.time_ns(), n))


def host_read(x, site: str, read=torch.Tensor.cpu):
    """``read(x)``: the program's read of a device tensor to the host
    (``.cpu()`` by default; ``int``, ``float``, ``bool``, ``Tensor.item``
    or ``Tensor.tolist`` as given). When tracing is on, the wait is span
    ``sync.<site>``, and the read counts one ``sync.<site>`` unless `x` is
    no tensor or an empty one: those copy nothing and wait on nothing."""
    if not (_enabled or _profiler._is_profiler_enabled):
        return read(x)
    with _Span("sync." + site):
        out = read(x)
    if isinstance(x, torch.Tensor) and x.numel():
        count("sync." + site)
    return out


def events() -> list:
    """The buffer, oldest first: spans as (name, start_ns, end_ns, depth),
    counters as (name, t_ns, n)."""
    return list(_events)


def reset() -> None:
    """Empty the buffer."""
    _events.clear()


def _kernel_launches() -> dict:
    """Each kernel wrapper's ``launches`` count (calls that reached a
    device kernel since the process started)."""
    from editanything_tpu_torch.core import flash_attention as FA
    from editanything_tpu_torch.core import kernels as K
    return {"flash_attention": FA.flash_attention.launches,
            "group_norm_silu": K.group_norm_silu.launches,
            # of those, the launches that took kernel A's NHWC path
            "group_norm_silu_nhwc": getattr(K.group_norm_silu,
                                            "launches_nhwc", 0),
            "sam_twoway": K.sam_twoway.launches,
            "sam_upscale_hyper": K.sam_upscale_hyper.launches,
            "resnet_fused": K.resnet_fused.launches}


def snapshot() -> dict:
    """The buffer summed: {"spans": {name: {"count", "host_ms"}},
    "counters": {name: total}, "launches": {kernel wrapper: launches}}."""
    spans = collections.defaultdict(lambda: {"count": 0, "host_ms": 0.0})
    counters = collections.Counter()
    for ev in _events:
        if len(ev) == 4:
            s = spans[ev[0]]
            s["count"] += 1
            s["host_ms"] += (ev[2] - ev[1]) / 1e6
        else:
            counters[ev[0]] += ev[2]
    return {"spans": dict(spans), "counters": dict(counters),
            "launches": _kernel_launches()}
