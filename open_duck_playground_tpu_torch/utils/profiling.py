"""Profiling, step timing, and the port's own tracer.

On ``torch.profiler`` (counterpart of the JAX package's ``utils/profiling.py``):

- `trace(log_dir, device)`: context manager around
  ``torch.profiler.profile`` that records host activity, and the card's
  kernels and copies when `device` is a CUDA device, and writes a Chrome
  trace (``trace.json``, for chrome://tracing or Perfetto) into `log_dir`
  on exit. It yields the ``profile`` object, so the caller can read
  ``key_averages()`` or ``events()``.
- `annotate(name)`: ``torch.profiler.record_function`` passthrough, a named
  span of host time inside a capture.
- `StepTimer`: wall-clock steps/sec with exponential smoothing.

The tracer: spans and counters that the package records itself, on one
clock with the card. Off by default; `enable()`, `disable()`, `enabled()`,
`reset()` (forget what was recorded), `summary()` (the aggregate), `spans()`
(every span). A span (`span(name, device, unit)`) records its name, its
parent (the innermost span open when it opened), its unit (the training
step, eval episode or eval step it belongs to: the outermost span opened
with ``unit=True`` above it, 0 outside any), its host start and end
(``time.perf_counter_ns``) and, when `device` is a CUDA device, its device
start and end. `add` records a closed host span that its caller timed.
The package's span names, and the metric each feeds, are listed in
README.md (Profiling) and PERF.md §3.

Counters are the objects' own (`watch`: an int an object keeps, counted
from `reset()`), and each captured graph's static counts by its name
(`note_graph`, kept across `reset()`; `graphs()`).

Device times are stamps: a one-thread kernel, handed over by the kernel
library that builds it (`stamp_with`), appends the card's ``%globaltimer``
to a ring on the card, at the index a counter on the card holds, in stream
order. An eager span stamps at its start and end. Inside a CUDA graph (``utils.graphs.GraphedBody``) the
spans opened during the capture become the segment's template, and their
stamps graph nodes: every replay appends its own stamps after those
enqueued before it, with no copy and no host wait, so replays enqueued
ahead of the card keep their own stamps. The host keeps the same count
(one per eager stamp, the template's stamps per replay), so it knows where
each stamp lands: spans stamp on one stream at a time. `summary()` reads
the ring once (call it after synchronizing) and maps stamps onto
``perf_counter_ns`` by two anchors (synchronize, stamp, read the host
clock): one at `reset()` or the ring's first use, one at `summary()`.
Records and stamps are held in memory up to a bound; what does not fit is
counted as ``dropped``.

While a ``torch.profiler`` records, each eager span is also a
``record_function`` annotation, so the profiler's idle gaps carry the
program's names.

Off means off: a span then costs one check of a module flag and returns a
shared null context; nothing is allocated, launched or annotated, and a
graph captured while off holds no stamp node. On the CPU spans carry host
times only. One thread opens spans.
"""

from __future__ import annotations

import contextlib
import os
import time
import weakref
from typing import Any, Dict, Iterator, List, Optional, Tuple, Union

import torch
from torch.autograd import profiler as _autograd_profiler


@contextlib.contextmanager
def trace(log_dir: str, device: Union[str, torch.device] = "cuda"
          ) -> Iterator[torch.profiler.profile]:
    """Capture a torch.profiler trace of the body into `log_dir`/trace.json.
    With a CUDA `device` the card's activity is recorded too, and a missing
    card raises rather than tracing the host alone."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: trace records the card's activity unless given "
                               "device='cpu'")
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Named host-side annotation visible in profiler traces."""
    return torch.profiler.record_function(name)


# ---------------------------------------------------------------------------
# the tracer
# ---------------------------------------------------------------------------

RECORDS = 1 << 20  # spans held: eager spans and replays of templates
RING = 1 << 21  # device stamps held per card (16 MiB)

_ON = False  # the one check a span makes
_NULL = contextlib.nullcontext()  # what every span is while the tracer is off
_STAMPER = None  # the stamp kernel's launcher (stamp_with)


def span(name: str, device: Union[None, str, torch.device] = None, unit: bool = False):
    """A context manager recording one span (module docstring). `device`: a
    CUDA device when the span brackets stream work on it (its device times
    are stamped), else None or the CPU (host times only). `unit`: the span
    starts a unit unless one is open. With the tracer off it returns a
    shared null context."""
    if not _ON:
        return _NULL
    return _Span(name, device, unit)


def add(name: str, t0: int, t1: int) -> None:
    """A closed span of host time only, [t0, t1] in perf_counter_ns, that
    the caller timed itself, under the span open now (nothing while off)."""
    if _ON:
        _TRACER.add(name, t0, t1)


def stamp_with(launch) -> None:
    """The stamp kernel's launcher, `launch(ring, count, capacity, stream)`
    -> a cudaError code: one thread that writes ``%globaltimer`` into
    ``ring[*count]`` if ``*count < capacity`` and adds 1 to ``*count``, on
    the CUDA stream handle `stream` (ring and count: device pointers to
    int64). The kernel library that builds it hands it over on import."""
    global _STAMPER
    _STAMPER = launch


def enable() -> None:
    """Record spans from now on (graphs captured from now on hold stamps)."""
    global _ON
    _ON = True


def disable() -> None:
    """Stop recording; what was recorded stays until `reset()`."""
    global _ON
    _ON = False


def enabled() -> bool:
    return _ON


def reset() -> None:
    """Forget every span and stamp recorded, restart the counters and units
    from 0 and take a new anchor on each card the tracer has used (it
    synchronizes that card). The graphs' kernel_nodes are kept."""
    _TRACER.reset()


def spans() -> List[Dict[str, Any]]:
    """Every span recorded since `reset()`, parents before children, as
    dicts: name, parent (index, None at the top), unit, host (t0, t1) in
    perf_counter_ns or None while open, device (d0, d1) in perf_counter_ns
    or None where not stamped. Reads the rings: call after the card has run
    what was enqueued (synchronize); takes an anchor on each."""
    return _TRACER.expand()


def summary() -> Dict[str, Any]:
    """`summarize` of `spans()`, with the counters since `reset()`, each
    graph's node counts and the number of spans dropped."""
    out = summarize(spans())
    out["counters"] = _counters()
    out["graphs"] = graphs()
    out["dropped"] = _TRACER.dropped
    return out


@contextlib.contextmanager
def sample() -> Iterator[Dict[str, float]]:
    """The tracer on for the body; yields a dict that holds, after the body,
    the host milliseconds of each span name the body recorded. If the
    tracer was off before, it is off again after and the body's spans are
    forgotten."""
    was = _ON
    t = _TRACER
    mark, gen = (len(t.records), len(t.replays), {d: r.head for d, r in t.rings.items()}), t.gen
    totals: Dict[str, float] = {}
    enable()
    try:
        yield totals
    finally:
        if t.gen == gen:
            for r in t.records[mark[0]:]:
                if r.t1 is not None:
                    totals[r.name] = totals.get(r.name, 0.0) + (r.t1 - r.t0) / 1e6
        if not was:
            disable()
            if t.gen == gen:
                del t.records[mark[0]:], t.replays[mark[1]:]
                for d, r in t.rings.items():
                    r.rewind(mark[2].get(d, 0))


# -- counters ----------------------------------------------------------------

_WATCHED: List[list] = []  # [weakref to the object, attribute, counter name, value at reset]
_GRAPHS: Dict[str, Dict[str, int]] = {}  # graph name -> kernel_nodes, segments


def watch(obj: Any, attr: str, name: str) -> None:
    """Count `obj.<attr>` (an int the object keeps) under `name` in
    `summary()`'s counters, from `reset()` on, for as long as `obj` lives."""
    _WATCHED[:] = [w for w in _WATCHED if w[0]() is not None]
    _WATCHED.append([weakref.ref(obj), attr, name, 0])


def note_graph(name: str, **counts: int) -> None:
    """A captured graph's static counts (its nodes by kind, its segments),
    under its name; a later graph of the same name replaces them."""
    _GRAPHS[name] = dict(counts)


def graphs() -> Dict[str, Dict[str, int]]:
    """Each captured graph's static counts (kernel_nodes, memcpy_nodes,
    memset_nodes, segments) by its name, as `note_graph` left them: counted
    at capture, the tracer on or off, and kept across `reset()`."""
    return {k: dict(v) for k, v in _GRAPHS.items()}


def _counters() -> Dict[str, int]:
    out: Dict[str, int] = {}
    for ref, attr, name, base in _WATCHED:
        obj = ref()
        if obj is not None:
            out[name] = out.get(name, 0) + getattr(obj, attr) - base
    return out


# -- recording ---------------------------------------------------------------


class _Record:
    __slots__ = ("name", "parent", "unit", "t0", "t1", "dev", "s0", "s1")

    def __init__(self, name: str, parent: int, unit: int):
        self.name, self.parent, self.unit = name, parent, unit
        self.t0 = self.t1 = None
        self.dev, self.s0, self.s1 = -1, -1, -1


class _Ring:
    """A card's stamps: RING slots, the card's count of stamps after them
    (where the next one lands), and the host's count of the same."""

    def __init__(self, dev: int):
        self.dev = dev
        self.t = torch.zeros(RING + 1, dtype=torch.int64, device=_ring_device(dev))
        self.ptr = self.t.data_ptr()
        self.count_ptr = self.ptr + 8 * RING
        self.head = 0
        self.anchor_buf = torch.zeros(2, dtype=torch.int64, device=self.t.device)
        self.anchors: List[Tuple[int, int]] = []

    def stamp(self) -> int:
        """One eager stamp on the current stream; returns its slot."""
        _launch(self.ptr, self.count_ptr, RING, self.dev)
        self.head += 1
        return self.head - 1

    def rewind(self, head: int) -> None:
        """Both counts back to `head` (in stream order on the card)."""
        self.head = head
        self.t[RING].fill_(head)


class Template:
    """The stamps of one graph segment: for each span opened while it was
    captured, (name, parent entry or -1, its start's and end's place among
    the segment's stamps) in `entries`; `n` stamps in all."""

    def __init__(self, ring: _Ring):
        self.ring = ring
        self.entries: List[Tuple[str, int, int, int]] = []
        self.stack: List[int] = []
        self.n = 0

    def stamp(self) -> int:
        """One stamp node of the segment; returns its place in it."""
        _launch(self.ring.ptr, self.ring.count_ptr, RING, self.ring.dev)
        self.n += 1
        return self.n - 1


def _ring_device(dev: int) -> torch.device:
    return torch.device("cuda", dev)


def _index(device: torch.device) -> int:
    return device.index if device.index is not None else torch.cuda.current_device()


def _launch(ring: int, count: int, capacity: int, dev: int) -> None:
    if _STAMPER is None:
        raise RuntimeError("tracer: no stamp kernel was handed over (stamp_with)")
    err = _STAMPER(ring, count, capacity, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tracer: stamp launch failed: cudaError {err}")


class _Span:
    __slots__ = ("name", "device", "unit", "rec", "i", "gen", "rf", "tpl", "entry")

    def __init__(self, name: str, device: Union[None, str, torch.device], unit: bool):
        self.name, self.device, self.unit = name, device, unit
        self.rec = self.rf = self.tpl = None

    def __enter__(self):
        _TRACER.enter(self)
        return self

    def __exit__(self, *exc):
        _TRACER.exit(self)
        return False


class _Tracer:
    def __init__(self):
        self.records: List[_Record] = []
        # each replay of a template: (template, its first slot, parent span, unit)
        self.replays: List[Tuple[Template, int, int, int]] = []
        self.stack: List[int] = []
        self.rings: Dict[int, _Ring] = {}
        self.capture: Optional[Template] = None
        self.units = 0
        self.dropped = 0
        self.gen = 0

    def ring(self, dev: int) -> _Ring:
        r = self.rings.get(dev)
        if r is None:
            r = self.rings[dev] = _Ring(dev)
            r.anchors.append(_anchor(r))
        return r

    def reset(self) -> None:
        self.gen += 1
        self.records, self.replays, self.stack = [], [], []
        self.units = self.dropped = 0
        for r in self.rings.values():
            r.rewind(0)
            r.anchors = [_anchor(r)]
        for w in _WATCHED:
            obj = w[0]()
            if obj is not None:
                w[3] = getattr(obj, w[1])

    def enter(self, s: _Span) -> None:
        dev = s.device
        if isinstance(dev, str):
            dev = torch.device(dev)
        cuda = dev is not None and dev.type == "cuda"
        tpl = self.capture
        if tpl is not None:  # inside a capture that GraphedBody records
            if not cuda:
                return  # host time inside a capture means nothing
            i = len(tpl.entries)
            tpl.entries.append((s.name, tpl.stack[-1] if tpl.stack else -1, tpl.stamp(), -1))
            tpl.stack.append(i)
            s.tpl, s.entry = tpl, i
            return
        if cuda and torch.cuda.is_current_stream_capturing():
            return  # a capture the tracer does not own
        if len(self.records) >= RECORDS:
            self.dropped += 1
            return
        parent = self.stack[-1] if self.stack else -1
        unit = self.records[parent].unit if parent >= 0 else 0
        if s.unit and not unit:
            self.units += 1
            unit = self.units
        rec = _Record(s.name, parent, unit)
        if _autograd_profiler._is_profiler_enabled:
            s.rf = torch.profiler.record_function(s.name)
            s.rf.__enter__()
        ring = None
        if cuda:
            ring = self.ring(_index(dev))
            if ring.head + 2 <= RING:
                rec.dev = ring.dev
            else:
                self.dropped += 1
        s.rec, s.i, s.gen = rec, len(self.records), self.gen
        self.records.append(rec)
        self.stack.append(s.i)
        rec.t0 = time.perf_counter_ns()
        if rec.dev >= 0:
            rec.s0 = ring.stamp()

    def add(self, name: str, t0: int, t1: int) -> None:
        if self.capture is not None:
            return
        if len(self.records) >= RECORDS:
            self.dropped += 1
            return
        parent = self.stack[-1] if self.stack else -1
        rec = _Record(name, parent, self.records[parent].unit if parent >= 0 else 0)
        rec.t0, rec.t1 = t0, t1
        self.records.append(rec)

    def exit(self, s: _Span) -> None:
        tpl = s.tpl
        if tpl is not None:
            tpl.stack.pop()
            name, parent, k0, _ = tpl.entries[s.entry]
            tpl.entries[s.entry] = (name, parent, k0, tpl.stamp())
            return
        rec = s.rec
        if rec is not None and s.gen == self.gen:
            if rec.dev >= 0:
                rec.s1 = self.rings[rec.dev].stamp()
            rec.t1 = time.perf_counter_ns()
            if self.stack and self.stack[-1] == s.i:
                self.stack.pop()
            elif s.i in self.stack:
                self.stack.remove(s.i)
        if s.rf is not None:
            s.rf.__exit__(None, None, None)

    def replayed(self, tpl: Template) -> None:
        ring = tpl.ring  # the replay appended tpl.n stamps on the card
        base, ring.head = ring.head, ring.head + tpl.n
        if ring.head > RING or len(self.replays) >= RECORDS:
            self.dropped += len(tpl.entries)
            return
        parent = self.stack[-1] if self.stack else -1
        unit = self.records[parent].unit if parent >= 0 else 0
        self.replays.append((tpl, base, parent, unit))

    def expand(self) -> List[Dict[str, Any]]:
        maps, stamps = {}, {}
        for d, r in self.rings.items():
            stamps[d] = r.t[:min(r.head, RING)].cpu().tolist()
            (h0, d0), (h1, d1) = r.anchors[0], _anchor(r)
            slope = (h1 - h0) / (d1 - d0) if d1 != d0 else 1.0
            maps[d] = (h0, d0, slope)

        def on_host(d: int, a: int, b: int):
            v = stamps[d]
            if b >= len(v) or v[a] <= 0 or v[b] < v[a]:
                return None  # past the ring's end, or not run
            h0, d0, slope = maps[d]
            return (h0 + (v[a] - d0) * slope, h0 + (v[b] - d0) * slope)

        out: List[Dict[str, Any]] = []
        for rec in self.records:
            closed = rec.t1 is not None
            out.append({"name": rec.name, "parent": None if rec.parent < 0 else rec.parent,
                        "unit": rec.unit, "host": (rec.t0, rec.t1) if closed else None,
                        "device": (on_host(rec.dev, rec.s0, rec.s1)
                                   if closed and rec.s1 >= 0 else None)})
        for tpl, at, parent, unit in self.replays:
            base = len(out)
            for name, p, k0, k1 in tpl.entries:
                out.append({"name": name, "unit": unit, "host": None,
                            "parent": (None if parent < 0 else parent) if p < 0 else base + p,
                            "device": on_host(tpl.ring.dev, at + k0, at + k1)})
        return out


def _anchor(ring: _Ring) -> Tuple[int, int]:
    """(host ns, device ns) of one stamp (into a buffer of its own): the
    best of three (synchronize, stamp, synchronize), the host time the
    middle of the tightest wait."""
    buf, best = ring.anchor_buf, None
    for _ in range(3):
        buf.zero_()
        torch.cuda.synchronize(ring.dev)
        h0 = time.perf_counter_ns()
        _launch(buf.data_ptr(), buf.data_ptr() + 8, 1, ring.dev)
        torch.cuda.synchronize(ring.dev)
        h1 = time.perf_counter_ns()
        if best is None or h1 - h0 < best[0]:
            best = (h1 - h0, (h0 + h1) // 2, int(buf[0].item()))
    return best[1], best[2]


_TRACER = _Tracer()


def template(device: torch.device) -> Optional[Template]:
    """A new template for one graph segment on `device`, or None with the
    tracer off (the segment then holds no stamp)."""
    return Template(_TRACER.ring(_index(device))) if _ON else None


@contextlib.contextmanager
def recording(tpl: Optional[Template]):
    """Inside a graph capture: the segment is the template's span
    ``graph.replay`` (its first and last nodes are its stamps), and the
    device spans opened in the body are stamped into `tpl` under it
    (nothing with None)."""
    if tpl is None:
        yield
        return
    _TRACER.capture = tpl
    try:
        with _Span("graph.replay", torch.device("cuda", tpl.ring.dev), False):
            yield
    finally:
        _TRACER.capture = None


def replayed(tpl: Template) -> None:
    """After each replay of the segment captured into `tpl` (its stamps,
    appended on the card): the spans of its template, under the span open
    now. The host's count of the ring follows the card's, on or off."""
    if _ON:
        _TRACER.replayed(tpl)
    else:
        tpl.ring.head += tpl.n


# -- the summary ---------------------------------------------------------------


def _merge(intervals) -> List[List[float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _covered(iv, kids) -> float:
    """The length of `iv` that the intervals `kids` cover."""
    a, b = iv
    return sum(min(y, b) - max(x, a) for x, y in _merge(k for k in kids if k is not None)
               if min(y, b) > max(x, a))


def summarize(spans: List[Dict[str, Any]], top: int = 10) -> Dict[str, Any]:
    """The aggregate of `spans` (as `spans()` gives them):

    - ``spans`` and ``paths``: per name, and per path of names from the top
      ("ppo.training_step/ppo.rollout/ppo.rollout.replay/env.step"), the
      count, host ms, device ms and the self ms of each (the span's time
      less the part of it its children cover). A span with no stamps of its
      own takes the hull of its descendants' device times;
    - ``window_ms``: from the first stamp to the last; ``busy_ms``: the
      union of the stamped spans' device intervals; ``device_idle_pct``:
      the window less the union, over the window (None without stamps);
    - ``idle_by_span``: each gap of the union charged, in ms, to the
      innermost span open on the host when the card went idle ("outside"
      when none was); ``idle_gaps``: the `top` longest, [name, ms];
    - ``units``: the units seen; ``stamps``: the device stamps read."""
    n = len(spans)
    kids: List[List[int]] = [[] for _ in range(n)]
    for i, s in enumerate(spans):
        if s["parent"] is not None:
            kids[s["parent"]].append(i)
    dev = [s["device"] for s in spans]
    for i in range(n - 1, -1, -1):  # children come after their parents
        if dev[i] is None:
            ds = [dev[c] for c in kids[i] if dev[c] is not None]
            if ds:
                dev[i] = (min(a for a, _ in ds), max(b for _, b in ds))
    by_name: Dict[str, Dict[str, float]] = {}
    by_path: Dict[str, Dict[str, float]] = {}
    paths: List[str] = []
    for i, s in enumerate(spans):
        p = s["parent"]
        paths.append(s["name"] if p is None else f"{paths[p]}/{s['name']}")
        host, d = s["host"], dev[i]
        h_ms = (host[1] - host[0]) / 1e6 if host else 0.0
        d_ms = (d[1] - d[0]) / 1e6 if d else 0.0
        self_h = h_ms - _covered(host, [spans[c]["host"] for c in kids[i]]) / 1e6 if host else 0.0
        self_d = d_ms - _covered(d, [dev[c] for c in kids[i]]) / 1e6 if d else 0.0
        for table, key in ((by_name, s["name"]), (by_path, paths[i])):
            row = table.setdefault(key, {"count": 0, "host_ms": 0.0, "device_ms": 0.0,
                                         "self_host_ms": 0.0, "self_device_ms": 0.0})
            row["count"] += 1
            row["host_ms"] += h_ms
            row["device_ms"] += d_ms
            row["self_host_ms"] += self_h
            row["self_device_ms"] += self_d

    busy = _merge(s["device"] for s in spans if s["device"] is not None)
    window = (busy[-1][1] - busy[0][0]) / 1e6 if busy else 0.0
    busy_ms = sum(b - a for a, b in busy) / 1e6
    gaps = [(busy[k][1], busy[k + 1][0]) for k in range(len(busy) - 1)]
    # each gap to the innermost host span open at its start: a sweep over
    # the host spans' starts and ends (they nest) and the gaps' starts
    events = []
    for i, s in enumerate(spans):
        if s["host"] is not None:
            events += [(s["host"][0], 1, i), (s["host"][1], 0, i)]
    events += [(g0, 2, k) for k, (g0, _) in enumerate(gaps)]
    events.sort()
    open_: List[int] = []
    charged: List[str] = [""] * len(gaps)
    for _, kind, i in events:
        if kind == 1:
            open_.append(i)
        elif kind == 0:
            if open_ and open_[-1] == i:
                open_.pop()
            elif i in open_:
                open_.remove(i)
        else:
            charged[i] = spans[open_[-1]]["name"] if open_ else "outside"
    idle_by: Dict[str, float] = {}
    for (g0, g1), name in zip(gaps, charged):
        idle_by[name] = idle_by.get(name, 0.0) + (g1 - g0) / 1e6
    longest = sorted(range(len(gaps)), key=lambda k: gaps[k][0] - gaps[k][1])[:top]
    return {"spans": by_name, "paths": by_path, "window_ms": window, "busy_ms": busy_ms,
            "device_idle_pct": 100.0 * (window - busy_ms) / window if window > 0 else None,
            "idle_by_span": idle_by,
            "idle_gaps": [[charged[k], (gaps[k][1] - gaps[k][0]) / 1e6] for k in longest],
            "units": len({s["unit"] for s in spans if s["unit"]}),
            "stamps": 2 * sum(s["device"] is not None for s in spans)}


class StepTimer:
    """Wall-clock steps/sec with exponential smoothing."""

    def __init__(self, smoothing: float = 0.9):
        self._smoothing = smoothing
        self._last: Optional[float] = None
        self._rate: Optional[float] = None

    def tick(self, units: float = 1.0) -> Optional[float]:
        """Record one step of `units` work; returns smoothed units/sec."""
        now = time.monotonic()
        if self._last is not None:
            dt = max(now - self._last, 1e-9)
            rate = units / dt
            if self._rate is None:
                self._rate = rate
            else:
                self._rate = self._smoothing * self._rate + (1 - self._smoothing) * rate
        self._last = now
        return self._rate

    @property
    def rate(self) -> Optional[float]:
        return self._rate
