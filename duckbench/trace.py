"""A torch.profiler Chrome trace reduced to what the per-layer metrics read.

The reading of the trace is a copy of ``chip_smoke.py``'s ``read_trace`` /
``_busy`` (the annotated spans, each device operation with the runtime call
that launched it), kept here so that the yardstick does not move with that
script. On top of it: the union of the device intervals inside a window,
the device time of each operation by name, and the idle gaps between device
intervals, each named by the innermost annotated span the host was in when
the gap began.
"""

from __future__ import annotations

import json
from typing import Dict, List, Tuple

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")  # device work in a Chrome trace
WINDOW = "duckbench.window"  # the annotation around the traced window


def read_trace(path: str):
    """(annotations, device work): the record_function spans {name: [(start,
    end)]}, and per kernel, copy or set on the card (category, name, start,
    end); microseconds on one clock."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return parse_events(events)


def parse_events(events: List[dict]):
    spans: Dict[str, List[Tuple[float, float]]] = {}
    work = []
    for e in events:
        cat = e.get("cat")
        if cat == "user_annotation":
            spans.setdefault(e["name"], []).append((float(e["ts"]), float(e["ts"] + e["dur"])))
        elif cat in DEVICE_CATS:
            work.append((cat, e["name"], float(e["ts"]), float(e["ts"] + e["dur"])))
    return spans, work


def merge(intervals) -> np.ndarray:
    """Sorted disjoint intervals covering `intervals` ((start, end) pairs)."""
    iv = np.array(sorted(intervals), dtype=np.float64).reshape(-1, 2)
    merged: List[List[float]] = []
    for a, b in iv:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return np.array(merged, dtype=np.float64).reshape(-1, 2)


def busy(merged: np.ndarray, a: float, b: float) -> float:
    """Length of [a, b] covered by the sorted disjoint intervals `merged`."""
    if merged.size == 0:
        return 0.0
    return float(np.clip(np.minimum(merged[:, 1], b) - np.maximum(merged[:, 0], a), 0, None).sum())


def summarize(spans, work, kernel: str, top: int = 10) -> dict:
    """The traced window: from the first device operation that starts
    inside the WINDOW annotation (or the trace, without one) to the last
    that ends inside it, so that neither the host's start under the
    profiler nor its closing synchronize counts as idle. Its length and
    device-busy seconds, the named kernel's launches and device seconds,
    the operations by device seconds (top `top`), the longest idle gaps
    (top `top`), each named by the host's innermost annotated span at the
    gap's start ("host" outside every span), and every device operation of
    the window (`inside`: (category, name, start, end), microseconds), for
    the readers of other kernels."""
    if spans.get(WINDOW):
        a, b = spans[WINDOW][0]
        inside = [w for w in work if w[2] >= a and w[3] <= b]
    else:
        inside = list(work)
    if inside:
        a, b = min(w[2] for w in inside), max(w[3] for w in inside)
    else:
        a = b = 0.0
    merged = merge([(w[2], w[3]) for w in inside])
    by_name: Dict[str, float] = {}
    for w in inside:
        by_name[w[1]] = by_name.get(w[1], 0.0) + (w[3] - w[2]) / 1e6
    k = [w for w in inside if w[0] == "kernel" and kernel in w[1]]
    edges = np.concatenate([[a], merged.reshape(-1), [b]])
    starts, lengths = edges[0::2], edges[1::2] - edges[0::2]
    named = sorted(((s, e, n) for n, ss in spans.items()
                    if n != WINDOW and not n.startswith("ProfilerStep") for s, e in ss),
                   key=lambda x: x[1] - x[0])
    gaps = []
    for i in np.argsort(-lengths, kind="stable")[:top]:
        if lengths[i] > 0:
            g0 = starts[i]
            host = next((n for s, e, n in named if s <= g0 < e), "host")
            gaps.append([host, float(lengths[i]) / 1e6])
    return dict(window_s=(b - a) / 1e6, busy_s=busy(merged, a, b) / 1e6,
                kernel_launches=len(k), kernel_s=sum(w[3] - w[2] for w in k) / 1e6,
                device_ops=sorted(([n, s] for n, s in by_name.items()), key=lambda x: -x[1])[:top],
                idle_gaps=gaps[:top], device_events=len(inside), inside=inside)
