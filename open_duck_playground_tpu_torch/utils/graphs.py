"""Bodies over fixed buffers, replayed as CUDA graphs on the card.

The JAX package jits its env step, its rollout (a ``lax.scan``), its eval
episode and its SGD step: each is one device program. Their counterparts
here are `Captured` programs. A graph replays fixed addresses, so each
program is written as a *body*: a function of static copies of its inputs
that reads fixed tensors and writes its results into fixed tensors (its
buffers), in place. `GraphedBody` records the body once and replays it on
a CUDA device, and runs it eagerly at each replay on any other: the one
place the port chooses between the two. A body that must stop for a
collective (the env-sharded SGD step) is a generator: each `yield` ends
one graph segment, and the collective runs between two replays
(`between`).

Tree helpers for the nested dicts and dataclasses of tensors the bodies
work on: `tree_map`, `tree_leaves`, and `copy_into`, which copies one tree
into the buffers of another of the same structure.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import gc
import inspect
import json
import statistics
import time
from typing import Any, Callable, Dict, Iterable, List, Optional

import torch

from open_duck_playground_tpu_torch.utils import profiling


def tree_map(fn, x):
    """`fn` over every tensor of nested dicts and dataclasses (None stays)."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, dict):
        return {k: tree_map(fn, v) for k, v in x.items()}
    return dataclasses.replace(x, **{f.name: tree_map(fn, getattr(x, f.name))
                                     for f in dataclasses.fields(x)})


def tree_leaves(x, prefix: str = "", out: Optional[Dict[str, torch.Tensor]] = None
                ) -> Dict[str, torch.Tensor]:
    """{path: tensor} of every tensor of nested dicts and dataclasses, in a
    fixed order (a None field, one the engine does not fill, is left out)."""
    out = {} if out is None else out
    if x is None:
        return out
    if isinstance(x, torch.Tensor):
        out[prefix] = x
    elif isinstance(x, dict):
        for k, v in x.items():
            tree_leaves(v, f"{prefix}/{k}", out)
    else:
        for f in dataclasses.fields(x):
            tree_leaves(getattr(x, f.name), f"{prefix}/{f.name}", out)
    return out


@torch.no_grad()
def copy_into(dst, src) -> None:
    """Every tensor of `src` copied into the tensor at the same place of
    `dst` (one structure, one shape per place). A tensor of `src` that is
    its own place's tensor of `dst` is left alone; one that shares storage
    with another tensor of `dst` is cloned before any copy runs. A step
    hands some of its inputs on to other places (the last action becomes
    the one before it), so copying in place must not read a buffer it has
    already overwritten."""
    a, b = tree_leaves(dst), tree_leaves(src)
    if a.keys() != b.keys() or any(t.shape != b[k].shape for k, t in a.items()):
        raise ValueError(f"cannot copy {({k: tuple(v.shape) for k, v in b.items()})} into "
                         f"{({k: tuple(v.shape) for k, v in a.items()})}")
    storages = {t.untyped_storage().data_ptr() for t in a.values()}
    pending = []
    for k, t in a.items():
        s = b[k]
        if s is t:
            continue
        if s.untyped_storage().data_ptr() in storages:
            s = s.clone()
        pending.append((t, s))
    for t, s in pending:
        t.copy_(s)


def clone_tree(x):
    """Distinct copies of every tensor of `x`, for buffers: a tensor that
    appears at two places (reset puts the first state in the autoreset
    cache) becomes two."""
    return tree_map(torch.clone, x)


_END = object()  # what a body's run yields after its last segment
# CUgraphNodeType (cudaGraphNodeType): the kinds of node a capture makes
_NODE_KINDS = {0: "kernel", 1: "memcpy", 2: "memset"}


@functools.lru_cache(maxsize=1)
def _driver():
    cu = ctypes.CDLL("libcuda.so.1")
    cu.cuGraphGetNodes.restype = ctypes.c_int
    cu.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_size_t)]
    cu.cuGraphNodeGetType.restype = ctypes.c_int
    cu.cuGraphNodeGetType.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    return cu


def node_counts(graph: torch.cuda.CUDAGraph) -> Dict[str, int]:
    """The nodes of a captured graph (made with keep_graph=True) by kind:
    kernel, memcpy, memset, other. Read from its cudaGraph_t through the
    CUDA driver that torch's runtime calls (cuGraphGetNodes,
    cuGraphNodeGetType: the runtime's cudaGraphGetNodes and
    cudaGraphNodeGetType are these). A replay launches the kernel nodes,
    and the CUDA driver runs each device-to-device memcpy node as a kernel of its
    own too (the profiler's ``memcpy32_post``)."""
    cu, g = _driver(), ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    err = cu.cuGraphGetNodes(g, None, ctypes.byref(n))
    nodes = (ctypes.c_void_p * n.value)()
    err = err or cu.cuGraphGetNodes(g, nodes, ctypes.byref(n))
    kind = ctypes.c_int(0)
    counts = {k: 0 for k in (*_NODE_KINDS.values(), "other")}
    for node in nodes:
        err = err or cu.cuGraphNodeGetType(node, ctypes.byref(kind))
        counts[_NODE_KINDS.get(kind.value, "other")] += 1
    if err != 0:
        raise RuntimeError(f"counting a graph's nodes failed: CUresult {err}")
    return counts


class GraphedBody:
    """`body` recorded once as CUDA graphs and replayed, on a CUDA device;
    run eagerly at each replay on any other (`captures`).

    `body` is a function of no arguments, or a generator function whose
    every `yield x` is a point between two segments of it (the env-sharded
    SGD step yields a fixed buffer at each collective): each segment is
    then a CUDA graph of its own, all of one memory pool, replayed in the
    order captured, with `between(x)` run eagerly at each point (the
    collective, in place on that buffer). A plain function is one segment.
    `replay()` returns what the body returned (`result`): at its capture on
    the card (tensors the graphs write), at this run elsewhere.
    `buffers`: the tensors the body overwrites that outlive it (its state);
    `generators`: every torch.Generator the body draws from; `kernels`: the
    objects that count the launches (`launches`) of each hand-written
    kernel the body launches, each with its `name` (the env's
    FusedPhysics, the optimizer's ``ops.cuda_step.ADAM``, the GAE kernel's
    ``ops.cuda_step.GAE``, the swish's ``ops.cuda_step.SWISH``). `log`, if
    given, gets one line "<name> captured: {info}" (seconds of the
    warm-up, the capture and the instantiation, the graph pool's bytes, the fused
    launches per replay, in all and by kernel name, the kernel, memcpy and memset nodes summed over the
    segments (`node_counts`; the kernel nodes without the tracer's stamp
    nodes, counted apart), the segments, and `extra`).

    `capture()` (or the first `replay()`): the body runs once eagerly on a
    side stream, as a warm-up (cuBLAS workspaces of that stream, the fused
    kernel's tables, attributes and module, a segmented body's buffers,
    `between` at every point), from snapshots of the buffers and of the
    generators' states, which are restored after it; then each segment is
    captured on that stream with every generator registered with its
    graph, and instantiated. Capture runs nothing, `between` included. A
    replay then reads each generator's state as it stands (a `set_state`
    is obeyed) and advances it as the eager body would. The warm-up's
    kernel launches are real and stay counted; the capture's are taken off
    each kernel's `launches`, and each replay adds back the number of
    fused launches its capture recorded. A capture or replay that fails
    raises: nothing falls back to the eager body.

    Off the card `capture()` does nothing, and `replay()` runs the body
    once, `between(x)` at each point (as dist.run_points does): no
    warm-up, no snapshot, no node count; `replays` counts all the same.

    Python's cyclic collector is run before the capture and kept off during
    it: a CUDA graph it frees while this one captures would invalidate the
    capture (destroying a graph is not permitted while a stream captures).
    For the same reason `body` should not reference the object that owns
    this GraphedBody: the pair would be a cycle that only the collector
    frees.

    The tracer (utils/profiling.py): the capture is the span
    ``graph.capture``, and the seconds of its warm-up, capture and
    instantiation in `info` are its children ``graph.capture.warmup``,
    ``.record`` and ``.instantiate`` (`profiling.add`). With the tracer on,
    the device spans the body opens while a segment is captured become
    that segment's template of stamps, which each replay of the segment
    hands to the tracer. The node counts
    are taken at every capture, the tracer on or off, and noted under
    `name` (profiling.graphs); ``replays`` is the tracer's
    ``graph.replays``."""

    def __init__(self, body: Callable[[], Any], buffers: Iterable[torch.Tensor],
                 generators: Iterable[torch.Generator] = (), kernels: Iterable[Any] = (),
                 device=None, name: str = "body", log=None,
                 extra: Optional[Dict[str, Any]] = None,
                 between: Optional[Callable[[Any], Any]] = None):
        self.device = torch.device(device)
        self.eager = not self.captures(self.device)
        self.body, self.name, self.log, self.between = body, name, log, between
        self.result: Any = None
        self.buffers: List[torch.Tensor] = list(buffers)
        self.generators = list(generators)
        self.kernels = list(kernels)
        self.graphs: List[Any] = []
        self.points: List[Any] = []  # what each segment yields (_END after the last)
        self.templates: List[Optional[profiling.Template]] = []  # each segment's stamps
        self.segment_capture_s: List[float] = []
        self.replays = 0
        self.launches_per_replay: List[int] = []
        self.info: Dict[str, Any] = {}
        self._extra = dict(extra or {})
        profiling.watch(self, "replays", "graph.replays")

    @staticmethod
    def captures(device) -> bool:
        """Whether a body on `device` is recorded as CUDA graphs (a CUDA
        device) or run eagerly at each replay (any other): the port's one
        test of that choice."""
        return torch.device(device).type == "cuda"

    @property
    def graph(self):
        """The first segment's graph (a plain body's only one); None before
        the capture, and off the card."""
        return self.graphs[0] if self.graphs else None

    def _run(self):
        """The body, yielding at its points (nothing for a plain function);
        what it returns is kept as `result`."""
        out = self.body()
        if inspect.isgenerator(out):
            out = yield from out
        self.result = out

    def capture(self) -> None:
        """Record the body, once (nothing off the card)."""
        if self.eager or self.graphs:
            return
        with profiling.span("graph.capture"):
            self._capture()

    def _capture(self) -> None:
        dev = self.device
        with torch.no_grad():
            saved = [t.clone() for t in self.buffers]
        gen_states = [g.get_state() for g in self.generators]
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        t0 = time.perf_counter_ns()
        with torch.cuda.stream(stream):
            for point in self._run():
                self.between(point)
        torch.cuda.current_stream(dev).wait_stream(stream)
        with torch.no_grad():
            for t, s in zip(self.buffers, saved):
                t.copy_(s)
        for g, s in zip(self.generators, gen_states):
            g.set_state(s)
        torch.cuda.synchronize(dev)
        t1 = time.perf_counter_ns()
        profiling.add("graph.capture.warmup", t0, t1)
        del saved
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        pool = torch.cuda.graph_pool_handle()
        counts = [k.launches for k in self.kernels]
        graphs, points, seconds, templates = [], [], [], []
        run = self._run()
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        t2 = time.perf_counter_ns()
        try:
            while not points or points[-1] is not _END:
                graph = torch.cuda.CUDAGraph(keep_graph=True)
                for g in self.generators:
                    graph.register_generator_state(g)
                tpl = profiling.template(dev)
                t_seg = time.perf_counter()
                with torch.cuda.graph(graph, pool=pool, stream=stream), profiling.recording(tpl):
                    points.append(next(run, _END))
                seconds.append(time.perf_counter() - t_seg)
                graphs.append(graph)
                templates.append(tpl if tpl is not None and tpl.entries else None)
        finally:
            if collecting:
                gc.enable()
        t3 = time.perf_counter_ns()
        profiling.add("graph.capture.record", t2, t3)
        self.launches_per_replay = [k.launches - n for k, n in zip(self.kernels, counts)]
        for k, n in zip(self.kernels, counts):
            k.launches = n  # the capture launched nothing
        t4 = time.perf_counter_ns()
        for graph in graphs:
            graph.instantiate()
        torch.cuda.synchronize(dev)
        t5 = time.perf_counter_ns()
        profiling.add("graph.capture.instantiate", t4, t5)
        self.graphs, self.points, self.segment_capture_s = graphs, points, seconds
        self.templates = templates
        stamps = sum(t.n for t in templates if t is not None)
        nodes = {f"{k}_nodes": 0 for k in _NODE_KINDS.values()}
        for graph in graphs:
            for k, n in node_counts(graph).items():
                if k in _NODE_KINDS.values():
                    nodes[f"{k}_nodes"] += n
        nodes["kernel_nodes"] -= stamps  # the program's kernels, the tracer's left out
        profiling.note_graph(self.name, **nodes, segments=len(graphs))
        self.info = {"warmup_s": round((t1 - t0) / 1e9, 4),
                     "capture_s": round((t3 - t2) / 1e9, 4),
                     "instantiate_s": round((t5 - t4) / 1e9, 4),
                     "pool_bytes": torch.cuda.memory_reserved(dev) - reserved,
                     "fused_launches_per_replay": sum(self.launches_per_replay),
                     "launches_per_replay": {k.name: n for k, n in
                                             zip(self.kernels, self.launches_per_replay)},
                     **nodes, **self._extra}
        if stamps:
            self.info["stamp_nodes"] = stamps
        if len(graphs) > 1:
            self.info.update(segments=len(graphs),
                             segment_capture_s_median=round(statistics.median(seconds), 6),
                             segment_capture_s_max=round(max(seconds), 6))
        if self.log is not None:
            self.log(f"{self.name} captured: {json.dumps(self.info)}")

    def replay(self) -> Any:
        if self.eager:
            for point in self._run():
                self.between(point)
        else:
            self.capture()
            for graph, point, tpl in zip(self.graphs, self.points, self.templates):
                graph.replay()
                if tpl is not None:
                    profiling.replayed(tpl)
                if point is not _END:
                    self.between(point)
            for k, n in zip(self.kernels, self.launches_per_replay):
                k.launches += n
        self.replays += 1
        return self.result


class Captured:
    """A device program: `body` over static copies of a call's inputs,
    replayed by a GraphedBody (CUDA graphs on the card, the body run
    eagerly elsewhere). The port's env step, rollout, SGD step and eval
    step are each one, adapted to the signature of the function it
    replaces (envs/wrapper.py, train/ppo.py).

    `run(inputs, reads)`: `inputs` is a dict of trees. The first call
    clones it into static buffers (`static`) and builds the GraphedBody of
    `body(static)` (its info adds `static_input_bytes` to `extra`); a later
    call copies `inputs` into them under the span ``<prefix>.copy_in``
    (copy_into: a leaf that is its own buffer is left alone, and a call
    whose every entry is the static one opens no span). Every call then
    replays under ``<prefix>.replay`` and returns what the body returned,
    on the card the tensors its capture wrote: the next call overwrites
    them. `reads`: what the body reads by reference, not through `inputs` (the
    params and normalizer, the env, the shard), given at construction and
    handed again at every call, checked by identity (a graph keeps the
    addresses it captured: restore into them, do not rebind them); its
    tensors are snapshotted for the warm-up with the static buffers.

    `body` takes the static dict; it may be a generator function with
    collective points, and should not reference this object (GraphedBody).
    `generators`, `kernels`, `device`, `name`, `log`, `between` and `extra`
    are GraphedBody's. With `log`, the constructor logs one line "<name>:
    <what>, <how it runs>"."""

    def __init__(self, body: Callable[[Any], Any], reads: Iterable[Any] = (),
                 generators: Iterable[torch.Generator] = (), kernels: Iterable[Any] = (),
                 device=None, name: str = "body", prefix: str = "body", what: str = "one replay",
                 log=None, between: Optional[Callable[[Any], Any]] = None,
                 extra: Optional[Dict[str, Any]] = None):
        self.body, self.reads = body, list(reads)
        self.generators, self.kernels = list(generators), list(kernels)
        self.device, self.name, self.prefix = torch.device(device), name, prefix
        self.log, self.between, self.extra = log, between, extra
        self.static: Any = None
        self.graph: Optional[GraphedBody] = None
        if log is not None:
            how = (f"CUDA graphs on {self.device}, captured at the first call"
                   if GraphedBody.captures(self.device) else
                   f"run eagerly on {self.device} (no CUDA graph off the card)")
            log(f"{name}: {what}, {how}")

    @property
    def replays(self) -> int:
        return 0 if self.graph is None else self.graph.replays

    @property
    def info(self) -> Dict[str, Any]:
        """The capture's GraphedBody.info ({} before it, and off the card)."""
        return {} if self.graph is None else self.graph.info

    def load(self, inputs, reads: Iterable[Any] = ()) -> None:
        """Check `reads`, then the first call's clone or a later call's copy
        of `inputs` into the static buffers."""
        reads = list(reads)
        if len(reads) != len(self.reads) or any(a is not b for a, b in zip(reads, self.reads)):
            raise ValueError(f"{self.name} reads what it was made for: hand it the same objects "
                             "(restore into its tensors, do not rebind them)")
        if self.graph is None:
            self.static = clone_tree(inputs)
            leaves = list(tree_leaves(self.static).values())
            extra = {"static_input_bytes": sum(t.numel() * t.element_size() for t in leaves),
                     **(self.extra or {})}
            buffers = leaves + [t for t in self.reads if isinstance(t, torch.Tensor)]
            self.graph = GraphedBody(functools.partial(self.body, self.static), buffers,
                                     self.generators, self.kernels, self.device, self.name,
                                     self.log, extra, self.between)
            return
        if inputs.keys() != self.static.keys() or any(v is not self.static[k]
                                                       for k, v in inputs.items()):
            with profiling.span(f"{self.prefix}.copy_in", self.device):
                copy_into(self.static, inputs)

    def run(self, inputs, reads: Iterable[Any] = ()) -> Any:
        self.load(inputs, reads)
        with profiling.span(f"{self.prefix}.replay"):
            return self.graph.replay()
