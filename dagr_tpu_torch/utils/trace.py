"""Spans, stage times and counters of the compiled steps; off by default.

``enable()`` starts a recording and ``disable()`` ends it; nothing else
switches it.  Off, ``span`` and ``stage`` hand back one shared no-op
context: no allocation, no device operation, no synchronise, and a graph
captured then holds no node of this module.

* A span (``span(name)``) is a stretch of host time: its name, start and
  end (``time.time_ns()``, ``CLOCK_REALTIME``, the clock that
  ``torch.profiler`` converts its timestamps to: a profiler event's
  ``time_range`` in us is its ns less the capture's ``trace_start_ns``,
  over 1000), the span it opened inside, and its call: the outermost
  span open when it began, so that every span of one request or step
  shares one identifier.  A ``step`` span (``StepGraphs.__call__``)
  also names its ``StepGraphs`` and graph key.  Spans are kept in a ring
  of ``RING`` entries; when it is full the oldest is overwritten and
  ``spans_dropped`` counts it.  While a ``torch.profiler`` capture runs,
  each span is also entered as a profiler range of the same name (about
  1 us a span), so a capture with host activity shows it.
* A stage (``stage(name)``) is a stretch of a step body's device work.
  Inside a CUDA-graph capture it records a pair of timing events
  (``external``: real event nodes of the graph), so every replay of that
  graph times it; a replay's stage times are read before the next
  replay of its ``StepGraphs`` (``replaying``), or at ``snapshot()``,
  if the events have completed, and otherwise the replay counts as
  unread: reading never waits.  A graph carries stage events if and
  only if the recording was on at its capture.  In a step body run
  eagerly on the CPU a stage is a span (the host time is the device
  time there) and adds to the same sums.  In an eager warm-up on the
  card it records nothing.
* The counters are the ones ``StepGraphs`` keeps (``_Graph.calls``):
  warm-ups, captures and replays per ``StepGraphs`` name and graph key,
  ``recaptures`` (a capture after that ``StepGraphs``' first replay: a
  new shape compiled mid-run), and the stage reads and unread replays.

Names: spans ``step``, ``step.copy_in``, ``step.warmup``,
``step.capture``, ``step.launch``, ``step.copy_out``
(``utils/graphs.py``); ``forward`` (``serve.window_forward``),
``serve.chain`` (``MultiStreamServer.make_chain``) and ``train.step``
(``make_train_step``, ``make_train_step_fusion``).  Stages
``train.forward``, ``train.loss``, ``train.backward``, ``train.update``
(``train/state.py``) and ``serve.event_level`` (the server's step up to
its dense tail).  One thread records at a time.
"""
from __future__ import annotations

import time
import weakref
from typing import Dict, List, Optional

import torch
from torch.autograd import profiler as _profiler

RING = 1 << 16      # spans kept


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NOOP = _Noop()
_STEP_GRAPHS: "weakref.WeakSet" = weakref.WeakSet()


class _Recording:
    def __init__(self):
        self.ring: List[Optional[tuple]] = [None] * RING
        self.written = 0
        self.next_id = 0
        self.open: List["_Span"] = []
        self.capturing: Optional[list] = None   # a capture's stage list
        self.host_stages = False                # inside an eager CPU step
        self.stage_ms: Dict[str, float] = {}
        self.stage_n: Dict[str, int] = {}
        # (StepGraphs name, key) -> [replays read, replays unread]
        self.reads: Dict[tuple, List[int]] = {}
        # StepGraphs -> (key, graph) of its last replay, stages unread
        self.pending: "weakref.WeakKeyDictionary" = (
            weakref.WeakKeyDictionary())

    def add_stage(self, name: str, ms: float) -> None:
        self.stage_ms[name] = self.stage_ms.get(name, 0.0) + ms
        self.stage_n[name] = self.stage_n.get(name, 0) + 1


_R: Optional[_Recording] = None


def enable() -> None:
    """Start a new recording (what an earlier one held is dropped)."""
    global _R
    _R = _Recording()


def disable() -> None:
    global _R
    _R = None


def enabled() -> bool:
    return _R is not None


class _Span:
    __slots__ = ("r", "name", "graph", "key", "sid", "parent", "call", "t0",
                 "rf", "host_before", "stage")

    def __init__(self, r: _Recording, name: str, graph=None, stage=False):
        self.r, self.name, self.graph, self.stage = r, name, graph, stage
        self.key = None

    def __enter__(self):
        r = self.r
        self.sid = r.next_id
        r.next_id += 1
        self.parent = r.open[-1].sid if r.open else -1
        self.call = r.open[0].sid if r.open else self.sid
        r.open.append(self)
        if self.graph is not None:
            self.host_before = r.host_stages
            r.host_stages = not self.graph.cuda
        self.rf = (torch._C._autograd._record_function_with_args_enter(
            self.name) if _profiler._is_profiler_enabled else None)
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        r = self.r
        if self.rf is not None:
            torch._C._autograd._record_function_with_args_exit(self.rf)
        r.open.pop()
        graph = None
        if self.graph is not None:
            r.host_stages = self.host_before
            graph = self.graph.name
        if self.stage:
            r.add_stage(self.name, (t1 - self.t0) * 1e-6)
        r.ring[r.written % len(r.ring)] = (
            self.sid, self.name, self.t0, t1, self.parent, self.call, graph,
            None if self.key is None else str(self.key))
        r.written += 1
        return False


def span(name: str, graph=None):
    """A span named ``name`` (a context; ``graph``: the ``StepGraphs``
    of a ``step`` span, whose key the caller may set on it)."""
    r = _R
    if r is None:
        return NOOP
    return _Span(r, name, graph)


class _StageEvents:
    __slots__ = ("name", "stages", "begin")

    def __init__(self, name: str, stages: list):
        self.name, self.stages = name, stages

    def __enter__(self):
        self.begin = torch.cuda.Event(enable_timing=True, external=True)
        self.begin.record()
        return None

    def __exit__(self, *exc):
        end = torch.cuda.Event(enable_timing=True, external=True)
        end.record()
        self.stages.append((self.name, self.begin, end))
        return False


def stage(name: str):
    """A stage of a step body named ``name`` (a context; see the module
    docstring)."""
    r = _R
    if r is None:
        return NOOP
    if r.capturing is not None:
        return _StageEvents(name, r.capturing)
    if r.host_stages:
        return _Span(r, name, stage=True)
    return NOOP


class _Capture:
    __slots__ = ("r", "g")

    def __init__(self, r: _Recording, g):
        self.r, self.g = r, g

    def __enter__(self):
        self.g.stages = self.r.capturing = []
        return None

    def __exit__(self, *exc):
        self.r.capturing = None
        return False


def capture(g):
    """The context of a capture of the graph ``g`` (a ``_Graph``): the
    stages its body meets go into ``g.stages``."""
    r = _R
    if r is None:
        return NOOP
    return _Capture(r, g)


def register(step_graphs) -> None:
    """Let ``snapshot`` read the counters of ``step_graphs``."""
    _STEP_GRAPHS.add(step_graphs)


def _read(r: _Recording, step_graphs, key, g) -> None:
    """Add a replay of ``g`` (the graph of ``key`` in ``step_graphs``) to
    the stage sums if its events have completed, else count it unread;
    never waits."""
    tally = r.reads.setdefault((step_graphs.name, str(key)), [0, 0])
    if not g.stages[-1][2].query():
        tally[1] += 1
        return
    for stage_name, begin, end in g.stages:
        r.add_stage(stage_name, begin.elapsed_time(end))
    tally[0] += 1


def replaying(step_graphs, key, g) -> None:
    """Called just before ``g``, the graph of ``key`` in ``step_graphs``,
    replays: the stage times of ``step_graphs``' last replay are read
    (while its events still hold them), and this replay's, if ``g``
    carries stages, are left for the next."""
    r = _R
    if r is None:
        return
    last = r.pending.pop(step_graphs, None)
    if last is not None:
        _read(r, step_graphs, *last)
    if g.stages:
        r.pending[step_graphs] = (key, g)


def snapshot() -> Dict:
    """What is recorded so far: ``spans`` (oldest first, each a dict of
    ``id``, ``name``, ``start_ns``, ``end_ns``, ``parent`` (-1 at the
    top), ``call``, ``graph`` and ``key`` (a ``step`` span's, else
    None)), ``spans_dropped``, ``stages`` ({stage: {"ms": summed ms,
    "n": replays read}}) and ``counters`` ({StepGraphs name:
    {"recaptures": n, "keys": {key: {"warmups", "captures", "replays",
    "stage_reads", "stage_unread"}}}}, summed over the ``StepGraphs`` of
    one name).  Replays whose stage events have completed are read
    first."""
    r = _R
    spans, dropped, stages, reads = [], 0, {}, {}
    if r is not None:
        for sg, last in list(r.pending.items()):
            _read(r, sg, *last)
        r.pending.clear()
        dropped = max(r.written - len(r.ring), 0)
        spans = [dict(zip(("id", "name", "start_ns", "end_ns", "parent",
                           "call", "graph", "key"), r.ring[i % len(r.ring)]))
                 for i in range(dropped, r.written)]
        stages = {k: {"ms": r.stage_ms[k], "n": r.stage_n[k]}
                  for k in r.stage_ms}
        reads = r.reads
    counters: Dict[str, Dict] = {}

    def graph(name):
        return counters.setdefault(name, {"recaptures": 0, "keys": {}})

    def row(name, key):
        return graph(name)["keys"].setdefault(key, dict.fromkeys(
            ("warmups", "captures", "replays", "stage_reads",
             "stage_unread"), 0))

    for sg in list(_STEP_GRAPHS):
        graph(sg.name)["recaptures"] += sg.recaptures
        for key, c in sg.counts().items():
            out = row(sg.name, str(key))
            for k, v in c.items():
                out[k] += v
    for (name, key), (n_read, n_unread) in reads.items():
        out = row(name, key)
        out["stage_reads"] += n_read
        out["stage_unread"] += n_unread
    return {"spans": spans, "spans_dropped": dropped, "stages": stages,
            "counters": counters}
