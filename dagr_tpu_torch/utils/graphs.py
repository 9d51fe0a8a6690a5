"""Compiled steps: one step function replayed from CUDA graphs.

The port's counterpart of the JAX package's jitted steps with the state
donated.  ``StepGraphs`` runs a step body for every ``make_*`` of the
port (the engine's steps, the server's step and chain, the sync and eval
forwards, the recipe train step):

* On a CPU device it calls the body eagerly: that is the path the caller
  chose, and the tests run it.
* On a CUDA device, per graph key (the caller's key and the inputs'
  shapes and dtypes), the first ``WARMUP`` calls run the body eagerly on
  the device's one side stream: real steps on the caller's state, which
  also fill the step's lazily made device tables (``DeviceConsts``, the
  ``lru_cache``d tables), whose first use copies from pageable host
  memory.  The next call captures the body, on that stream, into a
  ``torch.cuda.CUDAGraph`` whose memory pool all graphs of one
  ``StepGraphs`` share, with the inputs copied into static device
  buffers, then replays it; later calls copy the inputs into those
  buffers and replay.  The state is updated in place
  by the captured kernels.  A capture that fails raises: there is no
  eager fallback on the card.
* The outputs of a replay are copied out, so that a caller keeping a
  step's outputs never sees the next replay overwrite them.
* The graphs are bound to one state, the first one a call passes; a
  call with another raises.
* The body's Python side effects run once, at capture: a host counter
  (``ServeState.steps``, ``TrainState.step``) is advanced by the caller
  of ``StepGraphs`` on every call, never by the body.
* With ``utils.trace`` on, a call is a ``step`` span with its copy-in,
  warm-up, capture, launch and copy-out inside; a graph captured then
  times its body's stages, read before the next replay without waiting
  (``trace.replaying``); the warm-ups, captures and replays per key
  (``counts``) and ``recaptures`` are this module's own counts.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Hashable, Optional, Sequence

import torch
from torch.utils._pytree import tree_map

from dagr_tpu_torch.utils import trace

WARMUP = 2     # eager calls per graph key before its capture
# one side stream per device for every warm-up and capture: cuBLAS keeps
# a workspace for each stream that runs a product, for the life of the
# process, so a stream per call would hold one workspace each
_SIDE_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


def _side_stream(device: torch.device) -> "torch.cuda.Stream":
    if device not in _SIDE_STREAMS:
        _SIDE_STREAMS[device] = torch.cuda.Stream(device)
    return _SIDE_STREAMS[device]


def _same_state(a, b) -> bool:
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(x is y for x, y in zip(a, b))
    return a is b


def _clone(x):
    return x.clone() if torch.is_tensor(x) else x


class _Graph:
    __slots__ = ("calls", "graph", "inputs", "outputs", "stages")

    def __init__(self):
        self.calls = 0
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.inputs: Sequence[torch.Tensor] = ()
        self.outputs: Any = None
        # (name, begin event, end event) of each stage, in the graph when
        # the recording was on at its capture (utils.trace)
        self.stages: Sequence = ()


class StepGraphs:
    """The captured graphs of one step function on ``device`` (see the
    module docstring).  ``name`` appears in errors."""

    def __init__(self, device, name: str):
        self.device = torch.device(device)
        self.name = name
        self.cuda = self.device.type == "cuda"
        self.pool = torch.cuda.graph_pool_handle() if self.cuda else None
        self.graphs: Dict[Hashable, _Graph] = {}
        self.recaptures = 0      # captures after the first replay
        self._state = None
        self._bound = False
        trace.register(self)

    def __call__(self, key: Hashable, body: Callable, inputs: Sequence,
                 state=None):
        """``body(*inputs)`` -> a tree of tensors (the step's outputs),
        eagerly on a CPU device, else from the graph of ``key`` (see the
        module docstring); ``inputs`` are tensors, moved to the device."""
        if self._bound and not _same_state(state, self._state):
            raise ValueError(f"{self.name}: its graphs are bound to another "
                             "state; make a new step for this one")
        self._state, self._bound = state, True
        with trace.span("step", self) as sp:
            if not self.cuda:
                return body(*inputs)
            with trace.span("step.copy_in"):
                inputs = [x.to(self.device) for x in inputs]
                key = (key,) + tuple((tuple(x.shape), x.dtype)
                                     for x in inputs)
                g = self.graphs.setdefault(key, _Graph())
                if g.graph is not None:
                    for static, x in zip(g.inputs, inputs):
                        static.copy_(x)
            if sp is not None:
                sp.key = key
            side = _side_stream(self.device)
            if g.calls < WARMUP:
                g.calls += 1
                with trace.span("step.warmup"):
                    side.wait_stream(torch.cuda.current_stream(self.device))
                    with torch.cuda.stream(side):
                        out = body(*inputs)
                    torch.cuda.current_stream(self.device).wait_stream(side)
                return out
            if g.graph is None:
                with trace.span("step.capture"):
                    if self.replays():
                        self.recaptures += 1
                    g.inputs = [x.clone() for x in inputs]
                    graph = torch.cuda.CUDAGraph()
                    with trace.capture(g), torch.cuda.graph(
                            graph, pool=self.pool, stream=side):
                        g.outputs = body(*g.inputs)
                    g.graph = graph
            g.calls += 1
            trace.replaying(self, key, g)
            with trace.span("step.launch"):
                g.graph.replay()
            with trace.span("step.copy_out"):
                return tree_map(_clone, g.outputs)

    def replays(self) -> int:
        """Calls served by a replay so far, over every graph."""
        return sum(max(g.calls - WARMUP, 0) for g in self.graphs.values())

    def counts(self) -> Dict[Hashable, Dict[str, int]]:
        """Per graph key: the eager warm-ups, captures and replays."""
        return {k: {"warmups": min(g.calls, WARMUP),
                    "captures": int(g.graph is not None),
                    "replays": max(g.calls - WARMUP, 0)}
                for k, g in self.graphs.items()}
