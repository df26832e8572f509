"""The serving loops on the card as captured CUDA graphs.

The JAX package runs a decode chunk (``decode_steps_fused``) and a
speculative dispatch (``spec_steps_fused``) as one jitted lax.scan each.
The port runs the same Python loops once under stream capture
(``torch.cuda.CUDAGraph``) and replays the graph every round, so a round
costs the host one launch instead of thousands.

  LoopState  the running batch a scheduler serves from: ``tok``, the
             cache (and the draft cache) and the sampling generator,
             with its captured loops, one per degradation level. A
             scheduler borrows one from a LoopPool and writes
             admissions, evictions and scrubs into its tensors in place,
             so the addresses a graph holds stay valid.
  LoopPool   the states of one engine, by (kind, slots, cache length,
             dtype, chunk or rounds) and the EP binding their loops read.
             A state is lent to one live scheduler at a time, so a second
             ``Engine.generate`` or a ``recover()`` replays the graphs
             captured before; a second live scheduler gets a state, and
             captures, of its own. A new binding's state replaces the old
             one's once that is free.
  GraphLoop  one loop over one state, with static buffers for the
             per-round host operands, copied in before each replay. Its
             outputs are the captured ones, overwritten by the next
             replay, so a scheduler reads them first.

Capture, on the card, one at a time on one side stream per card: the
kernel library is loaded, one warm-up run on
clones of the state and of the generator loads the kernels' modules and
sets up cuBLAS without touching the live state, then the loop is
captured on the state's own tensors with capture_error_mode
"thread_local" (the front door captures from its serving thread). The
generator is registered with the graph, so a replay draws what the eager
loop would and advances the generator as far. The kernels count their
launches in Python, which a replay does not run: each counter's move
during the capture is added again on every replay, and the warm-up's and
the capture's own moves are taken back. A capture that fails raises;
there is no eager fallback on the card. On the CPU a GraphLoop runs the
loop as it is.
"""
from __future__ import annotations

import contextlib
import threading
import time
import weakref
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import kernels as K
from repro_torch.kernels import build

# run(tensors, generator, inputs) -> the loop's outputs
LoopFn = Callable[[Dict, torch.Generator, Dict[str, torch.Tensor]], tuple]


@contextlib.contextmanager
def launches_taken_back():
    """Yields a dict that, once the block ends, holds how far each
    kernel's launch counter moved inside it; the counters are then put
    back where they were."""
    before = K.launch_counts()
    moved: Dict[str, int] = {}
    try:
        yield moved
    finally:
        after = K.launch_counts()
        moved.update({k: after[k] - before[k] for k in before})
        for k, n in before.items():
            K.KERNELS[k].launches = n


def add_launches(moved: Dict[str, int]) -> None:
    """Count a replay's launches, as the wrappers would have."""
    for k, n in moved.items():
        K.KERNELS[k].launches += n


def _clone(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    if isinstance(x, torch.Generator):
        g = torch.Generator(device=x.device)
        g.set_state(x.get_state())
        return g
    return x


def _zero(tree: Dict) -> None:
    for v in tree.values():
        if isinstance(v, dict):
            _zero(v)
        else:
            v.zero_()


_SIDE: Dict[int, torch.cuda.Stream] = {}
_CAPTURING = threading.Lock()     # captures share the stream: one at a time


def _side_stream(dev) -> torch.cuda.Stream:
    """The stream every capture on ``dev`` runs on: one per card, since
    cuBLAS keeps a workspace for each stream it has run on for the life
    of the process, so a stream per capture would hold one more
    workspace of the card's memory with every capture."""
    i = dev.index if dev.index is not None else torch.cuda.current_device()
    if i not in _SIDE:
        _SIDE[i] = torch.cuda.Stream(i)
    return _SIDE[i]


class GraphLoop:
    """One loop ``run`` over a LoopState's tensors and generator,
    captured at construction on the card. ``inputs`` are its static
    operand buffers (name -> tensor on the state's device)."""

    def __init__(self, run: LoopFn, tensors: Dict, gen: torch.Generator,
                 inputs: Dict[str, torch.Tensor]):
        self.run = run
        self.tensors, self.gen = tensors, gen
        self.inputs = inputs
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out = None
        self.launches: Dict[str, int] = {}   # per replay
        self.capture_s = 0.0
        if gen.device.type == "cuda":
            self._capture(gen.device)

    def _capture(self, dev) -> None:
        t0 = time.perf_counter()
        build.lib()
        with _CAPTURING:
            side = _side_stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with launches_taken_back(), torch.cuda.stream(side):
                self.run(_clone(self.tensors), _clone(self.gen),
                         _clone(self.inputs))
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            graph.register_generator_state(self.gen)
            with launches_taken_back() as moved, torch.cuda.graph(
                    graph, stream=side, capture_error_mode="thread_local"):
                self.out = self.run(self.tensors, self.gen, self.inputs)
        self.graph, self.launches = graph, moved
        self.capture_s = time.perf_counter() - t0

    def __call__(self, **ops):
        """Copy the host operands (arrays, tensors or tuples by input
        name) into the static buffers, run the loop (replay its graph on
        the card) and return its outputs."""
        for k, v in ops.items():
            self.inputs[k].copy_(torch.as_tensor(v))
        if self.graph is None:
            return self.run(self.tensors, self.gen, self.inputs)
        self.graph.replay()
        add_launches(self.launches)
        return self.out


class LoopState:
    """A running batch (``tensors``: tok, cache, and dcache for the
    speculative loop; ``gen``) and its loops by degradation level."""

    def __init__(self, tensors: Dict, gen: torch.Generator):
        self.tensors = tensors
        self.gen = gen
        self.loops: Dict[int, GraphLoop] = {}
        self._holder: Optional[weakref.ref] = None

    @property
    def holder(self):
        """The live scheduler this state is lent to, or None."""
        return self._holder() if self._holder is not None else None

    def loop(self, level: int,
             make: Callable[[], Tuple[LoopFn, Dict[str, torch.Tensor]]]
             ) -> GraphLoop:
        """The loop of a degradation level, built (and captured) at its
        first use by ``make() -> (run, inputs)``."""
        if level not in self.loops:
            run, inputs = make()
            self.loops[level] = GraphLoop(run, self.tensors, self.gen, inputs)
        return self.loops[level]

    @property
    def capture_s(self) -> float:
        return sum(lp.capture_s for lp in self.loops.values())


class LoopPool:
    """The LoopStates of one engine (or of one scheduler made alone),
    each lent to at most one live scheduler at a time."""

    def __init__(self):
        self._states: Dict[tuple, List[LoopState]] = {}
        self._dropped_capture_s = 0.0

    def acquire(self, key: tuple, holder, make: Callable[[], LoopState],
                *, binding=None) -> LoopState:
        """A free state for ``key`` (one whose scheduler released it or
        no longer exists), its tensors zeroed as a fresh one's are, or a
        new one from ``make()``; lent to ``holder``.

        ``binding`` is what a captured loop reads besides the state's own
        tensors (``repro_torch.ep.binding_key``: an EP executor and its
        table shape). The free states of ``key`` under any other binding
        are dropped, so a new binding takes the place of the old one's
        running batch and graphs instead of adding to them."""
        for full in [f for f in self._states
                     if f[0] == key and f[1] != binding]:
            kept = [s for s in self._states[full] if s.holder is not None]
            self._dropped_capture_s += sum(
                s.capture_s for s in self._states[full] if s.holder is None)
            if kept:
                self._states[full] = kept
            else:
                del self._states[full]
        states = self._states.setdefault((key, binding), [])
        free = [s for s in states if s.holder is None]
        if free:
            state = free[0]
            _zero(state.tensors)
        else:
            state = make()
            states.append(state)
        state._holder = weakref.ref(holder)
        return state

    @staticmethod
    def release(state: LoopState) -> None:
        state._holder = None

    def states(self) -> List[LoopState]:
        return [s for ss in self._states.values() for s in ss]

    @property
    def capture_s(self) -> float:
        """Seconds spent capturing, summed over every loop (dropped
        states' included)."""
        return self._dropped_capture_s + sum(s.capture_s
                                             for s in self.states())
