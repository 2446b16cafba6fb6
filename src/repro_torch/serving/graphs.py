"""The fused decode round and the bucketed admission as captured CUDA
graphs: the port's counterpart of the JAX engine's executor layer
(``_executor``, ``repro/serving/engine.py:83-107``; the jitted, donated
round at ``:237-239``, ``:304-307``, ``:828-879``; the admission chain
``_prefill_len`` -> ``_greedy`` -> ``_merge``/``_append`` -> ``_SET_TOK``
at ``:106``, ``:224-247``, ``:308-310``, ``:518-633``).

JAX compiles a decode round into one executable, dispatched once, over
donated buffers that XLA updates in place.  Here a ``FunctionInstance``
keeps every buffer that crosses rounds at a fixed address (the KV pools,
the slot-token vector, the positions and, paged, the block tables and the
active mask), its round writes all of them in place, and ``RoundGraph``
captures that op chain into one ``torch.cuda.CUDAGraph``:
on the card a round is one graph launch from the host instead of one
launch per op.

One graph per instance.  JAX shares its executables per model across
instances; a CUDA graph holds the addresses of its own instance's pools,
so it cannot be shared.  Each graph has a private memory pool for its
intermediates.  The round's outputs (the slot tokens and positions) live
in the instance's buffers, outside every pool, so with ``overlap=True``
one instance's replay never overwrites another's tokens before that
instance's sync reads them.

- The first round of an instance runs eagerly: it builds the kernel
  library and cuBLAS's state.  The second is captured and then replayed
  (capture records the round without running it, so no round runs
  twice); later rounds replay.  An instance captures once in its life.
- A failed capture raises, and every later round of the graph raises
  too: there is no eager fallback.
- A replay runs no kernel wrapper, so it adds the launch counts that the
  wrappers recorded while the round was captured (``kernels.COUNTED``);
  the capture itself counts none.
- On the CPU, where CUDA graphs do not exist, every round runs eagerly.

``PrefillGraphs`` applies the same rules to an instance's admissions of
the dense family, one ``RoundGraph`` per prefill bucket (JAX compiles
``_prefill_len`` once per bucket shape): the first admission of a bucket
runs eagerly, the second is captured and replayed, later ones replay.
The bucket graphs of one instance share one memory pool: they never run
at once, each reads only the instance's argument buffer and writes only
the instance's pools and token buffers (outside every pool), and the one
output each keeps (its logits row, for checks) stays allocated, so no
other graph of the pool writes there.  Whatever else one leaves in the
pool the next may overwrite, in any order of replay.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from repro_torch import kernels


class RoundGraph:
    """One instance's round, ``body`` (a callable over fixed buffers, which
    it writes in place): eager first, then a captured CUDA graph.
    ``outputs`` is what ``body`` returned at capture; each replay
    refreshes those tensors in place.  ``body`` is passed to each call and
    never kept, so an instance that holds its graph forms no reference
    cycle and its pools are freed as soon as it is dropped."""

    def __init__(self, device: torch.device, pool: Any = None):
        self.device = torch.device(device)
        self.pool = pool  # a memory pool shared with other graphs, or None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs: Any = None
        self.eager_rounds = 0
        self.captures = 0  # capture attempts: at most one
        self.replays = 0
        self._delta: list[int] = []

    def run(self, body: Callable[[], Any]) -> Any:
        """One round: eager on the CPU and for the first round, else a
        replay (``body`` captured first if this is the second round)."""
        if self.device.type != "cuda" or (self.graph is None
                                          and not self.eager_rounds):
            self.eager_rounds += 1
            return body()
        if self.graph is None:
            self.capture(body)
        return self.replay()

    def capture(self, body: Callable[[], Any]) -> None:
        """Capture ``body`` (on ``torch.cuda.graph``'s side stream) into a
        graph with its own memory pool, or ``pool``.  Raises if capture
        fails, and on any second call."""
        if self.captures:
            raise RuntimeError(
                "this round was captured once already (or its capture "
                "failed); a graph never re-captures and never falls back "
                "to the eager round")
        self.captures += 1
        graph = torch.cuda.CUDAGraph()
        before = kernels.counter_values()
        try:
            with torch.cuda.graph(graph, pool=self.pool):
                outputs = body()
        finally:
            self._delta = [n - b for n, b in
                           zip(kernels.counter_values(), before)]
            kernels.add_launches([-n for n in self._delta])
        self.graph, self.outputs = graph, outputs

    def replay(self) -> Any:
        """Launch the captured round on the current stream."""
        self.graph.replay()
        kernels.add_launches(self._delta)
        self.replays += 1
        return self.outputs


class PrefillGraphs:
    """One instance's bucketed admissions: a ``RoundGraph`` per bucket,
    made at the bucket's first admission, all on one memory pool."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.by_bucket: dict[int, RoundGraph] = {}
        self._pool: Any = None

    def run(self, bucket: int, body: Callable[[], Any]) -> Any:
        """One admission of ``bucket``: eager, captured then replayed, or
        replayed, as ``RoundGraph.run`` decides for that bucket."""
        graph = self.by_bucket.get(bucket)
        if graph is None:
            if self.device.type == "cuda" and self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            graph = self.by_bucket[bucket] = RoundGraph(self.device,
                                                        self._pool)
        return graph.run(body)

    @property
    def captures(self) -> int:
        return sum(g.captures for g in self.by_bucket.values())

    @property
    def replays(self) -> int:
        return sum(g.replays for g in self.by_bucket.values())

    @property
    def eager(self) -> int:
        return sum(g.eager_rounds for g in self.by_bucket.values())
