"""Live serving engine on PyTorch: the FaST-GShare data plane over the
port's models (counterpart of ``repro.serving.engine``: continuous, paged
and static batching, the fused round and its host-argmax reference,
on-device sampling and speculative decoding).

* **Model sharing (§3.5)** — N instances of a function share ONE param
  tree through the ``ModelStore``; the runtime never copies weights.
* **FaST-Manager (§3.3)** — every instance's dispatch is gated by the
  node's ``TokenScheduler``; wall-clock pass times (which end in the
  pass's host sync, so they include the device time) feed ``Q_used``.
* **Continuous batching** — each ``FunctionInstance`` owns ``max_batch``
  decode slots over a persistent per-slot KV pool; a finished request
  frees its slot at once and queued requests are admitted mid-flight by a
  bucketed prefill whose cache is copied into the freed slot.
* **Block-paged KV (``batching="paged"``)** — slots map to physical
  blocks handed out by a ``KVPageAllocator``; admission budgets free
  blocks for the request's whole lifetime, and a finished request
  releases its blocks at once.
* **Sync-free decode rounds (``fused=True``, the default)** — sampling
  runs on the device, prefill tokens stay on the device, and block
  tables, positions and the active mask stay device-resident, re-uploaded
  only when admission or release dirtied their host mirrors.  A pass is
  ``dispatch_step`` (enqueue, no host pull) then ``sync_step``: ONE
  ``.cpu()`` of one gathered tensor that holds every pending prefill
  token and the round's tokens.  ``fused=False`` is the host-argmax
  reference (engine.py:736-760): the eager step, its logits pulled and
  argmaxed on the host (sampled: the device sampler on the same key
  stream, its tokens pulled), one sync per round and per admitted
  prompt.
* **Static batching (``batching="static"``)** — the reference batch
  that is prefilled together (its prompts share one length) and retires
  together (engine.py:1065-1115); eager, unbucketed, host argmax.

JAX's donated buffers become buffers allocated once per instance and
written in place: the KV pools (by the decode steps, ``merge_slot`` and
``append_paged``), the slot-token vector (admitted tokens by an
``index_copy_`` at the slot, the counterpart of ``_SET_TOK``,
engine.py:106; the round's tokens by the round itself), the positions
and, paged, the block tables and active mask (one upload ``copy_`` into
them).  JAX's jitted round becomes ``graphs.RoundGraph``: on the card
each instance's fused round is one captured CUDA graph, replayed once per
round; on the CPU it runs eagerly.

A fused admission is one body, ``_admission_body``: prefill, greedy
pick, the token's write into the slot-token vector and into the pass's
pending buffer, and the cache's merge into the slot (continuous) or its
scatter into the pages (paged), all driven by one argument buffer on
the device (length, slot, ordinal, append row, padded tokens) that one
``copy_`` fills from a pinned staging row before each admission.  The
dense and moe families' bucketed admissions run it as
``graphs.PrefillGraphs``, one CUDA graph per (instance, bucket) on the
card, the counterpart of
JAX's ``_prefill_len`` -> ``_greedy`` -> ``_merge``/``_append`` ->
``_SET_TOK``; RWKV-6 and the hybrid prefill at the exact length and run
the body eagerly.  Paged pools hold one block past the allocator's, a
write-only sink for the blocks an admission must not write (JAX's drop
sentinel, engine.py:625-633).

An instance reads the int8-KV gate (``REPRO_KV_INT8``) once, when it is
built, and passes it to every prefill, pool and byte count it makes, so
it stays int8 (or bf16) whatever the variable does later; paged
admission then charges the int8 block bytes.  The dense and moe
families, RWKV-6 and the Hymba hybrid serve through the same paths; a
windowed config (mixtral, gemma3), RWKV-6 and the hybrid prefill at the
exact prompt length and serve continuous only (a
``batching="paged"`` deploy raises ``ValueError``, as in JAX: their
caches are recurrent state and rolled sliding-window rows, not rows
addressed by absolute position).

* **Prefix sharing (paged, on by default)** — admission matches a
  prompt's chained block digests against resident pages
  (``_plan_paged_admission``, engine.py:573-589): matched full blocks are
  mapped read-only, an exact-prompt match shares the tail block too
  against one reserved copy-on-write spare, and only the rest is charged
  to the admission's block budget.  A shared prompt is still prefilled
  whole; its staged append row sends the shared blocks to the sink, so
  the admission graphs do not change.  Before each round ``_cow_round``
  gives every slot about to write a shared tail block its private copy
  (``Model.copy_block``, in place in the pools, eagerly between graph
  launches on the replays' stream) and re-points its table row, which
  the round graph reads from the fixed device tables.
* **Lifecycle** — ``export_slot``/``import_slot`` move a decoding slot
  between instances (between passes; an import writes the fixed
  buffers in place, so the target's graphs keep replaying), a paused
  instance dispatches nothing, ``retire`` drains an instance and closes
  it (its graphs, pools and store reference released), ``fail`` drops a
  whole node, and queued requests expire past their deadline except in
  the ``guaranteed`` tier, with the ``batch`` lane queued last; the
  node's health is the ratio of two pass-latency EWMAs.

* **Sampling (``sampling=SamplingConfig``)** — temperature, top-k and
  top-p on the device, with noise from the instance's key
  (``kernels.keys``): a (2,) int64 buffer on the device, advanced in
  place inside the admission body (one split per admitted prefill) and
  the round body (one a round), so the graphs' replays draw what the
  eager bodies would.  ``fused=False`` replays the same key stream
  eagerly and gives the same tokens.
* **Speculative decoding (``speculate=SpecConfig``)** — the round is
  ``serving/speculative.py``'s body: k draft steps on a dense draft slot
  pool (in the instance's KV memory pool), one verify forward of the
  ``k + 1`` window, the on-device fold and the position advance, all in
  place, one captured graph; the admission body prefills the draft too
  and merges it into its pool.  Requests reserve ``k`` KV rows more
  (``_spec_k``), copy-on-write resolves the ``1 + k`` rows a window can
  write, and ``sync_step`` lands a window per slot.  A speculating slot
  does not export.  The JAX refusals hold: no static batching with
  either, no ``fused=False`` with ``speculate``, no int8 KV and no draft
  of another vocabulary.

* **Sharded pods (``group=``, a ``TPGroup`` of ``shards > 1``
  members)** — one instance over several member devices, the
  counterpart of JAX's one-controller ``tp_mesh``
  (engine.py:175-202, 488-513): the instance holds one param tree and
  one KV pool per member (``PodModel``; the weights column-sharded by
  ``serve_pspec`` under ``TPGroup.weights_key``, the pools split by kv
  head when the heads divide the group), and its admission and round
  bodies drive every member and gather their columns exactly, so a
  pod's f32 streams on the CPU are one device's (on the card only where
  cuBLAS's column-slice products are bit-equal to the full product's
  slices, ``distributed.sharding``).  The paged pools share one page
  table and allocator; a COW copy touches every member's pool.  A pod
  whose members share one device captures its round and admissions as
  graphs like any instance; one whose members span devices runs them
  eagerly, a mode declared at deploy.  A pod neither speculates nor
  exports slots.  ``group=None`` is the single-device path, unchanged.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import time
from collections import deque
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.manager import TokenScheduler
from repro_torch.core.model_sharing import ModelStore, pytree_nbytes
from repro_torch.core.resources import Alloc
from repro_torch.core.slo import SLORecorder
from repro_torch.distributed.sharding import (TPGroup, per_member_bytes,
                                              serve_pspec, shard_put)
from repro_torch.kernels import keys
from repro_torch.models import build_model
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model, PodModel, default_kv_blocks
from repro_torch.serving.graphs import PrefillGraphs, RoundGraph
from repro_torch.serving.paging import (NULL_BLOCK, KVPageAllocator,
                                        PageTable, blocks_needed,
                                        prompt_digests)
from repro_torch.serving.speculative import (GREEDY, SamplingConfig,
                                             SpecConfig,
                                             spec_round_continuous,
                                             spec_round_paged)


IDLE_SLEEP_S = 0.001  # pump's default yield in a lull
# The fused admission's argument buffer (int64): length, slot and ordinal
# in the pass, then (paged) the append row, then the padded prompt.
_LEN, _SLOT, _ORD, _ROW = 0, 1, 2, 3


def _bucket_len(n: int) -> int:
    """Smallest power of two >= n (prefill padding bucket)."""
    return 1 << max(n - 1, 0).bit_length()


def _leaves(tree: Any):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _refuse_options(model: Model, kv_int8: bool, batching: str, fused: bool,
                    sampling, speculate, draft_model, draft_key) -> None:
    """The JAX engine's refusals of sampling and speculation
    (engine.py:178-183, 355-372), raised before the instance takes any
    store reference."""
    if sampling is not None and batching == "static":
        raise ValueError("stochastic sampling requires a slot batching mode "
                         "(continuous/paged)")
    if speculate is None:
        return
    if not fused or batching == "static":
        raise ValueError("speculate requires the fused continuous/paged "
                         "round (the draft/verify loop is one round)")
    if not model.supports_speculative(kv_int8):
        raise ValueError(f"{model.cfg.name}: speculative verify needs a "
                         f"full-cache dense/moe target (no int8 KV)")
    if draft_model is None or draft_key is None:
        raise ValueError("speculate needs a draft model and its weights key "
                         "(engine.deploy builds them)")
    if not draft_model.supports_speculative(False):
        raise ValueError(f"{draft_model.cfg.name}: the draft must be a "
                         f"full-cache dense/moe config")
    if draft_model.cfg.vocab_size != model.cfg.vocab_size:
        raise ValueError("draft and target must share vocab_size")


@dataclasses.dataclass
class ServeRequest:
    req_id: int
    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int = 8
    submitted_at: float = 0.0
    tokens_out: list = dataclasses.field(default_factory=list)
    done: bool = False
    finished_at: float = 0.0
    # SLO lifecycle (engine.py:137-145): absolute deadline on the engine
    # clock (None = none), the tier it was admitted under, a typed outcome
    # when it ends without completing (``repro_torch.core.slo``), and how
    # many times it was re-routed after a failure.
    deadline: Optional[float] = None
    tier: str = "best_effort"
    outcome: Optional[str] = None
    attempts: int = 0


class FunctionInstance:
    """One FaSTPod-equivalent: prefill/decode over shared weights, a pool
    of ``max_batch`` decode slots, continuous or block-paged KV, or a
    static batch.  ``fused=True`` (the default; never for static) runs the
    sync-free round, a CUDA graph on the card (``round_graph``);
    ``fused=False`` the host-argmax reference.  Token streams are
    identical either way.  ``prefill_buckets=False`` admits the dense
    and moe families at the exact prompt length, eagerly, with no prefill
    graphs;
    ``prefix_sharing`` applies to paged instances only.  ``sampling``
    samples on the device; ``speculate`` runs the draft-k / verify-1
    round with ``draft_model``, whose weights the store holds under
    ``draft_key``.  ``group`` makes the instance a sharded pod over its
    members (the store then holds a list of member trees)."""

    def __init__(self, inst_id: str, model: Model, store: ModelStore,
                 weights_key: str, *, device: torch.device,
                 max_batch: int = 4, max_len: int = 64,
                 batching: str = "continuous", prefill_buckets: bool = True,
                 block_size: int = 16, n_kv_blocks: Optional[int] = None,
                 fused: bool = True, prefix_sharing: bool = True,
                 sampling: Optional[SamplingConfig] = None,
                 speculate: Optional[SpecConfig] = None,
                 draft_model: Optional[Model] = None,
                 draft_key: Optional[str] = None,
                 group: Optional[TPGroup] = None):
        if batching not in ("continuous", "static", "paged"):
            raise ValueError(f"unknown batching mode {batching!r}")
        kv_int8 = model.kv_int8()
        if group is not None and speculate is not None:
            raise ValueError("speculate cannot ride a sharded pod: the "
                             "draft/verify round is not tensor-parallel")
        _refuse_options(model, kv_int8, batching, fused, sampling, speculate,
                        draft_model, draft_key)
        # The pod's runner (raises for what pods do not serve yet), or
        # the model itself: every call on params and caches goes through
        # ``self.runner``.
        self.group = group
        self.runner = (model if group is None
                       else PodModel(model, group, kv_int8))
        self.inst_id = inst_id
        self.model = model
        self.device = device
        self.max_batch = max_batch
        self.max_len = max_len
        self.batching = batching
        self.fused = fused and batching != "static"
        self.store = store
        self.weights_key = weights_key
        self.params = store.get(weights_key)  # shared, zero-copy
        self.kv_int8 = kv_int8  # pinned for the instance's life
        self.queue: deque[ServeRequest] = deque()
        # Prompts are right-padded to power-of-two buckets (engine.py:
        # 518-530): O(log max_len) prefill shapes instead of one per length.
        self.bucketed = (batching != "static" and prefill_buckets
                         and model.supports_bucketed_prefill())
        self.steps = 0
        self.retired = False  # draining: no new routing, slots finish
        self.paused = False   # migrating: no admission, no round
        # When the instance's first token reached the host (time to first
        # token of a cold instance).
        self.first_token_at: Optional[float] = None
        # Prefix sharing (paged only): resident blocks mapped, and
        # divergent appends resolved by a copy (engine.py:262-266).
        self.prefix_sharing = prefix_sharing and batching == "paged"
        self.shared_block_hits = 0
        self.cow_count = 0
        self.prefills = 0  # prefill launches (telemetry)
        self.rounds = 0    # decode rounds dispatched (telemetry)
        self.slots: list[Optional[ServeRequest]] = [None] * max_batch
        self._slot_tok = np.zeros((max_batch,), np.int32)  # host mirror
        self.cache: Optional[dict] = None
        self._kv_mem = None  # the KV pools' memory pool (the card only)
        self.active: list[ServeRequest] = []  # the static batch
        # Completions of a host-synchronous step (static, fused=False),
        # handed out by sync_step.
        self._host_finished: list[ServeRequest] = []
        self.refills = 0
        self.last_fill = 0
        self.sync_count = 0  # host synchronisation points (telemetry)
        self.uploads = 0     # paged table/pos uploads (dirty-flag telemetry)
        # Deferred results of the in-flight pass: (req, slot or None for
        # done-at-prefill), the i-th admission's token in
        # ``_pending_dev[i]``, and the decode round's active-slot snapshot
        # (its tokens land in ``_slot_tok_dev``).
        self._pending_prefill: list[tuple[ServeRequest, Optional[int]]] = []
        self._round: Optional[list[int]] = None
        self.round_graph: Optional[RoundGraph] = None
        self.prefill_graphs: Optional[PrefillGraphs] = None
        if batching == "paged":
            if not model.supports_paged():
                raise ValueError(f"{model.cfg.name}: batching='paged' needs "
                                 f"a full-cache dense/moe config")
            if block_size <= 0 or max_len % block_size:
                raise ValueError(
                    "block_size must be positive and divide max_len")
            self.block_size = block_size
            self.blocks_per_seq = max_len // block_size
            n_blocks = (n_kv_blocks if n_kv_blocks is not None
                        else default_kv_blocks(max_batch, max_len,
                                               block_size))
            self._block_bytes = model.kv_block_bytes(block_size,
                                                     self.kv_int8)
            self.allocator = KVPageAllocator(n_blocks, block_size,
                                             block_bytes=self._block_bytes)
            self.pages = PageTable(self.allocator)
            # Host mirrors; the fused round reads device copies, allocated
            # once and re-filled in place only when admission or release
            # dirtied these.
            self._tables = np.full((max_batch, self.blocks_per_seq),
                                   NULL_BLOCK, np.int32)
            self._pos = np.zeros((max_batch,), np.int32)
            self._state_dirty = True
        # Sampling and speculation (engine.py:335-397): the key is device
        # state (a fixed buffer, advanced in place by the admission and
        # round bodies, or by ``_sample`` on the host-argmax path); the
        # draft's side pool is made with the KV pools, in their memory pool.
        self.sampling = sampling
        self.speculate = speculate
        self.draft_model = draft_model
        self.draft_key = draft_key
        self.draft_params = None
        self.dcache: Optional[dict] = None
        self.spec_proposed = 0  # draft tokens proposed (telemetry)
        self.spec_accepted = 0  # draft tokens accepted (telemetry)
        self._key_dev: Optional[torch.Tensor] = None
        if sampling is not None or speculate is not None:
            seed = sampling.seed if sampling is not None else speculate.seed
            self._key_dev = keys.new_key(seed, device)
        if speculate is not None:
            self.draft_params = store.get(draft_key)
            build = (spec_round_paged if batching == "paged"
                     else spec_round_continuous)
            self._spec_round = build(model, draft_model, speculate.k,
                                     sampling if sampling is not None
                                     else GREEDY)
        if self.fused:
            self._init_fused_buffers()

    def _init_fused_buffers(self) -> None:
        """The buffers every fused round and admission reads and writes,
        allocated once, at one address for the instance's life: the slot
        tokens (the round's input and output), the pass's pending prefill
        tokens, the admission's argument buffer and, paged, the tables,
        positions and active mask (views of one state buffer).  Each
        device buffer that the host fills has a pinned staging copy, so a
        fill is one asynchronous ``copy_``; a staging row is rewritten only
        after the pass's sync, when its copy has run."""
        mb, dev = self.max_batch, self.device
        pin = torch.device(dev).type == "cuda"
        i32 = dict(dtype=torch.int32, device=dev)
        self._slot_tok_dev = torch.zeros((mb,), **i32)
        self._pending_dev = torch.zeros((mb,), **i32)
        self._tok0 = _ROW + (self.blocks_per_seq
                             if self.batching == "paged" else 0)
        width = self._tok0 + self.max_len
        self._args = torch.zeros((width,), dtype=torch.int64, device=dev)
        # One staging row per admission of a pass (at most max_batch).
        self._args_stage = torch.zeros((mb, width), dtype=torch.int64,
                                       pin_memory=pin)
        if self.speculate is not None:
            self._out_dev = torch.zeros((mb, self.speculate.k + 1), **i32)
            self._n_emit_dev = torch.zeros((mb,), **i32)
        # A pod spanning devices runs its bodies eagerly (a CUDA graph is
        # captured on one device's stream): declared here, never a fallback.
        eager = self.group is not None and not self.group.one_device
        self.round_graph = RoundGraph(dev, eager=eager)
        if self.bucketed:
            self.prefill_graphs = PrefillGraphs(dev, eager=eager)
        if self.batching == "paged":
            n = mb * self.blocks_per_seq
            self._state_dev = torch.zeros((n + 2 * mb,), **i32)
            self._state_stage = torch.zeros((n + 2 * mb,), dtype=torch.int32,
                                            pin_memory=pin)
            self._tables_dev = self._state_dev[:n].view(self._tables.shape)
            self._pos_dev = self._state_dev[n:n + mb]
            self._active_dev = self._state_dev[n + mb:]

    def close(self) -> None:
        """Release the paged blocks and return the store reference
        (engine.py:396-401), then drop the graphs and the KV pools, so
        that ``torch.cuda.empty_cache()`` can return their memory."""
        if self.batching == "paged":
            self.pages.release_all()
        if self.draft_params is not None:
            self.store.put_back(self.draft_key)
        self.store.put_back(self.weights_key)
        self.drop_device_state()

    def drop_device_state(self) -> None:
        """Drop the graphs (each with its memory pool), the KV pools with
        theirs and the weights reference, the store's too (after ``fail``
        the failed node's store lives on only there): a closed or failed
        instance serves nothing more, and what it held is freed even while
        a caller still holds the instance.  (The fused token and argument
        buffers, a few KB, go with the instance.)"""
        self.round_graph = self.prefill_graphs = None
        self.cache = self.params = self._kv_mem = self.store = None
        self.dcache = self.draft_params = None

    def pool_ids(self) -> set[tuple[int, int]]:
        """Ids of the memory pools that hold the instance's device state
        on the card: its KV pools', its round graph's and its prefill
        graphs' shared one (the few KB of fused token buffers lie outside
        them).  ``torch.cuda.memory_snapshot()`` tags each segment with
        its pool's id; empty on the CPU and once the state is dropped."""
        pools = set()
        if self._kv_mem is not None:
            pools.add(tuple(self._kv_mem.id))
        if self.round_graph is not None and self.round_graph.graph is not None:
            pools.add(tuple(self.round_graph.graph.pool()))
        if self.prefill_graphs is not None and \
                self.prefill_graphs.pool is not None:
            pools.add(tuple(self.prefill_graphs.pool))
        return pools

    def hbm_bytes_by_member(self) -> dict[int, int]:
        """Bytes of the instance's weights and KV pools each member holds,
        keyed by the member's node (engine.py:508-513,
        ``hbm_bytes_by_device``; by node, since members may share a
        device); a one-device instance is one member, node 0."""
        if self.group is None:
            return {0: pytree_nbytes(self.params)
                    + pytree_nbytes(self.cache or {})}
        return per_member_bytes(self.group, self.params, self.cache)

    # -- KV accounting ---------------------------------------------------------

    def kv_bytes_in_use(self) -> int:
        """Physical KV bytes held by live requests (paged) or reserved by
        the allocated pool (dense slot modes), plus the draft's side pool
        once it exists."""
        if self.batching == "paged":
            used = self.pages.bytes_in_use(self._block_bytes)
        else:
            used = self.dense_kv_reserved() if self.cache is not None else 0
        return used + self.draft_kv_bytes()

    def draft_kv_bytes(self) -> int:
        """Bytes of the draft's dense side pool (0 without one)."""
        if self.dcache is None:
            return 0
        return self.draft_model.dense_kv_bytes(self.max_batch, self.max_len,
                                               False)

    def dense_kv_reserved(self) -> int:
        """What the dense slot pool reserves for this instance's capacity:
        the baseline the paged pool is measured against."""
        return self.model.dense_kv_bytes(self.max_batch, self.max_len,
                                         self.kv_int8)

    @property
    def kv_bytes_peak(self) -> int:
        """Paged: the allocator's block high-watermark in bytes; dense
        modes: the slot-pool reservation once the pool exists."""
        if self.batching != "paged":
            return self.dense_kv_reserved() if self.cache is not None else 0
        return self.allocator.bytes_high_watermark

    def kv_bytes_saved(self) -> int:
        """Bytes prefix sharing saves now against the unshared paged plane:
        extra references minus the reserved COW spares, in bytes (0 for
        the dense modes)."""
        if self.batching != "paged":
            return 0
        return self.pages.bytes_saved(self._block_bytes)

    def has_work(self) -> bool:
        return bool(self.queue) or self.n_active() > 0

    def n_active(self) -> int:
        if self.batching == "static":
            return len(self.active)
        return sum(1 for r in self.slots if r is not None)

    def load(self) -> int:
        """Queue depth + occupied slots (join-shortest-queue metric)."""
        return len(self.queue) + self.n_active()

    def acceptance_rate(self) -> float:
        """Draft tokens accepted over proposed (0 before a speculative
        round)."""
        if not self.spec_proposed:
            return 0.0
        return self.spec_accepted / self.spec_proposed

    def _spec_k(self, max_new_tokens: int) -> int:
        """KV rows a speculating request may write past ``prompt + max_new
        - 1``: the last window starts at most at row ``prompt + max_new -
        2`` and writes k rows beyond it; none for a request done at
        prefill (engine.py:557-563)."""
        if self.speculate is None or max_new_tokens <= 1:
            return 0
        return self.speculate.k

    def _kv_rows_needed(self, req: ServeRequest) -> int:
        """KV rows a request writes: the prompt plus one row per decode
        round (the final token is emitted, never cached), plus the
        speculation margin."""
        return (int(req.prompt.shape[0]) + req.max_new_tokens - 1
                + self._spec_k(req.max_new_tokens))

    def _mark_first_token(self) -> None:
        """Record when the instance's first token reached the host (every
        path that lands a token calls this; a fused token lands at
        ``sync_step``)."""
        if self.first_token_at is None:
            self.first_token_at = time.perf_counter()

    # -- device-resident decode state ----------------------------------------

    def _upload_paged_state(self) -> None:
        """Copy dirtied host mirrors (tables / positions / active mask)
        into their device buffers, in place, by one asynchronous copy —
        once per admit/release burst, not per round."""
        mask = np.array([r is not None for r in self.slots], np.int32)
        self._state_stage.numpy()[:] = np.concatenate(
            [self._tables.ravel(), self._pos, mask])
        self._state_dev.copy_(self._state_stage, non_blocking=True)
        self._state_dirty = False
        self.uploads += 1

    def _init_cache(self) -> dict:
        """The slot pool, or the paged pools with the sink block at index
        ``allocator.n_blocks``, which the allocator never hands out.  On
        the card they live in a memory pool of the instance's own: from
        the default pool they could be carved out of a cached segment
        whose other blocks hold live tensors (the weights among them), and
        ``close`` could then not give their memory back to the device."""
        if self.device.type != "cuda":
            return self._make_cache()
        self._kv_mem = torch.cuda.MemPool()
        with torch.cuda.use_mem_pool(self._kv_mem, self.device.index):
            return self._make_cache()

    def _make_cache(self):
        if self.speculate is not None:  # the draft's pool, in the same pool
            self.dcache = self.draft_model.init_slot_cache(
                self.max_batch, self.max_len, self.device, kv_int8=False)
        if self.batching == "paged":
            return self.runner.init_paged_cache(
                self.allocator.n_blocks + 1, self.block_size, self.device,
                kv_int8=self.kv_int8)
        return self.runner.init_slot_cache(self.max_batch, self.max_len,
                                           self.device, kv_int8=self.kv_int8)

    # -- admission -------------------------------------------------------------

    def _prefill_one(self, prompt: np.ndarray):
        """Prefill one prompt, right-padded to its bucket when enabled."""
        n = int(prompt.shape[0])
        self.prefills += 1
        kw = {"max_len": self.max_len, "kv_int8": self.kv_int8}
        if self.bucketed and n < self.max_len:
            pl = min(_bucket_len(n), self.max_len)
            padded = np.zeros((pl,), np.int32)
            padded[:n] = prompt
            tokens = torch.as_tensor(padded[None], device=self.device)
            return self.runner.prefill(self.params, tokens, length=n, **kw)
        tokens = torch.as_tensor(np.asarray(prompt, np.int32)[None],
                                 device=self.device)
        return self.runner.prefill(self.params, tokens, **kw)

    def _plan_paged_admission(self, req: ServeRequest) -> tuple[int, tuple]:
        """Blocks a paged admission must allocate for ``req`` and its
        sharing plan ``(full_digests, tail_digest, shared_full,
        tail_block)`` (engine.py:573-589): a shared full block costs
        nothing, a shared tail block trades its block for a reserved COW
        spare, so the charge is ``blocks_needed - len(shared_full)``."""
        total = blocks_needed(self._kv_rows_needed(req), self.block_size)
        if not self.prefix_sharing:
            return total, ([], None, [], None)
        full, tail_digest = prompt_digests(req.prompt, self.block_size)
        shared, tail_block = self.pages.match_prefix(full, tail_digest)
        return total - len(shared), (full, tail_digest, shared, tail_block)

    def _assert_writes_exclusive(self, append_row: np.ndarray) -> None:
        """The paged write contract (engine.py:591-603): every block an
        append row writes is owned by this sequence alone; the null block
        and the sink are skipped.  Raises on a shared block."""
        for b in np.asarray(append_row).tolist():
            if b != NULL_BLOCK and b < self.allocator.n_blocks and \
                    self.allocator.refcount(b) != 1:
                raise AssertionError(
                    f"{self.inst_id}: an append would write block {b} with "
                    f"refcount {self.allocator.refcount(b)} (shared blocks "
                    f"are read-only)")

    def _map_paged_request(self, slot: int, req: ServeRequest, plan: tuple
                           ) -> np.ndarray:
        """Bind a slot's pages (the shared prefix, then private blocks),
        publish its prompt digests, and return its append row: the slot's
        block row with the shared blocks and the padding past the blocks
        it holds sent to the sink (JAX's drop sentinel, engine.py:605-633).
        Its writer checks it against the write contract."""
        full_digests, tail_digest, shared, tail_block = plan
        shared_all = shared + ([tail_block] if tail_block is not None
                               else [])
        rows = self._kv_rows_needed(req)
        if shared_all:
            self.pages.allocate_shared(slot, rows, shared_all,
                                       tail_shared=tail_block is not None)
            self.shared_block_hits += len(shared_all)
        else:
            self.pages.allocate(slot, rows)
        if self.prefix_sharing:
            self.pages.register_prefix(slot, full_digests, tail_digest)
        return self._bind_row(slot, len(shared_all),
                              int(req.prompt.shape[0]))

    def _bind_row(self, slot: int, n_shared: int, pos: int) -> np.ndarray:
        """Point the slot's table mirror at its blocks and its position at
        ``pos``; return its append row (see ``_map_paged_request``)."""
        row = np.asarray(self.pages.row(slot, self.blocks_per_seq), np.int64)
        self._tables[slot] = row
        self._pos[slot] = pos
        self._state_dirty = True
        idx = np.arange(self.blocks_per_seq)
        write = (idx >= n_shared) & (idx < len(self.pages.blocks(slot)))
        return np.where(write, row, self.allocator.n_blocks)

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        """The admission's and the host-argmax round's sampler on the
        device: greedy, or sampled with a key split off the instance's key
        (advanced in place; engine.py:664-673, 736-741)."""
        if self.sampling is None:
            return self.model.sample_greedy(logits)
        return self.model.sample_tokens(logits, keys.advance(self._key_dev),
                                        self.sampling)

    def _admission_body(self, width: int, bucketed: bool) -> torch.Tensor:
        """One fused admission, read from ``_args`` (what a prefill graph
        captures and replays): prefill the ``width`` prompt tokens (at the
        true length from the buffer when bucketed), sample the token
        (``_sample``), write it into the pending buffer at the admission's
        ordinal and into the slot-token vector at its slot, merge the
        cache into the slot or scatter it through the append row and,
        speculating, prefill the draft and merge it into the draft's pool
        (``_dprefill_one``/``_admit_draft``, engine.py:532-555).  A request
        done at prefill leaves its slot free: its merges land in a free
        slot (which the next admission there overwrites whole) and its
        append row is all sink.  Returns the logits row (what checks
        compare; the engine reads only the buffers)."""
        a = self._args
        tokens = a[self._tok0:self._tok0 + width].view(1, width)
        length = a[_LEN] if bucketed else None
        logits, entry = self.runner.prefill(
            self.params, tokens, max_len=self.max_len, length=length,
            kv_int8=self.kv_int8)
        tok = self._sample(logits)
        slot = a[_SLOT:_SLOT + 1]
        self._pending_dev.index_copy_(0, a[_ORD:_ORD + 1], tok)
        self._slot_tok_dev.index_copy_(0, slot, tok)
        if self.batching == "paged":
            self.runner.append_paged(self.cache, entry, a[_ROW:self._tok0])
        else:
            self.runner.merge_slot(self.cache, entry, slot)
        if self.speculate is not None:
            _, dentry = self.draft_model.prefill(
                self.draft_params, tokens, max_len=self.max_len,
                length=length, kv_int8=False)
            self.draft_model.merge_slot(self.dcache, dentry, slot)
        return logits

    def _admit_fused(self, slot: int, req: ServeRequest, done: bool,
                     plan: Optional[tuple] = None) -> None:
        """Stage the admission's arguments, copy them into ``_args`` and
        run the body: a prefill graph of the prompt's bucket (dense), or
        eagerly at the exact length (rwkv6, the hybrid).  Paged, the
        staged append row (all sink for a request done at prefill) is
        checked against the write contract before the copy; ``plan`` is
        the paged admission's sharing plan (``_plan_paged_admission``)."""
        k = len(self._pending_prefill)
        if k >= self.max_batch:
            raise RuntimeError(f"{self.inst_id}: more than {self.max_batch} "
                               f"admissions before a sync_step")
        n = int(req.prompt.shape[0])
        width = min(_bucket_len(n), self.max_len) if self.bucketed else n
        stage = self._args_stage.numpy()[k]
        stage[_LEN], stage[_SLOT], stage[_ORD] = n, slot, k
        if self.batching == "paged":
            stage[_ROW:self._tok0] = (
                self.allocator.n_blocks if done
                else self._map_paged_request(slot, req, plan))
            self._assert_writes_exclusive(stage[_ROW:self._tok0])
        stage[self._tok0 + n:self._tok0 + width] = 0
        stage[self._tok0:self._tok0 + n] = req.prompt
        self._args.copy_(self._args_stage[k], non_blocking=True)
        self.prefills += 1
        body = functools.partial(self._admission_body, width, self.bucketed)
        if self.bucketed:
            self.prefill_graphs.run(width, body)
        else:
            body()

    def _admit(self) -> list[ServeRequest]:
        """Prefill queued requests one at a time into free slots.  Paged
        mode budgets free blocks for the head request's whole lifetime
        (FIFO: the head waits for retiring blocks).  Prefill tokens stay
        on the device until the pass's single sync; the returned list
        holds the requests finished by their prefill (marked done at
        sync)."""
        finished = []
        paged = self.batching == "paged"
        had_live = self.n_active() > 0
        for slot in range(self.max_batch):
            if self.slots[slot] is not None or not self.queue:
                continue
            head = self.queue[0]
            plan = ([], None, [], None)
            if paged and head.max_new_tokens > 1:
                need, plan = self._plan_paged_admission(head)
                if not self.allocator.can_alloc(need):
                    break  # the head waits for retiring blocks
            req = self.queue.popleft()
            if self.fused:
                if self.cache is None:
                    self.cache = self._init_cache()
                done_at_prefill = (len(req.tokens_out) + 1
                                   >= req.max_new_tokens)
                self._admit_fused(slot, req, done_at_prefill, plan)
                self._pending_prefill.append(
                    (req, None if done_at_prefill else slot))
                if done_at_prefill:
                    finished.append(req)  # marked done by sync_step
                    continue  # slot stays free for the next queued request
            else:
                logits, entry = self._prefill_one(req.prompt)
                self.sync_count += 1
                tok = int(self._sample(logits).cpu()[0])
                req.tokens_out.append(tok)
                self._mark_first_token()
                if len(req.tokens_out) >= req.max_new_tokens:
                    req.done = True
                    finished.append(req)
                    continue
                if self.cache is None:
                    self.cache = self._init_cache()
                if paged:
                    self._append(entry,
                                 self._map_paged_request(slot, req, plan))
                else:
                    self.runner.merge_slot(self.cache, entry, slot)
                self._slot_tok[slot] = tok
            if had_live:
                self.refills += 1
            self.slots[slot] = req
        return finished

    def _append(self, entry: dict, append_row: np.ndarray) -> None:
        """Scatter a batch-1 entry into the pages through an append row,
        checked against the write contract (eagerly: the host-argmax
        admission and ``import_slot``)."""
        self._assert_writes_exclusive(append_row)
        self.runner.append_paged(self.cache, entry, torch.as_tensor(
            append_row, dtype=torch.int64, device=self.device))

    def _advance_slot(self, slot: int, tok: int) -> Optional[ServeRequest]:
        """Land one round's token on an occupied slot; free the slot (and
        its blocks) when the request finishes.  Returns it iff finished."""
        req = self.slots[slot]
        req.tokens_out.append(tok)
        self._mark_first_token()
        self._slot_tok[slot] = tok
        if self.batching == "paged":
            self._pos[slot] += 1  # mirrors the in-step pos + active
        if len(req.tokens_out) >= req.max_new_tokens:
            req.done = True
            self.slots[slot] = None
            if self.batching == "paged":
                self._release_paged(slot)
            return req
        return None

    def _release_paged(self, slot: int) -> None:
        """Free a finished slot's blocks and park it on the null block."""
        self.pages.release(slot)
        self._tables[slot] = NULL_BLOCK
        self._pos[slot] = 0
        self._state_dirty = True

    def _cow_round(self) -> None:
        """Copy-on-write before a round's writes land (engine.py:770-805).
        A slot whose next rows — one, or the ``1 + k`` of a speculative
        window — lie in a shared prompt-tail block takes that block's
        reserved spare: the page is copied into it in place
        (``Model.copy_block``, eagerly, on the stream the replays use,
        after the admissions that wrote the page) and the slot's table
        mirror re-pointed, so the round's upload refills the fixed device
        tables before the replay.  Afterwards no block a round writes is
        shared, and a speculative rollback is a position trim."""
        span = 1 + (self.speculate.k if self.speculate is not None else 0)
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            pos = int(self._pos[slot])
            for idx in range(pos // self.block_size,
                             (pos + span - 1) // self.block_size + 1):
                block, moved = self.pages.writable_block(
                    slot, idx * self.block_size)
                if moved is not None:
                    old, new = moved
                    self.runner.copy_block(self.cache, old, new)
                    self._tables[slot][idx] = new
                    self._state_dirty = True
                    self.cow_count += 1
                if self.allocator.refcount(block) != 1:
                    raise AssertionError(f"{self.inst_id}: slot {slot} "
                                         f"would write shared block {block}")

    def _host_tokens(self, logits: torch.Tensor) -> np.ndarray:
        """Reference sampler (one sync): the logits pulled, argmax and clip
        on the host; sampled, the device sampler on the instance's key
        stream, its tokens pulled (``_sample_host``, engine.py:736-741)."""
        self.sync_count += 1
        if self.sampling is not None:
            return self._sample(logits).cpu().numpy()
        tok = np.argmax(logits.cpu().numpy(), axis=-1)
        return np.minimum(tok, self.model.cfg.vocab_size - 1).astype(np.int32)

    def _decode_round_host(self) -> list[ServeRequest]:
        """Host-argmax reference round (``fused=False``, engine.py:736-760):
        the eager step on freshly uploaded tokens (and tables and
        positions), its logits argmaxed on the host."""
        self.rounds += 1
        tok = torch.as_tensor(self._slot_tok, device=self.device)
        if self.batching == "paged":
            logits, self.cache = self.runner.decode_step_paged(
                self.params, tok, self.cache,
                torch.as_tensor(self._tables, device=self.device),
                torch.as_tensor(self._pos, device=self.device))
        else:
            logits, self.cache = self.runner.decode_step(self.params, tok,
                                                         self.cache)
        next_tok = self._host_tokens(logits)
        finished = []
        for slot, req in enumerate(self.slots):
            if req is None:
                continue  # a free slot decoded garbage; ignore it
            done = self._advance_slot(slot, int(next_tok[slot]))
            if done is not None:
                finished.append(done)
        return finished

    # -- static reference path (engine.py:1065-1115) ---------------------------

    def _admit_static(self) -> list[ServeRequest]:
        """Prefill up to ``max_batch`` queued requests as one batch (their
        prompts share one length)."""
        batch = []
        while self.queue and len(batch) < self.max_batch:
            batch.append(self.queue.popleft())
        if not batch:
            return []
        prompts = torch.as_tensor(np.stack([r.prompt for r in batch]),
                                  dtype=torch.int32, device=self.device)
        self.prefills += 1
        logits, self.cache = self.runner.prefill(
            self.params, prompts, max_len=self.max_len, kv_int8=self.kv_int8)
        finished = []
        for r, t in zip(batch, self._host_tokens(logits)):
            r.tokens_out.append(int(t))
            self._mark_first_token()
            if len(r.tokens_out) >= r.max_new_tokens:
                r.done = True
                finished.append(r)
        self.active = batch
        self._retire_static_if_done()
        return finished

    def _decode_round_static(self) -> list[ServeRequest]:
        """One round of the whole batch; finished members keep their row
        but stop taking tokens."""
        self.rounds += 1
        toks = torch.as_tensor([r.tokens_out[-1] for r in self.active],
                               dtype=torch.int32, device=self.device)
        logits, self.cache = self.runner.decode_step(self.params, toks,
                                                     self.cache)
        finished = []
        for r, t in zip(self.active, self._host_tokens(logits)):
            if r.done:
                continue
            r.tokens_out.append(int(t))
            if len(r.tokens_out) >= r.max_new_tokens:
                r.done = True
                finished.append(r)
        self._retire_static_if_done()
        return finished

    def _retire_static_if_done(self) -> None:
        """The batch retires together once every member is done; no slot
        is refilled mid-flight."""
        if self.active and all(r.done for r in self.active):
            self.active = []
            self.cache = None

    # -- one pass: dispatch now, sync once -----------------------------------

    def _round_body(self) -> torch.Tensor:
        """The fused round (what ``round_graph`` runs, captures and
        replays): it writes every buffer that crosses rounds in place, the
        KV pools by the decode step, the key (sampling), then, as its last
        ops, the positions (the slot pool's ``pos``, or the paged ones
        advanced by the active mask) and the slot tokens, its input and its
        output.  Speculating, it is the draft-k / verify-1 body of
        ``serving/speculative.py``, which also writes the draft's pool,
        ``_out_dev`` and ``_n_emit_dev``."""
        tok = self._slot_tok_dev
        paged = self.batching == "paged"
        if self.speculate is not None:
            state = ((self._tables_dev, self._pos_dev, self._active_dev)
                     if paged else ())
            self._spec_round(self.params, self.draft_params, tok, self.cache,
                             self.dcache, *state, self._key_dev,
                             self._out_dev, self._n_emit_dev)
            return tok
        if paged:
            new_tok, _, pos = self.runner.decode_step_paged_tokens(
                self.params, tok, self.cache, self._tables_dev,
                self._pos_dev, self._active_dev, self._key_dev,
                self.sampling)[:3]
            self._pos_dev.copy_(pos)
        else:
            new_tok, advanced = self.runner.decode_step_tokens(
                self.params, tok, self.cache, self._key_dev,
                self.sampling)[:2]
            if self.group is None:
                self.cache["pos"].copy_(advanced["pos"])
            else:
                for pool, adv in zip(self.cache, advanced):
                    pool["pos"].copy_(adv["pos"])
        return tok.copy_(new_tok)

    def _dispatch_round(self) -> None:
        """Enqueue one fused decode round on the device — no host pull: a
        graph replay on the card, the eager round on the CPU."""
        active = [s for s, r in enumerate(self.slots) if r is not None]
        self.rounds += 1
        if self.batching == "paged" and self._state_dirty:
            self._upload_paged_state()
        self.round_graph.run(self._round_body)
        self._round = active

    def dispatch_step(self) -> bool:
        """Admit and dispatch one token-gated step.  The fused modes do it
        without any host synchronisation; the host-synchronous reference
        modes (static, ``fused=False``) run the step in full and stash its
        completions.  Either way ``sync_step`` finishes the pass.  A
        paused (migrating) instance dispatches nothing and returns
        False."""
        if self.paused:
            return False
        self.steps += 1
        if self.batching == "static":
            if self.active:
                self.last_fill = sum(1 for r in self.active if not r.done)
                self._host_finished = self._decode_round_static()
            else:
                finished = self._admit_static()
                self.last_fill = len(self.active) or len(finished)
                self._host_finished = finished
            return True
        finished = self._admit()
        self.last_fill = self.n_active() + len(finished)
        if self.prefix_sharing and self.n_active() > 0:
            self._cow_round()  # before either round's writes
        if self.fused:
            if self.n_active() > 0:
                self._dispatch_round()
            return True
        if self.n_active() > 0:
            finished += self._decode_round_host()
        self._host_finished = finished
        return True

    def sync_step(self) -> list[ServeRequest]:
        """Complete the dispatched pass.  Fused: ONE host synchronisation,
        the pending prefill tokens and the round's tokens gathered into
        one device tensor and pulled by one ``.cpu()``.  Returns the
        requests the pass completed."""
        if not self.fused:
            finished, self._host_finished = self._host_finished, []
            return finished
        if not self._pending_prefill and self._round is None:
            return []
        n_pre = len(self._pending_prefill)
        parts = [self._pending_dev[:n_pre]]
        if self._round is not None:
            parts += ([self._out_dev.view(-1), self._n_emit_dev]
                      if self.speculate is not None else [self._slot_tok_dev])
        self.sync_count += 1
        host = torch.cat(parts).cpu().numpy()  # the pass's single pull
        finished = []
        for (req, slot), tok in zip(self._pending_prefill, host[:n_pre]):
            req.tokens_out.append(int(tok))
            self._mark_first_token()
            if slot is None:  # whole request served by its prefill
                req.done = True
                finished.append(req)
            else:
                self._slot_tok[slot] = int(tok)
        self._pending_prefill = []
        if self._round is None:
            return finished
        active, self._round = self._round, None
        if self.speculate is None:
            toks = host[n_pre:]
            for slot in active:
                done = self._advance_slot(slot, int(toks[slot]))
                if done is not None:
                    finished.append(done)
            return finished
        # A speculative round lands a window a slot (engine.py:937-962): a
        # slot that reaches max_new mid-window is freed at once and its
        # surplus dropped (the device position overshot; the release resets
        # the mirrors, and the next admission there overwrites the slot).
        k = self.speculate.k
        out = host[n_pre:n_pre + self.max_batch * (k + 1)].reshape(
            self.max_batch, k + 1)
        n_emit = host[n_pre + self.max_batch * (k + 1):]
        for slot in active:
            n = int(n_emit[slot])
            self.spec_proposed += k
            self.spec_accepted += n - 1
            for t in out[slot, :n]:
                done = self._advance_slot(slot, int(t))
                if done is not None:
                    finished.append(done)
                    break
        return finished

    def run_step(self) -> list[ServeRequest]:
        """``dispatch_step`` + ``sync_step`` back to back."""
        if not self.dispatch_step():
            return []
        return self.sync_step()

    # -- migration (pause -> gather -> merge, engine.py:988-1061) -------------

    def _between_passes(self, what: str) -> None:
        if self._pending_prefill or self._round is not None:
            raise RuntimeError(f"{self.inst_id}: {what} runs between passes "
                               f"(after sync_step), not mid-pass")

    def export_slot(self, slot: int) -> tuple[ServeRequest, dict, int]:
        """One occupied slot's decode state, ``(request, batch-1 cache
        entry, last token)``; paged slots are gathered into the dense
        layout, so any instance can import them.  Between passes only:
        the host mirrors are the pass's sync's."""
        if self.group is not None:
            raise ValueError(f"{self.inst_id}: a sharded pod's slots do not "
                             f"export (each member holds its share of the "
                             f"KV)")
        req = self.slots[slot]
        if req is None:
            raise ValueError(f"slot {slot} of {self.inst_id} is empty")
        if self.speculate is not None:
            raise ValueError(f"{self.inst_id}: speculating slots cannot be "
                             f"exported (the draft's side pool does not "
                             f"travel)")
        self._between_passes("export_slot")
        if self.batching == "paged":
            entry = self.model.gather_pages(self.cache, self._tables[slot],
                                            int(self._pos[slot]))
        else:
            entry = self.model.gather_slot(self.cache, slot)
        return req, entry, int(self._slot_tok[slot])

    def import_slot(self, slot: int, req: ServeRequest, entry: dict,
                    tok: int) -> None:
        """Merge an exported slot into ``slot``, the inverse of
        ``export_slot``: the request's later rounds give the tokens they
        would have given at the source.  Paged, the import takes the
        admission's worst-case blocks and re-shares FULL prompt blocks
        only; the tail block stays private, as it already holds decode
        rows.  Everything is written in place into the buffers the
        instance's graphs read (pools, tables via the next upload, slot
        token), so its graphs keep replaying."""
        if self.batching == "static":
            raise ValueError("static batches cannot absorb migrated slots")
        if self.slots[slot] is not None:
            raise ValueError(f"slot {slot} of {self.inst_id} is occupied")
        if self.group is not None:
            raise ValueError(f"{self.inst_id}: a sharded pod imports no "
                             f"slots")
        self._between_passes("import_slot")
        if self.cache is None:
            self.cache = self._init_cache()
        if self.batching == "paged":
            full = (prompt_digests(req.prompt, self.block_size)[0]
                    if self.prefix_sharing else [])
            shared, _ = self.pages.match_prefix(full, None)
            rows = self._kv_rows_needed(req)
            if shared:
                self.pages.allocate_shared(slot, rows, shared)
                self.shared_block_hits += len(shared)
            else:
                self.pages.allocate(slot, rows)
            if self.prefix_sharing:
                self.pages.register_prefix(slot, full, None)
            self._append(entry, self._bind_row(slot, len(shared),
                                               int(entry["pos"])))
        else:
            self.model.merge_slot(self.cache, entry, slot)
        self.slots[slot] = req
        self._slot_tok[slot] = tok
        if self.fused:
            self._slot_tok_dev[slot] = tok  # in place: the graphs read it


def context_refusal(cfg: ModelConfig) -> Optional[str]:
    """Why the engine does not serve ``cfg``, or None: a vision or
    encoder-decoder model prefills with a context, and a request carries
    none — nor does the reference's engine, which prefills with the prompt
    alone (engine.py:215-217) and fails on the family's assert at the
    first admission."""
    if cfg.family not in ("encdec", "vlm"):
        return None
    return (f"{cfg.name}: a {cfg.family} model prefills with a context "
            f"(B, {cfg.n_context_tokens}, {cfg.d_model}), and a ServeRequest "
            f"carries none, as the reference engine's requests carry none "
            f"(repro/serving/engine.py:215-217); drive it through the "
            f"Model API: prefill(ctx=), merge_slot, decode_step_tokens")


class ServingEngine:
    """One node: token scheduler + N weight-shared instances on one
    device (``None`` = the card; the CPU only when asked for)."""

    def __init__(self, window: float = 0.2, device=None,
                 idle_sleep_s: float = IDLE_SLEEP_S):
        self.device = resolve_device(device)
        self.scheduler = TokenScheduler(window=window)
        self.store = ModelStore()
        self.instances: dict[str, FunctionInstance] = {}
        self.recorders: dict[str, SLORecorder] = {}
        self.alive = True
        self._req_ids = itertools.count()
        self._inst_seq = itertools.count()
        self._t0 = time.perf_counter()
        # What pump sleeps when a pass grants nothing after a pass that
        # did no work (0: never sleeps).
        self.idle_sleep_s = idle_sleep_s
        # An injected stall per pass, inside the timed region (the chaos
        # harness's straggler lever; 0 does nothing).
        self.pump_delay_s = 0.0
        # Gray-failure quarantine: routing and placement stop, occupants
        # drain through pump.  One-way, set by a frontend.
        self.quarantined = False
        # Pass-latency EWMAs of the health score (engine.py:1151-1155).
        self._lat_fast = 0.0
        self._lat_slow = 0.0
        self._expired: dict[str, int] = {}  # queued requests expired
        # Called with the instance id once a retired instance has drained
        # and closed.
        self.on_instance_closed: Optional[Any] = None
        # fn -> its draft Model, built once (engine.py:1180-1186).
        self._draft_models: dict[str, Model] = {}

    def now(self) -> float:
        return time.perf_counter() - self._t0

    def deploy(self, fn: str, model: Model, params: Any, alloc: Alloc, *,
               n_instances: int = 1, max_batch: int = 4, max_len: int = 64,
               batching: str = "continuous", prefill_buckets: bool = True,
               block_size: int = 16, n_kv_blocks: Optional[int] = None,
               fused: bool = True, prefix_sharing: bool = True,
               sampling: Optional[SamplingConfig] = None,
               speculate: Optional[SpecConfig] = None,
               draft_params: Any = None,
               group: Optional[TPGroup] = None) -> list[str]:
        """Deploy ``n_instances`` of ``fn`` sharing one stored copy of
        ``params`` (which must already lie on the engine's device).  When
        the node's store already holds ``fn``, its copy is used and
        ``params`` is ignored (it may be None), as in JAX.  ``speculate``
        builds the draft model of ``speculate.draft_cfg`` (once a function
        and node) and stores ``draft_params`` under ``"{fn}#draft"`` on
        the first deploy (engine.py:1166-1200).

        ``group`` (a ``TPGroup`` whose primary is this engine's device)
        deploys sharded pods: their weights live under
        ``group.weights_key(fn)``, ``"{fn}@tp{shards}"`` on one device
        (engine.py:1179-1187), so ``shards=1`` replicas keep sharing the
        intact tree, and pods on other member devices never share trees; ``params`` is a full tree,
        placed by ``shard_put`` with ``serve_pspec``, or the list of member
        trees a sharded upload made."""
        if not self.alive:
            raise RuntimeError("cannot deploy to a failed node")
        refusal = context_refusal(model.cfg)
        if refusal:
            raise ValueError(refusal)
        weights_key = fn
        if group is not None:
            if group.primary != self.device:
                raise ValueError(f"a pod's primary member lies on "
                                 f"{group.primary}, the engine on "
                                 f"{self.device}")
            weights_key = group.weights_key(fn)
            if isinstance(params, dict):
                params = shard_put(params, model.param_names(), group,
                                   resolver=serve_pspec)
        if fn not in self.recorders:
            self.recorders[fn] = SLORecorder(fn=fn)
        self._store_weights(weights_key, params, group)
        draft_model = draft_key = None
        if speculate is not None:
            draft_model = self._draft_models.get(fn)
            if draft_model is None:
                draft_model = self._draft_models[fn] = build_model(
                    speculate.draft_cfg)
            draft_key = f"{fn}#draft"
            if not self.store.contains(draft_key) and draft_params is None:
                raise ValueError(f"{fn}: speculate set but no draft weights "
                                 f"staged (pass draft_params on the first "
                                 f"deploy)")
            self._store_weights(draft_key, draft_params)
        ids = []
        for _ in range(n_instances):
            inst_id = f"{fn}/{next(self._inst_seq)}"
            self.instances[inst_id] = FunctionInstance(
                inst_id, model, self.store, weights_key, device=self.device,
                max_batch=max_batch, max_len=max_len, batching=batching,
                prefill_buckets=prefill_buckets, block_size=block_size,
                n_kv_blocks=n_kv_blocks, fused=fused,
                prefix_sharing=prefix_sharing, sampling=sampling,
                speculate=speculate, draft_model=draft_model,
                draft_key=draft_key, group=group)
            self.scheduler.register(inst_id, alloc)
            ids.append(inst_id)
        return ids

    def _store_weights(self, key: str, params: Any,
                       group: Optional[TPGroup] = None) -> None:
        """Store ``params`` under ``key`` unless the node holds it already;
        they must lie on the engine's device, or a pod's member trees each
        on its member's."""
        if self.store.contains(key):
            return
        trees, devices = (([params], [self.device]) if group is None
                          else (params, group.devices))
        for tree, dev in zip(trees, devices):
            for leaf in _leaves(tree):
                if leaf.device != dev:
                    raise ValueError(f"{key}: params are on {leaf.device}, "
                                     f"their member on {dev}")
        self.store.store(key, params)

    # -- scale-down and node failure (engine.py:1227-1282) --------------------

    def retire(self, inst_id: str,
               strip_queue: bool = True) -> list[ServeRequest]:
        """Stop routing to an instance and return its queued requests for
        the caller to re-route (``strip_queue=False`` keeps them: the last
        replica drains its own queue).  Occupied slots decode on under the
        scheduler; once the instance has no work it closes and
        ``on_instance_closed`` fires."""
        inst = self.instances[inst_id]
        inst.retired = True
        strays: list[ServeRequest] = []
        if strip_queue:
            strays = list(inst.queue)
            inst.queue.clear()
        if not inst.has_work():
            self._close(inst_id)
        return strays

    def _close(self, inst_id: str) -> None:
        inst = self.instances.pop(inst_id)
        self.scheduler.deregister(inst_id)
        inst.close()
        if self.on_instance_closed is not None:
            self.on_instance_closed(inst_id)

    def fail(self) -> list[tuple[str, ServeRequest]]:
        """A node crash: every instance dies at once, with no drain and no
        ``on_instance_closed``.  Returns the unfinished requests as (fn,
        request), slot occupants with their tokens reset (their KV died
        with the node; greedy decode reproduces the stream from the
        prompt) and queued ones.  The instances' graphs and pools are
        dropped, and the store is replaced by an empty one."""
        self.alive = False
        strays: list[tuple[str, ServeRequest]] = []
        for inst_id, inst in self.instances.items():
            fn = inst_id.split("/")[0]
            occupants = (inst.active if inst.batching == "static"
                         else inst.slots)
            for req in occupants:
                if req is None or req.done:
                    continue
                req.tokens_out = []
                strays.append((fn, req))
            strays.extend((fn, req) for req in inst.queue)
            inst.drop_device_state()
        self.instances.clear()
        self.scheduler.pods.clear()  # a crash: tokens die mid-hold
        self.store = ModelStore()
        return strays

    # -- routing --------------------------------------------------------------

    def submit(self, fn: str, prompt: np.ndarray, max_new_tokens: int = 8,
               deadline: Optional[float] = None, tier: str = "best_effort",
               attempts: int = 0) -> ServeRequest:
        req = ServeRequest(req_id=next(self._req_ids), prompt=prompt,
                           max_new_tokens=max_new_tokens,
                           submitted_at=self.now(), deadline=deadline,
                           tier=tier, attempts=attempts)
        # Join-shortest-queue over the function's live instances (retired
        # ones drain, paused ones migrate: no new work).
        candidates = [v for k, v in self.instances.items()
                      if k.startswith(fn + "/") and not v.retired
                      and not v.paused]
        if not candidates:
            raise KeyError(f"function {fn} has no instances")
        inst = min(candidates, key=lambda i: i.load())
        # Reject requests that can never fit the instance's cache up front
        # (a dense write past max_len would clamp onto the last row).
        rows = inst._kv_rows_needed(req)
        if rows > inst.max_len:
            raise ValueError(
                f"request needs {rows} KV rows (prompt "
                f"{int(prompt.shape[0])} + {max_new_tokens} new tokens + "
                f"{inst._spec_k(max_new_tokens)} speculation margin) > "
                f"max_len {inst.max_len} of {inst.inst_id}")
        if (inst.batching == "paged" and max_new_tokens > 1
                and blocks_needed(rows, inst.block_size)
                > inst.allocator.capacity):
            raise ValueError(
                f"request needs {blocks_needed(rows, inst.block_size)} KV "
                f"blocks > pool capacity {inst.allocator.capacity} of "
                f"{inst.inst_id}")
        self.enqueue(inst, req)
        return req

    @staticmethod
    def enqueue(inst: FunctionInstance, req: ServeRequest) -> None:
        """Queue ``req`` ahead of the instance's parked ``batch``-tier
        requests unless it is one; uniform tiers queue in FIFO order."""
        if req.tier != "batch":
            idx = next((i for i, r in enumerate(inst.queue)
                        if r.tier == "batch"), None)
            if idx is not None:
                inst.queue.insert(idx, req)
                return
        inst.queue.append(req)

    def has_work(self) -> bool:
        return any(i.has_work() for i in self.instances.values())

    def pump(self, budget_s: float = 1.0, *, overlap: bool = True) -> int:
        """Run token-gated passes until idle or ``budget_s`` is spent (a
        failed node runs none).

        ``overlap=True`` dispatches every granted fused instance's step
        first (kernels queue on the device and the call returns), then
        syncs each instance once, so one instance's kernels run while
        Python dispatches and pulls the others; a host-synchronous
        instance dispatches in the sync pass, just before its sync.
        ``overlap=False`` dispatches and syncs one instance at a time.
        Queued requests past their deadline expire before each pass; a
        paused instance asks for no token; a retired instance closes
        after the sync that drains it."""
        if not self.alive:
            return 0
        completed = 0
        deadline = time.perf_counter() + budget_s
        worked_last_pass = False
        while time.perf_counter() < deadline:
            self._expire_queued()
            any_work = False
            for inst_id, inst in self.instances.items():
                if inst.has_work() and not inst.paused:
                    any_work = True
                    self.scheduler.request_token(inst_id, self.now())
            if not any_work:
                break
            granted = self.scheduler.dispatch(self.now())
            if not granted:
                # Quota-blocked: spin while saturated, yield in a lull.
                if not worked_last_pass and self.idle_sleep_s > 0:
                    time.sleep(self.idle_sleep_s)
                worked_last_pass = False
                continue
            worked_last_pass = True
            t_prev = time.perf_counter()
            if self.pump_delay_s > 0:
                time.sleep(self.pump_delay_s)  # the injected straggler
            if overlap:
                # Only fused instances dispatch early: a host-synchronous
                # step (static, fused=False) runs in full in dispatch_step,
                # so it runs in the sync pass, timed against its own Q_used
                # (engine.py:1382-1404).
                for token in granted:
                    inst = self.instances[token.pod_id]
                    if inst.fused:
                        inst.dispatch_step()
            for token in granted:
                inst = self.instances[token.pod_id]
                if not overlap or not inst.fused:
                    inst.dispatch_step()
                finished = inst.sync_step()
                t_now = time.perf_counter()
                elapsed, t_prev = t_now - t_prev, t_now
                self._observe_pass(elapsed)
                occ = token.occ * min(inst.last_fill / inst.max_batch, 1.0)
                self.scheduler.complete(token.pod_id, elapsed, self.now(),
                                        occ=occ)
                fn = token.pod_id.split("/")[0]
                for r in finished:
                    r.finished_at = self.now()
                    met = (None if r.deadline is None
                           else r.finished_at <= r.deadline)
                    self.recorders[fn].record(r.finished_at - r.submitted_at,
                                              r.finished_at,
                                              deadline_met=met)
                    completed += 1
                if inst.retired and not inst.has_work():
                    self._close(token.pod_id)  # drained, and synced
        return completed

    def _expire_queued(self) -> None:
        """Drop queued requests past their deadline, outside the
        ``guaranteed`` tier, with the typed outcome ``"expired"``, before
        they take a slot (engine.py:1427-1453)."""
        now = self.now()
        for inst_id, inst in self.instances.items():
            kept, dropped = [], []
            for r in inst.queue:
                (dropped if r.deadline is not None and r.tier != "guaranteed"
                 and now > r.deadline else kept).append(r)
            if not dropped:
                continue
            inst.queue.clear()
            inst.queue.extend(kept)
            fn = inst_id.split("/")[0]
            for r in dropped:
                r.done = True
                r.outcome = "expired"
                r.finished_at = now
                self._expired[inst_id] = self._expired.get(inst_id, 0) + 1
                if fn in self.recorders:
                    self.recorders[fn].record_expired()

    def _observe_pass(self, elapsed: float) -> None:
        """Feed one pass's latency into the fast and slow EWMAs."""
        if self._lat_slow == 0.0:
            self._lat_fast = self._lat_slow = elapsed
            return
        self._lat_fast = 0.6 * self._lat_fast + 0.4 * elapsed
        self._lat_slow = 0.98 * self._lat_slow + 0.02 * elapsed

    def health(self) -> float:
        """Health in (0, 1]: slow over fast pass-latency EWMA, 1.0 while
        passes keep their long-run latency, about 1/N when they run N
        times slower; 0 for a failed node."""
        if not self.alive:
            return 0.0
        if self._lat_fast <= self._lat_slow or self._lat_fast == 0.0:
            return 1.0
        return self._lat_slow / self._lat_fast

    def memory_bytes(self) -> int:
        """Weight bytes resident in the node's store (a shared copy is
        counted once, however many instances use it)."""
        return self.store.used_bytes()

    def kv_bytes_in_use(self) -> int:
        """Physical KV bytes live requests hold across this node."""
        return sum(i.kv_bytes_in_use() for i in self.instances.values())

    def dense_kv_reserved(self) -> int:
        """What dense slot pools would reserve for the same capacity."""
        return sum(i.dense_kv_reserved() for i in self.instances.values())

    def kv_bytes_saved(self) -> int:
        """Bytes prefix sharing saves across this node's instances."""
        return sum(i.kv_bytes_saved() for i in self.instances.values())

    def sync_counts(self) -> dict[str, int]:
        """Per-instance host syncs: the fused round's budget is one per
        instance per pass; the host-argmax reference spends one per round
        plus one per admitted prompt."""
        return {k: v.sync_count for k, v in self.instances.items()}

    def telemetry(self) -> dict[str, dict[str, int]]:
        """Hot-path counters per instance: steps, host syncs, prefills,
        decode rounds, (paged) device-state uploads — ``uploads << steps``
        shows the tables and positions stay device-resident between
        admission events — prefix-sharing hits, COW copies, draft tokens
        proposed and accepted (speculation), queued
        requests expired past their deadline, the round graph's captures
        and replays, and the prefill graphs' (summed over buckets; 0 where
        admission is eager)."""
        def count(graphs, what):
            return 0 if graphs is None else getattr(graphs, what)
        return {k: {"steps": v.steps, "syncs": v.sync_count,
                    "prefills": v.prefills, "rounds": v.rounds,
                    "uploads": v.uploads, "shared_hits": v.shared_block_hits,
                    "cow": v.cow_count, "spec_proposed": v.spec_proposed,
                    "spec_accepted": v.spec_accepted,
                    "expired": self._expired.get(k, 0),
                    "captures": count(v.round_graph, "captures"),
                    "replays": count(v.round_graph, "replays"),
                    "prefill_captures": count(v.prefill_graphs, "captures"),
                    "prefill_replays": count(v.prefill_graphs, "replays")}
                for k, v in self.instances.items()}
