"""Live serving engine on PyTorch: the FaST-GShare data plane over the
port's models (counterpart of ``repro.serving.engine``: greedy
continuous, paged and static batching, the fused round and its
host-argmax reference).

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
  argmaxed on the host, one sync per round and per admitted prompt.
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
dense family's bucketed admissions run it as ``graphs.PrefillGraphs``,
one CUDA graph per (instance, bucket) on the card, the counterpart of
JAX's ``_prefill_len`` -> ``_greedy`` -> ``_merge``/``_append`` ->
``_SET_TOK``; RWKV-6 and the hybrid prefill at the exact length and run
the body eagerly.  Paged pools hold one block past the allocator's, a
write-only sink for the blocks an admission must not write (JAX's drop
sentinel, engine.py:625-633).

An instance reads the int8-KV gate (``REPRO_KV_INT8``) once, when it is
built, and passes it to every prefill, pool and byte count it makes, so
it stays int8 (or bf16) whatever the variable does later; paged
admission then charges the int8 block bytes.  The dense family, RWKV-6
and the Hymba hybrid serve through the same paths; RWKV-6 and the hybrid
prefill at the exact prompt length and serve continuous only (a
``batching="paged"`` deploy raises ``ValueError``, as in JAX: their
caches are recurrent state and rolled sliding-window rows, not rows
addressed by absolute position).

Not ported yet (ROADMAP.md): sampling and speculation, prefix sharing
and copy-on-write, migration (``export_slot``/``import_slot``),
``retire``/``fail``, SLO deadlines.
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
from repro_torch.core.model_sharing import ModelStore
from repro_torch.core.resources import Alloc
from repro_torch.core.slo import SLORecorder
from repro_torch.models.model import Model, default_kv_blocks
from repro_torch.serving.graphs import PrefillGraphs, RoundGraph
from repro_torch.serving.paging import (NULL_BLOCK, KVPageAllocator,
                                        PageTable, blocks_needed)


IDLE_SLEEP_S = 0.001  # pump's yield when a pass grants nothing after a lull
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


@dataclasses.dataclass
class ServeRequest:
    req_id: int
    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int = 8
    submitted_at: float = 0.0
    tokens_out: list = dataclasses.field(default_factory=list)
    done: bool = False
    finished_at: float = 0.0


class FunctionInstance:
    """One FaSTPod-equivalent: prefill/decode over shared weights, a pool
    of ``max_batch`` decode slots, continuous or block-paged KV, or a
    static batch.  ``fused=True`` (the default; never for static) runs the
    sync-free round, a CUDA graph on the card (``round_graph``);
    ``fused=False`` the host-argmax reference.  Token streams are
    identical either way."""

    def __init__(self, inst_id: str, model: Model, store: ModelStore,
                 weights_key: str, *, device: torch.device,
                 max_batch: int = 4, max_len: int = 64,
                 batching: str = "continuous", block_size: int = 16,
                 n_kv_blocks: Optional[int] = None, fused: bool = True,
                 prefix_sharing: bool = False):
        if batching not in ("continuous", "static", "paged"):
            raise ValueError(f"unknown batching mode {batching!r}")
        if prefix_sharing:
            raise NotImplementedError(
                "prefix sharing is not ported yet (ROADMAP.md, Queue 1 "
                "item 4)")
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
        self.kv_int8 = model.kv_int8()  # pinned for the instance's life
        self.queue: deque[ServeRequest] = deque()
        # Prompts are right-padded to power-of-two buckets (engine.py:
        # 518-530): O(log max_len) prefill shapes instead of one per length.
        self.bucketed = (batching != "static"
                         and model.supports_bucketed_prefill())
        self.steps = 0
        self.prefills = 0  # prefill launches (telemetry)
        self.rounds = 0    # decode rounds dispatched (telemetry)
        self.slots: list[Optional[ServeRequest]] = [None] * max_batch
        self._slot_tok = np.zeros((max_batch,), np.int32)  # host mirror
        self.cache: Optional[dict] = None
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
                                 f"a full-cache dense config")
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
        self.round_graph = RoundGraph(dev)
        if self.bucketed:
            self.prefill_graphs = PrefillGraphs(dev)
        if self.batching == "paged":
            n = mb * self.blocks_per_seq
            self._state_dev = torch.zeros((n + 2 * mb,), **i32)
            self._state_stage = torch.zeros((n + 2 * mb,), dtype=torch.int32,
                                            pin_memory=pin)
            self._tables_dev = self._state_dev[:n].view(self._tables.shape)
            self._pos_dev = self._state_dev[n:n + mb]
            self._active_dev = self._state_dev[n + mb:]

    def close(self) -> None:
        """Return the store reference and release the paged blocks
        (engine.py:396-401)."""
        if self.batching == "paged":
            self.pages.release_all()
        self.store.put_back(self.weights_key)

    # -- KV accounting ---------------------------------------------------------

    def kv_bytes_in_use(self) -> int:
        """Physical KV bytes held by live requests (paged) or reserved by
        the allocated pool (dense slot modes)."""
        if self.batching == "paged":
            return self.pages.bytes_in_use(self._block_bytes)
        return self.dense_kv_reserved() if self.cache is not None else 0

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
        """Bytes prefix sharing saves now (0 until it is ported)."""
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

    def _kv_rows_needed(self, req: ServeRequest) -> int:
        """KV rows a request writes: the prompt plus one row per decode
        round (the final token is emitted, never cached)."""
        return int(req.prompt.shape[0]) + req.max_new_tokens - 1

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
        ``allocator.n_blocks``, which the allocator never hands out."""
        if self.batching == "paged":
            return self.model.init_paged_cache(
                self.allocator.n_blocks + 1, self.block_size, self.device,
                kv_int8=self.kv_int8)
        return self.model.init_slot_cache(self.max_batch, self.max_len,
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
            return self.model.prefill(self.params, tokens, length=n, **kw)
        tokens = torch.as_tensor(np.asarray(prompt, np.int32)[None],
                                 device=self.device)
        return self.model.prefill(self.params, tokens, **kw)

    def _map_paged_request(self, slot: int, req: ServeRequest
                           ) -> tuple[list[int], np.ndarray]:
        """Bind a slot's blocks; returns its block row and the mask of the
        logical blocks its prefill entry may write (the padding blocks past
        the blocks the request holds stay out of the pool — the
        counterpart of the JAX drop sentinel, engine.py:625-628)."""
        self.pages.allocate(slot, self._kv_rows_needed(req))
        row = self.pages.row(slot, self.blocks_per_seq)
        self._tables[slot] = row
        self._pos[slot] = int(req.prompt.shape[0])
        self._state_dirty = True
        write = np.arange(self.blocks_per_seq) < len(self.pages.blocks(slot))
        return row, write

    def _admission_body(self, width: int, bucketed: bool) -> torch.Tensor:
        """One fused admission, read from ``_args`` (what a prefill graph
        captures and replays): prefill the ``width`` prompt tokens (at the
        true length from the buffer when bucketed), pick the greedy token,
        write it into the pending buffer at the admission's ordinal and
        into the slot-token vector at its slot, and merge the cache into
        the slot or scatter it through the append row.  A request done at
        prefill leaves its slot free: its merge lands in a free slot (which
        the next admission there overwrites whole) and its append row is
        all sink.  Returns the logits row (what checks compare; the engine
        reads only the buffers)."""
        a = self._args
        tokens = a[self._tok0:self._tok0 + width].view(1, width)
        logits, entry = self.model.prefill(
            self.params, tokens, max_len=self.max_len,
            length=a[_LEN] if bucketed else None, kv_int8=self.kv_int8)
        tok = self.model.sample_greedy(logits)
        slot = a[_SLOT:_SLOT + 1]
        self._pending_dev.index_copy_(0, a[_ORD:_ORD + 1], tok)
        self._slot_tok_dev.index_copy_(0, slot, tok)
        if self.batching == "paged":
            self.model.append_paged(self.cache, entry, a[_ROW:self._tok0])
        else:
            self.model.merge_slot(self.cache, entry, slot)
        return logits

    def _admit_fused(self, slot: int, req: ServeRequest, done: bool) -> None:
        """Stage the admission's arguments, copy them into ``_args`` and
        run the body: a prefill graph of the prompt's bucket (dense), or
        eagerly at the exact length (rwkv6, the hybrid)."""
        k = len(self._pending_prefill)
        if k >= self.max_batch:
            raise RuntimeError(f"{self.inst_id}: more than {self.max_batch} "
                               f"admissions before a sync_step")
        n = int(req.prompt.shape[0])
        width = min(_bucket_len(n), self.max_len) if self.bucketed else n
        stage = self._args_stage.numpy()[k]
        stage[_LEN], stage[_SLOT], stage[_ORD] = n, slot, k
        if self.batching == "paged":
            sink = self.allocator.n_blocks
            if done:
                stage[_ROW:self._tok0] = sink
            else:
                row, write = self._map_paged_request(slot, req)
                stage[_ROW:self._tok0] = np.where(write, row, sink)
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
            if paged and head.max_new_tokens > 1:
                need = blocks_needed(self._kv_rows_needed(head),
                                     self.block_size)
                if not self.allocator.can_alloc(need):
                    break
            req = self.queue.popleft()
            if self.fused:
                if self.cache is None:
                    self.cache = self._init_cache()
                done_at_prefill = (len(req.tokens_out) + 1
                                   >= req.max_new_tokens)
                self._admit_fused(slot, req, done_at_prefill)
                self._pending_prefill.append(
                    (req, None if done_at_prefill else slot))
                if done_at_prefill:
                    finished.append(req)  # marked done by sync_step
                    continue  # slot stays free for the next queued request
            else:
                logits, entry = self._prefill_one(req.prompt)
                self.sync_count += 1
                tok = int(self.model.sample_greedy(logits).cpu()[0])
                req.tokens_out.append(tok)
                if len(req.tokens_out) >= req.max_new_tokens:
                    req.done = True
                    finished.append(req)
                    continue
                if self.cache is None:
                    self.cache = self._init_cache()
                if paged:
                    row, write = self._map_paged_request(slot, req)
                    self.model.append_paged(self.cache, entry, row, write)
                else:
                    self.model.merge_slot(self.cache, entry, slot)
                self._slot_tok[slot] = tok
            if had_live:
                self.refills += 1
            self.slots[slot] = req
        return finished

    def _advance_slot(self, slot: int, tok: int) -> Optional[ServeRequest]:
        """Land one round's token on an occupied slot; free the slot (and
        its blocks) when the request finishes.  Returns it iff finished."""
        req = self.slots[slot]
        req.tokens_out.append(tok)
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

    def _host_argmax(self, logits: torch.Tensor) -> np.ndarray:
        """Reference sampler: the logits pulled, argmax and clip on the
        host (one sync)."""
        self.sync_count += 1
        tok = np.argmax(logits.cpu().numpy(), axis=-1)
        return np.minimum(tok, self.model.cfg.vocab_size - 1).astype(np.int32)

    def _decode_round_host(self) -> list[ServeRequest]:
        """Host-argmax reference round (``fused=False``, engine.py:736-760):
        the eager step on freshly uploaded tokens (and tables and
        positions), its logits argmaxed on the host."""
        self.rounds += 1
        tok = torch.as_tensor(self._slot_tok, device=self.device)
        if self.batching == "paged":
            logits, self.cache = self.model.decode_step_paged(
                self.params, tok, self.cache,
                torch.as_tensor(self._tables, device=self.device),
                torch.as_tensor(self._pos, device=self.device))
        else:
            logits, self.cache = self.model.decode_step(self.params, tok,
                                                        self.cache)
        next_tok = self._host_argmax(logits)
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
        logits, self.cache = self.model.prefill(
            self.params, prompts, max_len=self.max_len, kv_int8=self.kv_int8)
        finished = []
        for r, t in zip(batch, self._host_argmax(logits)):
            r.tokens_out.append(int(t))
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
        logits, self.cache = self.model.decode_step(self.params, toks,
                                                    self.cache)
        finished = []
        for r, t in zip(self.active, self._host_argmax(logits)):
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
        KV pools by the decode step, then, as its last ops, the positions
        (the slot pool's ``pos``, or the paged ones advanced by the active
        mask) and the slot tokens, its input and its output."""
        tok = self._slot_tok_dev
        if self.batching == "paged":
            new_tok, _, pos = self.model.decode_step_paged_tokens(
                self.params, tok, self.cache, self._tables_dev,
                self._pos_dev, self._active_dev)
            self._pos_dev.copy_(pos)
        else:
            new_tok, advanced = self.model.decode_step_tokens(
                self.params, tok, self.cache)
            self.cache["pos"].copy_(advanced["pos"])
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
        completions.  Either way ``sync_step`` finishes the pass."""
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
            parts.append(self._slot_tok_dev)
        self.sync_count += 1
        host = torch.cat(parts).cpu().numpy()  # the pass's single pull
        finished = []
        for (req, slot), tok in zip(self._pending_prefill, host[:n_pre]):
            req.tokens_out.append(int(tok))
            if slot is None:  # whole request served by its prefill
                req.done = True
                finished.append(req)
            else:
                self._slot_tok[slot] = int(tok)
        self._pending_prefill = []
        if self._round is not None:
            active, self._round = self._round, None
            toks = host[n_pre:]
            for slot in active:
                done = self._advance_slot(slot, int(toks[slot]))
                if done is not None:
                    finished.append(done)
        return finished

    def run_step(self) -> list[ServeRequest]:
        """``dispatch_step`` + ``sync_step`` back to back."""
        self.dispatch_step()
        return self.sync_step()


class ServingEngine:
    """One node: token scheduler + N weight-shared instances on one
    device (``None`` = the card; the CPU only when asked for)."""

    def __init__(self, window: float = 0.2, device=None):
        self.device = resolve_device(device)
        self.scheduler = TokenScheduler(window=window)
        self.store = ModelStore()
        self.instances: dict[str, FunctionInstance] = {}
        self.recorders: dict[str, SLORecorder] = {}
        self._req_ids = itertools.count()
        self._inst_seq = itertools.count()
        self._t0 = time.perf_counter()

    def now(self) -> float:
        return time.perf_counter() - self._t0

    def deploy(self, fn: str, model: Model, params: Any, alloc: Alloc, *,
               n_instances: int = 1, max_batch: int = 4, max_len: int = 64,
               batching: str = "continuous", block_size: int = 16,
               n_kv_blocks: Optional[int] = None, fused: bool = True,
               prefix_sharing: bool = False) -> list[str]:
        """Deploy ``n_instances`` of ``fn`` sharing one stored copy of
        ``params`` (which must already lie on the engine's device)."""
        for leaf in _leaves(params):
            if leaf.device != self.device:
                raise ValueError(f"{fn}: params are on {leaf.device}, the "
                                 f"engine on {self.device}")
        if fn not in self.recorders:
            self.recorders[fn] = SLORecorder(fn=fn)
        if not self.store.contains(fn):
            self.store.store(fn, params)
        ids = []
        for _ in range(n_instances):
            inst_id = f"{fn}/{next(self._inst_seq)}"
            self.instances[inst_id] = FunctionInstance(
                inst_id, model, self.store, fn, device=self.device,
                max_batch=max_batch, max_len=max_len, batching=batching,
                block_size=block_size, n_kv_blocks=n_kv_blocks,
                fused=fused, prefix_sharing=prefix_sharing)
            self.scheduler.register(inst_id, alloc)
            ids.append(inst_id)
        return ids

    def submit(self, fn: str, prompt: np.ndarray,
               max_new_tokens: int = 8) -> ServeRequest:
        req = ServeRequest(req_id=next(self._req_ids), prompt=prompt,
                           max_new_tokens=max_new_tokens,
                           submitted_at=self.now())
        candidates = [v for k, v in self.instances.items()
                      if k.startswith(fn + "/")]
        if not candidates:
            raise KeyError(f"function {fn} has no instances")
        inst = min(candidates, key=lambda i: i.load())
        # Reject requests that can never fit the instance's cache up front
        # (a dense write past max_len would clamp onto the last row).
        rows = inst._kv_rows_needed(req)
        if rows > inst.max_len:
            raise ValueError(
                f"request needs {rows} KV rows > max_len {inst.max_len} of "
                f"{inst.inst_id}")
        if (inst.batching == "paged" and max_new_tokens > 1
                and blocks_needed(rows, inst.block_size)
                > inst.allocator.capacity):
            raise ValueError(
                f"request needs {blocks_needed(rows, inst.block_size)} KV "
                f"blocks > pool capacity {inst.allocator.capacity} of "
                f"{inst.inst_id}")
        inst.queue.append(req)
        return req

    def has_work(self) -> bool:
        return any(i.has_work() for i in self.instances.values())

    def pump(self, budget_s: float = 1.0, *, overlap: bool = True) -> int:
        """Run token-gated passes until idle or ``budget_s`` is spent.

        ``overlap=True`` dispatches every granted fused instance's step
        first (kernels queue on the device and the call returns), then
        syncs each instance once, so one instance's kernels run while
        Python dispatches and pulls the others; a host-synchronous
        instance dispatches in the sync pass, just before its sync.
        ``overlap=False`` dispatches and syncs one instance at a time."""
        completed = 0
        deadline = time.perf_counter() + budget_s
        worked_last_pass = False
        while time.perf_counter() < deadline:
            any_work = False
            for inst_id, inst in self.instances.items():
                if inst.has_work():
                    any_work = True
                    self.scheduler.request_token(inst_id, self.now())
            if not any_work:
                break
            granted = self.scheduler.dispatch(self.now())
            if not granted:
                # Quota-blocked: spin while saturated, yield in a lull.
                if not worked_last_pass:
                    time.sleep(IDLE_SLEEP_S)
                worked_last_pass = False
                continue
            worked_last_pass = True
            t_prev = time.perf_counter()
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
                occ = token.occ * min(inst.last_fill / inst.max_batch, 1.0)
                self.scheduler.complete(token.pod_id, elapsed, self.now(),
                                        occ=occ)
                fn = token.pod_id.split("/")[0]
                for r in finished:
                    r.finished_at = self.now()
                    self.recorders[fn].record(r.finished_at - r.submitted_at,
                                              r.finished_at)
                    completed += 1
        return completed

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
        admission events — the round graph's captures and replays, and the
        prefill graphs' (summed over buckets; 0 where admission is eager)."""
        def count(graphs, what):
            return 0 if graphs is None else getattr(graphs, what)
        return {k: {"steps": v.steps, "syncs": v.sync_count,
                    "prefills": v.prefills, "rounds": v.rounds,
                    "uploads": v.uploads,
                    "captures": count(v.round_graph, "captures"),
                    "replays": count(v.round_graph, "replays"),
                    "prefill_captures": count(v.prefill_graphs, "captures"),
                    "prefill_replays": count(v.prefill_graphs, "replays")}
                for k, v in self.instances.items()}
