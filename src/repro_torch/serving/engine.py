"""Live serving engine on PyTorch: the FaST-GShare data plane over the
port's models (counterpart of ``repro.serving.engine``, fused greedy
continuous and paged modes).

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
* **Sync-free decode rounds** — sampling runs on the device, prefill
  tokens stay on the device, and block tables, positions and the active
  mask stay device-resident, re-uploaded only when admission or release
  dirtied their host mirrors.  A pass is ``dispatch_step`` (enqueue, no
  host pull) then ``sync_step``: ONE ``.cpu()`` of one gathered tensor
  that holds every pending prefill token and the round's tokens.

JAX's donated buffers become in-place updates of preallocated pools: the
KV pools are written in place by the decode steps, ``merge_slot`` and
``append_paged``, and the slot-token vector takes admitted tokens by an
in-place device write (the counterpart of ``_SET_TOK``, engine.py:106).

Not ported yet (ROADMAP.md): static batching and ``fused=False``,
sampling and speculation, prefix sharing and copy-on-write, migration
(``export_slot``/``import_slot``), ``retire``/``fail``, SLO deadlines.
"""

from __future__ import annotations

import dataclasses
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
from repro_torch.serving.paging import (NULL_BLOCK, KVPageAllocator,
                                        PageTable, blocks_needed)


IDLE_SLEEP_S = 0.001  # pump's yield when a pass grants nothing after a lull


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
    of ``max_batch`` decode slots, continuous or block-paged KV."""

    def __init__(self, inst_id: str, model: Model, store: ModelStore,
                 weights_key: str, *, device: torch.device,
                 max_batch: int = 4, max_len: int = 64,
                 batching: str = "continuous", block_size: int = 16,
                 n_kv_blocks: Optional[int] = None,
                 prefix_sharing: bool = False):
        if batching not in ("continuous", "paged"):
            raise NotImplementedError(
                f"batching={batching!r} is not ported yet (the port serves "
                f"'continuous' and 'paged'; see ROADMAP.md)")
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
        self.params = store.get(weights_key)  # shared, zero-copy
        self.queue: deque[ServeRequest] = deque()
        # Prompts are right-padded to power-of-two buckets (engine.py:
        # 518-530): O(log max_len) prefill shapes instead of one per length.
        self.bucketed = model.supports_bucketed_prefill()
        self.steps = 0
        self.slots: list[Optional[ServeRequest]] = [None] * max_batch
        self._slot_tok = np.zeros((max_batch,), np.int32)  # host mirror
        self._slot_tok_dev: Optional[torch.Tensor] = None
        self.cache: Optional[dict] = None
        self.refills = 0
        self.last_fill = 0
        self.sync_count = 0  # host synchronisation points (telemetry)
        self.uploads = 0     # paged table/pos uploads (dirty-flag telemetry)
        # Deferred results of the in-flight pass: (req, (1,) device token,
        # slot or None for done-at-prefill) and the decode round's
        # ((B,) device tokens, active-slot snapshot).
        self._pending_prefill: list[tuple[ServeRequest, torch.Tensor,
                                          Optional[int]]] = []
        self._round: Optional[tuple[torch.Tensor, list[int]]] = None
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
            self._block_bytes = model.kv_block_bytes(block_size)
            self.allocator = KVPageAllocator(n_blocks, block_size,
                                             block_bytes=self._block_bytes)
            self.pages = PageTable(self.allocator)
            # Host mirrors; the decode round reads device copies that are
            # re-uploaded only when admission/release dirtied these.
            self._tables = np.full((max_batch, self.blocks_per_seq),
                                   NULL_BLOCK, np.int32)
            self._pos = np.zeros((max_batch,), np.int32)
            self._tables_dev: Optional[torch.Tensor] = None
            self._pos_dev: Optional[torch.Tensor] = None
            self._active_dev: Optional[torch.Tensor] = None
            self._state_dirty = True

    def has_work(self) -> bool:
        return bool(self.queue) or self.n_active() > 0

    def n_active(self) -> int:
        return sum(1 for r in self.slots if r is not None)

    def load(self) -> int:
        """Queue depth + occupied slots (join-shortest-queue metric)."""
        return len(self.queue) + self.n_active()

    def _kv_rows_needed(self, req: ServeRequest) -> int:
        """KV rows a request writes: the prompt plus one row per decode
        round (the final token is emitted, never cached)."""
        return int(req.prompt.shape[0]) + req.max_new_tokens - 1

    # -- device-resident decode state ----------------------------------------

    def _tok_dev(self) -> torch.Tensor:
        if self._slot_tok_dev is None:
            self._slot_tok_dev = torch.as_tensor(self._slot_tok,
                                                 device=self.device)
        return self._slot_tok_dev

    def _upload_paged_state(self) -> None:
        """Push dirtied host mirrors (tables / positions / active mask) to
        the device — once per admit/release burst, not per round."""
        mask = np.array([r is not None for r in self.slots], np.int32)
        self._tables_dev = torch.as_tensor(self._tables, device=self.device)
        self._pos_dev = torch.as_tensor(self._pos, device=self.device)
        self._active_dev = torch.as_tensor(mask, device=self.device)
        self._state_dirty = False
        self.uploads += 1

    def _init_cache(self) -> dict:
        if self.batching == "paged":
            return self.model.init_paged_cache(self.allocator.n_blocks,
                                               self.block_size, self.device)
        return self.model.init_slot_cache(self.max_batch, self.max_len,
                                          self.device)

    # -- admission -------------------------------------------------------------

    def _prefill_one(self, prompt: np.ndarray):
        """Prefill one prompt, right-padded to its bucket when enabled."""
        n = int(prompt.shape[0])
        if self.bucketed and n < self.max_len:
            pl = min(_bucket_len(n), self.max_len)
            padded = np.zeros((pl,), np.int32)
            padded[:n] = prompt
            tokens = torch.as_tensor(padded[None], device=self.device)
            return self.model.prefill(self.params, tokens,
                                      max_len=self.max_len, length=n)
        tokens = torch.as_tensor(np.asarray(prompt, np.int32)[None],
                                 device=self.device)
        return self.model.prefill(self.params, tokens, max_len=self.max_len)

    def _map_paged_request(self, slot: int, req: ServeRequest,
                           entry: dict) -> None:
        """Bind a slot's blocks and scatter its prefill entry into them.
        The write mask keeps the entry's padding blocks (past the blocks
        the request holds) out of the pool — the counterpart of the JAX
        drop sentinel (engine.py:625-628)."""
        self.pages.allocate(slot, self._kv_rows_needed(req))
        row = self.pages.row(slot, self.blocks_per_seq)
        self._tables[slot] = row
        self._pos[slot] = int(req.prompt.shape[0])
        self._state_dirty = True
        write = np.arange(self.blocks_per_seq) < len(self.pages.blocks(slot))
        self.model.append_paged(self.cache, entry, row, write)

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
            logits, entry = self._prefill_one(req.prompt)
            tok_dev = self.model.sample_greedy(logits)  # (1,), on device
            done_at_prefill = len(req.tokens_out) + 1 >= req.max_new_tokens
            self._pending_prefill.append(
                (req, tok_dev, None if done_at_prefill else slot))
            if done_at_prefill:
                finished.append(req)
                continue  # slot stays free for the next queued request
            if self.cache is None:
                self.cache = self._init_cache()
            if had_live:
                self.refills += 1
            if paged:
                self._map_paged_request(slot, req, entry)
            else:
                self.model.merge_slot(self.cache, entry, slot)
            self.slots[slot] = req
            self._tok_dev()[slot] = tok_dev[0]  # in-place device write
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

    # -- one pass: dispatch now, sync once -----------------------------------

    def _dispatch_round(self) -> None:
        """Enqueue one fused decode round on the device — no host pull."""
        active = [s for s, r in enumerate(self.slots) if r is not None]
        if self.batching == "paged":
            if self._state_dirty:
                self._upload_paged_state()
            tok, self.cache, self._pos_dev = \
                self.model.decode_step_paged_tokens(
                    self.params, self._tok_dev(), self.cache,
                    self._tables_dev, self._pos_dev, self._active_dev)
        else:
            tok, self.cache = self.model.decode_step_tokens(
                self.params, self._tok_dev(), self.cache)
        self._slot_tok_dev = tok  # device-resident input of the next round
        self._round = (tok, active)

    def dispatch_step(self) -> bool:
        """Admit and dispatch one token-gated step without any host
        synchronisation; ``sync_step`` finishes the pass."""
        self.steps += 1
        finished = self._admit()
        self.last_fill = self.n_active() + len(finished)
        if self.n_active() > 0:
            self._dispatch_round()
        return True

    def sync_step(self) -> list[ServeRequest]:
        """Complete the dispatched pass with ONE host synchronisation: the
        pending prefill tokens and the round's tokens are gathered into
        one device tensor and pulled by one ``.cpu()``.  Returns the
        requests the pass completed."""
        if not self._pending_prefill and self._round is None:
            return []
        parts = [t.reshape(1) for _, t, _ in self._pending_prefill]
        if self._round is not None:
            parts.append(self._round[0])
        self.sync_count += 1
        host = torch.cat(parts).cpu().numpy()  # the pass's single pull
        finished = []
        n_pre = len(self._pending_prefill)
        for (req, _, slot), tok in zip(self._pending_prefill, host[:n_pre]):
            req.tokens_out.append(int(tok))
            if slot is None:  # whole request served by its prefill
                req.done = True
                finished.append(req)
            else:
                self._slot_tok[slot] = int(tok)
        self._pending_prefill = []
        if self._round is not None:
            _, active = self._round
            self._round = None
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
               n_kv_blocks: Optional[int] = None,
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
                prefix_sharing=prefix_sharing)
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

        ``overlap=True`` dispatches every granted instance's step first
        (kernels queue on the device and the call returns), then syncs
        each instance once, so one instance's kernels run while Python
        dispatches and pulls the others.  ``overlap=False`` dispatches and
        syncs one instance at a time."""
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
                for token in granted:
                    self.instances[token.pod_id].dispatch_step()
            for token in granted:
                inst = self.instances[token.pod_id]
                if not overlap:
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

    def sync_counts(self) -> dict[str, int]:
        """Per-instance host syncs: exactly one per instance per pass."""
        return {k: v.sync_count for k, v in self.instances.items()}

    def telemetry(self) -> dict[str, dict[str, int]]:
        """Hot-path counters per instance: steps, host syncs and (paged)
        device-state uploads — ``uploads << steps`` shows the tables and
        positions stay device-resident between admission events."""
        return {k: {"steps": v.steps, "syncs": v.sync_count,
                    "uploads": v.uploads}
                for k, v in self.instances.items()}
