"""Block-paged KV cache bookkeeping (vLLM-style) for the live data plane.

The dense slot pool (`Model.init_slot_cache`) reserves a full ``max_len``
KV row per decode slot, so a short request strands most of the memory the
MRA/``MemoryModel`` admission charged for it — exactly the fragmentation
FaST-GShare's fine-grained accounting is supposed to prevent.  This module
is the host-side half of the paged replacement:

* ``KVPageAllocator`` — a free-list allocator over ``n_blocks`` physical
  KV blocks of ``block_size`` tokens each, now REFCOUNTED: a block handed
  out by ``alloc`` starts at refcount 1, ``incref`` lets several page
  tables map the same physical block (prefix sharing), and ``free``
  decrements — the block only returns to the free list when its last
  reference drops.  Block 0 is reserved as the **null block**: free
  decode slots and padded block-table entries all point at it, so their
  garbage writes land in a trash page instead of a live sequence's
  memory.  Double frees are rejected, alloc/free/defrag stats are tracked
  (in blocks AND bytes when ``block_bytes`` is given), and the free list
  is kept sorted (lowest id first) so reuse stays dense at the front of
  the pool.  The allocator also owns the **content-hash registry**
  (``register`` / ``lookup``): digest -> resident block, auto-unregistered
  when the block is physically freed.
* ``PageTable`` — per-sequence block lists: which physical blocks hold a
  sequence's KV rows, in logical order.  ``allocate_shared`` maps a new
  sequence onto resident prefix blocks (incref) plus freshly-allocated
  private blocks; ``writable_block`` enforces the copy-on-write rule at
  every write site.  ``row`` pads a sequence's list to the fixed
  ``max_blocks`` width the jitted decode step expects.

Prefix sharing, in one paragraph: ``prompt_digests`` hashes a prompt into
chained per-block digests (block ``i``'s digest commits to ALL tokens up
to and including block ``i``, so equal digests mean equal whole prefixes,
not just equal block contents).  Full prompt blocks are immutable once
written — every later write of any sequence lands at positions beyond
them — so they are shared freely at any refcount.  The *partial* tail
block of a prompt is shareable only on an exact full-prompt match (its
digest commits to the entire prompt) and IS written later (each sharer's
decode rows continue inside it), so sharing it reserves one copy-on-write
spare block per extra reference up front: the worst-case-reservation
admission invariant ("an admitted request can never exhaust the pool
mid-flight") survives sharing, and the first divergent append pops the
spare, copies the block, and re-points the writer — shared blocks are
never written (``PageTable.writable_block`` raises if they would be).

The device-side half lives in ``repro_torch.models``: paged cache layout
(``Model.init_paged_cache``), prefill scatter (``append_paged``), the
contiguous re-gather (``gather_pages``) and the block-table decode step
(``decode_step_paged``).  ``FunctionInstance(batching="paged")`` in
``repro_torch.serving.engine`` ties the two together, prefix sharing
included (on by default for paged instances): admission plans through
``match_prefix`` / ``allocate_shared`` / ``register_prefix``, and the
engine's ``_cow_round`` calls ``writable_block`` for every slot before a
round and copies the page (``Model.copy_block``) when it returns a move.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional

NULL_BLOCK = 0


def blocks_needed(n_tokens: int, block_size: int) -> int:
    """Physical blocks required to hold ``n_tokens`` KV rows."""
    if n_tokens <= 0:
        return 0
    return -(-n_tokens // block_size)


def prompt_digests(prompt, block_size: int
                   ) -> tuple[list[bytes], Optional[bytes]]:
    """Chained content digests of a prompt's KV blocks.

    Returns ``(full, tail)``: one digest per FULL block of
    ``block_size`` tokens, plus a digest over the whole prompt when its
    length is not a block multiple (else None).  Digest ``i`` chains the
    previous digest into the hash, so two prompts produce the same digest
    at block ``i`` iff their first ``(i+1) * block_size`` tokens are
    identical — a match is always a whole-prefix match.  The tail digest
    commits to the entire prompt (chain + remainder), so a tail hit means
    the prompts are byte-for-byte equal.
    """
    toks = [int(t) for t in prompt]
    full: list[bytes] = []
    chain = b""
    n_full = len(toks) // block_size
    for i in range(n_full):
        h = hashlib.blake2b(digest_size=16)
        h.update(chain)
        h.update(b"".join(t.to_bytes(8, "little", signed=True)
                          for t in toks[i * block_size:(i + 1) * block_size]))
        chain = h.digest()
        full.append(chain)
    tail: Optional[bytes] = None
    rem = toks[n_full * block_size:]
    if rem:
        h = hashlib.blake2b(digest_size=16)
        h.update(chain)
        h.update(b"tail")  # a tail digest never collides with a full one
        h.update(b"".join(t.to_bytes(8, "little", signed=True)
                          for t in rem))
        tail = h.digest()
    return full, tail


class BlockExhausted(RuntimeError):
    """The pool has fewer free blocks than the allocation asked for."""


class KVPageAllocator:
    """Refcounted free-list allocator over a fixed pool of physical blocks.

    Block ``NULL_BLOCK`` (id 0) is never handed out: it is the shared
    trash page that free decode slots and block-table padding point at.
    ``block_bytes`` (optional) sizes the bytes-denominated stats; the
    block-count stats are always tracked.
    """

    def __init__(self, n_blocks: int, block_size: int, block_bytes: int = 0):
        if n_blocks < 2:
            raise ValueError("need at least 2 blocks (one is the null block)")
        if block_size <= 0:
            raise ValueError("block_size must be positive")
        self.n_blocks = n_blocks
        self.block_size = block_size
        self.block_bytes = block_bytes
        # Free list: frees are appended (recently-freed blocks are reused
        # first); ``defrag`` re-sorts so allocation returns to preferring
        # the lowest ids and the live region re-packs at the pool front.
        self._free: list[int] = list(range(1, n_blocks))
        self._ref: dict[int, int] = {}  # allocated block -> reference count
        # Content-hash registry: prefix digest -> resident block (and the
        # inverse, for auto-unregistration on physical free).  One digest
        # per block, first registration wins.
        self._digest_to_block: dict[bytes, int] = {}
        self._block_digest: dict[int, bytes] = {}
        self.n_allocs = 0
        self.n_frees = 0       # physical frees (blocks returned to the list)
        self.n_increfs = 0     # sharing events (extra references taken)
        self.n_defrags = 0
        self.high_watermark = 0  # peak blocks_in_use over the pool lifetime

    # -- capacity ----------------------------------------------------------

    @property
    def capacity(self) -> int:
        """Usable blocks (the null block is not allocatable)."""
        return self.n_blocks - 1

    @property
    def blocks_in_use(self) -> int:
        return len(self._ref)

    @property
    def extra_refs(self) -> int:
        """References beyond the first, over all blocks — the raw sharing
        win in blocks (before subtracting reserved COW spares)."""
        return sum(r - 1 for r in self._ref.values())

    @property
    def shared_blocks(self) -> int:
        """Blocks currently mapped by more than one sequence."""
        return sum(1 for r in self._ref.values() if r > 1)

    def free_blocks(self) -> int:
        return len(self._free)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    # -- alloc / incref / free ---------------------------------------------

    def alloc(self, n: int) -> list[int]:
        """Take ``n`` blocks off the front of the free list (refcount 1)."""
        if n < 0:
            raise ValueError("cannot allocate a negative block count")
        if n > len(self._free):
            raise BlockExhausted(
                f"need {n} blocks, only {len(self._free)} free "
                f"(capacity {self.capacity})")
        taken, self._free = self._free[:n], self._free[n:]
        for b in taken:
            self._ref[b] = 1
        self.n_allocs += n
        self.high_watermark = max(self.high_watermark, self.blocks_in_use)
        return taken

    def incref(self, block: int) -> int:
        """Take an extra reference on an allocated block (prefix sharing);
        returns the new refcount."""
        if block not in self._ref:
            raise ValueError(f"block {block} is not allocated")
        self._ref[block] += 1
        self.n_increfs += 1
        return self._ref[block]

    def refcount(self, block: int) -> int:
        """Current references on ``block`` (0 = not allocated)."""
        return self._ref.get(block, 0)

    def free(self, blocks: list[int]) -> None:
        """Drop one reference per listed block; rejects double/foreign
        frees.  A block whose count reaches zero returns to the free list
        (and its content-hash registration is dropped).

        All-or-nothing: validation (including duplicates WITHIN the list)
        happens before any state changes, so a rejected free never loses
        blocks.  A single call never names a block twice — each caller
        (one page-table row list) holds at most one reference per block.
        """
        seen: set[int] = set()
        for b in blocks:
            if b not in self._ref or b in seen:
                raise ValueError(
                    f"block {b} is not allocated (double free or foreign "
                    f"block)")
            seen.add(b)
        for b in blocks:
            self._ref[b] -= 1
            if self._ref[b] == 0:
                del self._ref[b]
                self._free.append(b)
                self.n_frees += 1
                digest = self._block_digest.pop(b, None)
                if digest is not None:
                    del self._digest_to_block[digest]

    # -- content-hash registry (prefix sharing) -----------------------------

    def register(self, digest: bytes, block: int) -> bool:
        """Publish an allocated block's content digest for prefix matching.

        First registration wins (an equal digest means bit-identical
        content, so re-pointing would only churn the registry), and a
        block carries at most one digest.  Returns True iff registered.
        """
        if block not in self._ref:
            raise ValueError(f"cannot register free block {block}")
        if digest in self._digest_to_block or block in self._block_digest:
            return False
        self._digest_to_block[digest] = block
        self._block_digest[block] = digest
        return True

    def lookup(self, digest: bytes) -> Optional[int]:
        """Resident block holding this digest's content, or None."""
        return self._digest_to_block.get(digest)

    @property
    def registered_blocks(self) -> int:
        return len(self._digest_to_block)

    # -- stats -------------------------------------------------------------

    def fragmentation(self) -> float:
        """1 - (largest contiguous free run / free blocks); 0 = compact.

        Measured on the id-sorted view — it describes the free *address
        space*, not the reuse order of the list itself.
        """
        if not self._free:
            return 0.0
        ordered = sorted(self._free)
        best = run = 1
        for prev, cur in zip(ordered, ordered[1:]):
            run = run + 1 if cur == prev + 1 else 1
            best = max(best, run)
        return 1.0 - best / len(ordered)

    def defrag(self) -> float:
        """Re-sort the free list and report the remaining fragmentation.

        Frees append in retire order, so a long-lived pool drifts toward
        allocating scattered ids; defrag restores lowest-id-first reuse so
        the live region re-packs at the pool front.  Physical compaction
        (migrating live blocks) is the engine's job — it owns the device
        arrays.
        """
        self._free.sort()
        self.n_defrags += 1
        return self.fragmentation()

    @property
    def bytes_in_use(self) -> int:
        """Physical bytes held by allocated blocks (a shared block is
        charged ONCE — it occupies one physical block however many
        sequences map it)."""
        return self.blocks_in_use * self.block_bytes

    @property
    def bytes_high_watermark(self) -> int:
        """Physical peak in bytes — ``high_watermark`` (blocks) times
        ``block_bytes``, updated at every allocation rather than sampled,
        and consistent with refcounted sharing (charged once)."""
        return self.high_watermark * self.block_bytes

    def stats(self) -> dict[str, float]:
        return {
            "capacity": self.capacity,
            "in_use": self.blocks_in_use,
            "free": self.free_blocks(),
            "allocs": self.n_allocs,
            "frees": self.n_frees,
            "increfs": self.n_increfs,
            "defrags": self.n_defrags,
            # Block counts and their bytes forms, side by side: the
            # high-watermark/defrag stats used to be block-denominated
            # only, which silently under-reported on configs with large
            # ``block_bytes``.
            "high_watermark": self.high_watermark,
            "bytes_high_watermark": self.bytes_high_watermark,
            "bytes_in_use": self.bytes_in_use,
            "shared_blocks": self.shared_blocks,
            "extra_refs": self.extra_refs,
            "registered": self.registered_blocks,
            "fragmentation": self.fragmentation(),
        }


@dataclasses.dataclass
class PageTable:
    """Per-sequence block lists over one ``KVPageAllocator``.

    Keys are caller-chosen sequence ids — the engine uses its decode-slot
    indices, NOT request ids (req-id counters are per-engine and collide
    when an evict re-routes queued requests across nodes; slots are unique
    within the instance and always released before reuse).  Values are the
    physical block ids holding the sequence's KV rows in logical order.

    ``spares`` maps a *mutable shared* block (a prompt-tail block mapped
    by more than one sequence) to the copy-on-write blocks reserved for
    it: one spare per extra reference, allocated at share time so a COW
    can never hit pool exhaustion mid-flight.  Invariant: while block
    ``b`` is tail-shared, ``len(spares[b]) == refcount(b) - 1``; both
    sides step down together on every COW and on every sharer release.
    """

    allocator: KVPageAllocator
    seqs: dict[int, list[int]] = dataclasses.field(default_factory=dict)
    spares: dict[int, list[int]] = dataclasses.field(default_factory=dict)

    def allocate(self, seq_id: int, n_tokens: int) -> list[int]:
        """Reserve enough blocks for ``n_tokens`` rows of sequence ``seq_id``."""
        if seq_id in self.seqs:
            raise ValueError(f"sequence {seq_id} already has pages")
        blocks = self.allocator.alloc(
            blocks_needed(n_tokens, self.allocator.block_size))
        self.seqs[seq_id] = blocks
        return blocks

    # -- prefix sharing -----------------------------------------------------

    def match_prefix(self, full_digests: list[bytes],
                     tail_digest: Optional[bytes]
                     ) -> tuple[list[int], Optional[int]]:
        """Longest resident prefix for a prompt's digest chain.

        Walks the full-block digests until the first registry miss;
        the tail block joins the match only when EVERY full block hit
        (the tail digest commits to the whole prompt, so a partial chain
        can never legitimately reach it).  Returns
        ``(shared_full_blocks, tail_block_or_None)`` — nothing is
        increfed yet; ``allocate_shared`` takes the references.
        """
        shared: list[int] = []
        for digest in full_digests:
            block = self.allocator.lookup(digest)
            if block is None:
                break
            shared.append(block)
        tail = None
        if tail_digest is not None and len(shared) == len(full_digests):
            tail = self.allocator.lookup(tail_digest)
        return shared, tail

    def allocate_shared(self, seq_id: int, n_tokens: int,
                        shared: list[int], *,
                        tail_shared: bool = False) -> list[int]:
        """Map ``seq_id`` onto resident ``shared`` prefix blocks plus
        freshly-allocated private blocks for the rest of its lifetime.

        ``shared`` lists the matched blocks in logical order; when
        ``tail_shared``, its LAST entry is a mutable prompt-tail block and
        one COW spare is reserved against it up front (the admission
        charge is therefore ``blocks_needed - len(full_shared)``: tail
        sharing trades its block for a spare and saves bytes only until
        the first divergent append — what it really buys is the shared
        prefill write elision and the full-block wins in front of it).
        """
        if seq_id in self.seqs:
            raise ValueError(f"sequence {seq_id} already has pages")
        total = blocks_needed(n_tokens, self.allocator.block_size)
        if len(shared) > total:
            raise ValueError(
                f"matched {len(shared)} shared blocks > {total} needed")
        n_spare = 1 if tail_shared else 0
        fresh = self.allocator.alloc(total - len(shared) + n_spare)
        private, spare = (fresh[:-1], fresh[-1:]) if n_spare else (fresh, [])
        for b in shared:
            self.allocator.incref(b)
        self.seqs[seq_id] = list(shared) + private
        if tail_shared:
            self.spares.setdefault(shared[-1], []).extend(spare)
        return self.seqs[seq_id]

    def register_prefix(self, seq_id: int, full_digests: list[bytes],
                        tail_digest: Optional[bytes] = None) -> int:
        """Publish a sequence's prompt blocks in the content registry so
        later admissions can share them; returns how many registered anew
        (already-resident digests are skipped — first wins)."""
        blocks = self.seqs[seq_id]
        n = 0
        for i, digest in enumerate(full_digests):
            if i >= len(blocks):
                break
            n += self.allocator.register(digest, blocks[i])
        if tail_digest is not None and len(full_digests) < len(blocks):
            n += self.allocator.register(tail_digest,
                                         blocks[len(full_digests)])
        return n

    def writable_block(self, seq_id: int, pos: int
                       ) -> tuple[int, Optional[tuple[int, int]]]:
        """The block that may be WRITTEN at row ``pos`` — the single
        enforcement point of the COW rule.

        Exclusively-owned blocks pass through.  A shared (refcount > 1)
        block is swapped for one of its reserved COW spares: the spare
        replaces it in this sequence's row, the shared block loses one
        reference, and ``(old, new)`` is returned so the engine copies the
        device page before the write lands.  A shared block with no spare
        is an invariant violation (a write was about to corrupt another
        sequence's KV) and raises.
        """
        idx = pos // self.allocator.block_size
        block = self.seqs[seq_id][idx]
        if self.allocator.refcount(block) == 1:
            return block, None
        reserved = self.spares.get(block)
        if not reserved:
            raise RuntimeError(
                f"write at row {pos} would hit shared block {block} "
                f"(refcount {self.allocator.refcount(block)}) with no COW "
                f"spare reserved — shared blocks must never be written")
        new = reserved.pop()
        if not reserved:
            del self.spares[block]
        self.seqs[seq_id][idx] = new
        self.allocator.free([block])  # drop this sequence's reference
        return new, (block, new)

    # -- release ------------------------------------------------------------

    def blocks(self, seq_id: int) -> list[int]:
        return self.seqs[seq_id]

    def release(self, seq_id: int) -> list[int]:
        """Drop a sequence's references; blocks whose last reference this
        was return to the free list.  Releasing a sharer of a mutable
        tail block also returns one of its reserved COW spares (the
        ``spares`` invariant steps down with the refcount)."""
        blocks = self.seqs.pop(seq_id)
        for b in blocks:
            if self.allocator.refcount(b) > 1:
                reserved = self.spares.get(b)
                if reserved:
                    self.allocator.free([reserved.pop()])
                    if not reserved:
                        del self.spares[b]
            self.allocator.free([b])
        return blocks

    def release_all(self) -> int:
        """Drop every sequence (instance teardown); returns blocks
        released.  Any orphaned COW spares are returned too (there are
        none while the invariant holds, but teardown must not leak)."""
        n = 0
        for seq_id in list(self.seqs):
            n += len(self.release(seq_id))
        for block, reserved in list(self.spares.items()):
            self.allocator.free(reserved)
            del self.spares[block]
        return n

    # -- views --------------------------------------------------------------

    def row(self, seq_id: int, max_blocks: int) -> list[int]:
        """Block-table row padded with the null block to ``max_blocks``."""
        blocks = self.seqs[seq_id]
        if len(blocks) > max_blocks:
            raise ValueError(
                f"sequence {seq_id} holds {len(blocks)} blocks > "
                f"max_blocks {max_blocks}")
        return blocks + [NULL_BLOCK] * (max_blocks - len(blocks))

    @property
    def n_seqs(self) -> int:
        return len(self.seqs)

    @property
    def n_spares(self) -> int:
        """COW spare blocks currently reserved (allocated, not in any row)."""
        return sum(len(v) for v in self.spares.values())

    def saved_blocks(self) -> int:
        """Physical blocks sharing is saving RIGHT NOW: references beyond
        the first, minus the COW spares reserved against mutable shared
        blocks (a tail share is memory-neutral until its COW resolves)."""
        return self.allocator.extra_refs - self.n_spares

    def bytes_in_use(self, block_bytes: int) -> int:
        """Physical KV bytes held by live sequences (shared blocks charged
        once)."""
        return self.allocator.blocks_in_use * block_bytes

    def bytes_saved(self, block_bytes: int) -> int:
        """Bytes the unshared plane would additionally hold for the same
        live sequences."""
        return self.saved_blocks() * block_bytes
