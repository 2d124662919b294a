"""KV block allocator: refcounted block pool with prefix sharing + COW
(counterpart of `ray_tpu/serve/kv_cache.py`).

The host half of the paged KV cache (device half: `PagedKVCache` in
`models/decoding.py`). The allocator owns which pool blocks belong to
which request, shares blocks between requests with a common prompt prefix
(refcounted, automatic prefix caching at block granularity), and
duplicates a shared partial block before a new owner appends into it
(copy-on-write: the engine runs the device-side `copy_block`, then swaps
the table entry the allocator hands back).

Block 0 is the reserved NULL block: never allocated, every unused table
entry points at it, so the gather/scatter is always in bounds.

Pure Python, the same behaviour as the JAX package's allocator.

The pool's bytes are carved out of the node's shared-memory object store
through the create-then-fill seam (`ObjectStore.create_arena`): the arena
reservation makes KV pressure visible to the store accounting/syncer
plane, and releasing it returns the store to quiescence. Engines running
without a store (standalone, unit tests) skip the arena. When the store
cannot hold the arena, `create_arena` hands back an anonymous mapping
whose pages nothing touches (`arena_in_store` is then False).
"""
from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional, Tuple


def prefix_digest(tokens) -> str:
    """Stable digest of a cumulative token prefix, keyed on the raw token
    values (not positions): two engines that prefilled the same prompt
    prefix derive the same digest."""
    h = hashlib.sha1()
    for t in tokens:
        h.update(int(t).to_bytes(8, "little", signed=True))
    return h.hexdigest()[:16]


class KVBlockAllocator:
    """Free-list + refcounts + prefix map over ``num_blocks`` pool blocks
    of ``block_size`` tokens each (block 0 reserved).

    Prefix map: key = tuple of ALL prompt tokens up to and including a
    block's chunk (cumulative keys make lookups exact, not positional).
    Freed blocks that carry a prefix key become "cached-free": refcount
    0, contents intact, LRU-evictable when the free list runs dry. A
    lookup hit on a cached-free block revives it (refcount 1) without
    re-prefilling.
    """

    def __init__(self, num_blocks: int, block_size: int, *,
                 store: Any = None, bytes_per_block: int = 0,
                 prefix_sharing: bool = True, arena_name: str = "kv-pool"):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is the null block)")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.prefix_sharing = prefix_sharing
        self._lock = threading.Lock()
        self._free: deque = deque(range(1, num_blocks))
        self._ref = [0] * num_blocks
        # prefix key -> block id; insertion order over CACHED (refcount
        # 0) entries is the eviction LRU.
        self._by_key: Dict[tuple, int] = {}
        self._key_of: Dict[int, tuple] = {}
        # key -> stable digest (computed once at registration).
        self._digest_of: Dict[tuple, str] = {}
        self._cached: "OrderedDict[int, None]" = OrderedDict()
        # full-prompt key -> metadata (last-token logits) so a whole-
        # prompt hit can sample its first token without any forward.
        self._meta: Dict[tuple, Any] = {}
        self.stats = {"reuse_hits": 0, "reuse_misses": 0, "cow_copies": 0,
                      "evictions": 0, "alloc_failures": 0}
        self._arena = None
        self.arena_bytes = 0
        if store is not None and bytes_per_block > 0:
            self._reserve_arena(store, bytes_per_block, arena_name)

    # -- shm arena ------------------------------------------------------
    def _reserve_arena(self, store, bytes_per_block: int,
                       arena_name: str) -> None:
        from ray_tpu_torch.core.ids import ObjectID

        oid = ObjectID.from_random()
        size = self.num_blocks * bytes_per_block
        try:
            self._arena = store.create_arena(oid, size)
            self.arena_bytes = size
        except Exception:  # noqa: BLE001 — pool works unreserved
            self._arena = None

    @property
    def arena_in_store(self) -> bool:
        """Whether the reservation is an object in the store (False: no
        arena, or the anonymous mapping a full store hands back)."""
        return bool(self._arena is not None and self._arena.in_store)

    def release(self) -> None:
        """Drop the shm arena reservation (engine shutdown)."""
        if self._arena is not None:
            self._arena.release()
            self._arena = None
            self.arena_bytes = 0

    # -- core alloc/free ------------------------------------------------
    def _evict_cached(self) -> Optional[int]:
        """Reclaim the least-recently-registered cached-free block."""
        if not self._cached:
            return None
        blk, _ = self._cached.popitem(last=False)
        key = self._key_of.pop(blk, None)
        if key is not None:
            self._by_key.pop(key, None)
            self._meta.pop(key, None)
            self._digest_of.pop(key, None)
        self.stats["evictions"] += 1
        return blk

    def can_alloc(self, n: int) -> bool:
        with self._lock:
            return len(self._free) + len(self._cached) >= n

    def alloc(self, n: int) -> Optional[List[int]]:
        """Allocate ``n`` exclusive blocks (refcount 1 each) or None if
        the pool can't cover it even after evicting cached prefixes:
        the engine queues the request instead of erroring."""
        with self._lock:
            if len(self._free) + len(self._cached) < n:
                self.stats["alloc_failures"] += 1
                return None
            out = []
            for _ in range(n):
                blk = self._free.popleft() if self._free \
                    else self._evict_cached()
                self._ref[blk] = 1
                out.append(blk)
            return out

    def free(self, blocks: List[int]) -> None:
        """Drop one reference per block. A block reaching refcount 0
        returns to the free list unless it carries a prefix key: then it
        parks in the cached-free LRU with contents intact."""
        with self._lock:
            for blk in blocks:
                if blk <= 0:
                    continue
                self._ref[blk] -= 1
                if self._ref[blk] > 0:
                    continue
                self._ref[blk] = 0
                if self.prefix_sharing and blk in self._key_of:
                    self._cached[blk] = None
                    self._cached.move_to_end(blk)
                else:
                    self._free.append(blk)

    # -- prefix sharing -------------------------------------------------
    def lookup_prefix(self, tokens: List[int]
                      ) -> Tuple[List[int], int, Optional[Any]]:
        """Longest registered prefix of ``tokens``: returns (blocks,
        covered_tokens, meta) with every returned block increffed.
        Coverage is block-aligned except a whole-prompt hit, whose
        (possibly partial) tail block and stored last-token logits ride
        back too: the engine skips prefill entirely on that path."""
        if not self.prefix_sharing:
            return [], 0, None
        bs = self.block_size
        with self._lock:
            whole = tuple(tokens)
            if whole in self._by_key and len(tokens) % bs:
                # Whole-prompt key with a partial tail: grab the aligned
                # chain plus the tail.
                chain = self._chain_locked(tokens, len(tokens) // bs)
                if chain is not None:
                    tail = self._by_key[whole]
                    self._take_locked(tail)
                    blocks = chain + [tail]
                    self.stats["reuse_hits"] += len(blocks)
                    return blocks, len(tokens), self._meta.get(whole)
            # Longest aligned chain.
            n_full = len(tokens) // bs
            for k in range(n_full, 0, -1):
                chain = self._chain_locked(tokens, k)
                if chain is not None:
                    self.stats["reuse_hits"] += len(chain)
                    meta = (self._meta.get(whole)
                            if k * bs == len(tokens) else None)
                    return chain, k * bs, meta
            self.stats["reuse_misses"] += 1
            return [], 0, None

    def _chain_locked(self, tokens, k: int) -> Optional[List[int]]:
        """Incref + return the first k aligned blocks, or None if any
        link is missing (all-or-nothing so refcounts stay balanced)."""
        bs = self.block_size
        blocks = []
        for i in range(k):
            blk = self._by_key.get(tuple(tokens[:(i + 1) * bs]))
            if blk is None:
                for b in blocks:          # roll back increfs
                    self._drop_locked(b)
                return None
            blocks.append(blk)
        for b in blocks:
            self._take_locked(b)
        return blocks

    def _take_locked(self, blk: int) -> None:
        if self._ref[blk] == 0:
            self._cached.pop(blk, None)
        self._ref[blk] += 1

    def _drop_locked(self, blk: int) -> None:
        # Undo a _take_locked during chain rollback (no LRU re-park: the
        # block never left the caller's view).
        if self._ref[blk] > 0:
            self._ref[blk] -= 1
            if self._ref[blk] == 0 and blk in self._key_of:
                self._cached[blk] = None

    def register_prefix(self, tokens: List[int], blocks: List[int],
                        meta: Any = None) -> None:
        """Publish a prefilled prompt's blocks for reuse: aligned chunks
        keyed cumulatively, plus the whole-prompt key on the tail (which
        may be partial). ``meta`` (last-token logits) is stored under the
        whole-prompt key. Does NOT change refcounts: the caller still
        owns its references; blocks become cached-free when the last
        owner frees them."""
        if not self.prefix_sharing:
            return
        bs = self.block_size
        with self._lock:
            n_full = len(tokens) // bs
            for i in range(n_full):
                key = tuple(tokens[:(i + 1) * bs])
                self._register_locked(key, blocks[i])
            if len(tokens) % bs and len(blocks) > n_full:
                self._register_locked(tuple(tokens), blocks[n_full])
            if meta is not None:
                self._meta[tuple(tokens)] = meta

    def _register_locked(self, key: tuple, blk: int) -> None:
        old = self._by_key.get(key)
        if old == blk:
            return
        if old is not None:
            # Key collision with a different block: keep the existing
            # registration (its content already matches the key).
            return
        prev_key = self._key_of.get(blk)
        if prev_key is not None and prev_key != key:
            self._by_key.pop(prev_key, None)
            self._meta.pop(prev_key, None)
            self._digest_of.pop(prev_key, None)
        self._by_key[key] = blk
        self._key_of[blk] = key
        self._digest_of[key] = prefix_digest(key)

    def adopt(self, tokens: List[int], meta: Any = None
              ) -> Optional[List[int]]:
        """Adopt path for KV frames computed elsewhere (disaggregated
        prefill, live migration): allocate blocks covering ``tokens``,
        register them as a reusable prefix and return the block ids, still
        referenced. The engine scatters the frame into them, then ``free``s
        them to park cached-free (contents intact, LRU-evictable), so the
        next lookup of the prompt takes the ordinary prefix-hit path. None
        when sharing is off or the pool cannot cover the frame (the caller
        recomputes)."""
        if not self.prefix_sharing or not tokens:
            return None
        need = -(-len(tokens) // self.block_size)
        blocks = self.alloc(need)
        if blocks is None:
            return None
        self.register_prefix(tokens, blocks, meta=meta)
        return blocks

    def prefix_digests(self, limit: int = 0) -> List[str]:
        """Digests of the block-ALIGNED registered prefixes, most recently
        registered last; ``limit`` > 0 keeps the newest that many."""
        with self._lock:
            out = [d for k, d in self._digest_of.items()
                   if len(k) % self.block_size == 0]
        if limit > 0 and len(out) > limit:
            out = out[-limit:]
        return out

    def unregister_block(self, blk: int) -> None:
        """Drop a block's prefix key (its content is about to diverge from
        the key: the sole-owner in-place append)."""
        with self._lock:
            key = self._key_of.pop(blk, None)
            if key is not None:
                self._by_key.pop(key, None)
                self._meta.pop(key, None)
                self._digest_of.pop(key, None)
            self._cached.pop(blk, None)

    def cow(self, blk: int) -> Tuple[int, bool]:
        """Prepare ``blk`` for in-place writes by its caller (who holds
        one reference). Shared or registered blocks are duplicated:
        returns (new_block, True) and the caller must device-copy
        blk -> new_block and swap its table entry (its reference moves
        to the copy). A sole-owner unregistered block is returned as-is:
        (blk, False)."""
        with self._lock:
            shared = self._ref[blk] > 1
            registered = blk in self._key_of
            if not shared and not registered:
                return blk, False
            if not shared and registered:
                # Sole owner of a registered block: keep the pristine
                # copy for future hits only when a spare block exists;
                # otherwise unregister and write in place.
                if not self._free and not self._cached:
                    key = self._key_of.pop(blk)
                    self._by_key.pop(key, None)
                    self._meta.pop(key, None)
                    self._digest_of.pop(key, None)
                    return blk, False
            new = self._free.popleft() if self._free \
                else self._evict_cached()
            if new is None:
                # Pool exhausted and the block is SHARED: the caller
                # must wait for capacity like any other allocation.
                raise MemoryError("KV pool exhausted during COW")
            self._ref[new] = 1
            # Caller's reference migrates to the copy.
            self._ref[blk] -= 1
            if self._ref[blk] == 0:
                if blk in self._key_of:
                    self._cached[blk] = None
                    self._cached.move_to_end(blk)
                else:
                    self._free.append(blk)
            self.stats["cow_copies"] += 1
            return new, True

    # -- introspection --------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            usable = self.num_blocks - 1
            free = len(self._free)
            cached = len(self._cached)
            active = usable - free - cached
            return {
                "blocks_total": usable,
                "blocks_free": free,
                "blocks_cached": cached,
                "blocks_active": active,
                "occupancy": round(active / usable, 4) if usable else 0.0,
                "prefixes_registered": len(self._by_key),
                "arena_bytes": self.arena_bytes,
                **self.stats,
            }
