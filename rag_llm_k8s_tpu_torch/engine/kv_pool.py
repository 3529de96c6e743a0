"""Block-pool KV allocation for the paged continuous engine, counterpart of
``rag_llm_k8s_tpu/engine/kv_pool.py``.

Host-side bookkeeping only. The device arena ``[L, num_blocks, K, block,
hd]`` is engine state; the pool tracks which physical block ids are live:

- a free list hands out ids O(1), LIFO, and takes them back on release;
- ref counts free a block only when its last holder lets go;
- physical block 0 is the reserved **null block**: never allocated, the
  table entry of every logical block a row has not reached, and the sink
  of every junk write (inactive rows, lanes past a row's table). No kernel
  reads it: every kernel skips logical blocks at or past ``kv_len``;
- ``alloc`` is all-or-nothing and raises :class:`PoolExhausted`, which the
  engine turns into admission backpressure or preemption, never a crash.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict, Iterable, List

from rag_llm_k8s_tpu_torch.sim import policy

NULL_BLOCK = 0


class PoolExhausted(RuntimeError):
    """The pool cannot serve an allocation right now (every block is
    accounted for; freeing a row makes it servable again)."""

    def __init__(self, requested: int, available: int):
        super().__init__(
            f"kv pool exhausted: requested {requested} block(s), {available} free"
        )
        self.requested = requested
        self.available = available


class KVBlockPool:
    """Free-list + ref-count allocator over ``num_blocks`` physical blocks
    of ``block_size`` tokens (block 0 reserved). Thread-safe: the scheduler
    thread allocates, other threads may read the counts."""

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError(
                f"kv pool needs >= 2 blocks (1 reserved null + 1 usable), got {num_blocks}"
            )
        if block_size < 1:
            raise ValueError(f"block_size={block_size}: expected >= 1")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self._lock = threading.Lock()
        self._free: deque = deque(range(1, self.num_blocks))
        self._refs: Dict[int, int] = {}
        self.total_allocs = 0
        self.total_exhaustions = 0
        # registered-prefix blocks per hotness tier (engine/tiering.py): the
        # engine accounts a registration's blocks at register, drop and
        # retier; the allocator itself ignores tiers
        self._tier_blocks: Dict[str, int] = {"hot": 0, "warm": 0, "cold": 0}

    def blocks_for(self, tokens: int) -> int:
        """Blocks covering ``tokens`` logical positions."""
        return policy.blocks_for(tokens, self.block_size)

    def available(self) -> int:
        with self._lock:
            return len(self._free)

    def blocks_in_use(self) -> int:
        with self._lock:
            return (self.num_blocks - 1) - len(self._free)

    def usable_blocks(self) -> int:
        """Allocatable capacity (all but the null block)."""
        return self.num_blocks - 1

    def fragmentation(self, used_tokens: int) -> float:
        """Internal fragmentation: the fraction of allocated token slots not
        holding live KV, ``1 - used / (in_use * block_size)``."""
        in_use = self.blocks_in_use()
        if in_use <= 0:
            return 0.0
        return max(0.0, min(1.0, 1.0 - float(used_tokens) / (in_use * self.block_size)))

    def can_alloc(self, n: int) -> bool:
        with self._lock:
            return n <= len(self._free)

    def alloc(self, n: int) -> List[int]:
        """Take ``n`` blocks (ref count 1 each), all or nothing."""
        if n <= 0:
            return []
        with self._lock:
            free = len(self._free)
            if n > free:
                self.total_exhaustions += 1
                raise PoolExhausted(n, free)
            ids = [self._free.pop() for _ in range(n)]
            for b in ids:
                self._refs[b] = 1
            self.total_allocs += n
            return ids

    def ref(self, ids: Iterable[int]) -> None:
        """One more reference on each block."""
        with self._lock:
            for b in ids:
                if b == NULL_BLOCK:
                    continue
                if b not in self._refs:
                    raise ValueError(f"ref() of unallocated block {b}")
                self._refs[b] += 1

    def free(self, ids: Iterable[int]) -> int:
        """Drop one reference per block; blocks at zero return to the free
        list. A free of an unallocated block is a bookkeeping bug and
        raises. Returns how many blocks became free."""
        reclaimed = 0
        with self._lock:
            for b in ids:
                if b == NULL_BLOCK:
                    continue
                refs = self._refs.get(b)
                if refs is None:
                    raise ValueError(f"free() of unallocated block {b}")
                if refs <= 1:
                    del self._refs[b]
                    self._free.append(b)
                    reclaimed += 1
                else:
                    self._refs[b] = refs - 1
        return reclaimed

    def refcount(self, block: int) -> int:
        with self._lock:
            return self._refs.get(block, 0)

    def account_tier(self, tier: str, delta: int) -> None:
        """Move ``delta`` registered blocks into ``tier``'s ledger (negative
        = out), clamped at zero."""
        if tier not in self._tier_blocks:
            raise ValueError(f"unknown kv tier {tier!r}; tiers: {tuple(self._tier_blocks)}")
        with self._lock:
            self._tier_blocks[tier] = max(0, self._tier_blocks[tier] + delta)

    def tier_occupancy(self) -> Dict[str, int]:
        """Registered blocks per tier, and ``rows``: the blocks in use that
        no registration accounts for."""
        with self._lock:
            out = dict(self._tier_blocks)
            in_use = (self.num_blocks - 1) - len(self._free)
            out["rows"] = max(0, in_use - sum(out.values()))
            return out

    def reset(self) -> None:
        """Every block back to the free list (engine reset); the tier
        ledgers read zero, as the registrations died with the arena."""
        with self._lock:
            self._refs.clear()
            self._free = deque(range(1, self.num_blocks))
            for t in self._tier_blocks:
                self._tier_blocks[t] = 0

    def stats(self) -> Dict[str, int]:
        with self._lock:
            in_use = (self.num_blocks - 1) - len(self._free)
            return {
                "kv_pool_blocks_total": self.num_blocks - 1,
                "kv_pool_blocks_in_use": in_use,
                "kv_pool_blocks_free": len(self._free),
                "kv_pool_allocs_total": self.total_allocs,
                "kv_pool_exhaustions_total": self.total_exhaustions,
                "kv_pool_tier_hot_blocks": self._tier_blocks["hot"],
                "kv_pool_tier_warm_blocks": self._tier_blocks["warm"],
            }

    def __repr__(self) -> str:
        s = self.stats()
        return (
            f"KVBlockPool(bs={self.block_size}, "
            f"in_use={s['kv_pool_blocks_in_use']}/{s['kv_pool_blocks_total']})"
        )
