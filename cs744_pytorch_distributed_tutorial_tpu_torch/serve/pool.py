"""Host-side page accounting for the paged KV pool.

A copy of the JAX package's ``serve/pool.py`` (plain Python). The device
side is dumb on purpose: per-layer pools of ``[num_pages, page_size,
Hkv, D]`` plus a ``[B, P]`` page table, all fixed-shape so the decode
step has one shape. Everything that *varies* — which pages belong to
which request, what is free — lives here as plain Python, mutated
between steps.

Page 0 is reserved as the TRASH page: inactive slots point their whole
table row at it, so the (unavoidable — fixed-shape step) writes from
dead slots land somewhere no live slot ever gathers. It is never
allocated.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class PagePool:
    """LIFO free-list allocator over ``num_pages`` KV pages.

    LIFO keeps the working set of page indices small and recently
    touched (cache-friendly scatter/gather on device), and makes tests
    deterministic. ``high_water`` tracks the max simultaneously
    allocated pages — the number the HBM budget must actually cover.
    """

    num_pages: int
    page_size: int
    _free: list[int] = field(default_factory=list)
    _live: set[int] = field(default_factory=set)
    _allocated: int = 0
    high_water: int = 0
    # Cumulative churn counters: pages handed out / returned over the
    # pool's lifetime (the engine's ``page_churn`` stat).
    total_allocs: int = 0
    total_frees: int = 0

    def __post_init__(self) -> None:
        if self.num_pages < 2:
            raise ValueError(
                f"num_pages must be >= 2 (page 0 is reserved as trash), "
                f"got {self.num_pages}"
            )
        if self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {self.page_size}")
        # Page 0 is the trash page — excluded. Reversed so that pages
        # allocate in ascending order (pop from the end).
        self._free = list(range(self.num_pages - 1, 0, -1))
        self._live = set()

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def allocated_pages(self) -> int:
        return self._allocated

    def pages_for(self, tokens: int) -> int:
        """Pages needed to hold ``tokens`` KV rows (ceil division)."""
        return -(-tokens // self.page_size)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, n: int) -> list[int]:
        if n > len(self._free):
            raise RuntimeError(
                f"page pool exhausted: want {n}, have {len(self._free)} "
                f"free of {self.num_pages - 1} allocatable"
            )
        out = [self._free.pop() for _ in range(n)]
        self._live.update(out)
        self._allocated += n
        self.total_allocs += n
        self.high_water = max(self.high_water, self._allocated)
        return out

    def free(self, pages: list[int]) -> None:
        # Validate against the LIVE set, not just the free list: the old
        # ``p in self._free`` check let a page duplicated WITHIN one call
        # (``free([3, 3])``) slip through silently — the free list grew a
        # duplicate entry and the same page could later be handed to two
        # slots. ``seen`` catches the intra-call duplicate, ``_live``
        # catches everything else (already-free or never-allocated).
        seen: set[int] = set()
        for p in pages:
            if p == 0:
                raise ValueError("page 0 is the reserved trash page")
            if not (0 < p < self.num_pages):
                raise ValueError(f"page index {p} out of range")
            if p in seen or p not in self._live:
                raise ValueError(f"double free of page {p}")
            seen.add(p)
        # Freed pages go back on TOP of the stack — reused first.
        self._free.extend(reversed(pages))
        self._live.difference_update(seen)
        self._allocated -= len(pages)
        self.total_frees += len(pages)

    def check_invariants(self) -> bool:
        """Debug audit of the page accounting; raises AssertionError on
        any violation, returns True when clean (so tests can assert it).

        The engine calls this under ``__debug__`` at every retire /
        preempt / deadline-expiry free — the paths where a bookkeeping
        bug would silently leak (or double-lease) pages:

        - free-list ∪ live pages == every allocatable page (none leaked),
        - free-list ∩ live pages == ∅ (no page both free and leased),
        - the trash page (0) is never allocated and never on the free
          list,
        - the counters agree with the sets.
        """
        free = set(self._free)
        allocatable = set(range(1, self.num_pages))
        assert len(free) == len(self._free), (
            f"free list holds duplicate pages: {sorted(self._free)}"
        )
        assert 0 not in free and 0 not in self._live, (
            "trash page 0 was allocated or freed"
        )
        assert not (free & self._live), (
            f"pages both free and live: {sorted(free & self._live)}"
        )
        assert free | self._live == allocatable, (
            f"pages leaked: {sorted(allocatable - free - self._live)}"
        )
        assert self._allocated == len(self._live), (
            f"allocated counter {self._allocated} != "
            f"{len(self._live)} live pages"
        )
        return True
