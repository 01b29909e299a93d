"""Paged KV residency: block-table allocation behind the serving scheduler.

The COPA paper prices its serving configs under the assumption that a
request's peak KV footprint is resident for its whole lifetime — which is
exactly what ``repro_torch.serve.sim`` did by reserving ``prompt + output`` tokens
at admission. Production engines (vLLM-style block tables) allocate KV in
fixed-size *pages* as the sequence grows, which changes what the MSM's
DRAM capacity knob buys: the same DRAM holds more in-flight requests, and
an oversubscribed pool trades occasional eviction + prefill recompute for
admission headroom. This module is the allocator layer of that model:

* :class:`PagedKvSpec` — the residency policy (``page_size``,
  ``oversubscription``, eviction policy) threaded through
  :class:`~repro_torch.serve.sim.Instance`, ``repro_torch.serve.fleet`` and the batched
  fleet core. ``paged=None`` at the API layer keeps the original
  full-reservation behavior (the parity oracle).
* :class:`ReservedKv` — the scalar reservation allocator (the old
  ``kv_reserved`` counter behind the shared allocator interface).
* :class:`PagedKv` — a real block table: free list of page ids,
  per-request page lists, a *commit* ledger (peak pages per admitted
  request, bounded by ``capacity_pages * oversubscription``) and a *mapped*
  ledger (pages actually backing resident KV, bounded by
  ``capacity_pages``).
* :class:`SchedPolicy` — the scheduler hook that rides on the allocator
  interface: chunked prefill (``prefill_chunk`` tokens per request per
  iteration) and decode-priority admission (at most one admission per
  iteration, and none while a prefill is mid-flight).

Residency model (shared by the heap oracle and both batched engines, and
what the parity tests pin down):

* a request's *committed* footprint is its peak ``ceil((prompt + output) /
  page_size)`` pages, checked against the oversubscribable commit budget at
  admission — with ``oversubscription == 1.0`` this is exactly the old
  conservative reservation, page-granular;
* its *mapped* footprint at a step is ``ceil(kv_read / page_size)`` where
  ``kv_read`` is the KV the step must read (prefilled context + previously
  emitted tokens). The token a step writes lands in the page mapped at its
  next step's start (write-allocate at the step boundary), so a request's
  final token never needs a resident page — pages exist to serve future
  reads. With ``page_size=1`` and oversubscription disabled the mapped sum
  equals the reservation path's resident-KV sum bit-for-bit;
* when mapped demand would exceed physical pages (only possible with
  ``oversubscription > 1``), the LRU policy evicts the least-recently-
  admitted running request(s) back to the *front* of the waiting queue;
  their pages are freed and their KV is recomputed (prompt + already-
  emitted tokens re-prefilled) at re-admission — emitted tokens are never
  lost, only residency. Extreme oversubscription can recompute-thrash,
  exactly as on real engines; admission never triggers eviction (a
  candidate must fit the *physical* pool on top of current demand).

The JAX reference package's module, host-side and free of tensor work.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

EVICTION_POLICIES = ("none", "lru")


def pages_for(tokens: int, page_size: int) -> int:
    """Pages holding ``tokens`` KV tokens (ceil division; 0 tokens -> 0)."""
    return -(-tokens // page_size)


@dataclass(frozen=True)
class PagedKvSpec:
    """Block-table residency policy for one serving instance.

    ``oversubscription`` scales the commit budget: 1.0 admits only what is
    guaranteed to fit physically (eviction can never fire); > 1.0 admits
    more and requires an eviction policy to resolve page-pool pressure."""

    page_size: int = 16
    oversubscription: float = 1.0
    eviction: str = "none"

    def __post_init__(self):
        if self.page_size < 1:
            raise ValueError("page_size must be >= 1")
        if not (self.oversubscription > 0
                and math.isfinite(self.oversubscription)):
            raise ValueError("oversubscription must be finite and > 0")
        if self.eviction not in EVICTION_POLICIES:
            raise ValueError(f"unknown eviction policy {self.eviction!r}; "
                             f"one of {EVICTION_POLICIES}")
        if self.eviction == "none" and self.oversubscription > 1.0:
            raise ValueError(
                "oversubscription > 1 needs an eviction policy (mapped "
                "demand may exceed physical pages)")


@dataclass(frozen=True)
class SchedPolicy:
    """Continuous-batching scheduler variants on the allocator hook.

    ``prefill_chunk`` caps the prompt tokens one request prefills per
    iteration (None: whole prompt in its admission iteration — the
    original semantics); the iteration that consumes the last chunk also
    emits the first token. ``decode_priority`` admits at most ONE request
    per iteration into a non-empty batch and defers admission entirely
    while any running request is still mid-prefill, bounding the prefill
    stall a decode step can absorb."""

    prefill_chunk: int | None = None
    decode_priority: bool = False

    def __post_init__(self):
        if self.prefill_chunk is not None and self.prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1 (or None)")

    @property
    def is_default(self) -> bool:
        return self.prefill_chunk is None and not self.decode_priority


class ReservedKv:
    """Scalar full-reservation allocator — the ``page_size=None`` oracle.

    Commits a request's whole ``prompt + output`` token footprint at
    admission (the original ``kv_reserved`` counter); nothing is paged, so
    ``pages_mapped`` is always 0 and eviction never applies."""

    page_size = None

    def __init__(self, capacity_tokens: float):
        self.capacity_tokens = float(capacity_tokens)
        self.reserved = 0.0
        self.pages_mapped = 0

    def fits(self, kv_tokens: int) -> bool:
        """Could this request EVER be admitted on an empty instance?"""
        return kv_tokens <= self.capacity_tokens

    def can_admit(self, kv_tokens: int) -> bool:
        return self.reserved + kv_tokens <= self.capacity_tokens

    def admit(self, rid: int, kv_tokens: int) -> None:
        self.reserved += kv_tokens

    def ensure(self, rid: int, demand_pages: int) -> None:
        pass

    def release(self, rid: int, kv_tokens: int) -> None:
        self.reserved -= kv_tokens

    @property
    def committed_tokens(self) -> float:
        return self.reserved


class PagedKv:
    """Block-table KV allocator: free list + per-request page lists.

    Two ledgers guard two different limits. The *commit* ledger holds each
    admitted request's peak page count against ``commit_budget =
    capacity_pages * oversubscription`` — the admission bound. The *mapped*
    ledger holds the pages actually wired to requests against the physical
    ``capacity_pages`` — the eviction bound. Page ids are handed out
    deterministically (ascending from the free list) so engine parity is
    exact; with infinite capacity the free list is virtual (a counter)."""

    def __init__(self, capacity_tokens: float, spec: PagedKvSpec):
        self.spec = spec
        self.page_size = spec.page_size
        self.capacity_tokens = float(capacity_tokens)
        if math.isinf(self.capacity_tokens):
            self.capacity_pages: float = float("inf")
            self._free: list[int] | None = None    # virtual free list
            self._next_page = 0
        else:
            self.capacity_pages = int(self.capacity_tokens
                                      // self.page_size)
            # pop() from the tail yields pages 0, 1, 2, ...
            self._free = list(range(self.capacity_pages - 1, -1, -1))
            self._next_page = -1
        self.commit_budget = self.capacity_pages * spec.oversubscription
        self.page_table: dict[int, list[int]] = {}
        self._committed: dict[int, int] = {}       # rid -> peak pages
        self.committed_pages = 0
        self.pages_mapped = 0

    def pages_for(self, tokens: int) -> int:
        return -(-tokens // self.page_size)

    def fits(self, kv_tokens: int) -> bool:
        """Peak footprint fits the PHYSICAL pool (else never admissible)."""
        return self.pages_for(kv_tokens) <= self.capacity_pages

    def can_admit(self, kv_tokens: int) -> bool:
        return (self.committed_pages + self.pages_for(kv_tokens)
                <= self.commit_budget)

    def admit(self, rid: int, kv_tokens: int) -> None:
        if rid in self._committed:
            raise RuntimeError(f"request {rid} already admitted")
        peak = self.pages_for(kv_tokens)
        self._committed[rid] = peak
        self.committed_pages += peak
        self.page_table[rid] = []

    def ensure(self, rid: int, demand_pages: int) -> None:
        """Grow ``rid``'s page list to ``demand_pages`` (never shrinks —
        a residency's KV only grows until release/eviction)."""
        pages = self.page_table[rid]
        grow = demand_pages - len(pages)
        if grow <= 0:
            return
        if self._free is None:
            nxt = self._next_page
            pages.extend(range(nxt, nxt + grow))
            self._next_page = nxt + grow
        else:
            if grow > len(self._free):
                raise RuntimeError(
                    "page pool exhausted — eviction should have run")
            for _ in range(grow):
                pages.append(self._free.pop())
        self.pages_mapped += grow

    def release(self, rid: int, kv_tokens: int | None = None) -> None:
        """Unmap + uncommit ``rid`` (completion or eviction)."""
        pages = self.page_table.pop(rid)
        self.pages_mapped -= len(pages)
        if self._free is not None:
            self._free.extend(reversed(pages))
        self.committed_pages -= self._committed.pop(rid)

    @property
    def committed_tokens(self) -> float:
        """Committed footprint in token units (what the step log records —
        with ``page_size=1`` this equals the reservation path's counter)."""
        return float(self.committed_pages * self.page_size)


def make_allocator(capacity_tokens: float,
                   spec: PagedKvSpec | None):
    """The allocator behind an :class:`~repro_torch.serve.sim.Instance`."""
    if spec is None:
        return ReservedKv(capacity_tokens)
    return PagedKv(capacity_tokens, spec)
