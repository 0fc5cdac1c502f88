"""KV-cache slot management for continuous batching.

Static-capacity design (real-time constraint — no retracing on the hot
path): the engine owns ``max_batch`` slots; requests are admitted
into free slots, generate in lockstep decode steps, and free their slot on
completion. Cache leaves universally carry batch at axis 1 ((layers, B, ...)),
so slot insertion is one in-place copy into a ``narrow`` view per leaf.

Slots carry an explicit LIFECYCLE PHASE so a multi-tenant frontend can tell
"prefill still staging" apart from "participating in lockstep decode":

    free ──allocate──▶ prefill ──insert resolves──▶ decoding ──▶ finished
      ▲                                                            │
      └──────────── free() / evict() (returns to free list) ◀──────┘

``allocate`` draws from an explicit FIFO free list (deterministic reuse,
O(1) per call); ``free``/``evict`` return the index to it. ``evict`` is the
shed path — semantically identical to ``free`` but counted separately, so a
stream frontend's overload decisions are auditable. Each allocation bumps a
``generation`` counter: a caller holding a Slot object across reuse can
detect staleness instead of appending tokens into a stranger's record.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core.persistent import tree_map

BATCH_AXIS = 1   # cache leaves are (layers/groups, B, ...)

# -- slot lifecycle phases -------------------------------------------------
PH_FREE = "free"          # on the free list
PH_PREFILL = "prefill"    # allocated; prefill (host or device) in progress
PH_DECODING = "decoding"  # inserted; participates in lockstep decode
PH_FINISHED = "finished"  # generation done; awaiting device-side release


@dataclass
class Slot:
    request_id: int = -1
    length: int = 0
    max_len: int = 0
    generated: list = field(default_factory=list)
    active: bool = False
    phase: str = PH_FREE
    generation: int = 0


class SlotManager:
    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self.slots = [Slot() for _ in range(capacity)]
        self._free: deque[int] = deque(range(capacity))
        self._generation = 0
        self.evictions = 0

    def allocate(self, request_id: int, prompt_len: int,
                 max_len: int) -> Optional[int]:
        """Bind a request to a free slot (phase ``prefill``); None when
        every slot is live."""
        if not self._free:
            return None
        i = self._free.popleft()
        self._generation += 1
        self.slots[i] = Slot(request_id=request_id, length=prompt_len,
                             max_len=max_len, active=True, phase=PH_PREFILL,
                             generation=self._generation)
        return i

    def free(self, slot: int) -> Slot:
        """Return a live slot to the free list; the retired Slot record is
        handed back (callers may hold it — it is replaced, not mutated, so
        ``generated`` survives reuse)."""
        s = self.slots[slot]
        if not s.active:
            raise ValueError(f"slot {slot} is not live (double free?)")
        self.slots[slot] = Slot()
        self._free.append(slot)
        return s

    def evict(self, slot: int) -> Slot:
        """The shed path: identical to :meth:`free` (the slot returns to
        the free list) but counted, so overload evictions are auditable
        separately from normal end-of-stream frees."""
        s = self.free(slot)
        self.evictions += 1
        return s

    def set_phase(self, slot: int, phase: str) -> None:
        self.slots[slot].phase = phase

    def active_indices(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if s.active]

    def decoding_indices(self) -> list[int]:
        """Slots whose insert resolved — the only rows a lockstep decode
        step produced a real token for."""
        return [i for i, s in enumerate(self.slots)
                if s.active and s.phase == PH_DECODING]

    @property
    def any_active(self) -> bool:
        return any(s.active for s in self.slots)

    @property
    def free_count(self) -> int:
        return len(self._free)


def insert_slot_caches(big, small, slot: int):
    """Write a batch-1 cache tree into slot ``slot`` of the engine cache,
    IN PLACE (the reference returns an updated copy); returns ``big``."""
    def upd(b, s):
        b.narrow(BATCH_AXIS, slot, 1).copy_(s)
        return b
    return tree_map(upd, big, small)


def extract_slot_caches(big, slot: int):
    """Slot ``slot`` of a batched cache tree as a batch-1 tree of VIEWS
    into ``big`` (the reference returns a copy): writes through them
    update the engine cache in place."""
    return tree_map(lambda b: b.narrow(BATCH_AXIS, slot, 1), big)


def zeros_like_slot(big, slot: int):
    """Zero one slot of a batched cache tree in place; returns ``big``."""
    def z(b):
        b.narrow(BATCH_AXIS, slot, 1).zero_()
        return b
    return tree_map(z, big)
