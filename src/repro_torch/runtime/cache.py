"""Lineage-keyed materialization cache with budgeted device/host tiers.

The result-cache half of interactive processing (paper §Conclusions /
Fig. 6): ``MaRe.persist()`` registers a materialized
:class:`~repro_torch.core.dataset.ShardedDataset` under its lineage
fingerprint, and any later action whose plan *prefix* reaches a cached
lineage node starts from the cached dataset and only executes the
suffix — the Spark ``RDD.cache()`` contract.

Budgeting: entry size is estimated from the dataset's record *schema* ×
capacity × shard count (no device sync, and the reference's integer for
the same dataset), and each tier is a byte-budgeted LRU:

* ``device`` — entries hold the live dataset on its device; evicting
  spills the entry to the ``host`` tier (one copy to CPU tensors; the
  cache drops its reference to the device tensors).
* ``host`` — entries hold CPU tensors plus the shard count and the device
  they came from; a hit copies them back to THAT device (``cuda:1``
  stays ``cuda:1``).  Evicting drops the entry (it can always be
  recomputed from lineage).

Budgets count estimated bytes, not the caching allocator's bytes.

Multi-tenant partitions: entries carry an ``owner`` tag and, when
per-tenant budgets are configured, each owner's resident bytes are
bounded *independently* — one tenant persisting past its partition
evicts ITS OWN least-recent entries, never a neighbour's.  Lookups stay
shared and read-only: a hit on an entry someone else paid for counts as
a ``shared_hit``.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch.core import tree
from repro_torch.core.dataset import ShardedDataset
from repro_torch.core.plan import Plan
from repro_torch.core.schema import schema_of_records, torch_dtype
from repro_torch.obs import METRICS, instant, span
from repro_torch.runtime.lineage import Lineage

TIERS = ("device", "host")


def estimate_nbytes(ds: ShardedDataset) -> int:
    """Schema-based size estimate: itemsize x record shape x capacity x
    shards per leaf, plus the counts vector (no device transfer)."""
    schema = schema_of_records(ds.records)
    rows = ds.capacity * ds.num_shards
    total = ds.num_shards * 4    # counts: int32 per shard
    for f in tree.leaves(schema.fields):
        per_record = 1
        for d in f.shape:
            per_record *= int(d)
        total += torch_dtype(f.dtype).itemsize * per_record * rows
    return int(total)


@dataclasses.dataclass
class CacheEntry:
    """One materialized lineage node, resident in exactly one tier."""

    lineage: Lineage
    tier: str                        # "device" | "host"
    nbytes: int
    dataset: Optional[ShardedDataset] = None       # device tier
    host_records: Any = None                       # host tier (CPU tensors)
    host_counts: Optional[torch.Tensor] = None
    num_shards: int = 1
    #: Device the dataset lived on; a host-tier hit copies back there.
    device: Optional[torch.device] = None
    #: Tenant charged for this entry's bytes (None = unowned/shared pool).
    owner: Optional[str] = None


#: Default per-tier budgets (the reference's): every ``persist()`` pins
#: its materialization in the process-wide store, so the defaults are
#: FINITE.  Pass ``None`` for unbounded.
DEVICE_BUDGET_DEFAULT = 1 << 30   # 1 GiB estimated device-resident bytes
HOST_BUDGET_DEFAULT = 4 << 30     # 4 GiB spilled host copies
#: On a machine with CUDA the device tier's default is this share of the
#: current card's memory instead: one k = 12 k-mer table over 8 shards
#: is 1.6 GB, so the reference's 1 GiB would spill every generation of
#: a stream to the host.  The rest of the card is left to the actions.
DEVICE_BUDGET_CARD_SHARE = 0.25


def default_device_budget() -> int:
    """The device tier's default budget: ``DEVICE_BUDGET_CARD_SHARE`` of
    the current CUDA card's memory, or ``DEVICE_BUDGET_DEFAULT`` on a
    machine without CUDA."""
    if not torch.cuda.is_available():
        return DEVICE_BUDGET_DEFAULT
    total = torch.cuda.get_device_properties(
        torch.cuda.current_device()).total_memory
    return int(total * DEVICE_BUDGET_CARD_SHARE)


class MaterializationCache:
    """Budgeted two-tier LRU store of materialized datasets by lineage.

    ``device_budget_bytes`` / ``host_budget_bytes`` bound the estimated
    resident bytes per tier; ``None`` means unbounded, and the device
    tier's ``"auto"`` (the default) is :func:`default_device_budget`.  One shared LRU
    order spans both tiers, but budgets and eviction are per tier: device
    evicts by spilling to host, host evicts by dropping.
    """

    def __init__(self,
                 device_budget_bytes: Union[int, None, str] = "auto",
                 host_budget_bytes: Optional[int] = HOST_BUDGET_DEFAULT,
                 tenant_device_budget_bytes: Optional[int] = None,
                 tenant_host_budget_bytes: Optional[int] = None
                 ) -> None:
        self.device_budget_bytes = device_budget_bytes
        self.host_budget_bytes = host_budget_bytes
        #: Per-OWNER partition bounds (None = partitions unbounded; the
        #: global budgets still apply).
        self.tenant_device_budget_bytes = tenant_device_budget_bytes
        self.tenant_host_budget_bytes = tenant_host_budget_bytes
        self._entries: "OrderedDict[Lineage, CacheEntry]" = OrderedDict()
        # persist() runs on the caller's thread while async actions hit
        # the store from the executor's dispatch thread — every public
        # method takes this lock
        self._lock = threading.RLock()
        self.hits = 0
        self.host_hits = 0
        self.shared_hits = 0      # reader != owner on an owned entry
        self.misses = 0
        self.puts = 0
        self.spills = 0
        self.drops = 0
        #: Explicit :meth:`drop` removals — separate from LRU ``drops``.
        self.invalidations = 0
        #: Enforcement passes that left some owner partition over its
        #: budget (impossible by construction).
        self.tenant_budget_violations = 0

    # -- accounting ----------------------------------------------------------

    def _device_budget(self) -> Optional[int]:
        """The device tier's budget, ``"auto"`` resolved at first use (not
        at construction: the process-wide executor is built at import)."""
        if self.device_budget_bytes == "auto":
            self.device_budget_bytes = default_device_budget()
        return self.device_budget_bytes

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def tier_bytes(self, tier: str, owner: Any = Ellipsis) -> int:
        """Resident estimated bytes in ``tier`` (``owner=`` filters to one
        owner's charged entries; the default counts everyone's)."""
        with self._lock:
            return sum(e.nbytes for e in self._entries.values()
                       if e.tier == tier
                       and (owner is Ellipsis or e.owner == owner))

    def owner_bytes(self) -> Dict[Optional[str], Dict[str, int]]:
        """Per-owner charged bytes by tier."""
        with self._lock:
            out: Dict[Optional[str], Dict[str, int]] = {}
            for e in self._entries.values():
                per = out.setdefault(e.owner, {t: 0 for t in TIERS})
                per[e.tier] += e.nbytes
            return out

    def entry(self, lineage: Lineage) -> Optional[CacheEntry]:
        """Peek without touching recency or stats (describe/tests)."""
        with self._lock:
            return self._entries.get(lineage)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"entries": len(self._entries),
                    "device_bytes": self.tier_bytes("device"),
                    "host_bytes": self.tier_bytes("host"),
                    "hits": self.hits, "host_hits": self.host_hits,
                    "shared_hits": self.shared_hits,
                    "misses": self.misses, "puts": self.puts,
                    "spills": self.spills, "drops": self.drops,
                    "invalidations": self.invalidations,
                    "tenant_budget_violations":
                        self.tenant_budget_violations}

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def drop(self, lineage: Lineage) -> bool:
        """Explicitly remove one entry (any tier), returning whether it
        was resident — *invalidation*, not eviction."""
        with self._lock:
            entry = self._entries.pop(lineage, None)
            if entry is None:
                return False
            self.invalidations += 1
            instant("cache.invalidate", nbytes=entry.nbytes,
                    lineage=lineage.digest())
            METRICS.counter("mat_cache.invalidations").inc()
            return True

    # -- put / eviction ------------------------------------------------------

    def put(self, ds: ShardedDataset, tier: str = "device",
            owner: Optional[str] = None) -> CacheEntry:
        """Register a materialized dataset under its lineage (idempotent
        per lineage: a re-persist refreshes recency, and re-places an
        entry held in the other tier).  ``owner`` charges the entry's
        bytes to that tenant's partition; a re-persist keeps the original
        owner."""
        if tier not in TIERS:
            raise ValueError(f"unknown persist tier {tier!r}; "
                             f"expected one of {TIERS}")
        if ds.lineage is None:
            raise ValueError("dataset has no lineage fingerprint; persist "
                             "through MaRe/Executor, not raw datasets")
        with self._lock:
            existing = self._entries.get(ds.lineage)
            if existing is not None and existing.tier == tier:
                self._entries.move_to_end(ds.lineage)
                return existing
            entry = CacheEntry(lineage=ds.lineage, tier=tier,
                               nbytes=estimate_nbytes(ds),
                               num_shards=ds.num_shards, device=ds.device,
                               owner=existing.owner if existing is not None
                               else owner)
            if tier == "device":
                entry.dataset = ds
            else:
                self._to_host(entry, ds)
            self._entries[ds.lineage] = entry
            self._entries.move_to_end(ds.lineage)
            self.puts += 1
            METRICS.counter(f"mat_cache.{tier}.puts").inc()
            self._enforce_budgets()
            return entry

    def _to_host(self, entry: CacheEntry, ds: ShardedDataset) -> None:
        # runs under self._lock, so a large spill stalls concurrent
        # lookups for the copy's duration — the price of atomic tier
        # accounting.  copy=True: a CPU dataset's host copy is its own
        # tensors too, never a view the caller may still write.
        entry.host_records = tree.tree_map(
            lambda leaf: leaf.detach().to("cpu", copy=True), ds.records)
        entry.host_counts = ds.counts.detach().to("cpu", copy=True)
        entry.dataset = None
        entry.tier = "host"

    def _spill_lru(self, owner: Any = Ellipsis) -> bool:
        """Spill the least-recent device entry (of ``owner``, when given)
        to the host tier; False when that tier has no candidate."""
        victim = next((e for e in self._entries.values()
                       if e.tier == "device"
                       and (owner is Ellipsis or e.owner == owner)), None)
        if victim is None:
            return False
        with span("cache.spill", nbytes=victim.nbytes,
                  lineage=victim.lineage.digest()):
            self._to_host(victim, victim.dataset)
        self.spills += 1
        METRICS.counter("mat_cache.device.evictions").inc()
        return True

    def _drop_lru(self, owner: Any = Ellipsis) -> bool:
        """Drop the least-recent host entry (of ``owner``, when given)."""
        victim_key = next((k for k, e in self._entries.items()
                           if e.tier == "host"
                           and (owner is Ellipsis or e.owner == owner)),
                          None)
        if victim_key is None:
            return False
        instant("cache.drop", nbytes=self._entries[victim_key].nbytes,
                lineage=victim_key.digest())
        del self._entries[victim_key]
        self.drops += 1
        METRICS.counter("mat_cache.host.evictions").inc()
        return True

    def _over(self, tier: str, budget: Optional[int], owner: Any) -> bool:
        return budget is not None and self.tier_bytes(tier, owner) > budget

    def _enforce_budgets(self) -> None:
        # per-owner partitions first: an over-budget owner evicts within
        # its OWN entries, so one tenant's persist pressure can never
        # push a neighbour's materializations out
        dev_b = self.tenant_device_budget_bytes
        host_b = self.tenant_host_budget_bytes
        if dev_b is not None or host_b is not None:
            owners = {e.owner for e in self._entries.values()
                      if e.owner is not None}
            for owner in owners:
                while self._over("device", dev_b, owner):
                    if not self._spill_lru(owner):
                        break
                while self._over("host", host_b, owner):
                    if not self._drop_lru(owner):
                        break
                if (self._over("device", dev_b, owner)
                        or self._over("host", host_b, owner)):
                    self.tenant_budget_violations += 1
                    METRICS.counter(
                        "mat_cache.tenant_budget_violations").inc()
        # device -> host spill, LRU first; then host drop, LRU first
        while self._over("device", self._device_budget(), Ellipsis):
            if not self._spill_lru():
                break
        while self._over("host", self.host_budget_bytes, Ellipsis):
            if not self._drop_lru():
                break

    # -- lookup --------------------------------------------------------------

    def get(self, lineage: Lineage, tenant: Optional[str] = None
            ) -> Optional[ShardedDataset]:
        """Dataset for an exact lineage node, or None.  Host-tier hits are
        copied back to the entry's own device (and stay host-resident —
        promotion is the caller's persist decision).  ``tenant`` names the
        reader: a hit on an entry someone ELSE paid for also counts as a
        shared (read-only) hit."""
        with self._lock:
            entry = self._entries.get(lineage)
            if entry is None:
                self.misses += 1
                METRICS.counter("mat_cache.misses").inc()
                return None
            self._entries.move_to_end(lineage)
            self.hits += 1
            METRICS.counter(f"mat_cache.{entry.tier}.hits").inc()
            if entry.owner is not None and tenant != entry.owner:
                self.shared_hits += 1
                METRICS.counter("mat_cache.shared_hits").inc()
            if entry.tier == "device":
                return entry.dataset
            self.host_hits += 1
            with span("cache.host_restore", nbytes=entry.nbytes):
                dev = entry.device
                records = tree.tree_map(lambda leaf: leaf.to(dev),
                                        entry.host_records)
                counts = entry.host_counts.to(dev)
            return ShardedDataset(records=records, counts=counts,
                                  num_shards=entry.num_shards,
                                  lineage=lineage)

    def longest_prefix(self, root: Lineage, plan: Plan
                       ) -> Tuple[int, Optional[Lineage]]:
        """Longest plan prefix (stage count, lineage) materialized here.

        Scans from the full plan down to one stage; ``(0, None)`` when no
        prefix is cached.  Pure lookup on keys — no data and no stats
        touched, so ``describe()`` may call it freely.
        """
        with self._lock:
            for i in range(len(plan.stages), 0, -1):
                lin = root.extend(plan, upto=i)
                if lin in self._entries:
                    return i, lin
            return 0, None

    def lookup_prefix(self, root: Lineage, plan: Plan,
                      tenant: Optional[str] = None
                      ) -> Tuple[int, Optional[str],
                                 Optional[ShardedDataset]]:
        """Atomic longest-prefix lookup + fetch for an action: returns
        ``(stages, tier, dataset)``, or ``(0, None, None)`` — counted as
        one miss — when no prefix is materialized.  Atomic, so a
        concurrent ``persist()`` cannot evict the entry between the
        lookup and the fetch and mis-report the serving tier."""
        with self._lock:
            k, lin = self.longest_prefix(root, plan)
            if not k:
                self.misses += 1
                METRICS.counter("mat_cache.misses").inc()
                return 0, None, None
            tier = self._entries[lin].tier
            return k, tier, self.get(lin, tenant=tenant)
