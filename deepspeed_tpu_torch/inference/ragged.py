"""Ragged-batching control plane: paged KV-cache bookkeeping.

Counterpart of deepspeed_tpu/inference/ragged.py, kept as a near-verbatim
copy (the module is host-side Python with no JAX in it; the port keeps its
own copy so it imports nothing of the JAX package). Host-side pure
Python/numpy: the device only ever sees dense int32 block tables and
context lengths, so all allocation policy stays off the device.

One "block" spans `block_size` token slots across ALL layers: allocating
a block reserves that token range in every layer's K and V cache.

Prefix caching (vLLM-style automatic prefix caching): the allocator is
REFCOUNTED, a block may be shared by several sequences, and retired
blocks whose contents are content-addressed park in an LRU pool instead
of recycling, so a later prompt sharing the prefix reuses them without
recomputation. The StateManager keys each FULL block by the hash chain
key_i = H(key_{i-1}, tokens_in_block_i) (blake2b); `extend()` takes the
prompt token ids, walks the chain, and returns the match. A shared tail
block is copy-on-write: the match reports a (src, dst) page copy the
engine must issue before any sequence appends into it.
"""

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np


class KVCacheExhaustedError(RuntimeError):
    """The paged KV pool cannot satisfy an allocation: zero free AND
    zero evictable parked blocks left after accounting. Typed (a
    RuntimeError subclass, so legacy callers keep working) because the
    serving scheduler's reserve loop must distinguish "pool pressure —
    preempt and retry" from any other RuntimeError (e.g. the tracked-
    sequence cap), which it must surface, not answer with preemption."""


class BlockedAllocator:
    """Refcounted free-list allocator over the paged KV cache, with an
    LRU pool of retired-but-cached blocks.

    ref: inference/v2/ragged/blocked_allocator.py:11 — same contract
    (allocate n or raise; free returns blocks) extended with
    vLLM-style block sharing:

    - every allocated block carries a refcount; `incref` shares a live
      block, `free` decrements and only a count of zero retires it.
    - a retired block that was `mark_cached` (its contents are in the
      prefix index) PARKS in an LRU pool instead of entering the free
      list — the KV pages stay valid for future prefix hits.
    - allocation under pressure evicts LRU-cold parked blocks (the
      evict callback lets the index drop their keys first).
    """

    def __init__(self, num_blocks: int,
                 evict_cb: Optional[Callable[[int], None]] = None,
                 cache_pool_blocks: int = -1):
        if num_blocks < 1:
            raise ValueError(f"paged KV cache needs >= 1 block, got {num_blocks}")
        self._num_blocks = num_blocks
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self._refs: Dict[int, int] = {}
        self._lru: "OrderedDict[int, None]" = OrderedDict()  # parked, oldest first
        self._cached: set = set()  # blocks whose contents the index addresses
        self._evict_cb = evict_cb
        # max parked blocks retained (< 0 = unbounded, 0 = never park)
        self._pool_cap = cache_pool_blocks
        self.evictions = 0

    @property
    def total_blocks(self) -> int:
        return self._num_blocks

    @property
    def free_blocks(self) -> int:
        """Strictly-free blocks (content already discarded)."""
        return len(self._free)

    @property
    def cached_blocks(self) -> int:
        """Parked blocks: refcount 0 but contents kept for prefix hits."""
        return len(self._lru)

    @property
    def available_blocks(self) -> int:
        """Allocation capacity: free + evictable parked blocks."""
        return len(self._free) + len(self._lru)

    def refcount(self, block: int) -> int:
        return self._refs.get(block, 0)

    def is_parked(self, block: int) -> bool:
        return block in self._lru

    def _evict_lru(self) -> int:
        block, _ = self._lru.popitem(last=False)
        self._cached.discard(block)
        self.evictions += 1
        if self._evict_cb is not None:
            self._evict_cb(block)
        return block

    def allocate(self, num_blocks: int) -> List[int]:
        if num_blocks < 0:
            raise ValueError(f"cannot allocate {num_blocks} blocks")
        if num_blocks > self.available_blocks:
            raise KVCacheExhaustedError(
                f"KV cache exhausted: requested {num_blocks} blocks, "
                f"{self.available_blocks} available "
                f"({len(self._free)} free + {len(self._lru)} cached) "
                f"of {self._num_blocks}"
            )
        out: List[int] = []
        for _ in range(num_blocks):
            b = self._free.pop() if self._free else self._evict_lru()
            self._refs[b] = 1
            out.append(b)
        return out

    def incref(self, block: int) -> None:
        """Share a LIVE block (prefix hit on a block another sequence
        still references)."""
        if self._refs.get(block, 0) < 1:
            raise ValueError(f"incref of non-live block {block}")
        self._refs[block] += 1

    def acquire_cached(self, block: int) -> None:
        """Resurrect a PARKED block (prefix hit on a retired entry):
        leaves the LRU pool with refcount 1, contents intact."""
        if block not in self._lru:
            raise ValueError(f"block {block} is not parked")
        del self._lru[block]
        self._refs[block] = 1

    def mark_cached(self, block: int) -> None:
        """Flag a block's contents as index-addressed: when its refcount
        drops to zero it parks instead of recycling."""
        self._cached.add(block)

    def _park(self, block: int) -> None:
        self._lru[block] = None  # MRU end
        if 0 <= self._pool_cap < len(self._lru):
            self._free.append(self._evict_lru())

    def parked_blocks_mru(self) -> List[int]:
        """Parked (evictable, index-addressed) block ids, MOST recently
        used first — the replica-spin-up warm-boot path enumerates the
        donor's hottest prefix chains in this order (read-only)."""
        return list(reversed(self._lru))

    def trim_parked(self, max_blocks: int) -> int:
        """Evict up to `max_blocks` LRU-parked blocks into the free
        list (contents dropped, index keys released via the evict
        callback) — the pressure governor's YELLOW relief valve:
        draining cold cache now means allocations under RED pressure
        find real free blocks instead of paying eviction churn.
        Returns the number evicted."""
        n = 0
        while n < max_blocks and self._lru:
            self._free.append(self._evict_lru())
            n += 1
        return n

    def free(self, blocks: List[int]) -> None:
        # validate everything first so a raise mutates nothing
        if len(blocks) != len(set(blocks)):
            raise ValueError(f"double free: duplicate blocks in {blocks}")
        for b in blocks:
            if not (0 <= b < self._num_blocks):
                raise ValueError(f"block {b} out of range [0, {self._num_blocks})")
            if self._refs.get(b, 0) < 1:
                raise ValueError(f"double free of block {b}")
        for b in blocks:
            self._refs[b] -= 1
            if self._refs[b] == 0:
                del self._refs[b]
                if b in self._cached:
                    self._park(b)
                else:
                    self._free.append(b)


@dataclasses.dataclass
class SequenceDescriptor:
    """ref: inference/v2/ragged/sequence_descriptor.py DSSequenceDescriptor —
    tracks one in-flight generation."""

    uid: int
    blocks: List[int] = dataclasses.field(default_factory=list)
    seen_tokens: int = 0  # tokens whose KV lives in the cache
    # prefix-cache bookkeeping: token ids for positions [0, len(tokens))
    # when known, and the chain key per registered/matched full block.
    # tokens_valid flips off the first time tokens are committed that the
    # host never saw (fused-decode sampling) — no further index commits.
    tokens: List[int] = dataclasses.field(default_factory=list)
    tokens_valid: bool = True
    block_keys: List[bytes] = dataclasses.field(default_factory=list)
    n_cached: int = 0  # tokens served from the prefix cache at admission

    def blocks_needed(self, new_tokens: int, block_size: int) -> int:
        total = self.seen_tokens + new_tokens
        need = -(-total // block_size)  # ceil
        return max(0, need - len(self.blocks))


@dataclasses.dataclass
class PrefixMatch:
    """Result of a prefix-cache admission (extend with token_ids)."""

    n_cached: int                  # prompt tokens whose KV is reused
    reused_blocks: List[int]       # shared blocks (index hits)
    fresh_blocks: List[int]        # newly allocated blocks
    cow: Optional[Tuple[int, int]] = None  # (src, dst) page copy to issue


def _chain_key(parent: Optional[bytes], toks) -> bytes:
    """Content address of one full block given its parent's key —
    collision-safe (blake2b) so two different prefixes can never alias
    a cache page."""
    h = hashlib.blake2b(digest_size=16)
    if parent is not None:
        h.update(parent)
    h.update(np.asarray(toks, np.int64).tobytes())
    return h.digest()


class StateManager:
    """Tracks sequences + owns the allocator
    (ref: inference/v2/ragged/ragged_manager.py:19 DSStateManager), plus
    the content-addressed prefix index when enable_prefix_cache is on."""

    def __init__(self, num_blocks: int, block_size: int, max_tracked: int = 2048,
                 enable_prefix_cache: bool = False,
                 cache_pool_blocks: int = -1):
        self.block_size = block_size
        self.allocator = BlockedAllocator(
            num_blocks, evict_cb=self._on_evict,
            cache_pool_blocks=cache_pool_blocks if enable_prefix_cache else 0)
        self.max_tracked = max_tracked
        self.enable_prefix_cache = enable_prefix_cache
        self._seqs: Dict[int, SequenceDescriptor] = {}
        self._index: Dict[bytes, int] = {}      # chain key -> block id
        self._block_key: Dict[int, bytes] = {}  # block id -> chain key
        # chain key -> (parent key, this block's token ids): the token
        # provenance that lets a parked chain be re-serialized for a
        # cross-replica warm boot (parked_chains) — block_size ints per
        # indexed block, dropped with the index entry on eviction
        self._chain_meta: Dict[
            bytes, Tuple[Optional[bytes], Tuple[int, ...]]] = {}
        self.stats: Dict[str, int] = {
            "lookup_hits": 0, "lookup_misses": 0,
            "cached_tokens": 0, "prompt_tokens": 0, "cow_copies": 0,
        }

    def _on_evict(self, block: int) -> None:
        key = self._block_key.pop(block, None)
        if key is not None and self._index.get(key) == block:
            del self._index[key]
            self._chain_meta.pop(key, None)

    # -- queries (ref: ragged_manager.py get_sequence:125 etc.) ----------
    def get(self, uid: int) -> Optional[SequenceDescriptor]:
        return self._seqs.get(uid)

    def get_or_create(self, uid: int) -> SequenceDescriptor:
        if uid not in self._seqs:
            if len(self._seqs) >= self.max_tracked:
                raise RuntimeError(
                    f"too many tracked sequences ({self.max_tracked})"
                )
            self._seqs[uid] = SequenceDescriptor(uid=uid)
        return self._seqs[uid]

    @property
    def n_tracked(self) -> int:
        return self._seqs.__len__()

    @property
    def tracked_uids(self) -> List[int]:
        return list(self._seqs)

    @property
    def free_blocks(self) -> int:
        """Allocation capacity: parked (evictable) blocks count — a
        cached block never blocks a new sequence from fitting."""
        return self.allocator.available_blocks

    @property
    def indexed_blocks(self) -> int:
        return len(self._index)

    def trim_parked(self, max_blocks: int) -> int:
        """Evict up to `max_blocks` LRU-parked prefix-cache blocks to
        the free list (pressure-governor YELLOW action; the allocator's
        evict callback drops their index keys first)."""
        return self.allocator.trim_parked(max_blocks)

    def can_fit(self, uid: int, new_tokens: int) -> bool:
        seq = self._seqs.get(uid) or SequenceDescriptor(uid=uid)
        return seq.blocks_needed(new_tokens, self.block_size) <= self.free_blocks

    def cache_stats(self) -> Dict[str, float]:
        """Prefix-cache counters (lookup hits/misses, cached-token
        ratio, evictions, COW copies) for query()/monitor/bench."""
        s: Dict[str, float] = dict(self.stats)
        s["evictions"] = self.allocator.evictions
        s["parked_blocks"] = self.allocator.cached_blocks
        s["indexed_blocks"] = len(self._index)
        prompt = s["prompt_tokens"]
        s["cached_token_ratio"] = (
            s["cached_tokens"] / prompt if prompt else 0.0)
        return s

    # -- prefix index ----------------------------------------------------
    def lookup_prefix(self, token_ids) -> int:
        """How many leading tokens of `token_ids` this manager could
        serve from its prefix index RIGHT NOW, without acquiring or
        mutating anything — the routing signal a multi-replica front
        door scores replicas by (inference/router.py). Mirrors the
        admission cap exactly: a whole-prompt match reports len-1 (the
        last token must run to produce logits), so the returned count
        equals the `n_cached` an immediate extend(token_ids=...) on
        this replica would get."""
        if not self.enable_prefix_cache or len(token_ids) < 2:
            return 0
        chain = self._walk_chain(token_ids)
        return max(0, min(len(chain) * self.block_size,
                          len(token_ids) - 1))

    def _walk_chain(self, token_ids) -> List[Tuple[bytes, int]]:
        """Longest indexed full-block chain prefix of token_ids:
        [(key, block), ...] in position order. Read-only."""
        bs = self.block_size
        out: List[Tuple[bytes, int]] = []
        key: Optional[bytes] = None
        for i in range(len(token_ids) // bs):
            key = _chain_key(key, token_ids[i * bs:(i + 1) * bs])
            block = self._index.get(key)
            if block is None:
                break
            out.append((key, block))
        return out

    def parked_chains(
            self, limit: int) -> List[Tuple[List[int], List[int]]]:
        """Up to `limit` indexed prefix chains whose LEAF block is
        currently parked, hottest (MRU) first: [(token_ids, blocks)],
        each chain root-to-leaf with full token provenance. Read-only
        — nothing is acquired or mutated. The replica-lifecycle warm
        boot (inference/router.py add_replica) serializes these through
        engine.export_parked_kv so a joining replica starts with the
        donor's hottest cached prefixes already parked in its own
        pool. A chain that is a prefix of an already-collected one is
        skipped (the longer chain carries it); a chain whose interior
        metadata was evicted is skipped whole (its pages may be
        recycled)."""
        chains: List[Tuple[List[int], List[int]]] = []
        seen_keys: set = set()
        for block in self.allocator.parked_blocks_mru():
            if len(chains) >= max(0, limit):
                break
            key = self._block_key.get(block)
            if key is None or key in seen_keys:
                continue
            toks_rev: List[Tuple[int, ...]] = []
            blocks_rev: List[int] = []
            walk: List[bytes] = []
            k: Optional[bytes] = key
            intact = True
            while k is not None:
                meta = self._chain_meta.get(k)
                b = self._index.get(k)
                if meta is None or b is None:
                    intact = False
                    break
                toks_rev.append(meta[1])
                blocks_rev.append(b)
                walk.append(k)
                k = meta[0]
            # ancestors are covered by this (longer) chain either way:
            # a broken walk means the root was evicted and every
            # descendant key is equally unservable as a chain
            seen_keys.update(walk)
            if not intact:
                continue
            tokens = [t for blk in reversed(toks_rev) for t in blk]
            chains.append((tokens, list(reversed(blocks_rev))))
        return chains

    def _acquire(self, block: int) -> None:
        if self.allocator.is_parked(block):
            self.allocator.acquire_cached(block)
        else:
            self.allocator.incref(block)

    def _register_full_blocks(self, seq: SequenceDescriptor) -> None:
        """Commit newly-FULL blocks of `seq` into the index (their
        contents are final: every slot holds a committed token)."""
        bs = self.block_size
        n_full = min(seq.seen_tokens, len(seq.tokens)) // bs
        for i in range(len(seq.block_keys), n_full):
            parent = seq.block_keys[-1] if seq.block_keys else None
            key = _chain_key(parent, seq.tokens[i * bs:(i + 1) * bs])
            seq.block_keys.append(key)
            block = seq.blocks[i]
            if key not in self._index:
                self._index[key] = block
                self._block_key[block] = key
                self._chain_meta[key] = (
                    parent, tuple(seq.tokens[i * bs:(i + 1) * bs]))
                self.allocator.mark_cached(block)
            # an existing entry wins (concurrent identical prompts):
            # this sequence's duplicate block stays private

    # -- mutation --------------------------------------------------------
    def extend(
        self, uid: int, new_tokens: int, token_ids=None,
        max_suffix_rows: Optional[int] = None,
    ) -> Union[SequenceDescriptor,
               Tuple[SequenceDescriptor, PrefixMatch]]:
        """Reserve cache room for `new_tokens` more tokens of `uid`
        (ref: kv_cache.py reserve:144); returns the descriptor with its
        block table grown. Does NOT bump seen_tokens — the engine commits
        that after the forward actually writes the KV. On allocation
        failure a freshly-created descriptor is untracked again, so a
        caught cache-exhausted error does not leak tracked sequences.

        With `token_ids` (the full prompt of a NEW sequence) the call
        additionally walks the prefix hash chain and returns
        (descriptor, PrefixMatch): matched full blocks are SHARED into
        the sequence (refcounted / resurrected from the LRU pool),
        seen_tokens jumps to n_cached (their KV already exists), and
        only the suffix still needs a forward pass. A match covering the
        whole prompt is capped at len-1 (the last token must run to
        produce logits) and its tail block goes copy-on-write: the match
        carries a (src, dst) page copy the engine must issue before the
        tail is written. max_suffix_rows bounds the non-cached suffix
        (the engine's decode-row budget); a hit whose suffix would not
        fit degrades to a plain miss."""
        created = uid not in self._seqs
        seq = self.get_or_create(uid)
        match: Optional[PrefixMatch] = None
        acquired: List[int] = []
        try:
            if token_ids is not None:
                match = self._match_prefix(seq, token_ids, max_suffix_rows,
                                           acquired)
                # a match already advanced seen_tokens to n_cached: the
                # room still needed is the non-cached remainder
                new_tokens = len(token_ids) - seq.seen_tokens
            need = seq.blocks_needed(new_tokens, self.block_size)
            if need:
                fresh = self.allocator.allocate(need)
                seq.blocks.extend(fresh)
                if match is not None:
                    match.fresh_blocks.extend(fresh)
        except RuntimeError:
            for b in reversed(acquired):
                self.allocator.free([b])
            seq.blocks = [b for b in seq.blocks if b not in acquired]
            if created:
                del self._seqs[uid]
            raise
        if token_ids is not None:
            return seq, match
        return seq

    def _match_prefix(self, seq: SequenceDescriptor, token_ids,
                      max_suffix_rows: Optional[int],
                      acquired: List[int]) -> PrefixMatch:
        """Walk + acquire the prefix chain for a new sequence; fills
        `acquired` so the caller can roll back on allocation failure."""
        n = len(token_ids)
        if self.enable_prefix_cache and not seq.blocks \
                and seq.seen_tokens == 0:
            seq.tokens = [int(t) for t in token_ids]
        if (not self.enable_prefix_cache or seq.blocks
                or seq.seen_tokens > 0 or n < 2):
            return PrefixMatch(0, [], [])
        chain = self._walk_chain(seq.tokens)
        n_cached = min(len(chain) * self.block_size, n - 1)
        if n_cached <= 0 or (max_suffix_rows is not None
                             and n - n_cached > max_suffix_rows):
            self.stats["lookup_misses"] += 1
            self.stats["prompt_tokens"] += n
            return PrefixMatch(0, [], [])
        cow: Optional[Tuple[int, int]] = None
        # acquire every matched block (pins them against eviction)
        for _, block in chain:
            self._acquire(block)
            acquired.append(block)
        if n_cached < len(chain) * self.block_size:
            # the cap cut into the last matched block: the tail is
            # shared AND will be written (the recomputed last token) —
            # copy-on-write it into a private block
            src = chain[-1][1]
            dst = self.allocator.allocate(1)[0]
            cow = (src, dst)
            blocks = [b for _, b in chain[:-1]] + [dst]
            # release the pin on src: it parks/stays shared untouched
            self.allocator.free([src])
            acquired.remove(src)
            acquired.append(dst)
            keys = [k for k, _ in chain[:-1]]
            reused = [b for _, b in chain[:-1]]
            self.stats["cow_copies"] += 1
        else:
            blocks = [b for _, b in chain]
            keys = [k for k, _ in chain]
            reused = list(blocks)
        seq.blocks = blocks
        seq.block_keys = keys
        seq.seen_tokens = n_cached  # cached KV is already committed
        seq.n_cached = n_cached
        self.stats["lookup_hits"] += 1
        self.stats["cached_tokens"] += n_cached
        self.stats["prompt_tokens"] += n
        return PrefixMatch(n_cached, reused, [], cow)

    def commit(self, uid: int, new_tokens: int, token_ids=None) -> None:
        """Bump seen_tokens after the forward wrote the KV; with
        token_ids (or a token record from admission) also registers
        newly-full blocks in the prefix index. Committing tokens the
        host never saw (fused-decode sampling) permanently stops index
        registration for the sequence — already-registered blocks stay
        valid (their contents are final)."""
        seq = self._seqs[uid]
        start = seq.seen_tokens
        seq.seen_tokens += new_tokens
        if not self.enable_prefix_cache or not seq.tokens_valid:
            return
        if token_ids is not None:
            for j, t in enumerate(token_ids):
                pos = start + j
                if pos == len(seq.tokens):
                    seq.tokens.append(int(t))
                elif pos > len(seq.tokens):
                    seq.tokens_valid = False
                    return
        if seq.seen_tokens > len(seq.tokens):
            seq.tokens_valid = False
            return
        self._register_full_blocks(seq)

    def flush(self, uid: int) -> None:
        """ref: ragged_manager.py flush_sequence:110 — release the
        blocks. Refcounted: shared blocks survive for their other
        owners; index-addressed blocks whose count hits zero park in
        the LRU pool for future prefix hits."""
        seq = self._seqs.pop(uid, None)
        if seq is None:
            raise KeyError(f"unknown sequence uid {uid}")
        self.allocator.free(seq.blocks)

    # -- device views ----------------------------------------------------
    def block_table(self, uids: List[int], max_blocks: int,
                    pad_block: int = 0) -> np.ndarray:
        """Dense [len(uids), max_blocks] int32 block table. Unused slots
        fill with pad_block — the engine passes its reserved scratch
        block so fused-kernel pad rows never touch a live block."""
        out = np.full((len(uids), max_blocks), pad_block, np.int32)
        for i, uid in enumerate(uids):
            blocks = self._seqs[uid].blocks
            if len(blocks) > max_blocks:
                raise ValueError(
                    f"uid {uid} has {len(blocks)} blocks > table width {max_blocks}"
                )
            out[i, : len(blocks)] = blocks
        return out
