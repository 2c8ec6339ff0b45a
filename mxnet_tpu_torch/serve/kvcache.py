"""Paged KV cache for autoregressive serving.

Counterpart of ``mxnet_tpu/serve/kvcache.py``.  Key and value states live
in preallocated pools of fixed-size blocks
(``[num_layers, num_blocks, block_size, heads, head_dim]``); each request
owns a host-side block table mapping its logical block ``j`` to physical
slot ``table[j]``.

* :class:`BlockAllocator` — the host-side free-list allocator with
  reference counts and an LRU side-cache, and :class:`PrefixIndex`, the
  content-hashed prefix index: copies of the JAX package's classes (pure
  Python; the chain hashes are the same bytes).
* :func:`write_prefill` / :func:`write_decode` — scatter fresh K/V states
  into table-addressed slots.  The JAX package returns a new pool and
  donates the old one; here the pool is written in place with
  ``index_put_``, the PyTorch counterpart of that donated functional
  update.  Padded or inactive rows go to the reserved trash block 0.
* :func:`paged_attention` — one query token per request over its blocks:
  ``impl="scan"`` (the online-softmax block scan), ``"dense"`` (one
  gather, one masked softmax) or ``"flash"`` (the flash-decode kernel of
  :mod:`.flash_decode`); :func:`paged_prefill_attention` — causal
  attention of one prefill chunk over the request's cached prefix;
  :func:`paged_verify_attention` — causal attention of a speculative
  verify window (C positions per request) over each request's cache.
* :func:`write_spec` / :func:`scrub_positions` — the verify window's
  writes and the rollback of its rejected tail: the window's K/V is
  written before attention reads it, and rejected positions are zeroed
  in place (payload and scale) once acceptance has run.
* fp8 pools (:class:`QuantPool`): an e4m3 payload of 1 byte per element
  plus one f32 scale per cached position, quantized with
  :func:`~mxnet_tpu_torch.quant.rowwise_quantize`.  Every read path
  dequantizes to f32 at the gather (the flash-decode kernel in
  registers).  Payload bytes are written, gathered, zeroed and moved
  through a ``uint8`` view: a 1-byte move that needs no float8 support
  from the indexing ops.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import (Callable, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch

from ..base import MXNetError
from ..context import DeviceLike, resolve_device
from ..parallel.ring_attention import NEG_INF
from ..quant import FP8_DTYPES, rowwise_quantize

__all__ = ["TRASH_BLOCK", "KV_QUANT_FORMATS", "KV_FP8_FORMAT", "QuantPool",
           "BlockAllocator", "PrefixIndex", "make_pools", "is_quantized",
           "layer_view", "pool_nbytes", "kv_bytes_per_token",
           "paged_attention", "paged_prefill_attention",
           "paged_verify_attention", "dense_attention", "write_prefill",
           "write_decode", "write_spec", "scrub_positions", "scrub_blocks",
           "compact_pool"]

#: physical slot 0 is never handed out: padded prefill positions and
#: inactive decode rows scatter their garbage there, keeping every
#: device-side write unconditional.
TRASH_BLOCK = 0

#: quantized-pool storage formats ("fp8" = e4m3 payload + one f32 scale
#: per cached position)
KV_QUANT_FORMATS = ("fp8",)

#: the fp8 format of quantized pools: KV states are forward values, so
#: e4m3's mantissa beats e5m2's range
KV_FP8_FORMAT = "e4m3"


class QuantPool(NamedTuple):
    """A quantized KV pool: ``payload`` ``[num_layers, num_blocks,
    block_size, heads, head_dim]`` in ``float8_e4m3fn`` and ``scale``
    ``[num_layers, num_blocks, block_size]`` f32, one scale per cached
    position (one layer's view drops the leading axis of both).  Every
    pool-taking function here accepts a plain tensor or a ``QuantPool``."""
    payload: torch.Tensor
    scale: torch.Tensor


Pool = Union[torch.Tensor, QuantPool]


def is_quantized(pool) -> bool:
    return isinstance(pool, QuantPool)


def _leaves(pool: Pool) -> Tuple[torch.Tensor, ...]:
    """The pool's tensors, payload as ``uint8`` bytes: what moves,
    zeroes or relocates a pool acts on each leaf alike."""
    if is_quantized(pool):
        return pool.payload.view(torch.uint8), pool.scale
    return (pool,)


def layer_view(pool: Pool, layer: int) -> Pool:
    """One layer's slice of a pool (views): ``[num_blocks, BS, H, hd]``,
    or the matching ``QuantPool`` of ``(payload, scale[num_blocks, BS])``."""
    if is_quantized(pool):
        return QuantPool(pool.payload[layer], pool.scale[layer])
    return pool[layer]


def pool_nbytes(*pools: Pool) -> int:
    """Device bytes held by the given pools (payload and scales)."""
    return sum(t.numel() * t.element_size()
               for pool in pools for t in _leaves(pool))


def _check_quant(quant: Optional[str]) -> None:
    if quant is not None and quant not in KV_QUANT_FORMATS:
        raise MXNetError(f"unknown kv quant format {quant!r}, expected one "
                         f"of {KV_QUANT_FORMATS} or None")


def kv_bytes_per_token(num_layers: int, heads: int, head_dim: int,
                       quant: Optional[str] = None,
                       dtype: torch.dtype = torch.float32) -> int:
    """Device bytes one cached position occupies across both pools (K and
    V, all layers): what decode streams per token per request.  fp8 pools
    pay 1 byte per element plus one f32 scale per (layer, position,
    pool)."""
    _check_quant(quant)
    per_pos = heads * head_dim
    if quant is None:
        itemsize = torch.empty((), dtype=dtype).element_size()
        return 2 * num_layers * per_pos * itemsize
    return 2 * num_layers * (per_pos * 1 + 4)


# ---------------------------------------------------------------------------
# Host side: block allocator
# ---------------------------------------------------------------------------

class BlockAllocator:
    """Free-list allocator over the physical slots of a KV pool, with
    reference counting and an LRU side-cache of refcount-0 blocks.

    Slot ``TRASH_BLOCK`` (0) is reserved.  ``alloc`` hands out the
    lowest free slots (deterministic — replays identically),
    ``release`` drops one owner's reference, ``defrag`` compacts live
    slots toward the low end of the pool and returns the relocation map
    the engine applies with :func:`compact_pool`.

    A physical slot is in exactly one of three states:

    * **free** — on the free list, contents garbage.
    * **referenced** — held by one or more owners (``addref`` lets a
      second request map a slot another request already filled — the
      prefix cache's copy-on-write sharing; writes only ever target
      refcount-1 private blocks, so "copy" is structural: a diverging
      request allocates fresh blocks past the shared prefix).
    * **cached** — refcount dropped to zero but ``cache_filter`` kept
      the slot resident (its KV contents are indexed by content hash).
      Cached slots are *extra capacity, never pressure*: ``alloc``
      evicts the coldest cached slots (LRU) before failing, and
      ``num_available``/``can_alloc`` count them as allocatable, so
      caching never causes an admission reject or preemption that
      would not have happened anyway.

    ``cache_filter(block) -> bool`` and ``on_evict(block)`` are
    settable attributes (not ctor args) so the engine can wire the
    allocator and :class:`PrefixIndex` together after both exist.
    """

    def __init__(self, num_blocks: int, block_size: int,
                 cache_cap: Optional[int] = None):
        if num_blocks < 2:
            raise MXNetError("BlockAllocator needs >= 2 blocks "
                             "(slot 0 is the reserved trash block)")
        if block_size < 1:
            raise MXNetError(f"block_size must be >= 1, got {block_size}")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self._free: List[int] = list(range(1, num_blocks))
        self._refs: Dict[int, set] = {}        # phys slot -> owner set
        self._cached: "OrderedDict[int, None]" = OrderedDict()  # LRU order
        self.cache_cap = cache_cap             # max cached slots (None = all)
        self.cache_filter: Optional[Callable[[int], bool]] = None
        self.on_evict: Optional[Callable[[int], None]] = None

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_used(self) -> int:
        return len(self._refs)

    @property
    def num_cached(self) -> int:
        return len(self._cached)

    @property
    def num_available(self) -> int:
        """Slots allocatable right now: free plus evictable cached."""
        return len(self._free) + len(self._cached)

    def blocks_for_tokens(self, ntokens: int) -> int:
        """Blocks needed to hold ``ntokens`` cache entries."""
        return max(1, -(-int(ntokens) // self.block_size))

    def can_alloc(self, nblocks: int) -> bool:
        return nblocks <= self.num_available

    def _evict_one(self) -> None:
        block, _ = self._cached.popitem(last=False)   # coldest first
        if self.on_evict is not None:
            self.on_evict(block)
        self._free.append(block)

    def alloc(self, nblocks: int, owner) -> List[int]:
        if nblocks > self.num_available:
            raise MXNetError(
                f"kv pool exhausted: want {nblocks} blocks, "
                f"{len(self._free)} free + {len(self._cached)} cached "
                f"of {self.num_blocks - 1}")
        while nblocks > len(self._free):
            self._evict_one()
        self._free.sort()
        got, self._free = self._free[:nblocks], self._free[nblocks:]
        for b in got:
            self._refs[b] = {owner}
        return got

    def addref(self, block: int, owner) -> None:
        """Map an already-resident slot into another owner's table —
        promotes a cached slot back to referenced, or adds an owner to
        a shared referenced slot.  Free slots cannot be addref'd."""
        if block in self._cached:
            del self._cached[block]
            self._refs[block] = {owner}
            return
        refs = self._refs.get(block)
        if refs is None:
            raise MXNetError(f"addref of free kv block {block}")
        if owner in refs:
            raise MXNetError(f"owner {owner!r} already references "
                             f"kv block {block}")
        refs.add(owner)

    def refcount(self, block: int) -> int:
        return len(self._refs.get(block, ()))

    def release(self, blocks: Sequence[int], owner) -> None:
        """Drop ``owner``'s reference on each slot.  A slot whose last
        reference drops either parks in the LRU cache (``cache_filter``
        says its contents are worth keeping) or returns to the free
        list."""
        for b in blocks:
            refs = self._refs.get(b)
            if refs is None or owner not in refs:
                raise MXNetError(
                    f"release of kv block {b} not held by {owner!r}")
            refs.discard(owner)
            if refs:
                continue
            del self._refs[b]
            if self.cache_filter is not None and self.cache_filter(b):
                self._cached[b] = None          # MRU end
                if self.cache_cap is not None:
                    while len(self._cached) > self.cache_cap:
                        self._evict_one()
            else:
                self._free.append(b)

    def uncache(self, blocks: Sequence[int]) -> None:
        """Return cached slots straight to the free list *without* the
        ``on_evict`` callback — the invalidation path, where the index
        has already dropped them.  Unknown slots are ignored."""
        for b in blocks:
            if b in self._cached:
                del self._cached[b]
                self._free.append(b)

    def free(self, blocks: Sequence[int]) -> None:
        """Force-drop slots back to the free list regardless of
        refcount (legacy single-owner path; callers must not share).
        Cached slots are evicted through ``on_evict`` first."""
        for b in blocks:
            if b in self._refs:
                del self._refs[b]
                self._free.append(b)
            elif b in self._cached:
                del self._cached[b]
                if self.on_evict is not None:
                    self.on_evict(b)
                self._free.append(b)
            else:
                raise MXNetError(f"double free of kv block {b}")

    def owned_by(self, owner) -> List[int]:
        return sorted(b for b, refs in self._refs.items() if owner in refs)

    def check(self, tables: Dict[object, Sequence[int]]) -> None:
        """Table-integrity audit: every table entry is a referenced
        slot held by that mapper, a slot in several tables is legal iff
        *each* mapper holds a reference (prefix sharing), cached and
        free slots appear in no table, and every (slot, owner)
        reference appears in that owner's table."""
        seen: Dict[int, List[object]] = {}
        free = set(self._free)
        for owner, table in tables.items():
            for b in table:
                if b == TRASH_BLOCK:
                    raise MXNetError(f"{owner!r}: table points at the "
                                     "trash block")
                if b in free:
                    raise MXNetError(f"block {b} both free and mapped")
                if b in self._cached:
                    raise MXNetError(f"block {b} both cached (ref-0) "
                                     f"and mapped by {owner!r}")
                refs = self._refs.get(b, ())
                if owner not in refs:
                    raise MXNetError(f"{owner!r}: block {b} not owned "
                                     f"(holders={sorted(map(repr, refs))})")
                seen.setdefault(b, []).append(owner)
        leaked = sorted(
            (b, o) for b, refs in self._refs.items() for o in refs
            if o not in seen.get(b, ()))
        if leaked:
            raise MXNetError(f"leaked blocks (owned, not in any table): "
                             f"{leaked}")

    def defrag(self) -> Dict[int, int]:
        """Compact live slots (referenced *and* cached — cached blocks
        hold reusable KV) to the lowest physical indices.  Returns
        ``{old_slot: new_slot}`` for every *moved* slot; the caller must
        rewrite its tables, remap the prefix index, and apply
        :func:`compact_pool` with the same map before the next device
        step.  LRU order of cached slots is preserved."""
        live = sorted(set(self._refs) | set(self._cached))
        mapping: Dict[int, int] = {}
        target = 1
        for b in live:
            if b != target:
                mapping[b] = target
            target += 1
        if mapping:
            self._refs = {mapping.get(b, b): o
                          for b, o in self._refs.items()}
            self._cached = OrderedDict(
                (mapping.get(b, b), None) for b in self._cached)
            self._free = list(range(1 + len(live), self.num_blocks))
        return mapping


# ---------------------------------------------------------------------------
# Host side: content-hashed prefix index
# ---------------------------------------------------------------------------

class PrefixIndex:
    """Content hash -> physical slot map for cross-request KV reuse.

    Each *full* block of a token sequence gets a rolling chain hash:
    ``h_j = blake2b(h_{j-1} | weights_version | tokens_of_block_j)``, the
    tokens as little-endian int64 bytes (the JAX package's digests, byte
    for byte).  Chaining makes the hash position- and prefix-dependent,
    and folding the weights version in means ``invalidate`` makes every
    stale entry unreachable at once.

    The index stores only the hash -> slot map; residency and reference
    counts live in :class:`BlockAllocator` (``cache_filter=
    index.contains_block`` keeps indexed blocks resident at refcount 0,
    ``on_evict=index.drop_block`` unpublishes them when LRU pressure
    reclaims the slot).  Partial (tail) blocks are never published: only
    full, prefill-written blocks are content-addressable, which is what
    makes sharing copy-on-write-safe — every later write lands past the
    last full prefix block.
    """

    def __init__(self, block_size: int):
        if block_size < 1:
            raise MXNetError(f"block_size must be >= 1, got {block_size}")
        self.block_size = int(block_size)
        self.version = 0
        self._entries: Dict[bytes, int] = {}      # chain hash -> phys slot
        self._block_hash: Dict[int, bytes] = {}   # phys slot -> chain hash

    def __len__(self) -> int:
        return len(self._entries)

    def chain_hashes(self, tokens: Sequence[int]) -> List[bytes]:
        """Rolling chain hash of every *full* block of ``tokens``
        (``len(tokens) // block_size`` digests; the tail is never
        hashed)."""
        bs = self.block_size
        ver = self.version.to_bytes(8, "little")
        out: List[bytes] = []
        prev = b"\x00" * 16
        for j in range(len(tokens) // bs):
            blk = np.asarray(tokens[j * bs:(j + 1) * bs], "<i8").tobytes()
            prev = hashlib.blake2b(prev + ver + blk,
                                   digest_size=16).digest()
            out.append(prev)
        return out

    def match(self, tokens: Sequence[int]) -> List[int]:
        """Longest indexed prefix: physical slots for the leading run of
        full blocks whose chain hashes are all present (stops at the
        first miss)."""
        blocks: List[int] = []
        for h in self.chain_hashes(tokens):
            b = self._entries.get(h)
            if b is None:
                break
            blocks.append(b)
        return blocks

    def publish(self, h: bytes, block: int) -> bool:
        """Register ``block`` as the holder of chain hash ``h``.  First
        publisher wins: a duplicate leaves the existing entry and the
        late block stays private.  Returns whether it was inserted."""
        if h in self._entries or block in self._block_hash:
            return False
        self._entries[h] = block
        self._block_hash[block] = h
        return True

    def contains_block(self, block: int) -> bool:
        return block in self._block_hash

    def drop_block(self, block: int) -> None:
        """Unpublish one slot (LRU eviction / force-free); a no-op for
        unindexed slots."""
        h = self._block_hash.pop(block, None)
        if h is not None:
            self._entries.pop(h, None)

    def invalidate(self) -> List[int]:
        """Drop every entry and bump the weights version.  Returns the
        slots that were indexed, for the caller to ``uncache``."""
        dropped = sorted(self._block_hash)
        self.version += 1
        self._entries.clear()
        self._block_hash.clear()
        return dropped

    def remap(self, mapping: Dict[int, int]) -> None:
        """Apply a :meth:`BlockAllocator.defrag` relocation map."""
        if not mapping:
            return
        self._entries = {h: mapping.get(b, b)
                         for h, b in self._entries.items()}
        self._block_hash = {mapping.get(b, b): h
                            for b, h in self._block_hash.items()}


# ---------------------------------------------------------------------------
# Device side: pools + paged reads/writes
# ---------------------------------------------------------------------------

def make_pools(num_layers: int, num_blocks: int, block_size: int,
               heads: int, head_dim: int, dtype: torch.dtype = torch.float32,
               quant: Optional[str] = None, device: DeviceLike = None
               ) -> Tuple[Pool, Pool]:
    """Preallocate the K and V pools, zeroed:
    ``[num_layers, num_blocks, block_size, heads, head_dim]``.
    ``quant="fp8"`` returns :class:`QuantPool` pairs (e4m3 payload plus
    per-position f32 scales) instead."""
    _check_quant(quant)
    shape = (num_layers, num_blocks, block_size, heads, head_dim)
    dev = resolve_device(device)
    if quant is None:
        return (torch.zeros(shape, dtype=dtype, device=dev),
                torch.zeros(shape, dtype=dtype, device=dev))

    def one():
        # zero bytes are +0.0 in e4m3
        return QuantPool(
            torch.zeros(shape, dtype=torch.uint8, device=dev).view(
                FP8_DTYPES[KV_FP8_FORMAT]),
            torch.zeros(shape[:3], dtype=torch.float32, device=dev))

    return one(), one()


def _block_size_of(pool: Pool) -> int:
    return (pool.payload if is_quantized(pool) else pool).shape[-3]


def _gather_blocks(pool: Pool, idx):
    """Gather one layer's physical blocks by slot index, dequantizing fp8
    payloads to f32 against their per-position scales (payload widened to
    f32, then multiplied by the scale).  The result is
    ``idx.shape + [BS, H, hd]``."""
    idx = idx.long()
    if is_quantized(pool):
        q = pool.payload.view(torch.uint8)[idx].view(pool.payload.dtype)
        return q.float() * pool.scale[idx][..., None, None]
    return pool[idx]


def _attend_blocks(q, read_block, nblk: int, block_size: int, lengths,
                   scale):
    """Online-softmax block scan, one query token per row: running max,
    sum and accumulator in f32, ``NEG_INF`` masking by length."""
    b, h, d = q.shape
    dev = q.device
    m = torch.full((b, h), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h, d), dtype=torch.float32, device=dev)
    offs = torch.arange(block_size, device=dev)
    for j in range(nblk):
        k_blk, v_blk = read_block(j)
        s = _einsum("bhd,bkhd->bhk", q, k_blk).float() * scale
        valid = (j * block_size + offs)[None, :] < lengths[:, None]
        s = s.masked_fill(~valid[:, None, :], NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        p = p.masked_fill(~valid[:, None, :], 0.0)
        l = l * alpha + p.sum(dim=-1)
        acc = (acc * alpha[..., None]
               + torch.einsum("bhk,bkhd->bhd", p, v_blk.float()))
        m = m_new
    l = torch.clamp_min(l, 1e-30)
    return (acc / l[..., None]).to(q.dtype)


def _einsum(spec, a, b):
    """``einsum`` with JAX's type promotion of its two operands (a bf16
    query against a dequantized f32 cache computes in f32)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(spec, a.to(dt), b.to(dt))


def paged_attention(q, k_pool, v_pool, tables, lengths, *,
                    scale: Optional[float] = None, impl: str = "scan"):
    """One-token-per-request attention over a paged cache.

    ``q``: [B, H, hd]; ``k_pool``/``v_pool``: one layer's pool
    [num_blocks, BS, H, hd], plain or :class:`QuantPool`; ``tables``:
    [B, max_blocks] int32 physical slot per logical block; ``lengths``:
    [B] int32 valid entries (the current token included, already
    written).  Returns [B, H, hd].  ``impl`` is ``"scan"``, ``"dense"``
    or ``"flash"``.
    """
    b, h, d = q.shape
    nblk = tables.shape[1]
    bs = _block_size_of(k_pool)
    scale_ = (1.0 / np.sqrt(d)) if scale is None else scale

    if impl == "flash":
        from .flash_decode import flash_decode_attention
        return flash_decode_attention(q, k_pool, v_pool, tables, lengths,
                                      scale=scale_)

    if impl == "dense":
        k = _gather_blocks(k_pool, tables).reshape(b, nblk * bs, h, d)
        v = _gather_blocks(v_pool, tables).reshape(b, nblk * bs, h, d)
        s = _einsum("bhd,blhd->bhl", q, k).float() * scale_
        valid = (torch.arange(nblk * bs, device=q.device)[None, :]
                 < lengths[:, None])
        s = s.masked_fill(~valid[:, None, :], NEG_INF)
        m = s.amax(dim=-1)
        p = torch.exp(s - m[..., None]).masked_fill(~valid[:, None, :], 0.0)
        l = torch.clamp_min(p.sum(dim=-1), 1e-30)
        out = torch.einsum("bhl,blhd->bhd", p, v.float())
        return (out / l[..., None]).to(q.dtype)

    if impl != "scan":
        raise MXNetError(f"paged_attention: unknown impl {impl!r}, expected "
                         "'scan', 'dense' or 'flash'")

    def read_block(j):
        slot = tables[:, j]
        return _gather_blocks(k_pool, slot), _gather_blocks(v_pool, slot)

    return _attend_blocks(q, read_block, nblk, bs, lengths, scale_)


def paged_prefill_attention(q, k_pool, v_pool, table_row, start, length, *,
                            scale: Optional[float] = None):
    """Causal attention for one prefill chunk over a paged cache.

    ``q``: [C, H, hd], the chunk's query states at absolute positions
    ``start .. start+C-1``; ``table_row``: [max_blocks] int32, one
    request's block table; ``length``: total valid cache entries (the
    chunk's own K/V already written, so chunk position ``p`` attends to
    every cached position ``<= start+p``).  Returns [C, H, hd].

    Materialises the [C, L_max] scores (L_max = table capacity x block
    size: one request's cache), dequantizing fp8 pools at the gather.
    Padded chunk positions (``start+p >= length``) give garbage rows; the
    engine samples only the row of the prompt's last token.
    """
    c, h, d = q.shape
    nblk = table_row.shape[0]
    bs = _block_size_of(k_pool)
    scale_ = (1.0 / np.sqrt(d)) if scale is None else scale
    k = _gather_blocks(k_pool, table_row).reshape(nblk * bs, h, d)
    v = _gather_blocks(v_pool, table_row).reshape(nblk * bs, h, d)
    s = _einsum("chd,lhd->chl", q, k).float() * scale_
    pos = torch.arange(nblk * bs, device=q.device)
    qpos = start + torch.arange(c, device=q.device)
    valid = (pos[None, :] <= qpos[:, None]) & (pos[None, :] < length)
    s = s.masked_fill(~valid[:, None, :], NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None]).masked_fill(~valid[:, None, :], 0.0)
    l = torch.clamp_min(p.sum(dim=-1), 1e-30)
    out = torch.einsum("chl,lhd->chd", p, v.float())
    return (out / l[..., None]).to(q.dtype)


def paged_verify_attention(q, k_pool, v_pool, tables, lengths, *,
                           scale: Optional[float] = None):
    """Causal attention for one speculative verify step: C query
    positions per request over a paged cache.

    ``q``: [B, C, H, hd], query states at absolute positions
    ``lengths[b] .. lengths[b]+C-1`` (window position 0 is the request's
    current last token, 1..C-1 the drafted continuation); ``tables``:
    [B, max_blocks]; ``lengths``: [B] cache entries valid before this
    step.  The window's own K/V must already be written, so window
    position ``c`` attends to every cached position ``<= lengths+c``.
    Returns [B, C, H, hd].

    One gather and one masked softmax over the [B, C, L_max] scores (the
    ``"dense"`` decode strategy; C is K+1, small), dequantizing fp8 pools
    at the gather.
    """
    b, c, h, d = q.shape
    nblk = tables.shape[1]
    bs = _block_size_of(k_pool)
    scale_ = (1.0 / np.sqrt(d)) if scale is None else scale
    k = _gather_blocks(k_pool, tables).reshape(b, nblk * bs, h, d)
    v = _gather_blocks(v_pool, tables).reshape(b, nblk * bs, h, d)
    s = _einsum("bchd,blhd->bchl", q, k).float() * scale_
    pos = torch.arange(nblk * bs, device=q.device)
    qpos = lengths[:, None] + torch.arange(c, device=q.device)[None, :]
    valid = (pos[None, None, :] <= qpos[:, :, None])[:, :, None, :]
    s = s.masked_fill(~valid, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None]).masked_fill(~valid, 0.0)
    l = torch.clamp_min(p.sum(dim=-1), 1e-30)
    out = torch.einsum("bchl,blhd->bchd", p, v.float())
    return (out / l[..., None]).to(q.dtype)


def dense_attention(q, k_buf, v_buf, lengths, *, block_size: int,
                    scale: Optional[float] = None):
    """The contiguous-cache counterpart: the same block scan over
    per-request buffers ``[B, L_pad, H, hd]`` (``L_pad`` a multiple of
    ``block_size``)."""
    b, lpad, h, d = k_buf.shape
    if lpad % block_size:
        raise MXNetError(f"dense cache length {lpad} not a multiple of "
                         f"block {block_size}")
    nblk = lpad // block_size
    scale_ = (1.0 / np.sqrt(d)) if scale is None else scale
    kb = k_buf.reshape(b, nblk, block_size, h, d)
    vb = v_buf.reshape(b, nblk, block_size, h, d)

    def read_block(j):
        return kb[:, j], vb[:, j]

    return _attend_blocks(q, read_block, nblk, block_size, lengths, scale_)


def _scatter(pool: Pool, layer: int, index, states) -> None:
    """Write ``states`` (rows of [H, hd]) at ``pool[layer][index]`` in
    place; a :class:`QuantPool` quantizes each row (fp8 payload and f32
    scale) and scatters both with the same indices."""
    if is_quantized(pool):
        q, s = rowwise_quantize(states.reshape((-1,) + states.shape[-2:]),
                                KV_FP8_FORMAT)
        pool.payload.view(torch.uint8)[layer].index_put_(
            index, q.view(torch.uint8).reshape(states.shape))
        pool.scale[layer].index_put_(index, s.reshape(states.shape[:-2]))
    else:
        pool[layer].index_put_(index, states.to(pool.dtype))


def write_prefill(pool, layer: int, states, table_row, length, start=0):
    """Scatter a prompt's (or prompt chunk's) K or V states into its
    table's slots, in place.

    ``pool``: [layers, nblocks, BS, H, hd], plain or :class:`QuantPool`;
    ``states``: [L_pad, H, hd] (bucket- or chunk-padded); ``table_row``:
    [max_blocks] int32; ``length``: valid positions; ``start``: absolute
    position of ``states[0]``.  Positions ``>= length`` land in the trash
    block.  Returns ``pool``.
    """
    lpad = states.shape[0]
    bs = _block_size_of(pool)
    dev = table_row.device
    pos = start + torch.arange(lpad, device=dev)
    # a bucket may be longer than the table covers; those positions are
    # >= length anyway
    logical = torch.clamp_max(pos // bs, table_row.shape[0] - 1)
    slot = torch.where(pos < length, table_row.long()[logical],
                       TRASH_BLOCK)
    _scatter(pool, layer, (slot, pos % bs), states)
    return pool


def write_decode(pool, layer: int, states, slots, offsets, active):
    """Scatter one decode step's K or V states, one position per row, in
    place.  ``states``: [B, H, hd]; ``slots``/``offsets``: [B] physical
    block and in-block position; ``active``: [B] bool — inactive rows
    write to the trash block.  Returns ``pool``."""
    slot = torch.where(active, slots.long(), TRASH_BLOCK)
    _scatter(pool, layer, (slot, offsets.long()), states)
    return pool


def write_spec(pool, layer: int, states, slots, offsets):
    """Scatter one speculative verify window's K or V states, C positions
    per row, in place.  ``states``: [B, C, H, hd]; ``slots``/``offsets``:
    [B, C] physical block and in-block position of each window entry.
    The caller points dead entries (inactive rows, positions past a row's
    live drafts) at the trash block.  A :class:`QuantPool` quantizes the
    window flattened to [B*C, H, hd], one position a row, so a position's
    fp8 payload and scale are the bytes :func:`write_decode` would write
    for the same states.  Returns ``pool``."""
    _scatter(pool, layer, (slots.long(), offsets.long()), states)
    return pool


def scrub_positions(pool, slots, offsets):
    """Zero single cache positions, payload and scale, across every layer,
    in place: the rollback of a speculative step's rejected tail.
    ``slots``/``offsets``: [B, C]; entries to keep point at the trash
    block.  Until the next append overwrites them, masked attention lanes
    still read rolled-back positions (multiplied by zero), so they must
    hold no stale state.  Returns ``pool``."""
    index = (slots.long(), offsets.long())
    for t in _leaves(pool):
        t[(slice(None),) + index] = 0
    return pool


def scrub_blocks(pool, blocks):
    """Zero the given physical blocks (payload and scales) across every
    layer, in place.  The engine calls it when a request's cached K/V may
    be non-finite: attention masks invalid lanes by multiplying by zero,
    and ``0 * NaN`` is NaN, so blocks must return to the pool finite."""
    if blocks:
        leaves = _leaves(pool)
        idx = torch.as_tensor(sorted(set(int(b) for b in blocks)),
                              dtype=torch.long, device=leaves[0].device)
        for t in leaves:
            t[:, idx] = 0
    return pool


def compact_pool(pool, mapping: Dict[int, int]):
    """Apply a :meth:`BlockAllocator.defrag` relocation map in place:
    copy each moved slot's contents (payload and scales alike) to its new
    physical index.  Values are moved, never transformed, so attention
    after a defrag is bitwise unchanged.  The sources are gathered before
    any destination is written."""
    if mapping:
        leaves = _leaves(pool)
        src = sorted(mapping)
        dev = leaves[0].device
        src_t = torch.as_tensor(src, dtype=torch.long, device=dev)
        dst_t = torch.as_tensor([mapping[s] for s in src], dtype=torch.long,
                                device=dev)
        for t in leaves:
            t[:, dst_t] = t[:, src_t]
    return pool
