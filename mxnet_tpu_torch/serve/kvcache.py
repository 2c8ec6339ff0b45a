"""Paged KV cache for autoregressive serving.

Counterpart of ``mxnet_tpu/serve/kvcache.py``.  Key and value states live
in preallocated pools of fixed-size blocks
(``[num_layers, num_blocks, block_size, heads, head_dim]``); each request
owns a host-side block table mapping its logical block ``j`` to physical
slot ``table[j]``.

* :class:`BlockAllocator` — the host-side free-list allocator, a copy of
  the JAX package's class (pure Python).
* :func:`write_prefill` / :func:`write_decode` — scatter fresh K/V states
  into table-addressed slots.  The JAX package returns a new pool and
  donates the old one; here the pool is written in place with
  ``index_put_``, the PyTorch counterpart of that donated functional
  update.  Padded or inactive rows go to the reserved trash block 0.
* :func:`paged_attention` — one query token per request over its blocks:
  ``impl="scan"`` (the online-softmax block scan), ``"dense"`` (one
  gather, one masked softmax) or ``"flash"`` (the flash-decode kernel of
  :mod:`.flash_decode`).

fp8 pools (``QuantPool``) are not ported yet.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..base import MXNetError, not_ported
from ..context import DeviceLike, resolve_device
from ..parallel.ring_attention import NEG_INF

__all__ = ["TRASH_BLOCK", "QuantPool", "BlockAllocator", "make_pools",
           "layer_view", "kv_bytes_per_token", "paged_attention",
           "dense_attention", "write_prefill", "write_decode",
           "scrub_blocks"]

#: physical slot 0 is never handed out: padded prefill positions and
#: inactive decode rows scatter their garbage there, keeping every
#: device-side write unconditional.
TRASH_BLOCK = 0


class QuantPool:
    """fp8-e4m3 KV pool of the JAX package: not ported yet."""

    def __init__(self, *args, **kwargs):
        raise not_ported("QuantPool (fp8 KV cache)")


def layer_view(pool: torch.Tensor, layer: int) -> torch.Tensor:
    """One layer's slice of a pool: ``[num_blocks, BS, H, hd]`` (a view)."""
    return pool[layer]


def kv_bytes_per_token(num_layers: int, heads: int, head_dim: int,
                       quant: Optional[str] = None,
                       dtype: torch.dtype = torch.float32) -> int:
    """Device bytes one cached position occupies across both pools (K and
    V, all layers): what decode streams per token per request."""
    if quant is not None:
        raise not_ported(f"kv quant {quant!r}")
    itemsize = torch.empty((), dtype=dtype).element_size()
    return 2 * num_layers * heads * head_dim * itemsize


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
# Device side: pools + paged reads/writes
# ---------------------------------------------------------------------------

def make_pools(num_layers: int, num_blocks: int, block_size: int,
               heads: int, head_dim: int, dtype: torch.dtype = torch.float32,
               quant: Optional[str] = None, device: DeviceLike = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Preallocate the K and V pools, zeroed:
    ``[num_layers, num_blocks, block_size, heads, head_dim]``."""
    if quant is not None:
        raise not_ported(f"kv quant {quant!r}")
    shape = (num_layers, num_blocks, block_size, heads, head_dim)
    dev = resolve_device(device)
    return (torch.zeros(shape, dtype=dtype, device=dev),
            torch.zeros(shape, dtype=dtype, device=dev))


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
        s = torch.einsum("bhd,bkhd->bhk", q, k_blk).float() * scale
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


def paged_attention(q, k_pool, v_pool, tables, lengths, *,
                    scale: Optional[float] = None, impl: str = "scan"):
    """One-token-per-request attention over a paged cache.

    ``q``: [B, H, hd]; ``k_pool``/``v_pool``: one layer's
    [num_blocks, BS, H, hd] pool; ``tables``: [B, max_blocks] int32
    physical slot per logical block; ``lengths``: [B] int32 valid entries
    (the current token included, already written).  Returns [B, H, hd].
    ``impl`` is ``"scan"``, ``"dense"`` or ``"flash"``.
    """
    b, h, d = q.shape
    nblk = tables.shape[1]
    bs = k_pool.shape[-3]
    scale_ = (1.0 / np.sqrt(d)) if scale is None else scale

    if impl == "flash":
        from .flash_decode import flash_decode_attention
        return flash_decode_attention(q, k_pool, v_pool, tables, lengths,
                                      scale=scale_)

    if impl == "dense":
        idx = tables.long()
        k = k_pool[idx].reshape(b, nblk * bs, h, d)
        v = v_pool[idx].reshape(b, nblk * bs, h, d)
        s = torch.einsum("bhd,blhd->bhl", q, k).float() * scale_
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
        slot = tables[:, j].long()
        return k_pool[slot], v_pool[slot]

    return _attend_blocks(q, read_block, nblk, bs, lengths, scale_)


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


def write_prefill(pool, layer: int, states, table_row, length, start=0):
    """Scatter a prompt's K or V states into its table's slots, in place.

    ``pool``: [layers, nblocks, BS, H, hd]; ``states``: [L_pad, H, hd]
    (bucket-padded); ``table_row``: [max_blocks] int32; ``length``: valid
    positions; ``start``: absolute position of ``states[0]``.  Positions
    ``>= length`` land in the trash block.  Returns ``pool``.
    """
    lpad = states.shape[0]
    bs = pool.shape[-3]
    pos = start + torch.arange(lpad, device=pool.device)
    # a bucket may be longer than the table covers; those positions are
    # >= length anyway
    logical = torch.clamp_max(pos // bs, table_row.shape[0] - 1)
    slot = torch.where(pos < length, table_row.long()[logical],
                       TRASH_BLOCK)
    pool[layer].index_put_((slot, pos % bs), states.to(pool.dtype))
    return pool


def write_decode(pool, layer: int, states, slots, offsets, active):
    """Scatter one decode step's K or V states, one position per row, in
    place.  ``states``: [B, H, hd]; ``slots``/``offsets``: [B] physical
    block and in-block position; ``active``: [B] bool — inactive rows
    write to the trash block.  Returns ``pool``."""
    slot = torch.where(active, slots.long(), TRASH_BLOCK)
    pool[layer].index_put_((slot, offsets.long()), states.to(pool.dtype))
    return pool


def scrub_blocks(pool, blocks):
    """Zero the given physical blocks across every layer, in place.  The
    engine calls it when a request's cached K/V may be non-finite:
    attention masks invalid lanes by multiplying by zero, and
    ``0 * NaN`` is NaN, so blocks must return to the pool finite."""
    if blocks:
        idx = torch.as_tensor(sorted(set(int(b) for b in blocks)),
                              dtype=torch.long, device=pool.device)
        pool[:, idx] = 0
    return pool
