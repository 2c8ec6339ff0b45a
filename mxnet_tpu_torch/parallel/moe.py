"""Mixture of experts: the dense programs and expert parallelism over the
``expert`` axis.

Counterpart of ``mxnet_tpu/parallel/moe.py``, with its names and
arithmetic:

* :func:`switch_ffn` (top-1, the Switch gate) and :func:`moe_ffn` (top-k,
  gates renormalized over the chosen k) route each token with dense
  dispatch and combine tensors ``[N, E, C]``; capacity accounting is
  rank-major (GShard): every token's rank-0 choice claims a slot before
  any rank-1 choice does, and a choice past its expert's capacity ``C =
  ceil(cf * k * N / E)`` is dropped;
* :func:`moe_ffn_ep` is the expert-parallel program: each member routes
  its own tokens, an all-to-all along the expert axis moves each
  expert's slots to the member that holds it, the member runs its
  experts, and the reverse all-to-all brings the results home;
* :func:`load_balance_loss` is Switch's auxiliary loss.

The routing bookkeeping runs in int64 (a count kept in bf16 stops at
256 and collides capacity slots).  ``jax.lax.top_k`` and ``jnp.argmax``
break ties toward the lowest index; here the top k are taken from a
stable descending sort and the top 1 from ``torch.argmax`` (the first
maximum), so ties break the same way on the CPU and on the card.

Inside a mesh member's step these functions take the member's meetings
(``sync=``, a :class:`~.members.NodeSync`): the dense programs then
route the global batch of the data group (the capacity from the global
token count, each member's arrival positions offset by the counts of
the members before it, per rank and expert) and :func:`load_balance_loss`
averages over every member's tokens; :func:`ep_member` is one member's
part of the expert-parallel program, meeting along the expert axis.
:func:`moe_ffn_ep` itself takes global tensors and a mesh of contexts,
as the JAX function takes global arrays and a mesh.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..base import MXNetError
from .mesh import DATA_AXIS, EXPERT_AXIS, NamedSharding, PartitionSpec
from .members import mesh_groups, run_synced

__all__ = ["switch_ffn", "moe_ffn", "moe_ffn_ep", "load_balance_loss",
           "ep_member"]


def _top1(probs):
    """``(gate, index)`` of each row's largest probability, ``[N, 1]``
    each, the first index among equal maxima."""
    return probs.amax(dim=-1, keepdim=True), \
        torch.argmax(probs, dim=-1, keepdim=True)


def _topk(probs, k: int):
    """``(values, indices)`` of each row's ``k`` largest probabilities in
    descending order, equal values in index order (``jax.lax.top_k``)."""
    idx = torch.sort(probs, dim=-1, descending=True, stable=True)[1][:, :k]
    return probs.gather(-1, idx), idx


def _route_base(onehot, sync):
    """The arrival position each rank's first claim of each expert takes,
    ``[k, E]``: the claims of every earlier rank, and under ``sync`` (the
    data group's global batch) those of the members before this one at
    the same rank; with the global token count.  ``onehot`` is ``[N, k,
    E]`` int64."""
    n = onehot.shape[0]
    counts = onehot.sum(dim=0)                                  # [k, E]
    if sync is None:
        return counts.cumsum(dim=0) - counts, n
    parts = sync.parts((n, counts), DATA_AXIS)
    me = sync.rank(DATA_AXIS)
    every = torch.stack([c.to(counts.device) for _, c in parts])
    total = every.sum(dim=0)
    before = every[:me].sum(dim=0)
    return total.cumsum(dim=0) - total + before, sum(m for m, _ in parts)


def _topk_dispatch(topi, gates, e: int, cap: int, dtype, base=None):
    """Rank-major (GShard) capacity accounting: every token's rank-0
    assignment claims a slot before any rank-1 assignment does.

    ``topi``: ``[N, k]`` expert ids; ``gates``: ``[N, k]`` gate weights;
    ``base``: ``[k, E]`` the position of each rank's first claim of each
    expert (default: this batch's earlier ranks' claims).  Returns
    ``(dispatch, combine)``, both ``[N, E, C]``."""
    onehot = F.one_hot(topi, e)                                 # [N, k, E]
    if base is None:
        base, _ = _route_base(onehot, None)
    within = onehot.cumsum(dim=0) * onehot - onehot
    pos = within + base.unsqueeze(0) * onehot
    keep = ((pos < cap) & (onehot > 0)).to(dtype)
    slots = torch.arange(cap, device=pos.device)
    slot = (pos.unsqueeze(-1) == slots).to(dtype)               # [N,k,E,C]
    disp_k = slot * keep.unsqueeze(-1)
    dispatch = disp_k.sum(dim=1)
    combine = (disp_k * gates.to(dtype)[..., None, None]).sum(dim=1)
    return dispatch, combine


def _experts(dispatch, combine, x, w1, b1, w2, b2):
    """The expert feed-forward over the dispatched slots and the
    combine back to the tokens: ``[N, D]``."""
    expert_in = torch.einsum("nec,nd->ecd", dispatch, x)        # [E, C, D]
    h = torch.relu(torch.einsum("ecd,edh->ech", expert_in, w1)
                   + b1[:, None])
    expert_out = torch.einsum("ech,ehd->ecd", h, w2) + b2[:, None]
    return torch.einsum("nec,ecd->nd", combine, expert_out)


def _dense(x, gate_w, w1, b1, w2, b2, k: int, capacity_factor: float,
           switch: bool, sync):
    e = gate_w.shape[1]
    k = 1 if switch else min(k, e)
    probs = torch.softmax(x @ gate_w, dim=-1)                   # [N, E]
    if switch:
        gates, topi = _top1(probs)
    else:
        topv, topi = _topk(probs, k)
        gates = topv / torch.clamp_min(topv.sum(dim=-1, keepdim=True), 1e-9)
    base, n = _route_base(F.one_hot(topi, e), sync)
    cap = max(1, math.ceil(capacity_factor * k * n / e))
    dispatch, combine = _topk_dispatch(topi, gates, e, cap, x.dtype, base)
    return _experts(dispatch, combine, x, w1, b1, w2, b2), probs


def moe_ffn(x, gate_w, w1, b1, w2, b2, k: int = 2,
            capacity_factor: float = 1.5, *, sync=None):
    """Top-k routed expert feed-forward (k = 2 is the GShard default).

    Each token goes to its top-k experts with gates renormalized over the
    chosen k; per-expert capacity ``C = ceil(cf * k * N / E)`` drops
    overflow assignments (the token keeps its surviving ones, or gets
    zero).  Shapes as :func:`switch_ffn`; returns ``(y, router_probs)``.
    ``sync``: a member's meetings, to route the data group's global
    batch."""
    return _dense(x, gate_w, w1, b1, w2, b2, k, capacity_factor, False,
                  sync)


def switch_ffn(x, gate_w, w1, b1, w2, b2, capacity_factor: float = 1.5,
               *, sync=None):
    """Top-1 routed expert feed-forward.

    ``x``: ``[N, D]`` tokens; ``gate_w``: ``[D, E]`` router weights;
    ``w1, b1``: ``[E, D, H], [E, H]``; ``w2, b2``: ``[E, H, D], [E, D]``.
    Per-expert capacity ``C = ceil(cf * N / E)``; an overflow token gets
    zero (Switch).  The output is scaled by the router probability.
    Returns ``(y, router_probs)``.  ``sync``: as in :func:`moe_ffn`."""
    return _dense(x, gate_w, w1, b1, w2, b2, 1, capacity_factor, True, sync)


def load_balance_loss(router_probs, num_experts: Optional[int] = None, *,
                      sync=None):
    """Switch's auxiliary loss, ``E * sum_e fraction_e * mean_prob_e``;
    under ``sync`` the means are over every member's tokens of the data
    group (the probabilities' sum meets differentiably)."""
    e = num_experts or router_probs.shape[-1]
    frac = F.one_hot(torch.argmax(router_probs, dim=-1),
                     e).to(router_probs.dtype)
    if sync is None:
        return e * torch.sum(frac.mean(dim=0) * router_probs.mean(dim=0))
    n = sync.host_sum(router_probs.shape[0], DATA_AXIS)
    frac = sync.allreduce(frac.sum(dim=0), DATA_AXIS) / n
    mean_prob = sync.allreduce(router_probs.sum(dim=0), DATA_AXIS) / n
    return e * torch.sum(frac * mean_prob)


def ep_member(x_l, gate_w, w1_l, b1_l, w2_l, b2_l, k: int,
              capacity_factor: float, sync, expert_axis: str = EXPERT_AXIS):
    """One member's part of the expert-parallel program: its tokens
    ``x_l`` routed with the capacity of its own count (``shard_map``'s
    semantics), the slots of each expert sent to the member that holds
    it and the results brought back, both by an all-to-all along
    ``expert_axis``; ``w1_l`` ... hold the member's ``E / ep`` experts.
    ``k = 1`` scales by the router probability (Switch); ``k > 1``
    renormalizes over the chosen k.  Returns ``(y_l, probs_l)``."""
    n_l = x_l.shape[0]
    e = gate_w.shape[1]
    kk = min(k, e)
    cap = max(1, math.ceil(capacity_factor * kk * n_l / e))
    probs = torch.softmax(x_l @ gate_w, dim=-1)
    topv, topi = _topk(probs, kk)
    gates = topv if kk == 1 else \
        topv / torch.clamp_min(topv.sum(dim=-1, keepdim=True), 1e-9)
    dispatch, combine = _topk_dispatch(topi, gates, e, cap, x_l.dtype)
    expert_in = torch.einsum("nec,nd->ecd", dispatch, x_l)     # [E, C, D]
    # every peer's slots for this member's experts, end to end along the
    # capacity dimension: [E / ep, ep * C, D]
    recv = sync.all_to_all(expert_in, 0, 1, expert_axis)
    h = torch.relu(torch.einsum("ecd,edh->ech", recv, w1_l)
                   + b1_l[:, None])
    out = torch.einsum("ech,ehd->ecd", h, w2_l) + b2_l[:, None]
    # each peer's tokens' results back to it: [E, C, D]
    back = sync.all_to_all(out, 1, 0, expert_axis)
    return torch.einsum("nec,ecd->nd", combine, back), probs


def moe_ffn_ep(x, gate_w, w1, b1, w2, b2, mesh, k: int = 2,
               capacity_factor: float = 1.5, expert_axis: str = EXPERT_AXIS,
               data_axis: str = DATA_AXIS):
    """Expert-parallel top-k MoE with an explicit token all-to-all.

    ``x`` (``[N, D]``, global) is cut over every member as ``P((data_axis,
    expert_axis), None)``: member ``(d, e)`` takes token block ``d * ep +
    e`` (``P(expert_axis, None)`` without a data axis); the expert
    weights are cut over ``expert_axis`` (``E / ep`` experts a member),
    the router replicated.  Each member runs :func:`ep_member` in its own
    thread; returns the global ``(y, router_probs)`` on ``x``'s device,
    differentiable into every input."""
    ep = mesh.shape[expert_axis]
    e = gate_w.shape[1]
    if e % ep:
        raise MXNetError(f"num_experts {e} not divisible by expert-axis "
                         f"size {ep}")
    tok_axes = tuple(a for a in (data_axis, expert_axis)
                     if a in mesh.axis_names)
    tok = NamedSharding(mesh, PartitionSpec(tok_axes, None))
    wsh = NamedSharding(mesh, PartitionSpec(expert_axis))
    devices = [m.torch_device for m in mesh.members]
    blocks = {}
    for i in range(mesh.size):
        blocks.setdefault(tok.index(i, x.shape)[0].start, i)

    def member(i, handle):
        dev = devices[i]
        x_l = x[tok.index(i, x.shape)].to(dev)
        pieces = [t[wsh.index(i, t.shape)].to(dev) for t in (w1, b1, w2, b2)]
        return ep_member(x_l, gate_w.to(dev), *pieces, k, capacity_factor,
                         handle.at("moe_ffn_ep"), expert_axis)

    outs = run_synced(member, devices, mesh_groups(mesh, [expert_axis]))
    order = [blocks[s] for s in sorted(blocks)]
    y = torch.cat([outs[i][0].to(x.device) for i in order])
    probs = torch.cat([outs[i][1].to(x.device) for i in order])
    return y, probs
