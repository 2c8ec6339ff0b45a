"""Online post-training harness: the train half of the train->serve
loop.

Counterpart of ``mxnet_tpu/online/loop.py``.  One :class:`OnlineLoop`
round drives four subsystems as one live system:

1. **rollout** -- the serving fleet (:class:`~mxnet_tpu_torch.serve.
   router.Router`) generates completions for a batch of prompts under
   seeded sampling (keys are (seed, position)-pure, so every rollout
   replays exactly);
2. **select + batch** -- rollouts become a fixed-shape training batch with
   a weighted-NLL objective: an optional ``reward_fn`` scores each
   completion and only the top-``keep_frac`` sequences carry loss
   (weights in {0, 1} applied through the symbol's ``ignore_label``
   mask; prompt and padding positions are always masked);
3. **train** -- a :class:`~mxnet_tpu_torch.parallel.trainer.
   ShardedTrainer` bound with the weights the fleet serves
   (:func:`make_rollout_trainer`) takes ``train_steps`` steps;
4. **publish** -- the updated weights go through a
   :class:`~mxnet_tpu_torch.checkpoint.CheckpointManager` with a compat
   stamp in the manifest meta, then onto the live fleet through the
   compat gate and ``Router.rolling_swap`` from the checkpoint path.

Telemetry: ``online.rounds`` / ``online.rollout_tokens`` counters, the
``online.weights_step`` gauge and ``online.rollout`` / ``online.train``
/ ``online.publish`` spans, beside the swap's own ``online.swaps`` /
``online.rebuilds`` / ``online.swap_ms``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from .. import telemetry
from ..base import MXNetError
from ..serve.engine import _env_int
from .compat import compat_stamp

__all__ = ["OnlineConfig", "OnlineLoop", "make_rollout_trainer"]

IGNORE = -1   # the label value transformer_lm(ignore_label=...) masks


@dataclass(frozen=True)
class OnlineConfig:
    """Loop policy.  Engine/router geometry lives in their own
    configs; this is purely the rollout→train→publish cadence."""
    rounds: int = 1            # rollout→train→publish iterations
    rollouts: int = 8          # requests generated per round
    max_new_tokens: int = 16   # completion budget per rollout
    train_steps: int = 4       # trainer steps per round's batch
    temperature: float = 0.8   # rollout sampling temperature
    top_k: int = 0
    keep_frac: float = 0.5     # reward-ranked fraction that keeps loss

    @classmethod
    def from_env(cls, **overrides) -> "OnlineConfig":
        """Environment defaults (``MXNET_TPU_ONLINE_ROUNDS``,
        ``_ROLLOUTS``, ``_MAX_NEW``, ``_TRAIN_STEPS``); explicit kwargs
        win."""
        env = dict(
            rounds=_env_int("MXNET_TPU_ONLINE_ROUNDS", 1),
            rollouts=_env_int("MXNET_TPU_ONLINE_ROLLOUTS", 8),
            max_new_tokens=_env_int("MXNET_TPU_ONLINE_MAX_NEW", 16),
            train_steps=_env_int("MXNET_TPU_ONLINE_TRAIN_STEPS", 4),
        )
        env.update(overrides)
        return cls(**env)


def make_rollout_trainer(params: Dict[str, Any], *, heads: int,
                         batch: int, seq_len: int,
                         optimizer: str = "sgd",
                         optimizer_params: Optional[Dict[str, Any]] = None,
                         mesh=None, device=None):
    """A :class:`ShardedTrainer` on the rollout objective, initialized
    from the SERVING weights, so round 0 trains from exactly what the
    fleet serves.  The symbol is ``transformer_lm(...,
    ignore_label=-1)``: masked positions (prompt, padding, rejected
    sequences) carry zero loss and zero gradient.  ``heads`` comes from
    the serving config (shapes do not tell it); ``device`` as every
    entry point's (the card unless ``"cpu"``)."""
    from ..models.transformer import lm_config_from_params, transformer_lm
    from ..parallel import ShardedTrainer
    vocab, num_layers, d_model = lm_config_from_params(params)
    sym = transformer_lm(vocab_size=vocab, num_layers=num_layers,
                         d_model=d_model, heads=heads,
                         batch_size=batch, seq_len=seq_len,
                         ignore_label=IGNORE)
    trainer = ShardedTrainer(
        sym, mesh=mesh, optimizer=optimizer,
        optimizer_params=optimizer_params or {"learning_rate": 0.05},
        device=device)
    trainer.bind(data_shapes={"data": (batch, seq_len)},
                 label_shapes={"softmax_label": (batch, seq_len)},
                 arg_params={k: _host(v) for k, v in params.items()})
    return trainer


def _host(v):
    """A parameter as a host numpy array (tensors on the card included)."""
    if hasattr(v, "asnumpy"):
        return v.asnumpy()
    if hasattr(v, "detach"):
        return v.detach().cpu().numpy()
    return np.asarray(v)


class OnlineLoop:
    """See the module docstring.  ``prompt_fn(round_idx, n)`` returns
    ``n`` token-list prompts for a round; ``reward_fn(prompt, tokens)
    -> float`` scores a completion (``None`` keeps every sequence).
    ``base_seed`` makes the whole loop — rollouts included —
    replayable."""

    def __init__(self, router, trainer, manager, *,
                 prompt_fn: Callable[[int, int], Sequence[Sequence[int]]],
                 reward_fn: Optional[Callable[[List[int], List[int]],
                                              float]] = None,
                 config: Optional[OnlineConfig] = None,
                 base_seed: int = 0, pad_id: int = 0):
        self.router = router
        self.trainer = trainer
        self.manager = manager
        self.prompt_fn = prompt_fn
        self.reward_fn = reward_fn
        self.config = config or OnlineConfig.from_env()
        self.base_seed = int(base_seed)
        self.pad_id = int(pad_id)
        shapes = getattr(trainer, "_input_shapes", None)
        if not shapes or "data" not in shapes:
            raise MXNetError("OnlineLoop needs a trainer bound with a "
                             "'data' input (see make_rollout_trainer)")
        self.batch, self.seq_len = (int(shapes["data"][0]),
                                    int(shapes["data"][1]))
        if self.batch < self.config.rollouts:
            raise MXNetError(
                f"trainer batch {self.batch} smaller than rollouts "
                f"{self.config.rollouts} — one row per rollout")

    # -- rollout ----------------------------------------------------------

    def rollout(self, round_idx: int) -> Dict[str, Any]:
        """Generate one round of completions on the live fleet and
        pack them into a training batch."""
        cfg = self.config
        prompts = [list(map(int, p))
                   for p in self.prompt_fn(round_idx, cfg.rollouts)]
        if len(prompts) != cfg.rollouts:
            raise MXNetError(
                f"prompt_fn returned {len(prompts)} prompts, "
                f"expected {cfg.rollouts}")
        with telemetry.span("online.rollout", round=round_idx,
                            n=len(prompts)):
            seed0 = self.base_seed + round_idx * cfg.rollouts
            rids = [self.router.submit(
                p, max_new_tokens=cfg.max_new_tokens,
                temperature=cfg.temperature, top_k=cfg.top_k,
                seed=seed0 + i) for i, p in enumerate(prompts)]
            self.router.run()
        outs, rewards = [], []
        harvested = 0
        for p, rid in zip(prompts, rids):
            rr = self.router.request(rid)
            toks = list(rr.tokens) if rr.state == "finished" else []
            outs.append(toks)
            harvested += len(toks)
            rewards.append(
                float(self.reward_fn(p, toks))
                if (self.reward_fn is not None and toks) else 1.0)
        telemetry.counter("online.rollout_tokens").inc(harvested)
        keep = self._select(outs, rewards)
        data, labels = self._pack(prompts, outs, keep)
        return {"data": data, "softmax_label": labels,
                "prompts": prompts, "tokens": outs,
                "rewards": rewards, "kept": keep,
                "rollout_tokens": harvested}

    def _select(self, outs: List[List[int]],
                rewards: List[float]) -> List[bool]:
        """{0,1} sequence weights: keep the top ``keep_frac`` by
        reward (every non-empty sequence when no reward_fn)."""
        if self.reward_fn is None:
            return [bool(t) for t in outs]
        n_keep = max(1, int(round(self.config.keep_frac * len(outs))))
        order = sorted(range(len(outs)),
                       key=lambda i: (-rewards[i], i))
        chosen = set(order[:n_keep])
        return [bool(outs[i]) and i in chosen for i in range(len(outs))]

    def _pack(self, prompts, outs, keep):
        """Fixed-shape (batch, seq_len) arrays.  Labels are
        next-token; only KEPT sequences' generated positions carry a
        real label — prompt positions, padding, and rejected
        sequences are ``ignore_label`` (zero loss, zero grad)."""
        B, L = self.batch, self.seq_len
        data = np.full((B, L), self.pad_id, dtype=np.float32)
        labels = np.full((B, L), IGNORE, dtype=np.float32)
        for i, (p, toks) in enumerate(zip(prompts, outs)):
            seq = (p + toks)[:L]
            data[i, :len(seq)] = seq
            if not keep[i]:
                continue
            # label[t] = seq[t+1], but only where seq[t+1] is a
            # GENERATED token (t+1 >= len(prompt))
            for t in range(len(seq) - 1):
                if t + 1 >= len(p):
                    labels[i, t] = seq[t + 1]
        return data, labels

    # -- the loop ---------------------------------------------------------

    def run_round(self, round_idx: int) -> Dict[str, Any]:
        """One rollout, train, publish and rolling-swap iteration."""
        cfg = self.config
        batch = self.rollout(round_idx)
        with telemetry.span("online.train", round=round_idx,
                            steps=cfg.train_steps):
            feed = {"data": batch["data"],
                    "softmax_label": batch["softmax_label"]}
            for _ in range(cfg.train_steps):
                self.trainer.step(feed)
        step = int(self.trainer._num_update)
        arg, aux = self.trainer.get_params()
        heads = self.router.replicas[0].engine.heads
        stamp = compat_stamp({k: v for k, v in arg.items()}, heads=heads)
        with telemetry.span("online.publish", round=round_idx,
                            step=step):
            self.manager.save_model(
                step, self.trainer.symbol, arg, aux,
                meta={"compat": stamp, "online_round": round_idx},
                blocking=True)
            self.manager.wait_until_finished()
            # the deployment reads the checkpoint back, never the
            # trainer's live arrays: the fleet serves what a cold
            # restart would load
            swap = self.router.rolling_swap(self.manager.directory)
        telemetry.counter("online.rounds").inc()
        telemetry.gauge("online.weights_step").set(step)
        return {"round": round_idx, "step": step,
                "rollout_tokens": batch["rollout_tokens"],
                "kept": batch["kept"], "rewards": batch["rewards"],
                "swap": swap}

    def run(self) -> List[Dict[str, Any]]:
        """Drive ``config.rounds`` full iterations; returns the
        per-round summaries."""
        return [self.run_round(r) for r in range(self.config.rounds)]
