"""Supervised / behavioural-cloning trainer (counterpart of
``gym2048_tpu/train/bc.py``).

Cross-entropy over (board, action) pairs, for either model: the policy
:class:`~gym2048_tpu_torch.models.resnet.Game2048Model` (its logits) or the
PPO :class:`~gym2048_tpu_torch.models.resnet.ActorCritic` (its policy
logits), so that the result warm-starts PPO. An epoch shuffles the data
with one permutation and takes minibatches of ``batch_size`` in order; the
last one is padded with the permutation's first indices and their loss is
masked out (BatchNorm's batch statistics still see them, as in JAX). The
optimiser is ``optax.adam(lr)``: ``torch.optim.Adam(lr)``, whose eps, 1e-8,
is optax's. The data lives on the model's device as int8 exponent boards
and is one-hot encoded per minibatch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gym2048_tpu_torch.models.resnet import ActorCritic, boards_to_model_input


@dataclasses.dataclass(frozen=True)
class BCConfig:
    """Defaults mirror the reference ``train()``."""

    epochs: int = 3
    batch_size: int = 128
    lr: float = 1e-3
    seed: int = 0


class BCTrainer:
    """Cross-entropy trainer of ``model`` (a ``Game2048Model`` or an
    ``ActorCritic``), on the model's device; the model is trained in
    place."""

    def __init__(self, model, config: BCConfig = BCConfig()):
        self.model = model
        self.cfg = config
        self.device = next(model.parameters()).device

    def _logits(self, obs: torch.Tensor) -> torch.Tensor:
        if isinstance(self.model, ActorCritic):
            return self.model(obs)[0]
        return self.model.logits(obs)

    def init_model(self, generator: torch.Generator | None = None):
        """Draw the model's weights anew (flax's initialisation) from
        ``generator`` (default: seeded ``cfg.seed``); returns the model."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(self.cfg.seed)
        self.model.init_weights(generator)
        return self.model

    def _data(self, boards_exp, labels) -> tuple[torch.Tensor, torch.Tensor]:
        boards = torch.as_tensor(np.asarray(boards_exp), dtype=torch.int8).to(self.device)
        labels = torch.as_tensor(np.asarray(labels).reshape(-1),
                                 dtype=torch.int64).to(self.device)
        return boards, labels

    def _epoch(self, optimizer: torch.optim.Optimizer, boards: torch.Tensor,
               labels: torch.Tensor, perm: torch.Tensor):
        """One epoch over ``perm`` (a permutation of the ``N`` samples),
        the last minibatch padded and masked -> ``(mean loss, accuracy)``
        as device scalars."""
        n, bs = boards.shape[0], self.cfg.batch_size
        n_batches = -(-n // bs)
        pad = n_batches * bs - n
        perm = perm.to(self.device, torch.int64)
        if pad:
            perm = torch.cat([perm, perm[:pad]])
        mask_flat = torch.cat([torch.ones(n, device=self.device),
                               torch.zeros(pad, device=self.device)])
        model = self.model.train()
        losses, corrects = [], []
        for i in range(n_batches):
            take = perm[i * bs:(i + 1) * bs]
            m = mask_flat[i * bs:(i + 1) * bs]
            y = labels[take]
            logits = self._logits(boards_to_model_input(boards[take]))
            nll = -torch.log_softmax(logits, -1).gather(-1, y[:, None])[:, 0]
            loss = (nll * m).sum() / m.sum().clamp_min(1.0)
            loss.backward()
            optimizer.step()
            optimizer.zero_grad(set_to_none=True)
            losses.append(loss.detach() * m.sum())
            corrects.append(((logits.argmax(-1) == y) * m).sum().detach())
        model.eval()
        return torch.stack(losses).sum() / n, torch.stack(corrects).sum() / n

    def fit(self, boards_exp, labels, generator: torch.Generator | None = None,
            epochs: int | None = None, verbose: bool = True,
            perms: list | None = None) -> tuple:
        """Train on ``(N, 4, 4)`` int8 exponent boards and ``(N,)`` action
        labels (host or device); returns ``(model, per-epoch history)``.
        Each epoch's permutation comes from ``generator`` (default: seeded
        ``cfg.seed``) unless ``perms[e]`` gives it. A fresh Adam state
        starts each call, as in JAX."""
        epochs = self.cfg.epochs if epochs is None else epochs
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(self.cfg.seed)
        boards, labels = self._data(boards_exp, labels)
        optimizer = torch.optim.Adam(self.model.parameters(), lr=self.cfg.lr)
        history = []
        for epoch in range(epochs):
            perm = (torch.randperm(boards.shape[0], generator=generator, device=self.device)
                    if perms is None else torch.as_tensor(np.array(perms[epoch], copy=True)))
            loss, acc = self._epoch(optimizer, boards, labels, perm)
            rec = {"epoch": epoch + 1, "loss": float(loss), "accuracy": float(acc)}
            history.append(rec)
            if verbose:
                print(f"Epoch {epoch + 1}/{epochs} — loss: {rec['loss']:.4f} "
                      f"— accuracy: {rec['accuracy']:.4f}")
        return self.model, history

    @torch.no_grad()
    def evaluate(self, boards_exp, labels) -> dict:
        """Validation loss and accuracy in eval mode, in one forward."""
        boards, labels = self._data(boards_exp, labels)
        self.model.eval()
        logits = self._logits(boards_to_model_input(boards))
        nll = -torch.log_softmax(logits, -1).gather(-1, labels[:, None])[:, 0]
        n = labels.shape[0]
        return {"loss": float(nll.sum()) / n,
                "accuracy": float((logits.argmax(-1) == labels).sum()) / n}


def build_bc_trainer_for_ppo(filters: int = 64, residual_blocks: int = 4,
                             config: BCConfig = BCConfig(epochs=10, batch_size=256),
                             device: str | torch.device = "cuda") -> BCTrainer:
    """BC trainer on the PPO actor-critic (the reference's pretrain_bc:
    the architecture of ppo_train, trained with cross-entropy), on the card
    unless ``device`` says otherwise."""
    return BCTrainer(ActorCritic(filters, residual_blocks, device=device), config)
