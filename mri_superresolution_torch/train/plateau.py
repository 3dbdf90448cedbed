"""Host-side schedulers: ReduceLROnPlateau + early stopping.

An own copy of the JAX package's ``train/plateau.py``. Parity with the
reference's torch scheduler configuration
(scripts/train.py:189-191: mode='min', factor=0.5, patience=patience//2,
torch defaults threshold=1e-4 relative, cooldown=0, min_lr=0) and the early
stopping counter (scripts/train.py:405-422,462-464). The learning rate is a
plain float that the trainer sets into the optimizer's param groups each
step.
"""

from __future__ import annotations


class ReduceLROnPlateau:
    """min-mode plateau LR reducer matching torch.optim.lr_scheduler."""

    def __init__(self, initial_lr: float, factor: float = 0.5,
                 patience: int = 5, threshold: float = 1e-4,
                 min_lr: float = 0.0, cooldown: int = 0):
        self.lr = float(initial_lr)
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.cooldown = cooldown
        self.best = float("inf")
        self.num_bad_epochs = 0
        self.cooldown_counter = 0

    def _is_better(self, metric: float) -> bool:
        return metric < self.best * (1.0 - self.threshold)

    def step(self, metric: float) -> float:
        """Record a validation metric; returns the (possibly reduced) lr."""
        if self._is_better(metric):
            self.best = metric
            self.num_bad_epochs = 0
        elif self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1

        if self.num_bad_epochs > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
        return self.lr

    def state_dict(self) -> dict:
        return {k: getattr(self, k) for k in
                ("lr", "best", "num_bad_epochs", "cooldown_counter")}

    def load_state_dict(self, state: dict) -> None:
        for k, v in state.items():
            setattr(self, k, v)


class EarlyStopping:
    """Stop after ``patience`` consecutive validation epochs without a new
    best val loss (reference scripts/train.py:405-422,462-464)."""

    def __init__(self, patience: int):
        self.patience = patience
        self.best = float("inf")
        self.counter = 0

    def update(self, val_loss: float) -> bool:
        """Returns True when this epoch set a new best."""
        if val_loss < self.best:
            self.best = val_loss
            self.counter = 0
            return True
        self.counter += 1
        return False

    @property
    def should_stop(self) -> bool:
        return self.counter >= self.patience

    def state_dict(self) -> dict:
        return {"best": self.best, "counter": self.counter}

    def load_state_dict(self, state: dict) -> None:
        self.best = state["best"]
        self.counter = state["counter"]
