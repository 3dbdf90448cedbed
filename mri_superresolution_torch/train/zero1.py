"""ZeRO-1: Adam's moments sharded over the data-parallel ranks.

The counterpart of the JAX trainer's ``--opt_shard``
(``parallel/mesh.zero1_shardings``: each moment sharded along its largest
axis that the data axis divides, scalars and indivisible tensors
replicated). Each rank keeps Adam's ``exp_avg`` and ``exp_avg_sq`` only
for its slice of every sharded parameter, updates that slice with the
all-reduced gradient, and all-gathers the new slices into the full
parameters; a replicated parameter is updated whole on every rank.

The update is ``torch.optim.Adam`` itself (``trainer.make_optimizer``),
run on contiguous copies of the slices: Adam is elementwise, so a slice
takes the same bits as the same elements of the whole tensor, and
``--opt_shard`` gives the replicated update's parameters and moments.
:meth:`Zero1Adam.adam_state` gathers the moments into the replicated
layout (a collective on every rank), so a checkpoint keeps the JAX
package's format and resumes at any world size, sharded or not.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from mri_superresolution_torch.parallel import multihost
from mri_superresolution_torch.parallel.mesh import zero1_layout


class Zero1Adam:
    """Adam over ``named_params`` with ZeRO-1-sharded moments, on the
    ranks of ``coll`` (a ``multihost.Collectives``). ``param_groups`` is
    the inner optimizer's (the trainer sets the lr there); :meth:`step`
    reads each parameter's ``.grad``, the all-reduced gradient."""

    def __init__(self, named_params: Sequence[Tuple[str, torch.nn.Parameter]],
                 learning_rate: float, weight_decay: float,
                 coll: multihost.Collectives):
        from mri_superresolution_torch.train.trainer import make_optimizer
        self.coll = coll
        # (name, param, axis or None, this rank's slice tensor)
        self.leaves: List[Tuple[str, torch.nn.Parameter, Optional[int],
                                torch.Tensor]] = []
        for name, p in named_params:
            ax = zero1_layout(tuple(p.shape), coll.world)
            own = (p.detach() if ax is None
                   else self._narrow(p, ax).clone())
            self.leaves.append((name, p, ax, own))
        self.optimizer = make_optimizer([own for *_, own in self.leaves],
                                        learning_rate, weight_decay)

    @property
    def param_groups(self):
        return self.optimizer.param_groups

    def _narrow(self, t: torch.Tensor, ax: int) -> torch.Tensor:
        n = t.shape[ax] // self.coll.world
        return t.detach().narrow(ax, self.coll.rank * n, n)

    def counts(self) -> Tuple[int, int]:
        """(moment tensors stored sharded, all moment tensors) with Adam's
        step counter among them, as the JAX trainer counts optax's leaves."""
        sharded = sum(1 for _, _, ax, _ in self.leaves if ax is not None)
        return 2 * sharded, 2 * len(self.leaves) + 1

    def moment_bytes(self) -> int:
        """The bytes of the moments this rank holds."""
        return sum(st[k].numel() * st[k].element_size()
                   for st in self.optimizer.state.values()
                   for k in ("exp_avg", "exp_avg_sq") if k in st)

    @torch.no_grad()
    def step(self) -> None:
        shards, axes = {}, {}
        for name, p, ax, own in self.leaves:
            if ax is None:
                own.grad = p.grad
                continue
            own.copy_(self._narrow(p, ax))
            own.grad = self._narrow(p.grad, ax).contiguous()
        self.optimizer.step()
        for name, p, ax, own in self.leaves:
            own.grad = None
            if ax is not None:
                shards[name], axes[name] = own, ax
        full = multihost.gather_tree(self.coll, shards, axes)
        for name, p, ax, _ in self.leaves:
            if ax is not None:
                p.copy_(full[name])

    def adam_state(self) -> Dict[str, Any]:
        """``trainer.adam_state``'s layout, the moments gathered from every
        rank (a collective: every rank calls it at the same point)."""
        mu, nu, count = {}, {}, 0
        shards, axes = {}, {}
        for name, p, ax, own in self.leaves:
            st = self.optimizer.state.get(own) or {}
            m = st.get("exp_avg", torch.zeros_like(own)).detach()
            v = st.get("exp_avg_sq", torch.zeros_like(own)).detach()
            if "step" in st:
                count = int(st["step"])
            if ax is None:
                mu[name], nu[name] = m.cpu(), v.cpu()
            else:
                shards["mu/" + name], axes["mu/" + name] = m, ax
                shards["nu/" + name], axes["nu/" + name] = v, ax
        for key, t in multihost.gather_tree(self.coll, shards, axes).items():
            kind, name = key.split("/", 1)
            (mu if kind == "mu" else nu)[name] = t.cpu()
        return {"count": count, "mu": mu, "nu": nu}

    def load_adam_state(self, state: Dict[str, Any]) -> None:
        """This rank's slices of a replicated-layout Adam state."""
        for name, p, ax, own in self.leaves:
            m = state["mu"][name].to(own).reshape(p.shape)
            v = state["nu"][name].to(own).reshape(p.shape)
            if ax is not None:
                m, v = self._narrow(m, ax), self._narrow(v, ax)
            self.optimizer.state[own] = {
                "step": torch.tensor(float(state["count"])),
                "exp_avg": m.clone().contiguous(),
                "exp_avg_sq": v.clone().contiguous()}
