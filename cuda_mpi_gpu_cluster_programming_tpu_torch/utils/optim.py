"""Adam over a params tree, in optax's arithmetic.

``adam(lr)`` returns ``(init, update)``, the two halves of ``optax.adam``:
``init(params)`` is the state (``count`` int32, first and second moments
``mu`` and ``nu`` shaped like the params), ``update(grads, state, params)``
returns ``(updates, new_state)``, and :func:`apply_updates` adds the
updates to the params in their dtype. The order of the operations is
optax's (``scale_by_adam``, then ``scale_by_learning_rate``):

    mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g^2 + b2 nu;  count += 1
    mu_hat = mu / (1 - b1^count);  nu_hat = nu / (1 - b2^count)
    update = -lr * mu_hat / (sqrt(nu_hat + eps_root) + eps)

``torch.optim.Adam`` rounds in another order (it folds the bias
corrections into the step size), so it would not match the JAX package's
training step to fp32 rounding.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from .tree import tree_leaves, tree_map


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, eps_root: float = 0.0) -> Tuple[Callable, Callable]:
    def init(params: Any) -> Dict[str, Any]:
        device = tree_leaves(params)[0].device
        return {"count": torch.zeros((), dtype=torch.int32, device=device),
                "mu": tree_map(torch.zeros_like, params), "nu": tree_map(torch.zeros_like, params)}

    def update(grads: Any, state: Dict[str, Any], params: Any = None) -> Tuple[Any, Dict[str, Any]]:
        del params
        mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, state["mu"])
        nu = tree_map(lambda g, v: (1 - b2) * (g * g) + b2 * v, grads, state["nu"])
        count = state["count"] + 1
        # the bias corrections in fp32, as optax computes decay**count (count int32)
        c1 = 1 - torch.tensor(b1, dtype=torch.float32, device=count.device) ** count.float()
        c2 = 1 - torch.tensor(b2, dtype=torch.float32, device=count.device) ** count.float()
        updates = tree_map(
            lambda m, v: -lr * ((m / c1.to(m.dtype)) / (torch.sqrt(v / c2.to(v.dtype) + eps_root) + eps)), mu, nu)
        return updates, {"count": count, "mu": mu, "nu": nu}

    return init, update


def apply_updates(params: Any, updates: Any) -> Any:
    """``params + updates``, each leaf cast back to its param's dtype (``optax.apply_updates``)."""
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)
