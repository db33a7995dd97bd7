"""Training steps over the Blocks 1-2 model and full AlexNet: the JAX
package's ``training.py``.

A step is ``(params, opt_state, x, y) -> (new_params, new_opt_state,
loss[, grad_norm])``: the MSE loss of the forward against ``y``, its
gradient by ``torch.autograd`` through the reference ops (the JAX
package's ``jax.value_and_grad``), then the optimizer's update and
``apply_updates`` in optax's order of operations (``utils/optim.py``:
``sgd`` by default, ``adam``). The forward is the single-device reference
forward, the row-sharded one (``sp_shards``, ``parallel/sharded.py``) or the
tensor-parallel one (``tp_shards``, ``parallel/tensor_parallel.py``) over
the mesh's shard slots; a halo copy and a gather are differentiable copies,
so the gradient flows back through them. The Blocks 1-2 forward has no
backward kernel in the JAX package, so a training step launches no CUDA
kernel of the port: its convs are the reference tier's (cuDNN on the card).

With a mesh, the data-parallel placement (the JAX package's sharding
constraints: params replicated, the batch over ``dp``) is the mesh's home
device for both, which on one card is the device they are on.
:func:`make_elastic_step_builder` maps a supervisor's ladder rung onto these
steps over the mesh the supervisor passes (its surviving slots).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from .models.alexnet import BLOCKS12, forward_blocks12
from .utils.optim import apply_updates, sgd
from .utils.tree import tree_leaves, tree_map, tree_unflatten


def _remat(fwd: Callable) -> Callable:
    """Recompute the forward's activations in the backward pass (the JAX
    package's ``jax.checkpoint``)."""
    from torch.utils.checkpoint import checkpoint

    def run(params, x):
        leaves = tree_leaves(params)
        return checkpoint(lambda xx, *ls: fwd(tree_unflatten(params, list(ls)), xx), x, *leaves,
                          use_reentrant=False)

    return run


def global_norm(tree) -> torch.Tensor:
    """``optax.global_norm``: sqrt of the sum over leaves of sum(x^2)."""
    return torch.sqrt(sum(torch.sum(torch.square(t)) for t in tree_leaves(tree)))


def _step(opt, loss_fn: Callable, pre=None, post=None, with_grad_norm: bool = False) -> Callable:
    """The shared update scaffold: (pre) -> loss and gradient -> the
    optimizer's update -> apply_updates -> (post)."""
    _, update = opt

    def step(params, opt_state, x, y):
        if pre is not None:
            params, x = pre(params, x)
        live = tree_map(lambda t: t.detach().requires_grad_(True), params)
        with torch.enable_grad():
            loss = loss_fn(live, x, y)
            grads = tree_unflatten(live, list(torch.autograd.grad(loss, tree_leaves(live))))
        with torch.no_grad():
            updates, new_opt_state = update(grads, opt_state, params)
            new_params = apply_updates(tree_map(torch.Tensor.detach, params), updates)
            if post is not None:
                new_params = post(new_params)
            out = (new_params, new_opt_state, loss.detach())
            return out + (global_norm(grads),) if with_grad_norm else out

    return step


def _dp_pre_post(mesh):
    """(pre, post) of the replicated-params discipline over ``mesh``: params
    and the batch on the mesh's home device; (None, None) without a mesh."""
    if mesh is None:
        return None, None
    from .parallel.elastic import reshard_tree

    def pre(params, x):
        return reshard_tree(params, mesh), x.to(mesh.devices[0])

    def post(new_params):
        return reshard_tree(new_params, mesh)

    return pre, post


def _mse(fwd: Callable) -> Callable:
    def loss_fn(params, x, y):
        return torch.mean((fwd(params, x) - y) ** 2)

    return loss_fn


def make_train_step(
    cfg=BLOCKS12,
    mesh=None,
    optimizer: Optional[Tuple[Callable, Callable]] = None,
    lr: float = 1e-3,
    sp_shards: int = 0,
    tp_shards: int = 0,
    remat: bool = False,
    with_grad_norm: bool = False,
    device: str = "cuda",
) -> Tuple[Callable, Callable]:
    """``(init_fn, step_fn)`` for an optimizer ``(init, update)`` (default
    ``sgd(lr)``): ``init_fn(params) -> opt_state``, ``step_fn(params,
    opt_state, x, y) -> (new_params, new_opt_state, loss[, grad_norm])``.

    ``sp_shards``: the row-sharded forward over ``mesh`` (default a mesh of
    that many slots on ``device``), whose ``sp`` axis must have as many;
    ``tp_shards``: the tensor-parallel one; neither: the single-device
    reference forward (with ``mesh``, on its home device). ``remat``
    recomputes the activations in the backward pass. ``with_grad_norm``
    appends the gradient's global L2 norm."""
    if sp_shards and tp_shards:
        raise ValueError("sp_shards and tp_shards are mutually exclusive strategies")
    opt = optimizer if optimizer is not None else sgd(lr)
    if sp_shards and sp_shards >= 1:
        from .parallel.sharded import build_sharded_forward

        if mesh is not None and mesh.n_shards != sp_shards:
            raise ValueError(f"mesh 'sp' axis has {mesh.n_shards} devices but sp_shards={sp_shards}; "
                             "the halo/ownership plan would be built for the wrong shard count")
        if mesh is not None and mesh.dp > 1:
            # a (dp, sp) mesh: the whole batch through the first data-parallel row's shard slots (the
            # replicated-params discipline keeps params and batch on the home device, as without sp)
            mesh = dataclasses.replace(mesh, axis_names=mesh.axis_names[-1:], shape=(sp_shards,),
                                       devices=mesh.shard_devices)
        fwd = build_sharded_forward(cfg, n_shards=sp_shards, mesh=mesh, device=device, differentiable=True)
        return opt[0], _step(opt, _mse(_remat(fwd) if remat else fwd), with_grad_norm=with_grad_norm)
    if tp_shards and tp_shards >= 1:
        from .parallel.tensor_parallel import build_tp_forward

        fwd = build_tp_forward(cfg, n_shards=tp_shards, mesh=mesh, device=device, differentiable=True)
        return opt[0], _step(opt, _mse(_remat(fwd) if remat else fwd), with_grad_norm=with_grad_norm)

    def base_fwd(params, x):
        return forward_blocks12(params, x, cfg)

    pre, post = _dp_pre_post(mesh)
    return opt[0], _step(opt, _mse(_remat(base_fwd) if remat else base_fwd), pre, post,
                         with_grad_norm=with_grad_norm)


def make_elastic_step_builder(
    cfg=BLOCKS12,
    optimizer: Optional[Tuple[Callable, Callable]] = None,
    lr: float = 1e-3,
    remat: bool = False,
    with_grad_norm: bool = False,
    device: str = "cuda",
) -> Callable:
    """``(entry, mesh) -> step_fn`` for the supervisor's step replay
    (``Supervisor(step_builder=...)``): a ladder rung onto
    :func:`make_train_step`'s strategies over the mesh the supervisor
    passes (never one of its own). One optimizer serves every rung, so the
    optimizer state keeps its structure through a degrade."""
    opt = optimizer if optimizer is not None else sgd(lr)

    def build(entry, mesh) -> Callable:
        kw = dict(optimizer=opt, remat=remat, with_grad_norm=with_grad_norm, device=device)
        if entry.strategy in ("halo", "staged_halo") and entry.n_shards >= 2:
            return make_train_step(cfg, mesh=mesh, sp_shards=entry.n_shards, **kw)[1]
        if entry.strategy == "tp" and entry.n_shards >= 2:
            return make_train_step(cfg, mesh=mesh, tp_shards=entry.n_shards, **kw)[1]
        if entry.strategy in ("single", "replicated") or entry.n_shards == 1:
            return make_train_step(cfg, **kw)[1]
        raise ValueError(f"no elastic training step for ladder entry {entry.key}")

    return build


def make_classifier_train_step(
    cfg,
    mesh=None,
    optimizer: Optional[Tuple[Callable, Callable]] = None,
    lr: float = 1e-3,
    remat: bool = False,
) -> Tuple[Callable, Callable]:
    """``(init_fn, step_fn)`` for full-AlexNet classification: the
    cross-entropy of the FC8 logits (fp32 log-softmax) against integer
    ``labels``, ``step_fn(params, opt_state, x, labels)``; Adam by default,
    as in the JAX package."""
    from .models.alexnet_full import forward_alexnet
    from .utils.optim import adam

    opt = optimizer if optimizer is not None else adam(lr)

    def fwd(params, x):
        return forward_alexnet(params, x, cfg)

    run = _remat(fwd) if remat else fwd

    def loss_fn(params, x, labels):
        logp = torch.log_softmax(run(params, x).float(), dim=-1)
        return -torch.mean(torch.take_along_dim(logp, labels.long()[:, None], dim=-1))

    pre, post = _dp_pre_post(mesh)
    return opt[0], _step(opt, loss_fn, pre, post)
