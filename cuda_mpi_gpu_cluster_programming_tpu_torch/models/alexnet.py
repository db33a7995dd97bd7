"""AlexNet Blocks 1-2: the one model definition shared by both tiers.

    227x227x3 -Conv1(K=96,F=11,S=4,P=0)-> 55x55x96 -Pool1(3,2)-> 27x27x96
             -Conv2(K=256,F=5,S=1,P=2)-> 27x27x256 -Pool2(3,2)-> 13x13x256
             -LRN2(N=5, a=1e-4, b=0.75, k=2.0)-> 13x13x256

Activations are NHWC and weights HWIO ``(F, F, C, K)``, the JAX package's
layouts, so the two packages compare like with like.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from ..ops import reference as ops
from ..ops.shapes import conv_out_dim, pool_out_dim

Params = Dict[str, Dict[str, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    out_channels: int
    filter_size: int
    stride: int
    padding: int


@dataclasses.dataclass(frozen=True)
class PoolSpec:
    window: int
    stride: int


@dataclasses.dataclass(frozen=True)
class LrnSpec:
    size: int
    alpha: float
    beta: float
    k: float
    # False = the CUDA form of the original course code (k + alpha*sum: the
    # headline golden numbers); True = its CPU form (k + alpha*sum/size).
    alpha_over_size: bool = False


@dataclasses.dataclass(frozen=True)
class Blocks12Config:
    """AlexNet Blocks 1-2 hyperparameters (reference defaults)."""

    in_height: int = 227
    in_width: int = 227
    in_channels: int = 3
    conv1: ConvSpec = ConvSpec(96, 11, 4, 0)
    pool1: PoolSpec = PoolSpec(3, 2)
    conv2: ConvSpec = ConvSpec(256, 5, 1, 2)
    pool2: PoolSpec = PoolSpec(3, 2)
    lrn2: LrnSpec = LrnSpec(5, 1e-4, 0.75, 2.0)

    def layer_chain(self) -> Tuple[Tuple[str, Any], ...]:
        return (
            ("conv1", self.conv1),
            ("pool1", self.pool1),
            ("conv2", self.conv2),
            ("pool2", self.pool2),
            ("lrn2", self.lrn2),
        )


BLOCKS12 = Blocks12Config()


def layer_dims(cfg):
    """Walk the layer chain once, yielding ``(name, spec, in_dims, out_dims)``
    with dims as (H, W, C): the one shape traversal that ``output_shape``
    and the FLOP counters share."""
    h, w, c = cfg.in_height, cfg.in_width, cfg.in_channels
    for name, spec in cfg.layer_chain():
        hin, win, cin = h, w, c
        if isinstance(spec, ConvSpec):
            h = conv_out_dim(h, spec.filter_size, spec.padding, spec.stride)
            w = conv_out_dim(w, spec.filter_size, spec.padding, spec.stride)
            c = spec.out_channels
        elif isinstance(spec, PoolSpec):
            h = pool_out_dim(h, spec.window, spec.stride)
            w = pool_out_dim(w, spec.window, spec.stride)
        yield name, spec, (hin, win, cin), (h, w, c)


def output_shape(cfg: Blocks12Config = BLOCKS12) -> Tuple[int, int, int]:
    """(H, W, C) of the final output: 13x13x256 for the defaults."""
    dims = cfg.in_height, cfg.in_width, cfg.in_channels
    for _name, _spec, _in, dims in layer_dims(cfg):
        pass
    return dims


def stage_flops(cfg: Blocks12Config = BLOCKS12):
    """Per-stage ``(name, flops, matmul_flops)`` for ONE image.

    ``flops`` counts everything (conv MACs x2 + bias + ReLU, pool window
    compares, LRN window sums and scale); ``matmul_flops`` only the conv
    MACs x2."""
    for name, spec, (_hi, _wi, c_in), (h, w, c_out) in layer_dims(cfg):
        if isinstance(spec, ConvSpec):
            macs = h * w * c_out * spec.filter_size**2 * c_in
            yield name, 2 * macs + h * w * c_out, 2 * macs
        elif isinstance(spec, PoolSpec):
            yield name, h * w * c_out * spec.window**2, 0
        elif isinstance(spec, LrnSpec):
            yield name, h * w * c_out * (2 * spec.size + 2), 0


def flops_per_image(cfg: Blocks12Config = BLOCKS12) -> int:
    """All FLOPs for one image through Blocks 1-2 (MAC = 2 FLOPs)."""
    return sum(f for _name, f, _mm in stage_flops(cfg))


def matmul_flops_per_image(cfg: Blocks12Config = BLOCKS12) -> int:
    """Conv MACs x2 for one image through Blocks 1-2."""
    return sum(mm for _name, _f, mm in stage_flops(cfg))


def forward_blocks12(params: Params, x: torch.Tensor, cfg: Blocks12Config = BLOCKS12) -> torch.Tensor:
    """Conv1→ReLU→Pool1→Conv2→ReLU→Pool2→LRN2 on the reference-op tier.

    ``x`` is NHWC; params is ``{"conv1": {"w","b"}, "conv2": {"w","b"}}``
    with HWIO weights."""
    c1, p1, c2, p2, n2 = cfg.conv1, cfg.pool1, cfg.conv2, cfg.pool2, cfg.lrn2
    x = ops.conv2d(x, params["conv1"]["w"], params["conv1"]["b"], stride=c1.stride, padding=c1.padding)
    x = ops.relu_maxpool(x, window=p1.window, stride=p1.stride)
    x = ops.conv2d(x, params["conv2"]["w"], params["conv2"]["b"], stride=c2.stride, padding=c2.padding)
    x = ops.relu_maxpool(x, window=p2.window, stride=p2.stride)
    return ops.lrn(
        x, size=n2.size, alpha=n2.alpha, beta=n2.beta, k=n2.k, alpha_over_size=n2.alpha_over_size
    )
