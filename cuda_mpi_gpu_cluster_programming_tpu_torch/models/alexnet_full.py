"""Full AlexNet: Blocks 1-2 extended through conv5 and the FC head.

The counterpart of the JAX package's ``models/alexnet_full.py``:

    227x227x3 -Conv1(96,11,s4)->55x55x96 -Pool1(3,2)->27x27x96
      -Conv2(256,5,p2)->27x27x256 -Pool2(3,2)->13x13x256 -LRN2->13x13x256
      -Conv3(384,3,p1)->13x13x384 -Conv4(384,3,p1)->13x13x384
      -Conv5(256,3,p1)->13x13x256 -Pool5(3,2)->6x6x256
      -flatten 9216- FC6(4096) -FC7(4096) -FC8(num_classes) -> logits

The Blocks 1-2 prefix keeps the course code's layer order (ReLU after each
conv, LRN only after Pool2), and ``forward_spatial`` is the walker that
``forward_blocks12`` runs (``models/alexnet.py``), so the prefix is bitwise
``forward_blocks12``. ReLU
follows every conv and FC6/FC7. Activations are NHWC, conv weights HWIO and
FC weights ``(in, out)``; the flatten before FC6 is NHWC's (h, w, c) order,
the JAX package's, never torchvision's (c, h, w). Dropout (p = 0.5) is drawn
from an optional ``torch.Generator``; without one the pass is deterministic.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from ..ops import reference as ops
from .alexnet import BLOCKS12, Blocks12Config, ConvSpec, Params, PoolSpec, forward_spatial, output_shape


@dataclasses.dataclass(frozen=True)
class AlexNetConfig:
    """Full-network hyperparameters; the Blocks 1-2 defaults are the course code's."""

    blocks12: Blocks12Config = BLOCKS12
    conv3: ConvSpec = ConvSpec(384, 3, 1, 1)
    conv4: ConvSpec = ConvSpec(384, 3, 1, 1)
    conv5: ConvSpec = ConvSpec(256, 3, 1, 1)
    pool5: PoolSpec = PoolSpec(3, 2)
    fc6: int = 4096
    fc7: int = 4096
    num_classes: int = 1000
    dropout_rate: float = 0.5

    def layer_chain(self) -> Tuple[Tuple[str, Any], ...]:
        """The spatial chain: Blocks 1-2's, then conv3, conv4, conv5, pool5."""
        return self.blocks12.layer_chain() + (
            ("conv3", self.conv3),
            ("conv4", self.conv4),
            ("conv5", self.conv5),
            ("pool5", self.pool5),
        )

    @property
    def family(self) -> str:
        """The model family, as ``ExecConfig.model`` and the tuning plan's
        shape key name it."""
        return "alexnet_full"

    @property
    def in_height(self) -> int:
        return self.blocks12.in_height

    @property
    def in_width(self) -> int:
        return self.blocks12.in_width

    @property
    def in_channels(self) -> int:
        return self.blocks12.in_channels


ALEXNET = AlexNetConfig()


def spatial_output_shape(cfg: AlexNetConfig = ALEXNET) -> Tuple[int, int, int]:
    """(H, W, C) after pool5: 6x6x256 for the defaults."""
    return output_shape(cfg)


def fc_head(
    params: Params, feats: torch.Tensor, cfg: AlexNetConfig = ALEXNET,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """flatten -> FC6 (ReLU, dropout) -> FC7 (ReLU, dropout) -> FC8 logits.

    The one FC head of every tier: plain ``(N, in) x (in, out)`` matmuls
    (cuBLAS on the card, ``ops.reference.linear``: product, then bias add,
    as JAX rounds them), as the JAX package leaves them to XLA. ``generator``: dropout's random stream (``None``: no
    dropout, the inference pass); its masks are drawn on the generator's
    device and moved to the features'."""
    x = feats.reshape(feats.shape[0], -1)
    for name in ("fc6", "fc7"):
        x = ops.relu(ops.linear(x, params[name]["w"], params[name]["b"]))
        if generator is not None and cfg.dropout_rate > 0:
            keep = 1.0 - cfg.dropout_rate
            mask = torch.rand(x.shape, generator=generator, device=generator.device) < keep
            x = torch.where(mask.to(x.device), x / keep, torch.zeros((), dtype=x.dtype, device=x.device))
    return ops.linear(x, params["fc8"]["w"], params["fc8"]["b"])


def forward_alexnet(
    params: Params, x: torch.Tensor, cfg: AlexNetConfig = ALEXNET,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """The full pass on the reference-op tier -> (N, num_classes) logits."""
    return fc_head(params, forward_spatial(params, x, cfg), cfg, generator)


def predict(params: Params, x: torch.Tensor, cfg: AlexNetConfig = ALEXNET) -> torch.Tensor:
    """Class probabilities (softmax over the logits)."""
    return torch.softmax(forward_alexnet(params, x, cfg), dim=-1)


def _param_shapes(cfg: AlexNetConfig) -> Dict[str, Tuple[Tuple[int, ...], Tuple[int, ...]]]:
    shapes: Dict[str, Tuple[Tuple[int, ...], Tuple[int, ...]]] = {}
    c_in = cfg.in_channels
    for name, spec in cfg.layer_chain():
        if isinstance(spec, ConvSpec):
            shapes[name] = ((spec.filter_size, spec.filter_size, c_in, spec.out_channels), (spec.out_channels,))
            c_in = spec.out_channels
    h, w, c = spatial_output_shape(cfg)
    shapes["fc6"] = ((h * w * c, cfg.fc6), (cfg.fc6,))
    shapes["fc7"] = ((cfg.fc6, cfg.fc7), (cfg.fc7,))
    shapes["fc8"] = ((cfg.fc7, cfg.num_classes), (cfg.num_classes,))
    return shapes


def init_full_deterministic(cfg: AlexNetConfig = ALEXNET, dtype=torch.float32, device="cuda") -> Params:
    """weights = 0.01, biases = 0.0: the cross-tier comparison init over
    the full net. Every output channel then has the same weights, so all
    logits are equal: it cannot catch a channel permutation."""
    return {
        name: {"w": torch.full(ws, 0.01, dtype=dtype, device=device), "b": torch.zeros(bs, dtype=dtype, device=device)}
        for name, (ws, bs) in _param_shapes(cfg).items()
    }


def init_full_random(
    generator: torch.Generator, cfg: AlexNetConfig = ALEXNET, dtype=torch.float32, device="cuda"
) -> Params:
    """He-scaled normal weights (uniform [0, 1) explodes through 8 layers),
    bias 0.1, drawn on the CPU from ``generator`` layer by layer and moved
    to ``device``. The numbers differ from the JAX package's for the same
    seed (JAX draws with threefry); ``models.init.params_from_jax`` carries
    JAX-drawn params over."""
    params: Params = {}
    for name, (ws, bs) in _param_shapes(cfg).items():
        w = torch.randn(ws, generator=generator, dtype=torch.float32) * (2.0 / math.prod(ws[:-1])) ** 0.5
        params[name] = {"w": w.to(device=device, dtype=dtype), "b": torch.full(bs, 0.1, dtype=dtype, device=device)}
    return params
