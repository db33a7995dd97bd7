"""Parameter and input initialisation, layout converters, weight carry-over.

Two init modes, as in the JAX package:

- deterministic: input = 1.0, weights = 0.01, biases = 0.0, the mode whose
  output is the golden first-10 ``29.2932 25.9153 23.3255 ...``;
- random: uniform [0, 1) input and weights, biases 0.1, drawn from an
  explicit ``torch.Generator``. The numbers differ from the JAX package's
  for the same seed (JAX draws with threefry); tests that compare the two
  packages make their inputs with numpy and hand them to both, and
  :func:`params_from_jax` carries JAX-drawn weights over.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from .alexnet import BLOCKS12, Blocks12Config, Params


def _conv_shapes(cfg: Blocks12Config):
    c1, c2 = cfg.conv1, cfg.conv2
    w1 = (c1.filter_size, c1.filter_size, cfg.in_channels, c1.out_channels)
    w2 = (c2.filter_size, c2.filter_size, c1.out_channels, c2.out_channels)
    return w1, (c1.out_channels,), w2, (c2.out_channels,)


def init_params_deterministic(
    cfg: Blocks12Config = BLOCKS12, dtype=torch.float32, device="cuda"
) -> Params:
    """weights = 0.01, biases = 0.0 (the cross-version comparison init)."""
    w1s, b1s, w2s, b2s = _conv_shapes(cfg)
    return {
        "conv1": {"w": torch.full(w1s, 0.01, dtype=dtype, device=device),
                  "b": torch.zeros(b1s, dtype=dtype, device=device)},
        "conv2": {"w": torch.full(w2s, 0.01, dtype=dtype, device=device),
                  "b": torch.zeros(b2s, dtype=dtype, device=device)},
    }


def init_params_random(
    generator: torch.Generator, cfg: Blocks12Config = BLOCKS12, dtype=torch.float32, device="cuda"
) -> Params:
    """Uniform [0, 1) weights, bias 0.1, drawn on the CPU from ``generator``
    (so the draw does not depend on the device) and moved to ``device``."""
    w1s, b1s, w2s, b2s = _conv_shapes(cfg)

    def uniform(shape):
        return torch.rand(shape, generator=generator, dtype=torch.float32).to(device=device, dtype=dtype)

    return {
        "conv1": {"w": uniform(w1s), "b": torch.full(b1s, 0.1, dtype=dtype, device=device)},
        "conv2": {"w": uniform(w2s), "b": torch.full(b2s, 0.1, dtype=dtype, device=device)},
    }


def deterministic_input(
    batch: int = 1, cfg: Blocks12Config = BLOCKS12, dtype=torch.float32, device="cuda"
) -> torch.Tensor:
    """All-ones NHWC input."""
    return torch.ones((batch, cfg.in_height, cfg.in_width, cfg.in_channels), dtype=dtype, device=device)


def random_input(
    generator: torch.Generator, batch: int = 1, cfg: Blocks12Config = BLOCKS12,
    dtype=torch.float32, device="cuda",
) -> torch.Tensor:
    """Uniform [0, 1) NHWC input drawn on the CPU from ``generator``."""
    shape = (batch, cfg.in_height, cfg.in_width, cfg.in_channels)
    return torch.rand(shape, generator=generator, dtype=torch.float32).to(device=device, dtype=dtype)


def to_reference_layout(w: torch.Tensor) -> np.ndarray:
    """HWIO ``(F,F,C,K)`` -> the course code's flat K,C,F,F weight layout
    (``w_idx = ((k*C + c)*F + fy)*F + fx``)."""
    return w.detach().cpu().float().numpy().transpose(3, 2, 0, 1).reshape(-1)


def from_reference_layout(flat, f: int, c: int, k: int, device="cuda") -> torch.Tensor:
    """Flat K,C,F,F weights -> HWIO ``(F,F,C,K)``."""
    arr = np.asarray(flat, dtype=np.float32).reshape(k, c, f, f)
    return torch.from_numpy(np.ascontiguousarray(arr.transpose(2, 3, 1, 0))).to(device)


def _tensor_from_array(a: Any, device) -> torch.Tensor:
    arr = np.array(a)  # a writable, contiguous copy
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bfloat16 has no torch twin in numpy
        return torch.from_numpy(arr.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(arr).to(device)


def params_from_jax(tree: Mapping[str, Mapping[str, Any]], device="cuda") -> Params:
    """The JAX package's params (arrays, or anything ``np.asarray`` takes)
    as the port's params: same layouts, same values, same dtypes. Full
    AlexNet's come over as they are: conv3-5 in HWIO, fc6-8 as ``(in, out)``
    matrices, fc6's rows in the (h, w, c) order of the NHWC flatten."""
    return {
        layer: {name: _tensor_from_array(a, device) for name, a in leaves.items()}
        for layer, leaves in tree.items()
    }


def params_to(params: Params, dtype=None, device=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """``params`` with every tensor moved to ``device`` and/or cast to ``dtype``."""
    return {layer: {n: t.to(device=device, dtype=dtype) for n, t in leaves.items()} for layer, leaves in params.items()}
