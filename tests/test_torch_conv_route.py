"""The reference tier's convolution route (``ops.reference.conv_route``) on the CPU.

``ops.reference.conv2d`` is the fp32 oracle every candidate is screened
against. Which convolution computes a call depends on the operands'
device type and the accumulation dtype: fp32 on the CPU runs PyTorch's GEMM
convolution (``aten.thnn_conv2d``), fp32 on CUDA ``F.conv2d`` on float64
copies rounded once to fp32 (cuDNN's own fp32 choice, an FFT at conv2, is
past the gate's fp32 budget on same-sign sums), everything else
``F.conv2d`` in its dtype. The rule is held here for each device type and
dtype, and the float64 route's arithmetic is held on the CPU (where the
route can be asked for): one rounding of the float64 convolution, bitwise,
with its gradient reaching the fp32 operands.
"""

import pytest
import torch
import torch.nn.functional as F

from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import reference
from torch_threads import one_intra_op_thread  # noqa: unused-import (an autouse fixture)


@pytest.mark.parametrize("device,acc,route", [
    ("cpu", torch.float32, "gemm"), ("cuda", torch.float32, "float64"), ("cuda:0", torch.float32, "float64"),
    ("cpu", torch.bfloat16, "library"), ("cuda", torch.bfloat16, "library"), ("cpu", torch.float64, "library"),
    ("cuda", torch.float64, "library"), ("cuda", torch.float16, "library"),
])
def test_the_route_by_device_and_accumulation_dtype(device, acc, route):
    assert reference.conv_route(torch.device(device), acc) == route
    assert reference.conv_route(device, acc) == route


def _operands(seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand((2, 13, 13, 5), generator=g)
    w = torch.rand((3, 3, 5, 4), generator=g) - 0.5
    b = torch.rand((4,), generator=g)
    return x, w, b


def test_the_float64_route_rounds_the_float64_convolution_once(monkeypatch):
    """The CUDA fp32 route, asked for on the CPU: the output is the float64
    convolution rounded to fp32, plus the bias in fp32, bit for bit; the
    bf16 operands widened for an fp32 accumulator take the same route."""
    monkeypatch.setattr(reference, "conv_route", lambda device, acc: "float64" if acc == torch.float32 else "library")
    x, w, b = _operands()
    got = reference.conv2d(x, w, b, stride=2, padding=1)
    want = F.conv2d(x.permute(0, 3, 1, 2).double(), w.permute(3, 2, 0, 1).double(), stride=2, padding=1).float()
    assert got.dtype == torch.float32 and torch.equal(got, want.permute(0, 2, 3, 1) + b)
    xb, wb = x.bfloat16(), w.bfloat16()
    got = reference.conv2d(xb, wb, b, stride=1, padding=(0, 1), preferred_element_type=torch.float32)
    want = F.conv2d(xb.permute(0, 3, 1, 2).double(), wb.permute(3, 2, 0, 1).double(), padding=(0, 1)).float()
    assert got.dtype == torch.float32 and torch.equal(got, want.permute(0, 2, 3, 1) + b)


def test_the_float64_route_is_differentiable(monkeypatch):
    """A training step through the oracle differentiates the same function:
    the fp32 operands' gradients are the float64 convolution's, rounded."""
    x, w, b = _operands(1)
    grads = {}
    for route in ("float64", "gemm"):
        monkeypatch.setattr(reference, "conv_route", lambda device, acc, route=route: route)
        leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
        reference.conv2d(*leaves, stride=1, padding=1).square().sum().backward()
        grads[route] = [t.grad for t in leaves]
        assert all(g is not None and g.dtype == torch.float32 for g in grads[route])
    for a, c in zip(grads["float64"], grads["gemm"]):
        torch.testing.assert_close(a, c, rtol=1e-5, atol=1e-5)
