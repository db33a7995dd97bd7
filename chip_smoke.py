#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of the repository, on a host with one CUDA GPU and the
CUDA toolkit (``nvcc``). Phases, in order; a phase that fails ends the run
with a non-zero exit code and nothing is caught:

1. build the kernel library from ``cuda_mpi_gpu_cluster_programming_tpu_torch/csrc``;
2. at the main path's shapes (batch 128, 227x227x3), in fp32 and bf16, hold
   each staged kernel (conv1, conv2, pool1, pool2, lrn2) against its plain
   PyTorch version on the card, and time the kernel, the plain version and
   one PyTorch library call with CUDA events, beside the card's bound; then
   the fused ``conv_block`` kernel at both blocks in fp32, bf16 and int8w:
   against its plain version, bitwise against the staged kernel chain of
   the same block (fp32, bf16), timed beside that chain, its plain version,
   the cuDNN chain (a note: no one library call computes a block) and the
   bound; and every kernel again at edge shapes off the main path;
3. drive the main path through ``run.main``, each run with the kernels'
   launch counts set to 0 just before it and read just after: ``v3_pallas``
   and ``v1_jit`` in fp32 and bf16 (staged), ``v3_pallas`` with
   ``TPU_FRAMEWORK_FUSE=block`` in fp32, bf16 and int8w, and ``--dtype
   int8w`` staged on both tiers, batch 128; check the golden first-10 on
   the staged and fused fp32 routes, every route against ``v1_jit`` fp32
   on numpy-seeded random params within the precision budgets, fused
   int8w against staged int8w, and ``ToleranceGate().screen_blocks`` at
   227x227 for fp32, bf16 and int8w.

Then it prints the ``{"kernels": [...]}`` line, the card's name and power
limit, and last the ``{"ok": true, "device": ...}`` line. Details of every
phase also go to ``chip_smoke_out/chip_smoke.json`` (listed in ``.gitignore``).

Tolerances, kernel against plain version on the same inputs:
- conv fp32: max |diff| <= 1e-5 x max |plain|. Both accumulate in fp32 in
  different orders (one FMA chain per output; per-tap matmuls);
- conv and LRN bf16: per element, 1 bf16 ulp (where that order flips the
  one rounding to bf16) plus the fp32 term above (1e-5, LRN 1e-6, of the
  max), which dominates where a sum cancels to near zero;
- pool: bitwise (max is exact);
- LRN fp32: max |diff| <= 1e-6 x max |plain| (same sums, same powf);
- conv_block fp32: 1e-5 x max |plain|, as conv; bf16 and int8w: 1 bf16 ulp
  + 1e-5 of the max, and 2 ulps for a block that ends in LRN: a one-ulp
  flip of the bf16 interior (the conv's other summation order) moves the
  LRN result, which is then rounded once more; against the staged kernel
  chain, fp32 and bf16: bitwise.
Main path: ``precision/gate.py`` budgets of the JAX package: fp32 1e-4 abs
and 1e-5 of the max; bf16 2e-2 and int8w 6e-2 of the max against the fp32
oracle.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import re
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

GOLDEN_FIRST10 = [29.2932, 25.9153, 23.3255, 23.3255, 23.3255, 23.3255, 23.3255, 23.3255, 23.3255, 23.3255]
BATCH = 128
TIMED_REPS = 25
TPU_FILE = "cuda_mpi_gpu_cluster_programming_tpu/ops/pallas_kernels.py"
PORT = "cuda_mpi_gpu_cluster_programming_tpu_torch"
KERNELS = {
    # name: (source, TPU kernel it replaces, stages on the main path)
    "conv2d": (f"{PORT}/csrc/conv2d.cu", f"{TPU_FILE}:434", ("conv1", "conv2")),
    "maxpool2d": (f"{PORT}/csrc/maxpool.cu", f"{TPU_FILE}:963", ("pool1", "pool2")),
    "lrn": (f"{PORT}/csrc/lrn.cu", f"{TPU_FILE}:1024", ("lrn2",)),
}
BLOCK_KERNEL = ("conv_block", f"{PORT}/csrc/conv_block.cu",
                "cuda_mpi_gpu_cluster_programming_tpu/ops/megakernel.py:111", ("block1", "block2"))
FP32_ABS, FP32_REL, BF16_REL, INT8W_REL = 1e-4, 1e-5, 2e-2, 6e-2
BUDGET_REL = {"bf16": BF16_REL, "int8w": INT8W_REL}


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_time_ms(fn, reps: int = TIMED_REPS, warmup: int = 3) -> float:
    """Median over ``reps`` single calls, each between two CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each |value| (8 significant bits)."""
    _m, e = torch.frexp(t.float().abs().clamp_min(2.0**-126))
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32), e - 8)


def compare(rule, got: torch.Tensor, want: torch.Tensor) -> dict:
    """Kernel output against its plain version. ``rule`` is "bitwise", a
    relative budget r (max |diff| <= r x max |plain|), or ("ulp", r[, n]):
    each element within n (default 1) bf16 ulps plus r x max |plain| (the
    fp32 reordering term: after cancellation near zero, that absolute error
    is larger than the ulp of the small result)."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    wmax = float(w.abs().max().clamp_min(1e-30))
    res = {"max_abs_err": float(diff.max()), "max_rel_err": float(diff.max()) / wmax}
    if rule == "bitwise":
        res.update(tol="bitwise", ok=bool(torch.equal(got, want)))
    elif isinstance(rule, tuple):
        n_ulp = rule[2] if len(rule) > 2 else 1
        ulp = bf16_ulp(torch.maximum(g.abs(), w.abs()))
        slack = n_ulp * ulp + rule[1] * wmax
        res.update(tol=f"{n_ulp} bf16 ulp + {rule[1]:g} x max|plain|", ok=bool((diff <= slack).all()),
                   max_ulps=float((diff / ulp).max()))
    else:
        res.update(tol=f"{rule:g} x max|plain|", ok=res["max_rel_err"] <= rule)
    return res


def stage_inputs(dtype, gen):
    """The main path's tensors at batch 128: input, zero-mean weights (so
    ReLU clamps), and each stage's input as the kernel chain produces it."""
    from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import cuda_kernels as ck

    def r(*shape, scale=1.0, shift=0.0):
        return ((torch.rand(shape, generator=gen, device="cuda") - shift) * scale).to(dtype)

    x = r(BATCH, 227, 227, 3)
    w1, b1 = r(11, 11, 3, 96, scale=2 / 363**0.5, shift=0.5), r(96, scale=0.2, shift=0.5)
    w2, b2 = r(5, 5, 96, 256, scale=2 / 2400**0.5, shift=0.5), r(256, scale=0.2, shift=0.5)
    y1 = ck.conv2d_bias_relu(x, w1, b1, stride=4, padding=0)
    q1 = ck.maxpool2d(y1, window=3, stride=2)
    y2 = ck.conv2d_bias_relu(q1, w2, b2, stride=1, padding=2)
    q2 = ck.maxpool2d(y2, window=3, stride=2)
    return dict(x=x, w1=w1, b1=b1, w2=w2, b2=b2, y1=y1, q1=q1, y2=y2, q2=q2)


def kernel_phase(spec, peak_name) -> list:
    """Phase 2: every kernel at every main-path stage, fp32 and bf16."""
    import torch.nn.functional as F

    from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import cuda_kernels as ck

    lrn_kw = dict(size=5, alpha=1e-4, beta=0.75, k=2.0)
    rows = []
    for pol, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        gen = torch.Generator(device="cuda").manual_seed(2026)
        t = stage_inputs(dtype, gen)
        es = t["x"].element_size()
        stages = []
        convs = (("conv1", t["x"], t["w1"], t["b1"], 4, 0), ("conv2", t["q1"], t["w2"], t["b2"], 1, 2))
        for stage, x, w, b, s, p in convs:
            y = ck.conv2d_bias_relu(x, w, b, stride=s, padding=p)
            wl = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            n, ho, wo, k = y.shape
            stages.append(dict(
                kernel="conv2d", stage=stage,
                run=lambda x=x, w=w, b=b, s=s, p=p: ck.conv2d_bias_relu(x, w, b, stride=s, padding=p),
                plain=lambda x=x, w=w, b=b, s=s, p=p: ck.conv2d_bias_relu_plain(x, w, b, stride=s, padding=p),
                library=lambda x=x, wl=wl, b=b, s=s, p=p: F.conv2d(x.permute(0, 3, 1, 2), wl, b, stride=s, padding=p),
                library_call="F.conv2d (cuDNN, channels-last, bias, no ReLU)",
                flops=2 * n * ho * wo * k * w.shape[0] * w.shape[1] * w.shape[2],
                nbytes=(x.numel() + w.numel() + b.numel() + y.numel()) * es,
                peak=pol, rule=FP32_REL if pol == "fp32" else ("ulp", FP32_REL),
            ))
        for stage, x in (("pool1", t["y1"]), ("pool2", t["y2"])):
            y = ck.maxpool2d(x, window=3, stride=2)
            stages.append(dict(
                kernel="maxpool2d", stage=stage,
                run=lambda x=x: ck.maxpool2d(x, window=3, stride=2),
                plain=lambda x=x: ck.maxpool2d_plain(x, window=3, stride=2),
                library=lambda x=x: F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2),
                library_call="F.max_pool2d (channels-last)",
                flops=y.numel() * 9, nbytes=(x.numel() + y.numel()) * es, peak="fp32", rule="bitwise",
            ))
        x = t["q2"]
        stages.append(dict(
            kernel="lrn", stage="lrn2",
            run=lambda x=x: ck.lrn(x, **lrn_kw),
            plain=lambda x=x: ck.lrn_plain(x, **lrn_kw),
            # torch's LRN divides alpha by size: pass alpha*size for the same function
            library=lambda x=x: F.local_response_norm(x.permute(0, 3, 1, 2), 5, alpha=5e-4, beta=0.75, k=2.0),
            library_call="F.local_response_norm (alpha*size)",
            flops=x.numel() * 12, nbytes=2 * x.numel() * es, peak="fp32",
            rule=1e-6 if pol == "fp32" else ("ulp", 1e-6),
        ))
        for st in stages:
            res = compare(st["rule"], st["run"](), st["plain"]())
            torch.cuda.synchronize()
            bound, by = spec.bound_ms(st["flops"], st["nbytes"], st["peak"])
            row = dict(
                kernel=st["kernel"], stage=st["stage"], dtype=pol, **res,
                ms=gpu_time_ms(st["run"]), plain_ms=gpu_time_ms(st["plain"]),
                library_ms=gpu_time_ms(st["library"]), library_call=st["library_call"],
                bound_ms=bound, bound_by=by, flops=st["flops"], bytes=st["nbytes"],
                peak=f"{spec.name} {peak_name(st['peak'])}",
            )
            log(f"kernel {row['kernel']:9s} {row['stage']:5s} {pol}: ok={row['ok']} tol={row['tol']} "
                f"max_abs={row['max_abs_err']:.3g} max_rel={row['max_rel_err']:.3g} | ms={row['ms']:.4f} "
                f"plain={row['plain_ms']:.4f} library={row['library_ms']:.4f} bound={row['bound_ms']:.4f} ({by})")
            require(row["ok"], f"{row['kernel']} at {row['stage']} {pol} disagrees with its plain version: {res}")
            rows.append(row)
        del t, stages
        torch.cuda.empty_cache()
    return rows


def edge_phase() -> list:
    """Kernel against plain version at shapes off the main path: channel
    and pixel counts that are not tile multiples, stride 2, an odd channel
    count, other pool windows and LRN sizes, both alpha forms."""
    from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import cuda_kernels as ck

    gen = torch.Generator(device="cuda").manual_seed(7)
    results = []
    for pol, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        def r(*shape, scale=1.0, shift=0.0):
            return ((torch.rand(shape, generator=gen, device="cuda") - shift) * scale).to(dtype)

        for n, h, c, f, k, s, p in ((3, 45, 5, 3, 40, 2, 1), (2, 31, 96, 5, 72, 1, 2), (1, 45, 3, 11, 8, 4, 0)):
            x, w, b = r(n, h, h, c), r(f, f, c, k, scale=2 / (f * f * c) ** 0.5, shift=0.5), r(k, scale=0.2, shift=0.5)
            rule = FP32_REL if pol == "fp32" else ("ulp", FP32_REL)
            res = compare(rule, ck.conv2d_bias_relu(x, w, b, stride=s, padding=p),
                          ck.conv2d_bias_relu_plain(x, w, b, stride=s, padding=p))
            results.append((f"conv {n}x{h}x{h}x{c} F{f} K{k} s{s} p{p} {pol}", res))
        for shape, win, st in (((3, 14, 14, 40), 3, 2), ((2, 9, 9, 7), 2, 2), ((1, 8, 8, 3), 3, 1)):
            x = r(*shape, shift=0.5)
            res = compare("bitwise", ck.maxpool2d(x, window=win, stride=st),
                          ck.maxpool2d_plain(x, window=win, stride=st))
            results.append((f"pool {shape} {win}/{st} {pol}", res))
        for size, aos in ((5, False), (5, True), (3, False)):
            x = r(2, 5, 5, 40, scale=60, shift=0.5)
            kw = dict(size=size, alpha=1e-4, beta=0.75, k=2.0, alpha_over_size=aos)
            res = compare(1e-6 if pol == "fp32" else ("ulp", 1e-6), ck.lrn(x, **kw), ck.lrn_plain(x, **kw))
            results.append((f"lrn C40 size{size} alpha_over_size={aos} {pol}", res))
    torch.cuda.synchronize()
    for what, res in results:
        log(f"edge {what}: ok={res['ok']} max_abs={res['max_abs_err']:.3g}")
        require(res["ok"], f"edge case {what}: kernel disagrees with its plain version: {res}")
    return results


def block_cases(pol, gen):
    """Batch-128 inputs of both blocks under ``pol``: fp32 weights drawn as
    in ``stage_inputs``, cast to bf16, or quantized per channel for int8w.
    Block 2's input is block 1's kernel output."""
    from cuda_mpi_gpu_cluster_programming_tpu_torch.models.alexnet import BLOCKS12
    from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import cuda_kernels as ck
    from cuda_mpi_gpu_cluster_programming_tpu_torch.precision.quantize import quantize_channelwise

    def r(*shape, scale=1.0, shift=0.0):
        return (torch.rand(shape, generator=gen, device="cuda") - shift) * scale

    x = r(BATCH, 227, 227, 3)
    w1, b1 = r(11, 11, 3, 96, scale=2 / 363**0.5, shift=0.5), r(96, scale=0.2, shift=0.5)
    w2, b2 = r(5, 5, 96, 256, scale=2 / 2400**0.5, shift=0.5), r(256, scale=0.2, shift=0.5)
    cfg = BLOCKS12
    cases = []
    for name, cspec, pspec, lrn, w, b in (("block1", cfg.conv1, cfg.pool1, None, w1, b1),
                                          ("block2", cfg.conv2, cfg.pool2, cfg.lrn2, w2, b2)):
        cases.append(block_case(name, pol, x, w, b, cspec.stride, cspec.padding, pspec.window, pspec.stride, lrn))
        x = ck.conv_block(*cases[-1]["args"], **cases[-1]["kw"])
    return cases


def block_case(name, pol, x, w, b, stride, padding, pool_window, pool_stride, lrn):
    """One conv_block call under ``pol`` from fp32 ``w`` and ``b``: its
    arguments, its staged kernel chain and its cuDNN chain."""
    import torch.nn.functional as F

    from cuda_mpi_gpu_cluster_programming_tpu_torch.models.alexnet import ConvSpec, PoolSpec
    from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import cuda_kernels as ck
    from cuda_mpi_gpu_cluster_programming_tpu_torch.ops.kernel_model import _conv_then_pool
    from cuda_mpi_gpu_cluster_programming_tpu_torch.ops.variants import KernelVariants
    from cuda_mpi_gpu_cluster_programming_tpu_torch.precision.quantize import (
        int8w_conv_then_pool,
        quantize_channelwise,
    )

    kw = dict(stride=stride, padding=padding, pool_window=pool_window, pool_stride=pool_stride, lrn=lrn)
    cspec = ConvSpec(w.shape[3], w.shape[0], stride, padding)
    pspec = PoolSpec(pool_window, pool_stride)
    if pol == "int8w":
        q, s = quantize_channelwise(w)
        args, kw["scale"] = (x.to(torch.bfloat16), q, b), s
        staged = lambda a=args: int8w_conv_then_pool(a[0], q, s, b, cspec, pspec, tier="kernels", lrn=lrn)  # noqa: E731
        wl, bl = q.to(torch.bfloat16), b.to(torch.bfloat16)
    else:
        dt = torch.float32 if pol == "fp32" else torch.bfloat16
        args = (x.to(dt), w.to(dt), b.to(dt))
        staged = lambda a=args: _conv_then_pool(*a, cspec, pspec, KernelVariants(), lrn=lrn)  # noqa: E731
        wl, bl = args[1], args[2]
    wl = wl.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)

    def cudnn(a=args):
        y = F.relu(F.conv2d(a[0].permute(0, 3, 1, 2), wl, bl, stride=stride, padding=padding))
        y = F.max_pool2d(y, pool_window, pool_stride)
        if lrn is None:
            return y
        # torch's LRN divides alpha by size: pass alpha*size for the CUDA form
        alpha = lrn.alpha if lrn.alpha_over_size else lrn.alpha * lrn.size
        return F.local_response_norm(y, lrn.size, alpha=alpha, beta=lrn.beta, k=lrn.k)

    n, h, wd, c = args[0].shape
    f, k = w.shape[0], w.shape[3]
    ho, wo = (h - f + 2 * padding) // stride + 1, (wd - f + 2 * padding) // stride + 1
    hp, wp = (ho - pool_window) // pool_stride + 1, (wo - pool_window) // pool_stride + 1
    out_bytes = n * hp * wp * k * (4 if pol == "fp32" or (pol == "int8w" and lrn is not None) else 2)
    inputs = (*args, kw["scale"]) if pol == "int8w" else args
    return dict(
        name=name, args=args, kw=kw, staged=staged, cudnn=cudnn,
        flops=2 * n * ho * wo * k * f * f * c,
        fp32_flops=n * hp * wp * k * (pool_window**2 + (2 * lrn.size + 2 if lrn is not None else 0)),
        nbytes=sum(t.numel() * t.element_size() for t in inputs) + out_bytes,
        rule=FP32_REL if pol == "fp32" else ("ulp", FP32_REL, 2 if lrn is not None else 1),
    )


def block_phase(spec, peak_name) -> list:
    """Phase 2, fused: conv_block at both blocks in fp32, bf16 and int8w."""
    from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import cuda_kernels as ck

    rows = []
    for pol in ("fp32", "bf16", "int8w"):
        gen = torch.Generator(device="cuda").manual_seed(2027)
        for case in block_cases(pol, gen):
            args, kw = case["args"], case["kw"]
            run = lambda a=args, k=kw: ck.conv_block(*a, **k)  # noqa: E731
            plain = lambda a=args, k=kw: ck.conv_block_plain(*a, **k)  # noqa: E731
            got = run()
            res = compare(case["rule"], got, plain())
            if pol != "int8w":
                res["bitwise_staged"] = bool(torch.equal(got, case["staged"]()))
            torch.cuda.synchronize()
            bound, by = spec.bound_ms(case["flops"], case["nbytes"], pol, fp32_flops=case["fp32_flops"])
            row = dict(
                kernel="conv_block", stage=case["name"], dtype=pol, **res, out_dtype=str(got.dtype),
                ms=gpu_time_ms(run), plain_ms=gpu_time_ms(plain), staged_ms=gpu_time_ms(case["staged"]),
                library_ms=None, cudnn_chain_ms=gpu_time_ms(case["cudnn"]),
                cudnn_chain="F.conv2d -> F.relu -> F.max_pool2d (-> F.local_response_norm), channels-last"
                + ("; int8 values as bf16, no rescale" if pol == "int8w" else ""),
                bound_ms=bound, bound_by=by, flops=case["flops"], fp32_flops=case["fp32_flops"],
                bytes=case["nbytes"], peak=f"{spec.name} {peak_name(pol)}",
            )
            log(f"kernel conv_block {row['stage']} {pol}: ok={row['ok']} tol={row['tol']} "
                f"max_abs={row['max_abs_err']:.3g} max_ulps={row.get('max_ulps', 0):.2f} "
                f"bitwise_staged={res.get('bitwise_staged', 'n/a')} out={row['out_dtype']} | ms={row['ms']:.4f} "
                f"plain={row['plain_ms']:.4f} staged={row['staged_ms']:.4f} cudnn_chain={row['cudnn_chain_ms']:.4f} "
                f"bound={bound:.4f} ({by})")
            require(row["ok"], f"conv_block {row['stage']} {pol} disagrees with its plain version: {res}")
            require(res.get("bitwise_staged", True), f"conv_block {row['stage']} {pol} differs from the staged chain")
            rows.append(row)
        torch.cuda.empty_cache()
    return rows


def block_edge_phase() -> list:
    """conv_block against its plain version (and, fp32/bf16, bitwise
    against the staged chain) off the main path: odd channel counts, a
    ragged last band of pooled rows, LRN over more than 256 channels, both
    LRN alpha forms."""
    from cuda_mpi_gpu_cluster_programming_tpu_torch.models.alexnet import LrnSpec
    from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import cuda_kernels as ck

    gen = torch.Generator(device="cuda").manual_seed(8)
    results = []
    shapes = (
        # n, h, c, k, f, s, p, lrn: pooled rows 4 (45x45), 7 (67x67), 11 = 7 + 4 (99x99, odd C and K),
        # 15 = 7 + 7 + 1 with LRN alpha/size, and LRN over 300 channels (two chunks of 256)
        (2, 45, 3, 96, 11, 4, 0, None),
        (2, 67, 3, 96, 11, 4, 0, None),
        (3, 99, 5, 37, 11, 4, 0, None),
        (2, 31, 7, 40, 5, 1, 2, LrnSpec(5, 1e-4, 0.75, 2.0, alpha_over_size=True)),
        (2, 27, 96, 300, 5, 1, 2, LrnSpec(5, 1e-4, 0.75, 2.0)),
    )
    for pol in ("fp32", "bf16", "int8w"):
        for n, h, c, k, f, s, p, lrn in shapes:
            x = torch.rand((n, h, h, c), generator=gen, device="cuda") * (8.0 if lrn else 1.0)
            w = (torch.rand((f, f, c, k), generator=gen, device="cuda") - 0.5) * (2 / (f * f * c) ** 0.5)
            b = (torch.rand((k,), generator=gen, device="cuda") - 0.5) * 0.2
            case = block_case(f"{n}x{h}x{h}x{c} F{f} K{k} s{s} p{p} lrn={lrn}", pol, x, w, b, s, p, 3, 2, lrn)
            got = ck.conv_block(*case["args"], **case["kw"])
            res = compare(case["rule"], got, ck.conv_block_plain(*case["args"], **case["kw"]))
            if pol != "int8w":
                res["bitwise_staged"] = bool(torch.equal(got, case["staged"]()))
            results.append((f"conv_block {case['name']} {pol}", res))
    torch.cuda.synchronize()
    for what, res in results:
        log(f"edge {what}: ok={res['ok']} max_abs={res['max_abs_err']:.3g} "
            f"bitwise_staged={res.get('bitwise_staged', 'n/a')}")
        require(res["ok"] and res.get("bitwise_staged", True), f"edge case {what}: {res}")
    return results


def run_cli(argv) -> str:
    from cuda_mpi_gpu_cluster_programming_tpu_torch import run

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = run.main(argv)
    out = buf.getvalue()
    require(rc == 0, f"run.main {argv} returned {rc}:\n{out}")
    return out


STAGED = {"conv2d": 2, "maxpool2d": 2, "lrn": 1, "conv_block": 0}
FUSED = {"conv2d": 0, "maxpool2d": 0, "lrn": 0, "conv_block": 2}
INT8W_STAGED = {"conv2d": 2, "maxpool2d": 2, "lrn": 0, "conv_block": 0}  # the LRN is the fp32 reference op
NONE = {"conv2d": 0, "maxpool2d": 0, "lrn": 0, "conv_block": 0}
MAIN_RUNS = (
    # (config, policy, TPU_FRAMEWORK_FUSE, kernel launches per forward)
    ("v3_pallas", "fp32", "", STAGED), ("v3_pallas", "bf16", "", STAGED),
    ("v1_jit", "fp32", "", NONE), ("v1_jit", "bf16", "", NONE),
    ("v3_pallas", "fp32", "block", FUSED), ("v3_pallas", "bf16", "block", FUSED),
    ("v3_pallas", "int8w", "block", FUSED),
    ("v3_pallas", "int8w", "", INT8W_STAGED), ("v1_jit", "int8w", "", NONE),
)


def drive(key, pol, fuse, per_forward) -> dict:
    """One main-path run through ``run.main`` with ``TPU_FRAMEWORK_FUSE``
    set for the call and restored after; the launch counts are set to 0
    just before it and read just after."""
    from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import cuda_kernels as ck

    before = os.environ.get("TPU_FRAMEWORK_FUSE")
    os.environ["TPU_FRAMEWORK_FUSE"] = fuse
    try:
        ck.reset_launches()
        out = run_cli(["--config", key, "--dtype", pol, "--batch", str(BATCH), "--init", "random",
                       "--repeats", "10", "--warmup", "3"])
        launches = dict(ck.LAUNCHES)
    finally:
        if before is None:
            del os.environ["TPU_FRAMEWORK_FUSE"]
        else:
            os.environ["TPU_FRAMEWORK_FUSE"] = before
    name = f"{key}{'+fuse=' + fuse if fuse else ''}/{pol}"
    passes = int(re.search(r"^Kernel launches: .* passes=(\d+)$", out, re.M).group(1))
    shape = re.search(r"^Final Output Shape: (\S+)$", out, re.M).group(1)
    first10 = [float(v) for v in re.search(r"^Final Output \(first 10 values\): (.+)$", out, re.M).group(1).split()]
    ms = float(re.search(r"completed in ([0-9.]+) ms", out).group(1))
    log(f"main path {name}: {ms:.3f} ms/pass at batch {BATCH} ({BATCH / ms * 1e3:.1f} img/s) "
        f"launches={launches} passes={passes}")
    require(shape == "13x13x256", f"{name}: output shape {shape}")
    require(all(np.isfinite(first10)), f"{name}: non-finite output {first10}")
    want = {k: n * passes for k, n in per_forward.items()}
    require(passes > 0 and launches == want, f"{name}: launches {launches}, want {want}")
    return dict(per_pass_ms=ms, images_per_sec=BATCH / ms * 1e3, launches=launches, passes=passes, stdout=out)


def main_path_phase() -> dict:
    """Phase 3: the port's main paths through their entry points."""
    from cuda_mpi_gpu_cluster_programming_tpu_torch import configs
    from cuda_mpi_gpu_cluster_programming_tpu_torch.models import init
    from cuda_mpi_gpu_cluster_programming_tpu_torch.models.alexnet import BLOCKS12
    from cuda_mpi_gpu_cluster_programming_tpu_torch.ops.variants import KernelVariants
    from cuda_mpi_gpu_cluster_programming_tpu_torch.precision.gate import ToleranceGate

    result = {"runs": {}}
    for key, pol, fuse, per_forward in MAIN_RUNS:
        result["runs"][f"{key}{'+fuse=' + fuse if fuse else ''}/{pol}"] = drive(key, pol, fuse, per_forward)

    fused = KernelVariants(fuse="block")
    for key, v in (("v3_pallas", None), ("v3_pallas+fuse=block", fused), ("v1_jit", None)):
        fwd = configs.build_forward(configs.REGISTRY[key.split("+")[0]], variants=v)
        got = fwd(init.init_params_deterministic(), init.deterministic_input(1))[0].reshape(-1)[:10].cpu().numpy()
        log(f"golden {key}: {' '.join(f'{v:.4f}' for v in got)}")
        require(np.allclose(got, GOLDEN_FIRST10, rtol=2e-5, atol=0), f"{key} golden first-10 {got}")
        result[f"golden/{key}"] = got.tolist()

    rng = np.random.default_rng(2026)
    params = init.params_from_jax({
        "conv1": {"w": rng.random((11, 11, 3, 96), dtype=np.float32), "b": np.full(96, 0.1, np.float32)},
        "conv2": {"w": rng.random((5, 5, 96, 256), dtype=np.float32), "b": np.full(256, 0.1, np.float32)},
    })
    x = torch.from_numpy(rng.random((BATCH, 227, 227, 3), dtype=np.float32)).cuda()
    outs = {}
    for key, pol, fuse, _n in MAIN_RUNS:
        v = KernelVariants(fuse=fuse or "none") if key == "v3_pallas" else None
        outs[f"{key}{'+fuse=' + fuse if fuse else ''}/{pol}"] = configs.build_forward(
            configs.REGISTRY[key], policy=pol, variants=v)(params, x)
    oracle = outs["v1_jit/fp32"]
    omax = float(oracle.abs().max())
    for name, out in outs.items():
        pol = name.split("/")[-1]
        require(tuple(out.shape) == (BATCH, 13, 13, 256) and bool(torch.isfinite(out).all()), f"{name} output")
        err = float((out - oracle).abs().max())
        ok = (err <= FP32_ABS and err / omax <= FP32_REL) if pol == "fp32" else err / omax <= BUDGET_REL[pol]
        log(f"budget {name} vs v1_jit fp32: max_abs={err:.3g} rel_of_max={err / omax:.3g} ok={ok}")
        require(ok, f"{name} outside its budget against the fp32 oracle")
        result[f"budget/{name}"] = dict(max_abs=err, rel_of_max=err / omax)
    for pol in ("fp32", "bf16"):
        same = bool(torch.equal(outs[f"v3_pallas+fuse=block/{pol}"], outs[f"v3_pallas/{pol}"]))
        log(f"fused v3_pallas {pol} bitwise equal to staged v3_pallas {pol}: {same}")
        require(same, f"fused {pol} differs from the staged kernel chain")
    staged, fused_out = outs["v3_pallas/int8w"], outs["v3_pallas+fuse=block/int8w"]
    rel = float((fused_out - staged).abs().max() / staged.abs().max())
    log(f"budget fused int8w vs staged int8w: rel_of_max={rel:.3g} (budget {INT8W_REL})")
    require(rel <= INT8W_REL, "fused int8w outside the int8w budget of staged int8w")
    result["budget/fused_int8w_vs_staged_int8w"] = rel
    del outs, staged, fused_out

    # 45x45: (45 - 11) % 4 != 0, so conv1 ignores the last input rows/cols
    geo = dataclasses.replace(BLOCKS12, in_height=45, in_width=45)
    x45 = torch.from_numpy(rng.random((2, 45, 45, 3), dtype=np.float32)).cuda()
    o45 = [configs.build_forward(configs.REGISTRY[key], geo)(params, x45) for key in ("v3_pallas", "v1_jit")]
    err = float((o45[0] - o45[1]).abs().max())
    rel = err / float(o45[1].abs().max())
    log(f"budget 45x45 v3_pallas fp32 vs v1_jit fp32: shape={tuple(o45[0].shape)} "
        f"max_abs={err:.3g} rel_of_max={rel:.3g}")
    require(tuple(o45[0].shape) == (2, 1, 1, 256) and err <= FP32_ABS and rel <= FP32_REL, "45x45 forward")
    result["budget/45x45/fp32"] = dict(max_abs=err, rel_of_max=rel)

    # the fused blocks screened against the fp32 oracle at 227x227
    xs = x[:16]
    for pol in ("fp32", "bf16", "int8w"):
        res = ToleranceGate().screen_blocks(pol, params, xs, BLOCKS12)
        log(f"screen_blocks {pol} 227x227 batch {xs.shape[0]}: passed={res.passed} margin={res.margin:.4f} "
            + " ".join(f"{c.stage}: abs={c.max_abs:.3g} rel={c.max_rel:.3g}" for c in res.stages))
        require(res.passed and res.margin > 0, f"screen_blocks {pol}: {res.reason()}")
        result[f"screen_blocks/{pol}"] = res.to_obj()
    return result


def kernels_line(rows, runs) -> dict:
    """One entry per (kernel, dtype): times summed over the kernel's stages
    in one forward; launches from that dtype's main-path run of the route
    that launches the kernel (staged, or fused for conv_block)."""
    name, source, replaces, stages = BLOCK_KERNEL
    table = [(k, src, rep, st, pol, f"v3_pallas/{pol}") for k, (src, rep, st) in KERNELS.items() for pol in ("fp32", "bf16")]
    table += [(name, source, replaces, stages, pol, f"v3_pallas+fuse=block/{pol}") for pol in ("fp32", "bf16", "int8w")]
    entries = []
    for name, source, replaces, stages, pol, run_key in table:
        mine = [r for r in rows if r["kernel"] == name and r["dtype"] == pol]
        require([r["stage"] for r in mine] == list(stages), f"{name} {pol}: stages {mine}")
        run = runs[run_key]
        ms = sum(r["ms"] for r in mine)
        block = name == "conv_block"
        keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "max_abs_err", "max_rel_err", "tol")
        entries.append(dict(
            name=name, dtype=pol, route="cuda", source=source, replaces=replaces,
            launches=run["launches"][name], launches_per_forward=run["launches"][name] / run["passes"],
            max_abs_err=max(r["max_abs_err"] for r in mine), within_tolerance=all(r["ok"] for r in mine),
            ms=ms, kernel_ms=ms, plain_ms=sum(r["plain_ms"] for r in mine),
            bound_ms=sum(r["bound_ms"] for r in mine),
            # the stages' bounds add up; the label is the larger stage's
            bound_by=max(mine, key=lambda r: r["bound_ms"])["bound_by"],
            # no one library call computes a fused block: the cuDNN chain's time is a note beside it
            library_ms=None if block else sum(r["library_ms"] for r in mine),
            **(dict(staged_chain_ms=sum(r["staged_ms"] for r in mine),
                    cudnn_chain_ms_note=sum(r["cudnn_chain_ms"] for r in mine)) if block else {}),
            stages={r["stage"]: {k: r[k] for k in keys + (("staged_ms", "cudnn_chain_ms") if block else ())}
                    for r in mine},
        ))
    return {"kernels": entries}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs a CUDA GPU", file=sys.stderr)
        return 1
    from cuda_mpi_gpu_cluster_programming_tpu_torch.observability.specs import spec_for
    from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    spec, assumed = spec_for(kind)
    log(f"device: {kind} | nvidia-smi: {smi} | spec: {spec.name}{' (assumed)' if assumed else ''}")
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")

    info = _build.build()
    log(f"phase 1: kernel library {info.path} {'built' if info.built else 'cached'} in {info.seconds:.1f} s")
    for line in info.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    def peak_name(p):
        return f"fp32 {spec.fp32_tflops} TFLOP/s" if p == "fp32" else f"bf16 {spec.bf16_tflops} TFLOP/s (conv)"

    rows = kernel_phase(spec, peak_name) + block_phase(spec, peak_name)
    edges = edge_phase() + block_edge_phase()
    log("phase 2: every kernel agrees with its plain version, at the main path's shapes and off it")
    main = main_path_phase()
    log("phase 3: main path ran through the kernels, golden and budgets hold")
    line = kernels_line(rows, main["runs"])

    out_dir = Path("chip_smoke_out")
    out_dir.mkdir(exist_ok=True)
    # a diagnostic dump for the reader, never read back: a torn file costs nothing
    (out_dir / "chip_smoke.json").write_text(json.dumps(  # noqa: atomic-write
        dict(device=kind, nvidia_smi=smi, spec=spec.name, build_s=info.seconds, build_log=info.log,
             stages=rows, edge_cases=edges, main_path=main, kernels=line["kernels"]), indent=1, default=str))
    print(json.dumps(line), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
