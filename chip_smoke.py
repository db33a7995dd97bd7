#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --record   # only the records below, from this checkout
    python3 chip_smoke.py --flash-rows   # only the flash and relu rows, phases 3b, 3c and the staged passes
    python3 chip_smoke.py --pool-rows    # only the pool and lrn rows and the staged and phases passes, from this checkout

Run from the root of the repository, on a host with one CUDA GPU and the
CUDA toolkit (``nvcc``). ``--record`` builds the library and prints one
JSON line with what ``MAINLOOP_PTXAS``, ``FLASH_SWEEP_SHA256``,
``FLASH_BWD_TILES_SHA256``, ``FLASH_BWD_WIDE_SHA256``,
``FLASH_FWD_TILES_SHA256``, ``FLASH_FWD_WIDE_SHA256``,
``ENGINE_FP32_SHA256`` and ``POOL_LRN_SHA256`` hold a later tree to (run
it in a checkout of the tree to be recorded, with this file copied in), and
each digested output's own sha256. ``--flash-rows`` prints one JSON line
with phase 2's flash_fwd, flash_dq and flash_dkv rows (long_context's and
TINY_LM's shapes, D = 256 and 512) and relu rows, phases 3b and 3c and the
staged ``v3_pallas`` passes in fp32 and bf16; ``--pool-rows`` one with
phase 2's maxpool2d (pool1, pool2, the W stages), maxpool_phases (pool1, pool2), maxpool_s2d (the pool
A/B's pool1, pool2) and lrn rows and the staged ``v3_pallas``,
``v3_pallas`` with ``TPU_FRAMEWORK_POOL=phases`` and ``v1_jit`` passes in
fp32 and bf16 (two trees compared in one call, this file copied into
each). With no arguments, phases in order; a phase that
fails ends the run with a non-zero exit code and nothing is caught:

1. build the kernel library from ``cuda_mpi_gpu_cluster_programming_tpu_torch/csrc``;
   read ``ptxas -v``'s registers and spills of the kernels on the Hopper
   mainloop (``conv_sm90.cuh``): conv2d.cu's, conv_block.cu's,
   conv_pairs.cu's and conv_im2col.cu's must be ``MAINLOOP_PTXAS``, those
   before conv_taps.cu and conv_g8.cu joined the mainloop;
   read the flash instances' registers and spills (logged);
   1b. read its SASS (``cuobjdump --dump-sass``): every bf16 and int8w
   instance of the six mainloop files' kernels (conv2d.cu, conv_block.cu,
   conv_pairs.cu, conv_im2col.cu, conv_taps.cu, conv_g8.cu) and every bf16
   instance of flash_fwd.cu, flash_dq.cu and flash_dkv.cu at D = 16, 32, 64
   and 128 contains HMMA (the tensor cores), and at D = 256 and the
   windowed instance HMMA with fewer FFMA than HMMA, every fp32 one FFMA
   and no HMMA (no TF32); every vector instance of maxpool.cu, lrn.cu,
   maxpool_phases.cu and maxpool_s2d.cu (4 fp32, 8 bf16 lanes; the packs
   among them) issues 128-bit global loads (LDG.E.128);
2. at the main path's shapes (batch 128, 227x227x3), in fp32 and bf16, hold
   each staged kernel (conv1, conv2, pool1, pool2, lrn2) against its plain
   PyTorch version on the card, and time the kernel, the plain version and
   one PyTorch library call with CUDA events, beside the card's bound (the
   pool and LRN rows, the W stages among them, also the kernel's and the
   library call's device time by ``torch.profiler``, ``device_ms``; conv2
   fp32 also bitwise ``conv_taps``, whose stride-1 term order is vcol's, and
   the cuDNN kernels behind its library call named by ``torch.profiler``); then
   the conv and pool variants the autotuner sweeps: the taps, pairs,
   im2col ("fused") and g8 (conv1) conv kernels, the phases pool (its pack
   ``pool_phases_pack`` bitwise its plain pack, its kernel alone on the
   stack beside the bound of its own bytes), and the hpool epilogue
   and k_block modes of the vcol and taps convs with the pool's W stage,
   each against its plain version and timed the same way (taps, pairs,
   im2col and g8 with their packing, and the kernel alone on operands
   packed once), plus bitwise: pairs and im2col against taps (fp32 and
   bf16), and at conv2 all three against conv2d (bf16), g8 against a
   second launch,
   hpool + W stage against conv + maxpool2d (vcol, taps; conv1, conv2),
   k_block 64 and 128 against 0 (vcol, taps; conv2), phases against
   maxpool2d (pool1, pool2); then the fused ``conv_block`` kernel at both
   blocks in fp32, bf16 and int8w: against its plain version, bitwise
   against the staged kernel chain of the same block (fp32, bf16), timed
   beside that chain, its plain version, the cuDNN chain (a note: no one
   library call computes a block) and the bound; and every kernel again at
   edge shapes off the main path (an even-fq pairs case, a ragged output,
   C=5 with K=40, g8 at strides 2, 3 and 4 and at an odd K among them;
   pairs, im2col and g8 held there to the bitwise pins above); the pools
   and LRN off the main path and on signed zeros (``pool_lrn_edge_phase``:
   +0.0 wins over -0.0 in every pool kernel, the reference pool, the hpool
   conv + W stage and conv_block, NaN windows, C = 3, 7, 40 and 96 through
   the scalar and vector instances, views off 16-byte alignment, 2/2 and
   3/1 windows, LRN sizes 3 and 5 in both alpha forms, past one channel
   chunk); the fp32 taps and g8 outputs of ``engine_fp32_digest`` must
   hash to ``ENGINE_FP32_SHA256``, the bits of their older engine, and
   ``maxpool2d``, its W stage and ``lrn`` (``pool_lrn_digest``, inputs
   without -0.0) to ``POOL_LRN_SHA256``, the bits of the kernels before
   their Hopper redesign; then the LM
   slice's kernels in fp32 and bf16: ``relu`` at conv1's output (bitwise;
   its device time beside ``torch.relu``'s) and ``flash_fwd`` at
   ``long_context``'s defaults (1x4096x8x64) and at TINY_LM's attention (8x1024x4x32), causal and full, and at D = 256
   and 512 (1x4096x2xD, causal), a second launch bitwise the first, timed
   (CUDA events around a call and the kernel's own device time) beside SDPA,
   and off those shapes (the JAX tests' ragged blocks, D = 16 and 128, the
   zero-padded D = 8, 24 and 48, D = 256 and the padded D = 200, every D
   from 1 to 256 through the three flash kernels with the bits of
   ``FLASH_SWEEP_SHA256``, D = 257, 320 and 512 (1024 in fp32) through
   their windowed instance, strided q/k/v, relu on a
   NaN, -0.0 and an unaligned view); then the flash backward, ``flash_dq`` and
   ``flash_dkv``, in fp32 and bf16 at the same two shapes, causal and full,
   each against its plain version, a second launch bitwise the first and
   (fp32) autograd through ``ops.attention``, timed beside SDPA's backward,
   and off those shapes (the ragged blocks, D = 16, 128 and 256, the padded
   D = 8, 24, 48 and 200, an lse cotangent, strided q/k/v with a zero-stride dO,
   the joint (out, lse) gradient against the oracle, q/k/v/dO views off
   16-byte alignment through the three kernels bitwise contiguous copies,
   q/k/v mixing fp32 and bf16, a head axis of stride H and B or H of 65537
   through the three kernels against the plain versions (the operands the
   JAX kernel takes), every D from 1 to 128 in bf16 through the three
   kernels against the plain versions, and the fp32 bits of several tiles,
   ``FLASH_BWD_TILES_SHA256`` and the forward's ``FLASH_FWD_TILES_SHA256``,
   at D >= 256 ``FLASH_BWD_WIDE_SHA256`` and ``FLASH_FWD_WIDE_SHA256``);
   then the pool A/B's
   space-to-depth pool ``maxpool_s2d`` at pool1 and pool2 (batch 128,
   standard normal) in fp32 and bf16, bitwise against its plain version and
   maxpool2d, its pack ``s2d_pool_pack`` bitwise its plain pad and repack,
   the pack, the wrapper (pack included) and the kernel alone on its packed
   operand timed beside the plain version, ``F.max_pool2d`` and the bounds,
   and off those shapes (C = 20, 128 and 130, window/stride 2/2, 3/1 and
   5/3, H != W, NaN, -inf and -0.0 in the input, the pack from a view off
   16-byte alignment); then full AlexNet's new shapes in fp32 and bf16
   (``v6_kernel_phase``): conv2d at conv3, conv4 and conv5 (3x3, stride 1,
   pad 1 on 13x13; bitwise ``conv_taps``) and maxpool2d at pool5 against
   their plain versions and timed beside cuDNN / ``F.max_pool2d`` and the
   bound, the hpool conv5 with its W stage (bitwise conv5 + maxpool2d) and
   ``conv_block`` at block 5 (bitwise its staged chain), and untimed: taps
   against its plain version, pairs and im2col bitwise taps (conv3..conv5),
   k_block 64 and 128 bitwise 0 at conv4 (conv2d, taps), the taps hpool and
   the phases pool bitwise at pool5;
3. drive the main path through ``run.main``, each run with the kernels'
   launch counts set to 0 just before it and read just after: ``v3_pallas``
   and ``v1_jit`` in fp32 and bf16 (staged), ``v3_pallas`` with
   ``TPU_FRAMEWORK_FUSE=block`` in fp32, bf16 and int8w, ``--dtype int8w``
   staged on both tiers, and ``v3_pallas`` with ``TPU_FRAMEWORK_CONV=taps``,
   ``pairs``, ``fused`` and ``g8``, ``POOL=phases``, ``FUSE=hpool`` and
   ``KBLOCK=128`` in fp32 and bf16 (taps also in int8w), batch 128; check
   ``CONV=pairs`` and ``fused`` bitwise ``CONV=taps`` in fp32 and in bf16
   (one mainloop, one term order), the golden first-10 on every fp32
   kernel route, every route against
   ``v1_jit`` fp32 on numpy-seeded random params within the precision
   budgets, fused int8w against staged int8w, and
   ``ToleranceGate().screen_blocks`` at 227x227 for fp32, bf16 and int8w;
   then full AlexNet (``v6_path_phase``): ``v6_full_pallas`` staged,
   ``FUSE=block`` and ``FUSE=hpool`` and ``v6_full_jit``, each in fp32 and
   bf16 at batch 128, shape 1000, launches (staged conv2d 5, maxpool2d 3,
   lrn 1; block conv_block 3, conv2d 2; ``v6_full_jit`` none), every route
   against ``v6_full_jit`` fp32 on He-scaled params (fp32 rtol 2e-5, atol
   2e-4; bf16 2e-2 of the max), the fused routes bitwise staged in fp32;
   the flags ``--save-params``/``--params`` (the same first-10),
   ``--input native`` on both tiers, ``--trace`` (one ``run.measure``
   span), the one chaos drill (``CHAOS_SPEC=kernel_compile=1 --fallback-chain
   auto``: ``DEGRADED(v6_full_pallas -> v6_full_jit)``, no kernel launched;
   no other run may print ``DEGRADED``) and ``--breakdown`` on both tiers
   in fp32 and bf16 (12 layers);
   3b. the transformer LM's forward family, launch counts set to 0 before
   each run and read after: ``examples.long_context.main`` at its defaults
   (``--strategy flash --verify`` fp32 and bf16, one flash_fwd launch per
   call; ``--strategy single``), and at TINY_LM, batch 8, L=1024,
   ``forward_lm`` flash against reference (2 launches per forward, TF32
   turned off by the path itself) in fp32 and bf16, ``lm_loss``,
   ``decode_logits`` against ``forward_lm`` and greedy ``generate`` (32
   steps); then the unfused conv1 -> relu sequence, bitwise the fused conv;
   3c. the LM's training, launch counts set to 0 before each run and read
   after: at TINY_LM, batch 8 x 1025 tokens, one ``make_lm_train_step``
   step with flash and one with the reference attention in fp32 and in bf16
   mixed precision (losses and every gradient leaf compared; flash_fwd,
   flash_dq and flash_dkv 2 launches each a step), the counts again with
   ``accum_steps=2`` (4 each) and ``remat`` (flash_fwd 4), ms a step and
   tok/s, and a ``torch.profiler`` split of a step's device time; then
   ``examples.lm.main`` at its defaults with ``--attn flash --generate 16``
   in fp32 and with ``--compute bf16``, every line PASSED;
   3d. the pool A/B, ``pool_ab.main`` at batch 128 for pool1 and pool2 in
   fp32 and bf16, launch counts set to 0 before each run and read after:
   six rows in the JAX script's order, every compared strategy bitwise
   ``F.max_pool2d`` (no ``mismatch``, no ``error``), s2d_pool_pack,
   maxpool_s2d, pool_phases_pack, maxpool_phases and maxpool2d launched;
   3e. the bench, ``python -m <port>.bench`` in a subprocess (the library
   warm from phase 1), three calls at batch 128: ``BENCH_CONFIGS=v1_jit,
   v3_pallas BENCH_DTYPE=fp32`` (each row with its ``bf16`` sub-object),
   ``v3_pallas`` int8w, and ``v3_pallas`` bf16 with
   ``TPU_FRAMEWORK_FUSE=block``: every row has no ``error``, ``value`` > 0,
   ``platform`` gpu, ``mfu`` in (0, 1], ``fp32_ceiling_fraction`` in (0, 1]
   on fp32 rows and null on the others, a ``breakdown`` whose stages
   (conv1..lrn2, or block1 and block2 when fused) sum to its ``total_ms``
   and a ``roofline`` beside it (int8w: both skipped, with the reason);
   each row is printed beside phase 3's ``run.main`` reading of its route.
   The breakdown's full prefix launches what the pass launches (conv2d 2,
   maxpool2d 2, lrn 1; fused conv_block 2), counted in this process; then
   ``run.main --breakdown --profile DIR`` on ``v3_pallas`` and
   ``v1_jit --breakdown`` exit 0, one ``Layer`` line per layer, and the
   Chrome trace exists;
   3f. the inference service (``serving/``) at 227x227, ``max_batch`` 8, for
   ``v1_jit`` fp32 and ``v3_pallas`` fp32 and bf16: each server warms (one
   CUDA graph captured per bucket) and drains the request sizes
   ``SERVE_SIZES``, the launch counts set to 0 just before the drain and
   read after (a replay adds the launches its capture recorded); every
   result bitwise the eager forward on its padded bucket, sliced, the
   ``v3_pallas`` results within the fp32/bf16 budgets of the ``v1_jit``
   fp32 server's, no cache miss; per ``v3_pallas`` bucket (1, 2, 4, 8) the
   graph's kernel nodes as CUDA prints them (``CUDAGraph.debug_dump``):
   conv2d 2, maxpool2d 2, lrn 1, equal to what its capture counted, no
   cuDNN or cuBLAS conv; the drained run's counts equal to the sum of its
   dispatches' graphs' nodes; and the dispatch's host ms, graph against
   the eager forward on the same static input; a threaded ``run_load`` at
   50 req/s for 3 s with no failure (``v3_pallas`` fp32); the kernels at
   bucket 8's shapes against their plain versions, timed (the kernels
   line's serve entries); ``python -m <port>.bench`` with
   ``BENCH_MODE=serve`` and ``saturate`` (``v3_pallas`` fp32): no
   ``error``, ``platform`` gpu, ``value`` > 0, no cache miss, and
   ``percentiles_agree`` on every saturate row; and ``run.main --serve
   --serve-frontend 0 --traffic-shape diurnal+burst`` on ``v3_pallas``
   (exit 0, the ``Serve frontend:`` line, no failure, no cache miss);
   3g. the control loop (``serving/controller.py``, ``observability/replay.py``
   and ``gate.py``) at 227x227, ``max_batch`` 8, on a ``v3_pallas`` bf16
   server with the controller on: built first, it drains ``SERVE_SIZES``
   (bitwise phase 3f's bf16 results, the same batches), then the controller,
   fed 128 late protected-class outcomes before each evaluation on an
   injected clock past its cooldown and dwell, walks ``tighten_admission``
   bulk, then batch, ``narrow_buckets`` (bucket 8 dropped, its graph
   released), ``downshift_dtype`` (a ``gate_pass`` and an int8w
   ``serve_rewarm`` journaled, every bucket captured again: conv2d 2,
   maxpool2d 2 kernel nodes, its LRN the fp32 reference op), and on on-time
   outcomes back up in reverse (``upshift_dtype`` recaptures bf16,
   ``widen_buckets`` captures bucket 8 again). After every rung the stream
   is drained (a request wider than the largest bucket rejected at the
   door), the launch counts set to 0 just before and read just after: each
   result bitwise the live policy's eager forward on its padded batch, the
   int8w ones within 6e-2 of the max of the ``v1_jit`` fp32 forward's, the
   counts the live graphs' kernel nodes summed over the dispatches, no cache
   miss; after the upshift the batches assembled as phase 3f's are bitwise
   its results, and at the bottom of the ladder the whole stream is. Then
   ``evaluate``'s cost (2000 calm calls), int8w under the graph at every
   bucket (graph against eager, as 3f times bf16), the int8w kernels at
   bucket 8 against their plain versions (the kernels line's int8w serve
   entries); 3f's Poisson 50 req/s ``v3_pallas`` fp32 run recorded into a
   journal of its own and replayed neutrally (accounting identical, no
   divergence; p50/p99 pairs with their resolutions) and at
   ``traffic_mult`` 2 (twice the offered requests); and ``python -m
   <port>.bench`` with ``BENCH_MODE=replay`` on that journal (exit 0),
   ``gate`` over 3e's fp32 rows (``v1_jit``, then ``v3_pallas``) as two
   rounds in ``chip_smoke_out/gate/`` (the in-process verdict, exit by it)
   and ``control`` on ``v3_pallas`` (both sides' books closed, no
   divergence, actions on the ON side, none on the calm trace; the
   protected class's burn off and on is printed: its clause is read, not
   required). ``python3 chip_smoke.py --control`` runs this phase alone;
4. the autotuner: ``run.main --config v3_pallas --tune`` at 227x227, batch
   32, sweeping fp32, bf16 and int8w with the gate journaled and
   preflighted; it must print ``Tune plan: swept``, every dtype's plan must
   show no failed candidate and no degraded layer, the gate journal must
   hold a ``gate_pass`` for fp32, and a second identical call must print
   ``Tune plan: cache``. Each layer's winner is printed with its
   ``best_ms`` and ``default_ms``; then ``--config v6_full_pallas --tune
   --dtype fp32`` at batch 32 (the single-dtype sweep over five conv
   layers): ``swept`` with no failed candidate, then ``cache``.

Then it prints the ``{"kernels": [...]}`` line, the card's name and power
limit, and last the ``{"ok": true, "device": ...}`` line. The kernels
line carries, beside each kernel's Blocks 1-2 entries, full AlexNet's
(``model`` ``alexnet_full``): conv2d, maxpool2d, lrn and conv_block summed
over their stages in one ``v6_full_pallas`` forward, and the serve path's
(``path`` ``serve``): conv2d, maxpool2d and lrn at bucket 8's shapes, with
the launches of the drained run (counted at its replays) and of one dispatch (bucket 8's graph's kernel
nodes), in fp32 and bf16 (phase 3f) and in int8w (phase 3g: conv2d and maxpool2d,
the launches of the ladder's int8w drain). Details of every
phase also go to ``chip_smoke_out/chip_smoke.json`` (listed in ``.gitignore``).

Tolerances, kernel against plain version on the same inputs:
- conv fp32: max |diff| <= 1e-5 x max |plain|. Both accumulate in fp32 in
  different orders (one FMA chain per output; per-tap matmuls);
- conv and LRN bf16: per element, 1 bf16 ulp (where that order flips the
  one rounding to bf16) plus the fp32 term above (1e-5, LRN 1e-6, of the
  max), which dominates where a sum cancels to near zero;
- pool, phases pool, W stage and s2d pool: bitwise (max is exact), NaN
  bits and the sign of a zero included (+0.0 over -0.0, ``jnp.maximum``'s);
  the two packs: bitwise (they only move and zero-fill);
- LRN fp32: max |diff| <= 1e-6 x max |plain| (same sums, same powf; the
  kernel also keeps the bits of its first design, ``POOL_LRN_SHA256``);
- conv_block fp32: 1e-5 x max |plain|, as conv; bf16 and int8w: 1 bf16 ulp
  + 1e-5 of the max, and 2 ulps for a block that ends in LRN: a one-ulp
  flip of the bf16 interior (the conv's other summation order) moves the
  LRN result, which is then rounded once more; against the staged kernel
  chain, fp32 and bf16: bitwise;
- relu: bitwise (NaN bits included);
- flash_fwd out: fp32 2e-6 x max |v| (one fp32 recurrence, other sum
  orders; out mixes v's rows, so its error scales with v), bf16 1 ulp +
  that term: at every D the p v product runs on the tensor cores with p
  split into two bf16 terms (one misses the rule 38-79x,
  ``tests/test_torch_attention.py``); lse 1e-6 x its max; out against the
  O(L^2) oracle 2e-5 (fp32) or 3e-2 (bf16) abs + rel, the JAX flash tests';
  a second launch bitwise the first; the fp32 bits are held by
  ``FLASH_SWEEP_SHA256``, ``FLASH_FWD_TILES_SHA256`` and
  ``FLASH_FWD_WIDE_SHA256``;
- flash_dq, flash_dkv: fp32 max |diff| <= 1e-5 x max |plain| for each
  output (the same fp32 recompute, sums in another order; the fp32 bits
  are also held by ``FLASH_SWEEP_SHA256``), bf16 1 ulp plus that term: at
  D <= 128 the kernels run the second products on the tensor cores with p
  and dS split into two bf16 terms (16 significant bits against the plain
  versions' fp32; one term misses the rule by 24-62x,
  ``tests/test_torch_attention.py``); a second launch bitwise the first (no
  atomics); fp32 against autograd through the oracle 5e-5 abs + rel (the
  JAX tests' gradient tolerance), the joint (out, lse) gradient 1e-4.
Main path: ``precision/gate.py`` budgets of the JAX package: fp32 1e-4 abs
and 1e-5 of the max; bf16 2e-2 and int8w 6e-2 of the max against the fp32
oracle. Full AlexNet: fp32 rtol 2e-5 and atol 2e-4 against ``v6_full_jit``
fp32 (the JAX package's own cross-tier tolerance of the full model), bf16
2e-2 of the max. LM: flash against reference and decode against forward, rtol 1e-4
/ atol 2e-4 (``tests/test_decode.py``), bf16 rtol 0.1 / atol 0.3 (the same
file's bf16 parity). Training, flash against reference: the loss within
1e-5 rel (fp32; bf16 1e-2: bf16 logits round in other places), every
gradient leaf within 1e-3 (fp32) or 5e-2 (bf16) of its max |grad|.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

GOLDEN_FIRST10 = [29.2932, 25.9153, 23.3255, 23.3255, 23.3255, 23.3255, 23.3255, 23.3255, 23.3255, 23.3255]
BATCH = 128
TIMED_REPS = 25
TPU_FILE = "cuda_mpi_gpu_cluster_programming_tpu/ops/pallas_kernels.py"
PORT = "cuda_mpi_gpu_cluster_programming_tpu_torch"
KERNELS = {
    # name: (source, TPU kernel it replaces, stages on the main path, the route's run)
    "conv2d": (f"{PORT}/csrc/conv2d.cu", f"{TPU_FILE}:434", ("conv1", "conv2"), ""),
    "maxpool2d": (f"{PORT}/csrc/maxpool.cu", f"{TPU_FILE}:963", ("pool1", "pool2"), ""),
    "lrn": (f"{PORT}/csrc/lrn.cu", f"{TPU_FILE}:1024", ("lrn2",), ""),
    "conv_taps": (f"{PORT}/csrc/conv_taps.cu", f"{TPU_FILE}:399", ("conv1", "conv2"), "+CONV=taps"),
    "conv_pairs": (f"{PORT}/csrc/conv_pairs.cu", f"{TPU_FILE}:380", ("conv1", "conv2"), "+CONV=pairs"),
    "conv_im2col": (f"{PORT}/csrc/conv_im2col.cu", f"{TPU_FILE}:328", ("conv1", "conv2"), "+CONV=fused"),
    # g8 packs phases of a strided conv: conv1 (stride 4); conv2 (stride 1) runs vcol on that route
    "conv_g8": (f"{PORT}/csrc/conv_g8.cu", f"{TPU_FILE}:476", ("conv1",), "+CONV=g8"),
    # the phases pool's one-pass pack of its stack replaces the JAX lowering's _pool_phases (XLA ops, no Pallas)
    "pool_phases_pack": (f"{PORT}/csrc/maxpool_phases.cu", f"{TPU_FILE}:910", ("pool1", "pool2"), "+POOL=phases"),
    "maxpool_phases": (f"{PORT}/csrc/maxpool_phases.cu", f"{TPU_FILE}:889", ("pool1", "pool2"), "+POOL=phases"),
}
BLOCK_KERNEL = ("conv_block", f"{PORT}/csrc/conv_block.cu",
                "cuda_mpi_gpu_cluster_programming_tpu/ops/megakernel.py:111", ("block1", "block2"))
# the transformer LM's forward family: the standalone ReLU and the flash-attention forward
FLASH_FILE = "cuda_mpi_gpu_cluster_programming_tpu/ops/flash_attention.py"
LM_KERNELS = {
    # name: (source, TPU kernel it replaces)
    "relu": (f"{PORT}/csrc/relu.cu", f"{TPU_FILE}:1084"),
    "flash_fwd": (f"{PORT}/csrc/flash_fwd.cu", f"{FLASH_FILE}:60"),
    "flash_dq": (f"{PORT}/csrc/flash_dq.cu", f"{FLASH_FILE}:184"),
    "flash_dkv": (f"{PORT}/csrc/flash_dkv.cu", f"{FLASH_FILE}:217"),
}
# the pool A/B's space-to-depth pool and its one-pass pad and repack (pool_s2d128's jnp.pad and _space_to_depth,
# XLA ops there): name: (source, what it replaces); their run is pool_ab
S2D_KERNELS = {"s2d_pool_pack": (f"{PORT}/csrc/maxpool_s2d.cu", "scripts/pool_ab.py:76"),
               "maxpool_s2d": (f"{PORT}/csrc/maxpool_s2d.cu", "scripts/pool_ab.py:63")}
POOL_AB_SHAPES = {"pool1": (55, 55, 96), "pool2": (27, 27, 256)}  # pool_ab.POOL_SHAPES, window 3, stride 2
# the flash backward kernels: FLOPs per B H L^2 D (2 per multiply-add of each product: dQ 3 products,
# dK/dV 4, as the TPU kernels count them; half when causal) and (B, L, H, D) tensors moved once
# (dQ reads q, k, v, dO and writes dq; dK/dV also writes dv), beside the fp32 lse and delta (B, H, L)
FLASH_BWD_WORK = {"flash_dq": (6, 5), "flash_dkv": (8, 6)}
BWD_PLAIN_REL = 1e-5  # against the plain version: max |diff| <= 1e-5 x max |plain| (bf16: + 1 ulp)
BWD_ORACLE_TOL = 5e-5  # fp32 against autograd through ops.attention: tests/test_flash_attention.py's grad tolerance
JOINT_TOL = 1e-4  # the joint (out, lse) gradient against the oracle: test_with_lse_joint_vjp_matches_oracle's
# training, flash against reference at TINY_LM: the loss (fp32 rtol; bf16: the bf16 logits' rounding
# moves it) and every gradient leaf within a share of its max |grad|
TRAIN_LOSS_RTOL = {"fp32": 1e-5, "bf16": 1e-2}
TRAIN_GRAD_REL = {"fp32": 1e-3, "bf16": 5e-2}
TRAIN_STEPS_TIMED = 10
LONG_CONTEXT = (1, 4096, 8, 64)  # examples.long_context's defaults: B, L, H, D
LM_BATCH = 8
TINY_LM_ATTN = (LM_BATCH, 1024, 4, 32)  # TINY_LM's attention at batch 8 and L = max_len
FLASH_D256 = (1, 4096, 2, 256)  # the widest single-window head dim, at long_context's length (causal, timed)
FLASH_D512 = (1, 4096, 2, 512)  # two windows of 256 output columns, at the same length (causal, timed)
# the head dims above 256 held against their plain versions off the main path (1024 in fp32 only)
FLASH_WIDE_DIMS = (257, 320, 512)
# sha256 of the bits of out, lse, dq, dk and dv of every head dim 1..256 in head_dim_sweep, as the kernels
# gave them before the windowed instance above 256 was added (NVIDIA H100 build, CUDA 12.8; ``python3
# chip_smoke.py --record`` in a checkout of that tree prints it): at D <= 256 the kernels keep their bits
FLASH_SWEEP_SHA256 = "0c54a79f6053858e053539389439963860e0b0c16fae952de21261812054a818"
FLASH_REF_TOL = {"fp32": 2e-5, "bf16": 3e-2}  # tests/test_flash_attention.py, abs and rel against the oracle
# flash_fwd against its plain version: out within 2e-6 x max |v| (the same fp32 recurrence, sums in
# another order; out is a convex mix of v's rows, so its error scales with v, not with out, which
# averages toward 0 over a long full row); bf16 1 ulp + that term (one rounding of an fp32 result);
# lse within 1e-6 x its max
FLASH_PLAIN_V_REL = 2e-6
LSE_REL = 1e-6
LM_RTOL, LM_ATOL = 1e-4, 2e-4  # tests/test_decode.py's fp32 parity
LM_BF16_RTOL, LM_BF16_ATOL = 0.1, 0.3  # tests/test_decode.py's bf16 parity
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


def device_time_ms(fn, marker: str = "", reps: int = 10):
    """Device time from ``torch.profiler`` over ``reps`` calls after a warm
    one, without the host's time before a launch that a pair of CUDA events
    around one call also counts: with ``marker``, the mean of the kernels
    whose name holds it (one a call); without, the sum of a call's kernels
    and copies. None when the trace shows no device time (not measured)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and marker in e.key]
    total, count = sum(e.self_device_time_total for e in events), sum(e.count for e in events)
    if total <= 0:
        return None
    return total / 1e3 / (count if marker else reps)


def _fmt(ms) -> str:
    """A time for the log: 4 decimals, or "not measured" (None)."""
    return "not measured" if ms is None else f"{ms:.4f}"


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
                   max_ulps=float((diff / ulp).max()), max_share=float((diff / slack).max()))
    else:
        res.update(tol=f"{rule:g} x max|plain|", ok=res["max_rel_err"] <= rule)
    return res


def stage_inputs(dtype, gen, batch: int = BATCH):
    """The main path's tensors at ``batch`` (128; the serve path's largest
    bucket, 8): input, zero-mean weights (so ReLU clamps), and each stage's
    input as the kernel chain produces it."""
    from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import cuda_kernels as ck

    def r(*shape, scale=1.0, shift=0.0):
        return ((torch.rand(shape, generator=gen, device="cuda") - shift) * scale).to(dtype)

    x = r(batch, 227, 227, 3)
    w1, b1 = r(11, 11, 3, 96, scale=2 / 363**0.5, shift=0.5), r(96, scale=0.2, shift=0.5)
    w2, b2 = r(5, 5, 96, 256, scale=2 / 2400**0.5, shift=0.5), r(256, scale=0.2, shift=0.5)
    y1 = ck.conv2d_bias_relu(x, w1, b1, stride=4, padding=0)
    q1 = ck.maxpool2d(y1, window=3, stride=2)
    y2 = ck.conv2d_bias_relu(q1, w2, b2, stride=1, padding=2)
    q2 = ck.maxpool2d(y2, window=3, stride=2)
    return dict(x=x, w1=w1, b1=b1, w2=w2, b2=b2, y1=y1, q1=q1, y2=y2, q2=q2)


LRN2_KW = dict(size=5, alpha=1e-4, beta=0.75, k=2.0)  # BLOCKS12.lrn2, the CUDA alpha form


def pool_stage(stage, x) -> dict:
    """The maxpool2d row of a 3x3/2 pool stage on ``x``, its device time
    (``device_ms``) read from the kernels named ``*pool*``."""
    import torch.nn.functional as F

    from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import cuda_kernels as ck

    n, h, w, c = x.shape
    out = n * ((h - 3) // 2 + 1) * ((w - 3) // 2 + 1) * c
    return dict(
        kernel="maxpool2d", stage=stage, marker="pool",
        run=lambda x=x: ck.maxpool2d(x, window=3, stride=2),
        plain=lambda x=x: ck.maxpool2d_plain(x, window=3, stride=2),
        library=lambda x=x: F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2),
        library_call="F.max_pool2d (channels-last)",
        flops=out * 9, nbytes=(x.numel() + out) * x.element_size(), peak="fp32", rule="bitwise",
    )


def w_stage(stage, y_h, unfused, after) -> dict:
    """The maxpool2d row of the 1x3/(1,2) W stage on an hpool conv's output
    ``y_h``, bitwise ``unfused`` (conv + maxpool2d)."""
    import torch.nn.functional as F

    from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import cuda_kernels as ck

    n, hp, w, k = y_h.shape
    out = n * hp * ((w - 3) // 2 + 1) * k
    return dict(
        kernel="maxpool2d", stage=stage, mode=f"W stage after {after}", marker="pool",
        run=lambda y=y_h: ck.maxpool2d_w(y, window=3, stride=2),
        plain=lambda y=y_h: ck.maxpool_rect_plain(y, window=(1, 3), stride=(1, 2)),
        library=lambda y=y_h: F.max_pool2d(y.permute(0, 3, 1, 2), (1, 3), (1, 2)),
        library_call="F.max_pool2d (1x3 / 1x2, channels-last)",
        flops=out * 3, nbytes=(y_h.numel() + out) * y_h.element_size(), peak="fp32",
        rule="bitwise", same_as=[(f"{after}+maxpool2d", unfused)],
    )


def lrn_stage(x, pol) -> dict:
    """The lrn row at lrn2 (``LRN2_KW``) on ``x``."""
    import torch.nn.functional as F

    from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import cuda_kernels as ck

    return dict(
        kernel="lrn", stage="lrn2", marker="lrn",
        run=lambda x=x: ck.lrn(x, **LRN2_KW),
        plain=lambda x=x: ck.lrn_plain(x, **LRN2_KW),
        # torch's LRN divides alpha by size: pass alpha*size for the same function
        library=lambda x=x: F.local_response_norm(x.permute(0, 3, 1, 2), 5, alpha=5e-4, beta=0.75, k=2.0),
        library_call="F.local_response_norm (alpha*size)",
        flops=x.numel() * 12, nbytes=2 * x.numel() * x.element_size(), peak="fp32",
        rule=1e-6 if pol == "fp32" else ("ulp", 1e-6),
    )


def packed_pool_stage(kernel, stage, x) -> dict:
    """The ``maxpool_phases`` or ``maxpool_s2d`` row of a 3x3/2 pool stage on
    ``x``: the wrapper (its pack, then its pool kernel), bitwise its plain
    version and maxpool2d; ``device_ms`` the pool kernel alone (the kernels
    named ``<kernel>*``), ``wrapper_device_ms`` every kernel of a call (the
    pack's device time is the difference)."""
    import torch.nn.functional as F

    from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import cuda_kernels as ck

    n, h, w, c = x.shape
    out = n * ((h - 3) // 2 + 1) * ((w - 3) // 2 + 1) * c
    return dict(
        kernel=kernel, stage=stage, marker=kernel, packs=True,
        run=lambda x=x: getattr(ck, kernel)(x, window=3, stride=2),
        plain=lambda x=x: getattr(ck, f"{kernel}_plain")(x, window=3, stride=2),
        library=lambda x=x: F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2),
        library_call="F.max_pool2d (channels-last)",
        flops=out * 9, nbytes=(x.numel() + out) * x.element_size(), peak="fp32", rule="bitwise",
        same_as=[("maxpool2d", lambda x=x: ck.maxpool2d(x, window=3, stride=2))],
    )


def pack_stage(kernel, stage, x, run, plain) -> dict:
    """A pack's row (``pool_phases_pack``, ``s2d_pool_pack``): bitwise its
    plain pack, beside the bound of x read once and its operand written once
    (no one PyTorch call computes a pack); ``device_ms`` the pack kernel."""
    return dict(kernel=kernel, stage=stage, run=run, plain=plain, library=None, library_call=None, flops=0,
                nbytes=(x.numel() + run().numel()) * x.element_size(), peak="fp32", rule="bitwise", marker=kernel)


def packed_pool_rows(pack_st, pool_st, operand, pol, spec, peak_name) -> list:
    """The pack's row and the pool's, the pool kernel alone (``alone``) on
    the packed ``operand`` timed beside the bound of its own bytes (operand
    read once, output written once) and bitwise the wrapper; the pool row
    carries the pack's ``pack_ms`` and ``pack_bound_ms``."""
    pack = measure(pack_st, pol, spec, peak_name)
    got = pool_st["run"]()
    pool_st.update(alone_bytes=(operand.numel() + got.numel()) * got.element_size())
    pool = measure(pool_st, pol, spec, peak_name)
    require(torch.equal(pool_st["alone"](), got), f"{pool['kernel']} {pool['stage']} {pol}: the kernel alone "
            "differs from the wrapper")
    pool.update(pack_ms=pack["ms"], pack_bound_ms=pack["bound_ms"], operand_shape=list(operand.shape),
                operand_bytes=operand.numel() * operand.element_size())
    return [pack, pool]


def kernel_phase(spec, peak_name, batch: int = BATCH) -> list:
    """Phase 2: every kernel at every main-path stage, fp32 and bf16 (at
    ``batch``: 128, or the serve path's bucket 8 in phase 3f)."""
    import torch.nn.functional as F

    from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import cuda_kernels as ck

    rows = []
    for pol, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        gen = torch.Generator(device="cuda").manual_seed(2026)
        t = stage_inputs(dtype, gen, batch)
        es = t["x"].element_size()
        stages = []
        convs = (("conv1", t["x"], t["w1"], t["b1"], 4, 0), ("conv2", t["q1"], t["w2"], t["b2"], 1, 2))
        for stage, x, w, b, s, p in convs:
            y = ck.conv2d_bias_relu(x, w, b, stride=s, padding=p)
            wl = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            n, ho, wo, k = y.shape
            st = dict(
                kernel="conv2d", stage=stage,
                run=lambda x=x, w=w, b=b, s=s, p=p: ck.conv2d_bias_relu(x, w, b, stride=s, padding=p),
                plain=lambda x=x, w=w, b=b, s=s, p=p: ck.conv2d_bias_relu_plain(x, w, b, stride=s, padding=p),
                library=lambda x=x, wl=wl, b=b, s=s, p=p: F.conv2d(x.permute(0, 3, 1, 2), wl, b, stride=s, padding=p),
                library_call="F.conv2d (cuDNN, channels-last, bias, no ReLU)",
                flops=2 * n * ho * wo * k * w.shape[0] * w.shape[1] * w.shape[2],
                nbytes=(x.numel() + w.numel() + b.numel() + y.numel()) * es,
                peak=pol, rule=FP32_REL if pol == "fp32" else ("ulp", FP32_REL),
            )
            if s == 1 and pol == "fp32" and batch == BATCH:
                # at stride 1 taps' term order (qh, qw, c) is vcol's (fy, fx, c): one fmaf chain each
                st.update(same_as=[("conv_taps", lambda x=x, w=w, b=b, p=p: ck.conv_taps(
                    x, w, b, stride=1, padding=p))])
                CUDNN_KERNELS[f"{stage} {pol}"] = library_kernels(st["library"])
                log(f"library F.conv2d at {stage} {pol} runs: {CUDNN_KERNELS[f'{stage} {pol}']}")
            stages.append(st)
        stages += [pool_stage("pool1", t["y1"]), pool_stage("pool2", t["y2"]), lrn_stage(t["q2"], pol)]
        rows += [measure(st, pol, spec, peak_name) for st in stages]
        del t, stages
        torch.cuda.empty_cache()
    return rows


# the cuDNN kernels behind the fp32 conv2 library call (torch.profiler), for the record
CUDNN_KERNELS = {}


def library_kernels(fn) -> list:
    """Names of the CUDA kernels one call of ``fn`` launches, by device time
    (``torch.profiler``; the warm-up call picks cuDNN's algorithm first)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [(e.key, getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0)))
             for e in prof.key_averages()
             if getattr(e, "device_type", None) is not None and "CUDA" in str(e.device_type)]
    return [k for k, _t in sorted(names, key=lambda kv: -kv[1])]


# the kernel files on the Hopper mainloop (conv_sm90.cuh): their names carry the file's anonymous namespace
MAINLOOP_FILES = ("conv2d_cu", "conv_block_cu", "conv_pairs_cu", "conv_im2col_cu", "conv_taps_cu", "conv_g8_cu")
# those whose registers and spills MAINLOOP_PTXAS holds (taps and g8 joined the mainloop after the record)
PTXAS_HELD = ("conv2d_cu", "conv_block_cu", "conv_pairs_cu", "conv_im2col_cu")


# the files whose instances load 16-byte channel vectors (VEC 4 fp32, 8 bf16; VEC 1 the scalar instance)
VECTOR_FILES = ("maxpool_cu", "lrn_cu", "maxpool_phases_cu", "maxpool_s2d_cu")
# the flash kernels' files, and the head dims whose instances run the Hopper design (over flash_bwd_sm90.cuh):
# bf16 on mma.sync, fp32 on FFMA; the D = 256 and windowed (D 0) instances of all three run the tensor cores
# in bf16 with no FFMA main loop (fewer FFMA than HMMA)
FLASH_FILES = ("flash_fwd_cu", "flash_dq_cu", "flash_dkv_cu")
FLASH_SM90_DIMS = (16, 32, 64, 128)
FLASH_WIDE_INSTANCES = (256, 0)


def flash_instance(name: str):
    """``(file, dtype, D)`` of a flash kernel's mangled name (D 0: the
    windowed instance, ``wide::WIDE``), or None for any other kernel."""
    f = next((f for f in FLASH_FILES if f in name), None)
    if f is None or "kernel" not in name:
        return None
    m = re.search(r"Li(\d+)E", name)
    return f, "bf16" if "bfloat16" in name else "fp32", int(m.group(1)) if m else 0


def sass_phase(info) -> dict:
    """The instructions the conv and flash entry points compiled to, from
    ``cuobjdump --dump-sass`` on the built library: every bf16 (and int8w)
    instance of the kernels on the Hopper mainloop (the six files of
    ``MAINLOOP_FILES``) and every bf16 instance of ``flash_fwd.cu``,
    ``flash_dq.cu`` and ``flash_dkv.cu`` at D <= 128 must contain HMMA
    (mma.sync on the tensor cores), and so must the bf16 D = 256 and
    windowed instances of the three, with fewer FFMA than HMMA (no FFMA
    main loop); every fp32 one FFMA and no HMMA (no TF32: the fp32
    contract)."""
    from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import _build

    tool = Path(_build.find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "--dump-sass", str(info.path)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    found, flash, vector = {}, {}, {}
    for chunk in sass.split("Function : ")[1:]:
        name = chunk.split(None, 1)[0]
        counts = dict(hmma=chunk.count("HMMA"), ffma=chunk.count("FFMA"))
        inst = flash_instance(name)
        if inst is not None:
            flash[name] = dict(file=inst[0], dtype=inst[1], d=inst[2], **counts)
        elif any(f in name for f in MAINLOOP_FILES):
            found[name] = dict(dtype="bf16" if "bfloat16" in name else "fp32", **counts)
        elif any(f in name for f in VECTOR_FILES):
            vec = re.search(r"Li(\d+)E", name)
            vector[name] = dict(file=next(f for f in VECTOR_FILES if f in name), vec=int(vec.group(1)) if vec else 0,
                                dtype="bf16" if "bfloat16" in name else "fp32", ldg128=chunk.count("LDG.E.128"))
    kinds = {(v["file"], v["dtype"], v["vec"]) for v in vector.values()}
    require({(f, "fp32", 4) for f in VECTOR_FILES} | {(f, "bf16", 8) for f in VECTOR_FILES} <= kinds,
            f"SASS: the vector instances of {VECTOR_FILES} were not all found: {sorted(kinds)}")
    for name, v in vector.items():
        ok = v["ldg128"] > 0 if v["vec"] > 1 else None
        log(f"sass {v['file']} {v['dtype']} VEC={v['vec']} LDG.E.128={v['ldg128']} ok={ok}: {name[:110]}")
        require(ok is not False, f"SASS of {name}: a vector instance without 128-bit loads: {v}")
    kinds = {(next(f for f in MAINLOOP_FILES if f in k), v["dtype"]) for k, v in found.items()}
    require({(f, dt) for f in MAINLOOP_FILES for dt in ("fp32", "bf16")} <= kinds,
            f"SASS: the conv entry points were not all found: {sorted(kinds)}")
    flash_kinds = {(v["file"], v["dtype"], v["d"]) for v in flash.values()}
    want = {(f, dt, d) for f in FLASH_FILES for dt in ("fp32", "bf16") for d in FLASH_SM90_DIMS + FLASH_WIDE_INSTANCES}
    require(want <= flash_kinds, f"SASS: the flash instances were not all found: {sorted(flash_kinds)}")
    for name, v in found.items():
        ok = v["hmma"] > 0 if v["dtype"] == "bf16" else (v["ffma"] > 0 and v["hmma"] == 0)
        log(f"sass {v['dtype']} HMMA={v['hmma']} FFMA={v['ffma']} ok={ok}: {name[:110]}")
        require(ok, f"SASS of {name}: {v}")
    for name, v in flash.items():
        if v["dtype"] == "fp32":
            ok = v["ffma"] > 0 and v["hmma"] == 0
        elif v["d"] in FLASH_SM90_DIMS:
            ok = v["hmma"] > 0
        else:  # the D = 256 and windowed instances: the tensor cores, no FFMA main loop
            ok = 0 < v["hmma"] and v["ffma"] < v["hmma"]
        log(f"sass {v['file']} {v['dtype']} D={v['d']} HMMA={v['hmma']} FFMA={v['ffma']} ok={ok}: {name[:110]}")
        require(ok is not False, f"SASS of {name}: {v}")
    return dict(conv=found, flash=flash, vector=vector)


def flash_ptxas(build_log: str) -> dict:
    """Registers and spill-store bytes of every flash instance, keyed
    ``file/dtype/D`` (kernel name beside them)."""
    table = {}
    for name, regs, stores in ptxas_entries(build_log):
        inst = flash_instance(name)
        if inst is not None:
            kname = re.search(r"(flash_\w*kernel\w*?)I", name)
            table[f"{inst[0]}/{inst[1]}/D={inst[2]}"] = dict(registers=regs, spill_stores=stores,
                                                            kernel=kname.group(1) if kname else name[:60])
    return dict(sorted(table.items()))


# ``ptxas -v`` of the ``PTXAS_HELD`` files' kernels as they were before conv_taps.cu and conv_g8.cu joined
# their mainloop, per file and dtype (bf16: int8w's too): the sorted (registers, spill-store bytes) of every
# entry (NVIDIA H100 build, CUDA 12.8; ``python3 chip_smoke.py --record`` in a checkout of that tree prints
# it). The shared mainloop's callers must keep them.
MAINLOOP_PTXAS = {
    "conv2d_cu/bf16": [[95, 0], [96, 0], [117, 0], [128, 4], [128, 28]],
    "conv2d_cu/fp32": [[123, 0], [123, 0], [157, 0], [168, 0], [168, 0]],
    "conv_block_cu/bf16": [[223, 0], [226, 0], [228, 0], [246, 0]],
    "conv_block_cu/fp32": [[213, 0], [255, 0]],
    "conv_im2col_cu/bf16": [[128, 4], [128, 28]],
    "conv_im2col_cu/fp32": [[168, 0], [168, 0]],
    "conv_pairs_cu/bf16": [[126, 0], [126, 0]],
    "conv_pairs_cu/fp32": [[168, 0], [227, 0]],
}
# sha256 of the bits of the fp32 conv_taps and conv_g8 outputs of engine_fp32_digest, as the kernels gave
# them on their implicit-GEMM engine before they joined the Hopper mainloop (NVIDIA H100 build, CUDA 12.8;
# ``python3 chip_smoke.py --record`` in a checkout of that tree prints it): one fmaf chain a term in kg
# order from 0 on both, so the mainloop keeps their bits
ENGINE_FP32_SHA256 = "eb3368a76a1b9d438c5a3db71aea90f6791810111b5beed7af0b7dc1abb63a30"


def ptxas_entries(build_log: str) -> list:
    """``(entry name, registers, spill-store bytes)`` of every kernel in
    ``ptxas -v``'s part of the build log."""
    entries, name, spill = [], None, 0
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spill = m.group(1), 0
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name is not None:
            spill = int(m.group(1))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            entries.append((name, int(m.group(1)), spill))
            name = None
    return entries


def ptxas_table(build_log: str) -> dict:
    """Per mainloop file and dtype, the sorted ``[registers, spill stores]``
    of its entries."""
    table = {}
    for name, regs, stores in ptxas_entries(build_log):
        f = next((f for f in MAINLOOP_FILES if f in name), None)
        if f is not None:
            table.setdefault(f"{f}/{'bf16' if 'bfloat16' in name else 'fp32'}", []).append([regs, stores])
    return {k: sorted(v) for k, v in sorted(table.items())}


def ptxas_phase(info) -> dict:
    """Phase 1: the mainloop kernels' registers and spills from the build
    log; those of the ``PTXAS_HELD`` files must be ``MAINLOOP_PTXAS``."""
    table = ptxas_table(info.log)
    for key, entries in table.items():
        log(f"ptxas {key}: [registers, spill-store bytes] {entries}")
    held = {k: v for k, v in table.items() if k.split("/")[0] in PTXAS_HELD}
    require(held == MAINLOOP_PTXAS, f"{', '.join(PTXAS_HELD)}: registers or spills moved: {held} "
            f"against {MAINLOOP_PTXAS}")
    return table


def measure(st, pol, spec, peak_name) -> dict:
    """One stage row: the kernel against its plain version by the stage's
    rule (and bitwise against each ``(name, fn)`` of ``st["same_as"]``),
    then kernel, plain and library times beside the bound; where
    ``st["alone"]`` is given (a wrapper that packs its operands first), the
    kernel alone on the packed operands is timed too (``kernel_ms``)."""
    got = st["run"]()
    res = compare(st["rule"], got, st["plain"]())
    if st.get("same_as"):
        res["bitwise"] = {ref: bool(torch.equal(got, fn())) for ref, fn in st["same_as"]}
    torch.cuda.synchronize()
    bound, by = spec.bound_ms(st["flops"], st["nbytes"], st["peak"])
    lib = st.get("library")
    row = dict(
        kernel=st["kernel"], stage=st["stage"], mode=st.get("mode", ""), dtype=pol, **res,
        ms=gpu_time_ms(st["run"]), plain_ms=gpu_time_ms(st["plain"]),
        library_ms=gpu_time_ms(lib) if lib is not None else None, library_call=st.get("library_call"),
        bound_ms=bound, bound_by=by, flops=st["flops"], bytes=st["nbytes"],
        peak=f"{spec.name} {peak_name(st['peak'])}",
    )
    if "alone" in st:
        row["kernel_ms"] = gpu_time_ms(st["alone"])
    if "alone_bytes" in st:
        row["kernel_bound_ms"], row["kernel_bound_by"] = spec.bound_ms(0, st["alone_bytes"], "fp32",
                                                                       fp32_flops=st["flops"])
    if "marker" in st:
        row["device_ms"] = device_time_ms(st["run"], st["marker"])
        row["library_device_ms"] = device_time_ms(lib) if lib is not None else None
    if st.get("packs"):
        # the wrapper's every kernel and copy: its packing's device time is this less device_ms
        row["wrapper_device_ms"] = device_time_ms(st["run"])
    name = f"{row['kernel']}{'[' + row['mode'] + ']' if row['mode'] else ''}"
    lib_s = f"{row['library_ms']:.4f}" if lib is not None else "n/a"
    log(f"kernel {name:14s} {row['stage']:5s} {pol}: ok={row['ok']} tol={row['tol']} "
        f"max_abs={row['max_abs_err']:.3g} max_rel={row['max_rel_err']:.3g}"
        + "".join(f" bitwise_vs_{ref}={ok}" for ref, ok in res.get("bitwise", {}).items())
        + f" | ms={row['ms']:.4f}" + (f" kernel_alone={row['kernel_ms']:.4f}" if "alone" in st else "")
        + (f" (its own bytes' bound {row['kernel_bound_ms']:.4f})" if "alone_bytes" in st else "")
        + (f" device_ms={_fmt(row['device_ms'])}" if "marker" in st else "")
        + (f" wrapper_device_ms={_fmt(row['wrapper_device_ms'])}" if st.get("packs") else "")
        + f" plain={row['plain_ms']:.4f} library={lib_s}"
        + (f" (device {_fmt(row['library_device_ms'])})" if "marker" in st else "")
        + f" bound={row['bound_ms']:.4f} ({by})")
    require(row["ok"], f"{name} at {row['stage']} {pol} disagrees with its plain version: {res}")
    require(all(res.get("bitwise", {}).values()), f"{name} at {row['stage']} {pol} differs from {res.get('bitwise')}")
    return row


def variant_phase(spec, peak_name) -> list:
    """Phase 2, the variants the tuner sweeps, at the main path's stages in
    fp32 and bf16: the taps, pairs and im2col convs, the hpool and k_block
    modes of the vcol and taps convs, the W stage after hpool, and the
    phases pool with its pack (``packed_pool_rows``); each against its plain
    version, with the bitwise checks of the module docstring, timed beside
    its bound and a library call."""
    import torch.nn.functional as F

    from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import cuda_kernels as ck
    from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import packing

    conv_fns = {
        "conv2d": (ck.conv2d_bias_relu, ck.conv2d_bias_relu_plain),
        "conv_taps": (ck.conv_taps, ck.conv_taps_plain),
        "conv_pairs": (ck.conv_pairs, ck.conv_pairs_plain),
        "conv_im2col": (ck.conv_im2col, ck.conv_im2col_plain),
        "conv_g8": (ck.conv_g8, ck.conv_g8_plain),
    }
    rows = []
    for pol, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        gen = torch.Generator(device="cuda").manual_seed(2026)
        t = stage_inputs(dtype, gen)
        es = t["x"].element_size()
        rule = FP32_REL if pol == "fp32" else ("ulp", FP32_REL)
        stages = []
        convs = (("conv1", t["x"], t["w1"], t["b1"], 4, 0), ("conv2", t["q1"], t["w2"], t["b2"], 1, 2))
        for stage, x, w, b, s, p in convs:
            n, ho, wo, k = t["y1" if stage == "conv1" else "y2"].shape
            flops = 2 * n * ho * wo * k * w.shape[0] * w.shape[1] * w.shape[2]
            in_bytes = (x.numel() + w.numel() + b.numel()) * es
            wl = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            lib = lambda x=x, wl=wl, b=b, s=s, p=p: F.conv2d(x.permute(0, 3, 1, 2), wl, b, stride=s, padding=p)  # noqa: E731
            hp = (ho - 3) // 2 + 1
            modes = [(kname, "", {}) for kname in ("conv_taps", "conv_pairs", "conv_im2col")]
            if s >= 2:
                modes.append(("conv_g8", "", {}))
            modes += [(kname, "hpool", dict(hpool=(3, 2))) for kname in ("conv2d", "conv_taps")]
            if stage == "conv2":
                modes += [(kname, f"k_block={kb}", dict(k_block=kb)) for kname in ("conv2d", "conv_taps")
                          for kb in (64, 128)]
            for kname, mode, extra in modes:
                fn, plain = conv_fns[kname]
                run = lambda fn=fn, x=x, w=w, b=b, s=s, p=p, e=extra: fn(x, w, b, stride=s, padding=p, **e)  # noqa: E731
                st = dict(
                    kernel=kname, stage=stage, mode=mode, run=run, peak=pol, rule=rule, flops=flops,
                    plain=lambda plain=plain, x=x, w=w, b=b, s=s, p=p, e=extra: plain(x, w, b, stride=s, padding=p, **e),
                    nbytes=in_bytes + n * (hp if mode == "hpool" else ho) * wo * k * es,
                )
                if mode == "hpool":
                    # no one library call takes the H max in a conv's epilogue
                    st.update(library=None, library_call=None)
                    unfused = lambda fn=fn, x=x, w=w, b=b, s=s, p=p: ck.maxpool2d(  # noqa: E731
                        fn(x, w, b, stride=s, padding=p), window=3, stride=2)
                    stages.append(st)
                    stages.append(w_stage("pool1" if stage == "conv1" else "pool2", run(), unfused, kname))
                else:
                    st.update(library=lib, library_call="F.conv2d (cuDNN, channels-last, bias, no ReLU)")
                    if mode:
                        st.update(same_as=[("k_block=0", lambda fn=fn, x=x, w=w, b=b, s=s, p=p: fn(
                            x, w, b, stride=s, padding=p))])
                    else:
                        refs, alone = mainloop_variant_extras(kname, pol, x, w, b, s, p)
                        st.update(same_as=refs, alone=alone)
                    stages.append(st)
        rows += [measure(st, pol, spec, peak_name) for st in stages]
        for stage, x in (("pool1", t["y1"]), ("pool2", t["y2"])):
            hp, wp = (x.shape[1] - 3) // 2 + 2, (x.shape[2] - 3) // 2 + 2
            xph = ck.pool_phases_pack(x, window=3, stride=2)
            pool = packed_pool_stage("maxpool_phases", stage, x)
            pool.update(alone=lambda xph=xph: ck.maxpool_phases_packed(xph, window=3, stride=2))
            rows += packed_pool_rows(pack_stage(
                "pool_phases_pack", stage, x, run=lambda x=x: ck.pool_phases_pack(x, window=3, stride=2),
                plain=lambda x=x, hp=hp, wp=wp: packing.pool_phases(x, 2, hp, wp)), pool, xph, pol, spec, peak_name)
            del xph
        del t, stages
        torch.cuda.empty_cache()
    return rows


def mainloop_variant_extras(kname, pol, x, w, b, s, p):
    """The bitwise references of a taps, pairs, im2col or g8 row and its
    launch on operands packed once (the kernel alone). Taps, pairs and
    im2col run the same terms in the same order on the Hopper mainloop (in
    fp32 one fmaf chain a term, in bf16 the mainloop's tensor-core k-steps):
    pairs and im2col give taps' bits, and at stride 1 (where the s2d order is
    vcol's) all three give ``conv2d_bias_relu``'s in bf16 (fp32: the conv2d
    row's own pin). g8's terms are its own: a second launch gives its bits."""
    from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import cuda_kernels as ck

    kw = dict(stride=s, padding=p)
    if kname == "conv_g8":
        xs8, wcols, ho, wo = ck._g8_operands(x, w, s, p)
        return ([("second launch", lambda: ck.conv_g8(x, w, b, **kw))],
                lambda: ck.conv_g8_packed(xs8, wcols, b, ho=ho, wo=wo))
    refs = [] if kname == "conv_taps" else [("conv_taps", lambda: ck.conv_taps(x, w, b, **kw))]
    if s == 1 and pol != "fp32":
        refs.append(("conv2d", lambda: ck.conv2d_bias_relu(x, w, b, **kw)))
    if kname == "conv_im2col":
        xcol, wmat, ho, wo = ck._im2col_operands(x, w, s, p)
        return refs, lambda: ck.conv_im2col_packed(xcol, wmat, b, n=x.shape[0], ho=ho, wo=wo)
    xs, ws, fq, ho, wo = ck._s2d_operands(x, w, s, p)
    if kname == "conv_taps":
        return refs, lambda: ck.conv_taps_packed(xs, ws, b, ho=ho, wo=wo)
    ops = ck._pairs_operands(xs, ws, fq)
    return refs, lambda: ck.conv_pairs_packed(*ops, b, ho=ho, wo=wo)


# the conv variants off the main path, (n, h, c, f, k, stride, pad): an even-fq pairs case (F8 s4: fq 2), a
# ragged output (23 rows), C=5 with K=40, K=256 for both k_blocks, g8 at strides 4 (an odd output), 2 and 3,
# and g8 at an odd K (37: its store a column at a time) and an odd output (15 rows)
EDGE_VARIANT_CASES = ((2, 35, 5, 8, 40, 4, 1), (3, 45, 5, 3, 40, 2, 1), (2, 31, 96, 5, 72, 1, 2),
                      (1, 13, 16, 3, 256, 1, 1), (2, 37, 3, 11, 16, 4, 0), (2, 37, 3, 7, 16, 3, 2),
                      (2, 31, 3, 5, 37, 2, 1))


def engine_fp32_digest() -> dict:
    """The sha256 of the bits of fp32 ``conv_taps`` and ``conv_g8`` outputs
    on seeded inputs, in order: taps at conv1 and conv2 (batch 128), in
    hpool at both and in k_block 64 and 128 at conv2; g8 at conv1; then
    taps, and g8 where the stride is >= 2, at every ``EDGE_VARIANT_CASES``
    shape. ``sha256`` must be ``ENGINE_FP32_SHA256``; ``items`` has each
    output's own digest, to name the one that moved."""
    from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import cuda_kernels as ck

    gen = torch.Generator(device="cuda").manual_seed(2033)
    t = stage_inputs(torch.float32, gen)
    runs = []
    for stage, x, w, b, s, p in (("conv1", t["x"], t["w1"], t["b1"], 4, 0), ("conv2", t["q1"], t["w2"], t["b2"], 1, 2)):
        args, kw = (x, w, b), dict(stride=s, padding=p)
        runs += [(f"taps {stage}", ck.conv_taps, args, kw),
                 (f"taps hpool {stage}", ck.conv_taps, args, dict(kw, hpool=(3, 2)))]
        if s == 1:
            runs += [(f"taps k_block={kb} {stage}", ck.conv_taps, args, dict(kw, k_block=kb)) for kb in (64, 128)]
        else:
            runs.append((f"g8 {stage}", ck.conv_g8, args, kw))
    for n, h, c, f, k, s, p in EDGE_VARIANT_CASES:
        x = torch.rand((n, h, h, c), generator=gen, device="cuda")
        w = (torch.rand((f, f, c, k), generator=gen, device="cuda") - 0.5) * (2 / (f * f * c) ** 0.5)
        b = (torch.rand((k,), generator=gen, device="cuda") - 0.5) * 0.2
        args, kw = (x, w, b), dict(stride=s, padding=p)
        tag = f"{n}x{h}x{h}x{c} F{f} K{k} s{s} p{p}"
        runs += [(f"taps {tag}", ck.conv_taps, args, kw)] + ([(f"g8 {tag}", ck.conv_g8, args, kw)] if s >= 2 else [])
    total, items = hashlib.sha256(), {}
    for name, fn, args, kw in runs:
        raw = fn(*args, **kw).contiguous().cpu().numpy().tobytes()
        items[name] = hashlib.sha256(raw).hexdigest()
        total.update(raw)
    return dict(sha256=total.hexdigest(), items=items)


# sha256 of the bits of pool_lrn_digest's outputs, as the one thread an element maxpool.cu and lrn.cu gave them
# before their Hopper redesign (NVIDIA H100 build, CUDA 12.8; ``python3 chip_smoke.py --record`` in a checkout of that tree
# with this file copied in prints it): on inputs without -0.0 the redesign keeps every bit
POOL_LRN_SHA256 = "d576555dff753835bf06e33bf47b19657aa75c1d012c45740ff39c7efcca8497"
# (name, shape, what runs): the main path's pools and LRN at batch 128, the W stages that follow an hpool
# conv, and edge_phase's LRN cases; each input standard normal (the LRN's scaled so the scale term matters)
POOL_LRN_DIGEST = (
    ("pool1", (BATCH, 55, 55, 96), "pool"), ("pool2", (BATCH, 27, 27, 256), "pool"),
    ("pool1 W stage", (BATCH, 27, 55, 96), "w"), ("pool2 W stage", (BATCH, 13, 27, 256), "w"),
    ("lrn2", (BATCH, 13, 13, 256), dict(LRN2_KW, scale=8.0)),
    *[(f"lrn C40 size{size} alpha_over_size={aos}", (2, 5, 5, 40),
       dict(size=size, alpha=1e-4, beta=0.75, k=2.0, alpha_over_size=aos, scale=60.0))
      for size, aos in ((5, False), (5, True), (3, False), (3, True))],
)


def pool_lrn_digest() -> dict:
    """The sha256 of the bits of ``maxpool2d`` (pool1, pool2), its W stage
    (``maxpool2d_w``) and ``lrn`` (lrn2 and the C = 40 edge cases, sizes 3
    and 5, both alpha forms) in fp32 and bf16, in ``POOL_LRN_DIGEST``'s
    order, on seeded inputs that hold no -0.0. ``sha256`` must be
    ``POOL_LRN_SHA256``; ``items`` has each output's own digest."""
    from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import cuda_kernels as ck

    total, items = hashlib.sha256(), {}
    for pol, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        gen = torch.Generator(device="cuda").manual_seed(2034)
        for name, shape, what in POOL_LRN_DIGEST:
            x = torch.randn(shape, generator=gen, device="cuda")
            if isinstance(what, dict):
                kw = dict(what)
                x = (x * kw.pop("scale")).to(dtype)
                fn = lambda x=x, kw=kw: ck.lrn(x, **kw)  # noqa: E731
            else:
                x = x.to(dtype)
                fn = (lambda x=x: ck.maxpool2d(x, window=3, stride=2)) if what == "pool" else (  # noqa: E731
                    lambda x=x: ck.maxpool2d_w(x, window=3, stride=2))
            require(not bool(((x == 0) & torch.signbit(x)).any()), f"digest input {name} holds -0.0")
            raw = fn().contiguous().view(torch.uint8).cpu().numpy().tobytes()
            items[f"{name} {pol}"] = hashlib.sha256(raw).hexdigest()
            total.update(raw)
    return dict(sha256=total.hexdigest(), items=items)


def pool_rows(spec, peak_name) -> list:
    """Phase 2's pool and lrn rows alone (``--pool-rows``): maxpool2d at
    pool1 and pool2 and lrn2 on the staged chain's tensors, the W stages
    after the vcol hpool conv, the phases pool at pool1 and pool2 (the same
    tensors) and the s2d pool at the pool A/B's (``s2d_inputs``), in fp32
    and bf16. The phases and s2d rows read their pool kernel alone and
    their whole wrapper by ``torch.profiler`` (``packed_pool_stage``), so
    that a parent without the packs' entry points runs them too."""
    from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import cuda_kernels as ck

    rows = []
    for pol, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        gen = torch.Generator(device="cuda").manual_seed(2026)
        t = stage_inputs(dtype, gen)
        stages = [pool_stage("pool1", t["y1"]), pool_stage("pool2", t["y2"]), lrn_stage(t["q2"], pol)]
        for stage, x, w, b, s, p in (("pool1", t["x"], t["w1"], t["b1"], 4, 0), ("pool2", t["q1"], t["w2"], t["b2"], 1, 2)):
            unfused = lambda x=x, w=w, b=b, s=s, p=p: ck.maxpool2d(  # noqa: E731
                ck.conv2d_bias_relu(x, w, b, stride=s, padding=p), window=3, stride=2)
            y_h = ck.conv2d_bias_relu(x, w, b, stride=s, padding=p, hpool=(3, 2))
            stages.append(w_stage(stage, y_h, unfused, "conv2d"))
        stages += [packed_pool_stage("maxpool_phases", stage, t[y]) for stage, y in (("pool1", "y1"), ("pool2", "y2"))]
        stages += [packed_pool_stage("maxpool_s2d", stage, x) for stage, x in s2d_inputs(dtype)]
        rows += [measure(st, pol, spec, peak_name) for st in stages]
        del t, stages
        torch.cuda.empty_cache()
    return rows


def edge_phase() -> list:
    """Kernel against plain version at shapes off the main path: channel
    and pixel counts that are not tile multiples, stride 2, an odd channel
    count, other pool windows and LRN sizes, both alpha forms; the conv
    variants at ``EDGE_VARIANT_CASES``, with the hpool, k_block, phases and
    Hopper-mainloop bitwise checks; the phases pack bitwise its plain pack
    (C = 3, 7, 20, 40, 96, 128, 256, odd H/W, 2/2 and 3/1 windows, a view off
    16-byte alignment) and the phases kernel alone on it bitwise its plain
    version."""
    from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import cuda_kernels as ck
    from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import packing

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
        for n, h, c, f, k, s, p in EDGE_VARIANT_CASES:
            x, w, b = r(n, h, h, c), r(f, f, c, k, scale=2 / (f * f * c) ** 0.5, shift=0.5), r(k, scale=0.2, shift=0.5)
            kw = dict(stride=s, padding=p)
            rule = FP32_REL if pol == "fp32" else ("ulp", FP32_REL)
            tag = f"{n}x{h}x{h}x{c} F{f} K{k} s{s} p{p} {pol}"
            pairs = [("conv_taps", ck.conv_taps, ck.conv_taps_plain), ("conv_im2col", ck.conv_im2col, ck.conv_im2col_plain)]
            if -(-f // s) >= 2:
                pairs.append(("conv_pairs", ck.conv_pairs, ck.conv_pairs_plain))
            if s >= 2:
                pairs.append(("conv_g8", ck.conv_g8, ck.conv_g8_plain))
            for name, fn, plain in pairs:
                results.append((f"{name} {tag}", compare(rule, fn(x, w, b, **kw), plain(x, w, b, **kw))))
            # the Hopper mainloop's pins (mainloop_variant_extras) at odd shapes (cs = 27, 20: the term-by-term
            # gathers): pairs and im2col bitwise taps (and, at stride 1, vcol) in both dtypes; g8 bitwise itself
            got_t = ck.conv_taps(x, w, b, **kw)
            got = {"conv_im2col": ck.conv_im2col(x, w, b, **kw)}
            if -(-f // s) >= 2:
                got["conv_pairs"] = ck.conv_pairs(x, w, b, **kw)
            refs = {"conv_taps": got_t}
            if s == 1:
                refs["conv2d"] = ck.conv2d_bias_relu(x, w, b, **kw)
                got["conv_taps"] = got_t
            for ref, want in refs.items():
                for name, y in got.items():
                    if name != ref:
                        results.append((f"{name} bitwise {ref} {tag}", compare("bitwise", y, want)))
            if s >= 2:
                results.append((f"conv_g8 second launch bitwise the first {tag}",
                                compare("bitwise", ck.conv_g8(x, w, b, **kw), ck.conv_g8(x, w, b, **kw))))
            for name, fn in (("conv2d", ck.conv2d_bias_relu), ("conv_taps", ck.conv_taps)):
                y = fn(x, w, b, **kw)
                if y.shape[1] >= 3:
                    got = ck.maxpool2d_w(fn(x, w, b, hpool=(3, 2), **kw), window=3, stride=2)
                    results.append((f"{name} hpool+W vs staged {tag}", compare("bitwise", got, ck.maxpool2d(y, window=3, stride=2))))
                for kb in (64, 128):
                    if ck.effective_k_block(kb, k):
                        results.append((f"{name} k_block={kb} vs 0 {tag}", compare("bitwise", fn(x, w, b, k_block=kb, **kw), y)))
            if y.shape[1] >= 3:
                results.append((f"maxpool_phases vs maxpool2d {tag}", compare(
                    "bitwise", ck.maxpool_phases(y, window=3, stride=2), ck.maxpool2d(y, window=3, stride=2))))
        for shape, win, st in (((3, 14, 14, 40), 3, 2), ((2, 9, 9, 7), 2, 2), ((1, 8, 8, 3), 3, 1)):
            x = r(*shape, shift=0.5)
            res = compare("bitwise", ck.maxpool2d(x, window=win, stride=st),
                          ck.maxpool2d_plain(x, window=win, stride=st))
            results.append((f"pool {shape} {win}/{st} {pol}", res))
            res = compare("bitwise", ck.maxpool_phases(x, window=win, stride=st), ck.maxpool_phases_plain(x, window=win, stride=st))
            results.append((f"maxpool_phases {shape} {win}/{st} {pol}", res))
            xph = ck.pool_phases_pack(x, window=win, stride=st)
            q = (win - 1) // st
            hp, wp = (shape[1] - win) // st + 1 + q, (shape[2] - win) // st + 1 + q
            results.append((f"pool_phases_pack {shape} {win}/{st} {pol} (bitwise)", compare(
                "bitwise", xph, packing.pool_phases(x, st, hp, wp))))
            results.append((f"maxpool_phases_packed {shape} {win}/{st} {pol} (bitwise)", compare(
                "bitwise", ck.maxpool_phases_packed(xph, window=win, stride=st),
                ck.maxpool_phases_packed_plain(xph, window=win, stride=st))))
        # the pack at pool1's and pool2's widths, odd H/W and C = 20, 128 (the vector instance), and off 16-byte
        # alignment (the scalar instance)
        for shape in ((2, 55, 55, 96), (2, 27, 27, 256), (3, 15, 17, 20), (2, 13, 21, 128)):
            x = r(*shape, shift=0.5)
            hp, wp = (shape[1] - 3) // 2 + 2, (shape[2] - 3) // 2 + 2
            want = packing.pool_phases(x, 2, hp, wp)
            results.append((f"pool_phases_pack {shape} 3/2 {pol} (bitwise)", compare(
                "bitwise", ck.pool_phases_pack(x, window=3, stride=2), want)))
            off = r(x.numel() + 1, shift=0.5)[1:].view(shape)
            off.copy_(x)
            results.append((f"pool_phases_pack {shape} 3/2 {pol} view off 16-byte alignment (bitwise)", compare(
                "bitwise", ck.pool_phases_pack(off, window=3, stride=2), want)))
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


def signed_zero_rule(x, got, window, stride) -> bool:
    """Where a pool of ``x`` gave a zero, its sign is JAX's: +0.0 where the
    window holds a +0.0, -0.0 where its zeros are all -0.0 (``window`` and
    ``stride``: ints or (rows, cols); the windows found by pooling the
    "+0.0 here" mask)."""
    import torch.nn.functional as F

    plus0 = F.max_pool2d((_bits(x) == 0).float().permute(0, 3, 1, 2), window, stride).permute(0, 2, 3, 1) > 0
    zero = got == 0
    return bool((~torch.signbit(got[zero & plus0])).all()) and bool(torch.signbit(got[zero & ~plus0]).all())


def pool_lrn_edge_phase() -> list:
    """maxpool.cu and lrn.cu off the main path, and the pools' signed-zero
    rule everywhere: windows of +-0.0 (+0.0 wins in maxpool2d, its W stage,
    maxpool_phases, maxpool_s2d and the reference tier's pool, each bitwise
    its plain version where it has one; the reference tier's relu_maxpool,
    all +0.0, bitwise maxpool2d of ReLU's output); a zero input with negative weights
    and a -0.0 bias through the hpool conv + W stage and conv_block (int8w
    with a negative scale too), every output +0.0; NaN windows (bitwise, NaN
    where the plain version has it); C = 3, 7, 40 and 96 through the scalar
    and vector instances (``vector_width`` says which); views 2 or 4 bytes
    off 16-byte alignment (scalar) bitwise their aligned copies; 3x3/2,
    1x3/(1,2), 2/2 and 3/1 windows; LRN at sizes 3 and 5, both alpha forms,
    C = 3, 7, 40, 256 (off alignment too) and past one channel chunk
    (1100, 2056), and at sizes 1, 7 and 9 (the squares read one by one)."""
    from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import cuda_kernels as ck
    from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import reference

    gen = torch.Generator(device="cuda").manual_seed(13)
    results = []

    def bitwise(name, got, want, extra=True):
        results.append((name, dict(ok=bool(torch.equal(_bits(got), _bits(want))) and bool(extra), max_abs_err=0.0)))

    pools = (("maxpool2d 3x3/2", lambda x: ck.maxpool2d(x, window=3, stride=2),
              lambda x: ck.maxpool2d_plain(x, window=3, stride=2), 3, 2),
             ("maxpool2d_w 1x3/(1,2)", lambda x: ck.maxpool2d_w(x, window=3, stride=2),
              lambda x: ck.maxpool_rect_plain(x, window=(1, 3), stride=(1, 2)), (1, 3), (1, 2)),
             ("maxpool2d 2/2", lambda x: ck.maxpool2d(x, window=2, stride=2),
              lambda x: ck.maxpool2d_plain(x, window=2, stride=2), 2, 2),
             ("maxpool2d 3/1", lambda x: ck.maxpool2d(x, window=3, stride=1),
              lambda x: ck.maxpool2d_plain(x, window=3, stride=1), 3, 1),
             ("maxpool_phases 3x3/2", lambda x: ck.maxpool_phases(x, window=3, stride=2),
              lambda x: ck.maxpool_phases_plain(x, window=3, stride=2), 3, 2),
             ("maxpool_s2d 3x3/2", lambda x: ck.maxpool_s2d(x, window=3, stride=2),
              lambda x: ck.maxpool_s2d_plain(x, window=3, stride=2), 3, 2))
    for pol, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        vec = 16 // dtype.itemsize
        zeros = torch.tensor([-0.0, 0.0, -1.0, -2.0], device="cuda").to(dtype)
        for c in (3, 7, 40, 96):
            shape = (2, 15, 17, c)
            signed = zeros[torch.randint(0, 4, shape, generator=gen, device="cuda")]
            nan = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            flat = nan.view(-1)
            payload = torch.tensor([0x7FC00123 if dtype == torch.float32 else 0x7FC1],
                                   dtype=torch.int32 if dtype == torch.float32 else torch.int16, device="cuda")
            flat[5::37] = payload.view(dtype)
            flat[11::53] = float("nan")
            normal = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            buf = torch.randn(normal.numel() + 1, generator=gen, device="cuda").to(dtype)
            off = buf[1:].view(shape)  # 4 (fp32) or 2 (bf16) bytes past a 16-byte boundary
            inst = ck.vector_width(c, dtype, normal.data_ptr())
            results.append((f"vector_width C={c} {pol}: {inst}",
                            dict(ok=inst == (vec if c % vec == 0 else 1) and ck.vector_width(c, dtype, off.data_ptr()) == 1,
                                 max_abs_err=0.0)))
            for name, fn, plain, win, st in pools:
                if name.startswith("maxpool_s2d") and c not in (40, 96):
                    continue
                tag = f"{name} C={c} {pol}"
                got = fn(signed)
                bitwise(f"{tag} +-0.0 (bitwise, +0.0 wins)", got, plain(signed), signed_zero_rule(signed, got, win, st))
                got = fn(nan)
                bitwise(f"{tag} NaN (bitwise)", got, plain(nan), torch.isnan(got).any())
                bitwise(f"{tag} standard normal (bitwise)", fn(normal), plain(normal))
                bitwise(f"{tag} view off 16-byte alignment (bitwise the aligned copy)", fn(off), fn(off.clone()))
            got = reference.maxpool(signed, window=3, stride=2)
            results.append((f"reference.maxpool +-0.0 C={c} {pol}", dict(
                ok=signed_zero_rule(signed, got, 3, 2) and bool(torch.equal(got, ck.maxpool2d(signed, window=3, stride=2))),
                max_abs_err=0.0)))
            got = reference.relu_maxpool(signed, window=3, stride=2)
            results.append((f"reference.relu_maxpool +-0.0 C={c} {pol}", dict(
                ok=bool(torch.equal(_bits(got), _bits(ck.maxpool2d(reference.relu(signed), window=3, stride=2))))
                and not bool(torch.signbit(got).any()), max_abs_err=0.0)))

        # ReLU's sign in the conv epilogues: a zero input, negative weights and a -0.0 bias give +0.0 everywhere
        x = torch.zeros((2, 23, 23, 8), device="cuda", dtype=dtype)
        w = -torch.rand((3, 3, 8, 16), generator=gen, device="cuda").to(dtype) - 0.25
        b = torch.full((16,), -0.0, device="cuda", dtype=dtype)
        for name, got, want in (
            ("conv2d hpool + W stage", ck.maxpool2d_w(ck.conv2d_bias_relu(x, w, b, stride=1, padding=1, hpool=(3, 2)),
                                                      window=3, stride=2),
             ck.maxpool2d_plain(ck.conv2d_bias_relu_plain(x, w, b, stride=1, padding=1), window=3, stride=2)),
            ("conv_block", ck.conv_block(x, w, b, stride=1, padding=1, pool_window=3, pool_stride=2),
             ck.conv_block_plain(x, w, b, stride=1, padding=1, pool_window=3, pool_stride=2)),
        ):
            bitwise(f"{name} zero input, -0.0 bias {pol}: all +0.0", got, want, (_bits(got) == 0).all())
    x = torch.zeros((2, 23, 23, 8), device="cuda", dtype=torch.bfloat16)
    q = -torch.randint(1, 127, (3, 3, 8, 16), generator=gen, device="cuda").to(torch.int8)
    b = torch.full((16,), -0.0, device="cuda")
    scale = -torch.rand((16,), generator=gen, device="cuda") - 0.01
    got = ck.conv_block(x, q, b, stride=1, padding=1, pool_window=3, pool_stride=2, scale=scale)
    want = ck.conv_block_plain(x, q, b, stride=1, padding=1, pool_window=3, pool_stride=2, scale=scale)
    bitwise("conv_block int8w zero input, negative scale, -0.0 bias: all +0.0", got, want, (_bits(got) == 0).all())

    for pol, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        for shape, size, aos in (((2, 5, 5, 40), 3, True), ((2, 5, 5, 3), 5, False), ((3, 4, 5, 7), 5, True),
                                 ((3, 4, 5, 7), 3, False), ((2, 5, 5, 256), 5, False), ((1, 3, 3, 1100), 5, False),
                                 ((1, 2, 2, 2056), 3, True), ((1, 2, 2, 2056), 5, False), ((2, 5, 5, 40), 7, False),
                                 ((3, 4, 5, 7), 9, True), ((2, 3, 3, 256), 1, False)):
            kw = dict(size=size, alpha=1e-4, beta=0.75, k=2.0, alpha_over_size=aos)
            x = (torch.randn(shape, generator=gen, device="cuda") * 60).to(dtype)
            res = compare(1e-6 if pol == "fp32" else ("ulp", 1e-6), ck.lrn(x, **kw), ck.lrn_plain(x, **kw))
            results.append((f"lrn {shape} size{size} alpha_over_size={aos} {pol}", res))
            buf = (torch.randn(x.numel() + 1, generator=gen, device="cuda") * 60).to(dtype)
            off = buf[1:].view(shape)
            bitwise(f"lrn {shape} size{size} view off 16-byte alignment {pol} (bitwise the aligned copy)",
                    ck.lrn(off, **kw), ck.lrn(off.clone(), **kw))
    torch.cuda.synchronize()
    for what, res in results:
        log(f"edge {what}: ok={res['ok']}")
        require(res["ok"], f"edge case {what}: {res}")
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


def block_row(case, pol, spec, peak_name) -> dict:
    """One conv_block row: against its plain version, bitwise against the
    staged kernel chain (fp32, bf16), timed beside that chain, its plain
    version, the cuDNN chain and the bound."""
    from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import cuda_kernels as ck

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
    return row


def block_phase(spec, peak_name) -> list:
    """Phase 2, fused: conv_block at both blocks in fp32, bf16 and int8w."""
    rows = []
    for pol in ("fp32", "bf16", "int8w"):
        gen = torch.Generator(device="cuda").manual_seed(2027)
        rows += [block_row(case, pol, spec, peak_name) for case in block_cases(pol, gen)]
        torch.cuda.empty_cache()
    return rows


# full AlexNet's layers after Blocks 1-2 (conv3, conv4, conv5: 3x3, stride 1, pad 1 on 13x13; pool5 3x3/2)
V6_CONVS = (("conv3", 256, 384), ("conv4", 384, 384), ("conv5", 384, 256))


def v6_stage_inputs(dtype, gen):
    """conv3..pool5 at batch 128: a positive 13x13x256 input (as LRN2 gives),
    He-scaled zero-mean uniform weights and biases around 0, and each
    stage's input as the kernel chain produces it."""
    from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import cuda_kernels as ck

    def r(*shape, scale=1.0, shift=0.0):
        return ((torch.rand(shape, generator=gen, device="cuda") - shift) * scale).to(dtype)

    t = dict(x3=r(BATCH, 13, 13, 256))
    x = t["x3"]
    for name, c, k in V6_CONVS:
        w, b = r(3, 3, c, k, scale=2 * (6 / (9 * c)) ** 0.5, shift=0.5), r(k, scale=0.2, shift=0.5)
        t[name] = (x, w, b)
        x = ck.conv2d_bias_relu(x, w, b, stride=1, padding=1)
    t["y5"] = x
    return t


def v6_kernel_phase(spec, peak_name) -> list:
    """Phase 2, full AlexNet's new shapes in fp32 and bf16: conv2d at conv3,
    conv4 and conv5 (fp32 also bitwise ``conv_taps``) and maxpool2d at pool5
    against their plain versions, timed beside cuDNN / ``F.max_pool2d`` and
    the bound; the hpool conv5 with its W stage (bitwise conv5 + maxpool2d)
    and ``conv_block`` at block 5 (conv5 + pool5, no LRN; bitwise its staged
    chain), timed too; untimed, taps against its plain version and pairs and
    im2col bitwise taps at conv3..conv5, k_block 64 and 128 bitwise 0 at
    conv4 (conv2d, taps), and the phases pool bitwise maxpool2d at pool5."""
    import torch.nn.functional as F

    from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import cuda_kernels as ck

    rows, checks = [], []
    for pol, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        gen = torch.Generator(device="cuda").manual_seed(2028)
        t = v6_stage_inputs(dtype, gen)
        rule = FP32_REL if pol == "fp32" else ("ulp", FP32_REL)
        stages = []
        for name, _c, _k in V6_CONVS:
            x, w, b = t[name]
            kw = dict(stride=1, padding=1)
            y = ck.conv2d_bias_relu(x, w, b, **kw)
            n, ho, wo, k = y.shape
            wl = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            st = dict(
                kernel="conv2d", stage=name, peak=pol, rule=rule,
                run=lambda x=x, w=w, b=b: ck.conv2d_bias_relu(x, w, b, stride=1, padding=1),
                plain=lambda x=x, w=w, b=b: ck.conv2d_bias_relu_plain(x, w, b, stride=1, padding=1),
                library=lambda x=x, wl=wl, b=b: F.conv2d(x.permute(0, 3, 1, 2), wl, b, stride=1, padding=1),
                library_call="F.conv2d (cuDNN, channels-last, bias, no ReLU)",
                flops=2 * n * ho * wo * k * 9 * w.shape[2],
                nbytes=(x.numel() + w.numel() + b.numel() + y.numel()) * y.element_size(),
                # at stride 1 taps' term order is vcol's: one fmaf chain each (bf16: the same k-steps)
                same_as=[("conv_taps", lambda x=x, w=w, b=b: ck.conv_taps(x, w, b, stride=1, padding=1))],
            )
            stages.append(st)
            taps = ck.conv_taps(x, w, b, **kw)
            checks.append((f"conv_taps {name} {pol} vs its plain version",
                           compare(rule, taps, ck.conv_taps_plain(x, w, b, **kw))))
            for kname in ("conv_pairs", "conv_im2col"):
                checks.append((f"{kname} {name} {pol} vs conv_taps", compare("bitwise", getattr(ck, kname)(x, w, b, **kw),
                                                                             taps)))
            if name == "conv4":
                for kname in ("conv2d_bias_relu", "conv_taps"):
                    fn = getattr(ck, kname)
                    for kb in (64, 128):
                        checks.append((f"{kname} conv4 k_block={kb} {pol} vs k_block=0", compare(
                            "bitwise", fn(x, w, b, k_block=kb, **kw), fn(x, w, b, **kw))))
            if name == "conv5":
                hp = (ho - 3) // 2 + 1
                run = lambda x=x, w=w, b=b: ck.conv2d_bias_relu(x, w, b, stride=1, padding=1, hpool=(3, 2))  # noqa: E731
                stages.append(dict(
                    kernel="conv2d", stage=name, mode="hpool", peak=pol, rule=rule, run=run, library=None,
                    library_call=None, flops=st["flops"],
                    plain=lambda x=x, w=w, b=b: ck.conv2d_bias_relu_plain(x, w, b, stride=1, padding=1, hpool=(3, 2)),
                    nbytes=(x.numel() + w.numel() + b.numel() + n * hp * wo * k) * y.element_size(),
                ))
                unfused = lambda x=x, w=w, b=b: ck.maxpool2d(  # noqa: E731
                    ck.conv2d_bias_relu(x, w, b, stride=1, padding=1), window=3, stride=2)
                stages.append(w_stage("pool5", run(), unfused, "conv2d"))
                taps_h = ck.conv_taps(x, w, b, hpool=(3, 2), **kw)
                checks.append((f"conv_taps hpool + W stage conv5 {pol} vs conv_taps + maxpool2d", compare(
                    "bitwise", ck.maxpool2d_w(taps_h, window=3, stride=2), ck.maxpool2d(taps, window=3, stride=2))))
        stages.append(pool_stage("pool5", t["y5"]))
        rows += [measure(st, pol, spec, peak_name) for st in stages]
        y5 = t["y5"]
        checks.append((f"maxpool_phases pool5 {pol} vs maxpool2d", compare(
            "bitwise", ck.maxpool_phases(y5, window=3, stride=2), ck.maxpool2d(y5, window=3, stride=2))))
        checks.append((f"maxpool_phases pool5 {pol} vs its plain version", compare(
            "bitwise", ck.maxpool_phases(y5, window=3, stride=2), ck.maxpool_phases_plain(y5, window=3, stride=2))))
        x4, w5, b5 = t["conv5"]
        rows.append(block_row(block_case("block5", pol, x4, w5, b5, 1, 1, 3, 2, None), pol, spec, peak_name))
        del t, stages
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    for what, res in checks:
        log(f"v6 {what}: ok={res['ok']} tol={res['tol']} max_abs={res['max_abs_err']:.3g}")
        require(res["ok"], f"v6 check {what}: {res}")
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


def _launches(**counts) -> dict:
    """Kernel launches per forward: the counts given, 0 for every other kernel."""
    from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import cuda_kernels as ck

    return {name: counts.get(name, 0) for name in ck.LAUNCHES}


STAGED = dict(conv2d=2, maxpool2d=2, lrn=1)
MAIN_RUNS = (
    # (config, policy, TPU_FRAMEWORK_* knobs, kernel launches per forward)
    ("v3_pallas", "fp32", {}, STAGED), ("v3_pallas", "bf16", {}, STAGED),
    ("v1_jit", "fp32", {}, {}), ("v1_jit", "bf16", {}, {}),
    ("v3_pallas", "fp32", {"FUSE": "block"}, dict(conv_block=2)),
    ("v3_pallas", "bf16", {"FUSE": "block"}, dict(conv_block=2)),
    ("v3_pallas", "int8w", {"FUSE": "block"}, dict(conv_block=2)),
    # int8w staged: the LRN is the fp32 reference op
    ("v3_pallas", "int8w", {}, dict(conv2d=2, maxpool2d=2)), ("v1_jit", "int8w", {}, {}),
    *[(key, pol, knobs, counts) for knobs, counts in (
        ({"CONV": "taps"}, dict(conv_taps=2, maxpool2d=2, lrn=1)),
        ({"CONV": "pairs"}, dict(conv_pairs=2, maxpool2d=2, lrn=1)),
        ({"CONV": "fused"}, dict(conv_im2col=2, maxpool2d=2, lrn=1)),
        # g8 runs conv1 (stride 4); conv2 (stride 1) falls back to vcol, as in the JAX package
        ({"CONV": "g8"}, dict(conv_g8=1, conv2d=1, maxpool2d=2, lrn=1)),
        # the phases pool packs its stack with a kernel of its own
        ({"POOL": "phases"}, dict(conv2d=2, pool_phases_pack=2, maxpool_phases=2, lrn=1)),
        # the conv kernel takes the pool's H max; maxpool2d runs the W stage
        ({"FUSE": "hpool"}, dict(conv2d=2, maxpool2d=2, lrn=1)),
        # k_block 128 applies to conv2 (K=256); conv1 (K=96) runs unblocked
        ({"KBLOCK": "128"}, STAGED),
    ) for key, pol in (("v3_pallas", "fp32"), ("v3_pallas", "bf16"))],
    ("v3_pallas", "int8w", {"CONV": "taps"}, dict(conv_taps=2, maxpool2d=2)),
)
_KNOB_FIELD = {"FUSE": "fuse", "CONV": "conv", "POOL": "pool", "KBLOCK": "k_block", "ROWBLOCK": "row_block"}


def run_name(key, pol, knobs) -> str:
    return f"{key}{''.join(f'+{k}={v}' for k, v in knobs.items())}/{pol}"


def run_variants(key, knobs):
    """The KernelVariants a route's knobs set (None for the reference tier)."""
    from cuda_mpi_gpu_cluster_programming_tpu_torch.ops.variants import KernelVariants

    if not key.endswith("_pallas"):
        return None
    return KernelVariants(**{_KNOB_FIELD[k]: int(v) if k in ("KBLOCK", "ROWBLOCK") else v for k, v in knobs.items()})


@contextlib.contextmanager
def knob_env(knobs):
    """Set the ``TPU_FRAMEWORK_*`` variables of ``knobs`` (and clear the
    others) for the block; restore them after."""
    names = [f"TPU_FRAMEWORK_{k}" for k in _KNOB_FIELD]
    saved = {n: os.environ.get(n) for n in names}
    try:
        for n in names:
            os.environ.pop(n, None)
        for k, v in knobs.items():
            os.environ[f"TPU_FRAMEWORK_{k}"] = v
        yield
    finally:
        for n, v in saved.items():
            if v is None:
                os.environ.pop(n, None)
            else:
                os.environ[n] = v


def drive(key, pol, knobs, per_forward, shape="13x13x256", extra=()) -> dict:
    """One main-path run through ``run.main`` with the route's knobs set in
    the environment for the call; the launch counts are set to 0 just
    before it and read just after. No route may degrade."""
    from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import cuda_kernels as ck

    with knob_env(knobs):
        ck.reset_launches()
        out = run_cli(["--config", key, "--dtype", pol, "--batch", str(BATCH), "--init", "random",
                       "--repeats", "10", "--warmup", "3", *extra])
        launches = dict(ck.LAUNCHES)
    name = run_name(key, pol, knobs)
    passes = int(re.search(r"^Kernel launches: .* passes=(\d+)$", out, re.M).group(1))
    got_shape = re.search(r"^Final Output Shape: (\S+)$", out, re.M).group(1)
    first10 = [float(v) for v in re.search(r"^Final Output \(first 10 values\): (.+)$", out, re.M).group(1).split()]
    ms = float(re.search(r"completed in ([0-9.]+) ms", out).group(1))
    log(f"main path {name}: {ms:.3f} ms/pass at batch {BATCH} ({BATCH / ms * 1e3:.1f} img/s) "
        f"launches={launches} passes={passes}")
    require(got_shape == shape, f"{name}: output shape {got_shape}")
    require("DEGRADED" not in out, f"{name} degraded:\n{out}")
    require(all(np.isfinite(first10)), f"{name}: non-finite output {first10}")
    want = {k: n * passes for k, n in _launches(**per_forward).items()}
    require(passes > 0 and launches == want, f"{name}: launches {launches}, want {want}")
    return dict(per_pass_ms=ms, images_per_sec=BATCH / ms * 1e3, launches=launches, passes=passes, stdout=out)


def main_path_phase() -> dict:
    """Phase 3: the port's main paths through their entry points."""
    from cuda_mpi_gpu_cluster_programming_tpu_torch import configs
    from cuda_mpi_gpu_cluster_programming_tpu_torch.models import init
    from cuda_mpi_gpu_cluster_programming_tpu_torch.models.alexnet import BLOCKS12
    from cuda_mpi_gpu_cluster_programming_tpu_torch.precision.gate import ToleranceGate

    result = {"runs": {}}
    for key, pol, knobs, per_forward in MAIN_RUNS:
        result["runs"][run_name(key, pol, knobs)] = drive(key, pol, knobs, per_forward)

    for key, pol, knobs, _n in MAIN_RUNS:
        if pol != "fp32":
            continue
        name = run_name(key, pol, knobs)
        with knob_env({}):
            fwd = configs.build_forward(configs.REGISTRY[key], variants=run_variants(key, knobs))
        got = fwd(init.init_params_deterministic(), init.deterministic_input(1))[0].reshape(-1)[:10].cpu().numpy()
        log(f"golden {name}: {' '.join(f'{v:.4f}' for v in got)}")
        require(np.allclose(got, GOLDEN_FIRST10, rtol=2e-5, atol=0), f"{name} golden first-10 {got}")
        result[f"golden/{name}"] = got.tolist()

    rng = np.random.default_rng(2026)
    params = init.params_from_jax({
        "conv1": {"w": rng.random((11, 11, 3, 96), dtype=np.float32), "b": np.full(96, 0.1, np.float32)},
        "conv2": {"w": rng.random((5, 5, 96, 256), dtype=np.float32), "b": np.full(256, 0.1, np.float32)},
    })
    x = torch.from_numpy(rng.random((BATCH, 227, 227, 3), dtype=np.float32)).cuda()
    outs = {}
    for key, pol, knobs, _n in MAIN_RUNS:
        with knob_env({}):
            fwd = configs.build_forward(configs.REGISTRY[key], policy=pol, variants=run_variants(key, knobs))
        outs[run_name(key, pol, knobs)] = fwd(params, x)
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
        for knobs in ({"FUSE": "block"}, {"FUSE": "hpool"}, {"POOL": "phases"}, {"KBLOCK": "128"}):
            name = run_name("v3_pallas", pol, knobs)
            same = bool(torch.equal(outs[name], outs[f"v3_pallas/{pol}"]))
            log(f"{name} bitwise equal to staged v3_pallas/{pol}: {same}")
            require(same, f"{name} differs from the staged kernel chain")
        # taps, pairs and fused sum each output in the same order on the Hopper mainloop: in fp32 one fmaf
        # chain, in bf16 the same tensor-core k-steps, so the three routes give one output's bits
        for conv, ref in (("pairs", "taps"), ("fused", "taps")):
            same = bool(torch.equal(outs[run_name("v3_pallas", pol, {"CONV": conv})],
                                    outs[run_name("v3_pallas", pol, {"CONV": ref})]))
            log(f"v3_pallas+CONV={conv}/{pol} bitwise equal to v3_pallas+CONV={ref}/{pol}: {same}")
            require(same, f"CONV={conv} differs from CONV={ref} in {pol}")
    staged, fused_out = outs["v3_pallas/int8w"], outs["v3_pallas+FUSE=block/int8w"]
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


V6_STAGED = dict(conv2d=5, maxpool2d=3, lrn=1)
V6_RUNS = (
    # (config, policy, TPU_FRAMEWORK_* knobs, kernel launches per forward); the FC head is cuBLAS on every route
    ("v6_full_pallas", "fp32", {}, V6_STAGED), ("v6_full_pallas", "bf16", {}, V6_STAGED),
    # conv1, conv2 (with LRN2) and conv5 each one block; conv3 and conv4 have no pool to fuse
    ("v6_full_pallas", "fp32", {"FUSE": "block"}, dict(conv_block=3, conv2d=2)),
    ("v6_full_pallas", "bf16", {"FUSE": "block"}, dict(conv_block=3, conv2d=2)),
    # the three pools' H max in their convs' epilogues; maxpool2d runs their W stages
    ("v6_full_pallas", "fp32", {"FUSE": "hpool"}, V6_STAGED), ("v6_full_pallas", "bf16", {"FUSE": "hpool"}, V6_STAGED),
    ("v6_full_jit", "fp32", {}, {}), ("v6_full_jit", "bf16", {}, {}),
)
# every v6 route against v6_full_jit fp32 on He-scaled params: fp32 the JAX package's cross-tier tolerance of full
# AlexNet (tests/test_alexnet_full.py: rtol 2e-5, atol 2e-4); bf16 the bf16 budget, 2e-2 of the oracle's max
V6_RTOL, V6_ATOL = 2e-5, 2e-4
V6_LAYERS = ("conv1", "pool1", "conv2", "pool2", "lrn2", "conv3", "conv4", "conv5", "pool5", "fc6", "fc7", "fc8")


def v6_he_params(rng):
    """Full AlexNet's params drawn with numpy: He-normal weights, bias 0.1
    (``init_full_random``'s distribution; the constant init makes every
    logit equal)."""
    from cuda_mpi_gpu_cluster_programming_tpu_torch.models import init
    from cuda_mpi_gpu_cluster_programming_tpu_torch.models.alexnet_full import ALEXNET, _param_shapes

    tree = {name: {"w": (rng.standard_normal(ws, dtype=np.float32) * np.float32((2.0 / np.prod(ws[:-1])) ** 0.5)),
                   "b": np.full(bs, 0.1, np.float32)} for name, (ws, bs) in _param_shapes(ALEXNET).items()}
    return init.params_from_jax(tree)


def v6_path_phase() -> dict:
    """Phase 3, full AlexNet through ``run.main`` (``V6_RUNS``), launch counts
    set to 0 before each run and read after; every route against
    ``v6_full_jit`` fp32 on He-scaled params, the fused routes bitwise the
    staged one in fp32; then the flags: ``--save-params`` / ``--params``,
    ``--input native``, ``--trace`` and the one chaos drill
    (``kernel_compile`` with ``--fallback-chain auto``: v6_full_pallas
    degrades to v6_full_jit and launches no kernel)."""
    from cuda_mpi_gpu_cluster_programming_tpu_torch import configs
    from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import cuda_kernels as ck
    from cuda_mpi_gpu_cluster_programming_tpu_torch.resilience import chaos
    from cuda_mpi_gpu_cluster_programming_tpu_torch.resilience.journal import Journal

    result = {"runs": {}}
    for key, pol, knobs, per_forward in V6_RUNS:
        result["runs"][run_name(key, pol, knobs)] = drive(key, pol, knobs, per_forward, shape="1000")

    rng = np.random.default_rng(2029)
    params = v6_he_params(rng)
    x = torch.from_numpy(rng.random((BATCH, 227, 227, 3), dtype=np.float32)).cuda()
    outs = {}
    for key, pol, knobs, _n in V6_RUNS:
        with knob_env({}):
            fwd = configs.build_forward(configs.REGISTRY[key], policy=pol, variants=run_variants(key, knobs))
        outs[run_name(key, pol, knobs)] = fwd(params, x)
    oracle = outs["v6_full_jit/fp32"]
    omax = float(oracle.abs().max())
    for name, out in outs.items():
        pol = name.split("/")[-1]
        require(tuple(out.shape) == (BATCH, 1000) and bool(torch.isfinite(out).all()), f"{name} output")
        err = float((out - oracle).abs().max())
        ok = (bool(((out - oracle).abs() <= V6_ATOL + V6_RTOL * oracle.abs()).all()) if pol == "fp32"
              else err / omax <= BF16_REL)
        log(f"budget {name} vs v6_full_jit fp32: max_abs={err:.3g} rel_of_max={err / omax:.3g} ok={ok}")
        require(ok, f"{name} outside its budget against v6_full_jit fp32")
        result[f"budget/{name}"] = dict(max_abs=err, rel_of_max=err / omax)
    for pol in ("fp32", "bf16"):
        for knobs in ({"FUSE": "block"}, {"FUSE": "hpool"}):
            name = run_name("v6_full_pallas", pol, knobs)
            same = bool(torch.equal(outs[name], outs[f"v6_full_pallas/{pol}"]))
            log(f"{name} bitwise equal to staged v6_full_pallas/{pol}: {same}")
            require(same or pol != "fp32", f"{name} differs from the staged route in fp32")
            result[f"bitwise/{name}"] = same
    del outs, oracle

    out_dir = Path("chip_smoke_out")
    out_dir.mkdir(exist_ok=True)
    npz, trace = out_dir / "v6_params.npz", out_dir / "v6_trace.jsonl"
    npz.unlink(missing_ok=True)
    trace.unlink(missing_ok=True)
    small = ["--batch", "8", "--repeats", "3", "--warmup", "2", "--init", "random", "--seed", "5"]

    def first10(out):
        return re.search(r"^Final Output \(first 10 values\): (.+)$", out, re.M).group(1)

    with knob_env({}):
        saved = run_cli(["--config", "v6_full_pallas", *small, "--save-params", str(npz)])
        loaded = run_cli(["--config", "v6_full_pallas", *small, "--params", str(npz)])
        native = {key: run_cli(["--config", key, *small, "--params", str(npz), "--input", "native"])
                  for key in ("v6_full_pallas", "v6_full_jit")}
        traced = run_cli(["--config", "v6_full_pallas", *small, "--trace", str(trace)])
        os.environ["CHAOS_SPEC"] = "kernel_compile=1"
        chaos.reset()
        try:
            ck.reset_launches()
            drill = run_cli(["--config", "v6_full_pallas", *small, "--fallback-chain", "auto"])
            drill_launches = dict(ck.LAUNCHES)
        finally:
            os.environ.pop("CHAOS_SPEC")
            chaos.reset()
    log(f"--save-params then --params: {first10(saved)} | {first10(loaded)}")
    require(f"Saved params to {npz}" in saved and f"Loaded params from {npz}" in loaded
            and first10(saved) == first10(loaded), "the --save-params / --params round trip")
    got = {k: np.array(first10(v).split(), dtype=np.float64) for k, v in native.items()}
    log(f"--input native: v6_full_pallas {first10(native['v6_full_pallas'])} | v6_full_jit "
        f"{first10(native['v6_full_jit'])}")
    require(all("Final Output Shape: 1000" in v and "DEGRADED" not in v for v in native.values())
            and np.allclose(got["v6_full_pallas"], got["v6_full_jit"], rtol=V6_RTOL, atol=V6_ATOL),
            "--input native on the two v6 tiers")
    spans = [r for r in Journal.load(trace) if r["kind"] == "span" and r["name"] == "run.measure"]
    log(f"--trace: {re.search(r'^Trace: .*$', traced, re.M).group(0)}; run.measure spans {len(spans)}")
    require(len(spans) == 1 and spans[0]["attrs"]["per_pass_ms"] > 0 and "DEGRADED" not in traced, "--trace")
    degraded = re.search(r"^DEGRADED\(.*$", drill, re.M)
    log(f"chaos drill: {degraded.group(0) if degraded else 'no DEGRADED line'}; launches after it {drill_launches}")
    require(degraded is not None and degraded.group(0).startswith("DEGRADED(v6_full_pallas -> v6_full_jit)")
            and "Final Output Shape: 1000" in drill and drill_launches == _launches(), "the chaos drill")
    result["flags"] = dict(save_params=first10(saved), params=first10(loaded),
                           native={k: first10(v) for k, v in native.items()}, trace_spans=spans,
                           drill=degraded.group(0), drill_launches=drill_launches)

    # the per-layer split of both tiers (run --breakdown): conv1..pool5, then the FC head's three matmuls
    for key in ("v6_full_pallas", "v6_full_jit"):
        for pol in ("fp32", "bf16"):
            with knob_env({}):
                text = run_cli(["--config", key, "--dtype", pol, "--batch", str(BATCH), "--init", "random",
                                "--repeats", "3", "--warmup", "1", "--breakdown"])
            lines = re.findall(r"^Layer (\S+) completed in ([0-9.]+) ms -> (\S+)$", text, re.M)
            require([n for n, _ms, _s in lines] == [*V6_LAYERS] and lines[-1][2] == "1000",
                    f"run --breakdown {key}/{pol}:\n{text}")
            log(f"run.main --config {key} --dtype {pol} --breakdown: " + " ".join(f"{n}={ms}" for n, ms, _s in lines))
            result[f"breakdown/{key}/{pol}"] = {n: float(ms) for n, ms, _s in lines}
    return result


BENCH_CALLS = (
    # the environment of one ``python -m <port>.bench`` call, and the rows it prints as (config, dtype, granularity)
    (dict(BENCH_CONFIGS="v1_jit,v3_pallas", BENCH_DTYPE="fp32"), (("v1_jit", "fp32", "stage"),
                                                                   ("v3_pallas", "fp32", "stage"))),
    (dict(BENCH_CONFIG="v3_pallas", BENCH_DTYPE="int8w"), (("v3_pallas", "int8w", "skipped"),)),
    (dict(BENCH_CONFIG="v3_pallas", BENCH_DTYPE="bf16", TPU_FRAMEWORK_FUSE="block"),
     (("v3_pallas", "bf16", "block"),)),
)


def share_ok(v) -> bool:
    return isinstance(v, (int, float)) and 0 < v <= 1


def check_bench_row(row, config, dtype, granularity, runs, fused) -> dict:
    """One bench row against the contract, logged beside phase 3's reading
    of its route. ``granularity``: the breakdown's (stage or block),
    "skipped" where it has none, None for a ``bf16`` sub-object (which
    carries no breakdown)."""
    from cuda_mpi_gpu_cluster_programming_tpu_torch.observability.stages import BLOCK_STAGES, SENTINEL_STAGES

    name = f"{config}{'+FUSE=block' if fused else ''}/{dtype}"
    require("error" not in row and isinstance(row.get("value"), (int, float)) and row["value"] > 0,
            f"bench {name}: {row}")
    require(share_ok(row["mfu"]), f"bench {name}: mfu {row['mfu']}")
    frac = row["fp32_ceiling_fraction"]
    require(share_ok(frac) if dtype == "fp32" else frac is None, f"bench {name}: fp32_ceiling_fraction {frac}")
    run_ms = runs[name]["per_pass_ms"]
    log(f"bench {name}: per_pass_ms={row['per_pass_ms']} ({row['value']} img/s, mfu={row['mfu']}, "
        f"fp32_ceiling_fraction={frac}, n={row['timing_n']} ci95={row['timing_ci95_ms']}) "
        f"beside run.main {run_ms:.3f} ms (phase 3)")
    out = dict(per_pass_ms=row["per_pass_ms"], value=row["value"], mfu=row["mfu"], fp32_ceiling_fraction=frac,
               run_main_per_pass_ms=run_ms)
    if granularity is None:
        return out
    require(row["platform"] == "gpu", f"bench {name}: platform {row['platform']}")
    bd, rf = row["breakdown"], row["roofline"]
    if granularity == "skipped":
        require("skipped" in bd and "skipped" in rf, f"bench {name}: breakdown {bd} roofline {rf}")
        log(f"bench {name}: breakdown {bd['skipped']}")
        return out
    names = BLOCK_STAGES if granularity == "block" else SENTINEL_STAGES
    require(list(bd.get("stages", {})) == list(names) and bd["granularity"] == granularity,
            f"bench {name}: breakdown {bd}")
    require(abs(bd["stage_sum_ms"] - bd["total_ms"]) <= 1e-4, f"bench {name}: stages do not sum to total {bd}")
    require("stages" in rf and sorted(s["name"] for s in rf["stages"]) == sorted(names), f"bench {name}: {rf}")
    log(f"bench {name} breakdown ({bd['tier']}, total {bd['total_ms']} ms): "
        + " ".join(f"{k}={v}" for k, v in bd["stages"].items()))
    log(f"bench {name} roofline (peak {rf['peak_tflops']} TF/s, pass_mfu {rf['pass_mfu']}): " + "; ".join(
        f"{s['name']} {s['ms']} ms {s['bound']} mfu={s['mfu']} floor={s['floor_ms']}"
        + (" NOTE above its roof" if s.get("note") else "") for s in rf["stages"]))
    return dict(out, breakdown=bd, roofline=rf)


def bench_phase(runs) -> dict:
    """Phase 3e: the bench's measure mode through ``python -m``, its rows
    held to the row contract beside phase 3's ``run.main`` readings; the
    breakdown's launches; ``run.main --breakdown --profile``."""
    from cuda_mpi_gpu_cluster_programming_tpu_torch.models import init
    from cuda_mpi_gpu_cluster_programming_tpu_torch.observability import stages
    from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import cuda_kernels as ck
    from cuda_mpi_gpu_cluster_programming_tpu_torch.ops.variants import KernelVariants
    from cuda_mpi_gpu_cluster_programming_tpu_torch.utils.profiling import TRACE_FILE, cast_for_compute

    t0 = time.perf_counter()
    result = {"rows": {}}
    for env_extra, expected in BENCH_CALLS:
        env = {k: v for k, v in os.environ.items() if not k.startswith(("BENCH_", "TPU_FRAMEWORK_"))}
        env.update(env_extra, BENCH_MAX_RETRIES="0")
        t_call = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", f"{PORT}.bench"], capture_output=True, text=True, env=env,
                              timeout=900)
        require(proc.returncode == 0, f"bench {env_extra}: rc {proc.returncode}\n{proc.stderr[-3000:]}")
        rows = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
        result.setdefault("raw_rows", []).extend(rows)  # phase 3g's regression gate reads them as rounds
        log(f"bench call {env_extra}: {time.perf_counter() - t_call:.1f} s, {len(rows)} rows; "
            + " | ".join(line for line in proc.stderr.splitlines() if line.startswith("bench:")))
        require(len(rows) == len(expected), f"bench {env_extra}: rows {proc.stdout[-3000:]}")
        fused = env_extra.get("TPU_FRAMEWORK_FUSE") == "block"
        for row, (config, dtype, granularity) in zip(rows, expected):
            require(row.get("config") == config and row.get("dtype") == dtype, f"bench {env_extra}: {row}")
            key = f"{config}{'+FUSE=block' if fused else ''}/{dtype}"
            result["rows"][key] = check_bench_row(row, config, dtype, granularity, runs, fused)
            if dtype == "fp32":
                sub = row.get("bf16")
                require(isinstance(sub, dict), f"bench {key}: no bf16 sub-object")
                result["rows"][f"{config}/bf16 (sub-object)"] = check_bench_row(sub, config, "bf16", None, runs, False)

    # the breakdown's full prefix launches what the pass launches
    gen = torch.Generator().manual_seed(7)
    params = init.init_params_random(gen, device="cuda")
    x = init.random_input(gen, BATCH, device="cuda")
    for knobs, want in (({}, STAGED), ({"FUSE": "block"}, dict(conv_block=2))):
        with knob_env(knobs):
            fns = (stages.block_stage_fns(variants=KernelVariants.resolve()) if knobs
                   else stages.sentinel_stage_fns(tier="kernels"))
        for pol in ("fp32", "bf16"):
            p, xc = cast_for_compute(params, x, pol)
            ck.reset_launches()
            out = stages.stage_prefix(fns, len(fns))(p, xc)
            torch.cuda.synchronize()
            launches = dict(ck.LAUNCHES)
            require(launches == _launches(**want) and tuple(out.shape) == (BATCH, 13, 13, 256),
                    f"breakdown prefix {knobs} {pol}: launches {launches}")
            log(f"breakdown full prefix {run_name('v3_pallas', pol, knobs)}: launches "
                + " ".join(f"{k}={v}" for k, v in launches.items() if v))
            result[f"prefix_launches/{run_name('v3_pallas', pol, knobs)}"] = launches

    prof_dir = Path("chip_smoke_out") / "profile"
    trace = prof_dir / TRACE_FILE
    for key, extra, layers in (("v3_pallas", ["--profile", str(prof_dir)], 5), ("v1_jit", [], 7)):
        text = run_cli(["--config", key, "--batch", str(BATCH), "--init", "random", "--repeats", "3",
                        "--warmup", "1", "--breakdown", *extra])
        lines = re.findall(r"^Layer (\S+) completed in ([0-9.]+) ms -> (\S+)$", text, re.M)
        require(len(lines) == layers and lines[-1][2] == "13x13x256", f"run --breakdown {key}:\n{text}")
        require(not extra or f"Profiler trace written to {trace}" in text, f"run --profile:\n{text}")
        log(f"run.main --config {key} --breakdown: " + " ".join(f"{n}={ms}" for n, ms, _s in lines))
        result[f"run_breakdown/{key}"] = {n: float(ms) for n, ms, _s in lines}
    require(trace.exists() and trace.stat().st_size > 0, f"run --profile wrote no {trace}")
    events = json.loads(trace.read_text()).get("traceEvents", [])
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    log(f"run.main --profile: {trace} {trace.stat().st_size} bytes, {len(events)} events, {kernels} device kernels")
    result["profile"] = dict(path=str(trace), bytes=trace.stat().st_size, events=len(events), kernels=kernels)
    result["seconds"] = time.perf_counter() - t0
    log(f"phase 3e wall time: {result['seconds']:.1f} s")
    return result


# phase 3f, the inference service: request sizes of the drained stream, its largest bucket, the servers
# (config, policy) and the kernels a v3_pallas dispatch launches, by a name in their torch.profiler key
SERVE_SIZES = [1, 3, 2, 1, 4, 8, 5]
SERVE_MAX_BATCH = 8
SERVE_SERVERS = (("v1_jit", "fp32"), ("v3_pallas", "fp32"), ("v3_pallas", "bf16"))
SERVE_MARKERS = {"conv2d": "conv_tiles", "maxpool2d": "maxpool_band_kernel", "lrn": "lrn_kernel"}
# names of the kernels a cuDNN or cuBLAS convolution runs (none may run in a v3_pallas dispatch)
LIBRARY_CONV_MARKS = ("cudnn", "fprop", "xmma", "implicit_gemm", "winograd", "fft", "cutlass", "nvjet", "gemm")
SERVE_TIMED = 30  # dispatches timed per bucket, graph and eager each


def replay_kernels(fn, reps: int = 1, attempts: int = 3) -> dict:
    """The device kernels of ``reps`` calls of ``fn`` by ``torch.profiler``:
    {kernel key: launches}, and their device ms a call. A trace that shows
    no device kernel at all is taken again, up to ``attempts`` traces in
    all (the profiler lost one trace of many in a row on the card); empty
    after that (not measured)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        counts, device_us = {}, 0.0
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
                counts[e.key] = counts.get(e.key, 0) + e.count
                device_us += e.self_device_time_total
        if counts:
            break
    return dict(counts=counts, device_ms=device_us / 1e3 / reps if counts else None)


def graph_kernel_nodes(dot: str) -> list:
    """The kernel nodes of a graph that ``CUDAGraph.debug_dump`` printed:
    the function name of each, in node order."""
    names = []
    for chunk in re.split(r'^\s*"graph_\d+_node_\d+"\s*\[', dot, flags=re.M)[1:]:
        if "KERNEL" not in chunk.split("|", 1)[0]:
            continue
        m = re.search(r"\{\s*ID\s*\|[^|]*\|\s*([^}]*)\}", chunk)  # {ID | 0 (topoId: 4) | name\<\<\<grid\>\>\>}
        require(m is not None, f"a kernel node with no function name: {chunk[:1000]}")
        names.append(m.group(1).strip())
    return names


def by_marker(counts: dict) -> dict:
    """Launches of the serve path's kernels in a profile's counts."""
    return {name: sum(n for k, n in counts.items() if mark in k) for name, mark in SERVE_MARKERS.items()}


def dispatch_times(srv, bucket: int, xb: np.ndarray, per_dispatch=None) -> dict:
    """One dispatch's host wall ms at ``bucket`` (median of ``SERVE_TIMED``),
    from the padded batch in pinned host memory: the graph (copy into the
    static input, replay, fence: ``_dispatch``'s timed region) against the
    same forward called eagerly on the same static input after the same
    copy, and each one's device ms by ``torch.profiler`` (a trace that lost
    any of ``per_dispatch``'s launches, default ``STAGED``: not measured)."""
    graphs, fwd, params = srv._graphs, srv._fwd, srv._params
    static_in = graphs.static_input(bucket)
    np.copyto(graphs.host_buffer(bucket), xb)
    host = torch.from_numpy(xb).pin_memory()

    def graph_call():
        graphs.run(bucket, graphs.host_buffer(bucket))
        graphs.fence()

    def eager_call():
        static_in.copy_(host, non_blocking=True)
        fwd(params, static_in)
        graphs.fence()

    out = {}
    for name, call in (("graph", graph_call), ("eager", eager_call), ("graph", graph_call), ("eager", eager_call)):
        for _ in range(3):
            call()
        times = []
        for _ in range(SERVE_TIMED):
            t0 = time.perf_counter()
            call()
            times.append((time.perf_counter() - t0) * 1e3)
        out.setdefault(f"{name}_ms", []).append(statistics.median(times))
    res = {k: min(v) for k, v in out.items()}  # two interleaved rounds each; the lower median
    for name, call in (("graph", graph_call), ("eager", eager_call)):
        # a trace that lost any of the five calls' kernels would understate the mean: not measured
        prof = replay_kernels(call, reps=5)
        whole = by_marker(prof["counts"]) == {k: 5 * (per_dispatch or STAGED).get(k, 0) for k in SERVE_MARKERS}
        res[f"{name}_device_ms"] = prof["device_ms"] if whole else None
    res["speedup"] = res["eager_ms"] / res["graph_ms"]
    return res


def serve_inputs() -> tuple:
    """The serve phases' params (uniform [0, 1) weights, bias 0.1) and the
    request stream of ``SERVE_SIZES`` 227x227 images, from one seed."""
    from cuda_mpi_gpu_cluster_programming_tpu_torch.models import init

    rng = np.random.default_rng(2026)
    params = init.params_from_jax({
        "conv1": {"w": rng.random((11, 11, 3, 96), dtype=np.float32), "b": np.full(96, 0.1, np.float32)},
        "conv2": {"w": rng.random((5, 5, 96, 256), dtype=np.float32), "b": np.full(256, 0.1, np.float32)},
    })
    return params, [rng.random((n, 227, 227, 3), dtype=np.float32) for n in SERVE_SIZES]


def entry_batches(records) -> list:
    """(bucket, n_requests, n_images, pad) of each ``serve_batch`` record."""
    return [(r["bucket"], r["n_requests"], r["n_images"], r["pad"]) for r in records if r["kind"] == "serve_batch"]


def serve_phase(spec, peak_name) -> dict:
    """Phase 3f: the inference service on the card at 227x227, max_batch 8."""
    from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import cuda_kernels as ck
    from cuda_mpi_gpu_cluster_programming_tpu_torch.resilience.journal import Journal
    from cuda_mpi_gpu_cluster_programming_tpu_torch.serving.loadgen import run_load
    from cuda_mpi_gpu_cluster_programming_tpu_torch.serving.server import InferenceServer, ServeConfig

    t0 = time.perf_counter()
    out_dir = Path("chip_smoke_out")
    out_dir.mkdir(exist_ok=True)
    params, xs = serve_inputs()
    result = {"servers": {}}
    served = {}
    for key, pol in SERVE_SERVERS:
        name = f"{key}/{pol}"
        journal = out_dir / f"serve_{key}_{pol}.jsonl"
        journal.unlink(missing_ok=True)
        srv = InferenceServer(ServeConfig(config=key, compute=pol, max_batch=SERVE_MAX_BATCH, journal_path=str(journal)),
                              params=params)
        with knob_env({}):
            srv.run_until_drained()  # builds (the staged route), then captures every bucket
        handles = [srv.submit(x) for x in xs]
        ck.reset_launches()
        srv.run_until_drained()
        counter_launches = dict(ck.LAUNCHES)  # the drained run's: its replays' (every bucket was captured)
        require([h.status for h in handles] == ["OK"] * len(xs), f"serve {name}: {[h.error for h in handles]}")
        require(srv.stats.cache_misses == 0 and srv.stats.warmup_compiles == len(srv.buckets) == 4,
                f"serve {name}: {srv.summary()}")
        batches = [r for r in Journal.load(journal) if r["kind"] == "serve_batch"]
        # each result bitwise the eager forward on its padded bucket, sliced
        pending = list(zip(xs, handles))
        for rec in batches:
            mine = [pending.pop(0) for _ in range(rec["n_requests"])]
            padded = np.concatenate([x for x, _h in mine] + [np.zeros((rec["pad"], 227, 227, 3), np.float32)])
            eager = srv._fwd(params, torch.from_numpy(padded).cuda()).cpu().numpy()
            off = 0
            for x, h in mine:
                require(np.array_equal(h.result, eager[off : off + len(x)]),
                        f"serve {name}: bucket {rec['bucket']} differs from the eager forward")
                off += len(x)
        require(not pending, f"serve {name}: {len(pending)} requests in no serve_batch record")
        served[name] = [h.result for h in handles]
        if name == "v3_pallas/bf16":  # what phase 3g's server is held to (main() takes it out of the dump)
            result["bf16_served"] = dict(results=served[name], batches=entry_batches(batches))
        entry = dict(
            buckets=list(srv.buckets), batches=entry_batches(batches),
            warmup_ms={r["bucket"]: r["ms"] for r in Journal.load(journal) if r["kind"] == "serve_warm"},
            counter_launches=counter_launches, dispatch={},
        )
        if key == "v3_pallas":
            # the drained run's launches, counted where they happen: a wrapper at a call, a graph at a replay (the
            # launches its capture recorded); each dispatch replays its bucket's graph once, and each graph holds
            # the kernel nodes CUDA prints of it
            run_launches = {k: counter_launches[k] for k in STAGED}
            nodes = {}
            for bucket in srv.buckets:
                dot = srv._graphs.dump(bucket, out_dir / f"serve_graph_{pol}_{bucket}.dot")
                names = graph_kernel_nodes(dot)
                nodes[bucket] = {k: sum(mark in n for n in names) for k, mark in SERVE_MARKERS.items()}
                foreign = [n for n in names if not any(mark in n for mark in SERVE_MARKERS.values())
                           and any(m in n.lower() for m in LIBRARY_CONV_MARKS)]
                log(f"serve {name} bucket {bucket}: graph kernel nodes {nodes[bucket]} of {len(names)}; "
                    f"capture counted {srv._graphs.kernels(bucket)}")
                require(nodes[bucket] == STAGED == srv._graphs.kernels(bucket),
                        f"serve {name} bucket {bucket}: nodes {nodes[bucket]} counted {srv._graphs.kernels(bucket)} "
                        f"want {STAGED}; kernel nodes {names}")
                require(not foreign, f"serve {name} bucket {bucket}: a library conv in the graph: {foreign}")
            want = {k: sum(nodes[b][k] for b, *_ in entry["batches"]) for k in STAGED}
            require(run_launches == want and all(v > 0 for v in want.values()),
                    f"serve {name}: the drained run launched {run_launches}, its dispatches' graphs hold {want}")
            entry.update(run_launches=run_launches, graph_nodes=nodes)
            xb = xs[SERVE_SIZES.index(SERVE_MAX_BATCH)]
            for bucket in srv.buckets:
                entry["dispatch"][bucket] = d = dispatch_times(srv, bucket, xb[:bucket])
                log(f"serve {name} dispatch bucket {bucket}: graph {d['graph_ms']:.4f} ms, eager {d['eager_ms']:.4f} ms "
                    f"(x{d['speedup']:.2f}); device graph {_fmt(d['graph_device_ms'])}, eager "
                    f"{_fmt(d['eager_device_ms'])}")
        log(f"serve {name}: {srv.summary()} batches {entry['batches']} warmup ms {entry['warmup_ms']} counters "
            + " ".join(f"{k}={v}" for k, v in counter_launches.items() if v))
        if name == "v3_pallas/fp32":
            # the threaded path: the dispatch thread replays what start() captured on this one
            srv.start()
            try:
                rep = run_load(srv, rate_rps=50.0, duration_s=3.0, seed=0)
            finally:
                srv.stop()
            log(f"serve {name} run_load 50 req/s 3 s: {rep.summary()}")
            require(rep.n_failed == 0 and rep.n_ok + rep.n_shed + rep.n_rejected == rep.n_requests > 0
                    and srv.stats.cache_misses == 0, f"serve {name} run_load: {rep.summary()}")
            entry["load"] = dict(summary=rep.summary(), p50_ms=rep.p50_ms, p99_ms=rep.p99_ms,
                                 img_s=rep.sustained_img_s, n_requests=rep.n_requests, n_ok=rep.n_ok)
        srv.close()
        result["servers"][name] = entry
    oracle = np.concatenate(served["v1_jit/fp32"])
    omax = float(np.abs(oracle).max())
    for name in ("v3_pallas/fp32", "v3_pallas/bf16"):
        err = float(np.abs(np.concatenate(served[name]) - oracle).max())
        pol = name.split("/")[1]
        ok = (err <= FP32_ABS and err / omax <= FP32_REL) if pol == "fp32" else err / omax <= BF16_REL
        log(f"serve budget {name} vs v1_jit/fp32 served: max_abs={err:.3g} rel_of_max={err / omax:.3g} ok={ok}")
        require(ok, f"serve {name} outside its budget against the served fp32 oracle")
        result[f"budget/{name}"] = dict(max_abs=err, rel_of_max=err / omax)
    result["rows8"] = kernel_phase(spec, peak_name, batch=SERVE_MAX_BATCH)
    result["bench"] = serve_bench_calls()
    text = run_cli(["--config", "v3_pallas", "--serve", "--serve-frontend", "0", "--traffic-shape", "diurnal+burst"])
    require(re.search(r"^Serve frontend: url=http://127\.0\.0\.1:\d+$", text, re.M) is not None, f"run --serve:\n{text}")
    require(re.search(r"^Serve: .* failed=0 cache_misses=0 ", text, re.M) is not None, f"run --serve:\n{text}")
    log("run.main --serve --serve-frontend 0 --traffic-shape diurnal+burst: "
        + " | ".join(line for line in text.splitlines() if line.startswith("Serve")))
    result["run_serve"] = text
    result["seconds"] = time.perf_counter() - t0
    log(f"phase 3f wall time: {result['seconds']:.1f} s")
    return result


def serve_bench_calls() -> dict:
    """The bench's serve and saturate modes through ``python -m`` on
    ``v3_pallas`` fp32, held to their row contracts."""
    res = {}
    for mode in ("serve", "saturate"):
        env = {k: v for k, v in os.environ.items() if not k.startswith(("BENCH_", "TPU_FRAMEWORK_"))}
        env.update(BENCH_MODE=mode, BENCH_CONFIG="v3_pallas")
        t_call = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", f"{PORT}.bench"], capture_output=True, text=True, env=env,
                              timeout=600)
        require(proc.returncode == 0, f"bench {mode}: rc {proc.returncode}\n{proc.stderr[-3000:]}")
        rows = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
        require(len(rows) == (1 if mode == "serve" else 4), f"bench {mode}: rows {proc.stdout[-3000:]}")
        for row in rows:
            require("error" not in row and row.get("platform") == "gpu" and row.get("value", 0) > 0
                    and row.get("cache_misses_post_warmup") == 0, f"bench {mode} row: {row}")
            if mode == "saturate":
                require(row.get("percentiles_agree") is True and row.get("accounting_closed") is True,
                        f"bench saturate row: {row}")
        keep = ("value", "p50_ms", "p99_ms", "n_requests", "n_ok", "n_shed", "n_failed", "n_rejected", "buckets",
                "rate_rps", "offered_img_s", "knee_rate_img_s", "percentiles_agree", "warmup_compiles")
        res[mode] = [{k: r[k] for k in keep if k in r} for r in rows]
        log(f"bench {mode} ({time.perf_counter() - t_call:.1f} s): " + " | ".join(
            " ".join(f"{k}={v}" for k, v in r.items()) for r in res[mode]))
        res[f"{mode}_rows"] = rows
    return res


def serve_kernels_entries(serve) -> list:
    """The ``kernels`` line's entries of the serve path, one per (kernel,
    dtype): times summed over the kernel's stages at bucket 8 (phase 3f's
    rows), the counters over the drained run of the request stream (each
    replay adds what its capture recorded, held to the graphs' kernel
    nodes), and launches per dispatch of bucket 8 (its graph's nodes)."""
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "max_abs_err", "max_rel_err", "tol")
    entries = []
    for name in SERVE_MARKERS:
        source, replaces, stages, _route = KERNELS[name]
        for pol in ("fp32", "bf16"):
            mine = [r for r in serve["rows8"] if r["kernel"] == name and r["dtype"] == pol and not r.get("mode")]
            require([r["stage"] for r in mine] == list(stages), f"serve {name} {pol}: stages {mine}")
            srv = serve["servers"][f"v3_pallas/{pol}"]
            entries.append(dict(
                name=name, dtype=pol, route="cuda", source=source, replaces=replaces, path="serve",
                run=f"serve v3_pallas/{pol} (max_batch {SERVE_MAX_BATCH}, request sizes {SERVE_SIZES})",
                launches=srv["run_launches"][name], launches_per_dispatch=srv["graph_nodes"][SERVE_MAX_BATCH][name],
                dispatches=len(srv["batches"]),
                max_abs_err=max(r["max_abs_err"] for r in mine), within_tolerance=all(r["ok"] for r in mine),
                ms=sum(r["ms"] for r in mine), plain_ms=sum(r["plain_ms"] for r in mine),
                bound_ms=sum(r["bound_ms"] for r in mine), bound_by=max(mine, key=lambda r: r["bound_ms"])["bound_by"],
                library_ms=sum(r["library_ms"] for r in mine), batch=SERVE_MAX_BATCH,
                stages={r["stage"]: {k: r[k] for k in keys + STAGE_EXTRAS if k in r} for r in mine},
            ))
    return entries

# phase 3g, the control loop: the controller's knobs (the default window; the clock is injected, so cooldown and
# dwell pass between evaluations), the ladder it walks down and back on a v3_pallas bf16 server, what an int8w
# dispatch launches (its LRN is the fp32 reference op), and phase 3f's bf16 results and batches
CTL_KNOBS = dict(eval_s=0.25, window=128, min_completed=20, cooldown_s=1.0, min_dwell_s=2.0)
CTL_LADDER = (("tighten_admission", "bulk"), ("tighten_admission", "batch"), ("narrow_buckets", ""),
              ("downshift_dtype", "int8w"), ("upshift_dtype", "int8w"), ("widen_buckets", ""),
              ("relax_admission", "batch"), ("relax_admission", "bulk"))
INT8W_STAGED = dict(conv2d=2, maxpool2d=2)


def graph_nodes(srv, tag: str) -> dict:
    """Every live bucket graph's serve-path kernel nodes as CUDA prints them
    ({bucket: {kernel: nodes}}), each held to what its capture counted."""
    nodes = {}
    for bucket in srv.buckets:
        names = graph_kernel_nodes(srv._graphs.dump(bucket, Path("chip_smoke_out") / f"control_{tag}_{bucket}.dot"))
        nodes[bucket] = {k: sum(mark in n for n in names) for k, mark in SERVE_MARKERS.items()}
        require({k: v for k, v in nodes[bucket].items() if v} == srv._graphs.kernels(bucket),
                f"control {tag} bucket {bucket}: nodes {nodes[bucket]}, capture counted {srv._graphs.kernels(bucket)}")
        foreign = [n for n in names if not any(mark in n for mark in SERVE_MARKERS.values())
                   and any(m in n.lower() for m in LIBRARY_CONV_MARKS)]
        require(not foreign, f"control {tag} bucket {bucket}: a library conv in the graph: {foreign}")
    return nodes


def control_drain(srv, xs, tag: str, oracle) -> dict:
    """Drain ``xs`` through ``srv`` (a request wider than its largest bucket
    is rejected at the door), the launch counts set to 0 just before and
    read just after: each result bitwise the live policy's eager forward on
    its padded batch, the counts the live graphs' kernel nodes summed over
    the dispatches, every serve-path kernel of the policy launched, no
    cache miss; and the error against the fp32 ``v1_jit`` ``oracle`` on the
    same batches."""
    from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import cuda_kernels as ck
    from cuda_mpi_gpu_cluster_programming_tpu_torch.resilience.journal import Journal

    journal = srv.cfg.journal_path
    fits = [i for i, x in enumerate(xs) if len(x) <= srv.buckets[-1]]
    for x in xs:
        if len(x) > srv.buckets[-1]:
            try:
                srv.submit(x)
                require(False, f"control {tag}: a request of {len(x)} admitted past bucket {srv.buckets[-1]}")
            except ValueError:
                pass
    n_records = len(Journal.load(journal))
    handles = [srv.submit(xs[i]) for i in fits]
    ck.reset_launches()
    srv.run_until_drained()
    counts = dict(ck.LAUNCHES)
    require([h.status for h in handles] == ["OK"] * len(fits), f"control {tag}: {[h.error for h in handles]}")
    batches = entry_batches(Journal.load(journal)[n_records:])
    nodes = graph_nodes(srv, tag)
    want = {k: sum(nodes[b][k] for b, *_ in batches) for k in SERVE_MARKERS}
    path = INT8W_STAGED if srv.current_compute == "int8w" else STAGED
    require({k: counts[k] for k in SERVE_MARKERS} == want and all(want[k] > 0 for k in path)
            and not any(v for k, v in counts.items() if k not in SERVE_MARKERS),
            f"control {tag}: the drained run launched {counts}, its dispatches' graphs hold {want}")
    require(srv.stats.cache_misses == 0, f"control {tag}: {srv.summary()}")
    pending, groups, err, omax = list(zip(fits, handles)), [], 0.0, 0.0
    for bucket, n_requests, _n_images, pad in batches:
        mine = [pending.pop(0) for _ in range(n_requests)]
        padded = torch.from_numpy(np.concatenate([xs[i] for i, _h in mine]
                                                 + [np.zeros((pad, 227, 227, 3), np.float32)])).cuda()
        eager = srv._fwd(srv._params, padded).cpu().numpy()
        ref = oracle(srv._params, padded).cpu().numpy()
        off = 0
        for i, h in mine:
            require(np.array_equal(h.result, eager[off : off + len(xs[i])]),
                    f"control {tag}: request {i} (bucket {bucket}) differs from the eager {srv.current_compute} forward")
            err = max(err, float(np.abs(h.result - ref[off : off + len(xs[i])]).max()))
            off += len(xs[i])
        omax = max(omax, float(np.abs(ref).max()))
        groups.append((bucket, tuple(i for i, _h in mine)))
    return dict(requests=fits, batches=batches, groups=groups, counts={k: counts[k] for k in SERVE_MARKERS},
                nodes=nodes, results={i: h.result for i, h in zip(fits, handles)}, oracle_err=err, oracle_max=omax)


def int8w_serve_rows(spec, peak_name) -> list:
    """The kernels an int8w dispatch launches, at bucket 8's shapes: conv2d
    on bf16 activations and the weights quantized per output channel (the
    int8 values as bf16, zero bias, no ReLU: the rescale follows), its plain
    version by the bf16 rule, and maxpool2d on the rescaled ReLU output."""
    import torch.nn.functional as F

    from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import cuda_kernels as ck
    from cuda_mpi_gpu_cluster_programming_tpu_torch.precision.quantize import quantize_channelwise

    gen = torch.Generator(device="cuda").manual_seed(2026)
    t = stage_inputs(torch.float32, gen, SERVE_MAX_BATCH)
    cur, rows = t["x"].to(torch.bfloat16), []
    for stage, w, b, s, p, pool in (("conv1", t["w1"], t["b1"], 4, 0, "pool1"), ("conv2", t["w2"], t["b2"], 1, 2, "pool2")):
        q, scale = quantize_channelwise(w)
        wq, zb = q.to(torch.bfloat16), torch.zeros(q.shape[-1], dtype=torch.bfloat16, device="cuda")
        wl = wq.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        y = ck.conv2d_bias_relu(cur, wq, zb, stride=s, padding=p, relu=False)
        n, ho, wo, k = y.shape
        rows.append(measure(dict(
            kernel="conv2d", stage=stage, mode="int8w",
            run=lambda x=cur, w=wq, b=zb, s=s, p=p: ck.conv2d_bias_relu(x, w, b, stride=s, padding=p, relu=False),
            plain=lambda x=cur, w=wq, b=zb, s=s, p=p: ck.conv2d_bias_relu_plain(x, w, b, stride=s, padding=p,
                                                                                 relu=False),
            library=lambda x=cur, wl=wl, s=s, p=p: F.conv2d(x.permute(0, 3, 1, 2), wl, stride=s, padding=p),
            library_call="F.conv2d (cuDNN, bf16, channels-last, no bias)",
            flops=2 * n * ho * wo * k * w.shape[0] * w.shape[1] * w.shape[2],
            nbytes=(cur.numel() + wq.numel() + y.numel()) * 2 + zb.numel() * 2, peak="bf16",
            rule=("ulp", FP32_REL),
        ), "int8w", spec, peak_name))
        a = torch.relu(y.float() * scale + b).to(torch.bfloat16)
        st = pool_stage(pool, a)
        st["mode"] = "int8w"
        rows.append(measure(st, "int8w", spec, peak_name))
        cur = ck.maxpool2d(a, window=3, stride=2)
    return rows


def control_phase(spec, peak_name, bench_rows=None, served=None) -> dict:
    """Phase 3g: the control loop on the card at 227x227, max_batch 8.
    ``bench_rows``: phase 3e's rows (the gate's rounds); ``served``: phase
    3f's bf16 results and batches (None when run alone)."""
    from cuda_mpi_gpu_cluster_programming_tpu_torch.configs import REGISTRY, build_forward
    from cuda_mpi_gpu_cluster_programming_tpu_torch.models.alexnet import BLOCKS12
    from cuda_mpi_gpu_cluster_programming_tpu_torch.observability.replay import (
        ReplayKnobs, load_recorded_run, percentile_resolution, replay_recorded)
    from cuda_mpi_gpu_cluster_programming_tpu_torch.resilience.journal import Journal
    from cuda_mpi_gpu_cluster_programming_tpu_torch.serving.controller import ControllerConfig
    from cuda_mpi_gpu_cluster_programming_tpu_torch.serving.loadgen import run_load
    from cuda_mpi_gpu_cluster_programming_tpu_torch.serving.server import InferenceServer, ServeConfig
    from cuda_mpi_gpu_cluster_programming_tpu_torch.serving.traffic import default_class_mix, slo_policy

    t0 = time.perf_counter()
    out_dir = Path("chip_smoke_out")
    out_dir.mkdir(exist_ok=True)
    params, xs = serve_inputs()
    journal = out_dir / "control_v3_pallas_bf16.jsonl"
    journal.unlink(missing_ok=True)
    srv = InferenceServer(ServeConfig(
        config="v3_pallas", compute="bf16", max_batch=SERVE_MAX_BATCH, journal_path=str(journal),
        slo=slo_policy(default_class_mix((1, 2, 4, 8))), controller=ControllerConfig(**CTL_KNOBS)), params=params)
    oracle = build_forward(REGISTRY["v1_jit"], BLOCKS12, policy="fp32", device="cuda")
    result = {"rungs": []}
    with knob_env({}):
        srv.run_until_drained()  # built and every bucket captured before a request waits
        base = control_drain(srv, xs, "base", oracle)
        if served is not None:
            require(base["batches"] == served["batches"]
                    and all(np.array_equal(base["results"][i], y) for i, y in enumerate(served["results"])),
                    "control: the controlled bf16 server differs from phase 3f's")
        ctl, now = srv.controller, time.monotonic() + 1e6  # ahead of the dispatch loop's own evaluations
        for step, (action, target) in enumerate(CTL_LADDER):
            for _ in range(ctl.cfg.window):  # the protected class's outcomes: late on the way down, then on time
                ctl.note_ok("interactive", 2000.0 if step < 4 else 100.0)
            now += 2.5
            graphs = srv._graphs
            rec = ctl.evaluate(now)
            require(rec is not None and rec["actuated"] and (rec["action"], rec["target"]) == (action, target),
                    f"control step {step}: want {action}:{target}, got {rec}")
            d = control_drain(srv, xs, f"{step}_{action}", oracle)
            d.update(action=f"{action}:{target}" if target else action, action_ms=rec["ms"], level=rec["level"], buckets=list(srv.buckets),
                     compute=srv.current_compute, recaptured=srv._graphs is not graphs,
                     evidence_burn=rec["evidence"]["burn"].get("interactive"))
            same_3f = [g for g in d["groups"] if g in set(base["groups"])]
            d["bitwise_3f_batches"] = len(same_3f)
            if action == "narrow_buckets":
                require(srv.buckets == (1, 2, 4) and 8 not in srv._graphs and 8 not in srv._warmed,
                        f"control: narrowing left {srv.buckets}, graphs of {sorted(srv._warmed)}")
            if "dtype" in action:
                pol = "int8w" if action == "downshift_dtype" else "bf16"
                require(d["recaptured"] and d["compute"] == pol
                        and all(n == {**{k: 0 for k in SERVE_MARKERS}, **(INT8W_STAGED if pol == "int8w" else STAGED)}
                                for n in d["nodes"].values()),
                        f"control {action}: recaptured {d['recaptured']} at {d['compute']}, nodes {d['nodes']}")
            if action == "downshift_dtype":
                records = Journal.load(journal)
                require(any(r["kind"] == "gate_pass" and r["key"] == "controller:int8w" for r in records)
                        and any(r["kind"] == "serve_rewarm" and r["dtype"] == "int8w" for r in records),
                        "control: the downshift journaled no gate_pass or no int8w serve_rewarm")
                require(d["oracle_err"] <= INT8W_REL * d["oracle_max"],
                        f"control int8w: {d['oracle_err']:.4g} off the fp32 oracle (max {d['oracle_max']:.4g})")
            if action == "upshift_dtype":
                # the batches phase 3f (and the base drain) assembled alike: bitwise its bf16 graph outputs
                for bucket, idx in same_3f:
                    require(all(np.array_equal(d["results"][i], base["results"][i]) for i in idx),
                            f"control upshift: batch {idx} at bucket {bucket} differs from the bf16 service's")
                require(same_3f, "control upshift: no batch assembled as before")
            if action == "widen_buckets":
                require(srv.buckets == (1, 2, 4, 8) and 8 in srv._graphs, f"control: widening left {srv.buckets}")
            log(f"control {step} {d['action']}: {rec['ms']:.3f} ms, level {rec['level']}, buckets {srv.buckets}, "
                f"{srv.current_compute}{' (recaptured)' if d['recaptured'] else ''}; drained {d['batches']} counted "
                f"{d['counts']} = nodes x dispatches; max_abs vs v1_jit fp32 {d['oracle_err']:.4g} "
                f"(max {d['oracle_max']:.4g}); {len(same_3f)} batch(es) as phase 3f's")
            result["rungs"].append({k: v for k, v in d.items() if k != "results"})
        last = result["rungs"][-1]
        require(last["batches"] == base["batches"] and all(np.array_equal(d["results"][i], base["results"][i])
                                                            for i in base["results"]),
                "control: back at the bottom of the ladder the service differs from where it started")
        records = Journal.load(journal)
        kinds = [r["kind"] for r in records]
        require("serve_miss" not in kinds and srv.stats.cache_misses == 0 and kinds.count("serve_rewarm") == 2,
                f"control: {srv.summary()} rewarms {kinds.count('serve_rewarm')}")
        # each rewarm's captures: the serve_warm records just before it
        result["rewarms"] = []
        for j, r in enumerate(records):
            if r["kind"] == "serve_rewarm":
                warms = [w for w in records[:j] if w["kind"] == "serve_warm"][-len(r["buckets"]):]
                result["rewarms"].append(dict(dtype=r["dtype"], ms=r["ms"], buckets=r["buckets"],
                                              capture_ms={w["bucket"]: w["ms"] for w in warms}))
                log(f"control rewarm {r['dtype']}: {r['ms']:.3f} ms for buckets {r['buckets']}, per bucket "
                    + ", ".join(f"{w['bucket']}: {w['ms']:.3f}" for w in warms))
        # evaluate's cost at level 0 on calm windows (every call past eval_s: a full evaluation, no action)
        n_eval = 2000
        te = time.perf_counter()
        acted = [ctl.evaluate(now + (k + 1) * ctl.cfg.eval_s) for k in range(n_eval)]
        result["evaluate_us"] = (time.perf_counter() - te) / n_eval * 1e6
        require(not any(acted) and ctl.level == 0, "control: a calm evaluation acted")
        log(f"control evaluate: {result['evaluate_us']:.2f} us a call, no action (level 0)")
        # int8w under the graph at every bucket: one apply_compute outside the ladder, timed per bucket, then back
        ms8 = srv.apply_compute("int8w")
        result["int8w_graph_nodes"] = graph_nodes(srv, "int8w")
        result["int8w_rewarm_ms"] = ms8
        xb = xs[SERVE_SIZES.index(SERVE_MAX_BATCH)]
        result["int8w_dispatch"] = {}
        for bucket in srv.buckets:
            result["int8w_dispatch"][bucket] = dt = dispatch_times(srv, bucket, xb[:bucket], per_dispatch=INT8W_STAGED)
            log(f"control int8w dispatch bucket {bucket}: graph {dt['graph_ms']:.4f} ms, eager {dt['eager_ms']:.4f} "
                f"ms (x{dt['speedup']:.2f}); device graph {_fmt(dt['graph_device_ms'])}, eager "
                f"{_fmt(dt['eager_device_ms'])}")
        log(f"control int8w rewarm of buckets {srv.buckets}: {ms8:.3f} ms")
        srv.apply_compute("bf16")
    srv.close()
    result["rows8"] = int8w_serve_rows(spec, peak_name)

    # replay of a journal recorded on the card: phase 3f's Poisson 50 req/s run (v3_pallas fp32), in a journal of
    # its own
    recorded_path = out_dir / "control_recorded.jsonl"
    recorded_path.unlink(missing_ok=True)
    rsrv = InferenceServer(ServeConfig(config="v3_pallas", compute="fp32", max_batch=SERVE_MAX_BATCH,
                                       journal_path=str(recorded_path)), params=params)
    with knob_env({}):
        rsrv.start()
    try:
        run_load(rsrv, rate_rps=50.0, duration_s=3.0, seed=0)
    finally:
        rsrv.close()
    recorded = load_recorded_run(recorded_path)
    result["replay"] = {}
    for mult in (1.0, 2.0):
        with knob_env({}):
            rep = replay_recorded(recorded, ReplayKnobs(traffic_mult=mult, device="cuda",
                                                        journal_path=str(out_dir / f"control_replay_x{mult:g}.jsonl")))
        require(rep.accounting_closed and not rep.diverged and rep.cache_misses == 0, f"replay x{mult}: {rep.summary()}")
        if mult == 1.0:
            require(rep.accounting_matches, f"replay: accounting differs from the record: {rep.summary()}")
        else:
            require(rep.n_offered == 2 * len(recorded.submits), f"replay x2: offered {rep.n_offered}")
        pairs = {}
        for q in (50, 99):
            rec_q, rep_q = rep.percentile_pair(q)
            floor = rep.knobs.percentile_floor_ms
            pairs[f"p{q}"] = dict(recorded=rec_q, replay=rep_q,
                                  recorded_resolution=percentile_resolution(recorded.latencies_ms, q, floor),
                                  replay_resolution=percentile_resolution(rep.latencies_ms, q, floor),
                                  within=rep.percentile_within_resolution(q))
        result["replay"][f"x{mult:g}"] = dict(summary=rep.summary(), percentiles=pairs, obj=rep.to_obj())
        log(f"replay x{mult:g}: {rep.summary()}")
        log(f"replay x{mult:g} p50/p99 (replay/recorded, resolutions): " + "; ".join(
            f"{q} {v['replay']:.3f}/{v['recorded']:.3f} ms (+-{v['replay_resolution']:.1f}, "
            f"+-{v['recorded_resolution']:.1f}) within={v['within']}" for q, v in pairs.items()))
    result["bench"] = control_bench_calls(recorded_path, bench_rows)
    result["seconds"] = time.perf_counter() - t0
    log(f"phase 3g wall time: {result['seconds']:.1f} s")
    return result


def control_bench_calls(recorded_path, bench_rows) -> dict:
    """The bench's replay, gate and control modes through ``python -m``: a
    neutral replay of the card's journal exits 0; the gate over phase 3e's
    fp32 rows (``v1_jit`` then ``v3_pallas``) as two rounds prints the
    in-process verdict and exits by it; the control drill on ``v3_pallas``
    closes its books on both sides, never diverges and acts on the ON side
    (its burn clause is printed and kept, and read, not required)."""
    from cuda_mpi_gpu_cluster_programming_tpu_torch.observability.gate import evaluate

    out_dir = Path("chip_smoke_out")
    res = {}

    def call(mode, **extra):
        env = {k: v for k, v in os.environ.items() if not k.startswith(("BENCH_", "TPU_FRAMEWORK_"))}
        env.update(BENCH_MODE=mode, **extra)
        t_call = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", f"{PORT}.bench"], capture_output=True, text=True, env=env,
                              timeout=600)
        rows = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
        require(len(rows) == 1, f"bench {mode}: rc {proc.returncode}\n{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
        log(f"bench {mode} ({time.perf_counter() - t_call:.1f} s): rc {proc.returncode}")
        return proc.returncode, rows[0]

    rc, row = call("replay", BENCH_REPLAY_JOURNAL=str(recorded_path),
                   BENCH_REPLAY_OUT=str(out_dir / "control_bench_replay.jsonl"))
    require(rc == 0 and "error" not in row and row["accounting_matches"] and not row["diverged"]
            and row["platform"] == "gpu", f"bench replay: rc {rc} {row}")
    res["replay"] = row
    log(f"bench replay: p50 {row['p50_ms']}/{row['recorded_p50_ms']} p99 {row['p99_ms']}/{row['recorded_p99_ms']} "
        f"ms, value {row['value']} img/s, diverged {row['diverged']}")

    if bench_rows is None:  # --control alone: one quick measure call gives the rounds
        env = {k: v for k, v in os.environ.items() if not k.startswith(("BENCH_", "TPU_FRAMEWORK_"))}
        env.update(BENCH_CONFIGS="v1_jit,v3_pallas", BENCH_DTYPE="fp32", BENCH_BATCH="8", BENCH_REPEATS="20",
                   BENCH_BF16="0", BENCH_BREAKDOWN="0", BENCH_MAX_RETRIES="0")
        proc = subprocess.run([sys.executable, "-m", f"{PORT}.bench"], capture_output=True, text=True, env=env,
                              timeout=600)
        bench_rows = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    rounds = [r for r in bench_rows if r.get("dtype") == "fp32" and r.get("config") in ("v1_jit", "v3_pallas")][:2]
    require([r["config"] for r in rounds] == ["v1_jit", "v3_pallas"], f"gate: rounds {rounds}")
    gate_dir = out_dir / "gate"
    gate_dir.mkdir(exist_ok=True)
    paths = []
    for i, r in enumerate(rounds, 1):
        path = gate_dir / f"BENCH_r{i:02d}.json"
        path.write_text(json.dumps(r))  # noqa: atomic-write (a scratch file this phase reads back at once)
        paths.append(str(path))
    verdict = evaluate(paths)
    rc, row = call("gate", BENCH_GATE_PATHS=str(gate_dir / "BENCH_r*.json"))
    require(row == {"metric": "alexnet_blocks12_bench_gate", **verdict.to_obj()} and verdict.compared == 1
            and rc == (0 if verdict.ok else 3), f"bench gate: rc {rc} {row}")
    res["gate"] = row
    log(f"bench gate over phase 3e's fp32 rows (v1_jit, then v3_pallas): ok={verdict.ok} rc {rc}\n{verdict.render()}")

    rc, row = call("control", BENCH_CONFIG="v3_pallas", BENCH_CTL_JOURNAL_DIR=str(out_dir / "control_bench"))
    burn = [f for f in row.get("failures", []) if "burn not strictly lower" in f]
    require("error" not in row and row["accounting_closed"] == {"off": True, "on": True}
            and row["diverged"] == {"off": False, "on": False} and sum(row["on_actions"].values()) > 0
            and row["calm_actions"] == 0 and set(row["failures"]) == set(burn) and rc == (3 if burn else 0),
            f"bench control: rc {rc} {row}")
    res["control"] = row
    log(f"bench control (v3_pallas fp32, 227x227, max_batch {row['max_batch']}, {row['sat_rate_rps']} req/s, "
        f"slo_scale {row['slo_scale']}): burn {row['protected_cls']} off {row['burn_protected_off']} on "
        f"{row['burn_protected_on']}: {'HOLDS' if not burn else 'FAILS'}; on actions {row['on_actions']}, "
        f"value {row['value']} img/s")
    return res


def control_kernels_entries(control) -> list:
    """The ``kernels`` line's entries of the int8w serve path: conv2d and
    maxpool2d at bucket 8's shapes (phase 3g's rows, summed over stages),
    the launches of the ladder's int8w drained run (counted at its replays,
    held to the graphs' nodes), and launches per dispatch of bucket 8's
    int8w graph."""
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "max_abs_err", "max_rel_err", "tol")
    down = next(r for r in control["rungs"] if r["action"].startswith("downshift_dtype"))
    entries = []
    for name in INT8W_STAGED:
        source, replaces, stages, _route = KERNELS[name]
        mine = [r for r in control["rows8"] if r["kernel"] == name]
        require([r["stage"] for r in mine] == list(stages), f"control {name}: stages {mine}")
        entries.append(dict(
            name=name, dtype="int8w", route="cuda", source=source, replaces=replaces, path="serve",
            run=f"serve v3_pallas/bf16 -> int8w (the controller's downshift; request sizes {SERVE_SIZES})",
            launches=down["counts"][name], launches_per_dispatch=control["int8w_graph_nodes"][SERVE_MAX_BATCH][name],
            dispatches=len(down["batches"]),
            max_abs_err=max(r["max_abs_err"] for r in mine), within_tolerance=all(r["ok"] for r in mine),
            ms=sum(r["ms"] for r in mine), plain_ms=sum(r["plain_ms"] for r in mine),
            bound_ms=sum(r["bound_ms"] for r in mine), bound_by=max(mine, key=lambda r: r["bound_ms"])["bound_by"],
            library_ms=sum(r["library_ms"] for r in mine), batch=SERVE_MAX_BATCH,
            stages={r["stage"]: {k: r[k] for k in keys + STAGE_EXTRAS if k in r} for r in mine},
        ))
    return entries


TUNE_BATCH = 32


def tune_phase() -> dict:
    """Phase 4: ``run.main --tune`` sweeps fp32, bf16 and int8w x every
    candidate of both conv layers at 227x227 (the gate journaled and
    preflighted), then a second identical call must hit the plan cache. No
    candidate may fail and no layer degrade: a broken kernel must not hide
    in the sweep's record of failed candidates."""
    from cuda_mpi_gpu_cluster_programming_tpu_torch.resilience.journal import Journal

    out_dir = Path("chip_smoke_out")
    out_dir.mkdir(exist_ok=True)
    plan_path, journal = out_dir / "tune_plan.json", out_dir / "tune_plan_gate.jsonl"
    for f in (plan_path, journal):
        f.unlink(missing_ok=True)
    argv = ["--config", "v3_pallas", "--tune", "--plan", str(plan_path), "--batch", str(TUNE_BATCH),
            "--tune-repeats", "2", "--tune-warmup", "1", "--repeats", "3", "--warmup", "2"]
    with knob_env({}):
        t0 = time.perf_counter()
        first = run_cli(argv)
        t1 = time.perf_counter()
        second = run_cli(argv)
        t2 = time.perf_counter()
    for what, out, word in (("first", first, "swept"), ("second", second, "cache")):
        line = re.search(r"^Tune plan: .*$", out, re.M)
        log(f"tune {what} call: {line.group(0) if line else 'no Tune plan line'}")
        require(line is not None and line.group(0).startswith(f"Tune plan: {word} hash="),
                f"the {what} --tune call did not print 'Tune plan: {word}':\n{out[-3000:]}")
    obj = json.loads(plan_path.read_text())
    by_dtype = {entry["dtype"]: entry for entry in obj["plans"].values()}
    require(set(by_dtype) == {"fp32", "bf16", "int8w"}, f"plans for {sorted(by_dtype)}")
    winners = {}
    for dt, entry in sorted(by_dtype.items()):
        require(entry["degraded"] == "", f"{dt} plan degraded: {entry['degraded']}")
        for layer in ("conv1", "conv2"):
            st = entry["stats"][layer]
            v = entry["layers"][layer]
            label = f"conv={v['conv']} pool={v['pool']} rb={v['row_block']} kb={v['k_block']} fuse={v['fuse']}"
            log(f"tune winner {dt} {layer}: {label} best_ms={st.get('best_ms')} default_ms={st.get('default_ms')} "
                f"timed={st.get('timed')} failed={st.get('failed')} pruned={st.get('pruned')}")
            require(st.get("failed") == 0 and st.get("degraded", "") == "",
                    f"{dt} {layer}: failed={st.get('failed')} degraded={st.get('degraded')} {st.get('failures')}")
            winners[f"{dt}/{layer}"] = dict(variants=label, best_ms=st.get("best_ms"), default_ms=st.get("default_ms"),
                                            timed=st.get("timed"), pruned=st.get("pruned"))
    recs = Journal.load(journal)
    require(any(r["kind"] == "gate_pass" and r.get("policy") == "fp32" for r in recs),
            f"no gate_pass record for fp32 in {journal}")
    (policy,) = obj["policies"].values()
    log(f"tune dtype winner: {policy['dtype']} (sweep {t1 - t0:.1f} s, cached call {t2 - t1:.1f} s, "
        f"{len(recs)} gate records)")
    return dict(winners=winners, dtype_winner=policy["dtype"], sweep_s=t1 - t0, cached_s=t2 - t1,
                gate_records=recs, stdout_sweep=first, stdout_cache=second)


def v6_tune_phase() -> dict:
    """Phase 4, full AlexNet: ``run.main --config v6_full_pallas --tune`` at
    227x227, batch 32, fp32 (the single-dtype sweep: the gate screens
    Blocks 1-2 only) over its five conv layers, no failed candidate and no
    degraded layer; then a second identical call must hit the cache."""
    out_dir = Path("chip_smoke_out")
    out_dir.mkdir(exist_ok=True)
    plan_path = out_dir / "v6_tune_plan.json"
    plan_path.unlink(missing_ok=True)
    argv = ["--config", "v6_full_pallas", "--tune", "--dtype", "fp32", "--plan", str(plan_path), "--batch",
            str(TUNE_BATCH), "--tune-repeats", "2", "--tune-warmup", "1", "--repeats", "3", "--warmup", "2"]
    with knob_env({}):
        t0 = time.perf_counter()
        first = run_cli(argv)
        t1 = time.perf_counter()
        second = run_cli(argv)
        t2 = time.perf_counter()
    for what, out, word in (("first", first, "swept"), ("second", second, "cache")):
        line = re.search(r"^Tune plan: .*$", out, re.M)
        log(f"v6 tune {what} call: {line.group(0) if line else 'no Tune plan line'}")
        require(line is not None and line.group(0).startswith(f"Tune plan: {word} hash=")
                and "Final Output Shape: 1000" in out, f"the {what} v6 --tune call:\n{out[-3000:]}")
    (entry,) = json.loads(plan_path.read_text())["plans"].values()
    require(entry["dtype"] == "fp32" and entry["degraded"] == "" and list(entry["layers"]) == [
        "conv1", "conv2", "conv3", "conv4", "conv5"], f"v6 plan {entry['layers']} degraded={entry['degraded']}")
    winners = {}
    for layer, v in entry["layers"].items():
        st = entry["stats"][layer]
        label = f"conv={v['conv']} pool={v['pool']} rb={v['row_block']} kb={v['k_block']} fuse={v['fuse']}"
        log(f"v6 tune winner fp32 {layer}: {label} best_ms={st.get('best_ms')} default_ms={st.get('default_ms')} "
            f"timed={st.get('timed')} failed={st.get('failed')} pruned={st.get('pruned')}")
        require(st.get("failed") == 0 and st.get("degraded", "") == "",
                f"v6 {layer}: failed={st.get('failed')} degraded={st.get('degraded')} {st.get('failures')}")
        winners[layer] = dict(variants=label, best_ms=st.get("best_ms"), default_ms=st.get("default_ms"),
                              timed=st.get("timed"), pruned=st.get("pruned"))
    log(f"v6 tune: sweep {t1 - t0:.1f} s, cached call {t2 - t1:.1f} s")
    return dict(winners=winners, sweep_s=t1 - t0, cached_s=t2 - t1, stdout_sweep=first, stdout_cache=second)


def s2d_inputs(dtype) -> list:
    """``(stage, x)`` at the pool A/B's pool1 and pool2, batch 128, standard
    normal (as ``pool_ab`` makes its input), from a seeded generator."""
    gen = torch.Generator(device="cuda").manual_seed(2032)
    return [(stage, torch.randn((BATCH, h, w, c), generator=gen, device="cuda").to(dtype))
            for stage, (h, w, c) in POOL_AB_SHAPES.items()]


def s2d_phase(spec, peak_name) -> list:
    """Phase 2, the pool A/B's s2d pool at pool1 and pool2 (``s2d_inputs``)
    in fp32 and bf16: the pack (``s2d_pool_pack``) bitwise its plain pad and
    repack, timed beside the bound of x read once and the operand written
    once; the pool bitwise against its plain version and against maxpool2d,
    the wrapper timed with its pack (as the phases and taps rows include
    their packing), the kernel alone on the packed operand (``kernel_ms``,
    beside the bound of its own bytes), the plain version and
    ``F.max_pool2d``, beside the function's bytes bound (x read once, y
    written once)."""
    from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import cuda_kernels as ck

    rows = []
    for pol, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        for stage, x in s2d_inputs(dtype):
            c = x.shape[3]
            xs = ck.s2d_pool_pack(x, window=3, stride=2)
            pool = packed_pool_stage("maxpool_s2d", stage, x)
            pool.update(alone=lambda xs=xs, c=c: ck.maxpool_s2d_packed(xs, c, window=3, stride=2))
            rows += packed_pool_rows(pack_stage(
                "s2d_pool_pack", stage, x, run=lambda x=x: ck.s2d_pool_pack(x, window=3, stride=2),
                plain=lambda x=x: ck.s2d_pool_operand(x, window=3, stride=2).contiguous()), pool, xs, pol, spec,
                peak_name)
            log(f"kernel maxpool_s2d {stage} {pol}: pack {rows[-2]['ms']:.4f} ms (bound {rows[-2]['bound_ms']:.4f}), "
                f"kernel alone on the packed {tuple(xs.shape)} operand {rows[-1]['kernel_ms']:.4f} ms (bound of its "
                f"own bytes {rows[-1]['kernel_bound_ms']:.4f})")
            del x, xs
        torch.cuda.empty_cache()
    return rows


def s2d_edge_phase() -> list:
    """The s2d pool off pool1 and pool2, bitwise against its plain version
    and (where the input holds no NaN) against maxpool2d: C = 20, 128 and
    130 (20 in bf16 takes the store's scalar tail), window/stride 2/2, 3/1
    and 5/3, an H != W input, and NaN (its payload kept), -inf and -0.0 in
    the input; its pack at each shape bitwise the plain pad and repack, and
    from a view off 16-byte alignment (the scalar instance)."""
    from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import cuda_kernels as ck

    gen = torch.Generator(device="cuda").manual_seed(12)
    results = []
    for pol, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        for shape, win, st in (((3, 15, 15, 20), 3, 2), ((3, 15, 15, 128), 3, 2), ((3, 15, 15, 130), 3, 2),
                               ((2, 16, 16, 96), 2, 2), ((2, 9, 9, 130), 3, 1), ((2, 17, 17, 20), 5, 3),
                               ((2, 13, 21, 96), 3, 2), ((2, 27, 19, 256), 3, 2)):
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            got = ck.maxpool_s2d(x, window=win, stride=st)
            res = compare("bitwise", got, ck.maxpool_s2d_plain(x, window=win, stride=st))
            res["bitwise_maxpool2d"] = bool(torch.equal(got, ck.maxpool2d(x, window=win, stride=st)))
            res["ok"] = res["ok"] and res["bitwise_maxpool2d"]
            results.append((f"maxpool_s2d {shape} {win}/{st} {pol} (bitwise, and vs maxpool2d)", res))
            want = ck.s2d_pool_operand(x, window=win, stride=st)
            results.append((f"s2d_pool_pack {shape} {win}/{st} {pol} (bitwise)", compare(
                "bitwise", ck.s2d_pool_pack(x, window=win, stride=st), want)))
            off = torch.randn(x.numel() + 1, generator=gen, device="cuda").to(dtype)[1:].view(shape)
            off.copy_(x)
            results.append((f"s2d_pool_pack {shape} {win}/{st} {pol} view off 16-byte alignment (bitwise)", compare(
                "bitwise", ck.s2d_pool_pack(off, window=win, stride=st), want)))
        x = torch.randn((2, 11, 11, 20), generator=gen, device="cuda").to(dtype)
        flat = x.view(-1)
        flat[::7] = float("-inf")
        flat[1::11] = -0.0
        flat[2::11] = 0.0
        nan = torch.tensor([0x7FC00123 if dtype == torch.float32 else 0x7FC1],
                           dtype=torch.int32 if dtype == torch.float32 else torch.int16, device="cuda")
        flat[3::13] = nan.view(dtype)
        got = ck.maxpool_s2d(x, window=3, stride=2)
        want = ck.maxpool_s2d_plain(x, window=3, stride=2)
        ok = torch.equal(_bits(got), _bits(want)) and bool(torch.isnan(got).any())
        results.append((f"maxpool_s2d NaN (payload), -inf, -0.0 {pol} (bitwise)", dict(ok=ok, max_abs_err=0.0)))
    torch.cuda.synchronize()
    for what, res in results:
        log(f"edge {what}: ok={res['ok']}")
        require(res["ok"], f"edge case {what}: {res}")
    return results


def lm_kernel_phase(spec, peak_name) -> list:
    """Phase 2, the LM slice's kernels in fp32 and bf16: ``relu`` at conv1's
    output (bitwise against its plain version; its device time and
    ``torch.relu``'s, ``device_ms``), and ``flash_fwd`` at
    ``long_context``'s defaults and at TINY_LM's attention, causal and full,
    and at D = 256 and 512 (``FLASH_D256``, ``FLASH_D512``, causal): out
    and lse against the plain version, out against the O(L^2) oracle
    (``ops.attention``), timed beside SDPA and the bound."""
    from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import cuda_kernels as ck

    rows = []
    for pol, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        gen = torch.Generator(device="cuda").manual_seed(2028)
        x = torch.randn((BATCH, 55, 55, 96), generator=gen, device="cuda").to(dtype)
        rows.append(measure(dict(
            kernel="relu", stage="conv1 out", run=lambda x=x: ck.relu(x), plain=lambda x=x: ck.relu_plain(x),
            library=lambda x=x: torch.relu(x), library_call="torch.relu", marker="relu_kernel",
            flops=x.numel(), nbytes=2 * x.numel() * x.element_size(), peak="fp32", rule="bitwise",
        ), pol, spec, peak_name))
        del x
        for stage, shape, causals in (("long_context", LONG_CONTEXT, (True, False)),
                                      ("tiny_lm", TINY_LM_ATTN, (True, False)), ("d256", FLASH_D256, (True,)),
                                      ("d512", FLASH_D512, (True,))):
            for causal in causals:
                rows.append(flash_row(stage, shape, causal, pol, dtype, gen, spec, peak_name))
        torch.cuda.empty_cache()
    return rows


def flash_fwd_against_plain(out, lse, q, k, v, **kw) -> dict:
    """flash_fwd's ``(out, lse)`` against its plain version on the same
    q, k, v: out within ``FLASH_PLAIN_V_REL`` of max |v|, plus 1 ulp where
    out is bf16; lse within ``LSE_REL`` of its max."""
    from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import cuda_kernels as ck

    p_out, p_lse = ck.flash_fwd_plain(q, k, v, **kw)
    slack = FLASH_PLAIN_V_REL * float(v.float().abs().max())
    diff = (out.float() - p_out.float()).abs()
    if out.dtype == torch.bfloat16:
        ulps = bf16_ulp(torch.maximum(out.float().abs(), p_out.float().abs()))
        ok = bool((diff <= ulps + slack).all())
        tol = f"1 bf16 ulp + {FLASH_PLAIN_V_REL:g} x max|v|"
    else:
        ok = float(diff.max()) <= slack
        tol = f"{FLASH_PLAIN_V_REL:g} x max|v|"
    res_lse = compare(LSE_REL, lse, p_lse)
    return dict(max_abs_err=float(diff.max()), max_rel_err=float(diff.max()) / float(p_out.float().abs().max()),
                tol=tol, ok=ok and out.dtype == p_out.dtype and out.shape == p_out.shape,
                lse_max_abs_err=res_lse["max_abs_err"], lse_ok=res_lse["ok"], lse_tol=res_lse["tol"])


def flash_case(shape, causal, dtype, gen, block_q=128, block_k=128) -> dict:
    """flash_fwd on standard-normal q, k, v against its plain version
    (:func:`flash_fwd_against_plain`), against the oracle (``FLASH_REF_TOL``,
    abs and rel, elementwise), and a second launch bitwise the first."""
    from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import cuda_kernels as ck
    from cuda_mpi_gpu_cluster_programming_tpu_torch.ops.attention import attention

    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(3))
    pol = "fp32" if dtype == torch.float32 else "bf16"
    kw = dict(causal=causal, block_q=block_q, block_k=block_k)
    out, lse = ck.flash_fwd(q, k, v, **kw)
    again = ck.flash_fwd(q, k, v, **kw)
    res = flash_fwd_against_plain(out, lse, q, k, v, **kw)
    ref = attention(q, k, v, causal=causal).float()
    diff = (out.float() - ref).abs()
    tol = FLASH_REF_TOL[pol]
    res.update(ref_max_abs_err=float(diff.max()), ref_ok=bool((diff <= tol + tol * ref.abs()).all()),
               ref_tol=f"{tol:g} abs + {tol:g} rel vs ops.attention",
               bitwise_rerun=torch.equal(out, again[0]) and torch.equal(lse, again[1]))
    res["ok_all"] = res["ok"] and res["lse_ok"] and res["ref_ok"] and res["bitwise_rerun"]
    return dict(q=q, k=k, v=v, res=res)


def flash_row(stage, shape, causal, pol, dtype, gen, spec, peak_name) -> dict:
    """Phase 2 row of flash_fwd at one shape: checked by :func:`flash_case`
    (plain version, oracle, a second launch bitwise), timed by CUDA events
    around a call (``ms``) and the kernel's own device time
    (``device_ms``, :func:`device_time_ms`) beside the plain version, SDPA
    (the same two ways) and the bound."""
    import torch.nn.functional as F

    from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import cuda_kernels as ck

    case = flash_case(shape, causal, dtype, gen)
    q, k, v, res = case["q"], case["k"], case["v"], case["res"]
    torch.cuda.synchronize()
    b, l, h, d = shape
    flops = 4 * b * h * l * l * d // (2 if causal else 1)
    nbytes = 4 * q.numel() * q.element_size() + b * h * l * 4  # q, k, v read, out written once; the fp32 lse
    bound, by = spec.bound_ms(flops, nbytes, pol)
    run = lambda: ck.flash_fwd(q, k, v, causal=causal)  # noqa: E731
    plain = lambda: ck.flash_fwd_plain(q, k, v, causal=causal)  # noqa: E731
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=causal)
    row = dict(
        kernel="flash_fwd", stage=stage, mode="" if causal else "full", dtype=pol, shape=list(shape), **res,
        ms=gpu_time_ms(run), device_ms=device_time_ms(run, "flash_fwd_"), plain_ms=gpu_time_ms(plain),
        library_ms=gpu_time_ms(sdpa), library_device_ms=device_time_ms(sdpa),
        library_call="F.scaled_dot_product_attention (is_causal; (B, H, L, D) views)",
        bound_ms=bound, bound_by=by, flops=flops, bytes=nbytes, peak=f"{spec.name} {peak_name(pol)}",
    )
    log(f"kernel flash_fwd{'' if causal else '[full]'} {stage} {'x'.join(map(str, shape))} {pol}: "
        f"ok={res['ok']} tol={res['tol']} max_abs={res['max_abs_err']:.3g} lse_max_abs={res['lse_max_abs_err']:.3g} "
        f"vs_oracle={res['ref_max_abs_err']:.3g} ({res['ref_ok']}) bitwise_rerun={res['bitwise_rerun']} "
        f"| ms={row['ms']:.4f} device_ms={row['device_ms'] or float('nan'):.4f} plain={row['plain_ms']:.4f} "
        f"sdpa={row['library_ms']:.4f} (device {row['library_device_ms'] or float('nan'):.4f}) "
        f"bound={bound:.4f} ({by})")
    require(res["ok_all"], f"flash_fwd {stage} {pol} causal={causal}: {res}")
    del case
    return row


def flash_bwd_case(shape, causal, dtype, gen, block_q=128, block_k=128, lse_grad=False) -> dict:
    """flash_dq and flash_dkv on standard-normal q, k, v, dO (and, with
    ``lse_grad``, a standard-normal lse cotangent shifting delta), after a
    flash_fwd: each output against its plain version (``BWD_PLAIN_REL`` of
    its max, plus 1 ulp in bf16), a second launch bitwise the first, and in
    fp32 without an lse cotangent against autograd through the O(L^2)
    oracle ``ops.attention`` (``BWD_ORACLE_TOL`` abs + rel)."""
    from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import cuda_kernels as ck
    from cuda_mpi_gpu_cluster_programming_tpu_torch.ops.attention import attention

    q, k, v, g = (torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(4))
    pol = "fp32" if dtype == torch.float32 else "bf16"
    kw = dict(causal=causal, block_q=block_q, block_k=block_k)
    out, lse = ck.flash_fwd(q, k, v, **kw)
    delta = (g.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()
    if lse_grad:
        delta = delta - torch.randn(delta.shape, generator=gen, device="cuda")
    args = (q, k, v, g, lse, delta)
    got = dict(flash_dq=(ck.flash_dq(*args, **kw),), flash_dkv=ck.flash_dkv(*args, **kw))
    again = dict(flash_dq=(ck.flash_dq(*args, **kw),), flash_dkv=ck.flash_dkv(*args, **kw))
    plain = dict(flash_dq=(ck.flash_dq_plain(*args, **kw),), flash_dkv=ck.flash_dkv_plain(*args, **kw))
    oracle = None
    if pol == "fp32" and not lse_grad:
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        oracle = torch.autograd.grad(attention(*leaves, causal=causal), leaves, g)
    rule = BWD_PLAIN_REL if pol == "fp32" else ("ulp", BWD_PLAIN_REL)
    res = {}
    for name, outs, ref_idx in (("flash_dq", ("dq",), (0,)), ("flash_dkv", ("dk", "dv"), (1, 2))):
        mine, twice, base = got[name], again[name], plain[name]
        parts = [compare(rule, a, b) for a, b in zip(mine, base)]
        r = dict(max_abs_err=max(x["max_abs_err"] for x in parts), max_rel_err=max(x["max_rel_err"] for x in parts),
                 tol=parts[0]["tol"], ok=all(x["ok"] for x in parts),
                 bitwise_rerun=all(torch.equal(a, b) for a, b in zip(mine, twice)),
                 finite=all(bool(torch.isfinite(a).all()) for a in mine))
        r.update({f"{o}_max_abs_err": x["max_abs_err"] for o, x in zip(outs, parts)})
        if oracle is not None:
            diffs = [(a.float() - oracle[i]).abs() for a, i in zip(mine, ref_idx)]
            r.update(ref_max_abs_err=max(float(d.max()) for d in diffs),
                     ref_ok=all(bool((d <= BWD_ORACLE_TOL + BWD_ORACLE_TOL * oracle[i].abs()).all())
                                for d, i in zip(diffs, ref_idx)),
                     ref_tol=f"{BWD_ORACLE_TOL:g} abs + rel vs autograd through ops.attention")
        r["ok_all"] = r["ok"] and r["bitwise_rerun"] and r["finite"] and r.get("ref_ok", True)
        res[name] = r
    return dict(args=args, kw=kw, res=res)


def flash_bwd_rows(stage, shape, causal, pol, dtype, gen, spec, peak_name) -> list:
    """Phase 2 rows of flash_dq and flash_dkv at one shape: checked by
    :func:`flash_bwd_case`, timed (CUDA events around a call, and the
    kernel's own device time, :func:`device_time_ms`) beside their plain versions, SDPA's
    backward (the same two ways: one ``torch.autograd.grad`` on a retained
    ``scaled_dot_product_attention`` graph: dq, dk and dv together, so the
    same time stands in both rows) and the bound."""
    import torch.nn.functional as F

    from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import cuda_kernels as ck

    case = flash_bwd_case(shape, causal, dtype, gen)
    args, kw = case["args"], case["kw"]
    q, k, v, g = args[:4]
    torch.cuda.synchronize()
    leaves = [t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v)]
    o = F.scaled_dot_product_attention(*leaves, is_causal=causal)
    g_t = g.transpose(1, 2).contiguous()
    library_ms = gpu_time_ms(lambda: torch.autograd.grad(o, leaves, g_t, retain_graph=True))
    library_device_ms = device_time_ms(lambda: torch.autograd.grad(o, leaves, g_t, retain_graph=True))
    del o, leaves
    b, l, h, d = shape
    rows = []
    for name, run, plain in (
        ("flash_dq", lambda: ck.flash_dq(*args, **kw), lambda: ck.flash_dq_plain(*args, **kw)),
        ("flash_dkv", lambda: ck.flash_dkv(*args, **kw), lambda: ck.flash_dkv_plain(*args, **kw)),
    ):
        res = case["res"][name]
        products, tensors = FLASH_BWD_WORK[name]
        flops = products * b * h * l * l * d // (2 if causal else 1)
        nbytes = tensors * q.numel() * q.element_size() + 2 * b * h * l * 4
        bound, by = spec.bound_ms(flops, nbytes, pol)
        row = dict(
            kernel=name, stage=stage, mode="" if causal else "full", dtype=pol, shape=list(shape), **res,
            ms=gpu_time_ms(run), device_ms=device_time_ms(run, f"{name}_kernel"), plain_ms=gpu_time_ms(plain),
            library_ms=library_ms, library_device_ms=library_device_ms,
            library_call="torch.autograd.grad of F.scaled_dot_product_attention (is_causal; dq, dk, dv together)",
            bound_ms=bound, bound_by=by, flops=flops, bytes=nbytes, peak=f"{spec.name} {peak_name(pol)}",
        )
        log(f"kernel {name}{'' if causal else '[full]'} {stage} {'x'.join(map(str, shape))} {pol}: "
            f"ok={res['ok']} tol={res['tol']} max_abs={res['max_abs_err']:.3g} bitwise_rerun={res['bitwise_rerun']} "
            + (f"vs_oracle={res['ref_max_abs_err']:.3g} ({res['ref_ok']}) " if "ref_ok" in res else "")
            + f"| ms={row['ms']:.4f} device_ms={row['device_ms'] or float('nan'):.4f} plain={row['plain_ms']:.4f} "
            f"sdpa_bwd={library_ms:.4f} (device {library_device_ms or float('nan'):.4f}) bound={bound:.4f} ({by})")
        require(res["ok_all"], f"{name} {stage} {pol} causal={causal}: {res}")
        rows.append(row)
    del case
    return rows


def lm_bwd_kernel_phase(spec, peak_name) -> list:
    """Phase 2, the flash backward in fp32 and bf16: ``flash_dq`` and
    ``flash_dkv`` at ``long_context``'s defaults and at TINY_LM's
    attention, causal and full, and at D = 256 and 512 causal (:func:`flash_bwd_rows`)."""
    rows = []
    for pol, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        gen = torch.Generator(device="cuda").manual_seed(2031)
        for stage, shape, causals in (("long_context", LONG_CONTEXT, (True, False)),
                                      ("tiny_lm", TINY_LM_ATTN, (True, False)), ("d256", FLASH_D256, (True,)),
                                      ("d512", FLASH_D512, (True,))):
            for causal in causals:
                rows += flash_bwd_rows(stage, shape, causal, pol, dtype, gen, spec, peak_name)
        torch.cuda.empty_cache()
    return rows


def lm_bwd_edge_phase() -> list:
    """The flash backward off the main path: flash_dq and flash_dkv at the
    JAX tests' ragged (L, block_q, block_k) = (24, 8, 12) and (192, 48, 64),
    at D = 16, 128 and 256 and the padded D = 8, 24, 48 and 200, causal and full, with and without an lse
    cotangent;
    the gradient of ``out.sum()`` (a zero-stride dO) with q, k, v slices of
    one packed qkv tensor, bitwise the gradient through contiguous copies;
    the joint (out, lse) gradient of ``flash_attention_with_lse`` against
    the oracle (``JOINT_TOL``); operands off 16-byte alignment, forward
    too (:func:`unaligned_bwd_cases`); mixed fp32/bf16 operands, a head
    axis of stride H and B or H past 65535, forward and backward
    (:func:`repair_cases`); every D from 1 to 256 in bf16, forward and
    backward (:func:`bf16_head_dim_sweep`); and the fp32 bits across
    several tiles of the backward (:func:`flash_bwd_tiles_digest`; at
    D >= 256, :func:`flash_bwd_wide_digest`) and the forward
    (:func:`flash_fwd_digest`, at D >= 256 too)."""
    from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(10)
    results = []
    for pol, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        for b, l, h, d, bq, bk in ((2, 24, 3, 16, 8, 12), (2, 192, 3, 64, 48, 64), (2, 24, 2, 128, 8, 12),
                                   (1, 192, 2, 128, 48, 64), (3, 192, 2, 16, 48, 64),
                                   (2, 64, 2, 8, 64, 64), (2, 192, 3, 24, 48, 64), (1, 256, 2, 48, 128, 128),
                                   (2, 192, 2, 256, 48, 64), (1, 256, 3, 200, 128, 128)):
            for causal in (True, False):
                for lse_grad in (False, True):
                    case = flash_bwd_case((b, l, h, d), causal, dtype, gen, bq, bk, lse_grad=lse_grad)
                    for name, res in case["res"].items():
                        results.append((f"{name} {b}x{l}x{h}x{d} blocks ({bq}, {bk}) causal={causal} "
                                        f"lse_grad={lse_grad} {pol}", dict(res, ok=res["ok_all"])))
        for causal in (True, False):
            packed = torch.randn((2, 256, 3, 4 * 32), generator=gen, device="cuda").to(dtype).requires_grad_(True)
            q, k, v = (packed[:, :, i].view(2, 256, 4, 32) for i in range(3))
            (got,) = torch.autograd.grad(fa.flash_attention(q, k, v, causal=causal).sum(), (packed,))
            leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
            out = fa.flash_attention(*leaves, causal=causal)
            want = torch.autograd.grad(out, leaves, torch.ones_like(out))
            same = all(torch.equal(got[:, :, i].reshape(2, 256, 4, 32), w) for i, w in enumerate(want))
            results.append((f"flash backward: strided qkv views and a zero-stride dO, bitwise contiguous, "
                            f"causal={causal} {pol}", dict(ok=same, max_abs_err=0.0)))
    for causal in (True, False):
        leaves = [torch.randn((2, 64, 2, 16), generator=gen, device="cuda").requires_grad_(True) for _ in range(3)]
        o, s = fa.flash_attention_with_lse(*leaves, causal=causal)
        got = torch.autograd.grad((o**2).sum() + torch.sin(s).sum(), leaves)
        sc = torch.einsum("blhd,bmhd->bhlm", leaves[0], leaves[1]) / 16**0.5
        if causal:
            sc = sc.masked_fill(~torch.ones(64, 64, dtype=torch.bool, device="cuda").tril(), -1e30)
        oo = torch.einsum("bhlm,bmhd->blhd", sc.softmax(-1), leaves[2])
        want = torch.autograd.grad((oo**2).sum() + torch.sin(torch.logsumexp(sc, -1)).sum(), leaves)
        err = max(float((a - w).abs().max()) for a, w in zip(got, want))
        ok = all(bool(((a - w).abs() <= JOINT_TOL + JOINT_TOL * w.abs()).all()) for a, w in zip(got, want))
        results.append((f"flash_attention_with_lse joint (out, lse) gradient vs the oracle causal={causal} fp32",
                        dict(ok=ok, max_abs_err=err)))
    results += unaligned_bwd_cases(gen)
    results += repair_cases(gen)
    results.append(("flash_fwd, flash_dq, flash_dkv at every D from 1 to 256 (bf16, 1x64x2xD, causal) through "
                    "the kernels, each within 1 ulp + its rule's share of the max of its plain version",
                    bf16_head_dim_sweep()))
    results.append(("flash_dq, flash_dkv in fp32 across several tiles (FLASH_BWD_TILE_SHAPES, causal and full): "
                    "the bits of FLASH_BWD_TILES_SHA256", flash_bwd_tiles_digest()))
    results.append(("flash_dq, flash_dkv in fp32 at D = 256, 320, 512 and 1024 across several tiles "
                    "(FLASH_BWD_WIDE_SHAPES, causal and full): the bits of FLASH_BWD_WIDE_SHA256",
                    flash_bwd_wide_digest()))
    results.append(("flash_fwd in fp32 across several tiles (FLASH_BWD_TILE_SHAPES, causal and full): "
                    "the bits of FLASH_FWD_TILES_SHA256",
                    flash_fwd_digest(FLASH_BWD_TILE_SHAPES, 2000, FLASH_FWD_TILES_SHA256)))
    results.append(("flash_fwd in fp32 at D = 256, 320, 512 and 1024 across several tiles (FLASH_BWD_WIDE_SHAPES, "
                    "causal and full): the bits of FLASH_FWD_WIDE_SHA256",
                    flash_fwd_digest(FLASH_BWD_WIDE_SHAPES, 4000, FLASH_FWD_WIDE_SHA256)))
    torch.cuda.synchronize()
    for what, res in results:
        log(f"edge {what}: ok={res['ok']} max_abs={res['max_abs_err']:.3g}"
            + (f" bitwise_rerun={res['bitwise_rerun']}" if "bitwise_rerun" in res else "")
            + (f" vs_oracle={res['ref_max_abs_err']:.3g}" if "ref_max_abs_err" in res else "")
            + (f" worst_share_of_tolerance={res['worst_share_of_tolerance']:.3g} failing={res['failing_head_dims']}"
               if "worst_share_of_tolerance" in res else ""))
        require(res["ok"], f"edge case {what}: {res}")
    return results


def bf16_head_dim_sweep() -> dict:
    """Every head dim from 1 to 256 in bf16: :func:`head_dim_sweep`'s
    inputs (numpy, seed D, (1, 64, 2, D), causal) cast to bf16, through
    flash_fwd, then flash_dq and flash_dkv, each launched once (the counts
    say so): out within 1 bf16 ulp + ``FLASH_PLAIN_V_REL`` x max |v| and lse
    within ``LSE_REL`` of flash_fwd_plain's, dq, dk and dv each within 1
    bf16 ulp + ``BWD_PLAIN_REL`` x max of its plain version, a second launch
    of each kernel bitwise the first, every output finite."""
    from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import cuda_kernels as ck

    worst, bad = 0.0, []
    for d in range(1, 257):
        rng = np.random.default_rng(d)
        q, k, v, g = (torch.from_numpy(rng.standard_normal((1, 64, 2, d), dtype=np.float32)).cuda().to(torch.bfloat16)
                      for _ in range(4))
        ck.reset_launches()
        out, lse = ck.flash_fwd(q, k, v, causal=True)
        delta = (g.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()
        args = (q, k, v, g, lse, delta)
        got = (ck.flash_dq(*args, causal=True), *ck.flash_dkv(*args, causal=True))
        launched = ck.LAUNCHES["flash_fwd"] == ck.LAUNCHES["flash_dq"] == ck.LAUNCHES["flash_dkv"] == 1
        fwd_again = ck.flash_fwd(q, k, v, causal=True)
        again = (ck.flash_dq(*args, causal=True), *ck.flash_dkv(*args, causal=True))
        want = (ck.flash_dq_plain(*args, causal=True), *ck.flash_dkv_plain(*args, causal=True))
        fwd = flash_fwd_against_plain(out, lse, q, k, v, causal=True)
        parts = [compare(("ulp", BWD_PLAIN_REL), a, b) for a, b in zip(got, want)]
        worst = max(worst, *(x["max_share"] for x in parts))
        ok = (launched and fwd["ok"] and fwd["lse_ok"] and all(x["ok"] for x in parts)
              and torch.equal(out, fwd_again[0]) and torch.equal(lse, fwd_again[1])
              and all(torch.equal(a, b) for a, b in zip(got, again))
              and all(bool(torch.isfinite(a).all()) for a in (out, lse, *got)))
        if not ok:
            bad.append(d)
    ck.reset_launches()
    return dict(ok=not bad, failing_head_dims=bad, max_abs_err=0.0, worst_share_of_tolerance=worst)


def unaligned_bwd_cases(gen) -> list:
    """flash_fwd, flash_dq and flash_dkv on q, k, v and dO that are views
    one element off 16-byte alignment (one packed (B, L, H, 4D + 1) tensor,
    its columns from 1 on), at D = 32 and 64, and 256 and 320 (the D = 256
    and windowed instances), with a ragged L = 100, causal and full, in fp32
    and bf16: the kernels' element-by-element copy path,
    bitwise their results on contiguous copies (the same shared-memory
    tiles) and within the plain rules."""
    from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import cuda_kernels as ck

    results = []
    for pol, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        rule = BWD_PLAIN_REL if pol == "fp32" else ("ulp", BWD_PLAIN_REL)
        for d in (32, 64, 256, 320):
            for causal in (True, False):
                packed = torch.randn((2, 100, 3, 4 * d + 1), generator=gen, device="cuda").to(dtype)
                views = tuple(packed[..., 1 + i * d: 1 + (i + 1) * d] for i in range(4))
                copies = tuple(t.contiguous() for t in views)
                ck.reset_launches()
                fwd = ck.flash_fwd(*views[:3], causal=causal)
                out, lse = ck.flash_fwd(*copies[:3], causal=causal)
                delta = (copies[3].float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()
                got = (ck.flash_dq(*views, lse, delta, causal=causal), *ck.flash_dkv(*views, lse, delta, causal=causal))
                launched = (ck.LAUNCHES["flash_fwd"], ck.LAUNCHES["flash_dq"], ck.LAUNCHES["flash_dkv"]) == (2, 1, 1)
                want = (ck.flash_dq(*copies, lse, delta, causal=causal),
                        *ck.flash_dkv(*copies, lse, delta, causal=causal))
                plain = (ck.flash_dq_plain(*copies, lse, delta, causal=causal),
                         *ck.flash_dkv_plain(*copies, lse, delta, causal=causal))
                parts = [compare(rule, a, b) for a, b in zip(got, plain)]
                fwd_plain = flash_fwd_against_plain(out, lse, *copies[:3], causal=causal)
                same = (torch.equal(fwd[0], out) and torch.equal(fwd[1], lse)
                        and all(torch.equal(a, b) for a, b in zip(got, want)))
                results.append((f"flash_fwd, flash_dq, flash_dkv on views off 16-byte alignment, 2x100x3x{d} "
                                f"causal={causal} {pol}: bitwise contiguous={same}",
                                dict(ok=launched and same and all(x["ok"] for x in parts) and fwd_plain["ok"]
                                     and fwd_plain["lse_ok"],
                                     max_abs_err=max(fwd_plain["max_abs_err"], *(x["max_abs_err"] for x in parts)))))
    ck.reset_launches()
    return results


def repair_cases(gen) -> list:
    """What the JAX kernel takes and the port's flash wrappers once refused,
    through the kernels on the card, forward and backward, each kernel's
    launch counted (one per call) and each output in the dtype JAX gives it:
    q, k, v mixing fp32 and bf16 (the kernels then run in fp32 on fp32
    copies: out, dq, dk, dv within the fp32 rules, plus 1 ulp where the
    output is bf16); a head axis with stride H (a (B, L, D, H).transpose(2,
    3) view), bitwise the results on contiguous copies; and B or H of 65537,
    past the card's grid y/z limit, at L = 2 and 64 (D = 16, 64 and 256)
    against the plain versions and at L = 1 (D = 64 and 256), where out is
    v and dv is dO bitwise."""
    from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import cuda_kernels as ck

    f32, b16 = torch.float32, torch.bfloat16

    def run(q, k, v, g, causal):
        ck.reset_launches()
        out, lse = ck.flash_fwd(q, k, v, causal=causal)
        # g contiguous first: a strided view's sum may take another order, and delta another bit
        delta = (g.contiguous().float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()
        grads = (ck.flash_dq(q, k, v, g, lse, delta, causal=causal),
                 *ck.flash_dkv(q, k, v, g, lse, delta, causal=causal))
        launched = (ck.LAUNCHES["flash_fwd"], ck.LAUNCHES["flash_dq"], ck.LAUNCHES["flash_dkv"]) == (1, 1, 1)
        return out, lse, delta, grads, launched

    def held(q, k, v, g, causal, what):
        out, lse, delta, grads, launched = run(q, k, v, g, causal)
        fwd = flash_fwd_against_plain(out, lse, q, k, v, causal=causal)
        args = (q, k, v, g, lse, delta)
        plain = (ck.flash_dq_plain(*args, causal=causal), *ck.flash_dkv_plain(*args, causal=causal))
        parts = [compare(BWD_PLAIN_REL if a.dtype == f32 else ("ulp", BWD_PLAIN_REL), a, b)
                 for a, b in zip(grads, plain)]
        dtypes = [t.dtype for t in (out, *grads)] == [q.dtype, q.dtype, k.dtype, v.dtype]
        ok = launched and dtypes and fwd["ok"] and fwd["lse_ok"] and all(x["ok"] for x in parts)
        return (what, dict(ok=ok, max_abs_err=max(fwd["max_abs_err"], *(x["max_abs_err"] for x in parts)),
                           launched=launched, dtypes_as_jax=dtypes))

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    results = []
    for causal in (True, False):
        for dts in ((f32, b16, f32), (b16, f32, b16)):
            shape = (2, 256, 3, 64)
            q, k, v = (randn(shape, dt) for dt in dts)
            g = randn(shape, dts[0])
            names = "/".join("fp32" if dt == f32 else "bf16" for dt in dts)
            results.append(held(q, k, v, g, causal, f"flash kernels on mixed q/k/v {names} 2x256x3x64 "
                                                    f"causal={causal} (fp32 arithmetic, JAX's output dtypes)"))
        for pol, dt in (("fp32", f32), ("bf16", b16)):
            q, k, v, g = (randn((2, 256, 64, 3), dt).transpose(2, 3) for _ in range(4))
            res = held(q, k, v, g, causal, "")[1]
            got = run(q, k, v, g, causal)
            want = run(*(t.contiguous() for t in (q, k, v, g)), causal)
            same = all(torch.equal(a, b) for a, b in zip((got[0], got[1], *got[3]), (want[0], want[1], *want[3])))
            results.append((f"flash kernels on a head axis of stride 3 (2x256x3x64 transposed views) causal={causal} "
                            f"{pol}: bitwise contiguous copies={same}", dict(res, ok=res["ok"] and same)))
    for shape, dt, causal in (((65537, 2, 1, 64), f32, False), ((1, 2, 65537, 64), b16, True),
                              ((65537, 2, 1, 256), f32, True), ((1, 2, 65537, 256), b16, False),
                              ((65537, 64, 1, 16), b16, True), ((1, 64, 65537, 16), f32, False)):
        q, k, v, g = (randn(shape, dt) for _ in range(4))
        results.append(held(q, k, v, g, causal, f"flash kernels at B or H past 65535, {'x'.join(map(str, shape))} "
                                                f"causal={causal} {'fp32' if dt == f32 else 'bf16'}"))
        del q, k, v, g
    # L = 1: p = 1, so out is v and dv is dO, bitwise (dq and dk are 0 but for the rounding of dp - delta, which
    # no relative rule can hold)
    for shape, dt in (((65537, 1, 1, 64), f32), ((1, 1, 65537, 256), b16)):
        q, k, v, g = (randn(shape, dt) for _ in range(4))
        out, _lse, _delta, grads, launched = run(q, k, v, g, True)
        ok = (launched and torch.equal(out, v) and torch.equal(grads[2], g)
              and all(bool(torch.isfinite(t).all()) for t in grads))
        results.append((f"flash kernels at B or H past 65535, {'x'.join(map(str, shape))} causal "
                        f"{'fp32' if dt == f32 else 'bf16'}: out is v and dv is dO, bitwise",
                        dict(ok=ok, max_abs_err=float((out.float() - v.float()).abs().max()), launched=launched)))
        del q, k, v, g, out, grads
    ck.reset_launches()
    torch.cuda.empty_cache()
    return results


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def lm_edge_phase() -> list:
    """The LM slice's kernels off the main path: flash_fwd at the JAX
    tests' ragged (L, block_q, block_k) = (24, 8, 12) and (192, 48, 64),
    at D = 16 and 128, causal and full; on strided q, k, v (slices of one
    packed qkv tensor) bitwise against contiguous copies; at D = 8, 24 and
    48, which the wrappers zero-pad to the next kernel width, at D = 256
    and the padded D = 200, and every D from 1 to 256 (fp32, through the
    kernel: the launch counted; the bits as before, ``FLASH_SWEEP_SHA256``),
    D = 257, 320 and 512 (and 1024 in fp32) through the windowed instance
    of all three flash kernels (:func:`wide_head_dim_cases`); relu at an
    odd size, on a NaN (kept, bits and all) and -0.0 (to +0.0), and on a
    view 4 bytes off 16-byte alignment."""
    from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import cuda_kernels as ck

    gen = torch.Generator(device="cuda").manual_seed(9)
    results = []
    for pol, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        for b, l, h, d, bq, bk in ((2, 24, 3, 16, 8, 12), (2, 192, 3, 64, 48, 64), (2, 24, 2, 128, 8, 12),
                                   (1, 192, 2, 128, 48, 64), (3, 192, 2, 16, 48, 64)):
            for causal in (True, False):
                res = flash_case((b, l, h, d), causal, dtype, gen, bq, bk)["res"]
                results.append((f"flash_fwd {b}x{l}x{h}x{d} blocks ({bq}, {bk}) causal={causal} {pol}",
                                dict(res, ok=res["ok_all"])))
        packed = torch.randn((2, 256, 3, 4 * 32), generator=gen, device="cuda").to(dtype)
        q, k, v = (packed[:, :, i].view(2, 256, 4, 32) for i in range(3))
        got = ck.flash_fwd(q, k, v, causal=True)
        want = ck.flash_fwd(q.contiguous(), k.contiguous(), v.contiguous(), causal=True)
        same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        results.append((f"flash_fwd strided qkv views vs contiguous {pol}", dict(ok=same, max_abs_err=0.0)))
        for b, l, h, d, bq, bk in ((2, 64, 2, 8, 64, 64), (2, 192, 3, 24, 48, 64), (1, 256, 2, 48, 128, 128)):
            for causal in (True, False):
                res = flash_case((b, l, h, d), causal, dtype, gen, bq, bk)["res"]
                results.append((f"flash_fwd {b}x{l}x{h}x{d} (padded) blocks ({bq}, {bk}) causal={causal} {pol}",
                                dict(res, ok=res["ok_all"])))
        # the widest instantiation (D = 256, the tiles in 64-column chunks) and D = 200 padded to it
        for b, l, h, d, bq, bk in ((2, 192, 2, 256, 48, 64), (1, 256, 3, 200, 128, 128)):
            for causal in (True, False):
                res = flash_case((b, l, h, d), causal, dtype, gen, bq, bk)["res"]
                results.append((f"flash_fwd {b}x{l}x{h}x{d} blocks ({bq}, {bk}) causal={causal} {pol}",
                                dict(res, ok=res["ok_all"])))
        # above 256 the windowed instance of each kernel: every window sums the scores over all of D
        for d in FLASH_WIDE_DIMS + ((1024,) if pol == "fp32" else ()):
            results += wide_head_dim_cases(d, dtype, gen)
        x = torch.randn((7, 13, 5), generator=gen, device="cuda").to(dtype)
        x.view(-1)[:4] = torch.tensor([float("nan"), -0.0, float("-inf"), -float("nan")], dtype=dtype)
        for name, t in (("odd 7x13x5 with NaN, -0.0, -inf", x), ("view off alignment", x.view(-1)[1:])):
            got, want = ck.relu(t), ck.relu_plain(t)
            ok = torch.equal(_bits(got), _bits(want)) and bool(torch.isnan(got.view(-1)[0] if t is x else got.view(-1)[2]))
            results.append((f"relu {name} {pol} (bitwise)", dict(ok=ok, max_abs_err=0.0)))
        got = ck.relu(x)
        results.append((f"relu -0.0 to +0.0 {pol}", dict(ok=not bool(torch.signbit(got.view(-1)[1])), max_abs_err=0.0)))
    results.append(("flash_fwd, flash_dq, flash_dkv at every D from 1 to 256 (fp32, 1x64x2xD, causal) "
                    "through the kernels, the bits of FLASH_SWEEP_SHA256", head_dim_sweep()))
    torch.cuda.synchronize()
    for what, res in results:
        log(f"edge {what}: ok={res['ok']} max_abs={res['max_abs_err']:.3g}"
            + (f" lse_max_abs={res['lse_max_abs_err']:.3g} vs_oracle={res['ref_max_abs_err']:.3g}"
               f" bitwise_rerun={res['bitwise_rerun']}" if "lse_max_abs_err" in res else ""))
        require(res["ok"], f"edge case {what}: {res}")
    return results


def wide_head_dim_cases(d, dtype, gen) -> list:
    """Head dim ``d`` above 256 at (1, 192, 2, d), blocks (48, 64), causal
    and full: flash_fwd by :func:`flash_case` and flash_dq, flash_dkv by
    :func:`flash_bwd_case`, each within the tolerances of the module
    docstring, and each launched through its kernel (the counts say so)."""
    from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import cuda_kernels as ck

    pol = "fp32" if dtype == torch.float32 else "bf16"
    dp, windows = ck.flash_width(d)
    results = []
    for causal in (True, False):
        ck.reset_launches()
        fwd = flash_case((1, 192, 2, d), causal, dtype, gen, 48, 64)["res"]
        bwd = flash_bwd_case((1, 192, 2, d), causal, dtype, gen, 48, 64)["res"]
        # flash_case launches flash_fwd twice (the rerun), flash_bwd_case once more and each backward kernel twice
        launched = (ck.LAUNCHES["flash_fwd"], ck.LAUNCHES["flash_dq"], ck.LAUNCHES["flash_dkv"]) == (3, 2, 2)
        tag = f"1x192x2x{d} (run at {dp}, {windows} windows) causal={causal} {pol}"
        results.append((f"flash_fwd {tag}", dict(fwd, ok=fwd["ok_all"] and launched)))
        for name, res in bwd.items():
            results.append((f"{name} {tag}", dict(res, ok=res["ok_all"] and launched)))
    ck.reset_launches()
    return results


def head_dim_sweep() -> dict:
    """Every head dim from 1 to 256, fp32, (1, 64, 2, D) causal, inputs
    drawn with numpy from the seed D: flash_fwd, flash_dq and flash_dkv
    each launch their kernel once (the count says so) and agree with their
    plain versions (out: ``FLASH_PLAIN_V_REL`` of max |v|; dq, dk, dv:
    ``BWD_PLAIN_REL`` of each one's max); and the bits of every out, lse,
    dq, dk and dv hash to ``FLASH_SWEEP_SHA256``."""
    from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import cuda_kernels as ck

    worst, bad, digest = 0.0, [], hashlib.sha256()
    for d in range(1, 257):
        rng = np.random.default_rng(d)
        q, k, v, g = (torch.from_numpy(rng.standard_normal((1, 64, 2, d), dtype=np.float32)).cuda()
                      for _ in range(4))
        ck.reset_launches()
        out, lse = ck.flash_fwd(q, k, v, causal=True)
        delta = (g * out).sum(-1).permute(0, 2, 1).contiguous()
        dq = ck.flash_dq(q, k, v, g, lse, delta, causal=True)
        dk, dv = ck.flash_dkv(q, k, v, g, lse, delta, causal=True)
        launched = ck.LAUNCHES["flash_fwd"] == ck.LAUNCHES["flash_dq"] == ck.LAUNCHES["flash_dkv"] == 1
        for t in (out, lse, dq, dk, dv):
            digest.update(t.contiguous().cpu().numpy().tobytes())
        p_out, _ = ck.flash_fwd_plain(q, k, v, causal=True)
        parts = [float((out - p_out).abs().max()) / float(v.abs().max()) / FLASH_PLAIN_V_REL]
        want = (ck.flash_dq_plain(q, k, v, g, lse, delta, causal=True),
                *ck.flash_dkv_plain(q, k, v, g, lse, delta, causal=True))
        parts += [compare(BWD_PLAIN_REL, a, b)["max_rel_err"] / BWD_PLAIN_REL for a, b in zip((dq, dk, dv), want)]
        shapes = all(t.shape == q.shape and t.is_contiguous() for t in (out, dq, dk, dv))
        worst = max(worst, *parts)
        if not (launched and shapes and max(parts) <= 1.0):
            bad.append(d)
    ck.reset_launches()
    sha = digest.hexdigest()
    return dict(ok=not bad and sha == FLASH_SWEEP_SHA256, failing_head_dims=bad, max_abs_err=0.0,
                worst_share_of_tolerance=worst, sha256=sha, sha256_held=FLASH_SWEEP_SHA256)


# the fp32 flash backward across several tiles (the sweep above runs one 64-row tile): (B, L, H, D), causal
# and full, L ragged against the 64-row tiles at each kernel width up to 128
FLASH_BWD_TILE_SHAPES = ((2, 192, 3, 64), (2, 256, 4, 32), (1, 300, 2, 128), (2, 100, 3, 16), (1, 1024, 2, 64))
# sha256 of the bits of dq, dk and dv of flash_bwd_tiles_digest, as the FFMA kernels of flash_bwd.cuh gave them
# before the Hopper redesign (NVIDIA H100 build, CUDA 12.8; ``python3 chip_smoke.py --record`` in a checkout
# of that tree with this file copied in prints it): the fp32 redesign keeps the operations and their order
FLASH_BWD_TILES_SHA256 = "907569fe7f50545e9a4846a8df7ec66c0f417cca2395b08a7aebfd06ed5e19e6"


def flash_bwd_tiles_digest() -> dict:
    """fp32 flash_dq and flash_dkv at ``FLASH_BWD_TILE_SHAPES``, causal and
    full, inputs drawn with numpy (seed 1000 + L + D), lse and delta from
    flash_fwd: the sha256 of the bits of every dq, dk and dv, and each
    one's launch counted."""
    from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import cuda_kernels as ck

    digest, launched = hashlib.sha256(), True
    for shape in FLASH_BWD_TILE_SHAPES:
        for causal in (True, False):
            rng = np.random.default_rng(1000 + shape[1] + shape[3])
            q, k, v, g = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).cuda() for _ in range(4))
            kw = dict(causal=causal, block_q=shape[1], block_k=shape[1])
            out, lse = ck.flash_fwd(q, k, v, **kw)
            delta = (g * out).sum(-1).permute(0, 2, 1).contiguous()
            ck.reset_launches()
            outs = (ck.flash_dq(q, k, v, g, lse, delta, **kw), *ck.flash_dkv(q, k, v, g, lse, delta, **kw))
            launched &= ck.LAUNCHES["flash_dq"] == ck.LAUNCHES["flash_dkv"] == 1
            for t in outs:
                digest.update(t.contiguous().cpu().numpy().tobytes())
    ck.reset_launches()
    sha = digest.hexdigest()
    return dict(ok=launched and sha == FLASH_BWD_TILES_SHA256, max_abs_err=0.0, sha256=sha,
                sha256_held=FLASH_BWD_TILES_SHA256)


# the fp32 flash backward at D >= 256 across several tiles (B, L, H, D), causal and full: L ragged against the
# 64-row tiles, D = 256 (one window), 320 (windows of 256 and 64 columns), 512 (two) and 1024 (four)
FLASH_BWD_WIDE_SHAPES = ((2, 200, 3, 256), (1, 300, 2, 320), (2, 130, 2, 512), (1, 260, 1, 1024))
# sha256 of the bits of dq, dk and dv of flash_bwd_wide_digest, as the FFMA kernels of the retired
# flash_bwd.cuh gave them before the Hopper redesign of D >= 256 (NVIDIA H100 build, CUDA 12.8; ``python3
# chip_smoke.py --record`` in a checkout of that tree with this file copied in prints it): the fp32 redesign
# keeps the operations and their order
FLASH_BWD_WIDE_SHA256 = "148705ace0e21e2169f5af7d14c37ea77df00e9fa17109f5474f58663e8809a5"


def flash_bwd_wide_digest() -> dict:
    """fp32 flash_dq and flash_dkv at ``FLASH_BWD_WIDE_SHAPES``, causal and
    full, inputs drawn with numpy (seed 3000 + L + D), lse and delta from
    flash_fwd: the sha256 of the bits of every dq, dk and dv, and each
    one's launch counted."""
    from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import cuda_kernels as ck

    digest, launched = hashlib.sha256(), True
    for shape in FLASH_BWD_WIDE_SHAPES:
        for causal in (True, False):
            rng = np.random.default_rng(3000 + shape[1] + shape[3])
            q, k, v, g = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).cuda() for _ in range(4))
            kw = dict(causal=causal, block_q=shape[1], block_k=shape[1])
            out, lse = ck.flash_fwd(q, k, v, **kw)
            delta = (g * out).sum(-1).permute(0, 2, 1).contiguous()
            ck.reset_launches()
            outs = (ck.flash_dq(q, k, v, g, lse, delta, **kw), *ck.flash_dkv(q, k, v, g, lse, delta, **kw))
            launched &= ck.LAUNCHES["flash_dq"] == ck.LAUNCHES["flash_dkv"] == 1
            for t in outs:
                digest.update(t.contiguous().cpu().numpy().tobytes())
    ck.reset_launches()
    sha = digest.hexdigest()
    return dict(ok=launched and sha == FLASH_BWD_WIDE_SHA256, max_abs_err=0.0, sha256=sha,
                sha256_held=FLASH_BWD_WIDE_SHA256)


# sha256 of the bits of out and lse of flash_fwd_digest at FLASH_BWD_TILE_SHAPES, as the fp32 FFMA forward gave
# them before its Hopper redesign (NVIDIA H100 build, CUDA 12.8; ``python3 chip_smoke.py --record`` in a checkout
# of that tree with this file copied in prints it): the fp32 redesign keeps the operations and their order
FLASH_FWD_TILES_SHA256 = "4a8c34a01fb48dd806868d1c9d786c26e898c9bd898602f7fc536c592afed1d5"


def flash_fwd_digest(shapes, seed: int, held: str) -> dict:
    """fp32 flash_fwd at ``shapes`` (several 64-row tiles, ragged L), causal
    and full, inputs drawn with numpy (seed ``seed`` + L + D): the sha256 of
    the bits of every out and lse, held to ``held``, and each launch
    counted. ``FLASH_BWD_TILE_SHAPES`` from seed 2000 give
    ``FLASH_FWD_TILES_SHA256``; ``FLASH_BWD_WIDE_SHAPES`` (D = 256, 320, 512
    and 1024) from seed 4000 ``FLASH_FWD_WIDE_SHA256``."""
    from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import cuda_kernels as ck

    digest, launched = hashlib.sha256(), True
    for shape in shapes:
        for causal in (True, False):
            rng = np.random.default_rng(seed + shape[1] + shape[3])
            q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).cuda() for _ in range(3))
            ck.reset_launches()
            outs = ck.flash_fwd(q, k, v, causal=causal, block_q=shape[1], block_k=shape[1])
            launched &= ck.LAUNCHES["flash_fwd"] == 1
            for t in outs:
                digest.update(t.contiguous().cpu().numpy().tobytes())
    ck.reset_launches()
    sha = digest.hexdigest()
    return dict(ok=launched and sha == held, max_abs_err=0.0, sha256=sha, sha256_held=held)


# sha256 of the bits of out and lse of flash_fwd_digest at FLASH_BWD_WIDE_SHAPES, as the parent FFMA kernels of
# D >= 256 (``flash_fwd_kernel<float, 256>``, ``flash_fwd_wide_kernel<float>``) gave them before their Hopper
# redesign (NVIDIA H100 build, CUDA 12.8; ``python3 chip_smoke.py --record`` in a checkout of that tree with this
# file copied in prints it): the fp32 redesign keeps the operations and their order
FLASH_FWD_WIDE_SHA256 = "a38c2c39af2dfe58feef35ce9ba639a02083c3aa801f6feb1eb895c06bd17c16"


def run_long_context(argv) -> dict:
    """``examples.long_context.main`` with the launch counts set to 0 just
    before and read just after; its contract lines parsed."""
    from cuda_mpi_gpu_cluster_programming_tpu_torch.examples import long_context
    from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import cuda_kernels as ck

    buf = io.StringIO()
    ck.reset_launches()
    with contextlib.redirect_stdout(buf):
        rc = long_context.main(argv)
    launches = dict(ck.LAUNCHES)
    out = buf.getvalue()
    require(rc == 0, f"long_context {argv} returned {rc}:\n{out}")
    calls = int(re.search(r"^Kernel launches: .* calls=(\d+)$", out, re.M).group(1))
    m = re.search(r"^Attention completed in ([0-9.]+) ms \((\d+) tok/s\)$", out, re.M)
    verdict = re.search(r"^Verification: max\|delta\| = (\S+) .* -> (PASSED|FAILED)$", out, re.M)
    shape = re.search(r"^Final Output Shape: (\S+)$", out, re.M).group(1)
    first10 = [float(x) for x in re.search(r"^Final Output \(first 10 values\): (.+)$", out, re.M).group(1).split()]
    require(m is not None and verdict is not None and verdict.group(2) == "PASSED", f"long_context {argv}:\n{out}")
    require(re.search(r"^KV resident per device: ", out, re.M) is not None, "no KV residency line")
    require(len(first10) == 10 and all(np.isfinite(first10)), f"first 10 values {first10}")
    return dict(ms=float(m.group(1)), tok_s=int(m.group(2)), max_delta=float(verdict.group(1)), calls=calls,
                launches=launches, shape=shape, stdout=out)


def lm_path_phase() -> dict:
    """Phase 3b: the transformer LM's forward family on the card.

    ``examples.long_context.main`` at its defaults (B=1, L=4096, H=8, D=64,
    causal): ``--strategy flash --verify`` in fp32 and bf16 (one flash_fwd
    launch per call) and ``--strategy single``. At TINY_LM (d_model 128, 4
    heads, d_ff 512, 2 layers, vocab 256), batch 8, L=1024: ``forward_lm``
    with flash against reference (2 launches per forward, TF32 off),
    fp32 and bf16; ``lm_loss`` for both; ``decode_logits`` against
    ``forward_lm``; greedy ``generate`` for 32 steps, each token the argmax
    of the forward's logits within the fp32 tolerance. Then the unfused
    conv1 -> relu launch sequence, bitwise the fused conv."""
    from cuda_mpi_gpu_cluster_programming_tpu_torch.models import transformer as tf
    from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import cuda_kernels as ck
    from cuda_mpi_gpu_cluster_programming_tpu_torch.utils.tree import tree_map

    result = {"runs": {}}
    lc_shape = "x".join(map(str, LONG_CONTEXT))
    for strategy, pol in (("flash", "fp32"), ("flash", "bf16"), ("single", "fp32")):
        r = run_long_context(["--strategy", strategy, "--verify", "--dtype", pol])
        name = f"long_context --strategy {strategy}/{pol}"
        per_call = 1 if strategy == "flash" else 0
        want = _launches(flash_fwd=per_call * r["calls"])
        log(f"path {name}: {r['ms']:.4f} ms ({r['tok_s']} tok/s) max|delta|={r['max_delta']:.3g} "
            f"shape={r['shape']} launches flash_fwd={r['launches']['flash_fwd']} calls={r['calls']}")
        require(r["shape"] == lc_shape, f"{name}: shape {r['shape']}")
        require(r["calls"] > 0 and r["launches"] == want, f"{name}: launches {r['launches']}, want {want}")
        result["runs"][name] = dict(r, passes=r["calls"])

    cfg = tf.TINY_LM
    flash_cfg = dataclasses.replace(cfg, attn_impl="flash")
    gen = torch.Generator().manual_seed(2026)
    params = tf.init_transformer(cfg, generator=gen, device="cuda")
    # lm_loss predicts token t + 1 from tokens 0..t: max_len + 1 tokens give a forward over max_len
    loss_toks = torch.randint(0, cfg.vocab, (LM_BATCH, cfg.max_len + 1), generator=gen).cuda()
    toks = loss_toks[:, :-1]
    n_tok = LM_BATCH * cfg.max_len

    def forward(p, c, name, per_forward):
        ck.reset_launches()
        with torch.inference_mode():
            out = tf.forward_lm(p, toks, c)
        torch.cuda.synchronize()
        launches = dict(ck.LAUNCHES)
        want = _launches(flash_fwd=per_forward)
        require(launches == want, f"{name}: launches {launches}, want {want}")
        require(tuple(out.shape) == (LM_BATCH, cfg.max_len, cfg.vocab) and bool(torch.isfinite(out).all()),
                f"{name}: output {tuple(out.shape)} or non-finite")
        with torch.inference_mode():
            ms = gpu_time_ms(lambda: tf.forward_lm(p, toks, c), reps=10)
        log(f"path {name}: {ms:.4f} ms ({n_tok / ms * 1e3:.0f} tok/s) launches flash_fwd={launches['flash_fwd']}")
        result["runs"][name] = dict(ms=ms, tok_s=n_tok / ms * 1e3, launches=launches, passes=1)
        return out

    # the LM path must turn TF32 off itself: switch it on and read it back after a forward
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    lf = forward(params, flash_cfg, "forward_lm flash/fp32", cfg.n_layers)
    require(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32,
            "forward_lm left TF32 on")
    lr = forward(params, cfg, "forward_lm reference/fp32", 0)
    err = float((lf - lr).abs().max())
    ok = bool(torch.allclose(lf, lr, rtol=LM_RTOL, atol=LM_ATOL))
    log(f"forward_lm flash vs reference fp32: max_abs={err:.3g} (rtol {LM_RTOL:g}, atol {LM_ATOL:g}) ok={ok}")
    require(ok, "forward_lm flash disagrees with reference (fp32)")
    result["forward_flash_vs_reference/fp32"] = err

    pb = tree_map(lambda t: t.to(torch.bfloat16), params)
    lfb = forward(pb, flash_cfg, "forward_lm flash/bf16", cfg.n_layers)
    lrb = forward(pb, cfg, "forward_lm reference/bf16", 0)
    errb = float((lfb.float() - lrb.float()).abs().max())
    okb = bool(torch.allclose(lfb.float(), lrb.float(), rtol=LM_BF16_RTOL, atol=LM_BF16_ATOL))
    log(f"forward_lm flash vs reference bf16: max_abs={errb:.3g} (rtol {LM_BF16_RTOL:g}, atol {LM_BF16_ATOL:g}) ok={okb}")
    require(okb, "forward_lm flash disagrees with reference (bf16)")
    result["forward_flash_vs_reference/bf16"] = errb
    del pb, lfb, lrb

    with torch.inference_mode():
        loss_f, loss_r = (float(tf.lm_loss(params, loss_toks, c)) for c in (flash_cfg, cfg))
    log(f"lm_loss flash={loss_f:.6f} reference={loss_r:.6f}")
    require(np.isfinite(loss_f) and abs(loss_f - loss_r) <= 1e-5 * abs(loss_r), "lm_loss flash vs reference")
    result["lm_loss"] = dict(flash=loss_f, reference=loss_r)

    ck.reset_launches()
    t0 = time.perf_counter()
    dl = tf.decode_logits(params, toks, cfg)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    err = float((dl - lr).abs().max())
    ok = bool(torch.allclose(dl, lr, rtol=LM_RTOL, atol=LM_ATOL))
    log(f"decode_logits vs forward_lm fp32: max_abs={err:.3g} ok={ok} | {dt * 1e3:.1f} ms "
        f"({n_tok / dt:.0f} tok/s teacher-forced, batch {LM_BATCH})")
    require(ok and dict(ck.LAUNCHES) == _launches(), "decode_logits vs forward_lm, or it launched a kernel")
    result["runs"]["decode_logits/fp32"] = dict(ms=dt * 1e3, tok_s=n_tok / dt, max_abs=err, launches=dict(ck.LAUNCHES))
    del dl, lf, lr

    steps, plen = 32, 64
    prompt = toks[:, :plen]
    ck.reset_launches()
    t0 = time.perf_counter()
    seq = tf.generate(params, prompt, cfg, steps=steps)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    require(tuple(seq.shape) == (LM_BATCH, plen + steps) and torch.equal(seq[:, :plen], prompt.long())
            and int(seq.min()) >= 0 and int(seq.max()) < cfg.vocab, f"generate output {tuple(seq.shape)}")
    with torch.inference_mode():
        lg = tf.forward_lm(params, seq[:, :-1], cfg)[:, plen - 1:]
    chosen = lg.gather(-1, seq[:, plen:, None])[..., 0]
    gap = float((lg.amax(-1) - chosen).max())
    log(f"generate greedy {steps} steps, batch {LM_BATCH}, prompt {plen}: {dt * 1e3:.1f} ms "
        f"({LM_BATCH * steps / dt:.0f} tok/s); largest logit gap of a chosen token {gap:.3g}")
    require(bool((lg.amax(-1) - chosen <= LM_ATOL + LM_RTOL * lg.amax(-1).abs()).all()),
            "generate: a greedy token is not the argmax of forward_lm's logits")
    result["runs"]["generate/fp32"] = dict(ms=dt * 1e3, tok_s=LM_BATCH * steps / dt, gap=gap, launches=dict(ck.LAUNCHES))

    # the standalone ReLU: the unfused conv1 -> relu sequence, bitwise the conv's fused ReLU
    for pol, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        g = torch.Generator(device="cuda").manual_seed(2029)
        x = torch.rand((BATCH, 227, 227, 3), generator=g, device="cuda").to(dtype)
        w = ((torch.rand((11, 11, 3, 96), generator=g, device="cuda") - 0.5) * (2 / 363**0.5)).to(dtype)
        b = ((torch.rand((96,), generator=g, device="cuda") - 0.5) * 0.2).to(dtype)
        ck.reset_launches()
        y = ck.relu(ck.conv2d_bias_relu(x, w, b, stride=4, padding=0, relu=False))
        torch.cuda.synchronize()
        launches = dict(ck.LAUNCHES)
        same = torch.equal(y, ck.conv2d_bias_relu(x, w, b, stride=4, padding=0))
        name = f"unfused conv1 -> relu/{pol}"
        log(f"path {name}: launches conv2d={launches['conv2d']} relu={launches['relu']}; bitwise the fused conv: {same}")
        require(launches == _launches(conv2d=1, relu=1) and same, f"{name}: {launches}, same={same}")
        result["runs"][name] = dict(launches=launches, passes=1)
    return result


def run_lm_cli(argv) -> dict:
    """``examples.lm.main`` with the launch counts set to 0 just before and
    read just after; its contract lines parsed, every verdict PASSED."""
    from cuda_mpi_gpu_cluster_programming_tpu_torch.examples import lm
    from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import cuda_kernels as ck

    buf = io.StringIO()
    ck.reset_launches()
    with contextlib.redirect_stdout(buf):
        rc = lm.main(argv)
    launches = dict(ck.LAUNCHES)
    out = buf.getvalue()
    require(rc == 0, f"examples.lm {argv} returned {rc}:\n{out}")
    require(re.search(r"^--- Byte-LM training \[", out, re.M) is not None, f"no banner:\n{out}")
    m = re.search(r"^Training completed in ([0-9.]+) ms \((\d+) tok/s\)$", out, re.M)
    verdict = re.search(r"^Verification: loss (\S+) -> (\S+) .* -> (PASSED|FAILED)$", out, re.M)
    gen_ok = re.search(r"^Generation continuation: (PASSED|FAILED)$", out, re.M)
    steps = int(re.search(r"^Step \d+/(\d+): loss = ", out, re.M).group(1))
    require(m is not None and verdict is not None and verdict.group(3) == "PASSED", f"examples.lm {argv}:\n{out}")
    require(gen_ok is not None and gen_ok.group(1) == "PASSED", f"examples.lm {argv}: generation\n{out}")
    return dict(ms=float(m.group(1)), tok_s=int(m.group(2)), loss_first=float(verdict.group(1)),
                loss_last=float(verdict.group(2)), steps=steps, launches=launches, passes=steps, stdout=out)


# the kernels a pool_ab run launches: s2d128's pack and pool, the phases strategies' pack and pool, sep2's pool
AB_KERNELS = ("s2d_pool_pack", "maxpool_s2d", "pool_phases_pack", "maxpool_phases", "maxpool2d")


def pool_ab_phase() -> dict:
    """Phase 3d: the pool A/B, ``pool_ab.main`` at batch 128 for pool1 and
    pool2 in fp32 and bf16, the launch counts set to 0 just before each run
    and read just after: exit 0, six rows in the JAX script's order, no
    ``mismatch`` and no ``error`` (every compared strategy bitwise
    ``F.max_pool2d``), and s2d_pool_pack, maxpool_s2d, pool_phases_pack,
    maxpool_phases and maxpool2d launched. Then one ``s2d128`` call launches
    s2d_pool_pack and maxpool_s2d once each."""
    from cuda_mpi_gpu_cluster_programming_tpu_torch import pool_ab
    from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import cuda_kernels as ck

    order = ["xla", "current", "phases", "s2d128", "sep2", "sep2p"]
    result = {"runs": {}}
    for pol in ("fp32", "bf16"):
        for pool in POOL_AB_SHAPES:
            argv = ["--pool", pool, "--dtype", pol, "--batch", str(BATCH)]
            buf = io.StringIO()
            ck.reset_launches()
            with contextlib.redirect_stdout(buf):
                rc = pool_ab.main(argv)
            launches = dict(ck.LAUNCHES)
            rows = [json.loads(line) for line in buf.getvalue().splitlines()]
            name = f"pool_ab --pool {pool}/{pol}"
            log(f"path {name}: rc={rc} " + " ".join(
                f"{r['strategy']}={r.get('ms_per_pass', r.get('error'))}{' MISMATCH' if r.get('mismatch') else ''}"
                for r in rows) + "; launches " + " ".join(f"{k}={launches[k]}" for k in AB_KERNELS))
            require(rc == 0, f"{name} returned {rc}: {rows}")
            require([r["strategy"] for r in rows] == order, f"{name}: strategies {rows}")
            require(not any("mismatch" in r or "error" in r for r in rows), f"{name}: {rows}")
            require(all(launches[k] > 0 for k in AB_KERNELS), f"{name}: launches {launches}")
            result["runs"][name] = dict(rc=rc, rows=rows, launches=launches)
    (h, w, c) = POOL_AB_SHAPES["pool2"]
    x = torch.randn((2, h, w, c), device="cuda")
    ck.reset_launches()
    pool_ab.strategies(x, 3, 2)["s2d128"]()
    require(ck.LAUNCHES == _launches(s2d_pool_pack=1, maxpool_s2d=1), f"one s2d128 call: launches {ck.LAUNCHES}")
    ck.reset_launches()
    return result


PROFILED_STEPS = 3
# kernel-name markers of the groups a training step's device time is split into
STEP_GROUPS = (("flash_fwd", ("flash_fwd_kernel",)), ("flash_dq", ("flash_dq_kernel",)),
               ("flash_dkv", ("flash_dkv_kernel",)), ("matmul (cuBLAS)", ("gemm", "cutlass", "sm90_xmma", "nvjet")))


def profile_steps(step, params, state, toks) -> dict:
    """Device time of a training step by kernel group, from ``torch.profiler``
    over ``PROFILED_STEPS`` steps after two warm ones: each group's ms a step,
    the device's busy ms (the sum over kernels and copies) against the host's
    wall ms a step, the idle share 1 - busy / wall, and the 8 costliest
    kernels by name. A trace that shows no device time leaves them None
    (not measured)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        params, state, _ = step(params, state, toks)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILED_STEPS):
            params, state, _ = step(params, state, toks)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / PROFILED_STEPS
    groups = {name: 0.0 for name, _ in STEP_GROUPS}
    groups["other kernels and copies"] = 0.0
    by_kernel = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = e.self_device_time_total / 1e3 / PROFILED_STEPS
        name = next((g for g, marks in STEP_GROUPS if any(m in e.key for m in marks)), "other kernels and copies")
        groups[name] += ms
        by_kernel[e.key[:80]] = by_kernel.get(e.key[:80], 0.0) + ms
    busy = sum(groups.values())
    if busy <= 0:
        return dict(wall_ms=wall, busy_ms=None, idle_share=None, groups=None, top=None)
    top = dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8])
    return dict(wall_ms=wall, busy_ms=busy, idle_share=1 - busy / wall, groups=groups, top=top)


def train_path_phase() -> dict:
    """Phase 3c: the LM's training on the card, at TINY_LM, batch 8 x 1025
    tokens (1024 predicted positions), launch counts set to 0 just before
    each run and read just after.

    In fp32 and in bf16 mixed precision (fp32 masters): one
    ``make_lm_train_step`` step with flash attention and one with the
    reference, the gradients caught on their way to the optimizer: the
    losses within ``TRAIN_LOSS_RTOL``, every gradient leaf within
    ``TRAIN_GRAD_REL`` x its max |grad|, flash_fwd, flash_dq and flash_dkv 2
    launches each in the flash step (one a layer) and none in the
    reference's; the counts again for ``accum_steps=2`` (each x 2) and for
    ``remat`` (flash_fwd 4: the backward runs each block's forward again);
    ms per step and tok/s for both attentions, with a ``torch.profiler``
    split of a step's device time (:func:`profile_steps`). Then ``examples.lm.main`` at
    its defaults with ``--attn flash --generate 16``, in fp32 and with
    ``--compute bf16``: every line PASSED, 2 launches of each kernel a step."""
    from cuda_mpi_gpu_cluster_programming_tpu_torch.models import transformer as tf
    from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import cuda_kernels as ck
    from cuda_mpi_gpu_cluster_programming_tpu_torch.utils.optim import adam
    from cuda_mpi_gpu_cluster_programming_tpu_torch.utils.tree import tree_leaves

    cfg = tf.TINY_LM
    flash_cfg = dataclasses.replace(cfg, attn_impl="flash")
    gen = torch.Generator().manual_seed(2032)
    params = tf.init_transformer(cfg, generator=gen, device="cuda")
    toks = torch.randint(0, cfg.vocab, (LM_BATCH, cfg.max_len + 1), generator=gen).cuda()
    n_tok = LM_BATCH * cfg.max_len
    per_layer = cfg.n_layers
    result = {"runs": {}}
    for pol, cdt in (("fp32", None), ("bf16", torch.bfloat16)):
        caught, losses = {}, {}
        for impl, c in (("flash", flash_cfg), ("reference", cfg)):
            init, update = adam(1e-3)

            def spy(grads, state, p=None, impl=impl, update=update):
                caught[impl] = grads
                return update(grads, state, p)

            _, step = tf.make_lm_train_step(c, optimizer=(init, spy), compute_dtype=cdt)
            state = init(params)
            ck.reset_launches()
            new, _, loss = step(params, state, toks)
            torch.cuda.synchronize()
            launches = dict(ck.LAUNCHES)
            want = (_launches(flash_fwd=per_layer, flash_dq=per_layer, flash_dkv=per_layer) if impl == "flash"
                    else _launches())
            name = f"make_lm_train_step {impl}/{pol}"
            require(launches == want, f"{name}: launches {launches}, want {want}")
            require(np.isfinite(float(loss)) and all(bool(torch.isfinite(t).all()) for t in tree_leaves(new)),
                    f"{name}: non-finite loss or params")
            require(all(t.dtype == torch.float32 for t in tree_leaves(new)), f"{name}: masters left fp32")
            losses[impl] = float(loss)
            p_run, s_run = params, init(params)

            def one_step(step=step):
                nonlocal p_run, s_run
                p_run, s_run, _ = step(p_run, s_run, toks)

            ms = gpu_time_ms(one_step, reps=TRAIN_STEPS_TIMED, warmup=2)
            prof = profile_steps(step, params, init(params), toks)
            log(f"path {name}: {ms:.4f} ms a step ({n_tok / ms * 1e3:.0f} tok/s) loss {float(loss):.6f} "
                f"launches flash_fwd={launches['flash_fwd']} flash_dq={launches['flash_dq']} "
                f"flash_dkv={launches['flash_dkv']}")
            busy = "not measured" if prof["busy_ms"] is None else (
                f"device busy {prof['busy_ms']:.4f} ms, idle share {prof['idle_share']:.3f}; "
                + ", ".join(f"{g} {t:.4f}" for g, t in prof["groups"].items()))
            log(f"  profile {name}: host {prof['wall_ms']:.4f} ms a step; {busy}")
            result["runs"][name] = dict(ms=ms, tok_s=n_tok / ms * 1e3, loss=float(loss), launches=launches, passes=1,
                                        profile=prof)
            del p_run, s_run
        loss_err = abs(losses["flash"] - losses["reference"]) / abs(losses["reference"])
        grad_errs = [float((a.float() - b.float()).abs().max()) / float(b.float().abs().max().clamp_min(1e-30))
                     for a, b in zip(tree_leaves(caught["flash"]), tree_leaves(caught["reference"]))]
        ok = loss_err <= TRAIN_LOSS_RTOL[pol] and max(grad_errs) <= TRAIN_GRAD_REL[pol]
        log(f"train step flash vs reference {pol}: loss rel {loss_err:.3g} (tol {TRAIN_LOSS_RTOL[pol]:g}); "
            f"largest gradient gap {max(grad_errs):.3g} of its leaf's max |grad| (tol {TRAIN_GRAD_REL[pol]:g}) ok={ok}")
        require(ok, f"train step flash vs reference {pol}: loss rel {loss_err}, grad gaps {grad_errs}")
        result[f"flash_vs_reference/{pol}"] = dict(loss_rel=loss_err, grad_rel=max(grad_errs), losses=losses)
        for what, c, accum, per in (
            # launches per layer: two microbatches; with remat the backward runs the block's forward again
            ("accum_steps=2", flash_cfg, 2, dict(flash_fwd=2, flash_dq=2, flash_dkv=2)),
            ("remat", dataclasses.replace(flash_cfg, remat=True), 1, dict(flash_fwd=2, flash_dq=1, flash_dkv=1)),
        ):
            init, step = tf.make_lm_train_step(c, accum_steps=accum, compute_dtype=cdt)
            state = init(params)
            ck.reset_launches()
            _, _, loss = step(params, state, toks)
            torch.cuda.synchronize()
            launches = dict(ck.LAUNCHES)
            want = _launches(**{k: n * per_layer for k, n in per.items()})
            name = f"make_lm_train_step flash {what}/{pol}"
            log(f"path {name}: loss {float(loss):.6f} (accum 1: {losses['flash']:.6f}) launches "
                f"flash_fwd={launches['flash_fwd']} flash_dq={launches['flash_dq']} flash_dkv={launches['flash_dkv']}")
            require(launches == want, f"{name}: launches {launches}, want {want}")
            require(abs(float(loss) - losses["flash"]) <= TRAIN_LOSS_RTOL[pol] * abs(losses["flash"]),
                    f"{name}: loss {float(loss)} vs {losses['flash']}")
            result["runs"][name] = dict(loss=float(loss), launches=launches, passes=1)
    for pol in ("fp32", "bf16"):
        r = run_lm_cli(["--attn", "flash", "--generate", "16"] + (["--compute", "bf16"] if pol == "bf16" else []))
        name = f"examples.lm --attn flash/{pol}"
        want = _launches(flash_fwd=per_layer * r["steps"], flash_dq=per_layer * r["steps"],
                         flash_dkv=per_layer * r["steps"])
        log(f"path {name}: {r['ms']:.1f} ms for {r['steps']} steps ({r['tok_s']} tok/s) loss {r['loss_first']:.4f} -> "
            f"{r['loss_last']:.4f}; launches flash_fwd={r['launches']['flash_fwd']} "
            f"flash_dq={r['launches']['flash_dq']} flash_dkv={r['launches']['flash_dkv']}; PASSED, generation PASSED")
        require(r["launches"] == want, f"{name}: launches {r['launches']}, want {want}")
        result["runs"][name] = r
    return result


def lm_kernels_entries(rows, runs) -> list:
    """The ``kernels`` line's entries of the LM slices: relu per dtype (its
    run: the unfused conv1 -> relu sequence; no path calls it), flash_fwd
    per dtype at long_context's shape (its run: ``long_context --strategy
    flash``) and at TINY_LM's (its run: ``forward_lm`` with flash), and
    flash_dq and flash_dkv per dtype at TINY_LM's (its run: one
    ``make_lm_train_step`` step with flash; launches per forward are per
    step). Times are the causal rows'; the full-attention rows go under
    ``modes``."""
    plan = [("relu", pol, "conv1 out", f"unfused conv1 -> relu/{pol}") for pol in ("fp32", "bf16")]
    plan += [("flash_fwd", pol, "long_context", f"long_context --strategy flash/{pol}") for pol in ("fp32", "bf16")]
    plan += [("flash_fwd", pol, "tiny_lm", f"forward_lm flash/{pol}") for pol in ("fp32", "bf16")]
    plan += [(name, pol, "tiny_lm", f"make_lm_train_step flash/{pol}")
             for name in ("flash_dq", "flash_dkv") for pol in ("fp32", "bf16")]
    keys = ("ms", "device_ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "max_abs_err", "max_rel_err", "tol")
    entries = []
    for name, pol, stage, run_key in plan:
        mine = [r for r in rows if r["kernel"] == name and r["dtype"] == pol and r["stage"] == stage]
        (row,) = [r for r in mine if not r.get("mode")]
        run = runs[run_key]
        source, replaces = LM_KERNELS[name]
        entry = dict(
            name=name, dtype=pol, route="cuda", source=source, replaces=replaces, run=run_key, stage=stage,
            launches=run["launches"][name], launches_per_forward=run["launches"][name] / run["passes"],
            max_abs_err=max(r["max_abs_err"] for r in mine), within_tolerance=all(r["ok"] for r in mine),
            ms=row["ms"], kernel_ms=row["ms"], device_ms=row.get("device_ms"), plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"], library_call=row["library_call"],
        )
        if "shape" in row:
            entry["shape"] = row["shape"]
        modes = [r for r in mine if r.get("mode")]
        if modes:
            entry["modes"] = {r["mode"]: {k: r.get(k) for k in keys} for r in modes}
        entries.append(entry)
    return entries


def s2d_kernels_entries(rows, runs) -> list:
    """The ``kernels`` line's s2d_pool_pack and maxpool_s2d entries, one per
    dtype: their run is ``pool_ab`` (``--pool pool1`` and ``--pool pool2``;
    launches summed over the two), their stages pool1 and pool2. The pool's
    ``ms`` is the wrapper's (its pack included), ``kernel_ms`` the kernel
    alone on the packed operand; times and bounds summed over the stages."""
    keys = ("ms", "kernel_ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "kernel_bound_ms", "pack_ms",
            "device_ms", "library_device_ms", "wrapper_device_ms", "max_abs_err", "tol", "operand_shape")
    entries = []
    for name, (source, replaces) in S2D_KERNELS.items():
        for pol in ("fp32", "bf16"):
            mine = [r for r in rows if r["kernel"] == name and r["dtype"] == pol]
            require([r["stage"] for r in mine] == list(POOL_AB_SHAPES), f"{name} {pol}: stages {mine}")
            launches = {pool: runs[f"pool_ab --pool {pool}/{pol}"]["launches"][name] for pool in POOL_AB_SHAPES}
            lib, dev = [r["library_ms"] for r in mine], [r.get("device_ms") for r in mine]
            entries.append(dict(
                name=name, dtype=pol, route="cuda", source=source, replaces=replaces,
                run=f"pool_ab --pool pool1/pool2 --dtype {pol}", launches=sum(launches.values()),
                launches_by_run=launches, launches_per_s2d128_call=1,
                max_abs_err=max(r["max_abs_err"] for r in mine), within_tolerance=all(r["ok"] for r in mine),
                ms=sum(r["ms"] for r in mine), kernel_ms=sum(r.get("kernel_ms", r["ms"]) for r in mine),
                device_ms=None if None in dev else sum(dev),  # the kernel alone by torch.profiler
                plain_ms=sum(r["plain_ms"] for r in mine), bound_ms=sum(r["bound_ms"] for r in mine),
                bound_by=max(mine, key=lambda r: r["bound_ms"])["bound_by"],
                library_ms=None if None in lib else sum(lib), library_call=mine[0]["library_call"],
                stages={r["stage"]: {k: r[k] for k in keys if k in r} for r in mine},
            ))
    return entries


# what a stage of the kernels line carries beside ``keys`` where its row has it
STAGE_EXTRAS = ("staged_ms", "cudnn_chain_ms", "kernel_ms", "kernel_bound_ms", "pack_ms", "pack_bound_ms",
                "device_ms", "library_device_ms", "wrapper_device_ms")


def kernels_line(rows, runs) -> dict:
    """One entry per (kernel, dtype): times summed over the kernel's stages
    in one forward of its route; launches from that dtype's main-path run
    of the route that launches the kernel (staged, a variant's, or fused for
    conv_block). A kernel's other modes (hpool, k_block, the W stage) are
    listed under ``modes``, outside the sums."""
    name, source, replaces, stages = BLOCK_KERNEL
    table = [(k, src, rep, st, pol, f"v3_pallas{route}/{pol}")
             for k, (src, rep, st, route) in KERNELS.items() for pol in ("fp32", "bf16")]
    table += [(name, source, replaces, stages, pol, f"v3_pallas+FUSE=block/{pol}") for pol in ("fp32", "bf16", "int8w")]
    entries = []
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "max_abs_err", "max_rel_err", "tol")
    for name, source, replaces, stages, pol, run_key in table:
        every = [r for r in rows if r["kernel"] == name and r["dtype"] == pol]
        mine = [r for r in every if not r.get("mode")]
        modes = [r for r in every if r.get("mode")]
        require([r["stage"] for r in mine] == list(stages), f"{name} {pol}: stages {mine}")
        run = runs[run_key]
        ms = sum(r["ms"] for r in mine)
        block = name == "conv_block"
        device = [r.get("device_ms") for r in mine]
        entry = dict(
            name=name, dtype=pol, route="cuda", source=source, replaces=replaces, run=run_key,
            launches=run["launches"][name], launches_per_forward=run["launches"][name] / run["passes"],
            max_abs_err=max(r["max_abs_err"] for r in every), within_tolerance=all(r["ok"] for r in every),
            # the wrapper's time (packing included); kernel_ms: the kernel alone where a row timed it
            ms=ms, kernel_ms=sum(r.get("kernel_ms", r["ms"]) for r in mine),
            # the kernel alone by torch.profiler, where the rows read it (None: not measured)
            **(dict(device_ms=None if None in device else sum(device)) if "device_ms" in mine[0] else {}),
            plain_ms=sum(r["plain_ms"] for r in mine),
            bound_ms=sum(r["bound_ms"] for r in mine),
            # the stages' bounds add up; the label is the larger stage's
            bound_by=max(mine, key=lambda r: r["bound_ms"])["bound_by"],
            # no one library call computes a fused block or a pack: the cuDNN chain's time is a note beside a block
            library_ms=None if block or mine[0]["library_ms"] is None else sum(r["library_ms"] for r in mine),
            **(dict(staged_chain_ms=sum(r["staged_ms"] for r in mine),
                    cudnn_chain_ms_note=sum(r["cudnn_chain_ms"] for r in mine)) if block else {}),
            stages={r["stage"]: {k: r[k] for k in keys + STAGE_EXTRAS if k in r} for r in mine},
        )
        if modes:
            entry["modes"] = {f"{r['mode']} @ {r['stage']}": {
                k: r[k] for k in keys + (("device_ms", "library_device_ms") if "device_ms" in r else ())}
                for r in modes}
        entries.append(entry)
    return {"kernels": entries}


# full AlexNet's kernels: name -> (the stages of one v6_full_pallas forward it runs, the route's knobs)
V6_KERNELS = {"conv2d": (("conv1", "conv2", "conv3", "conv4", "conv5"), ""),
              "maxpool2d": (("pool1", "pool2", "pool5"), ""), "lrn": (("lrn2",), ""),
              "conv_block": (("block1", "block2", "block5"), "+FUSE=block")}


def v6_kernels_entries(rows, runs) -> list:
    """The ``kernels`` line's entries of full AlexNet, one per (kernel,
    dtype): times summed over the kernel's stages in one ``v6_full_pallas``
    forward (Blocks 1-2's rows at the same shapes, then conv3..pool5's and
    block 5's), launches from that dtype's v6 run; conv5's hpool mode and
    pool5's W stage go under ``modes``."""
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "max_abs_err", "max_rel_err", "tol")
    entries = []
    for name, (stages, route) in V6_KERNELS.items():
        source, replaces = (BLOCK_KERNEL[1], BLOCK_KERNEL[2]) if name == "conv_block" else KERNELS[name][:2]
        for pol in ("fp32", "bf16"):
            every = [r for r in rows if r["kernel"] == name and r["dtype"] == pol and r["stage"] in stages]
            mine = [r for r in every if not r.get("mode")]
            modes = [r for r in every if r.get("mode") and r["stage"] in ("conv5", "pool5")]
            require([r["stage"] for r in mine] == list(stages), f"v6 {name} {pol}: stages {[r['stage'] for r in mine]}")
            run_key = f"v6_full_pallas{route}/{pol}"
            run = runs[run_key]
            block = name == "conv_block"
            entry = dict(
                name=name, dtype=pol, route="cuda", source=source, replaces=replaces, model="alexnet_full",
                run=run_key, launches=run["launches"][name],
                launches_per_forward=run["launches"][name] / run["passes"],
                max_abs_err=max(r["max_abs_err"] for r in every), within_tolerance=all(r["ok"] for r in every),
                ms=sum(r["ms"] for r in mine), plain_ms=sum(r["plain_ms"] for r in mine),
                bound_ms=sum(r["bound_ms"] for r in mine), bound_by=max(mine, key=lambda r: r["bound_ms"])["bound_by"],
                library_ms=None if block else sum(r["library_ms"] for r in mine),
                **(dict(staged_chain_ms=sum(r["staged_ms"] for r in mine),
                        cudnn_chain_ms_note=sum(r["cudnn_chain_ms"] for r in mine)) if block else {}),
                stages={r["stage"]: {k: r[k] for k in keys + STAGE_EXTRAS if k in r} for r in mine},
            )
            if modes:
                entry["modes"] = {f"{r['mode']} @ {r['stage']}": {k: r[k] for k in keys if k in r} for r in modes}
            entries.append(entry)
    return entries


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

    def peak_name(p):
        return f"fp32 {spec.fp32_tflops} TFLOP/s" if p == "fp32" else f"bf16 {spec.bf16_tflops} TFLOP/s (tensor cores)"

    if sys.argv[1:] == ["--flash-rows"]:
        # phase 2's flash rows (flash_fwd, flash_dq, flash_dkv at long_context's and TINY_LM's shapes, causal
        # and full, and at D = 256 and 512 causal) and relu rows, phases 3b and 3c, and the staged v3_pallas
        # passes in fp32 and bf16, from this checkout: two trees compared in one call
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        rows = lm_kernel_phase(spec, peak_name) + lm_bwd_kernel_phase(spec, peak_name)
        lm, train = lm_path_phase(), train_path_phase()
        runs = {run_name(key, pol, knobs): {k: v for k, v in drive(key, pol, knobs, per_forward).items()
                                            if k != "stdout"}
                for key, pol, knobs, per_forward in MAIN_RUNS[:2]}
        print(json.dumps(dict(device=kind, nvidia_smi=smi, rows=rows, lm=lm, train=train, runs=runs), default=str),
              flush=True)
        return 0
    if sys.argv[1:] == ["--pool-rows"]:
        # phase 2's pool rows (maxpool2d at pool1, pool2 and the W stages, maxpool_phases, maxpool_s2d) and lrn
        # rows, then the staged v3_pallas, v3_pallas+POOL=phases and v1_jit passes, from this checkout: two
        # trees compared in one call
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        rows, runs = pool_rows(spec, peak_name), {}
        for key, pol, knobs, per_forward in MAIN_RUNS:
            if knobs in ({}, {"POOL": "phases"}) and pol in ("fp32", "bf16"):
                runs[run_name(key, pol, knobs)] = {k: v for k, v in drive(key, pol, knobs, per_forward).items()
                                                   if k != "stdout"}
        print(json.dumps(dict(device=kind, nvidia_smi=smi, rows=rows, runs=runs), default=str), flush=True)
        return 0
    if sys.argv[1:] == ["--control"]:
        # phase 3g alone (its gate's two rounds from one quick measure call), from this checkout
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        control = control_phase(spec, peak_name)
        print(json.dumps(dict(device=kind, nvidia_smi=smi, control=control,
                              kernels=control_kernels_entries(control)), default=str), flush=True)
        return 0
    if sys.argv[1:] == ["--record"]:
        # the records MAINLOOP_PTXAS, FLASH_SWEEP_SHA256, FLASH_BWD_TILES_SHA256, FLASH_BWD_WIDE_SHA256,
        # FLASH_FWD_TILES_SHA256, FLASH_FWD_WIDE_SHA256, ENGINE_FP32_SHA256 and POOL_LRN_SHA256 hold a later tree
        # to, from this checkout
        torch.backends.cuda.matmul.allow_tf32 = False
        sweep = head_dim_sweep()
        tiles = flash_bwd_tiles_digest()
        wide = flash_bwd_wide_digest()
        fwd_tiles = flash_fwd_digest(FLASH_BWD_TILE_SHAPES, 2000, FLASH_FWD_TILES_SHA256)
        fwd_wide = flash_fwd_digest(FLASH_BWD_WIDE_SHAPES, 4000, FLASH_FWD_WIDE_SHA256)
        engine = engine_fp32_digest()
        pool_lrn = pool_lrn_digest()
        ptxas = {k: v for k, v in ptxas_table(info.log).items() if k.split("/")[0] in PTXAS_HELD}
        print(json.dumps(dict(device=kind, nvidia_smi=smi, ptxas=ptxas, flash_sweep_sha256=sweep["sha256"],
                              flash_sweep_within_tolerance=not sweep["failing_head_dims"],
                              flash_bwd_tiles_sha256=tiles["sha256"], flash_bwd_wide_sha256=wide["sha256"],
                              flash_fwd_tiles_sha256=fwd_tiles["sha256"], flash_fwd_wide_sha256=fwd_wide["sha256"],
                              engine_fp32_sha256=engine["sha256"], engine_fp32_items=engine["items"],
                              pool_lrn_sha256=pool_lrn["sha256"], pool_lrn_items=pool_lrn["items"])), flush=True)
        return 0
    for line in info.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")
    ptxas = ptxas_phase(info)
    flash_regs = flash_ptxas(info.log)
    for key, v in flash_regs.items():
        log(f"ptxas {key}: {v['registers']} registers, {v['spill_stores']} bytes spill stores ({v['kernel']})")
    sass = sass_phase(info)
    log("phase 1b: the bf16 and int8w conv entry points and the bf16 flash instances contain HMMA (at D >= 256 "
        "with fewer FFMA than HMMA), the fp32 ones FFMA and no HMMA; "
        f"{', '.join(PTXAS_HELD)} keep their registers and spills")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = kernel_phase(spec, peak_name) + variant_phase(spec, peak_name) + block_phase(spec, peak_name)
    v6_rows = v6_kernel_phase(spec, peak_name)
    lm_rows = lm_kernel_phase(spec, peak_name) + lm_bwd_kernel_phase(spec, peak_name)
    s2d_rows = s2d_phase(spec, peak_name)
    edges = (edge_phase() + pool_lrn_edge_phase() + block_edge_phase() + s2d_edge_phase() + lm_edge_phase()
             + lm_bwd_edge_phase())
    engine = engine_fp32_digest()
    log(f"engine fp32 bits: taps and g8 hash to {engine['sha256']} (ENGINE_FP32_SHA256 {ENGINE_FP32_SHA256})")
    require(engine["sha256"] == ENGINE_FP32_SHA256, f"fp32 taps or g8 bits moved: {engine['items']}")
    pool_lrn = pool_lrn_digest()
    log(f"pool and LRN bits: maxpool2d, its W stage and lrn hash to {pool_lrn['sha256']} "
        f"(POOL_LRN_SHA256 {POOL_LRN_SHA256})")
    require(pool_lrn["sha256"] == POOL_LRN_SHA256, f"pool or LRN bits moved: {pool_lrn['items']}")
    log("phase 2: every kernel agrees with its plain version, at the main path's shapes and off it; "
        "fp32 taps and g8 keep the bits of ENGINE_FP32_SHA256, the pools and LRN those of POOL_LRN_SHA256")
    main = main_path_phase()
    log("phase 3: main path ran through the kernels, golden and budgets hold")
    v6 = v6_path_phase()
    log("phase 3: full AlexNet ran through the kernels on every route, within budget of v6_full_jit; "
        "--save-params/--params, --input native, --trace and the chaos drill held")
    lm = lm_path_phase()
    log("phase 3b: long_context and the LM's forward, loss, decode and generation ran through flash_fwd")
    train = train_path_phase()
    log("phase 3c: the LM's training step and examples.lm ran through flash_fwd, flash_dq and flash_dkv")
    ab = pool_ab_phase()
    log("phase 3d: pool_ab ran every strategy through its kernel, each bitwise F.max_pool2d")
    bench = bench_phase(main["runs"])
    log("phase 3e: the bench printed every row to its contract; run --breakdown and --profile ran")
    serve = serve_phase(spec, peak_name)
    log("phase 3f: the service replayed a CUDA graph per bucket (conv2d 2, maxpool2d 2, lrn 1 a dispatch), each "
        "result bitwise its eager forward and within budget; no cache miss; bench serve/saturate and run --serve ran")
    control = control_phase(spec, peak_name, bench["raw_rows"], serve.pop("bf16_served"))
    log("phase 3g: the controller walked the ladder down and back, every rung's graphs (recaptured at int8w and "
        "back) bitwise their eager forward, launches = nodes x dispatches, no cache miss; a neutral replay of a "
        "card journal held; bench replay, gate and control ran")
    tune = tune_phase()
    log("phase 4: the tuner swept every dtype with no failed candidate, then hit its cache")
    v6_tune = v6_tune_phase()
    log("phase 4: the v6 tuner swept five conv layers with no failed candidate, then hit its cache")
    line = kernels_line(rows, main["runs"])
    line["kernels"] += v6_kernels_entries(rows + v6_rows, v6["runs"])
    line["kernels"] += lm_kernels_entries(lm_rows, {**lm["runs"], **train["runs"]})
    line["kernels"] += s2d_kernels_entries(s2d_rows, ab["runs"])
    line["kernels"] += serve_kernels_entries(serve)
    line["kernels"] += control_kernels_entries(control)

    out_dir = Path("chip_smoke_out")
    out_dir.mkdir(exist_ok=True)
    # a diagnostic dump for the reader, never read back: a torn file costs nothing
    (out_dir / "chip_smoke.json").write_text(json.dumps(  # noqa: atomic-write
        dict(device=kind, nvidia_smi=smi, spec=spec.name, build_s=info.seconds, build_log=info.log, ptxas=ptxas,
             flash_ptxas=flash_regs, sass=sass, engine_fp32=engine, pool_lrn=pool_lrn,
             cudnn_kernels=CUDNN_KERNELS, stages=rows + v6_rows + lm_rows + s2d_rows, edge_cases=edges, main_path=main,
             v6_path=v6, lm_path=lm, train_path=train, pool_ab=ab, bench=bench, serve=serve, control=control, tune=tune,
             v6_tune=v6_tune,
             kernels=line["kernels"]), indent=1,
        default=str))
    print(json.dumps(line), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
