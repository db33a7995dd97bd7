"""One rank of the distributed tier tests (``tests/test_torch_distributed_tiers.py``).

Run by ``parallel.distributed.launch_local`` as ``python -m
tests.torch_dist_tiers --out DIR --shards N``: the rank joins the gloo
group on the CPU, builds every AlexNet tier at ``SMALL`` (43x43, batch 2)
over the mesh across the ranks, runs each once with the collectives set to
0 just before and read just after, and writes ``rank<r>.json`` (its
counts, a forward each) and, on rank 0, ``outputs.npz`` (each tier's
output, keyed ``<config>/<dtype>``). ``--fail-rank R`` makes rank R raise
before its first collective instead, ``--hang-rank R`` makes it sleep.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from cuda_mpi_gpu_cluster_programming_tpu_torch import configs
from cuda_mpi_gpu_cluster_programming_tpu_torch.models import alexnet, init
from cuda_mpi_gpu_cluster_programming_tpu_torch.models.alexnet_full import AlexNetConfig, _param_shapes
from cuda_mpi_gpu_cluster_programming_tpu_torch.parallel import distributed, halo

SMALL = dataclasses.replace(alexnet.BLOCKS12, in_height=43, in_width=43)
RUNS = [(k, "fp32") for k in ("v2.1_replicated", "v2.2_sharded", "v4_hybrid", "v5_collective", "v7_tp",
                              "v6_full_sharded")] + [("v5_collective", "bf16"), ("v5_collective", "int8w")]


def numpy_case(seed=20, batch=2, hw=43):
    """``tests/test_torch_sharded.py``'s ``_numpy_case``: zero-mean weights,
    small biases and a uniform [0, 1) input, drawn with numpy."""
    rng = np.random.default_rng(seed)

    def w(*shape):
        fan_in = shape[0] * shape[1] * shape[2]
        return ((rng.random(shape, dtype=np.float32) - 0.5) * (4 / fan_in**0.5)).astype(np.float32)

    params = {"conv1": {"w": w(11, 11, 3, 96), "b": ((rng.random(96, dtype=np.float32) - 0.5) * 0.2)},
              "conv2": {"w": w(5, 5, 96, 256), "b": ((rng.random(256, dtype=np.float32) - 0.5) * 0.2)}}
    return params, rng.random((batch, hw, hw, 3), dtype=np.float32)


def full_case(seed=21, batch=2, hw=99):
    """Full AlexNet at 99x99 with ``tests/test_torch_sharded.py``'s narrow
    head (fc6 64, fc7 32, 10 classes): He-scaled params and the input, from
    numpy."""
    rng = np.random.default_rng(seed)
    cfg = AlexNetConfig(blocks12=dataclasses.replace(alexnet.BLOCKS12, in_height=hw, in_width=hw),
                        fc6=64, fc7=32, num_classes=10)
    params = {name: {"w": (rng.standard_normal(ws) * (2 / np.prod(ws[:-1])) ** 0.5).astype(np.float32),
                     "b": np.full(bs, 0.1, np.float32)} for name, (ws, bs) in _param_shapes(cfg).items()}
    return cfg, params, rng.random((batch, hw, hw, 3), dtype=np.float32)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--shards", type=int, required=True)
    p.add_argument("--fail-rank", type=int, default=-1)
    p.add_argument("--hang-rank", type=int, default=-1)
    args = p.parse_args(argv)
    distributed.maybe_initialize_from_env(device="cpu")
    rank = torch.distributed.get_rank()
    if rank == args.fail_rank:
        raise SystemExit(f"rank {rank} fails before its first collective")
    if rank == args.hang_rank:
        time.sleep(3600)
    params, x = numpy_case()
    fcfg, fparams, fx = full_case()
    counts, outs = {}, {}
    for key, dtype in RUNS:
        full = key == "v6_full_sharded"
        fwd = configs.build_forward(configs.REGISTRY[key], fcfg if full else SMALL, policy=dtype, device="cpu",
                                    n_shards=args.shards)
        p_np, x_np = (fparams, fx) if full else (params, x)
        halo.reset_collectives()
        out = fwd(init.params_from_jax(p_np, device="cpu"), torch.from_numpy(x_np.copy()))
        counts[f"{key}/{dtype}"] = dict(collectives=dict(halo.COLLECTIVES), wire=dict(halo.WIRE),
                                        output=out is not None)
        if out is not None:
            outs[f"{key}/{dtype}"] = out.numpy()
    with open(os.path.join(args.out, f"rank{rank}.json"), "w") as f:
        json.dump(counts, f)
    if rank == 0:
        np.savez(os.path.join(args.out, "outputs.npz"), **outs)
    torch.distributed.destroy_process_group()
    print(f"rank {rank}: {len(RUNS)} tiers ran", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
