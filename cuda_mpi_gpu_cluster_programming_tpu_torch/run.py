"""CLI runner for the port: one single-device Blocks 1-2 configuration.

    python -m cuda_mpi_gpu_cluster_programming_tpu_torch.run --config v3_pallas --batch 128

Runs on the GPU unless ``--device cpu`` is given; with no CUDA device and
no ``--device cpu`` it raises. Prints the JAX package's stdout contract
(``Precision:``, ``Compile time:``, ``Final Output Shape:``, ``Final Output
(first 10 values):``, ``... completed in X ms``, ``Timing stats:``), which
the harness regexes read.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import torch

from .precision.policy import POLICY_NAMES


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", default="v1_jit", help="execution config key (see --list-configs)")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--init", choices=["deterministic", "random"], default="deterministic")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--repeats", type=int, default=10, help="fenced passes for amortized timing")
    p.add_argument("--warmup", type=int, default=5, help="short-chain passes subtracted by the estimator")
    p.add_argument("--compute", choices=["fp32", "bf16"], default="fp32",
                   help="precision policy (legacy spelling; --dtype supersedes it)")
    p.add_argument("--dtype", choices=POLICY_NAMES, default="",
                   help="precision policy: fp32, bf16, or int8w (per-channel int8 weights)")
    p.add_argument("--height", type=int, default=227)
    p.add_argument("--width", type=int, default=227)
    p.add_argument("--lrn-form", choices=["cuda", "cpu"], default="cuda",
                   help="LRN alpha convention: cuda = alpha*sum (golden), cpu = alpha*sum/size")
    p.add_argument("--list-configs", action="store_true")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return p


def main(argv=None) -> int:
    args = make_parser().parse_args(argv)

    from .configs import REGISTRY, build_forward, resolve_device
    from .models.alexnet import BLOCKS12
    from .models.init import (
        deterministic_input,
        init_params_deterministic,
        init_params_random,
        random_input,
    )
    from .ops import cuda_kernels
    from .utils.timing import amortized_stats, fence

    if args.list_configs:
        for c in REGISTRY.values():
            print(f"{c.key:18s} {c.version_name:22s} {c.description}")
        return 0
    if args.config not in REGISTRY:
        print(f"unknown config {args.config!r}; try --list-configs", file=sys.stderr)
        return 2
    exec_cfg = REGISTRY[args.config]
    device = resolve_device(args.device)

    model_cfg = dataclasses.replace(
        BLOCKS12,
        in_height=args.height,
        in_width=args.width,
        lrn2=dataclasses.replace(BLOCKS12.lrn2, alpha_over_size=(args.lrn_form == "cpu")),
    )
    label = "GPU" if device.type == "cuda" else "CPU"
    dev_name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"--- AlexNet {label} {exec_cfg.version_name} [{exec_cfg.key}] (batch={args.batch}) ---")
    print(f"Devices: 1 x {dev_name} ({device.type})")

    run_dtype = args.dtype or args.compute
    source = "dtype" if args.dtype else "compute"
    print(f"Precision: dtype={run_dtype} source={source} gate={'ref' if run_dtype == 'fp32' else 'none'}")

    # One generator, params first and input second: --seed S reproduces both.
    gen = torch.Generator().manual_seed(args.seed)
    if args.init == "deterministic":
        params = init_params_deterministic(model_cfg, device=device)
        x = deterministic_input(args.batch, model_cfg, device=device)
    else:
        params = init_params_random(gen, model_cfg, device=device)
        x = random_input(gen, args.batch, model_cfg, device=device)

    try:
        fwd = build_forward(exec_cfg, model_cfg, policy=run_dtype, device=device)
    except (ValueError, NotImplementedError) as e:
        print(f"cannot build config {exec_cfg.key!r}: {e}", file=sys.stderr)
        return 2

    passes = 0

    def counted(p, xx):
        nonlocal passes
        passes += 1
        return fwd(p, xx)

    before = dict(cuda_kernels.LAUNCHES)
    t0 = time.perf_counter()
    counted(params, x)
    fence(device)
    compile_ms = (time.perf_counter() - t0) * 1e3  # first call: kernel build/load included

    n_small = max(1, args.warmup)
    st = amortized_stats(counted, params, x, n_small=n_small, n_large=n_small + max(1, args.repeats))
    out = counted(params, x).cpu().numpy()
    per_pass_ms = st.per_call_ms

    shape_str = "x".join(str(d) for d in out.shape[1:])
    first10 = " ".join(f"{v:.4f}" for v in out[0].reshape(-1)[:10])
    print(f"Compile time: {compile_ms:.1f} ms")
    print(f"Final Output Shape: {shape_str}")
    print(f"Final Output (first 10 values): {first10}")
    print(
        f"AlexNet {label} Forward Pass completed in {per_pass_ms:.3f} ms "
        f"(amortized over {args.repeats} fenced passes; "
        f"{args.batch / (per_pass_ms / 1e3):.1f} img/s)"
    )
    print(
        f"Timing stats: n={st.n_samples} ci95={st.ci95_ms:.4f} ms chain={st.n_chain}"
        + (" SHADOWED" if st.shadowed else "")
        + (" UNDERCONVERGED" if st.underconverged else "")
    )
    launches = " ".join(f"{k}={v - before[k]}" for k, v in cuda_kernels.LAUNCHES.items())
    print(f"Kernel launches: {launches} passes={passes}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
