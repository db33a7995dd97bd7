"""CLI: the Perfetto export, journal replay, the regression gate's report,
roofline attribution and the fleet-health report (the JAX package's
``python -m <package>.observability``).

    python -m cuda_mpi_gpu_cluster_programming_tpu_torch.observability \\
        export --journal logs/serve_journal.jsonl --out logs/trace.json
    python -m cuda_mpi_gpu_cluster_programming_tpu_torch.observability \\
        replay --journal logs/serve_journal.jsonl [--traffic-mult 2] [--devices 1] [--slo-scale 0.5] \\
        [--journal-out replay.jsonl] [--device cpu]
    python -m cuda_mpi_gpu_cluster_programming_tpu_torch.observability \\
        report [--fail-on-regression] [--json] BENCH_r*.json
    python -m cuda_mpi_gpu_cluster_programming_tpu_torch.observability \\
        roofline BENCH_r*.json                              # committed rows
    python -m cuda_mpi_gpu_cluster_programming_tpu_torch.observability \\
        roofline --live [--batch N] [--height H --width W] [--device cpu]   # measured now
    python -m cuda_mpi_gpu_cluster_programming_tpu_torch.observability \\
        health --journal logs/serve_journal.jsonl [--json] [--fail-on-budget-burn]

``export``, ``report`` and ``health`` only read journals and JSON rows and
touch no device. ``replay`` and ``roofline --live`` run on ``--device``
(CUDA unless the CPU is asked for).

Exit codes: 0 clean (trace exported, replay matched or a what-if ran, no
regression, roofline rendered, health rendered with budgets intact or no
gate asked for); 2 usage (a missing, empty or unreplayable journal, bad
arguments, no measurable roofline view, no GPU for a device subcommand);
3 a tripped gate (a regression with ``--fail-on-regression``, a neutral
replay that diverged from its record, a blown error budget with
``--fail-on-budget-burn``).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="cuda_mpi_gpu_cluster_programming_tpu_torch.observability")
    sub = p.add_subparsers(dest="cmd", required=True)
    ex = sub.add_parser("export", help="stitch span and journal records into a Perfetto-loadable Chrome trace JSON")
    ex.add_argument("--journal", required=True,
                    help="a journal .jsonl file, or a directory whose *.jsonl files are stitched together")
    ex.add_argument("--out", default="", help="output trace path (default: <journal>.trace.json beside the input)")
    rp = sub.add_parser("report", help="cross-run report over BENCH_r*.json rounds (>10%% headline/stage "
                                       "regressions; last_good echoes excluded)")
    rp.add_argument("bench", nargs="+", help="BENCH_r*.json paths")
    rp.add_argument("--fail-on-regression", action="store_true",
                    help="exit 3 when a regression past the threshold survives echo exclusion")
    rp.add_argument("--json", action="store_true", help="print the GateVerdict object instead of the text report")
    rl = sub.add_parser("replay", help="re-drive a recorded serve journal through a live server (same arrivals, "
                                       "classes, deadlines and chaos schedule); the knobs make it a what-if")
    rl.add_argument("--journal", required=True, help="the recorded serve journal (.jsonl file or directory)")
    rl.add_argument("--traffic-mult", type=float, default=1.0,
                    help="offer the recorded schedule at this multiple (fractions select by a stable per-rid hash)")
    rl.add_argument("--devices", type=int, default=None,
                    help="rebuild the server at this shard width instead of the recorded one")
    rl.add_argument("--slo-scale", type=float, default=1.0,
                    help="scale every class SLO budget and request deadline (0.5 = twice as tight)")
    rl.add_argument("--controller", choices=("on", "off"), default="",
                    help="'on' forces the serving controller onto the replay server, 'off' strips a recorded one; "
                         "default re-drives as recorded")
    rl.add_argument("--journal-out", default="",
                    help="journal the replay here (default: a temp file; the replay journal is itself replayable)")
    rl.add_argument("--json", action="store_true", help="print the replay report object")
    rl.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    rf = sub.add_parser("roofline", help="per-stage MFU / HBM-bandwidth attribution with compute-vs-memory-bound "
                                         "verdicts, over committed BENCH rows or a live measurement")
    rf.add_argument("bench", nargs="*", help="BENCH_r*.json rows (wrapped in a parsed object, bare objects, or JSONL); "
                                             "last_good echoes are marked and never ranked")
    rf.add_argument("--live", action="store_true",
                    help="measure a per-stage breakdown now on --device (observability.stages) and attribute it")
    rf.add_argument("--batch", type=int, default=4, help="live batch size")
    rf.add_argument("--height", type=int, default=227, help="live input height")
    rf.add_argument("--width", type=int, default=227, help="live input width")
    rf.add_argument("--dtype", default="fp32", help="live dtype policy (fp32|bf16)")
    rf.add_argument("--repeats", type=int, default=3, help="live per-prefix chain size")
    rf.add_argument("--json", action="store_true", help="print RooflineReport objects (one JSON line per view)")
    rf.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    hl = sub.add_parser("health", help="fleet-health report over any journal: incident MTTR decomposition (phases "
                                       "sum to wall time), availability, per-class SLO attainment with "
                                       "error-budget burn, and compile-cost attribution")
    hl.add_argument("--journal", required=True,
                    help="a journal .jsonl file, or a directory whose *.jsonl files are folded together")
    hl.add_argument("--json", action="store_true", help="print the HealthReport object")
    hl.add_argument("--fail-on-budget-burn", action="store_true",
                    help="exit 3 when any SLO class has burned through its error budget (burn > 1.0)")
    return p


def main(argv=None) -> int:
    args = make_parser().parse_args(argv)
    if args.cmd == "export":
        return _export_main(args)
    if args.cmd == "report":
        from .gate import evaluate

        verdict = evaluate(args.bench)
        print(json.dumps(verdict.to_obj()) if args.json else verdict.render())
        if args.fail_on_regression and not verdict.ok:
            print(f"regression gate: FAIL ({len(verdict.regressions)} regression(s) > {verdict.threshold:.0%})",
                  file=sys.stderr)
            return 3
        return 0
    if args.cmd == "replay":
        return _replay_main(args)
    if args.cmd == "roofline":
        return _roofline_main(args)
    return _health_main(args)


def _export_main(args) -> int:
    from .export import export_trace

    src = Path(args.journal)
    if not src.exists():
        print(f"no journal at {src}", file=sys.stderr)
        return 2
    out = args.out or str((src if src.is_dir() else src.with_suffix("")).with_suffix("")) + ".trace.json"
    info = export_trace(src, out)
    print(f"Trace exported: {info['out']} events={info['events']} spans={info['spans']} records={info['records']}")
    if info["spans"] == 0:
        print("note: no span records found — the timeline is the synthetic journal-order view (run with tracing "
              "wired, e.g. run --serve --serve-journal / --trace, for real timestamps)")
    return 0


def _replay_main(args) -> int:
    from .replay import ReplayKnobs, load_recorded_run, replay_recorded

    src = Path(args.journal)
    if not src.exists():
        print(f"no journal at {src}", file=sys.stderr)
        return 2
    if args.traffic_mult <= 0 or args.slo_scale <= 0:
        print("--traffic-mult/--slo-scale must be > 0", file=sys.stderr)
        return 2
    try:
        recorded = load_recorded_run(src)
    except ValueError as e:
        print(f"unreplayable journal: {e}", file=sys.stderr)
        return 2
    try:
        report = replay_recorded(recorded, ReplayKnobs(
            traffic_mult=args.traffic_mult, devices=args.devices, slo_scale=args.slo_scale,
            journal_path=args.journal_out, controller=args.controller, device=args.device,
        ))
    except ValueError as e:  # a recording the knobs cannot rebuild
        print(f"unreplayable journal: {e}", file=sys.stderr)
        return 2
    except RuntimeError as e:  # no GPU and the CPU not asked for
        print(str(e), file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(report.to_obj()))
    else:
        print(f"Replay: {report.summary()}")
        for line in report.class_lines():
            print(line)
        if report.controller_state is not None:
            st = report.controller_state
            print(f"Replay controller: mode={st['mode']} level={st['level']} actions={st['actions'] or 'none'}")
    if report.diverged:
        print("replay divergence: a neutral replay must reproduce the recorded per-class accounting identically "
              "and land its percentiles within estimator resolution", file=sys.stderr)
        return 3
    return 0


def _health_main(args) -> int:
    from .export import load_records
    from .health import ERROR_BUDGET, health_from_records

    src = Path(args.journal)
    if not src.exists():
        print(f"no journal at {src}", file=sys.stderr)
        return 2
    records = load_records(src)
    if not records:
        print(f"empty journal at {src}", file=sys.stderr)
        return 2
    report = health_from_records(records)
    print(json.dumps(report.to_obj()) if args.json else report.render())
    if args.fail_on_budget_burn and report.budget_blown:
        blown = [c.name or "(default)" for c in report.classes if c.blown]
        print(f"health gate: FAIL — error budget blown for class(es) {', '.join(blown)} (burn > 1.0x of the "
              f"{ERROR_BUDGET:.0%} violation budget)", file=sys.stderr)
        return 3
    return 0


def _roofline_main(args) -> int:
    """Ranked per-stage tables over committed BENCH rows (echoes marked
    and never ranked) or a live breakdown measured on ``--device``."""
    from .roofline import roofline_from_bench_row

    rendered = 0
    # row-per-line artifacts render every row; round files go through the gate's classifier
    jsonl = [p for p in args.bench if str(p).endswith(".jsonl")]
    rounds_paths = [p for p in args.bench if p not in jsonl]
    for path in jsonl:
        try:
            lines = Path(path).read_text().splitlines()
        except OSError as e:
            print(f"cannot read {path}: {e}", file=sys.stderr)
            return 2
        for i, line in enumerate(lines):
            line = line.strip()
            if not line.startswith("{"):
                continue
            try:
                obj = json.loads(line)
            except ValueError:
                continue
            for rep in roofline_from_bench_row(obj):
                rendered += 1
                rep.label = f"{obj.get('config', '')} {rep.label}".strip()
                if args.json:
                    print(json.dumps({"row": f"{path}:{i + 1}", **rep.to_obj()}))
                else:
                    print(f"== {path}:{i + 1}")
                    print(rep.render())
    if rounds_paths:
        from .gate import load_rounds

        rounds = load_rounds(rounds_paths)
        if not rounds:
            print("no parseable BENCH rows", file=sys.stderr)
            return 2
        for rr in rounds:
            print(f"== {rr.name}: {rr.provenance}")
            if rr.is_echo:
                print(f"   echo of {rr.echo_of} — stale carry, not ranked")
                continue
            reports = roofline_from_bench_row(rr.row)
            if not reports:
                print("   no measurable roofline view (error-only round)")
                continue
            for rep in reports:
                rendered += 1
                print(json.dumps({"round": rr.name, **rep.to_obj()}) if args.json else rep.render())
    if args.live:
        rc = _roofline_live(args)
        if rc:
            return rc
        rendered += 1
    if not args.bench and not args.live:
        print("roofline: name BENCH rows and/or pass --live", file=sys.stderr)
        return 2
    return 0 if rendered else 2


def _roofline_live(args) -> int:
    import dataclasses

    import torch

    from ..configs import resolve_device
    from ..models.alexnet import BLOCKS12
    from ..models.init import deterministic_input, init_params_deterministic
    from .roofline import attribute_roofline
    from .stages import attribute_stages

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(str(e), file=sys.stderr)
        return 2
    cfg = dataclasses.replace(BLOCKS12, in_height=args.height, in_width=args.width)
    att = attribute_stages(init_params_deterministic(cfg, device=device),
                           deterministic_input(args.batch, cfg, device=device), cfg, compute=args.dtype,
                           repeats=args.repeats, warmup=1)
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    rep = attribute_roofline(dict(att.stages), dtype=args.dtype, batch=args.batch, device_kind=kind, cfg=cfg,
                             source="breakdown", total_ms=att.total_ms, label=f"live {device.type}")
    print(json.dumps(rep.to_obj()) if args.json else rep.render())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
