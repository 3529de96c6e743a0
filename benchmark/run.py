"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``benchmark/``
and the port. ``--trace 0`` prints the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics, read from a device trace of the window
and from the harness's records. A run needs a CUDA card; with none, or with
fewer than the cell asks for, it prints no result and exits 2. The last
line of standard output is the result; the numbers that decide ``correct``
are the last lines of standard error and the result's last key.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import check, harness, traffic  # noqa: E402
from benchmark.devtrace import DeviceTrace  # noqa: E402
from benchmark.window import Run  # noqa: E402

# a traced run traces the first TRACE_S seconds of its window; the metrics
# read from the harness's records then cover the rest of the window, so
# that the profiler's cost on the host (it about doubles a decode step's
# issue) does not enter them
TRACE_S = 10.0


def read_metric(name: str, run: Run):
    """The metric's reader, ``benchmark/metrics/<name>.py``; None when it
    found nothing to read."""
    path = os.path.join(harness.HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def card_line() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def trace_events(prof, lo_ns: int, hi_ns: int) -> DeviceTrace:
    """The device events of a stopped ``torch.profiler`` run, on its clock
    (nanoseconds since the epoch), as seconds."""
    import torch

    res = prof.profiler.kineto_results
    lo = max(lo_ns, res.trace_start_ns())
    ev = [(e.name(), e.start_ns() * 1e-9, (e.start_ns() + e.duration_ns()) * 1e-9) for e in res.events()
          if e.device_type() == torch.autograd.DeviceType.CUDA]
    return DeviceTrace(ev, lo * 1e-9, hi_ns * 1e-9)


def execute(cell, seed: int, seconds: float, trace: bool = False, control: bool = False, device: str = "cuda",
            after_build=None) -> dict:
    """One run of ``cell`` on ``device``: the result line as a dict.
    ``after_build(built)`` is the tests' hook into the built service."""
    import torch

    cuda = device == "cuda"
    os.makedirs(harness.RUN_DIR, exist_ok=True)
    qs = traffic.questions(cell.mix, seed)
    built = harness.build(cell, seed, device, record_attention=trace)
    if after_build is not None:
        after_build(built)
    sampling = {"temperature": built.app.sampling.temperature, "top_p": built.app.sampling.top_p,
                "largest_bucket": max(built.app.engine.prompt_buckets)}
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    prof = None
    opened = {}
    if trace:
        from torch.profiler import ProfilerActivity, profile

        # the CPU run of the tests traces the host only: no device event
        prof = profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU])

        def on_open():
            prof.start()
            opened["lo_ns"] = time.time_ns()
            built.recorder.start()
    else:
        def on_open():
            pass
    window, threads = harness.drive(built, qs, seconds, cell.mix.think_ms, on_open=on_open,
                                    slice_s=min(TRACE_S, seconds / 2) if prof is not None else 0.0)
    setup_s = window.t_open - T_START
    if prof is not None:
        built.recorder.stop()
        prof.stop()
        t_from = window.t_slice
    else:
        t_from = window.t_open
    harness.wait_close(window)
    harness.close(built, threads)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    dtrace = None
    if prof is not None:
        dtrace = trace_events(prof, opened["lo_ns"], window.slice_end_ns)
        del prof
    calls, metas, recorder = built.capture.calls, built.metas, built.recorder
    harness.free(built)
    run = Run(cell.name, cell.config["model"], seconds, window.t_open, window.t_close, window.records, calls,
              dtrace, setup_s, t_from, recorder.calls if recorder is not None else None)

    n_ret, n_dec = cell.samples
    judged = check.judge(cell.config, seed, cell.mix, metas, window.records, calls, device, sampling,
                         n_ret, n_dec, control=control)
    inside = [r for r in window.records if window.t_open <= r["recv"] <= window.t_close]
    failed = sum(r["status"] != 200 for r in inside)
    correct, checks = check.verdict(judged["numbers"], cell.limits, failed)
    if control:
        # the control in the program's place: its numbers under the same
        # names and limits decide this run's ``correct``
        program = {"correct": bool(correct), "checks": checks}
        correct, checks = check.verdict(check.control_numbers(judged["numbers"]), cell.limits, failed)
    in_calls = [c for c in calls if c.t0 <= window.t_close]
    print("calls (rows, bucket, chunk, spec, steps, start and end in the window): "
          + json.dumps([[len(c.rows), c.S, c.chunk, int(c.spec), c.steps, round(c.t0 - window.t_open, 3),
                         round(c.t1 - window.t_open, 3)] for c in in_calls]), file=sys.stderr, flush=True)

    metrics = {}
    for name in (cell.metrics_layer if trace else cell.metrics_e2e):
        v = read_metric(name, run)
        if v is not None:
            metrics[name] = {"value": v, "unit": cell.units[name]}
    dev = {"platform": "gpu" if cuda else device, "kind": torch.cuda.get_device_name(0) if cuda else device,
           "count": int(cell.entry["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": len(inside), "failed": int(failed), "metrics": metrics,
              "device": dev}
    if dtrace is not None:
        dev["busy_s"] = dtrace.busy_s()
        dev["window_s"] = dtrace.window_s
        result["breakdown"] = {"device_ops": dtrace.top_ops(10), "idle_gaps": dtrace.gaps(10)}
    result["judged"] = {k: v for k, v in judged.items() if k != "numbers"}
    # the numbers this cell does not compare, beside the readings
    result["judged"]["readings"].update({k: v for k, v in judged["numbers"].items()
                                         if k not in cell.limits and not k.startswith("control_")})
    if control:
        result["program"] = program
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="judge the fp8 control in the program's place: `correct` is the control's "
                         "verdict, the program's is under `program` (not in the benchmark's runs)")
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)

    import torch

    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}", file=sys.stderr, flush=True)
    result = execute(cell, args.seed, args.seconds, trace=bool(args.trace), control=bool(args.control))
    checks = result.pop("checks")
    result["card"] = card
    result["checks"] = checks
    bad = harness.forbidden_modules()
    if bad:
        print(f"benchmark: modules of JAX or the JAX package were loaded: {bad}", file=sys.stderr)
        return 3
    for name, (v, lim) in checks.items():
        print(f"check {name}: {v} (limit {lim})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
