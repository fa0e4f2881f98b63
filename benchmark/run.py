"""One run of one benchmark cell: whole SSRS studies through the
``Simulator`` on one GPU.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (``setup_s``, from process start): check the device, load the
cell's files, build the Simulator, then run the cell's warm-up studies.
With ``--trace 0`` the window repeats whole studies until their summed
wall reaches ``--seconds`` and reports ``study_s``; with ``--trace 1``
one study runs under the profiler and the cell's per-layer metrics are
read from it. Either way the last study is then compared with the plain
references (``check.py``), and the last line of stdout is the result.

Exits 3, with no result line, when JAX's default device is not a GPU or
there are fewer GPUs than the cell asks for.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

# pylint: disable=wrong-import-position
import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import check, harness, spec  # noqa: E402
from benchmark import trace as trace_mod  # noqa: E402
from benchmark.roofline import engine_bytes_per_agent_step  # noqa: E402

# what the benchmark writes, at fixed paths inside the checkout
WORK = os.path.join(ROOT, '.bench')


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _finite(x):
    """A JSON number for any float (a non-finite reading is the largest
    float)."""
    x = float(x)
    return x if math.isfinite(x) else sys.float_info.max


def card_report():
    """The card's name and power limit, from nvidia-smi, for the log."""
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        out = f'nvidia-smi unavailable: {exc}'
    log(f'card: {out}')


def main(argv=None, require_gpu=True, bench_dir=spec.BENCH_DIR,
         entry=None, control=False):
    """One run. ``entry`` stands in for the cell's ``BENCHMARK.json``
    entry (tests run cells of their own); ``control`` runs the
    lower-precision control of the check instead of the program as
    configured."""
    args = parse(argv)
    cache_dir = os.path.join(WORK, 'jax_cache')
    os.makedirs(cache_dir, exist_ok=True)
    os.environ['JAX_COMPILATION_CACHE_DIR'] = cache_dir
    # no eviction: a cell's cache is a few MB, and eviction's bookkeeping
    # files were seen to go missing on a chip machine (every write failed)
    os.environ['JAX_COMPILATION_CACHE_MAX_SIZE'] = '-1'
    harness.go_offline()
    import jax
    jax.config.update('jax_compilation_cache_dir', cache_dir)
    jax.config.update('jax_compilation_cache_max_size', -1)

    if entry is None:
        entry = spec.workload_entry(args.workload)
    chips = int(entry['chips'])
    devs = jax.devices()
    if require_gpu and (devs[0].platform != 'gpu' or len(devs) < chips):
        log(f'benchmark: cell {args.workload!r} needs {chips} NVIDIA '
            f'GPU(s); JAX found {len(devs)} {devs[0].platform} device(s) '
            f'({devs[0].device_kind}). Nothing was run.')
        return 3
    device = {'platform': devs[0].platform, 'kind': devs[0].device_kind,
              'count': chips}
    if devs[0].platform == 'gpu':
        card_report()
        peaks = spec.load_peaks(devs[0].device_kind)
    else:
        peaks = None

    wl, cfg, limits = spec.load_cell(entry, bench_dir)
    out_dir = os.path.join(WORK, 'out', args.workload)
    shutil.rmtree(out_dir, ignore_errors=True)
    kw = harness.simulator_config(cfg, wl, out_dir, args.seed)
    if control:
        kw['track_weight_precision'] = 'bfloat16'
    import ssrs_tpu
    if not os.path.abspath(ssrs_tpu.__file__).startswith(ROOT + os.sep):
        log(f'benchmark: ssrs_tpu comes from {ssrs_tpu.__file__}, not '
            f'from this checkout ({ROOT}). Nothing was run.')
        return 4
    with harness.program_output_to_stderr():
        sim = ssrs_tpu.Simulator(**kw)
    # every executable of the cell goes to the in-checkout cache, so
    # later runs of the cell load them instead of compiling
    jax.config.update('jax_persistent_cache_min_compile_time_secs', 0)
    captures = harness.Captures()
    captures.install()

    index = 0
    for _ in range(int(wl['warmup_studies'])):
        with harness.CompileCounter() as cc, \
                harness.program_output_to_stderr():
            wall, _, _ = harness.run_study(sim, wl, args.seed, index,
                                           captures)
        log(f'warm-up study {index}: {wall:.3f} s, {cc.count} executables '
            f'built ({cc.seconds:.3f} s)')
        index += 1
    setup_s = time.perf_counter() - _T0
    log(f'setup_s {setup_s:.3f}')

    walls, attempted, failed = [], 0, 0
    summary = records = red = None
    if args.trace:
        trace_dir = os.path.join(WORK, 'trace', args.workload)
        shutil.rmtree(trace_dir, ignore_errors=True)
        opts = jax.profiler.ProfileOptions()
        opts.python_tracer_level = 0
        opts.host_tracer_level = 2
        attempted = 1
        jax.profiler.start_trace(trace_dir, profiler_options=opts)
        try:
            with harness.program_output_to_stderr():
                wall, summary, records = harness.run_study(
                    sim, wl, args.seed, index, captures)
            walls.append(wall)
        finally:
            jax.profiler.stop_trace()
        index += 1
        raw = trace_mod.load_xplane(trace_dir)
        red = trace_mod.reduce_trace(raw, trace_mod.span_window(raw),
                                     spec.load_layers())
        log(f'traced study: {wall:.3f} s; {red["n_device_events"]} device '
            f'events, busy {red["busy_s"]:.3f} s of {red["window_s"]:.3f} s')
    else:
        with harness.CompileCounter() as cc:
            spent = 0.
            while attempted == 0 or spent < args.seconds:
                attempted += 1
                t0 = time.perf_counter()
                try:
                    with harness.program_output_to_stderr():
                        wall, summary, records = harness.run_study(
                            sim, wl, args.seed, index, captures)
                    walls.append(wall)
                except Exception:  # noqa: BLE001 — a failed study is
                    # counted and reported, and the run goes on
                    failed += 1
                    traceback.print_exc(file=sys.stderr)
                    summary = None
                spent += time.perf_counter() - t0
                index += 1
        print(f'executables built inside the window: {cc.count} '
              f'({cc.seconds:.3f} s)', flush=True)
        log(f'study walls: {walls}')

    stats = devs[0].memory_stats() or {}
    device['memory_peak_bytes'] = int(stats.get('peak_bytes_in_use', 0))
    captures.uninstall()

    metrics = {}
    breakdown = None
    if args.trace:
        useful = 0
        for case in sim.case_ids:
            counts = sim.get_presence_counts(case, 0)
            useful += int(counts.sum(dtype='int64')) - int(sim.track_count)
        table = captures.tables[0] if captures.tables else None
        ctx = SimpleNamespace(
            trace=red, records=records, useful_steps=useful,
            solve_seconds=list(captures.solve_seconds),
            bytes_per_agent_step=None if table is None else
            engine_bytes_per_agent_step(table.dtype.itemsize,
                                        int(sim.track_dirn_restrict)),
            peaks=peaks, memory_peak_bytes=device['memory_peak_bytes'])
        for name, unit in spec.cell_metrics(args.workload, 'per_layer'):
            value = spec.load_metric(name)(ctx)
            if value is not None:
                metrics[name] = {'value': value, 'unit': unit}
        device['busy_s'] = red['busy_s']
        device['window_s'] = red['window_s']
        breakdown = {'device_ops': red['device_ops'],
                     'idle_gaps': red['idle_gaps']}
    elif walls:
        metrics['study_s'] = {'value': sum(walls) / len(walls), 'unit': 's'}
        metrics['setup_s'] = {'value': setup_s, 'unit': 's'}

    if summary is None:
        correct, rows = False, [('last study completed', 0., 1.)]
    else:
        t0 = time.perf_counter()
        numbers = check.check_study(sim, wl, captures, summary, index,
                                    args.seed, control=control)
        correct, rows = check.verdict(numbers, limits)
        log(f'check took {time.perf_counter() - t0:.3f} s')
    correct = correct and failed == 0

    result = {'correct': bool(correct), 'attempted': attempted,
              'failed': failed, 'metrics': metrics, 'device': device}
    if breakdown is not None:
        result['breakdown'] = breakdown
    result['checks'] = {name: {'value': _finite(v), 'limit': lim}
                        for name, v, lim in rows}
    for name, v, lim in rows:
        log(f'check {name}: {v!r} (limit {lim!r}) '
            f'{"PASS" if v <= lim else "FAIL"}')
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
