"""Command-line entry point: ``python -m ssrs_tpu <command>``.

The reference package has no CLI (runs are scripts importing
``ssrs.Simulator``); this adds the obvious one on top of the same
``Config`` surface. A run config is a JSON object whose keys are
``Config`` fields — exactly what ``Simulator`` writes to
``<out_dir>/<run_name>/<run_name>.json``, so a past run's JSON re-runs
as-is.

Commands:
    run CONFIG.json [--no-plots]   build Simulator, simulate tracks,
                                   compute/plot presence maps
    info                           JAX backend / device / version report
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys


def _load_config(path: str):
    from .config import Config
    with open(path) as fobj:
        raw = json.load(fobj)
    if not isinstance(raw, dict):
        raise SystemExit(f'{path}: expected a JSON object of Config '
                         'fields')
    fields = {f.name for f in dataclasses.fields(Config)}
    unknown = sorted(set(raw) - fields)
    if unknown:
        raise SystemExit(
            f'{path}: unknown Config field(s): {", ".join(unknown)}\n'
            f'valid fields: {", ".join(sorted(fields))}')
    # JSON round-trip turns tuples into lists; Config handles sequences
    return Config(**raw)


def _cmd_run(args) -> int:
    from .simulator import Simulator
    config = _load_config(args.config)
    sim = Simulator(config)
    sim.simulate_tracks()
    sim.compute_presence_map()
    if not args.no_plots:
        sim.plot_terrain_features()
        sim.plot_simulated_tracks()
        sim.plot_presence_map()
    print(f'run complete: {sim.mode_data_dir}')
    return 0


def _cmd_info(args) -> int:
    import jax

    import ssrs_tpu
    print(f'ssrs_tpu {getattr(ssrs_tpu, "__version__", "0.1.0")}')
    print(f'jax {jax.__version__}')
    try:
        devices = jax.devices()
        print(f'backend: {devices[0].platform} '
              f'({len(devices)} device(s))')
        for d in devices:
            print(f'  {d}')
    except RuntimeError as exc:
        print(f'backend unavailable: {exc}')
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog='python -m ssrs_tpu',
        description='stochastic soaring-raptor simulator (JAX)')
    sub = parser.add_subparsers(dest='command', required=True)

    p_run = sub.add_parser('run', help='run a simulation from a JSON '
                                       'config')
    p_run.add_argument('config', help='JSON file of Config fields')
    p_run.add_argument('--no-plots', action='store_true',
                       help='skip figure generation')
    p_run.set_defaults(fn=_cmd_run)

    p_info = sub.add_parser('info', help='report backend/devices')
    p_info.set_defaults(fn=_cmd_info)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == '__main__':
    sys.exit(main())
