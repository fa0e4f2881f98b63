"""Loads the benchmark's data files by name.

Every piece that belongs to one cell, one configuration, one per-layer
metric or one layer sits in a file of its own and is found by the name
``BENCHMARK.json`` gives it:

- ``configs/<config>.json``    the deployment: region, resolution, winds
- ``traffic/<traffic>.json``   the study: mode, directions, tracks, check sizes
- ``limits/<cell>.json``       the limit of each number the check compares
- ``metrics/<metric>.py``      a reader ``read(ctx) -> float | None``
- ``layers/<layer>.json``      the ``hlo_module`` name patterns of a layer
- ``peaks.json``               published peaks, keyed by ``device_kind``

A later change adds files and entries; none of these loaders needs an edit
for it.
"""

from __future__ import annotations

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


def _json(path):
    with open(path, encoding='utf-8') as fobj:
        return json.load(fobj)


def benchmark_json():
    return _json(os.path.join(ROOT, 'BENCHMARK.json'))


def workload_entry(name):
    """The ``BENCHMARK.json`` entry of cell ``name``."""
    for entry in benchmark_json()['workloads']:
        if entry['name'] == name:
            return entry
    raise KeyError(f'no workload {name!r} in BENCHMARK.json')


def load_cell(entry, bench_dir=BENCH_DIR):
    """(study, config, limits) of the cell ``entry`` (its
    ``BENCHMARK.json`` entry). The study is the traffic file with the
    cell's name added."""
    study = _json(os.path.join(bench_dir, 'traffic',
                               f'{entry["traffic"]}.json'))
    study['name'] = entry['name']
    cfg = _json(os.path.join(bench_dir, 'configs', f'{entry["config"]}.json'))
    limits = _json(os.path.join(bench_dir, 'limits', f'{entry["name"]}.json'))
    return study, cfg, limits


def load_layers():
    """{layer: [hlo_module fnmatch patterns]} from every layer file."""
    out = {}
    layer_dir = os.path.join(BENCH_DIR, 'layers')
    for fname in sorted(os.listdir(layer_dir)):
        if fname.endswith('.json'):
            spec = _json(os.path.join(layer_dir, fname))
            out[spec['layer']] = list(spec['hlo_modules'])
    return out


def load_peaks(device_kind):
    """The peak entry of ``device_kind``; an unknown device is an error."""
    table = _json(os.path.join(BENCH_DIR, 'peaks.json'))['devices']
    if device_kind not in table:
        raise KeyError(f'no published peaks for device {device_kind!r} in '
                       'benchmark/peaks.json')
    return table[device_kind]


def load_metric(name):
    """The ``read(ctx)`` function of per-layer metric ``name``."""
    path = os.path.join(BENCH_DIR, 'metrics', f'{name}.py')
    mod_spec = importlib.util.spec_from_file_location(
        'bench_metric_' + name.replace('.', '_').replace('-', '_'), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(name, kind):
    """(name, unit) of the ``end_to_end`` or ``per_layer`` metrics that
    cell ``name`` reports: every metric without a ``workloads`` list, and
    those whose list names the cell."""
    out = []
    for m in benchmark_json()[kind]:
        if name in m.get('workloads', [name]):
            out.append((m['name'], m['unit']))
    return out
