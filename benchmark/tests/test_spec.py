"""Every file BENCHMARK.json names is there and loads, and the file
follows the benchmark's naming rules."""

import json
import os
import re

import pytest

from benchmark import spec

BJ = spec.benchmark_json()
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')


@pytest.mark.parametrize('entry', BJ['workloads'], ids=lambda e: e['name'])
def test_every_cell_loads(entry):
    study, cfg, limits = spec.load_cell(entry)
    assert study['study'] in ('uniform', 'sweep')
    assert cfg['name'] == entry['config']
    assert limits, 'a cell compares at least one number'
    for lim in limits.values():
        assert lim['limit'] >= 0


@pytest.mark.parametrize('cfg', BJ['configs'], ids=lambda c: c['name'])
def test_every_config_file(cfg):
    with open(os.path.join(spec.ROOT, cfg['file']), encoding='utf-8') as f:
        data = json.load(f)
    assert data['name'] == cfg['name']
    assert data['reduced'] == cfg['reduced']
    assert cfg['file'].startswith(BJ['paths'][0] + '/')


@pytest.mark.parametrize('metric', BJ['per_layer'], ids=lambda m: m['name'])
def test_every_per_layer_metric_has_a_reader(metric):
    assert callable(spec.load_metric(metric['name']))
    assert metric['moves'] in {m['name'] for m in BJ['end_to_end']}


def test_layers_named_in_benchmark_have_maps():
    layers = spec.load_layers()
    for metric in BJ['per_layer']:
        if metric['source'] == 'device_trace' and metric['layer'] != 'device':
            assert metric['layer'] in layers


def test_names_units_and_peaks():
    for group in ('configs', 'workloads', 'end_to_end', 'per_layer'):
        for item in BJ[group]:
            assert NAME.match(item['name']), item['name']
            for key in ('why', 'layer', 'source'):
                if key in item:
                    assert 1 <= len(item[key]) <= 200 and '\n' not in item[key]
            if 'unit' in item:
                assert UNIT.match(item['unit']), item['unit']
    peaks = spec.load_peaks('NVIDIA H100 80GB HBM3')
    assert peaks['hbm_bytes_per_s'] == 3.35e12
    with pytest.raises(KeyError):
        spec.load_peaks('a card that is not in the table')
