"""The trace reduction: busy time as a union of device events, the idle
share over the study's host span, the per-layer split by ``hlo_module``,
and idle gaps labelled by what the host was doing."""

import json
import os

import pytest

from benchmark import spec, trace

# times in ns; two overlapping engine kernels, one solver kernel, and a
# kernel that starts before the study span and is clipped to it
HAND = {
    'device': [
        [50, 100, 'jit__run_chunk', 'fusion_1'],      # clipped to 100..150
        [200, 100, 'jit__run_chunk', 'fusion_2'],     # 200..300
        [250, 100, 'jit__compact', 'sort'],           # 250..350, overlaps
        [600, 100, 'jit_other', 'copy'],              # 600..700
        [1200, 50, 'jit__run_chunk', 'late'],         # after the span
    ],
    'host': [
        ['study', 100, 1100],
        ['tracks_call', 150, 900],
        ['PjitFunction(solve)', 400, 550],
        ['presence_map_call', 900, 1100],
    ],
}
LAYERS = {'agents': ['jit__run_chunk*', 'jit__compact*']}


def test_busy_union_and_window():
    red = trace.reduce_trace(HAND, trace.span_window(HAND), LAYERS)
    # busy: 100..150, 200..350, 600..700 -> 50 + 150 + 100 ns
    assert red['busy_s'] == pytest.approx(300e-9)
    assert red['window_s'] == pytest.approx(1000e-9)
    assert red['layer_s']['agents'] == pytest.approx(200e-9)
    assert red['n_device_events'] == 4


def test_idle_gaps_are_labelled_by_the_host():
    red = trace.reduce_trace(HAND, trace.span_window(HAND), LAYERS)
    gaps = red['idle_gaps']
    # longest gaps: 700..1100 (400 ns), 350..600 (250), 150..200 (50)
    assert [g[1] for g in gaps] == pytest.approx([400e-9, 250e-9, 50e-9])
    assert gaps[0][0] == 'presence_map_call'
    assert gaps[1][0] == 'tracks_call: PjitFunction(solve)'
    assert gaps[2][0] == 'tracks_call'


def test_top_device_ops_by_module_and_kernel():
    red = trace.reduce_trace(HAND, trace.span_window(HAND), LAYERS)
    ops = dict(red['device_ops'])
    assert ops['jit__run_chunk:fusion_2'] == pytest.approx(100e-9)
    assert ops['jit__run_chunk:fusion_1'] == pytest.approx(50e-9)
    assert 'jit__run_chunk:late' not in ops


RECORDED = os.path.join(spec.BENCH_DIR, 'testdata', 'wy_trace_cut.json')


def test_recorded_chip_trace_cut():
    """A cut of a traced WY study on the H100 (``testdata/``): the
    reduction's numbers are consistent with each other and with the
    events, and the engine's modules are found by the layer map."""
    with open(RECORDED, encoding='utf-8') as fobj:
        cut = json.load(fobj)
    window = (cut['window'][0], cut['window'][1])
    red = trace.reduce_trace(cut, window, spec.load_layers())
    assert 0 < red['busy_s'] <= red['window_s']
    assert 0 < red['layer_s']['agents'] <= red['busy_s']
    total_gaps = sum(g[1] for g in red['idle_gaps'])
    assert total_gaps <= red['window_s'] - red['busy_s'] + 1e-12
    assert red['n_device_events'] == len(cut['device'])
    assert all(label.split(':')[0] in trace.HARNESS_SPANS
               for label, _ in red['idle_gaps'])
    assert cut['expected'] == pytest.approx(
        {'busy_s': red['busy_s'], 'agents_s': red['layer_s']['agents']})
