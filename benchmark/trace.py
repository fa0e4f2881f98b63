"""From a profiler trace to device busy time, per-layer device time, the
top device operations and the host's longest idle gaps.

The reduction works on a small neutral form so it can be tested on a
recorded cut of a chip trace (``testdata/``):

    {"device": [[start_ns, dur_ns, hlo_module, kernel], ...],
     "host": [[name, start_ns, end_ns], ...]}

``device`` holds every event on a ``Stream`` line of a ``/device:GPU``
plane; ``host`` holds the events of the host thread that ran the study,
where the harness's ``TraceAnnotation`` spans and JAX's dispatch events
sit. Host
and device times are on the profiler's one clock.
"""

from __future__ import annotations

import fnmatch
import glob
import os

import numpy as np

HARNESS_SPANS = ('study', 'fields_call', 'tracks_call', 'sweep_call',
                 'presence_map_call', 'artifact_cleanup',
                 # program entry points the harness wraps (harness.Captures)
                 'solve_potential_refined', 'solve_potential_direct',
                 '_prologue_jit', 'prepared_weights_batch')


def load_xplane(trace_dir):
    """Neutral form of the newest ``.xplane.pb`` under ``trace_dir``."""
    from jax.profiler import ProfileData
    files = sorted(glob.glob(os.path.join(
        trace_dir, 'plugins', 'profile', '*', '*.xplane.pb')))
    if not files:
        raise RuntimeError(f'no .xplane.pb under {trace_dir}')
    prof = ProfileData.from_file(files[-1])
    device, host = [], []
    for plane in prof.planes:
        if plane.name.startswith('/device:GPU'):
            for line in plane.lines:
                if not line.name.startswith('Stream'):
                    continue
                for ev in line.events:
                    module = ''
                    for key, val in ev.stats:
                        if key == 'hlo_module':
                            module = str(val)
                            break
                    device.append([ev.start_ns, ev.duration_ns, module,
                                   ev.name])
        elif plane.name == '/host:CPU':
            # the thread that ran the study: the line holding the
            # harness's spans (its name is the interpreter's, e.g.
            # 'python' or 'python3')
            for line in plane.lines:
                events = [[ev.name, ev.start_ns, ev.start_ns + ev.duration_ns]
                          for ev in line.events]
                if any(e[0] == 'study' for e in events):
                    host.extend(events)
    return {'device': device, 'host': host}


def _union(starts, ends):
    """Merged [start, end) intervals of possibly overlapping ones."""
    if len(starts) == 0:
        return np.zeros((0, 2))
    order = np.argsort(starts, kind='stable')
    s, e = starts[order], ends[order]
    run_end = np.maximum.accumulate(e)
    new = np.ones(s.size, bool)
    new[1:] = s[1:] > run_end[:-1]
    idx = np.flatnonzero(new)
    ends_at = np.append(idx[1:] - 1, s.size - 1)
    return np.stack([s[idx], run_end[ends_at]], axis=1)


def _clip(starts, ends, lo, hi):
    s = np.clip(starts, lo, hi)
    e = np.clip(ends, lo, hi)
    keep = e > s
    return s[keep], e[keep]


def _busy(starts, ends):
    iv = _union(starts, ends)
    return float((iv[:, 1] - iv[:, 0]).sum()) if iv.size else 0.


def span_window(trace, name='study'):
    """(start_ns, end_ns) of the last host span called ``name``."""
    spans = [h for h in trace['host'] if h[0] == name]
    if not spans:
        raise RuntimeError(f'no host span {name!r} in the trace')
    return float(spans[-1][1]), float(spans[-1][2])


def _host_label(host, t):
    """What the host was doing at time t: the innermost harness span
    open then and, inside it, the innermost other host event."""
    span, inner = 'outside the harness spans', None
    span_start = inner_start = -np.inf
    for name, s, e in host:
        if s <= t < e:
            if name in HARNESS_SPANS:
                if s >= span_start:
                    span, span_start = name, s
            elif s >= inner_start:
                inner, inner_start = name, s
    return span if inner is None else f'{span}: {inner}'


def reduce_trace(trace, window, layers, top=10):
    """Device busy time, per-layer device time and the breakdown inside
    ``window`` = (start_ns, end_ns).

    ``layers`` maps a layer name to ``hlo_module`` fnmatch patterns; a
    layer's device time is the union of its events' intervals."""
    lo, hi = window
    dev = trace['device']
    starts = np.array([d[0] for d in dev], np.float64)
    ends = starts + np.array([d[1] for d in dev], np.float64)
    modules = np.array([d[2] for d in dev], object)
    kernels = np.array([d[3] for d in dev], object)
    inside = (ends > lo) & (starts < hi)
    starts, ends = starts[inside], ends[inside]
    modules, kernels = modules[inside], kernels[inside]
    cs, ce = _clip(starts, ends, lo, hi)
    busy_ns = _busy(cs, ce)

    names = np.unique(modules) if modules.size else np.zeros(0, object)
    layer_ns = {}
    for layer, patterns in layers.items():
        mine = [m for m in names
                if any(fnmatch.fnmatchcase(m, p) for p in patterns)]
        sel = np.isin(modules, mine)
        if sel.any():
            s, e = _clip(starts[sel], ends[sel], lo, hi)
            layer_ns[layer] = _busy(s, e)

    keys = np.array([f'{m}:{k}' if m else k
                     for m, k in zip(modules, kernels)], object)
    device_ops = []
    if keys.size:
        uniq, inv = np.unique(keys, return_inverse=True)
        tot = np.bincount(inv, weights=np.minimum(ends, hi)
                          - np.maximum(starts, lo))
        order = np.argsort(-tot)[:top]
        device_ops = [(str(uniq[i]), float(tot[i])) for i in order]

    iv = _union(cs, ce)
    bounds = np.concatenate([[lo], iv.ravel(), [hi]]).reshape(-1, 2)
    gaps = [(float(a), float(b)) for a, b in bounds if b > a]
    gaps.sort(key=lambda g: g[0] - g[1])
    idle_gaps = [[_host_label(trace['host'], (a + b) / 2), (b - a) * 1e-9]
                 for a, b in gaps[:top]]
    return {
        'window_s': (hi - lo) * 1e-9,
        'busy_s': busy_ns * 1e-9,
        'layer_s': {k: v * 1e-9 for k, v in layer_ns.items()},
        'device_ops': [[k, v * 1e-9] for k, v in device_ops],
        'idle_gaps': idle_gaps,
        'n_device_events': int(inside.sum()),
    }

