"""Per-batch critical-path attribution over the causal span tree (twin of
``petastorm_tpu/observability/critical_path.py``).

The trace ring (``observability/trace.py``) holds Chrome-trace events whose
``args`` carry ``trace``/``span``/``parent`` stamps: every ventilated item is
a trace, and the spans recorded across the ventilator thread, the worker
process, the consumer thread, the loader, and the infeed all parent into one
tree rooted at the item's *virtual root* (the trace id itself — see
``trace.trace_root``). This module reconstructs those trees and answers the
question the flat stall report cannot: **for THIS batch, which stage was on
the critical path** — fetch, decode, pool wait, ring wait, or collate?

Terminology:

* *makespan* — wall time from the earliest span start to the latest span end
  in the trace (dispatch → delivered), in µs.
* *self time* — a span's duration minus the parts covered by its children
  (clipped to the span's own interval), i.e. time attributable to the stage
  itself rather than to something it contains.
* *critical path* — the makespan decomposed along the timeline: at every
  instant the deepest active span owns the time, uncovered instants are
  ``'<untraced>'``, and the resulting ordered segments sum exactly to the
  makespan — the batch's dispatch-to-delivery latency, named stage by stage.

Events ship between processes on the pools' existing metrics piggyback, so a
main-process ring snapshot is normally enough.
"""

from __future__ import annotations

from petastorm_tpu_torch.observability import trace as _trace

#: tree nodes are plain dicts so the structure round-trips through JSON
#: without a conversion pass


def traces_in(events=None):
    """Group stamped events by trace id -> list of events (insertion order).
    Unstamped events (spans recorded with no active context) are skipped."""
    if events is None:
        events = _trace.get_ring().snapshot()
    out = {}
    for ev in events:
        args = ev.get('args') or {}
        tid = args.get('trace')
        if tid is not None:
            out.setdefault(tid, []).append(ev)
    return out


def span_tree(events, trace_id):
    """Reconstruct the span tree of one trace. Returns the virtual-root node
    (or None when the trace has no events)::

        {'span': <trace_id>, 'name': '<root>', 'trace': <trace_id>,
         'ts': µs, 'dur': µs (makespan), 'pid': None, 'children': [node, ...]}

    Child nodes carry the event fields (``name``/``cat``/``ts``/``dur``/
    ``pid``/``tid``/``args``) plus ``self_us`` and ``children``. Spans whose
    parent id never arrived (e.g. rotated out of the ring) attach to the root
    so no recorded work disappears from the view."""
    evs = traces_in(events).get(trace_id)
    if not evs:
        return None
    nodes = {}
    for ev in evs:
        args = ev.get('args') or {}
        sid = args.get('span')
        node = {'span': sid, 'parent': args.get('parent'), 'name': ev.get('name'),
                'cat': ev.get('cat'), 'ts': ev.get('ts', 0), 'dur': ev.get('dur', 0),
                'pid': ev.get('pid'), 'tid': ev.get('tid'),
                'args': {k: v for k, v in args.items()
                         if k not in ('trace', 'span', 'parent')},
                'children': []}
        if sid is not None:
            # duplicate span ids (retries replay the same item) keep the later
            # event — its timings supersede the abandoned attempt's
            nodes[sid] = node
    root = {'span': trace_id, 'parent': None, 'name': '<root>', 'cat': 'trace',
            'trace': trace_id, 'pid': None, 'tid': None, 'args': {},
            'children': []}
    for node in nodes.values():
        parent = nodes.get(node['parent']) if node['parent'] != trace_id else None
        if parent is None or parent is node:
            root['children'].append(node)
        else:
            parent['children'].append(node)
    starts = [n['ts'] for n in nodes.values()]
    ends = [n['ts'] + n['dur'] for n in nodes.values()]
    root['ts'] = min(starts)
    root['dur'] = max(ends) - root['ts']  # makespan
    _finalize(root)
    return root


def _finalize(node):
    """Sort children by start time and compute ``self_us`` bottom-up."""
    node['children'].sort(key=lambda n: n['ts'])
    covered = 0
    p_start, p_end = node['ts'], node['ts'] + node['dur']
    for child in node['children']:
        _finalize(child)
        # clip to the parent interval: cross-process clocks can skew a child
        # slightly outside, and attribution must never go negative
        covered += max(0, min(child['ts'] + child['dur'], p_end)
                       - max(child['ts'], p_start))
    node['self_us'] = max(0, node['dur'] - covered)


def critical_path(tree):
    """Timeline decomposition of the makespan: at every instant, the deepest
    active span in the tree owns the time (a parent's interval cedes to the
    child doing the actual work). Returns ordered, merged segments
    ``[{'name', 'cat', 'pid', 'dur_us'}, ...]`` whose durations sum exactly to
    the makespan — the batch's dispatch-to-delivery latency named stage by
    stage. Instants covered by no span (queueing between a worker finishing
    and the consumer picking the result up, scheduler delay, ring wait on an
    uninstrumented path) surface as ``'<untraced>'`` segments rather than
    vanishing.

    A plain longest-child descent would be wrong here: handoffs are async, so
    a child routinely outlives its parent (the worker span starts after the
    ``ventilate`` span that caused it already closed) — the sweep handles
    that naturally."""
    spans = []

    def walk(node, depth):
        for child in node['children']:
            spans.append((depth, child))
            walk(child, depth + 1)

    walk(tree, 1)
    if not spans:
        return []
    bounds = sorted({b for _, n in spans for b in (n['ts'], n['ts'] + n['dur'])})
    segments = []
    for lo, hi in zip(bounds, bounds[1:]):
        best = None
        for depth, n in spans:
            if n['ts'] <= lo and n['ts'] + n['dur'] >= hi:
                # deepest wins; among equals the later-started (the span
                # actually progressing the item at this point)
                if (best is None or depth > best[0]
                        or (depth == best[0] and n['ts'] > best[1]['ts'])):
                    best = (depth, n)
        if best is None:
            seg = {'name': '<untraced>', 'cat': 'trace', 'pid': None}
        else:
            n = best[1]
            seg = {'name': n['name'], 'cat': n['cat'], 'pid': n['pid']}
        if segments and segments[-1]['name'] == seg['name'] \
                and segments[-1]['pid'] == seg['pid']:
            segments[-1]['dur_us'] += hi - lo
        else:
            seg['dur_us'] = hi - lo
            segments.append(seg)
    return segments


def stage_breakdown(tree):
    """Self time per stage name across the whole tree (µs) — where the
    makespan actually went, nesting counted once."""
    out = {}
    stack = [tree]
    while stack:
        node = stack.pop()
        if node['name'] != '<root>':
            out[node['name']] = out.get(node['name'], 0) + node['self_us']
        stack.extend(node['children'])
    return out


def _tree_stats(tree):
    pids = set()
    spans = 0
    stack = [tree]
    while stack:
        node = stack.pop()
        if node['name'] != '<root>':
            pids.add(node['pid'])
            spans += 1
        stack.extend(node['children'])
    return spans, pids


def slowest_batches(events=None, top=5):
    """Batches ranked by makespan, slowest first::

        [{'trace', 'makespan_us', 'spans', 'processes',
          'stages': {name: self_µs}, 'critical_path': [...]}]
    """
    if events is None:
        events = _trace.get_ring().snapshot()
    rows = []
    for tid in traces_in(events):
        tree = span_tree(events, tid)
        if tree is None:
            continue
        spans, pids = _tree_stats(tree)
        rows.append({'trace': tid, 'makespan_us': tree['dur'], 'spans': spans,
                     'processes': len(pids), 'stages': stage_breakdown(tree),
                     'critical_path': critical_path(tree)})
    rows.sort(key=lambda r: r['makespan_us'], reverse=True)
    return rows[:top]
