"""The numbers that decide ``correct``: the program's outputs against the
plain reference's, each held to a limit of the cell's own
(``benchmark/workloads/<cell>.json``)."""

from __future__ import annotations

import statistics

import numpy as np


def relative_gap(prog, ref, scale):
    """``|prog - ref| / scale``; 0 where both are 0, infinite where only the
    scale is."""
    gap = abs(prog - ref)
    if scale == 0:
        return 0.0 if gap == 0 else float('inf')
    return gap / scale


def _median(values):
    """The median leaf's norm among the leaves the reference moves at all:
    at the first step the zero-initialised last batch norm of every block
    holds its branch's gradient at exactly 0, in both programs."""
    moving = [v for v in values if v > 0]
    return statistics.median(moving) if moving else 0.0


def moving_leaves(grad, floor=1e-3):
    """The leaves whose reference gradient norm is at least ``floor`` of the
    median leaf's: the others move by round-off alone."""
    median = _median(grad.values())
    return {n for n, g in grad.items() if g >= floor * median}


def _norm(t):
    return float(t.detach().double().norm())


def leaf_gaps(prog, ref, keep):
    """Each leaf of ``keep``: the gap between the program's and the
    reference's norm of the leaf, against the larger of the reference's norm
    of that leaf and of the median leaf (``prog`` and ``ref``: ``{leaf:
    tensor}``)."""
    norms = {n: _norm(t) for n, t in ref.items()}
    median = _median(norms.values())
    return [relative_gap(_norm(prog[n]), norms[n], max(norms[n], median)) for n in sorted(keep)]


#: the numbers of :func:`model_numbers`
MODEL_NUMBERS = ('loss1_gap', 'loss_gap', 'grad1_leaf_gap', 'change_leaf_gap')


def model_numbers(prog, ref):
    """The three steps the reference follows from the start. ``prog`` and
    ``ref``: ``{'losses', 'first_grad', 'change'}``, the last two
    ``{leaf: tensor}``; ``ref`` also ``grad_max``. The first step's and the
    steps' largest relative loss gap, and the worst leaf's gap of norms of
    the first gradient and of the change over the steps."""
    first = {n: _norm(t) for n, t in ref['first_grad'].items()}
    losses = [relative_gap(p, r, abs(r)) for p, r in zip(prog['losses'], ref['losses'])]
    return dict(zip(MODEL_NUMBERS, (
        losses[0],
        max(losses),
        max(leaf_gaps(prog['first_grad'], ref['first_grad'], moving_leaves(first))),
        max(leaf_gaps(prog['change'], ref['change'], moving_leaves(ref['grad_max']))))))


#: the numbers of :func:`window_numbers`
WINDOW_NUMBERS = ('window_loss_gap', 'window_grad_leaf_gap', 'window_change_leaf_gap')


def window_numbers(prog, ref):
    """The window step the reference follows from the program's state:
    ``prog`` and ``ref`` ``{'loss', 'grad', 'change'}`` (``prog`` None when
    the window ended before the step came: every number infinite). The
    relative loss gap, and the worst leaf's gap of norms of the gradient and
    of the change; leaves as in :func:`model_numbers`, by the reference's
    gradient at that step."""
    if prog is None:
        return {name: float('inf') for name in WINDOW_NUMBERS}
    keep = moving_leaves({n: _norm(g) for n, g in ref['grad'].items()})
    return dict(zip(WINDOW_NUMBERS, (
        relative_gap(prog['loss'], ref['loss'], abs(ref['loss'])),
        max(leaf_gaps(prog['grad'], ref['grad'], keep)),
        max(leaf_gaps(prog['change'], ref['change'], keep)))))


def row_numbers(row_ids, rows):
    """Which rows the run staged: ``row_ids`` every row id staged in the
    run, ``rows`` the store's row count. Ids outside the store, and the
    spread of the times each row was staged."""
    ids = np.asarray(row_ids, dtype=np.int64)
    unknown = int(((ids < 0) | (ids >= rows)).sum())
    counts = np.bincount(ids[(ids >= 0) & (ids < rows)], minlength=rows)
    return {'unknown_rows': unknown, 'row_count_spread': int(counts.max() - counts.min())}


def judge(numbers, limits, not_compared=()):
    """``(correct, [(name, value, limit)])``: every number at or under its
    limit. A number the cell names as not compared is printed with the limit
    None; any other number without a limit fails: no check is left unheld."""
    rows = []
    ok = True
    for name, value in numbers.items():
        limit = limits.get(name)
        rows.append((name, value, limit))
        if name in not_compared:
            continue
        if limit is None or not value <= limit:
            ok = False
    return ok, rows
