"""PT400 — purity of CUDA-graph captures: the port's twin of
``petastorm_tpu/analysis/jax_purity.py``.

The JAX rule checks the functions ``jit``/``pjit``/``shard_map`` trace. The
port calls none of them: its trace-once-replay-many point is the CUDA graph
(``GraphedTrainStep._capture`` in ``models/train.py``). A capture records the
kernels a block launches ONCE and every replay relaunches them: host-side
work inside the capture runs at capture time only. So this rule checks

* the body of every ``with torch.cuda.graph(...)`` block, and
* every function passed to ``torch.cuda.make_graphed_callables`` (by the
  name of a function defined in the same module, alone or in a tuple or
  list), with its nested ``def``s,

and flags there

* host clock and host RNG calls (``time.*``, ``np.random.*``, ``random.*``,
  ...): the value is read once, at capture, and frozen into the graph's
  kernel arguments, so every replay repeats it;
* sync calls (``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
  ``torch.cuda.synchronize()``): they wait for the device, which a stream
  that is capturing refuses, so the capture fails;
* generator reseeds (``manual_seed`` of torch or of a generator): a CUDA
  generator cannot be reseeded to another seed while a stream captures, and
  a reseed to its own seed is not replayed (draw outside the graph and copy
  the draw into a static buffer, as the graphed step does).

The JAX rule's third check, subscript writes to arguments, does not carry
over: an in-place write is how a captured graph updates its static buffers
(the optimizer step inside the train step's capture writes every parameter
in place), so it is the intended form here, not a fault.
"""

from __future__ import annotations

import ast

from petastorm_tpu_torch.analysis.core import Checker, attr_chain

#: dotted-call prefixes that are host-side effects under capture (the JAX
#: rule's list)
_IMPURE_PREFIXES = ('np.random.', 'numpy.random.', 'random.', 'time.',
                    'datetime.datetime.now', 'datetime.datetime.utcnow',
                    'os.urandom', 'uuid.')

#: argument-less method calls that copy to the host and wait for the device
_SYNC_METHODS = {'item', 'tolist', 'cpu', 'numpy'}

#: generator reseeds, by the last name of the call
_RESEED_CALLS = {'manual_seed', 'manual_seed_all'}


def _is_capture_block(expr, graph_aliases):
    """Is ``expr`` (a ``with`` item) a ``torch.cuda.graph(...)`` call?"""
    if not isinstance(expr, ast.Call):
        return False
    chain = attr_chain(expr.func)
    if chain is None:
        return False
    return chain == 'cuda.graph' or chain.endswith('.cuda.graph') or chain in graph_aliases


def _is_make_graphed(func):
    chain = attr_chain(func)
    return chain is not None and chain.rsplit('.', 1)[-1] == 'make_graphed_callables'


def _graph_aliases(tree):
    """Local names bound to ``torch.cuda.graph`` by ``from torch.cuda import
    graph [as name]``."""
    aliases = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module == 'torch.cuda':
            aliases.update(a.asname or a.name for a in node.names if a.name == 'graph')
    return aliases


def _captured_regions(tree):
    """``(label, nodes)`` for every capture block body and every function
    passed to ``make_graphed_callables``."""
    aliases = _graph_aliases(tree)
    by_name = {}
    regions = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            by_name.setdefault(node.name, node)
        elif isinstance(node, ast.With) \
                and any(_is_capture_block(item.context_expr, aliases) for item in node.items):
            regions.append(('the capture block at line {}'.format(node.lineno), node.body))
    seen = set()
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and _is_make_graphed(node.func) and node.args):
            continue
        arg = node.args[0]
        names = arg.elts if isinstance(arg, (ast.Tuple, ast.List)) else [arg]
        for name in names:
            if isinstance(name, ast.Name) and name.id in by_name and name.id not in seen:
                seen.add(name.id)
                fn = by_name[name.id]
                regions.append(('the graphed callable {}()'.format(fn.name), [fn]))
    return regions


class CapturePurityChecker(Checker):
    code = 'PT400'
    name = 'capture-purity'
    description = ('host clock/RNG reads, device syncs and generator reseeds inside '
                   'CUDA-graph captures (torch.cuda.graph, make_graphed_callables)')
    scope = ('*/torch/*.py', '*ops/*.py', '*parallel/*.py')

    def check(self, src):
        reported = set()
        for where, nodes in _captured_regions(src.tree):
            for top in nodes:
                for node in ast.walk(top):
                    if isinstance(node, ast.Call) and id(node) not in reported:
                        finding = self._check_call(src, node, where)
                        if finding is not None:
                            reported.add(id(node))
                            yield finding

    def _check_call(self, src, node, where):
        chain = attr_chain(node.func)
        last = (node.func.attr if isinstance(node.func, ast.Attribute)
                else node.func.id if isinstance(node.func, ast.Name) else None)
        if chain is not None and chain.startswith(_IMPURE_PREFIXES):
            return self.finding(
                src, node.lineno,
                "'{}()' inside {} runs at capture time only — its value freezes into the "
                'graph and every replay repeats it; draw on the device or copy the value '
                'into a static buffer'.format(chain, where))
        if last in _RESEED_CALLS:
            return self.finding(
                src, node.lineno,
                "'{}()' inside {} reseeds a generator, which a capture cannot replay — "
                'draw outside the graph and copy the draw into a static buffer'.format(
                    chain or '.' + last, where))
        if chain is not None and (chain == 'cuda.synchronize'
                                  or chain.endswith('.cuda.synchronize')):
            return self.finding(
                src, node.lineno,
                "'{}()' inside {} waits for the device, which a capturing stream "
                'refuses'.format(chain, where))
        if isinstance(node.func, ast.Attribute) and node.func.attr in _SYNC_METHODS \
                and not node.args and not node.keywords:
            return self.finding(
                src, node.lineno,
                '.{}() inside {} copies to the host and waits for the device, which a '
                'capturing stream refuses — keep values as device tensors'.format(
                    node.func.attr, where))
        return None


__all__ = ['CapturePurityChecker']
