"""CUDA-graph captures with no host work inside, and host work outside any
capture.

``<kind>_block(graph, x)`` and ``<kind>_step(x)`` follow the bad fixture's
convention; the first replay of each equals its eager call. The in-place
writes into static buffers are how a captured graph keeps its state."""
import time

import numpy as np
import torch


def affine_block(graph, x):
    out = torch.empty_like(x)
    with torch.cuda.graph(graph):
        out[...] = x * 2 + 1          # a static buffer, written in place
    return out


def momentum_block(graph, x):
    # the graph updates this buffer in place at every replay: it is returned,
    # since a buffer the caller drops is freed while the graph still writes it
    state = torch.zeros_like(x)
    with torch.cuda.graph(graph):
        state.mul_(0.9).add_(x)
    return state


def affine_step(x):
    return torch.tanh(x) * 3 - 1


def graph_affine_step(x):
    return torch.cuda.make_graphed_callables(affine_step, (x,))


def host_inputs(shape):
    """Host clock, host RNG, a reseed and a sync, none inside a capture."""
    torch.manual_seed(int(time.time()))
    x = torch.from_numpy(np.random.rand(*shape).astype(np.float32))
    return x, float(x.sum().item())
