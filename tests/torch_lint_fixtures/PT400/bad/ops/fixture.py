"""Host work inside CUDA-graph captures, in both capture forms.

Each ``<kind>_block(graph, x)`` captures into ``graph`` with
``torch.cuda.graph`` and returns the captured output; each
``<kind>_step(x)`` is captured by ``graph_<kind>_step(x)`` through
``torch.cuda.make_graphed_callables``. ``chip_smoke.py`` captures each one
on the card and checks the symptom its kind predicts."""
import random
import time

import numpy as np
import torch


def clock_block(graph, x):
    with torch.cuda.graph(graph):
        out = x + time.perf_counter()
    return out


def host_rng_block(graph, x):
    with torch.cuda.graph(graph):
        out = x + float(np.random.rand())
    return out


def sync_block(graph, x):
    with torch.cuda.graph(graph):
        out = x * 2
        out = out / out.sum().item()
    return out


def reseed_block(graph, x):
    with torch.cuda.graph(graph):
        torch.manual_seed(1234)
        out = x + torch.rand_like(x)
    return out


def clock_step(x):
    return x + time.perf_counter()


def host_rng_step(x):
    return x + random.random()


def sync_step(x):
    torch.cuda.synchronize()
    return x * 2


def reseed_step(x):
    torch.cuda.manual_seed(1234)
    return x + torch.rand_like(x)


def graph_clock_step(x):
    return torch.cuda.make_graphed_callables(clock_step, (x,))


def graph_host_rng_step(x):
    return torch.cuda.make_graphed_callables(host_rng_step, (x,))


def graph_sync_step(x):
    return torch.cuda.make_graphed_callables(sync_step, (x,))


def graph_reseed_step(x):
    return torch.cuda.make_graphed_callables(reseed_step, (x,))
