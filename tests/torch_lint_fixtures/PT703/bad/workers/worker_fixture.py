import time

from petastorm_tpu_torch import observability as obs
from petastorm_tpu_torch.observability.trace import record_span


def process_item(worker, args, ctx):
    t0 = time.time()
    worker.process(*args)
    # orphan: the raw emitter stamps no TraceContext
    record_span('decode', 'worker', t0, time.time() - t0)


def decode_block(block, ctx):
    # orphan: hand-rolled identity diverges from the propagated context
    with obs.stage('decode', cat='worker', trace=ctx.trace, parent=ctx.span):
        return block.decode()
