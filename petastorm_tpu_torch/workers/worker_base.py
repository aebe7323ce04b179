"""Worker protocol shared by the pools (twin of ``petastorm_tpu/workers/worker_base.py``)."""

from __future__ import annotations


class WorkerBase(object):
    """A worker processes one ventilated item per ``process`` call and
    publishes zero or more results via ``publish_func``.

    :param worker_id: ordinal of this worker in the pool
    :param publish_func: callable(result) delivering a result to the consumer
    :param args: pool-wide setup arguments
    """

    def __init__(self, worker_id, publish_func, args):
        self.worker_id = worker_id
        self.publish_func = publish_func
        self.args = args

    def process(self, *args, **kwargs):
        raise NotImplementedError

    def publish(self, data):
        self.publish_func(data)

    def shutdown(self):
        """Called once when the pool stops; release worker-held resources."""
