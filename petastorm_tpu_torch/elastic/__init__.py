"""Elastic pod sharding: survive a host joining or leaving mid-epoch.

Twin of ``petastorm_tpu/elastic/``. ``make_reader(elastic=True)`` (or an
:class:`ElasticConfig`) replaces the static ``cur_shard``/``shard_count``
arithmetic with a lease-based membership registry, a generation-numbered
shard map and a resharding protocol with exactly-once commits (sample
delivery is at-least-once only in the false-expiry window bounded by
``lease_s``, ``docs/parallelism.md``), all coordinated through a shared
filesystem directory: no coordinator process, no network channel. The
directory's layout, file names and records are the JAX package's, so hosts
of both packages can form one pod.

The JAX package also checks the protocol against an executable spec and
watches it at run time (the elastic monitor); that waits for the port of the
protocol monitor, and asking for it raises.
"""

from __future__ import annotations

import os

from petastorm_tpu_torch.elastic.membership import DEFAULT_LEASE_RETRY, MembershipRegistry
from petastorm_tpu_torch.elastic.shardmap import ShardMap, global_order, owner_of, stable_hash


def default_host_id():
    """A stable identity for this host: ``host<rank>`` in a
    ``torch.distributed`` world of more than one process (the rank's reader
    shard, :func:`~petastorm_tpu_torch.parallel.reader_shard_for_process`),
    else machine + pid (unique enough for single-machine pods and tests)."""
    try:
        from petastorm_tpu_torch.parallel.mesh import reader_shard_for_process
        index, count = reader_shard_for_process()
        if count > 1:
            return 'host{}'.format(index)
    except Exception:  # noqa: PT300 - torch absent or no process group: fall back
        pass
    try:
        node = os.uname().nodename
    except (AttributeError, OSError):
        node = 'host'
    return '{}-{}'.format(node, os.getpid())


class ElasticConfig(object):
    """Configuration of an elastic reader.

    :param coord_dir: the coordination directory all pod hosts can reach (an
        NFS or GCS-fuse mount). ``None`` derives ``<dataset>/_elastic`` from
        the dataset path, which suits a dataset on a shared writable
        filesystem
    :param host_id: this host's stable identity; ``None`` derives it
        (:func:`default_host_id`)
    :param lease_s: the membership lease: the longest a dead host pins its
        in-flight row groups, AND the bound on duplicate sample delivery
        after a false expiry (a host stalled longer than ``lease_s`` but
        still running may have its in-flight row groups adopted while it is
        still delivering them; commits stay exclusive)
    :param poll_s: the membership and scoreboard scan period (default
        ``lease_s / 4``)
    :param monitor: the JAX package's runtime elastic monitor, not ported:
        ``None`` (then ``PSTPU_ELASTIC_MONITOR`` or
        ``PSTPU_PROTOCOL_MONITOR`` decides) or a false value; a monitor, or
        either variable set to a true value, raises NotImplementedError
    :param retry: a :class:`~petastorm_tpu_torch.retry.RetryPolicy` for all
        lease and scoreboard I/O (default: a bounded short-backoff policy),
        so slow shared-filesystem metadata operations retry instead of
        looking like a death
    """

    __slots__ = ('coord_dir', 'host_id', 'lease_s', 'poll_s', 'monitor', 'retry')

    def __init__(self, coord_dir=None, host_id=None, lease_s=5.0, poll_s=None, monitor=None,
                 retry=None):
        if lease_s <= 0:
            raise ValueError('lease_s must be positive, got {!r}'.format(lease_s))
        if poll_s is None:
            poll_s = max(lease_s / 4.0, 0.02)
        if poll_s <= 0:
            raise ValueError('poll_s must be positive, got {!r}'.format(poll_s))
        self.coord_dir = coord_dir
        self.host_id = host_id
        self.lease_s = float(lease_s)
        self.poll_s = float(poll_s)
        self.monitor = monitor
        self.retry = retry

    def retry_policy(self):
        return self.retry if self.retry is not None else DEFAULT_LEASE_RETRY

    def describe(self):
        return ('coord_dir={} host={} lease_s={} poll_s={}'
                .format(self.coord_dir, self.host_id, self.lease_s, self.poll_s))


def _refuse_monitor(explicit):
    """The JAX package resolves the elastic monitor here, from ``explicit``
    or, when that is None, from ``PSTPU_ELASTIC_MONITOR`` (with
    ``PSTPU_PROTOCOL_MONITOR`` as the umbrella opt-in). The monitor is not
    ported: a request for one raises rather than being ignored."""
    if explicit is None:
        env = os.environ.get('PSTPU_ELASTIC_MONITOR',
                             os.environ.get('PSTPU_PROTOCOL_MONITOR', ''))
        explicit = env not in ('', '0')
    if explicit:
        raise NotImplementedError(
            'the elastic protocol monitor is not yet ported to petastorm_tpu_torch '
            '(ROADMAP.md, "protocol monitor"): pass ElasticConfig(monitor=None) and leave '
            'PSTPU_ELASTIC_MONITOR and PSTPU_PROTOCOL_MONITOR unset or 0')


def resolve_elastic(value, dataset_path=None):
    """``make_reader``'s ``elastic=`` argument as a fully resolved
    :class:`ElasticConfig`: the coordination directory derived when not
    given, the host identity filled in, a monitor request refused."""
    if value is True:
        cfg = ElasticConfig()
    elif isinstance(value, ElasticConfig):
        cfg = value
    else:
        raise ValueError('elastic= must be True or an ElasticConfig, got {!r}'.format(value))
    coord_dir = cfg.coord_dir
    if coord_dir is None:
        if dataset_path is None:
            raise ValueError('elastic=True needs a dataset on a local/shared path to derive the '
                             'coordination directory; pass ElasticConfig(coord_dir=...) '
                             'explicitly')
        coord_dir = os.path.join(dataset_path, '_elastic')
    host_id = cfg.host_id if cfg.host_id is not None else default_host_id()
    _refuse_monitor(cfg.monitor)
    return ElasticConfig(coord_dir=coord_dir, host_id=str(host_id), lease_s=cfg.lease_s,
                         poll_s=cfg.poll_s, monitor=None, retry=cfg.retry)


__all__ = ['DEFAULT_LEASE_RETRY', 'ElasticConfig', 'MembershipRegistry', 'ShardMap',
           'default_host_id', 'global_order', 'owner_of', 'resolve_elastic', 'stable_hash']
