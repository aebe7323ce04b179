"""HDFS namenode resolution and high-availability failover.

Twin of ``petastorm_tpu/hdfs/namenode.py``: Hadoop site configuration found
from the environment, nameservice -> namenode-list resolution, and a client
wrapper that fails over to the standby namenode when an operation raises an
IO error (at most 2 failovers, round-robin reconnect).

HDFS is reached through ``pyarrow.fs.HadoopFileSystem`` (Arrow C++
libhdfs). The connector is injectable, so the HA machinery is testable with
no Hadoop, and failover wraps each call through ``__getattr__`` proxying.
"""

from __future__ import annotations

import logging
import os
import xml.etree.ElementTree as ET
from urllib.parse import urlparse

logger = logging.getLogger(__name__)

#: maximum failover attempts before an operation is abandoned
MAX_FAILOVER_ATTEMPTS = 2

#: environment variables probed, in order, for a Hadoop installation
_HADOOP_ENV_VARS = ('HADOOP_HOME', 'HADOOP_PREFIX', 'HADOOP_INSTALL')


class HdfsConnectError(IOError):
    """Raised when no namenode of a nameservice accepts a connection."""


class MaxFailoversExceeded(RuntimeError):
    """Raised when an operation kept failing after exhausting failover attempts."""

    def __init__(self, failed_exceptions, max_failover_attempts, func_name):
        self.failed_exceptions = failed_exceptions
        self.max_failover_attempts = max_failover_attempts
        self.__name__ = func_name
        message = 'Failover attempts exceeded maximum ({}) for action "{}". ' \
                  'Exceptions: {}'.format(max_failover_attempts, func_name, failed_exceptions)
        super().__init__(message)


class HadoopConfiguration(dict):
    """Flat dict of Hadoop config properties parsed from ``hdfs-site.xml`` and
    ``core-site.xml``."""

    @classmethod
    def from_environment(cls):
        """Locate a Hadoop installation via HADOOP_HOME/HADOOP_PREFIX/
        HADOOP_INSTALL (or an explicit HADOOP_CONF_DIR) and parse its site
        files. Returns an empty configuration when none is found."""
        conf = cls()
        conf_dir = os.environ.get('HADOOP_CONF_DIR')
        if conf_dir is None:
            for env in _HADOOP_ENV_VARS:
                if env in os.environ:
                    conf_dir = os.path.join(os.environ[env], 'etc', 'hadoop')
                    break
        if conf_dir is None:
            logger.warning(
                'No Hadoop installation found (checked HADOOP_CONF_DIR, %s). '
                'Namenode resolution will be empty.', ', '.join(_HADOOP_ENV_VARS))
            return conf
        for name in ('hdfs-site.xml', 'core-site.xml'):
            conf.load_site_xml(os.path.join(conf_dir, name))
        return conf

    def load_site_xml(self, xml_path):
        """Merge ``<property><name>/<value>`` pairs from a Hadoop site file."""
        try:
            root = ET.parse(xml_path).getroot()
        except (ET.ParseError, OSError) as e:
            logger.error('Could not parse Hadoop site file %s: %s', xml_path, e)
            return
        for prop in root.iter('property'):
            name, value = prop.find('name'), prop.find('value')
            if name is not None and value is not None:
                self[name.text] = value.text


class HdfsNamenodeResolver(object):
    """Resolves HDFS nameservices to concrete namenode ``host:port`` lists."""

    def __init__(self, hadoop_configuration=None):
        if hadoop_configuration is None:
            hadoop_configuration = HadoopConfiguration.from_environment()
        self._conf = hadoop_configuration

    def resolve_hdfs_name_service(self, nameservice):
        """Namenode ``host:port`` list for a nameservice, or ``None`` when the
        name is not a configured nameservice (it may simply be a hostname)."""
        namenode_ids = self._conf.get('dfs.ha.namenodes.' + nameservice)
        if not namenode_ids:
            return None
        namenodes = []
        for nn in namenode_ids.split(','):
            key = 'dfs.namenode.rpc-address.{}.{}'.format(nameservice, nn.strip())
            address = self._conf.get(key)
            if not address:
                raise RuntimeError(
                    'Inconsistent Hadoop configuration: "{}" lists namenode "{}" but '
                    'property "{}" is missing'.format(nameservice, nn, key))
            namenodes.append(address)
        return namenodes

    def resolve_default_hdfs_service(self):
        """``(nameservice, namenode list)`` for ``fs.defaultFS``."""
        default_fs = self._conf.get('fs.defaultFS')
        if not default_fs:
            raise RuntimeError('Hadoop configuration has no "fs.defaultFS" property; '
                               'cannot resolve a default HDFS service')
        nameservice = urlparse(default_fs).netloc
        namenodes = self.resolve_hdfs_name_service(nameservice)
        if namenodes is None:
            raise IOError('Unable to resolve namenodes of default service "{}"'.format(default_fs))
        return nameservice, namenodes


def _is_io_error(exc):
    """IO-shaped errors trigger failover; programming errors do not. Arrow C++
    raises OSError subclasses (pyarrow.lib.ArrowIOError is an alias of OSError
    in modern Arrow)."""
    return isinstance(exc, OSError)


def namenode_failover(func):
    """Decorator for :class:`HAHdfsClient` proxy methods: on IO error,
    reconnect to the next namenode (round-robin) and retry, up to
    :data:`MAX_FAILOVER_ATTEMPTS` reconnects."""

    def wrapper(client, *args, **kwargs):
        failures = []
        while True:
            try:
                return func(client, *args, **kwargs)
            except Exception as e:  # noqa: BLE001 - filtered just below
                if not _is_io_error(e):
                    raise
                failures.append(e)
                if len(failures) > MAX_FAILOVER_ATTEMPTS:
                    # wrapper.__name__ is patched to the proxied method's name
                    raise MaxFailoversExceeded(failures, MAX_FAILOVER_ATTEMPTS,
                                               wrapper.__name__)
                # HdfsConnectError (every namenode refused the reconnect) is
                # terminal — _do_failover already tried the whole ring
                client._do_failover(e)

    wrapper.__name__ = getattr(func, '__name__', 'wrapped')
    return wrapper


class HAHdfsClient(object):
    """Filesystem facade with namenode failover.

    Proxies every attribute of the underlying filesystem; callables are wrapped
    so an IO error reconnects round-robin to the next namenode and retries.
    """

    def __init__(self, connector_cls, list_of_namenodes, user=None):
        if not list_of_namenodes:
            raise HdfsConnectError('HAHdfsClient requires at least one namenode')
        self._connector_cls = connector_cls
        self._list_of_namenodes = list(list_of_namenodes)
        self._user = user
        self._index_of_nn = -1
        self._filesystem = None
        self._do_failover()  # initial connect = failover from "nowhere"

    def _do_failover(self, cause=None):
        """Advance round-robin to the next namenode that accepts a connection.
        Trying every namenode (not just the next) means the initial connect —
        and any reconnect — survives a hard-down first-listed namenode."""
        connect_errors = []
        for _ in range(len(self._list_of_namenodes)):
            self._index_of_nn = (self._index_of_nn + 1) % len(self._list_of_namenodes)
            namenode = self._list_of_namenodes[self._index_of_nn]
            if cause is not None:
                logger.warning('HDFS operation failed (%s); failing over to namenode %s',
                               cause, namenode)
            try:
                self._filesystem = self._connector_cls.hdfs_connect_namenode(
                    namenode, user=self._user)
                return
            except OSError as e:
                connect_errors.append((namenode, e))
        raise HdfsConnectError('Unable to connect to any namenode of {}: {}'.format(
            self._list_of_namenodes, connect_errors))

    # pickling support for spawned worker processes: reconnect on unpickle
    def __getstate__(self):
        return {'connector_cls': self._connector_cls,
                'list_of_namenodes': self._list_of_namenodes,
                'user': self._user}

    def __setstate__(self, state):
        self.__init__(state['connector_cls'], state['list_of_namenodes'], state['user'])

    def __getattr__(self, name):
        # only called for attributes NOT found on HAHdfsClient itself
        attr = getattr(self._filesystem, name)
        if not callable(attr):
            return attr

        @namenode_failover
        def proxied(client, *args, **kwargs):
            # re-fetch from the *current* filesystem: failover replaces it
            return getattr(client._filesystem, name)(*args, **kwargs)

        proxied.__name__ = name
        return lambda *args, **kwargs: proxied(self, *args, **kwargs)


class HdfsConnector(object):
    """Namenode connection factory.
    Subclass and override :meth:`hdfs_connect_namenode` to inject mocks."""

    # connection timeouts are libhdfs configuration; two namenodes is the
    # HA convention
    MAX_NAMENODES = 2

    @classmethod
    def hdfs_connect_namenode(cls, url_or_address, user=None):
        """Connect to one namenode. Accepts ``host:port``, ``hdfs://host:port``
        or ``user@host:port`` (URI userinfo wins only when ``user`` is None)."""
        import pyarrow.fs as pafs
        if '://' not in url_or_address:
            url_or_address = 'hdfs://' + url_or_address
        parsed = urlparse(url_or_address)
        host = parsed.hostname or 'default'
        port = parsed.port or 8020
        return pafs.HadoopFileSystem(host, port, user=user or parsed.username)

    @classmethod
    def connect_to_either_namenode(cls, list_of_namenodes, user=None):
        """Try each namenode once and return the first filesystem that answers;
        raise :class:`HdfsConnectError` when all fail."""
        errors = []
        for namenode in list_of_namenodes[:cls.MAX_NAMENODES]:
            try:
                return cls.hdfs_connect_namenode(namenode, user=user)
            except OSError as e:
                errors.append((namenode, e))
        raise HdfsConnectError(
            'Unable to connect to any namenode of {}: {}'.format(list_of_namenodes, errors))

    @classmethod
    def connect_ha_client(cls, list_of_namenodes, user=None):
        """An :class:`HAHdfsClient` bound to this connector."""
        return HAHdfsClient(cls, list_of_namenodes, user=user)


def as_pyarrow_filesystem(ha_client):
    """Wrap an :class:`HAHdfsClient` into a genuine ``pyarrow.fs.FileSystem``
    (via ``PyFileSystem``/``FileSystemHandler``) so pyarrow APIs that validate
    their ``filesystem=`` argument (``pq.write_to_dataset`` etc.) accept it.
    Every handler call rides the HA proxy, so failover still applies."""
    import pyarrow.fs as pafs

    from petastorm_tpu_torch.pafs_util import DelegatingHandler

    class _HaHandler(DelegatingHandler):
        # self.fs is the HAHdfsClient: same method surface as a pyarrow
        # filesystem (its __getattr__ proxies the live HadoopFileSystem with
        # failover), so the shared delegation base applies verbatim

        def get_type_name(self):
            return 'ha-hdfs'

        def __eq__(self, other):
            return isinstance(other, _HaHandler) and \
                self.fs._list_of_namenodes == other.fs._list_of_namenodes

        def __ne__(self, other):
            return not self.__eq__(other)

        def __hash__(self):
            # __eq__ without __hash__ would make the handler (and the
            # PyFileSystem over it) unhashable (PT600)
            return hash((type(self), tuple(self.fs._list_of_namenodes or ())))

    return pafs.PyFileSystem(_HaHandler(ha_client))


def resolve_and_connect(dataset_url, hadoop_configuration=None, connector=HdfsConnector,
                        user=None, pyarrow_wrap=False):
    """Resolve an ``hdfs://`` URL to an HA filesystem + path.

    ``hdfs://nameservice/path`` with a configured HA nameservice yields an
    :class:`HAHdfsClient` over its namenodes; ``hdfs:///path`` (no netloc) uses
    ``fs.defaultFS``; a plain ``hdfs://[user@]host:port/path`` connects
    directly. ``pyarrow_wrap=True`` returns HA clients wrapped as genuine
    pyarrow filesystems (:func:`as_pyarrow_filesystem`).
    """
    parsed = urlparse(dataset_url)
    if parsed.scheme != 'hdfs':
        raise ValueError('Not an hdfs:// URL: {}'.format(dataset_url))
    resolver = HdfsNamenodeResolver(hadoop_configuration)
    # case-preserving host extraction: parsed.hostname lowercases, but Hadoop
    # nameservice config keys are case-sensitive; bracketed IPv6 literals keep
    # their colons
    host_port = parsed.netloc.rpartition('@')[2]
    if host_port.startswith('['):
        nameservice = host_port[1:host_port.index(']')] if ']' in host_port else host_port
    else:
        nameservice = host_port.partition(':')[0]
    if not parsed.netloc:
        _, namenodes = resolver.resolve_default_hdfs_service()
    else:
        namenodes = resolver.resolve_hdfs_name_service(nameservice)
    user = user or parsed.username
    if namenodes:
        client = HAHdfsClient(connector, namenodes, user=user)
        return (as_pyarrow_filesystem(client) if pyarrow_wrap else client), parsed.path
    # not a nameservice: direct host[:port] connection, no HA wrapping
    return connector.hdfs_connect_namenode(parsed.netloc, user=user), parsed.path
