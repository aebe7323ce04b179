"""High-availability HDFS support (twin of ``petastorm_tpu/hdfs/``)."""

from petastorm_tpu_torch.hdfs.namenode import (HadoopConfiguration,  # noqa: F401
                                               HAHdfsClient, HdfsConnector,
                                               HdfsNamenodeResolver, MaxFailoversExceeded,
                                               as_pyarrow_filesystem, namenode_failover)
