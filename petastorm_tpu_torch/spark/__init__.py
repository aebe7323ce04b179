"""DataFrame -> store converter (twin of ``petastorm_tpu/spark/``)."""

from petastorm_tpu_torch.spark.dataset_converter import (DatasetConverter,  # noqa: F401
                                                         SparkDatasetConverter,
                                                         make_converter,
                                                         make_spark_converter,
                                                         register_delete_dir_handler)
