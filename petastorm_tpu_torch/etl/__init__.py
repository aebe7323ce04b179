"""ETL: dataset materialization and metadata (twin of ``petastorm_tpu.etl``)."""

from petastorm_tpu_torch.etl.dataset_metadata import (  # noqa: F401
    DatasetWriter, PetastormMetadataError, RowGroupPiece, get_schema, load_row_groups,
    materialize_dataset,
)
