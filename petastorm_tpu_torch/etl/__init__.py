"""ETL: dataset materialization, metadata and row-group indexing (twin of
``petastorm_tpu.etl``)."""

from petastorm_tpu_torch.etl.dataset_metadata import (  # noqa: F401
    DatasetWriter, PetastormMetadataError, RowGroupPiece, get_schema, load_row_groups,
    materialize_dataset,
)
from petastorm_tpu_torch.etl.indexer_base import RowGroupIndexerBase  # noqa: F401
from petastorm_tpu_torch.etl.rowgroup_indexers import (  # noqa: F401
    FieldNotNullIndexer, SingleFieldIndexer,
)
from petastorm_tpu_torch.etl.rowgroup_indexing import (  # noqa: F401
    build_rowgroup_index, get_row_group_indexes,
)
