from deciphon_tpu_torch.db.dispatch import db_typeid, open_db
from deciphon_tpu_torch.db.format import TensorDB, write_db
from deciphon_tpu_torch.db.partition import balanced_partitions, bucket_by_core_size

__all__ = [
    "TensorDB", "write_db", "db_typeid", "open_db",
    "balanced_partitions", "bucket_by_core_size",
]
