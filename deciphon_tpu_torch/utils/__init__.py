from deciphon_tpu_torch.utils.rc import RC, DcpError
from deciphon_tpu_torch.utils.xmath import lrt, partition_size, partition_starts

__all__ = ["RC", "DcpError", "lrt", "partition_size", "partition_starts"]
