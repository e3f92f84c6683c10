from deciphon_tpu_torch.models.alphabet import DNA, RNA, AMINO, GeneticCode, STANDARD_CODE

__all__ = ["DNA", "RNA", "AMINO", "GeneticCode", "STANDARD_CODE"]
