from deciphon_tpu_torch.parallel.mesh import ScanMesh, make_scan_mesh

__all__ = ["ScanMesh", "make_scan_mesh"]
