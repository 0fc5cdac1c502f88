from repro_torch.kernels.ssd_scan.kernel import ssd_chunk, ssd_chunk_plain
from repro_torch.kernels.ssd_scan.ops import ssd
from repro_torch.kernels.ssd_scan.ref import ssd_ref

__all__ = ["ssd", "ssd_chunk", "ssd_chunk_plain", "ssd_ref"]
