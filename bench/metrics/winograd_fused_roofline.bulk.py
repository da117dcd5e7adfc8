"""winograd_fused_roofline.bulk: see ``readers.kernel_roofline``."""
from bench.readers import kernel_roofline


def read(w):
    return kernel_roofline(w, "winograd_fused")
