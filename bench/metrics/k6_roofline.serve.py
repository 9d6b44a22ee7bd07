"""% of its roofline that K6 (``kernels/mamba2_ssd``) reached over the
traced window: the bounds (``bench/counts/bounds.ssd_bound``) of every
request's scans at its own prompt length, over the device time of K6's
CUDA kernels."""
from bench.trace import kernel_roofline


def read(run):
    return kernel_roofline(run, "mamba2_ssd")
