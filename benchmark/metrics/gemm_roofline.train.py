"""Matrix-product operations of the training steps over the GEMM
category's device time at the fp32 peak, in %."""
from benchmark import readers
from benchmark.frozen import flops as F


def read(run):
    return readers.roofline(run, "GEMM", F.matmul_forward_flops)
