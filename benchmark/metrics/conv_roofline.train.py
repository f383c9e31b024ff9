"""Convolution operations of the training steps over the convolution
category's device time at the fp32 peak, in %."""
from benchmark import readers
from benchmark.frozen import flops as F


def read(run):
    return readers.roofline(run, "convolution", F.conv_forward_flops)
