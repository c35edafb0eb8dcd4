"""Share (%) of the least time of the coupling work (``biot_savart_batch``
per ordered film pair at the round's columns) in the device time under the
``bench.coupling`` span (``sweep._coupling_round``)."""

from benchmark.readers import roofline


def read(ctx):
    return roofline(ctx, "bench.coupling")
