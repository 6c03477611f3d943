"""gather_roofline.td: the lookup kernel (csrc/table_gather.cu) on the TD step's stream, least time by bytes over kernel time (%)."""

from benchmark.layer_metrics import gather_roofline


def read(ctx):
    return gather_roofline(ctx)
