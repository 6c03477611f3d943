"""gather_roofline.agent: the lookup kernel (csrc/table_gather.cu) on the search's leaves, least time by bytes over kernel time (%)."""

from benchmark.layer_metrics import gather_roofline


def read(ctx):
    return gather_roofline(ctx)
