"""95th percentile of every gap between consecutive tokens a stream was
delivered, over every stream, of the gaps that end in the window."""
from portbench.serve import itl_gaps, pctl


def read(run):
    g = itl_gaps(run)
    return pctl(g, 95) * 1e3 if g else None
