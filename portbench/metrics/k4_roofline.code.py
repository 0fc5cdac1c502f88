"""K4 (decode attention) at its roofline: the least time of every layer's
decode attention over the decoding rows at their lengths, for the steps
in the window, over the device time of K4's kernels by name."""
from portbench import work


def read(run):
    if not run.trace:
        return None
    dev = run.trace["kernel_s"].get("k4", 0.0)
    pk = work.peak(run.device_kind)
    least = run.model["num_layers"] * sum(
        work.least_s(work.k4(run.model, lens), pk)
        for t, lens in run.steps if lens and run.in_window(t))
    return 100.0 * least / dev if dev > 0 and least > 0 else None
