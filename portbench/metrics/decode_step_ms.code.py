"""The window's seconds over the decode steps the engine ran in it (ms a
step, the host's part and any prefill between steps included)."""


def read(run):
    n = run.counters1["steps"] - run.counters0["steps"]
    return run.seconds * 1e3 / n if n > 0 else None
