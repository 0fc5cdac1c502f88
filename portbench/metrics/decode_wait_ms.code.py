"""Time the host blocks on the card for a decode step: the mean duration
of the program's ``repro_torch.rt.wait.decode`` spans that start in the
traced window (``program_spans``)."""


def read(run):
    prog = (run.trace or {}).get("program")
    return prog["decode_wait_ms"] if prog else None
