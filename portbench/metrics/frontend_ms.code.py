"""The stream frontend's own host time a poll: the mean duration of the
``repro_torch.streams.poll`` spans that start in the traced window, less
what the ``repro_torch.engine.*`` spans inside each cover
(``program_spans``)."""


def read(run):
    prog = (run.trace or {}).get("program")
    return prog["frontend_ms"] if prog else None
