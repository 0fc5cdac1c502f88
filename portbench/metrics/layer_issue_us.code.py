"""Host time to issue one layer of a decode step: the mean duration of the
``repro_torch.model.layer`` spans that decode triggers starting in the
traced window hold (``program_spans``)."""


def read(run):
    prog = (run.trace or {}).get("program")
    return prog["layer_issue_us"] if prog else None
