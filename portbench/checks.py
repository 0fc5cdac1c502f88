"""Whether what the timed path served is correct: the served tokens
against the plain float32 reference, and the same numbers for the control
(the reference in float8, in the program's place).

Once the window has closed, a sample, drawn from the seed, of the
requests that finished (prompt and every served token), with the longest
in it, is run teacher-forced: the reference reads the prompt and the
served tokens, and each served token is judged at the position that
produced it (the prefill's last position, then each decode position).

Numbers, each against its limit in ``checks/<workload>.json``:

* ``gap_max``: the widest gap by which a served token's logit lies below
  the reference's best at its position;
* ``logit_err``: the largest relative error (2-norm over the vocabulary)
  of the logits the prefill returned at each sampled prompt's last
  position (the harness keeps each prefill's last logits on the card in
  the window);
* ``judged``: the served tokens judged, at least ``min_judged``.

The control's numbers, at the same positions: the gap of the token that
the float8 reference puts first, and its logits' error.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.model import Reference, gaps, rel_err


def sample_finished(streams: list, seed: int, served_tokens: int,
                    max_requests: int) -> list:
    """Finished, never-shed requests, drawn from the seed: the longest
    (prompt and served tokens) first, then at random, until
    ``served_tokens`` are covered or ``max_requests`` taken."""
    done = [r for r in streams if r.closed is not None and not r.shed
            and not r.failed and r.tokens]
    if not done:
        return []
    longest = max(done, key=lambda r: len(r.req.prompt) + len(r.tokens))
    rest = [r for r in done if r is not longest]
    rng = np.random.default_rng([int(seed), 2])
    order = [longest] + [rest[i] for i in rng.permutation(len(rest))]
    out, n = [], 0
    for r in order:
        if n >= served_tokens or len(out) >= max_requests:
            break
        out.append((np.asarray(r.req.prompt), list(r.tokens), r.logits))
        n += len(r.tokens)
    return out


class Tally:
    """The numbers of one side (the program, or the control)."""

    def __init__(self):
        self.gap = []
        self.logit = []
        self.judged = 0

    def numbers(self) -> dict:
        out = {"gap_max": max(self.gap) if self.gap else math.nan}
        if self.logit:
            out["logit_err"] = max(self.logit)
        out["judged"] = self.judged
        return out


def compare(config: dict, seed: int, device, finished: list,
            control: bool = False) -> dict:
    """{"program": numbers[, "control": numbers]}."""
    ref = Reference(config, seed, device)
    low = Reference(config, seed, device, precision="fp8") if control \
        else None
    prog, ctl = Tally(), Tally()
    if finished:
        seqs = [torch.as_tensor(np.concatenate(
                    [p, np.asarray(toks[:-1], np.int64)]),
                    dtype=torch.long, device=device)
                for p, toks, _ in finished]
        want = [list(range(len(p) - 1, len(p) - 1 + len(toks)))
                for p, toks, _ in finished]
        r = ref.forward(seqs, want)
        lo = low.forward(seqs, want) if low else None
        for i, (_, toks, first) in enumerate(finished):
            lg = r["logits"][i]
            prog.gap.append(float(gaps(lg, toks).max()))
            prog.judged += len(toks)
            if first is not None:
                prog.logit.append(float(rel_err(first[None].to(device),
                                                lg[:1])[0]))
            if lo:
                low_lg = lo["logits"][i]
                ctl.gap.append(float(gaps(lg, low_lg.argmax(-1)).max()))
                ctl.judged += len(toks)
                ctl.logit.append(float(rel_err(low_lg[:1], lg[:1])[0]))
        del r, lo
    out = {"program": prog.numbers()}
    if control:
        out["control"] = ctl.numbers()
    return out


def verdict(numbers: dict, checks: dict) -> tuple:
    """(correct, {name: {"value", "limit" or "min"}}) of the program's
    numbers against the limits; a number that is not finite, a limit that
    is missing, or fewer judged tokens than ``min_judged`` fails."""
    shown = {}
    ok = bool(checks.get("limits"))
    for name, lim in checks.get("limits", {}).items():
        v = numbers.get(name, math.nan)
        shown[name] = {"value": v, "limit": lim["limit"]}
        ok = ok and math.isfinite(v) and v <= lim["limit"]
    floor = int(checks.get("min_judged", 1))
    shown["judged"] = {"value": numbers.get("judged", 0), "min": floor}
    return ok and numbers.get("judged", 0) >= floor, shown
