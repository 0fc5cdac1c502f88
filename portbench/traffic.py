"""The one traffic generator: a traffic file's parameters and a seed in,
the requests of a run out.

An open loop: ``n = round(rate_per_s * seconds)`` requests, each due at
its scheduled arrival (seconds from the window's start), one period of
``n / rate_per_s`` seconds. With ``lead_in_s`` the last ``lead_in_s``
seconds of that period come once more before the window (arrivals below
0, prompts of their own), so the window opens on the load it would carry
were the schedule repeated, not on an empty system: whatever the
rotation, the window then holds one whole period at its steady state.

Every seed gets the same requests in the same order, started at another
place: prompt and output lengths are the quantiles of a clipped
lognormal (``median``, ``sigma``, ``min``, ``max``) at ``(i + 0.5) / n``,
the gaps between arrivals those of an exponential at ``rate_per_s``; the
traffic's ``schedule_seed`` (0 where it names none) draws one uniform
order of each list, so the gaps follow one another as a Poisson
process's do, with its bursts; every ``high_every``-th request of that
order is HIGH. The run's seed draws where in that schedule the window
starts (a rotation of the lists and the classes together) and the
prompts' token ids. So two seeds ask for the same work with the same
bursts, the same requests overlapping and the same requests HIGH, and
the seed does not change how much of it coincides.
"""
from __future__ import annotations

from dataclasses import dataclass
from statistics import NormalDist

import numpy as np


@dataclass
class Request:
    index: int
    prompt: np.ndarray           # int32 token ids
    max_new: int
    high: bool
    arrival_s: float             # due time from the window start


def quantiles(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def lengths(dist: dict, n: int) -> np.ndarray:
    """The ``n`` lengths of a clipped lognormal, at its quantiles, sorted."""
    nd = NormalDist()
    z = np.array([nd.inv_cdf(float(q)) for q in quantiles(n)])
    v = np.round(dist["median"] * np.exp(dist["sigma"] * z))
    return np.clip(v, dist["min"], dist["max"]).astype(np.int64)


def arrival_gaps(rate: float, n: int) -> np.ndarray:
    """The ``n`` gaps of a Poisson process at ``rate``, at their quantiles,
    scaled to sum to ``n / rate`` (the quantiles' mean falls a little
    short of the exponential's)."""
    g = -np.log1p(-quantiles(n))
    return g * (n / rate / g.sum())


def count(traffic: dict, seconds: float) -> int:
    return max(1, int(round(traffic["rate_per_s"] * seconds)))


def generate(traffic: dict, vocab: int, seed: int,
             seconds: float) -> list[Request]:
    n = count(traffic, seconds)
    order = np.random.default_rng(int(traffic.get("schedule_seed", 0)))
    prompt_len = order.permutation(lengths(traffic["prompt_tokens"], n))
    out_len = order.permutation(lengths(traffic["output_tokens"], n))
    gaps = order.permutation(arrival_gaps(traffic["rate_per_s"], n))
    every = int(traffic.get("high_every", 0))
    high = np.arange(n) % every == 0 if every else np.zeros(n, bool)
    rng = np.random.default_rng(int(seed))
    shift = -int(rng.integers(n))
    prompt_len, out_len, gaps, high = (
        np.roll(a, shift) for a in (prompt_len, out_len, gaps, high))
    arrivals = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    period = float(gaps.sum())

    def request(i, index, at):
        return Request(index, rng.integers(0, vocab, int(prompt_len[i]),
                                           dtype=np.int32),
                       int(out_len[i]), bool(high[i]), at)
    out = [request(i, i, float(arrivals[i])) for i in range(n)]
    lead = float(traffic.get("lead_in_s", 0.0))
    return [request(i, i - n, float(arrivals[i]) - period)
            for i in range(n) if arrivals[i] >= period - lead] + out
