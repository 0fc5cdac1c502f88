"""The traffic drawn from a seed: the same each time; every seed the same
schedule started at another place; the schedule's order drawn uniformly
(bursts kept)."""
import numpy as np

from portbench import traffic
from portbench.tests import tiny


def test_same_seed_same_requests():
    t = tiny.traffic()
    a = traffic.generate(t, 512, 2**31 + 11, 5.0)
    b = traffic.generate(t, 512, 2**31 + 11, 5.0)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert np.array_equal(x.prompt, y.prompt)
        assert (x.max_new, x.high, x.arrival_s) == \
            (y.max_new, y.high, y.arrival_s)


def test_seeds_share_sizes_and_gaps():
    t = tiny.traffic()
    a = traffic.generate(t, 512, 1, 10.0)
    b = traffic.generate(t, 512, 2, 10.0)
    assert len(a) == len(b) == 60
    assert sorted(len(r.prompt) for r in a) == \
        sorted(len(r.prompt) for r in b)
    assert sorted(r.max_new for r in a) == sorted(r.max_new for r in b)
    ga = np.diff([r.arrival_s for r in a])
    gb = np.diff([r.arrival_s for r in b])
    assert [len(r.prompt) for r in a] != [len(r.prompt) for r in b]
    assert ga.min() >= 0 and gb.min() >= 0
    # the same gaps, save the one each seed puts last
    assert len(set(np.round(ga, 9)) & set(np.round(gb, 9))) >= len(ga) - 1
    # one schedule, rotated: every request keeps its lengths and the gap
    # that follows it
    la = [(len(r.prompt), r.max_new, r.high) for r in a]
    lb = [(len(r.prompt), r.max_new, r.high) for r in b]
    k = next(k for k in range(len(la)) if la[k:] + la[:k] == lb)
    assert np.allclose(np.roll(ga, -k)[:len(ga) - k], gb[:len(ga) - k])


def test_gaps_come_in_bursts_as_a_poisson_process_does():
    """The schedule's order of gaps is uniform: runs of short gaps occur
    as often as independent exponential gaps make them, not one a
    stratum."""
    n, runs = 0, []
    for order in range(200):
        t = dict(tiny.traffic(), rate_per_s=10.0, schedule_seed=order)
        g = np.diff([r.arrival_s for r in traffic.generate(t, 512, 5,
                                                           20.0)])
        short = g < np.quantile(g, 0.2)
        # three short gaps in a row: four arrivals within a fifth's gaps
        runs.append(int(np.sum(short[:-2] & short[1:-1] & short[2:])))
        n += len(g) - 2
    # independent draws: about n * 0.2**3 such runs
    assert 0.6 < sum(runs) / (n * 0.2 ** 3) < 1.4


def test_lengths_within_clip_and_classes():
    o = traffic.generate(tiny.traffic(), 512, 7, 4.0)
    assert all(8 <= len(r.prompt) <= 48 for r in o)
    assert all(4 <= r.max_new <= 16 for r in o)
    # every 4th request HIGH, at the phase the seed's rotation gives
    k = [r.high for r in o].index(True)
    assert [r.high for r in o] == [(i - k) % 4 == 0 for i in range(len(o))]
    assert all(0 <= int(r.prompt.max()) < 512 for r in o)


def test_large_seed():
    reqs = traffic.generate(tiny.traffic(), 512, 2**40 + 3, 2.0)
    assert len(reqs) == 12


def test_the_lead_in_repeats_the_end_of_the_period():
    """With ``lead_in_s`` the requests of the period's last seconds come
    again before the window, with prompts of their own; the window's
    requests are those of a run without it."""
    t = dict(tiny.traffic(), lead_in_s=2.0)
    base = traffic.generate(tiny.traffic(), 512, 2**31 + 5, 10.0)
    got = traffic.generate(t, 512, 2**31 + 5, 10.0)
    window = [r for r in got if r.arrival_s >= 0]
    lead = [r for r in got if r.arrival_s < 0]
    assert len(window) == len(base) == 60
    for x, y in zip(window, base):
        assert np.array_equal(x.prompt, y.prompt)
        assert (x.max_new, x.high, x.arrival_s) == \
            (y.max_new, y.high, y.arrival_s)
    # one period is n / rate seconds: the window's length
    assert base[-1].arrival_s < 10.0
    tail = [r for r in base if r.arrival_s >= 10.0 - 2.0]
    assert len(lead) == len(tail) > 0
    for x, y in zip(lead, tail):
        assert abs(x.arrival_s - (y.arrival_s - 10.0)) < 1e-9
        assert (len(x.prompt), x.max_new, x.high) == \
            (len(y.prompt), y.max_new, y.high)
        assert not np.array_equal(x.prompt, y.prompt)
    assert min(r.arrival_s for r in lead) >= -2.0
