"""The end-to-end reader on synthetic timelines: a stall moves it, every
gap of every stream counts; the knee sweep's time to first token counts
a shed request as the longest time the run saw."""
import math

from portbench import spec, traffic
from portbench.serve import Run, StreamRec, pctl, ttfts
from portbench.tests import tiny


def _rec(i, due, times, high=False, shed=False):
    req = traffic.Request(i, None, 8, high, 0.0)
    r = StreamRec(req, i, due, times=[(t, 0) for t in times],
                  first=times[0] if times else None, shed=shed)
    return r


def _run(streams, t_stop=20.0):
    run = Run(tiny.cell(), 1, 10.0, t0=0.0, t_end=10.0,
              streams=streams, t_stop=t_stop)
    return run


def read(name, run):
    return spec.metric_reader(name)(run)


def steady(stall_at=None, stall=0.0):
    """20 requests, one every 0.5 s, 10 tokens each 20 ms apart; with a
    stall, every token due after ``stall_at`` comes ``stall`` s later."""
    out = []
    for i in range(20):
        due = 0.5 * i
        times = [due + 0.1 + 0.02 * k for k in range(10)]
        if stall_at is not None:
            times = [t + stall if t >= stall_at else t for t in times]
        out.append(_rec(i, due, times, high=i % 4 == 0))
    return out


def test_a_stall_moves_the_itl_tail():
    base = _run(steady())
    # a stall of 1.5 s inside the decodes of several streams at once
    stalled = _run(steady(stall_at=4.15, stall=1.5))
    assert read("itl_p95_ms", stalled) >= read("itl_p95_ms", base)
    assert max(g for r in stalled.streams for g in
               [b - a for (a, _), (b, _) in zip(r.times, r.times[1:])]) \
        >= 1.5
    # a stall between many gaps moves the tail
    slow = _run(steady())
    for r in slow.streams[4:12]:
        r.times = [(t + 0.2 * k, n) for k, (t, n) in enumerate(r.times)]
    assert read("itl_p95_ms", slow) > read("itl_p95_ms", base)


def test_itl_p95_is_the_tail_of_all_gaps():
    run = _run([_rec(0, 0.0, [0.1 + 0.01 * k for k in range(100)] + [3.0])])
    # 100 gaps of 10 ms, one of ~1.91 s: the 95th percentile is 10 ms
    assert math.isclose(read("itl_p95_ms", run), 10.0, rel_tol=1e-6)
    for k in range(10):
        run.streams.append(_rec(k + 1, 0.0, [0.1, 1.1]))
    assert read("itl_p95_ms", run) >= 1000.0


def test_shed_counts_as_the_longest_wait():
    streams = steady()
    run = _run(streams, t_stop=25.0)
    base = pctl(ttfts(run), 95)
    for r in streams[:2]:
        r.shed = True
    v = pctl(ttfts(run), 95)
    # 2 of 20 shed (10%): the p95 is a shed one's wait to the stop
    assert v > base
    assert math.isclose(v, 25.0 - streams[1].due, rel_tol=1e-9)


def test_requests_and_gaps_outside_the_window_do_not_count():
    streams = steady()
    streams.append(_rec(99, 12.0, [30.0, 31.0]))
    run = _run(streams)
    assert ttfts(run) == ttfts(_run(steady()))
    assert read("itl_p95_ms", run) == read("itl_p95_ms", _run(steady()))
