"""The port's persistent tile-op kernels (K1 drain, K2 drain + flight
recorder, K3 legacy executor), through their plain PyTorch versions on the
CPU, against the reference's Pallas kernels in interpret mode: the same
queues and workspaces, made by numpy from a seed. Acks, control words,
profile rows, ticks and from_gpu rows are exact; workspaces, results and
carries agree within rtol/atol 1e-4 (f32 sums in another order). The cases
include what the reference's numpy oracle gets wrong and its kernel does
not: out-of-range and negative tile indices and opcodes."""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.persistent as J
import repro_torch.core.mailbox as t_mb
import repro_torch.kernels.persistent as P
from repro.core import mailbox as mb
from repro_torch.kernels.persistent import kernel as PK

TILE = 128
TOL = dict(rtol=1e-4, atol=1e-4)
C, QLEN, NBUF = 2, 8, 4


def D(op, a0=0, a1=0, rid=0, **kw):
    return mb.WorkDescriptor(opcode=op, arg0=a0, arg1=a1, request_id=rid, **kw)


MIXED = [
    D(J.OP_MATMUL, *J.pack_args(3, 0, 1), rid=1),
    D(J.OP_REDUCE, J.pack_args(0, 2)[0], rid=2, n_chunks=4),
    D(J.OP_ADD, *J.pack_args(2, 0, 1), rid=3),
    D(J.OP_SCALE, *J.pack_scale(1, 1, -1.5), rid=4),
    D(J.OP_RELU, J.pack_args(0, 3)[0], rid=5),
    D(J.OP_COPY, J.pack_args(1, 2)[0], rid=6),
    D(J.OP_NOP, rid=7),
]

# indices the oracle would reject: dst=9, dst=-1, a=200, b=-1, b=7, b=-6,
# opcode -3 (clips to NOP) and 99 (clips to REDUCE), dst aliasing a and b
OUT_OF_RANGE = [
    D(J.OP_COPY, J.pack_args(9, 1)[0], rid=20),
    D(J.OP_COPY, -256 + 2, rid=21),
    D(J.OP_RELU, J.pack_args(0, 200)[0], rid=22),
    D(J.OP_ADD, J.pack_args(1, 0)[0], -1, rid=23),
    D(J.OP_MATMUL, J.pack_args(2, 2)[0], 7, rid=24, chunk=1, n_chunks=3),
    D(J.OP_MATMUL, J.pack_args(0, 0)[0], 0, rid=25),
    D(J.OP_ADD, J.pack_args(3, 3)[0], -6, rid=26),
    D(-3, J.pack_args(1, 1)[0], rid=27),
]


def _ws(seed, c=C, nbuf=NBUF):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((c, nbuf, TILE, TILE)) * 0.1).astype(
        np.float32)


def _queue(progs):
    return np.stack([mb.descriptor_ring(p, QLEN) for p in progs])


def _ctrl(windows):
    return np.stack([mb.queue_control(tail=t, head=h, stop=s)
                     for h, t, s in windows])


def _torch(*arrays):
    return [torch.from_numpy(np.array(a, copy=True)) for a in arrays]


def drain_both(progs, windows, seed=0, carry0=(0.0, 0.0), tick0=(0, 0)):
    """One drain launch through the interpret-mode Pallas flight-recorder
    kernel and through both plain versions (K1 bare, K2 profiled)."""
    ring, ctrl, ws = _queue(progs), _ctrl(windows), _ws(seed)
    carry = np.array(carry0, np.float32)[:, None]
    tick = np.array(tick0, np.int32)[:, None]
    ref = [np.asarray(x) for x in J.persistent_drain_prof(
        jnp.asarray(ctrl), jnp.asarray(ring), jnp.asarray(ws),
        jnp.asarray(carry), jnp.asarray(tick), interpret=True)]
    bare = [t.numpy() for t in PK.drain_plain(*_torch(ctrl, ring, ws, carry))]
    prof = [t.numpy() for t in PK.drain_plain(*_torch(ctrl, ring, ws, carry,
                                                       tick))]
    return ref, bare, prof, ws


def assert_drain_equal(got, ref):
    ws, carry, acks, results, ctrl = got[:5]
    np.testing.assert_allclose(ws, ref[0], **TOL)
    np.testing.assert_allclose(carry, ref[1], **TOL)
    np.testing.assert_array_equal(acks, ref[2])
    np.testing.assert_allclose(results, ref[3], **TOL)
    np.testing.assert_array_equal(ctrl, ref[4])
    if len(got) > 5:
        np.testing.assert_array_equal(got[5], ref[5])       # prof rows
        np.testing.assert_array_equal(got[6], ref[6])       # tick


CASES = {
    # (programs per cluster, (head, tail, stop) per cluster, carry0, tick0)
    "mixed": ([MIXED, MIXED[::-1]], [(0, 7, 0), (0, 7, 0)], (0.5, -0.25),
              (3, 0)),
    "window": ([MIXED, MIXED], [(1, 5, 0), (2, 3, 0)], (0.0, 1.0), (0, 9)),
    "stop": ([MIXED, MIXED], [(0, 7, 1), (0, 7, 0)], (0.0, 0.0), (0, 0)),
    "out_of_range": ([OUT_OF_RANGE, OUT_OF_RANGE[::-1]],
                     [(0, 8, 0), (0, 8, 0)], (0.0, 0.0), (5, 5)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_drain_plain_matches_interpret_pallas(case):
    progs, windows, carry0, tick0 = CASES[case]
    ref, bare, prof, ws_in = drain_both(progs, windows, carry0=carry0,
                                        tick0=tick0)
    assert_drain_equal(bare, ref)
    assert_drain_equal(prof, ref)
    drained = ref[4][:, mb.QC_DRAINED]
    assert drained.tolist() == [int(ref[5][c, :, mb.P_ACTIVE].sum())
                                for c in range(C)]
    if case == "stop":
        assert drained[0] == 0
        np.testing.assert_array_equal(ref[0][0], ws_in[0])
    if case == "out_of_range":
        assert int(drained[0]) == 8
        # dst=9 and dst=-1 both wrote the last tile, as the kernel does
        assert (ref[2][0, :, mb.W_STATUS] == mb.THREAD_FINISHED).sum() == 7


def test_drain_bare_plain_matches_bare_kernel():
    """K1's plain version against the reference's bare drain kernel (the
    profiled kernel's acks are byte-identical to it)."""
    ring, ctrl, ws = _queue([MIXED, OUT_OF_RANGE]), \
        _ctrl([(0, 7, 0), (1, 8, 0)]), _ws(1)
    carry = np.zeros((C, 1), np.float32)
    ref = [np.asarray(x) for x in J.persistent_drain(
        jnp.asarray(ctrl), jnp.asarray(ring), jnp.asarray(ws),
        jnp.asarray(carry), interpret=True)]
    got = P.persistent_drain(*_torch(ctrl, ring, ws, carry))
    assert_drain_equal([t.numpy() for t in got], ref)


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_drain_random_programs_with_aliasing(seed):
    """Random opcode/arg/chunk mixes with dst, a and b drawn from 0..3 (so
    they alias), random windows and carries."""
    rng = np.random.default_rng(seed)
    progs, windows = [], []
    for c in range(C):
        n = int(rng.integers(2, QLEN + 1))
        prog = []
        for i in range(n):
            op = int(rng.integers(0, J.NUM_DRAIN_OPS))
            dst, a, b = (int(x) for x in rng.integers(0, 4, 3))
            a0, a1 = (J.pack_scale(dst, a, float(rng.uniform(-2, 2)))
                      if op == J.OP_SCALE else J.pack_args(dst, a, b))
            n_chunks = int(rng.integers(1, 4))
            prog.append(D(op, a0, a1, rid=100 + i,
                          chunk=int(rng.integers(0, n_chunks)),
                          n_chunks=n_chunks))
        progs.append(prog)
        head = int(rng.integers(0, 2))
        windows.append((head, int(rng.integers(head, n + 1)), 0))
    ref, bare, prof, _ = drain_both(
        progs, windows, seed=seed,
        carry0=tuple(rng.uniform(-1, 1, C)), tick0=tuple(rng.integers(0, 9, C)))
    assert_drain_equal(bare, ref)
    assert_drain_equal(prof, ref)


def test_drain_carry_and_tick_across_launches():
    """The carry and tick a launch leaves behind seed the next launch, as
    the reference's aliased outputs do."""
    d = D(J.OP_REDUCE, J.pack_args(0, 1)[0], rid=9, n_chunks=8)
    ring1 = _queue([[d, d.advance()]] * C)
    ring2 = _queue([[d.advance().advance()]] * C)
    ctrl1, ctrl2 = _ctrl([(0, 2, 0)] * C), _ctrl([(0, 1, 0)] * C)
    ws = _ws(2)
    carry = np.zeros((C, 1), np.float32)
    tick = np.zeros((C, 1), np.int32)
    r1 = J.persistent_drain_prof(jnp.asarray(ctrl1), jnp.asarray(ring1),
                                 jnp.asarray(ws), jnp.asarray(carry),
                                 jnp.asarray(tick), interpret=True)
    r2 = [np.asarray(x) for x in J.persistent_drain_prof(
        jnp.asarray(ctrl2), jnp.asarray(ring2), r1[0], r1[1], r1[6],
        interpret=True)]
    tws, tcarry, ttick = _torch(ws, carry, tick)
    P.persistent_drain_prof(*_torch(ctrl1, ring1), tws, tcarry, ttick)
    t2 = P.persistent_drain_prof(*_torch(ctrl2, ring2), tws, tcarry, ttick)
    assert_drain_equal([t.numpy() for t in t2], r2)
    s = ws[:, 1].sum(axis=(1, 2))
    np.testing.assert_allclose(tcarry.numpy()[:, 0], 3 * s, rtol=1e-4)
    assert ttick.numpy()[:, 0].tolist() == [3] * C


EXEC_PROGRAMS = {
    "mixed": [[(J.OP_MATMUL, *J.pack_args(3, 0, 1)),
               (J.OP_RELU, J.pack_args(3, 3)[0], 0),
               (J.OP_MATMUL, *J.pack_args(3, 3, 3)),
               (J.OP_SCALE, *J.pack_scale(2, 3, 0.5))],
              [(J.OP_ADD, *J.pack_args(1, 0, 1)), (J.OP_COPY,
                                                   *J.pack_args(2, 1)),
               (J.OP_NOP, 0, 0), (J.OP_REDUCE, *J.pack_args(0, 1))]],
    "out_of_range": [[(J.OP_COPY, J.pack_args(9, 1)[0], 0),
                      (J.OP_ADD, -256 + 2, -1), (-4, 0, 0),
                      (J.OP_MATMUL, J.pack_args(0, 250)[0], 5)],
                     []],
}


@pytest.mark.parametrize("case", list(EXEC_PROGRAMS))
def test_execute_plain_matches_interpret_pallas(case):
    """K3: the 6-op table (REDUCE clips to COPY), one from_gpu row per
    cluster counting every work row, NOP opcodes included."""
    q = J.build_queue(EXEC_PROGRAMS[case], 6)
    np.testing.assert_array_equal(P.build_queue(EXEC_PROGRAMS[case], 6), q)
    ws = _ws(7)
    ref_ws, ref_fg = J.persistent_execute(jnp.asarray(q), jnp.asarray(ws),
                                          interpret=True)
    got_ws, got_fg = P.persistent_execute(*_torch(q, ws))
    np.testing.assert_allclose(got_ws.numpy(), np.asarray(ref_ws), **TOL)
    np.testing.assert_array_equal(got_fg.numpy(), np.asarray(ref_fg))
    assert got_fg[0, mb.W_ARG0] == 4


def test_wrappers_take_plain_path_on_cpu_in_place():
    """A CPU tensor takes the plain version (no launch is counted) and the
    workspace, carry and tick are updated in place."""
    counts = (P.persistent_drain.launches, P.persistent_drain_prof.launches,
              P.persistent_execute.launches)
    ring, ctrl, ws = _torch(_queue([MIXED] * C), _ctrl([(0, 7, 0)] * C),
                            _ws(0))
    carry = torch.zeros((C, 1))
    tick = torch.zeros((C, 1), dtype=torch.int32)
    out = P.persistent_drain_prof(ctrl, ring, ws, carry, tick)
    assert out[0] is ws and out[1] is carry and out[6] is tick
    assert tick[:, 0].tolist() == [7, 7]
    assert P.persistent_execute(ring, ws)[0] is ws
    assert (P.persistent_drain.launches, P.persistent_drain_prof.launches,
            P.persistent_execute.launches) == counts


def test_tile_state_and_helpers_match_reference():
    for seed in (None, 0, 3):
        np.testing.assert_array_equal(P.tile_state(4, seed=seed)["ws"].numpy(),
                                      np.asarray(J.tile_state(4, seed=seed)["ws"]))
    assert P.mlp_program() == J.ops.mlp_program()
    for args in ((3, 0, 1), (2, 7)):
        assert P.pack_args(*args) == J.pack_args(*args)
    assert P.pack_scale(1, 2, -1.5) == J.pack_scale(1, 2, -1.5)
    assert P.TILE_OP_NAMES == J.TILE_OP_NAMES


def test_cuda_source_constants_equal_python():
    """The layout constants spelled out in csrc/persistent.cu equal the
    mailbox's and the kernel module's."""
    src = PK.SOURCE.read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (-?\d+);", src))
    names = [n for n in consts if hasattr(t_mb, n) or hasattr(PK, n)]
    assert len(names) >= 35
    for name in names:
        want = getattr(t_mb, name) if hasattr(t_mb, name) else \
            getattr(PK, name)
        assert int(consts[name]) == want, name
