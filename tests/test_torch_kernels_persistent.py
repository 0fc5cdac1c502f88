"""The port's persistent tile-op kernels (K1 drain, K2 drain + flight
recorder, K3 legacy executor), through their plain PyTorch versions on the
CPU, against the reference's Pallas kernels in interpret mode: the same
queues and workspaces, made by numpy from a seed. Acks, control words,
profile rows, ticks and from_gpu rows are exact; workspaces, results and
carries agree within rtol/atol 1e-4 (f32 sums in another order). The cases
include what the reference's numpy oracle gets wrong and its kernel does
not: out-of-range and negative tile indices and opcodes.

K1-K3 form tile products in 3xTF32 on the card; a numpy emulation of that
split, in each kernel's order of sums, holds the plain drain and the plain
executor to their f32 selves on ``chip_smoke.py``'s queues before any card
time is spent."""
import importlib.util
import re
from pathlib import Path

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


def test_reference_oracle_names_copy_their_inputs():
    """The reference's oracle names give its oracles' results and, as
    there, leave the workspace, carry and tick they were given unchanged;
    K2's oracle requires its tick."""
    ring, ctrl, ws = _queue([MIXED, MIXED[::-1]]), \
        _ctrl([(0, 7, 0), (1, 6, 0)]), _ws(2)
    carry = np.array([[0.5], [-0.25]], np.float32)
    tick = np.array([[3], [0]], np.int32)
    args = _torch(ctrl, ring, ws, carry, tick)
    before = [a.clone() for a in args]
    got = P.persistent_drain_prof_ref(*args)
    assert_drain_equal([t.numpy() for t in got], [
        np.asarray(x) for x in J.persistent_drain_prof_ref(
            ctrl, ring, ws, carry, tick)])
    got = P.persistent_drain_ref(*args[:4])
    assert_drain_equal([t.numpy() for t in got], [
        np.asarray(x) for x in J.persistent_drain_ref(ctrl, ring, ws, carry)])
    with pytest.raises(TypeError):
        P.persistent_drain_prof_ref(*args[:4])
    ws_out, fromgpu = P.persistent_execute_ref(args[1], args[2])
    ref = J.persistent_execute_ref(ring, ws)
    np.testing.assert_allclose(ws_out.numpy(), np.asarray(ref[0]), **TOL)
    np.testing.assert_array_equal(fromgpu.numpy(), np.asarray(ref[1]))
    for a, b in zip(args, before):
        assert torch.equal(a, b)


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


# csrc/persistent.cu's own geometry (no Python counterpart), held to what
# the kernels rely on below, and its error codes
GEOMETRY = {"DRAIN_WARPS_M", "DRAIN_WARPS_N", "RING_STAGES", "RING_KB",
            "RING_A_LD", "RING_B_LD", "SMALL_BUFFERS", "EXEC_CONSUMERS",
            "EXEC_KB", "EXEC_STAGES", "EXEC_FRESH_K", "EXEC_SMEM_ALIGN",
            "EXEC_BAR_BYTES"}
ERROR_CODES = {"ERR_NO_ENCODER", "ERR_ENCODE"}
H100_SMEM_OPTIN = 232448     # bytes of shared memory a block may opt into
H100_REGS = 65536            # 32-bit registers of an SM


def _source_constants() -> dict:
    """Every top-level ``constexpr int`` of csrc/persistent.cu, evaluated
    in order (literals, or C++ integer expressions of the ones before)."""
    src = PK.SOURCE.read_text()
    consts = {}
    for name, expr in re.findall(r"^constexpr int (\w+)\s*=\s*([^;]+);", src,
                                 re.M):
        consts[name] = int(eval(expr.replace("/", "//"),
                                {"__builtins__": {}}, dict(consts)))
    return consts


def test_cuda_source_constants_equal_python():
    """Every constant spelled out in csrc/persistent.cu is covered: a
    literal equals the mailbox's or the kernel module's constant of the
    same name, or is one of the kernel's geometry constants checked in
    ``test_cuda_ring_geometry``; the rest are expressions of those."""
    src = PK.SOURCE.read_text()
    consts = _source_constants()
    literals = dict(re.findall(r"^constexpr int (\w+) = (-?\d+);", src, re.M))
    assert {int(literals[n]) for n in ERROR_CODES} == {-2, -3}
    names = [n for n in consts if hasattr(t_mb, n) or hasattr(PK, n)]
    assert len(names) >= 35
    for name in names:
        want = getattr(t_mb, name) if hasattr(t_mb, name) else \
            getattr(PK, name)
        assert consts[name] == want, name
    assert set(literals) <= set(names) | GEOMETRY | ERROR_CODES, \
        set(literals) - set(names) - GEOMETRY - ERROR_CODES
    assert GEOMETRY <= set(literals)


def test_cuda_ring_geometry():
    """K1/K2's warp grid covers the 128 x 128 product in m16n8 tiles; the
    operand ring holds a stage per k-block of one whole product with
    16-byte rows for cp.async, and mma.sync fragment reads on 32 distinct
    banks (A [m][k]: lane = 4 g + t reads row g, column t; B [k][n]: row
    t, column g); ring and small-half buffers take more shared memory than
    the 48 KB static limit but no more than a block may opt into.

    K3: two consumer warpgroups of 64 product rows (wgmma m64n128) and a
    producer warp; a k-block row is one 128-byte swizzle row of f32; the
    fresh accumulators cover whole 8-deep steps; raw stages, two split
    buffers (big and small halves of A and Bᵀ) and the barriers fit the
    opt-in from a 1024-byte-aligned base; 224 registers a thread fit the
    SM; the split's B chunks land on 8 distinct 16-byte bank groups for
    the 8 lanes of a phase (row n, chunk c ^ n % 8)."""
    k = _source_constants()
    assert k["EXEC_CONSUMERS"] * 64 == TILE
    assert k["EXEC_THREADS"] == 128 * k["EXEC_CONSUMERS"] + 32
    assert k["EXEC_THREADS"] * 224 <= H100_REGS
    assert k["EXEC_KB"] * 4 == 128 and TILE % k["EXEC_KB"] == 0
    assert k["EXEC_KB"] % k["EXEC_FRESH_K"] == 0
    assert k["EXEC_FRESH_K"] % 8 == 0 and k["EXEC_STAGES"] >= 2
    assert k["EXEC_KBLOCK_BYTES"] == TILE * k["EXEC_KB"] * 4
    assert k["EXEC_SMEM_BYTES"] == k["EXEC_SMEM_ALIGN"] + \
        k["EXEC_STAGES"] * 2 * k["EXEC_KBLOCK_BYTES"] + \
        2 * 4 * k["EXEC_KBLOCK_BYTES"] + k["EXEC_BAR_BYTES"]
    assert 48 * 1024 < k["EXEC_SMEM_BYTES"] <= H100_SMEM_OPTIN
    assert k["EXEC_KBLOCK_BYTES"] % k["EXEC_SMEM_ALIGN"] == 0
    assert 2 * k["EXEC_STAGES"] * 8 + 4 <= k["EXEC_BAR_BYTES"]
    assert k["EXEC_UNITS"] * k["EXEC_CONSUMER_THREADS"] == \
        2 * TILE * k["EXEC_KB"] // 4
    for c in range(8):
        groups = {((n % 8) * 128 + ((c ^ (n % 8)) << 4)) // 16 % 8
                  for n in range(8)}
        assert len(groups) == 8
    assert k["DRAIN_NT"] == 32 * k["DRAIN_WARPS_M"] * k["DRAIN_WARPS_N"]
    assert k["WARP_MT"] * 16 * k["DRAIN_WARPS_M"] == TILE
    assert k["WARP_NT"] * 8 * k["DRAIN_WARPS_N"] == TILE
    assert k["DRAIN_NT"] * 128 <= H100_REGS       # 128 registers a thread
    assert k["RING_STAGES"] * k["RING_KB"] == TILE
    assert k["RING_A_LD"] >= k["RING_KB"] and k["RING_B_LD"] >= TILE
    assert k["RING_A_LD"] % 4 == 0 and k["RING_B_LD"] % 4 == 0
    assert k["KBLOCK_FLOATS"] // 4 % k["DRAIN_NT"] == 0
    pairs = [(g, t) for g in range(8) for t in range(4)]
    assert len({(g * k["RING_A_LD"] + t) % 32 for g, t in pairs}) == 32
    assert len({(t * k["RING_B_LD"] + g) % 32 for g, t in pairs}) == 32
    assert k["STAGE_FLOATS"] == TILE * k["RING_A_LD"] + \
        k["RING_KB"] * k["RING_B_LD"]
    assert k["DRAIN_SMEM_BYTES"] == 4 * k["STAGE_FLOATS"] * (
        k["RING_STAGES"] + k["SMALL_BUFFERS"])
    assert 48 * 1024 < k["DRAIN_SMEM_BYTES"] + 4 * k["DRAIN_NT"] // 32 <= \
        H100_SMEM_OPTIN


# ---------------------------------------------------------------------------
# 3xTF32, emulated: what K1/K2 compute on the card, before any card time
# ---------------------------------------------------------------------------

def _tf32_rna(x):
    """``cvt.rna.tf32.f32`` on the f32 bit pattern: round to tf32's 10-bit
    mantissa, to nearest with ties away from zero (add half the range of
    the 13 dropped bits to the magnitude, then clear them); inf and NaN
    pass unchanged."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    finite = (u & np.uint32(0x7F800000)) != np.uint32(0x7F800000)
    r = np.where(finite, (u + np.uint32(0x1000)) & np.uint32(0xFFFFE000), u)
    return r.astype(np.uint32).view(np.float32)


def _split(x):
    """x = big + small, both tf32, and big masked to 0 where it is not
    finite: small is 0 there, and the masked big is what the cross terms
    take, so inf * small (inf * 0, or inf of the wrong sign) never makes
    NaN."""
    big = _tf32_rna(x)
    finite = np.isfinite(big)
    with np.errstate(invalid="ignore"):
        small = _tf32_rna(np.where(finite, x - big, 0).astype(np.float32))
    zero = np.float32(0)
    return big, np.where(finite, small, zero), np.where(finite, big, zero)


def _bmm_3xtf32(A, B):
    """The kernel's tile product: a_small @ b_big' + a_big' @ b_small +
    a_big @ b_big (small @ small dropped; ' is the masked big), summed in
    f64 and rounded to f32 once, so that what differs from the f32 plain
    version is the split's own error and not a third summation order."""
    ab, as_, abm = (t.astype(np.float64) for t in _split(A.numpy()))
    bb, bs, bbm = (t.astype(np.float64) for t in _split(B.numpy()))
    with np.errstate(invalid="ignore", over="ignore"):
        return torch.from_numpy(
            ((as_ @ bbm + abm @ bs) + ab @ bb).astype(np.float32))


def _chip_smoke():
    """``chip_smoke.py``'s queue builders (importing it needs no card)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_tf32_rna_rounds_to_nearest_ties_away():
    ulp = 2.0 ** -10                       # tf32's ulp at 1.0
    x = np.array([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2 ** -20,
                  1 + 3 * ulp / 2, np.inf, -np.inf,
                  np.finfo(np.float32).max], np.float32)
    want = np.array([1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, np.inf, -np.inf,
                     np.inf], np.float32)
    np.testing.assert_array_equal(_tf32_rna(x), want)
    assert np.isnan(_tf32_rna(np.array([np.nan], np.float32)))[0]
    assert (_tf32_rna(x[:4]).view(np.uint32) & 0x1FFF == 0).all()
    # big + small carries 21-22 significant bits of x
    x = np.random.default_rng(0).standard_normal(4096).astype(np.float32)
    big, small, _ = _split(x)
    np.testing.assert_allclose(big.astype(np.float64) + small, x,
                               rtol=2.0 ** -20, atol=0)


def test_3xtf32_propagates_inf_as_ffma_does():
    """An inf operand gives inf, not NaN, in the row it reaches, as f32
    math does: small is 0 where big is not finite (x - big would be NaN),
    and the cross terms take that big as 0 (inf * b_small is NaN where
    b_small is 0, and -inf where it is negative)."""
    rng = np.random.default_rng(1)
    A = rng.uniform(0.5, 1, (1, TILE, TILE)).astype(np.float32)
    B = rng.uniform(0.5, 1, (1, TILE, TILE)).astype(np.float32)
    A[0, 3, 7] = np.inf
    got = _bmm_3xtf32(torch.from_numpy(A), torch.from_numpy(B)).numpy()
    want = A @ B
    assert np.isposinf(got[0, 3]).all() and np.isposinf(want[0, 3]).all()
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], **TOL)


@pytest.mark.parametrize("queue", ["matmul", "mixed", "chained"])
def test_3xtf32_drain_matches_plain_on_smoke_queues(queue, monkeypatch):
    """The plain drain with its tile products formed as the card forms
    them (3xTF32) against the plain drain in f32, on the first clusters of
    ``chip_smoke.py``'s queues (its builders, seed 0; the chained queue on
    its scaled workspace): ints equal, floats within the card's 1e-4."""
    cs = _chip_smoke()
    inp = cs.tile_inputs(C=4, device="cpu")
    ctrl, ring = inp[queue]
    ws = inp["ws"] * (cs.CHAIN_SCALE if queue == "chained" else 1.0)

    def drain():
        return PK.drain_plain(ctrl, ring, ws.clone(), inp["carry"].clone(),
                              inp["tick"].clone())

    want = drain()
    monkeypatch.setattr(torch, "bmm", _bmm_3xtf32)
    got = drain()
    for g, w in zip(got, want):
        if g.dtype == torch.int32:
            assert torch.equal(g, w)
        else:
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
    assert not torch.equal(got[0], want[0])      # the split did take effect
    assert float(want[0].abs().max()) < 1e4


def _trunc_f32(x):
    """f64 -> f32 rounded toward zero (the tensor cores' sums)."""
    r = x.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(x)
    r[over] = np.nextafter(r[over], np.float32(0))
    return r


def _k3_product(D, A, B, fresh_k, kb=32):
    """K3's D + A @ B as the card forms it: acc starts as D; each 32-deep
    k-block is summed in fresh accumulators of fresh_k depth, each 8-deep
    step adding small·big', big'·small, big·big in that order into the
    fresh sum with truncation; each fresh sum is added to acc in f32,
    rounded to nearest."""
    ab, as_, abm = (t.astype(np.float64) for t in _split(A))
    bb, bs, bbm = (t.astype(np.float64) for t in _split(B))
    acc = D.astype(np.float32)
    for k0 in range(0, TILE, fresh_k):
        p = np.zeros(D.shape, np.float32)
        for t in range(k0, k0 + fresh_k, 8):
            sl = slice(t, t + 8)
            for x, y in ((as_, bbm), (abm, bs), (ab, bb)):
                p = _trunc_f32(p + x[..., sl] @ y[..., sl, :])
        acc = (acc + p).astype(np.float32)
    return acc


def _execute_k3(queue, ws, fresh_k):
    """The executor over queues of MATMUL and RELU rows, every product in
    K3's arithmetic (numpy), one cluster at a time."""
    q, w = queue.numpy(), ws.numpy().copy()
    nbuf = w.shape[1]
    idx = lambda i: min(max(i + nbuf if i < 0 else i, 0), nbuf - 1)
    for c in range(q.shape[0]):
        for row in q[c]:
            if row[mb.W_STATUS] < mb.THREAD_WORK:
                continue
            dst, a = idx(row[mb.W_ARG0] >> 8), idx(row[mb.W_ARG0] & 255)
            if row[mb.W_OPCODE] == J.OP_MATMUL:
                w[c, dst] = _k3_product(w[c, dst], w[c, a],
                                        w[c, idx(row[mb.W_ARG1])], fresh_k)
            else:
                assert row[mb.W_OPCODE] == J.OP_RELU
                w[c, dst] = np.maximum(w[c, a], 0)
    return torch.from_numpy(w)


@pytest.mark.parametrize("queue", ["demo", "matmul", "chained"])
def test_3xtf32_execute_matches_plain_on_smoke_queues(queue):
    """K3's arithmetic (3xTF32 on wgmma: D loaded into the accumulator,
    fresh sums of EXEC_FRESH_K depth, as csrc/persistent.cu sets it)
    against the plain executor in f32, on the first clusters of
    ``chip_smoke.py``'s queues (seed 0; the chained queue on its scaled
    workspace) and on its tile-MLP demo: within the card's 1e-4."""
    cs = _chip_smoke()
    fresh_k = _source_constants()["EXEC_FRESH_K"]
    if queue == "demo":
        rng = np.random.default_rng(1)
        w = np.zeros((2, 5, TILE, TILE), np.float32)
        w[:, :3] = rng.standard_normal((2, 3, TILE, TILE)) * 0.1
        ws = torch.from_numpy(w)
        ring = torch.from_numpy(P.build_queue([P.mlp_program()] * 2, 4))
    else:
        inp = cs.tile_inputs(C=2, device="cpu")
        ring = inp[queue][1][:, :16].contiguous()
        ws = inp["ws"] * (cs.CHAIN_SCALE if queue == "chained" else 1.0)
    want, fromgpu = PK.execute_plain(ring, ws.clone())
    got = _execute_k3(ring, ws, fresh_k)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert not torch.equal(got, want)            # the emulation took effect
    assert fromgpu[:, mb.W_ARG0].tolist() == [int(
        (ring[c, :, mb.W_STATUS] >= mb.THREAD_WORK).sum()) for c in range(2)]
