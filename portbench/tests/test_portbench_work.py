"""The work counters on hand-worked cases."""
import math

from portbench import work

PK = {"flops": 1000.0, "bytes_s": 100.0}
M = {"d_model": 4, "num_heads": 2, "num_kv_heads": 1, "head_dim": 2,
     "d_ff": 8, "vocab_size": 16, "num_layers": 3}


def test_matmul_and_attention_by_hand():
    assert work.matmul(3, 4, 5).flops == 2 * 3 * 4 * 5
    assert work.matmul(3, 4, 5).bytes == 4 * 5 * 2
    # causal 3 tokens: 1 + 2 + 3 = 6 (query, key) pairs, 2 heads x dim 2
    w = work.k5(M, 3)
    assert w.flops == 4 * 2 * 2 * 6
    assert w.bytes == 3 * (2 * 2 * 2 + 2 * 1 * 2) * 2
    # two rows at 5 and 7 valid keys
    w = work.k4(M, [5, 7])
    assert w.flops == 4 * 2 * 2 * 12
    assert w.bytes == 12 * 2 * 1 * 2 * 2 + 2 * 2 * 2 * 2 * 2


def test_share_is_100_at_the_bound():
    for w in (work.k5(M, 9), work.k4(M, [3, 4]), work.prefill(M, 7),
              work.decode_step(M, [2, 9, 4])):
        t = work.least_s(w, PK)
        assert t == max(w.flops / PK["flops"], w.bytes / PK["bytes_s"])
        assert math.isclose(100.0 * t / t, 100.0)
        assert 100.0 * t / (t * 1.25) < 100.0


def test_prefill_by_hand():
    d, H, Hkv, D, f, V, n = 4, 2, 1, 2, 8, 16, 3
    L = 5
    proj = 2 * L * (d * H * D + d * 2 * Hkv * D + H * D * d)
    attn = 4 * H * D * L * (L + 1) / 2
    mlp = 2 * L * d * f * 3
    w = work.prefill(M, L)
    assert w.flops == n * (proj + attn + mlp) + 2 * d * V
    weights = (d * H * D + d * 2 * Hkv * D + H * D * d + 3 * d * f) * 2
    assert w.bytes > n * weights + d * V * 2


def test_decode_step_reads_weights_once():
    one = work.decode_step(M, [4])
    two = work.decode_step(M, [4, 4])
    d, H, Hkv, D, f, V = 4, 2, 1, 2, 8, 16
    weights = M["num_layers"] * (d * H * D * 2 + d * 2 * Hkv * D
                                 + 3 * d * f) * 2 + d * V * 2
    assert one.bytes > weights
    # a second row adds its keys and values, activations and logits only
    extra = two.bytes - one.bytes
    assert extra < weights / 2


def test_peaks_table():
    pk = work.peak("NVIDIA H100 80GB HBM3")
    assert pk == {"flops": 989e12, "bytes_s": 3.35e12}
