"""The frozen arithmetic of the yardstick against hand counts at small
shapes, and the trace readers on intervals laid out by hand."""
import math

import pytest

from portbench.families import dense, hybrid, vlm
from portbench.metrics import attn_kernels_roofline
from portbench.yardstick import bounds, trace


def test_pairs_by_hand():
    assert bounds.pairs(4, True, 0) == 1 + 2 + 3 + 4
    assert bounds.pairs(4, False, 0) == 16
    assert bounds.pairs(4, True, 2) == 1 + 2 + 2 + 2
    assert bounds.pairs(3, False, 0, sk=5) == 15


def test_attention_bounds_by_hand():
    b = bounds.attention_bounds((1, 2, 4, 8), "bfloat16", True, 0)
    # q, k, v, o: 1 x 2 x 4 x 8 bf16 = 128 B each; lse 2 x 4 f32 = 32 B;
    # 2 heads x 10 causal pairs
    fwd_bytes, fwd_flops = 2 * 128 + 2 * 128 + 32, 4 * 8 * 20
    assert b["flash_fwd"]["bound_ms"] == pytest.approx(
        max(fwd_bytes / 3.35e12, fwd_flops / 989e12) * 1e3)
    dq_bytes, dkdv_bytes = 3 * 128 + 2 * 128 + 64, 2 * 128 + 4 * 128 + 64
    assert b["flash_bwd_dq"]["bound_ms"] == pytest.approx(
        max(dq_bytes / 3.35e12, 6 * 8 * 20 / 989e12) * 1e3)
    assert b["flash_bwd_dkdv"]["bound_ms"] == pytest.approx(
        max(dkdv_bytes / 3.35e12, 8 * 8 * 20 / 989e12) * 1e3)
    big = bounds.attention_bounds((4, 36, 2048, 64), "bfloat16", True, 0)
    assert big["flash_fwd"]["bound_by"] == "operations"


def test_ssd_bounds_by_hand():
    b = bounds.ssd_bounds((1, 128, 2, 64, 16), "float32")
    x, row, bc = 128 * 2 * 64 * 4, 128 * 2 * 4, 128 * 16 * 4
    states = 2 * 2 * 64 * 16 * 4          # 2 heads x 2 chunks x P x N f32
    chunks, pairs, lpn = 2 * 2, 64 * 65 // 2, 2 * 64 * 64 * 16
    want_bytes = 2 * x + row + 2 * bc + 4 * 2 + states
    want_flops = chunks * (2 * pairs * (16 + 64) + 2 * lpn)
    assert b["ssd_fwd"]["bound_bytes"] == want_bytes
    assert b["ssd_fwd"]["bound_flops"] == want_flops
    assert b["fwd_state"]["bound_flops"] + b["fwd_chunk"]["bound_flops"] \
        == want_flops
    assert b["ssd_fwd"]["bound_tf32_ms"] == pytest.approx(
        max(want_bytes / 3.35e12, want_flops / 495e12) * 1e3)


TINY = {"n_layers": 1, "d_model": 8, "n_heads": 2, "n_kv_heads": 2,
        "head_dim": 4, "d_ff": 16, "vocab": 10, "dtype": "bfloat16",
        "family": "dense"}


def test_dense_flops_by_hand():
    # q, k, v, o 8 x 8 each, gate/up/down 8 x 16; the head 8 x 10
    matmul = 4 * 64 + 3 * 128 + 80
    attn = 3 * 4 * 2 * 4 * 5 / 2          # 2 heads of 4, seq 4, causal
    assert dense.flops_per_token(TINY, 4) == pytest.approx(6 * matmul + attn)
    assert vlm.flops_per_token is dense.flops_per_token


def test_published_flops():
    import json
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run = json.load(open(os.path.join(root, "configs",
                                      "minicpm-2b.json")))["run"]
    assert dense.flops_per_token(run, 2048) == pytest.approx(
        17_481_180_672)
    run = json.load(open(os.path.join(root, "configs",
                                      "zamba2-7b-36.json")))["run"]
    assert hybrid.flops_per_token(run, 2048) == pytest.approx(
        22_878_812_928)


def test_hybrid_flops_by_hand():
    run = dict(TINY, family="hybrid", n_layers=2, attn_every=2,
               ssm_expand=2, ssm_state=2, ssm_heads=2)
    # in_proj 8 x (2*16 + 2*2 + 2), out_proj 16 x 8
    mamba = 8 * 38 + 16 * 8
    L = 64
    pairs = L * (L + 1) // 2
    ssd_fwd = pairs * 2 * 2 + 2 * (pairs * 2 * 8 + 4 * L * 8 * 2)
    shared = 4 * 64 + 3 * 128
    want = (6 * (2 * mamba + shared + 80) + 2 * 3 * ssd_fwd / L
            + 3 * 4 * 2 * 4 * 65 / 2)
    assert hybrid.flops_per_token(run, 64) == pytest.approx(want)
    assert hybrid.ssd_launches(run, 4, 64)[0]["shape"] == (4, 64, 2, 8, 2)


def test_category_of_port_kernel_names():
    assert trace.category("void flash_fwd_mma_kernel<64>(bf16 const*)") \
        == "attention (port kernels)"
    assert trace.category("void ssd_bwd_chunk_kernel<float, 64, 64>()") \
        == "SSD (port kernels)"
    assert trace.category("nvjet_hsh_128x256_64x4_1x2_h_bz_coopA_NTT") \
        == "matmul (cuBLAS)"
    assert trace.category("void at::native::vectorized_elementwise") \
        == trace.OTHER


def test_kernel_kind_and_head_dim():
    f = attn_kernels_roofline.kind_and_head_dim
    assert f("void flash_fwd_mma_kernel<64>(bf16 const*, int)") == (
        "flash_fwd", 64)
    assert f("void flash_bwd_dq_kernel<float, 112>(float const*)") == (
        "flash_bwd_dq", 112)
    assert f("void flash_bwd_dkdv_mma_kernel<128>()") == (
        "flash_bwd_dkdv", 128)
    assert f("void flash_decode_split_kernel<bf16, 64, 1, false>()") is None


def test_busy_segments_and_gaps():
    dev = [(10, 20, "a"), (15, 30, "b"), (40, 50, "c"), (45, 48, "d"),
           (90, 120, "e")]
    seg = trace.busy_segments(dev, 0, 100)
    assert seg == [(10, 30), (40, 50), (90, 100)]
    assert trace.idle_gaps(seg, 0, 100) == [(0, 10), (30, 40), (50, 90)]
    host = [(0, 100, "step"), (55, 85, "aten::item"), (60, 70, "sync")]
    assert trace.host_activity(host, (50, 90)) == "sync"
    assert trace.host_activity(host, (30, 40)) == "step"
    assert trace.host_activity([], (30, 40)) == "host idle"
    assert math.isclose(sum(e - s for s, e in seg) / 100, 0.4)
