"""The yardstick against counts by hand at small shapes."""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from benchmark.arith import bounds, lthm

CONFIGS = Path(__file__).resolve().parent.parent / "configs"


def test_bench_flash_bias_bound_by_hand():
    # B=1, T=4, H=2, hd=8, one KV head, table of 9 rows, bf16, causal:
    # pairs 10; forward: 2 products * 2 * 8 * 2 * 10 = 640 flops;
    # bytes: q, o (2*64*2) + k, v (2*32*2) + lse (4*2*4) + table (9*2*4) = 256+128+32+72 = 488
    t = bounds.flash_bias_s("flash_bias_fwd", 1, 4, 2, 8, 1, 9)
    assert t == pytest.approx(max(488 / 3.35e12, 640 / 989e12))
    t = bounds.flash_bias_s("flash_bias_dkv", 1, 4, 2, 8, 1, 9)
    assert t == pytest.approx(max((2 * 128 + 4 * 64 + 2 * 32 + 2 * 72) / 3.35e12, 4 * 320 / 989e12))


def test_bench_ce_bound_by_hand():
    n, d = 1024, 64
    rows = 2 * n * d * 2 + n
    assert bounds.ce_s("ce_fwd", n, d) == pytest.approx(
        max((rows + 8 * n + 4 + 12 * n) / 3.35e12, 2 * n * n * d / 989e12))
    assert bounds.ce_s("ce_dq", n, d) == bounds.ce_s("ce_dc", n, d)
    with pytest.raises(ValueError):
        bounds.ce_s("ce_other", n, d)


def test_bench_lthm_shapes_and_flops_by_hand():
    cfg = json.loads((CONFIGS / "lthm_long.json").read_text())["model_config"]
    s = lthm.shapes(cfg, users=64, history=1024)
    assert (s.t, s.hd, s.ff, s.ce_n, s.ce_calls, s.window) == (1025, 16, 2048, 32768, 12, 1025)
    per_pos = 16 * 2 * (2 * 512 * 512 + 512 * 32 + 2 * 512 * 2048) + 2 * 512 * 6 * 128
    towers = 64 * 1025 * per_pos + 64 * 1024 * 2 * 512 * 512
    attn = 16 * 64 * 2 * 2 * 16 * 32 * (1025 * 1026 // 2)
    product = 64 * 1024 * 2 * (32 * 512 + 32 * 192 + 512 * 128)
    assert lthm.forward_flops(s) == towers + attn + product
    assert lthm.ce_flops(s) == 12 * 3 * 2 * 32768**2 * 128
    assert lthm.train_flops(s) == 3 * lthm.forward_flops(s) + lthm.ce_flops(s)
    # the training step's attention bound holds the forward's
    assert lthm.attention_bound_s(s, True) > lthm.attention_bound_s(s, False) > 0


def test_bench_prod_context_reads_the_config():
    cfg = json.loads((CONFIGS / "lthm_prod.json").read_text())["model_config"]
    s = lthm.shapes(cfg, users=64, history=768)
    assert (s.context, s.t, s.window, s.ce_n) == (512, 513, 513, 16384)
