"""The benchmark's FLOP and byte counts pinned by hand-worked numbers."""

from __future__ import annotations

import pytest

from benchmark.harness import arith
from benchmark.harness.models import ref_sd_config
from benchmark.harness.spec import cell, load_bench


def _sd15():
    return ref_sd_config(cell("train-exp1", load_bench())["config"])


def unet_row_by_hand() -> dict[str, float]:
    """One SD-1.5 UNet row (one CFG half) at 512 px, 77 context tokens, by
    the architecture: 2 FLOPs a multiply-add, each product counted once."""
    conv = lambda hw, cin, cout, k: 2.0 * hw * cin * cout * k * k
    lin = lambda m, cin, cout: 2.0 * m * cin * cout
    out = {"conv": 0.0, "linear": 0.0, "geglu": 0.0, "attention": 0.0}
    t = 77

    def resnet(hw, cin, cout):
        out["conv"] += conv(hw, cin, cout, 3) + conv(hw, cout, cout, 3) + (conv(hw, cin, cout, 1) if cin != cout else 0)
        out["linear"] += lin(1, 1280, cout)  # time_emb_proj

    def transformer(hw, c):
        out["conv"] += 2 * conv(hw, c, c, 1)  # proj_in, proj_out
        out["linear"] += 4 * lin(hw, c, c)  # attn1 q, k, v, out
        out["linear"] += 2 * lin(hw, c, c) + 2 * lin(t, 768, c)  # attn2 q, out; k, v of the context
        out["attention"] += 2 * 2.0 * hw * hw * c + 2 * 2.0 * hw * t * c  # QK^T and PV, self then cross
        out["geglu"] += lin(hw, c, 8 * c) + lin(hw, 4 * c, c)  # proj [d, 2I] and out [I, d], I = 4d

    hw = {0: 64 * 64, 1: 32 * 32, 2: 16 * 16, 3: 8 * 8}
    ch = (320, 640, 1280, 1280)
    out["conv"] += conv(hw[0], 4, 320, 3)
    out["linear"] += lin(1, 320, 1280) + lin(1, 1280, 1280)  # time embedding
    skips, cur = [320], 320
    for i, c in enumerate(ch):
        for _ in range(2):
            resnet(hw[i], cur, c)
            cur = c
            if i < 3:
                transformer(hw[i], c)
            skips.append(c)
        if i < 3:
            out["conv"] += conv(hw[i + 1], c, c, 3)  # stride-2 downsample
            skips.append(c)
    resnet(hw[3], 1280, 1280)
    transformer(hw[3], 1280)
    resnet(hw[3], 1280, 1280)
    for i, c in enumerate(reversed(ch)):
        level = 3 - i
        for _ in range(3):
            resnet(hw[level], cur + skips.pop(), c)
            cur = c
            if i > 0:
                transformer(hw[level], c)
        if i < 3:
            out["conv"] += conv(hw[level - 1], c, c, 3)  # upsample, then conv at the doubled size
    out["conv"] += conv(hw[0], 320, 4, 3)
    return out


def test_unet_row_flops_equal_the_hand_count():
    by_hand = unet_row_by_hand()
    # conv 443.9, linear 79.8, GEGLU 153.5, attention 126.1 GFLOP
    assert by_hand == {"conv": 443_946_106_880, "linear": 79_763_537_920, "geglu": 153_511_526_400,
                       "attention": 126_052_270_080}
    counted = arith.unit_flops(_sd15(), (224, 112, 256), "text_encoder")["unet"]
    assert counted == pytest.approx(sum(by_hand.values()), rel=1e-12)
    assert counted == pytest.approx(803_273_441_280)


def test_flash_launch_at_the_true_head_dim():
    # [8, 4096, 8, 40] forward with lse: 2 products of 2*B*H*S*T*D FLOPs
    assert arith.flash_flops(8, 4096, 4096, 8, 40, "fwd_lse") == 2 * 2 * 8 * 8 * 4096 * 4096 * 40
    # q, o: 8*4096*8*40*2 bytes each; k, v the same; lse 8*8*4096 fp32
    assert arith.flash_bytes(8, 4096, 4096, 8, 40, "fwd_lse") == 4 * 20_971_520 + 1_048_576
    # exponential-bound: 8*8*4096^2 exps at 3.9e12/s = 0.2753 ms (not the
    # 0.165 ms of its products, which padding to D = 48 would make 0.198)
    assert arith.flash_bound_s(8, 4096, 4096, 8, 40, "fwd_lse") == pytest.approx(1_073_741_824 / 3.9e12)
    assert arith.flash_bound_s(8, 4096, 4096, 8, 40, "fwd_lse") * 1e3 == pytest.approx(0.27532, abs=1e-5)
    # the backward: 5 products, ops-bound at 0.4343 ms (PERF.md's K6 row)
    assert arith.flash_bound_s(8, 4096, 4096, 8, 40, "bwd") * 1e3 == pytest.approx(0.43427, abs=1e-5)


def test_geglu_k5_and_k4_bounds():
    # K5 at [32768, 320] (I = 1280): dproj and dx, 2 x 2*M*d*2I = 107.4 GFLOP
    flops, nbytes = arith.geglu_cost(32768, 320, 1280, "dx")
    assert flops == 2 * 2 * 32768 * 320 * 2560
    assert nbytes == 2 * (32768 * 320 + 2560 * 320 + 2560 + 32768 * 1280 + 32768 * 320)
    assert arith.geglu_bound_s(32768, 320, 1280, "dx") * 1e3 == pytest.approx(0.10857, abs=1e-5)
    # K4 at [16384, 320]: one product, 26.8 GFLOP, 0.0271 ms
    assert arith.geglu_bound_s(16384, 320, 1280, "fwd") * 1e3 == pytest.approx(0.027142, abs=1e-6)


def test_unet_ops_are_the_flash_and_geglu_shapes():
    ops = arith.unet_ops(_sd15().unet)
    assert sorted(ops["flash"]) == sorted([(4096, 4096, 8, 40)] * 5 + [(1024, 1024, 8, 80)] * 5)
    assert len(ops["geglu"]) == 16
    assert sum(1 for m, d, i in ops["geglu"] if (m, d, i) == (4096, 320, 1280)) == 5
