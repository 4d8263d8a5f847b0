"""The benchmark's work counts against the port's numbers: FLOPs per pair
(the port's ``utils/profiling.estimate_flops`` read 224.343 GFLOPs for
l@640 and 977.771 for x@1024, on the CPU) and K1's bounds from PERF.md's
kernel table (l@640 bs16 0.8038 ms, K1.e at the x scale 0.0250 ms; the
table took the bf16 peak as 989 TFLOP/s)."""

import json

import pytest

from portbench import harness, work

CARD = work.peaks("NVIDIA H100 80GB HBM3")
TABLE_CARD = dict(CARD, bf16_flops_per_s=989e12)


def cfg(name):
    return json.loads((harness.HERE / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name,hw,gflops", [
    ("cft-l-llvip-640", (640, 640), 224.343),
    ("cft-x-llvip-1024", (1024, 1024), 977.771)])
def test_flops_per_pair(name, hw, gflops):
    assert work.flops_per_pair(cfg(name), hw) / 1e9 == pytest.approx(
        gflops, abs=5e-4)


def test_cft_widths():
    assert work.cft_widths(cfg("cft-l-llvip-640")) == [256, 512, 1024]
    assert work.cft_widths(cfg("cft-x-llvip-1024")) == [320, 640, 1280]


def test_k1_bounds_match_the_kernel_table():
    assert work.k1_bound_ms(16, [256, 512, 1024], TABLE_CARD) == \
        pytest.approx(0.8038, abs=5e-5)
    per = {k: work.bound_ms(v, TABLE_CARD) for k, v in
           work.k1_launches(16, [256, 512, 1024]).items()}
    assert per == pytest.approx({"layernorm": 0.1052, "gemm_bias": 0.1413,
                                 "gemm_gelu": 0.1876, "gemm_residual": 0.2996,
                                 "attention": 0.0701}, abs=5e-5)
    x = work.k1_launches(8, [1280])
    assert work.bound_ms(x["attention"], TABLE_CARD) == pytest.approx(
        0.0250, abs=5e-5)
    assert work.bound_ms(x["layernorm"], TABLE_CARD) == pytest.approx(
        0.0376, abs=5e-5)
    # launches per forward: 168 at three stages
    assert sum(len(v) for v in work.k1_launches(16, [256, 512, 1024])
               .values()) == 168


def test_train_flops_are_about_three_forwards():
    c = dict(cfg("cft-l-llvip-640"), depth_multiple=0.33, width_multiple=0.25)
    fwd = work.flops_per_pair(c, (64, 64))
    step = work.train_flops_per_step(c, 2, (64, 64))
    assert 2.5 * 2 * fwd < step < 3.05 * 2 * fwd
