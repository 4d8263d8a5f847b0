"""PyTorch port, profiling (utils/profiling.py) on the CPU: ``model_info``
parameters and ``per_layer_costs`` equal the JAX package's on the mini
single- and two-stream models; the FLOP count holds every CFT layer (the
count minus the count without the stack equals ``cft_flops``, the
analytic K1 share, exactly) and on the single-stream model lies within
15 % of XLA's cost analysis (which on a two-stream model counts the CFT
scan's body once); ``microbenchmark`` times on the CPU."""

import pytest

from multispectral_object_detection_tpu_torch.models.model import build_model
from multispectral_object_detection_tpu_torch.ops import cft_stack
from multispectral_object_detection_tpu_torch.utils import profiling
from tests._torch_port import (  # noqa: F401
    load, mini_single_weights, mini_weights, share_torch_threads)

IMG = 64
XLA_BOUND = 0.15  # |port / XLA - 1| on the single-stream model (0.140)


@pytest.fixture(scope="module", params=["two_stream", "single"])
def pair(request):
    from multispectral_object_detection_tpu.models import build_model as jb
    from multispectral_object_detection_tpu.utils import profiling as jp

    w = (mini_weights(0) if request.param == "two_stream"
         else mini_single_weights(0))
    jmodel = jb(w["cfg"])
    return dict(kind=request.param, w=w,
                port=load(build_model(w["cfg"]), w["sd"]),
                jax_info=jp.model_info(jmodel, w["params"], img_size=IMG),
                jax_rows=jp.per_layer_costs(jmodel, w["params"]))


def test_model_info_matches_jax(pair):
    got = profiling.model_info(pair["port"], img_size=IMG, verbose=True)
    want = pair["jax_info"]
    assert got["params"] == want["params"] and got["layers"] == want["layers"]
    ratio = got["flops"] / want["flops"]
    if pair["kind"] == "single":
        assert abs(ratio - 1) <= XLA_BOUND, ratio
    else:  # XLA counts one of each stage's 8 layers
        assert ratio > 5, ratio


def test_per_layer_costs_match_jax(pair):
    assert profiling.per_layer_costs(pair["port"]) == pair["jax_rows"]


def test_flops_hold_every_cft_layer(monkeypatch):
    w = mini_weights(0)
    model = load(build_model(w["cfg"]), w["sd"])
    full = profiling.estimate_flops(model, IMG)
    monkeypatch.setattr(cft_stack, "fused_cft_stack_plain",
                        lambda x, *weights, **kw: x)
    without = profiling.estimate_flops(model, IMG)
    assert full - without == profiling.cft_flops(model) > 0
    model.fuse()  # packed stages count alike
    assert profiling.cft_flops(model) == full - without
    assert profiling.model_info(model, IMG)["params"] > 0


def test_microbenchmark_times_on_the_cpu():
    import torch

    x = torch.randn(64, 64)
    assert profiling.microbenchmark(torch.mm, x, x, n=3, warmup=1)["ms"] > 0
