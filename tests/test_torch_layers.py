"""PyTorch port, building blocks: each module against its JAX counterpart
on the same weights (fp32, CPU), live and BN-folded, and against the
reference goldens in tests/data."""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multispectral_object_detection_tpu.models import detect as jdetect
from multispectral_object_detection_tpu.models import layers as jlayers
from multispectral_object_detection_tpu.models.fusion import (
    CrossModalFusion as JaxFusion)
from multispectral_object_detection_tpu.models.model import (
    fuse_conv_bn as jax_fuse_conv_bn)
from multispectral_object_detection_tpu.utils.torch_import import (
    convert_state_dict)
from multispectral_object_detection_tpu_torch.models import layers as L
from multispectral_object_detection_tpu_torch.models.detect import (
    Detect, decode_predictions)
from multispectral_object_detection_tpu_torch.models.fusion import (
    CrossModalFusion)
from multispectral_object_detection_tpu_torch.models.model import (
    build_model, fuse_conv_bn, load_reference_state_dict)
from tests._torch_port import (  # noqa: F401
    load, random_state_dict, share_torch_threads, to_nchw, to_nhwc)

DATA = Path(__file__).parent / "data"

# name -> (port module, JAX module factory(fused), input NHWC shape)
BLOCKS = {
    "conv_k3_s2": (lambda: L.ConvBnAct(8, 16, 3, 2),
                   lambda f: jlayers.ConvBnAct(16, 3, 2, fused=f), (2, 16, 16, 8)),
    "focus": (lambda: L.Focus(3, 16, 3),
              lambda f: jlayers.Focus(16, 3, fused=f), (2, 32, 32, 3)),
    "c3_shortcut": (lambda: L.C3(16, 16, n=2),
                    lambda f: jlayers.C3(16, 16, n=2, fused=f), (2, 16, 16, 16)),
    "c3_plain": (lambda: L.C3(16, 32, n=1, shortcut=False),
                 lambda f: jlayers.C3(16, 32, n=1, shortcut=False, fused=f),
                 (2, 16, 16, 16)),
    "spp": (lambda: L.SPP(32, 32), lambda f: jlayers.SPP(32, 32, fused=f),
            (2, 8, 8, 32)),
}


@pytest.mark.parametrize("fused", [False, True], ids=["live_bn", "folded"])
@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_matches_jax(name, fused):
    make_port, make_jax, shape = BLOCKS[name]
    port = make_port()
    sd = random_state_dict(port, seed=len(name))
    load(port, sd)
    params, stats = convert_state_dict({f"model.0.{k}": v
                                        for k, v in sd.items()})
    params, stats = params["blocks_0"], stats["blocks_0"]
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    if fused:
        fuse_conv_bn(port)
        params, stats = jax_fuse_conv_bn(params, stats)
        assert not stats
        variables = {"params": params}
    else:
        variables = {"params": params, "batch_stats": stats}
    want = jax.jit(make_jax(fused).apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = port(to_nchw(x).contiguous(memory_format=torch.channels_last))
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("kind", ["upsample", "concat", "add", "add2"])
def test_graph_glue_matches_jax(kind):
    rng = np.random.default_rng(1)
    a, b, c = (rng.standard_normal((2, 4, 6, 8)).astype(np.float32)
               for _ in range(3))
    ta, tb, tc = to_nchw(a), to_nchw(b), to_nchw(c)
    port, jax_mod, targs, jargs = {
        "upsample": (L.Upsample(2), jlayers.Upsample(2), ta, jnp.asarray(a)),
        "concat": (L.Concat(), jlayers.Concat(), [ta, tb],
                   [jnp.asarray(a), jnp.asarray(b)]),
        "add": (L.Add(), jlayers.Add(), [ta, tb],
                [jnp.asarray(a), jnp.asarray(b)]),
        "add2": (L.Add2(1), jlayers.Add2(1), [ta, (tb, tc)],
                 [jnp.asarray(a), (jnp.asarray(b), jnp.asarray(c))]),
    }[kind]
    want = jax_mod.apply({}, jargs)
    np.testing.assert_array_equal(to_nhwc(port(targs)), np.asarray(want))


ANCHORS = ((10, 13, 16, 30, 33, 23), (30, 61, 62, 45, 59, 119))


def _detect_golden_outputs():
    z = np.load(DATA / "detect_golden.npz")
    head = Detect(3, ANCHORS, (8, 16), (16, 32))
    load(head, {"m.0.weight": z["w0"], "m.0.bias": z["b0"],
                "m.1.weight": z["w1"], "m.1.bias": z["b1"]})
    with torch.no_grad():
        feats = head([torch.from_numpy(z["x0"]), torch.from_numpy(z["x1"])])
    anc = np.asarray(ANCHORS, np.float32).reshape(2, 3, 2)
    return z, feats, decode_predictions(feats, anc, (8, 16)).numpy(), anc


def test_detect_decode_matches_reference_golden():
    """The reference flattens (na, ny, nx)-major, the port (ny, nx, na) as
    the JAX package: compare as sorted row sets."""
    z, _, dets, _ = _detect_golden_outputs()
    want = z["z"]
    assert dets.shape == want.shape
    for b in range(want.shape[0]):
        np.testing.assert_allclose(dets[b][np.lexsort(dets[b].T)],
                                   want[b][np.lexsort(want[b].T)],
                                   rtol=1e-4, atol=1e-4)


def test_detect_decode_matches_jax_row_for_row():
    z, feats, dets, anc = _detect_golden_outputs()
    head = jdetect.Detect(nc=3, anchors=ANCHORS, strides=(8, 16))
    params = {"params": {
        "m0": {"kernel": z["w0"].transpose(2, 3, 1, 0), "bias": z["b0"]},
        "m1": {"kernel": z["w1"].transpose(2, 3, 1, 0), "bias": z["b1"]}}}
    jfeats = jax.jit(head.apply)(
        params, [jnp.asarray(z["x0"].transpose(0, 2, 3, 1)),
                 jnp.asarray(z["x1"].transpose(0, 2, 3, 1))])
    for f, jf in zip(feats, jfeats):
        np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=1e-4,
                                   atol=1e-4)
    want = np.asarray(jdetect.decode_predictions(jfeats, anc, (8, 16)))
    np.testing.assert_allclose(dets, want, rtol=1e-4, atol=1e-4)


def test_detect_prior_bias_matches_jax_init():
    head = Detect(3, ANCHORS, (8, 16), (16, 32))
    head.init_prior_bias()
    init = jdetect._detect_bias_init(3, 3, 16.0)
    np.testing.assert_allclose(head.m[1].bias.detach().numpy(),
                               np.asarray(init(None, (24,))), rtol=1e-6)


@pytest.mark.parametrize("packed", [False, True], ids=["per_layer", "packed"])
def test_fusion_matches_reference_gpt_golden(packed):
    """tests/data/gpt_golden.npz holds a reference GPT state dict, inputs and
    outputs; it loads into the port's CrossModalFusion as it is."""
    z = np.load(DATA / "gpt_golden.npz")
    mod = CrossModalFusion(d_model=64, n_layer=2)
    load(mod, {k: z[k] for k in z.files if k not in ("rgb", "ir", "o1", "o2")})
    if packed:
        mod.pack()
    with torch.no_grad():
        o1, o2 = mod((torch.from_numpy(z["rgb"]), torch.from_numpy(z["ir"])))
    np.testing.assert_allclose(o1.numpy(), z["o1"], rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(o2.numpy(), z["o2"], rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("hw", [(16, 16), (12, 10)])
def test_fusion_matches_jax_module(hw):
    mod = CrossModalFusion(d_model=64, n_layer=2)
    sd = random_state_dict(mod, seed=3)
    load(mod, sd)
    params, _ = convert_state_dict({f"model.10.{k}": v for k, v in sd.items()})
    rng = np.random.default_rng(4)
    rgb, ir = (rng.standard_normal((2, *hw, 64)).astype(np.float32)
               for _ in range(2))
    j1, j2 = jax.jit(JaxFusion(d_model=64, n_layer=2).apply)(
        {"params": params["blocks_10"]}, (jnp.asarray(rgb), jnp.asarray(ir)))
    with torch.no_grad():
        o1, o2 = mod((to_nchw(rgb), to_nchw(ir)))
    np.testing.assert_allclose(to_nhwc(o1), np.asarray(j1), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(to_nhwc(o2), np.asarray(j2), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("fused", [False, True], ids=["live_bn", "folded"])
def test_net_golden_loads_directly(fused):
    """tests/data/net_golden.npz: a reference state dict of a mini
    single-stream config (Focus/Conv/C3/SPP/Upsample/Concat/Detect) with
    its raw outputs (B, na, ny, nx, no); the port loads it as it is."""
    z = np.load(DATA / "net_golden.npz")
    cfg = json.loads((DATA / "net_golden_cfg.json").read_text())
    model = build_model(cfg)
    load_reference_state_dict(model, {k: z[k] for k in z.files
                                      if not k.startswith("__")})
    if fused:
        model.fuse()
    with torch.no_grad():
        feats = model(torch.from_numpy(z["__input__"]))
    for i, f in enumerate(feats):
        np.testing.assert_allclose(f.numpy().transpose(0, 3, 1, 2, 4),
                                   z[f"__out{i}__"], rtol=1e-4, atol=1e-4)
