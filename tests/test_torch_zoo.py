"""PyTorch port, the hub zoo against the JAX package on the CPU (fp32):
config-name resolution (F6: every name the JAX ``get_config`` resolves,
with its nc), each zoo block and activation on the same numpy-seeded
weights and inputs (rtol/atol 1e-4, live and BN-folded), the 13 hub
configs' parameter pins (built on the meta device), whole-graph parity of
yolov3-tiny, yolov5s-transformer and yolov5s6 with their strides, the
torch-made C3TR golden, ``state_dict_from_jax`` against JAX's
``convert_state_dict`` for every zoo config, and K2's route through the P6
family's C3 blocks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multispectral_object_detection_tpu.models import activations as jact
from multispectral_object_detection_tpu.models import build_model as jbuild
from multispectral_object_detection_tpu.models import configs as jconfigs
from multispectral_object_detection_tpu.models import layers as jl
from multispectral_object_detection_tpu.models.model import (
    fuse_conv_bn as jax_fuse_conv_bn)
from multispectral_object_detection_tpu.utils.torch_import import (
    convert_state_dict)
from multispectral_object_detection_tpu_torch.models import activations as A
from multispectral_object_detection_tpu_torch.models import configs
from multispectral_object_detection_tpu_torch.models import layers as L
from multispectral_object_detection_tpu_torch.models.model import (
    build_model, fuse_conv_bn, load_reference_state_dict)
from multispectral_object_detection_tpu_torch.models.parser import (
    parse_model_config)
from multispectral_object_detection_tpu_torch.utils.jax_import import (
    state_dict_from_jax)
from tests._torch_port import (  # noqa: F401
    load, random_state_dict, share_torch_threads, to_nchw, to_nhwc)

TOL = dict(rtol=1e-4, atol=1e-4)

# ------------------------------------------------------ F6: config names
JAX_NAMES = [
    "yolov5s", "yolov5n", "yolov5x.yaml", "yolov3", "yolov3-spp",
    "yolov3-tiny", "yolov5-fpn", "yolov5_panet", "yolov5-p2", "yolov5-p6",
    "yolov5_p7", "yolov5s6", "yolov5m6", "yolov5l6", "yolov5x6",
    "yolov5s-transformer", "yolov5s_fusion_add", "yolov5l_fusion_transformer",
    "yolov5l_fusion_transformerx3", "yolov5l_fusion_transformerx3_llvip",
    "yolov5l_fusion_transformer_flir", "yolov5l_fusion_transformerx3_flir",
    "yolov5l_fusion_add_vedai", "yolov5m_fusion_transformerx3_vedai",
]


@pytest.mark.parametrize("name", JAX_NAMES)
def test_get_config_resolves_every_jax_name(name):
    for nc in (None, 5):
        assert configs.get_config(name, nc=nc) == jconfigs.get_config(
            name, nc=nc), (name, nc)


@pytest.mark.parametrize("name,nc", [
    ("yolov5l_fusion_transformerx3_llvip", 1),
    ("yolov5l_fusion_transformer_flir", 3),
    ("yolov5l_fusion_add_vedai", 9), ("yolov5s6", 80)])
def test_dataset_suffix_sets_nc(name, nc):
    assert configs.get_config(name)["nc"] == nc


@pytest.mark.parametrize("name", ["yolov9", "yolov5q", "yolov5q_fusion_add"])
def test_unknown_name_raises_the_jax_message(name):
    with pytest.raises(ValueError) as want:
        jconfigs.get_config(name)
    with pytest.raises(ValueError) as got:
        configs.get_config(name)
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------ zoo blocks
def _random_tree(shapes, rng):
    """numpy values for a flax variable tree of ShapeDtypeStructs: kernels
    ~ N(0, 1/fan_in), BatchNorm scales and variances in [0.5, 1.5], other
    leaves small."""
    def fill(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if name in ("kernel", "in_proj_w"):
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(
                np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


# name -> (port module, JAX module factory(fused), input NHWC shape(s));
# a list of shapes feeds a list of maps
BLOCKS = {
    "dwconv_s2": (lambda: L.dwconv(8, 16, 3, 2),
                  lambda f: jl.dwconv(8, 16, 3, 2, fused=f), (2, 16, 16, 8)),
    "bottleneck_csp": (lambda: L.BottleneckCSP(16, 32, n=2),
                       lambda f: jl.BottleneckCSP(16, 32, n=2, fused=f),
                       (2, 8, 8, 16)),
    "ghost_conv": (lambda: L.GhostConv(8, 16, 3, 2),
                   lambda f: jl.GhostConv(16, 3, 2, fused=f), (2, 16, 16, 8)),
    "ghost_bottleneck_s1": (lambda: L.GhostBottleneck(16, 16),
                            lambda f: jl.GhostBottleneck(16, 16, fused=f),
                            (2, 8, 8, 16)),
    "ghost_bottleneck_s2": (lambda: L.GhostBottleneck(8, 16, 3, 2),
                            lambda f: jl.GhostBottleneck(8, 16, 3, 2,
                                                         fused=f),
                            (2, 8, 8, 8)),
    "transformer_block": (lambda: L.TransformerBlock2D(8, 16, 4, 2),
                          lambda f: jl.TransformerBlock2D(8, 16, 4, 2,
                                                          fused=f),
                          (2, 4, 6, 8)),
    "c3tr": (lambda: L.C3TR(16, 16, n=2),
             lambda f: jl.C3TR(16, 16, n=2, fused=f), (2, 4, 4, 16)),
    "mixconv": (lambda: L.MixConv2d(8, 16, (1, 3, 5), 2),
                lambda f: jl.MixConv2d(8, 16, (1, 3, 5), 2), (2, 8, 8, 8)),
    "crossconv": (lambda: L.CrossConv(8, 8, 3, 1, shortcut=True),
                  lambda f: jl.CrossConv(8, 8, 3, 1, shortcut=True, fused=f),
                  (2, 8, 8, 8)),
    "crossconv_s2": (lambda: L.CrossConv(8, 16, 3, 2, g=2, e=0.5),
                     lambda f: jl.CrossConv(8, 16, 3, 2, g=2, e=0.5,
                                            fused=f), (2, 8, 8, 8)),
    "classify": (lambda: L.Classify(16, 5), lambda f: jl.Classify(5),
                 (2, 4, 4, 16)),
    "classify_list": (lambda: L.Classify(24, 5), lambda f: jl.Classify(5),
                      [(2, 4, 4, 16), (2, 2, 2, 8)]),
    "sum_weighted": (lambda: L.Sum(3, weight=True),
                     lambda f: jl.Sum(3, weight=True),
                     [(2, 4, 4, 8)] * 3),
    "sum": (lambda: L.Sum(2), lambda f: jl.Sum(2), [(2, 4, 4, 8)] * 2),
    "contract": (lambda: L.Contract(2), lambda f: jl.Contract(2),
                 (2, 8, 6, 4)),
    "expand": (lambda: L.Expand(2), lambda f: jl.Expand(2), (2, 4, 3, 8)),
    "maxpool": (lambda: L.MaxPool2d(3, 2, 1), lambda f: jl.MaxPool2d(3, 2, 1),
                (2, 9, 8, 4)),
    "zeropad": (lambda: L.ZeroPad2d((0, 1, 2, 1)),
                lambda f: jl.ZeroPad2d((0, 1, 2, 1)), (2, 5, 4, 3)),
}


def _inputs(shape, rng):
    if isinstance(shape, list):
        return [rng.standard_normal(s).astype(np.float32) for s in shape]
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("fused", [False, True], ids=["live_bn", "folded"])
@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_zoo_block_matches_jax(name, fused):
    make_port, make_jax, shape = BLOCKS[name]
    rng = np.random.default_rng(len(name))
    x = _inputs(shape, rng)
    jx = [jnp.asarray(a) for a in x] if isinstance(x, list) else jnp.asarray(x)
    jmod = make_jax(False)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jx)
    tree = _random_tree(shapes, rng)
    params, stats = tree.get("params", {}), tree.get("batch_stats", {})
    sd = state_dict_from_jax({"blocks_0": params} if params else {},
                             {"blocks_0": stats} if stats else {})
    port = make_port()
    load(port, {k[len("model.0."):]: v for k, v in sd.items()})
    if fused:
        fuse_conv_bn(port)
        params, stats = jax_fuse_conv_bn(params, stats)
        jmod = make_jax(True)
    variables = {"params": params, "batch_stats": stats} if stats else (
        {"params": params} if params else {})
    want = jax.jit(jmod.apply)(variables, jx)
    tx = [to_nchw(a) for a in x] if isinstance(x, list) else to_nchw(x)
    with torch.no_grad():
        got = port(tx)
    got = got.numpy() if got.dim() == 2 else to_nhwc(got)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_bare_batch_norms_stay_live_and_fp32_after_fuse():
    from multispectral_object_detection_tpu_torch.models.model import (
        cast_inference_params)

    m = L.BottleneckCSP(16, 32, n=1)
    fuse_conv_bn(m)
    assert m.bn is not None and m.cv1.bn is None and m.cv4.bn is None
    cast_inference_params(m, torch.bfloat16)
    assert m.bn.weight.dtype == torch.float32
    assert m.bn.running_var.dtype == torch.float32
    assert m.cv2.weight.dtype == torch.bfloat16
    with torch.no_grad():
        y = m(torch.randn(1, 16, 8, 8, dtype=torch.bfloat16))
    assert y.dtype == torch.bfloat16 and torch.isfinite(y).all()


def test_transformer_layer_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 12, 16)).astype(np.float32)
    jmod = jl.TransformerLayerSimple(16, 4)
    tree = _random_tree(jax.eval_shape(jmod.init, jax.random.PRNGKey(0),
                                       jnp.asarray(x)), rng)
    sd = state_dict_from_jax({"blocks_0": {"tr0": tree["params"]}})
    port = L.TransformerLayer(16, 4)
    load(port, {k[len("model.0.tr.0."):]: v for k, v in sd.items()})
    want = jmod.apply(tree, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ----------------------------------------------------------- activations
@pytest.mark.parametrize("name", ["silu", "hardswish", "mish"])
def test_activation_functions_match_jax(name):
    x = np.random.default_rng(0).standard_normal((2, 8, 8, 4)).astype(
        np.float32) * 4
    want = np.asarray(getattr(jact, name)(jnp.asarray(x)))
    got = getattr(A, name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def _chw(v):
    """A JAX (1, 1, 1, C) or conv (k, k, I, O) leaf in the port's layout."""
    v = np.asarray(v)
    return v.transpose(0, 3, 1, 2) if v.shape[:3] == (1, 1, 1) else \
        v.transpose(3, 2, 0, 1)


@pytest.mark.parametrize("name", ["FReLU", "AconC", "MetaAconC"])
def test_activation_modules_match_jax(name):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    jmod = getattr(jact, name)(16)
    tree = _random_tree(jax.eval_shape(jmod.init, jax.random.PRNGKey(0),
                                       jnp.asarray(x)), rng)
    port = getattr(A, name)(16)
    p, s = tree["params"], tree.get("batch_stats", {})
    sd = {}
    torch_leaf = {"kernel": "weight", "scale": "weight", "bias": "bias"}
    for k, v in p.items():
        if isinstance(v, dict):  # convs and the BatchNorm
            for leaf, val in v.items():
                sd[f"{k}.{torch_leaf[leaf]}"] = \
                    _chw(val) if leaf == "kernel" else np.asarray(val)
        else:
            sd[k] = _chw(v)
    for k, v in s.items():
        sd[f"{k}.running_mean"], sd[f"{k}.running_var"] = v["mean"], v["var"]
        sd[f"{k}.num_batches_tracked"] = np.zeros((), np.int64)
    load(port, sd)
    want = jmod.apply(tree, jnp.asarray(x))
    with torch.no_grad():
        got = port(to_nchw(x))
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), **TOL)


# ----------------------------------------------------------- the configs
PINS = [  # tests/test_model.py's counts, verified against the reference
    ("yolov3", lambda: configs.yolov3(), 61949149),
    ("yolov3-spp", lambda: configs.yolov3(spp=True), 62998749),
    ("yolov3-tiny", lambda: configs.yolov3_tiny(), 8852366),
    ("yolov5-fpn", lambda: configs.yolov5_fpn(), 50262781),
    ("yolov5-panet", lambda: configs.yolov5_panet(), 47818749),
    ("yolov5-p2", lambda: configs.yolov5_p2(), 47953533),
    ("yolov5-p7", lambda: configs.yolov5_p7(), 143955579),
    ("yolov5s6", lambda: configs.yolov5_p6("s"), 12667836),
    ("yolov5m6", lambda: configs.yolov5_p6("m"), 35917020),
    ("yolov5l6", lambda: configs.yolov5_p6("l"), 77263228),
    ("yolov5x6", lambda: configs.yolov5_p6("x"), 141821340),
    ("yolov5-p6", lambda: configs.get_config("yolov5-p6"), 77263228),
    ("yolov5s-transformer", lambda: configs.yolov5_transformer("s"), 7276861),
]


@pytest.mark.parametrize("name,make,want", PINS, ids=[p[0] for p in PINS])
def test_hub_config_parameter_pins(name, make, want):
    m = build_model(make(), device="meta")
    assert sum(p.numel() for p in m.parameters()) == want


def test_tiny_and_p7_strides():
    assert parse_model_config(configs.yolov3_tiny()).strides == (16, 32)
    assert parse_model_config(configs.yolov5_p7()).strides == (
        8, 16, 32, 64, 128)


@pytest.mark.parametrize("name,img,strides", [
    ("yolov3-tiny", 64, (16, 32)), ("yolov5s-transformer", 64, (8, 16, 32)),
    ("yolov5s6", 128, (8, 16, 32, 64))])
def test_whole_graph_matches_jax(name, img, strides):
    cfg = configs.get_config(name, nc=3)
    port = build_model(cfg)
    assert port.spec.strides == strides
    sd = random_state_dict(port, 1)
    load(port, sd)
    params, stats = convert_state_dict(sd)
    jm = jbuild(cfg)
    x = np.random.default_rng(0).random((2, img, img, 3)).astype(np.float32)
    want = jax.jit(lambda p, s, a: jm.apply({"params": p, "batch_stats": s},
                                            a))(params, stats, jnp.asarray(x))
    with torch.no_grad():
        got = port(to_nchw(x).contiguous(memory_format=torch.channels_last))
    assert len(got) == len(strides)
    for g, w, s in zip(got, want, strides):
        assert g.shape == (2, img // s, img // s, 3, 8)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_c3tr_golden_pins_the_port():
    """tests/data/c3tr_golden.npz: a torch-made mini Focus->Conv->C3TR->Detect
    net's state dict, input and raw outputs ((B, na, ny, nx, no) there)."""
    import json
    from pathlib import Path

    data = Path(__file__).parent / "data"
    z = np.load(data / "c3tr_golden.npz")
    cfg = json.loads((data / "c3tr_golden_cfg.json").read_text())
    port = build_model(cfg)
    load_reference_state_dict(port, {k: z[k] for k in z.files
                                     if not k.startswith("__")})
    with torch.no_grad():
        feats = port(torch.from_numpy(z["__input__"]))
    for i, f in enumerate(feats):
        np.testing.assert_allclose(f.numpy().transpose(0, 3, 1, 2, 4),
                                   z[f"__out{i}__"], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("name", [p[0] for p in PINS])
def test_state_dict_bridge_round_trips_every_zoo_config(name):
    """Port layout -> JAX convert_state_dict -> state_dict_from_jax is the
    identity, and the JAX model's own trees (a repeated row's modules are
    blocks_{i}_{j} there) map onto the port's keys and shapes (at width
    1/16, so the trees stay small)."""
    cfg = dict(configs.get_config(name, nc=3))
    cfg["width_multiple"] = 0.0625
    port = build_model(cfg)
    sd = random_state_dict(port, 2)
    back = state_dict_from_jax(*convert_state_dict(sd))
    kept = {k for k in sd if not k.endswith("num_batches_tracked")}
    assert set(back) == kept
    for k in kept:
        np.testing.assert_array_equal(back[k], sd[k])
    want = jax.eval_shape(jbuild(cfg).init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 256, 256, 3)))
    zeros = jax.tree.map(lambda a: np.zeros(a.shape, np.float32), want)
    jax_sd = state_dict_from_jax(zeros["params"], zeros["batch_stats"])
    assert {k: v.shape for k, v in jax_sd.items()} == {
        k: sd[k].shape for k in kept}


def test_c3_kernel_routes_the_p6_c3_blocks():
    """yolov5l6 with use_c3_kernel: once fused, the bottlenecks of the
    backbone's C3 blocks with a shortcut take K2 (c_ = 64, 128, 256 and
    384, the P6 width new to K2); at the s scale the c_ = 32 ones do not,
    and the fused forward through K2's plain twin equals the
    convolutions'."""
    big = build_model(configs.get_config("yolov5l6"), device="meta",
                      use_c3_kernel=True)
    fuse_conv_bn(big)
    widths = {b.cv1.conv.out_channels for b in big.modules()
              if isinstance(b, L.Bottleneck) and b.takes_kernel}
    assert widths == {64, 128, 256, 384}
    cfg = configs.get_config("yolov5s6", nc=2)
    ref = build_model(cfg)
    load(ref, random_state_dict(ref, 4))
    k2 = build_model(cfg, use_c3_kernel=True)
    k2.load_state_dict(ref.state_dict())
    ref.fuse(), k2.eval().fuse()
    taking = [b for b in k2.modules()
              if isinstance(b, L.Bottleneck) and b.takes_kernel]
    assert {b.cv1.conv.out_channels for b in taking} == {64, 128, 192}
    x = torch.rand(1, 3, 128, 128)
    with torch.no_grad():
        for a, b in zip(k2(x), ref(x)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def test_int8_weights_reach_the_bare_convs():
    """``quantize_int8`` turns BottleneckCSP's and MixConv2d's bare convs
    int8 too; their forwards dequantize (within 2e-2 of fp32)."""
    from multispectral_object_detection_tpu_torch.models.quantize import (
        quantize_int8)

    for make in (lambda: L.BottleneckCSP(16, 32, n=2),
                 lambda: L.MixConv2d(16, 32, (1, 3, 5))):
        ref = make()
        load(ref, random_state_dict(ref, 5))
        q = make()
        q.load_state_dict(ref.state_dict())
        quantize_int8(q.eval())
        assert not any(isinstance(m, torch.nn.Conv2d) and "weight" in
                       m._parameters for m in q.modules())
        x = torch.randn(2, 16, 8, 8)
        with torch.no_grad():
            a, b = q(x), ref(x)
        assert (a - b).abs().max() <= 2e-2 * b.abs().max()


def test_p6_constructors_serve_on_the_cpu():
    """hubconf's P6 family (the root hubconf.py's constructors): yolov5s6
    serves a frame through Detector.__call__; the others name their
    configs."""
    from multispectral_object_detection_tpu_torch import hubconf

    det = hubconf.yolov5s6(img_size=128, device="cpu", dtype=torch.float32)
    assert det.model.spec.strides == (8, 16, 32, 64)
    frame = np.random.default_rng(0).integers(0, 256, (96, 120, 3),
                                              dtype=np.uint8)
    res = det([frame])
    assert len(res) == 1 and np.isfinite(res.boxes[0]).all()
    for name in ("yolov5s6", "yolov5m6", "yolov5l6", "yolov5x6"):
        assert getattr(hubconf, name).__name__ == name
