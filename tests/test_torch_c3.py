"""PyTorch port, fused C3 bottleneck (K2), weights-only int8 and TTA against
the JAX package (fp32 on the CPU unless stated): the kernel's plain version
against ``bottleneck_ref`` and the Pallas kernel in interpret mode, the C3
block and the n-scale mini model with the kernel route on, the int8
weights bit for bit, and TTA on the mini model. On a GPU, the CUDA kernel
against its plain version."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multispectral_object_detection_tpu.models import build_model as jax_build
from multispectral_object_detection_tpu.models import layers as jlayers
from multispectral_object_detection_tpu.models.model import (
    fuse_conv_bn as jax_fuse_conv_bn)
from multispectral_object_detection_tpu.models.quantize import (
    dequantize_int8)
from multispectral_object_detection_tpu.models.quantize import (
    quantize_int8 as jax_quantize_int8)
from multispectral_object_detection_tpu.ops.pallas_c3 import (
    bottleneck_pallas, bottleneck_ref)
from multispectral_object_detection_tpu.train.tta import (
    tta_forward as jax_tta_forward)
from multispectral_object_detection_tpu.utils.torch_import import (
    convert_state_dict)
from multispectral_object_detection_tpu_torch.models import configs
from multispectral_object_detection_tpu_torch.models import layers as L
from multispectral_object_detection_tpu_torch.models.fusion import (
    CrossModalFusion)
from multispectral_object_detection_tpu_torch.models.model import (
    build_model, fuse_conv_bn, load_reference_state_dict)
from multispectral_object_detection_tpu_torch.models.quantize import (
    conv_weight, quantize_int8, quantized_bytes)
from multispectral_object_detection_tpu_torch.ops import c3_bottleneck as k2
from multispectral_object_detection_tpu_torch.ops.cft_stack import (
    fused_cft_stack_plain)
from multispectral_object_detection_tpu_torch.train.tta import tta_forward
from multispectral_object_detection_tpu_torch.utils import tracing
from multispectral_object_detection_tpu_torch.utils.jax_import import (
    state_dict_from_jax)
from tests._torch_port import (  # noqa: F401
    load, mini_weights, random_state_dict, share_torch_threads, to_nchw,
    to_nhwc)

SHAPES = [(2, 16, 16, 64), (1, 10, 14, 64), (1, 8, 8, 128)]


def _k2_inputs(shape, seed):
    """x (B, H, W, C), w1 (C, C), b1, w2 (3, 3, C, C) HWIO, b2; numpy fp32."""
    rng = np.random.default_rng(seed)
    C = shape[-1]

    def f(*s, scale=1.0):
        return (rng.standard_normal(s) * scale).astype(np.float32)

    return (f(*shape), f(C, C, scale=C ** -0.5), f(C, scale=0.1),
            f(3, 3, C, C, scale=(9 * C) ** -0.5), f(C, scale=0.1))


def _torch(args, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in args]


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax_reference(shape):
    args = _k2_inputs(shape, seed=shape[2])
    got = k2.c3_bottleneck_plain(*_torch(args)).numpy()
    want = np.asarray(bottleneck_ref(*map(jnp.asarray, args)))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas_interpret(shape):
    args = _k2_inputs(shape, seed=shape[1])
    got = k2.c3_bottleneck_plain(*_torch(args)).numpy()
    want = np.asarray(bottleneck_pallas(*map(jnp.asarray, args),
                                        interpret=True))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_plain_bf16_rounding_points_match_jax_reference():
    """bf16: z and the output are rounded at the same points on both
    sides; only the order of the fp32 sums differs."""
    args = _k2_inputs((2, 16, 16, 64), seed=3)
    got = k2.c3_bottleneck_plain(*_torch(args, torch.bfloat16)).float().numpy()
    want = np.asarray(bottleneck_ref(*(jnp.asarray(a, jnp.bfloat16)
                                       for a in args)), np.float32)
    assert np.abs(got - want).max() <= 8e-3 * np.abs(want).max()


def test_wrapper_on_cpu_takes_plain_path_and_counts_nothing():
    t = _torch(_k2_inputs((1, 5, 7, 64), seed=4))
    before = tracing.counter(k2.COUNTER)
    assert torch.equal(k2.c3_bottleneck(*t), k2.c3_bottleneck_plain(*t))
    assert tracing.counter(k2.COUNTER) == before


def test_wrapper_rejects_mixed_devices():
    x, w1, b1, w2, b2 = _torch(_k2_inputs((1, 4, 4, 64), seed=5))
    with pytest.raises(ValueError):
        k2.c3_bottleneck(x, w1.to("meta"), b1, w2, b2)


def _k2_shapes(scale, img, batch):
    """(B, H, W, C) of every bottleneck that takes the kernel in the
    two-stream paper config at ``scale``, from a forward on meta tensors."""
    model = build_model(configs.yolov5_two_stream(scale), device="meta",
                        use_c3_kernel=True)
    shapes = []
    for m in model.modules():
        if isinstance(m, CrossModalFusion):
            m.stack_fn = fused_cft_stack_plain  # the kernels take no meta
        elif isinstance(m, L.Bottleneck) and m.fits_kernel:
            m.register_forward_hook(lambda mod, a, out: shapes.append(
                tuple(a[0].permute(0, 2, 3, 1).shape)))
    x = torch.empty(batch, 3, img, img, device="meta")
    with torch.no_grad():
        model(x, x)
    return shapes


# bench size of each scale, and its K2 blocks per forward
K2_BENCH = {"n": (640, 16, 6), "s": (640, 16, 12), "m": (640, 16, 12),
            "l": (640, 16, 42), "x": (1024, 8, 24)}
# shapes that reach the kernel's TMA edges: ragged boxes, an image smaller
# than one box, three and five 64-channel slabs
K2_EDGES = [(2, 17, 23, 64), (1, 3, 5, 64), (2, 24, 40, 192), (2, 24, 40, 320)]


def _meta_k2_args(shape, dtype, bias_dtype):
    C = shape[-1]
    meta = {"device": "meta", "dtype": dtype}
    return (torch.empty(shape, **meta), torch.empty(C, C, **meta),
            torch.empty(C, device="meta", dtype=bias_dtype),
            torch.empty(9, C, C, **meta),
            torch.empty(C, device="meta", dtype=bias_dtype))


@pytest.mark.parametrize("scale", sorted(K2_BENCH))
def test_check_c3_takes_every_k2_shape_at_bench_size(scale):
    """Every bottleneck that takes the kernel at the scale's bench size
    passes ``check_c3``, in bf16 with bf16 and fp32 biases and in fp32 (no
    card needed); the edge shapes of chip_smoke.py's phase 2 as well."""
    img, batch, blocks = K2_BENCH[scale]
    shapes = _k2_shapes(scale, img, batch)
    assert len(shapes) == blocks
    assert all(s[-1] % 64 == 0 for s in shapes)
    for shape in set(shapes) | set(K2_EDGES):
        for dt, bdt in ((torch.bfloat16, torch.bfloat16),
                        (torch.bfloat16, torch.float32),
                        (torch.float32, torch.float32)):
            x, w1, b1, w2, b2 = _meta_k2_args(shape, dt, bdt)
            k2.check_c3(x, w1, b1, w2, b2)
            k2.check_c3(x, w1, b1, w2.view(3, 3, *w2.shape[1:]), b2)


@pytest.mark.parametrize("case", ["channels", "mixed_dtypes", "w1_shape",
                                  "w2_shape", "bias_dtype", "bias_shape",
                                  "rank"])
def test_check_c3_refuses_what_the_kernel_does_not_take(case):
    x, w1, b1, w2, b2 = _meta_k2_args((2, 8, 8, 128), torch.bfloat16,
                                      torch.bfloat16)
    if case == "channels":  # C = 96
        x, w1, b1, w2, b2 = _meta_k2_args((2, 8, 8, 96), torch.bfloat16,
                                          torch.bfloat16)
    elif case == "mixed_dtypes":
        w2 = w2.float()
    elif case == "w1_shape":
        w1 = torch.empty(128, 64, device="meta", dtype=torch.bfloat16)
    elif case == "w2_shape":  # 9 C^2 elements, but not (9, C, C) or HWIO
        w2 = w2.view(3, 384, 128)
    elif case == "bias_dtype":
        b2 = b2.to(torch.float16)
    elif case == "bias_shape":
        b1 = torch.empty(64, device="meta", dtype=torch.bfloat16)
    else:
        x = x[0]
    with pytest.raises(ValueError):
        k2.check_c3(x, w1, b1, w2, b2)


def _counting(model):
    """Wrap each Bottleneck's kernel route with a call counter."""
    calls = []
    for m in model.modules():
        if isinstance(m, L.Bottleneck):
            def fn(*a, _fn=m.c3_fn):
                calls.append(a[0].shape)
                return _fn(*a)
            m.c3_fn = fn
    return calls


def _c3_pair():
    """The port's C3(128, 128, n=2) with and without the kernel route on one
    state dict, and the same weights as JAX trees."""
    plain, kern = L.C3(128, 128, n=2), L.C3(128, 128, n=2, use_c3_kernel=True)
    sd = random_state_dict(plain, seed=11)
    load(plain, sd)
    load(kern, sd)
    params, stats = convert_state_dict({f"model.0.{k}": v
                                        for k, v in sd.items()})
    return plain, kern, params["blocks_0"], stats["blocks_0"]


def _fuse_and_pack(module):
    fuse_conv_bn(module)
    for m in module.modules():
        if isinstance(m, L.Bottleneck):
            m.pack()
    return module


def test_c3_kernel_route_matches_plain_c3():
    plain, kern, _, _ = _c3_pair()
    _fuse_and_pack(plain)
    _fuse_and_pack(kern)
    calls = _counting(kern)
    x = to_nchw(np.random.default_rng(6).standard_normal(
        (2, 16, 16, 128)).astype(np.float32)).contiguous(
            memory_format=torch.channels_last)
    with torch.no_grad():
        want, got = plain(x), kern(x)
    assert len(calls) == 2 and not any(m.w1 is not None for m in plain.m)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5,
                               atol=2e-5)


def test_c3_kernel_route_matches_jax_pallas_c3():
    _, kern, params, stats = _c3_pair()
    _fuse_and_pack(kern)
    fparams, _ = jax_fuse_conv_bn(params, stats)
    x = np.random.default_rng(7).standard_normal(
        (2, 16, 16, 128)).astype(np.float32)
    want = jlayers.C3(128, 128, n=2, fused=True, use_pallas=True).apply(
        {"params": fparams}, jnp.asarray(x))
    with torch.no_grad():
        got = kern(to_nchw(x).contiguous(memory_format=torch.channels_last))
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


# ------------------------------------------------ n-scale mini model (64 px)
IMG, NC = 64, 2


@pytest.fixture(scope="module")
def mini():
    """JAX weights (unfused and BN-folded) of the n-scale two-stream CFT
    model, and a uint8 batch at 64 px and at 96 px."""
    w = mini_weights(0)
    assert w["cfg"] == configs.yolov5_two_stream("n", nc=NC,
                                                 fusion="transformerx3")
    rng = np.random.default_rng(1)
    ims = {s: [rng.integers(0, 256, (2, s, s, 3), dtype=np.uint8)
               for _ in range(2)] for s in (IMG, 96)}
    return dict(cfg=w["cfg"], params=w["params"], stats=w["stats"],
                fparams=w["fparams"], ims=ims, spec=jax_build(w["cfg"]).spec)


def _port_fused(mini, **kw):
    model = build_model(mini["cfg"], **kw)
    load_reference_state_dict(
        model, state_dict_from_jax(mini["params"], mini["stats"]))
    return model.fuse()


def _inputs(mini, size):
    np_x = [a.astype(np.float32) / 255.0 for a in mini["ims"][size]]
    return ([jnp.asarray(a) for a in np_x],
            [to_nchw(a).contiguous(memory_format=torch.channels_last)
             for a in np_x])


def _assert_raw_close(got, want, tol=2e-4):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=tol,
                                   atol=tol)


def test_mini_model_with_c3_kernel_matches_jax_pallas_c3(mini):
    model = _port_fused(mini, use_c3_kernel=True)
    calls = _counting(model)
    jx, tx = _inputs(mini, IMG)
    jmodel = jax_build(mini["spec"], fused=True, use_pallas=True,
                       use_pallas_c3=True)
    want = jax.jit(lambda p: jmodel.apply(
        {"params": p, "batch_stats": {}}, *jx, train=False))(mini["fparams"])
    with torch.no_grad():
        got = model(*tx)
    assert len(calls) == 6 and {s[-1] for s in calls} == {64}
    _assert_raw_close(got, want)


def _jax_q_tree(qparams, leaf):
    """The quantized JAX tree with each {"q", "s"} replaced by ``leaf`` of
    it (as a plain array tree the weight bridge reads)."""
    def is_q(x):
        return isinstance(x, dict) and set(x) == {"q", "s"}

    return jax.tree_util.tree_map(lambda x: leaf(x) if is_q(x) else x,
                                  qparams, is_leaf=is_q)


def _port_convs(model):
    return {f"model.{name}.weight": m for name, m in model.model.named_modules()
            if isinstance(m, torch.nn.Conv2d)}


@pytest.fixture(scope="module")
def jax_int8(mini):
    """The JAX package's int8 tree of the fused weights (quantized op by
    op, as the bit-for-bit test pins it; computed once for the module)."""
    return jax_quantize_int8(mini["fparams"])


def test_int8_weights_match_jax_bit_for_bit(mini, jax_int8):
    """q of every conv weight equals the JAX q of the same fused weights
    (HWIO -> OIHW), and the bf16 dequantized weights are identical."""
    model = _port_fused(mini)
    convs = _port_convs(model)
    sd = state_dict_from_jax(mini["fparams"])
    with torch.no_grad():  # the same fused weights on both sides
        for key, conv in convs.items():
            conv.weight.copy_(torch.from_numpy(sd[key]))
    quantize_int8(model)
    qparams = jax_int8
    q = state_dict_from_jax(_jax_q_tree(qparams, lambda x: x["q"]))
    # one program (its results are bit-identical to op by op here)
    deq = state_dict_from_jax(jax.jit(
        lambda t: dequantize_int8(t, jnp.bfloat16))(qparams))
    assert len(convs) > 50
    for key, conv in convs.items():
        assert conv.weight_q.dtype == torch.int8 and "weight" not in dict(
            conv.named_parameters())
        np.testing.assert_array_equal(conv.weight_q.numpy(), q[key],
                                      err_msg=key)
        np.testing.assert_array_equal(
            conv_weight(conv, torch.bfloat16).float().numpy(),
            np.asarray(deq[key], np.float32), err_msg=key)


def test_int8_mini_model_matches_jax_dequantized_apply(mini, jax_int8):
    model = _port_fused(mini, use_c3_kernel=True)
    fp32_bytes = quantized_bytes(model)
    n_conv = sum(c.weight.numel() for c in _port_convs(model).values())
    quantize_int8(model)
    # 3 of the 4 bytes of every conv weight saved (less the scales)
    assert fp32_bytes - quantized_bytes(model) > 2.9 * n_conv
    assert all(m.w1 is None for m in model.modules()
               if isinstance(m, L.Bottleneck))  # K2 reads the int8 weights
    jx, tx = _inputs(mini, IMG)
    jmodel = jax_build(mini["spec"], fused=True, use_pallas=True)
    want = jax.jit(lambda p: jmodel.apply(
        {"params": dequantize_int8(p, jnp.float32), "batch_stats": {}},
        *jx, train=False))(jax_int8)
    with torch.no_grad():
        got = model(*tx)
    _assert_raw_close(got, want)


def test_tta_matches_jax_tta(mini):
    """96 px: the scales give canvases of 96, 96 and 64 px."""
    model = _port_fused(mini, use_c3_kernel=True)
    jx, tx = _inputs(mini, 96)
    jmodel = jax_build(mini["spec"], fused=True)
    want = jax.jit(lambda p: jax_tta_forward(jmodel, p, {}, *jx))(
        mini["fparams"])
    with torch.no_grad():
        got = tta_forward(model, *tx)
    per_canvas = {s: 3 * sum((s // st) ** 2 for st in (8, 16, 32))
                  for s in (96, 64)}
    assert got.shape == want.shape == (
        2, 2 * per_canvas[96] + per_canvas[64], 5 + NC)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-3)


# ----------------------------------------------------------------- the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc to build the kernels")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 8e-3)])
@pytest.mark.parametrize("shape", [(2, 17, 23, 64), (2, 20, 20, 128)])
def test_cuda_kernel_matches_plain(cuda_device, shape, dtype, tol):
    torch.backends.cudnn.allow_tf32 = False
    t = [v.to(cuda_device) for v in _torch(_k2_inputs(shape, seed=8), dtype)]
    before = tracing.counter(k2.COUNTER)
    got = k2.c3_bottleneck(*t).float()
    torch.cuda.synchronize()
    want = k2.c3_bottleneck_plain(*t).float()
    assert tracing.counter(k2.COUNTER) - before == 2
    assert (got - want).abs().max() <= tol * want.abs().max()
