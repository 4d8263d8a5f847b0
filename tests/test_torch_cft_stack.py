"""PyTorch port, CFT transformer stack: the kernels' plain twins against the
JAX package (fp32 on the CPU), the wrappers' CPU path, and on a GPU the
CUDA kernels against their twins."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multispectral_object_detection_tpu.ops import pallas_fusion as pf
from multispectral_object_detection_tpu_torch.models.configs import (
    yolov5_two_stream)
from multispectral_object_detection_tpu_torch.models.parser import (
    parse_model_config)
from multispectral_object_detection_tpu_torch.ops import cft_stack as cs
from tests._torch_port import share_torch_threads  # noqa: F401

# the JAX twin as one compiled program per shape (op by op it compiles each
# of its operations apart, several times slower)
_stack_reference = jax.jit(pf.fused_cft_stack_reference,
                           static_argnames="num_heads")


def _inputs(B, C, L, seed):
    """x (B, 128, C) and the ten stacked weight arguments, numpy fp32."""
    rng = np.random.default_rng(seed)

    def f(*shape, scale=0.05):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    def ln():
        return np.stack([1 + f(L, C, scale=0.1), f(L, C, scale=0.1)], 1)

    x = f(B, 128, C, scale=1.0)
    return x, [f(L, C, 3 * C), f(L, 3 * C), f(L, C, C), f(L, C),
               f(L, C, 4 * C), f(L, 4 * C), f(L, 4 * C, C), f(L, C), ln(), ln()]


def _cast(x, ws, torch_dtype, jnp_dtype):
    """Both sides' arguments: weights in the compute dtype, LN fp32."""
    t = [torch.from_numpy(x).to(torch_dtype)] + [
        torch.from_numpy(w).to(torch_dtype if i < 8 else torch.float32)
        for i, w in enumerate(ws)]
    j = [jnp.asarray(x, jnp_dtype)] + [
        jnp.asarray(w, jnp_dtype if i < 8 else jnp.float32)
        for i, w in enumerate(ws)]
    return t, j


@pytest.mark.parametrize("B,C,L", [(2, 64, 2), (1, 128, 2), (3, 64, 1),
                                   (1, 256, 1)])
def test_stack_plain_matches_jax_reference(B, C, L):
    x, ws = _inputs(B, C, L, seed=C + L)
    t, j = _cast(x, ws, torch.float32, jnp.float32)
    got = cs.fused_cft_stack_plain(*t, num_heads=8).numpy()
    want = np.asarray(_stack_reference(*j, num_heads=8))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_stack_plain_matches_pallas_interpret():
    x, ws = _inputs(2, 64, 2, seed=1)
    t, j = _cast(x, ws, torch.float32, jnp.float32)
    got = cs.fused_cft_stack_plain(*t, num_heads=8).numpy()
    want = np.asarray(pf.fused_cft_stack(*j, num_heads=8, interpret=True))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_stack_bf16_rounding_points_match_jax_reference():
    """bf16 compute: both round at the same points (qkv, attention
    probabilities, head outputs, fc1); 2 layers of bf16 rounding allow a
    few bf16 ulps of the largest output."""
    x, ws = _inputs(2, 64, 2, seed=2)
    t, j = _cast(x, ws, torch.bfloat16, jnp.bfloat16)
    got = cs.fused_cft_stack_plain(*t, num_heads=8).float().numpy()
    want = np.asarray(_stack_reference(*j, num_heads=8),
                      np.float32)
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_plain_matches_jax(dtype):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((256, 64)).astype(np.float32) * 3 + 1
    s = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    b = (0.1 * rng.standard_normal(64)).astype(np.float32)
    got = cs.layer_norm_plain(torch.from_numpy(x), torch.from_numpy(s),
                              torch.from_numpy(b), getattr(torch, dtype))
    want = pf._ln(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b)).astype(
        getattr(jnp, dtype))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=1e-5 if dtype == "float32" else 8e-3,
                               atol=1e-5 if dtype == "float32" else 8e-3)


@pytest.mark.parametrize("epilogue", ["bias", "gelu", "residual"])
def test_linear_plain_matches_jax(epilogue):
    rng = np.random.default_rng(4)
    a = rng.standard_normal((128, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 192)) * 0.1).astype(np.float32)
    b = rng.standard_normal(192).astype(np.float32)
    s = rng.standard_normal((128, 192)).astype(np.float32)
    acc = jnp.dot(jnp.asarray(a), jnp.asarray(w)) + jnp.asarray(b)
    if epilogue == "residual":
        want = jnp.asarray(s) + jnp.dot(jnp.asarray(a), jnp.asarray(w)) + b
        got = cs.linear_plain(torch.from_numpy(a), torch.from_numpy(w),
                              torch.from_numpy(b), epilogue,
                              out=torch.from_numpy(s.copy()))
    else:
        want = pf._gelu_exact(acc) if epilogue == "gelu" else acc
        got = cs.linear_plain(torch.from_numpy(a), torch.from_numpy(w),
                              torch.from_numpy(b), epilogue)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("heads,d", [(8, 8), (8, 16), (4, 32)])
def test_attention_plain_matches_jax(heads, d):
    rng = np.random.default_rng(5)
    B, N, C = 2, 128, heads * d
    qkv = rng.standard_normal((B * N, 3 * C)).astype(np.float32)
    q4 = jnp.asarray(qkv).reshape(B, N, 3, heads, d)
    logits = jnp.einsum("bnhd,bmhd->bhnm", q4[:, :, 0], q4[:, :, 1])
    att = jax.nn.softmax(logits / jnp.sqrt(jnp.float32(d)), axis=-1)
    want = jnp.einsum("bhnm,bmhd->bnhd", att, q4[:, :, 2]).reshape(B * N, C)
    got = cs.attention_plain(torch.from_numpy(qkv), B, heads)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def _jax_attention(qkv, batch, heads, d):
    """`_kernel`'s per-(image, head) attention, written in jnp, fp32."""
    q4 = jnp.asarray(qkv).reshape(batch, -1, 3, heads, d)
    logits = jnp.einsum("bnhd,bmhd->bhnm", q4[:, :, 0], q4[:, :, 1])
    att = jax.nn.softmax(logits / jnp.sqrt(jnp.float32(d)), axis=-1)
    return jnp.einsum("bhnm,bmhd->bnhd", att, q4[:, :, 2]).reshape(
        qkv.shape[0], heads * d)


@pytest.mark.parametrize("d,n", [(24, 128), (40, 128), (136, 128), (40, 100),
                                 (160, 100)])
def test_attention_plain_matches_jax_at_odd_widths_and_masked_edge(d, n):
    """Head widths that are not multiples of 16 (24 and 40: the m and x
    scales' P3 stages; 136), and N = 100 tokens, where the kernel masks the
    keys past N of its 128 slots."""
    rng = np.random.default_rng(d + n)
    B, heads = 2, 8
    qkv = rng.standard_normal((B * n, 3 * heads * d)).astype(np.float32)
    got = cs.attention_plain(torch.from_numpy(qkv), B, heads)
    want = _jax_attention(qkv, B, heads, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_stack_plain_matches_jax_reference_at_100_tokens():
    """The whole stack at N = 100 tokens and the m scale's P3 width (C = 192,
    head width 24) against the JAX package's reference."""
    rng = np.random.default_rng(11)
    C, L = 192, 1

    def f(*shape, scale=0.05):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    def ln():
        return np.stack([1 + f(L, C, scale=0.1), f(L, C, scale=0.1)], 1)

    x = f(2, 100, C, scale=1.0)
    ws = [f(L, C, 3 * C), f(L, 3 * C), f(L, C, C), f(L, C), f(L, C, 4 * C),
          f(L, 4 * C), f(L, 4 * C, C), f(L, C), ln(), ln()]
    t, j = _cast(x, ws, torch.float32, jnp.float32)
    got = cs.fused_cft_stack_plain(*t, num_heads=8).numpy()
    want = np.asarray(_stack_reference(*j, num_heads=8))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("epilogue", ["bias", "gelu", "residual"])
def test_linear_plain_matches_jax_at_ragged_n(epilogue):
    """N = 320, a multiple of 64 but not of 128 (proj and fc2 at the x
    scale's P3 stage; its QKV has N = 960), where the kernel's 128-wide
    tiles run past the matrix."""
    rng = np.random.default_rng(12)
    a = rng.standard_normal((128, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 320)) * 0.1).astype(np.float32)
    b = rng.standard_normal(320).astype(np.float32)
    s = rng.standard_normal((128, 320)).astype(np.float32)
    acc = jnp.dot(jnp.asarray(a), jnp.asarray(w))
    if epilogue == "residual":
        want = jnp.asarray(s) + acc + b
        got = cs.linear_plain(torch.from_numpy(a), torch.from_numpy(w),
                              torch.from_numpy(b), epilogue,
                              out=torch.from_numpy(s.copy()))
    else:
        want = acc + b
        want = pf._gelu_exact(want) if epilogue == "gelu" else want
        got = cs.linear_plain(torch.from_numpy(a), torch.from_numpy(w),
                              torch.from_numpy(b), epilogue)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def _cft_widths(scale):
    """d_model of each CFT stage of the paper config at ``scale``."""
    spec = parse_model_config(yolov5_two_stream(scale))
    return [n.c2 for n in spec.nodes if n.kind == "GPT"]


@pytest.mark.parametrize("scale", ["n", "s", "m", "l", "x"])
def test_kernel_argument_checks_take_every_cft_shape(scale):
    """Every LayerNorm, GEMM and attention call of the CFT stages of
    ``scale`` at batch 1, 8 and 16 passes the kernels' argument checks, in
    bf16 and fp32, on meta tensors (no card needed). TTA's 544 and 448 px
    passes pool to the same 8x8 grid, so they make the same calls."""
    widths = _cft_widths(scale)
    assert len(widths) == 3
    n_tok = 2 * 8 * 8
    meta = {"device": "meta"}
    for dt in (torch.bfloat16, torch.float32):
        for batch in (1, 8, 16):
            M = batch * n_tok
            for C in widths:
                x = torch.empty(M, C, **meta)
                ln = torch.empty(C, **meta)
                cs.check_layer_norm(x, ln, ln, dt)
                for K, N, epi in ((C, 3 * C, "bias"), (C, C, "residual"),
                                  (C, 4 * C, "gelu"), (4 * C, C, "residual")):
                    out = (torch.empty(M, N, **meta) if epi == "residual"
                           else None)
                    cs.check_linear(torch.empty(M, K, dtype=dt, **meta),
                                    torch.empty(K, N, dtype=dt, **meta),
                                    torch.empty(N, dtype=dt, **meta), epi,
                                    out=out)
                cs.check_attention(torch.empty(M, 3 * C, dtype=dt, **meta),
                                   batch, 8)


@pytest.mark.parametrize("case", ["head_width", "tokens", "gemm_n",
                                  "gemm_dtype", "ln_width"])
def test_kernel_argument_checks_refuse_what_the_kernels_do_not_take(case):
    meta = {"device": "meta", "dtype": torch.bfloat16}
    with pytest.raises(ValueError):
        if case == "head_width":  # C = 96: head width 12
            cs.check_attention(torch.empty(256, 288, **meta), 2, 8)
        elif case == "tokens":  # 129 tokens per image
            cs.check_attention(torch.empty(258, 768, **meta), 2, 8)
        elif case == "gemm_n":  # N = 96
            cs.check_linear(torch.empty(128, 64, **meta),
                            torch.empty(64, 96, **meta),
                            torch.empty(96, **meta), "bias")
        elif case == "gemm_dtype":
            cs.check_linear(torch.empty(128, 64, **meta),
                            torch.empty(64, 64, device="meta"),
                            torch.empty(64, **meta), "bias")
        else:  # C = 4096
            x = torch.empty(128, 4096, device="meta")
            cs.check_layer_norm(x, x[0], x[0], torch.bfloat16)


@pytest.mark.parametrize("C", [1280, 2048])
def test_layer_norm_plain_matches_jax_at_x_scale_widths(C):
    rng = np.random.default_rng(C)
    x = rng.standard_normal((64, C)).astype(np.float32) * 3 + 1
    s = (1 + 0.1 * rng.standard_normal(C)).astype(np.float32)
    b = (0.1 * rng.standard_normal(C)).astype(np.float32)
    got = cs.layer_norm_plain(torch.from_numpy(x), torch.from_numpy(s),
                              torch.from_numpy(b), torch.float32)
    want = pf._ln(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_stack_plain_matches_jax_reference_at_head_width_160():
    """The x scale's P5 stage: C = 1280, 8 heads of width 160."""
    x, ws = _inputs(1, 1280, 1, seed=9)
    t, j = _cast(x, ws, torch.float32, jnp.float32)
    got = cs.fused_cft_stack_plain(*t, num_heads=8).numpy()
    want = np.asarray(_stack_reference(*j, num_heads=8))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def _wrapper_cases():
    rng = np.random.default_rng(6)

    def t(*shape, dtype=torch.float32):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dtype)

    x, ws = _inputs(1, 64, 1, seed=7)
    stack_args = [torch.from_numpy(x)] + [torch.from_numpy(w) for w in ws]
    a, w, b, s = t(128, 64), t(64, 64), t(64), t(128, 64)
    qkv = t(256, 192)
    return {
        "layer_norm": (lambda: cs.layer_norm(s, b, b, torch.bfloat16),
                       lambda: cs.layer_norm_plain(s, b, b, torch.bfloat16)),
        "linear_bias": (lambda: cs.linear(a, w, b, "bias"),
                        lambda: cs.linear_plain(a, w, b, "bias")),
        "linear_gelu": (lambda: cs.linear(a, w, b, "gelu"),
                        lambda: cs.linear_plain(a, w, b, "gelu")),
        "linear_residual": (
            lambda: cs.linear(a, w, b, "residual", out=s.clone()),
            lambda: cs.linear_plain(a, w, b, "residual", out=s.clone())),
        "attention": (lambda: cs.attention(qkv, 2, 8),
                      lambda: cs.attention_plain(qkv, 2, 8)),
        "fused_cft_stack": (lambda: cs.fused_cft_stack(*stack_args),
                            lambda: cs.fused_cft_stack_plain(*stack_args)),
    }


@pytest.mark.parametrize("name", ["layer_norm", "linear_bias", "linear_gelu",
                                  "linear_residual", "attention",
                                  "fused_cft_stack"])
def test_wrapper_on_cpu_takes_plain_path_and_counts_nothing(name):
    kernel_fn, plain_fn = _wrapper_cases()[name]
    cs.reset_launches()
    assert torch.equal(kernel_fn(), plain_fn())
    assert all(v == 0 for v in cs.LAUNCHES.values()), cs.LAUNCHES


def test_wrappers_reject_mixed_devices_and_misused_out():
    x = torch.zeros(128, 64)
    with pytest.raises(ValueError):
        cs.layer_norm(x, torch.zeros(64, device="meta"), torch.zeros(64),
                      torch.float32)
    with pytest.raises(ValueError):
        cs.linear(x, torch.zeros(64, 64), torch.zeros(64), "bias", out=x)
    with pytest.raises(ValueError):
        cs.linear(x, torch.zeros(64, 64), torch.zeros(64), "relu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc to build the kernels")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 1.5e-2)])
def test_cuda_stack_matches_plain(cuda_device, dtype, tol):
    x, ws = _inputs(4, 256, 2, seed=8)
    t, _ = _cast(x, ws, dtype, jnp.float32)
    t = [v.to(cuda_device) for v in t]
    cs.reset_launches()
    got = cs.fused_cft_stack(*t).float()
    torch.cuda.synchronize()
    want = cs.fused_cft_stack_plain(*t).float()
    assert cs.LAUNCHES["cft_attention"] == 2
    assert (got - want).abs().max() <= tol * want.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 8e-3)])
def test_cuda_x_scale_layer_norm_and_attention_match_plain(cuda_device,
                                                           dtype, tol):
    """C = 1280 (float4 per lane beyond the old 8) and head width 160
    (4 query rows per warp, to fit shared memory)."""
    g = torch.Generator().manual_seed(10)
    x = torch.randn(1024, 1280, generator=g).to(cuda_device)
    w = (1 + 0.1 * torch.randn(1280, generator=g)).to(cuda_device)
    b = (0.1 * torch.randn(1280, generator=g)).to(cuda_device)
    qkv = torch.randn(1024, 3 * 1280, generator=g).to(cuda_device, dtype)
    for got, want in ((cs.layer_norm(x, w, b, dtype),
                       cs.layer_norm_plain(x, w, b, dtype)),
                      (cs.attention(qkv, 8, 8), cs.attention_plain(qkv, 8, 8))):
        torch.cuda.synchronize()
        got, want = got.float(), want.float()
        assert (got - want).abs().max() <= tol * want.abs().max()
