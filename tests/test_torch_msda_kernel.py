"""PyTorch port, multi-scale deformable attention's sampling
(ops/msda.ms_deform_attn) and its CUDA kernel K4 ``msda_sample``
(kernels/csrc/msda.cu).

On the CPU: the plain path (K4's twin) launches nothing; ``check_msda`` and
``msda_sample``'s checks refuse what K4 does not take; and the plain path
matches the official core (``portbench/reference/deformable_detr``) at the
edges K4 has to match: locations on a level's border, exactly on pixel
centres, half a pixel outside and far outside, and logits of very
different scales. On the card (marked ``cuda``): K4 against the plain path
on the same inputs in the working dtype, at the DETR cell's encoder and
decoder shapes and at those edges, one launch and no host read a call, 12
a Deformable DETR forward. No JAX here: the card tests run where there is
none."""

import pytest
import torch

from multispectral_object_detection_tpu_torch.ops import msda
from multispectral_object_detection_tpu_torch.ops.msda import ms_deform_attn
from multispectral_object_detection_tpu_torch.utils import tracing
from portbench.reference import deformable_detr as ref_detr
from tests._torch_port import share_torch_threads  # noqa: F401

# levels of power-of-two sides: a location (c + 0.5) / W, its offset and the
# offset / W are exact in fp32 and in bf16, so "on a centre" and "on the
# border" are exact on both paths
EDGE_SHAPES = [(8, 16), (4, 8), (2, 4), (1, 2)]
# the DETR cell's levels at 1024 px: 21,760 tokens an image
CELL_SHAPES = ref_detr.level_shapes((1024, 1024))
HEADS, POINTS = 8, 4
# max |K4 - plain| / max |plain|. bf16: both store the bf16 rounding of fp32
# sums that agree to about 1e-6, so an element differs by at most one bf16
# ulp (2^-8 of the largest output); 8e-3 allows two. fp32: the sums run in
# another order, and K4 rounds the pixel coordinate as loc * W - 0.5 where
# grid_sample rounds ((2 loc - 1 + 1) W - 1) / 2, a few fp32 ulps of W
# (about 1e-5 px at W = 128) times the value's slope: 3.4e-6 was read on
# an H100 at the cell's shapes.
TOL = {torch.bfloat16: 8e-3, torch.float32: 2e-5}


def _locations(shapes, reference, offsets, heads, points):
    """The sampling locations (N, Q, M, L, P, 2) as ``ms_deform_attn``
    computes them in fp32: reference + offset / (W, H)."""
    n, q = offsets.shape[:2]
    off = offsets.float().view(n, q, heads, len(shapes), points, 2)
    norm = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32,
                        device=offsets.device)
    return reference.float()[:, :, None, None, None] + off / norm[:, None]


def edge_case(kind, device="cpu", dtype=torch.float32, n=2, q=12):
    """Inputs of ``ms_deform_attn`` at EDGE_SHAPES, two heads of 32
    channels, 3 points, reference 0 (so the offset is the location times
    the level's side):

    - ``border``: locations 0 and 1 on either axis, the outer edges of the
      first and last pixels (pixel coordinates -0.5 and W - 0.5);
    - ``centres``: every location on a pixel's centre;
    - ``half_pixel_outside``: half a pixel past an edge (pixel coordinate
      -1 or W: no corner inside) and just inside it;
    - ``far_outside``: thousands of pixels out, and a few past the edge;
    - ``logit_scales``: random locations, logits scaled by 1e-3 to 1e3
      from query to query (softmax near uniform to one-hot)."""
    g = torch.Generator().manual_seed(len(kind))
    m, p, d = 2, 3, 32
    s = sum(h * w for h, w in EDGE_SHAPES)
    value = torch.randn(n, s, m, d, generator=g)
    logits = torch.randn(n, q, m, len(EDGE_SHAPES) * p, generator=g)
    side = torch.tensor([[w, h] for h, w in EDGE_SHAPES], dtype=torch.float32)
    shape = (n, q, m, len(EDGE_SHAPES), p, 2)
    pix = torch.rand(shape, generator=g) * side[:, None]  # pixel units
    if kind == "border":
        pix = torch.randint(0, 2, shape, generator=g) * side[:, None].expand(
            shape).float()
        keep = torch.rand(shape, generator=g) < 0.5  # one axis on the border
        pix = torch.where(keep, pix, torch.rand(shape, generator=g)
                          * side[:, None])
    elif kind == "centres":
        pix = torch.floor(pix) + 0.5
    elif kind == "half_pixel_outside":
        edge = torch.where(torch.rand(shape, generator=g) < 0.5,
                           torch.full(shape, -0.5), side[:, None] + 0.5)
        inside = torch.where(edge < 0, torch.full(shape, -0.25),
                             side[:, None] + 0.25)
        pix = torch.where(torch.rand(shape, generator=g) < 0.5, edge, inside)
    elif kind == "far_outside":
        far = torch.randint(-1, 2, shape, generator=g).float() * 4096.0
        pix = torch.where(far != 0, far + pix, pix + torch.randint(
            -3, 4, shape, generator=g).float() * side[:, None])
    elif kind == "logit_scales":
        scale = 10.0 ** torch.linspace(-3, 3, q)
        logits = logits * scale[None, :, None, None]
    else:
        raise ValueError(kind)
    reference = torch.zeros(n, q, 2)
    offsets = pix.flatten(2)
    args = (value.to(dtype), EDGE_SHAPES, reference, offsets.to(dtype),
            logits.flatten(2).to(dtype), p)
    return tuple(a.to(device) if torch.is_tensor(a) else a for a in args)


EDGES = ["border", "centres", "half_pixel_outside", "far_outside",
         "logit_scales"]


@pytest.mark.parametrize("kind", EDGES)
def test_plain_path_at_the_edges_matches_the_official_core(kind):
    value, shapes, reference, offsets, logits, p = edge_case(kind)
    n, q = offsets.shape[:2]
    m = value.shape[2]
    got = ms_deform_attn(value, shapes, reference, offsets, logits, p)
    loc = _locations(shapes, reference, offsets, m, p)
    a = logits.float().view(n, q, m, -1).softmax(-1).view(
        n, q, m, len(shapes), p)
    want = ref_detr.ms_deform_attn_core(value, shapes, loc, a)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    if kind == "half_pixel_outside":
        # only the points a quarter pixel inside add anything
        assert got.abs().max() > 0


def test_half_a_pixel_outside_adds_nothing():
    """A location half a pixel past any edge (pixel coordinate -1 or W)
    has no corner inside the level: the output is exactly zero."""
    value, shapes, reference, offsets, logits, p = edge_case(
        "half_pixel_outside")
    side = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32)
    off = offsets.view(*offsets.shape[:2], 2, len(shapes), p, 2)
    off = torch.where(off < 0, torch.full_like(off, -0.5),
                      side[:, None] + 0.5)
    got = ms_deform_attn(value, shapes, reference, off.flatten(2), logits, p)
    assert got.abs().max() == 0


def test_plain_path_on_the_cpu_launches_no_kernel():
    args = edge_case("centres")
    before = tracing.counter(msda.COUNTER)
    with tracing.span("test") as root:
        ms_deform_attn(*args)
    assert tracing.counter(msda.COUNTER) == before
    names = [s.name for s in tracing.spans() if s.request == root.id]
    assert names.count("msda") == 1 and msda.COUNTER not in names


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _cell_args(n=8, q=None, ref_batch=1, dtype=torch.bfloat16, shapes=None,
               heads=HEADS, d=32, points=POINTS, make=_meta):
    shapes = CELL_SHAPES if shapes is None else shapes
    s = sum(h * w for h, w in shapes)
    q = s if q is None else q
    nl = len(shapes)
    return [make(n, s, heads, d, dtype=dtype), shapes,
            make(ref_batch, q, 2, dtype=torch.float32),
            make(n, q, heads * nl * points * 2, dtype=dtype),
            make(n, q, heads * nl * points, dtype=dtype), points]


@pytest.mark.parametrize("case", [
    "encoder", "decoder_batch_n", "decoder_batch_1", "float32", "one_level",
    "three_levels", "one_point", "eight_points", "one_query",
    "grad_off"])
def test_check_msda_takes_the_shapes_of_published_models(case):
    kw = {"encoder": {}, "decoder_batch_n": dict(q=300, ref_batch=8),
          "decoder_batch_1": dict(q=300), "float32": dict(dtype=torch.float32),
          "one_level": dict(shapes=CELL_SHAPES[:1]),
          "three_levels": dict(shapes=CELL_SHAPES[1:], q=300),  # RT-DETR
          "one_point": dict(points=1, q=300),
          "eight_points": dict(points=8, q=300),
          "one_query": dict(n=1, q=1), "grad_off": dict(q=300)}[case]
    args = _cell_args(**kw)
    if case == "grad_off":  # weights that ask for a gradient, grad mode off
        for i in (0, 3, 4):
            args[i].requires_grad_()
        with torch.no_grad():
            msda.check_msda(*args)
        with torch.inference_mode():
            msda.check_msda(*args)
    else:
        msda.check_msda(*args)


@pytest.mark.parametrize("case", [
    "head_dim_64", "head_dim_16", "five_levels", "nine_points", "no_points",
    "float16", "float64", "offsets_dtype", "logits_dtype", "reference_bf16",
    "shapes_do_not_tile", "empty_level", "offsets_width", "logits_shape",
    "reference_batch", "reference_queries", "value_rank", "value_grad",
    "offsets_grad", "logits_grad", "reference_grad"])
def test_check_msda_refuses_what_the_kernel_does_not_take(case):
    """Shapes, dtypes and sizes K4 has no instance for; and, with grad mode
    on, any input that asks for a gradient (K4 has no backward, so it
    would drop it: the plain path, on CPU tensors, has one)."""
    args = _cell_args(q=300)
    value, shapes, reference, offsets, logits, points = args
    if case == "head_dim_64":
        args = _cell_args(q=300, heads=4, d=64)
    elif case == "head_dim_16":
        args = _cell_args(q=300, heads=16, d=16)
    elif case == "five_levels":
        args = _cell_args(q=300, shapes=CELL_SHAPES + [(4, 4)])
    elif case == "nine_points":
        args = _cell_args(q=300, points=9)
    elif case == "no_points":
        args = _cell_args(q=300, points=0)
    elif case in ("float16", "float64"):
        args = _cell_args(q=300, dtype=getattr(torch, case))
    elif case == "offsets_dtype":
        args[3] = _meta(*offsets.shape, dtype=torch.float32)
    elif case == "logits_dtype":
        args[4] = _meta(*logits.shape, dtype=torch.float32)
    elif case == "reference_bf16":
        args[2] = _meta(*reference.shape)
    elif case == "shapes_do_not_tile":
        args[1] = [(128, 128), (64, 64), (32, 32), (16, 15)]
    elif case == "empty_level":
        args = _cell_args(q=300, shapes=CELL_SHAPES[:3] + [(0, 16)])
    elif case == "offsets_width":
        args[3] = _meta(8, 300, offsets.shape[2] - 2)
    elif case == "logits_shape":
        args[4] = _meta(8, 301, logits.shape[2])
    elif case == "reference_batch":
        args[2] = _meta(3, 300, 2, dtype=torch.float32)
    elif case == "reference_queries":
        args[2] = _meta(1, 299, 2, dtype=torch.float32)
    elif case.endswith("_grad"):
        i = {"value": 0, "reference": 2, "offsets": 3, "logits": 4}[
            case[:-len("_grad")]]
        args[i].requires_grad_()
    else:
        args[0] = _meta(8, value.shape[1], 256)
    with pytest.raises(ValueError, match="msda_sample"):
        msda.check_msda(*args)


def _cpu(*shape, dtype=torch.bfloat16):
    return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize("case", ["value_not_contiguous",
                                  "offsets_misaligned", "cpu_tensors",
                                  "mixed_devices"])
def test_msda_sample_refuses_before_any_launch(case):
    """Layouts and devices K4 does not take raise before anything is
    allocated or launched; on mixed devices ``ms_deform_attn`` itself
    raises rather than choose a path."""
    shapes = [(4, 8), (2, 4)]
    args = _cell_args(n=2, q=5, shapes=shapes, make=_cpu)
    if case == "value_not_contiguous":
        args[0] = _cpu(2, 40, 32, HEADS).transpose(2, 3)
    elif case == "offsets_misaligned":
        width = args[3].shape[2]
        args[3] = _cpu(2 * 5 * width + 1)[1:].view(2, 5, width)
    before = tracing.counter(msda.COUNTER)
    if case == "mixed_devices":
        args[0] = _meta(*args[0].shape)
        with pytest.raises(ValueError, match="one CUDA device"):
            ms_deform_attn(*args)
    else:
        with pytest.raises(ValueError, match="msda_sample"):
            msda.msda_sample(*args)
    assert tracing.counter(msda.COUNTER) == before


# ----------------------------------------------------------------- the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc to build the kernels")
    return torch.device("cuda")


def cell_inputs(n, q, ref_batch, dtype, device, seed=0, far=0.05):
    """The cell's shapes with random data: value and logits normal, offsets
    of several pixels (normal, 3 px), a share ``far`` of them 100 times
    that; an encoder's reference (Q = the tokens, ``ref_batch`` 1) is each
    token's pixel centre, a decoder's uniform in [0, 1]."""
    g = torch.Generator(device=device).manual_seed(seed)
    s = sum(h * w for h, w in CELL_SHAPES)
    nl = len(CELL_SHAPES)
    value = torch.randn(n, s, HEADS, 32, device=device, generator=g)
    off = torch.randn(n, q, HEADS * nl * POINTS * 2, device=device,
                      generator=g) * 3
    off = torch.where(torch.rand(off.shape, device=device, generator=g)
                      < far, off * 100, off)
    logits = torch.randn(n, q, HEADS * nl * POINTS, device=device,
                         generator=g) * 2
    if q == s:
        ref = torch.cat([torch.stack(torch.meshgrid(
            (torch.arange(w, device=device) + 0.5) / w,
            (torch.arange(h, device=device) + 0.5) / h, indexing="xy"),
            -1).reshape(-1, 2) for h, w in CELL_SHAPES])[None].expand(
                ref_batch, -1, -1).contiguous()
    else:
        ref = torch.rand(ref_batch, q, 2, device=device, generator=g)
    return (value.to(dtype), CELL_SHAPES, ref, off.to(dtype),
            logits.to(dtype), POINTS)


def rel_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("q,ref_batch", [(None, 1), (300, 2), (300, 1)],
                         ids=["encoder", "decoder_batch_n", "decoder_batch_1"])
def test_kernel_matches_plain_at_the_cell_shapes(cuda_device, q, ref_batch,
                                                 dtype):
    s = sum(h * w for h, w in CELL_SHAPES)
    args = cell_inputs(2, s if q is None else q, ref_batch, dtype,
                       cuda_device)
    want = msda.ms_deform_attn_plain(*args)
    got = ms_deform_attn(*args)
    assert got.dtype == dtype and got.shape == want.shape
    assert rel_err(got, want) <= TOL[dtype]
    if dtype == torch.bfloat16:  # the same bf16 rounding, nearly always
        assert float((got == want).float().mean()) > 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kind", EDGES)
def test_kernel_matches_plain_at_the_edges(cuda_device, kind, dtype):
    args = edge_case(kind, cuda_device, dtype)
    want = msda.ms_deform_attn_plain(*args)
    got = ms_deform_attn(*args)
    assert rel_err(got, want) <= TOL[dtype]


@pytest.mark.cuda
def test_kernel_is_one_launch_and_no_host_read(cuda_device):
    args = cell_inputs(2, 300, 2, torch.bfloat16, cuda_device)
    ms_deform_attn(*args)  # the library's first load
    torch.cuda.synchronize()
    before = tracing.counter(msda.COUNTER)
    torch.cuda.set_sync_debug_mode("error")
    try:
        with tracing.span("test") as root:
            ms_deform_attn(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert tracing.counter(msda.COUNTER) - before == 1
    mine = [s for s in tracing.spans() if s.request == root.id]
    names = {s.id: s.name for s in mine}
    k4 = [s for s in mine if s.name == msda.COUNTER]
    assert len(k4) == 1 and names[k4[0].parent] == "msda"


@pytest.mark.cuda
def test_a_detr_forward_is_twelve_launches(cuda_device):
    """Deformable DETR R50 in bf16 on the card: every MSDA call of a
    forward (6 encoder, 6 decoder) launches K4 once, inside its ``msda``
    span, and the forward's outputs agree with the plain path's. The
    official init zeroes the box head's last layer, so that boxes would
    be the reference points whatever MSDA gives: it is drawn non-zero
    here, so both outputs read the decoder's state."""
    from multispectral_object_detection_tpu_torch.hub import Detector
    from multispectral_object_detection_tpu_torch.models import \
        deformable_detr

    det = Detector("deformable_detr_r50", img_size=256, dtype=torch.bfloat16,
                   device=cuda_device,
                   generator=torch.Generator().manual_seed(1))
    last = det.model.bbox_embed.layers[-1]
    with torch.no_grad():
        last.weight.copy_(0.1 * torch.randn(
            last.weight.shape, generator=torch.Generator().manual_seed(2)))
    x = (torch.rand(2, 3, 256, 256, device=cuda_device) * 255).to(
        torch.uint8).float() / 255
    with torch.no_grad():
        det.model(x)
        torch.cuda.synchronize()
        before = tracing.counter(msda.COUNTER)
        with tracing.span("test") as root:
            logits, boxes = det.model(x)
        torch.cuda.synchronize()
        assert tracing.counter(msda.COUNTER) - before == 12
        mine = [s for s in tracing.spans() if s.request == root.id]
        names = {s.id: s.name for s in mine}
        k4 = [s for s in mine if s.name == msda.COUNTER]
        assert len(k4) == 12 and all(names[s.parent] == "msda" for s in k4)
        real = deformable_detr.ms_deform_attn
        deformable_detr.ms_deform_attn = msda.ms_deform_attn_plain
        try:
            want_logits, want_boxes = det.model(x)
        finally:
            deformable_detr.ms_deform_attn = real
    assert rel_err(logits, want_logits) <= 2e-2
    assert rel_err(boxes, want_boxes) <= 2e-2
    # the sizes vary (the official init gives every box sigmoid(-2)): the
    # boxes read the decoder's state
    assert float(boxes[..., 2:].float().std()) > 1e-2
