"""PyTorch port, Grad-CAM (utils/gradcam.py) on the CPU: the tap hook (a
zero tap is a no-op, a perturbation propagates, a bad node or a CFT
stage's pair is refused), ``grad`` and ``sum`` CAMs against the JAX
package's ``compute_cam`` on the mini two-stream CFT model (fp32, 1e-4),
the overlay's JET table and float resize against cv2's, and the CLI."""

import numpy as np
import pytest
import torch

from multispectral_object_detection_tpu_torch.models.model import build_model
from multispectral_object_detection_tpu_torch.utils import gradcam
from tests._torch_port import (  # noqa: F401
    load, mini_weights, share_torch_threads, to_nchw)


@pytest.fixture(scope="module")
def mini():
    w = mini_weights(0)
    model = load(build_model(w["cfg"]), w["sd"])
    rng = np.random.default_rng(0)
    rgb, ir = (rng.random((1, 64, 64, 3)).astype(np.float32)
               for _ in range(2))
    return model, w, rgb, ir


def test_zero_tap_is_a_no_op_and_returns_the_activation(mini):
    model, _, rgb, ir = mini
    x, x2 = to_nchw(rgb), to_nchw(ir)
    with torch.no_grad():
        plain = model(x, x2)
        with gradcam.tap(model, 4, grad=True) as box:
            out = model(x, x2)
    for a, b in zip(plain, out):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert box["act"].shape == (1, 64, 8, 8)
    assert not box["tap"].any()


def test_a_perturbation_propagates(mini):
    model, _, rgb, ir = mini
    x, x2 = to_nchw(rgb), to_nchw(ir)
    with torch.no_grad():
        plain = model(x, x2)
        with gradcam.tap(model, 4, add=torch.full((1, 64, 8, 8), 0.5)):
            out = model(x, x2)
    assert not torch.allclose(plain[0], out[0])


def test_bad_nodes_are_refused(mini):
    model, _, rgb, ir = mini
    with pytest.raises(ValueError, match="not a node"):
        with gradcam.tap(model, 999):
            pass
    with pytest.raises(ValueError, match="CFT stage"):  # node 10: GPT pair
        gradcam.compute_cam(model, to_nchw(rgb), to_nchw(ir), layer=10,
                            mode="sum")
    with pytest.raises(ValueError, match="mode"):
        gradcam.compute_cam(model, to_nchw(rgb), to_nchw(ir), layer=4,
                            mode="bogus")


@pytest.mark.parametrize("layer,mode,class_id", [
    (4, "grad", None), (4, "sum", None), (37, "grad", None),
    (18, "grad", 1)])
def test_cam_matches_jax(mini, layer, mode, class_id):
    """Node 4: the RGB stem at P3; 18: the P4 CFT stage's output added to
    the RGB stream; 37: the neck's P3 output."""
    import jax.numpy as jnp

    from multispectral_object_detection_tpu.models import build_model as jb
    from multispectral_object_detection_tpu.utils.gradcam import (
        compute_cam as jax_cam)

    model, w, rgb, ir = mini
    want = np.asarray(jax_cam(jb(w["cfg"]), w["params"], w["stats"],
                              jnp.asarray(rgb), jnp.asarray(ir), layer=layer,
                              mode=mode, class_id=class_id))
    got = gradcam.compute_cam(model, to_nchw(rgb), to_nchw(ir), layer=layer,
                              mode=mode, class_id=class_id).numpy()
    assert got.shape == want.shape and got.min() >= 0 and got.max() <= 1
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_grad_mode_runs_the_training_stack_and_restores_the_kernel(
        mini, monkeypatch):
    from multispectral_object_detection_tpu_torch.models.fusion import (
        CrossModalFusion)
    from multispectral_object_detection_tpu_torch.ops import cft_stack

    model, _, rgb, ir = mini
    calls = []
    real = cft_stack.cft_stack_train

    def spy(*a, **k):
        calls.append(a[0].requires_grad or torch.is_grad_enabled())
        return real(*a, **k)

    monkeypatch.setattr(cft_stack, "cft_stack_train", spy)
    gradcam.compute_cam(model, to_nchw(rgb), to_nchw(ir), layer=37)
    assert calls == [True] * 3  # the three CFT stages, grad enabled
    assert all(m.stack_fn is cft_stack.fused_cft_stack
               for m in model.modules() if isinstance(m, CrossModalFusion))


def test_overlay_matches_cv2():
    cv2 = pytest.importorskip("cv2")
    from multispectral_object_detection_tpu_torch.data.native import (
        resize_f32)

    lut = cv2.applyColorMap(np.arange(256, dtype=np.uint8)[:, None],
                            cv2.COLORMAP_JET)[:, 0, ::-1]
    np.testing.assert_array_equal(gradcam.jet_lut(), lut)
    rng = np.random.RandomState(1)
    cam = rng.rand(8, 8).astype(np.float32)
    np.testing.assert_allclose(resize_f32(cam, 96, 128),
                               cv2.resize(cam, (128, 96)), atol=1e-6)
    img = rng.randint(0, 255, (96, 128, 3)).astype(np.uint8)
    out = gradcam.overlay_cam(img, cam)
    heat = cv2.applyColorMap(np.uint8(255 * cv2.resize(cam, (128, 96))),
                             cv2.COLORMAP_JET)[..., ::-1] / np.float32(255)
    want = heat + np.float32(img) / 255
    want = np.uint8(255 * want / want.max())
    assert out.shape == img.shape and out.dtype == np.uint8
    assert np.abs(out.astype(int) - want).max() <= 1


def test_cli_writes_overlays(tmp_path, capsys):
    from multispectral_object_detection_tpu_torch.data.synthetic import (
        make_paired_dataset)

    w = mini_weights(0)
    ckpt = tmp_path / "w.pt"
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in
                w["sd"].items()}, ckpt)
    rgb, ir = make_paired_dataset(str(tmp_path / "d"), n_images=2,
                                  img_size=64, nc=2, seed=1)
    argv = ["--cfg", "yolov5n_fusion_transformerx3", "--nc", "2",
            "--weights", str(ckpt), "--source1", rgb, "--source2", ir,
            "--layers", "4", "30", "--img-size", "64", "--fp32", "--mode",
            "sum", "--project", str(tmp_path / "runs")]
    if not torch.cuda.is_available():
        assert gradcam.main(argv) == 1  # no GPU and no --device cpu
        assert "CUDA" in capsys.readouterr().err
    assert gradcam.main(argv + ["--device", "cpu"]) == 0
    out = sorted((tmp_path / "runs" / "exp").iterdir())
    assert len(out) == 4 and all(f.name.startswith("cam_") for f in out)
