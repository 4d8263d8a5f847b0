"""Hub-style constructors over the port's ``Detector`` (the counterparts of
the root hubconf.py's, reference hubconf.py:21-122).

    from multispectral_object_detection_tpu_torch.hubconf import cft
    det = cft(weights="runs/train/exp/best")   # CUDA; device="cpu" for CPU
    results = det([rgb_array], [ir_array])

Each takes ``nc``, ``weights`` (a JAX checkpoint directory or a ``.pt``
state dict), ``img_size`` and ``Detector``'s other keywords. ``custom``
takes any config name of ``models/configs.get_config`` (the hub zoo
included) or a DSL dict.
"""

from .hub import Detector, create  # noqa: F401


def _make(name):
    def ctor(nc=None, weights=None, img_size=640, **kw):
        return Detector(name, nc=nc, weights=weights, img_size=img_size, **kw)

    ctor.__name__ = name
    return ctor


yolov5n = _make("yolov5n")
yolov5s = _make("yolov5s")
yolov5m = _make("yolov5m")
yolov5l = _make("yolov5l")
yolov5x = _make("yolov5x")
# the P6 family: 4 detect scales, trained at 1280 px
yolov5s6 = _make("yolov5s6")
yolov5m6 = _make("yolov5m6")
yolov5l6 = _make("yolov5l6")
yolov5x6 = _make("yolov5x6")
cft = _make("yolov5l_fusion_transformerx3")
cft_s = _make("yolov5s_fusion_transformerx3")
fusion_add = _make("yolov5l_fusion_add")


def custom(cfg_or_name, nc=None, weights=None, **kw):
    return Detector(cfg_or_name, nc=nc, weights=weights, **kw)
