"""Built-in model configurations as plain DSL dicts for the parser.

The port's copy of the configs of multispectral_object_detection_tpu/
models/configs.py that this slice runs: single-stream YOLOv5 and the
two-stream RGB+IR fusion families (`add`, `transformer` = 4 CFT stages at
P2-P5, `transformerx3` = the paper's 3 CFT stages at P3/P4/P5).
"""

from __future__ import annotations

from typing import Dict, List, Optional

SCALES = {
    "n": (0.33, 0.25),  # nano: for CPU tests / edge
    "s": (0.33, 0.50),
    "m": (0.67, 0.75),
    "l": (1.00, 1.00),
    "x": (1.33, 1.25),
}

COCO_ANCHORS = [
    [10, 13, 16, 30, 33, 23],      # P3/8
    [30, 61, 62, 45, 59, 119],     # P4/16
    [116, 90, 156, 198, 373, 326], # P5/32
]


def yolov5(scale: str = "s", nc: int = 80) -> Dict:
    """Single-stream YOLOv5 (reference models/yolov5{s,m,l,x}.yaml)."""
    gd, gw = SCALES[scale]
    backbone = [
        [-1, 1, "Focus", [64, 3]],        # 0  P1/2
        [-1, 1, "Conv", [128, 3, 2]],     # 1  P2/4
        [-1, 3, "C3", [128]],             # 2
        [-1, 1, "Conv", [256, 3, 2]],     # 3  P3/8
        [-1, 9, "C3", [256]],             # 4
        [-1, 1, "Conv", [512, 3, 2]],     # 5  P4/16
        [-1, 9, "C3", [512]],             # 6
        [-1, 1, "Conv", [1024, 3, 2]],    # 7  P5/32
        [-1, 1, "SPP", [1024, [5, 9, 13]]],
        [-1, 3, "C3", [1024, False]],     # 9
    ]
    head = [
        [-1, 1, "Conv", [512, 1, 1]],            # 10
        [-1, 1, "nn.Upsample", ["None", 2, "nearest"]],
        [[-1, 6], 1, "Concat", [1]],
        [-1, 3, "C3", [512, False]],             # 13
        [-1, 1, "Conv", [256, 1, 1]],            # 14
        [-1, 1, "nn.Upsample", ["None", 2, "nearest"]],
        [[-1, 4], 1, "Concat", [1]],
        [-1, 3, "C3", [256, False]],             # 17 P3
        [-1, 1, "Conv", [256, 3, 2]],
        [[-1, 14], 1, "Concat", [1]],
        [-1, 3, "C3", [512, False]],             # 20 P4
        [-1, 1, "Conv", [512, 3, 2]],
        [[-1, 10], 1, "Concat", [1]],
        [-1, 3, "C3", [1024, False]],            # 23 P5
        [[17, 20, 23], 1, "Detect", ["nc", "anchors"]],
    ]
    return {
        "nc": nc,
        "depth_multiple": gd,
        "width_multiple": gw,
        "anchors": [list(a) for a in COCO_ANCHORS],
        "backbone": backbone,
        "head": head,
    }


def _stream_p3(frm) -> List[list]:
    """One CSPDarknet stem up to P3/8 (5 rows)."""
    return [
        [frm, 1, "Focus", [64, 3]],
        [-1, 1, "Conv", [128, 3, 2]],
        [-1, 3, "C3", [128]],
        [-1, 1, "Conv", [256, 3, 2]],
        [-1, 9, "C3", [256]],
    ]


def yolov5_two_stream(scale: str = "l", nc: int = 1,
                      fusion: str = "transformerx3") -> Dict:
    """Two-stream RGB+IR configs.

    fusion='transformerx3': the paper config, CFT at P3/P4/P5 with Add2
    residuals, then an Add-merged pyramid (reference
    models/transformer/yolov5l_fusion_transformerx3_*.yaml).
    fusion='add': plain elementwise-add fusion baseline.
    fusion='transformer': 4 CFT stages at P2-P5.
    """
    gd, gw = SCALES[scale]
    b: List[list] = []
    b += _stream_p3(-1)   # rows 0-4: RGB stream to P3
    b += _stream_p3(-4)   # rows 5-9: IR stream to P3

    if fusion == "transformerx3":
        b += [
            [[4, 9], 1, "GPT", [256]],          # 10: CFT @ P3
            [[4, 10], 1, "Add2", [256, 0]],     # 11
            [[9, 10], 1, "Add2", [256, 1]],     # 12
            [11, 1, "Conv", [512, 3, 2]],       # 13
            [-1, 9, "C3", [512]],               # 14
            [12, 1, "Conv", [512, 3, 2]],       # 15
            [-1, 9, "C3", [512]],               # 16
            [[14, 16], 1, "GPT", [512]],        # 17: CFT @ P4
            [[14, 17], 1, "Add2", [512, 0]],    # 18
            [[16, 17], 1, "Add2", [512, 1]],    # 19
            [18, 1, "Conv", [1024, 3, 2]],      # 20
            [-1, 1, "SPP", [1024, [5, 9, 13]]], # 21
            [-1, 3, "C3", [1024, False]],       # 22
            [19, 1, "Conv", [1024, 3, 2]],      # 23
            [-1, 1, "SPP", [1024, [5, 9, 13]]], # 24
            [-1, 3, "C3", [1024, False]],       # 25
            [[22, 25], 1, "GPT", [1024]],       # 26: CFT @ P5
            [[22, 26], 1, "Add2", [1024, 0]],   # 27
            [[25, 26], 1, "Add2", [1024, 1]],   # 28
            [[11, 12], 1, "Add", [1]],          # 29: fused P3
            [[18, 19], 1, "Add", [1]],          # 30: fused P4
            [[27, 28], 1, "Add", [1]],          # 31: fused P5
        ]
        p3, p4, p5 = 29, 30, 31
    elif fusion == "add":
        b += [
            [4, 1, "Conv", [512, 3, 2]],        # 10
            [-1, 9, "C3", [512]],               # 11
            [9, 1, "Conv", [512, 3, 2]],        # 12
            [-1, 9, "C3", [512]],               # 13
            [11, 1, "Conv", [1024, 3, 2]],      # 14
            [-1, 1, "SPP", [1024, [5, 9, 13]]], # 15
            [-1, 3, "C3", [1024, False]],       # 16
            [13, 1, "Conv", [1024, 3, 2]],      # 17
            [-1, 1, "SPP", [1024, [5, 9, 13]]], # 18
            [-1, 3, "C3", [1024, False]],       # 19
            [[4, 9], 1, "Add", [1]],            # 20: fused P3
            [[11, 13], 1, "Add", [1]],          # 21: fused P4
            [[16, 19], 1, "Add", [1]],          # 22: fused P5
        ]
        p3, p4, p5 = 20, 21, 22
    elif fusion == "transformer":
        b = [
            [-1, 1, "Focus", [64, 3]],          # 0
            [-1, 1, "Conv", [128, 3, 2]],       # 1 P2/4
            [-1, 3, "C3", [128]],               # 2
            [-4, 1, "Focus", [64, 3]],          # 3
            [-1, 1, "Conv", [128, 3, 2]],       # 4
            [-1, 3, "C3", [128]],               # 5
            [[2, 5], 1, "GPT", [128]],          # 6: CFT @ P2
            [[2, 6], 1, "Add2", [128, 0]],      # 7
            [[5, 6], 1, "Add2", [128, 1]],      # 8
            [7, 1, "Conv", [256, 3, 2]],        # 9 P3/8
            [-1, 9, "C3", [256]],               # 10
            [8, 1, "Conv", [256, 3, 2]],        # 11
            [-1, 9, "C3", [256]],               # 12
            [[10, 12], 1, "GPT", [256]],        # 13: CFT @ P3
            [[10, 13], 1, "Add2", [256, 0]],    # 14
            [[12, 13], 1, "Add2", [256, 1]],    # 15
            [14, 1, "Conv", [512, 3, 2]],       # 16 P4/16
            [-1, 9, "C3", [512]],               # 17
            [15, 1, "Conv", [512, 3, 2]],       # 18
            [-1, 9, "C3", [512]],               # 19
            [[17, 19], 1, "GPT", [512]],        # 20: CFT @ P4
            [[17, 20], 1, "Add2", [512, 0]],    # 21
            [[19, 20], 1, "Add2", [512, 1]],    # 22
            [-2, 1, "Conv", [1024, 3, 2]],      # 23 P5/32 (from 21, like ref)
            [-1, 1, "SPP", [1024, [5, 9, 13]]], # 24
            [-1, 3, "C3", [1024, False]],       # 25
            [22, 1, "Conv", [1024, 3, 2]],      # 26
            [-1, 1, "SPP", [1024, [5, 9, 13]]], # 27
            [-1, 3, "C3", [1024, False]],       # 28
            [[25, 28], 1, "GPT", [1024]],       # 29: CFT @ P5
            [[25, 29], 1, "Add2", [1024, 0]],   # 30
            [[28, 29], 1, "Add2", [1024, 1]],   # 31
            [[14, 15], 1, "Add", [1]],          # 32: fused P3
            [[21, 22], 1, "Add", [1]],          # 33: fused P4
            [[30, 31], 1, "Add", [1]],          # 34: fused P5
        ]
        p3, p4, p5 = 32, 33, 34
    else:
        raise ValueError(f"unknown fusion kind: {fusion}")

    nb = len(b)
    head = [
        [-1, 1, "Conv", [512, 1, 1]],                    # nb
        [-1, 1, "nn.Upsample", ["None", 2, "nearest"]],  # nb+1
        [[-1, p4], 1, "Concat", [1]],                    # nb+2
        [-1, 3, "C3", [512, False]],                     # nb+3
        [-1, 1, "Conv", [256, 1, 1]],                    # nb+4
        [-1, 1, "nn.Upsample", ["None", 2, "nearest"]],  # nb+5
        [[-1, p3], 1, "Concat", [1]],                    # nb+6
        [-1, 3, "C3", [256, False]],                     # nb+7  P3-small
        [-1, 1, "Conv", [256, 3, 2]],                    # nb+8
        [[-1, nb + 4], 1, "Concat", [1]],                # nb+9
        [-1, 3, "C3", [512, False]],                     # nb+10 P4-medium
        [-1, 1, "Conv", [512, 3, 2]],                    # nb+11
        [[-1, nb], 1, "Concat", [1]],                    # nb+12
        [-1, 3, "C3", [1024, False]],                    # nb+13 P5-large
        [[nb + 7, nb + 10, nb + 13], 1, "Detect", ["nc", "anchors"]],
    ]
    return {
        "nc": nc,
        "depth_multiple": gd,
        "width_multiple": gw,
        "anchors": [list(a) for a in COCO_ANCHORS],
        "backbone": b,
        "head": head,
    }


def get_config(name: str, nc: Optional[int] = None) -> Dict:
    """Resolve a config by name: 'yolov5[nsmlx]' or
    'yolov5[nsmlx]_fusion_(add|transformer|transformerx3)'."""
    key = name.lower().replace(".yaml", "")
    if "_fusion_" in key:
        base, fusion = key.split("_fusion_", 1)
        scale = base[-1]
        if base[:-1] == "yolov5" and scale in SCALES and fusion in (
                "add", "transformer", "transformerx3"):
            return yolov5_two_stream(scale, nc=1 if nc is None else nc,
                                     fusion=fusion)
    elif key[:-1] == "yolov5" and key[-1] in SCALES:
        return yolov5(key[-1], nc=80 if nc is None else nc)
    raise ValueError(f"unknown config {name!r} (try yolov5[nsmlx] or "
                     "yolov5[nsmlx]_fusion_(add|transformer|transformerx3))")
