"""Built-in model configurations as plain DSL dicts for the parser.

The port's copy of multispectral_object_detection_tpu/models/configs.py:
single-stream YOLOv5 s/m/l/x, the two-stream RGB+IR fusion families
(`add`, `transformer` = 4 CFT stages at P2-P5, `transformerx3` = the
paper's 3 CFT stages at P3/P4/P5) and the hub zoo (yolov3, -spp, -tiny,
yolov5-fpn, -panet, -p2, -p6, -p7, the P6 family yolov5[smlx]6 and
yolov5s-transformer). ``get_config`` resolves the same names as the JAX
package's, with the same ``nc`` defaults.
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


# Named COCO anchor presets per detect-pyramid depth and train resolution
# (the reference asset models/hub/anchors.yaml). Pass one to a generator's
# `anchors=` override or the train CLI's model YAML to re-anchor a config
# without re-running autoanchor.
ANCHOR_PRESETS: Dict[str, List[List[int]]] = {
    "p5_640": COCO_ANCHORS,
    "p6_640": [[9, 11, 21, 19, 17, 41],
               [43, 32, 39, 70, 86, 64],
               [65, 131, 134, 130, 120, 265],
               [282, 180, 247, 354, 512, 387]],
    "p6_1280": [[19, 27, 44, 40, 38, 94],
                [96, 68, 86, 152, 180, 137],
                [140, 301, 303, 264, 238, 542],
                [436, 615, 739, 380, 925, 792]],
    "p6_1920": [[28, 41, 67, 59, 57, 141],
                [144, 103, 129, 227, 270, 205],
                [209, 452, 455, 396, 358, 812],
                [653, 922, 1109, 570, 1387, 1187]],
    "p7_640": [[11, 11, 13, 30, 29, 20],
               [30, 46, 61, 38, 39, 92],
               [78, 80, 146, 66, 79, 163],
               [149, 150, 321, 143, 157, 303],
               [257, 402, 359, 290, 524, 372]],
    "p7_1280": [[19, 22, 54, 36, 32, 77],
                [70, 83, 138, 71, 75, 173],
                [165, 159, 148, 334, 375, 151],
                [334, 317, 251, 626, 499, 474],
                [750, 326, 534, 814, 1079, 818]],
    "p7_1920": [[29, 34, 81, 55, 47, 115],
                [105, 124, 207, 107, 113, 259],
                [247, 238, 222, 500, 563, 227],
                [501, 476, 376, 939, 749, 711],
                [1126, 489, 801, 1222, 1618, 1227]],
}


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


def yolov3(nc: int = 80, spp: bool = False) -> Dict:
    """YOLOv3(-SPP) in the same DSL (reference models/hub/yolov3*.yaml)."""
    backbone = [
        [-1, 1, "Conv", [32, 3, 1]],      # 0
        [-1, 1, "Conv", [64, 3, 2]],      # 1 P1/2
        [-1, 1, "Bottleneck", [64]],
        [-1, 1, "Conv", [128, 3, 2]],     # 3 P2/4
        [-1, 2, "Bottleneck", [128]],
        [-1, 1, "Conv", [256, 3, 2]],     # 5 P3/8
        [-1, 8, "Bottleneck", [256]],
        [-1, 1, "Conv", [512, 3, 2]],     # 7 P4/16
        [-1, 8, "Bottleneck", [512]],
        [-1, 1, "Conv", [1024, 3, 2]],    # 9 P5/32
        [-1, 4, "Bottleneck", [1024]],    # 10
    ]
    head = [
        [-1, 1, "Bottleneck", [1024, False]],
        ([-1, 1, "SPP", [512, [5, 9, 13]]] if spp
         else [-1, 1, "Conv", [512, [1, 1]]]),
        [-1, 1, "Conv", [1024, 3, 1]],
        [-1, 1, "Conv", [512, 1, 1]],
        [-1, 1, "Conv", [1024, 3, 1]],    # 15 P5/32-large
        [-2, 1, "Conv", [256, 1, 1]],
        [-1, 1, "nn.Upsample", ["None", 2, "nearest"]],
        [[-1, 8], 1, "Concat", [1]],
        [-1, 1, "Bottleneck", [512, False]],
        [-1, 1, "Bottleneck", [512, False]],
        [-1, 1, "Conv", [256, 1, 1]],
        [-1, 1, "Conv", [512, 3, 1]],     # 22 P4/16-medium
        [-2, 1, "Conv", [128, 1, 1]],
        [-1, 1, "nn.Upsample", ["None", 2, "nearest"]],
        [[-1, 6], 1, "Concat", [1]],
        [-1, 1, "Bottleneck", [256, False]],
        [-1, 2, "Bottleneck", [256, False]],  # 27 P3/8-small
        [[27, 22, 15], 1, "Detect", ["nc", "anchors"]],
    ]
    return {
        "nc": nc, "depth_multiple": 1.0, "width_multiple": 1.0,
        "anchors": [[10, 13, 16, 30, 33, 23],
                    [30, 61, 62, 45, 59, 119],
                    [116, 90, 156, 198, 373, 326]],
        "backbone": backbone, "head": head,
    }


def yolov5_p6(scale: str = "s", nc: int = 80) -> Dict:
    """4-scale P3-P6 variant (reference models/hub/yolov5{s,m,l,x}6.yaml)."""
    gd, gw = SCALES[scale]
    backbone = [
        [-1, 1, "Focus", [64, 3]],          # 0 P1/2
        [-1, 1, "Conv", [128, 3, 2]],       # 1 P2/4
        [-1, 3, "C3", [128]],
        [-1, 1, "Conv", [256, 3, 2]],       # 3 P3/8
        [-1, 9, "C3", [256]],
        [-1, 1, "Conv", [512, 3, 2]],       # 5 P4/16
        [-1, 9, "C3", [512]],
        [-1, 1, "Conv", [768, 3, 2]],       # 7 P5/32
        [-1, 3, "C3", [768]],
        [-1, 1, "Conv", [1024, 3, 2]],      # 9 P6/64
        [-1, 1, "SPP", [1024, [3, 5, 7]]],
        [-1, 3, "C3", [1024, False]],       # 11
    ]
    head = [
        [-1, 1, "Conv", [768, 1, 1]],                    # 12
        [-1, 1, "nn.Upsample", ["None", 2, "nearest"]],
        [[-1, 8], 1, "Concat", [1]],
        [-1, 3, "C3", [768, False]],                     # 15
        [-1, 1, "Conv", [512, 1, 1]],                    # 16
        [-1, 1, "nn.Upsample", ["None", 2, "nearest"]],
        [[-1, 6], 1, "Concat", [1]],
        [-1, 3, "C3", [512, False]],                     # 19
        [-1, 1, "Conv", [256, 1, 1]],                    # 20
        [-1, 1, "nn.Upsample", ["None", 2, "nearest"]],
        [[-1, 4], 1, "Concat", [1]],
        [-1, 3, "C3", [256, False]],                     # 23 P3
        [-1, 1, "Conv", [256, 3, 2]],
        [[-1, 20], 1, "Concat", [1]],
        [-1, 3, "C3", [512, False]],                     # 26 P4
        [-1, 1, "Conv", [512, 3, 2]],
        [[-1, 16], 1, "Concat", [1]],
        [-1, 3, "C3", [768, False]],                     # 29 P5
        [-1, 1, "Conv", [768, 3, 2]],
        [[-1, 12], 1, "Concat", [1]],
        [-1, 3, "C3", [1024, False]],                    # 32 P6
        [[23, 26, 29, 32], 1, "Detect", ["nc", "anchors"]],
    ]
    return {
        "nc": nc, "depth_multiple": gd, "width_multiple": gw,
        "anchors": [[19, 27, 44, 40, 38, 94],
                    [96, 68, 86, 152, 180, 137],
                    [140, 301, 303, 264, 238, 542],
                    [436, 615, 739, 380, 925, 792]],
        "backbone": backbone, "head": head,
    }


def yolov3_tiny(nc: int = 80) -> Dict:
    """YOLOv3-tiny (reference models/hub/yolov3-tiny.yaml): two detect
    scales at strides 16/32, MaxPool downsampling."""
    backbone = [
        [-1, 1, "Conv", [16, 3, 1]],            # 0
        [-1, 1, "nn.MaxPool2d", [2, 2, 0]],     # 1 P1/2
        [-1, 1, "Conv", [32, 3, 1]],
        [-1, 1, "nn.MaxPool2d", [2, 2, 0]],     # 3 P2/4
        [-1, 1, "Conv", [64, 3, 1]],
        [-1, 1, "nn.MaxPool2d", [2, 2, 0]],     # 5 P3/8
        [-1, 1, "Conv", [128, 3, 1]],
        [-1, 1, "nn.MaxPool2d", [2, 2, 0]],     # 7 P4/16
        [-1, 1, "Conv", [256, 3, 1]],
        [-1, 1, "nn.MaxPool2d", [2, 2, 0]],     # 9 P5/32
        [-1, 1, "Conv", [512, 3, 1]],
        [-1, 1, "nn.ZeroPad2d", [[0, 1, 0, 1]]],
        [-1, 1, "nn.MaxPool2d", [2, 1, 0]],     # 12
    ]
    head = [
        [-1, 1, "Conv", [1024, 3, 1]],
        [-1, 1, "Conv", [256, 1, 1]],
        [-1, 1, "Conv", [512, 3, 1]],           # 15 P5/32-large
        [-2, 1, "Conv", [128, 1, 1]],
        [-1, 1, "nn.Upsample", ["None", 2, "nearest"]],
        [[-1, 8], 1, "Concat", [1]],
        [-1, 1, "Conv", [256, 3, 1]],           # 19 P4/16-medium
        [[19, 15], 1, "Detect", ["nc", "anchors"]],
    ]
    return {
        "nc": nc, "depth_multiple": 1.0, "width_multiple": 1.0,
        "anchors": [[10, 14, 23, 27, 37, 58],
                    [81, 82, 135, 169, 344, 319]],
        "backbone": backbone, "head": head,
    }


def yolov5_fpn(nc: int = 80) -> Dict:
    """FPN (top-down only) head over a BottleneckCSP backbone
    (reference models/hub/yolov5-fpn.yaml)."""
    backbone = [
        [-1, 1, "Focus", [64, 3]],                 # 0 P1/2
        [-1, 1, "Conv", [128, 3, 2]],              # 1 P2/4
        [-1, 3, "Bottleneck", [128]],
        [-1, 1, "Conv", [256, 3, 2]],              # 3 P3/8
        [-1, 9, "BottleneckCSP", [256]],
        [-1, 1, "Conv", [512, 3, 2]],              # 5 P4/16
        [-1, 9, "BottleneckCSP", [512]],
        [-1, 1, "Conv", [1024, 3, 2]],             # 7 P5/32
        [-1, 1, "SPP", [1024, [5, 9, 13]]],
        [-1, 6, "BottleneckCSP", [1024]],          # 9
    ]
    head = [
        [-1, 3, "BottleneckCSP", [1024, False]],   # 10 P5-large
        [-1, 1, "nn.Upsample", ["None", 2, "nearest"]],
        [[-1, 6], 1, "Concat", [1]],
        [-1, 1, "Conv", [512, 1, 1]],
        [-1, 3, "BottleneckCSP", [512, False]],    # 14 P4-medium
        [-1, 1, "nn.Upsample", ["None", 2, "nearest"]],
        [[-1, 4], 1, "Concat", [1]],
        [-1, 1, "Conv", [256, 1, 1]],
        [-1, 3, "BottleneckCSP", [256, False]],    # 18 P3-small
        [[18, 14, 10], 1, "Detect", ["nc", "anchors"]],
    ]
    return {
        "nc": nc, "depth_multiple": 1.0, "width_multiple": 1.0,
        "anchors": [list(a) for a in COCO_ANCHORS],
        "backbone": backbone, "head": head,
    }


def yolov5_panet(nc: int = 80) -> Dict:
    """PANet head over a BottleneckCSP backbone (models/hub/yolov5-panet.yaml):
    the yolov5 topology with BottleneckCSP in place of C3."""
    backbone = [
        [-1, 1, "Focus", [64, 3]],
        [-1, 1, "Conv", [128, 3, 2]],
        [-1, 3, "BottleneckCSP", [128]],
        [-1, 1, "Conv", [256, 3, 2]],
        [-1, 9, "BottleneckCSP", [256]],
        [-1, 1, "Conv", [512, 3, 2]],
        [-1, 9, "BottleneckCSP", [512]],
        [-1, 1, "Conv", [1024, 3, 2]],
        [-1, 1, "SPP", [1024, [5, 9, 13]]],
        [-1, 3, "BottleneckCSP", [1024, False]],   # 9
    ]
    head = [
        [-1, 1, "Conv", [512, 1, 1]],              # 10
        [-1, 1, "nn.Upsample", ["None", 2, "nearest"]],
        [[-1, 6], 1, "Concat", [1]],
        [-1, 3, "BottleneckCSP", [512, False]],    # 13
        [-1, 1, "Conv", [256, 1, 1]],              # 14
        [-1, 1, "nn.Upsample", ["None", 2, "nearest"]],
        [[-1, 4], 1, "Concat", [1]],
        [-1, 3, "BottleneckCSP", [256, False]],    # 17 P3
        [-1, 1, "Conv", [256, 3, 2]],
        [[-1, 14], 1, "Concat", [1]],
        [-1, 3, "BottleneckCSP", [512, False]],    # 20 P4
        [-1, 1, "Conv", [512, 3, 2]],
        [[-1, 10], 1, "Concat", [1]],
        [-1, 3, "BottleneckCSP", [1024, False]],   # 23 P5
        [[17, 20, 23], 1, "Detect", ["nc", "anchors"]],
    ]
    return {
        "nc": nc, "depth_multiple": 1.0, "width_multiple": 1.0,
        "anchors": [list(a) for a in COCO_ANCHORS],
        "backbone": backbone, "head": head,
    }


def yolov5_p2(nc: int = 80) -> Dict:
    """P2-augmented head (models/hub/yolov5-p2.yaml): an extra top-down stage
    to P2/4 then back down; detect still at P3/P4/P5. `anchors: 3` =
    autoanchor placeholders."""
    cfg = yolov5("l", nc=nc)  # shares the exact backbone at gd=gw=1.0
    head = [
        [-1, 1, "Conv", [512, 1, 1]],                    # 10
        [-1, 1, "nn.Upsample", ["None", 2, "nearest"]],
        [[-1, 6], 1, "Concat", [1]],
        [-1, 3, "C3", [512, False]],                     # 13
        [-1, 1, "Conv", [256, 1, 1]],                    # 14
        [-1, 1, "nn.Upsample", ["None", 2, "nearest"]],
        [[-1, 4], 1, "Concat", [1]],
        [-1, 3, "C3", [256, False]],                     # 17 P3-small
        [-1, 1, "Conv", [128, 1, 1]],                    # 18
        [-1, 1, "nn.Upsample", ["None", 2, "nearest"]],
        [[-1, 2], 1, "Concat", [1]],
        [-1, 1, "C3", [128, False]],                     # 21 P2-xsmall
        [-1, 1, "Conv", [128, 3, 2]],
        [[-1, 18], 1, "Concat", [1]],
        [-1, 3, "C3", [256, False]],                     # 24 P3-small
        [-1, 1, "Conv", [256, 3, 2]],
        [[-1, 14], 1, "Concat", [1]],
        [-1, 3, "C3", [512, False]],                     # 27 P4-medium
        [-1, 1, "Conv", [512, 3, 2]],
        [[-1, 10], 1, "Concat", [1]],
        [-1, 3, "C3", [1024, False]],                    # 30 P5-large
        [[24, 27, 30], 1, "Detect", ["nc", "anchors"]],
    ]
    cfg["head"] = head
    cfg["anchors"] = 3
    return cfg


def _p6_trunk() -> List[list]:
    return [
        [-1, 1, "Focus", [64, 3]],          # 0 P1/2
        [-1, 1, "Conv", [128, 3, 2]],       # 1 P2/4
        [-1, 3, "C3", [128]],
        [-1, 1, "Conv", [256, 3, 2]],       # 3 P3/8
        [-1, 9, "C3", [256]],
        [-1, 1, "Conv", [512, 3, 2]],       # 5 P4/16
        [-1, 9, "C3", [512]],
        [-1, 1, "Conv", [768, 3, 2]],       # 7 P5/32
        [-1, 3, "C3", [768]],
    ]


def yolov5_p7(nc: int = 80) -> Dict:
    """6-scale trunk, detect at P3-P7 / strides 8-128
    (models/hub/yolov5-p7.yaml). `anchors: 3` placeholders."""
    backbone = _p6_trunk() + [
        [-1, 1, "Conv", [1024, 3, 2]],      # 9 P6/64
        [-1, 3, "C3", [1024]],
        [-1, 1, "Conv", [1280, 3, 2]],      # 11 P7/128
        [-1, 1, "SPP", [1280, [3, 5]]],
        [-1, 3, "C3", [1280, False]],       # 13
    ]
    head = [
        [-1, 1, "Conv", [1024, 1, 1]],                   # 14
        [-1, 1, "nn.Upsample", ["None", 2, "nearest"]],
        [[-1, 10], 1, "Concat", [1]],
        [-1, 3, "C3", [1024, False]],                    # 17
        [-1, 1, "Conv", [768, 1, 1]],                    # 18
        [-1, 1, "nn.Upsample", ["None", 2, "nearest"]],
        [[-1, 8], 1, "Concat", [1]],
        [-1, 3, "C3", [768, False]],                     # 21
        [-1, 1, "Conv", [512, 1, 1]],                    # 22
        [-1, 1, "nn.Upsample", ["None", 2, "nearest"]],
        [[-1, 6], 1, "Concat", [1]],
        [-1, 3, "C3", [512, False]],                     # 25
        [-1, 1, "Conv", [256, 1, 1]],                    # 26
        [-1, 1, "nn.Upsample", ["None", 2, "nearest"]],
        [[-1, 4], 1, "Concat", [1]],
        [-1, 3, "C3", [256, False]],                     # 29 P3-small
        [-1, 1, "Conv", [256, 3, 2]],
        [[-1, 26], 1, "Concat", [1]],
        [-1, 3, "C3", [512, False]],                     # 32 P4-medium
        [-1, 1, "Conv", [512, 3, 2]],
        [[-1, 22], 1, "Concat", [1]],
        [-1, 3, "C3", [768, False]],                     # 35 P5-large
        [-1, 1, "Conv", [768, 3, 2]],
        [[-1, 18], 1, "Concat", [1]],
        [-1, 3, "C3", [1024, False]],                    # 38 P6-xlarge
        [-1, 1, "Conv", [1024, 3, 2]],
        [[-1, 14], 1, "Concat", [1]],
        [-1, 3, "C3", [1280, False]],                    # 41 P7-xxlarge
        [[29, 32, 35, 38, 41], 1, "Detect", ["nc", "anchors"]],
    ]
    return {
        "nc": nc, "depth_multiple": 1.0, "width_multiple": 1.0,
        "anchors": 3, "backbone": backbone, "head": head,
    }


def yolov5_transformer(scale: str = "s", nc: int = 80) -> Dict:
    """C3TR (transformer bottleneck) at the SPP tail
    (models/hub/yolov5s-transformer.yaml)."""
    cfg = yolov5(scale, nc=nc)
    cfg["backbone"][-1] = [-1, 3, "C3TR", [1024, False]]
    return cfg


def get_config(name: str, nc: Optional[int] = None) -> Dict:
    """Resolve a config by name, e.g. 'yolov5s', 'yolov5l6', 'yolov3-tiny',
    'yolov5l_fusion_transformerx3' or 'yolov5l_fusion_transformerx3_llvip'
    (a dataset suffix sets nc: flir 3, llvip 1, vedai 9)."""
    name = name.lower().replace(".yaml", "")
    n_cls = 80 if nc is None else nc
    if name.startswith("yolov3"):
        if "tiny" in name:
            return yolov3_tiny(nc=n_cls)
        return yolov3(nc=n_cls, spp="spp" in name)
    if name in ("yolov5-fpn", "yolov5_fpn"):
        return yolov5_fpn(nc=n_cls)
    if name in ("yolov5-panet", "yolov5_panet"):
        return yolov5_panet(nc=n_cls)
    if name in ("yolov5-p2", "yolov5_p2"):
        return yolov5_p2(nc=n_cls)
    if name in ("yolov5-p7", "yolov5_p7"):
        return yolov5_p7(nc=n_cls)
    if name in ("yolov5-p6", "yolov5_p6"):
        cfg = yolov5_p6(scale="l", nc=n_cls)
        cfg["anchors"] = 3  # models/hub/yolov5-p6.yaml uses placeholders
        return cfg
    if "transformer" in name and "_fusion_" not in name:
        return yolov5_transformer(scale=name[6], nc=n_cls)
    if name.endswith("6") and name.startswith("yolov5"):
        return yolov5_p6(scale=name[6], nc=80 if nc is None else nc)
    if "_fusion_" in name:
        base, fus = name.split("_fusion_", 1)
        scale = base[-1]
        if nc is None:
            # dataset-suffixed reference names carry nc in their YAML
            # (models/transformer/*.yaml: FLIR nc=3, llvip nc=1, vedai nc=9)
            for ds, ds_nc in (("flir", 3), ("llvip", 1), ("vedai", 9)):
                if ds in fus:
                    nc = ds_nc
                    break
        fus = {"transformerx3": "transformerx3", "transformer": "transformer",
               "add": "add"}.get(fus.split("_")[0], fus)
        if scale not in SCALES:
            raise ValueError(f"unknown config {name!r}: scale {scale!r} not "
                             f"in {sorted(SCALES)}")
        return yolov5_two_stream(scale=scale, nc=1 if nc is None else nc, fusion=fus)
    scale = name[-1]
    if not name.startswith("yolov5") or scale not in SCALES:
        raise ValueError(
            f"unknown config {name!r} (try yolov5[nsmlx], yolov5[smlx]6, "
            f"yolov3(-spp|-tiny), yolov5-(fpn|panet|p2|p6|p7), "
            f"yolov5s-transformer, or *_fusion_(add|transformer|"
            f"transformerx3), or a YAML path)")
    return yolov5(scale=scale, nc=80 if nc is None else nc)
