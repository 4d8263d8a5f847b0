"""Inference input sources: images, directories, globs, videos, webcams and
streams.

Counterpart of multispectral_object_detection_tpu/data/sources.py, with
the same iterator: (path or name, RGB frame, capture or None). Images go
through the port's own reader (``data/imageio.imread``: PNG, and JPEG
through libjpeg, without cv2); video files, webcams and streams need cv2's
``VideoCapture`` and raise an ImportError that names cv2 where it is not
installed. ``ThreadedStreams`` keeps the freshest frame of each stream on a
daemon thread, as the reference's LoadStreams.
"""

from __future__ import annotations

import glob
import threading
import time
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np

from .imageio import imread

VID_EXTS = {".mov", ".avi", ".mp4", ".mpg", ".mpeg", ".m4v", ".wmv", ".mkv"}
IMG_EXTS = {".bmp", ".jpg", ".jpeg", ".png", ".tif", ".tiff", ".webp"}


def _cv2(what: str):
    try:
        import cv2
    except ImportError:
        raise ImportError(f"{what} needs cv2 (opencv-python), which is not "
                          f"installed; images and directories of images "
                          f"are read without it") from None
    return cv2


def is_stream(source: str) -> bool:
    """A webcam index or a stream URL."""
    return str(source).isnumeric() or str(source).lower().startswith(
        ("rtsp://", "rtmp://", "http://", "https://"))


class MediaSource:
    """Iterate a path (image, video, directory or glob), a webcam index or
    a stream URL."""

    def __init__(self, source: str):
        self.source = str(source)
        self.is_webcam = self.source.isnumeric()
        self.is_stream = is_stream(self.source) and not self.is_webcam

    def _files(self) -> List[Path]:
        p = Path(self.source)
        if p.is_dir():
            return sorted(f for f in p.rglob("*")
                          if f.suffix.lower() in IMG_EXTS | VID_EXTS)
        if any(ch in self.source for ch in "*?["):
            return sorted(Path(f) for f in glob.glob(self.source,
                                                     recursive=True)
                          if Path(f).suffix.lower() in IMG_EXTS | VID_EXTS)
        return [p]

    def __iter__(self) -> Iterator[Tuple[str, np.ndarray, Optional[object]]]:
        if self.is_webcam or self.is_stream:
            cv2 = _cv2(f"reading {self.source}")
            cap = cv2.VideoCapture(int(self.source) if self.is_webcam
                                   else self.source)
            assert cap.isOpened(), f"failed to open {self.source}"
            n = 0
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                n += 1
                yield f"{self.source}_{n}", frame[:, :, ::-1], cap
            cap.release()
            return
        for f in self._files():
            if f.suffix.lower() in VID_EXTS:
                cap = _cv2(f"reading the video {f}").VideoCapture(str(f))
                while True:
                    ok, frame = cap.read()
                    if not ok:
                        break
                    yield str(f), frame[:, :, ::-1], cap
                cap.release()
            else:
                yield str(f), imread(f), None


class ThreadedStreams:
    """Several streams, one daemon thread each keeping its latest frame
    (reference LoadStreams, datasets.py:437-515). Needs cv2."""

    def __init__(self, sources: List[str], fps_sleep: float = 0.01):
        cv2 = _cv2("reading streams")
        self.caps = []
        self.frames: List[Optional[np.ndarray]] = []
        self.threads = []
        self.running = True
        self.fps_sleep = fps_sleep
        for s in sources:
            cap = cv2.VideoCapture(int(s) if s.isnumeric() else s)
            assert cap.isOpened(), f"failed to open stream {s}"
            ok, frame = cap.read()
            assert ok, f"failed to read from {s}"
            self.caps.append(cap)
            self.frames.append(frame[:, :, ::-1])
            t = threading.Thread(target=self._reader,
                                 args=(len(self.caps) - 1,), daemon=True)
            t.start()
            self.threads.append(t)

    def _reader(self, i: int):
        while self.running:
            ok, frame = self.caps[i].read()
            if ok:
                self.frames[i] = frame[:, :, ::-1]
            else:
                time.sleep(0.1)
            time.sleep(self.fps_sleep)

    def latest(self) -> List[np.ndarray]:
        return [f.copy() for f in self.frames]

    def close(self):
        self.running = False
        for c in self.caps:
            c.release()
