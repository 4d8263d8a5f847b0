"""REST inference service of the port (the counterpart of
multispectral_object_detection_tpu/serve/rest_api.py, reference
utils/flask_rest_api/restapi.py), on the standard library's HTTP server.

    POST /v1/object-detection/<model>   multipart/form-data with the file
        field "image" (and "image_ir" for two-stream models)
        -> 200, JSON records [{xmin, ymin, xmax, ymax, confidence, class,
           name}, ...] in native pixels (DetectionResults.records)
    GET /healthz -> {"status": "ok", "model": <model>}

The same routes, 400 errors and records as the JAX service; uploads are
decoded by the port's ``imdecode`` (PNG, JPEG without cv2 or PIL).
``handle`` is the request handling as a plain function, reachable without
a socket.

    python -m multispectral_object_detection_tpu_torch.serve.rest_api \\
        --model yolov5l_fusion_transformerx3 --port 5000 [--weights CKPT]
"""

from __future__ import annotations

import argparse
import json
import logging
import threading
from email.parser import BytesParser
from email.policy import HTTP
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple

logger = logging.getLogger(__name__)


def parse_multipart(content_type: str, body: bytes) -> Dict[str, bytes]:
    """The file fields of a multipart/form-data body: {field name: bytes}."""
    msg = BytesParser(policy=HTTP).parsebytes(
        b"Content-Type: " + content_type.encode("latin-1") + b"\r\n\r\n"
        + body)
    if not msg.is_multipart():
        return {}
    files = {}
    for part in msg.iter_parts():
        name = part.get_param("name", header="content-disposition")
        if name:
            files[name] = part.get_payload(decode=True) or b""
    return files


def handle(detector, files: Dict[str, bytes]) -> Tuple[int, object]:
    """One detection request: the uploaded files -> (HTTP status, JSON
    body). 400 without "image", or without "image_ir" for a two-stream
    model, or for an image that does not decode."""
    from ..data.imageio import imdecode

    if "image" not in files:
        return 400, {"error": "multipart field 'image' required"}
    try:
        rgb = imdecode(files["image"], "image")
        ir = imdecode(files["image_ir"], "image_ir") \
            if "image_ir" in files else None
    except (ValueError, ImportError) as e:
        return 400, {"error": f"cannot decode the upload: {e}"}
    if detector.two_stream and ir is None:
        return 400, {"error": "two-stream model needs 'image_ir'"}
    res = detector([rgb], [ir] if ir is not None else None)
    return 200, res.records()[0]


def make_server(detector, model_name: str, host: str = "127.0.0.1",
                port: int = 5000) -> ThreadingHTTPServer:
    """A threading HTTP server of the two routes (port 0: a free one).
    Requests are served one at a time on the detector."""
    route = f"/v1/object-detection/{model_name}"
    lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        def _send(self, status: int, body) -> None:
            data = json.dumps(body).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):  # noqa: N802
            if self.path == "/healthz":
                self._send(200, {"status": "ok", "model": model_name})
            else:
                self._send(404, {"error": f"no route {self.path}"})

        def do_POST(self):  # noqa: N802
            if self.path != route:
                self._send(404, {"error": f"no route {self.path}"})
                return
            n = int(self.headers.get("Content-Length") or 0)
            files = parse_multipart(self.headers.get("Content-Type", ""),
                                    self.rfile.read(n))
            with lock:
                status, body = handle(detector, files)
            self._send(status, body)

        def log_message(self, fmt, *args):
            logger.info("%s " + fmt, self.address_string(), *args)

    return ThreadingHTTPServer((host, port), Handler)


def encode_multipart(files: Dict[str, Tuple[str, bytes]],
                     boundary: Optional[str] = None) -> Tuple[str, bytes]:
    """{field: (file name, bytes)} -> (Content-Type, body): a client's
    request, for tests and scripts."""
    boundary = boundary or "msod-boundary-7d1f"
    parts = []
    for field, (fname, data) in files.items():
        parts.append(
            f"--{boundary}\r\nContent-Disposition: form-data; "
            f'name="{field}"; filename="{fname}"\r\n'
            f"Content-Type: application/octet-stream\r\n\r\n".encode()
            + data + b"\r\n")
    body = b"".join(parts) + f"--{boundary}--\r\n".encode()
    return f"multipart/form-data; boundary={boundary}", body


def main(argv=None):
    ap = argparse.ArgumentParser(
        "python -m multispectral_object_detection_tpu_torch.serve.rest_api")
    ap.add_argument("--model", type=str, default="yolov5s")
    ap.add_argument("--nc", type=int, default=None)
    ap.add_argument("--weights", type=str, default=None)
    ap.add_argument("--img-size", type=int, default=640)
    ap.add_argument("--conf", type=float, default=0.25)
    ap.add_argument("--host", type=str, default="0.0.0.0")
    ap.add_argument("--port", type=int, default=5000)
    ap.add_argument("--int8", action="store_true",
                    help="weights-only int8 storage (models/quantize.py)")
    ap.add_argument("--device", type=str, default="",
                    help="'' = cuda (fails without a GPU), 'cpu', 'cuda:N'")
    args = ap.parse_args(argv)

    from ..hub import Detector
    from ..utils.general import device_from_arg

    logging.basicConfig(format="%(message)s", level=logging.INFO)
    det = Detector(args.model, nc=args.nc, weights=args.weights,
                   img_size=args.img_size, conf=args.conf, int8=args.int8,
                   device=device_from_arg(args.device))
    server = make_server(det, args.model, args.host, args.port)
    logger.info(f"serving {args.model} on http://{args.host}:"
                f"{server.server_address[1]}")
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
