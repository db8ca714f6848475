"""HTTP serving endpoint for the port (twin of densecap_tpu/serve/server.py).

  python -m densecap_tpu_torch.serve.server --checkpoint ck.npz --device cuda

POST /api/infer   body: {"image": "<base64 jpeg>", "stream": id} or raw
                  JPEG bytes (stream id in the X-Stream-Id header)
GET  /            the browser webcam client (densecap_tpu/serve/static)

A JPEG body is decoded in memory by the native pipeline
(`native_lib.decode_jpeg_bytes`) when it builds; PNG, and anything it
does not decode, goes to PIL. --quantize int8 serves fc6/fc7 in int8.
--data_parallel N (with --batch_size a multiple of N) splits each
micro-batch over N GPUs from --device, one replica of the model on
each. A failed warm-up is an error: the server does not start.
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import os
import ssl
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .. import native_lib
from ..cli._common import (add_quantize_flag, maybe_quantize,
                           resolve_data_parallel)
from ..utils.checkpoint import load_checkpoint
from .engine import InferenceEngine

# the browser client is shared with the JAX package's server
_STATIC_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "densecap_tpu", "serve", "static")


def _decode_image(data):
    """Image bytes -> (H, W, 3) uint8 RGB: libdcio's in-memory JPEG decode
    first, PIL for PNG and for what it does not decode."""
    if native_lib.is_available("dcio"):
        rgb = native_lib.decode_jpeg_bytes(data)
        if rgb is not None:
            return rgb
    from PIL import Image

    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


def make_handler(engine):
    """A request handler class serving `engine.process_array`."""

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code, body, ctype="application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Access-Control-Allow-Origin", "*")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *a):  # quiet
            pass

        def do_GET(self):
            path = "client.html" if self.path in ("/", "") else \
                self.path.lstrip("/")
            full = os.path.normpath(os.path.join(_STATIC_DIR, path))
            inside = os.path.commonpath([full, _STATIC_DIR]) == _STATIC_DIR
            if not inside or not os.path.isfile(full):
                self._send(404, b'{"error": "not found"}')
                return
            ctype = ("text/html" if full.endswith(".html")
                     else "application/javascript" if full.endswith(".js")
                     else "text/plain")
            with open(full, "rb") as f:
                self._send(200, f.read(), ctype)

        def do_POST(self):
            if self.path != "/api/infer":
                self._send(404, b'{"error": "not found"}')
                return
            body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
            stream_id = self.headers.get("X-Stream-Id")
            try:
                if self.headers.get("Content-Type", "").startswith(
                        "application/json"):
                    payload = json.loads(body)
                    img_b64 = payload["image"]
                    stream_id = payload.get("stream", stream_id)
                    if "," in img_b64[:64]:  # data-URL prefix
                        img_b64 = img_b64.split(",", 1)[1]
                    data = base64.b64decode(img_b64)
                else:
                    data = body
                rgb = _decode_image(data)
            except Exception as e:  # noqa: BLE001 — a bad payload is a 400
                self._send(400, json.dumps({"error": str(e)}).encode())
                return
            try:
                result = engine.process_array(rgb, stream_id=stream_id)
            except TimeoutError as e:
                self._send(504, json.dumps({"error": str(e)}).encode())
                return
            except Exception as e:  # noqa: BLE001 — engine fault is a 500
                self._send(500, json.dumps({"error": str(e)}).encode())
                return
            self._send(200, json.dumps(result).encode())

    return Handler


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--image_size", type=int, default=480,
                   help="the reference demo serves 480 px frames")
    p.add_argument("--num_proposals", type=int, default=50)
    p.add_argument("--pre_nms_topk", type=int, default=6000,
                   help="NMS scans only the top-K scored anchors (-1 = all)")
    p.add_argument("--max_boxes", type=int, default=50)
    p.add_argument("--batch_size", type=int, default=1,
                   help="micro-batch concurrent requests (throughput mode)")
    p.add_argument("--data_parallel", type=int, default=1,
                   help="shard each micro-batch over this many devices "
                        "(requires --batch_size multiple of it)")
    p.add_argument("--certfile", default="",
                   help="enable TLS (browser webcams need HTTPS off localhost)")
    p.add_argument("--keyfile", default="")
    add_quantize_flag(p)
    args = p.parse_args(argv)

    params, meta, cfg = load_checkpoint(args.checkpoint)
    params = maybe_quantize(params, args.quantize)
    cfg = cfg.replace(image_size=args.image_size,
                      test_max_proposals=args.num_proposals,
                      test_pre_nms_topk=args.pre_nms_topk)
    devices = resolve_data_parallel(args.data_parallel, args.device)
    engine = InferenceEngine(params, cfg, meta.get("idx_to_token", {}),
                             device=args.device, max_boxes=args.max_boxes,
                             batch_size=args.batch_size, devices=devices)
    print("warming up...")
    engine.warmup()

    httpd = ThreadingHTTPServer((args.host, args.port), make_handler(engine))
    if args.certfile:
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(args.certfile, args.keyfile or None)
        httpd.socket = ctx.wrap_socket(httpd.socket, server_side=True)
    print(f"serving on {args.host}:{args.port}")
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
        engine.close()


if __name__ == "__main__":
    main()
