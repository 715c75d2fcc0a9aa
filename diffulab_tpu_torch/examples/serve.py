"""Minimal HTTP serving of an exported sampling artifact, stdlib only (port
of examples/serve.py).

    python -m diffulab_tpu_torch.examples.export_sampler --config-name ... --out artifacts/flow ...
    python -m diffulab_tpu_torch.examples.serve --artifact artifacts/flow --port 8000

    curl -s -X POST localhost:8000/generate \\
        -d '{"seed": 0, "y": [1, 2, 3, 4]}' -o batch.json
    # -> {"shape": [...], "images": "<base64 uint8 NHWC [0, 255]>"}

One artifact is one static (batch, shape, steps, guidance) configuration:
requests with fewer conditioning rows than the artifact's batch are padded
with their last row and trimmed on the way out. ``GET /healthz`` reports the
manifest; a malformed request gets a 400 with ``{"error"}``. The artifact
serves on ``--device`` (default ``cuda``), the device type it was exported
on.
"""

from __future__ import annotations

import argparse
import base64
import json
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np

from diffulab_tpu_torch.deploy import DeployedSampler


def make_handler(sampler: DeployedSampler):
    cond_spec = sampler.manifest["cond"]

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"status": "ok", "manifest": sampler.manifest})
            else:
                self._send(404, {"error": "unknown path (use POST /generate)"})

        def do_POST(self):
            if self.path != "/generate":
                self._send(404, {"error": "unknown path (use POST /generate)"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                seed = int(req.get("seed", 0))
                bsz = sampler.batch_size
                n = bsz
                cond = {}
                for key, spec in cond_spec.items():
                    if key not in req:
                        raise ValueError(f"missing conditioning input '{key}'")
                    arr = np.asarray(req[key], dtype=spec["dtype"])
                    if arr.ndim == len(spec["shape"]):
                        arr = arr[None]  # a single row (e.g. {"y": 3}) -> batch of 1
                    if arr.shape[1:] != tuple(spec["shape"]):
                        raise ValueError(
                            f"'{key}' rows must have shape {spec['shape']}, got {list(arr.shape[1:])}")
                    n = min(n, len(arr))
                    if len(arr) > bsz:
                        raise ValueError(f"'{key}' has {len(arr)} rows > artifact batch {bsz}")
                    # pad to the artifact's static batch; trimmed on response
                    pad = [(0, bsz - len(arr))] + [(0, 0)] * (arr.ndim - 1)
                    cond[key] = np.pad(arr, pad, mode="edge")
                images = sampler(seed=seed, **cond)[:n]
                u8 = ((np.clip(images, -1, 1) + 1) * 127.5).astype(np.uint8)
                self._send(200, {
                    "shape": list(u8.shape),
                    "images": base64.b64encode(u8.tobytes()).decode(),
                })
            except Exception as e:  # noqa: BLE001 — surface as a 400
                self._send(400, {"error": str(e)})

        def log_message(self, fmt, *args):
            print(f"[serve] {fmt % args}")

    return Handler


def warm(sampler: DeployedSampler) -> None:
    """One call on zero conditioning, so that the first request is not the
    one that loads the kernels."""
    sampler(seed=0, **{k: np.zeros((sampler.batch_size, *v["shape"]), v["dtype"])
                       for k, v in sampler.manifest["cond"].items()})


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--artifact", required=True)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    sampler = DeployedSampler(args.artifact, device=args.device)
    warm(sampler)
    print(f"warm; serving {args.artifact} on http://{args.host}:{args.port}")
    HTTPServer((args.host, args.port), make_handler(sampler)).serve_forever()


if __name__ == "__main__":
    main()
