"""Minimal HTTP detection server over an exported artifact — the port of
`examples/serve_http.py`.

The serving host needs the artifact directory from `cli export`, torch,
numpy, the two kernel modules whose custom ops the program calls, and PIL
to decode a posted image: no model code.

    python -m objectdetection_ssd_torch.cli export --checkpoint-dir ckpt \\
        --out-dir artifact --serve-batch-size 1
    python -m objectdetection_ssd_torch.serve_http artifact --port 8000

    curl -s -X POST --data-binary @dog.jpg localhost:8000/detect

POST /detect with a JPEG/PNG body returns JSON detections in pixel
coordinates of the posted image.  ``--dynamic-batch`` (with an artifact
exported for a batch > 1) coalesces concurrent requests into shared
program calls (`MicroBatcher`).  It is off by default, as in the JAX
example: whether it wins depends on where the time of a request goes, so
measure before picking.  ``--device cpu`` serves on the CPU (the kernels'
plain versions).
"""

from __future__ import annotations

import argparse
import io
import json
import queue
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from objectdetection_ssd_torch.device import resolve_device
# Registers the custom ops the program calls (K1, K3) and reads the
# artifact; it imports no model code.
from objectdetection_ssd_torch.infer.export import load_program, read_meta

_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


class MinimalExportedDetector:
    """The artifact's program, called on exactly one exported-size batch:
    (batch_size, S, S, 3) images -> (boxes, scores, classes, valid) on the
    device, returned before the device finishes.  `infer.export.
    ExportedDetector` adds the padding and chunking."""

    def __init__(self, artifact_dir: str, device=None):
        self.device = resolve_device(device)
        self.meta = read_meta(artifact_dir)
        self._call = load_program(artifact_dir, self.device).module()

    @torch.inference_mode()
    def __call__(self, images: np.ndarray):
        return self._call(torch.as_tensor(images).to(self.device))


class MicroBatcher:
    """Coalesce concurrent requests into one program call (dynamic
    batching).

    One dispatcher thread takes preprocessed images off a queue.  The first
    image of a batch waits at most ``max_wait_ms`` for companions; the
    batch is padded (by repeating row 0) to the artifact's batch size and
    runs as ONE program call, and each row goes back to its waiting
    handler thread.  Under load the wait never triggers, so throughput
    approaches batch_size images per call, while an idle server still
    answers a lone request within ~max_wait_ms.

    Two stages: the dispatch thread launches a call (the card runs it
    asynchronously) and the completion thread copies its results to the
    host and wakes the waiters, so one batch's copy overlaps the next
    one's launch.  ``max_in_flight`` bounds the calls between the two.  A
    failure in either stage is raised in every caller of its batch.
    `close` stops both threads.
    """

    def __init__(self, detector, max_wait_ms: float = 4.0,
                 max_in_flight: int = 4):
        self._det = detector
        self._bs = int(detector.meta["batch_size"])
        self._wait = max_wait_ms / 1000.0
        self._q: queue.Queue = queue.Queue()
        self._pending: queue.Queue = queue.Queue(maxsize=max_in_flight)
        self._threads = [threading.Thread(target=self._loop, daemon=True),
                         threading.Thread(target=self._completion_loop,
                                          daemon=True)]
        for t in self._threads:
            t.start()

    def infer_one(self, arr: np.ndarray):
        """Blocking single-image inference; returns this image's
        (boxes, scores, classes, valid) rows as numpy arrays."""
        done = threading.Event()
        slot = [None, None]                    # [result, exception]
        self._q.put((arr, slot, done))
        done.wait()
        if slot[1] is not None:
            raise slot[1]
        return slot[0]

    def close(self, timeout: float = 30.0) -> None:
        """Stop the threads once the requests already queued are
        answered."""
        self._q.put(None)
        for t in self._threads:
            t.join(timeout)

    def _loop(self):
        while True:
            first = self._q.get()
            if first is None:
                self._pending.put(None)
                return
            batch = [first]
            deadline = time.perf_counter() + self._wait
            stop = False
            while len(batch) < self._bs:
                left = deadline - time.perf_counter()
                if left <= 0:
                    break
                try:
                    item = self._q.get(timeout=left)
                except queue.Empty:
                    break
                if item is None:
                    stop = True
                    break
                batch.append(item)
            rows = [item[0] for item in batch]
            rows += [rows[0]] * (self._bs - len(rows))     # pad the tail
            try:
                out = self._det(np.stack(rows))            # async launch
            except Exception as e:
                for _, slot, done in batch:
                    slot[1] = e
                    done.set()
            else:
                self._pending.put((out, batch))  # blocks at max_in_flight
            if stop:
                self._pending.put(None)
                return

    def _completion_loop(self):
        while True:
            item = self._pending.get()
            if item is None:
                return
            out, batch = item
            try:
                boxes, scores, classes, valid = (t.cpu().numpy()
                                                 for t in out)
                for i, (_, slot, done) in enumerate(batch):
                    slot[0] = (boxes[i], scores[i], classes[i], valid[i])
                    done.set()
            except Exception as e:              # fan the failure out too
                for _, slot, done in batch:
                    slot[1] = e
                    done.set()


def build_handler(detector, classes, batcher: MicroBatcher | None = None):
    """The request handler class: decode the posted image, resize it to
    the artifact's size, run it (through ``batcher`` when given) and
    answer JSON detections in the image's pixel coordinates."""
    from PIL import Image

    size = detector.meta["image_size"]
    bs = detector.meta["batch_size"]
    # uint8 artifacts take raw resized pixels and normalize inside the
    # program; float32 ones take host-normalized images.
    uint8_input = detector.meta.get("input_dtype", "float32") == "uint8"

    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):
            if self.path != "/detect":
                self.send_error(404)
                return
            length = int(self.headers.get("Content-Length", 0))
            raw = self.rfile.read(length)
            try:
                im = Image.open(io.BytesIO(raw)).convert("RGB")
            except Exception:
                self.send_error(400, "not an image")
                return
            w, h = im.size
            if uint8_input:
                arr = np.asarray(im.resize((size, size)), np.uint8)
            else:
                arr = np.asarray(im.resize((size, size)), np.float32) / 255.0
                arr = (arr - _MEAN) / _STD
            if batcher is not None:
                boxes, scores, det_classes, valid = batcher.infer_one(arr)
            else:
                batch = np.broadcast_to(arr, (bs, size, size, 3)).copy()
                boxes, scores, det_classes, valid = (
                    t[0].cpu().numpy() for t in detector(batch))
            out = {
                "detections": [
                    {"box_xyxy": [round(float(v), 1) for v in b],
                     "label": classes[int(c)],
                     "score": round(float(s), 4)}
                    for b, c, s in zip(boxes[valid] * [w, h, w, h],
                                       det_classes[valid], scores[valid])
                ]
            }
            body = json.dumps(out).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):  # quiet
            pass

    return Handler


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("artifact", help="directory written by `cli export`")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs on the CPU)")
    p.add_argument("--dynamic-batch", action="store_true",
                   help="coalesce concurrent requests into shared program "
                        "calls (needs a batch_size > 1 artifact)")
    p.add_argument("--max-wait-ms", type=float, default=4.0,
                   help="max time the first request of a batch waits for "
                        "companions (idle-server latency floor)")
    args = p.parse_args(argv)

    det = MinimalExportedDetector(args.artifact, device=args.device)
    batcher = None
    if args.dynamic_batch:
        if det.meta["batch_size"] <= 1:
            raise SystemExit(
                "error: --dynamic-batch needs an artifact exported with "
                "batch_size > 1 (this one is batch_size="
                f"{det.meta['batch_size']}; re-export with "
                "--serve-batch-size N)")
        batcher = MicroBatcher(det, max_wait_ms=args.max_wait_ms)
    handler = build_handler(det, det.meta["classes"], batcher=batcher)
    # Handlers must overlap for requests to coalesce in the batcher.
    server = ThreadingHTTPServer(("127.0.0.1", args.port), handler)
    mode = ("dynamic batching" if batcher is not None
            else "per-request calls")
    print(f"serving on http://127.0.0.1:{args.port}/detect "
          f"(batch={det.meta['batch_size']}, {mode}, {det.device})")
    try:
        server.serve_forever()
    finally:
        server.server_close()
        if batcher is not None:
            batcher.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
