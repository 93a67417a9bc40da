"""Micro-batching server over the batched pipeline, and its HTTP endpoint.

Counterpart of the JAX package's ``serve.py``:

* :class:`BatchingPredictor`: concurrent callers submit single images; a
  dispatcher thread packs them into fixed-shape batches, padded to the
  smallest power-of-two bucket that fits, and runs the batched pipeline
  (normalise -> forward -> decode -> NMS), or serves from a one-file
  ``.edz`` artifact (:meth:`BatchingPredictor.from_artifact`, export.py:
  one bucket, the exported batch); a resolver thread fetches the
  results and resolves each caller's future with boxes in source pixels.
  Device compute overlaps the transfer of results (``pipeline_depth``), a
  bounded queue sheds overload, and crash guards fail callers instead of
  hanging them.
* ``python -m efficientdet_tpu_torch.serve [--edz model.edz]``: a stdlib
  HTTP endpoint (POST /predict with a JPEG/PNG body -> JSON detections; 501
  on a host without PIL, which decodes the body).

Every request is letterboxed on the host to the model resolution, so on the
card one CUDA graph per bucket serves all traffic. There:

* the dispatcher replays on the predictor's own stream, under its own
  ``torch.inference_mode`` (both are per-thread state);
* a replay overwrites the graph's outputs, and may overwrite another
  bucket's (the buckets share one memory pool), so right after each replay
  the outputs are copied into pinned host buffers of the batch's own, on
  the replay's stream, and an event is recorded that the resolver waits on:
  batch N's results are on the host before batch N+1's replay can touch
  them;
* images are packed straight into a pinned input buffer of the batch's
  own, which the replay's copy to the card reads. Every pinned buffer comes
  from torch's caching host allocator, which hands a block out again only
  after the copies enqueued on it have finished and its tensor is freed:
  no batch can write into another's buffers, however many are in flight
  and whoever (the dispatcher or :meth:`BatchingPredictor.warmup`) runs
  them.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import List, Optional, Tuple

import numpy as np
import torch

from .configs import PHIS, EvalConfig, parse_phi
from .data.common import letterbox_hostside
from .models.detector import predict_pipeline, resolve_device
from .utils.cuda_graph import GraphedCall


class PredictorOverloaded(RuntimeError):
    """Raised by :meth:`BatchingPredictor.predict` when ``max_pending``
    requests are already queued: shed load or retry with backoff."""


def _bucket_sizes(batch_size: int) -> List[int]:
    """Batch buckets: the powers of two below ``batch_size``, then
    ``batch_size`` itself, ascending. One graph is captured per bucket, so a
    partial micro-batch is padded only to the smallest bucket that fits."""
    sizes = []
    b = 1
    while b < batch_size:
        sizes.append(b)
        b *= 2
    sizes.append(batch_size)
    return sizes


class _Fetch:
    """One output of a dispatched batch: ``np.asarray`` waits for its copy
    to the host and returns a copy of its own, so the pinned buffer goes
    back to the allocator with the batch."""

    def __init__(self, event, host: torch.Tensor):
        self.event = event
        self.host = host

    def __array__(self, dtype=None, copy=None):
        self.event.synchronize()
        out = self.host.numpy().copy()
        return out if dtype is None else out.astype(dtype)


class BatchingPredictor:
    """Micro-batching wrapper over the batched pipeline.

    Args:
      model: an :class:`EfficientDet` on its device (``fuse_for_inference``
        it for production speed); the server runs where the model lies.
      batch_size: the largest bucket.
      max_delay_ms: how long the collector waits to fill a batch before
        flushing a partial one.
      eval_config: detection filtering parameters.
      max_pending: backpressure bound, the images queued but not yet
        flushed; beyond it ``predict`` raises :class:`PredictorOverloaded`
        (None: ``32 * batch_size``; 0: unbounded).
      pipeline_depth: batches that may be in flight at once; with 2 the
        dispatcher replays batch N+1 while batch N's results come back.
      bucket_batches: pad partial batches to power-of-two buckets (True) or
        always to ``batch_size`` (one graph).

    On the card each bucket's graph is captured at its first batch; call
    :meth:`warmup` to capture all of them before traffic. The host's share
    of a request is its letterbox, in the caller's thread: run a server
    process with ``torch.set_num_threads(1)`` (the CLI does, on the card),
    or concurrent callers' resizes each start a team of intra-op threads
    and oversubscribe the cores.
    """

    def __init__(
        self,
        model,
        batch_size: int = 16,
        max_delay_ms: float = 5.0,
        eval_config: Optional[EvalConfig] = None,
        max_pending: Optional[int] = None,
        pipeline_depth: int = 2,
        bucket_batches: bool = True,
    ):
        self.model = model
        self.manifest = None
        self.batch_size = batch_size
        self.max_delay = max_delay_ms / 1e3
        self.size = model.config.image_size
        self.eval_config = eval_config or EvalConfig()
        self._buckets = _bucket_sizes(batch_size) if bucket_batches else [batch_size]
        self._start_device(next(model.parameters()).device,
                           lambda x: predict_pipeline(self.model, x, self.eval_config))
        self._start_runtime(max_pending, pipeline_depth)

    @classmethod
    def from_artifact(
        cls,
        path: str,
        max_delay_ms: float = 5.0,
        max_pending: Optional[int] = None,
        pipeline_depth: int = 2,
        device=None,
    ) -> "BatchingPredictor":
        """Serve directly from a one-file ``.edz`` export artifact.

        The artifact (``efficientdet_tpu_torch.export.save_exported``)
        carries the exported predict program, its weights and the eval
        config: no model build, checkpoint restore or BN folding happens on
        the serving host, and ``batch_size`` and the image size come from
        the manifest (the exported program's batch is static, so there is
        one bucket). ``device``: None means the GPU, raising without one;
        on the card the bucket is one CUDA graph of the loaded program.
        """
        from .export import load_exported

        device = resolve_device(device)
        predict, manifest = load_exported(path, device)
        if not manifest.get("preprocess", True):
            raise ValueError(
                "artifact was exported with preprocess=False; the serving "
                "path submits uint8 letterboxed canvases: re-export with "
                "preprocess=True"
            )
        self = cls.__new__(cls)
        self.model = None  # the weights live inside the loaded program's closure
        self.manifest = manifest
        self.batch_size = int(manifest["batch_size"])
        self.max_delay = max_delay_ms / 1e3
        self.size = int(manifest["model"]["image_size"])
        self.eval_config = EvalConfig(**manifest["eval_config"])
        self._buckets = [self.batch_size]
        self._start_device(device, predict)
        self._start_runtime(max_pending, pipeline_depth)
        return self

    def _start_device(self, device: torch.device, call):
        """``call(images)``: the pipeline on one packed uint8 batch."""
        self.device = device
        self._call = call
        # staging + dispatch by the worker, against warmup() on another thread
        self._device_lock = threading.Lock()
        self._graphs: dict = {}
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        self._predict = self._run_batch

    def _start_runtime(self, max_pending, pipeline_depth):
        if max_pending is None:
            max_pending = 32 * self.batch_size
        self._queue: "queue.Queue" = queue.Queue(maxsize=max_pending or 0)
        # dispatched-but-unfetched batches; its bound IS the pipeline depth
        self._inflight_q: "queue.Queue" = queue.Queue(maxsize=max(pipeline_depth, 1))
        self._closed = False
        self._broken: Optional[BaseException] = None
        # batches dequeued but not yet resolved; the crash guards fail their
        # futures (they are in no queue, so the queue drains can't see them)
        self._dispatching: Optional[List] = None
        self._resolving: Optional[List] = None
        self._worker = threading.Thread(target=self._run_guarded, daemon=True)
        self._resolver = threading.Thread(target=self._resolve_guarded, daemon=True)
        self._worker.start()
        self._resolver.start()

    # -- the device call ---------------------------------------------------

    def _stage(self, bucket: int) -> torch.Tensor:
        """The host buffer a batch of ``bucket`` canvases is packed into."""
        return torch.empty((bucket, self.size, self.size, 3), dtype=torch.uint8,
                           pin_memory=self.device.type == "cuda")

    def _graph(self, bucket: int) -> GraphedCall:
        graph = self._graphs.get(bucket)
        if graph is None:
            example = torch.zeros((bucket, self.size, self.size, 3), dtype=torch.uint8,
                                  device=self.device)
            graph = GraphedCall(self._call, example, pool=self._pool)
            self._graphs[bucket] = graph
        return graph

    def _run_batch(self, images: torch.Tensor):
        """Run the pipeline on one packed (b, S, S, 3) uint8 batch from
        :meth:`_stage`; returns (boxes, scores, classes, num_valid), each
        read by ``np.asarray``. On the card this dispatches and returns."""
        if self.device.type != "cuda":
            return self._call(images)
        graph = self._graph(images.shape[0])  # captured at the bucket's first batch
        event = torch.cuda.Event()
        with torch.cuda.stream(self._stream):
            outputs = graph(images)
            host = [torch.empty(o.shape, dtype=o.dtype, pin_memory=True) for o in outputs]
            for dst, src in zip(host, outputs):
                dst.copy_(src, non_blocking=True)
            event.record(self._stream)
        return tuple(_Fetch(event, h) for h in host)

    # -- the public surface ------------------------------------------------

    def predict(self, image: np.ndarray) -> Future:
        """Submit one (H, W, 3) RGB uint8 image; returns a Future.

        The future resolves to ``(boxes (N, 4) xyxy in input coords,
        scores (N,), classes (N,))`` with only valid detections included.
        Raises :class:`PredictorOverloaded` when ``max_pending`` images are
        already queued (caller should shed load / retry with backoff).
        """
        if self._closed:
            raise RuntimeError("predictor closed")
        if self._broken is not None:
            raise RuntimeError(
                "predictor worker crashed; no further requests accepted"
            ) from self._broken
        canvas, scale = letterbox_hostside(image, self.size)
        fut: Future = Future()
        try:
            self._queue.put_nowait((canvas, scale, fut))
        except queue.Full:
            raise PredictorOverloaded(f"{self._queue.maxsize} images already pending") from None
        if self._broken is not None or (self._closed and not self._worker.is_alive()):
            # raced past the closed/broken check while the corresponding
            # drain ran: the worker will never see this item, so fail it
            # instead of hanging the caller
            self._fail_pending(self._broken or RuntimeError("predictor closed"))
        return fut

    def predict_sync(self, image: np.ndarray, timeout: Optional[float] = 30.0):
        """Blocking convenience wrapper around :meth:`predict`."""
        return self.predict(image).result(timeout=timeout)

    def warmup(self) -> None:
        """Run every bucket once, blocking until done: on the card this
        builds the kernels and captures each bucket's graph, which would
        otherwise happen at the bucket's first batch, mid-traffic. Safe on a
        live predictor (it takes the dispatcher's lock)."""
        for b in self._buckets:
            with self._device_lock:
                out = self._predict(self._stage(b).zero_())
            for o in out:
                np.asarray(o)

    def close(self):
        """Stop accepting requests, drain in-flight ones, join the workers.

        Every future submitted before ``close`` resolves (result or error);
        a request racing past the closed check resolves with an error
        rather than hanging.
        """
        self._closed = True
        try:
            # bounded put: if the worker crashed with a full queue, waiting
            # for a consumer that no longer exists would deadlock close()
            self._queue.put(None, timeout=5)
        except queue.Full:
            pass
        self._worker.join(timeout=60)
        self._resolver.join(timeout=60)
        exc = RuntimeError("predictor closed")
        self._fail_pending(exc)
        self._fail_inflight(exc)

    # -- dispatcher / resolver pipeline -----------------------------------
    #
    # Two stages connected by a bounded in-flight queue:
    #   dispatcher: request queue -> micro-batch -> pack -> self._predict
    #               (on the card: replay + copies enqueued, returns at once)
    #   resolver:   in-flight queue -> np.asarray (waits for the batch's
    #               copies to the host) -> resolve futures
    # While the resolver waits on batch N, the dispatcher has already queued
    # batch N+1, so the device never idles between micro-batches.

    def _fail_pending(self, exc: BaseException) -> None:
        """Resolve every still-queued request future with ``exc``."""
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                return
            if item is not None:
                item[2].set_exception(exc)

    def _fail_inflight(self, exc: BaseException) -> None:
        """Resolve every dispatched-but-unfetched future with ``exc``."""
        while True:
            try:
                item = self._inflight_q.get_nowait()
            except queue.Empty:
                return
            if item is not None:
                for _, _, fut in item[0]:
                    if not fut.done():
                        fut.set_exception(exc)

    @staticmethod
    def _fail_batch(batch, exc: BaseException) -> None:
        for _, _, fut in batch or []:
            if not fut.done():
                fut.set_exception(exc)

    def _run_guarded(self):
        """Dispatcher guard: a crash must fail callers, not hang them.

        ``_flush`` routes dispatch-time errors into the batch's futures;
        this guard covers everything else (packing, queue logic).
        """
        try:
            with torch.inference_mode():
                self._run()
        except BaseException as e:  # noqa: BLE001 — must not lose callers
            self._broken = e
            self._fail_batch(self._dispatching, e)
            self._fail_pending(e)
        finally:
            # always hand the resolver its shutdown sentinel, crash or not
            try:
                self._inflight_q.put(None, timeout=5)
            except queue.Full:
                pass  # resolver crashed with a full pipeline; drains handle it

    def _resolve_guarded(self):
        try:
            self._resolve_loop()
        except BaseException as e:  # noqa: BLE001
            self._broken = e
            self._fail_batch(self._resolving, e)
            self._fail_inflight(e)

    def _run(self):
        while True:
            item = self._queue.get()
            if item is None:
                return
            batch: List[Tuple[np.ndarray, float, Future]] = [item]
            self._dispatching = batch  # guard visibility: same list object
            # fill up to batch_size, waiting at most max_delay
            deadline = time.monotonic() + self.max_delay
            while len(batch) < self.batch_size:
                remaining = deadline - time.monotonic()
                try:
                    if remaining <= 0:
                        # deadline passed: stop WAITING, but still drain
                        # requests already in the queue; they cost no extra
                        # latency and un-fragment the herd a resolved
                        # batch's callers make when they resubmit at once
                        nxt = self._queue.get_nowait()
                    else:
                        nxt = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    self._flush(batch)
                    return
                batch.append(nxt)
            self._flush(batch)
            self._dispatching = None

    def _flush(self, batch):
        """Pack and DISPATCH one micro-batch (does not wait for results),
        padded to the smallest bucket that fits."""
        bucket = next(s for s in self._buckets if s >= len(batch))
        with self._device_lock:
            images = self._stage(bucket)
            for i, (canvas, _, _) in enumerate(batch):
                images[i] = torch.from_numpy(canvas)
            images[len(batch):] = 0
            try:
                outputs = self._predict(images)
            except Exception as e:  # dispatch-time error (capture, shapes, OOM)
                self._fail_batch(batch, e)
                return
        # hand to the resolver; blocks only when `pipeline_depth` batches
        # are already in flight (that wait IS the pipeline backpressure).
        # Bounded waits so a dead resolver can't wedge the dispatcher.
        while True:
            if self._broken is not None:
                self._fail_batch(batch, self._broken)
                return
            try:
                self._inflight_q.put((batch, outputs), timeout=0.5)
            except queue.Full:
                continue
            if self._broken is not None:
                # resolver crashed between the check above and our put: its
                # drain may have already run, so nothing would ever consume
                # this batch; drain again (done futures are skipped)
                self._fail_inflight(self._broken)
            return

    def _resolve_loop(self):
        while True:
            item = self._inflight_q.get()
            if item is None:
                return
            batch, outputs = item
            self._resolving = batch
            try:
                # waits until this batch's results are on the host; the
                # dispatcher keeps working meanwhile
                boxes, scores, classes, nvalid = (np.asarray(o) for o in outputs)
            except Exception as e:  # device-side error surfaces at fetch
                self._fail_batch(batch, e)
                self._resolving = None
                continue
            for i, (_, scale, fut) in enumerate(batch):
                if fut.done():  # caller cancelled: their loss, not a crash
                    continue
                n = int(nvalid[i])
                fut.set_result((boxes[i, :n] / scale, scores[i, :n], classes[i, :n]))
            self._resolving = None


def make_http_handler(predictor, max_request_mb: float = 32.0):
    """The stdlib request handler for ``main`` (factored out so the error
    paths, 404/413/501/400/503/504, are testable without a model). The body
    is an encoded image, decoded with PIL; without PIL the answer is 501."""
    import io
    import json
    from http.server import BaseHTTPRequestHandler

    max_request_bytes = int(max_request_mb * 1e6)

    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):
            if self.path != "/predict":
                self.send_error(404)
                return
            length = int(self.headers.get("Content-Length", 0))
            if length > max_request_bytes:
                self.send_error(413, f"request body exceeds {max_request_mb} MB")
                return
            body = self.rfile.read(length)
            try:
                from PIL import Image
            except ImportError:
                # a host without the decoder (some lack PIL; the device
                # line's host_modules says which) answers with a status
                # line, not a dropped connection
                self.send_error(501, "no image decoder on this host")
                return
            try:
                img = np.asarray(Image.open(io.BytesIO(body)).convert("RGB"))
            except Exception:
                # a malformed or truncated body is a 400, not a raw 500
                # traceback from inside PIL
                self.send_error(400, "body is not a decodable image")
                return
            try:
                boxes, scores, classes = predictor.predict_sync(img)
            except PredictorOverloaded:
                self.send_error(503, "overloaded: too many pending requests")
                return
            except TimeoutError:
                # the future's deadline expired (e.g. a graph captured ahead
                # of this request): uncaught, the handler thread dies and the
                # client sees a closed connection with no status line
                self.send_error(504, "predict deadline exceeded")
                return
            out = json.dumps(
                {
                    "detections": [
                        {
                            "box": [round(float(x), 2) for x in b],
                            "score": round(float(s), 4),
                            "class": int(c),
                        }
                        for b, s, c in zip(boxes, scores, classes)
                    ]
                }
            ).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(out)))
            self.end_headers()
            self.wfile.write(out)

        def log_message(self, *a):  # quiet
            pass

    return Handler


def make_http_server(predictor, host: str = "0.0.0.0", port: int = 0,
                     max_request_mb: float = 32.0):
    """ThreadingHTTPServer wired to the predictor, with a listen backlog of
    128: the stdlib's 5 resets connections when tens of clients connect in
    the same instant; beyond the predictor's queue, requests get an orderly
    503 instead of a transport error."""
    from http.server import ThreadingHTTPServer

    class Server(ThreadingHTTPServer):
        daemon_threads = True
        request_queue_size = 128

    return Server((host, port), make_http_handler(predictor, max_request_mb))


def main(argv=None):
    """HTTP serving CLI: POST an image to /predict -> JSON."""
    import argparse

    p = argparse.ArgumentParser(description="Serve an EfficientDet model.")
    p.add_argument("--edz", default=None,
                   help="serve from a one-file .edz export artifact (export.py); "
                   "--phi/--checkpoint/--num-classes/--batch-size/--score-threshold "
                   "then come from the artifact's manifest and may not be given")
    p.add_argument("--phi", type=parse_phi, default=0, choices=PHIS)
    p.add_argument("--checkpoint", default=None, help="a save_params file")
    p.add_argument("--num-classes", type=int, default=90)
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--max-delay-ms", type=float, default=5.0)
    p.add_argument("--score-threshold", type=float, default=0.3)
    p.add_argument("--max-pending", type=int, default=None,
                   help="request queue bound before 503 (default 32x batch)")
    p.add_argument("--pipeline-depth", type=int, default=2,
                   help="dispatched-but-unfetched device batches")
    p.add_argument("--max-request-mb", type=float, default=32.0,
                   help="reject request bodies larger than this with 413")
    p.add_argument("--no-bucket-batches", action="store_true",
                   help="always pad partial micro-batches to the full --batch-size "
                   "(one graph) instead of power-of-two buckets")
    p.add_argument("--skip-warmup", action="store_true",
                   help="skip capturing the bucket graphs before accepting traffic "
                   "(the first batch of each bucket then captures its graph)")
    p.add_argument("--device", default=None, help="default: the GPU; 'cpu' to run on the CPU")
    args = p.parse_args(argv)

    if args.edz:
        # the manifest owns the model: a model flag beside --edz would be
        # dropped without a word, so it is an error (against the defaults)
        ignored = [
            flag
            for flag, value, default in (
                ("--phi", args.phi, 0),
                ("--checkpoint", args.checkpoint, None),
                ("--num-classes", args.num_classes, 90),
                ("--batch-size", args.batch_size, 8),
                ("--score-threshold", args.score_threshold, 0.3),
            )
            if value != default
        ]
        if ignored:
            p.error(f"--edz takes the model from the artifact manifest; "
                    f"conflicting flags: {', '.join(ignored)}")
    device = resolve_device(args.device)
    if device.type == "cuda":
        # the host only letterboxes and packs, one request a thread: one
        # intra-op thread each, not a team per concurrent resize
        torch.set_num_threads(1)
    if args.edz:
        predictor = BatchingPredictor.from_artifact(
            args.edz,
            max_delay_ms=args.max_delay_ms,
            max_pending=args.max_pending,
            pipeline_depth=args.pipeline_depth,
            device=device,
        )
        name = f"{args.edz} (EfficientDet-D{predictor.manifest['model']['phi']})"
    else:
        from .models.detector import build_efficientdet, fuse_for_inference
        from .utils.checkpoint import load_params

        model, _ = build_efficientdet(args.phi, num_classes=args.num_classes,
                                      dtype=torch.bfloat16, device=device)
        if args.checkpoint:
            load_params(args.checkpoint, model)
        predictor = BatchingPredictor(
            fuse_for_inference(model),
            batch_size=args.batch_size,
            max_delay_ms=args.max_delay_ms,
            eval_config=EvalConfig(score_threshold=args.score_threshold),
            max_pending=args.max_pending,
            pipeline_depth=args.pipeline_depth,
            bucket_batches=not args.no_bucket_batches,
        )
        name = f"EfficientDet-D{args.phi}"
    if not args.skip_warmup:
        print(f"warming up {len(predictor._buckets)} batch bucket(s) {predictor._buckets} ...",
              flush=True)
        predictor.warmup()
    server = make_http_server(predictor, port=args.port, max_request_mb=args.max_request_mb)
    print(f"serving {name} on :{args.port}/predict", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
