"""The port's micro-batching server and its HTTP endpoint, on the CPU.

The JAX package's fast serving tests, case by case, against a stubbed
device call (``_predict`` replaced before the first request, so the
queueing, bucketing, overload, shutdown and crash contract runs at full
speed without a model), and one end-to-end case: a tiny model on the CPU
whose served detections equal ``predict_pipeline`` on the same canvases.
"""

import dataclasses
import io
import json
import sys
import threading
import time
import types
import zipfile

import numpy as np
import pytest
import torch

import efficientdet_tpu_torch as et
from efficientdet_tpu_torch.data.common import letterbox_hostside
from efficientdet_tpu_torch.serve import (
    BatchingPredictor,
    PredictorOverloaded,
    _bucket_sizes,
    main,
    make_http_server,
)


class _FakeModel(torch.nn.Module):
    """What the server reads of a model: its config's image size and the
    device of its parameters (the CPU)."""

    def __init__(self):
        super().__init__()
        self.config = types.SimpleNamespace(image_size=64)
        self.weight = torch.nn.Parameter(torch.zeros(1))


def _outputs(b, n=1, score=0.9):
    boxes = np.tile(np.asarray([[1.0, 2.0, 30.0, 40.0]], np.float32), (b, 100, 1)).reshape(b, 100, 4)
    scores = np.zeros((b, 100), np.float32)
    scores[:, 0] = score
    return boxes, scores, np.zeros((b, 100), np.int32), np.full((b,), n, np.int32)


def stub_predictor(batch_size=2, max_delay_ms=1.0, max_pending=None, predict=None,
                   bucket_batches=True):
    """A BatchingPredictor whose device call is a host-side stub."""
    pred = BatchingPredictor(_FakeModel(), batch_size=batch_size, max_delay_ms=max_delay_ms,
                             max_pending=max_pending, bucket_batches=bucket_batches)
    pred._predict = predict or (lambda images: _outputs(images.shape[0]))
    return pred


def _shape_recording(**kw):
    shapes = []

    def predict(images):
        shapes.append(images.shape[0])
        return _outputs(images.shape[0])

    return stub_predictor(predict=predict, **kw), shapes


def _img(seed=0, hw=(48, 64)):
    return np.random.RandomState(seed).randint(0, 255, hw + (3,), np.uint8)


# -- batch buckets -----------------------------------------------------------

def test_bucket_sizes():
    assert _bucket_sizes(32) == [1, 2, 4, 8, 16, 32]
    assert _bucket_sizes(8) == [1, 2, 4, 8]
    assert _bucket_sizes(6) == [1, 2, 4, 6]
    assert _bucket_sizes(1) == [1]


@pytest.mark.parametrize("bucket_batches,want", [(True, [1]), (False, [8])])
def test_single_request_dispatches_its_bucket(bucket_batches, want):
    """A lone request pads to bucket 1, or to the full batch with bucketing off."""
    pred, shapes = _shape_recording(batch_size=8, max_delay_ms=0.0, bucket_batches=bucket_batches)
    try:
        pred.predict_sync(_img(), timeout=10)
    finally:
        pred.close()
    assert shapes == want


def test_partial_batch_rounds_up_to_next_bucket():
    pred, shapes = _shape_recording(batch_size=8, max_delay_ms=200.0)
    try:
        futs = [pred.predict(_img()) for _ in range(3)]
        for f in futs:
            f.result(timeout=10)
    finally:
        pred.close()
    assert set(shapes) <= {4}, shapes


def test_queued_items_drained_after_deadline():
    """Requests already queued when the deadline expires join the current
    batch instead of fragmenting into singleton flushes."""
    pred, shapes = _shape_recording(batch_size=8, max_delay_ms=0.0)
    entered, release = threading.Event(), threading.Event()
    orig_flush = pred._flush

    def gated_flush(batch):
        entered.set()
        release.wait(5)
        orig_flush(batch)

    pred._flush = gated_flush
    try:
        first = pred.predict(_img())
        assert entered.wait(5)
        futs = [pred.predict(_img()) for _ in range(4)]
        release.set()
        first.result(timeout=10)
        for f in futs:
            f.result(timeout=10)
    finally:
        pred.close()
    assert shapes == [1, 4], shapes


def test_warmup_runs_every_bucket():
    pred, shapes = _shape_recording(batch_size=8, max_delay_ms=0.0)
    try:
        pred.warmup()
    finally:
        pred.close()
    assert shapes == [1, 2, 4, 8]


# -- the concurrency contract ------------------------------------------------

def test_overload_raises_and_recovers():
    started, release = threading.Event(), threading.Event()

    def blocking_predict(images):
        started.set()
        assert release.wait(timeout=30)
        return _outputs(images.shape[0], n=0)

    pred = stub_predictor(batch_size=1, max_delay_ms=0.0, max_pending=2, predict=blocking_predict)
    try:
        f0 = pred.predict(_img())  # dequeued by the collector,
        assert started.wait(timeout=30)  # now blocking in the device call
        f1 = pred.predict(_img(1))  # fills the bounded queue
        f2 = pred.predict(_img(2))
        with pytest.raises(PredictorOverloaded):
            pred.predict(_img(3))  # backpressure, not growth
        release.set()
        for f in (f0, f1, f2):
            f.result(timeout=30)
        pred.predict(_img(4)).result(timeout=30)  # capacity freed: accepted again
    finally:
        release.set()
        pred.close()


def test_device_exception_propagates_and_worker_survives():
    calls = {"n": 0}

    def flaky_predict(images):
        calls["n"] += 1
        if calls["n"] == 1:
            raise ValueError("injected device error")
        return _outputs(images.shape[0], n=0)

    pred = stub_predictor(batch_size=1, predict=flaky_predict)
    try:
        with pytest.raises(ValueError, match="injected device error"):
            pred.predict(_img()).result(timeout=30)
        boxes, _, _ = pred.predict(_img(1)).result(timeout=30)
        assert boxes.shape[1] == 4
    finally:
        pred.close()


def test_worker_crash_fails_pending_and_rejects_new():
    pred = stub_predictor(batch_size=1)

    def boom(batch):
        raise RuntimeError("host-side packing crash")

    pred._flush = boom  # a crash OUTSIDE the per-batch error handling
    fut = pred.predict(_img())
    with pytest.raises(RuntimeError, match="packing crash"):
        fut.result(timeout=30)
    deadline = time.monotonic() + 30
    while pred._broken is None and time.monotonic() < deadline:
        time.sleep(0.01)
    with pytest.raises(RuntimeError, match="worker crashed"):
        pred.predict(_img(1))
    pred.close()  # must not deadlock
    assert not pred._worker.is_alive() and not pred._resolver.is_alive()


def test_close_with_inflight_resolves_everything():
    def slow_predict(images):
        time.sleep(0.05)
        return _outputs(images.shape[0])

    pred = stub_predictor(batch_size=2, max_delay_ms=1.0, predict=slow_predict)
    futs = [pred.predict(_img(i)) for i in range(8)]
    pred.close()
    for f in futs:
        assert f.done(), "future left hanging after close()"
        if f.exception() is None:
            assert f.result()[0].shape[1] == 4
        else:
            assert "closed" in str(f.exception())


def test_predict_after_close_raises():
    pred = stub_predictor()
    pred.close()
    with pytest.raises(RuntimeError, match="closed"):
        pred.predict(_img())


def test_fetch_error_isolated_to_its_batch():
    """A device error surfacing at fetch time (np.asarray in the resolver,
    where the card's event wait happens) fails that batch only."""

    class BoomArray:
        def __array__(self, *a, **k):
            raise ValueError("fetch boom")

    calls = {"n": 0}

    def predict(images):
        calls["n"] += 1
        good = _outputs(images.shape[0])
        return (BoomArray(),) + good[1:] if calls["n"] == 1 else good

    pred = stub_predictor(batch_size=1, predict=predict)
    try:
        with pytest.raises(ValueError, match="fetch boom"):
            pred.predict(_img()).result(timeout=30)
        boxes, _, _ = pred.predict(_img(1)).result(timeout=30)
        assert boxes.shape == (1, 4)
    finally:
        pred.close()


def test_dispatch_overlaps_fetch():
    """While batch N's fetch blocks the resolver, batch N+1 is dispatched."""
    dispatched = []
    fetch_gate, second_dispatched = threading.Event(), threading.Event()

    class SlowFetch:
        def __init__(self, arr):
            self.arr = arr

        def __array__(self, *a, **k):
            assert fetch_gate.wait(timeout=30)
            return self.arr

    def predict(images):
        dispatched.append(images.shape[0])
        if len(dispatched) == 2:
            second_dispatched.set()
        boxes, *rest = _outputs(images.shape[0])
        return (SlowFetch(boxes), *rest)

    pred = stub_predictor(batch_size=1, max_delay_ms=0.0, predict=predict)
    try:
        f0 = pred.predict(_img(0))
        f1 = pred.predict(_img(1))
        assert second_dispatched.wait(timeout=30), "dispatcher serialised on the resolver's fetch"
        assert not f0.done()
        fetch_gate.set()
        f0.result(timeout=30)
        f1.result(timeout=30)
    finally:
        fetch_gate.set()
        pred.close()


def test_concurrent_submissions_resolve_to_their_own_images():
    """More client threads than cores, a short switch interval: every
    future resolves to the result of its own image, never a neighbour's
    (the stub's score is the canvas's first pixel, its box the scale)."""

    def predict(images):
        b = images.shape[0]
        boxes, scores, classes, n = _outputs(b)
        scores[:, 0] = images[:, 0, 0, 0].float().numpy() / 255.0
        return boxes, scores, classes, n

    pred = stub_predictor(batch_size=8, max_delay_ms=2.0, predict=predict)
    errors = []

    def client(k):
        try:
            for r in range(6):
                v = (7 * k + r) % 250 + 1
                img = np.full((40 + k, 64, 3), v, np.uint8)
                boxes, scores, _ = pred.predict_sync(img, timeout=30)
                _, scale = letterbox_hostside(img, 64)
                assert scores[0] == np.float32(v / 255.0)
                np.testing.assert_allclose(boxes[0], np.float32([1, 2, 30, 40]) / scale)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(k,)) for k in range(24)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        pred.close()
    assert not errors, errors[:3]


# -- end to end on a tiny model ----------------------------------------------

def test_served_detections_equal_predict_pipeline():
    """A tiny model on the CPU: three concurrent requests fill one batch of
    3 (buckets 1, 2, 3), and their detections, boxes scaled back, equal
    predict_pipeline on the same three canvases; a lone request equals it at
    batch 1."""
    cfg = dataclasses.replace(et.ModelConfig.for_phi(0, num_classes=4, image_size=128),
                              bifpn_width=8, bifpn_depth=1, head_depth=1)
    model = et.models.detector.init_weights(et.EfficientDet(cfg), seed=0).eval()
    ec = et.EvalConfig(score_threshold=0.0101)
    pred = BatchingPredictor(model, batch_size=3, max_delay_ms=2000.0, eval_config=ec)
    shapes = []
    run = pred._predict

    def recording(images):
        shapes.append(images.shape[0])
        return run(images)

    pred._predict = recording
    imgs = [_img(i, (90 + 20 * i, 128)) for i in range(3)]
    try:
        futs = [pred.predict(im) for im in imgs]
        served = [f.result(timeout=120) for f in futs]
        lone = pred.predict_sync(imgs[0], timeout=120)
    finally:
        pred.close()
    assert shapes == [3, 1]
    canvases = [letterbox_hostside(im, 128) for im in imgs]
    b, s, c, n = et.predict_pipeline(model, torch.from_numpy(np.stack([cv for cv, _ in canvases])), ec)
    for i, ((boxes, scores, classes), (_, scale)) in enumerate(zip(served, canvases)):
        k = int(n[i])
        assert k > 0
        np.testing.assert_array_equal(boxes, b[i, :k].numpy() / scale)
        np.testing.assert_array_equal(scores, s[i, :k].numpy())
        np.testing.assert_array_equal(classes, c[i, :k].numpy())
    b1, s1, c1, n1 = et.predict_pipeline(model, torch.from_numpy(canvases[0][0][None]), ec)
    k = int(n1[0])
    np.testing.assert_array_equal(lone[0], b1[0, :k].numpy() / canvases[0][1])
    np.testing.assert_array_equal(lone[1], s1[0, :k].numpy())


@pytest.fixture(scope="module")
def tiny_artifact(tmp_path_factory):
    cfg = dataclasses.replace(et.ModelConfig.for_phi(0, num_classes=4, image_size=128),
                              bifpn_width=8, bifpn_depth=1, head_depth=1)
    model = et.models.detector.init_weights(et.EfficientDet(cfg), seed=0).eval()
    ec = et.EvalConfig(score_threshold=0.0101)
    path = str(tmp_path_factory.mktemp("edz") / "tiny.edz")
    et.save_exported(path, model, 2, eval_config=ec)
    return path, model, ec


def test_from_artifact_matches_the_fused_pipeline(tiny_artifact):
    """Serving from a .edz artifact equals predict_pipeline on the fused
    model, on a letterboxed image; the geometry and the eval config come
    from the manifest."""
    path, model, ec = tiny_artifact
    pred = BatchingPredictor.from_artifact(path, max_delay_ms=1.0, device="cpu")
    img = _img(1, (90, 128))
    try:
        assert pred.batch_size == 2 and pred.size == 128 and pred._buckets == [2]
        assert pred.manifest["model"]["phi"] == 0 and pred.model is None
        assert pred.eval_config == ec
        boxes, scores, classes = pred.predict_sync(img, timeout=120)
    finally:
        pred.close()
    canvas, scale = letterbox_hostside(img, 128)
    batch = torch.from_numpy(np.stack([canvas, np.zeros_like(canvas)]))
    b, s, c, n = et.predict_pipeline(et.fuse_for_inference(model), batch, ec)
    k = int(n[0])
    assert k > 0
    np.testing.assert_array_equal(boxes, b[0, :k].numpy() / scale)
    np.testing.assert_array_equal(scores, s[0, :k].numpy())
    np.testing.assert_array_equal(classes, c[0, :k].numpy())


def test_from_artifact_refuses_an_artifact_without_preprocess(tiny_artifact, tmp_path):
    raw = str(tmp_path / "raw.edz")
    with zipfile.ZipFile(tiny_artifact[0]) as zin, zipfile.ZipFile(raw, "w") as zout:
        for name in zin.namelist():
            data = zin.read(name)
            if name == "manifest.json":
                data = json.dumps({**json.loads(data), "preprocess": False})
            zout.writestr(name, data)
    with pytest.raises(ValueError, match="preprocess=False"):
        BatchingPredictor.from_artifact(raw, device="cpu")


@pytest.mark.parametrize("flag,value", [("--phi", "3"), ("--checkpoint", "ck.pt"),
                                        ("--num-classes", "20"), ("--batch-size", "4"),
                                        ("--score-threshold", "0.5")])
def test_edz_conflicts_with_each_model_flag(flag, value, capsys):
    with pytest.raises(SystemExit) as e:
        main(["--edz", "unused.edz", flag, value])
    assert e.value.code == 2  # an argparse error, not a crash
    err = capsys.readouterr().err
    assert flag in err and "artifact manifest" in err


def test_server_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--port", "0"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--port", "0", "--edz", "unused.edz"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchingPredictor.from_artifact("unused.edz")


# -- the HTTP surface --------------------------------------------------------

def _serve(predictor, max_request_mb=1.0):
    server = make_http_server(predictor, host="127.0.0.1", max_request_mb=max_request_mb)
    # burst hardening: the stdlib default backlog of 5 resets connections
    assert type(server).request_queue_size == 128
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def _post(server, body, path="/predict"):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=30)
    conn.request("POST", path, body=body)
    resp = conn.getresponse()
    out = (resp.status, resp.read())
    conn.close()
    return out


def _png(hw=(64, 64)):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.zeros(hw + (3,), np.uint8)).save(buf, format="PNG")
    return buf.getvalue()


@pytest.mark.parametrize("body,path,max_mb,status", [
    (b"x" * 10_000, "/predict", 0.001, 413),  # over the 1 kB bound
    (b"definitely not a JPEG", "/predict", 1.0, 400),
    (b"", "/nope", 1.0, 404),
], ids=["oversized-413", "undecodable-400", "wrong-path-404"])
def test_http_error_statuses(body, path, max_mb, status):
    pred = stub_predictor()
    server = _serve(pred, max_request_mb=max_mb)
    try:
        assert _post(server, body, path)[0] == status
    finally:
        server.shutdown()
        pred.close()


@pytest.mark.parametrize("error,status", [(TimeoutError("deadline"), 504),
                                          (PredictorOverloaded("full"), 503)],
                         ids=["deadline-504", "overloaded-503"])
def test_http_predict_errors_answer_a_status(error, status):
    """A deadline or an overload out of predict_sync answers a status line,
    not a connection closed by a dead handler thread."""
    pred = stub_predictor()

    def fail(img, timeout=30.0):
        raise error

    pred.predict_sync = fail
    server = _serve(pred)
    try:
        assert _post(server, _png())[0] == status
    finally:
        server.shutdown()
        pred.close()


@pytest.mark.parametrize("body", [_png, lambda: b"definitely not a JPEG"], ids=["png", "garbage"])
def test_http_without_an_image_decoder_answers_501(body, monkeypatch):
    """On a host without PIL (the card's) a POST gets a 501 status line, not
    a dropped connection; with PIL, a garbage body still gets 400."""
    payload = body()
    pred = stub_predictor()
    server = _serve(pred)
    try:
        assert _post(server, payload)[0] == (200 if payload.startswith(b"\x89PNG") else 400)
        monkeypatch.setitem(sys.modules, "PIL", None)  # import PIL raises ImportError
        status, text = _post(server, payload)
        assert status == 501 and b"no image decoder" in text
    finally:
        server.shutdown()
        pred.close()


def test_valid_png_roundtrips_detections():
    pred = stub_predictor()  # fixed detections: one box a request
    server = _serve(pred)
    try:
        status, body = _post(server, _png((32, 128)))  # letterboxed at scale 0.5
        assert status == 200
        dets = json.loads(body)["detections"]
        assert len(dets) == 1 and set(dets[0]) == {"box", "score", "class"}
        assert dets[0]["score"] == 0.9 and dets[0]["class"] == 0
        assert dets[0]["box"] == [2.0, 4.0, 60.0, 80.0]  # the canvas box, in source pixels
    finally:
        server.shutdown()
        pred.close()
