"""EfficientDet-D4 through the port's entry points against the JAX package, on the CPU.

The weighted BiFPN (224 x 7), the B4 backbone and head depth 4 at 384 px,
90 classes: the Predictor, the .edz artifact and ``from_artifact``, defined
in tests/torch_entry.py with their weights and tolerances; here also the
micro-batching server filling a bucket.
"""

import numpy as np
import torch

import efficientdet_tpu_torch as et
from efficientdet_tpu_torch.data.common import letterbox_hostside
from efficientdet_tpu_torch.serve import BatchingPredictor
from torch_entry import *  # noqa: F401,F403  (the tests and their fixtures)
from torch_entry import ENLARGE, SHRINK, SIZE, entry_for, served, source_image

entry = entry_for(4)


def test_served_detections_equal_predict_pipeline(entry):
    """BatchingPredictor over the BN-folded D4 on the CPU (buckets 1, 2,
    3): three concurrent requests of three source shapes fill one batch of
    3, and their detections, boxes scaled back, equal predict_pipeline's
    on the same three canvases bit for bit; a lone request equals it at
    batch 1 (tests/test_torch_serve.py's end-to-end case at D4)."""
    model = et.fuse_for_inference(entry["port"])
    pred = BatchingPredictor(model, batch_size=3, max_delay_ms=2000.0)
    shapes = []
    run = pred._predict

    def recording(images):
        shapes.append(images.shape[0])
        return run(images)

    pred._predict = recording
    imgs = [source_image(30 + i, hw) for i, hw in enumerate([SHRINK, ENLARGE, (384, 384)])]
    try:
        futs = [pred.predict(im) for im in imgs]
        answers = [f.result(timeout=300) for f in futs]
        lone = pred.predict_sync(imgs[0], timeout=300)
    finally:
        pred.close()
    assert pred._buckets == [1, 2, 3] and shapes == [3, 1]
    canvases = [letterbox_hostside(im, SIZE) for im in imgs]
    dets = et.predict_pipeline(model, torch.from_numpy(np.stack([cv for cv, _ in canvases])))
    for i, (got, (_, scale)) in enumerate(zip(answers, canvases)):
        want = served(dets, i, scale)
        assert len(want[0]) > 0
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    one = et.predict_pipeline(model, torch.from_numpy(canvases[0][0][None]))
    for g, w in zip(lone, served(one, 0, canvases[0][1])):
        np.testing.assert_array_equal(g, w)
