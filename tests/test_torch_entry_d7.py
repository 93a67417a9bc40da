"""EfficientDet-D7 through the port's entry points against the JAX package, on the CPU.

The unweighted BiFPN (384 x 8), the B6 backbone, head depth 5 and anchor
scale 5 at 384 px, 90 classes: the Predictor, the .edz artifact (its
manifest's ``weighted_bifpn`` false) and ``from_artifact``, defined in
tests/torch_entry.py with their weights and tolerances; here also sharded
predict against the JAX package's ``make_sharded_predict_fn``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from efficientdet_tpu.configs import EvalConfig as JEvalConfig
from efficientdet_tpu.parallel import make_mesh as j_make_mesh
from efficientdet_tpu.parallel import make_sharded_predict_fn as j_sharded_predict
import efficientdet_tpu_torch as et
from efficientdet_tpu_torch.parallel import make_mesh, make_sharded_predict_fn
from efficientdet_tpu_torch.parallel.launch import free_port
from torch_entry import *  # noqa: F401,F403  (the tests and their fixtures)
from torch_entry import assert_equal_detections, check_detections, entry_for, export_images

entry = entry_for(7)


def test_sharded_predict_matches_jax(entry):
    """make_sharded_predict_fn on a gloo process group of one rank (the
    sharded path: its rows, then the gather) against the JAX package's on
    a one-device CPU mesh, the same variables and a batch of 2: counts
    exact, then each image by check_detections (classes exact, boxes 1e-3
    px, scores 1e-5, near-ties in either order); and equal bit for bit to
    the one-process make_predict_fn."""
    images = export_images(7)
    jpred = j_sharded_predict(entry["jmodel"], j_make_mesh(jax.devices()[:1]), JEvalConfig())
    want = [np.asarray(t) for t in jpred(entry["variables"], jnp.asarray(images))]
    x = torch.from_numpy(images)
    mesh = make_mesh(device="cpu", init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1,
                     rank=0, timeout_s=60)
    try:
        assert mesh.group is not None
        got = make_sharded_predict_fn(entry["port"], mesh)(x)
    finally:
        mesh.close()
    assert_equal_detections(got, et.make_predict_fn(entry["port"])(x))
    got = [t.numpy() for t in got]
    np.testing.assert_array_equal(got[3], want[3])
    for i, n in enumerate(want[3]):
        check_detections([t[i, :n] for t in got[:3]], [t[i, :n] for t in want[:3]])
