"""The pytest side of tests/test_torch_parallel.py and tests/test_torch_spatial.py.

Models, weights and batches made with numpy from seeds, the JAX models they
are bridged from, and the tolerances the multi-rank results are held to.
The ranks themselves run tests/torch_parallel_ranks.py (no JAX there).

Weights: every leaf of the JAX variables tree is drawn with numpy (shapes
from ``jax.eval_shape``, no init compile): fan-in normal kernels, BN scales
and variances in [0.5, 1.5], biases and means normal(0, 0.2), the class
head's final bias near the prior, and bridged into the port by
``utils/convert.py`` (tests/test_torch_train.py's recipe: two independent
inits cannot be compared, and the JAX initialiser makes every class logit
equal the prior).

The step tolerances are PR 6's (tests/test_torch_train.py), stated once in
the port's parallel/tolerances.py, which chip_smoke.py holds the card's
steps to as well: loss and its parts 1e-5 relative; the gradient, read from
Adam's first moment after one step (mu = (1 - b1) g), within 1e-4 of each
leaf's largest |g| plus 1e-6 of the model's largest; BN statistics 1e-5;
new parameters 1e-5 where |g| is above 1e-3 of its leaf's largest and that
noise, else within 2 lr.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from efficientdet_tpu.configs import ModelConfig as JModelConfig
import efficientdet_tpu_torch as et
from efficientdet_tpu_torch.parallel import tolerances as T
from efficientdet_tpu_torch.parallel.tolerances import LOSS_REL
from efficientdet_tpu_torch.utils.convert import from_flax_variables, load_flax_variables

LR = 1e-3


def jax_config(size, num_classes, backbone="efficientnet-b0", width=16, depth=2, head=2,
               survival_prob=0.8):
    return dataclasses.replace(
        JModelConfig.for_phi(0, num_classes=num_classes, image_size=size), backbone=backbone,
        bifpn_width=width, bifpn_depth=depth, head_depth=head, survival_prob=survival_prob)


def spec_of(cfg):
    """The rank programs' model spec of a JAX ModelConfig."""
    return {"phi": cfg.phi, "num_classes": cfg.num_classes, "image_size": cfg.image_size,
            "overrides": {"backbone": cfg.backbone, "bifpn_width": cfg.bifpn_width,
                          "bifpn_depth": cfg.bifpn_depth, "head_depth": cfg.head_depth,
                          "survival_prob": cfg.survival_prob}}


def draw_variables(model, size, seed):
    """Every leaf of ``model``'s flax variables drawn with numpy."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)))

    def draw(path, leaf):
        keys = [getattr(p, "key", "") for p in path]
        name, shape = keys[-1], leaf.shape
        if name == "kernel":
            return rng.normal(0, (1.5 / int(np.prod(shape[:-1]))) ** 0.5, shape).astype(np.float32)
        if name in ("var", "scale"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if name == "fusion_weights":
            return rng.uniform(0.2, 1.5, shape).astype(np.float32)
        if name == "bias" and "class_net" in keys and "final" in keys:
            return rng.normal(-4.6, 0.3, shape).astype(np.float32)
        return rng.normal(0, 0.2, shape).astype(np.float32)

    return jax.tree.map(np.asarray, jax.tree_util.tree_map_with_path(draw, shapes))


def port_state(spec, variables):
    """The port's state dict of ``variables`` for a model of ``spec``."""
    cfg = et.ModelConfig.for_phi(spec["phi"], num_classes=spec["num_classes"],
                                 image_size=spec["image_size"])
    model = et.EfficientDet(dataclasses.replace(cfg, **spec["overrides"]))
    return {k: v.clone() for k, v in load_flax_variables(model, variables).state_dict().items()}


def as_port(tree, coll="params"):
    """A flax tree -> numpy arrays by the port's state-dict names."""
    return {k: v.numpy() for k, v in from_flax_variables({coll: jax.tree.map(np.asarray, tree)}).items()}


def synth_batch(seed, batch, size, num_classes, max_gt=8, uint8=False):
    """tests/test_train.py's batch: uniform(-1, 1) images (normalised) with
    one box each, painted in; ``uint8``: the same as [0, 255] canvases with
    their extents, for the device augmenter."""
    rng = np.random.RandomState(seed)
    images = rng.uniform(-1, 1, (batch, size, size, 3)).astype(np.float32)
    gt_boxes = np.zeros((batch, max_gt, 4), np.float32)
    gt_labels = np.full((batch, max_gt), -1, np.int32)
    for i in range(batch):
        x1, y1 = rng.randint(0, size // 2, 2)
        w, h = rng.randint(size // 4, size // 2, 2)
        gt_boxes[i, 0] = [x1, y1, min(x1 + w, size - 1), min(y1 + h, size - 1)]
        gt_labels[i, 0] = rng.randint(0, num_classes)
        images[i, y1:y1 + h, x1:x1 + w, :] += 1.0
    out = {"images": images, "gt_boxes": gt_boxes, "gt_labels": gt_labels}
    if uint8:
        out["images"] = np.clip((images + 1.0) * 100.0, 0, 255).astype(np.uint8)
        out["extents"] = np.tile(np.float32([size, size - size // 8]), (batch, 1))
    return out


def torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def compare_step(got, want_metrics, want_mu, want_stats, want_params, loss_rel=LOSS_REL,
                 scale=1.0):
    """A step's result (tests/torch_parallel_ranks.run_steps) against a
    reference's metrics and, by the port's names, its gradients as Adam's
    first moments, BN statistics and new parameters, held to
    parallel/tolerances.py's rules (``scale``: FLOAT64_SCALE for float64
    steps). Returns the share of elements held within 2 lr."""
    def tensors(d):
        return {k: torch.as_tensor(np.asarray(v)) for k, v in d.items()}

    errors = T.step_errors(
        (got["metrics"][0], got["mu"], got["buffers"], got["params"]),
        (want_metrics, tensors(want_mu), tensors(want_stats), tensors(want_params)),
        lr=LR, loss_rel=loss_rel, scale=scale)
    assert T.step_holds(errors), errors
    return errors["small_share"]


def compare_to_port_step(got, want, scale=1.0):
    """A parallel step against the port's one-process step (both
    run_steps results)."""
    return compare_step(got, want["metrics"][0],
                        {k: v.numpy() for k, v in want["mu"].items()},
                        {k: v.numpy() for k, v in want["buffers"].items()
                         if not k.endswith("num_batches_tracked")},
                        {k: v.numpy() for k, v in want["params"].items()}, scale=scale)


def assert_detections(got, want, box_tol=0.0, score_tol=0.0):
    """Counts and classes exact, boxes and scores within the tolerances
    (0: equal bit for bit)."""
    names = ("boxes", "scores", "classes", "num_valid")
    for name, a, b in zip(names, got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, (name, a.shape, b.shape)
        tol = {"boxes": box_tol, "scores": score_tol}.get(name, 0.0)
        if tol == 0.0:
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a.astype(np.float32), b.astype(np.float32), rtol=0,
                                       atol=tol, err_msg=name)
