"""The port's TF/automl-style weight maps (utils/convert.py) against the JAX package's.

No checkpoint file is read: the trees are synthetic, drawn with numpy over
the JAX model's shapes (``jax.eval_shape``, no init compile), as the JAX
package's own tests do. Both packages export the same bridged weights to
TF-style names; the dicts must agree name for name and array for array.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficientdet_tpu.configs import ModelConfig as JModelConfig
from efficientdet_tpu.models.detector import EfficientDet as JEfficientDet
from efficientdet_tpu.utils import convert as jconvert
import efficientdet_tpu_torch as et
from efficientdet_tpu_torch.utils import convert
from efficientdet_tpu_torch.utils.convert import from_flax_variables


def _jax_config(slim: bool):
    cfg = JModelConfig.for_phi(0, num_classes=6, image_size=128)
    if slim:
        cfg = dataclasses.replace(cfg, bifpn_width=16, bifpn_depth=2, head_depth=2)
    return cfg


def _port_config(cfg):
    fields = {f.name for f in dataclasses.fields(et.ModelConfig)} - {"anchor"}
    return et.ModelConfig(**{k: getattr(cfg, k) for k in fields})


def _draw(cfg, seed):
    """Every leaf of the JAX detector's variables, drawn with numpy."""
    model = JEfficientDet(config=cfg)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 3)))
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda s: rng.normal(0, 1, s.shape).astype(np.float32), shapes)


@pytest.fixture(scope="module", params=["slim_d0", "full_d0"])
def trees(request):
    cfg = _jax_config(request.param == "slim_d0")
    variables = _draw(cfg, 0)
    state = from_flax_variables(variables)
    return cfg, _port_config(cfg), variables, state


def test_detector_export_equals_the_jax_export(trees):
    jcfg, cfg, variables, state = trees
    want = jconvert.export_detector_tf_style(variables, jcfg)
    got = convert.export_detector_tf_style(state, cfg)
    assert sorted(got) == sorted(want)
    for name, arr in want.items():
        assert got[name].shape == np.shape(arr), name
        np.testing.assert_array_equal(got[name], np.asarray(arr), err_msg=name)


def test_detector_round_trip_is_lossless(trees):
    _, cfg, _, state = trees
    model = et.EfficientDet(cfg)
    assert sorted(model.state_dict()) == sorted(state)
    tf_vars = convert.export_detector_tf_style(state, cfg)
    perturbed = {k: np.asarray(v) + 1.0 for k, v in tf_vars.items()}
    convert.import_detector(model, perturbed, cfg)
    back = convert.export_detector_tf_style(model, cfg)
    assert sorted(back) == sorted(tf_vars)
    for name, arr in perturbed.items():
        np.testing.assert_array_equal(back[name], arr.astype(np.float32), err_msg=name)
    # and onto a state dict: the same tensors as the model received
    again = convert.import_detector(state, perturbed, cfg)
    for key, v in model.state_dict().items():
        assert torch.equal(again[key], v), key


def test_the_map_lands_on_every_tensor_once(trees):
    _, cfg, _, state = trees
    keys = [convert.torch_key(p) for p in convert.detector_name_map(cfg)]
    assert len(keys) == len(set(keys)) == len(state)
    convert.assert_full_coverage(state, convert.detector_name_map(cfg))


def test_import_rejects_a_bad_shape(trees):
    _, cfg, _, state = trees
    tf_vars = convert.export_detector_tf_style(state, cfg)
    tf_vars["efficientnet-b0/stem/conv2d/kernel"] = np.zeros((1, 1, 1, 1), np.float32)
    with pytest.raises(ValueError, match="shape mismatch"):
        convert.import_detector(state, tf_vars, cfg)


def test_import_rejects_a_coverage_gap(trees):
    _, cfg, _, state = trees
    name_map = convert.detector_name_map(cfg)
    gap = dict(name_map)
    gap.pop("params/class_net/net/final/pointwise/bias")
    with pytest.raises(KeyError, match="unmapped"):
        convert.assert_full_coverage(state, gap)
    tf_vars = convert.export_detector_tf_style(state, cfg)
    del tf_vars["box_net/box-predict/bias"]
    with pytest.raises(KeyError, match="unmatched"):
        convert.import_detector(state, tf_vars, cfg)
    # not strict: the gap keeps the target's own tensor
    out = convert.import_detector(state, tf_vars, cfg, strict=False)
    assert torch.equal(out["box_net.net.final.pointwise.bias"], state["box_net.net.final.pointwise.bias"])


@pytest.mark.parametrize("model_name", ["efficientnet-b0", "efficientnet-b1"])
def test_backbone_name_map_equals_the_jax_map(model_name):
    assert convert.backbone_name_map(model_name) == jconvert.backbone_name_map(model_name)


def test_bifpn_and_head_maps_equal_the_jax_maps():
    for depth, weighted in ((2, True), (3, False)):
        assert convert.bifpn_name_map(depth, weighted) == jconvert.bifpn_name_map(depth, weighted)
    for head in ("class", "box"):
        assert convert.head_name_map(head, 3) == jconvert.head_name_map(head, 3)


def test_backbone_round_trip_and_layouts(trees):
    _, cfg, variables, state = trees
    tf_style = convert.export_tf_style(state)
    want = jconvert.export_tf_style(variables)
    assert sorted(tf_style) == sorted(want)
    dw = tf_style["efficientnet-b0/blocks_0/depthwise_conv2d/depthwise_kernel"]
    assert dw.shape[-1] == 1  # TF depthwise layout (H, W, C, 1)
    for name in want:
        np.testing.assert_array_equal(tf_style[name], np.asarray(want[name]), err_msg=name)
    perturbed = {k: v + 1.0 for k, v in tf_style.items()}
    restored = convert.import_backbone(state, perturbed)
    back = convert.export_tf_style(restored)
    for name in tf_style:
        np.testing.assert_array_equal(back[name], tf_style[name] + 1.0)


@pytest.fixture(scope="module", params=range(8))
def phi_trees(request):
    """EfficientDet-D``phi`` (90 classes): the JAX variables drawn with numpy
    over ``jax.eval_shape``'s shapes (no init, no forward), the port's
    bridged state dict and its model on the meta device (keys and shapes
    only)."""
    jcfg = JModelConfig.for_phi(request.param)
    shapes = jax.eval_shape(JEfficientDet(config=jcfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 128, 128, 3)))
    rng = np.random.default_rng(request.param)
    variables = jax.tree.map(lambda s: rng.standard_normal(s.shape, dtype=np.float32), shapes)
    cfg = et.ModelConfig.for_phi(request.param)
    with torch.device("meta"):
        model = et.EfficientDet(cfg)
    return jcfg, cfg, variables, from_flax_variables(variables), model


def test_name_map_covers_the_state_dict_at_every_phi(phi_trees):
    jcfg, cfg, _, state, model = phi_trees
    name_map = convert.detector_name_map(cfg)
    assert name_map == jconvert.detector_name_map(jcfg)
    own = model.state_dict()
    keys = [convert.torch_key(p) for p in name_map]
    assert len(keys) == len(set(keys)) == len(own)
    assert set(keys) == set(own) == set(state)
    for key, v in own.items():
        assert state[key].shape == v.shape, key
    convert.assert_full_coverage(state, name_map)


def test_tf_style_export_and_import_at_every_phi(phi_trees):
    jcfg, cfg, variables, state, _ = phi_trees
    want = jconvert.export_detector_tf_style(variables, jcfg)
    got = convert.export_detector_tf_style(state, cfg)
    assert sorted(got) == sorted(want)
    for name, arr in want.items():
        np.testing.assert_array_equal(got[name], np.asarray(arr), err_msg=name)
    perturbed = {k: np.asarray(v) + 1.0 for k, v in got.items()}
    back = convert.export_detector_tf_style(convert.import_detector(state, perturbed, cfg), cfg)
    assert sorted(back) == sorted(perturbed)
    for name, arr in perturbed.items():
        np.testing.assert_array_equal(back[name], arr, err_msg=name)
