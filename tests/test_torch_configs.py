"""The port's configs equal the JAX package's, field by field."""

import dataclasses

import pytest

import efficientdet_tpu.configs as jc
import efficientdet_tpu_torch.configs as tc


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


@pytest.mark.parametrize("phi", range(8))
def test_model_config_for_phi(phi):
    t = tc.ModelConfig.for_phi(phi)
    j = jc.ModelConfig.for_phi(phi)
    tf = _fields(t)
    anchor = tf.pop("anchor")
    jf = _fields(j)
    assert _fields(anchor) == _fields(jf.pop("anchor"))
    # every field, the remat switches included
    assert tf == jf
    assert t.num_levels == j.num_levels
    assert t.num_anchors_per_cell == j.num_anchors_per_cell
    assert t.feature_shapes() == j.feature_shapes()
    assert t.total_anchors() == j.total_anchors()
    assert anchor.sizes == j.anchor.sizes


def test_model_config_overrides_and_errors():
    kw = dict(num_classes=6, weighted_bifpn=False, freeze_bn=True, image_size=256)
    assert _fields(tc.ModelConfig.for_phi(3, **kw))["image_size"] == 256
    t, j = tc.ModelConfig.for_phi(3, **kw), jc.ModelConfig.for_phi(3, **kw)
    assert {k: v for k, v in _fields(t).items() if k != "anchor"} == {
        k: v for k, v in _fields(j).items() if k in _fields(t) and k != "anchor"
    }
    for bad in (dict(phi=8), dict(phi=0, image_size=500)):
        with pytest.raises(ValueError):
            tc.ModelConfig.for_phi(**bad)


def test_block_tables_and_rounding():
    assert set(tc.BACKBONE_BLOCK_TABLES) == set(jc.BACKBONE_BLOCK_TABLES)
    for name, table in jc.BACKBONE_BLOCK_TABLES.items():
        assert [_fields(b) for b in tc.BACKBONE_BLOCK_TABLES[name]] == [
            _fields(b) for b in table
        ]
    assert tc.EFFICIENTNET_PARAMS == jc.EFFICIENTNET_PARAMS
    for f in (8, 16, 24, 32, 40, 80, 112, 192, 320, 1280):
        for w, d, _ in jc.EFFICIENTNET_PARAMS.values():
            assert tc.round_filters(f, w) == jc.round_filters(f, w)
    for r in range(1, 5):
        for w, d, _ in jc.EFFICIENTNET_PARAMS.values():
            assert tc.round_repeats(r, d) == jc.round_repeats(r, d)


@pytest.mark.parametrize("num_classes", [6, 90])
def test_eval_config(num_classes):
    assert _fields(tc.EvalConfig()) == _fields(jc.EvalConfig())
    assert _fields(tc.EvalConfig.exact(num_classes, max_detections=50)) == _fields(
        jc.EvalConfig.exact(num_classes, max_detections=50)
    )
