"""Weight bridges: flax variables trees and TF/automl-style checkpoints -> the port.

**flax -> torch.** The port's modules carry the flax module names, so a flax
path maps onto a torch key by joining with ``.`` and renaming the leaf:

  params/.../kernel          -> ....weight   4-D: HWIO -> OIHW (a depthwise
                                              (kh, kw, 1, C) becomes (C, 1, kh, kw))
  params/.../scale           -> ....weight   (BatchNorm)
  params/.../bias            -> ....bias
  params/.../fusion_weights  -> ....fusion_weights
  batch_stats/.../mean       -> ....running_mean
  batch_stats/.../var        -> ....running_var

It takes the unfused tree and the output of the JAX package's
``fold_bn_variables`` alike. An unknown leaf name raises here; keys the
model lacks or leaves it without raise in :func:`load_flax_variables`.

:func:`adam_state_from_optax` bridges a training state's optimizer: optax's
Adam moments (``mu``, ``nu``: trees shaped like ``params``) and its count
become the port's ``train_lib.Optimizer`` state, so a step can start from a
JAX step's state.

**TF/automl-style names -> torch** (counterpart of the JAX package's
``utils/convert.py``), for the official automl EfficientDet and bare
EfficientNet checkpoints once such files are available. The name maps are
written over the JAX package's flax paths (``params/backbone/stem_conv/kernel``
-> ``efficientnet-b0/stem/conv2d/kernel``), from the port's own ``configs``,
so they equal the JAX package's key for key; a flax path becomes a torch key
by the rule above. On the way in:

* a TF conv kernel (H, W, I, O) becomes OIHW, a TF depthwise kernel
  (H, W, C, 1) becomes (C, 1, H, W);
* BN ``gamma``, ``beta``, ``moving_mean``, ``moving_variance`` become
  ``weight``, ``bias``, ``running_mean``, ``running_var``;
* the BiFPN's per-input fast-fusion scalars (``WSM``, ``WSM_1``, ...) stack
  into the node's ``fusion_weights``.

A shape mismatch raises; so does a variable missing on either side, and,
under ``strict``, a tree the map does not cover in full
(:func:`assert_full_coverage`). :func:`export_tf_style` and
:func:`export_detector_tf_style` are the inverses (round-trip aid).
The name scheme was written from the public automl code and is guarded by
these shape checks; re-verify it against a real checkpoint when one is
available.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple, Union

import numpy as np
import torch

from ..configs import EFFICIENTNET_B0_BLOCKS, EFFICIENTNET_PARAMS, round_repeats
from ..models.bifpn import node_plan
from .fold_bn import _flatten

_PARAM_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias",
                 "fusion_weights": "fusion_weights"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


def _key(coll: str, path: Tuple[str, ...]) -> str:
    names = _PARAM_LEAVES if coll == "params" else _STAT_LEAVES
    return ".".join(path[:-1] + (names[path[-1]],))


def from_flax_variables(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """{'params': ..., ['batch_stats': ...]} of numpy arrays -> state dict."""
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise ValueError(f"unknown variable collections: {sorted(unknown)}")
    out: Dict[str, torch.Tensor] = {}
    for coll, names in (("params", _PARAM_LEAVES), ("batch_stats", _STAT_LEAVES)):
        for path, value in _flatten(dict(variables.get(coll, {}))).items():
            leaf = path[-1]
            if leaf not in names:
                raise ValueError(f"unknown {coll} leaf {'/'.join(path)!r}")
            arr = np.array(value, dtype=np.float32)  # a writable copy
            if leaf == "kernel" and arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            key = _key(coll, path)
            if key in out:
                raise ValueError(f"two flax leaves map onto {key!r}")
            out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def load_flax_variables(model: torch.nn.Module, variables: Dict[str, Any]) -> torch.nn.Module:
    """Load a flax tree into ``model``; missing, left-over or misshapen keys raise."""
    sd = from_flax_variables(variables)
    own = model.state_dict()
    missing = sorted(set(own) - set(sd))
    extra = sorted(set(sd) - set(own))
    bad = sorted(k for k in set(sd) & set(own) if sd[k].shape != own[k].shape)
    if missing or extra or bad:
        raise ValueError(
            f"flax variables do not fit the model: missing {missing[:5]}, "
            f"left over {extra[:5]}, shape mismatch {bad[:5]}"
        )
    model.load_state_dict(sd)
    return model


def adam_state_from_optax(mu: Dict[str, Any], nu: Dict[str, Any], count: int,
                          device=None) -> Dict[str, Any]:
    """optax ``ScaleByAdamState`` leaves (numpy trees shaped like ``params``,
    and the count) -> the port's optimizer state, on ``device`` (None = the
    GPU, raising without one, as the training entry points resolve it). The
    moments take the parameters' layout, as the kernels do."""
    from ..models.detector import resolve_device

    device = resolve_device(device)

    def moments(tree):
        return {k: v.to(device) for k, v in from_flax_variables({"params": tree}).items()}

    return {"count": int(count), "mu": moments(mu), "nu": moments(nu)}


# -- TF/automl-style names ---------------------------------------------------

def backbone_name_map(model_name: str = "efficientnet-b0") -> Dict[str, str]:
    """{flax path: official TF name} for the backbone's params AND batch stats.

    Paths are '/'-joined with a leading ``params/`` or ``batch_stats/``
    collection, without the detector's ``backbone/`` prefix. Official names
    follow automl's ``efficientnet-bN/blocks_K/...`` scheme with TPU batch
    norm counters.
    """
    _, depth_coeff, _ = EFFICIENTNET_PARAMS[model_name]
    m: Dict[str, str] = {}

    def bn(ours: str, tf: str):
        m[f"params/{ours}/scale"] = f"{tf}/gamma"
        m[f"params/{ours}/bias"] = f"{tf}/beta"
        m[f"batch_stats/{ours}/mean"] = f"{tf}/moving_mean"
        m[f"batch_stats/{ours}/var"] = f"{tf}/moving_variance"

    root = model_name
    m["params/stem_conv/kernel"] = f"{root}/stem/conv2d/kernel"
    bn("stem_bn", f"{root}/stem/tpu_batch_normalization")
    gi = 0  # automl's global blocks_%d counter
    for stage_idx, cfg in enumerate(EFFICIENTNET_B0_BLOCKS):
        for r in range(round_repeats(cfg.num_repeat, depth_coeff)):
            ours = f"stage{stage_idx + 1}_block{r}"
            tf = f"{root}/blocks_{gi}"
            n_bn = 0
            project_conv = "conv2d"
            if cfg.expand_ratio != 1:
                m[f"params/{ours}/expand_conv/kernel"] = f"{tf}/conv2d/kernel"
                bn(f"{ours}/expand_bn", f"{tf}/tpu_batch_normalization")
                n_bn = 1
                project_conv = "conv2d_1"
            m[f"params/{ours}/depthwise_conv/kernel"] = f"{tf}/depthwise_conv2d/depthwise_kernel"
            bn(f"{ours}/depthwise_bn",
               f"{tf}/tpu_batch_normalization" + (f"_{n_bn}" if n_bn else ""))
            n_bn += 1
            m[f"params/{ours}/se/reduce/kernel"] = f"{tf}/se/conv2d/kernel"
            m[f"params/{ours}/se/reduce/bias"] = f"{tf}/se/conv2d/bias"
            m[f"params/{ours}/se/expand/kernel"] = f"{tf}/se/conv2d_1/kernel"
            m[f"params/{ours}/se/expand/bias"] = f"{tf}/se/conv2d_1/bias"
            m[f"params/{ours}/project_conv/kernel"] = f"{tf}/{project_conv}/kernel"
            bn(f"{ours}/project_bn", f"{tf}/tpu_batch_normalization_{n_bn}")
            gi += 1
    return m


def head_name_map(head: str, depth: int, num_levels: int = 5,
                  min_level: int = 3) -> Dict[str, str]:
    """{flax path: official TF name} for the ClassNet (``"class"``) or BoxNet
    (``"box"``): ``{head}_net/{head}-{i}/{depthwise_kernel, pointwise_kernel,
    bias}``, the per-level BNs ``{head}_net/{head}-{i}-bn-{level}/...`` and
    the final conv ``{head}_net/{head}-predict/...``."""
    net = f"{head}_net"
    root = f"{head}_net/net"
    m: Dict[str, str] = {}
    for i in range(depth):
        m[f"params/{root}/conv{i}/depthwise/kernel"] = f"{net}/{head}-{i}/depthwise_kernel"
        m[f"params/{root}/conv{i}/pointwise/kernel"] = f"{net}/{head}-{i}/pointwise_kernel"
        m[f"params/{root}/conv{i}/pointwise/bias"] = f"{net}/{head}-{i}/bias"
        for lvl in range(num_levels):
            ours = f"{root}/bn_l{lvl}_d{i}"
            tf = f"{net}/{head}-{i}-bn-{min_level + lvl}"
            m[f"params/{ours}/scale"] = f"{tf}/gamma"
            m[f"params/{ours}/bias"] = f"{tf}/beta"
            m[f"batch_stats/{ours}/mean"] = f"{tf}/moving_mean"
            m[f"batch_stats/{ours}/var"] = f"{tf}/moving_variance"
    m[f"params/{root}/final/depthwise/kernel"] = f"{net}/{head}-predict/depthwise_kernel"
    m[f"params/{root}/final/pointwise/kernel"] = f"{net}/{head}-predict/pointwise_kernel"
    m[f"params/{root}/final/pointwise/bias"] = f"{net}/{head}-predict/bias"
    return m


def bifpn_name_map(depth: int, weighted: bool = True, bifpn_key: str = "bifpn",
                   min_level: int = 3,
                   max_level: int = 7) -> Dict[str, Union[str, Tuple[str, ...]]]:
    """{flax path: TF name, or a tuple of them} for the BiFPN (automl's
    ``fpn_cells`` scheme) over P``min_level``..P``max_level``.

    automl numbers the L input features as graph nodes 0..L-1 (P3..P7:
    0..4) and each cell's new nodes from L on, in the order of
    ``models/bifpn.node_plan`` (P3..P7: 5..12 for P6td, P5td, P4td, P3out,
    P4out, P5out, P6out, P7out; P3..P8: 6..15 for P7td ... P8out): node j
    is ``fnode{j}``, its conv and BN under ``op_after_combine{j+L}``. The
    fast-fusion weights are per-input SCALARS ``WSM``, ``WSM_1``, ...: a
    node's vector maps onto a TUPLE of names (stacked on import, split on
    export). The first cell's channel-matching 1x1 convs are
    ``fnode{j}/resample_0_{src}_{j+L}`` of the node j that takes backbone
    level ``src`` (C3..C5: 0..2) first; the P6 conv is the top-level
    ``resample_p6`` (the levels above it are max-pools, with no variables).
    """
    m: Dict[str, Union[str, Tuple[str, ...]]] = {}

    def bn(ours: str, tf: str):
        m[f"params/{ours}/scale"] = f"{tf}/gamma"
        m[f"params/{ours}/bias"] = f"{tf}/beta"
        m[f"batch_stats/{ours}/mean"] = f"{tf}/moving_mean"
        m[f"batch_stats/{ours}/var"] = f"{tf}/moving_variance"

    def conv2d(ours: str, tf: str):
        m[f"params/{ours}/kernel"] = f"{tf}/kernel"
        m[f"params/{ours}/bias"] = f"{tf}/bias"

    root = bifpn_key
    plan = node_plan(min_level, max_level)
    n = max_level - min_level + 1
    j_of = {name: j for j, (name, _, _) in enumerate(plan)}
    # the first cell's input resamples: (ours, the node that takes it, source node)
    for ours, node, src in (("p5_in_td", "p5_td", 2), ("p4_in_td", "p4_td", 1),
                            ("p3_in", "p3_out", 0), ("p4_in_bu", "p4_out", 1),
                            ("p5_in_bu", "p5_out", 2)):
        j = j_of[node]
        tf = f"fpn_cells/cell_0/fnode{j}/resample_0_{src}_{j + n}"
        conv2d(f"{root}/layer0/{ours}_conv", f"{tf}/conv2d")
        bn(f"{root}/layer0/{ours}_bn", f"{tf}/bn")
    conv2d(f"{root}/layer0/p6_in_conv", "resample_p6/conv2d")
    bn(f"{root}/layer0/p6_in_bn", "resample_p6/bn")
    for cell in range(depth):
        for j, (ours, _, inputs) in enumerate(plan):
            node = f"{root}/layer{cell}/{ours}"
            tf_node = f"fpn_cells/cell_{cell}/fnode{j}"
            oac = f"{tf_node}/op_after_combine{j + n}"
            if weighted:
                m[f"params/{node}/fusion_weights"] = tuple(
                    f"{tf_node}/WSM" + (f"_{i}" if i else "") for i in range(len(inputs)))
            m[f"params/{node}/conv/depthwise/kernel"] = f"{oac}/conv/depthwise_kernel"
            m[f"params/{node}/conv/pointwise/kernel"] = f"{oac}/conv/pointwise_kernel"
            m[f"params/{node}/conv/pointwise/bias"] = f"{oac}/conv/bias"
            bn(f"{node}/bn", f"{oac}/bn")
    return m


def detector_name_map(config) -> Dict[str, Union[str, Tuple[str, ...]]]:
    """The complete {flax path: TF name(s)} map of a detector
    (:class:`~efficientdet_tpu_torch.configs.ModelConfig`): the backbone
    (prefixed ``backbone/``), the BiFPN and both heads, every parameter and
    BN statistic."""
    m: Dict[str, Union[str, Tuple[str, ...]]] = {}
    for ours, tf in backbone_name_map(config.backbone).items():
        coll, path = ours.split("/", 1)
        m[f"{coll}/backbone/{path}"] = tf
    m.update(bifpn_name_map(config.bifpn_depth, config.weighted_bifpn,
                            min_level=config.min_level, max_level=config.max_level))
    m.update(head_name_map("class", config.head_depth, config.num_levels, config.min_level))
    m.update(head_name_map("box", config.head_depth, config.num_levels, config.min_level))
    return m


def torch_key(flax_path: str, prefix: str = "") -> str:
    """``params/a/b/kernel`` -> ``{prefix}a.b.weight``, by the flax bridge's rule."""
    coll, path = flax_path.split("/", 1)
    return prefix + _key(coll, tuple(path.split("/")))


def _is_depthwise(flax_path: str) -> bool:
    return flax_path.endswith(("depthwise_conv/kernel", "depthwise/kernel"))


def _tf_to_torch(flax_path: str, arr: np.ndarray) -> np.ndarray:
    if arr.ndim == 4:
        # TF depthwise (H, W, C, 1) -> (C, 1, H, W); dense (H, W, I, O) -> OIHW
        return arr.transpose(2, 3, 0, 1) if _is_depthwise(flax_path) else arr.transpose(3, 2, 0, 1)
    return arr


def _torch_to_tf(flax_path: str, arr: np.ndarray) -> np.ndarray:
    if arr.ndim == 4:
        return arr.transpose(2, 3, 0, 1) if _is_depthwise(flax_path) else arr.transpose(2, 3, 1, 0)
    return arr


StateOrModel = Union[torch.nn.Module, Dict[str, torch.Tensor]]


def _apply_name_map(target: StateOrModel, tf_vars: Dict[str, np.ndarray], name_map,
                    prefix: str = "", strict: bool = True) -> StateOrModel:
    """Copy ``tf_vars`` onto ``target`` per {flax path: TF name}, shape-checked.

    ``target``: a port model (loaded in place and returned) or a state dict
    (a new dict is returned, in each tensor's own dtype and device)."""
    state = target.state_dict() if isinstance(target, torch.nn.Module) else target
    out = dict(state)
    missing = []
    for ours, tf_name in name_map.items():
        key = torch_key(ours, prefix)
        if key not in state:
            missing.append(("ours", key))
            continue
        if isinstance(tf_name, tuple):
            absent = [n for n in tf_name if n not in tf_vars]
            if absent:
                missing.extend(("tf", n) for n in absent)
                continue
            src = np.stack([np.asarray(tf_vars[n]).reshape(()) for n in tf_name])
        else:
            if tf_name not in tf_vars:
                missing.append(("tf", tf_name))
                continue
            src = _tf_to_torch(ours, np.asarray(tf_vars[tf_name]))
        dst = state[key]
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"shape mismatch for {key} <- {tf_name}: "
                             f"{tuple(src.shape)} vs {tuple(dst.shape)}")
        out[key] = torch.from_numpy(np.ascontiguousarray(src, dtype=np.float32)).to(
            dtype=dst.dtype, device=dst.device)
    if missing and strict:
        raise KeyError(f"unmatched variables ({len(missing)}): {missing[:8]} ...")
    if isinstance(target, torch.nn.Module):
        target.load_state_dict(out)
        return target
    return out


def import_backbone(target: StateOrModel, tf_vars: Dict[str, np.ndarray],
                    model_name: str = "efficientnet-b0", backbone_key: str = "backbone",
                    strict: bool = True) -> StateOrModel:
    """The backbone's weights from ``tf_vars`` (official names -> arrays)
    onto a port model or state dict."""
    return _apply_name_map(target, tf_vars, backbone_name_map(model_name),
                           prefix=f"{backbone_key}." if backbone_key else "", strict=strict)


def import_heads(target: StateOrModel, tf_vars: Dict[str, np.ndarray], head_depth: int,
                 strict: bool = True) -> StateOrModel:
    """The class and box heads' weights from an automl-style checkpoint; for
    the whole detector use :func:`import_detector`, which also enforces
    full coverage."""
    m = {**head_name_map("class", head_depth), **head_name_map("box", head_depth)}
    return _apply_name_map(target, tf_vars, m, strict=strict)


def import_detector(target: StateOrModel, tf_vars: Dict[str, np.ndarray], config,
                    strict: bool = True) -> StateOrModel:
    """A FULL automl-style EfficientDet checkpoint (backbone, BiFPN, heads)
    onto a port model or state dict. Under ``strict`` every mapped variable
    must exist on both sides with its shape, AND the map must cover every
    tensor of the target (:func:`assert_full_coverage`), so a naming drift
    cannot leave random weights in the model."""
    name_map = detector_name_map(config)
    if strict:
        state = target.state_dict() if isinstance(target, torch.nn.Module) else target
        assert_full_coverage(state, name_map)
    return _apply_name_map(target, tf_vars, name_map, strict=strict)


def assert_full_coverage(state: Dict[str, torch.Tensor], name_map) -> None:
    """Raise unless ``name_map`` covers EVERY tensor of the state dict."""
    covered = {torch_key(ours) for ours in name_map}
    uncovered = sorted(k for k in state if k not in covered)
    if uncovered:
        raise KeyError(f"name map leaves {len(uncovered)} variables unmapped "
                       f"(import would keep their random weights): {uncovered[:8]} ...")


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().float().numpy()


def export_tf_style(target: StateOrModel, model_name: str = "efficientnet-b0",
                    backbone_key: str = "backbone") -> Dict[str, np.ndarray]:
    """Inverse of :func:`import_backbone` (round-trip aid): {TF name: array},
    float32 in TF's layout; entries the target lacks are left out."""
    state = target.state_dict() if isinstance(target, torch.nn.Module) else target
    prefix = f"{backbone_key}." if backbone_key else ""
    out = {}
    for ours, tf_name in backbone_name_map(model_name).items():
        key = torch_key(ours, prefix)
        if key in state:
            out[tf_name] = _torch_to_tf(ours, _numpy(state[key]))
    return out


def export_detector_tf_style(target: StateOrModel, config) -> Dict[str, np.ndarray]:
    """Inverse of :func:`import_detector`: the {TF name: array} dict an
    automl checkpoint reader would give, float32, the fusion-weight vectors
    split back into WSM scalars. A mapped tensor the target lacks raises."""
    state = target.state_dict() if isinstance(target, torch.nn.Module) else target
    out: Dict[str, np.ndarray] = {}
    for ours, tf_name in detector_name_map(config).items():
        key = torch_key(ours)
        if key not in state:
            raise KeyError(f"export: {key} missing from the state dict")
        arr = _numpy(state[key])
        if isinstance(tf_name, tuple):
            for i, n in enumerate(tf_name):
                out[n] = arr[i]
        else:
            out[tf_name] = _torch_to_tf(ours, arr)
    return out
