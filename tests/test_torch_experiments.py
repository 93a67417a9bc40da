"""The port's two kernel-free experiments against the JAX package's scripts, on the CPU.

``efficientdet_tpu_torch/experiments/stage1_packing.py`` ports the four
block formulations of ``experiments/stage1_packing_bench.py``: each variant
equals the JAX script's same variant, in its output and in its gradients
with respect to the weights, at batch 1, 16 px, 8 -> 4 channels, float32,
within 1e-5 of each tensor's scale. ``int8_microbench.py`` ports
``experiments/int8_microbench.py``: its int8 product equals numpy's int32
product exactly, and its result keys are the JAX script's (the keys a
section writes when its int8 op runs, or its ``*_int8_error``).
"""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from experiments import stage1_packing_bench as jstage1
from efficientdet_tpu_torch.experiments import drawn_weights, int8_microbench, stage1_packing
import torch_float64_witness
from torch_family import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALE_TOL = 1e-5
JAX_BLOCKS = {"ref_nhwc": jstage1.block_ref, "s2d_grouped": jstage1.block_s2d,
              "s2d_taps": jstage1.block_tap, "nchw": jstage1.block_nchw}


@pytest.fixture(scope="module")
def small():
    return stage1_packing.inputs(batch=1, size=16, cin=8, cout=4, dtype=torch.float32,
                                 device="cpu")


def _jax_value_and_grad(block, x, dwk, pw):
    def loss(params):
        o = block(x, params["dwk"], params["pw"])
        return jnp.sum(o * o), o

    (val, out), grads = jax.value_and_grad(loss, has_aux=True)({"dwk": dwk, "pw": pw})
    return np.asarray(val), np.asarray(out), (np.asarray(grads["dwk"]), np.asarray(grads["pw"]))


def _within_scale(got, want, name):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=SCALE_TOL, atol=SCALE_TOL * np.abs(want).max(),
                               err_msg=name)


@pytest.mark.parametrize("variant", sorted(stage1_packing.VARIANTS))
def test_stage1_variant_equals_the_jax_variant(small, variant):
    x, dwk, pw = small
    val, out, grads = stage1_packing.forward_backward(stage1_packing.VARIANTS[variant], x, dwk, pw)
    jval, jout, jgrads = _jax_value_and_grad(JAX_BLOCKS[variant], *(jnp.asarray(t.numpy()) for t in small))
    assert out.shape == jout.shape == (1, 16, 16, 4)
    _within_scale(out, jout, "output")
    _within_scale(val, jval, "sum of squares")
    for g, w, name in zip(grads, jgrads, ("d dwk", "d pw")):
        assert g.shape == w.shape, name
        _within_scale(g, w, name)


def test_stage1_packing_is_the_jax_packing(small):
    x = small[0]
    packed = stage1_packing.s2d_cm(x)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jstage1.s2d_cm(jnp.asarray(x.numpy()))))
    assert torch.equal(stage1_packing.d2s_cm(packed, x.shape[-1]), x)


def test_stage1_run_checks_every_variant_on_the_cpu():
    recs = stage1_packing.run(batch=1, size=16, cin=8, cout=4, steps=1, dtype=torch.float32,
                              device="cpu")
    assert [r["variant"] for r in recs] == list(stage1_packing.VARIANTS)
    for r in recs:
        assert r["ms"] is None and 0.0 <= r["err_over_tol"] <= 1e-3, r


@pytest.mark.parametrize("shape", [(32, 64, 16), (48, 128, 64)])
def test_int8_product_equals_numpy(shape):
    m, k, n = shape
    rng = np.random.RandomState(m)
    a = rng.randint(-128, 128, (m, k)).astype(np.int8)
    b = rng.randint(-128, 128, (k, n)).astype(np.int8)
    got = int8_microbench.int8_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int32) @ b.astype(np.int32))


def _jax_result_keys():
    """Every ``results[...]`` key the JAX script writes, from its source."""
    with open(os.path.join(ROOT, "experiments", "int8_microbench.py")) as f:
        tree = ast.parse(f.read())
    return {node.slice.value for node in ast.walk(tree)
            if isinstance(node, ast.Subscript) and isinstance(node.value, ast.Name)
            and node.value.id == "results" and isinstance(node.slice, ast.Constant)}


def test_int8_microbench_keys_are_the_jax_scripts():
    jax_keys = _jax_result_keys()
    got = int8_microbench.run("cpu", matmul_size=32, conv_shape=(1, 16, 8, 8), n_lo=1, n_hi=2,
                              reps=1)
    assert "device" in got and got["device"] == "cpu"
    want = set()
    for key in jax_keys:
        section = key.split("_")[0]
        error = f"{section}_int8_error"
        if key == error:
            want |= {key} if error in got else set()
        elif "int8" in key:
            want |= set() if error in got else {key}
        else:
            want.add(key)
    want.add("device")
    assert set(got) == want
    assert {k.split("_")[0] for k in jax_keys if k.endswith("_int8_error")} == {
        "matmul", "conv3x3", "dwconv3x3"}
    # an int8 conv on the CPU sums in int8, not int32: recorded as the JAX script records it
    assert "int8_error" in " ".join(got) and "matmul_int8_speedup" in got


def test_int8_chain_consumes_each_output():
    """Each iteration's input is the last one's plus its output's sum mod 3,
    as the JAX script's fori_loop carry."""
    seen = []

    def op(x):
        seen.append(x.clone())
        return x.to(torch.int32) * 5

    x0 = torch.tensor([[1, 2], [3, 4]], dtype=torch.int8)
    int8_microbench.loop_bench(op, x0, n_lo=2, n_hi=4, reps=1)
    assert len(seen) == 1 + 2 + 4  # the eager probe, then each chain
    starts = [i for i, x in enumerate(seen) if torch.equal(x, x0)]
    assert starts == [0, 1, 5]  # the chain of 4, then the chain of 2
    for chain in (seen[1:5], seen[5:]):
        for prev, nxt in zip(chain, chain[1:]):
            assert torch.equal(nxt, prev + int(prev.to(torch.int32).sum() * 5 % 3))


def test_experiments_run_on_the_gpu_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        int8_microbench.run()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stage1_packing.run()


@pytest.fixture(scope="module")
def drawn_d0():
    return drawn_weights.drawn_model("cpu", seed=3, image_size=128)


def test_drawn_state_dict_covers_the_model(drawn_d0):
    state = drawn_weights.drawn_state_dict(drawn_d0, seed=3)
    own = drawn_d0.state_dict()
    assert sorted(state) == sorted(own)
    for k, v in own.items():
        assert state[k].shape == v.shape and torch.equal(state[k], v.cpu()), k
    var = torch.cat([v for k, v in state.items() if k.endswith("running_var")])
    assert 0.5 <= float(var.min()) and float(var.max()) <= 1.5


def test_the_gain_scales_the_conv_draw_only(drawn_d0):
    base = drawn_weights.drawn_state_dict(drawn_d0, seed=3)
    unit = drawn_weights.drawn_state_dict(drawn_d0, seed=3, gain=1.0)
    for k, v in base.items():
        if k.endswith("weight") and v.dim() == 4:
            torch.testing.assert_close(unit[k], (v.double() * (1 / 1.5) ** 0.5).float(), msg=k)
        else:
            assert torch.equal(unit[k], v), k


def test_calibrate_bn_moves_the_statistics_halfway():
    """calibrate_bn: each BN's running statistics become half their drawn
    values plus half the batch's (the biased variance of its input), the
    momenta are restored and the model is left in eval mode; drawn_model's
    ``calibrate`` runs it on calibration_images of its seed."""
    model = drawn_weights.drawn_model("cpu", seed=3, image_size=128)
    before = {k: v.clone() for k, v in model.state_dict().items() if "running_" in k}
    seen = []
    bn = model.backbone.stem_bn
    hook = bn.register_forward_hook(lambda m, i, o: seen.append(i[0].detach()))
    images = drawn_weights.calibration_images(128, 3)
    assert images.shape == (4, 128, 128, 3) and images.dtype == torch.uint8
    drawn_weights.calibrate_bn(model, images)
    hook.remove()
    assert len(seen) == 1
    x = seen[0].double()
    for name, batch in (("running_mean", x.mean((0, 2, 3))),
                        ("running_var", x.var((0, 2, 3), unbiased=False))):
        want = 0.5 * before[f"backbone.stem_bn.{name}"].double() + 0.5 * batch
        torch.testing.assert_close(getattr(bn, name).double(), want, rtol=1e-5, atol=1e-6)
    assert bn.momentum == 0.99 and not any(m.training for m in model.modules())
    calibrated = drawn_weights.drawn_model("cpu", seed=3, image_size=128, calibrate=True)
    for k, v in model.state_dict().items():
        assert torch.equal(calibrated.state_dict()[k], v), k


def test_float64_witness_on_the_cpu(drawn_d0, capsys):
    images = torch.from_numpy(np.random.RandomState(2).randint(0, 256, (1, 128, 128, 3))
                              .astype(np.uint8))
    rec = torch_float64_witness.float64_distance(drawn_d0, images)
    assert set(rec) == {"class", "box"}
    for r in rec.values():
        assert r["scale"] > 0 and 0 <= r["over_tol"] < 0.1, rec
    for args in (["--weights", "init"], ["--gain", "1"]):
        torch_float64_witness.main(["--phi", "0", "--image-size", "128"] + args)
        line = capsys.readouterr().out.strip().splitlines()[-1]
        assert '"over_tol"' in line and ('"init"' in line or '"gain": 1.0' in line), line
