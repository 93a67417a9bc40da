"""The port stands alone: no JAX, no flax, nothing of efficientdet_tpu."""

import ast
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import efficientdet_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "efficientdet_tpu_torch")
# the top-level experiments/ package is the JAX package's; the port's own
# efficientdet_tpu_torch.experiments (relative imports too) is allowed
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "efficientdet_tpu", "experiments")


def _modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(efficientdet_tpu_torch.__path__, "efficientdet_tpu_torch.")
    )


def test_every_module_imports_without_jax():
    code = (
        "import importlib, sys\n"
        f"for name in {_modules()!r}: importlib.import_module(name)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", [
    os.path.join(d, f) for d, _, fs in os.walk(PKG) for f in fs if f.endswith(".py")
] + [os.path.join(ROOT, "chip_smoke.py")])
def test_no_forbidden_import_in_source(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_guard_walks_the_port_experiments(tmp_path):
    mods = _modules()
    for name in ("experiments.packed_mbconv", "experiments.mbconv", "experiments.packed_chain",
                 "experiments.tap_floor", "ops.mbconv_kernel", "ops.tap_floor_kernel"):
        assert f"efficientdet_tpu_torch.{name}" in mods
    src = tmp_path / "probe.py"
    src.write_text("from ..experiments import packed_mbconv\nimport experiments.packed_chain\n")
    # the port's own experiments, imported relatively, are not the JAX package's
    assert [m for m in _imports(str(src)) if m.split(".")[0] in FORBIDDEN] == [
        "experiments.packed_chain"]


def test_experiment_entry_points_raise_without_gpu(monkeypatch):
    from efficientdet_tpu_torch.experiments import packed_chain, packed_mbconv, tap_floor

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        packed_mbconv.torch_block(packed_mbconv.BLOCKS["d0s1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        packed_chain.torch_chain(packed_chain.TINY_CHAIN)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tap_floor.measure_rate("fma", 9, 1, 1)
    with pytest.raises(RuntimeError, match="on the GPU"):
        packed_mbconv.run_block(packed_mbconv.BLOCKS["d0s1"], device="cpu")


def test_new_wrappers_reject_other_devices():
    from efficientdet_tpu_torch.experiments.packed_mbconv import BLOCKS
    from efficientdet_tpu_torch.ops.mbconv_kernel import fused_mbconv_nhwc, packed_mbconv
    from efficientdet_tpu_torch.ops.tap_floor_kernel import tap_floor

    meta = [torch.empty((1, 1), device="meta")] * 10
    with pytest.raises(ValueError, match="unsupported device"):
        packed_mbconv(torch.empty((1, 32, 4), device="meta"), meta, BLOCKS["d0s1"])
    with pytest.raises(ValueError, match="unsupported device"):
        fused_mbconv_nhwc(torch.empty((1, 2, 2, 32), device="meta"), meta, 3, False)
    with pytest.raises(ValueError, match="lie on"):
        packed_mbconv(torch.empty((1, 32, 4)), meta, BLOCKS["d0s1"])
    with pytest.raises(ValueError, match="unsupported device"):
        tap_floor(torch.empty((8, 128), device="meta"))


def test_entry_point_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        efficientdet_tpu_torch.build_efficientdet(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        efficientdet_tpu_torch.efficientdet_d0(device="cuda")


def test_wrappers_reject_other_devices():
    from efficientdet_tpu_torch.ops.head_kernel import head_pointwise_anchor_major
    from efficientdet_tpu_torch.ops.nms_kernel import suppression_keep_mask

    meta = torch.empty((4, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        head_pointwise_anchor_major(meta, torch.empty((8, 9), device="meta"), torch.empty(9, device="meta"), 9)
    with pytest.raises(ValueError, match="unsupported device"):
        suppression_keep_mask(torch.empty((1, 4, 4), device="meta"), torch.empty((1, 4), device="meta"),
                              torch.empty((1, 4), device="meta"))


@pytest.mark.cuda
def test_kernels_on_the_gpu():
    """On a GPU: both kernels against their plain versions, small shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs the kernels at full size")
    from efficientdet_tpu_torch.ops.head_kernel import head_pointwise_anchor_major, head_pointwise_reference
    from efficientdet_tpu_torch.ops.nms_kernel import suppression_keep_mask, suppression_keep_mask_reference

    g = torch.Generator().manual_seed(0)
    x = torch.randn(1000, 64, generator=g).cuda()
    k = torch.randn(64, 9 * 90, generator=g).cuda() * 0.1
    b = torch.randn(9 * 90, generator=g).cuda()
    got = head_pointwise_anchor_major(x, k, b, 9)
    want = head_pointwise_reference(x, k, b, 9)
    torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=1e-4)
    xy = torch.rand(2, 300, 2, generator=g) * 200
    boxes = torch.cat([xy, xy + 10 + torch.rand(2, 300, 2, generator=g) * 100], -1).cuda()
    cls = torch.randint(0, 3, (2, 300), generator=g).int().cuda()
    valid = (torch.rand(2, 300, generator=g) > 0.1).cuda()
    assert torch.equal(suppression_keep_mask(boxes, cls, valid), suppression_keep_mask_reference(boxes, cls, valid))


@pytest.mark.cuda
def test_mbconv_and_floor_kernels_on_the_gpu():
    """On a GPU: the fused MBConv's three launchers and the floor kernel
    against their plain versions, small shapes (float32, TF32 off)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs the kernels at full size")
    from efficientdet_tpu_torch.experiments.packed_mbconv import BlockShape, pack_params, torch_block
    from efficientdet_tpu_torch.ops import mbconv_kernel as mk
    from efficientdet_tpu_torch.ops.tap_floor_kernel import tap_floor, tap_floor_reference

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(0)
    for shape in (BlockShape("exp_skip", 2, 16, 8, 48, 8, 3, 2), BlockShape("noexp", 2, 16, 8, 8, 4, 3, 2),
                  BlockShape("k5", 2, 8, 8, 24, 8, 5, 2), BlockShape("wide", 1, 40, 56, 336, 56, 5, 14)):
        block, _ = torch_block(shape, torch.float32, device="cuda")
        packed = pack_params(block)
        x = torch.randn(shape.batch, shape.hw, shape.hw, shape.cin, generator=g).cuda()
        want = mk.unpack_x(mk.packed_mbconv_reference(mk.pack_x(x), packed, shape), shape.hw)
        tol = 1e-4 * max(want.abs().max().item(), 1.0)
        got = mk.unpack_x(mk.packed_mbconv(mk.pack_x(x), packed, shape), shape.hw)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=tol)
        mask = mk.rp_mask(shape.hw, torch.float32, "cuda")
        got_rp = mk.packed_mbconv_rp(mk.pack_rp(x), mask, packed, shape)
        assert (got_rp * (1 - mask)).abs().max().item() == 0.0
        torch.testing.assert_close(mk.unpack_rp(got_rp, shape.hw), want, rtol=1e-4, atol=tol)
        got_n = mk.fused_mbconv_nhwc(x.contiguous(), packed, shape.ksize, shape.has_skip)
        torch.testing.assert_close(got_n, want, rtol=1e-4, atol=tol)
    x = torch.rand(64, 1024, generator=g).cuda()
    for op, chains in (("fma", 1), ("fma", 4), ("swish", 4)):
        torch.testing.assert_close(tap_floor(x, op, 9, 3, chains), tap_floor_reference(x, op, 9, 3, chains),
                                   rtol=1e-5, atol=1e-6)
