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
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "efficientdet_tpu")


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
