"""The port stands alone: no JAX, no flax, nothing of efficientdet_tpu.

Nor cv2 or PIL, which the machine that runs the port on the card lacks:
only the host-only demo helpers (utils/image.py), the CLI's drawing and the
HTTP handler import them, inside the function that needs them.
"""

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
# the top-level experiments/ and tools/ are the JAX package's (tools/ is also
# imported by its bare module names); the port's own
# efficientdet_tpu_torch.experiments and .tools (relative imports too) are allowed
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "efficientdet_tpu", "experiments",
             "tools", "analyze_trace", "parity_run")
# imported only inside a function, and only in these files
HOST_ONLY = ("cv2", "PIL")
HOST_ONLY_FILES = ("utils/image.py", "predict.py", "serve.py")


def _modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(efficientdet_tpu_torch.__path__, "efficientdet_tpu_torch.")
    )


def test_every_module_imports_without_jax():
    code = (
        "import importlib, sys\n"
        f"for name in {_modules()!r}: importlib.import_module(name)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN + HOST_ONLY!r})\n"
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


def _module_level_imports(path):
    """The imports a module runs when it is imported (not inside a function)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    todo = list(tree.body)
    while todo:
        node = todo.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        todo.extend(ast.iter_child_nodes(node))


SOURCES = [os.path.join(d, f) for d, _, fs in os.walk(PKG) for f in fs if f.endswith(".py")] + [
    os.path.join(ROOT, "chip_smoke.py")]


@pytest.mark.parametrize("path", SOURCES)
def test_no_forbidden_import_in_source(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"
    bad = [m for m in _module_level_imports(path) if m.split(".")[0] in HOST_ONLY]
    assert not bad, f"{path} imports {bad} when it is imported"
    if not path.replace(os.sep, "/").endswith(tuple(f"efficientdet_tpu_torch/{f}" for f in HOST_ONLY_FILES)):
        bad = [m for m in _imports(path) if m.split(".")[0] in HOST_ONLY]
        assert not bad, f"{path} imports {bad}"


def test_host_only_guard_sees_function_level_imports(tmp_path):
    src = tmp_path / "probe.py"
    src.write_text("import numpy\ntry:\n    import cv2\nexcept ImportError:\n    pass\n"
                   "def f():\n    from PIL import Image\n")
    assert sorted(_module_level_imports(str(src))) == ["cv2", "numpy"]
    assert "PIL" in list(_imports(str(src)))


def test_guard_walks_the_port_experiments(tmp_path):
    mods = _modules()
    for name in ("experiments.packed_mbconv", "experiments.mbconv", "experiments.packed_chain",
                 "experiments.tap_floor", "ops.mbconv_kernel", "ops.tap_floor_kernel",
                 "predict", "inference", "serve", "data.common", "utils.image",
                 "utils.checkpoint", "utils.cuda_graph", "train_lib", "losses", "anchors",
                 "models.normalization", "models.remat", "utils.convert", "data.csv_", "data.coco",
                 "data.pascal", "data.augment", "data.device_cache", "ops.augment", "evaluation",
                 "evaluation.coco_eval", "evaluation.voc", "evaluation.host_overlap", "train", "evaluate",
                 "experiments.int8_microbench", "experiments.stage1_packing",
                 "tools.analyze_trace", "tools.parity_run"):
        assert f"efficientdet_tpu_torch.{name}" in mods
    src = tmp_path / "probe.py"
    src.write_text("from ..experiments import packed_mbconv\nimport experiments.packed_chain\n"
                   "from ..tools import analyze_trace\nimport tools.parity_run\n"
                   "import analyze_trace\n")
    # the port's own experiments and tools, imported relatively, are not the JAX package's
    assert [m for m in _imports(str(src)) if m.split(".")[0] in FORBIDDEN] == [
        "experiments.packed_chain", "tools.parity_run", "analyze_trace"]


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
    with pytest.raises(RuntimeError, match="no CUDA device"):
        efficientdet_tpu_torch.Predictor()
    from efficientdet_tpu_torch.predict import main

    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--image", "unused.png"])


def test_data_evaluation_and_clis_import_without_cv2_or_pil():
    """In a process where importing cv2 or PIL fails, the data, evaluation
    and CLI modules import (they read images only inside load_image)."""
    code = (
        "import sys\n"
        "sys.modules['cv2'] = None\n"
        "sys.modules['PIL'] = None\n"
        "import efficientdet_tpu_torch.data, efficientdet_tpu_torch.evaluation\n"
        "import efficientdet_tpu_torch.train, efficientdet_tpu_torch.evaluate\n"
        "import efficientdet_tpu_torch.data.augment, efficientdet_tpu_torch.ops.augment\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stdout + out.stderr


def test_training_clis_raise_without_gpu(monkeypatch, tmp_path):
    from efficientdet_tpu_torch import evaluate, train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["csv", str(tmp_path / "missing.csv"), str(tmp_path / "classes.csv")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate.main(["csv", str(tmp_path / "missing.csv"), str(tmp_path / "classes.csv"),
                       "--snapshot", str(tmp_path)])
    from efficientdet_tpu_torch.data import DeviceDataCache

    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceDataCache([None], 64)  # raises before it reads the dataset


def test_graphs_need_a_cuda_input():
    from efficientdet_tpu_torch.utils.cuda_graph import GraphedCall, capturable_constant

    with pytest.raises(ValueError, match="CUDA input"):
        GraphedCall(lambda x: x + 1, torch.zeros(3), pool=None)
    values = (0.485, 0.456, 0.406)
    assert torch.equal(capturable_constant(values, "cpu"), torch.tensor(values, dtype=torch.float32))


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
def test_streamed_head_plan_on_the_gpu():
    """On a GPU: the head kernel's streamed plan (bf16, Cin 88 and 384, the
    class and the box launch, rows that end inside a 128-row tile) within
    one bf16 ulp of its plain version, padded rows holding the bias only."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs the kernels at full size")
    from efficientdet_tpu_torch.ops.head_kernel import (
        bf16_plan,
        head_pointwise_anchor_major,
        head_pointwise_reference,
    )

    g = torch.Generator().manual_seed(0)
    for cin in (88, 384):
        for a, out in ((9, 90), (1, 36)):
            assert bf16_plan(cin, a, out) == "streamed"
            x = torch.randn(1000, cin, generator=g).bfloat16().cuda()
            k = (torch.randn(cin, a * out, generator=g) * cin ** -0.5).cuda()
            b = torch.randn(a * out, generator=g).cuda()
            z, amax, m = head_pointwise_anchor_major(x, k, b, a)
            zr, ar, _ = head_pointwise_reference(x, k, b, a)
            for got, want in ((z, zr), (amax, ar)):
                got, want = got.float(), want.float()
                assert bool(((got - want).abs() <= 2.0 ** -7 * want.abs() + 1e-4).all())
            pad = b.bfloat16().float().reshape(a, 1, out).expand(a, z.shape[1] - m, out)
            assert torch.equal(z[:, m:].float(), pad)


@pytest.mark.cuda
def test_streamed_plan_inside_d4_graphs_on_the_gpu(monkeypatch):
    """On a GPU: D4 in bf16 (drawn weights, calibrated BNs). Its anchor-major
    pipeline captured in a CUDA graph holds the head kernel's two launches
    on the streamed plan (Cin 224, counted at capture) and the NMS kernel,
    and its replay equals the eager call bit for bit; the Predictor's graph
    (its heads are convolutions, as the JAX package's) replays equal to
    eager() bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs the entry points at full size")
    import numpy as np

    import efficientdet_tpu_torch as et
    from efficientdet_tpu_torch.experiments.drawn_weights import drawn_model
    from efficientdet_tpu_torch.ops import head_kernel as hk
    from efficientdet_tpu_torch.utils.cuda_graph import GraphedCall

    captured = []
    launch = hk.launch_into

    def recording(x2d, kt, bias, z, amax, num_anchors):
        if torch.cuda.is_current_stream_capturing():
            captured.append((x2d.shape[1], num_anchors, z.shape[2]))
        return launch(x2d, kt, bias, z, amax, num_anchors)

    monkeypatch.setattr(hk, "launch_into", recording)
    state = drawn_model("cuda", seed=4, phi=4, gain=1.0, calibrate=True).state_dict()
    model, cfg = et.build_efficientdet(4, num_classes=90, dtype=torch.bfloat16, device="cuda")
    model.load_state_dict(state)
    ec = et.EvalConfig(score_threshold=0.0)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randint(0, 256, (2, cfg.image_size, cfg.image_size, 3))
                         .astype(np.uint8)).cuda()
    graph = GraphedCall(lambda t: et.predict_pipeline(model, t, ec), x,
                        pool=torch.cuda.graph_pool_handle())
    assert [c[0] for c in captured] == [224, 224]
    assert all(hk.bf16_plan(*c) == "streamed" for c in captured)
    replay = [t.clone() for t in graph(x)]
    with torch.inference_mode():
        eager = et.predict_pipeline(model, x, ec)
    assert all(torch.equal(a, b) for a, b in zip(replay, eager))
    assert int(eager[3].min()) > 0
    p = et.Predictor(phi=4, dtype="bf16", score_threshold=0.0, variables=state)
    for hw in ((480, 640), (300, 200)):
        img = rng.randint(0, 256, hw + (3,)).astype(np.uint8)
        got, want = p(img), p.eager(img)
        assert len(got[1]) > 0
        assert all(np.array_equal(a, b) for a, b in zip(got, want))


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


@pytest.mark.cuda
def test_predictor_graph_replay_equals_eager():
    """On a GPU: a Predictor's CUDA graph at one source shape, replayed on
    two images, gives exactly what the eager pipeline gives."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs the Predictor at full size")
    import numpy as np

    p = efficientdet_tpu_torch.Predictor(phi=0, num_classes=8, image_size=256)
    rng = np.random.RandomState(0)
    for _ in range(2):
        img = rng.randint(0, 256, (120, 200, 3)).astype(np.uint8)
        for got, want in zip(p(img), p.eager(img)):
            np.testing.assert_array_equal(got, want)
    assert list(p._run_cache) == [(120, 200)]


@pytest.mark.cuda
def test_predictor_threads_at_two_shapes_on_the_gpu():
    """On a GPU: threads sharing one Predictor at two source shapes (two
    CUDA graphs of one pool) each get the answer eager() gives their image."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs the Predictor at full size")
    import threading

    import numpy as np

    p = efficientdet_tpu_torch.Predictor(phi=0, num_classes=8, image_size=256, score_threshold=0.0)
    rng = np.random.RandomState(1)
    images = [rng.randint(0, 256, hw + (3,)).astype(np.uint8)
              for hw in ((120, 200), (200, 120)) for _ in range(2)]
    want = [p.eager(img) for img in images]
    errors = []

    def caller(k):
        for _ in range(10):
            got = p(images[k % len(images)])
            if not all(np.array_equal(g, w) for g, w in zip(got, want[k % len(images)])):
                errors.append(k)

    threads = [threading.Thread(target=caller, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    assert sorted(p._run_cache) == [(120, 200), (200, 120)]


@pytest.mark.cuda
def test_ops_launch_their_kernels_and_export_on_the_gpu(tmp_path):
    """On a GPU: each custom op launches its kernel (its wrapper's counter
    goes up by one a call), and a tiny exported function of both round-trips
    through torch.export.save/load with the same results."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs the export at full size")
    from efficientdet_tpu_torch.ops import head_kernel as hk
    from efficientdet_tpu_torch.ops import nms_kernel as nk

    g = torch.Generator().manual_seed(0)
    x = torch.randn(700, 64, generator=g).cuda()
    k = torch.randn(64, 9 * 6, generator=g).cuda() * 0.1
    b = torch.randn(9 * 6, generator=g).cuda()
    xy = torch.rand(2, 100, 2, generator=g) * 200
    boxes = torch.cat([xy, xy + 10 + torch.rand(2, 100, 2, generator=g) * 50], -1).cuda()
    cls = torch.randint(0, 3, (2, 100), generator=g).int().cuda()
    valid = (torch.rand(2, 100, generator=g) > 0.1).cuda()
    before = (hk.head_pointwise_anchor_major.launches, nk.suppression_keep_mask.launches)
    torch.ops.efficientdet_tpu_torch.head_pointwise(x, k, b, 9)
    torch.ops.efficientdet_tpu_torch.nms_keep_mask(boxes, cls, valid, 0.5)
    assert (hk.head_pointwise_anchor_major.launches, nk.suppression_keep_mask.launches) == (
        before[0] + 1, before[1] + 1)

    class Both(torch.nn.Module):
        def forward(self, x, k, b, boxes, cls, valid):
            z, amax, _ = hk.head_pointwise_anchor_major(x, k, b, 9)
            return z, amax, nk.suppression_keep_mask(boxes, cls, valid, 0.5)

    args = (x, k, b, boxes, cls, valid)
    path = str(tmp_path / "both.pt2")
    torch.export.save(torch.export.export(Both(), args), path)
    got = torch.export.load(path).module()(*args)
    want = Both()(*args)
    for g_, w in zip(got, want):
        assert torch.equal(g_, w)
    assert hk.head_pointwise_anchor_major.launches == before[0] + 3
    assert nk.suppression_keep_mask.launches == before[1] + 3


def test_parallel_modules_and_rank_programs_import_without_jax():
    """parallel/ and the rank programs that the multi-rank tests and
    chip_smoke.py start (tests/torch_parallel_ranks.py) run in processes
    that import no JAX: importing them pulls in nothing forbidden."""
    ranks = os.path.join(ROOT, "tests", "torch_parallel_ranks.py")
    code = (
        "import importlib.util, sys\n"
        "import efficientdet_tpu_torch.parallel, efficientdet_tpu_torch.parallel.launch\n"
        f"spec = importlib.util.spec_from_file_location('ranks', {ranks!r})\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN + HOST_ONLY!r})\n"
        "print(bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
    bad = [m for m in _imports(ranks) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{ranks} imports {bad}"


def test_parallel_entry_points_raise_without_gpu(monkeypatch):
    from efficientdet_tpu_torch.parallel import make_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    assert make_mesh(device="cpu").world_size == 1


@pytest.mark.cuda
def test_sharded_predict_at_world_size_one_on_the_gpu():
    """On a GPU: NCCL at world size 1; make_sharded_predict_fn launches the
    head and NMS kernels and equals make_predict_fn bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs the parallel phase at full size")
    import numpy as np

    from efficientdet_tpu_torch.ops import head_kernel as hk
    from efficientdet_tpu_torch.ops import nms_kernel as nk
    from efficientdet_tpu_torch.parallel import make_mesh, make_sharded_predict_fn
    from efficientdet_tpu_torch.parallel.launch import free_port

    mesh = make_mesh(init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1, rank=0,
                     timeout_s=60)
    try:
        assert mesh.backend == "nccl"
        model, _ = efficientdet_tpu_torch.build_efficientdet(0, num_classes=6, image_size=128)
        images = torch.from_numpy(
            np.random.RandomState(0).randint(0, 256, (3, 128, 128, 3)).astype(np.uint8)).cuda()
        before = (hk.head_pointwise_anchor_major.launches, nk.suppression_keep_mask.launches)
        got = make_sharded_predict_fn(model, mesh)(images)
        torch.cuda.synchronize()
        assert (hk.head_pointwise_anchor_major.launches, nk.suppression_keep_mask.launches) == (
            before[0] + 2, before[1] + 1)
        want = efficientdet_tpu_torch.make_predict_fn(model)(images)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    finally:
        mesh.close()
