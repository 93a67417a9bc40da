"""The port's train.py and evaluate.py CLIs on the CPU.

A CSV dataset of PNG files in tmp_path; EfficientDet-D0 at 128 px, batch 2,
epochs of one step, ``--device cpu``. The written ``train_config.json``,
read by the JAX package's ``train_config_from_snapshot``, gives the JAX
``TrainConfig`` of the same fields; ``train_log.jsonl`` has the JAX loop's
metric keys; ``--snapshot`` resumes the step count; the refusals exit as the
JAX CLI's do; ``evaluate.main`` restores the directory and prints the mAP.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from efficientdet_tpu.configs import TrainConfig as JTrainConfig
from efficientdet_tpu.configs import train_config_from_snapshot as j_from_snapshot
from efficientdet_tpu_torch import evaluate, train
from efficientdet_tpu_torch.configs import train_config_from_snapshot

# the metric keys of the JAX loop's step lines
STEP_KEYS = {"loss", "grad_norm", "cls_loss", "box_loss", "num_positives", "epoch", "step", "sec"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: tier-1 runs six test processes on the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def csv_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("csvcli")
    rng = np.random.RandomState(0)
    rows = []
    for i, (w, h) in enumerate([(160, 120), (96, 128), (128, 128), (200, 100)]):
        Image.fromarray(rng.randint(0, 256, (h, w, 3)).astype(np.uint8)).save(root / f"img{i}.png")
        rows.append(f"img{i}.png,10,12,{w // 2},{h // 2},thing")
        rows.append(f"img{i}.png,{w // 3},{h // 3},{w - 5},{h - 5},widget")
    (root / "annots.csv").write_text("\n".join(rows) + "\n")
    (root / "classes.csv").write_text("thing,0\nwidget,1\n")
    return root


def _argv(csv_dir, ckpt, *extra):
    return ["csv", str(csv_dir / "annots.csv"), str(csv_dir / "classes.csv"), "--device", "cpu",
            "--image-size", "128", "--batch-size", "2", "--snapshot-path", str(ckpt), *extra]


def _log(ckpt):
    with open(ckpt / "train_log.jsonl") as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def trained(csv_dir, tmp_path_factory):
    ckpt = tmp_path_factory.mktemp("ckpt")
    state = train.main(_argv(csv_dir, ckpt, "--epochs", "2", "--steps", "1", "--ema-decay", "0.9",
                             "--val-annotations-path", str(csv_dir / "annots.csv"), "--compute-val-loss"))
    return ckpt, state


def test_train_writes_jax_compatible_files(trained):
    ckpt, state = trained
    assert state.step == 2
    with open(ckpt / "train_config.json") as f:
        saved = json.load(f)
    assert saved["model"] == {"phi": 0, "num_classes": 2, "weighted_bifpn": True, "freeze_bn": False,
                              "image_size": 128}
    port_tc = train_config_from_snapshot(saved)
    assert port_tc.ema_decay == 0.9 and port_tc.steps_per_epoch == 1 and port_tc.batch_size == 2
    assert dataclasses.asdict(j_from_snapshot(saved)) == dataclasses.asdict(port_tc)
    assert set(saved["train"]) == {f.name for f in dataclasses.fields(JTrainConfig)}
    steps = [m for m in _log(ckpt) if "loss" in m]
    assert len(steps) == 2 and all(set(m) == STEP_KEYS for m in steps)
    assert [m["step"] for m in steps] == [1, 2] and all(np.isfinite(m["loss"]) for m in steps)
    assert sorted(os.listdir(ckpt)) == ["1", "2", "train_config.json", "train_log.jsonl"]
    metrics = json.loads((ckpt / "2" / "metrics.json").read_text())
    assert {"loss", "mAP", "val_loss", "val_cls_loss", "val_box_loss"} <= set(metrics)


def test_resume_continues_the_step_count(trained, csv_dir, tmp_path, capsys):
    ckpt, _ = trained
    state = train.main(_argv(csv_dir, tmp_path / "resumed", "--epochs", "1", "--steps", "1",
                             "--ema-decay", "0.9", "--snapshot", str(ckpt), "--no-eval"))
    assert state.step == 3
    assert f"resumed from {ckpt} at step 2" in capsys.readouterr().out
    assert [m["step"] for m in _log(tmp_path / "resumed")] == [3]


def test_evaluate_prints_the_map(trained, csv_dir, capsys):
    ckpt, _ = trained
    out = evaluate.main(["csv", str(csv_dir / "annots.csv"), str(csv_dir / "classes.csv"),
                         "--snapshot", str(ckpt), "--device", "cpu", "--dtype", "f32", "--use-ema"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("EfficientDet-D0 | 128px | 2 classes | 4 images | cpu")
    assert lines[1].startswith("thing: AP=") and lines[2].startswith("widget: AP=")
    assert json.loads(lines[-1]) == {"mAP": round(out["mAP"], 4)}
    assert 0.0 <= out["mAP"] <= 1.0 and set(out["aps"]) == {0, 1}


def test_device_augment_and_data_echo_run(csv_dir, tmp_path):
    state = train.main(_argv(csv_dir, tmp_path, "--epochs", "1", "--steps", "2", "--device-augment",
                             "--data-echo", "2", "--workers", "2", "--no-eval", "--log-file",
                             str(tmp_path / "log.jsonl"), "--tensorboard-dir", str(tmp_path / "tb")))
    assert state.step == 2
    with open(tmp_path / "log.jsonl") as f:
        losses = [json.loads(line)["loss"] for line in f]
    # the echoed batch is a new view: another loss
    assert len(losses) == 2 and losses[0] != losses[1] and np.isfinite(losses).all()


def test_device_cache_with_device_augment_runs(csv_dir, tmp_path, capsys):
    state = train.main(_argv(csv_dir, tmp_path, "--epochs", "1", "--steps", "1", "--device-cache", "3",
                             "--device-augment", "--no-eval", "--debug-nans"))
    assert state.step == 1
    out = capsys.readouterr().out
    assert '"device_cache_images": 3' in out


@pytest.mark.parametrize("extra, message", [
    (("--device-cache", "4", "--random-transform"), "host-side --random-transform can't apply"),
    (("--snapshot", "imagenet"), "needs pretrained weights"),
])
def test_refusals_exit_as_jax(csv_dir, tmp_path, extra, message):
    with pytest.raises(SystemExit, match=message):
        train.main(_argv(csv_dir, tmp_path, "--epochs", "1", "--steps", "1", "--no-eval", *extra))


def test_epoch_evaluation_leaves_the_training_weights(csv_dir, monkeypatch):
    """The epoch evaluation runs on the EMA weights in eval mode, then puts
    back the training weights and mode, and moves no BN statistic."""
    from efficientdet_tpu_torch import build_efficientdet
    from efficientdet_tpu_torch.configs import TrainConfig
    from efficientdet_tpu_torch.data import CsvDataset
    from efficientdet_tpu_torch.train_lib import create_train_state

    model, _ = build_efficientdet(0, num_classes=2, image_size=128, device="cpu")
    model.train()
    state = create_train_state(model, TrainConfig(ema_decay=0.9), device="cpu")
    with torch.no_grad():
        for v in state.ema_params.values():
            v.mul_(0.5)
    params = {k: v.detach().clone() for k, v in state.params.items()}
    buffers = {k: v.clone() for k, v in model.named_buffers()}
    seen = []
    real = train.eval_weights

    def spy(m, s):
        ctx = real(m, s)

        class Spy:
            def __enter__(self):
                out = ctx.__enter__()
                seen.append((m.training, all(torch.equal(s.params[k], s.ema_params[k]) for k in s.params)))
                return out

            def __exit__(self, *exc):
                return ctx.__exit__(*exc)

        return Spy()

    args = train.parse_args(["csv", "a", "b", "--batch-size", "2"])
    ds = CsvDataset(str(csv_dir / "annots.csv"), str(csv_dir / "classes.csv"))
    monkeypatch.setattr(train, "eval_weights", spy)
    ap = train.evaluate_epoch(args, model, state, ds, 128)
    assert seen == [(False, True)] and 0.0 <= ap <= 1.0
    assert model.training
    for k, v in state.params.items():
        assert torch.equal(v, params[k]), k
    for k, v in model.named_buffers():
        assert torch.equal(v, buffers[k]), k
