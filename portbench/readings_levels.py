"""``readings.py`` for a cell of ``kind`` ``batched_levels`` (``d7x-b16``): the
readings its correctness limits are set from, with the control and the
layer-by-layer comparison computed through ``reference/levels.py``.

    python3 portbench/readings_levels.py --workload d7x-b16 --seeds 11 12 13 \
        --control-seeds 11 12 --faults drop_best_level invert_nms --fault-seeds 21 22 \
        --levels-seed 11 --levels-images 16 --levels-block 2

For each seed, one run of the cell as ``run.py`` makes it (a short window of
``--seconds``) prints the port's numbers; for each control seed, the same
run's checked inputs also go through the control, the reference computed
through fp8 (``lib/precision.py``) in the port's place; for each fault seed,
one run with each of ``--faults`` planted in the port (``faults.py``). One
JSON line each. With ``--levels-seed``, one more line: the timed path (the
cell's folded model in its precision, the anchor-major heads as
``make_predict_fn`` runs them) against the float32 reference on
``--levels-images`` images of the seed, ``--levels-block`` at a time: the
backbone's taps C3..C5 and each level's logits and box deltas, each as the
largest gap over the largest magnitude of the reference's; the fp8 control
beside it; and the BiFPN's fusion counters over one forward. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import faults  # noqa: E402
from portbench.lib import precision  # noqa: E402
from portbench.lib.bench import Bench, Cell  # noqa: E402
from portbench.readings import digest  # noqa: E402


def control_numbers(bench) -> dict:
    """The fp8 control's numbers on the canvases a run checked."""
    from portbench.lib.detect import gaps, reference_outputs
    from portbench.traffic.batched_levels import reference_model

    check = bench.extra.pop("check")
    ev, block, canvases = check["ev"], check["block"], check["canvases"]
    low = reference_model(check["cfg"], check["sd"], canvases.device,
                          precision.BELOW[bench.params["precision"]])
    dets = [d for _, _, d, _ in reference_outputs(low, canvases, ev, block)]
    del low
    ref = reference_model(check["cfg"], check["sd"], canvases.device)
    return {"control": gaps(ref, canvases, dets, ev, block)[0].numbers()}


def _levels(cls_out, box_out, batch: int, sizes):
    """The anchor-major heads' outputs as each level's (B, H, W, A*C) logits
    and (B, H, W, A*4) deltas, the layout of the reference's ``levels``."""
    z, _, hws = cls_out
    zb, _ = box_out
    a, c = z.shape[0], z.shape[2]
    cls, box, off = [], [], 0
    for hw, (h, w) in zip(hws, sizes):
        rows = slice(off, off + batch * hw)
        cls.append(z[:, rows].reshape(a, batch, h, w, c).permute(1, 2, 3, 0, 4)
                   .reshape(batch, h, w, a * c))
        box.append(zb[rows].reshape(batch, h, w, -1))
        off += batch * hw
    return cls, box


def levels_numbers(cell, seed: int, images: int, block: int, device: str = "cuda") -> dict:
    """The timed path and the fp8 control against the float32 reference,
    layer by layer (see the module's docstring)."""
    import torch

    from efficientdet_tpu_torch.models import bifpn
    from efficientdet_tpu_torch.ops.preprocess import preprocess_batch_fixed
    from portbench.lib.models import DTYPES, port_model, reference_config
    from portbench.reference.model import normalize
    from portbench.traffic.batched_levels import drawn_state_dict, reference_model

    bench = Bench(cell, seed, 0.0, False, time.perf_counter(), device)
    cfg = reference_config(cell.config)
    size, dtype = cfg.image_size, DTYPES[bench.params["precision"]]
    sd = drawn_state_dict(cfg, bench.seed_for("weights"), device)
    gen = torch.Generator(device).manual_seed(bench.seed_for("images"))
    canvases = torch.randint(0, 256, (images, size, size, 3), generator=gen, device=device,
                             dtype=torch.uint8)
    sizes = [(-(-size // s),) * 2 for s in cfg.strides]
    port = port_model(cell.config, sd, dtype, device, fuse=True)
    names = ["C3", "C4", "C5"] + [f"P{s.bit_length() - 1}" for s in cfg.strides]
    out, worst, scale = {}, {"port": {}, "control": {}}, {}
    with torch.inference_mode():
        x = preprocess_batch_fixed(canvases, dtype=dtype)
        taps = port.backbone(x.permute(0, 3, 1, 2))
        before = (bifpn.fuse.sum, bifpn.fuse.weighted)
        cls, box = _levels(*port(x, anchor_major=True), images, sizes)
        out["fusion_nodes"] = {"sum": bifpn.fuse.sum - before[0],
                               "weighted": bifpn.fuse.weighted - before[1]}
        timed = [(f"{n}.tap", t) for n, t in zip(names[:3], taps)]
        timed += [(f"{n}.cls", t) for n, t in zip(names[3:], cls)]
        timed += [(f"{n}.box", t) for n, t in zip(names[3:], box)]
        del port, x
        ref = reference_model(cfg, sd, device)
        low = reference_model(cfg, sd, device, precision.BELOW[bench.params["precision"]])

        def outputs(model, xb):
            got_cls, got_box = model(xb, levels=True)
            return list(model.backbone(xb.permute(0, 3, 1, 2))) + got_cls + got_box

        for i in range(0, images, block):
            xb = normalize(canvases[i:i + block])
            want, control = outputs(ref, xb), outputs(low, xb)
            for (key, t), r, c in zip(timed, want, control):
                scale[key] = max(scale.get(key, 0.0), float(r.abs().max()))
                for side, got in (("port", t[i:i + block]), ("control", c)):
                    gap = float((got.float() - r).abs().max())
                    worst[side][key] = max(worst[side].get(key, 0.0), gap)
    for side in worst:
        out[side] = {k: v / scale[k] for k, v in worst[side].items()}
    out["scale"] = scale
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--faults", nargs="*", default=[], choices=sorted(faults.FAULTS))
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--levels-seed", type=int, default=None)
    p.add_argument("--levels-images", type=int, default=16)
    p.add_argument("--levels-block", type=int, default=2)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        sys.exit("portbench/readings_levels.py: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = Cell(ROOT, args.workload)
    if cell.kind != "batched_levels":
        sys.exit(f"portbench/readings_levels.py: {args.workload} is a {cell.kind!r} cell; "
                 "use readings.py")
    if args.levels_seed is not None:
        rec = levels_numbers(cell, args.levels_seed, args.levels_images, args.levels_block)
        print(json.dumps({"workload": args.workload, "seed": args.levels_seed,
                          "levels": rec}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    runs = [(seed, None) for seed in args.seeds]
    runs += [(seed, fault) for fault in args.faults for seed in args.fault_seeds]
    for seed, fault in runs:
        undo = faults.plant(fault) if fault else None
        bench = Bench(cell, seed, args.seconds, False, time.perf_counter())
        try:
            cell.traffic().run(bench)
        finally:
            if undo:
                undo()
        rec = {"workload": args.workload, "seed": seed, "fault": fault, "numbers": bench.numbers,
               "faults": bench.faults, "end_to_end": bench.end_to_end,
               "answers": digest(bench.extra["check"]["port"])}
        if seed in args.control_seeds and not fault:
            rec.update(control_numbers(bench))
        print(json.dumps(rec), flush=True)
        del bench
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
