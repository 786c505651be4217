"""Online serving loop: a filesystem-queue inference daemon.

Counterpart of `micformer_tpu/cli/serve.py`. Load the model once, then serve
requests as they arrive; a producer thread loads and preprocesses request
k+1 while the device computes request k.

Request protocol (drop files into --watch):
  <name>.npy              float32/float16 [2, D, H, W] preprocessed CT+MR
                          volume, or
  ct_<id>_image.nii.gz    the CT half of a raw pair; its mr_<id>_image.nii.gz
                          partner is read with it, and both are normalised
                          (--normalisation) and resized to --target-shape as
                          in training's preprocessing.
Results appear in --out as <name>_seg.nii.gz plus a <name>.done file holding
one JSON line: the request's latency and the kernel launches it made. A
request file is claimed once its mtime is 0.2 s old (write-complete
heuristic) and never reprocessed; a malformed one gets a <file>.error.

The model comes from a training run (--run-dir: `config.json` and
`ckpt_<--ckpt-tag>.pt`, rebuilt by `config.run_model`) or from --weights, a
state_dict saved with torch.save, with --model (micformer or mednext) built
from the registry. --model-kwargs (JSON) goes over either's arguments. A
model that returns a list (deep supervision) serves its first,
full-resolution output. PyTorch runs eagerly, so there is no executable to
warm: the first request builds the kernel libraries if no earlier call did.

--exported serves an artifact of cli/export (`convert/aot_export.py`): the
whole pipeline, tiling to argmax, as one `torch.export` program whose kernels
are custom ops. It takes an argmax artifact only, its volume shape from the
artifact's meta.json, and runs the artifact's program for --device (a
device the artifact holds no program for is refused); the model zoo and the
checkpoint are not read.

    python -m micformer_tpu_torch.cli.serve --run-dir runs/mednext \
        --watch in/ --out out/ --bf16 --target-shape 160 --max-requests 3
    python -m micformer_tpu_torch.cli.serve --exported runs/mednext/exported \
        --watch in/ --out out/ --max-requests 3
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import threading
import time

import numpy as np
import torch


def _discover_requests(watch: str, seen: set[str]):
    """New, write-complete request files (.npy or ct_*_image.nii.gz)."""
    out = []
    now = time.time()
    try:
        names = sorted(os.listdir(watch))
    except FileNotFoundError:
        return out
    for fn in names:
        path = os.path.join(watch, fn)
        is_request = fn.endswith(".npy") or (fn.startswith("ct_")
                                             and fn.endswith("_image.nii.gz"))
        if path in seen or not is_request or not os.path.isfile(path):
            continue
        try:
            if now - os.path.getmtime(path) < 0.2:
                continue  # possibly still being written
        except OSError:
            continue
        out.append(path)
    return out


def _load_request(path: str, target_shape, normalisation: str):
    """-> (request name, image [2, D, H, W] float32)."""
    if path.endswith(".npy"):
        img = np.asarray(np.load(path), dtype=np.float32)
        if img.ndim != 4 or img.shape[0] != 2:
            raise ValueError(f"{path}: expected [2, D, H, W], got {img.shape}")
        return os.path.basename(path)[: -len(".npy")], img

    from micformer_tpu_torch.data import image_utils as iu
    from micformer_tpu_torch.data.nifti import read_nifti

    mr_path = os.path.join(os.path.dirname(path),
                           os.path.basename(path).replace("ct_", "mr_", 1))
    norm = iu.NORMALIZERS[normalisation]
    ct = norm(read_nifti(path, dtype=np.float32))
    mr = norm(read_nifti(mr_path, dtype=np.float32))
    img = np.stack([iu.resize_trilinear(ct, target_shape),
                    iu.resize_trilinear(mr, target_shape)]).astype(np.float32)
    return os.path.basename(path)[: -len("_image.nii.gz")], img


def build_model(*, run_dir=None, weights=None, model=None, model_kwargs="{}",
                num_classes=8, ckpt_tag="best_dice", fused_attention=False, bf16=False,
                device="cuda"):
    """(model name, model with its weights) of a training run (`config.json`
    and `ckpt_<ckpt_tag>.pt`, the model rebuilt by `config.run_model`) or of
    a state_dict file (`weights`, the family `model`, default micformer);
    `model_kwargs` (JSON) goes over either's arguments. The rule of serve and
    export."""
    from micformer_tpu_torch import registry
    from micformer_tpu_torch.config import run_model
    from micformer_tpu_torch.train.checkpoint import CheckpointManager

    if run_dir:
        model_name, kwargs = run_model(run_dir, model, num_classes)
        state = CheckpointManager(run_dir).restore_params_only(ckpt_tag)
    else:
        model_name, kwargs = model or "micformer", {"num_classes": num_classes}
        state = torch.load(weights, map_location="cpu", weights_only=True)
    kwargs.update(json.loads(model_kwargs))
    if fused_attention:
        kwargs["fused_attention"] = True
    dtype = torch.bfloat16 if bf16 else torch.float32
    net = registry.build(model_name, dtype=dtype, device=device, **kwargs)
    net.load_state_dict(state)
    return model_name, net


def main(argv=None, report=None):
    """Serve until --max-requests or --idle-exit; returns each request's
    latency in seconds. `report`, a dict, gets serve's start-up facts:
    the model's name, and for --exported the artifact's load seconds and
    its graph's op nodes (`aot_export.op_nodes`)."""
    from micformer_tpu_torch import native
    from micformer_tpu_torch.convert.aot_export import (
        build_inference_fn, load_artifact, op_nodes, read_meta,
    )
    from micformer_tpu_torch.data.image_utils import NORMALIZERS
    from micformer_tpu_torch.data.nifti import write_nifti
    from micformer_tpu_torch.kernels import LAUNCHES

    p = argparse.ArgumentParser("micformer_tpu_torch.serve")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--run-dir", default=None,
                     help="training run dir (config.json and checkpoints)")
    src.add_argument("--weights", default=None, help="state_dict .pt file")
    src.add_argument("--exported", default=None,
                     help="an artifact dir of cli/export (argmax), served instead "
                          "of a model: no model zoo, no checkpoint")
    p.add_argument("--ckpt-tag", default="best_dice",
                   choices=["best_dice", "best_loss", "latest"])
    p.add_argument("--model", default=None,
                   help="registered model family (default: the run's, else micformer)")
    p.add_argument("--model-kwargs", default="{}",
                   help="JSON object of model constructor arguments")
    p.add_argument("--num_classes", type=int, default=8)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; --exported: one of the artifact's platforms")
    p.add_argument("--watch", required=True, help="request drop directory")
    p.add_argument("--out", required=True, help="result directory")
    p.add_argument("--target-shape", type=int, default=128,
                   help="size NIfTI-pair requests are resized to")
    p.add_argument("--normalisation", default="minmax", choices=sorted(NORMALIZERS))
    p.add_argument("--roi", type=int, default=128)
    p.add_argument("--overlap", type=float, default=0.5)
    p.add_argument("--sw-batch-size", type=int, default=4)
    p.add_argument("--step-mode", default="monai", choices=["monai", "nnunet"])
    p.add_argument("--mirror-tta", action="store_true")
    p.add_argument("--bf16", action="store_true",
                   help="serve in bfloat16 (the bench protocol)")
    p.add_argument("--fused-attention", action="store_true",
                   help="MicFormer: run attention through the fused kernel K2 "
                        "(the JAX package's MICFORMER_FUSED_ATTENTION=1)")
    p.add_argument("--poll", type=float, default=0.5,
                   help="watch-directory poll interval (seconds)")
    p.add_argument("--max-requests", type=int, default=None,
                   help="exit after N requests (bounded runs / tests)")
    p.add_argument("--idle-exit", type=float, default=None,
                   help="exit after this many idle seconds (default: run "
                        "forever)")
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    ts = (args.target_shape,) * 3
    report = {} if report is None else report
    # NIfTI-pair requests are read and resized by the native library: build
    # it now, not inside the first request
    native.available()

    if args.exported:
        # the artifact is the whole pipeline (tiling, model, blending,
        # argmax); its meta pins the serving shapes and the device
        meta = read_meta(args.exported)
        if meta["output"] != "argmax_uint8":
            raise SystemExit("serve needs an argmax artifact (re-export without --logits)")
        dev = torch.device(args.device)
        if dev.type not in meta["platforms"]:
            raise SystemExit(f"serve: the artifact runs on {meta['platforms']}, "
                             f"not on --device {args.device}")
        t0 = time.perf_counter()
        infer, meta = load_artifact(args.exported, device=dev)
        load_s = time.perf_counter() - t0
        ts = tuple(meta["input_shape"][2:])
        model_name = meta.get("model", "exported")
        report.update(load_s=load_s, op_nodes=op_nodes(infer))
        print(f"serve: exported {model_name} on {dev} (shape {ts}, roi {meta['roi']}, "
              f"sw_batch {meta['sw_batch_size']}), loaded in {load_s:.2f} s, op nodes "
              f"{json.dumps(report['op_nodes'])}; watching {args.watch}", flush=True)
    else:
        model_name, model = build_model(
            run_dir=args.run_dir, weights=args.weights, model=args.model,
            model_kwargs=args.model_kwargs, num_classes=args.num_classes,
            ckpt_tag=args.ckpt_tag, fused_attention=args.fused_attention, bf16=args.bf16,
            device=args.device)
        dev = next(model.parameters()).device
        # the composition an artifact exports: tiling, model, blending, argmax
        infer = build_inference_fn(
            model, roi=(args.roi,) * 3, num_classes=args.num_classes, overlap=args.overlap,
            sw_batch_size=args.sw_batch_size, step_mode=args.step_mode,
            mirror_tta=args.mirror_tta)
        print(f"serve: {model_name} on {dev} (roi {args.roi}, sw_batch "
              f"{args.sw_batch_size}, {next(model.parameters()).dtype}); "
              f"watching {args.watch}", flush=True)
    report["model"] = model_name

    # producer thread: watch + load (host-bound); main thread: device compute
    # and export. Queue depth 2 keeps one request loading while one computes.
    req_q: queue.Queue = queue.Queue(maxsize=2)
    seen: set[str] = set()
    stop = threading.Event()

    def produce():
        while not stop.is_set():
            found = _discover_requests(args.watch, seen)
            for path in found:
                seen.add(path)
                try:
                    name, img = _load_request(path, ts, args.normalisation)
                except (OSError, ValueError) as e:  # malformed: report, go on
                    with open(os.path.join(args.out, os.path.basename(path)
                                           + ".error"), "w") as f:
                        f.write(str(e))
                    continue
                while not stop.is_set():
                    try:
                        req_q.put((name, img), timeout=args.poll)
                        break
                    except queue.Full:
                        continue
            if not found:
                stop.wait(args.poll)

    producer = threading.Thread(target=produce, daemon=True)
    producer.start()

    served = 0
    latencies = []
    idle_since = time.time()
    try:
        while args.max_requests is None or served < args.max_requests:
            try:
                name, img = req_q.get(timeout=args.poll)
            except queue.Empty:
                if (args.idle_exit is not None
                        and time.time() - idle_since > args.idle_exit):
                    break
                continue
            before = dict(LAUNCHES)
            t1 = time.perf_counter()
            with torch.no_grad():
                seg = infer(torch.from_numpy(img[None]).to(dev))
            seg_np = seg[0].cpu().numpy()
            latency = time.perf_counter() - t1
            write_nifti(os.path.join(args.out, f"{name}_seg.nii.gz"), seg_np)
            served += 1
            latencies.append(latency)
            idle_since = time.time()
            stats = {"request": name, "latency_s": latency, "served": served,
                     "mean_latency_s": sum(latencies) / served,
                     "launches": {k: LAUNCHES[k] - before[k] for k in LAUNCHES}}
            with open(os.path.join(args.out, f"{name}.done"), "w") as f:
                json.dump(stats, f)
            print(f"serve: {json.dumps(stats)}", flush=True)
    finally:
        stop.set()
        producer.join(timeout=10)

    print(f"serve: exiting after {served} request(s)", flush=True)
    return latencies


if __name__ == "__main__":
    main()
