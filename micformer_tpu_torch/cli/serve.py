"""Online serving loop: a filesystem-queue inference daemon.

Counterpart of the `.npy` request path of `micformer_tpu/cli/serve.py`. Load
the model once, then serve requests as they arrive; a producer thread loads
request k+1 while the device computes request k.

Request protocol (drop files into --watch):
  <name>.npy    float32/float16 [2, D, H, W] preprocessed CT+MR volume.
Results appear in --out as <name>_seg.nii.gz plus a <name>.done file holding
one JSON line: the request's latency and the kernel launches it made. A
request file is claimed once its mtime is 0.2 s old (write-complete
heuristic) and never reprocessed; a malformed one gets a <name>.npy.error.

Weights come from --weights, a state_dict saved with torch.save; the model is
--model (micformer or mednext), built from the registry with --model-kwargs
(JSON) over its defaults. A model that returns a list (deep supervision)
serves its first, full-resolution output. PyTorch runs eagerly, so there is
no executable to warm: the first request builds the kernel libraries if no
earlier call did.

    python -m micformer_tpu_torch.cli.serve --model mednext --weights w.pt \
        --watch in/ --out out/ --bf16 --max-requests 3
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
    """New, write-complete .npy request files."""
    out = []
    now = time.time()
    try:
        names = sorted(os.listdir(watch))
    except FileNotFoundError:
        return out
    for fn in names:
        path = os.path.join(watch, fn)
        if path in seen or not fn.endswith(".npy") or not os.path.isfile(path):
            continue
        try:
            if now - os.path.getmtime(path) < 0.2:
                continue  # possibly still being written
        except OSError:
            continue
        out.append(path)
    return out


def _load_request(path: str):
    """-> (request name, image [2, D, H, W] float32)."""
    img = np.asarray(np.load(path), dtype=np.float32)
    if img.ndim != 4 or img.shape[0] != 2:
        raise ValueError(f"{path}: expected [2, D, H, W], got {img.shape}")
    return os.path.basename(path)[: -len(".npy")], img


def main(argv=None):
    from micformer_tpu_torch import registry
    from micformer_tpu_torch.data.nifti import write_nifti
    from micformer_tpu_torch.infer import sliding_window_inference
    from micformer_tpu_torch.kernels import LAUNCHES

    p = argparse.ArgumentParser("micformer_tpu_torch.serve")
    p.add_argument("--weights", required=True, help="state_dict .pt file")
    p.add_argument("--model", default="micformer", help="registered model family")
    p.add_argument("--model-kwargs", default="{}",
                   help="JSON object of model constructor arguments")
    p.add_argument("--num_classes", type=int, default=8)
    p.add_argument("--device", default="cuda")
    p.add_argument("--watch", required=True, help="request drop directory")
    p.add_argument("--out", required=True, help="result directory")
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

    kwargs = dict(json.loads(args.model_kwargs), num_classes=args.num_classes)
    if args.fused_attention:
        kwargs["fused_attention"] = True
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    model = registry.build(args.model, dtype=dtype, device=args.device, **kwargs)
    state = torch.load(args.weights, map_location="cpu", weights_only=True)
    model.load_state_dict(state)
    dev = next(model.parameters()).device

    def predictor(win):
        out = model(win)
        return out[0] if isinstance(out, (list, tuple)) else out

    def infer(volume):
        logits = sliding_window_inference(
            volume, (args.roi,) * 3, predictor, num_classes=args.num_classes,
            overlap=args.overlap, sw_batch_size=args.sw_batch_size,
            step_mode=args.step_mode, mirror_tta=args.mirror_tta)
        return logits.argmax(dim=1).to(torch.uint8)

    print(f"serve: {args.model} on {dev} (roi {args.roi}, sw_batch "
          f"{args.sw_batch_size}, {dtype}); watching {args.watch}", flush=True)

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
                    name, img = _load_request(path)
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
