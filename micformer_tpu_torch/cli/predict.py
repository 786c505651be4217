"""Batch prediction CLI: sliding window, fold ensemble, mirror TTA.

Counterpart of `micformer_tpu/cli/predict.py`: for each
case of the split, each fold's model (one run directory a fold, weights from
`ckpt_<tag>.pt`) predicts by sliding window (mirror TTA optional, serial or,
with MICFORMER_TTA_BATCHED=1, batched), the folds' softmax is averaged, and
its argmax, largest-CC postprocessed on request, is written as
`<pid>_pred.nii.gz`. Cases are loaded and preprocessed ahead of the device
by a background thread, or a pool of threads or worker processes
(`--workers`, `--worker-mode`).

The model is rebuilt from the first run's `config.json` (`config.run_model`)
and every fold runs it with its own weights, so a `--fused-attention` run
predicts through K2; a deep-supervised model predicts with its
full-resolution head. For the 3d engine (and `--sharded-tiles`) each fold's
relative-position biases are gathered once, at the roi, after its weights
load (`models.layers.materialize_rpe_cache`), as the JAX CLI does. Runs on
the card unless --device cpu is given, and raises when CUDA is asked for and
missing.

Cascade: `--cascade-prev-seg-dir` appends the one-hot of the previous
stage's `<pid>_segFromPrevStage.npy` (foreground labels) as input channels;
`--save-seg-for-next-stage` writes those files. `--native-geometry`
resamples the class probabilities to each case's source grid before the
argmax and writes the source affine.

Several ranks (torchrun; see `parallel/distributed.py`) share the work:
  - by default the cases go round-robin by rank (`shard_cases`), each rank
    writing its own;
  - `--sharded-tiles`: every rank predicts every case with the tile grid
    split over the ranks (`infer/sharded.py`, one tile a predictor call,
    --sw-batch-size unused as in JAX), and the primary rank writes;
  - `--engine spatial`: one whole-volume forward of a GenericUNet run with
    D slabbed over the ranks (`parallel/spatial.py`; --spatial-shards, when
    given, must equal the world size; mirror TTA does not apply, as in
    JAX), and the primary rank writes.
With one process these are the 3d engine at sw_batch 1 and the whole-volume
forward.

`--engine 2d` predicts slice by slice with a 2D model (a 2D GenericUNet
run), each slice tiled by roi² (`infer/sliding_window_2d.py`, mirror TTA
over the in-plane axes); `--engine p3d` feeds it each slice with its
neighbours stacked into channels (`--pseudo3d-slices`, odd). Both ignore
`--sharded-tiles`, as JAX's do.

    python -m micformer_tpu_torch.cli.predict --data <root> --cache <cache> \
        --run-dirs runs/fold0 runs/fold1 --out preds --target-shape 160 \
        --roi 128 --sw-batch-size 4 --mirror-tta --largest-cc --save-softmax
    torchrun --nproc-per-node 2 -m micformer_tpu_torch.cli.predict ... --sharded-tiles
    torchrun --nproc-per-node 2 -m micformer_tpu_torch.cli.predict --data <root> \
        --run-dirs runs/generic_unet --engine spatial --target-shape 128
"""

from __future__ import annotations

import argparse
import copy
import os
import queue
import threading
import time

import numpy as np
import torch

def _prefetch_cases(ds, indices, depth: int = 2, workers: int = 0,
                    worker_mode: str = "thread"):
    """Yield (i, ds[i]) for i in indices, loaded ahead of consumption so the
    host's preprocessing (IO, resize, normalise) overlaps the device.

    workers <= 1: one background thread, `depth` cases ahead. workers > 1:
    a pool of threads or worker processes (`worker_mode`) keeps
    max(depth, workers) cases in flight."""
    indices = list(indices)
    if workers > 1:
        from micformer_tpu_torch.data.loader import make_fetch_pool

        pool, fetch_one = make_fetch_pool(ds, workers, worker_mode)
        try:
            depth = max(depth, workers)
            inflight = [(i, fetch_one(i)) for i in indices[:depth]]
            nxt = depth
            while inflight:
                i, fut = inflight.pop(0)
                if nxt < len(indices):
                    inflight.append((indices[nxt], fetch_one(indices[nxt])))
                    nxt += 1
                yield i, fut.result()
        finally:
            pool.shutdown(wait=True, cancel_futures=True)
        return
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def produce():
        try:
            for i in indices:
                item = (i, ds[i])
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
            q.put(None)
        except Exception as e:  # surfaced to the consumer
            q.put(e)

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                return
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        stop.set()
        t.join(timeout=10)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("micformer_tpu_torch.predict")
    p.add_argument("--data", required=True)
    p.add_argument("--cache", default=None)
    p.add_argument("--model", default=None,
                   help="model family; default: the model in the first run "
                        "dir's config.json, else micformer")
    p.add_argument("--run-dirs", nargs="+", required=True,
                   help="one run dir per fold to ensemble")
    p.add_argument("--ckpt-tag", default="best_dice", choices=["best_dice", "best_loss"])
    p.add_argument("--out", default="./output")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--roi", type=int, default=128)
    p.add_argument("--overlap", type=float, default=0.5)
    p.add_argument("--sw-batch-size", type=int, default=2)
    p.add_argument("--step-mode", default="monai", choices=["monai", "nnunet"])
    p.add_argument("--engine", default="3d", choices=["3d", "2d", "p3d", "spatial"],
                   help="3d: volumetric tiles; 2d: slice-by-slice 2D tiles of a 2D "
                        "model; p3d: the same with each slice's neighbours stacked into "
                        "channels; spatial: one whole-volume GenericUNet forward with D "
                        "slabbed over the ranks")
    p.add_argument("--spatial-shards", type=int, default=None,
                   help="ranks of --engine spatial (default and only value: the world size)")
    p.add_argument("--sharded-tiles", action="store_true",
                   help="split each case's tile grid over the ranks")
    p.add_argument("--pseudo3d-slices", type=int, default=5,
                   help="--engine p3d: the odd count of slices each prediction sees")
    p.add_argument("--mirror-tta", action="store_true",
                   help="8-way mirror ensemble; MICFORMER_TTA_BATCHED=1 runs the "
                        "flips as one batched forward")
    p.add_argument("--largest-cc", action="store_true")
    p.add_argument("--split", default="test", choices=["val", "test"])
    p.add_argument("--num_classes", type=int, default=8)
    p.add_argument("--target-shape", type=int, default=128)
    p.add_argument("--cascade-prev-seg-dir", default=None,
                   help="dir of <pid>_segFromPrevStage.npy files whose one-hot "
                        "(foreground labels) is appended as input channels")
    p.add_argument("--save-softmax", action="store_true",
                   help="also save <pid>_softmax.npz (fold-averaged class "
                        "probabilities, float16) for cli.ensemble")
    p.add_argument("--save-seg-for-next-stage", action="store_true",
                   help="also write <pid>_segFromPrevStage.npy (model-grid label "
                        "map) to seed the cascade's next stage")
    p.add_argument("--workers", type=int, default=0,
                   help="case-prefetch workers (>1 enables the pool)")
    p.add_argument("--worker-mode", default="thread", choices=["thread", "process"])
    p.add_argument("--overlays", action="store_true",
                   help="also write <pid>_overlay.png: the segmentation over "
                        "the axial slice with the most foreground")
    p.add_argument("--native-geometry", action="store_true",
                   help="resample the probabilities to each case's source grid "
                        "before the argmax, and write the source affine")
    return p


def main(argv=None):
    """Predict every case of the split; returns one record a case: its
    patient id, seconds (case loaded to files written), infer_seconds (to
    the label map on the host) and kernel launches."""
    from micformer_tpu_torch import native
    from micformer_tpu_torch import registry
    from micformer_tpu_torch.parallel import distributed

    args = build_parser().parse_args(argv)
    native.available()      # the volume reader: built now, not in the first case
    # a group that main joins (torchrun's ranks) it leaves when it ends
    with distributed.joined(registry.resolve_device(args.device)) as device:
        return _predict(args, device)


def _predict(args, device):
    from micformer_tpu_torch import registry
    from micformer_tpu_torch.config import run_model
    from micformer_tpu_torch.data.cascade import resize_seg_nearest, seg_to_onehot
    from micformer_tpu_torch.data.image_utils import resize_trilinear
    from micformer_tpu_torch.data.mmwhs import get_datasets
    from micformer_tpu_torch.data.nifti import read_nifti, write_nifti
    from micformer_tpu_torch.infer import (
        sliding_window_inference, sliding_window_inference_2d,
        sliding_window_inference_pseudo3d, sliding_window_inference_sharded,
    )
    from micformer_tpu_torch.kernels import LAUNCHES
    from micformer_tpu_torch.models.layers import materialize_rpe_cache
    from micformer_tpu_torch.parallel import distributed
    from micformer_tpu_torch.parallel.mesh import is_primary, shard_cases
    from micformer_tpu_torch.parallel.spatial import spatial_sharded_apply
    from micformer_tpu_torch.pipeline.postprocess import remove_all_but_largest_cc
    from micformer_tpu_torch.train.checkpoint import CheckpointManager
    from micformer_tpu_torch.train.logging import save_overlay_png

    rank, world = distributed.world()
    spatial = args.engine == "spatial"
    if args.spatial_shards is not None and (not spatial or args.spatial_shards != world):
        raise SystemExit(f"--spatial-shards {args.spatial_shards}: --engine spatial runs on "
                         f"every rank, {world} here")
    # every rank predicts every case (and the primary writes), or each its own
    collective = spatial or (args.engine == "3d" and args.sharded_tiles)

    os.makedirs(args.out, exist_ok=True)
    ts = (args.target_shape,) * 3
    _, val_ds, test_ds = get_datasets(args.data, cache_dir=args.cache, target_shape=ts)
    ds = val_ds if args.split == "val" else test_ds

    model_name, kwargs = run_model(args.run_dirs[0], args.model, args.num_classes)
    if spatial and model_name != "generic_unet":
        raise SystemExit(f"--engine spatial runs generic_unet, not {model_name}")
    base = registry.build(model_name, device=device, **kwargs)
    win0 = None
    if args.engine == "3d" and len(ds):
        # inference only: each fold's relative-position biases are gathered
        # once, at the roi's windows, after its weights are loaded (a load
        # empties the cache); a model without bias tables is left as is
        n_ch = int(np.asarray(ds[0]["image"]).shape[0])
        if args.cascade_prev_seg_dir:
            n_ch += args.num_classes - 1
        win0 = torch.zeros((1, n_ch) + (args.roi,) * 3, device=device,
                           dtype=next(base.parameters()).dtype)
    models = []
    for rd in args.run_dirs:
        m = copy.deepcopy(base) if models else base
        m.load_state_dict(CheckpointManager(rd).restore_params_only(args.ckpt_tag))
        if win0 is not None:
            materialize_rpe_cache(m, win0)
        models.append(m)

    def infer(model, vol):
        def predictor(win):
            out = model(win)
            return out[0] if isinstance(out, (list, tuple)) else out

        if spatial:
            return spatial_sharded_apply(model, vol)
        common = dict(num_classes=args.num_classes, overlap=args.overlap,
                      step_mode=args.step_mode, mirror_tta=args.mirror_tta)
        if args.engine == "3d" and args.sharded_tiles:
            return sliding_window_inference_sharded(vol, (args.roi,) * 3, predictor, **common)
        common["sw_batch_size"] = args.sw_batch_size
        if args.engine == "2d":
            return sliding_window_inference_2d(vol, (args.roi,) * 2, predictor, **common)
        if args.engine == "p3d":
            return sliding_window_inference_pseudo3d(vol, (args.roi,) * 2, predictor,
                                                     pseudo3d_slices=args.pseudo3d_slices,
                                                     **common)
        return sliding_window_inference(vol, (args.roi,) * 3, predictor, **common)

    def write_case(i, pid, img, probs, seg):
        """Write the case's files; returns the label map's path."""
        probs_np = (probs[0].cpu().numpy() if args.save_softmax or args.native_geometry
                    else None)
        if args.save_softmax:
            np.savez_compressed(os.path.join(args.out, f"{pid}_softmax.npz"),
                                softmax=probs_np.astype(np.float16))
        seg_model_space = seg  # the overlay's grid: that of `img`
        if args.save_seg_for_next_stage:
            np.save(os.path.join(args.out, f"{pid}_segFromPrevStage.npy"), seg)
        affine = None
        if args.native_geometry:
            orig = read_nifti(ds.cases[i].ct, with_header=True)[1]
            affine = orig.affine
            # the header's shape is (x, y, z), arrays are (z, y, x)
            zyx = tuple(int(d) for d in orig.shape[:3])[::-1]
            if zyx != seg.shape:
                seg = np.argmax(resize_trilinear(probs_np, zyx), axis=0).astype(np.uint8)
        if args.largest_cc:
            seg = remove_all_but_largest_cc(seg)
        out_path = os.path.join(args.out, f"{pid}_pred.nii.gz")
        write_nifti(out_path, seg, affine=affine)
        if args.overlays:
            save_overlay_png(img, seg_model_space,
                             os.path.join(args.out, f"{pid}_overlay.png"))
        return out_path

    cases = range(len(ds)) if collective else shard_cases(range(len(ds)), rank, world)
    writes = is_primary() or not collective
    records = []
    for i, s in _prefetch_cases(ds, cases, workers=args.workers,
                                worker_mode=args.worker_mode):
        t0 = time.perf_counter()
        before = dict(LAUNCHES)
        pid = s["patient_id"]
        img = np.asarray(s["image"], np.float32)
        if args.cascade_prev_seg_dir:
            prev = np.load(os.path.join(args.cascade_prev_seg_dir,
                                        f"{pid}_segFromPrevStage.npy"))
            prev = resize_seg_nearest(prev, img.shape[1:])
            onehot = seg_to_onehot(prev, list(range(1, args.num_classes)))
            img = np.concatenate([img, onehot.astype(img.dtype)], axis=0)
        vol = torch.tensor(img[None], device=device)
        probs = None
        for m in models:
            sm = torch.softmax(infer(m, vol), dim=1)
            probs = sm if probs is None else probs + sm
        probs = probs / len(models)
        seg = probs.argmax(dim=1)[0].to(torch.uint8).cpu().numpy()
        t_infer = time.perf_counter() - t0
        out_path = None
        if writes:
            out_path = write_case(i, pid, img, probs, seg)
        rec = {"patient_id": pid, "seconds": time.perf_counter() - t0,
               "infer_seconds": t_infer,
               "launches": {k: LAUNCHES[k] - before[k] for k in LAUNCHES}}
        records.append(rec)
        print(f"{pid}: {f'wrote {out_path}' if writes else f'rank {rank} done'} in "
              f"{rec['seconds']:.3f} s", flush=True)
    return records


if __name__ == "__main__":
    main()
