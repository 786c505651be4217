"""Ranks of a torch.distributed group on the CPU for the port's parallel tests.

`run_ranks(world, tmp_path, worker, **kw)` spawns `world` processes (gloo,
a `file://` store under tmp_path, so concurrent test workers never share a
port); rank r runs `worker(rank, world, tmp_path, **kw)` on one torch thread
and its return value comes back, in rank order. A rank that raises fails
the call. The workers here import torch and the port only, never JAX: the
tests hold their results against the JAX package in their own process.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.multiprocessing as mp


def _entry(rank, world, tmp_path, worker, kw):
    from micformer_tpu_torch.parallel import distributed

    torch.set_num_threads(1)
    distributed.initialize("cpu", init_method=f"file://{tmp_path}/store", world_size=world,
                           rank=rank)
    try:
        out = worker(rank, world, tmp_path, **kw)
        torch.save(out, os.path.join(tmp_path, f"rank{rank}.pt"))
    finally:
        distributed.shutdown()


def run_ranks(world: int, tmp_path, worker, **kw) -> list:
    tmp_path = str(tmp_path)
    os.makedirs(tmp_path, exist_ok=True)
    mp.start_processes(_entry, args=(world, tmp_path, worker, kw), nprocs=world,
                       start_method="spawn", join=True)
    return [torch.load(os.path.join(tmp_path, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


class Items:
    """An indexable dataset of n distinct samples (picklable for spawned
    loader workers, which import this module and not the test's)."""

    def __init__(self, n=12):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        image = np.full((2, 4, 4, 4), i, np.float32)
        label = np.full((4, 4, 4), i % 8, np.uint8)
        return {"image": image, "label": label, "patient_id": f"p{i}"}


# ---- losses -----------------------------------------------------------------

LOSS_NAMES = ("mdice", "dice_ce", "gdl", "topk", "focal", "mcc", "dice_topk", "dice_bce",
              "pyramid")


def loss_fn(name):
    from micformer_tpu_torch.losses import dice
    from micformer_tpu_torch.train.trainer import LOSSES

    if name == "pyramid":
        return lambda lg, t: dice.deep_supervision_loss(lg, t)
    return LOSSES[name]


def loss_batch(world: int, seed: int = 0):
    """A global batch of 2·world rows whose class content differs by rank
    (rank 0's rows hold classes 0-1, the last rank's all four): logits
    [B, 4, 8, 8, 6], a one-hot target, and a two-level pyramid."""
    rng = np.random.default_rng(seed)
    B, K = 2 * world, 4
    logits = rng.normal(size=(B, K, 8, 8, 6)).astype(np.float32)
    labels = np.stack([rng.integers(0, 2 + (K - 2) * (i // 2) // max(world - 1, 1), (8, 8, 6))
                       for i in range(B)])
    target = np.eye(K, dtype=np.float32)[labels].transpose(0, 4, 1, 2, 3)
    low = rng.normal(size=(B, K, 4, 4, 3)).astype(np.float32)
    return logits, target, low


def whole_batch_losses(world: int) -> dict:
    """name -> (loss, d loss / d logits, d loss / d low) on one process."""
    logits, target, low = loss_batch(world)
    out = {}
    for name in LOSS_NAMES:
        lg = torch.tensor(logits, requires_grad=True)
        lw = torch.tensor(low, requires_grad=True)
        t = torch.from_numpy(target)
        value = loss_fn(name)([lg, lw] if name == "pyramid" else lg, t)
        value.backward()
        out[name] = (value.item(), lg.grad.numpy(), None if lw.grad is None else lw.grad.numpy())
    return out


def losses_worker(rank, world, tmp_path):
    """Each loss on this rank's rows inside global_batch: (loss, d/d logits
    rows, d/d low rows); and global_dice_sums of its rows' sigmoid."""
    from micformer_tpu_torch.losses.dice import global_batch
    from micformer_tpu_torch.parallel.mesh import global_dice_sums, rank_rows

    logits, target, low = loss_batch(world)
    rows = rank_rows(len(logits), rank, world)
    out = {}
    for name in LOSS_NAMES:
        lg = torch.tensor(logits[rows], requires_grad=True)
        lw = torch.tensor(low[rows], requires_grad=True)
        with global_batch():
            value = loss_fn(name)([lg, lw] if name == "pyramid" else lg,
                                  torch.from_numpy(target[rows]))
        value.backward()
        out[name] = (value.item(), lg.grad.numpy(), None if lw.grad is None else lw.grad.numpy())
    probs = torch.sigmoid(torch.tensor(logits[rows], requires_grad=True))
    sums = global_dice_sums(probs, torch.from_numpy(target[rows]))
    out["global_dice_sums"] = [s.detach().numpy() for s in sums]
    return out


# ---- data-parallel training ---------------------------------------------------

def make_model(name: str, kwargs: dict, state=None):
    """The model from seed 0, or with the weights of `state` (a state_dict);
    MedNeXt is built by its class, which takes its block counts."""
    from micformer_tpu_torch import registry
    from micformer_tpu_torch.models.mednext import MedNeXt

    gen = torch.Generator().manual_seed(0)
    if name == "mednext":
        model = MedNeXt(**kwargs)
        registry.init_weights(model, gen)
    else:
        model = registry.build(name, device="cpu", generator=gen, **kwargs)
    if state is not None:
        model.load_state_dict(state)
    return model


def trainer(name, kwargs, run_dir, mesh=None, zero1=False, state=None, **cfg):
    from micformer_tpu_torch.train.trainer import TrainConfig, Trainer

    return Trainer(make_model(name, kwargs, state),
                   TrainConfig(run_dir=str(run_dir), mesh=mesh, zero1=zero1, **cfg))


def train_batches(n: int, batch: int, shape, seed: int = 0):
    """n loader batches (f16 images [batch, 2, *shape], uint8 class maps)."""
    rng = np.random.default_rng(seed)
    return [(rng.uniform(0, 1, (batch, 2) + shape).astype(np.float16),
             rng.integers(0, 8, (batch,) + shape).astype(np.uint8)) for _ in range(n)]


def params_of(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def many_worker(rank, world, tmp_path, jobs):
    """Each (worker, kwargs) of `jobs` in turn; their results in a list."""
    return [fn(rank, world, tmp_path, **kw) for fn, kw in jobs]


def ddp_step_worker(rank, world, tmp_path, name, kwargs, cfg, shape, steps=1, state=None,
                    tag="run"):
    """`steps` DDP steps on this rank's rows of the global batches: the
    losses, the gradients after the first step and the parameters after
    each."""
    from micformer_tpu_torch.parallel.mesh import rank_rows

    tr = trainer(name, kwargs, os.path.join(tmp_path, tag), mesh=f"data={world}", state=state,
                 **cfg)
    losses, params, grads = [], [], None
    for images, labels in train_batches(steps, 2 * world, shape):
        rows = rank_rows(len(images), rank, world)
        rec = tr.train_step(torch.from_numpy(images[rows]), torch.from_numpy(labels[rows]))
        losses.append(rec["loss"])
        if grads is None:
            grads = {n: p.grad.clone() for n, p in tr.model.named_parameters()}
        params.append(params_of(tr.model))
    return {"losses": losses, "grads": grads, "params": params}


def zero1_worker(rank, world, tmp_path, name, kwargs, cfg, shape, val):
    """Plain DDP for four Adam steps and ZeRO-1 for three from the same
    weights; ZeRO-1's checkpoint after its third step; then case-parallel
    validation of the DDP trainer over `val` batches."""
    from micformer_tpu_torch.parallel.mesh import rank_rows

    batches = train_batches(4, 2 * world, shape)
    out = {}
    for tag, zero1, steps in (("ddp", False, 4), ("zero1", True, 3)):
        tr = trainer(name, kwargs, os.path.join(tmp_path, tag), mesh=f"data={world}",
                     zero1=zero1, **cfg)
        params = []
        for images, labels in batches[:steps]:
            rows = rank_rows(len(images), rank, world)
            tr.train_step(torch.from_numpy(images[rows]), torch.from_numpy(labels[rows]))
            params.append(params_of(tr.model))
        out[tag] = {"params": params, "sharded": type(tr.optimizer).__name__}
        if zero1:
            tr.ckpt.save("latest", tr._payload(0, 0.0, 1.0))
        else:
            ddp = tr
    vm = ddp.validate([(torch.from_numpy(i), torch.from_numpy(lab), {}) for i, lab in val])
    out["val"] = vm
    return out


# ---- inference ---------------------------------------------------------------

def sharded_inputs():
    """A [1, 2, 24, 24, 24] volume (8 tiles of 16³ at overlap 0.5) and the
    weight of a linear 2 -> 8 channel predictor."""
    rng = np.random.default_rng(0)
    return (rng.normal(size=(1, 2, 24, 24, 24)).astype(np.float32),
            rng.normal(size=(8, 2)).astype(np.float32))


def linear_predictor(w):
    w = torch.from_numpy(w)
    return lambda x: torch.einsum("oc,bcdhw->bodhw", w, x)


def sharded_worker(rank, world, tmp_path, mirror_tta):
    """sliding_window_inference_sharded on every rank: (logits, predictor
    calls on this rank)."""
    from micformer_tpu_torch.infer import sliding_window_inference_sharded

    vol, w = sharded_inputs()
    fn, calls = linear_predictor(w), []

    def predictor(x):
        calls.append(x.shape[0])
        return fn(x)

    out = sliding_window_inference_sharded(torch.from_numpy(vol), (16,) * 3, predictor,
                                           mirror_tta=mirror_tta)
    return out.numpy(), len(calls)


def predict_worker(rank, world, tmp_path, argv):
    """cli/predict on this rank: its records."""
    from micformer_tpu_torch.cli import predict

    return predict.main(argv)


# ---- the spatial engine -------------------------------------------------------

SCHEDULES = {"isotropic": (((2, 2, 2), (2, 2, 2)), ((3, 3, 3),) * 3),
             "anisotropic": (((1, 2, 2), (2, 2, 2)), ((1, 3, 3), (3, 3, 3), (3, 3, 3)))}


def small_unet(schedule: str, state=None):
    pools, convs = SCHEDULES[schedule]
    return make_model("generic_unet", dict(num_classes=3, base_num_features=4,
                                           pool_kernels=pools, conv_kernels=convs), state)


def spatial_input(depth: int = 32):
    return np.random.default_rng(1).normal(size=(1, 2, depth, 16, 16)).astype(np.float32)


def spatial_worker(rank, world, tmp_path, states):
    """halo_exchange of arange(8) along D (this rank's 8 / W planes); the
    spatial forward of each schedule with the weights of `states`; whether a
    misaligned depth raises."""
    from micformer_tpu_torch.parallel.spatial import halo_exchange, spatial_sharded_apply

    d = 8 // world
    x = torch.arange(8, dtype=torch.float32).reshape(1, 1, 8, 1, 1)[:, :, rank * d:(rank + 1) * d]
    out = {"halo": halo_exchange(x, 1, 1).flatten().tolist()}
    for name in SCHEDULES:
        out[name] = spatial_sharded_apply(small_unet(name, states[name]),
                                          torch.from_numpy(spatial_input()))
    try:
        spatial_sharded_apply(small_unet("isotropic"), torch.from_numpy(spatial_input(24)))
        out["misaligned"] = None
    except ValueError as e:
        out["misaligned"] = str(e)
    return out
