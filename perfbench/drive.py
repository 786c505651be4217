"""The one general runner of the traffic mixes. A mix is a data file
(`traffic/<mix>.json`) whose `kind` names the entry it drives:

- `serve`: closed-loop calls of the program's serving program
  (`convert.aot_export.build_inference_fn`, as `cli/serve` builds it), one
  client: each call takes `volumes_per_call` volumes of `side`³ from host
  memory to the device, runs tiling, the model, blending and argmax, and
  copies the uint8 map back to the host (`cli/serve.py`'s timed span).
- `train`: `Trainer.train_step` back to back on host batches of f16 images
  and uint8 labels, as the program's loader yields them.

Inputs come from a pool of `pool` distinct synthetic cases made from the
seed and are cycled. Set-up makes the weights and the pool, builds the
entry and warms every shape the window uses; the window then runs for the
given seconds. With a trace, `torch.profiler` records `trace_calls` calls
that start after a third of the window. What the judge needs is kept: the
sampled calls' outputs (serve) or the first steps' readings (train).
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

import numpy as np
import torch

from perfbench import inputs
from perfbench.reference import build_reference
from perfbench.reference.common import make_state

GIB = 2.0 ** 30
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def weights(config: dict, seed: int, device) -> dict:
    """The cell's f32 weights, drawn on `device` from the seed."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return make_state(build_reference(config, device="meta"), gen, device)


def data_generator(seed: int, device) -> torch.Generator:
    """The generator of the inputs: another stream than the weights'."""
    return torch.Generator(device=device).manual_seed((2 * seed + 1) % 2 ** 63)


def program_model(config: dict, dtype, device, state: dict) -> torch.nn.Module:
    """The program's model of `config` (`registry.build` with the config's
    `program_kwargs`, else its `kwargs`), built on the meta device and given
    `state` on `device`: no weights are drawn on the host. The state loads
    strictly, so the program's parameters have the reference's shapes; they
    must number the config's `parameters`. Its buffers, which `to_empty`
    leaves unset, are given the values its constructor computes
    (`derived_buffers`); a model without buffers builds nothing more."""
    from micformer_tpu_torch import registry

    kwargs = config.get("program_kwargs", config["kwargs"])
    with torch.device("meta"):
        model = registry.build(config["model"], dtype=dtype, device="meta", **kwargs)
    count = sum(p.numel() for p in model.parameters())
    if count != config["parameters"]:
        raise RuntimeError(f"{config['name']}: the program's model has {count} parameters, "
                           f"the configuration states {config['parameters']}")
    buffers = derived_buffers(config["model"], kwargs, model)
    model.to_empty(device=device)
    for name, value in buffers.items():
        model.get_buffer(name).copy_(value)
    model.load_state_dict(state)
    return model


def derived_buffers(name: str, kwargs: dict, model: torch.nn.Module) -> dict:
    """{buffer name: value} of `model`, the registered `name` built on the
    meta device with `kwargs`: what its constructor computes for each
    buffer. Only non-persistent buffers are taken, such as the rel-pos
    models' `rel_pos_index`: the reference cannot supply a buffer that a
    state_dict holds. The values come from a twin that the registered
    factory builds under the meta device, without `registry.build`'s move
    to it: its parameters hold nothing, while a buffer made from host data
    (`torch.from_numpy`) keeps its values on the CPU. A buffer that the
    twin holds on meta has no value to give, and is refused."""
    from micformer_tpu_torch import registry

    names = [n for n, _ in model.named_buffers()]
    if not names:
        return {}
    held = model.state_dict()
    persistent = [n for n in names if n in held]
    if persistent:
        raise RuntimeError(f"{name}: the buffers {persistent} are in the state_dict, and the "
                           "reference has no value for them")
    factory, registered = registry._lookup(name)
    with torch.device("meta"):
        twin = factory(**{**registered, **kwargs})
    values = dict(twin.named_buffers())
    unset = [n for n in names if n not in values or values[n].is_meta]
    if unset:
        raise RuntimeError(f"{name}: the buffers {unset} are computed on the meta device, "
                           "so to_empty would leave them unset")
    return {n: values[n] for n in names}


# The one value of each of these mix keys that the runner and the judge
# implement: closed-loop arrivals, and the training step whose reference
# (`judge.train_readings`) is Adam, the mdice loss, the monai augmentation
# and the cosine schedule. A mix that asks for another is refused.
FIXED = {"serve": {"arrival": "closed"},
         "train": {"arrival": "closed", "optimizer": "adam", "loss": "mdice",
                   "augment": "monai", "scheduler": "cosine"}}


def check_mix(mix: dict) -> None:
    """Refuse a mix of an unknown kind, or one that sets a key of FIXED to
    a value that is not implemented."""
    if mix.get("kind") not in FIXED:
        raise ValueError(f"mix kind {mix.get('kind')!r}: one of {sorted(FIXED)}")
    for key, value in FIXED[mix["kind"]].items():
        if mix.get(key) != value:
            raise ValueError(f"mix {key} {mix.get(key)!r}: only {value!r} is implemented")


class Trace:
    """torch.profiler over `calls` calls that start after `after` seconds
    of the window; after the window, `export` writes its Chrome trace to
    `path`, so the writing stays out of the window."""

    def __init__(self, calls: int, after: float, path: str):
        self.calls, self.after, self.path = calls, after, path
        self.first = None        # index of the first traced call
        self.prof = None         # the profiler while it records
        self.done = None         # the profiler once it has stopped
        self.span = None

    @staticmethod
    def warm(device):
        """Start the profiler once in set-up, so its own start-up stays out
        of the window."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.ones(1, device=device).add_(1)
            torch.cuda.synchronize(device)

    def before(self, i: int, elapsed: float):
        if self.first is None and elapsed >= self.after:
            from torch.profiler import ProfilerActivity, profile

            self.first = i
            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.start()
            self.span = torch.autograd.profiler.record_function("perfbench.stretch")
            self.span.__enter__()

    def after_call(self, i: int):
        if self.prof is not None and i == self.first + self.calls - 1:
            self.span.__exit__(None, None, None)
            self.prof.stop()
            self.done, self.prof = self.prof, None

    def export(self) -> bool:
        """Write the trace; False if the stretch did not end in the window."""
        if self.done is None:
            return False
        self.done.export_chrome_trace(self.path)
        return True


class SetupClock:
    """Seconds of each phase of set-up, reported on standard error."""

    def __init__(self, device):
        self.device, self.t, self.phases = device, time.perf_counter(), []

    def mark(self, name: str):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.phases.append(f"{name} {now - self.t:.2f} s")
        self.t = now

    def report(self):
        print(f"perfbench: set-up {', '.join(self.phases)}", file=sys.stderr)


def _window(seconds: float, call, trace: Trace | None) -> tuple[list[float], float]:
    """Calls `call(i)` while the window is open; returns each call's
    seconds and the window's length, from its start to the end of the last
    call started in it."""
    times = []
    t0 = time.perf_counter()
    end = t0
    i = 0
    while end - t0 < seconds:
        if trace is not None:
            trace.before(i, end - t0)
        t1 = time.perf_counter()
        with torch.autograd.profiler.record_function("perfbench.call"):
            call(i)
        end = time.perf_counter()
        times.append(end - t1)
        if trace is not None:
            trace.after_call(i)
        i += 1
    return times, end - t0


def serve(config: dict, mix: dict, seed: int, seconds: float, device, trace: Trace | None,
          keep: list[int], mark_setup, fault=None) -> dict:
    """The serving mix: returns the window's readings, the pool (host
    volumes) and the kept outputs {call index: uint8 map}. `fault(infer)`
    returns a serving program with a fault planted in it (tests)."""
    from micformer_tpu_torch.convert.aot_export import build_inference_fn

    clock = SetupClock(device)
    dtype = DTYPES[config["dtype"]]
    model = program_model(config, dtype, device, weights(config, seed, device))
    clock.mark("model")
    B, side = mix["volumes_per_call"], mix["side"]
    pool = serve_pool(config, mix, seed, device)
    clock.mark("inputs")
    roi = mix["roi"]
    infer = build_inference_fn(model, roi=(roi,) * 3, num_classes=config["kwargs"]["num_classes"],
                               overlap=mix["overlap"], sw_batch_size=mix["sw_batch_size"],
                               step_mode="monai", argmax=True)
    if fault is not None:
        infer = fault(infer)
    kept = {}
    last = {}

    def call(i):
        with torch.no_grad():
            seg = infer(torch.from_numpy(pool[i % len(pool)]).to(device))
        out = seg.cpu().numpy()
        if i in keep:
            kept[i] = out
        last["i"], last["out"] = i, out

    for i in range(mix["warmup_calls"]):
        call(-1 - i)
    clock.mark("warm-up calls")
    if trace is not None:
        Trace.warm(device)
    clock.report()
    setup_s = mark_setup()
    _reset_peak(device)
    times, window = _window(seconds, call, trace)
    peak = _peak(device)
    kept[last["i"]] = last["out"]
    n = len(times)
    return {"calls": n, "volumes": n * B, "window_s": window, "times": times,
            "volumes_per_s": n * B / window, "p95_latency_s": float(np.percentile(times, 95)),
            "peak_mem_gib": peak / GIB, "memory_peak_bytes": peak, "setup_s": setup_s,
            "attempted": n, "failed": 0, "pool": pool, "kept": kept,
            "forwards_per_call": _chunks(mix, side, B)}


def serve_pool(config: dict, mix: dict, seed: int, device) -> list:
    """The serving calls' inputs: host f32 arrays [volumes_per_call, 2,
    side³], contiguous, as serve's loader leaves a volume; call i takes
    pool[i % len(pool)], so the pool's cases are cycled."""
    B = mix["volumes_per_call"]
    images, _ = inputs.make_cases(data_generator(seed, device), mix["pool"], mix["side"],
                                  config["kwargs"]["num_classes"])
    cases = images.cpu().numpy()
    return [np.ascontiguousarray(cases[[(j * B + b) % len(cases) for b in range(B)]])
            for j in range(len(cases) // np.gcd(len(cases), B))]


def train_batches(config: dict, mix: dict, seed: int, device) -> list:
    """The training steps' batches: host (f16 images [batch, 2, side³],
    uint8 labels [batch, side³]) as the program's loader yields them, each
    case in one batch; step i takes batches[i % len(batches)]."""
    B = mix["batch"]
    images, labels = inputs.make_cases(data_generator(seed, device), mix["pool"], mix["side"],
                                       config["kwargs"]["num_classes"])
    images, labels = images.half().cpu(), labels.cpu()
    return [(images[j:j + B].contiguous(), labels[j:j + B].contiguous())
            for j in range(0, mix["pool"] - B + 1, B)]


def _chunks(mix: dict, side: int, B: int) -> list[int]:
    """The batch of each model forward of one serving call: the tiles of
    the monai placement, sw_batch_size tiles a forward, each tile holding
    the call's B volumes."""
    from perfbench.reference.common import monai_starts

    tiles = len(monai_starts(side, mix["roi"], mix["overlap"])) ** 3
    chunk = mix["sw_batch_size"]
    return [chunk * B] * -(-tiles // chunk)


def train(config: dict, mix: dict, seed: int, seconds: float, device, trace: Trace | None,
          follow: int, mark_setup, fault=None) -> dict:
    """The training mix: the step object is built once; its first `follow`
    steps (set-up) are read for the judge, then the same object runs the
    window. `fault(trainer)` plants a fault in the program (tests)."""
    from micformer_tpu_torch.train.trainer import TrainConfig, Trainer

    clock = SetupClock(device)
    model = program_model(config, torch.float32, device, weights(config, seed, device))
    clock.mark("model")
    batches = train_batches(config, mix, seed, device)
    clock.mark("inputs")
    with tempfile.TemporaryDirectory(prefix="perfbench-") as run_dir:
        cfg = TrainConfig(lr=mix["lr"], loss=mix["loss"], augment=mix["augment"],
                          bf16=mix["bf16"], optimizer=mix["optimizer"],
                          scheduler=mix["scheduler"], epochs=mix["epochs"],
                          num_classes=config["kwargs"]["num_classes"], seed=seed,
                          run_dir=os.path.join(run_dir, "run"))
        trainer = Trainer(model, cfg)
        if fault is not None:
            fault(trainer)
        names = {p: n for n, p in model.named_parameters()}
        losses, grad1 = [], {}
        for i in range(follow):
            rec = trainer.train_step(*batches[i % len(batches)])
            losses.append(rec["loss"])
            if i == 0:
                grad1 = _first_gradient(trainer, names)
        after = {n: p.detach().to("cpu", copy=True) for n, p in model.named_parameters()}
        del names
        clock.mark(f"first {follow} steps")
        if trace is not None:
            Trace.warm(device)
        clock.report()
        setup_s = mark_setup()
        _reset_peak(device)
        skipped = []

        def call(i):
            rec = trainer.train_step(*batches[(follow + i) % len(batches)])
            skipped.append(rec["skipped"])

        times, window = _window(seconds, call, trace)
        peak = _peak(device)
        del trainer, model
    n = len(times)
    return {"calls": n, "steps": n, "window_s": window, "times": times,
            "step_ms": 1e3 * window / n, "peak_mem_gib": peak / GIB, "memory_peak_bytes": peak,
            "setup_s": setup_s, "attempted": n, "failed": int(sum(skipped)),
            "batches": batches, "losses": losses, "grad1": grad1, "after": after,
            "trace_batch": mix["batch"]}


def _first_gradient(trainer, names: dict) -> dict:
    """The first step's gradient as Adam received it, from its state after
    that step: exp_avg = (1 - β1)·g."""
    out = {}
    for group in trainer.optimizer.param_groups:
        beta1 = group["betas"][0]
        for p in group["params"]:
            st = trainer.optimizer.state.get(p)
            if st and "exp_avg" in st:
                out[names[p]] = (st["exp_avg"] / (1 - beta1)).to("cpu", copy=True)
    return out


def _reset_peak(device):
    """Wait for the device, then start its peak-memory reading afresh."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)


def _peak(device) -> int:
    if device.type != "cuda":
        return 0
    torch.cuda.synchronize(device)
    return int(torch.cuda.max_memory_allocated(device))
