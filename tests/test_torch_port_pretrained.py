"""`pretrained` seeding against the JAX package on the CPU.

The same source and destination weights (seeded values in the JAX models'
parameter trees, converted with `state_dict_from_flax`) go through the JAX rule (`load_pretrained_params`
on the flax trees) and the port's (`load_pretrained_state` on the
state_dicts): the loaded, skipped and missing sets and the resulting
tensors are identical. As in JAX, MicFormer's `out_conv` is held back while
MedNeXt's heads (`out`, `ds1`-`ds4`), whose names hold no marker, transfer
when their shapes match. Then the trainer: a `fit` seeded from another port
run logs the counts, and a live resume wins over `pretrained`.

The JAX package reads its MICFORMER_* flags at import; they are cleared here
first, so it runs its default forms.
"""

import os

for _k in [k for k in os.environ if k.startswith("MICFORMER_")]:
    del os.environ[_k]

import json  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
import torch.nn as nn  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from micformer_tpu import registry as jreg  # noqa: E402
from micformer_tpu.convert.torch_import import load_pretrained_params  # noqa: E402
from micformer_tpu.models import mednext as jm  # noqa: E402
from micformer_tpu_torch import registry as treg  # noqa: E402
from micformer_tpu_torch.convert import from_flax  # noqa: E402
from micformer_tpu_torch.convert.from_flax import state_dict_from_flax  # noqa: E402
from micformer_tpu_torch.convert.pretrained import load_pretrained_state  # noqa: E402
from micformer_tpu_torch.models import mednext as tm  # noqa: E402
from micformer_tpu_torch.train.trainer import TrainConfig, Trainer  # noqa: E402

TINY = dict(embed_dim=12, depths=(1, 1), num_heads=(3, 6), drop_path_rate=0.0)
SMALL = dict(n_channels=4, block_counts=(1,) * 9, deep_supervision=True)


def _flax_names(params: dict, model: nn.Module) -> dict:
    """{flax path "a/b/leaf": the port's parameter name}, by
    `state_dict_from_flax`'s own walk (its renames and leaf rules)."""
    out = {}

    def walk(mod, tree, prefix, path):
        renames = from_flax._RENAMES.get(type(mod).__name__, {})
        for key, val in tree.items():
            if isinstance(val, dict):
                name = renames.get(key, key)
                walk(getattr(mod, name), val, f"{prefix}{name}.", path + (key,))
            else:
                leaf, _ = from_flax._convert_leaf(mod, key, np.asarray(val), key)
                out["/".join(path + (key,))] = f"{prefix}{leaf}"

    walk(model, params, "", ())
    return out


def _inits(family, num_classes, seeds):
    """[(flax params, port model holding them)]: the tree of the JAX model's
    init (abstract, `jax.eval_shape`: nothing compiles) filled with seeded
    normal values, one tree a seed."""
    if family == "micformer":
        jmodel = jreg.build("micformer", num_classes=num_classes, **TINY)
    else:
        jmodel = jm.MedNeXt(num_classes=num_classes, **SMALL)
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0),
                            jnp.zeros((1, 2, 16, 16, 16)))["params"]
    out = []
    for seed in seeds:
        rng = np.random.default_rng(seed)
        params = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), shapes)
        if family == "micformer":
            tmodel = treg.build("micformer", device="cpu", num_classes=num_classes, **TINY)
        else:
            tmodel = tm.MedNeXt(num_classes=num_classes, **SMALL)
        tmodel.load_state_dict(state_dict_from_flax(params, tmodel))
        out.append((params, tmodel))
    return out


# (family, destination classes): MicFormer's head is held back by its marker
# whatever the shapes; MedNeXt's transfers at 8 classes and is skipped for
# its shape at 4
CASES = [("micformer", 8), ("mednext", 8), ("mednext", 4)]


@pytest.fixture(scope="module")
def inits():
    """{family: the 8-class source}, {(family, classes): the destination}."""
    src, dst = {}, {}
    for fam in ("micformer", "mednext"):
        src[fam], dst[fam, 8] = _inits(fam, 8, (0, 1))
    (dst["mednext", 4],) = _inits("mednext", 4, (2,))
    return src, dst


def _names(entries):
    return {e.split(":")[0] for e in entries}


@pytest.mark.parametrize("fam, dst_classes", CASES, ids=[f"{f}-{n}" for f, n in CASES])
def test_pretrained_selection_matches_jax(inits, fam, dst_classes):
    src_params, src_model = inits[0][fam]
    dst_params, dst_model = inits[1][fam, dst_classes]
    jparams, jreport = load_pretrained_params(dst_params, src_params)
    state, report = load_pretrained_state(dst_model.state_dict(), src_model.state_dict())
    names = _flax_names(dst_params, dst_model)
    assert set(names.values()) == set(state)
    for key in ("loaded", "skipped", "missing"):
        assert _names(report[key]) == {names[p] for p in _names(jreport[key])}, key
    assert not report["missing"]
    want = state_dict_from_flax(jparams, dst_model)
    for k, v in state.items():
        assert torch.equal(v, want[k]), k
    heads = {"micformer": {"out_conv.weight", "out_conv.bias"},
             "mednext": {f"{h}.{p}" for h in ("out", "ds1", "ds2", "ds3", "ds4")
                         for p in ("weight", "bias")}}[fam]
    if fam == "micformer":
        # held back by its marker whatever the shapes
        assert _names(report["skipped"]) == heads
        assert all(e.endswith("head (not transferred)") for e in report["skipped"])
    elif dst_classes == 8:
        # the JAX rule's markers miss MedNeXt's heads: they transfer
        assert heads <= set(report["loaded"]) and not report["skipped"]
    else:
        assert _names(report["skipped"]) == heads
        assert all("ckpt" in e for e in report["skipped"])
    for k in report["loaded"]:
        assert torch.equal(state[k], src_model.state_dict()[k])


def _tiny_trainer(run_dir, seed, **cfg):
    model = treg.build("micformer", device="cpu", generator=torch.Generator().manual_seed(seed),
                       **dict(TINY, embed_dim=6))
    return Trainer(model, TrainConfig(run_dir=str(run_dir), epochs=1, augment="none",
                                      steps_per_epoch=1, **cfg))


def _loader():
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.uniform(0, 1, (1, 2, 16, 16, 16)).astype(np.float16))
    lab = torch.from_numpy(rng.integers(0, 8, (1, 16, 16, 16)).astype(np.uint8))
    return [(img, lab, {})]


def test_fit_seeded_from_a_port_run_logs_the_counts(tmp_path, capsys):
    src = _tiny_trainer(tmp_path / "src", seed=1)
    src.ckpt.save("best_dice", src._payload(0, 0.5, 0.5), metric=0.5)
    src.ckpt.save("latest", {"params": {k: v + 1 for k, v in src.model.state_dict().items()}})
    dst = _tiny_trainer(tmp_path / "dst", seed=2, pretrained=str(tmp_path / "src"), lr=0.0)
    before = {k: v.clone() for k, v in dst.model.state_dict().items()}
    dst.fit(_loader())
    n = len(before)
    log = [json.loads(line) for line in (tmp_path / "dst" / "log.jsonl").read_text().splitlines()]
    assert {"pretrained": {"loaded": n - 2, "skipped": 2, "missing": 0}} in log
    assert f"{n - 2} tensors loaded, 2 skipped, 0 missing" in capsys.readouterr().out
    # lr 0: the step leaves the weights; the default tag is best_dice
    for k, v in dst.model.state_dict().items():
        want = before[k] if k.startswith("out_conv.") else src.model.state_dict()[k]
        assert torch.equal(v, want), k
    # "run_dir:tag" reads another tag
    report = dst.load_pretrained(f"{tmp_path / 'src'}:latest")
    assert len(report["loaded"]) == n - 2
    assert torch.equal(dst.model.state_dict()["patch_embed.proj.weight"],
                       src.model.state_dict()["patch_embed.proj.weight"] + 1)


def test_live_resume_wins_over_pretrained(tmp_path):
    src = _tiny_trainer(tmp_path / "src", seed=1)
    src.ckpt.save("best_dice", src._payload(0, 0.5, 0.5), metric=0.5)
    own = _tiny_trainer(tmp_path / "dst", seed=3)
    own.ckpt.save("latest", own._payload(0, 0.25, 0.5))
    dst = _tiny_trainer(tmp_path / "dst", seed=2, pretrained=str(tmp_path / "src"))
    dst.fit(_loader(), resume=True)      # epoch 0 is done: nothing left to train
    assert dst.history == []
    for k, v in dst.model.state_dict().items():
        assert torch.equal(v, own.model.state_dict()[k]), k
    log = (tmp_path / "dst" / "log.jsonl").read_text()
    assert '"pretrained"' in log
