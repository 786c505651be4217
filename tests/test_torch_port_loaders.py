"""The port's loaders of the reference's own PyTorch models
(`convert/torch_import.load_reference_micformer`, the six
`convert/zoo_import.load_reference_*` and `load_reference_vtunet_module`)
against the JAX package's copies of them.

The stand-ins for packages the reference imports and this environment lacks
install into `sys.modules` and return early when a module of that name is
there, so each side's are installed with the other's out of the way and
removed after: timm's DropPath (eval, and training with the global
generator seeded alike), to_2tuple, to_3tuple and trunc_normal_, and
positional_encodings' PositionalEncodingPermute3D equal JAX's exactly. With
no reference tree each loader raises the exception JAX's raises (each side
in a fresh process). A stub tree under tmp_path goes through the synthetic
packages, the module loader and the stand-ins. Last, the port-loader
variants of the reference-model tests (`test_torch_parity.py`,
`test_torch_port_reference_import.py`), which skip without the reference's
code, as those do.
"""

import contextlib
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from micformer_tpu.convert import zoo_import as jzi
from micformer_tpu_torch import registry as treg
from micformer_tpu_torch.convert import torch_import as tti
from micformer_tpu_torch.convert import zoo_import as tzi

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOADERS = ("load_reference_mednext", "load_reference_transbts", "load_reference_nnformer",
           "load_reference_swinunet3d", "load_reference_transunet", "load_reference_vtunet",
           "load_reference_vtunet_module")
# what the loaders put into sys.modules: stand-ins and synthetic packages
INSTALLED = ("timm", "positional_encodings", "mmcv", "_ref_", "nnunet_mednext", "models",
             "utils")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ours(name):
    return name.split(".")[0] in INSTALLED or name.startswith("_ref_")


@contextlib.contextmanager
def _isolated():
    """No stand-in or synthetic package is visible inside; those installed
    inside are removed after, and those there before put back."""
    saved = {k: sys.modules.pop(k) for k in [k for k in sys.modules if _ours(k)]}
    try:
        yield
    finally:
        for k in [k for k in sys.modules if _ours(k)]:
            del sys.modules[k]
        sys.modules.update(saved)


def _shims(side):
    """(timm.models.layers, positional_encodings.torch_encodings) as `side`
    installs them."""
    with _isolated():
        if side == "jax":
            jzi._extend_timm_shim()
            jzi._install_positional_encodings_shim()
        else:
            tzi._extend_timm_shim()
            tzi._install_positional_encodings_shim()
        return (sys.modules["timm.models.layers"],
                sys.modules["positional_encodings.torch_encodings"])


@pytest.fixture(scope="module")
def shims():
    return {side: _shims(side) for side in ("jax", "port")}


def test_droppath_shim_equals_jax(shims):
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(6, 3, 4)).astype(np.float32))
    out = {}
    for side, (layers, _) in shims.items():
        dp = layers.DropPath(0.4)
        assert torch.equal(dp.eval()(x), x)
        dp.train()
        torch.manual_seed(3)
        out[side] = dp(x)
        assert torch.equal(layers.DropPath(0.0).train()(x), x)
    assert torch.equal(out["port"], out["jax"])
    assert not torch.equal(out["port"], x)


def test_tuple_and_trunc_normal_shims_equal_jax(shims):
    (jl, _), (tl, _) = shims["jax"], shims["port"]
    for v in (3, (1, 2, 3), [4, 5]):
        assert tl.to_3tuple(v) == jl.to_3tuple(v) and tl.to_2tuple(v) == jl.to_2tuple(v)
    got, want = torch.empty(20000), torch.empty(20000)
    torch.manual_seed(5)
    assert tl.trunc_normal_(got, mean=0.1, std=0.02) is got
    torch.manual_seed(5)
    jl.trunc_normal_(want, mean=0.1, std=0.02)
    assert torch.equal(got, want)
    stats = [(t.mean().item(), t.std().item(), t.min().item(), t.max().item())
             for t in (got, want)]
    assert stats[0] == stats[1]


@pytest.mark.parametrize("shape", [(1, 12, 4, 5, 6), (2, 7, 3, 3, 2)])
def test_positional_encodings_shim_equals_jax(shims, shape):
    x = torch.from_numpy(np.random.default_rng(1).normal(size=shape).astype(np.float32))
    got = shims["port"][1].PositionalEncodingPermute3D(shape[1])(x)
    want = shims["jax"][1].PositionalEncodingPermute3D(shape[1])(x)
    assert got.shape == x.shape
    assert torch.equal(got, want)


MISSING = """
import json, sys, importlib
mod = importlib.import_module(sys.argv[1])
root = sys.argv[2]
ours = ("timm", "positional_encodings", "mmcv", "nnunet_mednext", "models", "utils")
before = set(sys.modules)
out = {}
for name in json.loads(sys.argv[3]):
    fn = getattr(mod, name, None) or getattr(
        importlib.import_module(sys.argv[1].replace("zoo_import", "torch_import")), name)
    try:
        fn(root)
        out[name] = None
    except Exception as e:
        out[name] = type(e).__name__
    for k in set(sys.modules) - before:      # each loader as in a fresh process
        if k.split(".")[0] in ours or k.startswith("_ref_"):
            del sys.modules[k]
print(json.dumps(out))
"""


def test_missing_reference_root_raises_as_jax(tmp_path):
    """Each loader on a reference_root that does not exist, the modules a
    loader left removed before the next: the exception type of JAX's loader
    (FileNotFoundError from the module loader, ModuleNotFoundError from
    TransUNet's package import)."""
    names = json.dumps(list(LOADERS) + ["load_reference_micformer"])
    got = {}
    for side, pkg in (("jax", "micformer_tpu"), ("port", "micformer_tpu_torch")):
        res = subprocess.run([sys.executable, "-c", MISSING, f"{pkg}.convert.zoo_import",
                              str(tmp_path / "absent"), names], cwd=REPO, capture_output=True,
                             text=True, timeout=300, env=dict(os.environ, OMP_NUM_THREADS="1"))
        assert res.returncode == 0, res.stderr[-3000:]
        got[side] = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["port"] == got["jax"]
    assert set(got["port"].values()) == {"FileNotFoundError", "ModuleNotFoundError"}


# a stub reference tree: each family's files at the loaders' paths, importing
# what the reference's do (relative, through synthetic packages, the stand-ins)
_RECORD = """
import torch.nn as nn

class _Recorded(nn.Module):
    def __init__(self, *args, **kwargs):
        super().__init__()
        self.args, self.kwargs = args, kwargs
        self.bn = nn.BatchNorm3d(2)
"""
STUBS = {
    "MicFormer/models/STN.py": "import torch.nn as nn\nclass SpatialTransformer(nn.Module):\n"
                               "    pass\n",
    "MicFormer/models/MICFormer_self.py": _RECORD + "from .STN import SpatialTransformer\n"
                                          "from timm.models.layers import DropPath\n"
                                          "class Head(_Recorded):\n    pass\n",
    "MedNeXt/nnunet_mednext/network_architecture/mednextv1/blocks.py": "X = 1\n",
    "MedNeXt/nnunet_mednext/network_architecture/mednextv1/MedNextV1.py":
        _RECORD + "from nnunet_mednext.network_architecture.mednextv1.blocks import X\n"
                  "class MedNeXt(_Recorded):\n    outside_block_checkpointing = True\n",
    "MedNeXt/nnunet_mednext/network_architecture/mednextv1/create_mednext_v1.py":
        "from nnunet_mednext.network_architecture.mednextv1.MedNextV1 import MedNeXt\n"
        "def create_mednext_v1(*args):\n    return MedNeXt(*args)\n",
    **{f"TransBTS/TransBTS/{m}.py": "" for m in ("IntmdSequential", "PositionalEncoding",
                                                 "Unet_skipconnection", "Transformer")},
    "TransBTS/TransBTS/TransBTS.py":
        _RECORD + "import types, torch\n"
                  "class BTS(_Recorded):\n"
                  "    def __init__(self, **kw):\n"
                  "        super().__init__(**kw)\n"
                  "        self.position_encoding = nn.Module()\n"
                  "        self.position_encoding.position_embeddings = nn.Parameter(\n"
                  "            torch.zeros(1, 4096, kw['embedding_dim']))\n"
                  "        self.Unet = types.SimpleNamespace(\n"
                  "            InitConv=types.SimpleNamespace(dropout=0.2))\n",
    "nnFormer/nnformer/nnFormer_tumor.py":
        "from .neural_network import SegmentationNetwork\n"
        "from .initialization import InitWeights_He\n"
        "from timm.models.layers import to_3tuple, trunc_normal_\n"
        "class nnFormer(SegmentationNetwork):\n"
        "    def __init__(self, **kw):\n        super().__init__()\n        self.kwargs = kw\n"
        "        self.init = InitWeights_He()\n",
    "SwinUnet/SwinUnet_3DV1/SwinUnet_3D.py":
        _RECORD + "from timm.models.layers import DropPath, to_2tuple\n"
                  "class SwinUnet3D(_Recorded):\n    pass\n",
    "TransUnet/utils/helpers.py": "SCALE = 2\n",
    "TransUnet/models/segmentation/trans_unet.py":
        _RECORD + "from positional_encodings.torch_encodings import "
                  "PositionalEncodingPermute3D\nfrom utils.helpers import SCALE\n"
                  "class TransUNet(_Recorded):\n    pass\n",
    "VT-Unet/vtunet/vt_unet.py":
        _RECORD + "from mmcv.runner import load_checkpoint\n"
                  "from timm.models.layers import to_3tuple\n"
                  "class SwinTransformerSys3D(_Recorded):\n    pass\n",
}


def _stub_tree(root):
    for rel, text in STUBS.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(text))
    return str(root)


def _batch_stats(model):
    return (not model.bn.track_running_stats and model.bn.running_mean is None
            and model.bn.running_var is None)


def test_loaders_build_from_a_stub_reference_tree(tmp_path):
    """Each loader imports its stub modules under the synthetic packages (a
    relative import, absolute imports through `nnunet_mednext`, `models`
    and `utils`), with the stand-ins, builds the model with the JAX loader's
    arguments and returns it in eval mode, its quirks neutralised."""
    root = _stub_tree(tmp_path / "reference")
    with _isolated():
        head = tti.load_reference_micformer(root, embed_dim=24)
        assert not head.training and head.kwargs == dict(
            n_channels=1, embed_dim=24, num_classes=8, window_size=(2, 2, 2))
        assert sys.modules["_ref_micformer_models.MICFormer_self"].SpatialTransformer is \
            sys.modules["_ref_micformer_models.STN"].SpatialTransformer

        mednext = tzi.load_reference_mednext(root, deep_supervision=True)
        assert not mednext.training and mednext.args == (2, 8, "S", 3, True)
        assert mednext.outside_block_checkpointing is False

        torch.manual_seed(0)
        bts = tzi.load_reference_transbts(root, img_dim=16, embedding_dim=8)
        assert not bts.training and _batch_stats(bts) and bts.Unet.InitConv.dropout == 0.0
        assert bts.position_encoding.position_embeddings.shape == (1, 8, 8)
        assert bts.kwargs["hidden_dim"] == 4096 and bts.kwargs["dropout_rate"] == 0.0

        nnf = tzi.load_reference_nnformer(root, crop_size=(32, 32, 32))
        assert not nnf.training and nnf.kwargs["crop_size"] == [32, 32, 32]
        assert nnf.kwargs["window_size"] == [4, 4, 8, 4] and nnf.init(nnf) is nnf

        swin = tzi.load_reference_swinunet3d(root, window_size=2)
        assert not swin.training and swin.kwargs["window_size"] == 2
        assert swin.kwargs["downscaling_factors"] == (4, 2, 2, 2)

        tu = tzi.load_reference_transunet(root, num_channels_list=(8, 16))
        assert not tu.training and _batch_stats(tu)
        assert tu.kwargs["num_channels_list"] == [8, 16]

        vt = tzi.load_reference_vtunet(root, embed_dim=24)
        assert not vt.training and vt.kwargs["embed_dim"] == 24
        assert vt.kwargs["depths_decoder"] == [1, 2, 2, 2]
        assert tzi.load_reference_vtunet_module(root) is sys.modules["_ref_vtunet"]


def test_a_failed_module_load_is_not_kept(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("raise RuntimeError('broken reference module')\n")
    with _isolated():
        with pytest.raises(RuntimeError, match="broken reference module"):
            tti._load_module("_ref_bad", str(bad))
        assert "_ref_bad" not in sys.modules


# -- the port's loaders on the reference's own code, where it is present --------

def _reference_code(*parts):
    path = os.path.join(tti.REFERENCE, *parts)
    if not os.path.isdir(path):
        pytest.skip(f"the reference's code is not at {path}")


def _outputs(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


# family -> (reference dirs, port loader and its arguments, port importer, port
# build kwargs, input shape, tolerance, table scale, seed): the configurations
# of test_torch_parity.py and test_torch_port_reference_import.py
REFERENCE_MODELS = {
    "micformer": (("MicFormer", "models"), tti.load_reference_micformer,
                  dict(embed_dim=24, num_classes=8), tti.micformer_state_from_torch,
                  dict(name="micformer", embed_dim=24), (1, 2, 64, 64, 64), 5e-4, 1.0, 0),
    "mednext": (("MedNeXt",), tzi.load_reference_mednext,
                dict(size="S", in_channels=2, num_classes=8), tzi.mednext_state_from_torch,
                dict(name="mednext", faithful_up=True), (1, 2, 32, 32, 32), 5e-4, 1.0, 0),
    "mednext_deep_supervision": (
        ("MedNeXt",), tzi.load_reference_mednext,
        dict(size="S", in_channels=2, num_classes=8, deep_supervision=True),
        tzi.mednext_state_from_torch,
        dict(name="mednext", faithful_up=True, deep_supervision=True), (1, 2, 32, 32, 32),
        5e-4, 1.0, 0),
    "transbts": (("TransBTS",), tzi.load_reference_transbts,
                 dict(img_dim=32, num_channels=2, num_classes=8), tzi.transbts_state_from_torch,
                 dict(name="transbts", input_size=32), (1, 2, 32, 32, 32), 5e-4, 1.0, 2),
    "nnformer": (("nnFormer",), tzi.load_reference_nnformer,
                 dict(crop_size=(64, 64, 64), in_channels=2, num_classes=8),
                 tzi.nnformer_state_from_torch, dict(name="nnformer", input_size=64),
                 (1, 2, 64, 64, 64), 5e-4, 20.0, 3),
    "nnformer_deep_supervision": (
        ("nnFormer",), tzi.load_reference_nnformer,
        dict(crop_size=(32, 32, 32), in_channels=2, num_classes=8, deep_supervision=True),
        tzi.nnformer_state_from_torch,
        dict(name="nnformer", input_size=32, deep_supervision=True), (1, 2, 32, 32, 32),
        5e-4, 1.0, 4),
    "swinunet3d": (("SwinUnet",), tzi.load_reference_swinunet3d,
                   dict(window_size=2, in_channels=2, num_classes=8),
                   tzi.swinunet3d_state_from_torch,
                   dict(name="swinunet3d", window_size=2, faithful_scramble=True),
                   (1, 2, 64, 64, 64), 5e-4, 1.0, 5),
    "transunet": (("TransUnet",), tzi.load_reference_transunet,
                  dict(input_shape=(2, 32, 32, 32), num_classes=8,
                       num_channels_list=(8, 16, 32, 64)),
                  tzi.transunet_state_from_torch,
                  dict(name="transunet", num_channels_list=(8, 16, 32, 64), input_size=32),
                  (1, 2, 32, 32, 32), 5e-4, 1.0, 6),
    "vtunet": (("VT-Unet",), tzi.load_reference_vtunet,
               dict(img_size=(128, 64, 64), in_chans=2, num_classes=8, embed_dim=48),
               tzi.vtunet_state_from_torch,
               dict(name="vtunet", embed_dim=48, faithful_2d_merge=True),
               (1, 2, 128, 64, 64), 1e-4, 20.0, 3),
}


@pytest.mark.parametrize("family", list(REFERENCE_MODELS))
def test_port_loader_reference_model_imported_into_the_port(family):
    """The port's loader builds the reference's model, the port's importer
    moves its weights into the port's model, and the two forwards agree (the
    bars of the JAX transplant tests)."""
    dirs, loader, kwargs, importer, build, shape, tol, scale, seed = REFERENCE_MODELS[family]
    _reference_code(*dirs)
    torch.manual_seed(seed)
    with _isolated():
        ref = loader(tti.REFERENCE, **kwargs)
    if scale != 1.0:
        with torch.no_grad():
            for name, p in ref.named_parameters():
                if "relative_position_bias_table" in name:
                    p.mul_(scale)
    build = dict(build)
    model = treg.build(build.pop("name"), device="cpu", num_classes=8, **build)
    state, _ = importer(ref.state_dict(), model)
    model.load_state_dict(state)
    x = torch.from_numpy(np.random.default_rng(seed).normal(size=shape).astype(np.float32))
    with torch.no_grad():
        got, want = _outputs(model(x)), _outputs(ref(x))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert (g - w).abs().max().item() < tol
