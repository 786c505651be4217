"""The rest of the port's host side against the JAX package: the BraTS
dataset and the batch helpers of `data/image_utils.py`, the native NIfTI
reader and resizers (built with g++ at first use), `utils.count_parameters`,
the 2D-Swin -> VT-UNet inflation, and the last two ops (`inverse_stn_warp`,
`window_area_partition`)."""

import os

for _k in [k for k in os.environ if k.startswith("MICFORMER_")]:
    del os.environ[_k]

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from micformer_tpu import native as jnative  # noqa: E402
from micformer_tpu.data import brats as jbrats  # noqa: E402
from micformer_tpu.data import image_utils as jiu  # noqa: E402
from micformer_tpu.data.nifti import write_nifti  # noqa: E402
from micformer_tpu_torch import native  # noqa: E402
from micformer_tpu_torch.data import brats as tbrats  # noqa: E402
from micformer_tpu_torch.data import image_utils as tiu  # noqa: E402

from torch_port_oracle import flax_params  # noqa: E402


def _rng(seed):
    return np.random.default_rng(seed)


def _brats_root(tmp_path, n=8, shape=(20, 22, 18)):
    rng = _rng(0)
    for i in range(n):
        pid = f"BraTS2021_{i:05d}"
        d = tmp_path / pid
        d.mkdir()
        for mod in tbrats.MODALITIES:
            vol = np.abs(rng.normal(size=shape)).astype(np.float32) * 100
            vol[:2] = 0
            write_nifti(str(d / f"{pid}_{mod}.nii.gz"), vol)
        if i != 3:                      # one patient without a label
            write_nifti(str(d / f"{pid}_seg.nii.gz"),
                        rng.choice([0, 1, 2, 4], size=shape).astype(np.uint8))
    return str(tmp_path)


def _same_item(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k])
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("normalisation", ["minmax", "zscore"])
def test_brats_datasets_equal_jax(tmp_path, normalisation):
    """Train (seeded pad-or-crop), validation and test items of each
    split, item for item; the label-less patient gives zero regions."""
    root = _brats_root(tmp_path)
    kw = dict(seed=7, fold=1, target_size=(16, 16, 16), normalisation=normalisation)
    got, want = tbrats.get_brats_datasets(root, **kw), jbrats.get_brats_datasets(root, **kw)
    for t, j in zip(got, want):
        assert len(t) == len(j) > 0
        assert [p.name for p in t.patient_dirs] == [p.name for p in j.patient_dirs]
        for i in range(len(t)):
            _same_item(t[i], j[i])
    assert got[0][0]["image"].shape == (4, 16, 16, 16)
    seg = _rng(1).choice([0, 1, 2, 4], size=(5, 6, 7))
    np.testing.assert_array_equal(tbrats.BratsDataset.regions_from_label(seg),
                                  jbrats.BratsDataset.regions_from_label(seg))
    with pytest.raises(FileNotFoundError):
        tbrats.get_brats_datasets(str(tmp_path / "BraTS2021_00000" / "none"))


def test_batch_helpers_equal_jax():
    rng = _rng(2)
    one_hot = rng.normal(size=(8, 5, 6, 7))
    np.testing.assert_array_equal(tiu.one_hot_to_label(one_hot), jiu.one_hot_to_label(one_hot))
    shapes = [(17, 33, 16), (40, 2, 31), (1, 1, 1)]
    for div in (16, 8, 1):
        assert tiu.pad_batch_to_max_shape(shapes, div) == jiu.pad_batch_to_max_shape(shapes, div)
    img = np.zeros((3, 9, 10, 11), np.float32)
    img[1:, 2:5, 3:9, 4] = 1.0
    np.testing.assert_array_equal(tiu.remove_unwanted_background(img),
                                  jiu.remove_unwanted_background(img))
    a, b = rng.normal(size=(2, 20, 18, 16)), rng.normal(size=(2, 20, 18, 16))
    for fn in ("random_crop", "random_crop2d", "random_crop3d"):
        got = getattr(tiu, fn)(a, b, min_perc=0.3, max_perc=0.9, rng=_rng(5))
        want = getattr(jiu, fn)(a, b, min_perc=0.3, max_perc=0.9, rng=_rng(5))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(tiu.random_crop(a, rng=_rng(6)),
                                  jiu.random_crop(a, rng=_rng(6)))
    with pytest.raises(ValueError, match="do not match"):
        tiu.random_crop(a, b[:, 1:])
    ims = [rng.normal(size=(2, 10, 17, 5)), rng.normal(size=(2, 16, 3, 20))]
    lbs = [rng.integers(0, 3, size=im.shape) for im in ims]
    for r in (None, 9):
        got = tiu.collate_pad_batch(ims, lbs, 8, None if r is None else _rng(r))
        want = jiu.collate_pad_batch(ims, lbs, 8, None if r is None else _rng(r))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    batch = rng.normal(size=(1, 2, 10, 17, 32))
    (gp, gpads), (wp, wpads) = (tiu.pad_batch1_to_compatible_size(batch),
                                jiu.pad_batch1_to_compatible_size(batch))
    assert gpads == wpads == (6, 15, 0)
    np.testing.assert_array_equal(gp, wp)


@pytest.fixture
def built():
    """The native library, built at first use (skips where g++ cannot build it)."""
    if not native.available():
        pytest.skip(f"g++ did not build the native library: {native.BUILD_ERROR}")


def test_native_reader_and_resizers_equal_jax_native_and_python(tmp_path, built):
    """Bitwise the JAX package's native library where it is built (same
    source and flags), and the Python paths to tests/test_native.py's bars:
    reader 1e-5 (f32) and 1e-4 (int16), trilinear 1e-3, nearest exactly."""
    from micformer_tpu_torch.data.nifti import read_nifti

    rng = _rng(3)
    f32 = (rng.normal(size=(33, 47, 21)) * 50).astype(np.float32)
    i16 = (rng.normal(size=(20, 22, 24)) * 300).astype(np.int16)
    write_nifti(str(tmp_path / "f.nii.gz"), f32)
    write_nifti(str(tmp_path / "i.nii"), i16)
    for path, vol, atol in ((tmp_path / "f.nii.gz", f32, 1e-5),
                            (tmp_path / "i.nii", i16, 1e-4)):
        got = native.read_nifti_f32(str(path))
        assert got.dtype == np.float32 and got.shape == vol.shape
        np.testing.assert_allclose(got, vol.astype(np.float32), atol=atol)
        # read_nifti takes the native path for float32 reads
        np.testing.assert_array_equal(read_nifti(str(path), dtype=np.float32), got)
        if jnative.available():
            np.testing.assert_array_equal(got, jnative.read_nifti_f32(str(path)))
    assert native.read_nifti_f32(str(tmp_path / "missing.nii.gz")) is None
    vol = rng.normal(size=(30, 40, 25)).astype(np.float32)
    for shape in ((64, 64, 64), (16, 16, 16), (30, 40, 25), (7, 41, 3)):
        tri = native.resize_trilinear_f32(vol, shape)
        near = native.resize_nearest_f32(vol, shape)
        np.testing.assert_allclose(tri, tiu._resize_trilinear_py(vol, shape), atol=1e-3)
        np.testing.assert_array_equal(near, tiu.resize_nearest(vol, shape))
        np.testing.assert_array_equal(tiu.resize_trilinear(vol, shape),
                                      tri if shape != vol.shape else vol)
        if jnative.available():
            np.testing.assert_array_equal(tri, jnative.resize_trilinear_f32(vol, shape))
            np.testing.assert_array_equal(near, jnative.resize_nearest_f32(vol, shape))


def test_native_build_failure_is_kept_and_printed_once(tmp_path, monkeypatch, capfd):
    """A compiler that fails: BUILD_ERROR keeps its message, stderr shows it
    once, and the readers take the Python path."""
    from micformer_tpu_torch.data.nifti import read_nifti

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_ERROR", None)
    monkeypatch.setattr(native._build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setenv("CXX", "false")
    vol = _rng(4).normal(size=(6, 7, 8)).astype(np.float32)
    write_nifti(str(tmp_path / "v.nii.gz"), vol)
    assert not native.available()
    assert "false failed" in native.BUILD_ERROR
    np.testing.assert_array_equal(read_nifti(str(tmp_path / "v.nii.gz"), dtype=np.float32), vol)
    np.testing.assert_allclose(tiu.resize_trilinear(vol, (12, 7, 4)),
                               tiu._resize_trilinear_py(vol, (12, 7, 4)))
    assert native.resize_nearest_f32(vol, (3, 3, 3)) is None
    err = capfd.readouterr().err
    assert err.count("native reader is not available") == 1


def test_count_parameters_equals_jax():
    from micformer_tpu.utils import count_parameters as jcount
    from micformer_tpu_torch import registry
    from micformer_tpu_torch.utils import count_parameters

    model = registry.build("micformer", device="cpu", embed_dim=12, depths=[1, 1],
                           num_heads=[3, 6])
    n = count_parameters(model)
    assert n == count_parameters(model.state_dict()) == count_parameters(model.parameters())
    assert n == jcount({k: v.numpy() for k, v in model.state_dict().items()})
    assert n == sum(p.numel() for p in model.parameters())


# the 2D-Swin inflation: tests/test_swin2d_inflation.py's fake checkpoint
DEPTHS, HEADS, E, WIN = (2, 2, 2, 1), (3, 6, 12, 24), 24, (3, 3, 3)


def _fake_swin2d_state_dict(rng):
    sd = {"patch_embed.proj.weight": rng.normal(size=(E, 3, 4, 4)),
          "patch_embed.proj.bias": rng.normal(size=(E,)),
          "patch_embed.norm.weight": rng.normal(size=(E,)),
          "patch_embed.norm.bias": rng.normal(size=(E,)),
          "norm.weight": rng.normal(size=(E * 8,)), "norm.bias": rng.normal(size=(E * 8,))}
    for i, depth in enumerate(DEPTHS):
        C = E * 2 ** i
        for b in range(depth):
            p = f"layers.{i}.blocks.{b}"
            for name, shape in (("norm1.weight", (C,)), ("norm1.bias", (C,)),
                                ("norm2.weight", (C,)), ("norm2.bias", (C,)),
                                ("attn.qkv.weight", (3 * C, C)), ("attn.qkv.bias", (3 * C,)),
                                ("attn.proj.weight", (C, C)), ("attn.proj.bias", (C,)),
                                ("attn.relative_position_bias_table", (25, HEADS[i])),
                                ("mlp.fc1.weight", (4 * C, C)), ("mlp.fc1.bias", (4 * C,)),
                                ("mlp.fc2.weight", (C, 4 * C)), ("mlp.fc2.bias", (C,))):
                sd[f"{p}.{name}"] = rng.normal(size=shape)
    return {k: v.astype(np.float32) for k, v in sd.items()}


@pytest.mark.parametrize("case", ["fitting", "mismatched", "unfactored_table"])
def test_swin2d_inflation_equals_jax(case):
    """JAX's vtunet_params_from_swin2d into a numpy-drawn params skeleton
    (jax.eval_shape), converted with from_flax, equals the port's own
    inflation of the same skeleton tensor for tensor, and the reports
    agree name for name."""
    from micformer_tpu.convert import torch_import as jti
    from micformer_tpu.models.vtunet import VTUNet
    from micformer_tpu_torch import registry
    from micformer_tpu_torch.convert import swin2d
    from micformer_tpu_torch.convert.from_flax import flax_names, state_dict_from_flax

    kw = dict(num_classes=4, embed_dim=E, depths=DEPTHS, num_heads=HEADS, window_size=WIN)
    params = flax_params(VTUNet(**kw), np.zeros((1, 2, 32, 32, 32), np.float32))
    model = registry.build("vtunet", device="cpu", **kw)
    sd = _fake_swin2d_state_dict(_rng(1))
    if case == "mismatched":
        sd["layers.0.blocks.0.attn.qkv.weight"] = np.zeros((10, 10), np.float32)
        sd["patch_embed.norm.weight"] = np.zeros((E + 1,), np.float32)
    elif case == "unfactored_table":
        sd["layers.2.blocks.1.attn.relative_position_bias_table"] = np.zeros((169, 12),
                                                                            np.float32)
    jnew, jrep = jti.vtunet_params_from_swin2d(sd, params, depths=DEPTHS, window_size=WIN)
    tnew, trep = swin2d.vtunet_params_from_swin2d(
        sd, state_dict_from_flax(params, model), depths=DEPTHS, window_size=WIN)
    want = state_dict_from_flax(jnew, model)
    assert tnew.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(tnew[k], want[k], rtol=0, atol=0, msg=k)
    to_torch = {path: name for name, path in flax_names(params, model).items()}

    def named(entry):
        path = entry.split(":")[0]
        return to_torch.get(path, path.replace("/rel_pos_bias_table", ".attn.rel_pos_bias_table"))

    assert trep["loaded"] == [to_torch[p] for p in jrep["loaded"]]
    assert [named(s) for s in trep["skipped"]] == [named(s) for s in jrep["skipped"]]
    assert trep["missing"] == jrep["missing"] == []
    assert len(trep["loaded"]) > 40 and bool(trep["skipped"]) == (case != "fitting")
    model.load_state_dict(tnew)
    with torch.no_grad():
        out = model(torch.zeros(1, 2, 32, 32, 32))
    assert out.shape == (1, 4, 32, 32, 32) and torch.isfinite(out).all()


def test_inflation_helpers_equal_jax():
    from micformer_tpu.convert import torch_import as jti
    from micformer_tpu_torch.convert import swin2d

    w2d = _rng(0).normal(size=(6, 3, 4, 4)).astype(np.float32)
    got = swin2d.inflate_patch_embed_2d_to_3d(w2d, kd=4, in_channels=2)
    assert got.shape == (6, 2, 4, 4, 4)
    np.testing.assert_array_equal(
        got, jti.inflate_patch_embed_2d_to_3d(w2d, 4, 2).transpose(4, 3, 0, 1, 2))
    t2d = _rng(1).normal(size=(25, 2)).astype(np.float32)
    np.testing.assert_array_equal(swin2d.inflate_rel_pos_table_2d_to_3d(t2d, (3, 3, 3)),
                                  jti.inflate_rel_pos_table_2d_to_3d(t2d, (3, 3, 3)))
    assert swin2d.inflate_rel_pos_table_2d_to_3d(np.zeros((169, 2)), (3, 3, 3)) is None


@pytest.mark.parametrize("shape", [(1, 6, 5, 7, 3), (2, 4, 4, 4, 2)])
def test_inverse_stn_warp_equals_jax(shape):
    from micformer_tpu.ops.warp import inverse_stn_warp as jwarp
    from micformer_tpu_torch.ops.warp import inverse_stn_warp

    rng = _rng(2)
    src = rng.normal(size=shape).astype(np.float32)
    flow = (rng.normal(size=(shape[0], 3, *shape[1:4])) * 1.5).astype(np.float32)
    want = np.asarray(jax.jit(jwarp)(jnp.asarray(src), jnp.asarray(flow)))
    got = inverse_stn_warp(torch.from_numpy(src), torch.from_numpy(flow))
    assert got.shape == src.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("shape,window", [((1, 4, 6, 8, 3), (2, 2, 2)),
                                          ((2, 6, 4, 6, 5), (3, 2, 3))])
def test_window_area_partition_equals_jax(shape, window):
    from micformer_tpu.ops.windows import window_area_partition as jpart
    from micformer_tpu_torch.ops.windows import window_area_partition

    x = _rng(3).normal(size=shape).astype(np.float32)
    want = np.asarray(jpart(jnp.asarray(x), window))
    got = window_area_partition(torch.from_numpy(x), window)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
