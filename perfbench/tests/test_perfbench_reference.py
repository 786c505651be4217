"""The plain references of perfbench/reference/ against the program's plain
path (its CPU versions of the kernels) at a tiny size, on the same seeded
state_dict: the forwards of both models, and MedNeXt's gradients."""

import json
import os

import pytest
import torch
from conftest import ROOT

from perfbench import drive
from perfbench.reference import build_reference


def _counted(config):
    """`config` with `parameters` set to its reference's count."""
    model = build_reference(config, device="meta")
    return {**config, "parameters": sum(p.numel() for p in model.parameters())}


MICFORMER = _counted(dict(name="micformer", model="micformer", reference="micformer",
                          model_class="MicFormer",
                          kwargs=dict(num_classes=8, embed_dim=12, depths=[1, 1, 2, 1],
                                      num_heads=[1, 2, 4, 8], window_size=[2, 2, 2],
                                      patch_size=[4, 4, 4])))
MEDNEXT = _counted(dict(name="mednext_s", model="mednext", reference="mednext",
                        model_class="MedNeXt",
                        kwargs=dict(num_classes=8, n_channels=4, exp_r=[2] * 9, kernel=3,
                                    block_counts=[2] * 9),
                        program_kwargs=dict(num_classes=8, size="S", kernel=3, n_channels=4)))


def _pair(config, seed):
    dev = torch.device("cpu")
    state = drive.weights(config, seed, dev)
    program = drive.program_model(config, torch.float32, dev, state)
    reference = build_reference(config, dev)
    reference.load_state_dict(state)
    return program, reference


@pytest.mark.parametrize("config", [MICFORMER, MEDNEXT], ids=["micformer", "mednext"])
def test_reference_forward_matches_the_program(config):
    program, reference = _pair(config, 11)
    x = torch.randn((2, 2, 32, 32, 32), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        got, want = program(x), reference(x)
    assert got.shape == want.shape == (2, 8, 32, 32, 32)
    # f32 on both sides: the order of sums alone differs
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


def test_reference_gradients_match_the_program():
    program, reference = _pair(MEDNEXT, 12)
    x = torch.randn((2, 2, 32, 32, 32), generator=torch.Generator().manual_seed(4))
    program.train()
    reference.train()
    program(x).square().mean().backward()
    reference(x).square().mean().backward()
    got = dict(program.named_parameters())
    scale = max(p.grad.abs().max().item() for p in reference.parameters())
    for name, p in reference.named_parameters():
        assert (got[name].grad - p.grad).abs().max().item() <= 1e-5 * scale, name


def test_the_weights_follow_the_seed():
    a = drive.weights(MEDNEXT, 2 ** 31 + 5, torch.device("cpu"))
    b = drive.weights(MEDNEXT, 2 ** 31 + 5, torch.device("cpu"))
    c = drive.weights(MEDNEXT, 2 ** 31 + 6, torch.device("cpu"))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["stem.weight"], c["stem.weight"])


@pytest.mark.parametrize("name", ["micformer", "mednext_s"])
def test_the_configs_build_at_their_stated_parameters(name):
    # the reference and the program, each built on meta from the config as
    # a run builds it, number the config's `parameters`
    with open(os.path.join(ROOT, "perfbench", "configs", f"{name}.json")) as f:
        config = json.load(f)
    reference = build_reference(config, device="meta")
    assert sum(p.numel() for p in reference.parameters()) == config["parameters"]
    state = {k: torch.empty_like(v, device="meta") for k, v in reference.state_dict().items()}
    with torch.device("meta"):
        program = drive.program_model(config, torch.float32, "meta", state)
    assert set(dict(program.named_parameters())) == set(dict(reference.named_parameters()))


def test_a_program_of_other_widths_is_refused():
    config = {**MEDNEXT, "parameters": MEDNEXT["parameters"] + 1}
    with pytest.raises(RuntimeError, match="parameters"):
        drive.program_model(config, torch.float32, torch.device("cpu"),
                            drive.weights(MEDNEXT, 1, torch.device("cpu")))
