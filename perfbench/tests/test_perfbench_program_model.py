"""`drive.program_model` on models that hold buffers: the rel-pos
transformers of the zoo get the buffers their constructors compute, on the
device, and run as a whole CPU build does; a buffer the reference cannot
supply is refused by name; models without buffers are built once, as
before."""

import pytest
import torch
import torch.nn as nn
from test_perfbench_reference import MEDNEXT, MICFORMER

from perfbench import drive
from perfbench.reference.common import make_state

# small widths of the zoo's rel-pos models, each run at [1, 2, 32³]; the
# model is built for that input where its tables follow the input
BIASED = {
    "swinunetr": dict(num_classes=3, feature_size=6, depths=[2, 2, 2, 2],
                      num_heads=[1, 2, 3, 6], input_size=32),
    "nnformer": dict(num_classes=3, embed_dim=8, depths=[1, 1, 1, 1],
                     num_heads=[1, 2, 4, 8], input_size=32),
    "vtunet": dict(num_classes=3, embed_dim=12, num_heads=[1, 2, 3, 4],
                   window_size=[2, 2, 2]),
}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(model, kwargs):
    """A configuration of `model`, its `parameters` counted on a meta build
    of the program, with a state drawn over the program's own parameters."""
    from micformer_tpu_torch import registry

    with torch.device("meta"):
        meta = registry.build(model, device="meta", **kwargs)
    config = dict(name=model, model=model, kwargs=kwargs,
                  parameters=sum(p.numel() for p in meta.parameters()))
    return config, make_state(meta, torch.Generator().manual_seed(7), "cpu")


@pytest.mark.parametrize("model", sorted(BIASED))
def test_buffers_and_forward_match_a_whole_cpu_build(model):
    from micformer_tpu_torch import registry

    config, state = _config(model, BIASED[model])
    program = drive.program_model(config, torch.float32, torch.device("cpu"), state)
    whole = registry.build(model, device="cpu", **BIASED[model])
    whole.load_state_dict(state)
    got, want = dict(program.named_buffers()), dict(whole.named_buffers())
    assert "rel_pos_index" in " ".join(got)
    assert set(got) == set(want)
    for name, buf in want.items():
        assert got[name].device.type == "cpu" and got[name].dtype == buf.dtype, name
        assert torch.equal(got[name], buf), name
    x = torch.randn((1, 2, 32, 32, 32), generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        # the same code, weights, indices and input on one thread
        assert torch.equal(program(x), whole(x))


class _Persistent(nn.Module):
    def __init__(self):
        super().__init__()
        self.lin = nn.Linear(4, 4)
        self.register_buffer("running_scale", torch.ones(4))


class _ComputedOnMeta(nn.Module):
    def __init__(self):
        super().__init__()
        self.lin = nn.Linear(4, 4)
        # made by a factory call, so under the meta device it holds no values
        self.register_buffer("positions", torch.arange(4), persistent=False)


@pytest.mark.parametrize("cls, buffer", [(_Persistent, "running_scale"),
                                         (_ComputedOnMeta, "positions")],
                         ids=["persistent", "computed_on_meta"])
def test_a_buffer_without_a_value_is_refused_by_name(monkeypatch, cls, buffer):
    from micformer_tpu_torch import registry

    monkeypatch.setitem(registry._REGISTRY, "toy", (cls, {}))
    config = dict(name="toy", model="toy", kwargs={}, parameters=20)
    state = {"lin.weight": torch.zeros(4, 4), "lin.bias": torch.zeros(4)}
    with pytest.raises(RuntimeError, match=buffer):
        drive.program_model(config, torch.float32, torch.device("cpu"), state)


@pytest.mark.parametrize("config, builds", [(MICFORMER, 1), (MEDNEXT, 1), ("swinunetr", 2)],
                         ids=["micformer", "mednext", "swinunetr"])
def test_only_a_model_with_buffers_builds_a_twin(monkeypatch, config, builds):
    # the registered factory's calls: registry.build's, and the twin's
    from micformer_tpu_torch import registry

    if config == "swinunetr":
        config, state = _config(config, BIASED[config])
    else:
        state = drive.weights(config, 3, torch.device("cpu"))
    name = config["model"]
    factory, registered = registry._lookup(name)
    calls = []

    def counted(**kw):
        calls.append(kw)
        return factory(**kw)

    monkeypatch.setitem(registry._REGISTRY, name, (counted, registered))
    drive.program_model(config, torch.float32, torch.device("cpu"), state)
    assert len(calls) == builds


def test_a_model_with_buffers_and_other_widths_is_refused():
    config, state = _config("swinunetr", BIASED["swinunetr"])
    with pytest.raises(RuntimeError, match="parameters"):
        drive.program_model({**config, "parameters": config["parameters"] + 1},
                            torch.float32, torch.device("cpu"), state)
