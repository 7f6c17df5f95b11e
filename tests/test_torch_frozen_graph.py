"""The frozen-pass graphs (`models/frozen_graph.py`) on the CPU: when
`Blip2CIR.fusion_bank_features` stays eager, the eager / capture / replay
sequence and its launch counts (`ops/cuda_build`'s rule) over a stand-in
for the CUDA graph, and the bank extraction dropping the graphs. The graphs
themselves run on the card (`tests/test_torch_cuda.py -k bank_graph`).
Imports no JAX."""

import numpy as np
import pytest
import torch
from torch import nn

from spn4cir_tpu_torch.bank.bank import extract_fusion_banks
from spn4cir_tpu_torch.models import frozen_graph as fgm
from spn4cir_tpu_torch.models.api import build_backbone
from spn4cir_tpu_torch.models.blip24cir import Blip2CIR
from spn4cir_tpu_torch.ops import cuda_build

CAPTIONS = ["is red with long sleeves", "has a dog on it", "shorter", "blue"]
COUNTERS = ("eager_calls", "captures", "replays")


def counts(fn):
    return tuple(getattr(fn, c) for c in COUNTERS)


@pytest.fixture
def blip2():
    backbone = build_backbone("blip2", blip2_size="test-tiny")
    backbone.init_params(torch.Generator().manual_seed(0))
    backbone.eval()
    side = backbone.input_dim
    images = torch.randn(2, side, side, 3,
                         generator=torch.Generator().manual_seed(1))
    ids = torch.from_numpy(backbone.tokenize(CAPTIONS[:2]))
    return backbone, images, ids


def _cut(backbone):
    # what `parallel.tp` leaves on a layer it cuts (here a group of one)
    layer = backbone.model.visual_encoder.blocks[0].attn.proj
    layer.tp = torch.nn.functional.linear


@pytest.mark.parametrize("why", ["grad", "training", "tp", "device"])
def test_fusion_bank_features_stays_eager(blip2, why):
    """With grad on, in training mode, with a tensor-parallel layer, or on
    the CPU, the call runs the eager body, counts an eager call and keeps
    no graph."""
    backbone, images, ids = blip2
    with torch.no_grad():
        want = backbone._bank_pass(images, ids)
    if why == "training":
        backbone.train()
    if why == "tp":
        _cut(backbone)
    fn = Blip2CIR.fusion_bank_features
    before = counts(fn)
    with torch.set_grad_enabled(why == "grad"):
        assert fgm.FrozenGraphs.check(backbone._bank_reads(),
                                      (images, ids))[0] == why
        got = backbone.fusion_bank_features(images, ids)
        again = backbone.fusion_bank_features(images, ids)
    assert counts(fn) == (before[0] + 2, before[1], before[2])
    assert backbone._bank_graphs.graphs == {}
    for g, a, w in zip(got, again, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
        torch.testing.assert_close(a, w, rtol=0, atol=0)


def test_check_reads_every_weight_of_the_pass(blip2, monkeypatch):
    """The addresses cover the tower, ln_vision, the frozen Q-Former,
    vision_proj and the query tokens, and nothing the pass does not read."""
    backbone, images, ids = blip2
    monkeypatch.setattr(fgm, "on_one_cuda_device", lambda inputs: True)
    with torch.no_grad():
        why, addresses = fgm.FrozenGraphs.check(backbone._bank_reads(),
                                                (images, ids))
    m = backbone.model
    read = [m.query_tokens]
    for part in (m.visual_encoder, m.ln_vision, m.Qformer, m.vision_proj):
        read += [*part.parameters(), *part.buffers()]
    assert why is None
    assert sorted(addresses) == sorted(t.data_ptr() for t in read)
    assert m.Qformer_query.bert.embeddings.word_embeddings.weight.data_ptr() \
        not in addresses


_REPLAYING = []


def _fake_wrapper(name):
    def wrapper():
        if not _REPLAYING:               # a replay runs no Python
            wrapper.launches += 1
    wrapper.__name__ = name
    cuda_build.counted(wrapper)
    return wrapper


class _FakeGraph:
    """The CUDA graph's stand-in: a capture runs the pass's Python once (its
    wrappers count, as under a real capture) and a replay runs it again
    into the captured outputs."""

    def __init__(self, fn, inputs):
        self.fn, self.inputs = fn, inputs
        self.outputs = tuple(fn(*inputs))

    def replay(self):
        _REPLAYING.append(True)
        try:
            for out, new in zip(self.outputs, self.fn(*self.inputs)):
                out.copy_(new)
        finally:
            _REPLAYING.pop()


class _Counter:
    eager_calls = captures = replays = 0


@pytest.fixture
def fake_cuda(monkeypatch):
    def capture(fn, inputs, pool):
        assert pool == "pool"
        graph = _FakeGraph(fn, inputs)
        return graph, graph.outputs

    monkeypatch.setattr(cuda_build, "COUNTED", [])   # fake wrappers only
    monkeypatch.setattr(fgm, "on_one_cuda_device", lambda inputs: True)
    monkeypatch.setattr(fgm, "capture_graph", capture)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")


def _pass():
    layer = nn.Linear(4, 3).eval()
    kernel = _fake_wrapper("kernel")

    def fn(x):
        kernel()
        kernel()
        return (layer(x), layer(x).sum(-1))
    return layer, kernel, fn


def test_first_call_eager_second_captures_then_replays(fake_cuda):
    layer, kernel, fn = _pass()
    graphs = fgm.FrozenGraphs(_Counter())
    counter = graphs.counter
    xs = torch.randn(4, 5, 4, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        got = [graphs(fn, (layer,), x) for x in xs]
        want = [fn(x) for x in xs]
    assert counts(counter) == (1, 1, 3)
    # 2 launches a pass: 4 calls and the 4 eager passes above; the capture
    # put nothing on the device
    assert kernel.launches == 16
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    # fresh outputs: no two calls alias, nor the graph's own buffers
    (entry,) = graphs.graphs.values()
    ptrs = [t.data_ptr() for g in got for t in g]
    ptrs += [t.data_ptr() for t in entry.outputs]
    assert len(set(ptrs)) == len(ptrs)


def test_a_new_shape_starts_eagerly_and_keys_share_the_pool(fake_cuda):
    layer, _, fn = _pass()
    graphs = fgm.FrozenGraphs(_Counter())
    counter = graphs.counter
    with torch.no_grad():
        for rows in (5, 5, 5, 2, 2, 5):
            graphs(fn, (layer,), torch.ones(rows, 4))
    assert counts(counter) == (2, 2, 4)
    assert len(graphs.graphs) == 2 and graphs.pool == "pool"


@pytest.mark.parametrize("move", ["data", "parameter", "assign"])
def test_moved_weights_capture_again(fake_cuda, move):
    layer, _, fn = _pass()
    graphs = fgm.FrozenGraphs(_Counter())
    counter = graphs.counter
    x = torch.ones(5, 4)
    with torch.no_grad():
        for _ in range(3):
            graphs(fn, (layer,), x)
        new = layer.weight.detach() * 2
        if move == "data":
            layer.weight.data = new
        elif move == "parameter":
            layer.weight = nn.Parameter(new)
        else:
            layer.load_state_dict({"weight": new, "bias": layer.bias.clone()},
                                  assign=True)
        got = graphs(fn, (layer,), x)
        want = fn(x)
    assert (counter.captures, counter.replays) == (2, 3)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)


def test_drop_all_frees_every_pass(fake_cuda):
    layer, _, fn = _pass()
    passes = [fgm.FrozenGraphs(_Counter()) for _ in range(2)]
    with torch.no_grad():
        for graphs in passes:
            for _ in range(2):
                graphs(fn, (layer,), torch.ones(5, 4))
    assert all(len(g.graphs) == 1 for g in passes)
    fgm.drop_all()
    assert all(g.graphs == {} and g.pool is None for g in passes)


def test_extract_fusion_banks_drops_the_graphs_on_return(fake_cuda):
    layer, _, fn = _pass()
    graphs = fgm.FrozenGraphs(_Counter())

    def encode(images, text_ids):
        return graphs(fn, (layer,), images)

    batches = [{"captions": CAPTIONS[:2],
                "refer_images": np.ones((2, 4), np.float32),
                "target_images": np.zeros((2, 4), np.float32),
                "triplet_idx": np.array([0, 1]),
                "refer_image_id": np.array([0, 1]),
                "target_image_id": np.array([2, 3])}] * 3
    with torch.no_grad():
        bank = extract_fusion_banks(
            encode, iter(batches), 2, 4,
            lambda caps: np.zeros((len(caps), 2, 4), np.int32))
    assert graphs.counter.replays == 5       # 6 calls: eager, then graphed
    assert graphs.graphs == {}
    assert bank.refer.shape == (2, 3) and tuple(bank.target.shape) == (4,)


def test_extract_fusion_banks_drops_the_graphs_when_it_raises(fake_cuda):
    layer, _, fn = _pass()
    graphs = fgm.FrozenGraphs(_Counter())

    def encode(images, text_ids):
        if graphs.counter.replays:
            raise RuntimeError("the encoder failed")
        return graphs(fn, (layer,), images)

    batch = {"captions": CAPTIONS[:2],
             "refer_images": np.ones((2, 4), np.float32),
             "target_images": np.zeros((2, 4), np.float32),
             "triplet_idx": np.array([0, 1]),
             "refer_image_id": np.array([0, 1]),
             "target_image_id": np.array([2, 3])}
    with torch.no_grad(), pytest.raises(RuntimeError, match="failed"):
        extract_fusion_banks(
            encode, iter([batch] * 3), 2, 4,
            lambda caps: np.zeros((len(caps), 2, 4), np.int32))
    assert graphs.counter.replays == 1 and graphs.graphs == {}
