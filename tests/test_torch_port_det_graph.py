"""The DINO head's CUDA-graph path (``models/heads/dino_head.py``) and the
attention scale without a host synchronisation that it needs
(``models/layers/attention.py``).

CPU cases: ``scaled_logits`` against the division it replaced, logits and
gradients bit for bit in float32 and bfloat16; a tiny head in training,
with grad on, with CDN queries and serving on the CPU runs its selection
and decoder eagerly, equal bit for bit to the region as it was written
before it became ``DINOHead._decode`` (``parent_region``); the graph key
follows where the parameters' data lies, not its values; and the life
cycle of the graphs with the CUDA capture stood in for (``StandIn``:
nothing on the CPU captures a graph): a key's first call eager, its second
captures, later calls replay, ``GRAPH_KEYS`` keys kept, outputs that share
no storage with the graph's buffers and that a later replay leaves alone.
The ``cuda`` cases (skipped without a card) run the division there and
replay the tiny head against its eager calls. No JAX here: the ``cuda``
cases run on the card with ``--noconftest``.
"""

import pytest
import torch

from rscotr_tpu_torch.models.heads import dino_head
from rscotr_tpu_torch.models.heads.dino_head import DINOHead
from rscotr_tpu_torch.models.layers.attention import scaled_logits
from rscotr_tpu_torch.models.layers.common import init_weights
from rscotr_tpu_torch.ops.box_ops import inverse_sigmoid
from rscotr_tpu_torch.ops.pos_encoding import coordinate_sine_embedding

C, NQ, K = 32, 6, 5
SIZES = ((16, 16), (8, 8), (4, 4), (2, 2))   # strides 8..64 of a 128^2 tile
DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


def _device(name):
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the division on the card)")
    return torch.device(name)


def parent_region(head, memory, mask_flat, valid_ratios, shapes,
                  dn_label_query=None, dn_bbox_query=None, attn_mask=None):
    """The head's selection, decoder and branches as ``DINOHead.forward``
    ran them after the encoder before they became ``_decode``."""
    tr = head.transformer
    B = memory.shape[0]
    out_memory, out_proposals = head._gen_proposals(memory, mask_flat,
                                                    shapes, valid_ratios)
    enc_cls = head.cls_branches[-1](out_memory)
    enc_coord_unact = head.reg_branches[-1](out_memory) + out_proposals
    topk_idx = enc_cls.max(-1).values.topk(head.num_query, dim=1).indices
    topk_score = enc_cls.gather(
        1, topk_idx[..., None].expand(-1, -1, enc_cls.shape[-1]))
    topk_coords_unact = enc_coord_unact.gather(
        1, topk_idx[..., None].expand(-1, -1, 4))
    topk_anchor = topk_coords_unact.sigmoid()
    topk_coords_unact = topk_coords_unact.detach()
    x = tr.query_embed.weight[None].expand(B, -1, -1)
    ref_unact = topk_coords_unact
    if dn_label_query is not None:
        x = torch.cat([dn_label_query, x], 1)
        ref_unact = torch.cat([dn_bbox_query, topk_coords_unact], 1)
    ref = ref_unact.sigmoid()
    ratios4 = torch.cat([valid_ratios, valid_ratios], -1)[:, None]
    dec = tr.decoder
    states, refs = [], [ref]
    for lid, layer in enumerate(dec.layers):
        ref_input = ref[:, :, None, :] * ratios4
        query_pos = dec.ref_point_head(coordinate_sine_embedding(
            ref_input[:, :, 0, :], num_feats=C // 2))
        x = layer(x, query_pos, memory, ref_input, shapes,
                  self_attn_mask=attn_mask, key_padding_mask=mask_flat)
        new_ref = (head.reg_branches[lid](x) +
                   inverse_sigmoid(ref, eps=1e-3)).sigmoid()
        ref = new_ref.detach()
        states.append(dec.norm(x))
        refs.append(new_ref)
    all_cls = [head.cls_branches[i](s) for i, s in enumerate(states)]
    all_coords = [(head.reg_branches[i](s) +
                   inverse_sigmoid(refs[i], eps=1e-3)).sigmoid()
                  for i, s in enumerate(states)]
    return (torch.stack(all_cls), torch.stack(all_coords), topk_score,
            topk_anchor)


def tiny_head(device="cpu", seed=0):
    """A 2-layer head, its initial weights moved off their special values
    (zero box deltas, equal class biases) so that every branch counts."""
    head = DINOHead(num_classes=K, num_query=NQ, embed_dims=C,
                    num_decoder_layers=2, num_heads=4, num_points=2,
                    feedforward_channels=64, device="cpu")
    g = torch.Generator().manual_seed(seed)
    init_weights(head, g)
    with torch.no_grad():
        for p in head.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=g))
    return head.to(device).eval()


def tiny_feats(B, seed, device="cpu"):
    g = torch.Generator(device).manual_seed(seed)
    return [torch.randn(B, h, w, C, generator=g, device=device)
            for h, w in SIZES]


def encode(tokens, pos, ref, shapes, key_padding_mask=None):
    """An encoder stand-in: the tokens plus their positions."""
    return tokens + pos


def run(head, feats, hw, **cdn):
    """The head's forward and the arguments its ``_decode`` was given."""
    seen = {}
    decode = head._decode

    def spy(*args):
        seen["args"] = args
        return decode(*args)

    head._decode = spy
    try:
        return head(feats, hw, encode, **cdn), seen.get("args")
    finally:
        del head._decode


def counters():
    return (DINOHead.graph_captures, DINOHead.graph_replays,
            DINOHead.eager_calls)


def same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b)) and len(a) == len(b)


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scaled_logits_bit_equal_to_the_tensor_division(device, dtype):
    dev = _device(device)
    g = torch.Generator().manual_seed(3)
    q = (torch.randn(2, 8, 60, 32, generator=g) * 3).to(dev, dtype)
    k = (torch.randn(2, 8, 70, 32, generator=g) * 3).to(dev, dtype)
    w = torch.randn(2, 8, 60, 70, generator=g).to(dev, dtype)
    grads = []
    for f in (scaled_logits, lambda a, b: torch.matmul(
            a, b.transpose(-1, -2)) / torch.sqrt(torch.tensor(
                float(a.shape[-1]), dtype=a.dtype, device=a.device))):
        qq, kk = q.clone().requires_grad_(), k.clone().requires_grad_()
        out = f(qq, kk)
        (out * w).sum().backward()
        grads.append((out.detach(), qq.grad, kk.grad))
    assert grads[0][0].dtype == dtype
    assert same(grads[0], grads[1])


@pytest.mark.parametrize("mode", ["train", "grad", "cdn", "cpu"])
def test_region_runs_eagerly(monkeypatch, mode):
    """Two calls alike, each eager and equal to ``parent_region``. But for
    ``cpu`` the CPU stands in for the card (``StandIn``, and a
    ``_replayable`` that asks only for grad mode off), so that the call's
    own mode or inputs alone keep the region eager."""
    if mode != "cpu":
        monkeypatch.setattr(dino_head, "_replayable",
                            lambda memory: not torch.is_grad_enabled())
        monkeypatch.setattr(dino_head, "_Graph", StandIn)
    head = tiny_head()
    feats, hw = tiny_feats(2, 1), torch.tensor([[128, 128], [128, 96]])
    cdn = {}
    if mode == "cdn":
        P = 4
        g = torch.Generator().manual_seed(2)
        mask = torch.zeros(P + NQ, P + NQ, dtype=torch.bool)
        mask[P:, :P] = True
        cdn = dict(dn_label_query=torch.randn(2, P, C, generator=g),
                   dn_bbox_query=torch.randn(2, P, 4, generator=g),
                   attn_mask=mask)
    if mode == "train":
        head.train()
    before = counters()
    with torch.set_grad_enabled(mode == "grad"):
        for _ in range(2):
            got, args = run(head, feats, hw, **cdn)
            want = parent_region(head, *args)
            assert len(got) == 4 and same(got, want)
    assert counters() == (before[0], before[1], before[2] + 2)
    assert not head._graphs.by_key
    if mode == "grad":
        got[1].sum().backward()
        assert head.reg_branches[0][4].weight.grad is not None


def test_graph_key_follows_storage_not_values():
    head = tiny_head()
    memory = torch.zeros(2, sum(h * w for h, w in SIZES), C)
    key = head._graph_key(memory, SIZES)
    assert key is not None and key == head._graph_key(memory.clone(), SIZES)
    w = head.cls_branches[0].weight
    with torch.no_grad():
        w.copy_(w * 2)                   # a weight loaded in place
    assert head._graph_key(memory, SIZES) == key
    w.data = w.data.clone()              # new storage for the parameter
    moved = head._graph_key(memory, SIZES)
    assert moved != key
    assert head._graph_key(memory[:1], SIZES) != moved
    assert head._graph_key(memory.bfloat16(), SIZES) != moved
    with torch.inference_mode():
        assert head._graph_key(memory, SIZES) != moved


class StandIn:
    """``dino_head._Graph`` without CUDA: the region's outputs in buffers
    that every call overwrites, as a replay overwrites the graph's."""

    def __init__(self, head, memory, mask_flat, valid_ratios, shapes):
        self.head, self.shapes = head, shapes
        self.inputs = (memory.clone(), mask_flat.clone(), valid_ratios.clone())
        self.outputs = head._decode(*self.inputs, shapes)

    def __call__(self, memory, mask_flat, valid_ratios):
        for buf, t in zip(self.inputs, (memory, mask_flat, valid_ratios)):
            buf.copy_(t)
        for buf, t in zip(self.outputs,
                          self.head._decode(*self.inputs, self.shapes)):
            buf.copy_(t)


def test_graph_life_cycle(monkeypatch):
    head = tiny_head()
    hw = torch.tensor([[128, 128], [128, 96]])
    feats = [tiny_feats(2, s) for s in range(3)]
    with torch.inference_mode():
        eager = [run(head, f, hw)[0] for f in feats]
    monkeypatch.setattr(dino_head, "_replayable", lambda memory: True)
    monkeypatch.setattr(dino_head, "_Graph", StandIn)
    before = counters()
    with torch.inference_mode():
        outs = [run(head, f, hw)[0] for f in feats]
    # first call eager, second captures and replays, third replays
    assert tuple(a - b for a, b in zip(counters(), before)) == (1, 2, 1)
    assert all(same(o, e) for o, e in zip(outs, eager))
    (graph,) = head._graphs.by_key.values()
    buffers = {t.untyped_storage().data_ptr()
               for t in graph.inputs + tuple(graph.outputs)}
    for out in outs[1:]:
        assert not buffers & {t.untyped_storage().data_ptr() for t in out}

    # GRAPH_KEYS keys kept, the least recently used dropped: its next call
    # is a first call again
    with torch.inference_mode():
        for B in range(3, 3 + dino_head.GRAPH_KEYS):
            run(head, tiny_feats(B, 0), hw[:1].expand(B, -1))
        assert len(head._graphs.by_key) == dino_head.GRAPH_KEYS
        before = counters()
        assert same(run(head, feats[0], hw)[0], eager[0])
    assert counters() == (before[0], before[1], before[2] + 1)


@pytest.mark.cuda
def test_replay_matches_eager_on_card():
    """Four calls of one key (eager, capture, replay, replay) against the
    same calls of a twin head in training mode, which stays eager: bit for
    bit, the K1 launches a call alike."""
    from rscotr_tpu_torch.ops.ms_deform_attn import ms_deform_attn
    dev = _device("cuda")
    head, twin = tiny_head(dev), tiny_head(dev)
    hw = torch.tensor([[128, 128], [128, 96]], device=dev)
    feats = [tiny_feats(2, s, dev) for s in range(4)]
    twin.train()
    launches, eager = [], []
    with torch.inference_mode():
        for f in feats:
            k1 = ms_deform_attn.launches
            eager.append(run(twin, f, hw)[0])
            launches.append(ms_deform_attn.launches - k1)
        before = counters()
        for f, want, n in zip(feats, eager, launches):
            k1 = ms_deform_attn.launches
            assert same(run(head, f, hw)[0], want)
            assert ms_deform_attn.launches - k1 == n == 2
    assert tuple(a - b for a, b in zip(counters(), before)) == (1, 3, 1)
