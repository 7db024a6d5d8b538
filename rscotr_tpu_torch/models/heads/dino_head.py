"""DINO detection head (PyTorch counterpart of
rscotr_tpu/models/heads/dino_head.py).

Two-stage deformable DETR: encoder proposals (finite ``BIG`` masking), the
top-``num_query`` selection over max class logits, decoder layers with box
refinement (look forward twice) and per-layer outputs. The encoder is the
MTL's shared encoder, passed in as ``encode_fn``. Parameter names follow the
reference (``transformer.*``, ``cls_branches.{i}``,
``reg_branches.{i}.{0,2,4}``, ``label_embedding``). In training the
contrastive-denoising queries (``models/heads/cdn.py``) are prepended to the
matching queries under the CDN self-attention mask; the top-k proposal
coordinates are detached, and so is the reference passed between decoder
layers, while the per-layer outputs keep the non-detached refinement (look
forward twice). Serving runs the ``num_query`` matching queries only.

In serving, everything after the encoder (``DINOHead._decode``: proposals,
top-k, decoder, branches) runs as one CUDA graph replay. The region's shapes
are fixed by the input key (device, batch, level sizes, dtype, query count,
inference mode, and where each parameter's data lies), so its ~1,000 small
launches, which the host would otherwise issue one by one while the card
waits, are recorded once and launched as one. The first call with a key
runs eagerly (it warms up cuBLAS and the allocator), the second captures the
graph in a memory pool of its own and replays it, every later call copies
its inputs into the graph's buffers and replays. The head keeps the graphs
of its ``GRAPH_KEYS`` most recently used keys and releases the others. A
weight loaded in place keeps the key, and the replay reads the new weights;
a parameter given new storage makes a new key. Training, grad mode, the CDN
queries, the CPU, ``torch.compile`` / ``torch.export`` tracing, a dispatch
mode (``FlopCounterMode``, a fake tensor mode) and a stream that is already
capturing run the region eagerly, as written. A replay writes shared
buffers, so one thread at a time may call a head; it returns copies of the
graph's outputs.
"""

from __future__ import annotations

import collections
import math
from typing import Callable, Optional, Sequence

import torch
from torch import nn
from torch.utils._python_dispatch import _get_current_dispatch_mode

from rscotr_tpu_torch.models.layers.common import (Embedding, LayerNorm,
                                                   Linear, Mlp, constant_,
                                                   normal_)
from rscotr_tpu_torch.models.layers.transformer import DinoDecoderLayer
from rscotr_tpu_torch.ops.box_ops import inverse_sigmoid
from rscotr_tpu_torch.ops.layer_norm import layer_norm
from rscotr_tpu_torch.ops.ms_deform_attn import ms_deform_attn
from rscotr_tpu_torch.ops.point_generator import encoder_reference_points
from rscotr_tpu_torch.ops.pos_encoding import (coordinate_sine_embedding,
                                               sine_positional_encoding)
from rscotr_tpu_torch.utils import trace

BIG = 1e4  # finite stand-in for the reference's masked_fill(inf)
GRAPH_KEYS = 4  # input keys whose graphs a head keeps, least recently used out

# The launch counters of the kernels ``DINOHead._decode`` launches (K1, K7):
# a replay launches them again, so it adds what its capture counted.
_COUNTERS = ((ms_deform_attn, "launches"), (ms_deform_attn, "vec_launches"),
             (layer_norm, "launches"))


def mlvl_masks_and_ratios(spatial_shapes, strides, img_hw):
    """Per-level padding masks (True = pad) and valid ratios (B, L, 2) from
    the un-padded content size ``img_hw`` (B, 2) = (h, w)."""
    dev = img_hw.device
    img_h = img_hw[:, 0].float()
    img_w = img_hw[:, 1].float()
    masks, ratios = [], []
    for (h, w), s in zip(spatial_shapes, strides):
        valid_y = (torch.arange(h, dtype=torch.float32, device=dev) * s
                   )[None] < img_h[:, None]
        valid_x = (torch.arange(w, dtype=torch.float32, device=dev) * s
                   )[None] < img_w[:, None]
        masks.append(~(valid_y[:, :, None] & valid_x[:, None, :]))
        ratios.append(torch.stack([valid_x.float().sum(1) / w,
                                   valid_y.float().sum(1) / h], -1))
    return masks, torch.stack(ratios, dim=1)


class DinoTransformerDecoder(nn.Module):
    def __init__(self, num_layers, embed_dims, num_heads, num_levels,
                 num_points, feedforward_channels, dtype, device):
        super().__init__()
        self.layers = nn.ModuleList(
            DinoDecoderLayer(embed_dims, num_heads, num_levels, num_points,
                             feedforward_channels, dtype=dtype, device=device)
            for _ in range(num_layers))
        self.ref_point_head = Mlp(2 * embed_dims, embed_dims, embed_dims,
                                  num_layers=2, dtype=dtype, device=device)
        self.norm = LayerNorm(embed_dims, device=device)


class DinoTransformer(nn.Module):
    def __init__(self, num_query, num_feature_levels, decoder, embed_dims,
                 dtype, device):
        super().__init__()
        self.level_embeds = nn.Parameter(
            torch.empty(num_feature_levels, embed_dims, device=device))
        self.query_embed = Embedding(num_query, embed_dims, device=device)
        self.enc_output = Linear(embed_dims, embed_dims, dtype=dtype,
                                 device=device)
        self.enc_output_norm = LayerNorm(embed_dims, device=device)
        self.decoder = decoder

    def _init_params(self, g):
        normal_(self.level_embeds, 1.0, g)


def _replayable(memory: torch.Tensor) -> bool:
    """Whether a serving call whose encoder gave ``memory`` may run
    ``DINOHead._decode`` as a CUDA graph: a CUDA tensor, grad mode off, no
    ``torch.compile`` or ``torch.export`` tracing, no dispatch mode (which
    sees each op) and no capture already under way on the stream."""
    return (memory.is_cuda and not torch.is_grad_enabled()
            and not torch.compiler.is_compiling()
            and not torch.compiler.is_exporting()
            and _get_current_dispatch_mode() is None
            and not torch.cuda.is_current_stream_capturing())


class _Graph:
    """``DINOHead._decode`` of one input key as a CUDA graph, captured in a
    memory pool of its own, with its input buffers, its outputs and the
    kernel launches its capture counted. Made, it has run once."""

    def __init__(self, head, memory, mask_flat, valid_ratios, shapes):
        stream = head._graphs.stream(memory.device)
        self.inputs = (memory.clone(), mask_flat.clone(), valid_ratios.clone())
        self.graph = torch.cuda.CUDAGraph()
        before = [getattr(f, name) for f, name in _COUNTERS]
        with torch.cuda.device(memory.device), torch.cuda.graph(
                self.graph, stream=stream, capture_error_mode="thread_local"):
            self.outputs = head._decode(*self.inputs, shapes)
        self.launches = [getattr(f, name) - n
                         for (f, name), n in zip(_COUNTERS, before)]
        self.graph.replay()

    def __call__(self, memory, mask_flat, valid_ratios):
        for buf, t in zip(self.inputs, (memory, mask_flat, valid_ratios)):
            buf.copy_(t)
        self.graph.replay()
        for (f, name), n in zip(_COUNTERS, self.launches):
            setattr(f, name, getattr(f, name) + n)


class _Graphs:
    """A head's graphs by input key, least recently used first, at most
    ``GRAPH_KEYS`` (a key seen once holds None: its call ran eagerly), and
    the stream each device captures on."""

    def __init__(self):
        self.by_key = collections.OrderedDict()
        self.streams = {}

    def __contains__(self, key):
        return key in self.by_key

    def get(self, key):
        self.by_key.move_to_end(key)
        return self.by_key[key]

    def add(self, key, graph=None):
        self.by_key[key] = graph
        self.by_key.move_to_end(key)
        while len(self.by_key) > GRAPH_KEYS:
            self.by_key.popitem(last=False)

    def stream(self, device):
        if device not in self.streams:
            self.streams[device] = torch.cuda.Stream(device)
        return self.streams[device]


class DINOHead(nn.Module):
    # how often ``_decode`` was captured, replayed, and run eagerly
    graph_captures = 0
    graph_replays = 0
    eager_calls = 0

    def __init__(self, num_classes: int = 20, num_query: int = 600,
                 embed_dims: int = 256, num_decoder_layers: int = 6,
                 num_feature_levels: int = 4, num_heads: int = 8,
                 num_points: int = 4, feedforward_channels: int = 2048,
                 pos_temperature: float = 20.0,
                 strides: Sequence[int] = (8, 16, 32, 64),
                 dtype=torch.float32, device=None):
        super().__init__()
        self.num_classes, self.num_query = num_classes, num_query
        self.embed_dims, self.pos_temperature = embed_dims, pos_temperature
        self.strides = tuple(strides)
        C, L = embed_dims, num_decoder_layers
        self.label_embedding = Embedding(num_classes, C, device=device)
        decoder = DinoTransformerDecoder(L, C, num_heads, num_feature_levels,
                                         num_points, feedforward_channels,
                                         dtype, device)
        self.transformer = DinoTransformer(num_query, num_feature_levels,
                                           decoder, C, dtype, device)
        # L decoder branches + 1 encoder-proposal branch
        self.cls_branches = nn.ModuleList(
            Linear(C, num_classes, dtype=dtype, device=device)
            for _ in range(L + 1))
        self.reg_branches = nn.ModuleList(
            nn.Sequential(Linear(C, C, dtype=dtype, device=device), nn.ReLU(),
                          Linear(C, C, dtype=dtype, device=device), nn.ReLU(),
                          Linear(C, 4, dtype=dtype, device=device))
            for _ in range(L + 1))
        self._graphs = _Graphs()

    def _init_params(self, g):
        prior = -math.log((1 - 0.01) / 0.01)
        for fc in self.cls_branches:
            constant_(fc.bias, prior)
        for reg in self.reg_branches:
            constant_(reg[4].weight, 0.0)
            constant_(reg[4].bias, 0.0)

    def forward(self, neck_feats, img_hw: torch.Tensor, encode_fn: Callable,
                dn_label_query: Optional[torch.Tensor] = None,
                dn_bbox_query: Optional[torch.Tensor] = None,
                attn_mask: Optional[torch.Tensor] = None):
        """
        Args:
            neck_feats: NHWC maps, high->low resolution (strides 8..64).
            img_hw: (B, 2) int content size of each padded image.
            encode_fn: the shared encoder.
            dn_label_query (B, P, C), dn_bbox_query (B, P, 4) unsigmoided,
                attn_mask (P + num_query, P + num_query) bool (True = not
                allowed): the CDN queries and their mask, or None.
        Returns:
            all_cls (L, B, N, K), all_coords (L, B, N, 4) with
            N = P + num_query, topk_score (B, num_query, K), topk_anchor
            (B, num_query, 4).
        """
        tr = self.transformer
        B = neck_feats[0].shape[0]
        C = self.embed_dims
        shapes = tuple((f.shape[1], f.shape[2]) for f in neck_feats)
        with trace.span(trace.DET_EMBED):
            masks, valid_ratios = mlvl_masks_and_ratios(shapes, self.strides,
                                                        img_hw)
            toks, poss, mflat = [], [], []
            for lvl, f in enumerate(neck_feats):
                h, w = shapes[lvl]
                pos = sine_positional_encoding(
                    masks[lvl], num_feats=C // 2,
                    temperature=self.pos_temperature, normalize=True)
                toks.append(f.reshape(B, h * w, C))
                poss.append(pos.reshape(B, h * w, C) + tr.level_embeds[lvl])
                mflat.append(masks[lvl].reshape(B, h * w))
            tokens = torch.cat(toks, 1)
            pos_flat = torch.cat(poss, 1)
            mask_flat = torch.cat(mflat, 1)

            enc_ref = encoder_reference_points(shapes, valid_ratios)
        with trace.span(trace.ENCODER):
            memory = encode_fn(tokens, pos_flat, enc_ref, shapes,
                               key_padding_mask=mask_flat)

        key = None
        if dn_label_query is None and attn_mask is None and \
                not self.training and _replayable(memory):
            key = self._graph_key(memory, shapes)
        if key is not None and key in self._graphs:
            with trace.span(trace.DET_DECODER):
                return self._replay(key, memory, mask_flat, valid_ratios,
                                    shapes)
        if key is not None:
            self._graphs.add(key)
        DINOHead.eager_calls += 1
        return self._decode(memory, mask_flat, valid_ratios, shapes,
                            dn_label_query, dn_bbox_query, attn_mask)

    def _decode(self, memory, mask_flat, valid_ratios, shapes,
                dn_label_query=None, dn_bbox_query=None, attn_mask=None):
        """Everything after the encoder: the two-stage proposals and top-k
        selection, the decoder queries (CDN first) with box refinement, and
        the per-layer branches; ``forward``'s outputs. Run eagerly, or
        captured into a CUDA graph that later calls replay."""
        tr = self.transformer
        B = memory.shape[0]
        C = self.embed_dims

        # ---- two-stage proposals and top-k selection ---------------------
        with trace.span(trace.DET_SELECT):
            out_memory, out_proposals = self._gen_proposals(
                memory, mask_flat, shapes, valid_ratios)
            enc_cls = self.cls_branches[-1](out_memory)       # (B, S, K)
            enc_coord_unact = (self.reg_branches[-1](out_memory) +
                               out_proposals)
            topk_idx = enc_cls.max(-1).values.topk(self.num_query,
                                                   dim=1).indices
            K = enc_cls.shape[-1]
            topk_score = enc_cls.gather(
                1, topk_idx[..., None].expand(-1, -1, K))
            topk_coords_unact = enc_coord_unact.gather(
                1, topk_idx[..., None].expand(-1, -1, 4))
            topk_anchor = topk_coords_unact.sigmoid()
            topk_coords_unact = topk_coords_unact.detach()

        # ---- decoder queries (CDN first) and box refinement --------------
        with trace.span(trace.DET_DECODER):
            x = tr.query_embed.weight[None].expand(B, -1, -1)
            ref_unact = topk_coords_unact
            if dn_label_query is not None:
                x = torch.cat([dn_label_query, x], 1)
                ref_unact = torch.cat([dn_bbox_query, topk_coords_unact], 1)
            ref = ref_unact.sigmoid()
            ratios4 = torch.cat([valid_ratios, valid_ratios], -1)[:, None]
            dec = tr.decoder
            inter_states, inter_refs = [], [ref]
            for lid, layer in enumerate(dec.layers):
                ref_input = ref[:, :, None, :] * ratios4      # (B, N, L, 4)
                query_pos = dec.ref_point_head(coordinate_sine_embedding(
                    ref_input[:, :, 0, :], num_feats=C // 2))
                x = layer(x, query_pos, memory, ref_input, shapes,
                          self_attn_mask=attn_mask, key_padding_mask=mask_flat)
                new_ref = (self.reg_branches[lid](x) +
                           inverse_sigmoid(ref, eps=1e-3)).sigmoid()
                ref = new_ref.detach()
                inter_states.append(dec.norm(x))
                inter_refs.append(new_ref)

            all_cls, all_coords = [], []
            for lvl, state in enumerate(inter_states):
                all_cls.append(self.cls_branches[lvl](state))
                all_coords.append((self.reg_branches[lvl](state) +
                                   inverse_sigmoid(inter_refs[lvl], eps=1e-3)
                                   ).sigmoid())
            return (torch.stack(all_cls), torch.stack(all_coords), topk_score,
                    topk_anchor)

    def _graph_key(self, memory, shapes):
        """The key of the graph a serving call may replay: device, batch,
        level sizes, dtype, query count, inference mode and each
        parameter's data pointer; None where a parameter is a DTensor."""
        ptrs = []
        for p in self.parameters():
            if type(p).__name__ == "DTensor":
                return None
            ptrs.append(p.data_ptr())
        return (memory.device, memory.shape[0], shapes, memory.dtype,
                self.num_query, torch.is_inference_mode_enabled(),
                tuple(ptrs))

    def _replay(self, key, memory, mask_flat, valid_ratios, shapes):
        """``_decode`` by the key's graph, captured at the key's second
        call. Returns copies: the next replay overwrites the graph's own
        outputs."""
        graph = self._graphs.get(key)
        if graph is None:
            graph = _Graph(self, memory, mask_flat, valid_ratios, shapes)
            self._graphs.add(key, graph)
            DINOHead.graph_captures += 1
        else:
            graph(memory, mask_flat, valid_ratios)
        DINOHead.graph_replays += 1
        return tuple(t.clone() for t in graph.outputs)

    def _gen_proposals(self, memory, mask_flat, shapes, valid_ratios):
        """mmdet gen_encoder_output_proposals with finite masking."""
        tr = self.transformer
        dev = memory.device
        props = []
        for lvl, (h, w) in enumerate(shapes):
            yy, xx = torch.meshgrid(
                torch.arange(h, dtype=torch.float32, device=dev),
                torch.arange(w, dtype=torch.float32, device=dev),
                indexing="ij")
            grid = torch.stack([xx, yy], -1).reshape(-1, 2)
            scale = torch.stack([valid_ratios[:, lvl, 0] * w,
                                 valid_ratios[:, lvl, 1] * h], -1)[:, None]
            grid = (grid[None] + 0.5) / scale
            wh = torch.full_like(grid, 0.05 * (2.0 ** lvl))
            props.append(torch.cat([grid, wh], -1))
        props = torch.cat(props, 1)                         # (B, S, 4)
        in_range = ((props > 0.01) & (props < 0.99)).all(-1, keepdim=True)
        props_unact = torch.log(props.clamp(min=1e-9) /
                                (1.0 - props).clamp(min=1e-9))
        invalid = mask_flat[..., None] | ~in_range
        props_unact = props_unact.masked_fill(invalid, BIG)
        mem = memory.masked_fill(invalid, 0.0)
        return tr.enc_output_norm(tr.enc_output(mem)), props_unact
