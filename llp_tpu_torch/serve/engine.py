"""Link-prediction serving: node encoding, pair scoring and top-K partner
retrieval (counterpart of ``llp_tpu/serve/engine.py``).

* :func:`load_serving_artifacts` reads a training checkpoint (written by
  either package) into modules on the requested device.
* :func:`encode_nodes` embeds features with an MLP (student) encoder;
  :func:`encode_graph_nodes` runs a GNN teacher's full-graph forward (SAGE
  or GCN), whose aggregations are the segment-sum kernel on the card.
* :func:`score_pairs` scores (src, dst) pairs by
  :func:`~llp_tpu_torch.ops.edge_score.score_edges`; on the card a supported
  'mlp' head goes through the fused SDDMM kernel.
* :func:`top_k_partners` is the exact blocked top-K over the whole table;
  on the card a supported 'mlp' head scores its candidates with the fused
  retrieval kernel (:mod:`llp_tpu_torch.ops.mlp_topk`).

The table may be a :class:`~llp_tpu_torch.serve.quant.QuantTable` (int8 or
int4): rows dequantize on the fly, 'inner' dots run on the codes.  The
blocked scan of :func:`top_k_partners` is :func:`scan_top_k`, which each
rank of the node-sharded engine (:mod:`llp_tpu_torch.parallel.eval`) runs
over its own rows.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from llp_tpu_torch.core.graph import Graph
from llp_tpu_torch.models.encoder import apply_encoder
from llp_tpu_torch.models.predictor import LinkPredictor
from llp_tpu_torch.ops.edge_score import score_edges
from llp_tpu_torch.ops.mlp_topk import fused_mlp_supported, head_layers, mlp_block_logits
from llp_tpu_torch.serve.quant import (
    QuantTable,
    TableLike,
    code_dots,
    codes_rows,
    codes_slice,
    dequantize_rows,
    dequantize_slice,
)
from llp_tpu_torch.utils.checkpoint import load_checkpoint
from llp_tpu_torch.utils.device import setup_device
from llp_tpu_torch.utils.params import from_jax

# Bytes allowed for one retrieval block's largest intermediate (the (Q, B, H)
# Hadamard tile of an unfused 'mlp' head, or the (Q, B) scores of 'inner'
# and of the fused kernel): the default block size follows from it and the
# request's shape.
TOPK_BLOCK_BYTES = 256 << 20


def load_serving_artifacts(path: str, *, device="cuda") -> Tuple[
        nn.ModuleDict, Optional[torch.Tensor], Dict[str, Any]]:
    """``({"encoder", "predictor"} modules, features or None, meta)``.

    Teacher checkpoints carry best-val node features; student (MLP)
    checkpoints encode fresh features on demand.  The modules are in eval
    mode on ``device``: the card unless ``device="cpu"``; with no card
    visible anything else raises ``SystemExit``."""
    device = setup_device(device)
    ckpt, meta = load_checkpoint(path)
    tree = ckpt["params"] if "params" in ckpt else ckpt
    feats = ckpt.get("features") if "params" in ckpt else None
    modules = from_jax({"encoder": tree["encoder"], "predictor": tree["predictor"]},
                       conv=meta.get("conv", "sage")).to(device)
    if feats is not None:
        feats = torch.from_numpy(np.asarray(feats, np.float32)).to(device)
    return modules, feats, meta


@torch.no_grad()
def encode_nodes(encoder: nn.Module, x: torch.Tensor, *, block: int = 8192) -> torch.Tensor:
    """(N, D) features -> (N, H) embeddings with a graph-free (MLP) encoder,
    ``block`` rows at a time so peak memory is bounded by the block."""
    if x.shape[0] == 0:
        return apply_encoder(encoder, None, x)
    return torch.cat([apply_encoder(encoder, None, x[i:i + block])
                      for i in range(0, x.shape[0], block)])


@torch.no_grad()
def encode_graph_nodes(encoder: nn.Module, graph: Graph, x: torch.Tensor) -> torch.Tensor:
    """GNN-encoder serving: embed every node with a full-graph forward — the
    production-setting re-encode over the current edge set."""
    return apply_encoder(encoder, graph, x)


def _take_rows(h: TableLike, idx: torch.Tensor, dtype=None) -> torch.Tensor:
    """Row gather from a plain or quantized table (dequantized)."""
    if isinstance(h, QuantTable):
        return dequantize_rows(h, idx, dtype=dtype or torch.float32)
    rows = h.index_select(0, idx)
    return rows if dtype is None else rows.to(dtype)


@torch.no_grad()
def score_pairs(predictor: LinkPredictor, h: TableLike, src, dst, *,
                fused: Optional[bool] = None) -> torch.Tensor:
    """Probabilities (B,) for candidate (src, dst) pairs of rows of ``h``.

    ``fused=None`` takes the fused SDDMM kernel for a supported 'mlp' head
    when ``h`` lies on the card, and the unfused PyTorch expression
    otherwise; ``fused=False`` always takes the unfused expression.  (The
    JAX package defaults to unfused from a TPU measurement that does not
    carry over; PERF.md records both times on the H100.)  One call of
    :func:`score_edges`: a dense table in one launch of the kernel, which
    gathers the rows itself, or in its pair blocks; a quantized table in
    those blocks, each gathered and dequantized, then scored by the kernel
    or the expression."""
    src = torch.as_tensor(src, dtype=torch.int64, device=h.device).contiguous()
    dst = torch.as_tensor(dst, dtype=torch.int64, device=h.device).contiguous()
    if fused is None:
        fused = h.device.type == "cuda"
    lins = predictor.lins if predictor.mode == "mlp" else None
    return score_edges(h, src, dst, mode=predictor.mode, lins=lins, fused=fused,
                       take=(lambda ids: _take_rows(h, ids)) if isinstance(h, QuantTable)
                       else None)


def auto_topk_block(predictor: LinkPredictor, q_count: int, width: int,
                    fused: bool = False) -> int:
    """Candidates per retrieval block such that the block's largest
    intermediate fits :data:`TOPK_BLOCK_BYTES`: the (Q, B) fp32 scores, and
    for an unfused 'mlp' head the (Q, B, max(H, F)) Hadamard and hidden
    tiles.  The fused kernel keeps no such tile, so up to Q = 284 a
    235,868-row table is one block and one launch."""
    per_candidate = 4 * max(1, q_count)
    if predictor.mode == "mlp" and not fused:
        per_candidate *= max(width, predictor.lins[0].out_features)
    return max(1, TOPK_BLOCK_BYTES // per_candidate)


@torch.no_grad()
def top_k_partners(predictor: LinkPredictor, h: TableLike, query_ids, *,
                   k: int = 10, block: Optional[int] = None,
                   exclude_self: bool = True, compute_dtype=None,
                   approx: bool = False,
                   mlp_fused: Optional[bool] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each query node, the K nodes with the highest link probability:
    ``(scores, node_ids)``, each (Q, K), sorted descending.

    Candidates are scored a block at a time and merged into a running top-K,
    exactly.  ``approx=True`` is accepted for the JAX signature's sake and
    retrieves exactly (torch has no approximate top-k; the JAX package is
    exact on the CPU too).  ``compute_dtype`` (e.g. ``torch.bfloat16``)
    scores in that type and merges in fp32; on a quantized table it is the
    type the rows dequantize to.

    ``h`` may be a :class:`QuantTable`: 'inner' dots run on the int8 codes
    (int4 blocks unpack after the read) with the rank-1 scale grid; 'mlp'
    candidate blocks dequantize on the fly.

    ``mlp_fused=None`` scores a supported 'mlp' head with the fused
    retrieval kernel (:func:`~llp_tpu_torch.ops.mlp_topk.mlp_block_logits`:
    raw logits, sigmoid on the K winners) when the table lies on the card,
    and with the unfused expression otherwise; ``mlp_fused=True`` asks for
    the kernel's route on any device (the plain version on the CPU);
    ``False`` never takes it.  The JAX package defaults to off from a TPU
    measurement that does not carry over; PERF.md records both top-K times
    on the H100."""
    del approx
    query_ids = torch.as_tensor(query_ids, dtype=torch.int64, device=h.device)
    n = h.shape[0]
    q_codes = q_scale = None
    if isinstance(h, QuantTable) and predictor.mode != "mlp":
        q_codes, q_scale = codes_rows(h, query_ids), h.scale.index_select(0, query_ids)
    vals, ids, raw = scan_top_k(predictor, h, _take_rows(h, query_ids), query_ids,
                                k=min(k, n - 1 if exclude_self else n), block=block,
                                exclude_self=exclude_self, compute_dtype=compute_dtype,
                                mlp_fused=mlp_fused, q_codes=q_codes, q_scale=q_scale)
    return squash(vals, raw), ids


def squash(vals: torch.Tensor, raw: bool) -> torch.Tensor:
    """Raw dots or logits -> probabilities; ``-inf`` slots stay ``-inf``."""
    return torch.where(torch.isfinite(vals), torch.sigmoid(vals), vals) if raw else vals


@torch.no_grad()
def scan_top_k(predictor: LinkPredictor, h: TableLike, q_h: torch.Tensor,
               query_ids: torch.Tensor, *, k: int, row0: int = 0,
               block: Optional[int] = None, exclude_self: bool = True, compute_dtype=None,
               mlp_fused: Optional[bool] = None, q_codes: Optional[torch.Tensor] = None,
               q_scale: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor, bool]:
    """The blocked top-``k`` of the queries against the rows of ``h``, whose
    first row is node ``row0``: ``(values, node_ids, raw)``, each (Q, k)
    fp32 and int64, padded with ``-inf`` and id -1 where ``h`` has fewer
    than ``k`` rows.  ``raw`` says the values are dots or logits, which
    :func:`squash` turns into probabilities; the unfused 'mlp' expression
    gives probabilities already.  ``q_h`` (Q, H) are the queries' rows in
    the table's type (dequantized fp32 for a :class:`QuantTable`), and
    ``q_codes``/``q_scale`` their codes and scales, which an 'inner' head
    over a :class:`QuantTable` dots with the table's codes.  The single
    engine (:func:`top_k_partners`) and each rank of the node-sharded one
    (:func:`llp_tpu_torch.parallel.eval.sharded_topk_partners`) run it."""
    quant = isinstance(h, QuantTable)
    dev = h.device
    n, width = h.shape
    q = query_ids.shape[0]
    mlp = predictor.mode == "mlp"
    if mlp_fused is None:
        mlp_fused = dev.type == "cuda"
    lins = head_layers(predictor.lins) if mlp else None
    fused = bool(mlp_fused) and mlp and fused_mlp_supported(lins, width)
    if block is None:
        # the kernel's plain version on the CPU does materialize the tile
        block = auto_topk_block(predictor, q, width, fused and dev.type == "cuda")
    block = max(1, min(block, n))
    if compute_dtype is not None and compute_dtype != h.dtype:
        if not quant:
            h = h.to(compute_dtype)
        q_h = q_h.to(compute_dtype)
        predictor = copy.deepcopy(predictor).to(compute_dtype)
        lins = head_layers(predictor.lins) if mlp else None
    inner = not mlp
    if inner and quant and q_codes is None:
        raise ValueError("an 'inner' head over a quantized table needs the queries' codes")
    vals = torch.full((q, k), -torch.inf, dtype=torch.float32, device=dev)
    ids = torch.full((q, k), -1, dtype=torch.int64, device=dev)
    for b0 in range(0, n, block):
        size = min(block, n - b0)
        cand_ids = torch.arange(row0 + b0, row0 + b0 + size, device=dev)
        if inner and quant:
            # sigmoid is monotone: rank raw dots, squash the K winners last
            cs = h.scale[b0:b0 + size]
            scores = code_dots(q_codes, codes_slice(h, b0, size)).float() * (
                q_scale[:, None] * cs[None, :])
        elif inner:
            # fp32 dots of (possibly bf16) rows: the products are exact in fp32
            scores = q_h.float() @ h[b0:b0 + size].float().T
        elif fused and quant:
            scores = mlp_block_logits(lins, q_h, codes_slice(h, b0, size),
                                      scales=h.scale[b0:b0 + size])
        elif fused:
            scores = mlp_block_logits(lins, q_h, h[b0:b0 + size])
        else:
            cand = (dequantize_slice(h, b0, size, dtype=compute_dtype or torch.float32)
                    if quant else h[b0:b0 + size])
            scores = predictor(q_h[:, None, :], cand[None, :, :]).float()
        if exclude_self:
            scores = scores.masked_fill(cand_ids[None, :] == query_ids[:, None], -torch.inf)
        all_vals = torch.cat([vals, scores], dim=1)
        all_ids = torch.cat([ids, cand_ids[None, :].expand(q, -1)], dim=1)
        vals, pos = torch.topk(all_vals, k, dim=1)
        ids = torch.gather(all_ids, 1, pos)
    return vals, ids, inner or fused
