"""Uniform random walks and LLP context sampling on the device (counterpart
of ``llp_tpu/sample/walk.py``).

Walks run over the graph's sender CSR (``row_ptr``/``col``/``out_degree``)
under a ``torch.Generator``: each step draws ``u`` uniform in [0, 1) in
fp32 and moves to out-neighbour slot ``min(floor(u·deg), deg - 1)`` of the
current node; a node with no out-edges stays where it is, as
``torch_cluster.random_walk`` does (reference ``src/main.py:37-45``).

The context matrix has the reference's layout, (B, 1 + C) with
C = step·hops·(1 + ns_rate) and column 0 the anchor:

* ``'rw'`` -- one walk of step·hops;
* ``'nb'`` -- ``step`` walks of ``hops`` from the anchor, each without its
  repeated anchor column (``main.py:45``).  The ``step`` walks are
  independent, so they run as one walk over ``step·B`` starts: ``hops``
  dependent gathers rather than ``step·hops``;
* then step·hops·ns_rate uniform node ids.

The JAX package's threefry stream is not reproduced.
"""

from __future__ import annotations

import torch

from llp_tpu_torch.core.graph import Graph


def random_walk(generator: torch.Generator, graph: Graph, start: torch.Tensor,
                walk_length: int) -> torch.Tensor:
    """(B, walk_length + 1) int64 node ids, column 0 ``start``."""
    cur = start.to(torch.int64)
    path = [cur]
    last_edge = max(graph.num_edges - 1, 0)
    for _ in range(walk_length):
        deg = graph.out_degree.index_select(0, cur)
        u = torch.rand(cur.shape, generator=generator, device=cur.device)
        off = torch.minimum((u * deg.to(u.dtype)).to(torch.int64), deg - 1).clamp(min=0)
        if graph.num_edges:
            # an isolated node's slot may point one past the last edge; it is
            # replaced below, so clamp the read into range
            slot = (graph.row_ptr.index_select(0, cur) + off).clamp(max=last_edge)
            cur = torch.where(deg > 0, graph.col.index_select(0, slot), cur)
        path.append(cur)
    return torch.stack(path, dim=1)


def sample_contexts(generator: torch.Generator, graph: Graph, anchors: torch.Tensor, *,
                    ps_method: str = "nb", step: int = 3, hops: int = 2,
                    ns_rate: int = 1) -> torch.Tensor:
    """The (B, 1 + step·hops·(1 + ns_rate)) int64 context matrix of
    ``anchors``."""
    anchors = anchors.to(torch.int64)
    b = anchors.shape[0]
    if ps_method == "rw":
        pos = random_walk(generator, graph, anchors, step * hops)
    elif ps_method == "nb":
        walks = random_walk(generator, graph, anchors.repeat(step), hops)
        rest = walks[:, 1:].reshape(step, b, hops).transpose(0, 1).reshape(b, step * hops)
        pos = torch.cat([anchors[:, None], rest], dim=1)
    else:
        raise ValueError(f"unknown ps_method {ps_method!r}")
    neg = torch.randint(0, graph.num_nodes, (b, step * hops * ns_rate), generator=generator,
                        device=anchors.device)
    return torch.cat([pos, neg], dim=1)
