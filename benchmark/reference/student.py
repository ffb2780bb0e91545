"""The plain reference of the LLP student (an MLP distilled with LLP_D and
LLP_R from a frozen teacher's table and head), minibatch mode, 'nb'
contexts: its forward, and the first steps of an epoch replayed from the
generator's state at the epoch's start.

A step, after the LLP reference (``main.py:52-144``): a link batch of the
positives in the epoch's random order with as many uniform negatives, a
node batch of anchors in another random order; per anchor ``rw_step``
random walks of ``hops`` over the training graph and ``rw_step · hops ·
ns_rate`` uniform nodes as its C contexts; one MLP forward over the rows
[contexts | src | dst]; the student's and the teacher's head on (anchor,
context) pairs; LLP_D (the KL of the softmaxed scores), LLP_R (a margin
ranking over every pair of contexts), ``true_label`` · BCE on the link
pairs; each group's gradients clipped to norm 1; one Adam step.

Draws from the run's generator, in the program's documented order: the
link ``randperm``, the node ``randperm``; per step the negatives, each walk
hop's ``rand`` over the ``rw_step · B`` walkers, the uniform contexts, the
encoder's dropout mask, the context head's, the link head's.  A walk step
goes to out-neighbour ``min(floor(u · deg), deg - 1)`` of the sender-sorted
edge list (stable), and stays on a node with none.
"""

from __future__ import annotations

import itertools
from typing import Dict, Optional

import numpy as np
import torch

from reference.core import Adam, Precision, bce, clip_groups, dropout, leaves, mlp_head


def mlp_encode(p: Dict[str, torch.Tensor], x: torch.Tensor, prec: Precision, *,
               layers: int, rate: float = 0.0,
               gen: Optional[torch.Generator] = None) -> torch.Tensor:
    h = x
    for i in range(layers):
        h = prec.linear(h, p[f"encoder.layers.{i}.weight"], p[f"encoder.layers.{i}.bias"])
        if i < layers - 1:
            h = dropout(torch.relu(h), rate, gen)
    return h


def mlp_encode_blocks(p, x, prec, *, layers: int, block: int = 1 << 16) -> torch.Tensor:
    """The eval-mode table, ``block`` rows at a time."""
    with torch.no_grad():
        return torch.cat([mlp_encode(p, x[i:i + block], prec, layers=layers)
                          for i in range(0, x.shape[0], block)])


class SenderCSR:
    """Out-neighbour lists of a (2, E) message edge list, senders sorted
    stably."""

    def __init__(self, edges: np.ndarray, num_nodes: int, device):
        order = np.argsort(edges[0], kind="stable")
        deg = np.bincount(edges[0], minlength=num_nodes)
        ptr = np.zeros(num_nodes + 1, np.int64)
        ptr[1:] = np.cumsum(deg)
        self.col = torch.from_numpy(edges[1][order].astype(np.int64)).to(device)
        self.ptr = torch.from_numpy(ptr).to(device)
        self.deg = torch.from_numpy(deg.astype(np.int64)).to(device)
        self.num_edges = int(edges.shape[1])

    def walk(self, gen: torch.Generator, start: torch.Tensor, length: int) -> torch.Tensor:
        cur, path = start, [start]
        for _ in range(length):
            deg = self.deg[cur]
            u = torch.rand(cur.shape, generator=gen, device=cur.device)
            off = torch.minimum((u * deg.to(torch.float32)).to(torch.int64), deg - 1).clamp(min=0)
            slot = (self.ptr[cur] + off).clamp(max=self.num_edges - 1)
            cur = torch.where(deg > 0, self.col[slot], cur)
            path.append(cur)
        return torch.stack(path, dim=1)


def contexts(csr: SenderCSR, gen: torch.Generator, anchors: torch.Tensor, *, step: int,
             hops: int, ns_rate: int, num_nodes: int) -> torch.Tensor:
    """(B, 1 + step·hops·(1 + ns_rate)): the anchor, its 'nb' walk nodes
    (walk j's hops in order, walk after walk), uniform nodes."""
    b = anchors.shape[0]
    walks = csr.walk(gen, anchors.repeat(step), hops)
    rest = walks[:, 1:].reshape(step, b, hops).transpose(0, 1).reshape(b, step * hops)
    neg = torch.randint(0, num_nodes, (b, step * hops * ns_rate), generator=gen,
                        device=anchors.device)
    return torch.cat([anchors[:, None], rest, neg], dim=1)


def llp_d(s: torch.Tensor, t: torch.Tensor, amask: torch.Tensor) -> torch.Tensor:
    """KL(log_softmax(s) || softmax(t)), summed, over the real anchors."""
    log_s = torch.log_softmax(s, dim=-1)
    p_t = torch.softmax(t, dim=-1)
    elt = p_t * (torch.log(p_t.clamp(min=1e-12)) - log_s) * amask.float()[:, None]
    return elt.sum() / amask.float().sum().clamp(min=1.0)


def llp_r(s: torch.Tensor, t: torch.Tensor, amask: torch.Tensor, margin: float) -> torch.Tensor:
    """Margin ranking over every pair (i < j) of contexts, the teacher's
    order as the target (0 within ``margin``), the mean over real slots."""
    pairs = torch.tensor(list(itertools.combinations(range(s.shape[1]), 2)),
                         device=s.device).T
    t0, t1 = t[:, pairs[0]], t[:, pairs[1]]
    target = (t0 > t1 + margin).float() - (t0 < t1 - margin).float()
    elt = torch.clamp(-target * (s[:, pairs[0]] - s[:, pairs[1]]) + margin, min=0.0)
    m = amask.float()[:, None].expand_as(elt)
    return (elt * m).sum() / m.sum().clamp(min=1.0)


def replay_steps(weights: Dict[str, torch.Tensor], teacher: Dict[str, torch.Tensor],
                 t_table: torch.Tensor, csr: SenderCSR, x: torch.Tensor, pos: torch.Tensor,
                 gen_state: torch.Tensor, *, steps: int, batch: int, node_batch: int,
                 cfg: dict, prec: Precision) -> dict:
    """The first ``steps`` steps of a student epoch: ``{"losses", "grads",
    "params"}`` as :func:`reference.teacher.replay_steps` gives them.
    ``teacher`` holds the frozen head's leaves (``predictor.lins.i``) and
    ``t_table`` the teacher's table."""
    dev = x.device
    gen = torch.Generator(device=dev)
    gen.set_state(gen_state)
    n, e = x.shape[0], pos.shape[0]
    layers, rate = cfg["num_layers"], cfg["dropout"]
    p = leaves(weights)
    opt = Adam(p, cfg["lr"])
    nsteps = -(-e // batch)
    lperm = torch.randperm(e, generator=gen, device=dev)
    lperm = torch.cat([lperm, torch.full((nsteps * batch - e,), e, device=dev)])
    nperm = torch.randperm(n, generator=gen, device=dev)
    nperm = torch.cat([nperm, torch.full((max(nsteps * node_batch - n, 0),), n, device=dev)])
    losses, grads = [], None
    for i in range(steps):
        lidx = lperm[i * batch:(i + 1) * batch]
        nidx = nperm[i * node_batch:(i + 1) * node_batch]
        anchors, amask = nidx.clamp(max=n - 1), nidx < n
        neg = torch.randint(0, n, (2, batch), generator=gen, device=dev)
        ctx = contexts(csr, gen, anchors, step=cfg["rw_step"], hops=cfg["hops"],
                       ns_rate=cfg["ns_rate"], num_nodes=n)
        edges, emask = pos[lidx.clamp(max=e - 1)], lidx < e
        src = torch.cat([edges[:, 0], neg[0]])
        dst = torch.cat([edges[:, 1], neg[1]])
        rows = mlp_encode(p, x.index_select(0, torch.cat([ctx.reshape(-1), src, dst])), prec,
                          layers=layers, rate=rate, gen=gen)
        c = rows[:ctx.numel()].view(*ctx.shape, -1)
        s_r = torch.sigmoid(mlp_head(p, "predictor", c[:, :1], c[:, 1:], prec, rate=rate,
                                     gen=gen))
        with torch.no_grad():
            t_rows = t_table.index_select(0, ctx.reshape(-1)).view(*ctx.shape, -1)
            t_r = torch.sigmoid(mlp_head(teacher, "predictor", t_rows[:, :1], t_rows[:, 1:],
                                         prec))
        rest = rows[ctx.numel():]
        out = torch.sigmoid(mlp_head(p, "predictor", rest[:src.shape[0]], rest[src.shape[0]:],
                                     prec, rate=rate, gen=gen))
        labels = torch.cat([torch.ones(batch, device=dev), torch.zeros(batch, device=dev)])
        loss = (cfg["llp_d"] * llp_d(s_r, t_r, amask)
                + cfg["llp_r"] * llp_r(s_r, t_r, amask, cfg["margin"])
                + cfg["true_label"] * bce(out, labels, torch.cat([emask, emask])))
        loss.backward()
        clip_groups(p, ["encoder", "predictor"])
        if i == 0:
            grads = {k: v.grad.detach().clone() for k, v in p.items()}
        opt.step()
        losses.append(float(loss.detach()))
    return {"losses": losses, "grads": grads,
            "params": {k: v.detach() for k, v in p.items()}}
