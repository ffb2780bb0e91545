"""The plain reference of the SAGE teacher: its forward, and the first
steps of an epoch replayed from the generator's state at the epoch's
start.

A step, as the LLP reference's teacher takes it (``train_teacher_gnn.py``):
a batch of training positives in the epoch's random order and as many
uniform negatives, a full-graph SAGE encode (``lin_l(mean_j x_j) +
lin_r(x_i)``, ReLU and dropout between the layers), the 'mlp' head on the
pairs' rows, BCE, each group's gradients clipped to norm 1, one Adam step.
The random draws come from the run's generator in the order the program
documents: the epoch's ``randperm`` of the positives, then per step the
negatives (``randint (2, B)``), the encoder's dropout mask, the head's.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from reference.core import (
    Adam,
    MeanGraph,
    Precision,
    bce,
    clip_groups,
    dropout,
    leaves,
    mlp_head,
)


def sage_encode(p: Dict[str, torch.Tensor], graph: MeanGraph, x: torch.Tensor,
                prec: Precision, *, layers: int, rate: float = 0.0,
                gen: Optional[torch.Generator] = None,
                x_mean: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Node embeddings; ``x_mean`` is layer 1's neighbour mean of ``x``
    where the caller has it (it does not depend on the weights)."""
    h = x
    for i in range(layers):
        agg = x_mean if (i == 0 and x_mean is not None) else graph.mean(h)
        pre = f"encoder.convs.{i}"
        h = (prec.linear(agg, p[f"{pre}.lin_l.weight"], p[f"{pre}.lin_l.bias"])
             + prec.linear(h, p[f"{pre}.lin_r.weight"]))
        if i < layers - 1:
            h = dropout(torch.relu(h), rate, gen)
    return h


def replay_steps(weights: Dict[str, torch.Tensor], graph: MeanGraph, x: torch.Tensor,
                 pos: torch.Tensor, gen_state: torch.Tensor, *, steps: int, batch: int,
                 layers: int, dropout_rate: float, lr: float, prec: Precision) -> dict:
    """The first ``steps`` steps of an epoch from ``weights`` and the
    generator state ``gen_state``: ``{"losses", "grads"}`` (the first
    step's clipped gradients, as Adam takes them) and ``"params"`` after
    the last step."""
    dev = x.device
    gen = torch.Generator(device=dev)
    gen.set_state(gen_state)
    n, e = x.shape[0], pos.shape[0]
    p = leaves(weights)
    opt = Adam(p, lr)
    x_mean = graph.mean(x)
    perm = torch.randperm(e, generator=gen, device=dev)
    perm = torch.cat([perm, torch.full((-(-e // batch) * batch - e,), e, device=dev)])
    losses, grads = [], None
    for i in range(steps):
        idx = perm[i * batch:(i + 1) * batch]
        neg = torch.randint(0, n, (2, batch), generator=gen, device=dev)
        mask = idx < e
        edges = pos[idx.clamp(max=e - 1)]
        h = sage_encode(p, graph, x, prec, layers=layers, rate=dropout_rate, gen=gen,
                        x_mean=x_mean)
        src = torch.cat([edges[:, 0], neg[0]])
        dst = torch.cat([edges[:, 1], neg[1]])
        logits = mlp_head(p, "predictor", h.index_select(0, src), h.index_select(0, dst),
                          prec, rate=dropout_rate, gen=gen)
        labels = torch.cat([torch.ones(batch, device=dev), torch.zeros(batch, device=dev)])
        loss = bce(torch.sigmoid(logits), labels, torch.cat([mask, mask]))
        loss.backward()
        clip_groups(p, ["encoder", "predictor"])
        if i == 0:
            grads = {k: v.grad.detach().clone() for k, v in p.items()}
        opt.step()
        losses.append(float(loss.detach()))
    return {"losses": losses, "grads": grads,
            "params": {k: v.detach() for k, v in p.items()}}
