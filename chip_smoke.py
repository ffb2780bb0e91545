#!/usr/bin/env python3
"""Smoke run of ``llp_tpu_torch`` on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It uses the first visible card and imports
nothing of JAX or ``llp_tpu``. The phases below either pass or raise. Any
failure exits non-zero.

1. device       -- the card's name and power limit (nvidia-smi), torch and
                   CUDA versions.
2. build        -- compiles every kernel of ``llp_tpu_torch/csrc`` (one
                   ``nvcc`` per source, all started together).
3. kernel_check -- each kernel against its plain PyTorch version on the card,
                   at stated tolerances: segsum in its three unweighted
                   instances (fp32, bf16 -> fp32, bf16 -> bf16) and its two
                   weighted ones (fp32, bf16 -> bf16; weights with zeros and
                   negative values), the spmm backward, unweighted and
                   weighted (``torch.autograd.grad`` in x and in the weights
                   through the kernel route against the plain backward and
                   the plain edge dots), SDDMM, and the fused retrieval
                   kernel (mlp_topk) in its four instances (fp32 or bf16,
                   dense or int8 candidates) at heads of 2 to 4 layers and
                   ragged Q and B. With more than one card visible
                   (other_card), segsum and SDDMM run again on the last card
                   while card 0 stays current.
4. serve        -- the serving CLI (``llp_tpu_torch.cli.serve.main``) at full
                   width: a 2-layer GraphSAGE teacher, hidden 256, with a
                   2-layer mlp head. It runs with random weights from a seed
                   on the ``cora`` and ``collab`` stand-ins, and then an MLP
                   student runs on ``collab``. The collab teacher runs again
                   from int8 and int4 tables and in bf16, cora from an int8
                   table, and the daemon (``BackgroundServer``) answers
                   top-K and score requests on the collab int8 table. Launch
                   counters show that the kernels served (the top-K through
                   mlp_topk). The kernels' answers are held against the
                   plain routes on the card and against the CPU.
5. weighted_data -- writes the collab stand-in as an ogbl-collab export
                   (``save_dataset_npz``: integer weights >= 1, the official
                   held-out counts, 100,000 negatives each) and a
                   20,000-node sibling, under ``build/chip_smoke/``.
6. train        -- the training CLI (``llp_tpu_torch.cli.train_teacher.main``)
                   at full width (hidden 256, 2 layers, mlp head, batch
                   65,536, dropout 0.5): the GraphSAGE teacher 20 epochs on
                   ``cora`` and 2 epochs each at fp32 and bf16 on
                   ``collab``; on the weighted collab export
                   (``--use_edge_weight``) SAGE 2 epochs at fp32 and GCN 2
                   epochs each at fp32 and bf16; the GCN teacher 20 epochs
                   on ``cora``. Launch counters show the segsum kernel in
                   both directions on every step (the weighted instances on
                   the weighted runs, twice a step for GCN) and the SDDMM
                   kernel in eval. The serving CLI serves both cora
                   artifacts, on the card and on the CPU. Then 3 steps with
                   dropout 0 and fixed negatives, on the card and on the
                   CPU, whose losses must agree: SAGE on ``cora``, weighted
                   GCN on the 20,000-node export; and a profiled collab
                   epoch per type and of weighted GCN (where the time goes).
7. kernels      -- one JSON line: each kernel's launches on the serving and
                   training paths, its time at the collab shapes, the plain
                   version's time, a library call's time where one exists,
                   and the least time the card could take. A
                   ``top_k_partners:`` line gives the fused and unfused
                   top-K times at Q=256 over collab.

The last line is ``{"ok": true, "device": {...}}``. Without CUDA, or outside
a checkout, the script exits 1 and prints no result.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"  # checkpoints written by the serve phase
# A dataset directory that holds no files: the registry serves its seeded
# stand-ins (cora 2,708 x 1,433; collab 235,868 x 128 with 2.51M edges).
STANDINS = str(WORK / "standins")
# The weighted exports (phase_weighted_data): the collab stand-in laid out as
# the ogbl-collab download, and a 20,000-node sibling.
WEIGHTED = str(WORK / "weighted")
WEIGHTED_SMALL = str(WORK / "weighted_small")

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, fp32 outside the
# tensor cores, and bf16 on the tensor cores (dense). The kernels here run
# no tensor-core instruction; a bf16 input's bound is held to the bf16 peak.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12

SEGSUM_TOL = dict(rtol=1e-5, atol=1e-5)   # fp32, another summation order
# bf16 results: one bf16 ulp of the reference value, as two summation orders
# can round to neighbouring bf16 values; the floor covers sums that cancel
# to near zero, where fp32 reassociation error outgrows the ulp.
BF16_TOL = dict(ulps=1, atol=1e-5)
LOSS_RTOL = 1e-4                          # card vs CPU losses, 3 steps, fp32
BF16_LOSS_RTOL = 2e-2                     # bf16 vs fp32 losses, 3 steps
SDDMM_TOL = dict(rtol=1e-5, atol=1e-6)    # as tests/test_sddmm.py
H_TOL = dict(rtol=1e-4, atol=1e-4)        # encode: two layers of cuBLAS vs CPU GEMMs
SCORE_ATOL = 1e-5
# Fused retrieval kernel, fp32: the sums only reassociate (TF32 is off), as
# tests/test_mlp_fused.py holds the TPU kernel to the XLA expression.
MLP_TOPK_TOL = dict(rtol=2e-5, atol=2e-5)
QUANT_CPU_ATOL = 1e-3  # quantized serving, card vs CPU (see phase_serve)


def log(phase: str, payload) -> None:
    print(f"{phase}: {json.dumps(payload) if not isinstance(payload, str) else payload}",
          flush=True)


def compare(got, ref, *, rtol: float, atol: float, what: str) -> dict:
    """Max abs error of ``got`` against ``ref``, and the largest share of its
    tolerance ``atol + rtol * |ref|`` that any element uses; raises past 1."""
    import torch

    if got.shape != ref.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
    got, ref = got.detach().double(), ref.detach().double()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite values")
    if not got.numel():
        return {"max_abs": 0.0, "tol_used": 0.0}
    err = (got - ref).abs()
    used = float((err / (atol + rtol * ref.abs())).max())
    if used > 1.0:
        raise AssertionError(f"{what}: past rtol={rtol} atol={atol} "
                             f"(max abs {float(err.max()):.3g}, {used:.3g}x the tolerance)")
    return {"max_abs": float(err.max()), "tol_used": used}


def compare_bf16(got, ref, *, ulps: int, atol: float, what: str) -> dict:
    """As :func:`compare`, with the tolerance ``ulps`` bf16 ulps of ``ref``
    plus ``atol``."""
    import torch

    if got.shape != ref.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
    got, ref = got.detach().double(), ref.detach().double()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite values")
    if not got.numel():
        return {"max_abs": 0.0, "tol_used": 0.0}
    # bf16 keeps 8 significant bits: its ulp in [2^k, 2^(k+1)) is 2^(k-7).
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp(min=2.0 ** -126))) - 7)
    err = (got - ref).abs()
    used = float((err / (ulps * ulp + atol)).max())
    if used > 1.0:
        raise AssertionError(f"{what}: past {ulps} bf16 ulp + {atol} "
                             f"(max abs {float(err.max()):.3g}, {used:.3g}x the tolerance)")
    return {"max_abs": float(err.max()), "tol_used": used}


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------- phases


def phase_device() -> dict:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)  # the card's name and power limit, as nvidia-smi gives them
    info = {"nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "torch": torch.__version__,
            "cuda": torch.version.cuda}
    log("device", info)
    return info


def phase_build() -> None:
    from llp_tpu_torch.ops.build import build_all

    t0 = time.perf_counter()
    report = build_all()
    for name, r in report.items():
        for line in r["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas[{name}]", line.strip())
    log("build", {"seconds": time.perf_counter() - t0,
                  "kernels": {n: {"seconds": r["seconds"], "cached": r["cached"]}
                              for n, r in report.items()}})


def _check_graph(n: int, e: int, hub_deg: int, isolated: int, seed: int):
    """A random graph whose last ``isolated`` nodes receive nothing and whose
    node 7 receives ``hub_deg`` edges."""
    import numpy as np

    from llp_tpu_torch.core.graph import build_graph

    rng = np.random.default_rng(seed)
    send = rng.integers(0, n, e + hub_deg)
    recv = np.concatenate([rng.integers(0, n - isolated, e), np.full(hub_deg, 7)])
    return build_graph(np.stack([send, recv]), n, device="cuda")


def phase_kernel_check(gen) -> dict:
    """Each kernel against its plain version on the card; returns the
    largest abs error per kernel, instance and direction."""
    import numpy as np
    import torch

    from llp_tpu_torch.data.registry import get_dataset
    from llp_tpu_torch.core.graph import build_graph
    from llp_tpu_torch.models.predictor import LinkPredictor
    from llp_tpu_torch.ops.sddmm import head_weights, sddmm_mlp_score, sddmm_mlp_score_plain
    from llp_tpu_torch.ops.segsum import segsum, segsum_plain
    from llp_tpu_torch.ops.spmm import spmm, spmm_backward_plain

    worst = dict.fromkeys(("segsum", "segsum_bf16_f32", "segsum_bf16", "spmm_bwd",
                           "spmm_bwd_bf16", "segsum_w", "segsum_w_bf16", "spmm_bwd_w",
                           "spmm_bwd_w_bf16", "spmm_dw", "sddmm"), 0.0)

    def segsum_case(label, graph, x):
        xb = x.bfloat16()
        for reduce in ("sum", "mean"):
            scale = graph.inv_in_degree if reduce == "mean" else None
            # (key, input, out_dtype, reference, comparison)
            ref32 = segsum_plain(x, graph.senders, graph.in_ptr, scale)
            refb = segsum_plain(xb.float(), graph.senders, graph.in_ptr, scale)
            cases = (
                ("segsum", x, None, ref32, lambda g, r, w: compare(g, r, **SEGSUM_TOL, what=w)),
                ("segsum_bf16_f32", xb, torch.float32, refb,
                 lambda g, r, w: compare(g, r, **SEGSUM_TOL, what=w)),
                ("segsum_bf16", xb, None, refb.bfloat16(),
                 lambda g, r, w: compare_bf16(g, r, **BF16_TOL, what=w)),
            )
            for key, inp, out_dtype, ref, check in cases:
                before = segsum.launches
                got = segsum(inp, graph.senders, graph.in_ptr, scale, out_dtype=out_dtype)
                torch.cuda.synchronize()
                if graph.num_edges and segsum.launches != before + 1:
                    raise AssertionError(f"{key} {label}: the kernel did not launch")
                if got.dtype != ref.dtype:
                    raise AssertionError(f"{key} {label}: {got.dtype} out, expected {ref.dtype}")
                err = check(got, ref, f"{key} {label} d={x.shape[1]} {reduce}")
                worst[key] = max(worst[key], err["max_abs"])
                log("kernel_check", {"kernel": key, "case": label, "reduce": reduce,
                                     "n": graph.num_nodes, "e": graph.num_edges,
                                     "d": x.shape[1], **err})

    def backward_case(label, graph, d):
        for dtype, key in ((torch.float32, "spmm_bwd"), (torch.bfloat16, "spmm_bwd_bf16")):
            x = torch.randn(graph.num_nodes, d, generator=gen, device="cuda").to(dtype)
            g = torch.randn(graph.num_nodes, d, generator=gen, device="cuda").to(dtype)
            for reduce in ("sum", "mean"):
                x.requires_grad_(True)
                before = spmm.backward_launches
                (got,) = torch.autograd.grad(spmm(graph, x, reduce), x, g)
                torch.cuda.synchronize()
                if graph.num_edges and spmm.backward_launches != before + 1:
                    raise AssertionError(f"{key} {label}: the backward kernel did not launch")
                ref = spmm_backward_plain(graph, g, reduce)
                what = f"{key} {label} d={d} {reduce}"
                err = (compare(got, ref, **SEGSUM_TOL, what=what) if dtype == torch.float32
                       else compare_bf16(got, ref, **BF16_TOL, what=what))
                worst[key] = max(worst[key], err["max_abs"])
                log("kernel_check", {"kernel": key, "case": label, "reduce": reduce,
                                     "n": graph.num_nodes, "e": graph.num_edges, "d": d,
                                     **err})

    def weighted_case(label, graph, x, w):
        """The weighted instances (fp32, bf16 -> bf16) against the plain
        version, with the plain version's rounding points."""
        xb = x.bfloat16()
        for reduce in ("sum", "mean"):
            scale = graph.inv_in_degree if reduce == "mean" else None
            for key, inp in (("segsum_w", x), ("segsum_w_bf16", xb)):
                before = segsum.launch_counts.copy()
                got = segsum(inp, graph.senders, graph.in_ptr, scale, weights=w)
                torch.cuda.synchronize()
                inst = "float32->float32" if inp.dtype == torch.float32 else "bfloat16->bfloat16"
                if segsum.launch_counts[(inst, x.shape[1], True)] != before[(inst, x.shape[1],
                                                                              True)] + 1:
                    raise AssertionError(f"{key} {label}: the weighted kernel did not launch")
                ref = segsum_plain(inp, graph.senders, graph.in_ptr, scale, weights=w)
                what = f"{key} {label} d={x.shape[1]} {reduce}"
                err = (compare(got, ref, **SEGSUM_TOL, what=what) if key == "segsum_w"
                       else compare_bf16(got, ref, **BF16_TOL, what=what))
                worst[key] = max(worst[key], err["max_abs"])
                log("kernel_check", {"kernel": key, "case": label, "reduce": reduce,
                                     "n": graph.num_nodes, "e": graph.num_edges,
                                     "d": x.shape[1], **err})

    def weighted_backward_case(label, graph, x32, w):
        """torch.autograd.grad through the weighted route against the plain
        backward (dx) and the plain edge dots (dw)."""
        for dtype, key in ((torch.float32, "spmm_bwd_w"), (torch.bfloat16, "spmm_bwd_w_bf16")):
            d = x32.shape[1]
            x = x32.to(dtype).requires_grad_(True)
            g = torch.randn(graph.num_nodes, d, generator=gen, device="cuda").to(dtype)
            wt = w.clone().requires_grad_(True)
            for reduce in ("sum", "mean"):
                before = spmm.weighted_backward_launches
                dx, dw = torch.autograd.grad(spmm(graph, x, reduce, edge_weight=wt), (x, wt), g)
                torch.cuda.synchronize()
                if spmm.weighted_backward_launches != before + 1:
                    raise AssertionError(f"{key} {label}: the weighted backward did not launch")
                ref = spmm_backward_plain(graph, g, reduce, edge_weight=w)
                what = f"{key} {label} d={d} {reduce}"
                err = (compare(dx, ref, **SEGSUM_TOL, what=what) if dtype == torch.float32
                       else compare_bf16(dx, ref, **BF16_TOL, what=what))
                gs = g.float() * (graph.inv_in_degree[:, None] if reduce == "mean" else 1.0)
                dw_ref = (gs[graph.receivers] * x.detach().float()[graph.senders]).sum(1)
                dw_err = compare(dw, dw_ref, **SEGSUM_TOL, what=f"dw {what}")
                worst[key] = max(worst[key], err["max_abs"])
                worst["spmm_dw"] = max(worst["spmm_dw"], dw_err["max_abs"])
                log("kernel_check", {"kernel": key, "case": label, "reduce": reduce,
                                     "n": graph.num_nodes, "e": graph.num_edges, "d": d,
                                     **err, "dw": dw_err})

    # Hub row of degree 12,000 and isolated receivers. The features are
    # multiples of 1/256 in [-4, 4] (and so are their bf16 roundings), so
    # every partial sum is exact in fp32 and the hub row's 12,000-term sum
    # agrees in any order. The weights are multiples of 1/8 in [-2, 2], a
    # seventh of them 0, so the weighted sums are exact too.
    g = _check_graph(50_000, 200_000, 12_000, 5_000, seed=0)
    w = torch.randint(-16, 17, (g.num_edges,), generator=gen, device="cuda").float() / 8
    w[::7] = 0.0
    for d in (8, 100, 128, 256, 1433):
        x = torch.randint(-1024, 1025, (g.num_nodes, d), generator=gen,
                          device="cuda").float() / 256
        segsum_case("hub+isolated", g, x)
        backward_case("hub+isolated", g, d)
    for d in (1, 37, 128, 256, 1433):
        x = torch.randint(-1024, 1025, (g.num_nodes, d), generator=gen,
                          device="cuda").float() / 256
        weighted_case("hub+isolated", g, x, w)
        weighted_backward_case("hub+isolated", g, x, w)
    empty = build_graph(np.zeros((2, 0), np.int64), 100, device="cuda")
    segsum_case("E=0", empty, torch.randn(100, 64, generator=gen, device="cuda"))
    backward_case("E=0", empty, 64)
    # The serving and training graphs with Gaussian features at the widths
    # the encode runs.
    for name, widths in (("cora", (1433, 256)), ("collab", (128, 256))):
        ds = get_dataset(STANDINS, name)
        gs = build_graph(ds.edge_index, ds.num_nodes, device="cuda")
        for d in widths:
            segsum_case(name, gs, torch.randn(gs.num_nodes, d, generator=gen, device="cuda"))
        if name == "collab":
            backward_case(name, gs, 256)
            # weighted: co-authorship-like counts, at the collab widths
            wc = torch.randint(1, 6, (gs.num_edges,), generator=gen, device="cuda").float()
            for d in widths:
                weighted_case(name, gs, torch.randn(gs.num_nodes, d, generator=gen,
                                                    device="cuda"), wc)

    def sddmm_case(n, d, hid, b):
        head = LinkPredictor("mlp", d, hid, generator=torch.Generator().manual_seed(d + hid))
        w = [t.cuda() for t in head_weights(head.lins)]
        table = torch.randn(n, d, generator=gen, device="cuda")
        src = torch.randint(0, n, (b,), generator=gen, device="cuda")
        dst = torch.randint(0, n, (b,), generator=gen, device="cuda")
        before = sddmm_mlp_score.launches
        got = sddmm_mlp_score(table, table, src, dst, *w)
        torch.cuda.synchronize()
        if sddmm_mlp_score.launches != before + 1:
            raise AssertionError("sddmm: the kernel did not launch")
        err = compare(got, sddmm_mlp_score_plain(table, table, src, dst, *w),
                      **SDDMM_TOL, what=f"sddmm d={d} h={hid} b={b}")
        worst["sddmm"] = max(worst["sddmm"], err["max_abs"])
        log("kernel_check", {"kernel": "sddmm", "n": n, "d": d, "h": hid, "b": b,
                             **err, **SDDMM_TOL})

    for b in (1, 700, 2048, 1 << 20):
        sddmm_case(235_868, 256, 256, b)
    sddmm_case(5_000, 100, 100, 700)     # D, H not multiples of 128
    sddmm_case(5_000, 37, 70, 2048)      # ragged feature tail, fewer units than threads
    sddmm_case(5_000, 512, 128, 700)     # shared memory above 48 KB
    sddmm_case(5_000, 2048, 300, 700)    # z staged in two chunks, two groups of units
    sddmm_case(5_000, 1813, 70, 2048)    # chunked, with a ragged last chunk
    worst.update(mlp_topk_check(gen))
    return worst


def _mlp_head(dims, seed: int) -> list:
    """A random head of widths ``dims`` (H, hidden..., 1) on the card, in the
    JAX layout ``mlp_block_logits`` takes, with 1/sqrt(fan-in) weights."""
    import torch

    g = torch.Generator().manual_seed(seed)
    return [{"w": (torch.randn(k, f, generator=g) / k ** 0.5).cuda(),
             "b": (0.1 * torch.randn(f, generator=g)).cuda()}
            for k, f in zip(dims[:-1], dims[1:])]


def mlp_topk_check(gen) -> dict:
    """The four instances of the fused retrieval kernel (fp32 or bf16, dense
    or int8 candidates) against ``mlp_block_logits_plain`` on the card, at
    ragged Q and B, heads of 2 to 4 layers, and the collab serving shape."""
    import torch

    from llp_tpu_torch.ops.mlp_topk import (
        bf16_tolerance,
        mlp_block_logits,
        mlp_block_logits_plain,
    )
    from llp_tpu_torch.serve.quant import quantize_table

    worst = {f"mlp_topk_{dt}_{kind}": 0.0 for dt in ("f32", "bf16") for kind in ("dense", "int8")}
    cases = (  # (dims, Q, B): Q and B ragged against the 64-candidate tile
        ((256, 256, 1), 16, 235_868),   # the collab serving shape (16 CLI queries)
        ((256, 256, 1), 37, 2049),
        ((128, 256, 256, 1), 5, 301),   # 3 layers: one activation buffer
        ((100, 70, 1), 3, 130),         # widths not multiples of 16 or 128
        ((64, 300, 1), 2, 77),          # 300 units: two passes of 256
        ((48, 96, 40, 72, 1), 4, 65),   # 4 layers: two buffers in turn
        ((256, 256, 1), 1, 1),
    )
    for i, (dims, q, b) in enumerate(cases):
        lins = _mlp_head(dims, seed=40 + i)
        table = torch.randn(b, dims[0], generator=gen, device="cuda")
        qt = quantize_table(table)
        queries = torch.randn(q, dims[0], generator=gen, device="cuda")
        for dt, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            q_h = queries.to(dt)
            for kind, cand, scales in (("dense", table.to(dt), None),
                                       ("int8", qt.q, qt.scale)):
                before = mlp_block_logits.launches
                got = mlp_block_logits(lins, q_h, cand, scales=scales)
                torch.cuda.synchronize()
                if mlp_block_logits.launches != before + 1:
                    raise AssertionError(f"mlp_topk {tag} {kind}: the kernel did not launch")
                ref = mlp_block_logits_plain(lins, q_h, cand, scales=scales)
                what = f"mlp_topk {tag} {kind} dims={dims} q={q} b={b}"
                if dt == torch.float32:
                    err = compare(got, ref, **MLP_TOPK_TOL, what=what)
                    tol = MLP_TOPK_TOL
                else:
                    bound = bf16_tolerance(lins, q_h, cand, scales=scales)
                    e = (got - ref).abs()
                    used = float((e / bound).max())
                    if not bool(torch.isfinite(got).all()) or used > 1.0:
                        raise AssertionError(f"{what}: past the bf16 bound ({used:.3g}x)")
                    err = {"max_abs": float(e.max()), "tol_used": used}
                    tol = {"bound": "2 * 2^-7 * sum_u z_u |w_L,u| + 1e-5"}
                key = f"mlp_topk_{tag}_{kind}"
                worst[key] = max(worst[key], err["max_abs"])
                log("kernel_check", {"kernel": key, "dims": dims, "q": q, "b": b, **err, **tol})
    return worst


def phase_other_card() -> None:
    """With more than one card visible, both kernels on the last one while
    card 0 stays current: each launch must make its tensors' device current."""
    import numpy as np
    import torch

    from llp_tpu_torch.core.graph import build_graph
    from llp_tpu_torch.models.predictor import LinkPredictor
    from llp_tpu_torch.ops.sddmm import head_weights, sddmm_mlp_score, sddmm_mlp_score_plain
    from llp_tpu_torch.ops.segsum import segsum, segsum_plain

    count = torch.cuda.device_count()
    if count < 2:
        log("other_card", "skipped: one card visible")
        return
    dev = torch.device("cuda", count - 1)
    gen = torch.Generator(device=dev).manual_seed(1)
    rng = np.random.default_rng(1)
    g = build_graph(rng.integers(0, 10_000, (2, 80_000)), 10_000, device=dev)
    x = torch.randn(g.num_nodes, 256, generator=gen, device=dev)
    scale = 1.0 / g.in_degree.clamp(min=1).float()
    got = segsum(x, g.senders, g.in_ptr, scale)
    seg = compare(got, segsum_plain(x, g.senders, g.in_ptr, scale), **SEGSUM_TOL,
                  what=f"segsum on {dev}")
    w = [t.to(dev) for t in head_weights(
        LinkPredictor("mlp", 256, 256, generator=torch.Generator().manual_seed(5)).lins)]
    src = torch.randint(0, g.num_nodes, (5000,), generator=gen, device=dev)
    dst = torch.randint(0, g.num_nodes, (5000,), generator=gen, device=dev)
    sd = compare(sddmm_mlp_score(x, x, src, dst, *w),
                 sddmm_mlp_score_plain(x, x, src, dst, *w), **SDDMM_TOL,
                 what=f"sddmm on {dev}")
    torch.cuda.synchronize(dev)
    if torch.cuda.current_device() != 0:
        raise AssertionError("a kernel launch left another card current")
    log("other_card", {"device": str(dev), "segsum": seg, "sddmm": sd})


def _save_model(path: Path, encoder, predictor, meta: dict) -> None:
    from llp_tpu_torch.utils.checkpoint import save_checkpoint
    from llp_tpu_torch.utils.params import to_jax

    save_checkpoint(str(path), {"params": {"encoder": to_jax(encoder),
                                           "predictor": to_jax(predictor)}}, meta)


def _teacher(path: Path, in_dim: int, dataset: str, seed: int) -> None:
    import torch

    from llp_tpu_torch.models.encoder import init_encoder
    from llp_tpu_torch.models.predictor import LinkPredictor

    g = torch.Generator().manual_seed(seed)
    enc = init_encoder("sage", in_dim, 256, 256, 2, conv="sage", generator=g)
    pred = LinkPredictor("mlp", 256, 256, 1, 2, generator=g)
    # The meta keys the JAX trainer writes with a teacher artifact, plus norm_type.
    _save_model(path, enc, pred, dict(
        encoder="sage", conv="sage", predictor="mlp", hidden_channels=256,
        num_layers=2, predictor_layers=2, dataset=dataset, setting="transductive",
        val=0.0, norm_type="none"))


def _student(path: Path, in_dim: int, dataset: str, seed: int) -> None:
    import torch

    from llp_tpu_torch.models.encoder import init_encoder
    from llp_tpu_torch.models.predictor import LinkPredictor

    g = torch.Generator().manual_seed(seed)
    enc = init_encoder("mlp", in_dim, 256, 256, 2, generator=g)
    pred = LinkPredictor("mlp", 256, 256, 1, 2, generator=g)
    _save_model(path, enc, pred, dict(
        encoder="mlp", predictor="mlp", hidden_channels=256, num_layers=2,
        predictor_layers=2, dataset=dataset, setting="transductive", val=0.0,
        norm_type="none"))


def _serve(argv) -> tuple[dict, list]:
    """Run the serving CLI; returns its summary and its JSON result lines."""
    from llp_tpu_torch.cli.serve import main

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        summary = main(argv)
    lines = [json.loads(s) for s in buf.getvalue().splitlines() if s.strip()]
    summary = dict(summary, wall_s=time.perf_counter() - t0)
    return summary, lines[:-1]


def _requests(n: int, seed: int) -> tuple[str, str]:
    import numpy as np

    rng = np.random.default_rng(seed)
    queries = ",".join(str(q) for q in rng.choice(n, 16, replace=False))
    pairs = ",".join(f"{a}:{b}" for a, b in rng.integers(0, n, (1024, 2)))
    return queries, pairs


def _check_pairs(gpu_lines, cpu_lines, what, atol=SCORE_ATOL) -> float:
    import numpy as np

    g = next(x for x in gpu_lines if "pairs" in x)
    c = next(x for x in cpu_lines if "pairs" in x)
    if g["pairs"] != c["pairs"]:
        raise AssertionError(f"{what}: the pair lists differ")
    err = float(np.abs(np.array(g["scores"]) - np.array(c["scores"])).max())
    if err > atol or not np.isfinite(g["scores"]).all():
        raise AssertionError(f"{what}: pair scores differ by {err} > {atol}")
    return err


def _check_topk(gpu_lines, cpu_lines, k, what, atol=SCORE_ATOL) -> dict:
    """Scores agree within ``atol``; ids agree wherever a score is apart
    from both neighbours by more than that (the last slot's lower
    neighbour is unseen, so it is held to its score only)."""
    import numpy as np

    gq = [x for x in gpu_lines if "query" in x]
    cq = [x for x in cpu_lines if "query" in x]
    if [x["query"] for x in gq] != [x["query"] for x in cq] or not gq:
        raise AssertionError(f"{what}: the query lists differ")
    worst, compared = 0.0, 0
    for a, b in zip(gq, cq):
        sa, sb = np.array(a["scores"]), np.array(b["scores"])
        if len(sa) != k or len(sb) != k:
            raise AssertionError(f"{what}: expected {k} partners")
        worst = max(worst, float(np.abs(sa - sb).max()))
        gaps = np.abs(np.diff(sb))
        left = np.concatenate([[np.inf], gaps]) > atol
        right = np.concatenate([gaps, [0.0]]) > atol
        for i in np.flatnonzero(left & right):
            compared += 1
            if a["partners"][i] != b["partners"][i]:
                raise AssertionError(f"{what}: query {a['query']} slot {i}: partner "
                                     f"{a['partners'][i]} != {b['partners'][i]}")
    if worst > atol:
        raise AssertionError(f"{what}: top-k scores differ by {worst} > {atol}")
    return {"max_abs": worst, "ids_compared": compared, "atol": atol}


def _engine_lines(predictor, table, queries: str, pairs: str, compute_dtype=None) -> list:
    """The CLI's JSON lines for these requests, from the engine's unfused
    routes (the plain PyTorch expressions) on the same table."""
    import numpy as np

    from llp_tpu_torch.serve import score_pairs, top_k_partners

    qi = np.array([int(q) for q in queries.split(",")])
    vals, ids = top_k_partners(predictor, table, qi, k=10, compute_dtype=compute_dtype,
                               mlp_fused=False)
    lines = [{"query": int(q), "partners": i.tolist(), "scores": [round(float(v), 6) for v in r]}
             for q, r, i in zip(qi, vals.cpu(), ids.cpu())]
    se = np.array([[int(a) for a in p.split(":")] for p in pairs.split(",")])
    scores = score_pairs(predictor, table, se[:, 0], se[:, 1], fused=False).cpu()
    lines.append({"pairs": [f"{a}:{b}" for a, b in se.tolist()],
                  "scores": [round(float(v), 6) for v in scores]})
    return lines


def _daemon_lines(state, queries: str, pairs: str) -> list:
    """The same requests through the HTTP daemon (``BackgroundServer``)."""
    import urllib.request

    from llp_tpu_torch.serve import BackgroundServer

    def post(port, path, payload):
        req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                     data=json.dumps(payload).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())

    se = [[int(a) for a in p.split(":")] for p in pairs.split(",")]
    with BackgroundServer(state) as srv:
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/healthz", timeout=60) as r:
            health = json.loads(r.read())
        topk = post(srv.port, "/v1/topk", {"queries": [int(q) for q in queries.split(",")],
                                           "k": 10})
        score = post(srv.port, "/v1/score", {"pairs": se})
    return health, topk["results"] + [{"pairs": [f"{a}:{b}" for a, b in se],
                                       "scores": score["scores"]}]


def phase_serve() -> dict:
    """Drive the serving CLI and the daemon on the card, hold them against
    the CPU and against the plain routes; returns the kernels' launches on
    the serving path."""
    import torch

    from llp_tpu_torch.core.graph import build_graph
    from llp_tpu_torch.data.registry import get_dataset
    from llp_tpu_torch.ops.mlp_topk import bf16_tolerance, head_layers, mlp_block_logits
    from llp_tpu_torch.ops.sddmm import sddmm_mlp_score
    from llp_tpu_torch.ops.segsum import segsum
    from llp_tpu_torch.serve import ServingState, encode_graph_nodes, load_serving_artifacts
    from llp_tpu_torch.serve.quant import quantize_table

    WORK.mkdir(parents=True, exist_ok=True)
    data = STANDINS
    datasets = {"cora": (2708, 1433), "collab": (235_868, 128)}
    for i, (name, (_, d)) in enumerate(datasets.items()):
        _teacher(WORK / f"{name}-teacher", d, name, seed=10 + i)
    _student(WORK / "collab-student", 128, "collab", seed=20)

    def counts():
        return segsum.launches, sddmm_mlp_score.launches, mlp_block_logits.launches

    def serve(argv, what, expect_segsum=2):
        s0, d0, m0 = counts()
        summary, lines = _serve(argv)
        s1, d1, m1 = counts()
        n = datasets["cora" if "--datasets=cora" in argv else "collab"][0]
        if summary["nodes"] != n or summary["dim"] != 256:
            raise AssertionError(f"{what}: served a table of {summary['nodes']} x "
                                 f"{summary['dim']}")
        if s1 - s0 != expect_segsum:
            raise AssertionError(f"{what}: {s1 - s0} segsum launches, expected "
                                 f"{expect_segsum} (one per SAGE layer)")
        if d1 == d0:
            raise AssertionError(f"{what}: the pairs were not scored by the sddmm kernel")
        if any(a.startswith("--topk") for a in argv) and m1 == m0:
            raise AssertionError(f"{what}: the top-K was not scored by the mlp_topk kernel")
        log("serve", {"run": what, **summary, "segsum_launches": s1 - s0,
                      "sddmm_launches": d1 - d0, "mlp_topk_launches": m1 - m0})
        return lines

    runs = {}
    # the serving path starts here
    segsum.launches = sddmm_mlp_score.launches = mlp_block_logits.launches = 0
    mlp_block_logits.launch_counts.clear()
    for name, (n, _) in datasets.items():
        queries, pairs = _requests(n, seed=n)
        argv = [f"--checkpoint={WORK / f'{name}-teacher'}", f"--datasets={name}",
                f"--dataset_dir={data}", "--reencode", "--topk=10",
                f"--queries={queries}", f"--pairs={pairs}"]
        summary_lines = serve(argv, f"{name} teacher")
        runs[name] = (argv, summary_lines, queries, pairs)
    _, student_pairs = _requests(235_868, seed=1)
    student_argv = [f"--checkpoint={WORK / 'collab-student'}", "--datasets=collab",
                    f"--dataset_dir={data}", f"--pairs={student_pairs}"]
    student_lines = serve(student_argv, "collab student", expect_segsum=0)
    # The collab teacher from int8 and int4 tables, and scored in bf16.
    collab_argv, _, queries, pairs = runs["collab"]
    variants = {}
    for flag in ("--quantize=int8", "--quantize=int4", "--compute_dtype=bfloat16"):
        variants[flag] = serve(collab_argv + [flag], f"collab teacher {flag}")
    cora_int8 = serve(runs["cora"][0] + ["--quantize=int8"], "cora teacher --quantize=int8")

    # The daemon on the collab int8 table: the same requests over HTTP.
    modules, _, _ = load_serving_artifacts(str(WORK / "collab-teacher"), device="cpu")
    ds = get_dataset(data, "collab")
    x = torch.from_numpy(ds.x)
    # copies on the card: the CPU modules serve the CPU encode below
    pred = copy.deepcopy(modules["predictor"]).cuda()
    h_gpu = encode_graph_nodes(copy.deepcopy(modules["encoder"]).cuda(),
                               build_graph(ds.edge_index, ds.num_nodes, device="cuda"), x.cuda())
    m0, d0 = mlp_block_logits.launches, sddmm_mlp_score.launches
    state = ServingState(pred, h_gpu, quantize="int8")
    state.warmup(10)
    health, daemon = _daemon_lines(state, queries, pairs)
    if mlp_block_logits.launches == m0 or sddmm_mlp_score.launches == d0:
        raise AssertionError("daemon: the requests did not go through the kernels")
    if health["table_dtype"] != "int8" or health["nodes"] != 235_868:
        raise AssertionError(f"daemon: healthz {health}")
    log("serve_daemon", {"health": health, "mlp_topk_launches": mlp_block_logits.launches - m0,
                         "sddmm_launches": sddmm_mlp_score.launches - d0,
                         "vs_cli_topk": _check_topk(daemon, variants["--quantize=int8"], 10,
                                                    "daemon vs CLI int8"),
                         "vs_cli_pairs": _check_pairs(daemon, variants["--quantize=int8"],
                                                      "daemon vs CLI int8")})
    launches = {"segsum": segsum.launches, "sddmm": sddmm_mlp_score.launches,
                "mlp_topk": dict(mlp_block_logits.launch_counts)}
    for inst in (("float32", "dense"), ("float32", "int8"), ("bfloat16", "dense")):
        if not mlp_block_logits.launch_counts[inst]:
            raise AssertionError(f"mlp_topk {inst}: no launch on the serving path")

    # The kernels' answers against the plain routes on the same card and
    # table.  bf16: the kernel and the unfused bf16 expression round at the
    # same points, so they part only where a hidden unit rounds to the
    # neighbouring bf16 value; bf16_tolerance bounds that in logits, and a
    # probability moves by at most a quarter of its logit.
    for flag, lines in variants.items():
        if flag.startswith("--quantize"):
            table = quantize_table(h_gpu, bits=int(flag[-1]))
            ref = _engine_lines(pred, table, queries, pairs)
            atol = SCORE_ATOL
        else:
            ref = _engine_lines(pred, h_gpu, queries, pairs, compute_dtype=torch.bfloat16)
            rows = h_gpu.bfloat16()
            q_rows = rows[torch.tensor([int(q) for q in queries.split(",")], device="cuda")]
            bf16_pred = copy.deepcopy(pred).to(torch.bfloat16)
            atol = 0.25 * float(bf16_tolerance(head_layers(bf16_pred.lins), q_rows, rows).max())
        log("serve_vs_plain", {"run": f"collab teacher {flag}",
                               "topk": _check_topk(lines, ref, 10, flag, atol=atol),
                               "pairs_max_abs": _check_pairs(lines, ref, flag)})

    # The same requests on the CPU, through the plain versions.
    argv, lines, _, _ = runs["cora"]
    _, cpu = _serve(argv + ["--device=cpu"])
    log("serve_vs_cpu", {"dataset": "cora", "pairs_max_abs": _check_pairs(lines, cpu, "cora"),
                         "topk": _check_topk(lines, cpu, 10, "cora")})
    # int8: the card's and the CPU's encodes differ by about 1e-6, which can
    # move a code that sits at a rounding boundary by one step of its row's
    # scale (max|h|/127); QUANT_CPU_ATOL covers a few such steps.
    _, cpu = _serve(runs["cora"][0] + ["--quantize=int8", "--device=cpu"])
    log("serve_vs_cpu", {"dataset": "cora", "quantize": "int8",
                         "pairs_max_abs": _check_pairs(cora_int8, cpu, "cora int8",
                                                       atol=QUANT_CPU_ATOL),
                         "topk": _check_topk(cora_int8, cpu, 10, "cora int8",
                                             atol=QUANT_CPU_ATOL)})
    # collab: top-k on the CPU would score 16 x 235,868 pairs through the
    # 256-wide head (about 0.5 TFLOP), so only the encode and the pairs.
    _, cpu = _serve([a for a in collab_argv if not a.startswith(("--topk", "--queries"))]
                    + ["--device=cpu"])
    pairs_err = _check_pairs(runs["collab"][1], cpu, "collab")
    h_cpu = encode_graph_nodes(modules["encoder"],
                               build_graph(ds.edge_index, ds.num_nodes, device="cpu"), x)
    log("serve_vs_cpu", {"dataset": "collab", "pairs_max_abs": pairs_err,
                         "h": compare(h_gpu.cpu(), h_cpu, **H_TOL, what="collab h"), **H_TOL})
    _, cpu = _serve(student_argv + ["--device=cpu"])
    log("serve_vs_cpu", {"dataset": "collab", "checkpoint": "student",
                         "pairs_max_abs": _check_pairs(student_lines, cpu, "student")})
    return launches


def _train(argv) -> tuple[dict, dict, list]:
    """Run the training CLI; returns its stats, its report and its stdout."""
    from llp_tpu_torch.cli.train_teacher import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        stats, report = main(argv)
    return stats, report, buf.getvalue().splitlines()


def _counts() -> dict:
    """A snapshot of every launch counter."""
    from llp_tpu_torch.ops.sddmm import sddmm_mlp_score
    from llp_tpu_torch.ops.segsum import segsum
    from llp_tpu_torch.ops.spmm import spmm

    return {"segsum": segsum.launches, "by_shape": dict(segsum.launch_counts),
            "backward": spmm.backward_launches,
            "weighted_backward": spmm.weighted_backward_launches,
            "sddmm": sddmm_mlp_score.launches}


def _shape_key(inst: str, d: int, weighted: bool) -> str:
    return f"{inst} d={d}{' weighted' if weighted else ''}"


def _delta(after: dict, before: dict) -> dict:
    shapes = {_shape_key(*key): n - before["by_shape"].get(key, 0)
              for key, n in after["by_shape"].items()}
    by_shape = {k: v for k, v in shapes.items() if v}
    weighted = sum(v for k, v in by_shape.items() if k.endswith(" weighted"))
    return {"segsum": after["segsum"] - before["segsum"],
            "backward": after["backward"] - before["backward"],
            "weighted": weighted,
            "weighted_backward": after["weighted_backward"] - before["weighted_backward"],
            "sddmm": after["sddmm"] - before["sddmm"],
            "by_shape": by_shape}


TRAIN_FLAGS = ["--hidden_channels=256", "--num_layers=2", "--predictor=mlp",
               "--batch_size=65536", "--dropout=0.5", "--runs=1", "--eval_steps=1",
               "--log_steps=1", "--patience=100"]

# The training runs: (dataset, epochs, compute dtype, dataset directory,
# variant). The first three are the default SAGE teacher on the stand-ins;
# the rest train on the weighted collab export (SAGE, and GCN at both
# types) and the GCN teacher on cora.
TRAIN_RUNS = (("cora", 20, "float32", STANDINS, ""),
              ("collab", 2, "float32", STANDINS, ""),
              ("collab", 2, "bfloat16", STANDINS, ""),
              ("collab", 2, "float32", WEIGHTED, "weighted sage"),
              ("collab", 2, "float32", WEIGHTED, "weighted gcn"),
              ("collab", 2, "bfloat16", WEIGHTED, "weighted gcn"),
              ("cora", 20, "float32", STANDINS, "gcn"))


def _variant_flags(variant: str) -> list:
    return ((["--use_edge_weight"] if "weighted" in variant else [])
            + (["--encoder=gcn"] if "gcn" in variant else []))


def _train_line(name: str, dtype: str, variant: str, stats: dict, report: dict,
                counts: dict) -> dict:
    import statistics

    metric = "Hits@50" if name == "collab" else "Hits@20"
    steady = report["epoch_s"][1:] or report["epoch_s"]
    line = {"dataset": name, "compute_dtype": dtype, "variant": variant or "sage",
            "epochs": len(report["epoch_s"]),
            "steps_per_epoch": report["steps_per_epoch"],
            "epoch_s": statistics.median(steady), "epoch_s_all": report["epoch_s"],
            "eval_s": report["perf"]["mean_eval_s"],
            "edges_per_s": report["perf"]["edges_per_sec"],
            "losses": report["losses"][0], "final_loss": report["losses"][0][-1],
            "metric": metric, "valid": stats[metric]["valid"][0],
            "test": stats[metric]["test"][0], "launches": counts}
    log("train", line)
    return line


def _write_weighted(path: Path, ds, *, n_valid: int, n_test: int, n_neg: int,
                    seed: int) -> dict:
    """An export of ``ds`` laid out as the ogbl-collab download's: its
    undirected pairs permuted by ``seed``, ``n_valid`` and ``n_test`` held
    out, the rest the train positives; ``n_neg`` uniform negatives each for
    valid and test; integer weights >= 1 on the train pairs from a seeded
    geometric draw (p = 0.5, mean 2: co-authorship counts); the message
    graph is the train pairs in both directions with equal weights."""
    import numpy as np

    from llp_tpu_torch.data.io import save_dataset_npz

    rng = np.random.default_rng(seed)
    pairs = ds.edge_index[:, ds.edge_index[0] < ds.edge_index[1]].T
    pairs = pairs[rng.permutation(len(pairs))]
    valid, test = pairs[:n_valid], pairs[n_valid:n_valid + n_test]
    train = pairs[n_valid + n_test:]
    w = rng.geometric(0.5, len(train)).astype(np.float32)
    n = ds.num_nodes
    split = {"train": {"edge": train, "weight": w},
             "valid": {"edge": valid, "edge_neg": rng.integers(0, n, (n_neg, 2))},
             "test": {"edge": test, "edge_neg": rng.integers(0, n, (n_neg, 2))}}
    save_dataset_npz(str(path), ds.x, np.concatenate([train.T, train.T[::-1]], axis=1),
                     edge_weight=np.concatenate([w, w]), split=split,
                     split_name=f"weighted-standin:seed={seed}")
    info = {"path": str(path), "nodes": n, "features": int(ds.x.shape[1]),
            "pairs": int(len(pairs)), "train_pairs": int(len(train)),
            "valid": n_valid, "test": n_test, "negatives": n_neg,
            "message_edges": 2 * int(len(train)), "mean_weight": float(w.mean()),
            "max_weight": float(w.max())}
    log("weighted_data", info)
    return info


def phase_weighted_data() -> None:
    """The weighted datasets of the training phase: the collab stand-in
    exported with ogbl-collab's held-out counts (60,084 valid and 46,329
    test pairs, 100,000 negatives each), and a 20,000-node sibling of the
    same width and degree for the card-against-CPU losses."""
    from llp_tpu_torch.data.registry import get_dataset

    t0 = time.perf_counter()
    _write_weighted(Path(WEIGHTED) / "collab.npz", get_dataset(STANDINS, "collab"),
                    n_valid=60_084, n_test=46_329, n_neg=100_000, seed=11)
    small = get_dataset("", "synthetic:sbm:20000:16:8.2:5:128:gauss")
    _write_weighted(Path(WEIGHTED_SMALL) / "collab.npz", small, n_valid=3_900, n_test=3_000,
                    n_neg=8_000, seed=12)
    log("weighted_data", {"seconds": time.perf_counter() - t0})


def _parity_losses(device: str, compute_dtype: str, *, dataset_dir: str = STANDINS,
                   name: str = "cora", encoder: str = "sage", use_edge_weight: bool = False,
                   steps: int = 3) -> list:
    """``steps`` steps of the teacher at full width, dropout 0, with fixed
    negatives drawn by numpy: one step per epoch, since the batch holds
    every positive."""
    import numpy as np
    import torch

    from llp_tpu_torch.train.loop import prepare_transductive
    from llp_tpu_torch.train.teacher import TeacherTrainer, init_teacher
    from llp_tpu_torch.utils.config import TeacherConfig

    cfg = TeacherConfig(datasets=name, dataset_dir=dataset_dir, encoder=encoder,
                        use_edge_weight=use_edge_weight)
    data = prepare_transductive(cfg, torch.device(device))
    n, d = data["x"].shape
    model = init_teacher(encoder=encoder, in_channels=d, hidden_channels=256, num_layers=2,
                         predictor_mode="mlp", generator=torch.Generator().manual_seed(0))
    trainer = TeacherTrainer(model.to(device), data["graph"], data["x"], data["pos_edges"],
                             encoder=encoder, batch_size=max(65536, data["num_pos"]),
                             neg_mode="uniform", compute_dtype=compute_dtype)
    if trainer.steps != 1:
        raise AssertionError(f"{name}: {trainer.steps} steps per epoch, expected 1")
    negatives = np.random.default_rng(7).integers(0, n, (steps, 1, 2, trainer.batch))
    gen = torch.Generator(device=device).manual_seed(0)
    return [float(trainer.epoch(gen, negatives=torch.from_numpy(negatives[i]).to(device)))
            for i in range(steps)]


def _profile_epoch(compute_dtype: str, *, dataset_dir: str = STANDINS, encoder: str = "sage",
                   use_edge_weight: bool = False) -> dict:
    """One collab epoch under ``torch.profiler`` after a warm-up epoch: the
    device time by kernel, the epoch's wall time and its launches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from llp_tpu_torch.train.loop import prepare_transductive
    from llp_tpu_torch.train.teacher import TeacherTrainer, init_teacher
    from llp_tpu_torch.utils.config import TeacherConfig

    cfg = TeacherConfig(datasets="collab", dataset_dir=dataset_dir, encoder=encoder,
                        use_edge_weight=use_edge_weight)
    data = prepare_transductive(cfg, torch.device("cuda"))
    model = init_teacher(encoder=encoder, in_channels=data["x"].shape[1], hidden_channels=256,
                         num_layers=2, predictor_mode="mlp", dropout=0.5,
                         generator=torch.Generator().manual_seed(0)).cuda()
    trainer = TeacherTrainer(model, data["graph"], data["x"], data["pos_edges"],
                             encoder=encoder, batch_size=65536, neg_mode=cfg.neg_mode,
                             compute_dtype=compute_dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    trainer.epoch(gen)
    torch.cuda.synchronize()
    before = _counts()
    t0 = time.perf_counter()
    trainer.epoch(gen)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = _delta(_counts(), before)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.epoch(gen)
        torch.cuda.synchronize()
    # Kernels only: a CPU op's entry, and a user annotation's device span,
    # repeat the device time of the kernels inside them.
    by_kernel = {ev.key: ev.self_device_time_total / 1e3 for ev in prof.key_averages()
                 if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0
                 and not getattr(ev, "is_user_annotation", False)}
    device_ms = sum(by_kernel.values())
    segsum_ms = sum(v for k, v in by_kernel.items() if "segsum_kernel" in k)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    out = {"encoder": encoder, "weighted": use_edge_weight, "compute_dtype": compute_dtype,
           "steps": trainer.steps, "epoch_s": wall_s, "launches": counts,
           "launches_per_step": {k: v / trainer.steps for k, v in counts["by_shape"].items()},
           "device_ms": device_ms if device_ms else "not measured",
           "segsum_ms": segsum_ms if device_ms else "not measured",
           # the unprofiled epoch's wall time against the profiled one's kernels
           "device_idle_share": 1 - device_ms / (wall_s * 1e3) if device_ms else "not measured",
           "top_kernels_ms": top}
    log("train_profile", out)
    return out


def _check_train_launches(label: str, variant: str, dtype: str, counts: dict,
                          steps: int) -> None:
    """The kernels every step must have launched, from the run's counters."""
    if counts["backward"] < steps:
        raise AssertionError(f"{label}: {counts['backward']} backward segsum launches in "
                             f"{steps} steps")
    aggregations = 2 if "gcn" in variant else 1  # per step, each direction
    if counts["segsum"] - counts["backward"] < aggregations * steps:
        raise AssertionError(f"{label}: {counts['segsum'] - counts['backward']} forward "
                             f"segsum launches in {steps} steps, expected {aggregations} "
                             f"a step")
    if counts["sddmm"] == 0:
        raise AssertionError(f"{label}: eval did not launch the sddmm kernel")
    shapes = counts["by_shape"]
    if "weighted" in variant:
        fwd = counts["weighted"] - counts["weighted_backward"]
        if counts["weighted_backward"] < aggregations * steps or fwd < aggregations * steps:
            raise AssertionError(f"{label}: {fwd} weighted forward and "
                                 f"{counts['weighted_backward']} weighted backward launches "
                                 f"in {steps} steps, expected {aggregations} each a step")
        if dtype == "bfloat16":
            bf16_fwd = shapes.get(_shape_key("bfloat16->bfloat16", 256, True), 0)
            f32_bwd = shapes.get(_shape_key("float32->float32", 256, True), 0)
            if bf16_fwd < aggregations * steps or f32_bwd < aggregations * steps:
                raise AssertionError(f"{label}: {bf16_fwd} weighted bf16->bf16 forwards and "
                                     f"{f32_bwd} weighted fp32 launches at d=256 in {steps} "
                                     f"steps (the backward runs fp32)")
    elif counts["backward"] < aggregations * steps:
        raise AssertionError(f"{label}: {counts['backward']} backward launches in {steps} steps")
    elif dtype == "bfloat16":
        cast = shapes.get(_shape_key("bfloat16->bfloat16", 256, False), 0)
        if cast < 2 * steps:
            raise AssertionError(f"{label}: {cast} bf16->bf16 launches at d=256 in "
                                 f"{steps} steps (one forward and one backward each)")


def _serve_trained(ckpt: Path, expect_segsum: int) -> None:
    """Serve a trained cora artifact through the CLI on the card and on the
    CPU (re-encode, top-10 of 16 queries, 1,024 pairs); the answers agree."""
    import numpy as np

    from llp_tpu_torch.ops.segsum import segsum

    if not all(Path(f"{ckpt}{ext}").exists() for ext in (".npz", ".json")):
        raise AssertionError(f"the cora teacher artifact {ckpt} was not written")
    queries, pairs = _requests(2708, seed=3)
    argv = [f"--checkpoint={ckpt}", "--datasets=cora", f"--dataset_dir={STANDINS}",
            "--reencode", "--topk=10", f"--queries={queries}", f"--pairs={pairs}"]
    before = segsum.launches
    summary, lines = _serve(argv)
    launched = segsum.launches - before
    scores = [v for x in lines for v in x["scores"]]
    if summary["nodes"] != 2708 or summary["dim"] != 256 or not np.isfinite(scores).all():
        raise AssertionError(f"serving the trained cora artifact: {summary}")
    if sum("query" in x for x in lines) != 16:
        raise AssertionError("serving the trained cora artifact: expected 16 top-k lines")
    if launched != expect_segsum:
        raise AssertionError(f"serving {ckpt}: {launched} segsum launches, expected "
                             f"{expect_segsum} (one per layer)")
    _, cpu = _serve(argv + ["--device=cpu"])
    log("serve_trained", {"checkpoint": str(ckpt), **summary, "segsum_launches": launched,
                          "vs_cpu_pairs_max_abs": _check_pairs(lines, cpu, str(ckpt)),
                          "vs_cpu_topk": _check_topk(lines, cpu, 10, str(ckpt))})


def phase_train() -> dict:
    """Drive the training CLI on the card, serve what it wrote, hold 3 steps
    against the CPU; returns each run's launches and the profiles."""
    import numpy as np

    from llp_tpu_torch.ops.segsum import segsum
    from llp_tpu_torch.ops.sddmm import sddmm_mlp_score
    from llp_tpu_torch.ops.spmm import spmm

    saved, results = WORK / "saved", WORK / "results"
    runs = {}
    # the training path starts here
    segsum.launches = spmm.backward_launches = sddmm_mlp_score.launches = 0
    spmm.weighted_backward_launches = 0
    segsum.launch_counts.clear()
    for name, epochs, dtype, data_dir, variant in TRAIN_RUNS:
        label = f"{name} {dtype} {variant or 'sage'}"
        before = _counts()
        stats, report, _ = _train([f"--datasets={name}", f"--epochs={epochs}",
                                   f"--compute_dtype={dtype}", f"--dataset_dir={data_dir}",
                                   f"--save_dir={saved}", f"--results_dir={results}",
                                   *TRAIN_FLAGS, *_variant_flags(variant)])
        counts = _delta(_counts(), before)
        line = _train_line(name, dtype, variant, stats, report, counts)
        steps = report["steps_per_epoch"] * len(report["epoch_s"])
        if line["losses"][-1] >= line["losses"][0]:
            raise AssertionError(f"{label}: the loss did not fall: {line['losses']}")
        _check_train_launches(label, variant, dtype, counts, steps)
        runs[(name, dtype, variant)] = {"line": line, "counts": counts, "steps": steps}
    launches = _counts()

    _serve_trained(saved / "cora-sage_transductive", expect_segsum=2)
    _serve_trained(saved / "cora-gcn_transductive", expect_segsum=2)

    parity = {}
    for label, kw in (("cora sage", {}),
                      ("weighted gcn", dict(dataset_dir=WEIGHTED_SMALL, name="collab",
                                            encoder="gcn", use_edge_weight=True))):
        gpu = _parity_losses("cuda", "float32", **kw)
        cpu = _parity_losses("cpu", "float32", **kw)
        gap = float(np.max(np.abs(np.array(gpu) - cpu) / np.abs(cpu)))
        line = {"run": label, "gpu": gpu, "cpu": cpu, "rel_gap": gap, "rtol": LOSS_RTOL}
        if label == "cora sage":
            bf16 = _parity_losses("cuda", "bfloat16", **kw)
            line.update(bf16=bf16, bf16_rtol=BF16_LOSS_RTOL,
                        bf16_rel_gap=float(np.max(np.abs(np.array(bf16) - gpu) / np.abs(gpu))))
        log("train_vs_cpu", line)
        if gap > LOSS_RTOL:
            raise AssertionError(f"{label}: card vs CPU losses differ by {gap:.3g} > {LOSS_RTOL}")
        if line.get("bf16_rel_gap", 0.0) > BF16_LOSS_RTOL:
            raise AssertionError(f"{label}: bf16 vs fp32 losses differ by "
                                 f"{line['bf16_rel_gap']:.3g} > {BF16_LOSS_RTOL}")
        parity[label] = line

    profiles = {dtype: _profile_epoch(dtype) for dtype in ("float32", "bfloat16")}
    profiles["weighted gcn"] = _profile_epoch("float32", dataset_dir=WEIGHTED, encoder="gcn",
                                              use_edge_weight=True)
    profiles["weighted sage"] = _profile_epoch("float32", dataset_dir=WEIGHTED,
                                               use_edge_weight=True)
    return {"runs": runs, "launches": launches, "profiles": profiles, "parity": parity}


def _segsum_timing(x, senders, in_ptr, scale, adj, out_dtype=None, weights=None) -> dict:
    """Kernel, plain and library times of one segsum at these inputs, and the
    bytes it must move: x once, the index arrays (the scale and the weights)
    once, out once."""
    import torch

    from llp_tpu_torch.ops.segsum import segsum, segsum_plain

    n = in_ptr.numel() - 1
    out_dtype = out_dtype or x.dtype
    t = {"ms": time_ms(lambda: segsum(x, senders, in_ptr, scale, weights=weights,
                                      out_dtype=out_dtype)),
         "plain_ms": time_ms(lambda: segsum_plain(x, senders, in_ptr, scale, weights=weights,
                                                  out_dtype=out_dtype))}
    if out_dtype != x.dtype:
        t["library_ms"] = None
        t["library_note"] = f"no single PyTorch call takes {x.dtype} in and gives {out_dtype}"
    else:
        try:  # does torch.sparse.mm take this type?
            adj = adj.to(x.dtype)
            t["library_ms"] = time_ms(lambda: torch.sparse.mm(adj, x))
        except RuntimeError as exc:
            t["library_ms"] = None
            t["library_note"] = f"torch.sparse.mm refuses {x.dtype} here: {str(exc)[:120]}"
    out_bytes = torch.empty((), dtype=out_dtype).element_size()
    t["bytes"] = (n * x.shape[1] * (x.element_size() + out_bytes) + senders.numel() * 8
                  + in_ptr.numel() * 8 + (0 if scale is None else n * 4)
                  + (0 if weights is None else weights.numel() * 4))
    t["bound_ms"] = t["bytes"] / HBM_BYTES_PER_S * 1e3
    return t


def _weighted_entries(gen, train: dict, worst: dict) -> list:
    """The weighted instances at the shapes of the weighted collab training
    runs: the GCN aggregation forward (fp32 and bf16 -> bf16, the raw
    weights) and backward (fp32 over the sender CSR, the weights read
    through ``sender_edge_id``) at D=256, and the SAGE layer-1 hoist (the
    weighted mean's normalised weights) at D=128. ``library_ms`` is
    ``torch.sparse.mm`` over a CSR that carries the same weights."""
    import torch

    from llp_tpu_torch.train.loop import prepare_transductive
    from llp_tpu_torch.utils.config import TeacherConfig

    data = prepare_transductive(TeacherConfig(datasets="collab", dataset_dir=WEIGHTED,
                                              use_edge_weight=True), torch.device("cuda"))
    g = data["graph"]
    n, e = g.num_nodes, g.num_edges
    w_fwd, w_mean = g.edge_weight, g.mean_weights
    w_bwd = g.edge_weight.index_select(0, g.sender_edge_id)

    def csr(ptr, idx, values):
        return torch.sparse_csr_tensor(ptr, idx, values, (n, n))

    # launches on the training path, from the counters of the whole phase:
    # every weighted backward is the fp32 instance at d=256
    by_shape, bwd = train["launches"]["by_shape"], train["launches"]["weighted_backward"]
    # per step: the profiled weighted GCN and SAGE epochs (fp32; no eval in
    # them, and the SAGE hoist ran before them, at the trainer's set-up), and
    # the bf16 run (its eval runs fp32, so every bf16 launch is a step's)
    prof = train["profiles"]["weighted gcn"]["launches"]
    prof_steps = train["profiles"]["weighted gcn"]["steps"]
    hoist_per_step = train["profiles"]["weighted sage"]["launches_per_step"].get(
        _shape_key("float32->float32", 128, True), 0.0)
    gcn16 = train["runs"][("collab", "bfloat16", "weighted gcn")]
    cases = (
        ("segsum.weighted.fwd.f32.d256", torch.float32, 256, g.senders, g.in_ptr, w_fwd,
         csr(g.in_ptr, g.senders, w_fwd), "segsum_w",
         by_shape.get(("float32->float32", 256, True), 0) - bwd,
         (prof["weighted"] - prof["weighted_backward"]) / prof_steps,
         "receiver CSR, the GCN aggregation's raw weights"),
        ("segsum.weighted.bwd.f32.d256", torch.float32, 256, g.col, g.row_ptr, w_bwd,
         csr(g.row_ptr, g.col, w_bwd), "spmm_bwd_w", bwd,
         prof["weighted_backward"] / prof_steps, "sender CSR, weights through sender_edge_id"),
        ("segsum.weighted.fwd.bf16.d256", torch.bfloat16, 256, g.senders, g.in_ptr, w_fwd,
         csr(g.in_ptr, g.senders, w_fwd), "segsum_w_bf16",
         by_shape.get(("bfloat16->bfloat16", 256, True), 0),
         gcn16["counts"]["by_shape"].get(_shape_key("bfloat16->bfloat16", 256, True), 0)
         / gcn16["steps"], "receiver CSR, bf16 -> bf16"),
        ("segsum.weighted.hoist.f32.d128", torch.float32, 128, g.senders, g.in_ptr, w_mean,
         csr(g.in_ptr, g.senders, w_mean), "segsum_w",
         by_shape.get(("float32->float32", 128, True), 0), hoist_per_step,
         "receiver CSR, the weighted mean's normalised weights (SAGE layer 1, hoisted: "
         "once at the trainer's set-up and once for eval, none a step)"),
    )
    entries = []
    for name, dtype, d, idx, ptr, wts, adj, err_key, launches, per_step, what in cases:
        x = torch.randn(n, d, generator=gen, device="cuda").to(dtype)
        t = _segsum_timing(x, idx, ptr, None, adj, weights=wts)
        log("timing", {"kernel": name, "n": n, "e": e, "d": d, **t})
        entry = {"name": name, "route": "cuda", "source": "llp_tpu_torch/csrc/segsum.cu",
                 "replaces": "llp_tpu/ops/pallas/segsum_kernel.py:148",
                 "launches": launches, "launches_per_step": per_step,
                 "max_abs_err": worst[err_key], "ms": t["ms"], "plain_ms": t["plain_ms"],
                 "bound_ms": t["bound_ms"], "bound_by": "bytes", "library_ms": t["library_ms"],
                 "shapes": f"weighted collab train: n={n} e={e}, d={d}, {what}"}
        if "library_note" in t:
            entry["library_note"] = t["library_note"]
        entries.append(entry)
    return entries


def _mlp_topk_entries(gen, launches: dict, worst: dict) -> list:
    """The fused retrieval kernel at the collab serving shape: Q = 256 queries
    against all 235,868 rows, H = F = 256, a 2-layer head. The kernel in its
    fp32 dense, int8 and bf16 dense instances; its plain version over the
    candidate blocks the engine's unfused route takes (the whole (Q, B, H)
    Hadamard would be 62 GB); and top_k_partners through the kernel and
    through the unfused expression, the data for the ``mlp_fused=None``
    default."""
    import torch

    from llp_tpu_torch.models.predictor import LinkPredictor
    from llp_tpu_torch.ops.mlp_topk import head_layers, mlp_block_logits, mlp_block_logits_plain
    from llp_tpu_torch.serve import top_k_partners
    from llp_tpu_torch.serve.engine import auto_topk_block
    from llp_tpu_torch.serve.quant import quantize_table

    n, h, q = 235_868, 256, 256
    pred = LinkPredictor("mlp", h, h, generator=torch.Generator().manual_seed(4)).cuda()
    lins = head_layers(pred.lins)
    table = torch.randn(n, h, generator=gen, device="cuda")
    qt = quantize_table(table)
    qidx = torch.randperm(n, generator=gen, device="cuda")[:q]
    block = auto_topk_block(pred, q, h)  # the unfused route's candidates per block

    def plain(q_h, cand, scales=None):
        out = torch.empty((q, n), dtype=torch.float32, device="cuda")
        for b0 in range(0, n, block):
            out[:, b0:b0 + block] = mlp_block_logits_plain(
                lins, q_h, cand[b0:b0 + block],
                scales=None if scales is None else scales[b0:b0 + block])
        return out

    flops = 2 * q * n * sum(int(w["w"].shape[0]) * int(w["w"].shape[1]) for w in lins)
    weight_values = sum(w["w"].numel() + w["b"].numel() for w in lins)
    times = {}
    for tag, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        q_h, cand = table[qidx].to(dt), table.to(dt)
        times[tag] = {"ms": time_ms(lambda: mlp_block_logits(lins, q_h, cand), reps=3, warmup=1),
                      "plain_ms": time_ms(lambda: plain(q_h, cand), reps=3, warmup=1)}
    q_h = table[qidx]
    times["int8"] = {
        "ms": time_ms(lambda: mlp_block_logits(lins, q_h, qt.q, scales=qt.scale), reps=3,
                      warmup=1),
        "plain_ms": time_ms(lambda: plain(q_h, qt.q, qt.scale), reps=3, warmup=1)}
    # each input read once, the (Q, B) logits written once
    out_bytes = q * n * 4
    nbytes = {"f32": n * h * 4 + q * h * 4 + weight_values * 4 + out_bytes,
              "bf16": n * h * 2 + q * h * 2 + weight_values * 4 + out_bytes,
              "int8": n * h + n * 4 + q * h * 4 + weight_values * 4 + out_bytes}
    peak = {"f32": FP32_FLOP_PER_S, "int8": FP32_FLOP_PER_S, "bf16": BF16_FLOP_PER_S}
    for tag, t in times.items():
        t["bound_ms"] = max(flops / peak[tag], nbytes[tag] / HBM_BYTES_PER_S) * 1e3
        t["bound_by"] = ("operations" if flops / peak[tag] >= nbytes[tag] / HBM_BYTES_PER_S
                         else "bytes")
        log("timing", {"kernel": f"mlp_topk.{tag}", "q": q, "b": n, "h": h, "flops": flops,
                       "bytes": nbytes[tag], "tflop_per_s": flops / t["ms"] / 1e9, **t})

    topk = {"q": q, "b": n, "k": 10, "block_unfused": block}
    for tag, tbl, cdt in (("f32", table, None), ("int8", qt, None),
                          ("bf16", table, torch.bfloat16)):
        for route in (True, False):
            topk[f"{tag}_{'fused' if route else 'unfused'}_ms"] = time_ms(
                lambda: top_k_partners(pred, tbl, qidx, k=10, compute_dtype=cdt,
                                       mlp_fused=route), reps=3, warmup=1)
    log("top_k_partners", topk)

    common = {"route": "cuda", "source": "llp_tpu_torch/csrc/mlp_topk.cu",
              "replaces": "llp_tpu/ops/pallas/mlp_topk_kernel.py:81",
              "library_ms": None,
              "library_note": "no single PyTorch call takes the Hadamard product of every "
                              "query x candidate pair through an MLP head"}
    shapes = f"Q={q} queries x {n} candidates, H=F={h}, 2-layer head"
    f32, bf16 = times["f32"], times["bf16"]
    return [
        {"name": "mlp_topk", **common,
         "launches": sum(v for (dt, _), v in launches.items() if dt == "float32"),
         "max_abs_err": max(worst["mlp_topk_f32_dense"], worst["mlp_topk_f32_int8"]),
         "ms": f32["ms"], "plain_ms": f32["plain_ms"], "bound_ms": f32["bound_ms"],
         "bound_by": f32["bound_by"], "int8_ms": times["int8"]["ms"],
         "int8_plain_ms": times["int8"]["plain_ms"], "int8_bound_ms": times["int8"]["bound_ms"],
         "shapes": f"{shapes}, fp32 dense (int8_*: int8 codes + scales)"},
        {"name": "mlp_topk.bf16", **common,
         "launches": sum(v for (dt, _), v in launches.items() if dt == "bfloat16"),
         "max_abs_err": max(worst["mlp_topk_bf16_dense"], worst["mlp_topk_bf16_int8"]),
         "ms": bf16["ms"], "plain_ms": bf16["plain_ms"], "bound_ms": bf16["bound_ms"],
         "bound_by": bf16["bound_by"], "shapes": f"{shapes}, bf16 dense"},
    ]


def phase_kernels(gen, launches: dict, train: dict, worst: dict) -> list:
    """Times at the collab serving and training shapes; returns the kernels
    line's entries."""
    import torch

    from llp_tpu_torch.core.graph import build_graph
    from llp_tpu_torch.data.registry import get_dataset
    from llp_tpu_torch.models.predictor import LinkPredictor
    from llp_tpu_torch.ops.sddmm import head_weights, sddmm_mlp_score, sddmm_mlp_score_plain
    from llp_tpu_torch.serve import score_pairs
    from llp_tpu_torch.train.loop import prepare_transductive
    from llp_tpu_torch.utils.config import TeacherConfig

    ds = get_dataset(STANDINS, "collab")
    g = build_graph(ds.edge_index, ds.num_nodes, device="cuda")
    n, e = g.num_nodes, g.num_edges
    scale = g.inv_in_degree
    # The library's counterpart: a CSR adjacency whose values carry the mean's
    # 1/deg, times the features, as one torch.sparse.mm.
    adj = torch.sparse_csr_tensor(g.in_ptr, g.senders, scale[g.receivers], (n, n))

    # One collab encode aggregates twice: the 128-wide input, then the
    # 256-wide hidden layer. The serving segsum entry sums those two launches.
    seg = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0}
    for d in (128, 256):
        x = torch.randn(n, d, generator=gen, device="cuda")
        t = _segsum_timing(x, g.senders, g.in_ptr, scale, adj)
        log("timing", {"kernel": "segsum", "n": n, "e": e, "d": d, **t})
        for key in seg:
            seg[key] += t[key]

    head = LinkPredictor("mlp", 256, 256, generator=torch.Generator().manual_seed(3))
    w1, b1, w2, b2 = (t.cuda() for t in head_weights(head.lins))
    table = torch.randn(n, 256, generator=gen, device="cuda")
    b, d, hid = 1 << 20, 256, 256
    src = torch.randint(0, n, (b,), generator=gen, device="cuda")
    dst = torch.randint(0, n, (b,), generator=gen, device="cuda")
    rows = int(torch.unique(torch.cat([src, dst])).numel())  # table rows the pairs touch
    sd_bytes = rows * d * 4 + 2 * b * 8 + (d * hid + 2 * hid + 1) * 4 + b * 4
    # Hadamard (D), first layer (2DH), bias and relu (2H), second layer (2H),
    # bias and sigmoid (about 4) per pair.
    sd_flops = b * (d + 2 * d * hid + 4 * hid + 4)
    sd = {"ms": time_ms(lambda: sddmm_mlp_score(table, table, src, dst, w1, b1, w2, b2)),
          "plain_ms": time_ms(lambda: sddmm_mlp_score_plain(table, table, src, dst,
                                                            w1, b1, w2, b2))}
    log("timing", {"kernel": "sddmm", "n": n, "b": b, "d": d, "h": hid,
                   "bytes": sd_bytes, "flops": sd_flops, "rows_touched": rows, **sd})
    # score_pairs through the kernel and through the unfused expression: the
    # data for the fused=None default.
    head = head.cuda()
    log("score_pairs", {"pairs": b, "table": [n, d],
                        "fused_ms": time_ms(lambda: score_pairs(head, table, src, dst,
                                                                fused=True), reps=5),
                        "unfused_ms": time_ms(lambda: score_pairs(head, table, src, dst,
                                                                  fused=False), reps=5)})

    seg_bound_ms = seg["bytes"] / HBM_BYTES_PER_S * 1e3
    sd_bytes_ms = sd_bytes / HBM_BYTES_PER_S * 1e3
    sd_flops_ms = sd_flops / FP32_FLOP_PER_S * 1e3
    entries = [
        {"name": "segsum", "route": "cuda", "source": "llp_tpu_torch/csrc/segsum.cu",
         "replaces": "llp_tpu/ops/pallas/segsum_kernel.py:148",
         "launches": launches["segsum"], "max_abs_err": worst["segsum"],
         "ms": seg["ms"], "plain_ms": seg["plain_ms"], "bound_ms": seg_bound_ms,
         "bound_by": "bytes", "library_ms": seg["library_ms"],
         "shapes": f"collab serve encode: n={n} e={e}, d=128 + d=256, mean, fp32"},
        {"name": "sddmm", "route": "cuda", "source": "llp_tpu_torch/csrc/sddmm.cu",
         "replaces": "llp_tpu/ops/pallas/sddmm_kernel.py:41",
         "launches": launches["sddmm"] + train["launches"]["sddmm"],
         "max_abs_err": worst["sddmm"],
         "ms": sd["ms"], "plain_ms": sd["plain_ms"],
         "bound_ms": max(sd_bytes_ms, sd_flops_ms),
         "bound_by": "operations" if sd_flops_ms >= sd_bytes_ms else "bytes",
         "library_ms": None,
         "library_note": "no single PyTorch call gathers, multiplies and runs the MLP head",
         "shapes": f"{b} pairs over a {n} x {d} table, H={hid}"},
        *_mlp_topk_entries(gen, launches["mlp_topk"], worst),
    ]

    # The training shapes: the message graph of the collab split (the train
    # positives, both directions), forward over the receiver CSR and backward
    # over the sender CSR, as the collab training runs above launched them.
    data = prepare_transductive(TeacherConfig(datasets="collab", dataset_dir=STANDINS),
                                torch.device("cuda"))
    tg = data["graph"]
    tn, te = tg.num_nodes, tg.num_edges
    tscale = tg.inv_in_degree
    fwd_adj = torch.sparse_csr_tensor(tg.in_ptr, tg.senders, tscale[tg.receivers], (tn, tn))
    # backward: A^T (diag(1/deg) g), with g scaled before the kernel
    bwd_adj = torch.sparse_csr_tensor(tg.row_ptr, tg.col, torch.ones(te, device="cuda"),
                                      (tn, tn))
    tags = {torch.float32: ("f32", "float32->float32", 148, "segsum", "spmm_bwd"),
            torch.bfloat16: ("bf16", "bfloat16->bfloat16", 191, "segsum_bf16",
                             "spmm_bwd_bf16")}
    for dtype, (tag, inst, line_no, fwd_key, bwd_key) in tags.items():
        run = train["runs"][("collab", str(dtype).split(".")[-1], "")]
        prof = train["profiles"][str(dtype).split(".")[-1]]
        for direction, d in (("fwd", 128), ("fwd", 256), ("bwd", 256)):
            x = torch.randn(tn, d, generator=gen, device="cuda").to(dtype)
            if direction == "fwd":
                t = _segsum_timing(x, tg.senders, tg.in_ptr, tscale, fwd_adj)
                key = fwd_key
            else:
                x = (x.float() * tscale[:, None]).to(dtype)
                t = _segsum_timing(x, tg.col, tg.row_ptr, None, bwd_adj)
                key = bwd_key
            shape_key = _shape_key(inst, d, False)
            if direction == "fwd":
                run_launches = run["counts"]["by_shape"].get(shape_key, 0)
                per_step = prof["launches_per_step"].get(shape_key, 0.0)
                if d == 256:  # the backward launches share this instance and width
                    run_launches -= run["counts"]["backward"]
                    per_step -= prof["launches"]["backward"] / prof["steps"]
            else:
                run_launches = run["counts"]["backward"]
                per_step = prof["launches"]["backward"] / prof["steps"]
            log("timing", {"kernel": f"segsum.{direction}.{tag}", "n": tn, "e": te, "d": d,
                           **t})
            entry = {"name": f"segsum.{direction}.{tag}.d{d}", "route": "cuda",
                     "source": "llp_tpu_torch/csrc/segsum.cu",
                     "replaces": f"llp_tpu/ops/pallas/segsum_kernel.py:{line_no}",
                     "launches": run_launches, "launches_per_step": per_step,
                     "max_abs_err": worst[key], "ms": t["ms"], "plain_ms": t["plain_ms"],
                     "bound_ms": t["bound_ms"], "bound_by": "bytes",
                     "library_ms": t["library_ms"],
                     "shapes": (f"collab train {'receiver' if direction == 'fwd' else 'sender'}"
                                f" CSR: n={tn} e={te}, d={d}, {inst}"
                                f"{', mean' if direction == 'fwd' else ', g pre-scaled'}")}
            if "library_note" in t:
                entry["library_note"] = t["library_note"]
            entries.append(entry)
    # The bf16-message instance (bf16 in, fp32 out) is checked above but runs
    # on no path of this slice, so it is timed here and left off the line.
    x = torch.randn(tn, 256, generator=gen, device="cuda").bfloat16()
    t = _segsum_timing(x, tg.senders, tg.in_ptr, tscale, fwd_adj, out_dtype=torch.float32)
    log("timing", {"kernel": "segsum.fwd.bf16->f32", "n": tn, "e": te, "d": 256, **t})
    return entries + _weighted_entries(gen, train, worst)


def main() -> int:
    try:
        import torch
    except ImportError as exc:
        print(f"chip_smoke: {exc}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this smoke run needs one GPU",
              file=sys.stderr)
        return 1
    if not (ROOT / "llp_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT} is not a checkout of the repository "
              f"(no llp_tpu_torch/csrc)", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    info = phase_device()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = phase_kernel_check(gen)
    phase_other_card()
    launches = phase_serve()
    phase_weighted_data()
    train = phase_train()
    kernels = phase_kernels(gen, launches, train, worst)
    log("total", {"seconds": time.perf_counter() - t0})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": info["name"],
                                             "count": info["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
