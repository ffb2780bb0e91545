#!/usr/bin/env python3
"""Smoke run of ``llp_tpu_torch`` on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It uses the first visible card and imports
nothing of JAX or ``llp_tpu``. The phases below either pass or raise. Any
failure exits non-zero.

1. device       -- the card's name and power limit (nvidia-smi), torch and
                   CUDA versions.
2. build        -- compiles every kernel of ``llp_tpu_torch/csrc`` (one
                   ``nvcc`` per source, all started together) and the host
                   partitioner ``csrc/partition.cpp`` (``g++``); logs each
                   kernel's registers, spills and static shared memory
                   (``ptxas[...]:`` lines, from ``-Xptxas -v``) and the
                   HMMA/HGMMA counts of the retrieval kernel's tensor-core
                   route and of the pair scorer (``sass[mlp_topk]:``,
                   ``sass[sddmm]:``, from ``cuobjdump -sass``), which must
                   not be 0.
3. trace_tie    -- the program's spans (``llp_tpu_torch.utils.profiling``)
                   on the device trace's clock, in the process's first
                   profiler session, as the benchmark's traced slice is
                   (B1's library and the sleep kernel loaded before it, as
                   a warm step has them): under a CUDA-only
                   ``torch.profiler``, after a synchronise, a span around
                   ``torch.cuda._sleep``, TRACE_TIE_REPS times after one
                   untimed launch in the session; on the recorder's own
                   tie (its marker kernel) the sleep kernels start within
                   TRACE_TIE_US of their spans' starts (median), none
                   more than TRACE_TIE_US before its span's start or after
                   its launch returned, and a span's device time holds
                   its kernel
                   (``trace_tie:`` line: the errors, the marker's name, and
                   how far a tie through a PyTorch fill reads from it).
4. kernel_check -- each kernel against its plain PyTorch version on the card,
                   at stated tolerances: segsum in its three unweighted
                   instances (fp32, bf16 -> fp32, bf16 -> bf16) and its two
                   weighted ones (fp32, bf16 -> bf16; weights with zeros and
                   negative values), the spmm backward, unweighted and
                   weighted (``torch.autograd.grad`` in x and in the weights
                   through the kernel route against the plain backward and
                   the plain edge dots), on a hub-and-isolated graph, cora,
                   collab and the collab-sized power-law graph
                   ``ba_graph(235_868, 5)`` (D=256 and the scalar path, its
                   hub rows run first); SDDMM (the tensor-core route with
                   16- and 4-byte gathers, ragged B, D and H off every tile,
                   H > 256); two launches of every segsum instance (both
                   directions, Gaussian features) and of SDDMM at 2^20
                   pairs on the same inputs give equal bits; the fused retrieval
                   kernel (mlp_topk) in its four instances (fp32 or bf16,
                   dense or int8 candidates) at heads of 2 to 4 layers and
                   ragged Q and B (Q = 1, B off the 64-candidate tile; bf16
                   on its tensor-core route and, for a head too wide for
                   it, the SIMT one), and the tile SpMM (spmm_tiles, B5) in
                   its four instances (fp32 or bf16 x, unweighted or
                   weighted tiles) with min_tile_edges 0 and 16 at D = 64,
                   128, 256 and 37 on a hub-and-isolated and a banded graph
                   and on one whose row blocks hold 789 chunks and exactly
                   one, its hybrid forward and backward (sum, mean; the
                   residual through segsum) and the empty tile set; the
                   gathers' backward (``gather_rows``: segsum over the ids'
                   CSR) at the collab teacher's and student's shapes, fp32
                   and bf16, against ``index_add_`` in fp32, two passes
                   equal bit for bit; the ReLU-dropout kernel
                   (``relu_dropout``) at the collab teacher's two dropout
                   sites, fp32 and bf16, with and without the addend, and on
                   a ragged view that starts inside a vector, against
                   ``relu_dropout_plain`` bit for bit (forward, both
                   gradients, the generator's state); inputs it does not
                   take raise; its launches through the trainers on cora: 2
                   + 2 a teacher step, none a student step at dropout 0,
                   none in an eval. With more than one card visible
                   (other_card), segsum and SDDMM run again on the last card
                   while card 0 stays current.
5. serve        -- the serving CLI (``llp_tpu_torch.cli.serve.main``) at full
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
6. weighted_data -- writes the collab stand-in as an ogbl-collab export
                   (``save_dataset_npz``: integer weights >= 1, the official
                   held-out counts, 100,000 negatives each) and a
                   20,000-node sibling, under ``build/chip_smoke/``.
7. train        -- the training CLI (``llp_tpu_torch.cli.train_teacher.main``)
                   at full width (hidden 256, 2 layers, mlp head, batch
                   65,536, dropout 0.5): the GraphSAGE teacher 20 epochs on
                   ``cora`` and 2 epochs each at fp32 and bf16 on
                   ``collab``; on the weighted collab export
                   (``--use_edge_weight``) SAGE 2 epochs at fp32 and GCN 2
                   epochs each at fp32 and bf16; the GCN teacher 20 epochs
                   on ``cora``; SAGE with ``--use_valedges_as_input`` 5
                   epochs on ``cora`` and 2 on the 20,000-node weighted
                   export. Launch counters show the segsum kernel in both
                   directions on every step (the weighted instances on the
                   weighted runs, twice a step for GCN), over both graphs
                   with the validation edges as input, the D=256 steps on
                   128-byte feature slices, the ReLU-dropout kernel 2 + 2 a
                   step and none in an eval (the encoder's hidden layer and
                   the head's), and the SDDMM kernel in eval, on
                   its tensor-core route (as in every phase below). The
                   serving CLI serves both cora artifacts, on
                   the card and on the CPU. Then 3 steps with dropout 0 and
                   fixed negatives, on the card and on the CPU, whose losses
                   must agree: SAGE on ``cora``, weighted GCN on the
                   20,000-node export; and a profiled collab epoch per type
                   and of weighted GCN and SAGE (where the time goes).
8. student      -- the student's CLI (``llp_tpu_torch.cli.train_student.main``)
                   at full width (hidden 256, 2 layers, mlp head, link
                   batch 65,536, dropout 0.5, C = 12 contexts) from the
                   train phase's teachers: on ``cora`` 20 epochs full-batch
                   ``nb``, 20 epochs ``--minibatch --ps_method=rw
                   --llp_r_chunk=16`` and 5 epochs with KD_RM = KD_LM = 0.3;
                   on the weighted collab export 2 epochs each at fp32,
                   bf16 and fp32 ``--minibatch``. Every loss falls, every
                   eval launches SDDMM 4 times and nothing launches segsum;
                   the ReLU-dropout kernel runs 3 + 3 a step (the encoder's
                   hidden layer, the head's over the context pairs and over
                   the link pairs) and none in an eval.
                   The default cora student serves on the card (top-K
                   through mlp_topk) and on the CPU alike; 3 single-step
                   epochs with fixed contexts and negatives agree with the
                   CPU's; a profiled collab student epoch.
9. production   -- the production (unseen-node) setting through both
                   training CLIs (``--transductive production``) at full
                   width: the SAGE teacher 20 epochs on ``cora`` (ratios
                   0.3) and 2 epochs at fp32 on ``collab`` (0.1), then the
                   default student from each, 20 and 2 epochs. Every loss
                   falls; every teacher eval launches segsum over the
                   training graph and the inference graph (the layer-1
                   hoist once per graph a run, layer 2 per graph an eval);
                   every eval launches SDDMM once per non-empty edge set
                   (7), and the student's none of segsum. The cora teacher's
                   evaluation agrees on the card and the CPU, and its
                   artifact, served with ``--reencode``, answers alike on
                   both.
10. tooling     -- raw downloads, snapshots, the reference's artifacts and
                   the sweep and parity CLIs at full width: a Planetoid raw
                   cora (2,708 x 1,433, 10,556 directed edges) and a
                   GNN-benchmark coauthor-cs (18,333 x 6,805 CSR attributes,
                   163,788 directed edges) written from a seed under
                   ``build/chip_smoke/raw/`` and loaded through
                   ``get_dataset`` (features as written, edges symmetric,
                   unique, no self-loops); the collab teacher 4 epochs
                   straight and cut at 2 with ``--checkpoint_every 2`` and
                   resumed to 4, and the same for the cora student, in
                   PyTorch's default mode (the losses, final weights, Adam
                   state and generator state equal bit for bit, full
                   histories, the resumed run's artifact at its best
                   validation), and each straight run once more under
                   PyTorch's deterministic algorithms, equal bit for bit
                   to the default-mode one (``default_mode_rel_gap`` 0);
                   ``tests/golden``'s cora split and SAGE
                   teacher through ``llp_tpu_torch.cli.import_reference``, a
                   student distilled from it (5 epochs) and the teacher
                   served with ``--reencode`` on the card and the CPU alike;
                   ``run_sweep`` with a dict spec (2 teacher trials on the
                   raw cora, 3 epochs each, then a third by resume, on the
                   uninterrupted stream); ``cli.parity`` over the raw cora
                   and coauthor-cs (1 run, 3 epochs). Launch counters show
                   segsum in both directions and the gathers' backward on
                   every teacher step and SDDMM four times in every eval.
11. scale10m    -- the teacher at 10M nodes through ``TeacherTrainer``
                   (``scripts/scale10m_r5.py``'s configuration: an SBM of
                   10,000,000 nodes, 64 communities, mean degree 7, 64
                   Gaussian features, seed 5; SAGE 2 layers, hidden 128,
                   mlp head, dropout 0, bf16, uniform negatives, batch
                   2^19), built on the host with the port's own
                   ``sbm_graph`` (its time printed apart): one fp32 epoch
                   with ``gather_last`` off and on (the first 20 steps'
                   losses within 1e-4 of each other), then one bf16 epoch
                   in each setting of ``gather_last`` and ``remat`` (epoch
                   time, peak device bytes; the first 8 steps' losses
                   within 1e-3 of each other, remat's equal to the plain
                   run's bit for bit), then the
                   last model's bf16 table by a full encode, its AUC on
                   200,000 held-out pairs (scored by SDDMM), the table in
                   int4, and top-10 from it against the fp32 table:
                   'inner' at Q=256 and the bf16 'mlp' head at Q=128
                   through mlp_topk (recall@10 and times); then segsum
                   bf16 -> bf16 at D=128 forward and backward over the
                   10M CSR beside ``torch.sparse.mm`` and its bound.
12. reorder     -- ``--reorder rcm|locality`` and the tile SpMM: the
                   orders of the collab stand-in (their host time) and the
                   tile fill under each (min_tile_edges 16 and 0); on the
                   RCM graph the hybrid ``spmm_tiles`` mean forward and
                   backward (fp32, and bf16 forward) and the weighted tiles
                   of the mean (fp32 and bf16 x) against their plain
                   versions (the plain segment sum and backward,
                   ``spmm_tiles_apply_plain``);
                   the teacher CLI with ``--reorder rcm`` and ``locality``
                   (cora 20 epochs, collab 2, fp32), a ``--reorder
                   locality`` student from the natural-order cora teacher,
                   the production setting relabeled (cora, teacher and
                   student), the RCM cora artifact served on the card and
                   the CPU. Then, after the path's counters are read, the
                   hybrid's tiles and the min_tile_edges 0 tiles against
                   ``spmm_tiles_apply_plain`` (fp32 and bf16 x), B1's
                   forward at D=256 on each order's CSR and B5's times
                   (the hybrid beside B1 and ``torch.sparse.mm``, its
                   residual segment sum alone, and ``spmm_tiles_apply`` at
                   min_tile_edges 0).
13. dp          -- the data-parallel path (``--num_devices``): (a) a world
                   of one rank over NCCL on ``cuda:0`` through the trainers'
                   ``world``, one epoch each of the collab SAGE teacher at
                   full width (fp32, bf16), the weighted GCN teacher (bf16)
                   and the collab student, against the single path: losses,
                   parameters and the generator bit for bit (else held at
                   2e-4 with the gap logged) and the same B1 launches
                   (``dp_world1:`` lines, both epoch times, the bytes summed
                   a step); (b) two ranks on the one card over gloo, the
                   collab teacher's first 4 steps (fp32) and a cora student
                   epoch against one card at rtol 2e-4, atol 2e-5, the
                   ranks' parameters equal bit for bit (``dp_gloo:``); (c)
                   with two cards, ``train_teacher --num_devices 2`` on
                   collab over NCCL (else a ``dp_cli:`` skip line); then
                   B1 over rank 0's half of the collab edges (forward and
                   backward fp32, forward bf16 -> fp32, weighted bf16 ->
                   fp32) against ``segsum_plain`` over the same CSR and
                   timed, entries of the kernels line.
14. halo        -- the node-sharded path (``--sharding halo``): (a) a world
                   of one rank over NCCL on ``cuda:0``, two epochs each in
                   turns with the single path, of the collab SAGE teacher
                   at full width (fp32, bf16), the weighted GCN teacher
                   (bf16) and the collab table student (minibatch): losses,
                   parameters, buffers and the generator bit for bit and
                   the same B1 launches (``halo_world1:``); the halo
                   evaluator at a world of one equal to the single path's,
                   with its B3 launches (``halo_eval:``); (b) two ranks on
                   the one card over gloo: the collab halo teacher's first
                   4 steps (fp32, dropout 0) against one card at rtol 2e-4,
                   atol 2e-5, its parameters within lr a step, and the
                   cora table student bit for bit against the dp minibatch
                   student (``halo_gloo:``); the rows and bytes a step
                   exchanges and each rank's peak memory (``halo_bytes:``);
                   (c) with two cards, ``train_teacher --num_devices 2
                   --sharding halo`` on collab (else a ``halo_cli:`` skip
                   line); then B1 over rank 0 of 2's halo plan (local and
                   remote, forward and backward, the owner scatter; bf16 ->
                   fp32 and weighted) against ``segsum_plain`` and timed,
                   entries of the kernels line.
15. shard       -- the node-sharded serving daemon (``--shard``) at the
                   serve phase's collab table (235,868 x 256 re-encoded on
                   the card, the 256-wide 'mlp' head), Q=256 queries, k=10
                   and 50, 1,024 pairs: (a) ``ShardedServingState`` at a
                   world of one over NCCL (the sharded path: the query
                   rows' all-reduce, the scan with its offset, the score's
                   row exchange) against ``ServingState``, fp32,
                   bf16 compute, int8 and int4, top-K and pair scores bit
                   for bit with the same retrieval (B4) and pair-scorer
                   (B3) launches (``shard_world1:``); (b) two ranks on the
                   one card over gloo, each holding its rows alone
                   (``shard_gloo:``, each rank's bytes in use after set-up);
                   (c) ``cli.serve --shard`` over HTTP in a process of its
                   own against the single daemon: top-K, scores, a 400 for
                   an id >= N, and a SIGTERM that leaves no rank process
                   (``shard_daemon:``; with two cards its ranks span them,
                   else a ``shard_cards:`` skip line); (d)
                   ``sharded_hits_auc`` at collab's eval size (46,329
                   positives, 100,000 negatives) at a world of one and over
                   two gloo ranks against ``hits_at_k``/``roc_auc``
                   (``hits_auc:``); (e) ``measure_scaling_global`` at a
                   world of one on the card at the collab stand-in's size
                   (235,868 nodes, 128 features, hidden 256, batch 65,536)
                   and two ``multihost`` processes of one CPU rank each,
                   which show the harness runs across hosts
                   (``multihost:``); then B4 over rank
                   0's half of the table at Q=256 in the four table kinds
                   against ``mlp_block_logits_plain`` and timed, and the
                   blocked scan over rank 1's half (global ids, the self
                   pairs masked) against a plain top-K, entries of the
                   kernels line.
16. kernels     -- one JSON line: each kernel's launches on the serving,
                   training, student, production, tooling, reorder, dp, halo and shard paths, its
                   time at the collab shapes, the plain version's time, a
                   library call's time where one exists, and the least time
                   the card could take. A ``top_k_partners:`` line gives the
                   fused and unfused top-K times at Q=256 over collab, fp32
                   and bf16, from dense and int8 tables. ``ba_segsum:``
                   times segsum on the power-law graph beside
                   ``torch.sparse.mm`` (and without its heavy-first order),
                   ``segsum_l2:`` the D=256 forward's edge count gathered
                   from a table that fits L2; ``sddmm_small:`` SDDMM at 700
                   and 2,048 pairs. ``gather_bwd:`` times the gathers'
                   backward three ways (``gather_rows`` through segsum,
                   ``index_add_``, ``index_add_`` under deterministic
                   algorithms) at the teacher's, the student's and the
                   10M teacher's shapes. ``relu_dropout:`` times the
                   ReLU-dropout kernel at the collab teacher's two sites,
                   fp32 and bf16, with and without the addend, beside its
                   byte bound, the draw, and the plain composition.

After each phase a ``memory:`` line gives the card's bytes in use, the
phase's peak (``llp_tpu_torch.utils.memory``; the peak is reset before
each phase) and the card's memory.

The last line is ``{"ok": true, "device": {...}}``. Without CUDA, or outside
a checkout, the script exits 1 and prints no result.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import io
import json
import subprocess
import sys
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
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
# tensor cores, and bf16 and TF32 on the tensor cores (dense). A bf16
# input's bound is held to the bf16 peak; the retrieval kernel's bf16 route
# runs on the tensor cores in bf16, the pair scorer's W1 product in TF32.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
TF32_FLOP_PER_S = 495e12

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


def _demangle(names) -> dict:
    """C++ names of mangled kernel symbols (c++filt), or the symbols as given."""
    import shutil

    names = sorted(set(names))
    if not names or not shutil.which("c++filt"):
        return {n: n for n in names}
    out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True, text=True,
                         timeout=60).stdout.splitlines()
    return dict(zip(names, out)) if len(out) == len(names) else {n: n for n in names}


def _ptxas_resources(log_text: str) -> dict:
    """Registers, static shared memory and spill bytes of each kernel that
    ``nvcc -Xptxas -v`` reports (dynamic shared memory is the launch's)."""
    import re

    out, fn = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
            out[fn] = {}
        elif fn and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            out[fn].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        elif fn and (m := re.search(r"Used (\d+) registers", line)):
            out[fn]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            out[fn]["static_smem"] = int(sm.group(1)) if sm else 0
    names = _demangle(out)
    return {names[k]: v for k, v in out.items()}


def _sass_counts(path, opcodes=("HMMA", "HGMMA")) -> dict:
    """Per kernel of a built library, the count of each opcode in its SASS
    (``cuobjdump -sass``)."""
    import os
    import re
    import shutil

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = dict.fromkeys(opcodes, 0)
        elif fn:
            for op in opcodes:
                if re.search(rf"\b{op}\.", line):
                    counts[fn][op] += 1
    names = _demangle(counts)
    return {names[k]: v for k, v in counts.items()}


def phase_build() -> None:
    """Build every kernel; log each kernel's registers, spills and shared
    memory (ptxas) and the tensor-core instructions (SASS) of the retrieval
    kernel's tensor-core route and of the pair scorer, which must be there
    for every instance of both."""
    from llp_tpu_torch.data import native
    from llp_tpu_torch.ops.build import build_all, library_path

    t0 = time.perf_counter()
    report = build_all()
    for name, r in report.items():
        for fn, res in _ptxas_resources(r["ptxas"]).items():
            log(f"ptxas[{name}]", {"kernel": fn, **res})
    for lib, kernel, instances in (("mlp_topk", "mlp_mma_kernel", 2),
                                   ("sddmm", "sddmm_tc_kernel", 2)):
        sass = _sass_counts(library_path(lib))
        for fn, c in sass.items():
            log(f"sass[{lib}]", {"kernel": fn, **c})
        mma = {fn: c for fn, c in sass.items() if kernel in fn}
        if len(mma) != instances or any(not c["HMMA"] + c["HGMMA"] for c in mma.values()):
            raise AssertionError(f"{lib}: the tensor-core route's kernels hold no HMMA: {mma}")
    # the host partitioner of --reorder locality (g++); its numpy fallback
    # would take hours on the collab stand-in
    cached = native.library_path().exists()
    t = time.perf_counter()
    if not native.native_available():
        raise AssertionError("the host partitioner (csrc/partition.cpp) did not build: no g++")
    log("build", {"seconds": time.perf_counter() - t0,
                  "kernels": {n: {"seconds": r["seconds"], "cached": r["cached"]}
                              for n, r in report.items()},
                  "partitioner": {"library": native.library_path().name, "cached": cached,
                                  "seconds": time.perf_counter() - t}})


def _check_graph(n: int, e: int, hub_deg: int, isolated: int, seed: int):
    """A random graph whose last ``isolated`` nodes receive nothing and whose
    node 7 receives ``hub_deg`` edges."""
    import numpy as np

    from llp_tpu_torch.core.graph import build_graph

    rng = np.random.default_rng(seed)
    send = rng.integers(0, n, e + hub_deg)
    recv = np.concatenate([rng.integers(0, n - isolated, e), np.full(hub_deg, 7)])
    return build_graph(np.stack([send, recv]), n, device="cuda")


@functools.cache
def _ba_graph():
    """The collab-sized power-law graph of B1's checks and timing, on the
    card: ``ba_graph(235_868, 5)``, both directions, 2,358,206 edges, hub
    rows of in-degree up to 1,610 (made once a run, about 8 s of host
    time)."""
    from llp_tpu_torch.core.graph import build_graph
    from llp_tpu_torch.data.synthetic import ba_graph

    return build_graph(ba_graph(235_868, 5), 235_868, device="cuda")


def phase_kernel_check(gen) -> dict:
    """Each kernel against its plain version on the card; returns the
    largest abs error per kernel, instance and direction."""
    import numpy as np
    import torch

    from llp_tpu_torch.data.registry import get_dataset
    from llp_tpu_torch.core.graph import build_graph
    from llp_tpu_torch.models.predictor import LinkPredictor
    from llp_tpu_torch.ops.sddmm import (
        gather_route,
        head_weights,
        sddmm_mlp_score,
        sddmm_mlp_score_plain,
        split_w1,
        split_w1_plain,
    )
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

    def exact(n, d):
        """Multiples of 1/256 in [-4, 4]: they and their bf16 roundings sum
        exactly in fp32 in any order (the partial sums stay far below 2^16)."""
        return torch.randint(-1024, 1025, (n, d), generator=gen, device="cuda").float() / 256

    def backward_case(label, graph, d, reduces=("sum", "mean"), exact_values=False):
        for dtype, key in ((torch.float32, "spmm_bwd"), (torch.bfloat16, "spmm_bwd_bf16")):
            if exact_values:
                x, g = exact(graph.num_nodes, d).to(dtype), exact(graph.num_nodes, d).to(dtype)
            else:
                x = torch.randn(graph.num_nodes, d, generator=gen, device="cuda").to(dtype)
                g = torch.randn(graph.num_nodes, d, generator=gen, device="cuda").to(dtype)
            for reduce in reduces:
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

    def weighted_backward_case(label, graph, x32, w, reduces=("sum", "mean"),
                               exact_values=False):
        """torch.autograd.grad through the weighted route against the plain
        backward (dx) and the plain edge dots (dw)."""
        for dtype, key in ((torch.float32, "spmm_bwd_w"), (torch.bfloat16, "spmm_bwd_w_bf16")):
            d = x32.shape[1]
            x = x32.to(dtype).requires_grad_(True)
            g = (exact(graph.num_nodes, d) if exact_values
                 else torch.randn(graph.num_nodes, d, generator=gen, device="cuda")).to(dtype)
            wt = w.clone().requires_grad_(True)
            for reduce in reduces:
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
        x = exact(g.num_nodes, d)
        segsum_case("hub+isolated", g, x)
        backward_case("hub+isolated", g, d)
    for d in (1, 37, 128, 256, 1433):
        x = exact(g.num_nodes, d)
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
            collab = gs
    # The collab-sized power-law graph: every instance, both directions, at
    # D=256 (the vector path) and D=37 (the scalar path). Its hub rows sum
    # 1,610 terms, so the features and weights are the exact ones of the hub
    # check above; the backward runs the sum, whose kernel call is the
    # mean's (the backward's scale is applied before the kernel).
    gb = _ba_graph()
    wb = torch.randint(-16, 17, (gb.num_edges,), generator=gen, device="cuda").float() / 8
    wb[::7] = 0.0
    heavy_before = segsum.heavy_first_launches
    for d in (256, 37):
        x = exact(gb.num_nodes, d)
        segsum_case("ba", gb, x)
        backward_case("ba", gb, d, reduces=("sum",), exact_values=True)
        weighted_case("ba", gb, x, wb)
        weighted_backward_case("ba", gb, x, wb, reduces=("sum",), exact_values=True)
    # its hub rows ran first, in every launch over it
    heavy = segsum.heavy_first_launches - heavy_before
    if heavy < 20:
        raise AssertionError(f"segsum ba: {heavy} launches ran the heavy rows first")
    log("kernel_check", {"kernel": "segsum_heavy_first", "case": "ba", "launches": heavy})
    # Two launches on the same inputs give the same bits, in every instance
    # and both directions, over hub rows and the collab graph, with Gaussian
    # features whose sums show their order in the low bits.
    repeats = 0
    for name, gr in (("ba", gb), ("collab", collab)):
        x = torch.randn(gr.num_nodes, 256, generator=gen, device="cuda")
        wr = torch.rand(gr.num_edges, generator=gen, device="cuda")
        for inst, inp, kw in (("float32->float32", x, {}),
                              ("bfloat16->float32", x.bfloat16(), {"out_dtype": torch.float32}),
                              ("bfloat16->bfloat16", x.bfloat16(), {}),
                              ("weighted float32->float32", x, {"weights": wr}),
                              ("weighted bfloat16->bfloat16", x.bfloat16(), {"weights": wr})):
            for direction, idx, ptr, sc in (("fwd", gr.senders, gr.in_ptr, gr.inv_in_degree),
                                            ("bwd", gr.col, gr.row_ptr, None)):
                first, second = (segsum(inp, idx, ptr, sc, **kw) for _ in range(2))
                if not torch.equal(first, second):
                    raise AssertionError(f"segsum {inst} {direction} {name}: two launches on "
                                         f"the same inputs differ")
                repeats += 1

    def sddmm_case(n, d, hid, b, misaligned=False):
        head = LinkPredictor("mlp", d, hid, generator=torch.Generator().manual_seed(d + hid))
        w = [t.cuda() for t in head_weights(head.lins)]
        table = torch.randn(n * d + 1, generator=gen, device="cuda")
        # misaligned: the table starts 4 bytes into its allocation
        table = table[1:] if misaligned else table[:-1]
        table = table.view(n, d)
        src = torch.randint(0, n, (b,), generator=gen, device="cuda")
        dst = torch.randint(0, n, (b,), generator=gen, device="cuda")
        route = gather_route(table, table)
        before = sddmm_mlp_score.launch_counts[(route, d, hid)]
        got = sddmm_mlp_score(table, table, src, dst, *w)
        torch.cuda.synchronize()
        if sddmm_mlp_score.launch_counts[(route, d, hid)] != before + 1:
            raise AssertionError(f"sddmm: the kernel did not launch on route {route}")
        if (route == "tensor_cores.gather16B") != (d % 4 == 0 and not misaligned):
            raise AssertionError(f"sddmm d={d}: route {route}")
        err = compare(got, sddmm_mlp_score_plain(table, table, src, dst, *w),
                      **SDDMM_TOL, what=f"sddmm d={d} h={hid} b={b} {route}")
        worst["sddmm"] = max(worst["sddmm"], err["max_abs"])
        log("kernel_check", {"kernel": "sddmm", "route": route, "n": n, "d": d, "h": hid,
                             "b": b, **err, **SDDMM_TOL})

    for b in (1, 700, 2048, 1 << 20):
        sddmm_case(235_868, 256, 256, b)
    sddmm_case(5_000, 100, 100, 700)     # D, H not multiples of 8 (nor 128)
    sddmm_case(5_000, 37, 70, 2048)      # D % 4 != 0: the 4-byte gathers; one warp of units
    sddmm_case(5_000, 512, 128, 700)     # 16 feature steps, half the units padding
    sddmm_case(5_000, 2048, 300, 700)    # H > 256: two passes over the features
    sddmm_case(5_000, 1813, 70, 2048)    # a ragged last feature step, 4-byte gathers
    sddmm_case(5_000, 256, 257, 129)     # H one past a pass; B one past a 128-pair tile
    sddmm_case(5_000, 36, 8, 127)        # D a multiple of 4, not of 32; B under one tile
    sddmm_case(5_000, 3, 1, 300)         # D = 3, H = 1
    sddmm_case(5_000, 256, 256, 1000, misaligned=True)  # 4-byte gathers at D = 256
    # two launches on the same inputs give the same bits
    head = LinkPredictor("mlp", 256, 256, generator=torch.Generator().manual_seed(1))
    w = [t.cuda() for t in head_weights(head.lins)]
    table = torch.randn(235_868, 256, generator=gen, device="cuda")
    src, dst = (torch.randint(0, 235_868, (1 << 20,), generator=gen, device="cuda")
                for _ in range(2))
    if not torch.equal(sddmm_mlp_score(table, table, src, dst, *w),
                       sddmm_mlp_score(table, table, src, dst, *w)):
        raise AssertionError("sddmm: two launches on the same inputs differ")
    log("kernel_check", {"kernel": "repeat", "segsum_pairs_equal": repeats,
                         "sddmm_pairs_equal": 1})
    # W1's split as the kernel writes it, bit for bit its plain layout
    for d, hid in ((256, 256), (100, 100), (37, 70), (2048, 300), (256, 257), (3, 1)):
        w1 = torch.randn(d, hid, generator=gen, device="cuda")
        if not torch.equal(split_w1(w1), split_w1_plain(w1)):
            raise AssertionError(f"sddmm split_w1 d={d} h={hid}: the kernel's split differs "
                                 f"from split_w1_plain")
    log("kernel_check", {"kernel": "sddmm_split_w1", "cases": 6, "equal": True})
    _check_route_refusals(head, gen)
    worst.update(mlp_topk_check(gen))
    worst.update(spmm_tiles_check(gen))
    worst.update(gather_check(gen))
    worst.update(relu_dropout_check(gen))
    relu_dropout_launch_check()
    return worst


# The gathers' backward at the main path's shapes: (label, rows of h, ids,
# width, types).  The teacher's step gathers the predictor's pair ends
# [src; dst] (2 x 65,536 positives and as many negatives) from the
# 235,868 x 256 embedding in one call; the student's full-batch step
# gathers a node batch's 13 rows (anchor and 12 contexts) and the pair ends
# (the weighted collab export: 18 steps, a node batch of 13,452), and its
# rank loss the 66 context pairs' columns of the (node batch, 12) scores,
# as rows of the transpose (fp32 scores in either compute type); the 10M
# teacher the 4 x 2^19 pair ends from its 10,000,000 x 128 layer-2 rows.
GATHER_SHAPES = (("teacher", 235_868, 4 * 65_536, 256, ("float32", "bfloat16")),
                 ("student", 235_868, 13 * 13_452 + 4 * 65_536, 256, ("float32", "bfloat16")),
                 ("student_rank", 12, 66, 13_452, ("float32",)),
                 ("scale10m", 10_000_000, 4 << 19, 128, ("float32", "bfloat16")))


def _gather_ids(gen, label: str, n: int, k: int):
    """The ids of a :data:`GATHER_SHAPES` case: the rank loss's first pair
    column; uniform at 10M rows (the SBM's pairs and uniform negatives hit
    no row often); else half uniform and half over 128 hub rows (1,024 to
    1,707 repeats each, past the heavy-row threshold)."""
    import torch

    from llp_tpu_torch.train.student import pair_table

    if label == "student_rank":
        return pair_table(12)[0].cuda()
    if label == "scale10m":
        return torch.randint(0, n, (k,), generator=gen, device="cuda")
    return torch.cat([torch.randint(0, n, (k - k // 2,), generator=gen, device="cuda"),
                      torch.randint(0, 128, (k // 2,), generator=gen, device="cuda")])


def _gather_err_key(label: str, dtype: str) -> str:
    """The ``worst`` entry a :data:`GATHER_SHAPES` case's error goes to."""
    return ("gather_bwd" + ("" if dtype == "float32" else "_bf16")
            + ("_10m" if label == "scale10m" else ""))


def gather_check(gen) -> dict:
    """``gather_rows``' backward (the segment-sum kernel over the ids' CSR)
    at :data:`GATHER_SHAPES` and their types, against its plain version
    (``index_add_`` in fp32, one cast): equal bits, on cotangents of
    multiples of 1/16 in [-4, 4], which bf16 holds exactly and whose sums
    (a hub row's 1,707 terms included) fp32 holds exactly in any order, so
    that the kernel's ordered sum and the atomics' unordered one must agree
    to the bit; two backward passes give equal bits; the forward is
    ``index_select``."""
    import torch

    from llp_tpu_torch.ops.gather import gather_rows, gather_rows_backward_plain

    worst = {_gather_err_key(label, name): 0.0
             for label, *_, dtypes in GATHER_SHAPES for name in dtypes}
    for label, n, k, d, dtypes in GATHER_SHAPES:
        idx = _gather_ids(gen, label, n, k)
        for name in dtypes:
            dtype = getattr(torch, name)
            key = _gather_err_key(label, name)
            h = torch.randn(n, d, generator=gen, device="cuda").to(dtype).requires_grad_(True)
            g = (torch.randint(-64, 65, (idx.numel(), d), generator=gen, device="cuda").float()
                 / 16).to(dtype)
            grads = []
            for _ in range(2):
                before = gather_rows.launches
                out = gather_rows(h, idx)
                (dh,) = torch.autograd.grad(out, h, g)
                torch.cuda.synchronize()
                if gather_rows.launches != before + 1:
                    raise AssertionError(f"gather {label} {dtype}: the kernel did not launch")
                grads.append(dh)
            if not torch.equal(out, h.detach().index_select(0, idx)):
                raise AssertionError(f"gather {label} {dtype}: the forward is not index_select")
            if not torch.equal(*grads):
                raise AssertionError(f"gather {label} {dtype}: two backward passes differ")
            ref = gather_rows_backward_plain(g, idx, n)
            max_abs = float((grads[0].float() - ref.float()).abs().max())
            if not torch.equal(grads[0], ref):
                raise AssertionError(f"gather backward {label} {dtype} n={n} ids={idx.numel()} "
                                     f"d={d}: not the plain version's bits (max abs {max_abs})")
            worst[key] = max(worst[key], max_abs)
            log("kernel_check", {"kernel": key, "case": label, "n": n, "ids": idx.numel(),
                                 "d": d, "repeat_equal": True, "equal_to_plain": True,
                                 "max_abs": max_abs})
    return worst


# The dropout sites of the collab teacher's step: the encoder's hidden layer
# (every node) and the 'mlp' head's (the products of the 2 x 65,536 pairs).
RELU_DROPOUT_SHAPES = (("encoder", 235_868, 256), ("head", 131_072, 256))


def _bits(t):
    """``t``'s bits as integers, so that equality also tells -0 from 0."""
    import torch

    return t.detach().view(torch.int16 if t.element_size() == 2 else torch.int32)


def relu_dropout_check(gen) -> dict:
    """``relu_dropout``'s kernel (``csrc/relu_dropout.cu``) against
    ``relu_dropout_plain`` at :data:`RELU_DROPOUT_SHAPES`, fp32 and bf16,
    with and without the addend, at rates 0.5, 0.1 and 0.15 (where fp32's
    1 / keep and the reciprocal of fp32 keep differ), and on a ragged view
    that starts inside a vector (the wrapper copies it to an aligned
    tensor): the forward, both gradients and the generator's state
    afterwards equal to the bit, one forward and one backward launch a
    call.  An input the kernel does not take (fp64, an addend of another
    type or shape) raises ValueError, and the entry points refuse an
    unaligned pointer.  Returns the largest abs error (0)."""
    import torch

    from llp_tpu_torch.ops.build import load_library
    from llp_tpu_torch.ops.rng import relu_dropout, relu_dropout_plain

    def run(fn, pre, addend, rate, cot):
        g = torch.Generator(device="cuda").manual_seed(1234)
        before = relu_dropout.launches, relu_dropout.backward_launches
        out = fn(pre, rate, g, addend=addend)
        grads = torch.autograd.grad(out, [t for t in (pre, addend) if t is not None], cot)
        torch.cuda.synchronize()
        return (out, grads, g.get_state(),
                (relu_dropout.launches - before[0], relu_dropout.backward_launches - before[1]))

    def check(label, pre, addend, rate, cot):
        got, ref = (run(fn, pre, addend, rate, cot) for fn in (relu_dropout, relu_dropout_plain))
        if got[3] != (1, 1) or ref[3] != (0, 0):
            raise AssertionError(f"relu_dropout {label}: launches {got[3]} (kernel), "
                                 f"{ref[3]} (plain)")
        for what, a, b in (("forward", got[0], ref[0]),
                           *((f"grad {i}", x, y) for i, (x, y) in enumerate(zip(got[1], ref[1])))):
            if not torch.equal(_bits(a), _bits(b)):
                raise AssertionError(f"relu_dropout {label} {what}: not the plain version's "
                                     f"bits ({int((_bits(a) != _bits(b)).sum())} differ)")
        if not torch.equal(got[2], ref[2]):
            raise AssertionError(f"relu_dropout {label}: the generator moved otherwise")
        kept = float((got[0] != 0).float().mean())
        log("kernel_check", {"kernel": "relu_dropout", "case": label, "equal_to_plain": True,
                             "nonzero_share": kept})

    for label, n, d in RELU_DROPOUT_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).removeprefix("torch.")
            x, a, cot = (torch.randn(n, d, generator=gen, device="cuda").to(dtype)
                         for _ in range(3))
            pre, addend = x.requires_grad_(True), a.requires_grad_(True)
            for with_addend in (False, True):
                for rate in (0.5, 0.1, 0.15):
                    check(f"{label} {name} addend={with_addend} rate={rate}", pre,
                          addend if with_addend else None, rate, cot)
            del x, a, cot, pre, addend
    base = torch.randn(999 * 37 + 1, generator=gen, device="cuda")
    view = base[1:].view(999, 37).requires_grad_(True)
    check("ragged unaligned fp32 rate=0.5", view, None, 0.5,
          torch.randn(999, 37, generator=gen, device="cuda"))

    pre = torch.randn(64, 8, generator=gen, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    for label, args in (("fp64", (pre.double(), None)),
                        ("bf16 addend to fp32", (pre, pre.bfloat16())),
                        ("addend of another shape", (pre, pre[:32]))):
        try:
            relu_dropout(args[0], 0.5, g, addend=args[1])
        except ValueError:
            continue
        raise AssertionError(f"relu_dropout {label}: no ValueError")
    fwd = load_library("relu_dropout")
    bwd = load_library("relu_dropout", "llp_relu_dropout_backward")
    out, mask = torch.empty_like(pre), torch.empty(pre.shape, dtype=torch.uint8, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    rc = (fwd(pre.data_ptr() + 4, None, pre.data_ptr(), out.data_ptr(), mask.data_ptr(),
              pre.numel() - 1, 0.5, 2.0, 0, stream),
          bwd(pre.data_ptr(), mask.data_ptr() + 1, out.data_ptr(), pre.numel() - 1, 2.0, 0,
              stream))
    if rc != (1, 1):
        raise AssertionError(f"relu_dropout: unaligned pointers gave {rc}, expected "
                             f"cudaErrorInvalidValue (1) from both entry points")
    log("kernel_check", {"kernel": "relu_dropout", "refused": ["fp64", "bf16 addend",
                                                               "addend shape", "unaligned"]})
    return {"relu_dropout": 0.0}


def relu_dropout_launch_check() -> dict:
    """The ReLU-dropout kernel's launches through the trainers on cora: 2
    forward and 2 backward a step of the SAGE teacher with an 'mlp' head at
    dropout 0.5 (the encoder's hidden layer and the head's), none in its
    eval; none a step of the MLP student at dropout 0 (the benchmark's
    student), nor in its eval."""
    import torch

    from llp_tpu_torch.ops.rng import relu_dropout
    from llp_tpu_torch.serve.engine import encode_graph_nodes
    from llp_tpu_torch.train.loop import evaluate_student, evaluate_teacher, prepare_transductive
    from llp_tpu_torch.train.student import StudentTrainer, init_student
    from llp_tpu_torch.train.teacher import TeacherTrainer, init_teacher
    from llp_tpu_torch.utils.config import TeacherConfig

    dev = torch.device("cuda")
    data = prepare_transductive(TeacherConfig(datasets="cora", dataset_dir=STANDINS), dev)
    din = data["x"].shape[1]

    def launches(fn):
        before = relu_dropout.launches, relu_dropout.backward_launches
        fn()
        torch.cuda.synchronize()
        return relu_dropout.launches - before[0], relu_dropout.backward_launches - before[1]

    teacher = init_teacher(encoder="sage", in_channels=din, hidden_channels=256, num_layers=2,
                           predictor_mode="mlp", dropout=0.5,
                           generator=torch.Generator().manual_seed(0)).to(dev)
    trainer = TeacherTrainer(teacher, data["graph"], data["x"], data["pos_edges"],
                             batch_size=1024, neg_mode="uniform")
    gen = torch.Generator(device=dev).manual_seed(0)
    counts = {"teacher_steps": trainer.steps,
              "teacher_epoch": launches(lambda: trainer.epoch(gen)),
              "teacher_eval": launches(lambda: evaluate_teacher(teacher, data, hits_ks=(50,),
                                                                x_aggs={}))}
    t_h = encode_graph_nodes(teacher["encoder"].eval(), data["graph"], data["x"])
    student = init_student(in_channels=din, hidden_channels=256, num_layers=2,
                           predictor_mode="mlp", dropout=0.0,
                           generator=torch.Generator().manual_seed(1)).to(dev)
    st = StudentTrainer(student, data["graph"], data["x"], t_h, teacher["predictor"],
                        data["pos_edges"], link_batch_size=1024, node_batch_size=256,
                        neg_mode="uniform", minibatch=True)
    counts.update(student_steps=st.steps, student_epoch=launches(lambda: st.epoch(gen)),
                  student_eval=launches(lambda: evaluate_student(student, data,
                                                                 hits_ks=(50,))))
    expected = {"teacher_epoch": (2 * trainer.steps, 2 * trainer.steps),
                "teacher_eval": (0, 0), "student_epoch": (0, 0), "student_eval": (0, 0)}
    wrong = {k: (counts[k], v) for k, v in expected.items() if counts[k] != v}
    if wrong:
        raise AssertionError(f"relu_dropout launches (read, expected): {wrong}")
    log("kernel_check", {"kernel": "relu_dropout_launches", **counts})
    return counts


def _check_route_refusals(head, gen) -> None:
    """The wrappers pick each kernel's path and count it; the C entry points
    refuse a pick that disagrees with the shape (cudaErrorInvalidValue, 1),
    so a route counter cannot name a path the kernel did not take."""
    import torch

    from llp_tpu_torch.ops.build import load_library
    from llp_tpu_torch.ops.sddmm import head_weights, split_w1
    from llp_tpu_torch.ops.segsum import index_int32

    stream = torch.cuda.current_stream().cuda_stream
    n = 64
    send = torch.randint(0, n, (4 * n,), generator=gen, device="cuda")
    ptr = torch.arange(n + 1, device="cuda") * 4
    seg = load_library("segsum")
    for d, vec in ((256, 0), (37, 1)):  # the vector path refused at D=37, scalar at 256
        x = torch.randn(n, d, generator=gen, device="cuda")
        out = torch.empty_like(x)
        rc = seg(x.data_ptr(), index_int32(send).data_ptr(), ptr.data_ptr(), None, None,
                 out.data_ptr(), n, d, 0, 0, vec, None, 0, 0, stream)
        if rc != 1:
            raise AssertionError(f"segsum d={d}: the entry took vec={vec} (rc {rc})")
    sd = load_library("sddmm")
    w1, b1, w2, b2 = (t.cuda() for t in head_weights(head.lins))
    ws = split_w1(w1)
    table = torch.randn(n, 256, generator=gen, device="cuda")
    out = torch.empty(4 * n, device="cuda")
    rc = sd(table.data_ptr(), table.data_ptr(), send.data_ptr(), send.data_ptr(),
            w1.data_ptr(), ws.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            out.data_ptr(), 4 * n, 256, 256, 0, stream)
    if rc != 1:
        raise AssertionError(f"sddmm: the entry took 4-byte gathers at D=256 (rc {rc})")
    torch.cuda.synchronize()
    log("kernel_check", {"kernel": "route_refusals", "segsum": 2, "sddmm": 1})


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
    ragged Q and B, heads of 2 to 4 layers, and the collab serving shape; bf16
    on the tensor-core route wherever ``mma_supported`` says so, and on the
    SIMT route for the wider heads."""
    import torch

    from llp_tpu_torch.ops.mlp_topk import (
        bf16_tolerance,
        mlp_block_logits,
        mlp_block_logits_plain,
        mma_supported,
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
        # Q = 1 and B off the 64-candidate tile, 2 to 4 layers (bf16: the
        # tensor-core route, its passes of 256 units and its activations)
        ((256, 256, 1), 1, 1000),
        ((128, 128, 128, 1), 1, 777),
        ((64, 320, 1), 1, 150),         # 320 units: two passes
        ((64, 96, 80, 48, 1), 1, 130),
        ((128, 256, 256, 1), 1, 301),   # bf16 too wide for the tensor cores: SIMT
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
                before = mlp_block_logits.launches, mlp_block_logits.tensor_core_launches
                got = mlp_block_logits(lins, q_h, cand, scales=scales)
                torch.cuda.synchronize()
                mma = dt == torch.bfloat16 and mma_supported(dims)
                if (mlp_block_logits.launches, mlp_block_logits.tensor_core_launches) != (
                        before[0] + 1, before[1] + mma):
                    raise AssertionError(f"mlp_topk {tag} {kind}: the kernel did not launch "
                                         f"on the {'tensor-core' if mma else 'SIMT'} route")
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
                log("kernel_check", {"kernel": key, "dims": dims, "q": q, "b": b,
                                     "route": "tensor cores" if mma else "SIMT", **err, **tol})
    return worst


def _banded_graph(n: int, e: int, band: int, isolated: int, seed: int):
    """Senders within ``band`` ids of their receiver (modulo n, so no node
    sends far more than the mean), so tiles near the diagonal fill and hold
    several chunks; the last ``isolated`` nodes receive nothing (whole row
    blocks with no chunk); parallel edges occur."""
    import numpy as np

    from llp_tpu_torch.core.graph import build_graph

    rng = np.random.default_rng(seed)
    recv = rng.integers(0, n - isolated, e)
    send = (recv + rng.integers(-band, band + 1, e)) % n
    return build_graph(np.stack([send, recv]), n, device="cuda")


def spmm_tiles_check(gen) -> dict:
    """The tile SpMM kernel (B5) in its four instances (fp32 or bf16 x,
    unweighted or weighted tiles) against ``spmm_tiles_apply_plain``, on a
    graph with a hub row and isolated receivers and on a banded one, with
    ``min_tile_edges`` 0 and 16, at D = 64, 128, 256 and 37; a row block of
    at least 500 chunks and one of exactly one; the hybrid ``spmm_tiles``
    forward and backward (sum and mean; the residual through segsum) against
    the plain segment sum and the plain backward; the empty tile set."""
    import numpy as np
    import torch

    from llp_tpu_torch.data.tiles import build_tiles, tile_fill
    from llp_tpu_torch.ops.segsum import segsum, segsum_plain
    from llp_tpu_torch.ops.spmm import spmm_backward_plain
    from llp_tpu_torch.ops.spmm_tiles import spmm_tiles, spmm_tiles_apply, spmm_tiles_apply_plain

    worst = {k: 0.0 for k in ("spmm_tiles_f32", "spmm_tiles_bf16", "spmm_tiles_w_f32",
                              "spmm_tiles_w_bf16", "spmm_tiles_hybrid",
                              "spmm_tiles_hybrid_bf16", "spmm_tiles_hybrid_bwd")}
    graphs = {"hub+isolated": _check_graph(50_000, 200_000, 12_000, 5_000, seed=0),
              "banded": _banded_graph(20_000, 600_000, 150, 1_000, seed=1)}
    for label, g in graphs.items():
        n = g.num_nodes
        send, recv = g.senders.cpu().numpy(), g.receivers.cpu().numpy()
        # weights: multiples of 1/8 in [-2, 2], a seventh of them 0
        w = np.random.default_rng(2).integers(-16, 17, g.num_edges).astype(np.float32) / 8
        w[::7] = 0.0
        for min_edges in (0, 16):
            for weighted in (False, True):
                tiles = build_tiles(recv, send, n, w if weighted else None,
                                    min_tile_edges=min_edges, device="cuda")[0]
                fill = tile_fill(tiles)
                for d in (64, 128, 256, 37):
                    # multiples of 1/256 in [-4, 4]: their bf16 roundings too, so
                    # the sums of x are exact in fp32 in any order
                    x = torch.randint(-1024, 1025, (n, d), generator=gen,
                                      device="cuda").float() / 256
                    for xt, tag in ((x, "f32"), (x.bfloat16(), "bf16")):
                        key = f"spmm_tiles{'_w' if weighted else ''}_{tag}"
                        before = spmm_tiles_apply.launches
                        got = spmm_tiles_apply(tiles, xt, n)
                        torch.cuda.synchronize()
                        if spmm_tiles_apply.launches != before + 1:
                            raise AssertionError(f"{key} {label}: the kernel did not launch")
                        ref = spmm_tiles_apply_plain(tiles, xt, n)
                        err = compare(got, ref, **SEGSUM_TOL,
                                      what=f"{key} {label} min={min_edges} d={d}")
                        worst[key] = max(worst[key], err["max_abs"])
                        log("kernel_check", {"kernel": key, "case": label,
                                             "min_tile_edges": min_edges, "n": n,
                                             "e": g.num_edges, "d": d, **fill, **err})
        # the hybrid: tiles of >= 16 edges through the kernel, the rest residual
        for d in (256, 37):
            # exact multiples again: the hub row's 12,000-term sums agree in
            # any order (the hybrid sums tiles, then the residual)
            x, gout = (torch.randint(-1024, 1025, (n, d), generator=gen,
                                     device="cuda").float() / 256 for _ in range(2))
            for reduce in ("sum", "mean"):
                scale = g.inv_in_degree if reduce == "mean" else None
                xr = x.clone().requires_grad_(True)
                residuals = sum(bool(t.res_send.numel()) for t in g.hybrid_tiles)
                before = (spmm_tiles_apply.launches, spmm_tiles.backward_launches,
                          segsum.launches)
                out = spmm_tiles(g, xr, reduce)
                (dx,) = torch.autograd.grad(out, xr, gout)
                torch.cuda.synchronize()
                if (spmm_tiles_apply.launches, spmm_tiles.backward_launches,
                        segsum.launches) != (before[0] + 2, before[1] + 1,
                                             before[2] + residuals):
                    raise AssertionError(f"spmm_tiles {label} {reduce}: expected one forward "
                                         f"and one backward launch, and segsum once per "
                                         f"residual ({residuals})")
                what = f"spmm_tiles hybrid {label} d={d} {reduce}"
                err = compare(out, segsum_plain(x, g.senders, g.in_ptr, scale), **SEGSUM_TOL,
                              what=what)
                bwd = compare(dx, spmm_backward_plain(g, gout, reduce), **SEGSUM_TOL,
                              what=f"{what} backward")
                xb = x.bfloat16()
                got16 = spmm_tiles(g, xb, reduce)
                err16 = compare_bf16(got16, segsum_plain(xb.float(), g.senders, g.in_ptr,
                                                         scale).bfloat16(),
                                     **BF16_TOL, what=f"{what} bf16")
                worst["spmm_tiles_hybrid"] = max(worst["spmm_tiles_hybrid"], err["max_abs"])
                worst["spmm_tiles_hybrid_bwd"] = max(worst["spmm_tiles_hybrid_bwd"],
                                                     bwd["max_abs"])
                worst["spmm_tiles_hybrid_bf16"] = max(worst["spmm_tiles_hybrid_bf16"],
                                                      err16["max_abs"])
                log("kernel_check", {"kernel": "spmm_tiles_hybrid", "case": label,
                                     "reduce": reduce, "n": n, "e": g.num_edges, "d": d,
                                     **err, "backward": bwd, "bf16": err16})
    # row block 0 receives from every tile column (>= 500 chunks, and
    # thousands of valid slots: several of the kernel's 1,024-slot batches);
    # row block 1 holds exactly one chunk
    rng = np.random.default_rng(3)
    n = 100_000
    recv = np.concatenate([rng.integers(0, 128, 80_000), np.full(5, 130),
                           rng.integers(256, n, 200_000)])
    send = np.concatenate([rng.integers(0, n, 80_000), rng.integers(384, 512, 5),
                           rng.integers(0, n, 200_000)])
    w = rng.integers(-16, 17, recv.size).astype(np.float32) / 8
    for weighted in (False, True):
        tiles = build_tiles(recv, send, n, w if weighted else None, device="cuda")[0]
        chunks = (tiles.block_ptr[1:] - tiles.block_ptr[:-1]).tolist()
        if chunks[0] < 500 or chunks[1] != 1:
            raise AssertionError(f"spmm_tiles: row blocks 0 and 1 hold {chunks[:2]} chunks")
        for d in (256, 37):
            x = torch.randint(-1024, 1025, (n, d), generator=gen, device="cuda").float() / 256
            for xt, tag in ((x, "f32"), (x.bfloat16(), "bf16")):
                key = f"spmm_tiles{'_w' if weighted else ''}_{tag}"
                before = spmm_tiles_apply.launches
                got = spmm_tiles_apply(tiles, xt, n)
                torch.cuda.synchronize()
                if spmm_tiles_apply.launches != before + 1:
                    raise AssertionError(f"{key} many chunks: the kernel did not launch")
                err = compare(got, spmm_tiles_apply_plain(tiles, xt, n), **SEGSUM_TOL,
                              what=f"{key} many chunks d={d}")
                worst[key] = max(worst[key], err["max_abs"])
                log("kernel_check", {"kernel": key, "case": "row block of many chunks",
                                     "chunks_row_block_0": chunks[0],
                                     "chunks_row_block_1": chunks[1], "n": n,
                                     "e": int(recv.size), "d": d, **err})
    empty = build_tiles(np.zeros(0), np.zeros(0), 1000, device="cuda")[0]
    before = spmm_tiles_apply.launches
    got = spmm_tiles_apply(empty, torch.randn(1000, 64, generator=gen, device="cuda"), 1000)
    torch.cuda.synchronize()
    if spmm_tiles_apply.launches != before + 1 or bool(got.any()):
        raise AssertionError("spmm_tiles on the empty tile set: expected one launch and zeros")
    log("kernel_check", {"kernel": "spmm_tiles_f32", "case": "empty tile set", "zeros": True})
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
    _reset_gather_counts()
    segsum.launches = sddmm_mlp_score.launches = mlp_block_logits.launches = 0
    mlp_block_logits.tensor_core_launches = 0
    mlp_block_logits.launch_counts.clear()
    segsum.launch_counts.clear()
    segsum.route_counts.clear()
    segsum.heavy_first_launches = 0
    sddmm_mlp_score.launch_counts.clear()
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
                "heavy_first": segsum.heavy_first_launches,
                "sddmm_routes": _sddmm_routes(),
                "mlp_topk": dict(mlp_block_logits.launch_counts),
                "mlp_topk_tensor_core": mlp_block_logits.tensor_core_launches}
    for inst in (("float32", "dense"), ("float32", "int8"), ("bfloat16", "dense")):
        if not mlp_block_logits.launch_counts[inst]:
            raise AssertionError(f"mlp_topk {inst}: no launch on the serving path")
    if mlp_block_logits.tensor_core_launches != mlp_block_logits.launch_counts[
            ("bfloat16", "dense")]:
        raise AssertionError("mlp_topk: the bf16 top-K of the 256-wide head did not run on "
                             "the tensor-core route")

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


def _train(argv, student: bool = False) -> tuple[dict, dict, list]:
    """Run the teacher's (or the student's) training CLI; returns its stats,
    its report and its stdout."""
    if student:
        from llp_tpu_torch.cli.train_student import main
    else:
        from llp_tpu_torch.cli.train_teacher import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        stats, report = main(argv)
    return stats, report, buf.getvalue().splitlines()


def _counts() -> dict:
    """A snapshot of every launch counter."""
    from llp_tpu_torch.ops.gather import gather_rows
    from llp_tpu_torch.ops.rng import relu_dropout
    from llp_tpu_torch.ops.sddmm import sddmm_mlp_score
    from llp_tpu_torch.ops.segsum import segsum
    from llp_tpu_torch.ops.spmm import spmm

    return {"segsum": segsum.launches, "by_shape": dict(segsum.launch_counts),
            "gather": gather_rows.launches,
            "gather_by_width": dict(gather_rows.launch_counts),
            "routes": dict(segsum.route_counts),
            "heavy_first": segsum.heavy_first_launches,
            "backward": spmm.backward_launches,
            "weighted_backward": spmm.weighted_backward_launches,
            "sddmm": sddmm_mlp_score.launches,
            "sddmm_routes": dict(sddmm_mlp_score.launch_counts),
            "relu_dropout": (relu_dropout.launches, relu_dropout.backward_launches)}


def _reset_gather_counts() -> None:
    from llp_tpu_torch.ops.gather import gather_rows

    gather_rows.launches = 0
    gather_rows.launch_counts.clear()


def _sddmm_routes() -> dict:
    """The pair scorer's launches by route, D and H, since its counters were
    last cleared."""
    from llp_tpu_torch.ops.sddmm import sddmm_mlp_score

    return {f"{r} d={d} h={h}": n for (r, d, h), n in sddmm_mlp_score.launch_counts.items()}


def _shape_key(inst: str, d: int, weighted: bool) -> str:
    return f"{inst} d={d}{' weighted' if weighted else ''}"


def _width_key(dtype: str, d: int) -> str:
    return f"{dtype} d={d}"


def _delta(after: dict, before: dict) -> dict:
    shapes = {_shape_key(*key): n - before["by_shape"].get(key, 0)
              for key, n in after["by_shape"].items()}
    by_shape = {k: v for k, v in shapes.items() if v}
    weighted = sum(v for k, v in by_shape.items() if k.endswith(" weighted"))
    routes = {k: n - before["routes"].get(k, 0) for k, n in after["routes"].items()}
    sddmm_routes = {f"{route} d={d} h={h}": n - before["sddmm_routes"].get((route, d, h), 0)
                    for (route, d, h), n in after["sddmm_routes"].items()}
    return {"segsum": after["segsum"] - before["segsum"],
            "heavy_first": after["heavy_first"] - before["heavy_first"],
            "backward": after["backward"] - before["backward"],
            "gather": after["gather"] - before["gather"],
            "gather_by_width": {k: v for k, v in (
                (_width_key(*key), n - before["gather_by_width"].get(key, 0))
                for key, n in after["gather_by_width"].items()) if v},
            "weighted": weighted,
            "weighted_backward": after["weighted_backward"] - before["weighted_backward"],
            "sddmm": after["sddmm"] - before["sddmm"],
            "relu_dropout": [a - b for a, b in zip(after["relu_dropout"],
                                                   before["relu_dropout"])],
            "by_shape": by_shape,
            "routes": {k: v for k, v in routes.items() if v},
            "sddmm_routes": {k: v for k, v in sddmm_routes.items() if v}}


# The route of the evals' pair scores: the 256-wide tables and head of the
# runs here, through the tensor cores with 16-byte gathers.
SDDMM_EVAL_ROUTE = "tensor_cores.gather16B d=256 h=256"


def _check_sddmm_route(label: str, counts: dict) -> None:
    """Every pair score of the run went through the tensor-core route."""
    if counts["sddmm_routes"].get(SDDMM_EVAL_ROUTE, 0) != counts["sddmm"]:
        raise AssertionError(f"{label}: {counts['sddmm']} sddmm launches, by route "
                             f"{counts['sddmm_routes']}; expected all on {SDDMM_EVAL_ROUTE}")


TRAIN_FLAGS = ["--hidden_channels=256", "--num_layers=2", "--predictor=mlp",
               "--batch_size=65536", "--dropout=0.5", "--runs=1", "--eval_steps=1",
               "--log_steps=1", "--patience=100"]

# The training runs: (dataset, epochs, compute dtype, dataset directory,
# variant, save directory under WORK). The first three are the default SAGE
# teacher on the stand-ins; then the weighted collab export (SAGE, and GCN
# at both types), the GCN teacher on cora, and the SAGE teacher with the
# validation edges as input on cora and on the 20,000-node weighted export.
# The cora SAGE and weighted SAGE teachers, which the student phase distils
# from, have save directories of their own, so no later run overwrites them.
TRAIN_RUNS = (("cora", 20, "float32", STANDINS, "", "teacher_cora"),
              ("collab", 2, "float32", STANDINS, "", "saved"),
              ("collab", 2, "bfloat16", STANDINS, "", "saved"),
              ("collab", 2, "float32", WEIGHTED, "weighted sage", "teacher_weighted"),
              ("collab", 2, "float32", WEIGHTED, "weighted gcn", "saved"),
              ("collab", 2, "bfloat16", WEIGHTED, "weighted gcn", "saved"),
              ("cora", 20, "float32", STANDINS, "gcn", "saved"),
              ("cora", 5, "float32", STANDINS, "valedges", "saved_valedges"),
              ("collab", 2, "float32", WEIGHTED_SMALL, "weighted sage valedges",
               "saved_valedges"))


def _variant_flags(variant: str) -> list:
    return ((["--use_edge_weight"] if "weighted" in variant else [])
            + (["--encoder=gcn"] if "gcn" in variant else [])
            + (["--use_valedges_as_input"] if "valedges" in variant else []))


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


def _collab(dataset_dir: str, use_edge_weight: bool = False) -> dict:
    """The collab training data on the card (``prepare_transductive``)."""
    import torch

    from llp_tpu_torch.train.loop import prepare_transductive
    from llp_tpu_torch.utils.config import TeacherConfig

    return prepare_transductive(TeacherConfig(datasets="collab", dataset_dir=dataset_dir,
                                              use_edge_weight=use_edge_weight),
                                torch.device("cuda"))


def _profile_epoch(data: dict, compute_dtype: str, *, encoder: str = "sage") -> dict:
    """One collab teacher epoch over ``data`` (from :func:`_collab`) under
    ``torch.profiler`` after a warm-up epoch (:func:`_profile_trainer`)."""
    import torch

    from llp_tpu_torch.train.teacher import TeacherTrainer, init_teacher

    model = init_teacher(encoder=encoder, in_channels=data["x"].shape[1], hidden_channels=256,
                         num_layers=2, predictor_mode="mlp", dropout=0.5,
                         generator=torch.Generator().manual_seed(0)).cuda()
    trainer = TeacherTrainer(model, data["graph"], data["x"], data["pos_edges"],
                             encoder=encoder, batch_size=65536, neg_mode="uniform",
                             compute_dtype=compute_dtype)
    out = {"encoder": encoder, "weighted": data["graph"].edge_weight is not None,
           "compute_dtype": compute_dtype, **_profile_trainer(trainer)}
    log("train_profile", out)
    return out


def _profile_trainer(trainer) -> dict:
    """A warm-up epoch, a timed epoch (wall time, launch counters), then one
    under ``torch.profiler``: the device time by kernel, the kernels a step
    launches and the device's idle share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from llp_tpu_torch.tools.probes import ATOMIC_NAMES

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
    kernels = [ev for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0
               and not getattr(ev, "is_user_annotation", False)]
    by_kernel = {ev.key: ev.self_device_time_total / 1e3 for ev in kernels}
    device_ms = sum(by_kernel.values())
    segsum_ms = sum(v for k, v in by_kernel.items()
                    if "segsum_vec_kernel" in k or "segsum_scalar_kernel" in k)
    # kernels that add into a tensor with atomics (what made a step differ
    # from run to run): none once every gather's backward is gather_rows'
    atomic = {k: v for k, v in by_kernel.items() if any(a in k for a in ATOMIC_NAMES)}
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    steps = trainer.steps
    return {"steps": steps, "epoch_s": wall_s, "launches": counts,
            "launches_per_step": {k: v / steps for k, v in counts["by_shape"].items()},
            "kernels_per_step": sum(ev.count for ev in kernels) / steps if kernels
            else "not measured",
            "device_ms": device_ms if device_ms else "not measured",
            "segsum_ms": segsum_ms if device_ms else "not measured",
            # the unprofiled epoch's wall time against the profiled one's kernels
            "device_idle_share": 1 - device_ms / (wall_s * 1e3) if device_ms else "not measured",
            "atomic_kernels_ms": atomic if device_ms else "not measured",
            "top_kernels_ms": top}


def _check_train_launches(label: str, variant: str, dtype: str, counts: dict,
                          steps: int) -> None:
    """The kernels every step must have launched, from the run's counters."""
    if counts["gather"] < steps:
        raise AssertionError(f"{label}: {counts['gather']} gather backward launches in "
                             f"{steps} steps, expected one a step (the predictor's rows)")
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
    _check_sddmm_route(label, counts)
    # the steps' 256-wide aggregations, forward and backward, gather
    # 128-byte feature slices that stay in L2
    sliced = counts["routes"].get("vector128B", 0)
    if sliced < 2 * aggregations * steps:
        raise AssertionError(f"{label}: {sliced} segsum launches on 128-byte slices in {steps} "
                             f"steps, expected {2 * aggregations} a step (routes "
                             f"{counts['routes']})")
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


def _check_student_gathers(label: str, counts: dict, report: dict) -> None:
    """The student has no graph: its segsum launches are its gathers'
    backward (the rows of a full-batch step, the rank loss's context
    pairs), at least one a step, and nothing else."""
    steps = report["steps_per_epoch"] * len(report["epoch_s"])
    if counts["segsum"] != counts["gather"] or counts["gather"] < steps:
        raise AssertionError(f"{label}: {counts['segsum']} segsum launches, {counts['gather']} "
                             f"of them the gathers' backward, in {steps} steps (expected only "
                             f"those, at least one a step)")


# The train-mode dropout sites a step of the train and student phases' CLI
# runs (2 layers, an 'mlp' head of 2 layers, dropout 0.5): the teacher's
# encoder hidden layer and head; the student's encoder hidden layer and
# its head over the context pairs and over the link pairs.
TEACHER_DROPOUT_SITES = 2
STUDENT_DROPOUT_SITES = 3


def _check_relu_dropout_launches(label: str, counts: dict, steps: int, sites: int) -> None:
    """The ReLU-dropout kernel ran forward and backward at each of a step's
    ``sites`` dropout sites, and never in an eval."""
    expected = [sites * steps, sites * steps]
    if list(counts["relu_dropout"]) != expected:
        raise AssertionError(f"{label}: {counts['relu_dropout']} ReLU-dropout launches "
                             f"(forward, backward) in {steps} steps and their evals, "
                             f"expected {expected}")


def _check_valedges_launches(label: str, variant: str, counts: dict, steps: int,
                             evals: int, in_dim: int) -> None:
    """With the validation edges as input, segsum runs over both graphs: the
    layer-1 hoist once for the trainer and once per eval graph, and every
    eval encodes layer 2 over the train graph and over the train+valid one."""
    weighted = "weighted" in variant
    shapes = counts["by_shape"]
    hoists = shapes.get(_shape_key("float32->float32", in_dim, weighted), 0)
    # unweighted, the gathers' backward shares the fp32 instance at d=256
    backward = (counts["weighted_backward"] if weighted
                else counts["backward"] + counts["gather"])
    layer2 = shapes.get(_shape_key("float32->float32", 256, weighted), 0) - backward
    if hoists != 3 or layer2 != steps + 2 * evals:
        raise AssertionError(f"{label}: {hoists} layer-1 and {layer2} layer-2 forward "
                             f"launches, expected 3 and {steps} + 2 x {evals} (both graphs)")


def _serve_trained(ckpt: Path, expect_segsum: int) -> None:
    """Serve a trained cora artifact through the CLI on the card and on the
    CPU (re-encode, top-10 of 16 queries, 1,024 pairs); the answers agree."""
    import numpy as np

    from llp_tpu_torch.ops.segsum import segsum

    if not all(Path(f"{ckpt}{ext}").exists() for ext in (".npz", ".json")):
        raise AssertionError(f"the cora artifact {ckpt} was not written")
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

    from llp_tpu_torch.ops.rng import relu_dropout
    from llp_tpu_torch.ops.segsum import segsum
    from llp_tpu_torch.ops.sddmm import sddmm_mlp_score
    from llp_tpu_torch.ops.spmm import spmm

    results = WORK / "results"
    runs = {}
    # the training path starts here
    _reset_gather_counts()
    segsum.launches = spmm.backward_launches = sddmm_mlp_score.launches = 0
    spmm.weighted_backward_launches = 0
    relu_dropout.launches = relu_dropout.backward_launches = 0
    segsum.launch_counts.clear()
    segsum.route_counts.clear()
    segsum.heavy_first_launches = 0
    sddmm_mlp_score.launch_counts.clear()
    for name, epochs, dtype, data_dir, variant, save in TRAIN_RUNS:
        label = f"{name} {dtype} {variant or 'sage'}"
        before = _counts()
        stats, report, _ = _train([f"--datasets={name}", f"--epochs={epochs}",
                                   f"--compute_dtype={dtype}", f"--dataset_dir={data_dir}",
                                   f"--save_dir={WORK / save}", f"--results_dir={results}",
                                   *TRAIN_FLAGS, *_variant_flags(variant)])
        counts = _delta(_counts(), before)
        line = _train_line(name, dtype, variant, stats, report, counts)
        steps = report["steps_per_epoch"] * len(report["epoch_s"])
        if line["losses"][-1] >= line["losses"][0]:
            raise AssertionError(f"{label}: the loss did not fall: {line['losses']}")
        _check_train_launches(label, variant, dtype, counts, steps)
        _check_relu_dropout_launches(label, counts, steps, TEACHER_DROPOUT_SITES)
        if "valedges" in variant:
            _check_valedges_launches(label, variant, counts, steps, len(report["eval_s"]),
                                     1433 if name == "cora" else 128)
        runs[(name, dtype, variant)] = {"line": line, "counts": counts, "steps": steps}
    launches = {**_counts(), "sddmm_routes": _sddmm_routes()}

    _serve_trained(WORK / "teacher_cora" / "cora-sage_transductive", expect_segsum=2)
    _serve_trained(WORK / "saved" / "cora-gcn_transductive", expect_segsum=2)

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

    # the collab data, loaded once for the profiles here and the kernels phase
    data = {"collab": _collab(STANDINS), "weighted": _collab(WEIGHTED, use_edge_weight=True)}
    profiles = {dtype: _profile_epoch(data["collab"], dtype) for dtype in ("float32", "bfloat16")}
    profiles["weighted gcn"] = _profile_epoch(data["weighted"], "float32", encoder="gcn")
    profiles["weighted sage"] = _profile_epoch(data["weighted"], "float32")
    return {"runs": runs, "launches": launches, "profiles": profiles, "parity": parity,
            "data": data}


STUDENT_FLAGS = ["--hidden_channels=256", "--num_layers=2", "--predictor=mlp",
                 "--link_batch_size=65536", "--dropout=0.5", "--runs=1", "--eval_steps=1",
                 "--log_steps=1", "--patience=100", "--encoder=sage"]

# The student runs: (dataset, epochs, compute dtype, dataset directory, the
# teacher's save directory under WORK, flags). The default student (C = 12
# contexts, nb walks, LLP_D + LLP_R + 0.1 BCE) on cora from the cora SAGE
# teacher, then minibatch with rw walks and chunked LLP_R, then the KD_RM
# and KD_LM baselines; on the weighted collab export (without
# --use_edge_weight: the walks are uniform) from the weighted SAGE teacher,
# fp32, bf16 and minibatch.
STUDENT_RUNS = (("cora", 20, "float32", STANDINS, "teacher_cora", ()),
                ("cora", 20, "float32", STANDINS, "teacher_cora",
                 ("--minibatch", "--ps_method=rw", "--llp_r_chunk=16")),
                ("cora", 5, "float32", STANDINS, "teacher_cora", ("--KD_RM=0.3", "--KD_LM=0.3")),
                ("collab", 2, "float32", WEIGHTED, "teacher_weighted", ()),
                ("collab", 2, "bfloat16", WEIGHTED, "teacher_weighted", ()),
                ("collab", 2, "float32", WEIGHTED, "teacher_weighted", ("--minibatch",)))


def _student_line(name: str, dtype: str, flags, stats: dict, report: dict,
                  counts: dict) -> dict:
    import statistics

    metric = "Hits@50" if name == "collab" else "Hits@20"
    steady = report["epoch_s"][1:] or report["epoch_s"]
    line = {"dataset": name, "compute_dtype": dtype, "flags": list(flags),
            "epochs": len(report["epoch_s"]), "steps_per_epoch": report["steps_per_epoch"],
            "node_batch": report["node_batch"],
            "epoch_s": statistics.median(steady), "epoch_s_all": report["epoch_s"],
            "eval_s": report["perf"]["mean_eval_s"],
            "edges_per_s": report["perf"]["edges_per_sec"],
            "losses": report["losses"][0], "metric": metric,
            "valid": stats[metric]["valid"][0], "test": stats[metric]["test"][0],
            "launches": counts}
    log("student", line)
    return line


def _student_trainer(device: str, *, name: str, dataset_dir: str, teacher: str,
                     dropout: float, compute_dtype: str = "float32", **kw):
    """A full-width student (hidden 256, 2 layers, mlp head) and its trainer
    on ``device``, distilling from the teacher artifact at ``teacher``."""
    import numpy as np
    import torch

    from llp_tpu_torch.train.loop import prepare_transductive
    from llp_tpu_torch.train.student import StudentTrainer, init_student
    from llp_tpu_torch.utils.checkpoint import load_checkpoint
    from llp_tpu_torch.utils.config import StudentConfig
    from llp_tpu_torch.utils.params import from_jax

    cfg = StudentConfig(datasets=name, dataset_dir=dataset_dir)
    data = prepare_transductive(cfg, torch.device(device))
    ckpt, _ = load_checkpoint(teacher)
    t_h = torch.from_numpy(np.asarray(ckpt["features"], np.float32)).to(device)
    n, d = data["x"].shape
    model = init_student(in_channels=d, hidden_channels=256, num_layers=2, predictor_mode="mlp",
                         dropout=dropout, generator=torch.Generator().manual_seed(0))
    kw.setdefault("node_batch_size", cfg.coupled_node_batch_size(n, data["num_pos"]))
    return data, StudentTrainer(model.to(device), data["graph"], data["x"], t_h,
                                from_jax(ckpt["params"]["predictor"]), data["pos_edges"],
                                neg_mode=cfg.neg_mode, neg_keys=data["neg_keys"],
                                compute_dtype=compute_dtype, **kw)


def _student_parity_losses(device: str, contexts, steps: int = 3) -> list:
    """``steps`` single-step epochs of the cora student at full width,
    dropout 0, with fixed contexts and negatives drawn on the host."""
    import numpy as np
    import torch

    data, trainer = _student_trainer(
        device, name="cora", dataset_dir=STANDINS, dropout=0.0,
        teacher=str(WORK / "teacher_cora" / "cora-sage_transductive"),
        link_batch_size=65536, node_batch_size=2708)
    if trainer.steps != 1:
        raise AssertionError(f"cora student: {trainer.steps} steps per epoch, expected 1")
    negatives = np.random.default_rng(7).integers(0, 2708, (steps, 1, 2, trainer.batch))
    gen = torch.Generator(device=device).manual_seed(0)
    return [float(trainer.epoch(gen, negatives=torch.from_numpy(negatives[i]).to(device),
                                contexts=contexts.to(device))) for i in range(steps)]


def phase_student() -> dict:
    """Drive the student's training CLI on the card from the train phase's
    teachers, serve the cora student on the card and on the CPU, hold 3
    steps against the CPU and profile a collab student epoch; returns each
    run's launches, the kernels' launches on the student's path and the
    profile."""
    import numpy as np
    import torch

    from llp_tpu_torch.ops.mlp_topk import mlp_block_logits
    from llp_tpu_torch.ops.rng import relu_dropout
    from llp_tpu_torch.ops.sddmm import sddmm_mlp_score
    from llp_tpu_torch.ops.segsum import segsum
    from llp_tpu_torch.ops.spmm import spmm
    from llp_tpu_torch.sample.walk import sample_contexts
    from llp_tpu_torch.train.loop import prepare_transductive
    from llp_tpu_torch.utils.config import StudentConfig

    results = WORK / "results"
    runs = {}
    # the student's path starts here
    _reset_gather_counts()
    segsum.launches = spmm.backward_launches = sddmm_mlp_score.launches = 0
    spmm.weighted_backward_launches = mlp_block_logits.launches = 0
    relu_dropout.launches = relu_dropout.backward_launches = 0
    segsum.launch_counts.clear()
    segsum.route_counts.clear()
    segsum.heavy_first_launches = 0
    sddmm_mlp_score.launch_counts.clear()
    mlp_block_logits.launch_counts.clear()
    for i, (name, epochs, dtype, data_dir, teacher, flags) in enumerate(STUDENT_RUNS):
        label = f"student {name} {dtype} {' '.join(flags) or 'default'}"
        before = _counts()
        stats, report, _ = _train([f"--datasets={name}", f"--epochs={epochs}",
                                   f"--compute_dtype={dtype}", f"--dataset_dir={data_dir}",
                                   f"--save_dir={WORK / teacher}", f"--results_dir={results}",
                                   *STUDENT_FLAGS, *flags], student=True)
        counts = _delta(_counts(), before)
        line = _student_line(name, dtype, flags, stats, report, counts)
        if line["losses"][-1] >= line["losses"][0]:
            raise AssertionError(f"{label}: the loss did not fall: {line['losses']}")
        evals = len(report["eval_s"])
        if counts["sddmm"] != 4 * evals:
            raise AssertionError(f"{label}: {counts['sddmm']} sddmm launches in {evals} evals "
                                 f"(expected 4 each)")
        _check_student_gathers(label, counts, report)
        _check_sddmm_route(label, counts)
        _check_relu_dropout_launches(label, counts,
                                     report["steps_per_epoch"] * len(report["epoch_s"]),
                                     STUDENT_DROPOUT_SITES)
        runs[(name, dtype, flags)] = {"line": line, "counts": counts}
        if i == 0:
            # the default cora student serves on the card (the top-K through
            # the retrieval kernel) and on the CPU alike
            m0 = mlp_block_logits.launches
            _serve_trained(WORK / "teacher_cora" / "cora-student_transductive",
                           expect_segsum=0)
            if mlp_block_logits.launches == m0:
                raise AssertionError("the cora student's top-K did not launch mlp_topk")
    launches = {"sddmm": sddmm_mlp_score.launches,
                "heavy_first": segsum.heavy_first_launches,
                "sddmm_routes": _sddmm_routes(),
                "mlp_topk": dict(mlp_block_logits.launch_counts),
                "relu_dropout": (relu_dropout.launches, relu_dropout.backward_launches)}
    log("student_launches", {"sddmm": launches["sddmm"],
                             "mlp_topk": {f"{dt} {kind}": n for (dt, kind), n
                                          in launches["mlp_topk"].items()}})

    # the card against the CPU: the same contexts, walked once on the host
    host = prepare_transductive(StudentConfig(datasets="cora", dataset_dir=STANDINS),
                                torch.device("cpu"))
    contexts = sample_contexts(torch.Generator().manual_seed(1), host["graph"],
                               torch.arange(host["x"].shape[0]))
    gpu = _student_parity_losses("cuda", contexts)
    cpu = _student_parity_losses("cpu", contexts)
    gap = float(np.max(np.abs(np.array(gpu) - cpu) / np.abs(cpu)))
    parity = {"run": "cora student", "gpu": gpu, "cpu": cpu, "rel_gap": gap, "rtol": LOSS_RTOL}
    log("student_vs_cpu", parity)
    if gap > LOSS_RTOL:
        raise AssertionError(f"cora student: card vs CPU losses differ by {gap:.3g} > {LOSS_RTOL}")

    _, trainer = _student_trainer("cuda", name="collab", dataset_dir=WEIGHTED, dropout=0.5,
                                  teacher=str(WORK / "teacher_weighted"
                                              / "collab-sage_transductive"),
                                  link_batch_size=65536)
    profile = {"compute_dtype": "float32", "node_batch": trainer.node_batch,
               "contexts": trainer.num_contexts, **_profile_trainer(trainer)}
    log("student_profile", profile)
    return {"runs": runs, "launches": launches, "parity": parity, "profile": profile}


# The production runs: (dataset, teacher epochs, student epochs). The default
# SAGE teacher at fp32 on the cora stand-in (split ratios 0.3) and the collab
# stand-in (0.1), then the default student from it; the split is made once
# and cached in the stand-ins' directory.
PRODUCTION_RUNS = (("cora", 20, 20), ("collab", 2, 2))
PRODUCTION = WORK / "production"  # both runs' artifacts


def _production_line(role: str, name: str, stats: dict, report: dict, counts: dict) -> dict:
    import statistics

    metric = "Hits@50" if name == "collab" else "Hits@20"
    steady = report["epoch_s"][1:] or report["epoch_s"]
    line = {"role": role, "dataset": name, "epochs": len(report["epoch_s"]),
            "steps_per_epoch": report["steps_per_epoch"],
            "epoch_s": statistics.median(steady), "epoch_s_all": report["epoch_s"],
            "eval_s": report["perf"]["mean_eval_s"], "losses": report["losses"][0],
            "metric": metric, metric: {k: v[0] for k, v in stats[metric].items()},
            "n_old": report["num_nodes"], "n": report["inference_nodes"],
            "message_edges": report["message_edges"],
            "inference_edges": report["inference_edges"], "eval_sets": report["eval_sets"],
            "launches": counts}
    log("production", line)
    return line


def _check_production_launches(label: str, role: str, counts: dict, report: dict,
                               in_dim: int) -> None:
    """SDDMM once per non-empty edge set an eval; the teacher's segsum over
    both graphs (:func:`_check_valedges_launches`: the layer-1 hoist for the
    trainer and per eval graph, layer 2 per graph an eval), the student's
    none."""
    evals = len(report["eval_s"])
    sets = sum(1 for m in report["eval_sets"].values() if m)
    if counts["sddmm"] != sets * evals:
        raise AssertionError(f"{label}: {counts['sddmm']} sddmm launches in {evals} evals, "
                             f"expected {sets} each (the non-empty edge sets)")
    if role == "student":
        _check_student_gathers(label, counts, report)
        _check_sddmm_route(label, counts)
        return
    steps = report["steps_per_epoch"] * len(report["epoch_s"])
    _check_train_launches(label, "", "float32", counts, steps)
    _check_valedges_launches(label, "", counts, steps, evals, in_dim)


def _production_eval(device: str) -> tuple:
    """The cora production teacher's evaluation on ``device``: ``(results,
    h_val, data)``."""
    import torch

    from llp_tpu_torch.train.loop import (
        eval_first_aggregations,
        evaluate_teacher,
        prepare_production,
    )
    from llp_tpu_torch.utils.checkpoint import load_checkpoint
    from llp_tpu_torch.utils.config import TeacherConfig
    from llp_tpu_torch.utils.params import from_jax

    cfg = TeacherConfig(datasets="cora", dataset_dir=STANDINS, transductive="production")
    data = prepare_production(cfg.finalize(), torch.device(device))
    ckpt, _ = load_checkpoint(str(PRODUCTION / "cora-sage_production"))
    model = from_jax(ckpt["params"]).to(device)
    results, h = evaluate_teacher(model, data, hits_ks=cfg.hits_ks,
                                  x_aggs=eval_first_aggregations("sage", "sage", data))
    return results, h, data


def phase_production() -> dict:
    """Drive both training CLIs in the production setting on the card, check
    the launches of every run, hold the cora teacher's evaluation and its
    served artifact against the CPU; returns each run's line and the
    launches on the production path."""
    import numpy as np

    from llp_tpu_torch.ops.sddmm import sddmm_mlp_score
    from llp_tpu_torch.ops.segsum import segsum
    from llp_tpu_torch.ops.spmm import spmm

    results = WORK / "results"
    runs = {}
    # the production path starts here
    _reset_gather_counts()
    segsum.launches = spmm.backward_launches = sddmm_mlp_score.launches = 0
    spmm.weighted_backward_launches = 0
    segsum.launch_counts.clear()
    segsum.route_counts.clear()
    segsum.heavy_first_launches = 0
    sddmm_mlp_score.launch_counts.clear()
    for name, t_epochs, s_epochs in PRODUCTION_RUNS:
        for role, epochs, flags in (("teacher", t_epochs, TRAIN_FLAGS),
                                    ("student", s_epochs, STUDENT_FLAGS)):
            label = f"production {role} {name}"
            before = _counts()
            stats, report, _ = _train([f"--datasets={name}", f"--epochs={epochs}",
                                       f"--dataset_dir={STANDINS}", f"--save_dir={PRODUCTION}",
                                       f"--results_dir={results}", "--transductive=production",
                                       *flags], student=role == "student")
            counts = _delta(_counts(), before)
            line = _production_line(role, name, stats, report, counts)
            if line["losses"][-1] >= line["losses"][0]:
                raise AssertionError(f"{label}: the loss did not fall: {line['losses']}")
            _check_production_launches(label, role, counts, report,
                                       1433 if name == "cora" else 128)
            runs[(name, role)] = line
    launches = {"segsum": segsum.launches, "sddmm": sddmm_mlp_score.launches,
                "heavy_first": segsum.heavy_first_launches}
    log("production_launches", launches)
    launches["sddmm_routes"] = _sddmm_routes()

    # the cora teacher's evaluation, the card against the CPU
    gpu, h_gpu, data = _production_eval("cuda")
    cpu, h_cpu, _ = _production_eval("cpu")
    # a flipped strict comparison moves a Hits@K or an AUC by 1/M of its
    # positive set: val, merged, old-old, old-new, new-new
    sizes = [data["val_pos"].shape[0]] + [data["test_edges"][k].shape[0]
                                          for k in ("merged", "old_old", "old_new", "new_new")]
    tol = 1.0 / np.maximum(sizes, 1) + 1e-6
    gaps = {k: np.abs(np.array(gpu[k]) - np.array(cpu[k])) for k in cpu}
    for k, gap in gaps.items():
        if not (gap <= tol).all():
            raise AssertionError(f"cora production eval {k}: card {gpu[k]} vs CPU {cpu[k]}")
    log("production_vs_cpu", {"h_val": compare(h_gpu.cpu(), h_cpu, **H_TOL, what="h_val"),
                              **H_TOL, "metric_tol": tol.tolist(),
                              "metrics_max_gap": {k: float(g.max()) for k, g in gaps.items()}})
    # its artifact re-encodes every node over the whole graph (as JAX serves it)
    _serve_trained(PRODUCTION / "cora-sage_production", expect_segsum=2)
    return {"runs": runs, "launches": launches}


TOOLING = WORK / "tooling"  # the tooling phase's runs, imports, sweep and report
RAW = WORK / "raw"  # the raw downloads it writes: Cora/raw/ and CS/raw/
GOLD = ROOT / "tests" / "golden"  # the reference's genuine artifacts (cora, 300 nodes)


def _write_raw_cora(base: Path, seed: int):
    """Planetoid raw files at cora's shape: 2,708 nodes, 1,433 binary
    features (1,708 ``allx`` rows, 1,000 ``tx`` rows for the test ids
    1,708-2,707, listed shuffled), ``graph`` a defaultdict of adjacency
    lists over 5,278 undirected edges (10,556 directed). Returns the
    features and the directed edge count the parse must give."""
    import collections
    import pickle

    import numpy as np
    import scipy.sparse as sp

    n, d, n_allx, n_und = 2708, 1433, 1708, 5278
    rng = np.random.default_rng(seed)
    x = sp.random(n, d, density=0.0127, random_state=seed, format="csr", dtype=np.float32)
    x.data[:] = 1.0
    pairs = np.sort(rng.integers(0, n, (4 * n_und, 2)), axis=1)
    pairs = np.unique(pairs[pairs[:, 0] != pairs[:, 1]], axis=0)
    pairs = pairs[rng.permutation(len(pairs))[:n_und]]
    graph = collections.defaultdict(list)
    for u, v in pairs.tolist():
        graph[u].append(v)
        graph[v].append(u)
    test_ids = rng.permutation(np.arange(n_allx, n))
    base.mkdir(parents=True, exist_ok=True)
    # tx's row i holds the features of node test_ids[i]
    for suffix, obj in (("allx", x[:n_allx]), ("tx", x[test_ids]), ("graph", graph)):
        with open(base / f"ind.cora.{suffix}", "wb") as f:
            pickle.dump(obj, f, protocol=2)
    np.savetxt(base / "ind.cora.test.index", test_ids, fmt="%d")
    return x, 2 * n_und


def _write_raw_cs(path: Path, seed: int):
    """A GNN-benchmark ``ms_academic_cs.npz`` at coauthor-cs's shape: a CSR
    adjacency over 18,333 nodes holding both directions of 81,894 edges
    (163,788 entries), and 18,333 x 6,805 binary CSR attributes. Returns the
    attributes and the directed edge count the parse must give."""
    import numpy as np
    import scipy.sparse as sp

    n, d, n_und = 18_333, 6_805, 81_894
    rng = np.random.default_rng(seed)
    pairs = np.sort(rng.integers(0, n, (2 * n_und, 2)), axis=1)
    pairs = np.unique(pairs[pairs[:, 0] != pairs[:, 1]], axis=0)
    pairs = pairs[rng.permutation(len(pairs))[:n_und]]
    both = np.concatenate([pairs, pairs[:, ::-1]])
    adj = sp.csr_matrix((np.ones(len(both), np.float32), (both[:, 0], both[:, 1])), (n, n))
    attr = sp.random(n, d, density=0.0088, random_state=seed, format="csr", dtype=np.float32)
    attr.data[:] = 1.0
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, adj_data=adj.data, adj_indices=adj.indices, adj_indptr=adj.indptr,
             adj_shape=np.array(adj.shape), attr_data=attr.data, attr_indices=attr.indices,
             attr_indptr=attr.indptr, attr_shape=np.array(attr.shape))
    return attr, 2 * n_und


def _check_raw(name: str, written, directed: int) -> dict:
    """Load a raw download through ``get_dataset``: its features as written,
    ``directed`` edges, symmetric, sorted and unique, no self-loops."""
    import numpy as np

    from llp_tpu_torch.data.registry import get_dataset

    t = time.perf_counter()
    ds = get_dataset(str(RAW), name)
    parse_s = time.perf_counter() - t
    ei, n = ds.edge_index, ds.num_nodes
    keys = ei[0] * n + ei[1]
    if (ds.synthetic or ds.x.shape != written.shape or ei.shape != (2, directed)
            or not np.array_equal(ds.x, written.toarray())):
        raise AssertionError(f"raw {name}: {ds.x.shape} features and {ei.shape} edges "
                             f"(synthetic {ds.synthetic}), expected {written.shape} as "
                             f"written and (2, {directed})")
    if ((ei[0] == ei[1]).any() or not (np.diff(keys) > 0).all()
            or not np.array_equal(np.sort(ei[1] * n + ei[0]), keys)):
        raise AssertionError(f"raw {name}: the edge set is not symmetric, unique and free "
                             f"of self-loops")
    line = {"step": "raw", "dataset": name, "nodes": n, "features": ds.num_features,
            "edges": int(ei.shape[1]), "parse_s": parse_s}
    log("tooling", line)
    return line


def _split_steps(dataset_dir: str, name: str, batch: int = 65536) -> int:
    """Steps per teacher epoch: the cached split's training positives over
    the batch."""
    import numpy as np

    with np.load(Path(dataset_dir) / f"{name}_split.npz") as z:
        return -(-int(z["train__edge"].shape[0]) // batch)


def _check_path(label: str, counts: dict, *, steps: int, evals: int) -> None:
    """B1 forward and backward on every teacher step (none with no step),
    B3 four times an eval (valid and test, positives and negatives), on
    the tensor-core route."""
    if steps:
        _check_train_launches(label, "", "float32", counts, steps)
    elif counts["segsum"] != counts["gather"]:
        raise AssertionError(f"{label}: {counts['segsum']} segsum launches, "
                             f"{counts['gather']} of them the gathers' backward (no graph)")
    if counts["sddmm"] != 4 * evals:
        raise AssertionError(f"{label}: {counts['sddmm']} sddmm launches in {evals} evals, "
                             f"expected 4 each")
    _check_sddmm_route(label, counts)


def _check_serve_launches(label: str, counts: dict) -> None:
    """A 2-layer re-encode (segsum once a layer) and the pairs in one SDDMM."""
    if counts["segsum"] != 2 or counts["sddmm"] != 1:
        raise AssertionError(f"{label}: {counts['segsum']} segsum and {counts['sddmm']} sddmm "
                             f"launches, expected 2 and 1")


def _resume_check(role: str, name: str, epochs: int, flags: list, teacher=None) -> dict:
    """``epochs`` epochs straight through, and the same cut at half way and
    resumed, each with a snapshot every ``epochs // 2``, in PyTorch's
    default mode: the same losses, final weights, Adam state and generator
    state bit for bit, full histories, and the resumed run's artifact
    holding its best validation. Then, as a control, the straight run once
    more under PyTorch's deterministic algorithms: its losses and snapshot
    must equal the default-mode run's bit for bit (``default_mode_rel_gap``
    0), which holds only if no op of a step sums with atomics (the gathers'
    backward goes through ``gather_rows``)."""
    import shutil
    import warnings

    import numpy as np
    import torch

    from llp_tpu_torch.train.state import load_run_state
    from llp_tpu_torch.utils.checkpoint import load_checkpoint

    student = role == "student"
    every = epochs // 2
    out, snaps = {}, {}
    mode = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    runs = (("straight", [(epochs, [])], False),
            ("cut", [(every, []), (epochs, ["--resume"])], False),
            ("deterministic", [(epochs, [])], True))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for kind, calls, deterministic in runs:
            save = TOOLING / f"resume_{role}_{kind}"
            if teacher is not None:
                save.mkdir(parents=True, exist_ok=True)
                for ext in (".npz", ".json"):
                    shutil.copy(f"{teacher}{ext}", save / f"{Path(teacher).name}{ext}")
            torch.use_deterministic_algorithms(deterministic, warn_only=True)
            try:
                for n_epochs, extra in calls:
                    before = _counts()
                    stats, report, _ = _train([f"--datasets={name}", f"--epochs={n_epochs}",
                                               f"--dataset_dir={STANDINS}", f"--save_dir={save}",
                                               f"--results_dir={WORK / 'results'}",
                                               f"--checkpoint_every={every}", *flags, *extra],
                                              student=student)
                    counts = _delta(_counts(), before)
                    ran = len(report["epoch_s"])
                    _check_path(f"resume {role} {kind} {extra}", counts,
                                steps=0 if student else report["steps_per_epoch"] * ran,
                                evals=len(report["eval_s"]))
            finally:
                torch.use_deterministic_algorithms(mode[0], warn_only=mode[1])
            artifact = save / f"{name}-{'student' if student else 'sage'}_transductive"
            out[kind] = {"losses": report["losses"][0], "ran_last_call": ran,
                         "snapshot_s": report["snapshot_s"]}
            snaps[kind] = load_run_state(f"{artifact}_trainstate")
            ckpt, meta = load_checkpoint(str(artifact))
            hist = snaps[kind][1]["logger_results"]
            metric = "Hits@50" if name == "collab" else "Hits@20"
            if [len(h[0]) for h in hist.values()] != [epochs] * len(hist) or "params" not in ckpt:
                raise AssertionError(f"resume {role} {kind}: histories "
                                     f"{[len(h[0]) for h in hist.values()]}, artifact keys "
                                     f"{sorted(ckpt)}")
            if not student and meta["val"] != max(v for v, _ in hist[metric][0]):
                raise AssertionError(f"resume {role} {kind}: the artifact holds val "
                                     f"{meta['val']}, the history's best is "
                                     f"{max(v for v, _ in hist[metric][0])}")

    def differing(kind):
        with (np.load(TOOLING / f"resume_{role}_straight" / f"{artifact.name}_trainstate.npz")
              as a, np.load(TOOLING / f"resume_{role}_{kind}" / f"{artifact.name}_trainstate.npz")
              as b):
            return sorted(k for k in {*a.files, *b.files}
                          if k not in a.files or k not in b.files
                          or not np.array_equal(a[k], b[k]))

    differ = differing("cut")
    ref, other = np.array(out["straight"]["losses"]), np.array(out["deterministic"]["losses"])
    line = {"step": "resume", "role": role, "dataset": name, "epochs": epochs,
            "every": every, **{f"{k}_{f}": v[f] for k, v in out.items() for f in v},
            "losses_equal": out["straight"]["losses"] == out["cut"]["losses"],
            "snapshot_arrays_differing": differ,
            "default_mode_rel_gap": float(np.max(np.abs(other - ref) / np.abs(ref))),
            "deterministic_arrays_differing": differing("deterministic"),
            # the card's generator state is its seed and offset (16 bytes)
            "rng_state": snaps["cut"][0]["rng"].tolist()[:16],
            "rng_equal_deterministic": bool(np.array_equal(snaps["deterministic"][0]["rng"],
                                                           snaps["cut"][0]["rng"])),
            "nondeterminism_warnings": sorted({str(w.message)[:120] for w in caught})}
    log("tooling", line)
    if len(out["straight"]["losses"]) != epochs or out["cut"]["ran_last_call"] != epochs - every:
        raise AssertionError(f"resume {role}: {len(out['straight']['losses'])} losses, the "
                             f"resumed call ran {out['cut']['ran_last_call']} epochs")
    if not line["losses_equal"] or differ:
        raise AssertionError(f"resume {role}: the resumed run is not the straight one: losses "
                             f"equal {line['losses_equal']}, arrays differing {differ}")
    if line["default_mode_rel_gap"] != 0.0 or line["deterministic_arrays_differing"]:
        raise AssertionError(f"resume {role}: the default mode does not repeat the "
                             f"deterministic one: losses {line['default_mode_rel_gap']:.3g} "
                             f"apart, arrays differing {line['deterministic_arrays_differing']}")
    return line


def phase_tooling() -> dict:
    """The port's tooling on the card: raw downloads (Planetoid cora and a
    GNN-benchmark coauthor-cs at their real shapes) through the registry;
    a collab teacher and a cora student cut and resumed; the reference's
    genuine cora artifacts imported, distilled from and served (the card
    against the CPU); a sweep with a resume; the parity report on the raw
    downloads. Returns the path's launches."""
    import random

    from llp_tpu_torch.cli import import_reference, parity, sweep
    from llp_tpu_torch.ops.mlp_topk import mlp_block_logits
    from llp_tpu_torch.ops.sddmm import sddmm_mlp_score
    from llp_tpu_torch.ops.segsum import segsum
    from llp_tpu_torch.ops.spmm import spmm

    lines = {}
    # the tooling path starts here
    _reset_gather_counts()
    segsum.launches = spmm.backward_launches = sddmm_mlp_score.launches = 0
    spmm.weighted_backward_launches = mlp_block_logits.launches = 0
    segsum.launch_counts.clear()
    segsum.route_counts.clear()
    segsum.heavy_first_launches = 0
    sddmm_mlp_score.launch_counts.clear()
    mlp_block_logits.launch_counts.clear()

    # 1. raw downloads at the real shapes
    before = _counts()
    cora_x, cora_e = _write_raw_cora(RAW / "Cora" / "raw", seed=11)
    cs_x, cs_e = _write_raw_cs(RAW / "CS" / "raw" / "ms_academic_cs.npz", seed=12)
    lines["raw"] = [_check_raw("cora", cora_x, cora_e), _check_raw("coauthor-cs", cs_x, cs_e)]
    _check_path("raw", _delta(_counts(), before), steps=0, evals=0)

    # 2. resume: the collab teacher and the cora student, cut and resumed
    lines["resume"] = [
        _resume_check("teacher", "collab", 4, TRAIN_FLAGS),
        _resume_check("student", "cora", 4, STUDENT_FLAGS,
                      teacher=str(WORK / "teacher_cora" / "cora-sage_transductive"))]

    # 3. the reference's artifacts: import, distil, serve with --reencode
    ref_data, ref_saved = TOOLING / "ref" / "data", TOOLING / "ref" / "saved"
    before = _counts()
    t = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        import_reference.main([
            "--datasets=cora", f"--dataset_dir={ref_data}", f"--save_dir={ref_saved}",
            f"--split_pkl={GOLD / 'data' / 'cora.pkl'}",
            f"--dataset_npz={GOLD / 'data' / 'cora.npz'}",
            f"--models_pkl={GOLD / 'saved-models' / 'cora-sage_transductive.pkl'}",
            f"--features_pkl={GOLD / 'saved-features' / 'cora-sage_transductive.pkl'}"])
    import_s = time.perf_counter() - t
    stats, report, _ = _train(["--datasets=cora", "--epochs=5", f"--dataset_dir={ref_data}",
                               f"--save_dir={ref_saved}", f"--results_dir={WORK / 'results'}",
                               *STUDENT_FLAGS], student=True)
    counts = _delta(_counts(), before)
    losses = report["losses"][0]
    if losses[-1] >= losses[0]:
        raise AssertionError(f"the student of the imported teacher: losses {losses}")
    _check_path("imported teacher's student", counts, steps=0, evals=len(report["eval_s"]))
    ckpt = ref_saved / "cora-sage_transductive"
    queries, pairs = _requests(300, seed=5)
    argv = [f"--checkpoint={ckpt}", "--datasets=cora", f"--dataset_dir={ref_data}",
            "--reencode", "--topk=10", f"--queries={queries}", f"--pairs={pairs}"]
    before = _counts()
    summary, served = _serve(argv)
    counts = _delta(_counts(), before)
    if summary["nodes"] != 300:
        raise AssertionError(f"serving the imported teacher: {summary}")
    _check_serve_launches("the imported teacher served", counts)
    _, cpu = _serve(argv + ["--device=cpu"])
    lines["import"] = {"step": "import", "import_s": import_s, "student_losses": losses,
                       "student_Hits@20": stats["Hits@20"]["test"][0],
                       "serve": {k: summary[k] for k in ("nodes", "dim")},
                       "serve_launches": {"segsum": counts["segsum"], "sddmm": counts["sddmm"]},
                       "vs_cpu_pairs_max_abs": _check_pairs(served, cpu, "imported teacher"),
                       "vs_cpu_topk": _check_topk(served, cpu, 10, "imported teacher")}
    log("tooling", lines["import"])

    # 4. a sweep of two teacher trials on the raw cora, then a third by resume
    spec = {"program": "train_teacher_gnn.py", "metric": {"name": "Hits@20"}, "trials": 3,
            "parameters": {"lr": {"values": [0.001, 0.005, 0.01]},
                           "dropout": {"values": [0.0, 0.5]}},
            "base": {"datasets": "cora", "dataset_dir": str(RAW), "epochs": 3, "runs": 1,
                     "hidden_channels": 256, "num_layers": 2, "predictor": "mlp",
                     "batch_size": 65536, "eval_steps": 1, "patience": 100,
                     "save_dir": str(TOOLING / "sweep"), "results_dir": ""}}
    out = str(TOOLING / "sweep.json")
    before = _counts()
    with contextlib.redirect_stdout(io.StringIO()):
        first = sweep.run_sweep(spec, out_path=out, seed=0, max_trials=2, device="cuda")
        resumed = sweep.run_sweep(spec, out_path=out, seed=0, resume=True, device="cuda")
    counts = _delta(_counts(), before)
    rng = random.Random(0)
    stream = [sweep.trial_config(spec, rng)[1] for _ in range(3)]
    if (resumed["history"][:2] != first["history"]
            or [r["params"] for r in resumed["history"]] != stream):
        raise AssertionError(f"the resumed sweep left the stream: {resumed['history']}")
    _check_path("sweep", counts, steps=3 * 3 * _split_steps(str(RAW), "cora"), evals=3 * 3)
    lines["sweep"] = {"step": "sweep", "history": resumed["history"], "best": resumed["best"]}
    log("tooling", lines["sweep"])

    # 5. the parity report on both raw downloads
    before = _counts()
    with contextlib.redirect_stdout(io.StringIO()):
        (report,) = parity.main([f"--dataset_dir={RAW}", "--datasets=cora,coauthor-cs",
                                 "--setting=transductive", "--runs=1", "--epochs=3",
                                 f"--results_dir={TOOLING / 'parity'}",
                                 f"--save_dir={TOOLING / 'parity'}"])
    counts = _delta(_counts(), before)
    entries = {e["dataset"]: e for e in report["entries"]}
    if (set(entries) != {"cora", "coauthor-cs"}
            or any(e["synthetic_standin"] for e in entries.values())
            or not all(Path(report[k]).exists() for k in ("json_path", "md_path"))):
        raise AssertionError(f"the parity report: {report}")
    steps = 3 * sum(_split_steps(str(RAW), name) for name in entries)
    _check_path("parity", counts, steps=steps, evals=2 * 3 * len(entries))
    lines["parity"] = {"step": "parity", "report": report["md_path"], **{
        name: {who: {"Hits@20": e[who]["stats"]["Hits@20"]["test"][0],
                     "seconds": e[who]["seconds"]} for who in ("teacher", "student")}
        for name, e in entries.items()}}
    log("tooling", lines["parity"])

    launches = {"segsum": segsum.launches, "sddmm": sddmm_mlp_score.launches,
                "heavy_first": segsum.heavy_first_launches}
    log("tooling_launches", launches)
    launches["sddmm_routes"] = _sddmm_routes()
    launches["mlp_topk"] = dict(mlp_block_logits.launch_counts)
    return {"lines": lines, "launches": launches}


# The 10M-node teacher (``scripts/scale10m_r5.py:92,195-197``): an SBM of
# 10,000,000 nodes in 64 communities at mean degree 7 (seed 5) with 64
# Gaussian community features, SAGE 2 layers, hidden 128, the mlp head,
# dropout 0, bf16, uniform negatives, batch 2^19, lr 0.005; 200,000 of its
# undirected pairs held out for the AUC, against as many uniform pairs.
SCALE10M = dict(nodes=10_000_000, communities=64, degree=7.0, features=64, hidden=128,
                batch=1 << 19, lr=0.005, seed=5, held_out=200_000)
# The runs of the 10M phase, (dtype, gather_last, remat): an fp32 pair, then
# the four settings of the big-graph knobs in bf16; the last run's model is
# exported.
SCALE10M_KNOBS = (("float32", False, False), ("float32", True, False),
                  ("bfloat16", False, False), ("bfloat16", False, True),
                  ("bfloat16", True, False), ("bfloat16", True, True))
# Losses of one epoch under the knobs. remat replays the same ops: equal
# bits. gather_last projects the last layer's rows alone, so the sums round
# at other places, and in bf16 a difference of rounding grows over the
# epoch's Adam steps into the trajectory: bf16's first SCALE10M_HELD_STEPS
# steps are held at SCALE10M_STEP_RTOL and its epoch means reported, fp32's
# first SCALE10M_FP32_STEPS steps at SCALE10M_FP32_RTOL (a fault in
# gather_last that shows after bf16's held steps shows there).
SCALE10M_HELD_STEPS = 8
SCALE10M_STEP_RTOL = 1e-3
SCALE10M_FP32_STEPS = 20
SCALE10M_FP32_RTOL = 1e-4


def _scale10m_data():
    """The host graph (seeded, nothing downloaded), split into the training
    pairs and the held-out ones; returns the arrays and the host seconds."""
    import numpy as np

    from llp_tpu_torch.data.synthetic import community_features, sbm_graph

    c = SCALE10M
    t = time.perf_counter()
    # the graph on a thread, the features here meanwhile (numpy's sorts and
    # draws release the GIL): the features' communities are the SBM's
    # first draw, taken again from its seed
    with ThreadPoolExecutor(max_workers=1) as pool:
        graph = pool.submit(sbm_graph, c["nodes"], c["communities"], c["degree"],
                            seed=c["seed"])
        comm = np.random.default_rng(c["seed"]).integers(0, c["communities"], size=c["nodes"])
        x = community_features(comm, c["features"], kind="gauss", seed=c["seed"])
        ei, sbm_comm = graph.result()
    if not np.array_equal(sbm_comm, comm):
        raise AssertionError("scale10m: the SBM's communities are not its seed's first draw")
    pairs = ei[:, ei[0] < ei[1]]  # each undirected pair once
    rng = np.random.default_rng(3)
    held = np.zeros(pairs.shape[1], bool)
    held[rng.choice(pairs.shape[1], c["held_out"], replace=False)] = True
    train = pairs[:, ~held]
    # (numpy's a[:, mask] is column-major: the held-out pairs are made
    # row-major, as the pair scorer reads each row of ids contiguously)
    return {"x": x, "train": train, "held": np.ascontiguousarray(pairs[:, held]),
            "neg": rng.integers(0, c["nodes"], (2, c["held_out"])),
            "messages": np.concatenate([train, train[::-1]], axis=1),
            "pairs": pairs.shape[1], "host_graph_s": time.perf_counter() - t}


def _segsum_plain_blocks(x, senders, in_ptr, scale, blocks: int = 16):
    """``segsum_plain`` over ``blocks`` runs of receiver rows in turn (the
    plain version at once would hold the (E, D) fp32 messages)."""
    import torch

    from llp_tpu_torch.ops.segsum import segsum_plain

    n = in_ptr.numel() - 1
    cuts = [n * i // blocks for i in range(blocks + 1)]
    parts = []
    for r0, r1 in zip(cuts[:-1], cuts[1:]):
        e0, e1 = int(in_ptr[r0]), int(in_ptr[r1])
        parts.append(segsum_plain(x, senders[e0:e1], in_ptr[r0:r1 + 1] - e0,
                                  None if scale is None else scale[r0:r1]))
    return torch.cat(parts)


def phase_scale10m(gen) -> dict:
    """The port's teacher at 10M nodes through ``TeacherTrainer``: one fp32
    epoch with ``gather_last`` off and on, then one bf16 epoch in each
    setting of ``gather_last`` and ``remat``, all from one seed (epoch
    time, peak device bytes, losses), then the last model's bf16 table
    by a full encode, its AUC on the held-out pairs (scored by the pair
    scorer, B3), the table in int4, and top-10 retrieval from it against the
    same model's fp32 table: 'inner' at Q=256 and the bf16 'mlp' head at
    Q=128 through the retrieval kernel (B4). Then B1 at the table's size.
    Returns the kernels line's entries and the path's launches."""
    import numpy as np
    import torch

    from llp_tpu_torch.core.graph import build_graph
    from llp_tpu_torch.models.predictor import LinkPredictor
    from llp_tpu_torch.ops.metrics import roc_auc
    from llp_tpu_torch.ops.mlp_topk import mlp_block_logits
    from llp_tpu_torch.ops.sddmm import sddmm_mlp_score
    from llp_tpu_torch.ops.segsum import segsum, segsum_plain
    from llp_tpu_torch.ops.spmm import spmm
    from llp_tpu_torch.serve import quantize_table, score_pairs, top_k_partners
    from llp_tpu_torch.train.teacher import TeacherTrainer, init_teacher
    from llp_tpu_torch.utils.memory import get_device_memory_map, reset_peak
    from llp_tpu_torch.utils.precision import call_in_dtype

    c = SCALE10M
    data = _scale10m_data()
    t = time.perf_counter()
    g = build_graph(data["messages"], c["nodes"], device="cuda")
    x = torch.from_numpy(data["x"]).cuda()
    pos = torch.from_numpy(data["train"].T.copy()).cuda()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    log("scale10m", {"step": "graph", "nodes": c["nodes"], "pairs": data["pairs"],
                     "train_pairs": int(pos.shape[0]), "messages": g.num_edges,
                     "held_out": c["held_out"], "host_graph_s": data["host_graph_s"],
                     "build_graph_s": build_s})
    del data["messages"]

    # the 10M path starts here
    _reset_gather_counts()
    segsum.launches = spmm.backward_launches = sddmm_mlp_score.launches = 0
    mlp_block_logits.launches = 0
    segsum.launch_counts.clear()
    segsum.route_counts.clear()
    sddmm_mlp_score.launch_counts.clear()
    mlp_block_logits.launch_counts.clear()
    runs = []
    for dtype, gather_last, remat in SCALE10M_KNOBS:
        model = init_teacher(encoder="sage", in_channels=c["features"],
                             hidden_channels=c["hidden"], num_layers=2, predictor_mode="mlp",
                             generator=torch.Generator().manual_seed(0)).cuda()
        torch.cuda.synchronize()
        reset_peak()
        base = get_device_memory_map()[0]["bytes_in_use"]
        trainer = TeacherTrainer(model, g, x, pos, batch_size=c["batch"], lr=c["lr"],
                                 neg_mode="uniform", compute_dtype=dtype,
                                 gather_last=gather_last, remat=remat)
        before = _counts()
        t = time.perf_counter()
        loss = float(trainer.epoch(torch.Generator(device="cuda").manual_seed(1)))
        epoch_s = time.perf_counter() - t
        step_losses = trainer.step_losses.tolist()
        counts = _delta(_counts(), before)
        mem = get_device_memory_map()[0]
        run = {"step": "epoch", "dtype": dtype, "gather_last": gather_last, "remat": remat,
               "steps": trainer.steps, "epoch_s": epoch_s, "loss": loss,
               "first_step_losses": step_losses[:max(SCALE10M_HELD_STEPS,
                                                     SCALE10M_FP32_STEPS)],
               "last_step_losses": step_losses[-3:],
               "bytes_at_start": base, "peak_bytes_in_use": mem["peak_bytes_in_use"],
               "peak_over_start": mem["peak_bytes_in_use"] - base,
               "bytes_limit": mem["bytes_limit"], "launches": counts}
        log("scale10m", run)
        # every step: the layer-2 aggregation both ways, the gathers' backward
        steps = trainer.steps
        fwd = counts["segsum"] - counts["backward"] - counts["gather"]
        if min(fwd, counts["backward"], counts["gather"]) < steps:
            raise AssertionError(f"scale10m {dtype} {gather_last} {remat}: {fwd} forward, "
                                 f"{counts['backward']} backward and {counts['gather']} gather "
                                 f"segsum launches in {steps} steps, expected each a step")
        runs.append(run)
        if (dtype, gather_last, remat) != SCALE10M_KNOBS[-1]:
            del trainer, model

    def first_steps_gap(group, k):
        first = np.array([r["first_step_losses"][:k] for r in group])
        return float(np.max(np.abs(first - first[0]) / np.abs(first[0])))

    fp32 = [r for r in runs if r["dtype"] == "float32"]
    bf16 = [r for r in runs if r["dtype"] == "bfloat16"]
    losses = [r["loss"] for r in bf16]
    step_gap = first_steps_gap(bf16, SCALE10M_HELD_STEPS)
    fp32_gap = first_steps_gap(fp32, SCALE10M_FP32_STEPS)
    remat_equal = [bf16[i]["loss"] == bf16[i + 1]["loss"]
                   and bf16[i]["first_step_losses"] == bf16[i + 1]["first_step_losses"]
                   for i in (0, 2)]
    log("scale10m", {"step": "losses", "epoch_losses": losses,
                     "epoch_rel_gap": max(abs(v - losses[0]) / abs(losses[0]) for v in losses),
                     "first_steps_rel_gap": step_gap, "held_steps": SCALE10M_HELD_STEPS,
                     "step_rtol": SCALE10M_STEP_RTOL, "remat_equal_bits": remat_equal,
                     "fp32_epoch_losses": [r["loss"] for r in fp32],
                     "fp32_first_steps_rel_gap": fp32_gap,
                     "fp32_held_steps": SCALE10M_FP32_STEPS,
                     "fp32_step_rtol": SCALE10M_FP32_RTOL})
    if (not all(np.isfinite([r["loss"] for r in runs])) or step_gap > SCALE10M_STEP_RTOL
            or fp32_gap > SCALE10M_FP32_RTOL or not all(remat_equal)):
        raise AssertionError(f"scale10m: bf16's first {SCALE10M_HELD_STEPS} steps' losses "
                             f"{step_gap:.3g} apart (rtol {SCALE10M_STEP_RTOL}), fp32's first "
                             f"{SCALE10M_FP32_STEPS} {fp32_gap:.3g} (rtol "
                             f"{SCALE10M_FP32_RTOL}); remat equal to plain: {remat_equal}; "
                             f"epoch losses {[r['loss'] for r in runs]}")
    # B1's launches on the bf16 training path: the layer-1 hoist (d=64) once
    # a trainer, then at d=128 the layer-2 forward, its backward and the
    # gathers' backward (2 a step with gather_last: the aggregated and the
    # input rows)
    d128 = _shape_key("bfloat16->bfloat16", 128, False)
    launches = {"steps": sum(r["steps"] for r in bf16),
                "gather": sum(r["launches"]["gather"] for r in bf16),
                "backward": sum(r["launches"]["backward"] for r in bf16),
                "forward_d128": sum(r["launches"]["by_shape"].get(d128, 0)
                                    - r["launches"]["backward"] - r["launches"]["gather"]
                                    for r in bf16),
                "fp32_runs": {"steps": sum(r["steps"] for r in fp32),
                              "segsum": sum(r["launches"]["segsum"] for r in fp32)},
                "segsum": segsum.launches, "sddmm": sddmm_mlp_score.launches,
                "by_shape": {_shape_key(*k): v for k, v in segsum.launch_counts.items()}}
    steps = launches["steps"]

    # the trained model's table, its AUC, int4 and retrieval
    enc, pred = model["encoder"].eval(), model["predictor"].eval()
    t = time.perf_counter()
    with torch.no_grad():
        h = call_in_dtype(enc, torch.bfloat16, g, trainer.x, x_agg=trainer.x_agg)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t
    del trainer
    h32 = h.float()
    ev = {k: torch.from_numpy(data[k]).cuda() for k in ("held", "neg")}
    t = time.perf_counter()
    s_pos = score_pairs(pred, h32, ev["held"][0], ev["held"][1])
    s_neg = score_pairs(pred, h32, ev["neg"][0], ev["neg"][1])
    auc = float(roc_auc(s_pos, s_neg))
    auc_s = time.perf_counter() - t
    t = time.perf_counter()
    q4 = quantize_table(h, bits=4)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t
    qi = torch.randint(0, c["nodes"], (256,), generator=gen, device="cuda")

    def timed_topk(*args, **kw):
        out = top_k_partners(*args, k=10, **kw)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = top_k_partners(*args, k=10, **kw)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def recall(a, b):
        ia, ib = a[1].cpu().numpy(), b[1].cpu().numpy()
        return float(np.mean([len(set(ia[r]) & set(ib[r])) / 10 for r in range(ia.shape[0])]))

    inner = LinkPredictor("inner", c["hidden"], c["hidden"])
    exact, exact_s = timed_topk(inner, h32, qi)
    got, got_s = timed_topk(inner, q4, qi)
    m0 = mlp_block_logits.launches
    exact_m, exact_m_s = timed_topk(pred, h32, qi[:128])
    got_m, got_m_s = timed_topk(pred, q4, qi[:128], compute_dtype=torch.bfloat16)
    b4 = mlp_block_logits.launches - m0
    table = {"step": "table", "encode_s": encode_s, "auc": auc, "auc_s": auc_s,
             "auc_pairs": [c["held_out"], c["held_out"]],
             "int4_bytes": q4.nbytes, "fp32_bytes": h32.numel() * 4, "quantize_s": quant_s,
             "inner_q256": {"recall@10": recall(got, exact), "int4_s": got_s,
                            "fp32_exact_s": exact_s},
             "mlp_q128": {"recall@10": recall(got_m, exact_m), "int4_bf16_s": got_m_s,
                          "fp32_exact_s": exact_m_s},
             "mlp_topk_launches": b4, "sddmm_launches": sddmm_mlp_score.launches}
    log("scale10m", table)
    if not (0.5 < auc <= 1.0) or not b4 or not sddmm_mlp_score.launches:
        raise AssertionError(f"scale10m: AUC {auc}, {b4} retrieval and "
                             f"{sddmm_mlp_score.launches} pair-scorer launches")
    del h, h32, q4, model, enc, pred

    # B1 at the table's size: bf16 -> bf16 at D=128, forward over the
    # receiver CSR (the mean) and backward over the sender CSR
    n, e = g.num_nodes, g.num_edges
    scale = g.inv_in_degree
    entries = []
    for direction, key in (("fwd", "forward_d128"), ("bwd", "backward")):
        xb = torch.randn(n, c["hidden"], generator=gen, device="cuda").bfloat16()
        if direction == "fwd":
            senders, ptr, sc = g.senders, g.in_ptr, scale
            adj = torch.sparse_csr_tensor(g.in_ptr, g.senders, scale[g.receivers], (n, n))
        else:
            xb = (xb.float() * scale[:, None]).bfloat16()
            senders, ptr, sc = g.col, g.row_ptr, None
            adj = torch.sparse_csr_tensor(g.row_ptr, g.col, torch.ones(e, device="cuda"),
                                          (n, n))
        ms = time_ms(lambda: segsum(xb, senders, ptr, sc), reps=5)
        plain_ms = time_ms(lambda: _segsum_plain_blocks(xb, senders, ptr, sc), reps=1, warmup=1)
        try:
            adj = adj.to(torch.bfloat16)
            library_ms = time_ms(lambda: torch.sparse.mm(adj, xb), reps=3, warmup=1)
        except RuntimeError as exc:
            library_ms = None
            log("scale10m", {"step": "library", "refused": str(exc)[:120]})
        del adj
        nbytes = (n * c["hidden"] * 4 + senders.numel() * 4 + ptr.numel() * 8
                  + (0 if sc is None else n * 4))
        entry = {"name": f"segsum.{direction}.bf16.d128.10m", "route": "cuda",
                 "source": "llp_tpu_torch/csrc/segsum.cu",
                 "replaces": "llp_tpu/ops/pallas/segsum_kernel.py:191",
                 "launches": launches[key], "launches_per_step": launches[key] / steps,
                 "max_abs_err": 0.0, "ms": ms,
                 "plain_ms": plain_ms, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                 "bound_by": "bytes", "library_ms": library_ms,
                 "plain_note": "segsum_plain over 16 blocks of receiver rows in turn",
                 "shapes": f"10M SBM {'receiver' if direction == 'fwd' else 'sender'} CSR: "
                           f"n={n} e={e}, d=128, bfloat16->bfloat16"}
        # held against the plain version on the first 200,000 rows
        r1 = min(200_000, n)
        e1 = int(ptr[r1])
        got = segsum(xb, senders[:e1], ptr[:r1 + 1].contiguous(),
                     None if sc is None else sc[:r1].contiguous())
        ref = segsum_plain(xb.float(), senders[:e1], ptr[:r1 + 1],
                           None if sc is None else sc[:r1])
        err = compare_bf16(got, ref, **BF16_TOL, what=f"segsum 10M {direction}")
        entry["max_abs_err"] = err["max_abs"]
        entries.append(entry)
        log("timing", {"kernel": entry["name"], "n": n, "e": e, "d": c["hidden"],
                       "bytes": nbytes, "ms": ms, "plain_ms": plain_ms,
                       "library_ms": library_ms, "bound_ms": entry["bound_ms"],
                       "max_abs_err": err["max_abs"]})
    log("scale10m_launches", launches)
    del g, x, pos
    return {"runs": runs, "table": table, "launches": launches, "entries": entries}


REORDER = WORK / "reorder"  # the relabeled runs' artifacts
# The teacher runs with --reorder: (dataset, epochs, order), fp32, beside the
# train phase's natural-order runs of the same dataset.
REORDER_RUNS = (("cora", 20, "rcm"), ("cora", 20, "locality"), ("collab", 2, "rcm"),
                ("collab", 2, "locality"))


def _b5_timing(name: str, tiles, x, n: int, launches: int, worst: float, what: str) -> dict:
    """The tile kernel's kernels-line entry at these tiles and x: its time,
    the plain version's, ``torch.sparse.mm`` over a CSR of the same tiled
    edges (and weights), and the least time: what the function needs read
    once (each valid slot's coordinate and weight, the chunks' tile rows and
    columns, the row blocks' offsets, the rows of x the tiles point at) and
    out written once, or 2 D operations a tiled edge at the fp32 rate,
    whichever is longer.  Padding slots are not charged: a chunk's edges
    fill its first slots and neither the function nor the kernel reads past
    them."""
    import torch

    from llp_tpu_torch.ops.spmm_tiles import spmm_tiles_apply, spmm_tiles_apply_plain

    d = x.shape[1]
    coords = tiles.coords.reshape(-1)
    slots = torch.nonzero(coords >= 0).squeeze(1)
    c = coords[slots].long()
    rows = tiles.tile_rows.long()[slots // 128] * 128 + c // 128
    cols = tiles.tile_cols.long()[slots // 128] * 128 + c % 128
    vals = (torch.ones(slots.numel(), device="cuda") if tiles.weights is None
            else tiles.weights.reshape(-1)[slots])
    adj = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals, (n, n)).coalesce()
    adj = adj.to_sparse_csr()
    edges = int(slots.numel())
    t = {"ms": time_ms(lambda: spmm_tiles_apply(tiles, x, n)),
         "plain_ms": time_ms(lambda: spmm_tiles_apply_plain(tiles, x, n))}
    try:  # does torch.sparse.mm take this type?
        adj_x = adj.to(x.dtype)
        t["library_ms"] = time_ms(lambda: torch.sparse.mm(adj_x, x))
    except RuntimeError as exc:
        t["library_ms"] = None
        t["library_note"] = f"torch.sparse.mm refuses {x.dtype} here: {str(exc)[:120]}"
    chunks = int(tiles.tile_rows.numel())
    x_rows = int(torch.unique(cols).numel())
    nbytes = (edges * 4 * (2 if tiles.weights is not None else 1) + chunks * 8
              + tiles.block_ptr.numel() * 8 + x_rows * d * x.element_size() + n * d * 4)
    flops = 2 * edges * d
    bytes_ms, flops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOP_PER_S * 1e3
    t.update(bytes=nbytes, flops=flops, bound_ms=max(bytes_ms, flops_ms),
             bound_by="bytes" if bytes_ms >= flops_ms else "operations")
    log("timing", {"kernel": name, "n": n, "d": d, "chunks": chunks, "tiled_edges": edges,
                   "x_rows": x_rows, "fill": edges / (chunks * 128), **t})
    entry = {"name": name, "route": "cuda", "source": "llp_tpu_torch/csrc/spmm_tiles.cu",
             "replaces": "docs/archived/spmm_tile_kernel.py:56", "launches": launches,
             "max_abs_err": worst, "ms": t["ms"], "plain_ms": t["plain_ms"],
             "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
             "library_ms": t["library_ms"],
             "shapes": f"{what}: n={n}, {chunks} chunks, {edges} tiled edges, d={d}"}
    if "library_note" in t:
        entry["library_note"] = t["library_note"]
    return entry


def phase_reorder(gen, train: dict, worst: dict) -> dict:
    """The relabeled path on the card: the orders of the collab stand-in and
    their tile fill; the tile SpMM (B5) on the RCM graph (the hybrid forward
    and backward, the weighted tiles of the mean); the training CLIs with
    ``--reorder`` (teachers, a student from the natural-order teacher, the
    production setting) and the reordered artifact served on the card and
    the CPU. The launch counters are read after that path; then B1 on each
    order and B5 are timed. Returns the path's launches and B5's kernels-line
    entries."""
    import shutil

    import numpy as np
    import torch

    from llp_tpu_torch.core.graph import build_graph
    from llp_tpu_torch.data.partition import locality_order
    from llp_tpu_torch.data.registry import get_dataset
    from llp_tpu_torch.data.reorder import rcm_order
    from llp_tpu_torch.data.tiles import build_tiles, tile_fill
    from llp_tpu_torch.ops.sddmm import sddmm_mlp_score
    from llp_tpu_torch.ops.segsum import segsum, segsum_plain
    from llp_tpu_torch.ops.spmm import spmm, spmm_backward_plain
    from llp_tpu_torch.ops.spmm_tiles import spmm_tiles, spmm_tiles_apply, spmm_tiles_apply_plain

    # the reorder path starts here
    _reset_gather_counts()
    segsum.launches = spmm.backward_launches = sddmm_mlp_score.launches = 0
    spmm.weighted_backward_launches = spmm_tiles_apply.launches = 0
    spmm_tiles.backward_launches = 0
    segsum.launch_counts.clear()
    segsum.route_counts.clear()
    segsum.heavy_first_launches = 0
    sddmm_mlp_score.launch_counts.clear()
    spmm_tiles_apply.launch_counts.clear()

    ds = get_dataset(STANDINS, "collab")
    n, ei = ds.num_nodes, ds.edge_index
    t = time.perf_counter()
    orders = {"natural": np.arange(n), "rcm": rcm_order(ei, n)}
    rcm_s = time.perf_counter() - t
    t = time.perf_counter()
    orders["locality"] = locality_order(ei, n, 64)
    log("reorder_order", {"dataset": "collab", "nodes": n, "edges": int(ei.shape[1]),
                          "rcm_s": rcm_s, "locality_s": time.perf_counter() - t,
                          "locality_parts": 64})
    graphs, fill = {}, []
    for name, order in orders.items():
        inv = np.empty(n, np.int64)
        inv[order] = np.arange(n)
        g = graphs[name] = build_graph(inv[ei], n, device="cuda")
        recv, send = g.receivers.cpu().numpy(), g.senders.cpu().numpy()
        for min_edges in (16, 0):
            tiles, res_recv, _, _ = build_tiles(recv, send, n, min_tile_edges=min_edges,
                                                device="cpu")
            row = {"order": name, "min_tile_edges": min_edges, **tile_fill(tiles),
                   "residual_edges": int(res_recv.size),
                   "residual_share": res_recv.size / g.num_edges}
            log("reorder_fill", row)
            fill.append(row)
    g = graphs["rcm"]
    recv, send = g.receivers.cpu().numpy(), g.senders.cpu().numpy()

    # B5 on the RCM graph: the hybrid mean aggregation forward and backward
    # (fp32, and the bf16 forward), each against its plain version
    scale = g.inv_in_degree
    x = torch.randn(n, 256, generator=gen, device="cuda")
    xb = x.bfloat16()
    gout = torch.randn(n, 256, generator=gen, device="cuda")
    xr = x.clone().requires_grad_(True)
    out = spmm_tiles(g, xr, "mean")
    (dx,) = torch.autograd.grad(out, xr, gout)
    b5 = {"hybrid": compare(out, segsum_plain(x, g.senders, g.in_ptr, scale), **SEGSUM_TOL,
                            what="spmm_tiles hybrid rcm"),
          "hybrid_backward": compare(dx, spmm_backward_plain(g, gout, "mean"), **SEGSUM_TOL,
                                     what="spmm_tiles bwd rcm"),
          "hybrid_bf16": compare_bf16(spmm_tiles(g, xb, "mean"),
                                      segsum_plain(xb.float(), g.senders, g.in_ptr,
                                                   scale).bfloat16(),
                                      **BF16_TOL, what="spmm_tiles hybrid bf16 rcm")}
    # the weighted tiles of the mean (1/deg on every edge, no residual): the
    # whole aggregation in the kernel
    mean_w = scale[g.receivers].cpu().numpy()
    tiles_w = build_tiles(recv, send, n, mean_w, device="cuda")[0]
    for xt, key in ((x, "weighted_f32"), (xb, "weighted_bf16")):
        b5[key] = compare(spmm_tiles_apply(tiles_w, xt, n),
                          spmm_tiles_apply_plain(tiles_w, xt, n), **SEGSUM_TOL,
                          what=f"spmm_tiles {key} rcm")
    log("reorder_b5", b5)

    results = WORK / "results"
    runs = {}
    for name, epochs, reorder in REORDER_RUNS:
        label = f"reorder {reorder} {name}"
        before = _counts()
        stats, report, _ = _train([f"--datasets={name}", f"--epochs={epochs}",
                                   f"--dataset_dir={STANDINS}", f"--reorder={reorder}",
                                   f"--save_dir={REORDER / reorder}",
                                   f"--results_dir={results}", *TRAIN_FLAGS])
        counts = _delta(_counts(), before)
        line = _train_line(name, "float32", f"reorder {reorder}", stats, report, counts)
        natural = train["runs"][(name, "float32", "")]["line"]
        runs[(name, reorder)] = {"epoch_s": line["epoch_s"], "natural_epoch_s": natural["epoch_s"],
                                 "metric": line["metric"], "valid": line["valid"],
                                 "natural_valid": natural["valid"]}
        log("reorder_train", {"dataset": name, "reorder": reorder, **runs[(name, reorder)]})
        if line["losses"][-1] >= line["losses"][0]:
            raise AssertionError(f"{label}: the loss did not fall: {line['losses']}")
        _check_train_launches(label, "", "float32", counts,
                              report["steps_per_epoch"] * len(report["epoch_s"]))
    _serve_trained(REORDER / "rcm" / "cora-sage_transductive", expect_segsum=2)

    # a relabeled student from the natural-order cora teacher, then the
    # production setting relabeled, teacher and student
    student_dir = REORDER / "student"
    student_dir.mkdir(parents=True, exist_ok=True)
    for ext in (".npz", ".json"):
        shutil.copy(WORK / "teacher_cora" / f"cora-sage_transductive{ext}", student_dir)
    jobs = (("student", "transductive", student_dir, STUDENT_FLAGS, True),
            ("teacher", "production", REORDER / "production", TRAIN_FLAGS, False),
            ("student", "production", REORDER / "production", STUDENT_FLAGS, True))
    for role, setting, save, flags, student in jobs:
        label = f"reorder locality cora {role} {setting}"
        before = _counts()
        stats, report, _ = _train(["--datasets=cora", "--epochs=20", f"--dataset_dir={STANDINS}",
                                   "--reorder=locality", f"--transductive={setting}",
                                   f"--save_dir={save}", f"--results_dir={results}", *flags],
                                  student=student)
        counts = _delta(_counts(), before)
        losses = report["losses"][0]
        metric = stats["Hits@20"]
        log("reorder_train", {"dataset": "cora", "reorder": "locality", "role": role,
                              "setting": setting, "epoch_s": report["epoch_s"][1:],
                              "losses": losses, "Hits@20": {k: v[0] for k, v in metric.items()},
                              "launches": counts})
        if losses[-1] >= losses[0]:
            raise AssertionError(f"{label}: the loss did not fall: {losses}")
        if setting == "production":
            _check_production_launches(label, role, counts, report, 1433)
        elif counts["sddmm"] != 4 * len(report["eval_s"]):
            raise AssertionError(f"{label}: {counts['sddmm']} sddmm launches, expected 4 an "
                                 f"eval")
        else:
            _check_student_gathers(label, counts, report)
            _check_sddmm_route(label, counts)

    launches = {"segsum": segsum.launches, "sddmm": sddmm_mlp_score.launches,
                "heavy_first": segsum.heavy_first_launches,
                "sddmm_routes": _sddmm_routes(),
                "spmm_tiles": spmm_tiles_apply.launches,
                "spmm_tiles_backward": spmm_tiles.backward_launches,
                "spmm_tiles_by_shape": {f"{k[0]} d={k[1]}{' weighted' if k[2] else ''}": v
                                        for k, v in spmm_tiles_apply.launch_counts.items()}}
    path_counts = dict(spmm_tiles_apply.launch_counts)  # the timings below launch more
    log("reorder_launches", launches)
    if not spmm_tiles.backward_launches or any(
            not spmm_tiles_apply.launch_counts[(dt, 256, wt)]
            for dt in ("float32", "bfloat16") for wt in (False, True)):
        raise AssertionError(f"reorder: a tile kernel instance did not launch: {launches}")

    # the tiles alone against the plain version on the RCM graph: the
    # hybrid's (>= 16 edges) and every edge's (min_tile_edges 0), after the
    # counters
    fwd, _ = g.hybrid_tiles
    tiles0 = build_tiles(recv, send, n, device="cuda")[0]
    for tiles, label in ((fwd.tiles, "tiles"), (tiles0, "min0")):
        for xt, tag in ((x, "f32"), (xb, "bf16")):
            b5[f"{label}_{tag}"] = compare(spmm_tiles_apply(tiles, xt, n),
                                           spmm_tiles_apply_plain(tiles, xt, n), **SEGSUM_TOL,
                                           what=f"spmm_tiles {label} {tag} rcm")
    log("reorder_b5_tiles", {k: b5[k] for k in ("tiles_f32", "tiles_bf16", "min0_f32",
                                                "min0_bf16")})

    # B1 on each order, B5 beside it on the RCM graph
    seg = {}
    for name, gr in graphs.items():
        adj = torch.sparse_csr_tensor(gr.in_ptr, gr.senders,
                                      gr.inv_in_degree[gr.receivers], (n, n))
        seg[name] = _segsum_timing(x, gr.senders, gr.in_ptr, gr.inv_in_degree, adj)
        log("reorder_segsum", {"order": name, "n": n, "e": gr.num_edges, "d": 256,
                               **seg[name]})
    hybrid = {"order": "rcm", "d": 256, "reduce": "mean",
              "hybrid_ms": time_ms(lambda: spmm_tiles(g, x, "mean")),
              "tiles_only_ms": time_ms(lambda: spmm_tiles_apply(fwd.tiles, x, n)),
              "residual_edges": int(fwd.res_recv.numel()),
              "residual_segsum_ms": time_ms(lambda: segsum(x, fwd.res_send, fwd.res_ptr,
                                                           out_dtype=torch.float32)),
              "segsum_ms": seg["rcm"]["ms"], "sparse_mm_ms": seg["rcm"]["library_ms"],
              "apply_min0_ms": time_ms(lambda: spmm_tiles_apply(tiles0, x, n)),
              "apply_min0": tile_fill(tiles0)}
    log("reorder_b5_timing", hybrid)

    def err(*keys):  # the worst error of an instance, on the check graphs and here
        return max([worst[k] for k in keys if k in worst]
                   + [b5[k]["max_abs"] for k in keys if k in b5])

    entries = [
        _b5_timing("spmm_tiles.f32", fwd.tiles, x, n, path_counts.get(("float32", 256, False), 0),
                   err("spmm_tiles_f32", "spmm_tiles_hybrid", "spmm_tiles_hybrid_bwd",
                       "hybrid", "hybrid_backward", "tiles_f32", "min0_f32"),
                   "collab stand-in in RCM order, the hybrid's tiles (>= 16 edges), fp32"),
        _b5_timing("spmm_tiles.bf16", fwd.tiles, xb, n,
                   path_counts.get(("bfloat16", 256, False), 0),
                   err("spmm_tiles_bf16", "spmm_tiles_hybrid_bf16", "hybrid_bf16",
                       "tiles_bf16", "min0_bf16"),
                   "the same tiles, bf16 x"),
        _b5_timing("spmm_tiles.weighted.f32", tiles_w, x, n,
                   path_counts.get(("float32", 256, True), 0),
                   err("spmm_tiles_w_f32", "weighted_f32"),
                   "collab stand-in in RCM order, every edge, weights 1/deg (the mean)"),
        _b5_timing("spmm_tiles.weighted.bf16", tiles_w, xb, n,
                   path_counts.get(("bfloat16", 256, True), 0),
                   err("spmm_tiles_w_bf16", "weighted_bf16"),
                   "the same weighted tiles, bf16 x"),
    ]
    return {"launches": launches, "runs": runs, "fill": fill, "entries": entries}


def _segsum_timing(x, senders, in_ptr, scale, adj, out_dtype=None, weights=None) -> dict:
    """Kernel, plain and library times of one segsum at these inputs, and the
    bytes it must move: x once, the index arrays (the senders as int32, the
    kernel's index type; the scale and the weights) once, out once."""
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
    t["bytes"] = (n * x.shape[1] * (x.element_size() + out_bytes) + senders.numel() * 4
                  + in_ptr.numel() * 8 + (0 if scale is None else n * 4)
                  + (0 if weights is None else weights.numel() * 4))
    t["bound_ms"] = t["bytes"] / HBM_BYTES_PER_S * 1e3
    return t


def _segsum_design_timing(gen, tg) -> None:
    """B1 where its design is decided: on the power-law graph (hub rows),
    fp32 and bf16 at D=256 beside ``torch.sparse.mm``, with and without the
    heavy-first order (``ba_segsum:``); and the collab training graph's edge
    count gathered at D=256 from a table that fits L2, the rate the sliced
    gathers can reach (``segsum_l2:``)."""
    import torch

    from llp_tpu_torch.ops import segsum as segsum_mod

    gb = _ba_graph()
    n = gb.num_nodes
    adj = torch.sparse_csr_tensor(gb.in_ptr, gb.senders, gb.inv_in_degree[gb.receivers], (n, n))
    deg = gb.in_degree
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(n, 256, generator=gen, device="cuda").to(dtype)
        t = _segsum_timing(x, gb.senders, gb.in_ptr, gb.inv_in_degree, adj)
        heavy = segsum_mod.HEAVY_EDGES
        try:  # no row heavy enough: the plain slice-major order
            segsum_mod.HEAVY_EDGES = gb.num_edges
            t["ms_without_heavy_first"] = time_ms(
                lambda: segsum_mod.segsum(x, gb.senders, gb.in_ptr, gb.inv_in_degree))
        finally:
            segsum_mod.HEAVY_EDGES = heavy
        log("ba_segsum", {"n": n, "e": gb.num_edges, "d": 256, "dtype": str(dtype),
                          "max_in_degree": int(deg.max()),
                          "heavy_rows": int((deg > heavy).sum()), **t})
    n2, e = 20_000, tg.num_edges
    x = torch.randn(n2, 256, generator=gen, device="cuda")  # 20 MB: fits L2
    send = torch.randint(0, n2, (e,), generator=gen, device="cuda")
    ptr = torch.arange(n2 + 1, device="cuda") * e // n2
    ms = time_ms(lambda: segsum_mod.segsum(x, send, ptr))
    log("segsum_l2", {"n": n2, "e": e, "d": 256, "ms": ms,
                      "gather_bytes_per_s": e * 256 * 4 / ms * 1e3})


def _weighted_entries(gen, train: dict, worst: dict) -> list:
    """The weighted instances at the shapes of the weighted collab training
    runs: the GCN aggregation forward (fp32 and bf16 -> bf16, the raw
    weights) and backward (fp32 over the sender CSR, the weights read
    through ``sender_edge_id``) at D=256, and the SAGE layer-1 hoist (the
    weighted mean's normalised weights) at D=128. ``library_ms`` is
    ``torch.sparse.mm`` over a CSR that carries the same weights."""
    import torch

    g = train["data"]["weighted"]["graph"]
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
    four instances (fp32 or bf16, dense or int8); its plain version over the
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
    for tag, dt in (("int8", torch.float32), ("bf16_int8", torch.bfloat16)):
        q_h = table[qidx].to(dt)
        times[tag] = {
            "ms": time_ms(lambda: mlp_block_logits(lins, q_h, qt.q, scales=qt.scale), reps=3,
                          warmup=1),
            "plain_ms": time_ms(lambda: plain(q_h, qt.q, qt.scale), reps=3, warmup=1)}
    # each input read once, the (Q, B) logits written once
    out_bytes = q * n * 4
    nbytes = {"f32": n * h * 4 + q * h * 4 + weight_values * 4 + out_bytes,
              "bf16": n * h * 2 + q * h * 2 + weight_values * 4 + out_bytes,
              "int8": n * h + n * 4 + q * h * 4 + weight_values * 4 + out_bytes,
              "bf16_int8": n * h + n * 4 + q * h * 2 + weight_values * 4 + out_bytes}
    peak = {"f32": FP32_FLOP_PER_S, "int8": FP32_FLOP_PER_S, "bf16": BF16_FLOP_PER_S,
            "bf16_int8": BF16_FLOP_PER_S}
    for tag, t in times.items():
        t["bound_ms"] = max(flops / peak[tag], nbytes[tag] / HBM_BYTES_PER_S) * 1e3
        t["bound_by"] = ("operations" if flops / peak[tag] >= nbytes[tag] / HBM_BYTES_PER_S
                         else "bytes")
        log("timing", {"kernel": f"mlp_topk.{tag}", "q": q, "b": n, "h": h, "flops": flops,
                       "bytes": nbytes[tag], "tflop_per_s": flops / t["ms"] / 1e9, **t})

    topk = {"q": q, "b": n, "k": 10, "block_unfused": block}
    for tag, tbl, cdt in (("f32", table, None), ("int8", qt, None),
                          ("bf16", table, torch.bfloat16), ("bf16_int8", qt, torch.bfloat16)):
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
    f32, bf16, bf16_int8 = times["f32"], times["bf16"], times["bf16_int8"]
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
         "bound_by": bf16["bound_by"], "int8_ms": bf16_int8["ms"],
         "int8_plain_ms": bf16_int8["plain_ms"], "int8_bound_ms": bf16_int8["bound_ms"],
         "shapes": f"{shapes}, bf16 dense on the tensor cores (int8_*: int8 codes + scales)"},
    ]


def _relu_dropout_entries(gen, train: dict, student: dict, worst: dict) -> list:
    """The ReLU-dropout kernel at :data:`RELU_DROPOUT_SHAPES`, rate 0.5: the
    encoder's site with the addend (the SAGE conv's two terms), the head's
    without, in fp32 (the kernels line's entries) and bf16 (``relu_dropout:``
    lines). ``ms`` is the kernel's forward and backward, ``bound_ms`` their
    bytes at the HBM rate; ``plain_ms`` is the plain composition's forward
    and backward with its draw, against ``site_ms``, the kernel's with the
    same draw."""
    import torch

    from llp_tpu_torch.ops.build import load_library
    from llp_tpu_torch.ops.rng import relu_dropout_plain

    fwd = load_library("relu_dropout")
    bwd = load_library("relu_dropout", "llp_relu_dropout_backward")
    stream = torch.cuda.current_stream().cuda_stream
    paths = {"train": list(train["launches"]["relu_dropout"]),
             "student": list(student["launches"]["relu_dropout"])}
    keep = 0.5
    entries = []
    for (label, n, d), with_addend in zip(RELU_DROPOUT_SHAPES, (True, False)):
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).removeprefix("torch.")
            pre, add, cot = (torch.randn(n, d, generator=gen, device="cuda").to(dtype)
                             for _ in range(3))
            pre.requires_grad_(True)
            if with_addend:
                add.requires_grad_(True)
            else:
                add = None
            sgen = torch.Generator(device="cuda").manual_seed(1)
            draw = torch.rand(pre.shape, generator=sgen, device="cuda")
            out, dx = torch.empty_like(pre), torch.empty_like(pre)
            mask = torch.empty(pre.shape, dtype=torch.uint8, device="cuda")
            code = 0 if dtype == torch.float32 else 1
            forward_ms = time_ms(lambda: fwd(pre.data_ptr(), add.data_ptr() if with_addend
                                             else None, draw.data_ptr(), out.data_ptr(),
                                             mask.data_ptr(), pre.numel(), keep, 1 / keep, code,
                                             stream))
            backward_ms = time_ms(lambda: bwd(cot.data_ptr(), mask.data_ptr(), dx.data_ptr(),
                                              pre.numel(), 1 / keep, code, stream))
            draw_ms = time_ms(lambda: torch.rand(pre.shape, generator=sgen, device="cuda"))
            inputs = [t for t in (pre, add) if t is not None]
            plain_out = relu_dropout_plain(pre, 1 - keep, sgen, addend=add)
            plain_fwd = time_ms(lambda: relu_dropout_plain(pre, 1 - keep, sgen, addend=add))
            plain_bwd = time_ms(lambda: torch.autograd.grad(plain_out, inputs, cot,
                                                            retain_graph=True))
            es = pre.element_size()
            fwd_bytes = pre.numel() * (es * (3 if with_addend else 2) + 4 + 1)
            bwd_bytes = pre.numel() * (2 * es + 1)
            t = {"site": label, "rows": n, "d": d, "dtype": name, "addend": with_addend,
                 "forward_ms": forward_ms,
                 "forward_bound_ms": fwd_bytes / HBM_BYTES_PER_S * 1e3,
                 "backward_ms": backward_ms,
                 "backward_bound_ms": bwd_bytes / HBM_BYTES_PER_S * 1e3,
                 "draw_ms": draw_ms, "site_ms": draw_ms + forward_ms + backward_ms,
                 "plain_forward_ms": plain_fwd, "plain_backward_ms": plain_bwd,
                 "plain_site_ms": plain_fwd + plain_bwd}
            log("relu_dropout", t)
            del pre, add, cot, draw, out, dx, mask, plain_out, inputs
            if dtype != torch.float32:
                continue
            entries.append({
                "name": f"relu_dropout.{label}", "route": "cuda",
                "source": "llp_tpu_torch/csrc/relu_dropout.cu",
                "replaces": None,
                "replaces_note": "the JAX package leaves ReLU and dropout to XLA",
                "launches": sum(v[0] for v in paths.values()),
                "launches_by_path": paths,
                "launches_note": ("forward, backward on the train (2 sites a step) and "
                                  "student (3 a step) paths, both sites summed"),
                "max_abs_err": worst["relu_dropout"],
                "ms": forward_ms + backward_ms, "forward_ms": forward_ms,
                "backward_ms": backward_ms,
                "bound_ms": (fwd_bytes + bwd_bytes) / HBM_BYTES_PER_S * 1e3,
                "bound_by": "bytes", "plain_ms": t["plain_site_ms"], "site_ms": t["site_ms"],
                "draw_ms": draw_ms, "library_ms": None,
                "library_note": "no single PyTorch call",
                "shapes": (f"collab teacher {label} site: {n} x {d}, fp32, rate 0.5"
                           f"{', with the addend' if with_addend else ''}")})
    return entries


def phase_kernels(gen, launches: dict, train: dict, student: dict, production: dict,
                  tooling: dict, scale10m: dict, reorder: dict, worst: dict) -> list:
    """Times at the collab serving and training shapes; returns the kernels
    line's entries, with the tile kernel's from the reorder phase. The
    segsum entry's launches count the serving, production, tooling and
    reorder paths; the sddmm ones the serving, training, student,
    production, tooling and reorder paths; mlp_topk's the serving, student
    and tooling paths."""
    import torch

    from llp_tpu_torch.core.graph import build_graph
    from llp_tpu_torch.data.registry import get_dataset
    from llp_tpu_torch.models.predictor import LinkPredictor
    from llp_tpu_torch.ops.sddmm import head_weights, sddmm_mlp_score, sddmm_mlp_score_plain
    from llp_tpu_torch.serve import score_pairs

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
    # a small batch: one wave of blocks, no longer than the launch itself
    log("sddmm_small", {"table": [n, d], "h": hid, **{
        f"b{bs}_ms": time_ms(lambda: sddmm_mlp_score(table, table, src[:bs], dst[:bs],
                                                      w1, b1, w2, b2)) for bs in (700, 2048)}})
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
    # The kernel runs the W1 product as three TF32 products on the tensor
    # cores (3xTF32) and the rest (Hadamard, bias, relu, w2) on fp32 units.
    sd_tc_flops = 3 * b * 2 * d * hid
    sd_flops_ms = (sd_tc_flops / TF32_FLOP_PER_S + (sd_flops - b * 2 * d * hid)
                   / FP32_FLOP_PER_S) * 1e3
    sd_fp32_ms = sd_flops / FP32_FLOP_PER_S * 1e3
    entries = [
        {"name": "segsum", "route": "cuda", "source": "llp_tpu_torch/csrc/segsum.cu",
         "replaces": "llp_tpu/ops/pallas/segsum_kernel.py:148",
         "launches": (launches["segsum"] + production["launches"]["segsum"]
                      + tooling["launches"]["segsum"] + reorder["launches"]["segsum"]),
         "launches_by_path": {"serve": launches["segsum"],
                              "production": production["launches"]["segsum"],
                              "tooling": tooling["launches"]["segsum"],
                              "reorder": reorder["launches"]["segsum"]},
         # launches that ran the blocks holding a row of more than
         # HEAVY_EDGES edges first: none unless a path's graph has such rows
         "heavy_first_by_path": {p: d["heavy_first"] for p, d in (
             ("serve", launches), ("train", train["launches"]),
             ("student", student["launches"]), ("production", production["launches"]),
             ("tooling", tooling["launches"]), ("reorder", reorder["launches"]))},
         "max_abs_err": worst["segsum"],
         "ms": seg["ms"], "plain_ms": seg["plain_ms"], "bound_ms": seg_bound_ms,
         "bound_by": "bytes", "library_ms": seg["library_ms"],
         "shapes": f"collab serve encode: n={n} e={e}, d=128 + d=256, mean, fp32"},
        {"name": "sddmm", "route": "cuda", "source": "llp_tpu_torch/csrc/sddmm.cu",
         "replaces": "llp_tpu/ops/pallas/sddmm_kernel.py:41",
         "launches": (launches["sddmm"] + train["launches"]["sddmm"]
                      + student["launches"]["sddmm"] + production["launches"]["sddmm"]
                      + tooling["launches"]["sddmm"] + reorder["launches"]["sddmm"]),
         "launches_by_path": {"serve": launches["sddmm"], "train": train["launches"]["sddmm"],
                              "student": student["launches"]["sddmm"],
                              "production": production["launches"]["sddmm"],
                              "tooling": tooling["launches"]["sddmm"],
                              "reorder": reorder["launches"]["sddmm"]},
         "max_abs_err": worst["sddmm"],
         "ms": sd["ms"], "plain_ms": sd["plain_ms"],
         "bound_ms": max(sd_bytes_ms, sd_flops_ms),
         "bound_by": "operations" if sd_flops_ms >= sd_bytes_ms else "bytes",
         "bound_note": ("3xTF32: three TF32 products of the W1 GEMM at the TF32 peak, the "
                        "rest at the fp32 peak"),
         "fp32_bound_ms": max(sd_bytes_ms, sd_fp32_ms),
         "launches_by_route": dict(sum(
             (Counter(p["launches"]["sddmm_routes"]) for p in (train, student, production,
                                                             tooling, reorder)),
             Counter(launches["sddmm_routes"]))),
         "library_ms": None,
         "library_note": "no single PyTorch call gathers, multiplies and runs the MLP head",
         "shapes": f"{b} pairs over a {n} x {d} table, H={hid}"},
        *_mlp_topk_entries(gen, dict(sum((Counter(p["mlp_topk"]) for p in (
            student["launches"], tooling["launches"])), Counter(launches["mlp_topk"]))), worst),
    ]

    # The training shapes: the message graph of the collab split (the train
    # positives, both directions), forward over the receiver CSR and backward
    # over the sender CSR, as the collab training runs above launched them.
    tg = train["data"]["collab"]["graph"]
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
                if d == 256:  # the backward launches (the aggregation's and the
                    # gathers') share this instance and width
                    run_launches -= run["counts"]["backward"] + run["counts"]["gather"]
                    per_step -= ((prof["launches"]["backward"] + prof["launches"]["gather"])
                                 / prof["steps"])
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
    _segsum_design_timing(gen, tg)
    return (entries + _gather_entries(gen, train, student, scale10m, worst)
            + _weighted_entries(gen, train, worst) + reorder["entries"] + scale10m["entries"]
            + _relu_dropout_entries(gen, train, student, worst))


def _gather_entries(gen, train: dict, student: dict, scale10m: dict, worst: dict) -> list:
    """The gathers' backward at :data:`GATHER_SHAPES` and their types, three
    ways: ``gather_rows``' (the ids' CSR by a sort and a ``searchsorted``,
    then B1: ``csr_ms`` + ``ms`` = ``backward_ms``), PyTorch's backward of
    ``index_select`` (``index_add_`` in the cotangent's type, with atomics:
    ``library_ms``) and the same under deterministic algorithms; one
    ``gather_bwd:`` line each.  Returns one kernels-line entry per case and
    type, whose launches are those of the path the case stands for, at its
    type and width: the train phase's at d=256 (the teacher), the student
    phase's at d=256 (its rows) and at every other width (the rank loss's
    columns, a node batch wide), the 10M phase's at d=128."""
    import torch

    from llp_tpu_torch.ops.gather import gather_csr, gather_rows_backward_plain
    from llp_tpu_torch.ops.segsum import index_int32, segsum

    def by_width(counts) -> Counter:
        total = Counter()
        for c in counts:
            total.update(c["gather_by_width"])
        return total

    paths = {"teacher": by_width(r["counts"] for r in train["runs"].values()),
             "student": by_width(r["counts"] for r in student["runs"].values()),
             "scale10m": by_width(r["launches"] for r in scale10m["runs"])}
    paths["student_rank"] = Counter({k: v for k, v in paths["student"].items()
                                     if not k.endswith(" d=256")})
    path_notes = {"teacher": "the train phase's teacher steps at this type and width",
                  "student": "the student phase's full-batch rows at this type and width",
                  "student_rank": "the student phase's rank-loss columns at this type, "
                                  "every node-batch width",
                  "scale10m": "the 10M phase's steps at this type and width"}
    mode = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    entries = []
    for label, n, k, d, dtypes in GATHER_SHAPES:
        idx = _gather_ids(gen, label, n, k)
        senders, in_ptr = gather_csr(idx, n)
        for name in dtypes:
            dtype = getattr(torch, name)
            tag = "f32" if dtype == torch.float32 else "bf16"
            g = torch.randn(idx.numel(), d, generator=gen, device="cuda").to(dtype)

            def index_add():  # PyTorch's backward of index_select
                return torch.zeros((n, d), dtype=dtype, device="cuda").index_add_(0, idx, g)

            index_int32(senders)  # the kernel reads int32 senders, made once here
            t = {"ms": time_ms(lambda: segsum(g, senders, in_ptr, order_heavy=False)),
                 "csr_ms": time_ms(lambda: index_int32(gather_csr(idx, n)[0])),
                 "backward_ms": time_ms(lambda: segsum(g, *gather_csr(idx, n),
                                                       order_heavy=False)),
                 "plain_ms": time_ms(lambda: gather_rows_backward_plain(g, idx, n)),
                 "library_ms": time_ms(index_add)}
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                t["index_add_deterministic_ms"] = time_ms(index_add)
            finally:
                torch.use_deterministic_algorithms(mode[0], warn_only=mode[1])
            # the cotangent, the int32 senders and the offsets read once, the
            # (N, d) gradient written once
            nbytes = (idx.numel() * d * g.element_size() + idx.numel() * 4
                      + in_ptr.numel() * 8 + n * d * g.element_size())
            t["bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
            log("gather_bwd", {"case": label, "dtype": tag, "n": n, "ids": idx.numel(), "d": d,
                               "bytes": nbytes, **t})
            launches = paths[label]
            own = ({k: v for k, v in launches.items() if k.startswith(name + " ")}
                   if label == "student_rank" else
                   {_width_key(name, d): launches[_width_key(name, d)]})
            entry = {
                "name": f"segsum.gather_bwd.{tag}.{label}", "route": "cuda",
                "source": "llp_tpu_torch/csrc/segsum.cu",
                "replaces": ("llp_tpu/ops/pallas/segsum_kernel.py:"
                             f"{148 if dtype == torch.float32 else 191}"),
                "launches": sum(own.values()), "launches_by_width": own,
                "launches_note": f"gather_rows' backward on {path_notes[label]}",
                "max_abs_err": worst[_gather_err_key(label, name)],
                "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": "bytes", "library_ms": t["library_ms"],
                "library_note": "index_add_, PyTorch's backward of index_select (atomics)",
                "csr_ms": t["csr_ms"],
                "index_add_deterministic_ms": t["index_add_deterministic_ms"],
                "shapes": f"{label}: {idx.numel()} ids into {n} x {d}, {name}"}
            if not entry["launches"]:
                raise AssertionError(f"gather {label} {name}: no launch on {path_notes[label]}")
            if label == "teacher":
                other = {k: v for k, v in launches.items()
                         if k.startswith(name + " ") and k != _width_key(name, d)}
                if other:
                    entry["launches_other_widths"] = other
            entries.append(entry)
    return entries


# ---------------------------------------------------------------- dp phase

# The data-parallel phase's runs. (b): the first DP_STEPS steps of the
# collab teacher on two gloo ranks of the one card (the positives cut to
# DP_STEPS batches) and DP_STUDENT_EPOCHS epochs of the cora student (a
# step each), their losses held against the single-card runs at DP_TOL. The
# parameters are held to Adam's step, lr a step: a gradient that is 0 but
# for rounding (cora's sparse features leave many) may flip sign when its
# sum runs in another order, and Adam's normalised step turns either sign
# into a move of up to lr; the share of DP_TOL they use is logged.
DP_BATCH = 65536
DP_STEPS = 4
DP_STUDENT_EPOCHS = 2
DP_LR = 0.005
DP_TOL = dict(rtol=2e-4, atol=2e-5)
DP_TIMEOUT_S = 300.0


def _dp_state(trainer) -> list:
    return [t.detach().clone() for t in trainer.model.state_dict().values()]


def _dp_epoch(trainer) -> dict:
    """One epoch of ``trainer`` from a fixed generator seed: its wall time,
    loss (and step losses), the launches, the bytes summed across ranks and
    the model's state after it."""
    import torch

    from llp_tpu_torch.parallel.mesh import World
    from llp_tpu_torch.parallel.sharded import sharded_spmm

    gen = torch.Generator(device="cuda").manual_seed(1)
    torch.cuda.synchronize()
    before, shards, sent = _counts(), Counter(sharded_spmm.launch_counts), World.all_reduce.bytes
    t0 = time.perf_counter()
    loss = trainer.epoch(gen)
    torch.cuda.synchronize()
    return {"epoch_s": time.perf_counter() - t0, "loss": float(loss), "steps": trainer.steps,
            "step_losses": getattr(trainer, "step_losses", loss.reshape(1)).clone(),
            "launches": _delta(_counts(), before),
            "shard_launches": Counter(sharded_spmm.launch_counts) - shards,
            "reduced_bytes": World.all_reduce.bytes - sent, "state": _dp_state(trainer),
            "rng": gen.get_state()}


def _dp_world_of_one(label: str, make, world) -> dict:
    """``make(world)``'s trainer for two epochs on the single path (world
    None) and as the one rank of ``world``, in turns (single, world, world,
    single): after each epoch the losses, the parameters and buffers and
    the generator bit for bit (else held at DP_TOL, the gap logged), and
    the same B1 launches; a teacher's aggregations over the shard (the
    student aggregates nothing). The second epochs' times are the ones to
    compare (the first holds any warm-up)."""
    single_t, dp_t = make(None), make(world)
    first = _dp_pair(label, _dp_epoch(single_t), _dp_epoch(dp_t))
    dp, single = _dp_epoch(dp_t), _dp_epoch(single_t)
    second = _dp_pair(label + " epoch 2", single, dp)
    return {"counts": first["counts"] + second["counts"]}


def _dp_pair(label: str, single: dict, dp: dict) -> dict:
    """One epoch of each path (:func:`_dp_epoch`) held against the other;
    logs a ``dp_world1:`` line and returns it with the shard's launches."""
    import torch

    bitwise = (torch.equal(single["step_losses"], dp["step_losses"])
               and torch.equal(single["rng"], dp["rng"])
               and all(torch.equal(a, b) for a, b in zip(single["state"], dp["state"])))
    gap = max(float((a.double() - b.double()).abs().max()) if a.numel() else 0.0
              for a, b in zip(single["state"], dp["state"]))
    steps = dp["steps"]
    line = {"run": label, "bitwise": bitwise, "max_abs_state_gap": gap,
            "loss_single": single["loss"], "loss_world1": dp["loss"], "steps": steps,
            "epoch_s_single": single["epoch_s"], "epoch_s_world1": dp["epoch_s"],
            "segsum_per_step_single": single["launches"]["segsum"] / steps,
            "segsum_per_step_world1": dp["launches"]["segsum"] / steps,
            "shard_launches": {" ".join(map(str, k)): v for k, v in dp["shard_launches"].items()},
            "reduced_bytes_per_step": dp["reduced_bytes"] / steps}
    log("dp_world1", line)
    for key in ("segsum", "backward", "weighted_backward", "gather"):
        if single["launches"][key] != dp["launches"][key]:
            raise AssertionError(f"dp {label}: {key} launches {dp['launches'][key]} at a "
                                 f"world of one, {single['launches'][key]} on one card")
    if "student" not in label and not dp["shard_launches"]:
        raise AssertionError(f"dp {label}: no launch over the shard")
    if not bitwise:
        compare(dp["step_losses"], single["step_losses"], **DP_TOL, what=f"dp {label} losses")
        for a, b in zip(dp["state"], single["state"]):
            compare(a, b, **DP_TOL, what=f"dp {label} parameters")
    return {**line, "counts": dp["shard_launches"]}


def _dp_teacher(data: dict, dtype: str, encoder: str = "sage"):
    """A maker of the full-width collab teacher's trainer (hidden 256, a
    2-layer mlp head, dropout 0.5, batch 65,536) for :func:`_dp_world_of_one`."""
    import torch

    from llp_tpu_torch.train.teacher import TeacherTrainer, init_teacher

    def make(world):
        model = init_teacher(encoder=encoder, in_channels=data["x"].shape[1],
                             hidden_channels=256, num_layers=2, predictor_mode="mlp",
                             dropout=0.5, generator=torch.Generator().manual_seed(0)).cuda()
        return TeacherTrainer(model, data["graph"], data["x"], data["pos_edges"],
                              encoder=encoder, batch_size=DP_BATCH, neg_mode="uniform",
                              compute_dtype=dtype, world=world)

    return make


def _dp_student(data: dict, teacher: Path):
    """A maker of the full-width collab student's trainer (hidden 256, the
    default losses, dropout 0.5) distilling from the artifact ``teacher``."""
    import numpy as np
    import torch

    from llp_tpu_torch.train.student import StudentTrainer, init_student
    from llp_tpu_torch.utils.checkpoint import load_checkpoint
    from llp_tpu_torch.utils.config import StudentConfig
    from llp_tpu_torch.utils.params import from_jax

    ckpt, _ = load_checkpoint(str(teacher))
    t_h = torch.from_numpy(np.asarray(ckpt["features"], np.float32)).cuda()
    n, d = data["x"].shape
    node_batch = StudentConfig(datasets="collab").coupled_node_batch_size(n, data["num_pos"])

    def make(world):
        model = init_student(in_channels=d, hidden_channels=256, num_layers=2,
                             predictor_mode="mlp", dropout=0.5,
                             generator=torch.Generator().manual_seed(0)).cuda()
        return StudentTrainer(model, data["graph"], data["x"], t_h,
                              from_jax(ckpt["params"]["predictor"]), data["pos_edges"],
                              link_batch_size=DP_BATCH, node_batch_size=node_batch,
                              neg_mode="uniform", world=world)

    return make


def _dp_gloo_jobs(train: dict) -> list:
    """(b)'s jobs for :func:`llp_tpu_torch.tools.dp_runs.run_jobs`: the collab
    teacher's first DP_STEPS steps (fp32) and a cora student epoch, at full
    width, from seeds."""
    import numpy as np
    import torch

    from llp_tpu_torch.train.loop import prepare_transductive
    from llp_tpu_torch.utils.checkpoint import load_checkpoint
    from llp_tpu_torch.utils.config import StudentConfig

    collab = train["data"]["collab"]
    g = collab["graph"]
    teacher = dict(edge_index=torch.stack([g.senders, g.receivers]).cpu().numpy(),
                   num_nodes=g.num_nodes, x=collab["x"].cpu().numpy(),
                   pos=collab["pos_edges"][:DP_STEPS * DP_BATCH].cpu().numpy(),
                   encoder="sage", hidden=256, dropout=0.5, seed=0, gen_seed=1,
                   batch=DP_BATCH, lr=DP_LR, neg_mode="uniform", epochs=1)
    cfg = StudentConfig(datasets="cora", dataset_dir=STANDINS)
    cora = prepare_transductive(cfg, torch.device("cpu"))
    ckpt, _ = load_checkpoint(str(WORK / "teacher_cora" / "cora-sage_transductive"))
    cg = cora["graph"]
    student = dict(edge_index=torch.stack([cg.senders, cg.receivers]).numpy(),
                   num_nodes=cg.num_nodes, x=cora["x"].numpy(),
                   pos=cora["pos_edges"].numpy(),
                   t_h=np.asarray(ckpt["features"], np.float32),
                   teacher_predictor=ckpt["params"]["predictor"], hidden=256, dropout=0.5,
                   seed=0, gen_seed=1, epochs=DP_STUDENT_EPOCHS,
                   trainer=dict(link_batch_size=DP_BATCH, lr=DP_LR, neg_mode="dense",
                                node_batch_size=cfg.coupled_node_batch_size(
                                    cg.num_nodes, cora["num_pos"])))
    return [("teacher", teacher), ("student", student)]


def _dp_two_gloo_ranks(train: dict) -> dict:
    """(b): two ranks on the one card over gloo (which sums CUDA tensors
    through the host), so B1 runs over each half of the collab edges on the
    card, held against the same runs on one card."""
    import torch

    from llp_tpu_torch.parallel.launch import launch
    from llp_tpu_torch.tools.dp_runs import run_jobs

    jobs = _dp_gloo_jobs(train)
    t0 = time.perf_counter()
    ranks = launch(run_jobs, ["cuda:0", "cuda:0"], jobs, backend="gloo",
                   timeout=DP_TIMEOUT_S, join_timeout=2 * DP_TIMEOUT_S)
    gloo_s = time.perf_counter() - t0
    singles = run_jobs([(kind, dict(spec, device="cuda")) for kind, spec in jobs])
    counts, lines = Counter(), {}
    for i, (kind, _) in enumerate(jobs):
        one, (r0, r1) = singles[i], (ranks[0][i], ranks[1][i])
        for key in ("params", "buffers"):
            for a, b in zip(_leaves(r0[key]), _leaves(r1[key])):
                if not _np_equal(a, b):
                    raise AssertionError(f"dp gloo {kind}: the ranks' {key} differ")
        got = r0.get("step_losses", [r0["losses"]])[0]
        want = one.get("step_losses", [one["losses"]])[0]
        err = compare(torch.as_tensor(got), torch.as_tensor(want), **DP_TOL,
                      what=f"dp gloo {kind} losses")
        steps = r0["steps"] * len(r0["losses"])  # the run's, over its epochs
        tol = dict(rtol=0.0, atol=DP_LR * steps)
        pairs = [(torch.as_tensor(a), torch.as_tensor(b))
                 for a, b in zip(_leaves(r0["params"]), _leaves(one["params"]))]
        for a, b in pairs:
            compare(a, b, **tol, what=f"dp gloo {kind} parameters")
        used = max(float(((a.double() - b.double()).abs()
                          / (DP_TOL["atol"] + DP_TOL["rtol"] * b.double().abs())).max())
                   for a, b in pairs)
        for r in (r0, r1):
            counts.update(r["shard_launches"])
        lines[kind] = {"run": kind, "steps": steps, "losses": list(map(float, got)),
                       "single_losses": list(map(float, want)), "loss_tol_used": err["tol_used"],
                       "param_atol": tol["atol"], "param_dp_tol_used": used,
                       "segsum_per_rank_step": r0["segsum_launches"] / steps,
                       "segsum_single_step": one["segsum_launches"] / steps,
                       "reduced_bytes_per_step": r0["reduced_bytes"] / steps}
        log("dp_gloo", lines[kind])
    if not counts:
        raise AssertionError("dp gloo: no launch over a shard")
    log("dp_gloo_total", {"seconds": gloo_s})
    return {"counts": counts, "lines": lines}


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in _leaves(item)]
    return [tree]


def _np_equal(a, b) -> bool:
    import numpy as np

    return np.array_equal(np.asarray(a), np.asarray(b))


def _dp_cli_two_cards() -> None:
    """(c): ``train_teacher --num_devices 2`` on collab over NCCL, with two
    cards visible."""
    import torch

    if torch.cuda.device_count() < 2:
        log("dp_cli", "skipped: one card visible (train_teacher --num_devices 2 needs two)")
        return
    stats, report, _ = _train(["--datasets=collab", "--epochs=1", f"--dataset_dir={STANDINS}",
                               f"--save_dir={WORK / 'dp'}", f"--results_dir={WORK / 'dp'}",
                               *TRAIN_FLAGS, "--num_devices=2"])
    log("dp_cli", {"num_devices": 2, "losses": report["losses"], "epoch_s": report["epoch_s"],
                   "Hits@50": stats["Hits@50"]})


# The shard B1 entries: (name, x's type, the CSR (fwd: receiver, bwd:
# sender), weighted, the counted key's direction and instance).
DP_SHARD_KERNELS = (
    ("segsum.dp_shard.fwd.f32.d256", "float32", "fwd", False, "float32->float32"),
    ("segsum.dp_shard.bwd.f32.d256", "float32", "bwd", False, "float32->float32"),
    ("segsum.dp_shard.fwd.bf16->f32.d256", "bfloat16", "fwd", False, "bfloat16->float32"),
    ("segsum.dp_shard.weighted.fwd.bf16->f32.d256", "bfloat16", "fwd", True,
     "bfloat16->float32"),
)


def _dp_shard_entries(gen, train: dict, counts: Counter) -> list:
    """B1 over rank 0's shard of a world of two (half the collab edges, the
    weighted export's for the weighted instance) at D=256: against
    ``segsum_plain`` over the same CSR, two launches equal bit for bit, and
    timed beside ``torch.sparse.mm`` over that CSR. The bound counts all
    N x D output rows, which every rank writes."""
    import torch

    from llp_tpu_torch.ops.segsum import segsum, segsum_plain
    from llp_tpu_torch.parallel.mesh import World, shard_edges

    half = World(rank=0, size=2, device=torch.device("cuda", 0), backend="gloo")
    shards = {w: shard_edges(train["data"]["weighted" if w else "collab"]["graph"], half)
              for w in (False, True)}
    entries = []
    for name, dtype, direction, weighted, inst in DP_SHARD_KERNELS:
        s = shards[weighted]
        n = s.num_nodes
        idx, ptr = (s.senders, s.in_ptr) if direction == "fwd" else (s.col, s.row_ptr)
        w = s.edge_weight if weighted else None
        x = torch.randn(n, 256, generator=gen, device="cuda").to(getattr(torch, dtype))
        got = segsum(x, idx, ptr, weights=w, out_dtype=torch.float32)
        again = segsum(x, idx, ptr, weights=w, out_dtype=torch.float32)
        if not torch.equal(got, again):
            raise AssertionError(f"{name}: two launches differ")
        err = compare(got, segsum_plain(x, idx, ptr, weights=w, out_dtype=torch.float32),
                      **SEGSUM_TOL, what=name)
        adj = torch.sparse_csr_tensor(ptr, idx, torch.ones_like(idx, dtype=torch.float32)
                                      if w is None else w, (n, n))
        t = _segsum_timing(x, idx, ptr, None, adj, out_dtype=torch.float32, weights=w)
        launches = counts.get((direction, inst, 256, weighted), 0)
        if not launches:
            raise AssertionError(f"{name}: no launch on the dp path")
        log("timing", {"kernel": name, "n": n, "e": s.num_edges, "d": 256, **t})
        entry = {"name": name, "route": "cuda", "source": "llp_tpu_torch/csrc/segsum.cu",
                 "replaces": "llp_tpu/ops/pallas/segsum_kernel.py:148",
                 "launches": launches, "max_abs_err": err["max_abs"], "ms": t["ms"],
                 "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": "bytes",
                 "library_ms": t["library_ms"],
                 "shapes": (f"rank 0 of 2's shard of the {'weighted ' if weighted else ''}"
                            f"collab train graph, {'receiver' if direction == 'fwd' else 'sender'}"
                            f" CSR: n={n} e={s.num_edges}, d=256, {inst}, no scale")}
        if "library_note" in t:
            entry["library_note"] = t["library_note"]
        entries.append(entry)
    return entries


def phase_dp(gen, train: dict) -> dict:
    """The data-parallel path (``TeacherTrainer``/``StudentTrainer`` with a
    world): (a) a world of one over NCCL on ``cuda:0`` against the single
    path, bit for bit, for the collab SAGE teacher (fp32, bf16), the weighted
    GCN teacher (bf16: the weighted bf16 -> fp32 instance) and the collab
    student, one epoch each; (b) two gloo ranks on the card against one
    card; (c) the CLI over two cards, when there are two; then the shard's
    B1 against its plain version and timed. Returns the kernels line's
    entries for the shard's launches."""
    import torch

    from llp_tpu_torch.parallel.launch import free_tcp_address
    from llp_tpu_torch.parallel.mesh import close_world, init_world
    from llp_tpu_torch.parallel.sharded import sharded_spmm

    # the dp path starts here
    sharded_spmm.launch_counts.clear()
    world = init_world(0, 1, torch.device("cuda", 0), init_method=free_tcp_address(),
                       timeout=DP_TIMEOUT_S)
    try:
        counts = Counter()
        data = train["data"]
        runs = (("collab sage float32", _dp_teacher(data["collab"], "float32")),
                ("collab sage bfloat16", _dp_teacher(data["collab"], "bfloat16")),
                ("weighted collab gcn bfloat16",
                 _dp_teacher(data["weighted"], "bfloat16", encoder="gcn")),
                ("collab student float32",
                 _dp_student(data["weighted"],
                             WORK / "teacher_weighted" / "collab-sage_transductive")))
        for label, make in runs:
            counts.update(_dp_world_of_one(label, make, world)["counts"])
    finally:
        close_world()
    gloo = _dp_two_gloo_ranks(train)
    counts.update(gloo["counts"])
    _dp_cli_two_cards()
    log("dp_launches", {" ".join(map(str, k)): v for k, v in counts.items()})
    return {"entries": _dp_shard_entries(gen, train, counts)}


# The halo phase (--sharding halo). (b): the collab SAGE teacher's first
# DP_STEPS steps on two gloo ranks of the one card (dropout 0: the ranks
# draw their node rows' masks from streams of their own), its losses at
# DP_TOL against one card and its parameters within lr a step; the cora
# table student HALO_STUDENT_EPOCHS epochs, bit for bit against the dp
# minibatch student in the same world.
HALO_STUDENT_EPOCHS = 2

# The halo B1 entries: (name, x's type, the plan's part, direction, weighted).
HALO_KERNELS = (
    ("segsum.halo.local.fwd.f32.d256", "float32", "local", "fwd", False),
    ("segsum.halo.local.bwd.f32.d256", "float32", "local", "bwd", False),
    ("segsum.halo.remote.fwd.f32.d256", "float32", "remote", "fwd", False),
    ("segsum.halo.remote.bwd.f32.d256", "float32", "remote", "bwd", False),
    ("segsum.halo.owner.bwd.f32.d256", "float32", "owner", "bwd", False),
    ("segsum.halo.local.fwd.bf16->f32.d256", "bfloat16", "local", "fwd", False),
    ("segsum.halo.local.bwd.bf16->f32.d256", "bfloat16", "local", "bwd", False),
    ("segsum.halo.local.weighted.fwd.bf16->f32.d256", "bfloat16", "local", "fwd", True),
    ("segsum.halo.local.weighted.bwd.f32.d256", "float32", "local", "bwd", True),
)


def _halo_epoch(trainer) -> dict:
    """:func:`_dp_epoch` with the halo aggregation's and ``table_gather``'s
    launches in it."""
    from llp_tpu_torch.parallel.epoch import table_gather
    from llp_tpu_torch.parallel.halo import halo_spmm

    halo, table = Counter(halo_spmm.launch_counts), table_gather.launches
    out = _dp_epoch(trainer)
    out["halo_launches"] = Counter(halo_spmm.launch_counts) - halo
    out["table_gather"] = table_gather.launches - table
    return out


def _halo_world_of_one(label: str, make, world) -> Counter:
    """(a): ``make(world)``'s trainer for two epochs on the single path and
    as the one rank of a halo ``world``, in turns (single, world, world,
    single): losses, parameters, buffers and generator bit for bit after
    each epoch, and the same B1 launches (the halo path's gathers through
    ``table_gather``). Returns the halo launches."""
    import torch

    single_t, halo_t = make(None), make(world)
    counts = Counter()
    first = (_halo_epoch(single_t), _halo_epoch(halo_t))
    second = _halo_epoch(halo_t), _halo_epoch(single_t)
    for i, (single, halo) in enumerate((first, second[::-1])):
        run = label if not i else f"{label} epoch 2"
        bitwise = (torch.equal(single["step_losses"], halo["step_losses"])
                   and torch.equal(single["rng"], halo["rng"])
                   and all(torch.equal(a, b) for a, b in zip(single["state"], halo["state"])))
        steps = halo["steps"]
        s, h = single["launches"], halo["launches"]
        line = {"run": run, "bitwise": bitwise, "loss_single": single["loss"],
                "loss_world1": halo["loss"], "steps": steps,
                "epoch_s_single": single["epoch_s"], "epoch_s_world1": halo["epoch_s"],
                "segsum_per_step_single": s["segsum"] / steps,
                "segsum_per_step_world1": h["segsum"] / steps,
                "halo_launches": {" ".join(map(str, k)): v
                                  for k, v in halo["halo_launches"].items()},
                "table_gather_launches": halo["table_gather"],
                "reduced_bytes_per_step": halo["reduced_bytes"] / steps}
        log("halo_world1", line)
        if not bitwise:
            raise AssertionError(f"halo {run}: a world of one is not the single path bit for bit")
        for key in ("segsum", "backward", "weighted_backward", "sddmm"):
            if s[key] != h[key]:
                raise AssertionError(f"halo {run}: {key} launches {h[key]} at a world of one, "
                                     f"{s[key]} on the single path")
        if s["gather"] != h["gather"] + halo["table_gather"]:
            raise AssertionError(f"halo {run}: {s['gather']} gather launches on the single "
                                 f"path, {h['gather']} + {halo['table_gather']} table_gather")
        if "student" not in label and not halo["halo_launches"]:
            raise AssertionError(f"halo {run}: no launch of the halo aggregation")
        counts.update(halo["halo_launches"])
    return counts


def _halo_teacher(data: dict, dtype: str, encoder: str = "sage", dropout: float = 0.5):
    """A maker of the full-width collab teacher's trainer, halo over a
    world, for :func:`_halo_world_of_one`."""
    import torch

    from llp_tpu_torch.train.teacher import TeacherTrainer, init_teacher

    def make(world):
        model = init_teacher(encoder=encoder, in_channels=data["x"].shape[1],
                             hidden_channels=256, num_layers=2, predictor_mode="mlp",
                             dropout=dropout, generator=torch.Generator().manual_seed(0)).cuda()
        return TeacherTrainer(model, data["graph"], data["x"], data["pos_edges"],
                              encoder=encoder, batch_size=DP_BATCH, neg_mode="uniform",
                              compute_dtype=dtype, world=world, sharding="halo")

    return make


def _halo_student(data: dict, teacher: Path):
    """A maker of the full-width collab minibatch student's trainer, its
    features and teacher table sharded by rows over a world."""
    import numpy as np
    import torch

    from llp_tpu_torch.train.student import StudentTrainer, init_student
    from llp_tpu_torch.utils.checkpoint import load_checkpoint
    from llp_tpu_torch.utils.config import StudentConfig
    from llp_tpu_torch.utils.params import from_jax

    ckpt, _ = load_checkpoint(str(teacher))
    t_h = torch.from_numpy(np.asarray(ckpt["features"], np.float32)).cuda()
    n, d = data["x"].shape
    node_batch = StudentConfig(datasets="collab").coupled_node_batch_size(n, data["num_pos"])

    def make(world):
        model = init_student(in_channels=d, hidden_channels=256, num_layers=2,
                             predictor_mode="mlp", dropout=0.5,
                             generator=torch.Generator().manual_seed(0)).cuda()
        return StudentTrainer(model, data["graph"], data["x"], t_h,
                              from_jax(ckpt["params"]["predictor"]), data["pos_edges"],
                              link_batch_size=DP_BATCH, node_batch_size=node_batch,
                              neg_mode="uniform", minibatch=True, world=world,
                              table=world is not None)

    return make


def _halo_eval_world_of_one(data: dict, world) -> dict:
    """(e): the halo evaluator at a world of one against the single path's
    on collab, full width: the same metrics and embeddings bit for bit, and
    the same pair-scorer (B3) launches."""
    import torch

    from llp_tpu_torch.evaln.transductive import evaluate_transductive
    from llp_tpu_torch.parallel.eval import evaluate_halo_transductive
    from llp_tpu_torch.parallel.halo import halo_graph
    from llp_tpu_torch.train.teacher import init_teacher

    model = init_teacher(encoder="sage", in_channels=data["x"].shape[1], hidden_channels=256,
                         num_layers=2, predictor_mode="mlp",
                         generator=torch.Generator().manual_seed(0)).cuda()
    enc, pred = model["encoder"], model["predictor"]
    hg = halo_graph(data["graph"], world)
    ks = (10, 50, 100)
    c0 = _counts()
    single, h_single = evaluate_transductive(enc, pred, data["graph"], data["x"],
                                             data["eval_edges"], hits_ks=ks)
    c1 = _counts()
    halo, h_halo = evaluate_halo_transductive(enc, pred, hg, data["x"], data["eval_edges"],
                                              hits_ks=ks)
    c2 = _counts()
    s, h = _delta(c1, c0), _delta(c2, c1)
    line = {"results_single": single, "results_world1": halo,
            "h_bitwise": bool(torch.equal(h_single, h_halo)), "sddmm_single": s["sddmm"],
            "sddmm_world1": h["sddmm"], "segsum_single": s["segsum"],
            "segsum_world1": h["segsum"]}
    log("halo_eval", line)
    if single != halo or not line["h_bitwise"]:
        raise AssertionError("halo eval: a world of one differs from the single path")
    if not h["sddmm"] or h["sddmm"] != s["sddmm"] or h["segsum"] != s["segsum"]:
        raise AssertionError(f"halo eval: launches {h} at a world of one, {s} single")
    _check_sddmm_route("halo eval", h)
    return line


def _halo_gloo_jobs(train: dict) -> list:
    """(b)'s jobs: the collab halo teacher's first DP_STEPS steps, fp32,
    dropout 0; the cora table student and the dp minibatch student."""
    kinds = dict(_dp_gloo_jobs(train))
    teacher = dict(kinds["teacher"], dropout=0.0, sharding="halo")
    student = dict(kinds["student"], epochs=HALO_STUDENT_EPOCHS)
    student["trainer"] = dict(student["trainer"], minibatch=True, table=True)
    dp_student = dict(student, trainer=dict(student["trainer"], table=False))
    return [("teacher", teacher), ("student", student), ("student", dp_student)]


def _halo_two_gloo_ranks(train: dict) -> dict:
    """(b) and (d): two ranks on the one card over gloo (their exchanges go
    through the host), so B1 runs over each rank's local and remote edges
    and the owner scatter on the card, held against one card; the rows and
    bytes a step exchanges, and each rank's peak memory."""
    import torch

    from llp_tpu_torch.parallel.launch import launch
    from llp_tpu_torch.tools.dp_runs import run_jobs

    jobs = _halo_gloo_jobs(train)
    t0 = time.perf_counter()
    ranks = launch(run_jobs, ["cuda:0", "cuda:0"], jobs, backend="gloo",
                   timeout=DP_TIMEOUT_S, join_timeout=2 * DP_TIMEOUT_S)
    gloo_s = time.perf_counter() - t0
    (r0, r1) = (ranks[0][0], ranks[1][0])
    one = run_jobs([("teacher", dict(jobs[0][1], sharding="dp", device="cuda"))])[0]
    for key in ("params", "buffers"):
        for a, b in zip(_leaves(r0[key]), _leaves(r1[key])):
            if not _np_equal(a, b):
                raise AssertionError(f"halo gloo teacher: the ranks' {key} differ")
    got, want = r0["step_losses"][0], one["step_losses"][0]
    err = compare(torch.as_tensor(got), torch.as_tensor(want), **DP_TOL,
                  what="halo gloo teacher losses")
    steps = r0["steps"]
    for a, b in zip(_leaves(r0["params"]), _leaves(one["params"])):
        compare(torch.as_tensor(a), torch.as_tensor(b), rtol=0.0, atol=DP_LR * steps,
                what="halo gloo teacher parameters")
    counts = Counter()
    for r in (r0, r1):
        counts.update(r["halo_launches"])
    log("halo_gloo", {"run": "collab sage float32", "steps": steps,
                      "losses": list(map(float, got)), "single_losses": list(map(float, want)),
                      "loss_tol_used": err["tol_used"], "param_atol": DP_LR * steps,
                      "segsum_per_rank_step": [r["segsum_launches"] / steps for r in (r0, r1)],
                      "halo_launches": [{" ".join(map(str, k)): v
                                         for k, v in r["halo_launches"].items()}
                                        for r in (r0, r1)]})
    log("halo_bytes", {"run": "collab sage float32, 2 gloo ranks on one card",
                       "owned_rows": [r["owned_rows"] for r in (r0, r1)],
                       "halo_rows_received": [r["halo_recv_rows"] for r in (r0, r1)],
                       "halo_rows_sent": [r["halo_send_rows"] for r in (r0, r1)],
                       "exchanged_bytes_per_step": [r["exchanged_bytes"] / steps
                                                    for r in (r0, r1)],
                       "all_reduce_bytes_per_step": [r["reduced_bytes"] / steps
                                                     for r in (r0, r1)],
                       "peak_bytes": [r["peak_bytes"] for r in (r0, r1)],
                       "single_card_peak_bytes": one["peak_bytes"]})
    for rank in ranks:
        table, dp = rank[1], rank[2]
        same = (table["losses"] == dp["losses"] and _np_equal(table["rng"], dp["rng"])
                and all(_np_equal(a, b) for a, b in zip(_leaves(table["params"]),
                                                        _leaves(dp["params"]))))
        if not same:
            raise AssertionError("halo gloo: the table student is not the dp student bit for bit")
    log("halo_gloo", {"run": "cora table student", "epochs": HALO_STUDENT_EPOCHS,
                      "losses": ranks[0][1]["losses"], "dp_losses": ranks[0][2]["losses"],
                      "bitwise": True, "peak_bytes": [r[1]["peak_bytes"] for r in ranks]})
    if not counts:
        raise AssertionError("halo gloo: no launch of the halo aggregation")
    log("halo_gloo_total", {"seconds": gloo_s})
    return {"counts": counts}


def _halo_cli_two_cards() -> None:
    """(c): ``train_teacher --num_devices 2 --sharding halo`` on collab over
    NCCL, with two cards visible."""
    import torch

    if torch.cuda.device_count() < 2:
        log("halo_cli", "skipped: one card visible (train_teacher --num_devices 2 "
                        "--sharding halo needs two)")
        return
    stats, report, _ = _train(["--datasets=collab", "--epochs=1", f"--dataset_dir={STANDINS}",
                               f"--save_dir={WORK / 'halo'}", f"--results_dir={WORK / 'halo'}",
                               *TRAIN_FLAGS, "--num_devices=2", "--sharding=halo"])
    log("halo_cli", {"num_devices": 2, "losses": report["losses"],
                     "epoch_s": report["epoch_s"], "Hits@50": stats["Hits@50"]})


def _halo_entries(gen, train: dict, counts: Counter) -> list:
    """B1 over rank 0 of 2's plan of the collab train graph (the weighted
    export's for the weighted instances) at D=256, in each CSR the halo
    aggregation launches it over: against ``segsum_plain`` over the same
    CSR, two launches equal bit for bit, timed beside ``torch.sparse.mm``
    over that CSR. The bound counts the input rows once, the output rows
    once and the CSR once."""
    import torch

    from llp_tpu_torch.ops.segsum import segsum, segsum_plain
    from llp_tpu_torch.parallel.halo import build_halo_plan
    from llp_tpu_torch.parallel.mesh import World

    half = World(rank=0, size=2, device=torch.device("cuda", 0), backend="gloo")
    plans = {w: build_halo_plan(train["data"]["weighted" if w else "collab"]["graph"], half)
             for w in (False, True)}
    entries = []
    for name, dtype, part, direction, weighted in HALO_KERNELS:
        p = plans[weighted]
        n_halo = p.halo_rows.numel()
        idx, ptr, rows, n_out, w = {
            ("local", "fwd"): (p.loc_senders, p.loc_in_ptr, p.n_loc, p.n_loc, p.loc_w),
            ("local", "bwd"): (p.loc_col, p.loc_row_ptr, p.n_loc, p.n_loc,
                               None if p.loc_w is None else p.loc_w[p.loc_sid]),
            ("remote", "fwd"): (p.rem_senders, p.rem_in_ptr, n_halo, p.n_loc, p.rem_w),
            ("remote", "bwd"): (p.rem_col, p.rem_row_ptr, p.n_loc, n_halo,
                                None if p.rem_w is None else p.rem_w[p.rem_sid]),
            ("owner", "bwd"): (p.send_senders, p.send_ptr, p.send_rows.numel(), p.n_loc, None),
        }[part, direction]
        w = w.contiguous() if weighted else None
        x = torch.randn(rows, 256, generator=gen, device="cuda").to(getattr(torch, dtype))
        got = segsum(x, idx, ptr, weights=w, out_dtype=torch.float32)
        again = segsum(x, idx, ptr, weights=w, out_dtype=torch.float32)
        if not torch.equal(got, again):
            raise AssertionError(f"{name}: two launches differ")
        err = compare(got, segsum_plain(x, idx, ptr, weights=w, out_dtype=torch.float32),
                      **SEGSUM_TOL, what=name)
        e = int(ptr[-1])
        values = torch.ones(e, device="cuda") if w is None else w[:e]
        adj = torch.sparse_csr_tensor(ptr, idx[:e], values, (n_out, rows))
        t = _segsum_timing(x, idx, ptr, None, adj, out_dtype=torch.float32, weights=w)
        t["bytes"] = (x.numel() * x.element_size() + n_out * 256 * 4 + idx.numel() * 4
                      + ptr.numel() * 8 + (0 if w is None else w.numel() * 4))
        t["bound_ms"] = t["bytes"] / HBM_BYTES_PER_S * 1e3
        inst = f"{dtype}->float32"
        launches = counts.get((part, direction, inst, 256, weighted), 0)
        if not launches:
            raise AssertionError(f"{name}: no launch on the halo path")
        log("timing", {"kernel": name, "rows_in": rows, "rows_out": n_out, "e": e, "d": 256, **t})
        entry = {"name": name, "route": "cuda", "source": "llp_tpu_torch/csrc/segsum.cu",
                 "replaces": "llp_tpu/ops/pallas/segsum_kernel.py:148",
                 "launches": launches, "max_abs_err": err["max_abs"], "ms": t["ms"],
                 "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": "bytes",
                 "library_ms": t["library_ms"],
                 "shapes": (f"rank 0 of 2's halo plan of the {'weighted ' if weighted else ''}"
                            f"collab train graph, {part} {direction}: {rows} rows in, {n_out} "
                            f"out, e={e}, d=256, {inst}, no scale")}
        if "library_note" in t:
            entry["library_note"] = t["library_note"]
        entries.append(entry)
    return entries


def phase_halo(gen, train: dict) -> dict:
    """The node-sharded path (``--sharding halo``): (a) a world of one over
    NCCL on ``cuda:0`` against the single path, two epochs each in turns,
    bit for bit with the same B1 launches, for the collab SAGE teacher
    (fp32, bf16), the weighted GCN teacher (bf16) and the collab table
    student; (e) the halo evaluator at a world of one against the single
    path's; (b) two gloo ranks on the card (the halo teacher's first steps
    against one card, the table student against the dp student bit for
    bit) and (d) the rows and bytes they exchange; (c) the CLI over two
    cards, when there are two; then the halo B1 entries of the kernels
    line."""
    import torch

    from llp_tpu_torch.parallel.epoch import table_gather
    from llp_tpu_torch.parallel.halo import halo_spmm
    from llp_tpu_torch.parallel.launch import free_tcp_address
    from llp_tpu_torch.parallel.mesh import close_world, init_world

    # the halo path starts here
    halo_spmm.launch_counts.clear()
    table_gather.launches = 0
    table_gather.launch_counts.clear()
    world = init_world(0, 1, torch.device("cuda", 0), init_method=free_tcp_address(),
                       timeout=DP_TIMEOUT_S)
    try:
        counts = Counter()
        data = train["data"]
        runs = (("collab sage float32", _halo_teacher(data["collab"], "float32")),
                ("collab sage bfloat16", _halo_teacher(data["collab"], "bfloat16")),
                ("weighted collab gcn bfloat16",
                 _halo_teacher(data["weighted"], "bfloat16", encoder="gcn")),
                ("collab table student float32",
                 _halo_student(data["weighted"],
                               WORK / "teacher_weighted" / "collab-sage_transductive")))
        for label, make in runs:
            counts.update(_halo_world_of_one(label, make, world))
        _halo_eval_world_of_one(data["collab"], world)
    finally:
        close_world()
    counts.update(_halo_two_gloo_ranks(train)["counts"])
    _halo_cli_two_cards()
    log("halo_launches", {" ".join(map(str, k)): v for k, v in counts.items()})
    return {"entries": _halo_entries(gen, train, counts)}


SHARD = WORK / "shard"  # the table file and the sharded daemon's log
SHARD_Q = 256
SHARD_KS = (10, 50)
SHARD_PAIRS = 1024
# (tag, --quantize, compute dtype)
SHARD_VARIANTS = (("fp32", "none", None), ("bf16", "none", "bfloat16"),
                  ("int8", "int8", None), ("int4", "int4", None))
COLLAB_EVAL = (46_329, 100_000)  # ogbl-collab's test positives and negatives
HITS_KS = (10, 20, 50, 100)
# measure_scaling_global's problem at the collab stand-in's size: its nodes,
# feature width, the teacher's hidden width and its batch
SCALING_COLLAB = dict(n_nodes=235_868, dim=128, hidden=256, batch=64 * 1024)


def _shard_table():
    """The serve phase's collab teacher re-encoded on the card: its head,
    the (235,868, 256) table and the dataset."""
    import torch

    from llp_tpu_torch.core.graph import build_graph
    from llp_tpu_torch.data.registry import get_dataset
    from llp_tpu_torch.serve import encode_graph_nodes, load_serving_artifacts

    modules, _, _ = load_serving_artifacts(str(WORK / "collab-teacher"), device="cuda")
    ds = get_dataset(STANDINS, "collab")
    h = encode_graph_nodes(modules["encoder"],
                           build_graph(ds.edge_index, ds.num_nodes, device="cuda"),
                           torch.from_numpy(ds.x).cuda())
    return modules["predictor"], h, ds


def _shard_counts() -> tuple:
    from llp_tpu_torch.ops.mlp_topk import mlp_block_logits
    from llp_tpu_torch.ops.sddmm import sddmm_mlp_score

    return mlp_block_logits.launches, sddmm_mlp_score.launches


def _flat_answers(answers) -> list:
    """A state's answers (top-K ``(values, ids)`` pairs and score arrays) as
    one list of arrays."""
    out = []
    for a in answers:
        out += list(a) if isinstance(a, tuple) else [a]
    return out


def _check_answers(got: list, want: list, what: str) -> dict:
    """Bit for bit, or else: scores within SCORE_ATOL and top-K ids equal
    wherever a score stands apart from its neighbours by more than that."""
    import numpy as np

    if all(np.array_equal(a, b) for a, b in zip(got, want)):
        return {"bitwise": True, "max_abs": 0.0}
    worst = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        if a.dtype.kind == "f":
            worst = max(worst, float(np.abs(a.astype(np.float64) - b).max()))
            if worst > SCORE_ATOL:
                raise AssertionError(f"{what}: scores differ by {worst} > {SCORE_ATOL}")
        else:  # ids, after their values
            vals = want[i - 1]
            gaps = np.abs(np.diff(vals, axis=1))
            edge = np.full((vals.shape[0], 1), np.inf)
            apart = (np.concatenate([edge, gaps], 1) > SCORE_ATOL) & (
                np.concatenate([gaps, edge], 1) > SCORE_ATOL)
            if not np.array_equal(a[apart], b[apart]):
                raise AssertionError(f"{what}: ids differ where the scores stand apart")
    return {"bitwise": False, "max_abs": worst, "atol": SCORE_ATOL}


def _shard_world_of_one(pred, h, queries, pairs, world) -> dict:
    """(a): ``ShardedServingState`` at a world of one (its sharded path,
    over one NCCL rank) against ``ServingState`` on the same table, in
    turns (single, world, world, single), each variant's answers bit for
    bit with the same B4 and B3 launches; returns the single answers and the world's launches per
    variant."""
    import numpy as np
    import torch

    from llp_tpu_torch.serve.server import ServingState, ShardedServingState

    out = {}
    for tag, quantize, cdt in SHARD_VARIANTS:
        dtype = None if cdt is None else getattr(torch, cdt)
        states = {"single": ServingState(pred, h, quantize=quantize, compute_dtype=dtype),
                  "world1": ShardedServingState(pred, h, world=world, quantize=quantize,
                                                compute_dtype=dtype)}
        runs = {}
        for name in ("single", "world1", "world1", "single"):
            state = states[name]
            torch.cuda.synchronize()
            c0, t0 = _shard_counts(), time.perf_counter()
            answers = [state.topk(queries, k) for k in SHARD_KS] + [state.score(pairs)]
            torch.cuda.synchronize()
            c1 = _shard_counts()
            runs.setdefault(name, []).append({"answers": _flat_answers(answers),
                                              "s": time.perf_counter() - t0,
                                              "launches": (c1[0] - c0[0], c1[1] - c0[1])})
        for a, b in zip(runs["single"], runs["world1"]):
            if not all(np.array_equal(x, y) for x, y in zip(a["answers"], b["answers"])):
                raise AssertionError(f"shard world of one {tag}: not bit for bit")
            if a["launches"] != b["launches"]:
                raise AssertionError(f"shard world of one {tag}: launches {b['launches']} "
                                     f"!= {a['launches']} of the single state")
        if not runs["world1"][0]["launches"][0] or not runs["world1"][0]["launches"][1]:
            raise AssertionError(f"shard world of one {tag}: B4 or B3 did not launch")
        single_s = runs["single"][1]["s"]
        world_s = runs["world1"][1]["s"]
        log("shard_world1", {"run": tag, "bitwise": True, "q": len(queries), "ks": SHARD_KS,
                             "pairs": len(pairs),
                             "mlp_topk_launches": runs["world1"][0]["launches"][0],
                             "sddmm_launches": runs["world1"][0]["launches"][1],
                             "single_s": single_s, "world1_s": world_s,
                             "overhead_s": world_s - single_s})
        out[tag] = {"answers": runs["single"][0]["answers"],
                    "launches": [r["launches"] for r in runs["world1"]]}
        del states, runs
        torch.cuda.empty_cache()
    return out


def _shard_hits_auc(h, ds, pred, world) -> dict:
    """(d), the world of one: scores of collab's eval size through the
    single state (B3), ``sharded_hits_auc`` against ``hits_at_k`` and
    ``roc_auc``; returns the scores and the job of two gloo ranks."""
    import numpy as np

    from llp_tpu_torch.parallel.eval import sharded_hits_auc
    from llp_tpu_torch.serve import score_pairs

    n_pos, n_neg = COLLAB_EVAL
    rng = np.random.default_rng(5)
    pos_e = ds.edge_index[:, rng.choice(ds.edge_index.shape[1], n_pos, replace=False)]
    neg_e = rng.integers(0, h.shape[0], (2, n_neg))
    pos = score_pairs(pred, h, pos_e[0], pos_e[1])
    neg = score_pairs(pred, h, neg_e[0], neg_e[1])
    got = {k: float(v) for k, v in sharded_hits_auc(pos, neg, HITS_KS, world).items()}
    _check_hits(got, pos, neg, "hits_auc world of one")
    log("hits_auc", {"world": 1, "positives": n_pos, "negatives": n_neg, **got})
    cut = 37_000  # uneven cuts
    return {"pos": pos.cpu().numpy(), "neg": neg.cpu().numpy(), "ks": HITS_KS,
            "cuts": [0, cut, n_neg]}


def _check_hits(got: dict, pos, neg, what: str) -> None:
    import torch

    from llp_tpu_torch.ops.metrics import hits_at_k, roc_auc

    pos, neg = torch.as_tensor(pos), torch.as_tensor(neg)
    for k in HITS_KS:
        if got[f"Hits@{k}"] != float(hits_at_k(pos, neg, k)):
            raise AssertionError(f"{what}: Hits@{k} {got[f'Hits@{k}']} != "
                                 f"{float(hits_at_k(pos, neg, k))}")
    if abs(got["AUC"] - float(roc_auc(pos, neg))) > 1e-6:
        raise AssertionError(f"{what}: AUC {got['AUC']} != {float(roc_auc(pos, neg))}")


def _shard_two_gloo_ranks(pred, h, queries, pairs, world1: dict, hits_job: dict) -> dict:
    """(b) and (d): two ranks on the one card over gloo, each reading its
    rows of the table from a file: every variant's answers against the
    single state's, each rank's bytes in use after set-up; and
    ``sharded_hits_auc`` over uneven cuts of the negatives. Returns each
    variant's B4 launches and B3's, summed over the ranks."""
    import numpy as np

    from llp_tpu_torch.parallel.launch import launch
    from llp_tpu_torch.tools.dp_runs import run_jobs
    from llp_tpu_torch.utils.params import to_jax

    SHARD.mkdir(parents=True, exist_ok=True)
    path = SHARD / "collab_table.npy"
    np.save(path, h.cpu().numpy())
    requests = [("topk", queries.tolist(), k) for k in SHARD_KS] + [("score", pairs.tolist())]
    tree = to_jax(pred)
    jobs = [("state", {"h": str(path), "predictor": tree, "quantize": quantize,
                       "compute_dtype": cdt, "requests": requests})
            for _, quantize, cdt in SHARD_VARIANTS] + [("hits_auc", hits_job)]
    t0 = time.perf_counter()
    ranks = launch(run_jobs, ["cuda:0", "cuda:0"], jobs, backend="gloo",
                   timeout=DP_TIMEOUT_S, join_timeout=2 * DP_TIMEOUT_S)
    gloo_s = time.perf_counter() - t0
    out = {}
    whole = {"fp32": h.numel() * 4, "bf16": h.numel() * 4, "int8": h.numel() + h.shape[0] * 4,
             "int4": h.numel() // 2 + h.shape[0] * 4}
    for i, (tag, _, _) in enumerate(SHARD_VARIANTS):
        r0, r1 = ranks[0][i], ranks[1][i]
        check = _check_answers(_flat_answers(r0["answers"]), world1[tag]["answers"],
                               f"shard gloo {tag}")
        b4 = sum(sum(r["mlp_topk_launches"].values()) for r in (r0, r1))
        b3 = r0["sddmm_launches"] + r1["sddmm_launches"]
        if not b4 or not b3:
            raise AssertionError(f"shard gloo {tag}: B4 or B3 did not launch on the ranks")
        log("shard_gloo", {"run": tag, **check, "rows": [r0["rows"], r1["rows"]],
                           "bytes_in_use": [r0["bytes_in_use"], r1["bytes_in_use"]],
                           "table_bytes": whole[tag],
                           "mlp_topk_launches": [r["mlp_topk_launches"] for r in (r0, r1)],
                           "sddmm_launches": [r0["sddmm_launches"], r1["sddmm_launches"]],
                           "rank0_request_s": r0["seconds"]})
        out[tag] = (b4, b3)
    hits = [r[-1] for r in ranks]
    if hits[0] != hits[1]:
        raise AssertionError("hits_auc gloo: the ranks disagree")
    _check_hits(hits[0], hits_job["pos"], hits_job["neg"], "hits_auc gloo")
    log("hits_auc", {"world": 2, "backend": "gloo", "cuts": hits_job["cuts"], **hits[0]})
    log("shard_gloo_total", {"seconds": gloo_s})
    path.unlink()
    return out


def _http(port: int, path: str, payload=None) -> tuple:
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _child_pids(pid: int) -> list:
    out = []
    for stat in Path("/proc").glob("[0-9]*/stat"):
        try:
            fields = stat.read_text().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[1]) == pid:
            out.append(int(stat.parent.name))
    return out


def _shard_daemon(pred, h, queries, pairs) -> None:
    """(c): ``cli.serve --shard`` in a process of its own, on every visible
    card (one here: a world of one over NCCL), against the single daemon
    on the same table over HTTP; then a SIGTERM, after which neither the
    CLI nor a rank process is left."""
    import signal

    import numpy as np
    import torch

    from llp_tpu_torch.serve import BackgroundServer, ServingState

    n = h.shape[0]
    SHARD.mkdir(parents=True, exist_ok=True)
    argv = [sys.executable, "-m", "llp_tpu_torch.cli.serve",
            f"--checkpoint={WORK / 'collab-teacher'}", "--datasets=collab",
            f"--dataset_dir={STANDINS}", "--reencode", "--port=0", "--shard", "--warmup=10"]
    t0 = time.perf_counter()
    with open(SHARD / "daemon.err", "w") as err:
        proc = subprocess.Popen(argv, cwd=ROOT, stdout=subprocess.PIPE, stderr=err, text=True)
        try:
            summary, port = None, None
            deadline = time.monotonic() + 600
            while port is None:
                line = proc.stdout.readline()
                if not line:
                    if proc.poll() is not None or time.monotonic() > deadline:
                        raise AssertionError("shard daemon: no ready line; see "
                                             f"{SHARD / 'daemon.err'}")
                    continue
                msg = json.loads(line)
                if "serving" in msg:
                    port = int(msg["serving"].rsplit(":", 1)[1])
                else:
                    summary = msg
            ready_s = time.perf_counter() - t0
            cards = torch.cuda.device_count()
            if summary.get("shards") != cards or summary["nodes"] != n:
                raise AssertionError(f"shard daemon: summary {summary}")
            children = _child_pids(proc.pid)
            checks = {}
            with BackgroundServer(ServingState(pred, h)) as srv:
                for name, path, payload in (
                        ("topk10", "/v1/topk", {"queries": queries.tolist(), "k": 10}),
                        ("topk50", "/v1/topk", {"queries": queries.tolist(), "k": 50}),
                        ("score", "/v1/score", {"pairs": pairs.tolist()})):
                    a, b = _http(port, path, payload), _http(srv.port, path, payload)
                    if a[0] != 200 or b[0] != 200:
                        raise AssertionError(f"shard daemon {name}: status {a[0]}, {b[0]}")
                    if name == "score":
                        got, want = [np.asarray(a[1]["scores"])], [np.asarray(b[1]["scores"])]
                    else:
                        got = [np.asarray([r[key]]) for r in a[1]["results"]
                               for key in ("scores", "partners")]
                        want = [np.asarray([r[key]]) for r in b[1]["results"]
                                for key in ("scores", "partners")]
                    checks[name] = _check_answers(got, want, f"shard daemon {name}")
            status, body = _http(port, "/v1/topk", {"queries": [n], "k": 3})
            if status != 400 or "out of range" not in body.get("error", ""):
                raise AssertionError(f"shard daemon: an id of N got {status} {body}")
            health = _http(port, "/healthz")[1]
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
    deadline = time.monotonic() + 60
    while any(Path(f"/proc/{p}").exists() for p in children) and time.monotonic() < deadline:
        time.sleep(0.2)
    left = [p for p in children if Path(f"/proc/{p}").exists()]
    if rc != 0 or left:
        raise AssertionError(f"shard daemon: exit code {rc}, processes left {left}")
    log("shard_daemon", {"shards": summary["shards"], "ready_s": ready_s,
                         "encode_s": summary["encode_s"], "checks": checks,
                         "bad_id_status": status, "device_calls": health["device_calls"],
                         "exit_code": rc, "children": len(children), "left": left})
    if cards < 2:
        log("shard_cards", "skipped: one card visible (the --shard CLI ran as a world of one; "
                           "its ranks span the cards where two or more are visible)")


def _multihost_cpu() -> list:
    """(e): two ``multihost`` processes of one CPU rank each, standing in for
    two hosts (started here, read by :func:`_multihost_read`)."""
    from llp_tpu_torch.parallel.launch import free_tcp_address

    port = free_tcp_address().rsplit(":", 1)[1]
    return [subprocess.Popen([sys.executable, "-m", "llp_tpu_torch.parallel.multihost",
                              "--coordinator", f"127.0.0.1:{port}", "--num_processes", "2",
                              "--process_id", str(i), "--device", "cpu:1", "--steps", "3"],
                             cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for i in (0, 1)]


def _multihost_read(procs) -> dict:
    outs = [p.communicate(timeout=600) for p in procs]
    if any(p.returncode for p in procs):
        raise AssertionError(f"multihost: exit codes {[p.returncode for p in procs]}: "
                             f"{outs[0][1][-2000:]} {outs[1][1][-2000:]}")
    lines = outs[0][0].splitlines()
    if len(lines) != 1 or outs[1][0].strip():
        raise AssertionError(f"multihost: process 0 printed {lines}, process 1 {outs[1][0]!r}")
    return json.loads(lines[0])


def _shard_entries(gen, pred, h, queries, counts: dict) -> list:
    """B4 over rank 0's half of the table (rank 0 of 2's rows of
    ``shard_bounds``; int4: its even block, unpacked) at Q=256 in the four
    table kinds, against ``mlp_block_logits_plain`` over the candidate
    blocks the unfused route takes, and timed; and the blocked scan over
    rank 1's half (global ids from the half's first row, the queries' own
    rows masked) against a plain top-K of the plain logits."""
    import torch

    from llp_tpu_torch.ops.mlp_topk import (
        bf16_tolerance,
        head_layers,
        mlp_block_logits,
        mlp_block_logits_plain,
    )
    from llp_tpu_torch.serve.engine import auto_topk_block, scan_top_k
    from llp_tpu_torch.serve.quant import codes_slice, dequantize_rows, quantize_table
    from llp_tpu_torch.serve.server import shard_bounds

    n, width = h.shape
    q = SHARD_Q
    lins = head_layers(pred.lins)
    qidx = torch.as_tensor(queries, device="cuda")
    block = auto_topk_block(pred, q, width)  # the unfused route's candidates per block
    rows_q = torch.arange(q, device="cuda")

    def plain(q_h, cand, scales=None):
        out = torch.empty((q, cand.shape[0]), dtype=torch.float32, device="cuda")
        for b0 in range(0, cand.shape[0], block):
            out[:, b0:b0 + block] = mlp_block_logits_plain(
                lins, q_h, cand[b0:b0 + block],
                scales=None if scales is None else scales[b0:b0 + block])
        return out

    def inputs(tag):
        if tag in ("fp32", "bf16"):
            half = shard_bounds(n, 2)[1]
            dt = torch.float32 if tag == "fp32" else torch.bfloat16
            return h[qidx].to(dt), h[:half].to(dt), None
        bits = 8 if tag == "int8" else 4
        half = shard_bounds(n, 2, bits)[1]
        qt = quantize_table(h[:half], bits)
        return (dequantize_rows(quantize_table(h[qidx], bits), rows_q),
                codes_slice(qt, 0, half).contiguous(), qt.scale)

    flops_per_cand = 2 * q * sum(int(w["w"].shape[0]) * int(w["w"].shape[1]) for w in lins)
    weight_values = sum(w["w"].numel() + w["b"].numel() for w in lins)
    entries = []
    for tag, _, _ in SHARD_VARIANTS:
        q_h, cand, scales = inputs(tag)
        b = cand.shape[0]
        got = mlp_block_logits(lins, q_h, cand, scales=scales)
        ref = plain(q_h, cand, scales)
        what = f"mlp_topk.shard.{tag}"
        if tag == "bf16":
            used = 0.0
            for b0 in range(0, b, block):
                bound = bf16_tolerance(lins, q_h, cand[b0:b0 + block])
                e = (got[:, b0:b0 + block] - ref[:, b0:b0 + block]).abs()
                used = max(used, float((e / bound).max()))
            if used > 1.0 or not bool(torch.isfinite(got).all()):
                raise AssertionError(f"{what}: past the bf16 bound ({used:.3g}x)")
            err = {"max_abs": float((got - ref).abs().max()), "tol_used": used}
        else:
            err = compare(got, ref, **MLP_TOPK_TOL, what=what)
        del ref
        ms = time_ms(lambda: mlp_block_logits(lins, q_h, cand, scales=scales), reps=3, warmup=1)
        plain_ms = time_ms(lambda: plain(q_h, cand, scales), reps=1, warmup=1)
        flops = flops_per_cand * b
        q_bytes = q * width * q_h.element_size()
        cand_bytes = cand.numel() * cand.element_size() + (0 if scales is None else b * 4)
        nbytes = cand_bytes + q_bytes + weight_values * 4 + q * b * 4
        peak = BF16_FLOP_PER_S if tag == "bf16" else FP32_FLOP_PER_S
        by_ops = flops / peak >= nbytes / HBM_BYTES_PER_S
        bound_ms = max(flops / peak, nbytes / HBM_BYTES_PER_S) * 1e3
        log("timing", {"kernel": what, "q": q, "b": b, "h": width, "flops": flops,
                       "bytes": nbytes, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                       "tflop_per_s": flops / ms / 1e9})
        kind = {"fp32": "fp32 dense", "bf16": "bf16 dense on the tensor cores",
                "int8": "int8 codes + scales", "int4": "int4 rows unpacked to int8 codes"}[tag]
        entries.append({
            "name": what, "route": "cuda", "source": "llp_tpu_torch/csrc/mlp_topk.cu",
            "replaces": "llp_tpu/ops/pallas/mlp_topk_kernel.py:81",
            "launches": counts[tag], "max_abs_err": err["max_abs"], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if by_ops else "bytes", "library_ms": None,
            "library_note": "no single PyTorch call takes the Hadamard product of every "
                            "query x candidate pair through an MLP head",
            "shapes": f"rank 0 of 2's rows ({b} of {n}), Q={q}, H=F={width}, 2-layer head, "
                      f"{kind}"})
    # the scan's global ids and self mask, over rank 1's half
    lo = shard_bounds(n, 2)[1]
    vals, ids, raw = scan_top_k(pred, h[lo:], h[qidx], qidx, k=10, row0=lo, exclude_self=True,
                                mlp_fused=True)
    logits = plain(h[qidx], h[lo:])
    logits[(torch.arange(lo, n, device="cuda")[None, :] == qidx[:, None])] = -torch.inf
    ref_vals, ref_pos = torch.topk(logits, 10, dim=1)
    err = compare(vals, ref_vals, **MLP_TOPK_TOL, what="shard scan values")
    gaps = (ref_vals[:, :-1] - ref_vals[:, 1:]).abs() > 1e-4
    apart = torch.cat([gaps[:, :1], gaps[:, 1:] & gaps[:, :-1], gaps[:, -1:]], 1)
    if not raw or not torch.equal(ids[apart], (ref_pos + lo)[apart]):
        raise AssertionError("shard scan: ids off where the logits stand apart")
    log("shard_scan", {"rows": [lo, n], "q": q, "k": 10, "self_in_half": int(
        ((qidx >= lo)).sum()), **err})
    return entries


def phase_shard(gen) -> dict:
    """The node-sharded serving daemon (``--shard``), its sharded Hits@K/AUC
    and the multi-host harness: (a) to (e) of the module's docstring, then
    B4's shard entries of the kernels line."""
    import numpy as np
    import torch

    from llp_tpu_torch.parallel.launch import free_tcp_address
    from llp_tpu_torch.parallel.mesh import close_world, init_world
    from llp_tpu_torch.parallel.multihost import measure_scaling_global

    pred, h, ds = _shard_table()
    n = h.shape[0]
    rng = np.random.default_rng(14)
    queries = rng.choice(n, SHARD_Q, replace=False)
    pairs = rng.integers(0, n, (SHARD_PAIRS, 2))
    hosts = _multihost_cpu()
    world = init_world(0, 1, torch.device("cuda", 0), init_method=free_tcp_address(),
                       timeout=DP_TIMEOUT_S)
    try:
        world1 = _shard_world_of_one(pred, h, queries, pairs, world)
        hits_job = _shard_hits_auc(h, ds, pred, world)
        card = measure_scaling_global(world=world, **SCALING_COLLAB)
    finally:
        close_world()
    log("multihost", {"run": "measure_scaling_global, a world of one over NCCL",
                      **SCALING_COLLAB, **card})
    gloo = _shard_two_gloo_ranks(pred, h, queries, pairs, world1, hits_job)
    _shard_daemon(pred, h, queries, pairs)
    cpu = _multihost_read(hosts)
    log("multihost", {"run": "two multihost processes of one CPU rank each (gloo)", **cpu,
                      "efficiency": "not measured: one card is visible, so the step's "
                                    "efficiency across cards cannot be read here"})
    counts = {tag: sum(b4 for b4, _ in world1[tag]["launches"]) + gloo[tag][0]
              for tag, _, _ in SHARD_VARIANTS}
    log("shard_launches", {"mlp_topk": counts,
                           "sddmm": {tag: sum(b3 for _, b3 in world1[tag]["launches"])
                                     + gloo[tag][1] for tag, _, _ in SHARD_VARIANTS}})
    return {"entries": _shard_entries(gen, pred, h, queries, counts)}


TRACE_TIE_US = 20.0      # a span's start against its first kernel's, on the tie
TRACE_TIE_REPS = 20
TRACE_TIE_CYCLES = 200_000  # about 0.1 ms of spinning at the card's clock


def phase_trace_tie() -> dict:
    """(3) of the module's docstring."""
    import os
    import tempfile

    import torch

    from llp_tpu_torch.utils import profiling

    # B1's library (the marker's) and the sleep kernel loaded before the
    # profiler, as a training step has its kernels in a traced slice
    from llp_tpu_torch.ops.build import load_library

    flag = torch.empty(1, dtype=torch.int32, device="cuda")
    load_library("segsum", "llp_trace_marker")(flag.data_ptr(),
                                               torch.cuda.current_stream().cuda_stream)
    torch.cuda._sleep(TRACE_TIE_CYCLES)
    torch.cuda.synchronize()
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    try:
        with profiling.span("trace_tie.open"):  # the session's tie
            pass
        # a session's first launch of a kernel pays the profiler's set-up
        # (37-54 us here), as a traced slice's first step does: not timed
        torch.cuda.synchronize()
        torch.cuda._sleep(TRACE_TIE_CYCLES)
        # a tie through a PyTorch op, as the benchmark's trace makes its own
        fill = torch.empty(1, dtype=torch.float64, device="cuda")
        torch.cuda.synchronize()
        t_fill = time.perf_counter()
        fill.fill_(1.0)
        returns = []  # the host times the sleeps' launches returned at
        for _ in range(TRACE_TIE_REPS):
            torch.cuda.synchronize()
            with profiling.span("trace_tie.sleep"):
                torch.cuda._sleep(TRACE_TIE_CYCLES)
                returns.append(time.perf_counter())
        torch.cuda.synchronize()
    finally:
        prof.stop()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    kernels = sorted((e["ts"], e.get("dur", 0.0), e["name"]) for e in events
                     if e.get("ph") == "X" and e.get("cat") == "kernel")
    session = profiling.last_session()
    offset = session.offset_us([(n, t) for t, _, n in kernels])
    if offset is None:
        raise AssertionError(f"trace_tie: no marker kernel ({profiling.MARKER_KERNEL!r}) in "
                             f"{sorted({n for _, _, n in kernels})}")
    sleeps = [k for k in kernels if "spin_kernel" in k[2]][1:]  # the untimed one first
    spans = [s for s in session.spans if s.name == "trace_tie.sleep"]
    if len(sleeps) != len(spans):
        raise AssertionError(f"trace_tie: {len(sleeps)} kernels for {len(spans)} spans: "
                             f"{sorted({n for _, _, n in sleeps})}")
    errors = [t - (s.t0 * 1e6 + offset) for (t, _, _), s in zip(sleeps, spans)]
    after_return = [t - (r * 1e6 + offset) for (t, _, _), r in zip(sleeps, returns)]
    covered = [s.device_ms * 1e3 - dur for (_, dur, _), s in zip(sleeps, spans)]
    median = sorted(errors)[len(errors) // 2]
    out = {"reps": len(spans), "error_us_median": median,
           "error_us_range": [min(errors), max(errors)],
           "after_return_us_range": [min(after_return), max(after_return)],
           "device_minus_kernel_us": [min(covered), max(covered)],
           "kernel_us": sorted(d for _, d, _ in sleeps)[len(sleeps) // 2],
           "marker": next(n for _, _, n in kernels if session.marker in n)[:160],
           "sleep_kernel": sleeps[0][2][:80], "limit_us": TRACE_TIE_US,
           "fill_tie_minus_marker_tie_us": min(t for t, _, n in kernels
                                               if "FillFunctor<double>" in n)
           - t_fill * 1e6 - offset}
    log("trace_tie", out)
    # a kernel starts after its span's start and before its launch returns
    # (a slow launch call is the host's, not the tie's); typically within
    # TRACE_TIE_US of the span's start
    if (abs(median) > TRACE_TIE_US or min(errors) < -TRACE_TIE_US
            or max(after_return) > TRACE_TIE_US):
        raise AssertionError(f"trace_tie: on the tie the kernels start {median:.1f} us "
                             f"(median) from their spans' starts, {out['error_us_range']} in "
                             f"all, and {out['after_return_us_range']} from their launches' "
                             f"returns (limit {TRACE_TIE_US} us)")
    if min(covered) < 0:
        raise AssertionError("trace_tie: a span's device time is shorter than its kernel")
    return out


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
    seconds = {}

    def timed(name, fn, *args):
        from llp_tpu_torch.utils.memory import get_device_memory_map, reset_peak

        reset_peak()
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t
        log("memory", {"phase": name, **get_device_memory_map()[0]})
        return out

    info = timed("device", phase_device)
    timed("build", phase_build)
    timed("trace_tie", phase_trace_tie)
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = timed("kernel_check", phase_kernel_check, gen)
    timed("other_card", phase_other_card)
    launches = timed("serve", phase_serve)
    timed("weighted_data", phase_weighted_data)
    train = timed("train", phase_train)
    student = timed("student", phase_student)
    production = timed("production", phase_production)
    tooling = timed("tooling", phase_tooling)
    scale10m = timed("scale10m", phase_scale10m, gen)
    reorder = timed("reorder", phase_reorder, gen, train, worst)
    dp = timed("dp", phase_dp, gen, train)
    halo = timed("halo", phase_halo, gen, train)
    shard = timed("shard", phase_shard, gen)
    kernels = (timed("kernels", phase_kernels, gen, launches, train, student, production,
                     tooling, scale10m, reorder, worst) + dp["entries"] + halo["entries"]
               + shard["entries"])
    log("total", {"seconds": time.perf_counter() - t0, "phases": seconds})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": info["name"],
                                             "count": info["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
