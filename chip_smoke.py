#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA H100.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each printing one JSON line (a failing phase raises and the script
exits non-zero):

1. device   -- the card (nvidia-smi name and power limit), TF32 off;
2. build    -- nvcc builds the hand-written kernels of src/repro_torch; the
               SASS instruction counts of each kernel (cuobjdump), which
               must show wgmma (HGMMA) and TMA loads (UTMALDG) in the
               prefill and decode matmul kernels, the bf16 flash and
               decode attention kernels and the bf16 SSD scan kernel of
               P 64, N 128, both kernels of K2's bf16 backward and K4's
               bf16 backward kernel of P 64, N 128, and
               tensor-core products (HMMA or HGMMA) and asynchronous loads
               (UTMALDG or LDGSTS) in the bf16 SSD scan kernel of P 50, N
               16; and each kernel's registers and spills from ptxas's
               report, with no spill allowed in either bf16 SSD scan
               kernel, in K2's bf16 backward kernels at hd 64 or in K4's
               backward kernels (those of K2 at hd 128, the band's and the
               forward's printed);
3. kernels  -- each kernel against its plain PyTorch version on the card
               at the shapes of the serving paths of the nine served
               models (qwen2_0_5b, llama3_2_1b, qwen2_7b, qwen3_4b,
               mamba2_1_3b, deepseek_moe_16b with its fp32 router,
               internvl2_26b, hymba_1_5b, whisper_large_v3, each at its
               served batch; whisper's flash attention not causal, its
               encoder's at S 1500 and its cross-attention from 512 and 455
               queries to 1500 keys, its decode attention over the 1500
               slots of its cross cache; hymba's flash
               attention under its window of 1024, at S 512 and at S 1800,
               past the window; its scan at P 50, N 16, bf16 on the
               tensor-core route "tc", fp32 on the CUDA cores, also at b 2,
               S 1800 from an initial state), with a
               served prefill's ragged length
               (8 x 455 rows for the matmul, S 455 for flash attention), the
               wmma matmul kernel and its split-K reduce at two bf16 shapes
               TMA cannot take, decode attention at served lengths, each
               with the length a host int and read from device memory (as
               the captured decode step passes it; also lengths 1, 64 and
               65, where most splits of the cluster are empty), and at hd
               128 with groups of 4 (qwen3_4b's heads),
               fp32 and bf16 (matmul and attention: 2e-4 and 2e-2 of
               1 + |plain|; bf16 decode attention also within 5e-5 +
               1e-2 |plain|, about one bf16 rounding of its output;
               ssd_scan: 1e-4 and 5e-2 of max |plain|, bf16 also within
               1e-2 of it, at the served shapes and at b 1, S 4096 from an
               initial state, there also with dt |A| small (A times 1e-4),
               the state carried across all 64 sub-chunks, at both (P, N),
               and at the mesh phase's sequence shard, b 1, S 2048 of
               mamba2_1_3b's heads from an initial state, long-memory, fp32
               and bf16; each call on its route),
               the matmul grouped over experts (deepseek_moe_16b's expert
               FFN at a decode step, C 8, and a prefill, C 235;
               llama4_maverick_400b_a17b's at C 8 and 80; a mesh rank's
               expert-parallel product, its 32 experts at C x M = 1536
               rows; each one launch on its grouped route; bf16 also
               within 5e-5 + 1e-2 |plain|),
               its backward products (dx = dy w^T, each expert's w^T read
               in place, and dw = x^T dy from a copy of x^T, which bf16
               pads along C to a multiple of 8, the copy's time apart) at
               deepseek_moe_16b's training capacity C 480 and at C 235
               (padded) in bf16, at C 15 in fp32, at a mesh rank's 32
               experts of 1536 rows in fp32 and bf16, and at
               llama4_maverick_400b_a17b's C 80 in bf16, each on its
               grouped route under both limits, its library torch.bmm,
               K1's backward products at qwen2_0_5b's training shapes
               (dx = dy w^T with w^T read in place, dw = x^T dy at 4096
               rows, the tied unembedding's too), K2's backward kernel
               (flash_attention_bwd from the forward's lse: qwen2_0_5b's
               (8, 512, 14/2, 64) causal and at S 455, (4, 512, 28/4, 128)
               causal, not causal whisper_large_v3's (8, 1500, 20/20, 64)
               and 512 queries to 1500 keys; bf16 on its wgmma route,
               fp32 on the CUDA cores; 2e-4 / 2e-2 of 1 + |plain| and a
               mean limit, BWD_MEAN_TOL; its library the autograd backward
               of SDPA; and the band's at hymba_1_5b's training shape (2,
               2048, 25/5, 64), window 1024, its library SDPA's autograd
               backward with a boolean band mask), K4's backward
               (ssd_scan_bwd, fp32 and bf16, against ssd_scan_bwd_plain,
               each call on its route, ssd_bwd_route's: bf16 at P 64,
               N 128 on "wgmma", the rest on "simt";
               mamba2_1_3b's training shape (8, 512, 64, P 64, N 128),
               hymba_1_5b's (2, 2048, 64, P 50, N 16), a ragged S from an
               initial state with a cotangent of the final state at both,
               and the long-memory inputs, b 1, S 4096, A times 1e-4, at
               both; 1e-4 and 5e-2 of max |plain|, bf16 also within 1e-2
               of it; library none), each backward also run twice and
               held equal bit for bit, K2 with a query offset (a
               sequence shard's queries against every key, forward and
               backward, as the mesh phase runs it: deepseek_moe_16b's
               (2, 256 of 512, 16/16, 128) at offsets 0 and 256 and
               hymba_1_5b's band (1, 1024 of 2048, 25/5, 64, window
               1024) at 1024; the loose and mean limits; its library SDPA
               with an explicit boolean mask),
               with CUDA-event times of the kernel, the plain version and,
               where one exists, one PyTorch library call, and the least
               time the card could take (bound_ms); the summary line sums
               the bf16 cases, the type the models are served and trained
               in;
4. parity   -- per model, at full width, depth 2 (deepseek_moe_16b: one
               dense and one MoE layer; whisper_large_v3: 2 encoder and 2
               decoder layers), fp32: the port on the CPU (plain
               versions) against the port on the card (kernels, the
               engine's decode step replayed from its captured graph):
               logits (internvl2_26b's with random patch embeddings ahead
               of the tokens; whisper_large_v3's with random frames, and
               also its prefill and 3 decode steps from them, which read
               the cross cache), and greedy tokens at max_seq 128 and at
               max_seq 48, where one prompt is longer than the cache and
               the other decodes past its end (hymba_1_5b: its ring of 48
               slots wraps); hymba_1_5b twice, at its window of 1024 and
               at a window of 32, which both prompts (40 and 64) exceed;
5. serve    -- per model, full width and depth in bf16 through ServeEngine,
               every decode step a replay of the engine's one captured CUDA
               graph (the dense models, internvl2_26b and whisper_large_v3:
               matmul, flash and decode attention; deepseek_moe_16b: those
               and the grouped matmul; mamba2_1_3b: matmul and ssd_scan;
               hymba_1_5b: all four, and a second run of 2 prompts of 1500
               and 1800 tokens at max_seq 2048, past its window of 1024,
               where its ring of 1024 slots wraps), with
               every kernel's launch count over that run (counts set to 0
               just before it), a check that every bf16 matmul of 64 rows
               or more (the prefills') took the wgmma kernel and every one
               of fewer rows (the decode steps' and the prefill's
               unembedding) the wgmma decode kernel, every fp32 one (the MoE
               router) the fp32 kernel, every grouped one its expected
               grouped route, and every scan its model's scan kernel; the
               graph's tokens against the same batch decoded eagerly
               through bundle.decode, all 32 of every request; a profile of
               one prefill and of four decode steps, eager and replayed
               (the device time of each of the port's kernels among them);
               wall, host and device ms per decode step, eager and graph
               alternating; whisper_large_v3's least decode step time from
               the bytes a step reads; and a check that a replay never
               makes the host wait on the card;
6. train_parity -- one make_train_step step at full width, depth 2, fp32,
               the card (every product, attention and scan a kernel,
               forward and backward) against the CPU from one state and
               batch: loss, gradient norm, moments and parameters, and the
               launch counts (K2's and K4's backward on their fp32
               routes, the products' by route), for qwen2_0_5b,
               qwen3_4b, whisper_large_v3, mamba2_1_3b, hymba_1_5b (at a
               window of 32, below its sequence of 64, so that the band's
               backward is in it) and deepseek_moe_16b (one dense and one
               MoE layer; its grouped products, forward, dx with w
               transposed and dw, on the fp32 grouped kernel at C 15); and on
               the card the loss and every gradient with the per-layer
               recompute equal, bit for bit, those without it;
7. train    -- at full width and depth, bf16, 5 steps of train_loop on
               data/pipeline.py's batches: qwen2_0_5b (AdamW lr 1e-3)
               and mamba2_1_3b (3e-4) at batch 8 x seq 512, hymba_1_5b
               (3e-4) at 2 x 2048 (past its window of 1024),
               deepseek_moe_16b (3e-4) at 8 x 512 cut to depth 4 (one
               dense, three MoE layers; C 480): the loss
               finite and falling, the launches per step (each layer
               step recomputed in the backward) of K1 (4 per product of a
               layer, 3 for the unembedding; by route: deepseek's routers on
               "fp32", its expert products, forward, dx and dw, on
               "wgmma_grouped", the rest on "wgmma"), K2 and K4 (twice a
               layer), K2's backward (the band's for hymba) and K4's
               backward (once) as expected,
               every product, attention backward and scan backward on its
               bf16 kernel (mamba2_1_3b's scan backward on "wgmma",
               hymba_1_5b's on "simt") and no plain version called (the
               grouped one's neither); step time, tokens/s, peak memory,
               a profiled step's device idle share and the backward
               kernels' device time; a checkpoint saved and restored equal
               bit for bit, and the next step from it equal, bit for bit,
               to the step without the restore; the phase's seconds;
8. train_100m -- examples/train_100m_torch.py --full through its main:
               llama_100m, 300 steps of 8 x 256 tokens, a checkpoint every
               100: the loss falling, the three checkpoints written, the
               launches as train's, step time, tokens/s, peak memory and
               the stragglers flagged;
9. failover -- examples/elastic_failover_torch.py --full through its main:
               qwen2_0_5b at full width and depth, bf16, placed through
               VNPUPolicy on a 2 x 4 topology of 8 rank ids, 3 steps of 4 x
               32 tokens, a checkpoint, its first core failed and the
               tenant migrated, the checkpoint restored (bit-equal to the
               state saved), 2 more steps (the first bit-equal to the same
               step of an uninterrupted run), the core repaired; the loss
               finite, the launches as train's, no plain version run; then
               that step's gradients through compress_tree and the
               error-feedback compressor on the card and on the CPU, the
               int8 payloads, scales, reconstructions and residuals
               bit-equal, the ratio and the ms of one compression;
10. mesh    -- deepseek_moe_16b at full width, depth 2, fp32, capacity
               factor 16, batch 4 x 512, over a 2 x 2 tenant mesh that the
               hypervisor places on 4 ranks (processes started with spawn
               that share the one card through gloo, which NCCL refuses):
               attention sharded by sequence (K2 with each shard's
               offset), the experts over the model axis through the
               all_to_all pair, every layer's weights gathered ZeRO-3
               style; the logits and one make_train_step step against the
               unsharded run on the card (its MoE aux loss the mesh's, the
               mean of each rank's over its tokens), K4's
               sequence-parallel scan over the data axis at mamba2_1_3b's
               (1, 4096, 64, 64, 128) on long-memory inputs against the
               scan of the whole sequence, fp32 and bf16, and one bf16
               sharded step; per rank the placement, exact launch counts
               (K1 and its grouped routes, K2 with and without an offset,
               K4), each collective's bytes and transport, peak memory and
               the step's wall ms (ranks sharing one card: no speed
               figure) (``phase_mesh``); and in the same world the GPipe
               pipeline (parallel/pipeline.py) over a "pod" axis of the 4
               ranks: the first 4 layers of qwen2_0_5b at full width, one
               a stage, 8 microbatches of 1 x 512, fp32 and bf16, its
               output bit-equal to the 4 layers run in sequence, each
               rank's 11 stage calls (bubble steps included) launching 77
               K1 and 11 K2, and bubble_fraction(4, 8);
11. core    -- one seeded stream of vNPU requests (launch/placement.py)
               through repro_torch.core's hypervisor with every mapper,
               ilp included: the placements and the host ms of each, the
               stream run twice the same;
12. tenants -- examples/multi_tenant_serving_torch.py --full and
               examples/quickstart_torch.py --full through their main:
               llama3_2_1b and qwen2_0_5b admitted through VNPUPolicy,
               scored against each other's flows, each serving 2 prompts
               of 8 tokens (4 new) at full width and depth in bf16, each
               engine's launches of K1 (by route), K2 and K3 exact; a 2 x 2
               and a 1 x 4 tenant placed and llama3_2_1b's forward and loss
               on the card, launches exact; the planes' analytic decode rate
               of qwen2_0_5b beside the card's measured one at batch 4
               (their ratio printed); one ClusterScheduler run of the mixed
               trace with the serving plane, on the card's host, timed and
               run twice the same;
13. fleet   -- the fleet and chaos planes on the card's host: two 8 x 8
               pods of the fleet-serving trace through a storm's
               fleet-scope faults (a pod lost and its tenants evacuated
               over the switch, a switch brownout), under the serial and
               the parallel executor (2 forked workers): pod_digests and
               every FleetMetrics field equal, each run's host seconds;
14. roofline -- the step times that the serve and train phases measured
               (each served path's prefill and decode step, each train
               path's step; no run of its own) against the analytic
               roofline of repro_torch.roofline on this card's peaks
               (peaks_for): the step's FLOPs (kernelized), bytes and model
               FLOPs, the compute and memory times, measured / bound and
               the measured MFU; a time below its bound fails.

Then each phase's seconds and the whole run's, a summary line of the kernels (each with the routes its cases took;
the grouped matmul's launches by path, serving and training, and its
forward and backward cases apart),
and last
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
It prints no result and exits non-zero without a CUDA device or outside a
checkout of the repository.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
SEED = 0
# the served paths, in run order: SERVE_PROFILES' three models, qwen3_4b,
# the SSD path, the MoE path, the vlm path, the hybrid path and the
# encoder-decoder path, each at a served batch: a profiled model's
# max_batch, read from the port's SERVE_PROFILES (serve/requests.py, the
# JAX package's copied), by ``serve_batch``.  The models without a
# profile borrow the batch (and PERF.md §2 the limits) of the profile
# nearest them in size: mamba2_1_3b, hymba_1_5b and whisper_large_v3
# llama3_2_1b's (8); qwen3_4b, deepseek_moe_16b and internvl2_26b
# qwen2_7b's (4)
MODELS = ("qwen2_0_5b", "llama3_2_1b", "qwen2_7b", "qwen3_4b", "mamba2_1_3b",
          "deepseek_moe_16b", "internvl2_26b", "hymba_1_5b",
          "whisper_large_v3")
BORROWED_BATCH = {"qwen3_4b": 4, "mamba2_1_3b": 8, "deepseek_moe_16b": 4,
                  "internvl2_26b": 4, "hymba_1_5b": 8, "whisper_large_v3": 8}
# hymba_1_5b's second serve run, where its window and its ring both bite:
# 2 prompts longer than the window of 1024, a cache of 2048 positions (a
# ring of 1024 slots), 32 new tokens
LONG_PATH = "hymba_1_5b_long_prompts"
LONG_PROMPTS = (1500, 1800)
LONG_MAX_SEQ = 2048
# the window that hymba_1_5b's second parity run takes, below both prompts
PARITY_WINDOW = 32
# the training paths at full width, bf16: (model, batch, seq, AdamW's lr,
# after a warmup of 2 steps, depth: None for the model's own).
# mamba2_1_3b at qwen2_0_5b's 8 x 512; hymba_1_5b at 2 x 2048, the same 4096
# tokens a step, past its window of 1024, so that the band bites.  Both at
# the package's default lr of 3e-4 (launch/train.py's): at qwen2_0_5b's
# 1e-3 mamba2_1_3b's loss rises from step 3 on (11.23, 9.40, 15.16, 15.79,
# 13.02 on an H100), the same with the plain backward in place of K4's
# kernel (11.23, 9.40, 15.15, 15.81, 13.03): the step, not the kernel.
# deepseek_moe_16b at 8 x 512 (C 480 a MoE layer) and 3e-4, cut to depth 4
# (one dense layer, three MoE layers: 2.27 B parameters, ≈ 23 GB of bf16
# weights and fp32 moments, twice that while the phase restores a second
# state beside the first; its 28 layers need the experts sharded over
# cards, which the port does not do yet).
# Their train steps are held card against CPU at depth 2 in fp32 beside
# qwen3_4b's (hd 128, qk_norm) and whisper_large_v3's (attention not
# causal, Sq != Skv); hymba_1_5b's at PARITY_WINDOW, below its sequence;
# deepseek_moe_16b's (one dense, one MoE layer) at C 15, every grouped
# product of it on the fp32 grouped kernel, dx with w transposed
TRAIN_PATHS = {"qwen2_0_5b_train": ("qwen2_0_5b", 8, 512, 1e-3, None),
               "mamba2_1_3b_train": ("mamba2_1_3b", 8, 512, 3e-4, None),
               "hymba_1_5b_train": ("hymba_1_5b", 2, 2048, 3e-4, None),
               "deepseek_moe_16b_train": ("deepseek_moe_16b", 8, 512, 3e-4,
                                          4)}
TRAIN_PARITY = ("qwen2_0_5b", "qwen3_4b", "whisper_large_v3", "mamba2_1_3b",
                "hymba_1_5b", "deepseek_moe_16b")
TOL = {"float32": 2e-4, "bfloat16": 2e-2}
SSD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}  # tests/test_kernels.py's
# and the second limit of bf16 (tests/test_torch_cuda.py's): the bf16 scans
# round three operands to bf16, which 5e-2 would let pass by far
SSD_FINE_TOL = {"bfloat16": 1e-2}
# bf16 decode attention keeps P.V in fp32, as its plain version: (rtol, atol)
# of about one bf16 rounding of the output (tests/test_torch_cuda.py's); the
# grouped matmul, whose fp32 sums differ from the plain version's only in
# their order, is held to it too
DECODE_FINE_TOL = (1e-2, 5e-5)
SLEEP_CYCLES = 2_000_000  # ~1 ms of GPU spin ahead of each timed call

# The card's published peaks (bytes/s, operations/s by input type) come
# from repro_torch.roofline's one table, H100_PEAKS, by the card's name
# (phase_device).
# Each served path's prefill and decode step time, each train path's step
# time, as the serve and train phases measured them: the roofline phase
# reads them (and times nothing itself).  (path, kind) -> {"cfg", "batch",
# "seq", "seq_is", "ms"}
STEP_TIMES = {}

# TPU kernels of the JAX package that the port's kernels replace
KERNELS = {
    "streamed_matmul": {"source": "src/repro_torch/kernels/csrc/streamed_matmul.cu",
                        "replaces": "src/repro/kernels/streamed_matmul.py:44"},
    "flash_attention": {"source": "src/repro_torch/kernels/csrc/flash_attention.cu",
                        "replaces": "src/repro/kernels/flash_attention.py:67"},
    "decode_attention": {"source": "src/repro_torch/kernels/csrc/decode_attention.cu",
                         "replaces": "src/repro/kernels/decode_attention.py:54"},
    "ssd_scan": {"source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
                 "replaces": "src/repro/kernels/ssd_scan.py:63"},
    # K2's and K4's backward: the JAX package has no Pallas backward (it
    # differentiates its jnp attention and its ssd_scan_ref with XLA); each
    # kernel serves the forward kernel it replaces on the training path
    "flash_attention_bwd": {
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:67"},
    "ssd_scan_bwd": {
        "source": "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:63"},
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def main() -> int:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from the root of a checkout of the repository",
              file=sys.stderr)
        return 1
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))

    t_start = time.perf_counter()
    seconds = {}

    def timed(name, fn, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0

    dev = timed("device", phase_device, torch)
    timed("build", phase_build)
    cases = timed("kernels", phase_kernels, torch, dev)
    for model in MODELS:
        timed("parity", phase_parity, torch, model)
    timed("parity", phase_parity, torch, "hymba_1_5b", window=PARITY_WINDOW)
    launches = {}
    for model in MODELS:
        launches[model] = timed("serve", phase_serve, torch, dev, model)
    launches[LONG_PATH] = timed("serve", phase_serve, torch, dev,
                                "hymba_1_5b", lengths=LONG_PROMPTS,
                                max_seq=LONG_MAX_SEQ, path=LONG_PATH)
    for model in TRAIN_PARITY:
        timed("train_parity", phase_train_parity, torch, model,
              window=PARITY_WINDOW if model == "hymba_1_5b" else None)
    for path, (model, batch, seq, lr, depth) in TRAIN_PATHS.items():
        launches[path] = timed("train", phase_train, torch, dev, model,
                               batch, seq, lr, path, depth=depth)
    launches["train_100m"] = timed("train_100m", phase_train_100m, torch, dev)
    launches["failover"] = timed("failover", phase_failover, torch, dev)
    launches["mesh"] = timed("mesh", phase_mesh, torch, dev)
    timed("core", phase_core)
    launches["tenants"] = timed("tenants", phase_tenants, torch, dev)
    timed("fleet", phase_fleet)
    timed("roofline", phase_roofline, dev,
          [(m, k) for m in (*MODELS, LONG_PATH) for k in ("prefill", "decode")]
          + [(p, "train") for p in (*TRAIN_PATHS, "train_100m")])
    emit({"phase": "seconds", "by_phase": seconds,
          "total_s": time.perf_counter() - t_start})
    summary = []
    for name, meta in KERNELS.items():
        mine = [c for c in cases if c["name"] == name]
        timed = [c for c in mine if c["dtype"] == "bfloat16"]  # as served
        summary.append({
            "name": name, "route": "cuda", **meta,
            "launches": sum(n.get(name, 0) for n in launches.values()),
            "launches_by_path": {m: n.get(name, 0)
                                 for m, n in launches.items()},
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            **timing_sums(timed),
            "shapes": [c["shape"] for c in timed],
            "kernel_routes": sorted({c["route"] for c in mine
                                     if "route" in c}),
        })
        grouped = [c for c in mine if c["shape"][0] == "grouped"]
        if grouped:  # the matmul grouped over experts, also on its own:
            # its launches by path (serving's forwards; training's forwards,
            # dx and dw), and its forward and backward cases apart
            fwd = [c for c in grouped if not str(c["shape"][1]).startswith(
                "bwd")]
            bwd = [c for c in grouped if c not in fwd]
            summary[-1]["grouped"] = {
                "launches_by_path": {m: n["grouped"] for m, n in
                                     launches.items() if "grouped" in n},
                "max_abs_err": max(c["max_abs_err"] for c in fwd),
                **timing_sums([c for c in fwd if c["dtype"] == "bfloat16"]),
                "backward": {
                    "max_abs_err": max(c["max_abs_err"] for c in bwd),
                    "xt_copy_ms": sum(c.get("xt_copy_ms", 0.0) for c in bwd
                                      if c["dtype"] == "bfloat16"),
                    **timing_sums([c for c in bwd
                                   if c["dtype"] == "bfloat16"])}}
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def timing_sums(cases):
    """The summary's times of ``cases``: kernel, plain, bound and library
    ms summed, and what bounds their sum."""
    by_bytes = sum(c["bytes_ms"] for c in cases)
    by_ops = sum(c["ops_ms"] for c in cases)
    library = [c["library_ms"] for c in cases]
    return {"ms": sum(c["kernel_ms"] for c in cases),
            "plain_ms": sum(c["plain_ms"] for c in cases),
            "bound_ms": sum(c["bound_ms"] for c in cases),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "library_ms": None if None in library else sum(library)}


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise RuntimeError(f"compute capability {cap}: the kernels are "
                           "built for sm_90a (Hopper)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.roofline import part_for, peaks_for
    name = torch.cuda.get_device_name(0)
    part, peaks = part_for(name), peaks_for(name)  # raise on another card
    emit({"phase": "device", "nvidia_smi": smi,
          "name": name, "capability": list(cap),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "allow_tf32": False,
          "peaks": {"part": part, **peaks}})
    return {"smi": smi, "part": part, "peaks": peaks}


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    so = _build.build()
    _build.load()
    seconds = time.perf_counter() - t0
    sass = sass_counts(so)
    log = Path(str(so) + ".log").read_text()
    ptxas = ptxas_report(log)
    emit({"phase": "build", "seconds": seconds,
          "library": str(so.relative_to(ROOT)),
          "ptxas_log": str(so.relative_to(ROOT)) + ".log", "sass": sass,
          "ptxas": ptxas, "ptxas_warnings": [
              line.strip() for line in log.splitlines()
              if "warning" in line.lower() or "Performance" in line]})
    for kernel in ("matmul_wgmma_kernel", "matmul_decode_kernel",
                   "flash_wgmma_kernel", "decode_wgmma_kernel",
                   "ssd_wgmma_kernel", "flash_bwd_dq_wgmma_kernel",
                   "flash_bwd_dkdv_wgmma_kernel", "ssd_bwd_wgmma_kernel"):
        mine = [c for name, c in sass.items() if kernel in name]
        if not mine or not all(c["HGMMA"] and c["UTMALDG"] for c in mine):
            raise AssertionError(f"{kernel}: no wgmma or TMA load in its SASS")
    mine = [c for name, c in sass.items() if "ssd_tc_kernel" in name]
    if not mine or not all((c["HMMA"] or c["HGMMA"]) and
                           (c["UTMALDG"] or c["LDGSTS"]) for c in mine):
        raise AssertionError(f"ssd_tc_kernel: no tensor-core product or "
                             f"asynchronous load in its SASS {mine}")
    for kernel in ("ssd_wgmma_kernel", "ssd_tc_kernel",
                   "flash_bwd_dq_wgmma_kernel<64,",
                   "flash_bwd_dkdv_wgmma_kernel<64,", "ssd_bwd_kernel",
                   "ssd_bwd_wgmma_kernel"):
        mine = [r for name, r in ptxas.items() if kernel in name]
        if not mine or any(r.get("spill_stores") != 0 or
                           r.get("spill_loads") != 0 for r in mine):
            raise AssertionError(f"{kernel}: spills or no report {mine}")
    # K2's kernels apart: the serving forward's (no lse), the training
    # forward's (lse; under a band too) and the bf16 backward's (causal or
    # not, and the band's), and K4's backward, registers and spills
    emit({"phase": "build", "k2_ptxas": {
        name: r for name, r in ptxas.items()
        if re.match(r"flash_(wgmma|bwd_\w+_wgmma)_kernel", name)},
        "k4_backward_ptxas": {name: r for name, r in ptxas.items()
                              if name.startswith("ssd_bwd")}})


def ptxas_report(log):
    """Per entry function of ptxas's ``-v`` report: registers, stack frame
    and spill bytes."""
    out, name = {}, None
    for line in log.splitlines():
        head = re.search(r"Compiling entry function '(\S+)'", line)
        if head:
            name = _kernel_name(head.group(1))
            out[name] = {}
            continue
        props = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores,"
                          r" (\d+) bytes spill loads", line)
        if name and props and "stack" not in out[name]:
            out[name].update(stack=int(props.group(1)),
                             spill_stores=int(props.group(2)),
                             spill_loads=int(props.group(3)))
        regs = re.search(r"Used (\d+) registers", line)
        if name and regs and "registers" not in out[name]:
            out[name]["registers"] = int(regs.group(1))
    return out


SASS_OPS = ("HGMMA", "UTMALDG", "HMMA", "LDGSTS")


def sass_counts(so):
    """Per kernel of the built library, how many of its SASS instructions
    are wgmma (HGMMA), TMA loads (UTMALDG), mma.sync (HMMA) and cp.async
    (LDGSTS), from ``cuobjdump -sass``."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    tool = shutil.which("cuobjdump") or os.path.join(cuda_home, "bin",
                                                     "cuobjdump")
    dump = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, name = {}, None
    for line in dump.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            name = head.group(1)
            counts[name] = dict.fromkeys(SASS_OPS, 0)
        elif name:
            op = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)",
                          line)
            if op and op.group(1) in counts[name]:
                counts[name][op.group(1)] += 1
    return {_kernel_name(k): v for k, v in counts.items()}


def _kernel_name(mangled):
    """``matmul_wgmma_kernel<true>``-style names from mangled ones."""
    filt = shutil.which("c++filt")
    if filt:
        name = subprocess.run([filt, mangled], capture_output=True, text=True,
                              timeout=60).stdout.strip()
        name = name.replace("(anonymous namespace)::", "")
        return re.sub(r"^void |\(.*\)$", "", name)
    return mangled


def phase_kernels(torch, dev):
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import decode_attention_plain
    from repro_torch.kernels.flash_attention import (
        BWD_MEAN_TOL, BWD_ROUTE_LAUNCHES, MEAN_TOL, flash_attention_bwd_plain,
        flash_attention_plain)
    from repro_torch.kernels.ssd_scan import (SSD_BWD_ROUTE_LAUNCHES,
                                              SSD_ROUTE_LAUNCHES,
                                              ssd_bwd_route, ssd_route,
                                              ssd_scan_bwd_plain,
                                              ssd_scan_plain)
    from repro_torch.kernels.streamed_matmul import (ROUTE_LAUNCHES,
                                                     grouped_matmul_plain,
                                                     grouped_route, k_splits,
                                                     matmul_plain,
                                                     matmul_route, sm_count)

    peaks = dev["peaks"]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")  # > L2

    def randn(*shape, dtype, scale=1.0):
        t = torch.randn(shape, generator=gen, device="cuda")
        return t.mul_(scale).to(dtype)  # in place: llama4's experts are 21 GB

    def time_ms(fn, iters=20, warmup=3):
        """Median of CUDA-event times of the device work, L2 flushed before
        each call (the serving path finds weights and caches cold).  A GPU
        spin ahead of each call keeps the card busy while the host enqueues
        it, so the host's launch cost stays outside the events."""
        for _ in range(warmup):
            fn()
        ev = []
        for _ in range(iters):
            flush.zero_()
            torch.cuda._sleep(SLEEP_CYCLES)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            ev.append((a, b))
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in ev)

    cases = []

    def check(name, shape, dtype, got, want, n_bytes, n_ops, fns,
              relative=False, fine=None, route=None, mean_rel=None,
              extra=None):
        """got/want: a tensor or a tuple of them (ssd_scan: y and the
        state).  relative: the rule of tests/test_kernels.py's SSD test,
        and for bf16 also SSD_FINE_TOL.  fine: an (rtol, atol) the kernel
        must also meet.  mean_rel: a limit of mean |got - want| over mean
        |want| the kernel must also meet.  route: the kernel that took the
        call.  extra: more keys of the case's line."""
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        dname = str(dtype).split(".")[-1]
        tol = (SSD_TOL if relative else TOL)[dname]
        fine_rel = SSD_FINE_TOL.get(dname) if relative else None
        err, rel_err, excess = 0.0, 0.0, float("-inf")
        for g, w in zip(got, want):
            # in slices of 2^27 elements: a 10.7 GB bf16 gradient (llama4's
            # grouped dw) would need 64 GB of fp32 copies at once
            g, w = g.reshape(-1), w.reshape(-1)
            d_max = w_max = d_sum = w_sum = 0.0
            loose = tight = float("-inf")
            for i in range(0, g.numel(), 1 << 27):
                gs, ws = g[i:i + (1 << 27)].float(), w[i:i + (1 << 27)].float()
                diff, mag = (gs - ws).abs(), ws.abs()
                d_max = max(d_max, diff.max().item())
                w_max = max(w_max, mag.max().item())
                d_sum += diff.sum().item()
                w_sum += mag.sum().item()
                if not relative:
                    loose = max(loose, (diff - tol * (1 + mag)).max().item())
                if fine:
                    tight = max(tight, (diff - fine[1] - fine[0] * mag)
                                .max().item())
                del gs, ws, diff, mag
            err = max(err, d_max)
            if relative:
                rel_err = max(rel_err, d_max / w_max)
                excess = max(excess, d_max - min(tol, fine_rel or tol)
                             * w_max)
            else:
                excess = max(excess, loose)
            if fine:
                excess = max(excess, tight)
            if mean_rel:
                ratio = d_sum / w_sum
                excess = max(excess, ratio - mean_rel)
        case = {"phase": "kernels", "name": name, "shape": shape,
                "dtype": dname, "max_abs_err": err, "tol": tol,
                "tol_rule": ("max |kernel - plain| <= tol * max |plain|"
                             if relative else
                             "|kernel - plain| <= tol * (1 + |plain|)")}
        if fine:
            case["fine_tol"] = {"rtol": fine[0], "atol": fine[1],
                                "rule": "|kernel - plain| <= atol + rtol |plain|"}
        if mean_rel:
            case["fine_tol"] = {"tol": mean_rel, "mean_rel_err": ratio,
                                "rule": "mean |kernel - plain| <= tol * "
                                        "mean |plain|"}
        if relative:
            case["max_rel_err"] = rel_err
        if fine_rel:
            case["fine_tol"] = {"tol": fine_rel,
                                "rule": "max |kernel - plain| <= tol * max |plain|"}
        if route:
            case["route"] = route
        bytes_ms = n_bytes / peaks["bytes"] * 1e3
        ops_ms = n_ops / peaks[case["dtype"]] * 1e3
        case.update(bytes_ms=bytes_ms, ops_ms=ops_ms,
                    bound_ms=max(bytes_ms, ops_ms),
                    bound_by="bytes" if bytes_ms >= ops_ms else "operations")
        for key, fn in zip(("kernel_ms", "plain_ms", "library_ms"), fns):
            case[key] = None if fn is None else time_ms(fn)
        case.update(extra or {})
        emit(case)
        if not excess <= 0:
            raise AssertionError(f"{name} {shape} {dtype}: kernel disagrees "
                                 f"with its plain version by {case['max_abs_err']}")
        cases.append(case)

    def matmul_case(M, K, N, tied, dtype):
        es = torch.tensor([], dtype=dtype).element_size()
        x = randn(M, K, dtype=dtype)
        if tied:  # a tied unembedding: embed.t(), read in place
            w = randn(N, K, dtype=dtype, scale=K ** -0.5).t()
        else:
            w = randn(K, N, dtype=dtype, scale=K ** -0.5)
        fns = (lambda: ops.matmul(x, w), lambda: matmul_plain(x, w),
               lambda: torch.matmul(x, w))
        check("streamed_matmul", [M, K, N], dtype, ops.matmul(x, w),
              matmul_plain(x, w), es * (M * K + K * N + M * N),
              2 * M * N * K, fns)

    # streamed_matmul: the (K, N) of qwen2_0_5b and of mamba2_1_3b at decode
    # and prefill M; the last of each is the tied unembedding
    pairs = [(896, 896), (896, 128), (896, 4864), (4864, 896), (896, 152064),
             (2048, 4096), (2048, 128), (2048, 64), (4096, 2048),
             (2048, 50432)]
    tied = {152064, 50432}
    # llama3_2_1b at batch 8, qwen2_7b, deepseek_moe_16b and internvl2_26b
    # at their batch 4: q/o, k/v, gate/up and down at the decode M and a
    # 512-token prefill's (internvl2_26b's 256 patches and 512 tokens), and
    # the unembedding at the decode M (a prefill unembeds the last
    # position): llama3_2_1b's tied, the others' a row-major lm_head.
    # deepseek_moe_16b's are its attention (16 heads over 16), its shared
    # experts (2 x 1408 wide) and its first layer's dense FFN; its fp32
    # router below.  hymba_1_5b at its batch 8: q/o, k/v, gate/up, down, the
    # SSD's w_z/w_x, w_B/w_C (N 16), w_dt (N 64) and w_out, and its untied
    # unembedding.  qwen3_4b at its batch 4: q, o, k/v, gate/up, down and
    # its tied unembedding.  whisper_large_v3 at its batch 8: the decoder's
    # q/k/v/o and cross q/o (1280, 1280), w1 and w2, and its untied
    # unembedding; its encoder's products (and the cross k/v, from the
    # encoder's output) at M 8 x 1500 below
    served = [(4, 2048, [(2560, 4096), (4096, 2560), (2560, 1024),
                         (2560, 9728), (9728, 2560)], (2560, 151936, True)),
              (8, 4096, [(1280, 1280), (1280, 5120), (5120, 1280)],
               (1280, 52224, False)),
              (8, 4096, [(2048, 2048), (2048, 512), (2048, 8192),
                         (8192, 2048)], (2048, 128256, True)),
              (8, 4096, [(1600, 1600), (1600, 320), (1600, 5504),
                         (5504, 1600), (1600, 3200), (1600, 16), (1600, 64),
                         (3200, 1600)], (1600, 32256, False)),
              (4, 2048, [(3584, 3584), (3584, 512), (3584, 18944),
                         (18944, 3584)], (3584, 152064, False)),
              (4, 2048, [(2048, 2048), (2048, 2816), (2816, 2048),
                         (2048, 10944), (10944, 2048)],
               (2048, 102400, False)),
              (4, 3072, [(6144, 6144), (6144, 1024), (6144, 16384),
                         (16384, 6144)], (6144, 92672, False))]
    for dtype in (torch.float32, torch.bfloat16):
        for M in (8, 4096, 8 * 455):  # decode, prefill, a ragged prefill
            for K, N in pairs:
                if M == 8 * 455 and N in tied:  # prefill unembeds 8 rows
                    continue
                matmul_case(M, K, N, N in tied, dtype)
        for m_decode, m_prefill, model_pairs, (K, N, is_tied) in served:
            for M in (m_decode, m_prefill):
                for Kp, Np in model_pairs:
                    matmul_case(M, Kp, Np, False, dtype)
            matmul_case(m_decode, K, N, is_tied, dtype)
        for K, N in ((1280, 1280), (1280, 5120), (5120, 1280)):
            matmul_case(8 * 1500, K, N, False, dtype)
    # deepseek_moe_16b's router, fp32 as the JAX package keeps it
    for M in (4, 2048):
        matmul_case(M, 2048, 64, False, torch.float32)

    # the wmma kernel and its split-K reduce: bf16 products TMA cannot take
    # (a row-major w with N % 8 != 0; K % 8 != 0, w the tied layout), at a
    # decode step's M, so K is split
    for M, K, N, w_t in ((8, 1000, 50, 0), (8, 1004, 896, 1)):
        x = randn(M, K, dtype=torch.bfloat16)
        w = (randn(N, K, dtype=torch.bfloat16, scale=K ** -0.5).t() if w_t
             else randn(K, N, dtype=torch.bfloat16, scale=K ** -0.5))
        if (matmul_route(M, N, K, w_t, x.dtype) != "wmma"
                or k_splits(M, N, K, sm_count(x.device)) < 2):
            raise AssertionError(f"({M}, {K}, {N}): not a split-K wmma case")
        before = ROUTE_LAUNCHES["wmma"]
        got = ops.matmul(x, w)
        if ROUTE_LAUNCHES["wmma"] != before + 1:
            raise AssertionError(f"({M}, {K}, {N}): the wmma kernel did not "
                                 "launch")
        fns = (lambda: ops.matmul(x, w), lambda: matmul_plain(x, w),
               lambda: torch.matmul(x, w))
        check("streamed_matmul", [M, K, N], torch.bfloat16, got,
              matmul_plain(x, w), 2 * (M * K + K * N + M * N), 2 * M * N * K,
              fns)
        del x, w

    # K1's backward at qwen2_0_5b's training shapes (batch 8 x seq 512 =
    # 4096 rows; one layer's q/o, k/v, gate/up and down, and the tied
    # unembedding over its padded vocabulary): dx = dy w^T, w^T read in
    # place (a row-major w's transpose; the tied table itself), and dw = x^T
    # dy, x^T a contiguous copy, as ops.matmul's backward calls them.  As
    # in the forward cases, the second operand is scaled by the contraction
    # length^-1/2 (dx sums over N, dw over the M rows)
    M = 4096
    for dtype in (torch.float32, torch.bfloat16):
        es = torch.tensor([], dtype=dtype).element_size()
        for K, N in ((896, 896), (896, 128), (896, 4864), (4864, 896),
                     (896, 151936)):
            w_t = (randn(N, K, dtype=dtype, scale=N ** -0.5) if N == 151936
                   else randn(K, N, dtype=dtype, scale=N ** -0.5).t())
            x_t = randn(K, M, dtype=dtype)
            dy = randn(M, N, dtype=dtype)
            dy_s = randn(M, N, dtype=dtype, scale=M ** -0.5)
            for tag, a, b in (("bwd_dx", dy, w_t), ("bwd_dw", x_t, dy_s)):
                m, k_, n = a.shape[0], a.shape[1], b.shape[1]
                before = ROUTE_LAUNCHES["wgmma"]
                got = ops.matmul(a, b)
                if dtype == torch.bfloat16 and \
                        ROUTE_LAUNCHES["wgmma"] != before + 1:
                    raise AssertionError(f"{tag} ({m}, {k_}, {n}): not on "
                                         "the wgmma kernel")
                fns = (lambda: ops.matmul(a, b), lambda: matmul_plain(a, b),
                       lambda: torch.matmul(a, b))
                check("streamed_matmul", [tag, m, k_, n], dtype, got,
                      matmul_plain(a, b), es * (m * k_ + k_ * n + m * n),
                      2 * m * n * k_, fns)
                del got
            del dy, dy_s, w_t, x_t
            free(torch)

    # the matmul grouped over experts, (E, C, K) @ (E, K, N) in one launch:
    # deepseek_moe_16b's expert FFN (64 experts, d 2048, f 1408; gate/up and
    # down) at a decode step of its served batch 4 (C = max(8, ceil(4 x 6 /
    # 64 x 1.25)) = 8) and at a prefill of 4 x 501 tokens (C = 235), and
    # llama4_maverick_400b_a17b's (128 experts, top-1, d 5120, f 8192; its
    # 10.7 GB of gate weights) at C 8 and at C 80, a prefill of 8192 tokens;
    # and a rank's of the mesh phase, its E / M = 32 experts at C x M = 1536
    # rows (MESH_CAPACITY_ROWS), which its all_to_all gathers
    for dtype in (torch.float32, torch.bfloat16):
        es = torch.tensor([], dtype=dtype).element_size()
        for E, C, K, N in ((64, 8, 2048, 1408), (64, 8, 1408, 2048),
                           (64, 235, 2048, 1408), (64, 235, 1408, 2048),
                           (32, MESH_CAPACITY_ROWS, 2048, 1408),
                           (32, MESH_CAPACITY_ROWS, 1408, 2048),
                           (128, 8, 5120, 8192), (128, 80, 5120, 8192)):
            x = randn(E, C, K, dtype=dtype)
            w = randn(E, K, N, dtype=dtype, scale=K ** -0.5)
            route = grouped_route(E, C, N, K, dtype)
            before = ROUTE_LAUNCHES[route]
            got = ops.grouped_matmul(x, w)
            if ROUTE_LAUNCHES[route] != before + 1:
                raise AssertionError(f"grouped ({E}, {C}, {K}, {N}): the "
                                     f"{route} kernel did not launch")
            fns = (lambda: ops.grouped_matmul(x, w),
                   lambda: grouped_matmul_plain(x, w),
                   lambda: torch.bmm(x, w))
            check("streamed_matmul", ["grouped", E, C, K, N], dtype, got,
                  grouped_matmul_plain(x, w),
                  es * (E * C * K + E * K * N + E * C * N), 2 * E * C * N * K,
                  fns, fine=DECODE_FINE_TOL if dtype == torch.bfloat16
                  else None, route=route)
            del x, w, got
            free(torch)

    # K1's grouped backward, as ops.grouped_matmul's autograd Function
    # calls it for y = x (E, C, K) @ w (E, K, N): dx = dy w^T, each
    # expert's w^T read in place (w_t), and dw = x^T dy, x^T a contiguous
    # copy that bf16 pads with dy along C to a multiple of 8
    # (ops.pad_capacity; its time apart, "xt_copy_ms").  deepseek_moe_16b's
    # gate/up (d 2048 -> f 1408) and down (f -> d) at its training capacity
    # (8 x 512 tokens: C 480) and at C 235 (a served prefill's, which takes
    # the pad), in bf16; at train_parity's C 15 (2 x 64 tokens) in fp32; at
    # a mesh rank's 32 experts of 1536 rows in fp32 and bf16; and
    # llama4_maverick_400b_a17b's gate (128 experts, 5120 -> 8192) at C 80.
    # The bytes: x, dy and the gradient once (C unpadded); the operations
    # 2 E C K N; the library torch.bmm on the kernel's views
    def grouped_bwd_case(tag, a, b, route, shape, dtype, n_bytes, extra):
        before = ROUTE_LAUNCHES[route]
        got = ops.grouped_matmul(a, b)
        if ROUTE_LAUNCHES[route] != before + 1:
            raise AssertionError(f"grouped {tag} {shape}: the {route} "
                                 "kernel did not launch")
        fns = (lambda: ops.grouped_matmul(a, b),
               lambda: grouped_matmul_plain(a, b), lambda: torch.bmm(a, b))
        E, C, K, N = shape
        check("streamed_matmul", ["grouped", tag, *shape], dtype, got,
              grouped_matmul_plain(a, b), n_bytes, 2 * E * C * K * N, fns,
              fine=DECODE_FINE_TOL if dtype == torch.bfloat16 else None,
              route=route, extra=extra)

    for dtype, E, C, K, N in ((torch.bfloat16, 64, 480, 2048, 1408),
                              (torch.bfloat16, 64, 480, 1408, 2048),
                              (torch.bfloat16, 64, 235, 2048, 1408),
                              (torch.bfloat16, 64, 235, 1408, 2048),
                              (torch.float32, 64, 15, 2048, 1408),
                              (torch.float32, 64, 15, 1408, 2048),
                              *((dt, 32, MESH_CAPACITY_ROWS, K, N)
                                for dt in (torch.float32, torch.bfloat16)
                                for K, N in ((2048, 1408), (1408, 2048))),
                              (torch.bfloat16, 128, 80, 5120, 8192)):
        es = torch.tensor([], dtype=dtype).element_size()
        n_bytes = es * (E * C * K + E * C * N + E * K * N)
        x = randn(E, C, K, dtype=dtype)
        w = randn(E, K, N, dtype=dtype, scale=K ** -0.5)
        dy = randn(E, C, N, dtype=dtype, scale=C ** -0.5)
        grouped_bwd_case("bwd_dx", dy, w.transpose(1, 2),
                         grouped_route(E, C, K, N, dtype, w_t=1),
                         (E, C, K, N), dtype, n_bytes,
                         {"w_t": 1, "padded_c": C})
        del w  # dw reads x and dy: llama4's w and its dw are 10.7 GB each
        free(torch)
        xt, dyp = ops.pad_capacity(x.transpose(1, 2), dy)
        grouped_bwd_case("bwd_dw", xt, dyp,
                         grouped_route(E, K, N, xt.shape[2], dtype),
                         (E, C, K, N), dtype, n_bytes,
                         {"w_t": 0, "padded_c": xt.shape[2],
                          "xt_copy_ms": time_ms(lambda: ops.pad_capacity(
                              x.transpose(1, 2), dy))})
        del x, dy, xt, dyp
        free(torch)

    def sdpa(q, k, v, causal, window=0):  # (B, H, S, hd) views
        """SDPA, causal, or under a window shorter than S with a boolean
        band mask (whichever backend takes a mask); the port never calls
        it."""
        if window and window < q.shape[2]:
            i = torch.arange(q.shape[2], device=q.device)
            band = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :]
                                                 < window)
            return lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=band, enable_gqa=True)
        return lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True)

    # flash_attention: prefill at B=8, S=512, qwen2_0_5b's heads, and at a
    # served prefill's ragged S 455; llama3_2_1b's heads (32 over 8, hd 64)
    # at B 8, and at B 4 qwen2_7b's (28 over 4, hd 128), deepseek_moe_16b's
    # (16 over 16, hd 128) at S 512, and internvl2_26b's (48 over 8, hd
    # 128) at S 768, 256 patches and 512 tokens; hymba_1_5b's (25 over 5,
    # hd 64) under its window of 1024 at B 8, S 512 (the band is the causal
    # mask there) and at B 2, S 1800 (the long-prompt serve run), past it;
    # whisper_large_v3's (20 over 20, hd 64) at B 8: its decoder's causal
    # self-attention at S 512, and not causal its encoder's at S 1500 and
    # its cross-attention from 512 and 455 queries to the 1500 frames,
    # whose last key tile holds 28 keys.  (B, Sq, Skv, H, KV, hd, causal,
    # window).  The least operations count the keys attended: min(r + 1,
    # window) for query row r under the causal mask, Skv not causal.
    flash_cases = [(8, S, S, 14, 2, 64, True, 0) for S in (512, 455)] + [
        (8, 512, 512, 32, 8, 64, True, 0),
        (4, 512, 512, 28, 4, 128, True, 0),
        (4, 512, 512, 16, 16, 128, True, 0),
        (4, 768, 768, 48, 8, 128, True, 0),
        (8, 512, 512, 25, 5, 64, True, 1024),
        (2, 1800, 1800, 25, 5, 64, True, 1024),
        (8, 512, 512, 20, 20, 64, True, 0),
        (8, 1500, 1500, 20, 20, 64, False, 0),
        (8, 512, 1500, 20, 20, 64, False, 0),
        (8, 455, 1500, 20, 20, 64, False, 0)]
    for dtype in (torch.float32, torch.bfloat16):
        es = torch.tensor([], dtype=dtype).element_size()
        for B, Sq, Skv, H, KV, hd, causal, window in flash_cases:
            q = randn(B, Sq, H, hd, dtype=dtype)
            k = randn(B, Skv, KV, hd, dtype=dtype)
            v = randn(B, Skv, KV, hd, dtype=dtype)
            keys = (sum(min(r + 1, window or Sq) for r in range(Sq)) if causal
                    else Sq * Skv)
            fns = (lambda: ops.flash_attention(q, k, v, causal=causal,
                                               window=window),
                   lambda: flash_attention_plain(q, k, v, causal=causal,
                                                 window=window),
                   sdpa(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal, window))
            shape = [B, Sq, H, KV, hd] if Sq == Skv else [B, Sq, Skv, H, KV,
                                                          hd]
            check("flash_attention", shape
                  + ([] if causal else ["not_causal"])
                  + (["window", window] if window else []), dtype,
                  ops.flash_attention(q, k, v, causal=causal, window=window),
                  flash_attention_plain(q, k, v, causal=causal, window=window),
                  es * (2 * B * Sq * H * hd + 2 * B * Skv * KV * hd),
                  4 * hd * B * H * keys, fns,
                  mean_rel=MEAN_TOL[dtype])
            del q, k, v

    # flash_attention_bwd, K2's backward (dq, dk, dv from q, k, v, o, dO and
    # the forward's lse): qwen2_0_5b's training attention (8, 512, 14/2,
    # 64) causal and a ragged S 455, qwen3_4b's heads at hd 128 (4, 512,
    # 28/4), and not causal whisper_large_v3's encoder (8, 1500, 20/20) and
    # its cross-attention from 512 queries to 1500 keys; bf16 on the wgmma
    # route, fp32 on the CUDA cores.  The least operations: five products
    # of 2 hd per (query row, key attended); the bytes: q, k, v, o, dO and
    # the lse read and dq, dk, dv written once.  The library: autograd's
    # backward of SDPA at the same shape, timed alone (its forward run once).
    for dtype in (torch.float32, torch.bfloat16):
        es = torch.tensor([], dtype=dtype).element_size()
        for B, Sq, Skv, H, KV, hd, causal in (
                (8, 512, 512, 14, 2, 64, True), (8, 455, 455, 14, 2, 64, True),
                (4, 512, 512, 28, 4, 128, True),
                (8, 1500, 1500, 20, 20, 64, False),
                (8, 512, 1500, 20, 20, 64, False)):
            q = randn(B, Sq, H, hd, dtype=dtype)
            k = randn(B, Skv, KV, hd, dtype=dtype)
            v = randn(B, Skv, KV, hd, dtype=dtype)
            do = randn(B, Sq, H, hd, dtype=dtype)
            o, lse = ops.flash_attention_lse(q, k, v, causal=causal)
            keys = Sq * (Sq + 1) // 2 if causal else Sq * Skv
            route = "wgmma" if dtype == torch.bfloat16 else "fp32"
            before = BWD_ROUTE_LAUNCHES[route]
            got = ops.flash_attention_bwd(q, k, v, o, do, causal=causal,
                                          lse=lse)
            if BWD_ROUTE_LAUNCHES[route] != before + 1:
                raise AssertionError(f"flash_attention_bwd did not launch "
                                     f"on its {route} route")
            qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                          for t in (q, k, v))
            out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                 enable_gqa=True)
            dot = do.transpose(1, 2)
            fns = (lambda: ops.flash_attention_bwd(q, k, v, o, do,
                                                   causal=causal, lse=lse),
                   lambda: flash_attention_bwd_plain(q, k, v, o, do,
                                                     causal=causal),
                   lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                               retain_graph=True))
            shape = [B, Sq, H, KV, hd] if Sq == Skv else [B, Sq, Skv, H, KV,
                                                          hd]
            check("flash_attention_bwd",
                  shape + ([] if causal else ["not_causal"]), dtype, got,
                  flash_attention_bwd_plain(q, k, v, o, do, causal=causal),
                  es * (4 * B * Sq * H * hd + 4 * B * Skv * KV * hd)
                  + 4 * B * H * Sq,
                  5 * 2 * hd * B * H * keys, fns,
                  mean_rel=BWD_MEAN_TOL[dtype], route=route)
            del q, k, v, do, o, lse, got, qt, kt, vt, out, dot, fns
            free(torch)

    def same_bits(fn):
        """Two more calls of a backward give every output equal bit for
        bit (no atomics)."""
        first, second = fn(), fn()
        torch.cuda.synchronize()
        if not all(a is None or torch.equal(a, b)
                   for a, b in zip(first, second)):
            raise AssertionError("two calls of a backward kernel differ")

    # K2's band backward at hymba_1_5b's training shape: (2, 2048, 25/5,
    # 64) under its window of 1024, from the forward's band lse; the keys
    # attended min(r + 1, 1024) per row; its library SDPA's autograd
    # backward with a boolean band mask
    B, S, H, KV, hd, window = 2, 2048, 25, 5, 64, 1024
    for dtype in (torch.float32, torch.bfloat16):
        es = torch.tensor([], dtype=dtype).element_size()
        q = randn(B, S, H, hd, dtype=dtype)
        k = randn(B, S, KV, hd, dtype=dtype)
        v = randn(B, S, KV, hd, dtype=dtype)
        do = randn(B, S, H, hd, dtype=dtype)
        o, lse = ops.flash_attention_lse(q, k, v, window=window)
        route = "wgmma" if dtype == torch.bfloat16 else "fp32"
        before = BWD_ROUTE_LAUNCHES[route]
        got = ops.flash_attention_bwd(q, k, v, o, do, window=window, lse=lse)
        if BWD_ROUTE_LAUNCHES[route] != before + 1:
            raise AssertionError(f"the band's backward did not launch on "
                                 f"its {route} route")
        same_bits(lambda: ops.flash_attention_bwd(q, k, v, o, do,
                                                  window=window, lse=lse))
        i = torch.arange(S, device="cuda")
        band = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :]
                                             < window)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                      for t in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=band,
                                             enable_gqa=True)
        dot = do.transpose(1, 2)
        keys = sum(min(r + 1, window) for r in range(S))
        fns = (lambda: ops.flash_attention_bwd(q, k, v, o, do, window=window,
                                               lse=lse),
               lambda: flash_attention_bwd_plain(q, k, v, o, do,
                                                 window=window),
               lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                           retain_graph=True))
        check("flash_attention_bwd", [B, S, H, KV, hd, "window", window],
              dtype, got, flash_attention_bwd_plain(q, k, v, o, do,
                                                    window=window),
              es * (4 * B * S * H * hd + 4 * B * S * KV * hd) + 4 * B * H * S,
              5 * 2 * hd * B * H * keys, fns, mean_rel=BWD_MEAN_TOL[dtype],
              route=route)
        del q, k, v, do, o, lse, got, qt, kt, vt, out, dot, fns, band
        free(torch)

    # K2 with a query offset, forward and backward: a sequence shard's Sq
    # queries at positions q_offset + r against all Skv keys, causal, as
    # the sequence-sharded attention of the mesh phase runs it:
    # deepseek_moe_16b's two shards of 512 (B 2, 16/16, hd 128) at offsets
    # 0 and 256, and hymba_1_5b's second shard of 2048 (B 1, 25/5, hd 64)
    # under its window of 1024.  (B, Sq, Skv, q_offset, H, KV, hd, window).
    # The least work counts the keys each row attends, min(q_offset + r +
    # 1, window), and the bytes of the keys any row attends (from the
    # band's first to the shard's last row); the library is SDPA with an
    # explicit boolean mask (its is_causal aligns the mask top-left, which
    # is not the shard's), its autograd backward for the backward.
    for dtype in (torch.float32, torch.bfloat16):
        es = torch.tensor([], dtype=dtype).element_size()
        for B, Sq, Skv, off, H, KV, hd, window in (
                (2, 256, 512, 0, 16, 16, 128, 0),
                (2, 256, 512, 256, 16, 16, 128, 0),
                (1, 1024, 2048, 1024, 25, 5, 64, 1024)):
            q = randn(B, Sq, H, hd, dtype=dtype)
            k = randn(B, Skv, KV, hd, dtype=dtype)
            v = randn(B, Skv, KV, hd, dtype=dtype)
            do = randn(B, Sq, H, hd, dtype=dtype)
            mask = dict(causal=True, window=window, q_offset=off)
            rows = off + torch.arange(Sq, device="cuda")[:, None]
            cols = torch.arange(Skv, device="cuda")[None, :]
            allowed = (cols <= rows) & ((rows - cols < window) if window
                                        else True)
            keys = sum(min(off + r + 1, window or Skv) for r in range(Sq))
            lo = max(0, off - window + 1) if window else 0
            kv_bytes = es * 2 * B * (off + Sq - lo) * KV * hd
            qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                          for t in (q, k, v))
            ops.reset_launches()
            got = ops.flash_attention(q, k, v, **mask)
            o, lse = ops.flash_attention_lse(q, k, v, **mask)
            grads = ops.flash_attention_bwd(q, k, v, o, do, lse=lse, **mask)
            if ops.OFFSET_LAUNCHES != {"flash_attention": 2,
                                       "flash_attention_bwd": 1}:
                raise AssertionError(f"K2 with an offset did not launch as "
                                     f"asked: {ops.OFFSET_LAUNCHES}")
            shape = [B, Sq, Skv, H, KV, hd, "q_offset", off] + (
                ["window", window] if window else [])
            fns = (lambda: ops.flash_attention(q, k, v, **mask),
                   lambda: flash_attention_plain(q, k, v, **mask),
                   lambda: F.scaled_dot_product_attention(
                       qt.detach(), kt.detach(), vt.detach(),
                       attn_mask=allowed, enable_gqa=True))
            check("flash_attention", shape, dtype, got,
                  flash_attention_plain(q, k, v, **mask),
                  es * 2 * B * Sq * H * hd + kv_bytes, 4 * hd * B * H * keys,
                  fns, mean_rel=MEAN_TOL[dtype])
            out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=allowed,
                                                 enable_gqa=True)
            dot = do.transpose(1, 2)
            route = "wgmma" if dtype == torch.bfloat16 else "fp32"
            same_bits(lambda: ops.flash_attention_bwd(q, k, v, o, do, lse=lse,
                                                      **mask))
            fns = (lambda: ops.flash_attention_bwd(q, k, v, o, do, lse=lse,
                                                   **mask),
                   lambda: flash_attention_bwd_plain(q, k, v, o, do, **mask),
                   lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                               retain_graph=True))
            check("flash_attention_bwd", shape, dtype, grads,
                  flash_attention_bwd_plain(q, k, v, o, do, **mask),
                  es * (4 * B * Sq * H * hd) + 2 * kv_bytes + 4 * B * H * Sq,
                  5 * 2 * hd * B * H * keys, fns,
                  mean_rel=BWD_MEAN_TOL[dtype], route=route)
            del q, k, v, do, o, lse, got, grads, qt, kt, vt, out, dot, fns
            del allowed
            free(torch)

    # decode_attention: one token against a 1k cache; qwen2_0_5b's heads at
    # four lengths (487 is a served one), llama3_2_1b's (32 over 8, hd 64),
    # qwen2_7b's at its B 4 (28 over 4, hd 128), qwen3_4b's (32 over 8,
    # hd 128), and at B 4 deepseek_moe_16b's (16 over 16, hd 128) and
    # internvl2_26b's (48 over 8, hd 128), and hymba_1_5b's at B 8 (25 over
    # 5, hd 64: its ring of 1024 slots, full from position 1023 on);
    # whisper_large_v3's at B 8 (20 over 20, hd 64, groups of 1): its
    # decoder's self cache, and its cross cache of 1500 slots, read whole
    # (length 1500, a host int).  Each length twice: a host int (the plan
    # of its own keys),
    # and a 0-d int32 on the card, as the captured decode step passes it
    # (the plan of all S keys, splits past the length empty; shape tag
    # "device"); lengths 1, 64 and 65 on the card leave most of a cluster's
    # splits empty.
    for dtype in (torch.float32, torch.bfloat16):
        es = torch.tensor([], dtype=dtype).element_size()
        for B, H, KV, hd, S, lengths in (
                (8, 14, 2, 64, 1024, (1, 487, 513, 1024)),
                (8, 32, 8, 64, 1024, (487, 1024)),
                (4, 28, 4, 128, 1024, (487, 1024)),
                (8, 32, 8, 128, 1024, (487, 1024)),
                (4, 16, 16, 128, 1024, (487, 1024)),
                (4, 48, 8, 128, 1024, (487, 1024)),
                (8, 25, 5, 64, 1024, (487, 1024)),
                (8, 20, 20, 64, 1024, (487, 1024)),
                (8, 20, 20, 64, 1500, (1500,))):
            q = randn(B, H, hd, dtype=dtype)
            k = randn(B, S, KV, hd, dtype=dtype)
            v = randn(B, S, KV, hd, dtype=dtype)
            runs = [(n, n) for n in lengths] + [
                (n, torch.full((), n, dtype=torch.int32, device="cuda"))
                for n in sorted(set(lengths) | {1, 64, 65})]
            for length, arg in runs:
                tag = ["device"] if isinstance(arg, torch.Tensor) else []
                fns = (lambda: ops.decode_attention(q, k, v, arg),
                       lambda: decode_attention_plain(q, k, v, arg),
                       sdpa(q[:, :, None], k[:, :length].transpose(1, 2),
                            v[:, :length].transpose(1, 2), False))
                check("decode_attention", [B, S, H, KV, hd, length] + tag,
                      dtype, ops.decode_attention(q, k, v, arg),
                      decode_attention_plain(q, k, v, length),
                      es * (2 * B * H * hd + 2 * B * length * KV * hd),
                      4 * B * H * length * hd, fns,
                      fine=DECODE_FINE_TOL if dtype == torch.bfloat16
                      else None)
            del q, k, v

    # ssd_scan: mamba2_1_3b's prefill scan (64 heads of P 64, N 128, one
    # group) at b 8; 449 is prime, so the last sub-chunk is ragged; and a
    # bf16 scan of 64 sub-chunks from an initial state (b 1, S 4096), where
    # the state's rounding error has the longest walk; hymba_1_5b's (64
    # heads of P 50, N 16; bf16 on the tensor-core route "tc") at b 8, and
    # at b 2, S 1800 (the long-prompt serve run) from an initial state; at
    # both (P, N) the long-memory case, b 1, S 4096 from an initial state
    # with A times 1e-4, so that dt |A| is small and the state carries
    # across all 64 sub-chunks (a state carried in bf16 would miss the fine
    # limit there: tests/test_torch_kernels.py); and the mesh phase's shard
    # of that case, S 2048 of 4096 at P 64, N 128, from an initial state (as
    # seq_parallel_ssd's second pass runs it), fp32 and bf16.  The least
    # operations form
    # C B^T once per (batch row, chunk of 256) and the rest per head; no
    # PyTorch call computes the scan (library: none).
    H, chunk = 64, 256
    ssd_cases = [(torch.float32, 8, 512, False, 64, 128, 1.0),
                 (torch.float32, 8, 449, False, 64, 128, 1.0),
                 (torch.bfloat16, 8, 512, False, 64, 128, 1.0),
                 (torch.bfloat16, 8, 449, False, 64, 128, 1.0),
                 (torch.bfloat16, 1, 4096, True, 64, 128, 1.0),
                 (torch.bfloat16, 1, 4096, True, 64, 128, 1e-4),
                 (torch.float32, 1, MESH_SCAN[1] // MESH[0], True, 64, 128,
                  1e-4),
                 (torch.bfloat16, 1, MESH_SCAN[1] // MESH[0], True, 64, 128,
                  1e-4),
                 (torch.float32, 8, 512, False, 50, 16, 1.0),
                 (torch.float32, 8, 449, False, 50, 16, 1.0),
                 (torch.bfloat16, 8, 512, False, 50, 16, 1.0),
                 (torch.bfloat16, 8, 449, False, 50, 16, 1.0),
                 (torch.bfloat16, 2, 1800, True, 50, 16, 1.0),
                 (torch.bfloat16, 1, 4096, True, 50, 16, 1e-4)]
    for dtype, b, S, with_init, P, N, a_scale in ssd_cases:
        es = torch.tensor([], dtype=dtype).element_size()
        x = randn(b, S, H, P, dtype=dtype, scale=0.5)
        dt = F.softplus(randn(b, S, H, dtype=torch.float32))
        A = -torch.exp(randn(H, dtype=torch.float32, scale=0.3)) * a_scale
        Bm = randn(b, S, N, dtype=dtype, scale=0.5)
        Cm = randn(b, S, N, dtype=dtype, scale=0.5)
        init = randn(b, H, P, N, dtype=torch.float32) if with_init else None
        args = (x, dt, A, Bm, Cm)
        fns = (lambda: ops.ssd_scan(*args, chunk=chunk, init_state=init),
               lambda: ssd_scan_plain(*args, chunk=chunk, init_state=init),
               None)
        n_ops = 0
        for c0 in range(0, S, chunk):
            q = min(chunk, S - c0)
            n_ops += b * (2 * q * q * N + H * (2 * q * q * P + 4 * q * P * N))
        route = ssd_route(dtype, H, P, N)
        before = SSD_ROUTE_LAUNCHES[route]
        got = ops.ssd_scan(*args, chunk=chunk, init_state=init)
        if SSD_ROUTE_LAUNCHES[route] != before + 1:
            raise AssertionError(f"ssd_scan ({b}, {S}) {dtype}: the {route} "
                                 "kernel did not launch")
        check("ssd_scan", [b, S, H, P, N] + (["init"] if with_init else [])
              + (["long_memory"] if a_scale != 1.0 else []),
              dtype, got, ssd_scan_plain(*args, chunk=chunk, init_state=init),
              es * (2 * b * S * H * P + 2 * b * S * N)
              + 4 * (b * S * H + H + b * H * P * N * (2 if with_init else 1)),
              n_ops, fns, relative=True, route=route)
        del x, Bm, Cm, init, args, got

    # ssd_scan_bwd, K4's backward (dx, ddt, dA, dB, dC, d init_state from x,
    # dt, A, B, C, dy and the final state's cotangent), against
    # ssd_scan_bwd_plain: mamba2_1_3b's training scan (b 8, S 512, P 64, N
    # 128) and hymba_1_5b's (b 2, S 2048, P 50, N 16), fp32 and bf16; a
    # ragged S (449, 1800) from an initial state with a cotangent of the
    # final state; the long-memory inputs (b 1, S 4096, A times 1e-4) at
    # both, where an adjoint carried in bf16 or dA summed in low precision
    # would show.  bf16 at P 64, N 128 takes the tensor cores ("wgmma"), the
    # rest the CUDA cores ("simt"), each case on the route it must take.  B and C are the halves of one (b, S, 2N) tensor, read in
    # place.  The least operations, per (batch row, sub-chunk of q <= 64
    # rows): C B^T once (lower triangle), and per head dy (x dt)^T, (L o C
    # B^T)^T dy, (L o dy (x dt)^T)^T C and (L o dy (x dt)^T) B (triangles:
    # q (q + 1) each), and B G^T, (x dt) G, dy s0, the adjoint's update and
    # the states' (2 q P N each); no PyTorch call computes it (library:
    # none)
    H = 64
    ssd_bwd_cases = [(torch.float32, 8, 512, False, 64, 128, 1.0),
                     (torch.bfloat16, 8, 512, False, 64, 128, 1.0),
                     (torch.bfloat16, 8, 449, True, 64, 128, 1.0),
                     (torch.bfloat16, 1, 4096, True, 64, 128, 1e-4),
                     (torch.float32, 2, 2048, False, 50, 16, 1.0),
                     (torch.bfloat16, 2, 2048, False, 50, 16, 1.0),
                     (torch.bfloat16, 2, 1800, True, 50, 16, 1.0),
                     (torch.bfloat16, 1, 4096, True, 50, 16, 1e-4)]
    for dtype, b, S, with_init, P, N, a_scale in ssd_bwd_cases:
        es = torch.tensor([], dtype=dtype).element_size()
        x = randn(b, S, H, P, dtype=dtype, scale=0.5)
        dt = F.softplus(randn(b, S, H, dtype=torch.float32))
        A = -torch.exp(randn(H, dtype=torch.float32, scale=0.3)) * a_scale
        BC = randn(b, S, 2 * N, dtype=dtype, scale=0.5)
        Bm, Cm = BC[..., :N], BC[..., N:]
        dy = randn(b, S, H, P, dtype=dtype)
        init = randn(b, H, P, N, dtype=torch.float32) if with_init else None
        dstate = randn(b, H, P, N, dtype=torch.float32) if with_init else None
        args = (x, dt, A, Bm, Cm, dy)
        kw = dict(init_state=init, dstate=dstate)
        route = ssd_bwd_route(dtype, H, P, N, (BC.stride(0), BC.stride(1)))
        if route != ("wgmma" if (dtype, P) == (torch.bfloat16, 64)
                     else "simt"):
            raise AssertionError(f"ssd_scan_bwd {dtype} P {P}: route {route}")
        before = SSD_BWD_ROUTE_LAUNCHES[route]
        got = ops.ssd_scan_bwd(*args, **kw)
        if SSD_BWD_ROUTE_LAUNCHES[route] != before + 1:
            raise AssertionError(f"ssd_scan_bwd ({b}, {S}) {dtype}: the "
                                 f"{route} route did not launch")
        same_bits(lambda: ops.ssd_scan_bwd(*args, **kw))
        want = ssd_scan_bwd_plain(*args, chunk=chunk, **kw)
        n_ops = 0
        for c0 in range(0, S, 64):
            q = min(64, S - c0)
            n_ops += b * (q * (q + 1) * N + H * (2 * q * (q + 1) * (P + N)
                                                 + 10 * q * P * N))
        n_bytes = (es * (3 * b * S * H * P + 4 * b * S * N)
                   + 4 * (2 * b * S * H + 2 * H
                          + b * H * P * N * (3 if with_init else 0)))
        fns = (lambda: ops.ssd_scan_bwd(*args, **kw),
               lambda: ssd_scan_bwd_plain(*args, chunk=chunk, **kw), None)
        check("ssd_scan_bwd", [b, S, H, P, N]
              + (["init", "dstate"] if with_init else [])
              + (["long_memory"] if a_scale != 1.0 else []), dtype,
              tuple(g for g in got if g is not None),
              tuple(w for w in want if w is not None), n_bytes, n_ops, fns,
              relative=True, route=route)
        del x, BC, Bm, Cm, dy, init, dstate, args, got, want
        free(torch)
    del flush
    emit({"phase": "kernels", "names": list(KERNELS), "cases": len(cases)})
    return cases


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def phase_parity(torch, model, window=None):
    """``window``: a sliding window to put in place of the model's own."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import build
    from repro_torch.serve import EngineConfig, ServeEngine

    cfg = dataclasses.replace(get_config(model), n_layers=2,
                              param_dtype="float32", compute_dtype="float32")
    if cfg.family == "encdec":
        cfg = dataclasses.replace(cfg, n_enc_layers=2)
    if window is not None:
        cfg = dataclasses.replace(cfg, sliding_window=window)
    bundle = build(cfg)
    p_card = bundle.init(SEED, device="cuda")
    p_cpu = _to(p_card, "cpu")
    rng = np.random.default_rng(SEED)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size - 1,
                                                     (2, 64)))}
    if cfg.family == "vlm":  # the vision stub's output ahead of the tokens
        batch["patch_embeds"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.frontend_seq, cfg.frontend_dim)).astype(np.float32))
    if cfg.family == "encdec":  # random frames: each row its own encoding
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.enc_seq, cfg.frontend_dim)).astype(np.float32))
    with torch.inference_mode():
        got = bundle.forward(p_card, _to(batch, "cuda")).cpu()
        want = bundle.forward(p_cpu, batch)
        # the engine's frames are zeros, the same encoding for every row:
        # prefill and decode here from the random ones, on both
        steps = (decode_logits(torch, bundle, p_card, batch, "cuda"),
                 decode_logits(torch, bundle, p_cpu, batch, "cpu")) \
            if cfg.family == "encdec" else None
    diff = (got - want).abs()
    tol = 2e-3
    ok_logits = bool((diff <= tol * (1 + want.abs())).all())
    step_err = None
    if steps is not None:
        step_err = max((g - w).abs().max().item() for g, w in zip(*steps))
        ok_logits &= all(bool(((g - w).abs() <= tol * (1 + w.abs())).all())
                         for g, w in zip(*steps))
    prompts = [rng.integers(0, cfg.vocab_size - 1, n).astype(np.int32)
               for n in (40, 64)]
    # max_seq 128 holds both requests; at 48 the prompt of 64 is longer
    # than the cache and the prompt of 40 decodes past its end
    tokens, replays = {}, {}
    for max_seq in (128, 48):
        for device, params in (("cuda", p_card), ("cpu", p_cpu)):
            eng = ServeEngine(bundle, params, EngineConfig(batch_size=2,
                                                           max_seq=max_seq),
                              device=device)
            for pr in prompts:
                eng.submit(pr, max_new_tokens=9)  # prefill + 8 decode steps
            tokens[device, max_seq] = [r.out_tokens for r in eng.run()]
            replays[device, max_seq] = eng.decoder.replays
            del eng
    emit({"phase": "parity", "model": model, "n_layers": 2, "dtype": "float32",
          "sliding_window": cfg.sliding_window,
          "prefill_logits_max_abs_err": diff.max().item(), "tol": tol,
          **({} if step_err is None else
             {"decode_logits_max_abs_err_random_frames": step_err}),
          "prompt_lens": [len(p) for p in prompts], "new_tokens": 9,
          **{f"tokens_{'card' if d == 'cuda' else d}_max_seq_{n}": t
             for (d, n), t in tokens.items()},
          "card_graph_replays": {n: replays["cuda", n] for n in (128, 48)}})
    del p_card, p_cpu
    free(torch)
    if not ok_logits:
        raise AssertionError("card and CPU logits disagree")
    for n in (128, 48):
        if tokens["cuda", n] != tokens["cpu", n]:
            raise AssertionError(f"card and CPU greedy tokens differ at "
                                 f"max_seq {n}")
        if replays["cuda", n] != 8 or replays["cpu", n] != 0:
            raise AssertionError(f"replays {replays}: the card engine did not "
                                 "replay its graph for every decode step")


def train_launches(cfg, steps, tokens, recompute=True, experts=None,
                   rows=None):
    """Kernel launches of ``steps`` train steps of ``tokens`` tokens with no
    gradient accumulation.  With per-layer recomputation (``recompute``,
    the default: ``lm.run_stack``'s checkpoint of each layer step) each
    product of a layer (``expected_launches``' count of one prefill, less
    the unembedding) four times: its forward, its forward again in the
    backward's recompute of the layer, and its two backward products (dx
    and dw; every product's input needs its gradient, the first layer's
    through the embedding or the learned positions); the unembedding,
    outside the stacks, three times; each attention (banded or not) and
    each scan twice forward and once backward.  Without it, every product
    three times and each attention and scan once forward.  On the routes
    of the model's dtype (bf16: the attention backward's wgmma, the scans'
    tensor-core kernels and the scan backward's route, ssd_bwd_route's:
    "wgmma" at P 64, N 128, "simt" at P 50, N 16; fp32: the CUDA cores).
    The products by route ("streamed_matmul_<route>"): an MoE layer's fp32
    router as often as a layer's product on "fp32"; its three grouped
    products on ``grouped_route``'s routes at the capacity of ``tokens``
    (y once, or twice with the recompute; dx = dy w^T, w transposed; dw =
    x^T dy, C padded as ``ops.pad_capacity`` pads it); every other product
    on "wgmma" (bf16) or "fp32".  Under expert parallelism a rank's grouped
    products take its ``experts`` (E / M) at ``rows`` (C M) per expert."""
    import torch
    from repro_torch.kernels.ssd_scan import (SSD_BWD_ROUTE_LAUNCHES,
                                              SSD_ROUTE_LAUNCHES,
                                              ssd_bwd_route, ssd_route)
    from repro_torch.kernels.ops import ROW_MULTIPLE
    from repro_torch.kernels.streamed_matmul import (ROUTE_LAUNCHES,
                                                     grouped_route)
    from repro_torch.models.moe import _capacity
    launches, _, _ = expected_launches(cfg, 1, 0, 0, 0)
    fwd = 2 if recompute else 1  # forwards of each layer step a train step
    attn = launches["flash_attention"] * steps
    scans = launches["ssd_scan"] * steps
    bf16 = cfg.compute_dtype == "bfloat16"
    dtype = torch.bfloat16 if bf16 else torch.float32
    scan_routes = dict.fromkeys(SSD_ROUTE_LAUNCHES, 0)
    bwd_routes = dict.fromkeys(SSD_BWD_ROUTE_LAUNCHES, 0)
    if scans:
        shape = (dtype, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state)
        scan_routes[ssd_route(*shape)] = fwd * scans
        bwd_routes[ssd_bwd_route(*shape)] = scans
    products = ((fwd + 2) * (launches["streamed_matmul"] - 1) + 3) * steps
    routes = dict.fromkeys(ROUTE_LAUNCHES, 0)
    n_moe = cfg.moe_layer_split()[0] if cfg.family == "moe" else 0
    if n_moe:
        E, d, f = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
        C = _capacity(tokens, cfg.top_k, E, cfg.capacity_factor)
        E, C = experts or E, rows or C
        Cp = -(-C // ROW_MULTIPLE) * ROW_MULTIPLE if bf16 else C
        routes["fp32"] = (fwd + 2) * n_moe * steps
        for K, N in ((d, f), (d, f), (f, d)):  # wg, wu, wd
            for route, n in ((grouped_route(E, C, N, K, dtype), fwd),
                             (grouped_route(E, C, K, N, dtype, w_t=1), 1),
                             (grouped_route(E, K, N, Cp, dtype), 1)):
                routes[route] += n * n_moe * steps
    routes["wgmma" if bf16 else "fp32"] += products - sum(routes.values())
    return {"streamed_matmul": products,
            "flash_attention": fwd * attn, "decode_attention": 0,
            "ssd_scan": fwd * scans, "flash_attention_bwd": attn,
            "ssd_scan_bwd": scans,
            "flash_attention_bwd_wgmma": attn if bf16 else 0,
            "flash_attention_bwd_fp32": 0 if bf16 else attn,
            **{f"ssd_scan_{r}": n for r, n in scan_routes.items()},
            **{f"ssd_scan_bwd_{r}": n for r, n in bwd_routes.items()},
            **{f"streamed_matmul_{r}": n for r, n in routes.items()}}


def _counts(ops):
    """Every kernel's launches, the backward kernels', and the matmul's,
    the attention backward's, the scan's and the scan backward's by
    route."""
    from repro_torch.kernels.flash_attention import BWD_ROUTE_LAUNCHES
    from repro_torch.kernels.ssd_scan import (SSD_BWD_ROUTE_LAUNCHES,
                                              SSD_ROUTE_LAUNCHES)
    from repro_torch.kernels.streamed_matmul import ROUTE_LAUNCHES
    return {**ops.LAUNCHES, **ops.GRAD_LAUNCHES,
            **{f"flash_attention_bwd_{r}": n
               for r, n in BWD_ROUTE_LAUNCHES.items()},
            **{f"ssd_scan_{r}": n for r, n in SSD_ROUTE_LAUNCHES.items()},
            **{f"ssd_scan_bwd_{r}": n
               for r, n in SSD_BWD_ROUTE_LAUNCHES.items()},
            **{f"streamed_matmul_{r}": n for r, n in ROUTE_LAUNCHES.items()}}


def phase_train_parity(torch, model, window=None):
    """One ``make_train_step`` step at full width, depth 2 (whisper: 2
    encoder and 2 decoder layers), fp32: the port on the card (kernels,
    forward and backward) against the port on the CPU (plain versions),
    from the same state and batch; ``window``: a sliding window to put in
    place of the model's own.  The loss and the gradient norm within
    1e-4; every moment within 1e-4 of its leaf's largest value (the
    gradients agree); every parameter whose clipped gradient is above 1e-5
    (1000 eps) within 1e-3 lr, and each parameter leaf within 5e-3 lr on
    average.  Adam's first update is g / (|g| + eps) x lr, whose slope eps
    / (|g| + eps)^2 turns the noise of the sums of a gradient near eps into
    up to 2 lr, and only there.  On the card, the loss and every gradient
    of ``loss_and_grads`` with the per-layer recompute equal, bit for
    bit, those without it (``set_recompute(False)``)."""
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.kernels import ops
    from repro_torch.models import build
    from repro_torch.models.common import set_recompute, tree_leaves
    from repro_torch.train import (AdamWConfig, TrainConfig, init_state,
                                   make_train_step)
    from repro_torch.train.loop import loss_and_grads, to_device

    cfg = dataclasses.replace(get_config(model), n_layers=2,
                              param_dtype="float32", compute_dtype="float32")
    if cfg.family == "encdec":
        cfg = dataclasses.replace(cfg, n_enc_layers=2)
    if window is not None:
        cfg = dataclasses.replace(cfg, sliding_window=window)
    bundle = build(cfg)
    lr = 1e-3
    tcfg = TrainConfig(opt=AdamWConfig(lr=lr, warmup_steps=1))
    step = make_train_step(bundle.loss, tcfg)
    state = init_state(bundle.init(SEED, device="cuda"), tcfg.opt)
    batch = make_batch(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=64, global_batch=2,
        seed=SEED, family=cfg.family, frontend_seq=cfg.enc_seq,
        frontend_dim=cfg.frontend_dim), 0)
    ops.reset_launches()
    card, m_card = step(state, to_device(batch, "cuda"))
    torch.cuda.synchronize()
    launches = _counts(ops)
    # the loss and every gradient on the card with the per-layer
    # recompute and without it: equal bit for bit
    on = loss_and_grads(bundle.loss, state["params"],
                        to_device(batch, "cuda"))
    set_recompute(False)
    try:
        off = loss_and_grads(bundle.loss, state["params"],
                             to_device(batch, "cuda"))
    finally:
        set_recompute(True)
    recompute_equal = torch.equal(on[0], off[0]) and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(on[2]),
                                          tree_leaves(off[2])))
    del on, off
    cpu, m_cpu = step(_to(state, "cpu"), to_device(batch, "cpu"))
    got, want = convert.flatten(_to(card, "cpu")), convert.flatten(cpu)
    worst = {"params_max_over_lr": 0.0, "params_max_over_lr_above_1000eps":
             0.0, "params_mean_over_lr": 0.0, "moments_rel": 0.0}
    for name, w in want.items():
        diff = (got[name].double() - w.double()).abs()
        if name.startswith("params"):
            # m = (1 - b1) g clip after one step: |g clip| > 1e-5 where
            # |m| > 1e-6
            above = want["opt/m" + name[len("params"):]].abs() > 1e-6
            for key, d in (("params_max_over_lr", diff),
                           ("params_max_over_lr_above_1000eps", diff[above])):
                if d.numel():
                    worst[key] = max(worst[key], d.max().item() / lr)
            worst["params_mean_over_lr"] = max(worst["params_mean_over_lr"],
                                               diff.mean().item() / lr)
        elif name.startswith("opt/m") or name.startswith("opt/v"):
            worst["moments_rel"] = max(worst["moments_rel"], diff.max().item()
                                       / max(w.abs().max().item(), 1e-30))
    metrics = {k: (float(m_card[k]), float(m_cpu[k])) for k in m_card}
    expect = train_launches(cfg, 1, 2 * 64)
    emit({"phase": "train_parity", "model": model, "n_layers": 2,
          "dtype": "float32", "batch": [2, 64], "lr": lr,
          "sliding_window": cfg.sliding_window,
          "metrics_card_cpu": metrics, **worst, "launches": launches,
          "expected_launches": expect,
          "recompute_off_loss_and_grads_equal": recompute_equal})
    del state, card, cpu, got, want
    free(torch)
    if not recompute_equal:
        raise AssertionError("the card's loss or gradients with the per-layer "
                             "recompute differ from those without it")
    for k, (a, b) in metrics.items():
        if not abs(a - b) <= 1e-4 * (1 + abs(b)):
            raise AssertionError(f"train step {k}: card {a} != CPU {b}")
    if not (worst["params_max_over_lr_above_1000eps"] <= 1e-3
            and worst["params_mean_over_lr"] <= 5e-3
            and worst["moments_rel"] <= 1e-4):
        raise AssertionError(f"card and CPU train steps disagree: {worst}")
    if launches != expect:
        raise AssertionError(f"launch counts {launches} != {expect}")


def phase_train(torch, dev, model, batch, seq, lr, path, steps=5,
                depth=None):
    """``model`` at full width and depth (``depth`` layers where given),
    bf16 parameters, fp32 moments, AdamW at ``lr`` after a warmup of 2
    steps,
    ``steps`` steps of ``train_loop`` on ``data/pipeline.py``'s batches
    from seed 0, counts set to 0 just before: every step's loss finite,
    the last below the first; the launches per kernel as expected, every
    product (the grouped ones forward, dx and dw), attention backward and
    scan backward on its bf16 kernel (an MoE router on the fp32 one) and
    no plain version called; step time (between the loop's requests for
    batches: each step ends when the card has finished it), tokens/s and
    peak memory; then a checkpoint saved and restored (equal bit for bit)
    and one more step from each: the step from the trained state profiled
    for the device's idle share and the backward kernels' device time,
    CUDA-event times of its forward and backward and of its optimizer
    update apart, and its new state (kept on the host, so that a 1.5 B
    model's two states and a step's activations need not share the card)
    equal bit for bit to the one from the restored state."""
    from repro_torch import convert
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.kernels import ops
    from repro_torch.kernels.streamed_matmul import ROUTE_LAUNCHES
    from repro_torch.models import build
    from repro_torch.train import (AdamWConfig, TrainConfig, make_train_step,
                                   train_loop)
    from repro_torch.train.loop import loss_and_grads, to_device
    from repro_torch.train.optimizer import adamw_update

    t_phase = time.perf_counter()
    cfg = get_config(model)
    if depth is not None:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    bundle = build(cfg)
    tcfg = TrainConfig(opt=AdamWConfig(lr=lr, warmup_steps=2))
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                      global_batch=batch, seed=SEED)
    stamps = []

    def stream():
        i = 0
        while True:
            stamps.append(time.perf_counter())
            yield make_batch(dcfg, i)
            i += 1

    with plain_refused(ops):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        state, history = train_loop(bundle, tcfg, stream(), n_steps=steps,
                                    seed=SEED, device="cuda", log_every=1)
        stamps.append(time.perf_counter())
        launches, routes = _counts(ops), dict(ROUTE_LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_s = [b - a for a, b in zip(stamps[:-1], stamps[1:])][:steps]
    warm = statistics.median(step_s[1:])
    losses = [h["loss"] for h in history]

    # a checkpoint of the trained state, restored later; the next step from
    # the trained state, profiled, its new state kept on the host
    ckpt_dir = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    t0 = time.perf_counter()
    save_checkpoint(str(ckpt_dir), state, step=steps)
    save_s = time.perf_counter() - t0
    step = make_train_step(bundle.loss, tcfg)
    nxt = to_device(make_batch(dcfg, steps), "cuda")
    step(state, nxt)  # warm, outside the profile
    prof = profile_train_step(torch, lambda: step(state, nxt))
    # the step's two parts apart: CUDA events around the forward and
    # backward (loss_and_grads) and around the optimizer update
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    _, _, grads = loss_and_grads(bundle.loss, state["params"], nxt)
    ev[1].record()
    adamw_update(state["params"], grads, state["opt"], tcfg.opt)
    ev[2].record()
    torch.cuda.synchronize()
    prof["events_ms"] = {"loss_and_grads": ev[0].elapsed_time(ev[1]),
                         "adamw_update": ev[1].elapsed_time(ev[2])}
    del grads
    a = _to(step(state, nxt)[0], "cpu")
    t0 = time.perf_counter()
    restored, at = restore_checkpoint(str(ckpt_dir), state)
    restore_s = time.perf_counter() - t0
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    fs, fr = convert.flatten(state), convert.flatten(restored)
    same_restore = at == steps and all(torch.equal(fs[n], fr[n]) for n in fs)
    del state, fs
    free(torch)
    b = step(restored, nxt)[0]
    torch.cuda.synchronize()
    fa, fb = convert.flatten(a), convert.flatten(b)
    same = all(torch.equal(fa[n], fb[n].cpu()) for n in fa)
    expect = train_launches(cfg, steps, batch * seq)
    record_step(path, "train", cfg, batch, seq, "the batch's sequence",
                warm * 1e3)
    n_params = sum(t.numel() for n, t in fa.items() if n.startswith("params"))
    emit({"phase": "train", "model": model, "path": path,
          "n_layers": cfg.n_layers, "sliding_window": cfg.sliding_window,
          "dtype": cfg.param_dtype, "moments": tcfg.opt.moment_dtype,
          "batch": batch, "seq": seq, "tokens_per_step": batch * seq,
          "steps": steps, "lr": lr, "nvidia_smi": dev["smi"],
          "losses": losses,
          "grad_norms": [h["grad_norm"] for h in history],
          "step_s": step_s, "step_s_median_after_first": warm,
          "tokens_per_s": batch * seq / warm, "peak_mem_gb": peak_gb,
          "launches": launches, "expected_launches": expect,
          "matmul_routes": routes, "profile_one_step": prof,
          "k2_backward_device_ms_per_step": sum(
              ms for name, ms in prof["port_kernels_ms"].items()
              if name.startswith("flash_bwd")),
          "k4_backward_device_ms_per_step": sum(
              ms for name, ms in prof["port_kernels_ms"].items()
              if name.startswith("ssd_bwd")),
          "checkpoint_save_s": save_s, "checkpoint_restore_s": restore_s,
          "restored_state_equal": same_restore, "resumed_step_equal": same,
          "n_params": n_params, "phase_s": time.perf_counter() - t_phase})
    del restored, a, b, fa, fb, fr
    free(torch)
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"losses {losses}: not finite and falling")
    if launches != expect or not all(launches[k] for k, n in expect.items()
                                     if n):
        raise AssertionError(f"launch counts {launches} != {expect}")
    scan_bwd = "ssd_scan_bwd_" + ("wgmma" if cfg.ssm_headdim == 64
                                  else "simt")
    if cfg.compute_dtype != "bfloat16" or \
            launches["flash_attention_bwd_wgmma"] != \
            launches["flash_attention_bwd"] or \
            launches[scan_bwd] != launches["ssd_scan_bwd"]:
        raise AssertionError(f"launch counts {launches}: a backward off its "
                             "bf16 kernel")
    want = {r: expect[f"streamed_matmul_{r}"] for r in routes}
    if routes != want:
        raise AssertionError(f"routes {routes} != {want}: not every product "
                             f"of {launches['streamed_matmul']} on the wgmma "
                             "kernel, an MoE router's on the fp32 kernel, an "
                             "expert's on the grouped wgmma kernel")
    if not same_restore:
        raise AssertionError("the restored checkpoint differs from the state "
                             "saved")
    if not same:
        raise AssertionError("the step from the restored checkpoint differs "
                             "from the step without the restore")
    grouped = sum(n for r, n in routes.items() if "grouped" in r)
    return dict(launches, grouped=grouped) if grouped else launches


@contextlib.contextmanager
def plain_refused(ops):
    """Every kernel's plain version raises if called (a training path runs
    none of them on the card)."""
    def refuse(name):
        def plain(*args, **kwargs):
            raise AssertionError(f"{name} ran on the training path")
        return plain

    names = ("matmul_plain", "grouped_matmul_plain", "flash_attention_plain",
             "flash_attention_lse_plain", "flash_attention_bwd_plain",
             "ssd_scan_plain", "ssd_scan_bwd_plain")
    saved = {n: getattr(ops, n) for n in names}
    for n in names:
        setattr(ops, n, refuse(n))
    try:
        yield
    finally:
        for n in names:
            setattr(ops, n, saved[n])


def load_example(name: str):
    """``examples/<name>.py`` as a module (the examples are scripts)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    return example


TRAIN_100M_BATCH = 8  # examples/train_100m_torch.py's global batch


def phase_train_100m(torch, dev):
    """``examples/train_100m_torch.py --full`` on the card, through its
    ``main``: llama_100m (12 layers, d 768, 12/4 heads, vocab 32000, bf16),
    300 steps of 8 x 256 tokens, AdamW lr 1e-3 after 20 warmup steps, a
    checkpoint every 100 steps; counts set to 0 just before.  The loss
    falls (the example raises otherwise, and so does this phase), the
    three checkpoints are written, the launches are ``train_launches``'
    (every product on "wgmma", every attention backward on its wgmma
    route) and no plain version ran; step time (the example's, from one
    request for a batch to the next, checkpoints saved between), tokens/s,
    peak memory and the stragglers the loop flagged."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.streamed_matmul import ROUTE_LAUNCHES

    t_phase = time.perf_counter()
    example = load_example("train_100m_torch")
    ckpt_dir = ROOT / "build" / "chip_smoke_train_100m"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    printed = io.StringIO()
    with plain_refused(ops), contextlib.redirect_stdout(printed):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        out = example.main(["--full", "--checkpoint-dir", str(ckpt_dir)])
        launches, routes = _counts(ops), dict(ROUTE_LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ckpts = sorted((d for d in os.listdir(ckpt_dir) if d.startswith("step-")),
                   key=lambda d: int(d.split("-")[1]))
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    free(torch)
    cfg = example.small_llama(True)
    expect = train_launches(cfg, out["steps"], out["tokens_per_step"])
    warm = statistics.median(out["step_s"][1:])
    record_step("train_100m", "train", cfg, TRAIN_100M_BATCH,
                out["tokens_per_step"] // TRAIN_100M_BATCH,
                "the batch's sequence", warm * 1e3)
    losses = out["losses"]
    emit({"phase": "train_100m", "model": out["model"],
          "n_params": out["n_params"], "n_layers": cfg.n_layers,
          "dtype": cfg.param_dtype, "steps": out["steps"],
          "tokens_per_step": out["tokens_per_step"],
          "nvidia_smi": dev["smi"], "device": out["device"],
          "losses": losses, "step_s_median_after_first": warm,
          "step_s_max": max(out["step_s"]),
          "tokens_per_s": out["tokens_per_step"] / warm,
          "peak_mem_gb": peak_gb, "checkpoints": ckpts,
          "stragglers": out["stragglers"], "launches": launches,
          "expected_launches": expect, "matmul_routes": routes,
          "printed": printed.getvalue().splitlines(),
          "phase_s": time.perf_counter() - t_phase})
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"losses {losses}: not finite and falling")
    if ckpts != ["step-100", "step-200", "step-300"]:
        raise AssertionError(f"checkpoints {ckpts}, not one every 100 steps")
    if launches != expect or routes["wgmma"] != launches["streamed_matmul"] \
            or launches["flash_attention_bwd_wgmma"] != \
            launches["flash_attention_bwd"]:
        raise AssertionError(f"launch counts {launches} != {expect} or off "
                             f"the bf16 kernels ({routes})")
    return launches


# the mesh phase: deepseek_moe_16b at full width, depth 2 (one dense and
# one MoE layer), fp32, capacity factor 16 (nothing dropped), a batch of
# 4 x 512, over a 2 x 2 ("data", "model") tenant that the hypervisor places
# on a 2 x 2 topology of 4 ranks; the ranks are processes that share the one
# card through the gloo backend (NCCL refuses two ranks on one device).  And
# K4's sequence-parallel scan at mamba2_1_3b's (b 1, S 4096, H 64, P 64, N
# 128) on long-memory inputs (A times 1e-4), over the data axis.
MESH = (2, 2)
MESH_BATCH, MESH_SEQ, MESH_LR = 4, 512, 3e-4
MESH_SCAN = (1, 4096, 64, 64, 128)
# a rank's rows at its grouped products: the capacity of its 2 x 256 tokens
# (ceil(512 x 6 / 64 x 16) = 768) times the M ranks its all_to_all gathers
MESH_CAPACITY_ROWS = 768 * MESH[1]
# the phase's own limit on its ranks (measured 68-79 s on the H100), and
# below it each collective's, so that a hung rank fails the phase with its
# exit code well inside the script's 1200 s
MESH_TIMEOUT_S, MESH_COLLECTIVE_TIMEOUT_S = 240, 180
# the pipeline check in the mesh phase's world: 4 stages over a "pod" axis
# of its 4 ranks, each one layer of qwen2_0_5b at full width; 8
# microbatches of 1 x 512 (bubble fraction 3 / 11)
PIPE_STAGES, PIPE_MICRO, PIPE_SEQ = 4, 8, 512


def mesh_config(dtype):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("deepseek_moe_16b"), n_layers=2,
                               param_dtype=dtype, compute_dtype=dtype,
                               capacity_factor=16.0)


def mesh_batch(torch, cfg):
    from repro_torch.data import DataConfig, make_batch
    batch = make_batch(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=MESH_SEQ, global_batch=MESH_BATCH,
        seed=SEED, family=cfg.family, frontend_seq=cfg.enc_seq,
        frontend_dim=cfg.frontend_dim), 0)
    return {k: torch.as_tensor(v).cuda() for k, v in batch.items()}


@contextlib.contextmanager
def mesh_aux_loss(torch):
    """The unsharded model with the MoE aux loss that a (data, model) mesh
    of ``MESH`` defines (the JAX package's ``moe_forward``: the mean over
    the ranks of each rank's aux loss over its own tokens, a data shard's
    rows and a model shard's positions): the routed output from every
    token at once, the aux loss per token block.  Capacity factor 16 drops
    nothing, so the output is the same either way."""
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    local_moe = moe._local_moe
    D, M = MESH

    def partitioned(cfg, x_flat, router_w, wg, wu, wd, **kw):
        y, _ = local_moe(cfg, x_flat, router_w, wg, wu, wd, **kw)
        E, k = cfg.n_experts, cfg.top_k
        probs = torch.softmax(ops.matmul(x_flat.float(), router_w), dim=-1)
        idx = torch.topk(probs, k, dim=-1).indices
        probs = probs.view(D, MESH_BATCH // D, M, MESH_SEQ // M, E)
        idx = idx.view(D, MESH_BATCH // D, M, MESH_SEQ // M, k)
        auxes = []
        for i in range(D):
            for j in range(M):
                p, ix = probs[i, :, j].reshape(-1, E), idx[i, :, j].reshape(-1)
                ce = torch.bincount(ix, minlength=E).float() / ix.numel()
                auxes.append(E * torch.sum(p.mean(dim=0) * ce))
        return y, torch.stack(auxes).mean()

    moe._local_moe = partitioned
    try:
        yield
    finally:
        moe._local_moe = local_moe


def mesh_scan_inputs(torch, dtype):
    """K4's long-memory inputs at ``MESH_SCAN``, the same on every rank."""
    import torch.nn.functional as F
    b, S, H, P, N = MESH_SCAN
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)

    def randn(*shape, scale=1.0, dt=dtype):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dt)
    x = randn(b, S, H, P, scale=0.5)
    dt = F.softplus(randn(b, S, H, dt=torch.float32))
    A = -torch.exp(randn(H, scale=0.3, dt=torch.float32)) * 1e-4
    return x, dt, A, randn(b, S, N, scale=0.5), randn(b, S, N, scale=0.5)


def phase_mesh(torch, dev):
    """The port's sharded path over a hypervisor-placed tenant mesh (see
    ``MESH``): the unsharded references on the card in this process (the
    forward logits; one ``make_train_step`` step with the mesh's aux loss,
    ``mesh_aux_loss``; K4 over the whole sequence, fp32 and bf16), then 4
    ranks started with spawn on cuda:0 (``mesh_rank``), each running the
    same work sharded: attention in seq mode (K2 with each shard's
    q_offset), the MoE layer's experts over the model axis through the
    all_to_all pair, ZeRO-3 gathers of every layer's weights, and
    ``seq_parallel_ssd`` over the data axis.  Limits, each against the
    unsharded run: the logits 2e-4 (1 + |ref|) (fp32, as the kernels
    phase); the scan 1e-4 (fp32), 5e-2 and 1e-2 (bf16) of max |ref|; the
    step as train_parity holds the card against the CPU (its sums differ
    only in order here too): the loss, aux loss and gradient norm within
    1e-4 (1 + |ref|), every moment within 1e-4 of its leaf's largest value,
    every parameter whose moment is above 1e-6 (a clipped gradient above
    1000 eps) within 1e-3 lr and each leaf within 5e-3 lr on average.  Each
    rank's launches of K1 (grouped too, by route), K2 (with and without an
    offset) and K4 are held exact (and those of the pipeline check that
    follows in the same world, ``PIPE_*``: its output bit-equal to the
    layers run in sequence); its collectives' bytes and transport,
    its peak memory and the wall ms of its step are printed, and one bf16
    sharded step's launches and peak too, its loss and aux loss within
    2e-2 (1 + |ref|) of the fp32 unsharded step's (the same weights
    rounded).  The rank's own kernel shapes (its grouped products, its scan
    shard) are held against their plain versions in the kernels phase.  The ranks share one card: their
    times are no speed figure."""
    import multiprocessing as mp
    import socket
    from repro_torch.kernels import ops
    from repro_torch.models import build
    from repro_torch.train import AdamWConfig, TrainConfig, init_state
    from repro_torch.train import make_train_step

    t_phase = time.perf_counter()
    work = ROOT / "build" / "mesh_phase"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    cfg = mesh_config("float32")
    bundle = build(cfg)
    params = bundle.init(SEED, device="cuda")
    batch = mesh_batch(torch, cfg)
    with torch.inference_mode():
        torch.save(bundle.forward(params, batch).cpu(), work / "logits.pt")
    tcfg = TrainConfig(opt=AdamWConfig(lr=MESH_LR, warmup_steps=1))
    step = make_train_step(bundle.loss, tcfg)
    state = init_state(params, tcfg.opt)
    with mesh_aux_loss(torch):
        step(state, batch)  # warm-up: the timed step below is the second
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new, metrics = step(state, batch)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
    torch.save({"params": _to(new["params"], "cpu"),
                "m": _to(new["opt"]["m"], "cpu"),
                "metrics": {k: float(v) for k, v in metrics.items()}},
               work / "step.pt")
    scans = {}
    for dtype in (torch.float32, torch.bfloat16):
        y, _ = ops.ssd_scan(*mesh_scan_inputs(torch, dtype), chunk=256)
        scans[str(dtype).split(".")[-1]] = y.cpu()
    torch.save(scans, work / "scan.pt")
    del params, batch, state, new, metrics, step, bundle, y
    free(torch)
    ref_s = time.perf_counter() - t_phase

    with socket.socket() as sock:  # a free port for the ranks' store
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    world = MESH[0] * MESH[1]
    ctx = mp.get_context("spawn")  # this process holds a CUDA context
    procs = [ctx.Process(target=mesh_rank, args=(r, world, port, str(work)))
             for r in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    deadline = t0 + MESH_TIMEOUT_S
    while True:  # until all end, one fails or the phase's time is up
        codes = [p.exitcode for p in procs]
        if any(c not in (None, 0) for c in codes) or \
                time.perf_counter() > deadline or all(c == 0 for c in codes):
            break
        time.sleep(0.2)
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join()
    codes = [p.exitcode for p in procs]
    ranks_s = time.perf_counter() - t0
    results = []
    for r in range(world):
        path = work / f"rank{r}.json"
        results.append(json.loads(path.read_text()) if path.exists()
                       else None)
    for res in results:
        if res is not None:
            emit(res)
    launches = {}
    for res in results:
        for k, n in (res or {}).get("launches", {}).items():
            launches[k] = launches.get(k, 0) + n
    from repro_torch.parallel import bubble_fraction
    emit({"phase": "mesh", "world": world, "mesh": list(MESH),
          "pipeline": {"stages": PIPE_STAGES, "microbatches": PIPE_MICRO,
                       "bubble_fraction": bubble_fraction(PIPE_STAGES,
                                                          PIPE_MICRO)},
          "exit_codes": codes, "reference_s": ref_s, "ranks_s": ranks_s,
          "unsharded_step_ms": step_ms,
          "unsharded_step_note": "one process alone on the card",
          "launches_all_ranks": launches,
          "seconds": time.perf_counter() - t_phase})
    shutil.rmtree(work, ignore_errors=True)
    if codes != [0] * world or None in results:
        raise AssertionError(f"the mesh phase's ranks failed or timed out: "
                             f"exit codes {codes}")
    return launches


def mesh_rank(rank, world, port, work):
    """One rank of the mesh phase (``phase_mesh``): it loads the kernels the
    parent built, joins the world, builds the hypervisor's tenant mesh,
    runs the sharded work and writes its line to ``work/rank<r>.json``; an
    error ends the process with a non-zero exit code."""
    try:
        _mesh_rank(rank, world, port, Path(work))
    except BaseException:
        import traceback
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)


def _mesh_rank(rank, world, port, work):
    sys.path.insert(0, str(SRC))
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    from repro_torch import convert
    from repro_torch.core import (DeviceTopology, Hypervisor, allocate_tenant,
                                  mesh_2d)
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssd_scan import ssd_route
    from repro_torch.models import build
    from repro_torch.models.common import (clear_mesh_context, map_tree,
                                           set_mesh_context)
    from repro_torch.models.moe import _capacity
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.seqparallel import seq_parallel_ssd
    from repro_torch.train import AdamWConfig, TrainConfig, init_state
    from repro_torch.train import make_train_step

    backend = coll.init_world(rank, world, port, "cuda",
                              timeout_s=MESH_COLLECTIVE_TIMEOUT_S)
    dt = DeviceTopology.from_ranks(list(range(world)), MESH)
    hyp = Hypervisor(dt.topo, hbm_bytes=64 << 30)
    tenant = allocate_tenant(hyp, dt, mesh_2d(*MESH, base_id=100),
                             device_type=coll.mesh_device_type(backend))
    mesh = tenant.mesh
    coords = {a: coll.axis_index(mesh, a) for a in mesh.mesh_dim_names}
    placement = [{"virtual": v, "physical_core": p, "rank": dt.rank_for(p)}
                 for v, p in sorted(tenant.vnpu.assignment.items())]
    D, M = MESH
    out = {"phase": "mesh_rank", "rank": rank, "backend": backend,
           "mesh_coords": coords, "tenant_grid": mesh.mesh.tolist(),
           "placement": placement,
           "note": "4 ranks share one H100 through gloo: times are not a "
                   "speed figure"}
    checks = {}

    def counts():
        c = _counts(ops)
        c.update({f"offset_{k}": n for k, n in ops.OFFSET_LAUNCHES.items()})
        return c

    def close(got, want, tol):
        d = (got.float() - want.float()).abs()
        return d.max().item(), bool((d <= tol * (1 + want.float().abs()))
                                    .all())

    # the sharded forward and train step, fp32 and bf16
    for dtype in ("float32", "bfloat16"):
        cfg = mesh_config(dtype)
        bundle = build(cfg)
        specs = shd.param_specs(bundle.param_logical_axes(),
                                shd.param_rules(mesh))
        local = shd.shard_tree(bundle.init(SEED, device="cuda"), specs, mesh)
        torch.cuda.empty_cache()
        batch = mesh_batch(torch, cfg)
        lbatch = shd.shard_tree(batch, shd.batch_specs(batch, mesh), mesh)
        set_mesh_context(mesh, shd.batch_axes(mesh))
        tokens = lbatch["tokens"].numel() // M  # a rank's tokens at a MoE layer
        C = _capacity(tokens, cfg.top_k, cfg.n_experts, cfg.capacity_factor)
        # the kernels phase holds the grouped products at these shapes
        checks["grouped_shape_in_kernels_phase"] = {
            "ok": C * M == MESH_CAPACITY_ROWS and cfg.n_experts // M == 32,
            "rows": C * M, "experts": cfg.n_experts // M}
        expect = train_launches(cfg, 1, tokens, experts=cfg.n_experts // M,
                                rows=C * M)
        attn = expect["flash_attention_bwd"]
        expect.update(offset_flash_attention=2 * attn,
                      offset_flash_attention_bwd=attn)
        if dtype == "float32":
            ops.reset_launches()
            with torch.inference_mode():
                logits = bundle.forward(local, lbatch)
            torch.cuda.synchronize()
            fwd = counts()
            want = torch.load(work / "logits.pt", mmap=True)
            rows = slice(coords["data"] * logits.shape[0],
                         (coords["data"] + 1) * logits.shape[0])
            err, ok = close(logits.cpu(), want[rows], 2e-4)
            checks["logits"] = {"max_abs_err": err, "ok": ok,
                                "rule": "|sharded - unsharded| <= 2e-4 (1 + "
                                        "|unsharded|)"}
            # one forward: each product once (a train step's 4 a layer
            # product and 3 for the unembedding), each attention once
            fwd_expect = {"streamed_matmul":
                          (expect["streamed_matmul"] - 3) // 4 + 1,
                          "flash_attention": attn,
                          "offset_flash_attention": attn}
            out["forward_launches"] = {k: fwd[k] for k in fwd_expect}
            checks["forward_launches"] = {"ok": out["forward_launches"] ==
                                          fwd_expect, "expected": fwd_expect}
            del logits, want
        tcfg = TrainConfig(opt=AdamWConfig(lr=MESH_LR, warmup_steps=1))
        step = make_train_step(bundle.loss, tcfg, mesh=mesh, specs=specs)
        state = init_state(local, tcfg.opt)
        coll.reset_stats()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        new, metrics = step(state, lbatch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        got = counts()
        key = f"step_{dtype}"
        out[key] = {"wall_ms": wall_ms,
                    "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                    "metrics": {k: float(v) for k, v in metrics.items()},
                    "launches": {k: got[k] for k in expect},
                    "collectives": coll.stats_line()}
        checks[f"{key}_launches"] = {"ok": out[key]["launches"] == expect,
                                     "expected": expect}
        out.setdefault("launches", {})
        for k in ("streamed_matmul", "flash_attention", "flash_attention_bwd",
                  "ssd_scan", "ssd_scan_bwd", "decode_attention"):
            out["launches"][k] = out["launches"].get(k, 0) + got.get(k, 0)
        if dtype == "float32":
            ref = torch.load(work / "step.pt", mmap=True)
            m_ok = [abs(float(metrics[k]) - ref["metrics"][k])
                    <= 1e-4 * (1 + abs(ref["metrics"][k]))
                    for k in ("loss", "aux_loss", "grad_norm")]
            sizes = shd.mesh_shape(mesh).shape
            worst = {"params_max_over_lr_above_1000eps": 0.0,
                     "params_mean_over_lr": 0.0, "moments_rel": 0.0}
            block = lambda t, s: shd.local_block(  # noqa: E731
                t, s, sizes, coords)
            mine_p = convert.flatten(new["params"])
            mine_m = convert.flatten(new["opt"]["m"])
            ref_p = convert.flatten(map_tree(block, ref["params"], specs))
            ref_m = convert.flatten(map_tree(block, ref["m"], specs))
            for name in mine_p:
                rp, rm = ref_p[name].cuda(), ref_m[name].cuda()
                dp = (mine_p[name].double() - rp.double()).abs()
                above = rm.abs() > 1e-6
                if above.any():
                    worst["params_max_over_lr_above_1000eps"] = max(
                        worst["params_max_over_lr_above_1000eps"],
                        dp[above].max().item() / MESH_LR)
                worst["params_mean_over_lr"] = max(
                    worst["params_mean_over_lr"], dp.mean().item() / MESH_LR)
                worst["moments_rel"] = max(
                    worst["moments_rel"],
                    (mine_m[name].double() - rm.double()).abs().max().item()
                    / max(rm.abs().max().item(), 1e-30))
            out[key]["unsharded_metrics"] = ref["metrics"]
            out[key].update(worst)
            checks["step"] = {"ok": all(m_ok)
                              and worst["params_max_over_lr_above_1000eps"]
                              <= 1e-3 and worst["params_mean_over_lr"] <= 5e-3
                              and worst["moments_rel"] <= 1e-4}
            del ref, ref_p, ref_m, mine_p, mine_m
        else:  # the same weights rounded to bf16: the loss near fp32's
            ref = torch.load(work / "step.pt", mmap=True)["metrics"]
            checks["step_bfloat16_loss"] = {
                "ok": all(abs(float(metrics[k]) - ref[k])
                          <= TOL["bfloat16"] * (1 + abs(ref[k]))
                          for k in ("loss", "aux_loss")),
                "rule": "|bf16 sharded - fp32 unsharded| <= 2e-2 (1 + "
                        "|fp32|), loss and aux loss"}
        clear_mesh_context()
        del local, state, new, step, batch, lbatch, metrics
        torch.cuda.empty_cache()

    # K4's sequence-parallel scan over the data axis (the model ranks of a
    # data row run the same shard)
    want = torch.load(work / "scan.pt", mmap=True)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        x, dt_, A, Bm, Cm = mesh_scan_inputs(torch, dtype)
        seq = lambda t: shd.local_block(  # noqa: E731
            t, (None, "data"), shd.mesh_shape(mesh).shape, coords).contiguous()
        ops.reset_launches()
        coll.reset_stats()
        y = seq_parallel_ssd(seq(x), seq(dt_), A, seq(Bm), seq(Cm),
                             chunk=256, mesh=mesh, axis="data")
        torch.cuda.synchronize()
        got = counts()
        route = ssd_route(dtype, *MESH_SCAN[2:])
        ref = shd.local_block(want[name], (None, "data"),
                              shd.mesh_shape(mesh).shape, coords)
        d = (y.cpu().float() - ref.float()).abs().max().item()
        tol = min(SSD_TOL[name], SSD_FINE_TOL.get(name, 1.0))
        scale = ref.float().abs().max().item()
        out[f"scan_{name}"] = {"max_abs_err": d, "max_ref": scale,
                               "tol": tol, "route": route,
                               "launches": {"ssd_scan": got["ssd_scan"],
                                            f"ssd_scan_{route}":
                                            got[f"ssd_scan_{route}"]},
                               "collectives": coll.stats_line()}
        checks[f"scan_{name}"] = {"ok": d <= tol * scale
                                  and got["ssd_scan"] == 2
                                  and got[f"ssd_scan_{route}"] == 2}
        out["launches"]["ssd_scan"] += got["ssd_scan"]

    # the GPipe pipeline over a "pod" axis of the world's ranks: the first
    # PIPE_STAGES layers of qwen2_0_5b at full width, one a stage, against
    # the same layers run in sequence on each microbatch here
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.blocks import block_forward
    from repro_torch.models.common import dtype_of, layer_slice
    from repro_torch.parallel import pipeline_forward
    pod = make_test_mesh((PIPE_STAGES,), ("pod",))
    stage = coll.axis_index(pod, "pod")
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(get_config("qwen2_0_5b"),
                                  n_layers=PIPE_STAGES, param_dtype=dtype,
                                  compute_dtype=dtype)
        layers = build(cfg).init(SEED, device="cuda")["stacks"][0]
        gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
        x = (torch.randn((PIPE_MICRO, 1, PIPE_SEQ, cfg.d_model),
                         generator=gen, device="cuda") * 0.5
             ).to(dtype_of(dtype))
        calls = []

        def stage_fn(p, h, cfg=cfg):
            calls.append(1)
            return block_forward(cfg, p["b0"], h, "dense")[0]

        with torch.inference_mode():
            coll.reset_stats()
            torch.cuda.synchronize()
            ops.reset_launches()
            t0 = time.perf_counter()
            y = pipeline_forward(
                stage_fn, x, mesh=pod, axis="pod",
                stage_params=map_tree(lambda t: t[stage:stage + 1], layers))
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            got = counts()
            seq = []
            for h in x:
                for l in range(PIPE_STAGES):
                    h = block_forward(cfg, layer_slice(layers, l)["b0"], h,
                                      "dense")[0]
                seq.append(h)
            seq = torch.stack(seq)
        route = "wgmma" if dtype == "bfloat16" else "fp32"
        expect = {"streamed_matmul": 7 * len(calls),
                  f"streamed_matmul_{route}": 7 * len(calls),
                  "flash_attention": len(calls)}
        key = f"pipeline_{dtype}"
        out[key] = {"stage": stage, "microbatches": [PIPE_MICRO, 1, PIPE_SEQ],
                    "stage_calls": len(calls), "wall_ms": wall_ms,
                    "max_abs_err": (y.float() - seq.float()).abs().max().item(),
                    "bit_equal": bits_equal(y, seq),
                    "launches": {k: got[k] for k in expect},
                    "expected_launches": expect,
                    "collectives": coll.stats_line()}
        checks[key] = {"ok": out[key]["bit_equal"]
                       and len(calls) == PIPE_MICRO + PIPE_STAGES - 1
                       and out[key]["launches"] == expect,
                       "rule": "the pipeline's output equals the layers in "
                               "sequence bit for bit; 11 stage calls, 7 K1 "
                               "and 1 K2 each"}
        for k in ("streamed_matmul", "flash_attention"):
            out["launches"][k] += got[k]
        del layers, x, y, seq
        torch.cuda.empty_cache()
    out["checks"] = checks
    (work / f"rank{rank}.json").write_text(json.dumps(out))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    bad = [k for k, c in checks.items() if not c["ok"]]
    if bad:
        raise AssertionError(f"rank {rank}: {bad} failed")


def phase_core():
    """One seeded request stream (``launch/placement.py``: creates,
    destroys and remaps on the paper's 6 x 6 SIM mesh) through
    ``repro_torch.core``'s hypervisor with every mapper, ``ilp`` (scipy's
    milp) included: the placements, the engine's counters and the host ms
    of each stream; the same stream run twice gives the same trace.  The
    core is numpy and scipy on the host; nothing runs on the card."""
    from repro_torch import core
    from repro_torch.core.engine.ilp import HAVE_MILP
    from repro_torch.launch.placement import run_stream, summarize

    if not HAVE_MILP:
        raise AssertionError("scipy.optimize.milp is missing: the ilp mapper "
                             "cannot run")
    for mapper in sorted(core.engine.MAPPERS):
        t0 = time.perf_counter()
        trace = run_stream(core, mapper, SEED)
        ms = (time.perf_counter() - t0) * 1e3
        again = run_stream(core, mapper, SEED)
        summary = summarize(trace)
        emit({"phase": "core", "mapper": mapper, "seed": SEED,
              "events": len(trace) - 1, "host_ms": ms,
              "deterministic": trace == again, **summary})
        if trace != again or not summary["placed"]:
            raise AssertionError(f"{mapper}: the stream placed nothing or "
                                 "differs when run again")


def bits_equal(a, b) -> bool:
    """The same dtype, shape and bits (a float compared through an integer
    view of its bytes, so that -0.0 and 0.0 differ)."""
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        view = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        a, b = (t.contiguous().view(view[t.element_size()]) for t in (a, b))
    return torch.equal(a.cpu(), b.cpu())


def trees_bits_equal(a, b) -> bool:
    from repro_torch import convert
    fa, fb = convert.flatten(a), convert.flatten(b)
    return fa.keys() == fb.keys() and all(bits_equal(fa[k], fb[k])
                                          for k in fa)


def phase_failover(torch, dev):
    """``examples/elastic_failover_torch.py --full`` on the card, through
    its ``main``: qwen2_0_5b at full width and depth in bf16 placed through
    ``VNPUPolicy``, 3 steps of ``make_train_step`` (AdamW lr 1e-3 after 2
    warmup steps, batches of 4 x 32 tokens from ``make_batch``), a
    checkpoint, the tenant's first core failed and migrated away from, the
    checkpoint restored, 2 more steps, the core repaired and a second
    tenant placed on it; counts set to 0 just before.  Checks: the example
    ends with OK (it raises where the JAX example asserts), every loss is
    finite, the restored state equals the saved one bit for bit, the first
    resumed step equals, bit for bit, the same step taken again from the
    saved state (an uninterrupted run's: the step is deterministic), the
    launches are ``train_launches``' for the 5 steps (every product on
    "wgmma") and no plain version ran.  Then that step's gradient tree
    through ``compress_tree`` and one step of the error-feedback
    compressor, on the card and on the CPU: the int8 payloads, the scales,
    the reconstructions and the residuals bit-equal (the same element
    operations, each one IEEE rounding, on both); ``compression_ratio`` and
    the CUDA-event ms of one ``compress_tree`` on the card."""
    from repro_torch import convert
    from repro_torch.data import make_batch
    from repro_torch.kernels import ops
    from repro_torch.parallel import (compress_tree, compression_ratio,
                                      make_error_feedback_compressor)
    from repro_torch.train import make_train_step
    from repro_torch.train.loop import loss_and_grads, to_device

    t_phase = time.perf_counter()
    example = load_example("elastic_failover_torch")
    ckpt_dir = ROOT / "build" / "chip_smoke_failover"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    printed = io.StringIO()
    with plain_refused(ops), contextlib.redirect_stdout(printed):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        out = example.main(["--full", "--checkpoint-dir", str(ckpt_dir)])
        torch.cuda.synchronize()
        launches = _counts(ops)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    lines = printed.getvalue().splitlines()
    bundle, dcfg = out["bundle"], out["data_config"]
    restored_equal = trees_bits_equal(out["state_saved"],
                                      out["state_restored"])
    batch = to_device(make_batch(dcfg, out["restored_step"]), "cuda")
    step = make_train_step(bundle.loss, out["train_config"])
    with plain_refused(ops):
        again = step(out["state_saved"], batch)[0]
    resumed_equal = trees_bits_equal(again, out["first_resumed"])
    del again
    expect = train_launches(bundle.cfg, len(out["losses"]),
                            dcfg.global_batch * dcfg.seq_len)

    # the resumed step's gradients, compressed on the card and the CPU
    _, _, grads = loss_and_grads(bundle.loss, out["state_saved"]["params"],
                                 batch)
    compress, init = make_error_feedback_compressor()
    host = _to(grads, "cpu")
    card_q, card_r = compress_tree(grads)
    cpu_q, cpu_r = compress_tree(host)
    card_ef, cpu_ef = compress(grads, init(grads)), compress(host, init(host))
    flat = convert.flatten(host)
    compression = {
        "payload_and_scales_equal": trees_bits_equal(card_q, cpu_q),
        "reconstruction_equal": trees_bits_equal(card_r, cpu_r),
        "error_feedback_grads_equal": trees_bits_equal(card_ef[0],
                                                       cpu_ef[0]),
        "error_feedback_residual_equal": trees_bits_equal(card_ef[1],
                                                          cpu_ef[1]),
        "ratio": compression_ratio(grads), "leaves": len(flat),
        "grad_dtypes": sorted({str(t.dtype) for t in flat.values()}),
        "grad_bytes": sum(t.numel() * t.element_size()
                          for t in flat.values())}
    ms = []
    for _ in range(5):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        compress_tree(grads)
        ev[1].record()
        torch.cuda.synchronize()
        ms.append(ev[0].elapsed_time(ev[1]))
    compression["compress_tree_ms"] = statistics.median(ms)
    compression["compress_tree_ms_runs"] = ms
    del grads, host, flat, card_q, card_r, cpu_q, cpu_r, card_ef, cpu_ef
    losses = out["losses"]
    emit({"phase": "failover", "model": out["model"],
          "n_layers": out["n_layers"], "dtype": out["dtype"],
          "nvidia_smi": dev["smi"], "batch": [dcfg.global_batch,
                                              dcfg.seq_len],
          "placement_before": out["before"], "dead_core": out["dead"],
          "placement_after": out["after"], "ted": out["ted"],
          "modeled_pause_ms": out["pause_ms"],
          "spare_cores": out["spare_cores"], "losses": losses,
          "restored_state_equal": restored_equal,
          "resumed_step_equal_uninterrupted": resumed_equal,
          "launches": launches, "expected_launches": expect,
          "peak_mem_gb": peak_gb, "compression": compression,
          "printed": lines, "phase_s": time.perf_counter() - t_phase})
    del out, bundle, step
    free(torch)
    if lines[-1:] != ["OK"]:
        raise AssertionError(f"the example did not end with OK: {lines}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"losses {losses}: not finite")
    if not restored_equal:
        raise AssertionError("the restored checkpoint differs from the state "
                             "saved")
    if not resumed_equal:
        raise AssertionError("the first resumed step differs from the same "
                             "step of an uninterrupted run")
    if launches != expect:
        raise AssertionError(f"launch counts {launches} != {expect}")
    if not all(v for k, v in compression.items() if k.endswith("_equal")):
        raise AssertionError(f"the card's compression differs from the "
                             f"CPU's: {compression}")
    return launches


# the tenants phase: the planes' analytic decode rate of qwen2_0_5b
# against the port's measured one (tests/test_serving.py:504-515's
# computation): 4 cores of the SIM config, a batch of 4 at about 300
# tokens of context; served on the card as 4 prompts of 288 tokens and 24
# new ones (context 288-311), max_seq 512
CALIBRATION_BATCH, CALIBRATION_PROMPT, CALIBRATION_NEW = 4, 288, 24
# the ClusterScheduler run timed on the card's host: the mixed trace, the
# vnpu policy, the serving plane on
CLUSTER_HORIZON_S = 10.0


def phase_tenants(torch, dev):
    """``examples/multi_tenant_serving_torch.py --full`` and
    ``examples/quickstart_torch.py --full`` on the card, through their
    ``main``.  The first admits llama3_2_1b and qwen2_0_5b through
    ``VNPUPolicy`` on a 2 x 4 topology of 8 rank ids, scores each against
    its co-resident's flows and serves each 2 prompts of 8 tokens, 4 new
    tokens each, through ``ServeEngine`` (batch 2, max_seq 64) at full
    width and depth in bf16; each engine's run is counted apart (counts
    read around ``ServeEngine.run``): K1 (by route: every product of
    fewer than 64 rows on "wgmma_decode", the rest on "wgmma"), K2 and
    K3, exact against ``expected_launches`` for its model, batch and
    lengths, and every decode step a replay of the engine's graph.  The
    second places a 2 x 2 and a 1 x 4 tenant and runs llama3_2_1b's forward
    and loss on 4 x 32 tokens: K1 (all "wgmma") and K2 exact.  Both end
    with OK.  Then the planes' analytic decode rate of qwen2_0_5b
    (``CALIBRATION_*``) beside the card's measured tokens/s of the full
    model at batch 4, and their ratio, the calibration constant on the
    H100 (printed, not bounded); and one ``ClusterScheduler`` run of the
    mixed trace (vnpu, the serving plane on, ``CLUSTER_HORIZON_S``) on the
    card's host, timed, run twice and compared equal."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import mesh_2d
    from repro_torch.core import simulator as S
    from repro_torch.kernels import ops
    from repro_torch.models import build
    from repro_torch.sched import (ClusterScheduler, ServingConfig,
                                   make_policy, make_trace)
    from repro_torch.sched.traces import get_serving_workload
    from repro_torch.serve import EngineConfig, ServeEngine
    from repro_torch.serve.requests import get_profile

    t_phase = time.perf_counter()
    runs = []
    real_run = ServeEngine.run

    def counted_run(self, *args, **kwargs):
        torch.cuda.synchronize()
        before, replays = _counts(ops), self.decoder.replays
        stats = dict(self.stats)
        reqs = real_run(self, *args, **kwargs)
        torch.cuda.synchronize()
        after = _counts(ops)
        runs.append({"model": self.cfg.name, "batch": self.ecfg.batch_size,
                     "prompt_len": max(len(r.prompt) for r in reqs),
                     "launches": {k: after[k] - before[k] for k in after},
                     "replays": self.decoder.replays - replays,
                     "stats": {k: self.stats[k] - stats[k] for k in stats}})
        return reqs

    printed = {}
    ServeEngine.run = counted_run
    try:
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            serving = load_example("multi_tenant_serving_torch").main(
                ["--full"])
        printed["multi_tenant_serving"] = buf.getvalue().splitlines()
    finally:
        ServeEngine.run = real_run
    checks = {}
    per_tenant = {}
    for (name, t), run in zip(serving["tenants"].items(), runs):
        cfg = get_config(t["arch"])
        st = run["stats"]
        expect, _, _ = expected_launches(cfg, st["prefills"],
                                         st["decode_steps"],
                                         run["batch"] * run["prompt_len"],
                                         run["batch"])
        per_forward = expect["streamed_matmul"] // (st["prefills"] +
                                                    st["decode_steps"])
        tall = run["batch"] * run["prompt_len"] >= 64
        routes = {"wgmma": tall * (per_forward - 1) * st["prefills"]}
        routes["wgmma_decode"] = expect["streamed_matmul"] - routes["wgmma"]
        got = run["launches"]
        per_tenant[name] = {
            "arch": t["arch"], "cores": t["cores"], "ranks": t["ranks"],
            "bw_cap": t["bw_cap"], "simulated": {
                "mode": t["mode"], "interval_cycles": t["interval_cycles"],
                "fps": t["fps"]},
            "tokens": t["tokens"], "stats": t["stats"],
            "launches": {k: got[k] for k in expect},
            "matmul_routes": {k[len("streamed_matmul_"):]: n
                              for k, n in got.items()
                              if k.startswith("streamed_matmul_") and n},
            "expected_launches": expect, "expected_routes": routes,
            "graph_replays": run["replays"]}
        checks[name] = (
            {k: got[k] for k in expect} == expect
            and all(got[k] for k, n in expect.items() if n)
            and all(got[f"streamed_matmul_{r}"] == n
                    for r, n in routes.items())
            and run["replays"] == st["decode_steps"]
            and all(len(x) == 4 and all(0 <= v < cfg.vocab_size for v in x)
                    for x in t["tokens"]))
    checks["every_tenant_served"] = len(runs) == len(serving["tenants"]) == 2

    with contextlib.redirect_stdout(io.StringIO()) as buf:
        torch.cuda.synchronize()
        ops.reset_launches()
        quick = load_example("quickstart_torch").main(["--full"])
        torch.cuda.synchronize()
        got = _counts(ops)
    printed["quickstart"] = buf.getvalue().splitlines()
    qcfg = get_config("llama3_2_1b")
    expect, _, _ = expected_launches(qcfg, 1, 0, 0, 0)
    expect["streamed_matmul_wgmma"] = expect["streamed_matmul"]
    quick_launches = {k: got[k] for k in expect}
    checks["quickstart"] = (quick_launches == expect
                            and math.isfinite(quick["loss"]))
    checks["printed_ok"] = all(v[-1:] == ["OK"] for v in printed.values())

    # the planes' analytic decode rate against the card's
    prof = get_profile("qwen2_0_5b")
    sk = S.tensor_skeleton(get_serving_workload("qwen2_0_5b"), [0, 1, 6, 7],
                           mesh_2d(6, 6), S.SIM_CONFIG)
    pm = S.derive_phase_model(sk, S.finish_tensor(sk),
                              proxy_seq=prof.proxy_seq)
    analytic = CALIBRATION_BATCH / pm.decode_step_s(
        CALIBRATION_BATCH * 300 * prof.kv_bytes_per_token,
        CALIBRATION_BATCH * 3)
    cfg = get_config("qwen2_0_5b")
    bundle = build(cfg)
    eng = ServeEngine(bundle, bundle.init(SEED, device="cuda"),
                      EngineConfig(batch_size=CALIBRATION_BATCH,
                                   max_seq=512), device="cuda")
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size - 1, CALIBRATION_PROMPT)
               .astype(np.int32) for _ in range(CALIBRATION_BATCH)]
    for pr in prompts:  # warm-up: the prefill at this length
        eng.submit(pr, max_new_tokens=4)
    eng.run()
    before = dict(eng.stats)
    for pr in prompts:
        eng.submit(pr, max_new_tokens=CALIBRATION_NEW)
    t0 = time.perf_counter()
    eng.run()
    run_s = time.perf_counter() - t0
    st = {k: eng.stats[k] - before[k] for k in before}
    measured_run = st["tokens_out"] / run_s
    measured_decode = st["tokens_out"] / st["decode_s"]
    calibration = {
        "model": "qwen2_0_5b", "batch": CALIBRATION_BATCH,
        "prompt_len": CALIBRATION_PROMPT, "new_tokens": CALIBRATION_NEW,
        "analytic_tokens_per_s": analytic,
        "measured_tokens_per_s_run": measured_run,
        "measured_decode_tokens_per_s": measured_decode,
        "ratio_analytic_over_run": analytic / measured_run,
        "ratio_analytic_over_decode": analytic / measured_decode,
        "note": "the JAX test's constant (0.41) is its engine's on a CPU; "
                "this ratio is the port's on this card, printed, not "
                "bounded"}
    del eng, bundle
    free(torch)

    # one ClusterScheduler run on the card's host, twice
    def cluster_run():
        sched = ClusterScheduler(make_policy("vnpu", mesh_2d(6, 6)),
                                 epoch_s=2.0,
                                 serving=ServingConfig(seed=SEED))
        t0 = time.perf_counter()
        m = sched.run(make_trace("mixed", seed=SEED,
                                 horizon_s=CLUSTER_HORIZON_S),
                      trace_name="mixed")
        ms = (time.perf_counter() - t0) * 1e3
        digest = ([dataclasses.astuple(x) for x in m.samples],
                  list(m.request_log), dict(m.tenant_iterations),
                  {f.name: getattr(m, f.name) for f in dataclasses.fields(m)
                   if f.name.startswith(("n_", "requests_", "tokens_"))})
        return m, digest, ms

    m, digest, cluster_ms = cluster_run()
    _, again, again_ms = cluster_run()
    checks["cluster_deterministic"] = digest == again
    checks["cluster_served"] = bool(m.requests_completed and m.n_admitted)
    emit({"phase": "tenants", "nvidia_smi": dev["smi"],
          "utilization": serving["utilization"],
          "utilization_after_release":
              serving["utilization_after_release"],
          "tenants": per_tenant,
          "quickstart": {"tenants": quick["tenants"],
                         "utilization": quick["utilization"],
                         "model": quick["model"], "dtype": quick["dtype"],
                         "loss": quick["loss"], "launches": quick_launches,
                         "expected_launches": expect},
          "calibration": calibration,
          "cluster": {"trace": "mixed", "policy": "vnpu", "seed": SEED,
                      "horizon_s": CLUSTER_HORIZON_S,
                      "host_ms": [cluster_ms, again_ms],
                      "deterministic": digest == again,
                      "summary": m.summary()},
          "printed": printed, "checks": checks,
          "phase_s": time.perf_counter() - t_phase})
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"tenants phase: {bad} failed")
    launches = {}
    for counts in [r["launches"] for r in runs] + [got]:
        for k in ("streamed_matmul", "flash_attention", "decode_attention"):
            launches[k] = launches.get(k, 0) + counts[k]
    return launches


# the fleet phase: two 8 x 8 pods of the fleet-serving trace (8 s of
# arrivals, run to 24 s) through the storm profile's fleet-scope faults of
# seed 117 (pod 1 lost at 12.6 s, its tenants evacuated over the switch; a
# switch brownout from 13.4 s for 1.5 s), under the serial executor and
# the parallel one of 2 forked workers
FLEET_SEED, FLEET_PODS, FLEET_SIDE = 117, 2, 8
FLEET_HORIZON_S, FLEET_END_S = 8.0, 24.0


def storm_scenarios(fleet, plan):
    """A fault plan's fleet-scope faults as ``fleet``'s scenarios (either
    package's fleet module): a pod loss as "pod-failure", a switch brownout
    as "switch-brownout"."""
    out = []
    for e in plan.fleet_events():
        if e.kind == "pod-fail":
            out.append(fleet.Scenario("pod-failure", e.t_s, e.pod_id))
        else:
            out.append(fleet.Scenario("switch-brownout", e.t_s, 0,
                                      duration_s=e.duration_s,
                                      factor=e.factor))
    return out


def fleet_storm_plan(chaos):
    """The fleet phase's fault plan, from either package's chaos module."""
    return chaos.make_fault_plan(FLEET_SIDE, FLEET_SIDE, FLEET_END_S,
                                 seed=FLEET_SEED, n_pods=FLEET_PODS)


def fleet_storm_run(fleet, chaos, workers: int):
    """The fleet phase's run under ``workers`` executors (1: serial), on
    the given fleet and chaos modules; returns its FleetMetrics."""
    plan = fleet_storm_plan(chaos)
    pods = [fleet.PodSpec(pod_id=i, rows=FLEET_SIDE, cols=FLEET_SIDE)
            for i in range(FLEET_PODS)]
    f = fleet.Fleet(pods, fleet.FleetConfig(seed=FLEET_SEED, window_s=2.0,
                                            record_requests=True))
    trace = fleet.fleet_trace(FLEET_PODS, seed=FLEET_SEED,
                              horizon_s=FLEET_HORIZON_S)
    return f.run(trace, storm_scenarios(fleet, plan), workers=workers,
                 end_s=FLEET_END_S)


def cluster_metrics_plain(m):
    """A ClusterMetrics as builtins, field for field: each EpochSample a
    tuple, the latency sketches their snapshots, the scoring passes' wall
    times (the host's clock) by count alone."""
    out = {}
    for f in dataclasses.fields(m):
        v = getattr(m, f.name)
        if f.name == "samples":
            v = [dataclasses.astuple(s) for s in v]
        elif f.name == "scoring_pass_s":
            v = len(v)
        elif hasattr(v, "snapshot"):
            v = v.snapshot()
        out[f.name] = v
    return out


def fleet_metrics_plain(m):
    """A FleetMetrics as builtins, every field but ``wall_s`` (the host's
    clock) and ``workers`` (the executor's): the pods' metrics, the
    router's and the switch's stats."""
    out = {}
    for f in dataclasses.fields(m):
        v = getattr(m, f.name)
        if f.name == "pods":
            v = [cluster_metrics_plain(p) for p in v]
        elif f.name in ("router", "switch"):
            v = dataclasses.asdict(v)
        elif f.name in ("wall_s", "workers"):
            continue
        out[f.name] = v
    return out


def phase_fleet():
    """The fleet and chaos planes (``repro_torch.fleet``,
    ``repro_torch.chaos``: numpy on the host, nothing on the card): one
    fleet run under a storm (``fleet_storm_run``) with the serial executor
    and with the parallel one; their ``pod_digests`` and every
    ``FleetMetrics`` field equal, the storm's faults applied (a brownout,
    a pod's tenants evacuated), and each run's host seconds."""
    from repro_torch import chaos, fleet
    runs, host_s = {}, {}
    for workers in (1, 2):
        t0 = time.perf_counter()
        runs[workers] = fleet_storm_run(fleet, chaos, workers)
        host_s[workers] = time.perf_counter() - t0
    serial, parallel = runs[1], runs[2]
    same_digests = serial.pod_digests() == parallel.pod_digests()
    same_metrics = fleet_metrics_plain(serial) == fleet_metrics_plain(parallel)
    summary = serial.serving_summary()
    emit({"phase": "fleet", "pods": FLEET_PODS, "mesh": [FLEET_SIDE] * 2,
          "seed": FLEET_SEED,
          "faults": [[e.t_s, e.kind, e.pod_id]
                     for e in fleet_storm_plan(chaos).fleet_events()],
          "windows": serial.n_windows, "workers": parallel.workers,
          "serial_host_s": host_s[1], "parallel_host_s": host_s[2],
          "pod_digests_equal": same_digests,
          "fleet_metrics_equal": same_metrics, "summary": summary})
    if not (same_digests and same_metrics):
        raise AssertionError("the parallel executor's fleet run differs from "
                             "the serial one's")
    if parallel.workers != 2 or not serial.requests_arrived or \
            serial.switch.n_brownouts != 1 or not summary["evacuated"]:
        raise AssertionError(f"the storm did not run as planned: {summary}")


def record_step(path, kind, cfg, batch, seq, seq_is, ms) -> None:
    """A measured step for the roofline phase: ``path``'s ``kind`` step
    ("prefill", "decode", "train") of ``cfg`` at ``batch`` x ``seq``
    (``seq_is`` says what seq holds), ``ms`` milliseconds."""
    STEP_TIMES[(path, kind)] = {"cfg": cfg, "batch": batch, "seq": seq,
                                "seq_is": seq_is, "ms": ms}


def phase_roofline(dev, expected):
    """Each step that the serve and train phases timed (``STEP_TIMES``: no
    run of its own) against the analytic roofline of
    ``repro_torch.roofline`` on this card's peaks, one chip: the step's
    FLOPs (``step_flops``, kernelized: the causal half of attention), bytes
    (``step_bytes``, fp32 moments) and model FLOPs (``model_flops_for``),
    the compute and memory times at the bf16 rate, the bound (the larger),
    the measured ms over it and the measured MFU (model FLOPs over the bf16
    peak times the measured seconds).  ``expected``: the (path, kind) pairs
    that must have been timed.  A measured time below its bound fails the
    phase: no card beats its roofline, so a count or a timing is wrong."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.roofline import step_terms
    peaks = dev["peaks"]
    rows = []
    for (path, kind), m in STEP_TIMES.items():
        shape = ShapeSpec(f"{path}/{kind}", m["seq"], m["batch"], kind)
        t = step_terms(m["cfg"], shape, peaks)
        bound_ms = t.step_time * 1e3
        rows.append({
            "path": path, "kind": kind, "model": m["cfg"].name,
            "n_layers": m["cfg"].n_layers, "batch": m["batch"],
            "seq": m["seq"], "seq_is": m["seq_is"],
            "step_flops": t.hlo_flops, "step_bytes": t.hlo_bytes,
            "model_flops": t.model_flops,
            "t_compute_ms": t.t_compute * 1e3,
            "t_memory_ms": t.t_memory * 1e3, "bound_ms": bound_ms,
            "bound_by": t.bottleneck, "measured_ms": m["ms"],
            "measured_over_bound": m["ms"] / bound_ms,
            "mfu": t.model_flops / (peaks["bfloat16"] * m["ms"] / 1e3)})
    emit({"phase": "roofline", "nvidia_smi": dev["smi"], "part": dev["part"],
          "chips": 1, "peaks": peaks, "paths": rows})
    missing = sorted(set(map(tuple, expected)) - set(STEP_TIMES))
    if missing:
        raise AssertionError(f"no measured step for {missing}")
    below = [(r["path"], r["kind"], r["measured_ms"], r["bound_ms"])
             for r in rows if r["measured_ms"] < r["bound_ms"]]
    if below:
        raise AssertionError(f"measured below the roofline: {below}")


def profile_train_step(torch, fn):
    """torch.profiler over one call of ``fn``: wall ms, the union of device
    kernel time, the device's idle share, the twelve kernels with the most
    device time, and the port's kernels' device time by name."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end)
                              for e in kern):
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    by_name = {}
    for e in kern:
        name = e.name.replace("void ", "").replace("(anonymous namespace)::",
                                                   "").split("(")[0][:70]
        by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    port = {}
    for k, v in by_name.items():
        hit = re.match(r"(matmul|flash|decode|ssd)_\w*kernel", k)
        if hit:
            port[hit.group(0)] = port.get(hit.group(0), 0.0) + v / 1e3
    # K1's grouped instantiations: the template flag G, the last, true
    grouped = sum(v for k, v in by_name.items()
                  if re.match(r"matmul_\w*kernel<.*, true>$", k)) / 1e3
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "device_idle_share": (1 - busy / wall_us) if kern else None,
            "kernels_seen": len(kern),
            "top_device_ms": {k: v / 1e3 for k, v in top},
            "port_kernels_ms": port, "k1_grouped_ms": grouped}


def decode_logits(torch, bundle, params, batch, device, steps=3):
    """The logits of a prefill of ``batch`` and of ``steps`` greedy decode
    steps after it (a cache of 16 more positions), on ``device``."""
    from repro_torch.serve import greedy, seed_decode_cache
    B, S = batch["tokens"].shape
    logits, caches = bundle.prefill(params, _to(batch, device))
    caches = seed_decode_cache(bundle, caches, B, S + 16, device)
    out = [logits.cpu()]
    for i in range(steps):
        tok = greedy(logits, bundle.cfg.vocab_size)
        logits, caches = bundle.decode(params, caches, tok, S + i)
        out.append(logits.cpu())
    return out


def serve_batch(model: str) -> int:
    """A served model's batch: its profile's max_batch, or the batch it
    borrows (``BORROWED_BATCH``)."""
    from repro_torch.serve.requests import SERVE_PROFILES
    if model in SERVE_PROFILES:
        return SERVE_PROFILES[model].max_batch
    return BORROWED_BATCH[model]


def free(torch):
    """Give the card's memory back between models."""
    gc.collect()
    torch.cuda.empty_cache()


def expected_launches(cfg, prefills: int, decode_steps: int,
                      prefill_tokens: int, batch: int):
    """Kernel launches of a served run: the matmuls of every forward (the
    projections of each layer and the unembedding), the prefill kernel of
    each layer per prefill, the decode kernel of each layer per step.  Of
    the matmuls, the MoE layers' fp32 router and grouped expert products
    by route (``"fp32"``, the grouped routes), from the capacity C of a
    prefill's ``prefill_tokens`` tokens and of a step's ``batch``.  Of the
    scans, their count by route (bf16: mamba2's P 64, N 128 on
    ``"wgmma"``, hymba's P 50, N 16 on the tensor-core ``"tc"``; none on
    the CUDA cores).  Returns (launches, matmul routes, scan routes)."""
    import torch
    from repro_torch.kernels.ssd_scan import ssd_route
    from repro_torch.kernels.streamed_matmul import grouped_route
    from repro_torch.models.moe import _capacity
    L, forwards = cfg.n_layers, prefills + decode_steps
    if cfg.family == "encdec":
        # a prefill: each encoder layer's q k v o, w1 w2 and its attention;
        # each decoder layer's q k v o, cross q k v o, w1 w2, its
        # self-attention and cross-attention; the unembedding.  A step:
        # each decoder layer's q k v o, cross q o, w1 w2 and its two decode
        # attentions (the self cache, the whole cross cache); the
        # unembedding
        E = cfg.n_enc_layers
        return {"streamed_matmul": (6 * E + 10 * L + 1) * prefills
                + (8 * L + 1) * decode_steps,
                "flash_attention": (E + 2 * L) * prefills,
                "decode_attention": 2 * L * decode_steps,
                "ssd_scan": 0}, {}, {}
    ssd_routes = {}
    if cfg.family in ("ssm", "hybrid"):
        route = {"ssm": "wgmma", "hybrid": "tc"}[cfg.family]
        if ssd_route(torch.bfloat16, cfg.ssm_heads, cfg.ssm_headdim,
                     cfg.ssm_state) != route:
            raise AssertionError(f"{cfg.name}'s scans would not take the "
                                 f"{route} kernel")
        ssd_routes[route] = L * prefills
    if cfg.family == "ssm":  # w_z, w_x, w_B, w_C, w_dt, w_out; the SSD scan
        return {"streamed_matmul": (6 * L + 1) * forwards,
                "flash_attention": 0, "decode_attention": 0,
                "ssd_scan": L * prefills}, {}, ssd_routes
    if cfg.family == "hybrid":  # q k v o, gate up down, and the SSD's six
        return {"streamed_matmul": (13 * L + 1) * forwards,
                "flash_attention": L * prefills,
                "decode_attention": L * decode_steps,
                "ssd_scan": L * prefills}, {}, ssd_routes
    n_moe, _ = cfg.moe_layer_split()
    # q k v o, gate up down; a MoE layer: q k v o, the router, the
    # three grouped expert products and the shared experts' gate up down
    launches = {"streamed_matmul": (7 * L + 4 * n_moe + 1) * forwards,
                "flash_attention": L * prefills,
                "decode_attention": L * decode_steps, "ssd_scan": 0}
    routes = {}
    if n_moe:
        routes = {"fp32": n_moe * forwards, "wgmma_grouped": 0,
                  "wgmma_grouped_decode": 0}
        for tokens, n in ((prefill_tokens, prefills), (batch, decode_steps)):
            C = _capacity(tokens, cfg.top_k, cfg.n_experts,
                          cfg.capacity_factor)
            routes[grouped_route(cfg.n_experts, C, cfg.moe_d_ff,
                                 cfg.d_model, torch.bfloat16)] += 3 * n_moe * n
    return launches, routes, ssd_routes


def phase_serve(torch, dev, model, lengths=None, max_seq=1024, path=None):
    """``lengths``: the prompts' lengths, each its own request in one batch
    of as many rows (by default the model's served batch of prompts of
    128-512 tokens); ``path``: the run's name in the summary (the
    model's)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssd_scan import SSD_ROUTE_LAUNCHES
    from repro_torch.kernels.streamed_matmul import ROUTE_LAUNCHES
    from repro_torch.models import build
    from repro_torch.serve import EngineConfig, ServeEngine

    cfg = get_config(model)
    bundle = build(cfg)
    params = bundle.init(SEED, device="cuda")
    # all logits of the run finite: a flag on the card that each prefill and
    # each decode step (inside the captured graph too) ands in place
    finite = torch.ones((), dtype=torch.bool, device="cuda")
    # matmuls in the run: bf16 of 64 rows or more, bf16 of fewer, and fp32
    # (the MoE router); those made while the decode step is captured are
    # counted apart, since every replay of the graph launches them again
    kinds = ("tall", "small", "fp32")
    seen, seen_captured = dict.fromkeys(kinds, 0), dict.fromkeys(kinds, 0)

    def counted_matmul(x, w, _matmul=ops.matmul):
        into = (seen_captured if torch.cuda.is_current_stream_capturing()
                else seen)
        into["fp32" if x.dtype == torch.float32 else
             "small" if x.shape[0] < 64 else "tall"] += 1
        return _matmul(x, w)

    def prefill(p, batch):
        logits, caches = bundle.prefill(p, batch)
        finite.logical_and_(torch.isfinite(logits).all())
        return logits, caches

    def decode(p, caches, token, pos):
        logits, caches = bundle.decode(p, caches, token, pos)
        finite.logical_and_(torch.isfinite(logits).all())
        return logits, caches

    watched = dataclasses.replace(bundle, prefill=prefill, decode=decode)
    rng = np.random.default_rng(SEED)
    if lengths is None:
        lengths = rng.integers(128, 513, serve_batch(model))
    ecfg = EngineConfig(batch_size=len(lengths), max_seq=max_seq)
    prompts = [rng.integers(0, cfg.vocab_size - 1, n).astype(np.int32)
               for n in lengths]

    plain_matmul, ops.matmul = ops.matmul, counted_matmul
    try:
        # the engine captures its decode step, after one eager warm-up step,
        # when it is made; a first batch of 2 tokens warms the prefill
        eng = ServeEngine(watched, params, ecfg, device="cuda")
        for pr in prompts:
            eng.submit(pr, max_new_tokens=2)
        eng.run()
        before, replays0 = dict(eng.stats), eng.decoder.replays
        reqs = [eng.submit(pr, max_new_tokens=32) for pr in prompts]
        seen.update(dict.fromkeys(kinds, 0))
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        eng.run()
        launches, routes = dict(ops.LAUNCHES), dict(ROUTE_LAUNCHES)
        ssd_routes = dict(SSD_ROUTE_LAUNCHES)
    finally:
        ops.matmul = plain_matmul
    st = {k: eng.stats[k] - before[k] for k in before}
    replays = eng.decoder.replays - replays0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    all_finite = bool(finite)
    graph_tokens = [r.out_tokens for r in reqs]
    eager = eager_decode(torch, bundle, params, prompts, ecfg, 32)
    breakdown = profile_steps(torch, bundle, params, prompts, ecfg,
                              eng.decoder)

    same_tokens = graph_tokens == eager["tokens"]
    S = int(max(lengths))  # the prompts left-padded to the longest
    record_step(path or model, "prefill", cfg, ecfg.batch_size,
                S + (cfg.frontend_seq if cfg.family == "vlm" else 0),
                "the padded prompt (after the vlm's patch rows)",
                1e3 * st["prefill_s"] / st["prefills"])
    # step i of n attends the S + i + 1 positions up to its own
    record_step(path or model, "decode", cfg, ecfg.batch_size,
                S + (st["decode_steps"] + 1) // 2,
                "the mean of the lengths the decode steps attended",
                1e3 * st["decode_s"] / st["decode_steps"])
    bound = (decode_bound(cfg, params, ecfg, int(max(lengths)), 32,
                          dev["peaks"])
             if cfg.family == "encdec" else None)
    expect, expect_routes, expect_ssd = expected_launches(
        cfg, st["prefills"], st["decode_steps"],
        ecfg.batch_size * max(lengths), ecfg.batch_size)
    made = {k: seen[k] + seen_captured[k] * replays for k in kinds}
    emit({"phase": "serve", "model": model, "path": path or model,
          "n_layers": cfg.n_layers, "sliding_window": cfg.sliding_window,
          "dtype": cfg.param_dtype, "batch": ecfg.batch_size,
          "max_seq": ecfg.max_seq, "prompt_lens": [int(n) for n in lengths],
          "new_tokens": 32, "nvidia_smi": dev["smi"],
          "prefill_s": st["prefill_s"], "decode_s": st["decode_s"],
          "decode_steps": st["decode_steps"], "graph_replays": replays,
          "decode_tokens_per_s": st["tokens_out"] / st["decode_s"],
          "decode_step_ms": 1e3 * st["decode_s"] / st["decode_steps"],
          "eager_decode_step_ms": eager["step_ms"],
          **({} if bound is None else {"decode_step_bound": bound}),
          "graph_tokens_equal_eager": same_tokens,
          "peak_mem_gb": peak_gb,
          "launches": launches, "expected_launches": expect,
          "expected_routes": expect_routes,
          "launches_per_replay": eng.decoder.launches[0],
          "matmul_routes": routes, "ssd_routes": ssd_routes,
          "expected_ssd_routes": expect_ssd,
          "matmuls_of_64_rows_or_more": made["tall"],
          "matmuls_of_fewer_rows": made["small"],
          "matmuls_fp32": made["fp32"],
          "matmuls_per_replay": seen_captured,
          "logits_finite": all_finite,
          "first_tokens": reqs[0].out_tokens[:8], "profile": breakdown})
    del eng, watched, params, bundle, eager
    free(torch)
    if any(len(r.out_tokens) != 32 for r in reqs):
        raise AssertionError("a request did not get its 32 tokens")
    if not all(0 <= t < cfg.vocab_size for r in reqs for t in r.out_tokens):
        raise AssertionError("a token outside the vocabulary")
    if not all_finite:
        raise AssertionError("non-finite logits")
    if replays != st["decode_steps"]:
        raise AssertionError(f"{replays} replays for {st['decode_steps']} "
                             "decode steps: not every step was the graph")
    if not same_tokens:
        raise AssertionError("the graph's tokens differ from those of the "
                             "same batch decoded eagerly")
    if launches != expect or not all(launches[k] for k, n in expect.items()
                                     if n):
        raise AssertionError(f"launch counts {launches} != {expect}")
    if not made["tall"] or routes["wgmma"] != made["tall"] or \
            seen_captured["tall"]:
        raise AssertionError(f"{made['tall']} bf16 matmuls of 64 rows or "
                             f"more, routes {routes}: not all on the wgmma "
                             "kernel")
    if not made["small"] or routes["wgmma_decode"] != made["small"] or \
            routes["wmma"]:
        raise AssertionError(f"{made['small']} bf16 matmuls of fewer than 64 "
                             f"rows, routes {routes}: not all on the wgmma "
                             "decode kernel")
    # the fp32 route takes the MoE routers and nothing else; the grouped
    # routes the expert products, on the route of their capacity
    want = {"fp32": 0, "wgmma_grouped": 0, "wgmma_grouped_decode": 0,
            "fp32_grouped": 0, **expect_routes}
    if {k: routes[k] for k in want} != want or made["fp32"] != want["fp32"]:
        raise AssertionError(f"routes {routes} (fp32 matmuls {made['fp32']})"
                             f" != the expected {want}: a router or an expert "
                             "product left its kernel")
    grouped = {k: routes[k] for k in want if "grouped" in k}
    if ssd_routes != {**dict.fromkeys(ssd_routes, 0), **expect_ssd}:
        raise AssertionError(f"{launches['ssd_scan']} scans, routes "
                             f"{ssd_routes}: not all on the expected scan "
                             f"kernel {expect_ssd}")
    if any(grouped.values()):  # the summary's grouped launches
        launches = dict(launches, grouped=sum(grouped.values()))
    return launches


def decode_bound(cfg, params, ecfg, S, new, peaks):
    """An encoder-decoder's least decode step time, the bytes a step reads
    over the card's rate, as the mean over the run's ``new`` - 1 steps
    from position S: each input read once, the decoder's weights but the
    cross k/v products (run by prefill alone), the final norm, the
    unembedding, a row of the token and position tables per row of the
    batch, the whole cross cache, and the self cache up to each step's
    position."""
    from repro_torch import convert
    flat = convert.flatten({k: params[k] for k in ("dec_stack", "final_norm",
                                                   "lm_head")})
    weights = sum(t.numel() * t.element_size() for n, t in flat.items()
                  if not n.endswith(("cross/wk", "cross/wv")))
    es = params["embed"].element_size()
    tables = (ecfg.batch_size + 1) * cfg.d_model * es
    per_slot = 2 * cfg.n_layers * ecfg.batch_size * cfg.n_kv_heads \
        * cfg.head_dim_ * es  # K and V of one position, every layer
    cross = per_slot * cfg.enc_seq
    own = per_slot * statistics.mean(min(S + i + 1, ecfg.max_seq)
                                     for i in range(new - 1))
    total = weights + tables + cross + own
    return {"bytes": total, "weight_bytes": weights,
            "cross_cache_bytes": cross, "self_cache_bytes_mean": own,
            "ms": total / peaks["bytes"] * 1e3, "by": "bytes"}


def eager_decode(torch, bundle, params, prompts, ecfg, new):
    """The engine's batch decoded eagerly through ``bundle.decode``, as the
    engine would without its graph: every request's ``new`` tokens, and
    the wall ms per decode step, each ending in a copy of the tokens to the
    host as the engine's steps do."""
    from repro_torch.serve import greedy, pad_batch, seed_decode_cache
    batch, S = pad_batch(bundle.cfg, prompts, ecfg.batch_size, "cuda")
    V = bundle.cfg.vocab_size
    with torch.inference_mode():
        logits, caches = bundle.prefill(params, batch)
        caches = seed_decode_cache(bundle, caches, ecfg.batch_size,
                                   ecfg.max_seq, "cuda")
        tok = greedy(logits, V)
        out = [tok.cpu()]
        t0 = time.perf_counter()
        for i in range(new - 1):
            logits, caches = bundle.decode(params, caches, tok, S + i)
            tok = greedy(logits, V)
            out.append(tok.cpu())
        step_ms = (time.perf_counter() - t0) / (new - 1) * 1e3
    tokens = torch.cat(out, dim=1).tolist()[:len(prompts)]
    return {"tokens": tokens, "step_ms": step_ms}


def profile_steps(torch, bundle, params, prompts, ecfg, decoder, n_decode=4):
    """torch.profiler over one prefill, ``n_decode`` eager decode steps and
    ``n_decode`` replays of the engine's captured step (``decoder``), all
    of the served batch: host wall time, the union of device kernel time,
    the idle share of the device, and the kernels that take the most device
    time.  Then, unprofiled, eager steps and replays in turn (twice each):
    the host's time to enqueue a step and the wall time until the card has
    run it.  Last, a check that a replay never waits on the card."""
    from repro_torch.serve import greedy, pad_batch, seed_decode_cache
    from torch.profiler import ProfilerActivity, profile

    batch, S = pad_batch(bundle.cfg, prompts, ecfg.batch_size, "cuda")
    V = bundle.cfg.vocab_size
    state = {}

    def prefill():
        state["logits"], state["caches"] = bundle.prefill(params, batch)

    def eager(n):
        tok = greedy(state["logits"], V)
        for i in range(n):
            logits, _ = bundle.decode(params, state["decode_caches"], tok,
                                      S + i)
            tok = greedy(logits, V)

    def replay(n):
        for _ in range(n):
            decoder()

    def start_graph():
        decoder.start(state["caches"], greedy(state["logits"], V), S)

    def measure(fn, steps):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        kern = [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        busy, end = 0.0, float("-inf")
        for start, stop in sorted((e.time_range.start, e.time_range.end)
                                  for e in kern):
            busy += max(0.0, stop - max(start, end))
            end = max(end, stop)
        by_name = {}
        for e in kern:
            name = e.name.replace("void ", "").replace("(anonymous namespace)::", "")
            name = name.split("(")[0][:70]
            by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us()
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        port = {k: v / steps / 1e3 for k, v in by_name.items()
                if re.match(r"(matmul|flash|decode|ssd)_\w*kernel", k)}
        return {"steps": steps, "wall_ms_per_step": wall_us / steps / 1e3,
                "device_busy_ms_per_step": busy / steps / 1e3,
                "device_idle_share": (1 - busy / wall_us) if kern else None,
                "kernels_seen": len(kern),
                "top_device_ms_per_step": {k: v / steps / 1e3 for k, v in top},
                "port_kernels_ms_per_step": port}

    def unprofiled(step, n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(n)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        return {"steps": n, "host_ms_per_step": (t1 - t0) / n * 1e3,
                "wall_ms_per_step": (t2 - t0) / n * 1e3}

    with torch.inference_mode():
        prefill()  # warm
        out = {"prefill": measure(prefill, 1)}
        start_graph()
        state["decode_caches"] = seed_decode_cache(
            bundle, state["caches"], ecfg.batch_size, ecfg.max_seq, "cuda")
        eager(1)  # warm
        out["decode_eager"] = measure(lambda: eager(n_decode), n_decode)
        out["decode_graph"] = measure(lambda: replay(n_decode), n_decode)
        if out["decode_graph"]["kernels_seen"]:
            out["decode_graph"]["device_time_from"] = "torch.profiler"
        else:  # the profiler did not see the replayed graph's kernels
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            a.record()
            replay(n_decode)
            b.record()
            torch.cuda.synchronize()
            out["decode_graph"]["device_busy_ms_per_step"] = \
                a.elapsed_time(b) / n_decode
            out["decode_graph"]["device_time_from"] = (
                "CUDA events around the replays: torch.profiler showed no "
                "kernel of the replayed graph")
        # Unprofiled, as served but with no copy of the tokens to the host,
        # eager steps and replays in turn: where the host takes longer to
        # enqueue a step than the card to run it, the host bounds the step.
        runs = {"eager": [], "graph": []}
        for _ in range(2):
            runs["eager"].append(unprofiled(eager, 4 * n_decode))
            start_graph()
            runs["graph"].append(unprofiled(replay, 4 * n_decode))
        out["decode_unprofiled"] = runs
        # A host wait inside a replay (a copy from host memory, an .item())
        # would stop the host from running ahead of the card: one replay
        # with PyTorch's sync check raising on any such wait.
        start_graph()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            decoder()
        except RuntimeError as e:
            raise AssertionError(f"a replay of the decode step waits on the "
                                 f"card: {e}")
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        out["replay_host_syncs"] = 0
    return out


if __name__ == "__main__":
    sys.exit(main())
