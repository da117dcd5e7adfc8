"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_smoke.py

It builds the nine CUDA kernels from ``src/repro_torch/csrc``, holds
each against its plain PyTorch version on the card (fp32 and bf16; the
int8 kernel bit for bit, both its entries: the conv entry as the int8
executor launches it, fp32 in with the node's scale, epilogue and
addend, and on int8 codes, and the stacked GEMM, which must give the
conv entry's accumulator on the same codes) at the shapes the main
paths give it, and drives the paths through the entry points a user
calls:

- the paper's conv rows through ``repro_torch.conv2d``: the profiled
  rows (tables 3-5), resnet50's two 3x3 layers at batch 8 on the
  Winograd kernel (F(4,3) and F(2,3)), and forced ``algorithm="direct"``
  rows (t3_A, t4_B, t5_B and a stride-2 layer at 224x224);
- ``resnet_like`` served by ``CnnServeEngine`` at 32x32 (buckets 1 and
  4) and 224x224 (bucket 1) in fp32, where no conv node may run on a
  library executor;
- ``resnet_like`` calibrated through ``GraphPlan.warmup(calibrate=...)``
  and served in int8 (``precision=QuantPolicy()``) at 32x32, against the
  CPU int8 engine and against the fp32 engine's 0.05 accuracy bound;
- ``resnet_like`` served by ``AsyncServeFrontend`` on the card (the
  last phase, under the untuned plan store) at
  32x32 (buckets 1 and 4), 16x16 (1 and 2) and 224x224 (1 and 4),
  pipeline depth 2: 300 requests of 1-4 images from seed 0, submitted
  in bursts of 8, each followed by ``poll()``, then ``run()``.  Every
  request must be served with no deadline miss, every request's
  compute and queue time within its total, every stage's p50 <= p95 <=
  p99, the outputs within 3e-4 of the CPU engine's abs max, the kernels
  in a ``torch.profiler`` trace (the card alone) equal to what each
  batch's bucket plan predicts with no conv node on a library executor,
  and every input copy a pinned one (kineto's ``Pinned -> Device``); the
  share of its batches dispatched with a predecessor in flight whose
  input copy intersects a kernel of an earlier batch on the card is
  printed beside each geometry's device compute and the host's time
  from a batch's first kernel to the next copy.  The overlap itself is
  held on ``squeezenet_like`` at 224x224 in batches of 4, whose device
  compute outlasts the host's path to the next copy: at least half of
  its batches dispatched with a predecessor in flight must copy their
  input while a kernel of an earlier batch runs.  The mixed traffic is
  then served untraced (images/s and
  every stage's percentiles per geometry printed, and the same stream
  through ``CnnServeEngine.run()``), the int8 frontend at 32x32 must
  serve int8 and equal the int8 engine within its bound, the
  ``ShardedServeDispatcher`` over ``make_serve_mesh()`` (one card,
  ``DIST_SMOKE``, ``tiny_cnn``) must report one device and equal a plain
  ``AsyncServeFrontend`` bit for bit, and ``python -m
  repro_torch.launch.serve --cnn-dist --requests 16`` must exit 0 and
  print its stats;
- ``qwen2-1.5b``, ``qwen3-14b``, ``mamba2-1.3b``,
  ``deepseek-v2-lite-16b`` and ``deepseek-moe-16b`` served by the LM
  ``ServeEngine`` at full width and depth in bf16 (seed-0 params made on
  the card), ``jamba-v0.1-52b`` at full width and 16 of 32 layers, one
  model on the card at a time: 8 requests on 4 slots, prompts of 512,
  16 new tokens, where every GQA prefill attention runs
  ``flash_attention`` (MLA attends through the plain versions, as the
  reference does) and every Mamba2 prefill conv ``conv1d_tap``; the MoE
  models' routing statistics of a prefill wave are printed, and two
  eager calls of an MoE layer must give the same bits;
- the archs fed embeddings, ``qwen2-vl-2b`` and ``musicgen-large``
  (MHA at head dim 64), at full width and depth in bf16: their prefill
  and decode programs (``embeds_programs``: ``lm.prefill`` and
  ``lm.decode_step`` as CUDA graphs over static embeddings, M-RoPE
  positions and offset) over two waves of 4 x 512 seeded embeddings and
  15 teacher-forced decode steps each, qwen2-vl's prompts an image grid
  (``mrope_grid``) and its decode positions off the cache offset; every
  call's logits bit-equal to eager calls, ``flash_attention`` once a
  layer a prefill wave.  Then every LM cut to 4 layers in fp32 (the
  deepseek pair: one dense layer and three MoE layers; jamba: one
  8-layer period with all 16 experts), card against the CPU, the CPU
  side a layer at a time (``layerwise_cpu_logits``), where each MoE
  call's top-K expert sets and kept tokens are compared first, by (MoE
  layer, step): a token may route differently only where its K-th and
  (K+1)-th router probabilities on the CPU are within 1e-5;
- training (``training_phase``): ``qwen2-1.5b`` at full width and depth
  in bf16 through ``launch.steps.make_train_step`` and
  ``SyntheticLMData`` (5 steps of 8x512 tokens, its config's grad_accum
  4, full remat; step ms, tokens/s, 6*N*tokens over the step at 989
  TFLOP/s, peak memory, losses; the same batch at grad_accum 1 timed
  beside), where no hand-written kernel may launch (counters, and
  ``KERNEL_SYMBOLS`` in a ``torch.profiler`` trace of a step); the model
  cut to 2 layers at full width in fp32, 3 steps on the card and on the
  CPU from the same params and batches (loss and grad_norm within 1e-4
  relative, each leaf's update within 1e-2 relative in L2); the cut in
  bf16 through ``Trainer`` with async checkpoints, resumed by a second
  trainer (the restored state bit-equal to the saved one, the resumed
  step-3 loss within 1e-3 of an uninterrupted step 3), the step-3
  checkpoint served by ``ServeEngine`` through ``params_from_numpy``
  (``flash_attention`` launched once a layer a wave, tokens equal to an
  engine's on the trainer's in-memory params); and ``python -m
  repro_torch.launch.train --smoke`` exiting 0 on the card;
- training on a mesh (``mesh_training_phase``): a world-size-1 NCCL
  group on a ``FileStore`` and ``make_debug_mesh()``, (1, 1) ("data",
  "model"); one fp32 step of the 2-layer cut on the mesh against the
  same step unsharded (loss and grad_norm within 1e-5 relative, each
  leaf's update within 1e-2 in L2); ``qwen2-1.5b`` at full size in bf16,
  three steps through ``Trainer(mesh=...)`` beside three unsharded
  ones (step ms, tokens/s, peak memory; kernels, device busy and idle
  share of a traced mesh step, where no hand-written kernel may run);
  ``compressed_psum`` over the group on a (4, 1,048,576) fp32 tensor,
  bit-equal to the codec; the mesh trainer's 2-layer bf16 checkpoint
  restored with and without the mesh bit-equal to the saved state and
  served by ``ServeEngine`` (``flash_attention`` launched once a layer a
  wave, tokens equal to the in-memory params'); ``python -m
  repro_torch.launch.train --smoke --mesh debug`` exiting 0 and
  ``--mesh pod`` exiting non-zero with the 256-rank error.  The group is
  destroyed at the phase's end;
- the analysis (``analysis_phase``): on a world-size-1 NCCL group's
  (1, 1) mesh, qwen2-1.5b's training step (8x512 tokens, grad_accum 4,
  full remat, bf16) counted by ``launch/dryrun.py`` on meta and by its
  ``CostCounter`` around the real step on the card (FLOPs per rank
  within 1%, collective counts equal; the counted peak and
  ``torch.cuda.max_memory_allocated`` printed, not gated); the step's
  roofline with ``roofline.HW`` (NVIDIA's published H100 SXM peaks)
  beside the measured step ms (the largest term over the measured step
  at most 1.05); one prefill wave (4x512) counted on meta and on the
  card, where ``flash_attention`` launches once a layer (its formula's
  FLOPs equal on both); and ``python -m repro_torch.launch.dryrun`` on
  three cells of the pod mesh (qwen2-1.5b train_4k, deepseek-moe-16b
  decode_32k, mamba2-1.3b long_500k) under this machine's torch, each
  exiting 0 with status ``OK``.

It prints the launch geometry of the seven tensor-core kernels
(``conv1x1_gemm``, ``cuconv_fused``, ``winograd_fused``,
``direct_conv``, ``stage1_tap_gemm``, ``int8_gemm``: block tile,
splits, blocks; ``flash_attention``: grid and shared memory) at their
main-path shapes,
and fails where one of the fourteen paper shapes on the conv kernels
(t3_A-C, t4_A-B, t5_A-B, resnet50's two 3x3 rows, the forced direct
t3_A, t4_B and t5_B, the forced two-stage t4_A and t5_A), or
``stage2_tap_sum`` at t4_A or t5_A, launches under one wave of 132
blocks, or where an ``int8_gemm`` block owns more than one output tile;
the build phase prints every kernel's registers and spills, and fails
where ``direct_conv``, ``cuconv_stage1`` or ``int8_gemm`` spills.  Both
stage-1 entries (the stacked views and the padded input) must give the
same bits.  The served programs run as CUDA graphs
(``serve/graphs.py``): every CNN bucket's replay must equal its eager
program bit for bit, each served batch must be one replay, a warm
engine may resolve no plan, and the LM engines' tokens (first wave and
first decode step eager, the rest replayed) must equal eager
``lm.prefill``/``lm.decode_step`` tokens; the LM trace reports device
time and idle share of replayed prefill and decode steps (busy time is
the union of the kernel and memcpy records' intervals, never an
annotation span such as the ``ProfilerStep`` over them; an idle share
outside [0, 1] fails), and the LM phase
the peak device memory of the served run and of the eager one.  Each
served run (CNN and LM) runs under ``torch.profiler``, whose trace
counts by CUDA symbol the kernels that ran on the card, graph replays
included: they must equal the plans, as must those of one replayed
batch per 32x32 bucket and of a replayed LM prefill wave (its decode
steps run none).  The launch counters (replays add what their capture
recorded) are kept beside as bookkeeping.  One warm 32x32 batch per bucket, fp32 and int8,
runs under ``torch.profiler``: the int8 batch may launch no more CUDA kernels
than the fp32 one (an int8 node is one launch).  It then times served
latency over windows of a few
hundred requests per engine, times each kernel (CUDA graph replays
between CUDA events, so host dispatch is left out; eager times, the
host's time per call and an empty kernel's time in the same harness,
the launch floor, are kept beside) with its plain version, one
library call and its bound (work over the rate of the units the kernel
runs on: 495/3 TFLOP/s for a 3xTF32 product, the fp32 products of the
six tensor-core kernels; 989 for bf16; 1,979 TOP/s for int8; 67 TFLOP/s
for fp32 outside the tensor cores, ``stage2_tap_sum``'s adds and
``conv1d_tap``; the int8 conv entry's library call is ``torch._int_mm``
on its patch matrix, made outside the timed call, and the eager
composition it replaced is timed beside it), and checks that every
feasible launch config of the fused, direct, two-stage and int8
executors launches one geometry.

Two phases then run under plan stores of their own
(``build/chip_smoke_cache/tuned`` and ``.../models``; the untuned
phases' store is restored after each):

- measured autotuning: ``plan(spec, tune="algo")`` races every capable
  executor (``autotune.device_ms``, the harness the kernel times above
  come from; TF32 off) on nine rows, the seven profiled rows and
  resnet50's two 3x3 rows at batch 8, printing each candidate's device
  ms, the winner and the winner over cuDNN (``lax``).  It fails where a
  hand-written executor that supports a row was not timed or failed (a
  failed kernel ends the sweep with its error), where the winner is not
  the fastest timing or is off ``F.conv2d`` (3e-4, 2e-3 on F(4,3)), or
  where the replay after ``autotune.clear_cache()`` measures anything.
  ``plan(spec, tune="full")`` on r50_56x56x64 (Winograd pinned where
  the race gave the row to another executor) then races Winograd's
  launch configs, the one executor whose configs change the launch: it
  fails unless F(2,3) and F(4,3) were both timed, the plan takes the
  fastest config, its output is within 2e-3 of ``F.conv2d`` and its
  replay measures nothing.  Then ``resnet_like`` 224x224 (bucket 1) is
  served after ``warmup(tune="full")`` (each node's executor, config
  and fusion verdict printed): its trace must count its tuned plans'
  kernels, its replay equal its eager program, its outputs match the
  CPU engine and the untuned engine within 3e-4 of their abs max, and a
  second engine over the same store must warm with no measurement and
  no plan() resolution.  Last, a warm ``squeezenet_like`` 224x224
  engine is tuned with ``warmup(tune="full")``: at least one node must
  change executor and the bucket's CUDA graph be captured again, and
  the served run is held to the tuned plans, the replay and the CPU
  engine as above.  Served latency of the tuned and untuned engines is
  printed for both models, with no gate on speed;
- the other CNN models: ``squeezenet_like``, ``mobilenet_like`` and
  ``fire_like`` at 224x224 and ``tiny_cnn`` at 32x32 (buckets 1 and 4,
  seed-0 params) served by ``CnnServeEngine``: each trace must count its
  plans' kernels, each replay equal its eager program, the outputs
  match the CPU engine within 3e-4 of their abs max, and only the
  grouped conv nodes (mobilenet's ``dw1`` and ``dw2``) may plan onto a
  library executor.

It prints one ``{"kernels": [...]}`` line, the card's name and power
limit, and as its last line the device record.
Details go to ``chiprun_out/chip_smoke.json``.  Any failed phase exits
non-zero.
Without CUDA, or without the repository beside it, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# the card's published peaks (H100 SXM data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12          # float32 outside the tensor cores
# fp32 products on the TF32 tensor cores in the 3xTF32 split: three TF32
# products each, at a third of 495 TFLOP/s (conv1x1_gemm, cuconv_fused,
# winograd_fused, direct_conv, stage1_tap_gemm, flash_attention)
TF32X3_FLOP_PER_S = 495e12 / 3
INT8_OP_PER_S = 1979e12          # int8 tensor cores, dense
BF16_FLOP_PER_S = 989e12         # bf16 tensor cores, dense

FP32_TOL, BF16_TOL = 2e-5, 3e-2  # kernel vs plain: x * max(1, max|plain|)
# Winograd sums over another domain than its plain version: the
# reference's own Winograd bounds (tests/test_winograd.py:43,73)
WINOGRAD_FP32_TOL = {2: 1e-4, 4: 2e-3}
SERVE_TOL = 3e-4                 # card vs CPU engine: x * max|cpu output|
INT8_ACCURACY = 0.05             # int8 vs fp32 (quant/accuracy.py)

SMS = 132                        # the H100's streaming multiprocessors
WINDOWS, WINDOW_REQUESTS = 3, 300   # served-latency windows per engine
# the async front end's traffic: requests of 1-4 images over three
# geometries, submitted in bursts, each burst followed by a poll()
FRONTEND_REQUESTS, FRONTEND_BURST = 300, 8
# the stream the overlap of copies and compute is held on:
# squeezenet_like at 224x224 in batches of 4, requests of 4 images
OVERLAP_BUCKET, OVERLAP_REQUESTS = 4, 48

# resnet50's 3x3 layers of configs/cnn_paper.py NETWORKS, (H=W, K, M, C)
# at batch 8, with the launch config the JAX package's planner picks for
# them at backend "tpu" (tests/test_torch_graph.py pins both)
WINOGRAD_ROWS = {"r50_56x56x64": ((56, 3, 64, 64),
                                  {"m": 4, "tt": 256, "tm": 64, "tc": 64}),
                 "r50_28x28x128": ((28, 3, 128, 128),
                                   {"m": 2, "tt": 256, "tm": 128,
                                    "tc": 128})}
# the profiled 1x1 rows, on conv1x1_gemm
GEMM_ROWS = ("t3_A", "t3_B", "t3_C")
# the profiled 3x3 and 5x5 rows, on cuconv_fused
FUSED_ROWS = ("t4_A", "t4_B", "t5_A", "t5_B")
# forced algorithm="direct" rows: three profiled rows and resnet_like's
# b2c1 geometry at 224x224 (stride 2)
DIRECT_ROWS = ("t3_A", "t4_B", "t5_B")
DIRECT_STRIDED = ("b2c1@224", (1, 112, 112, 16), (3, 3, 16, 32), 2)
# forced algorithm="cuconv_two_stage_pallas" rows
TWO_STAGE_ROWS = ("t4_A", "t5_A")
# stage 2's time over its two main-path shapes before its redesign (the
# grid-stride pass, as this script timed it on an NVIDIA H100 80GB HBM3
# at 700 W), printed beside the redesigned kernel's
STAGE2_EARLIER_MS = 0.003832
# the kernels whose ptxas report may show no spill
NO_SPILL = ("direct_conv", "cuconv_stage1", "int8_gemm")

# the LM serving path (configs/archs.py), served at full width and, but
# where LM_SERVED_LAYERS cuts it, full depth
LM_ARCHS = ("qwen2-1.5b", "qwen3-14b", "mamba2-1.3b",
            "deepseek-v2-lite-16b", "deepseek-moe-16b", "jamba-v0.1-52b")
# the archs fed embeddings (their front ends are stubs: no patch encoder,
# no EnCodec), served through lm.prefill/decode_step as CUDA graphs at
# full width and depth; qwen2-vl-2b's prompts are an M-RoPE image grid
LM_EMBED_ARCHS = ("qwen2-vl-2b", "musicgen-large")
# each prompt of LM_PROMPT: text, a side x side image, text (mrope_grid)
LM_GRID = (16, 16, 240)
# depth cuts of the served archs: jamba's 32 layers (95.9 GiB in bf16)
# exceed the card, so it serves two repeats of its 8-layer period
LM_SERVED_LAYERS = {"jamba-v0.1-52b": 16}
LM_REQUESTS, LM_SLOTS, LM_PROMPT, LM_NEW, LM_MAX_LEN = 8, 4, 512, 16, 1024
# card vs CPU in fp32: depth cut for the CPU's sake, fp32 cache; an arch
# whose layer period is longer than LM_CPU_LAYERS (stack_plan refuses a
# part of it; jamba's is 8) is cut to one period, all its experts kept
# (the CPU side runs one layer at a time: layerwise_cpu_logits)
LM_CPU_LAYERS, LM_CPU_BATCH, LM_CPU_PROMPT, LM_CPU_STEPS = 4, 2, 64, 4
LM_CPU_GRID = (8, 6, 20)         # qwen2-vl-2b's grid in LM_CPU_PROMPT
LM_CPU_TOL = 1e-3                # x * max|CPU logits|
# card vs CPU: a token's top-K experts may differ only where its K-th and
# (K+1)-th router probabilities on the CPU are this close
ROUTE_FLIP_GAP = 1e-5
LM_KERNELS = ("flash_attention", "conv1d_tap")
LM_TRACE_STEPS = 4               # decode steps under the profiler
# a gated trace held open this long before and after its region: the
# card's timestamps, mapped onto the host's clock, can land milliseconds
# before the host's, and a record that lands outside the active step is
# dropped (a replayed batch right after the step was lost whole, and
# once one prefill wave of a served run)
TRACE_PAD_S = 0.25
# launches in a gated trace's warm-up step, whose records are dropped: a
# trace loses its first device records, more of them the more CUDA
# graphs the process has made (a probe on the card: 1 of 12 kernels
# after 105 timing graphs, 4 after 400; 100 launches absorbed the loss)
TRACE_WARM_LAUNCHES = 2000
# each launch counter's CUDA kernel (csrc/*.cu), by which a profiler
# trace counts what ran on the card, graph replays included
KERNEL_SYMBOLS = {"cuconv_fused": "cuconv_fused_kernel",
                  "conv1x1_gemm": "conv1x1_tc_kernel",
                  "stage1_tap_gemm": "stage1_tc_kernel",
                  "stage2_tap_sum": "stage2_tap_sum_kernel",
                  "winograd_fused": "winograd_fused_kernel",
                  "direct_conv": "direct_conv_tc_kernel",
                  "int8_gemm": "int8_gemm_kernel",
                  "flash_attention": "flash_attention_kernel",
                  "conv1d_tap": "conv1d_tap_kernel"}

# the training path (launch/steps.py, train/): qwen2-1.5b at full width
# and depth in bf16, its config's grad_accum, full remat
TRAIN_ARCH = "qwen2-1.5b"
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 5, 8, 512
TRAIN_TIMED_FROM = 1                 # medians over steps 2-5
# card vs CPU: 2 layers at full width in fp32, TF32 off
TRAIN_CUT_LAYERS, TRAIN_CPU_STEPS, TRAIN_CPU_ACCUM = 2, 3, 2
TRAIN_CPU_BATCH, TRAIN_CPU_SEQ, TRAIN_CPU_LR = 2, 128, 3e-3
TRAIN_CPU_TOL = 1e-4                 # loss and grad_norm, relative
TRAIN_UPDATE_TOL = 1e-2              # each leaf's p_3 - p_0, relative L2
# the trainer, checkpoints, resume and serving: the 2-layer cut in bf16
TRAIN_RESUME_TOL = 1e-3              # resumed step-3 loss, relative
TRAIN_SERVE_REQUESTS, TRAIN_SERVE_PROMPT, TRAIN_SERVE_NEW = 4, 128, 8
# training on a mesh: a world-size-1 NCCL group, make_debug_mesh() (1, 1)
MESH_STEPS = 3                       # full size, bf16; medians of 2-3
MESH_TOL = 1e-5                      # loss and grad_norm, relative
MESH_PSUM_SHAPE = (4, 1 << 20)       # compressed_psum's fp32 input
# the analysis: meta against the card, and the dry-run CLI's cells
ANALYSIS_FLOP_TOL = 0.01             # FLOPs per rank, relative
ANALYSIS_SHARE_MAX = 1.05            # largest roofline term / measured step
DRYRUN_CELLS = (("qwen2-1.5b", "train_4k"), ("deepseek-moe-16b",
                                             "decode_32k"),
                ("mamba2-1.3b", "long_500k"))

_PHASE = {"name": None, "t0": 0.0, "times": {}}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def phase(name) -> None:
    """Close the running phase (printing its wall time) and open
    ``name`` (None closes the last one)."""
    now = time.perf_counter()
    if _PHASE["name"] is not None:
        secs = now - _PHASE["t0"]
        _PHASE["times"][_PHASE["name"]] = secs
        print(f"   ({_PHASE['name']}: {secs:.1f} s)", flush=True)
    _PHASE["name"], _PHASE["t0"] = name, now
    if name is not None:
        print(f"== {name}", flush=True)


def traced_launches(prof) -> dict:
    """The launch counters' kernels that ran in a ``torch.profiler``
    trace, by counter name (kernels in graph replays too); zeros left
    out."""
    import re
    import torch
    counts = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for k, sym in KERNEL_SYMBOLS.items():
            if re.search(rf"\b{sym}\b", e.key):
                counts[k] = counts.get(k, 0) + e.count
    return counts


def device_records(prof) -> list:
    """The card's kernel, memcpy and memset records in a
    ``torch.profiler`` trace as ``(name, start_us, end_us)``, sorted by
    start.  Annotation spans (the ``ProfilerStep#`` step, any
    ``record_function`` range) are not records: they span the records
    inside them, so summing them with the records counted those twice."""
    import torch
    out = []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if (getattr(e, "is_user_annotation", False)
                or e.name.startswith("ProfilerStep")):
            continue
        out.append((e.name, float(e.time_range.start),
                    float(e.time_range.end)))
    out.sort(key=lambda r: r[1])
    return out


def busy_ms(records) -> float:
    """The length of the union of the records' intervals, ms (records
    sorted by start): records of two streams that overlap count once."""
    total, end = 0.0, None
    for _, t0, t1 in records:
        if end is None or t0 >= end:
            total, end = total + (t1 - t0), t1
        elif t1 > end:
            total, end = total + (t1 - end), t1
    return total / 1e3


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def ptxas_entries(log: str) -> list:
    """``-Xptxas -v`` per kernel: entry name, registers, spill bytes."""
    import re
    out = []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            out.append({"entry": m.group(1), "registers": None,
                        "spill_stores": None, "spill_loads": None})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and out:
            out[-1]["spill_stores"], out[-1]["spill_loads"] = map(
                int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and out:
            out[-1]["registers"] = int(m.group(1))
    return out


def mrope_grid(text: int, side: int, after: int):
    """Qwen2-VL's M-RoPE positions (arXiv:2409.12191 §2.1) of a prompt of
    ``text`` text tokens, a ``side`` x ``side`` image, then ``after``
    text tokens: (3, S) int32 rows (t, h, w), and the position the next
    token takes.  A text token at i is (i, i, i); the image's patch
    (r, c) is (t0, t0 + r, t0 + c) at t0 = ``text``; the text after it
    resumes one past the image's largest position."""
    import numpy as np
    ids = [(i, i, i) for i in range(text)]
    ids += [(text, text + r, text + c) for r in range(side)
            for c in range(side)]
    nxt = text + side
    ids += [(i, i, i) for i in range(nxt, nxt + after)]
    return np.array(ids, np.int32).T.copy(), nxt + after


class RoutingLog:
    """While entered, a stand-in for ``moe.moe_fwd`` that records each
    call's routing under the key (k, step): the router's probs, the
    top-K expert set of every token and the tokens each expert keeps
    (``moe.dispatch``, the routing ``moe_fwd`` itself runs).  The caller
    sets ``step`` before each call of a step.  The k-th MoE call of a
    step is the k-th MoE layer, whether the steps run layer by layer or
    the layers step by step, so two callers' records line up by key."""

    def __init__(self):
        self.step, self.calls = None, {}

    def __enter__(self):
        from repro_torch.nn import moe
        self._moe, self._fwd = moe, moe.moe_fwd
        moe.moe_fwd = self._record
        return self

    def __exit__(self, *exc):
        self._moe.moe_fwd = self._fwd

    def _record(self, p, cfg, x, dropless=False, n_groups=1):
        import torch
        k = sum(s == self.step for _, s in self.calls)
        xg = x.reshape(1, -1, x.shape[-1])
        probs, eidx, _, vals, tok = self._moe.dispatch(p, cfg, xg, dropless)
        kept = torch.zeros_like(probs, dtype=torch.bool).transpose(1, 2)
        kept.scatter_(-1, tok, vals > 0)
        self.calls[(k, self.step)] = {
            "probs": probs[0].cpu(),
            "experts": eidx[0].sort(-1).values.cpu(),
            "kept": kept[0].cpu()}
        return self._fwd(p, cfg, x, dropless, n_groups)


def _batch_dims(batch) -> tuple:
    """(rows, length) of an LM batch of tokens or embeddings."""
    return tuple((batch["tokens"] if "tokens" in batch
                  else batch["embeds"]).shape[:2])


def stepwise_logits(params, cfg, inputs, max_len, device, routes=None):
    """``lm.prefill`` of ``inputs[0]``, then ``lm.decode_step`` of each
    later input (teacher-forced, at offsets prompt, prompt + 1, ...), on
    ``device`` over an fp32 cache of ``max_len``: each call's logits, on
    the host.  ``routes`` (a ``RoutingLog``) learns each call's step."""
    import torch
    from repro_torch.models import lm
    B, S = _batch_dims(inputs[0])
    cache = lm.init_cache(cfg, B, max_len, kv_dtype=torch.float32,
                          device=device)
    out = []
    for i, batch in enumerate(inputs):
        if routes is not None:
            routes.step = i
        batch = {k: v.to(device) for k, v in batch.items()}
        if i == 0:
            logits, cache = lm.prefill(params, cfg, batch, cache)
        else:
            logits, cache = lm.decode_step(params, cfg, batch, cache,
                                           S + i - 1)
        out.append(logits.cpu())
    return out


def layerwise_cpu_logits(params, cfg, inputs, max_len, routes=None):
    """What ``stepwise_logits`` computes, on the CPU one layer at a time.
    The inputs are teacher-forced, so every call's input is known at the
    start: each layer's params are copied to the host from wherever
    ``params`` lie, run over the prefill and every decode step, and
    dropped before the next layer's are copied; then the final norm and
    the head.  The host holds about one layer, not the model (jamba's
    fp32 period: 49.4 GiB, its largest layer 10.5 GiB).  Built of
    ``lm_forward``'s own pieces (``stack_input``, ``_layer_fwd``,
    ``stack_output``), so on the CPU it gives the same bits."""
    import torch
    from repro_torch.models import lm
    from repro_torch.tree import map_tree
    cpu = torch.device("cpu")

    def host(node):
        return map_tree(lambda t: t.to(cpu), node)
    B, S = _batch_dims(inputs[0])
    # decode_step's offset: a 0-d int64 tensor
    offsets = [0] + [torch.tensor(S + i) for i in range(len(inputs) - 1)]
    modes = ["prefill"] + ["decode"] * (len(inputs) - 1)
    src = ({"embed": host(params["embed"])} if cfg.input_mode == "tokens"
           else params)                   # embeddings: the head's dtype
    xs, pos = zip(*(lm.stack_input(src, cfg, b, off)
                    for b, off in zip(inputs, offsets)))
    xs, pos = list(xs), list(pos)
    del src
    cache = lm.init_cache(cfg, B, max_len, kv_dtype=torch.float32,
                          device=cpu)
    for si, r, name, mixer, mlp in lm._layers(cfg):
        layer = host(params["segments"][si][r][name])
        for i in range(len(inputs)):
            if routes is not None:
                routes.step = i
            xs[i], _, _ = lm._layer_fwd(layer, cfg, mixer, mlp, xs[i],
                                        pos[i], cache[si][r][name],
                                        offsets[i], modes[i])
        del layer
    head = host({k: v for k, v in params.items() if k != "segments"
                 and (k != "embed" or cfg.tie_embeddings)})
    return [lm.stack_output(head, cfg, x) for x in xs]


def host_peak_gib() -> float:
    """This process's peak resident set so far (``getrusage``'s
    ``ru_maxrss``, KiB on Linux), GiB."""
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20


def host_rss_gib() -> float:
    """This process's resident set now (``/proc/self/statm``), GiB."""
    pages = int(Path("/proc/self/statm").read_text().split()[1])
    return pages * os.sysconf("SC_PAGE_SIZE") / 2 ** 30


def embeds_programs(cfg, slots, prompt, dtype, device, pool=None):
    """The served prefill and decode programs of an arch fed embeddings
    (the reference jits ``lm.prefill`` and ``lm.decode_step``; neither
    package has an engine for this input), each a ``GraphedProgram``
    sharing ``pool``: static ``embeds`` ((slots, prompt, D), then
    (slots, 1, D)), for M-RoPE archs static (3, slots, len) int32
    ``positions``, and for decode a 0-d int64 ``offset``, the cache
    position, which M-RoPE's positions need not equal.  Each program is
    ``prog(params, cache, embeds[, positions][, offset])`` and returns
    the last position's logits (slots, Vpad)."""
    import torch
    from repro_torch.models import lm
    from repro_torch.serve.graphs import GraphedProgram
    mrope = bool(cfg.mrope_sections)

    def batch(embeds, pos):
        return dict(embeds=embeds, **({"positions": pos[0]} if pos else {}))

    def prefill(params, cache, embeds, *pos):
        logits, _ = lm.prefill(params, cfg, batch(embeds, pos), cache)
        # a copy, so the static output is (slots, Vpad), not a view
        return logits[:, -1, :].contiguous()

    def decode(params, cache, embeds, *rest):
        *pos, offset = rest
        logits, _ = lm.decode_step(params, cfg, batch(embeds, pos), cache,
                                   offset)
        return logits[:, -1, :]

    def static(length):
        out = [torch.zeros((slots, length, cfg.d_model), dtype=dtype,
                           device=device)]
        if mrope:
            out.append(torch.zeros((3, slots, length), dtype=torch.int32,
                                   device=device))
        return out
    return (GraphedProgram(prefill, static(prompt), pool),
            GraphedProgram(decode, static(1) + [torch.zeros(
                (), dtype=torch.int64, device=device)], pool))


def training_phase(dev, report, launches, profiled, get_config) -> None:
    """The training path on the card: qwen2-1.5b at full size through
    ``make_train_step`` (no hand-written kernel may run); the 2-layer cut
    in fp32 against the CPU; the ``Trainer`` with async checkpoints,
    resumed by a second trainer; the step-3 checkpoint served by
    ``ServeEngine`` (``flash_attention`` launched, the tokens those of the
    trainer's in-memory params); and ``python -m
    repro_torch.launch.train`` exiting 0."""
    import shutil
    import numpy as np
    import torch
    from repro_torch.data import SyntheticLMData
    from repro_torch.kernels import _build
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import lm
    from repro_torch.optim import adamw_init
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.trainer import TrainConfig, Trainer
    from repro_torch.tree import leaves, map_tree

    out = report["train"] = {}
    cpu = torch.device("cpu")
    base = get_config(TRAIN_ARCH)

    def clear():
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def batch_on(data, step, device):
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for k, v in data.batch_at(step).items()}

    # -- full width and depth, bf16, through make_train_step -------------
    cfg = dataclasses.replace(base, remat="full")
    clear()
    torch.cuda.reset_peak_memory_stats()
    params = lm.init_lm(cfg, seed=0, device=dev)
    state = {"params": params, "opt": adamw_init(params),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    del params
    state_bytes = sum(t.numel() * t.element_size() for t in leaves(state))
    data = SyntheticLMData(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ)
    step_fn = make_train_step(cfg, donate=True)
    _build.reset_launches()
    ms, losses, norms = [], [], []
    for s_ in range(TRAIN_STEPS):
        batch = batch_on(data, s_, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    counts = {k: v for k, v in _build.LAUNCHES.items() if v}
    peak = torch.cuda.max_memory_allocated()
    batch = batch_on(data, TRAIN_STEPS, dev)
    with profiled(host=False) as prof:
        state, m = step_fn(state, batch)
        losses.append(float(m["loss"]))
    traced = traced_launches(prof)
    records = device_records(prof)
    del prof
    groups = {}
    for name, t0_, t1_ in records:
        g = ("gemm" if any(x in name.lower() for x in (
                 "gemm", "nvjet", "cutlass", "xmma", "sm90")) else
             "foreach" if "multi_tensor_apply" in name else
             "reduce" if "reduce" in name.lower() else
             "copy" if not is_kernel(name) else "elementwise")
        groups[g] = groups.get(g, 0.0) + (t1_ - t0_) / 1e3
    step_ms = float(np.median(ms[TRAIN_TIMED_FROM:]))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    n = cfg.num_params()
    mfu = 6 * n * tokens / (step_ms / 1e3) / BF16_FLOP_PER_S
    busy = busy_ms(records)
    span = ((records[-1][2] - records[0][1]) / 1e3) if records else 0.0
    out["full"] = {"arch": TRAIN_ARCH, "params": n,
                   "state_bytes": state_bytes, "batch": TRAIN_BATCH,
                   "seq": TRAIN_SEQ, "grad_accum": cfg.grad_accum,
                   "remat": cfg.remat, "step_ms": ms,
                   "step_ms_median": step_ms,
                   "tokens_per_s": tokens / step_ms * 1e3,
                   "model_flop_share_6N": mfu,
                   "peak_gib": peak / 2 ** 30, "losses": losses,
                   "grad_norms": norms, "launches": counts,
                   "traced_kernels": traced,
                   "traced_step_device_ms": busy,
                   "traced_step_device_span_ms": span,
                   "idle_share_untraced": 1 - busy / step_ms,
                   "traced_step_kernels": sum(1 for r in records
                                              if is_kernel(r[0])),
                   "traced_step_device_ms_by_group": groups}
    print(f"  {TRAIN_ARCH} (full size, bf16, batch {TRAIN_BATCH}x{TRAIN_SEQ},"
          f" grad_accum {cfg.grad_accum}, remat {cfg.remat}): "
          f"{n / 1e9:.3f} B params, state {state_bytes / 2 ** 30:.2f} GiB; "
          f"step ms {[round(t, 1) for t in ms]}, median of steps "
          f"{TRAIN_TIMED_FROM + 1}-{TRAIN_STEPS} {step_ms:.2f} ms, "
          f"{tokens / step_ms * 1e3:.0f} tokens/s, 6*N*tokens over the step "
          f"at {BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s: {mfu:.3f}; peak "
          f"{peak / 2 ** 30:.2f} GiB allocated")
    print(f"  {TRAIN_ARCH} losses {[round(x, 4) for x in losses]}, grad "
          f"norms {[round(x, 3) for x in norms]}; launch counters {counts}; "
          f"kernels of ours in a traced step {traced}; the traced step: "
          f"{out['full']['traced_step_kernels']} kernels, device busy "
          f"{busy:.2f} ms of a {span:.2f} ms span; idle share against the "
          f"untraced median step {1 - busy / step_ms:.3f}; device ms by "
          f"group {({k: round(v, 2) for k, v in groups.items()})}")
    # where the step's time goes: the same 4,096 tokens in one micro-batch
    # (a quarter of the launches), timed, not gated
    one = make_train_step(dataclasses.replace(cfg, grad_accum=1),
                          donate=True)
    one_ms = []
    for s_ in range(3):
        batch = batch_on(data, s_, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = one(state, batch)
        torch.cuda.synchronize()
        one_ms.append((time.perf_counter() - t0) * 1e3)
    out["full"]["grad_accum_1_step_ms"] = one_ms
    out["full"]["grad_accum_1_peak_gib"] = \
        torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"  the same batch in one micro-batch (grad_accum 1): step ms "
          f"{[round(t, 1) for t in one_ms]} (the first warms), peak "
          f"{out['full']['grad_accum_1_peak_gib']:.2f} GiB")
    if not all(np.isfinite(losses)) or not all(np.isfinite(norms)):
        fail(f"{TRAIN_ARCH} training: non-finite loss or grad norm")
    if counts or traced:
        fail(f"{TRAIN_ARCH} training launched hand-written kernels: "
             f"counters {counts}, trace {traced}")
    del state, m, batch
    clear()

    # -- card vs CPU: 2 layers at full width, fp32 ------------------------
    cut = dataclasses.replace(base, num_layers=TRAIN_CUT_LAYERS,
                              grad_accum=TRAIN_CPU_ACCUM)
    p0 = lm.init_lm(cut, seed=0, device=dev, dtype=torch.float32)
    p0 = map_tree(lambda t: t.cpu(), p0)            # the same numbers
    data = SyntheticLMData(cut.vocab_size, TRAIN_CPU_BATCH, TRAIN_CPU_SEQ)
    step_fn = make_train_step(cut, peak_lr=TRAIN_CPU_LR, donate=True)
    runs = {}
    for name, device in (("card", dev), ("cpu", cpu)):
        p = map_tree(lambda t: t.to(device, copy=True), p0)
        st = {"params": p, "opt": adamw_init(p),
              "step": torch.zeros((), dtype=torch.int32, device=device)}
        t0 = time.perf_counter()
        rows = []
        for s_ in range(TRAIN_CPU_STEPS):
            st, m = step_fn(st, batch_on(data, s_, device))
            rows.append((float(m["loss"]), float(m["grad_norm"])))
        runs[name] = (rows, [t.cpu() for t in leaves(st["params"])],
                      time.perf_counter() - t0)
        del st, p
        clear()
    base_leaves = leaves(p0)
    worst_metric = max(abs(a - b) / abs(b) for ra, rb in zip(
        runs["card"][0], runs["cpu"][0]) for a, b in zip(ra, rb))
    upd = []
    for a, b, z in zip(runs["card"][1], runs["cpu"][1], base_leaves):
        da, db = a - z, b - z
        upd.append(float((da - db).norm() / max(float(db.norm()), 1e-30)))
    out["card_vs_cpu"] = {"layers": TRAIN_CUT_LAYERS,
                          "grad_accum": TRAIN_CPU_ACCUM,
                          "card": runs["card"][0], "cpu": runs["cpu"][0],
                          "max_rel_loss_or_norm": worst_metric,
                          "max_rel_update_l2": max(upd),
                          "card_s": runs["card"][2],
                          "cpu_s": runs["cpu"][2]}
    print(f"  card vs CPU ({TRAIN_CUT_LAYERS} layers, fp32, batch "
          f"{TRAIN_CPU_BATCH}x{TRAIN_CPU_SEQ}, grad_accum {TRAIN_CPU_ACCUM},"
          f" {TRAIN_CPU_STEPS} steps): (loss, grad_norm) card "
          f"{runs['card'][0]}, cpu {runs['cpu'][0]}; max relative "
          f"difference {worst_metric:.2e} (bound {TRAIN_CPU_TOL}); max "
          f"relative L2 of a leaf's update difference {max(upd):.2e} over "
          f"{len(upd)} leaves (bound {TRAIN_UPDATE_TOL}); card "
          f"{runs['card'][2]:.1f} s, cpu {runs['cpu'][2]:.1f} s")
    if not worst_metric <= TRAIN_CPU_TOL:
        fail(f"training card vs CPU: loss/grad_norm differ by "
             f"{worst_metric:.2e} relative")
    if not max(upd) <= TRAIN_UPDATE_TOL:
        fail(f"training card vs CPU: a leaf's update differs by "
             f"{max(upd):.2e} relative in L2")
    del runs, p0, base_leaves
    clear()

    # -- the trainer: async checkpoints, resume, serving the checkpoint ---
    cut = dataclasses.replace(base, num_layers=TRAIN_CUT_LAYERS)
    root = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    run_dir = root / "run"
    data = SyntheticLMData(cut.vocab_size, TRAIN_BATCH, TRAIN_SERVE_PROMPT)
    first = Trainer(cut, TrainConfig(steps=2, ckpt_every=2,
                                     ckpt_dir=str(run_dir), ckpt_async=True,
                                     log_every=1), data, device=dev)
    t0 = time.perf_counter()
    first.run()
    first_s = time.perf_counter() - t0
    second = Trainer(cut, TrainConfig(steps=3, ckpt_every=2,
                                      ckpt_dir=str(run_dir), ckpt_async=True,
                                      log_every=1), data, device=dev)
    t0 = time.perf_counter()
    start = second.resume_or_init()
    restore_s = time.perf_counter() - t0
    same = all(torch.equal(a, b) for a, b in zip(leaves(first.state),
                                                   leaves(second.state)))
    print(f"  trainer ({TRAIN_CUT_LAYERS} layers, bf16): steps 1-2 and an "
          f"async checkpoint in {first_s:.1f} s; a second trainer resumed "
          f"from step {start} in {restore_s:.1f} s; restored state equal "
          f"to the saved one bit for bit: {same}")
    if start != 2 or not same:
        fail(f"resume: step {start}, bit-equal {same}")
    # the uninterrupted step 3, on the first trainer's own state
    first.state, m = first.step_fn(first.state, batch_on(data, 2, dev))
    whole = float(m["loss"])
    second.state = None
    second.run()
    resumed = second.metrics_log[-1]["loss"]
    rel = abs(resumed - whole) / abs(whole)
    print(f"  step-3 loss resumed {resumed:.6f}, uninterrupted {whole:.6f} "
          f"(relative {rel:.2e}, bound {TRAIN_RESUME_TOL}); checkpoints "
          f"{ckpt.latest_steps(run_dir)}")
    if not rel <= TRAIN_RESUME_TOL or ckpt.latest_steps(run_dir) != [2, 3]:
        fail(f"resumed step 3: loss {resumed} vs {whole}, checkpoints "
             f"{ckpt.latest_steps(run_dir)}")
    del first
    clear()
    tree = ckpt.load_numpy(run_dir, 3, prefix="params")
    served = lm.params_from_numpy(tree["params"], cut, device=dev)
    del tree
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cut.vocab_size, (
        TRAIN_SERVE_REQUESTS, TRAIN_SERVE_PROMPT)).astype(np.int32)
    waves = -(-TRAIN_SERVE_REQUESTS // LM_SLOTS)

    def serve(params):
        eng = ServeEngine(cut, params, slots=LM_SLOTS,
                          max_len=TRAIN_SERVE_PROMPT
                          + TRAIN_SERVE_NEW, device=dev)
        for i, pr in enumerate(prompts):
            eng.submit(Request(i, pr, max_new_tokens=TRAIN_SERVE_NEW))
        done = eng.run(prompt_len=TRAIN_SERVE_PROMPT)
        torch.cuda.synchronize()
        return {r.rid: r.out_tokens for r in done}

    _build.reset_launches()
    toks = serve(served)
    counts = {k: v for k, v in _build.LAUNCHES.items() if v}
    for k, v in counts.items():
        launches[k] += v
    want = serve(second.state["params"])
    planned = {"flash_attention": TRAIN_CUT_LAYERS * waves}
    print(f"  the step-3 checkpoint served by ServeEngine "
          f"({TRAIN_SERVE_REQUESTS} requests, prompt {TRAIN_SERVE_PROMPT}, "
          f"{TRAIN_SERVE_NEW} new tokens): launches {counts} (planned "
          f"{planned}); tokens equal those of the trainer's in-memory "
          f"params: {toks == want}; request 0 {toks[0]}")
    if counts != planned:
        fail(f"serving the checkpoint: launches {counts} != {planned}")
    if toks != want or len(toks) != TRAIN_SERVE_REQUESTS or any(
            len(t) != TRAIN_SERVE_NEW for t in toks.values()):
        fail("serving the checkpoint: tokens differ from the in-memory "
             "params' or are missing")
    out["trainer"] = {"first_two_steps_s": first_s, "restore_s": restore_s,
                      "restored_bit_equal": same, "resumed_loss": resumed,
                      "uninterrupted_loss": whole, "relative": rel,
                      "served_launches": counts, "served_tokens_equal": True}
    del second, served
    clear()

    # -- the launcher on the card (no --device) ----------------------------
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           TRAIN_ARCH, "--smoke", "--steps", "6", "--ckpt-every", "3",
           "--ckpt-dir", str(root / "cli")]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=600,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    cli_s = time.perf_counter() - t0
    steps_written = ckpt.latest_steps(root / "cli")
    print(f"  python -m repro_torch.launch.train --arch {TRAIN_ARCH} --smoke "
          f"--steps 6 --ckpt-every 3: exit {res.returncode} in {cli_s:.1f} s,"
          f" checkpoints {steps_written}; "
          f"{(res.stdout.strip().splitlines() or [''])[-1][:160]}")
    if res.returncode != 0 or steps_written != [3, 6]:
        fail(f"the training launcher exited {res.returncode}: "
             f"{res.stderr[-2000:]}")
    out["launcher"] = {"exit": res.returncode, "s": cli_s,
                       "checkpoints": steps_written}
    shutil.rmtree(root, ignore_errors=True)


def mesh_training_phase(dev, report, launches, profiled, get_config) -> None:
    """Training on a mesh: a world-size-1 NCCL process group and
    ``make_debug_mesh()``, (1, 1) ("data", "model").  The 2-layer fp32
    cut, one step on the mesh against the same step unsharded; qwen2-1.5b
    at full size in bf16, three steps through ``Trainer(mesh=...)``
    beside three unsharded ones (no hand-written kernel in a traced mesh
    step); ``compressed_psum`` over the one-rank group; the mesh
    trainer's checkpoint restored with and without the mesh and served
    (``flash_attention`` launched); the launcher with ``--mesh debug``
    (exit 0) and ``--mesh pod`` (the 256-rank error).  The group is
    destroyed at the end."""
    import shutil
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.data import SyntheticLMData
    from repro_torch.dist import compress as C
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import lm
    from repro_torch.optim import adamw_init
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.trainer import TrainConfig, Trainer
    from repro_torch.tree import leaves, map_tree

    out = report["mesh_train"] = {}
    base = get_config(TRAIN_ARCH)
    root = ROOT / "build" / "chip_smoke_mesh"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)

    def clear():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    def whole(tree):
        """A DTensor tree's whole values, copied (a replicated DTensor's
        ``full_tensor`` is its local tensor, which a donated step
        updates in place)."""
        return map_tree(lambda t: t.full_tensor().clone(), tree)

    # NCCL on the card (gloo where a rehearsal passes the CPU as dev)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.FileStore(
        str(root / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_debug_mesh()
        print(f"  process group {backend}, world {dist.get_world_size()}; "
              f"mesh {tuple(mesh.shape)} {mesh.mesh_dim_names} on "
              f"{mesh.device_type}")
        if tuple(mesh.shape) != (1, 1) or mesh.device_type != dev.type:
            fail(f"make_debug_mesh() on one card: {mesh}")

        # -- the 2-layer fp32 cut: one step on the mesh vs unsharded ----------
        cut = dataclasses.replace(base, num_layers=TRAIN_CUT_LAYERS,
                                  grad_accum=TRAIN_CPU_ACCUM)
        data = SyntheticLMData(cut.vocab_size, TRAIN_CPU_BATCH,
                               TRAIN_CPU_SEQ)
        tcfg = TrainConfig(ckpt_dir=str(root / "unused"),
                           peak_lr=TRAIN_CPU_LR)
        runs = {}
        for name, kw in (("mesh", {"mesh": mesh}), ("one", {"device": dev})):
            t = Trainer(cut, tcfg, data, **kw)
            st = t.init_state()
            st["params"] = map_tree(lambda a: a.float(), st["params"])
            st["opt"] = adamw_init(st["params"])
            p0 = leaves(whole(st["params"]) if name == "mesh"
                        else map_tree(torch.clone, st["params"]))
            st, m = t.step_fn(st, t.batch_at(0))
            p1 = leaves(whole(st["params"]) if name == "mesh"
                        else st["params"])
            runs[name] = (float(m["loss"]), float(m["grad_norm"]), p0, p1)
            del t, st
            clear()
        (lm_, gm, p0m, p1m), (lo, go, p0o, p1o) = runs["mesh"], runs["one"]
        same0 = all(torch.equal(a, b) for a, b in zip(p0m, p0o))
        rel_loss, rel_norm = abs(lm_ - lo) / abs(lo), abs(gm - go) / abs(go)
        upd = [float(((a - z) - (b - y)).norm()
                     / max(float((b - y).norm()), 1e-30))
               for a, z, b, y in zip(p1m, p0m, p1o, p0o)]
        out["cut"] = {"loss": [lm_, lo], "grad_norm": [gm, go],
                      "rel_loss": rel_loss, "rel_grad_norm": rel_norm,
                      "max_rel_update_l2": max(upd), "same_start": same0}
        print(f"  {TRAIN_CUT_LAYERS} layers fp32, one step at grad_accum "
              f"{TRAIN_CPU_ACCUM} on the mesh vs unsharded: loss {lm_:.7f} / "
              f"{lo:.7f} (relative {rel_loss:.2e}), grad_norm {gm:.6f} / "
              f"{go:.6f} ({rel_norm:.2e}), bound {MESH_TOL}; max relative L2 "
              f"of a leaf's update difference {max(upd):.2e} over "
              f"{len(upd)} leaves (bound {TRAIN_UPDATE_TOL}); same start "
              f"{same0}")
        if not (same0 and rel_loss <= MESH_TOL and rel_norm <= MESH_TOL
                and max(upd) <= TRAIN_UPDATE_TOL):
            fail("the mesh step differs from the unsharded step")
        del runs, p0m, p1m, p0o, p1o
        clear()

        # -- full size, bf16: Trainer on the mesh vs unsharded --------------
        cfg = dataclasses.replace(base, remat="full")
        data = SyntheticLMData(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ)
        tokens = TRAIN_BATCH * TRAIN_SEQ
        full = {}
        for name, kw in (("mesh", {"mesh": mesh}), ("one", {"device": dev})):
            torch.cuda.reset_peak_memory_stats()
            t = Trainer(cfg, TrainConfig(ckpt_dir=str(root / "unused")),
                        data, **kw)
            t.state = t.init_state()
            _build.reset_launches()
            ms, losses = [], []
            for s_ in range(MESH_STEPS):
                batch = t.batch_at(s_)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                t.state, m = t.step_fn(t.state, batch)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                losses.append(float(m["loss"]))
            row = {"step_ms": ms, "losses": losses,
                   "step_ms_median": float(np.median(ms[1:])),
                   "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                   "launches": {k: v for k, v in _build.LAUNCHES.items()
                                if v}}
            row["tokens_per_s"] = tokens / row["step_ms_median"] * 1e3
            if name == "mesh":
                local = sum(x.to_local().numel() for x in leaves(t.state))
                row["state_local_numel"] = local
                row["state_numel"] = sum(x.numel() for x in leaves(t.state))
                batch = t.batch_at(MESH_STEPS)
                with profiled(host=False) as prof:
                    t.state, m = t.step_fn(t.state, batch)
                    losses.append(float(m["loss"]))
                row["traced_kernels"] = traced_launches(prof)
                records = device_records(prof)
                del prof
                row["traced_step_kernels"] = sum(
                    1 for r in records if is_kernel(r[0]))
                row["traced_step_device_ms"] = busy_ms(records)
                row["idle_share_untraced"] = (
                    1 - row["traced_step_device_ms"] / row["step_ms_median"])
            full[name] = row
            del t, m, batch
            clear()
        mrow, orow = full["mesh"], full["one"]
        out["full"] = full
        print(f"  {TRAIN_ARCH} full size bf16, batch {TRAIN_BATCH}x{TRAIN_SEQ},"
              f" grad_accum {cfg.grad_accum}, remat {cfg.remat}, "
              f"{MESH_STEPS} steps: on the (1, 1) mesh step ms "
              f"{[round(x, 1) for x in mrow['step_ms']]} (median of 2-"
              f"{MESH_STEPS} {mrow['step_ms_median']:.1f}, "
              f"{mrow['tokens_per_s']:.0f} tokens/s, peak "
              f"{mrow['peak_gib']:.2f} GiB); unsharded "
              f"{[round(x, 1) for x in orow['step_ms']]} (median "
              f"{orow['step_ms_median']:.1f}, {orow['tokens_per_s']:.0f} "
              f"tokens/s, peak {orow['peak_gib']:.2f} GiB); mesh over "
              f"unsharded {mrow['step_ms_median'] / orow['step_ms_median']:.2f}"
              f"x")
        print(f"  a traced mesh step: {mrow['traced_step_kernels']} kernels "
              f"(unsharded, the training phase's trace: "
              f"{report['train']['full']['traced_step_kernels']}), device "
              f"busy {mrow['traced_step_device_ms']:.1f} ms, idle share "
              f"against the untraced median "
              f"{mrow['idle_share_untraced']:.3f}; kernels of ours "
              f"{mrow['traced_kernels']}, counters {mrow['launches']} and "
              f"{orow['launches']}; losses mesh "
              f"{[round(x, 4) for x in mrow['losses']]}, unsharded "
              f"{[round(x, 4) for x in orow['losses']]}; state "
              f"{mrow['state_local_numel']} of {mrow['state_numel']} "
              f"elements local")
        if not all(np.isfinite(r["losses"]).all() for r in full.values()):
            fail("training on the mesh: a non-finite loss")
        if mrow["traced_kernels"] or mrow["launches"] or orow["launches"]:
            fail(f"training on the mesh launched hand-written kernels: "
                 f"{mrow['traced_kernels']} {mrow['launches']}")

        # -- compressed_psum over the one-rank group ---------------------------
        g = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn(MESH_PSUM_SHAPE, generator=g, device=dev)
        zero = torch.zeros_like(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, err = C.compressed_psum(x, mesh["data"], zero)
        torch.cuda.synchronize()
        psum_ms = (time.perf_counter() - t0) * 1e3
        (q, sc, shape), want_err = C.quantize_with_feedback(x, zero)
        ok = (torch.equal(got, C.dequantize(q, sc, shape))
              and torch.equal(err, want_err))
        out["compressed_psum"] = {"shape": list(MESH_PSUM_SHAPE),
                                  "bit_equal": ok, "ms": psum_ms}
        print(f"  compressed_psum over mesh['data'] on a "
              f"{MESH_PSUM_SHAPE} fp32 tensor: {psum_ms:.2f} ms (first "
              f"call), equal to dequantize(quantize_with_feedback(x, 0)) "
              f"bit for bit: {ok}")
        if not ok:
            fail("compressed_psum over one rank differs from the codec")
        del x, zero, got, err, q, sc, want_err
        clear()

        # -- the mesh trainer's checkpoint: restored, served ----------------
        cut = dataclasses.replace(base, num_layers=TRAIN_CUT_LAYERS)
        data = SyntheticLMData(cut.vocab_size, TRAIN_BATCH, TRAIN_SERVE_PROMPT)
        run_dir = root / "run"
        t = Trainer(cut, TrainConfig(steps=2, ckpt_every=2,
                                     ckpt_dir=str(run_dir), ckpt_async=True,
                                     log_every=1), data, mesh=mesh)
        t.run()
        saved = leaves(whole(t.state))
        like = t.init_state(device="meta")
        plain = ckpt.restore_checkpoint(run_dir, 2, like, device=dev)
        onto = ckpt.restore_checkpoint(run_dir, 2, like,
                                       shardings=t.shardings)
        same = (all(torch.equal(a, b) for a, b in zip(saved, leaves(plain)))
                and all(torch.equal(a, b.full_tensor())
                        for a, b in zip(saved, leaves(onto))))
        print(f"  the mesh trainer ({TRAIN_CUT_LAYERS} layers, bf16): 2 steps, "
              f"checkpoint {ckpt.latest_steps(run_dir)}; restored without "
              f"the mesh and onto it, bit-equal to the saved state: {same}")
        if not same or ckpt.latest_steps(run_dir) != [2]:
            fail("the mesh trainer's checkpoint does not restore bit-equal")
        del plain, onto, saved
        tree = ckpt.load_numpy(run_dir, 2, prefix="params")
        served = lm.params_from_numpy(tree["params"], cut, device=dev)
        in_memory = whole(t.state["params"])
        del tree, t
        rng = np.random.default_rng(0)
        prompts = rng.integers(0, cut.vocab_size, (
            TRAIN_SERVE_REQUESTS, TRAIN_SERVE_PROMPT)).astype(np.int32)
        waves = -(-TRAIN_SERVE_REQUESTS // LM_SLOTS)

        def serve(params):
            eng = ServeEngine(cut, params, slots=LM_SLOTS,
                              max_len=TRAIN_SERVE_PROMPT + TRAIN_SERVE_NEW,
                              device=dev)
            for i, pr in enumerate(prompts):
                eng.submit(Request(i, pr, max_new_tokens=TRAIN_SERVE_NEW))
            done = eng.run(prompt_len=TRAIN_SERVE_PROMPT)
            torch.cuda.synchronize()
            return {r.rid: r.out_tokens for r in done}

        _build.reset_launches()
        toks = serve(served)
        counts = {k: v for k, v in _build.LAUNCHES.items() if v}
        for k, v in counts.items():
            launches[k] += v
        want = serve(in_memory)
        planned = {"flash_attention": TRAIN_CUT_LAYERS * waves}
        print(f"  its checkpoint served by ServeEngine: launches {counts} "
              f"(planned {planned}); tokens equal to the in-memory params': "
              f"{toks == want}")
        if counts != planned:
            fail(f"serving the mesh checkpoint: launches {counts} != "
                 f"{planned}")
        if toks != want or len(toks) != TRAIN_SERVE_REQUESTS:
            fail("serving the mesh checkpoint: tokens differ")
        out["trainer"] = {"restored_bit_equal": same,
                          "served_launches": counts,
                          "served_tokens_equal": True}
        del served, in_memory
        clear()

        # -- the launcher: --mesh debug, --mesh pod -----------------------------
        cli = {}
        for kind in ("debug", "pod"):
            cmd = [sys.executable, "-m", "repro_torch.launch.train",
                   "--arch", TRAIN_ARCH, "--smoke", "--steps", "3",
                   "--mesh", kind, "--ckpt-dir", str(root / f"cli_{kind}")]
            if dev.type != "cuda":
                cmd += ["--device", dev.type]
            t0 = time.perf_counter()
            res = subprocess.run(cmd, cwd=ROOT, capture_output=True,
                                 text=True, timeout=600, env=dict(
                                     os.environ,
                                     PYTHONPATH=str(ROOT / "src")))
            cli[kind] = {"exit": res.returncode,
                         "s": time.perf_counter() - t0,
                         "tail": (res.stdout + res.stderr).strip()
                         .splitlines()[-1:]}
            print(f"  launcher --mesh {kind}: exit {res.returncode} in "
                  f"{cli[kind]['s']:.1f} s; {cli[kind]['tail']}")
            if kind == "debug" and (res.returncode != 0 or
                                    ckpt.latest_steps(root / "cli_debug")
                                    != [3]):
                fail(f"launcher --mesh debug: exit {res.returncode}: "
                     f"{res.stderr[-2000:]}")
            if kind == "pod" and (res.returncode == 0
                                  or "needs 256 ranks" not in res.stderr):
                fail(f"launcher --mesh pod: exit {res.returncode} without "
                     f"the 256-rank error: {res.stderr[-2000:]}")
        out["launcher"] = cli
    finally:
        dist.destroy_process_group()
        shutil.rmtree(root, ignore_errors=True)


def analysis_phase(dev, report, launches, get_config) -> None:
    """The analysis (``launch/dryrun.py``, ``roofline/``) held to the
    card: on a world-size-1 NCCL group's (1, 1) mesh, qwen2-1.5b's
    training step (8x512 tokens, grad_accum 4, full remat, bf16) counted
    by the dry-run on meta and by the same counter around the real step
    on the card (FLOPs within ``ANALYSIS_FLOP_TOL``, collective counts
    equal; both peaks printed); the step's roofline with ``HW`` beside
    its measured ms (the largest term over the measured step at most
    ``ANALYSIS_SHARE_MAX``); one prefill wave counted on meta and on the
    card, where ``flash_attention`` launches once a layer (its formula's
    FLOPs equal); and ``python -m repro_torch.launch.dryrun`` on three
    cells of the pod mesh under this machine's torch (exit 0, ``OK``)."""
    import json
    import shutil
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import SyntheticLMData
    from repro_torch.kernels import _build
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import lm
    from repro_torch.roofline.analysis import HW, analyze_record
    from repro_torch.train.trainer import TrainConfig, Trainer
    from repro_torch.tree import leaves

    out = report["analysis"] = {"card": report["card"]}
    card = report["card"]
    root = ROOT / "build" / "chip_smoke_analysis"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)

    # the CLI's three cells first, in parallel, while this process counts
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = {f"{a}/{s_}": subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", a,
         "--shape", s_, "--out", str(root / "cli")], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for a, s_ in DRYRUN_CELLS}
    t_cli = time.perf_counter()

    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.FileStore(
        str(root / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_debug_mesh()
        cfg = dataclasses.replace(get_config(TRAIN_ARCH), remat="full")
        shape = ShapeConfig("train_8x512", TRAIN_SEQ, TRAIN_BATCH, "train")

        # -- the training step: on meta, then on the card -----------------
        t0 = time.perf_counter()
        *_, meta = D.lower_cell(TRAIN_ARCH, shape, False, cfg=cfg, mesh=mesh)
        meta_s = time.perf_counter() - t0
        t = Trainer(cfg, TrainConfig(ckpt_dir=str(root / "unused")),
                    SyntheticLMData(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ),
                    mesh=mesh)
        t.state = t.init_state()
        ms = []
        for s_ in range(2):                  # a warm step, a timed one
            batch = t.batch_at(s_)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t.state, _ = t.step_fn(t.state, batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        batch = t.batch_at(2)
        args = (t.state, batch)
        arg_bytes = D.local_bytes(args)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counter = D.CostCounter(arguments=[
            x.to_local() if hasattr(x, "to_local") else x
            for x in leaves(t.state) + list(batch.values())])
        t0 = time.perf_counter()
        with counter:
            t.state, m = t.step_fn(t.state, batch)
        torch.cuda.synchronize()
        counted_ms = (time.perf_counter() - t0) * 1e3
        card_peak = torch.cuda.max_memory_allocated()
        card_c = D.collective_bytes(counter)
        rel = abs(counter.flops - meta["flops_per_device"]) / max(
            meta["flops_per_device"], 1.0)
        counts = ({k: v["count"] for k, v in meta["collectives"].items()},
                  {k: v["count"] for k, v in card_c.items()})
        row = {"meta_flops": meta["flops_per_device"],
               "card_flops": float(counter.flops), "rel_flops": rel,
               "meta_bytes": meta["bytes_accessed_per_device"],
               "card_bytes": float(counter.bytes),
               "collective_counts": list(counts),
               "meta_peak_bytes": meta["memory"]["peak_bytes"],
               "card_counted_peak_bytes": arg_bytes + counter.peak_temp,
               "card_max_memory_allocated": card_peak,
               "meta_s": meta_s, "step_ms": ms, "counted_step_ms":
               counted_ms, "loss": float(m["loss"])}
        print(f"  [{card}] {TRAIN_ARCH} training step, {TRAIN_BATCH}x"
              f"{TRAIN_SEQ} tokens, grad_accum {cfg.grad_accum}, remat "
              f"{cfg.remat}, bf16, on the (1, 1) mesh: FLOPs per rank "
              f"counted on meta {meta['flops_per_device']:.6e} ({meta_s:.1f}"
              f" s on the host), on the card {counter.flops:.6e} (relative "
              f"{rel:.2e}, bound {ANALYSIS_FLOP_TOL}); bytes "
              f"{meta['bytes_accessed_per_device']:.6e} / "
              f"{counter.bytes:.6e}; collectives {counts[0]} / {counts[1]}")
        print(f"  [{card}] peak: counted on meta "
              f"{meta['memory']['peak_bytes'] / 2**30:.3f} GiB, counted on "
              f"the card {row['card_counted_peak_bytes'] / 2**30:.3f} GiB, "
              f"torch.cuda.max_memory_allocated "
              f"{card_peak / 2**30:.3f} GiB (recorded, not gated); step ms "
              f"{[round(x, 1) for x in ms]} untraced, {counted_ms:.1f} "
              f"under the counter")
        if not (np.isfinite(row["loss"]) and rel <= ANALYSIS_FLOP_TOL
                and counts[0] == counts[1]):
            fail("the dry-run's count of the training step differs from "
                 "the card's")

        # -- its roofline with HW ----------------------------------------
        rec = dict(meta, status="OK", arch=TRAIN_ARCH, shape=shape.name,
                   mesh="1x1", devices=1, kind="train",
                   params=cfg.num_params(),
                   active_params=cfg.num_active_params(),
                   tokens=TRAIN_BATCH * TRAIN_SEQ)
        roof = analyze_record(rec)
        step_s = ms[-1] / 1e3
        share = max(roof["compute_s"], roof["memory_s"],
                    roof["collective_s"]) / step_s
        row["roofline"] = {k: roof[k] for k in (
            "compute_s", "memory_s", "collective_s", "dominant",
            "useful_ratio", "roofline_frac", "peak_gib")}
        row["roofline"]["share"] = share
        print(f"  [{card}] roofline with {HW.name} ({HW.peak_flops:.3g} "
              f"FLOP/s, {HW.hbm_bw:.3g} B/s, links {HW.nvlink_bw:.3g} / "
              f"{HW.internode_bw:.3g} B/s; NVIDIA's published figures, not "
              f"measured): compute {roof['compute_s'] * 1e3:.3f} ms, memory "
              f"{roof['memory_s'] * 1e3:.3f} ms (unfused), collective "
              f"{roof['collective_s'] * 1e3:.3f} ms, bound "
              f"{roof['dominant']}; measured step {ms[-1]:.1f} ms: share "
              f"{share:.4f} (bound {ANALYSIS_SHARE_MAX}); 6ND/counted "
              f"{roof['useful_ratio']:.3f}")
        if share > ANALYSIS_SHARE_MAX:
            fail(f"roofline share {share:.3f} > {ANALYSIS_SHARE_MAX}: the "
                 f"count or the constants are wrong")
        out["train"] = row
        del t, args, batch, counter, m
        gc.collect()
        torch.cuda.empty_cache()

        # -- one prefill wave: meta and the card ---------------------------
        lcfg = get_config(TRAIN_ARCH)
        wave = {}
        for where in ("meta", "card"):
            d = torch.device("meta") if where == "meta" else dev
            params = lm.init_lm(lcfg, seed=0, device=d)
            cache = lm.init_cache(lcfg, LM_SLOTS, LM_MAX_LEN, device=d)
            toks = torch.zeros((LM_SLOTS, LM_PROMPT), dtype=torch.int32,
                               device=d)
            _build.reset_launches()
            c = D.CostCounter(arguments=leaves(params) + leaves(cache))
            with c, torch.no_grad():
                logits, _ = lm.prefill(params, lcfg, {"tokens": toks}, cache)
            torch.cuda.synchronize()
            wave[where] = {"flops": c.flops,
                           "flash_flops": c.flops_by_op.get(
                               "flash_attention", 0),
                           "launches": {k: v for k, v in
                                        _build.LAUNCHES.items() if v}}
            if where == "card":
                for k, v in wave[where]["launches"].items():
                    launches[k] += v
            del params, cache, logits
            gc.collect()
            torch.cuda.empty_cache()
        planned = {"flash_attention": lcfg.num_layers}
        print(f"  [{card}] one {TRAIN_ARCH} prefill wave ({LM_SLOTS}x"
              f"{LM_PROMPT}): flash_attention FLOPs by its formula on meta "
              f"{wave['meta']['flash_flops']:.6e}, on the card "
              f"{wave['card']['flash_flops']:.6e}; all FLOPs "
              f"{wave['meta']['flops']:.6e} / {wave['card']['flops']:.6e}; "
              f"launches on meta {wave['meta']['launches']}, on the card "
              f"{wave['card']['launches']} (planned {planned})")
        if (wave["meta"]["flash_flops"] != wave["card"]["flash_flops"]
                or not wave["card"]["flash_flops"]
                or wave["meta"]["launches"]
                or wave["card"]["launches"] != planned):
            fail("the prefill wave's kernel count differs between meta and "
                 "the card")
        out["prefill"] = wave
    finally:
        dist.destroy_process_group()

    # -- the CLI's cells, under this machine's torch ------------------------
    cli = {}
    for cell, proc in procs.items():
        text, _ = proc.communicate(timeout=600)
        arch, shp = cell.split("/")
        f = root / "cli" / f"{arch}__{shp}__pod.json"
        rec = json.loads(f.read_text()) if f.exists() else {}
        cli[cell] = {"exit": proc.returncode,
                     "status": rec.get("status", "no record"),
                     "compile_s": rec.get("compile_s"),
                     "probe": rec.get("probe")}
        if "traceback" in rec:
            cli[cell]["traceback"] = rec["traceback"]
        print(f"  [{card}] python -m repro_torch.launch.dryrun --arch {arch} "
              f"--shape {shp}: exit {proc.returncode}, "
              f"{cli[cell]['status']} in {rec.get('compile_s')} s of meta "
              f"runs; {text.strip().splitlines()[-1:]}")
    print(f"  the CLI's cells: {time.perf_counter() - t_cli:.1f} s wall, "
          f"beside the counts above")
    out["cli"] = cli
    if any(v["exit"] != 0 or v["status"] != "OK" for v in cli.values()):
        fail(f"the dry-run CLI under torch {torch.__version__}: {cli}\n"
             + "\n".join(v.get("traceback", "")[-3000:]
                         for v in cli.values()))
    shutil.rmtree(root / "cli", ignore_errors=True)


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: chip_smoke needs the card")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        fail(f"cannot import repro_torch from {ROOT / 'src'}: {e}")
    os.environ["REPRO_CACHE_DIR"] = str(ROOT / "build" / "chip_smoke_cache")
    import shutil
    shutil.rmtree(os.environ["REPRO_CACHE_DIR"], ignore_errors=True)

    import numpy as np
    import repro_torch as rt
    import torch.nn.functional as F
    from repro_torch.configs.base import SHAPES, get_config
    from repro_torch.configs.cnn_paper import PROFILED
    from repro_torch.configs.serve import (DEFAULT_SLO_MS, DIST_SMOKE,
                                           SMOKE_FRONTEND)
    from repro_torch.core import autotune, convspec, cuconv, executors
    from repro_torch.core import graph as tgraph
    from repro_torch.kernels import (_build, conv1d_tap, conv1x1,
                                     cuconv_fused, cuconv_stage1,
                                     cuconv_stage2, direct_conv,
                                     flash_attention, int8_gemm,
                                     winograd_fused)
    from repro_torch.models import lm
    from repro_torch.nn import moe as tmoe
    from repro_torch.models.cnn import (fire_like, mobilenet_like,
                                        resnet_like, squeezenet_like,
                                        tiny_cnn)
    from repro_torch.quant import Calibrator, QuantPolicy, symmetric
    from repro_torch.launch.mesh import make_serve_mesh
    from repro_torch.serve import (AsyncServeFrontend, ServeRequest,
                                   ShardedServeDispatcher)
    from repro_torch.serve.cnn import CnnServeEngine, ImageRequest
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.telemetry import STAGES, rollup_percentiles
    if "jax" in sys.modules or "repro" in sys.modules:
        fail("the port pulled in jax or the JAX package")

    dev = torch.device("cuda")
    report = {"kernels": {}, "shapes": [], "serve": {}}

    # -- 1. card ---------------------------------------------------------
    phase("card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0].strip() if smi else "nvidia-smi unavailable"
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    report["card"] = card
    if torch.backends.cuda.matmul.allow_tf32:
        fail("torch.backends.cuda.matmul.allow_tf32 is True: fp32 "
             "references must run without TF32")

    # -- 2. build ----------------------------------------------------------
    phase("build")
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"built {sorted(built)} in {time.perf_counter() - t0:.1f} s "
          f"(one nvcc per source, in parallel)")
    report["ptxas"] = {}
    for name, log in sorted(_build.BUILD_LOG.items()):
        entries = report["ptxas"][name] = ptxas_entries(log["ptxas"])
        for e in entries:
            print(f"  ptxas {name}: {e['entry']}: {e['registers']} "
                  f"registers, spill stores {e['spill_stores']} B, "
                  f"loads {e['spill_loads']} B")
    for name in NO_SPILL:
        entries = report["ptxas"].get(name)
        if not entries:
            fail(f"no ptxas report for {name} (built before this run: "
                 f"run chip_smoke on an empty build directory)")
        spilled = [e["entry"] for e in entries
                   if e["spill_stores"] or e["spill_loads"]]
        if spilled:
            fail(f"{name}: ptxas spills in {spilled}")

    # -- the main paths' shapes, from the port's own plans ------------------
    phase("plans, and int8 calibration through GraphPlan.warmup")
    gen = torch.Generator().manual_seed(0)

    def randn(shape, dtype=torch.float32):
        return torch.randn(tuple(shape), generator=gen).to(dev, dtype)

    model = resnet_like(num_classes=10)
    params = model.init(torch.Generator().manual_seed(0), device=dev)
    params_cpu = {n: {k: v.cpu() for k, v in p.items()}
                  for n, p in params.items()}
    rng = np.random.default_rng(0)
    small = (32, 32, 3)
    geometries = [(small, SMOKE_FRONTEND.geometry_map()[small]),
                  ((224, 224, 3), (1,))]
    # calibrate once on one seeded sample batch of 4 at 32x32: the
    # entries serve every bucket (batch-normalized keys)
    calib_x = rng.standard_normal((4,) + small, dtype=np.float32)
    calib = model.graph_plan((4,) + small, backend="cuda").warmup(
        calibrate=Calibrator(calib_x, params))["calibration"]
    print(f"  calibrated {sorted(calib)}: amax "
          f"{ {n: round(e['amax'], 4) for n, e in calib.items()} }")
    int8_geometry = (small, geometries[0][1])
    serve_policies = [("fp32", shape, buckets, None)
                      for shape, buckets in geometries]
    serve_policies.append(("int8",) + int8_geometry + (QuantPolicy(),))
    node_plans = []        # (label, ConvPlan) of every served conv node
    for kind, shape, buckets, pol in serve_policies:
        for b in buckets:
            gp = model.graph_plan((b,) + shape, backend="cuda",
                                  precision=pol)
            tag = f"resnet{shape[0]}b{b}" + (":int8" if pol else "")
            for name, p in gp.conv_plans.items():
                node_plans.append((f"{tag}:{name}", p))

    paper_plans = []       # (label, ConvPlan, call(x, w) through the API)
    for label, (hw, n, k, m, c) in PROFILED.items():
        spec = convspec.ConvSpec((n, hw, hw, c), (k, k, c, m),
                                 padding=((k - 1) // 2, (k - 1) // 2))
        paper_plans.append((label, convspec.plan(spec, backend="cuda"),
                            lambda x, w: rt.conv2d(x, w, padding="same")))
        if label in TWO_STAGE_ROWS:
            paper_plans.append((f"{label}:two_stage", convspec.plan(
                spec, force="cuconv_two_stage_pallas", backend="cuda"),
                lambda x, w: rt.conv2d(
                    x, w, padding="same",
                    algorithm="cuconv_two_stage_pallas")))
        if label in DIRECT_ROWS:
            paper_plans.append((f"{label}:direct", convspec.plan(
                spec, force="direct", backend="cuda"),
                lambda x, w: rt.conv2d(x, w, padding="same",
                                       algorithm="direct")))
    label, in_shape, w_shape, stride = DIRECT_STRIDED
    spec = convspec.ConvSpec(in_shape, w_shape, (stride, stride), (1, 1))
    paper_plans.append((f"{label}:direct", convspec.plan(
        spec, force="direct", backend="cuda"),
        lambda x, w: rt.conv2d(x, w, stride=stride, padding=(1, 1),
                               algorithm="direct")))
    variants = set()
    for label, ((hw, k, m, c), ref_cfg) in WINOGRAD_ROWS.items():
        spec = convspec.ConvSpec((8, hw, hw, c), (k, k, c, m),
                                 padding=(1, 1))
        p = convspec.plan(spec, backend="cuda")
        if p.algorithm != "winograd_pallas":
            fail(f"{label}: planned {p.algorithm}, not winograd_pallas")
        if p.config.as_dict() == ref_cfg:
            call = (lambda x, w: rt.conv2d(x, w, padding="same"))
        else:
            print(f"  {label}: the port's default config "
                  f"{p.config.as_dict()} differs from the reference's "
                  f"{ref_cfg}; forcing the reference's through "
                  f"plan(..., config=...)")
            p = convspec.plan(spec, backend="cuda", config=ref_cfg)
            call = p
        variants.add(p.config["m"])
        paper_plans.append((label, p, call))
    if variants != {2, 4}:
        fail(f"the Winograd rows run F(m,3) variants {variants}, not both")
    for label, p, _ in paper_plans:
        print(f"  {label}: {p.explain()}")

    def fused_args(p, dtype):
        s = p.spec
        kw = dict(stride=s.stride, padding=s.padding,
                  tm=p.config.get("tm", 128), rows=p.config.get("rows", 1))
        relu = (s.fused_add == "add_relu" if s.fused_add != "none"
                else s.wants_relu)
        kw["activation"] = "relu" if relu else None
        kw["bias"] = randn((s.filter_shape[3],), dtype) if s.has_bias \
            else None
        kw["addend"] = (randn(s.out_shape, dtype)
                        if s.fused_add != "none" else None)
        kw["pool"] = ((s.fused_pool[0], s.fused_pool[3], s.fused_pool[4])
                      if s.fused_pool else None)
        return (randn(s.in_shape, dtype), randn(s.filter_shape, dtype)), kw

    def gemm_tiles(p):
        c = p.config
        return dict(tp=c.get("tp", 256), tm=c.get("tm", 128),
                    tc=c.get("tc", 512))

    def two_stage_inputs(p, dtype):
        """Stage 1's operands both ways: the padded input and the HWIO
        filter (the main path's entry), and the stack of the tap views
        with the (T, C, M) taps (the reference's interface)."""
        s = p.spec
        kh, kw_, c, m = s.filter_shape
        xp = cuconv._pad_input(randn(s.in_shape, dtype),
                               *s.padding).contiguous()
        w4 = randn(s.filter_shape, dtype)
        xs = cuconv_stage1.stack_taps(xp, kh, kw_).contiguous()
        return (xp, w4), (xs, w4.reshape(kh * kw_, c, m))

    def case(kernel, label, kfn, pfn, args, kw, pkw, ops, tol,
             peak=FP32_FLOP_PER_S, in_line=True):
        """One kernel call; ``in_line``: its time is summed into the
        kernel's entry of the ``{"kernels": ...}`` line."""
        return dict(kernel=kernel, label=label, kfn=kfn, pfn=pfn,
                    args=args, kw=kw, pkw=pkw, ops=ops, tol=tol, peak=peak,
                    in_line=in_line)

    # every kernel call of the main paths at one dtype
    def cases(dtype):
        out = []
        base_tol = FP32_TOL if dtype == torch.float32 else BF16_TOL
        # the tensor-core kernels' rate for this dtype's products
        tc_peak = (TF32X3_FLOP_PER_S if dtype == torch.float32
                   else BF16_FLOP_PER_S)
        for label, p in node_plans + [(lb, p) for lb, p, _ in paper_plans]:
            s = p.spec
            n, oh, ow, m = s.out_shape
            kh, kw_, c, _ = s.filter_shape
            direct_flops = 2 * n * oh * ow * m * kh * kw_ * c
            if p.algorithm == "cuconv_pallas":
                args, kw = fused_args(p, dtype)
                out.append(case("cuconv_fused", label,
                                cuconv_fused.cuconv_fused,
                                cuconv_fused.cuconv_fused_plain, args, kw,
                                {k: v for k, v in kw.items()
                                 if k not in ("tm", "rows")},
                                direct_flops, base_tol, peak=tc_peak))
            elif p.algorithm == "conv1x1_pallas":
                args = (randn((n * oh * ow, c), dtype), randn((c, m), dtype))
                out.append(case("conv1x1_gemm", label, conv1x1.conv1x1_gemm,
                                conv1x1.conv1x1_gemm_plain, args,
                                gemm_tiles(p), {}, direct_flops, base_tol,
                                peak=tc_peak))
            elif p.algorithm == "cuconv_two_stage_pallas":
                padded, stacked = two_stage_inputs(p, dtype)
                out.append(case("stage1_tap_gemm", label,
                                cuconv_stage1.stage1_tap_conv,
                                cuconv_stage1.stage1_tap_conv_plain,
                                padded, gemm_tiles(p), {}, direct_flops,
                                base_tol, peak=tc_peak))
                # the reference's interface on the same values: held to
                # its plain version and to the entry above, bit for bit
                out.append(case("stage1_tap_gemm", f"{label}:stacked",
                                cuconv_stage1.stage1_tap_gemm,
                                cuconv_stage1.stage1_tap_gemm_plain,
                                stacked, gemm_tiles(p), {}, direct_flops,
                                base_tol, peak=tc_peak, in_line=False))
                temps = randn((kh * kw_, n * oh * ow, m))
                out.append(case("stage2_tap_sum", label,
                                cuconv_stage2.stage2_tap_sum,
                                cuconv_stage2.stage2_tap_sum_plain, (temps,),
                                {"out_dtype": dtype}, {"out_dtype": dtype},
                                (kh * kw_ - 1) * n * oh * ow * m, base_tol))
            elif p.algorithm == "winograd_pallas":
                fm = p.config["m"]
                pkw = dict(padding=s.padding, m=fm,
                           activation="relu" if s.wants_relu else None,
                           bias=(randn((m,), dtype) if s.has_bias
                                 else None))
                kw = dict(pkw, tt=p.config["tt"], tm=p.config["tm"],
                          tc=p.config["tc"])
                tiles = n * -(-oh // fm) * -(-ow // fm)
                out.append(case(
                    "winograd_fused", label, winograd_fused.winograd_fused,
                    winograd_fused.winograd_fused_plain,
                    (randn(s.in_shape, dtype), randn(s.filter_shape, dtype)),
                    kw, pkw, 2 * (fm + 2) ** 2 * tiles * c * m,
                    WINOGRAD_FP32_TOL[fm] if dtype == torch.float32
                    else BF16_TOL, peak=TF32X3_FLOP_PER_S))
            elif p.algorithm == "direct":
                pkw = dict(padding=s.padding, stride=s.stride)
                out.append(case(
                    "direct_conv", label, direct_conv.direct_conv,
                    direct_conv.direct_conv_plain,
                    (randn(s.in_shape, dtype), randn(s.filter_shape, dtype)),
                    dict(pkw, tm=p.config["tm"], tc=p.config["tc"]), pkw,
                    direct_flops, base_tol, peak=tc_peak))
        return out

    def int8_cases():
        """The int8 kernel's calls at every served int8 node: the conv
        entry as the executor launches it (fp32 input, the node's
        calibrated scale, epilogue and addend; in the line), the same
        entry on int8 codes (the raw accumulator), and the stacked entry
        on those codes' patch matrix."""
        out = []
        for label, p in node_plans:
            if p.algorithm != "cuconv_int8":
                continue
            s = p.spec
            n, oh, ow, m = s.out_shape
            kh, kw_, c, _ = s.filter_shape
            P, K = n * oh * ow, kh * kw_ * c
            ops = 2 * P * K * m
            w = torch.randint(-127, 128, (m, kh, kw_, c), generator=gen,
                              dtype=torch.int8).to(dev)
            relu = (s.fused_add == "add_relu" if s.fused_add != "none"
                    else s.wants_relu)
            pkw = dict(stride=s.stride, padding=s.padding,
                       scale=executors._scale_on(p.quant.x_scale, dev),
                       w_scales=torch.rand(m, generator=gen).to(dev) / 127,
                       bias=randn((m,)) if s.has_bias else None,
                       addend=(randn(s.out_shape) if s.fused_add != "none"
                               else None), relu=relu)
            out.append(case("int8_gemm", label, int8_gemm.int8_conv,
                            int8_gemm.int8_conv_plain, (randn(s.in_shape), w),
                            dict(pkw, **gemm_tiles(p)), pkw, ops, 0.0,
                            peak=INT8_OP_PER_S))
            codes = torch.randint(-127, 128, s.in_shape, generator=gen,
                                  dtype=torch.int8).to(dev)
            geo = dict(stride=s.stride, padding=s.padding)
            out.append(case("int8_gemm", f"{label}:codes",
                            int8_gemm.int8_conv, int8_gemm.int8_conv_plain,
                            (codes, w), dict(geo, **gemm_tiles(p)), geo, ops,
                            0.0, peak=INT8_OP_PER_S, in_line=False))
            stacked = (int8_gemm.conv_patches(codes, kh, kw_, s.stride,
                                              s.padding).contiguous(),
                       w.reshape(m, K).t().contiguous())
            out.append(case("int8_gemm", f"{label}:stacked",
                            int8_gemm.int8_gemm, int8_gemm.int8_gemm_plain,
                            stacked, gemm_tiles(p), {}, ops, 0.0,
                            peak=INT8_OP_PER_S, in_line=False))
        return out

    def served_config(arch):
        """The arch's config as served: full width, its depth cut where
        ``LM_SERVED_LAYERS`` says (and why, or None)."""
        cfg = get_config(arch)
        n = LM_SERVED_LAYERS.get(arch, cfg.num_layers)
        if n == cfg.num_layers:
            return cfg, None
        why = (f"{n} of {cfg.num_layers} layers: "
               f"{cfg.num_params() * 2 / 2 ** 30:.1f} GiB whole in bf16 "
               f"exceeds the card")
        return dataclasses.replace(cfg, num_layers=n), why

    lm_cuts = {arch: served_config(arch)
               for arch in LM_ARCHS + LM_EMBED_ARCHS}
    lm_cfgs = {arch: cfg for arch, (cfg, _) in lm_cuts.items()}

    def lm_cases(dtype):
        """The LM kernels' calls at the served models' shapes: prefill
        attention of 4 slots x 512 (and TRAIN_ARCH's train_4k sequence
        and the 4 x 128 prompts that serve its trained checkpoint), the
        three Mamba2 streams' conv.  The served bf16 calls make the
        line."""
        out = []
        bf16 = dtype == torch.bfloat16
        tol = BF16_TOL if bf16 else FP32_TOL
        for arch, cfg in lm_cfgs.items():
            mixers = {mx for mx, _ in cfg.layer_kinds()}
            if "attn" in mixers and not cfg.mla:    # MLA runs no kernel
                H, KVH, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
                shapes = [(LM_SLOTS, LM_PROMPT)]
                if arch == TRAIN_ARCH:      # its training and checkpoint
                    shapes += [(1, SHAPES["train_4k"].seq_len),
                               (LM_SLOTS, TRAIN_SERVE_PROMPT)]
                for b, s in shapes:
                    args = (randn((b, s, H, D), dtype),
                            randn((b, s, KVH, D), dtype),
                            randn((b, s, KVH, D), dtype))
                    out.append(case(
                        "flash_attention", f"{arch}:b{b}s{s}",
                        flash_attention.flash_attention,
                        flash_attention.flash_attention_plain, args,
                        {"causal": True}, {"causal": True},
                        4 * D * b * H * s * (s + 1) // 2, tol,
                        peak=BF16_FLOP_PER_S if bf16 else TF32X3_FLOP_PER_S,
                        in_line=bf16 and s == LM_PROMPT))
            if "ssm" in mixers:
                dims = {cfg.d_inner: "x", cfg.ssm_groups * cfg.ssm_state:
                        "B,C"}
                for dim, streams in dims.items():
                    shape = (LM_SLOTS, LM_PROMPT, dim)
                    args = (randn(shape, dtype), randn((cfg.d_conv, dim),
                                                       dtype),
                            randn((dim,), dtype))
                    out.append(case(
                        "conv1d_tap",
                        f"{arch}:{streams}:{'x'.join(map(str, shape))}",
                        conv1d_tap.conv1d_tap, conv1d_tap.conv1d_tap_plain,
                        args, {}, {}, 2 * cfg.d_conv * args[0].numel(), tol,
                        in_line=bf16))
        return out

    # -- 3. kernel vs plain --------------------------------------------------
    phase("kernel vs plain")
    max_err = {}
    stage1_outs = {}          # label -> output of each stage-1 entry
    int8_accs = {}            # label -> accumulator of each int8 entry
    for dtype, cs in ((torch.float32, cases(torch.float32)
                       + lm_cases(torch.float32)),
                      (torch.bfloat16, cases(torch.bfloat16)
                       + lm_cases(torch.bfloat16)),
                      (torch.int8, int8_cases())):
        for c in cs:
            kname, label = c["kernel"], c["label"]
            got = c["kfn"](*c["args"], **c["kw"])
            want = c["pfn"](*c["args"], **c["pkw"])
            torch.cuda.synchronize()
            if got.shape != want.shape or got.dtype != want.dtype:
                fail(f"{kname} {label}: {tuple(got.shape)}/{got.dtype} vs "
                     f"plain {tuple(want.shape)}/{want.dtype}")
            err = (got.double() - want.double()).abs().max().item()
            bound = c["tol"] * max(1.0, want.double().abs().max().item())
            ok = bool(torch.isfinite(got.double()).all()) and err <= bound
            if c["tol"] == 0:                   # int8: bit for bit
                ok = ok and torch.equal(got, want)
            print(f"  {kname:16s} {label:28s} {str(dtype)[6:]:8s} "
                  f"max|k-p|={err:.3e} bound={bound:.3e} "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"{kname} {label} {dtype}: kernel disagrees with its "
                     f"plain version ({err:.3e} > {bound:.3e})")
            if dtype != torch.bfloat16:
                max_err[kname] = max(max_err.get(kname, 0.0), err)
            if kname == "stage1_tap_gemm":
                stage1_outs[(label, dtype)] = got
            if kname == "int8_gemm" and label.endswith((":codes",
                                                         ":stacked")):
                int8_accs[label] = got
    for (label, dtype), got in stage1_outs.items():
        if label.endswith(":stacked"):
            same = torch.equal(got, stage1_outs[(label[:-8], dtype)])
            print(f"  stage1_tap_gemm  {label[:-8]:28s} {str(dtype)[6:]:8s} "
                  f"padded-input entry == stacked entry bit for bit: {same}")
            if not same:
                fail(f"stage1_tap_gemm {label[:-8]} {dtype}: the two "
                     f"entries disagree")

    for label, acc in int8_accs.items():
        if label.endswith(":codes"):
            node = label[:-len(":codes")]
            stacked = int8_accs[f"{node}:stacked"]
            same = torch.equal(acc, stacked.reshape(acc.shape))
            print(f"  int8_gemm        {node:28s} int8     conv entry == "
                  f"stacked entry on the same codes: {same}")
            if not same:
                fail(f"int8_gemm {node}: the two entries' accumulators "
                     f"differ")

    # -- 3b. the launch geometry of the tensor-core kernels and stage 2 -------
    phase("launch geometry of the tensor-core kernels and stage 2")

    def geometry(c):
        """What the wrapper launches for this call (the kernel's own
        block tile and splits, or grid; the plan's config sizes
        nothing)."""
        args, kw = c["args"], c["kw"]
        if c["kernel"] == "conv1x1_gemm":
            (P, C), M = args[0].shape, args[1].shape[1]
            return conv1x1.launch_geometry(P, C, M, args[0].element_size())
        if c["kernel"] == "cuconv_fused":
            return cuconv_fused.launch_geometry(
                args[0].shape, args[1].shape, kw["stride"], kw["padding"],
                kw["pool"], args[0].element_size())
        if c["kernel"] == "winograd_fused":
            n, h, w_, _ = args[0].shape
            fm, (ph, pw), M = kw["m"], kw["padding"], args[1].shape[3]
            tiles = n * -(-(h + 2 * ph - 2) // fm) * -(-(w_ + 2 * pw - 2)
                                                       // fm)
            return winograd_fused.launch_geometry(
                fm, tiles, M, kw["tm"], args[0].element_size())
        if c["kernel"] == "flash_attention":
            q = args[0]
            B, S, H, D = q.shape
            return flash_attention.launch_geometry(B, S, H, D,
                                                   q.element_size())
        if c["kernel"] == "direct_conv":
            return direct_conv.launch_geometry(
                args[0].shape, args[1].shape, kw["stride"], kw["padding"],
                args[0].element_size())
        if c["kernel"] == "stage1_tap_gemm":
            if args[0].dim() == 4:          # the padded input, HWIO filter
                n, hp, wp, C = args[0].shape
                kh, kw_, _, M = args[1].shape
                T, P = kh * kw_, n * (hp - kh + 1) * (wp - kw_ + 1)
            else:                           # the stacked views
                (T, P, C), M = args[0].shape, args[1].shape[2]
            return cuconv_stage1.launch_geometry(T, P, C, M,
                                                 args[0].element_size())
        if c["kernel"] == "int8_gemm":
            if args[0].dim() == 2:          # the stacked entry
                (P, K), M = args[0].shape, args[1].shape[1]
            else:                           # the conv entry
                M, kh, kw_, C = args[1].shape
                n, h, w_, _ = args[0].shape
                (sh, sw), (ph, pw) = kw["stride"], kw["padding"]
                P = (n * ((h + 2 * ph - kh) // sh + 1)
                     * ((w_ + 2 * pw - kw_) // sw + 1))
                K = kh * kw_ * C
            geo = int8_gemm.launch_geometry(P, K, M)
            return dict(geo, P=P, K=K, M=M)
        if c["kernel"] == "stage2_tap_sum":
            return cuconv_stage2.launch_geometry(*args[0].shape)
        if c["kernel"] == "conv1d_tap":
            return conv1d_tap.launch_geometry(*args[0].shape)
        return None

    report["geometry"] = {}
    # stage 2's rows are keyed "<row>:two_stage:sum" beside stage 1's
    main_rows = (set(GEMM_ROWS) | set(FUSED_ROWS) | set(WINOGRAD_ROWS)
                 | {f"{r}:direct" for r in DIRECT_ROWS}
                 | {f"{r}:two_stage" for r in TWO_STAGE_ROWS}
                 | {f"{r}:two_stage:sum" for r in TWO_STAGE_ROWS})
    for c in (cases(torch.float32) + lm_cases(torch.float32)
              + lm_cases(torch.bfloat16)
              + [c for c in int8_cases() if not c["label"].endswith(
                  ":codes")]):
        geo = geometry(c)
        if geo is None:
            continue
        key = (f"{c['label']}:{str(c['args'][0].dtype)[6:]}"
               if c["kernel"] == "flash_attention" else
               f"{c['label']}:sum" if c["kernel"] == "stage2_tap_sum"
               else c["label"])
        report["geometry"][key] = geo
        print(f"  {c['kernel']:16s} {key:28s} {geo}")
        if key in main_rows and geo["blocks"] < SMS:
            fail(f"{c['kernel']} {key}: {geo['blocks']} blocks, "
                 f"under one wave of {SMS}")
        # the int8 kernel: every block owns exactly one output tile
        if c["kernel"] == "int8_gemm" and not (
                geo["bm"] <= 32 and geo["bn"] <= 32
                and geo["blocks"] == geo["tiles"]
                == -(-geo["P"] // geo["bm"]) * -(-geo["M"] // geo["bn"])):
            fail(f"int8_gemm {key}: a block owns more than one output "
                 f"tile ({geo})")
    missing = main_rows - set(report["geometry"])
    if missing:
        fail(f"main-path shapes without a geometry: {missing}")

    # -- 4a. the per-call conv path: the paper's rows ------------------------
    phase("main path: paper rows through repro_torch.conv2d")
    launches = {k: 0 for k in _build.LAUNCHES}
    rows_in = {label: (randn(p.spec.in_shape), randn(p.spec.filter_shape))
               for label, p, _ in paper_plans}
    torch.cuda.synchronize()
    _build.reset_launches()
    rows_out = {label: call(*rows_in[label])
                for label, p, call in paper_plans}
    torch.cuda.synchronize()
    path_counts = dict(_build.LAUNCHES)
    for k, v in path_counts.items():
        launches[k] += v
    print(f"  launches: {path_counts}")
    for label, p, _ in paper_plans:
        y = rows_out[label]
        want = cuconv.conv_lax(*rows_in[label], stride=p.spec.stride,
                               padding=p.spec.padding)
        err = (y - want).abs().max().item()
        tol = 2e-3 if p.config.get("m") == 4 else 3e-4
        bound = tol * max(1.0, want.abs().max().item())
        if y.shape != want.shape or not err <= bound:
            fail(f"conv2d {label}: {err:.3e} from F.conv2d > {bound:.3e}")
        print(f"  {label:18s} out {tuple(y.shape)} max|y-F.conv2d|="
              f"{err:.3e} (bound {bound:.3e}) ok")
    need = {}
    for _, p, _ in paper_plans:
        for k in p.executor.kernels:
            need[k] = need.get(k, 0) + 1
    for k, n in need.items():
        if path_counts[k] != n:
            fail(f"paper rows: {k} launched {path_counts[k]} times, "
                 f"planned {n}")

    # -- 4b. serving resnet_like, fp32 and int8 ------------------------------
    phase("main path: resnet_like served by CnnServeEngine (fp32, int8)")
    # the same requests for every engine of a geometry
    traffic = {shape: [rng.normal(size=(n,) + shape).astype(np.float32)
                       for n in sizes]
               for shape, sizes in (((32, 32, 3), [1, 3, 2, 4, 1]),
                                    ((224, 224, 3), [1, 2]))}
    from torch.profiler import ProfilerActivity, profile, schedule

    @contextlib.contextmanager
    def profiled(host: bool = True):
        """``torch.profiler`` (CPU and CUDA; the card alone where not
        ``host``, which leaves the host's side of the region unslowed)
        around a region, after a warm-up step of TRACE_WARM_LAUNCHES
        small launches whose records are dropped, and held open
        TRACE_PAD_S before and after it.  Kernel records are lost at
        both ends otherwise: a trace closed right after a replayed qwen2
        prefill once held 24 of the 28 flash kernels it ran, and traces
        opened right before a served run missed its first batch."""
        with profile(activities=([ProfilerActivity.CPU] if host else [])
                     + [ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            warm = torch.zeros(256, device=dev)
            for _ in range(TRACE_WARM_LAUNCHES):
                warm.add_(1)
            torch.cuda.synchronize()
            prof.step()
            time.sleep(TRACE_PAD_S)
            yield prof
            torch.cuda.synchronize()
            time.sleep(TRACE_PAD_S)

    engines = {}
    served = {}
    plans_per_batch = {}          # (kind, shape) -> bucket -> launches
    for kind, shape, buckets, pol in serve_policies:
        eng = CnnServeEngine(model, params, shape, buckets=buckets,
                             precision=pol)
        ref = CnnServeEngine(model, params_cpu, shape, buckets=buckets,
                             device="cpu", backend="cuda", precision=pol)
        engines[(kind, shape)] = eng
        eng.warmup()
        library_nodes, per_batch = {}, {}
        for b in eng.buckets:
            gp = eng.programs.plan(b)
            print(gp.explain())
            library_nodes[str(b)] = {
                n: p.algorithm for n, p in gp.conv_plans.items()
                if not p.executor.kernels}
            per_batch[b] = {}
            for p in gp.conv_plans.values():
                for k in p.executor.kernels:
                    per_batch[b][k] = per_batch[b].get(k, 0) + 1
            print(f"  {kind} {shape} bucket {b}: serves "
                  f"{eng.programs.serve_dtype(b)}; launches per batch "
                  f"{per_batch[b]}; nodes on a library executor: "
                  f"{library_nodes[str(b)] or 'none'}")
            if library_nodes[str(b)]:
                fail(f"{kind} {shape} bucket {b}: conv nodes on a library "
                     f"executor: {library_nodes[str(b)]}")
        if kind == "fp32" and shape == small and per_batch[4] != {
                "winograd_fused": 1, "cuconv_fused": 5}:
            fail(f"fp32 32x32 bucket 4 plans {per_batch[4]}, not one "
                 f"winograd_fused and five cuconv_fused launches")
        if kind == "int8" and any(
                v != {"int8_gemm": 4, "cuconv_fused": 2}
                for v in per_batch.values()):
            fail(f"int8 buckets plan {per_batch}, not four int8_gemm and "
                 f"two cuconv_fused launches per batch")
        for i, im in enumerate(traffic[shape]):
            eng.submit(ImageRequest(i, im))
            ref.submit(ImageRequest(i, im))
        graphs = eng.programs.graphs
        if sorted(graphs) != list(eng.buckets) or any(
                g.captures != 1 for g in graphs.values()):
            fail(f"serving {kind} {shape}: warmup captured "
                 f"{ {b: g.captures for b, g in graphs.items()} }, not one "
                 f"CUDA graph per bucket")
        replays = {b: g.replays for b, g in graphs.items()}
        torch.cuda.synchronize()
        convspec.reset_plan_stats()
        _build.reset_launches()
        # under the profiler: the kernels the replays ran are counted in
        # the trace, beside the counters' bookkeeping
        with profiled() as prof:
            t0 = time.perf_counter()
            done = eng.run()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        counts = dict(_build.LAUNCHES)
        traced = traced_launches(prof)
        replays = {b: g.replays - replays[b] for b, g in graphs.items()}
        for k, v in counts.items():
            launches[k] += v
        want = {}
        for b, n_batches in eng.stats["batches"].items():
            for k, v in per_batch[b].items():
                if n_batches:
                    want[k] = want.get(k, 0) + n_batches * v
        plans_per_batch[(kind, shape)] = per_batch
        print(f"  {kind} {shape}: {eng.stats['images']} images in "
              f"{sum(eng.stats['batches'].values())} batches "
              f"{eng.stats['batches']}, {secs * 1e3:.2f} ms (profiled); "
              f"graph replays {replays}; kernels in the trace {traced}; "
              f"launch counters {counts}; planned {want}; plan() "
              f"resolutions {convspec.PLAN_STATS['resolutions']}")
        if traced != want:
            fail(f"serving {kind} {shape}: the trace ran {traced} != "
                 f"planned {want}")
        if {k: v for k, v in counts.items() if v} != want:
            fail(f"serving {kind} {shape}: launches {counts} != planned "
                 f"{want}")
        if replays != eng.stats["batches"] or any(
                g.captures != 1 for g in graphs.values()):
            fail(f"serving {kind} {shape}: graph replays {replays} != "
                 f"batches {eng.stats['batches']} (or a bucket re-captured)")
        if convspec.PLAN_STATS["resolutions"]:
            fail(f"serving {kind} {shape}: a warm engine made "
                 f"{convspec.PLAN_STATS['resolutions']} plan() resolutions")
        # each bucket's graph replays the eager program bit for bit
        for b in eng.buckets:
            xb = rng.normal(size=(b,) + shape).astype(np.float32)
            want_y = eng.programs.fn(b)(eng.params, eng.programs.put(xb))
            got_y = eng.programs.serve_batch(b, xb).clone()
            torch.cuda.synchronize()
            same = torch.equal(got_y, want_y)
            print(f"  {kind} {shape} bucket {b}: graph replay == eager "
                  f"program bit for bit: {same}")
            if not same:
                fail(f"serving {kind} {shape} bucket {b}: the graph's "
                     f"replay differs from the eager program by "
                     f"{(got_y - want_y).abs().max().item():.3e}")
        ref_done = ref.run()
        served[(kind, shape)] = done
        for a, r in zip(done, ref_done):
            if a.out.shape != r.out.shape or not np.isfinite(a.out).all():
                fail(f"serving {kind} {shape} request {a.rid}: bad output")
            err = float(np.abs(a.out - r.out).max())
            bound = SERVE_TOL * float(np.abs(r.out).max())
            if not err <= bound:
                fail(f"serving {kind} {shape} request {a.rid}: card vs CPU "
                     f"{err:.3e} > {bound:.3e}")
        print(f"  {kind} {shape}: outputs match the CPU engine within "
              f"{SERVE_TOL} of their abs max")
        report["serve"][f"{kind} {shape}"] = {
            "batches": {str(k): v for k, v in eng.stats["batches"].items()},
            "images": eng.stats["images"], "run_ms_profiled": secs * 1e3,
            "graph_replays": {str(k): v for k, v in replays.items()},
            "launches": counts, "traced_launches": traced,
            "library_nodes": library_nodes,
            "serve_dtypes": {str(b): eng.programs.serve_dtype(b)
                             for b in eng.buckets}}
    q_out = np.concatenate([r.out for r in served[("int8", small)]])
    f_out = np.concatenate([r.out for r in served[("fp32", small)]])
    rel = float(np.abs(q_out - f_out).max() / np.abs(f_out).max())
    print(f"  int8 vs fp32 at 32x32: max|q - fp| / max|fp| = {rel:.4e} "
          f"(bound {INT8_ACCURACY})")
    if not rel <= INT8_ACCURACY:
        fail(f"int8 serving is {rel:.4e} from fp32 > {INT8_ACCURACY}")
    report["serve"]["int8_vs_fp32_rel_err"] = rel

    # one served batch per 32x32 bucket, fp32 and int8 (the bucket's graph
    # replayed), under torch.profiler: its counted kernels must be the
    # bucket's plan, and, an int8 node being one kernel launch, an int8
    # batch may launch no more CUDA kernels than the fp32 batch
    report["serve"]["kernels_per_batch"] = {}
    for b in engines[("int8", small)].buckets:
        seen = {}
        for kind in ("fp32", "int8"):
            eng = engines[(kind, small)]
            xb = np.zeros((b,) + small, np.float32)
            replays = eng.programs.graphs[b].replays
            with profiled() as prof:
                eng.programs.serve_batch(b, xb)
                torch.cuda.synchronize()
            if eng.programs.graphs[b].replays != replays + 1:
                fail(f"{kind} 32x32 bucket {b}: the batch replayed no graph")
            seen[kind] = {}
            for name, _, _ in device_records(prof):
                if is_kernel(name):
                    seen[kind][name] = seen[kind].get(name, 0) + 1
            traced = traced_launches(prof)
            print(f"  {kind} 32x32 bucket {b}: "
                  f"{sum(seen[kind].values())} CUDA kernels per replayed "
                  f"batch; counted kernels {traced}")
            for name, n in sorted(seen[kind].items(), key=lambda kv: -kv[1]):
                print(f"    x{n:<3d} {name[:100]}")
            if traced != plans_per_batch[(kind, small)][b]:
                fail(f"{kind} 32x32 bucket {b}: a replayed batch ran "
                     f"{traced}, planned "
                     f"{plans_per_batch[(kind, small)][b]}")
        totals = {k: sum(v.values()) for k, v in seen.items()}
        report["serve"]["kernels_per_batch"][str(b)] = {
            k: {"total": totals[k], "kernels": v} for k, v in seen.items()}
        if not totals["fp32"]:
            fail(f"bucket {b}: the profiler saw no CUDA kernel")
        if totals["int8"] > totals["fp32"]:
            fail(f"bucket {b}: an int8 batch launches {totals['int8']} CUDA "
                 f"kernels, the fp32 batch {totals['fp32']}")

    # -- 4c. served latency over a window of requests -------------------------
    # A few requests prove the outputs; latency needs hundreds.  Each
    # window drains WINDOW_REQUESTS requests of 1..max(bucket) images
    # through the warm engine; ms per batch is the window's wall time
    # over its batches (every batch ends in a copy to the host).
    phase(f"served latency through the bucket graphs: {WINDOWS} windows "
          f"of {WINDOW_REQUESTS} requests")
    for kind, shape, buckets, _ in serve_policies:
        eng = engines[(kind, shape)]
        sizes = rng.integers(1, max(buckets) + 1, size=WINDOW_REQUESTS)
        pool = rng.standard_normal((int(sizes.max()),) + shape,
                                   dtype=np.float32)
        windows = []
        for _ in range(WINDOWS):
            before = dict(eng.stats["batches"])
            for i, n in enumerate(sizes):
                eng.submit(ImageRequest(i, pool[:n]))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.run()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            batches = {b: eng.stats["batches"][b] - before[b]
                       for b in eng.buckets}
            n_b = sum(batches.values())
            windows.append({"images": int(sizes.sum()), "batches":
                            {str(b): v for b, v in batches.items()},
                            "wall_ms": ms, "ms_per_batch": ms / n_b,
                            "images_per_s": sizes.sum() / ms * 1e3})
            print(f"  {kind} {shape}: {WINDOW_REQUESTS} requests, "
                  f"{sizes.sum()} images in {n_b} batches {batches}: "
                  f"{ms:.4f} ms, {ms / n_b:.6f} ms per batch, "
                  f"{sizes.sum() / ms * 1e3:.1f} images/s")
        report["serve"][f"{kind} {shape}"]["windows"] = windows

    # -- 4d. the LM serving path, bf16, full width (depth: LM_SERVED_LAYERS) ---
    phase(f"main path: LM served by ServeEngine (bf16, {LM_REQUESTS} "
          f"requests on {LM_SLOTS} slots, prompt {LM_PROMPT}, "
          f"{LM_NEW} new tokens)")
    report["lm_serve"] = {}
    waves = -(-LM_REQUESTS // LM_SLOTS)

    def serve_lm(cfg, params, prompts, timed):
        """One ``ServeEngine.run`` over ``prompts`` (on the card: the
        first wave and the first decode step eager, each then captured
        as a CUDA graph and replayed after); each prefill and decode
        call's logits are checked finite and, if ``timed``, its wall time
        taken between synchronizes, as ``(ms, replayed)``."""
        eng = ServeEngine(cfg, params, slots=LM_SLOTS, max_len=LM_MAX_LEN,
                          device=dev)
        times, nonfinite = {"_prefill": [], "_decode": []}, []
        for name in times:
            def wrapped(*a, fn=getattr(eng, name), name=name):
                if timed:
                    torch.cuda.synchronize()
                before = sum(g.replays for g in eng.graphs.values())
                t0 = time.perf_counter()
                logits, cache = fn(*a)
                if timed:
                    torch.cuda.synchronize()
                    times[name].append((
                        (time.perf_counter() - t0) * 1e3,
                        sum(g.replays for g in eng.graphs.values()) > before))
                if not bool(torch.isfinite(logits).all()):
                    nonfinite.append(name)
                return logits, cache
            setattr(eng, name, wrapped)
        for i, p in enumerate(prompts):
            eng.submit(Request(i, p, max_new_tokens=LM_NEW))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = eng.run(prompt_len=LM_PROMPT)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        graphs = {str(k): (g.captures, g.replays)
                  for k, g in eng.graphs.items()}
        return done, times, nonfinite, wall, graphs

    def memory_mark():
        """Empty the allocator's cache, reset its peaks; the bytes held."""
        gc.collect()                # an engine of an earlier run
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        return torch.cuda.memory_allocated(), torch.cuda.memory_reserved()

    def memory_peak(base):
        """Peak device memory since ``memory_mark()`` above what it held,
        GiB (allocated, reserved)."""
        torch.cuda.synchronize()
        return ((torch.cuda.max_memory_allocated() - base[0]) / 2 ** 30,
                (torch.cuda.max_memory_reserved() - base[1]) / 2 ** 30)

    def eager_tokens(cfg, params, prompts):
        """The served greedy tokens recomputed by eager ``lm.prefill`` and
        ``lm.decode_step`` calls, wave by wave, on a cache of their own."""
        out = []
        for w in range(0, len(prompts), LM_SLOTS):
            cache = logits = None          # one wave's cache at a time
            cache = lm.init_cache(cfg, LM_SLOTS, LM_MAX_LEN, device=dev)
            toks = torch.from_numpy(prompts[w:w + LM_SLOTS]).to(dev)
            logits, cache = lm.prefill(params, cfg, {"tokens": toks}, cache)
            cur = logits[:, -1, :cfg.vocab_size].float().argmax(-1)
            seq = [cur]
            for t in range(LM_NEW - 1):
                logits, cache = lm.decode_step(
                    params, cfg, {"tokens": cur[:, None].to(torch.int32)},
                    cache, LM_PROMPT + t)
                cur = logits[:, -1, :cfg.vocab_size].float().argmax(-1)
                seq.append(cur)
            out.extend(torch.stack(seq, 1).cpu().tolist())
        return out

    def kernel_group(name):
        """The device-time group of a kernel, by its name: the two LM
        kernels, library GEMMs, sorts (the MoE's top-k), gathers and
        scatters (the MoE's dispatch and combine, the caches' writes) and
        reductions (the MoE's K-way sum among them); "other" is the
        elementwise rest."""
        for key, group in (("flash_attention", "flash_attention"),
                           ("conv1d_tap", "conv1d_tap"), ("gemm", "gemm"),
                           ("nvjet", "gemm"), ("xmma", "gemm"),
                           ("cutlass", "gemm"), ("Sort", "topk_sort"),
                           ("sort", "topk_sort"),
                           ("scatter_gather", "gather_scatter"),
                           ("indexSelect", "gather_scatter"),
                           ("index_elementwise", "gather_scatter"),
                           ("reduce_kernel", "reduce")):
            if key in name:
                return group
        return "other"

    def engine_calls(cfg, params, prompts):
        """A fresh ``ServeEngine``'s prefill of one wave of ``prompts``
        and LM_TRACE_STEPS decode steps, each step's logits sampled to
        the host as the engine does, for ``trace_lm``; and its graphs'
        replay count."""
        eng = ServeEngine(cfg, params, slots=LM_SLOTS, max_len=LM_MAX_LEN,
                          device=dev)
        toks = torch.from_numpy(prompts).to(dev)
        step = torch.zeros((LM_SLOTS, 1), dtype=torch.int32, device=dev)

        def prefill():
            eng._sample(eng._prefill(eng.params, {"tokens": toks},
                                     eng.cache)[0])

        def decode():
            for t in range(LM_TRACE_STEPS):
                eng._sample(eng._decode(eng.params, {"tokens": step},
                                        eng.cache, LM_PROMPT + t)[0])
        return prefill, decode, lambda: sum(g.replays
                                            for g in eng.graphs.values())

    def trace_lm(arch, prefill, decode, replays, per_wave):
        """One prefill wave (``prefill()``) and LM_TRACE_STEPS decode
        steps (``decode()``), replayed from their CUDA graphs (captured
        first, outside the trace; ``replays()`` counts them) under
        torch.profiler: device time by kernel group and the device's idle
        share of the wall time (host clock, synchronized; busy time is
        the union of the kernel and memcpy records' intervals).  The
        replayed prefill must run ``per_wave``'s counted kernels, the
        decode steps none."""
        prefill()
        decode()                       # eager, then captured
        before = replays()
        calls = {"prefill": prefill, "decode": decode}
        out = {}
        for what, fn in calls.items():
            torch.cuda.synchronize()
            with profiled() as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            # kernel and memcpy records only (never the ProfilerStep
            # span over them), busy time as the union of their intervals
            records = device_records(prof)
            kernels = {}
            for name, t0, t1 in records:
                ms, n = kernels.get(name, (0.0, 0))
                kernels[name] = (ms + (t1 - t0) / 1e3, n + 1)
            busy = busy_ms(records)
            groups = {}
            for name, (ms, _) in kernels.items():
                g = kernel_group(name)
                groups[g] = groups.get(g, 0.0) + ms
            top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
            traced = traced_launches(prof)
            want = per_wave if what == "prefill" else {}
            print(f"  {arch} replayed {what}: kernels in the trace "
                  f"{traced}, planned {want}")
            if traced != want:
                fail(f"{arch} replayed {what}: the trace ran {traced} "
                     f"!= planned {want}")
            n_launch = sum(1 for r in records if is_kernel(r[0]))
            per = LM_TRACE_STEPS if what == "decode" else 1
            print(f"  {arch} replayed {what}: {n_launch} kernel "
                  f"launches ({n_launch / per:.0f} per "
                  f"{'step' if what == 'decode' else 'wave'})")
            out[what] = {"wall_ms": wall, "device_ms": busy,
                         "traced_launches": traced,
                         "kernel_launches": n_launch,
                         "kernel_launches_per_call": n_launch / per,
                         "idle_share": 1 - busy / wall if busy else None,
                         "groups_ms": groups,
                         "top": [(n[:80], ms, c) for n, (ms, c) in top]}
            if not busy:
                print(f"  {arch} {what}: the profiler saw no device "
                      f"time; busy and idle share not measured")
                continue
            print(f"  {arch} {what} under the profiler: wall "
                  f"{wall:.3f} ms, device busy {busy:.3f} ms, idle share "
                  f"{1 - busy / wall:.3f}; by group "
                  f"{ {g: round(ms, 4) for g, ms in groups.items()} }")
            if not 0.0 <= 1 - busy / wall <= 1.0:
                fail(f"{arch} {what}: idle share {1 - busy / wall:.3f} "
                     f"outside [0, 1] (busy {busy:.3f} ms of {wall:.3f})")
            for n, ms, c in out[what]["top"][:4]:
                print(f"    {ms:10.4f} ms  x{c:<5d} {n}")
        if replays() - before != LM_TRACE_STEPS + 1:
            fail(f"{arch}: the traced calls did not all replay graphs")
        return out

    def decode_idle(arch, row):
        """A served row's decode idle share: the profiler stretches the
        host's side of a step, so the traced device ms a step is held
        against the untraced ms a step."""
        busy = row["trace"]["decode"]["device_ms"]
        if not busy:
            return
        row["decode_device_ms_per_step"] = busy / LM_TRACE_STEPS
        row["decode_idle_share_untraced"] = 1 - (
            row["decode_device_ms_per_step"] / row["decode_ms_per_step"])
        print(f"  {arch} decode: device {busy / LM_TRACE_STEPS:.4f} ms per "
              f"step (traced) against {row['decode_ms_per_step']:.4f} ms per "
              f"step untraced: idle share "
              f"{row['decode_idle_share_untraced']:.3f}")

    def tree_tensors(node):
        if isinstance(node, dict):
            return [t for v in node.values() for t in tree_tensors(v)]
        if isinstance(node, list):
            return [t for v in node for t in tree_tensors(v)]
        return [node]

    def moe_layers(params):
        return [layer["moe"] for seg in params["segments"] for rep in seg
                for layer in rep.values() if "moe" in layer]

    def moe_checks(arch, cfg, params, prompts):
        """An MoE model's routing statistics on one prefill wave (eager
        ``lm_forward(mode="prefill")``, which returns them), and two
        eager calls of its first MoE layer, on the wave's shape (the
        capacity path) and on a decode step's (dropless): the same bits
        each time.  Returns the expert-read floor of a decode step (every
        expert bank of every MoE layer read once, dropless) beside."""
        cache = lm.init_cache(cfg, LM_SLOTS, LM_MAX_LEN, device=dev)
        toks = torch.from_numpy(prompts[:LM_SLOTS]).to(dev)
        _, _, aux = lm.lm_forward(params, cfg, {"tokens": toks}, cache, 0,
                                  "prefill")
        del cache
        aux = {k: float(v) for k, v in aux.items()}
        print(f"  {arch}: a prefill wave's routing, summed over "
              f"{len(moe_layers(params))} MoE layers: {aux}")
        moe = moe_layers(params)[0]
        gen = torch.Generator(device=dev).manual_seed(1)
        same = {}
        for label, (b, sq, dropless) in {
                "prefill": (LM_SLOTS, LM_PROMPT, False),
                "decode": (LM_SLOTS, 1, True)}.items():
            x = torch.randn((b, sq, cfg.d_model), generator=gen,
                            device=dev).to(torch.bfloat16)
            a, _ = tmoe.moe_fwd(moe, cfg, x, dropless=dropless)
            c, _ = tmoe.moe_fwd(moe, cfg, x, dropless=dropless)
            same[label] = torch.equal(a, c)
        print(f"  {arch}: two eager MoE calls bit-equal: {same}")
        if not all(same.values()):
            fail(f"{arch}: two eager MoE calls differ: {same}")
        expert_bytes = sum(t.numel() * t.element_size()
                           for m in moe_layers(params)
                           for t in tree_tensors(m["experts"]))
        return {"prefill_wave_aux": aux, "moe_bit_equal": same,
                "expert_bytes": expert_bytes,
                "decode_expert_floor_ms": expert_bytes / HBM_BYTES_PER_S
                * 1e3}

    held_first = None
    for arch in LM_ARCHS:
        cfg = lm_cfgs[arch]
        # the last model's params, engines, graph pools and caches freed:
        # what the card holds before each model is what it held before
        # the first
        held = memory_mark()[0] / 2 ** 30
        held_first = held if held_first is None else held_first
        print(f"  {arch}: {held:.3f} GiB allocated on the card before "
              f"its init ({held_first:.3f} before the first LM)")
        if held > held_first + 0.5:
            fail(f"{arch}: {held - held_first:.3f} GiB of an earlier LM "
                 f"still on the card")
        why = lm_cuts[arch][1]
        if why:
            print(f"  {arch}: served cut to {why}")
        t0 = time.perf_counter()
        params = lm.init_lm(cfg, seed=0, device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        param_bytes = sum(t.numel() * t.element_size()
                          for t in tree_tensors(params))
        print(f"  {arch}: init {init_s:.2f} s, {param_bytes / 2 ** 30:.3f} "
              f"GiB of params on the card")
        n_attn = sum(mx == "attn" for mx, _ in cfg.layer_kinds())
        # MLA attends through the plain versions: no flash_attention
        planned = {"flash_attention": 0 if cfg.mla else n_attn * waves,
                   "conv1d_tap": 3 * (cfg.num_layers - n_attn) * waves}
        prompts = rng.integers(0, cfg.vocab_size, (LM_REQUESTS, LM_PROMPT)) \
            .astype(np.int32)
        torch.cuda.synchronize()
        _build.reset_launches()
        # the main run under the profiler, which counts the kernels that
        # ran (the eager first wave's and every replay's), and its peak
        # device memory above the params (engine, cache, graphs' pool)
        base = memory_mark()
        with profiled() as prof:
            done, _, nonfinite, wall, graphs = serve_lm(cfg, params,
                                                        prompts, False)
        peak_graphs = memory_peak(base)
        counts = dict(_build.LAUNCHES)
        traced = traced_launches(prof)
        del prof
        for k in LM_KERNELS:
            launches[k] += counts[k]
        print(f"  {arch}: {cfg.num_params() / 1e9:.3f} B params (init "
              f"{init_s:.1f} s), {len(done)} requests in {wall:.1f} ms "
              f"(profiled); kernels in the trace {traced}; launch counters "
              f"{counts}; planned {planned}; graphs (captures, replays) "
              f"{graphs}")
        if traced != {k: v for k, v in planned.items() if v}:
            fail(f"{arch}: the trace ran {traced} != planned {planned}")
        if len(done) != LM_REQUESTS or any(
                len(r.out_tokens) != LM_NEW
                or not all(0 <= t < cfg.vocab_size for t in r.out_tokens)
                for r in done):
            fail(f"{arch}: not every request got {LM_NEW} tokens in "
                 f"[0, {cfg.vocab_size})")
        if nonfinite:
            fail(f"{arch}: non-finite logits from {sorted(set(nonfinite))}")
        if {k: v for k, v in counts.items() if v} != {
                k: v for k, v in planned.items() if v}:
            fail(f"{arch}: launches {counts} != planned {planned}")
        # wave 1 eager, then captured; wave 2 and every later step replayed
        want_graphs = {str(("prefill", LM_PROMPT)): (1, waves - 1),
                       "decode": (1, waves * (LM_NEW - 1) - 1)}
        if graphs != want_graphs:
            fail(f"{arch}: graphs (captures, replays) {graphs} != "
                 f"{want_graphs}")
        base = memory_mark()
        eager = eager_tokens(cfg, params, prompts)
        peak_eager = memory_peak(base)
        print(f"  {arch}: peak device memory above the params, GiB "
              f"(allocated, reserved): served through graphs "
              f"{peak_graphs}, eager lm.prefill/decode_step {peak_eager}")
        served_toks = {r.rid: r.out_tokens for r in done}
        same = all(served_toks[i] == eager[i] for i in range(LM_REQUESTS))
        print(f"  {arch}: served tokens (graphs) == eager lm.prefill/"
              f"decode_step tokens for all {LM_REQUESTS} requests: {same}")
        if not same:
            fail(f"{arch}: the graphs' tokens differ from the eager tokens")
        done, times, nonfinite, wall, _ = serve_lm(cfg, params, prompts,
                                                   True)
        tokens = sum(len(r.out_tokens) for r in done)

        def call_ms(name, replayed):
            return [t for t, r in times[name] if r == replayed]
        prefill_ms, decode_ms = (call_ms("_prefill", True),
                                 call_ms("_decode", True))
        row = {"params": cfg.num_params(), "param_bytes": param_bytes,
               "layers": cfg.num_layers, "cut": why,
               "held_gib_before_init": held,
               "init_s": init_s, "launches": counts,
               "prefill_ms_per_wave": float(np.median(prefill_ms)),
               "decode_ms_per_step": float(np.median(decode_ms)),
               "prefill_ms": prefill_ms, "decode_ms": decode_ms,
               "eager_then_capture_ms": {
                   "prefill": call_ms("_prefill", False),
                   "decode": call_ms("_decode", False)},
               "run_ms": wall, "tokens": tokens,
               "tokens_per_s": tokens / wall * 1e3,
               "params_read_floor_ms": param_bytes / HBM_BYTES_PER_S * 1e3,
               "sample_tokens": done[0].out_tokens,
               "graph_tokens_equal_eager": same,
               "peak_gib_graphs": peak_graphs,
               "peak_gib_eager": peak_eager}
        report["lm_serve"][arch] = row
        print(f"  {arch} (graph replays, median): prefill "
              f"{row['prefill_ms_per_wave']:.4f} ms per wave of "
              f"{LM_SLOTS}x{LM_PROMPT}, decode "
              f"{row['decode_ms_per_step']:.4f} ms per step of {LM_SLOTS} "
              f"(all-params read floor {row['params_read_floor_ms']:.4f} "
              f"ms; first wave / step eager and captured: "
              f"{row['eager_then_capture_ms']}); {tokens} tokens in "
              f"{wall:.2f} ms = {row['tokens_per_s']:.1f} tokens/s; request "
              f"0 {done[0].out_tokens[:6]}...")
        if cfg.num_experts:
            row.update(moe_checks(arch, cfg, params, prompts))
            print(f"  {arch} decode: {row['decode_ms_per_step']:.4f} ms per "
                  f"step against the expert-read floor "
                  f"{row['decode_expert_floor_ms']:.4f} ms "
                  f"({row['expert_bytes'] / 1e9:.3f} GB of experts at "
                  f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s)")
        row["trace"] = trace_lm(arch, *engine_calls(cfg, params,
                                                    prompts[:LM_SLOTS]),
                                {k: v // waves for k, v in planned.items()
                                 if v})
        decode_idle(arch, row)
        del params
        gc.collect()                # the engines and their graph pools
        torch.cuda.empty_cache()
    for k, v in launches.items():
        if v < 1:
            fail(f"{k} was not launched on the main path")

    # -- 4d'. the LM embeddings path: lm.prefill/decode_step as CUDA graphs ---
    phase(f"main path: the LM embeddings path ({', '.join(LM_EMBED_ARCHS)}; "
          f"bf16, {waves} waves of {LM_SLOTS} x {LM_PROMPT}, {LM_NEW - 1} "
          f"decode steps each, as CUDA graphs)")
    report["lm_embeds"] = {}

    def embeds_waves(cfg, seed):
        """Each wave's inputs, drawn on the card from a seeded generator
        and teacher-forced (no embedding table feeds a sampled token
        back): the prefill's (embeds[, positions]) and each decode step's
        (embeds[, positions], offset).  M-RoPE positions: LM_GRID's image
        grid, then one past it on all three rows, while the cache writes
        at LM_PROMPT, LM_PROMPT + 1, ..."""
        g = torch.Generator(device=dev).manual_seed(seed)

        def draw(n):
            return torch.randn((LM_SLOTS, n, cfg.d_model), generator=g,
                               device=dev).to(torch.bfloat16)
        pos = step_pos = ()
        if cfg.mrope_sections:
            grid, nxt = mrope_grid(*LM_GRID)
            if grid.shape[1] != LM_PROMPT:
                fail(f"LM_GRID {LM_GRID} spans {grid.shape[1]} positions, "
                     f"not the prompt's {LM_PROMPT}")
            pos = (torch.from_numpy(grid).to(dev)[:, None].expand(
                3, LM_SLOTS, LM_PROMPT).contiguous(),)
            step_pos = [(torch.full((3, LM_SLOTS, 1), nxt + t,
                                    dtype=torch.int32, device=dev),)
                        for t in range(LM_NEW - 1)]
        return [((draw(LM_PROMPT),) + pos,
                 [(draw(1),) + (step_pos[t] if step_pos else ())
                  + (LM_PROMPT + t,) for t in range(LM_NEW - 1)])
                for _ in range(waves)]

    def run_embeds(progs, params, cache, calls, timed, traced=None):
        """Every call of the waves ``calls`` through the programs
        (prefill, decode), in order: each call's logits (a copy; none
        where ``timed``), and where ``timed`` its wall ms between
        synchronizes as ``(prefill?, ms, replayed)``; the calls whose
        logits were not finite.  Where ``traced`` (a dict) is given,
        each prefill call runs under the profiler (the card alone) and
        the counted kernels its trace shows are added to it; the decode
        steps, whose replays ``trace_lm`` holds to none, stay untraced
        (musicgen's 14,320 launches a step made a whole run's trace
        some 400,000 records)."""
        outs, times, nonfinite = [], [], []
        for pre, steps in calls:
            for i, (prog, args) in enumerate(
                    [(progs[0], pre)] + [(progs[1], a) for a in steps]):
                if timed:
                    torch.cuda.synchronize()
                before = prog.replays
                t0 = time.perf_counter()
                with (profiled(host=False) if traced is not None and i == 0
                      else contextlib.nullcontext()) as prof:
                    logits = prog(params, cache, *args)
                if prof is not None:
                    for k, n in traced_launches(prof).items():
                        traced[k] = traced.get(k, 0) + n
                if timed:
                    torch.cuda.synchronize()
                    times.append((i == 0, (time.perf_counter() - t0) * 1e3,
                                  prog.replays > before))
                else:
                    outs.append(logits.clone())
                if not bool(torch.isfinite(logits).all()):
                    nonfinite.append(len(outs) + len(times) - 1)
        return outs, times, nonfinite

    for arch in LM_EMBED_ARCHS:
        cfg = lm_cfgs[arch]
        held = memory_mark()[0] / 2 ** 30
        print(f"  {arch}: {held:.3f} GiB allocated on the card before its "
              f"init ({held_first:.3f} before the first LM)")
        if held > held_first + 0.5:
            fail(f"{arch}: {held - held_first:.3f} GiB of an earlier LM "
                 f"still on the card")
        params = lm.init_lm(cfg, seed=0, device=dev)
        param_bytes = sum(t.numel() * t.element_size()
                          for t in tree_tensors(params))
        calls = embeds_waves(cfg, seed=0)
        n_calls = waves * LM_NEW
        planned = {"flash_attention": cfg.num_layers * waves}
        print(f"  {arch}: {cfg.num_params() / 1e9:.3f} B params, "
              f"{param_bytes / 2 ** 30:.3f} GiB on the card; head dim "
              f"{cfg.head_dim}, {cfg.num_heads} heads over "
              f"{cfg.num_kv_heads}; positions "
              f"{'an M-RoPE grid ' + str(LM_GRID) if cfg.mrope_sections else 'from the offset'}")
        _build.reset_launches()
        base = memory_mark()
        progs = embeds_programs(cfg, LM_SLOTS, LM_PROMPT, torch.bfloat16,
                                dev, torch.cuda.graph_pool_handle())
        cache = lm.init_cache(cfg, LM_SLOTS, LM_MAX_LEN, device=dev)
        traced = {}
        t0 = time.perf_counter()
        outs, _, nonfinite = run_embeds(progs, params, cache, calls, False,
                                        traced)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        peak_graphs = memory_peak(base)
        counts = dict(_build.LAUNCHES)
        for k in LM_KERNELS:
            launches[k] += counts[k]
        graphs = {"prefill": (progs[0].captures, progs[0].replays),
                  "decode": (progs[1].captures, progs[1].replays)}
        print(f"  {arch}: {n_calls} calls in {wall:.1f} ms (the prefills "
              f"profiled); kernels in their traces {traced}; launch counters "
              f"{ {k: v for k, v in counts.items() if v} }; planned "
              f"{planned}; graphs (captures, replays) {graphs}")
        if traced != planned:
            fail(f"{arch}: the trace ran {traced} != planned {planned}")
        if {k: v for k, v in counts.items() if v} != planned:
            fail(f"{arch}: launches {counts} != planned {planned}")
        want_graphs = {"prefill": (1, waves - 1),
                       "decode": (1, waves * (LM_NEW - 1) - 1)}
        if graphs != want_graphs:
            fail(f"{arch}: graphs (captures, replays) {graphs} != "
                 f"{want_graphs}")
        if nonfinite:
            fail(f"{arch}: non-finite logits from calls {nonfinite}")
        # the same calls eagerly, on a cache of their own
        base = memory_mark()
        eager_cache = lm.init_cache(cfg, LM_SLOTS, LM_MAX_LEN, device=dev)
        eager = []
        for pre, steps in calls:
            eager.append(progs[0].fn(params, eager_cache, *pre))
            eager += [progs[1].fn(params, eager_cache, *a).clone()
                      for a in steps]
        peak_eager = memory_peak(base)
        del eager_cache
        same = [torch.equal(a, b) for a, b in zip(outs, eager)]
        diff = max((a.float() - b.float()).abs().max().item()
                   for a, b in zip(outs, eager))
        print(f"  {arch}: every call's logits (eager first calls, then "
              f"replays) bit-equal to eager lm.prefill/decode_step: "
              f"{sum(same)} of {len(same)} (max |diff| {diff:.3e}); peak "
              f"device memory above the params, GiB (allocated, reserved): "
              f"through graphs {peak_graphs}, eager {peak_eager}")
        if len(same) != n_calls or not all(same):
            fail(f"{arch}: replayed logits differ from eager ones at calls "
                 f"{[i for i, ok in enumerate(same) if not ok]}")
        del outs, eager
        _, times, nonfinite = run_embeds(progs, params, cache, calls, True)
        if nonfinite:
            fail(f"{arch}: non-finite logits from timed calls {nonfinite}")
        run_ms = sum(ms for _, ms, _ in times)
        prefill_ms = [ms for pre, ms, r in times if pre and r]
        decode_ms = [ms for pre, ms, r in times if not pre and r]
        tokens = waves * LM_SLOTS * LM_NEW
        row = {"params": cfg.num_params(), "param_bytes": param_bytes,
               "layers": cfg.num_layers, "launches": counts,
               "prefill_ms_per_wave": float(np.median(prefill_ms)),
               "decode_ms_per_step": float(np.median(decode_ms)),
               "prefill_ms": prefill_ms, "decode_ms": decode_ms,
               "run_ms": run_ms, "tokens": tokens,
               "tokens_per_s": tokens / run_ms * 1e3,
               "params_read_floor_ms": param_bytes / HBM_BYTES_PER_S * 1e3,
               "graph_logits_equal_eager": True,
               "peak_gib_graphs": peak_graphs, "peak_gib_eager": peak_eager}
        report["lm_embeds"][arch] = row
        print(f"  {arch} (graph replays, median): prefill "
              f"{row['prefill_ms_per_wave']:.4f} ms per wave of "
              f"{LM_SLOTS}x{LM_PROMPT}, decode "
              f"{row['decode_ms_per_step']:.4f} ms per step of {LM_SLOTS} "
              f"(all-params read floor {row['params_read_floor_ms']:.4f} "
              f"ms); {tokens} positions' logits in {run_ms:.2f} ms of calls "
              f"= {row['tokens_per_s']:.1f} a second")
        pre, steps = calls[0]

        def prefill():
            progs[0](params, cache, *pre).float().argmax(-1).cpu()

        def decode():
            for a in steps[:LM_TRACE_STEPS]:
                progs[1](params, cache, *a).float().argmax(-1).cpu()
        row["trace"] = trace_lm(arch, prefill, decode,
                                lambda: progs[0].replays + progs[1].replays,
                                {"flash_attention": cfg.num_layers})
        decode_idle(arch, row)
        del params, progs, cache, calls, prefill, decode
        gc.collect()
        torch.cuda.empty_cache()

    # -- 4e. the LM path, card against CPU, fp32 -------------------------------
    phase(f"LM card vs CPU (fp32, full width, {LM_CPU_LAYERS} layers or "
          f"one longer period, all experts; the CPU side a layer at a "
          f"time)")
    report["lm_card_vs_cpu"] = {}

    def cpu_cut(arch, cfg):
        """The config of ``arch``'s card-vs-CPU check and its cut: the
        first ``LM_CPU_LAYERS`` layers, or one layer period where that is
        longer, every expert kept."""
        period = max(len(kinds) for _, kinds in lm.stack_plan(cfg))
        n = max(period, LM_CPU_LAYERS)
        cut = dataclasses.replace(cfg, num_layers=n)
        experts = (f" with all {cut.num_experts} experts"
                   if cut.num_experts else "")
        return cut, (f"{n} of {get_config(arch).num_layers} layers"
                     f"{' (one period)' if period > LM_CPU_LAYERS else ''}, "
                     f"fp32: {cut.num_params() * 4 / 2 ** 30:.1f} GiB"
                     f"{experts}")

    def cpu_inputs(cfg):
        """The check's teacher-forced inputs, on the host: a prompt of
        LM_CPU_BATCH x LM_CPU_PROMPT, then LM_CPU_STEPS one-position
        steps.  Tokens from ``rng``; embeddings from a seeded generator;
        M-RoPE positions LM_CPU_GRID's image grid, then one past it on
        all three rows, while the cache writes at LM_CPU_PROMPT on."""
        n, B, S = LM_CPU_STEPS + 1, LM_CPU_BATCH, LM_CPU_PROMPT
        if cfg.input_mode == "tokens":
            toks = torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (n, B, S)).astype(np.int32))
            return [{"tokens": toks[0]}] + [{"tokens": toks[t, :, :1]}
                                            for t in range(1, n)]
        embeds = torch.randn((n, B, S, cfg.d_model),
                             generator=torch.Generator().manual_seed(0))
        out = [{"embeds": embeds[0]}] + [{"embeds": embeds[t, :, :1]}
                                         for t in range(1, n)]
        if cfg.mrope_sections:
            grid, nxt = mrope_grid(*LM_CPU_GRID)
            if grid.shape[1] != S:
                fail(f"LM_CPU_GRID {LM_CPU_GRID} spans {grid.shape[1]} "
                     f"positions, not the prompt's {S}")
            out[0]["positions"] = torch.from_numpy(grid)[:, None].expand(
                3, B, S).contiguous()
            for t in range(1, n):
                out[t]["positions"] = torch.full((3, B, 1), nxt + t - 1,
                                                 dtype=torch.int32)
        return out

    def compare_routing(arch, card, cpu):
        """Each MoE call's top-K expert sets and kept tokens, card against
        CPU, by (MoE layer, step).  A token whose expert set differs must
        have its K-th and (K+1)-th CPU probabilities within
        ROUTE_FLIP_GAP."""
        if sorted(card) != sorted(cpu):
            fail(f"{arch}: MoE calls (layer, step) {sorted(card)} on the "
                 f"card, {sorted(cpu)} on the CPU")
        flips, kept_diff, gaps = 0, 0, []
        for key, b in sorted(cpu.items()):
            a = card[key]
            diff = (a["experts"] != b["experts"]).any(-1)
            flips += int(diff.sum())
            top = b["probs"].sort(-1, descending=True).values
            K = a["experts"].shape[-1]
            gap = top[:, K - 1] - top[:, K]
            gaps += gap[diff].tolist()
            kept_diff += int((a["kept"] != b["kept"]).any(0).sum())
        n_experts = next(iter(cpu.values()))["probs"].shape[-1]
        print(f"  {arch}: routing over {len(cpu)} MoE calls of "
              f"{n_experts} experts: {flips} token(s) with another top-K "
              f"expert set on the card (CPU gaps between the K-th and "
              f"(K+1)-th probabilities {gaps}); {kept_diff} token(s) kept "
              f"by another expert set")
        if any(g > ROUTE_FLIP_GAP for g in gaps):
            fail(f"{arch}: a token routed differently on the card with a "
                 f"probability gap above {ROUTE_FLIP_GAP}: {gaps}")
        return {"moe_calls": len(cpu), "experts": n_experts,
                "topk_flips": flips, "flip_gaps": gaps,
                "kept_differs": kept_diff}

    for arch in LM_ARCHS + LM_EMBED_ARCHS:
        cut, why = cpu_cut(arch, lm_cfgs[arch])
        # drawn on the card; the CPU side copies it a layer at a time
        params = lm.init_lm(cut, seed=0, device=dev, dtype=torch.float32)
        inputs = cpu_inputs(cut)
        max_len = LM_CPU_PROMPT + LM_CPU_STEPS
        routes = RoutingLog(), RoutingLog()
        t0 = time.perf_counter()
        with routes[0]:
            got = stepwise_logits(params, cut, inputs, max_len, dev,
                                  routes[0])
        card_s = time.perf_counter() - t0
        rss, before = host_rss_gib(), host_peak_gib()
        t0 = time.perf_counter()
        with routes[1]:
            want = layerwise_cpu_logits(params, cut, inputs, max_len,
                                        routes[1])
        cpu_s, after = time.perf_counter() - t0, host_peak_gib()
        # the process's peak only rises: where it did not, this side
        # stayed at or under the peak of an earlier one
        print(f"  {arch}: card vs CPU cut to {why}; the CPU side one layer "
              f"at a time: resident set {rss:.2f} GiB before it, the "
              f"process's peak {before:.2f} -> {after:.2f} GiB")
        routing = (compare_routing(arch, routes[0].calls, routes[1].calls)
                   if cut.num_experts else None)
        errs = []
        for step, (a, b) in enumerate(zip(got, want)):
            err = (a - b).abs().max().item()
            bound = LM_CPU_TOL * b.abs().max().item()
            errs.append({"step": step, "max_abs_err": err, "bound": bound})
            if not (err <= bound and bool(torch.isfinite(a).all())):
                fail(f"{arch} ({cut.num_layers} layers, fp32): card vs CPU "
                     f"{'prefill' if step == 0 else f'decode {step}'} "
                     f"{err:.3e} > {bound:.3e}")
        report["lm_card_vs_cpu"][arch] = {
            "logits": errs, "routing": routing, "cut": why,
            "card_s": card_s, "cpu_s": cpu_s,
            "host_rss_gib_before": rss,
            "host_peak_rss_gib": (before, after)}
        print(f"  {arch}: prefill + {LM_CPU_STEPS} decode steps, max|card - "
              f"cpu| {max(e['max_abs_err'] for e in errs):.3e} (bounds "
              f"{min(e['bound'] for e in errs):.3e}..); card "
              f"{card_s:.2f} s, cpu {cpu_s:.2f} s")
        del params, got, want, routes
        gc.collect()
        torch.cuda.empty_cache()

    # -- 4f. training: full size, card vs CPU, trainer, checkpoint served ---
    phase(f"training: {TRAIN_ARCH} at full size in bf16, card vs CPU, the "
          f"trainer, checkpoints, the checkpoint served, the launcher")
    training_phase(dev, report, launches, profiled, get_config)

    # -- 4g. training on a mesh: a world-size-1 NCCL group, a (1, 1) mesh --
    phase(f"training on a mesh: make_debug_mesh() (1, 1) over a one-rank "
          f"NCCL group; {TRAIN_ARCH} mesh vs unsharded, compressed_psum, "
          f"the mesh checkpoint served, the launcher")
    mesh_training_phase(dev, report, launches, profiled, get_config)

    # -- 4h. the analysis: the dry-run's counts held to the card --------------
    phase(f"analysis: {TRAIN_ARCH}'s training step and a prefill wave "
          f"counted on meta and on the card, the roofline with the H100's "
          f"published peaks, the dry-run CLI on the pod mesh")
    analysis_phase(dev, report, launches, get_config)

    # -- 5. timing -------------------------------------------------------------
    phase("timing (CUDA graph replays between CUDA events)")
    assert not torch.backends.cuda.matmul.allow_tf32

    # device ms of one fn(): calls captured in one CUDA graph and replayed
    # between two events, so the wrapper's host work is not in the
    # interval (the harness the autotune sweep times its candidates with)
    time_ms = autotune.device_ms

    def eager_ms(fn, reps=50):
        """``(ms, host_ms)`` of one eager ``fn()`` called back to back:
        events around the calls, and the host's time to issue one call
        (the floor under any eager time)."""
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host = (time.perf_counter() - t0) * 1e3 / reps
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps, host

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts if t is not None)

    def conv_call(x, w, stride, padding, bias):
        xn = x.permute(0, 3, 1, 2)
        wn = w.permute(3, 2, 0, 1).contiguous()

        def conv():
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                return torch.nn.functional.conv2d(xn, wn, bias, stride,
                                                  padding)
        return conv

    def library_call(c):
        """One PyTorch call computing the kernel's function (without a
        fused pool or add), or None where there is none."""
        kname, args, kw = c["kernel"], c["args"], c["kw"]
        if kname in ("cuconv_fused", "winograd_fused", "direct_conv"):
            return conv_call(*args, kw.get("stride", (1, 1)), kw["padding"],
                             kw.get("bias"))
        if kname == "conv1x1_gemm":
            return lambda: torch.matmul(*args)
        if kname == "stage1_tap_gemm":
            # torch.matmul over the stacked tap views (the stack is made
            # here, outside the timed call)
            xp, w4 = args
            kh, kw_, C, M = w4.shape
            xs = cuconv_stage1.stack_taps(xp, kh, kw_).contiguous()
            wt = w4.reshape(kh * kw_, C, M)
            return lambda: torch.matmul(xs, wt)
        if kname == "int8_gemm":
            a, b = args
            if a.dim() == 4:
                # the conv entry: torch._int_mm on its codes' patch matrix
                # (quantized and stacked here, outside the timed call)
                M, kh, kw_, C = b.shape
                if a.dtype != torch.int8:
                    a = symmetric.quantize_to_int8(a, kw["scale"])
                a = int8_gemm.conv_patches(a, kh, kw_, kw["stride"],
                                           kw["padding"]).contiguous()
                b = b.reshape(M, -1).t().contiguous()
            (P, K), M = a.shape, b.shape[1]
            if P > 16 and K % 8 == 0 and M % 8 == 0:
                return lambda: torch._int_mm(a, b)
            return None
        if kname == "flash_attention":
            q, k, v = (t.transpose(1, 2).contiguous() for t in args)
            return lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True)
        if kname == "conv1d_tap":
            x, w, b = args
            xt = x.transpose(1, 2).contiguous()           # (B, D, L)
            wt = w.t().unsqueeze(1).contiguous()          # (D, 1, K)

            def conv1d():
                with torch.backends.cudnn.flags(enabled=True,
                                                allow_tf32=False):
                    return F.conv1d(xt, wt, b, padding=w.shape[0] - 1,
                                    groups=x.shape[2])[..., :x.shape[1]]
            return conv1d
        return lambda: torch.sum(args[0], dim=0)

    def int8_composition(c):
        """The int8 executor's eager steps before it was one launch, at a
        conv entry's call: quantize x and the filter, pad and stack the
        tap views, the GEMM (the stacked entry), the fp32 epilogue."""
        (x, wq), kw = c["args"], c["pkw"]
        M, kh, kw_, C = wq.shape
        w = (wq.float() * kw["w_scales"].view(M, 1, 1, 1)).permute(
            1, 2, 3, 0).contiguous()

        def run():
            ws = symmetric.channel_scales(w)
            xq = symmetric.quantize_to_int8(x, kw["scale"])
            acc = int8_gemm.int8_gemm(
                int8_gemm.conv_patches(xq, kh, kw_, kw["stride"],
                                       kw["padding"]),
                symmetric.quantize_to_int8(w, ws).reshape(-1, M))
            y = acc.float().reshape(x.shape[0], -1, M) * (kw["scale"] * ws)
            if kw["bias"] is not None:
                y = y + kw["bias"]
            if kw["addend"] is not None:
                y = y + kw["addend"].reshape(y.shape)
            return torch.relu(y) if kw["relu"] else y
        return run

    # every kernel call of the main paths once (the stage-1 stack and the
    # int8 conv entry on codes are checked above, not timed), and the int8
    # kernel's stacked entry beside its conv entry
    timed = [c for c in cases(torch.float32) + int8_cases()
             if (c["kernel"] in ("winograd_fused", "direct_conv",
                                 "int8_gemm")
                 or not c["label"].startswith("resnet32"))
             and not (c["label"].endswith(":stacked")
                      and c["kernel"] == "stage1_tap_gemm")
             and not c["label"].endswith(":codes")]
    timed += lm_cases(torch.bfloat16) + lm_cases(torch.float32)
    # the floor under every row: an empty kernel (one block of 32 threads,
    # from the stage-2 library) in the same harness
    floor_ms = time_ms(lambda: cuconv_stage2.empty_launch(dev))
    report["launch_floor_ms"] = floor_ms
    print(f"  launch floor: an empty kernel {floor_ms:.6f} ms per launch "
          f"(CUDA graph replays, as every row below)")
    totals = {}
    for c in timed:
        kname, label, kfn, args, kw = (c["kernel"], c["label"], c["kfn"],
                                       c["args"], c["kw"])
        out = kfn(*args, **kw)
        moved = nbytes(*args, out, kw.get("bias"), kw.get("addend"))
        t_bytes = moved / HBM_BYTES_PER_S * 1e3
        t_ops = c["ops"] / c["peak"] * 1e3
        eager, host = eager_ms(lambda: kfn(*args, **kw))
        lib = library_call(c)
        geo = geometry(c)
        row = {"kernel": kname, "shape": label,
               "dtype": str(args[0].dtype)[6:],
               "config": {k: v for k, v in kw.items()
                          if k in ("m", "tt", "tm", "tc", "tp", "rows")},
               "geometry": geo,
               "ms": time_ms(lambda: kfn(*args, **kw)),
               "eager_ms": eager, "host_ms_per_call": host,
               "plain_ms": time_ms(lambda: c["pfn"](*args, **c["pkw"])),
               "library_ms": time_ms(lib) if lib is not None else None,
               "launch_floor_ms": floor_ms,
               "bytes": moved, "ops": c["ops"],
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        if kname == "int8_gemm" and args[0].dim() == 4:
            comp = int8_composition(c)
            row["composition_ms"] = time_ms(comp)
            row["composition_eager_ms"], _ = eager_ms(comp)
            print(f"  {'':16s} {label:28s} the eager composition it "
                  f"replaces: {row['composition_ms']:.6f} ms (eager "
                  f"{row['composition_eager_ms']:.6f})")
        report["shapes"].append(row)
        lib_s = (f"{row['library_ms']:.6f}" if lib is not None
                 else "none")
        shape_s = (f"plan {row['config']} (sizes nothing); launched "
                   f"{geo}" if geo is not None else f"{row['config']}")
        print(f"  {kname:16s} {label:28s} {row['dtype']:8s} "
              f"{row['ms']:.6f} ms  eager "
              f"{eager:.6f} (host {host:.6f})  plain {row['plain_ms']:.6f}"
              f"  library {lib_s}  bound {row['bound_ms']:.6f} "
              f"({row['bound_by']})  floor {floor_ms:.6f}  {shape_s}")
        if not c["in_line"]:
            continue
        tot = totals.setdefault(kname, {"ms": 0.0, "plain_ms": 0.0,
                                        "library_ms": 0.0, "library_n": 0,
                                        "bytes": 0, "ops": 0, "n": 0,
                                        "peak": c["peak"]})
        for k in ("ms", "plain_ms", "bytes", "ops"):
            tot[k] += row[k]
        if lib is not None:
            tot["library_ms"] += row["library_ms"]
            tot["library_n"] += 1
        tot["n"] += 1

    sources = {"cuconv_fused": ("src/repro_torch/csrc/cuconv_fused.cu",
                                "src/repro/kernels/cuconv_fused.py:216"),
               "conv1x1_gemm": ("src/repro_torch/csrc/conv1x1.cu",
                                "src/repro/kernels/conv1x1.py:39"),
               "stage1_tap_gemm": ("src/repro_torch/csrc/cuconv_stage1.cu",
                                   "src/repro/kernels/cuconv_stage1.py:42"),
               "stage2_tap_sum": ("src/repro_torch/csrc/cuconv_stage2.cu",
                                  "src/repro/kernels/cuconv_stage2.py:28"),
               "winograd_fused": ("src/repro_torch/csrc/winograd_fused.cu",
                                  "src/repro/kernels/winograd_pallas.py:148"),
               "direct_conv": ("src/repro_torch/csrc/direct_conv.cu",
                               "src/repro/kernels/direct_conv.py:84"),
               "int8_gemm": ("src/repro_torch/csrc/int8_gemm.cu",
                             "src/repro/kernels/int8_gemm.py:46"),
               "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:74"),
               "conv1d_tap": ("src/repro_torch/csrc/conv1d_tap.cu",
                              "src/repro/kernels/conv1d_tap.py:36")}
    work_dtype = {"int8_gemm": "int8", "flash_attention": "bf16",
                  "conv1d_tap": "bf16"}
    line = []
    for kname, (src, replaces) in sources.items():
        tot = totals[kname]
        t_bytes = tot["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = tot["ops"] / tot["peak"] * 1e3
        work = work_dtype.get(kname, "fp32")
        line.append({"name": kname, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[kname],
                     "max_abs_err": max_err[kname], "ms": tot["ms"],
                     "plain_ms": tot["plain_ms"], "bound_ms":
                     max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops
                     else "operations",
                     "library_ms": (tot["library_ms"] if tot["library_n"]
                                    else None),
                     "launch_floor_ms": floor_ms * tot["n"],
                     "work": f"{work}, sum over {tot['n']} main-path shapes"
                             + (f" (library call at {tot['library_n']})"
                                if tot["library_n"] != tot["n"] else "")})
    # int8_gemm's line is its conv entry, the executor's one launch; its
    # stacked entry and the eager composition it replaced ride beside it
    i8 = next(e for e in line if e["name"] == "int8_gemm")
    i8_rows = [r for r in report["shapes"] if r["kernel"] == "int8_gemm"]
    i8["stacked_ms"] = sum(r["ms"] for r in i8_rows
                           if r["shape"].endswith(":stacked"))
    i8["composition_ms"] = sum(r.get("composition_ms", 0.0)
                               for r in i8_rows)
    i8["work"] += (" (conv entry: fp32 in, quantized on load, fp32 "
                   "epilogue)")
    # stage 2 beside its launch floor and its time before the redesign
    # (a constant, printed here and kept out of the kernels line)
    s2 = next(e for e in line if e["name"] == "stage2_tap_sum")
    print(f"  stage2_tap_sum: {s2['ms']:.6f} ms over "
          f"{totals['stage2_tap_sum']['n']} shapes; launch floor "
          f"{s2['launch_floor_ms']:.6f} ms; before the redesign "
          f"{STAGE2_EARLIER_MS:.6f} ms; bound {s2['bound_ms']:.6f} ms")
    # its two bodies at the main path's taps: the unrolled one the wrapper
    # launches and the runtime-T loop, timed unrolled, loop, loop, unrolled
    report["stage2_bodies"] = {}
    for c in timed:
        if c["kernel"] != "stage2_tap_sum" or not c["in_line"]:
            continue
        temps = c["args"][0]
        ms = {True: [], False: []}
        for unroll in (True, False, False, True):
            ms[unroll].append(time_ms(
                lambda u=unroll: cuconv_stage2.stage2_tap_sum(
                    temps, unroll=u, **c["kw"])))
        body = {"T": temps.shape[0], "unrolled_ms": ms[True],
                "loop_ms": ms[False]}
        report["stage2_bodies"][c["label"]] = body
        print(f"  stage2_tap_sum {c['label']} (T = {temps.shape[0]}): "
              f"unrolled {ms[True]} ms, runtime-T loop {ms[False]} ms")
    report["kernels"] = line

    # -- 6. launch-config check: the fused, direct and two-stage kernels'
    # geometry is their own, so every feasible candidate of their
    # executors launches the same one (and gives the same bits)
    phase("launch-config check of the fused, direct, two-stage and int8 "
          "executors")
    probe = dict(node_plans + [(lb, p) for lb, p, _ in paper_plans])

    def fused_call(p):
        args, kw = fused_args(p, torch.float32)
        _, oh, _, m = p.spec.out_shape
        return lambda cfg: cuconv_fused.cuconv_fused(
            *args, **dict(kw, tm=min(cfg["tm"], m),
                          rows=min(cfg["rows"], oh)))

    def direct_call(p):
        s = p.spec
        x, w = randn(s.in_shape), randn(s.filter_shape)
        return lambda cfg: direct_conv.direct_conv(
            x, w, s.padding, s.stride, tm=cfg["tm"], tc=cfg["tc"])

    def two_stage_call(p):
        (xp, w4), _ = two_stage_inputs(p, torch.float32)
        return lambda cfg: cuconv_stage1.stage1_tap_conv(xp, w4, **cfg)

    def int8_call(p):
        node = next(lb for lb, q in node_plans if q is p)
        c = next(c for c in int8_cases() if c["label"] == node)
        return lambda cfg: int8_gemm.int8_conv(*c["args"],
                                               **dict(c["pkw"], **cfg))

    # executor, library, launcher, the launcher's geometry arguments, the
    # shapes probed, and a call under a config on operands made once
    probes = (("cuconv_pallas", "cuconv_fused", "cuconv_fused_launch",
               slice(25, 34), ("t4_A", "t4_B", "resnet224b1:stem",
                               "resnet224b1:b1c1"), fused_call),
              ("direct", "direct_conv", "direct_conv_launch", slice(19, 30),
               ("t4_B:direct",), direct_call),
              ("cuconv_two_stage_pallas", "cuconv_stage1",
               "stage1_tap_gemm_launch", slice(15, 21),
               ("t4_A:two_stage",), two_stage_call),
              ("cuconv_int8", "int8_gemm", "int8_gemm_launch",
               slice(22, 29), ("resnet32b4:int8:b1c1",
                               "resnet32b1:int8:b2c2"), int8_call))
    report["config_check"] = []
    for ex_name, lib_name, fn_name, geo_args, labels, make_call in probes:
        ex = executors.get(ex_name)
        lib = _build.library(lib_name)
        launcher = getattr(lib, fn_name)
        seen = []

        def recording(*a, launcher=launcher, geo_args=geo_args):
            seen.append(tuple(a[geo_args]))
            return launcher(*a)
        setattr(lib, fn_name, recording)
        try:
            for label in labels:
                p = probe[label]
                if p.algorithm != ex_name:
                    fail(f"{label}: planned {p.algorithm}, not {ex_name}")
                call = make_call(p)
                launched, outs = set(), []
                for cfg in ex.configs(p.spec):
                    if not ex.config_supports(p.spec, cfg)[0]:
                        continue
                    seen.clear()
                    outs.append(call(cfg.as_dict()))
                    launched |= set(seen)
                torch.cuda.synchronize()
                same_bits = all(torch.equal(outs[0], o) for o in outs[1:])
                report["config_check"].append({
                    "executor": ex_name, "shape": label,
                    "candidates": len(outs), "launches": sorted(launched),
                    "same_bits": same_bits})
                print(f"  {ex_name:24s} {label:20s} {len(outs)} feasible "
                      f"candidates launch {sorted(launched)}; outputs "
                      f"bit-identical: {same_bits}")
                if len(launched) != 1 or not same_bits:
                    fail(f"{ex_name} {label}: the executor's candidates "
                         f"launch {sorted(launched)} (same bits: "
                         f"{same_bits})")
        finally:
            setattr(lib, fn_name, launcher)

    # -- serving helpers of phases 7 and 8 ----------------------------------
    def per_batch_launches(eng):
        """Kernel launches per batch of each bucket, from its plans."""
        out = {}
        for b in eng.buckets:
            out[b] = {}
            for p in eng.programs.plan(b).conv_plans.values():
                for k in p.executor.kernels:
                    out[b][k] = out[b].get(k, 0) + 1
        return out

    def serve_checked(label, eng, ref, shape, sizes):
        """Serve requests of ``sizes`` images through the warm engine
        under the profiler and through ``ref``; fails unless the trace
        counts the plans' kernels, the counters agree, no plan() is
        resolved, each bucket's replay equals its eager program bit for
        bit, and the outputs match ``ref``'s within SERVE_TOL of their abs
        max.  Returns the served requests."""
        per_batch = per_batch_launches(eng)
        before = dict(eng.stats["batches"])
        for i, n in enumerate(sizes):
            im = rng.normal(size=(n,) + shape).astype(np.float32)
            eng.submit(ImageRequest(i, im))
            ref.submit(ImageRequest(i, im))
        torch.cuda.synchronize()
        convspec.reset_plan_stats()
        _build.reset_launches()
        with profiled() as prof:
            done = eng.run()
            torch.cuda.synchronize()
        counts = {k: v for k, v in _build.LAUNCHES.items() if v}
        traced = traced_launches(prof)
        want = {}
        for b, n in eng.stats["batches"].items():
            for k, v in per_batch[b].items():
                if n - before[b]:
                    want[k] = want.get(k, 0) + (n - before[b]) * v
        print(f"  {label}: batches {eng.stats['batches']}; kernels in the "
              f"trace {traced}; launch counters {counts}; planned {want}; "
              f"plan() resolutions {convspec.PLAN_STATS['resolutions']}")
        if traced != want or counts != want:
            fail(f"{label}: the trace ran {traced} (counters {counts}) != "
                 f"planned {want}")
        if convspec.PLAN_STATS["resolutions"]:
            fail(f"{label}: a warm engine resolved a plan")
        for b in eng.buckets:
            xb = rng.normal(size=(b,) + shape).astype(np.float32)
            want_y = eng.programs.fn(b)(eng.params, eng.programs.put(xb))
            got_y = eng.programs.serve_batch(b, xb).clone()
            torch.cuda.synchronize()
            if not torch.equal(got_y, want_y):
                fail(f"{label} bucket {b}: the graph's replay differs from "
                     f"the eager program")
        ref_done = ref.run()
        for a, r in zip(done, ref_done):
            if a.out.shape != r.out.shape or not np.isfinite(a.out).all():
                fail(f"{label} request {a.rid}: bad output")
            err = float(np.abs(a.out - r.out).max())
            bound = SERVE_TOL * float(np.abs(r.out).max())
            if not err <= bound:
                fail(f"{label} request {a.rid}: {err:.3e} from the "
                     f"reference > {bound:.3e}")
        print(f"  {label}: outputs within {SERVE_TOL} of the reference's "
              f"abs max; each bucket's replay == its eager program")
        return done

    def use_cache(path, fresh=False):
        """Point the persisted plan stores at ``path`` (emptied first if
        ``fresh``) and drop their in-memory mirrors."""
        if fresh:
            shutil.rmtree(path, ignore_errors=True)
        os.environ["REPRO_CACHE_DIR"] = str(path)
        autotune.clear_cache()
        tgraph.clear_cache()

    def to_cpu(tree):
        if isinstance(tree, torch.Tensor):
            return tree.cpu()
        if isinstance(tree, dict):
            return {k: to_cpu(v) for k, v in tree.items()}
        return [to_cpu(v) for v in tree]

    def failed_kernels(stats):
        """The hand-written executors among a sweep's failed candidates."""
        return [r for r in stats["failed"]
                if executors.get(r["algorithm"].split("+")[0]).kernels]

    untuned_cache = os.environ["REPRO_CACHE_DIR"]
    cache_root = ROOT / "build" / "chip_smoke_cache"

    # -- 7. measured autotuning: the paper's race, then tuned serving --------
    phase("measured autotuning on the card (tune='algo' on the paper's "
          "rows, tune='full' on served resnet_like)")
    use_cache(cache_root / "tuned", fresh=True)
    report["tuning"] = {"rows": {}}
    race = [(label, convspec.ConvSpec(
        (n, hw, hw, c), (k, k, c, m), padding=((k - 1) // 2,) * 2))
        for label, (hw, n, k, m, c) in PROFILED.items()]
    race += [(label, convspec.ConvSpec((8, hw, hw, c), (k, k, c, m),
                                       padding=(1, 1)))
             for label, ((hw, k, m, c), _) in WINOGRAD_ROWS.items()]
    mem0 = torch.cuda.memory_reserved()
    t_race = time.perf_counter()
    for label, spec in race:
        autotune.reset_measure_stats()
        p = convspec.plan(spec, tune="algo")
        stats = autotune.reset_measure_stats()
        times = {r["algorithm"]: r["ms"] for r in stats["timed"]}
        hand = {n for n in executors.supporting(spec)
                if executors.get(n).kernels}
        if failed_kernels(stats):
            fail(f"race {label}: hand-written candidates failed: "
                 f"{failed_kernels(stats)}")
        if not hand <= set(times) or "lax" not in times:
            fail(f"race {label}: timed {sorted(times)}, not every "
                 f"hand-written executor {sorted(hand)} and lax")
        if p.source != "measured" or times[p.algorithm] != min(
                times.values()):
            fail(f"race {label}: planned {p.algorithm} [{p.source}], not "
                 f"the fastest of {times}")
        x, w = randn(spec.in_shape), randn(spec.filter_shape)
        y = p(x, w)
        want = cuconv.conv_lax(x, w, stride=spec.stride,
                               padding=spec.padding)
        err = (y - want).abs().max().item()
        tol = 2e-3 if p.config.get("m") == 4 else 3e-4
        bound = tol * max(1.0, want.abs().max().item())
        if not err <= bound:
            fail(f"race {label}: the winner {p.algorithm} is {err:.3e} "
                 f"from F.conv2d > {bound:.3e}")
        autotune.clear_cache()          # a later process reads the file
        again = convspec.plan(spec, tune="algo")
        replay = autotune.reset_measure_stats()
        if again.algorithm != p.algorithm or any(replay.values()):
            fail(f"race {label}: the replay planned {again.algorithm} and "
                 f"measured {replay}")
        ratio = times[p.algorithm] / times["lax"]
        report["tuning"]["rows"][label] = {
            "spec": spec.key(), "device_ms": times, "winner": p.algorithm,
            "config": p.config.as_dict(), "winner_over_lax": ratio,
            "failed": stats["failed"], "max_abs_err": err}
        print(f"  {label:14s} winner {p.algorithm:24s} "
              f"{times[p.algorithm]:.6f} ms = {ratio:.3f}x cuDNN "
              f"({times['lax']:.6f} ms); max|y-F.conv2d| {err:.2e}; "
              f"replayed with no measurement")
        print("      " + "  ".join(f"{a} {t:.6f}" for a, t in sorted(
            times.items(), key=lambda kv: kv[1])))
        for r in stats["failed"]:
            print(f"      failed (not a kernel): {r['algorithm']}: "
                  f"{r['error']}")
    torch.cuda.synchronize()
    report["tuning"]["race_s"] = time.perf_counter() - t_race
    report["tuning"]["reserved_growth_gib"] = (
        torch.cuda.memory_reserved() - mem0) / 2 ** 30
    print(f"  race: {report['tuning']['race_s']:.1f} s; reserved memory "
          f"{report['tuning']['reserved_growth_gib']:+.3f} GiB over it")

    # tune="full" on a row whose winner has launch configs that change the
    # launch: Winograd's F(2,3) against F(4,3).  Where the race gave the
    # row to another executor in this run, Winograd is pinned, so its
    # config race runs on the card all the same.
    label = "r50_56x56x64"
    spec = dict(race)[label]
    p = convspec.plan(spec, tune="full")
    if p.algorithm != "winograd_pallas":
        p = convspec.plan(spec, tune="full", force="winograd_pallas")
    stats = autotune.reset_measure_stats()
    cfg_times = [(r["config"], r["ms"]) for r in stats["timed"]
                 if r["kind"] == "config"]
    variants = sorted({c["m"] for c, _ in cfg_times})
    print(f"  {label} tune='full': {p.algorithm} [{p.source}] config "
          f"{p.config.as_dict()} [{p.config_source}]; "
          f"{stats['config_sweeps']} config race over "
          f"{len(cfg_times)} launches: " + "  ".join(
              f"{c} {t:.6f}" for c, t in sorted(cfg_times,
                                                key=lambda ct: ct[1])))
    fastest = min(cfg_times, key=lambda ct: ct[1])[0] if cfg_times else None
    if stats["config_sweeps"] != 1 or variants != [2, 4] or \
            p.config.as_dict() != fastest or p.config_source != "measured":
        fail(f"{label} tune='full': config races "
             f"{stats['config_sweeps']}, F(m,3) variants timed {variants}, "
             f"planned {p.config.as_dict()} [{p.config_source}], fastest "
             f"{fastest}")
    x, w = randn(spec.in_shape), randn(spec.filter_shape)
    want = cuconv.conv_lax(x, w, stride=spec.stride, padding=spec.padding)
    err = (p(x, w) - want).abs().max().item()
    bound = 2e-3 * max(1.0, want.abs().max().item())
    if not err <= bound:
        fail(f"{label} tune='full': the winner {p.algorithm} "
             f"{p.config.as_dict()} is {err:.3e} from F.conv2d > "
             f"{bound:.3e}")
    autotune.clear_cache()
    force = None if p.source == "measured" else p.algorithm
    again = convspec.plan(spec, tune="full", force=force)
    replay = autotune.reset_measure_stats()
    if (again.algorithm, again.config) != (p.algorithm, p.config) or \
            any(replay.values()):
        fail(f"{label} tune='full': the replay planned {again.algorithm} "
             f"{again.config.as_dict()} and measured {replay}")
    print(f"  {label} tune='full': max|y-F.conv2d| {err:.2e} (bound "
          f"{bound:.2e}); replayed with no measurement")
    report["tuning"]["config_race"] = {
        "row": label, "algorithm": p.algorithm, "source": p.source,
        "config": p.config.as_dict(), "device_ms": cfg_times,
        "max_abs_err": err}

    shape224 = (224, 224, 3)
    untuned = engines[("fp32", shape224)]
    params = untuned.params           # resnet_like's (the LM's went)
    tuned = CnnServeEngine(resnet_like(num_classes=10), params, shape224,
                           buckets=(1,))
    ref224 = CnnServeEngine(model, params_cpu, shape224, buckets=(1,),
                            device="cpu", backend="cuda")
    t0 = time.perf_counter()
    tuned.warmup(tune="full")
    stats = autotune.reset_measure_stats()
    tune_s = time.perf_counter() - t0
    if failed_kernels(stats):
        fail(f"tuned serving: hand-written candidates failed: "
             f"{failed_kernels(stats)}")
    gp = tuned.programs.plan(1)
    print(gp.explain())
    verdicts = {}
    for r in stats["timed"]:
        if r["kind"] == "fusion":
            verdicts.setdefault(r["spec"], {})[r["algorithm"]] = r["ms"]
    for key, t in verdicts.items():
        print(f"  fusion {key}: {t}")
    nodes = {}
    for node in gp.graph.conv_nodes:
        p = gp.conv_plans[node.name]
        v = autotune.fusion_verdict(node.spec) if node.spec.has_fusion \
            else None
        nodes[node.name] = {"algorithm": p.algorithm, "source": p.source,
                            "config": p.config.as_dict(),
                            "fused": gp.fused.get(node.name),
                            "fusion_wins": v}
        print(f"  tuned {node.name:8s} {p.algorithm:24s} [{p.source}] "
              f"cfg {p.config.as_dict()} fused {gp.fused.get(node.name)} "
              f"verdict {v}")
    print(f"  tune='full' warmup: {tune_s:.1f} s, "
          f"{stats['algo_sweeps']} algorithm, {stats['config_sweeps']} "
          f"config and {stats['fusion_sweeps']} fusion sweeps, "
          f"{len(stats['timed'])} timings")
    tuned_out = serve_checked("tuned resnet_like 224x224", tuned, ref224,
                              shape224, [1, 1])
    for i in range(2):
        im = rng.normal(size=(1,) + shape224).astype(np.float32)
        untuned.submit(ImageRequest(i, im))
        tuned.submit(ImageRequest(i, im))
    a_out = np.concatenate([r.out for r in untuned.run()])
    b_out = np.concatenate([r.out for r in tuned.run()])
    rel = float(np.abs(a_out - b_out).max() / np.abs(a_out).max())
    print(f"  tuned vs untuned engine: max|d| / max|untuned| = {rel:.3e}")
    if not rel <= SERVE_TOL:
        fail(f"tuned serving differs from untuned by {rel:.3e} of its abs "
             f"max > {SERVE_TOL}")
    # a second engine over the same cache: zero measurement, zero plans
    use_cache(cache_root / "tuned")
    convspec.reset_plan_stats()
    second = CnnServeEngine(resnet_like(num_classes=10), params, shape224,
                            buckets=(1,))
    second.warmup(tune="full")
    again = autotune.reset_measure_stats()
    plans2 = {n: (p.algorithm, p.config)
              for n, p in second.programs.plan(1).conv_plans.items()}
    print(f"  second engine over the cache: measurements {again}, plan() "
          f"resolutions {convspec.PLAN_STATS['resolutions']}")
    if any(again.values()) or convspec.PLAN_STATS["resolutions"] or \
            plans2 != {n: (p.algorithm, p.config)
                       for n, p in gp.conv_plans.items()}:
        fail("a second engine over the tuned cache measured, resolved a "
             "plan, or serves other plans")
    windows = {"untuned": [], "tuned": []}
    pool = rng.standard_normal((1,) + shape224, dtype=np.float32)
    for kind in ("untuned", "tuned", "tuned", "untuned"):
        eng = untuned if kind == "untuned" else tuned
        for i in range(WINDOW_REQUESTS):
            eng.submit(ImageRequest(i, pool))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        windows[kind].append((time.perf_counter() - t0) * 1e3
                             / WINDOW_REQUESTS)
    print(f"  served 224x224 bucket 1, ms per batch over windows of "
          f"{WINDOW_REQUESTS} (untuned, tuned, tuned, untuned): untuned "
          f"{windows['untuned']}, tuned {windows['tuned']}")
    report["tuning"]["resnet224"] = {
        "nodes": nodes, "fusion_ms": verdicts, "warmup_s": tune_s,
        "sweeps": {k: stats[k] for k in ("algo_sweeps", "config_sweeps",
                                         "fusion_sweeps")},
        "timings": len(stats["timed"]), "tuned_vs_untuned": rel,
        "ms_per_batch": windows,
        "outputs": [r.out.tolist() for r in tuned_out]}

    # a model whose measured plan differs from its heuristic one: the
    # tune must drop the bucket's program and CUDA graph and capture the
    # tuned launches again.  Each engine has a model of its own, since a
    # model memoises the GraphPlan that warmup(tune=...) retunes.
    sq_params = squeezenet_like().init(torch.Generator().manual_seed(0),
                                       device=dev)
    sq_untuned = CnnServeEngine(squeezenet_like(), sq_params, shape224,
                                buckets=(1,))
    sq_untuned.warmup()
    sq = CnnServeEngine(squeezenet_like(), sq_params, shape224,
                        buckets=(1,))
    sq.warmup()
    heur = {n: p.algorithm
            for n, p in sq.programs.plan(1).conv_plans.items()}
    old_graph = sq.programs.graphs[1]
    t0 = time.perf_counter()
    sq.warmup(tune="full")
    stats = autotune.reset_measure_stats()
    tune_s = time.perf_counter() - t0
    gp = sq.programs.plan(1)
    print(gp.explain())
    moved = {n: (heur.get(n), p.algorithm)
             for n, p in gp.conv_plans.items()
             if heur.get(n) != p.algorithm}
    g = sq.programs.graphs[1]
    print(f"  squeezenet_like tune='full' warmup: {tune_s:.1f} s, "
          f"{stats['algo_sweeps']} algorithm, {stats['config_sweeps']} "
          f"config and {stats['fusion_sweeps']} fusion sweeps; nodes "
          f"that changed executor (heuristic, measured): {moved}; bucket "
          f"graph captured again: {g is not old_graph} "
          f"(captures {g.captures})")
    if not moved:
        fail("tuned squeezenet_like: no node changed executor, so the "
             "re-capture after a tune was not exercised")
    if g is old_graph or g.captures != 1:
        fail("tuned squeezenet_like: the bucket's CUDA graph was not "
             "captured again after the tune")
    sq_ref = CnnServeEngine(squeezenet_like(), to_cpu(sq_params), shape224,
                            buckets=(1,), device="cpu", backend="cuda")
    serve_checked("tuned squeezenet_like 224x224", sq, sq_ref, shape224,
                  [1, 1])
    sq_windows = {"untuned": [], "tuned": []}
    for kind in ("untuned", "tuned", "tuned", "untuned"):
        eng = sq_untuned if kind == "untuned" else sq
        for i in range(WINDOW_REQUESTS):
            eng.submit(ImageRequest(i, pool))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        sq_windows[kind].append((time.perf_counter() - t0) * 1e3
                                / WINDOW_REQUESTS)
    print(f"  squeezenet_like 224x224 bucket 1, ms per batch (untuned, "
          f"tuned, tuned, untuned): untuned {sq_windows['untuned']}, "
          f"tuned {sq_windows['tuned']}")
    report["tuning"]["squeezenet224"] = {
        "moved": moved, "warmup_s": tune_s,
        "executors": {n: p.algorithm for n, p in gp.conv_plans.items()},
        "sweeps": {k: stats[k] for k in ("algo_sweeps", "config_sweeps",
                                         "fusion_sweeps")},
        "ms_per_batch": sq_windows}
    del sq, sq_untuned, sq_ref, sq_params
    use_cache(untuned_cache)

    # -- 8. the other CNN models --------------------------------------------
    phase("the other CNN models served on the card (squeezenet_like, "
          "mobilenet_like, fire_like at 224x224; tiny_cnn at 32x32)")
    use_cache(cache_root / "models", fresh=True)
    report["models"] = {}

    for name, make, shape, buckets, sizes in (
            ("squeezenet_like", squeezenet_like, shape224, (1, 4), [4, 1]),
            ("mobilenet_like", mobilenet_like, shape224, (1, 4), [4, 1]),
            ("fire_like", fire_like, shape224, (1, 4), [4, 1]),
            ("tiny_cnn", tiny_cnn, small, (1, 4), [1, 3, 2, 4, 1])):
        m = make()
        prm = m.init(torch.Generator().manual_seed(0), device=dev)
        eng = CnnServeEngine(m, prm, shape, buckets=buckets)
        ref = CnnServeEngine(m, to_cpu(prm), shape, buckets=buckets,
                             device="cpu", backend="cuda")
        eng.warmup()
        library = {}
        for b in buckets:
            gp = eng.programs.plan(b)
            print(gp.explain())
            library[str(b)] = sorted(
                n for n, p in gp.conv_plans.items() if not p.executor.kernels)
            grouped = sorted(n for n, p in gp.conv_plans.items()
                             if p.spec.groups != 1)
            if library[str(b)] != grouped:
                fail(f"{name} bucket {b}: conv nodes on a library executor "
                     f"{library[str(b)]}, grouped nodes {grouped}")
        serve_checked(f"{name} {shape[0]}x{shape[1]}", eng, ref, shape,
                      sizes)
        report["models"][name] = {
            "shape": list(shape), "library_nodes": library,
            "executors": {str(b): {n: p.algorithm for n, p in
                                   eng.programs.plan(b).conv_plans.items()}
                          for b in buckets}}
    use_cache(untuned_cache)

    # -- 9. the async front end on the card --------------------------------------
    # resnet_like through AsyncServeFrontend at SMOKE_FRONTEND's two
    # geometries and 224x224 (buckets 1 and 4), pipeline depth 2: every
    # request served with no miss, telemetry consistent, outputs against
    # the CPU engine, the trace's kernels equal to the plans, every input
    # copy from pinned memory, and the copies overlapping an earlier
    # batch's kernels on the card.  Then the int8 frontend, the one-card
    # sharded dispatcher against the plain frontend, and the launcher.
    phase(f"main path: resnet_like served by AsyncServeFrontend "
          f"({FRONTEND_REQUESTS} requests in bursts of {FRONTEND_BURST}, "
          f"pipeline depth {SMOKE_FRONTEND.pipeline_depth}), the int8 "
          f"frontend, the one-card sharded dispatcher and the launcher")
    report["frontend"] = {"card": card}
    fe_geoms = dict(SMOKE_FRONTEND.geometry_map())
    fe_geoms[(224, 224, 3)] = (1, 4)
    frng = np.random.default_rng(0)
    fe_shapes = list(fe_geoms)
    fe_images = []
    for _ in range(FRONTEND_REQUESTS):
        shape = fe_shapes[int(frng.integers(len(fe_shapes)))]
        fe_images.append(frng.standard_normal(
            (int(frng.integers(1, 5)),) + shape, dtype=np.float32))

    def geom(shape):
        return "x".join(map(str, shape))

    def make_frontend(m, p, geoms, precision=None, cfg=SMOKE_FRONTEND):
        f = AsyncServeFrontend(m, p, geoms, max_wait_ms=cfg.max_wait_ms,
                               default_deadline_ms=DEFAULT_SLO_MS,
                               pipeline_depth=cfg.pipeline_depth,
                               precision=precision)
        f.warmup()
        return f

    def serve_stream(server, images):
        """Bursts of FRONTEND_BURST submits, each followed by a poll(),
        then run(); the requests in submit order."""
        reqs = []
        for i, x in enumerate(images):
            reqs.append(ServeRequest(rid=i, images=x))
            server.submit(reqs[-1])
            if (i + 1) % FRONTEND_BURST == 0:
                server.poll()
        server.run()
        return reqs

    def check_served(server, reqs, label):
        """Every request served, no miss, and each trace's telemetry
        consistent: compute and queue within the total, p50 <= p95 <=
        p99 for every stage."""
        st = server.stats()
        if (st["served"] != len(reqs) or st["deadline_misses"]
                or st["late_served"] or not all(
                    r.status == "served" and r.out is not None
                    and np.isfinite(r.out).all() for r in reqs)):
            fail(f"{label}: served {st['served']} of {len(reqs)}, misses "
                 f"{st['deadline_misses']}, late {st['late_served']}")
        frontend_ = getattr(server, "frontend", server)
        for t in frontend_.telemetry.requests:
            if not (t.compute_ms <= t.total_ms and t.queue_ms <= t.total_ms):
                fail(f"{label}: request {t.rid} compute {t.compute_ms} / "
                     f"queue {t.queue_ms} ms over its total {t.total_ms}")
        for stage, ps in st["latency_ms"].items():
            if not ps["p50"] <= ps["p95"] <= ps["p99"]:
                fail(f"{label}: {stage} percentiles {ps} not monotone")
        return st

    def stage_rollups(f):
        """p50/p95/p99 of every stage, per geometry (served requests)."""
        out = {}
        for g in sorted({t.geometry for t in f.telemetry.requests}):
            served_ = [t for t in f.telemetry.requests
                       if t.geometry == g and t.status == "served"]
            out[g] = {stage: rollup_percentiles(
                [t.stage_ms(stage) for t in served_]) for stage in STAGES}
        return out

    def check_copies(records, batches, label):
        """The trace's copies against the frontend's batches: one input
        copy from pinned memory and one output copy into pinned memory a
        batch, in dispatch order (fails otherwise).  Overlap on the card:
        a batch flagged overlapped whose input copy intersects a kernel
        of an earlier batch (one that starts before the previous batch's
        output copy, which follows its kernels on the compute stream).
        Per geometry, medians of the copy, of the batch's device compute
        (first kernel to output copy end) and of the host's reach (a
        batch's first kernel to the next batch's input copy)."""
        h2d = [r for r in records if r[0].startswith("Memcpy HtoD")]
        d2h = [r for r in records if r[0].startswith("Memcpy DtoH")]
        kern = [r for r in records if is_kernel(r[0])]
        names = sorted({r[0] for r in h2d + d2h})
        print(f"  {label}: copies in the trace: {len(h2d)} host-to-device, "
              f"{len(d2h)} device-to-host, kinds {names}")
        pageable = [r for r in h2d if "Pinned" not in r[0]]
        if pageable:
            fail(f"{label}: {len(pageable)} host-to-device copies not from "
                 f"pinned memory: {sorted({r[0] for r in pageable})}")
        if len(h2d) != len(batches) or len(d2h) != len(batches) or any(
                "Pinned" not in r[0] for r in d2h):
            fail(f"{label}: {len(h2d)} input and {len(d2h)} output copies "
                 f"in the trace for {len(batches)} batches ({names})")
        starts = [k[1] for k in kern]
        out = {"flagged": 0, "hits": 0, "pred_on_card": 0}
        per = {}
        for j, b in enumerate(batches):
            h0, h1 = h2d[j][1], h2d[j][2]
            row = per.setdefault(b.geometry, {"h2d": [], "compute": [],
                                              "reach": []})
            row["h2d"].append((h1 - h0) / 1e3)
            # batch j's kernels follow its input copy and, on the compute
            # stream, the output copy of the batch before it
            first = bisect.bisect_left(
                starts, max(h1, d2h[j - 1][1]) if j else h1)
            if first < len(kern) and kern[first][1] < d2h[j][1]:
                row["compute"].append((d2h[j][2] - kern[first][1]) / 1e3)
                if j + 1 < len(batches):
                    row["reach"].append((h2d[j + 1][1] - kern[first][1])
                                        / 1e3)
            if j == 0 or not b.overlapped:
                continue
            out["flagged"] += 1
            before = bisect.bisect_left(starts, min(h1, d2h[j - 1][1]))
            out["hits"] += any(k1 > h0 for _, _, k1 in kern[:before])
            out["pred_on_card"] += d2h[j - 1][2] > h0
        out["share"] = out["hits"] / out["flagged"] if out["flagged"] else 0.0
        out["by_geometry"] = {
            g: {"batches": len(r["h2d"]),
                "h2d_ms": float(np.median(r["h2d"])),
                "compute_ms": float(np.median(r["compute"] or [np.nan])),
                "reach_ms": float(np.median(r["reach"] or [np.nan]))}
            for g, r in per.items()}
        return out

    fe = make_frontend(model, params, fe_geoms)
    fe_plans = {}                 # (geometry, bucket) -> launches per batch
    for shape, progs in fe.programs.items():
        for b in progs.buckets:
            gp = progs.plan(b)
            lib = {n: q.algorithm for n, q in gp.conv_plans.items()
                   if not q.executor.kernels}
            if lib:
                fail(f"frontend {shape} bucket {b}: conv nodes on a library "
                     f"executor: {lib}")
            per = {}
            for q in gp.conv_plans.values():
                for k in q.executor.kernels:
                    per[k] = per.get(k, 0) + 1
            fe_plans[(geom(shape), b)] = per
    print(f"  launches per batch by (geometry, bucket): {fe_plans}")
    torch.cuda.synchronize()
    convspec.reset_plan_stats()
    _build.reset_launches()
    # the card alone under the profiler, so the host's side of the
    # pipeline runs at its own speed
    with profiled(host=False) as prof:
        t0 = time.perf_counter()
        fe_reqs = serve_stream(fe, fe_images)
        torch.cuda.synchronize()
        fe_secs = time.perf_counter() - t0
    counts = dict(_build.LAUNCHES)
    traced = traced_launches(prof)
    records = device_records(prof)
    del prof
    for k, v in counts.items():
        launches[k] += v
    st = check_served(fe, fe_reqs, "frontend")
    batches = fe.telemetry.batches
    want = {}
    for b in batches:
        for k, v in fe_plans[(b.geometry, b.bucket)].items():
            want[k] = want.get(k, 0) + v
    n_images = sum(x.shape[0] for x in fe_images)
    print(f"  {card}: {FRONTEND_REQUESTS} requests, {n_images} images in "
          f"{len(batches)} batches {st['batches_by_program']}: "
          f"{fe_secs * 1e3:.3f} ms (the card profiled), "
          f"{n_images / fe_secs:.1f} images/s; kernels in the trace "
          f"{traced}; launch counters {counts}; planned {want}; plan() "
          f"resolutions {convspec.PLAN_STATS['resolutions']}")
    if traced != want:
        fail(f"frontend: the trace ran {traced} != planned {want}")
    if {k: v for k, v in counts.items() if v} != want:
        fail(f"frontend: launches {counts} != planned {want}")
    if convspec.PLAN_STATS["resolutions"]:
        fail(f"frontend: a warm frontend made "
             f"{convspec.PLAN_STATS['resolutions']} plan() resolutions")
    copies = check_copies(records, batches, "frontend")
    print(f"  overlap on the card: {copies['hits']} of {copies['flagged']} "
          f"batches flagged overlapped ({copies['share']:.3f}) copied their "
          f"input while a kernel of an earlier batch ran; "
          f"{copies['pred_on_card']} found an earlier batch still on the "
          f"card (not gated here: see the squeezenet_like stream below)")
    for g, row in sorted(copies["by_geometry"].items()):
        print(f"    {g}: H2D {row['h2d_ms']:.6f} ms per batch, device "
              f"compute {row['compute_ms']:.6f} ms, from a batch's first "
              f"kernel to the next batch's copy {row['reach_ms']:.6f} ms "
              f"(medians of {row['batches']})")
    # outputs against the CPU engine, and the same stream through the
    # card's CnnServeEngine.run() per geometry
    fe_cmp = {}
    for shape, buckets in fe_geoms.items():
        idx = [i for i, x in enumerate(fe_images) if x.shape[1:] == shape]
        cpu = CnnServeEngine(model, params_cpu, shape, buckets=buckets,
                             device="cpu", backend="cuda")
        card_eng = CnnServeEngine(model, params, shape, buckets=buckets)
        card_eng.warmup()
        for i in idx:
            cpu.submit(ImageRequest(i, fe_images[i]))
            card_eng.submit(ImageRequest(i, fe_images[i]))
        err = 0.0
        for i, r in zip(idx, cpu.run()):
            e = float(np.abs(fe_reqs[i].out - r.out).max())
            bound = SERVE_TOL * float(np.abs(r.out).max())
            if not e <= bound:
                fail(f"frontend {shape} request {i}: card vs CPU {e:.3e} > "
                     f"{bound:.3e}")
            err = max(err, e)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng_done = card_eng.run()
        torch.cuda.synchronize()
        eng_ms = (time.perf_counter() - t0) * 1e3
        # the drain packs other batches than the frontend, so the two
        # may differ in the last bits (another bucket's plan)
        diff = max(float(np.abs(fe_reqs[i].out - r.out).max())
                   for i, r in zip(idx, eng_done))
        fe_cmp[geom(shape)] = {
            "requests": len(idx), "max_abs_err_vs_cpu": err,
            "engine_run_ms": eng_ms, "engine_batches": {
                str(k): v for k, v in card_eng.stats["batches"].items()},
            "max_abs_diff_vs_engine": diff}
        print(f"  {geom(shape)}: {len(idx)} requests within {SERVE_TOL} of "
              f"the CPU engine's abs max (max err {err:.3e}); the same "
              f"stream through CnnServeEngine.run(): {eng_ms:.3f} ms "
              f"{card_eng.stats['batches']}, max |frontend - engine| "
              f"{diff:.3e}")
        del card_eng
    # the same traffic again, nothing traced: throughput and latency
    fe2 = make_frontend(model, params, fe_geoms)
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    reqs2 = serve_stream(fe2, fe_images)
    torch.cuda.synchronize()
    fe2_secs = time.perf_counter() - t0
    for k, v in _build.LAUNCHES.items():
        launches[k] += v
    st2 = check_served(fe2, reqs2, "frontend (untraced)")
    rollups = stage_rollups(fe2)
    print(f"  {card}: untraced, {n_images} images in {fe2_secs * 1e3:.3f} "
          f"ms = {n_images / fe2_secs:.1f} images/s, "
          f"{st2['overlapped_batches']} of {st2['batches']} batches "
          f"overlapped (host flag)")
    for g, stages in rollups.items():
        print(f"    {g}: " + "; ".join(
            f"{stage} " + "/".join(f"{v:.4f}" for v in ps.values())
            for stage, ps in stages.items()) + " ms (p50/p95/p99)")
    report["frontend"].update({
        "requests": FRONTEND_REQUESTS, "images": n_images,
        "traced": {"secs": fe_secs, "stats": st, "traced_launches": traced,
                   "copies": copies},
        "untraced": {"secs": fe2_secs, "images_per_s": n_images / fe2_secs,
                     "stats": st2, "per_geometry_ms": rollups},
        "per_geometry": fe_cmp})
    del fe, fe2
    # overlap on the card where the card has work to overlap: resnet_like
    # computes a batch in less time than the host takes to reach the next
    # copy (the medians printed above, at every bucket: the pack alone
    # grows with the batch as fast as the compute), so the overlap is
    # held on squeezenet_like at 224x224, whose batch of 4 keeps the card
    # busy longer than that; 4-image requests submitted as above
    ov_model = squeezenet_like()
    ov_params = ov_model.init(0, device=dev)
    ov_shape = (224, 224, 3)
    ov = make_frontend(ov_model, ov_params, {ov_shape: (OVERLAP_BUCKET,)})
    gp = ov.programs[ov_shape].plan(OVERLAP_BUCKET)
    lib = {n: q.algorithm for n, q in gp.conv_plans.items()
           if not q.executor.kernels}
    if lib:
        fail(f"squeezenet_like 224x224 bucket {OVERLAP_BUCKET}: conv nodes "
             f"on a library executor: {lib}")
    orng = np.random.default_rng(1)
    ov_images = [orng.standard_normal((4,) + ov_shape, dtype=np.float32)
                 for _ in range(OVERLAP_REQUESTS)]
    _build.reset_launches()
    with profiled(host=False) as prof:
        t0 = time.perf_counter()
        ov_reqs = serve_stream(ov, ov_images)
        torch.cuda.synchronize()
        ov_secs = time.perf_counter() - t0
    records = device_records(prof)
    del prof
    label = f"squeezenet_like 224x224 bucket-{OVERLAP_BUCKET} frontend"
    check_served(ov, ov_reqs, label)
    ov_copies = check_copies(records, ov.telemetry.batches, label)
    cpu = CnnServeEngine(ov_model, {
        "convs": [{k: v.cpu() for k, v in c.items()}
                  for c in ov_params["convs"]],
        "head": ov_params["head"].cpu()}, ov_shape,
        buckets=(OVERLAP_BUCKET,), device="cpu", backend="cuda")
    for i in range(2):
        cpu.submit(ImageRequest(i, ov_images[i]))
    for i, r in enumerate(cpu.run()):
        e = float(np.abs(ov_reqs[i].out - r.out).max())
        if not e <= SERVE_TOL * float(np.abs(r.out).max()):
            fail(f"{label} request {i}: card vs CPU {e:.3e}")
    row = ov_copies["by_geometry"][geom(ov_shape)]
    n_ov = 4 * OVERLAP_REQUESTS
    print(f"  {card}: {label}: {OVERLAP_REQUESTS} requests, {n_ov} images "
          f"in {len(ov.telemetry.batches)} batches, {ov_secs * 1e3:.3f} ms "
          f"(the card profiled), {n_ov / ov_secs:.1f} images/s; overlap on "
          f"the card: {ov_copies['hits']} of {ov_copies['flagged']} batches "
          f"flagged overlapped ({ov_copies['share']:.3f}); H2D "
          f"{row['h2d_ms']:.6f} ms, device compute {row['compute_ms']:.6f} "
          f"ms, host reach {row['reach_ms']:.6f} ms per batch (medians)")
    report["frontend"]["overlap_stream"] = {
        "model": "squeezenet_like", "bucket": OVERLAP_BUCKET,
        "requests": OVERLAP_REQUESTS, "secs": ov_secs, "copies": ov_copies}
    if not (ov_copies["flagged"] and ov_copies["share"] >= 0.5):
        fail(f"{label}: only {ov_copies['hits']} of {ov_copies['flagged']} "
             f"batches with a predecessor in flight copied their input while "
             f"an earlier batch's kernel ran")
    del ov, ov_params
    # the int8 frontend at 32x32 (calibrated in phase 4)
    small_images = [x for x in fe_images if x.shape[1:] == small]
    fe8 = make_frontend(model, params, {small: fe_geoms[small]},
                        precision=QuantPolicy())
    _build.reset_launches()
    reqs8 = serve_stream(fe8, small_images)
    torch.cuda.synchronize()
    for k, v in _build.LAUNCHES.items():
        launches[k] += v
    st8 = check_served(fe8, reqs8, "int8 frontend")
    dtypes8 = st8["serve_dtype_by_program"]
    if not dtypes8 or not all("int8" in d for d in dtypes8.values()):
        fail(f"int8 frontend: serves {dtypes8}")
    eng8 = engines[("int8", small)]
    for i, x in enumerate(small_images):
        eng8.submit(ImageRequest(i, x))
    err8, same8 = 0.0, True
    for a, r in zip(reqs8, eng8.run()):
        e = float(np.abs(a.out - r.out).max())
        if not e <= SERVE_TOL * float(np.abs(r.out).max()):
            fail(f"int8 frontend request {a.rid}: {e:.3e} from the int8 "
                 f"engine")
        err8, same8 = max(err8, e), same8 and np.array_equal(a.out, r.out)
    print(f"  int8 frontend 32x32: {len(reqs8)} requests serve {dtypes8}; "
          f"against the int8 CnnServeEngine: max err {err8:.3e}, bit-equal "
          f"{same8}")
    report["frontend"]["int8"] = {"serve_dtype_by_program": dtypes8,
                                  "max_abs_err_vs_engine": err8,
                                  "equal_to_engine": same8}
    del fe8
    # the sharded dispatcher over the one-card serve mesh
    tmodel = tiny_cnn()
    tparams = tmodel.init(0, device=dev)
    dist_images = []
    drng = np.random.default_rng(0)
    dist_shapes = [s_ for s_, _ in DIST_SMOKE.geometries]
    for i in range(24):
        shape = dist_shapes[i % len(dist_shapes)]
        dist_images.append(drng.standard_normal(
            (int(drng.integers(1, 4)),) + shape, dtype=np.float32))
    mesh = make_serve_mesh()
    disp = ShardedServeDispatcher(
        tmodel, tparams, DIST_SMOKE.geometry_map(), mesh=mesh,
        max_wait_ms=DIST_SMOKE.max_wait_ms,
        default_deadline_ms=DIST_SMOKE.default_deadline_ms,
        pipeline_depth=DIST_SMOKE.pipeline_depth)
    disp.warmup()
    plain = make_frontend(tmodel, tparams, DIST_SMOKE.geometry_map(),
                          cfg=DIST_SMOKE)
    _build.reset_launches()
    d_reqs = serve_stream(disp, dist_images)
    p_reqs = serve_stream(plain, dist_images)
    torch.cuda.synchronize()
    for k, v in _build.LAUNCHES.items():
        launches[k] += v
    dst = check_served(disp, d_reqs, "sharded dispatcher")
    check_served(plain, p_reqs, "plain tiny_cnn frontend")
    same_d = all(np.array_equal(a.out, b.out)
                 for a, b in zip(d_reqs, p_reqs))
    tiny_algos = {geom(sh): {n: q.algorithm for n, q in
                             pr.plan(pr.buckets[0]).conv_plans.items()}
                  for sh, pr in disp.frontend.programs.items()}
    print(f"  sharded dispatcher over {mesh}: devices {dst['devices']}, "
          f"global buckets {dst['global_buckets']}, plans {tiny_algos}; "
          f"{len(d_reqs)} requests bit-equal to the plain frontend: "
          f"{same_d}")
    if dst["devices"] != 1 or not same_d:
        fail(f"sharded dispatcher: devices {dst['devices']}, bit-equal to "
             f"the plain frontend {same_d}")
    report["frontend"]["sharded"] = {"devices": dst["devices"],
                                     "equal_to_frontend": same_d,
                                     "plans": tiny_algos}
    del disp, plain
    # the launcher, as a user runs it
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--cnn-dist",
         "--requests", "16"], cwd=ROOT, capture_output=True, text=True,
        timeout=600, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    if out.returncode != 0:
        fail(f"python -m repro_torch.launch.serve --cnn-dist exited "
             f"{out.returncode}: {out.stderr[-2000:]}")
    lst = json.loads(out.stdout[out.stdout.index("{"):])
    print(f"  python -m repro_torch.launch.serve --cnn-dist --requests 16: "
          f"exit 0 in {time.perf_counter() - t0:.1f} s; "
          f"{out.stdout.splitlines()[1]}; stats: served {lst['served']}, "
          f"devices {lst['devices']}, batches {lst['batches_by_program']}")
    if lst["served"] != 16 or lst["deadline_misses"]:
        fail(f"the launcher served {lst['served']} of 16")
    report["frontend"]["launcher"] = lst
    for row in line:
        row["launches"] = launches[row["name"]]
    phase(None)
    report["phase_seconds"] = _PHASE["times"]

    out_dir = ROOT / "chiprun_out"
    try:
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    except OSError as e:
        print(f"(could not write {out_dir}: {e})")
    print(json.dumps({"kernels": line}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
