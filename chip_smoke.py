#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each failing loudly (an assertion or an exception ends the run
with a non-zero exit and no result line):

1. card: the card's name and power limit, from nvidia-smi;
2. build: nvcc builds every kernel from ``src/repro_torch/kernels/csrc``
   (one nvcc per source, all started together) and prints each kernel's
   registers and spills;
3. kernels: both CUDA bag kernels against their plain PyTorch version on
   the card over the kernel test grid (D=13, P=1, padded bags, shuffled
   shard offsets, rows past the shard's end, fp32 and bf16): fp32
   bitwise, bf16 within 0.1 (the reference's tolerance); both again over
   the NMP kernel's edges (``cases.NMP_GRID``: D from 4 to 1024, the
   scalar path, B = 1 and 13, T = 1, P > 32 and P % K != 0, holes between
   valid slots), bitwise in fp32 and bf16, with the library's NMP
   schedule equal to ``cases.nmp_schedule``; the attention
   kernels against theirs at the shapes and tolerances of
   ``repro_torch.kernels.cases`` (shared with the card tests): flash
   attention causal and not, G in {1, 3}, D in {32, 64, 112, 128},
   ragged S and T, smollm-135m's and zamba2-7b's full-width prefill
   shapes (fp32 within 2e-5,
   bf16 within two bf16 steps of each element), flash decode at the
   split-KV kernel's edges (pos at 0, mid-cache, at the last row and
   past T, kv_offset > 0 and a slice wholly after pos, one split and the
   most splits, G from 1 to 16, D 16 to 128 and 112 (row groups with
   spare lanes), smollm-135m's and zamba2-7b's last decode launches;
   1e-4 on o and l, 1e-5 on m);
4. serve: RM1 V0 at its published widths, only ``rows_per_table`` cut
   (3,417,969 -> 40,000, so the embedding bank fits one card), through
   ``run_scenario`` on the CLI's cluster (2 CNs, 4 MNs as
   ``2xddr_mn+2xnmp_mn``, 2 replicas, batch 64, 32 requests, a FailMN
   mid-stream).  The launch counters are zeroed just before and read
   just after; the scores are checked against the model's own
   one-reduction path; a second run on an all-DDR pool must give
   bitwise-equal scores;
5. timing: each kernel at the exact inputs one main-path launch gave it,
   beside its bytes bound, its plain version and one
   ``torch.nn.functional.embedding_bag`` call as a library yardstick,
   each by single-launch median and back to back (``device_ms``); the
   NMP row adds its schedule (grid, warps a block, float4 columns a
   lane, rows in flight K), the registers, spills and static shared
   memory ptxas gave its instantiation, and a second launch bitwise equal
   to the first, and fails if any NMP instantiation spills;
6. trace: the same serve once more under ``torch.profiler``: the
   device's busy time per batch, its idle share of the untraced serve's
   wall time, and the top kernels and host ops;
7. elastic: on the serve phase's model and bank, (a) the serve flags
   plus ``--elastic`` (the diurnal ``Autoscaler`` plan as timed
   resizes, shard migration included) on the same stream: at least one
   resize, every request completed, scores bitwise equal to the serve
   phase's; (b) ``--cns 1 --mns 2 --mn-type ddr_mn,nmp_mn``, 128
   requests, once without an SLA (scores within ``SCORE_ATOL`` of the
   model's one-reduction path) and once with ``--sla-p99-ms`` at half
   that run's virtual-clock p99: the SLA controller acts (its window
   filled), the final pool is larger than {1, 2}, both flat kernels
   launch and the scores are bitwise equal to the first run's.  In
   each run the first launch over each MN shard and table set (after
   every resize too) is held bitwise against the plain version on its
   inputs, and the ``ScenarioReport`` against the same spec served on
   the host with nothing computed (``HostClock``: the virtual clock
   reads only indices and bytes), field for field.  Each run prints
   its wall ms per batch, resizes, migrated bytes, final pool,
   launches and peak device memory;
8. single unit: ``DLRMServingEngine(use_kernel=True)`` over the whole
   (800, 40000, 128) bank, which needs 64-bit row addresses;
9. sharded: the table-sharded lookup ``core.sharding.disagg_embedding_
   lookup(mesh=None, use_kernel=True)`` over the whole bank, permuted by
   ``greedy_table_layout(m=4)`` (a second 16.4 GB stack), for a batch of
   64 from the same request stream: exactly one stacked-bag launch, the
   pooled output bitwise equal to the fused kernel's over the unpermuted
   bank and to the plain version, equal scores; the kernel on a bf16
   copy of 64 tables bitwise equal to its plain version; its time beside
   its bytes bound, its plain version and one
   ``torch.nn.functional.embedding_bag`` call; peak device memory;
10. fleet: RM1 V0 and RM2 V0 at their published widths, only
   ``rows_per_table`` cut, to 20,000 in both (the shared pool needs one
   table shape; the banks are 8.19 and 4.10 GB), served as one fleet
   through ``fleet.run_fleet`` with hand-built members under
   ``fleet_shift``'s traffic (48 requests, seed 9, a 0.3 rate shift
   from RM1 to RM2, then RM2's rows skewed) on the serve phase's pool
   with a 0.05 MB hot-row cache per CN: every request completed, both
   models and both flat kernels served, every score finite, in [0, 1]
   and within ``SCORE_ATOL`` of its member's one-reduction path; the
   first launch over each MN shard and table set (each model's tables
   apart) bitwise equal to the plain version, the report equal to the
   host clock's, as in elastic; wall ms per batch, batches per model
   and their sizes, launches, peak device memory, and RM2's dense
   tower traced at each batch size the fleet ran it at (device ms, the
   GEMMs' share, the fp32 and weight-read bounds);
11. lm: smollm-135m at its published widths, nothing cut (30 layers,
   d 576, 9 heads over 3 kv heads, head_dim 64, d_ff 1536, vocab 49152,
   tied, bf16), through ``LMServingEngine.generate``: batch 8, a
   1024-token seeded prompt, a 2048-slot cache, 64 decode steps.  The
   counters are zeroed just before and read just after: exactly 30
   flash-attention launches, all 30 on the tensor-core (wgmma) kernel,
   and 30 x 64 flash-decode launches.  Prefill ms,
   decode ms per token, tokens/s and peak memory are printed; each
   kernel is held against its plain version at the inputs of the first
   prefill (and at fp32 copies of them) and of the last decode launch,
   and timed there beside its bound,
   its plain version and ``scaled_dot_product_attention``; the attention
   row adds the kernel variant, its registers, spills and shared memory
   (ptxas and the kernel's own layout) and the tensor-work bound with
   the P split; the decode row its split count and grid, registers,
   spills and shared memory (failing on a spill), two launches bitwise
   equal and the host time per call of the wrapper and of SDPA (the
   eager decode step is paced by the host); an fp32 copy of the model (the scalar attention kernel)
   generates the same tokens through the kernels as through their plain
   versions;
12. zoo: the LM zoo's attention families at their published widths,
   bf16 random weights from a seeded ``torch.Generator``, each built,
   served and freed before the next (the leaf count equals
   ``param_count()``): qwen2.5-14b (48 heads padded from 40 over 8 kv
   heads, QKV bias), qwen3-4b (q/k norm), llama3-8b, qwen2-moe-a2.7b (60
   experts padded to 64, top-4, a shared expert), phi3.5-moe-42b-a6.6b
   (16 experts, top-2; cut: 32 -> 8 layers, since 32 need 83.7 GB),
   llava-next-mistral-7b (576 seeded patch embeddings before the prompt)
   and whisper-large-v3 (seeded (4, 1500, 1280) bf16 frames), through
   ``LMServingEngine.generate(extra=)``: batch 4, 16 decode steps, a
   512-token prompt in a 1024-slot cache (llava: 2048; whisper: 64
   tokens, 256 slots).  The counters are zeroed just before and read
   just after: flash attention ``num_layers`` launches a prefill (whisper
   96: encoder, self and cross), all on the tensor-core kernel, flash
   decode ``num_layers`` x 16 (whisper 2 x 32 x 16).  Each kernel is held
   against its plain version at the first launch of each attention kind
   and at the first and last decode launch over each cache (whisper's
   cross cache too, ``pos`` past its end), and timed there beside SDPA;
   an MoE decode step runs under sync debug mode 'error', twice from
   copies of one cache, with bitwise-equal logits.  Each prints prefill
   ms, decode ms per step, tokens/s, peak memory, launches and the MoE
   pairs dropped at prefill.  Then a 2-layer fp32 copy of each family
   at full width (llama3-8b, qwen2-moe, llava, whisper with 2 + 2 layers)
   generates the same greedy tokens through the kernels as through
   their plain versions, prefill logits within 1e-4.  The kernels' JSON
   rows gain each zoo arch's launches (``zoo_launches``);
13. recurrent: zamba2-7b (81 Mamba2 layers, d 3584, a shared attention
   block of 32 heads of 112 after each of 13 groups of 6, 6.75 B
   parameters) and rwkv6-3b (32 layers, d 2560, attention-free, 3.09 B)
   at their published widths, nothing cut, bf16 random weights from a
   seeded ``torch.Generator``, each built, served and freed before the
   next, through ``LMServingEngine.generate``: batch 4, a 512-token
   prompt in a 1024-slot cache, 16 steps.  The counters are zeroed just
   before and read just after: zamba2 13 flash-attention launches, all
   on the scalar kernel (head dim 112 is no wgmma width), and 13 x 16
   flash-decode launches; rwkv6 none of any kernel.  zamba2's kernels
   are held against their plain versions at the first prefill launch
   (and fp32 copies of its inputs) and the first and last decode
   launches, and timed there beside their bounds and SDPA; a decode
   step of each model runs under sync debug mode 'error', twice from
   copies of one cache, with bitwise-equal logits; each prints prefill
   ms, decode ms per step, tokens/s, peak memory and launches, and a
   trace of its prefill and two decode steps (rwkv6's prefill, some
   65,000 launches, traced on the device alone).  A 7-layer fp32 copy
   of zamba2 at full width (a group of 6 with its shared block, a tail
   of 1) generates the same tokens through the kernels as through their
   plain versions, prefill logits within 1e-4.  The kernels' rows gain
   both archs' launches and zamba2's head-dim-112 times
   (``head_dim_112``);
14. train: (a) smollm-135m at its published widths, nothing cut, bf16,
   through ``launch.train.build`` -> ``run_train_loop`` (Adam at the
   CLI's defaults, batch 8 x seq 2048, 40 steps, a checkpoint every 10
   in a temp directory, a fault hook that raises once at step 25): the
   fault fires once, the loop resumes from step 20, the latest
   checkpoint is step 40, every logged loss is finite and the last is
   below the first, and no kernel launches (the counters are zeroed just
   before and read just after: the loss takes the blocked jnp attention,
   the kernels have no backward); step ms (median and spread, leaving
   out the steps that hold a checkpoint save or the fault), tokens/s,
   peak memory, and one more step traced; (b) an fp32 copy at full
   width, batch 2 x seq 256: the loss and every leaf's gradient on the
   card against the CPU (loss within 1e-5 relative, gradients within
   rtol 1e-4 and 1e-6 + 1e-4 of each leaf's largest magnitude), and
   ``make_train_step(microbatches=2)`` against 1 (loss and gradient norm
   within 1e-5 relative, parameters within 1e-6 after an SGD step at lr
   1); (c) the F1 guard: flash attention, flash decode and a bag wrapper
   raise on grad-requiring operands and launch under ``torch.no_grad``;
   (d) RM1 V0 at its published widths, only ``rows_per_table`` cut
   (3,417,969 -> 10,000), Adagrad, batch 64, 10 steps: finite losses and
   gradients, one step lowers a fixed batch's loss; (e) one Adam step of
   llama3-8b, qwen2-moe-a2.7b, llava-next-mistral-7b, whisper-large-v3
   (2 layers each, whisper 2 + 2), zamba2-7b (7: a group of 6 with its
   shared block and a tail of 1) and rwkv6-3b (2) at their published
   widths, bf16, batch 2 at the zoo's prompt shapes, each freed before
   the next: the loss finite, every gradient finite and nonzero (the
   experts' together), the same batch's loss lower after the step;
15. mesh: serving on a mesh of 4 rank processes on the one card
   (``torch.multiprocessing`` spawn, a ``file://`` store, gloo: NCCL
   refuses two ranks on one device; the parent draws each model's
   weights once and passes them by CUDA IPC, each rank clones only its
   blocks).  It prints the backend and its routes (DTensors move by
   c10d all-gathers and slices: DTensor's functional collectives crash
   on gloo CUDA tensors).  (a) RM1 V0 as in serve (rows cut to 40,000)
   on (data 2, model 2) with ``make_rules(cfg, mesh, "prefill")``,
   params placed by ``reshard_tree``, through ``DLRMServingEngine(mesh,
   rules, use_kernel=True)``: serve's 32 requests, every rank's scores
   within ``SCORE_ATOL`` of serve's, the fused bag launched on every
   rank; then ``healthy_mesh({"model": 2}, failed_fraction=0.4)``, the
   params resharded onto the 2 survivors, the same requests within
   ``SCORE_ATOL`` of the first mesh's.  (b) smollm-135m (9 heads: FSDP
   and context parallelism) and qwen2-moe-a2.7b (16 heads, 64 padded
   experts: head-TP and EP) at their published widths on (1, 4) through
   ``build_program``'s prefill and decode fns (batch 8, prompt 1024,
   2048 slots, 16 steps; batch 4, prompt 512, 1024 slots, 16 steps),
   held against the same weights on one device before the ranks start:
   30 (24) decode launches a step on every rank, 3 of 4 at
   ``kv_offset`` > 0; qwen2-moe's 24 attention launches a prefill on
   every rank, all wgmma over 4 local heads; smollm's prefill launches
   no attention kernel (context parallelism runs the blocked attention,
   as the reference does).  Each rank holds its first attention launch
   and its first and last decode launch against the plain versions on
   the same card tensors.  smollm's bf16 logits of the prefill and of
   steps teacher-forced on the one-device tokens lie within ten bf16
   steps.  qwen2-moe's bf16 route ids at the mesh's capacity (EP rounds
   it up to a multiple of 8, as the reference does) drift from one
   device's with depth as one device's own do when its attention takes
   the plain versions: the mesh keeps at least that share at every
   layer (less 0.05), 99.9% at layer 0 and of the kept pairs.  (c)
   Copies at full width, 2 layers: smollm and qwen2-moe in fp32, greedy
   tokens equal to one device's, logits within 1e-4, route ids and kept
   pairs equal; qwen2-moe in bf16 (prompt 512), logits within ten bf16
   steps and the route floors of (b).  (d) whisper-large-v3 (20 heads:
   head-TP, 5 a rank, in the encoder, the decoder's self- and its
   cross-attention; batch 4, 64 tokens behind 1500 seeded frames, 256
   slots) and zamba2-7b (81 layers: 14 Mamba heads and 8 attention
   heads a rank; batch 4, prompt 512, 1024 slots) on (1, 4), rwkv6-3b
   (32 layers, batch 2 a rank) on (2, 2), each at its published widths
   in bf16, 4 steps, one spawn each with its fp32 copies (whisper 2 + 2
   layers, once under head-TP and once under the FSDP rules, where the
   encoder and both decoder attentions run context parallelism; zamba2
   7; rwkv6 2): every rank's attention launches a prefill (whisper 96,
   all wgmma; zamba2 13, scalar at head dim 112; none under FSDP + CP or
   for rwkv6) and decode launches a step (whisper 64, the cross cache's
   at kv_offset 0; zamba2 13); the copies' greedy tokens equal to one
   device's and logits within 1e-4; the bf16 logits within ten bf16
   steps, rwkv6's at every call within twice its witness, one device's
   own bf16 run on the mesh's batch blocks against its whole batch
   (``MESH_BF16_WITNESS``).  Each rank prints its prefill ms, decode ms
   a step, tokens/s, peak memory and the collectives' share
   of a decode step's wall (gloo stages through host memory: these are
   not NVLink's times); the card's memory in use, the phase's time.  A
   rank that fails fails the phase through its exit code;
16. mesh-train: training on the same kind of mesh (4 gloo rank
   processes on the card, one spawn), each case held against one
   device's run of it from the same weights, computed by the parent
   before the ranks start (gradients kept in files on the host, read
   by each rank for its own blocks).  (a) smollm-135m at its published
   widths, nothing cut, bf16, on (data 2, model 2) (9 heads: FSDP over
   data, context parallelism and Megatron over model, the
   vocab-parallel embedding and CE, ZeRO-1 Adam over data) through
   ``run_train_loop(mesh=, rules=)``: batch 8 x seq 1024, 8 steps (cut
   from ``[train]``'s 2048 and 40 for the phase's time), a checkpoint
   every 3, a fault at step 5: every logged loss within 2% of one
   device's loop, the loss falls, no kernel launch; (b) its last
   checkpoint restored by ``elastic_restore`` onto
   ``healthy_mesh({"model": 2}, 0.4)`` (ranks 0 and 1 on (1, 2)): the
   params and state gathered whole bitwise equal to the file's arrays,
   and one step there within 2% of one device's step from the same
   checkpoint on the same batch; (c) fp32 copies at full width, 2
   layers, on (2, 2): smollm at batch 4 x 256 and qwen2-moe-a2.7b at
   batch 2 x 256, capacity factor 8.0 (head-TP, EP), whisper-large-v3
   (2 + 2 layers, head-TP), zamba2-7b (7 layers) and rwkv6-3b (2) at
   batch 2 x 256: the loss within
   1e-5 relative, the MoE aux within 1e-6, every leaf's gradient within
   rtol 1e-4 and 1e-6 + 1e-4 of its largest magnitude, each rank's
   blocks (so every element of every leaf, and every replica) against
   the same blocks of one device's, since gathering 7 GB a rank through
   gloo would take most of the phase; after one Adam step, the params
   and both moments bitwise one device's update of this rank's own
   gradient (ZeRO-1 is exact) and within 1e-6 of the leaf's largest
   magnitude of one device's step, plus what the measured gradient
   difference moves them by (m by (1 - b1) dg, v by (1 - b2) dg
   (|g| + |g'|), a param by at most lr dg / eps: Adam's first update
   amplifies a gradient that differs in its last bits); (d) RM1 V0,
   rows cut to 10,000 as in ``[train]``, on (2, 2) (``table_shard``
   over model, ``table_rows`` over data), Adagrad, batch 64, 3 steps:
   each rank's block of the bank's gradient within (c)'s tolerance,
   every loss within 1e-5 relative.  Each rank prints its step ms
   (median and spread), tokens/s or samples/s, peak memory and the
   card's, the collectives' share of one more step's wall (host time
   inside ``sharding._reduce``/``_gather``, each from a synchronised
   card), the gradient all-reduce's payload a step, and the save and
   restore times;
17. dryrun: the multi-pod dry run (``repro_torch.launch.dryrun``), which
   needs no card: (a) ``run_cell`` for smollm-135m and qwen2-moe-a2.7b
   at every shape on both production meshes (256 and 512 ranks of a
   fake process group, fake tensors), in worker processes, each
   record's console line and the phase's wall time; (b) at
   ``mesh_shape=(1, 4)`` and ``[mesh]``'s smollm-135m shapes (batch 8,
   prompt 1024, 2048 slots): the argument bytes equal to what
   ``[mesh]``'s rank 0 placed (its local blocks of the weights, the
   cache and the tokens) and the kernel calls equal to its launches,
   prefill and a decode step, exactly; the predicted peak (the record's
   ``total_per_device_bytes``) beside the rank's
   ``max_memory_allocated``, as a ratio; (c) ``ops.LAUNCHES`` untouched
   by the fake path.

All timing lives here, never in ``src/`` (the repo's linter bans host
clocks there).  The line before the last is ``{"kernels": [...]}``; the
last is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import collections
import dataclasses
import gc
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
BF16_OPS_PER_S = 989e12        # H100 SXM bf16 dense tensor cores
ROWS = 40_000                  # rows_per_table cut so the bank fits
FLEET_ROWS = 20_000            # both fleet members' cut: one table shape
ELASTIC_REQUESTS = 128         # the [elastic] (b) stream
SCORE_ATOL = 1e-5              # cluster scores vs the one-reduction path
BF16_TOL = 0.1                 # the reference's bf16 tolerance
KERNELS = {
    "embedding_bag_fused_flat": "src/repro/kernels/embedding_bag.py:88",
    "embedding_bag_nmp_flat": "src/repro/kernels/embedding_bag.py:157",
}
LM_KERNELS = {
    "flash_attention": ("src/repro/kernels/flash_attention.py:63",
                        "src/repro_torch/kernels/csrc/flash_attention.cu"),
    "flash_decode_partial": ("src/repro/kernels/flash_decode.py:61",
                             "src/repro_torch/kernels/csrc/flash_decode.cu"),
}
ROW_KERNELS = dict(LM_KERNELS, embedding_bag=(
    "src/repro/kernels/embedding_bag.py:37",
    "src/repro_torch/kernels/csrc/embedding_bag.cu"))
SOURCES = ["embedding_bag", "flash_attention", "flash_decode"]
SHARDED_BATCH = 64             # bags per table in the sharded phase
CARD_BYTES = 80e9              # the H100's device memory
LM_BATCH, LM_PROMPT, LM_CACHE, LM_STEPS = 8, 1024, 2048, 64
ZOO = [  # arch, num_layers cut to (None: its published depth)
    ("qwen2.5-14b", None), ("qwen3-4b", None), ("llama3-8b", None),
    ("qwen2-moe-a2.7b", None),
    ("phi3.5-moe-42b-a6.6b", 8),       # 83.7 GB at 32 layers: not one card
    ("llava-next-mistral-7b", None), ("whisper-large-v3", None)]
ZOO_BATCH, ZOO_STEPS = 4, 16
#: family -> (prompt tokens, cache slots): text archs (the recurrent
#: ones too) 512 tokens in a 1024-slot cache; llava 512 behind its 576
#: patches; whisper 64 tokens behind its 1500 frames
ZOO_SHAPES = {"dense": (512, 1024), "moe": (512, 1024), "vlm": (512, 2048),
              "audio": (64, 256), "hybrid": (512, 1024), "ssm": (512, 1024)}
#: the full-width fp32 copies, 2 layers (2 + 2 for whisper): one per family
ZOO_FP32 = ["llama3-8b", "qwen2-moe-a2.7b", "llava-next-mistral-7b",
            "whisper-large-v3"]
#: the recurrent families at their published depth, served as the zoo
#: is: zamba2-7b (81 Mamba2 layers, a shared attention block of head dim
#: 112 after each of 13 groups of 6) and rwkv6-3b (attention-free)
RECURRENT = ["zamba2-7b", "rwkv6-3b"]
#: zamba2's fp32 copy: one group of 6 with its shared block, a tail of 1
RECURRENT_FP32_LAYERS = 7
#: [train]: smollm-135m's loop (batch x seq, steps, checkpoint period,
#: the step whose hook raises once), RM1's cut rows, and the zoo's
#: families at their published widths with their depth cut (zamba2: one
#: group of 6 with its shared block and a tail of 1)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 2048, 40
TRAIN_CKPT_EVERY, TRAIN_FAULT_AT = 10, 25
TRAIN_RM1_ROWS = 10_000
TRAIN_FAMILIES = [("llama3-8b", 2), ("qwen2-moe-a2.7b", 2),
                  ("llava-next-mistral-7b", 2), ("whisper-large-v3", 2),
                  ("zamba2-7b", 7), ("rwkv6-3b", 2)]


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def mixed_idx(rng, R, B, T, P):
    idx = rng.randint(0, R, (B, T, P)).astype(np.int32)
    lens = rng.randint(0, P + 1, (B, T))
    lens[0, 0] = 0                                  # one all-padded bag
    mask = np.arange(P)[None, None, :] < lens[..., None]
    return np.where(mask, idx, -1).astype(np.int32)


def check_grid(dev) -> None:
    from repro_torch.kernels import cases, ops
    from repro_torch.kernels.embedding_bag import embedding_bag_flat_plain
    n = 0
    for (T, R, D, B, P) in cases.BAG_GRID:
        for dtype in (torch.float32, torch.bfloat16):
            rng = np.random.RandomState(T * 1000 + D)
            flat = torch.from_numpy(
                rng.randn(T * R, D).astype(np.float32)).to(dev, dtype)
            slots = rng.permutation(T).astype(np.int32)   # shuffled shard
            offsets = torch.from_numpy(slots * R).to(dev)
            idx = torch.from_numpy(mixed_idx(rng, R, B, T, P)).to(dev)
            want = embedding_bag_flat_plain(flat, offsets, idx)
            for name in KERNELS:
                got = getattr(ops, name)(flat, offsets, idx)
                torch.cuda.synchronize()
                if dtype == torch.float32:
                    assert torch.equal(got, want), (name, T, R, D, B, P)
                else:
                    err = float((got - want).abs().max())
                    assert err <= BF16_TOL, (name, T, R, D, B, P, err)
                n += 1
    flat = torch.arange(40, dtype=torch.float32, device=dev).reshape(10, 4)
    offsets = torch.tensor([0, 5], dtype=torch.int32, device=dev)
    idx = torch.tensor([[[1, 7, -1], [2, 9, -1]]], dtype=torch.int32,
                       device=dev)
    want = torch.tensor([[[32., 34, 36, 38], [64, 66, 68, 70]]], device=dev)
    assert torch.equal(embedding_bag_flat_plain(flat, offsets, idx), want)
    for name in KERNELS:
        got = getattr(ops, name)(flat, offsets, idx)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (name, got)
        n += 1
    log(f"[kernels] {n} bag cases on the card (rows past the shard's end "
        f"read its last row, as in the reference): fp32 bitwise equal to "
        f"the plain version, bf16 within {BF16_TOL}")
    n = 0
    for (T, R, D, B, P, fill, holes) in cases.NMP_GRID:
        for dtype in (torch.float32, torch.bfloat16):
            rng = np.random.RandomState(T * 1000 + D + P)
            flat = cases.randn(rng, (T * R, D), dev, dtype)
            slots = rng.permutation(T).astype(np.int32)   # shuffled shard
            offsets = torch.from_numpy(slots * R).to(dev)
            idx = torch.from_numpy(
                cases.nmp_idx(rng, R, B, T, P, fill, holes)).to(dev)
            want = embedding_bag_flat_plain(flat, offsets, idx)
            for name in KERNELS:
                got = getattr(ops, name)(flat, offsets, idx)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (name, T, R, D, B, P, dtype)
                n += 1
            sched = nmp_schedule(dtype, B, T, D, D % 4 == 0)
            chunks, k = cases.nmp_schedule(D, flat.element_size(),
                                           D % 4 == 0)
            assert sched["chunks"] == chunks and sched["K"] == k, sched
    log(f"[kernels] {n} bag cases at the NMP kernel's edges: fp32 and bf16 "
        f"bitwise equal to the plain version; the library's NMP schedule "
        f"is cases.nmp_schedule's")


def nmp_schedule(dtype, B, T, D, vec):
    """The schedule ``eb_nmp_flat`` launches with for these shapes, as
    the built library reports it (``eb_nmp_schedule``)."""
    import ctypes
    from repro_torch.kernels import build, common
    fn = build.load("embedding_bag").eb_nmp_schedule
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    out = (ctypes.c_int * 4)()
    assert fn(common.DTYPE_CODES[dtype], B, T, D, int(vec), out) == 0
    return dict(zip(("grid", "warps_per_block", "chunks", "K"), out))


def check_attention_grid(dev) -> None:
    from repro_torch.kernels import cases, ops
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.kernels.flash_decode import flash_decode_plain
    n, worst = 0, 0.0
    for (B, H, Hkv, S, T, D) in cases.ATTN_GRID:
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                rng = np.random.RandomState(S + T + D)
                q = cases.randn(rng, (B, H, S, D), dev, dtype)
                k = cases.randn(rng, (B, Hkv, T, D), dev, dtype)
                v = cases.randn(rng, (B, Hkv, T, D), dev, dtype)
                got = ops.flash_attention(q, k, v, causal=causal)
                torch.cuda.synchronize()
                want = flash_attention_plain(q, k, v, causal=causal)
                atol, rtol = cases.ATTN_TOL[dtype]
                torch.testing.assert_close(
                    got.float(), want.float(), atol=atol, rtol=rtol,
                    msg=f"flash_attention {(B, H, Hkv, S, T, D)} {dtype} "
                        f"causal={causal}")
                worst = max(worst, float((got.float() - want.float()).abs()
                                         .max()))
                n += 1
    for (B, H, Hkv, T, D, pos, off) in cases.DECODE_GRID:
        for dtype in (torch.float32, torch.bfloat16):
            rng = np.random.RandomState(T + D + pos)
            q = cases.randn(rng, (B, H, D), dev, dtype)
            kc = cases.randn(rng, (B, T, Hkv, D), dev, dtype)
            vc = cases.randn(rng, (B, T, Hkv, D), dev, dtype)
            pos_t = torch.tensor(pos, dtype=torch.int32, device=dev)
            got = ops.flash_decode_partial(q, kc, vc, pos_t, kv_offset=off)
            torch.cuda.synchronize()
            want = flash_decode_plain(q, kc, vc, pos_t, kv_offset=off)
            for g, w, tol in zip(got, want, cases.DECODE_TOL):
                torch.testing.assert_close(g, w, atol=tol, rtol=tol)
            if off > pos:
                o, l, m = got
                assert not o.any() and not l.any()
                assert bool((m == -1e30).all())
            n += 1
    log(f"[kernels] {n} attention cases on the card: flash_attention "
        f"within (atol, rtol) {cases.ATTN_TOL[torch.float32]} (fp32) and "
        f"{cases.ATTN_TOL[torch.bfloat16]} (bf16) of the plain version "
        f"(worst {worst:.3g}), flash_decode_partial within "
        f"{cases.DECODE_TOL} on "
        f"(o, l, m); a slice wholly after pos gives m = -1e30, l = o = 0")


def median_ms(fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, iters: int = 50) -> float:
    """Device time per call of ``fn`` over ``iters`` calls back to back.
    A sleep kernel holds the stream while the host enqueues them, so the
    events time the device's work and not the host's dispatch, which
    ``median_ms`` includes where a call's device work is shorter than its
    launch path; fails if the host fell behind the device all the same."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    assert not a.query(), "the host fell behind: lengthen the sleep"
    b.synchronize()
    return a.elapsed_time(b) / iters


def host_ms(fn, iters: int = 100) -> float:
    """Host time per call of ``fn``: its checks, allocations and launch
    enqueue, with a sleep kernel holding the stream so that no call
    waits for the device; fails if the device caught up all the same."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    done = torch.cuda.Event()
    done.record()
    assert not done.query(), "the device caught up: lengthen the sleep"
    torch.cuda.synchronize()
    return dt / iters * 1e3


def bag_library(flat, offsets, idx):
    """The library yardstick of the bag kernels: one
    ``torch.nn.functional.embedding_bag(mode="sum")`` call over the same
    flat table, reading row offsets[t] + idx of each valid slot; returns
    a function that gives the pooled (B, T, D)."""
    B, T, _ = idx.shape
    valid = idx >= 0
    ids = (offsets.to(torch.int64)[None, :, None]
           + idx.to(torch.int64))[valid]
    counts = valid.sum(dim=2).reshape(-1)
    bag_off = torch.zeros_like(counts)
    bag_off[1:] = torch.cumsum(counts, 0)[:-1]
    return lambda: torch.nn.functional.embedding_bag(
        ids, flat, bag_off, mode="sum").reshape(B, T, flat.shape[1])


def time_kernel(name, flat, offsets, idx, launches, card):
    """Time one kernel at one main-path launch's exact inputs."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.embedding_bag import embedding_bag_flat_plain
    kernel = getattr(ops, name)
    out = kernel(flat, offsets, idx)
    plain = embedding_bag_flat_plain(flat, offsets, idx)
    err = float((out - plain).abs().max())
    assert torch.equal(out, plain), (name, err)
    if name == "embedding_bag_nmp_flat":
        assert torch.equal(kernel(flat, offsets, idx), out)
    B, T, P = idx.shape
    D = flat.shape[1]
    n_valid = int((idx >= 0).sum())
    library = bag_library(flat, offsets, idx)
    lib_err = float((library() - out).abs().max())
    ms = median_ms(lambda: kernel(flat, offsets, idx), iters=50)
    plain_ms = median_ms(lambda: embedding_bag_flat_plain(flat, offsets, idx),
                         iters=5, warmup=1)
    library_ms = median_ms(library, iters=50)
    dev_ms = device_ms(lambda: kernel(flat, offsets, idx))
    library_dev_ms = device_ms(library)
    nbytes, flops = work(name, flat, idx, live=n_valid)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FP32_OPS_PER_S * 1e3
    row = {"name": name, "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/embedding_bag.cu",
           "replaces": KERNELS[name], "launches": launches,
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "library_ms": library_ms, "device_ms": dev_ms,
           "library_device_ms": library_dev_ms}
    if name == "embedding_bag_nmp_flat":
        row.update(nmp_build_fields(flat, B, T, D))
    log("[timing] " + json.dumps(dict(
        row, shape={"B": B, "T": T, "P": P, "D": D,
                    "shard_rows": flat.shape[0], "valid_slots": n_valid},
        bytes=nbytes, library_max_abs_err=lib_err, card=card)))
    return row


def nmp_build_fields(flat, B, T, D):
    """The NMP kernel's schedule at these inputs, two launches bitwise
    equal, and what ptxas gave its instantiation; fails if any NMP
    instantiation spills."""
    vec = (D % 4 == 0
           and flat.data_ptr() % (4 * flat.element_size()) == 0)
    sched = nmp_schedule(flat.dtype, B, T, D, vec)
    tname = "13__nv_bfloat16" if flat.dtype == torch.bfloat16 else "f"
    info = ptxas_info("embedding_bag", f"nmp_flat_kernelI{tname}"
                      f"Li{sched['chunks']}ELi{sched['K']}E")
    every = ptxas_all("embedding_bag", "nmp_flat_kernel")
    assert every and all(i["spill_bytes"] == 0 for i in every.values()), \
        every
    return dict(sched, deterministic=True,
                registers=info and info.get("registers"),
                spill_bytes=info and info.get("spill_bytes"),
                smem_bytes=info and info.get("static_smem_bytes"),
                nmp_instantiations=len(every))


class MainPathProbe:
    """Counts ``ClusterEngine._mn_pool`` calls and records the batch
    sizes executed per fleet model, keeps the first call's inputs for
    each kernel (so the timing phase can replay one real main-path
    launch; ``keep=False`` keeps none, so that a resize frees the old
    shards), times ``serve`` and, with ``profile``, traces it with
    ``torch.profiler``.  With ``check``, the first launch over each
    MN's shard with each set of tables (so after every resize, for every
    CN's routing and every fleet model) is held bitwise against the
    plain version on the same inputs as it happens; the checks' time is
    left out of ``serve_s``."""

    def __init__(self, profile: bool = False, keep: bool = True,
                 check: bool = False):
        from repro_torch.serving.cluster import ClusterEngine
        self.cls = ClusterEngine
        self.orig_pool = ClusterEngine._mn_pool
        self.orig_execute = ClusterEngine._execute
        self.orig_serve = ClusterEngine.serve
        self.profile = profile
        self.keep = keep
        self.check = check
        self.prof = None
        self.calls = 0
        self.sizes = {}
        self.first = {}
        self.checked = {}
        self.check_s = 0.0
        self.serve_s = 0.0

    def __enter__(self):
        probe = self

        def execute(eng, task, dense, idx, model=0):
            probe.sizes.setdefault(model, []).append(dense.shape[0])
            return probe.orig_execute(eng, task, dense, idx, model=model)

        def mn_pool(eng, j, tids, idx_sub):
            probe.calls += 1
            name = ("embedding_bag_nmp_flat" if eng.mn_nmp[j]
                    else "embedding_bag_fused_flat")
            flat = eng._shard_flat[j]
            key = (name, j, flat.shape[0], tuple(tids))
            if ((probe.keep and name not in probe.first)
                    or (probe.check and key not in probe.checked)):
                slots = [eng._shard_slot[j][t] for t in tids]
                offsets = torch.tensor(slots, dtype=torch.int32,
                                       device=idx_sub.device) * eng.R
            if probe.keep and name not in probe.first:
                probe.first[name] = (flat, offsets, idx_sub.clone())
            out = probe.orig_pool(eng, j, tids, idx_sub)
            if probe.check and key not in probe.checked:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                check_launch(name, flat, offsets, idx_sub, out)
                probe.checked[key] = tuple(idx_sub.shape)
                probe.check_s += time.perf_counter() - t0
            return out

        def serve(eng, *a, **kw):
            torch.cuda.synchronize()
            t0, c0 = time.perf_counter(), probe.check_s
            if probe.profile:
                acts = [torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]
                with torch.profiler.profile(activities=acts) as prof:
                    out = probe.orig_serve(eng, *a, **kw)
                    torch.cuda.synchronize()
                probe.prof = prof
            else:
                out = probe.orig_serve(eng, *a, **kw)
                torch.cuda.synchronize()
            probe.serve_s += (time.perf_counter() - t0
                              - (probe.check_s - c0))
            return out

        self.cls._mn_pool = mn_pool
        self.cls._execute = execute
        self.cls.serve = serve
        return self

    def __exit__(self, *exc):
        self.cls._mn_pool = self.orig_pool
        self.cls._execute = self.orig_execute
        self.cls.serve = self.orig_serve
        return False


def check_launch(name, flat, offsets, idx, out, rows: int = 4) -> None:
    """One main-path bag launch's output bitwise against the plain
    version on the same inputs, ``rows`` bags of each table at a time so
    that the plain version's gather stays small beside the peak memory
    the phase reports."""
    from repro_torch.kernels.embedding_bag import embedding_bag_flat_plain
    for b in range(0, idx.shape[0], rows):
        want = embedding_bag_flat_plain(flat, offsets, idx[b:b + rows])
        assert torch.equal(out[b:b + rows], want), (
            name, tuple(flat.shape), tuple(idx.shape), b,
            float((out[b:b + rows] - want).abs().max()))


class HostClock:
    """Serves on the host with nothing computed: no shard is built,
    every bag pools to zeros and every dense tower returns zeros, over
    zero-stride banks (``host_bank``).  The virtual clock reads only
    indices and bytes, so a card run's ``ScenarioReport.to_dict()`` must
    equal the same spec's under this stand-in field for field."""

    def __enter__(self):
        from repro_torch.models.dlrm import DLRMModel
        from repro_torch.serving.cluster import ClusterEngine
        stubs = {
            (ClusterEngine, "_build_shards"): lambda eng: None,
            (ClusterEngine, "_fleet_embed"): lambda eng: {
                "embed": torch.zeros(()).expand(eng.T, eng.R, eng.D)},
            (ClusterEngine, "_mn_pool"): lambda eng, j, tids, idx_sub:
                torch.zeros(idx_sub.shape[0], len(tids), eng.D),
            (DLRMModel, "dense_forward"): lambda m, params, dense, pooled:
                torch.zeros(dense.shape[0]),
        }
        self.orig = {k: getattr(*k) for k in stubs}
        for (cls, attr), fn in stubs.items():
            setattr(cls, attr, fn)
        return self

    def __exit__(self, *exc):
        for (cls, attr), fn in self.orig.items():
            setattr(cls, attr, fn)
        return False


def host_bank(cfg):
    """A zero-stride fp32 stand-in for ``cfg``'s (T, R, D) bank on the
    host: all ``HostClock`` needs of a model's parameters."""
    r = cfg.dlrm
    return {"embed": torch.zeros(()).expand(
        r.num_tables, r.rows_per_table, r.embed_dim)}


def same_report(a, b, path="report") -> None:
    """Equal field for field; nan equals nan."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            same_report(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            same_report(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and math.isnan(a):
        assert isinstance(b, float) and math.isnan(b), path
    else:
        assert a == b, (path, a, b)


def check_scores(reqs, outputs, model_of, dev) -> float:
    """Every request's scores finite, in [0, 1] and within SCORE_ATOL of
    its model's one-reduction path ``serve_step`` over 64-sample chunks;
    ``model_of(req)`` gives the (model, params) pair.  Returns the
    largest difference."""
    worst = 0.0
    for r in reqs:
        s = outputs[r.rid]
        assert s.shape == (r.size,) and np.all(np.isfinite(s)), r.rid
        assert np.all((s >= 0) & (s <= 1)), r.rid
        model, params = model_of(r)
        for c in range(0, r.size, 64):
            batch = {k: torch.from_numpy(v[c:c + 64]).to(dev)
                     for k, v in r.payload.items()}
            want = model.serve_step(params, batch).cpu().numpy()
            np.testing.assert_allclose(s[c:c + 64], want, rtol=0,
                                       atol=SCORE_ATOL)
            worst = max(worst, float(np.abs(s[c:c + 64] - want).max()))
    return worst


def profile_summary(prof, traced_s: float, wall_s: float, batches: int,
                    card: str, what: str = "serve", unit: str = "batch"
                    ) -> None:
    """Device busy time of a traced serve against the untraced serve's
    wall time ``wall_s`` (tracing slows the host many times over, the
    device work not at all), and the kernels and host ops that take the
    most time.  Busy time sums the device-side events (kernels, copies)
    only: a host op's own device time repeats that of the kernels it
    launched.  The serve loop runs on one stream, so device events do
    not overlap."""
    events = prof.key_averages()
    device = [e for e in events if e.device_type != torch.autograd.DeviceType.CPU
              and not getattr(e, "is_user_annotation", False)]
    host = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    log(f"[profile] traced {what}, {batches} x {unit}: device busy "
        f"{busy_ms:.3f} ms = {busy_ms / batches:.3f} ms/{unit}; idle share "
        f"{1 - busy_ms / (wall_s * 1e3):.4f} of the untraced {what}'s "
        f"{wall_s * 1e3:.1f} ms (traced wall {traced_s * 1e3:.1f} ms); "
        f"{card}")
    for label, evs, key in (
            ("device", device, lambda e: e.self_device_time_total),
            ("host", host, lambda e: e.self_cpu_time_total)):
        top = sorted(evs, key=key, reverse=True)[:8]
        log(f"[profile] top {label} (ms): " + "; ".join(
            f"{e.key[:60]} {key(e) / 1e3:.3f} x{e.count}" for e in top))


class LMProbe:
    """Keeps the inputs of the first flash-attention launch of each kind
    (causal or not, S = T or not: whisper's encoder, self and cross
    attention) and of the first and last flash-decode launch over each
    cache length (whisper's self and cross caches), by reference, with no
    copies: a cache slice's rows are written only at later positions;
    times ``model``'s prefill with host clocks around syncs, against the
    whole ``generate``; and sums the MoE pairs dropped at prefill on the
    device (no sync inside the run)."""

    def __init__(self, model):
        from repro_torch.kernels import ops
        from repro_torch.models import moe
        self.ops, self.moe, self.cls = ops, moe, type(model)
        self.orig = (ops.flash_attention, ops.flash_decode_partial,
                     moe.dispatch, self.cls.prefill)
        self.attn, self.decode_first, self.decode_last = {}, {}, {}
        self.dropped, self.pairs = [], 0
        self.in_prefill = False
        self.prefill_s = 0.0

    def __enter__(self):
        probe = self
        attn, decode, dispatch, prefill = self.orig

        def flash_attention(q, k, v, **kw):
            key = (kw.get("causal", True), q.shape[2] == k.shape[2])
            probe.attn.setdefault(key, (q, k, v, kw))
            return attn(q, k, v, **kw)

        def flash_decode_partial(q, kc, vc, pos, **kw):
            probe.decode_first.setdefault(kc.shape[1], (q, kc, vc, pos, kw))
            probe.decode_last[kc.shape[1]] = (q, kc, vc, pos, kw)
            return decode(q, kc, vc, pos, **kw)

        def counted_dispatch(ids, Ep, capacity):
            slot, keep = dispatch(ids, Ep, capacity)
            if probe.in_prefill:
                probe.dropped.append((~keep).sum())
                probe.pairs += keep.numel()
            return slot, keep

        def timed_prefill(model, *a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            probe.in_prefill = True
            out = prefill(model, *a, **kw)
            probe.in_prefill = False
            torch.cuda.synchronize()
            probe.prefill_s += time.perf_counter() - t0
            return out

        self.ops.flash_attention = flash_attention
        self.ops.flash_decode_partial = flash_decode_partial
        self.moe.dispatch = counted_dispatch
        self.cls.prefill = timed_prefill
        return self

    def __exit__(self, *exc):
        (self.ops.flash_attention, self.ops.flash_decode_partial,
         self.moe.dispatch, self.cls.prefill) = self.orig
        return False


class PlainAttention:
    """Routes the model's attention through the kernels' plain versions
    on the card, to hold the kernel path against it (never used by the
    port itself)."""

    def __enter__(self):
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import flash_decode as fd
        from repro_torch.kernels import ops
        self.ops = ops
        self.orig = (ops.flash_attention, ops.flash_decode_partial)
        ops.flash_attention = fa.flash_attention_plain
        ops.flash_decode_partial = fd.flash_decode_plain
        return self

    def __exit__(self, *exc):
        self.ops.flash_attention, self.ops.flash_decode_partial = self.orig
        return False


def _sdpa(q, k, v, causal):
    """``scaled_dot_product_attention`` with GQA, the library yardstick."""
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=causal, enable_gqa=True)


def bound(nbytes, flops, ops_per_s):
    """The least time the card could take for the work -> (ms, "bytes"
    or "operations"): the larger of the bytes over the memory rate and
    the operations over the peak rate."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / ops_per_s * 1e3
    return ((bytes_ms, "bytes") if bytes_ms >= ops_ms
            else (ops_ms, "operations"))


def peak_ops(dtype) -> float:
    return BF16_OPS_PER_S if dtype == torch.bfloat16 else FP32_OPS_PER_S


def work(name, *operands, **kw):
    """(bytes, flops) of one call of kernel ``name`` on these operands:
    ``ops.kernel_cost``, the definition the dry run costs by too."""
    from repro_torch.kernels import ops
    flops, nbytes = ops.kernel_cost(name, *operands, **kw)
    return nbytes, flops


def kernel_row(name, ms, plain_ms, library_ms, err, launches, nbytes, flops,
               ops_per_s):
    bound_ms, bound_by = bound(nbytes, flops, ops_per_s)
    return {"name": name, "route": "cuda", "source": ROW_KERNELS[name][1],
            "replaces": ROW_KERNELS[name][0], "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def ptxas_all(source: str, entry: str):
    """Registers, spill bytes and static shared memory that ptxas
    reported (``-v``) for each kernel of ``csrc/<source>.cu`` whose
    mangled name contains ``entry``, by mangled name, and whether it
    serialised that kernel's wgmmas ("Potential Performance Loss");
    empty when this process did not build the source."""
    import re
    from repro_torch.kernels import build
    log = build.BUILD_LOGS.get(source, "").splitlines()
    infos, info = {}, None
    for line in log:
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            info = infos.setdefault(name, {}) if entry in name else None
        elif info is not None and "spill stores" in line:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            info["spill_bytes"] = int(st) + int(ld)
        elif info is not None and "Used" in line and "registers" in line:
            info["registers"] = int(re.search(r"Used (\d+) registers",
                                              line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            info["static_smem_bytes"] = int(smem.group(1)) if smem else 0
    for name, info in infos.items():
        info["wgmma_serialized"] = any(
            "Performance Loss" in line and name in line for line in log)
    return infos


def ptxas_info(source: str, entry: str):
    """``ptxas_all``'s report of the first kernel whose mangled name
    contains ``entry``; None when this process did not build the
    source."""
    return next(iter(ptxas_all(source, entry).values()), None)


def compare_attention(q, k, v, kw):
    """flash_attention against its plain version on one launch's inputs
    (``cases.ATTN_TOL``) -> (the kernel's output, max abs error)."""
    from repro_torch.kernels import cases, ops
    from repro_torch.kernels.flash_attention import flash_attention_plain
    causal = kw.get("causal", True)
    got = ops.flash_attention(q, k, v, causal=causal)
    want = flash_attention_plain(q, k, v, causal=causal)
    atol, rtol = cases.ATTN_TOL[q.dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    return got, float((got.float() - want.float()).abs().max())


def hold_attention(q, k, v, kw):
    """``compare_attention`` -> (the kernel's output, max abs error, its
    device ms back to back, SDPA's)."""
    from repro_torch.kernels import ops
    causal = kw.get("causal", True)
    got, err = compare_attention(q, k, v, kw)
    return (got, err,
            device_ms(lambda: ops.flash_attention(q, k, v, causal=causal)),
            device_ms(lambda: _sdpa(q, k, v, causal)))


def live_rows(kc, pos, kw) -> int:
    """The cache rows a decode launch reads: those at or before ``pos``."""
    return min(int(pos) + 1 - kw.get("kv_offset", 0), kc.shape[1])


def compare_decode(q, kc, vc, pos, kw):
    """flash_decode_partial against its plain version on one launch's
    inputs (``cases.DECODE_TOL``), two launches bitwise equal -> (the
    kernel's partials, max abs error)."""
    from repro_torch.kernels import cases, ops
    from repro_torch.kernels.flash_decode import flash_decode_plain
    got = ops.flash_decode_partial(q, kc, vc, pos, **kw)
    want = flash_decode_plain(q, kc, vc, pos, **kw)
    for g, w, tol in zip(got, want, cases.DECODE_TOL):
        torch.testing.assert_close(g, w, atol=tol, rtol=tol)
    again = ops.flash_decode_partial(q, kc, vc, pos, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    return got, max(float((g - w).abs().max()) for g, w in zip(got, want))


def hold_decode(q, kc, vc, pos, kw):
    """``compare_decode`` -> (the kernel's partials, max abs error, their
    device ms back to back, SDPA's over the live rows: the normalised
    output)."""
    from repro_torch.kernels import ops
    got, err = compare_decode(q, kc, vc, pos, kw)
    n = live_rows(kc, pos, kw)
    qh, kh, vh = (q[:, :, None, :], kc[:, :n].transpose(1, 2),
                  vc[:, :n].transpose(1, 2))
    return (got, err,
            device_ms(lambda: ops.flash_decode_partial(q, kc, vc, pos,
                                                       **kw)),
            device_ms(lambda: _sdpa(qh, kh, vh, False)))


def time_attention(q, k, v, kw, launches, card):
    """flash_attention at the first prefill launch's inputs, and on fp32
    copies of them (same shapes and strides), each against its plain
    version: bf16 within two bf16 steps of each element, fp32 within
    2e-5 (``repro_torch.kernels.cases``)."""
    from repro_torch.kernels import cases, ops
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.flash_attention import flash_attention_plain
    causal = kw.get("causal", True)
    q32, k32, v32 = q.float(), k.float(), v.float()
    assert [t.stride() for t in (q32, k32, v32)] == \
        [t.stride() for t in (q, k, v)]
    out32 = ops.flash_attention(q32, k32, v32, causal=causal)
    plain32 = flash_attention_plain(q32, k32, v32, **kw)
    atol, rtol = cases.ATTN_TOL[torch.float32]
    torch.testing.assert_close(out32, plain32, atol=atol, rtol=rtol)
    err32 = float((out32 - plain32).abs().max())
    del q32, k32, v32, out32, plain32
    out, err, dev_ms, lib_dev_ms = hold_attention(q, k, v, kw)
    lib_err = float((_sdpa(q, k, v, causal).float() - out.float()).abs()
                    .max())
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    nbytes, flops = work("flash_attention", q, k, causal=causal)
    ms = median_ms(lambda: ops.flash_attention(q, k, v, causal=causal),
                   iters=50)
    plain_ms = median_ms(lambda: flash_attention_plain(q, k, v, **kw),
                         iters=5, warmup=1)
    library_ms = median_ms(lambda: _sdpa(q, k, v, causal), iters=50)
    ops_per_s = peak_ops(q.dtype)
    row = kernel_row("flash_attention", ms, plain_ms, library_ms, err,
                     launches, nbytes, flops, ops_per_s)
    # the same two calls' device time alone, without the host's dispatch
    row["device_ms"], row["library_device_ms"] = dev_ms, lib_dev_ms
    row["fp32_max_abs_err"] = err32     # the same inputs widened to fp32
    kind = fa.variant(q.dtype, D)
    row["variant"] = kind
    if kind == "wgmma":
        # P V runs twice (P_hi, P_lo): Q K^T plus two P V products
        row["tensor_bound_ms"] = 1.5 * flops / ops_per_s * 1e3
        info = ptxas_info("flash_attention", f"fa_wgmma_kernelILi{D}E")
        row["registers"] = info and info.get("registers")
        row["spill_bytes"] = info and info.get("spill_bytes")
        row["smem_bytes"] = fa.wgmma_smem_bytes(D)
        row["wgmma_serialized"] = info and info["wgmma_serialized"]
        assert info is None or (info["spill_bytes"] == 0
                                and not info["wgmma_serialized"]), info
    else:
        tname = "13__nv_bfloat16" if q.dtype == torch.bfloat16 else "f"
        info = ptxas_info("flash_attention",
                          f"flash_fwd_kernelI{tname}Li{D}E")
        row["registers"] = info and info.get("registers")
        row["spill_bytes"] = info and info.get("spill_bytes")
        assert info is None or info["spill_bytes"] == 0, info
    log("[timing] " + json.dumps(dict(
        row, shape={"B": B, "H": H, "Hkv": Hkv, "S": S, "T": T, "D": D,
                    "causal": causal, "dtype": str(q.dtype)},
        bytes=nbytes, flops=flops, library_max_abs_err=lib_err,
        library="scaled_dot_product_attention(is_causal, enable_gqa)",
        card=card)))
    return row


def time_decode(q, kc, vc, pos, kw, launches, card):
    """flash_decode_partial at the last decode launch's inputs.  The
    library yardstick, SDPA over cache[:, :pos+1], computes the
    normalised output: the kernel's partials plus the combine.  Two
    launches must be bitwise equal (the splits merge in a fixed order)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels.flash_decode import flash_decode_plain
    from repro_torch.models.layers import combine_partials
    got, err, dev_ms, lib_dev_ms = hold_decode(q, kc, vc, pos, kw)
    B, H, D = q.shape
    T, Hkv = kc.shape[1], kc.shape[2]
    n = live_rows(kc, pos, kw)                     # rows this step reads
    qh = q[:, :, None, :]
    kh = kc[:, :n].transpose(1, 2)
    vh = vc[:, :n].transpose(1, 2)
    lib_err = float((_sdpa(qh, kh, vh, False)[:, :, 0].float()
                     - combine_partials(*got)).abs().max())
    nbytes, flops = work("flash_decode_partial", q, kc, live=n)
    ms = median_ms(lambda: ops.flash_decode_partial(q, kc, vc, pos, **kw),
                   iters=50)
    plain_ms = median_ms(lambda: flash_decode_plain(q, kc, vc, pos, **kw),
                         iters=5, warmup=1)
    library_ms = median_ms(lambda: _sdpa(qh, kh, vh, False), iters=50)
    ops_per_s = peak_ops(q.dtype)
    row = kernel_row("flash_decode_partial", ms, plain_ms, library_ms, err,
                     launches, nbytes, flops, ops_per_s)
    # the same calls' device time alone, without the host's dispatch
    row["device_ms"], row["library_device_ms"] = dev_ms, lib_dev_ms
    # the wrapper's host path per call, which paces the eager decode step
    row["host_ms"] = host_ms(
        lambda: ops.flash_decode_partial(q, kc, vc, pos, **kw))
    row["library_host_ms"] = host_ms(lambda: _sdpa(qh, kh, vh, False))
    splits = fd.num_splits(B, Hkv, T, torch.cuda.get_device_properties(
        q.device).multi_processor_count)
    row["splits"] = splits
    row["grid"] = [splits, Hkv, B]
    row["deterministic"] = True
    G = H // Hkv
    tname = "13__nv_bfloat16" if q.dtype == torch.bfloat16 else "f"
    info = ptxas_info("flash_decode", f"fd_split_kernelI{tname}Li{D}E"
                                      f"Li{min(G, 4)}E")
    row["registers"] = info and info.get("registers")
    row["spill_bytes"] = info and info.get("spill_bytes")
    row["smem_bytes"] = info and info.get("static_smem_bytes")
    assert info is None or info["spill_bytes"] == 0, info
    log("[timing] " + json.dumps(dict(
        row, shape={"B": B, "H": H, "Hkv": Hkv, "T": T, "D": D,
                    "pos": int(pos), "rows_read": n, "dtype": str(q.dtype)},
        bytes=nbytes, flops=flops, library_max_abs_err=lib_err,
        library="scaled_dot_product_attention over cache[:, :pos+1] "
                "(normalised output: kernel plus combine)",
        card=card)))
    return row


def sharded_phase(dev, cfg, model, params, reqs, card):
    """RM1 V0's table-sharded lookup on one card (the reference's
    single-host branch): lays the bank out with the greedy allocator,
    pools through the stacked kernel, holds the result against the fused
    kernel and the plain version, and times the kernel; returns its
    row."""
    from repro_torch.core.sharding import (disagg_embedding_lookup,
                                           greedy_table_layout)
    from repro_torch.kernels import ops
    from repro_torch.kernels.embedding_bag import embedding_bag_stacked_plain
    batch = {k: torch.from_numpy(np.concatenate(
        [r.payload[k] for r in reqs])[:SHARDED_BATCH]).to(dev)
        for k in ("dense", "indices")}
    idx = batch["indices"]
    assert idx.shape[0] == SHARDED_BATCH, idx.shape
    embed = params["embed"]
    fused = ops.embedding_bag_fused(embed, idx)           # kernel #1
    perm, inv, _, _ = greedy_table_layout(cfg, m=4)
    perm_t = torch.from_numpy(perm).to(dev, torch.int64)
    inv_t = torch.from_numpy(inv).to(dev, torch.int64)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stack = embed[perm_t]                          # MN-ordered stack
    idx_p = idx[:, perm_t].contiguous()
    ops.reset_launches()
    pooled = disagg_embedding_lookup(stack, idx_p, mesh=None,
                                     use_kernel=True)[:, inv_t]
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    assert launches["embedding_bag"] == 1, launches
    assert sum(launches.values()) == 1, launches
    assert peak_gb * 1e9 < CARD_BYTES, peak_gb
    assert torch.equal(pooled, fused)
    plain = embedding_bag_stacked_plain(stack, idx_p)
    assert torch.equal(plain[:, inv_t], pooled)
    plain_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    scores = model.dense_forward(params, batch["dense"], pooled)
    want = model.dense_forward(params, batch["dense"], fused)
    assert torch.equal(scores, want)
    assert bool(torch.isfinite(scores).all())
    valid = idx_p >= 0
    n_valid = int(valid.sum())
    log(f"[sharded] disagg_embedding_lookup(mesh=None, use_kernel=True) "
        f"over the {tuple(stack.shape)} stack in greedy_table_layout(m=4) "
        f"order, batch {SHARDED_BATCH}, {n_valid} valid slots "
        f"({n_valid / valid[..., 0].numel():.1f} per bag): launches "
        f"{launches}; pooled output bitwise equal to the fused kernel's "
        f"over the unpermuted bank and to the plain version; scores "
        f"bitwise equal; peak device memory {peak_gb:.3f} GB (layout and "
        f"lookup), {plain_peak_gb:.3f} GB with the plain version; {card}")
    del plain, scores, want, fused

    t16 = stack[:64].to(torch.bfloat16)
    i16 = idx_p[:, :64].contiguous()
    got16 = ops.embedding_bag(t16, i16)
    assert got16.dtype == torch.bfloat16
    assert torch.equal(got16, embedding_bag_stacked_plain(t16, i16))
    log(f"[sharded] bf16 copy of 64 tables {tuple(t16.shape)}: the kernel "
        f"bitwise equal to its plain version")
    del t16, i16, got16

    out = ops.embedding_bag(stack, idx_p)
    err = float((out - embedding_bag_stacked_plain(stack, idx_p)).abs()
                .max())
    T, R, D = stack.shape
    # the (T*R, D) view, each valid slot's row clamped into its table
    library = bag_library(
        stack.view(T * R, D),
        torch.arange(T, dtype=torch.int32, device=dev) * R,
        idx_p.clamp(max=R - 1))
    lib_err = float((library() - out).abs().max())
    ms = median_ms(lambda: ops.embedding_bag(stack, idx_p), iters=50)
    plain_ms = median_ms(lambda: embedding_bag_stacked_plain(stack, idx_p),
                         iters=5, warmup=1)
    library_ms = median_ms(library, iters=50)
    B, _, P = idx_p.shape
    nbytes, flops = work("embedding_bag", stack, idx_p, live=n_valid)
    row = kernel_row("embedding_bag", ms, plain_ms, library_ms, err,
                     launches["embedding_bag"], nbytes, flops,
                     FP32_OPS_PER_S)
    row["device_ms"] = device_ms(lambda: ops.embedding_bag(stack, idx_p))
    row["library_device_ms"] = device_ms(library)
    log("[timing] " + json.dumps(dict(
        row, shape={"B": B, "T": T, "P": P, "D": D, "R": R,
                    "valid_slots": n_valid},
        bytes=nbytes, library_max_abs_err=lib_err, card=card)))
    return row


def serve_line(phase, what, rep, probe, launches, card) -> None:
    """One phase's serve numbers: wall per batch, the pool, resizes and
    migrated bytes, launches and peak device memory."""
    eng, st = rep.engine, rep.stats
    log(f"[{phase}] {what}: {rep.completed}/{rep.total} requests in "
        f"{eng.batches_seen} batches, serve wall {probe.serve_s:.3f} s = "
        f"{probe.serve_s / eng.batches_seen * 1e3:.2f} ms/batch; final pool "
        f"{{{rep.final_n_cn} CN, {rep.final_m_mn} MN}} "
        f"{list(rep.mn_types)}; resizes {st.resizes}, migration_bytes "
        f"{st.migration_bytes:.0f}, SLA actions {st.sla_actions}; "
        f"virtual p99 {st.p99 * 1e3:.3f} ms; launches {launches}; peak "
        f"device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
        f"{card}")
    if probe.check:
        log(f"[{phase}] the first launch over each shard and table set, "
            f"bitwise equal to the plain version on its inputs: " + "; ".join(
                f"{name} x{len(v)}, (B, T, P) from {min(v)} to {max(v)}"
                for name in KERNELS
                for v in [[s for k, s in probe.checked.items()
                           if k[0] == name]] if v)
            + f"; the checks took {probe.check_s:.3f} s, left out of the "
            f"wall")


def host_clock_check(phase, what, rep, run) -> None:
    """``rep``, a card run's report, equals ``run()``'s under
    ``HostClock`` field for field (nan equal to nan)."""
    t0 = time.perf_counter()
    with HostClock():
        host = run()
    same_report(rep.to_dict(), host.to_dict())
    log(f"[{phase}] {what}: the report (stats, phases, events, pool) "
        f"equals the same spec's on the host with nothing computed, field "
        f"for field ({time.perf_counter() - t0:.2f} s on the host)")


def elastic_phase(model, params, flags, stream, scores, card) -> None:
    """SLA-driven and schedule-driven elasticity at RM1's full widths on
    the ``[serve]`` bank: (a) the ``[serve]`` flags plus ``--elastic``
    (the diurnal ``Autoscaler`` plan as timed resizes, with the FailMN)
    on the same stream, scores bitwise equal to ``[serve]``'s; (b) a
    {1 CN, 2 MN} pool served without an SLA, its scores held to the
    model's one-reduction path, then with the SLA controller held to
    half of that run's virtual-clock p99, which must act, grow the pool
    and leave the scores bitwise unchanged.  In every run each shard
    layout's first launch is held bitwise against the plain version,
    and the report against the host clock's."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.serving.scenario import Resize, plan_workload, run_scenario
    bank = host_bank(model.cfg)

    def run(tag, argv, stream, kernels=KERNELS):
        spec = serve.spec_from_flags(serve.parser().parse_args(argv))
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        with MainPathProbe(keep=False, check=True) as probe:
            rep = run_scenario(spec, model=model, params=params,
                               stream=stream)
        launches = dict(ops.LAUNCHES)
        planned = [e for e in spec.events if isinstance(e, Resize)]
        serve_line("elastic", f"{tag} {' '.join(argv)}" + (
            f" ({len(planned)} planned Resize events: " + ", ".join(
                f"{e.time_s * 1e3:g} ms -> {{{e.n_cn}, {e.m_mn}}}"
                for e in planned) + ")" if planned else ""),
            rep, probe, launches, card)
        assert rep.completed == rep.total == len(stream[0])
        assert all(launches[k] > 0 for k in kernels), launches
        assert sum(launches.values()) == probe.calls, (launches, probe.calls)
        host_clock_check("elastic", tag, rep, lambda: run_scenario(
            spec, model=model, params=bank, stream=stream, device="cpu"))
        return rep

    # the plan's first Resize (t=0) shrinks the pool to its first two MNs,
    # both DDR, and the MNs it adds later are of the pool's default type
    # (DDR): this run launches the fused kernel only
    rep = run("(a)", flags + ["--mn-type", "2xddr_mn+2xnmp_mn", "--elastic"],
              stream, kernels=["embedding_bag_fused_flat"])
    assert rep.stats.resizes >= 1, rep.stats.resizes
    for r in rep.results:
        assert np.array_equal(r.outputs, scores[r.rid]), r.rid
    log("[elastic] (a) scores bitwise equal to the [serve] phase's")
    del rep
    gc.collect()
    torch.cuda.empty_cache()

    base = ["--cluster", "--full", "--cns", "1", "--mns", "2", "--replicas",
            "2", "--batch", "64", "--requests", str(ELASTIC_REQUESTS),
            "--mn-type", "ddr_mn,nmp_mn"]
    spec0 = serve.spec_from_flags(serve.parser().parse_args(base))
    stream_b = plan_workload(spec0, model.cfg)
    rep0 = run("(b)", base, stream_b)
    target_ms = rep0.stats.p99 * 1e3 / 2
    want = {r.rid: r.outputs for r in rep0.results}
    del rep0
    gc.collect()
    torch.cuda.empty_cache()
    worst = check_scores(stream_b[0], want, lambda r: (model, params),
                         params["embed"].device)
    log(f"[elastic] (b) no SLA: every score finite, in [0, 1], and within "
        f"{SCORE_ATOL} of the model's one-reduction path (worst "
        f"{worst:.3g})")
    rep = run("(b) SLA", base + ["--sla-p99-ms", repr(target_ms)], stream_b)
    st = rep.stats
    assert st.sla_actions >= 1 and st.sla_window_filled, st
    assert (rep.final_n_cn >= 1 and rep.final_m_mn >= 2
            and (rep.final_n_cn, rep.final_m_mn) != (1, 2)), \
        (rep.final_n_cn, rep.final_m_mn)
    for r in rep.results:
        assert np.array_equal(r.outputs, want[r.rid]), r.rid
    log(f"[elastic] (b) with --sla-p99-ms {target_ms!r} (half the run's "
        f"p99) the controller emitted {st.sla_actions} resize action(s), "
        f"window filled; scores bitwise equal to the run without an SLA")
    del rep
    gc.collect()
    torch.cuda.empty_cache()


def fleet_phase(dev, card) -> None:
    """RM1 V0 and RM2 V0 at their published widths, ``rows_per_table``
    cut to FLEET_ROWS in both (the shared pool needs one table shape),
    served as one fleet under ``fleet_shift``'s traffic on the
    ``[serve]`` pool through ``run_fleet`` with hand-built members;
    each shard layout's first launch is held bitwise against the plain
    version, the report against the host clock's."""
    from repro_torch.configs import rm1, rm2
    from repro_torch.kernels import ops
    from repro_torch.models.dlrm import DLRMModel
    from repro_torch.serving.fleet import (FleetModel, plan_fleet_workload,
                                           run_fleet)
    from repro_torch.serving.scenario import ModelRef, ScenarioSpec, preset

    cfgs = [mod.CONFIG.replace(
        name=f"{mod.CONFIG.name}-rows{FLEET_ROWS // 1000}k",
        dlrm=dataclasses.replace(mod.CONFIG.dlrm, rows_per_table=FLEET_ROWS))
        for mod in (rm1, rm2)]
    log("[fleet] RM1 V0 + RM2 V0 at their published widths on one pool; "
        "cuts: " + ", ".join(
            f"{mod.CONFIG.name} rows_per_table "
            f"{mod.CONFIG.dlrm.rows_per_table} -> {FLEET_ROWS}"
            for mod in (rm1, rm2)) + " (one table shape for the pool)")
    for cfg in cfgs:
        log(f"[fleet] {cfg.name}: {dataclasses.asdict(cfg.dlrm)}")
    shift = preset("fleet_shift")
    spec = ScenarioSpec(
        name="fleet_shift-full", workload=shift.workload,
        events=shift.events,
        models=tuple(ModelRef(arch=a, reduced=False, rate_share=0.5)
                     for a in ("rm1", "rm2")),
        topology=dataclasses.replace(
            shift.topology, batch_size=64, n_cn=2, m_mn=4, n_replicas=2,
            mn_types=("ddr_mn", "ddr_mn", "nmp_mn", "nmp_mn")))
    torch.cuda.reset_peak_memory_stats()
    members = []
    for ref, cfg in zip(spec.models, cfgs):
        model = DLRMModel(cfg)
        members.append(FleetModel(name=ref.arch, ref=ref, model=model,
                                  params=model.init(0, device=dev)))
    ops.reset_launches()
    with MainPathProbe(keep=False, check=True) as probe:
        rep = run_fleet(spec, fleet=members, device=dev)
    launches = dict(ops.LAUNCHES)
    serve_line("fleet", f"fleet_shift's traffic ({spec.workload.requests} "
               f"requests, seed {spec.workload.seed}, cache_mb "
               f"{spec.topology.cache_mb}, {len(spec.events)} events) on "
               f"{{2 CN, 4 MN}} 2xddr_mn+2xnmp_mn, batch 64", rep, probe,
               launches, card)
    cs = rep.engine.cache_stats()
    sizes = {members[k].name: collections.Counter(n)
             for k, n in sorted(probe.sizes.items())}
    log(f"[fleet] batches executed per model "
        f"{ {k: sum(n.values()) for k, n in sizes.items()} }, by size "
        f"(the engine pads each to the batch size) "
        f"{ {k: dict(n) for k, n in sizes.items()} }; hot-row cache "
        f"probes {cs.probes} (one Python lookup each, "
        f"{probe.serve_s / cs.probes * 1e6:.2f} us of serve wall per "
        f"probe); per-model stats " + "; ".join(
            f"{n}: {m.completed}/{m.queries} completed, p99 "
            f"{m.p99 * 1e3:.3f} ms, {m.cache_hits} cache hits"
            for n, m in rep.stats.per_model.items()))
    assert rep.completed == rep.total == spec.workload.requests
    assert set(rep.stats.per_model) == {"rm1", "rm2"}
    assert all(m.completed > 0 for m in rep.stats.per_model.values())
    assert all(launches[k] > 0 for k in KERNELS), launches
    assert sum(launches.values()) == probe.calls, (launches, probe.calls)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    outputs = {r.rid: r.outputs for r in rep.results}
    host = [dataclasses.replace(m, params=host_bank(m.model.cfg))
            for m in members]
    host_clock_check("fleet", "fleet_shift", rep,
                     lambda: run_fleet(spec, fleet=host, device="cpu"))
    del rep, probe
    gc.collect()
    torch.cuda.empty_cache()
    reqs, _ = plan_fleet_workload(spec, members)   # the stream run_fleet served
    worst = check_scores(reqs, outputs, lambda r: (
        members[r.model].model, members[r.model].params), dev)
    log(f"[fleet] every score finite, in [0, 1], and within {SCORE_ATOL} "
        f"of its member's one-reduction path (worst {worst:.3g}); samples "
        f"per request " + ", ".join(
            f"{m.name} mean {np.mean(n):.2f} max {max(n)}"
            for k, m in enumerate(members)
            for n in [[q.size for q in reqs if q.model == k]]))
    for batch in sorted(sizes["rm2"]):     # the sizes the fleet ran
        rm2_dense_trace(members[1], dev, card, batch)
    log(f"[fleet] peak device memory {peak_gb:.2f} GB (both banks, their "
        f"concatenation, two replica copies, RM2's dense tower); {card}")
    del members, outputs, reqs
    gc.collect()
    torch.cuda.empty_cache()


def rm2_dense_trace(member, dev, card, batch: int, steps: int = 5) -> None:
    """RM2's dense tower at ``batch`` samples, a size the fleet's serve
    ran it at, under ``torch.profiler``: device ms per batch and the
    GEMM kernels' share of it, beside its FLOP count over the fp32 rate
    and its weights read once over the memory rate."""
    from repro_torch.configs import counting
    cfg = member.model.cfg
    r = cfg.dlrm
    g = torch.Generator(device=dev).manual_seed(0)
    dense = torch.randn(batch, r.num_dense_features, device=dev, generator=g)
    pooled = torch.randn(batch, r.num_tables, r.embed_dim, device=dev,
                         generator=g)
    step = lambda: member.model.dense_forward(member.params, dense, pooled)
    step()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    device = [e for e in prof.key_averages()
              if e.device_type != torch.autograd.DeviceType.CPU
              and not getattr(e, "is_user_annotation", False)]
    busy = sum(e.self_device_time_total for e in device) / 1e3 / steps
    gemm = sum(e.self_device_time_total for e in device
               if "gemm" in e.key.lower() or "cutlass" in e.key.lower()
               ) / 1e3 / steps
    flops = batch * counting.dlrm_dense_flops(cfg)
    nbytes = sum(t.numel() * t.element_size()
                 for k, v in member.params.items() if k != "embed"
                 for t in (v.values() if isinstance(v, dict) else [v]))
    ops_ms = flops / FP32_OPS_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"[fleet] RM2 dense tower, batch {batch} as the fleet ran it, "
        f"traced x{steps}: device {busy:.3f} ms/batch, GEMM kernels {gemm:.3f} ms "
        f"({gemm / busy:.3f} of it); {flops / 1e9:.2f} GFLOP, fp32 bound "
        f"{ops_ms:.3f} ms, weights {nbytes / 1e9:.3f} GB over the memory "
        f"rate {bytes_ms:.3f} ms; top: " + "; ".join(
            f"{e.key[:50]} {e.self_device_time_total / 1e3 / steps:.3f}"
            for e in sorted(device, key=lambda e: e.self_device_time_total,
                            reverse=True)[:4]) + f"; {card}")


def lm_trace(model, params, prompt, prefill_s, step_s, card,
             steps: int = 8, cache_len: int = LM_CACHE, extra=None,
             what: str = "lm", prefill_host: bool = True) -> None:
    """The main path's prefill, then ``steps`` decode steps, once more
    under ``torch.profiler``: device busy time and idle share against
    the untraced times, and the top kernels of each.  Without
    ``prefill_host`` the prefill's trace holds the device alone (rwkv6's
    token loop makes some 65,000 launches a prefill, whose host events
    would take ``key_averages`` most of a minute)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    dev = params["embed"].device
    batch = dict(extra or {}, tokens=torch.from_numpy(prompt).to(dev))
    with torch.profiler.profile(
            activities=acts if prefill_host else acts[1:]) as prof:
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, batch, cache_len=cache_len)
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    profile_summary(prof, traced_s, prefill_s, 1, card,
                    what=f"{what} prefill", unit="prefill")
    tok = logits[:, -1].argmax(dim=-1)[:, None].to(torch.int32)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, cache = model.decode_step(params, cache, {"tokens": tok})
            tok = logits[:, -1].argmax(dim=-1)[:, None].to(torch.int32)
            tok.cpu()
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    profile_summary(prof, traced_s, step_s * steps, steps, card,
                    what=f"{what} decode", unit="step")


def lm_phase(dev, card):
    """smollm-135m at full width through LMServingEngine; returns the
    two attention kernels' rows."""
    from repro_torch.configs import smollm_135m
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import registry
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.serving.engine import LMServingEngine

    cfg = smollm_135m.CONFIG
    model = registry.build(cfg)
    params = model.init(0, device=dev)
    n_params = sum(t.numel() for t in tree_leaves(params))
    assert n_params == model.param_count(), (n_params, model.param_count())
    log(f"[lm] {cfg.name} at its published widths, nothing cut: "
        f"{cfg.num_layers} layers, d {cfg.d_model}, {cfg.num_heads} heads "
        f"over {cfg.num_kv_heads} kv heads, head_dim "
        f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, tied={cfg.tie_embeddings}, {cfg.dtype}; "
        f"{n_params} parameters")
    rng = np.random.RandomState(0)
    prompt = rng.randint(0, cfg.vocab_size,
                         (LM_BATCH, LM_PROMPT)).astype(np.int32)
    engine = LMServingEngine(model, params, cache_len=LM_CACHE, device=dev)
    engine.generate(prompt[:, :64], steps=2)          # warm-up: cuBLAS etc.
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    with LMProbe(model) as probe:
        t0 = time.perf_counter()
        tokens = engine.generate(prompt, steps=LM_STEPS)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    variants = dict(fa.VARIANT_LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    decode_s = total_s - probe.prefill_s
    log(f"[lm] generate: batch {LM_BATCH}, prompt {LM_PROMPT}, cache "
        f"{LM_CACHE}, {LM_STEPS} steps; launches {launches}; prefill "
        f"{probe.prefill_s * 1e3:.3f} ms; decode "
        f"{decode_s / LM_STEPS * 1e3:.3f} ms per token (step of "
        f"{LM_BATCH} sequences); {LM_BATCH * LM_STEPS / decode_s:.1f} "
        f"generated tokens/s; whole generate {total_s * 1e3:.1f} ms; peak "
        f"device memory {peak_gb:.3f} GB; {card}")
    assert launches["flash_attention"] == cfg.num_layers, launches
    assert variants == {"wgmma": cfg.num_layers, "scalar": 0}, variants
    log(f"[lm] flash-attention launches by kernel: {variants}")
    assert launches["flash_decode_partial"] == cfg.num_layers * LM_STEPS, \
        launches
    assert launches["embedding_bag_fused_flat"] == 0
    assert launches["embedding_bag_nmp_flat"] == 0
    assert tokens.shape == (LM_BATCH, LM_STEPS) and tokens.dtype == np.int32
    assert tokens.min() >= 0 and tokens.max() < model.vp
    log(f"[lm] tokens (B, steps) = {tokens.shape}, first sequence "
        f"{tokens[0, :16].tolist()}...")

    # a decode step at full width never waits for the card
    logits, cache = model.prefill(
        params, {"tokens": torch.from_numpy(prompt[:, :64]).to(dev)},
        cache_len=128)
    tok = logits[:, -1].argmax(dim=-1)[:, None].to(torch.int32)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        model.decode_step(params, cache, {"tokens": tok})
    finally:
        torch.cuda.set_sync_debug_mode(0)
    del logits, cache, tok
    log("[lm] a decode step ran under sync debug mode 'error': no host "
        "sync inside it")
    lm_trace(model, params, prompt, probe.prefill_s, decode_s / LM_STEPS,
             card)
    rows = [time_attention(*probe.attn[(True, True)],
                           launches["flash_attention"], card),
            time_decode(*probe.decode_last[LM_CACHE],
                        launches["flash_decode_partial"], card)]
    del probe, engine
    gc.collect()
    torch.cuda.empty_cache()

    # The same full-width model in fp32 on a small input: the kernel path
    # against the plain versions on the card (the repo's own parity
    # tolerance for fp32 logits, 1e-4) and equal greedy tokens.
    cfg32 = cfg.replace(dtype="float32", param_dtype="float32")
    model32 = registry.build(cfg32)
    params32 = tree_map(lambda t: t.float(), params)
    small = prompt[:2, :96]
    batch = {"tokens": torch.from_numpy(small).to(dev)}
    ops.reset_launches()
    logits_k, _ = model32.prefill(params32, batch, cache_len=128)
    tok_k = LMServingEngine(model32, params32, cache_len=128,
                            device=dev).generate(small, steps=8)
    assert ops.LAUNCHES["flash_attention"] == 2 * cfg.num_layers
    assert fa.VARIANT_LAUNCHES == {"wgmma": 0,
                                   "scalar": 2 * cfg.num_layers}
    assert ops.LAUNCHES["flash_decode_partial"] == 8 * cfg.num_layers
    with PlainAttention():
        logits_p, _ = model32.prefill(params32, batch, cache_len=128)
        tok_p = LMServingEngine(model32, params32, cache_len=128,
                                device=dev).generate(small, steps=8)
    assert bool(torch.isfinite(logits_k).all())
    err = float((logits_k - logits_p).abs().max())
    torch.testing.assert_close(logits_k, logits_p, atol=1e-4, rtol=1e-4)
    assert np.array_equal(tok_k, tok_p), (tok_k, tok_p)
    log(f"[lm] fp32 copy, prompt (2, 96), 8 steps: prefill logits within "
        f"{err:.3g} of the plain-attention path (tolerance 1e-4), greedy "
        f"tokens equal")
    return rows


def zoo_inputs(cfg, rng, batch: int, prompt: int, dev, dtype):
    """A seeded prompt and the prefill's other inputs on the card in
    ``dtype``: llava's patch embeddings, whisper's frames."""
    toks = rng.randint(0, cfg.vocab_size, (batch, prompt)).astype(np.int32)
    extra = {}
    if cfg.family == "vlm":
        extra["images"] = torch.from_numpy(rng.randn(
            batch, cfg.vlm.num_patches, cfg.d_model).astype(np.float32)
        ).to(dev, dtype)
    if cfg.family == "audio":
        extra["frames"] = torch.from_numpy(rng.randn(
            batch, cfg.encdec.encoder_seq, cfg.d_model).astype(np.float32)
        ).to(dev, dtype)
    return toks, extra


def zoo_launches(cfg, steps: int):
    """(flash-attention launches a prefill, flash-decode launches over
    ``steps`` decode steps)."""
    if cfg.family == "audio":         # encoder, decoder self and cross
        return (cfg.encdec.num_encoder_layers + 2 * cfg.num_layers,
                2 * cfg.num_layers * steps)
    if cfg.family == "hybrid":        # zamba2: the shared block per group
        groups = cfg.num_layers // cfg.ssm.attn_every
        return groups, groups * steps
    if cfg.family == "ssm":           # rwkv6: attention-free
        return 0, 0
    return cfg.num_layers, cfg.num_layers * steps


def zoo_model(arch, layers, dev, card, tag: str = "zoo",
              time_rows: bool = False):
    """One arch at its published widths through ``LMServingEngine``;
    returns its launches and, with ``time_rows``, the attention kernels'
    rows (``time_attention``, ``time_decode``) at its first prefill and
    last decode launch."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import registry
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.serving.engine import LMServingEngine

    cfg = configs.get_config(arch)
    cut = ""
    if layers is not None:
        cut = f"; cut: num_layers {cfg.num_layers} -> {layers}"
        cfg = cfg.replace(num_layers=layers)
    model = registry.build(cfg)
    t0 = time.perf_counter()
    params = model.init(0, device=dev)
    n_params = sum(t.numel() for t in tree_leaves(params))
    assert n_params == model.param_count(), (n_params, model.param_count())
    prompt_len, cache_len = ZOO_SHAPES[cfg.family]
    rng = np.random.RandomState(0)
    prompt, extra = zoo_inputs(cfg, rng, ZOO_BATCH, prompt_len, dev,
                               torch.bfloat16)
    engine = LMServingEngine(model, params, cache_len=cache_len, device=dev)
    engine.generate(prompt[:, :16], steps=2, extra=extra)   # warm-up
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    with LMProbe(model) as probe:
        t0 = time.perf_counter()
        tokens = engine.generate(prompt, steps=ZOO_STEPS, extra=extra)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    variants = dict(fa.VARIANT_LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    decode_s = total_s - probe.prefill_s
    attn_n, decode_n = zoo_launches(cfg, ZOO_STEPS)
    assert launches["flash_attention"] == attn_n, launches
    # every launch on the kernel its head dim takes (zamba2's 112: scalar)
    kind = fa.variant(torch.bfloat16, cfg.resolved_head_dim)
    assert variants == {k: attn_n if k == kind else 0 for k in variants}, \
        variants
    assert launches["flash_decode_partial"] == decode_n, launches
    assert sum(launches.values()) == attn_n + decode_n, launches
    assert tokens.shape == (ZOO_BATCH, ZOO_STEPS)
    assert tokens.min() >= 0 and tokens.max() < model.vp
    dropped = int(sum(probe.dropped)) if probe.dropped else None
    pairs, prefill_s = probe.pairs, probe.prefill_s

    held = []
    for (causal, square), args in sorted(probe.attn.items()):
        _, err, ms, lib = hold_attention(*args)
        q, k = args[0], args[1]
        b, by = bound(*work("flash_attention", q, k, causal=causal),
                      peak_ops(q.dtype))
        held.append(f"attention {tuple(q.shape)} over T={k.shape[2]} "
                    f"causal={causal}: err {err:.3g}, device {ms:.5f} ms "
                    f"(SDPA {lib:.5f}; bound {b:.5f}, {by})")
    for T in sorted(probe.decode_last):
        for which, args in (("first", probe.decode_first[T]),
                            ("last", probe.decode_last[T])):
            _, err, ms, lib = hold_decode(*args)
            q, kc = args[0], args[1]
            b, by = bound(*work("flash_decode_partial", q, kc,
                                live=live_rows(kc, args[3], args[4])),
                          peak_ops(q.dtype))
            held.append(f"decode {which} over T={T} pos={int(args[3])} "
                        f"{tuple(q.shape)}: err {err:.3g}, device "
                        f"{ms:.5f} ms (SDPA {lib:.5f}; bound {b:.5f}, "
                        f"{by})")
    rows = {}
    if time_rows and attn_n:
        rows = {"flash_attention": time_attention(
                    *probe.attn[(True, True)], launches["flash_attention"],
                    card),
                "flash_decode_partial": time_decode(
                    *probe.decode_last[cache_len],
                    launches["flash_decode_partial"], card)}
    del probe

    state_line = ""
    if cfg.moe is not None or cfg.ssm is not None:
        # a decode step of routing or recurrent state under sync debug
        # mode, twice from copies of one cache: no host sync and
        # bitwise-equal logits
        logits, cache = model.prefill(
            params, {"tokens": torch.from_numpy(prompt[:, :64]).to(dev)},
            cache_len=128)
        tok = logits[:, -1].argmax(dim=-1)[:, None].to(torch.int32)
        copies = [tree_map(torch.clone, cache) for _ in range(2)]
        del cache
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            outs = [model.decode_step(params, c, {"tokens": tok})[0]
                    for c in copies]
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert torch.equal(outs[0], outs[1])
        assert bool(torch.isfinite(outs[0]).all())
        del copies, outs, logits, tok
        state_line = ("; a decode step ran under sync debug mode 'error', "
                      "twice from one cache: logits bitwise equal")
    if cfg.moe is not None:
        state_line = (f"; MoE pairs dropped at prefill {dropped} of "
                      f"{pairs} (capacity factor "
                      f"{cfg.moe.capacity_factor}){state_line}")
    log(f"[{tag}] {arch} ({cfg.family}) at its published widths "
        f"(d {cfg.d_model}, {cfg.num_layers} layers, {cfg.num_heads} heads"
        f" padded to {cfg.padded_heads} over {cfg.num_kv_heads} kv heads, "
        f"head_dim {cfg.resolved_head_dim}, vocab {cfg.vocab_size}"
        f"{cut}), {n_params} parameters, bf16: batch {ZOO_BATCH}, prompt "
        f"{prompt_len}, cache {cache_len}, {ZOO_STEPS} steps; prefill "
        f"{prefill_s * 1e3:.3f} ms; decode "
        f"{decode_s / ZOO_STEPS * 1e3:.3f} ms per step; "
        f"{ZOO_BATCH * ZOO_STEPS / decode_s:.1f} generated tokens/s; peak "
        f"device memory {peak_gb:.3f} GB; launches {launches}, attention "
        f"by kernel {variants}{state_line}; set-up {setup_s:.1f} s; {card}")
    for line in held:
        log(f"[{tag}] {arch} {line}")
    lm_trace(model, params, prompt, prefill_s, decode_s / ZOO_STEPS, card,
             steps=2, cache_len=cache_len, extra=extra, what=arch,
             prefill_host=cfg.family != "ssm")
    del engine, params, model, prompt, extra
    gc.collect()
    torch.cuda.empty_cache()
    return ({k: launches[k] for k in ("flash_attention",
                                      "flash_decode_partial")}, rows)


def zoo_fp32_copy(arch, dev, card, layers: int = 2,
                  tag: str = "zoo") -> None:
    """A ``layers``-layer fp32 copy of ``arch`` at its published widths
    (2 + 2 layers for whisper; the scalar attention kernel): the same
    greedy tokens through the kernels as through their plain versions,
    prefill logits within 1e-4 (the repo's fp32 parity tolerance)."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import registry
    from repro_torch.serving.engine import LMServingEngine

    cfg = configs.get_config(arch).replace(num_layers=layers,
                                           dtype="float32",
                                           param_dtype="float32")
    if cfg.encdec is not None:
        cfg = cfg.replace(encdec=dataclasses.replace(
            cfg.encdec, num_encoder_layers=2))
    model = registry.build(cfg)
    params = model.init(0, device=dev)
    prompt, extra = zoo_inputs(cfg, np.random.RandomState(1), 2, 96, dev,
                               torch.float32)
    prefix = cfg.vlm.num_patches if cfg.vlm is not None else 0
    cache_len = prefix + 128
    batch = dict(extra, tokens=torch.from_numpy(prompt).to(dev))
    ops.reset_launches()
    logits_k, _ = model.prefill(params, batch, cache_len=cache_len)
    tok_k = LMServingEngine(model, params, cache_len=cache_len,
                            device=dev).generate(prompt, steps=8, extra=extra)
    attn_n, decode_n = zoo_launches(cfg, 8)
    assert ops.LAUNCHES["flash_attention"] == 2 * attn_n, ops.LAUNCHES
    assert fa.VARIANT_LAUNCHES == {"wgmma": 0, "scalar": 2 * attn_n}
    assert ops.LAUNCHES["flash_decode_partial"] == decode_n, ops.LAUNCHES
    with PlainAttention():
        logits_p, _ = model.prefill(params, batch, cache_len=cache_len)
        tok_p = LMServingEngine(model, params, cache_len=cache_len,
                                device=dev).generate(prompt, steps=8,
                                                     extra=extra)
    assert bool(torch.isfinite(logits_k).all())
    err = float((logits_k - logits_p).abs().max())
    torch.testing.assert_close(logits_k, logits_p, atol=1e-4, rtol=1e-4)
    assert np.array_equal(tok_k, tok_p), (tok_k, tok_p)
    log(f"[{tag}] {arch} fp32 copy, {cfg.num_layers} layers at full width, "
        f"prompt (2, 96) behind {prefix or 'no'} patches"
        f"{f', {cfg.encdec.encoder_seq} frames' if cfg.encdec else ''}, "
        f"8 steps: "
        f"prefill logits within {err:.3g} of the plain-attention path "
        f"(tolerance 1e-4), greedy tokens equal; {card}")
    del model, params, batch, extra, logits_k, logits_p
    gc.collect()
    torch.cuda.empty_cache()


def zoo_phase(dev, card, rows) -> None:
    """The zoo's seven archs at full width, then the fp32 copies; adds
    each arch's launches to the attention kernels' rows."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    log(f"[zoo] device memory in use at the start "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB")
    launches = {arch: zoo_model(arch, layers, dev, card)[0]
                for arch, layers in ZOO}
    for arch in ZOO_FP32:
        zoo_fp32_copy(arch, dev, card)
    for row in rows:
        if row["name"] in ("flash_attention", "flash_decode_partial"):
            row["zoo_launches"] = {arch: n[row["name"]]
                                   for arch, n in launches.items()}
    log(f"[zoo] phase took {time.perf_counter() - t0:.1f} s; {card}")


def recurrent_phase(dev, card, rows) -> None:
    """zamba2-7b and rwkv6-3b at full width, then zamba2's fp32 copy;
    adds their launches to the attention kernels' rows, and zamba2's
    head-dim-112 numbers beside them."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    log(f"[recurrent] device memory in use at the start "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB")
    launches, d112 = {}, {}
    for arch in RECURRENT:
        launches[arch], held = zoo_model(arch, None, dev, card,
                                         tag="recurrent", time_rows=True)
        d112.update(held)
    zoo_fp32_copy("zamba2-7b", dev, card, layers=RECURRENT_FP32_LAYERS,
                  tag="recurrent")
    keep = ("ms", "device_ms", "plain_ms", "library_ms", "library_device_ms",
            "bound_ms", "bound_by", "max_abs_err", "launches")
    for row in rows:
        name = row["name"]
        if name in ("flash_attention", "flash_decode_partial"):
            row["zoo_launches"].update(
                {arch: n[name] for arch, n in launches.items()})
            row["head_dim_112"] = {k: d112[name][k] for k in keep}
    log(f"[recurrent] phase took {time.perf_counter() - t0:.1f} s; {card}")


def flat_items(tree, path=""):
    """(path, leaf) over a nested dict, in insertion order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flat_items(v, f"{path}/{k}")
    else:
        yield path, tree


def train_smollm(dev, card) -> None:
    """smollm-135m at full width through ``launch.train.build`` and
    ``run_train_loop``: 40 steps, a checkpoint every 10, a fault at step
    25 that restores step 20; step times, peak memory, one traced step."""
    import tempfile

    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_cli
    from repro_torch.models.params import tree_leaves
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.train_loop import make_train_step, run_train_loop

    with tempfile.TemporaryDirectory() as tmp:
        args = train_cli.parser().parse_args(
            ["--arch", "smollm-135m", "--steps", str(TRAIN_STEPS),
             "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
             "--ckpt-every", str(TRAIN_CKPT_EVERY), "--log-every", "1",
             "--ckpt-dir", tmp])
        model, opt_cfg, loader, loop_cfg = train_cli.build(args)
        cfg = model.cfg
        fired = []

        def fault_hook(step):
            if step == TRAIN_FAULT_AT and not fired:
                fired.append(step)
                raise RuntimeError("injected node failure")

        lines = []

        def log_fn(msg):
            lines.append((time.perf_counter(), msg))

        params = model.init(0, device=dev)
        n_params = sum(t.numel() for t in tree_leaves(params))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        params, state, hist = run_train_loop(
            model, opt_cfg, loader, loop_cfg, params=params,
            fault_hook=fault_hook, log_fn=log_fn, device=dev)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        latest = ckpt.latest_step(tmp)

    msgs = [m for _, m in lines]
    assert fired == [TRAIN_FAULT_AT], fired
    at = msgs.index(next(m for m in msgs if m.startswith("[fault]")))
    assert msgs[at].startswith(f"[fault] step {TRAIN_FAULT_AT}:"), msgs[at]
    resumed = TRAIN_FAULT_AT // TRAIN_CKPT_EVERY * TRAIN_CKPT_EVERY
    assert msgs[at + 1].startswith(f"step {resumed:5d}"), msgs[at + 1]
    assert latest == TRAIN_STEPS, latest
    assert int(state["step"]) == TRAIN_STEPS
    losses = [v for _, v in hist]
    assert all(math.isfinite(v) for v in losses), losses
    assert losses[-1] < losses[0], losses
    assert sum(launches.values()) == 0, launches
    # a step's interval: one "step" line to the next, leaving out those
    # that hold a checkpoint save (after steps 9, 19, ...) or the fault
    steps = []
    for (ta, ma), (tb, mb) in zip(lines, lines[1:]):
        if not (ma.startswith("step") and mb.startswith("step")):
            continue
        a, b = int(ma.split()[1]), int(mb.split()[1])
        if b == a + 1 and b % TRAIN_CKPT_EVERY:
            steps.append(((tb - ta) * 1e3, b))
    first_ms = (lines[0][0] - t0) * 1e3
    ms = [t for t, _ in steps]
    step_ms = statistics.median(ms)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    log(f"[train] {cfg.name} at its published widths, nothing cut "
        f"({cfg.num_layers} layers, d {cfg.d_model}, {cfg.num_heads} heads "
        f"over {cfg.num_kv_heads}, vocab {cfg.vocab_size}, tied, "
        f"{cfg.dtype}, remat {cfg.remat}), {n_params} parameters: "
        f"launch.train.build -> run_train_loop, Adam lr {opt_cfg.lr}, "
        f"batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, {TRAIN_STEPS} steps, a "
        f"checkpoint every {TRAIN_CKPT_EVERY}, a fault at step "
        f"{TRAIN_FAULT_AT}: resumed from step {resumed}, latest checkpoint "
        f"{latest}; loss {losses[0]:.4f} -> {losses[-1]:.4f}; step "
        f"{step_ms:.3f} ms median over {len(ms)} steps (min {min(ms):.3f}, "
        f"max {max(ms):.3f}; the first, with its warm-up, {first_ms:.1f}); "
        f"{tokens / step_ms * 1e3:.0f} tokens/s; the loop "
        f"{total_s:.1f} s; peak device memory {peak_gb:.3f} GB; kernel "
        f"launches {launches}; {card}")
    log(f"[train] losses by logged step: "
        f"{[(s, round(v, 4)) for s, v in hist]}; {card}")

    # one more step, traced
    batch = {k: torch.from_numpy(np.asarray(v)).to(dev)
             for k, v in next(iter(loader)).items()}
    step = make_train_step(model, opt_cfg)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step(params, state, batch)
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    profile_summary(prof, traced_s, step_ms / 1e3, 1, card,
                    what="smollm-135m train step", unit="step")
    del params, state, prof, batch
    gc.collect()
    torch.cuda.empty_cache()


def train_card_vs_cpu(dev, card) -> None:
    """An fp32 copy of smollm-135m at full width, batch 2 x seq 256: the
    loss and every leaf's gradient on the card against the CPU, and one
    train step with 2 microbatches against one with 1."""
    from repro_torch.configs import smollm_135m
    from repro_torch.models import registry
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.train.optimizer import OptConfig, init_state
    from repro_torch.train.train_loop import make_train_step, value_and_grad

    cfg = smollm_135m.CONFIG.replace(dtype="float32", param_dtype="float32")
    model = registry.build(cfg)
    cpu_params = model.init(0, device="cpu")
    rng = np.random.RandomState(3)
    toks = rng.randint(0, cfg.vocab_size, (2, 257)).astype(np.int32)
    cpu_batch = {"tokens": torch.from_numpy(toks[:, :-1].copy()),
                 "labels": torch.from_numpy(toks[:, 1:].copy())}
    batch = {k: v.to(dev) for k, v in cpu_batch.items()}
    params = tree_map(lambda t: t.to(dev), cpu_params)
    t0 = time.perf_counter()
    cpu_loss, cpu_grads = value_and_grad(model, cpu_params, cpu_batch)
    cpu_s = time.perf_counter() - t0
    loss, grads = value_and_grad(model, params, batch)
    worst = 0.0
    for (path, g), (_, want) in zip(flat_items(grads),
                                    flat_items(cpu_grads)):
        g = g.cpu()
        assert bool(torch.isfinite(g).all()), path
        tol = 1e-6 + 1e-4 * float(want.abs().max())
        err = float((g - want).abs().max())
        torch.testing.assert_close(g, want, rtol=1e-4, atol=tol, msg=path)
        worst = max(worst, err / tol)
    rel = abs(float(loss) - float(cpu_loss)) / abs(float(cpu_loss))
    assert rel < 1e-5, (float(loss), float(cpu_loss))
    log(f"[train] {cfg.name} fp32 copy at full width, batch 2 x seq 256: "
        f"loss {float(loss):.6f} on the card, {float(cpu_loss):.6f} on the "
        f"CPU (relative {rel:.3g}, tolerance 1e-5); every leaf's gradient "
        f"within rtol 1e-4, atol 1e-6 + 1e-4 x its largest magnitude (worst "
        f"{worst:.3g} of that tolerance); the CPU's loss and gradients "
        f"took {cpu_s:.1f} s; {card}")
    del cpu_params, cpu_grads, grads

    # SGD at lr 1: the parameters move by exactly the clipped gradient,
    # where Adam's first step, lr * g / (|g| + eps), would magnify the
    # last bits of the gradients smaller than eps
    opt = OptConfig(kind="sgd", lr=1.0)
    outs = []
    for mb in (1, 2):
        p = tree_map(lambda t: t.detach().clone(), params)
        p, _, metrics = make_train_step(model, opt, microbatches=mb)(
            p, init_state(opt, p), batch)
        outs.append((p, metrics))
    (p1, m1), (p2, m2) = outs
    for key in ("loss", "grad_norm"):
        a, b = float(m1[key]), float(m2[key])
        assert abs(a - b) <= 1e-5 * abs(a), (key, a, b)
    err = max(float((a - b).detach().abs().max())
              for a, b in zip(tree_leaves(p1), tree_leaves(p2)))
    assert err <= 1e-6, err
    log(f"[train] make_train_step(microbatches=2) against microbatches=1 "
        f"on one batch: loss {float(m2['loss']):.6f} / "
        f"{float(m1['loss']):.6f}, grad norm {float(m2['grad_norm']):.6f} /"
        f" {float(m1['grad_norm']):.6f} (within 1e-5 relative), parameters "
        f"after an SGD step at lr 1 within {err:.3g} (tolerance 1e-6); "
        f"{card}")
    del params, outs, p1, p2
    gc.collect()
    torch.cuda.empty_cache()


def train_guard(dev) -> None:
    """F1: each CUDA wrapper refuses grad-requiring operands while grad
    mode is on, and launches under ``torch.no_grad``."""
    from repro_torch.kernels import ops

    q = torch.randn(1, 3, 128, 64, device=dev, dtype=torch.bfloat16,
                    requires_grad=True)
    qd = torch.randn(1, 3, 64, device=dev, dtype=torch.bfloat16,
                     requires_grad=True)
    kc = torch.randn(1, 128, 3, 64, device=dev, dtype=torch.bfloat16)
    pos = torch.tensor(100, dtype=torch.int32, device=dev)
    tables = torch.randn(4, 64, 128, device=dev, requires_grad=True)
    idx = torch.randint(0, 64, (8, 4, 5), dtype=torch.int32, device=dev)
    calls = {
        "flash_attention": lambda: ops.flash_attention(q, q, q),
        "flash_decode_partial": lambda: ops.flash_decode_partial(
            qd, kc, kc, pos),
        "embedding_bag_fused_flat": lambda: ops.embedding_bag_fused(
            tables, idx)}
    for name, call in calls.items():
        try:
            call()
        except RuntimeError as e:
            assert f"{name}: the CUDA kernel has no backward" in str(e), e
        else:
            raise AssertionError(f"{name} took a grad-requiring operand")
    ops.reset_launches()
    with torch.no_grad():
        for call in calls.values():
            call()
    torch.cuda.synchronize()
    assert all(ops.LAUNCHES[n] == 1 for n in calls), ops.LAUNCHES
    ops.reset_launches()
    log(f"[train] F1 guard: {', '.join(calls)} raise on grad-requiring "
        f"operands in grad mode and launch once each under torch.no_grad")


def train_rm1(dev, card) -> None:
    """RM1 V0 at its published widths, rows cut to TRAIN_RM1_ROWS, Adagrad,
    batch 64, 10 steps; then one step on a fixed batch lowers its loss and
    every gradient is finite."""
    from repro_torch.configs import rm1
    from repro_torch.data.queries import dlrm_batch
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_cli
    from repro_torch.models.params import tree_leaves
    from repro_torch.train.train_loop import (make_train_step,
                                              run_train_loop, value_and_grad)

    cfg = rm1.CONFIG.replace(
        name=f"rm1.v0-rows{TRAIN_RM1_ROWS // 1000}k",
        dlrm=dataclasses.replace(rm1.CONFIG.dlrm,
                                 rows_per_table=TRAIN_RM1_ROWS))
    args = train_cli.parser().parse_args(
        ["--arch", "rm1", "--opt", "adagrad", "--batch", "64", "--steps",
         "10", "--log-every", "1"])
    model, opt_cfg, loader, loop_cfg = train_cli.build(args, cfg=cfg)
    params = model.init(0, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    lines = []
    t0 = time.perf_counter()
    params, state, hist = run_train_loop(
        model, opt_cfg, loader, loop_cfg, params=params, device=dev,
        log_fn=lambda m: lines.append(time.perf_counter()))
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    ms = [(b - a) * 1e3 for a, b in zip(lines, lines[1:])]
    assert sum(ops.LAUNCHES.values()) == 0, ops.LAUNCHES
    assert all(math.isfinite(v) for _, v in hist), hist

    rng = np.random.RandomState(123)
    batch = {k: torch.from_numpy(np.asarray(v)).to(dev)
             for k, v in dlrm_batch(cfg, 64, rng).items()}
    loss, grads = value_and_grad(model, params, batch)
    assert all(bool(torch.isfinite(g).all()) for g in tree_leaves(grads))
    nonzero = sum(int((g != 0).any()) for g in tree_leaves(grads))
    del grads
    make_train_step(model, opt_cfg)(params, state, batch)
    with torch.no_grad():
        after = float(model.loss(params, batch))
    assert after < float(loss), (float(loss), after)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"[train] {cfg.name}: RM1 V0 at its published widths, cut: "
        f"rows_per_table {rm1.CONFIG.dlrm.rows_per_table} -> "
        f"{TRAIN_RM1_ROWS}; Adagrad lr {opt_cfg.lr}, batch 64, 10 steps: "
        f"loss {hist[0][1]:.4f} -> {hist[-1][1]:.4f}; step "
        f"{statistics.median(ms):.3f} ms median over {len(ms)} (min "
        f"{min(ms):.3f}, max {max(ms):.3f}); the loop {total_s:.1f} s; a "
        f"fixed batch's loss {float(loss):.5f} -> {after:.5f} after one "
        f"step, every gradient finite ({nonzero} leaves nonzero); peak "
        f"device memory {peak_gb:.3f} GB; kernel launches 0; {card}")
    del params, state, batch
    gc.collect()
    torch.cuda.empty_cache()


def train_family(arch, layers, dev, card) -> None:
    """One Adam step of ``arch`` at its published widths, depth cut to
    ``layers`` (whisper: as many encoder layers too), bf16, batch 2 at
    the zoo's prompt shape: the loss finite, every leaf outside the
    experts with a finite, nonzero gradient (the experts' together
    nonzero), and the same batch's loss lower after the step."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import registry
    from repro_torch.models.params import tree_leaves
    from repro_torch.train.optimizer import OptConfig, init_state
    from repro_torch.train.train_loop import make_train_step, value_and_grad

    full = configs.get_config(arch)
    cfg = full.replace(num_layers=layers)
    if cfg.encdec is not None:
        cfg = cfg.replace(encdec=dataclasses.replace(
            cfg.encdec, num_encoder_layers=layers))
    model = registry.build(cfg)
    params = model.init(0, device=dev)
    n_params = sum(t.numel() for t in tree_leaves(params))
    prompt, _ = ZOO_SHAPES[cfg.family]
    rng = np.random.RandomState(0)
    toks, extra = zoo_inputs(cfg, rng, 2, prompt + 1, dev, torch.bfloat16)
    batch = dict(extra, tokens=torch.from_numpy(toks[:, :-1].copy()).to(dev),
                 labels=torch.from_numpy(toks[:, 1:].copy()).to(dev))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 1e9
    ops.reset_launches()
    t0 = time.perf_counter()
    loss, grads = value_and_grad(model, params, batch)
    grad_gb = torch.cuda.max_memory_allocated() / 1e9 - held_gb
    assert math.isfinite(float(loss)), float(loss)
    experts = []
    for path, g in flat_items(grads):
        assert bool(torch.isfinite(g).all()), path
        if "/moe/" in path and "shared" not in path and "router" not in path:
            experts.append(bool((g != 0).any()))
        else:
            assert bool((g != 0).any()), f"{arch}{path}: zero gradient"
    assert not experts or any(experts)
    del grads
    opt = OptConfig()
    params, _, metrics = make_train_step(model, opt)(
        params, init_state(opt, params), batch)
    with torch.no_grad():
        after = float(model.loss(params, batch))
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    assert sum(ops.LAUNCHES.values()) == 0, ops.LAUNCHES
    assert after < float(loss), (arch, float(loss), after)
    enc = inputs = hit = ""
    if cfg.encdec is not None:
        enc = f" (encoder {full.encdec.num_encoder_layers} -> {layers})"
        inputs = f" and {cfg.encdec.encoder_seq} frames"
    if cfg.vlm is not None:
        inputs = f" behind {cfg.vlm.num_patches} patches"
    if experts:
        hit = f", {sum(experts)} of {len(experts)} expert leaves nonzero"
    log(f"[train] {arch} ({cfg.family}) at its published widths, cut: "
        f"num_layers {full.num_layers} -> {layers}{enc}, {n_params} "
        f"parameters, bf16, batch 2, {prompt} tokens{inputs}: loss "
        f"{float(loss):.4f} -> {after:.4f} on the same batch after one "
        f"Adam step (lr {opt.lr}), every gradient finite{hit}; "
        f"loss, gradients, step and loss again {step_s:.2f} s; the loss "
        f"and its gradients peak {grad_gb:.3f} GB above the {held_gb:.3f} "
        f"GB of weights and batch; peak device memory {peak_gb:.3f} GB; "
        f"kernel launches 0; {card}")
    del params, batch, model
    gc.collect()
    torch.cuda.empty_cache()


def train_phase(dev, card) -> None:
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    log(f"[train] device memory in use at the start "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB")
    train_smollm(dev, card)
    train_card_vs_cpu(dev, card)
    train_guard(dev)
    train_rm1(dev, card)
    for arch, layers in TRAIN_FAMILIES:
        train_family(arch, layers, dev, card)
    log(f"[train] phase took {time.perf_counter() - t0:.1f} s; {card}")


# ---------------------------------------------------------------- mesh
#: rank processes of the [mesh] phase, all on cuda:0, and gloo's timeout
#: (a rank that fails ends the others' collectives there)
MESH_WORLD, MESH_TIMEOUT_S = 4, 180
MESH_RM1_BATCH = 64
#: arch -> (batch, prompt, cache slots, decode steps) on the (1, 4) mesh
MESH_LM = {"smollm-135m": (LM_BATCH, LM_PROMPT, LM_CACHE, 16),
           "qwen2-moe-a2.7b": (ZOO_BATCH, 512, 1024, ZOO_STEPS)}
#: the copies at full width, depth cut: (arch, dtype) -> (layers, batch,
#: prompt, cache slots, decode steps)
MESH_COPIES = {("smollm-135m", "float32"): (2, 8, 128, 256, 8),
               ("qwen2-moe-a2.7b", "float32"): (2, 4, 128, 256, 8),
               ("qwen2-moe-a2.7b", "bfloat16"): (2, 4, 512, 1024, 8)}
#: the encoder-decoder and recurrent families at their published widths,
#: bf16, one spawn of the ranks each: arch -> (model axis size, batch,
#: prompt, cache slots, decode steps); whisper's prompt and slots are
#: [zoo]'s, behind its 1500 frames; 4 decode steps, cut from [zoo]'s 16
#: for the script's time (1.3 s a step on the mesh)
MESH_ZOO = {"whisper-large-v3": (4, ZOO_BATCH, 64, 256, 4),
            "zamba2-7b": (4, ZOO_BATCH, 512, 1024, 4),
            "rwkv6-3b": (2, ZOO_BATCH, 512, 1024, 4)}
#: whisper under the FSDP rules on (1, 4): heads whole, so the encoder,
#: the decoder's self- and its cross-attention run context parallelism
WHISPER_FSDP = {"heads": None, "kv_heads": None, "attn_din": ("data",),
                "seq_sp": ("model",)}
#: their fp32 copies at full width, depth cut as [zoo] and [recurrent]
#: cut it (whisper 2 + 2 layers), in the same spawn as their arch:
#: (arch, what) -> (layers, batch, prompt, cache slots, decode steps,
#: prefill rule overrides)
MESH_ZOO_COPIES = {
    ("whisper-large-v3", "head-TP"): (2, 2, 64, 128, 4, None),
    ("whisper-large-v3", "FSDP + CP"): (2, 2, 64, 128, 4, WHISPER_FSDP),
    ("zamba2-7b", "head-TP"): (RECURRENT_FP32_LAYERS, 2, 128, 256, 4, None),
    ("rwkv6-3b", "head-TP"): (2, 2, 128, 256, 4, None)}
#: the bf16 archs whose mesh logits drift past ten bf16 steps with depth
#: (rwkv6-3b on (2, 2) on an H100: 1.9-2.4 of them): each call is held
#: instead to a witness of the same precision, how far one device's own
#: bf16 run on the mesh's batch blocks (each block alone, teacher-forced
#: on its rows of the same tokens) lies from its run on the whole batch
#: (1.8 at the prefill there): other shapes, so other kernels and
#: summation orders, and nothing else.  The mesh reorders once more
#: where that witness does not (the channel mix's ``ffn`` contraction
#: split over ``model`` and psummed, the vocab-parallel head, and at
#: decode the square projections' contraction over ``model``): two such
#: perturbations, each as large as the witness, add to at most
#: ``MESH_WITNESS_FACTOR`` times it
MESH_BF16_WITNESS, MESH_WITNESS_FACTOR = ("rwkv6-3b",), 2.0
#: bf16 MoE on the mesh: the shares of one device's route ids at layer 0
#: and of its kept pairs at every layer that the mesh keeps at least; at
#: every layer it keeps at least the share that one device's own prefill
#: with the plain attention keeps, less ``MESH_WITNESS_MARGIN``
MESH_ROUTE_FLOOR, MESH_WITNESS_MARGIN = 0.999, 0.05


def bf16_tol(ref: torch.Tensor) -> float:
    """Ten bf16 steps at the logits' magnitude (the zoo's tolerance)."""
    return 10 * 2 ** -8 * float(ref.abs().max())


class MeshProbe:
    """In a rank (or the parent's one-device run): each flash-attention
    launch's local heads, each decode launch's ``kv_offset``, the inputs
    of the first attention launch and of the first and last decode
    launch (for ``hold_mesh``), the MoE dispatch's route ids and kept
    pairs at prefill, and the host time inside the mesh collectives
    (``sharding._reduce`` / ``_gather``, each timed from a synchronised
    device, so its share excludes the compute queued before it)."""

    def __init__(self, timed: bool = False):
        from repro_torch.distributed import sharding as shd
        from repro_torch.kernels import ops
        from repro_torch.models import moe
        self.shd, self.ops, self.moe, self.timed = shd, ops, moe, timed
        self.orig = (ops.flash_attention, ops.flash_decode_partial,
                     moe.dispatch, shd._reduce, shd._gather)
        self.heads, self.offsets, self.routes = [], set(), []
        self.attn = self.decode_first = self.decode_last = None
        self.in_prefill, self.coll_s = False, 0.0

    def __enter__(self):
        probe = self
        attn, decode, dispatch, reduce_, gather = self.orig

        def flash_attention(q, k, v, **kw):
            probe.heads.append(q.shape[1])
            if probe.attn is None:
                probe.attn = (q, k, v, kw)
            return attn(q, k, v, **kw)

        def flash_decode_partial(q, kc, vc, pos, **kw):
            probe.offsets.add(kw.get("kv_offset", 0))
            # the caches by reference: later steps write rows past pos,
            # which the launch does not read
            args = (q.clone(), kc, vc, pos.clone(), kw)
            if probe.decode_first is None:
                probe.decode_first = args
            probe.decode_last = args
            return decode(q, kc, vc, pos, **kw)

        def recorded_dispatch(ids, Ep, capacity):
            slot, keep = dispatch(ids, Ep, capacity)
            if probe.in_prefill:
                probe.routes.append((ids, keep, capacity))
            return slot, keep

        def timed(fn):
            def run(*a, **kw):
                if not probe.timed:
                    return fn(*a, **kw)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                probe.coll_s += time.perf_counter() - t0
                return out
            return run

        self.ops.flash_attention = flash_attention
        self.ops.flash_decode_partial = flash_decode_partial
        self.moe.dispatch = recorded_dispatch
        self.shd._reduce, self.shd._gather = timed(reduce_), timed(gather)
        return self

    def __exit__(self, *exc):
        (self.ops.flash_attention, self.ops.flash_decode_partial,
         self.moe.dispatch, self.shd._reduce, self.shd._gather) = self.orig
        return False

    def route_arrays(self):
        return [(ids.cpu().numpy(), keep.cpu().numpy(), cap)
                for ids, keep, cap in self.routes]


def hold_mesh(probe) -> list:
    """The first attention launch and the first and last decode launch a
    rank made on the mesh path, each held against the kernel's plain
    version on the same card tensors (``cases.ATTN_TOL`` /
    ``DECODE_TOL``; a disagreement fails the rank) -> [(launch, shape,
    kv_offset, pos, max abs error)].  Its launches come after the
    path's counts were read."""
    held = []
    if probe.attn is not None:
        q, k, v, kw = probe.attn
        held.append(("attention", tuple(q.shape), None, None,
                     compare_attention(q, k, v, kw)[1]))
    for which, args in (("decode first", probe.decode_first),
                        ("decode last", probe.decode_last)):
        if args is None:                 # rwkv6: attention-free
            continue
        q, kc, vc, pos, kw = args
        held.append((which, tuple(kc.shape), kw.get("kv_offset", 0),
                     int(pos), compare_decode(*args)[1]))
    return held


def mesh_rank(rank: int, store: str, jobs, q) -> None:
    """One rank of the [mesh] phase: joins the gloo group on cuda:0, runs
    each (job, payload) of ``jobs`` in turn and puts (rank, results) on
    ``q``.  A failure is not caught: the rank exits non-zero, and the
    others fail at gloo's timeout."""
    import datetime
    import faulthandler

    import torch.distributed as dist
    faulthandler.enable()          # a crash in native code prints where
    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method="file://" + store, rank=rank,
        world_size=MESH_WORLD,
        timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    try:
        results = []
        for job, payload in jobs:
            torch.cuda.reset_peak_memory_stats()
            res = MESH_JOBS[job](rank, payload)
            torch.cuda.synchronize()
            res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            results.append(res)
            # release the parent's tensors (CUDA IPC counts this rank's
            # references, and a process that just exits may not drop them)
            payload.clear()
            gc.collect()
            torch.cuda.empty_cache()
        q.put((rank, results))
    finally:
        dist.destroy_process_group()


def drawn_compact(draw, dev):
    """The tree ``draw()`` makes on the card, moved to the host and back:
    drawing the weights (fp32 draws cast to bf16) leaves free blocks
    inside segments that live weights pin, which ``empty_cache`` cannot
    return (16.5 GB for qwen2-moe-a2.7b); fresh copies, made once the
    draw is freed, sit in segments of their own."""
    from repro_torch.models.params import tree_map
    host = tree_map(lambda t: t.cpu(), draw())     # the draw is freed here
    free_card()
    return tree_map(lambda t: t.to(dev), host)


def free_card() -> None:
    """Free what the parent no longer references, the tensors it shared
    with the ranks (CUDA IPC) included."""
    gc.collect()
    torch.cuda.ipc_collect()
    torch.cuda.empty_cache()


def run_ranks(jobs, deadline_s: float = 2 * MESH_TIMEOUT_S):
    """Spawns the ranks with ``jobs``, a list of (job, payload) (CUDA
    tensors in a payload pass through CUDA IPC: each rank clones only
    its own blocks), collects every rank's results and waits for its
    exit; a rank that dies, or exits non-zero, or a spawn still running
    after ``deadline_s``, fails the phase.  Returns (per job, the results
    by rank; wall s)."""
    import queue
    import tempfile

    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        procs = [ctx.Process(target=mesh_rank, args=(
            r, str(Path(d) / "store"), jobs, q)) for r in range(MESH_WORLD)]
        for p in procs:
            p.start()
        try:
            results = {}
            deadline = time.monotonic() + deadline_s
            while len(results) < MESH_WORLD:
                try:
                    rank, res = q.get(timeout=5)
                    results[rank] = res
                except queue.Empty:        # a poll: no result yet
                    codes = [p.exitcode for p in procs]
                    if (any(c not in (None, 0) for c in codes)
                            or time.monotonic() > deadline):
                        raise RuntimeError(
                            f"[mesh] {[j for j, _ in jobs]}: rank exit "
                            f"codes {codes}")
            for p in procs:
                p.join(timeout=60)
            codes = [p.exitcode for p in procs]
            assert codes == [0] * MESH_WORLD, codes
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
                p.close()        # drops the process's hold on the payloads
    per_job = [[results[r][i] for r in range(MESH_WORLD)]
               for i in range(len(jobs))]
    return per_job, time.perf_counter() - t0


def card_used_gb() -> float:
    """Device memory in use on the card by every process (GB)."""
    free, total = torch.cuda.mem_get_info()
    return (total - free) / 1e9


def mesh_rm1_rank(rank: int, p) -> dict:
    """RM1 V0 on the (data 2, model 2) mesh through
    ``DLRMServingEngine(mesh, rules, use_kernel=True)``, params placed by
    ``reshard_tree``; then ``healthy_mesh({"model": 2}, 0.4)`` and the
    same requests on the survivors."""
    import torch.distributed as dist

    from repro_torch.distributed import elastic
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import registry
    from repro_torch.serving.engine import DLRMServingEngine

    cfg, params, reqs, dev = p["cfg"], p["params"], p["reqs"], p["dev"]
    model = registry.build(cfg)
    mesh = make_host_mesh(2, device=dev)
    rules = registry.make_rules(cfg, mesh, "prefill")
    placed = elastic.reshard_tree(params, model.param_specs(), mesh, rules)
    dist.barrier()
    out = {"coord": mesh.get_coordinate(), "card_gb": card_used_gb(),
           "block": tuple(placed["embed"].to_local().shape)}
    eng = DLRMServingEngine(model, placed, batch_size=p["batch"],
                            use_kernel=True, device=dev, mesh=mesh,
                            rules=rules)
    eng.serve(reqs[:2])                                   # warm-up
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    res = eng.serve(reqs)
    torch.cuda.synchronize()
    out["serve_s"] = time.perf_counter() - t0
    out["launches"] = dict(ops.LAUNCHES)
    out["scores"] = {r.rid: r.outputs for r in res}
    del eng, placed, res
    gc.collect()
    torch.cuda.empty_cache()
    small = elastic.healthy_mesh({"model": 2}, failed_fraction=0.4,
                                 device=dev)
    out["healthy"] = small.mesh.tolist()
    survivor = elastic.reshard_tree(params, model.param_specs(), small, rules)
    if survivor is not None:
        ops.reset_launches()
        res = DLRMServingEngine(model, survivor, batch_size=p["batch"],
                                use_kernel=True, device=dev, mesh=small,
                                rules=rules).serve(reqs)
        out["healthy_launches"] = dict(ops.LAUNCHES)
        out["healthy_block"] = tuple(survivor["embed"].to_local().shape)
        out["healthy_scores"] = {r.rid: r.outputs for r in res}
    return out


def mesh_lm_rank(rank: int, p) -> dict:
    """An LM on the (1, 4) mesh (``(4 // p["model"], p["model"])`` when
    given) through ``build_program``'s prefill and decode fns, params
    placed by ``reshard_tree`` under each mode's rules (the prefill's
    with ``p["overrides"]``); the prompt with ``p["extra"]`` (whisper's
    frames); decode teacher-forced on ``p["forced"]`` when given (else
    greedy).  Rank 0 returns the logits and tokens."""
    import torch.distributed as dist

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import elastic
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_program
    from repro_torch.models import registry

    cfg, prompt, T, steps = p["cfg"], p["prompt"], p["cache"], p["steps"]
    forced, dev = p.get("forced"), p["dev"]
    extra = p.get("extra") or {}
    model = registry.build(cfg)
    mesh = make_host_mesh(p.get("model", MESH_WORLD), device=dev)
    dist.barrier()
    card = [card_used_gb()]
    B, S = prompt.shape
    pf, _, prules = build_program(cfg, ShapeConfig("p", S, B, "prefill"),
                                  mesh, cache_len=T,
                                  rule_overrides=p.get("overrides"))
    df, _, drules = build_program(cfg, ShapeConfig("d", T, B, "decode"), mesh)
    placed = elastic.reshard_tree(p["params"], model.param_specs(), mesh,
                                  prules)
    dist.barrier()
    card.append(card_used_gb())
    dparams = elastic.reshard_tree(placed, model.param_specs(), mesh, drules)
    dist.barrier()
    card.append(card_used_gb())
    toks = torch.from_numpy(prompt).to(dev)
    # warm-up: 64 tokens (and 64 of whisper's frames)
    pf(placed, dict({k: v[:, :64] for k, v in extra.items()},
                    tokens=toks[:, :64]))
    torch.cuda.synchronize()
    out = {"coord": mesh.get_coordinate(), "card_gb": card_used_gb(),
           "card_steps": card,
           "weights_gb": torch.cuda.memory_allocated() / 1e9}
    logits_out, own = [], []
    batch = dict(extra, tokens=toks)
    out["placed_bytes"] = {"prefill": placed_bytes(
        model, placed, batch, ShapeConfig("p", S, B, "prefill"), mesh,
        prules)}
    with MeshProbe() as probe:
        ops.reset_launches()
        t0 = time.perf_counter()
        probe.in_prefill = True
        logits, cache = pf(placed, batch)
        probe.in_prefill = False
        torch.cuda.synchronize()
        out["prefill_s"] = time.perf_counter() - t0
        out["placed_bytes"]["decode"] = placed_bytes(
            model, {"params": dparams, "cache": cache},
            {"tokens": toks[:, :1]}, ShapeConfig("d", T, B, "decode"), mesh,
            drules)
        out["prefill_launches"] = dict(ops.LAUNCHES)
        out["variants"] = dict(fa.VARIANT_LAUNCHES)
        out["heads"] = list(probe.heads)
        full = shd.full(logits)
        logits_out.append(full.float().cpu().numpy())
        own.append(full[:, -1].argmax(-1).to(torch.int32))
        per_step, decode_s = [], 0.0
        for i in range(steps):
            tok = (torch.from_numpy(forced[:, i]).to(dev)
                   if forced is not None else own[-1])
            ops.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = df(dparams, cache, {"tokens": tok[:, None]})
            full = shd.full(logits)
            torch.cuda.synchronize()
            decode_s += time.perf_counter() - t0
            per_step.append(ops.LAUNCHES["flash_decode_partial"])
            logits_out.append(full.float().cpu().numpy())
            own.append(full[:, -1].argmax(-1).to(torch.int32))
        out["decode_s"], out["decode_launches"] = decode_s, per_step
        out["offsets"] = sorted(probe.offsets)
        out["routes"] = probe.route_arrays() if rank == 0 else None
    # one more step with each collective timed from a synchronised card
    with MeshProbe(timed=True) as timer:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        df(dparams, cache, {"tokens": own[-1][:, None]})
        torch.cuda.synchronize()
        out["coll_share"] = timer.coll_s / (time.perf_counter() - t0)
    out["held"] = hold_mesh(probe)
    if rank == 0:
        out["logits"] = logits_out
        out["tokens"] = torch.stack(own, 1).cpu().numpy()
    return out


MESH_JOBS = {"rm1": mesh_rm1_rank, "lm": mesh_lm_rank}


def placed_bytes(model, tree, batch, shape, mesh, rules) -> int:
    """A rank's local bytes of a program's arguments: the blocks it holds
    of ``tree`` (placed DTensors) and of each ``batch`` input under the
    model's ``input_logical`` (the block the program takes)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed import sharding as shd
    from repro_torch.models.params import tree_leaves

    def nbytes(t):
        t = t.to_local() if isinstance(t, DTensor) else t
        return t.numel() * t.element_size()

    logical = model.input_logical(shape)
    with shd.use_mesh(mesh, rules):
        return (sum(nbytes(t) for t in tree_leaves(tree) if t is not None)
                + sum(nbytes(shd.local(v, *(logical.get(k)
                                            or (None,) * v.dim())))
                      for k, v in batch.items()))


def one_device_lm(model, params, prompt, T: int, steps: int, dev,
                  extra=None):
    """The same model on one device, greedy: (logits per call as fp32
    numpy, tokens (B, steps + 1), the prefill's routes)."""
    with torch.no_grad(), MeshProbe() as probe:
        probe.in_prefill = True
        logits, cache = model.prefill(
            params, dict(extra or {}, tokens=torch.from_numpy(prompt).to(dev)),
            cache_len=T)
        probe.in_prefill = False
        out, toks = [logits.float().cpu().numpy()], [logits[:, -1].argmax(-1)]
        for _ in range(steps):
            logits, cache = model.decode_step(
                params, cache, {"tokens": toks[-1][:, None].to(torch.int32)})
            out.append(logits.float().cpu().numpy())
            toks.append(logits[:, -1].argmax(-1))
        routes = probe.route_arrays()
    return out, torch.stack(toks, 1).to(torch.int32).cpu().numpy(), routes


def one_device_model(cfg, tokens: int):
    """The model one device is held at, and the published MoE capacity
    at a prefill of ``tokens`` (None without MoE).  EP rounds its
    per-shard capacity up to a multiple of 8, as the reference's EP
    branch does, so one device is held at the capacity the mesh keeps:
    a capacity factor that gives exactly it."""
    from repro_torch.models import registry

    if cfg.moe is None:
        return registry.build(cfg), None
    m = cfg.moe
    base = tokens * m.top_k / m.num_experts
    cap = max(8, int(base * m.capacity_factor))
    cap_ep = -(-cap // 8) * 8
    return registry.build(cfg.replace(moe=dataclasses.replace(
        m, capacity_factor=(cap_ep + 0.5) / base))), cap


def mesh_lm_line(tag, res, B, steps, card) -> None:
    for r, x in enumerate(res):
        log(f"[mesh] {tag} rank {r} {tuple(x['coord'])}: prefill "
            f"{x['prefill_s'] * 1e3:.3f} ms, decode "
            f"{x['decode_s'] / steps * 1e3:.3f} ms a step, "
            f"{B * steps / x['decode_s']:.1f} tokens/s, collectives "
            f"{x['coll_share']:.3f} of a step's wall (gloo: staged through "
            f"host memory, not NVLink), peak {x['peak_gb']:.3f} GB; prefill "
            f"launches {x['prefill_launches']} (kernels {x['variants']}, "
            f"local heads {sorted(set(x['heads']))}); decode launches a "
            f"step {sorted(set(x['decode_launches']))}, kv_offset "
            f"{x['offsets']}; held against the plain version on this "
            f"rank's tensors: " + "; ".join(
                f"{what} {shape}"
                + ("" if off is None else f" at kv_offset {off}, pos {pos}")
                + f" err {err:.3g}" for what, shape, off, pos, err
                in x["held"]) + f"; {card}")


def lm_case(arch, dev, dtype=None) -> dict:
    """An LM arch at its published widths (a copy's depth cut and dtype
    from ``MESH_COPIES`` when ``dtype`` is given), its weights drawn once
    on the card, and the same model served on one device before the
    ranks start: greedy tokens, logits per call, the prefill's MoE
    routes; in bf16 with MoE also the routes of one device's prefill
    with its attention through the plain versions (``witness``)."""
    from repro_torch import configs
    from repro_torch.models import registry

    cfg = configs.get_config(arch)
    tag = arch
    if dtype is not None:
        layers, B, S, T, steps = MESH_COPIES[arch, dtype]
        cfg = cfg.replace(num_layers=layers, dtype=dtype, param_dtype=dtype)
        tag = f"{arch} {dtype} copy ({layers} layers)"
    else:
        B, S, T, steps = MESH_LM[arch]
    fp32 = cfg.dtype == "float32"
    params = drawn_compact(lambda: registry.build(cfg).init(0, device=dev),
                           dev)
    prompt = np.random.RandomState(3).randint(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    ref_model, cap = one_device_model(cfg, B * S)
    want, tokens, routes = one_device_lm(ref_model, params, prompt, T, steps,
                                         dev)
    witness = None
    if cfg.moe is not None and not fp32:
        with PlainAttention():
            witness = one_device_lm(ref_model, params, prompt, T, 0, dev)[2]
    free_card()
    log(f"[mesh] {tag}: batch {B}, prompt {S}, {T} slots, {steps} steps; "
        f"the parent holds {torch.cuda.memory_allocated() / 1e9:.2f} GB "
        f"before the ranks")
    return {"tag": tag, "cfg": cfg, "fp32": fp32, "copy": dtype is not None,
            "want": want, "model": MESH_WORLD, "overrides": None,
            "tokens": tokens, "routes": routes, "witness": witness,
            "cap": cap, "B": B, "steps": steps, "T": T,
            "payload": {"cfg": cfg, "params": params, "prompt": prompt,
                        "cache": T, "steps": steps, "dev": dev,
                        # bf16 decodes teacher-forced on one device's tokens
                        "forced": None if fp32 else tokens}}


def forced_lm(model, params, prompt, tokens, T: int, dev, extra):
    """One device's logits per call (fp32 numpy), its decode teacher-
    forced on ``tokens`` (B, steps + 1) as the bf16 ranks' is."""
    out = []
    with torch.no_grad():
        logits, cache = model.prefill(
            params, dict(extra, tokens=torch.from_numpy(prompt).to(dev)),
            cache_len=T)
        out.append(logits.float().cpu().numpy())
        for i in range(tokens.shape[1] - 1):
            tok = torch.from_numpy(tokens[:, i]).to(dev)[:, None]
            logits, cache = model.decode_step(params, cache, {"tokens": tok})
            out.append(logits.float().cpu().numpy())
    return out


def bf16_witness(model, params, prompt, tokens, T: int, dev, extra, got,
                 blocks: int) -> list:
    """How far one device's bf16 logits ``got`` (its greedy run on the
    whole batch, which fed it ``tokens``) lie from its own run on the
    batch cut in ``blocks`` blocks (the mesh's batch blocks), each block
    alone and teacher-forced on its rows of ``tokens``, per call, in ten
    bf16 steps at the whole run's logits' magnitude."""
    b = prompt.shape[0] // blocks
    rows = [slice(i * b, (i + 1) * b) for i in range(blocks)]
    parts = [forced_lm(model, params, prompt[r], tokens[r], T, dev,
                       {k: v[r] for k, v in extra.items()}) for r in rows]
    free_card()
    return [float(np.abs(np.concatenate(cs, 0) - g).max())
            / bf16_tol(torch.from_numpy(g)) for g, cs in zip(got, zip(*parts))]


def zoo_mesh_case(arch, dev, what=None) -> dict:
    """whisper, zamba2 or rwkv6 for [mesh]: at its published widths in
    bf16 (``MESH_ZOO``), or with ``what`` its fp32 copy
    (``MESH_ZOO_COPIES``); its weights drawn once on the card, seeded
    inputs (whisper's frames in the model's dtype, as [zoo] sends
    them), and one device's greedy run before the ranks start."""
    from repro_torch import configs
    from repro_torch.models import registry

    cfg = configs.get_config(arch)
    m, B, S, T, steps = MESH_ZOO[arch]
    overrides, tag = None, f"{arch} on ({MESH_WORLD // m}, {m})"
    if what is not None:
        layers, B, S, T, steps, overrides = MESH_ZOO_COPIES[arch, what]
        cfg = cfg.replace(num_layers=layers, dtype="float32",
                          param_dtype="float32")
        if cfg.encdec is not None:
            cfg = cfg.replace(encdec=dataclasses.replace(
                cfg.encdec, num_encoder_layers=layers))
        tag = f"{arch} float32 copy ({layers} layers, {what})"
    fp32 = cfg.dtype == "float32"
    model = registry.build(cfg)
    params = model.init(0, device=dev)
    prompt, extra = zoo_inputs(cfg, np.random.RandomState(3), B, S, dev,
                               torch.float32 if fp32 else torch.bfloat16)
    want, tokens, _ = one_device_lm(model, params, prompt, T, steps, dev,
                                    extra)
    witness = None
    if not fp32 and arch in MESH_BF16_WITNESS:
        witness = bf16_witness(model, params, prompt, tokens, T, dev, extra,
                               want, MESH_WORLD // m)
    free_card()
    log(f"[mesh] {tag}: batch {B}, prompt {S}, {T} slots, {steps} steps"
        + (f", prefill rules with {overrides}" if overrides else "")
        + f"; the parent holds {torch.cuda.memory_allocated() / 1e9:.2f} GB"
        f" before the ranks")
    return {"tag": tag, "cfg": cfg, "fp32": fp32, "copy": what is not None,
            "want": want, "tokens": tokens, "routes": None, "witness": None,
            "bf16_witness": witness,
            "cap": None, "B": B, "steps": steps, "T": T, "model": m,
            "overrides": overrides,
            "payload": {"cfg": cfg, "params": params, "prompt": prompt,
                        "extra": extra, "cache": T, "steps": steps,
                        "dev": dev, "model": m, "overrides": overrides,
                        # bf16 decodes teacher-forced on one device's tokens
                        "forced": None if fp32 else tokens}}


def lm_check(case, res, card, rows_launches) -> None:
    """Every rank's launches; then the results against one device's:
    fp32, greedy tokens equal, logits within 1e-4 and MoE routes equal;
    bf16, logits within ten bf16 steps (dense models and the 2-layer
    copies; MoE routes: ``check_routes``)."""
    cfg, tag, steps, T = case["cfg"], case["tag"], case["steps"], case["T"]
    mesh_lm_line(tag, res, case["B"], steps, card)
    log(f"[mesh] {tag}: the card holds {max(x['card_gb'] for x in res):.2f} "
        f"of {torch.cuda.mem_get_info()[1] / 1e9:.2f} GB while the ranks "
        f"run (the parent's one copy of the weights, their blocks and "
        f"{MESH_WORLD + 1} CUDA contexts): at the ranks' start, after "
        f"placing, after the decode placement "
        f"{[round(g, 2) for g in res[0]['card_steps']]}; a rank's blocks "
        f"{res[0]['weights_gb']:.2f} GB")
    from repro_torch.kernels import flash_attention as fa

    hp, m = cfg.padded_heads, case["model"]
    # a prefill's attention launches and a decode step's (zoo_launches)
    attn_n, dec_n = zoo_launches(cfg, 1)
    head_tp = hp % m == 0 and "heads" not in (case["overrides"] or {})
    kind = fa.variant(torch.bfloat16, cfg.resolved_head_dim)
    for r, x in enumerate(res):
        assert x["decode_launches"] == [dec_n] * steps, (r, x)
        # each rank's slice of the self cache starts at its kv_offset;
        # whisper's cross cache is whole on every rank (kv_offset 0)
        offsets = {x["coord"][1] * T // m} if dec_n else set()
        if cfg.family == "audio":
            offsets.add(0)
        assert x["offsets"] == sorted(offsets), x
        attn = x["prefill_launches"]["flash_attention"]
        assert [h[0] for h in x["held"]] == (
            ["attention"] if attn else []) + (
            ["decode first", "decode last"] if dec_n else [])
        if head_tp and attn_n:           # the kernel on local heads
            assert attn == attn_n, x
            assert set(x["heads"]) == {hp // m}, x
            if not case["fp32"]:
                assert x["variants"] == {k: attn_n if k == kind else 0
                                         for k in x["variants"]}, x
        else:        # context parallel (blocked, no kernel) or attention-free
            assert attn == 0, x
    if dec_n:
        assert (sum(max(x["offsets"]) > 0 for x in res)
                == sum(x["coord"][1] > 0 for x in res))
    got, want = res[0]["logits"], case["want"]
    assert all(np.isfinite(g).all() for g in got)
    agree = float((res[0]["tokens"] == case["tokens"]).mean())
    if case["fp32"]:
        err = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
        log(f"[mesh] {tag}: greedy tokens agree with one device's on "
            f"{agree:.3f}, logits within {err:.3g} (tolerance 1e-4 and "
            f"1e-4 of each logit)")
        if cfg.moe is not None:
            check_routes(tag, cfg, res[0]["routes"], case, exact=True)
        np.testing.assert_array_equal(res[0]["tokens"], case["tokens"])
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
    else:
        ratios = [float(np.abs(g - w).max()) / bf16_tol(torch.from_numpy(w))
                  for g, w in zip(got, want)]
        log(f"[mesh] {tag}: bf16 logits against one device's, the largest "
            f"difference over ten bf16 steps at the logits' magnitude: "
            f"prefill {ratios[0]:.3f}, teacher-forced steps "
            f"{[round(x, 3) for x in ratios[1:]]}; greedy tokens agree on "
            f"{agree:.3f}")
        if cfg.moe is not None:
            check_routes(tag, cfg, res[0]["routes"], case, exact=False)
        # bf16 routing flips at near-ties under any other summation order,
        # a flipped pair changes the token's output, and the flips compound
        # with depth as one device's own do (check_routes holds the mesh
        # to that): a full-depth MoE's logits are reported, its 2-layer
        # copy's held
        wit = case.get("bf16_witness")
        if wit is not None:
            log(f"[mesh] {tag}: the witness, one device's bf16 logits on "
                f"the mesh's batch blocks against its whole batch's in the "
                f"same units: prefill {wit[0]:.3f}, teacher-forced steps "
                f"{[round(x, 3) for x in wit[1:]]}; each call held within "
                f"{MESH_WITNESS_FACTOR} times its witness (and at least 1)")
            assert all(r <= max(1.0, MESH_WITNESS_FACTOR * w)
                       for r, w in zip(ratios, wit)), (tag, ratios, wit)
        elif cfg.moe is None or case["copy"]:
            assert max(ratios) <= 1.0, (tag, ratios)
    rows_launches[tag] = [{"flash_attention": x["prefill_launches"][
        "flash_attention"], "flash_decode_partial": sum(x["decode_launches"])}
        for x in res]


def check_routes(arch, cfg, mroutes, case, exact: bool) -> None:
    """The MoE dispatch on the mesh against one device's at the mesh's
    capacity: the share of equal route ids and kept pairs a layer.  With
    ``exact`` every one equal; else (bf16) the floors of
    ``MESH_ROUTE_FLOOR`` and, at every layer, the share that one device
    keeps of its own route ids when its prefill takes the plain
    attention (``case["witness"]``) less ``MESH_WITNESS_MARGIN``."""
    from repro_torch.models import moe

    routes, cap = case["routes"], case["cap"]
    assert len(mroutes) == len(routes) == cfg.num_layers

    def same(a, b, i):
        return [float((x[i] == y[i]).mean()) for x, y in zip(a, b)]

    def fmt(xs):
        return [round(x, 4) for x in xs]

    ids_eq, kept_eq = same(mroutes, routes, 0), same(mroutes, routes, 1)
    # the pairs that the published capacity would keep otherwise
    published = sum(int((mk != moe.dispatch(
        torch.from_numpy(mi), cfg.moe.padded_experts, cap)[1].numpy()).sum())
        for mi, mk, _ in mroutes)
    witness, line = None, ""
    if case["witness"] is not None:
        witness = same(case["witness"], routes, 0)
        line = (f"; one device with the plain attention instead of the "
                f"kernel keeps its route ids on {fmt(witness)}")
    log(f"[mesh] {arch}: route ids equal to one device's on {fmt(ids_eq)} "
        f"of the (token, k) pairs a layer, kept pairs on {fmt(kept_eq)}, "
        f"at the mesh's capacity {mroutes[0][2]} (one device held there; "
        f"the published factor gives {cap}: on the mesh's routes "
        f"{published} of {mroutes[0][0].size * cfg.num_layers} pairs would "
        f"be kept otherwise){line}")
    for (mi, mk, mcap), (si, sk, scap) in zip(mroutes, routes):
        assert mcap == scap, (mcap, scap)
        if exact:
            np.testing.assert_array_equal(mi, si)
            np.testing.assert_array_equal(mk, sk)
    if not exact:
        assert ids_eq[0] >= MESH_ROUTE_FLOOR, (arch, ids_eq)
        assert min(kept_eq) >= MESH_ROUTE_FLOOR, (arch, kept_eq)
        assert all(m >= w - MESH_WITNESS_MARGIN
                   for m, w in zip(ids_eq, witness)), (arch, ids_eq, witness)


def rm1_check(res, reqs, scores, card) -> list:
    """RM1's mesh scores on every rank within ``SCORE_ATOL`` of
    ``[serve]``'s, the survivors' within it of the first mesh's; returns
    each rank's fused-bag launches."""
    for r, x in enumerate(res):
        log(f"[mesh] rm1 rank {r} {tuple(x['coord'])}: block {x['block']}, "
            f"serve {x['serve_s'] * 1e3:.1f} ms for {len(reqs)} requests, "
            f"bag launches {x['launches']}; card in use {x['card_gb']:.2f} "
            f"GB; healthy mesh {x['healthy']}"
            + (f": block {x['healthy_block']}, launches "
               f"{x['healthy_launches']}" if "healthy_scores" in x else
               ": not a survivor")
            + f"; peak {x['peak_gb']:.3f} GB; {card}")
    worst = worst_h = 0.0
    survivors = [x for x in res if "healthy_scores" in x]
    assert len(survivors) == 2
    for x in res:
        assert x["launches"]["embedding_bag_fused_flat"] > 0, x["launches"]
        for rid, s in x["scores"].items():
            worst = max(worst, float(np.abs(s - scores[rid]).max()))
            np.testing.assert_allclose(s, scores[rid], rtol=0, atol=SCORE_ATOL)
    for x in survivors:
        assert x["healthy_launches"]["embedding_bag_fused_flat"] > 0
        for rid, s in x["healthy_scores"].items():
            worst_h = max(worst_h, float(np.abs(
                s - res[0]["scores"][rid]).max()))
            np.testing.assert_allclose(s, res[0]["scores"][rid], rtol=0,
                                       atol=SCORE_ATOL)
    log(f"[mesh] rm1: every rank's scores within {SCORE_ATOL} of [serve]'s "
        f"(worst {worst:.3g}); after healthy_mesh({{'model': 2}}, 0.4) the "
        f"2 survivors' within {SCORE_ATOL} of the first mesh's (worst "
        f"{worst_h:.3g})")
    return [x["launches"]["embedding_bag_fused_flat"] for x in res]


def mesh_zoo(dev, card, lm) -> None:
    """whisper-large-v3, zamba2-7b and rwkv6-3b, one spawn of the ranks
    each, freed before the next: the arch at full width in bf16, then
    its fp32 copies; their launches go into ``lm``."""
    for arch in MESH_ZOO:
        cases = [zoo_mesh_case(arch, dev)] + [
            zoo_mesh_case(arch, dev, what)
            for a, what in MESH_ZOO_COPIES if a == arch]
        per_job, wall_s = run_ranks([("lm", c["payload"]) for c in cases])
        log(f"[mesh] {[c['tag'] for c in cases]}: {MESH_WORLD} ranks "
            f"spawned, served and joined in {wall_s:.1f} s")
        for c, res in zip(cases, per_job):
            lm_check(c, res, card, lm)
        del cases, per_job, c, res
        free_card()


def mesh_phase(dev, card, reqs, scores, rows) -> dict:
    """Spawns of four rank processes on the one card: smollm-135m on
    (1, 4), the 2-layer copies, then RM1 V0 on (data 2, model 2) and on the
    survivors of a failure; then qwen2-moe-a2.7b on (1, 4) alone (the
    parent's copy of its weights and the ranks' blocks hold 72 GB); then
    whisper, zamba2 and rwkv6 with their copies, one spawn each
    (``mesh_zoo``).  Returns rank 0's results of smollm-135m at full
    width (with its batch ``B`` and slots ``T``) for ``[dryrun]``."""
    from repro_torch.configs import rm1
    from repro_torch.models.dlrm import DLRMModel

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    log(f"[mesh] {MESH_WORLD} rank processes on cuda:0, joined by a file:// "
        f"store; backend gloo (NCCL refuses two ranks on one device).  "
        f"Routes: lsc/full -> c10d all_gather then a local slice, never "
        f"DTensor's functional collectives (they crash on gloo CUDA "
        f"tensors: tools/gloo_probe.py --funcol); psum/pmax -> all_reduce "
        f"in fp32; all_gather -> all_gather (native on gloo CUDA)")
    lm = {}
    cfg = rm1.CONFIG.replace(
        name="rm1.v0-rows40k",
        dlrm=dataclasses.replace(rm1.CONFIG.dlrm, rows_per_table=ROWS))
    cases = ([lm_case("smollm-135m", dev)]
             + [lm_case(a, dev, dt) for a, dt in MESH_COPIES])
    jobs = [("lm", c["payload"]) for c in cases] + [("rm1", {
        "cfg": cfg, "params": DLRMModel(cfg).init(0, device=dev),
        "reqs": reqs, "batch": MESH_RM1_BATCH, "dev": dev})]  # [serve]'s
    per_job, wall_s = run_ranks(jobs)
    log(f"[mesh] {[c['tag'] for c in cases] + ['rm1']}: {MESH_WORLD} ranks "
        f"spawned, served and joined in {wall_s:.1f} s")
    for c, res in zip(cases, per_job):
        lm_check(c, res, card, lm)
    smollm_rank0 = dict(per_job[0][0], B=cases[0]["B"], T=cases[0]["T"])
    launches = {"rm1": rm1_check(per_job[-1], reqs, scores, card)}
    del cases, jobs, per_job, c, res
    free_card()

    case = lm_case("qwen2-moe-a2.7b", dev)
    (res,), wall_s = run_ranks([("lm", case["payload"])])
    log(f"[mesh] {case['tag']}: {MESH_WORLD} ranks spawned, served and "
        f"joined in {wall_s:.1f} s")
    lm_check(case, res, card, lm)
    del case, res
    free_card()
    mesh_zoo(dev, card, lm)
    for row in rows:
        if row["name"] == "embedding_bag_fused_flat":
            row["mesh_launches"] = launches
        if row["name"] in ("flash_attention", "flash_decode_partial"):
            row["mesh_launches"] = {tag: [n[row["name"]] for n in per]
                                    for tag, per in lm.items()}
    log(f"[mesh] phase took {time.perf_counter() - t0:.1f} s; {card}")
    return smollm_rank0


# ---------------------------------------------------------- mesh-train
#: [mesh-train] (a): smollm-135m's loop on (data 2, model 2): batch x
#: seq, steps, checkpoint period, the step whose hook raises once
MT_BATCH, MT_SEQ, MT_STEPS, MT_CKPT_EVERY, MT_FAULT_AT = 8, 1024, 8, 3, 5
#: each logged loss of the mesh against one device's (relative), and (b)
MT_LOSS_RTOL = 0.02
#: (c) the fp32 copies at full width: arch -> (layers, batch, seq)
MT_COPIES = {"smollm-135m": (2, 4, 256), "qwen2-moe-a2.7b": (2, 2, 256),
             "whisper-large-v3": (2, 2, 256),     # 2 + 2 layers
             "zamba2-7b": (RECURRENT_FP32_LAYERS, 2, 256),
             "rwkv6-3b": (2, 2, 256)}
MT_COPY_LOSS_RTOL = 1e-5       # the loss against one device, relative
MT_GRAD_RTOL = 1e-4            # gradients: rtol, and atol 1e-6 + 1e-4 of
MT_GRAD_ATOL = 1e-6            # the leaf's largest magnitude ([train]'s)
MT_AUX_ATOL = 1e-6             # the MoE aux loss
#: params and moments after one Adam step: max |diff| over the leaf's
#: largest |x|, plus, elementwise, what the measured gradient difference
#: dg (clip included) moves them by: m by (1 - b1) dg, v by (1 - b2) dg
#: (|g| + |g'|), a param by at most lr dg / eps (the first update
#: lr g / (|g| + eps) has slope at most lr / eps)
MT_STEP_RTOL = 1e-6
#: (d) RM1 V0, rows cut as [train] cuts them: batch, steps
MT_RM1_BATCH, MT_RM1_STEPS = 64, 3


def np_block(arr, placements, mesh):
    """This rank's block of a (memory-mapped) numpy array under DTensor
    ``placements``: ``sharding.block``'s narrowing, as slices."""
    coord = mesh.get_coordinate()
    start, size = [0] * arr.ndim, list(arr.shape)
    for i, pl in enumerate(placements):
        if pl.is_shard():
            d = pl.dim
            size[d] //= mesh.size(i)
            start[d] += coord[i] * size[d]
    return arr[tuple(slice(a, a + n) for a, n in zip(start, size))]


def sorted_items(tree, path=""):
    """(path, leaf) in sorted-key order, None subtrees skipped."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from sorted_items(tree[k], f"{path}/{k}")
    elif tree is not None:
        yield path, tree


def leaf_file(d, path: str) -> Path:
    """The ``.npy`` file of a tree leaf ``path`` under directory ``d``."""
    return Path(d) / (path.strip("/").replace("/", ".") + ".npy")


def save_leaves(tree, d) -> None:
    """Every leaf of ``tree`` to its own ``.npy`` file under ``d``."""
    Path(d).mkdir(parents=True, exist_ok=True)
    for path, t in sorted_items(tree):
        np.save(leaf_file(d, path), t.detach().cpu().numpy())


def placed_from_files(d, model, mesh, rules, dev):
    """The model's parameters placed on ``mesh`` under ``rules``, each
    rank reading only its blocks from the ``.npy`` files under ``d``
    (memory-mapped): the weights never sit whole on the card."""
    from repro_torch.distributed import sharding as shd

    out = {}
    with shd.use_mesh(mesh, rules):
        for path, names in sorted_items(model.param_specs()):
            arr = np.load(leaf_file(d, path), mmap_mode="r")
            loc = np.array(np_block(
                arr, shd.make_sharding(names, arr.shape), mesh))
            *keys, last = path.strip("/").split("/")
            node = out
            for k in keys:
                node = node.setdefault(k, {})
            node[last] = shd.place_local(torch.from_numpy(loc).to(dev),
                                         names, arr.shape)
    return out


def adam_first_step(cfg, p, g, clip):
    """One device's first Adam update of one leaf from zero moments, in
    ``optimizer.apply_updates``' op order: (new p, m, v)."""
    step = torch.ones((), dtype=torch.float32, device=p.device)
    bc1, bc2 = 1 - cfg.b1 ** step, 1 - cfg.b2 ** step
    m = torch.zeros(g.shape, dtype=torch.float32, device=g.device)
    v = torch.zeros_like(m)
    g = g.float() * clip
    m = cfg.b1 * m + (1 - cfg.b1) * g
    v = cfg.b2 * v + (1 - cfg.b2) * g * g
    delta = cfg.lr * (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
    return (p.float() - delta).to(p.dtype), m, v


def grad_allreduce_bytes(params) -> int:
    """The gradient all-reduce's payload a step on this rank: each
    leaf's local gradient in fp32, once per mesh dim it is replicated
    on."""
    from repro_torch.distributed import sharding as shd
    return sum(shd.local_tensor(x).numel() * 4 * len(shd.placed_dims(x)[1])
               for _, x in sorted_items(params))


class CkptTimer:
    """Times every ``checkpoint.save`` and ``try_restore`` call made
    while it is active."""

    def __init__(self):
        from repro_torch.train import checkpoint as ckpt
        self.ckpt, self.orig = ckpt, (ckpt.save, ckpt.try_restore)
        self.save_s, self.restore_s = [], []

    def __enter__(self):
        save, restore = self.orig

        def timed(fn, into):
            def run(*a, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                into.append(time.perf_counter() - t0)
                return out
            return run

        self.ckpt.save = timed(save, self.save_s)
        self.ckpt.try_restore = timed(restore, self.restore_s)
        return self

    def __exit__(self, *exc):
        self.ckpt.save, self.ckpt.try_restore = self.orig
        return False


def mt_loop_args(ckpt_dir: str):
    from repro_torch.launch import train as train_cli
    return train_cli.parser().parse_args(
        ["--arch", "smollm-135m", "--steps", str(MT_STEPS), "--batch",
         str(MT_BATCH), "--seq", str(MT_SEQ), "--ckpt-every",
         str(MT_CKPT_EVERY), "--log-every", "1", "--ckpt-dir", ckpt_dir])


def mt_fault_hook():
    fired = []

    def hook(step):
        if step == MT_FAULT_AT and not fired:
            fired.append(step)
            raise RuntimeError("injected node failure")
    return hook, fired


def step_intervals(lines):
    """Step ms from the loop's log lines: one "step" line to the next,
    leaving out those that hold a checkpoint save or the fault."""
    out = []
    for (ta, ma), (tb, mb) in zip(lines, lines[1:]):
        if not (ma.startswith("step") and mb.startswith("step")):
            continue
        a, b = int(ma.split()[1]), int(mb.split()[1])
        if b == a + 1 and b % MT_CKPT_EVERY:
            out.append((tb - ta) * 1e3)
    return out


def mt_lm_rank(rank: int, p) -> dict:
    """(a) smollm-135m through ``run_train_loop(mesh=, rules=)`` on (data
    2, model 2) with a fault and checkpoints; one more step with the
    collectives timed; (b) ``elastic_restore`` of the loop's checkpoint
    onto ``healthy_mesh({"model": 2}, 0.4)``: the survivors' params and
    state gathered whole against the file's arrays, and one step there."""
    import torch.distributed as dist

    from repro_torch.distributed import elastic
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import registry
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.train_loop import (make_sharded_train_step,
                                              run_train_loop, train_shape)

    dev = p["dev"]
    model, opt_cfg, loader, loop_cfg = train_cli.build(mt_loop_args(p["ckpt"]))
    cfg = model.cfg
    mesh = make_host_mesh(2, device=dev)
    rules = registry.make_rules(cfg, mesh, "train")
    hook, fired = mt_fault_hook()
    lines = []
    dist.barrier()
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    with CkptTimer() as timer:
        params, state, hist = run_train_loop(
            model, opt_cfg, loader, loop_cfg, mesh=mesh, rules=rules,
            params=p["params"], fault_hook=hook, device=dev,
            log_fn=lambda m: lines.append((time.perf_counter(), m)))
    torch.cuda.synchronize()
    out = {"coord": mesh.get_coordinate(), "hist": hist, "fired": fired,
           "loop_s": time.perf_counter() - t0,
           "launches": sum(ops.LAUNCHES.values()),
           "step_ms": step_intervals(lines),
           "first_ms": (lines[0][0] - t0) * 1e3,
           "save_s": timer.save_s, "restore_s": timer.restore_s,
           "msgs": [m for _, m in lines], "card_gb": card_used_gb(),
           "allreduce_bytes": grad_allreduce_bytes(params),
           "latest": ckpt.latest_step(p["ckpt"])}
    batch = {k: torch.from_numpy(np.asarray(v)).to(dev)
             for k, v in next(iter(loader)).items()}
    step = make_sharded_train_step(model, opt_cfg, mesh, rules,
                                   train_shape(batch))
    step(params, state, batch)                    # warm
    with MeshProbe(timed=True) as coll:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(params, state, batch)
        torch.cuda.synchronize()
        out["timed_step_ms"] = (time.perf_counter() - t0) * 1e3
    out["coll_share"] = coll.coll_s * 1e3 / out["timed_step_ms"]
    del params, state, step
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the survivors restore the checkpoint
    small = elastic.healthy_mesh({"model": 2}, failed_fraction=0.4,
                                 device=dev)
    out["healthy"] = small.mesh.tolist()
    srules = registry.make_rules(cfg, small, "train")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = elastic.elastic_restore(p["ckpt"], model, opt_cfg, small, srules)
    torch.cuda.synchronize()
    out["elastic_s"] = time.perf_counter() - t0
    if res is None:
        return out
    params, state, step_no = res
    out["elastic_step"] = step_no
    with np.load(Path(p["ckpt"]) / f"ckpt_{step_no:08d}.npz") as data:
        diffs, n = [], 0
        for prefix, tree in (("p", params), ("o", state)):
            for path, x in sorted_items(tree):
                whole = shd.full(x).float().cpu().numpy()
                n += 1
                if not np.array_equal(whole, data[prefix + path]):
                    diffs.append(prefix + path)
    out["elastic_leaves"], out["elastic_diffs"] = n, diffs
    out["elastic_block"] = tuple(shd.local_tensor(params["embed"]).shape)
    b = {k: torch.from_numpy(v).to(dev) for k, v in p["batch_b"].items()}
    ops.reset_launches()
    _, _, met = make_sharded_train_step(model, opt_cfg, small, srules,
                                        train_shape(b))(params, state, b)
    out["elastic_loss"] = float(met["loss"])
    out["elastic_launches"] = sum(ops.LAUNCHES.values())
    return out


def mt_copy_rank(rank: int, p) -> dict:
    """(c) an fp32 copy at full width, 2 layers, on (data 2, model 2):
    the loss, the MoE aux, every leaf's gradient and, after one Adam
    step, the params and moments, each rank's blocks against the same
    blocks of one device's (its gradients read from files; its step
    recomputed from them by ``adam_first_step``)."""
    import torch.distributed as dist

    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import registry
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_loop import value_and_grad

    cfg, dev, ocfg = p["cfg"], p["dev"], OptConfig()
    model = registry.build(cfg)
    mesh = make_host_mesh(2, device=dev)
    rules = registry.make_rules(cfg, mesh, "train")
    placed = placed_from_files(p["weights"], model, mesh, rules, dev)
    with shd.use_mesh(mesh, rules):
        state = opt_mod.init_state(ocfg, placed, opt_mod.state_specs(
            ocfg, model.param_specs(), model.param_shapes()))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in p["batch"].items()}
    dist.barrier()
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with shd.use_mesh(mesh, rules):
        loss, grads = value_and_grad(model, placed, batch)
        torch.cuda.synchronize()
        vg_s = time.perf_counter() - t0
        aux = moe_aux(model, placed, batch)
        gnorm = opt_mod.global_norm(grads)
        mclip = torch.clamp(ocfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                            max=1.0)
        opt_mod.apply_updates(ocfg, placed, grads, state)
    torch.cuda.synchronize()
    out = {"coord": mesh.get_coordinate(), "loss": float(loss),
           "aux": float(aux), "vg_s": vg_s, "card_gb": card_used_gb(),
           "launches": sum(ops.LAUNCHES.values()),
           "allreduce_bytes": grad_allreduce_bytes(placed)}
    wdir, clip = Path(p["witness"]), torch.tensor(p["clip"], device=dev)
    worst = {k: (0.0, "") for k in ("grad", "param", "m", "v")}
    bad = []

    def note(kind, path, got, want, bound, scale):
        """Fold one chunk's elementwise check into ``worst``/``bad``."""
        diff = (got - want).abs()
        rel = float(diff.max()) / max(scale, 1e-30)
        if rel > worst[kind][0]:
            worst[kind] = (rel, path)
        if not bool((diff <= bound).all()):
            bad.append(f"{kind} {path}: max err {float(diff.max()):.3g} "
                       f"of {scale:.3g}")

    def rows(t):
        """Row ranges of ``t`` of at most 32 M elements (bounds the
        comparison's temporaries)."""
        per = max(1, (1 << 25) // max(1, t[0].numel()))
        return [(i, min(t.shape[0], i + per))
                for i in range(0, t.shape[0], per)]

    def chunk_of(arr, a, b):
        return torch.from_numpy(np.array(arr[a:b])).to(dev)

    flat_g = dict(sorted_items(grads))
    ms, vs = dict(sorted_items(state["m"])), dict(sorted_items(state["v"]))
    del grads
    for path in list(flat_g):
        g, x, m, v = flat_g[path], placed_of(placed, path), ms[path], vs[path]
        arr = np.load(leaf_file(wdir, path), mmap_mode="r")
        init = np.load(leaf_file(p["weights"], path), mmap_mode="r")
        # the param's block: the gradient, and the param after the step
        wblk, p0 = (np_block(arr, x.placements, mesh),
                    np_block(init, x.placements, mesh))
        gl, xl = g.to_local(), x.to_local()
        gatol = MT_GRAD_ATOL + MT_GRAD_RTOL * p["gmax"][path]
        pscale = float(xl.abs().max())
        own_ok = True
        for a, b in rows(xl):
            want = chunk_of(wblk, a, b)
            note("grad", path, gl[a:b], want,
                 gatol + MT_GRAD_RTOL * want.abs(), p["gmax"][path])
            p0c = chunk_of(p0, a, b)
            new_p = adam_first_step(ocfg, p0c, want, clip)[0]
            dg = (gl[a:b].float() * mclip - want * clip).abs()
            note("param", path, xl[a:b], new_p,
                 MT_STEP_RTOL * pscale + ocfg.lr * dg / ocfg.eps, pscale)
            # the ZeRO-1 update itself is exact: this rank's gradient and
            # clip through one device's update give its block bitwise
            own_ok &= torch.equal(adam_first_step(
                ocfg, p0c, gl[a:b], mclip)[0], xl[a:b])
            del want, new_p, dg, p0c
        # the state's (ZeRO-1) block: the moments after the step
        gwblk, pw = (np_block(arr, m.placements, mesh),
                     np_block(init, m.placements, mesh))
        gm = opt_mod._Zero(x, g, m).gb
        ml, vl = m.to_local(), v.to_local()
        mscale, vscale = float(ml.abs().max()), float(vl.abs().max())
        for a, b in rows(ml):
            gw, pwc = chunk_of(gwblk, a, b), chunk_of(pw, a, b)
            _, mw, vw = adam_first_step(ocfg, pwc, gw, clip)
            _, m_own, v_own = adam_first_step(ocfg, pwc, gm[a:b], mclip)
            own_ok &= (torch.equal(m_own, ml[a:b])
                       and torch.equal(v_own, vl[a:b]))
            ga, gb = gm[a:b].float() * mclip, gw * clip
            dgs = (ga - gb).abs()
            note("m", path, ml[a:b], mw,
                 MT_STEP_RTOL * mscale + (1 - ocfg.b1) * dgs, mscale)
            note("v", path, vl[a:b], vw, MT_STEP_RTOL * vscale
                 + (1 - ocfg.b2) * dgs * (ga.abs() + gb.abs()), vscale)
            del gw, pwc, mw, vw, m_own, v_own, ga, gb, dgs
        if not own_ok:
            bad.append(f"{path}: the ZeRO-1 update is not one device's on "
                       f"this rank's gradient")
        del flat_g[path], g, arr, init
    out["worst"], out["bad"] = worst, bad
    return out


def moe_aux(model, params, batch):
    """The MoE router aux loss of a training forward (0.0 without MoE:
    the other families' losses have none)."""
    if model.cfg.moe is None:
        return 0.0
    with torch.no_grad():
        return model.forward(params, batch, train=True)[1]


def placed_of(tree, path):
    for k in path.strip("/").split("/"):
        tree = tree[k]
    return tree


def mt_rm1_rank(rank: int, p) -> dict:
    """(d) RM1 V0 (rows cut) on (data 2, model 2), Adagrad: the bank's
    gradient, each rank's block against one device's, and
    ``MT_RM1_STEPS`` steps of the sharded train step; then one more step
    with the collectives timed."""
    import torch.distributed as dist

    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import registry
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_loop import (make_sharded_train_step,
                                              train_shape, value_and_grad)

    cfg, dev = p["cfg"], p["dev"]
    ocfg = OptConfig(kind="adagrad")
    model = registry.build(cfg)
    mesh = make_host_mesh(2, device=dev)
    rules = registry.make_rules(cfg, mesh, "train")
    placed = placed_from_files(p["weights"], model, mesh, rules, dev)
    with shd.use_mesh(mesh, rules):
        state = opt_mod.init_state(ocfg, placed, opt_mod.state_specs(
            ocfg, model.param_specs(), model.param_shapes()))
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()}
               for b in p["batches"]]
    dist.barrier()
    ops.reset_launches()
    with shd.use_mesh(mesh, rules):
        loss, grads = value_and_grad(model, placed, batches[0])
    bank = grads["embed"]
    arr = np.load(p["witness"], mmap_mode="r")
    want = torch.from_numpy(np.array(
        np_block(arr, bank.placements, mesh))).to(dev)
    got = bank.to_local()
    out = {"coord": mesh.get_coordinate(), "loss0": float(loss),
           "block": tuple(got.shape),
           "bank_err": float((got - want).abs().max()),
           "bank_ok": bool(torch.allclose(
               got, want, rtol=MT_GRAD_RTOL,
               atol=MT_GRAD_ATOL + MT_GRAD_RTOL * p["gmax"])),
           "allreduce_bytes": grad_allreduce_bytes(placed)}
    del grads, bank, want, got
    step = make_sharded_train_step(model, ocfg, mesh, rules,
                                   train_shape(batches[0]))
    losses, ms = [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, met = step(placed, state, b)
        losses.append(float(met["loss"]))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    out.update(losses=losses, step_ms=ms, card_gb=card_used_gb(),
               launches=sum(ops.LAUNCHES.values()))
    with MeshProbe(timed=True) as coll:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(placed, state, batches[0])
        torch.cuda.synchronize()
        out["timed_step_ms"] = (time.perf_counter() - t0) * 1e3
    out["coll_share"] = coll.coll_s * 1e3 / out["timed_step_ms"]
    return out


MESH_JOBS.update(train_lm=mt_lm_rank, train_copy=mt_copy_rank,
                 train_rm1=mt_rm1_rank)


def mt_lm_case(dev, tmp: Path, card) -> dict:
    """(a)'s weights, drawn once, and one device's run of the same loop
    on a copy of them (its own checkpoint directory) before the ranks."""
    from repro_torch.data.queries import ShardedLoader, lm_batch
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_cli
    from repro_torch.models.params import tree_map
    from repro_torch.train.train_loop import run_train_loop

    model, opt_cfg, loader, loop_cfg = train_cli.build(
        mt_loop_args(str(tmp / "one")))
    params = model.init(0, device=dev)
    hook, fired = mt_fault_hook()
    lines = []
    ops.reset_launches()
    t0 = time.perf_counter()
    _, _, hist = run_train_loop(
        model, opt_cfg, loader, loop_cfg,
        params=tree_map(lambda t: t.clone(), params), fault_hook=hook,
        device=dev, log_fn=lambda m: lines.append((time.perf_counter(), m)))
    torch.cuda.synchronize()
    assert sum(ops.LAUNCHES.values()) == 0, ops.LAUNCHES
    ms = step_intervals(lines)
    vocab = model.cfg.vocab_size
    batch_b = {k: np.asarray(v) for k, v in next(iter(ShardedLoader(
        lambda rng: lm_batch(vocab, MT_BATCH, MT_SEQ, rng), seed=1))).items()}
    log(f"[mesh-train] (a) one device's witness: {len(hist)} logged steps "
        f"in {time.perf_counter() - t0:.1f} s, step {statistics.median(ms):.3f}"
        f" ms median; {card}")
    return {"model": model, "opt_cfg": opt_cfg, "hist": hist,
            "one_ms": ms, "batch_b": batch_b,
            "payload": {"params": params, "dev": dev,
                        "ckpt": str(tmp / "mesh"), "batch_b": batch_b}}


def mt_copy_case(arch, dev, tmp: Path, card) -> dict:
    """(c): an fp32 copy of ``arch`` at full width, 2 layers (MoE at
    capacity factor 8.0), its weights drawn once, and one device's loss,
    aux, gradients and gradient clip before the ranks; the weights and
    the gradients go to ``.npy`` files, from which each rank reads its
    blocks.  smollm's also checks ``adam_first_step`` against one
    device's ``apply_updates`` bitwise."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import registry
    from repro_torch.models.params import tree_map
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_loop import value_and_grad

    layers, B, S = MT_COPIES[arch]
    cfg = configs.get_config(arch).replace(
        num_layers=layers, dtype="float32", param_dtype="float32")
    if cfg.encdec is not None:
        cfg = cfg.replace(encdec=dataclasses.replace(
            cfg.encdec, num_encoder_layers=layers))
    if cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  capacity_factor=8.0))
    model = registry.build(cfg)
    params = drawn_compact(lambda: model.init(0, device=dev), dev)
    rng = np.random.RandomState(17)
    toks = rng.randint(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}
    if cfg.encdec is not None:
        batch["frames"] = rng.randn(B, cfg.encdec.encoder_seq,
                                    cfg.d_model).astype(np.float32)
    tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    ocfg = OptConfig()
    one = tree_map(lambda t: t.clone(), params)
    ops.reset_launches()
    loss, grads = value_and_grad(model, one, tb)
    aux = moe_aux(model, one, tb)
    gnorm = opt_mod.global_norm(grads)
    clip = torch.clamp(ocfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                       max=1.0)
    assert sum(ops.LAUNCHES.values()) == 0, ops.LAUNCHES
    wdir = tmp / arch / "grads"
    save_leaves(grads, wdir)
    save_leaves(params, tmp / arch / "weights")
    gmax = {path: float(g.abs().max()) for path, g in sorted_items(grads)}
    checked = ""
    if arch == "smollm-135m":     # the recomputed step is one device's
        state = opt_mod.init_state(ocfg, one)
        opt_mod.apply_updates(ocfg, one, grads, state)
        for path, g in sorted_items(grads):
            p0 = placed_of(params, path)
            np_, m, v = adam_first_step(ocfg, p0, g, clip)
            assert torch.equal(np_, placed_of(one, path)), path
            assert torch.equal(m, placed_of(state["m"], path)), path
            assert torch.equal(v, placed_of(state["v"], path)), path
        checked = "; adam_first_step bitwise equal to apply_updates"
        del state
    log(f"[mesh-train] (c) {arch} fp32 copy: {layers} layers"
        f"{' + ' + str(layers) if cfg.encdec else ''} at full "
        f"width, batch {B} x seq {S}: one device's loss {float(loss):.6f}, "
        f"aux {float(aux):.6f}, grad norm {float(gnorm):.6f}, clip "
        f"{float(clip):.6f}{checked}; {card}")
    out = {"arch": arch, "loss": float(loss), "aux": float(aux),
           "payload": {"cfg": cfg, "weights": str(tmp / arch / "weights"),
                       "dev": dev, "batch": batch, "witness": str(wdir),
                       "clip": float(clip), "gmax": gmax}}
    del one, grads, loss, params
    return out


def mt_rm1_case(dev, tmp: Path, card) -> dict:
    """(d): RM1 V0 (rows cut), its weights drawn once (and written to
    ``.npy`` files for the ranks), seeded batches, and one device's bank
    gradient (written to a file) and Adagrad losses over the same steps
    before the ranks."""
    from repro_torch.configs import rm1
    from repro_torch.data.queries import dlrm_batch
    from repro_torch.models import registry
    from repro_torch.models.params import tree_map
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_loop import make_train_step, value_and_grad

    cfg = rm1.CONFIG.replace(
        name=f"rm1.v0-rows{TRAIN_RM1_ROWS // 1000}k",
        dlrm=dataclasses.replace(rm1.CONFIG.dlrm,
                                 rows_per_table=TRAIN_RM1_ROWS))
    model = registry.build(cfg)
    params = model.init(0, device=dev)
    rng = np.random.RandomState(29)
    batches = [{k: np.asarray(v) for k, v in dlrm_batch(
        cfg, MT_RM1_BATCH, rng).items()} for _ in range(MT_RM1_STEPS)]
    tbs = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()}
           for b in batches]
    one = tree_map(lambda t: t.clone(), params)
    _, grads = value_and_grad(model, one, tbs[0])
    bank = grads["embed"]
    np.save(tmp / "rm1_bank_grad.npy", bank.cpu().numpy())
    save_leaves(params, tmp / "rm1")
    gmax = float(bank.abs().max())
    del grads, bank
    ocfg = OptConfig(kind="adagrad")
    state = opt_mod.init_state(ocfg, one)
    step = make_train_step(model, ocfg)
    losses = []
    for b in tbs:
        one, state, met = step(one, state, b)
        losses.append(float(met["loss"]))
    log(f"[mesh-train] (d) {cfg.name}: one device's Adagrad losses "
        f"{[round(v, 6) for v in losses]}; {card}")
    del one, state, params
    return {"cfg": cfg, "losses": losses,
            "payload": {"cfg": cfg, "weights": str(tmp / "rm1"), "dev": dev,
                        "batches": batches,
                        "witness": str(tmp / "rm1_bank_grad.npy"),
                        "gmax": gmax}}


def mt_check_lm(case, res, card) -> None:
    hist = case["hist"]
    for r, x in enumerate(res):
        assert x["fired"] == [MT_FAULT_AT], x["fired"]
        assert x["launches"] == 0, x["launches"]
        assert x["latest"] == MT_STEPS, x["latest"]
        assert [s for s, _ in x["hist"]] == [s for s, _ in hist], x["hist"]
        for (s, got), (_, want) in zip(x["hist"], hist):
            assert abs(got - want) <= MT_LOSS_RTOL * abs(want), (s, got, want)
        assert x["hist"][-1][1] < x["hist"][0][1], x["hist"]
        ms = x["step_ms"]
        log(f"[mesh-train] (a) rank {r} {tuple(x['coord'])}: "
            f"run_train_loop(mesh=, rules=) {MT_STEPS} steps in "
            f"{x['loop_s']:.1f} s; step {statistics.median(ms):.3f} ms "
            f"median over {len(ms)} (min {min(ms):.3f}, max {max(ms):.3f}; "
            f"the first, with its warm-up, {x['first_ms']:.1f}); "
            f"{MT_BATCH * MT_SEQ / statistics.median(ms) * 1e3:.0f} tokens/s;"
            f" collectives {x['coll_share']:.3f} of a step's wall "
            f"({x['timed_step_ms']:.1f} ms, each collective timed from a "
            f"synchronised card; gloo stages through host memory, not "
            f"NVLink); gradient all-reduce payload "
            f"{x['allreduce_bytes'] / 1e6:.1f} MB a step; saves "
            f"{[round(t, 2) for t in x['save_s']]} s, restores "
            f"{[round(t, 2) for t in x['restore_s']]} s; peak "
            f"{x['peak_gb']:.3f} GB, the card {x['card_gb']:.2f} GB in use; "
            f"{card}")
    log(f"[mesh-train] (a) losses, mesh against one device: "
        f"{[(s, round(a, 4), round(b, 4)) for (s, a), (_, b) in zip(res[0]['hist'], hist)]}"
        f" (within {MT_LOSS_RTOL}); one device's step "
        f"{statistics.median(case['one_ms']):.3f} ms median; {card}")


def mt_check_elastic(case, res, dev, card) -> None:
    """(b): the survivors hold the checkpoint bitwise, and their step's
    loss lies within ``MT_LOSS_RTOL`` of one device's step from the same
    checkpoint on the same batch."""
    from repro_torch.models.params import tree_map
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.train_loop import make_train_step

    members = [x for x in res if "elastic_step" in x]
    assert len(members) == 2, [x.get("healthy") for x in res]
    model, opt_cfg = case["model"], case["opt_cfg"]
    tpl = tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                         device="meta"), model.param_shapes())
    params, state, step_no = ckpt.try_restore(
        case["payload"]["ckpt"], tpl, opt_mod.init_state(opt_cfg, tpl),
        device=dev)
    b = {k: torch.from_numpy(v).to(dev) for k, v in case["batch_b"].items()}
    _, _, met = make_train_step(model, opt_cfg)(params, state, b)
    want = float(met["loss"])
    for x in members:
        assert x["elastic_step"] == step_no == MT_STEPS, x["elastic_step"]
        assert not x["elastic_diffs"], x["elastic_diffs"]
        assert x["elastic_launches"] == 0
        assert abs(x["elastic_loss"] - want) <= MT_LOSS_RTOL * abs(want), (
            x["elastic_loss"], want)
    log(f"[mesh-train] (b) healthy_mesh({{'model': 2}}, 0.4) -> "
        f"{res[0]['healthy']}: elastic_restore of step {step_no} in "
        f"{[round(x['elastic_s'], 2) for x in res]} s by rank; "
        f"{members[0]['elastic_leaves']} leaves gathered whole, bitwise the "
        f"file's; embed block {members[0]['elastic_block']}; one step "
        f"there: loss {members[0]['elastic_loss']:.5f} against one device's "
        f"{want:.5f} from the same checkpoint; {card}")
    del params, state


def mt_check_copy(case, res, card) -> None:
    arch = case["arch"]
    for r, x in enumerate(res):
        assert x["launches"] == 0, x["launches"]
        assert abs(x["loss"] - case["loss"]) <= MT_COPY_LOSS_RTOL * abs(
            case["loss"]), (x["loss"], case["loss"])
        assert abs(x["aux"] - case["aux"]) <= MT_AUX_ATOL, (x["aux"],
                                                            case["aux"])
        assert not x["bad"], x["bad"][:8]
        log(f"[mesh-train] (c) {arch} rank {r} {tuple(x['coord'])}: loss "
            f"{x['loss']:.6f} (one device {case['loss']:.6f}), aux "
            f"{x['aux']:.6f} ({case['aux']:.6f}); worst leaf, max |err| "
            f"over its largest |x|: " + ", ".join(
                f"{k} {v:.3g} ({p})" for k, (v, p) in x["worst"].items())
            + f"; value_and_grad {x['vg_s'] * 1e3:.1f} ms; gradient "
            f"all-reduce payload {x['allreduce_bytes'] / 1e6:.1f} MB; peak "
            f"{x['peak_gb']:.3f} GB, the card {x['card_gb']:.2f} GB in use; "
            f"{card}")


def mt_check_rm1(case, res, card) -> None:
    for r, x in enumerate(res):
        assert x["launches"] == 0, x["launches"]
        assert x["bank_ok"], x["bank_err"]
        for got, want in zip(x["losses"], case["losses"]):
            assert abs(got - want) <= MT_COPY_LOSS_RTOL * abs(want), (
                x["losses"], case["losses"])
        ms = x["step_ms"]
        log(f"[mesh-train] (d) {case['cfg'].name} rank {r} "
            f"{tuple(x['coord'])}: bank block {x['block']}, its gradient "
            f"within rtol {MT_GRAD_RTOL} of one device's (max err "
            f"{x['bank_err']:.3g}); Adagrad losses "
            f"{[round(v, 6) for v in x['losses']]}; step "
            f"{statistics.median(ms):.3f} ms median of {len(ms)} (min "
            f"{min(ms):.3f}, max {max(ms):.3f}); "
            f"{MT_RM1_BATCH / statistics.median(ms) * 1e3:.0f} samples/s; "
            f"collectives {x['coll_share']:.3f} of a step's wall "
            f"({x['timed_step_ms']:.1f} ms); gradient all-reduce payload "
            f"{x['allreduce_bytes'] / 1e6:.1f} MB; peak {x['peak_gb']:.3f} "
            f"GB, the card {x['card_gb']:.2f} GB in use; {card}")


def mesh_train_phase(dev, card) -> None:
    """Training on a mesh of 4 rank processes on the one card (gloo, as
    in [mesh]).  Cases and cuts: (a) smollm-135m at its published
    widths, nothing cut, bf16, on (data 2, model 2): batch 8 x seq 1024
    and 8 steps (cut from [train]'s 2048 and 40 for the phase's time),
    a checkpoint every 3, a fault at step 5; (b) its checkpoint restored
    onto the 2 survivors; (c) fp32 copies at full width, depth cut to 2
    layers: smollm at batch 4 x 256, qwen2-moe-a2.7b at batch 2 x 256
    and capacity factor 8.0, whisper (2 + 2), zamba2 (7) and rwkv6 (2)
    at batch 2 x 256; (d) RM1 V0, rows_per_table cut to 10,000
    as in [train], batch 64, 3 steps.  One device's witness of each case
    is computed first from the same weights (its gradients kept in files
    on the host); the ranks compare their blocks against it."""
    import tempfile

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    log(f"[mesh-train] {MESH_WORLD} rank processes on cuda:0 (gloo, as "
        f"[mesh]); collectives differentiated by their transposes; ZeRO-1 "
        f"Adam/Adagrad state over data; no kernel launches")
    with tempfile.TemporaryDirectory() as d:
        tmp = Path(d)
        lm = mt_lm_case(dev, tmp, card)
        free_card()
        copies = [mt_copy_case(a, dev, tmp, card) for a in MT_COPIES]
        free_card()
        rm = mt_rm1_case(dev, tmp, card)
        free_card()
        log(f"[mesh-train] witnesses done in {time.perf_counter() - t0:.1f} "
            f"s; the parent holds {torch.cuda.memory_allocated() / 1e9:.2f} "
            f"GB of weights for the ranks")
        jobs = ([("train_lm", lm["payload"])]
                + [("train_copy", c["payload"]) for c in copies]
                + [("train_rm1", rm["payload"])])
        per_job, wall_s = run_ranks(jobs, deadline_s=600)
        log(f"[mesh-train] {MESH_WORLD} ranks spawned, trained and joined "
            f"in {wall_s:.1f} s")
        mt_check_lm(lm, per_job[0], card)
        del jobs
        free_card()
        mt_check_elastic(lm, per_job[0], dev, card)
        for c, res in zip(copies, per_job[1:-1]):
            mt_check_copy(c, res, card)
        mt_check_rm1(rm, per_job[-1], card)
        del lm, copies, rm, per_job
        free_card()
    log(f"[mesh-train] phase took {time.perf_counter() - t0:.1f} s; {card}")


# -------------------------------------------------------------- dryrun
#: [dryrun] (a): the archs run on both production meshes at every shape
DRYRUN_ARCHS = ("smollm-135m", "qwen2-moe-a2.7b")
#: cells (a) leaves out, for its 60 s: qwen2-moe's training takes 62-63 s
#: a mesh on an H100 host's 8 cores, more than all the others together;
#: tests/test_torch_dryrun.py holds its argument bytes
DRYRUN_LEFT_OUT = (("qwen2-moe-a2.7b", "train_4k"),)


def dryrun_cell(arch: str, shape: str, multi: bool):
    """One cell of the dry run, in a worker process: (record, seconds)."""
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    rec = dryrun.run_cell(arch, shape, multi)
    return rec, time.perf_counter() - t0


def dryrun_phase(rank0: dict, card: str) -> None:
    """(a) the dry run of ``DRYRUN_ARCHS`` at every shape on both
    production meshes (but ``DRYRUN_LEFT_OUT``), its cells in worker processes (it runs on fake
    tensors: no card); (b) the dry run at ``[mesh]``'s (1, 4) smollm-135m
    shapes held against what that phase's rank 0 placed and launched;
    (c) ``ops.LAUNCHES`` untouched by the fake path."""
    import concurrent.futures as cf
    import multiprocessing
    import os

    from repro_torch.configs.base import SHAPES, ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    cells = [(a, s, m) for a in DRYRUN_ARCHS for s in SHAPES
             for m in (False, True) if (a, s) not in DRYRUN_LEFT_OUT]
    # the training cells take longest: first
    cells.sort(key=lambda c: SHAPES[c[1]].kind != "train")
    workers = min(len(cells), os.cpu_count() or 1)
    with cf.ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn")) as ex:
        futures = {c: ex.submit(dryrun_cell, *c) for c in cells}
        done = {c: f.result() for c, f in futures.items()}
    for (arch, shape, multi), (rec, secs) in sorted(done.items()):
        tag = f"{arch}|{shape}|{'multi' if multi else 'single'}"
        log(dryrun.record_line(tag, rec) + f" ({secs:.1f} s)")
        assert rec["status"] in ("ok", "skip"), rec
        if rec["status"] == "ok":
            assert rec["cost"]["flops"] > 0 and rec["memory"][
                "argument_bytes"] > 0, rec
    secs_a = time.perf_counter() - t0
    log(f"[dryrun] (a) {len(cells)} cells of {', '.join(DRYRUN_ARCHS)} "
        f"(left out: {DRYRUN_LEFT_OUT}) on {workers} worker processes in "
        f"{secs_a:.1f} s; fake tensors on {dryrun.fake_device()}")

    before = dict(ops.LAUNCHES)
    B, S, T = rank0["B"], MESH_LM["smollm-135m"][1], rank0["T"]
    pre = dryrun.run_cell(
        "smollm-135m", "prefill", False, mesh_shape=(1, MESH_WORLD),
        shape=ShapeConfig("prefill", S, B, "prefill"))
    dec = dryrun.run_cell(
        "smollm-135m", "decode", False, mesh_shape=(1, MESH_WORLD),
        shape=ShapeConfig("decode", T, B, "decode"))
    got = {"prefill": pre, "decode": dec}
    want_kernels = {
        "prefill": {k: v for k, v in rank0["prefill_launches"].items() if v},
        "decode": {"flash_decode_partial": rank0["decode_launches"][0]}}
    assert len(set(rank0["decode_launches"])) == 1, rank0["decode_launches"]
    for kind, rec in got.items():
        args = rec["memory"]["argument_bytes"]
        assert args == rank0["placed_bytes"][kind], (
            kind, args, rank0["placed_bytes"])
        assert rec["kernels"] == want_kernels[kind], (kind, rec["kernels"])
    peak = max(r["memory"]["total_per_device_bytes"] for r in got.values())
    log(f"[dryrun] (b) smollm-135m on (1, {MESH_WORLD}), batch {B}, prompt "
        f"{S}, {T} slots: argument bytes prefill "
        f"{pre['memory']['argument_bytes']}, decode "
        f"{dec['memory']['argument_bytes']}, equal to [mesh] rank 0's "
        f"placed {rank0['placed_bytes']}; kernel calls prefill "
        f"{pre['kernels']}, decode {dec['kernels']}, equal to its launches; "
        f"predicted peak {peak / 1e9:.3f} GB (prefill "
        f"{pre['memory']['total_per_device_bytes'] / 1e9:.3f}, decode "
        f"{dec['memory']['total_per_device_bytes'] / 1e9:.3f}) against the "
        f"rank's max_memory_allocated {rank0['peak_gb']:.3f} GB: ratio "
        f"{peak / 1e9 / rank0['peak_gb']:.3f}; collectives a decode step "
        f"{dec['collectives']['counts']}")
    assert ops.LAUNCHES == before, (before, ops.LAUNCHES)
    log(f"[dryrun] (c) ops.LAUNCHES untouched by the fake path {before}; "
        f"the phase took {time.perf_counter() - t0:.1f} s; {card}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    from repro_torch.configs import rm1
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.ref import embedding_bag_seq_ref
    from repro_torch.launch import serve
    from repro_torch.models.dlrm import DLRMModel
    from repro_torch.serving.engine import DLRMServingEngine
    from repro_torch.serving.scenario import plan_workload, run_scenario

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    log(card)
    log(f"[card] {kind}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; {torch.cuda.device_count()} card(s)")

    # -------------------------------------------------------------- build
    t0 = time.perf_counter()
    for name in SOURCES:       # build from the checkout's sources, always
        build.library_path(name).unlink(missing_ok=True)
    build.build(SOURCES)
    for name in SOURCES:
        build.load(name)
    log(f"[build] {', '.join(n + '.cu' for n in SOURCES)} built in "
        f"{time.perf_counter() - t0:.2f} s")
    for name in SOURCES:
        for line in build.BUILD_LOGS.get(name, "").splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling",
                                       "arning", "Performance Loss")):
                log(f"[build] {name}: {line.strip()}")

    # ------------------------------------------------------------ kernels
    check_grid(dev)
    check_attention_grid(dev)

    # -------------------------------------------------------------- serve
    cfg = rm1.CONFIG.replace(
        name="rm1.v0-rows40k",
        dlrm=dataclasses.replace(rm1.CONFIG.dlrm, rows_per_table=ROWS))
    log(f"[serve] {cfg.name}: RM1 V0 at its published widths "
        f"{dataclasses.asdict(cfg.dlrm)}; cut: rows_per_table "
        f"{rm1.CONFIG.dlrm.rows_per_table} -> {ROWS}")
    model = DLRMModel(cfg)
    params = model.init(0, device=dev)
    assert not torch.backends.cuda.matmul.allow_tf32   # set by the port
    flags = ["--cluster", "--full", "--mns", "4", "--cns", "2",
             "--replicas", "2", "--batch", "64", "--requests", "32",
             "--fail-mn", "1"]
    spec = serve.spec_from_flags(serve.parser().parse_args(
        flags + ["--mn-type", "2xddr_mn+2xnmp_mn"]))
    stream = plan_workload(spec, cfg)
    reqs = stream[0]

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    with MainPathProbe() as probe:
        rep = run_scenario(spec, model=model, params=params, stream=stream)
    launches = dict(ops.LAUNCHES)
    eng = rep.engine
    log(f"[serve] {rep.completed}/{rep.total} requests in "
        f"{eng.batches_seen} batches; launches {launches}; _mn_pool calls "
        f"{probe.calls}; serve wall {probe.serve_s:.3f} s = "
        f"{probe.serve_s / eng.batches_seen * 1e3:.2f} ms/batch; peak "
        f"device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
        f"{card}")
    for line in rep.summary():
        log(line)
    assert rep.completed == rep.total == len(reqs)
    assert all(launches[k] > 0 for k in KERNELS), launches
    assert sum(launches.values()) == probe.calls, (launches, probe.calls)
    assert rep.stats.failures == 1
    scores = {r.rid: r.outputs for r in rep.results}

    # ------------------------------------------------------------- timing
    rows = [time_kernel(name, *probe.first[name], launches[name], card)
            for name in KERNELS]

    serve_s = probe.serve_s
    del rep, eng, probe            # frees the replica shards
    gc.collect()
    torch.cuda.empty_cache()
    worst = check_scores(reqs, scores, lambda r: (model, params), dev)
    log(f"[serve] every score finite, in [0, 1], and within {SCORE_ATOL} "
        f"of the model's one-reduction path (worst {worst:.3g})")
    ops.reset_launches()
    spec_ddr = serve.spec_from_flags(serve.parser().parse_args(
        flags + ["--mn-type", "ddr_mn"]))
    rep_ddr = run_scenario(spec_ddr, model=model, params=params,
                           stream=stream)
    assert rep_ddr.completed == rep_ddr.total
    assert ops.LAUNCHES["embedding_bag_nmp_flat"] == 0
    for r in rep_ddr.results:
        assert np.array_equal(r.outputs, scores[r.rid]), r.rid
    log("[serve] all-DDR pool: scores bitwise equal to the mixed pool's")
    del rep_ddr
    gc.collect()
    torch.cuda.empty_cache()
    with MainPathProbe(profile=True) as traced:
        rep = run_scenario(spec, model=model, params=params, stream=stream)
    profile_summary(traced.prof, traced.serve_s, serve_s,
                    rep.engine.batches_seen, card)
    del rep, traced
    gc.collect()
    torch.cuda.empty_cache()

    # ------------------------------------------------------------ elastic
    elastic_phase(model, params, flags, stream, scores, card)

    # -------------------------------------------------------- single unit
    unit = DLRMServingEngine(model, params, batch_size=64, use_kernel=True)
    ops.reset_launches()
    out = unit.serve(reqs[:8])
    unit_launches = dict(ops.LAUNCHES)
    assert unit_launches["embedding_bag_fused_flat"] > 0, unit_launches
    for r in out:
        np.testing.assert_allclose(r.outputs, scores[r.rid], rtol=0,
                                   atol=SCORE_ATOL)
    idx = torch.from_numpy(np.concatenate(
        [r.payload["indices"] for r in reqs[:8]])[:64]).to(dev)
    whole = ops.embedding_bag_fused(params["embed"], idx)
    assert torch.equal(whole, embedding_bag_seq_ref(params["embed"], idx))
    log(f"[unit] DLRMServingEngine(use_kernel=True): {len(out)} requests, "
        f"launches {unit_launches}; the fused kernel over the whole "
        f"{tuple(params['embed'].shape)} bank (64-bit rows) is bitwise "
        f"equal to the slot-order reference")

    # ------------------------------------------------------------ sharded
    rows.append(sharded_phase(dev, cfg, model, params, reqs, card))
    del unit, out, whole, params, model
    gc.collect()
    torch.cuda.empty_cache()

    # -------------------------------------------------------------- fleet
    fleet_phase(dev, card)

    # ----------------------------------------------------------------- lm
    rows += lm_phase(dev, card)

    # ---------------------------------------------------------------- zoo
    zoo_phase(dev, card, rows)

    # ---------------------------------------------------------- recurrent
    recurrent_phase(dev, card, rows)

    # -------------------------------------------------------------- train
    train_phase(dev, card)

    # --------------------------------------------------------------- mesh
    smollm_rank0 = mesh_phase(dev, card, reqs, scores, rows)

    # --------------------------------------------------------- mesh-train
    mesh_train_phase(dev, card)

    # ------------------------------------------------------------- dryrun
    dryrun_phase(smollm_rank0, card)

    log(f"[total] the script took {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
