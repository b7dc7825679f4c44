#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero):

1. toolchain — card name and power limit, nvcc, torch and CUDA
   versions, whether triton imports; builds the five CUDA kernels of
   ``src/repro_torch/csrc`` (one nvcc per source, in parallel).
2. kernels — each crypto kernel against its plain PyTorch version on
   the card and against the numpy/hashlib oracles, on lengths 0, 1, 55,
   56, 63, 64, 65, 4096 and 512 KiB and on a tile of 256 x 512 KiB
   chunks with distinct keys (exact bytes); a one-byte tamper must raise
   ``IntegrityError`` naming its chunk. Times each kernel and its plain
   version at the tile, and the fused pass at 1 MiB tiles against the
   registered 128 MiB tile. The SHA-256 engine's risky inputs through
   the SHA and fused kernels against their plain versions, hashlib and
   ``ctr_decrypt``: one group of lengths 0, 1, 55, 64, 65, 512 KiB and
   524,304 (salt and chunk), N = 1, 31, 33 and 257 messages, starts
   1..15 bytes off the 16-byte grid; the launch
   geometry (G, stages, warps, shared memory) of both kernels at the
   tile is printed. The two erasure kernels (XOR parity, GF(256)
   matrix product) against their plain versions and numpy (XOR,
   ``erasure.gf_matmul``) on stripe lengths 0, 1, 3, 5, 15, 16, 17 and
   131072, with ``encode_matrix(4, 6)``'s parity rows, a random (8, 8)
   matrix and a (16, 16) matrix holding all 256 coefficients; parity
   also for k = 1, 2, 3, 5, 8, 9, on those lengths and 131073, and with
   the data 1, 4 and 8 bytes off the 16-byte grid; parity is timed on
   one ``put_chunk``'s (4, 131072) stripes beside an empty kernel of
   the same grid (the card's floor for one launch). The AES kernel's
   risky inputs against its plain version and ``aes.encrypt_blocks``:
   run lengths (1, 31, 33, 40, 32768) in one call, N = 1, 31, 33, 257
   blocks (one schedule per block, and in runs), AES-128 schedules, a
   batch giving every lane of a warp every byte value in every state
   position, and the FIPS-197 AES-128 and AES-256 example vectors.
3. main path — SmolLM-360M at full width (random weights from
   ``--seed``): ``ImageService.publish`` (SHA and AES kernels),
   ``cold_start`` through a second service on the same store, whose L1
   starts empty so every chunk comes from the origin (fused kernel), a
   byte-identity check of the restored
   tree, and a ``ServeEngine`` answering 4 requests whose greedy tokens
   must equal those of the same weights loaded without the image. The
   paper's Fig. 11 from the origin: the cold start's simulated
   ``sim_serial_s`` must equal fetched x 36 ms + L1 probes x 2 us
   (to 1e-9) and be at least 4x its ``sim_pipelined_s`` at the policy's
   parallelism; ``read_lat`` (``e2e.read``) holds one sample per fetched
   chunk (p50/p99 printed). Then an engine of ``max_len`` 8 serves a
   10-token prompt beside a 2-token one: the batch finishes and the
   short one's tokens equal its run alone (ROADMAP.md §3, fault 1).
   Phases 4-6 run on the cut image: phase 3's tree cut to its first
   ``CUT_LAYERS`` (8) of 32 layers at full width (0.503 GB), published
   into phase 3's store; a restore of it must be byte-identical, and the
   cut weights loaded directly give the greedy tokens phases 4-6 repeat.
4. L2 path — on the cut image: worker A (``l2_nodes=12``, 4-of-5
   stripes, latencies seeded from ``--seed``) restores with an empty
   L1, so every chunk comes from the origin and fills the L2 once (one
   parity launch per origin GET). (4b, the paper's Fig. 9) Every
   distinct chunk name is read from the healthy L2 once through
   ``get_chunk`` (4-of-5) and once through ``get_chunk_unreplicated``
   (4-of-4), each ciphertext checked against its name: p99.9 of 4-of-5
   must lie below 4-of-4's and p99 not above (p50/p90/p99/p99.9 and the
   tail cut printed); with ``cache-000`` crashed, every name once each
   way: 4-of-5 (one hedged batch) serves every chunk, the GF(256) kernel
   rebuilding those that lost a data stripe; 4-of-4 misses exactly the
   names whose first four ring nodes hold ``cache-000`` (apart from
   reads whose stripe passed the 20 ms deadline, counted); the node is
   healed. Then
   one L2 node crashes, and worker B, with an empty L1 and A's L2,
   cold-starts SmolLM-360M staged: no origin GET, every distinct chunk
   an L2 hit, the chunks that lost a data stripe rebuilt by the GF(256)
   kernel, the restored tree and the greedy tokens equal to phase 3's;
   B's ``sim_pipelined_s`` is printed beside phase 3's (Fig. 11, the L2
   against the origin), with the L2's ``hit_rate`` and ``l2.fetch``
   summary. A third worker restores streamed from the same L2 (byte
   check). The L2 is then flushed, and a fourth worker's restore must
   make one origin GET per distinct chunk (byte check). The GF(256)
   kernel is then timed at the largest erasure-signature group of B's
   reconstruction.
5. peer storm — on the cut image, a cold-start storm through the peer
   tier with a flaky origin (``FaultyStore``, 2% transient GET errors):
   workers 0-3, each an ``ImageService`` with an empty 256 MiB L1, no
   L2, retries (5 attempts) and a 50% circuit breaker, and its client
   of one 5-worker ``PeerMesh`` (binary provisioning trees), start
   together on their own threads (streamed reads, fused kernel). Worker
   0 cold-starts it and serves phase 3's prompts; workers 1-3
   restore the tree. The first worker that leads at most 1% of the
   flights and has served 100 transfers stops serving (crashed) while
   its own restore goes on. Checks:
   every tree and worker 0's tokens equal phase 3's; the fleet's origin
   GETs lie between the distinct chunk count and twice it; peer
   transfers happened and the crash fired; transient errors were
   retried with no giveup and the breaker never opened; at least four
   restores' worth of fused launches. Then one chunk's copy in the mesh
   is replaced by a one-byte-flipped one, and worker 4 (idle so far)
   restores: the fused kernel flags that chunk, the reader evicts it
   mesh-wide and restarts, the restart takes exactly one origin GET,
   and the restored tree is byte-identical.
6. checkpoint roll under a live restore — on a fresh store, a
   ``GenerationalGC`` and services sharing its pins and refcounts and
   one name-index sidecar: a trainer publishes the cut tree A as
   ``ckpt-0`` into R1 (SHA and AES kernels); a restarted trainer (a new
   service) publishes B, A with its last two layers of every
   ``g0/s0/*`` tensor redrawn, as ``ckpt-1``: it must skip encrypting
   exactly the chunks of B that hashlib finds in A, and upload the
   rest. ``retire_image(R1, "ckpt-0")`` must return A's chunks that B
   lacks. A reader (empty L1, no L2) restores B streamed from R1 while
   its origin GETs from the 350th on are held: meanwhile a sweep of R1
   is deferred and deletes nothing, ``new_root`` gives R2 and
   ``migrate`` moves one manifest and copies B's chunks. Released, the
   restore must equal B; then the sweep reclaims exactly the dead
   chunks, R1 expires and is deleted with no alarm. B cold-starts from
   R2 and serves phase 3's requests with the tokens of B loaded without
   the image. A ``CowBlockDevice`` over B in R2: a 4 MiB read across
   chunks equals B's image bytes, an unaligned 1 MiB write reads back,
   a fresh reader still sees the base, and a prefetched ``embed`` shard
   reads back equal with no further origin GET.
7. the launcher — SmolLM-360M at full width published into a fresh
   store under the launcher's tenant key, then served by
   ``repro_torch.launch.serve.main(["--arch", "smollm-360m",
   "--no-reduced", "--store", ..., "--eager-flush", "--l2-nodes", "0",
   "--requests", "8", "--max-new", "8"])`` in process with the decode
   tile left at ``"auto"`` (the autotune sweep runs here): its 8 greedy
   outputs must equal a ``ServeEngine`` over the same weights loaded
   directly, the restore must launch the fused kernel beyond the
   sweep's launches, and the stats must carry ``eager_flushes``; the
   chosen tile and each candidate's timed rate are printed. Then a
   reduced ``--publish`` launcher with ``--l2-nodes 6 --peer-workers 2
   --retry-attempts 3 --breaker-threshold 0.5 --origin-fault
   error_p=0.02`` must serve every request, launch SHA-256 and AES and
   give up no retry. Then ``DecoderLM.prefill``: 4 prompts of 256
   tokens at SmolLM-360M's full width in bfloat16 against prefill by
   decoding (argmax equal, logits within ``PREFILL_BF16_TOL``), and
   starcoder2-15b at full width cut to 2 of 40 layers (float32 weights
   drawn on the card), one 4608-token prompt past its 4096-token
   window, in float32, with the card route
   of ``flash_attn`` held against its plain blocked version at every
   layer (``FLASH_F32_TOL``); prefill ms and peak memory printed.
8. the MoE and hybrid families and the expert-shard restore. (a) At
   their published widths, in bfloat16, with weights drawn on the card
   from ``--seed`` (``models.lm.init_device``), one model at a time:
   arctic-480b cut to 1 of 35 layers (128 experts top-2 and the dense
   residual MLP), kimi-k2-1t-a32b to 2 of 61 (the dense first layer of
   d_ff 18432, then 384 experts top-8 and a shared expert; vocab
   163840), jamba-v0.1-52b to 8 of 32 (one period: attention at slot 4,
   Mamba elsewhere, MoE on odd slots). Each ``ServeEngine`` serves 8
   requests of 8-token prompts and 8 new tokens at batch 4 twice, with
   identical tokens and last logits; the MoE layers of one decode batch
   are held against a per-token float32 loop (``moe_loop``, within
   ``MOE_LOOP_TOL``); a 4 x 256-token prefill is timed; jamba's prefill
   with ``capacity_factor`` E / K must equal decoding the same prompts
   in float32, with its weights drawn again in float32 (greedy tokens,
   logits within ``PREFILL_BF16_TOL``); in bfloat16 the same comparison
   is printed with the tokens each MoE layer routed elsewhere. Tokens/s, ms
   per decode step beside the floor of reading every expert's weights,
   prefill ms and peak memory are printed. (b) ``ep_image_config()``'s
   jamba image (one period at d_model 1024, 1.590 GB float32) is
   published (SHA and AES kernels) and cold-started through a second
   service (fused kernel), whose 8 requests must get the tokens of the
   same weights loaded directly; then ``expert_shard_restore`` for each
   of 4 EP ranks, each through a fresh service with an empty L1: every
   array must equal its slice of the published tree byte for byte (the
   router, ``A_log``, ``conv_w`` and ``dt_proj`` whole), the ranks'
   expert slices must make up the stacks, and each rank must make one
   origin GET per distinct non-zero chunk it needs, fewer bytes than
   the cold start. (c) ``python -m repro_torch.launch.serve --arch
   jamba-v0.1-52b --publish`` (reduced) in process serves all 8
   requests.
9. a crash and resume. (a) SmolLM-360M at full width, cut to
   ``TRAIN_LAYERS`` (8) of its 32 layers (weights drawn on the card from
   ``--seed``), trains under the ``baseline`` variant
   (float32 master weights and Adam moments, bfloat16 compute, full
   remat), ``LoopConfig(batch=8, seq=512, ckpt_every=4)``, with a
   ``CheckpointManager`` whose ``ImageService`` (``torch-fused``) sits
   on a fresh store and ``GenerationalGC``. Trainer A runs on from
   step 0 in one ``run``: step 4 snapshots the state and starts the
   checkpoint's upload on the manager's thread (SHA-256 and AES
   kernels), steps 5-6 train while that upload is in flight (checked;
   their step ms are printed beside steps 2-4's), and the
   ``failure_hook`` then raises ``WorkerFailure``. The upload lands
   (the simulated crash spares it) and every tensor of the step-4
   snapshot is hashed on the upload thread after its publish. Trainer B, through a
   new service on the same store (empty L1), resumes (fused kernel): it
   must come back at step 4 with every tensor byte-identical to A's
   snapshot, and its steps 5-6 must give A's losses within
   ``TRAIN_LOSS_TOL`` (whether they are bitwise equal is printed). B
   trains on to the step-8 checkpoint; the run's records are
   rediscovered from the store, ``retire_before(keep_last=1)`` must
   return exactly the chunks only the step-4 image held and the sweep
   must reclaim them all. ``ElasticCoordinator(1, 4)`` kills ``w-0-2``
   and plans its recovery over the step-8 image with dim 0 of every
   tensor split four ways, through a fresh service (empty L1, origin
   GETs counted): at most ``RECOVERY_MAX_FRACTION`` of the chunks, one
   origin GET per distinct non-zero chunk of the plan; the shard is
   then restored (fused kernel) and must equal the slices of B's
   step-8 state. Step ms, tokens/s, publish s, the snapshot's host-copy
   s, resume s and recovery s are printed. (b)
   ``repro_torch.launch.train.main(["--arch", "smollm-360m",
   "--reduced", "--steps", "4", "--ckpt-every", "2", "--variant",
   "opt8bit", "--store", ...])``, then the same with ``--resume``,
   which must start at step 4; both must print the reference's lines.
10. the xLSTM, encoder-decoder and VLM families. (a) xlstm-350m at
   published width cut to ``XLSTM_LAYERS`` (12) of its 24 layers (6
   mLSTM/sLSTM pairs, d_model 1024, 4 heads, vocab 50304 padded to
   50432, untied; ~265.5 M parameters) from ``init_flat`` on the host (``--seed``): its
   float32 tree is published through an ``ImageService`` (SHA-256 and
   AES kernels) and cold-started through a second service with an
   empty L1 (fused kernel); every tensor must be byte-identical to the
   published tree (per-tensor SHA-256), and a bfloat16 ``ServeEngine``
   serves 8 requests of 8-token prompts and 16 new tokens at batch 4
   with the tokens of the same weights loaded directly. Then a prefill
   of 4 x 256 tokens in float32 against decoding the same prompts:
   greedy tokens equal, last logits and the final C/n/m/h/c/conv states
   within ``PREFILL_BF16_TOL`` of their max. (b) whisper-base at
   published width and full depth (6 + 6 layers, d_model 512, 8 heads,
   biases, layernorm, sinusoidal positions, vocab 51865 padded to
   51968; ~97.3 M parameters), published and cold-started as in (a),
   its engine serving 8 requests against the zero cross k/v, as the
   reference's does; then ``EncDecModel.prefill`` over 4 x 1500 frames
   (``encoder_seq``, drawn by ``global_batch`` at 0.1 scale) and 16
   greedy ``decode_step``s against the built cross k/v; then, in
   float32, a train-mode loss of 448 decoder tokens against the 1500
   frames with the card route of ``flash_attn`` held against its plain
   version at every call (``FLASH_F32_TOL``): the encoder's non-causal
   1500 x 1500, the decoder's causal 448 x 448 and the cross 448 x
   1500. (c) pixtral-12b at published width and all 40 layers (d_model
   5120, 32/8 heads of 128, d_ff 14336, vocab 131072; ~12.25 B
   parameters, 24.5 GB bfloat16 drawn on the card from ``--seed`` with
   ``init_device``, no image): a prefill of 4 x (256 patches + 256
   tokens) and 16 greedy decode steps, twice, with identical bits; in
   float32, cut to 4 layers, that prefill against a prefill of patches
   + 248 tokens and 8 decode steps (greedy tokens equal, logits within
   ``PREFILL_BF16_TOL``). (d) ``repro_torch.launch.train.main(["--arch",
   A, "--reduced", "--steps", "2", "--ckpt-every", "2", "--store",
   ...])`` and its ``--resume`` (which must start at step 2) for each
   of the three archs, and ``repro_torch.launch.serve.main(["--arch",
   "whisper-base", "--publish"])``, which must serve every request.
   Every time printed in phase 10 carries the card's name and power
   limit.
11. sharding on ``torch.distributed``. (a) A world-1 NCCL process group
   and a (1, 1) ``DeviceMesh``: under ``use_policy(mesh,
   ShardingPolicy())`` phase 9's SmolLM-360M (full width, 8 layers)
   trains 3 steps at phase 9's 8 x 512 tokens (baseline variant, ``--seed``) with its params and
   Adam state as DTensors placed by ``param_specs()`` and
   ``opt_state_specs``; the losses must equal phase 9's first three
   within ``TRAIN_LOSS_TOL`` relative, and the step ms is printed beside
   phase 9's. The same cell under ``opt8bit`` (int8 Adam moments) trains
   3 steps unsharded and 3 as DTensors on that mesh (the optimizer's
   block-row route): the losses and every moment's ``q`` and ``scale``
   must be equal bit for bit; both step ms are printed. (b) The
   roofline of its first step counted on the card
   (``launch.roofline.count_step``) must equal a fake-tensor trace of
   the same cell (``launch.dryrun.build_step``) exactly: FLOPs, unfused
   bytes and collective bytes (0); ``model_flops`` must be
   1.933136363520e12. ``step_time_s``, the measured step, model_flops /
   (measured x H100 peak) and ``max_memory_allocated`` beside the
   trace's ``per_device_total`` are printed. (c) Started before phase
   10 in their own low-priority processes: ``python -m
   repro_torch.launch.sweep --arch smollm-360m --single-pod-only`` (3
   cells) and ``python -m repro_torch.launch.dryrun --arch
   kimi-k2-1t-a32b --shape train_4k`` with ``baseline``, ``moe_a2a``
   and ``zero3_tuned8``, all on the fake 16 x 16 process group; every
   record must exist with 256 chips and the closed-form ``model_flops``,
   ``moe_a2a``'s must exchange all-to-all bytes (its collective bytes
   printed beside baseline's, kind by kind), and ``zero3_tuned8``'s
   ``moment_bytes`` must equal 2 R (256 + 4) / 256 summed over kimi-k2's
   leaves (R a leaf's 256-value blocks padded to 512 rows; 256 fsdp
   ranks), its ``per_device_total`` printed beside baseline's. Each
   record's terms are printed as a roofline projection at H100 SXM5
   data-sheet peaks, never as a card time.

12. the port's four examples, each through its ``main(argv)`` in
   process (``repro_torch.examples``), at the sizes they run by default.
   (a) ``quickstart`` on SmolLM-360M at full width (weights from
   ``--seed``): the restores of the fine-tuned tensor (before and after
   the GC roll) and the half shard of ``embed`` must be byte-identical to
   the source tree, the chunks touched must equal the chunks the half
   of ``embed`` spans in the layout, the fine-tune must store exactly
   its chunks the base lacks and the roll migrate exactly the two
   images' distinct chunks (hashlib counts). (b) ``serve_finetunes``
   with ``--dtype float32``: ten fine-tunes, each of one tensor, cold
   started through one shared service (a 1.61 GB L1, a 6-node L2 whose
   ``cache-000`` fails before the fourth start); as each replica serves,
   its weights must be bit-equal to its fine-tune (on the card) and
   its tokens those of the fine-tune loaded directly
   (``_serve_direct``), and it must make one origin GET for each of its
   chunks no earlier image held, so the fleet's origin GETs equal the
   distinct chunks across the ten images (hashlib). (c)
   ``coldstart_drill`` (24 functions on 3 bases, 512 KiB chunks, four
   300-invocation phases): no start rejected, post-recovery's origin
   fraction no higher than the cold restart's and within 1.5x steady's
   plus 0.01. (d) ``train_lm`` (the ~100M config, EXAMPLE_TRAIN_STEPS
   steps, checkpoints every 50, a crash half way): the resumed trainer
   must start at the last checkpoint and its first loss equal, bitwise,
   that of an uninterrupted trainer run to that step, and every loss
   must stay within ``LOSS_CHANCE_TOL`` of ln(vocab): the synthetic
   labels follow the inputs only at position 0 (in the JAX package too),
   so the JAX example's LEARNING verdict is printed, not required. Every
   time printed carries the card's name and power limit.

The last lines are the launch counts of phases 3 to 12, the kernel
table (``{"kernels": [...]}``, each kernel's launches counted on the path
that runs it, and on every path in ``launches_by_phase``), the
``nvidia-smi`` name/power-limit line and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import math
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# The card's peaks (NVIDIA H100 SXM data sheet, dense, 700 W): HBM
# 3.35 TB/s; 32-bit integer ALU rate 16.7 Tops/s, i.e. 132 SMs x 64
# INT32 lanes x 1.98 GHz (half the lanes of the 67 TFLOP/s float32 peak,
# which counts an FMA as two).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# Shared memory serves one wavefront a cycle per SM (132 SMs at the
# 1.98 GHz boost clock); a warp's read whose 32 lanes hit 32 different
# banks is one wavefront, so a table read costs at least 1/32 of one.
SMEM_WAVEFRONTS_PER_S = 132 * 1.98e9
# Operations are counted as the fewest 32-bit instructions that
# crypto_common.cuh's bodies need at the INT32 rate: a 3-input logic op
# is one LOP3, a 3-input add one IADD3, a rotate one SHF, a byte extract
# or byte swap one PRMT; address arithmetic is not counted. A table read
# is an LDS on the shared-memory pipe, which issues beside the INT32
# pipe, so table reads are a term of their own: wavefronts at the rate
# above. Each count is a floor, so each bound is a least time.
# SHA-256 per 64-byte block: 16 byte swaps; schedule 48 x 10 (per sigma
# 2 SHF + 1 shift + 1 LOP3; 2 adds); rounds 64 x 14 (per Sigma 3 SHF +
# 1 LOP3; ch and maj 1 LOP3 each; t1 2 IADD3; a and e 1 add each);
# final 8 adds.
SHA_OPS_PER_BLOCK = 16 + 48 * 10 + 64 * 14 + 8
# The chain: a message's SHA-256 blocks are dependent, each 64 rounds of
# those 14 instructions, which one thread must issue in order, at most
# one a cycle at the 1.98 GHz boost clock. So a launch lasts at least its
# longest message's blocks x 64 x 14 cycles, however many messages run
# beside it (the operation bound spreads them over all 132 x 64 lanes,
# which 256 chains cannot fill). In practice a warp instruction holds a
# sub-partition's 16-lane INT32 pipe for 2 cycles, so about twice the
# chain term is the floor of rounds issued on that pipe alone.
SHA_CHAIN_INSNS_PER_ROUND = 14
CHAIN_ISSUE_PER_S = 1.98e9
# AES-256 per 16-byte block (T-table): initial key xor 4; 13 middle
# rounds x 24 (per column 4 byte extracts, 2 LOP3 for the five-way xor);
# final round 32 (per column 4 extracts, 3 PRMT to assemble the word, 1
# key xor). Table reads: 16 a round, 14 rounds (the last reads S-box
# bytes).
AES_OPS_PER_BLOCK = 4 + 13 * 24 + 32
AES_READS_PER_BLOCK = 14 * 16
# Erasure kernels per 32-bit word (four bytes) of an output row that sums
# m terms: the XOR of m words is ceil((m - 1) / 2) LOP3s (three inputs
# each); a term whose coefficient is neither 0 nor 1 also costs 7 ops (4
# byte extracts, 3 PRMT to reassemble the word) and 4 product-table
# reads. Parity is one row of k ones. The 4-of-5 code's reconstruction
# matrices hold only 0 and 1, so on the L2 path both kernels are XOR
# only.
GF_GENERAL_TERM_OPS = 7
GF_GENERAL_TERM_READS = 4
# queued_ms: a spin of 2e8 cycles lasts ~100 ms at the H100's 1.98 GHz
# boost clock (longer at lower clocks); the runs must be enqueued in less
SPIN_CYCLES = 200_000_000
QUEUED_SPIN_MS = 50.0
KIB512 = 512 << 10
# phases 3-6 pin the kernel backends' registered decode tile
# (core.decode.KERNEL_TILE_BYTES), so their numbers stay comparable
# with runs from before "auto" autotuned; phase 7 leaves it at "auto"
TILE = 128 << 20
# phases 4-6 run on phase 3's SmolLM-360M tree cut to its first CUT_LAYERS
# of 32 layers (full width; a 0.503 GB image of ~960 chunks in place of
# 1.449 GB and 2763), published into phase 3's store under its key, so
# that the whole script, phase 12 included, stays well inside its time
# limit; phase 3 keeps all 32 layers
CUT_LAYERS = 8
# phase 3: the engine's max_len for a prompt of max_len + 2 tokens
# beside a 2-token one (ROADMAP.md §3, fault 1)
PAST_MAX_LEN = 8
# phase 4b: reads of every distinct chunk through the healthy L2, each
# way (4-of-5 and 4-of-4); then once each way with a node down. One
# healthy pass, not two: the host's LRU-K eviction, which runs on every
# stripe a read promotes from flash into a full memory tier, makes each
# pair of reads cost ~8 ms (scripts/profile_l2_host.py's cost), and two
# passes would take this phase past a minute
FIG9_PASSES = 1
# phase 7: prefill at SmolLM-360M's full width (bfloat16) against prefill
# by decoding: greedy tokens equal and the last-position logits within
# PREFILL_BF16_TOL x max |logit|. The two round different bfloat16 sums
# through 32 layers (batched matmuls against one-row ones), so the
# tolerance is wider than the 2e-2 that tests/test_torch_model.py holds
# two frameworks to at 2 layers; the first H100 run measured 1.7%
# (0.0508 of 2.98). starcoder2-15b at full width, depth cut to
# STARCODER_LAYERS of 40, one prompt past its 4096-token window, float32,
# the card route of flash_attn within FLASH_F32_TOL of its plain version
PREFILL_PROMPTS = 4
PREFILL_LEN = 256
PREFILL_BF16_TOL = 3e-2
STARCODER_LAYERS = 2
STARCODER_PROMPT = 4608
FLASH_F32_TOL = 1e-4
# phase 8a: the MoE and hybrid families at their published widths,
# depth cut to (arch, layers kept) so that the bfloat16 weights (drawn on
# the card) fit one card one model at a time; ServeEngine answers
# FAMILY_REQUESTS requests of 8-token prompts (rng_prompt) and FAMILY_NEW
# new tokens at batch FAMILY_BATCH, twice (the bits must repeat); one
# decode batch's MoE layer is held against a per-token float32 loop
# within MOE_LOOP_TOL x max |y|; jamba's prefill of PREFILL_PROMPTS x
# PREFILL_LEN tokens against decoding them, with capacity_factor E / K
# (no assignment dropped), in float32, within PREFILL_BF16_TOL (in
# bfloat16 rounding moves some tokens' top-k experts: printed only)
FAMILY_MODELS = (("arctic-480b", 1), ("kimi-k2-1t-a32b", 2),
                 ("jamba-v0.1-52b", 8))
FAMILY_REQUESTS = 8
FAMILY_NEW = 8
FAMILY_BATCH = 4
MOE_LOOP_TOL = 2e-2
# phase 8b: expert-parallel restores of a jamba image by EP_SIZE ranks
EP_SIZE = 4
# phase 9: SmolLM-360M at full width, cut to TRAIN_LAYERS of its 32
# layers (so that phase 12 fits: a 1.51 GB checkpoint in place of
# 4.35 GB), trains under the launcher's
# "baseline" variant (float32 master weights and moments, bfloat16
# compute, full remat), TRAIN_BATCH x TRAIN_SEQ tokens a step, a
# checkpoint every TRAIN_CKPT_EVERY steps; trainer A crashes before step
# TRAIN_CRASH_AT + 1, B resumes from the step-4 checkpoint and must
# repeat A's losses within TRAIN_LOSS_TOL relative (the float32 SDPA
# backward need not repeat its bits), then trains on to the step-8
# checkpoint. Elastic recovery of w-0-2 of a (1, RECOVERY_MP) grid, dim
# 0 of every tensor split RECOVERY_MP ways, may fetch at most
# RECOVERY_MAX_FRACTION of the step-8 image's chunks
TRAIN_LAYERS = 8
TRAIN_BATCH = 8
TRAIN_SEQ = 512
TRAIN_CKPT_EVERY = 4
TRAIN_CRASH_AT = 6
TRAIN_LOSS_TOL = 1e-4
RECOVERY_MP = 4
RECOVERY_MAX_FRACTION = 0.30
RECOVERY_L1_BYTES = 2 << 30             # holds the shard: restored from L1
STRIPE = KIB512 // 4                    # a 512 KiB chunk's 4-of-5 stripe
ODD_LENGTHS = (0, 1, 55, 56, 63, 64, 65, 4096, KIB512)
STRIPE_LENGTHS = (0, 1, 3, 5, 15, 16, 17, STRIPE)
KEY_DERIVATION = 16 + KIB512            # salt || chunk, hashed on publish
# one group mixing every padding case with chains of 8193 blocks
MIXED_GROUP = (0, 1, 55, 64, 65, KIB512, KEY_DERIVATION)
ENGINE_BATCHES = (1, 31, 33, 257)       # not multiples of either kernel's G
UNALIGNED = (0, 1, 55, 56, 63, 64, 65, 127, 128, 129, 300, 5000, 17, 31,
             48, 65536, KEY_DERIVATION)
# the AES kernel's risky inputs: run lengths that make warps and tiles
# straddle chunks, block counts off the warp size, and the two FIPS-197
# example vectors (Appendix C.1, AES-128, and C.3, AES-256): key bytes
# 00 01 02 ..., plaintext 00 11 22 ... ff
AES_BOUNDARY_COUNTS = (1, 31, 33, 40, 32768)
AES_BATCHES = (1, 31, 33, 257)
FIPS197_PLAIN = bytes.fromhex("00112233445566778899aabbccddeeff")
FIPS197 = {16: "69c4e0d86a7b0430d8cdb78070b4c55a",
           32: "8ea2b7ca516745bfeafc49904b496089"}
# parity's risky inputs: k off the L2's 4 (1 and 9 take the runtime-k
# loop), a stripe one byte past the L2's, data off the 16-byte grid
PARITY_KS = (1, 2, 3, 5, 8, 9)
PARITY_LENGTHS = STRIPE_LENGTHS + (STRIPE + 1,)
PARITY_OFFSETS = (1, 4, 8)
# kernel -> (source, TPU kernel it replaces, phase whose run counts it)
TPU_KERNELS = {
    "fused_verify_decrypt": ("src/repro_torch/csrc/fused.cu",
                             "src/repro/kernels/fused/fusedp.py:107", 3),
    "sha256_many": ("src/repro_torch/csrc/sha256.cu",
                    "src/repro/kernels/sha256/sha256p.py:91", 3),
    "aes_encrypt_many": ("src/repro_torch/csrc/aes.cu",
                         "src/repro/kernels/aes/bitslice_pallas.py:55", 3),
    "gf256": ("src/repro_torch/csrc/gf256.cu",
              "src/repro/kernels/gf256/gf256.py:70", 4),
    "parity": ("src/repro_torch/csrc/parity.cu",
               "src/repro/kernels/parity/parity.py:28", 4),
}
PATH_KERNELS = {3: ("fused_verify_decrypt", "sha256_many",
                    "aes_encrypt_many"),
                4: ("parity", "gf256", "fused_verify_decrypt"),
                5: ("fused_verify_decrypt",),
                6: ("sha256_many", "aes_encrypt_many",
                    "fused_verify_decrypt"),
                7: ("fused_verify_decrypt", "sha256_many",
                    "aes_encrypt_many"),
                8: ("fused_verify_decrypt", "sha256_many",
                    "aes_encrypt_many"),
                9: ("sha256_many", "aes_encrypt_many",
                    "fused_verify_decrypt"),
                10: ("sha256_many", "aes_encrypt_many",
                     "fused_verify_decrypt"),
                12: ("sha256_many", "aes_encrypt_many",
                     "fused_verify_decrypt", "parity")}
# phase 10: the xLSTM, encoder-decoder and VLM families. xlstm-350m and
# whisper-base serve FAMILY_REQUESTS requests of PHASE10_NEW new tokens
# at batch FAMILY_BATCH; whisper-base decodes PHASE10_NEW greedy steps
# after its prefill, and its float32 loss runs over WHISPER_TARGET
# decoder tokens (Whisper's target length) against encoder_seq frames;
# pixtral-12b prefills PREFILL_PROMPTS x (256 patches + PIXTRAL_TEXT
# tokens), and its float32 check keeps PIXTRAL_F32_LAYERS of 40 layers
PHASE10_NEW = 16
# xlstm-350m cut to XLSTM_LAYERS of its 24 layers (6 mLSTM/sLSTM pairs,
# a 1.062 GB image in place of 1.711 GB) so that the script stays well
# inside its time limit
XLSTM_LAYERS = 12
WHISPER_TARGET = 448
PIXTRAL_TEXT = 256
PIXTRAL_F32_LAYERS = 4
PHASE10_ARCHS = ("xlstm-350m", "whisper-base", "pixtral-12b")
# phase 5: the storm's workers (worker STORM_WORKERS idles until the
# poisoned-copy restore). Every worker asks for the image's chunks in
# the same order, so the first to probe leads nearly every flight (on
# an H100 one worker led all 2762 of a 32-layer image's). The peer that
# crashes is therefore the first worker to have served
# CRASH_AFTER_TRANSFERS transfers while leading at most 1% of the
# flights: a tree or holder peer, not the leader, whose crash would
# orphan every later flight. The binary tree (fanout 2) makes a
# non-leading joiner the parent of the third joiner, so such a peer
# serves in every ordering of the race (with fanout 4 and three joiners
# only the leader serves the tree).
STORM_WORKERS = 4
STORM_FANOUT = 2
CRASH_AFTER_TRANSFERS = 100
CRASH_MAX_LED_SHARE = 0.01
ORIGIN_ERROR_P = 0.02
STORM_TIMEOUT_S = 300
PEER_COUNTERS = ("peer.transfers", "peer.direct_hits", "peer.tree_hits",
                 "peer.joins", "peer.misses", "peer.promotions",
                 "peer.dead_peer_fallthroughs", "peer.deadline_fallthroughs",
                 "peer.registered_chunks", "read.peer_hits",
                 "read.peer_fallthroughs", "peer.tree_repairs",
                 "peer.abandoned_leases")
# phase 6: B is A with these rows (the last two of CUT_LAYERS layers) of
# every g0/s0/* tensor redrawn; the reader's gate holds its GETs from this
# one on (about a third of B's chunks)
FINE_TUNED_ROWS = slice(CUT_LAYERS - 2, CUT_LAYERS)
GATE_AT_GET = 350
GATE_TIMEOUT_S = 300
RESILIENCE_COUNTERS = ("retry.attempts", "retry.retries", "retry.backoff_s",
                       "retry.giveups", "retry.budget_exhausted",
                       "retry.integrity_refetches", "breaker.opened",
                       "breaker.half_opens", "breaker.probes",
                       "breaker.closed", "breaker.shed",
                       "faults.origin_transient")


# phase 11: sharding on torch.distributed. (a) SmolLM-360M at full width
# trains SHARD_STEPS steps of phase 9's TRAIN_BATCH x TRAIN_SEQ tokens
# (the baseline variant, same seed) with its state as DTensors on a
# world-1 NCCL (1, 1) mesh; its losses must equal phase 9's first steps
# within TRAIN_LOSS_TOL relative. (b) The roofline of its first step
# counted on the card must equal a fake-tensor trace of the same cell
# exactly, and model_flops must be SMOLLM_TRAIN_FLOPS (6 x 78,659,520
# active parameters x 4096 tokens). (c) Dry runs on the fake 16 x 16
# process group, each in its own process, started before phase 10 at
# low priority (they need the CPU only): the SmolLM sweep's three cells
# and kimi-k2 x train_4k under each of KIMI_VARIANTS, every record of
# DRYRUN_CHIPS ranks; moe_a2a must exchange all-to-all bytes, and
# zero3_tuned8 must hold its int8 moments at int8_moment_bytes' count.
# (a) repeats under INT8_VARIANT, unsharded and as DTensors, bitwise.
SHARD_STEPS = 3
SMOLLM_TRAIN_FLOPS = 1.933136363520e12
INT8_VARIANT = "opt8bit"
KIMI_VARIANTS = ("baseline", "moe_a2a", "zero3_tuned8")
DRYRUN_CHIPS = 256
DRYRUN_TIMEOUT_S = 420
DRYRUN_NICE = 10


# phase 12: the port's four examples through their main(argv) at the
# sizes they run by default: quickstart and serve_finetunes on
# SmolLM-360M at full width (one draw of its weights from --seed),
# serve_finetunes' replicas in float32 so each restored tree can be
# hashed from the model, coldstart_drill at 24 functions x 300
# invocations a phase, train_lm's ~100M config for EXAMPLE_TRAIN_STEPS
# steps (the fewest that checkpoint twice and crash after the first:
# its loss cannot fall in any number of steps, below). Post-recovery's
# origin fraction must be within DRILL_RECOVERY_FACTOR x steady's plus
# DRILL_RECOVERY_SLACK. The synthetic pipeline's labels follow the
# model's inputs only at position 0 (``data.synthetic.global_batch``
# plants ``31 t + U{0..6}`` from the tokens before they are replaced,
# as the JAX package's does), so every train_lm loss must stay within
# LOSS_CHANCE_TOL of ln(vocab), and the JAX example's LEARNING verdict
# (last loss below the first logged by 0.2) is printed, not required.
EXAMPLE_TRAIN_STEPS = 100
DRILL_RECOVERY_FACTOR = 1.5
DRILL_RECOVERY_SLACK = 0.01
LOSS_CHANCE_TOL = 0.3


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*a):
    print(*a, flush=True)


def sh(cmd) -> str:
    try:
        return subprocess.run(cmd, capture_output=True, text=True,
                              timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unavailable ({e})"


def sha_blocks(lengths) -> int:
    return sum((int(n) + 72) // 64 for n in lengths)


def bound(nbytes: float, ops: float, chain_blocks: int = 0,
          reads: float = 0) -> tuple:
    """(least ms, what sets it): the larger of the bytes over the HBM
    rate, the operations over the INT32 rate, the table `reads` as
    shared-memory wavefronts and, for SHA-256, the longest message's
    chain of `chain_blocks` blocks (see above)."""
    terms = {"bytes": nbytes / HBM_BYTES_PER_S,
             "operations": ops / INT32_OPS_PER_S,
             "shared memory": reads / 32 / SMEM_WAVEFRONTS_PER_S,
             "chain": chain_blocks * 64 * SHA_CHAIN_INSNS_PER_ROUND
             / CHAIN_ISSUE_PER_S}
    by = max(terms, key=terms.get)
    return terms[by] * 1e3, by


def cuda_ms(fn, reps: int) -> float:
    """Mean ms of `fn` over `reps` runs, CUDA events, after one warmup."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def queued_ms(fn, reps: int) -> float:
    """Mean device ms of `fn` over `reps` runs queued behind a spin on
    the card, so that the card runs them back to back: the kernel's own
    time, without the host's per-call cost (Python, ctypes, allocation),
    which dominates a launch of a few microseconds. Fails if the host
    took longer to enqueue the runs than the spin lasted."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    check(enqueue_ms < QUEUED_SPIN_MS, f"enqueueing {reps} runs took "
          f"{enqueue_ms:.1f} ms, longer than the spin")
    return start.elapsed_time(end) / reps


def wall_ms(fn) -> tuple:
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def gf_work(matrix, width: int) -> tuple:
    """(fewest 32-bit operations, table reads) of `matrix` x (k, `width`)
    bytes (see GF_GENERAL_TERM_OPS)."""
    words = (width + 3) // 4
    ops = reads = 0
    for row in matrix:
        terms = [int(c) for c in row if c]
        general = sum(c != 1 for c in terms)
        ops += words * (max(0, -(-(len(terms) - 1) // 2))
                        + GF_GENERAL_TERM_OPS * general)
        reads += words * GF_GENERAL_TERM_READS * general
    return ops, reads


def max_abs_err(a, b) -> int:
    return int((a.to(b.device).long() - b.long()).abs().max()) \
        if a.numel() else 0


# ------------------------------------------------------------- phase 1

def phase_toolchain(kernels) -> str:
    smi = sh(["nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader"]).splitlines()
    smi_line = smi[0] if smi else "unavailable"
    import torch
    log("card:", smi_line)
    log("nvcc:", sh([kernels._nvcc(), "--version"]).splitlines()[-1])
    log("torch", torch.__version__, "cuda", torch.version.cuda,
        "device", torch.cuda.get_device_name(0))
    try:
        import triton
        log("triton", triton.__version__)
    except ImportError:
        log("triton: not importable")
    t0 = time.perf_counter()
    info = kernels.build_all()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s")
    for name, rec in info.items():
        regs = [ln.strip() for ln in rec["ptxas"].splitlines()
                if "registers" in ln or "smem" in ln]
        log(f"  {name}: {rec['lib']} ({rec['seconds']:.2f} s) {regs}")
    return smi_line


# ------------------------------------------------------------- phase 2

def phase_kernels(rng, tile_chunks: int, tile_len: int) -> dict:
    import numpy as np
    import torch

    from repro_torch.core.crypto import aes, convergent
    from repro_torch.kernels.aes import ops as aops
    from repro_torch.kernels.fused import ops as fops
    from repro_torch.kernels.sha256 import ops as sops

    dev = torch.device("cuda")
    rows = {}

    def rand(n):
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    odd = [rand(n) for n in ODD_LENGTHS]
    odd_keys = [rand(32) for _ in odd]
    small = [i for i, n in enumerate(ODD_LENGTHS) if n <= 4096]
    tile = [rand(tile_len) for _ in range(tile_chunks)]
    tile_keys = [rand(32) for _ in tile]

    # ---------------- SHA-256
    got = sops.sha256_many(odd, device=dev)
    check(got == [hashlib.sha256(m).digest() for m in odd],
          "sha256 kernel != hashlib on the odd lengths")
    sm = sops.to_device(*sops.pack_messages([odd[i] for i in small]), dev)
    check(torch.equal(sops.sha256_lanes(*sm).cpu(),
                      sops.sha256_lanes_plain(*sm).cpu()),
          "sha256 kernel != plain on the odd lengths")
    tb = sops.to_device(*sops.pack_messages(tile), dev)
    kd = sops.sha256_lanes(*tb)
    ref = np.frombuffer(b"".join(hashlib.sha256(m).digest() for m in tile),
                        np.uint8).reshape(-1, 32)
    check(np.array_equal(kd.cpu().numpy(), ref), "sha256 kernel != hashlib "
          "on the tile")
    ms = cuda_ms(lambda: sops.sha256_lanes(*tb), 3)
    pd, plain_ms = wall_ms(lambda: sops.sha256_lanes_plain(*tb))
    err = max_abs_err(kd, pd)
    check(err == 0, "sha256 kernel != plain on the tile")
    nbytes = tile_chunks * tile_len
    rows["sha256_many"] = dict(
        ms=ms, plain_ms=plain_ms, max_abs_err=err,
        bound=bound(nbytes + 48 * tile_chunks,
                    sha_blocks([tile_len] * tile_chunks) * SHA_OPS_PER_BLOCK,
                    sha_blocks([tile_len])))
    log(f"sha256: kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, "
        f"{nbytes / ms / 1e6:.3f} GB/s at {tile_chunks} x {tile_len} B")

    # ---------------- AES (the publish path's CTR counter blocks)
    def hook(blocks, rks, counts=None):
        return aops.encrypt_many(blocks, rks, counts=counts, device=dev)
    hook.per_chunk_rks = True
    lens = [len(m) for m in odd]
    ks = aes.ctr_keystream_many(odd_keys, lens, encrypt_many=hook)
    ks_ref = aes.ctr_keystream_many(odd_keys, lens)
    check(all(np.array_equal(a, b) for a, b in zip(ks, ks_ref)),
          "aes kernel != numpy T-table keystreams on the odd lengths")
    check((np.frombuffer(odd[-1], np.uint8) ^ ks[-1]).tobytes()
          == aes.ctr_encrypt(odd[-1], odd_keys[-1]),
          "aes kernel CTR != ctr_encrypt at 512 KiB")
    nb = tile_len // 16
    ctr = np.zeros((tile_chunks * nb, 16), np.uint8)
    ctr[:, 8:] = np.tile(np.arange(nb, dtype=">u8"), tile_chunks) \
        .view(np.uint8).reshape(-1, 8)
    rks_np = aes.expand_keys_many(tile_keys)
    blocks = torch.from_numpy(ctr).to(dev)
    rks = torch.from_numpy(rks_np.view(np.int32)).to(dev)
    idx = torch.from_numpy(np.repeat(np.arange(tile_chunks, dtype=np.int32),
                                     nb)).to(dev)
    ka = aops.aes_encrypt_blocks(blocks, rks, idx)
    sample = rng.choice(ctr.shape[0], min(4096, ctr.shape[0]),
                        replace=False)
    check(np.array_equal(ka.cpu().numpy()[sample], aes.encrypt_blocks(
        ctr[sample], rks_np[idx.cpu().numpy()[sample]])),
        "aes kernel != encrypt_blocks on a tile sample")
    ms = cuda_ms(lambda: aops.aes_encrypt_blocks(blocks, rks, idx), 5)
    pa, plain_ms = wall_ms(
        lambda: aops.aes_encrypt_blocks_plain(blocks, rks, idx))
    err = max_abs_err(ka, pa)
    check(err == 0, "aes kernel != plain on the tile")
    n = ctr.shape[0]
    rows["aes_encrypt_many"] = dict(
        ms=ms, plain_ms=plain_ms, max_abs_err=err,
        bound=bound(36 * n + rks_np.nbytes, n * AES_OPS_PER_BLOCK,
                    reads=n * AES_READS_PER_BLOCK))
    log(f"aes: kernel {ms:.4f} ms, plain {plain_ms:.1f} ms, "
        f"{16 * n / ms / 1e6:.3f} GB/s at {n} blocks; geometry "
        f"{aops.geometry(n)}")
    del blocks, idx, ka, pa

    # ---------------- fused verify+decrypt
    dig, pts = fops.fused_verify_decrypt(odd, odd_keys, device=dev)
    check(dig == [hashlib.sha256(m).digest() for m in odd],
          "fused digests != hashlib on the odd lengths")
    check(pts == [aes.ctr_decrypt(m, k) for m, k in zip(odd, odd_keys)],
          "fused plaintexts != ctr_decrypt on the odd lengths")
    sm = sops.to_device(*sops.pack_messages([odd[i] for i in small]), dev)
    srk = torch.from_numpy(fops.round_keys([odd_keys[i] for i in small])
                           .view(np.int32)).to(dev)
    kp, kdg = fops.fused_verify_decrypt_lanes(*sm, srk)
    pp, pdg = fops.fused_lanes_plain(*sm, srk)
    check(torch.equal(kdg, pdg), "fused digests != plain on odd lengths")
    for o, ln in zip(sm[1].tolist(), sm[2].tolist()):
        check(torch.equal(kp[o:o + ln], pp[o:o + ln]),
              "fused plaintext != plain on the odd lengths")
    trk = torch.from_numpy(fops.round_keys(tile_keys).view(np.int32)).to(dev)
    kp, kdg = fops.fused_verify_decrypt_lanes(*tb, trk)
    check(np.array_equal(kdg.cpu().numpy(), ref),
          "fused digests != hashlib on the tile")
    kp_np = kp.cpu().numpy()
    offs = tb[1].cpu().numpy()
    for i in (0, tile_chunks // 2, tile_chunks - 1):
        check(kp_np[offs[i]:offs[i] + tile_len].tobytes()
              == aes.ctr_decrypt(tile[i], tile_keys[i]),
              f"fused plaintext != ctr_decrypt on tile chunk {i}")
    ms = cuda_ms(lambda: fops.fused_verify_decrypt_lanes(*tb, trk), 3)
    (pp, pdg), plain_ms = wall_ms(lambda: fops.fused_lanes_plain(*tb, trk))
    err = max(max_abs_err(kdg, pdg), max_abs_err(kp, pp))
    check(err == 0, "fused kernel != plain on the tile")
    ops = sha_blocks([tile_len] * tile_chunks) * SHA_OPS_PER_BLOCK \
        + tile_chunks * (tile_len // 16) * (AES_OPS_PER_BLOCK + 4)
    rows["fused_verify_decrypt"] = dict(
        ms=ms, plain_ms=plain_ms, max_abs_err=err,
        bound=bound(2 * nbytes + tile_chunks * (32 + 16 + 240), ops,
                    sha_blocks([tile_len]),
                    tile_chunks * (tile_len // 16) * AES_READS_PER_BLOCK))
    log(f"fused: kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, "
        f"{nbytes / ms / 1e6:.3f} GB/s at {tile_chunks} x {tile_len} B")
    del pp, pdg, kp

    # ---------------- tamper: IntegrityError names the chunk
    encs = [convergent.encrypt_chunk(m, b"smoke-salt-16by!") for m in tile[:8]]
    cts = [e.ciphertext for e in encs]
    bad = bytearray(cts[3])
    bad[len(bad) // 2] ^= 1
    cts[3] = bytes(bad)
    try:
        convergent.decrypt_chunks(
            cts, [e.key for e in encs], [e.sha256 for e in encs],
            fused=lambda c, k: fops.fused_verify_decrypt(c, k, device=dev))
    except convergent.IntegrityError as e:
        check(e.bad_positions == [3], f"tamper named {e.bad_positions}")
    else:
        raise SmokeFailure("a tampered chunk decrypted without error")
    log("tamper: IntegrityError names chunk 3")

    # ---------------- tile size: 1 MiB tiles (the JAX autotuner's top)
    # against the registered 128 MiB tile, same chunks, through the hook
    per = max(1, (1 << 20) // tile_len)

    def tiled(step):
        for i in range(0, tile_chunks, step):
            fops.fused_verify_decrypt(tile[i:i + step], tile_keys[i:i + step],
                                      device=dev)
    _, small_ms = wall_ms(lambda: tiled(per))
    _, big_ms = wall_ms(lambda: tiled(tile_chunks))
    rows["tile_effect"] = {"chunks": tile_chunks, "small_tile_ms": small_ms,
                           "small_tile_chunks": per, "big_tile_ms": big_ms}
    log(f"tile effect: {tile_chunks} chunks through the fused hook: "
        f"{per}-chunk tiles {small_ms:.1f} ms, one tile {big_ms:.1f} ms")
    return rows


def phase_engine_cases(rng) -> None:
    """The SHA-256 engine's risky inputs through both redesigned kernels,
    each held against its plain version (``sha256_lanes_plain``, and
    ``ctr_decrypt_plain`` for the fused plaintext) and hashlib/
    ``ctr_decrypt``: one group mixing lengths 0..524,304, batches of
    N = 1, 31, 33, 257, and starts 1..15 bytes off the 16-byte grid.
    Prints each kernel's launch geometry at the tile."""
    import numpy as np
    import torch

    from repro_torch.core.crypto import aes
    from repro_torch.kernels.fused import ops as fops
    from repro_torch.kernels.sha256 import ops as sops

    dev = torch.device("cuda")
    for name, mod in (("sha256", sops), ("fused", fops)):
        log(f"  {name} geometry at 256 chunks: {mod.geometry(256)}")

    def case(label, lengths, misalign=False):
        msgs = [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
                for n in lengths]
        keys = [rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
                for _ in msgs]
        if misalign:
            offs, end = [], 0
            for i, m in enumerate(msgs):
                offs.append((end + 15) // 16 * 16 + 1 + i % 15)
                end = offs[-1] + len(m)
            buf = rng.integers(0, 256, end + 7, dtype=np.uint8)
            for m, o in zip(msgs, offs):
                buf[o:o + len(m)] = np.frombuffer(m, np.uint8)
            packed = (buf, np.array(offs, np.int64),
                      np.array([len(m) for m in msgs], np.int64))
        else:
            packed = sops.pack_messages(msgs)
        t = sops.to_device(*packed, dev)
        rks = torch.from_numpy(fops.round_keys(keys).view(np.int32)).to(dev)
        want = np.frombuffer(b"".join(hashlib.sha256(m).digest()
                                      for m in msgs), np.uint8).reshape(-1, 32)
        plain_dig = sops.sha256_lanes_plain(*t)
        plain_pt = fops.ctr_decrypt_plain(*t, rks)
        check(np.array_equal(plain_dig.cpu().numpy(), want),
              f"sha256 plain != hashlib, {label}")
        dig = sops.sha256_lanes(*t)
        pt, fdig = fops.fused_verify_decrypt_lanes(*t, rks)
        check(torch.equal(dig, plain_dig) and torch.equal(fdig, plain_dig),
              f"sha256/fused digests != plain, {label}")
        check(np.array_equal(dig.cpu().numpy(), want),
              f"sha256 kernel != hashlib, {label}")
        ptn, ppn = pt.cpu().numpy(), plain_pt.cpu().numpy()
        for m, k, o in zip(msgs, keys, packed[1]):
            check(ptn[o:o + len(m)].tobytes() == aes.ctr_decrypt(m, k)
                  and np.array_equal(ptn[o:o + len(m)], ppn[o:o + len(m)]),
                  f"fused plaintext != ctr_decrypt/plain, {label}")
        log(f"engine case {label}: {len(msgs)} messages, kernels == plain "
            f"== hashlib/ctr_decrypt")

    case(f"one group of lengths {list(MIXED_GROUP)}", MIXED_GROUP)
    for n in ENGINE_BATCHES:
        case(f"N={n}", rng.integers(0, 5000, n))
    case("unaligned starts", UNALIGNED, misalign=True)


def phase_aes_cases(rng) -> None:
    """The AES kernel's risky inputs (AES_BOUNDARY_COUNTS, AES_BATCHES, the
    FIPS-197 vectors), AES-128 schedules, and one batch in which every
    lane of a warp meets every byte value in every state position, each
    against the plain version and ``aes.encrypt_blocks`` byte for byte."""
    import numpy as np
    import torch

    from repro_torch.core.crypto import aes
    from repro_torch.kernels.aes import ops as aops

    dev = torch.device("cuda")

    def case(label, blocks, keys, idx):
        rks = aes.expand_keys_many(keys)
        b = torch.from_numpy(blocks).to(dev)
        r = torch.from_numpy(rks.view(np.int32)).to(dev)
        i = torch.from_numpy(idx.astype(np.int32)).to(dev)
        got = aops.aes_encrypt_blocks(b, r, i)
        check(torch.equal(got, aops.aes_encrypt_blocks_plain(b, r, i)),
              f"aes kernel != plain, {label}")
        out = got.cpu().numpy()
        check(np.array_equal(out, aes.encrypt_blocks(blocks, rks[idx])),
              f"aes kernel != encrypt_blocks, {label}")
        log(f"aes case {label}: {len(blocks)} blocks, {len(keys)} "
            f"schedules, kernel == plain == encrypt_blocks")
        return out

    def keys(n, size=32):
        return [rng.integers(0, 256, size, dtype=np.uint8).tobytes()
                for _ in range(n)]

    def runs(counts):
        return np.repeat(np.arange(len(counts)), counts)

    def rand(n):
        return rng.integers(0, 256, (n, 16), dtype=np.uint8)

    c = AES_BOUNDARY_COUNTS
    case(f"counts {list(c)}", rand(sum(c)), keys(len(c)), runs(c))
    # the same through the host hook's run-length protocol
    rks = aes.expand_keys_many(keys(len(c)))
    blocks = rand(sum(c))
    got = aops.encrypt_many(blocks, rks, counts=np.array(c), device=dev)
    check(np.array_equal(got, aes.encrypt_blocks(blocks, rks[runs(c)])),
          "aes encrypt_many(counts=) != encrypt_blocks")
    for n in AES_BATCHES:
        case(f"N={n}, one schedule per block", rand(n), keys(n), np.arange(n))
        split = np.sort(rng.integers(0, n + 1, 2))
        cn = np.diff([0, *split, n])
        case(f"N={n}, runs {cn.tolist()}", rand(n), keys(3), runs(cn))
    case("AES-128 runs (7, 300, 2000)", rand(2307), keys(3, 16),
         runs((7, 300, 2000)))
    case("AES-128, one schedule per block", rand(257), keys(257, 16),
         np.arange(257))
    every = np.repeat(((np.arange(256 * 32) // 32) % 256)
                      .astype(np.uint8)[:, None], 16, axis=1)
    case("every byte value at every position and lane", every, keys(1),
         np.zeros(len(every), np.int64))
    for size, want in FIPS197.items():
        key = bytes(range(size))
        out = case(f"FIPS-197 AES-{8 * size}",
                   np.frombuffer(FIPS197_PLAIN, np.uint8)[None].copy(),
                   [key], np.zeros(1, np.int64))
        check(out.tobytes().hex() == want,
              f"aes kernel != FIPS-197 AES-{8 * size} vector")


def empty_launcher(kernels, n: int):
    """A function that launches ``csrc/parity.cu``'s empty kernel with the
    grid parity takes for aligned (k, `n`) stripes (counted nowhere)."""
    import ctypes

    import torch
    fn = kernels.library("parity").parity_empty_launch
    fn.argtypes = [ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch():
        err = fn(n, torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"empty kernel launch failed: CUDA error {err}")
    return launch


def phase_erasure_kernels(rng, kernels) -> dict:
    """Parity and GF(256) against their plain versions and numpy (parity
    also at PARITY_KS, PARITY_LENGTHS and PARITY_OFFSETS), then parity
    timed at one ``put_chunk``'s shape beside an empty kernel of the same
    grid. The GF(256) row is timed after phase 4 (``time_gf256``), at the
    shape phase 4 gave it."""
    import numpy as np
    import torch

    from repro_torch.core import erasure
    from repro_torch.kernels.gf256 import ops as gops
    from repro_torch.kernels.parity import ops as pops

    dev = torch.device("cuda")
    mats = {"encode_matrix(4, 6) parity rows": erasure.encode_matrix(4, 6)[4:],
            "random (8, 8)": rng.integers(0, 256, (8, 8), dtype=np.uint8),
            "all 256 coefficients (16, 16)":
                np.arange(256, dtype=np.uint8).reshape(16, 16)}
    err_p = err_g = 0
    for n in STRIPE_LENGTHS:
        d = rng.integers(0, 256, (4, n), dtype=np.uint8)
        t = torch.from_numpy(d).to(dev)
        kp = pops.parity(t)
        check(np.array_equal(kp.cpu().numpy(),
                             np.bitwise_xor.reduce(d, axis=0)),
              f"parity kernel != numpy XOR at stripe length {n}")
        err_p = max(err_p, max_abs_err(kp, pops.parity_plain(t)))
        for label, m in mats.items():
            d = rng.integers(0, 256, (m.shape[1], n), dtype=np.uint8)
            mt, dt = torch.from_numpy(m).to(dev), torch.from_numpy(d).to(dev)
            kg = gops.gf_matmul(mt, dt)
            check(np.array_equal(kg.cpu().numpy(), erasure.gf_matmul(m, d)),
                  f"gf256 kernel != erasure.gf_matmul, {label}, length {n}")
            err_g = max(err_g, max_abs_err(kg, gops.gf_matmul_plain(mt, dt)))
    for k in PARITY_KS:
        for n in PARITY_LENGTHS:
            d = rng.integers(0, 256, (k, n), dtype=np.uint8)
            t = torch.from_numpy(d).to(dev)
            kp = pops.parity(t)
            check(np.array_equal(kp.cpu().numpy(),
                                 np.bitwise_xor.reduce(d, axis=0)),
                  f"parity kernel != numpy XOR, k={k}, length {n}")
            err_p = max(err_p, max_abs_err(kp, pops.parity_plain(t)))
    for off in PARITY_OFFSETS:
        for n in PARITY_LENGTHS[1:]:
            d = rng.integers(0, 256, (4, n), dtype=np.uint8)
            buf = torch.zeros(4 * n + off, dtype=torch.uint8, device=dev)
            t = buf[off:].view(4, n)
            t.copy_(torch.from_numpy(d))
            check(t.data_ptr() % 16 == off, "offset view not off the grid")
            kp = pops.parity(t)
            check(np.array_equal(kp.cpu().numpy(),
                                 np.bitwise_xor.reduce(d, axis=0)),
                  f"parity kernel != numpy XOR, base {off} bytes off the "
                  f"grid, length {n}")
            err_p = max(err_p, max_abs_err(kp, pops.parity_plain(t)))
    check(err_p == 0, "parity kernel != plain")
    check(err_g == 0, "gf256 kernel != plain")
    log(f"parity: equal to numpy and plain for k in {list(PARITY_KS)} on "
        f"lengths {list(PARITY_LENGTHS)}, and with the data "
        f"{list(PARITY_OFFSETS)} bytes off the 16-byte grid")
    log(f"erasure kernels: parity and gf256 equal numpy and their plain "
        f"versions on stripe lengths {list(STRIPE_LENGTHS)}, matrices "
        f"{list(mats)}")
    d = torch.from_numpy(rng.integers(0, 256, (4, STRIPE),
                                      dtype=np.uint8)).to(dev)
    empty = empty_launcher(kernels, STRIPE)
    floor_ms = queued_ms(empty, 200)
    ms = queued_ms(lambda: pops.parity(d), 200)
    plain_ms = queued_ms(lambda: pops.parity_plain(d), 100)
    call_ms = cuda_ms(lambda: pops.parity(d), 200)
    log(f"parity: kernel {ms * 1e3:.3f} us, plain {plain_ms * 1e3:.3f} us "
        f"at (4, {STRIPE}) bytes (device time, queued); the card's floor "
        f"for one launch (an empty kernel of the same grid, queued): "
        f"{floor_ms * 1e3:.3f} us; one call back to back with the next, "
        f"host included: {call_ms * 1e3:.2f} us")
    return {"parity": dict(ms=ms, plain_ms=plain_ms, max_abs_err=err_p,
                           call_ms=call_ms, launch_floor_ms=floor_ms,
                           bound=bound(5 * STRIPE, gf_work(
                               np.ones((1, 4)), STRIPE)[0])),
            "gf256_check_err": err_g}


def time_gf256(rng, matrix, width: int, err: int) -> dict:
    """The GF(256) kernel and its plain version at (r, k) x (k, width),
    with the reconstruction matrix phase 4 used for its largest group."""
    import numpy as np
    import torch

    from repro_torch.kernels.gf256 import ops as gops

    dev = torch.device("cuda")
    m = torch.from_numpy(np.ascontiguousarray(matrix)).to(dev)
    d = torch.from_numpy(rng.integers(0, 256, (matrix.shape[1], width),
                                      dtype=np.uint8)).to(dev)
    kg = gops.gf_matmul(m, d)
    pg = gops.gf_matmul_plain(m, d)
    err = max(err, max_abs_err(kg, pg))
    check(err == 0, "gf256 kernel != plain at the phase-4 shape")
    del kg, pg
    ms = queued_ms(lambda: gops.gf_matmul(m, d), 20)
    plain_ms = queued_ms(lambda: gops.gf_matmul_plain(m, d), 2)
    r, k = matrix.shape
    nbytes = (r + k) * width + r * k
    ops, reads = gf_work(matrix, width)
    log(f"gf256: kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, "
        f"{nbytes / ms / 1e6:.1f} GB/s at ({r}, {k}) x ({k}, {width}), "
        f"matrix {matrix.tolist()}")
    return dict(ms=ms, plain_ms=plain_ms, max_abs_err=err,
                bound=bound(nbytes, ops, reads=reads))


# ------------------------------------------------------------- phase 3

def phase_main_path(seed: int, kernels, tmp: Path) -> tuple:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.service import ImageService, ServiceConfig
    from repro_torch.core.store import ChunkStore
    from repro_torch.models import DecoderLM, init_flat
    from repro_torch.serve.coldstart import cold_start
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = get_config("smollm-360m")
    t0 = time.perf_counter()
    flat = init_flat(cfg, seed)
    nparams = sum(a.size for a in flat.values())
    log(f"model {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{nparams / 1e6:.1f} M params, weights made in "
        f"{time.perf_counter() - t0:.1f} s")
    want = tree_digests(flat)
    key = hashlib.sha256(b"smoke tenant key").digest()
    out = {}
    store = ChunkStore(tmp)
    svc = ImageService(store, ServiceConfig(device="cuda", root="r0",
                                            max_batch_bytes=TILE))
    kernels.reset_launches()
    t0 = time.perf_counter()
    blob, st = svc.publish(flat, tenant="smoke", tenant_key=key)
    torch.cuda.synchronize()
    pub_s = time.perf_counter() - t0
    timing = svc.publisher().last_timing
    out["publish_s"] = pub_s
    out["publish_GBps"] = st.bytes_total / pub_s / 1e9
    out["publish_crypto_s"] = timing["crypto_s"]
    out["image_bytes"] = st.bytes_total
    out["chunks"] = st.total_chunks
    log(f"publish: {pub_s:.2f} s, {out['publish_GBps']:.3f} GB/s, "
        f"{st.total_chunks} chunks ({st.zero_chunks} zero), crypto "
        f"hooks {timing['crypto_s']:.2f} s, image id "
        f"{timing['image_id_s']:.2f} s")
    svc.close()

    # a worker that never published: its L1 starts empty
    svc = ImageService(store, ServiceConfig(device="cuda", root="r0",
                                            max_batch_bytes=TILE))
    model = DecoderLM(cfg, device="cuda")
    engine, cs = cold_start(model, blob, key, svc)
    check(cs["origin_fetches"] >= st.unique_chunks,
          f"cold start fetched {cs['origin_fetches']} chunks from the "
          f"origin, fewer than the {st.unique_chunks} stored")
    out.update({k: cs[k] for k in (
        "load_seconds", "restore_seconds", "fetch_wall_s",
        "decode_wall_s", "overlap_fraction", "decode_tiles",
        "origin_fetches")})
    log("cold start:", json.dumps({k: out[k] for k in cs if k in out}))

    # the cold start's reader (the service caches one per session)
    handle = svc.open(blob, key)
    out["sim"] = check_sim_origin(handle, cs)
    restored = handle.restore_tree()
    got = tree_digests(restored)
    check(got == want, "restored tree differs from the published one")
    del restored
    log(f"restore: {len(got)} tensors byte-identical (per-tensor SHA-256)")
    launches = dict(kernels.LAUNCHES)

    prompts = [rng_prompt(seed + i, cfg.vocab_size) for i in range(4)]
    reqs = [Request(i, prompt=p, max_new=16) for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    torch.cuda.synchronize()
    res = engine.run_until_drained()
    new_tokens = sum(len(r.out) for r in reqs)
    out["decode_tokens_per_s"] = new_tokens / res["seconds"]
    out["engine_steps"] = res["steps"]
    check(all(r.done and len(r.out) == 16 for r in reqs),
          "requests did not complete")
    ref_model = DecoderLM(cfg, device="cuda").load_flat(flat)
    ref = ServeEngine(ref_model, max_batch=4, max_len=128)
    rreqs = [Request(i, prompt=p, max_new=16)
             for i, p in enumerate(prompts)]
    for r in rreqs:
        ref.submit(r)
    ref.run_until_drained()
    check([r.out for r in reqs] == [r.out for r in rreqs],
          "cold-started tokens differ from the image-free model's")
    log(f"serve: 4 requests, {new_tokens} tokens, "
        f"{out['decode_tokens_per_s']:.1f} tokens/s, tokens equal "
        f"the image-free model's; first: {reqs[0].out}")
    out["peak_device_GB"] = torch.cuda.max_memory_allocated() / 1e9
    out["launches"] = launches
    out["past_max_len"] = check_past_max_len(model, prompts[0][:2])
    svc.close()
    ctx = {"store": store, "blob": blob, "key": key, "want": want,
           "unique_chunks": st.unique_chunks, "prompts": prompts,
           "tokens": [r.out for r in reqs], "flat": flat,
           "sim": out["sim"], "cfg": cfg}
    return out, ctx


def cut_context(kernels, ctx: dict) -> dict:
    """Phases 4-6's image: phase 3's tree cut to its first CUT_LAYERS
    layers (every ``g0/*`` stack sliced; full width), published into
    phase 3's store under its key. A restore through a fresh service
    (empty L1) must be byte-identical to the cut tree; its fused launches
    are one restore's. A ``ServeEngine`` over the cut weights loaded
    directly gives the greedy tokens of phase 3's prompts that phases 4-6
    hold their servers to. Returns phase 3's context with these in place
    of its image's."""
    import dataclasses

    import torch

    from repro_torch.core.manifest import ZERO_CHUNK, open_manifest
    from repro_torch.core.service import ImageService, ServiceConfig
    from repro_torch.models import DecoderLM
    from repro_torch.serve.engine import Request, ServeEngine

    t0 = time.perf_counter()
    cfg = dataclasses.replace(ctx["cfg"], num_layers=CUT_LAYERS)
    flat = {k: (v[:CUT_LAYERS] if k.startswith("g0/") else v)
            for k, v in ctx["flat"].items()}
    want = tree_digests(flat)
    svc = ImageService(ctx["store"], ServiceConfig(
        device="cuda", root="r0", max_batch_bytes=TILE))
    blob, st = svc.publish(flat, tenant="smoke", tenant_key=ctx["key"],
                           image_id=f"cut-{CUT_LAYERS}")
    svc.close()
    # most of its chunks are phase 3's (the same bytes at the same
    # offsets), so the store held them already: count its distinct ones
    distinct = len({c.name for c in open_manifest(blob, ctx["key"]).chunks}
                   - {ZERO_CHUNK})
    svc = ImageService(ctx["store"], ServiceConfig(
        device="cuda", root="r0", max_batch_bytes=TILE))
    f0 = kernels.LAUNCHES["fused_verify_decrypt"]
    handle = svc.open(blob, ctx["key"])
    got = tree_digests(handle.restore_tree())
    torch.cuda.synchronize()
    fused = kernels.LAUNCHES["fused_verify_decrypt"] - f0
    lb = handle.reader.last_batch
    # Fig. 11 from the origin for this image (phase 4 sets the L2 beside it)
    sim = {k: lb[k] for k in ("sim_serial_s", "sim_pipelined_s")}
    svc.close()
    check(got == want, "the cut image's restore differs from the cut tree")
    ref = ServeEngine(DecoderLM(cfg, device="cuda").load_flat(flat),
                      max_batch=4, max_len=128)
    reqs = [Request(i, prompt=p, max_new=16)
            for i, p in enumerate(ctx["prompts"])]
    for r in reqs:
        ref.submit(r)
    ref.run_until_drained()
    del ref
    out = {**ctx, "cfg": cfg, "flat": flat, "want": want, "blob": blob,
           "unique_chunks": distinct,
           "tokens": [r.out for r in reqs], "fused_per_restore": fused,
           "sim": sim}
    log(f"cut image: {cfg.name} cut to {CUT_LAYERS} of "
        f"{ctx['cfg'].num_layers} layers, {st.bytes_total} B in "
        f"{st.total_chunks} chunks ({distinct} distinct, {st.unique_chunks} "
        f"not already in the store), a restore byte-identical in {fused} "
        f"fused launches; "
        f"{time.perf_counter() - t0:.2f} s")
    return out


def check_sim_origin(handle, cs: dict) -> dict:
    """Fig. 11 from the origin: the streamed cold start's simulated
    serial and pipelined seconds. Every distinct chunk probed the empty
    L1 once and came from the origin, so the serial figure is fetched x
    ``ORIGIN_LAT_S`` + probes x ``L1_PROBE_S`` (no retry policy is set),
    and pipelining at the policy's parallelism must cut it at least 4x
    (the reference's gate); ``read_lat`` holds one sample per fetched
    chunk."""
    from repro_torch.core.blockdev import L1_PROBE_S, ORIGIN_LAT_S

    reader = handle.reader
    lb = reader.last_batch
    probes = len(handle.manifest.unique_names)
    check("sim_serial_s" in lb and "sim_pipelined_s" in lb,
          "the cold start's last_batch lacks sim_serial_s/sim_pipelined_s")
    check(cs["sim_serial_s"] == lb["sim_serial_s"],
          "cold_start's stats disagree with the reader's last_batch")
    fetched = lb["fetched"]
    check(fetched == probes == cs["origin_fetches"],
          f"{fetched} chunks fetched, {probes} distinct, "
          f"{cs['origin_fetches']} origin GETs")
    want = fetched * ORIGIN_LAT_S + probes * L1_PROBE_S
    check(abs(lb["sim_serial_s"] - want) <= 1e-9,
          f"sim_serial_s {lb['sim_serial_s']!r} != {want!r}")
    ratio = lb["sim_serial_s"] / lb["sim_pipelined_s"]
    check(ratio >= 4.0, f"simulated serial/pipelined {ratio:.3f} < 4 at "
          f"parallelism {lb['parallelism']}")
    summ = reader.read_lat.summary()
    check(summ["n"] == fetched, f"read_lat holds {summ['n']} samples for "
          f"{fetched} fetched chunks")
    out = {"fetched": fetched, "l1_probes": probes,
           "parallelism": lb["parallelism"],
           "sim_serial_s": lb["sim_serial_s"],
           "sim_pipelined_s": lb["sim_pipelined_s"], "ratio": ratio,
           "read_lat_n": summ["n"], "read_lat_p50_s": summ["p50"],
           "read_lat_p99_s": summ["p99"]}
    log("Fig. 11 from the origin:", json.dumps(out))
    return out


def check_past_max_len(model, short: list) -> dict:
    """One prompt longer than the engine's ``max_len`` beside one in
    range (ROADMAP.md §3, fault 1): the KV-cache writes past the last
    row are dropped, as the reference's scatter drops them, so the batch
    finishes and the in-range slot's tokens equal a run without the
    long request."""
    import torch

    from repro_torch.serve.engine import Request, ServeEngine

    def serve(prompts):
        eng = ServeEngine(model, max_batch=2, max_len=PAST_MAX_LEN)
        reqs = [Request(i, prompt=p, max_new=3)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
        torch.cuda.synchronize()
        check(all(r.done for r in reqs), "a request past max_len did not "
              "finish")
        return [r.out for r in reqs]
    long = list(range(1, PAST_MAX_LEN + 3))
    both = serve([long, short])
    alone = serve([short])
    check(both[1] == alone[0], f"the in-range slot's tokens {both[1]} "
          f"differ from its run alone {alone[0]}")
    out = {"max_len": PAST_MAX_LEN, "long_prompt": len(long),
           "long_tokens": both[0], "short_tokens": both[1]}
    log("past max_len:", json.dumps(out))
    return out


def tree_digests(tree: dict) -> dict:
    """Per-leaf SHA-256 of a flat tree (bfloat16 leaves as their bits)."""
    from repro_torch.core.layout import leaf_bytes
    return {k: hashlib.sha256(leaf_bytes(v).tobytes()).hexdigest()
            for k, v in tree.items()}


# ------------------------------------------------------------- phase 4

def phase_l2_path(seed: int, kernels, ctx: dict) -> tuple:
    """Worker A fills a 12-node L2 (latency model seeded from `seed`)
    from the origin; Fig. 9 runs on it (``phase_fig9``); one node
    crashes; worker B cold-starts from the L2 alone (staged), and a
    third worker restores streamed from it; the L2 is flushed and a
    fourth worker's restore goes back to the origin. Returns (summary,
    the largest group that reached the GF(256) hook as (matrix,
    width))."""
    import torch

    from repro_torch.core.cache.distributed import FaultPlan
    from repro_torch.core.service import ImageService, ReadPolicy, \
        ServiceConfig
    from repro_torch.core.telemetry import COUNTERS
    from repro_torch.models import DecoderLM
    from repro_torch.serve.coldstart import cold_start
    from repro_torch.serve.engine import Request

    store, blob, key = ctx["store"], ctx["blob"], ctx["key"]
    unique = ctx["unique_chunks"]
    l2_names = ("l2.hits", "l2.misses", "l2.stripe_timeouts", "l2.hedges",
                "l2.hedge_wins")
    out = {}
    kernels.reset_launches()

    # worker A: empty L1, empty L2 -> every chunk from the origin
    a = ImageService(store, ServiceConfig(device="cuda", root="r0",
                                          l2_nodes=12, l2_seed=seed,
                                          max_batch_bytes=TILE))
    ha = a.open(blob, key)
    before = ha.counters.get("read.origin_fetches")
    t0 = time.perf_counter()
    got = tree_digests(ha.restore_tree())
    torch.cuda.synchronize()
    out["fill_restore_s"] = time.perf_counter() - t0
    fills = ha.counters.get("read.origin_fetches") - before
    out["fill_origin_fetches"] = fills
    out["fill_parity_launches"] = kernels.LAUNCHES["parity"]
    check(got == ctx["want"], "worker A's restore differs from the cut tree")
    check(fills >= unique, f"worker A fetched {fills} chunks from the "
          f"origin, fewer than the {unique} distinct ones")
    check(kernels.LAUNCHES["parity"] == fills,
          f"{kernels.LAUNCHES['parity']} parity launches for {fills} "
          "L2 fills")
    log(f"L2 fill: worker A restored in {out['fill_restore_s']:.2f} s, "
        f"{fills:.0f} origin GETs, {kernels.LAUNCHES['parity']} parity "
        "launches")

    out["fig9"] = phase_fig9(kernels, a.l2, ha.manifest.unique_names,
                             ha.manifest.chunk_size)

    a.l2.set_fault("cache-000", FaultPlan.crashed())
    groups = []
    matmul = a.l2.coder.matmul_fn

    def recording(matrix, data):
        groups.append((matrix.copy(), data.shape[1]))
        return matmul(matrix, data)
    a.l2.coder.matmul_fn = recording

    # worker B: empty L1, A's L2 with cache-000 crashed, staged cold start
    cfg = ctx["cfg"]
    b = ImageService(store, ServiceConfig(device="cuda", root="r0",
                                          max_batch_bytes=TILE), l2=a.l2)
    model = DecoderLM(cfg, device="cuda")
    loaded = {}
    load_flat = model.load_flat

    def capture(flat):
        loaded.update(flat)
        return load_flat(flat)
    model.load_flat = capture
    c0 = {k: COUNTERS.get(k) for k in l2_names}
    g0 = kernels.LAUNCHES["gf256"]
    engine, cs = cold_start(model, blob, key, b,
                            policy=ReadPolicy(mode="staged", l2_hedge=True))
    l2c = {k: COUNTERS.get(k) - c0[k] for k in l2_names}
    out.update({f"b_{k}": cs[k] for k in (
        "load_seconds", "restore_seconds", "fetch_wall_s", "decode_wall_s",
        "origin_fetches", "l2_hits", "sim_serial_s", "sim_pipelined_s")})
    out["b_l2"] = l2c
    out["b_gf256_launches"] = kernels.LAUNCHES["gf256"] - g0
    out["b_groups"] = sorted((w // STRIPE for _, w in groups), reverse=True)
    log("L2 cold start:", json.dumps({k: v for k, v in out.items()
                                      if k.startswith("b_")}))
    check(cs["origin_fetches"] == 0,
          f"worker B made {cs['origin_fetches']} origin GETs")
    check(cs["l2_hits"] == unique,
          f"worker B had {cs['l2_hits']} L2 hits for {unique} chunks")
    check(out["b_gf256_launches"] >= 1, "the GF(256) kernel did not run")
    check(tree_digests(loaded) == ctx["want"],
          "worker B's restored tree differs from the cut tree")
    del loaded
    reqs = [Request(i, prompt=p, max_new=16)
            for i, p in enumerate(ctx["prompts"])]
    for r in reqs:
        engine.submit(r)
    engine.run_until_drained()
    check([r.out for r in reqs] == ctx["tokens"],
          "worker B's tokens differ from the cut weights'")
    log("L2 serve: 4 requests, greedy tokens equal the cut weights'")
    origin = ctx["sim"]
    out["fig11"] = {
        "origin_sim_pipelined_s": origin["sim_pipelined_s"],
        "l2_sim_pipelined_s": cs["sim_pipelined_s"],
        "origin_sim_serial_s": origin["sim_serial_s"],
        "l2_sim_serial_s": cs["sim_serial_s"],
        "l2_hit_rate": a.l2.hit_rate,
        "l2_fetch": a.l2.fetch_lat.summary()}
    log("Fig. 11, the L2 against the origin:", json.dumps(out["fig11"]))
    del engine, model
    b.close()

    # a third worker: streamed restore from the same L2
    c = ImageService(store, ServiceConfig(device="cuda", root="r0",
                                          max_batch_bytes=TILE), l2=a.l2)
    hc = c.open(blob, key)
    before = hc.counters.get("read.origin_fetches")
    t0 = time.perf_counter()
    got = tree_digests(hc.restore_tree(policy=ReadPolicy(l2_hedge=True)))
    out["c_restore_s"] = time.perf_counter() - t0
    out["c_origin_fetches"] = hc.counters.get("read.origin_fetches") - before
    out["c_l2_hits"] = hc.reader.last_batch["l2_hits"]
    check(got == ctx["want"], "the streamed L2 restore differs from the cut tree")
    log(f"L2 streamed restore: {out['c_restore_s']:.2f} s, "
        f"{out['c_l2_hits']} L2 hits, {out['c_origin_fetches']:.0f} origin "
        "GETs, byte-identical")
    c.close()

    # a flushed L2 holds nothing: a fourth worker goes back to the origin
    a.l2.flush()
    d = ImageService(store, ServiceConfig(device="cuda", root="r0",
                                          max_batch_bytes=TILE), l2=a.l2)
    hd = d.open(blob, key)
    before = hd.counters.get("read.origin_fetches")
    t0 = time.perf_counter()
    got = tree_digests(hd.restore_tree())
    out["d_restore_s"] = time.perf_counter() - t0
    out["d_origin_fetches"] = hd.counters.get("read.origin_fetches") - before
    check(got == ctx["want"], "the restore after flush() differs from "
          "the cut tree")
    check(out["d_origin_fetches"] == unique,
          f"after flush() a restore made {out['d_origin_fetches']:.0f} "
          f"origin GETs for {unique} distinct chunks")
    log(f"L2 flushed: a restore took {out['d_restore_s']:.2f} s, "
        f"{out['d_origin_fetches']:.0f} origin GETs, byte-identical")
    d.close()
    a.close()
    out["launches"] = dict(kernels.LAUNCHES)
    largest = max(groups, key=lambda g: g[1])
    return out, largest


def _percentiles(xs) -> dict:
    import numpy as np
    return {f"p{q:g}_us": float(np.percentile(xs, q)) * 1e6
            for q in (50, 90, 99, 99.9)}


def phase_fig9(kernels, l2, names: list, chunk_len: int) -> dict:
    """Phase 4b, the paper's Fig. 9, on worker A's filled L2: every
    distinct chunk name read ``FIG9_PASSES`` times through ``get_chunk``
    (4-of-5: the 4th-fastest of 5 stripes) and through
    ``get_chunk_unreplicated`` (4-of-4: the slowest of the 4 data
    stripes), interleaved as the reference's benchmark reads them; each
    ciphertext returned must hash to its name. p99.9 of 4-of-5 must lie
    below 4-of-4's and p99 not above (the reference's
    ``test_erasure_beats_kofk_tail``). A 4-of-4 read misses only when a
    stripe passed the stripe deadline (``l2.stripe_timeouts`` rose in
    that read). Then ``cache-000`` crashes and every name is read once
    each way: 4-of-5 in one hedged batch, as worker B's staged restore
    reads, which returns every chunk, the GF(256) kernel rebuilding
    those that lost a data stripe, and 4-of-4 name by name, which
    misses exactly the names whose first four ring nodes hold
    ``cache-000``, counted from the ring beforehand, besides reads with
    a timed-out stripe. The node is healed before returning."""
    from repro_torch.core.telemetry import COUNTERS

    def verified(name, ct) -> bool:
        check(ct is None or hashlib.sha256(ct).hexdigest() == name,
              f"the L2 returned a ciphertext that does not hash to {name}")
        return ct is not None

    def timeouts() -> float:
        return COUNTERS.get("l2.stripe_timeouts")

    out = {"names": len(names), "passes": FIG9_PASSES}
    t0 = time.perf_counter()
    ec, kk = [], []
    kk_misses = 0
    for _ in range(FIG9_PASSES):
        for name in names:
            lat, ct = l2.get_chunk(name, chunk_len)
            check(verified(name, ct), f"4-of-5 missed {name} on a healthy "
                  "L2")
            ec.append(lat)
            before = timeouts()
            lat, ct = l2.get_chunk_unreplicated(name, chunk_len)
            kk.append(lat)
            if not verified(name, ct):
                check(timeouts() > before, f"4-of-4 missed {name} on a "
                      "healthy L2 with no stripe past the deadline")
                kk_misses += 1
    out["healthy_s"] = time.perf_counter() - t0
    out["4of5"], out["4of4"] = _percentiles(ec), _percentiles(kk)
    out["tail_cut"] = {q: out["4of4"][q] / out["4of5"][q]
                       for q in out["4of5"]}
    out["4of4_timeout_misses"] = kk_misses
    log("Fig. 9, healthy L2:", json.dumps(out))
    check(out["4of5"]["p99.9_us"] < out["4of4"]["p99.9_us"],
          "p99.9 of 4-of-5 is not below 4-of-4's")
    check(out["4of5"]["p99_us"] <= out["4of4"]["p99_us"],
          "p99 of 4-of-5 is above 4-of-4's")

    victim = "cache-000"
    k = l2.coder.k
    lost = {n for n in names
            if victim in l2.ring.lookup(n, count=l2.coder.n)[:k]}
    l2.fail_node(victim)
    g0 = kernels.LAUNCHES["gf256"]
    t0 = time.perf_counter()
    down = []
    for name, (lat, ct) in l2.get_chunks(names, chunk_len,
                                         hedge=True).items():
        check(verified(name, ct), f"4-of-5 missed {name} with one node "
              "down")
        down.append(lat)
    out["crashed_gf256_launches"] = kernels.LAUNCHES["gf256"] - g0
    kk_missed, unexplained = set(), 0
    for name in names:
        before = timeouts()
        _, ct = l2.get_chunk_unreplicated(name, chunk_len)
        if not verified(name, ct):
            kk_missed.add(name)
            if name not in lost:
                check(timeouts() > before, f"4-of-4 missed {name}, whose "
                      f"data stripes avoid {victim}, with no stripe past "
                      "the deadline")
                unexplained += 1
    l2.fail_node(victim, False)
    out["crashed_s"] = time.perf_counter() - t0
    out["crashed_4of5"] = _percentiles(down)
    out["predicted_4of4_misses"] = len(lost)
    out["4of4_misses"] = len(kk_missed)
    out["4of4_timeout_misses_crashed"] = unexplained
    log(f"Fig. 9, {victim} down:", json.dumps(
        {k_: v for k_, v in out.items() if k_.startswith(("crashed",
                                                          "predicted",
                                                          "4of4_"))}))
    check(lost <= kk_missed, f"4-of-4 served {len(lost - kk_missed)} of "
          f"the {len(lost)} names whose data stripes include {victim}")
    check(len(kk_missed) == len(lost) + unexplained,
          f"4-of-4 missed {len(kk_missed)} names, predicted {len(lost)}")
    check(out["crashed_gf256_launches"] > 0, "the GF(256) kernel did not "
          f"run with {victim} down")
    return out


# ------------------------------------------------------------- phase 5

def _deltas(before: dict, names) -> dict:
    from repro_torch.core.telemetry import COUNTERS
    return {k: COUNTERS.get(k) - before.get(k, 0.0) for k in names}


def _pct(xs, q) -> float:
    import numpy as np
    return float(np.percentile(np.asarray(xs, float), q)) if xs else 0.0


def phase_peer_storm(seed: int, kernels, ctx: dict,
                     fused_per_restore: int) -> dict:
    """The cold-start storm through the peer tier, then the poisoned
    peer copy (module doc, phase 5)."""
    import threading

    import torch

    from repro_torch.core.cache.distributed import FaultPlan
    from repro_torch.core.faults import FaultyStore, OriginFaultPlan
    from repro_torch.core.manifest import ZERO_CHUNK, open_manifest
    from repro_torch.core.service import ImageService, ServiceConfig, \
        build_peer_mesh
    from repro_torch.core.telemetry import COUNTERS
    from repro_torch.models import DecoderLM
    from repro_torch.serve.coldstart import cold_start
    from repro_torch.serve.engine import Request

    t_phase = time.perf_counter()
    store, blob, key = ctx["store"], ctx["blob"], ctx["key"]
    unique = ctx["unique_chunks"]
    origin = FaultyStore(store, OriginFaultPlan.flaky(error_p=ORIGIN_ERROR_P),
                         seed=seed)
    cfg = ServiceConfig(device="cuda", root="r0", retry_attempts=5,
                        retry_seed=seed, breaker_threshold=0.5,
                        peer_fanout=STORM_FANOUT, max_batch_bytes=TILE)
    crash = {}
    crash_lock = threading.Lock()
    led = [0] * (STORM_WORKERS + 1)     # flights each worker's probe led

    def crash_hook(name, src, dst):
        # `led` counts a worker's leads when its probe returns; a leader
        # serves its flights only after that
        if crash or mesh.workers[src].served < CRASH_AFTER_TRANSFERS \
                or led[src] > CRASH_MAX_LED_SHARE * unique:
            return
        with crash_lock:
            if not crash:
                crash.update(worker=src, served=mesh.workers[src].served,
                             led=led[src],
                             at_s=time.perf_counter() - t_phase)
                mesh.set_fault(src, FaultPlan.crashed())
    mesh = build_peer_mesh(cfg, STORM_WORKERS + 1, seed=seed,
                           transfer_hook=crash_hook)
    # how long each joined flight kept its joiner waiting
    waits, waits_lock = [], threading.Lock()

    def timed_join(client):
        join_wait = client._join_wait

        def wrapped(name, flight):
            t0 = time.perf_counter()
            try:
                return join_wait(name, flight)
            finally:
                with waits_lock:
                    waits.append(time.perf_counter() - t0)
        return wrapped

    def counted_probe(client):
        probe = client.probe_chunks

        def wrapped(names, chunk_len, on_ready):
            leads, futs = probe(names, chunk_len, on_ready)
            led[client.wid] += len(leads)
            return leads, futs
        return wrapped
    clients = [mesh.client(i) for i in range(STORM_WORKERS + 1)]
    for c in clients:
        c._join_wait = timed_join(c)
        c.probe_chunks = counted_probe(c)
    svcs = [ImageService(origin, cfg, peer=clients[i])
            for i in range(STORM_WORKERS)]
    model = DecoderLM(ctx["cfg"], device="cuda")
    digests, times, splits, errors, engine = {}, {}, {}, [], {}
    load_flat = model.load_flat

    def capture(flat):
        digests[0] = tree_digests(flat)
        return load_flat(flat)
    model.load_flat = capture
    barrier = threading.Barrier(STORM_WORKERS)

    def work(i):
        try:
            barrier.wait(timeout=120)
            t0 = time.perf_counter()
            if i == 0:
                engine[0], lb = cold_start(model, blob, key, svcs[0])
                times[0] = (t0, time.perf_counter(), lb["restore_seconds"],
                            lb["load_seconds"])
            else:
                h = svcs[i].open(blob, key)
                tree = h.restore_tree()
                t1 = time.perf_counter()
                digests[i] = tree_digests(tree)
                del tree
                times[i] = (t0, t1, t1 - t0, None)
                lb = h.reader.last_batch
            splits[i] = [lb[k] for k in ("fetch_wall_s", "decode_wall_s",
                                         "overlap_fraction")]
        except Exception as e:          # reported by the check below
            errors.append(f"worker {i}: {e!r}")

    c0 = COUNTERS.snapshot()
    kernels.reset_launches()
    threads = [threading.Thread(target=work, args=(i,), name=f"worker-{i}",
                                daemon=True) for i in range(STORM_WORKERS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=STORM_TIMEOUT_S)
    hung = [t.name for t in threads if t.is_alive()]
    names = PEER_COUNTERS + RESILIENCE_COUNTERS + ("read.origin_fetches",)
    d = _deltas(c0, names)
    fused = kernels.LAUNCHES["fused_verify_decrypt"]
    restores = [times[i][2] for i in sorted(times)]
    out = {
        "workers": STORM_WORKERS,
        "fleet_wall_s": max((t[1] for t in times.values()), default=0.0)
        - min((t[0] for t in times.values()), default=0.0),
        "restore_s": restores,
        "restore_p50_s": _pct(restores, 50),
        "restore_max_s": max(restores, default=0.0),
        "w0_load_seconds": times[0][3] if 0 in times else None,
        "fetch_decode_overlap": [splits.get(i) for i in range(STORM_WORKERS)],
        "origin_gets": d["read.origin_fetches"], "unique_chunks": unique,
        "peer": {k: d[k] for k in PEER_COUNTERS},
        "resilience": {k: d[k] for k in RESILIENCE_COUNTERS},
        "crash": crash,
        "served": [w.served for w in mesh.workers],
        "led": list(led),
        "join_waits": len(waits),
        "join_wait_p50_s": _pct(waits, 50),
        "join_wait_p99_s": _pct(waits, 99),
        "join_wait_max_s": max(waits, default=0.0),
        "join_waits_at_deadline": sum(w >= mesh.deadline_s for w in waits),
        "fused_launches": fused,
    }
    log("peer storm:", json.dumps(out))
    check(not hung, f"storm workers {hung} did not finish in "
          f"{STORM_TIMEOUT_S} s")
    torch.cuda.synchronize()
    check(not errors, f"storm workers failed: {errors}")
    for i in range(STORM_WORKERS):
        check(digests.get(i) == ctx["want"],
              f"storm worker {i}'s tree differs from the cut tree")
    check(unique <= d["read.origin_fetches"] <= 2 * unique,
          f"the storm made {d['read.origin_fetches']:.0f} origin GETs for "
          f"{unique} distinct chunks (allowed {unique}..{2 * unique})")
    check(d["peer.transfers"] > 0, "no peer transfer in the storm")
    check(bool(crash), f"no worker leading at most "
          f"{CRASH_MAX_LED_SHARE:.0%} of the flights served "
          f"{CRASH_AFTER_TRANSFERS} transfers, so the crash did not fire")
    check(d["retry.retries"] >= 1, "no origin GET was retried")
    check(d["retry.giveups"] == 0,
          f"{d['retry.giveups']:.0f} origin GETs gave up")
    check(d["breaker.opened"] == 0, "the origin breaker opened")
    check(fused >= STORM_WORKERS * fused_per_restore,
          f"{fused} fused launches for {STORM_WORKERS} restores of "
          f"{fused_per_restore} each")
    reqs = [Request(i, prompt=p, max_new=16)
            for i, p in enumerate(ctx["prompts"])]
    for r in reqs:
        engine[0].submit(r)
    engine[0].run_until_drained()
    check([r.out for r in reqs] == ctx["tokens"],
          "storm worker 0's tokens differ from the cut weights'")
    log("peer storm: 4 trees byte-identical, worker 0's 4 requests give "
        "the cut weights' greedy tokens")
    del engine, model
    for svc in svcs:
        svc.close()

    # a poisoned peer copy, advertised by a worker that did not crash
    name = sorted({c.name for c in open_manifest(blob, key).chunks}
                  - {ZERO_CHUNK})[unique // 2]
    clients[0].invalidate(name)
    good = store.get_chunk("r0", name)
    bad = bytearray(good)
    bad[len(bad) // 2] ^= 0x01
    poisoner = next(i for i in range(STORM_WORKERS) if i != crash["worker"])
    clients[poisoner].put_chunk(name, bytes(bad), source="origin")
    check(mesh.holders(name) == [poisoner],
          "the poisoned copy is not advertised")
    w4 = ImageService(origin, cfg, peer=clients[STORM_WORKERS])
    h4 = w4.open(blob, key)
    flagged = []
    invalidate_bad = h4.reader._invalidate_bad

    def record(err):
        flagged.append(list(err.bad_positions))
        invalidate_bad(err)
    h4.reader._invalidate_bad = record
    c1 = COUNTERS.snapshot()
    f1 = kernels.LAUNCHES["fused_verify_decrypt"]
    t0 = time.perf_counter()
    got = tree_digests(h4.restore_tree())
    out["poison_restore_s"] = time.perf_counter() - t0
    d4 = _deltas(c1, names)
    out["poison_origin_gets"] = d4["read.origin_fetches"]
    out["poison_integrity_refetches"] = d4["retry.integrity_refetches"]
    out["poison_fused_launches"] = kernels.LAUNCHES["fused_verify_decrypt"] \
        - f1
    out["poison_holders_after"] = mesh.holders(name)
    w4.close()
    log("poisoned peer copy:", json.dumps(
        {k: v for k, v in out.items() if k.startswith("poison")}),
        f"flagged {flagged}")
    check(flagged == [[name]],
          f"the fused decode flagged {flagged}, not [[{name[:12]}...]]")
    check(got == ctx["want"], "worker 4's tree differs from the cut tree")
    check(d4["retry.integrity_refetches"] == 1,
          f"{d4['retry.integrity_refetches']:.0f} integrity refetch rounds")
    check(d4["read.origin_fetches"] == 1,
          f"worker 4 made {d4['read.origin_fetches']:.0f} origin GETs")
    check(poisoner not in mesh.holders(name),
          f"worker {poisoner} still holds the poisoned chunk")
    out["launches"] = dict(kernels.LAUNCHES)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"peer storm phase: {out['phase_s']:.2f} s")
    return out


# ------------------------------------------------------------- phase 6

class GatedStore:
    """The reader's view of the store: forwards every call, and from
    its `at`-th ``get_chunk`` on holds each GET until ``release`` is
    set. The GC's own GETs (``copy_chunks``) go to the store itself, so
    they are neither counted nor held."""

    def __init__(self, inner, at: int):
        self.inner = inner
        self.at = at
        self.calls = 0
        self._lock = threading.Lock()
        self.reached = threading.Event()
        self.release = threading.Event()

    def __getattr__(self, item):
        return getattr(self.inner, item)

    def get_chunk(self, root, name):
        with self._lock:
            self.calls += 1
            held = self.calls >= self.at
        if held:
            self.reached.set()
            if not self.release.wait(timeout=GATE_TIMEOUT_S):
                raise SmokeFailure("the reader's gate was never released")
        return self.inner.get_chunk(root, name)


def fine_tune(flat: dict, seed: int) -> dict:
    """B: `flat` with the last two layers (rows FINE_TUNED_ROWS) of every
    ``g0/s0/*`` tensor redrawn from `seed` (weights at the init scale,
    norm scales around 1); every other array is shared with `flat`."""
    import numpy as np
    rng = np.random.default_rng(seed)
    out = dict(flat)
    for name in sorted(flat):
        if not name.startswith("g0/s0/"):
            continue
        a = flat[name].copy()
        rows = a[FINE_TUNED_ROWS]
        new = rng.standard_normal(rows.shape, dtype=np.float32)
        if name.endswith("/scale"):
            new = np.float32(1) + np.float32(0.01) * new
        else:
            new *= np.float32(1.0 / np.sqrt(a.shape[-2]))
        a[FINE_TUNED_ROWS] = new
        out[name] = a
    return out


def chunk_digests(flat: dict) -> list:
    """hashlib SHA-256 of each non-zero chunk of `flat`'s image, in
    chunk order."""
    from repro_torch.core.layout import StreamingImageWriter, build_layout, \
        canonical_paths
    lay = build_layout(flat)
    return [hashlib.sha256(c).digest() for _, c in
            StreamingImageWriter(lay).chunks(canonical_paths(flat))
            if c.count(0) != len(c)]


def image_bytes(layout, flat: dict, offset: int, length: int) -> bytes:
    """Bytes [offset, offset + length) of `flat`'s image, assembled from
    the tensors at the layout's offsets (zeros between them)."""
    import numpy as np
    out = np.zeros(length, np.uint8)
    end = offset + length
    for t in layout.tensors.values():
        lo, hi = max(offset, t.offset), min(end, t.offset + t.nbytes)
        if lo < hi:
            raw = np.ascontiguousarray(flat[t.name]).view(np.uint8).reshape(-1)
            out[lo - offset:hi - offset] = raw[lo - t.offset:hi - t.offset]
    return out.tobytes()


def disk_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def phase_gc_roll(seed: int, kernels, ctx: dict, work: Path) -> dict:
    """A checkpoint roll of SmolLM-360M under a live restore (module
    doc, phase 6)."""
    import numpy as np
    import torch

    from repro_torch.core.blockdev import CowBlockDevice
    from repro_torch.core.gc import GenerationalGC
    from repro_torch.core.layout import CHUNK_SIZE
    from repro_torch.core.loader import sharding_slices
    from repro_torch.core.manifest import ZERO_CHUNK, open_manifest
    from repro_torch.core.service import ImageService, ServiceConfig
    from repro_torch.core.store import ChunkStore
    from repro_torch.core.telemetry import COUNTERS
    from repro_torch.models import DecoderLM
    from repro_torch.serve.coldstart import cold_start
    from repro_torch.serve.engine import Request, ServeEngine

    t_phase = time.perf_counter()
    cfg = ctx["cfg"]
    key = ctx["key"]
    flat_a = ctx["flat"]
    flat_b = fine_tune(flat_a, seed + 1)
    want_b = tree_digests(flat_b)
    dig_a = set(chunk_digests(flat_a))
    dig_b = chunk_digests(flat_b)
    shared = sum(d in dig_a for d in dig_b)      # B's chunks A already has
    store = ChunkStore(work / "store")
    gc = GenerationalGC(store)
    r1 = gc.active
    disk = [0]
    out = {"b_nonzero_chunks": len(dig_b), "b_chunks_in_a": shared}

    def service(root, **kw):
        return ImageService(store, ServiceConfig(
            device="cuda", root=root, max_batch_bytes=TILE,
            publish_name_index_path=str(work / "names.idx"), **kw),
            pins=gc.pins, refcounts=gc.refcounts)

    def names_of(blob) -> set:
        return {c.name for c in open_manifest(blob, key).chunks} - \
            {ZERO_CHUNK}

    kernels.reset_launches()
    # 1. the trainer publishes A
    p = service(r1)
    gc.pipeline = p.publisher()
    t0 = time.perf_counter()
    blob_a, st_a = p.publish(flat_a, tenant="smoke", tenant_key=key,
                             image_id="ckpt-0")
    torch.cuda.synchronize()
    out["publish_a_s"] = time.perf_counter() - t0
    out["publish_a_crypto_s"] = p.publisher().last_timing["crypto_s"]
    # 2. a restarted trainer publishes B through the saved name index
    q = service(r1)
    c0 = COUNTERS.snapshot()
    t0 = time.perf_counter()
    blob_b, st_b = q.publish(flat_b, tenant="smoke", tenant_key=key,
                             image_id="ckpt-1")
    torch.cuda.synchronize()
    out["publish_b_s"] = time.perf_counter() - t0
    tb = q.publisher().last_timing
    out["publish_b_crypto_s"] = tb["crypto_s"]
    out["publish_b_probe_s"] = tb["probe_s"]
    d = _deltas(c0, ("publish.encrypt_skipped_chunks",
                     "publish.encrypt_skipped_bytes", "store.presence_probes"))
    out["skipped_chunks"] = d["publish.encrypt_skipped_chunks"]
    out["skipped_bytes"] = d["publish.encrypt_skipped_bytes"]
    out["b_presence_probes"] = d["store.presence_probes"]
    out["b_unique_chunks"] = st_b.unique_chunks
    q.close()
    disk[0] = max(disk[0], disk_bytes(work))
    log("gc roll: publish A", json.dumps({k: out[k] for k in (
        "publish_a_s", "publish_a_crypto_s")}), "B", json.dumps({
            k: out[k] for k in ("publish_b_s", "publish_b_crypto_s",
                                "publish_b_probe_s", "skipped_chunks",
                                "skipped_bytes", "b_unique_chunks",
                                "b_chunks_in_a", "b_nonzero_chunks")}))
    check(out["skipped_chunks"] == shared,
          f"B's publish skipped encrypting {out['skipped_chunks']:.0f} "
          f"chunks; {shared} of its chunks are A's")
    check(st_b.unique_chunks == len(dig_b) - shared,
          f"B uploaded {st_b.unique_chunks} chunks, not the "
          f"{len(dig_b) - shared} A lacks")

    # 3. the roll, under a streamed restore of B frozen mid-flight
    names_a, names_b = names_of(blob_a), names_of(blob_b)
    dead = gc.retire_image(r1, "ckpt-0")
    check(dead == names_a - names_b, f"retire_image returned {len(dead)} "
          f"names, not the {len(names_a - names_b)} of A that B lacks")
    gate = GatedStore(store, GATE_AT_GET)
    reader = ImageService(gate, ServiceConfig(device="cuda", root=r1,
                                                max_batch_bytes=TILE),
                          pins=gc.pins)
    res = {}

    def restore():
        try:
            t = time.perf_counter()
            tree = reader.open(blob_b, key, root=r1).restore_tree()
            res["wall_s"] = time.perf_counter() - t
            res["digests"] = tree_digests(tree)
        except Exception as e:          # reported by the check below
            res["error"] = repr(e)
    th = threading.Thread(target=restore, name="restore-under-roll",
                          daemon=True)
    th.start()
    check(gate.reached.wait(timeout=GATE_TIMEOUT_S),
          f"the restore never reached its origin GET {GATE_AT_GET}")
    t_frozen = time.perf_counter()
    try:
        check(gc.pins.pinned(r1), "the frozen restore does not pin R1")
        c0 = COUNTERS.snapshot()
        check(gc.sweep(r1) == 0, "a sweep of the pinned R1 deleted chunks")
        check(_deltas(c0, ("gc.sweeps_deferred_pinned",))[
            "gc.sweeps_deferred_pinned"] == 1, "the sweep was not deferred")
        check(all(store.has_chunk(r1, n) for n in dead),
              "a dead chunk went while R1 was pinned")
        r2 = gc.new_root()
        before = (gc.stats.migrated_manifests, gc.stats.migrated_chunks)
        t0 = time.perf_counter()
        gc.migrate(r1)
        out["migrate_s"] = time.perf_counter() - t0
        out["migrated_manifests"] = gc.stats.migrated_manifests - before[0]
        out["migrated_chunks"] = gc.stats.migrated_chunks - before[1]
        disk[0] = max(disk[0], disk_bytes(work))
    finally:
        out["frozen_s"] = time.perf_counter() - t_frozen
        gate.release.set()
    th.join(timeout=GATE_TIMEOUT_S)
    check(not th.is_alive(), "the restore under the roll did not finish")
    torch.cuda.synchronize()
    check("error" not in res, f"the restore under the roll failed: "
          f"{res.get('error')}")
    out["restore_under_roll_s"] = res["wall_s"]
    out["reader_gets"] = gate.calls
    check(res["digests"] == want_b,
          "B's restore under the roll differs from B")
    check(out["migrated_manifests"] == 1, f"migrate moved "
          f"{out['migrated_manifests']} manifests, not 1")
    check(out["migrated_chunks"] == len(names_b), f"migrate copied "
          f"{out['migrated_chunks']} chunks, not B's {len(names_b)}")
    reader.close()
    check(not gc.pins.pinned(r1), "R1 is still pinned after the restore")
    out["swept"] = gc.sweep(r1)
    check(out["swept"] == len(dead), f"the sweep after the restore "
          f"deleted {out['swept']} chunks, not {len(dead)}")
    gc.expire(r1)
    check(gc.delete_expired(r1) is True, "R1 was not deleted")
    check(gc.stats.alarms == [] and not store.deletion_frozen,
          f"expired-root alarms {gc.stats.alarms}")
    log("gc roll:", json.dumps({k: out[k] for k in (
        "migrate_s", "migrated_manifests", "migrated_chunks", "frozen_s",
        "restore_under_roll_s", "reader_gets", "swept")}),
        f"R1 deleted, {len(dead)} dead chunks, no alarm")

    # 4. serve B from R2
    blob_b2 = store.get_manifest(r2, "ckpt-1")
    s = service(r2)
    model = DecoderLM(cfg, device="cuda")
    engine, cs = cold_start(model, blob_b2, key, s, root=r2)
    out["r2_load_seconds"] = cs["load_seconds"]
    out["r2_origin_fetches"] = cs["origin_fetches"]
    reqs = [Request(i, prompt=pr, max_new=16)
            for i, pr in enumerate(ctx["prompts"])]
    for r in reqs:
        engine.submit(r)
    engine.run_until_drained()
    ref = ServeEngine(DecoderLM(cfg, device="cuda").load_flat(flat_b),
                      max_batch=4, max_len=128)
    rreqs = [Request(i, prompt=pr, max_new=16)
             for i, pr in enumerate(ctx["prompts"])]
    for r in rreqs:
        ref.submit(r)
    ref.run_until_drained()
    check(all(r.done and len(r.out) == 16 for r in reqs),
          "R2's requests did not complete")
    check([r.out for r in reqs] == [r.out for r in rreqs],
          "R2's cold-started tokens differ from B's image-free model's")
    del engine, ref, model
    log(f"gc roll: cold start from R2 in {cs['load_seconds']:.2f} s, "
        f"{cs['origin_fetches']} origin GETs, 4 requests give B's "
        "image-free tokens")

    # 5. a block view of B in R2
    h = s.open(blob_b2, key, root=r2)
    dev = CowBlockDevice(h.reader)
    off = 3 * CHUNK_SIZE + 12345
    check(dev.read(off, 4 << 20) == image_bytes(h.layout, flat_b, off,
                                                4 << 20),
          "a 4 MiB block read differs from B's image")
    woff = 7 * CHUNK_SIZE - 777
    payload = np.random.default_rng(seed + 2).integers(
        0, 256, 1 << 20, dtype=np.uint8).tobytes()
    dev.write(woff, payload)
    base = image_bytes(h.layout, flat_b, woff - 100, (1 << 20) + 200)
    check(dev.read(woff - 100, (1 << 20) + 200)
          == base[:100] + payload + base[-100:],
          "the 1 MiB write does not read back")
    out["cow_dirty_bytes"] = dev.dirty_bytes
    fresh = service(r2)
    hf = fresh.open(blob_b2, key, root=r2)
    check(hf.reader.read_many([(woff - 100, (1 << 20) + 200)])[0] == base,
          "a fresh reader does not see the base bytes")
    sl = sharding_slices(flat_b["embed"].shape, [8, 1], [3, 0])
    want_shard = np.ascontiguousarray(flat_b["embed"][sl[0][0]:sl[0][1]])
    shard_chunks = hf.shard_chunks({"embed": sl})
    g0 = hf.counters.get("read.origin_fetches")
    hf.prefetch(shard_chunks)
    g1 = hf.counters.get("read.origin_fetches")
    got = hf.tensor_shard("embed", sl)
    g2 = hf.counters.get("read.origin_fetches")
    out["shard_chunks"] = len(shard_chunks)
    out["prefetch_origin_gets"] = g1 - g0
    check(got.tobytes() == want_shard.tobytes(),
          "the prefetched embed shard differs from B's")
    check(g2 == g1, f"tensor_shard after prefetch made {g2 - g1} origin "
          "GETs")
    log("gc roll: block view", json.dumps({k: out[k] for k in (
        "cow_dirty_bytes", "shard_chunks", "prefetch_origin_gets")}),
        "4 MiB read equal, 1 MiB write reads back, base intact, "
        "prefetched shard equal with no further origin GET")
    fresh.close()
    s.close()
    p.close()
    out["launches"] = dict(kernels.LAUNCHES)
    out["peak_disk_bytes"] = disk[0]
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"gc roll phase: {out['phase_s']:.2f} s, peak disk "
        f"{disk[0] / 1e9:.3f} GB")
    return out


# ------------------------------------------------------------- phase 7

def _launch(kernels, argv: list) -> tuple:
    """One in-process run of the port's serve launcher: (its result,
    the kernel launches it made, its wall seconds)."""
    from repro_torch.launch import serve
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = serve.main(argv)
    import torch
    torch.cuda.synchronize()
    return res, dict(kernels.LAUNCHES), time.perf_counter() - t0


def _serve_direct(model, requests: int, max_new: int, *, prompts=None,
                  max_batch: int = 4, max_len: int = 64) -> list:
    """The launcher's requests (or `prompts`) through a ServeEngine over
    `model`."""
    from repro_torch.serve.engine import Request, ServeEngine
    eng = ServeEngine(model, max_batch=max_batch, max_len=max_len)
    prompts = prompts or [[1 + i, 2, 3] for i in range(requests)]
    reqs = [Request(i, prompt=list(p), max_new=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    return [r.out for r in reqs]


def phase_launcher(seed: int, kernels, ctx: dict, work: Path) -> dict:
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import decode
    from repro_torch.core.service import ImageService, ServiceConfig
    from repro_torch.core.store import ChunkStore
    from repro_torch.core.telemetry import COUNTERS
    from repro_torch.launch import serve
    from repro_torch.models import DecoderLM, RunFlags, init_flat
    from repro_torch.models import blocks
    from repro_torch.models.attention import flash_attn_plain
    from repro_torch.models.lm import init_device

    t_phase = time.perf_counter()
    out = {}
    cfg = get_config("smollm-360m")
    flat = ctx["flat"]

    # 1. the full-width model through the launcher, tile left at "auto"
    store_dir = work / "store"
    pub = ImageService(ChunkStore(store_dir), ServiceConfig(
        device="cuda", root="R1", max_batch_bytes=TILE))
    t0 = time.perf_counter()
    blob, st = pub.publish(flat, tenant="serve", tenant_key=serve.TENANT_KEY,
                           image_id="smollm-360m-full")
    pub.close()
    log(f"launcher: published {cfg.name} at full width, {st.total_chunks} "
        f"chunks of {KIB512} B, in {time.perf_counter() - t0:.2f} s")
    argv = ["--arch", "smollm-360m", "--no-reduced", "--store",
            str(store_dir), "--image", "smollm-360m-full", "--root", "R1",
            "--eager-flush", "--l2-nodes", "0", "--requests", "8",
            "--max-new", "8"]
    log("launcher: python -m repro_torch.launch.serve " + " ".join(argv))
    res, launches_a, wall = _launch(kernels, argv)
    cs = res["cold_start"]
    rates = decode.AUTOTUNE_RATES[("torch-fused", "cuda")]
    sweep_launches = 2 * len(rates)        # a warmup and a timed pass each
    check(res["served"] == 8, f"the launcher served {res['served']}/8")
    check(launches_a["fused_verify_decrypt"] > sweep_launches,
          f"the launcher's restore launched no fused kernel beyond the "
          f"autotune sweep's {sweep_launches}: {launches_a}")
    check("eager_flushes" in cs and cs["eager_flushes"] is not None,
          "the cold start's stats carry no eager_flushes")
    direct = DecoderLM(cfg, device="cuda").load_flat(flat)
    want = _serve_direct(direct, 8, 8)
    check(res["tokens"] == want, "the launcher's greedy tokens differ from "
          f"the directly loaded model's: {res['tokens']} vs {want}")
    new_tokens = sum(len(t) for t in res["tokens"])
    out["launcher"] = {
        "tile_bytes": res["tile_bytes"],
        "autotune_GBps": {str(c): r / 1e9 for c, r in sorted(rates.items())},
        "load_seconds": cs["load_seconds"],
        "fetch_wall_s": cs["fetch_wall_s"],
        "decode_wall_s": cs["decode_wall_s"],
        "decode_tiles": cs["decode_tiles"],
        "eager_flushes": cs["eager_flushes"],
        "overlap_fraction": cs["overlap_fraction"],
        "origin_fetches": cs["origin_fetches"],
        "serve_tokens_per_s": new_tokens / res["serve_seconds"],
        "wall_s": wall, "fused_launches": launches_a["fused_verify_decrypt"],
        "sweep_fused_launches": sweep_launches}
    log("launcher: autotuned tile", res["tile_bytes"], "B; timed GB/s per "
        "candidate", json.dumps(out["launcher"]["autotune_GBps"]))
    log("launcher: full width", json.dumps(out["launcher"]),
        "; 8 requests' tokens equal the directly loaded model's")

    # 2. every flag group at reduced width, publishing on the card
    before = COUNTERS.get("retry.giveups")
    argv = ["--arch", "smollm-360m", "--publish", "--l2-nodes", "6",
            "--peer-workers", "2", "--retry-attempts", "3",
            "--breaker-threshold", "0.5", "--origin-fault", "error_p=0.02"]
    log("launcher: python -m repro_torch.launch.serve " + " ".join(argv))
    res_b, launches_b, wall_b = _launch(kernels, argv)
    giveups = COUNTERS.get("retry.giveups") - before
    check(res_b["served"] == res_b["requests"] == 8,
          f"the reduced launcher served {res_b['served']}/8")
    for name in ("sha256_many", "aes_encrypt_many"):
        check(launches_b[name] > 0, f"the --publish launcher launched no "
              f"{name}")
    check(giveups == 0, f"{giveups} origin retries gave up")
    out["reduced_flags"] = {"wall_s": wall_b, "launches": launches_b,
                            "retry_giveups": giveups}
    log("launcher: reduced --publish with L2, peers, retries, breaker and "
        "a flaky origin:", json.dumps(out["reduced_flags"]),
        f"(GF(256) {launches_b['gf256']}, parity {launches_b['parity']} "
        "launches)")

    # 3a. prefill at SmolLM-360M's full width against prefill by decoding
    B, S = PREFILL_PROMPTS, PREFILL_LEN
    toks = torch.from_numpy(np.random.default_rng(seed + 7).integers(
        0, cfg.vocab_size, (B, S)))
    direct.prefill({"tokens": toks}, direct.init_decode_state(B, S))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, _ = direct.prefill({"tokens": toks},
                               direct.init_decode_state(B, S))
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    state = direct.init_decode_state(B, S)
    t0 = time.perf_counter()
    for t in range(S):
        dec_logits, state = direct.decode_step(state, toks[:, t],
                                               torch.full((B,), t))
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    V = cfg.vocab_size
    a, b = logits[:, :V].float(), dec_logits[:, :V].float()
    diff = (a - b).abs().max().item()
    scale = b.abs().max().item()
    top2 = b.topk(2, dim=-1).values
    out["prefill_smollm"] = {
        "prompts": B, "tokens": S, "prefill_ms": prefill_ms,
        "decode_path_s": decode_s, "max_abs_logit_diff": diff,
        "max_abs_logit": scale,
        "min_top2_gap": (top2[:, 0] - top2[:, 1]).min().item()}
    check(torch.equal(a.argmax(-1), b.argmax(-1)),
          "prefill's greedy tokens differ from prefill by decoding: "
          f"{out['prefill_smollm']}")
    check(diff <= PREFILL_BF16_TOL * scale, "prefill's last-position logits "
          f"differ from prefill by decoding: {out['prefill_smollm']}")
    log("prefill: smollm-360m, full width, bfloat16:",
        json.dumps(out["prefill_smollm"]))
    del direct, state, logits, dec_logits

    # 3b. starcoder2-15b at full width, 2 of its 40 layers, a prompt
    # past its 4096-token window; the card route of flash_attn held
    # against the plain blocked version at every layer
    full = get_config("starcoder2-15b")
    cut = dataclasses.replace(full, num_layers=STARCODER_LAYERS)
    log(f"prefill: {full.name} at full width (d_model {full.d_model}, "
        f"{full.num_heads} heads / {full.num_kv_heads} KV, window "
        f"{full.sliding_window}), depth cut to {cut.num_layers} of "
        f"{full.num_layers} layers, float32, one prompt of "
        f"{STARCODER_PROMPT} tokens")
    t0 = time.perf_counter()
    sc = DecoderLM(cut, RunFlags(dtype="float32")).load_flat(
        init_device(cut, seed + 8, dtype="float32"))
    torch.cuda.synchronize()
    weights_s = time.perf_counter() - t0
    errs = []
    card_flash = blocks.flash_attn

    def checked(q, k, v, **kw):
        o = card_flash(q, k, v, **kw)
        ref = flash_attn_plain(q.float(), k.float(), v.float(), **kw)
        errs.append((o.float() - ref).abs().max().item())
        return o

    sc_toks = torch.from_numpy(np.random.default_rng(seed + 9).integers(
        0, cut.vocab_size, (1, STARCODER_PROMPT)))
    blocks.flash_attn = checked
    try:
        sc.prefill({"tokens": sc_toks},
                   sc.init_decode_state(1, STARCODER_PROMPT))
    finally:
        blocks.flash_attn = card_flash
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sc_logits, _ = sc.prefill({"tokens": sc_toks},
                              sc.init_decode_state(1, STARCODER_PROMPT))
    torch.cuda.synchronize()
    sc_ms = (time.perf_counter() - t0) * 1e3
    out["prefill_starcoder2"] = {
        "layers": cut.num_layers, "of_layers": full.num_layers,
        "tokens": STARCODER_PROMPT, "window": full.sliding_window,
        "prefill_ms": sc_ms, "weights_s": weights_s,
        "peak_device_GB": torch.cuda.max_memory_allocated() / 1e9,
        "flash_max_abs_err_per_layer": errs}
    check(len(errs) == cut.num_layers,
          f"flash_attn ran {len(errs)} times for {cut.num_layers} layers")
    check(max(errs) <= FLASH_F32_TOL, "the card route of flash_attn differs "
          f"from its plain version: {errs}")
    check(bool(torch.isfinite(sc_logits).all()),
          "starcoder2 prefill logits are not finite")
    log("prefill: starcoder2-15b:", json.dumps(out["prefill_starcoder2"]))
    del sc, sc_logits
    out["launches"] = {k: launches_a[k] + launches_b[k] for k in launches_a}
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"launcher phase: {out['phase_s']:.2f} s")
    return out


# ------------------------------------------------------------- phase 8

def ep_image_config():
    """Phase 8b's image: jamba-v0.1-52b's published layout (16 experts
    top-2 on every other sublayer, attention at slot 4 of a period of 8,
    Mamba d_state 16, d_conv 4, expand 2, vocab 65536, no positional
    embedding, head_dim 128) for one period, 8 of its 32 layers, with
    three cuts: d_model 4096 -> 1024, heads 32 / 8 KV -> 8 / 2, d_ff and
    dense_d_ff 14336 -> 1024. The float32 image is then 1.590 GB, the
    size of phase 3's, because publishing runs at ~0.1 GB/s."""
    import dataclasses

    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("jamba-v0.1-52b"), num_layers=8,
                               d_model=1024, num_heads=8, num_kv_heads=2,
                               head_dim=128, d_ff=1024, dense_d_ff=1024)


def expert_bytes(cfg, itemsize: int) -> int:
    """Bytes of `cfg`'s expert stacks at `itemsize` bytes a weight."""
    from repro_torch.models.lm import flat_specs, param_specs
    from repro_torch.serve.coldstart import expert_dim
    return sum(math.prod(sp.shape) * itemsize
               for name, sp in flat_specs(param_specs(cfg)).items()
               if expert_dim(name, sp.shape, cfg.num_experts) is not None)


def moe_loop(p: dict, x, cfg):
    """The MoE layer of `x` (T, D) one token at a time, in float32: the
    router's logits as the model forms them (``x @ router`` in the
    working dtype), then softmax and top-k (ties to the lower expert) in
    float32 and the gates renormalised; an assignment is kept while its
    expert has room, in flat (token, k) order, under the capacity
    T * K * cf / E (at least 1, at most T, rounded up to 128s from 128);
    every kept expert's FFN and the shared and residual MLPs from the
    same bfloat16 weights upcast to float32."""
    import torch
    import torch.nn.functional as F
    T, D = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    probs = torch.softmax((x @ p["router"]).float(), dim=-1).cpu()
    cap = min(max(1, int(T * K * cfg.capacity_factor / E)), T)
    if cap >= 128:
        cap = -(-cap // 128) * 128

    def ffn(w, v):
        if cfg.mlp_type == "swiglu":
            h = F.silu(v @ w["w_gate"].float()) * (v @ w["w_up"].float())
        else:
            h = F.gelu(v @ w["w_up"].float(), approximate="tanh")
        return h @ w["w_down"].float()

    xf = x.float()
    y = torch.zeros((T, D), dtype=torch.float32, device=x.device)
    used = [0] * E
    for t in range(T):
        row = probs[t].tolist()
        top = sorted(range(E), key=lambda e: (-row[e], e))[:K]
        total = max(sum(row[e] for e in top), 1e-9)
        for e in top:
            if used[e] < cap:
                w = {k: p[k][e] for k in ("w_gate", "w_up", "w_down")
                     if k in p}
                y[t] += (row[e] / total) * ffn(w, xf[t])
            used[e] += 1
    for extra in ("shared", "residual"):
        if extra in p:
            y += ffn(p[extra], xf)
    return y


def serve_recorded(model, prompts: list) -> dict:
    """`prompts` through a ``ServeEngine`` at batch FAMILY_BATCH:
    greedy tokens, the last decode step's logits, steps and seconds."""
    import torch

    from repro_torch.serve.engine import Request, ServeEngine
    last = {}
    inner = model.decode_step

    def recorded(state, tokens, pos):
        logits, state = inner(state, tokens, pos)
        last["logits"] = logits
        return logits, state

    model.decode_step = recorded
    try:
        eng = ServeEngine(model, max_batch=FAMILY_BATCH, max_len=64)
        reqs = [Request(i, prompt=p, max_new=FAMILY_NEW)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        torch.cuda.synchronize()
        res = eng.run_until_drained()
    finally:
        del model.decode_step
    check(all(r.done and len(r.out) == FAMILY_NEW for r in reqs),
          f"{model.cfg.name}: requests did not complete")
    return {"tokens": [r.out for r in reqs], "logits": last["logits"],
            "steps": res["steps"], "seconds": res["seconds"]}


def check_moe_layers(model, toks) -> list:
    """Decode the prompts `toks` (B, S) from a fresh state and hold
    every MoE layer of the last step against ``moe_loop`` on its input:
    [relative max error per MoE layer]."""
    import torch

    from repro_torch.models import blocks
    calls = []
    real = blocks.moe_apply

    def rec(p, x, cfg, dtype, impl="sort"):
        y = real(p, x, cfg, dtype, impl=impl)
        calls.append((p, x, y))
        return y

    B = toks.shape[0]
    state = model.init_decode_state(B, 64)
    blocks.moe_apply = rec
    try:
        for t in range(toks.shape[1]):
            calls.clear()
            model.decode_step(state, toks[:, t], torch.full((B,), t))
    finally:
        blocks.moe_apply = real
    errs = []
    for p, x, y in calls:
        want = moe_loop(p, x[:, 0], model.cfg)
        err = (y[:, 0].float() - want).abs().max().item()
        scale = want.abs().max().item()
        errs.append(err / scale)
        check(err <= MOE_LOOP_TOL * scale, f"{model.cfg.name}: a MoE layer "
              f"differs from the per-token loop by {err} (max |y| {scale})")
    return errs


def prefill_against_decoding(model, toks) -> dict:
    """`model`'s prefill of `toks` (B, S) against decoding them one
    token a step: the last logits' largest difference, whether the
    greedy tokens agree, and for each MoE layer how many of the B * S
    tokens the two routed to another set of experts."""
    import torch

    from repro_torch.models import moe
    B, S = toks.shape
    routes = {"prefill": [], "decode": []}
    real = moe.route
    mode = ["prefill"]

    def rec(p, xf, cfg, dtype):
        gates, experts = real(p, xf, cfg, dtype)
        routes[mode[0]].append(experts.sort(dim=-1).values)
        return gates, experts

    moe.route = rec
    try:
        logits, _ = model.prefill({"tokens": toks},
                                  model.init_decode_state(B, S))
        mode[0] = "decode"
        state = model.init_decode_state(B, S)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(S):
            dec, state = model.decode_step(state, toks[:, t],
                                           torch.full((B,), t))
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
    finally:
        moe.route = real
    n = len(routes["prefill"])
    flips = [int((routes["prefill"][i].view(B, S, -1)
                  != torch.stack(routes["decode"][i::n], dim=1))
                 .any(-1).sum()) for i in range(n)]
    V = model.cfg.vocab_size
    a, b = logits[:, :V].float(), dec[:, :V].float()
    return {"dtype": model.flags.dtype, "decode_path_s": decode_s,
            "max_abs_logit_diff": (a - b).abs().max().item(),
            "max_abs_logit": b.abs().max().item(),
            "argmax_equal": bool(torch.equal(a.argmax(-1), b.argmax(-1))),
            "tokens_routed_elsewhere_per_moe_layer": flips}


def check_prefill_equals_decoding(cfg, seed: int, toks) -> dict:
    """Jamba's prefill against decoding, in float32 with weights drawn
    on the card, capacity_factor E / K (no assignment dropped): greedy
    tokens equal, logits within PREFILL_BF16_TOL. In bfloat16 the two
    paths' rounding differs enough to move a token's top-k experts now
    and then, a discontinuity that spreads through the later layers
    (``prefill_against_decoding`` counts those tokens), so the check is
    made where rounding is 2^16 times finer."""
    import dataclasses

    import torch

    from repro_torch.models import DecoderLM, RunFlags
    from repro_torch.models.lm import init_device
    nodrop = dataclasses.replace(
        cfg, capacity_factor=cfg.num_experts / cfg.experts_per_token)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = DecoderLM(nodrop, RunFlags(dtype="float32")).load_flat(
        init_device(nodrop, seed, "float32"))
    out = prefill_against_decoding(model, toks)
    out["peak_device_GB"] = torch.cuda.max_memory_allocated() / 1e9
    del model
    torch.cuda.empty_cache()
    check(out["argmax_equal"], f"{cfg.name}: prefill's greedy tokens differ "
          f"from decoding: {out}")
    check(out["max_abs_logit_diff"] <= PREFILL_BF16_TOL * out["max_abs_logit"],
          f"{cfg.name}: prefill's logits differ from decoding: {out}")
    return out


def phase_families(seed: int) -> dict:
    """8a: each of FAMILY_MODELS at its published widths (module doc)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import DecoderLM
    from repro_torch.models.lm import init_device

    out = {}
    for arch, layers in FAMILY_MODELS:
        full = get_config(arch)
        cfg = dataclasses.replace(full, num_layers=layers)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        flat = init_device(cfg, seed, "bfloat16")
        model = DecoderLM(cfg, device="cuda").load_flat(flat)
        torch.cuda.synchronize()
        weights_s = time.perf_counter() - t0
        weight_bytes = sum(t.numel() * t.element_size() for t in flat.values())
        rec = {"layers": layers, "of_layers": full.num_layers,
               "weights_GB": weight_bytes / 1e9, "weights_s": weights_s}
        log(f"family: {arch} at full width (d_model {cfg.d_model}, "
            f"{cfg.num_experts} experts top-{cfg.experts_per_token}), "
            f"{layers} of {full.num_layers} layers, "
            f"{rec['weights_GB']:.2f} GB of weights drawn on the card in "
            f"{weights_s:.2f} s")
        prompts = [rng_prompt(seed + 30 + i, cfg.vocab_size)
                   for i in range(FAMILY_REQUESTS)]
        runs = [serve_recorded(model, prompts) for _ in range(2)]
        check(runs[0]["tokens"] == runs[1]["tokens"], f"{arch}: a second "
              "run of the same requests gave other tokens")
        check(torch.equal(runs[0]["logits"], runs[1]["logits"]),
              f"{arch}: a second run gave other last logits")
        new_tokens = sum(len(t) for t in runs[1]["tokens"])
        rec["tokens_per_s"] = new_tokens / runs[1]["seconds"]
        rec["decode_step_ms"] = runs[1]["seconds"] / runs[1]["steps"] * 1e3
        rec["expert_read_floor_ms"] = expert_bytes(cfg, 2) \
            / HBM_BYTES_PER_S * 1e3
        rec["weight_read_floor_ms"] = weight_bytes / HBM_BYTES_PER_S * 1e3
        toks = torch.tensor(prompts[:FAMILY_BATCH])
        rec["moe_loop_rel_err"] = check_moe_layers(model, toks)
        ptoks = torch.from_numpy(np.random.default_rng(seed + 40).integers(
            0, cfg.vocab_size, (PREFILL_PROMPTS, PREFILL_LEN)))
        model.prefill({"tokens": ptoks},
                      model.init_decode_state(PREFILL_PROMPTS, PREFILL_LEN))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.prefill({"tokens": ptoks},
                      model.init_decode_state(PREFILL_PROMPTS, PREFILL_LEN))
        torch.cuda.synchronize()
        rec["prefill_ms"] = (time.perf_counter() - t0) * 1e3
        if cfg.family == "hybrid":
            nodrop = dataclasses.replace(
                cfg, capacity_factor=cfg.num_experts / cfg.experts_per_token)
            rec["prefill_vs_decoding_bfloat16"] = prefill_against_decoding(
                DecoderLM(nodrop, device="cuda").load_flat(flat), ptoks)
        rec["peak_device_GB"] = torch.cuda.max_memory_allocated() / 1e9
        rec["first_tokens"] = runs[1]["tokens"][0]
        del model, flat, runs
        if cfg.family == "hybrid":
            rec["prefill_vs_decoding_float32"] = \
                check_prefill_equals_decoding(cfg, seed, ptoks)
        log(f"family: {arch}:", json.dumps(rec))
        out[arch] = rec
    torch.cuda.empty_cache()
    return out


class CountingStore:
    """The reader's view of the store: forwards every call, and counts
    the ``get_chunk`` calls and the bytes they return."""

    def __init__(self, inner):
        self.inner = inner
        self.gets = 0
        self.bytes = 0
        self._lock = threading.Lock()

    def __getattr__(self, item):
        return getattr(self.inner, item)

    def get_chunk(self, root, name):
        data = self.inner.get_chunk(root, name)
        with self._lock:
            self.gets += 1
            self.bytes += len(data)
        return data


def same_bytes(a, b) -> bool:
    import numpy as np
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(
        a.reshape(-1).view(np.uint8), b.reshape(-1).view(np.uint8))


def phase_ep_restore(seed: int, kernels, work: Path) -> dict:
    """8b: publish, cold start and EP_SIZE expert-parallel restores of
    ``ep_image_config()``'s image; 8c: the reduced jamba launcher."""
    import numpy as np
    import torch

    from repro_torch.core.manifest import ZERO_CHUNK
    from repro_torch.core.service import ImageService, ServiceConfig
    from repro_torch.core.store import ChunkStore
    from repro_torch.models import DecoderLM, init_flat
    from repro_torch.serve.coldstart import cold_start, \
        expert_shard_restore, expert_shard_slices
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = ep_image_config()
    t0 = time.perf_counter()
    flat = init_flat(cfg, seed + 50)
    out = {"params": sum(a.size for a in flat.values()),
           "weights_s": time.perf_counter() - t0}
    key = hashlib.sha256(b"ep tenant key").digest()
    store = ChunkStore(work / "store")

    def service(st):
        return ImageService(st, ServiceConfig(device="cuda", root="r0",
                                              max_batch_bytes=TILE))

    kernels.reset_launches()
    pub = service(store)
    t0 = time.perf_counter()
    blob, st = pub.publish(flat, tenant="ep", tenant_key=key)
    torch.cuda.synchronize()
    out["publish_s"] = time.perf_counter() - t0
    pub.close()
    out.update(image_bytes=st.bytes_total, chunks=st.total_chunks,
               unique_chunks=st.unique_chunks, zero_chunks=st.zero_chunks)
    log(f"ep: {cfg.name} cut to d_model {cfg.d_model}, {cfg.num_layers} "
        f"layers, {out['params'] / 1e6:.1f} M params, published "
        f"{st.bytes_total / 1e9:.3f} GB in {out['publish_s']:.2f} s: "
        f"{st.total_chunks} chunks, {st.unique_chunks} stored, "
        f"{st.zero_chunks} zero")

    counting = CountingStore(store)
    svc = service(counting)
    model = DecoderLM(cfg, device="cuda")
    engine, cs = cold_start(model, blob, key, svc)
    svc.close()
    out["cold_start"] = {k: cs[k] for k in (
        "load_seconds", "restore_seconds", "origin_fetches")}
    out["cold_start"].update(origin_gets=counting.gets,
                             origin_bytes=counting.bytes)
    check(counting.gets >= st.unique_chunks, f"the cold start fetched "
          f"{counting.gets} chunks, fewer than the {st.unique_chunks} stored")
    prompts = [rng_prompt(seed + 60 + i, cfg.vocab_size)
               for i in range(FAMILY_REQUESTS)]

    def serve(eng):
        reqs = [Request(i, prompt=p, max_new=FAMILY_NEW)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
        check(all(r.done for r in reqs), "ep: requests did not complete")
        return [r.out for r in reqs]

    tokens = serve(engine)
    direct = DecoderLM(cfg, device="cuda").load_flat(flat)
    check(tokens == serve(ServeEngine(direct, max_batch=4, max_len=128)),
          "ep: the cold-started model's tokens differ from the directly "
          "loaded model's")
    del model, engine, direct
    log("ep: cold start", json.dumps(out["cold_start"]), f"; {len(prompts)} "
        "requests served, tokens equal the directly loaded model's")

    E = cfg.num_experts
    whole = [n for n in flat if n.endswith(("ffn/router", "mixer/A_log",
                                            "mixer/conv_w", "mixer/dt_proj"))]
    parts = {}
    out["ranks"] = []
    for rank in range(EP_SIZE):
        counting = CountingStore(store)
        svc = service(counting)
        handle = svc.open(blob, key)
        tensors = handle.layout.tensors
        slices = expert_shard_slices(tensors, E, rank, EP_SIZE)
        planned = handle.shard_chunks({
            n: s or [(0, d) for d in tensors[n].shape]
            for n, s in slices.items()})
        names = {handle.manifest.chunks[i].name for i in planned} \
            - {ZERO_CHUNK}
        t0 = time.perf_counter()
        got = expert_shard_restore(handle, E, rank, EP_SIZE)
        torch.cuda.synchronize()
        rec = {"rank": rank, "restore_s": time.perf_counter() - t0,
               "chunks": len(planned), "planned_gets": len(names),
               "origin_gets": counting.gets, "origin_bytes": counting.bytes,
               "share_of_cold_start_bytes":
               counting.bytes / out["cold_start"]["origin_bytes"]}
        svc.close()
        check(counting.gets == len(names), f"ep rank {rank} made "
              f"{counting.gets} origin GETs for {len(names)} distinct chunks")
        check(counting.bytes < out["cold_start"]["origin_bytes"],
              f"ep rank {rank} fetched as many bytes as the whole image")
        lo, hi = E * rank // EP_SIZE, E * (rank + 1) // EP_SIZE
        for n, full in flat.items():
            if slices[n] is None:
                check(same_bytes(got[n], full), f"ep rank {rank}: {n} "
                      "differs from the published tensor")
            else:
                check(slices[n][1] == (lo, hi), f"{n}: expert dim not dim 1")
                check(same_bytes(got[n], full[:, lo:hi]), f"ep rank {rank}: "
                      f"{n} differs from experts {lo}:{hi} of the published")
                parts.setdefault(n, []).append(got[n])
        check(all(slices[n] is None for n in whole),
              "ep: a router or Mamba tensor was sliced")
        out["ranks"].append(rec)
        log("ep: rank", json.dumps(rec))
        del got
    check(len(parts) == 12, f"ep: {len(parts)} expert stacks, want 12")
    for n, ps in parts.items():
        check(same_bytes(np.concatenate(ps, axis=1), flat[n]),
              f"ep: the ranks' slices of {n} do not make up the tensor")
    out["launches_ep"] = dict(kernels.LAUNCHES)
    log(f"ep: {EP_SIZE} ranks restored their exact slices ({len(parts)} "
        f"expert stacks whole again, {len(whole)} router and Mamba tensors "
        "whole on every rank)")
    del flat, parts

    argv = ["--arch", "jamba-v0.1-52b", "--publish"]
    log("launcher: python -m repro_torch.launch.serve " + " ".join(argv))
    res, launches_c, wall = _launch(kernels, argv)
    check(res["served"] == res["requests"] == 8,
          f"the reduced jamba launcher served {res['served']}/8")
    out["launcher"] = {"wall_s": wall, "launches": launches_c,
                       "config": res["config"]}
    log("launcher: reduced jamba --publish:", json.dumps(out["launcher"]))
    out["launches"] = {k: out["launches_ep"][k] + launches_c[k]
                       for k in launches_c}
    return out


# ------------------------------------------------------------- phase 9

def image_chunk_names(store, root: str, image_id: str) -> set:
    """The non-zero chunk names of an image, from its public manifest."""
    from repro_torch.core.manifest import ZERO_CHUNK, read_public
    pub = read_public(store.get_manifest(root, image_id))
    return {name for _i, name, _s in pub["chunks"]} - {ZERO_CHUNK}


def phase_train_resume(seed: int, kernels, work: Path) -> dict:
    """9a: SmolLM-360M at full width (TRAIN_LAYERS layers) trains,
    checkpoints through the
    service, crashes and resumes byte-identical; retention and a sweep;
    elastic recovery of one worker's shard. 9b: the reduced launcher
    and its --resume."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.core.gc import GenerationalGC
    from repro_torch.core.service import ImageService, ServiceConfig
    from repro_torch.core.store import ChunkStore
    from repro_torch.launch.variants import get_variant
    from repro_torch.train.checkpoint import CheckpointManager, state_to_tree
    from repro_torch.train.elastic import ElasticCoordinator
    from repro_torch.train.loop import LoopConfig, Trainer, WorkerFailure
    from repro_torch.train.optimizer import OptConfig

    cfg = dataclasses.replace(get_config("smollm-360m"),
                              num_layers=TRAIN_LAYERS)
    _policy, flags, opt = get_variant("baseline", cfg, SHAPES["train_4k"])
    loop = LoopConfig(steps=TRAIN_CKPT_EVERY, batch=TRAIN_BATCH,
                      seq=TRAIN_SEQ, ckpt_every=TRAIN_CKPT_EVERY,
                      log_every=1, seed=seed, opt=OptConfig(**opt))
    key = hashlib.sha256(b"train tenant key").digest()
    store = ChunkStore(work / "store")
    gc = GenerationalGC(store)
    services = []

    class SnapshotManager(CheckpointManager):
        """Hashes each uploaded snapshot on the upload thread, after its
        publish, so that no training step waits on the hashing."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.digests, self.snapshot_bytes = {}, {}

        def _upload(self, step, host_tree):
            super()._upload(step, host_tree)
            self.digests[step] = tree_digests(host_tree)
            self.snapshot_bytes[step] = sum(v.nbytes
                                            for v in host_tree.values())

        def uploading(self) -> bool:
            return self._pending is not None and self._pending.is_alive()

    def manager(l1_bytes=256 << 20, st=store, cls=CheckpointManager):
        svc = ImageService(st, ServiceConfig(
            device="cuda", decode_backend="torch-fused", max_batch_bytes=TILE,
            l1_bytes=l1_bytes), pins=gc.pins, refcounts=gc.refcounts)
        services.append(svc)
        return cls(st, gc, tenant="train", tenant_key=key,
                   run_name="smollm", service=svc)

    out = {"config": cfg.name, "variant": "baseline",
           "flags": {"dtype": flags.dtype, "remat": flags.remat},
           "moments": loop.opt.moments, "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ}
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    mgr_a = manager(cls=SnapshotManager)
    t0 = time.perf_counter()
    a = Trainer(cfg, loop, ckpt_mgr=mgr_a, flags=flags, device="cuda").init()
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    # one run toward step 8: steps 1-4, the step-4 save, steps 5-6
    # under its upload, then the crash
    a.failure_hook = lambda step: step >= TRAIN_CRASH_AT
    t0 = time.perf_counter()
    try:
        a.run(2 * TRAIN_CKPT_EVERY)
        raise SmokeFailure("trainer A did not crash")
    except WorkerFailure as e:
        check(e.step == TRAIN_CRASH_AT, f"A crashed at step {e.step}")
    out["steps_wall_s"] = time.perf_counter() - t0
    out["upload_in_flight_at_crash"] = mgr_a.uploading()
    check(out["upload_in_flight_at_crash"], "the step-4 upload ended "
          f"before step {TRAIN_CRASH_AT} did: no step ran under it")
    t0 = time.perf_counter()
    mgr_a.wait()
    out["upload_left_at_crash_s"] = time.perf_counter() - t0
    rec4 = mgr_a.records[-1]
    check(rec4.step == TRAIN_CKPT_EVERY, f"A's checkpoint is at step "
          f"{rec4.step}")
    out["snapshot_host_copy_s"] = mgr_a.last_snapshot_s
    out["publish_s"] = rec4.stats["seconds"]
    out["checkpoint_bytes"] = rec4.stats["bytes_total"]
    out["checkpoint_unique_chunks"] = rec4.stats["unique_chunks"]
    out["publish_GBps"] = rec4.stats["bytes_total"] / rec4.stats["seconds"] \
        / 1e9
    launches_pub = dict(kernels.LAUNCHES)
    want = mgr_a.digests[TRAIN_CKPT_EVERY]
    out["state_tensors"] = len(want)
    out["state_bytes"] = mgr_a.snapshot_bytes[TRAIN_CKPT_EVERY]
    log(f"train: {cfg.name} [baseline] B={TRAIN_BATCH} S={TRAIN_SEQ}, "
        f"weights drawn in {out['init_s']:.2f} s; step-4 checkpoint "
        f"{rec4.stats['bytes_total'] / 1e9:.3f} GB, "
        f"{rec4.stats['unique_chunks']} chunks stored, published in "
        f"{out['publish_s']:.2f} s ({out['publish_GBps']:.3f} GB/s), host "
        f"copy {out['snapshot_host_copy_s']:.2f} s, "
        f"{out['upload_left_at_crash_s']:.2f} s of it left when A "
        f"crashed; launches {json.dumps(launches_pub)}")

    hist_a = {h["step"]: h for h in a.history}
    out["step_ms_all"] = [1e3 * hist_a[s]["s"]
                          for s in range(1, TRAIN_CRASH_AT + 1)]
    out["step_ms"] = float(np.median(out["step_ms_all"][1:TRAIN_CKPT_EVERY]))
    out["step_ms_under_upload"] = out["step_ms_all"][TRAIN_CKPT_EVERY:]
    out["tokens_per_s"] = TRAIN_BATCH * TRAIN_SEQ / (out["step_ms"] / 1e3)
    out["losses_a"] = [hist_a[s]["loss"] for s in range(1, TRAIN_CRASH_AT + 1)]
    check(all(np.isfinite(out["losses_a"])), "A's losses are not finite")
    out["peak_device_GB"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"train: A crashed at step {TRAIN_CRASH_AT}; step "
        f"{out['step_ms']:.2f} ms (median of steps 2-{TRAIN_CKPT_EVERY}), "
        f"{out['tokens_per_s']:.0f} tokens/s; steps "
        f"{TRAIN_CKPT_EVERY + 1}-{TRAIN_CRASH_AT} under the step-4 upload "
        f"{[round(x, 2) for x in out['step_ms_under_upload']]} ms (steps "
        f"1-{TRAIN_CKPT_EVERY}: "
        f"{[round(x, 2) for x in out['step_ms_all'][:TRAIN_CKPT_EVERY]]}); "
        f"losses {out['losses_a']}, peak {out['peak_device_GB']:.2f} GB")
    del a
    mgr_a.service.close()
    torch.cuda.empty_cache()

    # B: a new service on the same store, its L1 empty
    mgr_b = manager()
    b = Trainer(cfg, loop, ckpt_mgr=mgr_b, flags=flags, device="cuda")
    before = dict(kernels.LAUNCHES)
    t0 = time.perf_counter()
    b.resume()
    torch.cuda.synchronize()
    out["resume_s"] = time.perf_counter() - t0
    out["resume_fused_launches"] = kernels.LAUNCHES["fused_verify_decrypt"] \
        - before["fused_verify_decrypt"]
    check(b.step == TRAIN_CKPT_EVERY, f"B resumed at step {b.step}")
    check(out["resume_fused_launches"] > 0,
          "the resume did not launch the fused kernel")
    got = tree_digests(state_to_tree(b.state))
    check(got == want, "the resumed state differs from A's step-4 snapshot "
          f"in {sorted(k for k in want if got.get(k) != want[k])[:5]}")
    b.run(TRAIN_CRASH_AT - TRAIN_CKPT_EVERY)
    hist_b = {h["step"]: h for h in b.history}
    out["losses_b"] = [hist_b[s]["loss"] for s in
                       range(TRAIN_CKPT_EVERY + 1, TRAIN_CRASH_AT + 1)]
    ref = out["losses_a"][TRAIN_CKPT_EVERY:]
    out["losses_bitwise_equal"] = out["losses_b"] == ref
    out["loss_max_rel_diff"] = max(abs(x - y) / abs(y)
                                   for x, y in zip(out["losses_b"], ref))
    check(out["loss_max_rel_diff"] <= TRAIN_LOSS_TOL, f"B's losses "
          f"{out['losses_b']} differ from A's {ref}")
    log(f"train: B resumed at step {TRAIN_CKPT_EVERY} in "
        f"{out['resume_s']:.2f} s ({out['resume_fused_launches']} fused "
        "launches), "
        f"{len(got)} tensors byte-identical to A's snapshot; steps 5-6 "
        f"losses {out['losses_b']} (A: {ref}), bitwise equal: "
        f"{out['losses_bitwise_equal']}, max rel diff "
        f"{out['loss_max_rel_diff']:.3g}")

    # B trains on to the step-8 checkpoint; the restarted trainer adopts
    # the run's history from the store, keeps the newest and sweeps
    b.run(2 * TRAIN_CKPT_EVERY - TRAIN_CRASH_AT)
    rec8 = mgr_b.records[-1]
    check(rec8.step == 2 * TRAIN_CKPT_EVERY, f"B's checkpoint is at step "
          f"{rec8.step}")
    out["publish2_s"] = rec8.stats["seconds"]
    snap8 = state_to_tree(b.state)
    mgr_b.records = mgr_b.discover()
    check([r.step for r in mgr_b.records] == [4, 8],
          f"discover found steps {[r.step for r in mgr_b.records]}")
    only4 = image_chunk_names(store, rec4.root, rec4.image_id) \
        - image_chunk_names(store, rec8.root, rec8.image_id)
    dead = mgr_b.retire_before(keep_last=1)
    swept = gc.sweep(gc.active)
    check(dead == only4, f"retire_before returned {len(dead)} chunks, the "
          f"step-4 image alone holds {len(only4)}")
    check(swept == len(dead) > 0, f"the sweep reclaimed {swept} of "
          f"{len(dead)} dead chunks")
    check(set(store.list_chunks(gc.active)) ==
          image_chunk_names(store, rec8.root, rec8.image_id),
          "the root holds other chunks than the step-8 image's")
    out["retired_chunks"] = len(dead)
    out["swept_chunks"] = swept
    log(f"train: B checkpointed step 8 ({out['publish2_s']:.2f} s); "
        f"retire_before(keep_last=1) freed {len(dead)} chunks, the sweep "
        f"reclaimed {swept}")
    del b
    mgr_b.service.close()
    torch.cuda.empty_cache()

    # elastic recovery: a fresh reader, empty L1, counted origin GETs
    counting = CountingStore(store)
    svc = ImageService(counting, ServiceConfig(
        device="cuda", max_batch_bytes=TILE, l1_bytes=RECOVERY_L1_BYTES),
        pins=gc.pins)
    handle = svc.open(store.get_manifest(rec8.root, rec8.image_id), key,
                      root=rec8.root)
    co = ElasticCoordinator(1, RECOVERY_MP)
    co.kill("w-0-2")
    plan = co.plan_recovery(
        "w-0-2", handle,
        param_specs_fn=lambda n, s: [RECOVERY_MP] + [1] * (len(s) - 1))
    from repro_torch.core.manifest import ZERO_CHUNK
    names = {handle.manifest.chunks[i].name for i in plan["chunks"]} \
        - {ZERO_CHUNK}
    stats = co.execute_recovery(plan, handle)
    gets = counting.gets
    before = dict(kernels.LAUNCHES)
    t0 = time.perf_counter()
    shards = handle.restore_shards(plan["shard_slices"])
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    svc.close()
    out["recovery"] = {
        "chunks": len(plan["chunks"]), "image_chunks":
        handle.layout.num_chunks, "chunk_fraction": plan["chunk_fraction"],
        "distinct_nonzero_chunks": len(names), "origin_gets": gets,
        "origin_fetches": stats["origin_fetches"],
        "prefetch_s": stats["seconds"], "restore_s": restore_s,
        "gets_after_restore": counting.gets,
        "fused_launches": kernels.LAUNCHES["fused_verify_decrypt"]
        - before["fused_verify_decrypt"]}
    check(plan["chunk_fraction"] <= RECOVERY_MAX_FRACTION,
          f"recovery needs {plan['chunk_fraction']:.3f} of the chunks")
    check(gets == stats["origin_fetches"] == len(names), f"recovery made "
          f"{gets} origin GETs ({stats['origin_fetches']} counted) for "
          f"{len(names)} distinct non-zero chunks")
    check(co.workers["w-0-2"].alive, "w-0-2 was not brought back")
    for n, sl in plan["shard_slices"].items():
        want_shard = np.ascontiguousarray(
            snap8[n][tuple(slice(a, b) for a, b in sl)])
        check(same_bytes(shards[n], want_shard),
              f"recovered shard of {n} differs from the step-8 state")
    del snap8, shards
    log("train: recovery of w-0-2 (mp 4):", json.dumps(out["recovery"]))

    # 9b: the launcher, reduced, then --resume
    import contextlib
    import io
    import re

    from repro_torch.launch import train as launch_train
    argv = ["--arch", "smollm-360m", "--reduced", "--steps", "4",
            "--ckpt-every", "2", "--variant", "opt8bit", "--store",
            str(work / "launch")]
    line = re.compile(r"step +\d+  loss -?[\d.]+  gnorm [\d.]+  [\d.]+s")
    out["launcher"] = []
    for extra, start in (([], 0), (["--resume"], 4)):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            hist = launch_train.main(argv + extra)
        torch.cuda.synchronize()
        text = buf.getvalue().splitlines()
        log("launcher: python -m repro_torch.launch.train "
            + " ".join(argv + extra))
        for ln in text:
            log("  " + ln)
        check(text[0] == f"training smollm-360m [opt8bit] from step {start}",
              f"the launcher printed {text[0]!r}")
        check(all(line.fullmatch(ln) for ln in text[1:-1]) and
              text[-1].startswith("checkpoints: [("),
              "the launcher's lines differ from the reference's")
        check(hist[-1]["step"] == start + 4, f"the launcher stopped at step "
              f"{hist[-1]['step']}")
        out["launcher"].append({"start": start, "wall_s":
                                time.perf_counter() - t0,
                                "last_loss": hist[-1]["loss"]})
    out["launches"] = dict(kernels.LAUNCHES)
    for svc in services:
        svc.close()
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------- phase 10

def publish_and_cold_start(cfg, flat: dict, seed: int, kernels,
                           store_dir: Path, card: str) -> tuple:
    """10a/b: `flat` published through one service (SHA-256, AES), then
    cold-started through a second one with an empty L1 (fused kernel);
    every restored tensor byte-identical (per-tensor SHA-256); the
    cold-started bfloat16 engine serves FAMILY_REQUESTS requests of
    8-token prompts and PHASE10_NEW new tokens at batch FAMILY_BATCH
    with the tokens of the same weights loaded directly. Returns (the
    stats with the launches, the cold-started model)."""
    import torch

    from repro_torch.core.service import ImageService, ServiceConfig
    from repro_torch.core.store import ChunkStore
    from repro_torch.models import build_model
    from repro_torch.serve.coldstart import cold_start
    from repro_torch.serve.engine import Request, ServeEngine

    want = tree_digests(flat)
    key = hashlib.sha256(f"{cfg.name} tenant key".encode()).digest()
    store = ChunkStore(store_dir)

    def service():
        return ImageService(store, ServiceConfig(device="cuda", root="r0",
                                                 max_batch_bytes=TILE))

    out = {"params": sum(a.size for a in flat.values())}
    kernels.reset_launches()
    pub = service()
    t0 = time.perf_counter()
    blob, st = pub.publish(flat, tenant="smoke", tenant_key=key)
    torch.cuda.synchronize()
    out["publish_s"] = time.perf_counter() - t0
    pub.close()
    out.update(image_bytes=st.bytes_total, chunks=st.total_chunks,
               unique_chunks=st.unique_chunks)
    log(f"{cfg.name}: {out['params'] / 1e6:.1f} M params, published "
        f"{st.bytes_total / 1e9:.3f} GB ({st.total_chunks} chunks) in "
        f"{out['publish_s']:.2f} s {card}")
    svc = service()
    model = build_model(cfg, device="cuda")
    engine, cs = cold_start(model, blob, key, svc)
    check(cs["origin_fetches"] >= st.unique_chunks,
          f"{cfg.name}: the cold start fetched {cs['origin_fetches']} "
          f"chunks from the origin, fewer than the {st.unique_chunks} stored")
    check(cs["decode_backend"] == "torch-fused", f"{cfg.name}: the cold "
          f"start decoded with {cs['decode_backend']}")
    out["cold_start"] = {k: cs[k] for k in (
        "load_seconds", "restore_seconds", "fetch_wall_s", "decode_wall_s",
        "origin_fetches")}
    restored = svc.open(blob, key).restore_tree()
    check(tree_digests(restored) == want, f"{cfg.name}: the restored tree "
          "differs from the published one")
    out["tensors_identical"] = len(want)
    del restored
    out["launches"] = dict(kernels.LAUNCHES)
    svc.close()
    log(f"{cfg.name}: cold start {json.dumps(out['cold_start'])}, "
        f"{len(want)} tensors byte-identical {card}")

    prompts = [rng_prompt(seed + 70 + i, cfg.vocab_size)
               for i in range(FAMILY_REQUESTS)]

    def serve(eng):
        reqs = [Request(i, prompt=p, max_new=PHASE10_NEW)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        torch.cuda.synchronize()
        res = eng.run_until_drained()
        check(all(r.done and len(r.out) == PHASE10_NEW for r in reqs),
              f"{cfg.name}: requests did not complete")
        return [r.out for r in reqs], res

    tokens, res = serve(engine)
    direct = build_model(cfg, device="cuda").load_flat(flat)
    check(tokens == serve(ServeEngine(direct, max_batch=FAMILY_BATCH,
                                      max_len=128))[0],
          f"{cfg.name}: the cold-started model's tokens differ from the "
          "directly loaded model's")
    del direct, engine
    new = sum(len(t) for t in tokens)
    out["serve"] = {"requests": len(prompts), "tokens": new,
                    "steps": res["steps"],
                    "decode_step_ms": res["seconds"] / res["steps"] * 1e3,
                    "tokens_per_s": new / res["seconds"],
                    "first_tokens": tokens[0]}
    log(f"{cfg.name}: served {len(prompts)} requests at batch "
        f"{FAMILY_BATCH}, {out['serve']['decode_step_ms']:.3f} ms a decode "
        f"step, {out['serve']['tokens_per_s']:.1f} tokens/s, tokens equal "
        f"the directly loaded model's {card}")
    return out, model


def close_states(got: dict, want: dict, tol: float) -> dict:
    """{name: max |got - want| / max |want|} of two decode-state trees;
    fails past `tol`."""
    errs = {}
    for name, w in want.items():
        if isinstance(w, dict):
            errs.update({f"{name}/{k}": v for k, v in
                         close_states(got[name], w, tol).items()})
            continue
        scale = max(w.float().abs().max().item(), 1e-30)
        errs[name] = (got[name].float() - w.float()).abs().max().item() \
            / scale
        check(errs[name] <= tol, f"state {name} differs by {errs[name]} "
              "of its max")
    return errs


def phase_xlstm(seed: int, kernels, work: Path, card: str) -> dict:
    """10a: xlstm-350m at published width, XLSTM_LAYERS of its 24
    layers (module doc)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import DecoderLM, RunFlags, init_flat

    cfg = dataclasses.replace(get_config("xlstm-350m"),
                              num_layers=XLSTM_LAYERS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    flat = init_flat(cfg, seed + 80)
    weights_s = time.perf_counter() - t0
    out, model = publish_and_cold_start(cfg, flat, seed, kernels,
                                        work / "xlstm", card)
    out["weights_s"] = weights_s
    toks = torch.from_numpy(np.random.default_rng(seed + 81).integers(
        0, cfg.vocab_size, (PREFILL_PROMPTS, PREFILL_LEN)))
    model.prefill({"tokens": toks[:, :8]},
                  model.init_decode_state(PREFILL_PROMPTS, PREFILL_LEN))
    _, ms = wall_ms(lambda: model.prefill(
        {"tokens": toks},
        model.init_decode_state(PREFILL_PROMPTS, PREFILL_LEN)))
    out["prefill_bf16_ms"] = ms
    del model
    # float32: prefill against decoding the same prompts
    f32 = DecoderLM(cfg, RunFlags(dtype="float32")).load_flat(flat)
    del flat
    state = f32.init_decode_state(PREFILL_PROMPTS, PREFILL_LEN,
                                  torch.float32)
    (logits, state), ms = wall_ms(lambda: f32.prefill({"tokens": toks},
                                                      state))
    out["prefill_f32_ms"] = ms
    ref = f32.init_decode_state(PREFILL_PROMPTS, PREFILL_LEN, torch.float32)
    t0 = time.perf_counter()
    for t in range(PREFILL_LEN):
        dec, ref = f32.decode_step(ref, toks[:, t],
                                   torch.full((PREFILL_PROMPTS,), t))
    torch.cuda.synchronize()
    out["decode_path_s"] = time.perf_counter() - t0
    V = cfg.vocab_size
    a, b = logits[:, :V].float(), dec[:, :V].float()
    out["max_abs_logit_diff"] = (a - b).abs().max().item()
    out["max_abs_logit"] = b.abs().max().item()
    check(torch.equal(a.argmax(-1), b.argmax(-1)), "xlstm-350m: prefill's "
          "greedy tokens differ from decoding")
    check(out["max_abs_logit_diff"] <= PREFILL_BF16_TOL
          * out["max_abs_logit"], "xlstm-350m: prefill's logits differ "
          f"from decoding: {out['max_abs_logit_diff']}")
    out["state_rel_err"] = close_states(state, ref, PREFILL_BF16_TOL)
    out["peak_device_GB"] = torch.cuda.max_memory_allocated() / 1e9
    del f32, state, ref
    torch.cuda.empty_cache()
    log("xlstm-350m:", json.dumps({k: v for k, v in out.items()
                                   if k != "launches"}), card)
    return out


def phase_whisper(seed: int, kernels, work: Path, card: str) -> dict:
    """10b: whisper-base at published width and full depth (module
    doc)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import global_batch
    from repro_torch.models import RunFlags, blocks, build_model, init_flat
    from repro_torch.models.attention import flash_attn_plain

    cfg = get_config("whisper-base")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    flat = init_flat(cfg, seed + 90)
    out, model = publish_and_cold_start(cfg, flat, seed, kernels,
                                        work / "whisper", card)
    B, S = PREFILL_PROMPTS, cfg.encoder_seq
    frames = torch.from_numpy(global_batch(cfg, 0, B, S, seed=seed)
                              ["frames"])
    model.prefill({"frames": frames}, model.init_decode_state(B, 32))
    state = model.init_decode_state(B, 32)
    (logits, state), ms = wall_ms(lambda: model.prefill({"frames": frames},
                                                        state))
    out["encoder_ms"] = ms
    check(state["s1"]["k"].shape == (cfg.num_layers, B, S, cfg.num_kv_heads,
                                     cfg.head_dim), "whisper-base: the "
          f"cross k/v has shape {tuple(state['s1']['k'].shape)}")
    tok = logits[:, :cfg.vocab_size].argmax(-1)
    greedy = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(PHASE10_NEW):
        logits, state = model.decode_step(state, tok, torch.full((B,), t))
        tok = logits[:, :cfg.vocab_size].argmax(-1)
        greedy.append(tok)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    out["decode_step_ms"] = sec / PHASE10_NEW * 1e3
    out["decode_tokens_per_s"] = B * PHASE10_NEW / sec
    out["first_tokens"] = [int(t[0]) for t in greedy]
    check(bool(torch.isfinite(logits).all()), "whisper-base: decode logits "
          "are not finite")
    del model, state
    # float32: flash_attn's card route against its plain version at every
    # call of a train-mode loss over WHISPER_TARGET tokens and S frames
    f32 = build_model(cfg, RunFlags(dtype="float32"),
                      device="cuda").load_flat(flat)
    del flat
    card_flash = blocks.flash_attn
    calls = []

    def checked(q, k, v, **kw):
        o = card_flash(q, k, v, **kw)
        ref = flash_attn_plain(q.float(), k.float(), v.float(), **kw)
        calls.append({"q": q.shape[1], "kv": k.shape[1],
                      "causal": kw.get("causal", True),
                      "err": (o.float() - ref).abs().max().item()})
        return o

    rng = np.random.default_rng(seed + 91)
    toks = rng.integers(0, cfg.vocab_size, (B, WHISPER_TARGET + 1))
    batch = {"frames": frames, "tokens": toks[:, :-1], "labels": toks[:, 1:]}
    blocks.flash_attn = checked
    try:
        with torch.no_grad():
            loss = f32.loss(f32.params, batch)
    finally:
        blocks.flash_attn = card_flash
    kinds = {(c["q"], c["kv"], c["causal"]) for c in calls}
    check(kinds == {(S, S, False), (WHISPER_TARGET, WHISPER_TARGET, True),
                    (WHISPER_TARGET, S, False)},
          f"whisper-base: flash_attn saw shapes {sorted(kinds)}")
    check(len(calls) == cfg.encoder_layers + 2 * cfg.num_layers,
          f"whisper-base: flash_attn ran {len(calls)} times")
    errs = [c["err"] for c in calls]
    check(max(errs) <= FLASH_F32_TOL, "whisper-base: the card route of "
          f"flash_attn differs from its plain version: {calls}")
    check(bool(torch.isfinite(loss)), "whisper-base: the loss is not finite")
    out["flash_max_abs_err"] = {
        "encoder_1500x1500": max(c["err"] for c in calls if c["q"] == S),
        "cross_448x1500": max(c["err"] for c in calls
                              if c["q"] != c["kv"]),
        "decoder_self_448": max(c["err"] for c in calls
                                if c["q"] == c["kv"] == WHISPER_TARGET)}
    out["loss_f32"] = loss.item()
    out["peak_device_GB"] = torch.cuda.max_memory_allocated() / 1e9
    del f32
    torch.cuda.empty_cache()
    log("whisper-base:", json.dumps({k: v for k, v in out.items()
                                     if k != "launches"}), card)
    return out


def pixtral_run(model, batch: dict) -> tuple:
    """Prefill the patches and tokens of `batch`, then PHASE10_NEW
    greedy decode steps: (tokens (B, PHASE10_NEW), last logits, prefill
    ms, decode ms a step)."""
    import torch

    B, T = batch["tokens"].shape
    P, V = model.cfg.num_patches, model.cfg.vocab_size
    state = model.init_decode_state(B, P + T + PHASE10_NEW)
    (logits, state), prefill_ms = wall_ms(lambda: model.prefill(batch, state))
    tok = logits[:, :V].argmax(-1)
    out = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(PHASE10_NEW):
        out.append(tok)
        logits, state = model.decode_step(state, tok,
                                          torch.full((B,), P + T + t))
        tok = logits[:, :V].argmax(-1)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / PHASE10_NEW * 1e3
    return torch.stack(out, 1), logits, prefill_ms, step_ms


def phase_pixtral(seed: int, card: str) -> dict:
    """10c: pixtral-12b at published width (module doc)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import global_batch
    from repro_torch.models import DecoderLM, RunFlags
    from repro_torch.models.lm import init_device

    cfg = get_config("pixtral-12b")
    P = cfg.num_patches
    data = global_batch(cfg, 0, PREFILL_PROMPTS, P + PIXTRAL_TEXT, seed=seed)
    batch = {k: torch.from_numpy(data[k]).cuda()
             for k in ("tokens", "patches")}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    flat, weights_ms = wall_ms(lambda: init_device(cfg, seed, "bfloat16"))
    weight_bytes = sum(t.numel() * t.element_size() for t in flat.values())
    model = DecoderLM(cfg, device="cuda").load_flat(flat)
    del flat
    runs = [pixtral_run(model, batch) for _ in range(2)]
    check(torch.equal(runs[0][0], runs[1][0]) and
          torch.equal(runs[0][1], runs[1][1]), "pixtral-12b: a second run "
          "gave other tokens or logits")
    out = {"layers": cfg.num_layers, "weights_GB": weight_bytes / 1e9,
           "weights_s": weights_ms / 1e3, "prompt": [P, PIXTRAL_TEXT],
           "prefill_ms": runs[1][2], "decode_step_ms": runs[1][3],
           "weight_read_floor_ms": weight_bytes / HBM_BYTES_PER_S * 1e3,
           "tokens_per_s": PREFILL_PROMPTS * 1e3 / runs[1][3],
           "first_tokens": runs[1][0][0].tolist(),
           "peak_device_GB": torch.cuda.max_memory_allocated() / 1e9}
    check(bool(torch.isfinite(runs[1][1]).all()), "pixtral-12b: decode "
          "logits are not finite")
    del model, runs
    torch.cuda.empty_cache()
    log(f"pixtral-12b: all {cfg.num_layers} layers at full width, "
        f"{out['weights_GB']:.2f} GB bfloat16 drawn on the card, "
        f"prefill {out['prefill_ms']:.2f} ms, decode step "
        f"{out['decode_step_ms']:.3f} ms against a weight-read floor of "
        f"{out['weight_read_floor_ms']:.3f} ms, peak "
        f"{out['peak_device_GB']:.2f} GB {card}")

    # float32, PIXTRAL_F32_LAYERS layers: one prefill of patches + T tokens
    # against a prefill of patches + T - 8 and 8 decode steps
    cut = dataclasses.replace(cfg, num_layers=PIXTRAL_F32_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    f32 = DecoderLM(cut, RunFlags(dtype="float32")).load_flat(
        init_device(cut, seed + 1, "float32"))
    T, B, V = PIXTRAL_TEXT, PREFILL_PROMPTS, cfg.vocab_size
    want, _ = f32.prefill(batch, f32.init_decode_state(B, P + T,
                                                       torch.float32))
    state = f32.init_decode_state(B, P + T, torch.float32)
    _, state = f32.prefill({"tokens": batch["tokens"][:, :T - 8],
                            "patches": batch["patches"]}, state)
    for t in range(T - 8, T):
        got, state = f32.decode_step(state, batch["tokens"][:, t],
                                     torch.full((B,), P + t))
    a, b = got[:, :V].float(), want[:, :V].float()
    rec = {"layers": PIXTRAL_F32_LAYERS,
           "max_abs_logit_diff": (a - b).abs().max().item(),
           "max_abs_logit": b.abs().max().item(),
           "peak_device_GB": torch.cuda.max_memory_allocated() / 1e9}
    check(torch.equal(a.argmax(-1), b.argmax(-1)), "pixtral-12b: prefill "
          "then decoding gives other greedy tokens than one prefill")
    check(rec["max_abs_logit_diff"] <= PREFILL_BF16_TOL * rec["max_abs_logit"],
          f"pixtral-12b: prefill then decoding differs: {rec}")
    out["prefill_then_decode_f32"] = rec
    del f32, state
    torch.cuda.empty_cache()
    log("pixtral-12b:", json.dumps(out), card)
    return out


def phase_launchers_4b(kernels, work: Path, card: str) -> dict:
    """10d: the reduced train launcher and its --resume for each of
    PHASE10_ARCHS, and the whisper-base serve launcher with --publish."""
    import contextlib
    import io

    import torch

    from repro_torch.launch import train as launch_train

    out = {"train": {}}
    kernels.reset_launches()
    for arch in PHASE10_ARCHS:
        argv = ["--arch", arch, "--reduced", "--steps", "2", "--ckpt-every",
                "2", "--store", str(work / f"launch-{arch}")]
        for extra, start in (([], 0), (["--resume"], 2)):
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                hist = launch_train.main(argv + extra)
            torch.cuda.synchronize()
            text = buf.getvalue().splitlines()
            check(text[0] == f"training {arch} [baseline] from step {start}",
                  f"the {arch} launcher printed {text[0]!r}")
            check(hist[-1]["step"] == start + 2, f"the {arch} launcher "
                  f"stopped at step {hist[-1]['step']}")
            out["train"][f"{arch}{' --resume' if start else ''}"] = {
                "wall_s": time.perf_counter() - t0,
                "last_loss": hist[-1]["loss"]}
    launches = dict(kernels.LAUNCHES)
    res, launches_s, wall = _launch(kernels, ["--arch", "whisper-base",
                                              "--publish"])
    check(res["served"] == res["requests"], "the whisper-base launcher "
          f"served {res['served']} of {res['requests']} requests")
    out["serve_whisper"] = {"wall_s": wall, "served": res["served"],
                            "load_seconds": res["cold_start"]["load_seconds"]}
    out["launches"] = {k: launches[k] + launches_s[k] for k in launches}
    log("launchers:", json.dumps({k: v for k, v in out.items()
                                  if k != "launches"}), card)
    return out


def phase_families_4b(seed: int, kernels, work: Path, card: str) -> dict:
    """Phase 10: (a) xlstm-350m, (b) whisper-base, (c) pixtral-12b, (d)
    the launchers (module doc)."""
    t0 = time.perf_counter()
    xl = phase_xlstm(seed, kernels, work, card)
    wh = phase_whisper(seed, kernels, work, card)
    shutil.rmtree(work, ignore_errors=True)
    px = phase_pixtral(seed, card)
    la = phase_launchers_4b(kernels, work, card)
    out = {"xlstm-350m": xl, "whisper-base": wh, "pixtral-12b": px,
           "launchers": la}
    out["launches"] = {k: xl["launches"][k] + wh["launches"][k]
                       + la["launches"][k] for k in la["launches"]}
    for rec in (xl, wh, la):
        del rec["launches"]
    out["phase_s"] = time.perf_counter() - t0
    log(f"phase 10: {out['phase_s']:.2f} s {card}")
    return out


def start_dryruns(work: Path) -> list:
    """Phase 11c's dry runs in the background, each writing its record
    under `work` and its output to a log there: (command, process, log
    file)."""
    import os
    work.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_DRYRUN_DIR=str(work))
    cmds = [[sys.executable, "-m", "repro_torch.launch.sweep", "--arch",
             "smollm-360m", "--single-pod-only", "--jobs", "3"]]
    cmds += [[sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
              "kimi-k2-1t-a32b", "--shape", "train_4k", "--variant", v]
             for v in KIMI_VARIANTS]
    out = []
    for i, cmd in enumerate(cmds):
        f = open(work / f"dryrun-{i}.log", "w")
        out.append((cmd, subprocess.Popen(
            cmd, cwd=ROOT, env=env, stdout=f, stderr=subprocess.STDOUT,
            preexec_fn=lambda: os.nice(DRYRUN_NICE)), f))
    return out


def stop_dryruns(procs: list) -> None:
    for _, p, f in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
        f.close()


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def int8_moment_bytes(param_shapes, block: int, ranks: int) -> int:
    """One rank's bytes of int8 Adam moments (m and v: int8 q of (R,
    block), float32 scale of (R, 1) per leaf, R the leaf's blocks padded
    to 512 rows) with the rows sharded over `ranks`."""
    from repro_torch.train.optimizer import _SHARD_PAD

    total, stack = 0, [param_shapes]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack += list(node.values())
            continue
        n = 1
        for d in node.shape:
            n *= d
        rows = -(-n // block)
        rows += (-rows) % _SHARD_PAD
        check(rows % ranks == 0, f"{rows} rows do not shard {ranks} ways")
        total += 2 * rows * (block + 4) // ranks
    return total


def int8_sharded_steps(model, cfg, shape, mesh, seed: int,
                       card: str) -> dict:
    """11a under INT8_VARIANT: SHARD_STEPS steps of phase 9's cell
    unsharded, then as DTensors on `mesh`; the losses and every
    moment's q and scale must be equal bit for bit."""
    import numpy as np
    import torch

    from repro_torch.configs import SHAPES
    from repro_torch.data.synthetic import global_batch
    from repro_torch.launch.dryrun import (
        place_batch,
        place_train_state,
        under_policy,
    )
    from repro_torch.launch.variants import get_variant
    from repro_torch.train.optimizer import OptConfig, _flatten, _is_q8, \
        _paths
    from repro_torch.train.step import init_train_state, make_train_step

    policy, _, opt = get_variant(INT8_VARIANT, cfg, SHAPES["train_4k"])
    opt_cfg = OptConfig(**opt)
    check(opt_cfg.moments == "int8", f"{INT8_VARIANT} has "
          f"{opt_cfg.moments} moments")
    step = make_train_step(model, opt_cfg)
    runs = {}
    for name, fn in (("plain", step),
                     ("dtensor", under_policy(step, mesh, policy))):
        state = init_train_state(model, seed, opt_cfg)
        if name == "dtensor":
            state = place_train_state(model, state, mesh, policy, opt_cfg)
        losses, ms = [], []
        for s in range(SHARD_STEPS):
            batch = {k: torch.from_numpy(np.asarray(v)).cuda()
                     for k, v in global_batch(cfg, s, TRAIN_BATCH, TRAIN_SEQ,
                                              seed=seed).items()}
            if name == "dtensor":
                batch = place_batch(model, batch, shape, mesh, policy)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = fn(state, batch)
            loss = metrics["loss"]
            losses.append(float(loss.full_tensor() if name == "dtensor"
                                else loss))
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
        moments = {}
        for key in ("m", "v"):
            for leaf, q8 in zip(_paths(state["opt"][key]),
                                _flatten(state["opt"][key], _is_q8)):
                for part in ("q", "scale"):
                    t = q8[part]
                    moments[f"{key}/{leaf}/{part}"] = t.full_tensor() \
                        if name == "dtensor" else t
        runs[name] = {"losses": losses, "step_ms_all": ms,
                      "step_ms": float(np.median(ms[1:])),
                      "moments": moments}
        del state, metrics, batch
    plain, dt = runs["plain"], runs["dtensor"]
    check(dt["losses"] == plain["losses"], f"{INT8_VARIANT} DTensor losses "
          f"{dt['losses']} are not the unsharded {plain['losses']}")
    check(sorted(dt["moments"]) == sorted(plain["moments"]),
          "the DTensor state's moments are not the unsharded state's")
    for key, t in dt["moments"].items():
        want = plain["moments"][key]
        check(t.dtype == want.dtype and t.shape == want.shape
              and torch.equal(t, want), f"{INT8_VARIANT}: {key} differs "
              f"from the unsharded step's")
    out = {"losses": plain["losses"], "plain_step_ms": plain["step_ms"],
           "dtensor_step_ms": dt["step_ms"],
           "plain_step_ms_all": plain["step_ms_all"],
           "dtensor_step_ms_all": dt["step_ms_all"],
           "moment_tensors": len(plain["moments"]),
           "moment_bytes": sum(t.numel() * t.element_size()
                               for t in plain["moments"].values())}
    log(f"sharding {card}: SmolLM-360M [{INT8_VARIANT}] B={TRAIN_BATCH} "
        f"S={TRAIN_SEQ}, int8 moments ({out['moment_bytes']} bytes): "
        f"{SHARD_STEPS} steps as DTensors on the world-1 NCCL mesh equal "
        f"the unsharded steps bit for bit (losses {plain['losses']}, "
        f"{out['moment_tensors']} q and scale tensors); step "
        f"{out['dtensor_step_ms']:.2f} ms as DTensors beside "
        f"{out['plain_step_ms']:.2f} ms unsharded (median of steps "
        f"2-{SHARD_STEPS})")
    return out


def closed_form_flops(cfg, shape, counts: dict) -> float:
    """6 N_active B S for training, 2 N B S for a prefill, 2 N B for a
    decode step (N: the active parameters without the embeddings)."""
    B, S = shape.global_batch, shape.seq_len
    factor = {"train": 6.0 * B * S, "prefill": 2.0 * B * S,
              "decode": 2.0 * B}[shape.kind]
    return factor * counts["active"]


def phase_sharding(seed: int, train: dict, dryruns: list, work: Path,
                   card: str) -> dict:
    """11: the sharded path on the card (a, b) and the dry runs (c)."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.synthetic import global_batch
    from repro_torch.launch.dryrun import (
        build_step,
        place_batch,
        place_train_state,
        trace,
        under_policy,
    )
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.modelflops import model_flops, param_counts
    from repro_torch.launch.roofline import (
        HBM_BW,
        PEAK_FLOPS,
        count_step,
        roofline_from_costs,
    )
    from repro_torch.launch.variants import get_variant
    from repro_torch.models import build_model
    from repro_torch.sharding.constrain import FORCED
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.step import init_train_state, make_train_step

    out = {}
    cfg = dataclasses.replace(get_config("smollm-360m"),
                              num_layers=TRAIN_LAYERS)
    policy, flags, opt = get_variant("baseline", cfg, SHAPES["train_4k"])
    opt_cfg = OptConfig(**opt)
    shape = ShapeConfig("train_8x512", TRAIN_SEQ, TRAIN_BATCH, "train")
    model = build_model(cfg, flags, device="cuda")
    mf = model_flops(cfg, shape, model.param_shapes())
    check(mf == SMOLLM_TRAIN_FLOPS, f"model_flops {mf!r} is not "
          f"{SMOLLM_TRAIN_FLOPS!r}")
    out["model_flops"] = mf
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        mesh = make_local_mesh(1, 1, device_type="cuda")
        sharded = under_policy(make_train_step(model, opt_cfg), mesh, policy)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = place_train_state(model, init_train_state(model, seed,
                                                          opt_cfg),
                                  mesh, policy, opt_cfg)
        FORCED.clear()
        losses, step_ms = [], []
        for s in range(SHARD_STEPS):
            batch = place_batch(model, {
                k: torch.from_numpy(np.asarray(v)).cuda()
                for k, v in global_batch(cfg, s, TRAIN_BATCH, TRAIN_SEQ,
                                         seed=seed).items()},
                shape, mesh, policy)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if s == 0:
                (state, metrics), costs = count_step(sharded, state, batch)
            else:
                state, metrics = sharded(state, batch)
            losses.append(float(metrics["loss"].full_tensor()))
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
        out["peak_device_bytes"] = torch.cuda.max_memory_allocated()
        out["losses"] = losses
        out["step_ms_all"] = step_ms
        out["step_ms"] = float(np.median(step_ms[1:]))
        ref = train["losses_a"][:SHARD_STEPS]
        out["loss_max_rel_diff"] = max(abs(x - y) / abs(y)
                                       for x, y in zip(losses, ref))
        check(out["loss_max_rel_diff"] <= TRAIN_LOSS_TOL, f"sharded losses "
              f"{losses} differ from phase 9's {ref}")
        out["forced_replications"] = dict(FORCED)
        log(f"sharding {card}: SmolLM-360M [baseline] on a world-1 NCCL "
            f"(1, 1) mesh, DTensor state, B={TRAIN_BATCH} S={TRAIN_SEQ}: "
            f"losses {losses} (phase 9: {ref}, max rel diff "
            f"{out['loss_max_rel_diff']:.3g}); step "
            f"{out['step_ms']:.2f} ms (median of steps 2-{SHARD_STEPS}; "
            f"phase 9 unsharded {train['step_ms']:.2f} ms); forced "
            f"replications {out['forced_replications']}")
        del state, metrics, batch

        roof = roofline_from_costs(costs, 1, mf)
        with FakeTensorMode(allow_non_fake_inputs=True):
            fstep, args = build_step(model, shape, mesh, policy, opt_cfg,
                                     "cuda")
            fake, memory = trace(fstep, args)
        got = (costs.dot_flops, costs.bytes_accessed, costs.collective_bytes)
        want = (fake.dot_flops, fake.bytes_accessed, fake.collective_bytes)
        check(got == want, f"the roofline counted on the card {got} is not "
              f"the fake-tensor trace's {want}")
        check(costs.collective_bytes == 0, "a world-1 step moved "
              "collective bytes")
        measured_s = out["step_ms"] / 1e3
        out["roofline"] = roof.to_dict()
        out["measured_mfu"] = mf / (measured_s * PEAK_FLOPS)
        out["estimate"] = memory
        log(f"sharding {card}: roofline of step 1 counted on the card = "
            f"its fake-tensor trace: {costs.dot_flops:.6e} FLOPs, "
            f"{costs.bytes_accessed:.6e} unfused bytes, "
            f"{costs.collective_bytes} collective bytes, {costs.ops} ops; "
            f"model_flops {mf:.12e}; projection at H100 SXM5 datasheet "
            f"peaks ({PEAK_FLOPS:.4g} FLOP/s, {HBM_BW:.4g} B/s): "
            f"step_time_s {roof.step_time_s:.6f} ({roof.dominant}-bound; "
            f"compute {roof.compute_s * 1e3:.3f} ms, memory "
            f"{roof.memory_s * 1e3:.3f} ms); measured step "
            f"{out['step_ms']:.2f} ms, model_flops / (measured x peak) = "
            f"{100 * out['measured_mfu']:.3f}%; max_memory_allocated "
            f"{out['peak_device_bytes'] / 2**30:.3f} GiB beside the "
            f"trace's per_device_total {memory['per_device_total'] / 2**30:.3f}"
            f" GiB")
        out["int8"] = int8_sharded_steps(model, cfg, shape, mesh, seed, card)
    finally:
        dist.destroy_process_group()

    t0 = time.perf_counter()
    for cmd, p, f in dryruns:
        try:
            rc = p.wait(timeout=max(1.0, DRYRUN_TIMEOUT_S -
                                    (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            rc = None
        f.flush()
        check(rc == 0, f"{' '.join(cmd[2:])} ended with {rc}: "
              f"{(work / Path(f.name).name).read_text()[-2000:]}")
    out["dryrun_wait_s"] = time.perf_counter() - t0
    records = {}
    for path in sorted(work.glob("*_16x16_*.json")):
        rec = json.loads(path.read_text())
        records[path.stem] = rec
    want = [f"smollm-360m_{s}_16x16_baseline"
            for s in ("train_4k", "prefill_32k", "decode_32k")]
    want += [f"kimi-k2-1t-a32b_train_4k_16x16_{v}" for v in KIMI_VARIANTS]
    check(sorted(records) == sorted(want), f"dry-run records "
          f"{sorted(records)}, want {sorted(want)}")
    out["dryruns"] = {}
    for name in want:
        rec = records[name]
        r = rec["roofline"]
        cfg_r = get_config(rec["arch"])
        shape_r = SHAPES[rec["shape"]]
        m = build_model(cfg_r, flags, device="cuda")
        closed = closed_form_flops(cfg_r, shape_r,
                                   param_counts(cfg_r, m.param_shapes()))
        check(rec["chips"] == DRYRUN_CHIPS and r["chips"] == DRYRUN_CHIPS,
              f"{name}: {rec['chips']} chips")
        check(r["model_flops"] == closed, f"{name}: model_flops "
              f"{r['model_flops']!r}, closed form {closed!r}")
        out["dryruns"][name] = {k: rec[k] for k in (
            "memory", "forced_replications", "lower_s", "hlo_bytes",
            "device")} | {"roofline": r}
        log(f"dryrun {name}: roofline projection at H100 SXM5 datasheet "
            f"peaks, {DRYRUN_CHIPS} ranks (fake process group; not a card "
            f"time): compute {r['compute_s'] * 1e3:.3f} ms, memory "
            f"{r['memory_s'] * 1e3:.3f} ms, collective "
            f"{r['collective_s'] * 1e3:.3f} ms -> {r['dominant']}-bound, "
            f"step_time_s {r['step_time_s']:.6f}, mfu {r['mfu']:.6f}, "
            f"useful {r['useful_fraction']:.6f}; flops/rank {r['flops']:.6e},"
            f" unfused bytes/rank {r['bytes']:.6e}, collective bytes/rank "
            f"{r['collective_bytes']:.6e}; memory/rank "
            f"{rec['memory']['per_device_total'] / 2**30:.3f} GiB; forced "
            f"replications {rec['forced_replications']}; traced in "
            f"{rec['lower_s']} s")
    base = records[f"kimi-k2-1t-a32b_train_4k_16x16_{KIMI_VARIANTS[0]}"]
    a2a = records[f"kimi-k2-1t-a32b_train_4k_16x16_{KIMI_VARIANTS[1]}"]
    a2a_bytes = a2a["roofline"]["collective_detail"].get("all-to-all", 0.0)
    check(a2a_bytes > 0, "moe_a2a's record has no all-to-all bytes")
    kinds = sorted(set(base["roofline"]["collective_detail"])
                   | set(a2a["roofline"]["collective_detail"]))
    out["kimi_collectives"] = {
        k: [base["roofline"]["collective_detail"].get(k, 0.0),
            a2a["roofline"]["collective_detail"].get(k, 0.0)]
        for k in kinds}
    log("dryrun kimi-k2-1t-a32b x train_4k collective bytes/rank by kind, "
        "baseline vs moe_a2a (projection, not a card time): "
        + "; ".join(f"{k} {v[0]:.6e} vs {v[1]:.6e}"
                    for k, v in out["kimi_collectives"].items()))
    z8 = records[f"kimi-k2-1t-a32b_train_4k_16x16_{KIMI_VARIANTS[2]}"]
    policy8, _, opt8 = get_variant(KIMI_VARIANTS[2], cfg,
                                   SHAPES["train_4k"])
    opt8 = OptConfig(**opt8)
    ranks = 1
    for axis in policy8.rules["fsdp"]:
        ranks *= {"data": 16, "model": 16}.get(axis, 1)
    kimi = build_model(get_config("kimi-k2-1t-a32b"), flags, device="cuda")
    want8 = int8_moment_bytes(kimi.param_shapes(), opt8.block, ranks)
    check(opt8.moments == "int8" and z8["moment_bytes"] == want8,
          f"{KIMI_VARIANTS[2]}: moment_bytes {z8['moment_bytes']}, the "
          f"formula gives {want8}")
    check(z8["memory"]["argument_bytes"] > want8, f"{KIMI_VARIANTS[2]}: "
          f"argument_bytes do not hold the moments")
    out["kimi_int8"] = {
        "moment_bytes": z8["moment_bytes"], "formula": want8,
        "fsdp_ranks": ranks,
        "forced_replications": z8["forced_replications"],
        "per_device_total": z8["memory"]["per_device_total"],
        "baseline_per_device_total": base["memory"]["per_device_total"]}
    log(f"dryrun kimi-k2-1t-a32b x train_4k [{KIMI_VARIANTS[2]}]: int8 "
        f"moments {z8['moment_bytes']} bytes/rank = 2 R (block + 4) / "
        f"{ranks} summed over the leaves ({want8}); forced replications "
        f"{z8['forced_replications']}; per_device_total "
        f"{z8['memory']['per_device_total'] / 2**30:.3f} GiB beside "
        f"baseline's {base['memory']['per_device_total'] / 2**30:.3f} GiB "
        f"(fake-tensor trace, not a card measurement)")
    return out


# ------------------------------------------------------------- phase 12

def chunk_map(layout, flat: dict, indices) -> dict:
    """{chunk index: hashlib SHA-256 of its bytes in `flat`'s image, or
    None for an all-zero chunk (never stored, never fetched)}."""
    cs = layout.chunk_size
    out = {}
    for i in indices:
        raw = image_bytes(layout, flat, i * cs, cs)
        out[i] = None if raw.count(0) == len(raw) else \
            hashlib.sha256(raw).digest()
    return out


def tensor_chunks(layout, name: str, nbytes: int | None = None) -> range:
    """The chunk indices that the first `nbytes` (default all) of tensor
    `name` span."""
    t = layout.tensors[name]
    n = t.nbytes if nbytes is None else nbytes
    cs = layout.chunk_size
    return range(t.offset // cs, (t.offset + n - 1) // cs + 1)


def _example(kernels, main, argv: list, **kw) -> tuple:
    """One in-process run of an example's main: (its result, the kernel
    launches it made, its wall seconds)."""
    import torch
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = main(argv, **kw)
    torch.cuda.synchronize()
    return res, dict(kernels.LAUNCHES), time.perf_counter() - t0


def example_quickstart(kernels, flat: dict, layout, base_map: dict,
                       work: Path, card: str) -> dict:
    """12a: ``repro_torch.examples.quickstart`` at full width."""
    import numpy as np

    from repro_torch.examples import quickstart

    res, launches, wall = _example(
        kernels, quickstart.main, ["--store", str(work / "quickstart")],
        weights=flat)
    shutil.rmtree(work / "quickstart", ignore_errors=True)
    name = next(k for k in sorted(flat) if k.startswith("g0"))
    check(res["tensor"] == name, f"quickstart fine-tuned {res['tensor']}, "
          f"not {name}")
    ft_t = flat[name] + np.float32(0.01)
    want = quickstart.sha(ft_t)
    rows = flat["embed"].shape[0] // 2
    want_half = quickstart.sha(flat["embed"][:rows])
    check(res["tensor_ok"] and res["tensor_sha256"] == want,
          "quickstart's restore of the fine-tuned tensor differs")
    check(res["half_ok"] and res["half_sha256"] == want_half,
          "quickstart's half shard of embed differs")
    check(res["restore_after_gc_ok"]
          and res["restore_after_gc_sha256"] == want,
          "quickstart's restore after the roll differs")
    half_chunks = tensor_chunks(layout, "embed",
                                rows * flat["embed"][0].nbytes)
    check(res["chunks_touched"] == len(half_chunks),
          f"quickstart touched {res['chunks_touched']} chunks for half of "
          f"embed; the layout says {len(half_chunks)}")
    ft = {**flat, name: ft_t}
    ft_map = {**base_map, **chunk_map(layout, ft,
                                      tensor_chunks(layout, name))}
    base_set = {d for d in base_map.values() if d}
    ft_set = {d for d in ft_map.values() if d}
    check(res["base"]["unique_chunks"] == len(base_set),
          f"base image stored {res['base']['unique_chunks']} chunks, "
          f"hashlib counts {len(base_set)} distinct")
    check(res["fine_tune"]["unique_chunks"] == len(ft_set - base_set),
          f"fine-tune stored {res['fine_tune']['unique_chunks']} chunks; "
          f"{len(ft_set - base_set)} of its chunks are not in the base")
    check(res["migrated_manifests"] == 2 and res["deleted_old_root"]
          and res["migrated_chunks"] == len(base_set | ft_set),
          f"roll migrated {res['migrated_manifests']} manifests, "
          f"{res['migrated_chunks']} chunks (want 2, "
          f"{len(base_set | ft_set)}), deleted {res['deleted_old_root']}")
    out = {k: res[k] for k in ("base", "fine_tune", "tensor",
                               "chunks_touched", "num_chunks",
                               "migrated_manifests", "migrated_chunks")}
    out.update(wall_s=wall, launches=launches)
    log(f"quickstart: {json.dumps(out)} {card}")
    log(f"quickstart: restores and half shard byte-identical, {len(half_chunks)}"
        f" chunks for half of embed, {len(ft_set - base_set)} new chunks of "
        f"the fine-tune; {wall:.2f} s {card}")
    return out


def bits(t):
    """A tensor's bytes as a flat uint8 tensor on its device."""
    import torch
    return t.contiguous().view(torch.uint8).reshape(-1)


def same_bits(got: dict, want: dict) -> list:
    """The paths whose tensors differ in shape, dtype or any bit
    (compared on the card), or lie in only one of the two trees."""
    import torch
    return sorted(k for k in got.keys() | want.keys()
                  if k not in got or k not in want
                  or got[k].shape != want[k].shape
                  or got[k].dtype != want[k].dtype
                  or not torch.equal(bits(got[k]), bits(want[k])))


def example_serve_finetunes(kernels, cfg, flat: dict, layout,
                            base_map: dict, work: Path, card: str) -> dict:
    """12b: ``repro_torch.examples.serve_finetunes``, ten float32
    replicas of full-width SmolLM-360M, each checked against its
    fine-tune as it serves: every tensor bit-equal on the card."""
    import torch

    from repro_torch.core.layout import canonical_paths
    from repro_torch.examples import serve_finetunes
    from repro_torch.models import DecoderLM
    from repro_torch.models.lm import RunFlags

    seen: set = set()
    new_chunks, direct = [], []
    ref = DecoderLM(cfg, RunFlags(dtype="float32"), device="cuda")
    names = sorted(flat)
    base = {k: torch.from_numpy(v).to("cuda") for k, v in flat.items()}

    def on_replica(i, engine, stats, tree):
        victim = names[i % len(names)]
        m = {**base_map, **chunk_map(layout, tree,
                                     tensor_chunks(layout, victim))}
        digests = {d for d in m.values() if d}
        new_chunks.append(len(digests - seen))
        seen.update(digests)
        want = {**base, victim: torch.from_numpy(tree[victim]).to("cuda")}
        bad = same_bits(dict(canonical_paths(engine.model.params)), want)
        check(not bad, f"replica {i}'s restored tree differs from its "
              f"fine-tune ({bad})")
        ref.load_flat(tree)
        direct.append(_serve_direct(
            ref, 1, serve_finetunes.MAX_NEW,
            prompts=[serve_finetunes.PROMPT], max_batch=2, max_len=32)[0])

    res, launches, wall = _example(
        kernels, serve_finetunes.main,
        ["--dtype", "float32", "--store", str(work / "fleet")],
        weights=flat, on_replica=on_replica)
    shutil.rmtree(work / "fleet", ignore_errors=True)
    reps = res["replicas"]
    check(len(reps) == 10, f"{len(reps)} replicas")
    for i, r in enumerate(reps):
        check(r["tokens"] == direct[i], f"replica {i}'s tokens {r['tokens']}"
              f" differ from the directly loaded fine-tune's {direct[i]}")
        check(r["origin_fetches"] == new_chunks[i],
              f"replica {i} made {r['origin_fetches']} origin GETs; "
              f"{new_chunks[i]} of its chunks were in no earlier image")
    fleet = res["fleet"]
    check(fleet["origin_fetches"] == len(seen),
          f"the fleet made {fleet['origin_fetches']} origin GETs for "
          f"{len(seen)} distinct chunks across the ten images")
    after = sum(r["origin_fetches"] for r in
                reps[serve_finetunes.FAIL_BEFORE:])
    out = {"fine_tunes": res["fine_tunes"], "replicas": reps,
           "fleet": fleet, "distinct_chunks": len(seen),
           "origin_gets_after_failure": after,
           "new_chunks_after_failure": sum(
               new_chunks[serve_finetunes.FAIL_BEFORE:]),
           "wall_s": wall, "launches": launches}
    log(f"serve_finetunes: {json.dumps(out)} {card}")
    log(f"serve_finetunes: 10 replicas bit-equal to their fine-tunes "
        f"(every tensor, on the card), tokens equal the directly loaded "
        f"fine-tunes'; fleet origin GETs {fleet['origin_fetches']:.0f} = "
        f"{len(seen)} distinct chunks, {after:.0f} of them after "
        f"{fleet['failed_node']} failed (each a chunk no earlier image "
        f"held); {wall:.2f} s {card}")
    return out


def example_coldstart_drill(kernels, work: Path, card: str) -> dict:
    """12c: ``repro_torch.examples.coldstart_drill`` at its defaults."""
    from repro_torch.examples import coldstart_drill

    res, launches, wall = _example(
        kernels, coldstart_drill.main, ["--store", str(work / "drill")])
    shutil.rmtree(work / "drill", ignore_errors=True)
    ph = res["phases"]
    for name, p in ph.items():
        check(p["rejected"] == 0, f"drill {name}: {p['rejected']} starts "
              "rejected by a serial trace")
    post, cold, steady = (ph[k]["origin_fraction"] for k in (
        "post-recovery", "cold restart", "steady"))
    check(post <= cold, f"drill: post-recovery origin fraction {post} above "
          f"the cold restart's {cold}")
    check(post <= DRILL_RECOVERY_FACTOR * steady + DRILL_RECOVERY_SLACK,
          f"drill: post-recovery origin fraction {post}, steady {steady}")
    out = {"phases": ph, "l1_bytes": res["l1_bytes"], "wall_s": wall,
           "launches": launches}
    for name, p in ph.items():
        log(f"drill {name}: p50 {p['p50_ms']:.4f} ms, p99 "
            f"{p['p99_ms']:.4f} ms (simulated), L1 hit rate "
            f"{p['l1_hit_rate']:.4f}, origin fraction "
            f"{p['origin_fraction']:.6f}, rejected {p['rejected']} {card}")
    log(f"drill: {wall:.2f} s, launches {launches} {card}")
    return out


def example_train_lm(kernels, work: Path, card: str) -> dict:
    """12d: ``repro_torch.examples.train_lm`` for EXAMPLE_TRAIN_STEPS
    steps; the resumed trainer's first loss against an uninterrupted
    trainer run to the same step."""
    from repro_torch.examples import train_lm
    from repro_torch.train.loop import Trainer

    res, launches, wall = _example(
        kernels, train_lm.main, ["--steps", str(EXAMPLE_TRAIN_STEPS),
                                 "--store", str(work / "train")])
    shutil.rmtree(work / "train", ignore_errors=True)
    cfg, loop, _ = train_lm.config(False, EXAMPLE_TRAIN_STEPS)
    saved_a = [c["step"] for c in res["checkpoints"]
               if c["step"] <= res["crash_step"]]
    check(saved_a and res["resumed_step"] == max(saved_a),
          f"resumed at step {res['resumed_step']}; A's checkpoints {saved_a}")
    t0 = time.perf_counter()
    ref = Trainer(cfg, loop, device="cuda").init()
    ref.run(res["resumed_step"] + 1)
    ref_s = time.perf_counter() - t0
    want = ref.history[-1]["loss"]
    first_b = res["losses_b"][0]
    check(first_b[0] == res["resumed_step"] + 1 and first_b[1] == want,
          f"resumed first loss {first_b} differs from the uninterrupted "
          f"trainer's {want!r} at step {res['resumed_step'] + 1}")
    chance = math.log(cfg.vocab_size)
    far = [(st, x) for st, x in res["losses_a"] + res["losses_b"]
           if not abs(x - chance) <= LOSS_CHANCE_TOL]
    check(not far, f"losses off the chance level ln(V) = {chance:.4f} by "
          f"more than {LOSS_CHANCE_TOL}: {far[:5]}")
    steps = res["step_s_a"][1:] + res["step_s_b"][1:]
    out = {k: res[k] for k in ("config", "steps", "param_counts",
                               "crash_step", "resumed_step", "resume_s",
                               "first_loss", "last_loss", "checkpoints",
                               "s_per_step_a", "s_per_step_b")}
    out.update(step_ms_median=1e3 * float(sorted(steps)[len(steps) // 2]),
               learning=res["learning"], chance_loss=chance,
               resumed_first_loss=first_b[1], uninterrupted_loss=want,
               uninterrupted_s=ref_s, wall_s=wall, launches=launches,
               losses_a=res["losses_a"], losses_b=res["losses_b"])
    log(f"train_lm: {json.dumps({k: v for k, v in out.items() if not k.startswith('losses')})} {card}")
    log(f"train_lm: {res['param_counts']['total_with_embed'] / 1e6:.1f} M "
        f"params, crashed at {res['crash_step']}, resumed at "
        f"{res['resumed_step']} with first loss {first_b[1]!r} = the "
        f"uninterrupted trainer's (bitwise); loss {res['first_loss']:.4f} "
        f"-> {res['last_loss']:.4f} (ln V {chance:.4f}; "
        f"{'LEARNING' if res['learning'] else 'not learning'}); "
        f"{out['step_ms_median']:.2f} ms a step (median); {wall:.2f} s "
        f"{card}")
    return out


def phase_examples(seed: int, kernels, work: Path, card: str) -> dict:
    """12: the port's four examples through their ``main``."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.layout import build_layout
    from repro_torch.models import init_flat

    t0 = time.perf_counter()
    work.mkdir(parents=True, exist_ok=True)
    cfg = get_config("smollm-360m")
    flat = init_flat(cfg, seed)
    layout = build_layout(flat, KIB512)
    base_map = chunk_map(layout, flat, range(layout.num_chunks))
    out = {"weights_and_hashes_s": time.perf_counter() - t0}
    out["quickstart"] = example_quickstart(kernels, flat, layout, base_map,
                                           work, card)
    out["serve_finetunes"] = example_serve_finetunes(
        kernels, cfg, flat, layout, base_map, work, card)
    del flat, base_map
    torch.cuda.empty_cache()
    out["coldstart_drill"] = example_coldstart_drill(kernels, work, card)
    out["train_lm"] = example_train_lm(kernels, work, card)
    out["launches"] = {k: sum(out[e]["launches"][k] for e in (
        "quickstart", "serve_finetunes", "coldstart_drill", "train_lm"))
        for k in out["quickstart"]["launches"]}
    out["phase_s"] = time.perf_counter() - t0
    log(f"phase 12: {out['phase_s']:.2f} s, launches {out['launches']} "
        f"{card}")
    return out


def rng_prompt(seed: int, vocab: int) -> list:
    import numpy as np
    return [int(t) for t in
            np.random.default_rng(seed).integers(0, vocab, 8)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    try:
        from repro_torch import kernels
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is missing ({e})",
              file=sys.stderr)
        return 2
    import numpy as np
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.perf_counter()
    tmp = ROOT / "build" / f"smoke-store-{args.seed}"
    work = ROOT / "build" / f"smoke-gc-{args.seed}"
    work7 = ROOT / "build" / f"smoke-launch-{args.seed}"
    work8 = ROOT / "build" / f"smoke-ep-{args.seed}"
    work9 = ROOT / "build" / f"smoke-train-{args.seed}"
    work10 = ROOT / "build" / f"smoke-families-{args.seed}"
    work11 = ROOT / "build" / f"smoke-dryrun-{args.seed}"
    work12 = ROOT / "build" / f"smoke-examples-{args.seed}"
    for d in (tmp, work, work7, work8, work9, work10, work11, work12):
        shutil.rmtree(d, ignore_errors=True)
    dryruns = []
    ended = {}

    def mark(phase: str) -> None:
        ended[phase] = time.perf_counter() - t_all
        log(f"phase {phase} ended at {ended[phase]:.2f} s")
    try:
        smi_line = phase_toolchain(kernels)
        mark("1")
        rng = np.random.default_rng(args.seed)
        rows = phase_kernels(rng, 256, KIB512)
        phase_engine_cases(rng)
        phase_aes_cases(rng)
        erasure_rows = phase_erasure_kernels(rng, kernels)
        rows["parity"] = erasure_rows["parity"]
        mark("2")
        main_path, ctx = phase_main_path(args.seed, kernels, tmp)
        mark("3")
        cut = cut_context(kernels, ctx)
        mark("3-cut")
        l2_path, largest = phase_l2_path(args.seed, kernels, cut)
        rows["gf256"] = time_gf256(rng, *largest,
                                   erasure_rows["gf256_check_err"])
        mark("4")
        storm = phase_peer_storm(args.seed, kernels, cut,
                                 cut["fused_per_restore"])
        mark("5")
        shutil.rmtree(tmp, ignore_errors=True)  # phase 6 has its own store
        gc_roll = phase_gc_roll(args.seed, kernels, cut, work)
        shutil.rmtree(work, ignore_errors=True)
        mark("6")
        del cut
        launcher = phase_launcher(args.seed, kernels, ctx, work7)
        shutil.rmtree(work7, ignore_errors=True)
        mark("7")
        del ctx
        families = phase_families(args.seed)
        ep = phase_ep_restore(args.seed, kernels, work8)
        shutil.rmtree(work8, ignore_errors=True)
        mark("8")
        train = phase_train_resume(args.seed, kernels, work9)
        shutil.rmtree(work9, ignore_errors=True)
        mark("9")
        card = f"[{smi_line.strip()}]"   # every phase-10 time carries it
        dryruns = start_dryruns(work11)
        fam4b = phase_families_4b(args.seed, kernels, work10, card)
        mark("10")
        kernels.reset_launches()
        sharding = phase_sharding(args.seed, train, dryruns, work11, card)
        sharding["launches"] = dict(kernels.LAUNCHES)
        mark("11")
        examples = phase_examples(args.seed, kernels, work12, card)
        shutil.rmtree(work12, ignore_errors=True)
        mark("12")
        launches = {3: main_path["launches"], 4: l2_path["launches"],
                    5: storm["launches"], 6: gc_roll["launches"],
                    7: launcher["launches"], 8: ep["launches"],
                    9: train["launches"], 10: fam4b["launches"],
                    11: sharding["launches"], 12: examples["launches"]}
        for phase, names in PATH_KERNELS.items():
            for name in names:
                check(launches[phase][name] > 0, f"kernel {name} was not "
                      f"launched on the path of phase {phase}")
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        stop_dryruns(dryruns)
        for d in (tmp, work, work7, work8, work9, work10, work11, work12):
            shutil.rmtree(d, ignore_errors=True)
    table = []
    for name, (src, replaces, phase) in TPU_KERNELS.items():
        r = rows[name]
        bound_ms, bound_by = r["bound"]
        # no single PyTorch call computes SHA-256, AES, an XOR reduction
        # over rows or a GF(256) product, so there is no library time
        table.append({"name": name, "route": "cuda", "source": src,
                      "replaces": replaces,
                      "launches": launches[phase][name],
                      "launches_by_phase": {
                          str(p): launches[p][name]
                          for p, names in PATH_KERNELS.items()
                          if name in names or p == 12},
                      "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                      "plain_ms": r["plain_ms"], "bound_ms": bound_ms,
                      "bound_by": bound_by, "library_ms": None})
    summary = {k: v for k, v in main_path.items() if k != "launches"}
    summary["tile_effect"] = rows["tile_effect"]
    summary["parity_call_ms"] = rows["parity"]["call_ms"]
    summary["parity_launch_floor_ms"] = rows["parity"]["launch_floor_ms"]
    summary["l2_path"] = {k: v for k, v in l2_path.items()
                          if k != "launches"}
    summary["peer_storm"] = {k: v for k, v in storm.items()
                             if k != "launches"}
    summary["gc_roll"] = {k: v for k, v in gc_roll.items()
                          if k != "launches"}
    summary["launcher"] = {k: v for k, v in launcher.items()
                           if k != "launches"}
    summary["families"] = families
    summary["ep_restore"] = {k: v for k, v in ep.items()
                             if k not in ("launches", "launches_ep")}
    summary["train"] = {k: v for k, v in train.items() if k != "launches"}
    summary["families_4b"] = {k: v for k, v in fam4b.items()
                              if k != "launches"}
    summary["sharding"] = {k: v for k, v in sharding.items()
                           if k != "launches"}
    summary["examples"] = {k: v for k, v in examples.items()
                           if k != "launches"}
    summary["phases_ended_at_s"] = ended
    summary["smoke_seconds"] = time.perf_counter() - t_all
    log("main path:", json.dumps(summary))
    log(json.dumps({"launches": {f"phase{p}": n
                                 for p, n in launches.items()}}))
    log(json.dumps({"kernels": table}))
    log(smi_line)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
