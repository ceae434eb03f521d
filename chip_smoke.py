#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

Run from the root of a checkout on a machine with an NVIDIA H100::

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase's failure is caught):

1. build every CUDA kernel from ``src/repro_torch/kernels/csrc`` (nvcc,
   in parallel) and print the build time and ptxas' register report;
2. the main path, through the user entry points: ``compress_amr`` of the
   ``run1_z10`` structure at 512³ (two levels, 23/77, seed 10) with
   ``eb = 1e-3 · range`` of the finest level → ``write`` → ``read`` →
   ``read_roi``, all on ``cuda``.  Decoded levels must equal the
   compress-time recon bit for bit, the ROI crops must equal slices of
   them, and ``max|recon − orig|`` over each mask must stay within
   ``eb + 2⁻²²·max|orig|``.  Kernel launch counts are reset just before
   and read just after; every kernel must have launched.  The brick
   shapes the path sends kernels 1 and 2 are recorded.  The read must
   make fewer than 1,000 device launches (``torch.profiler``); the
   finest level's placement (one ``index_copy_`` per shape group) is held
   against a per-brick loop of slice copies on the same decoded bricks
   and timed beside it in turns;
2b. region serving on phase 2's snapshot: ``RegionServer(path,
   device="cuda")`` with a cache of 25 % of the decoded level bytes
   (150,994,944 B at 512³), on the reference bench's workload (six boxes
   of side 170 stepping by 85).  The cold batch (launch counts reset
   before and read after: kernels 2 and 4), the warm batch three times
   (launches, busy share), the uncached ``read_roi`` replay and the cache
   statistics are printed, with warm/cold beside the reference bench's 3×
   bar (printed, not enforced).  Every crop, cold, warm and from a second
   server fed by ``cache_export`` → ``cache_import`` (zero misses), must
   equal ``read_roi`` and the slice of phase 2's decoded levels bit for
   bit.  Then the GSP level of ``tests/card_reference`` is served through
   its whole-level key: kernel 6 must launch, and the crop must equal the
   reference's recon;
2c. multi-part snapshots of phase 2's data.  Each multi-part run is
   read alone (launch counts set to 0 just before it and read just
   after; each kernel on its path must launch), and the single-file
   baselines and timed repeats run outside those windows:
   ``write_multipart(parts=4)`` of phase 2's result, every level's
   ``level_signature`` equal to the single file's, the
   ``MultiPartReader(device="cuda")`` decode equal to phase 2's levels
   bit for bit (kernels 4 and 2) and timed in turns with the single-file
   read, kernel 4's launches per level (wrapper counts; the profiler's
   kernel count beside them), the write timed in turns with the single
   file's; the raw levels through ``ParallelTACZWriter(parts=4)`` in
   thread mode (a CUDA stream per worker; kernels 1 and 3) and in
   spawned processes (kernels 1 and 3 in the workers, whose own counts
   are printed apart as ``process_worker_launches``), against one
   ``TACZWriter``, in turns (the reference bench's 1.5× bar printed, not
   enforced; the single and the thread-mode write also under the
   profiler), each decode equal to phase 2's levels; the GSP level of
   ``tests/card_reference`` through the writer's whole-level key (one
   part owns it; its signature equals the reference's file's and it
   decodes to the reference's recon: kernels 5 and 6); phase 2b's six
   boxes served from the directory (cold: kernels 4 and 2) equal to the
   single-file server's crops, cold and warm (three warm batches, each
   server in turn), and a part-aligned shard server that opens no part
   but its own;
2d. error-bound tuning and distortion-aware serving on phase 2's
   dataset: ``AutoTuner(ds, device="cuda", steps_down=4, steps_up=4)``
   (the reference bench's ``--quick`` rungs) tunes ``hi: psnr>=70``,
   ``lo: psnr>=50`` and ``ps: ps_error<=0.01`` (launch counts set to 0
   just before and read just after: kernels 1 and 3), and
   ``write_variant_set(payload_codec="none")`` writes them through the
   same tuner (read alone again).  Printed: tuning wall s, evaluations
   and compressions, s a level compression, ms a ``measure_metrics``,
   the peak device memory, each variant's bounds, bits and metrics, and
   the bits the ``ps`` variant saves against the cheapest uniform bound
   on the same ladder that meets its target, beside the reference
   bench's 10 % bar (printed, not enforced).  Gates: every variant file
   decodes to the tuner's compress-time recon bit for bit; the metrics
   restated from each decoded variant equal the catalog's exactly, twice
   in a row; every level within its tuned bound.  Then ``serve(set_dir,
   port=0, device="cuda")`` on 127.0.0.1 and the port's ``RegionClient``
   on phase 2b's six boxes: ``psnr>=60`` picks ``hi`` and every crop
   equals ``read_roi`` of ``hi.tacz``; the ``lo`` pin works;
   ``psnr>=500`` and ``psnr==60`` are HTTP 400.  The cold HTTP batch is
   read alone (kernels 2 and 4); cold and warm batches are timed in turns
   beside an in-process ``VariantServer``'s and profiled;
2e. sharded serving, load and SLOs on phase 2's snapshot, every server
   and the router on the card in this process (``sharded_serving``): the
   reference bench's eight boxes tiling the domain, one cache budget
   (1.05 × the largest shard's slice of the working set) for a single
   server and two shard-filtered servers (``ShardMap(["s0", "s1"])``)
   behind ``serve``; ``ShardedRegionRouter(device="cuda")`` over the two;
   the fleet's cold batch read alone (kernels 2 and 4), three warm
   passes each in turns beside the bench's bar (fleet faster; printed,
   not enforced), a warm fleet batch profiled.  Then ``s1`` stopped: the
   fallback read alone, at most one launch of kernel 4 a fallback
   (shard, level) group.  Then the reference load bench's settings
   (Zipf, 32 queries, seed 11, 100 requests/s offered, concurrency 4,
   250 requests, 10 % verified against the port's reader on the card)
   through the mounted router, a ``FleetCollector`` over the fleet and
   the bench's three pinned SLO rules, and the grow run (``s2`` at
   request 125, cache handoff, ``apply_shard_map``).  Gates: every crop
   equals the single server's and the decoded level's slice; shards
   cache only their own keys; no errors, no mismatches, the verdict
   passes, keys handed off and dropped on ``reshard``, the hit rate
   holds within 0.10 across the swap; each of the five stage timers
   (``prequant``, ``branch_score``, ``entropy``, ``compress_level``,
   ``entropy_decode``) observed in phase 2's compress and read;
3. kernels 1-4 against their plain PyTorch versions on the card, at the
   main path's shapes (exact agreement required), with CUDA-event times
   of the kernel, the plain version and, where one PyTorch call computes
   the same function, that call (``library_ms``, a yardstick only).
   Kernel 1 is timed beside its elementwise design (the kernel 1 of
   earlier builds, one thread per element, through its C entry) on the
   main stack, in turns, and both are held against the plain version on
   every brick shape the main path sent it (CUDA-graph times of both).
   Kernel 2 is also held against its plain version on every brick shape
   the main path sent it and on one shape that takes its three-pass
   route, and timed beside that route on the main stack.  Kernel 4's
   chunked decode must equal its own serial walk (forced on every
   payload) and the codes the compressor encoded on every payload of the
   finest level (plus a truncated copy of one), with no payload left to
   the serial walk; it must equal the plain decoder on the payloads of at
   most 16,384 symbols and on the seeded adversarial cases of
   ``kernels.huffdec_cases``; chunk sizes are compared in turns;
4. the TAC path (``she=False``), through the user entry points: the
   ``run2_t3`` structure (Nyx Run2_T3, three levels 2/6/92 %, seed 3) at
   512³ with ``eb = 1e-3 · range`` of the finest level, compressed with
   each of ``lorenzo``, ``lor_reg`` and ``interp``.  The 92 % coarse level
   must take GSP, every level must hold the error bound, and that level
   streamed through ``TACZWriter(strategy="gsp")`` must read back
   (``read``, ``read_roi``, ``verify``) equal to the compress-time recon.
   Launch counts are reset before and read after; kernels 5 and 6 must
   have launched.  Kernel 4 on that level's one GSP payload must equal
   its serial walk and the compress-time codes, settle with no serial
   payload, and is timed there at each chunk size; kernels 1 and 2 are
   held against their plain versions on every brick shape the path sent
   them.
   Kernels 5 and 6 are then held against their plain versions, and
   timed, on the grid that path gives them: the GSP-padded 128³ coarse
   level.  There a launch is about as short as the host's
   cost per call, so they are also timed from a CUDA graph of 100 calls;
5. kernels 5 and 6 against their plain versions on the GSP-padded finest
   level of phase 2's snapshot (512³), at ``tile = shape`` and at the
   reference's default tile ``(8, 128, 128)``.  At ``tile = shape``, on
   the 128³ grid (from CUDA graphs) and at 512³ (events), every design
   is held against the plain version and timed in turns: kernel 5's
   plane walk beside its elementwise design, across units a thread and
   blocks per SM, and with and without its zero test; kernel 6's planes
   route beside its three-pass route (the kernels 5 and 6 of earlier
   builds, through their C entries) and, at 128³, kernel 2's planes
   route on a one-brick stack;
6. the card against the reference's own files: the golden fixtures
   (``tests/golden/{v1,v2_zlib,truncated_tacf}.tacz`` and the two-part
   ``multipart.taczd``) decode on the card to ``expected.npz`` bit for
   bit, and the TAC GSP level of
   ``tests/card_reference`` and its TAC+ snapshot (128³) compress on the
   card to the reference's bytes and decode to the reference's recon;
7. LM serving with an int8 KV cache, through the user entry points:
   deepseek-7b at full width and depth (30 layers, d_model 4096, 6.9 B
   parameters initialised on the card from a seeded generator, each
   layer's leaf at ``1/√fan_in`` as the reference's ``_init_leaf``
   scales a layer), 8 requests of 1,024 prompt tokens and 32 greedy new
   tokens through ``ServingEngine(cfg, RunConfig(kv_quant=True))
   .generate``, then the same with a bf16 cache.  Two paths are each
   driven with the launch counts reset just before and read just after:
   ``generate`` with the int8 cache (kernel 7 exactly ``2 + layers ·
   steps`` times: the prefill cache's K and V stacks, then one fused
   decode write a layer and step; it never launches kernel 8), and a
   full-width bf16 prefill cache through ``quantize_prefill_cache`` and
   ``dequantize_kv`` (kernel 8 must have launched).  Checks: ids in
   range, finite logits, greedy agreement of the two caches ≥ 50 %, the
   dequantized cache within ``scale/2``
   (plus float32 rounding) of the bf16 cache it came from, and
   prefill/decode consistency — the last-position logits of a
   1,024-token prefill against a 1,023-token prefill plus one decode
   step: relative max error ≤ 1e-2 with a bf16 cache on the model's
   first two layers (the reference test's depth and tolerance); at full
   depth the int8 cache's error at most 1e-2 above the bf16 cache's;
   and, with the same weights in float32 at full depth, ≤ 1e-2 with the
   int8 cache (the bf16 cache's reading is printed beside it).  Prefill
   and decode step times and a ``torch.profiler`` breakdown of both are
   printed.  Kernels 7 and 8 are held against their plain versions
   (exactly) and timed at the path's two shapes: the stacked prefill
   cache (kernel 7 in turns with its warp route, the kernel 7 of earlier
   builds) and a decode step's K (one position of one layer, 256 × 128;
   timed from a CUDA graph).  A decode step's write of K and V into one
   layer's int8 cache, fused (``ops.quantize_kv_into``, one launch),
   must equal the composed route (two kernel-7 calls and four slice
   copies, with either route of kernel 7) and the plain version; the
   three are timed from CUDA graphs in turns, and the host's time per
   call of the fused and the composed write in turns;
8. mixture-of-experts serving, through the user entry points, with
   phase 7's traffic: granite-moe-1b-a400m at full width and depth (24
   layers, d_model 1024, 32 experts, top-8, d_ff 512 per expert) and
   qwen3-moe-30b-a3b at full width with 8 of its 48 layers (d_model 2048,
   128 experts, top-8, d_ff 768), each initialised on the card from a
   seeded generator (an expert leaf at one expert matrix's ``1/√fan_in``),
   its ``param_counts`` equal to the reference's figures.  Each int8
   ``generate`` is read alone: kernel 7 exactly ``2 + layers · steps``
   times (770 and 258), kernel 8 never.  Granite also runs the bf16 cache
   (greedy agreement ≥ 50 %), the cache read-back (kernel 8 launched, the
   dequantized cache within ``scale/2`` plus float32 rounding; then
   kernels 7 and 8 and the fused decode write held exactly against their
   plain versions at its head_dim of 64, as in phase 7), and
   prefill/decode consistency at a drop-free capacity (``capacity_factor
   = n_experts / experts_per_token``, 4): phase 7's three gates, the
   float32 one with every token routed as the full prefill routed it (a
   router near-tie that the cache's rounding flips moves a token by a
   whole expert's share; the flipped tokens are counted), and, unpinned,
   the float32 int8 cache at most 1e-2 above the bf16 cache.  Printed
   for both: init s, prefill s, decode ms a step, peak device bytes, and
   a ``torch.profiler`` breakdown of one decode step with the MoE
   layer's routing, dispatch and expert operators named;
9. recurrent-state serving, through the user entry points, with phase 7's
   traffic: rwkv6-7b (32 layers, d_model 4096, 64 heads of 64, d_ff
   14,336, vocab 65,536) and zamba2-2.7b (54 Mamba2 layers in 9 groups of
   6, each group followed by the shared attention block, d_model 2560, 32
   heads of 80, d_inner 5120, 80 SSM heads of 64, state 64), both at full
   width and depth, initialised on the card from a seeded generator, the
   leaves the recurrences read (``mu_*``, ``w0``, ``u_bonus``, ``a_log``,
   ``dt_bias``, ``d_skip``) then redrawn non-zero from a numpy seed
   (``make_card_reference.recurrence_leaf``), ``param_counts`` equal to
   the reference's figures.  Each ``generate`` is read alone: rwkv6-7b
   has no cache, so its int8 and bf16 settings launch neither kernel 7
   nor 8 and give identical ids; zamba2's int8 ``generate`` launches
   kernel 7 exactly ``2 + groups · steps`` = 290 times (its shared
   attention's K and V stacks, then one fused decode write a group and
   step) and kernel 8 never; its greedy agreement with the bf16
   ``generate`` is printed, not gated (random weights give logits flat
   enough for bf16 rounding alone to reorder); its cache read-back
   launches kernel 8 within ``scale/2`` plus float32 rounding, and
   kernels 7 and 8 and the fused decode write are then held exactly
   against their plain versions at its head_dim of 80 (kernel 7's warp
   route: 10 lanes a group is no tile), as in phase 7.  Prefill/decode
   consistency:
   rwkv6-7b ≤ 1e-2 in bf16 at full depth and, with the same weights in
   float32 on its first 8 layers, ≤ 1e-4; zamba2 ≤ 2e-2 with a bf16
   cache on its first two groups (12 layers, the reference test's depth
   and tolerance for this arch), the int8 cache at most 1e-2 above the
   bf16 cache's reading at full depth, and so in float32 too (its decode
   reads the conv state rounded to bf16, as the reference keeps it).
   Printed for both: init s, prefill s, decode ms a step, peak device
   bytes, and a ``torch.profiler`` breakdown of one prefill and one
   decode step with the blocks (``rwkv6_apply``, ``mamba2_apply``,
   ``attention``, ``mlp_apply``) and the WKV / SSD operators named.

10. embedding-input serving, through the user entry points, with phase
   7's traffic fed as frontend embeddings (N(0, 1) · 0.02 from a numpy
   seed, as the reference's stub frontend makes them): musicgen-medium at
   full width and depth (48 layers, d_model 1536, 24 heads of 64, an
   ungated GELU MLP, 1,362,249,216 parameters) and internvl2-76b at full
   width with 16 of its 80 layers (d_model 8192, 64 query and 8 KV heads
   of 128, 14,741,151,744 parameters), ``param_counts`` equal to the
   reference's at both depths and no ``embed`` leaf.  Each run is a
   prefill of 8 × 1,024 embeddings and 32 decode steps of one (8, d)
   embedding each through ``ServingEngine.prefill``/``decode`` with
   ``embeds=``, read alone: the int8 cache launches kernel 7 exactly ``2 +
   layers · 32`` times (1,538 and 514) and kernel 8 never, the bf16 cache
   neither; ``generate`` raises.  Then the cache read-back (kernels 7 and 8
   twice each, within ``scale/2``), ``qdq_exact`` at head_dim 64 and 128,
   and phase 7's consistency gates: the bf16 cache ≤ 1e-2 on two layers,
   int8 ≤ bf16 + 1e-2 at the run's depth, and a float32 witness (musicgen
   at 48 layers, internvl2 at 4) whose bf16-cache reading is at most
   1e-2 and whose int8-cache reading is at most 4.0 times that
   (``roundtrip_rms``, printed: the int8 round trip's RMS error over
   the bf16 one's on Gaussian head vectors, 3.57 at head_dim 64 and 3.89
   at 128).
   Printed: init, prefill s, decode ms a step, a profiled decode step's
   launches and busy share, peak bytes;
11. training on one card, through ``repro_torch.launch.train``, one fixed
   batch of 8 × 1,024 positions with labels (the last position masked)
   from numpy seeds: five AdamW steps of musicgen-medium at full size
   (``remat="layer"``, lr 1e-3, one warmup step; the loss falls,
   ``lm_head`` changes, every loss and norm finite, no kernel launched);
   three steps of its two-replica form (``make_train_step_compressed``,
   state and error feedback replicated, ~41 GB; one under the profiler,
   then two counted): kernels 7 and 8 exactly once a leaf and step (10
   each), the replicas bit-identical after the
   step, and on the last step's ``lm_head`` and ``w_up`` leaves kernels 7
   and 8 equal to their plain versions at group 256 (on the exchange's
   matrix and an odd-length cut of ``lm_head``), the kept residual the
   exchange's and within ``scale/2`` of its group, kernels 7 and 8 timed
   on ``w_up``'s (3,538,944, 256) matrix; three Adafactor steps of
   deepseek-7b cut to 4 of its 30 layers (1,648,398,336 parameters, the
   token embedding's gradient) with two microbatches, whose gradients
   are first held within 2.5e-2 of the one-batch gradients (the CPU
   tests' bf16 gradient tolerance); the loss falls.  Printed: step s,
   tokens/s, peak bytes, a profiled step's launches and busy share,
   ``float32_matmul_precision`` (``"highest"``);
12. the resilient loop on one card, through
   ``repro_torch.launch.train.train_loop`` with a ``checkpoint_dir``:
   musicgen-medium at full width cut to 4 of its 48 layers (116,405,760
   parameters; 8 until the whole script outgrew 1,050 s), float32, AdamW (lr 1e-3, one warmup step), fed by the
   port's ``embedding_batches`` at phase 11's batch shape (seed 31).
   Run (a): 6 steps, a checkpoint every 3 (the loss falls; the restored
   step-6 state equals the saved one bit for bit); run (b): a fresh
   8-step loop resumes at step 6, its stream advanced there (history
   from step 6; profiled: launches, busy share); run (c): a stream that
   raises ``SimulatedFailure`` when step 4's batch is fetched, then a
   loop resumed from step 3, held to (a)'s parameters within
   ``LOOP_RESUME_REL_MAX`` (the bit-exact outcome printed).  Then (a)'s
   state saved and restored once lossless (equal bit for bit) and once
   lossy at ``eb_rel = 1e-4``, each read alone: kernel 5 exactly once
   for each rank-3 lossy leaf on the save and kernel 6 on the restore,
   every lossy leaf within ``eb`` (+ float32 rounding), the moments
   lossless; two leaves' card blobs byte for byte and their card decodes
   bit for bit against the CPU's plain encode and decode; kernels 5 and
   6 against their plain versions at the largest leaf's shape, timed.
   Last, one granite-moe-1b-a400m expert leaf at full shape (``w_up``,
   24 × 32 × 1,024 × 512) through ``core.sz.lorenzo_codes`` and
   ``lorenzo_decode``, the functions the tensor codec calls: kernels 1
   and 2 once each on its ``(32, 1024, 512)`` bricks, equal to their
   plain versions, timed.  Printed: the temporary directory's free
   bytes, each step's synchronized seconds and the watchdog's durations
   (host time around each step call, which returns before its kernels
   end), save and restore seconds, file bytes and their ratio, the save's
   shares in the host copy, kernel 5 and the byte pass (zlib where
   ``zstandard`` is missing), and each run's launch counts
   (``loop_launches`` on the kernel rows);
13. the mesh (``mesh_training``): musicgen-medium at full width, 8 of
   48 layers (229,664,256 parameters), float32, AdamW, phase 11's batch shape
   (seed 37).  Run (a), one process: two steps of the two-replica step
   (``make_train_step_compressed(n_pods=2)``), the exchange's inputs on
   ``TRAIN_EXCHANGE_LEAVES`` recorded at the last step, then one
   lossless ``CheckpointManager.save`` of replica 0.  Run (b): two ranks
   spawned on the one card (``torch.multiprocessing``, gloo, a
   ``file://`` rendezvous in a temporary directory, a 120 s group
   timeout), on the mesh ``(pod=2, data=1, model=1)``, one replica a
   rank, take the same two steps through
   ``make_train_step_compressed(mesh=)``; kernels 7 and 8 must each
   launch once a leaf a step on each rank (read alone: the counts set to
   0 just before each step and read just after); the two ranks'
   parameters must be bit-identical and each leaf within
   ``LOOP_RESUME_REL_MAX`` of its largest magnitude of (a)'s (the
   bit-exact outcome printed); fed (a)'s recorded gradients and
   residuals, the exchange across ranks must equal the one-process
   exchange bit for bit.  Run (c): the ranks restore (a)'s checkpoint
   onto ``(data=2, model=1)`` with ``param_shardings(…,
   rules_for(mesh, RunConfig(fsdp=True)))``; each rank's shard of each
   leaf must equal its slice of the saved tensor bit for bit.  Printed:
   each rank's synchronized step seconds and the exchange's share, the
   bytes that cross a step (int8 codes and float32 scales) beside the
   float32 gradient bytes, each rank's peak device memory and launches
   (``mesh_launches`` on the K7/K8 rows), the restore seconds and each
   rank's local bytes beside the full bytes.  Two ranks share one card:
   nothing crosses a link.

Prints the card's name and power limit, the script's wall time, a
``{"kernels": [...]}`` line and, last, ``{"ok": true, "device": {...}}``.
Without a CUDA device, or outside a checkout, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from dataclasses import replace

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

SHAPE = (512, 512, 512)
DENSITIES = [0.23, 0.77]
TAC_DENSITIES = [0.0202, 0.0556, 0.9242]     # run2_t3: fine → coarse
TAC_ALGORITHMS = ("lorenzo", "lor_reg", "interp")
ROI_BOX = ((100, 228), (200, 264), (0, 512))
PLAIN_K4_MAX_SYMBOLS = 16384
K4_CHUNK_BITS = (64, 128, 256, 512, 1024)    # the chunk-size A/B
K2_THREE_PASS_SHAPE = (2, 2, 128, 256)       # a plane past shared memory
LM_ARCH = "deepseek_7b"
LM_BATCH, LM_PROMPT, LM_NEW = 8, 1024, 32
LM_SEED = 13
QDQ = ("group_quant", "group_dequant")
# phase 8: (arch, layers kept (None: all), (total, active) parameters by
# the reference's param_counts at that depth)
MOE_CASES = (("granite_moe_1b_a400m", None, (1384963072, 478993408)),
             ("qwen3_moe_30b_a3b", 8, (5531797504, 1001949184)))
MOE_SEED = 17
# phase 9: (arch, the widths checked, (total, active) parameters by the
# reference's param_counts); the fields read for each family
RECURRENT_CASES = (("rwkv6_7b", (32, 4096, 64, 14336, 65536),
                    (7534415872, 7534415872)),
                   ("zamba2_2_7b", (54, 6, 2560, 32, 80, 2, 64, 64, 32000),
                    (2422386848, 2422386848)))
RECURRENT_FIELDS = {
    "ssm": ("n_layers", "d_model", "rwkv_head", "d_ff", "vocab_size"),
    "hybrid": ("n_layers", "shared_attn_every", "d_model", "n_heads",
               "head_dim", "ssm_expand", "ssm_head", "ssm_state",
               "vocab_size")}
RECURRENT_SEED = 19
RWKV_F32_LAYERS = 8              # the float32 witness's depth (of 32)
# the WKV / SSD operators (the blocks are NamedBlocks' ranges)
RECURRENT_ATEN_OPS = (
    "aten::einsum", "aten::bmm", "aten::mm", "aten::cumsum", "aten::exp",
    "aten::mul", "aten::_to_copy", "aten::cat")
# phase 10: (arch, layers kept (None: all), parameters by the reference's
# param_counts at that depth and at full depth, layers of the float32
# witness); the embeddings' seed
FRONTEND_CASES = (("musicgen_medium", None, 1362249216, 1362249216, 48),
                  ("internvl2_76b", 16, 14741151744, 69503033344, 4))
FRONTEND_SEED = 23
# the float32 witness's int8-cache reading over its bf16-cache reading,
# at most: read 2.85 (musicgen), 3.31 (internvl2) and 2.87 (deepseek's
# phase 7), below the two round trips' RMS ratio on Gaussian head
# vectors (``roundtrip_rms``: 3.57 at head_dim 64, 3.89 at 128); scales
# twice too coarse double that ratio
F32_INT8_OVER_BF16_MAX = 4.0
# phase 11: one fixed batch of 8 × 1,024 positions; AdamW on
# musicgen-medium (then the two-replica step), Adafactor on deepseek-7b
# cut to 4 of its 30 layers, which brings in the token embedding
TRAIN_SEED = 29
TRAIN_BATCH = (8, 1024)
TRAIN_ADAMW_STEPS, TRAIN_PODS_STEPS, TRAIN_ADAFACTOR_STEPS = 5, 2, 3
TRAIN_PODS = 2
TRAIN_ADAFACTOR_CASE = ("deepseek_7b", 4, 1648398336)
# the exchange's leaves recorded for the exact and residual checks
TRAIN_EXCHANGE_LEAVES = ("lm_head", "layers/mlp/w_up")
# phase 12: train_loop on musicgen-medium at full width cut to 4 of its
# 48 layers (a full-depth float32 checkpoint with AdamW's moments is
# ~16 GB, and its lossy encode a zlib pass on the host; 4, not 8, keeps
# the whole script inside its time limit), float32, from
# embedding_batches at phase 11's batch shape; the lossy checkpoint's
# bound; the two leaves whose card blobs and decodes are held to the
# CPU's plain versions (kernel 6's planes and three-pass routes); one
# expert leaf at full shape for kernels 1 and 2
LOOP_ARCH, LOOP_LAYERS = "musicgen_medium", 4
LOOP_SEED = 31
LOOP_EB_REL = 1e-4
LOOP_HELD_LEAVES = ("layers/attn/wq", "layers/mlp/w_up")
LOOP_EXPERT = ("granite_moe_1b_a400m", "layers/mlp/w_up")
# run (c), resumed from its step-3 checkpoint, against run (a): the same
# kernels on the same inputs from the same state, so only a device
# reduction whose order varied could move a value: each parameter leaf
# within 1e-6 of its largest magnitude (bit-exactness is printed)
LOOP_RESUME_REL_MAX = 1e-6
# phase 13: phase 12's model at 4 of its 48 layers (float32) in phase
# 11's two-replica step, in one process and then as two gloo
# ranks on the one card (NCCL puts no two ranks on one device), each rank
# holding one replica; then the elastic restore onto (data=2, model=1);
# then the plain step in one process (a′) and data-parallel with fsdp on
# (data=2, model=1) (d).  4, not 8, keeps the whole script inside its
# time limit
MESH_LAYERS = 4
MESH_SEED = 37
MESH_PODS, MESH_STEPS = 2, 2
MESH_PG_TIMEOUT_S = 120          # the ranks' process-group timeout
MESH_JOIN_S = 600                # the ranks must end within this
# (d) against (a′): step 1's loss (relative); the gathered step-1
# gradients of TRAIN_EXCHANGE_LEAVES (of each leaf's largest magnitude);
# each rank's shards after step 1 against the one-process AdamW update
# of the gathered gradients on the gathered step-0 parameters (beyond
# one ulp of the value, of the leaf's largest update)
DP_LOSS_REL_MAX, DP_GRAD_REL_MAX, DP_UPDATE_REL_MAX = 1e-6, 1e-5, 1e-6
# the MoE layer's routing, dispatch and expert operators
MOE_ATEN_OPS = ("aten::softmax", "aten::sort", "aten::scatter_add_",
                "aten::searchsorted", "aten::index_copy_",
                "aten::repeat_interleave", "aten::index_add_", "aten::bmm",
                "aten::index", "aten::cat")
# phase 2d: the variant set and the reference bench's --quick rungs
VARIANT_TARGETS = {"hi": "psnr>=70", "lo": "psnr>=50",
                   "ps": "ps_error<=0.01"}
TUNE_STEPS = 4
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
FP32_OPS_PER_S = 67e12           # H100 SXM, outside the tensor cores

KERNELS = {
    "lorenzo3d_codes_batched": ("src/repro_torch/kernels/csrc/lorenzo3d.cu",
                                "src/repro/kernels/lorenzo3d.py:139"),
    "lorenzo3d_recon_batched": ("src/repro_torch/kernels/csrc/lorenzo3d.cu",
                                "src/repro/kernels/lorenzo3d.py:157"),
    "hist": ("src/repro_torch/kernels/csrc/hist.cu",
             "src/repro/kernels/hist.py:41"),
    "huffdec": ("src/repro_torch/kernels/csrc/huffdec.cu",
                "src/repro/kernels/huffdec.py:48"),
    "lorenzo3d_codes": ("src/repro_torch/kernels/csrc/lorenzo3d.cu",
                        "src/repro/kernels/lorenzo3d.py:64"),
    "lorenzo3d_recon": ("src/repro_torch/kernels/csrc/lorenzo3d.cu",
                        "src/repro/kernels/lorenzo3d.py:82"),
    "group_quant": ("src/repro_torch/kernels/csrc/qdq.cu",
                    "src/repro/kernels/qdq.py:43"),
    "group_dequant": ("src/repro_torch/kernels/csrc/qdq.cu",
                      "src/repro/kernels/qdq.py:64"),
}


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    return 1


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def cuda_ms(fn, reps: int, torch) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, after one warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int, torch) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls captured in one
    CUDA graph, so the host's cost per launch, which exceeds a small
    kernel's own time, drops out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_row(name, err, ms, plain_ms, bytes_moved, ops_count, library_ms,
               n_launches, smi, **extra) -> dict:
    b_ms, b_by = bound(bytes_moved, ops_count)
    print(f"kernel {name}: ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"bound_ms={b_ms:.4f} ({b_by}) library_ms={library_ms} "
          f"max_abs_err={err} launches={n_launches} {extra} [{smi}]")
    row = {"name": name, "route": "cuda", "source": KERNELS[name][0],
           "replaces": KERNELS[name][1], "launches": n_launches,
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms}
    check(not row.keys() & extra.keys(), f"{name}: extra keys {extra}")
    return {**row, **extra}


class RecordBrickShapes:
    """Records the (X, Y, Z) brick shapes, with the largest stack of each,
    that callers send kernels 1 and 2 while active:
    ``ops.lorenzo3d_codes_batched`` and ``ops.lorenzo3d_recon_batched``
    are wrapped, and the wrappers still launch and count as before.
    Yields ``{"codes": {...}, "recon": {...}}``."""

    WRAPPED = {"codes": "lorenzo3d_codes_batched",
               "recon": "lorenzo3d_recon_batched"}

    def __init__(self, ops):
        self.ops = ops
        self.shapes = {key: {} for key in self.WRAPPED}

    def __enter__(self):
        self.orig = {}
        for key, fn in self.WRAPPED.items():
            self.orig[key] = orig = getattr(self.ops, fn)

            def recording(t, eb, _orig=orig, _seen=self.shapes[key]):
                n, *brick = t.shape
                _seen[tuple(brick)] = max(n, _seen.get(tuple(brick), 0))
                return _orig(t, eb)
            setattr(self.ops, fn, recording)
        return self.shapes

    def __exit__(self, *exc):
        for key, fn in self.WRAPPED.items():
            setattr(self.ops, fn, self.orig[key])


def k1_elementwise(torch, ops, build, x, eb):
    """A call of kernel 1 as one thread per element (the kernel 1 of
    earlier builds) through its C entry, on ``x``: returns (call,
    output)."""
    out = torch.empty(x.shape, dtype=torch.int64, device=x.device)
    lib = build.library("lorenzo3d")

    def call():
        rc = lib.lorenzo3d_codes_batched_elementwise(
            ops._ptr(x), ops._ptr(out), *x.shape, 2.0 * eb, ops._stream(x))
        check(rc == 0, f"elementwise K1 launch failed with error {rc}")
    return call, out


def check_k1_shapes(torch, ops, ref, build, shapes: dict, eb: float,
                    label: str, smi: str):
    """Kernel 1 against its plain version on seeded values of every
    recorded brick shape (at its largest stack), timed from CUDA graphs
    beside its elementwise design; returns the shapes with their routes
    and times."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    seen = []
    for brick, n in sorted(shapes.items()):
        x = torch.randn((n, *brick), generator=gen, device="cuda") * (300 * eb)
        want = ref.lorenzo3d_codes_batched(x, eb)
        check(torch.equal(ops.lorenzo3d_codes_batched(x, eb), want),
              f"K1 != plain on {label} brick {brick} x {n}")
        old, old_out = k1_elementwise(torch, ops, build, x, eb)
        old()
        check(torch.equal(old_out, want), f"elementwise K1 != plain, {brick}")
        graph = graph_ms(lambda: ops.lorenzo3d_codes_batched(x, eb), 20, torch)
        seen.append({
            "brick": brick, "n": n, "route": ops.codes_route(x),
            "graph_ms": graph,
            "elementwise_graph_ms": graph_ms(old, 20, torch),
            "graph_ms_2": graph_ms(
                lambda: ops.lorenzo3d_codes_batched(x, eb), 20, torch),
            "bound_ms": bound(12 * x.numel(), 12 * x.numel())[0]})
    print(f"K1 == plain on every brick shape of {label} "
          f"[{smi}]: {json.dumps(seen)}")
    return seen


def k2_three_pass(torch, ops, build, codes, eb):
    """A call of kernel 2's three-pass route (the kernel 2 of earlier
    builds) through its C entry, on ``codes``: returns (call, output)."""
    scratch = torch.empty_like(codes)
    out = torch.empty(codes.shape, dtype=torch.float32, device=codes.device)
    lib = build.library("lorenzo3d")

    def call():
        rc = lib.lorenzo3d_recon_batched(
            ops._ptr(codes), ops._ptr(scratch), ops._ptr(out), *codes.shape,
            2.0 * eb, ops._stream(codes))
        check(rc == 0, f"three-pass launch failed with error {rc}")
    return call, out


def k5_call(torch, ops, build, x, eb, design: str, units: int = 0,
            skip_zero: bool = True, blocks_per_sm: int = 0):
    """A call of kernel 5 at ``tile = shape`` through its C entries, on
    ``x``: ``design="walk"`` (the plane walk, with ``units`` a thread, the
    zero test or not, ``blocks_per_sm``; defaults: ``ops``'), or
    ``"elementwise"`` (one thread per element: the kernel 5 of earlier
    builds).  Returns (call, output)."""
    out = torch.empty(x.shape, dtype=torch.int64, device=x.device)
    lib = build.library("lorenzo3d")
    units = units or ops.K5_UNITS
    blocks_per_sm = blocks_per_sm or ops.K5_BLOCKS_PER_SM

    def call():
        if design == "walk":
            rc = lib.lorenzo3d_codes_walk(
                ops._ptr(x), ops._ptr(out), *x.shape, 2.0 * eb, units,
                int(skip_zero), blocks_per_sm, ops._stream(x))
        else:
            rc = lib.lorenzo3d_codes(ops._ptr(x), ops._ptr(out), *x.shape,
                                     *x.shape, 2.0 * eb, ops._stream(x))
        check(rc == 0, f"K5 {design} launch failed with error {rc}")
    return call, out


def k6_call(torch, ops, build, codes, eb, design: str):
    """A call of kernel 6 at ``tile = shape`` through its C entries, on
    ``codes``: ``design="planes"`` (its route now), ``"three_pass"`` (the
    kernel 6 of earlier builds) or ``"k2_planes"`` (kernel 2's planes route
    on a one-brick stack).  Returns (call, output)."""
    scratch = torch.empty_like(codes)
    out = torch.empty(codes.shape, dtype=torch.float32, device=codes.device)
    lib = build.library("lorenzo3d")
    args = (ops._ptr(codes), ops._ptr(scratch), ops._ptr(out))

    def call():
        if design == "planes":
            rc = lib.lorenzo3d_recon_planes(*args, *codes.shape, 2.0 * eb,
                                            ops._stream(codes))
        elif design == "three_pass":
            rc = lib.lorenzo3d_recon(*args, *codes.shape, *codes.shape,
                                     2.0 * eb, ops._stream(codes))
        else:
            rc = lib.lorenzo3d_recon_bricks(*args, 1, *codes.shape, 2.0 * eb,
                                            ops._stream(codes))
        check(rc == 0, f"K6 {design} launch failed with error {rc}")
    return call, out


def k56_turns(torch, ops, ref, build, x, codes, eb, timer,
              smi: str) -> dict:
    """Kernels 5 and 6 at ``tile = shape`` on ``x`` and its ``codes``:
    every design equal to the plain version, then timed in turns with
    ``timer(call)`` (new, earlier, earlier, new); kernel 5's walk across
    units a thread and blocks per SM (up, then down), and with and without
    the zero test (on, off, off, on) at ``ops``' setting; kernel 2's planes
    route on a one-brick stack where its route takes the shape."""
    shape = tuple(x.shape)
    want_c = ref.lorenzo3d_codes(x, eb, shape)
    want_r = ref.lorenzo3d_recon(codes, eb, shape)
    out = {"card": smi, "shape": shape,
           "routes": [ops.codes3d_route(shape, shape),
                      ops.recon3d_route(shape, shape)]}
    k5 = {d: k5_call(torch, ops, build, x, eb, d)
          for d in ("walk", "elementwise")}
    k6_designs = ("planes", "three_pass") + (
        ("k2_planes",) if ops.recon_route(shape) == "planes" else ())
    k6 = {d: k6_call(torch, ops, build, codes, eb, d) for d in k6_designs}
    for name, (call, got) in k5.items():
        call()
        check(torch.equal(got, want_c), f"K5 {name} != plain on {shape}")
    for name, (call, got) in k6.items():
        call()
        check(torch.equal(got, want_r), f"K6 {name} != plain on {shape}")
    for kern, designs, new, old in (("k5", k5, "walk", "elementwise"),
                                    ("k6", k6, "planes", "three_pass")):
        t = {new: [], old: []}
        for d in (new, old, old, new):
            t[d].append(timer(designs[d][0]))
        out[f"{kern}_ms"] = t
    if "k2_planes" in k6:
        out["k2_planes_ms"] = [timer(k6["k2_planes"][0]) for _ in range(2)]
    configs = [(u, b) for u in (1, 2, 4) for b in (1, 2, 4, 8)]
    ab = {f"{u}x{b}": [] for u, b in configs}
    for u, b in configs + configs[::-1]:
        call, got = k5_call(torch, ops, build, x, eb, "walk", u,
                            ops.K5_SKIP_ZERO, b)
        call()
        check(torch.equal(got, want_c), f"K5 walk {u}x{b} != plain")
        ab[f"{u}x{b}"].append(timer(call))
    out["k5_units_x_blocks_per_sm_ms"] = ab
    skip = {"zero_test": [], "no_zero_test": []}
    for on in (True, False, False, True):
        call, got = k5_call(torch, ops, build, x, eb, "walk", 0, on)
        call()
        check(torch.equal(got, want_c), f"K5 walk skip_zero={on} != plain")
        skip["zero_test" if on else "no_zero_test"].append(timer(call))
    out["k5_zero_test_ms"] = skip
    out["zero_share"] = float((x == 0).sum()) / x.numel()
    out["bound_ms"] = bound(12 * x.numel(), 12 * x.numel())[0]
    return out


def k7_warp_route(torch, ops, build, x, group):
    """Kernel 7 on its warp route only (one warp per group; the kernel 7 of
    earlier builds) through its C entry, on ``x``: returns (codes, scales,
    call), the outputs written by one call already made."""
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    s = torch.empty((x.shape[0], x.shape[1] // group), dtype=torch.float32,
                    device=x.device)
    fn = getattr(build.library("qdq"), "group_quant_warp_f32"
                 if x.dtype == torch.float32 else "group_quant_warp_bf16")

    def call():
        rc = fn(ops._ptr(x), ops._ptr(q), ops._ptr(s), s.numel(), group,
                ops._stream(x))
        check(rc == 0, f"warp-route K7 launch failed with error {rc}")
    call()
    return q, s, call


def check_k2_shapes(torch, ops, ref, build, shapes: dict, eb: float,
                    label: str, smi: str):
    """Kernel 2 against its plain version on seeded codes of every recorded
    brick shape (at its largest stack), timed beside its three-pass route;
    returns the shapes with their routes."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    seen = []
    for brick, n in sorted(shapes.items()):
        codes = torch.randint(-2 ** 20, 2 ** 20, (n, *brick), generator=gen,
                              device="cuda")
        want = ref.lorenzo3d_recon_batched(codes, eb)
        check(torch.equal(ops.lorenzo3d_recon_batched(codes, eb), want),
              f"K2 != plain on {label} brick {brick} x {n}")
        three, three_out = k2_three_pass(torch, ops, build, codes, eb)
        three()
        check(torch.equal(three_out, want), f"three-pass != plain, {brick}")
        # from CUDA graphs: a small stack's launch is shorter than the
        # host's cost per call
        seen.append({
            "brick": brick, "n": n, "route": ops.recon_route(brick),
            "graph_ms": graph_ms(
                lambda: ops.lorenzo3d_recon_batched(codes, eb), 20, torch),
            "three_pass_graph_ms": graph_ms(three, 20, torch),
            "bound_ms": bound(12 * codes.numel(), 5 * codes.numel())[0]})
    print(f"K2 == plain on every brick shape of {label} "
          f"[{smi}]: {json.dumps(seen)}")
    return seen


class ForceSerialK4:
    """While active, every ``ops.huffdec`` call walks all its payloads
    serially (the kernel 4 of earlier builds): a same-call A/B of the read
    path."""

    def __init__(self, ops):
        self.ops = ops

    def __enter__(self):
        self.orig = orig = self.ops.huffdec
        self.ops.huffdec = lambda *a, **k: orig(*a, serial=True, **k)

    def __exit__(self, *exc):
        self.ops.huffdec = self.orig


def read_turns(torch, ops, fn) -> dict:
    """Wall seconds of ``fn()`` (ending in a synchronize) in turns:
    chunked K4, K4's serial walk forced, serial, chunked."""
    out = {"chunked_s": [], "serial_walk_s": []}
    for serial in (False, True, True, False):
        with ForceSerialK4(ops) if serial else contextlib.nullcontext():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out["serial_walk_s" if serial else "chunked_s"].append(
                time.perf_counter() - t0)
    return out


def device_profile(torch, fn, count: str | None = None,
                   warm_up: bool = True, aten_ops: tuple = (),
                   ranges: tuple = ()) -> dict:
    """One ``fn()`` under ``torch.profiler`` (after a warm-up, unless the
    caller has just run it): wall ms, summed kernel ms (its share of the
    wall is the device's busy share), the kernel launches and the kernels
    that take most of the time; with ``count``, also the launches of
    kernels whose name holds it; with ``aten_ops``, each named operator's
    calls and the device ms of the kernels it launched; with ``ranges``,
    the same for each ``record_function`` range of that name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if warm_up:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # device-side events only: an operator's own entry also carries the
    # time of the kernels it launched, and a named range's device-side
    # entry spans the kernels inside it, so it is left out of the sums
    ev = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
          and e.key not in ranges]
    ev.sort(key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in ev) / 1e3
    out = {"wall_ms": wall, "kernel_ms": busy, "busy_share": busy / wall,
           "kernel_launches": sum(e.count for e in ev),
           "top": [(e.key[:60], e.self_device_time_total / 1e3, e.count)
                   for e in ev[:8]]}
    if count is not None:
        out[f"{count}_launches"] = sum(e.count for e in ev if count in e.key)
    for key, names in (("aten_ops", aten_ops), ("ranges", ranges)):
        if names:
            by = {e.key: e for e in prof.key_averages()
                  if e.device_type == DeviceType.CPU and e.key in names}
            out[key] = {k: (by[k].count, by[k].device_time_total / 1e3)
                        for k in names if k in by}
    return out


def k4_stats(ops) -> dict:
    s = ops.huffdec_stats.tolist()
    return {"chunks": s[0], "passes": s[1], "serial_payloads": s[2],
            "decoded_per_pass": s[3:]}


def k4_vs_serial(torch, ops, args, label: str, **kw) -> dict:
    """Kernel 4 (chunked) against its own serial walk forced on every
    payload; returns the chunked call's sync statistics."""
    out, err = ops.huffdec(*args, **kw)
    st = k4_stats(ops)
    out_s, err_s = ops.huffdec(*args, serial=True)
    check(torch.equal(out, out_s) and torch.equal(err, err_s),
          f"K4 chunked != its serial walk on {label} {kw}")
    return st


def synced(torch, fn):
    """``(fn(), wall seconds)``, the work ended by a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def placement_turns(torch, tio, path: str, smi: str) -> dict:
    """The reader's batched placement (one ``index_copy_`` per shape
    group) against a per-brick loop of slice copies, written here, on the
    same decoded bricks of the finest level: bit-identical, timed in turns
    (batched, loop, loop, batched) and each under the profiler."""
    with tio.TACZReader(path, device="cuda") as rd:
        e = rd.levels[0]
        groups = [(recon, [e.subblocks[p].origin for p in poss])
                  for poss, recon in rd._decode_groups(
                      0, [(sbi, None) for sbi in range(len(e.subblocks))])]

        def batched():
            acc = torch.zeros(e.grid_shape, dtype=torch.float32,
                              device="cuda")
            rd._place(acc, (0, 0, 0), groups)
            return acc

        def loop():
            acc = torch.zeros(e.grid_shape, dtype=torch.float32,
                              device="cuda")
            for stack, origins in groups:
                for brick, o in zip(stack, origins):
                    acc[tuple(slice(a, a + n) for a, n
                              in zip(o, brick.shape))] = brick
            return acc

        check(torch.equal(batched(), loop()),
              "batched placement != the per-brick loop on the finest level")
        out = {"card": smi, "bricks": len(e.subblocks),
               "groups": len(groups), "batched_s": [], "loop_s": []}
        for name, fn in (("batched_s", batched), ("loop_s", loop),
                         ("loop_s", loop), ("batched_s", batched)):
            out[name].append(synced(torch, fn)[1])
        for name, fn in (("batched", batched), ("loop", loop)):
            prof = device_profile(torch, fn)
            out[f"{name}_launches"] = prof["kernel_launches"]
            out[f"{name}_kernel_ms"] = prof["kernel_ms"]
            out[f"{name}_wall_ms"] = prof["wall_ms"]
    return out


def region_workload() -> list:
    """The reference bench's workload (``benchmarks/bench_region_serving
    ._workload``) at ``SHAPE``: six boxes of a third of the side, stepping
    by half a box, so neighbours share sub-blocks."""
    side = max(4, SHAPE[0] // 3)
    step = max(2, side // 2)
    return [((ox, ox + side), (oy, oy + side), (0, side))
            for ox in (0, step, 2 * step) for oy in (0, step)]


def region_serving(torch, np, ops, tio, path: str, levels, smi: str,
                   ) -> dict:
    """Phase 2b: ``RegionServer`` on phase 2's snapshot, on the card, with
    a cache of 25 % of the decoded level bytes: the cold batch (launch
    counts reset just before and read just after; kernels 2 and 4 must
    launch), the warm batch three times, the uncached ``read_roi`` replay,
    and a second server warmed by ``cache_export`` → ``cache_import``.
    Every crop equals ``read_roi`` and the slice of phase 2's decoded
    levels bit for bit.  Then a GSP level (``tests/card_reference``)
    served through its whole-level key: kernel 6 must launch."""
    from repro_torch.serving import RegionServer

    boxes = region_workload()
    budget = sum(lv.numel() * lv.element_size() for lv in levels) // 4
    out = {"card": smi, "boxes": boxes, "budget_bytes": budget}

    def same(crops, label):
        for per_box in crops:
            for c in per_box:
                want = levels[c.level][tuple(slice(lo, hi) for lo, hi in c.box)]
                check(c.data.is_cuda and torch.equal(c.data, want),
                      f"region serving: {label} crop of level {c.level} "
                      f"box {c.box} != the decoded level's slice")

    with RegionServer(path, cache_bytes=budget, device="cuda") as srv:
        ops.reset_launches()
        cold, out["cold_s"] = synced(torch, lambda: srv.get_regions(boxes))
        out["launches"] = dict(ops.launches)
        out["cold_stats"] = srv.cache.stats()
        ops.reset_launches()
        out["warm_s"] = []
        for _ in range(3):
            warm, t = synced(torch, lambda: srv.get_regions(boxes))
            out["warm_s"].append(t)
        out["warm_launches_3_batches"] = dict(ops.launches)
        out["stats"] = srv.cache.stats()
        check(all(b.is_cuda for b in srv.cache._od.values()),
              "a cached brick is not in device memory")
        out["cache_device_bytes"] = sum(
            b.numel() * b.element_size() for b in srv.cache._od.values())
        out["warm_profile"] = device_profile(
            torch, lambda: srv.get_regions(boxes))
        same(cold, "cold")
        same(warm, "warm")
        blob = srv.cache_export(srv.reader.subblock_keys())
    out["export_bytes"] = len(blob)
    with tio.TACZReader(path, device="cuda") as rd:
        replay, out["read_roi_replay_s"] = synced(
            torch, lambda: [rd.read_roi(b) for b in boxes])
        same(replay, "read_roi")
        for c, r in zip(cold, replay):
            for a, b in zip(c, r):
                check(torch.equal(a.data, b.data),
                      "region serving: cold crop != read_roi")
    with RegionServer(path, cache_bytes=budget, device="cuda") as srv2:
        out["import"] = srv2.cache_import(blob)
        imported, out["imported_warm_s"] = synced(
            torch, lambda: srv2.get_regions(boxes))
        out["imported_stats"] = srv2.cache.stats()
        check(out["imported_stats"]["misses"] == 0,
              f"imported cache missed: {out['imported_stats']}")
        same(imported, "imported-cache")
    warm_med = sorted(out["warm_s"])[1]
    out["warm_over_cold"] = out["cold_s"] / warm_med
    out["reference_bench_bar"] = 3.0
    check(out["launches"]["huffdec"] > 0
          and out["launches"]["lorenzo3d_recon_batched"] > 0,
          f"kernels 2/4 never launched serving regions: {out['launches']}")
    # a whole-level key: the TAC GSP level of tests/card_reference
    gsp = os.path.join(HERE, "tests", "card_reference", "gsp_lorenzo.tacz")
    with np.load(os.path.join(HERE, "tests", "card_reference",
                              "gsp_lorenzo_recon.npz")) as z:
        recon = z["recon"]
    box = ((5, 47), (0, 64), (20, 33))
    with RegionServer(gsp, device="cuda") as srv3:
        ops.reset_launches()
        crop, out["gsp_cold_s"] = synced(torch, lambda: srv3.get_roi(box))
        out["gsp_launches"] = dict(ops.launches)
        warm_crop = srv3.get_roi(box)
    for c in (crop, warm_crop):
        check(np.array_equal(c[0].data.cpu().numpy(), recon[tuple(
            slice(lo, hi) for lo, hi in box)]),
            "region serving: the GSP level's crop != the reference's recon")
    check(out["gsp_launches"]["lorenzo3d_recon"] > 0,
          f"kernel 6 never launched on a whole-level key: "
          f"{out['gsp_launches']}")
    return out


def card_fixture():
    """The module ``tests/card_reference/make_card_reference.py`` (its
    paths, its seeded level and its writer settings)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_card_reference",
        os.path.join(HERE, "tests", "card_reference",
                     "make_card_reference.py"))
    fixture = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fixture)
    return fixture


def in_turns(torch, fns: dict, order: list[str]) -> dict:
    """Wall seconds (ending in a synchronize) of each named ``fn()``, run
    in ``order``; returns ``{name: [seconds, ...]}``."""
    out = {name: [] for name in fns}
    for name in order:
        out[name].append(synced(torch, fns[name])[1])
    return out


def multipart(torch, np, ops, tio, ds, res, eb: float, path: str, levels,
              smi: str) -> dict:
    """Phase 2c: multi-part snapshots of phase 2's data on the card.

    Each multi-part run is read alone: the launch counts are set to 0
    just before it and read just after it, and every kernel on that run's
    path must have launched (``out["launches"][run]``).  The runs are the
    slice write of phase 2's compressed result (``write_multipart(parts=
    4)``; no kernel on its path), the directory read (kernels 4 and 2),
    per level the read of that level (kernel 4 once per part that holds
    some of its payloads), the raw write in thread mode (kernels 1 and 3
    in this process), the raw write in spawned processes (kernels 1 and 3
    in the workers: their own counts, reported at ``close``, are printed
    apart as ``process_worker_launches`` and never added to this
    process's), the GSP level's write and read (kernels 5 and 6) and the
    directory's serving, cold (kernels 4 and 2) and from a part-aligned
    shard server.  The single-file baselines and the repeats timed in
    turns run outside those windows.  Checks: each level's signature
    equals the single file's; every decode equals phase 2's levels bit for
    bit; the GSP level has one owner and decodes to the reference's recon;
    the directory's crops equal the single-file server's, cold and warm;
    the shard server opens only its own part."""
    from repro_torch.io import manifest as mfst
    from repro_torch.serving import RegionServer, ShardMap

    def read_all(src):
        with tio.open_snapshot(src, device="cuda") as rd:
            return rd.read()

    out = {"card": smi, "parts": 4, "launches": {}}

    def window(run: str, fn, needs=()):
        """``fn()`` alone between a reset and a read of the counts."""
        ops.reset_launches()
        got, sec = synced(torch, fn)
        counts = {k: v for k, v in ops.launches.items() if v}
        out["launches"][run] = counts
        for name in needs:
            check(counts.get(name, 0) > 0,
                  f"kernel {name} never launched on the multi-part {run}")
        return got, sec

    tmp = tempfile.TemporaryDirectory(dir=os.path.dirname(path))
    mdir = os.path.join(tmp.name, "compressed.taczd")
    # ---- compressed levels: payload slices under the shared codebooks
    window("write_compressed", lambda: tio.write_multipart(
        mdir, res, parts=4, device="cuda"))
    with tio.TACZReader(path, device="cuda") as srd, \
            tio.open_snapshot(mdir, device="cuda") as mrd:
        check(isinstance(mrd, tio.MultiPartReader), "not a multi-part reader")
        for li in range(srd.n_levels):
            check(mrd.level_signature(li) == srd.level_signature(li),
                  f"multi-part level {li} signature != the single file's")
        out["payloads_per_part"] = [
            [len(idx) for idx in p["levels"]] for p in mrd.manifest["parts"]]
    got, _ = window("read", lambda: read_all(mdir),
                    needs=("huffdec", "lorenzo3d_recon_batched"))
    for li, (g, want) in enumerate(zip(got, levels)):
        check(torch.equal(g, want),
              f"multi-part decode of level {li} != phase 2's level")
    del got
    out["k4_per_level"] = []
    with tio.open_snapshot(mdir, device="cuda") as mrd:
        for li in range(mrd.n_levels):
            window(f"read_level_{li}", lambda: mrd.read_level(li),
                   needs=("huffdec",))
            out["k4_per_level"].append(
                out["launches"][f"read_level_{li}"]["huffdec"])
    out["write_compressed_s"] = in_turns(torch, {
        "single": lambda: tio.write(os.path.join(tmp.name, "one.tacz"), res,
                                    device="cuda"),
        "multi": lambda: tio.write_multipart(mdir, res, parts=4,
                                             device="cuda")},
        ["single", "multi", "multi", "single"])
    out["read_s"] = in_turns(torch, {
        "single": lambda: tio.read(path, device="cuda"),
        "multi": lambda: read_all(mdir)},
        ["single", "multi", "multi", "single"])
    # kernel 4 ends every call with one launch of its serial_kernel
    out["read_profile"] = {
        "single": device_profile(torch, lambda: tio.read(path, device="cuda"),
                                 count="serial_kernel"),
        "multi": device_profile(torch, lambda: read_all(mdir),
                                count="serial_kernel")}

    # ---- raw levels: every part compresses its own bricks
    def single_writer():
        with tio.TACZWriter(os.path.join(tmp.name, "one.tacz"), eb=eb,
                            device="cuda") as w:
            for lvl in ds.levels:
                w.add_level(lvl.data, lvl.mask, ratio=lvl.ratio)

    def parallel(mode):
        def run():
            with tio.ParallelTACZWriter(
                    os.path.join(tmp.name, f"raw-{mode}.taczd"), parts=4,
                    mode=mode, eb=eb, device="cuda") as w:
                for lvl in ds.levels:
                    w.add_level(lvl.data, lvl.mask, ratio=lvl.ratio)
            return w
        return run

    window("write_thread", parallel("thread"),
           needs=("lorenzo3d_codes_batched", "hist"))
    w, _ = window("write_process", parallel("process"))
    per_part = {mfst.part_name(pi): {k: v for k, v in c.items() if v}
                for pi, c in sorted(w.worker_launches.items())}
    out["process_worker_launches"] = per_part
    for name in ("lorenzo3d_codes_batched", "hist"):
        check(sum(c.get(name, 0) for c in per_part.values()) > 0,
              f"kernel {name} never launched in a spawned part worker")
    for name in ("raw-thread.taczd", "raw-process.taczd"):
        got = read_all(os.path.join(tmp.name, name))
        for li, (g, want) in enumerate(zip(got, levels)):
            check(torch.equal(g, want),
                  f"{name}: level {li} != phase 2's level")
    out["write_raw_s"] = in_turns(torch, {
        "single": single_writer, "thread": parallel("thread"),
        "process": parallel("process")},
        ["single", "thread", "process", "process", "thread", "single"])
    got = read_all(os.path.join(tmp.name, "one.tacz"))
    for li, (g, want) in enumerate(zip(got, levels)):
        check(torch.equal(g, want), f"one.tacz: level {li} != phase 2's")
    del got
    out["write_raw_profile"] = {
        name: device_profile(torch, fn) for name, fn in (
            ("single", single_writer), ("thread", parallel("thread")))}
    best = {k: min(v) for k, v in out["write_raw_s"].items()}
    out["speedup_over_single"] = {k: best["single"] / best[k]
                                  for k in ("thread", "process")}
    out["reference_bench_bar"] = 1.5

    # ---- a GSP level through its whole-level key (kernels 5 and 6)
    fixture = card_fixture()
    data, mask, geb = fixture.level()
    gdir = os.path.join(tmp.name, "gsp.taczd")

    def gsp_write():
        with tio.ParallelTACZWriter(gdir, parts=4, eb=geb, device="cuda",
                                    **fixture.WRITER) as w:
            w.add_level(data, mask, ratio=1)
    window("write_gsp", gsp_write, needs=("lorenzo3d_codes",))
    owners = [p["levels"][0] for p in mfst.load(gdir)["parts"]]
    check(sorted(sum(owners, [])) == [0], f"GSP level owners: {owners}")
    with np.load(fixture.RECON) as z:
        want_recon = z["recon"]
    with tio.open_snapshot(gdir, device="cuda") as mrd, \
            tio.TACZReader(fixture.CONTAINER, device="cuda") as srd:
        check(mrd.level_signature(0) == srd.level_signature(0),
              "the GSP level's part != the reference's level")
        recon, _ = window("read_gsp", lambda: mrd.read_level(0),
                          needs=("lorenzo3d_recon",))
        check(np.array_equal(recon.cpu().numpy(), want_recon),
              "the multi-part GSP level != the reference's recon")

    # ---- serving the directory
    boxes = region_workload()
    with RegionServer(mdir, device="cuda") as msrv, \
            RegionServer(path, device="cuda") as ssrv:
        mgot, m_s = window("serve_cold", lambda: msrv.get_regions(boxes),
                           needs=("huffdec", "lorenzo3d_recon_batched"))
        sgot, s_s = synced(torch, lambda: ssrv.get_regions(boxes))
        out["serve_cold_s"] = {"multi": [m_s], "single": [s_s]}
        out["serve_warm_s"] = {"multi": [], "single": []}
        for rep in ("cold", "warm", "warm", "warm"):
            if rep == "warm":
                mgot, m_s = synced(torch, lambda: msrv.get_regions(boxes))
                sgot, s_s = synced(torch, lambda: ssrv.get_regions(boxes))
                out["serve_warm_s"]["multi"].append(m_s)
                out["serve_warm_s"]["single"].append(s_s)
            for per_m, per_s in zip(mgot, sgot):
                for a, b in zip(per_m, per_s):
                    check(a.data.is_cuda and torch.equal(a.data, b.data),
                          f"served {rep} crop of level {a.level} box "
                          f"{a.box}: directory != single file")
        partition = msrv.reader.partition
    m = ShardMap.from_dict(partition)
    sid = sorted(m.shards)[0]
    with RegionServer(mdir, shard_map=m, shard_id=sid, device="cuda") as sh:
        window("serve_shard", lambda: sh.get_regions(boxes))
        out["shard_open_parts"] = sh.reader.open_parts
        check(sh.reader.open_parts in ([], [0]),
              f"shard {sid} opened {sh.reader.open_parts}")
    # per kernel, the sum of its windows' counts (this process only)
    out["launches_total"] = {
        k: sum(c.get(k, 0) for c in out["launches"].values())
        for k in ops.launches}
    out["process_worker_launches_total"] = {
        k: sum(c.get(k, 0) for c in per_part.values()) for k in ops.launches}
    tmp.cleanup()
    return out


def tuning_serving(torch, np, ops, tio, ds, smi: str) -> dict:
    """Phase 2d: error-bound tuning and distortion-aware serving on phase
    2's dataset, on the card.

    ``AutoTuner(device="cuda")`` on the reference bench's ``--quick``
    rungs tunes each of :data:`VARIANT_TARGETS` (launch counts set to 0
    just before and read just after: kernels 1 and 3 must launch), then
    ``write_variant_set`` writes them with ``payload_codec="none"``
    through the same tuner (its own reset and read).  Gates: every
    variant file decodes to the tuner's compress-time recon bit for bit,
    ``measure_metrics`` restated from each decoded variant equals the
    catalog's four numbers exactly and repeats exactly, every level
    within its tuned bound.  The bench's uniform arm (the cheapest single
    bound on the ladder meeting the ``ps`` target) is priced beside the
    tuned ``ps`` variant and the bench's 10 % bar (printed, not
    enforced).  Last, ``serve(set_dir, port=0, device="cuda")`` answers
    the region workload through the port's ``RegionClient``: the target
    ``psnr>=60`` picks ``hi`` and every crop equals ``read_roi`` of
    ``hi.tacz``; the ``lo`` pin works; ``psnr>=500`` and ``psnr==60``
    are HTTP 400.  The cold HTTP batch is read alone (kernels 2 and 4
    must launch), and cold and warm batches are timed in turns beside an
    in-process ``VariantServer``'s, then profiled."""
    import threading

    from repro_torch.core import hybrid
    from repro_torch.io import variants as vrt
    from repro_torch.serving import (RegionAPIError, RegionClient,
                                     VariantServer, serve)
    from repro_torch.tuning import (AutoTuner, measure_metrics,
                                    write_variant_set)
    from repro_torch.tuning.autotune import _measure

    out = {"card": smi, "targets": VARIANT_TARGETS,
           "steps_down": TUNE_STEPS, "steps_up": TUNE_STEPS}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tuner = AutoTuner(ds, device="cuda", steps_down=TUNE_STEPS,
                      steps_up=TUNE_STEPS)

    # 1. tune, read alone
    ops.reset_launches()
    tuned, tune_s = {}, {}
    for name, target in VARIANT_TARGETS.items():
        tuned[name], tune_s[name] = synced(
            torch, lambda target=target: tuner.tune(target))
    out["tune_launches"] = dict(ops.launches)
    out["tune_s"] = tune_s
    out["tune_total_s"] = sum(tune_s.values())
    out["peak_device_bytes_tune"] = torch.cuda.max_memory_allocated()
    out["memo_entries"] = len(tuner._level_memo)
    for name in ("lorenzo3d_codes_batched", "hist"):
        check(out["tune_launches"][name] > 0,
              f"kernel {name} never launched tuning")
    out["variants"] = {name: {
        "target": str(tr.target), "ebs": list(tr.ebs), "bits": tr.bits,
        "metrics": tr.metrics, "evaluations": tr.evaluations,
        "compressions_so_far": tr.compressions,
        "frontier_points": len(tr.frontier.points)}
        for name, tr in tuned.items()}
    out["compressions"] = tuner.compressions

    # one level compression and one measure_metrics, timed apart
    chosen = tuned["lo"].result
    lvl_s = []
    for li, lvl in enumerate(ds.levels):
        _, t = synced(torch, lambda lvl=lvl: hybrid.compress_level(
            lvl.data, lvl.mask, eb=tuned["lo"].ebs[li],
            unit=max(2, tuner.unit // lvl.ratio), ratio=lvl.ratio,
            device="cuda"))
        lvl_s.append(t)
    out["level_compress_s"] = lvl_s
    first, out["measure_metrics_ms"] = synced(
        torch, lambda: measure_metrics(ds, chosen))
    out["measure_metrics_ms"] *= 1e3
    # the tuner's own evaluation reuses the dataset's uniform field and
    # spectrum, computed once a tuner
    again, t = synced(torch, lambda: _measure(ds, chosen, tuner._orig))
    out["measure_cached_reference_ms"] = t * 1e3
    check(first == measure_metrics(ds, chosen) == again
          == tuned["lo"].metrics,
          "measure_metrics is not repeatable on the card")

    # the bench's uniform arm for the ps target
    ladder = [tuner.base_eb * tuner.factor ** k
              for k in range(-TUNE_STEPS, TUNE_STEPS + 1)]
    uniform = None
    t0 = time.perf_counter()
    for eb in sorted(ladder, reverse=True):
        bits, mets = tuner.evaluate([eb] * ds.n_levels)
        if tuned["ps"].target.satisfies(mets):
            uniform = {"eb": eb, "bits": bits, "metrics": mets}
            break
    out["uniform_scan_s"] = time.perf_counter() - t0
    check(uniform is not None, "no uniform bound on the ladder meets the "
                               "ps target")
    out["ps_uniform"] = uniform
    out["ps_bits_saved_pct"] = 100.0 * (1.0 - tuned["ps"].bits
                                        / uniform["bits"])
    out["reference_bench_bar_pct"] = 10.0

    # 2. write the variant set through the same tuner, read alone
    with tempfile.TemporaryDirectory() as tmp:
        set_dir = os.path.join(tmp, "snap.taczv")
        ops.reset_launches()
        _, out["write_s"] = synced(torch, lambda: write_variant_set(
            set_dir, ds, VARIANT_TARGETS, default="lo",
            payload_codec="none", tuner=tuner))
        out["write_launches"] = dict(ops.launches)
        catalog = vrt.load_catalog(set_dir)
        out["file_bytes"] = {v["name"]: os.path.getsize(
            os.path.join(set_dir, v["file"])) for v in catalog["variants"]}
        for entry in catalog["variants"]:
            name = entry["name"]
            tr = tuned[name]
            check(entry["ebs"] == list(tr.ebs) and entry["bits"] == tr.bits,
                  f"variant {name}: catalog row != the tuned point")
            levels = tio.read(os.path.join(set_dir, entry["file"]),
                              device="cuda")
            for li, (got, lr) in enumerate(zip(levels, tr.result.levels)):
                check(torch.equal(got, lr.recon),
                      f"variant {name} level {li}: decode != compress-time "
                      f"recon")
                lvl = ds.levels[li]
                mask = torch.from_numpy(lvl.mask).to("cuda")
                err = float((got - torch.from_numpy(lvl.data).to("cuda"))
                            .abs()[mask].max())
                check(err <= tr.ebs[li] * (1 + 1e-5),
                      f"variant {name} level {li}: max err {err} > "
                      f"{tr.ebs[li]}")
                out["variants"][name].setdefault("max_err", []).append(err)
            decoded = hybrid.AMRCompressionResult(levels=[
                hybrid.LevelResult(**{**lr.__dict__, "recon": r})
                for lr, r in zip(tr.result.levels, levels)],
                method=tr.result.method)
            m1 = measure_metrics(ds, decoded)
            m2 = measure_metrics(ds, decoded)
            check(m1 == m2 == entry["metrics"],
                  f"variant {name}: restated metrics {m1} / {m2} != the "
                  f"catalog's {entry['metrics']}")
            del levels, decoded
        print("tuning: " + json.dumps(out))

        # 3. serve the set over HTTP on the card
        boxes = region_workload()
        budget = 150994944
        hi_path = os.path.join(set_dir, "hi.tacz")
        lo_path = os.path.join(set_dir, "lo.tacz")
        srv = {}
        with tio.TACZReader(hi_path, device="cuda") as rd:
            want_hi = [[c.data.cpu().numpy() for c in rd.read_roi(b)]
                       for b in boxes]
        with tio.TACZReader(lo_path, device="cuda") as rd:
            want_lo = [c.data.cpu().numpy() for c in rd.read_roi(boxes[0])]
        httpd = serve(set_dir, port=0, cache_bytes=budget, device="cuda")
        th = threading.Thread(target=httpd.serve_forever, daemon=True)
        th.start()
        try:
            cli = RegionClient(f"http://127.0.0.1:{httpd.server_address[1]}",
                               timeout=120.0)

            def http_batch():
                header, crops = cli.regions_ex(boxes, target="psnr>=60")
                check(header["variant"] == "hi",
                      f"psnr>=60 picked {header['variant']}, not hi")
                return crops

            ops.reset_launches()
            crops, cold_http = synced(torch, http_batch)
            srv["http_cold_launches"] = dict(ops.launches)
            for b, per in enumerate(crops):
                for c, w in zip(per, want_hi[b]):
                    check(np.array_equal(c.data, w),
                          f"HTTP crop of level {c.level} box {boxes[b]} != "
                          f"read_roi of hi.tacz")
            for name in ("huffdec", "lorenzo3d_recon_batched"):
                check(srv["http_cold_launches"][name] > 0,
                      f"kernel {name} never launched on the cold HTTP batch")
            header, pinned = cli.regions_ex([boxes[0]], variant="lo")
            check(header["variant"] == "lo", f"lo pin: {header['variant']}")
            for c, w in zip(pinned[0], want_lo):
                check(np.array_equal(c.data, w), "lo pin crop != read_roi")
            srv["bodies_400"] = {}
            for bad in ("psnr>=500", "psnr==60"):
                try:
                    cli.regions([boxes[0]], target=bad)
                except RegionAPIError as exc:
                    check(exc.code == 400, f"{bad}: HTTP {exc.code}")
                    srv["bodies_400"][bad] = json.loads(exc.body_excerpt)
                else:
                    check(False, f"{bad} was served")
            with VariantServer(set_dir, cache_bytes=budget,
                               device="cuda") as vs:
                def local_batch():
                    _, name, res = vs.get_regions_ex(boxes,
                                                     target="psnr>=60")
                    return res

                _, cold_local = synced(torch, local_batch)
                turns = in_turns(torch, {"http_warm_s": http_batch,
                                         "local_warm_s": local_batch},
                                 ["http_warm_s", "local_warm_s",
                                  "local_warm_s", "http_warm_s"])
                srv.update(cold_http_s=cold_http, cold_local_s=cold_local,
                           **turns)
                srv["http_warm_profile"] = device_profile(torch,
                                                          http_batch)
                srv["local_warm_profile"] = device_profile(torch,
                                                           local_batch)
            srv["response_bytes"] = sum(c.data.nbytes for per in crops
                                        for c in per)
        finally:
            httpd.shutdown()
            httpd.server_close()
            httpd.region_server.close()
            th.join(timeout=30)
        out["serving"] = srv
    return out


def stage_timer_readings(obsm) -> dict:
    """``{stage: (count, sum s)}`` of the five stage timers in the port's
    registry: ``tacz_compress_stage_seconds`` by stage,
    ``tacz_compress_level_seconds`` over its strategies and
    ``tacz_entropy_decode_seconds``."""
    snap = obsm.REGISTRY.snapshot()
    stages = snap["tacz_compress_stage_seconds"]["series"]
    out = {}
    for stage in ("prequant", "branch_score", "entropy"):
        s = stages.get(f"stage={stage}", {"count": 0, "sum": 0.0})
        out[stage] = (s["count"], s["sum"])
    lv = snap["tacz_compress_level_seconds"]["series"].values()
    out["compress_level"] = (sum(v["count"] for v in lv),
                             sum(v["sum"] for v in lv))
    ed = snap["tacz_entropy_decode_seconds"]["series"].get(
        "_", {"count": 0, "sum": 0.0})
    out["entropy_decode"] = (ed["count"], ed["sum"])
    return out


def timer_delta(after: dict, before: dict) -> dict:
    return {k: {"count": after[k][0] - before[k][0],
                "sum_s": after[k][1] - before[k][1]} for k in after}


def sharded_workload() -> list:
    """The reference bench's working set (``benchmarks/
    bench_sharded_serving._workload``) at ``SHAPE``: eight boxes tiling the
    domain in 2×2×2 halves, so every sub-block is in the working set."""
    h = [max(1, s // 2) for s in SHAPE]
    return [((ox, ox + h[0]), (oy, oy + h[1]), (oz, oz + h[2]))
            for ox in (0, h[0]) for oy in (0, h[1]) for oz in (0, h[2])]


#: the reference bench's pinned SLO set (``benchmarks/bench_loadgen.py``
#: ``SLO_RULES``), as ``(name, kind, op, threshold, params)``
SLO_SPEC = [
    ("errors", "error_rate", "<", 0.001,
     {"metric": "tacz_http_requests_total"}),
    ("tail_spread", "quantile_ratio", "<=", 150.0,
     {"metric": "tacz_server_request_seconds", "q_hi": 0.99, "q_lo": 0.50}),
    ("fleet_up", "up", ">=", 1.0, {}),
]
LOAD_RATE, LOAD_REQUESTS, LOAD_POPULATION = 100.0, 250, 32


def hit_rate(before: list, after: list) -> float:
    """Fleet cache hit rate between two lists of ``cache.stats()``
    (servers added after ``before`` count from zero), as the reference
    bench computes it."""
    hits = misses = 0
    for i, b in enumerate(after):
        a = before[i] if i < len(before) else {"hits": 0, "misses": 0}
        hits += b["hits"] - a["hits"]
        misses += b["misses"] - a["misses"]
    total = hits + misses
    return hits / total if total else 1.0


def sharded_serving(torch, np, ops, tio, path: str, levels, smi: str,
                    dev: str = "cuda") -> dict:
    """Phase 2e: sharded region serving, load and SLOs on phase 2's
    snapshot, every server and the router on the card, in this process.

    1. The reference bench's sharded-vs-single setup: the eight boxes
       tiling the domain, one cache budget for every server (1.05 × the
       largest shard's slice of the working set), a single unsharded
       server behind ``serve`` + ``RegionClient`` against two
       shard-filtered servers behind ``serve`` + ``ShardedRegionRouter``;
       the fleet's cold batch read alone (kernels 2 and 4 must launch),
       three warm passes each in turns, the bench's bar (fleet faster)
       printed, one warm fleet batch profiled.  Gates: every router crop
       equals the single server's and the slice of phase 2's decoded
       levels; each shard caches only keys it owns.
    2. ``s1`` stopped: the crops still equal, the router falls back, and
       the fallback (read alone) makes at most one launch of kernel 4 a
       fallback (shard, level) group.
    3. The reference bench's load and SLO run: a new ``s1``, the router
       mounted behind ``serve``, ``ZipfWorkload(SHAPE, population=32,
       seed=11)`` through ``client_fetch(RegionClient(router_url))`` at
       100 requests/s offered, concurrency 4, 250 requests, 10 % verified
       against the port's reader on the card; a ``FleetCollector`` over
       the two shards and the router, judged by the bench's three pinned
       rules; then the grow run, ``s2`` started at request 125 on
       ``ShardMap.grow``, the moved bricks handed over by
       ``/v1/cache/export`` → ``/v1/cache/import``, the router swapped by
       ``apply_shard_map``.  Gates: no errors and no mismatches in either
       run, the verdict passes, some keys are handed off, the old owners
       drop the moved keys on ``reshard``, and the post-swap hit rate is
       at least the pre-swap rate less 0.10."""
    import threading

    from repro_torch.io.reader import WHOLE_LEVEL
    from repro_torch.obs import FleetCollector, SLOEngine, SLORule
    from repro_torch.serving import (LoadGenerator, RegionClient,
                                     ShardedRegionRouter, ShardMap,
                                     ZipfWorkload, client_fetch, serve)
    from repro_torch.serving.regions import DecodePlanner

    boxes = sharded_workload()
    smap = ShardMap(["s0", "s1"])
    with tio.TACZReader(path, device=dev) as rd:
        plans = DecodePlanner(rd).plan(
            [(li, b) for b in boxes for li in range(rd.n_levels)])
        per_key = {}
        for p in plans:
            for li, sbi in p.keys():
                shape = (rd.levels[li].shape if sbi == WHOLE_LEVEL
                         else rd.subblock_shape(li, sbi))
                per_key[(li, sbi)] = int(np.prod(shape)) * 4
        all_keys = rd.subblock_keys()
    slices = {sid: sum(b for k, b in per_key.items() if smap.owner(k) == sid)
              for sid in smap.shards}
    budget = max(4096, int(1.05 * max(slices.values())))
    out = {"card": smi, "boxes": len(boxes),
           "working_set_bytes": sum(per_key.values()),
           "shard_slice_bytes": slices, "budget_bytes": budget}
    servers: dict = {}

    def start(name: str, **kw) -> str:
        httpd = serve(path, port=0, cache_bytes=budget, device=dev, **kw)
        th = threading.Thread(target=httpd.serve_forever, daemon=True)
        th.start()
        servers[name] = (httpd, th)
        return f"http://127.0.0.1:{httpd.server_address[1]}"

    def stop(name: str) -> None:
        httpd, th = servers.pop(name)
        httpd.shutdown()
        httpd.server_close()
        if name != "router":          # the router closes once, below
            httpd.region_server.close()
        th.join(timeout=30)

    def same(crops, label: str, single_crops=None) -> None:
        for b, per_box in enumerate(crops):
            for i, c in enumerate(per_box):
                want = levels[c.level][tuple(slice(lo, hi)
                                             for lo, hi in c.box)]
                check(c.data.device.type == dev
                      and torch.equal(c.data, want),
                      f"sharded: {label} crop of level {c.level} box "
                      f"{c.box} != the decoded level's slice")
                if single_crops is not None:
                    check(np.array_equal(c.data.cpu().numpy(),
                                         single_crops[b][i].data),
                          f"sharded: {label} crop of level {c.level} box "
                          f"{c.box} != the single server's")

    router = None
    try:
        # 1. sharded against single, the reference bench's setup
        single = RegionClient(start("single"), timeout=300.0)
        urls = {sid: start(sid, shard_map=smap, shard_id=sid)
                for sid in smap.shards}
        router = ShardedRegionRouter(path, smap, urls, device=dev,
                                     timeout=300.0)
        single_crops, out["single_cold_s"] = synced(
            torch, lambda: single.regions(boxes))
        ops.reset_launches()
        cold, out["fleet_cold_s"] = synced(
            torch, lambda: router.get_regions(boxes))
        launches = {"fleet_cold": dict(ops.launches)}
        for name in ("huffdec", "lorenzo3d_recon_batched"):
            check(launches["fleet_cold"][name] > 0,
                  f"kernel {name} never launched on the fleet's cold batch")
        same(cold, "cold", single_crops)
        fleet_warm = single_warm = None

        def fleet_batch():
            nonlocal fleet_warm
            fleet_warm = router.get_regions(boxes)

        def single_batch():
            nonlocal single_warm
            single_warm = single.regions(boxes)

        turns = in_turns(torch, {"single_warm_s": single_batch,
                                 "fleet_warm_s": fleet_batch},
                         ["single_warm_s", "fleet_warm_s", "fleet_warm_s",
                          "single_warm_s", "single_warm_s", "fleet_warm_s"])
        out.update(turns)
        same(fleet_warm, "warm", single_warm)
        med = {k: sorted(v)[1] for k, v in turns.items()}
        out["fleet_over_single"] = med["single_warm_s"] / med["fleet_warm_s"]
        out["reference_bench_bar"] = 1.0
        out["single_stats"] = servers["single"][0].region_server.cache.stats()
        for sid in smap.shards:
            rs = servers[sid][0].region_server
            out[f"{sid}_stats"] = rs.cache.stats()
            owned = {k for k in all_keys if smap.owner(k) == sid}
            check(all((k[1], k[2]) in owned for k in rs.cache._od),
                  f"shard {sid} cached a key it does not own")
            check(all(b.device.type == dev for b in rs.cache._od.values()),
                  f"shard {sid} cached a brick off the card")
        out["fleet_warm_profile"] = device_profile(torch, fleet_batch,
                                                   warm_up=False)
        out["router_counters_warm"] = dict(router.counters)
        check(router.counters["local_fallbacks"] == 0,
              f"the live fleet fell back: {router.counters}")
        del cold, fleet_warm, single_warm, single_crops
        stop("single")

        # 2. one shard down: the fallback, read alone
        stop("s1")
        before = router.counters["local_fallbacks"]
        ops.reset_launches()
        down, out["one_down_s"] = synced(
            torch, lambda: router.get_regions(boxes))
        launches["fallback"] = dict(ops.launches)
        groups = router.counters["local_fallbacks"] - before
        out["fallback_groups"] = groups
        same(down, "one-shard-down")
        del down
        check(groups > 0, "no group fell back with s1 down")
        check(0 < launches["fallback"]["huffdec"] <= groups,
              f"the fallback made {launches['fallback']['huffdec']} K4 "
              f"launches for {groups} (shard, level) groups")
        out["sharded_launches"] = launches

        # 3. load and SLOs, then the grow run
        urls["s1"] = start("s1", shard_map=smap, shard_id="s1")
        router.apply_shard_map(smap, urls)
        rhttpd = serve(router, port=0)
        rth = threading.Thread(target=rhttpd.serve_forever, daemon=True)
        rth.start()
        servers["router"] = (rhttpd, rth)
        router_url = f"http://127.0.0.1:{rhttpd.server_address[1]}"
        client = RegionClient(router_url, timeout=300.0)
        wl = ZipfWorkload(SHAPE, levels=(0,), population=LOAD_POPULATION,
                          seed=11)
        t0 = time.perf_counter()
        for q in wl.queries:              # warm pass, as the bench's
            client.regions([q.box], levels=list(q.levels))
        out["warm_pass_s"] = time.perf_counter() - t0
        col = FleetCollector({**urls, "router": router_url}, window=64,
                             timeout=60.0)
        eng = SLOEngine(col, [SLORule(n, k, op, t, params=p)
                              for n, k, op, t, p in SLO_SPEC])
        col.poll()
        new_map, moved = smap.grow("s2", all_keys)
        grow = {"moved_keys": len(moved), "imported": 0}
        swap_stats: list = []
        shard_names = ["s0", "s1"]

        def fleet_cache() -> list:
            return [dict(servers[n][0].region_server.cache.stats())
                    for n in shard_names]

        def grow_fleet() -> None:
            url2 = start("s2", shard_map=new_map, shard_id="s2")
            shard_names.append("s2")
            dst = RegionClient(url2, timeout=300.0)
            for sid in smap.shards:       # the old owners export
                blob = RegionClient(urls[sid], timeout=300.0).cache_export(
                    moved)
                grow["handoff_bytes"] = grow.get("handoff_bytes", 0) \
                    + len(blob)
                grow["imported"] += dst.cache_import(blob)["imported"]
            router.apply_shard_map(new_map, {**urls, "s2": url2})
            swap_stats.extend(fleet_cache())

        with tio.TACZReader(path, device=dev) as rd:
            gen = LoadGenerator(client_fetch(client), wl, rate=LOAD_RATE,
                                concurrency=4, verify_reader=rd,
                                verify_fraction=0.1, seed=1)
            report = gen.run(LOAD_REQUESTS)
            pre_stats = fleet_cache()
            grow_report = gen.run(LOAD_REQUESTS,
                                  actions={LOAD_REQUESTS // 2: grow_fleet})
            post_stats = fleet_cache()
        col.poll()
        eng.evaluate()
        verdict = eng.verdict()
        dropped = sum(servers[sid][0].region_server.reshard(new_map)
                      for sid in smap.shards)
        pre_rate = hit_rate(pre_stats, swap_stats[:len(pre_stats)])
        post_rate = hit_rate(swap_stats, post_stats)
        out["load"] = {"steady": report.to_dict(),
                       "grow": grow_report.to_dict(),
                       "max_lag_s": [report.max_lag_s,
                                     grow_report.max_lag_s],
                       "errors": [report.error_messages[:3],
                                  grow_report.error_messages[:3]]}
        out["grow"] = {**grow, "reshard_dropped": dropped,
                       "hit_rate_pre": pre_rate, "hit_rate_post": post_rate}
        out["slo"] = verdict
        out["slo_report"] = eng.report()
        out["router_counters"] = dict(router.counters)
        for label, rep in (("steady", report), ("grow", grow_report)):
            check(rep.errors == 0,
                  f"load ({label}): {rep.errors} errors: "
                  f"{rep.error_messages[:3]}")
            check(rep.verified > 0 and rep.mismatches == 0,
                  f"load ({label}): verified {rep.verified}, mismatches "
                  f"{rep.mismatches}")
        check(verdict["passed"], f"pinned SLO set failed: {verdict}")
        check(grow["imported"] > 0, "the grow run handed off no brick")
        check(dropped > 0, "the old owners dropped nothing on reshard")
        check(post_rate >= pre_rate - 0.10,
              f"hit rate fell from {pre_rate} to {post_rate} across the "
              f"swap")
    finally:
        for name in list(servers):
            stop(name)
        if router is not None:
            router.close()
    return out


def card_reference(torch, np, ops, tio, smi: str) -> dict:
    """Phase 6: the card's output held to files the reference wrote.  The
    golden fixtures decode on the card to ``expected.npz`` bit for bit;
    the TAC GSP level of ``tests/card_reference`` (64³, ``lorenzo``,
    written by the reference's host path) compresses on the card to the
    reference's bytes and decodes on the card to the reference's recon,
    with kernels 5 and 6 launched on their ``tile = shape`` routes; so
    does its TAC+ snapshot (128³, two levels; kernels 1-4)."""
    tests = os.path.join(HERE, "tests")
    fixture = card_fixture()
    out = {"card": smi, "golden": {}}
    with np.load(os.path.join(tests, "golden", "expected.npz")) as z:
        expected = {k: z[k] for k in z.files}
    for name in ("v1", "v2_zlib", "truncated_tacf"):
        with tio.TACZReader(os.path.join(tests, "golden", f"{name}.tacz"),
                            device="cuda") as rd:
            check(rd.verify(), f"golden {name}: container CRCs")
            for li in range(rd.n_levels):
                got = rd.read_level(li)
                check(got.is_cuda and np.array_equal(
                    got.cpu().numpy(), expected[f"level{li}"]),
                    f"golden {name} level {li} != expected.npz on the card")
            out["golden"][name] = rd.n_levels
    # the two-part golden snapshot, through its manifest
    ops.reset_launches()
    with tio.open_snapshot(os.path.join(tests, "golden", "multipart.taczd"),
                           device="cuda") as rd:
        check(isinstance(rd, tio.MultiPartReader) and rd.verify(),
              "golden multipart: manifest or part CRCs")
        for li in range(rd.n_levels):
            got = rd.read_level(li)
            check(got.is_cuda and np.array_equal(
                got.cpu().numpy(), expected[f"level{li}"]),
                f"golden multipart level {li} != expected.npz on the card")
        check(rd.frontier.default_point.metrics["psnr"] == 72.0,
              "golden multipart: the manifest's frontier")
        out["golden"]["multipart"] = rd.n_levels
    out["golden_multipart_launches"] = dict(ops.launches)
    with open(fixture.CONTAINER, "rb") as f:
        want_bytes = f.read()
    with np.load(fixture.RECON) as z:
        want_recon = z["recon"]
    data, mask, eb = fixture.level()
    shape = fixture.SHAPE
    out["routes"] = [ops.codes3d_route(shape, shape),
                     ops.recon3d_route(shape, shape)]
    check(out["routes"] == ["walk", "planes"],
          f"K5/K6 routes on the fixture: {out['routes']}")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "card.tacz")
        ops.reset_launches()
        with tio.TACZWriter(path, eb=eb, device="cuda",
                            **fixture.WRITER) as w:
            w.add_level(data, mask, ratio=1)
        out["launches_write"] = dict(ops.launches)
        with open(path, "rb") as f:
            check(f.read() == want_bytes,
                  "the GSP level's file != the reference's bytes")
    ops.reset_launches()
    got, = tio.read(fixture.CONTAINER, device="cuda")
    torch.cuda.synchronize()
    out["launches_read"] = dict(ops.launches)
    check(np.array_equal(got.cpu().numpy(), want_recon),
          "the GSP level read on the card != the reference's recon")
    check(out["launches_write"]["lorenzo3d_codes"] > 0
          and out["launches_read"]["lorenzo3d_recon"] > 0,
          "kernels 5/6 did not run on the fixture")
    out["fixture_bytes"] = len(want_bytes)
    # the TAC+ snapshot: compressed and written on the card, then the
    # reference's file read on the card, each level held by its digest
    from repro_torch.core import amr, hybrid

    with open(fixture.TACPLUS_RECON) as f:
        want_digests = json.load(f)["levels"]
    with open(fixture.TACPLUS_CONTAINER, "rb") as f:
        want_bytes = f.read()
    ds = amr.synthetic_amr(**fixture.TACPLUS)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "tacplus.tacz")
        ops.reset_launches()
        res = hybrid.compress_amr(ds, eb=fixture.finest_eb(ds),
                                  device="cuda")
        tio.write(path, res, payload_codec="none", device="cuda")
        out["tacplus_launches_write"] = dict(ops.launches)
        check([fixture.digest(lr.recon.cpu().numpy()) for lr in res.levels]
              == want_digests, "the TAC+ compress-time recon on the card "
                               "!= the reference's")
        with open(path, "rb") as f:
            check(f.read() == want_bytes,
                  "the TAC+ snapshot's file != the reference's bytes")
    ops.reset_launches()
    got = tio.read(fixture.TACPLUS_CONTAINER, device="cuda")
    out["tacplus_launches_read"] = dict(ops.launches)
    check([fixture.digest(g.cpu().numpy()) for g in got] == want_digests,
          "the TAC+ snapshot read on the card != the reference's recon")
    check(all(out["tacplus_launches_write"][k] > 0 for k in (
        "lorenzo3d_codes_batched", "lorenzo3d_recon_batched", "hist"))
          and out["tacplus_launches_read"]["huffdec"] > 0,
          "kernels 1-4 did not run on the TAC+ snapshot")
    out["tacplus_fixture_bytes"] = len(want_bytes)
    return out


class PinRouting:
    """Routes the MoE layers of later passes as a recorded pass routed
    them.

    ``run(fn, seq, pos0, record)`` runs ``fn`` with
    ``models.moe._route`` (the top-k of each token group) wrapped.  The
    groups of a pass come layer by layer, each layer's groups in token
    order over ``batch`` sequences of ``seq`` positions from ``pos0``.
    A recording pass keeps every token's top-k experts by (layer,
    sequence, position); a later pass sends each token to the experts
    recorded at its (layer, sequence, position), with its own
    probabilities as gates, and counts the tokens whose own top-k set
    differs (``flips``)."""

    def __init__(self, torch, n_layers: int, batch: int):
        from repro_torch.models import moe
        self.torch, self.moe = torch, moe
        self.n_layers, self.batch = n_layers, batch
        self.table = None
        self.flips = 0

    def run(self, fn, seq: int, pos0: int, record: bool):
        torch, orig = self.torch, self.moe._route
        state = {"layer": 0, "offset": 0}
        rows = [[] for _ in range(self.n_layers)]

        def route(probs, k):
            vals, idx = orig(probs, k)
            g, layer, off = probs.shape[0], state["layer"], state["offset"]
            if record:
                rows[layer].append(idx)
            else:
                f = torch.arange(off, off + g, device=probs.device)
                pinned = self.table[layer, f // seq, f % seq + pos0]
                self.flips = self.flips + (
                    idx.sort(1).values != pinned.sort(1).values).any(1).sum()
                idx, vals = pinned, probs.gather(1, pinned)
            state["offset"] = off + g
            if state["offset"] == self.batch * seq:
                state["layer"], state["offset"] = layer + 1, 0
            return vals, idx

        self.moe._route = route
        try:
            out = fn()
        finally:
            self.moe._route = orig
        if record:
            self.table = torch.stack([torch.cat(r).reshape(
                self.batch, seq, -1) for r in rows])
        return out


def prompt_batch(cfg, prompts) -> dict:
    """A prefill or serve step's batch: ``prompts`` as token ids, or as
    frontend embeddings (B, S, d) for an embedding-input config."""
    from repro_torch.models.model import input_key
    return {input_key(cfg): prompts}


def lm_consistency(torch, cfg, params, prompts, run,
                   pin: PinRouting | None = None) -> float:
    """Relative max error between the last-position logits of a prefill
    over all prompt positions (token ids, or embeddings for an
    embedding-input config) and those of a prefill over all but the last
    plus one decode step of the last, with ``run``'s cache.  With
    ``pin``, the full prefill records the MoE routing and the other two
    passes are routed as it routed them."""
    from repro_torch.serving import make_prefill_step, make_serve_step
    from repro_torch.serving.engine import grow_cache

    S = prompts.shape[1]

    def run_pass(fn, seq, pos0, record):
        return fn() if pin is None else pin.run(fn, seq, pos0, record)

    full, _ = run_pass(lambda: make_prefill_step(cfg, run)(
        params, prompt_batch(cfg, prompts)), S, 0, True)
    _, state = run_pass(lambda: make_prefill_step(cfg, run)(
        params, prompt_batch(cfg, prompts[:, :-1])), S - 1, 0, False)
    dec, _ = run_pass(lambda: make_serve_step(cfg, run)(
        params, grow_cache(state, 1, cfg), prompt_batch(cfg, prompts[:, -1:]),
        S - 1),
        1, S - 1, False)
    full, dec = full.float(), dec.float()
    check(bool(torch.isfinite(full).all() and torch.isfinite(dec).all()),
          "non-finite logits")
    return float((full - dec).abs().max() / full.abs().max())


def lm_profile(torch, eng, params, prompts, smi: str) -> dict:
    """``torch.profiler`` over one prefill and over three decode steps
    (see :func:`device_profile`)."""
    logits, state = eng.prefill(params, prompts, LM_PROMPT + 3)
    tok = torch.argmax(logits, dim=-1)

    def decode_3_steps():
        st = state
        for i in range(3):
            _, st = eng.decode(params, st, tok, LM_PROMPT + i)
    return {"card": smi,
            "prefill": device_profile(
                torch, lambda: eng.prefill(params, prompts, LM_PROMPT)),
            "decode_3_steps": device_profile(torch, decode_3_steps)}


def cache_readback(torch, cfg, params, prompts) -> tuple:
    """The cache's conversion and read-back: a bf16 prefill cache of
    ``prompts`` (ids or embeddings) through ``quantize_prefill_cache`` and ``dequantize_kv``,
    the launch counts reset just before and read just after.  Returns
    ``(bf16 cache, every kernel's launches, worst |dequantized − bf16| /
    scale)``, the cache being a hybrid's ``kv`` half; the
    bound is ``1/2 + 2⁻¹⁵`` (half a step, plus the float32 rounding of
    x/scale and of q·scale)."""
    from repro_torch.configs import RunConfig
    from repro_torch.kernels import ops
    from repro_torch.serving import (dequantize_kv, make_prefill_step,
                                     quantize_prefill_cache)

    _, state_b = make_prefill_step(cfg, RunConfig(kv_quant=False))(
        params, prompt_batch(cfg, prompts))
    ops.reset_launches()
    state_q = quantize_prefill_cache(cfg, state_b)
    hybrid = cfg.family == "hybrid"
    cache_b = state_b["kv"] if hybrid else state_b
    cache_q = state_q["kv"] if hybrid else state_q
    deq = {name: dequantize_kv(cache_q[name], cache_q[name + "_scale"],
                               torch.float32) for name in ("k", "v")}
    torch.cuda.synchronize()
    launches = dict(ops.launches)
    del state_b, state_q
    worst = 0.0
    for name in ("k", "v"):
        for li in range(cache_b[name].shape[0]):
            err = (deq[name][li] - cache_b[name][li].float()).abs()
            scale = cache_q[name + "_scale"][li][..., None]
            worst = max(worst, float((err / scale).max()))
        del err
    return cache_b, launches, worst


def composed_write(torch, ops, build, kv_step: dict, cache: dict, pos: int,
                   warp: bool) -> None:
    """The decode write of earlier builds: kernel 7 on K, kernel 7 on V (on
    the route it picks, or with ``warp`` on its warp route), then four
    copies into ``cache`` at position ``pos``."""
    hd = kv_step["k"].shape[-1]
    for name, t in kv_step.items():
        if warp:
            q, s, _ = k7_warp_route(torch, ops, build, t.reshape(-1, hd), hd)
        else:
            q, s = ops.group_quant(t.reshape(-1, hd), hd)
        cache[name][:, pos:pos + 1] = q.reshape(t.shape)
        cache[name + "_scale"][:, pos:pos + 1] = s.reshape(t.shape[:-1])


def qdq_exact(torch, cfg, cache_b: dict, label: str) -> tuple:
    """Kernels 7 and 8 against their plain versions, bit for bit, at a
    serving path's shapes, the group being ``cfg.head_dim``: kernel 7 (on
    the route it picks for that group, and on its warp route) and kernel 8
    on the prefill's K stack ``cache_b["k"]`` and on its first layer's K
    at one position, a decode step's shape; then the fused decode write of
    that step's K and V (one kernel-7 launch) into a full-capacity int8
    layer at position ``LM_PROMPT``, against the composed routes and the
    plain version.  Returns ``(x, kv_step, layer)``: the K stack as
    ``(rows, hd)``, the decode step's ``{"k", "v"}`` and the layer that
    the fused write wrote."""
    from repro_torch.kernels import build, ops, ref
    from repro_torch.models.attention import init_kv_cache

    hd = cfg.head_dim
    x = cache_b["k"].reshape(-1, hd)
    # a decode step's K and V of one layer, (B, 1, H, hd), and one layer's
    # int8 cache at full capacity, written at the first decode position
    kv_step = {n: cache_b[n][0][:, -1:].contiguous() for n in ("k", "v")}
    step_k = kv_step["k"].reshape(-1, hd)
    for where, xs in (("prefill cache", x), ("decode step", step_k)):
        q, s = ops.group_quant(xs, hd)
        q_p, s_p = ref.group_quant(xs, hd)
        check(torch.equal(q, q_p) and torch.equal(s, s_p),
              f"{label}: K7 != plain at the {where} shape")
        q_w, s_w, _ = k7_warp_route(torch, ops, build, xs, hd)
        check(torch.equal(q_w, q_p) and torch.equal(s_w, s_p),
              f"{label}: K7's warp route != plain at the {where} shape")
        d = ops.group_dequant(q, s, hd)
        check(torch.equal(d, ref.group_dequant(q, s, hd)),
              f"{label}: K8 != plain at the {where} shape")
        del q_p, s_p, q_w, s_w, d
        print(f"{label}: K7/K8 == plain at the {where} shape "
              f"{tuple(xs.shape)}")
    capacity = LM_PROMPT + LM_NEW
    B = kv_step["k"].shape[0]
    layer = init_kv_cache(cfg, B, capacity, device=x.device, quantized=True)
    layer_c = {n: t.clone() for n, t in layer.items()}
    layer_w = {n: t.clone() for n, t in layer.items()}
    before = ops.launches["group_quant"]
    ops.quantize_kv_into(kv_step["k"], kv_step["v"], layer, LM_PROMPT)
    check(ops.launches["group_quant"] == before + 1,
          f"{label}: the fused decode write is not one launch")
    composed_write(torch, ops, build, kv_step, layer_c, LM_PROMPT, False)
    composed_write(torch, ops, build, kv_step, layer_w, LM_PROMPT, True)
    for name in layer:
        check(torch.equal(layer[name], layer_c[name])
              and torch.equal(layer[name], layer_w[name]),
              f"{label}: fused decode write != composed route ({name})")
    ref_layer = {n: torch.zeros_like(t) for n, t in layer.items()}
    ref.quantize_kv_into(kv_step["k"], kv_step["v"], ref_layer, LM_PROMPT)
    check(all(torch.equal(layer[n], ref_layer[n]) for n in layer),
          f"{label}: fused decode write != plain")
    print(f"{label}: K7 fused decode write == composed route == plain at "
          f"{tuple(kv_step['k'].shape)} into a {capacity}-position layer")
    return x, kv_step, layer


def step_times(torch, eng, params, prompts, st: dict, tag: str) -> None:
    """Into ``st``: the prefill's seconds and the median decode step's ms
    (and tokens/s) over ``LM_NEW`` greedy steps, each synchronised."""
    import statistics

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, state = eng.prefill(params, prompts, LM_PROMPT + LM_NEW)
    torch.cuda.synchronize()
    st[f"prefill_{tag}_s"] = time.perf_counter() - t0
    tok = torch.argmax(logits, dim=-1)
    steps = []
    for i in range(LM_NEW):
        t0 = time.perf_counter()
        logits, state = eng.decode(params, state, tok, LM_PROMPT + i)
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0) * 1e3)
        tok = torch.argmax(logits, dim=-1)
    check(bool(torch.isfinite(logits.float()).all()), "non-finite logits")
    med = statistics.median(steps)
    st[f"decode_{tag}_ms_per_token"] = med
    st[f"decode_{tag}_tokens_per_s"] = LM_BATCH / med * 1e3


def lm_serving(torch, smi: str) -> list[dict]:
    """Phase 7: LM serving with an int8 KV cache at deepseek-7b's full
    width and depth.  Returns the kernel rows of kernels 7 and 8."""
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.kernels import build, ops, ref
    from repro_torch.models import layers, model
    from repro_torch.serving import ServingEngine

    dev = torch.device("cuda")
    check(torch.get_float32_matmul_precision() == "highest",
          "float32 products must not run as TF32")
    cfg = get_config(LM_ARCH)
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.d_ff, cfg.vocab_size)
          == (30, 4096, 32, 11008, 102400), f"{LM_ARCH} is not full size")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    specs = model.model_specs(cfg)
    params = layers.init_from_specs(
        specs, torch.Generator(device=dev).manual_seed(LM_SEED), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = layers.param_count(specs)
    prompts = torch.randint(
        0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
        generator=torch.Generator().manual_seed(LM_SEED)).to(dev)
    run_q, run_b = RunConfig(kv_quant=True), RunConfig(kv_quant=False)
    eng_q = ServingEngine(cfg, run_q, device=dev)
    eng_b = ServingEngine(cfg, run_b, device=dev)
    st = {"card": smi, "arch": LM_ARCH, "layers": cfg.n_layers,
          "d_model": cfg.d_model, "params": n_params, "batch": LM_BATCH,
          "prompt": LM_PROMPT, "new_tokens": LM_NEW, "init_s": init_s}
    failed = []

    def expect(cond: bool, msg: str) -> None:
        if not cond:
            failed.append(msg)

    # ---- path 1, generate with the int8 cache: counts reset before, read
    # after.  It launches kernel 7 (the prefill cache, then each decode
    # step's K and V per layer) and never kernel 8: decode folds the
    # scales into the scores, as the reference does
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    ids_q = eng_q.generate(params, prompts, new_tokens=LM_NEW)
    torch.cuda.synchronize()
    st["generate_int8_s"] = time.perf_counter() - t0
    st["peak_device_bytes_generate_int8"] = torch.cuda.max_memory_allocated()
    per_generate = {k: ops.launches[k] for k in QDQ}
    st["launches_per_generate"] = per_generate
    # the prefill cache's K and V stacks, then one fused write a layer and
    # a decode step
    want_k7 = 2 + cfg.n_layers * LM_NEW
    expect(per_generate["group_quant"] == want_k7,
           f"kernel group_quant launched {per_generate['group_quant']} "
           f"times by generate, not {want_k7}")
    t0 = time.perf_counter()
    ids_b = eng_b.generate(params, prompts, new_tokens=LM_NEW)
    torch.cuda.synchronize()
    st["generate_bf16_s"] = time.perf_counter() - t0
    for ids in (ids_q, ids_b):
        check(tuple(ids.shape) == (LM_BATCH, LM_NEW), f"ids {ids.shape}")
        check(int(ids.min()) >= 0 and int(ids.max()) < cfg.vocab_size,
              "generated ids out of range")
    st["greedy_agreement"] = float((ids_q == ids_b).float().mean())
    expect(st["greedy_agreement"] >= 0.5,
           f"int8 and bf16 caches agree on {st['greedy_agreement']} < 0.5")

    # ---- path 2, the cache's conversion and read-back
    cache_b, readback, worst = cache_readback(torch, cfg, params, prompts)
    per_readback = {k: readback[k] for k in QDQ}
    st["launches_per_cache_readback"] = per_readback
    expect(per_readback["group_dequant"] > 0,
           "kernel group_dequant never launched by dequantize_kv")
    st["dequant_err_over_scale"] = worst
    expect(worst <= 0.5 + 2.0 ** -15, f"dequant error {worst} · scale")

    # ---- prefill/decode consistency.  The reference holds it at 1e-2 on
    # two layers with a bf16 cache; over 30 bf16 layers the two paths'
    # own roundings drift further apart, so at full depth the int8 cache
    # is held to add at most 1e-2 to what the bf16 cache gives, and the
    # float32 run at the end holds it to 1e-2 without that drift
    cut = replace(cfg, n_layers=2)
    cut_params = dict(params, layers={
        blk: {k: w[:2] for k, w in leaves.items()}
        for blk, leaves in params["layers"].items()})
    for depth, c, p in ((2, cut, cut_params), (cfg.n_layers, cfg, params)):
        for tag, run in (("int8", run_q), ("bf16", run_b)):
            st[f"consistency_rel_{tag}_{depth}_layers"] = lm_consistency(
                torch, c, p, prompts, run)
    del cut_params
    rel2 = st["consistency_rel_bf16_2_layers"]
    expect(rel2 <= 1e-2, f"two-layer bf16 consistency {rel2} > 1e-2")
    rel_q = st[f"consistency_rel_int8_{cfg.n_layers}_layers"]
    rel_b = st[f"consistency_rel_bf16_{cfg.n_layers}_layers"]
    expect(rel_q <= rel_b + 1e-2,
           f"int8 consistency {rel_q} > bf16's {rel_b} + 1e-2")

    # ---- step times: prefill, and each decode step, synchronised
    for tag, eng in (("int8", eng_q), ("bf16", eng_b)):
        step_times(torch, eng, params, prompts, st, tag)
    print("LM serving: " + json.dumps(st))
    print("LM serving, device time by kernel: " + json.dumps(
        lm_profile(torch, eng_q, params, prompts, smi)))

    # ---- kernels 7 and 8 against their plain versions at the path's shapes
    rows = []
    hd = cfg.head_dim
    x, kv_step, layer = qdq_exact(torch, cfg, cache_b, LM_ARCH)
    step_k = kv_step["k"].reshape(-1, hd)

    def fused():
        ops.quantize_kv_into(kv_step["k"], kv_step["v"], layer, LM_PROMPT)

    n, rows_n = x.numel(), x.shape[0]
    # the prefill stack, in turns: tile route, warp route (the K7 of
    # earlier builds), warp route, tile route
    _, _, k7_warp_call = k7_warp_route(torch, ops, build, x, hd)
    k7_ms = cuda_ms(lambda: ops.group_quant(x, hd), 20, torch)
    k7_warp_ms = cuda_ms(k7_warp_call, 20, torch)
    k7_warp_ms_2 = cuda_ms(k7_warp_call, 20, torch)
    k7_ms_2 = cuda_ms(lambda: ops.group_quant(x, hd), 20, torch)
    # a decode step's write from CUDA graphs, in turns: fused, composed
    # (the current K7 twice + four copies), composed with the warp route
    # (the decode write of earlier builds), and back
    step_n = 2 * kv_step["k"].numel()
    step = {"fused": [], "composed": [], "composed_warp_route": []}
    for key in ("fused", "composed", "composed_warp_route",
                "composed_warp_route", "composed", "fused"):
        fn = fused if key == "fused" else (
            lambda w=key == "composed_warp_route": composed_write(
                torch, ops, build, kv_step, layer, LM_PROMPT, w))
        step[key].append(graph_ms(fn, 100, torch))
    step_bound = bound(3 * step_n + 4 * step_n // hd, 4 * step_n)[0]
    # ... and the host's time per call (decode follows the host), 200
    # calls each, in turns
    step_host_us = {"fused": [], "composed": []}
    for key in ("fused", "composed", "composed", "fused"):
        fn = fused if key == "fused" else (lambda: composed_write(
            torch, ops, build, kv_step, layer, LM_PROMPT, False))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        torch.cuda.synchronize()
        step_host_us[key].append((time.perf_counter() - t0) / 200 * 1e6)
    q, s = ops.group_quant(x, hd)
    rows.append(kernel_row(
        "group_quant", 0, k7_ms,
        cuda_ms(lambda: ref.group_quant(x, hd), 3, torch),
        2 * n + n + 4 * rows_n, 4 * n, None, per_generate["group_quant"], smi,
        launches_from="ServingEngine.generate, int8 cache",
        ms_turns=[k7_ms, k7_ms_2],
        warp_route_ms_turns=[k7_warp_ms, k7_warp_ms_2],
        decode_write_graph_ms=step, decode_write_bound_ms=step_bound,
        decode_write_host_us=step_host_us))
    rows.append(kernel_row(
        "group_dequant", 0,
        cuda_ms(lambda: ops.group_dequant(q, s, hd), 20, torch),
        cuda_ms(lambda: ref.group_dequant(q, s, hd), 3, torch),
        n + 4 * rows_n + 4 * n, n, None, per_readback["group_dequant"], smi,
        launches_from="quantize_prefill_cache + dequantize_kv, "
                      "full-width cache",
        launches_per_generate=per_generate["group_dequant"]))
    del x, q, s, cache_b, layer
    qk, sk = ops.group_quant(step_k, hd)
    m = step_k.numel()
    small = {"card": smi, "shape": tuple(step_k.shape),
             "k7_graph_ms": graph_ms(
                 lambda: ops.group_quant(step_k, hd), 100, torch),
             "k7_plain_graph_ms": graph_ms(
                 lambda: ref.group_quant(step_k, hd), 100, torch),
             "k7_event_ms": cuda_ms(
                 lambda: ops.group_quant(step_k, hd), 200, torch),
             "k7_bound_ms": bound(3 * m + 4 * step_k.shape[0], 4 * m)[0],
             "decode_write_graph_ms": step,
             "decode_write_bound_ms": step_bound,
             "decode_write_host_us": step_host_us,
             "k8_graph_ms": graph_ms(
                 lambda: ops.group_dequant(qk, sk, hd), 100, torch),
             "k8_plain_graph_ms": graph_ms(
                 lambda: ref.group_dequant(qk, sk, hd), 100, torch),
             "k8_bound_ms": bound(5 * m + 4 * step_k.shape[0], m)[0],
             "k7_launches_per_token": cfg.n_layers}
    print("K7/K8 at the decode-step shape: " + json.dumps(small))

    # ---- witness for the full-depth consistency: the same weights in
    # float32 (exact copies), so that only the cache's own rounding (bf16
    # or int8, as the reference keeps it whatever the model's dtype) parts
    # the two paths.  Its int8 reading is held to the reference's 1e-2
    def to_f32(tree):
        for k, w in tree.items():
            if isinstance(w, dict):
                to_f32(w)
            else:
                tree[k] = w.float()
    to_f32(params)
    torch.cuda.empty_cache()
    cfg32 = replace(cfg, dtype="float32")
    f32 = {"card": smi}
    for tag, run in (("int8", run_q), ("bf16", run_b)):
        f32[f"consistency_rel_{tag}_cache"] = lm_consistency(
            torch, cfg32, params, prompts, run)
    print(f"LM serving, float32 model at {cfg.n_layers} layers: "
          + json.dumps(f32))
    expect(f32["consistency_rel_int8_cache"] <= 1e-2,
           f"float32 int8-cache consistency {f32} > 1e-2")
    del params
    torch.cuda.empty_cache()
    check(not failed, "; ".join(failed))
    return rows


def moe_serving(torch, smi: str) -> dict:
    """Phase 8: mixture-of-experts serving, through the user entry points.
    Returns the printed readings with each run's launch counts."""
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.kernels import ops
    from repro_torch.models import layers, model
    from repro_torch.serving import ServingEngine

    dev = torch.device("cuda")
    run_q, run_b = RunConfig(kv_quant=True), RunConfig(kv_quant=False)
    out = {"card": smi, "launches": {}}
    failed = []

    def expect(cond: bool, msg: str) -> None:
        if not cond:
            failed.append(msg)

    for arch, depth, counts in MOE_CASES:
        full = get_config(arch)
        cfg = full if depth is None else replace(full, n_layers=depth)
        tag = arch.split("_")[0]
        st = {"card": smi, "arch": arch, "layers": cfg.n_layers,
              "of_layers": full.n_layers, "d_model": cfg.d_model,
              "experts": cfg.n_experts, "top_k": cfg.experts_per_token,
              "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
              "param_counts": model.param_counts(cfg), "batch": LM_BATCH,
              "prompt": LM_PROMPT, "new_tokens": LM_NEW}
        check(st["param_counts"] == counts,
              f"{arch}: param_counts {st['param_counts']} != {counts}")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        params = layers.init_from_specs(
            model.model_specs(cfg),
            torch.Generator(device=dev).manual_seed(MOE_SEED), device=dev)
        torch.cuda.synchronize()
        st["init_s"] = time.perf_counter() - t0
        prompts = torch.randint(
            0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
            generator=torch.Generator().manual_seed(MOE_SEED)).to(dev)
        engines = {"int8": ServingEngine(cfg, run_q, device=dev)}
        if depth is None:
            engines["bf16"] = ServingEngine(cfg, run_b, device=dev)

        # ---- generate with the int8 cache: counts reset just before and
        # read just after; K7 on the prefill stacks, then one fused write a
        # layer and decode step, never K8
        ids = {}
        for ctag, eng in engines.items():
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launches()
            t0 = time.perf_counter()
            ids[ctag] = eng.generate(params, prompts, new_tokens=LM_NEW)
            torch.cuda.synchronize()
            st[f"generate_{ctag}_s"] = time.perf_counter() - t0
            st[f"peak_device_bytes_generate_{ctag}"] = \
                torch.cuda.max_memory_allocated()
            if ctag == "int8":
                got = {k: ops.launches[k] for k in ops.launches}
                out["launches"][f"{tag}_generate_int8"] = got
                want = 2 + cfg.n_layers * LM_NEW
                expect(got["group_quant"] == want and
                       got["group_dequant"] == 0,
                       f"{arch}: generate launched K7 {got['group_quant']} "
                       f"times (not {want}) and K8 {got['group_dequant']}")
            check(tuple(ids[ctag].shape) == (LM_BATCH, LM_NEW),
                  f"{arch}: ids {tuple(ids[ctag].shape)}")
            check(int(ids[ctag].min()) >= 0
                  and int(ids[ctag].max()) < cfg.vocab_size,
                  f"{arch}: generated ids out of range")
        if "bf16" in ids:
            st["greedy_agreement"] = float(
                (ids["int8"] == ids["bf16"]).float().mean())
            expect(st["greedy_agreement"] >= 0.5,
                   f"{arch}: int8 and bf16 caches agree on "
                   f"{st['greedy_agreement']} < 0.5")
        for ctag, eng in engines.items():
            step_times(torch, eng, params, prompts, st, ctag)

        # ---- one decode step under the profiler (int8 cache)
        eng = engines["int8"]
        logits, state = eng.prefill(params, prompts, LM_PROMPT + 1)
        tok = torch.argmax(logits, dim=-1)
        st["decode_step_profile"] = device_profile(
            torch, lambda: eng.decode(params, state, tok, LM_PROMPT),
            aten_ops=MOE_ATEN_OPS)
        del logits, state

        if depth is None:
            # ---- the cache's conversion and read-back: K8
            cache_b, got, worst = cache_readback(torch, cfg, params, prompts)
            out["launches"][f"{tag}_readback"] = got
            st["dequant_err_over_scale"] = worst
            expect(got["group_dequant"] > 0,
                   f"{arch}: dequantize_kv never launched K8")
            expect(worst <= 0.5 + 2.0 ** -15,
                   f"{arch}: dequant error {worst} · scale")
            # ---- K7 and K8 against their plain versions at this arch's
            # head_dim, after the counts were read
            qdq_exact(torch, cfg, cache_b, arch)
            del cache_b
            t0 = time.perf_counter()
            consistency = moe_consistency(torch, cfg, params, prompts)
            st.update(consistency, consistency_s=time.perf_counter() - t0)
            rel2 = consistency["consistency_rel_bf16_2_layers"]
            expect(rel2 <= 1e-2, f"{arch}: two-layer bf16 consistency "
                                 f"{rel2} > 1e-2")
            rel_q = consistency[f"consistency_rel_int8_{cfg.n_layers}_layers"]
            rel_b = consistency[f"consistency_rel_bf16_{cfg.n_layers}_layers"]
            expect(rel_q <= rel_b + 1e-2, f"{arch}: int8 consistency {rel_q} "
                                          f"> bf16's {rel_b} + 1e-2")
            # a token whose top-k set the cache's rounding flips takes a
            # whole expert's share apart (ROADMAP.md, queue 3): phase 7's
            # float32 gate holds with the routing pinned; unpinned, the
            # int8 cache adds at most 1e-2 to the bf16 cache's reading
            rel32 = consistency["float32_pinned_consistency_rel_int8_cache"]
            expect(rel32 <= 1e-2, f"{arch}: float32 int8-cache consistency, "
                                  f"routing pinned, {rel32} > 1e-2")
            rel_q = consistency["float32_consistency_rel_int8_cache"]
            rel_b = consistency["float32_consistency_rel_bf16_cache"]
            expect(rel_q <= rel_b + 1e-2, f"{arch}: float32 int8 consistency "
                                          f"{rel_q} > bf16's {rel_b} + 1e-2")
        del params
        torch.cuda.empty_cache()
        print(f"MoE serving, {arch}: " + json.dumps(st))
        out[tag] = st
    check(not failed, "; ".join(failed))
    return out


def moe_consistency(torch, cfg, params, prompts) -> dict:
    """Prefill/decode consistency (:func:`lm_consistency`) at a drop-free
    capacity, ``capacity_factor = n_experts / experts_per_token``: then
    every group's capacity is at least its token count, so the 1,024-token
    prefill and the one-token decode step drop nothing.  bf16 and int8
    caches on the first two layers and at full depth, then both again with
    the same weights in float32 (``params`` is converted in place)."""
    from repro_torch.configs import RunConfig

    cfg = replace(cfg, capacity_factor=cfg.n_experts / cfg.experts_per_token)
    runs = (("int8", RunConfig(kv_quant=True)),
            ("bf16", RunConfig(kv_quant=False)))
    cut_params = dict(params, layers={
        blk: {k: w[:2] for k, w in leaves.items()}
        for blk, leaves in params["layers"].items()})
    st = {"consistency_capacity_factor": cfg.capacity_factor}
    for depth, c, p in ((2, replace(cfg, n_layers=2), cut_params),
                        (cfg.n_layers, cfg, params)):
        for tag, run in runs:
            st[f"consistency_rel_{tag}_{depth}_layers"] = lm_consistency(
                torch, c, p, prompts, run)
    del cut_params
    for tree in [params] + [v for v in params["layers"].values()]:
        for k, w in tree.items():
            if not isinstance(w, dict):
                tree[k] = w.float()
    torch.cuda.empty_cache()
    cfg32 = replace(cfg, dtype="float32")
    for tag, run in runs:
        st[f"float32_consistency_rel_{tag}_cache"] = lm_consistency(
            torch, cfg32, params, prompts, run)
        # the same with every token routed as the full prefill routed it:
        # what is left is the cache's rounding through a smooth model
        pin = PinRouting(torch, cfg.n_layers, prompts.shape[0])
        st[f"float32_pinned_consistency_rel_{tag}_cache"] = lm_consistency(
            torch, cfg32, params, prompts, run, pin=pin)
        st[f"float32_routing_flips_{tag}_cache"] = int(pin.flips)
    return st


class NamedBlocks:
    """While active, the stack's blocks run inside
    ``torch.profiler.record_function`` ranges named after them
    (``rwkv6_apply``: the time mix with the WKV6 recurrence and the
    channel mix; ``mamba2_apply``: the Mamba2 block with the SSD;
    ``attention``; ``mlp_apply``), so that a profile attributes device
    time to them.  ``repro_torch.models.model``'s names are wrapped; the
    wrappers return what the blocks return."""

    NAMES = ("rwkv6_apply", "mamba2_apply", "attention", "mlp_apply")

    def __init__(self, torch):
        from repro_torch.models import model
        self.torch, self.model = torch, model

    def __enter__(self):
        self.orig = {n: getattr(self.model, n) for n in self.NAMES}
        for name, fn in self.orig.items():
            def named(*a, _fn=fn, _name=name, **kw):
                with self.torch.profiler.record_function(_name):
                    return _fn(*a, **kw)
            setattr(self.model, name, named)
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.model, name, fn)


def seed_recurrence_leaves(torch, params: dict, seed: int) -> list[str]:
    """Redraw, in place, the layer leaves that the RWKV6 or Mamba2
    recurrence reads and ``init_from_specs`` leaves at zeros or ones
    (``make_card_reference.recurrence_leaf``: ``mu_*``, ``w0``,
    ``u_bonus``, ``a_log``, ``dt_bias``, ``d_skip``), from
    ``default_rng(seed)`` in sorted name order.  Returns their names."""
    import numpy as np

    fixture = card_fixture()
    rng = np.random.default_rng(seed)
    names = []
    for name in sorted(params["layers"]):
        leaf = params["layers"][name]
        a = fixture.recurrence_leaf(name, tuple(leaf.shape), rng)
        if a is not None:
            leaf.copy_(torch.from_numpy(a))
            names.append(name)
    return names


def cut_layers(cfg, params: dict, n: int, dtype=None) -> tuple:
    """``(cfg, params)`` of the model's first ``n`` layers (a hybrid: its
    first ``n / shared_attn_every`` groups), optionally cast to
    ``dtype``.  The leaves are views of ``params``' unless cast."""
    lead = n // cfg.shared_attn_every if cfg.family == "hybrid" else n
    cast = (lambda t: t) if dtype is None else (lambda t: t.to(dtype))

    def walk(tree: dict, stacked: bool) -> dict:
        return {k: walk(w, stacked or k == "layers") if isinstance(w, dict)
                else cast(w[:lead] if stacked else w)
                for k, w in tree.items()}
    out = walk(params, False)
    cfg = replace(cfg, n_layers=n, **(
        {} if dtype is None else {"dtype": str(dtype).split(".")[-1]}))
    return cfg, out


def recurrent_serving(torch, smi: str) -> dict:
    """Phase 9: recurrent-state serving, through the user entry points.
    Returns the printed readings with each run's launch counts."""
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.kernels import ops
    from repro_torch.models import layers, model
    from repro_torch.serving import ServingEngine

    dev = torch.device("cuda")
    run_q, run_b = RunConfig(kv_quant=True), RunConfig(kv_quant=False)
    out = {"card": smi, "launches": {}}
    failed = []

    def expect(cond: bool, msg: str) -> None:
        if not cond:
            failed.append(msg)

    for arch, shape, counts in RECURRENT_CASES:
        cfg = get_config(arch)
        tag = arch.split("_")[0]
        got_shape = tuple(getattr(cfg, f) for f in RECURRENT_FIELDS[cfg.family])
        check(got_shape == shape, f"{arch} is not full size: {got_shape}")
        st = {"card": smi, "arch": arch, "family": cfg.family,
              "shape": dict(zip(RECURRENT_FIELDS[cfg.family], shape)),
              "param_counts": model.param_counts(cfg), "batch": LM_BATCH,
              "prompt": LM_PROMPT, "new_tokens": LM_NEW}
        check(st["param_counts"] == counts,
              f"{arch}: param_counts {st['param_counts']} != {counts}")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        params = layers.init_from_specs(
            model.model_specs(cfg),
            torch.Generator(device=dev).manual_seed(RECURRENT_SEED),
            device=dev)
        st["seeded_leaves"] = seed_recurrence_leaves(torch, params,
                                                     RECURRENT_SEED)
        torch.cuda.synchronize()
        st["init_s"] = time.perf_counter() - t0
        prompts = torch.randint(
            0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
            generator=torch.Generator().manual_seed(RECURRENT_SEED)).to(dev)
        engines = {"int8": ServingEngine(cfg, run_q, device=dev),
                   "bf16": ServingEngine(cfg, run_b, device=dev)}

        # ---- each generate read alone: rwkv has no cache (K7 = K8 = 0);
        # zamba2's int8 cache takes K7 on the prefill's K and V stacks,
        # then one fused write a group and decode step, never K8
        ids = {}
        for ctag, eng in engines.items():
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launches()
            t0 = time.perf_counter()
            ids[ctag] = eng.generate(params, prompts, new_tokens=LM_NEW)
            torch.cuda.synchronize()
            st[f"generate_{ctag}_s"] = time.perf_counter() - t0
            st[f"peak_device_bytes_generate_{ctag}"] = \
                torch.cuda.max_memory_allocated()
            got = {k: ops.launches[k] for k in ops.launches}
            out["launches"][f"{tag}_generate_{ctag}"] = got
            want = (0 if cfg.family == "ssm" or ctag == "bf16" else
                    2 + cfg.n_layers // cfg.shared_attn_every * LM_NEW)
            expect(got["group_quant"] == want and got["group_dequant"] == 0,
                   f"{arch}: the {ctag} generate launched K7 "
                   f"{got['group_quant']} times (not {want}) and K8 "
                   f"{got['group_dequant']}")
            check(tuple(ids[ctag].shape) == (LM_BATCH, LM_NEW),
                  f"{arch}: ids {tuple(ids[ctag].shape)}")
            check(int(ids[ctag].min()) >= 0
                  and int(ids[ctag].max()) < cfg.vocab_size,
                  f"{arch}: generated ids out of range")
        st["greedy_agreement"] = float(
            (ids["int8"] == ids["bf16"]).float().mean())
        if cfg.family == "ssm":
            expect(torch.equal(ids["int8"], ids["bf16"]),
                   f"{arch}: the int8 and bf16 settings differ without a "
                   "cache")
        # the hybrid's greedy agreement is printed, not gated: on random
        # weights its logits are flat enough that bf16 rounding alone
        # reorders them, so the cache is held by the consistency gates
        # below and by K7/K8 equal to their plain versions at its shapes
        for ctag, eng in engines.items():
            if cfg.family != "ssm" or ctag == "int8":
                step_times(torch, eng, params, prompts, st, ctag)

        # ---- one prefill and one decode step under the profiler, the
        # blocks named
        eng = engines["int8"]
        with NamedBlocks(torch):
            st["prefill_profile"] = device_profile(
                torch, lambda: eng.prefill(params, prompts, LM_PROMPT + 1),
                aten_ops=RECURRENT_ATEN_OPS, ranges=NamedBlocks.NAMES)
            logits, state = eng.prefill(params, prompts, LM_PROMPT + 1)
            tok = torch.argmax(logits, dim=-1)
            st["decode_step_profile"] = device_profile(
                torch, lambda: eng.decode(params, state, tok, LM_PROMPT),
                aten_ops=RECURRENT_ATEN_OPS, ranges=NamedBlocks.NAMES)
        del logits, state

        if cfg.family == "hybrid":
            # ---- the cache's conversion and read-back: K8
            cache_b, got, worst = cache_readback(torch, cfg, params, prompts)
            out["launches"][f"{tag}_readback"] = got
            st["dequant_err_over_scale"] = worst
            expect(got["group_dequant"] > 0,
                   f"{arch}: dequantize_kv never launched K8")
            expect(worst <= 0.5 + 2.0 ** -15,
                   f"{arch}: dequant error {worst} · scale")
            # ---- K7 and K8 against their plain versions at the shared
            # attention's head_dim, after the counts were read
            qdq_exact(torch, cfg, cache_b, arch)
            del cache_b

        # ---- prefill/decode consistency (a 1,024-token prefill against a
        # 1,023-token prefill plus one decode step)
        t0 = time.perf_counter()
        if cfg.family == "ssm":
            rel = lm_consistency(torch, cfg, params, prompts, run_b)
            st[f"consistency_rel_{cfg.n_layers}_layers"] = rel
            expect(rel <= 1e-2, f"{arch}: bf16 consistency {rel} > 1e-2")
            c32, p32 = cut_layers(cfg, params, RWKV_F32_LAYERS,
                                  torch.float32)
            rel = lm_consistency(torch, c32, p32, prompts, run_b)
            del p32
            st[f"float32_consistency_rel_{RWKV_F32_LAYERS}_layers"] = rel
            expect(rel <= 1e-4, f"{arch}: float32 consistency at "
                                f"{RWKV_F32_LAYERS} layers {rel} > 1e-4")
        else:
            depth = 2 * cfg.shared_attn_every
            c2, p2 = cut_layers(cfg, params, depth)
            rel = lm_consistency(torch, c2, p2, prompts, run_b)
            st[f"consistency_rel_bf16_{depth}_layers"] = rel
            expect(rel <= 2e-2, f"{arch}: bf16 consistency at {depth} "
                                f"layers {rel} > 2e-2")
            for ctag, run in (("int8", run_q), ("bf16", run_b)):
                st[f"consistency_rel_{ctag}_{cfg.n_layers}_layers"] = \
                    lm_consistency(torch, cfg, params, prompts, run)
            rel_q = st[f"consistency_rel_int8_{cfg.n_layers}_layers"]
            rel_b = st[f"consistency_rel_bf16_{cfg.n_layers}_layers"]
            expect(rel_q <= rel_b + 1e-2, f"{arch}: int8 consistency {rel_q} "
                                          f"> bf16's {rel_b} + 1e-2")
            # the same weights in float32: the decode step still reads its
            # conv state rounded to bf16 (the reference keeps it bf16 in
            # every dtype; ROADMAP.md, queue 3), so the int8 cache is held
            # to the bf16 cache's reading, not to a bound of its own
            c32, p32 = cut_layers(cfg, params, cfg.n_layers, torch.float32)
            del params
            torch.cuda.empty_cache()
            params = p32
            for ctag, run in (("int8", run_q), ("bf16", run_b)):
                st[f"float32_consistency_rel_{ctag}_cache"] = lm_consistency(
                    torch, c32, params, prompts, run)
            st["float32_consistency_cause"] = (
                "the Mamba2 conv state is bf16 in every dtype")
            rel_q = st["float32_consistency_rel_int8_cache"]
            rel_b = st["float32_consistency_rel_bf16_cache"]
            expect(rel_q <= rel_b + 1e-2, f"{arch}: float32 int8 consistency "
                                          f"{rel_q} > bf16's {rel_b} + 1e-2")
        st["consistency_s"] = time.perf_counter() - t0
        del params
        torch.cuda.empty_cache()
        print(f"recurrent serving, {arch}: " + json.dumps(st))
        out[tag] = st
    check(not failed, "; ".join(failed))
    return out


def seeded_embeddings(torch, np, shape: tuple, seed: int, dev):
    """Frontend embeddings as the reference's stub frontend makes them,
    N(0, 1) · 0.02 in float32, from a numpy seed, on ``dev``."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            * np.float32(0.02)).to(dev)


def embedding_run(torch, eng, params, prompts, steps) -> dict:
    """``generate``'s work for an embedding-input model: a prefill of
    ``prompts`` (B, P, d) into a cache of ``P + len(steps)`` positions,
    then one decode step for each (B, d) embedding of ``steps``, each
    synchronised.  Returns the prefill s, each step's ms and the last
    logits."""
    P = prompts.shape[1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, state = eng.prefill(params, embeds=prompts,
                                capacity=P + len(steps))
    torch.cuda.synchronize()
    out = {"prefill_s": time.perf_counter() - t0, "step_ms": []}
    for i, emb in enumerate(steps):
        t0 = time.perf_counter()
        logits, state = eng.decode(params, state, embeds=emb,
                                   cache_len=P + i)
        torch.cuda.synchronize()
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
    check(bool(torch.isfinite(logits.float()).all()), "non-finite logits")
    out["logits"] = logits
    return out


def roundtrip_rms(torch, np, hd: int, dev) -> dict:
    """A cache's round-trip RMS error on 65,536 Gaussian head vectors of
    ``hd`` values (from a numpy seed), each over the bf16 cast's: kernel
    7's plain version and back (``scale = max|x|/127``), and the same
    with every scale twice as coarse, which a kernel 7 whose scales were
    off by 2× would store."""
    from repro_torch.kernels import ref

    rng = np.random.default_rng(FRONTEND_SEED + 2)
    x = torch.from_numpy(
        rng.standard_normal((65536, hd)).astype(np.float32)).to(dev)
    rms = lambda y: float((y - x).pow(2).mean().sqrt())
    q, s = ref.group_quant(x, hd)
    bf16 = rms(x.bfloat16().float())
    coarse = torch.round(x / (2 * s)).clamp_(-127, 127) * (2 * s)
    return {"int8_over_bf16": rms(ref.group_dequant(q, s, hd)) / bf16,
            "coarse_scale_over_bf16": rms(coarse) / bf16}


def embedding_serving(torch, smi: str) -> dict:
    """Phase 10: embedding-input serving, through the user entry points.
    Returns the printed readings with each run's launch counts."""
    import statistics

    import numpy as np

    from repro_torch.configs import RunConfig, get_config
    from repro_torch.kernels import ops
    from repro_torch.models import layers, model
    from repro_torch.serving import ServingEngine

    dev = torch.device("cuda")
    run_q, run_b = RunConfig(kv_quant=True), RunConfig(kv_quant=False)
    out = {"card": smi, "launches": {}}
    failed = []

    def expect(cond: bool, msg: str) -> None:
        if not cond:
            failed.append(msg)

    for arch, depth, count, full_count, f32_layers in FRONTEND_CASES:
        t_case = time.perf_counter()
        full = get_config(arch)
        cfg = full if depth is None else replace(full, n_layers=depth)
        tag = arch.split("_")[0]
        st = {"card": smi, "arch": arch, "layers": cfg.n_layers,
              "of_layers": full.n_layers, "d_model": cfg.d_model,
              "heads": (cfg.n_heads, cfg.n_kv_heads),
              "head_dim": cfg.head_dim, "act": cfg.act,
              "param_counts": model.param_counts(cfg), "batch": LM_BATCH,
              "prompt": LM_PROMPT, "new_positions": LM_NEW}
        check(cfg.input_mode == "embeddings", f"{arch}: {cfg.input_mode}")
        check(st["param_counts"] == (count, count)
              and model.param_counts(full) == (full_count, full_count),
              f"{arch}: param_counts {st['param_counts']} != {count}")
        check("embed" not in model.model_specs(cfg), f"{arch}: embed leaf")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        params = layers.init_from_specs(
            model.model_specs(cfg),
            torch.Generator(device=dev).manual_seed(FRONTEND_SEED),
            device=dev)
        torch.cuda.synchronize()
        st["init_s"] = time.perf_counter() - t0
        d = cfg.d_model
        prompts = seeded_embeddings(torch, np, (LM_BATCH, LM_PROMPT, d),
                                    FRONTEND_SEED, dev)
        steps = list(seeded_embeddings(
            torch, np, (LM_NEW, LM_BATCH, d), FRONTEND_SEED + 1, dev))
        engines = {"int8": ServingEngine(cfg, run_q, device=dev),
                   "bf16": ServingEngine(cfg, run_b, device=dev)}
        st["generate_raises"] = None
        try:
            engines["int8"].generate(params, torch.zeros(
                (LM_BATCH, 4), dtype=torch.long, device=dev), new_tokens=1)
        except ValueError as exc:
            st["generate_raises"] = str(exc)[:80]
        check(st["generate_raises"] is not None,
              f"{arch}: generate ran without a frontend")

        # ---- each run read alone: K7 on the prefill's K and V stacks,
        # then one fused write a layer and decode step; never K8
        last = {}
        for ctag, eng in engines.items():
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launches()
            res = embedding_run(torch, eng, params, prompts, steps)
            st[f"peak_device_bytes_{ctag}"] = \
                torch.cuda.max_memory_allocated()
            got = {k: ops.launches[k] for k in ops.launches}
            out["launches"][f"{tag}_serve_{ctag}"] = got
            want = 2 + cfg.n_layers * LM_NEW if ctag == "int8" else 0
            expect(got["group_quant"] == want and got["group_dequant"] == 0,
                   f"{arch}: the {ctag} run launched K7 {got['group_quant']}"
                   f" times (not {want}) and K8 {got['group_dequant']}")
            st[f"prefill_{ctag}_s"] = res["prefill_s"]
            st[f"decode_{ctag}_ms_per_step"] = statistics.median(
                res["step_ms"])
            st[f"decode_{ctag}_positions_per_s"] = (
                LM_BATCH / st[f"decode_{ctag}_ms_per_step"] * 1e3)
            last[ctag] = res["logits"].float()
        st["last_step_logits_rel_int8_vs_bf16"] = float(
            (last["int8"] - last["bf16"]).abs().max()
            / last["bf16"].abs().max())

        # ---- one decode step under the profiler (int8 cache)
        eng = engines["int8"]
        _, state = eng.prefill(params, embeds=prompts,
                               capacity=LM_PROMPT + 1)
        st["decode_step_profile"] = device_profile(
            torch, lambda: eng.decode(params, state, embeds=steps[0],
                                      cache_len=LM_PROMPT))
        del state

        # ---- the cache's conversion and read-back: K8; then K7 and K8
        # and the fused decode write against their plain versions at this
        # arch's head_dim, after the counts were read
        cache_b, got, worst = cache_readback(torch, cfg, params, prompts)
        out["launches"][f"{tag}_readback"] = got
        st["dequant_err_over_scale"] = worst
        expect(got["group_dequant"] == 2 and got["group_quant"] == 2,
               f"{arch}: read-back launched K7 {got['group_quant']} and K8 "
               f"{got['group_dequant']} times, not 2 and 2")
        expect(worst <= 0.5 + 2.0 ** -15,
               f"{arch}: dequant error {worst} · scale")
        qdq_exact(torch, cfg, cache_b, arch)
        del cache_b
        st["roundtrip_rms"] = roundtrip_rms(torch, np, cfg.head_dim, dev)

        # ---- prefill/decode consistency: the bf16 cache at the
        # reference test's depth (2 layers), the int8 cache against the
        # bf16 one at the run's depth, then the float32 witness
        t0 = time.perf_counter()
        c2, p2 = cut_layers(cfg, params, 2)
        rel = lm_consistency(torch, c2, p2, prompts, run_b)
        st["consistency_rel_bf16_2_layers"] = rel
        expect(rel <= 1e-2, f"{arch}: two-layer bf16 consistency {rel}")
        for ctag, run in (("int8", run_q), ("bf16", run_b)):
            st[f"consistency_rel_{ctag}_{cfg.n_layers}_layers"] = \
                lm_consistency(torch, cfg, params, prompts, run)
        rel_q = st[f"consistency_rel_int8_{cfg.n_layers}_layers"]
        rel_b = st[f"consistency_rel_bf16_{cfg.n_layers}_layers"]
        expect(rel_q <= rel_b + 1e-2, f"{arch}: int8 consistency {rel_q} > "
                                      f"bf16's {rel_b} + 1e-2")
        c32, p32 = cut_layers(cfg, params, f32_layers, torch.float32)
        del params, p2
        torch.cuda.empty_cache()
        for ctag, run in (("int8", run_q), ("bf16", run_b)):
            st[f"float32_{f32_layers}_layers_consistency_rel_{ctag}_cache"] \
                = lm_consistency(torch, c32, p32, prompts, run)
        # two fixed bars: the bf16 cache alone (the model's own
        # amplification of a cache's rounding) and the int8 cache's
        # reading over it (what kernel 7's scales add)
        rel32 = st[f"float32_{f32_layers}_layers_consistency_rel_int8_cache"]
        rel32_b = st[f"float32_{f32_layers}_layers_consistency_rel_bf16_cache"]
        st["float32_int8_over_bf16"] = rel32 / rel32_b
        expect(rel32_b <= 1e-2, f"{arch}: float32 bf16-cache consistency "
                                f"{rel32_b} > 1e-2")
        expect(rel32 <= F32_INT8_OVER_BF16_MAX * rel32_b,
               f"{arch}: float32 int8-cache consistency {rel32} > "
               f"{F32_INT8_OVER_BF16_MAX} × the bf16 cache's {rel32_b}")
        st["consistency_s"] = time.perf_counter() - t0
        del p32
        torch.cuda.empty_cache()
        st["case_s"] = time.perf_counter() - t_case
        print(f"embedding serving, {arch}: " + json.dumps(st))
        out[tag] = st
    check(not failed, "; ".join(failed))
    return out


class RecordExchange:
    """While active, ``optim.grad_compress``'s ``exchange_leaf`` (which
    the step's ``compress_pod_reduce`` calls a leaf) keeps a copy of the
    inputs (both replicas' gradients and residuals) of each leaf whose
    shape ``want`` names, the last step's overwriting the earlier; the
    wrapper calls the same function, so the step launches what it
    launched."""

    def __init__(self, want: dict):
        from repro_torch.optim import grad_compress
        self.mod, self.want, self.seen = grad_compress, want, {}

    def __enter__(self):
        self.orig = self.mod.exchange_leaf

        def recording(g, e, n_pods):
            name = self.want.get(tuple(g.shape))
            if name is not None:
                self.seen[name] = (g.clone(), e.clone())
            return self.orig(g, e, n_pods)
        self.mod.exchange_leaf = recording
        return self

    def __exit__(self, *exc):
        self.mod.exchange_leaf = self.orig


def leaf_at(tree: dict, path: str):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def train_batch(torch, np, cfg, seed: int, dev) -> dict:
    """One fixed train batch of ``TRAIN_BATCH`` from a numpy seed: token
    ids or frontend embeddings, and labels in ``[0, vocab)`` whose last
    position is -1 (masked), as the reference's pipelines make them."""
    rng = np.random.default_rng(seed)
    B, S = TRAIN_BATCH
    out = {}
    from repro_torch.models.model import input_key
    if input_key(cfg) == "tokens":
        out["tokens"] = torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (B, S))).to(dev)
    else:
        out["embeds"] = torch.from_numpy(
            rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
            * np.float32(0.02)).to(dev)
    labels = rng.integers(0, cfg.vocab_size, (B, S))
    labels[:, -1] = -1
    out["labels"] = torch.from_numpy(labels).to(dev)
    return out


def timed_steps(torch, step, n: int, st: dict, tag: str, tokens: int
                ) -> list[dict]:
    """``n`` calls of ``step()``, each synchronised: into ``st`` each
    step's s and the median step's tokens/s; returns each step's
    metrics (host floats)."""
    import statistics

    out, secs = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        out.append({k: float(v) for k, v in metrics.items()})
    st[f"{tag}_step_s"] = secs
    st[f"{tag}_tokens_per_s"] = tokens / statistics.median(secs)
    return out


def training(torch, smi: str) -> dict:
    """Phase 11: the single-card train step, AdamW, the two-replica step
    with the int8 gradient exchange, and Adafactor with microbatches.
    Returns the printed readings with each run's launch counts and the
    exchange's kernel timings at group 256."""
    import numpy as np

    from repro_torch.configs import RunConfig, get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import train
    from repro_torch.models import model
    from repro_torch.optim import adafactor, adamw, grad_compress
    from repro_torch.optim.tree import leaves

    dev = torch.device("cuda")
    precision = torch.get_float32_matmul_precision()
    check(precision == "highest", "float32 products must not run as TF32")
    out = {"card": smi, "launches": {},
           "float32_matmul_precision": precision}
    failed = []
    tokens = TRAIN_BATCH[0] * TRAIN_BATCH[1]

    def expect(cond: bool, msg: str) -> None:
        if not cond:
            failed.append(msg)

    # ---- 1. AdamW, musicgen-medium at full size, remat a layer
    cfg = get_config("musicgen_medium")
    run = RunConfig(remat="layer")
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=1)
    st = {"card": smi, "arch": cfg.name, "layers": cfg.n_layers,
          "params": model.param_counts(cfg)[0], "batch": TRAIN_BATCH,
          "run": "remat=layer", "optimizer": "adamw lr=1e-3 warmup=1",
          "float32_matmul_precision": precision}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, opt_state = train.init_train_state(
        cfg, run, torch.Generator(device=dev).manual_seed(TRAIN_SEED), opt,
        device=dev)
    batch = train_batch(torch, np, cfg, TRAIN_SEED, dev)
    head0 = params["lm_head"].clone()
    step, _ = train.make_train_step(cfg, run, opt)
    ops.reset_launches()
    metrics = timed_steps(
        torch, lambda: step(params, opt_state, batch)[2],
        TRAIN_ADAMW_STEPS, st, "adamw", tokens)
    out["launches"]["adamw_steps"] = dict(ops.launches)
    st["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    st["losses"] = [m["loss"] for m in metrics]
    st["grad_norms"] = [m["grad_norm"] for m in metrics]
    expect(all(np.isfinite(st["losses"])) and all(np.isfinite(
        st["grad_norms"])), f"adamw: non-finite loss or norm {metrics}")
    expect(st["losses"][-1] < st["losses"][0],
           f"adamw: the loss did not fall: {st['losses']}")
    expect(not torch.equal(params["lm_head"], head0),
           "adamw: lm_head did not change")
    expect(sum(out["launches"]["adamw_steps"].values()) == 0,
           f"adamw: a plain step launched {out['launches']['adamw_steps']}")
    st["step_profile"] = device_profile(
        torch, lambda: step(params, opt_state, batch), warm_up=False)
    del params, opt_state, head0
    torch.cuda.empty_cache()
    print("training, AdamW: " + json.dumps(st))
    out["adamw"] = st

    # ---- 2. the two-replica step: int8 gradient exchange on K7/K8
    st = {"card": smi, "arch": cfg.name, "n_pods": TRAIN_PODS,
          "batch": TRAIN_BATCH, "optimizer": "adamw lr=1e-3 warmup=1"}
    torch.cuda.reset_peak_memory_stats()
    params_r, opt_r, ef_r = train.init_replica_state(
        cfg, run, TRAIN_PODS,
        torch.Generator(device=dev).manual_seed(TRAIN_SEED), opt, device=dev)
    st["state_bytes"] = torch.cuda.memory_allocated()
    step_r, _ = train.make_train_step_compressed(cfg, run, TRAIN_PODS, opt)
    n_leaves = len(leaves(params_r))
    # the recorded leaves' shapes are unique among the model's leaves
    want = {tuple(leaf_at(params_r, name).shape): name
            for name in TRAIN_EXCHANGE_LEAVES}
    check(len(want) == len(TRAIN_EXCHANGE_LEAVES)
          and sum(tuple(a.shape) in want for _, a in leaves(params_r))
          == len(want), f"pods: recorded shapes {want}")
    # one step under the profiler first (not counted), then the counted
    # steps, the last of which the checks below read
    st["step_profile"] = device_profile(
        torch, lambda: step_r(params_r, opt_r, ef_r, batch), warm_up=False)
    per_step, losses = [], []
    with RecordExchange(want) as rec:
        for i in range(TRAIN_PODS_STEPS):
            ops.reset_launches()
            m = timed_steps(torch, lambda: step_r(params_r, opt_r, ef_r,
                                                  batch)[3],
                            1, st, f"step{i}", tokens)[0]
            per_step.append({k: ops.launches[k] for k in QDQ})
            losses.append(m["loss"])
    out["launches"]["pods_step"] = per_step[-1]
    st["launches_per_step"] = per_step
    st["losses"] = losses
    st["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    for got in per_step:
        expect(got == {"group_quant": n_leaves, "group_dequant": n_leaves},
               f"pods: a step launched {got}, not {n_leaves} of each")
    expect(all(np.isfinite(losses)), f"pods: losses {losses}")
    same = all(torch.equal(a[0], a[1]) for _, a in leaves(params_r))
    expect(same, "pods: the replicas' parameters differ after the step")
    st["replicas_bit_identical"] = same
    kept = {name: leaf_at(ef_r, name) for name in rec.seen}
    del params_r, opt_r, ef_r
    torch.cuda.empty_cache()
    # the recorded leaves of the last step: K7 and K8 against their plain
    # versions, bit for bit, on the exchange's (rows, 256) matrix, and on
    # an odd-length cut of the smaller leaf (zero-padded to whole groups)
    exact, k256 = {}, {}
    for name in list(rec.seen):
        g, e = rec.seen.pop(name)
        gc = g.float() + e
        del g, e
        rows = grad_compress._rows(gc.reshape(TRAIN_PODS, -1)).reshape(
            -1, grad_compress.GROUP).contiguous()
        cases = [("leaf", rows)]
        if name == "lm_head":
            cases.append(("odd_cut", grad_compress._rows(
                gc.reshape(-1)[:gc.numel() - 77]).contiguous()))
        for label, x in cases:
            q, s = ops.group_quant(x, 256)
            q_p, s_p = ref.group_quant(x, 256)
            ok = torch.equal(q, q_p) and torch.equal(s, s_p)
            del q_p, s_p
            d = ops.group_dequant(q, s, 256)
            ok = ok and torch.equal(d, ref.group_dequant(q, s, 256))
            del d
            expect(ok, f"pods: K7/K8 != plain at group 256 on {name} "
                       f"({label}, {tuple(x.shape)})")
            exact[f"{name}/{label}"] = [tuple(x.shape), ok]
        del cases
        # the residual the step kept is the exchange's, within half a
        # quantization step of its group
        q, s = ops.group_quant(rows, 256)
        deq = ops.group_dequant(q, s, 256).reshape(TRAIN_PODS, -1)
        resid = (gc.reshape(TRAIN_PODS, -1)
                 - deq[:, :gc[0].numel()]).reshape(gc.shape)
        del deq
        expect(torch.equal(resid, kept[name]),
               f"pods: {name}'s residual is not the step's")
        over = float((grad_compress._rows(resid.reshape(TRAIN_PODS, -1))
                      .abs().amax(-1).reshape(-1) / s[:, 0]).max())
        exact[f"{name}/residual_over_scale"] = over
        expect(over <= 0.5 + 2.0 ** -15,
               f"pods: {name}'s residual {over} · scale")
        del resid
        if name == "layers/mlp/w_up":
            n, n_rows = rows.numel(), rows.shape[0]
            k256 = {"shape": tuple(rows.shape),
                    "k7": (cuda_ms(lambda: ops.group_quant(rows, 256), 20,
                                   torch),
                           cuda_ms(lambda: ref.group_quant(rows, 256), 3,
                                   torch),
                           bound(4 * n + n + 4 * n_rows, 4 * n)[0]),
                    "k8": (cuda_ms(lambda: ops.group_dequant(q, s, 256), 20,
                                   torch),
                           cuda_ms(lambda: ref.group_dequant(q, s, 256), 3,
                                   torch),
                           bound(n + 4 * n_rows + 4 * n, n)[0])}
        del gc, rows, q, s
        torch.cuda.empty_cache()
    expect(set(exact) >= {f"{p}/leaf" for p in TRAIN_EXCHANGE_LEAVES},
           f"pods: recorded {sorted(exact)}")
    st["k7_k8_exact_at_group_256"] = exact
    st["k7_k8_ms_at_group_256"] = k256
    del rec, kept
    torch.cuda.empty_cache()
    print("training, two replicas: " + json.dumps(st))
    out["pods"] = st

    # ---- 3. Adafactor, deepseek-7b cut to 4 layers, two microbatches
    arch, depth, count = TRAIN_ADAFACTOR_CASE
    cfg = replace(get_config(arch), n_layers=depth)
    run = RunConfig(optimizer="adafactor", microbatches=2)
    opt = adafactor.AdafactorConfig(warmup_steps=1)
    st = {"card": smi, "arch": arch, "layers": depth,
          "of_layers": get_config(arch).n_layers,
          "params": model.param_counts(cfg)[0], "batch": TRAIN_BATCH,
          "run": "microbatches=2, remat=layer",
          "optimizer": "adafactor warmup=1"}
    check(st["params"] == count, f"{arch}@{depth}: {st['params']} != {count}")
    torch.cuda.reset_peak_memory_stats()
    params, opt_state = train.init_train_state(
        cfg, run, torch.Generator(device=dev).manual_seed(TRAIN_SEED), opt,
        device=dev)
    batch = train_batch(torch, np, cfg, TRAIN_SEED + 1, dev)
    # the microbatched gradients against the one-batch gradients (bf16,
    # rounded per half): each leaf within the bf16 gradient tolerance of
    # the CPU tests, 2.5e-2 relative
    _, _, g2 = train._microbatched_grads(params, batch, cfg, run)
    _, _, g1 = train._microbatched_grads(params, batch, cfg,
                                         replace(run, microbatches=1))
    g1_of = dict(leaves(g1))
    rel = {"/".join(p): float((g.float() - g1_of[p].float()).abs().max()
                              / g1_of[p].float().abs().max())
           for p, g in leaves(g2)}
    st["microbatch_vs_one_batch_grads_rel"] = max(rel.values())
    expect(max(rel.values()) <= 2.5e-2, f"adafactor: microbatched grads "
                                        f"{rel}")
    del g1, g2, g1_of
    step, _ = train.make_train_step(cfg, run, opt)
    ops.reset_launches()
    metrics = timed_steps(torch, lambda: step(params, opt_state, batch)[2],
                          TRAIN_ADAFACTOR_STEPS, st, "adafactor", tokens)
    out["launches"]["adafactor_steps"] = dict(ops.launches)
    st["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    st["losses"] = [m["loss"] for m in metrics]
    expect(all(np.isfinite(st["losses"]))
           and st["losses"][-1] < st["losses"][0],
           f"adafactor: losses {st['losses']}")
    st["step_profile"] = device_profile(
        torch, lambda: step(params, opt_state, batch), warm_up=False)
    del params, opt_state, batch
    torch.cuda.empty_cache()
    print("training, Adafactor: " + json.dumps(st))
    out["adafactor"] = st
    check(not failed, "; ".join(failed))
    return out


class SyncedClock:
    """Wall seconds between consecutive batches the loop takes from a
    stream, each ended by a synchronize: one full loop step apiece (its
    launches, its kernels, its logging and any save it starts)."""

    def __init__(self, torch, stream):
        self.torch, self.stream = torch, stream
        self.stamps = []

    def __iter__(self):
        return self

    def __next__(self):
        self.torch.cuda.synchronize()
        self.stamps.append(time.perf_counter())
        return next(self.stream)

    def seconds(self) -> list[float]:
        return [b - a for a, b in zip(self.stamps, self.stamps[1:])]


class SaveClock:
    """Times, while active, what a checkpoint write spends in kernel 5
    (``ops.lorenzo3d_codes``, synchronized around each call) and in the
    tensor codec's byte pass on the host (``repro_torch.io.tensor``'s
    ``zlib.compress``, or ``zstd_compress`` where ``zstandard`` is
    installed), from whichever thread writes."""

    def __init__(self, torch, ops, tensor_mod):
        self.torch, self.ops, self.mod = torch, ops, tensor_mod
        self.k5_s = self.byte_pass_s = 0.0
        self.codec = "zstd" if tensor_mod.HAVE_ZSTD else "zlib"

    def _timed(self, fn):
        def call(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            self.byte_pass_s += time.perf_counter() - t0
            return out
        return call

    def __enter__(self):
        import types
        import zlib

        self.orig = (self.ops.lorenzo3d_codes, self.mod.zlib,
                     self.mod.zstd_compress)

        def k5(*a, **kw):
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self.orig[0](*a, **kw)
            self.torch.cuda.synchronize()
            self.k5_s += time.perf_counter() - t0
            return out
        self.ops.lorenzo3d_codes = k5
        self.mod.zlib = types.SimpleNamespace(
            compress=self._timed(zlib.compress), crc32=zlib.crc32)
        self.mod.zstd_compress = self._timed(self.orig[2])
        return self

    def __exit__(self, *exc):
        (self.ops.lorenzo3d_codes, self.mod.zlib,
         self.mod.zstd_compress) = self.orig


class RecordWatchdogs:
    """While active, ``train_loop``'s ``StepWatchdog`` is a subclass that
    keeps every instance made: yields the list, whose watchdogs' step
    durations can be read after the loop returns."""

    def __init__(self, resilience):
        self.mod = resilience

    def __enter__(self):
        made = []
        self.orig = orig = self.mod.StepWatchdog

        class Kept(orig):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                made.append(self)
        self.mod.StepWatchdog = Kept
        return made

    def __exit__(self, *exc):
        self.mod.StepWatchdog = self.orig


def failing_stream(stream, fail_at: int, ready: str):
    """``stream`` that raises ``SimulatedFailure`` when batch ``fail_at``
    is asked for, once ``ready`` (the checkpoint written before it) is on
    disk: the loop's last save is non-blocking."""
    from repro_torch.runtime import FailureInjector

    inj = FailureInjector(fail_at_step=fail_at)
    for i, batch in enumerate(stream):
        if i == fail_at:
            t0 = time.perf_counter()
            while not os.path.exists(ready):
                check(time.perf_counter() - t0 < 120, f"no {ready}")
                time.sleep(0.01)
        inj.check(i)
        yield batch


def same_trees(torch, a: dict, b: dict) -> bool:
    from repro_torch.optim.tree import leaves

    la, lb = leaves(a), dict(leaves(b))
    return len(la) == len(lb) and all(
        p in lb and x.dtype == lb[p].dtype and x.shape == lb[p].shape
        and torch.equal(x, lb[p].to(x.device)) for p, x in la)


def tree_rel(torch, want: dict, got: dict) -> float:
    """The largest per-leaf ``max |got − want| / max |want|``."""
    from repro_torch.optim.tree import leaves

    g = dict(leaves(got))
    return max(float((g[p].float() - w.float()).abs().max()
                     / w.float().abs().max().clamp_min(1e-30))
               for p, w in leaves(want))


def resilient_loop(torch, smi: str) -> dict:
    """Phase 12: ``train_loop`` on the card with checkpoints (musicgen-
    medium at full width, 4 of its 48 layers, float32, AdamW, the port's
    ``embedding_batches``): run (a), the resumed run (b), the failed and
    resumed run (c); then a measured lossless and lossy save and restore
    (kernels 5 and 6 on the lossy leaves), two lossy blobs and decodes
    held to the CPU's plain versions, and one granite-moe expert leaf at
    full shape through ``lorenzo_codes``/``lorenzo_decode`` (kernels 1
    and 2 on ``(E, d, f)`` bricks).  Returns the printed readings with
    each run's launch counts."""
    import itertools
    import json as js
    import shutil
    import signal
    from types import SimpleNamespace

    import numpy as np

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.core import sz
    from repro_torch.data import embedding_batches
    from repro_torch.io import tensor as tio_tensor
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import train
    from repro_torch.models import model
    from repro_torch.optim import adamw
    from repro_torch.runtime import SimulatedFailure, resilience

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    arch, depth = LOOP_ARCH, LOOP_LAYERS
    cfg = replace(get_config(arch), n_layers=depth, dtype="float32")
    run = RunConfig(remat="layer")
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=1)
    shape = SimpleNamespace(global_batch=TRAIN_BATCH[0],
                            seq_len=TRAIN_BATCH[1])
    root = tempfile.mkdtemp(prefix="chip_smoke_loop_")
    usage = shutil.disk_usage(root)
    out = {"card": smi, "arch": arch, "layers": depth,
           "of_layers": get_config(arch).n_layers,
           "params": model.param_counts(cfg)[0], "dtype": "float32",
           "batch": TRAIN_BATCH, "optimizer": "adamw lr=1e-3 warmup=1",
           "run": "remat=layer", "tmp_free_bytes": usage.free,
           "tmp_dir": root, "launches": {}}
    print(f"resilient loop: temporary directory {root}, "
          f"{usage.free} bytes free of {usage.total}")
    sigterm = signal.getsignal(signal.SIGTERM)

    def stream(start: int = 0):
        return itertools.islice(embedding_batches(
            cfg, shape, seed=LOOP_SEED, device=dev), start, None)

    def loop(steps: int, data, ckpt: str, **kw):
        return train.train_loop(
            cfg, run, data, steps=steps, opt_cfg=opt, checkpoint_dir=ckpt,
            checkpoint_every=3, log_every=1, device=dev,
            generator=torch.Generator(device=dev).manual_seed(LOOP_SEED),
            **kw)

    def counted(key: str, fn):
        """``fn()`` read alone: the launch counts set to 0 just before it
        and read just after (also when it raises)."""
        torch.cuda.synchronize()
        ops.reset_launches()
        try:
            return fn()
        finally:
            torch.cuda.synchronize()
            out["launches"][key] = dict(ops.launches)

    try:
        # ---- (a) six steps, a checkpoint every three
        dir_a = os.path.join(root, "a")
        clock = SyncedClock(torch, stream())
        t0 = time.perf_counter()
        with RecordWatchdogs(resilience) as wds:
            params_a, opt_a, hist_a = counted("a", lambda: loop(
                6, clock, dir_a))
        out["a_s"] = time.perf_counter() - t0
        out["a_history"] = hist_a
        out["a_step_s"] = clock.seconds()
        out["a_watchdog_s"] = list(wds[0].durations)
        out["watchdog_note"] = ("the watchdog's durations are host time "
                                "around each step call, which returns "
                                "before its kernels end: no synchronize "
                                "closes the window")
        check([s for s, _ in hist_a] == list(range(6)),
              f"(a): history {hist_a}")
        check(all(np.isfinite([v for _, v in hist_a])), f"(a): {hist_a}")
        check(hist_a[-1][1] < hist_a[0][1],
              f"(a): the loss did not fall: {hist_a}")
        mgr_a = CheckpointManager(dir_a, device=dev)
        check(mgr_a.list_steps() == [3, 6], f"(a): {mgr_a.list_steps()}")
        rp, ro, rs = mgr_a.restore(6)
        check(rs == 6 and same_trees(torch, params_a, rp)
              and same_trees(torch, opt_a, ro),
              "(a): the restored step-6 state != the saved state")
        del rp, ro

        # ---- (b) a fresh loop of 8 steps resumes at step 6
        t0 = time.perf_counter()
        res_b = {}
        with RecordWatchdogs(resilience) as wds:
            out["b_profile"] = device_profile(
                torch, lambda: res_b.setdefault("r", counted(
                    "b", lambda: loop(8, stream(6), dir_a))), warm_up=False)
        out["b_s"] = time.perf_counter() - t0
        _, opt_b, hist_b = res_b.pop("r")
        out["b_history"] = hist_b
        out["b_watchdog_s"] = list(wds[0].durations)
        check(hist_b and hist_b[0][0] >= 6 and [s for s, _ in hist_b]
              == [6, 7], f"(b): history {hist_b}")
        check(int(opt_b["step"]) == 8, f"(b): opt step {opt_b['step']}")
        del opt_b
        shutil.rmtree(dir_a)
        torch.cuda.empty_cache()

        # ---- (c) a failure when step 4's batch is fetched, then a resume
        dir_c = os.path.join(root, "c")
        t0 = time.perf_counter()
        try:
            counted("c_failed", lambda: loop(6, failing_stream(
                stream(), 4, os.path.join(dir_c, "step_00000003.json")),
                dir_c))
            check(False, "(c): no SimulatedFailure")
        except SimulatedFailure as exc:
            out["c_failure"] = str(exc)
        torch.cuda.empty_cache()
        check(CheckpointManager(dir_c, device=dev).list_steps() == [3],
              "(c): the failed run's checkpoints")
        params_c, opt_c, hist_c = counted("c_resumed", lambda: loop(
            6, stream(3), dir_c))
        out["c_s"] = time.perf_counter() - t0
        out["c_history"] = hist_c
        check(hist_c[0][0] == 3, f"(c): history {hist_c}")
        out["c_vs_a_bit_exact"] = {"params": same_trees(torch, params_a,
                                                        params_c),
                                   "opt": same_trees(torch, opt_a, opt_c)}
        out["c_vs_a_params_rel"] = tree_rel(torch, params_a, params_c)
        out["c_vs_a_history_equal"] = hist_c == hist_a[3:]
        check(out["c_vs_a_params_rel"] <= LOOP_RESUME_REL_MAX,
              f"(c): params {out['c_vs_a_params_rel']} from (a)'s")
        del params_c, opt_c
        shutil.rmtree(dir_c)
        torch.cuda.empty_cache()

        # ---- measured saves and restores of (a)'s final state
        saves = {}
        n_rank3 = 0
        for kind, eb_rel in (("lossless", 0.0), ("lossy", LOOP_EB_REL)):
            d = os.path.join(root, kind)
            mgr = CheckpointManager(d, lossy_eb_rel=eb_rel, device=dev)
            with SaveClock(torch, ops, tio_tensor) as sc:
                torch.cuda.synchronize()
                ops.reset_launches()
                t0 = time.perf_counter()
                mgr.save(6, params_a, opt_a)
                t1 = time.perf_counter()
                mgr.wait()
                t2 = time.perf_counter()
            save_launches = dict(ops.launches)
            ops.reset_launches()
            t3 = time.perf_counter()
            rp, ro, _ = mgr.restore(6)
            torch.cuda.synchronize()
            t4 = time.perf_counter()
            restore_launches = dict(ops.launches)
            out["launches"][f"{kind}_save"] = save_launches
            out["launches"][f"{kind}_restore"] = restore_launches
            npz = os.path.join(d, "step_00000006.npz")
            with open(os.path.join(d, "step_00000006.json")) as f:
                manifest = js.load(f)
            lossy = {manifest["entries"][k]["path"]: (k, v["eb"])
                     for k, v in manifest["lossy"].items()}
            st = {"save_s": t2 - t0, "host_copy_s": t1 - t0,
                  "write_s": t2 - t1, "restore_s": t4 - t3,
                  "file_bytes": os.path.getsize(npz),
                  "k5_s": sc.k5_s, "byte_pass_s": sc.byte_pass_s,
                  "byte_codec": sc.codec, "lossy_leaves": len(lossy)}
            st.update({f"{k}_share": st[f"{k}_s"] / st["save_s"]
                       for k in ("host_copy", "k5", "byte_pass")})
            if kind == "lossless":
                check(not lossy and same_trees(torch, params_a, rp)
                      and same_trees(torch, opt_a, ro),
                      "lossless restore != the saved state")
                check(sum(save_launches.values()) == 0
                      and sum(restore_launches.values()) == 0,
                      f"lossless: launches {save_launches} "
                      f"{restore_launches}")
            else:
                n_rank3 = sum(leaf_at(params_a, p[len("params/"):]).dim()
                              == 3 for p in lossy)
                st["rank3_lossy_leaves"] = n_rank3
                check(n_rank3 > 0 and save_launches["lorenzo3d_codes"]
                      == n_rank3, f"lossy save: K5 {save_launches} for "
                                  f"{n_rank3} rank-3 leaves")
                check(restore_launches["lorenzo3d_recon"] == n_rank3,
                      f"lossy restore: K6 {restore_launches}")
                worst = 0.0
                for p, (_, eb) in lossy.items():
                    src = leaf_at(params_a, p[len("params/"):])
                    err = float((leaf_at(rp, p[len("params/"):]) - src)
                                .abs().max())
                    limit = eb + 2.0 ** -23 * float(src.abs().max())
                    check(err <= limit, f"lossy {p}: {err} > {limit}")
                    worst = max(worst, err / eb)
                st["max_err_over_eb"] = worst
                check(same_trees(torch, opt_a, ro),
                      "lossy: the optimizer state is not lossless")
                # two leaves: the card's blob == the CPU's plain encode,
                # the card's decode == the plain decode, bit for bit
                held = {}
                with np.load(npz) as z:
                    for p in LOOP_HELD_LEAVES:
                        key, eb = lossy[f"params/{p}"]
                        blob = z[key].tobytes()
                        src = leaf_at(params_a, p)
                        t0 = time.perf_counter()
                        plain = tio_tensor.encode_tensor(
                            src.cpu(), eb, device="cpu")
                        plain_s = time.perf_counter() - t0
                        card = tio_tensor.decode_tensor(blob, device=dev)
                        host = tio_tensor.decode_tensor(blob, device="cpu")
                        ok = (blob == plain, torch.equal(card.cpu(), host))
                        held[p] = {"shape": list(src.shape),
                                   "routes": [ops.codes3d_route(
                                       tuple(src.shape), tuple(src.shape)),
                                       ops.recon3d_route(
                                       tuple(src.shape), tuple(src.shape))],
                                   "blob_bytes": len(blob),
                                   "blob_equal": ok[0], "decode_equal": ok[1],
                                   "cpu_encode_s": plain_s}
                        check(all(ok), f"lossy {p}: card != plain {ok}")
                        del card, host
                st["held_to_plain"] = held
            del rp, ro
            saves[kind] = st
            shutil.rmtree(d)
            torch.cuda.empty_cache()
        saves["file_ratio"] = (saves["lossless"]["file_bytes"]
                               / saves["lossy"]["file_bytes"])
        out["saves"] = saves
        out["rank3_lossy_leaves"] = n_rank3

        # K5/K6 at the largest checkpoint leaf's shape, against plain
        x = leaf_at(params_a, LOOP_HELD_LEAVES[-1]).contiguous()
        sh, eb = tuple(x.shape), LOOP_EB_REL * float(x.abs().max())
        codes = ops.lorenzo3d_codes(x, eb, sh)
        check(torch.equal(codes, ref.lorenzo3d_codes(x, eb, sh)),
              f"K5 != plain at {sh}")
        recon = ops.lorenzo3d_recon(codes, eb, sh)
        check(torch.equal(recon, ref.lorenzo3d_recon(codes, eb, sh)),
              f"K6 != plain at {sh}")
        n = x.numel()
        out["k56_at_leaf"] = {
            "shape": sh, "routes": [ops.codes3d_route(sh, sh),
                                    ops.recon3d_route(sh, sh)],
            "k5_ms": cuda_ms(lambda: ops.lorenzo3d_codes(x, eb, sh), 5,
                             torch),
            "k5_plain_ms": cuda_ms(lambda: ref.lorenzo3d_codes(x, eb, sh),
                                   2, torch),
            "k6_ms": cuda_ms(lambda: ops.lorenzo3d_recon(codes, eb, sh), 5,
                             torch),
            "k6_plain_ms": cuda_ms(lambda: ref.lorenzo3d_recon(codes, eb, sh),
                                   2, torch),
            "bound_ms": bound(12 * n, 12 * n)[0]}
        del params_a, opt_a, x, codes, recon
        torch.cuda.empty_cache()

        # ---- one granite-moe expert leaf at full shape: K1 and K2 on
        # (E, d, f) bricks, through lorenzo_codes / lorenzo_decode
        e_arch, e_path = LOOP_EXPERT
        e_cfg = get_config(e_arch)
        spec = leaf_at(model.model_specs(e_cfg), e_path)
        g = torch.Generator(device=dev).manual_seed(LOOP_SEED)
        x = (torch.randn(spec.shape, generator=g, device=dev)
             / float(np.sqrt(spec.shape[-2]))).to(spec.torch_dtype).float()
        eb = LOOP_EB_REL * float(x.abs().max())
        n = x.numel()
        codes = counted("expert_encode", lambda: sz.lorenzo_codes(x, eb))
        k1 = ops.lorenzo3d_codes_batched(x, eb)
        check(torch.equal(k1, ref.lorenzo3d_codes_batched(x, eb)),
              f"K1 != plain on {tuple(x.shape)}")
        check(torch.equal(codes, torch.diff(
            k1, dim=0, prepend=torch.zeros_like(k1[:1]))),
            "lorenzo_codes != K1 and its axis-0 difference")
        del k1
        check(torch.equal(codes, sz.lorenzo_nd_codes(sz.prequant(x, eb))),
              "lorenzo_codes != the plain N-D Lorenzo")
        recon = counted("expert_decode", lambda: sz.lorenzo_decode(codes, eb))
        cum = torch.cumsum(codes, dim=0).contiguous()
        k2 = ops.lorenzo3d_recon_batched(cum, eb)
        check(torch.equal(k2, recon) and torch.equal(
            k2, ref.lorenzo3d_recon_batched(cum, eb)),
            f"K2 != plain on {tuple(x.shape)}")
        del k2
        err = float((recon - x).abs().max())
        check(err <= eb + 2.0 ** -23 * float(x.abs().max()),
              f"expert leaf: error {err} > eb {eb}")
        for key, name in (("expert_encode", "lorenzo3d_codes_batched"),
                          ("expert_decode", "lorenzo3d_recon_batched")):
            check(out["launches"][key][name] == 1,
                  f"{key}: {out['launches'][key]}")
        out["expert"] = {
            "arch": e_arch, "leaf": e_path, "shape": tuple(x.shape),
            "brick": tuple(x.shape[1:]), "eb": eb, "max_err": err,
            "routes": [ops.codes_route(x), ops.recon_route(
                tuple(x.shape[1:]))],
            "k1_ms": cuda_ms(lambda: ops.lorenzo3d_codes_batched(x, eb), 3,
                             torch),
            "k1_plain_ms": cuda_ms(
                lambda: ref.lorenzo3d_codes_batched(x, eb), 1, torch),
            "k2_ms": cuda_ms(lambda: ops.lorenzo3d_recon_batched(cum, eb), 3,
                             torch),
            "k2_plain_ms": cuda_ms(
                lambda: ref.lorenzo3d_recon_batched(cum, eb), 1, torch),
            "bound_ms": bound(12 * n, 12 * n)[0]}
        del x, codes, recon, cum
        torch.cuda.empty_cache()
    finally:
        signal.signal(signal.SIGTERM, sigterm)
        shutil.rmtree(root, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print("resilient loop: " + json.dumps(out, default=str))
    return out


def mesh_run_opt() -> tuple:
    """Phase 13's run and optimizer: remat a layer, AdamW (lr 1e-3, one
    warmup step)."""
    from repro_torch.configs import RunConfig
    from repro_torch.optim import adamw

    return RunConfig(remat="layer"), adamw.AdamWConfig(lr=1e-3,
                                                       warmup_steps=1)


def device_sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


class TrainClock:
    """Seconds, while active, that ``launch.train``'s steps spend in each
    of its functions ``names`` (the device synchronized around each
    call), and the last return value of those in ``keep``."""

    def __init__(self, torch, dev, *names, keep=()):
        from repro_torch.launch import train

        self.torch, self.dev, self.mod = torch, dev, train
        self.s, self.keep, self.last = dict.fromkeys(names, 0.0), keep, {}

    def __enter__(self):
        self.orig = {n: getattr(self.mod, n) for n in self.s}
        for n, fn in self.orig.items():
            def timed(*a, _n=n, _fn=fn, **kw):
                device_sync(self.torch, self.dev)
                t0 = time.perf_counter()
                out = _fn(*a, **kw)
                device_sync(self.torch, self.dev)
                self.s[_n] += time.perf_counter() - t0
                if _n in self.keep:
                    self.last[_n] = out
                return out
            setattr(self.mod, n, timed)
        return self

    def __exit__(self, *exc):
        for n, fn in self.orig.items():
            setattr(self.mod, n, fn)


class RecordGrads:
    """While active, a host copy of the leaves ``names`` of the first
    gradients ``launch.train._microbatched_grads`` returns (the one-process
    step's first step)."""

    def __init__(self, names):
        from repro_torch.launch import train

        self.mod, self.names, self.first = train, names, None

    def __enter__(self):
        self.orig = orig = self.mod._microbatched_grads

        def recording(*a, **kw):
            out = orig(*a, **kw)
            if self.first is None:
                self.first = {n: leaf_at(out[2], n).cpu() for n in self.names}
            return out
        self.mod._microbatched_grads = recording
        return self

    def __exit__(self, *exc):
        self.mod._microbatched_grads = self.orig


def dp_step_bytes(params: dict, n: int, mb: int) -> dict:
    """The bytes a rank sends (and as many it receives) in a step of
    ``make_train_step(mesh=)`` over ``n`` ranks, at a ring's volume: the
    all-gather of each sharded parameter and the reduce-scatter of its
    float32 gradient, ``(n − 1)/n`` of the leaf each; the all-reduce of a
    replicated leaf's float32 gradient, ``2(n − 1)/n``; the ``mb`` label
    counts (int64, all-reduced), the norm's float32 partial sums and the
    ``mb + 2`` float32 metrics (all-gathered)."""
    from repro_torch.optim.tree import leaves, sharded

    share = (n - 1) / n
    out = {"gather": 0, "reduce_scatter": 0, "all_reduce": 0}
    for _, p in leaves(params):
        if sharded(p):
            out["gather"] += share * p.numel() * p.element_size()
            out["reduce_scatter"] += share * p.numel() * 4
        else:
            out["all_reduce"] += 2 * share * p.numel() * 4
    out["scalars"] = (2 * share * 8 * mb
                      + (n - 1) * 4 * (len(leaves(params)) + mb + 2))
    out = {k: int(v) for k, v in out.items()}
    out["total"] = sum(out.values())
    return out


def update_rel(torch, want, got, old) -> float:
    """``max(|got − want| − ulp(want), 0) / max |want − old|``: a leaf's
    difference beyond one ulp, of its largest update."""
    ulp = torch.nextafter(want.abs(), torch.full_like(want, float("inf"))) \
        - want.abs()
    beyond = ((got.double() - want.double()).abs() - ulp.double()).clamp_min(0)
    return float(beyond.max() / (want.double() - old.double()).abs().max()
                 .clamp_min(1e-30))


def mesh_rank(rank: int, n: int, root: str, cfg, dev_type: str) -> None:
    """One rank of phase 13 (spawned): joins the gloo group at ``root``'s
    ``file://`` rendezvous, runs :func:`mesh_rank_run`, and writes its
    readings to ``root/rank<r>.json``."""
    import datetime

    import torch
    import torch.distributed as dist

    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(root, "rdzv"),
        rank=rank, world_size=n,
        timeout=datetime.timedelta(seconds=MESH_PG_TIMEOUT_S))
    try:
        out = mesh_rank_run(torch, dist, rank, n, root, cfg,
                            torch.device(dev_type))
        bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "repro")]
        check(not bad, f"rank {rank} imported {sorted(bad)[:5]}")
        with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
            json.dump(out, f, default=str)
    finally:
        dist.destroy_process_group()


def mesh_rank_run(torch, dist, rank: int, n: int, root: str, cfg,
                  dev) -> dict:
    """Runs (b), (c) and (d) of phase 13 on this rank; returns its
    readings."""
    import numpy as np
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import RunConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import sharding, train
    from repro_torch.models import model
    from repro_torch.optim import grad_compress
    from repro_torch.optim.tree import leaves, replica

    if dev.type == "cuda":
        torch.cuda.set_device(0)
        torch.cuda.reset_peak_memory_stats()
    check(torch.get_float32_matmul_precision() == "highest",
          "float32 products must not run as TF32")
    run, opt = mesh_run_opt()
    out = {"rank": rank, "pid": os.getpid()}
    mesh = init_device_mesh(dev.type, (n, 1, 1),
                            mesh_dim_names=("pod", "data", "model"))
    out["pod_coordinate"] = mesh.get_local_rank("pod")

    # ---- (b) the steps, one replica a rank
    params_r, opt_r, ef_r = train.init_replica_state(
        cfg, run, None, torch.Generator(device=dev).manual_seed(MESH_SEED),
        opt, mesh=mesh, device=dev)
    step, _ = train.make_train_step_compressed(cfg, run, opt_cfg=opt,
                                               mesh=mesh)
    batch = train_batch(torch, np, cfg, MESH_SEED, dev)
    out["n_leaves"] = len(leaves(params_r))
    steps = []
    for i in range(MESH_STEPS):
        dist.barrier()
        device_sync(torch, dev)
        ops.reset_launches()
        with TrainClock(torch, dev, "compress_pod_reduce") as clock:
            t0 = time.perf_counter()
            m = step(params_r, opt_r, ef_r, batch)[3]
            device_sync(torch, dev)
            sec = time.perf_counter() - t0
        ex_s = clock.s["compress_pod_reduce"]
        steps.append({"s": sec, "exchange_s": ex_s,
                      "exchange_share": ex_s / sec,
                      "launches": {k: ops.launches[k] for k in QDQ},
                      "loss": float(m["loss"])})
    out["steps"] = steps
    out["peak_device_bytes"] = (torch.cuda.max_memory_allocated()
                                if dev.type == "cuda" else None)
    mgr = CheckpointManager(os.path.join(root, "ckpt"), device=dev)
    a_params, _, _ = mgr.restore(MESH_STEPS)
    mine = replica(params_r, 0)
    out["vs_a_bit_exact"] = same_trees(torch, a_params, mine)
    out["vs_a_params_rel"] = tree_rel(torch, a_params, mine)
    identical = True
    for _, leaf in leaves(mine):
        got = leaf.clone() if rank == 0 else torch.empty_like(leaf)
        dist.broadcast(got, src=0)
        identical = identical and torch.equal(got, leaf)
    out["ranks_bit_identical"] = identical
    del params_r, opt_r, ef_r, a_params, mine
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the exchange across ranks on (a)'s recorded inputs
    held = torch.load(os.path.join(root, f"exchange_{rank}.pt"),
                      map_location=dev)
    g = {k: v["g"] for k, v in held.items()}
    e = {k: v["e"] for k, v in held.items()}
    grad_compress.compress_pod_reduce(g, e, mesh=mesh)
    out["exchange_exact"] = {
        k: [torch.equal(g[k], v["mean"]), torch.equal(e[k], v["new_e"])]
        for k, v in held.items()}
    del held, g, e

    # ---- (c) the elastic restore onto (data=2, model=1), fsdp
    mesh2 = init_device_mesh(dev.type, (n, 1),
                             mesh_dim_names=("data", "model"))
    rules = sharding.rules_for(mesh2, RunConfig(fsdp=True))
    shardings = sharding.param_shardings(model.model_specs(cfg), mesh2,
                                         rules)
    pl_of = dict(leaves(shardings))
    dist.barrier()
    device_sync(torch, dev)
    t0 = time.perf_counter()
    p, o, s = mgr.restore(MESH_STEPS, mesh=mesh2, shardings=shardings)
    device_sync(torch, dev)
    out["restore_s"] = time.perf_counter() - t0
    full_p, _, _ = mgr.restore(MESH_STEPS)
    coord = mesh2.get_coordinate()
    local = full = n_sharded = 0
    slices_exact = s == MESH_STEPS
    p_of = dict(leaves(p))
    for path, whole in leaves(full_p):
        dt = p_of[path]
        ok = isinstance(dt, DTensor) and dt.placements == pl_of[path]
        ok = ok and torch.equal(dt.to_local(), sharding.local_slice(
            whole, mesh2, pl_of[path], coord))
        slices_exact = slices_exact and ok
        n_sharded += any(isinstance(q, Shard) for q in pl_of[path])
        local += dt.to_local().numel() * whole.element_size()
        full += whole.numel() * whole.element_size()
    out["restore"] = {"slices_exact": slices_exact, "sharded_leaves":
                      n_sharded, "leaves": len(pl_of), "local_bytes": local,
                      "full_bytes": full, "opt_whole": all(
                          not isinstance(t, DTensor) for _, t in leaves(o))}
    del p, o, full_p, p_of
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # ---- (d) the plain step, data-parallel with fsdp on (data=2)
    out["dp"] = mesh_dp_run(torch, dist, root, cfg, dev, mesh2)
    return out


def mesh_dp_run(torch, dist, root: str, cfg, dev, mesh) -> dict:
    """Run (d) of phase 13 on this rank: ``init_train_state(mesh=)`` and
    ``MESH_STEPS`` steps of ``make_train_step(mesh=)`` with fsdp, the
    launch counts reset just before each step and read just after; the
    step-1 gradients and shards held to (a′) and to the one-process
    update.  Returns its readings."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.launch import sharding, train
    from repro_torch.optim import adamw
    from repro_torch.optim.tree import leaves, local, sharded, tree_map

    run, opt = mesh_run_opt()
    run = replace(run, fsdp=True)
    group, n = dist.group.WORLD, dist.get_world_size()
    coord = mesh.get_coordinate()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    params, state = train.init_train_state(
        cfg, run, torch.Generator(device=dev).manual_seed(MESH_SEED), opt,
        mesh=mesh, device=dev)
    step, _ = train.make_train_step(cfg, run, opt, mesh=mesh)
    batch = train_batch(torch, np, cfg, MESH_SEED, dev)
    moments = {k: v for k, v in state.items() if k != "step"}
    out = {"bytes": {name: {
        "local": sum(local(t).numel() * t.element_size()
                     for _, t in leaves(tree)),
        "full": sum(t.numel() * t.element_size() for _, t in leaves(tree))}
        for name, tree in (("params", params), ("moments", moments))},
        "sharded_leaves": sum(sharded(p) for _, p in leaves(params)),
        "leaves": len(leaves(params)),
        "sent_bytes_a_step": dp_step_bytes(params, n, run.microbatches)}
    old = tree_map(torch.clone, train._gather_params(params, group))
    plain = torch.load(os.path.join(root, "plain_grads.pt"), map_location=dev)
    steps = []
    for i in range(MESH_STEPS):
        dist.barrier()
        device_sync(torch, dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        with TrainClock(torch, dev, "_gather_params", "_reduce_grads",
                        keep=("_reduce_grads",)) as clock:
            t0 = time.perf_counter()
            m = step(params, state, batch)[2]
            device_sync(torch, dev)
            sec = time.perf_counter() - t0
        launches = {k: ops.launches[k] for k in KERNELS}
        identical = True
        for _, p in leaves(params):
            if not sharded(p):
                got = local(p).clone()
                dist.broadcast(got, src=0)
                identical = identical and torch.equal(got, local(p))
        g_s, r_s = clock.s["_gather_params"], clock.s["_reduce_grads"]
        steps.append({"s": sec, "gather_s": g_s, "gather_share": g_s / sec,
                      "reduce_s": r_s, "reduce_share": r_s / sec,
                      "launches": launches, "loss": m["loss"].item(),
                      "grad_norm": m["grad_norm"].item(),
                      "replicated_identical": identical,
                      "peak_device_bytes": (torch.cuda.max_memory_allocated()
                                            if dev.type == "cuda" else None)})
        if i:
            continue
        # step 1: the gathered gradients against (a′)'s, and each shard
        # against the one-process update of the gathered gradients
        grads = train._gather_params(clock.last.pop("_reduce_grads"), group)
        out["grads_rel"] = {
            name: float((leaf_at(grads, name) - g).abs().max()
                        / g.abs().max()) for name, g in plain.items()}
        want = tree_map(torch.clone, old)
        adamw.adamw_update_(want, grads, adamw.adamw_init(want, opt), opt)
        del grads
        w_of, o_of = dict(leaves(want)), dict(leaves(old))
        worst, exact = 0.0, True
        for path, p in leaves(params):
            w = sharding.local_slice(w_of[path], mesh, p.placements, coord)
            o = sharding.local_slice(o_of[path], mesh, p.placements, coord)
            worst = max(worst, update_rel(torch, w, local(p), o))
            exact = exact and torch.equal(w, local(p))
        out["update_rel"], out["update_bit_exact"] = worst, exact
        del want, w_of, o_of, old, plain
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    out["steps"] = steps
    return out


def mesh_training(torch, smi: str, dev="cuda") -> dict:
    """Phase 13: run (a), the two-replica step in one process and a
    checkpoint of replica 0; run (a′), the plain step in one process;
    runs (b), (c) and (d) in two spawned gloo ranks on the one card
    (:func:`mesh_rank`).  Returns the printed readings with the ranks'
    launch counts."""
    import shutil

    import numpy as np

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import model
    from repro_torch.optim import grad_compress
    from repro_torch.optim.tree import leaves, replica

    dev = torch.device(dev)
    t_phase = time.perf_counter()
    cfg = replace(get_config(LOOP_ARCH), n_layers=MESH_LAYERS,
                  dtype="float32")
    run, opt = mesh_run_opt()
    root = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    out = {"card": smi, "arch": cfg.name, "layers": cfg.n_layers,
           "params": model.param_counts(cfg)[0], "dtype": "float32",
           "batch": TRAIN_BATCH, "n_pods": MESH_PODS, "steps": MESH_STEPS,
           "optimizer": "adamw lr=1e-3 warmup=1", "run": "remat=layer",
           "transport": "gloo, two ranks on one card: nothing crosses a "
                        "link"}
    try:
        # ---- (a) one process, two replicas
        params_r, opt_r, ef_r = train.init_replica_state(
            cfg, run, MESH_PODS,
            torch.Generator(device=dev).manual_seed(MESH_SEED), opt,
            device=dev)
        step, _ = train.make_train_step_compressed(cfg, run, MESH_PODS, opt)
        batch = train_batch(torch, np, cfg, MESH_SEED, dev)
        want = {tuple(leaf_at(params_r, name).shape): name
                for name in TRAIN_EXCHANGE_LEAVES}
        check(len(want) == len(TRAIN_EXCHANGE_LEAVES)
              and sum(tuple(a.shape) in want for _, a in leaves(params_r))
              == len(want), f"mesh: recorded shapes {want}")
        n_leaves = len(leaves(params_r))
        a_steps = []
        with RecordExchange(want) as rec:
            for _ in range(MESH_STEPS):
                device_sync(torch, dev)
                ops.reset_launches()
                t0 = time.perf_counter()
                m = step(params_r, opt_r, ef_r, batch)[3]
                device_sync(torch, dev)
                a_steps.append({"s": time.perf_counter() - t0,
                                "loss": float(m["loss"]),
                                "launches": {k: ops.launches[k]
                                             for k in QDQ}})
        out["a_steps"] = a_steps
        # the bytes a step sends between the replicas, against float32
        sizes = [a[0].numel() for _, a in leaves(params_r)]
        groups = [-(-n // grad_compress.GROUP) for n in sizes]
        out["exchange_bytes"] = {
            "int8_codes": sum(g * grad_compress.GROUP for g in groups),
            "float32_scales": 4 * sum(groups),
            "float32_gradients": 4 * sum(sizes)}
        # (a)'s last exchange on the recorded leaves, one file a rank
        held = [{} for _ in range(MESH_PODS)]
        for name in list(rec.seen):
            g, e = rec.seen.pop(name)
            mean, new_e = grad_compress.exchange_leaf(g, e, MESH_PODS)
            for r in range(MESH_PODS):
                held[r][name] = {k: v[r:r + 1].cpu() for k, v in (
                    ("g", g), ("e", e), ("mean", mean), ("new_e", new_e))}
            del g, e, mean, new_e
        check(set(held[0]) == set(TRAIN_EXCHANGE_LEAVES),
              f"mesh: recorded {sorted(held[0])}")
        for r in range(MESH_PODS):
            torch.save(held[r], os.path.join(root, f"exchange_{r}.pt"))
        del held
        t0 = time.perf_counter()
        CheckpointManager(os.path.join(root, "ckpt"), device=dev).save(
            MESH_STEPS, replica(params_r, 0), replica(opt_r, 0),
            blocking=True)
        out["a_save_s"] = time.perf_counter() - t0
        del params_r, opt_r, ef_r, rec
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        # ---- (a′) the plain step in one process; its step-1 gradients
        params, opt_state = train.init_train_state(
            cfg, run, torch.Generator(device=dev).manual_seed(MESH_SEED),
            opt, device=dev)
        step, _ = train.make_train_step(cfg, run, opt)
        plain_steps = []
        with RecordGrads(TRAIN_EXCHANGE_LEAVES) as rec:
            for _ in range(MESH_STEPS):
                device_sync(torch, dev)
                ops.reset_launches()
                t0 = time.perf_counter()
                m = step(params, opt_state, batch)[2]
                device_sync(torch, dev)
                plain_steps.append({"s": time.perf_counter() - t0,
                                    "loss": float(m["loss"]),
                                    "grad_norm": float(m["grad_norm"]),
                                    "launches": {k: ops.launches[k]
                                                 for k in KERNELS}})
        torch.save(rec.first, os.path.join(root, "plain_grads.pt"))
        out["plain_steps"] = plain_steps
        del params, opt_state, batch, rec
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        # ---- (b), (c): two ranks on the one card
        t0 = time.perf_counter()
        ctx = torch.multiprocessing.start_processes(
            mesh_rank, args=(MESH_PODS, root, cfg, dev.type),
            nprocs=MESH_PODS, join=False, start_method="spawn")
        try:
            while not ctx.join(timeout=2):
                check(time.perf_counter() - t0 < MESH_JOIN_S,
                      f"mesh: the ranks did not end in {MESH_JOIN_S} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
                proc.join(10)
        out["ranks_s"] = time.perf_counter() - t0
        ranks = []
        for r in range(MESH_PODS):
            with open(os.path.join(root, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        out["ranks"] = ranks
        out["launches"] = {f"rank{r['rank']}_step{i}": st["launches"]
                           for r in ranks for i, st in enumerate(r["steps"])}
        out["a_launches"] = [st["launches"] for st in a_steps]
        # (a′) and (d): no kernel is on the plain step's path
        out["dp_launches"] = {f"dp_rank{r['rank']}_step{i}": st["launches"]
                              for r in ranks
                              for i, st in enumerate(r["dp"]["steps"])}
        out["dp_launches"].update({f"plain_step{i}": st["launches"]
                                   for i, st in enumerate(plain_steps)})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    want = plain_steps[0]["loss"]
    out["dp_step1_loss_rel"] = abs(
        ranks[0]["dp"]["steps"][0]["loss"] - want) / abs(want)
    print("mesh: " + json.dumps(out, default=str))
    d = ranks[0]["dp"]
    print("mesh (d), rank 0, fsdp on (data=2, model=1), two ranks on one "
          "card through gloo, nothing crosses a link: " + json.dumps({
              "step_s": [st["s"] for st in d["steps"]],
              "gather_share": [st["gather_share"] for st in d["steps"]],
              "reduce_share": [st["reduce_share"] for st in d["steps"]],
              "sent_bytes_a_step": d["sent_bytes_a_step"]["total"],
              "compressed_step_sent_bytes": sum(
                  out["exchange_bytes"][k]
                  for k in ("int8_codes", "float32_scales")),
              "peak_device_bytes": [st["peak_device_bytes"]
                                    for st in d["steps"]],
              "local_over_full": {k: v["local"] / v["full"]
                                  for k, v in d["bytes"].items()},
              "plain_step_s": [st["s"] for st in out["plain_steps"]],
              "step1_loss_rel": out["dp_step1_loss_rel"],
              "grads_rel": d["grads_rel"], "update_rel": d["update_rel"]}))
    for r in ranks:
        check(r["pod_coordinate"] == r["rank"], f"mesh: rank {r['rank']} "
              f"at pod {r['pod_coordinate']}")
        check(r["n_leaves"] == n_leaves, f"mesh: {r['n_leaves']} leaves")
        check(r["ranks_bit_identical"], "mesh: the ranks' parameters differ")
        check(r["vs_a_params_rel"] <= LOOP_RESUME_REL_MAX,
              f"mesh: rank {r['rank']} {r['vs_a_params_rel']} from (a)")
        check(all(all(v) for v in r["exchange_exact"].values()),
              f"mesh: rank {r['rank']} exchange {r['exchange_exact']}")
        check(r["restore"]["slices_exact"] and r["restore"]["opt_whole"]
              and r["restore"]["sharded_leaves"] > 0,
              f"mesh: rank {r['rank']} restore {r['restore']}")
        check(all(np.isfinite(st["loss"]) for st in r["steps"]),
              f"mesh: rank {r['rank']} losses")
    for key, got in out["launches"].items():
        check(got == {k: n_leaves for k in QDQ},
              f"mesh: {key} launched {got}, not {n_leaves} of each")
    for got in out["a_launches"]:
        check(got == {k: n_leaves for k in QDQ}, f"mesh: (a) launched {got}")
    # (d) against (a′)
    dps = [r["dp"] for r in ranks]
    for i in range(MESH_STEPS):
        check(len({(d["steps"][i]["loss"], d["steps"][i]["grad_norm"])
                   for d in dps}) == 1, f"mesh: (d) step {i + 1}'s loss and "
              f"grad_norm differ between the ranks")
    rel = out["dp_step1_loss_rel"]
    check(rel <= DP_LOSS_REL_MAX, f"mesh: (d) step 1's loss {rel} from (a′)")
    for d in dps:
        check(all(st["replicated_identical"] for st in d["steps"]),
              "mesh: (d) replicated leaves differ between the ranks")
        check(max(d["grads_rel"].values()) <= DP_GRAD_REL_MAX,
              f"mesh: (d) gradients {d['grads_rel']} from (a′)'s")
        check(d["update_rel"] <= DP_UPDATE_REL_MAX,
              f"mesh: (d) shards {d['update_rel']} from the update")
        check(d["sharded_leaves"] > 0 and d["bytes"]["params"]["local"]
              < d["bytes"]["params"]["full"], f"mesh: (d) {d['bytes']}")
        check(all(np.isfinite(st["loss"]) for st in d["steps"]),
              "mesh: (d) losses")
    for key, got in out["dp_launches"].items():
        check(not any(got.values()), f"mesh: {key} launched {got}")
    return out


def main() -> int:
    t_start = time.perf_counter()
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        return fail("run from a checkout: src/repro_torch is missing")
    import torch
    if not torch.cuda.is_available():
        return fail("no CUDA device available")
    sys.path.insert(0, SRC)
    import numpy as np

    from repro_torch import io as tio
    from repro_torch.core import amr, gsp, hybrid
    from repro_torch.core.entropy import TorchEngine
    from repro_torch.kernels import build, ops, ref
    from repro_torch.obs import metrics as obsm

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    dev = torch.device("cuda")

    # ---------------------------------------------------------- 1. build
    t0 = time.perf_counter()
    build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    for name, log in build.build_logs().items():
        fn = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                # the mangled name past the anonymous namespace's prefix
                fn = line.split("'")[1].split("_cu_")[-1][:64]
            elif "registers" in line or "spill" in line:
                print(f"  ptxas {name} {fn}: {line.strip()}")

    # ---------------------------------------------------------- 2. main path
    t0 = time.perf_counter()
    ds = amr.synthetic_amr(SHAPE, densities=DENSITIES, refine_block=16,
                           lognormal_sigma=1.8, seed=10)
    fine = ds.levels[0]
    vals = fine.data[fine.mask]
    eb = 1e-3 * float(vals.max() - vals.min())
    print(f"data: {SHAPE} levels={ds.n_levels} eb={eb:.6g} "
          f"gen {time.perf_counter() - t0:.1f} s")

    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    stages = {}
    snap_dir = tempfile.TemporaryDirectory()      # kept to phase 2e
    timers = [stage_timer_readings(obsm)]         # phase 2e prints them
    with RecordBrickShapes(ops) as shapes2:
        path = os.path.join(snap_dir.name, "snap.tacz")
        t0 = time.perf_counter()
        res = hybrid.compress_amr(ds, eb=eb, device="cuda")
        torch.cuda.synchronize()
        stages["compress_s"] = time.perf_counter() - t0
        timers.append(stage_timer_readings(obsm))
        t0 = time.perf_counter()
        tio.write(path, res, device="cuda")
        stages["write_s"] = time.perf_counter() - t0
        timers.append(stage_timer_readings(obsm))
        t0 = time.perf_counter()
        levels = tio.read(path, device="cuda")
        torch.cuda.synchronize()
        stages["read_s"] = time.perf_counter() - t0
        timers.append(stage_timer_readings(obsm))
        t0 = time.perf_counter()
        roi = tio.read_roi(path, ROI_BOX, device="cuda")
        torch.cuda.synchronize()
        stages["read_roi_s"] = time.perf_counter() - t0
        launches = dict(ops.launches)
        file_bytes = os.path.getsize(path)
        read_ab = read_turns(torch, ops, lambda: tio.read(path, device="cuda"))
        read_prof = device_profile(torch,
                                   lambda: tio.read(path, device="cuda"))
        roi_prof = device_profile(
            torch, lambda: tio.read_roi(path, ROI_BOX, device="cuda"))
        placement = placement_turns(torch, tio, path, smi)
        with tio.TACZReader(path, device="cuda") as rd:
            check(rd.verify(), "container CRCs")
            entry0 = rd.levels[0]
            jobs = [(sb, tuple(sb.size), None) for sb in entry0.subblocks]
            parts = [rd._payload_parts(0, sb, shape) for sb, shape, _ in jobs]
            payloads0 = [(cb, sb.nbits, sb.n_codes)
                         for (cb, _), sb in zip(parts, entry0.subblocks)]
            codebook0 = rd._codebook(0)
    peak = torch.cuda.max_memory_allocated()

    for li, (lr, got) in enumerate(zip(res.levels, levels)):
        check(torch.equal(got, lr.recon), f"level {li}: read != recon")
        lvl = ds.levels[li]
        orig = torch.from_numpy(lvl.data).to(dev)
        mask = torch.from_numpy(lvl.mask).to(dev)
        err = float((got - orig).abs()[mask].max())
        limit = lr.eb + 2.0 ** -22 * float(orig.abs().max())
        check(err <= limit, f"level {li}: max err {err} > {limit}")
        print(f"level {li}: strategy={lr.strategy} subblocks={lr.n_subblocks} "
              f"values={lr.n_values} max_err={err:.6g} limit={limit:.6g}")
    for c in roi:
        want = levels[c.level][tuple(slice(lo, hi) for lo, hi in c.box)]
        check(torch.equal(c.data, want), f"roi level {c.level} != slice")
    raw_bytes = 4 * res.n_values
    print("main path: " + json.dumps({
        "card": smi, **{k: round(v, 3) for k, v in stages.items()},
        "compression_ratio_bits": res.compression_ratio(),
        "compression_ratio_file": raw_bytes / file_bytes,
        "file_bytes": file_bytes, "peak_device_bytes": peak,
        "launches": launches}))
    print("main path read, K4 chunked vs its serial walk forced (s, in "
          "turns): " + json.dumps({"card": smi, **read_ab}))
    print("main path read, device time by kernel: "
          + json.dumps({"card": smi, **read_prof}))
    print("main path read_roi, device time by kernel: "
          + json.dumps({"card": smi, **roi_prof}))
    print("finest level placement, batched vs per-brick loop (s, in "
          "turns): " + json.dumps(placement))
    for name in ("lorenzo3d_codes_batched", "lorenzo3d_recon_batched",
                 "hist", "huffdec"):
        check(launches[name] > 0,
              f"kernel {name} never launched on the main path")
    check(read_prof["kernel_launches"] < 1000,
          f"the read made {read_prof['kernel_launches']} launches")

    # ------------------------------------------------ 2b. region serving
    region = region_serving(torch, np, ops, tio, path, levels, smi)
    print("region serving: " + json.dumps(region))

    # --------------------------------------------- 2c. multi-part snapshots
    mpart = multipart(torch, np, ops, tio, ds, res, eb, path, levels, smi)
    print("multi-part: " + json.dumps(mpart))

    # ------------------------------- 2d. tuning and variant serving
    tuning = tuning_serving(torch, np, ops, tio, ds, smi)
    print("variant serving: " + json.dumps(tuning["serving"]))

    # ------------------------ 2e. sharded serving, load and SLOs
    t0 = time.perf_counter()
    shard = sharded_serving(torch, np, ops, tio, path, levels, smi)
    shard["phase_s"] = time.perf_counter() - t0
    snap_dir.cleanup()
    # the stage timers phase 2's compress and read recorded
    shard["stage_timers"] = {
        "compress": timer_delta(timers[1], timers[0]),
        "read": timer_delta(timers[3], timers[2])}
    print("sharded serving: " + json.dumps(shard))
    for name in ("prequant", "branch_score", "entropy", "compress_level"):
        check(shard["stage_timers"]["compress"][name]["count"] > 0,
              f"stage timer {name} never observed in phase 2's compress")
    check(shard["stage_timers"]["read"]["entropy_decode"]["count"] > 0,
          "stage timer entropy_decode never observed in phase 2's read")
    print("sharded serving: fleet warm batch "
          f"{shard['fleet_warm_s']} s against the single server's "
          f"{shard['single_warm_s']} s (the bench's bar: fleet faster; "
          f"{shard['fleet_over_single']:.3f}x) [{smi}]")

    # ------------------------------------------------- 3. kernels vs plain
    rows = []

    def row(name, err, ms, plain_ms, bytes_moved, ops_count, library_ms,
            n_launches=None):
        rows.append(kernel_row(
            name, err, ms, plain_ms, bytes_moved, ops_count, library_ms,
            launches[name] if n_launches is None else n_launches, smi))

    # K1/K2 on the largest same-shape stack of the finest level
    grid, _, _, subblocks = hybrid.partition_level(
        fine.data, fine.mask, unit=8)
    groups: dict = {}
    for sb in subblocks:
        groups.setdefault(tuple(sb.cell_size(grid.unit)), []).append(sb)
    shape, sbs = max(groups.items(),
                     key=lambda kv: len(kv[1]) * int(np.prod(kv[0])))
    u = grid.unit
    x = torch.from_numpy(np.stack([
        grid.data[tuple(slice(o * u, o * u + s) for o, s
                        in zip(sb.origin, shape))] for sb in sbs])).to(dev)
    n_el = x.numel()
    print(f"K1/K2 stack: {len(sbs)} x {shape}")
    codes = ops.lorenzo3d_codes_batched(x, eb)
    plain = ref.lorenzo3d_codes_batched(x, eb)
    check(torch.equal(codes, plain), "K1 != plain")
    check(ops.codes_route(x) == "planes", f"K1 route for {shape}")
    # K1 as one thread per element (the K1 of earlier builds) on the same
    # stack, through its C entry, in turns: new, elementwise, elementwise,
    # new
    k1_old, k1_old_out = k1_elementwise(torch, ops, build, x, eb)
    k1_old()
    check(torch.equal(k1_old_out, plain), "elementwise K1 != plain")
    k1_ms = cuda_ms(lambda: ops.lorenzo3d_codes_batched(x, eb), 20, torch)
    k1_old_ms = cuda_ms(k1_old, 20, torch)
    k1_old_ms_2 = cuda_ms(k1_old, 20, torch)
    k1_ms_2 = cuda_ms(lambda: ops.lorenzo3d_codes_batched(x, eb), 20, torch)
    k1_row = kernel_row(
        "lorenzo3d_codes_batched", 0, k1_ms,
        cuda_ms(lambda: ref.lorenzo3d_codes_batched(x, eb), 5, torch),
        12 * n_el, 12 * n_el, None, launches["lorenzo3d_codes_batched"], smi,
        ms_turns=[k1_ms, k1_ms_2],
        elementwise_ms_turns=[k1_old_ms, k1_old_ms_2])
    rows.append(k1_row)
    del k1_old_out
    recon = ops.lorenzo3d_recon_batched(codes, eb)
    plain_r = ref.lorenzo3d_recon_batched(codes, eb)
    check(torch.equal(recon, plain_r), "K2 != plain")
    check(ops.recon_route(shape) == "shared", f"K2 route for {shape}")
    # the three-pass route (the K2 of earlier builds) on the same stack,
    # through its C entry, for a same-call comparison
    three_pass, three = k2_three_pass(torch, ops, build, codes, eb)
    three_pass()
    check(torch.equal(three, plain_r), "K2 three-pass route != plain")
    k2_ms = cuda_ms(lambda: ops.lorenzo3d_recon_batched(codes, eb), 20, torch)
    k2_three_ms = cuda_ms(three_pass, 20, torch)
    k2_ms_2 = cuda_ms(lambda: ops.lorenzo3d_recon_batched(codes, eb), 20, torch)
    k2_three_ms_2 = cuda_ms(three_pass, 20, torch)
    rows.append(kernel_row(
        "lorenzo3d_recon_batched", float((recon - plain_r).abs().max()),
        k2_ms, cuda_ms(lambda: ref.lorenzo3d_recon_batched(codes, eb), 5,
                       torch),
        12 * n_el, 5 * n_el, None, launches["lorenzo3d_recon_batched"], smi,
        brick_route="shared", ms_turns=[k2_ms, k2_ms_2],
        three_pass_ms_turns=[k2_three_ms, k2_three_ms_2]))
    del x, codes, plain, recon, plain_r, three
    k2_seen = check_k2_shapes(torch, ops, ref, build, shapes2["recon"], eb,
                              "the TAC+ main path", smi)
    k1_seen = check_k1_shapes(torch, ops, ref, build, shapes2["codes"], eb,
                              "the TAC+ main path", smi)
    big = torch.randint(-2 ** 20, 2 ** 20, K2_THREE_PASS_SHAPE, device=dev)
    check(ops.recon_route(K2_THREE_PASS_SHAPE[1:]) == "three_pass",
          f"{K2_THREE_PASS_SHAPE} should take the three-pass route")
    check(torch.equal(ops.lorenzo3d_recon_batched(big, eb),
                      ref.lorenzo3d_recon_batched(big, eb)),
          f"K2 != plain on the three-pass shape {K2_THREE_PASS_SHAPE}")
    print(f"K2 == plain on the three-pass shape {K2_THREE_PASS_SHAPE}")
    del big

    # K3 on the finest level's pooled codes
    pooled = torch.cat([r.codes for r in res.levels[0].artifacts.results])
    lo, hi = (int(v) for v in torch.aminmax(pooled))
    span = hi - lo + 1
    counts = ops.hist(pooled, lo, span)
    check(torch.equal(counts, ref.hist(pooled, lo, span)), "K3 != plain")
    check(torch.equal(counts, torch.bincount(pooled - lo, minlength=span)),
          "K3 != bincount")
    shifted = pooled - lo
    row("hist", 0,
        cuda_ms(lambda: ops.hist(pooled, lo, span), 20, torch),
        cuda_ms(lambda: ref.hist(pooled, lo, span), 5, torch),
        8 * pooled.numel() + 8 * span, 2 * pooled.numel(),
        cuda_ms(lambda: torch.bincount(shifted, minlength=span), 20, torch))
    print(f"K3 input: {pooled.numel()} codes, span {span}")
    del pooled, shifted, counts

    # K4 on every payload of the finest level: the chunked decode settles
    # every payload with no serial walk, and equals its own serial walk
    # and the codes the compressor encoded; then with a truncated copy of
    # the first payload added, which the serial walk must take
    eng = TorchEngine(dev)
    args = eng.huffdec_args(codebook0, payloads0)
    n_out = args[5]
    out_k, err_k = ops.huffdec(*args)
    k4_level = k4_stats(ops)
    check(k4_level["serial_payloads"] == 0 and not bool(err_k.any()),
          f"K4 on the finest level: {k4_level}")
    check(torch.equal(out_k, torch.cat(
        [r.codes.reshape(-1) for r in res.levels[0].artifacts.results])),
        "K4 != the compress-time codes of the finest level")
    t0 = time.perf_counter()
    out_s, err_s = ops.huffdec(*args, serial=True)
    torch.cuda.synchronize()
    k4_serial_ms = (time.perf_counter() - t0) * 1e3
    check(torch.equal(out_k, out_s) and torch.equal(err_k, err_s),
          "K4 chunked != its serial walk on the finest level")
    del out_s, err_s
    trunc_set = payloads0 + [(payloads0[0][0], payloads0[0][1] // 2,
                              payloads0[0][2])]
    targs = eng.huffdec_args(codebook0, trunc_set)
    st = k4_vs_serial(torch, ops, targs, "the level + a truncated copy")
    check(st["serial_payloads"] == 1, f"K4 truncated copy: {st}")
    print(f"K4 == serial walk == compress-time codes on all "
          f"{len(payloads0)} payloads of the finest level: "
          f"{json.dumps(k4_level)}; with a truncated copy: {json.dumps(st)}")
    del targs, out_k, err_k

    # K4 against its plain version on the finest level's payloads of at
    # most PLAIN_K4_MAX_SYMBOLS symbols plus a truncated copy of the longest
    # of them (the plain lockstep decoder runs one step per symbol of the
    # longest payload)
    short = [p for p in payloads0 if p[2] <= PLAIN_K4_MAX_SYMBOLS]
    trunc = max(short, key=lambda p: p[2])
    short = short + [(trunc[0], trunc[1] // 2, trunc[2])]
    sargs = eng.huffdec_args(codebook0, short)
    out_k, err_k = ops.huffdec(*sargs)
    t0 = time.perf_counter()
    out_p, err_p = ref.huffdec(*sargs)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    check(torch.equal(out_k, out_p) and torch.equal(err_k, err_p),
          "K4 != plain on the level's payloads")
    check(int(err_k[-1]) == 1 and not bool(err_k[:-1].any()),
          "K4 error kinds on the level's payloads")
    print(f"K4 plain check: {len(short)} payloads, {sargs[5]} symbols, "
          f"max {trunc[2]} per payload, plain {plain_ms:.1f} ms")
    # ... and the seeded adversarial cases, at every chunk size
    from repro_torch.kernels import huffdec_cases
    adv = {}
    for cbits in K4_CHUNK_BITS:
        for name, cb, pays in huffdec_cases.cases(cbits, seed=cbits):
            cargs = eng.huffdec_args(cb, pays)
            ok, er = ops.huffdec(*cargs, chunk_bits=cbits)
            st = k4_stats(ops)
            op, ep = ref.huffdec(*cargs)
            check(torch.equal(ok, op) and torch.equal(er, ep),
                  f"K4 != plain on the adversarial case {name} at "
                  f"chunk_bits={cbits}")
            k4_vs_serial(torch, ops, cargs, name, chunk_bits=cbits)
            adv[f"{name}@{cbits}"] = {**st, "err": er.tolist()}
    for cbits in K4_CHUNK_BITS:
        check(adv[f"fixed_length_never_syncs@{cbits}"]["serial_payloads"]
              == 1, "K4: the fixed-length case must take the serial walk")
        check(adv[f"gap_past_first_chunk@{cbits}"]["err"] == [2, 0, 1, 0],
              "K4 error kinds on the gap case")
        check(adv[f"truncated_at_chunk_boundary@{cbits}"]["err"]
              == [1, 1, 0, 0], "K4 error kinds on the truncation case")
    print("K4 == plain == serial walk on the adversarial cases: "
          + json.dumps(adv))
    # K4 timed on the whole level, chunk sizes in turns (up, then down),
    # from CUDA graphs: the chunk size moves device work only
    ab = {c: [] for c in K4_CHUNK_BITS}
    for cbits in K4_CHUNK_BITS + K4_CHUNK_BITS[::-1]:
        ab[cbits].append(graph_ms(
            lambda: ops.huffdec(*args, chunk_bits=cbits), 5, torch))
    ab_stats = {}
    for cbits in K4_CHUNK_BITS:
        ab_stats[cbits] = k4_vs_serial(torch, ops, args, "the finest level",
                                       chunk_bits=cbits)
    print("K4 chunk-size A/B on the finest level (graph ms, in turns): "
          + json.dumps({"card": smi, "ms": ab, "stats": ab_stats}))
    print("K4 on the finest level, device time by kernel: " + json.dumps(
        {"card": smi, **device_profile(torch, lambda: ops.huffdec(*args))}))
    walked_bits = sum(min(nb, 8 * len(b)) for b, nb, _ in payloads0)
    k4_ms = cuda_ms(lambda: ops.huffdec(*args), 10, torch)
    k4_row = kernel_row(
        "huffdec", 0, k4_ms, plain_ms,
        int(args[0].numel()) + 8 * n_out + 36 * len(payloads0),
        walked_bits * 4, None, launches["huffdec"], smi,
        graph_ms=graph_ms(lambda: ops.huffdec(*args), 10, torch),
        chunk_bits=ops.HUFF_CHUNK_BITS, serial_walk_ms=k4_serial_ms,
        sync=k4_level)
    rows.append(k4_row)
    print(f"K4 input: {len(payloads0)} payloads, {n_out} symbols, "
          f"max {max(p[2] for p in payloads0)} per payload")
    del out_k, err_k, out_p, err_p

    del payloads0, args, sargs, res, levels, roi

    # ---------------------------------------------------------- 4. TAC path
    t0 = time.perf_counter()
    ds4 = amr.synthetic_amr(SHAPE, densities=TAC_DENSITIES, refine_block=16,
                            lognormal_sigma=2.6, seed=3)
    vals = ds4.levels[0].data[ds4.levels[0].mask]
    eb4 = 1e-3 * float(vals.max() - vals.min())
    coarse_li = ds4.n_levels - 1
    coarse = ds4.levels[coarse_li]
    print(f"TAC data: {SHAPE} levels={ds4.n_levels} "
          f"densities={[round(l.density, 4) for l in ds4.levels]} "
          f"eb={eb4:.6g} gen {time.perf_counter() - t0:.1f} s")
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    tac = {}
    with tempfile.TemporaryDirectory() as tmp, \
            RecordBrickShapes(ops) as shapes4:
        for alg in TAC_ALGORITHMS:
            st = {}
            t0 = time.perf_counter()
            res4 = hybrid.compress_amr(ds4, eb=eb4, algorithm=alg, she=False,
                                       device="cuda")
            torch.cuda.synchronize()
            st["compress_s"] = time.perf_counter() - t0
            check(res4.method == f"tac/{alg}", f"{alg}: method {res4.method}")
            for li, lr in enumerate(res4.levels):
                lvl = ds4.levels[li]
                orig = torch.from_numpy(lvl.data).to(dev)
                mask = torch.from_numpy(lvl.mask).to(dev)
                err = float((lr.recon - orig).abs()[mask].max())
                limit = lr.eb + 2.0 ** -22 * float(orig.abs().max())
                check(err <= limit, f"{alg} level {li}: max err {err} > "
                                    f"{limit}")
                print(f"{alg} level {li}: strategy={lr.strategy} "
                      f"density={lr.density:.4f} subblocks={lr.n_subblocks} "
                      f"bits={lr.total_bits} max_err={err:.6g} "
                      f"limit={limit:.6g}")
                del orig, mask
            check(res4.levels[coarse_li].strategy == "gsp",
                  f"{alg}: coarse level took "
                  f"{res4.levels[coarse_li].strategy}, not gsp")
            recon_c = res4.levels[coarse_li].recon
            codes_c = res4.levels[coarse_li].artifacts.results[0].codes
            path = os.path.join(tmp, f"{alg}.tacz")
            t0 = time.perf_counter()
            with tio.TACZWriter(path, eb=eb4, algorithm=alg, she=False,
                                strategy="gsp", device="cuda") as w:
                w.add_level(coarse.data, coarse.mask, ratio=coarse.ratio)
            st["write_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            got, = tio.read(path, device="cuda")
            torch.cuda.synchronize()
            st["read_s"] = time.perf_counter() - t0
            check(torch.equal(got, recon_c), f"{alg}: read != recon")
            t0 = time.perf_counter()
            crop, = tio.read_roi(path, ROI_BOX, device="cuda")
            torch.cuda.synchronize()
            st["read_roi_s"] = time.perf_counter() - t0
            check(torch.equal(crop.data, got[tuple(
                slice(lo, hi) for lo, hi in crop.box)]), f"{alg}: roi")
            with tio.TACZReader(path, device="cuda") as rd:
                check(rd.verify(), f"{alg}: container CRCs")
            st["compression_ratio_bits"] = res4.compression_ratio()
            st["coarse_file_bytes"] = os.path.getsize(path)
            tac[alg] = (st, path, codes_c.reshape(-1))
            del res4, recon_c, got, crop, codes_c
        launches4 = dict(ops.launches)
        peak4 = torch.cuda.max_memory_allocated()
        for alg, (st, path, codes_c) in tac.items():
            # K4 on the level's one GSP payload (after the counts were read):
            # equal to its serial walk and to the compress-time codes, with
            # no serial payload; timed at each chunk size in turns
            with tio.TACZReader(path, device="cuda") as rd:
                sb = rd.levels[0].subblocks[0]
                code_bytes, _ = rd._payload_parts(0, sb, rd.subblock_shape(0, 0))
                gargs = eng.huffdec_args(rd._codebook(0),
                                         [(code_bytes, sb.nbits, sb.n_codes)])
            gout, gerr = ops.huffdec(*gargs)
            st["k4_gsp_sync"] = k4_stats(ops)
            check(st["k4_gsp_sync"]["serial_payloads"] == 0
                  and not bool(gerr.any()), f"{alg}: K4 on the GSP payload "
                                            f"{st['k4_gsp_sync']}")
            check(torch.equal(gout, codes_c),
                  f"{alg}: K4 != the compress-time codes of the GSP level")
            t0 = time.perf_counter()
            sout, serr = ops.huffdec(*gargs, serial=True)
            torch.cuda.synchronize()
            st["k4_gsp_serial_walk_ms"] = (time.perf_counter() - t0) * 1e3
            check(torch.equal(gout, sout) and torch.equal(gerr, serr),
                  f"{alg}: K4 chunked != its serial walk on the GSP payload")
            ab = {c: [] for c in K4_CHUNK_BITS}
            for cbits in K4_CHUNK_BITS + K4_CHUNK_BITS[::-1]:
                ab[cbits].append(graph_ms(
                    lambda: ops.huffdec(*gargs, chunk_bits=cbits), 10, torch))
            st["k4_gsp_chunk_ab_graph_ms"] = ab
            st["k4_gsp_payload_ms"] = cuda_ms(lambda: ops.huffdec(*gargs), 20,
                                              torch)
            st["k4_gsp_payload_graph_ms"] = graph_ms(
                lambda: ops.huffdec(*gargs), 20, torch)
            st["gsp_payload_symbols"] = sb.n_codes
            st["gsp_payload_bytes"] = int(gargs[0].numel())
            if alg == TAC_ALGORITHMS[0]:
                st["k4_gsp_profile"] = device_profile(
                    torch, lambda: ops.huffdec(*gargs))
                st["read_turns"] = read_turns(
                    torch, ops, lambda: tio.read(path, device="cuda"))
            print(f"TAC {alg}: " + json.dumps({"card": smi, **{
                k: (round(v, 4) if isinstance(v, float) else v)
                for k, v in st.items()}}))
            del gout, gerr, sout, serr, codes_c
    print("TAC path: " + json.dumps({"peak_device_bytes": peak4,
                                     "launches": launches4}))
    for name in ("lorenzo3d_codes", "lorenzo3d_recon"):
        check(launches4[name] > 0,
              f"kernel {name} never launched on the TAC path")
    k2_seen += check_k2_shapes(torch, ops, ref, build, shapes4["recon"],
                               eb4, "the TAC path", smi)
    k1_seen += check_k1_shapes(torch, ops, ref, build, shapes4["codes"],
                               eb4, "the TAC path", smi)
    check(all(s["route"] != "three_pass" for s in k2_seen),
          f"a main-path brick shape takes the three-pass route: {k2_seen}")
    k1_row["brick_shapes"] = len(k1_seen)
    # the plane walk against the elementwise kernel where it takes the
    # shape (small stacks take the elementwise kernel itself)
    k1_row["slower_than_elementwise"] = [
        s["brick"] for s in k1_seen if s["route"] == "planes"
        and min(s["graph_ms"], s["graph_ms_2"]) > s["elementwise_graph_ms"]]
    # K4's row carries the GSP payload as its second shape
    g = tac["lorenzo"][0]
    g_bytes, g_syms = g["gsp_payload_bytes"], g["gsp_payload_symbols"]
    k4_row.update(
        gsp_payload_ms=g["k4_gsp_payload_ms"],
        gsp_payload_graph_ms=g["k4_gsp_payload_graph_ms"],
        gsp_payload_bound_ms=bound(g_bytes + 8 * g_syms + 36,
                                   4 * 8 * g_bytes)[0],
        gsp_payload_serial_walk_ms=g["k4_gsp_serial_walk_ms"],
        gsp_payload_symbols=g_syms, gsp_sync=g["k4_gsp_sync"],
        gsp_launches=launches4["huffdec"])

    # K5/K6 against their plain versions on the grid the TAC path gives
    # them: the GSP-padded coarse level, at the path's tile = shape
    padded, _ = gsp.gsp_pad(coarse.data, coarse.mask,
                            unit=max(2, 8 // coarse.ratio), device=dev)
    gshape = tuple(padded.shape)
    for tile in (gshape, (8, 128, 128)):
        codes = ops.lorenzo3d_codes(padded, eb4, tile)
        check(torch.equal(codes, ref.lorenzo3d_codes(padded, eb4, tile)),
              f"K5 != plain on the TAC path's grid at tile {tile}")
        recon = ops.lorenzo3d_recon(codes, eb4, tile)
        check(torch.equal(recon, ref.lorenzo3d_recon(codes, eb4, tile)),
              f"K6 != plain on the TAC path's grid at tile {tile}")
    n_el = padded.numel()
    tac_grid = {"card": smi, "shape": gshape, "values": n_el,
                "zero_share": float((padded == 0).sum()) / n_el,
                "routes": [ops.codes3d_route(gshape, gshape),
                           ops.recon3d_route(gshape, gshape)]}
    check(tac_grid["routes"] == ["walk", "planes"],
          f"K5/K6 routes on the TAC path's grid: {tac_grid['routes']}")
    codes = ops.lorenzo3d_codes(padded, eb4, gshape)
    tac_grid["bound_ms"] = bound(12 * n_el, 12 * n_el)[0]
    tac_grid["k5_ms"] = cuda_ms(
        lambda: ops.lorenzo3d_codes(padded, eb4, gshape), 200, torch)
    tac_grid["k5_plain_ms"] = cuda_ms(
        lambda: ref.lorenzo3d_codes(padded, eb4, gshape), 20, torch)
    tac_grid["k6_ms"] = cuda_ms(
        lambda: ops.lorenzo3d_recon(codes, eb4, gshape), 200, torch)
    tac_grid["k6_plain_ms"] = cuda_ms(
        lambda: ref.lorenzo3d_recon(codes, eb4, gshape), 20, torch)
    tac_grid["k5_graph_ms"] = graph_ms(
        lambda: ops.lorenzo3d_codes(padded, eb4, gshape), 100, torch)
    tac_grid["k6_graph_ms"] = graph_ms(
        lambda: ops.lorenzo3d_recon(codes, eb4, gshape), 100, torch)
    print("K5/K6 == plain on the TAC path's GSP grid at both tiles: "
          + json.dumps(tac_grid))
    # the designs in turns from CUDA graphs: a 128³ launch is about as
    # short as the host's cost per call
    grid_turns = k56_turns(torch, ops, ref, build, padded, codes, eb4,
                           lambda call: graph_ms(call, 100, torch), smi)
    print("K5/K6 designs on the TAC path's GSP grid (graph ms, in turns): "
          + json.dumps(grid_turns))
    del padded, codes, recon

    # ------------------------------------------------- 5. K5/K6 vs plain
    padded, _ = gsp.gsp_pad(fine.data, fine.mask, unit=8, device=dev)
    n_el = padded.numel()
    print(f"K5/K6 input: GSP-padded finest level of phase 2, "
          f"{tuple(padded.shape)}, {n_el} values, zero share "
          f"{float((padded == 0).sum()) / n_el}, routes "
          f"{ops.codes3d_route(SHAPE, SHAPE)}, "
          f"{ops.recon3d_route(SHAPE, SHAPE)}")
    check([ops.codes3d_route(SHAPE, SHAPE), ops.recon3d_route(SHAPE, SHAPE)]
          == ["walk", "planes"], f"K5/K6 routes at {SHAPE}")
    for tile in (SHAPE, (8, 128, 128)):
        codes = ops.lorenzo3d_codes(padded, eb, tile)
        check(torch.equal(codes, ref.lorenzo3d_codes(padded, eb, tile)),
              f"K5 != plain at tile {tile}")
        recon = ops.lorenzo3d_recon(codes, eb, tile)
        check(torch.equal(recon, ref.lorenzo3d_recon(codes, eb, tile)),
              f"K6 != plain at tile {tile}")
        print(f"K5/K6 == plain at tile {tile}")
        del codes, recon
    codes = ops.lorenzo3d_codes(padded, eb, SHAPE)
    big_turns = k56_turns(torch, ops, ref, build, padded, codes, eb,
                          lambda call: cuda_ms(call, 10, torch), smi)
    print(f"K5/K6 designs at {SHAPE} (event ms, in turns): "
          + json.dumps(big_turns))
    for name, new, old, fn, ops_count in (
            ("lorenzo3d_codes", "walk", "elementwise",
             lambda: ops.lorenzo3d_codes(padded, eb, SHAPE), 12 * n_el),
            ("lorenzo3d_recon", "planes", "three_pass",
             lambda: ops.lorenzo3d_recon(codes, eb, SHAPE), 5 * n_el)):
        key = "k5" if name == "lorenzo3d_codes" else "k6"
        plain = (lambda: ref.lorenzo3d_codes(padded, eb, SHAPE)) \
            if key == "k5" else (lambda: ref.lorenzo3d_recon(codes, eb, SHAPE))
        rows.append(kernel_row(
            name, 0, cuda_ms(fn, 20, torch), cuda_ms(plain, 3, torch),
            12 * n_el, ops_count, None, launches4[name], smi,
            design=big_turns["routes"][key == "k6"],
            ms_turns=big_turns[f"{key}_ms"][new],
            earlier_design_ms_turns=big_turns[f"{key}_ms"][old],
            grid_128_graph_ms=grid_turns[f"{key}_ms"][new],
            grid_128_earlier_design_graph_ms=grid_turns[f"{key}_ms"][old],
            grid_128_bound_ms=grid_turns["bound_ms"]))
    del padded, codes

    # ------------------------------------- 6. the card against the reference
    print("card vs the reference's files: " + json.dumps(
        card_reference(torch, np, ops, tio, smi)))

    # ------------------------------------------------- 7. LM serving
    rows += lm_serving(torch, smi)

    # ------------------------------------------------- 8. MoE serving
    t0 = time.perf_counter()
    moe = moe_serving(torch, smi)
    print(f"MoE serving: {time.perf_counter() - t0:.1f} s, launches "
          + json.dumps(moe["launches"]))

    # ------------------------------------------ 9. recurrent-state serving
    t0 = time.perf_counter()
    rec = recurrent_serving(torch, smi)
    print(f"recurrent serving: {time.perf_counter() - t0:.1f} s, launches "
          + json.dumps(rec["launches"]))

    # ------------------------------------- 10. embedding-input serving
    t0 = time.perf_counter()
    emb = embedding_serving(torch, smi)
    print(f"embedding serving: {time.perf_counter() - t0:.1f} s, launches "
          + json.dumps(emb["launches"]))

    # ------------------------------------------------- 11. training
    t0 = time.perf_counter()
    trn = training(torch, smi)
    print(f"training: {time.perf_counter() - t0:.1f} s, launches "
          + json.dumps(trn["launches"]))

    # ------------------------------------------------- 12. resilient loop
    t0 = time.perf_counter()
    loop = resilient_loop(torch, smi)
    print(f"resilient loop: {time.perf_counter() - t0:.1f} s, launches "
          + json.dumps(loop["launches"]))

    # ------------------------------------------------------- 13. the mesh
    t0 = time.perf_counter()
    mesh = mesh_training(torch, smi)
    print(f"mesh: {time.perf_counter() - t0:.1f} s, launches "
          + json.dumps(mesh["launches"]))

    # launches on the region-serving phase (2b) and the multi-part phase
    # (2c) beside each row's own path
    for r in rows:
        if r["name"] in ("lorenzo3d_recon_batched", "huffdec"):
            r["region_launches"] = region["launches"][r["name"]]
        elif r["name"] == "lorenzo3d_recon":
            r["region_launches"] = region["gsp_launches"][r["name"]]
        r["multipart_launches"] = mpart["launches_total"][r["name"]]
        r["multipart_worker_launches"] = \
            mpart["process_worker_launches_total"][r["name"]]
        # phase 2d: the tune, the variant writes and the cold HTTP batch
        r["tuning_launches"] = {
            "tune": tuning["tune_launches"][r["name"]],
            "write": tuning["write_launches"][r["name"]],
            "http_cold": tuning["serving"]["http_cold_launches"][r["name"]]}
        # phase 2e: the fleet's cold batch and the one-shard-down fallback
        r["sharded_launches"] = {
            run: counts[r["name"]]
            for run, counts in shard["sharded_launches"].items()}
        # phase 8: each int8 generate and granite's cache read-back
        r["moe_launches"] = {run: counts[r["name"]]
                             for run, counts in moe["launches"].items()}
        # phase 9: each generate and zamba2's cache read-back
        r["recurrent_launches"] = {
            run: counts[r["name"]] for run, counts in rec["launches"].items()}
        # phase 10: each serving run and each read-back; phase 11: the
        # plain steps and one two-replica step
        r["embedding_launches"] = {
            run: counts[r["name"]] for run, counts in emb["launches"].items()}
        r["train_launches"] = {
            run: counts.get(r["name"], 0)
            for run, counts in trn["launches"].items()}
        # phase 12: the loop's runs, the measured saves and restores, and
        # the expert leaf's encode and decode
        r["loop_launches"] = {
            run: counts[r["name"]] for run, counts in loop["launches"].items()}
        # phase 12's shapes: the largest rank-3 leaf (K5/K6), the expert
        # stack (K1/K2)
        at = {"lorenzo3d_codes": ("k56_at_leaf", "k5"),
              "lorenzo3d_recon": ("k56_at_leaf", "k6"),
              "lorenzo3d_codes_batched": ("expert", "k1"),
              "lorenzo3d_recon_batched": ("expert", "k2")}.get(r["name"])
        if at:
            st = loop[at[0]]
            r["loop_shape"] = {"shape": st["shape"], "ms": st[f"{at[1]}_ms"],
                               "plain_ms": st[f"{at[1]}_plain_ms"],
                               "bound_ms": st["bound_ms"],
                               "routes": st["routes"]}
        if r["name"] in QDQ:
            # phase 13: each rank's steps and run (a)'s
            r["mesh_launches"] = {
                run: counts[r["name"]]
                for run, counts in mesh["launches"].items()}
            r["mesh_launches"].update({
                f"one_process_step{i}": counts[r["name"]]
                for i, counts in enumerate(mesh["a_launches"])})
            key = "k7" if r["name"] == "group_quant" else "k8"
            ms, plain_ms, b_ms = trn["pods"]["k7_k8_ms_at_group_256"][key]
            r["group_256"] = {
                "shape": trn["pods"]["k7_k8_ms_at_group_256"]["shape"],
                "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                "exact": trn["pods"]["k7_k8_exact_at_group_256"]}
        # phase 13's plain step: (d)'s ranks and (a′)
        r.setdefault("mesh_launches", {}).update({
            run: counts[r["name"]]
            for run, counts in mesh["dp_launches"].items()})
    print(f"total wall: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
