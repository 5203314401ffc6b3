#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card and
check it end to end.

    python3 chip_smoke.py        # from the repository root; one CUDA card

Phases, in order; any failure exits non-zero and nothing is swallowed:

1. print the card (``torch.cuda.get_device_name`` and ``nvidia-smi``'s
   name and power limit);
2. build every CUDA kernel of the path from ``src/repro_torch/csrc`` (one
   ``nvcc`` per source, started together) and print the build seconds;
   B2's SASS (``cuobjdump``) must hold TF32 ``HMMA`` instructions;
3. hold each kernel against its plain PyTorch version on the card, on
   inputs the main path builds, TF32 off: the Gathering Unit (B1) with
   float32 and bfloat16 tables, both MVoxel layouts, 1 and 4 segments, at
   arm B's shape and at the reference's four shapes (C = 4, 8, 12, 16,
   caps 64-512: the run-time-C code, CTAs under 256 threads and a block
   read in place), bit for bit in every case; the
   fused MLP (B2, 3xTF32 on the tensor cores) at arm B's C=8, H=64 for S =
   131,072 (a reference chunk) and 4,096 (one pooled-fill chunk), and at
   the reference's shapes (1000, 8, 64), (555, 16, 32), (64, 4, 128) with
   weights at its initializer's scales; the fused tick's dual gather (B3)
   on the RIT blocks a fused tick builds (captured from a real tick),
   float32 and bfloat16, both layouts, 1 and 4 segments, and at arm D's
   shape, at the reference's shapes (grid 16, edge 8, C = 4, caps
   128 / 256 and 32 / 64) and at blocks read in place (the edge-16, C = 12
   block and [729, 80], float32; their bfloat16 copies staged), bit for
   bit against its plain version and against two B1 launches on the same
   blocks; the mixed-scene kernels B4 (Gathering
   Unit per segment's page) and B5 (dual gather per segment's page) on the
   blocks the first tick of arm E's mixed-scene serving run builds
   (captured from its admission priming and its fused sweep), float32 and
   bfloat16, both layouts, also bit for bit against B1 (B4) and B3 (B5) run
   on each segment's page; B4 and B5 also under maps that work their
   prefetched second buffer, on arm E's captured rows, float32 and
   bfloat16: all page 0, [0, 1] x 4 (num_seg 8), -1 and K between valid
   pages (NaN on exactly those rows, the others bit-equal to B1 / B3) and
   one segment; B4 and B5 also where the kernels before fault C4's repair
   raised: arm E's captured map and rows on pages rebuilt at C = 40
   (float32, read in place) and C = 36 (bfloat16, staged), and three
   pages of the edge-16, C = 12 block (read in place in both dtypes),
   each under its captured map and one with -1, bit for bit against the
   plain versions and against B1 / B3 on each valid page, NaN exactly on
   the invalid segment's rows; flash attention (B6), whose four kernels are the
   bfloat16 tensor-core prefill, the float32 tile prefill and the split-KV
   decode with its log-sum-exp combine: at arm F's first prefill
   ([1, 40, 2048, 128] against [1, 8, 2048, 128], causal, bfloat16 and
   float32) and first decode tick ([4, 40, 1, 128] against the
   [4, 8, 2084, 128] cache, kv_len 2049, bfloat16 and float32), the decode
   also at kv_len 1, 63, 64, 65, one split length -1 and +1, and 2084 (the
   whole cache, a prompt of max_len tokens), its two kernels also one by
   one against their plain versions (the partials within atol / rtol
   1e-4: float32 sums of up to a split's length in another order), a
   ragged prefill (S = 1000) through ``ops.mha``, a top-left causal
   sq = 64, sk = 128 case, and the decode shape with Sq = 2, which runs it
   through the prefill kernel instead; B6's window and softcap (the
   reference LM's local attention and ``logit_softcap``), both prefill
   kernels in bfloat16 and float32: causal prefills under a window at arm
   M2's shape ([1, 40, 10240, 128] against [1, 8, 10240, 128], window
   8,192, the plain version computed 1,024 query rows at a time) and at
   S = 65, 129 and 1,089 under a window of 64 (window + 1, + a 64-row
   query block + 1, + the reference's q_block + 1), and softcap 30 at arm
   F's prefill and decode shapes with q scaled by 8 (the decode's split
   kernel also alone against its plain partials); and (phase C5) B2 at
   S = 131,072 on
   the widths fault C5 made raise, [C, H] = [8, 48] and [8, 96] (padded to
   the 64- and 128-wide templates) and [8, 160] and [96, 128] (the
   run-time-H mode), biases drawn non-zero; and (arm I's shapes, on one
   real reference chunk of 2048 rays x 192 samples and each model's own
   random weights) B1 at ``cicero-dvgo``'s block [8000, 729, 12] with
   that chunk's ids [8000, 512, 8], bit for bit, and B2 at S = 131,072
   with [C, H] = [12, 64] (DVGO), [16, 64] (NGP) and [27, 64] (TensoRF,
   the first C that is not a multiple of 8). Tolerances are the reference's
   kernel tolerances: atol 2e-5 / rtol 1e-5 (float32; attention 2e-5 /
   1e-4), 3e-2 (bfloat16; attention atol 8e-3 / rtol 1e-2, a few bfloat16
   steps at the outputs' scale);
4. run the render arms A-E end to end through ``repro_torch.api`` (arm F,
   LM serving, below) with every launch
   count set to 0 just before and read just after; each arm is held
   against the same port run on the CPU (which runs the plain versions;
   those of arms A, B, B48, C, D, D adaptive's first window, E and G run
   in a worker process started before the arms, beside the card's work):
   every frame >= 40 dB PSNR, equal reference renders and frame counts,
   and every kernel of the arm launched.
   Arm A: ``RenderConfig(backend="streaming")`` at its defaults (res 64,
   window 16, grid 48, 4 channels, 32 samples, baked "lego"), 32 frames;
   sparse pixels within 1%.
   Arm B: ``make_model("dvgo", backend="streaming", decoder="mlp")`` at
   ``NerfConfig``'s defaults (grid 64, 8 channels, hidden 64, 64 samples)
   with random parameters from numpy seed 0, 16 frames at res 64; sparse
   pixels within 1%. Arm B48 (phase C5): arm B's model at
   ``mlp_hidden=48``, 8 frames; equal stats, B2 on its padded template.
   Arm C: arm A's config with ``fused_tick=True``, 32 frames; sparse
   pixels within 1%, and B3 launched once per fused tick.
   Arm D: arm B's model served (``Renderer.serve``) with
   ``fused_tick=True`` and 4 slots: 6 sessions of 32 frames (window 16),
   orbits 25 degrees apart in phase, so queueing and slot reuse happen;
   equal tick counts, B1, B2 and B3 launched, B3 once per tick. The same
   fleet is then served on the staged tick on the card, and its frames
   must agree with the fused run's at >= 40 dB.
   Arm E: multi-scene serving, ``RenderServeEngine(model, params,
   config=RenderConfig(backend="streaming", fused_tick=True,
   num_slots=4), scene_loader=...)`` at arm A's widths, the loader baking
   each named scene: 12 sessions x 32 frames over 6 of the 8 scene names
   on 4 pages, orbits 30 degrees apart. The run must show a cache hit, an
   eviction and the repaging of an evicted scene, mix at least 2 scenes
   in every tick, launch B5 once per tick and B4 (admission priming) and
   never B1 or B3; it is held against the port's CPU run of the fleet
   (frames >= 40 dB, equal ticks, per-session stats and scene-cache
   counters), two of its sessions against their scenes served alone on
   the card (>= 60 dB, equal hole fractions), and a shorter fleet (the
   first 4 sessions, 16 frames) is served staged and fused on the card
   (>= 40 dB, equal ticks; the staged run launches B4 in its pooled fill),
   and again at ``RenderConfig(channels=40)``, where B4 and B5 read every
   block in place: >= 60 dB from the 4-channel runs, equal ticks,
   per-session stats and scene-cache counters (byte counters 10x).
   Arm D adaptive: arm D's fleet served staged with
   ``adaptive_sampling=True`` (one run): the staged fleet's ticks; each
   session rendered alone on the card within 40 dB of its served frames,
   with equal stats and, in sum, equal fine holes; the first session's
   first window alone on the card and on the CPU (the staged fill at 4
   slots costs minutes of host CPU): >= 40 dB, equal buckets, hole and
   fine counts and stats. Recorded, not gated: each frame's PSNR against
   the full render of its pose beside the non-adaptive staged fleet's
   (the reference gates that delta at 1.0 dB on baked scenes, arm G;
   these weights are random); samples per tick beside the non-adaptive
   fleet's, B2's call shapes.
   Arm G: arm A's config with ``adaptive_sampling=True``,
   ``coarse_factor=4``, 32 frames: >= 40 dB from the CPU run, equal
   ``fine_counts`` per window and ``RenderStats``, the same 1.0 dB gate
   against arm A's frames; samples per window against arm A's.
   Arm H (the paper's baselines) at arm A's config, 16 frames: the full
   NeRF render of every frame, the host loop (``engine="host"``), TEMP-16
   (``engine="host", mode="temporal"``) and DS-2 (``render_ds2``), each
   >= 40 dB from the CPU run (host loop and TEMP-16 with equal stats),
   with its mean PSNR against the full render and its warm wall.
   Arm I: the paper's three configs (``configs.cicero_nerf``) at their
   published widths on the streaming backend: ``cicero-dvgo`` (grid 160,
   12 channels), ``cicero-ngp`` (8 hash levels of 2^19 x 2, res 16-1024)
   and ``cicero-tensorf`` (grid 300, rank 48, 27 channels), hidden 64,
   192 samples, ``NerfModel.init`` weights from a ``torch.Generator``
   seeded 0; ``RenderConfig(res=64, window=16)``, 16 frames of the "lego"
   orbit, staged, each rendered cold, again and warm. ``cicero-ngp`` and
   ``cicero-tensorf`` are held against the port's CPU run of the same
   window, ``cicero-dvgo`` against the card's own ``backend="reference"``
   render of the same poses (the CPU cannot hold its plain B1): >= 40
   dB, equal ``RenderStats`` (hole counts); B2 launched by all three, B1
   by the dense grid only. Its oracle sub-arm is the fig. 26 setup
   (``CiceroRenderer(oracle, {}, ...)`` on "materials" with
   ``specular=0.6``, res 48, window 4, 8 frames 4 degrees apart,
   ``phi_deg=4``), card against CPU.
   Phase T (NeRF training, ``nerf/train.py``): for each of arm I's three
   configs at full width on the reference backend, the first 3 steps of
   ``fit_field`` on host-drawn batches of 8,192 points, on the card and,
   from the same params each step, on the CPU (loss, every grad leaf, and
   AdamW on the card's grads run on the CPU, allclose at the ``T_*``
   tolerances); then ``fit_field`` at its defaults (400 steps x 8,192
   points drawn on the card): wall, steps/s, peak allocated memory and
   the held-out field loss on 8,192 numpy points before and after (finite
   and falling); then ``train_images`` for ``cicero-ngp`` against the
   oracle's "lego" frames at res 64 over 8 orbit poses (300 steps x 4,096
   rays; the loss must fall); and ``fit_field`` must raise ``ValueError``
   for a streaming ``dvgo`` model (B1 has no gradient, as the reference's
   Pallas kernels have none). Arm I fitted: arm I's streaming model
   objects render the fitted params exactly as arm I does (16 frames, res
   64, cold, again, warm; B1 and B2 on ``cicero-dvgo``'s path), >= 60 dB
   and equal stats against a fresh model object on the same params (no
   cache serves the random weights), each frame's PSNR against the
   oracle's full render of its pose beside arm I's random-weight frames';
   each config's mean must beat the random weights'.
   Where the card and CPU runs part (``c2_tables``): each of the six
   tables the loader bakes, on the card against its CPU bake, and the
   fleet served on the card from the CPU's bakes against the CPU run.
   A further, profiled run of each arm (``torch.profiler``) reports the
   device's busy share of the wall time, the host's ``cudaLaunchKernel``
   and ``cudaGraphLaunch`` calls, the run's peak of allocated device
   memory and the busiest kernels and ops (for arms D and E also the ops
   with the most device time by input shape). Each path's launches of
   B1-B5 must equal the eager ticks' (``EAGER_LAUNCHES``): a kernel
   launched inside a CUDA graph counts at each replay.
   Phase S, the steady tick: each staged window and fused tick is a tick
   program replayed as a CUDA graph from its second call on
   (``core.engine.TickProgram``). At arms A, B, C, G and D's keys (D
   fused, staged and adaptive, on the serving engine before it serves),
   three calls on the same device inputs (eager, capture and replay,
   replay inside ``torch.cuda.set_sync_debug_mode("error")``) must give
   bit-equal outputs, next references and resolved frames, with one key
   and one capture. Arm D's fleet served fused, staged and staged
   adaptive, arm E's fleet fused and its short fleet staged: one or two
   runs capture every key (captures = keys), then a further run whose
   every tick that admits nothing runs under the sync error mode, with
   no new key and no capture (arm E: across its scene churn); then one
   of arm E's paged keys is replayed (under the sync error mode) against
   the same call with the engine's graphs off; then arm I's
   ``cicero-ngp`` and ``cicero-tensorf`` keys (captures = keys after the
   arm's warm renders) likewise. The spies of
   the kernel checks and of C2 turn their engine's graphs off: they must
   see, or read back, every call.
   Phase P, session sharding and ``parallel/`` over ranks
   (:func:`run_phase_p`). P1, in this process, a one-rank NCCL group
   through a ``FileStore``: ``launch.mesh.make_smoke_mesh`` on the card;
   ``sharded_decode_attention`` at arm F's first decode tick (q
   [4, 40, 1, 128] against the [4, 8, 2084, 128] cache, index 2,048,
   bfloat16) within B6's bfloat16 tolerance of B6's decode and of the
   plain version; ``compress_with_feedback`` + ``compressed_psum``, int8
   and bfloat16, on a float32 tree with a [4096, 4096] leaf, bit for bit
   ``dequantize(quantize(g + ef))`` over two error-feedback steps;
   ``pipelined_forward`` over one stage bit-equal to ``reference_forward``
   (M = 1; M = 4 within 1e-5); fault C7's card check
   (:func:`p1_sharded_serving`): arm A's config served staged on 2
   slots, 2 sessions x 48 frames, by a serving engine whose session mesh
   is the one rank (so its windows take the sharded path, NCCL's
   all-gathers included) and by an unsharded one, each until its keys
   are captured and then once more with every tick that admits nothing
   under ``torch.cuda.set_sync_debug_mode("error")``: 0 synchronizing
   calls, no new key or capture, frames and statistics bit-equal to the
   unsharded run's; the group destroyed. P2, two gloo ranks
   started with ``spawn`` on this card (CUDA is initialized, so no fork;
   NCCL refuses two ranks on one device), in one start-up: (1) arm A's
   config, 2 sessions x 32 frames through ``render_windows`` with
   ``num_slots=2``, ``ShardConfig(num_devices=2)``; (2) arm B's model
   served staged on 4 slots, 4 sessions x 32 frames; both bit for bit
   the script's unsharded card runs of the same windows and fleet (every
   field, frames, hole counts, overflow flags, serving statistics), with
   ``"devices"`` 2 and each rank launching B1 (and B2 in (2)), its counts
   joining the kernels line; (3) ``sharded_decode_attention`` with the
   cache split 1,042 rows per rank against B6's decode on the whole
   cache; (4) ``pipelined_forward`` over 2 stages, M = 2 and 4, within
   1e-5 of ``reference_forward``, each stage holding a copy of its own
   half of the stacked layers (its bytes printed); (5)
   ``compressed_psum`` bit for bit the
   mean of the two ranks' dequantized payloads. The warm walls of (1) and
   (2) are recorded beside the unsharded ones, not gated; a rank's
   failure or a rank past its deadline fails the phase.
   Arm F: LM serving, ``repro_torch.serve.ServeEngine`` on qwen2.5-32b at
   full width (d_model 5120, 40 query and 8 KV heads, d_ff 27648, vocab
   152064, QKV bias), 8 of its 64 layers, bfloat16, random weights from
   ``torch.Generator`` seed 0 at the reference's scales, QKV biases drawn
   non-zero; 8 requests (prompts of 2048, 1536, 1024, 512, 1792, 768,
   1280 and 256 tokens, 32 new tokens each) on 4 slots, max_len 2084,
   served cold, then warm, then profiled (its first wave, 4 requests).
   B6's tensor-core prefill must launch 8 x 8 times and its decode
   kernels 8 x (decode ticks) times each, and nothing else. F2
   (``f2_check``): each request's prefill is rerun with B6 while every
   layer's B6 output is held against the plain version on the same q/k/v
   (atol 8e-3 / rtol 1e-2),
   and its logits must come no further from the same prefill with float64
   attention (``attention_reference``) than 1.5x the plain version's max
   and 1.25x its RMS distance (the plain version already sits about 0.05
   max abs from it at 16 bfloat16 layers, so a fixed 3e-2 bound against the
   plain version is recorded, not required). F2 is then run with three
   planted faults in B6's place (a key-tile loop one tile short, a strict
   causal test, query head h reading KV head h % KVH) and must fail for
   each on every request; two lower-precision attentions (scores, or P
   and V, in bfloat16) are recorded.
   F1: the same engine at the same width with 2 layers in float32 serves
   prompts of 64, 48, 40 and 32 tokens on 2 slots (slots reused at
   unequal positions, so the shared decode index matters) on the card and
   on the CPU: equal token streams and stats, prefill logits within
   1e-3; it runs B6's float32 kernels (tile prefill, split-KV decode);
   Arms M1, M and M2 (the MoE family and local attention through the LM
   ``ServeEngine``; random weights from ``torch.Generator`` seeds, each
   arm's weights freed before the next). M1: moonshot-v1-16b-a3b and
   llama4-maverick at their REDUCED widths (float32, head_dim 128,
   llama4's window 8) serve prompts of 24, 13, 9 and 5 tokens on 2 slots
   (8 new tokens: decoding runs past the window) on the card and on the
   CPU: equal token streams and stats, prefill logits within 1e-3; B6's
   float32 kernels only. M: moonshot at full width (d 2,048, 16 heads,
   MHA, 64 experts top-6 and the shared expert, ``moe_d_ff`` 1,408,
   vocab 163,840, bfloat16), 8 of its 48 layers, served as arm F serves
   (its 8 requests on 4 slots, max_len 2,084): cold, F2's check, warm,
   then profiled on the first 4 requests with 8 new tokens each. M2:
   llama4-maverick at full
   widths (d 5,120, 40 heads, kv 8, d_ff 16,384, ``moe_d_ff`` 8,192,
   vocab 202,048, window 8,192, bfloat16), one period of 4 layers (three
   local, one global; MoE in layers 2 and 4), 64 of its 128 experts;
   prompts of 10,240, 8,200, 1,024 and 512 tokens on 2 slots, 16 new
   tokens each (max_len 10,260): cold, F2's check, warm, profiled. In M
   and M2 B6's tensor-core prefill launches once per layer and request and
   its decode kernels once per layer and tick, and nothing else; F2's
   check runs with every router call's expert ids pinned to the checked
   run's (``routing``: routing is a discrete decision that bfloat16 noise
   flips), its logit limits 2x the plain version's distance
   (``M_F2_LIMITS``), and M2's three local layers must pass B6 their
   window; M2 also runs two of F2's controls at those limits
   (``M2_F2_CONTROLS``: the planted ``diag_tile_dropped``'s logits must
   break them on every request, the bfloat16 P.V is recorded);
   Arms R1, R and R2 (the recurrent mixers through the LM
   ``ServeEngine``: jamba's Mamba layers with MoE and its one attention
   layer a period, xlstm's mLSTM and sLSTM; random weights from
   ``torch.Generator`` seeds, each arm's weights freed before the next).
   R1: jamba-1.5-large and xlstm-350m at their REDUCED widths (float32;
   jamba's head_dim is the config's 128) serve prompts of 512, 300, 128
   and 40 tokens on 2 slots (over one 256 / 128-row chunk and not
   multiples of it) on the card and on the CPU: equal token streams and
   stats, prefill logits within 1e-3, B6's float32 kernels in jamba's
   attention layer only; then one train step of each on 2 x 512 tokens,
   card against CPU at phase L1's tolerances (an mLSTM's gate leaves
   ``wi``, ``wf``, ``bi``, ``bf`` at their own atol,
   ``R1_GATE_ATOL_OF_MAX``; an sLSTM's ``bi``, whose gradient is 0 in
   exact arithmetic, must be rounding noise on both), every grad leaf of
   both also read against the same step run in float64 on the CPU.
   R: jamba-1.5-large at full widths (d 8,192, 64 heads, kv 8, d_ff and
   ``moe_d_ff`` 24,576, vocab 65,536, ``mamba_d_state`` 16, 64 SSM heads
   of 256, bfloat16), one period (8 of 72 layers: 1 attention, 7 Mamba,
   4 MoE) and 8 of its 16 experts (top-2), serving arm F's fleet with
   its 1,280-token prompt replaced by 1,000 (one whole-prompt chunk):
   cold, F2's check on its attention layer with M2's two controls at
   the same limits, warm, profiled on the first 4 requests with 8 new
   tokens each. R2: xlstm-350m at full width and depth (24 layers, d
   1,024, tied embeddings, bfloat16), prompts of 256, 512, 2,048 and
   1,000 tokens on 4 slots, 32 new tokens: cold, warm, profiled on the
   first (the sLSTM prefill is a step loop). B6's prefill launches once per attention layer and request in
   R, its decode kernels once per attention layer and tick; R2 launches
   no kernel. Then, at full width, one layer of each kind (R's first
   Mamba layer, R2's first mLSTM and its sLSTM) in float32 on the first
   256 positions of its own input in a prefill: the card's output and
   final state within 1e-4 x their largest magnitude of the CPU's, and
   on the card the chunked Mamba (256 and 64-row chunks) and mLSTM
   against their step recurrences to the same bound;
   Arms W1, W, V1 and V (the encoder-decoder and the VLM through
   ``lm.make_prefill_step`` / ``make_decode_step``, the reference's entry
   points for these families; stub frontends from the synthetic
   pipeline's ``make_batch``; random weights from ``torch.Generator``
   seeds). W1: whisper-small's REDUCED (float32, head_dim 64) on 2 rows
   of 16 stub frames, prompt 24, 8 greedy tokens, on the card and on the
   CPU: equal streams, prefill logits within 1e-3, B6's float32 kernels
   (the encoder's, the decoder's self- and cross-attention); one train
   step at L1's rule. W1 bf16: the same config in bfloat16 over
   whisper-small's 1,500 frames, the frames in float32 as the Trainer's
   batches carry them (the encoder, the cross K/V and B6's encoder and
   cross calls then run in float32), on the card, then on the CPU fed
   the card's tokens: every step's logits within 6e-2 / 2e-2, the card's
   token within 6e-2 of the CPU's best logit, the cross K/V float32 on
   both, B6's fp32 tile prefill for the encoder's and cross calls and
   its tensor-core prefill for the self-attention. W: whisper-small at full width and depth (12 encoder
   and 12 decoder layers, d 768, 12 heads of 64, vocab 51,865, bfloat16),
   4 utterances of 1,500 stub frames (30 s of audio, in bfloat16 as the
   reference's dry-run specs them), prompts of 192 tokens, 32 greedy
   tokens, cache_len 448: each prefill launches B6's tensor-core prefill
   36 times (12 encoder, non-causal at 1,500 x 1,500; 12 causal self; 12
   cross, 192 rows against 1,500 keys), each tick its decode kernels 24
   times each (12 self, 12 cross over the 1,500-key cross cache); F2 on
   every B6 call of the prefill at arm F's limits (1.5x / 1.25x), per
   batch row, and the planted ``tail_tile_dropped`` (the key-tile loop
   one tile short: the ragged tail of the 1,500 keys) must break them on
   every row; the same batch with its frames in float32 (cold with its
   launches counted as W1 bf16's, the cross K/V float32, warm, and F2
   with each float32 call within 2e-5 / 1e-4 of the plain version);
   encoder, prefill and decode times, profiled over the prefill and 4
   ticks. V1: internvl2-1b at full widths, 2 of 24 layers,
   float32 (REDUCED's head_dim 14 is not one B6 takes): a prefill of 256
   stub patch embeddings + 64 tokens and 8 greedy tokens, card against
   CPU, as W1; F1's fleet through the ``ServeEngine``, text-only; one
   train step with the image stubs at L1's rule. V: internvl2-1b at full
   width and depth (24 layers, d 896, 14 heads over 2 KV heads (GQA
   group 7), d_ff 4,864, vocab 151,655 tied, bfloat16): 4 requests of 256
   stub patch embeddings + 256 tokens, 32 greedy tokens, F2 at arm F's
   limits, as W, with the planted ``diag_tile_dropped`` as its control;
   then arm F's fleet served text-only through the
   ``ServeEngine`` (cold, F2 with M2's two controls at the serving arms'
   2x limits, as arm R, warm, profiled on its first wave with 4 new
   tokens). B6's three new calls are also checked and
   timed alone (the encoder call, the cross prefill, the cross decode),
   and a GQA group of 7 is checked in both dtypes;
   Phase L (LM training, ``models/lm.make_train_step`` and
   ``train/trainer.Trainer``; no kernel: the reference trains through
   plain einsums, so every launch count must stay 0; TF32 off). L1: the
   ~100M config of the reference's ``examples/train_lm.py`` (minitron-4b's
   layout at 8 layers, d 768, 12 heads, kv 4, d_ff 3,072, vocab 16,384,
   float32) on the synthetic pipeline's batches of 8 x 128: the first 3
   train steps from the same params on the card and on the CPU, the loss
   at rtol 1e-5, each grad leaf at rtol 1e-3 + atol 1e-4 x its largest
   CPU value, and the in-place AdamW on the card's grads against
   ``adamw_update`` on the CPU at 1e-5 / 1e-7. L2: minitron-4b at its
   published widths (d 3,072, 24 heads, kv 8, d_ff 9,216, vocab 256,000,
   bfloat16, ``remat``, ``q_block`` 1,024, ``loss_chunk`` 4,096), 8 of
   its 32 layers, random weights (seed 0), batch 1 x 4,096: 10 steps at
   the Trainer's defaults (clip 1.0) with the loss, steps/s, tokens/s
   and peak allocated bytes of each; finite losses and params, and every
   grad leaf bfloat16 and finite. L3: the Trainer at L1's config, 60
   steps, a checkpoint every 20, one fault injected at step 30, in a
   temporary directory: exactly one restart, from step 20, whose error is
   the injected one; the last 5 steps' mean loss below the first 5's; one
   save and load of the final state timed (and exact); then 40 straight
   steps against 20 + a fresh Trainer resuming for 20: no restart, final
   losses within rtol 1e-3; L3's last checkpoint is kept for phase Q.
   Phase Q (the spec trees onto DTensor placements; no kernel, every
   launch count 0). Q1, in a subprocess started after phase L1: under
   torch's fake process group, the (16, 16) and (2, 16, 16) production
   meshes of 256 and 512 ranks, each of the ten registry archs at its
   published widths and depth laid out from meta shapes (no memory)
   under its ``default_strategy`` and the strict guard: its strategy,
   params bytes, and one rank's bytes and largest leaf block; then
   ``Trainer(L2's config, mesh=make_smoke_mesh())`` on a fake world of
   2, whose ``_pshard`` must name every param leaf and ``_oshard`` each
   moment as its param. Q2, two gloo ranks on the card started after
   phase L1: ``checkpoint.load(shardings=...)`` re-lays L3's checkpoint
   (L1's config, 1.28 GB) on the (2, 1) smoke mesh under minitron's
   strategy (``fsdp``): every rank's block bit-equal to its slice of the
   one-device load, the whole (gathered from host copies of the blocks:
   gloo cannot gather a CUDA DTensor) bit-equal to it, the placements
   the requested ones; then a mesh Trainer takes 3 steps of L1's config
   from seed 0 on both ranks: losses bit-equal between the ranks and
   within rtol 1e-5 of the one-device Trainer's on the card (L3's
   straight run, the same seed, schedule and batches), the checkpoint
   written once, by rank 0.
   Phase X (MoE's expert-parallel branch, the dry-run, the cost counter),
   after phase Q. X1, two gloo ranks on the card started after phase L
   on a (1, 2) (data, model) mesh under the mesh context, moonshot-v1-
   16b-a3b at its published widths, 2 layers drawn from a seed, each rank
   holding its 32 experts (a DTensor block, half of the expert bytes):
   (a) one MoE layer in float32, B 2 x S 256, both dispatch modes, the
   branch's body run once a mode, within ``F32_TOL`` of this process's
   one-device dispatch; (b) the bf16 prefill of 2 x 512 tokens, the
   branch taken on both layers and B6's prefill launched on each rank,
   its logits no further from the float64-attention prefill (every
   router call pinned to rank 0's expert ids) than F2's 1.5x max and
   1.25x RMS of the one-device prefill's; (c) one decode tick, through
   the fallback (each rank runs its experts, ``model`` gathers them),
   within 3e-2 of the one-device tick from rank 0's caches. X2, in a
   subprocess started with Q1: the dry-run (``launch.dryrun.run_cell``,
   a fake process group of 256 ranks, meta tensors) of moonshot x
   train_4k (the branch at tp 16), qwen2.5-32b x decode_32k (B6's decode
   through its operator's fake implementation) and cicero-dvgo x
   render_800 at full width and depth on the (16, 16) mesh of the card's
   device type: FLOPs counted, an LM cell's useful fraction in (0, 1],
   the train cell's params a rank equal to Q1's row for moonshot, and no
   device memory allocated. X3: the cost counter on arm A's first staged
   window of a fresh engine, its frames and holes bit-equal to another
   fresh engine's uncounted window; its FLOPs, bytes and bytes per frame
   printed (the counter sees the dispatcher's ops, not the ``ctypes``
   kernel launches, whose counts are recorded);
5. time each kernel and its plain version at the arms' shapes (B2 also
   at the four C5 shapes and arm I's three widths; B1 also on arm A's
   ``bank_interleaved`` table and arm I's ``cicero-dvgo`` block; B3 also
   at the two float32 blocks read in place; B4 also
   at the shape of arm E's staged per-scene fill, captured in a spied
   rerun of its staged fleet; B4 and B5 also on 40-channel pages, read
   in place; B2 also beside its 3xTF32 tensor-core
   bound) (device
   time from CUDA events, see ``time_ms``) beside the least time the card
   could take (B6 also beside ``scaled_dot_product_attention`` on the
   same tensors, the library yardstick; B6's windowed cases beside SDPA
   with a boolean band mask, its softcapped ones beside SDPA without the
   cap, which no PyTorch call applies), and print them as one JSON line,
   then the arms' wall times and each phase's seconds;
6. print ``{"ok": true, "device": {...}}`` as the last line.

Imports nothing of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import atexit
import contextlib
import dataclasses
import functools
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
SLEEP_CYCLES_PER_S = 2e9  # torch.cuda._sleep's cycles: ~1.98 GHz H100 SXM
FP32_FLOP_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores
F32_TOL = dict(atol=2e-5, rtol=1e-5)
BF16_TOL = dict(atol=3e-2, rtol=3e-2)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def time_ms(fn, repeats: int = 20, launches: int = 10,
            warmup: int = 3) -> float:
    """Device time of one ``fn()`` call, in ms: the median over
    ``repeats`` of CUDA-event time around ``launches`` back-to-back calls
    divided by ``launches``. A device-side sleep queued first lets the host
    enqueue every call before the first starts, so the host's launch cost
    is not counted: it lasts twice the host's time to enqueue ``launches``
    calls, measured once after the warm-up (at least 1 ms); inputs stay in
    L2 between calls, as they are when the path hands one stage's output to
    the next."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(launches):
        fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    sleep_cycles = int(max(2 * enqueue_s, 1e-3) * SLEEP_CYCLES_PER_S)
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def check_close(name: str, got, want, tol) -> float:
    import torch

    got, want = got.float(), want.float()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if not torch.allclose(got, want, **tol):
        fail(f"{name}: kernel disagrees with its plain version "
             f"(max abs err {err:.3g}, tolerance {tol})")
    print(f"check {name}: max abs err {err:.3g}")
    return err


def check_close_nan(name: str, got, want, tol) -> float:
    """``check_close`` where NaN is expected: the NaNs must sit at the
    same places, and the rest must agree."""
    import torch

    got, want = got.float(), want.float()
    if not torch.equal(torch.isnan(got), torch.isnan(want)):
        fail(f"{name}: NaN at other places than the plain version's")
    ok = ~torch.isnan(want)
    return check_close(name, got[ok], want[ok], tol)


def mlp_ref_inputs(n: int, c: int, h: int, device, seed: int = 0,
                   biases: bool = False) -> tuple:
    """B2's arguments at [S = n, C = c, H = h]: weights at the reference
    initializer's scales (N(0, 1) / sqrt(fan_in), zero biases, or N(0,
    0.1^2) ones with ``biases``) drawn from numpy ``seed`` as
    ``arm_b_params`` draws them, features N(0, 1) and the direction code
    of random unit directions."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                    device=device)
    normal = lambda rows, cols: f32(rng.standard_normal((rows, cols))
                                    / np.sqrt(rows))
    w = {"w1": normal(c, h), "b1": f32(np.zeros(h)), "w2": normal(h, h),
         "b2": f32(np.zeros(h)), "w_sigma": normal(h, 1),
         "w_rgb": normal(h + 9, 3), "b_rgb": f32(np.zeros(3))}
    if biases:
        for k, m in (("b1", h), ("b2", h), ("b_rgb", 3)):
            w[k] = f32(0.1 * rng.standard_normal(m))
    feats = f32(rng.standard_normal((n, c)))
    d = rng.standard_normal((n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    x, y, z = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    enc = f32(np.concatenate([d, x * y, y * z, x * z, x * x, y * y, z * z],
                             -1))
    return (feats, enc) + tuple(w.values())


# the reference's B2 shapes (tests/test_kernels.py::test_fused_mlp_shapes)
B2_REF_SHAPES = [(1000, 8, 64), (555, 16, 32), (64, 4, 128)]
# fault C5's [C, H]: padded to a template ([8, 48], [8, 96]) and the
# run-time-H mode ([8, 160], [96, 128]), at arm B's reference chunk
C5_SHAPES = [(8, 48), (8, 96), (8, 160), (96, 128)]
C5_ROWS = 131072
# the reference's Gathering Unit shapes (res, edge, cap, points, C):
# tests/test_kernels.py::test_gather_trilerp_shapes
B1_REF_SHAPES = [(32, 8, 128, 1500, 4), (48, 8, 256, 3000, 8),
                 (48, 16, 512, 2000, 12), (24, 8, 64, 500, 16)]
TF32_FLOP_PER_S = 495e12  # H100 SXM dense TF32 tensor cores


def profile_run(fn) -> dict:
    """Where one warm run's time goes: wall time under the profiler, the
    device's busy time (the sum of its kernels and copies — one stream,
    so they do not overlap), the host's kernel launches and CUDA-graph
    launches, the busiest kernels and host ops, and the run's peak of
    allocated device memory (the caching allocator's reserve beside it:
    it holds the tick programs' graph pools)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    peak = torch.cuda.max_memory_allocated()
    stats = prof.key_averages()
    dev = [e for e in stats if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in dev)
    top = lambda evs, key: [
        {"name": e.key[:70], "count": e.count, "us": getattr(e, key)}
        for e in sorted(evs, key=lambda e: -getattr(e, key))[:8]]
    host_calls = lambda name: {
        "count": sum(e.count for e in stats if e.key == name),
        "us": sum(e.self_cpu_time_total for e in stats if e.key == name)}
    return {"profiled_wall_us": wall_us,
            "host_cuda_launch_kernel": host_calls("cudaLaunchKernel"),
            "host_cuda_graph_launch": host_calls("cudaGraphLaunch"),
            "peak_allocated_bytes": peak,
            "reserved_bytes": torch.cuda.memory_reserved(),
            "device_busy_us": busy_us if dev else "not measured",
            "device_busy_share": busy_us / wall_us if dev else None,
            "device_events": sum(e.count for e in dev),
            "top_device": top(dev, "self_device_time_total"),
            "top_host_ops": top([e for e in stats
                                 if e.device_type == DeviceType.CPU],
                                "self_cpu_time_total")}


def profile_ops_by_shape(fn, top: int = 8) -> list:
    """The PyTorch ops whose own kernels take the most device time in one
    more run of ``fn``, grouped by input shape (shapes are recorded here
    only: recording them slows the host)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    ops = [e for e in prof.key_averages(group_by_input_shape=True)
           if e.device_type == DeviceType.CPU]
    return [{"name": e.key, "shapes": str(e.input_shapes)[:160],
             "count": e.count, "self_device_us": e.self_device_time_total}
            for e in sorted(ops, key=lambda e: -e.self_device_time_total)
            [:top]]


def capture_b3_inputs(engine, num_seg: int):
    """The RIT blocks one fused tick hands to B3: ``num_seg`` sessions on
    orbits 25 degrees apart, primed at their first pose, warped into their
    first window, co-rendering the pose after it. Returns the arguments
    and ``num_seg`` of the tick's ``fused_gather_dual`` call."""
    import torch
    from repro_torch.core.pipeline import orbit_trajectory
    from repro_torch.kernels import streaming_pipeline as sp_k

    n = engine.window
    trajs = [orbit_trajectory(n + 1, phase_deg=25.0 * i)
             for i in range(num_seg)]
    ref = torch.stack([t[0] for t in trajs])
    tgt = torch.stack([torch.stack(t[:n]) for t in trajs])
    nxt = torch.stack([t[n] for t in trajs])
    rgb, dep = engine.prime_reference(ref)
    seen = []
    real = sp_k.fused_gather_dual
    engine.cuda_graphs = False  # the spy must see the call itself

    def spy(*args, **kw):
        seen.append((args, kw["num_seg"]))
        return real(*args, **kw)

    sp_k.fused_gather_dual = spy
    try:
        engine.render_windows_streaming(rgb, dep, ref, tgt, nxt)
    finally:
        sp_k.fused_gather_dual = real
    if len(seen) != 1:
        fail(f"a fused tick called fused_gather_dual {len(seen)} times")
    return seen[0]


def capture_scened_inputs(engine, sessions):
    """The blocks the first tick of a mixed-scene fused serving run hands
    to B4 (the first chunk of its admission priming) and B5 (its fused
    sweep): ``((pages, scene_of_seg, ids, weights), num_seg)`` and
    ``((pages, scene_of_seg, ids_h, w_h, ids_r, w_r), num_seg)``."""
    from repro_torch.kernels import gather_trilerp as gt_k
    from repro_torch.kernels import streaming_pipeline as sp_k

    seen = {"b4": [], "b5": []}
    real_b4 = gt_k.gather_trilerp_mvoxels_per_seg
    real_b5 = sp_k.fused_gather_dual_per_seg

    def spy_b4(*args, **kw):
        seen["b4"].append((args, kw["num_seg"]))
        return real_b4(*args, **kw)

    def spy_b5(*args, **kw):
        seen["b5"].append((args, kw["num_seg"]))
        return real_b5(*args, **kw)

    gt_k.gather_trilerp_mvoxels_per_seg = spy_b4
    sp_k.fused_gather_dual_per_seg = spy_b5
    engine.engine.cuda_graphs = False  # the spies must see each call
    try:
        engine.submit(sessions)
        engine.step()
    finally:
        gt_k.gather_trilerp_mvoxels_per_seg = real_b4
        sp_k.fused_gather_dual_per_seg = real_b5
    if len(seen["b5"]) != 1 or not seen["b4"]:
        fail(f"a mixed-scene tick called B5 {len(seen['b5'])} and B4 "
             f"{len(seen['b4'])} times")
    return seen["b4"][0], seen["b5"][0]


# Arm E's fleet: session i views ARM_E_SCENES[i]. 4 pages: the first wave
# (sessions 0-3) hits on its second "chair"; the second evicts three
# scenes and repages "drums"; the third repages "chair", "ficus" and
# "materials" and hits on "lego". Every tick mixes 3-4 scenes.
ARM_E_SCENES = ["chair", "drums", "chair", "ficus",
                "hotdog", "lego", "materials", "drums",
                "chair", "lego", "ficus", "materials"]


def arm_e_sessions(n_sessions: int, n_frames: int) -> list:
    from repro_torch.core.pipeline import orbit_trajectory
    from repro_torch.serve.render_engine import RenderSession

    return [RenderSession(sid=i, poses=orbit_trajectory(
        n_frames, phase_deg=30.0 * i), scene=ARM_E_SCENES[i])
        for i in range(n_sessions)]


def c2_tables(grid_res: int, channels: int, device) -> list:
    """Each of arm E's scene tables baked on ``device`` against its CPU
    bake: how many vertices differ and by how much, and, on the same
    (CPU) vertex coordinates, how many vertices pick another nearest
    object (an argmin of near-equal distances) on the two devices."""
    import torch
    from repro_torch.nerf import scenes

    axes = torch.linspace(-1.0, 1.0, grid_res, dtype=torch.float32)
    axes_dev = torch.linspace(-1.0, 1.0, grid_res, dtype=torch.float32,
                              device=device).cpu()
    x, y, z = torch.meshgrid(axes, axes, axes, indexing="ij")
    pts = torch.stack([x, y, z], dim=-1).reshape(-1, 3)
    rows = []
    for name in sorted(set(ARM_E_SCENES)):
        scene = scenes.make_scene(name)
        card = scenes.bake_dense_table(scene, grid_res, channels,
                                       device=device).cpu()
        cpu = scenes.bake_dense_table(scene, grid_res, channels, device="cpu")
        diff = (card - cpu).abs().amax(1)
        d_card, i_card = scenes._sdf(scene, pts.to(device))
        d_cpu, i_cpu = scenes._sdf(scene, pts)
        rows.append({
            "scene": name, "equal": bool(torch.equal(card, cpu)),
            "max_abs_diff_per_channel":
                (card - cpu).abs().amax(0).tolist(),
            "vertices_differing": int((diff > 0).sum()),
            "vertices_differing_over_1e-3": int((diff > 1e-3).sum()),
            "vertices": int(diff.numel()),
            "linspace_equal": bool(torch.equal(axes, axes_dev)),
            "nearest_object_flips_same_points":
                int((i_card.cpu() != i_cpu).sum()),
            "sdf_max_abs_diff_same_points":
                float((d_card.cpu() - d_cpu).abs().max())})
    return rows


def c2_first_tick(engine, sessions) -> tuple:
    """The first tick of a mixed-scene fused serving run, with every call
    of B4, B5, the per-scene fallback gather and the composite recorded
    (inputs and output, moved to the CPU), and the tick's frames."""
    import torch
    from repro_torch.kernels import gather_trilerp as gt_k
    from repro_torch.kernels import streaming_pipeline as sp_k
    from repro_torch.nerf import volrend

    calls = []
    cpu = lambda x: (
        x.detach().to("cpu", copy=True) if torch.is_tensor(x) else
        tuple(cpu(y) for y in x) if isinstance(x, tuple) else x)
    spied = [(gt_k, "gather_trilerp_mvoxels_per_seg"),
             (sp_k, "fused_gather_dual_per_seg"),
             (sp_k, "gather_trilerp_ref_scened"), (volrend, "composite")]
    real = {name: getattr(mod, name) for mod, name in spied}

    def spy(name):
        def f(*args, **kw):
            out = real[name](*args, **kw)
            calls.append((name, [cpu(a) for a in args if torch.is_tensor(a)],
                          cpu(out)))
            return out
        return f

    for mod, name in spied:
        setattr(mod, name, spy(name))
    engine.engine.cuda_graphs = False  # the spies read each call back
    try:
        engine.submit(sessions)
        engine.step()
        engine.finalize()
    finally:
        for mod, name in spied:
            setattr(mod, name, real[name])
    frames = [f.cpu() for sess in sessions for f in sess.frames
              if f is not None]
    return calls, frames


def c2_compare(card: tuple, host: tuple) -> list:
    """Card against CPU, call by call (``c2_first_tick``'s records), one
    row per function: its calls, the largest difference of their float
    inputs and of their outputs, and how many calls had integer inputs
    (corner ids) that differ; then the frames' largest difference."""
    import torch

    def diff(a, b):
        if isinstance(a, tuple):
            return max(diff(x, y) for x, y in zip(a, b))
        if a.shape != b.shape:
            return float("inf")
        if not a.is_floating_point():
            return 0.0 if torch.equal(a, b) else float("inf")
        return float((a.float() - b.float()).abs().max()) if a.numel() \
            else 0.0

    (calls_g, frames_g), (calls_c, frames_c) = card, host
    if [n for n, _, _ in calls_g] != [n for n, _, _ in calls_c]:
        fail("C2: the card and the CPU tick call other functions")
    rows = {}
    for (name, ig, og), (_, ic, oc) in zip(calls_g, calls_c):
        d_in = [diff(a, b) for a, b in zip(ig, ic)]
        row = rows.setdefault(name, {"fn": name, "calls": 0,
                                     "float_inputs_max_abs_diff": 0.0,
                                     "calls_with_int_inputs_differing": 0,
                                     "output_max_abs_diff": 0.0})
        row["calls"] += 1
        row["float_inputs_max_abs_diff"] = max(
            [row["float_inputs_max_abs_diff"]]
            + [x for x in d_in if x != float("inf")])
        row["calls_with_int_inputs_differing"] += float("inf") in d_in
        row["output_max_abs_diff"] = max(row["output_max_abs_diff"],
                                         diff(og, oc))
    return list(rows.values()) + [{"frames": len(frames_g),
                                   "frames_max_abs_diff": max(
                                       diff(a, b) for a, b in
                                       zip(frames_g, frames_c))}]


def c2_warps(engine, sessions) -> tuple:
    """Serve ``sessions`` on ``engine``, recording every tick's warp
    (``sparw.warp_frames_flat``): its reference frames and depths, the
    warped colours and the hole flags, copied to the CPU (the references
    live in a buffer each tick rewrites). Returns (records, the run's
    metrics)."""
    from repro_torch.core import sparw

    real, rec = sparw.warp_frames_flat, []
    copy = lambda t: t.to("cpu", copy=True)

    def spy(rgb_ref, dep_ref, *args, **kw):
        out = real(rgb_ref, dep_ref, *args, **kw)
        rec.append({"rgb_ref": copy(rgb_ref), "dep_ref": copy(dep_ref),
                    "rgb": copy(out.rgb), "holes": copy(out.holes)})
        return out

    sparw.warp_frames_flat = spy
    engine.engine.cuda_graphs = False  # the spy reads every tick back
    try:
        metrics = engine.run(sessions)
    finally:
        sparw.warp_frames_flat = real
    return rec, metrics


def c2_compare_warps(card: list, host: list) -> list:
    """Tick by tick: how far the warp's inputs (the co-rendered reference)
    are apart, how many target pixels change their hole flag, and how many
    pixels warped on both devices take another colour (another source
    pixel won the pixel)."""
    rows = []
    for t, (g, c) in enumerate(zip(card, host)):
        warped = ~g["holes"] & ~c["holes"]
        d = (g["rgb"] - c["rgb"]).abs().amax(-1)
        rows.append({
            "tick": t,
            "ref_rgb_max_abs_diff": float(
                (g["rgb_ref"] - c["rgb_ref"]).abs().max()),
            "ref_depth_max_abs_diff": float(
                (g["dep_ref"] - c["dep_ref"]).abs().max()),
            "hole_flags_differing": int((g["holes"] != c["holes"]).sum()),
            "warped_pixels": int(warped.sum()),
            "warped_pixels_differing_over_1e-3": int(
                (warped & (d > 1e-3)).sum()),
            "warped_max_abs_diff": float(d[warped].max()) if warped.any()
            else 0.0})
    return rows


def arm_b_params(seed: int = 0, hidden: int = 64, res: int = 64) -> dict:
    """Random (untrained) parameters at NerfConfig's defaults (hidden
    width ``hidden``, grid ``res``), with the reference initializer's
    scales, drawn from numpy."""
    import numpy as np

    rng = np.random.default_rng(seed)
    c, h = 8, hidden
    f32 = lambda a: np.asarray(a, np.float32)
    normal = lambda rows, cols: f32(rng.standard_normal((rows, cols))
                                    / np.sqrt(rows))
    return {"table": f32(0.01 * rng.standard_normal((res**3, c))),
            "decoder": {"w1": normal(c, h), "b1": f32(np.zeros(h)),
                        "w2": normal(h, h), "b2": f32(np.zeros(h)),
                        "w_sigma": normal(h, 1),
                        "w_rgb": normal(h + 9, 3), "b_rgb": f32(np.zeros(3))}}

# Arm I: the paper's three NeRF configs (configs.cicero_nerf) at their
# published widths, random weights, 16 frames at res 64 (window 16), staged
ARM_I_CONFIGS = ("cicero-dvgo", "cicero-ngp", "cicero-tensorf")
ARM_I_FRAMES = 16
# the fig. 26 setup: the oracle on the specular "materials" scene
ARM_I_ORACLE = dict(scene="materials", specular=0.6, res=48, window=4,
                    frames=8, step_deg=4.0, phi_deg=4.0, num_samples=32)


def arm_i_model(name: str, device, configs=None):
    """Config ``name`` (``configs.cicero_nerf.NERF_CONFIGS`` unless
    ``configs`` is given) on the streaming backend, with ``NerfModel.init``
    weights from a ``torch.Generator`` seeded 0 on ``device``."""
    import torch
    from repro_torch.configs.cicero_nerf import NERF_CONFIGS
    from repro_torch.nerf import models

    cfg = (configs or NERF_CONFIGS)[name]
    model = models.NerfModel(dataclasses.replace(cfg, backend="streaming"))
    gen = torch.Generator(device=device).manual_seed(0)
    return model, model.init(gen, device=device)


def run_arm_i(models_params: dict, reset, counts, profile, *, res: int = 64,
              window: int = 16, n_frames: int = ARM_I_FRAMES) -> tuple:
    """Arm I: each ``(model, params)`` of ``models_params`` rendered cold,
    again (capturing its tick program) and warm through
    ``make_renderer(...).render``, then profiled. ``ngp`` and ``tensorf``
    are held against the port's CPU run of the same window; ``dvgo``
    against the card's own ``backend="reference"`` render of the same
    poses (the CPU cannot hold its plain B1: 8,000 MVoxels x 512 rows x 8
    corners x 12 channels, ~1.6 GB a chunk). Each: >= 40 dB worst frame and
    equal ``RenderStats`` (hole counts). Returns (rows, warm renderers)."""
    import torch
    from repro_torch import api
    from repro_torch.core.config import RenderConfig, RenderRequest
    from repro_torch.core.pipeline import orbit_trajectory
    from repro_torch.kernels import fused_nerf_mlp as mlp_k
    from repro_torch.kernels import gather_trilerp as gt_k
    from repro_torch.nerf import models
    from repro_torch.utils import psnr

    cfg = RenderConfig(res=res, window=window, backend="streaming")
    req = RenderRequest(poses=tuple(orbit_trajectory(n_frames)))
    rows, warm_renderers = {}, {}
    for name, (model, params) in models_params.items():
        gpu = api.make_renderer(cfg, model=model, params=params)
        reset()
        cold = gpu.render(req)
        launches = counts()
        gpu.render(req)  # captures the tick program the cold run met once
        warm = gpu.render(req)
        prof = profile(lambda: gpu.render(req))
        if model.cfg.kind == "dvgo":
            against = "the card's backend='reference' render"
            ref_model = models.NerfModel(dataclasses.replace(
                model.cfg, backend="reference"))
            t0 = time.perf_counter()
            other = api.make_renderer(cfg, model=ref_model,
                                      params=params).render(req)
        else:
            against = "the CPU run"
            cpu_params = api._to_device(params, torch.device("cpu"))
            t0 = time.perf_counter()
            other = api.make_renderer(cfg, model=model, params=cpu_params,
                                      device="cpu").render(req)
        other_s = time.perf_counter() - t0
        frames = [f.cpu() for f in cold.frames]
        for f in frames:
            if f.shape != (res, res, 3) or not torch.isfinite(f).all():
                fail(f"arm I {name}: a frame is not finite [{res}]^2 x 3")
        worst = min(float(psnr(f, o.cpu()))
                    for f, o in zip(frames, other.frames))
        if worst < 40.0:
            fail(f"arm I {name}: a frame is {worst:.2f} dB from {against}")
        sg, so = dataclasses.asdict(cold.stats), dataclasses.asdict(
            other.stats)
        if sg != so or cold.stats.frames != n_frames:
            fail(f"arm I {name}: stats differ from {against} ({sg} vs "
                 f"{so})")
        b1, b2 = launches[gt_k.KERNEL.name], launches[mlp_k.KERNEL.name]
        if b2 == 0 or (b1 > 0) != (model.cfg.kind == "dvgo"):
            fail(f"arm I {name}: B1 launched {b1} times, B2 {b2} (B2 must "
                 "run; B1 for the dense grid only)")
        c = model.cfg
        rows[name] = {
            "kind": c.kind, "feat_channels": c.feat_channels,
            "mlp_hidden": c.mlp_hidden, "num_samples": c.num_samples,
            "feature_table_bytes": c.feature_table_bytes(),
            "frames": n_frames, "res": res, "window": window,
            "ticks": -(-n_frames // window), "launches": launches,
            "profile": prof, "checked_against": against,
            "min_psnr_db": worst, "check_wall_s": other_s,
            "reference_renders": cold.stats.reference_renders,
            "sparse_pixels": cold.stats.sparse_pixels,
            "fallback_pixels": cold.stats.fallback_pixels,
            "hole_counts": [round(h * res * res)
                            for h in cold.stats.hole_fractions],
            "cold_wall_s": cold.wall_s, "warm_wall_s": warm.wall_s,
            "warm_fps": warm.fps}
        warm_renderers[name] = gpu
    return rows, warm_renderers


def run_arm_i_oracle() -> dict:
    """Arm I's oracle: ``CiceroRenderer(oracle, {}, config=...)`` at the
    fig. 26 setup on the card (the config names no device) against the
    same on the CPU: >= 40 dB worst frame, equal ``RenderStats``."""
    import torch
    from repro_torch.core.config import RenderConfig
    from repro_torch.core.pipeline import CiceroRenderer, orbit_trajectory
    from repro_torch.nerf import models, scenes
    from repro_torch.utils import psnr

    o = ARM_I_ORACLE
    model, _ = models.make_model(
        "oracle", scene=scenes.make_scene(o["scene"],
                                          specular=o["specular"]),
        num_samples=o["num_samples"])
    cfg = RenderConfig(res=o["res"], window=o["window"], phi_deg=o["phi_deg"])
    traj = orbit_trajectory(o["frames"], step_deg=o["step_deg"])
    card = CiceroRenderer(model, {}, config=cfg)
    t0 = time.perf_counter()
    frames, stats = card.render_trajectory(traj)
    if card.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cpu_frames, cpu_stats = CiceroRenderer(
        model, {}, config=cfg.replace(device="cpu")).render_trajectory(traj)
    worst = min(float(psnr(f.cpu(), c)) for f, c in zip(frames, cpu_frames))
    if worst < 40.0:
        fail(f"arm I oracle: a frame is {worst:.2f} dB from the CPU run")
    if dataclasses.asdict(stats) != dataclasses.asdict(cpu_stats):
        fail(f"arm I oracle: stats differ from the CPU run ({stats} vs "
             f"{cpu_stats})")
    return {"setup": o, "device": str(card.device), "min_psnr_db": worst,
            "sparse_pixels": stats.sparse_pixels,
            "fallback_pixels": stats.fallback_pixels,
            "mean_hole_fraction": stats.mean_hole_fraction,
            "wall_s": wall}


# Phase T: NeRF training on the card (nerf/train.py) for arm I's three
# configs at full width on the reference backend, then arm I rendered on
# the fitted params. Tolerances of the card-vs-CPU step check: the loss at
# rtol 1e-5; each grad leaf at rtol 1e-3 and atol 1e-4 x the leaf's largest
# CPU grad (float32 sums over 8,192 points in another order, the card's
# index_put accumulating atomically; the scene's targets differ by float
# noise at a density slope of up to 600 per unit); one AdamW step on the
# card's own grads, run on the CPU, at rtol 1e-5 / atol 1e-7 (the same
# float32 operations, pow and sqrt rounded apart)
T_CHECK_STEPS = 3
T_BATCH = 8192
T_STEPS = 400
T_LR = 5e-3
T_LOSS_TOL = dict(rtol=1e-5, atol=0.0)
T_GRAD_RTOL, T_GRAD_ATOL_OF_MAX = 1e-3, 1e-4
T_ADAM_TOL = dict(rtol=1e-5, atol=1e-7)
T_HELD_OUT = 8192  # numpy points of the held-out field loss
T_SCENE = "lego"
# At fit_field's defaults the dense grid of cicero-dvgo (160^3 vertices)
# stays fog: each vertex meets ~6 samples in 400 steps of 8,192 points,
# so its features barely leave their random init (held-out loss 0.14,
# frames 7.5 dB from the oracle's against the random weights' 9.3). Phase
# T records that fit; arm I fitted renders a second fit of the same 400
# steps at 8x the batch, which costs the same wall (the steps are
# host-bound) and renders above the random weights
T_DVGO_BATCH = 8 * T_BATCH
# train_images: the oracle's frames of 8 orbit poses at res 64
T_IMAGES = dict(config="cicero-ngp", res=64, poses=8, step_deg=45.0,
                steps=300, rays_per_batch=4096)


def _np_batch(n: int, seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    dirs = rng.standard_normal((n, 3)).astype(np.float32)
    return pts, dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)


def _cpu_tree(tree):
    from repro_torch.api import _to_device
    import torch

    return _to_device(tree, torch.device("cpu"))


def t_check_steps(model, scene, dev, steps: int = T_CHECK_STEPS,
                  batch: int = T_BATCH) -> dict:
    """The first ``steps`` steps of ``fit_field`` on host-drawn batches, on
    ``dev`` and, from the same params and state each step, on the CPU:
    loss and every grad leaf allclose, and AdamW on ``dev``'s grads run on
    the CPU equal to ``dev``'s new params."""
    import numpy as np
    import torch
    from repro_torch.nerf import train
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, \
        cosine_warmup
    from repro_torch.optim.adamw import tree_flatten

    name = model.cfg.kind
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    opt = adamw_init(params)
    no_clip = AdamWConfig(grad_clip_norm=0.0)
    rows = []
    for s in range(steps):
        pts, dirs = _np_batch(batch, 100 + s)
        cpu_p, cpu_o = _cpu_tree(params), _cpu_tree(opt)
        new_p, new_o, loss, grads = train.field_step(
            model, scene, params, opt, s, torch.from_numpy(pts).to(dev),
            torch.from_numpy(dirs).to(dev), lr=T_LR, steps=T_STEPS)
        _, _, cpu_loss, cpu_grads = train.field_step(
            model, scene, cpu_p, cpu_o, s, torch.from_numpy(pts),
            torch.from_numpy(dirs), lr=T_LR, steps=T_STEPS)
        loss_err = abs(float(loss) - float(cpu_loss))
        if loss_err > T_LOSS_TOL["rtol"] * abs(float(cpu_loss)):
            fail(f"phase T {name} step {s}: loss {float(loss)} on the card, "
                 f"{float(cpu_loss)} on the CPU")
        worst = 0.0
        for i, (g, c) in enumerate(zip(tree_flatten(grads)[0],
                                       tree_flatten(cpu_grads)[0])):
            g = g.cpu()
            scale = float(c.abs().max())
            err = (g - c).abs()
            if bool((err > T_GRAD_ATOL_OF_MAX * scale
                     + T_GRAD_RTOL * c.abs()).any()):
                fail(f"phase T {name} step {s}: grad leaf {i} "
                     f"{tuple(c.shape)} differs from the CPU's by "
                     f"{float(err.max()):.3g} (largest grad {scale:.3g})")
            worst = max(worst, float(err.max()) / max(scale, 1e-30))
        lr_t = cosine_warmup(s, T_LR, train.WARMUP_STEPS, T_STEPS)
        host_p, _ = adamw_update(_cpu_tree(grads), cpu_p, cpu_o, s, no_clip,
                                 lr_t)
        adam_err = 0.0
        for g, c in zip(tree_flatten(new_p)[0], tree_flatten(host_p)[0]):
            g = g.cpu()
            if not torch.allclose(g, c, **T_ADAM_TOL):
                fail(f"phase T {name} step {s}: AdamW on the card differs "
                     "from AdamW on the CPU on the same grads")
            adam_err = max(adam_err, float((g - c).abs().max()))
        rows.append({"step": s, "loss": float(loss),
                     "loss_rel_err": loss_err / abs(float(cpu_loss)),
                     "grad_err_of_leaf_max": worst,
                     "adamw_max_abs_err": adam_err})
        params, opt = new_p, new_o
    return rows


def t_held_out_loss(model, scene, params, dev) -> float:
    import torch
    from repro_torch.nerf import scenes, train

    pts, dirs = (torch.from_numpy(a).to(dev)
                 for a in _np_batch(T_HELD_OUT, 99))
    with torch.no_grad():
        return float(train.field_loss(model, params, pts, dirs,
                                      scenes.scene_density(scene, pts),
                                      scenes.scene_albedo(scene, pts)))


def oracle_frames(cfg, dev, res: int = 64,
                  n_frames: int = ARM_I_FRAMES) -> list:
    """The oracle's full renders of arm I's poses (the analytic "lego" at
    ``cfg``'s samples, near and far), on the CPU."""
    from repro_torch.core.pipeline import orbit_trajectory
    from repro_torch.nerf import models, rays, scenes

    oracle = models.NerfModel(dataclasses.replace(cfg, kind="oracle"),
                              scene=scenes.make_scene(T_SCENE))
    cam = rays.Camera.square(res)
    return [oracle.render_image({}, cam, p.to(dev))[0].cpu()
            for p in orbit_trajectory(n_frames)]


def psnr_vs(frames, truth) -> dict:
    from repro_torch.utils import psnr

    db = [float(psnr(f.cpu(), t)) for f, t in zip(frames, truth)]
    return {"min": min(db), "mean": sum(db) / len(db)}


def t_fit(model, scene, dev, steps: int, batch: int, res: int = 64) -> tuple:
    """``fit_field`` on ``dev`` with batches drawn there: (params, row of
    wall, steps/s, allocated bytes before and the peak during, held-out
    field loss before and after, which must be finite and fall, and the
    PSNR of the fitted model's full renders of arm I's poses against the
    oracle's)."""
    import math

    import torch
    from repro_torch.core.pipeline import orbit_trajectory
    from repro_torch.nerf import rays, train

    cuda = torch.device(dev).type == "cuda"
    init = model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    before = t_held_out_loss(model, scene, init, dev)
    del init
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    start_bytes = torch.cuda.memory_allocated() if cuda else None
    t0 = time.perf_counter()
    params = train.fit_field(model, scene,
                             torch.Generator(device=dev).manual_seed(0),
                             steps=steps, batch=batch, device=dev)
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if cuda else None
    after = t_held_out_loss(model, scene, params, dev)
    if not (math.isfinite(after) and after < before):
        fail(f"phase T {model.cfg.kind}: held-out field loss {before:.4g} "
             f"-> {after:.4g} at {steps} x {batch} (must be finite and "
             "fall)")
    cam = rays.Camera.square(res)
    with torch.no_grad():
        frames = [model.render_image(params, cam, p.to(dev))[0]
                  for p in orbit_trajectory(ARM_I_FRAMES)]
    return params, {
        "steps": steps, "batch": batch, "fit_wall_s": wall,
        "steps_per_s": steps / wall, "allocated_before_bytes": start_bytes,
        "peak_allocated_bytes": peak,
        "held_out_loss_before": before, "held_out_loss_after": after,
        "full_render_psnr_vs_oracle_db": psnr_vs(
            frames, oracle_frames(model.cfg, dev, res))}


def run_phase_t(names, dev, *, configs=None, steps: int = T_STEPS,
                batch: int = T_BATCH, dvgo_batch: int = T_DVGO_BATCH,
                check_batch: int = T_BATCH, images: dict = T_IMAGES
                ) -> tuple:
    """Phase T: for each config of ``names`` (``NERF_CONFIGS`` unless
    ``configs`` is given) on the reference backend, the card-vs-CPU check
    of ``fit_field``'s first steps (:func:`t_check_steps`), then
    ``fit_field`` at ``steps`` x ``batch`` with batches drawn on the card
    (:func:`t_fit`), and for a ``dvgo`` config again at ``dvgo_batch``
    (see ``T_DVGO_BATCH``); then ``train_images`` for
    ``images["config"]`` against the oracle's frames; a streaming
    ``dvgo`` model must raise ``ValueError``. Returns (rows, fitted params
    by name: the ``dvgo_batch`` fit for ``dvgo``, else the only one)."""
    import math

    import torch
    from repro_torch.configs.cicero_nerf import NERF_CONFIGS
    from repro_torch.core.pipeline import orbit_trajectory
    from repro_torch.nerf import models, rays, scenes, train

    cuda = torch.device(dev).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    scene = scenes.make_scene(T_SCENE)
    configs = configs or NERF_CONFIGS
    rows, fitted = {}, {}
    for name in names:
        model = models.NerfModel(dataclasses.replace(configs[name],
                                                     backend="reference"))
        t0 = time.perf_counter()
        row = {"check_steps": t_check_steps(model, scene, dev,
                                            batch=check_batch)}
        row["check_s"] = time.perf_counter() - t0
        fitted[name], fit = t_fit(model, scene, dev, steps, batch)
        row.update(fit)
        if model.cfg.kind == "dvgo":
            fitted[name], row["wide_batch_fit"] = t_fit(
                model, scene, dev, steps, dvgo_batch)
        rows[name] = row
    # train_images: photometric training against the oracle's frames
    im = images
    model = models.NerfModel(dataclasses.replace(configs[im["config"]],
                                                 backend="reference"))
    oracle = models.NerfModel(dataclasses.replace(
        configs[im["config"]], kind="oracle"), scene=scene)
    cam = rays.Camera.square(im["res"])
    poses = orbit_trajectory(im["poses"], step_deg=im["step_deg"])
    sync()
    t0 = time.perf_counter()
    _, losses = train.train_images(
        model, lambda c2w: oracle.render_image({}, cam, c2w.to(dev)), cam,
        poses, torch.Generator(device=dev).manual_seed(0), steps=im["steps"],
        rays_per_batch=im["rays_per_batch"], device=dev)
    sync()
    wall = time.perf_counter() - t0
    if not all(math.isfinite(x) for x in losses) or \
            sum(losses[-10:]) >= sum(losses[:10]):
        fail(f"phase T train_images: losses {losses[:3]} ... {losses[-3:]} "
             "(must be finite and fall)")
    rows["train_images"] = dict(im, first_loss=losses[0],
                                last_loss=losses[-1], wall_s=wall,
                                steps_per_s=im["steps"] / wall)
    # the streaming gather has no gradient: training must refuse it
    streaming = models.NerfModel(dataclasses.replace(
        configs[names[0]], kind="dvgo", backend="streaming"))
    try:
        train.fit_field(streaming, scene,
                        torch.Generator(device=dev).manual_seed(0), steps=1,
                        batch=8, device=dev)
    except ValueError as e:
        rows["streaming_dvgo_refused"] = str(e)
    else:
        fail("phase T: fit_field trained a streaming dvgo model (B1 has "
             "no gradient)")
    return rows, fitted


def run_arm_i_fitted(fitted: dict, arm_i_models: dict, random_renderers,
                     reset, counts, *, res: int = 64, window: int = 16,
                     n_frames: int = ARM_I_FRAMES) -> dict:
    """Arm I on the fitted params: each config's streaming model object
    from arm I (its halo-table cache holds the random-weight table)
    renders its ``fitted`` params through ``make_renderer(...).render``,
    cold, again and warm, as arm I does; B2 must launch, B1 for the dense
    grid only, and the warm run (a graph replay) must count the cold
    (eager) run's launches: the fitted weights' holes overflow the pool
    into the dense fallback, so the counts are this run's, not arm I's.
    Its frames must equal a fresh model object's render of the
    same params within 60 dB and equal ``RenderStats`` (nothing cached from
    the random weights), and its mean PSNR against the oracle's frames of
    the same poses must beat the random-weight render's
    (``random_renderers``: arm I's warm renderers)."""
    import torch
    from repro_torch import api
    from repro_torch.core.config import RenderConfig, RenderRequest
    from repro_torch.core.pipeline import orbit_trajectory
    from repro_torch.kernels import fused_nerf_mlp as mlp_k
    from repro_torch.kernels import gather_trilerp as gt_k
    from repro_torch.nerf import models
    from repro_torch.utils import params_device, psnr

    cfg = RenderConfig(res=res, window=window, backend="streaming")
    req = RenderRequest(poses=tuple(orbit_trajectory(n_frames)))
    rows = {}
    for name, params in fitted.items():
        model, _ = arm_i_models[name]
        dev = params_device(params)
        truth = oracle_frames(model.cfg, dev, res, n_frames)
        random_frames = random_renderers[name].render(req).frames
        gpu = api.make_renderer(cfg, model=model, params=params,
                                device=dev)
        reset()
        cold = gpu.render(req)
        launches = counts()
        gpu.render(req)
        reset()
        warm = gpu.render(req)
        if counts() != launches:
            fail(f"arm I fitted {name}: the replayed run launched "
                 f"{counts()}, the eager run {launches}")
        fresh = api.make_renderer(cfg, model=models.NerfModel(model.cfg),
                                  params=params, device=dev).render(req)
        frames = [f.cpu() for f in cold.frames]
        for f in frames:
            if f.shape != (res, res, 3) or not torch.isfinite(f).all():
                fail(f"arm I fitted {name}: a frame is not finite")
        vs_fresh = min(float(psnr(f, o.cpu()))
                       for f, o in zip(frames, fresh.frames))
        if vs_fresh < 60.0 or dataclasses.asdict(cold.stats) != \
                dataclasses.asdict(fresh.stats):
            fail(f"arm I fitted {name}: the arm's model object renders the "
                 f"fitted params {vs_fresh:.1f} dB from a fresh object's "
                 "(a cache served the random weights?)")
        b1, b2 = launches[gt_k.KERNEL.name], launches[mlp_k.KERNEL.name]
        if b2 == 0 or (b1 > 0) != (model.cfg.kind == "dvgo"):
            fail(f"arm I fitted {name}: B1 launched {b1} times, B2 {b2}")
        fit_db, rnd_db = psnr_vs(frames, truth), psnr_vs(random_frames,
                                                         truth)
        if fit_db["mean"] <= rnd_db["mean"]:
            fail(f"arm I fitted {name}: mean PSNR against the oracle "
                 f"{fit_db['mean']:.2f} dB, random weights "
                 f"{rnd_db['mean']:.2f} dB")
        rows[name] = {
            "frames": n_frames, "res": res, "window": window,
            "launches": launches, "psnr_vs_oracle_db": fit_db,
            "random_weights_psnr_vs_oracle_db": rnd_db,
            "min_psnr_vs_fresh_model_db": vs_fresh,
            "sparse_pixels": cold.stats.sparse_pixels,
            "fallback_pixels": cold.stats.fallback_pixels,
            "hole_counts": [round(h * res * res)
                            for h in cold.stats.hole_fractions],
            "cold_wall_s": cold.wall_s, "warm_wall_s": warm.wall_s,
            "warm_fps": warm.fps}
    return rows


# Arm F: LM serving at qwen2.5-32b's full width, depth cut to 8 of 64
# layers (16 until arms W and V joined the script: PERF.md section 4; at 4
# layers F2's bf16 noise reads above its 1.25x RMS limit), random weights;
# 8 requests on 4 slots.
LM_ARCH = "qwen2.5-32b"
LM_LAYERS = 8
LM_PROMPTS = [2048, 1536, 1024, 512, 1792, 768, 1280, 256]
LM_MAX_NEW = 32
LM_SLOTS = 4
LM_MAX_LEN = 2048 + 32 + 4
# F1: the same engine at the same width, 2 layers, float32, card vs CPU
F1_LAYERS = 2
F1_PROMPTS = [64, 48, 40, 32]
F1_SLOTS = 2
F1_MAX_NEW = 8
# float32 on two devices: sums over 5,120-27,648 terms in other orders
F1_TOL = dict(atol=1e-3, rtol=1e-3)
# the attention tolerance of the reference's tests (tests/test_kernels.py)
ATTN_F32_TOL = dict(atol=2e-5, rtol=1e-4)
# bfloat16 attention: a few bfloat16 steps at the outputs' scale (one step
# is 2**-8 of a value; randn q/k/v give outputs of about 0.04-1)
B6_BF16_TOL = dict(atol=8e-3, rtol=1e-2)
# the split-KV decode's float32 partials (m, l, unnormalized o): sums of up
# to a split's length (192 keys at arm F) in another order than the plain
# version's
DECODE_PARTIALS_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_FLOP_PER_S = 989e12  # H100 SXM dense bf16 tensor cores
B6 = "flash_attention"  # the B6 source's name in the launch counts


def lm_model(num_layers: int, dtype: str, seed: int, device):
    """``LM_ARCH`` at ``num_layers`` with random weights at the reference's
    scales from a ``torch.Generator``, its QKV biases drawn non-zero
    (N(0, 0.5^2)) so that the bias path carries weight."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.models import lm
    from repro_torch.models.common import ninit

    cfg = registry.get(LM_ARCH).with_(num_layers=num_layers, dtype=dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = lm.init_params(cfg, gen, device)
    for layer in params["layers"]:
        for name in ("bq", "bk", "bv"):
            b = layer["mixer"][name]
            b.copy_(ninit(gen, b.shape, 0.5, b.dtype))
    return cfg, params


def lm_requests(lengths, vocab: int, max_new: int, seed: int = 0) -> list:
    import numpy as np
    from repro_torch.serve import Request

    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, vocab, size=n).astype(np.int32)
               for n in lengths]
    return [Request(rid=i, prompt=p, max_new=max_new)
            for i, p in enumerate(prompts)]


def serve_lm(cfg, params, requests, num_slots: int, max_len: int, device):
    """One ``ServeEngine.run`` over ``requests``, recording each prefill's
    logits (cloned), each request's prefill seconds and time to first token
    (its greedy token is read on the host, which waits for the device), and
    the decode ticks. Returns (stats, wall seconds, record)."""
    import torch
    from repro_torch.serve import ServeEngine

    eng = ServeEngine(cfg, params, num_slots=num_slots, max_len=max_len,
                      device=device)
    rec = {"logits": [], "prefill_s": [], "ttft_s": [], "decode_ticks": 0}
    prefill, assign, decode = eng.prefill, eng._assign, eng.decode

    def spy_prefill(p, batch):
        logits, caches = prefill(p, batch)
        rec["logits"].append(logits.clone())
        return logits, caches

    def spy_assign(req, slot):
        t = time.perf_counter()
        assign(req, slot)
        now = time.perf_counter()
        rec["prefill_s"].append(now - t)
        rec["ttft_s"].append(now - t0)

    def spy_decode(*args):
        rec["decode_ticks"] += 1
        return decode(*args)

    eng.prefill, eng._assign, eng.decode = spy_prefill, spy_assign, spy_decode
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        stats = eng.run(requests)
        if device.type == "cuda":
            torch.cuda.synchronize()
    finally:
        # the spy holds a bound method of eng: without this the cycle keeps
        # the engine, its caches and its weights alive until a gc pass
        del eng._assign
    return stats, time.perf_counter() - t0, rec


# F2's controls: attentions F2 is run with in place of B6, to show what it
# can see. The planted faults are bugs a kernel could have (a key-tile loop
# one tile short, a strict causal test, the wrong KV head for a query
# head): F2 must come out false for each, on every request. The
# lower-precision ones (scores, or P and V, in bfloat16) are recorded.
F2_FAULTS = ("diag_tile_dropped", "strict_causal", "gqa_modulo")
F2_PRECISION = ("bf16_scores", "bf16_pv")
# a bug of the non-causal calls (arm W's encoder and cross-attention): the
# key-tile loop one 64-key tile short, so a row loses its last tile (at
# kv_len 1,500 the ragged tail, keys 1,472-1,499); causal calls unchanged
TAIL_FAULT = "tail_tile_dropped"


# rows of queries at a time where a check computes attention outside the
# kernels (the plain version, the float64 reference): arm M2's 10,240-row
# prefill would need 16.8 GB of fp32 scores at once
PLAIN_Q_BLOCK = 1024


def attention_reference(q, k, v, *, causal=True, sm_scale=None, kv_len=None,
                        window=0, softcap=0.0, acc="float64", fault=None,
                        q_block=PLAIN_Q_BLOCK):
    """B6's function with scores, softmax and sums in ``acc`` (float64 by
    default, the reference F2 holds the kernel and its plain version
    against), ``q_block`` query rows at a time, rounded once to ``q``'s
    dtype; ``fault`` plants one of F2's controls (``F2_FAULTS``,
    ``F2_PRECISION``, ``TAIL_FAULT``). A check harness: the port never
    calls it."""
    import torch

    acc = getattr(torch, acc)
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    g = h // kvh
    kv_len = sk if kv_len is None else kv_len
    sm_scale = d**-0.5 if sm_scale is None else sm_scale
    if fault == "gqa_modulo":  # query head h reads KV head h % KVH
        heads = torch.arange(h, device=q.device) % kvh
        k, v = k[:, heads], v[:, heads]
        kvh, g = h, 1
    ka, va = k.to(acc), v.to(acc)
    kpos = torch.arange(sk, device=q.device)[None, :]
    outs = []
    for q0 in range(0, sq, q_block):
        n = min(q_block, sq - q0)
        s = (q[:, :, q0:q0 + n].to(acc).reshape(b, kvh, g * n, d)
             @ ka.transpose(-1, -2)) * sm_scale
        if fault == "bf16_scores":
            s = s.to(torch.bfloat16).to(acc)
        if softcap > 0:
            s = softcap * torch.tanh(s / softcap)
        s = s.reshape(b, kvh, g, n, sk)
        qpos = q0 + torch.arange(n, device=q.device)[:, None]
        valid = kpos < kv_len
        if causal:
            valid = valid & ((qpos > kpos) if fault == "strict_causal"
                             else (qpos >= kpos))
        if window > 0:
            valid = valid & (qpos - kpos < window)
        if fault == "diag_tile_dropped":  # a row loses its own 32-key tile
            valid = valid & (kpos < qpos // 32 * 32)
        if fault == TAIL_FAULT and not causal:
            valid = valid & (kpos < (kv_len - 1) // 64 * 64)
        s = torch.where(valid, s, torch.full_like(s, -1e30))
        p = torch.softmax(s, dim=-1).reshape(b, kvh, g * n, sk)
        if fault == "bf16_pv":
            o = (p.to(torch.bfloat16) @ va.to(torch.bfloat16)).to(acc)
        else:
            o = p @ va
        outs.append(o.reshape(b, h, n, d))
    return torch.cat(outs, dim=2).to(q.dtype)


def plain_attention(q, k, v, **kw):
    """B6's plain version, ``PLAIN_Q_BLOCK`` query rows at a time."""
    from repro_torch.kernels import flash_attention as fa

    return fa.flash_attention_plain(q, k, v, q_block=PLAIN_Q_BLOCK, **kw)


def _prefill_with(cfg, params, request, max_len: int, attend):
    """One prefill of ``request`` with ``attend`` in ``flash_attention``'s
    place; returns its logits."""
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import lm

    tokens = torch.as_tensor(request.prompt[None].astype(np.int64),
                             device=params["embed"].device)
    real = fa.flash_attention
    fa.flash_attention = attend
    try:
        logits, _ = lm.make_prefill_step(cfg, max_len)(params,
                                                       {"tokens": tokens})
    finally:
        fa.flash_attention = real
    return logits


def f2_references(cfg, params, requests, max_len: int) -> list:
    """Each request's prefill logits with the plain version and with
    float64 attention: what ``f2_check`` holds an attention against."""
    return [{name: _prefill_with(cfg, params, r, max_len, fn)
             for name, fn in (("plain", plain_attention),
                              ("f64", attention_reference))} for r in requests]


@contextlib.contextmanager
def routing(log: list, replay: bool):
    """Record (``replay`` False) or replay each MoE router call's expert
    ids (``models.moe._router``) in call order. A replayed call keeps its
    own gates' values at the recorded ids (renormalized, as the router
    does) and counts the tokens whose own top-k differs ("flips"). A
    check harness: the port never calls it."""
    import torch
    from repro_torch.models import moe

    real, calls = moe._router, iter(list(log))
    flips = {"tokens": 0}

    def spy(params, x, cfg):
        idx, gate, aux = real(params, x, cfg)
        if not replay:
            log.append(idx.clone())
            return idx, gate, aux
        forced = next(calls)
        flips["tokens"] += int((idx != forced).any(-1).sum())
        gates = torch.softmax(x.float() @ params["router"], dim=-1)
        g = torch.gather(gates, -1, forced)
        g = g / torch.clamp(g.sum(-1, keepdim=True), min=1e-9)
        return forced, g.to(x.dtype), aux

    moe._router = spy
    try:
        yield flips
    finally:
        moe._router = real


def _b6_spy(attend, tol: dict):
    """(spy, tally): a stand-in for ``flash_attention`` that runs
    ``attend`` and holds each call's output against the plain version on
    the same q/k/v within ``tol`` (a float32 call within
    ``ATTN_F32_TOL``); ``tally`` counts the calls (windowed, non-causal,
    float32, GQA groups) and keeps the largest error."""
    import torch

    tally = {"err": 0.0, "ok": True, "calls": 0, "windowed": 0,
             "non_causal": 0, "float32": 0, "groups": set()}

    def spy(q, k, v, **kw):
        out = attend(q, k, v, **kw).float()
        want = plain_attention(q, k, v, **kw).float()
        tally["err"] = max(tally["err"], float((out - want).abs().max()))
        f32 = q.dtype == torch.float32
        tally["ok"] &= bool(torch.allclose(
            out, want, **(ATTN_F32_TOL if f32 else tol)))
        tally["calls"] += 1
        tally["float32"] += int(f32)
        tally["windowed"] += int(kw.get("window", 0) > 0)
        tally["non_causal"] += int(not kw.get("causal", True))
        tally["groups"].add(q.shape[1] // k.shape[1])
        return out.to(q.dtype)

    return spy, tally


def _logits_within(got, plain, f64, limits) -> dict:
    """One row's logits against the float64 prefill's: their max and RMS
    distance, the plain version's, the limits (``limits`` x the plain
    version's, at least 3e-2 and 1e-3) and whether ``got`` is within
    both."""
    dist = lambda a, b: (float((a - b).abs().max()),
                         float((a - b).pow(2).mean().sqrt()))
    (k_max, k_rms), (p_max, p_rms) = dist(got, f64), dist(plain, f64)
    bound = [max(3e-2, limits[0] * p_max), max(1e-3, limits[1] * p_rms)]
    return {"vs_f64_max_rms": [k_max, k_rms],
            "plain_vs_f64_max_rms": [p_max, p_rms],
            "ratio_max_rms": [k_max / p_max if p_max else None,
                              k_rms / p_rms if p_rms else None],
            "limits_max_rms": bound,
            "logits_ok": k_max <= bound[0] and k_rms <= bound[1]}


# F2's logit limits in arms F, W and V, against the plain version's
# distance from the float64 prefill: 1.5x its max, 1.25x its RMS
F_F2_LIMITS = (1.5, 1.25)


def f2_check(cfg, params, requests, refs, max_len: int, tol: dict,
             attend=None, served=None, limits=F_F2_LIMITS) -> list:
    """F2 for one attention, ``attend`` (default: ``flash_attention`` as the
    path calls it; else one of F2's controls). Each request's prefill is
    rerun on the card with ``attend`` in the path's place, spying on every
    layer's call to hold its output against the plain version on the same
    q/k/v within ``tol``. F2 holds for a request when every layer's
    attention is within ``tol`` and the logits come no further from the
    float64 prefill (``refs``, from ``f2_references``) than ``limits`` x
    the plain version's max (at least 3e-2) and RMS distance (at least
    1e-3), 1.5x and 1.25x by default. ``served``: the logits the engine's
    prefills gave, recorded as equal to the rerun or not. The logit
    distance alone misses attention faults that the model's bfloat16
    rounding hides (random weights make attention nearly uniform); the
    per-layer comparison does not. Returns one row per request.

    ``refs`` None (an MoE model): each request's references are computed
    after its rerun, with every router call's expert ids pinned to the
    rerun's (``routing``). Routing is a discrete decision: one bfloat16
    step in a layer's attention can move a token to another expert and its
    logits by O(1), whatever the attention's accuracy, so the logits are
    compared on the same routing; the tokens the references would have
    routed elsewhere on their own are recorded ("routing_flips")."""
    import torch
    from repro_torch.kernels import flash_attention as fa

    attend = fa.flash_attention if attend is None else attend
    rows = []
    for i, r in enumerate(requests):
        spy, layer = _b6_spy(attend, tol)
        log, flips = [], {}
        with routing(log, replay=False):
            got = _prefill_with(cfg, params, r, max_len, spy)
        if refs is None:
            ref = {}
            for name, fn in (("plain", plain_attention),
                             ("f64", attention_reference)):
                with routing(log, replay=True) as n:
                    ref[name] = _prefill_with(cfg, params, r, max_len, fn)
                flips[name] = n["tokens"]
        else:
            ref = refs[i]
        within = _logits_within(got, ref["plain"], ref["f64"], limits)
        rows.append({
            "rid": r.rid, "prompt": len(r.prompt),
            "layers_max_abs_err": layer["err"], "layers_ok": layer["ok"],
            "layer_calls": layer["calls"],
            "windowed_calls": layer["windowed"], **within,
            "holds": layer["ok"] and within["logits_ok"],
            "max_abs_err_vs_plain": float((got - ref["plain"]).abs().max()),
            "within_3e-2_of_plain": bool(torch.allclose(
                got, ref["plain"], atol=3e-2, rtol=3e-2)),
            "equal_to_served": (None if served is None
                                else bool(torch.equal(got, served[i]))),
            "router_calls": len(log), "routing_flips": flips})
    return rows


def b6_cost(b, h, kvh, sq, kv_len, d, causal, elem_bytes, window=0):
    """Bytes and flops the attention needs: q and o once, the kv_len rows
    of K and V once; two products of 2 flops per multiply-add, over the
    (query, key) pairs the masks leave (top-left: queries 0..sq-1 over
    keys 0..kv_len-1; causal, keys <= the query; a window, keys less than
    ``window`` before it). A softcap's tanh is not counted."""
    nbytes = (2 * b * h * sq * d + 2 * b * kvh * kv_len * d) * elem_bytes
    pairs = 0
    for i in range(sq):
        hi = min(i + 1, kv_len) if causal else kv_len
        lo = max(0, i - window + 1) if window > 0 else 0
        pairs += max(hi - lo, 0)
    return nbytes, 2 * 2 * b * h * pairs * d


# B6's window and softcap (the reference LM's local attention and
# logit_softcap), held against the plain version in both dtypes: at arm
# M2's windowed prefill, at S = window + 1, window + a 64-row query block
# + 1 and window + the reference's q_block (1,024) + 1 under a window of
# 64, and with softcap 30 at arm F's prefill and decode shapes, q scaled
# by 8 so that the scores (std ~8) reach where the cap bends them
B6_SMALL_WINDOW = 64
B6_SOFTCAP = 30.0
B6_SOFTCAP_Q_SCALE = 8.0

# arms M1, M and M2: the MoE family and local attention through the LM
# ServeEngine (see the module docstring)
M_ARCH = "moonshot-v1-16b-a3b"
# 8 of 48 layers: at arm F's 16 the whole script ran past its time limit
# once arms R joined it (PERF.md section 4)
M_LAYERS = 8
M2_ARCH = "llama4-maverick-400b-a17b"
M2_EXPERTS = 64  # of 128: all 128 leave too little of the card to prefill
M2_WINDOW = 8192  # the config's local_window
M2_PROMPTS = [10240, 8200, 1024, 512]  # 10,240 > window + q_block
M2_SLOTS = 2
M2_MAX_NEW = 16
M1_PROMPTS = [24, 13, 9, 5]  # llama4-reduced's window is 8
M1_SLOTS = 2
M1_MAX_NEW = 8
M1_MAX_LEN = 40
# F2's logit limits in the MoE arms, against the plain version's distance
# from the float64 prefill on the same routing: the path's bfloat16 P.V
# sits up to 1.59x (max) and 1.48x (RMS) as far as the plain version in
# arms M and M2 (PERF.md section 6), where arm F's dense layers stay
# within 1.5x / 1.25x; each layer's attention is held to the plain
# version at B6_BF16_TOL all the same
M_F2_LIMITS = (2.0, 2.0)
# F2's controls run in arm M2 at M_F2_LIMITS: a planted fault, whose logits
# must break the limits on every request (it read 6.5-57x the plain
# version's distance), and the bfloat16 P.V, recorded (1.1-1.5x), so that
# the limits have readings on both sides (PERF.md section 6)
M2_F2_CONTROLS = ("diag_tile_dropped", "bf16_pv")


def b6_variant_cases(dev, gen) -> list:
    """B6's windowed and softcapped cases: dicts of ``name``, ``qkv``,
    ``kw`` (the wrapper's arguments), ``variant``, ``cost`` (bytes,
    flops), ``library`` (SDPA on the same tensors: a boolean band mask
    for a window; None for a softcap, which no PyTorch call computes),
    ``sdpa_uncapped`` (SDPA without the cap, the nearest library call)
    and ``few`` (time with fewer repeats: the long prefill)."""
    import torch

    sdpa = torch.nn.functional.scaled_dot_product_attention

    def rnd(shape, dtype, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=dev,
                                    dtype=torch.float32)).to(dtype)

    def band(s, window):  # SDPA's boolean mask: True where a key is seen
        qpos = torch.arange(s, device=dev)[:, None]
        kpos = torch.arange(s, device=dev)[None, :]
        return (qpos >= kpos) & (qpos - kpos < window)

    cases = []
    for dt, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        es = torch.empty((), dtype=dt).element_size()
        for s, w in [(M2_PROMPTS[0], M2_WINDOW)] + [
                (B6_SMALL_WINDOW + extra, B6_SMALL_WINDOW)
                for extra in (1, 65, 1025)]:
            q = rnd((1, 40, s, 128), dt)
            k, v = rnd((1, 8, s, 128), dt), rnd((1, 8, s, 128), dt)
            mask = band(s, w)
            cases.append(dict(
                name=f"windowed prefill {tag} q [1, 40, {s}, 128] k/v "
                     f"[1, 8, {s}, 128] causal window {w}",
                qkv=(q, k, v), kw=dict(causal=True, window=w),
                variant="window", few=s > 4096,
                # SDPA's masked float32 path holds [1, 40, S, S] scores:
                # 16.8 GB at 10,240 rows, so it is timed in bfloat16 only
                library=None if s > 4096 and es == 4 else (
                    lambda q=q, k=k, v=v, m=mask: sdpa(
                        q, k, v, attn_mask=m, enable_gqa=True)),
                sdpa_uncapped=None,
                cost=b6_cost(1, 40, 8, s, s, 128, True, es, window=w)))
        q = rnd((1, 40, 2048, 128), dt, B6_SOFTCAP_Q_SCALE)
        k, v = rnd((1, 8, 2048, 128), dt), rnd((1, 8, 2048, 128), dt)
        cases.append(dict(
            name=f"softcapped prefill {tag} q [1, 40, 2048, 128] (x "
                 f"{B6_SOFTCAP_Q_SCALE:g}) k/v [1, 8, 2048, 128] causal "
                 f"softcap {B6_SOFTCAP:g}",
            qkv=(q, k, v), kw=dict(causal=True, softcap=B6_SOFTCAP),
            variant="softcap", few=False, library=None,
            sdpa_uncapped=lambda q=q, k=k, v=v: sdpa(
                q, k, v, is_causal=True, enable_gqa=True),
            cost=b6_cost(1, 40, 8, 2048, 2048, 128, True, es)))
        q = rnd((LM_SLOTS, 40, 1, 128), dt, B6_SOFTCAP_Q_SCALE)
        k, v = (rnd((LM_SLOTS, 8, LM_MAX_LEN, 128), dt) for _ in range(2))
        cases.append(dict(
            name=f"softcapped decode {tag} q [{LM_SLOTS}, 40, 1, 128] (x "
                 f"{B6_SOFTCAP_Q_SCALE:g}) cache [{LM_SLOTS}, 8, "
                 f"{LM_MAX_LEN}, 128] kv_len 2049 softcap {B6_SOFTCAP:g}",
            qkv=(q, k, v),
            kw=dict(causal=False, kv_len=2049, softcap=B6_SOFTCAP),
            variant="softcap", few=False, library=None,
            sdpa_uncapped=lambda q=q, k=k, v=v: sdpa(
                q, k[:, :, :2049], v[:, :, :2049], enable_gqa=True),
            cost=b6_cost(LM_SLOTS, 40, 8, 1, 2049, 128, False, es)))
    return cases


def moe_model(arch: str, dtype: str, seed: int, device, **widths):
    """``arch`` at ``widths`` with random weights at the reference's
    scales from a ``torch.Generator`` seeded ``seed`` on ``device``."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.models import lm

    cfg = registry.get(arch).with_(dtype=dtype, **widths)
    gen = torch.Generator(device=device).manual_seed(seed)
    return cfg, lm.init_params(cfg, gen, device)


def attn_layers(cfg) -> int:
    """The model's attention layers (B6's callers); its other layers are
    Mamba, mLSTM or sLSTM, which launch no kernel."""
    return sum(cfg.layer_pattern[i % cfg.period].mixer == "attn"
               for i in range(cfg.num_layers))


def b6_calls(cfg) -> tuple:
    """B6's calls in one prefill and in one decode step: one per attention
    layer; an encoder-decoder's prefill also one per encoder layer, and
    each of its decoder layers one more (cross-attention) in both."""
    n = attn_layers(cfg)
    if cfg.encoder_layers:
        return cfg.encoder_layers + 2 * n, 2 * n
    return n, n


def lm_launches_want(cfg, prefills: int, ticks: int, prefill: str) -> dict:
    """B6's launches on an LM run: its ``prefill`` kernel once per call of
    each prefill, the decode's split and combine kernels once per call of
    each tick (``b6_calls``); no other kernel (none at all for an
    attention-free model)."""
    pre, dec = b6_calls(cfg)
    want = {f"{B6}.{prefill}": pre * prefills,
            f"{B6}.decode_split": dec * ticks,
            f"{B6}.decode_combine": dec * ticks}
    want[B6] = sum(want.values())
    return want


def check_lm_launches(label: str, launches: dict, want: dict) -> None:
    if any(n != want.get(name, 0) for name, n in launches.items()):
        fail(f"{label}: launches {launches}, want {want} and no other "
             "kernel")


def run_arm_m1(dev, reset, counts, cfgs=None, label: str = "M1",
               prompts=M1_PROMPTS, max_len: int = M1_MAX_LEN) -> dict:
    """Arm M1: moonshot and llama4 at their REDUCED widths (float32,
    head_dim 128; llama4's window 8) served on the card and on the CPU
    from the same weights: equal token streams and stats, prefill logits
    within ``F1_TOL``; B6's float32 kernels only. Prompts longer than the
    window, decoding past it. Arm R1 is the same check on ``cfgs`` (the
    recurrent archs) and its own ``prompts``."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.models import lm

    cpu = torch.device("cpu")
    cfgs = cfgs or {a: registry.get_reduced(a) for a in (M_ARCH, M2_ARCH)}
    rows = {}
    for arch, cfg in cfgs.items():
        p_cpu = lm.init_params(cfg, torch.Generator().manual_seed(1), cpu)
        p_dev = to_dev(p_cpu, dev)
        reqs_g = lm_requests(prompts, cfg.vocab_size, M1_MAX_NEW, 1)
        reset()
        st_g, wall_g, rec_g = serve_lm(cfg, p_dev, reqs_g, M1_SLOTS,
                                       max_len, dev)
        launches = counts()
        del p_dev
        reqs_c = lm_requests(prompts, cfg.vocab_size, M1_MAX_NEW, 1)
        st_c, wall_c, rec_c = serve_lm(cfg, p_cpu, reqs_c, M1_SLOTS,
                                       max_len, cpu)
        streams = [r.out for r in reqs_g]
        if st_g != st_c or streams != [r.out for r in reqs_c]:
            fail(f"{label} {arch}: card stats {st_g} streams {streams} vs "
                 f"CPU {st_c} {[r.out for r in reqs_c]}")
        check_lm_launches(f"{label} {arch}", launches, lm_launches_want(
            cfg, len(prompts), st_g["ticks"], "prefill_tile"))
        err = max(check_close(
            f"{label} {arch} request {i} prefill logits, card vs CPU "
            "(float32)", a.cpu(), b, F1_TOL)
            for i, (a, b) in enumerate(zip(rec_g["logits"],
                                           rec_c["logits"])))
        rows[arch] = {
            "widths": {k: getattr(cfg, k) for k in (
                "num_layers", "d_model", "num_heads", "num_kv_heads",
                "head_dim", "d_ff", "moe_d_ff", "moe_num_experts",
                "moe_top_k", "local_window", "mamba_d_state", "xlstm_heads",
                "vocab_size")},
            "dtype": cfg.dtype, "prompts": prompts, "slots": M1_SLOTS,
            "max_len": max_len, "max_new": M1_MAX_NEW, "stats": st_g,
            "streams": streams, "launches": launches,
            "max_abs_err_prefill_logits": err, "card_wall_s": wall_g,
            "cpu_wall_s": wall_c}
    return rows


def to_dev(tree, device):
    """A nested dict / list of tensors, copied to ``device``."""
    if isinstance(tree, dict):
        return {k: to_dev(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_dev(v, device) for v in tree]
    return tree.to(device)


def run_lm_serving_arm(label: str, cfg, params, prompts, slots: int,
                       max_len: int, max_new: int, dev, reset, counts,
                       profile=None, windowed_layers: int = 0,
                       profile_requests: int = 0,
                       profile_max_new: int = 0, controls=()) -> dict:
    """One LM serving arm at bfloat16, as arm F serves: cold (launches
    counted: B6's prefill kernel once per layer and request, its decode
    kernels once per layer and tick, nothing else), F2's check without
    its controls (every layer's B6 output against the plain version on
    the path's own q/k/v, each request's logits against its prefill with
    float64 attention on the same expert routing; ``windowed_layers`` of
    each prefill's calls must carry a window; each of F2's ``controls``
    in B6's place at the same limits, where a planted fault's logits
    alone must break them on every request), warm, then profiled (the
    first ``profile_requests`` requests, 0 = all, with
    ``profile_max_new`` new tokens, 0 = ``max_new``: the profiler's
    post-processing grows with the launches it holds). The prefill
    launches and F2 count the attention layers only; an attention-free
    model (no B6 call) skips F2. F2's logit limits are
    ``M_F2_LIMITS``."""
    import torch

    n_attn = attn_layers(cfg)
    fleet = lambda: lm_requests(prompts, cfg.vocab_size, max_new)
    part_s, clock = {}, [time.perf_counter()]

    def part(name):
        now = time.perf_counter()
        part_s[name], clock[0] = now - clock[0], now

    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset()
    cold = fleet()
    st_cold, wall_cold, rec_cold = serve_lm(cfg, params, cold, slots,
                                            max_len, dev)
    launches = counts()
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else None
    ticks = st_cold["ticks"]
    want = lm_launches_want(cfg, len(prompts), ticks, "prefill_mma")
    if rec_cold["decode_ticks"] != ticks:
        fail(f"arm {label}: {rec_cold['decode_ticks']} decode calls for "
             f"{ticks} ticks")
    check_lm_launches(f"arm {label}", launches, want)
    for r in cold:
        if len(r.out) != max_new or not r.done \
                or min(r.out) < 0 or max(r.out) >= cfg.vocab_size:
            fail(f"arm {label}: request {r.rid} produced {r.out}")
    for lg in rec_cold["logits"]:
        if lg.shape != (1, cfg.vocab_size) or not torch.isfinite(lg).all():
            fail(f"arm {label}: prefill logits not finite [1, vocab]")
    part("cold")
    f2 = [] if not n_attn else f2_check(
        cfg, params, cold, None, max_len, B6_BF16_TOL,
        served=rec_cold["logits"], limits=M_F2_LIMITS)
    part("check")
    for row in f2:
        print(f"arm {label} F2 {json.dumps(row)}")
    if not all(row["holds"] for row in f2):
        fail(f"arm {label}: B6's prefill attention or logits are further "
             "from the plain version or the float64 prefill than the "
             f"limits allow (rows {f2})")
    if any(row["layer_calls"] != n_attn
           or row["windowed_calls"] != windowed_layers for row in f2):
        calls = [(r["layer_calls"], r["windowed_calls"]) for r in f2]
        fail(f"arm {label}: {calls} B6 calls (windowed) a prefill, want "
             f"{n_attn} ({windowed_layers})")
    f2_controls = {}
    for kind in controls:
        f2_controls[kind] = f2_check(
            cfg, params, cold, None, max_len, B6_BF16_TOL,
            attend=functools.partial(attention_reference, acc="float32",
                                     fault=kind), limits=M_F2_LIMITS)
        for row in f2_controls[kind]:
            print(f"arm {label} F2 {kind} {json.dumps(row)}")
        seen = [r["rid"] for r in f2_controls[kind] if r["logits_ok"]]
        if kind in F2_FAULTS and seen:
            fail(f"arm {label}: F2's logit limits {M_F2_LIMITS} cannot see "
                 f"the planted fault {kind}: its logits held for {seen}")
    part("controls")
    warm = fleet()
    st_warm, wall_warm, rec_warm = serve_lm(cfg, params, warm, slots,
                                            max_len, dev)
    generated = sum(len(r.out) for r in warm)
    prefill_s = sum(rec_warm["prefill_s"])
    part("warm")
    profiled = prompts[:profile_requests or len(prompts)]
    prof = (None if profile is None else profile(
        lambda: serve_lm(cfg, params, lm_requests(
            profiled, cfg.vocab_size, profile_max_new or max_new), slots,
            max_len, dev)))
    part("profile")
    specs = [cfg.layer_pattern[i % cfg.period]
             for i in range(cfg.num_layers)]
    widths = [min(cfg.local_window, max_len) if spec.attn_kind == "local"
              else max_len for spec in specs if spec.mixer == "attn"]
    return {
        "params": sum(t.numel() for t in _tree_leaves(params)),
        "config_params": cfg.param_count(),
        "config_active_params": cfg.active_param_count(),
        "layers": cfg.num_layers, "attention_layers": n_attn,
        "experts": cfg.moe_num_experts,
        "window": cfg.local_window, "requests": len(prompts),
        "prompt_lengths": list(prompts), "max_new": max_new, "slots": slots,
        "max_len": max_len, "cache_widths": widths, "ticks": ticks,
        "tokens_computed": st_cold["tokens_computed"],
        "reuse_ratio": st_cold["reuse_ratio"], "launches": launches,
        "b6_launches_expected": want, "cold_wall_s": wall_cold,
        "warm_wall_s": wall_warm, "generated_tokens": generated,
        "generated_tok_per_s": generated / wall_warm,
        "prefill_prompt_tok_per_s": sum(prompts) / prefill_s,
        "prefill_s": rec_warm["prefill_s"], "ttft_s": rec_warm["ttft_s"],
        "decode_s_per_tick": (wall_warm - prefill_s) / st_warm["ticks"],
        "warm_streams_equal_cold": [r.out for r in warm]
        == [r.out for r in cold],
        "weight_bytes": _tree_bytes(params),
        "kv_cache_bytes": sum(2 * slots * cfg.num_kv_heads * w * cfg.head_dim
                              * 2 for w in widths),
        "max_memory_allocated": peak, "F2": f2,
        "F2_controls": f2_controls, "profile": prof,
        "profiled_prompts": list(profiled),
        "profiled_max_new": profile_max_new or max_new, "part_s": part_s}


def run_arms_m(dev, reset, counts, profile, *, m_widths=None,
               m2_widths=None, m1_cfgs=None, m_prompts=None,
               m2_prompts=None) -> dict:
    """Arms M1, M (moonshot at full width, ``M_LAYERS`` layers) and M2
    (llama4-maverick at full widths, one period of 4 layers,
    ``M2_EXPERTS`` experts); the ``*_widths`` and prompts shrink them for
    a rehearsal on the CPU."""
    import torch

    out = {f"M1 {a}": row for a, row in run_arm_m1(
        dev, reset, counts, m1_cfgs).items()}
    # M's profiled run: its first wave (4 requests) with 8 new tokens each;
    # M2 also runs M2_F2_CONTROLS through F2 at its limits
    arms = (("M", M_ARCH, m_widths or dict(num_layers=M_LAYERS),
             m_prompts or LM_PROMPTS, LM_SLOTS, LM_MAX_NEW, 0, LM_SLOTS, 8,
             ()),
            ("M2", M2_ARCH, m2_widths or dict(num_layers=4,
                                              moe_num_experts=M2_EXPERTS),
             m2_prompts or M2_PROMPTS, M2_SLOTS, M2_MAX_NEW, 3, 0, 0,
             M2_F2_CONTROLS))
    for (label, arch, widths, prompts, slots, max_new, windowed,
         profiled, profiled_new, controls) in arms:
        t0 = time.perf_counter()
        cfg, params = moe_model(arch, "bfloat16", 0, dev, **widths)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        max_len = max(prompts) + max_new + 4
        out[label] = dict(run_lm_serving_arm(
            label, cfg, params, prompts, slots, max_len, max_new, dev,
            reset, counts, profile, windowed_layers=windowed,
            profile_requests=profiled, profile_max_new=profiled_new,
            controls=controls),
            arch=arch, widths=widths, init_s=init_s)
        del params  # free the arm's weights before the next one
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


# arms R1, R and R2: the recurrent mixers through the LM ServeEngine (see
# the module docstring)
R_ARCH = "jamba-1.5-large-398b"
# one period (8 of 72 layers: 1 attention, 7 Mamba, 4 MoE) and 8 of its 16
# experts, top-2 kept: 25.80 B params by the reference's accounting, 51.6
# GB; all 16 experts would take 90.3 GB
R_WIDTHS = dict(num_layers=8, moe_num_experts=8)
# arm F's fleet with its 1,280-token prompt replaced by 1,000, not a
# multiple of the Mamba's 256-row chunk: that prefill runs as one chunk
R_PROMPTS = [2048, 1536, 1024, 512, 1792, 768, 1000, 256]
R2_ARCH = "xlstm-350m"  # all 24 layers, its published widths
# its shortest prompt first: the profiled run serves the first request,
# with 8 new tokens, since the sLSTM's prefill is a step loop (~20
# launches a token and layer; profiling all four with 32 new tokens, the
# profiler's post-processing took 57 s for 101,322 launches on an H100,
# and the first two (512 and 256 tokens) took 32.9 s)
R2_PROMPTS = [256, 512, 2048, 1000]
R2_SLOTS = 4
R2_MAX_NEW = 32
R2_PROFILED = 1
# R1: both archs' REDUCED configs (jamba's head_dim is the config's 128,
# which ``with_`` keeps), card against CPU: prompts over one chunk (256 /
# 128 rows) and not multiples of it; one train step on 2 x 512 tokens
R1_PROMPTS = [512, 300, 128, 40]
R1_TRAIN = dict(steps=1, batch=2, seq=512)
# R1's grad leaves, card against CPU, at L1's rule (rtol L_GRAD_RTOL + atol
# L_GRAD_ATOL_OF_MAX x each leaf's largest), but the leaves that the
# mLSTM layers' backward pass reaches (every mLSTM leaf and the tied
# embedding), at this atol: there the float64 gradient of R1's xlstm step
# itself moves by up to 2.4e-4 of a leaf's largest when every param moves
# by one float32 ulp, and the card's grads sit up to 3.5e-4 from it
# (``f64_band`` and ``card_vs_f64`` of the readings; PERF.md section 6)
R1_ATOL_OF_MAX = {"mlstm": 1e-3, (None, "embed"): 1e-3}
# the relative move of every parameter (one float32 ulp, times a standard
# normal draw) that ``f64_band`` reads the float64 gradient under
F32_ULP = 2.0**-23
# the full-width mixer checks: one layer of each kind in float32 on the
# first 256 positions of its own input, card against CPU and chunked
# against the step recurrence, within 1e-4 x the largest magnitude
R_MIXER_TOKENS = 256
R_MIXER_TOL = 1e-4


def _rel_err(got, want) -> float:
    """max |got - want| over the largest |want|."""
    want = want.to(got.device).float()
    return float((got.float() - want).abs().max()) / max(
        float(want.abs().max()), 1e-30)


def mixer_checks(cfg, params, prompt, kinds, dev,
                 tokens: int = R_MIXER_TOKENS) -> dict:
    """Each recurrent mixer kind of ``kinds`` ("mamba", "mlstm", "slstm")
    at full width: its first layer's parameters in float32, on the first
    ``tokens`` positions of that layer's own input in a prefill of
    ``prompt`` (captured by a spy). The card's output and final state
    within ``R_MIXER_TOL`` x their largest magnitude of the port's CPU run
    of the same layer; on the card, the chunked form (Mamba at its
    256-row chunk and at 64, mLSTM at 128) against the step recurrence
    (``mamba_decode`` token by token, ``mlstm_scan``) to the same bound.
    The reference's ``test_mamba_chunk_size_invariance_and_decode`` and
    ``test_mlstm_chunked_equals_scan``, at full width. Returns the
    readings per kind."""
    import numpy as np
    import torch
    from repro_torch.models import lm
    from repro_torch.models import mamba as mamba_mod
    from repro_torch.models import xlstm as xlstm_mod

    where = {"mamba": (mamba_mod, "mamba_chunked"),
             "mlstm": (xlstm_mod, "mlstm_chunked"),
             "slstm": (xlstm_mod, "slstm_scan")}
    real = {k: getattr(*where[k]) for k in kinds}
    seen = {}

    def spy(kind):
        def fn(p, x, c, *args, **kw):
            if kind not in seen:
                seen[kind] = (p, x[:, :tokens].clone())
            return real[kind](p, x, c, *args, **kw)
        return fn

    tokens_t = torch.as_tensor(np.asarray(prompt, np.int64)[None],
                               device=dev)
    for k in kinds:
        setattr(*where[k], spy(k))
    try:
        lm.make_prefill_step(cfg, len(prompt))(params, {"tokens": tokens_t})
    finally:
        for k in kinds:
            setattr(*where[k], real[k])
    cfg32 = cfg.with_(dtype="float32")
    cpu = torch.device("cpu")
    rows = {}
    for kind in kinds:
        p, x = seen[kind]
        p32 = {n: t.float() for n, t in p.items()}
        x32 = x.float()
        out, st = real[kind](p32, x32, cfg32)
        out_c, st_c = real[kind](to_dev(p32, cpu), x32.cpu(), cfg32)
        errs = {"vs_cpu": [_rel_err(a, b) for a, b in
                           zip((out, *st), (out_c, *st_c))]}
        if kind == "mamba":
            out64, st64 = mamba_mod.mamba_chunked(p32, x32, cfg32, chunk=64)
            step = mamba_mod.mamba_state_init(cfg32, 1, torch.float32, dev)
            ys = []
            for t in range(x32.shape[1]):
                y, step = mamba_mod.mamba_decode(p32, x32[:, t:t + 1], cfg32,
                                                 step)
                ys.append(y)
            errs["chunk_64_vs_256"] = [_rel_err(a, b) for a, b in
                                       zip((out64, *st64), (out, *st))]
            errs["steps_vs_chunked"] = [_rel_err(a, b) for a, b in zip(
                (torch.cat(ys, dim=1), *step), (out, *st))]
        elif kind == "mlstm":
            out_s, st_s = xlstm_mod.mlstm_scan(p32, x32, cfg32)
            errs["scan_vs_chunked"] = [_rel_err(a, b) for a, b in
                                       zip((out_s, *st_s), (out, *st))]
        worst = max(max(v) for v in errs.values())
        if not worst <= R_MIXER_TOL:
            fail(f"{kind} at full width ({tuple(x.shape)}): {errs}, over "
                 f"{R_MIXER_TOL} of the largest magnitude")
        rows[kind] = {"input": list(x.shape), "params": sum(
            t.numel() for t in p32.values()),
            "rel_err_out_and_state": errs, "worst": worst}
        del p32, out_c, st_c
    return rows


def run_arms_r(dev, reset, counts, profile, *, r_widths=None,
               r2_widths=None, r1_cfgs=None, r_prompts=None,
               r2_prompts=None, r1_prompts=None, r1_train=None, mixer_tokens: int = R_MIXER_TOKENS) -> dict:
    """Arms R1 (both recurrent archs at REDUCED widths, card against CPU:
    served, then one train step), R (jamba-1.5-large at full widths, one
    period, ``R_WIDTHS``) and R2 (xlstm-350m, full width and depth), each
    with its full-width mixer checks; the keywords shrink them for a
    rehearsal on the CPU."""
    import torch
    from repro_torch.configs import registry

    r1_cfgs = r1_cfgs or {a: registry.get_reduced(a)
                          for a in (R_ARCH, R2_ARCH)}
    r1_prompts = r1_prompts or R1_PROMPTS
    out = {f"R1 {a}": row for a, row in run_arm_m1(
        dev, reset, counts, r1_cfgs, "R1", r1_prompts,
        max(r1_prompts) + M1_MAX_NEW + 4).items()}
    for a, cfg in r1_cfgs.items():
        t0 = time.perf_counter()
        reset()
        row = out[f"R1 {a}"]
        row["train_steps"] = l1_check_steps(
            cfg, dev, leaf_atol_of_max=R1_ATOL_OF_MAX, float64=True,
            **(r1_train or R1_TRAIN))
        row["train_launches"] = counts()
        check_lm_launches(f"R1 {a} training", row["train_launches"], {})
        row["train_s"] = time.perf_counter() - t0
    # R also runs M2's controls of F2 at the same limits
    arms = (("R", R_ARCH, r_widths or R_WIDTHS, r_prompts or R_PROMPTS,
             LM_SLOTS, LM_MAX_NEW, LM_SLOTS, 8, M2_F2_CONTROLS, ("mamba",)),
            ("R2", R2_ARCH, r2_widths or {}, r2_prompts or R2_PROMPTS,
             R2_SLOTS, R2_MAX_NEW, R2_PROFILED, 8, (), ("mlstm", "slstm")))
    for (label, arch, widths, prompts, slots, max_new, profiled,
         profiled_new, controls, kinds) in arms:
        t0 = time.perf_counter()
        cfg, params = moe_model(arch, "bfloat16", 0, dev, **widths)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        max_len = max(prompts) + max_new + 4
        out[label] = dict(run_lm_serving_arm(
            label, cfg, params, prompts, slots, max_len, max_new, dev,
            reset, counts, profile, profile_requests=profiled,
            profile_max_new=profiled_new, controls=controls),
            arch=arch, widths=widths, init_s=init_s)
        t0 = time.perf_counter()
        out[label]["mixer_checks"] = mixer_checks(
            cfg, params, lm_requests(prompts, cfg.vocab_size, max_new)[0]
            .prompt, kinds, dev, mixer_tokens)
        out[label]["part_s"]["mixer_checks"] = time.perf_counter() - t0
        del params  # free the arm's weights before the next one
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


# arms W1, W, V1 and V: the encoder-decoder (whisper-small) and the VLM
# (internvl2-1b) through the prefill and decode steps (see the module
# docstring). W: a batch of 4 utterances of 1,500 stub frames (30 s of
# audio; in the model's dtype, as the reference's dry-run specs them),
# decoder prompts of 192 tokens, 32 greedy tokens (the prefill's and 31
# decode ticks) in whisper's 448-token text context
W_ARCH = "whisper-small"
W_SHAPE = dict(batch=4, prompt=192, max_new=32, cache_len=448)
W_PROFILED_TICKS = 4  # 8 until phase Q joined the script
# W1: whisper-reduced (float32, head_dim 64), card against CPU
W1_SHAPE = dict(batch=2, prompt=24, max_new=8, cache_len=40)
W1_TRAIN = dict(steps=1, batch=2, seq=24)
# W1 bf16: whisper-reduced in bfloat16 over whisper-small's 1,500 frames,
# the frames in float32 as ``make_batch`` gives them and the Trainer's
# batches carry them. The encoder then runs in float32 (the reference's
# promotion of float32 frames against bfloat16 weights), the cross K/V
# stay float32, and B6 takes the encoder's and the cross-attention's
# calls in float32 and the decoder's self-attention in bfloat16. Card
# against CPU, the CPU fed the card's tokens: every step's logits within
# W1_BF16_TOL (4 bfloat16 steps at logits of 2-4), and at every step the
# card's token within its atol of the CPU's best logit (a near-tie may
# fall either way on another device's bfloat16 rounding)
W1_BF16_ENC_SEQ = 1500
W1_BF16_TOL = dict(atol=6e-2, rtol=2e-2)
# V: 4 requests of 256 stub patch embeddings + 256 tokens, 32 greedy
# tokens; then arm F's fleet through the ServeEngine, text-only, F2 at the
# serving arms' 2x limits with M2's two controls, as arm R runs it: at 24
# bfloat16 layers the path's P.V in bfloat16 read 1.25x the plain
# version's RMS distance on the 2,048-token prompt (over F's 1.25x;
# PERF.md section 6)
V_ARCH = "internvl2-1b"
V_SHAPE = dict(batch=4, prompt=256, max_new=32, cache_len=256 + 256 + 32)
# V1: internvl at full widths, 2 of its 24 layers, float32 (REDUCED's
# head_dim 14 is not one B6 takes), card against CPU
V1_LAYERS = 2
V1_SHAPE = dict(batch=2, prompt=64, max_new=8, cache_len=256 + 64 + 8)
V1_TRAIN = dict(steps=1, batch=2, seq=64)


def stub_batch(cfg, batch: int, prompt: int, dev, embeds_dtype=None,
               seed: int = 0) -> dict:
    """The synthetic pipeline's batch at the config's widths: tokens
    [batch, prompt] and the config's frame or patch embedding stubs (cast
    to ``embeds_dtype`` where given), on ``dev``; no targets."""
    import torch
    from repro_torch.data.pipeline import DataConfig, make_batch

    out = make_batch(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=prompt, global_batch=batch,
        seed=seed, enc_seq_len=cfg.enc_seq_len,
        num_image_tokens=cfg.num_image_tokens, d_model=cfg.d_model), 0)
    out = {k: torch.from_numpy(v).to(dev) for k, v in out.items()
           if k != "targets"}
    for k in ("frame_embeds", "image_embeds"):
        if k in out and embeds_dtype is not None:
            out[k] = out[k].to(embeds_dtype)
    return out


def lm_generate(cfg, params, batch, cache_len: int, max_new: int,
                forced=None) -> dict:
    """Greedy generation through ``lm.make_prefill_step`` and
    ``make_decode_step`` (the reference's entry points for these
    families): the prefill's argmax, then ``max_new - 1`` decode ticks
    from index P + S (P the image prefix's length), every token kept on
    the device and read once at the end; ``forced`` [B, max_new]: these
    tokens are fed instead of the argmax. Returns the streams [B,
    max_new] (the tokens fed), the prefill's logits, every step's logits
    (``step_logits``: the prefill's, then each tick's), the caches and
    the synchronized seconds of the prefill and of the decode ticks."""
    import torch
    from repro_torch.models import lm

    cuda = params["embed"].device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    prefill = lm.make_prefill_step(cfg, cache_len)
    decode = lm.make_decode_step(cfg)
    sync()
    t0 = time.perf_counter()
    pick = (lambda i, lg: torch.argmax(lg, -1)[:, None]) if forced is None \
        else (lambda i, lg: forced[:, i:i + 1].to(lg.device))
    logits, caches = prefill(params, batch)
    first = logits.clone()
    steps = [first]
    tok = pick(0, logits)
    sync()
    t1 = time.perf_counter()
    index = batch["tokens"].shape[1] + (
        batch["image_embeds"].shape[1]
        if cfg.num_image_tokens and "image_embeds" in batch else 0)
    out = [tok]
    for i in range(max_new - 1):
        logits, caches = decode(params, caches, tok, index + i)
        steps.append(logits)
        tok = pick(i + 1, logits)
        out.append(tok)
    streams = torch.cat(out, 1).cpu()
    t2 = time.perf_counter()
    return {"streams": streams, "prefill_logits": first,
            "step_logits": steps, "caches": caches,
            "prefill_s": t1 - t0, "decode_s": t2 - t1,
            "ticks": max_new - 1}


def f2_batch_check(cfg, params, batch, cache_len: int, tol: dict,
                   attend=None) -> list:
    """F2 (``f2_check``) for a batched prefill of the step functions:
    every B6 call of the prefill (the encoder's, the decoder's causal
    self-attention, its cross-attention) held against the plain version
    on its own q/k/v within ``tol``, and each batch row's logits no
    further from the same prefill with float64 attention than
    ``F_F2_LIMITS`` x the plain version's max and RMS distance. ``attend``
    replaces B6 (one of F2's controls). Returns one row per batch row."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import lm

    spy, layer = _b6_spy(fa.flash_attention if attend is None else attend,
                         tol)

    def prefill(fn):
        real = fa.flash_attention
        fa.flash_attention = fn
        try:
            return lm.make_prefill_step(cfg, cache_len)(params, batch)[0]
        finally:
            fa.flash_attention = real

    got = prefill(spy)
    ref = {name: prefill(fn) for name, fn in (("plain", plain_attention),
                                              ("f64", attention_reference))}
    rows = []
    for i in range(got.shape[0]):
        within = _logits_within(got[i], ref["plain"][i], ref["f64"][i],
                                F_F2_LIMITS)
        rows.append({
            "row": i, "layers_max_abs_err": layer["err"],
            "layers_ok": layer["ok"], "b6_calls": layer["calls"],
            "non_causal_calls": layer["non_causal"],
            "float32_calls": layer["float32"],
            "gqa_groups": sorted(layer["groups"]), **within,
            "holds": layer["ok"] and within["logits_ok"]})
    return rows


def promoted_launches_want(cfg, ticks: int) -> dict:
    """B6's launches on one greedy run of an encoder-decoder in bfloat16
    over float32 frames: the encoder's and the cross-attention's prefill
    calls on the float32 tile prefill, the decoder's self-attention on the
    tensor-core prefill, the decode kernels as ``lm_launches_want``."""
    want = lm_launches_want(cfg, 1, ticks, "prefill_mma")
    want[f"{B6}.prefill_mma"] = attn_layers(cfg)
    want[f"{B6}.prefill_tile"] = cfg.encoder_layers + attn_layers(cfg)
    return want


def check_promoted_caches(label: str, cfg, caches) -> None:
    """Over float32 frames: every decoder layer's cross K/V in float32,
    its self K/V in the model's dtype."""
    import torch

    own_dt = getattr(torch, cfg.dtype)
    dtypes = [(own.k.dtype, own.v.dtype, cross.k.dtype, cross.v.dtype)
              for own, cross in caches]
    if any(d != (own_dt, own_dt, torch.float32, torch.float32)
           for d in dtypes):
        fail(f"{label}: cache dtypes (self k, v, cross k, v) {dtypes}")


def run_promoted_check(label: str, cfg, dev, reset, counts,
                       shape: dict) -> dict:
    """W1 bf16 (see ``W1_BF16_TOL``): ``cfg`` greedy on the card over
    float32 stub frames, then the same steps on the CPU fed the card's
    tokens, and the CPU's own greedy stream (recorded); launches as
    ``promoted_launches_want``, the cross K/V float32 on both devices."""
    import torch
    from repro_torch.models import lm

    cpu = torch.device("cpu")
    p_cpu = lm.init_params(cfg, torch.Generator().manual_seed(1), cpu)
    p_dev = to_dev(p_cpu, dev)
    b_cpu = stub_batch(cfg, shape["batch"], shape["prompt"], cpu, seed=1)
    run = lambda p, b, forced=None: lm_generate(
        cfg, p, b, shape["cache_len"], shape["max_new"], forced=forced)
    reset()
    g = run(p_dev, to_dev(b_cpu, dev))
    launches = counts()
    del p_dev
    check_lm_launches(label, launches, promoted_launches_want(
        cfg, g["ticks"]))
    c = run(p_cpu, b_cpu, forced=g["streams"])
    for side, r in (("card", g), ("CPU", c)):
        check_promoted_caches(f"{label} {side}", cfg, r["caches"])
    errs, below_best = [], []
    for t, (lg, lc) in enumerate(zip(g["step_logits"], c["step_logits"])):
        errs.append(check_close(f"{label} step {t} logits, card vs CPU",
                                lg.cpu(), lc, W1_BF16_TOL))
        picked = lc.gather(-1, g["streams"][:, t:t + 1].long())[:, 0]
        below_best.append(float((lc.max(-1).values - picked).max()))
    if max(below_best) > W1_BF16_TOL["atol"]:
        fail(f"{label}: the card's tokens sit {below_best} below the CPU's "
             f"best logit, more than {W1_BF16_TOL['atol']}")
    own = run(p_cpu, b_cpu)["streams"]
    return {"widths": {k: getattr(cfg, k) for k in (
        "num_layers", "encoder_layers", "enc_seq_len", "d_model",
        "num_heads", "head_dim", "vocab_size")}, "dtype": cfg.dtype,
        "frames_dtype": "float32", **shape,
        "streams": g["streams"].tolist(), "launches": launches,
        "max_abs_err_step_logits": errs,
        "card_token_below_cpu_best": below_best,
        "cpu_own_streams_equal": bool(torch.equal(own, g["streams"]))}


def run_step_check(label: str, cfg, dev, reset, counts, shape: dict,
                   train: dict) -> dict:
    """W1 / V1: ``cfg`` (float32) greedy through the step functions on the
    card and on the CPU from the same weights and stub batch: equal
    streams, prefill logits within ``F1_TOL``, B6's float32 kernels
    launched as ``lm_launches_want`` says; then ``train`` steps of
    ``l1_check_steps`` (L1's rule) on batches with the stubs, which launch
    no kernel."""
    import torch
    from repro_torch.models import lm

    cpu = torch.device("cpu")
    p_cpu = lm.init_params(cfg, torch.Generator().manual_seed(1), cpu)
    p_dev = to_dev(p_cpu, dev)
    b_cpu = stub_batch(cfg, shape["batch"], shape["prompt"], cpu, seed=1)
    run = lambda p, b: lm_generate(cfg, p, b, shape["cache_len"],
                                   shape["max_new"])
    reset()
    g = run(p_dev, to_dev(b_cpu, dev))
    launches = counts()
    del p_dev
    c = run(p_cpu, b_cpu)
    if not torch.equal(g["streams"], c["streams"]):
        fail(f"{label}: card streams {g['streams'].tolist()} vs CPU "
             f"{c['streams'].tolist()}")
    err = check_close(f"{label} prefill logits, card vs CPU (float32)",
                      g["prefill_logits"].cpu(), c["prefill_logits"],
                      F1_TOL)
    check_lm_launches(label, launches, lm_launches_want(
        cfg, 1, g["ticks"], "prefill_tile"))
    t0 = time.perf_counter()
    reset()
    steps = l1_check_steps(cfg, dev, **train)
    train_launches = counts()
    check_lm_launches(f"{label} training", train_launches, {})
    return {"widths": {k: getattr(cfg, k) for k in (
        "num_layers", "encoder_layers", "enc_seq_len", "num_image_tokens",
        "d_model", "num_heads", "num_kv_heads", "head_dim", "d_ff",
        "vocab_size")}, "dtype": cfg.dtype, **shape,
        "streams": g["streams"].tolist(), "launches": launches,
        "max_abs_err_prefill_logits": err, "card_wall_s": g["prefill_s"]
        + g["decode_s"], "cpu_wall_s": c["prefill_s"] + c["decode_s"],
        "train": train, "train_steps": steps,
        "train_launches": train_launches,
        "train_s": time.perf_counter() - t0}


def run_step_arm(label: str, cfg, params, batch, shape: dict, dev, reset,
                 counts, profile, controls=(), frames32=None) -> dict:
    """W / V part 1 at bfloat16 through the step functions: cold
    (launches counted, ``lm_launches_want`` with the tensor-core
    prefill), ``f2_batch_check`` at arm F's limits (every B6 call of the
    prefill, each batch row's logits), each of ``controls`` (planted
    faults) in B6's place, whose logits must break the limits on every
    row; ``frames32`` (W: the batch with its frames in float32, as the
    Trainer's batches carry them): cold (launches as
    ``promoted_launches_want``, the cross K/V float32), warm (timed) and
    ``f2_batch_check`` (the float32 calls within ``ATTN_F32_TOL``); then
    warm (timed; with ``frames32`` the encoder alone too), then profiled
    over the prefill and its first ``W_PROFILED_TICKS`` ticks."""
    import torch
    from repro_torch.models import lm

    part_s, clock = {}, [time.perf_counter()]

    def part(name):
        now = time.perf_counter()
        part_s[name], clock[0] = now - clock[0], now

    run = lambda max_new: lm_generate(cfg, params, batch, shape["cache_len"],
                                      max_new)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset()
    cold = run(shape["max_new"])
    launches = counts()
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else None
    want = lm_launches_want(cfg, 1, cold["ticks"], "prefill_mma")
    check_lm_launches(f"arm {label}", launches, want)
    streams, logits = cold["streams"], cold["prefill_logits"]
    if streams.shape != (shape["batch"], shape["max_new"]) \
            or int(streams.min()) < 0 \
            or int(streams.max()) >= cfg.vocab_size:
        fail(f"arm {label}: streams {streams.tolist()}")
    if logits.shape != (shape["batch"], cfg.vocab_size) \
            or not torch.isfinite(logits).all():
        fail(f"arm {label}: prefill logits not finite [B, vocab]")
    part("cold")
    f2 = f2_batch_check(cfg, params, batch, shape["cache_len"], B6_BF16_TOL)
    for row in f2:
        print(f"arm {label} F2 {json.dumps(row)}")
    pre_calls = b6_calls(cfg)[0]
    if not all(r["holds"] and r["b6_calls"] == pre_calls for r in f2):
        fail(f"arm {label}: B6's prefill attention or logits are further "
             "from the plain version or the float64 prefill than F's "
             f"limits allow, or not {pre_calls} B6 calls (rows {f2})")
    part("check")
    f2_controls = {}
    for kind in controls:
        f2_controls[kind] = f2_batch_check(
            cfg, params, batch, shape["cache_len"], B6_BF16_TOL,
            attend=functools.partial(attention_reference, acc="float32",
                                     fault=kind))
        for row in f2_controls[kind]:
            print(f"arm {label} F2 {kind} {json.dumps(row)}")
        seen = [r["row"] for r in f2_controls[kind] if r["logits_ok"]]
        if seen:
            fail(f"arm {label}: F2's logit limits cannot see the planted "
                 f"fault {kind}: its logits held for rows {seen}")
    part("controls")
    promoted = None
    if frames32 is not None:
        name = f"arm {label} float32 frames"
        run32 = lambda: lm_generate(cfg, params, frames32,
                                    shape["cache_len"], shape["max_new"])
        reset()
        cold32 = run32()
        launches32 = counts()
        check_lm_launches(name, launches32,
                          promoted_launches_want(cfg, cold32["ticks"]))
        check_promoted_caches(name, cfg, cold32["caches"])
        del cold32["caches"]
        warm32 = run32()
        del warm32["caches"]
        f2_32 = f2_batch_check(cfg, params, frames32, shape["cache_len"],
                               B6_BF16_TOL)
        for row in f2_32:
            print(f"{name} F2 {json.dumps(row)}")
        n32 = cfg.encoder_layers + attn_layers(cfg)
        if not all(r["holds"] and r["b6_calls"] == pre_calls
                   and r["float32_calls"] == n32 for r in f2_32):
            fail(f"{name}: B6's prefill attention or logits are further "
                 "from the plain version or the float64 prefill than F's "
                 f"limits allow, or not {pre_calls} B6 calls of which "
                 f"{n32} float32 (rows {f2_32})")
        promoted = {
            "launches": launches32, "F2": f2_32,
            "prefill_s": warm32["prefill_s"],
            "decode_s_per_tick": warm32["decode_s"] / warm32["ticks"],
            "streams_equal_bf16_frames": bool(torch.equal(
                cold32["streams"], streams))}
        part("float32 frames")
    warm = run(shape["max_new"])
    enc_s = None
    if frames32 is not None:
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        lm.encode_prefill(params, batch["frame_embeds"], cfg)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        enc_s = time.perf_counter() - t0
    generated = warm["streams"].numel()
    part("warm")
    prof = None if profile is None else profile(
        lambda: run(W_PROFILED_TICKS + 1))
    part("profile")
    return {
        "params": sum(t.numel() for t in _tree_leaves(params)),
        "config_params": cfg.param_count(),
        "weight_bytes": _tree_bytes(params), **shape,
        "enc_seq_len": cfg.enc_seq_len,
        "image_tokens": (batch["image_embeds"].shape[1]
                         if "image_embeds" in batch else 0),
        "launches": launches, "b6_launches_expected": want,
        "b6_calls_prefill_tick": list(b6_calls(cfg)),
        "cold_wall_s": cold["prefill_s"] + cold["decode_s"],
        "warm_wall_s": warm["prefill_s"] + warm["decode_s"],
        "encoder_s": enc_s, "prefill_s": warm["prefill_s"],
        "decode_s_per_tick": warm["decode_s"] / warm["ticks"],
        "ticks": warm["ticks"], "generated_tokens": generated,
        "generated_tok_per_s": generated / (warm["prefill_s"]
                                            + warm["decode_s"]),
        "warm_streams_equal_cold": bool(torch.equal(warm["streams"],
                                                    streams)),
        "max_memory_allocated": peak, "F2": f2,
        "F2_controls": f2_controls, "float32_frames": promoted,
        "profile": prof, "profiled_ticks": W_PROFILED_TICKS,
        "part_s": part_s}


def run_arms_wv(dev, reset, counts, profile, *, w1_cfg=None, v1_cfg=None,
                w_widths=None, v_widths=None, w_shape=None, v_shape=None,
                w1_shape=None, v1_shape=None, w1_train=None, v1_train=None,
                v_prompts=None, w1_bf16_enc_seq=None) -> dict:
    """Arms W1, W (whisper-small at full width and depth), V1 and V
    (internvl2-1b at full width and depth, then its text-only fleet
    through the ServeEngine); the keywords shrink them for a rehearsal on
    the CPU."""
    import torch
    from repro_torch.configs import registry

    out = {}
    w1_cfg = w1_cfg or registry.get_reduced(W_ARCH)
    out["W1"] = run_step_check("W1", w1_cfg, dev, reset, counts,
                               w1_shape or W1_SHAPE, w1_train or W1_TRAIN)
    out["W1 bf16"] = run_promoted_check(
        "W1 bf16", w1_cfg.with_(dtype="bfloat16",
                                enc_seq_len=w1_bf16_enc_seq
                                or W1_BF16_ENC_SEQ),
        dev, reset, counts, w1_shape or W1_SHAPE)
    v1_cfg = v1_cfg or registry.get(V_ARCH).with_(num_layers=V1_LAYERS,
                                                  dtype="float32")
    out["V1"] = run_step_check("V1", v1_cfg, dev, reset, counts,
                               v1_shape or V1_SHAPE, v1_train or V1_TRAIN)
    # V1's ServeEngine check: F1's fleet, text-only, card against CPU
    v1_prompts = v_prompts[:len(F1_PROMPTS)] if v_prompts else F1_PROMPTS
    out["V1 serve"] = run_arm_m1(dev, reset, counts, {V_ARCH: v1_cfg},
                                 "V1 serve", v1_prompts,
                                 max(v1_prompts) + M1_MAX_NEW + 4)[V_ARCH]
    for label, arch, widths, shape, controls in (
            ("W", W_ARCH, w_widths or {}, w_shape or W_SHAPE, (TAIL_FAULT,)),
            ("V", V_ARCH, v_widths or {}, v_shape or V_SHAPE,
             ("diag_tile_dropped",))):
        t0 = time.perf_counter()
        cfg, params = moe_model(arch, "bfloat16", 0, dev, **widths)
        batch = stub_batch(cfg, shape["batch"], shape["prompt"], dev,
                           embeds_dtype=torch.bfloat16)
        frames32 = (stub_batch(cfg, shape["batch"], shape["prompt"], dev)
                    if label == "W" else None)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        out[label] = dict(run_step_arm(
            label, cfg, params, batch, shape, dev, reset, counts, profile,
            controls=controls, frames32=frames32),
            arch=arch, widths=widths, init_s=init_s)
        if label == "V":  # part 2: arm F's fleet, text-only
            prompts = v_prompts or LM_PROMPTS
            t0 = time.perf_counter()
            out["V serve"] = dict(run_lm_serving_arm(
                "V serve", cfg, params, prompts, LM_SLOTS,
                max(prompts) + LM_MAX_NEW + 4, LM_MAX_NEW, dev, reset,
                counts, profile, profile_requests=LM_SLOTS,
                profile_max_new=W_PROFILED_TICKS,
                controls=M2_F2_CONTROLS), arch=arch, widths=widths,
                serve_s=time.perf_counter() - t0)
        del params, batch, frames32  # free the arm's weights
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


# phase L: LM training (see the module docstring). L1 and L3 train the
# ~100M config of the reference's example (examples/train_lm.py: the
# minitron-4b layout at 8 layers, d 768, 12 heads, kv 4, d_ff 3,072,
# vocab 16,384, float32) on its batch of 8 x 128 with its schedule (base lr
# 1e-3, warmup 20) and the Trainer's clip (1.0)
L_ARCH = "minitron-4b"
L1_WIDTHS = dict(num_layers=8, d_model=768, num_heads=12, num_kv_heads=4,
                 d_ff=3072, vocab_size=16384, dtype="float32")
L1_BATCH, L1_SEQ, L1_CHECK_STEPS = 8, 128, 3
L_SCHEDULE = dict(base_lr=1e-3, warmup=20, total_steps=60)
L_GRAD_CLIP = 1.0
# phase T's tolerances: float32 sums in another order; the embedding's
# gradient accumulates its duplicate tokens in another order on the card
L_LOSS_RTOL = 1e-5
L_GRAD_RTOL, L_GRAD_ATOL_OF_MAX = 1e-3, 1e-4
L_ADAM_TOL = dict(rtol=1e-5, atol=1e-7)
# L2: minitron-4b at its published widths, 8 of its 32 layers, bfloat16,
# batch 1 x 4,096 (train_4k's sequence; its global batch 256 cut to 1)
L2_LAYERS, L2_BATCH, L2_SEQ, L2_STEPS = 8, 1, 4096, 10
# L3: the Trainer, one fault injected, then 40 straight steps against 20 +
# a fresh Trainer resuming for 20 more: the final losses within rtol 1e-3
# (the card's float32 sums need not repeat bit for bit, and AdamW's
# m / sqrt(v) amplifies a last-bit difference where a moment is tiny)
L3_STEPS, L3_CKPT_EVERY, L3_FAULT_AT = 60, 20, 30
L3_RESUME_STEPS = 20
L3_RESUME_RTOL = 1e-3


def l_config(widths=None):
    """The example's ~100M config: ``L_ARCH``'s REDUCED at ``widths``
    (default ``L1_WIDTHS``), as ``examples/train_lm.py`` builds it."""
    from repro_torch.configs import registry

    return registry.get_reduced(L_ARCH).with_(name=f"{L_ARCH}-100m",
                                              **(widths or L1_WIDTHS))


def _tree_leaves(tree):
    from repro_torch.optim.adamw import tree_flatten

    return tree_flatten(tree)[0]


# the leaf whose gradient is 0 in exact arithmetic: an sLSTM layer's
# input-gate bias (a shift of every input gate moves the stabilizer ``m``
# with it and changes nothing downstream)
EXACT_ZERO_GRADS = {("slstm", "mixer/bi")}


def _leaf_paths(tree, prefix=()) -> list:
    """Each leaf's path of keys, in ``tree_flatten``'s order (dict keys
    sorted)."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _leaf_paths(tree[k],
                                                             (*prefix, k))]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in _leaf_paths(v, (*prefix, i))]
    return [prefix]


def leaf_kinds(cfg, params) -> list:
    """Each LM param leaf as (its layer's mixer or None, its path below the
    layer, e.g. "mixer/wf"), in ``tree_flatten``'s order."""
    return [(cfg.layer_pattern[p[1] % cfg.period].mixer,
             "/".join(map(str, p[2:]))) if p[0] == "layers"
            else (None, "/".join(map(str, p))) for p in _leaf_paths(params)]


def _perturbed(tree, rel: float, seed: int):
    """``tree``'s leaves in float64, each element times (1 + ``rel`` x a
    standard normal draw from a CPU generator seeded ``seed``)."""
    import torch
    from repro_torch.optim.adamw import tree_flatten

    gen = torch.Generator().manual_seed(seed)
    leaves, unflatten = tree_flatten(tree)
    return unflatten([t.detach().cpu().double() * (1 + rel * torch.randn(
        t.shape, generator=gen, dtype=torch.float64)) for t in leaves])


def float64_loss_and_grads(params, batch, cfg):
    """``lm.loss_and_grads`` in float64 on the CPU: the exact arithmetic
    that a float32 step is read against. The params are cast to float64,
    and every float32 the model asks for (``.float()``, a float32
    ``dtype``, ``cfg.dtype``) is given as float64 by a
    ``TorchFunctionMode``; the chunks and periods that autograd would
    recompute run straight (``checkpoint`` changes memory only, and its
    recompute in the backward pass would run outside the mode)."""
    from unittest import mock

    import torch
    from torch.overrides import TorchFunctionMode
    from repro_torch.models import blocks, lm
    from repro_torch.models import mamba as mamba_mod
    from repro_torch.models import xlstm as xlstm_mod
    from repro_torch.optim.adamw import tree_flatten

    f32, f64 = torch.float32, torch.float64

    class Float64(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = dict(kwargs or {})
            if func is torch.Tensor.float:
                return args[0].double()
            if kwargs.get("dtype") is f32:
                kwargs["dtype"] = f64
            return func(*(f64 if a is f32 else a for a in args), **kwargs)

    leaves, unflatten = tree_flatten(params)
    p64 = unflatten([t.detach().cpu().double() for t in leaves])
    straight = lambda fn, *args, use_reentrant=None: fn(*args)
    with mock.patch.object(blocks, "checkpoint", straight), \
            mock.patch.object(mamba_mod, "checkpoint", straight), \
            mock.patch.object(xlstm_mod, "checkpoint", straight), Float64():
        loss, _, grads = lm.loss_and_grads(
            p64, {k: v.cpu() for k, v in batch.items()}, cfg)
    if loss.dtype != f64:
        fail(f"the float64 run's loss came out {loss.dtype}")
    return loss, grads


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tree_leaves(tree))


def _lm_batch(dcfg, step: int, dev):
    import torch
    from repro_torch.data.pipeline import make_batch

    return {k: torch.from_numpy(v).to(dev)
            for k, v in make_batch(dcfg, step).items()}


def l1_check_steps(cfg, dev, steps: int = L1_CHECK_STEPS,
                   batch: int = L1_BATCH, seq: int = L1_SEQ,
                   leaf_atol_of_max=None, float64: bool = False) -> list:
    """The first ``steps`` train steps on ``dev`` and, from the same params
    and AdamW state each step, on the CPU, on the synthetic pipeline's
    batches (with the config's frame or patch embedding stubs where it has
    them). The step is
    ``make_train_step``'s body in its two halves: ``lm.loss_and_grads``
    (the loss and every grad leaf allclose to the CPU's), then
    ``cosine_warmup`` and the in-place ``adamw_update_`` on ``dev``, whose
    new params and moments must equal the functional ``adamw_update`` run
    on the CPU on ``dev``'s own grads. Each grad leaf is held at rtol
    ``L_GRAD_RTOL`` + atol ``L_GRAD_ATOL_OF_MAX`` x its largest magnitude
    (``leaf_atol_of_max``: another atol for the leaves of a ``leaf_kinds``
    entry or of a mixer), but a leaf whose gradient is 0 in exact
    arithmetic (``EXACT_ZERO_GRADS``: an sLSTM's ``bi``), which must be
    rounding noise on both devices, within 1e-6 of the largest gradient.
    With ``float64``, each step's row also reads, per leaf and over the
    leaf's largest float64 magnitude, how far the card's and the CPU's
    grads each sit from :func:`float64_loss_and_grads` on the same params
    and batch, and how far that float64 gradient moves when every param
    moves by ``F32_ULP`` times a standard normal draw (``f64_band``: the
    spread that float32 rounding of the inputs alone would give)."""
    import torch
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, \
        adamw_update_, cosine_warmup

    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    opt = adamw_init(params)
    opt_cfg = AdamWConfig(grad_clip_norm=L_GRAD_CLIP)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                      global_batch=batch, enc_seq_len=cfg.enc_seq_len,
                      num_image_tokens=cfg.num_image_tokens,
                      d_model=cfg.d_model)
    cpu = torch.device("cpu")
    kinds = leaf_kinds(cfg, params)
    atol_of = leaf_atol_of_max or {}
    atols = [atol_of.get(k, atol_of.get(k[0], L_GRAD_ATOL_OF_MAX))
             for k in kinds]
    rows = []
    for s in range(steps):
        cpu_p, cpu_o = _cpu_tree(params), _cpu_tree(opt)
        loss, _, grads = lm.loss_and_grads(params, _lm_batch(dcfg, s, dev),
                                           cfg)
        cpu_loss, _, cpu_grads = lm.loss_and_grads(
            cpu_p, _lm_batch(dcfg, s, cpu), cfg)
        loss_err = abs(float(loss) - float(cpu_loss))
        if loss_err > L_LOSS_RTOL * abs(float(cpu_loss)):
            fail(f"phase L1 step {s}: loss {float(loss)} on the card, "
                 f"{float(cpu_loss)} on the CPU")
        worst, bad, readings = 0.0, [], []
        cpu_leaves = _tree_leaves(cpu_grads)
        top = max(float(c.abs().max()) for c in cpu_leaves)
        f64_leaves = band_leaves = [None] * len(cpu_leaves)
        if float64:
            f64_leaves, band_leaves = (_tree_leaves(float64_loss_and_grads(
                p, _lm_batch(dcfg, s, cpu), cfg)[1]) for p in (
                    cpu_p, _perturbed(cpu_p, F32_ULP, s)))
        for i, (g, c, e, e2, kind, atol) in enumerate(zip(
                _tree_leaves(grads), cpu_leaves, f64_leaves, band_leaves,
                kinds, atols)):
            g = g.cpu()
            name = f"{i} {kind[0] or ''} {kind[1]} {tuple(c.shape)}"
            if e is not None and kind not in EXACT_ZERO_GRADS:
                exact = max(float(e.abs().max()), 1e-30)
                readings.append({
                    "leaf": name, "f64_max": float(e.abs().max()),
                    "card_vs_cpu": float((g - c).abs().max()) / exact,
                    "card_vs_f64": float((g.double() - e).abs().max())
                    / exact,
                    "cpu_vs_f64": float((c.double() - e).abs().max())
                    / exact,
                    "f64_band": float((e2 - e).abs().max()) / exact})
            if kind in EXACT_ZERO_GRADS:
                if max(float(g.abs().max()), float(c.abs().max())) \
                        > 1e-6 * top:
                    bad.append(f"grad leaf {name}, 0 in exact arithmetic, "
                               f"reads {float(g.abs().max()):.3g} (card) / "
                               f"{float(c.abs().max()):.3g} (CPU)")
                continue
            scale = float(c.abs().max())
            err = (g - c).abs()
            if bool((err > atol * scale + L_GRAD_RTOL * c.abs()).any()):
                bad.append(f"grad leaf {name} differs from the CPU's by "
                           f"{float(err.max()):.3g} (largest grad "
                           f"{scale:.3g}, atol {atol:g} of it)")
            worst = max(worst, float(err.max()) / max(scale, 1e-30))
        for r in readings:
            print(f"{cfg.name} grad reading step {s} {json.dumps(r)}")
        if bad:
            fail(f"phase L1 step {s}: {bad}")
        lr = cosine_warmup(s, *(L_SCHEDULE[k] for k in (
            "base_lr", "warmup", "total_steps")))
        host_p, host_o = adamw_update(_cpu_tree(grads), cpu_p, cpu_o, s,
                                      opt_cfg, lr)
        adamw_update_(grads, params, opt, s, opt_cfg, lr)
        adam_err = 0.0
        for got, want in ((params, host_p), (opt["m"], host_o["m"]),
                          (opt["v"], host_o["v"])):
            for g, c in zip(_tree_leaves(got), _tree_leaves(want)):
                g = g.cpu()
                if not torch.allclose(g, c, **L_ADAM_TOL):
                    fail(f"phase L1 step {s}: the in-place AdamW on the "
                         "card differs from adamw_update on the CPU on the "
                         "same grads")
                adam_err = max(adam_err, float((g - c).abs().max()))
        rows.append({"step": s, "loss": float(loss),
                     "loss_rel_err": loss_err / abs(float(cpu_loss)),
                     "grad_err_of_leaf_max": worst,
                     "adamw_max_abs_err": adam_err,
                     "grad_readings": readings, **{
                         f"{k}_max": max(r[k] for r in readings)
                         for k in ("card_vs_f64", "cpu_vs_f64", "f64_band")
                         if readings}})
        del grads, cpu_grads, host_p, host_o
    return rows


def l2_full_width(dev, cfg=None, steps: int = L2_STEPS,
                  batch: int = L2_BATCH, seq: int = L2_SEQ) -> dict:
    """``make_train_step`` at the Trainer's defaults on ``L_ARCH`` at its
    published widths and ``L2_LAYERS`` layers (``cfg`` overrides), random
    weights from seed 0, the synthetic pipeline's batches of ``batch`` x
    ``seq``: per step the loss, steps/s, tokens/s and the peak allocated
    bytes so far; on the card one more step under the profiler
    (:func:`profile_run`). The losses and params must stay finite; then
    one more ``loss_and_grads`` whose every grad leaf must be finite and
    in its param's dtype (bfloat16)."""
    import math

    import torch
    from repro_torch.configs import registry
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train.trainer import TrainerConfig

    cuda = torch.device(dev).type == "cuda"
    cfg = cfg or registry.get(L_ARCH).with_(num_layers=L2_LAYERS)
    tc = TrainerConfig()
    step_fn = lm.make_train_step(
        cfg, AdamWConfig(grad_clip_norm=tc.grad_clip), base_lr=tc.base_lr,
        warmup=tc.warmup, total_steps=tc.total_steps)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                      global_batch=batch)
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    opt = adamw_init(params)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    state = {"params": _tree_bytes(params), "moments": _tree_bytes(opt),
             "allocated_before_bytes": (torch.cuda.memory_allocated()
                                        if cuda else None)}
    rows = []
    for s in range(steps):
        b = _lm_batch(dcfg, s, dev)
        t0 = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, b, s)
        loss = float(metrics["loss"])  # waits for the step
        dt = time.perf_counter() - t0
        row = {"step": s, "loss": loss, "lr": float(metrics["lr"]),
               "s": dt, "steps_per_s": 1.0 / dt,
               "tokens_per_s": batch * seq / dt,
               "peak_allocated_bytes": (torch.cuda.max_memory_allocated()
                                        if cuda else None)}
        print(f"phase L2 step {s}: {json.dumps(row)}", flush=True)
        rows.append(row)
        if not math.isfinite(loss):
            fail(f"phase L2 step {s}: loss {loss}")
    peak = torch.cuda.max_memory_allocated() if cuda else None
    prof = (profile_run(lambda: step_fn(params, opt,
                                        _lm_batch(dcfg, steps, dev), steps))
            if cuda else None)
    for i, p in enumerate(_tree_leaves(params)):
        if not bool(torch.isfinite(p).all()):
            fail(f"phase L2: param leaf {i} {tuple(p.shape)} is not finite "
                 f"after {steps} steps")
    _, _, grads = lm.loss_and_grads(params, _lm_batch(dcfg, steps + 1, dev),
                                    cfg)
    for i, (g, p) in enumerate(zip(_tree_leaves(grads),
                                   _tree_leaves(params))):
        if g.dtype != p.dtype or g.dtype != torch.bfloat16:
            fail(f"phase L2: grad leaf {i} is {g.dtype}, its param "
                 f"{p.dtype} (both must be bfloat16)")
        if not bool(torch.isfinite(g).all()):
            fail(f"phase L2: grad leaf {i} {tuple(g.shape)} is not finite")
    del grads
    steady = rows[1:] or rows
    step_s = statistics.median(r["s"] for r in steady)
    return {"config": {"arch": L_ARCH, "num_layers": cfg.num_layers,
                       "d_model": cfg.d_model, "num_heads": cfg.num_heads,
                       "num_kv_heads": cfg.num_kv_heads, "d_ff": cfg.d_ff,
                       "vocab_size": cfg.vocab_size, "dtype": cfg.dtype,
                       "remat": cfg.remat, "q_block": cfg.q_block,
                       "loss_chunk": cfg.loss_chunk, "batch": batch,
                       "seq": seq, "params": cfg.param_count()},
            "state_bytes": state, "steps": rows,
            "median_step_s_after_first": step_s,
            "steps_per_s": 1.0 / step_s,
            "tokens_per_s": batch * seq / step_s,
            "peak_allocated_bytes": peak, "profile_one_step": prof}


def l3_trainer(cfg, dev, steps: int = L3_STEPS,
               ckpt_every: int = L3_CKPT_EVERY, fault_at: int = L3_FAULT_AT,
               resume_steps: int = L3_RESUME_STEPS, batch: int = L1_BATCH,
               seq: int = L1_SEQ, root=None) -> dict:
    """The Trainer on ``dev`` in a temporary checkpoint dir (removed at the
    end; ``root`` instead, kept: phase Q2 re-lays its ``timed``
    checkpoint): ``steps`` steps with a checkpoint every ``ckpt_every`` and one
    fault injected at ``fault_at``; exactly that one restart, with the
    injected error, must happen, and the last 5 steps' mean loss must be
    below the first 5's. One save and one load of the final state are
    timed. Then ``2 x resume_steps`` straight steps against
    ``resume_steps`` + a fresh Trainer resuming for ``resume_steps`` more:
    no restart, and the final losses within ``L3_RESUME_RTOL``."""
    import tempfile

    import torch
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cuda = torch.device(dev).type == "cuda"
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                      global_batch=batch)
    injected = RuntimeError(f"injected fault at step {fault_at}")
    armed = [True]

    def fault(step):
        if step == fault_at and armed[0]:
            armed[0] = False
            raise injected

    def sync():
        if cuda:
            torch.cuda.synchronize()

    with contextlib.ExitStack() as stack:
        tmp = Path(root) if root is not None else Path(stack.enter_context(
            tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_")))
        tmp.mkdir(parents=True, exist_ok=True)

        def trainer(name, **kw):
            tcfg = TrainerConfig(
                ckpt_dir=str(tmp / name), ckpt_every=ckpt_every,
                grad_clip=L_GRAD_CLIP, metrics_path=str(tmp / "metrics"),
                **dict(L_SCHEDULE, total_steps=steps))
            return Trainer(cfg, dcfg, tcfg, device=dev, **kw)

        t = trainer("fault", fault_hook=fault)
        t0 = time.perf_counter()
        out = t.run(steps, resume=False)
        sync()
        wall = time.perf_counter() - t0
        events = [m for m in t.metrics if m.get("event") == "restart"]
        if (out["restarts"], len(events), out["final_step"]) != (1, 1,
                                                                  steps):
            fail(f"phase L3: restarts {out['restarts']}, restart events "
                 f"{events}, final step {out['final_step']} (want exactly "
                 f"the one injected restart and step {steps})")
        if events[0]["error"] != repr(injected)[:200]:
            fail(f"phase L3: the restart caught {events[0]['error']}, not "
                 "the injected fault")
        last_ckpt = (fault_at // ckpt_every) * ckpt_every
        if events[0]["step"] != last_ckpt:
            fail(f"phase L3: restarted at step {events[0]['step']}, the "
                 f"latest checkpoint was step {last_ckpt}")
        losses = out["losses"]
        first, last = (statistics.mean(losses[:5]),
                       statistics.mean(losses[-5:]))
        if not last < first:
            fail(f"phase L3: mean loss of the first 5 steps {first:.4f}, "
                 f"of the last 5 {last:.4f} (must fall)")
        state = {"params": out["params"], "opt": out["opt"]}
        sync()
        t0 = time.perf_counter()
        path = ckpt.save(tmp / "timed", out["final_step"], state)
        save_s = time.perf_counter() - t0
        nbytes = sum(f.stat().st_size for f in path.iterdir())
        t0 = time.perf_counter()
        loaded, _ = ckpt.load(tmp / "timed", state)
        sync()
        load_s = time.perf_counter() - t0
        for a, b in zip(_tree_leaves(loaded), _tree_leaves(state)):
            if not torch.equal(a, b):
                fail("phase L3: a checkpoint did not load back exactly")
        del out, state, loaded
        straight_t = trainer("straight")
        straight = straight_t.run(2 * resume_steps, resume=False)
        first_t = trainer("resume")
        first_t.run(resume_steps, resume=False)
        resumed_t = trainer("resume")
        resumed = resumed_t.run(resume_steps, resume=True)
        if (straight_t.restarts, first_t.restarts, resumed_t.restarts) != (
                0, 0, 0) or resumed["final_step"] != 2 * resume_steps:
            fail(f"phase L3 resume: restarts {straight_t.restarts}, "
                 f"{first_t.restarts}, {resumed_t.restarts}; final step "
                 f"{resumed['final_step']}")
        a, b = straight["losses"][-1], resumed["losses"][-1]
        gap = abs(a - b) / abs(a)
        if gap > L3_RESUME_RTOL:
            fail(f"phase L3 resume: final loss {b} after resuming, {a} "
                 f"straight (rtol {gap:.3g} > {L3_RESUME_RTOL})")
        return {"steps": steps, "ckpt_every": ckpt_every,
                "fault_at": fault_at, "restart_event": events[0],
                "restarts": t.restarts,
                "straggler_events": t.straggler_events,
                "wall_s": wall, "loss_first5_mean": first,
                "loss_last5_mean": last,
                "checkpoint": {"bytes": nbytes, "save_s": save_s,
                               "load_s": load_s},
                "straight_losses": straight["losses"],
                "resume": {"straight_final_loss": a,
                           "resumed_final_loss": b, "rel_gap": gap,
                           "bit_equal": straight["losses"][resume_steps:]
                           == resumed["losses"]}}


def run_phase_l(dev, reset, counts, *, l1_cfg=None, l2_cfg=None,
                l1_kw=None, l2_kw=None, l3_kw=None, after_l1=None) -> dict:
    """Phase L: L1 (:func:`l1_check_steps`), L2 (:func:`l2_full_width`) and
    L3 (:func:`l3_trainer`); the training path runs no hand-written
    kernel (the reference trains through plain einsums), so every launch
    count must stay 0. Each part prints its seconds. ``after_l1`` runs
    once L1, whose CPU steps want the host's cores, is done."""
    import torch

    cuda = torch.device(dev).type == "cuda"
    l1_cfg = l1_cfg or l_config()
    out = {"l1_config": {"arch": L_ARCH, "params": l1_cfg.param_count(),
                         **L1_WIDTHS, "batch": L1_BATCH, "seq": L1_SEQ}}
    reset()
    for name, fn in (
            ("L1", lambda: l1_check_steps(l1_cfg, dev, **(l1_kw or {}))),
            ("L2", lambda: l2_full_width(dev, l2_cfg, **(l2_kw or {}))),
            ("L3", lambda: l3_trainer(l1_cfg, dev, **(l3_kw or {})))):
        if cuda:
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out[name] = fn()
        out[f"{name}_s"] = time.perf_counter() - t0
        print(f"phase {name}: {out[f'{name}_s']:.1f} s", flush=True)
        if name == "L1" and after_l1 is not None:
            after_l1()
    out["launches"] = counts()
    if any(out["launches"].values()):
        fail(f"phase L launched a hand-written kernel: {out['launches']}")
    return out


# ---------------------------------------------------------------------------
# phase P: session sharding and the parallel/ collectives over ranks
# ---------------------------------------------------------------------------

# P2's checks 1 and 2 (arm A's windows, arm B's served fleet), arm F's first
# decode tick for the sharded decode attention (q [4, 40, 1, 128] against
# the [4, 8, 2084, 128] cache at index 2048), the gradient tree of the
# compression checks and the reference's gpipe test (L 8, D 16, B 8)
P_SHAPES = dict(frames=32, a_sessions=2, b_sessions=4,
                decode=dict(batch=4, heads=40, kv_heads=8, cache=2084,
                            dim=128, index=2048),
                grad=(4096, 4096), pipe=dict(layers=8, width=16, batch=8))
P_DEADLINE_S = 300.0  # the parent kills P2's ranks past this
P_COLLECTIVE_TIMEOUT_S = 120.0
P_FIELDS = ("frames", "holes", "hole_counts", "overflowed", "fine_counts")


def port_kernels() -> list:
    """The six kernel sources of the path, in the launch line's order."""
    from repro_torch.kernels import flash_attention as fa_k
    from repro_torch.kernels import fused_nerf_mlp as mlp_k
    from repro_torch.kernels import gather_trilerp as gt_k
    from repro_torch.kernels import streaming_pipeline as sp_k

    return [gt_k.KERNEL, mlp_k.KERNEL, sp_k.KERNEL, gt_k.KERNEL_PER_SEG,
            sp_k.KERNEL_PER_SEG, fa_k.KERNEL]


def launch_counts(kernels) -> dict:
    """Each kernel source's launches, and B6's by kernel."""
    from repro_torch.kernels import flash_attention as fa_k

    c = {k.name: k.launches for k in kernels}
    c.update({f"{B6}.{n}": m for n, m in fa_k.launches_by_kernel().items()})
    return c


def p_windows(n_sessions: int, n_frames: int, window: int) -> list:
    """Per warp window of ``n_sessions`` orbits (25 degrees apart in
    phase), the sessions' reference poses [S, 4, 4] and targets
    [S, N, 4, 4], as the trajectory schedule cuts them."""
    import torch

    from repro_torch.core import schedule
    from repro_torch.core.pipeline import orbit_trajectory

    trajs = [orbit_trajectory(n_frames, phase_deg=25.0 * i)
             for i in range(n_sessions)]
    plans = [schedule.WarpSchedule(window, "offtraj").windows(t)
             for t in trajs]
    return [(torch.stack([p[w]["ref_pose"] for p in plans]),
             torch.stack([torch.stack([t[j] for j in p[w]["frames"]])
                          for p, t in zip(plans, trajs)]))
            for w in range(len(plans[0]))]


def p_fleet(n_sessions: int, n_frames: int) -> list:
    from repro_torch.core.config import RenderRequest
    from repro_torch.core.pipeline import orbit_trajectory

    return [RenderRequest(poses=tuple(orbit_trajectory(
        n_frames, phase_deg=25.0 * i))) for i in range(n_sessions)]


def p_render_windows(renderer, windows, reset, counts) -> dict:
    """``windows`` through the renderer's engine (``render_windows``), cold
    with the launch counts set to 0 before and read after, then warm:
    every result's fields on the host and both walls."""
    eng = renderer.pipeline.device_engine
    dev = renderer.device

    def run():
        t0 = time.perf_counter()
        res = [eng.render_windows(r.to(dev), t.to(dev)) for r, t in windows]
        fields = [{k: getattr(x, k).cpu() for k in P_FIELDS} for x in res]
        return fields, time.perf_counter() - t0

    reset()
    cold, cold_s = run()
    launches = counts()
    _, warm_s = run()
    return {"windows": cold, "launches": launches, "cold_wall_s": cold_s,
            "warm_wall_s": warm_s}


def p_run_stats(m: dict) -> dict:
    """A serving run's statistics without walls, latencies and waits."""
    return {"ticks": m["ticks"], "complete": m["complete"],
            "total_frames": m["total_frames"], "pool": m["pool"],
            "memory": m["memory"], "slots": m["slots"],
            "scene_cache": m["scene_cache"],
            "queue": {k: m["queue"][k]
                      for k in ("depth_mean", "depth_max", "shed")},
            "per_session": {s: {k: v for k, v in row.items()
                                if "latency" not in k}
                            for s, row in m["per_session"].items()}}


def p_serve(renderer, fleet, reset, counts) -> dict:
    """``fleet`` served, cold (launches counted) then warm: each session's
    frames on the host and stats, the warm run's statistics (a warm run
    adds no bucket key: ``pool.recompiles`` 0), both walls."""
    import torch

    reset()
    results, m = renderer.serve(fleet)
    launches = counts()
    _, m_warm = renderer.serve(fleet)
    return {"frames": [torch.stack(r.frames).cpu() for r in results],
            "stats": [dataclasses.asdict(r.stats) for r in results],
            "run": p_run_stats(m_warm), "devices": m["devices"],
            "launches": launches, "cold_wall_s": m["wall_s"],
            "warm_wall_s": m_warm["wall_s"]}


def _tanh_layer(p, h):
    import torch

    return torch.tanh(h @ p["w"] + p["b"])


def p_pipe_inputs(dev, pipe: dict, seed: int = 0):
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    n, d, b = pipe["layers"], pipe["width"], pipe["batch"]
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    return {"w": 0.3 * rnd(n, d, d), "b": 0.01 * rnd(n, d)}, rnd(b, d)


def p_decode_inputs(dev, d: dict, seed: int = 0):
    """q, k, v of arm F's first decode tick, bfloat16."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev
                                     ).to(torch.bfloat16)
    return (rnd(d["batch"], d["heads"], 1, d["dim"]),
            rnd(d["batch"], d["kv_heads"], d["cache"], d["dim"]),
            rnd(d["batch"], d["kv_heads"], d["cache"], d["dim"]))


def p_decode_check(label: str, q, k_local, v_local, k, v, index: int,
                   mesh) -> dict:
    """``sharded_decode_attention`` of this rank's cache slice against B6's
    decode (and against B6's plain version) on the whole cache, at B6's
    bfloat16 tolerance."""
    from repro_torch.kernels import flash_attention as fa_k
    from repro_torch.parallel.decode_attention import \
        sharded_decode_attention

    b, h, _, d = q.shape
    got = sharded_decode_attention(q, k_local, v_local, index, mesh=mesh,
                                   seq_axis="model", sm_scale=d**-0.5)
    out = {}
    for name, fn in (("B6", fa_k.flash_attention),
                     ("plain", fa_k.flash_attention_plain)):
        want = fn(q, k, v, causal=False, sm_scale=d**-0.5,
                  kv_len=index + 1).reshape(b, 1, h * d)
        out[f"max_abs_err_vs_{name}"] = check_close(
            f"{label} vs {name}", got, want, B6_BF16_TOL)
    return out


def p2_rank(rank: int, world: int, tmp: str, spec: dict) -> None:
    """One rank of phase P2: join the gloo group through a ``FileStore``
    in ``tmp``, run :func:`p2_checks` once ``tmp/go`` exists and save what
    it returns (or the traceback) to ``tmp``."""
    import datetime
    import os
    import traceback

    import torch
    import torch.distributed as dist

    out = Path(tmp)
    torch.set_num_threads(2)  # two ranks and this process share the host
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(out / "store"), world), rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=P_COLLECTIVE_TIMEOUT_S))
    try:
        torch.save(p2_checks(rank, world, out, spec), out / f"rank{rank}.pt")
        dist.barrier()  # no rank leaves while another is in a collective
    except BaseException:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()
    # the result is written and the group is gone: end before the
    # interpreter's teardown, which has aborted a gloo rank after its work
    # ("terminate called without an active exception")
    os._exit(0)


def p2_checks(rank: int, world: int, out: Path, spec: dict) -> dict:
    """P2's five checks on this rank (see :func:`run_phase_p`)."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch import api
    from repro_torch.convert import params_from_numpy
    from repro_torch.core.config import ShardConfig
    from repro_torch.nerf import models
    from repro_torch.parallel import compression
    from repro_torch.parallel import dist as pdist
    from repro_torch.parallel.pipeline import pipelined_forward, \
        reference_forward, stage_block

    kernels = port_kernels()
    reset = lambda: [k.reset() for k in kernels]
    counts = lambda: launch_counts(kernels)
    shapes = spec["shapes"]
    shard = ShardConfig(num_devices=world)
    dev = pdist.rank_device(spec["device"])
    ren_a = api.make_renderer(spec["cfg_a"].replace(shard=shard),
                              device=spec["device"])
    model_b, _ = models.make_model(**spec["model_b"])
    ren_b = api.make_renderer(
        spec["cfg_b"].replace(shard=shard), model=model_b,
        params=params_from_numpy(arm_b_params(**spec["params_b"]), dev),
        device=spec["device"])
    windows = p_windows(shapes["a_sessions"], shapes["frames"],
                        spec["cfg_a"].window)
    fleet = p_fleet(shapes["b_sessions"], shapes["frames"])
    deadline = time.monotonic() + P_DEADLINE_S
    while not (out / "go").exists():  # the parent's unsharded runs first
        if time.monotonic() > deadline:
            raise TimeoutError("phase P2: the parent never started the run")
        time.sleep(0.05)
    t0 = time.perf_counter()
    res = {"A": p_render_windows(ren_a, windows, reset, counts),
           "B": p_serve(ren_b, fleet, reset, counts)}
    res["check_s"] = {"1_2": time.perf_counter() - t0}
    # 3: the decode attention, the cache split evenly over the ranks
    d = shapes["decode"]
    q, k, v = p_decode_inputs(dev, d)
    per = d["cache"] // world
    rows = slice(rank * per, (rank + 1) * per)
    seq_mesh = DeviceMesh(dev.type, torch.arange(world).reshape(1, world),
                          mesh_dim_names=("data", "model"))
    res["decode"] = p_decode_check(f"P2 decode rank {rank}", q, k[:, :, rows],
                                   v[:, :, rows], k, v, d["index"], seq_mesh)
    res["check_s"]["3"] = time.perf_counter() - t0
    # 4: gpipe over the ranks, each stage holding a copy of its own block
    # of the stacked layers (the whole stack is the yardstick's)
    pod = DeviceMesh(dev.type, list(range(world)), mesh_dim_names=("pod",))
    params, x = p_pipe_inputs(dev, shapes["pipe"])
    want = reference_forward(_tanh_layer, params, x)
    stage = {k: v.clone() for k, v in stage_block(params, pod).items()}
    held = lambda tree: sum(t.untyped_storage().nbytes()
                            for t in tree.values())
    res["pipeline_bytes"] = {"stage": held(stage), "stacked": held(params)}
    res["pipeline"] = {}
    for m in (2, 4):
        got = pipelined_forward(_tanh_layer, stage, x, mesh=pod,
                                num_microbatches=m)
        res["pipeline"][m] = float((got - want).abs().max())
    res["check_s"]["4"] = time.perf_counter() - t0
    # 5: compressed_psum against the mean of every rank's payloads
    gen = torch.Generator(device=dev).manual_seed(1 + rank)
    grads = {"w": torch.randn(shapes["grad"], generator=gen, device=dev),
             "b": torch.randn((7,), generator=gen, device=dev)}
    group = pdist.axis(pod, "pod").group
    res["psum_bit_equal"] = {}
    for mode in ("int8", "bfloat16"):
        ef = compression.make_ef_state(grads)
        qs, ss, _ = compression.compress_with_feedback(grads, ef, mode)
        mean, _ = compression.compressed_psum(grads, group, ef, mode)
        res["psum_bit_equal"][mode] = all(
            torch.equal(mean[n], sum(pdist.all_gather0(
                compression.dequantize(qs[n], ss[n])[None], group)) / world)
            for n in grads)
    res["check_s"]["5"] = time.perf_counter() - t0
    return res


# C7's card check in P1: arm A's config served staged on 2 slots, 2
# sessions of 48 frames (3 windows of 16: each run admits on its first tick,
# then runs 2 steady ticks)
P1_C7 = dict(sessions=2, frames=48)


def p1_sharded_serving(dev, cfg, reset, counts, c7: dict = P1_C7) -> dict:
    """Fault C7's card check, inside P1's one-rank group: ``cfg`` served
    staged on ``c7["sessions"]`` slots by a ``RenderServeEngine`` sharded
    over the group's one rank, and by an unsharded one. ``ShardConfig``
    turns sharding off at one device (as the reference's does), so the
    sharded engine gets the group's 1-D session mesh (``make_mesh``'s)
    after construction: its windows then take the sharded path, the
    gathers over NCCL included, at S / D = S. Each engine serves
    the fleet until every key is captured (at most twice), then once more
    with every tick that admits nothing under ``sync_error`` (0
    synchronizing calls), its launch counts set to 0 before and read
    after. The sharded run's finalized frames and statistics must be
    bit-equal to the unsharded run's, with at least one steady tick, no
    new key and no new capture."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch import api
    from repro_torch.core.config import ShardConfig
    from repro_torch.serve.render_engine import RenderServeEngine, \
        RenderSession

    guard = sync_error if dev.type == "cuda" else contextlib.nullcontext
    n = c7["sessions"]

    def fleet():
        return [RenderSession.from_request(r, i) for i, r in
                enumerate(p_fleet(n, c7["frames"]))]

    out = {}
    for label in ("unsharded", "sharded"):
        ren = api.make_renderer(cfg.replace(num_slots=n, shard=None),
                                device=dev)
        serve = RenderServeEngine(ren.model, ren.params, config=ren.config)
        eng = serve.engine
        if label == "sharded":
            eng.mesh = DeviceMesh(dev.type, [0], mesh_dim_names=(
                ShardConfig().axis_name,))
        for _ in range(2):  # no capture on the CPU: two runs
            if eng.tick_programs and eng.cuda_graphs \
                    and eng.num_captures == len(eng.tick_programs):
                break
            serve.run(fleet())
        keys, caps = sorted(eng.tick_programs), eng.num_captures
        real, steady = serve.step, [0]

        def guarded(serve=serve, real=real, steady=steady):
            if serve.queue and any(x is None for x in serve.slots):
                return real()  # admission: staging
            with guard():
                ran = real()
            steady[0] += ran
            return ran

        serve.step = guarded
        sessions = fleet()
        reset()
        t0 = time.perf_counter()
        m = serve.run(sessions)
        wall = time.perf_counter() - t0
        launches = counts()
        del serve.step
        if sorted(eng.tick_programs) != keys or eng.num_captures != caps \
                or (eng.cuda_graphs and caps != len(keys)) or steady[0] < 1 \
                or not m["complete"]:
            fail(f"P1 C7 {label}: keys {keys} -> {sorted(eng.tick_programs)}"
                 f", captures {caps} -> {eng.num_captures}, {steady[0]} "
                 f"steady ticks")
        out[label] = {
            "frames": [torch.stack(s.frames).cpu() for s in sessions],
            "stats": [dataclasses.asdict(s.stats) for s in sessions],
            "run": p_run_stats(m), "devices": m["devices"],
            "keys": [list(k) for k in keys], "steady_ticks": steady[0],
            "ticks": m["ticks"], "launches": launches, "warm_wall_s": wall}
    base, got = out["unsharded"], out["sharded"]
    if got["stats"] != base["stats"] or got["run"] != base["run"] \
            or any(not torch.equal(a, b)
                   for a, b in zip(got["frames"], base["frames"])):
        fail("P1 C7: the sharded serving run differs from the unsharded one")
    if got["keys"][0][0] != "staged_sharded" or got["devices"] != 1 \
            or got["launches"]["gather_trilerp"] == 0:
        fail(f"P1 C7: keys {got['keys']}, devices {got['devices']}, "
             f"launches {got['launches']}")
    for row in out.values():
        del row["frames"], row["stats"]
    out["bit_equal"] = True
    return out


def run_phase_p1(dev, shapes: dict = P_SHAPES, c7_cfg=None, reset=None,
                 counts=None) -> dict:
    """P1, in this process: a process group of one rank (NCCL on the card,
    gloo on the CPU) through a ``FileStore``: ``make_smoke_mesh``, the sharded
    decode attention at arm F's decode tick against B6, compression with
    ``compressed_psum`` bit for bit, gpipe over one stage, and with
    ``c7_cfg`` the sharded serving engine's steady tick
    (:func:`p1_sharded_serving`); the group is destroyed at the end."""
    import datetime
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.parallel import compression
    from repro_torch.parallel import dist as pdist
    from repro_torch.parallel.pipeline import pipelined_forward, \
        reference_forward, stage_block

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            store=dist.FileStore(f"{tmp}/store", 1), rank=0,
            world_size=1,
            timeout=datetime.timedelta(seconds=P_COLLECTIVE_TIMEOUT_S))
        try:
            mesh = make_smoke_mesh(device=None if dev.type == "cuda"
                                   else dev)
            out["backend"] = dist.get_backend(mesh.get_group("model"))
            out["mesh"] = [tuple(mesh.shape), mesh.mesh_dim_names]
            d = shapes["decode"]
            q, k, v = p_decode_inputs(dev, d)
            out["decode"] = p_decode_check("P1 decode", q, k, v, k, v,
                                           d["index"], mesh)
            gen = torch.Generator(device=dev).manual_seed(1)
            grads = {"w": torch.randn(shapes["grad"], generator=gen,
                                      device=dev),
                     "b": torch.randn((7,), generator=gen, device=dev)}
            group = pdist.axis(mesh, "data").group
            out["psum_bit_equal"] = {}
            for mode in ("int8", "bfloat16"):
                ef, equal = compression.make_ef_state(grads), True
                for step in range(2):  # the second carries a residual
                    g = {n: t * (step + 1) for n, t in grads.items()}
                    red, new_ef = compression.compressed_psum(g, group, ef,
                                                              mode)
                    equal &= all(torch.equal(red[n], compression.dequantize(
                        *compression.quantize(g[n] + ef[n], mode)))
                        for n in g)
                    ef = new_ef
                out["psum_bit_equal"][mode] = equal
                out[f"wire_bytes_{mode}"] = compression.wire_bytes(grads,
                                                                   mode)
            params, x = p_pipe_inputs(dev, shapes["pipe"])
            want = reference_forward(_tanh_layer, params, x)
            stage = stage_block(params, mesh, "data")  # one stage: all
            one = pipelined_forward(_tanh_layer, stage, x, mesh=mesh,
                                    num_microbatches=1, axis="data")
            four = pipelined_forward(_tanh_layer, stage, x, mesh=mesh,
                                     num_microbatches=4, axis="data")
            out["pipeline_one_stage_bit_equal"] = bool(torch.equal(one, want))
            out["pipeline_one_stage_m4_err"] = float(
                (four - want).abs().max())
            if c7_cfg is not None:
                t0 = time.perf_counter()
                out["C7"] = p1_sharded_serving(dev, c7_cfg, reset, counts)
                out["C7_s"] = time.perf_counter() - t0
        finally:
            dist.destroy_process_group()
    if not all(out["psum_bit_equal"].values()):
        fail(f"P1: compressed_psum differs from dequantize(quantize(g + ef)) "
             f"{out['psum_bit_equal']}")
    if not out["pipeline_one_stage_bit_equal"] \
            or out["pipeline_one_stage_m4_err"] > 1e-5:
        fail(f"P1: one-stage gpipe differs from reference_forward: {out}")
    return out


def run_phase_p(dev, reset, counts, *, cfg_a, cfg_b, model_b_kw: dict,
                params_b: dict, renderer_b=None, shapes: dict = P_SHAPES
                ) -> dict:
    """Phase P: P2's two gloo ranks are started with ``spawn`` on this
    card (NCCL refuses two ranks on one device); while they start, this
    process runs P1 (:func:`run_phase_p1`) and the unsharded runs P2 is
    held against, then writes the file the ranks wait on to run
    :func:`p2_checks`. Arm B's params are ``arm_b_params(**params_b)``
    in every process; ``renderer_b`` (arm D's staged renderer, whose keys
    its fleet captured: that fleet's first 4 sessions are P2's) serves
    the unsharded fleet, else a new one. Any rank's failure or a rank
    past ``P_DEADLINE_S`` fails the phase."""
    import multiprocessing as mp
    import tempfile

    import torch

    from repro_torch import api
    from repro_torch.convert import params_from_numpy
    from repro_torch.nerf import models

    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
    world = 2
    cfg_a, cfg_b = cfg_a.replace(num_slots=world), cfg_b.replace(
        num_slots=shapes["b_sessions"])
    # small: the ranks' start waits for nothing bulky through the pipe
    spec = dict(device=None if cuda else str(dev), shapes=shapes,
                cfg_a=cfg_a, cfg_b=cfg_b, model_b=model_b_kw,
                params_b=params_b)
    out = {}
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=p2_rank, args=(r, world, tmp, spec),
                             daemon=True) for r in range(world)]
        for p in procs:
            p.start()
        try:
            # P1 and the unsharded runs, while the ranks start
            out["P1"] = run_phase_p1(dev, shapes, c7_cfg=cfg_a, reset=reset,
                                     counts=counts)
            out["P1_s"] = time.perf_counter() - t1
            base_a = p_render_windows(
                api.make_renderer(cfg_a, device=dev),
                p_windows(shapes["a_sessions"], shapes["frames"],
                          cfg_a.window), reset, counts)
            reused_b = renderer_b is not None
            if renderer_b is None:
                model_b, _ = models.make_model(**model_b_kw)
                renderer_b = api.make_renderer(
                    cfg_b, model=model_b, params=params_from_numpy(
                        arm_b_params(**params_b), dev), device=dev)
            base_b = p_serve(renderer_b, p_fleet(shapes["b_sessions"],
                                                 shapes["frames"]),
                             reset, counts)
            Path(tmp, "go").touch()
            out["P2_go_s"] = time.perf_counter() - t1
            end = time.monotonic() + P_DEADLINE_S
            for p in procs:
                p.join(max(end - time.monotonic(), 0.0))
            stalled = [r for r, p in enumerate(procs) if p.is_alive()]
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        errors = {r: Path(tmp, f"rank{r}.err").read_text()
                  for r in range(world) if Path(tmp, f"rank{r}.err").exists()}
        if stalled or errors or any(p.exitcode for p in procs):
            fail(f"phase P2: ranks stalled {stalled}, exit codes "
                 f"{[p.exitcode for p in procs]}, errors {errors}")
        out["P2_joined_s"] = time.perf_counter() - t1
        print(f"phase P2: the ranks ran from {out['P2_go_s']:.1f} s to "
              f"{out['P2_joined_s']:.1f} s", flush=True)
        ranks = [torch.load(Path(tmp, f"rank{r}.pt"), weights_only=False)
                 for r in range(world)]
    out["P_s"] = time.perf_counter() - t1
    rank_launches, p2 = {}, {}
    for r, res in enumerate(ranks):
        for w, (got, want) in enumerate(zip(res["A"]["windows"],
                                            base_a["windows"])):
            for k in P_FIELDS:
                if not torch.equal(got[k], want[k]):
                    fail(f"P2 check 1 rank {r} window {w}: {k} differs "
                         f"from the unsharded render")
        if res["B"]["stats"] != base_b["stats"] \
                or res["B"]["run"] != base_b["run"] \
                or res["B"]["devices"] != world:
            fail(f"P2 check 2 rank {r}: stats {res['B']['run']} (devices "
                 f"{res['B']['devices']}) vs unsharded {base_b['run']}")
        for s, (got, want) in enumerate(zip(res["B"]["frames"],
                                            base_b["frames"])):
            if not torch.equal(got, want):
                fail(f"P2 check 2 rank {r} session {s}: frames differ from "
                     f"the unsharded serving run")
        la, lb = res["A"]["launches"], res["B"]["launches"]
        if la["gather_trilerp"] == 0 or lb["gather_trilerp"] == 0 \
                or lb["fused_nerf_mlp"] == 0:
            fail(f"P2 rank {r}: B1 / B2 unlaunched: A {la}, B {lb}")
        rank_launches[f"P2 A rank {r}"] = la
        rank_launches[f"P2 B rank {r}"] = lb
        if max(res["pipeline"].values()) > 1e-5:
            fail(f"P2 check 4 rank {r}: gpipe {res['pipeline']}")
        held = res["pipeline_bytes"]
        if held["stage"] * world != held["stacked"]:
            fail(f"P2 check 4 rank {r}: the stage holds {held['stage']} "
                 f"bytes of the {held['stacked']} stacked (want 1 / {world})")
        print(f"phase P2 gpipe rank {r}: the stage holds {held['stage']:,} "
              f"of the stack's {held['stacked']:,} param bytes", flush=True)
        if not all(res["psum_bit_equal"].values()):
            fail(f"P2 check 5 rank {r}: compressed_psum "
                 f"{res['psum_bit_equal']}")
        p2[f"rank {r}"] = {
            "decode": res["decode"], "pipeline_max_abs_err": res["pipeline"],
            "pipeline_param_bytes": res["pipeline_bytes"],
            "seconds_at_end_of_check": res["check_s"],
            "psum_bit_equal": res["psum_bit_equal"],
            **{f"{c}_{k}": res[c][k] for c in ("A", "B")
               for k in ("cold_wall_s", "warm_wall_s")}}
    p2["unsharded"] = {f"{c}_{k}": b[k] for c, b in (("A", base_a),
                                                     ("B", base_b))
                       for k in ("cold_wall_s", "warm_wall_s")}
    # arm D's renderer comes warm: both of its "unsharded B" runs are warm
    p2["unsharded"]["B_renderer_warm_at_entry"] = reused_b
    p2["unsharded"]["launches"] = {c: {k: b["launches"][k] for k in (
        "gather_trilerp", "fused_nerf_mlp")} for c, b in (("A", base_a),
                                                          ("B", base_b))}
    p2["checks_1_2"] = "bit-equal"  # every field, every rank
    out["P2"] = p2
    for label in ("unsharded", "sharded"):
        rank_launches[f"P1 C7 {label}"] = out["P1"]["C7"][label]["launches"]
    out["rank_launches"] = rank_launches
    return out


# ---------------------------------------------------------------------------
# phase Q: the spec trees onto DTensor placements, the elastic re-lay and
# the Trainer's mesh branch
# ---------------------------------------------------------------------------

# Q1: the production meshes ((16, 16) over 256 ranks, (2, 16, 16) over 512)
# under torch's fake process group, every arch at its published widths and
# depth from meta shapes; then the mesh Trainer at L2's config on the
# (2, 1) smoke mesh of a fake world of 2
Q_PROD_MESHES = ((False, 256), (True, 512))
Q_SMOKE_WORLD = 2
Q_DEADLINE_S = 300.0  # the parent kills Q's ranks and subprocess past this
# Q2: the mesh Trainer's steps, against the one-device Trainer's on the card
Q_TRAIN_STEPS = 3
Q_TRAIN_RTOL = L_LOSS_RTOL


def q_layout(cfg, mesh) -> dict:
    """``cfg``'s params laid out on ``mesh`` (this rank's view) under its
    ``default_strategy`` and the strict guard, from meta shapes: the
    strategy, the whole params' bytes, and this rank's bytes and largest
    leaf block."""
    import math

    from repro_torch.models import lm
    from repro_torch.models.common import map_specs
    from repro_torch.parallel import sharding

    shapes = lm.param_shapes(cfg)
    strategy = sharding.default_strategy(cfg)
    specs = sharding.apply_strategy(lm.param_specs(cfg), shapes, strategy)
    rows = []

    def leaf(spec, t):
        ns = sharding.named_sharding(mesh, spec, tuple(t.shape), strict=True)
        local, _ = sharding.local_block(ns, tuple(t.shape))
        size = t.element_size()
        rows.append((t.numel() * size, math.prod(local) * size,
                     any(type(p).__name__ == "Shard" for p in ns.placements)))

    map_specs(leaf, specs, shapes)
    return {"strategy": strategy, "params": cfg.param_count(),
            "leaves": len(rows), "sharded_leaves": sum(r[2] for r in rows),
            "param_bytes": sum(r[0] for r in rows),
            "param_bytes_per_rank": sum(r[1] for r in rows),
            "largest_leaf_bytes_per_rank": max(r[1] for r in rows)}


def q1_layouts(device=None, archs=None, trainer_cfg=None,
               prod_meshes=Q_PROD_MESHES) -> dict:
    """Q1's work, in a process of its own (it initializes the fake process
    group): :func:`q_layout` of every arch on each production mesh, then
    ``Trainer(trainer_cfg, mesh=make_smoke_mesh())`` (default: L2's
    config), whose ``_pshard`` must name every param leaf and ``_oshard``
    each moment as its param. No tensor is allocated anywhere."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.configs import registry
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.mesh import make_production_mesh, \
        make_smoke_mesh
    from repro_torch.models import lm
    from repro_torch.parallel.sharding import NamedSharding
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.trainer import Trainer, TrainerConfig

    out = {"meshes": {}}
    for multi_pod, world in prod_meshes:
        t0 = time.perf_counter()
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
        try:
            mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
            out["meshes"][str(tuple(mesh.shape))] = {
                arch: q_layout(registry.get(arch), mesh)
                for arch in archs or registry.list_archs()}
        finally:
            dist.destroy_process_group()
        out[f"s {tuple(mesh.shape)}"] = time.perf_counter() - t0
    cfg = trainer_cfg or registry.get(L_ARCH).with_(num_layers=L2_LAYERS)
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=Q_SMOKE_WORLD)
    try:
        mesh = make_smoke_mesh(device="cpu")
        t = Trainer(cfg, DataConfig(vocab_size=cfg.vocab_size, seq_len=8,
                                    global_batch=1),
                    TrainerConfig(ckpt_dir="unused"), mesh=mesh,
                    device=device)
        is_ns = lambda x: isinstance(x, NamedSharding)
        keys = [k for k, _ in ckpt._flatten(t._pshard, is_leaf=is_ns)]
        want = [k for k, _ in ckpt._flatten(lm.param_shapes(cfg))]
        out["trainer"] = {
            "config": cfg.name, "layers": cfg.num_layers,
            "params": cfg.param_count(), "mesh": list(mesh.shape),
            "leaves": len(keys), "covers_every_leaf": keys == want,
            "oshard_is_pshard": t._oshard == {"m": t._pshard,
                                               "v": t._pshard},
            "sharded_leaves": sum(
                any(type(p).__name__ == "Shard" for p in ns.placements)
                for _, ns in ckpt._flatten(t._pshard, is_leaf=is_ns)),
            "layout": q_layout(cfg, mesh)}
    finally:
        dist.destroy_process_group()
    return out


def q1_start(dev) -> subprocess.Popen:
    """Q1 in a subprocess of this script (fake process groups cannot share
    this process with P's real ones)."""
    import os

    code = ("import json, sys, chip_smoke; print(json.dumps("
            f"chip_smoke.q1_layouts(device={'None' if dev.type == 'cuda' else repr(str(dev))})))")
    return subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=dict(os.environ))


def q1_finish(proc: subprocess.Popen) -> dict:
    try:
        out, err = proc.communicate(timeout=Q_DEADLINE_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        fail("phase Q1: the subprocess passed its deadline")
    if proc.returncode != 0:
        fail(f"phase Q1: the subprocess failed: {err[-3000:]}")
    res = json.loads(out.strip().splitlines()[-1])
    tr = res["trainer"]
    if not (tr["covers_every_leaf"] and tr["oshard_is_pshard"]):
        fail(f"phase Q1: the mesh Trainer's placements miss leaves: {tr}")
    for mesh, rows in res["meshes"].items():
        for arch, row in rows.items():
            if row["param_bytes_per_rank"] > row["param_bytes"]:
                fail(f"phase Q1 {mesh} {arch}: {row}")
    return res


def q2_rank(rank: int, world: int, tmp: str, spec: dict) -> None:
    """One rank of phase Q2 (the gloo group of :func:`p2_rank`, its own
    ``FileStore``): :func:`q2_checks` once ``tmp/go`` exists. A fatal
    signal's traceback goes to ``tmp/rank<r>.fault``."""
    import datetime
    import faulthandler
    import os
    import traceback

    import torch
    import torch.distributed as dist

    out = Path(tmp)
    fault_log = open(out / f"rank{rank}.fault", "w")
    faulthandler.enable(file=fault_log)
    torch.set_num_threads(2)
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(out / "store"), world), rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=P_COLLECTIVE_TIMEOUT_S))
    try:
        torch.save(q2_checks(rank, world, out, spec), out / f"rank{rank}.pt")
        dist.barrier()
    except BaseException:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()
    os._exit(0)


def q2_checks(rank: int, world: int, out: Path, spec: dict) -> dict:
    """Q2 on this rank: the re-lay of ``spec["ckpt"]`` (phase L3's timed
    checkpoint) onto the (world, 1) smoke mesh under the config's strict
    placements, each rank's blocks and ``full_tensor()`` against the
    one-device load; then a mesh Trainer's ``Q_TRAIN_STEPS`` steps.

    gloo cannot gather a CUDA DTensor: the ``all_gather_into_tensor`` that
    ``full_tensor()`` runs ends the process with a segmentation fault in
    its wait (torch 2.11, two gloo ranks on one H100). So the whole tensor
    is gathered from a host copy of each rank's block, laid out on a CPU
    mesh of the same ranks with the same placements."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import lm
    from repro_torch.optim.adamw import tree_flatten
    from repro_torch.parallel import sharding
    from repro_torch.parallel.dist import rank_device
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.trainer import Trainer, TrainerConfig

    kernels = port_kernels()
    for k in kernels:
        k.reset()
    cfg, device = spec["cfg"], spec["device"]
    dev = rank_device(device)
    mesh = make_smoke_mesh(device=device)
    # the re-lay's layout (the config's strategy, the strict guard, each
    # moment as its param) and a first DTensor, whose one-time set-up
    # takes seconds, while phase L runs
    meta = lm.param_shapes(cfg)
    strategy = sharding.default_strategy(cfg)
    pshard = sharding.sharding_tree(sharding.apply_strategy(
        lm.param_specs(cfg), meta, strategy), meta, mesh, strict=True)
    leaves, unflatten = tree_flatten(meta)
    empty = lambda dtype=None: unflatten([
        torch.empty(0, dtype=dtype or t.dtype, device=dev) for t in leaves])
    template = {"params": empty(),
                "opt": {"m": empty(torch.float32),
                        "v": empty(torch.float32)}}
    lay = {"params": pshard, "opt": {"m": pshard, "v": pshard}}
    DTensor.from_local(torch.zeros(2, device=dev), mesh, [Replicate()]
                       * mesh.ndim, run_check=False).to_local()
    deadline = time.monotonic() + Q_DEADLINE_S
    while not (out / "go").exists():  # phase L3's checkpoint first
        if time.monotonic() > deadline:
            raise TimeoutError("phase Q2: the parent never started the run")
        time.sleep(0.05)
    res, t0 = {}, time.perf_counter()
    whole, _ = ckpt.load(spec["ckpt"], template)
    res["load_whole_s"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    state, _ = ckpt.load(spec["ckpt"], template, shardings=lay)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    res["load_relaid_s"] = time.perf_counter() - t1
    is_ns = lambda x: isinstance(x, sharding.NamedSharding)
    host_mesh = DeviceMesh("cpu", torch.arange(world).reshape(
        tuple(mesh.shape)), mesh_dim_names=mesh.mesh_dim_names)
    rows = {"leaves": 0, "sharded": 0, "local_equal": 0, "full_equal": 0,
            "placements_requested": 0, "local_bytes": 0, "whole_bytes": 0,
            "on_device": 0}
    for (key, dt), (_, want), (_, ns) in zip(
            ckpt._flatten(state), ckpt._flatten(whole),
            ckpt._flatten(lay, is_leaf=is_ns)):
        local = dt.to_local()
        _, offset = sharding.local_block(ns, tuple(want.shape))
        block = want[tuple(slice(o, o + n)
                           for o, n in zip(offset, local.shape))]
        rows["leaves"] += 1
        rows["sharded"] += any(type(p).__name__ == "Shard"
                               for p in ns.placements)
        rows["local_equal"] += bool(torch.equal(local, block))
        host = DTensor.from_local(local.cpu(), host_mesh,
                                  list(dt.placements), run_check=False,
                                  shape=dt.shape, stride=dt.stride())
        rows["full_equal"] += bool(torch.equal(host.full_tensor(),
                                               want.cpu()))
        rows["placements_requested"] += tuple(dt.placements) == \
            ns.placements
        rows["on_device"] += local.device == dev
        rows["local_bytes"] += local.numel() * local.element_size()
        rows["whole_bytes"] += want.numel() * want.element_size()
    res["relay"] = dict(rows, strategy=strategy, mesh=list(mesh.shape))
    res["relay_s"] = time.perf_counter() - t0
    del state, whole
    # the mesh Trainer: every rank trains the same steps; the mesh's first
    # rank writes each checkpoint
    saves, real_save = [], ckpt.save

    def counted(ckpt_dir, step, *args, **kw):
        saves.append(step)
        return real_save(ckpt_dir, step, *args, **kw)

    ckpt.save = counted
    t1 = time.perf_counter()
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=L1_SEQ,
                      global_batch=L1_BATCH)
    tcfg = TrainerConfig(ckpt_dir=str(out / "mesh_ckpt"),
                         ckpt_every=Q_TRAIN_STEPS + 1, grad_clip=L_GRAD_CLIP,
                         **L_SCHEDULE)
    trainer = Trainer(cfg, dcfg, tcfg, mesh=mesh, device=device)
    run = trainer.run(Q_TRAIN_STEPS, resume=False)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    res["train"] = {
        "losses": run["losses"], "restarts": run["restarts"],
        "final_step": run["final_step"], "saves": saves,
        "listing": sorted(p.name for p in (out / "mesh_ckpt").iterdir()),
        "pshard_is_strict": trainer._pshard == pshard,
        "wall_s": time.perf_counter() - t1}
    res["launches"] = launch_counts(kernels)
    res["s"] = time.perf_counter() - t0
    return res


def q2_start(spec: dict, tmp: str, world: int = 2) -> list:
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=q2_rank, args=(r, world, tmp, spec),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    return procs


def q2_finish(procs: list, tmp: str, one_device: list) -> dict:
    """Join Q2's ranks and hold their results: every block and
    ``full_tensor()`` equal to the one-device load, the placements the
    requested ones, some leaves sharded; the two ranks' losses bit-equal
    and within ``Q_TRAIN_RTOL`` of ``one_device`` (the one-device
    Trainer's on the card); one save per save step, by rank 0 only; no
    kernel launched."""
    import torch

    end = time.monotonic() + Q_DEADLINE_S
    try:
        for p in procs:
            p.join(max(end - time.monotonic(), 0.0))
        stalled = [r for r, p in enumerate(procs) if p.is_alive()]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    errors = {r: Path(tmp, f"rank{r}{ext}").read_text()
              for r in range(len(procs)) for ext in (".err", ".fault")
              if Path(tmp, f"rank{r}{ext}").exists()
              and Path(tmp, f"rank{r}{ext}").stat().st_size}
    if stalled or errors or any(p.exitcode for p in procs):
        fail(f"phase Q2: ranks stalled {stalled}, exit codes "
             f"{[p.exitcode for p in procs]}, errors {errors}")
    ranks = [torch.load(Path(tmp, f"rank{r}.pt"), weights_only=False)
             for r in range(len(procs))]
    for r, res in enumerate(ranks):
        rl = res["relay"]
        n = rl["leaves"]
        if not (rl["local_equal"] == rl["full_equal"] == n
                == rl["placements_requested"] == rl["on_device"]) \
                or rl["sharded"] == 0:
            fail(f"phase Q2 rank {r}: the re-lay {rl}")
        tr = res["train"]
        if tr["losses"] != ranks[0]["train"]["losses"]:
            fail(f"phase Q2: rank {r}'s losses {tr['losses']} differ from "
                 f"rank 0's {ranks[0]['train']['losses']}")
        gaps = [abs(a - b) / abs(b) for a, b in zip(tr["losses"],
                                                     one_device)]
        if len(gaps) != Q_TRAIN_STEPS or max(gaps) > Q_TRAIN_RTOL:
            fail(f"phase Q2 rank {r}: losses {tr['losses']} against the "
                 f"one-device Trainer's {one_device}")
        tr["max_rel_gap_vs_one_device"] = max(gaps)
        # the run's end saves once, on the mesh's first rank only
        want_saves = [Q_TRAIN_STEPS] if r == 0 else []
        if tr["saves"] != want_saves or tr["restarts"] \
                or not tr["pshard_is_strict"] \
                or tr["listing"] != [f"step_{Q_TRAIN_STEPS:08d}"]:
            fail(f"phase Q2 rank {r}: the mesh Trainer {tr}")
        if any(res["launches"].values()):
            fail(f"phase Q2 rank {r} launched a hand-written kernel: "
                 f"{res['launches']}")
    return {f"rank {r}": res for r, res in enumerate(ranks)}


def print_phase_q(q: dict, smi: str) -> None:
    for mesh, rows in q["Q1"]["meshes"].items():
        for arch, row in rows.items():
            print(f"phase Q1 {mesh} {arch}: {row['strategy']}, "
                  f"{row['sharded_leaves']} of {row['leaves']} leaves "
                  f"sharded, params {row['param_bytes'] / 1e9:.2f} GB, per "
                  f"rank {row['param_bytes_per_rank'] / 1e9:.3f} GB, its "
                  f"largest leaf block "
                  f"{row['largest_leaf_bytes_per_rank'] / 1e6:.1f} MB")
    tr = q["Q1"]["trainer"]
    print(f"phase Q1 Trainer({tr['config']} {tr['layers']} layers, "
          f"mesh={tr['mesh']}): _pshard covers every one of {tr['leaves']} "
          f"leaves, {tr['sharded_leaves']} sharded, "
          f"{json.dumps(tr['layout'])}")
    for r, res in q["Q2"].items():
        print(f"phase Q2 {r} ({smi}): re-lay {json.dumps(res['relay'])} in "
              f"{res['relay_s']:.1f} s (whole load {res['load_whole_s']:.1f}"
              f" s, re-laid {res['load_relaid_s']:.1f} s); mesh Trainer "
              f"{json.dumps(res['train'])}")
    print(f"phase Q: the one-device Trainer's losses (L3's straight run) "
          f"{q['one_device_losses']}, launches {q['launches']}")


# ---------------------------------------------------------------------------
# phase X: MoE's expert-parallel branch on two gloo ranks of the card (X1),
# the dry-run's cells under a fake process group (X2), the cost counter on
# arm A's first staged window (X3)
# ---------------------------------------------------------------------------

# X1: moonshot-v1-16b-a3b at its published widths (d 2048, 64 experts,
# top-6, moe_d_ff 1408, the shared expert), 2 layers drawn from the seed,
# on a (1, 2) (data, model) mesh: each rank holds its 32 experts (a DTensor
# block) and everything else whole; x and the tokens are plain tensors,
# every rank's same (the branch computes the rank's rows, sums the experts
# over ``model`` and returns the whole)
X_ARCH = "moonshot-v1-16b-a3b"
X_LAYERS = 2
X_SEED = 0
X_MOE = dict(batch=2, seq=256)  # (a): one MoE layer, float32
X_PREFILL = dict(batch=2, prompt=512)  # (b): the bf16 prefill through B6
X_DEADLINE_S = 300.0  # the parent kills X1's ranks past this
X_DECODE_TOL = dict(atol=3e-2, rtol=3e-2)  # the reference's bf16 tolerance
# X2: the cells at their published widths and depth on the (16, 16) mesh
X2_CELLS = (("moonshot-v1-16b-a3b", "train_4k"), ("qwen2.5-32b", "decode_32k"),
            ("cicero-dvgo", "render_800"))


def x_config(dtype: str = "bfloat16", dispatch: str = "einsum",
             widths: dict = None):
    """X1's config (``widths`` overrides the published widths: a rehearsal
    on the CPU)."""
    from repro_torch.configs import registry

    return registry.get(X_ARCH).with_(num_layers=X_LAYERS, dtype=dtype,
                                      moe_dispatch=dispatch,
                                      **(widths or {}))


def x_draws(dev, widths: dict = None) -> dict:
    """X1's inputs, drawn from ``X_SEED`` on ``dev`` (every process draws
    the same): one float32 MoE layer and its x, the bfloat16 model's params
    and the prefill's tokens."""
    import torch
    from repro_torch.models import lm, moe

    gen = lambda k: torch.Generator(device=dev).manual_seed(X_SEED + k)
    cfg32 = x_config("float32", widths=widths)
    b, s = X_MOE["batch"], X_MOE["seq"]
    return {"moe": moe.moe_init(gen(0), cfg32, torch.float32),
            "x": torch.randn((b, s, cfg32.d_model), generator=gen(1),
                             device=dev),
            "params": lm.init_params(x_config(widths=widths), gen(2),
                                     device=dev),
            "tokens": torch.randint(0, cfg32.vocab_size,
                                    (X_PREFILL["batch"], X_PREFILL["prompt"]),
                                    generator=gen(3), device=dev)}


def x_expert_blocks(layer: dict, mesh) -> dict:
    """A MoE layer's params with ``wg`` / ``wu`` / ``wd`` replaced by this
    rank's block over ``model`` (a DTensor; the whole tensors are
    dropped)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    out = dict(layer)
    m, tp = mesh.get_local_rank("model"), mesh.size(1)
    for w in ("wg", "wu", "wd"):
        t = layer[w]
        n = t.shape[0] // tp
        out[w] = DTensor.from_local(t[m * n:(m + 1) * n].clone(), mesh,
                                    [Replicate(), Shard(0)], run_check=False,
                                    shape=t.shape, stride=t.stride())
    return out


def x1_rank(rank: int, world: int, tmp: str, spec: dict) -> None:
    """One rank of X1 (a gloo group through a ``FileStore`` in ``tmp``):
    :func:`x1_checks`, its result (or traceback) saved to ``tmp``."""
    import datetime
    import os
    import traceback

    import torch
    import torch.distributed as dist

    out = Path(tmp)
    torch.set_num_threads(2)
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(out / "store"), world), rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=P_COLLECTIVE_TIMEOUT_S))
    try:
        torch.save(x1_checks(world, **spec), out / f"rank{rank}.pt")
        dist.barrier()
    except BaseException:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()
    os._exit(0)


def x1_checks(world: int, device=None, widths: dict = None) -> dict:
    """X1 on this rank, under the (1, ``world``) mesh on ``device`` (default:
    the card): (a) one float32 MoE layer in both dispatch modes; (b) the
    bf16 prefill (routing recorded, B6's launches and the expert-parallel
    bodies counted); (c) one decode tick after it, through the fallback.
    Outputs go back to the host."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import common, lm, moe

    dev = torch.device(device or "cuda")
    if dev.type == "cuda":
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    mesh = DeviceMesh(dev.type, torch.arange(world).reshape(1, world),
                      mesh_dim_names=("data", "model"))
    kernels = port_kernels()
    bodies, real = [0], moe._expert_parallel

    def counted(*a, **kw):
        bodies[0] += 1
        return real(*a, **kw)

    moe._expert_parallel = counted
    draws = x_draws(dev, widths)
    layer = x_expert_blocks(draws.pop("moe"), mesh)
    out = {"moe": {}}
    with torch.no_grad(), common.use_mesh(mesh):
        for mode in ("einsum", "streaming"):
            bodies[0] = 0
            y, aux = moe.moe(layer, draws["x"],
                             x_config("float32", mode, widths))
            out["moe"][mode] = {"out": y.cpu(), "aux": float(aux),
                                "bodies": bodies[0]}
    del layer
    params = draws["params"]
    params["layers"] = [dict(p, ffn=x_expert_blocks(p["ffn"], mesh))
                        for p in params["layers"]]
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["expert_bytes"] = sum(
        p["ffn"][w].to_local().numel() * p["ffn"][w].to_local().element_size()
        for p in params["layers"] for w in ("wg", "wu", "wd"))
    cfg = x_config(widths=widths)
    tokens = draws["tokens"]
    log = []
    for k in kernels:
        k.reset()
    with torch.no_grad(), common.use_mesh(mesh), routing(log, replay=False):
        bodies[0] = 0
        logits, caches = lm.make_prefill_step(
            cfg, X_PREFILL["prompt"] + 8)(params, {"tokens": tokens})
        out["prefill"] = {"logits": logits.float().cpu(),
                          "bodies": bodies[0],
                          "caches": [(c.k.cpu(), c.v.cpu()) for c in caches],
                          "b6": fa.launches_by_kernel()}
        token = logits.argmax(-1)[:, None]
        bodies[0] = 0
        logits_d, _ = lm.make_decode_step(cfg)(params, caches, token,
                                               X_PREFILL["prompt"])
        out["decode"] = {"logits": logits_d.float().cpu(), "token":
                         token.cpu(), "bodies": bodies[0]}
    out["launches"] = launch_counts(kernels)
    out["routing"] = [idx.cpu() for idx in log]
    out["max_memory_allocated"] = (torch.cuda.max_memory_allocated(dev)
                                   if dev.type == "cuda" else 0)
    moe._expert_parallel = real
    return out


def x1_start(tmp: str, world: int = 2, spec: dict = None) -> list:
    """X1's ranks, started with ``spawn`` (``spec``: :func:`x1_checks`'s
    keywords; default: the card at the published widths)."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=x1_rank, args=(r, world, tmp, spec or {}),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    return procs


def x1_finish(procs: list, tmp: str, dev, reset, counts,
              widths: dict = None) -> dict:
    """X1's checks: each rank's outputs against this process's one-device
    runs on the same draws. (a) within ``F32_TOL`` of the one-device
    dispatch, the branch's body run once a mode; (b) the rank's bf16
    prefill logits no further from the float64-attention prefill (every
    router call pinned to rank 0's expert ids, F2's rule) than 1.25x the
    one-device prefill's RMS distance (1.5x its max), the branch taken on
    every layer and B6 launched on each rank; (c) the decode tick (the
    fallback: no branch body) within ``X_DECODE_TOL`` of the one-device
    tick from rank 0's caches."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import lm, moe
    from repro_torch.models.attention import KVCache

    end = time.monotonic() + X_DEADLINE_S
    try:
        for p in procs:
            p.join(max(end - time.monotonic(), 0.0))
        stalled = [r for r, p in enumerate(procs) if p.is_alive()]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    world = len(procs)
    errors = {r: Path(tmp, f"rank{r}.err").read_text()
              for r in range(world) if Path(tmp, f"rank{r}.err").exists()}
    if stalled or errors or any(p.exitcode for p in procs):
        fail(f"phase X1: ranks stalled {stalled}, exit codes "
             f"{[p.exitcode for p in procs]}, errors {errors}")
    ranks = [torch.load(Path(tmp, f"rank{r}.pt"), weights_only=False)
             for r in range(world)]
    draws = x_draws(dev, widths)
    out = {"moe": {}, "ranks": {}}
    with torch.no_grad():
        for mode in ("einsum", "streaming"):
            y, aux = moe.moe(draws["moe"], draws["x"],
                             x_config("float32", mode, widths))
            y = y.cpu()
            for r, res in enumerate(ranks):
                got = res["moe"][mode]
                err = float((got["out"] - y).abs().max())
                if got["bodies"] != 1 or not torch.allclose(
                        got["out"], y, **F32_TOL) \
                        or abs(got["aux"] - float(aux)) > 1e-5:
                    fail(f"phase X1 (a) {mode} rank {r}: max abs err {err}, "
                         f"aux {got['aux']} vs {float(aux)}, branch bodies "
                         f"{got['bodies']}")
                out["moe"][f"{mode} rank {r}"] = {
                    "max_abs_err": err, "aux_err": abs(got["aux"]
                                                      - float(aux))}
        del draws["moe"], draws["x"]
        cfg, params, tokens = (x_config(widths=widths), draws["params"],
                               draws["tokens"])
        max_len = X_PREFILL["prompt"] + 8
        pinned = [t.to(dev) for t in ranks[0]["routing"]]
        n_moe = sum(1 for i in range(cfg.num_layers)
                    if cfg.layer_pattern[i % cfg.period].ffn == "moe")
        prefill_log, decode_log = pinned[:n_moe], pinned[n_moe:]

        def prefill(attend):
            real = fa.flash_attention
            fa.flash_attention = attend
            try:
                with routing(list(prefill_log), replay=True):
                    return lm.make_prefill_step(cfg, max_len)(
                        params, {"tokens": tokens})
            finally:
                fa.flash_attention = real

        reset()
        one, _ = prefill(fa.flash_attention)
        one_launches = counts()
        f64, _ = prefill(attention_reference)
        one, f64 = one.float().cpu(), f64.float().cpu()
        caches = [KVCache(k.to(dev), v.to(dev))
                  for k, v in ranks[0]["prefill"]["caches"]]
        token = ranks[0]["decode"]["token"].to(dev)
        with routing(list(decode_log), replay=True):
            one_d, _ = lm.make_decode_step(cfg)(params, caches, token,
                                                X_PREFILL["prompt"])
        one_d = one_d.float().cpu()
    for r, res in enumerate(ranks):
        pre, dec = res["prefill"], res["decode"]
        within = _logits_within(pre["logits"], one, f64, F_F2_LIMITS)
        d_err = float((dec["logits"] - one_d).abs().max())
        b6 = pre["b6"]
        if pre["bodies"] != n_moe or not within["logits_ok"] \
                or b6["prefill_mma"] != cfg.num_layers:
            fail(f"phase X1 (b) rank {r}: branch bodies {pre['bodies']} of "
                 f"{n_moe} layers, B6 {b6}, logits {within}")
        if dec["bodies"] != 0 or not torch.allclose(dec["logits"], one_d,
                                                    **X_DECODE_TOL):
            fail(f"phase X1 (c) rank {r}: branch bodies {dec['bodies']} "
                 f"(want 0: the fallback), decode logits max abs err "
                 f"{d_err}")
        out["ranks"][f"rank {r}"] = {
            "prefill_vs_f64": within, "decode_max_abs_err_vs_one_device":
            d_err, "branch_bodies_prefill": pre["bodies"],
            "b6_prefill_launches": b6, "expert_bytes_held":
            res["expert_bytes"], "max_memory_allocated":
            res["max_memory_allocated"], "launches": res["launches"]}
    whole = sum(p["ffn"][w].numel() * p["ffn"][w].element_size()
                for p in params["layers"] for w in ("wg", "wu", "wd"))
    out["expert_bytes_whole"] = whole
    if any(r["expert_bytes"] * world != whole for r in ranks):
        fail(f"phase X1: a rank holds {[r['expert_bytes'] for r in ranks]} "
             f"of the experts' {whole} bytes (want 1 / {world})")
    out["one_device_launches"] = one_launches
    return out


def x2_cells(device=None) -> dict:
    """X2's work, in a process of its own (it initializes the fake process
    group): the dry-run of each ``X2_CELLS`` cell on the (16, 16) mesh of
    the card's device type; their reports and the device memory the
    process allocated."""
    import torch

    from repro_torch.launch import dryrun

    out = {}
    for arch, shape in X2_CELLS:
        out[f"{arch} {shape}"] = dryrun.run_cell(arch, shape, "single",
                                                 device=device)
    dev = device or "cuda"
    out["device_memory_allocated"] = (
        torch.cuda.max_memory_allocated() if torch.device(dev).type == "cuda"
        else 0)
    return out


def x2_start(dev) -> subprocess.Popen:
    import os

    code = ("import json, chip_smoke; print(json.dumps(chip_smoke.x2_cells("
            f"{'None' if dev.type == 'cuda' else repr(str(dev))})))")
    return subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=dict(os.environ))


def x2_finish(proc: subprocess.Popen, q1: dict) -> dict:
    """X2's checks: every cell counted FLOPs; an LM cell's useful fraction
    in (0, 1]; the train cell's params a rank the bytes Q1 laid out for
    moonshot on (16, 16); no device memory allocated."""
    try:
        out, err = proc.communicate(timeout=X_DEADLINE_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        fail("phase X2: the subprocess passed its deadline")
    if proc.returncode != 0:
        fail(f"phase X2: the subprocess failed: {err[-3000:]}")
    lines = out.strip().splitlines()
    for line in lines[:-1]:
        print(f"phase X2 {line}")
    res = json.loads(lines[-1])
    for (arch, shape) in X2_CELLS:
        d = res[f"{arch} {shape}"]
        lm_cell = not arch.startswith("cicero-")
        if d["flops"] <= 0 or (lm_cell and not
                               0 < d["useful_flops_fraction"] <= 1):
            fail(f"phase X2 {arch} x {shape}: flops {d['flops']}, useful "
                 f"fraction {d['useful_flops_fraction']}")
    train = res["moonshot-v1-16b-a3b train_4k"]["param_bytes"]
    q1_row = q1["meshes"]["(16, 16)"]["moonshot-v1-16b-a3b"]
    if train != q1_row["param_bytes_per_rank"]:
        fail(f"phase X2: the train cell holds {train} param bytes a rank, "
             f"Q1 laid out {q1_row['param_bytes_per_rank']}")
    if res["device_memory_allocated"]:
        fail(f"phase X2: the dry-run allocated "
             f"{res['device_memory_allocated']} bytes of device memory")
    return res


def x3_window(dev, cfg, reset, counts) -> dict:
    """X3: the cost counter on arm A's first staged window (one session:
    the reference pose and the window's targets) on a fresh engine, and
    the same window on another fresh engine without it: the frames and
    holes bit-equal. The counter counts the ops that pass the dispatcher;
    the hand-written kernels launch through ``ctypes`` and are not among
    them (their launches are recorded)."""
    import torch

    from repro_torch import api
    from repro_torch.core.engine import DeviceSparwEngine
    from repro_torch.core.pipeline import orbit_trajectory
    from repro_torch.roofline import cost

    ren = api.make_renderer(cfg, device=dev)
    poses = [p.to(dev) for p in orbit_trajectory(32)[:cfg.window]]
    ref, tgt = poses[0][None], torch.stack(poses[1:])[None]
    engine = lambda: DeviceSparwEngine(ren.model, ren.params, config=cfg)
    engine().render_windows(ref, tgt).frames  # the cached constants
    reset()
    res, counted = cost.measure(engine().render_windows, ref, tgt)
    frames = res.frames
    launches = counts()
    plain = engine().render_windows(ref, tgt)
    equal = bool(torch.equal(frames, plain.frames)
                 and torch.equal(res.holes, plain.holes))
    n = tgt.shape[1]
    out = {"flops": counted["flops"], "bytes": counted["bytes"],
           "frames": n, "bytes_per_frame": cost.bytes_moved_per_frame(
               counted, n), "collectives": counted["coll_counts"],
           "kernel_launches": {k: v for k, v in launches.items() if v},
           "frames_bit_equal": equal}
    if not equal or counted["flops"] <= 0 or counted["bytes"] <= 0:
        fail(f"phase X3: {out}")
    return out


def print_phase_x(x: dict, smi: str) -> None:
    """Phase X's lines, each with the card's name and power limit."""
    x1 = x["X1"]
    for label, row in x1["moe"].items():
        print(f"phase X1 (a) MoE layer float32 {label}: {json.dumps(row)} "
              f"({smi})")
    for label, row in x1["ranks"].items():
        print(f"phase X1 {label}: {json.dumps(row)} ({smi})")
    print(f"phase X1 experts: {x1['expert_bytes_whole']:,} bytes whole, "
          f"one device's B6 launches {x1['one_device_launches']}")
    for cell, d in x["X2"].items():
        if isinstance(d, dict):
            print(f"phase X2 {cell}: flops/rank {d['flops']:.4e}, bytes/rank "
                  f"{d['bytes_accessed']:.4e}, collective bytes/rank "
                  f"{d['coll_weighted_bytes']:.4e} {d['coll_counts']}, args "
                  f"{d['arg_bytes']:,} B, params {d['param_bytes']:,} B, "
                  f"useful {d['useful_flops_fraction']:.4f}, dominant "
                  f"{d['dominant']}, roofline step "
                  f"{d['step_time_s'] * 1e3:.2f} ms, traced in "
                  f"{d['trace_s']} s")
    print(f"phase X2 device memory allocated: "
          f"{x['X2']['device_memory_allocated']}")
    print(f"phase X3 arm A's first staged window: {json.dumps(x['X3'])} "
          f"({smi})")


def window_spy(renderer) -> list:
    """Record each window the renderer's device engine renders: its pool
    buckets, hole counts and fine counts (device tensors, read after the
    run by :func:`read_windows`)."""
    eng = renderer.pipeline.device_engine
    log = []
    inner = eng.render_window

    def spy(ref_pose, tgt):
        buckets = eng._current_buckets()
        res = inner(ref_pose, tgt)
        log.append((buckets, res.hole_counts, res.fine_counts))
        return res

    eng.render_window = spy
    return log


def read_windows(log: list) -> list:
    return [(b, h.tolist(), f.tolist()) for b, h, f in log]


# the render arms' CPU reference runs (the port's plain path on the same
# poses) run in a worker process of their own, submitted at the start, so
# that they overlap the card's arms instead of following each of them
CPU_WORKER_SPARE_CORES = 2  # left to this process's host-bound launches


def cpu_worker_init() -> None:
    import os

    import torch

    torch.set_num_threads(max(1, (os.cpu_count() or 1)
                              - CPU_WORKER_SPARE_CORES))


def cpu_reference(job: dict) -> dict:
    """One CPU reference run, in the worker: ``job["cfg"]``'s renderer on
    the CPU (``job["model"]``: ``make_model``'s keywords, with
    ``job["np_params"]``; else the config's baked model) renders
    ``job["poses"]`` or serves ``job["fleet"]``; ``job["spy"]`` records its
    windows (:func:`window_spy`). Returns the render's result (or the
    served results and metrics), the windows and the wall seconds."""
    from repro_torch import api
    from repro_torch.convert import params_from_numpy
    from repro_torch.core.config import RenderRequest
    from repro_torch.nerf import models

    if "scenes" in job:
        return arm_e_cpu(job)
    extra = {}
    if "model" in job:
        model, _ = models.make_model(**job["model"])
        extra = dict(model=model,
                     params=params_from_numpy(job["np_params"], "cpu"))
    ren = api.make_renderer(job["cfg"], device="cpu", **extra)
    spy = window_spy(ren) if job.get("spy") else None
    t0 = time.perf_counter()
    if "fleet" in job:
        results, metrics = ren.serve(job["fleet"])
        out = {"results": results, "metrics": metrics}
    else:
        out = {"result": ren.render(RenderRequest(poses=tuple(job["poses"])))}
    out["wall_s"] = time.perf_counter() - t0
    if spy is not None:
        out["windows"] = read_windows(spy)
    return out


def arm_e_cpu(job: dict) -> dict:
    """Arm E's CPU run, in the worker: ``job["scenes"]`` = (sessions,
    frames) of :func:`arm_e_sessions` served by ``job["cfg"]``'s CPU
    renderer with a scene loader baking on the CPU, every tick's warp
    recorded (:func:`c2_warps`). Returns the sessions (their stats and
    frames), the warps, the run's metrics and the wall seconds."""
    from types import SimpleNamespace

    from repro_torch import api
    from repro_torch.nerf import scenes
    from repro_torch.serve.render_engine import RenderServeEngine

    cfg = job["cfg"]
    t0 = time.perf_counter()
    ren = api.make_renderer(cfg, device="cpu")
    eng = RenderServeEngine(
        ren.model, ren.params, config=ren.config,
        scene_loader=lambda name: scenes.bake_dense_table(
            scenes.make_scene(name), cfg.grid_res, cfg.channels,
            device="cpu"))
    sessions = arm_e_sessions(*job["scenes"])
    warps, metrics = c2_warps(eng, sessions)
    keep = ("frames", "reference_renders", "warped_pixels", "sparse_pixels",
            "fallback_pixels", "total_pixels")
    return {"sessions": [SimpleNamespace(
        sid=g.sid, scene=g.scene, frames=list(g.frames),
        stats=SimpleNamespace(**{k: getattr(g.stats, k) for k in keep}))
        for g in sessions], "warps": warps, "metrics": metrics,
        "wall_s": time.perf_counter() - t0}


def start_cpu_references(jobs: dict):
    """A one-worker ``spawn`` pool running :func:`cpu_reference` on each of
    ``jobs`` in order: (the pool, name -> its ``AsyncResult``). The pool
    is terminated at exit."""
    import multiprocessing as mp

    pool = mp.get_context("spawn").Pool(1, initializer=cpu_worker_init)
    atexit.register(pool.terminate)
    return pool, {name: pool.apply_async(cpu_reference, (job,))
                  for name, job in jobs.items()}


def main() -> int:
    import math

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    from repro_torch import api
    from repro_torch.convert import params_from_numpy
    from repro_torch.core import streaming
    from repro_torch.core.config import RenderConfig, RenderRequest
    from repro_torch.core.engine import DeviceSparwEngine
    from repro_torch.core.pipeline import orbit_trajectory
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import flash_attention as fa_k
    from repro_torch.kernels import fused_nerf_mlp as mlp_k
    from repro_torch.kernels import gather_trilerp as gt_k
    from repro_torch.kernels import streaming_pipeline as sp_k
    from repro_torch.nerf import mlp, models, rays, scenes
    from repro_torch.serve.render_engine import RenderServeEngine, \
        RenderSession
    from repro_torch.utils import psnr

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kernels = port_kernels()
    phase_s = {}
    clock = [time.perf_counter()]

    def phase_done(name):
        now = time.perf_counter()
        phase_s[name] = now - clock[0]
        clock[0] = now
        print(f"phase {name}: {phase_s[name]:.1f} s", flush=True)

    # 1. the card ----------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"device: {kind} (count {torch.cuda.device_count()})")
    print(f"nvidia-smi: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    phase_done("card")

    # 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    _build.build_all(kernels)
    print(f"build: {time.perf_counter() - t0:.1f} s for "
          f"{', '.join(k.name for k in kernels)}")
    for k in kernels:
        for line in k.log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {k.name}: {line.strip()}")
    # B2 must run on the tensor cores: its SASS holds TF32 HMMAs
    sass = subprocess.run(
        [str(Path(_build.nvcc()).parent / "cuobjdump"), "-sass",
         str(mlp_k.KERNEL.library)], capture_output=True, text=True,
        check=True).stdout.splitlines()
    b2_hmma = [line.split("*/")[1].split(";")[0].strip() for line in sass
               if "HMMA" in line and "TF32" in line]
    print(f"B2 SASS (cuobjdump): {len(b2_hmma)} TF32 HMMA instructions, "
          f"e.g. {b2_hmma[0] if b2_hmma else None}")
    if not b2_hmma:
        fail("B2's SASS holds no TF32 HMMA: it does not use the tensor cores")

    phase_done("build")

    # main-path inputs: the first reference chunk of each arm (the staged
    # engine renders a res-64 reference in chunks of ceil(4096 / 2) rays)
    cam = rays.Camera.square(64)
    poses = orbit_trajectory(32)
    chunk = 2048

    def chunk_points(pose_list, num_samples):
        o, d = rays.generate_rays_batch(cam, torch.stack(pose_list).to(dev))
        o, d = o[:, :chunk].reshape(-1, 3), d[:, :chunk].reshape(-1, 3)
        pts, _ = rays.sample_along_rays(o, d, 0.5, 6.0, num_samples)
        return pts.reshape(-1, 3), d.repeat_interleave(num_samples, dim=0)

    cfg_a = RenderConfig(backend="streaming")
    cfg_c = cfg_a.replace(fused_tick=True)
    model_b, cfg_b_model = models.make_model("dvgo", backend="streaming",
                                             decoder="mlp")
    np_params_b = arm_b_params(0)
    params_b = params_from_numpy(np_params_b, dev)
    cfg_b = RenderConfig(backend="streaming", decoder="mlp", grid_res=64,
                         channels=8, num_samples=64)
    cfg_d = cfg_b.replace(fused_tick=True, num_slots=4)
    cfg_e = cfg_c.replace(num_slots=4)
    # the CPU reference runs of arms A, B, B48, C, D, D adaptive (its first
    # session's first window), E and G, in the arms' order, beside the card
    model_b_kw = dict(kind="dvgo", backend="streaming", decoder="mlp")
    d_fleet = [RenderRequest(poses=tuple(orbit_trajectory(
        32, phase_deg=25.0 * i))) for i in range(6)]
    cfg_d_adaptive = cfg_d.replace(fused_tick=False, adaptive_sampling=True)
    cfg_g = cfg_a.replace(adaptive_sampling=True, coarse_factor=4)
    _cpu_pool, cpu_refs = start_cpu_references({
        "A": dict(cfg=cfg_a, poses=orbit_trajectory(32)),
        "B": dict(cfg=cfg_b, poses=orbit_trajectory(16), model=model_b_kw,
                  np_params=np_params_b),
        "B48": dict(cfg=cfg_b, poses=orbit_trajectory(8),
                    model=dict(model_b_kw, mlp_hidden=48),
                    np_params=arm_b_params(0, hidden=48)),
        "C": dict(cfg=cfg_c, poses=orbit_trajectory(32)),
        "D": dict(cfg=cfg_d, fleet=d_fleet, model=model_b_kw,
                  np_params=np_params_b),
        "D adaptive": dict(cfg=cfg_d_adaptive,
                           poses=d_fleet[0].poses[:cfg_d.window],
                           model=model_b_kw, np_params=np_params_b,
                           spy=True),
        "E": dict(cfg=cfg_e, scenes=(12, 32)),
        "G": dict(cfg=cfg_g, poses=orbit_trajectory(32), spy=True)})
    arm_i_models = {n: arm_i_model(n, dev) for n in ARM_I_CONFIGS}

    def scene_loader(device):
        return lambda name: scenes.bake_dense_table(
            scenes.make_scene(name), cfg_e.grid_res, cfg_e.channels,
            device=device)

    def scene_engine(renderer, **cfg_kw):
        return RenderServeEngine(
            renderer.model, renderer.params,
            config=renderer.config.replace(**cfg_kw),
            scene_loader=scene_loader(renderer.device))

    # 3. kernels against their plain versions -----------------------------
    errs = {"B1": 0.0, "B1_bf16": 0.0, "B2": 0.0, "B3": 0.0, "B3_bf16": 0.0,
            "B3_vs_B1": 0.0, "B4": 0.0, "B4_bf16": 0.0, "B5": 0.0,
            "B5_bf16": 0.0}
    b3_bit_equal = True  # B3 against two B1 launches
    b3_plain_equal = True  # B3 against its plain version
    b1_bit_equal = True
    shapes = {}

    def b1_check(label, tbl, ids, w, num_seg):
        """B1 against its plain version, within the tolerance and bit for
        bit (the same arithmetic)."""
        nonlocal b1_bit_equal
        got = gt_k.gather_trilerp_mvoxels_segmented(tbl, ids, w,
                                                    num_seg=num_seg)
        want = gt_k.gather_trilerp_plain(tbl, ids, w, num_seg)
        bf = tbl.dtype == torch.bfloat16
        key = "B1_bf16" if bf else "B1"
        errs[key] = max(errs[key], check_close(
            f"B1 {label} table {tuple(tbl.shape)} ids {tuple(ids.shape)}",
            got, want, BF16_TOL if bf else F32_TOL))
        b1_bit_equal &= bool(torch.equal(got, want))

    def b3_check(label, t, ih, wh, ir, wr, ns):
        """B3 against its plain version and against two B1 launches on
        the same blocks, within the tolerance and bit for bit."""
        nonlocal b3_bit_equal, b3_plain_equal
        bf = t.dtype == torch.bfloat16
        tol = BF16_TOL if bf else F32_TOL
        name = (f"B3 {label} {'bf16' if bf else 'f32'} num_seg={ns} table "
                f"{tuple(t.shape)} holes {tuple(ih.shape)} refs "
                f"{tuple(ir.shape)}")
        got = sp_k.fused_gather_dual(t, ih, wh, ir, wr, num_seg=ns)
        want = sp_k.fused_gather_dual_plain(t, ih, wh, ir, wr, ns)
        b1 = (gt_k.gather_trilerp_mvoxels_segmented(t, ih, wh, num_seg=ns),
              gt_k.gather_trilerp_mvoxels_segmented(t, ir, wr, num_seg=ns))
        key = "B3_bf16" if bf else "B3"
        for part, g, w, o in zip(("holes", "refs"), got, want, b1):
            errs[key] = max(errs[key], check_close(f"{name} {part}", g, w,
                                                   tol))
            errs["B3_vs_B1"] = max(errs["B3_vs_B1"], check_close(
                f"{name} {part} vs B1", g, o, tol))
            b3_plain_equal &= bool(torch.equal(g, w))
            b3_bit_equal &= bool(torch.equal(g, o))

    for layout in ("identity", "bank_interleaved"):
        ren = api.make_renderer(cfg_a.replace(mvoxel_layout=layout))
        scfg = ren.model.streaming_cfg
        mv_f32 = ren.params["mv_table"]
        for num_seg in (1, 4):
            pts, _ = chunk_points(poses[:num_seg], cfg_a.num_samples)
            seg = (torch.arange(num_seg, device=dev)
                   .repeat_interleave(chunk * cfg_a.num_samples))
            blocks = ops.rit_blocks(pts, scfg, seg=seg, num_seg=num_seg)
            for tag, tbl in (("f32", mv_f32),
                             ("bf16", mv_f32.to(torch.bfloat16))):
                args = (tbl, blocks.ids, blocks.weights)
                b1_check(f"{layout} {tag} num_seg={num_seg}", *args,
                         blocks.num_seg)
                if num_seg == 1 and tag == "f32":
                    shapes[f"B1_A {layout}"] = args
        # B3 on the blocks a fused tick of arm C's config builds
        eng_c = DeviceSparwEngine(ren.model, ren.params,
                                  config=cfg_c.replace(mvoxel_layout=layout))
        for num_seg in (1, 4):
            (tbl, ih, wh, ir, wr), ns = capture_b3_inputs(eng_c, num_seg)
            for t in (tbl, tbl.to(torch.bfloat16)):
                b3_check(layout, t, ih, wh, ir, wr, ns)
            if layout == "identity" and num_seg == 1:
                shapes["B3_C"] = ((tbl, ih, wh, ir, wr), ns)
    pts_b, dirs_b = chunk_points(poses[:1], cfg_b_model.num_samples)
    scfg_b = model_b.streaming_cfg
    prepared_b = model_b.prepare_streaming(params_b)
    blocks_b = ops.rit_blocks(pts_b, scfg_b)
    shapes["B1_B"] = (prepared_b["mv_table"], blocks_b.ids, blocks_b.weights)
    for tag, tbl in (("f32", prepared_b["mv_table"]),
                     ("bf16", prepared_b["mv_table"].to(torch.bfloat16))):
        b1_check(f"arm-B identity {tag}", tbl, *shapes["B1_B"][1:], 1)
    # the reference's four shapes: C = 12 and 16 run the run-time-C code,
    # caps 64 and 128 CTAs of 64 and 128 threads, and the edge-16 C = 12
    # block (235,824 B in fp32) is read in place
    for res, edge, cap, n, c in B1_REF_SHAPES:
        rng = np.random.default_rng(res + n)
        scfg_r = streaming.StreamingCfg(grid_res=res, mvoxel_edge=edge,
                                        capacity=cap)
        table = torch.as_tensor(rng.standard_normal((res**3, c)),
                                dtype=torch.float32, device=dev)
        pts = torch.as_tensor(rng.uniform(-1.0, 1.0, (n, 3)),
                              dtype=torch.float32, device=dev)
        blocks = ops.rit_blocks(pts, scfg_r)
        mv = streaming.build_mvoxel_table(table, scfg_r)
        for tag, tbl in (("f32", mv), ("bf16", mv.to(torch.bfloat16))):
            b1_check(f"reference shape res {res} edge {edge} cap {cap} "
                     f"C {c} {tag}", tbl, blocks.ids, blocks.weights, 1)
    print(f"B1 bit-equal to its plain version on every block: "
          f"{b1_bit_equal}")
    if not b1_bit_equal:
        fail("B1 differs from its plain version (the same arithmetic)")
    feats_b = ops.gather_features_streaming(
        params_b["table"], pts_b, scfg_b, mv_table=prepared_b["mv_table"])
    dec = params_b["decoder"]
    mlp_args = (feats_b, mlp._dir_enc(dirs_b), dec["w1"], dec["b1"],
                dec["w2"], dec["b2"], dec["w_sigma"], dec["w_rgb"],
                dec["b_rgb"])
    shapes["B2"] = mlp_args
    errs["B2"] = check_close(
        f"B2 C=8 H=64 S={feats_b.shape[0]}", mlp_k.fused_nerf_mlp(*mlp_args),
        mlp_k.fused_nerf_mlp_plain(*mlp_args), F32_TOL)
    # one pooled-fill chunk of arm B (64 rays x 64 samples), and the
    # reference's three shapes at its initializer's scales
    fill = 64 * cfg_b_model.num_samples
    fill_args = (mlp_args[0][:fill], mlp_args[1][:fill]) + mlp_args[2:]
    b2_cases = [(f"C=8 H=64 S={fill} (one pooled-fill chunk)", fill_args)]
    b2_cases += [(f"C={c} H={h} S={n} (reference shape)",
                  mlp_ref_inputs(n, c, h, dev)) for n, c, h in B2_REF_SHAPES]
    for label, a in b2_cases:
        errs["B2"] = max(errs["B2"], check_close(
            f"B2 {label}", mlp_k.fused_nerf_mlp(*a),
            mlp_k.fused_nerf_mlp_plain(*a), F32_TOL))
    # C5: the widths the templates do not take as they are, each through
    # the route mlp_plan gives it (the entry point's count shows which)
    c5 = {}
    errs["B2_C5"] = 0.0
    for c, h in C5_SHAPES:
        a = mlp_ref_inputs(C5_ROWS, c, h, dev, seed=c + h, biases=True)
        plan = mlp_k.mlp_plan(c, h, 9)
        before = dict(mlp_k.KERNEL.entry_launches)
        got = mlp_k.fused_nerf_mlp(*a)
        torch.cuda.synchronize()
        entry = [e for e, n in mlp_k.KERNEL.entry_launches.items()
                 if n != before[e]]
        want_entry = ("fused_nerf_mlp_f32" if plan.mode == "tensor"
                      else "fused_nerf_mlp_rt_f32")
        if entry != [want_entry]:
            fail(f"B2 C5 [{c}, {h}]: launched {entry}, plan {plan}")
        err = check_close(f"B2 C5 C={c} H={h} S={C5_ROWS} ({plan.mode}, "
                          f"width {plan.width}, tile {plan.tile}, smem "
                          f"{plan.smem} B)", got,
                          mlp_k.fused_nerf_mlp_plain(*a), F32_TOL)
        errs["B2_C5"] = max(errs["B2_C5"], err)
        c5[(c, h)] = {"args": a, "plan": plan._asdict(), "entry": entry[0],
                      "max_abs_err": err}
    if [c5[k]["plan"]["mode"] for k in C5_SHAPES] != \
            ["tensor", "tensor", "runtime", "runtime"]:
        fail(f"B2 C5 routes: {[c5[k]['plan'] for k in C5_SHAPES]}")
    errs["B2"] = max(errs["B2"], errs["B2_C5"])
    # arm I: the paper's configs at full width on one real reference chunk
    # (2048 rays x 192 samples): B1 at cicero-dvgo's block [8000, 729, 12]
    # with that chunk's ids, B2 at C = 12, 16 (NGP) and 27 (TensoRF), H = 64
    # on its first 131,072 samples, on each model's own weights
    pts_i, dirs_i = chunk_points(poses[:1], 192)
    b2_i = {}
    for name, (model, params) in arm_i_models.items():
        prepared = model.prepare_streaming(params)
        if model.cfg.kind == "dvgo":
            blocks = ops.rit_blocks(pts_i, model.streaming_cfg)
            shapes["B1_I"] = (prepared["mv_table"], blocks.ids,
                              blocks.weights)
            b1_check(f"arm-I {name}", *shapes["B1_I"], 1)
        feats = model.query_features(prepared, pts_i[:C5_ROWS])
        dec = prepared["decoder"]
        a = (feats, mlp._dir_enc(dirs_i[:C5_ROWS]), dec["w1"], dec["b1"],
             dec["w2"], dec["b2"], dec["w_sigma"], dec["w_rgb"],
             dec["b_rgb"])
        b2_i[name] = a
        errs["B2"] = max(errs["B2"], check_close(
            f"B2 arm-I {name} C={feats.shape[1]} H={dec['w1'].shape[1]} "
            f"S={feats.shape[0]}", mlp_k.fused_nerf_mlp(*a),
            mlp_k.fused_nerf_mlp_plain(*a), F32_TOL))
    print(f"B1 bit-equal at arm I's cicero-dvgo block: {b1_bit_equal}")
    if not b1_bit_equal:
        fail("B1 differs from its plain version at arm I's block")
    # B3 at arm D's shape: a 4-session fused tick of arm B's model
    eng_d = DeviceSparwEngine(model_b, params_b, config=cfg_d)
    (tbl, ih, wh, ir, wr), ns = capture_b3_inputs(eng_d, 4)
    shapes["B3_D"] = ((tbl, ih, wh, ir, wr), ns)
    for t in (tbl, tbl.to(torch.bfloat16)):
        b3_check("arm-D identity", t, ih, wh, ir, wr, ns)
    # B3 at the reference's shapes (tests/test_streaming_pipeline.py: grid
    # 16, edge 8, C = 4, caps 128 / 256 and 32 / 64: CTAs of 256 and 64
    # threads), then at blocks too large to stage, read in place: the
    # edge-16, C = 12 block in fp32 (235,824 B) and [729, 80] in fp32
    # (233,280 B; its bf16 copy is staged)
    b3_cases = [(16, 8, 128, 4, 600), (16, 8, 32, 4, 600),
                (48, 16, 512, 12, 20000), (48, 8, 512, 80, 150000)]
    for res, edge, cap, c, n in b3_cases:
        rng = np.random.default_rng(res + cap + c)
        table = torch.as_tensor(rng.standard_normal((res**3, c)),
                                dtype=torch.float32, device=dev)
        pts = torch.as_tensor(rng.uniform(-1.0, 1.0, (n, 3)),
                              dtype=torch.float32, device=dev)
        seg = torch.zeros(n, dtype=torch.int32, device=dev)
        layouts = ("identity", "bank_interleaved") if res == 16 \
            else ("identity",)
        for layout in layouts:
            scfg_r = streaming.StreamingCfg(grid_res=res, mvoxel_edge=edge,
                                            capacity=cap, layout=layout)
            bh = sp_k._rit_blocks(pts, seg, 1, scfg_r)
            br = sp_k._rit_blocks(pts, seg, 1, dataclasses.replace(
                scfg_r, capacity=2 * cap))
            mv = streaming.build_mvoxel_table(table, scfg_r)
            args = (bh.ids_mv, bh.w_mv, br.ids_mv, br.w_mv)
            label = (f"reference shape res {res} edge {edge} caps {cap}/"
                     f"{2 * cap} C {c} {layout}")
            for t in (mv, mv.to(torch.bfloat16)):
                b3_check(label, t, *args, 1)
            if res == 48:
                shapes[f"B3_in_place C{c}"] = ((mv,) + args, 1)
    print(f"B3 bit-equal to its plain version at every checked shape: "
          f"{b3_plain_equal}; to two B1 launches: {b3_bit_equal}")
    if not (b3_plain_equal and b3_bit_equal):
        fail("B3 differs from its plain version or from two B1 launches "
             "on the same blocks")
    # B4 and B5 on the blocks arm E's first mixed-scene tick builds; each
    # segment's rows also against B1 / B3 run on that segment's page
    per_seg_bit_equal = True
    for layout in ("identity", "bank_interleaved"):
        eng = scene_engine(api.make_renderer(
            cfg_e.replace(mvoxel_layout=layout)))
        (b4_args, ns4), (b5_args, ns5) = capture_scened_inputs(
            eng, arm_e_sessions(4, cfg_e.window))
        pages, scn = b4_args[0], b4_args[1]
        num_mv = pages.shape[1]
        page_of = scn.tolist()  # read here, for the check; a tick never does
        seg_rows = [slice(s * num_mv, (s + 1) * num_mv) for s in range(ns4)]
        for tag, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            tol = BF16_TOL if tag == "bf16" else F32_TOL
            key = "B4_bf16" if tag == "bf16" else "B4"
            tbl = pages.to(dt)
            ids, w = b4_args[2], b4_args[3]
            name = (f"B4 {layout} {tag} num_seg={ns4} pages "
                    f"{tuple(tbl.shape)} map {page_of} ids {tuple(ids.shape)}")
            got = gt_k.gather_trilerp_mvoxels_per_seg(tbl, scn, ids, w,
                                                      num_seg=ns4)
            errs[key] = max(errs[key], check_close(
                name, got, gt_k.gather_trilerp_per_seg_plain(
                    tbl, scn, ids, w, ns4), tol))
            for rows, page in zip(seg_rows, page_of):
                per_seg_bit_equal &= bool(torch.equal(
                    got[rows], gt_k.gather_trilerp_mvoxels_segmented(
                        tbl[page], ids[rows], w[rows], num_seg=1)))
            key = "B5_bf16" if tag == "bf16" else "B5"
            ih, wh, ir, wr = b5_args[2:]
            name = (f"B5 {layout} {tag} num_seg={ns5} pages "
                    f"{tuple(tbl.shape)} map {page_of} holes "
                    f"{tuple(ih.shape)} refs {tuple(ir.shape)}")
            got = sp_k.fused_gather_dual_per_seg(tbl, scn, ih, wh, ir, wr,
                                                 num_seg=ns5)
            want = sp_k.fused_gather_dual_per_seg_plain(tbl, scn, ih, wh, ir,
                                                        wr, ns5)
            for part, g, wt in zip(("holes", "refs"), got, want):
                errs[key] = max(errs[key], check_close(
                    f"{name} {part}", g, wt, tol))
            for rows, page in zip(seg_rows, page_of):
                b3 = sp_k.fused_gather_dual(tbl[page], ih[rows], wh[rows],
                                            ir[rows], wr[rows], num_seg=1)
                per_seg_bit_equal &= all(bool(torch.equal(g[rows], o))
                                         for g, o in zip(got, b3))
            if layout == "identity" and tag == "f32":
                shapes["B4_E"] = (b4_args, ns4)
                shapes["B5_E"] = (b5_args, ns5)
    # B4 and B5 under more maps that work their second buffer (the
    # captured map, a restage at every segment, is checked above), on arm
    # E's captured rows (segment s of a map takes the captured segment s
    # mod num_seg): no restage, alternation over 8 segments, an invalid
    # page (-1, then K) between valid ones, one segment
    b4_args, ns4 = shapes["B4_E"]
    b5_args, ns5 = shapes["B5_E"]
    pages = b4_args[0]
    k_pages, num_mv = pages.shape[0], pages.shape[1]
    page_maps = {"all page 0": [0] * ns4, "alternating": [0, 1] * 4,
                 "-1 between valid": [0, -1, 1, 2],
                 "K between valid": [1, k_pages, 1, 0], "one segment": [2]}
    seg_of = lambda x, s: x[s * num_mv:(s + 1) * num_mv]
    b4_map_checks, b5_map_checks = {}, {}
    for label, page_map in page_maps.items():
        ns = len(page_map)
        rows_of = lambda x, n: torch.cat([seg_of(x, s % n)
                                          for s in range(ns)])
        ids_m, w_m = rows_of(b4_args[2], ns4), rows_of(b4_args[3], ns4)
        sets_m = [rows_of(x, ns5) for x in b5_args[2:]]
        scn_m = torch.tensor(page_map, dtype=torch.int32, device=dev)
        for tag, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            tol = BF16_TOL if tag == "bf16" else F32_TOL
            tbl = pages.to(dt)
            got = gt_k.gather_trilerp_mvoxels_per_seg(tbl, scn_m, ids_m, w_m,
                                                      num_seg=ns)
            key = "B4_bf16" if tag == "bf16" else "B4"
            errs[key] = max(errs[key], check_close_nan(
                f"B4 {tag} map {page_map} ({label}) ids "
                f"{tuple(ids_m.shape)}", got,
                gt_k.gather_trilerp_per_seg_plain(tbl, scn_m, ids_m, w_m, ns),
                tol))
            got5 = sp_k.fused_gather_dual_per_seg(tbl, scn_m, *sets_m,
                                                  num_seg=ns)
            want5 = sp_k.fused_gather_dual_per_seg_plain(tbl, scn_m, *sets_m,
                                                         ns)
            key = "B5_bf16" if tag == "bf16" else "B5"
            for part, g, wt in zip(("holes", "refs"), got5, want5):
                errs[key] = max(errs[key], check_close_nan(
                    f"B5 {tag} map {page_map} ({label}) {part} "
                    f"{tuple(g.shape)}", g, wt, tol))
            equal4 = equal5 = True
            for s, page in enumerate(page_map):
                if 0 <= page < k_pages:
                    equal4 &= bool(torch.equal(
                        seg_of(got, s), gt_k.gather_trilerp_mvoxels_segmented(
                            tbl[page], seg_of(ids_m, s), seg_of(w_m, s),
                            num_seg=1)))
                    b3 = sp_k.fused_gather_dual(
                        tbl[page], *(seg_of(x, s) for x in sets_m),
                        num_seg=1)
                    equal5 &= all(bool(torch.equal(seg_of(g, s), o))
                                  for g, o in zip(got5, b3))
                else:
                    equal4 &= bool(torch.isnan(seg_of(got, s)).all())
                    equal5 &= all(bool(torch.isnan(seg_of(g, s)).all())
                                  for g in got5)
            b4_map_checks[f"{label} {tag}"] = equal4
            b5_map_checks[f"{label} {tag}"] = equal5
            per_seg_bit_equal &= equal4 and equal5
    print(f"B4 under each map, bit-equal to B1 on each valid page and NaN "
          f"on the invalid: {json.dumps(b4_map_checks)}")
    print(f"B5 under each map, bit-equal to B3 on each valid page and NaN "
          f"on the invalid: {json.dumps(b5_map_checks)}")
    print(f"B4 / B5 bit-equal to B1 / B3 on each segment's page: "
          f"{per_seg_bit_equal}")
    if not per_seg_bit_equal:
        fail("B4 or B5 differs from B1 / B3 run on a segment's page")
    # B4 and B5 at the shapes C4 was about, where the old kernels raised:
    # arm E's captured map and rows on pages rebuilt at C = 40 (fp32: two
    # blocks exceed shared memory, read in place) and C = 36 (bf16: staged,
    # run-time C over 32), and three pages of the edge-16, C = 12 block (in
    # place in both dtypes); each under its captured map and one with -1.
    # Bit-equal to the plain versions (NaN at the same places) and to B1 /
    # B3 on each valid page, NaN exactly on the invalid segment's rows
    gen4 = torch.Generator(device=dev).manual_seed(4)
    same = lambda a, b: bool(torch.equal(torch.isnan(a), torch.isnan(b))
                             and torch.equal(a.nan_to_num(), b.nan_to_num()))
    c4_checks = {}

    def per_seg_c4(label, pages, maps, b4_rows, b5_rows, ns):
        tol = BF16_TOL if pages.dtype == torch.bfloat16 else F32_TOL
        key = "_bf16" if pages.dtype == torch.bfloat16 else ""
        seg_rows = lambda x, s: x[s * pages.shape[1]:(s + 1) * pages.shape[1]]
        for page_map in maps:
            scn_m = torch.tensor(page_map, dtype=torch.int32, device=dev)
            name = (f"{label} pages {tuple(pages.shape)} "
                    f"{str(pages.dtype)[6:]} map {page_map}")
            got4 = gt_k.gather_trilerp_mvoxels_per_seg(pages, scn_m, *b4_rows,
                                                       num_seg=ns)
            want4 = gt_k.gather_trilerp_per_seg_plain(pages, scn_m, *b4_rows,
                                                      ns)
            got5 = sp_k.fused_gather_dual_per_seg(pages, scn_m, *b5_rows,
                                                  num_seg=ns)
            want5 = sp_k.fused_gather_dual_per_seg_plain(pages, scn_m,
                                                         *b5_rows, ns)
            errs["B4" + key] = max(errs["B4" + key], check_close_nan(
                f"B4 {name}", got4, want4, tol))
            for part, g, wt in zip(("holes", "refs"), got5, want5):
                errs["B5" + key] = max(errs["B5" + key], check_close_nan(
                    f"B5 {name} {part}", g, wt, tol))
            equal = same(got4, want4) and all(
                same(g, wt) for g, wt in zip(got5, want5))
            for s, page in enumerate(page_map):
                if 0 <= page < pages.shape[0]:
                    b1 = gt_k.gather_trilerp_mvoxels_segmented(
                        pages[page], *(seg_rows(x, s) for x in b4_rows),
                        num_seg=1)
                    b3 = sp_k.fused_gather_dual(
                        pages[page], *(seg_rows(x, s) for x in b5_rows),
                        num_seg=1)
                    equal &= bool(torch.equal(seg_rows(got4, s), b1)) and all(
                        bool(torch.equal(seg_rows(g, s), o))
                        for g, o in zip(got5, b3))
                else:
                    equal &= all(bool(torch.isnan(seg_rows(g, s)).all())
                                 for g in (got4,) + tuple(got5))
            c4_checks[name] = equal

    k_pages, num_mv, p_e = pages.shape[:3]
    map_e = b4_args[1].tolist()
    maps_e = [map_e, [map_e[0], -1] + map_e[2:]]
    for c, dt in ((40, torch.float32), (36, torch.bfloat16)):
        pages_c = torch.randn((k_pages, num_mv, p_e, c), generator=gen4,
                              device=dev).to(dt)
        per_seg_c4(f"arm E's rows, C = {c}", pages_c, maps_e, b4_args[2:],
                   b5_args[2:], ns4)
        if c == 40:
            shapes["B4_in_place"] = ((pages_c, b4_args[1]) + b4_args[2:],
                                     ns4)
            shapes["B5_in_place"] = ((pages_c, b5_args[1]) + b5_args[2:],
                                     ns5)
    rng = np.random.default_rng(16)
    scfg_16 = streaming.StreamingCfg(grid_res=48, mvoxel_edge=16,
                                     capacity=512)
    n16, ns16 = 40000, 4
    pts = torch.as_tensor(rng.uniform(-1.0, 1.0, (n16, 3)),
                          dtype=torch.float32, device=dev)
    seg = torch.arange(n16, device=dev, dtype=torch.int32) % ns16
    blocks = ops.rit_blocks(pts, scfg_16, seg=seg, num_seg=ns16)
    bh = sp_k._rit_blocks(pts, seg, ns16, scfg_16)
    br = sp_k._rit_blocks(pts, seg, ns16, dataclasses.replace(
        scfg_16, capacity=1024))
    pages_16 = torch.randn((3, scfg_16.num_mvoxels, scfg_16.halo_rows, 12),
                           generator=gen4, device=dev)
    for dt in (torch.float32, torch.bfloat16):
        per_seg_c4("edge 16, C = 12", pages_16.to(dt),
                   [[2, 0, 2, 1], [1, -1, 0, 2]],
                   (blocks.ids, blocks.weights),
                   (bh.ids_mv, bh.w_mv, br.ids_mv, br.w_mv), ns16)
    print(f"B4 / B5 at the C4 shapes, bit-equal to plain and to B1 / B3 on "
          f"each valid page, NaN on the invalid: {json.dumps(c4_checks)}")
    if not all(c4_checks.values()):
        fail("B4 or B5 differs at a C4 shape")
    # B6 at the shapes arm F gives it (its first prefill, 2,048 tokens, and
    # its first decode tick, 4 slots at index 2,048 of a 2,084-row cache),
    # a ragged prefill through ops.mha (kv_len masks the padding) and a
    # top-left causal sq < sk case; the library yardstick is SDPA on the
    # same tensors (decode: on the cache cut to kv_len)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen6 = torch.Generator(device=dev).manual_seed(6)

    def qkv(b, sq, sk, dtype):
        rnd = lambda *shape: torch.randn(shape, generator=gen6, device=dev,
                                         dtype=torch.float32).to(dtype)
        return rnd(b, 40, sq, 128), rnd(b, 8, sk, 128), rnd(b, 8, sk, 128)

    b6_cases = []
    for dt, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        q, k, v = qkv(1, 2048, 2048, dt)
        b6_cases.append((f"prefill {tag} q {list(q.shape)} k/v "
                         f"{list(k.shape)} causal", (q, k, v),
                         dict(causal=True), "flash",
                         lambda q=q, k=k, v=v: sdpa(q, k, v, is_causal=True,
                                                    enable_gqa=True),
                         b6_cost(1, 40, 8, 2048, 2048, 128, True,
                                 q.element_size())))
    q, k, v = qkv(1, 1000, 1000, torch.bfloat16)
    b6_cases.append(("ragged prefill bf16 S=1000 through ops.mha (padded to "
                     "1024, kv_len 1000)", (q, k, v), dict(causal=True),
                     "mha", lambda q=q, k=k, v=v: sdpa(
                         q, k, v, is_causal=True, enable_gqa=True),
                     b6_cost(1, 40, 8, 1000, 1000, 128, True, 2)))
    q, k, v = qkv(1, 64, 128, torch.bfloat16)
    b6_cases.append(("top-left causal bf16 sq=64 sk=128", (q, k, v),
                     dict(causal=True), "flash",
                     lambda q=q, k=k, v=v: sdpa(q, k, v, is_causal=True,
                                                enable_gqa=True),
                     b6_cost(1, 40, 8, 64, 128, 128, True, 2)))
    for dt, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        q, k, v = qkv(LM_SLOTS, 1, LM_MAX_LEN, dt)
        b6_cases.append((f"decode {tag} q {list(q.shape)} cache "
                         f"{list(k.shape)} kv_len 2049", (q, k, v),
                         dict(causal=False, kv_len=2049), "flash",
                         lambda q=q, k=k, v=v: sdpa(
                             q, k[:, :, :2049], v[:, :, :2049],
                             enable_gqa=True),
                         b6_cost(LM_SLOTS, 40, 8, 1, 2049, 128, False,
                                 q.element_size())))
    # the same decode through the prefill kernel: Sq = 2 takes the prefill
    # branch and does Sq = 1's work (one 64-row query block against the
    # same key tiles), the one-path alternative to the split-KV decode
    q, k, v = qkv(LM_SLOTS, 2, LM_MAX_LEN, torch.bfloat16)
    b6_cases.append(("decode shape through the prefill kernel, bf16 q "
                     f"{list(q.shape)} (Sq=2) cache {list(k.shape)} kv_len "
                     "2049", (q, k, v), dict(causal=False, kv_len=2049),
                     "flash", lambda q=q, k=k, v=v: sdpa(
                         q, k[:, :, :2049], v[:, :, :2049], enable_gqa=True),
                     b6_cost(LM_SLOTS, 40, 8, 2, 2049, 128, False, 2)))
    # arm W's three new calls (whisper-small: 12 heads, MHA, head_dim 64;
    # 1,500 encoder keys, a ragged last 64-key tile): the encoder's
    # non-causal self-attention, the decoder's cross-attention in prefill
    # (192 rows against 1,500 keys) and in decode (kv_len = Sk = 1,500)
    wb, wh, wd, wt = (W_SHAPE["batch"], 12, 64, 1500)
    rnd6 = lambda *shape: torch.randn(shape, generator=gen6, device=dev,
                                      dtype=torch.float32).bfloat16()
    for name, sq in (("encoder", wt), ("cross prefill", W_SHAPE["prompt"]),
                     ("cross decode", 1)):
        q, k, v = rnd6(wb, wh, sq, wd), rnd6(wb, wh, wt, wd), \
            rnd6(wb, wh, wt, wd)
        b6_cases.append((
            f"arm W {name} bf16 q {list(q.shape)} k/v {list(k.shape)} "
            f"non-causal" + (f" kv_len {wt}" if sq == 1 else ""), (q, k, v),
            dict(causal=False), "flash",
            lambda q=q, k=k, v=v: sdpa(q, k, v),
            b6_cost(wb, wh, wh, sq, wt, wd, False, 2)))

    def b6_route(q):
        """The kernel the wrapper routes ``q`` to (launches, errors)."""
        if q.shape[2] == 1:
            return "decode_split"
        return "prefill_mma" if q.dtype == torch.bfloat16 else "prefill_tile"

    def b6_err_key(q):
        tag = "bf16" if q.dtype == torch.bfloat16 else "f32"
        return f"B6 {b6_route(q)} {tag}"

    for name, (q, k, v), kw, via, _, _ in b6_cases:
        got = (ops.mha(q, k, v, **kw) if via == "mha"
               else fa_k.flash_attention(q, k, v, **kw))
        want = fa_k.flash_attention_plain(q, k, v, **kw)
        bf = q.dtype == torch.bfloat16
        key = b6_err_key(q)
        errs[key] = max(errs.get(key, 0.0), check_close(
            f"B6 {name}", got, want, B6_BF16_TOL if bf else ATTN_F32_TOL))
    # the split-KV decode at the kv_len edges of its plan (a range of one
    # key, a whole tile, a tile and one, one split length -1 and +1, arm
    # F's first tick, the whole cache), and its two kernels one by one
    splits, split_len = fa_k.decode_split_plan(
        LM_MAX_LEN, LM_SLOTS * 8,
        2 * torch.cuda.get_device_properties(0).multi_processor_count)
    decode_plan = {"splits": splits, "split_len": split_len,
                   "ctas": splits * LM_SLOTS * 8, "sms": torch.cuda
                   .get_device_properties(0).multi_processor_count}
    print(f"B6 decode split plan at cache {LM_MAX_LEN}: {decode_plan}")
    decode_kv_lens = [1, 63, 64, 65, split_len - 1, split_len + 1, 2049,
                      LM_MAX_LEN]
    errs["B6_partials"] = errs["B6_combine"] = 0.0
    decode_inputs = {}
    for dt, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        q, k, v = qkv(LM_SLOTS, 1, LM_MAX_LEN, dt)
        decode_inputs[tag] = (q, k, v)
        tol = B6_BF16_TOL if dt == torch.bfloat16 else ATTN_F32_TOL
        key = b6_err_key(q)
        for kv_len in decode_kv_lens:
            kw = dict(causal=False, kv_len=kv_len)
            errs[key] = max(errs.get(key, 0.0), check_close(
                f"B6 decode {tag} q {list(q.shape)} cache {list(k.shape)} "
                f"kv_len {kv_len}", fa_k.flash_attention(q, k, v, **kw),
                fa_k.flash_attention_plain(q, k, v, **kw), tol))
            plan = dict(kv_len=kv_len, splits=splits, split_len=split_len)
            parts = fa_k.decode_partials(q, k, v, **plan)
            for part, g, w in zip("mlo", parts, fa_k.decode_partials_plain(
                    q, k, v, **plan)):
                errs["B6_partials"] = max(errs["B6_partials"], check_close(
                    f"B6 decode split kernel {tag} kv_len {kv_len} partial "
                    f"{part}", g, w, DECODE_PARTIALS_TOL))
            errs["B6_combine"] = max(errs["B6_combine"], check_close(
                f"B6 decode combine kernel {tag} kv_len {kv_len}",
                fa_k.decode_combine(*parts, dt),
                fa_k.decode_combine_plain(*parts, dt), tol))
    # more than 8 query heads per KV head: a decode CTA serves 8 of them,
    # so the grid has two head chunks per KV head
    q = torch.randn((2, 32, 1, 128), generator=gen6, device=dev).bfloat16()
    k, v = (torch.randn((2, 2, LM_MAX_LEN, 128), generator=gen6,
                        device=dev).bfloat16() for _ in range(2))
    kw = dict(causal=False, kv_len=2049)
    errs["B6 decode_split bf16"] = max(errs["B6 decode_split bf16"],
                                       check_close(
        "B6 decode bf16 q [2, 32, 1, 128] (16 heads per KV head) cache "
        f"[2, 2, {LM_MAX_LEN}, 128] kv_len 2049",
        fa_k.flash_attention(q, k, v, **kw),
        fa_k.flash_attention_plain(q, k, v, **kw), B6_BF16_TOL))
    # GQA groups of 7 (internvl2-1b: 14 query heads over 2 KV heads, head
    # dim 64), prefill and decode in both dtypes
    for dt in (torch.bfloat16, torch.float32):
        tol = B6_BF16_TOL if dt == torch.bfloat16 else ATTN_F32_TOL
        for b, sq, sk, kw in ((1, 2048, 2048, dict(causal=True)),
                              (LM_SLOTS, 1, LM_MAX_LEN,
                               dict(causal=False, kv_len=2049))):
            q = torch.randn((b, 14, sq, 64), generator=gen6,
                            device=dev).to(dt)
            k, v = (torch.randn((b, 2, sk, 64), generator=gen6,
                                device=dev).to(dt) for _ in range(2))
            key = b6_err_key(q)
            errs[key] = max(errs.get(key, 0.0), check_close(
                f"B6 group 7 {dt} q {list(q.shape)} k/v {list(k.shape)} "
                f"{kw}", fa_k.flash_attention(q, k, v, **kw),
                fa_k.flash_attention_plain(q, k, v, **kw), tol))
    # B6's window and softcap (b6_variant_cases), each against the plain
    # version (by query blocks at arm M2's 10,240 rows); the softcapped
    # decode's split kernel also alone against its plain partials
    b6_variants = b6_variant_cases(dev, gen6)
    errs["B6 window"] = errs["B6 softcap"] = 0.0
    for case in b6_variants:
        (q, k, v), kw = case["qkv"], case["kw"]
        err = check_close(f"B6 {case['name']}",
                          fa_k.flash_attention(q, k, v, **kw),
                          plain_attention(q, k, v, **kw),
                          B6_BF16_TOL if q.dtype == torch.bfloat16
                          else ATTN_F32_TOL)
        errs[b6_err_key(q)] = max(errs[b6_err_key(q)], err)
        errs[f"B6 {case['variant']}"] = max(errs[f"B6 {case['variant']}"],
                                           err)
        if q.shape[2] == 1:
            plan = dict(kv_len=kw["kv_len"], splits=splits,
                        split_len=split_len, softcap=kw["softcap"])
            for part, g, w in zip("mlo", fa_k.decode_partials(
                    q, k, v, **plan), fa_k.decode_partials_plain(
                    q, k, v, **plan)):
                errs["B6_partials"] = max(errs["B6_partials"], check_close(
                    f"B6 softcapped decode split kernel {q.dtype} partial "
                    f"{part}", g, w, DECODE_PARTIALS_TOL))
    torch.cuda.synchronize()
    phase_done("kernel checks")

    # 4. the arms, end to end ---------------------------------------------
    def reset():
        for k in kernels:
            k.reset()

    def counts():
        return launch_counts(kernels)

    def all_stats(st):
        """Every field of a RenderStats, per-frame hole fractions too."""
        return dataclasses.asdict(st)

    warm_render = {}  # the arms' renderers, reused warm in phase S

    def run_arm(name, cfg, n_frames, model=None, np_params=None,
                profile=True, exact_stats=False):
        arm_poses = orbit_trajectory(n_frames)
        req = RenderRequest(poses=tuple(arm_poses))
        extra = ({} if model is None else
                 dict(model=model, params=params_from_numpy(np_params, dev)))
        gpu = api.make_renderer(cfg, **extra)
        reset()
        cold = gpu.render(req)
        launches = counts()
        gpu.render(req)  # captures the tick programs the cold run met once
        warm = gpu.render(req)
        warm_render[name] = gpu
        cpu = cpu_refs.pop(name).get()["result"]  # the worker's CPU run
        frames = [f.cpu() for f in cold.frames]
        for f in frames:
            if f.shape != (cfg.res, cfg.res, 3) or not torch.isfinite(f).all():
                fail(f"arm {name}: a frame is not finite [{cfg.res}]^2 x 3")
        worst = min(float(psnr(f, c)) for f, c in zip(frames, cpu.frames))
        if worst < 40.0:
            fail(f"arm {name}: a frame is {worst:.2f} dB from the CPU run")
        sg, sc = cold.stats, cpu.stats
        if sg.reference_renders != sc.reference_renders \
                or sg.frames != sc.frames or sc.frames != n_frames:
            fail(f"arm {name}: stats differ from the CPU run ({sg} vs {sc})")
        if abs(sg.sparse_pixels - sc.sparse_pixels) > \
                0.01 * max(sc.sparse_pixels, 1):
            fail(f"arm {name}: sparse pixels {sg.sparse_pixels} vs CPU "
                 f"{sc.sparse_pixels}")
        if exact_stats and all_stats(sg) != all_stats(sc):
            fail(f"arm {name}: stats differ from the CPU run "
                 f"({all_stats(sg)} vs {all_stats(sc)})")
        return {"frames": n_frames, "ticks": math.ceil(n_frames / cfg.window),
                "launches": launches,
                "profile": (profile_run(lambda: gpu.render(req)) if profile
                            else "not run"),
                "min_psnr_vs_cpu_db": worst,
                "reference_renders": sg.reference_renders,
                "sparse_pixels": sg.sparse_pixels,
                "sparse_pixels_cpu": sc.sparse_pixels,
                "fallback_pixels": sg.fallback_pixels,
                "mean_hole_fraction": sg.mean_hole_fraction,
                "cold_wall_s": cold.wall_s, "warm_wall_s": warm.wall_s,
                "warm_fps": warm.fps, "cpu_wall_s": cpu.wall_s}

    warm_serve = {}  # the arms' serving engines, reused warm in phase S

    def serve_engine_of(renderer):
        return renderer.pipeline.serve_engine_for(renderer.config)

    def serve_fleet(renderer, fleet):
        reset()
        torch.cuda.synchronize()
        results, m = renderer.serve(fleet)
        return results, m, counts()

    def run_serving_arm(name, cfg, fleet):
        n_sessions, n_frames = len(fleet), len(fleet[0].poses)
        gpu = api.make_renderer(cfg, model=model_b,
                                params=params_from_numpy(np_params_b, dev))
        cold, m_cold, launches = serve_fleet(gpu, fleet)
        _, m_warm, _ = serve_fleet(gpu, fleet)
        warm_serve[name] = serve_engine_of(gpu)
        ref = cpu_refs.pop(name).get()  # the worker's CPU run of the fleet
        cpu, m_cpu, cpu_s = ref["results"], ref["metrics"], ref["wall_s"]
        if not (m_cold["complete"] and m_cpu["complete"]):
            fail(f"arm {name}: a session did not complete")
        if m_cold["ticks"] != m_cpu["ticks"]:
            fail(f"arm {name}: {m_cold['ticks']} ticks vs CPU "
                 f"{m_cpu['ticks']}")
        worst = math.inf
        for rg, rc in zip(cold, cpu):
            if rg.stats.reference_renders != rc.stats.reference_renders \
                    or rg.stats.frames != rc.stats.frames \
                    or rc.stats.frames != n_frames:
                fail(f"arm {name}: session {rg.sid} stats differ from the "
                     f"CPU run ({rg.stats} vs {rc.stats})")
            for f, c in zip(rg.frames, rc.frames):
                f = f.cpu()
                if f.shape != (cfg.res, cfg.res, 3) \
                        or not torch.isfinite(f).all():
                    fail(f"arm {name}: a frame is not finite")
                worst = min(worst, float(psnr(f, c)))
        if worst < 40.0:
            fail(f"arm {name}: a frame is {worst:.2f} dB from the CPU run")
        sparse = [r.stats.sparse_pixels for r in cold]
        return cold, {
            "sessions": n_sessions, "frames": n_sessions * n_frames,
            "slots": cfg.num_slots, "ticks": m_cold["ticks"],
            "launches": launches,
            "profile": profile_run(lambda: gpu.serve(fleet)),
            "top_ops_by_shape": profile_ops_by_shape(lambda: gpu.serve(fleet)),
            "min_psnr_vs_cpu_db": worst,
            "reference_renders": [r.stats.reference_renders for r in cold],
            "sparse_pixels": sparse,
            "sparse_pixels_cpu": [r.stats.sparse_pixels for r in cpu],
            "fallback_pixels": [r.stats.fallback_pixels for r in cold],
            "memory": m_cold["memory"], "queue": m_cold["queue"],
            "cold_wall_s": m_cold["wall_s"], "warm_wall_s": m_warm["wall_s"],
            "warm_fps": m_warm["aggregate_fps"], "cpu_wall_s": cpu_s}, fleet

    def stats_of(sess):
        return {k: getattr(sess.stats, k) for k in (
            "frames", "reference_renders", "warped_pixels", "sparse_pixels",
            "fallback_pixels", "total_pixels")}

    def run_scenes_arm(cfg, n_sessions, n_frames):
        """Arm E: mixed-scene serving through RenderServeEngine with a
        scene_loader, held against the CPU run, exclusive runs and the
        staged tick (see the module docstring)."""
        ren = api.make_renderer(cfg)
        eng = scene_engine(ren)
        mixes = []  # the scenes each tick serves, read at its staging
        stage = eng._stage_scene_map

        def watched_stage():
            mixes.append(sorted({slot.scene_key for slot in eng.slots
                                 if slot is not None}))
            stage()

        eng._stage_scene_map = watched_stage
        reset()
        torch.cuda.synchronize()
        cold = arm_e_sessions(n_sessions, n_frames)
        m_cold = eng.run(cold)
        launches = counts()
        del eng._stage_scene_map
        m_warm = eng.run(arm_e_sessions(n_sessions, n_frames))
        # the worker's CPU run, each tick's warp recorded for C2 below
        e_cpu = cpu_refs.pop("E").get()
        if e_cpu["metrics"]["ticks"] != len(e_cpu["warps"]) \
                or len(e_cpu["sessions"]) != n_sessions:
            fail("arm E: the worker's CPU run is not the fleet's")
        cpu, warps_cpu, m_cpu = (e_cpu[k] for k in ("sessions", "warps",
                                                     "metrics"))
        cpu_s = e_cpu["wall_s"]
        sc = m_cold["scene_cache"]
        if not (m_cold["complete"] and m_cpu["complete"]):
            fail("arm E: a session did not complete")
        if m_cold["ticks"] != m_cpu["ticks"] or sc != m_cpu["scene_cache"]:
            fail(f"arm E: {m_cold['ticks']} ticks and scene cache {sc} vs "
                 f"CPU {m_cpu['ticks']} and {m_cpu['scene_cache']}")
        distinct = len(set(ARM_E_SCENES[:n_sessions]))
        if sc["hits"] < 1 or sc["evictions"] < 1 or sc["uploads"] <= distinct:
            fail(f"arm E: the scene cache saw no hit, eviction or repage: "
                 f"{sc}")
        if len(mixes) != m_cold["ticks"] or min(map(len, mixes)) < 2:
            fail(f"arm E: a tick served fewer than 2 scenes: {mixes}")
        if launches["fused_gather_dual_per_seg"] != m_cold["ticks"] \
                or launches["gather_trilerp_per_seg"] \
                < m_cold["memory"]["admission_ticks"] \
                or launches["gather_trilerp"] or launches["fused_gather_dual"]:
            fail(f"arm E: launches {launches} for {m_cold['ticks']} ticks "
                 "(B5 once per tick, B4 on admission, no B1 or B3)")
        worst, worst_at = math.inf, None
        for sg, scpu in zip(cold, cpu):
            if stats_of(sg) != stats_of(scpu) \
                    or sg.stats.frames != n_frames:
                fail(f"arm E: session {sg.sid} stats {stats_of(sg)} vs CPU "
                     f"{stats_of(scpu)}")
            for i, (f, c) in enumerate(zip(sg.frames, scpu.frames)):
                f = f.cpu()
                if f.shape != (cfg.res, cfg.res, 3) \
                        or not torch.isfinite(f).all():
                    fail("arm E: a frame is not finite")
                if float(psnr(f, c)) < worst:
                    worst = float(psnr(f, c))
                    worst_at = {"sid": sg.sid, "frame": i,
                                "scene": sg.scene, "psnr_db": worst,
                                "max_abs_diff": float((f - c).abs().max()),
                                "pixels_over_1e-3": int(
                                    ((f - c).abs().amax(-1) > 1e-3).sum())}
        if worst < 40.0:
            fail(f"arm E: a frame is {worst:.2f} dB from the CPU run")
        # where the card and CPU runs part: the baked tables, then the fleet
        # on the card from the CPU's bakes (the same tick code, other tables)
        c2 = {"tables": c2_tables(cfg.grid_res, cfg.channels, dev)}
        eng_x = RenderServeEngine(
            ren.model, ren.params, config=ren.config,
            scene_loader=lambda name: scene_loader("cpu")(name).to(dev))
        sess_x = arm_e_sessions(n_sessions, n_frames)
        warps_x, _ = c2_warps(eng_x, sess_x)
        if len(warps_x) != m_cpu["ticks"] or any(
                stats_of(a) != stats_of(b) for a, b in zip(sess_x, cpu)):
            fail("arm E from the CPU's bakes: stats differ from the CPU run")
        c2["warps"] = c2_compare_warps(warps_x, warps_cpu)
        del warps_x, warps_cpu
        for row in c2["warps"]:
            print(f"C2 warp {json.dumps(row)}")
        c2["min_psnr_vs_cpu_db_cpu_bakes"] = min(
            float(psnr(f.cpu(), c)) for sx, scpu in zip(sess_x, cpu)
            for f, c in zip(sx.frames, scpu.frames))
        c2["min_psnr_vs_cpu_db_card_bakes"] = worst
        c2["worst_frame"] = worst_at
        # the first mixed tick, stage by stage, card against CPU, both from
        # the CPU's bakes
        c2["first_tick"] = c2_compare(*(c2_first_tick(
            RenderServeEngine(ren.model, r.params, config=r.config,
                              scene_loader=lambda name, d=r.device:
                              scene_loader("cpu")(name).to(d)),
            arm_e_sessions(4, cfg.window))
            for r in (ren, api.make_renderer(cfg, device="cpu"))))
        for row in c2["first_tick"]:
            print(f"C2 first tick {json.dumps(row)}")
        for row in c2["tables"]:
            print(f"C2 table {json.dumps(row)}")
        print(f"C2 arm E frames vs the CPU run: card bakes {worst:.2f} dB, "
              f"CPU bakes {c2['min_psnr_vs_cpu_db_cpu_bakes']:.2f} dB; "
              f"worst frame {worst_at}")
        del eng_x, sess_x
        # two sessions on different scenes against their scene alone
        alone_db = math.inf
        for sid in (0, 1):
            solo = api.make_renderer(cfg.replace(scene=ARM_E_SCENES[sid]))
            (res,), _ = solo.serve([RenderRequest(
                poses=tuple(cold[sid].poses))])
            if res.stats.hole_fractions != cold[sid].stats.hole_fractions:
                fail(f"arm E: session {sid} hole fractions differ from its "
                     "scene served alone")
            alone_db = min(alone_db, min(
                float(psnr(a, b)) for a, b in zip(cold[sid].frames,
                                                  res.frames)))
        if alone_db < 60.0:
            fail(f"arm E: mixed and exclusive frames differ ({alone_db:.2f}"
                 " dB)")
        # a shorter fleet staged and fused on the card
        short = {}
        for fused in (True, False):
            e = scene_engine(ren, fused_tick=fused)
            reset()
            torch.cuda.synchronize()
            sess = arm_e_sessions(4, n_frames // 2)
            m = e.run(sess)
            short[fused] = (sess, m, counts())
        # the staged run once more, recording B4's calls by shape (apart
        # from the measured run, so the spy costs it nothing): the staged
        # per-scene fill's shape, which the timings use
        b4_calls = {}
        real_b4 = gt_k.gather_trilerp_mvoxels_per_seg

        def spy_b4(*args, **kw):
            key = (tuple(args[0].shape), str(args[0].dtype),
                   tuple(args[2].shape), kw["num_seg"])
            b4_calls.setdefault(key, [0, (args, kw["num_seg"])])[0] += 1
            return real_b4(*args, **kw)

        gt_k.gather_trilerp_mvoxels_per_seg = spy_b4
        spied = scene_engine(ren, fused_tick=False)
        spied.engine.cuda_graphs = False  # the spy must see every call
        try:
            spied.run(arm_e_sessions(4, n_frames // 2))
        finally:
            gt_k.gather_trilerp_mvoxels_per_seg = real_b4
        b4_by_shape = sorted(b4_calls.items(), key=lambda kv: -kv[1][0])
        shapes["B4_fill"] = b4_by_shape[0][1][1]
        b4_staged_shapes = [{"pages": list(k[0]), "dtype": k[1],
                             "ids": list(k[2]), "num_seg": k[3], "calls": v[0]}
                            for k, v in b4_by_shape]
        print(f"arm E staged: B4 calls by shape {b4_staged_shapes}")
        (s_f, m_f, l_f), (s_s, m_s, l_s) = short[True], short[False]
        if m_f["ticks"] != m_s["ticks"] or not m_s["complete"] \
                or l_s["gather_trilerp_per_seg"] == 0 \
                or l_s["gather_trilerp"] or l_s["fused_gather_dual_per_seg"]:
            fail(f"arm E: staged ticks {m_s['ticks']} vs fused {m_f['ticks']}"
                 f", staged launches {l_s}")
        staged_db = min(float(psnr(a, b)) for x, y in zip(s_f, s_s)
                        for a, b in zip(x.frames, y.frames))
        if staged_db < 40.0:
            fail(f"arm E: staged and fused frames differ ({staged_db:.2f} dB)")
        # C4 end to end: the short fleet at 40 channels, fused and staged.
        # Two fp32 [729, 40] blocks exceed shared memory, so B4 and B5 read
        # every page block in place. The padded channels are zero and the
        # direct decoder reads channels 0-3, so only float-order noise in
        # the dense fallback may part it from the 4-channel run
        c40 = cfg.replace(channels=40)
        ren40 = api.make_renderer(c40)
        wide = {}
        for fused in (True, False):
            e = RenderServeEngine(
                ren40.model, ren40.params,
                config=c40.replace(fused_tick=fused),
                scene_loader=lambda name: scenes.bake_dense_table(
                    scenes.make_scene(name), c40.grid_res, c40.channels,
                    device=dev))
            reset()
            torch.cuda.synchronize()
            sess = arm_e_sessions(4, n_frames // 2)
            m = e.run(sess)
            wide[fused] = (sess, m, counts())
        counters = ("hits", "misses", "evictions", "uploads", "hit_rate",
                    "resident_scenes")
        scale = c40.channels / cfg.channels  # page bytes grow with C
        wide_db = math.inf
        for fused, (s40, m40, l40) in wide.items():
            s4, m4, _ = short[fused]
            sc4, sc40 = m4["scene_cache"], m40["scene_cache"]
            if m40["ticks"] != m4["ticks"] or not m40["complete"] \
                    or any(sc40[k] != sc4[k] for k in counters) \
                    or any(sc40[k] != scale * sc4[k] for k in (
                        "evicted_bytes", "uploaded_bytes", "resident_bytes")):
                fail(f"arm E at 40 channels (fused {fused}): ticks "
                     f"{m40['ticks']} vs {m4['ticks']}, scene cache {sc40} "
                     f"vs {sc4}")
            if any(stats_of(a) != stats_of(b) for a, b in zip(s40, s4)):
                fail(f"arm E at 40 channels (fused {fused}): session stats "
                     "differ from the 4-channel run")
            if (fused and (l40["fused_gather_dual_per_seg"] != m40["ticks"]
                           or l40["gather_trilerp_per_seg"] == 0)) \
                    or (not fused and (l40["gather_trilerp_per_seg"] == 0
                                       or l40["fused_gather_dual_per_seg"])) \
                    or l40["gather_trilerp"] or l40["fused_gather_dual"]:
                fail(f"arm E at 40 channels (fused {fused}): launches {l40}")
            wide_db = min(wide_db, min(
                float(psnr(a, b)) for x, y in zip(s40, s4)
                for a, b in zip(x.frames, y.frames)))
        print(f"C4 end to end: arm E's short fleet at 40 channels, fused and "
              f"staged, {wide_db:.2f} dB from the 4-channel runs")
        if wide_db < 60.0:
            fail(f"arm E at 40 channels: frames {wide_db:.2f} dB from the "
                 "4-channel run")
        fleet = lambda: eng.run(arm_e_sessions(n_sessions, n_frames))
        return {
            "sessions": n_sessions, "frames": n_sessions * n_frames,
            "slots": cfg.num_slots, "ticks": m_cold["ticks"],
            "launches": launches, "scene_mix_per_tick": mixes,
            "scene_cache": sc, "scene_cache_warm": m_warm["scene_cache"],
            "profile": profile_run(fleet),
            "top_ops_by_shape": profile_ops_by_shape(fleet),
            "min_psnr_vs_cpu_db": worst,
            "min_psnr_vs_alone_db": alone_db, "C2": c2,
            "reference_renders": [x.stats.reference_renders for x in cold],
            "sparse_pixels": [x.stats.sparse_pixels for x in cold],
            "fallback_pixels": [x.stats.fallback_pixels for x in cold],
            "memory": m_cold["memory"], "queue": m_cold["queue"],
            "cold_wall_s": m_cold["wall_s"], "warm_wall_s": m_warm["wall_s"],
            "warm_fps": m_warm["aggregate_fps"], "cpu_wall_s": cpu_s,
            "short_fleet": {
                "sessions": 4, "frames_each": n_frames // 2,
                "ticks": m_f["ticks"], "min_psnr_staged_vs_fused_db":
                staged_db, "launches_fused": l_f, "launches_staged": l_s,
                "fused_wall_s": m_f["wall_s"], "staged_wall_s": m_s["wall_s"],
                "staged_b4_calls_by_shape": b4_staged_shapes},
            "short_fleet_40_channels": {
                "min_psnr_vs_4_channels_db": wide_db,
                "launches_fused": wide[True][2],
                "launches_staged": wide[False][2],
                "fused_wall_s": wide[True][1]["wall_s"],
                "staged_wall_s": wide[False][1]["wall_s"]}}


    def tree_bytes(tree):
        if isinstance(tree, dict):
            return sum(tree_bytes(v) for v in tree.values())
        if isinstance(tree, list):
            return sum(tree_bytes(v) for v in tree)
        return tree.numel() * tree.element_size()

    def run_lm_arm():
        """Arm F: LM serving (see the module docstring)."""
        cpu = torch.device("cpu")
        part_s, clock = {}, [time.perf_counter()]

        def part(name):
            now = time.perf_counter()
            part_s[name], clock[0] = now - clock[0], now

        # F1: 2 layers at full width in float32, the card against the CPU
        cfg1, p1 = lm_model(F1_LAYERS, "float32", 1, dev)
        p1_cpu = to_dev(p1, cpu)
        f1_len = max(F1_PROMPTS) + F1_MAX_NEW + 4
        reqs_g = lm_requests(F1_PROMPTS, cfg1.vocab_size, F1_MAX_NEW, 1)
        reset()
        st_g, wall_g, rec_g = serve_lm(cfg1, p1, reqs_g, F1_SLOTS, f1_len,
                                       dev)
        f1_launches = counts()
        del p1
        torch.cuda.empty_cache()
        reqs_c = lm_requests(F1_PROMPTS, cfg1.vocab_size, F1_MAX_NEW, 1)
        st_c, wall_c, rec_c = serve_lm(cfg1, p1_cpu, reqs_c, F1_SLOTS,
                                       f1_len, cpu)
        del p1_cpu
        streams_g, streams_c = [r.out for r in reqs_g], [r.out for r in reqs_c]
        if st_g != st_c or streams_g != streams_c:
            fail(f"F1: card stats {st_g} streams {streams_g} vs CPU {st_c} "
                 f"{streams_c}")
        f1_want = {"prefill_tile": F1_LAYERS * len(F1_PROMPTS),
                   "prefill_mma": 0,
                   "decode_split": F1_LAYERS * st_g["ticks"],
                   "decode_combine": F1_LAYERS * st_g["ticks"]}
        if any(f1_launches[f"{B6}.{n}"] != m for n, m in f1_want.items()):
            fail(f"F1: B6 launches {f1_launches} for {st_g['ticks']} ticks "
                 f"(want {f1_want})")
        f1_err = max(check_close(
            f"F1 request {i} prefill logits, card vs CPU (float32)",
            a.cpu(), b, F1_TOL)
            for i, (a, b) in enumerate(zip(rec_g["logits"], rec_c["logits"])))
        f1 = {"layers": F1_LAYERS, "dtype": "float32", "prompts": F1_PROMPTS,
              "slots": F1_SLOTS, "max_new": F1_MAX_NEW, "stats": st_g,
              "streams": streams_g, "launches": f1_launches,
              "max_abs_err_prefill_logits": f1_err, "card_wall_s": wall_g,
              "cpu_wall_s": wall_c}
        part("F1")

        # the full arm: LM_LAYERS layers at full width in bfloat16
        cfg, params = lm_model(LM_LAYERS, "bfloat16", 0, dev)
        weight_bytes = tree_bytes(params)
        fleet = lambda: lm_requests(LM_PROMPTS, cfg.vocab_size, LM_MAX_NEW)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset()
        cold = fleet()
        st_cold, wall_cold, rec_cold = serve_lm(cfg, params, cold, LM_SLOTS,
                                                LM_MAX_LEN, dev)
        launches = counts()
        peak = torch.cuda.max_memory_allocated()
        ticks = st_cold["ticks"]
        want_b6 = {f"{B6}.prefill_mma": LM_LAYERS * len(LM_PROMPTS),
                   f"{B6}.decode_split": LM_LAYERS * ticks,
                   f"{B6}.decode_combine": LM_LAYERS * ticks}
        want_b6[B6] = sum(want_b6.values())
        if rec_cold["decode_ticks"] != ticks or any(
                n != want_b6.get(name, 0) for name, n in launches.items()):
            fail(f"arm F: launches {launches} for {ticks} decode ticks "
                 f"(want {want_b6}: B6's prefill {LM_LAYERS} x 8 prefills, "
                 "its decode kernels each once per layer and tick, no other "
                 "kernel)")
        for r in cold:
            if len(r.out) != LM_MAX_NEW or not r.done \
                    or min(r.out) < 0 or max(r.out) >= cfg.vocab_size:
                fail(f"arm F: request {r.rid} produced {r.out}")
        for lg in rec_cold["logits"]:
            if lg.shape != (1, cfg.vocab_size) or not torch.isfinite(lg).all():
                fail("arm F: prefill logits not finite [1, vocab]")
        part("cold")
        # F2 (see f2_check), then each control in B6's place: F2 must come
        # out false for every planted fault on every request
        refs = f2_references(cfg, params, cold, LM_MAX_LEN)
        f2 = {"tolerance": B6_BF16_TOL,
              "B6": f2_check(cfg, params, cold, refs, LM_MAX_LEN,
                             B6_BF16_TOL, served=rec_cold["logits"])}
        for kind in F2_FAULTS + F2_PRECISION:
            f2[kind] = f2_check(
                cfg, params, cold, refs, LM_MAX_LEN, B6_BF16_TOL,
                attend=functools.partial(attention_reference, acc="float32",
                                         fault=kind))
        for kind, rows in f2.items():
            if kind != "tolerance":
                for row in rows:
                    print(f"F2 {kind} {json.dumps(row)}")
        del refs
        if not all(row["holds"] for row in f2["B6"]):
            fail("F2: B6's prefill attention or logits are further from the "
                 "plain version or the float64 prefill than the limits allow "
                 f"(rows {f2['B6']})")
        for kind in F2_FAULTS:
            if any(row["holds"] for row in f2[kind]):
                fail(f"F2 cannot see the planted fault {kind}: it held for "
                     f"{[row['rid'] for row in f2[kind] if row['holds']]}")
        part("F2")
        warm = fleet()
        st_warm, wall_warm, rec_warm = serve_lm(cfg, params, warm, LM_SLOTS,
                                                LM_MAX_LEN, dev)
        part("warm")
        generated = sum(len(r.out) for r in warm)
        prefill_s = sum(rec_warm["prefill_s"])
        kv_bytes = (LM_LAYERS * 2 * LM_SLOTS * cfg.num_kv_heads * LM_MAX_LEN
                    * cfg.head_dim * 2)
        # the profiled run serves the first wave (4 requests on the 4
        # slots): the profiler's post-processing grows with the launches
        prof = profile_run(lambda: serve_lm(
            cfg, params, lm_requests(LM_PROMPTS[:LM_SLOTS], cfg.vocab_size,
                                     LM_MAX_NEW), LM_SLOTS, LM_MAX_LEN, dev))
        part("profile")
        del params
        torch.cuda.empty_cache()
        return {
            "model": f"{LM_ARCH} full width, {LM_LAYERS} of 64 layers, "
                     "bfloat16, random weights (seed 0), QKV biases drawn",
            "requests": len(LM_PROMPTS), "prompt_lengths": LM_PROMPTS,
            "max_new": LM_MAX_NEW, "slots": LM_SLOTS, "max_len": LM_MAX_LEN,
            "ticks": ticks, "tokens_computed": st_cold["tokens_computed"],
            "reuse_ratio": st_cold["reuse_ratio"], "launches": launches,
            "b6_launches_expected": want_b6,
            "cold_wall_s": wall_cold, "warm_wall_s": wall_warm,
            "generated_tokens": generated,
            "generated_tok_per_s": generated / wall_warm,
            "prefill_prompt_tok_per_s": sum(LM_PROMPTS) / prefill_s,
            "prefill_s": rec_warm["prefill_s"], "ttft_s": rec_warm["ttft_s"],
            "ttft_cold_s": rec_cold["ttft_s"],
            "decode_s_per_tick": (wall_warm - prefill_s) / st_warm["ticks"],
            "warm_streams_equal_cold": [r.out for r in warm]
            == [r.out for r in cold],
            "weight_bytes": weight_bytes, "kv_cache_bytes": kv_bytes,
            "max_memory_allocated": peak, "profile": prof,
            "profiled_prompts": LM_PROMPTS[:LM_SLOTS],
            "F1": f1, "F2": f2, "part_s": part_s}

    # the adaptive-sampling and baseline arms (G, D adaptive, H)
    def psnr_delta(frames_a, frames_b, gt):
        """The reference's adaptive gate: each frame's PSNR against the
        full render of its pose, one run against the other, worst frame."""
        return max(abs(float(psnr(a, g)) - float(psnr(b, g)))
                   for a, b, g in zip(frames_a, frames_b, gt))

    def run_adaptive_arm(cfg, n_frames):
        """Arm G: staged adaptive trajectory (see the module docstring)."""
        arm_poses = orbit_trajectory(n_frames)
        req = RenderRequest(poses=tuple(arm_poses))
        gpu = api.make_renderer(cfg)
        warm_render["G"] = gpu
        spy = window_spy(gpu)
        reset()
        cold = gpu.render(req)
        launches = counts()
        wins = read_windows(spy)
        warm = gpu.render(req)
        ref = cpu_refs.pop("G").get()  # the worker's CPU run, spied
        cpu, wins_cpu, cpu_s = ref["result"], ref["windows"], ref["wall_s"]
        frames = [f.cpu() for f in cold.frames]
        for f in frames:
            if f.shape != (cfg.res, cfg.res, 3) or not torch.isfinite(f).all():
                fail("arm G: a frame is not finite [res]^2 x 3")
        worst = min(float(psnr(f, c)) for f, c in zip(frames, cpu.frames))
        if worst < 40.0:
            fail(f"arm G: a frame is {worst:.2f} dB from the CPU run")
        if wins != wins_cpu:
            fail(f"arm G: windows (buckets, hole counts, fine counts) "
                 f"differ from the CPU run: {wins} vs {wins_cpu}")
        if all_stats(cold.stats) != all_stats(cpu.stats):
            fail(f"arm G: stats differ from the CPU run ({cold.stats} vs "
                 f"{cpu.stats})")
        coarse = sum(sum(h) - sum(f) for _, h, f in wins)
        if coarse == 0:
            fail("arm G: no hole took the coarse pool")
        # arm A's config (the same run as arm A) and the full renders
        base = api.make_renderer(cfg.replace(adaptive_sampling=False))
        spy_base = window_spy(base)
        base_frames = [f.cpu() for f in base.render(req).frames]
        wins_base = read_windows(spy_base)
        gt = [f.cpu() for f in base.render_baseline(arm_poses)]
        delta = psnr_delta(frames, base_frames, gt)
        if delta > 1.0:
            fail(f"arm G: a frame is {delta:.3f} dB further from the full "
                 "render than arm A's (gate 1.0 dB)")
        ns, cf = cfg.num_samples, cfg.coarse_factor
        spw = [b * ns + bc * (ns // cf) for (b, bc), _, _ in wins]
        spw_base = [b * ns for (b, _), _, _ in wins_base]
        # the profile covers the first window (a 32-frame trace of ~130k
        # device events takes about a minute to reduce)
        first = RenderRequest(poses=tuple(arm_poses[:cfg.window]))
        return {"frames": n_frames, "ticks": len(wins),
                "launches": launches,
                "profile_first_window": profile_run(
                    lambda: gpu.render(first)),
                "min_psnr_vs_cpu_db": worst,
                "max_abs_psnr_delta_vs_non_adaptive_db": delta,
                "mean_psnr_vs_full_db": float(np.mean(
                    [float(psnr(f, g)) for f, g in zip(frames, gt)])),
                "mean_psnr_vs_full_db_non_adaptive": float(np.mean(
                    [float(psnr(f, g)) for f, g in zip(base_frames, gt)])),
                "windows": wins, "windows_non_adaptive": wins_base,
                "pool_samples_per_window": spw,
                "pool_samples_per_window_non_adaptive": spw_base,
                "hole_total": sum(sum(h) for _, h, _ in wins),
                "coarse_holes": coarse,
                "reference_renders": cold.stats.reference_renders,
                "sparse_pixels": cold.stats.sparse_pixels,
                "fallback_pixels": cold.stats.fallback_pixels,
                "cold_wall_s": cold.wall_s, "warm_wall_s": warm.wall_s,
                "warm_fps": warm.fps, "cpu_wall_s": cpu_s}

    def run_adaptive_serving(cfg, fleet, staged_frames, m_staged_warm):
        """Arm D adaptive: arm D's fleet served staged with adaptive
        sampling, held against each session rendered alone on the card
        and the first session's first window on the CPU (see the module
        docstring)."""
        gpu = api.make_renderer(cfg, model=model_b,
                                params=params_from_numpy(np_params_b, dev))
        b2_calls = {}
        inner = mlp_k.fused_nerf_mlp

        def b2_spy(*a):
            key = str(list(a[0].shape))
            b2_calls[key] = b2_calls.get(key, 0) + 1
            return inner(*a)

        mlp_k.fused_nerf_mlp = b2_spy
        try:
            served, m, launches = serve_fleet(gpu, fleet)
        finally:
            mlp_k.fused_nerf_mlp = inner
        warm_serve["D adaptive"] = serve_engine_of(gpu)
        log = list(warm_serve["D adaptive"]._pool_log)
        if not m["complete"] or m["ticks"] != m_staged_warm["ticks"]:
            fail(f"arm D adaptive: {m['ticks']} ticks (staged "
                 f"{m_staged_warm['ticks']}), or a session did not complete")
        if launches[mlp_k.KERNEL.name] == 0 \
                or launches[gt_k.KERNEL.name] == 0:
            fail(f"arm D adaptive: B1 or B2 unlaunched: {launches}")
        if not any(e["fine_total"] < e["hole_total"] for e in log):
            fail("arm D adaptive: no hole took the coarse pool")
        # every session alone on the card: the same frames, stats and, in
        # sum, fine counts as served
        spy = window_spy(gpu)
        worst_alone, fine_alone = math.inf, 0
        for req, rs in zip(fleet, served):
            alone = gpu.render(req)
            if all_stats(alone.stats) != all_stats(rs.stats):
                fail(f"arm D adaptive: session {rs.sid} stats served "
                     f"{rs.stats} vs alone {alone.stats}")
            for f, a in zip(rs.frames, alone.frames):
                if f.shape != (cfg.res, cfg.res, 3) \
                        or not torch.isfinite(f).all():
                    fail("arm D adaptive: a frame is not finite")
                worst_alone = min(worst_alone, float(psnr(f, a)))
        wins_alone = read_windows(spy)
        fine_alone = sum(sum(f) for _, _, f in wins_alone)
        if worst_alone < 40.0 or fine_alone != sum(e["fine_total"]
                                                   for e in log):
            fail(f"arm D adaptive: served vs alone {worst_alone:.2f} dB, "
                 f"fine holes {sum(e['fine_total'] for e in log)} vs "
                 f"{fine_alone}")
        # the CPU: the first session's first window alone (the staged
        # fill at 4 slots costs minutes on the host's CPU; see PERF.md)
        first = RenderRequest(poses=fleet[0].poses[:cfg.window])
        spy_gpu = window_spy(gpu)
        one = gpu.render(first)
        ref = cpu_refs.pop("D adaptive").get()  # the worker's, spied
        one_cpu, wins_cpu, cpu_s = (ref["result"], ref["windows"],
                                    ref["wall_s"])
        worst = min(float(psnr(f.cpu(), c)) for f, c in zip(one.frames,
                                                            one_cpu.frames))
        if worst < 40.0 or read_windows(spy_gpu) != wins_cpu \
                or all_stats(one.stats) != all_stats(one_cpu.stats):
            fail(f"arm D adaptive: session 0's first window {worst:.2f} dB "
                 f"from the CPU run, windows {read_windows(spy_gpu)} vs "
                 f"{wins_cpu}, stats {one.stats} vs {one_cpu.stats}")
        # against the non-adaptive staged fleet, each frame's PSNR to the
        # full render of its pose (recorded: the reference gates it on
        # baked scenes, arm G; these weights are random)
        deltas = []
        for req, ra, rs in zip(fleet, served, staged_frames):
            gt = gpu.render_baseline(req.poses)
            deltas += [(abs(float(psnr(a, g)) - float(psnr(b, g))),
                        float(psnr(a, g)), float(psnr(b, g)))
                       for a, b, g in zip(ra.frames, rs.frames, gt)]
        worst_delta = max(deltas)
        return {"sessions": len(fleet),
                "frames": sum(len(r.poses) for r in fleet),
                "slots": cfg.num_slots, "ticks": m["ticks"],
                "launches": launches, "b2_call_shapes": b2_calls,
                "min_psnr_served_vs_alone_db": worst_alone,
                "min_psnr_vs_cpu_db": worst,
                "windows_session0_first": read_windows(spy_gpu),
                "max_abs_psnr_delta_vs_non_adaptive_db": worst_delta[0],
                "worst_delta_frame_psnr_vs_full_db": worst_delta[1:],
                "mean_psnr_vs_full_db": float(np.mean(
                    [d[1] for d in deltas])),
                "mean_psnr_vs_full_db_non_adaptive": float(np.mean(
                    [d[2] for d in deltas])),
                "frames_over_1db": sum(d[0] > 1.0 for d in deltas),
                "pool": m["pool"],
                "pool_non_adaptive_staged": m_staged_warm["pool"],
                "pool_log": log,
                # one (cold) run only: the staged fleet runs ~15 s a serve
                "cold_wall_s": m["wall_s"],
                "cold_fps": m["aggregate_fps"], "cpu_wall_s": cpu_s}

    def run_baselines_arm(cfg, n_frames):
        """Arm H: the paper's baselines (see the module docstring)."""
        arm_poses = orbit_trajectory(n_frames)
        req = RenderRequest(poses=tuple(arm_poses))
        host = {"host": cfg.replace(engine="host"),
                "temporal": cfg.replace(engine="host", mode="temporal")}
        full = api.make_renderer(cfg)
        full_cpu = api.make_renderer(cfg, device="cpu")
        runs = {
            "full": (lambda: (full.render_baseline(arm_poses), None),
                     lambda: full_cpu.render_baseline(arm_poses)),
            "ds2": (lambda: (full.render_ds2(arm_poses), None),
                    lambda: full_cpu.render_ds2(arm_poses))}
        for name, c in host.items():
            gpu_r = api.make_renderer(c)
            cpu_r = api.make_renderer(c, device="cpu")
            runs[name] = (lambda r=gpu_r: (lambda x: (x.frames, x.stats))(
                r.render(req)), lambda r=cpu_r: r.render(req))
        out, gt = {}, None
        for name in ("full", "host", "temporal", "ds2"):
            gpu_fn, cpu_fn = runs[name]
            reset()
            torch.cuda.synchronize()
            frames, stats = gpu_fn()
            torch.cuda.synchronize()
            launches = counts()
            t0 = time.perf_counter()
            gpu_fn()
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            cpu = cpu_fn()
            cpu_s = time.perf_counter() - t0
            cpu_frames = cpu if stats is None else cpu.frames
            frames = [f.cpu() for f in frames]
            for f in frames:
                if f.shape != (cfg.res, cfg.res, 3) \
                        or not torch.isfinite(f).all():
                    fail(f"arm H {name}: a frame is not finite")
            worst = min(float(psnr(f, c)) for f, c in zip(frames,
                                                          cpu_frames))
            if worst < 40.0:
                fail(f"arm H {name}: a frame is {worst:.2f} dB from the "
                     "CPU run")
            if stats is not None and all_stats(stats) != all_stats(
                    cpu.stats):
                fail(f"arm H {name}: stats differ from the CPU run "
                     f"({stats} vs {cpu.stats})")
            if launches[gt_k.KERNEL.name] == 0:
                fail(f"arm H {name}: B1 never launched: {launches}")
            if name == "full":
                gt = frames
            out[name] = {
                "launches": launches, "min_psnr_vs_cpu_db": worst,
                "mean_psnr_vs_full_db": (None if name == "full" else float(
                    np.mean([float(psnr(f, g)) for f, g in zip(frames,
                                                               gt)]))),
                "reference_renders": (None if stats is None
                                      else stats.reference_renders),
                "mean_hole_fraction": (None if stats is None
                                       else stats.mean_hole_fraction),
                "warm_wall_s": warm_s, "warm_fps": n_frames / warm_s,
                "cpu_wall_s": cpu_s}
        if out["temporal"]["reference_renders"] != 1 \
                or out["host"]["reference_renders"] != -(-n_frames
                                                         // cfg.window):
            fail(f"arm H: reference renders host "
                 f"{out['host']['reference_renders']}, TEMP "
                 f"{out['temporal']['reference_renders']}")
        return {"frames": n_frames, "baselines": out}

    arms = {"A": run_arm("A", cfg_a, 32)}
    phase_done("arm A")
    arms["B"] = run_arm("B", cfg_b, 16, model_b, np_params_b)
    phase_done("arm B")
    # C5 end to end: arm B's model at hidden width 48 (B2 padded to 64)
    model_b48, _ = models.make_model("dvgo", backend="streaming",
                                     decoder="mlp", mlp_hidden=48)
    arms["B48"] = run_arm("B48", cfg_b, 8, model_b48,
                          arm_b_params(0, hidden=48), profile=False,
                          exact_stats=True)
    if arms["B48"]["launches"][mlp_k.KERNEL.name] == 0:
        fail(f"arm B48 never launched B2: {arms['B48']['launches']}")
    phase_done("C5")
    arms["C"] = run_arm("C", cfg_c, 32)
    phase_done("arm C")
    fused_frames, arms["D"], fleet = run_serving_arm("D", cfg_d, d_fleet)
    if arms["A"]["launches"]["gather_trilerp"] == 0:
        fail("arm A never launched the Gathering Unit kernel")
    if min(arms["B"]["launches"][k.name]
           for k in (gt_k.KERNEL, mlp_k.KERNEL)) == 0:
        fail(f"arm B left a kernel unlaunched: {arms['B']['launches']}")
    for name in ("C", "D"):
        arm = arms[name]
        if arm["launches"]["gather_trilerp"] == 0 \
                or arm["launches"]["fused_gather_dual"] != arm["ticks"]:
            fail(f"arm {name}: B3 launched {arm['launches']} times for "
                 f"{arm['ticks']} fused ticks (B1 must run too)")
    if arms["D"]["launches"]["fused_nerf_mlp"] == 0:
        fail(f"arm D never launched B2: {arms['D']['launches']}")
    # the same fleet on the staged serving tick, on the card
    gpu_s = api.make_renderer(cfg_d.replace(fused_tick=False), model=model_b,
                              params=params_from_numpy(np_params_b, dev))
    staged, m_staged, launches_staged = serve_fleet(gpu_s, fleet)
    _, m_staged_warm, _ = serve_fleet(gpu_s, fleet)
    warm_serve["D staged"] = serve_engine_of(gpu_s)
    if m_staged["ticks"] != arms["D"]["ticks"] or not m_staged["complete"]:
        fail(f"arm D: staged serving ran {m_staged['ticks']} ticks, fused "
             f"{arms['D']['ticks']}")
    worst = min(float(psnr(a, b)) for ra, rb in zip(fused_frames, staged)
                for a, b in zip(ra.frames, rb.frames))
    if worst < 40.0:
        fail(f"arm D: staged and fused serving frames differ ({worst:.2f} "
             "dB)")
    arms["D"]["staged"] = {
        "ticks": m_staged["ticks"], "launches": launches_staged,
        "min_psnr_vs_fused_db": worst, "cold_wall_s": m_staged["wall_s"],
        "warm_wall_s": m_staged_warm["wall_s"],
        "warm_fps": m_staged_warm["aggregate_fps"]}
    phase_done("arm D")
    arms["D_adaptive"] = run_adaptive_serving(cfg_d_adaptive, fleet, staged,
                                              m_staged_warm)
    phase_done("arm D adaptive")
    arms["E"] = run_scenes_arm(cfg_e, 12, 32)
    phase_done("arm E")
    arms["G"] = run_adaptive_arm(cfg_g, 32)
    phase_done("arm G")
    arms["H"] = run_baselines_arm(cfg_a, 32)
    phase_done("arm H")
    rows_i, renderers_i = run_arm_i(arm_i_models, reset, counts, profile_run)
    for name, row in rows_i.items():
        arms[f"I {name}"] = row
        warm_render[f"I {name}"] = renderers_i[name]
    reset()
    arms["I oracle"] = run_arm_i_oracle()
    arms["I oracle"]["launches"] = counts()
    phase_done("arm I")
    training, fitted = run_phase_t(ARM_I_CONFIGS, dev)
    phase_done("T")
    for name, row in run_arm_i_fitted(fitted, arm_i_models, renderers_i,
                                      reset, counts).items():
        arms[f"I fitted {name}"] = row
    del fitted
    phase_done("arm I fitted")

    # S. the steady tick: graph replays bit-equal to eager on the same
    # inputs and free of synchronizing calls, captures one per key
    def same_outputs(label, got, want):
        for name, t in tick_tensors(got).items():
            if not torch.equal(t, tick_tensors(want)[name]):
                fail(f"phase S {label}: {name} of a replay differs from "
                     "the eager call on the same inputs")
        if not torch.equal(got.frames, want.frames):
            fail(f"phase S {label}: resolved frames differ")

    def window_inputs(n_sessions, window):
        trajs = [orbit_trajectory(window + 1, phase_deg=25.0 * i)
                 for i in range(n_sessions)]
        ref = torch.stack([t[0] for t in trajs]).to(dev)
        tgt = torch.stack([torch.stack(t[:window]) for t in trajs]).to(dev)
        nxt = torch.stack([t[window] for t in trajs]).to(dev)
        return ref, tgt, nxt

    def engine_call(eng, n_sessions, fused, **kw):
        ref, tgt, nxt = window_inputs(n_sessions, eng.window)
        if not fused:
            return lambda: eng.render_windows(ref, tgt, **kw)
        rgb, dep = eng.prime_reference(ref)
        return lambda: eng.render_windows_streaming(rgb, dep, ref, tgt, nxt,
                                                    **kw)

    def warm_replay_check(label, eng, call):
        """``call()`` at a captured key, replayed under ``sync_error``,
        against the same call with the engine's graphs off: bit-equal
        outputs and resolved frames, and no capture."""
        caps = eng.num_captures
        with sync_error():
            graph = call()
        graphs, eng.cuda_graphs = eng.cuda_graphs, False
        eager = call()
        eng.cuda_graphs = graphs
        same_outputs(label, graph, eager)
        if eng.num_captures != caps:
            fail(f"phase S {label}: a warm key was captured again")

    def steady_serving(label, serve, fleet):
        """Serve ``fleet()`` until every key is captured (at most twice;
        not at all on a warm engine), then once more with every tick that
        admits nothing under ``sync_error``: no new key and no capture in
        that run."""
        eng = serve.engine
        for _ in range(2):
            if eng.tick_programs \
                    and eng.num_captures == len(eng.tick_programs):
                break
            serve.run(fleet())
        keys, caps = len(eng.tick_programs), eng.num_captures
        if caps != keys:
            fail(f"phase S {label}: {caps} captures for {keys} keys")
        real, steady = serve.step, [0]

        def guarded():
            if serve.queue and any(x is None for x in serve.slots):
                return real()  # admission: priming, paging, staging
            with sync_error():
                ran = real()
            steady[0] += ran
            return ran

        serve.step = guarded
        try:
            t0 = time.perf_counter()
            m = serve.run(fleet())
            wall = time.perf_counter() - t0
        finally:
            del serve.step
        if len(eng.tick_programs) != keys or eng.num_captures != caps \
                or not m["complete"] or steady[0] < 1:
            fail(f"phase S {label}: keys {keys} -> "
                 f"{len(eng.tick_programs)}, captures {caps} -> "
                 f"{eng.num_captures}, {steady[0]} steady ticks")
        return {"keys": keys, "captures": caps, "ticks": m["ticks"],
                "steady_ticks_checked": steady[0], "wall_s": wall}

    steady = {"replay": {}, "serving": {}}
    # the arms' renderers and serving engines as they left them, every key
    # captured: each one's first key replayed against eager
    for label, fused in (("A", False), ("B", False), ("C", True),
                         ("G", False)):
        eng = warm_render[label].pipeline.device_engine
        warm_replay_check(label, eng, engine_call(eng, 1, fused))
        steady["replay"][label] = {
            "key": list(next(iter(eng.tick_programs)))}
    # then arm D's fleet served fused, and staged and adaptive its first
    # wave (4 sessions: an admitting tick, then a steady one), as a staged
    # tick at 4 slots costs seconds
    for label, fused, n_sessions in (("D fused", True, 6),
                                     ("D staged", False, 4),
                                     ("D adaptive", False, 4)):
        serve = warm_serve["D" if label == "D fused" else label]
        warm_replay_check(label, serve.engine,
                          engine_call(serve.engine, 4, fused))
        steady["replay"][label] = {
            "key": list(next(iter(serve.engine.tick_programs)))}
        steady["serving"][label] = steady_serving(
            label, serve, lambda n=n_sessions: [
                RenderSession.from_request(r, i)
                for i, r in enumerate(fleet[:n])])
    for label, fused, n_sessions, n_frames in (("E fused", True, 12, 32),
                                               ("E staged", False, 4, 32)):
        serve = scene_engine(api.make_renderer(cfg_e), fused_tick=fused)
        steady["serving"][label] = steady_serving(
            label, serve, lambda: arm_e_sessions(n_sessions, n_frames))
        # a paged key of the run against eager, on the pages and map the
        # fleet left
        key = next(iter(serve.engine.tick_programs))
        warm_replay_check(label, serve.engine, engine_call(
            serve.engine, 4, fused, bucket=key[3],
            **({} if fused else {"bucket_coarse": key[4]})))
        steady["replay"][label] = {"key": list(key)}
    # arm I's hash and VM grids: their staged key, captured by the arm's
    # warm renders, replayed against eager
    for name in ("cicero-ngp", "cicero-tensorf"):
        label = f"I {name}"
        eng = warm_render[label].pipeline.device_engine
        if eng.num_captures != len(eng.tick_programs):
            fail(f"phase S {label}: {eng.num_captures} captures for "
                 f"{len(eng.tick_programs)} keys")
        warm_replay_check(label, eng, engine_call(eng, 1, False))
        steady["replay"][label] = {
            "key": list(next(iter(eng.tick_programs))),
            "keys": len(eng.tick_programs), "captures": eng.num_captures}
    for part, rows in steady.items():
        for label, row in rows.items():
            print(f"phase S {part} {label}: {json.dumps(row)}")
    phase_done("S")
    arms["P"] = run_phase_p(
        dev, reset, counts, cfg_a=cfg_a, cfg_b=cfg_b,
        model_b_kw=dict(kind="dvgo", backend="streaming", decoder="mlp"),
        params_b=dict(seed=0), renderer_b=gpu_s)
    phase_done("P")
    arms["F"] = run_lm_arm()
    phase_done("arm F")
    arms.update(run_arms_m(dev, reset, counts, profile_run))
    phase_done("arms M")
    arms.update(run_arms_r(dev, reset, counts, profile_run))
    phase_done("arms R")
    arms.update(run_arms_wv(dev, reset, counts, profile_run))
    phase_done("arms W V")
    # phase Q's fake-group subprocess and ranks start once L1's CPU steps
    # are done and run beside L2 and L3; the ranks wait for phase L3's
    # checkpoint, which they re-lay
    q_tmp = tempfile.mkdtemp(prefix="chip_smoke_q_")
    atexit.register(shutil.rmtree, q_tmp, True)
    q_procs = {}

    def start_q():
        q_procs["q1"] = q1 = q1_start(dev)
        atexit.register(lambda: q1.poll() is None and q1.kill())
        q_procs["x2"] = x2 = x2_start(dev)
        atexit.register(lambda: x2.poll() is None and x2.kill())
        q_procs["q2"] = q2_start({"cfg": l_config(), "device": None,
                                  "ckpt": str(Path(q_tmp, "l3", "timed"))},
                                 q_tmp)

    training_l = run_phase_l(dev, reset, counts,
                             l3_kw=dict(root=Path(q_tmp, "l3")),
                             after_l1=start_q)
    phase_done("L")
    # X1's ranks start now and run beside phase Q
    torch.cuda.empty_cache()  # L2's blocks, for the ranks' 8.6 GB each
    x_tmp = tempfile.mkdtemp(prefix="chip_smoke_x_")
    atexit.register(shutil.rmtree, x_tmp, True)
    x1_procs = x1_start(x_tmp)
    reset()
    Path(q_tmp, "go").touch()
    # the one-device Trainer from the same seed: L3's straight run
    q_one = training_l["L3"]["straight_losses"][:Q_TRAIN_STEPS]
    phase_q = {"one_device_losses": q_one}
    phase_q["Q1"] = q1_finish(q_procs["q1"])
    phase_q["Q2"] = q2_finish(q_procs["q2"], q_tmp, q_one)
    phase_q["launches"] = counts()
    shutil.rmtree(q_tmp, ignore_errors=True)
    phase_done("Q")
    print_phase_q(phase_q, smi)
    # X. MoE's expert-parallel branch, the dry-run, the cost counter
    phase_x = {"X1": x1_finish(x1_procs, x_tmp, dev, reset, counts)}
    shutil.rmtree(x_tmp, ignore_errors=True)
    phase_x["X2"] = x2_finish(q_procs["x2"], phase_q["Q1"])
    phase_x["X3"] = x3_window(dev, cfg_a, reset, counts)
    phase_done("X")
    print_phase_x(phase_x, smi)
    for name, arm in arms.items():
        print(f"arm {name}: {json.dumps(arm)}")
    print(f"B1 launches: arm A {arms['A']['launches']['gather_trilerp']} "
          f"(staged), arm C {arms['C']['launches']['gather_trilerp']} "
          f"(fused); arm D fused {arms['D']['launches']} vs staged "
          f"{launches_staged}")
    print(f"arm D serving: fused warm {m_warm_line(arms['D'])}; staged warm "
          f"{m_warm_line(arms['D']['staged'])}")
    b48, g, da = arms["B48"], arms["G"], arms["D_adaptive"]
    print(f"C5: arm B48 (mlp_hidden=48) {b48['min_psnr_vs_cpu_db']:.1f} dB "
          f"from the CPU run, B2 launches {b48['launches']['fused_nerf_mlp']}")
    print(f"arm G adaptive: warm {m_warm_line(g)}; pool samples per window "
          f"{g['pool_samples_per_window']} vs arm A "
          f"{g['pool_samples_per_window_non_adaptive']}; worst PSNR delta "
          f"{g['max_abs_psnr_delta_vs_non_adaptive_db']:.3f} dB; busy "
          f"{g['profile_first_window']['device_busy_share']} (first "
          f"window); B1 launches "
          f"{g['launches']['gather_trilerp']}")
    print(f"arm D adaptive: cold {da['cold_wall_s']:.3f} s "
          f"({da['cold_fps']:.1f} frames/s); samples per tick "
          f"{da['pool']['samples_per_tick']} (mean "
          f"{da['pool']['samples_per_tick_mean']:.0f}) vs staged "
          f"{da['pool_non_adaptive_staged']['samples_per_tick']} (mean "
          f"{da['pool_non_adaptive_staged']['samples_per_tick_mean']:.0f});"
          f" worst PSNR delta "
          f"{da['max_abs_psnr_delta_vs_non_adaptive_db']:.3f} dB; B2 calls "
          f"{da['b2_call_shapes']}")
    for n, b in arms["H"]["baselines"].items():
        print(f"arm H {n}: mean PSNR vs full {b['mean_psnr_vs_full_db']} dB,"
              f" warm {b['warm_wall_s']:.3f} s ({b['warm_fps']:.1f} frames/s)"
              f", {b['min_psnr_vs_cpu_db']:.1f} dB from the CPU run")
    for name in ARM_I_CONFIGS:
        a = arms[f"I {name}"]
        p = a["profile"]
        print(f"arm I {name} (C={a['feat_channels']}, H={a['mlp_hidden']}, "
              f"{a['num_samples']} samples): warm {m_warm_line(a)}; busy "
              f"{p['device_busy_share']}, host launches "
              f"{p['host_cuda_launch_kernel']['count']} kernels + "
              f"{p['host_cuda_graph_launch']['count']} graphs; B1 "
              f"{a['launches'][gt_k.KERNEL.name]}, B2 "
              f"{a['launches'][mlp_k.KERNEL.name]} launches; peak "
              f"{p['peak_allocated_bytes'] / 1e9:.2f} GB; holes "
              f"{a['hole_counts']}; {a['min_psnr_db']:.1f} dB from "
              f"{a['checked_against']}")
    def fit_line(t):
        p = t["full_render_psnr_vs_oracle_db"]
        return (f"fit_field {t['steps']} steps x {t['batch']} in "
                f"{t['fit_wall_s']:.2f} s ({t['steps_per_s']:.1f} steps/s), "
                f"peak {t['peak_allocated_bytes'] / 1e9:.2f} GB (from "
                f"{t['allocated_before_bytes'] / 1e9:.2f} GB), held-out loss "
                f"{t['held_out_loss_before']:.4f} -> "
                f"{t['held_out_loss_after']:.4f}, full renders "
                f"{p['min']:.2f} / {p['mean']:.2f} dB from the oracle")

    for name in ARM_I_CONFIGS:
        t, a = training[name], arms[f"I fitted {name}"]
        print(f"phase T {name} ({smi}): {fit_line(t)}; card vs CPU, first "
              f"{len(t['check_steps'])} steps: "
              f"{json.dumps(t['check_steps'])}")
        if "wide_batch_fit" in t:
            print(f"phase T {name} ({smi}), the fit arm I fitted renders: "
                  f"{fit_line(t['wide_batch_fit'])}")
        p, r = a["psnr_vs_oracle_db"], a["random_weights_psnr_vs_oracle_db"]
        print(f"arm I fitted {name} ({smi}): PSNR vs the oracle worst "
              f"{p['min']:.2f} / mean {p['mean']:.2f} dB (random weights "
              f"{r['min']:.2f} / {r['mean']:.2f}); holes "
              f"{a['hole_counts']}, {a['fallback_pixels']} fallback pixels; "
              f"warm {m_warm_line(a)}; B1 "
              f"{a['launches'][gt_k.KERNEL.name]}, B2 "
              f"{a['launches'][mlp_k.KERNEL.name]} launches")
    ti = training["train_images"]
    print(f"phase T train_images {ti['config']} ({smi}): {ti['steps']} steps "
          f"x {ti['rays_per_batch']} rays, loss {ti['first_loss']:.4f} -> "
          f"{ti['last_loss']:.4f}, {ti['wall_s']:.2f} s "
          f"({ti['steps_per_s']:.1f} steps/s)")
    o = arms["I oracle"]
    print(f"arm I oracle (fig. 26 setup): {o['min_psnr_db']:.1f} dB from "
          f"the CPU run, {o['sparse_pixels']} sparse pixels, card wall "
          f"{o['wall_s']:.3f} s")
    print(f"arm E multi-scene serving: warm {m_warm_line(arms['E'])}; "
          f"scene cache {arms['E']['scene_cache']}; launches "
          f"{arms['E']['launches']}")
    p = arms["P"]
    c7 = p["P1"]["C7"]
    print(f"phase P1 C7 ({smi}): the sharded engine's "
          f"{c7['sharded']['steady_ticks']} steady ticks of "
          f"{c7['sharded']['ticks']} under sync_error (0 synchronizing "
          f"calls), frames and stats bit-equal to the unsharded run; warm "
          f"walls {c7['sharded']['warm_wall_s']:.3f} / "
          f"{c7['unsharded']['warm_wall_s']:.3f} s sharded / unsharded; "
          f"{p['P1']['C7_s']:.1f} s")
    print(f"phase P: {p['P_s']:.1f} s, P1 {p['P1_s']:.1f} s "
          f"({p['P1']['backend']}, mesh {p['P1']['mesh']}), P2's ranks "
          f"started at {p['P2_go_s']:.1f} s; sharded walls "
          + "; ".join(f"{r}: {json.dumps(v)}" for r, v in p["P2"].items()))
    f = arms["F"]
    print(f"arm F LM serving: warm {f['warm_wall_s']:.3f} s (cold "
          f"{f['cold_wall_s']:.3f} s), {f['generated_tok_per_s']:.1f} "
          f"generated tok/s, prefill {f['prefill_prompt_tok_per_s']:.0f} "
          f"prompt tok/s, {f['ticks']} ticks, B6 launches "
          f"{f['launches']['flash_attention']}, peak "
          f"{f['max_memory_allocated'] / 1e9:.2f} GB")
    for n in ("M", "M2"):
        m, prof = arms[n], arms[n]["profile"]
        print(f"arm {n} {m['arch']} ({m['params']:,} params, {m['layers']} "
              f"layers, {m['experts']} experts, {smi}): warm "
              f"{m['warm_wall_s']:.3f} s (cold {m['cold_wall_s']:.3f} s), "
              f"{m['generated_tok_per_s']:.1f} generated tok/s, prefill "
              f"{m['prefill_prompt_tok_per_s']:.0f} prompt tok/s, "
              f"{m['ticks']} ticks, {m['decode_s_per_tick'] * 1e3:.1f} ms a "
              f"tick, busy {prof['device_busy_share']}, peak "
              f"{m['max_memory_allocated'] / 1e9:.2f} GB, B6 launches "
              f"{m['launches'][B6]}, F2 max err "
              f"{max(r['layers_max_abs_err'] for r in m['F2']):.3g}")
    for a in (M_ARCH, M2_ARCH):
        m = arms[f"M1 {a}"]
        print(f"arm M1 {a}: card vs CPU equal streams and stats "
              f"{m['stats']}, prefill logits within "
              f"{m['max_abs_err_prefill_logits']:.3g}")
    for n in ("R", "R2"):
        m, prof = arms[n], arms[n]["profile"]
        f2 = (f", F2 max err "
              f"{max(r['layers_max_abs_err'] for r in m['F2']):.3g}"
              if m["F2"] else "")
        print(f"arm {n} {m['arch']} ({m['params']:,} params, {m['layers']} "
              f"layers, {m['attention_layers']} attention, {m['experts']} "
              f"experts, {smi}): warm {m['warm_wall_s']:.3f} s (cold "
              f"{m['cold_wall_s']:.3f} s), {m['generated_tok_per_s']:.1f} "
              f"generated tok/s, prefill {m['prefill_prompt_tok_per_s']:.0f}"
              f" prompt tok/s, {m['ticks']} ticks, "
              f"{m['decode_s_per_tick'] * 1e3:.1f} ms a tick, busy "
              f"{prof['device_busy_share']} (profiled "
              f"{m['profiled_prompts']}), peak "
              f"{m['max_memory_allocated'] / 1e9:.2f} GB, B6 launches "
              f"{m['launches'][B6]}{f2}; parts {json.dumps(m['part_s'])}")
        for mixer, row in m["mixer_checks"].items():
            print(f"arm {n} full-width {mixer} ({smi}): {json.dumps(row)}")
    for a in (R_ARCH, R2_ARCH):
        m = arms[f"R1 {a}"]
        print(f"arm R1 {a}: card vs CPU equal streams and stats "
              f"{m['stats']}, prefill logits within "
              f"{m['max_abs_err_prefill_logits']:.3g}; one train step "
              f"{json.dumps(m['train_steps'])}")
    l1, l2, l3 = (training_l[k] for k in ("L1", "L2", "L3"))
    print(f"phase L1 {L_ARCH}-100m ({training_l['l1_config']['params']:,} "
          f"params, {smi}): card vs CPU, first {len(l1)} train steps: "
          f"{json.dumps(l1)}")
    print(f"phase L2 {L_ARCH} at full width, {l2['config']['num_layers']} "
          f"layers, {l2['config']['batch']} x {l2['config']['seq']} "
          f"({l2['config']['params']:,} params, {smi}): "
          f"{l2['steps_per_s']:.3f} steps/s, {l2['tokens_per_s']:.0f} "
          f"tokens/s (median step after the first), peak allocated "
          f"{l2['peak_allocated_bytes'] / 1e9:.2f} GB (params "
          f"{l2['state_bytes']['params'] / 1e9:.2f} GB, moments "
          f"{l2['state_bytes']['moments'] / 1e9:.2f} GB), losses "
          f"{[round(r['loss'], 4) for r in l2['steps']]}")
    p = l2["profile_one_step"]
    print(f"phase L2 one step profiled ({smi}): busy "
          f"{p['device_busy_share']}, {p['device_events']} device events, "
          f"{p['host_cuda_launch_kernel']['count']} launches; top device "
          f"{json.dumps(p['top_device'])}")
    print(f"phase L3 Trainer ({smi}): {l3['steps']} steps in "
          f"{l3['wall_s']:.1f} s, restart {l3['restart_event']}, loss "
          f"{l3['loss_first5_mean']:.4f} -> {l3['loss_last5_mean']:.4f}; "
          f"checkpoint {l3['checkpoint']['bytes'] / 1e9:.3f} GB saved in "
          f"{l3['checkpoint']['save_s']:.2f} s, loaded in "
          f"{l3['checkpoint']['load_s']:.2f} s; resume {l3['resume']}")

    # 5. timings beside the bounds ----------------------------------------
    def b1_cost(tbl, ids, w):
        out_bytes = ids.shape[0] * ids.shape[1] * tbl.shape[2] \
            * tbl.element_size()
        nbytes = (tbl.numel() * tbl.element_size() + ids.numel() * 4
                  + w.numel() * 4 + out_bytes)
        flops = 2 * 8 * ids.shape[0] * ids.shape[1] * tbl.shape[2]
        return nbytes, flops

    def b2_cost(args):
        feats, enc = args[0], args[1]
        s, c = feats.shape
        h = args[2].shape[1]
        dcfg = mlp.DecoderCfg(in_channels=c, hidden=h)
        nbytes = 4 * (sum(t.numel() for t in args) + 4 * s)
        return nbytes, s * mlp.decoder_flops(dcfg)

    def b3_cost(tbl, ih, wh, ir, wr):
        bh, fh = b1_cost(tbl, ih, wh)
        br, fr = b1_cost(tbl, ir, wr)
        table_bytes = tbl.numel() * tbl.element_size()
        return bh + br - table_bytes, fh + fr  # the table is read once

    def b4_cost(pages, scn, ids, w):
        # each distinct page's halo tables are read once: what this run's
        # map needs, not all K pages
        distinct = len(set(scn.tolist()))
        table_bytes = distinct * pages[0].numel() * pages.element_size()
        out_bytes = ids.shape[0] * ids.shape[1] * pages.shape[3] \
            * pages.element_size()
        nbytes = (table_bytes + scn.numel() * 4 + ids.numel() * 4
                  + w.numel() * 4 + out_bytes)
        flops = 2 * 8 * ids.shape[0] * ids.shape[1] * pages.shape[3]
        return nbytes, flops

    def b5_cost(pages, scn, ih, wh, ir, wr):
        bh, fh = b4_cost(pages, scn, ih, wh)
        br, fr = b4_cost(pages, scn, ir, wr)
        shared = (len(set(scn.tolist())) * pages[0].numel()
                  * pages.element_size() + scn.numel() * 4)
        return bh + br - shared, fh + fr  # pages and map read once

    def timed(kernel_fn, plain_fn, nbytes, flops, shape,
              flop_rate=FP32_FLOP_PER_S, library_fn=None, **time_kw):
        bound_s = max(nbytes / HBM_BYTES_PER_S, flops / flop_rate)
        return {"shape": shape, "ms": time_ms(kernel_fn, **time_kw),
                "plain_ms": time_ms(plain_fn, **time_kw),
                "bound_ms": bound_s * 1e3,
                "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                             >= flops / flop_rate else "operations"),
                "bytes": nbytes, "flops": flops,
                "library_ms": (None if library_fn is None
                               else time_ms(library_fn, **time_kw))}

    t_b1 = [timed(lambda a=a: gt_k.gather_trilerp_mvoxels(*a),
                  lambda a=a: gt_k.gather_trilerp_plain(*a, 1),
                  *b1_cost(*a),
                  f"table {list(a[0].shape)} ids {list(a[1].shape)}{label}")
            for a, label in ((shapes["B1_A identity"], ""),
                             (shapes["B1_B"], ""),
                             (shapes["B1_A bank_interleaved"],
                              " (arm A, bank_interleaved layout)"),
                             (shapes["B1_I"],
                              " (arm I, cicero-dvgo's first chunk)"))]
    t_b2 = [timed(lambda a=a: mlp_k.fused_nerf_mlp(*a),
                  lambda a=a: mlp_k.fused_nerf_mlp_plain(*a), *b2_cost(a),
                  f"S={a[0].shape[0]} C={a[0].shape[1]} H={a[2].shape[1]}"
                  f"{label}")
            for a, label in [(mlp_args, ""), (fill_args, "")] + [
                (b2_i[n], f" (arm I, {n})") for n in ARM_I_CONFIGS]]
    # B2 runs on the TF32 tensor cores, three products per product (3xTF32):
    # its bound there, beside the fp32 CUDA-core bound kept in "bound_ms"
    for t in t_b2:
        t["bound_ms_3xtf32_tensor"] = 1e3 * max(
            t["bytes"] / HBM_BYTES_PER_S, 3 * t["flops"] / TF32_FLOP_PER_S)
    # C5's shapes; the bound is the function's operations (unpadded H) on
    # the fp32 CUDA cores
    for c, h in C5_SHAPES:
        rec, a = c5[(c, h)], c5[(c, h)]["args"]
        plan = rec["plan"]
        t = timed(lambda a=a: mlp_k.fused_nerf_mlp(*a),
                  lambda a=a: mlp_k.fused_nerf_mlp_plain(*a), *b2_cost(a),
                  f"S={C5_ROWS} C={c} H={h} (C5: {plan['mode']}, width "
                  f"{plan['width']}, tile {plan['tile']})")
        t_b2.append(t)
        rec.update({k: t[k] for k in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "shape")})
    t_b3 = [timed(lambda a=a, n=n: sp_k.fused_gather_dual(*a, num_seg=n),
                  lambda a=a, n=n: sp_k.fused_gather_dual_plain(*a, n),
                  *b3_cost(*a),
                  f"table {list(a[0].shape)} holes {list(a[1].shape)} "
                  f"refs {list(a[3].shape)} num_seg {n}{label}")
            for (a, n), label in (
                (shapes["B3_C"], ""), (shapes["B3_D"], ""),
                (shapes["B3_in_place C12"],
                 " (edge-16 C = 12 block in fp32, read in place)"),
                (shapes["B3_in_place C80"],
                 " ([729, 80] block in fp32, read in place)"))]
    (b4_args, ns4), (b5_args, ns5) = shapes["B4_E"], shapes["B5_E"]

    def per_seg_timings(kernel_fn, plain_fn, cost, single_fn, single_plain,
                        single_cost, args, ns, label):
        """The captured tick's map, then the same rows with every segment
        on page 0 (no restage), then the single-scene kernel on page 0
        with the same rows: what the page steering costs."""
        one = (args[0], torch.zeros_like(args[1])) + tuple(args[2:])
        page0 = (args[0][0],) + tuple(args[2:])
        return [timed(lambda: kernel_fn(*args, num_seg=ns),
                      lambda: plain_fn(*args, ns), *cost(*args),
                      f"pages {list(args[0].shape)} map {args[1].tolist()} "
                      f"{label}"),
                timed(lambda: kernel_fn(*one, num_seg=ns),
                      lambda: plain_fn(*one, ns), *cost(*one),
                      f"the same, map {one[1].tolist()} (no restage)"),
                timed(lambda: single_fn(*page0, num_seg=ns),
                      lambda: single_plain(*page0, ns), *single_cost(*page0),
                      "the single-scene kernel on page 0, same rows")]

    t_b4 = per_seg_timings(
        gt_k.gather_trilerp_mvoxels_per_seg, gt_k.gather_trilerp_per_seg_plain,
        b4_cost, gt_k.gather_trilerp_mvoxels_segmented,
        gt_k.gather_trilerp_plain, b1_cost, b4_args, ns4,
        f"ids {list(b4_args[2].shape)}")
    # B4 at the shape of the staged per-scene fill (most of its launches),
    # captured from arm E's staged fleet
    fill4, ns_fill = shapes["B4_fill"]
    errs["B4"] = max(errs["B4"], check_close(
        f"B4 staged fill shape pages {tuple(fill4[0].shape)} map "
        f"{fill4[1].tolist()} ids {tuple(fill4[2].shape)}",
        gt_k.gather_trilerp_mvoxels_per_seg(*fill4, num_seg=ns_fill),
        gt_k.gather_trilerp_per_seg_plain(*fill4, ns_fill), F32_TOL))
    t_b4.append(timed(
        lambda: gt_k.gather_trilerp_mvoxels_per_seg(*fill4, num_seg=ns_fill),
        lambda: gt_k.gather_trilerp_per_seg_plain(*fill4, ns_fill),
        *b4_cost(*fill4),
        f"staged per-scene fill (arm E's staged fleet): pages "
        f"{list(fill4[0].shape)} map {fill4[1].tolist()} ids "
        f"{list(fill4[2].shape)}"))
    t_b5 = per_seg_timings(
        sp_k.fused_gather_dual_per_seg, sp_k.fused_gather_dual_per_seg_plain,
        b5_cost, sp_k.fused_gather_dual, sp_k.fused_gather_dual_plain,
        b3_cost, b5_args, ns5,
        f"holes {list(b5_args[2].shape)} refs {list(b5_args[4].shape)}")
    # B4 and B5 on arm E's captured map and rows with pages of 40 fp32
    # channels: two blocks exceed shared memory, each is read in place
    for t_k, fn, plain_fn, cost, key in (
            (t_b4, gt_k.gather_trilerp_mvoxels_per_seg,
             gt_k.gather_trilerp_per_seg_plain, b4_cost, "B4_in_place"),
            (t_b5, sp_k.fused_gather_dual_per_seg,
             sp_k.fused_gather_dual_per_seg_plain, b5_cost, "B5_in_place")):
        a, n = shapes[key]
        t_k.append(timed(lambda a=a, n=n, fn=fn: fn(*a, num_seg=n),
                         lambda a=a, n=n, fn=plain_fn: fn(*a, n), *cost(*a),
                         f"pages {list(a[0].shape)} map {a[1].tolist()}, "
                         "arm E's captured rows (read in place)"))
    # B6: bf16 at the tensor-core rate, float32 at the CUDA-core rate; each
    # case under the kernel the wrapper routes it to. The decode's two
    # kernels are timed alone at arm F's first tick (no single PyTorch call
    # computes either), then the whole decode (both) beside SDPA
    t_b6 = {n: [] for n in fa_k.KERNELS}
    decode_path = []
    for name, (q, k, v), kw, via, library_fn, cost in b6_cases:
        fn = ops.mha if via == "mha" else fa_k.flash_attention
        t = timed(lambda q=q, k=k, v=v, fn=fn, kw=kw: fn(q, k, v, **kw),
                  lambda q=q, k=k, v=v, kw=kw: fa_k.flash_attention_plain(
                      q, k, v, **kw), *cost, name,
                  flop_rate=(BF16_FLOP_PER_S if q.dtype == torch.bfloat16
                             else FP32_FLOP_PER_S), library_fn=library_fn)
        route = b6_route(q)
        (decode_path if route == "decode_split" else t_b6[route]).append(t)
    for tag, (q, k, v) in decode_inputs.items():
        plan = dict(kv_len=2049, splits=splits, split_len=split_len)
        parts = fa_k.decode_partials(q, k, v, **plan)
        es, (b, h, _, d) = q.element_size(), q.shape
        part_bytes = 4 * b * h * splits * (d + 2)
        rate = BF16_FLOP_PER_S if tag == "bf16" else FP32_FLOP_PER_S
        t_b6["decode_split"].append(timed(
            lambda q=q, k=k, v=v, plan=plan: fa_k.decode_partials(
                q, k, v, **plan),
            lambda q=q, k=k, v=v, plan=plan: fa_k.decode_partials_plain(
                q, k, v, **plan),
            (b * h * d + 2 * b * 8 * 2049 * d) * es + part_bytes,
            4 * b * h * 2049 * d,
            f"split kernel alone, {tag} q {list(q.shape)} cache "
            f"{list(k.shape)} kv_len 2049: {decode_plan}", flop_rate=rate))
        t_b6["decode_combine"].append(timed(
            lambda parts=parts, dt=q.dtype: fa_k.decode_combine(*parts, dt),
            lambda parts=parts, dt=q.dtype: fa_k.decode_combine_plain(
                *parts, dt),
            part_bytes + b * h * d * es, 4 * b * h * splits * d,
            f"combine kernel alone, {tag}, partials of {splits} splits "
            f"[{b}, {h}, {splits}, {d}]", flop_rate=FP32_FLOP_PER_S))
    t_b6["decode_split"] += decode_path
    # the window and softcap variants (b6_variant_cases); arm M2's
    # 10,240-row prefill with 5 repeats of 2 calls (its plain version and
    # SDPA's band mask take tens of ms a call)
    for case in b6_variants:
        (q, k, v), kw = case["qkv"], case["kw"]
        few = dict(repeats=5, launches=2) if case["few"] else {}
        t = timed(lambda q=q, k=k, v=v, kw=kw: fa_k.flash_attention(
                      q, k, v, **kw),
                  lambda q=q, k=k, v=v, kw=kw: plain_attention(
                      q, k, v, **kw),
                  *case["cost"], case["name"],
                  flop_rate=(BF16_FLOP_PER_S if q.dtype == torch.bfloat16
                             else FP32_FLOP_PER_S),
                  library_fn=case["library"], **few)
        t["variant"] = case["variant"]
        if case["sdpa_uncapped"] is not None:
            t["sdpa_uncapped_ms"] = time_ms(case["sdpa_uncapped"])
        t_b6[b6_route(q)].append(t)
    print(f"B6 decode: {decode_plan['splits']} splits of "
          f"{decode_plan['split_len']} keys, {decode_plan['ctas']} CTAs on "
          f"{decode_plan['sms']} SMs; " + "; ".join(
              f"{t['shape']}: {t['ms'] * 1e3:.1f} us (SDPA "
              f"{t['library_ms'] * 1e3:.1f} us)" for t in decode_path))
    phase_done("timings")
    card = f"{smi} (torch.cuda: {kind})"
    # every path's launches: each arm's measured run, plus the staged
    # comparison runs of arms D and E (counts reset before each)
    path_launches = {n: a["launches"] for n, a in arms.items()
                     if "launches" in a}
    path_launches.update({f"H_{n}": b["launches"]
                          for n, b in arms["H"]["baselines"].items()})
    path_launches["D_staged"] = arms["D"]["staged"]["launches"]
    path_launches["E_short_fused"] = arms["E"]["short_fleet"]["launches_fused"]
    path_launches["E_short_staged"] = \
        arms["E"]["short_fleet"]["launches_staged"]
    wide = arms["E"]["short_fleet_40_channels"]
    path_launches["E_c40_fused"] = wide["launches_fused"]
    path_launches["E_c40_staged"] = wide["launches_staged"]
    path_launches["F1"] = arms["F"]["F1"]["launches"]
    path_launches["W float32 frames"] = \
        arms["W"]["float32_frames"]["launches"]
    path_launches["L"] = training_l["launches"]
    path_launches["Q"] = phase_q["launches"]
    path_launches.update(arms["P"]["rank_launches"])
    path_launches.update({f"X1 {r}": row["launches"] for r, row in
                          phase_x["X1"]["ranks"].items()})
    path_launches["X3"] = dict.fromkeys(path_launches["A"], 0)
    path_launches["X3"].update(phase_x["X3"]["kernel_launches"])
    for name, want in EAGER_LAUNCHES.items():
        got = {k: path_launches[name][k] for k in want}
        if got != want:
            fail(f"path {name}: launches {got}, the eager ticks' {want}")

    def entry(name, key, source, replaces, err, t, **extra):
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    launches=sum(c[key] for c in path_launches.values()),
                    launches_per_arm={n: c[key]
                                      for n, c in path_launches.items()},
                    max_abs_err=err,
                    **{k: t[0][k] for k in ("ms", "plain_ms", "bound_ms",
                                            "bound_by", "library_ms",
                                            "shape")},
                    other_shapes=t[1:], card=card, **extra)

    line = {"kernels": [
        entry("gather_trilerp_mvoxels_segmented (B1, Gathering Unit)",
              gt_k.KERNEL.name, "src/repro_torch/csrc/gather_trilerp.cu",
              "src/repro/kernels/gather_trilerp.py:95", errs["B1"], t_b1,
              max_abs_err_bf16=errs["B1_bf16"],
              bit_equal_to_plain=b1_bit_equal,
              reference_shapes_checked=B1_REF_SHAPES),
        entry("fused_nerf_mlp (B2, fused radiance MLP, 3xTF32 mma.sync)",
              mlp_k.KERNEL.name, "src/repro_torch/csrc/fused_nerf_mlp.cu",
              "src/repro/kernels/fused_nerf_mlp.py:54", errs["B2"], t_b2,
              bound_ms_3xtf32_tensor=t_b2[0]["bound_ms_3xtf32_tensor"],
              sass_tf32_hmma=len(b2_hmma),
              c5_shapes=[dict({k: v for k, v in c5[s].items()
                               if k != "args"}, c=s[0], h=s[1])
                         for s in C5_SHAPES],
              max_abs_err_c5=errs["B2_C5"]),
        entry("fused_gather_dual (B3, fused tick dual gather)",
              sp_k.KERNEL.name,
              "src/repro_torch/csrc/fused_gather_dual.cu",
              "src/repro/kernels/streaming_pipeline.py:80", errs["B3"], t_b3,
              max_abs_err_bf16=errs["B3_bf16"],
              max_abs_err_vs_b1=errs["B3_vs_B1"],
              bit_equal_to_b1=b3_bit_equal,
              bit_equal_to_plain=b3_plain_equal,
              reference_and_in_place_shapes_checked=b3_cases),
        entry("gather_trilerp_mvoxels_per_seg (B4, mixed-scene Gathering "
              "Unit)", gt_k.KERNEL_PER_SEG.name,
              "src/repro_torch/csrc/gather_trilerp_per_seg.cu",
              "src/repro/kernels/gather_trilerp.py:143", errs["B4"], t_b4,
              max_abs_err_bf16=errs["B4_bf16"],
              bit_equal_to_b1_per_page=per_seg_bit_equal,
              maps_checked=b4_map_checks, c4_shapes_checked=c4_checks),
        entry("fused_gather_dual_per_seg (B5, mixed-scene fused tick dual "
              "gather)", sp_k.KERNEL_PER_SEG.name,
              "src/repro_torch/csrc/fused_gather_dual_per_seg.cu",
              "src/repro/kernels/streaming_pipeline.py:138", errs["B5"],
              t_b5, max_abs_err_bf16=errs["B5_bf16"],
              bit_equal_to_b3_per_page=per_seg_bit_equal,
              maps_checked=b5_map_checks, c4_shapes_checked=c4_checks),
    ]}
    b6_ptxas = [line.strip() for line in fa_k.KERNEL.log.read_text()
                .splitlines() if "registers" in line or "spill" in line]
    b6_src = "src/repro_torch/csrc/flash_attention.cu"
    b6_rep = "src/repro/kernels/flash_attention.py:96"
    line["kernels"] += [
        entry("flash_mma_kernel (B6 prefill, bf16 mma.sync tensor cores)",
              f"{B6}.prefill_mma", b6_src, b6_rep,
              errs["B6 prefill_mma bf16"],
              t_b6["prefill_mma"], ptxas=b6_ptxas,
              max_abs_err_window=errs["B6 window"],
              max_abs_err_softcap=errs["B6 softcap"]),
        entry("flash_tile_kernel (B6 prefill, fp32 CUDA cores)",
              f"{B6}.prefill_tile", b6_src, b6_rep,
              errs["B6 prefill_tile f32"], t_b6["prefill_tile"]),
        entry("flash_decode_split_kernel (B6 decode, split-KV partials)",
              f"{B6}.decode_split", b6_src, b6_rep, errs["B6_partials"],
              t_b6["decode_split"], decode_plan=decode_plan,
              max_abs_err_decode_bf16=errs["B6 decode_split bf16"],
              max_abs_err_decode_f32=errs["B6 decode_split f32"],
              max_abs_err_softcap=errs["B6 softcap"]),
        entry("flash_decode_combine_kernel (B6 decode, log-sum-exp merge)",
              f"{B6}.decode_combine", b6_src, b6_rep, errs["B6_combine"],
              t_b6["decode_combine"]),
    ]
    print(json.dumps(line))
    lm_arm = arms["F"]
    print(json.dumps({"arms_wall": {
        n: {"frames": a["frames"], "warm_wall_s": a["warm_wall_s"],
            "warm_fps": a["warm_fps"], "cold_wall_s": a["cold_wall_s"]}
        for n, a in arms.items()
        if n not in ("F", "H", "D_adaptive", "I oracle", "P")
        and not n.startswith(("M", "R", "W", "V"))},
        "baselines_H": {n: {k: b[k] for k in ("warm_wall_s", "warm_fps",
                                               "mean_psnr_vs_full_db")}
                        for n, b in arms["H"]["baselines"].items()},
        "lm_serving_F": {
            k: lm_arm[k] for k in ("warm_wall_s", "cold_wall_s",
                                   "generated_tok_per_s",
                                   "prefill_prompt_tok_per_s", "ticks")},
        "lm_serving_M": {
            n: {k: arms[n][k] for k in (
                "warm_wall_s", "cold_wall_s", "generated_tok_per_s",
                "prefill_prompt_tok_per_s", "ticks", "max_memory_allocated")}
            for n in ("M", "M2", "R", "R2", "V serve")},
        "lm_steps_WV": {
            n: {k: arms[n][k] for k in (
                "warm_wall_s", "cold_wall_s", "encoder_s", "prefill_s",
                "decode_s_per_tick", "generated_tok_per_s", "ticks",
                "max_memory_allocated")} for n in ("W", "V")},
        "steady_tick_S": steady,
        "training_T": training,
        "training_L": training_l,
        "phase_Q": phase_q,
        "phase_X": {k: phase_x[k] for k in ("X2", "X3")},
        "phase_s": phase_s, "total_s": sum(phase_s.values()),
        "card": card}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


# each path's launches of B1-B5 as the eager ticks made them (PERF.md
# section 6): the graph replays of the steady tick must count the same
EAGER_LAUNCHES = {
    name: dict(zip(("gather_trilerp", "fused_nerf_mlp", "fused_gather_dual",
                    "gather_trilerp_per_seg", "fused_gather_dual_per_seg"),
                   counts))
    for name, counts in {
        "A": (532, 0, 0, 0, 0), "B": (258, 258, 0, 0, 0),
        "B48": (258, 258, 0, 0, 0), "C": (18, 0, 2, 0, 0),
        "D": (16, 24, 4, 0, 0), "D_staged": (4128, 4128, 0, 0, 0),
        "D_adaptive": (8224, 8224, 0, 0, 0), "E": (0, 0, 0, 216, 6),
        "E_short_fused": (0, 0, 0, 72, 1),
        "E_short_staged": (0, 0, 0, 1096, 0),
        "E_c40_fused": (0, 0, 0, 72, 1),
        "E_c40_staged": (0, 0, 0, 1096, 0), "G": (1044, 0, 0, 0, 0),
        "H_full": (32, 0, 0, 0, 0), "H_host": (33, 0, 0, 0, 0),
        "H_temporal": (33, 0, 0, 0, 0), "H_ds2": (32, 0, 0, 0, 0),
        "F": (0, 0, 0, 0, 0), "F1": (0, 0, 0, 0, 0),
        "M": (0, 0, 0, 0, 0), "M2": (0, 0, 0, 0, 0),
        f"M1 {M_ARCH}": (0, 0, 0, 0, 0), f"M1 {M2_ARCH}": (0, 0, 0, 0, 0),
        "R": (0, 0, 0, 0, 0), "R2": (0, 0, 0, 0, 0),
        f"R1 {R_ARCH}": (0, 0, 0, 0, 0), f"R1 {R2_ARCH}": (0, 0, 0, 0, 0),
        "W1": (0, 0, 0, 0, 0), "W1 bf16": (0, 0, 0, 0, 0),
        "W": (0, 0, 0, 0, 0), "W float32 frames": (0, 0, 0, 0, 0),
        "V1": (0, 0, 0, 0, 0), "V1 serve": (0, 0, 0, 0, 0),
        "V": (0, 0, 0, 0, 0), "V serve": (0, 0, 0, 0, 0),
        "L": (0, 0, 0, 0, 0), "Q": (0, 0, 0, 0, 0),
        "I cicero-dvgo": (258, 258, 0, 0, 0),
        "I cicero-ngp": (0, 258, 0, 0, 0),
        "I cicero-tensorf": (0, 258, 0, 0, 0),
        "I oracle": (0, 0, 0, 0, 0)}.items()}


@contextlib.contextmanager
def sync_error():
    """Every synchronizing CUDA call inside the block raises
    (``torch.cuda.set_sync_debug_mode("error")``)."""
    import torch

    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


def tick_tensors(res) -> dict:
    """A window or tick result's device outputs (not the resolved frames:
    resolving reads ``overflowed`` back)."""
    names = ("sparse_frames", "holes", "hole_counts", "overflowed",
             "fine_counts", "next_rgb_ref", "next_dep_ref")
    return {n: getattr(res, n) for n in names if hasattr(res, n)}


def m_warm_line(arm: dict) -> str:
    return (f"{arm['warm_wall_s']:.3f} s, {arm['warm_fps']:.1f} frames/s, "
            f"cold {arm['cold_wall_s']:.3f} s")


if __name__ == "__main__":
    sys.exit(main())
