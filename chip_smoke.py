#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line per case:

1. ``card``    — the GPU, its power limit, its clocks, temperature and
   active throttle reasons, and the torch/CUDA versions (the clocks again
   in a ``clocks`` line right after the kernel phases).
2. ``build``   — nvcc builds every kernel source for sm_90a, all at once.
3. ``kernel``  — each kernel against its plain PyTorch version at the main
   path's shapes and one ragged shape: the error against a float64 reference
   within the stated tolerance (the broadcast select: equal), and CUDA-event
   times of the kernel, the plain version and one library call that
   computes the same function, and the share of the bound. The dense Eq. 3
   kernel also runs fully connected at the paper's N = 3000 and at N = 32
   (below one tile). The flash-attention kernel runs at
   mistral-nemo-12b's prefill of serve run (a) and ragged shapes
   (window, chunk, Sq ≠ Sk, rows without a key, head_dim 64, G = 1, 2, 4
   and 5 with Sq·G off the 128-row query tile, B = 2), at
   moonshot-v1-16b-a3b's prefill (G = 1), and its head_dim-256 instance
   at gemma3-4b's prefill of serve run (a) (8/4 heads, a global layer and
   a sliding one of window 1024) and four ragged shapes (G = 2 off the
   64-row tile with B = 2, rows without a key, a chunk, Sq ≠ Sk without
   the causal mask), and at llama4-scout's prefill of serve run (c)
   (1 × 16,384, 40/8 heads of 128: a global layer, and a chunked one
   whose chunk of 8192 the prompt crosses; the plain version runs one KV
   head at a time there, and the chunked time over the global one is
   printed: ≈ 0.5 when the kernel skips the key tiles outside the chunk),
   at whisper-tiny's encoder (1 × 1500, non-causal, 6/6 heads of 64: a
   ragged last key tile) and run (b)'s cross attention (8 × 432 queries
   over 1500 keys, non-causal), at llava's loss (1 × 4096, causal,
   32/8 × 128), and its head_dim-32 instance (whisper-tiny-smoke's 4/4
   heads of 32) at 1 × 1500 non-causal and 8 × 64 causal, held also to
   the plain version within 2e-5; each flash row names the backend
   ``scaled_dot_product_attention`` chose for its yardstick. The sparse
   Eq. 3 kernel runs on ER p = 0.1 at N = 1000 and at the paper's N = 3000 (two sender chunks),
   at a ragged shape and at N = 5000, p = 0.02 (four chunks); its band
   instance (``kernel_band``) at the ER cell's shape (N = 16,384, G(N,
   0.0005) from topology seed 0) against float64, two launches equal, one
   launch a wrapper call, the slab instance and ``torch.sparse.mm`` timed
   beside it, then both instances against float64 and timed at the shapes
   around the choice between them (``BAND_CROSSOVER``); the fused
   neighbor sum at N = 1000, the ragged shape and N = 5000 (four chunks),
   where one call must put exactly one kernel on the card (a profiler
   trace) and must not call the plain weight fold; given unit-row codes
   (``kernel_fold``) it must return ``ref.folded_weights`` bit for bit,
   with and without the edge mask, at N = 1000 and 5000. The bound of the
   Eq. 3 kernels counts the factored form's operations (one FMA per edge
   and column); the bound of the unfactored sum, two FMAs per edge and
   column, stays beside it as ``bound_ms_unfactored``. These four kernels,
   redesigned for Hopper, must give the same bits on two launches; their
   rows carry the grid and the resident blocks per SM from their
   libraries' queries (the sparse two also their slab width, chunks,
   registers and spill bytes), and the build fails if ptxas reports a
   spill in any of their libraries, nor in the router's and the WKV
   recurrence's, redesigned too. The MoE router
   ``moe_topk`` runs at moonshot's prefill (8192 × 64 experts, top-6),
   decode (8 × 64), one ragged shape (1000 × 128, top-8), jamba's
   prefill (8192 × 16, top-2) and llama4's top-1 routers through the
   generic instance (scout's 16,384 × 16, maverick's 8192 × 128 and
   8 × 128): ids equal to
   the plain version's except on rows whose top probabilities lie within
   2 ulps of each other (counted and printed), gates within 1e-6. The
   WKV-6 recurrence
   ``rwkv6_wkv`` runs at rwkv6-7b's prefill of serve run (a) (1 × 8192, 64
   heads of 64) with w as the model draws it (≈ 0.9975) and uniform in
   (0.9, 0.999), at run (b)'s (8 × 512), at the decode steps of runs (b)
   and (a) (8 × 1 and 1 × 1, from a random state) and at four ragged
   shapes of n = 8, 16, 32 and 40: within 3e-5
   of float64 relative to the recurrence over absolute values, with the
   plain loop and the reference's chunked form ``wkv6_chunked`` timed
   beside it. The mamba selective scan ``mamba_scan`` runs at
   jamba-v0.1-52b's prefill of serve run (a) (1 × 8192, D = 8192, N = 16)
   with decay as the model draws it (≈ 0.85–0.99) and uniform in (0.8,
   0.999), at run (b)'s (8 × 512), at decode (8 × 1, from a random state)
   and at three ragged shapes: within 3e-5 of float64 relative to the
   recurrence over |drive|, with the plain loop and the associative form
   of ``mamba_block`` timed beside it. The router and the WKV recurrence
   must give the same bits on two launches at every case, and their rows
   carry the grid, resident blocks per SM, registers and spill bytes from
   their libraries' queries (the WKV rows also the plan's threads per
   column quad, warps and columns per block).
   ``kernel_masked``: the two Eq. 3 kernels given a dropout-masked weight
   operand, and the fused neighbor sum given dropout-masked neighbor
   weights and no edge mask, against their plain versions and float64,
   the same bits on two launches.
4. ``main``    — ``train_rl_netes`` on pendulum at N = 1000 (the paper's
   policy, D = 4481), once on Erdős–Rényi p = 0.1 (auto picks sparse) and
   once fully connected (auto picks dense), with one eval each. Every
   kernel's launch counter is zeroed just before each run and read just
   after; the kernel of the run's representation must have launched.
5. ``channel`` — the same at N = 1000 through a lossy channel: (a) ER
   p = 0.1 with q8 and dropout (auto picks sparse and the wire form: both
   fused kernels launch on every step), (b) fully connected with event
   triggering, q4 and dropout (dense, fake-quant payload: the dense
   kernel and the fused broadcast select launch). The drop fraction must
   lie within binomial bounds of p.
5b. ``schedule`` — the same at N = 1000 under a topology schedule
   (``SCHEDULE_RUNS``): s-a ER p = 0.1 resampled every 2 iterations
   (sparse, K_max = 140 from ``pad_k_max``: ``netes_sparse_mixing`` 4
   times), s-b ER p = 0.5 annealed to 0.1 over 4 iterations (dense:
   ``netes_mixing`` 4 times), s-c s-a through channel (a) (both fused
   kernels 4 times), s-d a circulant ER p = 0.05 rotating by 3 (the roll
   chain: no Eq. 3 kernel). Each schedule's graphs are checked (s-a: the
   list at t = 2 differs from t = 0's, and the sparse kernel on it agrees
   with its plain version and float64 within ``TOL_REL``·S; s-b: nested,
   the edges non-increasing; s-d: every degree constant); s-c is run to
   iteration 2 with a checkpoint, resumed to 4, and must equal the
   uninterrupted run bit for bit. Step time, and the advance into a
   redraw timed with CUDA events (``advance_ms``).
   ``no_sync`` (steps): after a warm-up, one ``netes_step`` on ER and FC
   and through channels (a) and (b), and one ``scheduled_step`` of each of
   s-a … s-d (s-a and s-c redrawing), under
   ``torch.cuda.set_sync_debug_mode("error")``.
5c. ``telemetry`` — ``TELEMETRY_RUNS`` at N = 1000, 4 iterations, each
   probed and traced (``TrainConfig.probes``/``trace``) against the
   unprobed run from the same seed, whose history it must equal bit for
   bit: ER and FC with ``fitness|consensus|graph``, channel (a) with
   ``all``, schedule s-a with ``fitness|graph``. The run's kernels must
   launch once a step; ``fitness_mean`` must be ``reward_mean`` in
   float32, ``wire``'s ``msgs`` the history's, ER's density within 5
   binomial sd of 0.1 and FC's 1.0, s-a's graph signals must change at
   t = 2 only with ``deg_max`` ≤ K_max = 140, and ``reach_proxy`` must be
   ``theory.reachability_prior(N, density)``. Each trace must validate,
   build no kernel, and transfer once per drain. Then one probed step on
   ER under ``set_sync_debug_mode("error")``, one traced
   ``ServeEngine.generate`` of serve_parity's model (tokens equal to the
   untraced engine's, a valid trace), the CUDA-event time of one
   ``Probes.record`` of every stage with its host time and kernels, and
   24 plain and 24 probed steps from one state, in turns, timed by CUDA
   events and the host clock (quartiles, and of the difference a pair).
5d. ``capture`` — one probed ``netes_step`` on ER (the sparse kernel) and
   FC (the dense kernel) captured as one ``torch.cuda.CUDAGraph`` (the
   state's generator registered with the graph), replayed 3 times with
   the state copied back in between and held bit for bit (θ, best θ,
   best reward, the probe ring) against 3 eager probed steps from the
   same state and draws; one replay's kernels counted from a profiler
   trace (the Eq. 3 kernel must be there), its time per step by CUDA
   events beside the eager step's.
5e. ``search`` — the topology search at N = 1000 on pendulum
   (``SEARCH_COHORTS``, ``SEARCH_ARGV``, ``SEARCH_Q8``). ``search_parity``:
   a sparse cohort (ER p = 0.05, 0.1, the lists widened to the cohort's
   K_max) and a dense one (FC, ER p = 0.5), each a round of 4 iterations
   through the tournament's round function against the same candidates as
   independent ``netes.run``s from the same states and generators on the
   same topologies, which it must equal bit for bit (θ, best θ, best
   reward, score), and one batched rollout of the cohort's S·2N episodes
   against each candidate's own. ``search``: ``launch/train.py --search``
   with a checkpoint dir (two rounds, then 2 iterations on the winner;
   the two Eq. 3 kernels 34 times in all), its rerun on a copy of the dir
   whose ``latest.json`` points at round 0 (history, winner and score
   equal), and a tournament through ``run_search`` of ER p = 0.1, two
   graph seeds, static and ``resample_er(period=2)``, through q8 (both
   fused kernels 16 times, on widened and on redrawn lists). ``no_sync``:
   one cohort iteration of a static sparse, a static dense, a redrawing
   scheduled and a q8 cohort under ``set_sync_debug_mode("error")``.
   ``search_timing``: one iteration of the sparse cohort (S = 2) against 2
   sequential ``netes_step``s, 10 pairs in turns, CUDA events and the
   host clock.
5f. ``kernel_shard`` — the receiver ≠ sender (R × S) instances of the
   three Eq. 3 kernels (``netes_mixing_rs``, ``netes_sparse_mixing_rs``,
   ``fused_neighbor_sum_rs``; the sharded fleet's per-shard contraction)
   at the operands of shards 0 and 3 of a 4-way ``make_comm_plan`` of N =
   1000, D = 4481 (ER p = 0.1 for the sparse pair, q8 codes for the fused
   one; ER p = 0.5 dense) and shard 0 of an 8-way plan of N = 16,384 (ER
   p = 0.0005): each shard's rows, from the buffer its halo rounds
   deliver, equal to the world-size-1 rows and to the plain version bit
   for bit, within ``TOL_REL``·S of float64, the same bits on two
   launches; time, plain and library times, bound and grid
   (``SHARD_KERNEL_CASES``). Run with the kernel phases.
5g. ``shard`` (after ``parity``) — ``launch/train.py rl --shards 1``
   through NCCL (a world of one) on pendulum at N = 1000, ``SHARD_RUNS``:
   ER p = 0.1 (halo), ER through q8 (halo, the fused instance), FC
   (dense), channel (a) and schedule s-a (replicated). Each run's
   kernels counted (its R × S instance once a step, the square kernels
   never); its history and last
   checkpoint (θ, best θ, best reward) equal bit for bit to the
   ``mesh=None`` engine's from the same seed; a sharded step's host-clock
   ms beside ``netes_step``'s; one step of each under
   ``set_sync_debug_mode("error")`` (a wait is named, and fails unless it
   is inside a ``torch.distributed`` collective).
5h. ``shard_scale`` — N = 16,384, ER p = 0.0005, 2 iterations of
   ``--shards 1``: the wall, a step's ms and the peak device memory; the
   8-way plans' ``collective_bytes`` at D = 4481: ER's halo below FC's
   gather, q8 a quarter of ER's float32 payload.
6. ``parity``  — one NetES step at N = 64 on the GPU and on the CPU from the
   same parameters and draws must agree, without and with a channel (whose
   dropout masks, drawn on each device, must be equal).
6b. ``es_step`` — standard ES (``core.netes.es_step``, the paper's
   baseline) on pendulum at N = 1000, 3 iterations from one θ, ε and the
   reset states from one generator: finite rewards, θ moved, each step's
   ms; the last step under ``set_sync_debug_mode("error")``.
7. ``serve_parity`` — mistral-nemo-12b at full width and 2 layers, B = 2,
   a 256-token prompt, 8 new tokens: the prefill and decode logits of the
   kernel path against the port's plain full ``forward`` in float64 on
   the card (bf16 attention must fail the same tolerance).
8. ``serve_cpu_parity`` — the smoke model's greedy serving on the GPU
   against the CPU from the same weights.
9. ``serve`` — ``ServeEngine.generate`` of mistral-nemo-12b at full width
   and full depth (40 layers, 46.3 GB of float32 weights drawn on the
   card from a seed), 16 greedy tokens: (a) B = 1 with an 8192-token
   prompt, (b) B = 8 with 512-token prompts. The launch counters are
   zeroed just before each ``generate`` and read just after: 40 flash
   launches each. Then the same steps timed with CUDA events (prefill,
   each decode step) and profiled with ``torch.profiler``.
9b. ``forward_long`` — the full forward (``netes_dist.make_prefill_step``,
   whose attention is ``blockwise_attention``: query blocks of 512, key
   blocks of 1024, never the whole (S, S) scores) of mistral-nemo-12b at
   full width and 4 layers, float32, 1 × 32,768 (the reference's
   prefill_32k): ms (CUDA events and the host clock), peak memory, a
   profiled run's device idle share; no flash launch in it; the logits of
   the last 512 positions against the flash-kernel path's layers (4
   launches) within 1e-4·max|logit|.
10. ``moe_parity`` — moonshot-v1-16b-a3b at full width and 2 layers (the
   dense layer 0, then one MoE layer of 64 experts, top-6), B = 2,
   512-token prompts (one group of 512 per row, capacity 60: choices
   drop), 8 new tokens: every prompt position's logits of the kernel path
   against the float64 ``forward``, and each decode step's against the
   float64 ``forward`` in groups of one token (as decode routes). Routing
   decisions that differ between float32 and float64 are counted; each
   must lie at a float64 margin below 1e-5, and the logits are compared on
   the tokens whose routing agrees.
11. ``moe_cpu_parity`` — the moonshot smoke model's greedy serving on the
   GPU against the CPU from the same weights.
12. ``serve`` of moonshot-v1-16b-a3b at full width and 24 of its 48 layers
   (1 dense + 23 MoE, 53.9 GB of float32 weights; all 48 do not fit in
   80 GB), after mistral's weights are freed, as in 9: 24 flash and
   23 × 16 = 368 ``moe_topk`` launches per ``generate``.
13. ``rwkv_parity`` — rwkv6-7b at full width and 2 layers, B = 2, 512-token
   prompts, 8 new tokens: the kernel path's prefill and decode logits
   against the float64 ``forward`` (the chunked form) on the card.
14. ``rwkv_cpu_parity`` — the rwkv6 smoke model's greedy serving on the GPU
   against the CPU from the same weights.
15. ``serve`` of rwkv6-7b at full width and full depth (32 layers, 29.1 GB
   of float32 weights), after moonshot's weights are freed, as in 9:
   32 × 16 = 512 ``rwkv6_wkv`` launches per ``generate`` (one per layer in
   the prefill and in each decode step).
16. ``jamba_parity`` — jamba-v0.1-52b at full width and 2 layers (mamba +
   MoE of 16 experts, top-2, then sliding attention (window 4096) +
   SwiGLU), B = 2, 512-token prompts (one group of 512 per row, capacity
   80), 8 new tokens: every prompt position's and each decode step's
   logits of the kernel path against the float64 ``forward`` with the MoE
   grouped as served (the prompt in groups of 512, each fed-back token
   alone), on each row up to its first routing difference from float64
   (counted; each must lie at a float64 margin below 1e-5).
17. ``jamba_cpu_parity`` — the jamba smoke model's greedy serving on the
   GPU against the CPU from the same weights, with 128-token prompts
   (twice its window of 64).
18. ``serve`` of jamba-v0.1-52b at full width and 8 of its 32 layers (one
   period: 7 mamba layers, 4 MoE, 1 sliding attention; 52.1 GB of
   float32 weights; all 32 are 205.2 GB), after rwkv6's weights are
   freed, as in 9: 7 × 16 = 112 ``mamba_scan``, 1 flash and 4 × 16 = 64
   ``moe_topk`` launches per ``generate``.
19. ``gemma_parity`` — gemma3-4b at full width and 6 layers (one period: 5
   sliding layers of window 1024, then a global one; qk-norm; heads of
   256), B = 2, 1280-token prompts (the sliding layers' 1024-slot rings
   wrap in prefill), 8 new tokens: the kernel path's prefill and decode
   logits against the float64 ``forward`` on the card, within
   1e-4·max|logit|, and each layer's cache slots.
20. ``gemma_cpu_parity`` — the gemma smoke model's greedy serving on the
   GPU against the CPU, 128-token prompts (twice its window of 64).
21. ``serve`` of gemma3-4b at full width and full depth (34 layers, 15.52
   GB of float32 weights), after jamba's weights are freed, as in 9: 34
   flash launches per ``generate`` (the head_dim-256 instance), 5 of them
   global and 29 windowed.
21a. ``llama4_parity`` — llama4-scout-17b-a16e at full width and 2
   layers (a chunked MoE layer with its chunk cut to 512, then a global
   MoE layer: the offset cut to 1; 16 experts, top-1; qk-norm), B = 2,
   1536-token prompts (two chunk boundaries, three MoE groups of 512 a
   row), 4 decode steps from the first position of a new chunk: the
   kernel path's last prefill and decode logits against the float64
   ``forward`` with the MoE grouped as served, within 1e-4·max|logit|, on
   each row up to its first routing difference (counted; each at a
   float64 margin below 1e-5); the cache rings; one prefill under the
   sync check.
21b. ``serve_cpu_parity`` of both llama4 smoke models, 192-token prompts
   (three of their chunks of 64).
21c. ``serve`` of llama4-scout-17b-a16e at full width and 4 of its 48
   layers (one period: 3 chunked layers and the global one, 37.36 GB),
   as in 9 plus run (c) B = 1 × 16,384, where the chunk mask acts: 4
   flash launches per ``generate`` (1 global, 3 windowed) and 4 × 16 = 64
   ``moe_topk``.
21d. ``maverick_moe`` and ``serve`` of llama4-maverick-400b-a17b at full
   width and its first 2 layers (MoE of 128 experts, top-1, then SwiGLU;
   both chunked; 69.57 GB): first its MoE layer on its own input from a
   1 × 2048 prompt against a float64 product one expert at a time, with
   the kernel's ids (checked against the plain version under the tie
   rule) and the port's capacity and drops, within 1e-4·max|y|; then runs
   (a) and (b) as in 9 (2 flash launches, 16 ``moe_topk``), each run's
   peak under the card's total less 2 GB, with ``mem_get_info``.
21e. ``whisper_parity`` — whisper-tiny at full width and depth (4
   encoder and 4 decoder layers), B = 2, 1500 stub frames, 64-token
   prompts, 8 new tokens: the kernel path's prefill and decode logits
   against the float64 ``forward`` (blockwise attention: 1500 frames pad
   the last key block of 1024, whose 548 padded keys must add nothing),
   within 1e-4·max|logit|, and the encoder's output against its float64;
   12 flash launches a prefill (4 encoder, 4 self, 4 cross); one prefill
   under the sync check.
21f. ``serve_cpu_parity`` of whisper-tiny-smoke at its own 4 heads of 32
   (the flash kernel's head_dim-32 instance), with frames; ``serve`` of
   whisper-tiny at full depth (0.155 GB) with 1500 stub frames: (a) B =
   1 and (b) B = 8 with a 4-token prompt, (c) B = 1 with a 432-token one (448 positions with the new tokens, the model
   card's context): 12 flash launches per ``generate``, all global.
21g. ``llava_parity`` — llava-next-mistral-7b at full width and 2
   layers: serving (B = 2, 256-token prompts, the patches given to
   ``generate`` and dropped, as the reference's serving drops them)
   against the float64 ``forward``; then a vision batch of 2880 patches
   and 1216 tokens: the fused ``forward`` against float64 within
   1e-4·max|logit| and ``loss_fn`` (the kernels) within 1e-5 relative.
21h. ``serve_cpu_parity`` of the llava smoke; ``llava_loss`` (``loss_fn``
   at all 32 layers on a vision batch of 4096 positions: CUDA-event ms,
   peak, 32 flash launches, one call under the sync check) and ``serve``
   of llava-next-mistral-7b at all 32 layers (28.44 GB) as in 9, the
   patches given and dropped: 32 flash launches per ``generate``.
22. ``lm_netes`` — NetES over LM agents (``train_lm_netes``, the replica
   step of ``distributed.netes_dist``): gemma3-4b at full width and 6 of
   its 34 layers (one period; 4.95 GB an agent), N = 8 agents of one
   2048-token sequence each, 3 iterations (``LM_CASES``): (i) fully
   connected (``netes_mixing``), (ii) ER p = 0.5, sparse
   (``netes_sparse_mixing``), (iii) (ii) through channel (a) (both fused
   kernels, and the sparse kernel for the ε term). The counters are
   zeroed just before each run and read just after: each Eq. 3 kernel of
   the case launches once a slab (125 a step), flash 96 times a step (6
   layers × 16 evaluations, 5 windowed to 1 global). Per case the steps'
   ms (CUDA events), losses, the peak device memory (under 60 GB), and
   one more step under ``torch.profiler`` (the device's idle share); one
   step of (i) and of (iii) under the sync check. Before (i), its first
   step against float64 on the card: each agent's ± loss within 1e-5
   relative, the order of every two rewards float64 separates, and the
   last 4096 columns of every leaf's update within 3e-5·S.
22b. ``lm_netes`` of whisper-tiny at full width and depth (49.6 M
   parameters an agent), N = 8, one 448-token sequence beside 1500 frames
   an agent, 3 iterations on fully connected and on ER p = 0.5, as in 22
   (12 flash launches a loss, all global; the first step against float64;
   one step of each under the sync check).
23. ``lm_netes_cpu_parity`` — one replica step of gemma3-4b-smoke (FC),
   moonshot-v1-16b-a3b-smoke (ER: the router kernel) and
   jamba-v0.1-52b-smoke (ER through channel (a): the scan kernel) on the
   card against the CPU from the same parameters and draws, within 2e-5.
24. ``consensus`` — the consensus placement through ``launch/specs``:
   ``classify`` of llama4-scout-17b-a16e's and jamba-v0.1-52b's
   ``train_4k`` on a world-of-one mesh (consensus, P = 256), cut to P = 8
   and 2 layers at full width (``reduced``), one 1 × 4096 microbatch a
   member, ``build_step``'s step: (i) scout fully connected, (ii) ER p =
   0.5, (iii) (ii) through ``quantize(bits=8)|dropout(p=0.1)``, 3 steps
   each with β injected (no broadcast, broadcast, none), (iv) jamba on ER,
   2 steps. Per case: launches a step (scout flash 32, router 32; jamba
   scan 32, router 16; the select one a slab in (iii) only; the Eq. 3
   kernels none), step ms (CUDA events), finite ± losses, the peak under
   2θ + 10 GB beside θ, (iii)'s messages = broadcast·P; (ii)'s step 0,
   the step itself, against float64 given rewards that ``member_rewards``
   takes of the same θ (equal to the step's); θ after step 0 differing
   between (i) and (ii); the last step of (iii) and (iv) under the sync
   check, of (i) profiled (idle share, time by kind).
25. ``tooling`` — the dry run's accounting against the card (PR 30): for
   scout and jamba at phase 24's cut (ER p = 0.5), ``launch/specs.lower``
   of the pair traced on fake CUDA tensors under a ``launch/op_costs``
   recorder (the members folded), then one real step under a recorder
   (the kernels reporting their dot FLOPs) and one more timed by CUDA
   events: the two ``dot_flops`` must be equal, the predicted peak
   (arguments + the fake run's live-storage peak) within 15% of
   ``torch.cuda.max_memory_allocated`` over the step, and the roofline's
   bound at the H100's constants (``launch/analysis.py``) at most the
   measured step (a ``tooling_case`` line each). Then every one-device
   entry point of the contract linter (``repro_torch.analysis``) built on
   the card and called under ``torch.cuda.set_sync_debug_mode("error")``,
   its returned state as stable as the linter holds it; one ``tooling``
   line (the launches of the phase: ``launches_tooling`` in the kernels
   line). Then the script's total seconds (a ``total`` line).
The kernel phases also run the consensus step's kernels at its shapes,
each against its plain version and float64 as at the other shapes:
flash at 1 × 4096, 40/8 heads of 128 under scout's chunk of 8192; the
router at 4096 × 16, top-1 (scout) and top-2 (jamba); the scan at 1 ×
4096 × 8192 × 16; the select on one row, a slab of 2²⁴ columns and a
ragged last one of a leaf (``consensus_shapes`` in the kernels line).
The kernel phases also run the four Eq. 3 kernels at the LM step's
shapes, N = 8 by 16,777,216 columns (gemma3-4b's embedding slab) and by
5,242,880 (a layer's ``wq``), and flash at 1 × 2048, 8/4 heads of 256,
global and window 1024. ``torch.sparse.mm``, the sparse and fused
kernels' library yardstick, returns wrong values at 16,777,216 columns:
there its error is printed (``library_agrees``: false) and its time left
out. At both LM shapes those two kernels are also timed against
``torch.matmul`` on the dense weight (``matmul_ms``, held to 3e-5·S).
Every ``serve`` phase counts the flash calls by mask (global or windowed)
against the layers' kinds.
``no_sync`` (in phases 7, 13, 16, 19 and 21a): one prefill of
mistral-nemo-12b, of rwkv6-7b, of jamba-v0.1-52b (full width, 2 layers),
of gemma3-4b (6 layers) and of llama4-scout (2 layers) under
``torch.cuda.set_sync_debug_mode("error")``: any call that waits for the
card raises there.

Then a ``{"kernels": [...]}`` line (``launches``: the main path's and
channel run (a)'s; ``launches_schedule``: each schedule run's;
``launches_telemetry``: each probed run's and the traced generate's;
``launches_capture_replay``: the Eq. 3 kernel in one replay of each
captured step; ``launches_search``: each tournament's; the flash row's
``launches_gemma3_4b`` and its ``hd256`` and ``hd256_local`` times,
``launches_llama4_scout`` (runs (a) and (c), by mask) and
``launches_llama4_maverick``, and its ``llama4_global`` and
``llama4_chunk`` times, ``launches_whisper_tiny`` (each run, by mask),
``launches_llava``, ``launches_whisper_tiny_smoke_hd32`` (the
head_dim-32 instance in the smoke's GPU serving),
``launches_forward_long_kernel_path``, and the ``whisper_encoder``,
``whisper_cross``, ``llava_loss``, ``hd32_noncausal`` and ``hd32_causal``
times; the router row's ``launches_llama4`` (each run of
scout and maverick) and ``llama4_cases``;
``launches_lm_netes``: a step of each ``lm_netes`` case; ``lm_shapes``:
the times at the LM step's shapes; ``launches_shard``: each ``shard`` and
``shard_scale`` run's launches of the row's R × S instance (the select's
own); rows 1–3's ``rs`` and ``rs_cases``: the R × S instance's numbers
from ``kernel_shard``; ``launches_consensus``: a step of each
``consensus`` case; ``launches_tooling`` (``_rs``): the ``tooling``
phase's; ``consensus_shapes``: the kernel cases at the
consensus step's shapes), the ``nvidia-smi`` name and power limit, and last ``{"ok": true, "device":
{...}}``. Any failure raises, so the script exits non-zero and prints no
result. It imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import functools
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks from NVIDIA's data sheet: float32 on the CUDA
# cores, and HBM3 bandwidth. Both assume the full 700 W power limit.
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

# |kernel − float64 reference| ≤ TOL_REL · S elementwise, where S is the
# same sum taken over absolute values (Σ|a w θ_i| + σΣ|a w ε_i| + |wsum θ_j|).
# Rounding each of the ≤ 2N f32 additions in any order leaves an error that
# random-walks to ≈ √(2N)·u/√3·S ≈ 1.5e-6·S at N = 1000 (u = 6e-8); 3e-5 is
# 20 of those, while dropping a single source term is ≈ S/N = 1e-3·S.
# The fused wire sum Σ_k ws_jk·codes[idx_jk] is held to the same bound with
# S = Σ_k |ws_jk·codes[idx_jk]|: it adds K_max ≤ 130 terms (≈ 7e-7·S), and
# dropping one is ≈ S/K_max ≈ 8e-3·S.
TOL_REL = 3e-5

MAIN_N, MAIN_P_ER, MAIN_ITERS, EVAL_EPISODES = 1000, 0.1, 4, 16

# The main path through a lossy channel: (run, family, density, channel).
CHANNEL_RUNS = (
    ("a", "erdos_renyi", MAIN_P_ER, "quantize(bits=8)|dropout(p=0.1,seed=0)"),
    ("b", "fully_connected", 1.0,
     "event_triggered(threshold=0.01)|quantize(bits=4)|dropout(p=0.1,seed=0)"),
)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def nvidia_smi(query: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# the card's clocks, temperature and active throttle reasons: a card that
# runs slower under the same name and power limit shows here
CLOCKS = ("clocks.sm,clocks.mem,clocks.max.sm,temperature.gpu,"
          "clocks_throttle_reasons.active")


# NetES over LM agents (phase 22): gemma3-4b at full width and one period
# of its stack (5 sliding layers of window 1024, then a global one; 4.95 GB
# of float32 weights an agent), N = 8 agents (the reference launcher's
# example), one 2048-token sequence an agent, 3 iterations; 39.6 GB of
# parameters. (case, family, density, representation, channel)
LM_N, LM_LAYERS, LM_SEQ, LM_ITERS, LM_P_ER = 8, 6, 2048, 3, 0.5
LM_CASES = (("i", "fully_connected", 1.0, "dense", None),
            ("ii", "erdos_renyi", LM_P_ER, "sparse", None),
            ("iii", "erdos_renyi", LM_P_ER, "sparse", CHANNEL_RUNS[0][3]))
# σ of 1e-3 against weights of ≈ 0.02; a step changes a weight by about
# α/(Nσ²)·2σ = 2.5e-4, ≈ 1 % of it
LM_ALPHA, LM_SIGMA, LM_P_BROADCAST = 1e-6, 1e-3, 0.5
LM_PEAK_BYTES = 60e9        # the step's peak device memory must stay below
TOL_LM_LOSS = 1e-5          # an agent's ± loss against float64, relative
LM_CHECK_COLS = 4096        # columns of each leaf held against float64
# the Eq. 3 kernels timed at the LM step's shapes: gemma3-4b's embedding
# slab (SLAB_COLUMNS of its 671 M columns) and a layer's wq leaf (2560·8·256)
LM_KERNEL_SHAPES = (("lm_embed_slab", 1 << 24), ("lm_wq_leaf", 5_242_880))
# the dense yardstick (PyTorch's default keeps TF32 off for matmul)
MATMUL = "torch.matmul (f32, TF32 off)"
LM_KERNEL_GRAPHS = (("netes_mixing", "fully_connected", 1.0),
                    ("netes_sparse_mixing", "erdos_renyi", LM_P_ER))
# one replica step of each smoke model on the card and on the CPU with the
# same draws: (arch, family, representation, channel); 128-token
# sequences (two of the smoke's MoE groups, twice its window)
LM_PARITY_CASES = (
    ("gemma3-4b-smoke", "fully_connected", "dense", None),
    ("moonshot-v1-16b-a3b-smoke", "erdos_renyi", "sparse", None),
    ("jamba-v0.1-52b-smoke", "erdos_renyi", "sparse", CHANNEL_RUNS[0][3]))
LM_PARITY_N, LM_PARITY_SEQ, LM_MIN_MARGIN = 4, 128, 2e-5
# NetES over whisper-tiny agents at full width and depth (4 + 4 layers;
# 49.6 M parameters an agent with the 32,768-row position table): one
# 448-token sequence (the model card's context) beside 1500 frames an
# agent, fully connected and ER p = 0.5
LM_WHISPER_SEQ = 448
LM_WHISPER_CASES = (("whisper-i", "fully_connected", 1.0, "dense", None),
                    ("whisper-ii", "erdos_renyi", LM_P_ER, "sparse", None))

L2_FLUSH_BYTES = 64 << 20   # above the H100's 50 MB L2
SELECT_ITERS = 100          # timed launches of the broadcast select
SPIN_CYCLES = 2_000_000     # ≈ 1 ms of the card's clock


def time_stats(fn, warmup: int = 3, iters: int = 20) -> dict:
    """CUDA-event times of ``iters`` launches after warm-up: the median
    ``ms`` and the quartiles ``ms_q1``, ``ms_q3``.

    Before each timed launch a 64 MB buffer is read, outside the events,
    so every launch starts with a cold L2, as on the main path, where the
    rollout runs between two mixing updates. The flush reads rather than
    writes: it leaves the L2 holding clean lines only, so no write-back
    of the flush's own lines lands inside the timed launch. Then the card
    spins for ≈ 1 ms (``torch.cuda._sleep``), so that the host has queued
    the start event, the launch and the end event before the card reaches
    them: the events time the card's work, not the host's path to the
    launch (tens of µs, more than a small kernel takes).
    """
    import torch
    flush = torch.ones(L2_FLUSH_BYTES // 4, device="cuda")
    sink = torch.empty((), device="cuda")
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        torch.sum(flush, dim=0, out=sink)
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    q1, med, q3 = statistics.quantiles(
        [s.elapsed_time(e) for s, e in pairs], n=4)
    return {"ms": med, "ms_q1": q1, "ms_q3": q3}


def time_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    """The median of :func:`time_stats`."""
    return time_stats(fn, warmup, iters)["ms"]


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------

def _lm_row(row: dict) -> dict:
    """The numbers of a kernel row that the kernels line carries for an
    LM NetES shape."""
    keep = ("n", "p", "d", "k_max", "sq", "window", "max_abs_err", "ms",
            "ms_q1", "ms_q3", "plain_ms", "library", "library_ms",
            "library_agrees", "library_err_over_S", "matmul_ms",
            "matmul_err_over_S", "bound_ms", "bound_by", "share_of_bound")
    return {k: row[k] for k in keep if k in row}


def _consensus_shape(results: dict, name: str, row: dict) -> None:
    """Files a kernel case at a shape of the consensus step under the
    kernels line's ``consensus_shapes``."""
    keep = ("max_abs_err", "max_err_f64", "gates_err_f64", "err_over_S_f64",
            "rows_ids_differ", "ms", "ms_q1", "ms_q3", "plain_ms",
            "library_ms", "bound_ms", "bound_by", "flag_clear", "flag_set")
    results.setdefault("consensus_shapes", {}).setdefault(name, {})[
        row["shape"]] = {k: row[k] for k in keep if k in row}


def _operands(n: int, p: int, seed: int):
    """θ at the policy's init scale, ε ~ N(0, 1) and the antithetic
    centered-rank weights R̃ of random returns, as one NetES step makes."""
    import torch

    from repro_torch.core import es_utils
    g = torch.Generator(device="cuda").manual_seed(seed)
    theta = 0.3 * torch.randn(n, p, device="cuda", generator=g)
    eps = torch.randn(n, p, device="cuda", generator=g)
    ranks = es_utils.centered_rank(
        torch.randn(2 * n, device="cuda", generator=g))
    shaped = (ranks[:n] - ranks[n:]).contiguous()
    return theta, eps, shaped


def _graph(n: int, family: str, p: float, seed: int):
    from repro_torch.core.topology import TopologySpec
    return TopologySpec(family=family, n_agents=n, p=p, seed=seed).build()


def _check_against_f64(name, out, adj64, w, theta, eps, sigma,
                       strict: bool = True):
    """The S-scaled bound above, against Eq. 3 in float64 on the dense
    adjacency (the sparse function equals the dense one on its graph).
    Returns the worst |err|/S; with ``strict=False`` it raises not and
    returns (worst |err|/S, whether within the bound)."""
    import torch

    from repro_torch.kernels import ref
    w64, th64, ep64 = w.double(), theta.double(), eps.double()
    exact = ref.netes_mixing_ref(adj64, w64, w64, th64, ep64, sigma=sigma)
    wa = adj64.abs() * w64.abs()[None, :]
    scale = (wa @ th64.abs() + abs(sigma) * (wa @ ep64.abs())
             + (adj64 * w64[None, :]).sum(1).abs()[:, None] * th64.abs())
    excess = ((out.double() - exact).abs() - TOL_REL * scale).max().item()
    ratio = ((out.double() - exact).abs() / scale.clamp_min(1e-30)).max()
    if not strict:
        return ratio.item(), excess <= 0.0
    check(excess <= 0.0, f"{name}: error above {TOL_REL}·S "
          f"(worst |err|/S = {ratio.item():.3g})")
    return ratio.item()


def _device_ms(fn) -> dict:
    """Device ms of each kernel one call of ``fn`` runs (a torch.profiler
    trace, warm L2): the parts of a multi-kernel wrapper, and which kernel
    a library yardstick picks, and so on which units it computes."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {evt.key[:120]: getattr(evt, "self_device_time_total", 0.0) / 1e3
            for evt in prof.key_averages()
            if evt.device_type == torch.autograd.DeviceType.CUDA}


def _slab_launch(mod, pl) -> dict:
    """The launch of a slab kernel (``kernels/_slab.py``) on plan ``pl``:
    grid, resident blocks per SM, slab width, sender chunks, and the
    registers and local (spill) bytes per thread from the library's
    queries."""
    import torch
    occ = mod.occupancy(pl.n, torch.cuda.current_device())
    check(occ["local_bytes"] == 0, f"{mod.__name__}: {occ['local_bytes']} "
          "bytes of local memory per thread (spill)")
    return {"grid_blocks": pl.grid, "resident_blocks_per_sm": pl.resident,
            "slab_cols": pl.slab, "slabs": pl.slabs, "chunks": pl.chunks,
            "chunk_rows": pl.chunk_rows, "smem_bytes": pl.smem_bytes,
            "registers": occ["registers"],
            "spill_bytes": occ["local_bytes"]}


def _kernel_launches(fn, calls: int = 5) -> dict:
    """What ``calls`` calls of ``fn`` put on the card, from one
    torch.profiler trace: the runtime's launch calls on the host
    (``runtime``), and the kernels on the device (``kernels``), each by
    name with its count; library kernels and ours alike."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.key_averages()
    return {"calls": calls,
            "runtime": {e.key: e.count for e in events
                        if e.device_type != cuda and "Launch" in e.key},
            "kernels": {e.key[:120]: e.count for e in events
                        if e.device_type == cuda}}


def kernel_phase(results: dict, lm_results: dict) -> None:
    import numpy as np
    import torch

    from repro_torch.core.topology_repr import sparse_neighbors
    from repro_torch.kernels import netes_mixing as nm
    from repro_torch.kernels import netes_sparse_mixing as nsm
    from repro_torch.kernels import ref

    sigma = 0.1
    cases = [  # (kernel, label, family, density, n, p, main-path shape?)
        ("netes_mixing", "fc_main", "fully_connected", 1.0, MAIN_N, 4481, True),
        # the paper's 3000 agents fully connected (abstract; Fig. 2B)
        ("netes_mixing", "fc_3000", "fully_connected", 1.0, 3000, 4481,
         False),
        ("netes_mixing", "fc_32", "fully_connected", 1.0, 32, 4481, False),
        ("netes_mixing", "er_ragged", "erdos_renyi", 0.3, 257, 700, False),
        ("netes_sparse_mixing", "er_main", "erdos_renyi", MAIN_P_ER, MAIN_N,
         4481, True),
        ("netes_sparse_mixing", "er_ragged", "erdos_renyi", 0.3, 257, 700,
         False),
        # the paper's largest N (Fig. 2B): two sender chunks
        ("netes_sparse_mixing", "er_3000", "erdos_renyi", MAIN_P_ER, 3000,
         4481, False),
        # four sender chunks: the slab of 5000 senders fits no block
        ("netes_sparse_mixing", "er_chunked", "erdos_renyi", 0.02, 5000, 700,
         False),
    ] + [(kname, label, family, dens, LM_N, p, False)
         for kname, family, dens in LM_KERNEL_GRAPHS
         for label, p in LM_KERNEL_SHAPES]
    for kname, label, family, dens, n, p, main in cases:
        adj_np = _graph(n, family, dens, seed=0)
        theta, eps, w = _operands(n, p, seed=n + p)
        adj64 = torch.as_tensor(adj_np, dtype=torch.float64, device="cuda")
        if kname == "netes_mixing":
            adj = torch.as_tensor(adj_np, device="cuda")
            args = (adj, w, w, theta, eps)
            kernel = functools.partial(nm.netes_mixing, *args, sigma=sigma)
            plain = functools.partial(ref.netes_mixing_ref, *args, sigma=sigma)
            nnz, k_max = int(np.count_nonzero(adj_np)), n
            topo_bytes = 4 * n * n
        else:
            idx_np, mask_np = sparse_neighbors(adj_np)
            idx = torch.as_tensor(idx_np, device="cuda")
            mask = torch.as_tensor(mask_np, device="cuda")
            args = (idx, mask, w, w, theta, eps)
            kernel = functools.partial(nsm.netes_sparse_mixing, *args,
                                       sigma=sigma)
            plain = functools.partial(ref.sparse_mixing_ref, *args,
                                      sigma=sigma)
            nnz, k_max = int(np.count_nonzero(mask_np)), idx_np.shape[1]
            topo_bytes = 8 * n * k_max
        out_k, out_p = kernel(), plain()
        torch.cuda.synchronize()
        check(torch.isfinite(out_k).all().item(), f"{kname}/{label}: non-finite")
        check(torch.equal(kernel(), out_k),
              f"{kname}/{label}: two launches differ")
        if kname == "netes_mixing":
            pl = nm.launch_plan(n, p, "cuda")
            launch = {"grid_blocks": pl.grid_blocks,
                      "resident_blocks_per_sm": nm.occupancy(
                          torch.cuda.current_device())[0],
                      "tiles_whole": pl.full, "tiles_split": pl.rem,
                      "split": pl.split}
        else:
            pl = nsm.launch_plan(n, p, k_max, "cuda")
            check(not isinstance(pl, nsm.BandPlan),
                  f"{kname}/{label}: the band instance at N = {n}")
            launch = _slab_launch(nsm, pl)
        rel_k = _check_against_f64(f"{kname}/{label}", out_k, adj64, w, theta,
                                   eps, sigma)
        rel_p = _check_against_f64(f"{kname}/{label} plain", out_p, adj64, w,
                                   theta, eps, sigma)
        max_abs = (out_k - out_p).abs().max().item()

        # The library yardstick: ONE PyTorch call computing the same map,
        # out = W @ [θ; ε] with W = [a⊙R̃θ − diag(wsum) | σ·a⊙R̃ε] (N, 2N);
        # W and the stacked operand are built outside the timed call.
        a = torch.as_tensor(adj_np, device="cuda")
        wt = a * w[None, :]
        big_w = torch.cat([wt - torch.diag(wt.sum(1)), sigma * wt], dim=1)
        stacked = torch.cat([theta, eps], dim=0)
        matmul = functools.partial(torch.matmul, big_w, stacked)
        if kname == "netes_mixing":
            lib_name, lib = MATMUL, matmul
        else:
            lib_name = "torch.sparse.mm (CSR)"
            big_csr = big_w.to_sparse_csr()
            lib = functools.partial(torch.sparse.mm, big_csr, stacked)
        # at the LM shapes torch.sparse.mm has returned wrong values: its
        # error is reported there, and a wrong result gets no time; the
        # sparse kernel's LM rows also time torch.matmul on the dense
        # weight (the same function), the yardstick where the CSR one fails
        lm = label.startswith("lm_")
        rel_l = _check_against_f64(f"{kname}/{label} library", lib(), adj64,
                                   w, theta, eps, sigma, strict=not lm)
        rel_l, lib_ok = rel_l if lm else (rel_l, True)
        dense_lib = {}
        if lm and kname != "netes_mixing":
            dense_lib = {
                "matmul_err_over_S": _check_against_f64(
                    f"{kname}/{label} {MATMUL}", matmul(), adj64, w, theta,
                    eps, sigma),
                "matmul_ms": time_ms(matmul)}

        # Eq. 3's least work is its factored form (the same function):
        # Y = R̃θ·θ + σR̃ε·ε (3 flops an element), one FMA per edge and
        # column, and out = Σ m·Y − wsum·θ_j (2 flops an element). The
        # unfactored sum's bound (two FMAs per edge and column) stays beside
        # it, to compare with earlier runs.
        flops = 2.0 * nnz * p + 5.0 * n * p
        flops_unfactored = 4.0 * nnz * p
        moved = 4.0 * (3 * n * p + 2 * n) + topo_bytes
        t_ops, t_bytes = flops / F32_FLOPS, moved / HBM_BYTES_PER_S
        t_unf = max(flops_unfactored / F32_FLOPS, t_bytes)
        row = {"phase": "kernel", "name": kname, "shape": label, "n": n,
               "p": p, "k_max": k_max, "nnz": nnz,
               "max_abs_err": max_abs, "max_err_over_S": rel_k,
               "plain_err_over_S": rel_p, "library_err_over_S": rel_l,
               "tol_over_S": TOL_REL, **launch,
               **time_stats(kernel), "plain_ms": time_ms(plain),
               "library": lib_name,
               "library_ms": time_ms(lib) if lib_ok else None,
               "library_agrees": lib_ok, **dense_lib,
               "bound_ms": 1e3 * max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "gflop": flops / 1e9, "mbytes": moved / 1e6,
               "bound_ms_unfactored": 1e3 * t_unf,
               "gflop_unfactored": flops_unfactored / 1e9}
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        row["share_of_unfactored_bound"] = 1e3 * t_unf / row["ms"]
        if main:
            row["kernel_parts_ms"] = _device_ms(kernel)
            row["library_kernels_ms"] = _device_ms(lib)
        emit(row)
        if main:
            results[kname] = row
        if label.startswith("lm_"):
            lm_results.setdefault(kname, {})[label] = _lm_row(row)
        del out_k, out_p, args, big_w, stacked
        torch.cuda.empty_cache()


# The band instance of sparse Eq. 3 (``sparse_mixing_slab_l2``) at the ER
# cell's shape (N = 16,384, G(N, 0.0005) with self-loops, the pendulum
# policy's P = 4481), then the shapes that place the choice between the two
# instances (``nsm.uses_band``), both instances checked and timed at each:
# (label, N, p, P). The graphs are the port's own (``_graph``, topology
# seed 0); K_max as drawn there.
BAND_CELL = ("er_16384", 16_384, 0.0005, 4481)        # 11 chunks, K_max 22
BAND_CROSSOVER = (
    ("er_3000", 3000, 0.1, 4481),                     # 2 chunks, K_max 358
    ("er_5000", 5000, 0.02, 700),                     # 4 chunks, K_max 146
    ("er_1600", 1600, 0.005, 4481),                   # 2 chunks, K_max 21
    ("er_3000_p0.002", 3000, 0.002, 4481),            # 2 chunks, K_max 17
    ("er_3000_p0.005", 3000, 0.005, 4481),            # 2 chunks, K_max 32
    ("er_3000_p0.01", 3000, 0.01, 4481),              # 2 chunks, K_max 51
    ("er_16384_p0.002", 16_384, 0.002, 4481),         # 11 chunks
    ("er_16384_p0.004", 16_384, 0.004, 4481),         # 11 chunks
    ("er_16384_p0.008", 16_384, 0.008, 4481),         # 11 chunks
)
# netes_step iterations of the main path at the ER cell's shape
BAND_MAIN_ITERS = 3


def _er_list(n: int, p_edge: float, seed: int = 0):
    """The padded neighbor list of the port's G(N, p) with self-loops
    (``_graph``), on the card, and its real directed edges."""
    import torch

    from repro_torch.core.topology_repr import sparse_neighbors
    adj = _graph(n, "erdos_renyi", p_edge, seed)
    idx_np, mask_np = sparse_neighbors(adj)
    edges = int((adj != 0).sum())
    del adj
    return (torch.as_tensor(idx_np, device="cuda"),
            torch.as_tensor(mask_np, device="cuda"), edges)


def _check_sparse_f64(name, out, idx, mask, w, theta, eps, sigma):
    """``_check_against_f64``'s bound from the padded list itself (the
    plain sparse version in float64), ``w`` the weight of both θ and ε:
    no (N, N) operand at N = 16,384. Returns the worst |err|/S."""
    import torch

    from repro_torch.kernels import ref
    m64, w64 = mask.double(), w.double()
    th64, ep64 = theta.double(), eps.double()
    exact = ref.sparse_mixing_ref(idx, m64, w64, w64, th64, ep64,
                                  sigma=sigma)
    wa = m64.abs() * w64.abs()[idx.long()]
    scale = ref.sparse_mixing_ref(idx, wa, torch.ones_like(w64),
                                  torch.ones_like(w64), th64.abs(),
                                  ep64.abs(), sigma=abs(sigma))
    # the plain version subtracts Σ|a w|·|θ_j|; S adds |Σ a w|·|θ_j|
    wsum = (m64 * w64[idx.long()]).sum(1).abs()
    scale += (wa.sum(1) + wsum)[:, None] * th64.abs()
    err = (out.double() - exact).abs()
    ratio = (err / scale.clamp_min(1e-30)).max().item()
    check((err - TOL_REL * scale).max().item() <= 0.0,
          f"{name}: error above {TOL_REL}·S (worst |err|/S = {ratio:.3g})")
    return ratio


def band_kernel_phase(results: dict) -> None:
    """The band instance at the ER cell's shape against the float64 plain
    version, two launches equal, the wrapper's choice of it (its own
    launch count), its time beside the 0.263 ms bound, the slab
    instance's time and ``torch.sparse.mm``'s; then both instances
    against float64 and timed at each crossover shape."""
    import torch

    from repro_torch.kernels import netes_sparse_mixing as nsm
    sigma = 0.1
    for label, n, p_edge, p in (BAND_CELL,) + BAND_CROSSOVER:
        cell = label == BAND_CELL[0]
        idx, mask, edges = _er_list(n, p_edge)
        k_max = idx.shape[1]
        theta, eps, w = _operands(n, p, seed=n + p)
        args = (idx, mask, w, w, theta, eps)
        band_pl = nsm.BandPlan(n=n, cols=p)
        slab_pl = nsm.slab_plan(n, p, "cuda")
        chosen = nsm.launch_plan(n, p, k_max, "cuda")
        outs = {}

        def instance(pl):
            out = outs.setdefault(pl, torch.empty_like(theta))
            return functools.partial(nsm.launch, pl, *args, out, sigma=sigma)

        row = {"phase": "kernel_band", "shape": label, "n": n, "p": p,
               "density": p_edge, "k_max": k_max, "nnz": edges,
               "chunks": slab_pl.chunks,
               "chosen": "band" if isinstance(chosen, nsm.BandPlan)
               else "slab", "uses_band": nsm.uses_band(n, k_max)}
        check(row["uses_band"] == (row["chosen"] == "band"),
              f"band/{label}: launch_plan disagrees with uses_band")
        for name, pl in (("band", band_pl), ("slab", slab_pl)):
            fn = instance(pl)
            fn()
            torch.cuda.synchronize()
            got = outs[pl].clone()
            fn()
            check(torch.equal(outs[pl], got),
                  f"band/{label} {name}: two launches differ")
            row[f"{name}_err_over_S"] = _check_sparse_f64(
                f"band/{label} {name}", got, *args[:3], theta, eps, sigma)
            row[f"{name}_ms"] = time_stats(fn)
        occ = nsm.band_occupancy("cuda")
        check(occ["local_bytes"] == 0, f"band/{label}: {occ['local_bytes']} "
              "bytes of local memory per thread (spill)")
        row.update(band_cols=nsm.BAND, bands=band_pl.bands,
                   grid_blocks=band_pl.grid,
                   resident_blocks_per_sm=occ["resident"],
                   registers=occ["registers"],
                   spill_bytes=occ["local_bytes"])
        # Eq. 3's least time over the real edges (portbench/roofline.py's
        # count): 2·E·P flops; θ and ε read once, θ' written once, an
        # index and a weight an edge
        t_ops = 2.0 * edges * p / F32_FLOPS
        t_bytes = (4.0 * 3 * n * p + 8.0 * edges) / HBM_BYTES_PER_S
        row.update(bound_ms=1e3 * max(t_ops, t_bytes),
                   bound_by="operations" if t_ops >= t_bytes else "bytes")
        row["share_of_bound"] = row["bound_ms"] / row["band_ms"]["ms"]
        if cell:
            # the wrapper: one launch of the band instance a call, none of
            # the slab instance's; its output the band instance's bits
            before = (nsm.KERNEL_BAND.launches, nsm.KERNEL.launches)
            out_w = nsm.netes_sparse_mixing(*args, sigma=sigma)
            check((nsm.KERNEL_BAND.launches - before[0],
                   nsm.KERNEL.launches - before[1]) == (1, 0),
                  f"band/{label}: the wrapper did not launch the band "
                  "instance once")
            check(torch.equal(out_w, outs[band_pl]),
                  f"band/{label}: the wrapper's output differs")
            # W = [a⊙R̃θ − diag(wsum) | σ·a⊙R̃ε] as in ``kernel_phase``; the
            # padding's weight-0 slots index j beside its self-loop: summed
            wt = torch.zeros(n, n, device="cuda")
            rows = torch.arange(n, device="cuda")[:, None].expand_as(idx)
            wt.index_put_((rows, idx.long()), mask * w[idx.long()],
                          accumulate=True)
            big_w = torch.cat([wt - torch.diag(wt.sum(1)), sigma * wt], 1)
            del wt
            big_csr = big_w.to_sparse_csr()
            del big_w
            stacked = torch.cat([theta, eps], dim=0)
            lib = functools.partial(torch.sparse.mm, big_csr, stacked)
            row["library_err_over_S"] = _check_sparse_f64(
                f"band/{label} torch.sparse.mm", lib(), *args[:3], theta,
                eps, sigma)
            row["library"] = "torch.sparse.mm (CSR)"
            row["library_ms"] = time_stats(lib)["ms"]
            del big_csr, stacked
            results["netes_sparse_mixing_band"] = row
        emit(row)
        del outs, args, theta, eps, idx, mask
        torch.cuda.empty_cache()


def _dropout_mask(topo, p: float, seed: int = 0):
    """The channel's own dropout draw 0 for ``topo``."""
    import torch

    from repro_torch.comm import channel
    dev = topo.device
    key = channel.step_key(torch.tensor(seed, device=dev),
                           torch.tensor(0, device=dev))
    return channel.dropout_mask(key, topo, p)


def _check_fused_f64(name, out, idx, ws, codes, strict: bool = True):
    """|out − Σ_k ws·codes[idx]| ≤ TOL_REL·Σ_k |ws·codes[idx]| against a
    float64 sum over the same folded float32 weights. ``strict=False`` as
    in ``_check_against_f64``."""
    import torch
    idx_l = idx.long()
    ws64, c64 = ws.double(), codes.double()
    exact = torch.zeros(codes.shape, dtype=torch.float64, device=codes.device)
    scale = torch.zeros_like(exact)
    for k in range(idx.shape[1]):
        g = c64[idx_l[:, k]]
        exact += ws64[:, k, None] * g
        scale += ws64[:, k, None].abs() * g.abs()
    err = (out.double() - exact).abs()
    excess = (err - TOL_REL * scale).max().item()
    ratio = (err / scale.clamp_min(1e-30)).max().item()
    if not strict:
        return ratio, excess <= 0.0
    check(excess <= 0.0, f"{name}: error above {TOL_REL}·S "
          f"(worst |err|/S = {ratio:.3g})")
    return ratio


def wire_kernel_phase(results: dict, lm_results: dict) -> None:
    """The two fused wire kernels: q8 codes from ``encode`` of a payload at
    the policy's scale, the channel's dropout mask folded into the slot
    weights, at the main path's shapes, a ragged one and N = 5000 (four
    sender chunks). The neighbor sum must give the same bits on two
    launches and make one kernel launch per call."""
    import torch

    from repro_torch.core import wire_format
    from repro_torch.core.topology_repr import from_dense
    from repro_torch.kernels import netes_fused_mixing as nfm
    from repro_torch.kernels import ref

    for label, dens, n, d, main in (("er_main", MAIN_P_ER, MAIN_N, 4481, True),
                                    ("er_ragged", 0.3, 257, 700, False),
                                    # four sender chunks
                                    ("er_chunked", 0.02, 5000, 700, False),
                                    *((label, LM_P_ER, LM_N, p, False)
                                      for label, p in LM_KERNEL_SHAPES)):
        topo = from_dense(_graph(n, "erdos_renyi", dens, seed=0), "sparse",
                          device="cuda")
        theta, eps, w = _operands(n, d, seed=n + d)
        wp = wire_format.encode(theta + 0.1 * eps, 8, batched=True)
        em = _dropout_mask(topo, 0.1)
        args = (topo.neighbor_idx, topo.neighbor_mask, w, wp.codes, wp.scale,
                em)
        kernel = functools.partial(nfm.fused_neighbor_sum, *args)
        plain = functools.partial(ref.fused_neighbor_sum_ref, *args)
        out_k, out_p = kernel(), plain()
        torch.cuda.synchronize()
        check(torch.isfinite(out_k).all().item(),
              f"fused_neighbor_sum/{label}: non-finite")
        check(torch.equal(kernel(), out_k),
              f"fused_neighbor_sum/{label}: two launches differ")
        ws = ref.folded_weights(*args[:3], wp.scale, em)
        rel_k = _check_fused_f64(f"fused_neighbor_sum/{label}", out_k,
                                 topo.neighbor_idx, ws, wp.codes)
        rel_p = _check_fused_f64(f"fused_neighbor_sum/{label} plain", out_p,
                                 topo.neighbor_idx, ws, wp.codes)
        # library: one CSR product of the folded (N, N) weights with the
        # codes widened to float32; both made outside the timed call
        rows = torch.arange(n, device="cuda").repeat_interleave(topo.k_max)
        dense = torch.zeros(n, n, device="cuda").index_put_(
            (rows, topo.neighbor_idx.reshape(-1).long()), ws.reshape(-1),
            accumulate=True)
        big = dense.to_sparse_csr()
        codes_f32 = wp.codes.float()
        lib = functools.partial(torch.sparse.mm, big, codes_f32)
        lm = label.startswith("lm_")     # as in kernel_phase
        rel_l = _check_fused_f64(f"fused_neighbor_sum/{label} library",
                                 lib(), topo.neighbor_idx, ws, wp.codes,
                                 strict=not lm)
        rel_l, lib_ok = rel_l if lm else (rel_l, True)
        dense_lib = {}
        if lm:
            matmul = functools.partial(torch.matmul, dense, codes_f32)
            dense_lib = {
                "matmul_err_over_S": _check_fused_f64(
                    f"fused_neighbor_sum/{label} {MATMUL}", matmul(),
                    topo.neighbor_idx, ws, wp.codes),
                "matmul_ms": time_ms(matmul)}
        nnz, k_max = int((ws != 0).sum().item()), topo.k_max
        # one launch per call, the weights folded in the kernel: the trace
        # of one wrapper call holds one kernel, and the plain fold is not
        # called (it raises here)
        def _refuse(*_a, **_k):
            raise RuntimeError("ref.folded_weights called on the card")
        real_fold, ref.folded_weights = ref.folded_weights, _refuse
        try:
            # a trace on this card sometimes holds none of the device's
            # events: it is taken again, up to three times, until it does
            for attempt in range(1, 4):
                launched = _kernel_launches(kernel)
                launched["traces"] = attempt
                if launched["kernels"]:
                    break
        finally:
            ref.folded_weights = real_fold
        calls = launched["calls"]
        check(sum(launched["runtime"].values()) == calls
              and all("Cooperative" in k for k in launched["runtime"])
              and 0 < sum(launched["kernels"].values()) <= calls
              and all("fused_neighbor_sum_slab" in k
                      for k in launched["kernels"]),
              f"fused_neighbor_sum/{label}: {calls} calls launched "
              f"{launched}")
        flops = 2.0 * nnz * d
        moved = n * d + 4.0 * n * d + 12.0 * n * k_max + 8.0 * n
        t_ops, t_bytes = flops / F32_FLOPS, moved / HBM_BYTES_PER_S
        row = {"phase": "kernel", "name": "fused_neighbor_sum",
               "shape": label, "n": n, "d": d, "k_max": k_max,
               "nnz_after_dropout": nnz, "bits": 8,
               "max_abs_err": (out_k - out_p).abs().max().item(),
               "max_err_over_S": rel_k, "plain_err_over_S": rel_p,
               "library_err_over_S": rel_l, "tol_over_S": TOL_REL,
               **_slab_launch(nfm, nfm.launch_plan(n, d, "cuda")),
               "kernels_per_call": launched,
               **time_stats(kernel), "plain_ms": time_ms(plain),
               "library": "torch.sparse.mm (CSR, codes cast to f32 outside)",
               "library_ms": time_ms(lib) if lib_ok else None,
               "library_agrees": lib_ok, **dense_lib,
               "bound_ms": 1e3 * max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "gflop": flops / 1e9, "mbytes": moved / 1e6}
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        emit(row)
        if main:
            results["fused_neighbor_sum"] = row
        if label.startswith("lm_"):
            lm_results.setdefault("fused_neighbor_sum", {})[label] = \
                _lm_row(row)

        # the broadcast of the best agent: equal to the plain version
        best = wire_format.encode(theta[3] + 0.1 * eps[3], 8, batched=False)
        sel, sel_err = {}, 0.0
        for flag in (False, True):
            f = torch.tensor(flag, device="cuda")
            sargs = (best.codes, best.scale, f, theta)
            kernel = functools.partial(nfm.fused_broadcast_select, *sargs)
            plain = functools.partial(ref.broadcast_select_ref, *sargs)
            out_k, out_p = kernel(), plain()
            torch.cuda.synchronize()
            check(torch.equal(out_k, out_p),
                  f"fused_broadcast_select/{label} flag={flag}: differs from "
                  f"its plain version by {(out_k - out_p).abs().max().item()}")
            decoded = wire_format.decode(best.codes, best.scale)
            lib = functools.partial(torch.where, f, decoded[None, :], theta)
            check(torch.equal(lib(), out_p), "torch.where disagrees")
            sel_err = max(sel_err, (out_k - out_p).abs().max().item())
            # flag set: codes read, out written; clear: θ read, out written
            moved = (4.0 * n * d + d + 5 if flag else 8.0 * n * d + d + 5)
            # a 10–40 µs launch: 100 samples, with the quartiles beside
            lib_t = time_stats(lib, iters=SELECT_ITERS)
            sel[flag] = {**time_stats(kernel, iters=SELECT_ITERS),
                         "plain_ms": time_ms(plain, iters=SELECT_ITERS),
                         "library_ms": lib_t["ms"],
                         "library_ms_q1": lib_t["ms_q1"],
                         "library_ms_q3": lib_t["ms_q3"],
                         "bound_ms": 1e3 * moved / HBM_BYTES_PER_S,
                         "mbytes": moved / 1e6}
        row = {"phase": "kernel", "name": "fused_broadcast_select",
               "shape": label, "n": n, "d": d, "max_abs_err": sel_err,
               "equal_to_plain": True, "timed_launches": SELECT_ITERS,
               "library": "torch.where (decoded row made outside)",
               **sel[False], "bound_by": "bytes",
               "flag_set": sel[True]}
        emit(row)
        if main:
            results["fused_broadcast_select"] = row
        if label.startswith("lm_"):
            lm_results.setdefault("fused_broadcast_select", {})[label] = \
                _lm_row({**row, "share_of_bound": row["bound_ms"] / row["ms"]})
        del out_k, out_p, big, dense, codes_f32, theta, eps
        torch.cuda.empty_cache()


CONS_SELECT_LEAF = (1 << 24) + 4481   # a full slab of θ, then a ragged one


def consensus_select_phase(results: dict) -> None:
    """The broadcast select as the consensus step launches it: one row
    (θ has no agent axis), a slab of ``SLAB_COLUMNS`` columns and a ragged
    last one of a leaf, the codes sliced from one q8 message over the
    whole leaf (one scale), flag clear and set: equal to the plain
    version and to ``torch.where``; the full slab timed."""
    import torch

    from repro_torch.core import wire_format
    from repro_torch.distributed.netes_dist import SLAB_COLUMNS
    from repro_torch.kernels import netes_fused_mixing as nfm
    from repro_torch.kernels import ref

    g = torch.Generator(device="cuda").manual_seed(29)
    leaf = torch.randn(CONS_SELECT_LEAF, device="cuda", generator=g)
    cand = leaf + 0.1 * torch.randn(CONS_SELECT_LEAF, device="cuda",
                                    generator=g)
    msg = wire_format.encode(cand, 8, batched=False)
    decoded = wire_format.decode(msg.codes, msg.scale)
    row = {"phase": "kernel", "name": "fused_broadcast_select",
           "shape": "consensus_slab", "leaf": CONS_SELECT_LEAF,
           "slab_columns": SLAB_COLUMNS, "equal_to_plain": True}
    for c0 in range(0, CONS_SELECT_LEAF, SLAB_COLUMNS):
        c1 = min(c0 + SLAB_COLUMNS, CONS_SELECT_LEAF)
        theta = leaf[None, c0:c1]
        for flag in (False, True):
            f = torch.tensor(flag, device="cuda")
            sargs = (msg.codes[c0:c1], msg.scale, f, theta)
            kernel = functools.partial(nfm.fused_broadcast_select, *sargs)
            plain = functools.partial(ref.broadcast_select_ref, *sargs)
            lib = functools.partial(torch.where, f, decoded[None, c0:c1],
                                    theta)
            out_k, out_p = kernel(), plain()
            torch.cuda.synchronize()
            check(torch.equal(out_k, out_p) and torch.equal(lib(), out_p),
                  f"fused_broadcast_select/consensus (1, {c1 - c0}) "
                  f"flag={flag}: differs from its plain version by "
                  f"{(out_k - out_p).abs().max().item()}")
            if c1 - c0 < SLAB_COLUMNS:
                continue
            moved = 4.0 * (c1 - c0) * (1 if flag else 2) + (c1 - c0) + 5
            key = "flag_set" if flag else "flag_clear"
            row[key] = {**time_stats(kernel, iters=SELECT_ITERS),
                        "plain_ms": time_ms(plain, iters=SELECT_ITERS),
                        "library_ms": time_ms(lib, iters=SELECT_ITERS),
                        "bound_ms": 1e3 * moved / HBM_BYTES_PER_S,
                        "bound_by": "bytes", "max_abs_err": 0.0}
    emit(row)
    _consensus_shape(results, "fused_broadcast_select", row)
    del leaf, cand, msg, decoded
    torch.cuda.empty_cache()


def fused_fold_phase() -> None:
    """The fused neighbor sum's in-kernel weight fold, bit for bit. Sender
    i's codes are the unit row e_i (D = N), so out[j, i] is the one product
    ws·1 of receiver j's slot of sender i, exact in any order of the sum,
    and equals ``ref.folded_weights`` there; every other element is 0. With
    and without the channel's edge mask, at N = 1000 (one sender chunk) and
    N = 5000 (four)."""
    import torch

    from repro_torch.core import wire_format
    from repro_torch.core.topology_repr import from_dense
    from repro_torch.kernels import netes_fused_mixing as nfm
    from repro_torch.kernels import ref

    for label, dens, n in (("er_main", MAIN_P_ER, MAIN_N),
                           ("er_chunked", 0.02, 5000)):
        topo = from_dense(_graph(n, "erdos_renyi", dens, seed=0), "sparse",
                          device="cuda")
        theta, eps, w = _operands(n, 700, seed=n + 700)
        scale = wire_format.encode(theta + 0.1 * eps, 8, batched=True).scale
        codes = torch.eye(n, dtype=torch.int8, device="cuda")
        idx, nmask = topo.neighbor_idx, topo.neighbor_mask
        rows = torch.arange(n, device="cuda").repeat_interleave(topo.k_max)
        for edge, em in (("dropout", _dropout_mask(topo, 0.1)),
                         ("none", None)):
            out = nfm.fused_neighbor_sum(idx, nmask, w, codes, scale, em)
            ws = ref.folded_weights(idx, nmask, w, scale, em)
            # a row's senders are distinct: one weight per (j, i), the
            # padding's zeros beside it
            expect = torch.zeros(n, n, dtype=torch.float64, device="cuda")
            expect.index_put_((rows, idx.reshape(-1).long()),
                              ws.reshape(-1).double(), accumulate=True)
            expect = expect.float()
            check(torch.equal(out, expect),
                  f"fused_neighbor_sum fold/{label}/edge_mask={edge}: "
                  f"{int((out != expect).sum().item())} elements differ "
                  "from ref.folded_weights")
            emit({"phase": "kernel_fold", "name": "fused_neighbor_sum",
                  "shape": label, "n": n, "d": n, "edge_mask": edge,
                  "weights": int((ws != 0).sum().item()),
                  "equal_to_folded_weights": True})
        del codes, theta, eps, expect, out
        torch.cuda.empty_cache()


def masked_kernel_phase() -> None:
    """The two Eq. 3 kernels given a dropout-masked weight operand (what
    a lossy channel hands them), against their plain versions and float64,
    at the main path's shapes; then the fused neighbor sum with the
    dropout in its neighbor weights and no edge mask (the kernel's fold
    without em). Each must give the same bits on two launches."""
    import torch

    from repro_torch.core import wire_format
    from repro_torch.core.topology_repr import from_dense
    from repro_torch.kernels import netes_fused_mixing as nfm
    from repro_torch.kernels import netes_mixing as nm
    from repro_torch.kernels import netes_sparse_mixing as nsm
    from repro_torch.kernels import ref

    sigma = 0.1
    for kname, family, dens, rep in (
            ("netes_mixing", "fully_connected", 1.0, "dense"),
            ("netes_sparse_mixing", "erdos_renyi", MAIN_P_ER, "sparse")):
        adj_np = _graph(MAIN_N, family, dens, seed=0)
        topo = from_dense(adj_np, rep, device="cuda")
        theta, eps, w = _operands(MAIN_N, 4481, seed=7)
        em = _dropout_mask(topo, 0.1)
        # the same links fail in the dense form of the graph
        dense = from_dense(adj_np, "dense", device="cuda")
        adj64 = (dense.adj * _dropout_mask(dense, 0.1)).double()
        if rep == "dense":
            args = (topo.adj * em, w, w, theta, eps)
            kernel = functools.partial(nm.netes_mixing, *args, sigma=sigma)
            out_p = ref.netes_mixing_ref(*args, sigma=sigma)
        else:
            args = (topo.neighbor_idx, topo.neighbor_mask * em, w, w, theta,
                    eps)
            kernel = functools.partial(nsm.netes_sparse_mixing, *args,
                                       sigma=sigma)
            out_p = ref.sparse_mixing_ref(*args, sigma=sigma)
        out_k = kernel()
        torch.cuda.synchronize()
        check(torch.equal(kernel(), out_k), f"{kname} masked: two launches "
              "differ")
        rel_k = _check_against_f64(f"{kname} masked", out_k, adj64, w, theta,
                                   eps, sigma)
        rel_p = _check_against_f64(f"{kname} masked plain", out_p, adj64, w,
                                   theta, eps, sigma)
        emit({"phase": "kernel_masked", "name": kname, "representation": rep,
              "dropout_p": 0.1, "links_kept": float(em.mean().item()),
              "max_err_over_S": rel_k, "plain_err_over_S": rel_p,
              "max_abs_err": (out_k - out_p).abs().max().item(),
              "tol_over_S": TOL_REL, "equal_on_two_launches": True})

    topo = from_dense(_graph(MAIN_N, "erdos_renyi", MAIN_P_ER, seed=0),
                      "sparse", device="cuda")
    theta, eps, w = _operands(MAIN_N, 4481, seed=7)
    em = _dropout_mask(topo, 0.1)
    wp = wire_format.encode(theta + 0.1 * eps, 8, batched=True)
    args = (topo.neighbor_idx, topo.neighbor_mask * em, w, wp.codes,
            wp.scale)
    out_k = nfm.fused_neighbor_sum(*args)
    out_p = ref.fused_neighbor_sum_ref(*args)
    torch.cuda.synchronize()
    check(torch.equal(nfm.fused_neighbor_sum(*args), out_k),
          "fused_neighbor_sum masked: two launches differ")
    ws = ref.folded_weights(*args[:3], wp.scale)
    rel_k = _check_fused_f64("fused_neighbor_sum masked", out_k,
                             topo.neighbor_idx, ws, wp.codes)
    rel_p = _check_fused_f64("fused_neighbor_sum masked plain", out_p,
                             topo.neighbor_idx, ws, wp.codes)
    emit({"phase": "kernel_masked", "name": "fused_neighbor_sum",
          "representation": "sparse", "edge_mask": None, "dropout_p": 0.1,
          "links_kept": float(em.mean().item()), "max_err_over_S": rel_k,
          "plain_err_over_S": rel_p,
          "max_abs_err": (out_k - out_p).abs().max().item(),
          "tol_over_S": TOL_REL, "equal_on_two_launches": True})


# ---------------------------------------------------------------------------
# phase 3b: the flash-attention kernel against its plain version
# ---------------------------------------------------------------------------

# |kernel − float64 reference| ≤ TOL_ATTN elementwise, with q, k, v of unit
# normal entries. Each output is a convex combination of rows of v; float32
# rounding of the scores, the exp and the ≤ 8192-term sums of the online
# softmax leaves a few 1e-6, so 2e-5 is a margin of about ten. bf16
# attention (8-bit mantissa) misses by ≈ 1e-2; the main row computes it and
# checks that it fails.
TOL_ATTN = 2e-5

# (label, B, Sq, Sk, H, Hkv, hd, causal, window, chunk, main): ``main``
# names the row of the kernels line a case gives its times to
ATTN_CASES = (
    # mistral-nemo-12b's prefill of serve run (a)
    ("nemo_prefill_8192", 1, 8192, 8192, 32, 8, 128, True, 0, 0,
     "flash_attention"),
    ("window256_g4", 2, 1000, 1000, 32, 8, 128, True, 256, 0, ""),
    ("chunk128_g1", 1, 300, 300, 8, 8, 128, True, 0, 128, ""),
    ("noncausal_sq200_sk333", 1, 200, 333, 32, 8, 128, False, 0, 0, ""),
    # query rows 163 .. 299 have no valid key: the mean of v
    ("rows_without_a_key_hd64", 1, 300, 100, 4, 2, 64, True, 64, 0, ""),
    # moonshot-v1-16b-a3b's prefill of its serve run (a): G = 1
    ("moonshot_prefill_8192_g1", 1, 8192, 8192, 16, 16, 128, True, 0, 0, ""),
    # G = 1, 2, 4, 5 with Sq·G not a multiple of the 128-row query tile
    # (G = 5: llama4's 40/8 heads); B = 2
    ("g1_sq333", 1, 333, 333, 8, 8, 128, True, 0, 0, ""),
    ("g2_b2_sq333", 2, 333, 333, 16, 8, 128, True, 0, 0, ""),
    ("g4_sq333", 1, 333, 333, 32, 8, 128, True, 0, 0, ""),
    ("g5_sq333", 1, 333, 333, 40, 8, 128, True, 0, 0, ""),
    ("chunk128_g4", 1, 300, 300, 32, 8, 128, True, 0, 128, ""),
    ("hd64_g4", 1, 517, 517, 32, 8, 64, True, 0, 0, ""),
    # the head_dim-256 instance (64-row query tiles, 32-key tiles) at
    # gemma3-4b's prefill of serve run (a), 8/4 heads: a global layer and
    # a sliding one (window 1024); then ragged shapes: G = 2 with Sq·G off
    # the 64-row tile and B = 2, rows 163 .. 299 without a valid key, a
    # chunk, Sq ≠ Sk without the causal mask
    ("gemma_global_prefill_8192", 1, 8192, 8192, 8, 4, 256, True, 0, 0,
     "flash_attention_hd256"),
    ("gemma_local_prefill_8192_w1024", 1, 8192, 8192, 8, 4, 256, True, 1024,
     0, "flash_attention_hd256_local"),
    ("hd256_g2_b2_sq333", 2, 333, 333, 8, 4, 256, True, 0, 0, ""),
    ("rows_without_a_key_hd256", 1, 300, 100, 8, 4, 256, True, 64, 0, ""),
    ("hd256_chunk128", 1, 300, 300, 8, 4, 256, True, 0, 128, ""),
    ("hd256_noncausal_sq200_sk333", 1, 200, 333, 8, 4, 256, False, 0, 0, ""),
    # the NetES loss of gemma3-4b (lm_netes): one 2048-token sequence, a
    # global layer and a sliding one
    ("lm_gemma_2048", 1, 2048, 2048, 8, 4, 256, True, 0, 0, ""),
    ("lm_gemma_2048_w1024", 1, 2048, 2048, 8, 4, 256, True, 1024, 0, ""),
    # llama4-scout-17b-a16e's prefill of serve run (c), 1 × 16,384 over
    # 40/8 heads of 128 (G = 5): a global layer, and a chunked one whose
    # chunk of 8192 the prompt crosses once
    ("scout_global_16384", 1, 16384, 16384, 40, 8, 128, True, 0, 0,
     "flash_attention_llama4_global"),
    ("scout_chunk8192_16384", 1, 16384, 16384, 40, 8, 128, True, 0, 8192,
     "flash_attention_llama4_chunk"),
    # whisper-tiny (6/6 heads of 64, G = 1): the encoder over its 1500
    # frames, non-causal (1500 = 11·128 + 92: a ragged last key tile that
    # no mask trims), and run (b)'s cross attention of 8 × 432 prompt
    # positions over the 1500 encoder positions
    ("whisper_encoder_1500", 1, 1500, 1500, 6, 6, 64, False, 0, 0,
     "flash_attention_whisper_encoder"),
    ("whisper_cross_b8", 8, 432, 1500, 6, 6, 64, False, 0, 0,
     "flash_attention_whisper_cross"),
    # llava-next-mistral-7b's loss on a vision batch: 2880 patches and
    # 1216 tokens, causal over 4096 positions, 32/8 heads of 128
    ("llava_loss_4096", 1, 4096, 4096, 32, 8, 128, True, 0, 0,
     "flash_attention_llava_loss"),
    # the consensus step's loss of llama4-scout-17b-a16e (train_4k): one
    # 1 × 4096 microbatch through a chunked layer, 40/8 heads of 128, under
    # its chunk of 8192
    ("scout_train_4096_chunk8192", 1, 4096, 4096, 40, 8, 128, True, 0, 8192,
     ""),
    # the head_dim-32 instance (whisper-tiny-smoke's 4 heads of 32):
    # non-causal over 1500 keys (a ragged last key tile) and causal at B =
    # 8 × 64; held to the plain version within TOL_ATTN too
    ("hd32_noncausal_1500", 1, 1500, 1500, 4, 4, 32, False, 0, 0,
     "flash_attention_hd32_noncausal"),
    ("hd32_causal_b8_64", 8, 64, 64, 4, 4, 32, True, 0, 0,
     "flash_attention_hd32_causal"),
)
# The plain version materialises every (B, H, Sq, Sk) score: above this
# many bytes of float32 scores (scout's 16,384² × 40 heads: 43 GB) it runs
# one KV head and its G query heads at a time, which the heads' independence
# makes the same function
PLAIN_SCORE_BYTES = 8e9


def _attn_mask(sq, sk, causal, window, chunk):
    """(Sq, Sk) bool: the keys each query position may attend to."""
    import torch
    qp = torch.arange(sq, device="cuda")[:, None]
    kp = torch.arange(sk, device="cuda")[None, :]
    ok = torch.ones((sq, sk), dtype=torch.bool, device="cuda")
    if causal:
        ok &= qp >= kp
    if window:
        ok &= (qp - kp) < window
    if chunk:
        ok &= (qp // chunk) == (kp // chunk)
    return ok


def _attention_f64(q, k, v, ok, scale):
    """Naive masked softmax attention in float64, one (batch, KV head) at
    a time so that the (G, Sq, Sk) scores fit."""
    import torch
    b, _, h, _ = q.shape
    hkv = k.shape[2]
    g = h // hkv
    out = torch.empty(q.shape, dtype=torch.float64, device=q.device)
    for bi in range(b):
        for j in range(hkv):
            heads = slice(j * g, (j + 1) * g)
            s = torch.einsum("qgd,kd->gqk", q[bi, :, heads].double(),
                             k[bi, :, j].double()) * scale
            p = torch.softmax(torch.where(ok, s, -1e30), dim=-1)
            out[bi, :, heads] = torch.einsum("gqk,kd->qgd", p,
                                             v[bi, :, j].double())
    return out


def _sdpa_backend(*args, **kwargs) -> str:
    """The backend ``F.scaled_dot_product_attention`` picks for these
    arguments, by PyTorch's own choice function."""
    import torch
    from torch.nn.attention import SDPBackend
    return SDPBackend(torch._fused_sdp_choice(*args, **kwargs)).name


def attention_kernel_phase(results: dict, lm_results: dict) -> None:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    for (label, b, sq, sk, h, hkv, hd, causal, window, chunk,
         main) in ATTN_CASES:
        g = torch.Generator(device="cuda").manual_seed(sq + sk + h)
        q = torch.randn(b, sq, h, hd, device="cuda", generator=g)
        k = torch.randn(b, sk, hkv, hd, device="cuda", generator=g)
        v = torch.randn(b, sk, hkv, hd, device="cuda", generator=g)
        scale = hd ** -0.5
        kw = dict(causal=causal, window=window, chunk=chunk, scale=scale)
        kernel = functools.partial(fa.flash_attention, q, k, v, **kw)
        by_kv_head = 4.0 * b * h * sq * sk > PLAIN_SCORE_BYTES
        plain = functools.partial(_plain_by_kv_head if by_kv_head
                                  else ref.flash_attention_ref, q, k, v,
                                  **kw)
        out_k, out_p = kernel(), plain()
        torch.cuda.synchronize()
        check(torch.isfinite(out_k).all().item(),
              f"flash_attention/{label}: non-finite")
        check(torch.equal(kernel(), out_k),
              f"flash_attention/{label}: two launches differ")
        pl, resident = fa.launch_plan(b, sq, h, hkv, hd)
        ok = _attn_mask(sq, sk, causal, window, chunk)
        exact = _attention_f64(q, k, v, ok, scale)
        err_k = (out_k.double() - exact).abs().max().item()
        err_p = (out_p.double() - exact).abs().max().item()
        check(err_k <= TOL_ATTN, f"flash_attention/{label}: |err| {err_k} "
              f"above {TOL_ATTN}")
        check(err_p <= TOL_ATTN, f"flash_attention/{label} plain: |err| "
              f"{err_p} above {TOL_ATTN}")
        if hd == 32:
            err_kp = (out_k - out_p).abs().max().item()
            check(err_kp <= TOL_ATTN, f"flash_attention/{label}: |kernel − "
                  f"plain| {err_kp} above {TOL_ATTN}")

        # the library yardstick: one scaled_dot_product_attention call on
        # (B, H, S, hd) operands with the KV heads repeated, made outside
        # the timed call; a row with no valid key is NaN there, so its
        # error is taken over the other rows
        gq = h // hkv
        qt = q.transpose(1, 2).contiguous()
        kt = k.repeat_interleave(gq, dim=2).transpose(1, 2).contiguous()
        vt = v.repeat_interleave(gq, dim=2).transpose(1, 2).contiguous()
        if not window and not chunk and (sq == sk or not causal):
            lib_kw = dict(is_causal=causal, scale=scale)
        else:
            lib_kw = dict(attn_mask=ok, scale=scale)
        lib = functools.partial(F.scaled_dot_product_attention, qt, kt, vt,
                                **lib_kw)
        rows = ok.any(dim=1)
        lib_err = (lib().transpose(1, 2).double() - exact)[:, rows]
        pairs = int(ok.sum().item())
        flops = 4.0 * b * h * hd * pairs
        moved = 4.0 * (2 * b * sq * h * hd + 2 * b * sk * hkv * hd)
        t_ops, t_bytes = flops / F32_FLOPS, moved / HBM_BYTES_PER_S
        row = {"phase": "kernel", "name": "flash_attention", "shape": label,
               "b": b, "sq": sq, "sk": sk, "h": h, "hkv": hkv, "hd": hd,
               "causal": causal, "window": window, "chunk": chunk,
               "allowed_pairs": pairs,
               "rows_without_a_key": int((~rows).sum().item()),
               "max_abs_err": (out_k - out_p).abs().max().item(),
               "max_err_f64": err_k, "plain_err_f64": err_p,
               "library_err_f64": lib_err.abs().max().item(),
               "tol_f64": TOL_ATTN, "grid_blocks": pl.grid_blocks,
               "resident_blocks_per_sm": resident, **time_stats(kernel),
               "plain_ms": time_ms(plain), "plain_by_kv_head": by_kv_head,
               "library": "F.scaled_dot_product_attention (f32, KV heads "
                          "repeated outside)",
               "library_backend": _sdpa_backend(qt, kt, vt, **lib_kw),
               "library_ms": time_ms(lib),
               "bound_ms": 1e3 * max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "gflop": flops / 1e9, "mbytes": moved / 1e6}
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        if main or label.startswith("moonshot"):
            row["library_kernels_ms"] = _device_ms(lib)
        if main and causal and not window and not chunk:
            bf16 = F.scaled_dot_product_attention(
                qt.bfloat16(), kt.bfloat16(), vt.bfloat16(), is_causal=True,
                scale=scale).transpose(1, 2).double()
            row["bf16_library_err_f64"] = (bf16 - exact).abs().max().item()
            check(row["bf16_library_err_f64"] > TOL_ATTN,
                  "bf16 attention passes the float32 tolerance: tighten it")
        if main:
            results[main] = row
        if label.startswith("lm_"):
            lm_results.setdefault("flash_attention", {})[label] = _lm_row(row)
        if "train_4096" in label:
            _consensus_shape(results, "flash_attention", row)
        emit(row)
        del q, k, v, out_k, out_p, exact, qt, kt, vt, ok
        torch.cuda.empty_cache()
    # the chunked layer computes half the global one's (query, key) pairs
    # at 16,384 tokens: its time over the global one's ≈ 0.5 if the kernel
    # skips the key tiles outside the chunk, ≈ 1 if it does not (recorded,
    # not a failure)
    chunked = results["flash_attention_llama4_chunk"]
    full = results["flash_attention_llama4_global"]
    emit({"phase": "kernel", "name": "flash_attention",
          "check": "chunk_skip", "shapes": [chunked["shape"], full["shape"]],
          "pairs_ratio": chunked["allowed_pairs"] / full["allowed_pairs"],
          "ms_ratio": chunked["ms"] / full["ms"],
          "skip_works": chunked["ms"] / full["ms"] < 0.75})


def _plain_by_kv_head(q, k, v, **kw):
    """``ref.flash_attention_ref`` one KV head (and its G query heads) at
    a time, so that one (G, Sq, Sk) block of scores is live at once."""
    import torch

    from repro_torch.kernels import ref
    hkv = k.shape[2]
    g = q.shape[2] // hkv
    return torch.cat([ref.flash_attention_ref(
        q[:, :, j * g:(j + 1) * g], k[:, :, j:j + 1], v[:, :, j:j + 1], **kw)
        for j in range(hkv)], dim=2)


# ---------------------------------------------------------------------------
# phase 3c: the MoE router kernel against its plain version
# ---------------------------------------------------------------------------

# Gates are probabilities renormalised over k ≤ 8 of them: the kernel and
# the plain version round the same softmax and sums of ≤ 8 terms, ≈ 1e-7
# apart; a wrong expert or a missing renormalisation moves a gate by ≥ 1e-3.
TOL_GATES = 1e-6
# Ids are held EQUAL except on a row where two neighbours among the plain
# version's k + 1 largest probabilities lie within NEAR_TIE_ULPS float32
# ulps: there the two sum the exps in another order, may round them to one
# probability, and then break the tie toward the lower index.
NEAR_TIE_ULPS = 2

ROUTER_CASES = (  # (label, T, E, k, main)
    ("moonshot_prefill_8192", 8192, 64, 6, True),
    ("moonshot_decode_b8", 8, 64, 6, False),
    ("ragged_1000_e128_k8", 1000, 128, 8, False),
    # jamba-v0.1-52b's router at serve run (a)'s prefill: the 16 / 2 instance
    ("jamba_prefill_8192", 8192, 16, 2, False),
    # llama4's top-1 routers, through the generic instance: scout's at
    # serve run (c)'s prefill, maverick's at run (a)'s and (b)'s decode
    ("scout_prefill_16384", 16384, 16, 1, False),
    ("maverick_prefill_8192", 8192, 128, 1, False),
    ("maverick_decode_b8", 8, 128, 1, False),
    # the consensus step's routers on a 1 × 4096 microbatch (train_4k):
    # scout's top-1 (the generic instance) and jamba's top-2
    ("scout_train_4096", 4096, 16, 1, False),
    ("jamba_train_4096", 4096, 16, 2, False),
)


def _near_tie_rows(logits, k: int):
    """(T,) bool: rows where neighbours among the plain version's k + 1
    largest probabilities lie within NEAR_TIE_ULPS ulps of the larger."""
    import torch
    p = torch.softmax(logits, dim=-1)
    top = torch.sort(p, dim=-1, descending=True).values[:, :k + 1]
    ulp = torch.finfo(torch.float32).eps * top[:, :-1]
    return ((top[:, :-1] - top[:, 1:]) <= NEAR_TIE_ULPS * ulp).any(dim=1)


def _router_library(logits, k: int):
    """The yardstick: torch.softmax → torch.topk → renormalise, three
    PyTorch calls (no single call computes the router)."""
    import torch
    vals, ids = torch.topk(torch.softmax(logits, dim=-1), k, dim=-1)
    return vals / vals.sum(dim=-1, keepdim=True).clamp_min(1e-9), ids


def router_kernel_phase(results: dict) -> None:
    import torch

    from repro_torch.kernels import moe_router as mr
    from repro_torch.kernels import ref

    for label, t, e, k, main in ROUTER_CASES:
        g = torch.Generator(device="cuda").manual_seed(t + e + k)
        logits = torch.randn(t, e, device="cuda", generator=g)
        kernel = functools.partial(mr.moe_topk, logits, k)
        plain = functools.partial(ref.moe_topk_ref, logits, k)
        lib = functools.partial(_router_library, logits, k)
        (gk, ik), (gp, ip) = kernel(), plain()
        gk2, ik2 = kernel()
        torch.cuda.synchronize()
        check(bool(torch.isfinite(gk).all()), f"moe_topk/{label}: non-finite")
        check(torch.equal(gk2, gk) and torch.equal(ik2, ik),
              f"moe_topk/{label}: two launches differ")
        info = mr.launch_info(t, e, k, torch.cuda.current_device())
        check(info["local_bytes"] == 0, f"moe_topk/{label}: "
              f"{info['local_bytes']} bytes of local memory per thread")
        near = _near_tie_rows(logits, k)
        differ = (ik != ip).any(dim=1)
        check(not bool((differ & ~near).any()),
              f"moe_topk/{label}: ids differ from the plain version on "
              f"{int((differ & ~near).sum())} rows without a near-tie")
        gate_err = (gk - gp).abs().max().item()
        check(gate_err <= TOL_GATES, f"moe_topk/{label}: gates differ by "
              f"{gate_err} (tolerance {TOL_GATES})")
        # against float64: the gates of the float64 top-k of these logits
        g64, i64 = ref.moe_topk_ref(logits.double(), k)
        same = (ik.long() == i64.long()).all(dim=1)
        err64 = (gk.double() - g64)[same].abs().max().item()
        _, il = lib()
        moved = 4.0 * t * e + 8.0 * t * k
        ops = float(t * e * (5 + k))   # max, subtract, exp, add, divide; k compares
        t_ops, t_bytes = ops / F32_FLOPS, moved / HBM_BYTES_PER_S
        row = {"phase": "kernel", "name": "moe_topk", "shape": label,
               "t": t, "e": e, "k": k, "max_abs_err": gate_err,
               "gates_err_f64": err64, "tol_gates": TOL_GATES,
               "near_tie_rows": int(near.sum()),
               "rows_ids_differ": int(differ.sum()),
               "rows_ids_differ_f64": int((~same).sum()),
               "grid_blocks": info["grid"],
               "resident_blocks_per_sm": info["resident"],
               "registers": info["registers"],
               "spill_bytes": info["local_bytes"],
               "library_rows_ids_differ": int((il != ip).any(dim=1).sum()),
               **time_stats(kernel), "plain_ms": time_ms(plain),
               "library": "torch.softmax → torch.topk → renormalise "
                          "(three calls)",
               "library_ms": time_ms(lib),
               "bound_ms": 1e3 * max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "mops": ops / 1e6, "mbytes": moved / 1e6}
        emit(row)
        if main:
            results["moe_topk"] = row
        if "train_4096" in label:
            _consensus_shape(results, "moe_topk", row)
        if label.startswith(("scout", "maverick")):
            results.setdefault("moe_topk_llama4", {})[label] = {
                key: row[key] for key in (
                    "max_abs_err", "gates_err_f64", "near_tie_rows",
                    "rows_ids_differ", "grid_blocks", "ms", "plain_ms",
                    "library_ms", "bound_ms", "bound_by")}


# ---------------------------------------------------------------------------
# phase 3d: the WKV-6 recurrence against its plain version
# ---------------------------------------------------------------------------

# |kernel − float64| ≤ TOL_REL · S elementwise, where S is the same
# recurrence run in float64 over absolute values (|r|, |k|, |v|, w, |u|,
# |s0|). Each output and state entry is a decayed sum over ≈ 1/(1 − w)
# steps (400–1000 here) of float32 products; their rounding random-walks to
# ≈ u/√(1 − w²) ≈ 1e-6·S, and 3e-5 is thirty of those. Leaving out the
# bonus term or one step's decay moves an entry by ≥ (1 − w)·S ≈ 1e-3·S.
WKV_CASES = (  # (label, B, S, H, n, initial state?, w drawn as, main)
    # rwkv6-7b's prefill of serve run (a), w as the model draws it
    ("rwkv_prefill_8192", 1, 8192, 64, 64, False, "model", True),
    ("rwkv_prefill_8192_w_uniform", 1, 8192, 64, 64, False, "uniform",
     False),
    # serve run (b)'s prefill, and a decode step of run (b)
    ("rwkv_prefill_b8_512", 8, 512, 64, 64, False, "model", False),
    ("rwkv_decode_b8", 8, 1, 64, 64, True, "model", False),
    # serve run (a)'s decode step: 480 of the 512 launches of a generate
    ("rwkv_decode_b1", 1, 1, 64, 64, True, "model", False),
    ("ragged_n8", 2, 100, 3, 8, True, "uniform", False),
    ("ragged_n16", 1, 77, 5, 16, True, "uniform", False),
    ("ragged_n32", 3, 33, 2, 32, False, "uniform", False),
    ("ragged_n40", 1, 50, 2, 40, True, "uniform", False),
)
WKV_CHUNK = 128           # the reference's chunk in rwkv6_block


def _wkv_operands(b, s, h, n, s0: bool, w_kind: str, seed: int):
    """r, k, v, u unit normal; w either as rwkv6-7b's init makes it,
    exp(−exp(−6 + δ)) with δ the decay LoRA's ≈ 1e-2 (w ≈ 0.9975), or
    uniform in (0.9, 0.999); s0 unit normal, or None."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    r, k, v = (torch.randn(b, s, h, n, device="cuda", generator=g)
               for _ in range(3))
    if w_kind == "model":
        w = torch.exp(-torch.exp(-6.0 + 0.01 * torch.randn(
            b, s, h, n, device="cuda", generator=g)))
    else:
        w = 0.9 + 0.099 * torch.rand(b, s, h, n, device="cuda", generator=g)
    u = torch.randn(h, n, device="cuda", generator=g)
    z = (torch.randn(b, h, n, n, device="cuda", generator=g) if s0
         else None)
    return r, k, v, w, u, z


def _wkv_error_over_scale(got, exact, scale, name):
    err = ((got.double() - exact).abs() / scale.clamp_min(1e-30)).max().item()
    check(err <= TOL_REL, f"{name}: error {err:.3g}·S above {TOL_REL}·S")
    return err


def wkv_kernel_phase(results: dict) -> None:
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv6_wkv as rw
    from repro_torch.models import rwkv6

    for label, b, s, h, n, s0, w_kind, main in WKV_CASES:
        args = _wkv_operands(b, s, h, n, s0, w_kind, seed=b + s + h + n)
        r, k, v, w, u, z = args
        kernel = functools.partial(rw.rwkv6_wkv, *args)
        plain = functools.partial(ref.rwkv6_wkv_ref, *args)
        (out_k, s_k), (out_p, s_p) = kernel(), plain()
        out_k2, s_k2 = kernel()
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out_k).all() and torch.isfinite(s_k).all()),
              f"rwkv6_wkv/{label}: non-finite")
        check(torch.equal(out_k2, out_k) and torch.equal(s_k2, s_k),
              f"rwkv6_wkv/{label}: two launches differ")
        del out_k2, s_k2
        info = rw.launch_info(b, s, h, n, "cuda")
        check(info["local_bytes"] == 0, f"rwkv6_wkv/{label}: "
              f"{info['local_bytes']} bytes of local memory per thread")
        out64, s64 = ref.rwkv6_wkv_ref(
            *(a.double() for a in (r, k, v, w, u)),
            None if z is None else z.double())
        scale_o, scale_s = ref.rwkv6_wkv_ref(
            r.abs().double(), k.abs().double(), v.abs().double(), w.double(),
            u.abs().double(), None if z is None else z.abs().double())
        errs = {"out": _wkv_error_over_scale(out_k, out64, scale_o,
                                             f"rwkv6_wkv/{label}"),
                "state": _wkv_error_over_scale(s_k, s64, scale_s,
                                               f"rwkv6_wkv/{label} state"),
                "plain_out": _wkv_error_over_scale(
                    out_p, out64, scale_o, f"rwkv6_wkv/{label} plain"),
                "plain_state": _wkv_error_over_scale(
                    s_p, s64, scale_s, f"rwkv6_wkv/{label} plain state")}
        del out64, s64, scale_o, scale_s
        # the second yardstick: the reference's chunked form in plain
        # PyTorch products (rwkv6_block's), where S is a multiple of its
        # chunk; its error is reported, not gated (it divides by in-chunk
        # decay products)
        chunked = chunked_ms = chunked_err = None
        if s % WKV_CHUNK == 0:
            chunked = functools.partial(rwkv6.wkv6_chunked, *args,
                                        chunk=WKV_CHUNK)
            out_c, _ = chunked()
            chunked_err = (out_c - out_p).abs().max().item()
            chunked_ms = time_ms(chunked)
            del out_c
        # bytes: r, k, v, w and u read, s0 read, out and the state written;
        # operations: per step, head and state entry an FMA for r·S and a
        # multiply and an FMA for the update, per channel the bonus r·u·k
        moved = 4.0 * (5 * b * s * h * n + h * n + b * h * n * n
                       + (b * h * n * n if s0 else 0))
        ops = float(b * s * h * (5 * n * n + 4 * n))
        t_ops, t_bytes = ops / F32_FLOPS, moved / HBM_BYTES_PER_S
        plain_iters = 3 if s > 1000 else 20
        row = {"phase": "kernel", "name": "rwkv6_wkv", "shape": label,
               "b": b, "s": s, "h": h, "n": n, "initial_state": s0,
               "w": w_kind, "w_min": w.min().item(), "w_max": w.max().item(),
               "max_abs_err": max((out_k - out_p).abs().max().item(),
                                  (s_k - s_p).abs().max().item()),
               "err_over_S_f64": errs, "tol_over_S": TOL_REL,
               "threads_per_column_quad": info["rs"],
               "warps_per_block": info["warps"],
               "columns_per_block": info["cols"],
               "grid_blocks": info["grid"],
               "resident_blocks_per_sm": info["resident"],
               "registers": info["registers"],
               "spill_bytes": info["local_bytes"],
               **time_stats(kernel),
               "plain_ms": time_ms(plain, warmup=1, iters=plain_iters),
               "plain_timed_calls": plain_iters,
               "chunked_ms": chunked_ms, "chunked_max_abs_diff": chunked_err,
               "library": "none (no PyTorch call computes WKV-6)",
               "library_ms": None,
               "bound_ms": 1e3 * max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "gflop": ops / 1e9, "mbytes": moved / 1e6}
        emit(row)
        if main:
            results["rwkv6_wkv"] = row
        del args, r, k, v, w, u, z, out_k, s_k, out_p, s_p, kernel, plain
        torch.cuda.empty_cache()


# |kernel − float64| ≤ TOL_REL · S elementwise, where S is the same
# recurrence run in float64 over |drive| (and |h0|); decay lies in (0, 1).
# Each h_t is a decayed sum over ≈ 1/(1 − decay) steps (up to 1000 here)
# of float32 terms; their rounding random-walks to ≈ 1e-6·S or less, and
# 3e-5 is thirty of those. Leaving out one step's drive or decay moves an
# entry by ≥ (1 − decay)·S ≈ 1e-3·S.
SCAN_CASES = (  # (label, B, S, D, N, initial state?, decay drawn as, main)
    # jamba-v0.1-52b's prefill of serve run (a), decay as the model draws it
    ("jamba_prefill_8192", 1, 8192, 8192, 16, False, "model", True),
    ("jamba_prefill_8192_decay_uniform", 1, 8192, 8192, 16, False,
     "uniform", False),
    # serve run (b)'s prefill, and a decode step of run (b)
    ("jamba_prefill_b8_512", 8, 512, 8192, 16, False, "model", False),
    ("jamba_decode_b8", 8, 1, 8192, 16, True, "model", False),
    ("ragged_33x300x16", 1, 33, 300, 16, False, "uniform", False),
    ("ragged_b2_64x300x4", 2, 64, 300, 4, False, "uniform", False),
    ("one_step_8192x16", 1, 1, 8192, 16, False, "model", False),
    # the consensus step's mamba layers on a 1 × 4096 microbatch
    ("jamba_train_4096", 1, 4096, 8192, 16, False, "model", False),
)
SCAN_F64_SLICE = 2048     # channels per float64 reference pass (memory)


def _scan_operands(b, s, d, n, h0: bool, decay_kind: str, seed: int):
    """decay either as jamba's init makes it, exp(−Δ·A) with Δ =
    softplus(log(expm1(0.01)) + 0.01·N(0, 1)) ≈ 0.01 per (b, t, d) and
    A = 1 … N (decay ≈ 0.85–0.99), or uniform in (0.8, 0.999) as the
    reference's sweep; drive and h0 unit normal, or h0 None."""
    import math

    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    if decay_kind == "model":
        dt = torch.nn.functional.softplus(
            math.log(math.expm1(0.01))
            + 0.01 * torch.randn(b, s, d, device="cuda", generator=g))
        a = torch.arange(1, n + 1, dtype=torch.float32, device="cuda")
        decay = torch.exp(-dt[..., None] * a)
        del dt
    else:
        decay = 0.8 + 0.199 * torch.rand(b, s, d, n, device="cuda",
                                         generator=g)
    drive = torch.randn(b, s, d, n, device="cuda", generator=g)
    z = torch.randn(b, d, n, device="cuda", generator=g) if h0 else None
    return decay, drive, z


def _scan_errors_over_scale(outs: dict, decay, drive, z, label) -> dict:
    """For each named output, max |out − float64| / S over every entry,
    in passes of SCAN_F64_SLICE channels; raises above TOL_REL."""
    from repro_torch.kernels import ref
    worst = dict.fromkeys(outs, 0.0)
    for d0 in range(0, decay.shape[2], SCAN_F64_SLICE):
        sl = slice(d0, d0 + SCAN_F64_SLICE)
        dec = decay[:, :, sl].double()
        exact = ref.mamba_scan_ref(dec, drive[:, :, sl].double(),
                                   None if z is None else z[:, sl].double())
        scale = ref.mamba_scan_ref(
            dec, drive[:, :, sl].abs().double(),
            None if z is None else z[:, sl].abs().double()).clamp_min(1e-30)
        for name, out in outs.items():
            err = ((out[:, :, sl].double() - exact).abs() / scale).max()
            worst[name] = max(worst[name], err.item())
        del dec, exact, scale
    for name, err in worst.items():
        check(err <= TOL_REL, f"mamba_scan/{label} ({name}): error "
              f"{err:.3g}·S above {TOL_REL}·S")
    return worst


def scan_kernel_phase(results: dict) -> None:
    import torch

    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import ref
    from repro_torch.models import mamba

    for label, b, s, d, n, h0, decay_kind, main in SCAN_CASES:
        decay, drive, z = _scan_operands(b, s, d, n, h0, decay_kind,
                                         seed=b + s + d + n)
        kernel = functools.partial(ms.mamba_scan, decay, drive, z)
        plain = functools.partial(ref.mamba_scan_ref, decay, drive, z)
        h_k = kernel()
        torch.cuda.synchronize()
        check(bool(torch.isfinite(h_k).all()), f"mamba_scan/{label}: "
              "non-finite")
        h_p = plain()
        max_abs = (h_k - h_p).abs().max().item()
        errs = _scan_errors_over_scale({"kernel": h_k, "plain": h_p},
                                       decay, drive, z, label)
        del h_p
        # the second yardstick: the associative form in plain PyTorch
        # (mamba_block's), from a zero state; its difference from the
        # kernel is reported, not gated
        assoc = assoc_ms = assoc_err = None
        if z is None and s > 1:
            assoc = functools.partial(mamba.mamba_scan_ref, decay, drive)
            h_a = assoc()
            assoc_err = (h_a - h_k).abs().max().item()
            del h_a
            assoc_ms = time_ms(assoc, warmup=1, iters=5)
        del h_k
        # bytes: decay and drive read, h0 read, every h_t written;
        # operations: one FMA (2 flops) per (b, t, d, n)
        moved = 4.0 * (3 * b * s * d * n + (b * d * n if h0 else 0))
        ops = 2.0 * b * s * d * n
        t_ops, t_bytes = ops / F32_FLOPS, moved / HBM_BYTES_PER_S
        plain_iters = 3 if s > 1000 else 20
        row = {"phase": "kernel", "name": "mamba_scan", "shape": label,
               "b": b, "s": s, "d": d, "n": n, "initial_state": h0,
               "decay": decay_kind, "decay_min": decay.min().item(),
               "decay_max": decay.max().item(), "max_abs_err": max_abs,
               "err_over_S_f64": errs, "tol_over_S": TOL_REL,
               **time_stats(kernel),
               "plain_ms": time_ms(plain, warmup=1, iters=plain_iters),
               "plain_timed_calls": plain_iters,
               "assoc_ms": assoc_ms, "assoc_max_abs_diff": assoc_err,
               "library": "none (no PyTorch call computes a linear "
                          "recurrence)",
               "library_ms": None,
               "bound_ms": 1e3 * max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "gflop": ops / 1e9, "mbytes": moved / 1e6}
        row["hbm_share_of_bound"] = row["bound_ms"] / row["ms"]
        emit(row)
        if main:
            results["mamba_scan"] = row
        if "train_4096" in label:
            _consensus_shape(results, "mamba_scan", row)
        del decay, drive, z, kernel, plain, assoc
        torch.cuda.empty_cache()


ROLLOUT_EPISODES = 32_768   # 2N at N = 16,384: the benchmark's RL cells
ROLLOUT_Q90 = 2e-5          # the cells' return_q90 limit, against float64
# (parameter rows, episodes a row) held against the loop episode by episode:
# NetES's 2N candidates, the same episodes as 1024 rows of 32 (the
# ``per_theta`` index), and the main phase's evaluation of one θ
ROLLOUT_CASES = ((ROLLOUT_EPISODES, 1), (ROLLOUT_EPISODES // 32, 32),
                 (1, EVAL_EPISODES))
ROLLOUT_RTOL = 1e-5         # tests/test_torch_envs.py's tolerance: rtol
ROLLOUT_SPREADS = 6.0       # plus six times the loop's rounding spread


# An 8-sample spread is a noisy estimate of an episode's rounding
# sensitivity: among 2N = 32,768 episodes a few that pass near the upright
# read beyond the tolerance by chance. Those (at most one in a thousand)
# are held again against a spread from ROLLOUT_RECHECK_SAMPLES moves.
ROLLOUT_RECHECK_SAMPLES = 256


def _rollout_perturbed(env, policy, thetas, states, samples=8, seed=0):
    """The loop's returns (samples, M) after ``samples`` random ±1-ulp
    moves of every parameter, run in batches of up to ROLLOUT_EPISODES
    episodes: how far rounding alone moves each episode (far where an
    episode passes near the upright)."""
    import torch

    from repro_torch.envs import rollout
    g = torch.Generator(device=thetas.device).manual_seed(seed)
    rows = thetas.shape[0]
    batch = max(1, ROLLOUT_EPISODES // rows)
    outs = []
    for done in range(0, samples, batch):
        k = min(batch, samples - done)
        moved = thetas.repeat(k, 1)
        up = torch.rand(moved.shape, generator=g, device=thetas.device)
        moved = torch.nextafter(moved, torch.where(up < 0.5, torch.inf,
                                                   -torch.inf))
        outs.append(rollout.loop_return(env, policy, moved,
                                        states.repeat(k, 1)).reshape(k, rows))
        del moved, up
    return torch.cat(outs)


def rollout_kernel_phase(results: dict) -> None:
    """The pendulum rollout kernel at 2N = 32,768 NetES-like candidates
    (θ⁽⁰⁾ + 0.1 ε): its time against its bound and against the plain
    loop, registers and spills. In each of ``ROLLOUT_CASES`` every
    episode is held against the loop on the card, within rtol 1e-5 plus
    six times the loop's own rounding spread (from 8 moves; from
    ``ROLLOUT_RECHECK_SAMPLES`` for the few beyond that), and the
    kernel's 90th and 99th percentiles of relative distance from the
    loop run in float64 within twice the loop's own."""
    import torch

    from repro_torch import envs
    from repro_torch.envs import rollout
    from repro_torch.kernels import pendulum_rollout as pr

    env, policy = envs.Pendulum(), rollout.KERNEL_POLICY
    g = torch.Generator(device="cuda").manual_seed(35)
    cases = []
    for rows, per in ROLLOUT_CASES:
        thetas = policy.init(g, rows) + 0.1 * torch.randn(
            rows, policy.num_params, generator=g, device="cuda")
        states = env.reset(g, rows * per)
        got = pr.pendulum_rollout(env, thetas, states, per)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), "pendulum_rollout: non-finite")
        full = thetas.repeat_interleave(per, dim=0) if per > 1 else thetas
        want = rollout.loop_return(env, policy, full, states)
        exact = rollout.loop_return(env, policy, full.double(),
                                    states.double())
        spread = _rollout_perturbed(env, policy, full, states).std(
            dim=0, correction=0)
        tol = ROLLOUT_RTOL * want.abs() + ROLLOUT_SPREADS * spread
        dist = (got - want).abs()
        flagged = (dist > tol).nonzero().flatten()
        name = f"pendulum_rollout ({rows} rows × {per})"
        check(len(flagged) <= max(8, rows * per // 1000), f"{name}: "
              f"{len(flagged)} episodes beyond rtol {ROLLOUT_RTOL} + "
              f"{ROLLOUT_SPREADS}·spread of the loop")
        wide = (_rollout_perturbed(env, policy, full[flagged],
                                   states[flagged], ROLLOUT_RECHECK_SAMPLES,
                                   seed=1) if len(flagged)
                else want.new_zeros(ROLLOUT_RECHECK_SAMPLES, 0))
        wide_tol = (ROLLOUT_RTOL * want[flagged].abs()
                    + ROLLOUT_SPREADS * wide.std(dim=0, correction=0))
        rechecked = [{"episode": int(i), "kernel": got[i].item(),
                      "loop": want[i].item(), "float64": exact[i].item(),
                      "spread": spread[i].item(),
                      "wide_spread": wide[:, j].std(correction=0).item(),
                      "wide_min": wide[:, j].min().item(),
                      "wide_max": wide[:, j].max().item(),
                      "over_wide_tol": (dist[i] / wide_tol[j]).item()}
                     for j, i in enumerate(flagged.tolist())]

        def rel(x):
            return ((x.double() - exact) / exact.abs()).abs()

        def qs(x):
            return torch.quantile(rel(x), torch.tensor(
                [0.9, 0.99], dtype=torch.float64, device="cuda")).tolist()

        (k90, k99), (l90, l99) = qs(got), qs(want)
        case = {"rows": rows, "per_theta": per, "episodes": rows * per,
                "beyond_tol": len(flagged),
                "beyond_wide_tol": int((dist[flagged] > wide_tol).sum()),
                "rechecked": rechecked,
                "max_abs_err": dist.max().item(),
                "max_rel_err": (dist / want.abs()).max().item(),
                "max_over_tol": (dist / tol).max().item(),
                "q90_vs_f64": k90, "plain_q90_vs_f64": l90,
                "q99_vs_f64": k99, "plain_q99_vs_f64": l99,
                "max_vs_f64": rel(got).max().item(),
                "plain_max_vs_f64": rel(want).max().item()}
        cases.append(case)
        check(case["beyond_wide_tol"] == 0, f"{name}: "
              f"{case['beyond_wide_tol']} episodes beyond rtol "
              f"{ROLLOUT_RTOL} + {ROLLOUT_SPREADS}·spread of the loop from "
              f"{ROLLOUT_RECHECK_SAMPLES} moves: {rechecked}")
        if rows * per >= 1000:    # quantiles of a handful read nothing
            check(k90 <= ROLLOUT_Q90, f"{name}: q90 {k90} against float64,"
                  f" over {ROLLOUT_Q90}")
            check(k90 <= 2 * l90 and k99 <= 2 * l99, f"{name}: q90 / q99 "
                  f"{k90} / {k99} against float64, over twice the loop's "
                  f"{l90} / {l99}")
        if per == 1 and rows == ROLLOUT_EPISODES:
            timed = (thetas, states)
        del full, want, exact, spread, tol, dist, got, wide

    theta = policy.init(g, 1)[0]
    resets = env.reset(g, EVAL_EPISODES)
    best = rollout.evaluate_best(env, policy, theta, resets)
    check(torch.equal(best, pr.pendulum_rollout(
        env, theta[None, :], resets, EVAL_EPISODES).mean()),
        "evaluate_best: not the kernel's mean")

    thetas, states = timed
    m = ROLLOUT_EPISODES
    kernel = functools.partial(pr.pendulum_rollout, env, thetas, states)
    plain = functools.partial(rollout.loop_return, env, policy, thetas,
                              states)
    info = pr.launch_info(m, 0)
    ops = float(m) * env.episode_len * pr.FLOPS_PER_STEP
    moved = 4.0 * (thetas.numel() + states.numel() + m)
    t_ops, t_bytes = ops / F32_FLOPS, moved / HBM_BYTES_PER_S
    row = {"phase": "kernel", "name": "pendulum_rollout", "episodes": m,
           "steps": env.episode_len, **info, **cases[0], "cases": cases,
           **time_stats(kernel),
           "plain_ms": time_ms(plain, warmup=1, iters=3),
           "plain_timed_calls": 3,
           "library": "none (no PyTorch call runs an episode)",
           "library_ms": None,
           "bound_ms": 1e3 * max(t_ops, t_bytes),
           "bound_ops_ms": 1e3 * t_ops, "bound_bytes_ms": 1e3 * t_bytes,
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "gflop": ops / 1e9, "mbytes": moved / 1e6}
    row["share_of_bound"] = row["bound_ms"] / row["ms"]
    emit(row)
    check(info["local_bytes"] == 0, f"pendulum_rollout: {info['local_bytes']}"
          " bytes of local memory (spills)")
    results["pendulum_rollout"] = row
    del thetas, states, timed
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

KERNEL_OF = {"dense": "netes_mixing", "sparse": "netes_sparse_mixing"}


def _counters():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import moe_router as mr
    from repro_torch.kernels import netes_fused_mixing as nfm
    from repro_torch.kernels import netes_mixing as nm
    from repro_torch.kernels import netes_sparse_mixing as nsm
    from repro_torch.kernels import pendulum_rollout as pr
    from repro_torch.kernels import rwkv6_wkv as rw
    return {"netes_mixing": nm.KERNEL, "netes_sparse_mixing": nsm.KERNEL,
            "fused_neighbor_sum": nfm.NEIGHBOR_SUM,
            "fused_broadcast_select": nfm.BROADCAST_SELECT,
            "netes_mixing_rs": nm.KERNEL_RS,
            "netes_sparse_mixing_rs": nsm.KERNEL_RS,
            "fused_neighbor_sum_rs": nfm.NEIGHBOR_SUM_RS,
            "flash_attention": fa.KERNEL, "moe_topk": mr.KERNEL,
            "rwkv6_wkv": rw.KERNEL, "mamba_scan": ms.KERNEL,
            "pendulum_rollout": pr.KERNEL}


def main_phase(launches: dict) -> None:
    import math

    import torch

    from repro_torch.core import netes
    from repro_torch.core.netes import NetESConfig
    from repro_torch.core.topology import TopologySpec
    from repro_torch.envs import resolve_task
    from repro_torch.train.loop import (TrainConfig, build_topology,
                                        train_rl_netes)

    cfg = NetESConfig(alpha=0.05, sigma=0.1)   # the launcher's defaults
    for family, dens in (("erdos_renyi", MAIN_P_ER), ("fully_connected", 1.0)):
        tc = TrainConfig(
            n_agents=MAIN_N, iters=MAIN_ITERS, eval_every=MAIN_ITERS,
            eval_episodes=EVAL_EPISODES, seed=0, netes=cfg,
            topology=TopologySpec(family=family, n_agents=MAIN_N, p=dens,
                                  seed=0))
        topo = build_topology(tc, device="cuda")
        counters = _counters()
        for k in counters.values():
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hist = train_rl_netes("pendulum", tc, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {name: k.launches for name, k in counters.items()}
        kname = KERNEL_OF[topo.kind]
        check(counts[kname] > 0,
              f"{family}: {kname} never launched on the main path")
        launches[kname] = counts[kname]
        # one launch a reward call: an iteration's 2N episodes, an eval's
        check(counts["pendulum_rollout"] == MAIN_ITERS + len(hist["eval"]),
              f"{family}: pendulum_rollout launched "
              f"{counts['pendulum_rollout']} times, not once for each of "
              f"{MAIN_ITERS} iterations and {len(hist['eval'])} evals")
        launches["pendulum_rollout"] = counts["pendulum_rollout"]
        rewards = hist["reward_mean"] + hist["reward_max"] + hist["eval"]
        check(len(hist["reward_mean"]) == MAIN_ITERS
              and len(hist["eval"]) == 1, f"{family}: history has wrong length")
        check(all(math.isfinite(r) for r in rewards),
              f"{family}: non-finite rewards {rewards}")

        # steady-state step time and its two parts, outside the counted run
        reward_fn, dim, init_fn, _, _ = resolve_task("pendulum")
        state = netes.init_state(MAIN_N, dim, seed=1, init_fn=init_fn,
                                 device="cuda")
        step_ms = 1e3 * _host_time(
            functools.partial(netes.netes_step, state, topo, reward_fn, cfg),
            3)
        cand = torch.cat([state.thetas, state.thetas])
        resets = reward_fn.draw(state.generator, 2 * MAIN_N)
        rollout_ms = 1e3 * _host_time(
            functools.partial(reward_fn, cand, resets), 3)
        gen = torch.Generator(device="cuda").manual_seed(2)
        eps = torch.randn(state.thetas.shape, generator=gen, device="cuda")
        shaped = torch.rand(MAIN_N, generator=gen, device="cuda") - 0.5
        mixing_ms = time_ms(
            functools.partial(netes.mixing_update, topo, state.thetas, eps,
                              shaped, cfg))
        emit({"phase": "main", "task": "pendulum", "family": family,
              "density": dens, "representation": topo.kind,
              "k_max": topo.k_max, "n_agents": MAIN_N, "dim": dim,
              "iters": MAIN_ITERS, "wall_s": wall,
              "ms_per_iter_incl_build_and_eval": 1e3 * wall / MAIN_ITERS,
              "step_ms": step_ms, "rollout_2n_ms": rollout_ms,
              "mixing_update_ms": mixing_ms,
              "reward_mean": hist["reward_mean"],
              "reward_max": hist["reward_max"], "eval": hist["eval"],
              "eval_iter": hist["eval_iter"], "launches": counts})
    band_main_case(launches)


def band_main_case(launches: dict) -> None:
    """The main path at the ER cell's shape (``BAND_CELL``: N = 16,384, ER
    p = 0.0005 from topology seed 0, the pendulum policy's P = 4481):
    ``BAND_MAIN_ITERS`` ``netes_step`` iterations, the sparse kernel's two
    launch counts zeroed just before, must launch the band instance once
    an iteration and the slab instance never. The counts go to
    ``launches["netes_sparse_mixing_band"]``, the kernels line's band
    row."""
    import math

    import torch

    from repro_torch.core import netes
    from repro_torch.core.netes import NetESConfig
    from repro_torch.core.topology import TopologySpec
    from repro_torch.core.topology_repr import from_spec
    from repro_torch.envs import resolve_task
    from repro_torch.kernels import netes_sparse_mixing as nsm

    _, n, p_edge, cols = BAND_CELL
    cfg = NetESConfig(alpha=0.05, sigma=0.1)
    topo = from_spec(TopologySpec(family="erdos_renyi", n_agents=n,
                                  p=p_edge, seed=0), device="cuda")
    reward_fn, dim, init_fn, _, _ = resolve_task("pendulum")
    check(topo.kind == "sparse" and dim == cols,
          f"band main: a {topo.kind} topology at D = {dim}")
    state = netes.init_state(n, dim, seed=1, init_fn=init_fn, device="cuda")
    torch.cuda.synchronize()
    nsm.KERNEL_BAND.launches = nsm.KERNEL.launches = 0
    t0 = time.perf_counter()
    for _ in range(BAND_MAIN_ITERS):
        state, _, metrics = netes.netes_step(state, topo, reward_fn, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"band": nsm.KERNEL_BAND.launches, "slab": nsm.KERNEL.launches}
    check(counts == {"band": BAND_MAIN_ITERS, "slab": 0},
          f"band main: the sparse kernel's launches {counts} in "
          f"{BAND_MAIN_ITERS} iterations, not the band instance once each")
    check(all(math.isfinite(float(v)) for v in metrics.values()),
          f"band main: non-finite metrics {metrics}")
    check(bool(torch.isfinite(state.thetas).all()),
          "band main: non-finite θ")
    launches["netes_sparse_mixing_band"] = {"iters": BAND_MAIN_ITERS,
                                            **counts}
    emit({"phase": "main", "task": "pendulum", "family": "erdos_renyi",
          "density": p_edge, "representation": topo.kind,
          "k_max": topo.k_max, "n_agents": n, "dim": dim,
          "iters": BAND_MAIN_ITERS, "wall_s": wall,
          "ms_per_iter_incl_first": 1e3 * wall / BAND_MAIN_ITERS,
          "launches": counts})
    del state, topo
    torch.cuda.empty_cache()


def channel_phase(launches: dict) -> None:
    """``train_rl_netes`` at N = 1000 through each of ``CHANNEL_RUNS``,
    with the launch counters zeroed just before and read just after."""
    import math

    import torch

    from repro_torch.comm import channel as chan
    from repro_torch.core import netes
    from repro_torch.core.netes import NetESConfig
    from repro_torch.core.topology import TopologySpec
    from repro_torch.envs import resolve_task
    from repro_torch.train.loop import (TrainConfig, build_channel,
                                        build_topology, train_rl_netes)

    cfg = NetESConfig(alpha=0.05, sigma=0.1)
    expect = {"a": ("fused_neighbor_sum", "fused_broadcast_select"),
              "b": ("netes_mixing", "fused_broadcast_select")}
    for run, family, dens, text in CHANNEL_RUNS:
        tc = TrainConfig(
            n_agents=MAIN_N, iters=MAIN_ITERS, eval_every=MAIN_ITERS,
            eval_episodes=EVAL_EPISODES, seed=0, netes=cfg, channel=text,
            topology=TopologySpec(family=family, n_agents=MAIN_N, p=dens,
                                  seed=0))
        topo, ch = build_topology(tc, device="cuda"), build_channel(tc)
        counters = _counters()
        for k in counters.values():
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hist = train_rl_netes("pendulum", tc, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {name: k.launches for name, k in counters.items()}
        for kname in expect[run]:
            check(counts[kname] == MAIN_ITERS,
                  f"channel run ({run}): {kname} launched {counts[kname]} "
                  f"times in {MAIN_ITERS} iterations")
        if run == "a":
            launches.update({k: counts[k] for k in expect[run]})
        rewards = hist["reward_mean"] + hist["reward_max"] + hist["eval"]
        check(all(math.isfinite(r) for r in rewards),
              f"channel run ({run}): non-finite rewards {rewards}")
        # the drop fraction against Binomial(links, p) over the run: all
        # sources trigger here, so it is the fraction of links dropped
        p = ch.dropout_stage.p
        links = int(chan.realized_messages(topo, None, None).item()) // 2
        drop = sum(hist["drop_frac"]) / MAIN_ITERS
        sd = math.sqrt(p * (1 - p) / (links * MAIN_ITERS))
        check(abs(drop - p) <= 5 * sd, f"channel run ({run}): drop fraction "
              f"{drop} is more than 5 sd = {5 * sd:.3g} from p = {p}")
        check(hist["realized_msgs"] > 0, "no realized messages")

        # steady-state step and its parts, outside the counted run
        reward_fn, dim, init_fn, _, _ = resolve_task("pendulum")
        state = netes.init_state(MAIN_N, dim, seed=1, init_fn=init_fn,
                                 device="cuda")
        cstate = ch.init(state.thetas)
        step_ms = 1e3 * _host_time(
            functools.partial(netes.netes_step, state, topo, reward_fn, cfg,
                              channel=ch, chan_state=cstate), 3)
        cand = torch.cat([state.thetas, state.thetas])
        resets = reward_fn.draw(state.generator, 2 * MAIN_N)
        rollout_ms = 1e3 * _host_time(
            functools.partial(reward_fn, cand, resets), 3)
        gen = torch.Generator(device="cuda").manual_seed(2)
        eps = torch.randn(state.thetas.shape, generator=gen, device="cuda")
        payload = state.thetas + cfg.sigma * eps
        apply = ch.apply_wire if ch.wire_fused(topo) else ch.apply
        apply_ms = time_ms(functools.partial(apply, cstate, topo, payload))
        wire, em, _, _ = apply(cstate, topo, payload)
        shaped = torch.rand(MAIN_N, generator=gen, device="cuda") - 0.5
        mixing_ms = time_ms(functools.partial(
            netes.mixing_update, topo, state.thetas, eps, shaped, cfg,
            payload=wire, edge_mask=em))
        emit({"phase": "channel", "run": run, "task": "pendulum",
              "family": family, "density": dens, "channel": text,
              "label": ch.spec.label(), "representation": topo.kind,
              "wire_fused": ch.wire_fused(topo), "k_max": topo.k_max,
              "n_agents": MAIN_N, "dim": dim, "iters": MAIN_ITERS,
              "wall_s": wall, "step_ms": step_ms, "rollout_2n_ms": rollout_ms,
              "channel_apply_ms": apply_ms, "mixing_update_ms": mixing_ms,
              "realized_msgs": hist["realized_msgs"],
              "realized_wire_bytes": hist["realized_wire_bytes"],
              "msgs": hist["msgs"], "drop_frac_mean": drop,
              "drop_frac_5sd": 5 * sd, "links": links,
              "trigger_frac_mean": sum(hist["trigger_frac"]) / MAIN_ITERS,
              "reward_mean": hist["reward_mean"], "eval": hist["eval"],
              "launches": counts})


def _host_time(fn, iters: int) -> float:
    """Median host-clock seconds of ``fn`` run to completion, after one
    warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


# ---------------------------------------------------------------------------
# phase 5b: the main path under a topology schedule
# ---------------------------------------------------------------------------

# (run, family, density, schedule, channel, kernels that launch once a step)
SCHEDULE_RUNS = (
    ("s-a", "erdos_renyi", MAIN_P_ER, "resample_er(period=2)", None,
     ("netes_sparse_mixing",)),
    ("s-b", "erdos_renyi", 0.5, "anneal_density(p_end=0.1,horizon=4)", None,
     ("netes_mixing",)),
    ("s-c", "erdos_renyi", MAIN_P_ER, "resample_er(period=2)",
     CHANNEL_RUNS[0][3], ("fused_neighbor_sum", "fused_broadcast_select")),
    # circulant_erdos_renyi p = 0.05, seed 0: 21 offsets, the largest 463,
    # below (N − 1)//2 = 499 as rotation needs; mixes by the roll chain
    ("s-d", "circulant_erdos_renyi", 0.05, "rotate_circulant(stride=3)",
     None, ()),
)
EQ3_KERNELS = ("netes_mixing", "netes_sparse_mixing", "fused_neighbor_sum",
               "fused_broadcast_select")


def _schedule_config(family, dens, text, channel, **kw):
    from repro_torch.core.netes import NetESConfig
    from repro_torch.core.topology import TopologySpec
    from repro_torch.train.loop import TrainConfig
    base = dict(n_agents=MAIN_N, iters=MAIN_ITERS, eval_every=MAIN_ITERS,
                eval_episodes=EVAL_EPISODES, seed=0,
                netes=NetESConfig(alpha=0.05, sigma=0.1), schedule=text,
                channel=channel,
                topology=TopologySpec(family=family, n_agents=MAIN_N, p=dens,
                                      seed=0))
    return TrainConfig(**{**base, **kw})


def _check_refreshed_list(sched_state, smi: str) -> dict:
    """s-a: the sparse kernel on the list a redraw made (K_max = 140, the
    padded slots of a refresh index other agents with weight 0), against
    its plain version and float64, twice for the same bits."""
    import torch

    from repro_torch.kernels import netes_sparse_mixing as nsm
    from repro_torch.kernels import ref
    topo = sched_state.topo
    theta, eps, w = _operands(MAIN_N, 4481, seed=21)
    args = (topo.neighbor_idx, topo.neighbor_mask, w, w, theta, eps)
    out_k = nsm.netes_sparse_mixing(*args, sigma=0.1)
    out_p = ref.sparse_mixing_ref(*args, sigma=0.1)
    check(torch.equal(nsm.netes_sparse_mixing(*args, sigma=0.1), out_k),
          "schedule s-a: two launches on the refreshed list differ")
    adj64 = topo.to_dense().double()
    rel_k = _check_against_f64("schedule s-a refreshed list", out_k, adj64,
                               w, theta, eps, 0.1)
    rel_p = _check_against_f64("schedule s-a refreshed list plain", out_p,
                               adj64, w, theta, eps, 0.1)
    return {"k_max": topo.k_max, "max_abs_err": (out_k - out_p).abs().max()
            .item(), "max_err_over_S": rel_k, "plain_err_over_S": rel_p,
            "tol_over_S": TOL_REL, "nvidia_smi": smi}


def schedule_phase(launches: dict) -> dict:
    """``train_rl_netes`` at N = 1000 under each of ``SCHEDULE_RUNS``, the
    launch counters zeroed just before each run and read just after; the
    graphs each schedule makes, checked on the card; the resume of run
    s-c from a checkpoint, bit for bit; step and advance times. Returns
    the runs' schedule states at t = 1 (the next advance redraws) for the
    sync check."""
    import math
    import tempfile

    import torch

    from repro_torch.core import netes
    from repro_torch.envs import resolve_task
    from repro_torch.train.loop import (build_channel, build_schedule,
                                        train_rl_netes)

    smi = nvidia_smi()
    reward_fn, dim, init_fn, _, _ = resolve_task("pendulum")
    states = {}
    for run, family, dens, text, channel, expect in SCHEDULE_RUNS:
        tc = _schedule_config(family, dens, text, channel)
        schedule, ch = build_schedule(tc), build_channel(tc)
        counters = _counters()
        for k in counters.values():
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hist = train_rl_netes("pendulum", tc, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {name: k.launches for name, k in counters.items()}
        for kname in EQ3_KERNELS:
            want = MAIN_ITERS if kname in expect else 0
            check(counts[kname] == want, f"schedule {run}: {kname} launched "
                  f"{counts[kname]} times in {MAIN_ITERS} iterations, not "
                  f"{want}")
            launches.setdefault(kname, {})[run] = counts[kname]
        rewards = hist["reward_mean"] + hist["reward_max"] + hist["eval"]
        check(len(hist["reward_mean"]) == MAIN_ITERS
              and all(math.isfinite(r) for r in rewards),
              f"schedule {run}: history {rewards}")

        # the graphs of t = 0 … MAIN_ITERS, outside the counted run
        sstate = schedule.init(device="cuda")
        graphs, row = [], {}
        for t in range(MAIN_ITERS + 1):
            graphs.append(sstate)
            if t == 1:
                states[run] = sstate
            sstate = schedule.advance(sstate)
        dense = [g.topo.to_dense() for g in graphs]
        degs = [int(d.sum().item()) for d in dense]
        if run in ("s-a", "s-c"):
            g0, g2 = graphs[0].topo, graphs[2].topo
            check(g2.k_max == g0.k_max == 140, f"schedule {run}: K_max "
                  f"{g2.k_max}, not pad_k_max's 140")
            check(not (torch.equal(g0.neighbor_idx, g2.neighbor_idx)
                       and torch.equal(g0.neighbor_mask, g2.neighbor_mask)),
                  f"schedule {run}: the list at t = 2 equals t = 0's")
            check(torch.equal(dense[1], dense[0])
                  and torch.equal(dense[3], dense[2]),
                  f"schedule {run}: the graph changed off-period")
            if run == "s-a":
                row["refreshed_list"] = _check_refreshed_list(graphs[2],
                                                              smi)
        if run == "s-b":
            for t in range(1, len(dense)):
                check(bool((dense[t] <= dense[t - 1]).all().item()),
                      f"schedule s-b: an edge appeared at t = {t}")
                check(degs[t] <= degs[t - 1],
                      f"schedule s-b: density rose at t = {t}")
        if run == "s-d":
            deg0 = dense[0].sum(dim=1)
            for t, d in enumerate(dense):
                check(torch.equal(d.sum(dim=1), deg0)
                      and torch.equal(graphs[t].topo.deg, deg0),
                      f"schedule s-d: a degree changed at t = {t}")
            check(len({g.topo.shifts for g in graphs}) == len(graphs),
                  "schedule s-d: the circulant did not rotate")
            row["offsets"] = len(schedule.base_offsets)
            row["max_offset"] = max(schedule.base_offsets)

        # steady-state step, and the advance into a redraw (t = 1 → 2)
        state = netes.init_state(MAIN_N, dim, seed=1, init_fn=init_fn,
                                 device="cuda")
        cstate = ch.init(state.thetas) if ch is not None else None
        step_ms = 1e3 * _host_time(functools.partial(
            netes.scheduled_step, state, states[run], reward_fn, tc.netes,
            schedule, channel=ch, chan_state=cstate), 3)
        advance = functools.partial(schedule.advance, states[run])
        adv = (None if run == "s-d" else time_stats(advance))
        emit({"phase": "schedule", "run": run, "task": "pendulum",
              "family": family, "density": dens, "schedule": text,
              "channel": channel, "representation": schedule.representation,
              "k_max": schedule.k_max, "n_agents": MAIN_N, "dim": dim,
              "iters": MAIN_ITERS, "wall_s": wall, "step_ms": step_ms,
              "advance_redraws": schedule.redraws(2),
              "advance_ms": None if adv is None else adv["ms"],
              "advance_ms_q1": None if adv is None else adv["ms_q1"],
              "advance_ms_q3": None if adv is None else adv["ms_q3"],
              "edges_by_t": degs, "reward_mean": hist["reward_mean"],
              "eval": hist["eval"], "msgs": hist.get("msgs"),
              "launches": counts, "nvidia_smi": smi, **row})

    # resume on the card: s-c checkpointed at iteration 1, resumed to 3
    _, family, dens, text, channel, _ = SCHEDULE_RUNS[2]
    with tempfile.TemporaryDirectory() as tmp:
        full = train_rl_netes("pendulum", _schedule_config(
            family, dens, text, channel, eval_every=2), device="cuda")
        train_rl_netes("pendulum", _schedule_config(
            family, dens, text, channel, eval_every=2, iters=2,
            checkpoint_dir=tmp), device="cuda")
        resumed = train_rl_netes("pendulum", _schedule_config(
            family, dens, text, channel, eval_every=2, checkpoint_dir=tmp),
            device="cuda")
    for k in ("eval", "reward_mean", "reward_max", "msgs"):
        n = len(resumed[k])
        check(n > 0 and resumed[k] == full[k][-n:],
              f"schedule resume: {k} {resumed[k]} after the resume, "
              f"{full[k][-n:]} uninterrupted")
    emit({"phase": "schedule_resume", "run": "s-c", "resumed_at": 2,
          "iters": MAIN_ITERS, "eval": resumed["eval"],
          "reward_mean": resumed["reward_mean"], "msgs": resumed["msgs"],
          "bit_equal": True})
    return states


def no_sync_step_phase(sched_states: dict) -> None:
    """One ``netes_step`` on ER and FC and through channels (a) and (b),
    and one ``scheduled_step`` of each of ``SCHEDULE_RUNS`` (s-a and s-c
    from t = 1, so the advance redraws and sorts), each after a warm-up
    and under ``torch.cuda.set_sync_debug_mode("error")``: any call in it
    that waits for the card raises there."""
    import torch

    from repro_torch.core import netes
    from repro_torch.envs import resolve_task
    from repro_torch.train.loop import (build_channel, build_schedule,
                                        build_topology)

    reward_fn, dim, init_fn, _, _ = resolve_task("pendulum")
    cases = [("ER", "erdos_renyi", MAIN_P_ER, None, None),
             ("FC", "fully_connected", 1.0, None, None)]
    cases += [(f"channel ({run})", fam, dens, text, None)
              for run, fam, dens, text in CHANNEL_RUNS]
    cases += [(f"scheduled {run}", fam, dens, ch, text)
              for run, fam, dens, text, ch, _ in SCHEDULE_RUNS]
    checked = []
    for label, family, dens, channel, text in cases:
        tc = _schedule_config(family, dens, text, channel)
        ch = build_channel(tc)
        state = netes.init_state(MAIN_N, dim, seed=2, init_fn=init_fn,
                                 device="cuda")
        cstate = ch.init(state.thetas) if ch is not None else None
        if text is None:
            step = functools.partial(netes.netes_step, state,
                                     build_topology(tc, device="cuda"),
                                     reward_fn, tc.netes, channel=ch,
                                     chan_state=cstate)
        else:
            step = functools.partial(
                netes.scheduled_step, state, sched_states[label.split()[1]],
                reward_fn, tc.netes, build_schedule(tc), channel=ch,
                chan_state=cstate)
        step()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            step()
        except RuntimeError as err:
            raise RuntimeError(f"no_sync {label}: the step waits for the "
                               f"card: {err}") from err
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        checked.append(label)
    emit({"phase": "no_sync", "steps": checked, "n_agents": MAIN_N,
          "sync_debug_mode": "error", "step_synced": False})


# ---------------------------------------------------------------------------
# phase 5c: telemetry of the NetES loop and the serve engine
# ---------------------------------------------------------------------------

# (run, family, density, channel, schedule, probes, kernels that launch
# once a step)
TELEMETRY_RUNS = (
    ("ER", "erdos_renyi", MAIN_P_ER, None, None, "fitness|consensus|graph",
     ("netes_sparse_mixing",)),
    ("FC", "fully_connected", 1.0, None, None, "fitness|consensus|graph",
     ("netes_mixing",)),
    ("channel (a)", "erdos_renyi", MAIN_P_ER, CHANNEL_RUNS[0][3], None, "all",
     ("fused_neighbor_sum", "fused_broadcast_select")),
    ("s-a", "erdos_renyi", MAIN_P_ER, None, "resample_er(period=2)",
     "fitness|graph", ("netes_sparse_mixing",)),
)
K_MAX_S_A = 140         # pad_k_max(1000, 0.1, …) of schedule s-a


def _check_trace(path, label: str, moves: str = "drain") -> dict:
    """The trace validates; no span after the build phase built a kernel;
    each span named ``moves`` (a loop's ``drain``, a generate's
    ``decode``) is one transfer, and the spans at depth 0 transfer exactly
    once per such span. Returns the span counts by name and the
    transfers."""
    from repro_torch.obs import read_trace, validate_trace
    errors = validate_trace(path)
    check(not errors, f"telemetry {label}: trace violations {errors}")
    spans = [r for r in read_trace(path) if r["kind"] == "span"]
    built = [r for r in spans if r["compiles"]]
    check(not built, f"telemetry {label}: spans built kernels: {built}")
    drains = [r for r in spans if r["name"] == moves]
    total = sum(r["transfers"] for r in spans if r["depth"] == 0)
    check(total == len(drains) and all(r["transfers"] == 1 for r in drains),
          f"telemetry {label}: {total} transfers in {len(drains)} {moves} "
          "spans")
    names = {}
    for r in spans:
        names[r["name"]] = names.get(r["name"], 0) + 1
    return {"spans": names, "transfers": total, "drains": len(drains)}


def _telemetry_run(label, family, dens, channel, text, stages, expect,
                   launches: dict, tmp) -> dict:
    """One probed and traced ``train_rl_netes`` at N = 1000 against the
    unprobed run from the same seed, with its checks; returns its row."""
    import math

    import numpy as np
    import torch

    from repro_torch.core import theory
    from repro_torch.train.loop import train_rl_netes

    plain = train_rl_netes("pendulum", _schedule_config(family, dens, text,
                                                        channel),
                           device="cuda")
    trace = pathlib.Path(tmp) / f"{label.replace(' ', '_')}.jsonl"
    tc = _schedule_config(family, dens, text, channel, probes=stages,
                          trace=str(trace))
    counters = _counters()
    for k in counters.values():
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = train_rl_netes("pendulum", tc, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {name: k.launches for name, k in counters.items()}
    for kname in EQ3_KERNELS:
        want = MAIN_ITERS if kname in expect else 0
        check(counts[kname] == want, f"telemetry {label}: {kname} launched "
              f"{counts[kname]} times in {MAIN_ITERS} iterations, not {want}")
        if want:
            launches.setdefault(kname, {})[label] = counts[kname]
    series = hist.pop("probes")
    for k in plain:
        if k != "wall_s":
            check(hist[k] == plain[k], f"telemetry {label}: probed {k} "
                  f"{hist[k]} differs from the unprobed run's {plain[k]}")
    check(series["cursor"] == MAIN_ITERS and series["dropped"] == 0,
          f"telemetry {label}: ring cursor {series['cursor']}")
    row = {"phase": "telemetry", "run": label, "probes": stages,
           "family": family, "density": dens, "channel": channel,
           "schedule": text, "n_agents": MAIN_N, "iters": MAIN_ITERS,
           "wall_s": wall, "launches": counts, "probed_equals_plain": True,
           "trace": _check_trace(trace, label)}
    if "fitness_mean" in series:
        check(np.array_equal(series["fitness_mean"],
                             np.asarray(hist["reward_mean"], np.float32)),
              f"telemetry {label}: fitness_mean is not reward_mean")
    if "msgs" in series:
        check(np.array_equal(series["msgs"],
                             np.asarray(hist["msgs"], np.float32)),
              f"telemetry {label}: wire msgs differ from the history's")
    if "density" in series:
        dens_t = torch.as_tensor(series["density"], device="cuda")
        prior = theory.reachability_prior(MAIN_N, dens_t).cpu().numpy()
        check(np.array_equal(series["reach_proxy"], prior),
              f"telemetry {label}: reach_proxy {series['reach_proxy']} is "
              f"not reachability_prior(N, density) {prior}")
        if family == "fully_connected":
            check(bool((series["density"] == 1.0).all()),
                  f"telemetry {label}: FC density {series['density']}")
        else:
            sd = math.sqrt(dens * (1 - dens) / (MAIN_N * (MAIN_N - 1) / 2))
            gap = float(np.abs(series["density"] - dens).max())
            check(gap <= 5 * sd, f"telemetry {label}: density "
                  f"{series['density']} more than 5 sd = {5 * sd:.3g} "
                  f"from {dens}")
            row["density_5sd"] = 5 * sd
        if text is not None:
            # the graph signals change where the graph does: at t = 2 only
            graph = np.stack([series[k] for k in ("density", "deg_min",
                                                  "deg_max")])
            same = [bool((graph[:, t] == graph[:, t + 1]).all())
                    for t in range(MAIN_ITERS - 1)]
            check(same == [True, False, True]
                  and series["deg_max"].max() <= K_MAX_S_A,
                  f"telemetry {label}: graph signals {graph.tolist()} do "
                  f"not change at t = 2 only, or deg_max exceeds K_max = "
                  f"{K_MAX_S_A}")
            row["deg_max_changed_at_2"] = bool(series["deg_max"][2]
                                               != series["deg_max"][1])
    row["series"] = {k: (v.tolist() if hasattr(v, "tolist") else v)
                     for k, v in series.items()}
    return row


def _serve_trace_check(tmp) -> dict:
    """One traced ``ServeEngine.generate`` of mistral-nemo-12b at full width
    and 2 layers (serve_parity's model): tokens equal to the untraced
    engine's, a valid trace with no kernel built, 2 flash launches."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer
    from repro_torch.obs import read_trace
    from repro_torch.serve import ServeEngine

    cfg = dataclasses.replace(get_config(ARCH), num_layers=PARITY_LAYERS)
    params = transformer.init_params(cfg, seed=0, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (PARITY_BATCH, PARITY_PROMPT),
                            generator=g, device="cuda")
    max_len = PARITY_PROMPT + PARITY_NEW
    plain = ServeEngine(cfg, params, max_len=max_len).generate(
        prompts, new_tokens=PARITY_NEW)
    path = pathlib.Path(tmp) / "serve.jsonl"
    engine = ServeEngine(cfg, params, max_len=max_len, trace=str(path))
    fa.KERNEL.launches = 0
    traced = engine.generate(prompts, new_tokens=PARITY_NEW)
    flash = fa.KERNEL.launches
    engine.close()
    check(np.array_equal(traced, plain),
          "telemetry serve: traced generate differs from the untraced")
    check(flash == PARITY_LAYERS, f"telemetry serve: flash attention "
          f"launched {flash} times in a traced generate")
    summary = _check_trace(path, "serve", moves="decode")
    recs = read_trace(path)
    events = {r["name"]: r["attrs"] for r in recs if r["kind"] == "event"}
    spans = {r["name"]: r["dur_s"] for r in recs if r["kind"] == "span"}
    del params, engine
    torch.cuda.empty_cache()
    return {"phase": "telemetry_serve", "arch": ARCH,
            "num_layers": PARITY_LAYERS, "batch": PARITY_BATCH,
            "prompt": PARITY_PROMPT, "new_tokens": PARITY_NEW,
            "tokens_equal": True, "flash_launches": flash,
            "span_s": spans, "events": events, "trace": summary,
            "meta": recs[0]}


STEP_PAIRS = 24          # (plain, probed) step pairs timed in turns


def _quartiles(xs) -> dict:
    q1, med, q3 = statistics.quantiles(xs, n=4)
    return {"median": med, "q1": q1, "q3": q3}


def _paired_step_times(first, second, pairs: int = STEP_PAIRS,
                       names=("plain", "probed")) -> dict:
    """``pairs`` calls of ``first`` and as many of ``second`` from the same
    state, in turns (``first`` first in even pairs, ``second`` first in odd
    ones, so a drift falls on both), each run to completion: the quartiles
    in ms of its CUDA events (from the card reaching the call's first
    launch to its last) and of the host clock, under ``names``, and of
    the second-minus-first difference within each pair."""
    import torch
    a, b = names
    first(), second()
    torch.cuda.synchronize()
    dev = {a: [], b: []}
    host = {a: [], b: []}
    for k in range(pairs):
        order = ((a, first), (b, second))
        for name, fn in (order if k % 2 == 0 else order[::-1]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            host[name].append(1e3 * (time.perf_counter() - t0))
            dev[name].append(start.elapsed_time(end))
    out = {"pairs": pairs}
    for clock, t in (("device_ms", dev), ("host_ms", host)):
        out[clock] = {name: _quartiles(t[name]) for name in t}
        out[clock][f"{b}_minus_{a}"] = _quartiles(
            [y - x for x, y in zip(t[a], t[b])])
    return out


def telemetry_phase(launches: dict) -> None:
    """``TELEMETRY_RUNS`` probed and traced, each against its unprobed run;
    one probed step under the sync check; a traced ``generate``; the time
    of one ``Probes.record`` of every stage, and ``STEP_PAIRS`` step pairs
    with and without probes, in turns."""
    import tempfile

    import torch

    from repro_torch.core import netes
    from repro_torch.envs import resolve_task
    from repro_torch.obs import compile_probes
    from repro_torch.train.loop import build_channel, build_topology

    smi = nvidia_smi()
    with tempfile.TemporaryDirectory() as tmp:
        for run in TELEMETRY_RUNS:
            row = _telemetry_run(*run, launches=launches, tmp=tmp)
            emit({**row, "nvidia_smi": smi})
        serve = _serve_trace_check(tmp)
    launches.setdefault("flash_attention", {})["traced generate"] = \
        serve["flash_launches"]
    emit({**serve, "nvidia_smi": smi})

    reward_fn, dim, init_fn, _, _ = resolve_task("pendulum")
    cfg = _schedule_config("erdos_renyi", MAIN_P_ER, None, None).netes
    step_ms = {}
    for label, family, dens in (("ER", "erdos_renyi", MAIN_P_ER),
                                ("FC", "fully_connected", 1.0)):
        tc = _schedule_config(family, dens, None, None)
        topo = build_topology(tc, device="cuda")
        probes = compile_probes("fitness|consensus|graph")
        ring = probes.init("cuda")
        state = netes.init_state(MAIN_N, dim, seed=7, init_fn=init_fn,
                                 device="cuda")
        plain = functools.partial(netes.netes_step, state, topo, reward_fn,
                                  cfg)
        probed = functools.partial(plain, probes=probes, metrics_state=ring)
        step_ms[label] = _paired_step_times(plain, probed)
        if label == "ER":
            probed()
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                probed()
            except RuntimeError as err:
                raise RuntimeError("no_sync telemetry: the probed step "
                                   f"waits for the card: {err}") from err
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()

    # one record of every stage, on channel (a)'s metrics and graph
    tc = _schedule_config("erdos_renyi", MAIN_P_ER, None, CHANNEL_RUNS[0][3])
    topo, ch = build_topology(tc, device="cuda"), build_channel(tc)
    probes = compile_probes("all", channel=ch, dim=dim)
    state = netes.init_state(MAIN_N, dim, seed=8, init_fn=init_fn,
                             device="cuda")
    _, _, ring, metrics = netes.netes_step(
        state, topo, reward_fn, cfg, channel=ch,
        chan_state=ch.init(state.thetas), probes=probes,
        metrics_state=probes.init("cuda"))
    record = functools.partial(probes.record, ring, metrics, topo)
    rec = time_stats(record)
    torch.cuda.synchronize()
    calls = 200
    t0 = time.perf_counter()
    for _ in range(calls):
        record()
    host_us = 1e6 * (time.perf_counter() - t0) / calls
    torch.cuda.synchronize()
    kinds = _kernel_launches(record, calls=1)["kernels"]
    emit({"phase": "telemetry_cost", "probes": "all", "signals":
          probes.n_signals, "record_ms": rec["ms"], "record_ms_q1":
          rec["ms_q1"], "record_ms_q3": rec["ms_q3"],
          "record_host_us": host_us, "record_kernels": kinds,
          "step_ms_in_turns": step_ms,
          "probed_step_synced": False, "nvidia_smi": smi})


# ---------------------------------------------------------------------------
# phase 5d: one probed NetES step captured as a CUDA graph
# ---------------------------------------------------------------------------

CAPTURE_STEPS = 3        # replays held against as many eager steps
CAPTURE_TIMED = 10       # replays timed with CUDA events
CAPTURE_CASES = (("ER", "erdos_renyi", MAIN_P_ER),
                 ("FC", "fully_connected", 1.0))


def _step_outputs(state, ring):
    return (state.thetas.clone(), state.best_theta.clone(),
            state.best_reward.clone(), ring.buf.clone(), ring.cursor.clone())


def capture_phase(launches: dict, cases=CAPTURE_CASES) -> None:
    """For ER (the sparse kernel) and FC (the dense kernel) at N = 1000: one
    probed ``netes_step`` captured as a ``torch.cuda.CUDAGraph`` after a
    warm-up on a side stream, replayed ``CAPTURE_STEPS`` times with the
    state copied back between replays, and held bit for bit against as
    many eager probed steps from the same state and draws. The draws come
    from the state's generator, registered with the graph
    (``CUDAGraph.register_generator_state``; a torch without it fails
    here). One replay's kernels are counted from a profiler trace (the Python launch
    counters do not tick on a replay); its time per step by CUDA events."""
    import dataclasses

    import torch

    from repro_torch.core import netes
    from repro_torch.envs import resolve_task
    from repro_torch.obs import compile_probes
    from repro_torch.train.loop import build_topology

    smi = nvidia_smi()
    check(hasattr(torch.cuda.CUDAGraph, "register_generator_state"),
          f"capture: torch {torch.__version__} has no "
          "CUDAGraph.register_generator_state, which the captured step "
          "needs for the state's generator")
    reward_fn, dim, init_fn, _, _ = resolve_task("pendulum")
    probes = compile_probes("fitness|consensus|graph", capacity=8)
    for label, family, dens in cases:
        tc = _schedule_config(family, dens, None, None)
        cfg = tc.netes
        topo = build_topology(tc, device="cuda")
        kname = KERNEL_OF[topo.kind]
        init = netes.init_state(MAIN_N, dim, seed=6, init_fn=init_fn,
                                device="cuda")
        gen0 = init.generator.get_state()

        def generator():
            g = torch.Generator(device="cuda")
            g.set_state(gen0)
            return g


        # the eager steps
        st = dataclasses.replace(init, generator=generator())
        ring = probes.init("cuda")
        eager = []
        for k in range(CAPTURE_STEPS):
            st, _, ring, _ = netes.netes_step(st, topo, reward_fn, cfg,
                                              probes=probes,
                                              metrics_state=ring)
            eager.append(_step_outputs(st, ring))
        torch.cuda.synchronize()
        eager_ms = 1e3 * _host_time(functools.partial(
            netes.netes_step, init, topo, reward_fn, cfg,
            probes=probes, metrics_state=probes.init("cuda")), 3)

        # static inputs, a warm-up on a side stream, then the capture
        static = netes.NetESState(
            thetas=init.thetas.clone(), generator=generator(),
            step=init.step.clone(), best_reward=init.best_reward.clone(),
            best_theta=init.best_theta.clone())
        sring = probes.init("cuda")

        def step():
            return netes.netes_step(static, topo, reward_fn, cfg,
                                    probes=probes, metrics_state=sring)

        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        sring.buf.zero_()
        sring.cursor.zero_()
        static.generator.set_state(gen0)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(static.generator)
        t0 = time.perf_counter()
        with torch.cuda.graph(graph):
            out = step()
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        new = out[0]

        replayed = []
        for k in range(CAPTURE_STEPS):
            graph.replay()
            for name in ("thetas", "step", "best_reward", "best_theta"):
                getattr(static, name).copy_(getattr(new, name))
            replayed.append(_step_outputs(static, sring))
        torch.cuda.synchronize()
        fields = ("thetas", "best_theta", "best_reward", "ring buf",
                  "ring cursor")
        for k in range(CAPTURE_STEPS):
            for name, a, b in zip(fields, replayed[k], eager[k]):
                check(torch.equal(a, b), f"capture {label}: replay {k + 1} "
                      f"{name} differs from the eager step's")

        # a trace on this card sometimes holds none of the device's
        # events: it is taken again, up to three times, until it does
        for attempt in range(1, 4):
            kernels = _kernel_launches(graph.replay, calls=1)["kernels"]
            if kernels:
                break
        eq3 = {k: v for k, v in kernels.items()
               if any(s in k for s in ("sparse_mixing_slab", "mixing_gemm",
                                       "mixing_weights", "mixing_fixup"))}
        want = ("sparse_mixing_slab" if kname == "netes_sparse_mixing"
                else "mixing_gemm")
        check(any(want in k for k in eq3), f"capture {label}: {want} is not "
              f"in the replay's profile ({len(kernels)} kernel names)")
        launches.setdefault(kname, {})[f"capture {label}, one replay"] = sum(
            v for k, v in eq3.items() if want in k)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for _ in range(CAPTURE_TIMED):
            graph.replay()
        end.record()
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        replay_ms = start.elapsed_time(end) / CAPTURE_TIMED
        emit({"phase": "capture", "graph": label, "representation":
              topo.kind, "n_agents": MAIN_N, "dim": dim, "probes":
              probes.spec.label(), "draws": "generator registered",
              "capture_s": capture_s, "replays_checked": CAPTURE_STEPS,
              "bit_equal": True, "replay_kernels": sum(kernels.values()),
              "replay_kernels_by_name": eq3, "replay_ms": replay_ms,
              "replay_host_enqueue_ms": 1e3 * host_s / CAPTURE_TIMED,
              "eager_step_ms": eager_ms, "torch": torch.__version__,
              "nvidia_smi": smi})
        del graph, out, new
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 5e: the topology search
# ---------------------------------------------------------------------------

SEARCH_ITERS = 4         # iterations of the parity round and of round 0
SEARCH_PAIRS = 10        # (sequential, cohort) step pairs timed in turns
# the cohorts of the parity check and of the tournament: ER p = 0.05 and
# 0.1 are sparse (the lists widened to the cohort's K_max), FC and ER
# p = 0.5 dense
SEARCH_COHORTS = (("sparse", (("erdos_renyi", 0.05), ("erdos_renyi", 0.1))),
                  ("dense", (("fully_connected", 1.0),
                             ("erdos_renyi", 0.5))))
SEARCH_ARGV = ("rl", "--task", "pendulum", "--agents", str(MAIN_N),
               "--search", "--search-families",
               "erdos_renyi,fully_connected", "--search-densities",
               "0.05,0.1,0.5", "--search-seeds", "0", "--search-pool", "4",
               "--search-iters", str(SEARCH_ITERS), "--iters", "2")
# the second tournament: two graph seeds, static and resampled, through q8
SEARCH_Q8 = dict(families=("erdos_renyi",), densities=(MAIN_P_ER,),
                 seeds=(0, 1), schedules=(None, "resample_er(period=2)"),
                 channels=("quantize(bits=8)",), pool_size=4, round_iters=2,
                 eval_episodes=1)
# |Δ score| ≤ TOL_SCORE·|score| between a cohort's scores (its candidates'
# eval episodes in one rollout of S·E rows) and each candidate's alone (E
# rows), where their bits differ: cuBLAS may run another product for
# another batch, and one rounding in a pendulum episode near the upright
# equilibrium moves its return by up to 2e-3 relative (ROADMAP §3, slice 1)
TOL_SCORE = 2e-3


def _search_cohort(rep, graphs, channel=None, schedule=None):
    """The plans of one cohort at N = 1000 (asserted to be one cohort)."""
    from repro_torch.comm.channel import ChannelSpec
    from repro_torch.core.topology import TopologySpec
    from repro_torch.core.topology_sched import ScheduleSpec
    from repro_torch.search import CandidateSpec, tournament
    pool = [CandidateSpec(
        topo=TopologySpec(family=fam, n_agents=MAIN_N, p=dens, seed=seed),
        sched=None if schedule is None else ScheduleSpec.parse(schedule),
        chan=None if channel is None else ChannelSpec.parse(channel))
        for seed, (fam, dens) in enumerate(graphs)]
    plans = tournament._make_plans(pool, "auto", "cuda")
    check(len({p.cohort for p in plans}) == 1, f"search: {pool} make "
          f"{len({p.cohort for p in plans})} cohorts, not 1")
    kind = (plans[0].schedule.representation if schedule is not None
            else plans[0].cohort[1])
    check(kind == rep, f"search: the cohort is {kind}, not {rep}")
    return plans


def _search_states(plans, reward_fn, dim, init_fn):
    """Each candidate's initial states and eval generator, as
    ``run_search`` makes them."""
    import torch

    from repro_torch.core import netes
    from repro_torch.search import tournament
    states = [netes.init_state(MAIN_N, dim, seed=tournament._stream_seed(
        0, c), init_fn=init_fn, device="cuda") for c in range(len(plans))]
    gens = [torch.Generator(device="cuda").manual_seed(
        tournament._stream_seed(999, c, 0)) for c in range(len(plans))]
    return states, gens


def _first_divergence(env, policy, thetas, resets) -> dict:
    """The episodes of ``thetas (M, D)`` from ``resets (M, S)`` stepped as
    one batch and one row at a time, call by call as ``episode_return``
    makes them: the first call whose outputs differ, with its step and
    the largest difference, or None if the returns are equal."""
    import torch

    m = thetas.shape[0]
    batch = (policy.unflatten(thetas), resets)
    rows = [(policy.unflatten(thetas[i:i + 1]), resets[i:i + 1])
            for i in range(m)]
    n_layers = len(batch[0]) // 2

    def differs(name, t, got, own):
        own = torch.cat(own)
        if torch.equal(got, own):
            return None
        return {"step": t, "call": name, "rows": m,
                "max_abs_diff": (got - own).abs().max().item()}

    for t in range(env.episode_len):
        outs = []
        for params, state in [batch, *rows]:
            h = env.observe(state)
            trail = [("observe", h)]
            for i in range(n_layers):
                h = torch.baddbmm(params[2 * i + 1].unsqueeze(1),
                                  h.unsqueeze(1), params[2 * i]).squeeze(1)
                trail.append((f"baddbmm of layer {i}", h))
                h = torch.tanh(h)
                trail.append((f"tanh of layer {i}", h))
            trail.append(("env.step", env.step(state, h)[0]))
            outs.append(trail)
        for k, (name, got) in enumerate(outs[0]):
            found = differs(name, t, got, [o[k][1] for o in outs[1:]])
            if found is not None:
                return found
        batch = (batch[0], outs[0][-1][1])
        rows = [(params, o[-1][1]) for (params, _), o in zip(rows,
                                                             outs[1:])]
    return None


def _search_parity() -> list:
    """Per cohort of ``SEARCH_COHORTS``: a round of ``SEARCH_ITERS``
    iterations through the tournament's round function against the same
    candidates as independent ``netes.run``s from the same states and
    generators on the same widened topologies, and one batched rollout
    against the candidates' own."""
    import torch

    from repro_torch.core import netes, topology_repr
    from repro_torch.envs import resolve_task
    from repro_torch.search import tournament

    reward_fn, dim, init_fn, env, policy = resolve_task("pendulum")
    cfg = _schedule_config("erdos_renyi", MAIN_P_ER, None, None).netes
    rows = []
    for rep, graphs in SEARCH_COHORTS:
        plans = _search_cohort(rep, graphs)
        topos = topology_repr.unstack(topology_repr.stack(
            [p.topo for p in plans]))
        states, gens = _search_states(plans, reward_fn, dim, init_fn)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, _, _, scores = tournament._round(
            states, topos, reward_fn, cfg, SEARCH_ITERS, 1, gens)
        torch.cuda.synchronize()
        round_s = time.perf_counter() - t0
        states, gens = _search_states(plans, reward_fn, dim, init_fn)
        t0 = time.perf_counter()
        alone = [netes.run(st, topo, reward_fn, cfg, SEARCH_ITERS)[0]
                 for st, topo in zip(states, topos)]
        alone_scores = torch.cat([tournament._eval_scores(
            [st], reward_fn, 1, [g]) for st, g in zip(alone, gens)])
        torch.cuda.synchronize()
        alone_s = time.perf_counter() - t0

        # one rollout of all candidates against each candidate's own
        states, _ = _search_states(plans, reward_fn, dim, init_fn)
        draws = [netes.draw(st, reward_fn, MAIN_N, dim) for st in states]
        parts = [netes._perturb(st, cfg, d) for st, d in zip(states, draws)]
        batched = reward_fn(torch.cat([c for c, _ in parts]),
                            torch.cat([e for _, e in parts]))
        own = torch.cat([reward_fn(c, e) for c, e in parts])

        def diff(f):
            return max((getattr(a, f).double() - getattr(b, f).double())
                       .abs().max().item() for a, b in zip(got, alone))

        states_equal = all(
            torch.equal(getattr(a, f), getattr(b, f)) for a, b in
            zip(got, alone) for f in ("thetas", "best_theta",
                                      "best_reward"))
        scores_equal = torch.equal(scores, alone_scores)
        divergence = None
        if not scores_equal:
            # the eval episodes the scores came from, batched and alone
            _, gens = _search_states(plans, reward_fn, dim, init_fn)
            resets = torch.cat([reward_fn.draw(g, 1) for g in gens])
            divergence = _first_divergence(
                env, policy, torch.stack([st.best_theta for st in got]),
                resets.reshape(len(got), -1))
        rows.append({
            "cohort": rep, "graphs": [list(g) for g in graphs],
            "k_max": [p.topo.k_max for p in plans],
            "k_max_shared": topos[0].k_max, "iters": SEARCH_ITERS,
            "states_bit_equal": states_equal,
            "scores_bit_equal": scores_equal,
            "score_first_differing_call": divergence,
            "tol_score_rel": TOL_SCORE, "max_abs_dtheta": diff("thetas"),
            "max_abs_dbest_theta": diff("best_theta"),
            "max_abs_dbest_reward": diff("best_reward"),
            "max_abs_dscore": (scores - alone_scores).abs().max().item(),
            "scores": scores.tolist(), "scores_alone": alone_scores.tolist(),
            "rollout_rows": batched.shape[0],
            "rollout_bit_equal": torch.equal(batched, own),
            "rollout_max_abs_diff": (batched - own).abs().max().item(),
            "round_s": round_s, "alone_s": alone_s})
        check(states_equal and rows[-1]["rollout_bit_equal"],
              f"search parity ({rep}): the cohort round differs from "
              f"independent runs: {rows[-1]}")
        check(bool(((scores - alone_scores).abs()
                    <= TOL_SCORE * alone_scores.abs()).all()),
              f"search parity ({rep}): scores beyond {TOL_SCORE} relative: "
              f"{rows[-1]}")
    return rows


def _search_tournaments(launches: dict, tmp) -> dict:
    """``launch/train.py --search`` (``SEARCH_ARGV``) with a checkpoint
    dir, its resume from round 0 on a copy of the dir, and a q8 tournament
    (``SEARCH_Q8``) through ``run_search``, the launch counters zeroed
    just before each and read just after."""
    import contextlib
    import io
    import shutil

    import torch

    from repro_torch.core.netes import NetESConfig
    from repro_torch.launch import train as launch_train
    from repro_torch.search import SearchConfig, run_search

    def counted(fn):
        counters = _counters()
        for k in counters.values():
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return out, wall, {name: k.launches for name, k in counters.items()}

    def launch(ckpt):
        out = pathlib.Path(tmp) / f"{ckpt}.json"
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            launch_train.main([*SEARCH_ARGV, "--search-checkpoint-dir",
                               str(pathlib.Path(tmp) / ckpt), "--out",
                               str(out)])
        lines = text.getvalue().splitlines()
        check(any(ln.startswith("search winner: ") for ln in lines),
              f"search: no winner line in {lines}")
        return json.loads(out.read_text())

    rows = {}
    full, wall, counts = counted(lambda: launch("full"))
    search = full["search"]
    hist = search["history"]
    check([len(h["scores"]) for h in hist] == [4, 2],
          f"search tournament: rounds of {[len(h['scores']) for h in hist]}"
          " candidates, not [4, 2]")
    scores = [s for h in hist for s in h["scores"].values()]
    check(all(s > float("-inf") for s in scores),
          f"search tournament: a score is not finite: {hist}")
    eq3 = counts["netes_sparse_mixing"] + counts["netes_mixing"]
    # round 0: 4 candidates × 4; round 1: 2 × 8; training: 2
    check(counts["netes_sparse_mixing"] >= 2 * SEARCH_ITERS
          and counts["netes_mixing"] >= 2 * SEARCH_ITERS
          and eq3 == 8 * SEARCH_ITERS + 2, f"search tournament: launches "
          f"{counts}")
    rows["tournament"] = {"argv": " ".join(SEARCH_ARGV), "history": hist,
                          "winner": search["winner"], "score":
                          search["score"], "control_scores":
                          search["control_scores"], "pool": search["pool"],
                          "search_wall_s": search["wall_s"], "wall_s": wall,
                          "final_eval": full["history"]["final_eval"],
                          "launches": counts}

    # the resume: the copy's latest.json points at round 0's step file
    shutil.copytree(pathlib.Path(tmp) / "full", pathlib.Path(tmp) / "resume")
    ckpt = pathlib.Path(tmp) / "resume"
    (ckpt / "latest.json").write_text(
        (ckpt / "step_00000000.json").read_text())
    resumed, wall, counts_r = counted(lambda: launch("resume"))
    for k in ("history", "winner", "score", "control_scores"):
        check(resumed["search"][k] == search[k], f"search resume: {k} "
              f"{resumed['search'][k]} resumed, {search[k]} uninterrupted")
    check(counts_r["netes_sparse_mixing"] + counts_r["netes_mixing"]
          == 4 * SEARCH_ITERS + 2, f"search resume: launches {counts_r}")
    rows["tournament resumed"] = {"resumed_after_round": 0, "equal": True,
                                  "wall_s": wall, "launches": counts_r}

    sc = SearchConfig(n_agents=MAIN_N, netes=NetESConfig(alpha=0.05,
                                                         sigma=0.1),
                      **SEARCH_Q8)
    result, wall, counts_q = counted(
        lambda: run_search("pendulum", sc, device="cuda"))
    # round 0: 4 candidates × 2; round 1: 2 × 4
    for k in ("fused_neighbor_sum", "fused_broadcast_select"):
        check(counts_q[k] == 16, f"q8 tournament: {k} launched "
              f"{counts_q[k]} times, not 16")
    check(counts_q["netes_sparse_mixing"] == counts_q["netes_mixing"] == 0,
          f"q8 tournament: launches {counts_q}")
    rows["q8 tournament"] = {"config": {k: list(v) if isinstance(v, tuple)
                                        else v for k, v in SEARCH_Q8.items()},
                             "history": result.history,
                             "winner": result.winner.label(),
                             "score": result.score, "wall_s": wall,
                             "launches": counts_q}
    for run, row in rows.items():
        for k in EQ3_KERNELS:
            launches.setdefault(k, {})[run] = row["launches"][k]
    return rows


def _search_no_sync() -> list:
    """One cohort iteration of each cohort kind (static sparse, static
    dense, scheduled with a redraw, static sparse through q8) after a
    warm-up, under ``torch.cuda.set_sync_debug_mode("error")``."""
    import torch

    from repro_torch.core import topology_repr
    from repro_torch.envs import resolve_task
    from repro_torch.search import tournament

    reward_fn, dim, init_fn, _, _ = resolve_task("pendulum")
    cfg = _schedule_config("erdos_renyi", MAIN_P_ER, None, None).netes
    sparse = SEARCH_COHORTS[0][1]
    er = (("erdos_renyi", MAIN_P_ER),) * 2
    cases = (("static sparse", "sparse", sparse, None, None),
             ("static dense", "dense", SEARCH_COHORTS[1][1], None, None),
             ("scheduled, redrawing", "sparse", er, None,
              "resample_er(period=2)"),
             ("q8", "sparse", sparse, "quantize(bits=8)", None))
    checked = []
    for label, rep, graphs, channel, schedule in cases:
        plans = _search_cohort(rep, graphs, channel, schedule)
        plan = plans[0]
        states, _ = _search_states(plans, reward_fn, dim, init_fn)
        kw = dict(channel=plan.channel, schedule=plan.schedule)
        if plan.channel is not None:
            kw["cstates"] = [plan.channel.init(s.thetas) for s in states]
        topos = None
        if plan.schedule is None:
            topos = topology_repr.unstack(topology_repr.stack(
                [p.topo for p in plans]))
        else:   # at t = 1, so the advance to t = 2 redraws
            kw["sstates"] = [plan.schedule.advance(p.schedule.init(
                device="cuda")) for p in plans]
            check(plan.schedule.redraws(2), "no_sync search: no redraw")

        step = functools.partial(tournament._cohort_step, states, topos,
                                 reward_fn, cfg, **kw)
        step()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            step()
        except RuntimeError as err:
            raise RuntimeError(f"no_sync search {label}: the cohort step "
                               f"waits for the card: {err}") from err
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        checked.append(label)
    return checked


def _search_timing() -> dict:
    """One cohort iteration of the sparse cohort (S = 2) against 2
    sequential ``netes_step``s on the same candidates, states and
    topologies, ``SEARCH_PAIRS`` pairs in turns."""
    from repro_torch.core import netes, topology_repr
    from repro_torch.envs import resolve_task
    from repro_torch.search import tournament

    reward_fn, dim, init_fn, _, _ = resolve_task("pendulum")
    cfg = _schedule_config("erdos_renyi", MAIN_P_ER, None, None).netes
    plans = _search_cohort(*SEARCH_COHORTS[0])
    topos = topology_repr.unstack(topology_repr.stack(
        [p.topo for p in plans]))
    states, _ = _search_states(plans, reward_fn, dim, init_fn)

    def sequential():
        return [netes.netes_step(st, topo, reward_fn, cfg)
                for st, topo in zip(states, topos)]

    def cohort():
        return tournament._cohort_step(states, topos, reward_fn, cfg)

    return _paired_step_times(sequential, cohort, pairs=SEARCH_PAIRS,
                              names=("sequential", "cohort"))


def search_phase(launches: dict) -> None:
    """The topology search at N = 1000 on pendulum: cohort parity, two
    tournaments (one through the launcher, resumed from round 0), one
    cohort iteration of each kind under the sync check, and the time of a
    cohort iteration against sequential steps."""
    import tempfile

    smi = nvidia_smi()
    for row in _search_parity():
        emit({"phase": "search_parity", **row, "nvidia_smi": smi})
    with tempfile.TemporaryDirectory() as tmp:
        for run, row in _search_tournaments(launches, tmp).items():
            emit({"phase": "search", "run": run, **row, "nvidia_smi": smi})
    emit({"phase": "no_sync", "search_cohort_steps": _search_no_sync(),
          "n_agents": MAIN_N, "sync_debug_mode": "error",
          "step_synced": False})
    emit({"phase": "search_timing", "cohort": "sparse",
          "graphs": [list(g) for g in SEARCH_COHORTS[0][1]],
          "n_agents": MAIN_N, **_search_timing(), "nvidia_smi": smi})


# ---------------------------------------------------------------------------
# phase 6: GPU against CPU on a small input
# ---------------------------------------------------------------------------

def parity_phase() -> None:
    import torch

    from repro_torch.comm import channel as chan
    from repro_torch.core import netes
    from repro_torch.core.netes import Draws, NetESConfig
    from repro_torch.core.topology import TopologySpec
    from repro_torch.core.topology_repr import from_spec
    from repro_torch.envs import resolve_task

    n, cfg = 64, NetESConfig(alpha=0.05, sigma=0.1)
    reward_fn, dim, init_fn, _, _ = resolve_task("pendulum")
    cpu = netes.init_state(n, dim, seed=3, init_fn=init_fn, device="cpu")
    g = torch.Generator().manual_seed(4)
    draws = Draws(eps=torch.randn(n, dim, generator=g),
                  beta=torch.tensor(0.9),    # ≥ p_b: no broadcast, so θ' is Eq. 3's
                  evals=reward_fn.draw(g, n))
    for dens in (0.1, 0.5):
        spec = TopologySpec(family="erdos_renyi", n_agents=n, p=dens, seed=0)
        outs = {}
        for dev in ("cpu", "cuda"):
            state = netes.NetESState(
                thetas=cpu.thetas.to(dev), generator=None,
                step=cpu.step.to(dev), best_reward=cpu.best_reward.to(dev),
                best_theta=cpu.best_theta.to(dev))
            d = Draws(eps=draws.eps.to(dev), beta=draws.beta.to(dev),
                      evals=draws.evals.to(dev))
            topo = from_spec(spec, device=dev)
            new, _, m = netes.netes_step(state, topo, reward_fn, cfg,
                                         draws=d)
            outs[dev] = (topo.kind, new.thetas.cpu(), m["best_idx"].item(),
                         m["reward_max"].item())
        kind, th_cpu, bi_cpu, rmax_cpu = outs["cpu"]
        _, th_gpu, bi_gpu, rmax_gpu = outs["cuda"]
        # Rollouts on two devices round sin/cos differently (≈1e-6 relative
        # on returns, as between the JAX reference and float64), which
        # leaves the centered ranks unchanged unless two returns nearly tie;
        # the mixing sums then differ only in f32 summation order (≈1e-7 of
        # |θ|), so 1e-5·max(1, max|θ|) leaves a 100× margin.
        err = (th_gpu - th_cpu).abs().max().item()
        check(bi_cpu == bi_gpu, f"parity {kind}: best agent {bi_gpu} on the "
              f"GPU vs {bi_cpu} on the CPU")
        check(err <= 1e-5 * max(1.0, th_cpu.abs().max().item()),
              f"parity {kind}: θ differs by {err} (a near-tie of two "
              f"returns reorders the centered ranks; compare the rewards)")
        emit({"phase": "parity", "representation": kind, "n": n, "dim": dim,
              "max_abs_theta_err": err, "tol": "1e-5·max(1, max|θ|)",
              "reward_max_cpu": rmax_cpu, "reward_max_gpu": rmax_gpu})

    # through a lossy channel: each device draws its own dropout mask from
    # the same seed; the masks must be equal, θ′ as above
    for dens, text in ((0.1, "quantize(bits=8)|dropout(p=0.1,seed=0)"),
                       (0.5, "event_triggered(threshold=0.01)|"
                             "quantize(bits=4)|dropout(p=0.1,seed=0)")):
        spec = TopologySpec(family="erdos_renyi", n_agents=n, p=dens, seed=0)
        ch = chan.compile_channel(text, n)
        outs = {}
        for dev in ("cpu", "cuda"):
            state = netes.NetESState(
                thetas=cpu.thetas.to(dev), generator=None,
                step=cpu.step.to(dev), best_reward=cpu.best_reward.to(dev),
                best_theta=cpu.best_theta.to(dev))
            d = Draws(eps=draws.eps.to(dev), beta=draws.beta.to(dev),
                      evals=draws.evals.to(dev))
            topo = from_spec(spec, device=dev, channel=ch)
            cstate = ch.init(state.thetas)
            mask = chan.dropout_mask(
                chan.step_key(cstate.seed, cstate.draws), topo,
                ch.dropout_stage.p)
            new, cstate, m = netes.netes_step(state, topo, reward_fn, cfg,
                                              draws=d, channel=ch,
                                              chan_state=cstate)
            outs[dev] = (topo.kind, new.thetas.cpu(), m["best_idx"].item(),
                         mask.cpu(), m["msgs"].item(), cstate.msgs.item())
        kind, th_cpu, bi_cpu, mask_cpu, msgs_cpu, tot_cpu = outs["cpu"]
        _, th_gpu, bi_gpu, mask_gpu, msgs_gpu, tot_gpu = outs["cuda"]
        check(torch.equal(mask_cpu, mask_gpu),
              f"parity {text}: the dropout masks differ between CPU and GPU")
        check(msgs_cpu == msgs_gpu and tot_cpu == tot_gpu,
              f"parity {text}: messages {msgs_gpu} on the GPU vs {msgs_cpu}")
        check(bi_cpu == bi_gpu, f"parity {text}: best agent {bi_gpu} on the "
              f"GPU vs {bi_cpu} on the CPU")
        err = (th_gpu - th_cpu).abs().max().item()
        check(err <= 1e-5 * max(1.0, th_cpu.abs().max().item()),
              f"parity {text}: θ differs by {err}")
        emit({"phase": "parity", "representation": kind, "channel": text,
              "wire_fused": ch.wire_fused(topo), "n": n, "dim": dim,
              "masks_equal": True, "mask_shape": list(mask_cpu.shape),
              "links_kept": float(mask_cpu.mean()), "msgs": msgs_gpu,
              "max_abs_theta_err": err, "tol": "1e-5·max(1, max|θ|)"})


# ---------------------------------------------------------------------------
# phases 7–9: LM serving of mistral-nemo-12b
# ---------------------------------------------------------------------------

ARCH = "mistral-nemo-12b"
SERVE_RUNS = (("a", 1, 8192), ("b", 8, 512))   # (run, batch, prompt tokens)
NEW_TOKENS = 16
PARITY_LAYERS, PARITY_BATCH, PARITY_PROMPT, PARITY_NEW = 2, 2, 256, 8
# Serve parity: |kernel path − float64 forward| ≤ TOL_LOGITS · max(1,
# max|logit|) over every logit of the prefill and of each decode step. In
# float32 the full-width products (5120- and 14336-term sums) leave ≈ 1e-6
# of the logit scale; bf16 attention leaves ≈ 1e-3 to 1e-2 of it. 1e-4 sits
# between the two, and the phase checks that bf16 attention fails it.
TOL_LOGITS = 1e-4
# GPU against CPU at the smoke size: both in float32, summed in other
# orders; the CPU tests' 2e-5 (rtol and atol) against the JAX reference.
TOL_SMOKE = 2e-5


def _cast(tree, **kw):
    """The parameter tree with every tensor passed through ``.to(**kw)``."""
    from repro_torch.core.tree import tree_map
    return tree_map(lambda t: t.to(**kw), tree)


def _greedy(params, cfg, prompts, new_tokens, timed=False, extra=None):
    """What ``ServeEngine.generate`` does, greedy, keeping the logits: the
    prefill (given the frontends' inputs ``extra``, e.g. whisper's frames),
    then ``new_tokens − 1`` decode steps. With ``timed``, CUDA events
    around the prefill and around each decode step. Returns (tokens (B,
    new_tokens), [logits (B, V)] * new_tokens, times in ms)."""
    import torch

    from repro_torch.models import transformer
    b, s = prompts.shape
    dev = prompts.device
    extra = extra or {}
    cache = transformer.init_cache(cfg, b, s + new_tokens, torch.float32,
                                   dev)
    events = []

    def mark():
        if timed:
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()

    with torch.no_grad():
        mark()
        last, cache = transformer.prefill(params, cfg,
                                          {"tokens": prompts, **extra}, cache)
        mark()
        logits = [last]
        token = torch.argmax(last, dim=-1, keepdim=True)
        tokens = [token]
        for i in range(1, new_tokens):
            pos = torch.full((b,), s + i - 1, dtype=torch.long, device=dev)
            lg, cache = transformer.decode_step(params, cfg, token, cache,
                                                pos)
            mark()
            logits.append(lg[:, 0])
            token = torch.argmax(lg[:, 0], dim=-1, keepdim=True)
            tokens.append(token)
    if timed:
        torch.cuda.synchronize()
    times = [a.elapsed_time(z) for a, z in zip(events, events[1:])]
    return torch.cat(tokens, dim=1), logits, times


def _forward_bf16_attention(params, cfg, tokens):
    """``transformer.forward`` with each layer's attention computed in bf16
    (scaled_dot_product_attention on bf16 q, k, v): the computation the
    serve-parity tolerance must reject."""
    import torch
    import torch.nn.functional as F

    from repro_torch.models import attention, layers, transformer
    x = params["embed"][tokens]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    for p, ls in zip(params["layers"], cfg.layer_specs()):
        spec = transformer.attn_spec(cfg, ls)
        h = layers.rmsnorm(p["norm1"], x)
        q, k, v = attention._qkv(p["attn"], spec, h, positions)
        g = spec.num_heads // spec.num_kv_heads
        q, k, v = (t.transpose(1, 2).bfloat16() for t in (
            q, k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)))
        o = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                           scale=spec.scale)
        x = x + torch.einsum("bshk,hkd->bsd", o.transpose(1, 2).float(),
                             p["attn"]["wo"])
        x = x + layers.swiglu(p["ffn"], layers.rmsnorm(p["norm2"], x))
    x = layers.rmsnorm(params["final_norm"], x)
    return transformer.unembed(params, cfg, x)


def no_sync_prefill(arch: str, params, cfg, prompts, extra=None) -> None:
    """One ``transformer.prefill`` (given the frontends' inputs ``extra``)
    under ``torch.cuda.set_sync_debug_mode("error")``: a call in it that
    waits for the card (a copy to the host, ``.item()``, ``nonzero``)
    raises."""
    import torch

    from repro_torch.models import transformer
    cache = transformer.init_cache(cfg, prompts.shape[0], prompts.shape[1],
                                   torch.float32, "cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            transformer.prefill(params, cfg,
                                {"tokens": prompts, **(extra or {})}, cache)
    except RuntimeError as err:
        raise RuntimeError(f"no_sync {arch}: prefill waits for the card: "
                           f"{err}") from err
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    emit({"phase": "no_sync", "arch": arch, "num_layers": cfg.num_layers,
          "batch": prompts.shape[0], "prompt": prompts.shape[1],
          "sync_debug_mode": "error", "prefill_synced": False})


def serve_parity_phase() -> None:
    """Full width, 2 layers: the kernel path's prefill and decode logits
    against the port's plain full ``forward`` in float64 on the card over
    the prompt plus the tokens fed back."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer
    from repro_torch.serve import ServeEngine

    cfg = dataclasses.replace(get_config(ARCH), num_layers=PARITY_LAYERS)
    params = transformer.init_params(cfg, seed=0, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (PARITY_BATCH, PARITY_PROMPT),
                            generator=g, device="cuda")
    fa.KERNEL.launches = 0
    tokens, logits, _ = _greedy(params, cfg, prompts, PARITY_NEW)
    check(fa.KERNEL.launches == PARITY_LAYERS, "serve parity: flash "
          f"attention launched {fa.KERNEL.launches} times in one prefill")
    no_sync_prefill(ARCH, params, cfg, prompts)
    engine = ServeEngine(cfg, params, max_len=PARITY_PROMPT + PARITY_NEW)
    check(np.array_equal(engine.generate(prompts, new_tokens=PARITY_NEW),
                         tokens.cpu().numpy()),
          "serve parity: ServeEngine.generate differs from its own steps")
    fed = torch.cat([prompts, tokens[:, :-1]], dim=1)
    with torch.no_grad():
        ref64 = transformer.forward(_cast(params, dtype=torch.float64), cfg,
                                    {"tokens": fed})[:, PARITY_PROMPT - 1:]
        plain32 = transformer.forward(params, cfg, {"tokens": fed})[
            :, PARITY_PROMPT - 1:]
        bf16 = _forward_bf16_attention(params, cfg, fed)[:, PARITY_PROMPT - 1:]
    got = torch.stack(logits, dim=1).double()
    scale = max(1.0, ref64.abs().max().item())
    tol = TOL_LOGITS * scale
    err = (got - ref64).abs().max().item()
    err_plain = (plain32.double() - ref64).abs().max().item()
    err_bf16 = (bf16.double() - ref64).abs().max().item()
    check(torch.isfinite(got).all().item(), "serve parity: non-finite logits")
    check(err <= tol, f"serve parity: logits differ from float64 by {err} "
          f"(tolerance {tol})")
    check(err_bf16 > tol, f"serve parity: bf16 attention ({err_bf16}) passes "
          f"the tolerance {tol}: tighten it")
    emit({"phase": "serve_parity", "arch": ARCH, "num_layers": PARITY_LAYERS,
          "d_model": cfg.d_model, "batch": PARITY_BATCH,
          "prompt": PARITY_PROMPT, "new_tokens": PARITY_NEW,
          "max_abs_logit": scale, "max_abs_err": err,
          "plain_forward_f32_err": err_plain, "bf16_attention_err": err_bf16,
          "tol": tol, "tol_rel": TOL_LOGITS, "generate_equal": True,
          "flash_launches": PARITY_LAYERS})
    del params, logits, ref64, plain32, bf16, got, engine
    torch.cuda.empty_cache()


def _layer_counts(cfg):
    """(attention, MoE, rwkv, mamba) layers of ``cfg``: the flash kernel
    runs once per attention layer in a prefill, the router, the WKV kernel
    and the mamba scan once per layer of theirs in the prefill and in each
    decode step."""
    specs = cfg.layer_specs()
    return (sum(ls.mixer.startswith("attn") for ls in specs),
            sum(ls.ffn == "moe" for ls in specs),
            sum(ls.mixer == "rwkv" for ls in specs),
            sum(ls.mixer == "mamba" for ls in specs))


def _flash_masks(cfg) -> dict:
    """The flash calls of one prefill (or one ``loss_fn``) by mask:
    ``windowed`` (sliding or chunked layers) and ``global`` (full
    attention layers, and an encoder-decoder's encoder layers and its
    decoder's cross attention blocks)."""
    specs = cfg.layer_specs()
    n_global = sum(ls.mixer == "attn_full" for ls in specs)
    if cfg.is_encoder_decoder:
        n_global += cfg.encoder_layers + cfg.num_layers
    return {"global": n_global,
            "windowed": sum(ls.mixer in ("attn_sliding", "attn_chunked")
                            for ls in specs)}


def _frontend_inputs(cfg, b: int, device: str, seed: int = 3) -> dict:
    """The frontends' stub inputs of ``b`` rows on ``device``: whisper's
    ``frames``, llava's ``patch_embeds`` (none for a text model)."""
    import torch

    from repro_torch.models import frontends
    gen = torch.Generator(device=device).manual_seed(seed)
    if cfg.frontend == "audio":
        return {"frames": frontends.audio_frames(cfg, b, gen)}
    if cfg.frontend == "vision":
        return {"patch_embeds": frontends.vision_patches(cfg, b, gen)}
    return {}


def _served(extra: dict) -> dict:
    """``extra`` as ``ServeEngine.generate`` passes it to the prefill:
    without ``patch_embeds``, which its serving drops, as the
    reference's."""
    return {k: v for k, v in extra.items() if k != "patch_embeds"}


def serve_cpu_parity_phase(arch: str, prompt: int = 24) -> int:
    """``arch``'s smoke model's greedy serving on the GPU and on the CPU
    from the same weights and frontend inputs: tokens equal, logits within
    TOL_SMOKE. Returns the flash launches of the GPU's run."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import moe_router as mr
    from repro_torch.kernels import rwkv6_wkv as rw
    from repro_torch.models import transformer

    cfg = get_config(arch + "-smoke")
    n_attn, n_moe, n_rwkv, n_mamba = _layer_counts(cfg)
    n_flash = sum(_flash_masks(cfg).values())
    cpu = transformer.init_params(cfg, seed=0, device="cpu")
    prompts = torch.randint(0, cfg.vocab_size, (2, prompt),
                            generator=torch.Generator().manual_seed(2))
    extra = _served(_frontend_inputs(cfg, 2, "cpu"))
    tok_c, lg_c, _ = _greedy(cpu, cfg, prompts, 8, extra=extra)
    fa.KERNEL.launches = mr.KERNEL.launches = rw.KERNEL.launches = 0
    ms.KERNEL.launches = 0
    tok_g, lg_g, _ = _greedy(_cast(cpu, device="cuda"), cfg, prompts.cuda(),
                             8, extra=_cast(extra, device="cuda"))
    check(fa.KERNEL.launches == n_flash,
          f"smoke parity: {fa.KERNEL.launches} flash launches")
    check(mr.KERNEL.launches == 8 * n_moe,
          f"smoke parity: {mr.KERNEL.launches} moe_topk launches")
    check(rw.KERNEL.launches == 8 * n_rwkv,
          f"smoke parity: {rw.KERNEL.launches} rwkv6_wkv launches")
    check(ms.KERNEL.launches == 8 * n_mamba,
          f"smoke parity: {ms.KERNEL.launches} mamba_scan launches")
    check(torch.equal(tok_c, tok_g.cpu()), "smoke parity: greedy tokens "
          f"differ between GPU {tok_g.tolist()} and CPU {tok_c.tolist()}")
    got, want = torch.stack(lg_g, 1).cpu(), torch.stack(lg_c, 1)
    excess = ((got - want).abs() - TOL_SMOKE - TOL_SMOKE * want.abs()).max()
    check(excess.item() <= 0, "smoke parity: logits differ by more than "
          f"{TOL_SMOKE} (rtol and atol)")
    emit({"phase": "serve_cpu_parity", "arch": cfg.name, "batch": 2,
          "prompt": prompt, "new_tokens": 8, "head_dim": cfg.head_dim,
          "num_heads": cfg.num_heads, "frontend_inputs": sorted(extra),
          "tokens_equal": True, "moe_layers": n_moe, "rwkv_layers": n_rwkv,
          "mamba_layers": n_mamba,
          "max_abs_err": (got - want).abs().max().item(),
          "tol": TOL_SMOKE, "flash_launches": n_flash})
    return n_flash


# ---------------------------------------------------------------------------
# phases 10–12: MoE serving of moonshot-v1-16b-a3b
# ---------------------------------------------------------------------------

MOE_ARCH = "moonshot-v1-16b-a3b"
# 1 dense + 23 MoE layers, 53.9 GB of float32 weights: the whole 48 layers
# (108.7 GB) do not fit in 80 GB
MOE_SERVE_LAYERS = 24
MOE_PARITY_PROMPT = 512   # one group of 512 per row: capacity 60, drops
# A routing decision may differ between the float32 kernel path and the
# float64 forward only where float64's probabilities nearly tie: float32
# probabilities carry ≈ 1e-7 of rounding (the 2048-term router products,
# the softmax); a margin of 1e-5 is 100 times that.
MOE_FLIP_MARGIN = 1e-5


@contextlib.contextmanager
def _recording_moe_inputs(seen: list):
    """Appends the input of every ``moe.moe_block`` call to ``seen``."""
    from repro_torch.models import moe
    block = moe.moe_block

    def recording(params, spec, x, **kw):
        seen.append(x.detach())
        return block(params, spec, x, **kw)

    moe.moe_block = recording
    try:
        yield
    finally:
        moe.moe_block = block


def _prefill_all_logits(params, cfg, prompts):
    """``transformer.prefill``'s layers, the kernel path, with the logits
    of every position (prefill keeps the last one only)."""
    import torch

    from repro_torch.models import transformer
    b, s = prompts.shape
    cache = transformer.init_cache(cfg, b, s, torch.float32, prompts.device)
    with torch.no_grad():
        x, positions, _ = transformer.embed_inputs(
            params, cfg, {"tokens": prompts}, kernel=True)
        for i, (p, ls) in enumerate(zip(params["layers"], cfg.layer_specs())):
            x, cache["layers"][i] = transformer._prefill_layer(
                p, cfg, ls, x, cache["layers"][i], positions)
        x = transformer._norm(cfg, params["final_norm"], x)
        return transformer.unembed(params, cfg, x)


def _routing(router, h, spec, group: int, kernel: bool):
    """Routing of the MoE inputs h (B, S, D) in groups of ``group``: ids
    (T, k) from the kernel (float32) or the plain version (float64), the
    (T, E) masks of chosen and of kept experts, and each token's smallest
    gap between neighbours among its k + 1 largest probabilities."""
    import torch

    from repro_torch.kernels import moe_router as mr
    from repro_torch.kernels import ref
    from repro_torch.models import moe
    d = h.shape[-1]
    e, k = spec.num_experts, spec.experts_per_token
    logits = moe._router_logits({"router": router}, h.reshape(-1, d))
    _, ids = (mr.moe_topk if kernel else ref.moe_topk_ref)(logits, k)
    ids = ids.long()
    t = ids.shape[0]
    cap = moe.group_capacity(spec, group)
    _, dst = moe._dispatch_indices(ids.reshape(t // group, group, k), k, e,
                                   cap)
    chosen = torch.zeros(t, e, dtype=torch.bool, device=h.device)
    chosen.scatter_(1, ids, True)
    kept = torch.zeros_like(chosen).scatter_(1, ids,
                                             (dst < e * cap).reshape(t, k))
    p = torch.sort(torch.softmax(logits.double(), dim=-1), dim=-1,
                   descending=True).values[:, :k + 1]
    margin = (p[:, :-1] - p[:, 1:]).min(dim=1).values
    return ids, chosen, kept, margin


def _compare_routing(label, router32, router64, h32, h64, spec, group):
    """Counts the (token, choice) decisions that differ between the kernel
    path and float64; checks that each lies at a float64 margin below
    MOE_FLIP_MARGIN and that a token whose kept experts alone differ
    shares its group with such a flip. Returns (T,) bool, the tokens
    whose routing agrees, and a summary."""
    ids32, ch32, kept32, _ = _routing(router32, h32, spec, group, True)
    ids64, ch64, kept64, margin = _routing(router64, h64, spec, group, False)
    flip = (ids32 != ids64).any(dim=1)
    bad = flip & (margin >= MOE_FLIP_MARGIN)
    check(not bool(bad.any()), f"moe parity ({label}): routing differs from "
          f"float64 on {int(bad.sum())} tokens at a float64 margin ≥ "
          f"{MOE_FLIP_MARGIN}")
    set_differs = (ch32 != ch64).any(dim=1)
    kept_differs = (kept32 != kept64).any(dim=1)
    group_flip = set_differs.reshape(-1, group).any(dim=1, keepdim=True)
    stray = kept_differs & ~group_flip.expand(-1, group).reshape(-1)
    check(not bool(stray.any()), f"moe parity ({label}): {int(stray.sum())} "
          "tokens lose or gain a slot in a group without a routing flip")
    agree = ~(set_differs | kept_differs)
    summary = {"tokens": int(flip.numel()),
               "choices_differ": int((ids32 != ids64).sum()),
               "tokens_routed_apart": int((~agree).sum()),
               "min_margin_f64": margin.min().item(),
               "choices_dropped_f32": int((ch32 & ~kept32).sum())}
    return agree, summary


def moe_parity_phase() -> None:
    """moonshot at full width and 2 layers (dense, then MoE): the kernel
    path's logits of every prompt position and of each decode step against
    the float64 ``forward``, on the tokens whose routing agrees."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_router as mr
    from repro_torch.models import moe, transformer
    from repro_torch.serve import ServeEngine

    cfg = dataclasses.replace(get_config(MOE_ARCH), num_layers=PARITY_LAYERS)
    spec = transformer.moe_spec(cfg)
    check([ls.ffn for ls in cfg.layer_specs()] == ["swiglu", "moe"],
          "moe parity: the 2 layers are not dense then MoE")
    params = transformer.init_params(cfg, seed=0, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size,
                            (PARITY_BATCH, MOE_PARITY_PROMPT), generator=g,
                            device="cuda")
    seen32 = []
    with _recording_moe_inputs(seen32):
        fa.KERNEL.launches = mr.KERNEL.launches = 0
        tokens, logits, _ = _greedy(params, cfg, prompts, PARITY_NEW)
        check(fa.KERNEL.launches == PARITY_LAYERS
              and mr.KERNEL.launches == PARITY_NEW,
              f"moe parity: {fa.KERNEL.launches} flash and "
              f"{mr.KERNEL.launches} moe_topk launches in one generate")
        all32 = _prefill_all_logits(params, cfg, prompts)
    engine = ServeEngine(cfg, params, max_len=MOE_PARITY_PROMPT + PARITY_NEW)
    check(np.array_equal(engine.generate(prompts, new_tokens=PARITY_NEW),
                         tokens.cpu().numpy()),
          "moe parity: ServeEngine.generate differs from its own steps")
    del engine
    p64 = _cast(params, dtype=torch.float64)
    seen64 = []
    fed = torch.cat([prompts, tokens[:, :-1]], dim=1)
    with _recording_moe_inputs(seen64), torch.no_grad():
        pre64 = transformer.forward(p64, cfg, {"tokens": prompts})
        # decode routes each token in a group of its own: the forward in
        # groups of one token is its float64 reference (MoE is the last
        # layer, so the prompt's routing reaches no decode position)
        dec64 = transformer.forward(
            p64, dataclasses.replace(cfg, moe_group_size=1),
            {"tokens": fed})[:, MOE_PARITY_PROMPT:]
    router32 = params["layers"][1]["moe"]["router"]
    router64 = p64["layers"][1]["moe"]["router"]
    agree_pre, sum_pre = _compare_routing(
        "prefill", router32, router64, seen32[0], seen64[0], spec,
        MOE_PARITY_PROMPT)
    agree_dec, sum_dec = _compare_routing(
        "decode", router32, router64, torch.cat(seen32[1:PARITY_NEW], dim=1),
        seen64[1][:, MOE_PARITY_PROMPT:], spec, 1)
    check(sum_pre["choices_dropped_f32"] > 0, "moe parity: no choice dropped "
          "at capacity 60; the phase must exercise drops")
    scale = max(1.0, pre64.abs().max().item(), dec64.abs().max().item())
    tol = TOL_LOGITS * scale
    b = PARITY_BATCH
    err_pre = (all32.double() - pre64).abs().amax(dim=-1).reshape(-1)
    err_dec = (torch.stack(logits[1:], dim=1).double() - dec64).abs().amax(
        dim=-1).reshape(-1)
    err_last = (logits[0].double() - pre64[:, -1]).abs().amax(dim=-1)
    last_agree = agree_pre.reshape(b, -1)[:, -1]
    worst = max(err_pre[agree_pre].max().item(),
                err_dec[agree_dec].max().item(),
                err_last[last_agree].max().item() if last_agree.any() else 0)
    check(bool(torch.isfinite(all32).all()), "moe parity: non-finite logits")
    check(worst <= tol, f"moe parity: logits differ from float64 by {worst} "
          f"on tokens whose routing agrees (tolerance {tol})")
    emit({"phase": "moe_parity", "arch": MOE_ARCH,
          "num_layers": PARITY_LAYERS, "d_model": cfg.d_model,
          "experts": spec.num_experts, "top_k": spec.experts_per_token,
          "batch": b, "prompt": MOE_PARITY_PROMPT, "new_tokens": PARITY_NEW,
          "capacity": moe.group_capacity(spec, MOE_PARITY_PROMPT),
          "max_abs_logit": scale, "max_abs_err": worst,
          "tol": tol, "tol_rel": TOL_LOGITS,
          "flip_margin": MOE_FLIP_MARGIN, "prefill_routing": sum_pre,
          "decode_routing": sum_dec, "generate_equal": True,
          "launches": {"flash_attention": PARITY_LAYERS,
                       "moe_topk": PARITY_NEW}})
    del params, p64, logits, all32, pre64, dec64, seen32, seen64
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 13–15: serving of rwkv6-7b
# ---------------------------------------------------------------------------

RWKV_ARCH = "rwkv6-7b"
RWKV_PARITY_PROMPT = 512     # four chunks of the forward's chunked form


def rwkv_parity_phase() -> None:
    """rwkv6-7b at full width and 2 layers: the kernel path's prefill and
    decode logits against the float64 ``forward`` on the card over the
    prompt plus the tokens fed back (the forward runs the chunked form on
    the prompt's length, the sequential loop past it), and one prefill
    with no sync."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import rwkv6_wkv as rw
    from repro_torch.models import transformer
    from repro_torch.serve import ServeEngine

    cfg = dataclasses.replace(get_config(RWKV_ARCH), num_layers=PARITY_LAYERS)
    params = transformer.init_params(cfg, seed=0, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size,
                            (PARITY_BATCH, RWKV_PARITY_PROMPT), generator=g,
                            device="cuda")
    rw.KERNEL.launches = 0
    tokens, logits, _ = _greedy(params, cfg, prompts, PARITY_NEW)
    check(rw.KERNEL.launches == PARITY_LAYERS * PARITY_NEW,
          f"rwkv parity: rwkv6_wkv launched {rw.KERNEL.launches} times in "
          f"one generate of {PARITY_NEW} tokens")
    engine = ServeEngine(cfg, params,
                         max_len=RWKV_PARITY_PROMPT + PARITY_NEW)
    check(np.array_equal(engine.generate(prompts, new_tokens=PARITY_NEW),
                         tokens.cpu().numpy()),
          "rwkv parity: ServeEngine.generate differs from its own steps")
    del engine
    no_sync_prefill(RWKV_ARCH, params, cfg, prompts)
    fed = torch.cat([prompts, tokens[:, :-1]], dim=1)
    with torch.no_grad():
        p64 = _cast(params, dtype=torch.float64)
        # the prompt alone (the chunked form), then the whole fed sequence
        pre64 = transformer.forward(p64, cfg, {"tokens": prompts})[:, -1]
        ref64 = transformer.forward(p64, cfg, {"tokens": fed})[
            :, RWKV_PARITY_PROMPT - 1:]
        del p64
        plain32 = transformer.forward(params, cfg, {"tokens": fed})[
            :, RWKV_PARITY_PROMPT - 1:]
    got = torch.stack(logits, dim=1).double()
    scale = max(1.0, ref64.abs().max().item())
    tol = TOL_LOGITS * scale
    err = (got - ref64).abs().max().item()
    err_prefill = (got[:, 0] - pre64).abs().max().item()
    err_plain = (plain32.double() - ref64).abs().max().item()
    check(bool(torch.isfinite(got).all()), "rwkv parity: non-finite logits")
    check(err <= tol and err_prefill <= tol, f"rwkv parity: logits differ "
          f"from float64 by {err} / {err_prefill} (tolerance {tol})")
    emit({"phase": "rwkv_parity", "arch": RWKV_ARCH,
          "num_layers": PARITY_LAYERS, "d_model": cfg.d_model,
          "heads": cfg.num_heads, "head_dim": cfg.head_dim,
          "batch": PARITY_BATCH, "prompt": RWKV_PARITY_PROMPT,
          "new_tokens": PARITY_NEW, "max_abs_logit": scale,
          "max_abs_err": err, "prefill_vs_chunked_f64_err": err_prefill,
          "plain_forward_f32_err": err_plain, "tol": tol,
          "tol_rel": TOL_LOGITS, "generate_equal": True,
          "rwkv6_wkv_launches": PARITY_LAYERS * PARITY_NEW})
    del params, logits, ref64, pre64, plain32, got
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 16–18: hybrid serving of jamba-v0.1-52b
# ---------------------------------------------------------------------------

JAMBA_ARCH = "jamba-v0.1-52b"
# one 8-layer period (7 mamba layers, 4 of them with an MoE channel mixer,
# and the sliding-attention layer), 52.1 GB of float32 weights: all 32
# layers (205.2 GB) do not fit in 80 GB
JAMBA_SERVE_LAYERS = 8
JAMBA_PARITY_PROMPT = 512   # one MoE group of 512 per row (capacity 80)
JAMBA_SMOKE_PROMPT = 128    # two of the smoke's groups, twice its window


@contextlib.contextmanager
def _moe_groups_as_served(prompt: int):
    """``moe.moe_block`` routes the first ``prompt`` positions in the
    config's groups, as prefill does, and each later position in a group
    of its own, as decode does: a full forward over a prompt and the
    tokens fed back then computes what serving computes."""
    import dataclasses

    import torch

    from repro_torch.models import moe
    block = moe.moe_block

    def as_served(params, spec, x, **kw):
        out = block(params, spec, x[:, :prompt], **kw)
        if x.shape[1] == prompt:
            return out
        tail = block(params, dataclasses.replace(spec, group_size=1),
                     x[:, prompt:], **kw)
        return torch.cat([out, tail], dim=1)

    moe.moe_block = as_served
    try:
        yield
    finally:
        moe.moe_block = block


def _first_routing_difference(agree_by_layer, b: int):
    """(B,) the first position of each row whose routing differs from
    float64 in any MoE layer (the row's length where none does)."""
    import torch
    agree = torch.stack([a.reshape(b, -1) for a in agree_by_layer]).all(0)
    return torch.where(agree.all(dim=1), agree.shape[1],
                       (~agree).int().argmax(dim=1))


def jamba_parity_phase() -> None:
    """jamba at full width and 2 layers (mamba + MoE, then sliding
    attention + SwiGLU): the kernel path's logits of every prompt position
    and of each decode step against the float64 ``forward`` with the MoE
    grouped as served, on each row up to its first routing difference
    (layer 0 routes, so a flip moves every later position of its row
    through layer 1's attention and the capacity of its group); and one
    prefill with no sync."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import moe_router as mr
    from repro_torch.models import moe, transformer
    from repro_torch.serve import ServeEngine

    cfg = dataclasses.replace(get_config(JAMBA_ARCH),
                              num_layers=PARITY_LAYERS, attn_every=2)
    spec = transformer.moe_spec(cfg)
    check([(ls.mixer, ls.ffn) for ls in cfg.layer_specs()]
          == [("mamba", "moe"), ("attn_sliding", "swiglu")],
          "jamba parity: the 2 layers are not mamba + MoE, then sliding "
          "attention + SwiGLU")
    params = transformer.init_params(cfg, seed=0, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    p_len, b = JAMBA_PARITY_PROMPT, PARITY_BATCH
    prompts = torch.randint(0, cfg.vocab_size, (b, p_len), generator=g,
                            device="cuda")
    seen32 = []
    with _recording_moe_inputs(seen32):
        fa.KERNEL.launches = mr.KERNEL.launches = ms.KERNEL.launches = 0
        tokens, logits, _ = _greedy(params, cfg, prompts, PARITY_NEW)
        launched = (fa.KERNEL.launches, mr.KERNEL.launches,
                    ms.KERNEL.launches)
        check(launched == (1, PARITY_NEW, PARITY_NEW), "jamba parity: "
              f"{launched} flash, moe_topk and mamba_scan launches in one "
              f"generate of {PARITY_NEW} tokens")
        all32 = _prefill_all_logits(params, cfg, prompts)
    engine = ServeEngine(cfg, params, max_len=p_len + PARITY_NEW)
    check(np.array_equal(engine.generate(prompts, new_tokens=PARITY_NEW),
                         tokens.cpu().numpy()),
          "jamba parity: ServeEngine.generate differs from its own steps")
    del engine
    no_sync_prefill(JAMBA_ARCH, params, cfg, prompts)
    fed = torch.cat([prompts, tokens[:, :-1]], dim=1)
    seen64 = []
    with torch.no_grad(), _recording_moe_inputs(seen64), \
            _moe_groups_as_served(p_len):
        p64 = _cast(params, dtype=torch.float64)
        ref64 = transformer.forward(p64, cfg, {"tokens": fed})
        router64 = p64["layers"][0]["moe"]["router"]
        del p64
        plain32 = transformer.forward(params, cfg, {"tokens": fed})
    router32 = params["layers"][0]["moe"]["router"]
    agree_pre, sum_pre = _compare_routing(
        "jamba prefill", router32, router64, seen32[0], seen64[0], spec,
        p_len)
    agree_dec, sum_dec = _compare_routing(
        "jamba decode", router32, router64,
        torch.cat(seen32[1:PARITY_NEW], dim=1), seen64[1], spec, 1)
    # positions of each row before its first routing difference
    agree = torch.cat([agree_pre.reshape(b, -1), agree_dec.reshape(b, -1)],
                      dim=1)
    first = _first_routing_difference([agree], b)
    live = torch.arange(agree.shape[1], device="cuda")[None] < first[:, None]
    got = torch.cat([all32, torch.stack(logits[1:], dim=1)], dim=1).double()
    err = (got - ref64).abs().amax(dim=-1)                  # (B, S + new − 1)
    err_last = (logits[0].double() - ref64[:, p_len - 1]).abs().amax(dim=-1)
    scale = max(1.0, ref64.abs().max().item())
    tol = TOL_LOGITS * scale
    worst = max(err[live].max().item(),
                err_last[live[:, p_len - 1]].max().item()
                if live[:, p_len - 1].any() else 0.0)
    err_plain = (plain32.double() - ref64)[live].abs().max().item()
    check(bool(torch.isfinite(got).all()), "jamba parity: non-finite logits")
    check(worst <= tol, f"jamba parity: logits differ from float64 by "
          f"{worst} (tolerance {tol})")
    emit({"phase": "jamba_parity", "arch": JAMBA_ARCH,
          "num_layers": PARITY_LAYERS, "d_model": cfg.d_model,
          "d_inner": transformer.mamba_spec(cfg).d_inner,
          "d_state": cfg.mamba_d_state, "window": cfg.sliding_window,
          "experts": spec.num_experts, "top_k": spec.experts_per_token,
          "batch": b, "prompt": p_len, "new_tokens": PARITY_NEW,
          "capacity": moe.group_capacity(spec, p_len),
          "positions_compared": int(live.sum()),
          "positions_total": int(live.numel()),
          "max_abs_logit": scale, "max_abs_err": worst,
          "plain_forward_f32_err": err_plain, "tol": tol,
          "tol_rel": TOL_LOGITS, "flip_margin": MOE_FLIP_MARGIN,
          "prefill_routing": sum_pre, "decode_routing": sum_dec,
          "generate_equal": True,
          "launches": {"flash_attention": 1, "moe_topk": PARITY_NEW,
                       "mamba_scan": PARITY_NEW}})
    del params, logits, all32, ref64, plain32, got, seen32, seen64
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 19–21: serving of gemma3-4b (5:1 sliding/global attention, qk-norm,
# head_dim 256)
# ---------------------------------------------------------------------------

GEMMA_ARCH = "gemma3-4b"
# one period of the 34-layer stack: 5 sliding layers (window 1024), then a
# global one; 4.95 GB of float32 weights
GEMMA_PARITY_LAYERS = 6
# longer than the window: the sliding layers' 1024-slot ring wraps in
# prefill, and decode reads a ring whose oldest slots were overwritten
GEMMA_PARITY_PROMPT = 1280
GEMMA_SMOKE_PROMPT = 128    # twice the smoke's window of 64


def gemma_parity_phase() -> None:
    """gemma3-4b at full width and one period (5 sliding layers, then the
    global one), B = 2, prompts longer than the window: the kernel path's
    prefill and decode logits against the port's float64 ``forward`` on
    the card, the ring caches' lengths, and one prefill with no sync."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer
    from repro_torch.serve import ServeEngine

    cfg = dataclasses.replace(get_config(GEMMA_ARCH),
                              num_layers=GEMMA_PARITY_LAYERS)
    check([ls.mixer for ls in cfg.layer_specs()]
          == ["attn_sliding"] * 5 + ["attn_full"],
          "gemma parity: the 6 layers are not 5 sliding, then 1 global")
    b, p_len = PARITY_BATCH, GEMMA_PARITY_PROMPT
    max_len = p_len + PARITY_NEW
    rings = [c["kv"]["k"].shape[1] for c in transformer.init_cache(
        cfg, 1, max_len, torch.float32, "cuda")["layers"]]
    check(rings == [cfg.sliding_window] * 5 + [max_len],
          f"gemma parity: cache slots per layer {rings}")
    params = transformer.init_params(cfg, seed=0, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (b, p_len), generator=g,
                            device="cuda")
    fa.KERNEL.launches = 0
    tokens, logits, _ = _greedy(params, cfg, prompts, PARITY_NEW)
    check(fa.KERNEL.launches == GEMMA_PARITY_LAYERS, "gemma parity: flash "
          f"attention launched {fa.KERNEL.launches} times in one generate")
    no_sync_prefill(GEMMA_ARCH, params, cfg, prompts)
    engine = ServeEngine(cfg, params, max_len=max_len)
    check(np.array_equal(engine.generate(prompts, new_tokens=PARITY_NEW),
                         tokens.cpu().numpy()),
          "gemma parity: ServeEngine.generate differs from its own steps")
    del engine
    fed = torch.cat([prompts, tokens[:, :-1]], dim=1)
    with torch.no_grad():
        p64 = _cast(params, dtype=torch.float64)
        ref64 = transformer.forward(p64, cfg, {"tokens": fed})[:, p_len - 1:]
        del p64
        plain32 = transformer.forward(params, cfg, {"tokens": fed})[
            :, p_len - 1:]
    got = torch.stack(logits, dim=1).double()
    scale = max(1.0, ref64.abs().max().item())
    tol = TOL_LOGITS * scale
    err = (got - ref64).abs().max().item()
    err_prefill = (got[:, 0] - ref64[:, 0]).abs().max().item()
    err_plain = (plain32.double() - ref64).abs().max().item()
    check(torch.isfinite(got).all().item(), "gemma parity: non-finite logits")
    check(err <= tol, f"gemma parity: logits differ from float64 by {err} "
          f"(tolerance {tol})")
    emit({"phase": "gemma_parity", "arch": GEMMA_ARCH,
          "num_layers": GEMMA_PARITY_LAYERS, "d_model": cfg.d_model,
          "head_dim": cfg.head_dim, "window": cfg.sliding_window,
          "cache_slots": rings, "batch": b, "prompt": p_len,
          "new_tokens": PARITY_NEW, "weight_gb": 4 * cfg.count_params() / 1e9,
          "max_abs_logit": scale, "max_abs_err": err,
          "prefill_err": err_prefill, "plain_forward_f32_err": err_plain,
          "tol": tol, "tol_rel": TOL_LOGITS, "generate_equal": True,
          "flash_launches": GEMMA_PARITY_LAYERS})
    del params, logits, ref64, plain32, got
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 21a–21d: llama4-scout-17b-a16e and llama4-maverick-400b-a17b serving
# (chunked-local attention with a global layer every 4th, qk-norm, top-1
# MoE at E = 16 on every layer and E = 128 on every other one)
# ---------------------------------------------------------------------------

SCOUT_ARCH = "llama4-scout-17b-a16e"
MAVERICK_ARCH = "llama4-maverick-400b-a17b"
# one period of scout's 48 layers: 3 chunked layers and the global one,
# 37.36 GB of float32 weights (all 48: 402.8 GB); run (c)'s prompt
# crosses the chunk of 8192 once
SCOUT_SERVE_LAYERS = 4
SCOUT_SERVE_RUNS = SERVE_RUNS + (("c", 1, 16384),)
# maverick's first two layers (MoE of 128 experts, then SwiGLU; both
# chunked), 69.57 GB: the first global layer is index 3, and 4 layers are
# 135.0 GB
MAVERICK_SERVE_LAYERS = 2
MAVERICK_HEADROOM = 2e9     # maverick's peak stays under the card's total
                            # less this
# scout's widths at 2 layers, f32 20.75 GB beside 41.50 GB of float64:
# layer 0 chunked (chunk cut to 512), layer 1 global (offset cut to 1);
# prompts of 1536 cross two chunk boundaries and fill three MoE groups of
# 512 a row, then 4 decode steps from the first position of a new chunk
LLAMA_PARITY_CUTS = dict(num_layers=2, global_offset=1, chunk_size=512)
LLAMA_PARITY_PROMPT = 1536
LLAMA_PARITY_NEW = 5
LLAMA_SMOKE_PROMPT = 192    # three of the smokes' chunks (and groups) of 64
MAVERICK_MOE_PROMPT = 2048  # maverick's MoE layer on a 1 × 2048 prompt
# |y − y64| ≤ TOL_MOE_Y · max|y64| for the MoE layer's output: float32
# products over 5120 and 8192 terms leave ≈ 1e-6 of the scale; a wrong
# expert, a token kept past its capacity or a lost gate moves it by O(1)
TOL_MOE_Y = 1e-4


def llama4_parity_phase() -> None:
    """llama4-scout at full width and 2 layers (a chunked MoE layer, then
    a global one), B = 2, 1536-token prompts across two chunk boundaries,
    4 decode steps: the kernel path's last prefill and decode logits
    against the port's float64 ``forward`` with the MoE grouped as served,
    on each row up to its first routing difference from float64 (counted;
    each must lie at a float64 margin below 1e-5); the cache rings; one
    prefill with no sync."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_router as mr
    from repro_torch.models import moe, transformer
    from repro_torch.serve import ServeEngine

    cfg = dataclasses.replace(get_config(SCOUT_ARCH), **LLAMA_PARITY_CUTS)
    spec = transformer.moe_spec(cfg)
    check([(ls.mixer, ls.ffn) for ls in cfg.layer_specs()]
          == [("attn_chunked", "moe"), ("attn_full", "moe")],
          "llama4 parity: the 2 layers are not chunked + MoE, then global + "
          "MoE")
    b, p_len, new = PARITY_BATCH, LLAMA_PARITY_PROMPT, LLAMA_PARITY_NEW
    max_len = p_len + new
    rings = [c["kv"]["k"].shape[1] for c in transformer.init_cache(
        cfg, 1, max_len, torch.float32, "cuda")["layers"]]
    check(rings == [cfg.chunk_size, max_len],
          f"llama4 parity: cache slots per layer {rings}")
    params = transformer.init_params(cfg, seed=0, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (b, p_len), generator=g,
                            device="cuda")
    seen32 = []
    with _recording_moe_inputs(seen32):
        fa.KERNEL.launches = mr.KERNEL.launches = 0
        tokens, logits, _ = _greedy(params, cfg, prompts, new)
        launched = (fa.KERNEL.launches, mr.KERNEL.launches)
    check(launched == (2, 2 * new), f"llama4 parity: {launched} flash and "
          f"moe_topk launches in one generate of {new} tokens")
    engine = ServeEngine(cfg, params, max_len=max_len)
    check(np.array_equal(engine.generate(prompts, new_tokens=new),
                         tokens.cpu().numpy()),
          "llama4 parity: ServeEngine.generate differs from its own steps")
    del engine
    no_sync_prefill(SCOUT_ARCH, params, cfg, prompts)
    fed = torch.cat([prompts, tokens[:, :-1]], dim=1)
    seen64 = []
    with torch.no_grad(), _recording_moe_inputs(seen64), \
            _moe_groups_as_served(p_len):
        p64 = _cast(params, dtype=torch.float64)
        x64 = transformer._backbone(p64, cfg, {"tokens": fed})
        ref64 = transformer.unembed(p64, cfg, x64[:, p_len - 1:])
        routers64 = [lay["moe"]["router"] for lay in p64["layers"]]
        del p64, x64
        x32 = transformer._backbone(params, cfg, {"tokens": fed})
        plain32 = transformer.unembed(params, cfg, x32[:, p_len - 1:])
        del x32
    agree, summaries = [], {}
    for i in range(cfg.num_layers):
        router32 = params["layers"][i]["moe"]["router"]
        a_pre, summaries[f"layer{i}_prefill"] = _compare_routing(
            f"llama4 layer {i} prefill", router32, routers64[i], seen32[i],
            seen64[2 * i], spec, cfg.moe_group_size)
        dec32 = torch.cat([seen32[2 * step + i] for step in range(1, new)],
                          dim=1)
        a_dec, summaries[f"layer{i}_decode"] = _compare_routing(
            f"llama4 layer {i} decode", router32, routers64[i], dec32,
            seen64[2 * i + 1], spec, 1)
        agree.append(torch.cat([a_pre.reshape(b, -1), a_dec.reshape(b, -1)],
                               dim=1))
    first = _first_routing_difference(agree, b)
    pos = p_len - 1 + torch.arange(new, device="cuda")
    live = pos[None] < first[:, None]                       # (B, new)
    got = torch.stack(logits, dim=1).double()
    err = (got - ref64).abs().amax(dim=-1)
    scale = max(1.0, ref64.abs().max().item())
    tol = TOL_LOGITS * scale
    worst = err[live].max().item() if live.any() else 0.0
    err_plain = (plain32.double() - ref64).abs().amax(dim=-1)[live]
    check(bool(live[:, 0].any()), "llama4 parity: every row's routing "
          "differs from float64 before the prompt's end")
    check(bool(torch.isfinite(got).all()), "llama4 parity: non-finite "
          "logits")
    check(worst <= tol, f"llama4 parity: logits differ from float64 by "
          f"{worst} (tolerance {tol})")
    emit({"phase": "llama4_parity", "arch": SCOUT_ARCH,
          "cuts": {**LLAMA_PARITY_CUTS, "why": "depth 2 (one chunked and "
                   "one global layer; a period of 4 in float64 is 74.7 GB), "
                   "the global layer's offset 3 → 1, chunk 8192 → 512 so "
                   "that 1536-token prompts cross two chunk boundaries"},
          "d_model": cfg.d_model, "heads": [cfg.num_heads, cfg.num_kv_heads],
          "head_dim": cfg.head_dim, "experts": spec.num_experts,
          "top_k": spec.experts_per_token, "cache_slots": rings,
          "batch": b, "prompt": p_len, "decode_steps": new - 1,
          "capacity": moe.group_capacity(spec, cfg.moe_group_size),
          "weight_gb": 4 * cfg.count_params() / 1e9,
          "positions_compared": int(live.sum()),
          "positions_total": int(live.numel()),
          "max_abs_logit": scale, "max_abs_err": worst,
          "prefill_err": err[:, 0][live[:, 0]].max().item(),
          "plain_forward_f32_err": err_plain.max().item()
          if err_plain.numel() else 0.0,
          "tol": tol, "tol_rel": TOL_LOGITS, "flip_margin": MOE_FLIP_MARGIN,
          "routing": summaries, "generate_equal": True,
          "launches": {"flash_attention": 2, "moe_topk": 2 * new}})
    del params, logits, ref64, plain32, got, seen32, seen64
    gc.collect()
    torch.cuda.empty_cache()


def maverick_moe_check(cfg, params) -> None:
    """maverick's MoE layer (layer 0, 128 experts, top-1) on its own input
    from a 1 × 2048 prompt at full width: the kernel path's output against
    a float64 product one expert at a time (each expert's three matrices
    cast in turn: the whole layer in float64 is 129 GB), with the kernel's
    ids, held against the plain version's under the tie rule, and the same
    capacity and drops as the port, decided here from those ids alone."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import moe_router as mr
    from repro_torch.kernels import ref
    from repro_torch.models import moe, transformer

    spec = transformer.moe_spec(cfg)
    check(cfg.layer_specs()[0].ffn == "moe", "maverick: layer 0 is not MoE")
    g = torch.Generator(device="cuda").manual_seed(3)
    prompts = torch.randint(0, cfg.vocab_size, (1, MAVERICK_MOE_PROMPT),
                            generator=g, device="cuda")
    seen = []
    with torch.no_grad(), _recording_moe_inputs(seen):
        cache = transformer.init_cache(cfg, 1, MAVERICK_MOE_PROMPT,
                                       torch.float32, "cuda")
        transformer.prefill(params, cfg, {"tokens": prompts}, cache)
        del cache
        h = seen[0]                                         # (1, S, D)
        lay = params["layers"][0]["moe"]
        y32 = moe.moe_block(lay, spec, h)
        logits = moe._router_logits(lay, h.reshape(-1, cfg.d_model))
        _, ids = mr.moe_topk(logits, 1)
        _, ids_plain = ref.moe_topk_ref(logits, 1)
        _, ids64 = ref.moe_topk_ref(moe._router_logits(
            {"router": lay["router"].double()},
            h.double().reshape(-1, cfg.d_model)), 1)
    near = _near_tie_rows(logits, 1)
    differ = (ids != ids_plain).any(dim=1)
    check(not bool((differ & ~near).any()), "maverick MoE: kernel ids differ "
          "from the plain version's on rows without a near-tie")
    # capacity: the first `cap` tokens of each group of `group` that chose
    # an expert keep their slot, the rest are dropped (weight 0)
    t_all = ids.shape[0]
    group = min(spec.group_size, t_all)
    cap = moe.group_capacity(spec, group)
    e_of = ids[:, 0].long()
    onehot = F.one_hot(e_of, spec.num_experts).reshape(
        t_all // group, group, spec.num_experts)
    rank = (onehot.cumsum(dim=1) - 1).reshape(t_all, -1).gather(
        1, e_of[:, None])[:, 0]
    kept = rank < cap
    x64 = h.reshape(-1, cfg.d_model).double()
    y64 = torch.zeros_like(x64)
    for e in range(spec.num_experts):
        rows = torch.nonzero(kept & (e_of == e)).flatten()
        if rows.numel() == 0:
            continue
        wg, wu, wd = (lay[k][e].double() for k in ("w_gate", "w_up",
                                                   "w_down"))
        xe = x64[rows]
        y64[rows] = (F.silu(xe @ wg) * (xe @ wu)) @ wd      # gate 1 (top-1)
        del wg, wu, wd
    y = y32.reshape(-1, cfg.d_model).double()
    scale = y64.abs().max().item()
    err = (y - y64).abs().max().item()
    check(bool(torch.isfinite(y32).all()), "maverick MoE: non-finite output")
    check(err <= TOL_MOE_Y * scale, f"maverick MoE: output differs from the "
          f"per-expert float64 product by {err} (tolerance "
          f"{TOL_MOE_Y * scale})")
    emit({"phase": "maverick_moe", "arch": MAVERICK_ARCH, "layer": 0,
          "experts": spec.num_experts, "top_k": spec.experts_per_token,
          "tokens": t_all, "group": group, "capacity": cap,
          "tokens_dropped": int((~kept).sum()),
          "experts_used": int(torch.unique(e_of).numel()),
          "near_tie_rows": int(near.sum()),
          "rows_ids_differ_plain": int(differ.sum()),
          "rows_ids_differ_f64": int((ids.long() != ids64.long()).any(
              dim=1).sum()),
          "max_abs_y": scale, "max_abs_err": err,
          "tol": TOL_MOE_Y * scale, "tol_rel": TOL_MOE_Y})


# Kernel names by kind in a profile: the port's two model kernels, cuBLAS
# matrix products, and "dispatch": every indexing, sort, scan and
# concatenation kernel (in an MoE model almost all of them are the
# dispatch's gathers and scatters; the embedding lookup and the decode
# cache writes count here too).
PROFILE_KINDS = (("flash_attention", ("flash_attention_kernel",)),
                 ("eq3", ("mixing_gemm", "mixing_weights", "mixing_fixup",
                          "sparse_mixing_slab", "fused_neighbor_sum_slab",
                          "fused_broadcast_select_kernel")),
                 ("rng", ("normal", "philox", "distribution")),
                 ("moe_router", ("moe_topk_kernel",)),
                 ("rwkv6_wkv", ("wkv6_kernel", "wkv6_step_kernel")),
                 ("mamba_scan", ("mamba_scan_kernel",)),
                 ("matmul", ("gemm", "gemv", "xmma", "cutlass")),
                 ("dispatch", ("index", "gather", "scatter", "sort", "scan",
                               "catarray")))


def _profile(fn):
    """Device time of ``fn`` from a torch.profiler trace: the busy time
    (the sum of kernel times, one stream), the wall time on the host clock,
    the time by kind (PROFILE_KINDS, then the rest) and the six kernels
    that took the most. None where the trace holds no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kinds = {kind: 0.0 for kind, _ in PROFILE_KINDS}
    kinds["other"] = 0.0
    by_name = {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0.0)) / 1e3
        name = evt.key.lower()
        kind = next((kind for kind, words in PROFILE_KINDS
                     if any(w in name for w in words)), "other")
        kinds[kind] += ms
        by_name[evt.key[:80]] = (by_name.get(evt.key[:80], (0.0, 0))[0] + ms,
                                 evt.count)
    busy = sum(kinds.values())
    if busy == 0.0:
        return {"wall_ms": wall_ms, "device_busy_ms": None,
                "device_idle_share": None}
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / wall_ms, "by_kind_ms": kinds,
            "top_kernels": [{"name": n, "ms": t, "count": c}
                            for n, (t, c) in top]}


@contextlib.contextmanager
def _counting_flash_masks(seen: dict):
    """Counts the attention layers' flash calls by mask: ``global`` (no
    window, no chunk) and ``windowed`` (a sliding window or a chunk)."""
    from repro_torch.models import attention
    flash = attention.flash_attention

    def counting(q, k, v, **kw):
        kind = "windowed" if kw.get("window") or kw.get("chunk") else "global"
        seen[kind] = seen.get(kind, 0) + 1
        return flash(q, k, v, **kw)

    attention.flash_attention = counting
    try:
        yield
    finally:
        attention.flash_attention = flash


def serve_phase(arch: str, num_layers=None, runs=SERVE_RUNS, by_run=None,
                with_params=None, peak_bound=None) -> dict:
    """``ServeEngine.generate`` of ``arch`` at full width and
    ``num_layers`` layers (None: full depth), random float32 weights from
    a seed, once per run of ``runs``, given the frontends' stub inputs
    (whisper's frames; llava's patches, which the engine drops), the
    launch counters zeroed just before and read just after; then the same
    steps timed with CUDA events, and profiled. ``with_params(cfg,
    params)`` runs once, after the draw and before the runs;
    ``peak_bound`` (bytes) bounds each run's peak memory. Fills ``by_run``
    with each run's launch counts and flash calls by mask, and returns run
    (a)'s launch counts."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.serve import ServeEngine

    gc.collect()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    check(resident < 1e9, f"serve {arch}: {resident / 1e9:.2f} GB still "
          "allocated before its weights are drawn")
    cfg = get_config(arch)
    if num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    n_attn, n_moe, n_rwkv, n_mamba = _layer_counts(cfg)
    masks_expected = _flash_masks(cfg)
    n_flash = sum(masks_expected.values())
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = cfg.count_params()
    weight_bytes = 4 * n_params
    floor_ms = 1e3 * weight_bytes / HBM_BYTES_PER_S
    if with_params is not None:
        with_params(cfg, params)
        gc.collect()
        torch.cuda.empty_cache()
    for run, b, s in runs:
        engine = ServeEngine(cfg, params, max_len=s + NEW_TOKENS)
        g = torch.Generator(device="cuda").manual_seed(10 + b)
        prompts = torch.randint(0, cfg.vocab_size, (b, s), generator=g,
                                device="cuda")
        extra = _frontend_inputs(cfg, b, "cuda")
        counters = _counters()
        for k in counters.values():
            k.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        masks = {"global": 0, "windowed": 0}
        t0 = time.perf_counter()
        with _counting_flash_masks(masks):
            out = engine.generate(prompts, new_tokens=NEW_TOKENS,
                                  extra_batch=extra)
        wall = time.perf_counter() - t0
        counts = {name: k.launches for name, k in counters.items()}
        check(masks == masks_expected, f"serve run ({run}): flash calls by "
              f"mask {masks}, not {masks_expected}")
        peak = torch.cuda.max_memory_allocated()
        check(counts["flash_attention"] == n_flash,
              f"serve run ({run}): flash_attention launched "
              f"{counts['flash_attention']} times in one generate, not "
              f"{n_flash}")
        # the router and the WKV kernel: once per layer of theirs in the
        # prefill and in each of the NEW_TOKENS − 1 decode steps
        check(counts["moe_topk"] == n_moe * NEW_TOKENS,
              f"serve run ({run}): moe_topk launched {counts['moe_topk']} "
              f"times, not {n_moe} MoE layers × {NEW_TOKENS}")
        check(counts["rwkv6_wkv"] == n_rwkv * NEW_TOKENS,
              f"serve run ({run}): rwkv6_wkv launched {counts['rwkv6_wkv']} "
              f"times, not {n_rwkv} rwkv layers × {NEW_TOKENS}")
        check(counts["mamba_scan"] == n_mamba * NEW_TOKENS,
              f"serve run ({run}): mamba_scan launched "
              f"{counts['mamba_scan']} times, not {n_mamba} mamba layers × "
              f"{NEW_TOKENS}")
        check(out.shape == (b, NEW_TOKENS), f"serve run ({run}): {out.shape}")
        if run == "a":
            counts_a = counts
        if by_run is not None:
            by_run[run] = {"launches": counts, "flash_calls_by_mask": masks}
        if peak_bound is not None:
            free, total = torch.cuda.mem_get_info()
            emit({"phase": "serve_memory", "run": run, "arch": arch,
                  "mem_get_info_free_gb": free / 1e9,
                  "mem_get_info_total_gb": total / 1e9,
                  "max_memory_allocated_gb": peak / 1e9,
                  "max_memory_reserved_gb":
                      torch.cuda.max_memory_reserved() / 1e9,
                  "peak_bound_gb": peak_bound / 1e9})
            check(peak < peak_bound, f"serve run ({run}) of {arch}: peak "
                  f"{peak / 1e9:.2f} GB, not under {peak_bound / 1e9:.2f}")

        served = _served(extra)
        tokens, logits, times = _greedy(params, cfg, prompts, NEW_TOKENS,
                                        timed=True, extra=served)
        finite = all(torch.isfinite(lg).all().item() for lg in logits)
        check(finite, f"serve run ({run}): non-finite logits")
        check(np.array_equal(tokens.cpu().numpy(), out),
              f"serve run ({run}): the timed steps differ from generate")
        prefill_ms, decode = times[0], times[1:]
        q1, med, q3 = statistics.quantiles(decode, n=4)
        # a profiled prefill, then 3 profiled decode steps on its cache
        cache = transformer.init_cache(cfg, b, s + NEW_TOKENS, torch.float32,
                                       "cuda")
        state = {}

        def prefill():
            with torch.no_grad():
                state["last"], _ = transformer.prefill(
                    params, cfg, {"tokens": prompts, **served}, cache)

        def decode_3_steps():
            token = torch.argmax(state["last"], dim=-1, keepdim=True)
            with torch.no_grad():
                for i in range(3):
                    pos = torch.full((b,), s + i, dtype=torch.long,
                                     device="cuda")
                    lg, _ = transformer.decode_step(params, cfg, token, cache,
                                                    pos)
                    token = torch.argmax(lg[:, 0], dim=-1, keepdim=True)

        prof = {"prefill": _profile(prefill),
                "decode_3_steps": _profile(decode_3_steps)}
        emit({"phase": "serve", "run": run, "arch": arch,
              "num_layers": cfg.num_layers, "moe_layers": n_moe,
              "rwkv_layers": n_rwkv, "mamba_layers": n_mamba,
              "d_model": cfg.d_model,
              "params": n_params, "weight_gb": weight_bytes / 1e9,
              "init_s": init_s, "batch": b, "prompt": s,
              "new_tokens": NEW_TOKENS, "generate_wall_s": wall,
              "prefill_ms": prefill_ms,
              "prefill_tok_s": 1e3 * b * s / prefill_ms,
              "decode_ms_per_step": med, "decode_ms_q1": q1,
              "decode_ms_q3": q3, "decode_steps": len(decode),
              "decode_tok_s": 1e3 * b / med,
              "weight_bytes_floor_ms": floor_ms,
              "max_memory_allocated_gb": peak / 1e9,
              "logits_finite": finite, "launches": counts,
              "flash_calls_by_mask": masks, "frontend_inputs": {
                  k: list(v.shape) for k, v in extra.items()},
              "profile": prof, "tokens_row0": out[0].tolist()})
        del engine, logits, tokens, cache, state, extra, served
        torch.cuda.empty_cache()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return counts_a


# ---------------------------------------------------------------------------
# phases 21e–21h: whisper-tiny (encoder-decoder, cross attention, learned
# positions) and llava-next-mistral-7b (early-fused patches) serving
# ---------------------------------------------------------------------------

WHISPER_ARCH = "whisper-tiny"
LLAVA_ARCH = "llava-next-mistral-7b"
# whisper's serve runs: (a) B = 1 and (b) B = 8 with the 4-token
# start-of-transcript prompt; (c) B = 1 with a 432-token prompt, which with
# the 16 new tokens fills the model card's native 448-token context
WHISPER_SERVE_RUNS = (("a", 1, 4), ("b", 8, 4), ("c", 1, 432))
WHISPER_PARITY_PROMPT = 64
LLAVA_PARITY_LAYERS = 2
# llava's vision batch: 2880 patches and 1216 tokens in 4096 positions
# (the reference's train_4k); 1216 is no multiple of the 512-token xent
# chunk, so the loss unembeds the text in one chunk (156 MB of logits)
LLAVA_LOSS_SEQ = 4096
LLAVA_LOSS_ITERS = 3


def whisper_parity_phase() -> None:
    """whisper-tiny at full width and full depth (4 encoder and 4 decoder
    layers), B = 2, 1500 stub frames, 64-token prompts, 8 new tokens: the
    kernel path's prefill and decode logits against the port's float64
    ``forward`` over the prompt and the tokens fed back, within
    1e-4·max|logit|, and the encoder's output through the kernel against
    its float64; 12 flash launches a prefill (4 encoder, 4 self, 4
    cross); ``generate`` equal to its own steps; one prefill with no
    sync."""
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer
    from repro_torch.serve import ServeEngine

    cfg = get_config(WHISPER_ARCH)
    b, p_len, new = PARITY_BATCH, WHISPER_PARITY_PROMPT, PARITY_NEW
    params = transformer.init_params(cfg, seed=0, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (b, p_len), generator=g,
                            device="cuda")
    extra = _frontend_inputs(cfg, b, "cuda")
    n_flash = sum(_flash_masks(cfg).values())
    fa.KERNEL.launches = 0
    tokens, logits, _ = _greedy(params, cfg, prompts, new, extra=extra)
    check(fa.KERNEL.launches == n_flash == 12, "whisper parity: flash "
          f"attention launched {fa.KERNEL.launches} times in one generate")
    no_sync_prefill(WHISPER_ARCH, params, cfg, prompts, extra)
    engine = ServeEngine(cfg, params, max_len=p_len + new)
    check(np.array_equal(engine.generate(prompts, new_tokens=new,
                                         extra_batch=extra),
                         tokens.cpu().numpy()),
          "whisper parity: ServeEngine.generate differs from its own steps")
    fed = torch.cat([prompts, tokens[:, :-1]], dim=1)
    with torch.no_grad():
        p64 = _cast(params, dtype=torch.float64)
        ref64 = transformer.forward(p64, cfg, {"tokens": fed, **extra})[
            :, p_len - 1:]
        plain32 = transformer.forward(params, cfg, {"tokens": fed, **extra})[
            :, p_len - 1:]
        enc64 = transformer._encode(p64, cfg, extra["frames"].double(),
                                    kernel=False)
        enc32 = transformer._encode(params, cfg, extra["frames"],
                                    kernel=True)
        del p64
    got = torch.stack(logits, dim=1).double()
    scale = max(1.0, ref64.abs().max().item())
    tol = TOL_LOGITS * scale
    err = (got - ref64).abs().max().item()
    err_prefill = (got[:, 0] - ref64[:, 0]).abs().max().item()
    err_plain = (plain32.double() - ref64).abs().max().item()
    enc_scale = enc64.abs().max().item()
    enc_err = (enc32.double() - enc64).abs().max().item()
    check(torch.isfinite(got).all().item(), "whisper parity: non-finite "
          "logits")
    check(err <= tol, f"whisper parity: logits differ from float64 by {err} "
          f"(tolerance {tol})")
    check(enc_err <= TOL_LOGITS * enc_scale, "whisper parity: the encoder's "
          f"output differs from float64 by {enc_err}")
    emit({"phase": "whisper_parity", "arch": WHISPER_ARCH,
          "num_layers": cfg.num_layers, "encoder_layers": cfg.encoder_layers,
          "frames": cfg.encoder_seq, "d_model": cfg.d_model, "batch": b,
          "prompt": p_len, "new_tokens": new,
          "weight_gb": 4 * cfg.count_params() / 1e9,
          "max_abs_logit": scale, "max_abs_err": err,
          "prefill_err": err_prefill, "plain_forward_f32_err": err_plain,
          "encoder_max_abs": enc_scale, "encoder_err": enc_err,
          "tol": tol, "tol_rel": TOL_LOGITS, "generate_equal": True,
          "flash_launches": n_flash})
    del params, logits, ref64, plain32, got, enc32, enc64, engine, extra
    gc.collect()
    torch.cuda.empty_cache()


def llava_parity_phase() -> None:
    """llava-next-mistral-7b at full width and 2 layers. Serving: B = 2,
    256-token prompts, 8 new tokens, the patches given to ``generate`` and
    dropped (its tokens equal to the steps' without them), the prefill and
    decode logits against the float64 ``forward`` of the tokens within
    1e-4·max|logit|, one prefill with no sync. Early fusion: one vision
    batch of 2880 patches and 1216 tokens (4096 positions; the text at
    RoPE positions 2880 .. 4095): the float32 ``forward`` against the
    float64 one at every position within 1e-4·max|logit|, and ``loss_fn``
    through the kernels (a flash launch a layer over the 4096 positions)
    against its float64 within ``TOL_LM_LOSS`` relative."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import make_batch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer
    from repro_torch.serve import ServeEngine

    cfg = dataclasses.replace(get_config(LLAVA_ARCH),
                              num_layers=LLAVA_PARITY_LAYERS)
    b, p_len, new = PARITY_BATCH, PARITY_PROMPT, PARITY_NEW
    params = transformer.init_params(cfg, seed=0, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (b, p_len), generator=g,
                            device="cuda")
    fa.KERNEL.launches = 0
    tokens, logits, _ = _greedy(params, cfg, prompts, new)
    check(fa.KERNEL.launches == LLAVA_PARITY_LAYERS, "llava parity: flash "
          f"attention launched {fa.KERNEL.launches} times in one generate")
    no_sync_prefill(LLAVA_ARCH, params, cfg, prompts)
    engine = ServeEngine(cfg, params, max_len=p_len + new)
    check(np.array_equal(engine.generate(
        prompts, new_tokens=new,
        extra_batch=_frontend_inputs(cfg, b, "cuda")), tokens.cpu().numpy()),
        "llava parity: generate given the patches differs from the steps "
        "without them")
    del engine
    fed = torch.cat([prompts, tokens[:, :-1]], dim=1)
    p64 = _cast(params, dtype=torch.float64)
    with torch.no_grad():
        ref64 = transformer.forward(p64, cfg, {"tokens": fed})[:, p_len - 1:]
    got = torch.stack(logits, dim=1).double()
    scale = max(1.0, ref64.abs().max().item())
    err = (got - ref64).abs().max().item()
    check(torch.isfinite(got).all().item(), "llava parity: non-finite logits")
    check(err <= TOL_LOGITS * scale, f"llava parity: logits differ from "
          f"float64 by {err} (tolerance {TOL_LOGITS * scale})")
    del ref64, got, logits

    batch = make_batch(cfg, dict(global_batch=1, seq_len=LLAVA_LOSS_SEQ),
                       torch.Generator(device="cuda").manual_seed(4))
    s_text = LLAVA_LOSS_SEQ - cfg.num_patches
    check(tuple(batch["tokens"].shape) == (1, s_text),
          f"llava parity: tokens {tuple(batch['tokens'].shape)}")
    fused = {"tokens": batch["tokens"], "patch_embeds": batch["patch_embeds"]}
    with torch.no_grad():
        fa.KERNEL.launches = 0
        loss32 = transformer.loss_fn(params, cfg, batch).item()
        loss_launches = fa.KERNEL.launches
        loss64 = transformer.loss_fn(p64, cfg, batch).item()
        f64 = transformer.forward(p64, cfg, fused)
        f32 = transformer.forward(params, cfg, fused)
    check(f64.shape[1] == LLAVA_LOSS_SEQ, f"llava parity: forward over "
          f"{f64.shape[1]} positions")
    fscale = max(1.0, f64.abs().max().item())
    ferr = (f32.double() - f64).abs().max().item()
    rel = abs(loss32 - loss64) / abs(loss64)
    check(ferr <= TOL_LOGITS * fscale, f"llava parity: the fused forward "
          f"differs from float64 by {ferr}")
    check(rel <= TOL_LM_LOSS, f"llava parity: loss {loss32} is {rel:.3g} "
          f"relative from float64's {loss64}")
    check(loss_launches == LLAVA_PARITY_LAYERS,
          f"llava parity: {loss_launches} flash launches in one loss_fn")
    emit({"phase": "llava_parity", "arch": LLAVA_ARCH,
          "num_layers": LLAVA_PARITY_LAYERS, "d_model": cfg.d_model,
          "batch": b, "prompt": p_len, "new_tokens": new,
          "max_abs_logit": scale, "max_abs_err": err,
          "tol": TOL_LOGITS * scale, "generate_with_patches_equal": True,
          "vision_batch": {"patches": cfg.num_patches, "tokens": s_text},
          "fused_forward_max_abs_logit": fscale,
          "fused_forward_err": ferr, "loss": loss32, "loss_f64": loss64,
          "loss_rel_err": rel, "tol_loss_rel": TOL_LM_LOSS,
          "loss_flash_launches": loss_launches})
    del params, p64, f64, f32
    gc.collect()
    torch.cuda.empty_cache()


def llava_loss_check(cfg, params) -> None:
    """llava's ``loss_fn`` at full width and depth on one vision batch of
    2880 patches and 1216 tokens (``LLAVA_LOSS_SEQ``): CUDA-event ms of
    ``LLAVA_LOSS_ITERS`` calls after one warm-up, the peak memory, one
    flash launch a layer (causal over the 4096 positions), a finite loss;
    one call under the sync check."""
    import math

    import torch

    from repro_torch.data import make_batch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer

    batch = make_batch(cfg, dict(global_batch=1, seq_len=LLAVA_LOSS_SEQ),
                       torch.Generator(device="cuda").manual_seed(5))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        fa.KERNEL.launches = 0
        loss = transformer.loss_fn(params, cfg, batch)
        launches = fa.KERNEL.launches
        times = []
        for _ in range(LLAVA_LOSS_ITERS):
            a = torch.cuda.Event(enable_timing=True)
            z = torch.cuda.Event(enable_timing=True)
            a.record()
            transformer.loss_fn(params, cfg, batch)
            z.record()
            times.append((a, z))
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        torch.cuda.set_sync_debug_mode("error")
        try:
            transformer.loss_fn(params, cfg, batch)
        except RuntimeError as err:
            raise RuntimeError(f"no_sync llava loss_fn: it waits for the "
                               f"card: {err}") from err
        finally:
            torch.cuda.set_sync_debug_mode("default")
    ms = [a.elapsed_time(z) for a, z in times]
    value = loss.item()
    check(launches == cfg.num_layers, f"llava loss: {launches} flash "
          f"launches, not {cfg.num_layers}")
    check(math.isfinite(value), f"llava loss: {value}")
    emit({"phase": "llava_loss", "arch": cfg.name,
          "num_layers": cfg.num_layers, "seq": LLAVA_LOSS_SEQ,
          "patches": cfg.num_patches,
          "tokens": LLAVA_LOSS_SEQ - cfg.num_patches, "loss": value,
          "loss_ms": ms, "loss_ms_median": statistics.median(ms),
          "peak_memory_gb": peak / 1e9,
          "weight_gb": 4 * cfg.count_params() / 1e9,
          "flash_launches": launches, "no_sync": True})


# ---------------------------------------------------------------------------
# phase 22: NetES over LM agents
# ---------------------------------------------------------------------------

def _lm_config(family, dens, rep, channel):
    from repro_torch.core.netes import NetESConfig
    from repro_torch.core.topology import TopologySpec
    from repro_torch.train.loop import TrainConfig
    return TrainConfig(
        n_agents=LM_N, iters=LM_ITERS, seed=0, representation=rep,
        channel=channel,
        topology=TopologySpec(family=family, n_agents=LM_N, p=dens, seed=0),
        netes=NetESConfig(alpha=LM_ALPHA, sigma=LM_SIGMA,
                          p_broadcast=LM_P_BROADCAST))


def _lm_inputs(cfg, tc, it, seq):
    """Iteration ``it``'s batch and draws in ``train_lm_netes``."""
    from repro_torch.train.loop import lm_step_inputs
    return lm_step_inputs(cfg, tc, it, seq, device="cuda")


def _lm_f64_check(cfg, tc, topo, seq) -> dict:
    """The first step of case (i), from the run's θ⁽⁰⁾, batch and ε, held
    against float64 on the card: each agent's ± loss (the kernel path,
    ``loss_fn`` on float32 weights) against ``loss_fn`` of the same
    perturbed weights cast to float64 (the plain forward's layers) within
    ``TOL_LM_LOSS`` relative; the order of every two rewards whose float64
    gap exceeds that tolerance; and the last ``LM_CHECK_COLS`` columns of
    every leaf's update against Eq. 3 in float64 from the same θ, ε and
    shaped rewards: |Δθ − Δθ₆₄| ≤ TOL_REL·S + 2⁻²⁴·|θ'|, S the sum of the
    update's terms' magnitudes (α/(Nσ²)·(Σ|a w_θ θ_i| + σΣ|a w_ε ε_i| +
    |wsum θ_j|) + wd·|θ_j|), the last term the rounding of θ + Δθ. The
    step's β is set to 1 (no broadcast), so that the update is Eq. 3's."""
    import dataclasses

    import torch

    from repro_torch.core import es_utils
    from repro_torch.core.tree import flatten, tree_map
    from repro_torch.distributed import netes_dist
    from repro_torch.kernels import ref
    from repro_torch.models import transformer
    from repro_torch.train.loop import lm_population

    ncfg = tc.netes
    params = lm_population(cfg, tc, device="cuda")
    batch, draws = _lm_inputs(cfg, tc, 0, seq)
    draws = dataclasses.replace(draws, beta=torch.ones((), device="cuda"))
    r_pos, r_neg = netes_dist.agent_rewards(cfg, params, batch, draws.noise,
                                            ncfg.sigma)
    r32 = torch.cat([r_pos, r_neg]).double().cpu()
    r64 = []
    replica = tree_map(lambda leaf: torch.empty_like(leaf[0]), params)
    for sign in (1.0, -1.0):
        for a in range(LM_N):
            theta = netes_dist.agent_params(params, a)
            netes_dist.perturb_params(theta, draws.noise, a, ncfg.sigma,
                                      out=replica)
            if sign < 0:     # 2θ − (θ + σε), as the step makes θ − σε
                tree_map(lambda p, t: p.mul_(-1.0).add_(t, alpha=2.0),
                         replica, theta)
            p64 = tree_map(lambda x: x.double(), replica)
            loss = transformer.loss_fn(p64, cfg,
                                       {k: v[a] for k, v in batch.items()})
            r64.append(-loss.item())
            del p64, loss
    del replica
    r64 = torch.tensor(r64, dtype=torch.float64)
    rel = ((r32 - r64).abs() / r64.abs()).max().item()
    check(rel <= TOL_LM_LOSS, f"lm_netes f64: a ± loss is {rel:.3g} "
          f"relative from float64, above {TOL_LM_LOSS}")
    gap = r64[:, None] - r64[None, :]
    decided = gap.abs() > TOL_LM_LOSS * r64.abs()[:, None]
    flips = int((decided & (torch.sign(r32[:, None] - r32[None, :])
                            != torch.sign(gap))).sum().item())
    check(flips == 0, f"lm_netes f64: {flips} reward pairs ordered "
          "otherwise than in float64")

    # the columns held, before the update: θ and ε of each leaf's last
    # slab's tail
    leaves = flatten(params)
    held = []
    for i, leaf in enumerate(leaves):
        flat = leaf.view(LM_N, -1)
        p = flat.shape[1]
        s = (p - 1) // netes_dist.SLAB_COLUMNS
        c0 = s * netes_dist.SLAB_COLUMNS
        w = min(LM_CHECK_COLS, p - c0)
        eps = torch.empty(LM_N, p - c0, device="cuda")
        for a in range(LM_N):
            draws.noise(eps[a], a, i, s, c0)
        held.append((flat[:, p - w:].double(), eps[:, -w:].double(), w))
        del eps
    netes_dist.replica_update(params, r_pos, r_neg, draws, topo, ncfg)

    shaped = es_utils.centered_rank(torch.cat([r_pos, r_neg])).double()
    w_th, w_ep = shaped[:LM_N] + shaped[LM_N:], shaped[:LM_N] - shaped[LM_N:]
    adj = topo.adj.double()
    scale = ncfg.alpha / (LM_N * ncfg.sigma ** 2)
    worst = 0.0
    for leaf, (th, ep, w) in zip(leaves, held, strict=True):
        new = leaf.view(LM_N, -1)[:, -w:].double()
        mixed = ref.netes_mixing_ref(adj, w_th, w_ep, th, ep,
                                     sigma=ncfg.sigma)
        d64 = scale * mixed - ncfg.weight_decay * th
        wa = adj.abs()
        mag = (scale * ((wa * w_th.abs()) @ th.abs()
                        + ncfg.sigma * ((wa * w_ep.abs()) @ ep.abs())
                        + (adj @ w_th).abs()[:, None] * th.abs())
               + ncfg.weight_decay * th.abs())
        bound = TOL_REL * mag + 2.0 ** -24 * new.abs()
        err = ((new - th) - d64).abs()
        check(bool((err <= bound).all()),
              f"lm_netes f64: an update is off Eq. 3 by "
              f"{(err / bound).max().item():.3g} of its bound")
        worst = max(worst, (err / mag.clamp_min(1e-30)).max().item())
    del params, held
    torch.cuda.empty_cache()
    return {"loss_max_rel_err_f64": rel, "reward_order_flips": flips,
            "reward_pairs_decided": int(decided.sum().item()) // 2,
            "losses": r32.tolist(), "losses_f64": r64.tolist(),
            "update_max_err_over_S": worst, "update_cols_per_leaf":
            LM_CHECK_COLS, "tol_over_S": TOL_REL}


def _no_sync_lm_call(label, step, args) -> None:
    """One replica step under ``torch.cuda.set_sync_debug_mode("error")``."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(*args)
    except RuntimeError as err:
        raise RuntimeError(f"no_sync lm_netes ({label}): the step waits for "
                           f"the card: {err}") from err
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def lm_netes_phase(cfg, seq: int, cases, no_sync_cases) -> dict:
    """``train_lm_netes`` of ``cfg`` at N = 8, one ``seq``-token sequence
    an agent (whisper: beside its 1500 frames), 3 iterations, in
    ``cases``: for gemma3-4b (6 layers) ``LM_CASES``, (i) fully connected
    (the dense kernel), (ii) ER p = 0.5 (the sparse kernel), (iii) (ii)
    through channel (a) (both fused kernels, and the sparse kernel for the
    ε term); for whisper-tiny (full depth) ``LM_WHISPER_CASES``, (i) and
    (ii). Each run's launch counters are zeroed just before it and read
    just after; every Eq. 3 kernel of the case and the flash kernel (the
    calls of one ``loss_fn`` by mask, ``_flash_masks``, × 2N evaluations a
    step) must launch. Per case: the steps' ms (CUDA events), the losses,
    the peak device memory (under ``LM_PEAK_BYTES``), launches a step, and
    one more step profiled (the device's idle share); one step of each
    case in ``no_sync_cases`` under the sync check. Before the first
    case, its first step against float64 (``_lm_f64_check``). Returns the
    launches a step of each case, keyed by its label."""
    import dataclasses
    import math

    import torch

    from repro_torch.core.tree import flatten
    from repro_torch.distributed import netes_dist
    from repro_torch.train.loop import (build_channel, build_topology,
                                        lm_population, train_lm_netes)

    counters = _counters()
    per_step = {}
    per_eval = _flash_masks(cfg)
    for label, family, dens, rep, chan_text in cases:
        tc = _lm_config(family, dens, rep, chan_text)
        topo = build_topology(tc, device="cuda")
        check(topo.kind == rep, f"lm_netes ({label}): {topo.kind} topology")
        f64 = (_lm_f64_check(cfg, tc, topo, seq) if label == cases[0][0]
               else None)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for k in counters.values():
            k.launches = 0
        masks = {}
        with _counting_flash_masks(masks):
            t0 = time.perf_counter()
            hist = train_lm_netes(cfg, tc, seq_len=seq, device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts = {name: k.launches for name, k in counters.items()}
        peak = torch.cuda.max_memory_allocated()
        check(all(math.isfinite(v) for v in hist["loss_mean"])
              and len(hist["loss_mean"]) == LM_ITERS,
              f"lm_netes ({label}): losses {hist['loss_mean']}")
        check(peak < LM_PEAK_BYTES, f"lm_netes ({label}): peak memory "
              f"{peak / 1e9:.2f} GB")
        evals = LM_ITERS * 2 * LM_N
        want = {k: n * evals for k, n in per_eval.items() if n}
        check(counts["flash_attention"] == sum(want.values())
              and masks == want,
              f"lm_netes ({label}): flash launches {counts} by mask {masks}")
        needed = {"dense": ["netes_mixing"], "sparse": ["netes_sparse_mixing"]
                  }[rep] + (["fused_neighbor_sum", "fused_broadcast_select"]
                            if chan_text else [])
        for name in needed:
            check(counts[name] > 0,
                  f"lm_netes ({label}): {name} never launched")
        per_step[label] = {k: v / LM_ITERS for k, v in counts.items() if v}

        # the profiled and the no-sync steps: from the run's θ⁽⁰⁾ again
        params = lm_population(cfg, tc, device="cuda")
        channel = build_channel(tc)
        step = netes_dist.make_replica_train_step(
            cfg, tc.netes, LM_N, microbatch=1, topology=topo,
            channel=channel)
        batch, draws = _lm_inputs(cfg, tc, LM_ITERS, seq)
        states = [channel.init(params)] if channel is not None else []
        prof = _profile(lambda: step(params, None, batch, draws, *states))
        no_sync = label in no_sync_cases
        if no_sync:
            batch, draws = _lm_inputs(cfg, tc, LM_ITERS + 1, seq)
            _no_sync_lm_call(label, step,
                             (params, None, batch, draws, *states))
        emit({"phase": "lm_netes", "case": label, "arch": cfg.name,
              "num_layers": cfg.num_layers,
              "encoder_layers": cfg.encoder_layers, "n_agents": LM_N,
              "seq": seq, "batch_leaves": {k: list(v.shape)
                                           for k, v in batch.items()},
              "family": family, "density": dens, "representation": rep,
              "k_max": topo.k_max, "channel": chan_text,
              "iters": LM_ITERS, "netes": dataclasses.asdict(tc.netes),
              "params_per_agent": sum(leaf[0].numel() for leaf in
                                      flatten(params)),
              "wall_s": wall, "step_ms": hist["step_ms"],
              "step_ms_quartiles": _quartiles(hist["step_ms"]),
              "loss_mean": hist["loss_mean"],
              "reward_max": hist["reward_max"],
              "peak_memory_gb": peak / 1e9, "launches": counts,
              "launches_per_step": per_step[label],
              "flash_by_mask": masks, "profiled_step": prof,
              "no_sync_step": no_sync, "f64_first_step": f64})
        del params, step, states, batch, draws
        torch.cuda.empty_cache()
    return per_step


def lm_netes_cpu_parity_phase() -> None:
    """Two replica steps of each smoke model in ``LM_PARITY_CASES`` on the
    card and on the CPU from the same parameters, batch and draws (ε drawn
    on the CPU for both; the channel's dropout mask is the same bits on
    both devices): gemma3-4b-smoke fully connected (the dense kernel),
    moonshot-v1-16b-a3b-smoke on ER (the sparse kernel and the router
    kernel), jamba-v0.1-52b-smoke through channel (a) (the fused kernels
    and the scan kernel). The first step's β is 1 (no broadcast: the
    mixing is compared), the second's 0 (the broadcast is); the second
    starts on both devices from the CPU's parameters after the first, as
    q8 would round a 1e-7 difference of θ to a code apart on the rare
    element near a half-integer. Before each step the rewards' smallest
    gap must exceed ``LM_MIN_MARGIN``, so that both devices rank them
    alike; after it, parameters and metrics within ``TOL_SMOKE`` (rtol =
    atol)."""
    import torch

    from repro_torch.comm.channel import compile_channel
    from repro_torch.configs import get_config
    from repro_torch.core import topology_repr
    from repro_torch.core.netes import NetESConfig
    from repro_torch.core.topology import TopologySpec
    from repro_torch.core.tree import flatten, tree_map
    from repro_torch.data import make_batch
    from repro_torch.distributed import netes_dist

    ncfg = NetESConfig(alpha=0.01, sigma=0.02, p_broadcast=LM_P_BROADCAST)
    n = LM_PARITY_N
    for arch, family, rep, chan_text in LM_PARITY_CASES:
        cfg = get_config(arch)
        spec = TopologySpec(family=family, n_agents=n, p=LM_P_ER, seed=0)
        gen = torch.Generator().manual_seed(4)
        tokens = make_batch(cfg, dict(global_batch=n, seq_len=LM_PARITY_SEQ),
                            gen)["tokens"].reshape(n, 1, LM_PARITY_SEQ)
        runs = {}
        for dev in ("cpu", "cuda"):
            params = netes_dist.init_population(cfg, n, seed=3, device="cpu")
            params = tree_map(lambda t, d=dev: t.to(d), params)
            chan = compile_channel(chan_text, n) if chan_text else None
            step = netes_dist.make_replica_train_step(
                cfg, ncfg, n, microbatch=1,
                topology=topology_repr.from_spec(spec, representation=rep,
                                                 device=dev),
                channel=chan)
            tok = tokens.to(dev)
            runs[dev] = (params, step, {"tokens": tok, "labels": tok},
                         [chan.init(params)] if chan else [])
        margins, worst, metrics = [], [], []
        for t, beta in enumerate((1.0, 0.0)):
            noise = netes_dist.NoiseStream(seed=5, step=t, device="cpu")
            params, _, batch, _ = runs["cpu"]
            raw = torch.sort(torch.cat(netes_dist.agent_rewards(
                cfg, params, batch, noise, ncfg.sigma))).values
            margins.append((raw[1:] - raw[:-1]).min().item())
            check(margins[-1] > LM_MIN_MARGIN,
                  f"lm_netes_cpu_parity {arch}: step {t}'s rewards "
                  f"{margins[-1]:.3g} apart, too close to rank alike")
            out = {}
            for dev, (params, step, batch, states) in runs.items():
                draws = netes_dist.StepDraws(
                    noise=noise, beta=torch.full((), beta, device=dev))
                res = step(params, None, batch, draws, *states)
                states[:] = res[2:]
                out[dev] = res[1]
            err = 0.0
            for got, want in zip(flatten(runs["cuda"][0]),
                                 flatten(runs["cpu"][0]),
                                 strict=True):
                diff = (got.cpu() - want).abs()
                check(bool((diff <= TOL_SMOKE * (1 + want.abs())).all()),
                      f"lm_netes_cpu_parity {arch}: step {t}'s parameters "
                      f"differ by {diff.max().item():.3g}")
                err = max(err, diff.max().item())
            worst.append(err)
            for name, want in out["cpu"].items():
                got = out["cuda"][name].cpu()
                check(bool(torch.allclose(got, want, rtol=TOL_SMOKE,
                                          atol=TOL_SMOKE)),
                      f"lm_netes_cpu_parity {arch}: {name} {got} vs {want}")
            check(float(out["cuda"]["broadcast"]) == (beta < LM_P_BROADCAST),
                  f"lm_netes_cpu_parity {arch}: broadcast at β = {beta}")
            metrics.append({k: v.item() for k, v in out["cuda"].items()})
            tree_map(lambda g, c: g.copy_(c), runs["cuda"][0],
                     runs["cpu"][0])
        emit({"phase": "lm_netes_cpu_parity", "arch": arch,
              "representation": rep, "channel": chan_text, "n_agents": n,
              "seq": LM_PARITY_SEQ, "betas": [1.0, 0.0],
              "reward_margins": margins, "max_abs_param_diff": worst,
              "tol": TOL_SMOKE, "metrics": metrics})


# ---------------------------------------------------------------------------
# phase 24: the consensus placement (one shared θ, the population
# time-multiplexed: netes_dist.make_consensus_train_step)
# ---------------------------------------------------------------------------

# scout and jamba at full width and 2 layers (scout: both chunked
# attention + MoE of 16 experts, top-1; jamba: mamba + MoE of 16, top-2,
# then mamba + SwiGLU), P = 8 members (``classify`` gives 256 on a world of
# one), one 1 × 4096 microbatch a member (train_4k's sequence):
# (case, arch, family, density, channel, steps)
CONS_SHAPE, CONS_P, CONS_LAYERS = "train_4k", 8, 2
CONS_CASES = (
    ("i", SCOUT_ARCH, "fully_connected", 1.0, None, 3),
    ("ii", SCOUT_ARCH, "erdos_renyi", 0.5, None, 3),
    ("iii", SCOUT_ARCH, "erdos_renyi", 0.5,
     "quantize(bits=8)|dropout(p=0.1,seed=0)", 3),
    ("iv", JAMBA_ARCH, "erdos_renyi", 0.5, None, 2))
# β of each step: step 1 broadcasts (β < p_b), steps 0 and 2 do not, so
# the degree weights act in steps 0 and 2
CONS_BETAS = (1.0, 0.0, 1.0)
CONS_PEAK_SLACK = 10e9      # the peak stays under 2θ + this
CONS_WINDOW = 4096          # columns of each leaf compared across cases
# the cases whose last step runs under the sync check, and whose last
# step is profiled (a profiled scout step costs ≈ 25 s of the profiler's
# own work on the host)
CONS_NO_SYNC = ("iii", "iv")
CONS_PROFILED = ("i",)
CONS_F64 = "ii"             # the case whose step 0 is held against float64
CONS_DEVICE = "cuda"


def _consensus_pair(arch, family, dens, chan_text, mesh):
    """``classify``'s pair on the world-of-one ``mesh`` (consensus, P =
    256), cut to ``CONS_P`` members and ``CONS_LAYERS`` layers."""
    import dataclasses

    from repro_torch.comm.channel import ChannelSpec
    from repro_torch.core.topology import TopologySpec
    from repro_torch.launch import specs

    pair = specs.classify(
        arch, CONS_SHAPE, mesh,
        topo_spec=TopologySpec(family=family, n_agents=CONS_P, p=dens,
                               seed=0),
        chan_spec=ChannelSpec.parse(chan_text) if chan_text else None)
    check(pair.mode == "consensus" and pair.n_agents == 256,
          f"consensus: classify({arch}, {CONS_SHAPE}) on a world of one "
          f"gave {pair.mode}, P = {pair.n_agents}")
    return dataclasses.replace(
        pair, n_agents=CONS_P,
        cfg=dataclasses.replace(pair.cfg, num_layers=CONS_LAYERS),
        topo=dataclasses.replace(pair.topo, n_agents=CONS_P))


def _consensus_inputs(cfg, seed: int = 0):
    """θ⁽⁰⁾ (float32, from ``seed``) and the P microbatches of 1 × 4096."""
    import torch

    from repro_torch.configs import INPUT_SHAPES
    from repro_torch.data import make_batch
    from repro_torch.models import transformer

    seq = INPUT_SHAPES[CONS_SHAPE]["seq_len"]
    params = transformer.init_params(cfg, seed=seed, device=CONS_DEVICE)
    gen = torch.Generator(device=CONS_DEVICE).manual_seed(seed + 1)
    batch = make_batch(cfg, dict(global_batch=CONS_P, seq_len=seq), gen)
    return params, {k: v.reshape((CONS_P, 1) + v.shape[1:])
                    for k, v in batch.items()}


def _consensus_draws(t: int, beta: float):
    import torch

    from repro_torch.distributed import netes_dist
    return netes_dist.StepDraws(noise=netes_dist.NoiseStream(seed=11, step=t),
                                beta=torch.full((), beta, device=CONS_DEVICE))


def _consensus_f64_check(label, cfg, step, args, topo, ncfg, counters):
    """Step 0 of a case, ``build_step``'s own step, timed by CUDA events,
    its update held against float64. Before the step, the rewards of the
    same θ, batch and ε are taken by ``member_rewards`` (its launches are
    taken off the counters); the step's ``reward_mean`` and
    ``reward_max`` must equal theirs bit for bit, so they are the step's
    rewards. Given them and the members' perturbed parameters p_i = θ +
    σε_i in float32 (where the rewards were taken), the last
    ``LM_CHECK_COLS`` columns of every leaf of the step's θ' must lie
    within TOL_REL·S + 2⁻²³·|θ'| of α/(Pσ)·Σ_i c_i·(p_i − θ)/σ − wd·θ in
    float64 (c_i = w_ε,i·deg_i/P, deg the topology's: the step's own
    choice of degrees is checked), S the sum of the terms' magnitudes; the
    last term is two roundings of θ', since θ' is formed in the
    reference's order, θ + α/(Pσ)·u, then − wd·θ. Returns (the step's
    outputs, its ms, the check's numbers)."""
    import torch

    from repro_torch.core import es_utils
    from repro_torch.core.tree import flatten, tree_map
    from repro_torch.distributed import netes_dist

    params, _, batch, draws = args[:4]
    held = []
    for i, leaf in enumerate(flatten(params)):
        flat = leaf.view(-1)
        p = flat.numel()
        s = (p - 1) // netes_dist.SLAB_COLUMNS
        c0 = s * netes_dist.SLAB_COLUMNS
        w = min(LM_CHECK_COLS, p - c0)
        eps = torch.empty(CONS_P, p - c0, device=CONS_DEVICE)
        for m in range(CONS_P):
            draws.noise(eps[m], m, i, s, c0)
        th = flat[p - w:]
        pert = eps[:, -w:].mul(ncfg.sigma).add(th)      # as perturb_params
        held.append((th.double(), pert.double(), w))
        del eps
    before = {name: k.launches for name, k in counters.items()}
    replica = tree_map(torch.empty_like, params)
    r_pos, r_neg = netes_dist.member_rewards(cfg, params, batch,
                                             draws.noise, ncfg.sigma,
                                             replica)
    del replica
    raw = torch.cat([r_pos, r_neg])
    torch.cuda.synchronize()
    for name, k in counters.items():
        k.launches = before[name]
    res, ms = _timed_consensus_call(label, step, args, False)
    metrics = res[1]
    check(torch.equal(metrics["reward_mean"], raw.mean())
          and torch.equal(metrics["reward_max"], raw.max()),
          f"consensus f64 ({label}): the step's rewards are not those of "
          f"member_rewards on the same θ, batch and ε")
    degree = topo.deg.double() / CONS_P
    shaped = es_utils.centered_rank(raw).double()
    coeff = (shaped[:CONS_P] - shaped[CONS_P:]) * degree
    scale = ncfg.alpha / (CONS_P * ncfg.sigma)
    worst = used = 0.0
    for leaf, (th, pert, w) in zip(flatten(res[0]), held, strict=True):
        new = leaf.view(-1)[-w:].double()
        terms = coeff[:, None] * (pert - th) / ncfg.sigma
        d64 = scale * terms.sum(0) - ncfg.weight_decay * th
        mag = scale * terms.abs().sum(0) + ncfg.weight_decay * th.abs()
        bound = TOL_REL * mag + 2.0 ** -23 * new.abs()
        err = ((new - th) - d64).abs()
        check(bool((err <= bound).all()),
              f"consensus f64 ({label}): an update is off by "
              f"{(err / bound).max().item():.3g} of its bound")
        worst = max(worst, (err / mag.clamp_min(1e-30)).max().item())
        used = max(used, (err / bound).max().item())
    return (res, ms,
            {"update_max_err_over_S": worst, "tol_over_S": TOL_REL,
             "update_max_err_over_bound": used,
             "update_cols_per_leaf": LM_CHECK_COLS,
             "rewards_equal_to_the_steps": True})


def _timed_consensus_call(label, step, args, no_sync: bool):
    """One step timed by CUDA events; with ``no_sync`` under
    ``torch.cuda.set_sync_debug_mode("error")``."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if no_sync:
        torch.cuda.set_sync_debug_mode("error")
    try:
        start.record()
        res = step(*args)
        end.record()
    except RuntimeError as err:
        raise RuntimeError(f"no_sync consensus ({label}): the step waits "
                           f"for the card: {err}") from err
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return res, start.elapsed_time(end)


def _window(params) -> list:
    """The first ``CONS_WINDOW`` elements of every leaf, on the host."""
    from repro_torch.core.tree import flatten
    return [leaf.view(-1)[:CONS_WINDOW].cpu() for leaf in flatten(params)]


def _consensus_case(label, arch, family, dens, chan_text, steps, mesh,
                    ncfg, counters, after0: dict) -> dict:
    """One case of ``consensus_phase`` from θ⁽⁰⁾; its tensors are freed on
    return. Returns the launches a step."""
    import dataclasses
    import math

    import torch

    from repro_torch.comm.channel import compile_channel
    from repro_torch.configs import get_config
    from repro_torch.core import topology_repr
    from repro_torch.core.tree import flatten
    from repro_torch.distributed import netes_dist
    from repro_torch.launch import specs

    t_case = time.perf_counter()
    pair = _consensus_pair(arch, family, dens, chan_text, mesh)
    cfg = pair.cfg
    step, order = specs.build_step(pair, mesh, ncfg, device=CONS_DEVICE)
    check(order == ("params", "adj", "batch", "draws")
          + (("chan",) if chan_text else ()),
          f"consensus ({label}): step arguments {order}")
    f64 = None
    params, batch = _consensus_inputs(cfg)
    theta_bytes = sum(leaf.numel() * leaf.element_size()
                      for leaf in flatten(params))
    states = ([compile_channel(chan_text, CONS_P).init(params)]
              if chan_text else [])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in counters.values():
        k.launches = 0
    t_steps = time.perf_counter()
    metrics, ms, prof = [], [], None
    for t in range(steps):
        draws = _consensus_draws(t, CONS_BETAS[t])
        args = (params, None, batch, draws, *states)
        last = t == steps - 1
        if t == 0 and label == CONS_F64:
            res, t_ms, f64 = _consensus_f64_check(
                label, cfg, step, args,
                topology_repr.from_spec(pair.topo, device=CONS_DEVICE),
                ncfg, counters)
            ms.append(t_ms)
        elif last and label in CONS_PROFILED:
            box = []
            prof = _profile(lambda: box.append(step(*args)))
            res = box.pop()
            ms.append(prof["wall_ms"])
        else:
            res, t_ms = _timed_consensus_call(
                label, step, args, last and label in CONS_NO_SYNC)
            ms.append(t_ms)
        states = list(res[2:])
        metrics.append({k: v.item() for k, v in res[1].items()})
        if t == 0:
            after0[label] = _window(params)
    counts = {name: k.launches for name, k in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    steps_s = time.perf_counter() - t_steps
    for t, m in enumerate(metrics):
        check(math.isfinite(m["reward_mean"]) and math.isfinite(
            m["reward_max"]), f"consensus ({label}): step {t}'s losses {m}")
        check(m["broadcast"] == (CONS_BETAS[t] < ncfg.p_broadcast),
              f"consensus ({label}): step {t} broadcast {m['broadcast']}")
        if chan_text:
            check(m["msgs"] == m["broadcast"] * CONS_P
                  and m["trigger_frac"] == 1.0,
                  f"consensus ({label}): step {t}'s msgs {m}")
    if chan_text:
        check(float(states[0].msgs) == sum(m["msgs"] for m in metrics),
              f"consensus ({label}): the channel counted "
              f"{float(states[0].msgs)} messages")
    check(peak <= 2 * theta_bytes + CONS_PEAK_SLACK,
          f"consensus ({label}): peak {peak / 1e9:.2f} GB over 2θ "
          f"({2 * theta_bytes / 1e9:.2f} GB) + "
          f"{CONS_PEAK_SLACK / 1e9:.0f} GB")
    kinds = [(ls.mixer, ls.ffn) for ls in cfg.layer_specs()]
    evals = steps * 2 * CONS_P
    want = {"flash_attention": evals * sum(m.startswith("attn")
                                           for m, _ in kinds),
            "moe_topk": evals * sum(f == "moe" for _, f in kinds),
            "mamba_scan": evals * sum(m == "mamba" for m, _ in kinds),
            "fused_broadcast_select": steps * sum(
                -(-leaf.numel() // netes_dist.SLAB_COLUMNS)
                for leaf in flatten(params)) if chan_text else 0}
    for name, n in counts.items():
        check(n == want.get(name, 0),
              f"consensus ({label}): {name} launched {n} times, "
              f"{want.get(name, 0)} expected")
    check(counts["moe_topk"] > 0 and counts["flash_attention"]
          + counts["mamba_scan"] > 0,
          f"consensus ({label}): the model kernels never launched: {counts}")
    per_step = {k: v / steps for k, v in counts.items() if v}
    emit({"phase": "consensus", "case": label, "arch": arch,
          "mode": pair.mode, "classify_n_agents": 256,
          "reduced": {"num_layers": [CONS_LAYERS,
                                     get_config(arch).num_layers],
                      "n_pop": [CONS_P, 256], "steps": steps},
          "microbatch": list(batch["tokens"].shape[1:]),
          "family": family, "density": dens, "channel": chan_text,
          "netes": dataclasses.asdict(ncfg),
          "betas": list(CONS_BETAS[:steps]),
          "theta_gb": theta_bytes / 1e9, "peak_memory_gb": peak / 1e9,
          "peak_bound_gb": (2 * theta_bytes + CONS_PEAK_SLACK) / 1e9,
          "step_ms": ms, "metrics": metrics, "launches": counts,
          "launches_per_step": per_step,
          "no_sync_step": label in CONS_NO_SYNC,
          "profiled_last_step": prof, "f64_step0": f64,
          "setup_s": t_steps - t_case, "steps_wall_s": steps_s,
          "case_wall_s": time.perf_counter() - t_case})
    return per_step


def consensus_phase() -> dict:
    """``launch.specs``' entry for the consensus placement, on the card:
    ``classify`` of each arch's ``train_4k`` on a world-of-one mesh (mode
    consensus, P = 256), cut to ``CONS_P`` members and ``CONS_LAYERS``
    layers at full width, and ``build_step``'s step (``CONS_CASES``): (i)
    scout fully connected (``topology.deg``), (ii) ER p = 0.5, (iii) (ii)
    through ``quantize(bits=8)|dropout(p=0.1)`` (the broadcast through the
    fused select), (iv) jamba on ER p = 0.5. β is injected (no, yes, no).
    Each case from θ⁽⁰⁾ (``_consensus_case``): the counters zeroed just
    before its steps and read just after (flash and the router for scout,
    the scan and the router for jamba, the select in (iii) only, the Eq. 3
    kernels never), the steps' ms (CUDA events), the ± losses finite, the
    peak under 2θ + ``CONS_PEAK_SLACK``, (iii)'s ``msgs`` = broadcast·P;
    the last step of ``CONS_NO_SYNC`` under the sync check, of
    ``CONS_PROFILED`` profiled. θ after step 0 must differ between (i) and
    (ii) (the degree weights acted); (ii)'s step 0 is held against float64
    (``_consensus_f64_check``). Returns the
    launches a step of each case."""
    import torch

    from repro_torch.core.netes import NetESConfig
    from repro_torch.launch import mesh as launch_mesh

    t_phase = time.perf_counter()
    ncfg = NetESConfig(alpha=LM_ALPHA, sigma=LM_SIGMA,
                       p_broadcast=LM_P_BROADCAST)
    counters = _counters()
    mesh = launch_mesh.make_host_mesh(1, device=CONS_DEVICE)
    per_step, after0 = {}, {}
    try:
        for case in CONS_CASES:
            per_step[case[0]] = _consensus_case(*case, mesh, ncfg, counters,
                                                after0)
            torch.cuda.empty_cache()
    finally:
        mesh.close()
    moved = [not torch.equal(a, b) for a, b in zip(after0["i"], after0["ii"],
                                                  strict=True)]
    check(any(moved), "consensus: θ after step 0 is the same on FC and ER: "
          "the degree weights did not act")
    emit({"phase": "consensus_summary", "leaves_moved_by_degrees":
          sum(moved), "leaves": len(moved),
          "seconds": time.perf_counter() - t_phase})
    return per_step


# ---------------------------------------------------------------------------
# tooling (launch/op_costs.py, launch/specs.lower, launch/analysis.py,
# analysis/): the dry run's accounting held against the card on the
# consensus step, and the contract linter's entry points run on the card
# ---------------------------------------------------------------------------

TOOL_CASES = (("scout", SCOUT_ARCH), ("jamba", JAMBA_ARCH))
TOOL_PEAK_BAND = 0.15       # the predicted peak within ±15% of the measured


def _tooling_pair(arch):
    """Phase ``consensus``'s cut of ``arch``'s pair (ER p = 0.5, P =
    ``CONS_P``, ``CONS_LAYERS`` layers, full width) on a world of one, and
    its input shape: one 1 × 4096 microbatch a member."""
    from repro_torch.configs import INPUT_SHAPES
    from repro_torch.launch.mesh import NamedShape

    one = NamedShape(("data", "model"), (1, 1))
    pair = _consensus_pair(arch, "erdos_renyi", 0.5, None, one)
    shape = dict(seq_len=INPUT_SHAPES[CONS_SHAPE]["seq_len"],
                 global_batch=CONS_P, kind="train")
    return pair, one, shape


def _tooling_consensus(label, arch, ncfg, counters, smi) -> tuple:
    """``specs.lower(...).trace()`` of the cut pair on fake CUDA tensors
    (the members folded: one traced, counted P times), then one real step
    on the card under an ``op_costs`` recorder, the kernels reporting, and
    one more timed by CUDA events with no recorder. Checks: the two
    ``dot_flops`` equal; the predicted peak (arguments + the fake run's
    live-storage peak) within ``TOOL_PEAK_BAND`` of
    ``torch.cuda.max_memory_allocated`` over the step; the roofline's
    bound at the H100's constants at most the measured step. Returns (the
    case's record, the launches of its recorded step)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import analysis, op_costs, specs

    t_case = time.perf_counter()
    pair, one, shape = _tooling_pair(arch)
    lowered = specs.lower(pair, one, shape=shape, ncfg=ncfg,
                          device=CONS_DEVICE)
    t0 = time.perf_counter()
    fake = lowered.trace(fold=True)
    trace_s = time.perf_counter() - t0
    fake_costs = fake.costs()
    predicted = analysis.memory_analysis_dict(lowered.argument_bytes(),
                                              fake)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    params, batch = _consensus_inputs(pair.cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in counters.values():
        k.launches = 0
    with op_costs.OpCosts(keep_ops=False) as real:
        lowered.fn(params, None, batch, _consensus_draws(0, 1.0))
    torch.cuda.synchronize()
    launches = {n: k.launches for n, k in counters.items() if k.launches}
    measured = torch.cuda.max_memory_allocated() - base
    real_costs = real.costs()
    _, step_ms = _timed_consensus_call(
        f"tooling {label}", lowered.fn,
        (params, None, batch, _consensus_draws(1, 1.0)), False)
    del params, batch
    torch.cuda.empty_cache()
    hbm = (fake_costs["dot_bytes"] + fake_costs["kernel_bytes"]
           + fake_costs["collective_bytes"])
    terms = analysis.roofline_terms(fake_costs["dot_flops"], hbm,
                                    fake_costs["collective_bytes"])
    bound_ms = terms["step_time_lower_bound_s"] * 1e3
    flops_equal = fake_costs["dot_flops"] == real_costs["dot_flops"]
    check(flops_equal,
          f"tooling ({label}): dot FLOPs of the fake trace "
          f"{fake_costs['dot_flops']:.6e} (kernels "
          f"{fake_costs['kernel_flops']:.6e}) and of the card's step "
          f"{real_costs['dot_flops']:.6e} (kernels "
          f"{real_costs['kernel_flops']:.6e}) differ")
    off = abs(predicted["peak_bytes"] - measured) / measured
    check(off <= TOOL_PEAK_BAND,
          f"tooling ({label}): predicted peak "
          f"{predicted['peak_bytes'] / 1e9:.3f} GB is {off:.1%} off the "
          f"measured {measured / 1e9:.3f} GB")
    check(bound_ms <= step_ms,
          f"tooling ({label}): the roofline bound {bound_ms:.3f} ms is "
          f"above the measured step, {step_ms:.3f} ms")
    check(launches.get("moe_topk", 0) > 0,
          f"tooling ({label}): the router never launched: {launches}")
    return ({"case": label, "arch": arch, "card": smi,
             "reduced": {"num_layers": [CONS_LAYERS,
                                        get_config(arch).num_layers],
                         "n_pop": [CONS_P, 256]},
             "trace_s": trace_s,
             "dot_flops_fake": fake_costs["dot_flops"],
             "dot_flops_card": real_costs["dot_flops"],
             "kernel_flops": real_costs["kernel_flops"],
             "flops_equal": flops_equal,
             "kernels_reported": dict(real.kernels),
             "peak_predicted_gb": predicted["peak_bytes"] / 1e9,
             "argument_gb": predicted["argument_bytes"] / 1e9,
             "temp_predicted_gb": predicted["temp_bytes"] / 1e9,
             "peak_measured_gb": measured / 1e9,
             "peak_off": off, "roofline": terms, "bound_ms": bound_ms,
             "step_ms": step_ms, "bound_over_step": bound_ms / step_ms,
             "launches": launches,
             "case_wall_s": time.perf_counter() - t_case}, launches)


def _tooling_contracts(counters) -> tuple:
    """Every entry point of the contract linter that needs one device,
    built on the card (``build(device)``) and called twice: once to load
    its kernels and place its operands, then under
    ``torch.cuda.set_sync_debug_mode("error")``; the state it returns must
    be as stable as the contract layer holds it on fake tensors. Returns
    (entry points run, findings, launches)."""
    import torch

    from repro_torch.analysis import contracts
    from repro_torch.analysis.registry import iter_entry_points

    dev = torch.device(CONS_DEVICE, 0)
    run, findings = [], []
    for k in counters.values():
        k.launches = 0
    for ep in iter_entry_points():
        if ep.min_devices > 1:
            continue
        fn, args, kwargs = ep.build(dev)
        fn(*args, **kwargs)
        before = {name: contracts.snapshot(args[i])
                  for name, i, _ in ep.carry}
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = fn(*args, **kwargs)
        except RuntimeError as err:
            findings.append(f"{ep.name}: the call waits for the card: {err}")
            continue
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        pairs = {name: (before[name], contracts.snapshot(out[j]))
                 for name, _, j in ep.carry}
        findings += [f"{ep.name}: {m}" for m in contracts.check_stable_carry(
            pairs, dict(ep.carry_exempt))]
        run.append(ep.name)
    launches = {n: k.launches for n, k in counters.items() if k.launches}
    return run, findings, launches


def tooling_phase() -> dict:
    """(a) the dry run's accounting against the card on the consensus
    step of scout and jamba (``_tooling_consensus``); (b) the one-device
    entry points of the contract linter run on the card
    (``_tooling_contracts``); (c) one ``tooling`` line. Returns the
    launches of the phase by kernel."""
    import torch

    from repro_torch.core.netes import NetESConfig

    t_phase = time.perf_counter()
    smi = nvidia_smi()
    ncfg = NetESConfig(alpha=LM_ALPHA, sigma=LM_SIGMA,
                       p_broadcast=LM_P_BROADCAST)
    counters = _counters()
    cases, launches = [], {}
    for label, arch in TOOL_CASES:
        case, counts = _tooling_consensus(label, arch, ncfg, counters, smi)
        emit({"phase": "tooling_case", **case})
        cases.append(case)
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
        torch.cuda.empty_cache()
    run, findings, counts = _tooling_contracts(counters)
    for name, n in counts.items():
        launches[name] = launches.get(name, 0) + n
    check(not findings, f"tooling: contract findings on the card: "
          f"{findings}")
    emit({"phase": "tooling", "card": smi,
          "pairs": [c["case"] for c in cases],
          "flops_equal": all(c["flops_equal"] for c in cases),
          "peak_predicted_gb": {c["case"]: c["peak_predicted_gb"]
                                for c in cases},
          "peak_measured_gb": {c["case"]: c["peak_measured_gb"]
                               for c in cases},
          "bound_ms": {c["case"]: c["bound_ms"] for c in cases},
          "step_ms": {c["case"]: c["step_ms"] for c in cases},
          "entry_points_run": run, "entry_points": len(run),
          "findings": len(findings), "launches": launches,
          "cases": cases, "seconds": time.perf_counter() - t_phase})
    return launches


# ---------------------------------------------------------------------------
# the sharded fleet (distributed/fleet_shard.py): its kernels, its runs
# ---------------------------------------------------------------------------

SHARD_D = 4481             # the pendulum policy's parameters
# (label, density, N, shards of the plan, the shards held, kernels)
SHARD_KERNEL_CASES = (
    ("er_4way", MAIN_P_ER, MAIN_N, 4, (0, 3),
     ("netes_sparse_mixing", "fused_neighbor_sum")),
    ("er_dense_4way", 0.5, MAIN_N, 4, (0, 3), ("netes_mixing",)),
    ("er16k_8way", 0.0005, 16384, 8, (0,),
     ("netes_sparse_mixing", "fused_neighbor_sum")),
)
RS_KERNEL_OF = {"netes_mixing": "dense", "netes_sparse_mixing": "sparse",
                "fused_neighbor_sum": "sparse"}


def _rs_call(kname, plan, s, w, x, codes, scale, theta):
    """The R × S instance ``kname`` and its plain version on shard s of
    ``plan``: its rows of the plan's operands, and the buffer the halo
    rounds deliver to it (the payload rows at the shard's ``gid_buf``);
    a dense plan reads all N senders. Returns (kernel, plain, args, the
    dense float64 (R, S) weights, the sender rows, R, lo)."""
    import torch

    from repro_torch.kernels import netes_fused_mixing as nfm
    from repro_torch.kernels import netes_mixing as nm
    from repro_torch.kernels import netes_sparse_mixing as nsm
    from repro_torch.kernels import ref
    n, n_loc = plan.n, plan.n_loc
    lo = s * n_loc
    r = min(n_loc, n - lo)
    rows = slice(lo, lo + r)
    dev = theta.device
    op = {k: torch.as_tensor(v, device=dev) for k, v in plan.operands.items()}
    th = theta[rows].contiguous()
    if kname == "netes_mixing":
        adjb = op["adj_block"][rows].contiguous()
        args = (adjb, w, x, th)
        a64 = adjb.double() * w.double()[None, :]
        return nm.netes_mixing_rs, ref.netes_mixing_rs_ref, args, a64, x, r, lo
    pad = plan.n_pad - n
    gid = op["gid_buf"][s].long()
    coeff = torch.cat([w, w.new_zeros(pad)])[gid].contiguous()
    ridx = op["remap_idx"][rows].contiguous()
    rmask = op["remap_mask"][rows].contiguous()
    a64 = torch.zeros(r, gid.numel(), dtype=torch.float64, device=dev)
    a64.index_put_((torch.arange(r, device=dev).repeat_interleave(
        ridx.shape[1]), ridx.reshape(-1).long()),
        (rmask * coeff[ridx.long()]).reshape(-1).double(), accumulate=True)
    if kname == "fused_neighbor_sum":
        bc = torch.cat([codes, codes.new_zeros(pad, codes.shape[1])])[gid]
        bs = torch.cat([scale, scale.new_zeros(pad, 1)])[gid]
        args = (ridx, rmask, coeff, bc.contiguous(), bs.contiguous(), th)
        senders = bc.double() * bs.double()
        return (nfm.fused_neighbor_sum_rs, ref.fused_neighbor_sum_rs_ref,
                args, a64, senders, r, lo)
    buf = torch.cat([x, x.new_zeros(pad, x.shape[1])])[gid].contiguous()
    args = (ridx, rmask, coeff, buf, th)
    return (nsm.netes_sparse_mixing_rs, ref.sparse_mixing_rs_ref, args, a64,
            buf, r, lo)


def _rs_f64_check(name, out, a64, senders, theta) -> float:
    """|out − exact| ≤ TOL_REL·S elementwise, exact = A·x − (A·1)·θ in
    float64 and S = |A|·|x| + |A·1|·|θ|. Returns the worst |err|/S."""
    senders = senders.double()
    ws = a64.sum(dim=1, keepdim=True)
    th64 = theta.double()
    exact = a64 @ senders - ws * th64
    scale = a64.abs() @ senders.abs() + ws.abs() * th64.abs()
    err = (out.double() - exact).abs()
    check(((err - TOL_REL * scale).max() <= 0).item(),
          f"{name}: error above {TOL_REL}·S (worst |err|/S = "
          f"{(err / scale.clamp_min(1e-30)).max().item():.3g})")
    return (err / scale.clamp_min(1e-30)).max().item()


def kernel_shard_phase(results: dict) -> None:
    """The receiver ≠ sender instances of the three Eq. 3 kernels at the
    operands of shards of a ``fleet_shard.make_comm_plan`` (``
    SHARD_KERNEL_CASES``): each shard's rows, computed from the buffer its
    halo rounds deliver (the plain version bit for bit, within TOL_REL·S
    of float64, the same bits on two launches), must equal the rows of the
    world-size-1 plan bit for bit. Times, bounds, grids."""
    import torch

    from repro_torch.core import wire_format
    from repro_torch.core.topology_repr import from_dense
    from repro_torch.distributed import fleet_shard

    for label, dens, n, n_dev, shards, knames in SHARD_KERNEL_CASES:
        rep = "dense" if knames == ("netes_mixing",) else "sparse"
        topo = from_dense(_graph(n, "erdos_renyi", dens, seed=0), rep,
                          device="cuda")
        theta, eps, w = _operands(n, SHARD_D, seed=n + n_dev)
        x = theta + 0.1 * eps
        wp = wire_format.encode(x, 8, batched=True)
        plans = {1: fleet_shard.make_comm_plan(topo, 1),
                 n_dev: fleet_shard.make_comm_plan(topo, n_dev)}
        for kname in knames:
            kernel, _, args1, _, _, _, _ = _rs_call(
                kname, plans[1], 0, w, x, wp.codes, wp.scale, theta)
            whole = kernel(*args1)
            for s in shards:
                kernel, plain, args, a64, senders, r, lo = _rs_call(
                    kname, plans[n_dev], s, w, x, wp.codes, wp.scale, theta)
                name = f"{kname}_rs/{label}/shard{s}"
                out = kernel(*args)
                check(torch.equal(kernel(*args), out),
                      f"{name}: two launches differ")
                check(torch.equal(out, whole[lo:lo + r]),
                      f"{name}: rows differ from the world-size-1 rows")
                out_p = plain(*args)
                max_abs = (out - out_p).abs().max().item()
                check(max_abs == 0.0, f"{name}: differs from its plain "
                      f"version by {max_abs}")
                rel = _rs_f64_check(name, out, a64, senders, args[-1])
                n_send = senders.shape[0]
                nnz = int(torch.count_nonzero(a64).item())
                d = SHARD_D
                if kname == "netes_mixing":
                    flops = 2.0 * r * n_send * d + 2.0 * r * d
                    moved = 4.0 * (r * n_send + n_send + n_send * d
                                   + 2 * r * d)
                    grid = [-(-d // 64), -(-r // 64)]
                    lib_w = (args[0] * w[None, :])
                    lib = functools.partial(torch.matmul, lib_w, x)
                    lib_name = MATMUL
                else:
                    k = args[0].shape[1]
                    flops = 2.0 * nnz * d + 2.0 * r * d
                    elem = 1 if kname == "fused_neighbor_sum" else 4
                    moved = (elem * n_send * d + 8.0 * n_send + 8.0 * r * k
                             + 8.0 * r * d)
                    if kname == "fused_neighbor_sum":
                        flops += n_send * d       # each sender decoded once
                    grid = [r, -(-d // 1024)]
                    if kname == "fused_neighbor_sum":
                        lib_w = (a64 * args[4].double().reshape(1, -1)).float()
                        lib_x = args[3].float()
                    else:
                        lib_w, lib_x = a64.float(), args[3]
                    lib = functools.partial(torch.sparse.mm,
                                            lib_w.to_sparse_csr(), lib_x)
                    lib_name = "torch.sparse.mm (CSR)"
                t_ops, t_bytes = flops / F32_FLOPS, moved / HBM_BYTES_PER_S
                row = {"phase": "kernel_shard", "name": kname,
                       "case": label, "n": n, "n_dev": n_dev, "shard": s,
                       "receivers": r, "senders": n_send, "d": d,
                       "nnz": nnz, "grid": grid, "max_abs_err": max_abs,
                       "max_err_over_S": rel, "tol_over_S": TOL_REL,
                       "equals_world_size_1_rows": True,
                       **time_stats(functools.partial(kernel, *args)),
                       "plain_ms": time_ms(functools.partial(plain, *args),
                                           warmup=1, iters=5),
                       "library": lib_name, "library_ms": time_ms(lib),
                       "bound_ms": 1e3 * max(t_ops, t_bytes),
                       "bound_by": ("operations" if t_ops >= t_bytes
                                    else "bytes"),
                       "gflop": flops / 1e9, "mbytes": moved / 1e6}
                row["share_of_bound"] = row["bound_ms"] / row["ms"]
                emit(row)
                if s == 0 and label != "er16k_8way":
                    results[kname + "_rs"] = row
                else:
                    results.setdefault(kname + "_rs_cases", []).append(
                        {key: row[key] for key in (
                            "case", "shard", "receivers", "senders", "ms",
                            "bound_ms", "plain_ms", "library_ms",
                            "max_abs_err", "max_err_over_S")})
                del out, out_p, args, a64, senders
            del whole, args1
        del topo, theta, eps, x, wp, plans
        torch.cuda.empty_cache()


# (run, family, density, channel, schedule, the plan's mode, kernels that
# launch once a step)
SHARD_RUNS = (
    ("er", "erdos_renyi", MAIN_P_ER, None, None, "halo",
     ("netes_sparse_mixing_rs",)),
    ("er_q8", "erdos_renyi", MAIN_P_ER, "quantize(bits=8)", None, "halo",
     ("fused_neighbor_sum_rs", "fused_broadcast_select")),
    ("fc", "fully_connected", 1.0, None, None, "dense", ("netes_mixing_rs",)),
    ("a", "erdos_renyi", MAIN_P_ER, CHANNEL_RUNS[0][3], None, "replicated",
     ("fused_neighbor_sum_rs", "fused_broadcast_select")),
    ("s-a", "erdos_renyi", MAIN_P_ER, None, SCHEDULE_RUNS[0][3], "replicated",
     ("netes_sparse_mixing_rs",)),
)
SHARD_SCALE_N, SHARD_SCALE_P, SHARD_SCALE_ITERS = 16384, 0.0005, 2
SHARD_SCALE_DEVICES = 8       # the plans whose collective bytes are printed


def _shard_argv(family, dens, channel, schedule, n, iters, ckpt, out):
    argv = ["rl", "--task", "pendulum", "--agents", str(n), "--iters",
            str(iters), "--topology", family, "--density", str(dens),
            "--seed", "0", "--shards", "1", "--checkpoint-dir", str(ckpt),
            "--out", str(out)]
    if channel is not None:
        argv += ["--channel", channel]
    if schedule is not None:
        argv += ["--schedule", schedule]
    return argv


def _sync_check(label: str, step) -> dict:
    """One step under ``set_sync_debug_mode("error")``. A wait for the
    card raises; the frames of the call that waited are named, and the
    check fails unless it sits inside ``torch.distributed`` (a collective
    that itself waits for the host)."""
    import traceback

    import torch
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step()
        synced = None
    except RuntimeError as err:
        frames = traceback.extract_tb(err.__traceback__)
        synced = {"error": str(err)[:300],
                  "frames": [f"{f.filename.split('/')[-1]}:{f.lineno} "
                             f"{f.name}" for f in frames[-6:]]}
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    if synced is not None:
        in_collective = any("distributed" in f for f in synced["frames"])
        check(in_collective, f"shard {label}: the step waits for the card "
              f"outside a collective: {synced}")
    return {"label": label, "synced": synced}


def shard_phase(launches_shard: dict) -> None:
    """``launch/train.py rl --shards 1`` on pendulum at N = 1000 through
    NCCL (a world of one), ``SHARD_RUNS``: each run's kernels counted
    (the R × S instances once a step, the square ones never), its
    history and its last checkpoint's state equal bit for bit to the
    ``mesh=None`` engine's from the same seed; step times of the sharded
    engine beside ``netes_step``'s; one step of each under the sync
    check."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.core import netes
    from repro_torch.distributed import fleet_shard
    from repro_torch.envs import resolve_task
    from repro_torch.launch import train as launch_train
    from repro_torch.train.loop import (build_channel, build_schedule,
                                        build_topology)

    mesh = fleet_shard.build_mesh(1, device="cuda")
    check(mesh.device.type == "cuda" and torch.distributed.get_backend()
          == "nccl", f"shard: the mesh is not NCCL on the card: {mesh}")
    reward_fn, dim, init_fn, _, _ = resolve_task("pendulum")
    synced = []
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for run, family, dens, channel, text, mode, kernels in SHARD_RUNS:
                ck, out = pathlib.Path(tmp) / run, pathlib.Path(tmp) / (
                    run + ".json")
                counters = _counters()
                for k in counters.values():
                    k.launches = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                launch_train.main(_shard_argv(family, dens, channel, text,
                                              MAIN_N, MAIN_ITERS, ck, out))
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                counts = {name: k.launches for name, k in counters.items()}
                for name in kernels:
                    check(counts[name] == MAIN_ITERS, f"shard {run}: {name} "
                          f"launched {counts[name]} times, not once a step")
                for name in EQ3_KERNELS[:3]:
                    check(counts[name] == 0, f"shard {run}: the square "
                          f"{name} launched on the sharded path")
                launches_shard[run] = {k: v for k, v in counts.items() if v}
                hist = json.loads(out.read_text())["history"]

                # the mesh=None engine from the same seed
                tc = _schedule_config(family, dens, text, channel)
                ch, sched = build_channel(tc), build_schedule(tc)
                topo = None if sched is not None else build_topology(
                    tc, device="cuda")
                state = netes.init_state(MAIN_N, dim, seed=0,
                                         init_fn=init_fn, device="cuda")
                solo = fleet_shard.ShardedNetES(
                    topo, reward_fn, tc.netes, channel=ch, schedule=sched)
                check(solo.plan.mode == mode,
                      f"shard {run}: plan mode {solo.plan.mode}")
                res = solo.run(state, MAIN_ITERS,
                               chan_state=None if ch is None
                               else ch.init(state.thetas),
                               sched_state=None if sched is None
                               else sched.init(device="cuda"))
                metrics = res[-1]
                for key in ("reward_mean", "reward_max"):
                    check(hist[key] == metrics[key].double().tolist(),
                          f"shard {run}: {key} differs from the mesh=None "
                          "engine's")
                if ch is not None:
                    check(hist["msgs"] == metrics["msgs"].double().tolist(),
                          f"shard {run}: msgs differ")
                with np.load(ck / f"step_{MAIN_ITERS - 1:08d}.npz") as saved:
                    for leaf in ("thetas", "best_theta", "best_reward"):
                        check(np.array_equal(
                            saved[f"netes::.{leaf}"],
                            getattr(res[0], leaf).cpu().numpy()),
                              f"shard {run}: saved {leaf} differs from the "
                              "mesh=None engine's")

                # step times: the sharded engine (world of one) and
                # netes_step, from one state
                sharded = fleet_shard.ShardedNetES(
                    topo, reward_fn, tc.netes, mesh=mesh, channel=ch,
                    schedule=sched)
                st = netes.init_state(MAIN_N, dim, seed=1, init_fn=init_fn,
                                      device="cuda")
                cs0 = None if ch is None else ch.init(st.thetas)
                ss0 = None if sched is None else sched.init(device="cuda")

                def sharded_step():
                    sharded.run(st, 1, chan_state=cs0, sched_state=ss0)

                def plain_step():
                    kw = dict(channel=ch, chan_state=cs0)
                    if sched is None:
                        netes.netes_step(st, topo, reward_fn, tc.netes, **kw)
                    else:
                        netes.scheduled_step(st, ss0, reward_fn, tc.netes,
                                             sched, **kw)

                step_ms = 1e3 * _host_time(sharded_step, 3)
                plain_ms = 1e3 * _host_time(plain_step, 3)
                synced.append(_sync_check(run, sharded_step))
                emit({"phase": "shard", "run": run, "family": family,
                      "density": dens, "channel": channel, "schedule": text,
                      "mode": mode, "n_agents": MAIN_N, "iters": MAIN_ITERS,
                      "backend": torch.distributed.get_backend(),
                      "world_size": mesh.world_size, "wall_s": wall,
                      "step_ms": step_ms, "netes_step_ms": plain_ms,
                      "launches": launches_shard[run],
                      "equals_mesh_none_engine": True,
                      "reward_mean": hist["reward_mean"],
                      "eval": hist["eval"]})
        emit({"phase": "shard_no_sync", "steps": synced})
    finally:
        mesh.close()


def shard_scale_phase(launches_shard: dict) -> None:
    """N = 16,384 on pendulum at ER p = 0.0005 (``--shards 1``, NCCL, 2
    iterations): the wall, a step's ms and the peak device memory; and the
    8-way plans' ``collective_bytes`` at D = 4481: ER's halo below FC's
    gather, q8 about a quarter of ER's float32 payload."""
    import tempfile

    import torch

    from repro_torch.comm.channel import compile_channel
    from repro_torch.core import netes
    from repro_torch.core.netes import NetESConfig
    from repro_torch.distributed import fleet_shard
    from repro_torch.envs import resolve_task
    from repro_torch.launch import train as launch_train
    from repro_torch.train.loop import build_topology

    n, p = SHARD_SCALE_N, SHARD_SCALE_P
    reward_fn, dim, init_fn, _, _ = resolve_task("pendulum")
    mesh = fleet_shard.build_mesh(1, device="cuda")
    try:
        with tempfile.TemporaryDirectory() as tmp:
            counters = _counters()
            for k in counters.values():
                k.launches = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            launch_train.main(_shard_argv(
                "erdos_renyi", p, None, None, n, SHARD_SCALE_ITERS,
                pathlib.Path(tmp) / "ck", pathlib.Path(tmp) / "h.json"))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            counts = {name: k.launches for name, k in counters.items() if
                      k.launches}
            check(counts.get("netes_sparse_mixing_rs") == SHARD_SCALE_ITERS,
                  f"shard_scale: launches {counts}")
            launches_shard["scale_16k"] = counts
            hist = json.loads((pathlib.Path(tmp) / "h.json").read_text())[
                "history"]
        cfg = NetESConfig(alpha=0.05, sigma=0.1)
        tc = _schedule_config("erdos_renyi", p, None, None, n_agents=n,
                              topology=None, density=p)
        topo = build_topology(tc, device="cuda")
        eng = fleet_shard.ShardedNetES(topo, reward_fn, cfg, mesh=mesh)
        state = netes.init_state(n, dim, seed=1, init_fn=init_fn,
                                 device="cuda")
        torch.cuda.reset_peak_memory_stats()
        step_ms = 1e3 * _host_time(lambda: eng.run(state, 1), 2)
        step_peak = torch.cuda.max_memory_allocated()
    finally:
        mesh.close()
    plans = {}
    q8 = compile_channel("quantize(bits=8)", n)
    for label, tp, ch in (("er", topo, None),
                          ("fc", fleet_shard.FullyConnected(n), None),
                          ("er_q8", topo, q8)):
        e = fleet_shard.ShardedNetES(tp, reward_fn, cfg, channel=ch)
        e.plan = fleet_shard.make_comm_plan(tp, SHARD_SCALE_DEVICES,
                                            channel=ch)
        plans[label] = {"mode": e.plan.mode, "rounds": len(e.plan.rounds),
                        **e.collective_bytes(dim)}
    er, fc, q = (plans[k]["payload_bytes"] for k in ("er", "fc", "er_q8"))
    check(er < fc, f"shard_scale: ER's halo {er} B not below FC's gather "
          f"{fc} B")
    check(0.24 < q / er < 0.27, f"shard_scale: q8 payload {q} B is "
          f"{q / er:.3f} of ER's float32 {er} B")
    emit({"phase": "shard_scale", "n_agents": n, "density": p,
          "k_max": topo.k_max, "dim": dim, "iters": SHARD_SCALE_ITERS,
          "wall_s": wall, "peak_bytes_run": peak, "step_ms": step_ms,
          "peak_bytes_step": step_peak,
          "theta_bytes": n * dim * 4, "launches": counts,
          "reward_mean": hist["reward_mean"], "eval": hist["eval"],
          "collective_bytes_8way": plans, "q8_over_er": q / er,
          "er_over_fc": er / fc})


# ---------------------------------------------------------------------------
# forward_long: the full forward's blockwise attention at 1 × 32,768
# ---------------------------------------------------------------------------

# mistral-nemo-12b at full width (5120, 32/8 heads of 128) over the
# reference's prefill_32k length. Memory would hold ≈ 40 layers (1.09 GB of
# float32 weights a layer beside the 2.68 GB embedding, 17.2 GB of logits,
# ≈ 10 GB of one layer's transients: a key block's (32, 32,768, 1024)
# float32 scores are 4.3 GB, where whole scores would be 137 GB); the
# phase's time is what bounds it, ≈ 1 s a layer for the plain forward, so
# 4 layers (7.0 GB of weights)
LONG_LAYERS, LONG_SEQ, LONG_TAIL = 4, 32768, 512


def forward_long_phase() -> dict:
    """``netes_dist.make_prefill_step`` (the full forward, whose attention
    is ``blockwise_attention``) of mistral-nemo-12b at full width and
    ``LONG_LAYERS`` layers, float32, B = 1 × 32,768: its ms (host clock
    after a sync, and CUDA events), peak memory, a profiled run's device
    idle share; the logits of the last ``LONG_TAIL`` positions against the
    flash-kernel path's layers (``loss_fn``'s ``_kernel_layer``) within
    1e-4·max|logit|. Returns the kernel path's flash launches."""
    import dataclasses
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed import netes_dist
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer

    cfg = dataclasses.replace(get_config(ARCH), num_layers=LONG_LAYERS)
    params = transformer.init_params(cfg, seed=0, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(4)
    tokens = torch.randint(0, cfg.vocab_size, (1, LONG_SEQ), generator=g,
                           device="cuda")
    batch = {"tokens": tokens}
    prefill = netes_dist.make_prefill_step(cfg)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    fa.KERNEL.launches = 0
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        logits = prefill(params, batch)
        end.record()
        torch.cuda.synchronize()
        host_ms = 1e3 * (time.perf_counter() - t0)
    check(fa.KERNEL.launches == 0, "forward_long: the full forward launched "
          f"the flash kernel {fa.KERNEL.launches} times")
    peak = torch.cuda.max_memory_allocated()
    tail = logits[:, -LONG_TAIL:].clone()
    check(tuple(logits.shape) == (1, LONG_SEQ, cfg.vocab_size)
          and torch.isfinite(tail).all().item(),
          "forward_long: logits of the wrong shape or not finite")
    del logits
    torch.cuda.empty_cache()
    with torch.no_grad():
        prof = _profile(lambda: prefill(params, batch))
        fa.KERNEL.launches = 0
        x, positions, enc_out = transformer.embed_inputs(params, cfg, batch,
                                                         kernel=True)
        for i, ls in enumerate(cfg.layer_specs()):
            x = transformer._kernel_layer(params["layers"][i], cfg, ls, x,
                                          positions, enc_out)
        x = transformer._norm(cfg, params["final_norm"], x[:, -LONG_TAIL:])
        kernel_tail = transformer.unembed(params, cfg, x)
        launches = fa.KERNEL.launches
    check(launches == LONG_LAYERS, f"forward_long: {launches} flash launches "
          f"on the kernel path of {LONG_LAYERS} layers")
    scale = max(1.0, tail.abs().max().item())
    err = (kernel_tail - tail).abs().max().item()
    check(err <= TOL_LOGITS * scale, f"forward_long: the last {LONG_TAIL} "
          f"positions' logits differ from the kernel path's by {err} "
          f"(tolerance {TOL_LOGITS * scale})")
    emit({"phase": "forward_long", "arch": ARCH, "num_layers": LONG_LAYERS,
          "d_model": cfg.d_model, "heads": [cfg.num_heads, cfg.num_kv_heads],
          "head_dim": cfg.head_dim, "batch": 1, "seq": LONG_SEQ,
          "dtype": "float32", "step": "netes_dist.make_prefill_step",
          "attention": "blockwise_attention (query blocks of 512, key "
                       "blocks of 1024)",
          "weight_gb": 4 * cfg.count_params() / 1e9,
          "ms": start.elapsed_time(end),
          "host_ms": host_ms, "peak_gb": peak / 1e9,
          "peak_over_weights_gb": (peak - base) / 1e9,
          "whole_scores_gb_a_layer": 4 * cfg.num_heads * LONG_SEQ ** 2 / 1e9,
          "profile": prof, "tail": LONG_TAIL, "max_abs_logit": scale,
          "max_abs_err_vs_kernel_path": err, "tol": TOL_LOGITS * scale,
          "kernel_path_flash_launches": launches})
    del params, tail, kernel_tail, x, tokens, batch
    gc.collect()
    torch.cuda.empty_cache()
    return {"flash_attention": launches}


# ---------------------------------------------------------------------------
# es_step: standard ES (the paper's baseline) on pendulum at N = 1000
# ---------------------------------------------------------------------------

ES_ITERS = 3


def es_step_phase() -> None:
    """``core.netes.es_step`` on pendulum, N = 1000 (the paper's policy, D =
    4481), ``ES_ITERS`` iterations from one θ on the card, ε and the reset
    states from one generator: finite rewards, θ moved, each step's ms by
    CUDA events; the last step under ``set_sync_debug_mode("error")``."""
    import math

    import torch

    from repro_torch.core import netes
    from repro_torch.envs import resolve_task

    reward_fn, dim, init_fn = resolve_task("pendulum")[:3]
    gen = torch.Generator(device="cuda").manual_seed(0)
    theta0 = init_fn(gen, 1)[0].to("cuda")
    cfg = netes.NetESConfig()
    theta, rows = theta0, []
    for it in range(ES_ITERS):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        if it == ES_ITERS - 1:
            torch.cuda.set_sync_debug_mode("error")
        try:
            theta, metrics = netes.es_step(theta, reward_fn, cfg, MAIN_N,
                                           generator=gen)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        end.record()
        torch.cuda.synchronize()
        rows.append({"ms": start.elapsed_time(end),
                     **{k: v.item() for k, v in metrics.items()}})
    check(all(math.isfinite(r["reward_mean"]) and math.isfinite(
        r["reward_max"]) for r in rows), f"es_step: rewards {rows}")
    check(torch.isfinite(theta).all().item()
          and not torch.equal(theta, theta0), "es_step: θ not finite or "
          "not moved")
    emit({"phase": "es_step", "task": "pendulum", "n_agents": MAIN_N,
          "dim": dim, "iters": ES_ITERS, "steps": rows,
          "no_sync_step": ES_ITERS - 1})


# the libraries of the redesigned kernels, whose ptxas lines must show no
# spill
REDESIGNED = ("netes_mixing", "flash_attention", "netes_sparse_mixing",
              "netes_fused_mixing", "moe_router", "rwkv6_wkv")

SOURCE_OF = {
    "netes_mixing": ("src/repro_torch/csrc/netes_mixing.cu",
                     "src/repro/kernels/netes_mixing.py:55"),
    "netes_sparse_mixing": ("src/repro_torch/csrc/netes_sparse_mixing.cu",
                            "src/repro/kernels/netes_sparse_mixing.py:62"),
    "fused_neighbor_sum": ("src/repro_torch/csrc/netes_fused_mixing.cu",
                           "src/repro/kernels/netes_fused_mixing.py:112"),
    "fused_broadcast_select": ("src/repro_torch/csrc/netes_fused_mixing.cu",
                               "src/repro/kernels/netes_fused_mixing.py:192"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:82"),
    "moe_topk": ("src/repro_torch/csrc/moe_router.cu",
                 "src/repro/kernels/moe_router.py:45"),
    "rwkv6_wkv": ("src/repro_torch/csrc/rwkv6_wkv.cu",
                  "src/repro/kernels/rwkv6_wkv.py:43"),
    "mamba_scan": ("src/repro_torch/csrc/mamba_scan.cu",
                   "src/repro/kernels/mamba_scan.py:41"),
    "pendulum_rollout": ("src/repro_torch/csrc/pendulum_rollout.cu",
                         "none: the lax.scan of src/repro/envs/rollout.py:19"),
}


# the square kernel's row → its receiver ≠ sender instance's counter
RS_NAME = {"netes_mixing": "netes_mixing_rs",
           "netes_sparse_mixing": "netes_sparse_mixing_rs",
           "fused_neighbor_sum": "fused_neighbor_sum_rs"}


def main() -> int:
    import dataclasses

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails outside the repository)
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    smi = nvidia_smi()
    emit({"phase": "card", "nvidia_smi": smi, "clocks": nvidia_smi(CLOCKS),
          "device": torch.cuda.get_device_name(0),
          "capability": list(torch.cuda.get_device_capability(0)),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0]})

    t0 = time.perf_counter()
    libs = _build.build_all()
    ptxas = {name: [ln.strip() for ln in _build.log_path(name).read_text()
                    .splitlines() if "registers" in ln or "spill" in ln]
             for name in libs}
    emit({"phase": "build", "target": "sm_90a", "seconds":
          time.perf_counter() - t0, "libraries": sorted(libs),
          "ptxas": ptxas})
    for name in REDESIGNED:
        spills = [ln for ln in ptxas[name] if "spill" in ln
                  and "0 bytes spill stores, 0 bytes spill loads" not in ln]
        check(not spills, f"{name}: ptxas reports spills: {spills}")

    results, launches, lm_results = {}, {}, {}
    kernel_phase(results, lm_results)
    band_kernel_phase(results)
    wire_kernel_phase(results, lm_results)
    consensus_select_phase(results)
    fused_fold_phase()
    attention_kernel_phase(results, lm_results)
    router_kernel_phase(results)
    wkv_kernel_phase(results)
    scan_kernel_phase(results)
    rollout_kernel_phase(results)
    masked_kernel_phase()
    kernel_shard_phase(results)
    emit({"phase": "clocks", "after": "kernel phases",
          "query": CLOCKS, "nvidia_smi": nvidia_smi(CLOCKS)})
    main_phase(launches)
    channel_phase(launches)
    sched_launches, tel_launches, cap_launches = {}, {}, {}
    no_sync_step_phase(schedule_phase(sched_launches))
    telemetry_phase(tel_launches)
    capture_phase(cap_launches)
    search_launches = {}
    search_phase(search_launches)
    parity_phase()
    es_step_phase()
    shard_launches = {}
    shard_phase(shard_launches)
    shard_scale_phase(shard_launches)
    serve_parity_phase()
    serve_cpu_parity_phase(ARCH)
    launches["flash_attention"] = serve_phase(ARCH)["flash_attention"]
    long_launches = forward_long_phase()
    moe_parity_phase()
    serve_cpu_parity_phase(MOE_ARCH)
    launches["moe_topk"] = serve_phase(MOE_ARCH,
                                       MOE_SERVE_LAYERS)["moe_topk"]
    rwkv_parity_phase()
    serve_cpu_parity_phase(RWKV_ARCH)
    launches["rwkv6_wkv"] = serve_phase(RWKV_ARCH)["rwkv6_wkv"]
    jamba_parity_phase()
    serve_cpu_parity_phase(JAMBA_ARCH, JAMBA_SMOKE_PROMPT)
    launches["mamba_scan"] = serve_phase(JAMBA_ARCH,
                                         JAMBA_SERVE_LAYERS)["mamba_scan"]
    gemma_parity_phase()
    serve_cpu_parity_phase(GEMMA_ARCH, GEMMA_SMOKE_PROMPT)
    gemma_flash = serve_phase(GEMMA_ARCH)["flash_attention"]
    llama4_parity_phase()
    serve_cpu_parity_phase(SCOUT_ARCH, LLAMA_SMOKE_PROMPT)
    serve_cpu_parity_phase(MAVERICK_ARCH, LLAMA_SMOKE_PROMPT)
    scout_runs, maverick_runs = {}, {}
    serve_phase(SCOUT_ARCH, SCOUT_SERVE_LAYERS, runs=SCOUT_SERVE_RUNS,
                by_run=scout_runs)
    serve_phase(MAVERICK_ARCH, MAVERICK_SERVE_LAYERS, by_run=maverick_runs,
                with_params=maverick_moe_check,
                peak_bound=torch.cuda.mem_get_info()[1] - MAVERICK_HEADROOM)
    whisper_parity_phase()
    whisper_smoke_flash = serve_cpu_parity_phase(WHISPER_ARCH)
    whisper_runs, llava_runs = {}, {}
    serve_phase(WHISPER_ARCH, runs=WHISPER_SERVE_RUNS, by_run=whisper_runs)
    llava_parity_phase()
    serve_cpu_parity_phase(LLAVA_ARCH)
    serve_phase(LLAVA_ARCH, by_run=llava_runs, with_params=llava_loss_check)
    lm_launches = lm_netes_phase(
        dataclasses.replace(get_config(GEMMA_ARCH), num_layers=LM_LAYERS),
        LM_SEQ, LM_CASES, ("i", "iii"))
    lm_launches.update(lm_netes_phase(get_config(WHISPER_ARCH),
                                      LM_WHISPER_SEQ, LM_WHISPER_CASES,
                                      ("whisper-i", "whisper-ii")))
    lm_netes_cpu_parity_phase()
    cons_launches = consensus_phase()
    tool_launches = tooling_phase()
    rows = []
    for name in SOURCE_OF:
        r = results[name]
        source, replaces = SOURCE_OF[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"],
                     "share_of_bound": r["bound_ms"] / r["ms"],
                     "launches_schedule": sched_launches.get(name, {}),
                     "launches_telemetry": tel_launches.get(name, {}),
                     "launches_capture_replay": cap_launches.get(name, {}),
                     "launches_search": search_launches.get(name, {}),
                     "launches_lm_netes": {case: counts.get(name, 0)
                                           for case, counts in
                                           lm_launches.items()},
                     "lm_shapes": lm_results.get(name, {}),
                     "launches_shard": {
                         run: counts.get(RS_NAME.get(name, name), 0)
                         for run, counts in shard_launches.items()},
                     "launches_consensus": {case: counts.get(name, 0)
                                            for case, counts in
                                            cons_launches.items()},
                     "launches_tooling": tool_launches.get(name, 0),
                     "launches_tooling_rs": tool_launches.get(
                         RS_NAME.get(name, ""), 0),
                     "consensus_shapes": results.get(
                         "consensus_shapes", {}).get(name, {})})
        if name in RS_NAME:
            # the receiver ≠ sender instance at shard 0 of a 4-way plan
            # of N = 1000 (D = 4481), and its other shards and N = 16,384
            r = results[name + "_rs"]
            rows[-1]["rs"] = {k: r[k] for k in (
                "case", "receivers", "senders", "grid", "max_abs_err",
                "max_err_over_S", "ms", "ms_q1", "ms_q3", "plain_ms",
                "library", "library_ms", "bound_ms", "bound_by",
                "share_of_bound")}
            rows[-1]["rs_cases"] = results[name + "_rs_cases"]
        if name == "netes_sparse_mixing":
            # the band instance at the ER cell's shape, and its launches
            # and the slab instance's on the main path there
            rows[-1]["band"] = {
                **results["netes_sparse_mixing_band"],
                "launches_main": launches["netes_sparse_mixing_band"]}
        if name == "flash_attention":
            # the head_dim-256 instance: gemma3-4b's global and sliding
            # prefill layers, and its launches per serve (a) generate;
            # llama4-scout's per serve (a) and (c) generate, by mask, and
            # its global and chunked prefill of (c)
            rows[-1]["launches_gemma3_4b"] = gemma_flash
            rows[-1]["launches_llama4_scout"] = {
                run: {"flash_attention": scout_runs[run]["launches"][
                    "flash_attention"], **scout_runs[run][
                        "flash_calls_by_mask"]} for run in ("a", "c")}
            rows[-1]["launches_llama4_maverick"] = {
                run: maverick_runs[run]["launches"]["flash_attention"]
                for run in ("a", "b")}
            # whisper-tiny's per generate of each run, by mask (4 encoder,
            # 4 self, 4 cross: all global), and llava's
            rows[-1]["launches_whisper_tiny"] = {
                run: {"flash_attention": r["launches"]["flash_attention"],
                      **r["flash_calls_by_mask"]}
                for run, r in whisper_runs.items()}
            rows[-1]["launches_llava"] = {
                run: r["launches"]["flash_attention"]
                for run, r in llava_runs.items()}
            # the head_dim-32 instance: whisper-tiny-smoke's greedy serving
            # at its own 4 heads of 32 (its prefill; decode calls no
            # kernel); and forward_long's kernel path (head_dim 128)
            rows[-1]["launches_whisper_tiny_smoke_hd32"] = whisper_smoke_flash
            rows[-1]["launches_forward_long_kernel_path"] = long_launches[
                "flash_attention"]
            for key in ("flash_attention_hd32_noncausal",
                        "flash_attention_hd32_causal",
                        "flash_attention_hd256",
                        "flash_attention_hd256_local",
                        "flash_attention_llama4_global",
                        "flash_attention_llama4_chunk",
                        "flash_attention_whisper_encoder",
                        "flash_attention_whisper_cross",
                        "flash_attention_llava_loss"):
                r = results[key]
                rows[-1][key[len("flash_attention_"):]] = {
                    k: r[k] for k in ("shape", "max_abs_err", "ms",
                                      "plain_ms", "bound_ms", "bound_by",
                                      "library_ms", "library_backend",
                                      "share_of_bound")}
        if name == "moe_topk":
            rows[-1]["launches_llama4"] = {
                f"{arch}_{run}": runs[run]["launches"]["moe_topk"]
                for arch, runs in (("scout", scout_runs),
                                   ("maverick", maverick_runs))
                for run in runs}
            rows[-1]["llama4_cases"] = results["moe_topk_llama4"]
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
